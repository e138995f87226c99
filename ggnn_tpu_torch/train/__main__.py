"""CLI experiment runner (counterpart of ``ggnn_tpu/train/__main__.py``)::

    python -m ggnn_tpu_torch.train --config babi4 [--device cuda|cpu]
           [--epochs 100] [--lr 1e-3] [--state_dim 4] [--n_steps 5]
           [--batch_size 10] [--seed 0] [--question_id 0]
           [--data_root babi_data] [--backend xla] [--metrics out.jsonl]
           [--checkpoint_dir d] [--restore ckpt.npz] [--profile DIR]

Trains on the card by default (``--device cuda``); without a CUDA device
that raises, and nothing falls back to the CPU: pass ``--device cpu`` to
train on the CPU.  ``--backend onehot`` batches with the legacy layout
(``layout_for_batch``) as the reference's Trainer does.  ``--profile DIR``
records a ``torch.profiler`` trace of the training run (a Chrome trace,
``DIR/trace_*.json``; :mod:`ggnn_tpu_torch.profiling`).  Prints the result
record as JSON on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn_tpu_torch.train")
    ap.add_argument("--config", required=True,
                    help="registered config name (babi4/babi15/babi16/"
                         "babi18; babi19/babi19_small train a GGS-NN)")
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--lr", type=float)
    ap.add_argument("--batch_size", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--question_id", type=int)
    ap.add_argument("--fold", type=int)
    ap.add_argument("--n_train", type=int)
    ap.add_argument("--n_test", type=int)
    ap.add_argument("--data_root", type=str)
    ap.add_argument("--backend", type=str,
                    choices=["xla", "pallas", "onehot"])
    ap.add_argument("--state_dim", type=int, dest="model_state_dim")
    ap.add_argument("--n_steps", type=int, dest="model_n_steps")
    ap.add_argument("--graph_dim", type=int, dest="model_graph_dim",
                    help="gated-readout width (graph-level heads)")
    ap.add_argument("--ggsnn_output", type=str, dest="model_ggsnn_output",
                    choices=["graph", "node"],
                    help="GGS-NN output net: token per round or next-node "
                         "selection")
    ap.add_argument("--hidden_dim", type=int, dest="model_hidden_dim",
                    help="head MLP hidden width")
    ap.add_argument("--metrics", type=str, dest="metrics_path")
    ap.add_argument("--checkpoint_dir", type=str)
    ap.add_argument("--restore", type=str, help="checkpoint to resume from")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where to train (default cuda; without a card it "
                         "raises)")
    ap.add_argument("--profile", type=str, default=None,
                    help="record a profiler trace into this directory")
    args = ap.parse_args(argv)

    from ggnn_tpu_torch.train.config import build_config
    from ggnn_tpu_torch.train.loop import Trainer

    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "restore", "device", "profile")
                 and v is not None}
    cfg = build_config(args.config, **overrides)
    print(f"config: {cfg}", file=sys.stderr)
    trainer = Trainer(cfg, device=args.device)
    if args.restore:
        trainer.restore(args.restore)
    from ggnn_tpu_torch.profiling import trace
    with trace(args.profile, trainer.device):
        result = trainer.run()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
