"""CLI experiment runner (counterpart of ``ggnn_tpu/train/__main__.py``)::

    python -m ggnn_tpu_torch.train --config babi4 [--device cuda|cpu]
           [--epochs 100] [--lr 1e-3] [--state_dim 4] [--n_steps 5]
           [--batch_size 10] [--seed 0] [--question_id 0]
           [--data_root babi_data] [--backend xla] [--metrics out.jsonl]
           [--checkpoint_dir d] [--restore ckpt.npz]

Trains on the card by default (``--device cuda``); without a CUDA device
that raises, and nothing falls back to the CPU: pass ``--device cpu`` to
train on the CPU.  Prints the result record as JSON on stdout.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn_tpu_torch.train")
    ap.add_argument("--config", required=True,
                    help="registered config name (babi4/babi15/babi16/"
                         "babi18; babi19/babi19_small need GGS-NN)")
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
    args = ap.parse_args(argv)

    from ggnn_tpu_torch.train.config import build_config
    from ggnn_tpu_torch.train.loop import Trainer

    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "restore", "device")
                 and v is not None}
    cfg = build_config(args.config, **overrides)
    print(f"config: {cfg}", file=sys.stderr)
    trainer = Trainer(cfg, device=args.device)
    if args.restore:
        trainer.restore(args.restore)
    result = trainer.run()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
