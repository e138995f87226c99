"""10-fold evaluation runner (counterpart of ``ggnn_tpu/train/folds.py``):
each fold is an independent resample from the task generator; reports
per-fold accuracy and their mean and standard deviation::

    python -m ggnn_tpu_torch.train.folds --config babi4 [--folds 10]
           [--device cuda|cpu] [...]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def run_folds(config_name: str, n_folds: int = 10, device="cuda",
              **overrides) -> dict:
    from ggnn_tpu_torch.train.config import build_config
    from ggnn_tpu_torch.train.loop import Trainer
    from ggnn_tpu_torch.train.metrics import MetricsLogger

    accs = []
    for fold in range(1, n_folds + 1):
        cfg = build_config(config_name, fold=fold, **overrides)
        t = Trainer(cfg, MetricsLogger(echo=False), device=device)
        result = t.run()
        accs.append(result["test_accuracy"])
        print(f"# fold {fold}: {result['test_accuracy']:.4f}",
              file=sys.stderr)
    return {
        "config": config_name,
        "folds": n_folds,
        "accuracies": accs,
        "mean_accuracy": float(np.mean(accs)),
        "std_accuracy": float(np.std(accs)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn_tpu_torch.train.folds")
    ap.add_argument("--config", required=True)
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--epochs", type=int)
    ap.add_argument("--data_root", type=str)
    ap.add_argument("--state_dim", type=int, dest="model_state_dim")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in vars(args).items()
                 if k not in ("config", "folds", "device") and v is not None}
    print(json.dumps(run_folds(args.config, args.folds, args.device,
                               **overrides)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
