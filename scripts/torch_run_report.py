#!/usr/bin/env python
"""10-fold accuracy for every registered config on the committed
babi_data, trained by the port (the counterpart of
``scripts/run_report.py``, which writes the reference's
``docs/RESULTS.json``; this one never does).

Run: python scripts/torch_run_report.py [--device cuda|cpu] [--folds 10]
     [--out docs/RESULTS_torch.json]

Trains on the card by default; without one that raises.  Ten folds of
every config take about an hour.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where to train (default cuda; without a card it "
                         "raises)")
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--out", type=str,
                    default=os.path.join("docs", "RESULTS_torch.json"))
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(
            os.path.join(ROOT, "docs", "RESULTS.json")):
        raise ValueError("docs/RESULTS.json is the reference's report; "
                         "write the port's elsewhere")

    from ggnn_tpu_torch.models.init import device_or_raise
    from ggnn_tpu_torch.train import folds
    from ggnn_tpu_torch.train.config import CONFIGS

    device_or_raise(args.device)
    report = {}
    for name in sorted(CONFIGS):
        res = folds.run_folds(name, n_folds=args.folds,
                              data_root=os.path.join(ROOT, "babi_data"),
                              device=args.device)
        report[name] = res
        print(json.dumps(res), flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
