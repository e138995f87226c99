"""The short first check of the window kernels on one NVIDIA GPU (H100),
after one of them changes.

    python3 scripts/torch_window_bringup.py [--headline] [--train] [--wide]

Builds the port's CUDA library and runs chip_smoke.py's window kernel
checks on its fuzz layouts: #11 (int8 and int4 counts, 128-, 256- and
512-row blocks), #12, #13 (table, q8, on-demand; with and without init)
and #15, each against its plain version and a second run of itself.  With
``--headline`` it runs the whole ``[window kernels]`` phase instead: the
fuzz layouts, then the community headline's bench layouts, checked and
timed.  ``--train`` runs the training path's checks instead: #14 and
#13's emit_res on the grad fuzz layouts, the Y path, every kernel's
widths and the D = 8 Predictors (with ``--headline``: the whole ``[window
train]`` phase, the two train records included; ``--wide`` also times
the wide kernels at D = 384 and 512 there, beside 256).  The checks,
tolerances, bounds and timings are chip_smoke.py's own.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headline", action="store_true",
                    help="also check and time the community headline")
    ap.add_argument("--train", action="store_true",
                    help="the training path's kernels (#13 emit_res, #14)")
    ap.add_argument("--wide", action="store_true",
                    help="with --train --headline: also time D = 384, 512")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_window_bringup: no CUDA device", file=sys.stderr)
        return 2
    card, params = chip_smoke.setup()
    log, timings = {}, {}
    if args.train and args.headline:
        chip_smoke.window_train_phase(
            params, log, timings,
            chip_smoke.TIMED_WIDTHS + ((384, 512) if args.wide else ()))
    elif args.train:
        chip_smoke.window_grad_fuzz(params, log)
        chip_smoke.check_kernel_widths(log)
        chip_smoke.predictor_widths()
    elif args.headline:
        chip_smoke.window_kernels_phase(params, log, timings)
    else:
        chip_smoke.window_fuzz(params, log)
    print(json.dumps({"max_abs_err": {k: max(v) for k, v in log.items()},
                      "timings": timings}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
