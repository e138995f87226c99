"""The short first check of the pallas backend's kernels on one NVIDIA GPU
(H100), after one of them changes.

    python3 scripts/torch_pallas_bringup.py [--slice]

Builds the port's CUDA library and runs chip_smoke.py's ``[pallas
kernels]`` phase on the uniform headline batch (262,144 nodes, 8M directed
edges): #16 ``packed_messages`` and #17 ``sddmm_pallas`` on the fuzz
layouts and at the headline's packed layout, checked and timed; then the
``[widths]`` checks (every kernel at D = 4 to 256, #14 at 200 and 256
among them) and the fused window train step at D = 256.  ``--slice`` also
serves and trains the headline through the pallas backend (``[pallas
serve]``, ``[pallas train]``) and runs the Trainer CLI with ``--backend
pallas``.  The checks, tolerances, bounds and timings are chip_smoke.py's
own.
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
    ap.add_argument("--slice", action="store_true",
                    help="also serve and train through the pallas backend")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pallas_bringup: no CUDA device", file=sys.stderr)
        return 2
    card, _ = chip_smoke.setup()
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(chip_smoke.NODES, chip_smoke.EDGES,
                        chip_smoke.EDGE_TYPES,
                        annotation_dim=chip_smoke.ANN, seed=0, node_mult=128)
    log, timings = {}, {}
    launched = chip_smoke.pallas_phases(b, log, timings,
                                        serve_and_train=args.slice)
    del b
    torch.cuda.empty_cache()
    chip_smoke.widths_phase(log)
    print(json.dumps({"max_abs_err": {k: max(v) for k, v in log.items()},
                      "timings": timings,
                      "launches": {k: v for k, v in launched.items() if v}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
