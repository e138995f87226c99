"""The short first check of the kernel-variant kernels (#18, #19, #20) and
of the widths past 256 on one NVIDIA GPU (H100), after one of them changes.

    python3 scripts/torch_variants_bringup.py [--widths] [--headline]

Builds the port's CUDA library and runs chip_smoke.py's ``[variants]``
fuzz: #18 ``onehot_segment_scatter_stream`` and #19
``onehot_segment_scatter_loopT`` on legacy layouts (tile_e 8, 128, 2048,
empty blocks, a hub block), #20 ``window_block_spmm`` on window layouts (W
64, 256, 512, dummy tiles, a block without tiles), D = 4 to 384, f32 and
bf16.  ``--widths`` adds the ``[widths]`` checks (every kernel at D = 4 to
512); ``--headline`` the rest of ``[variants]``: the two sweeps of
``scripts/torch_scatter_variants.py`` and ``scripts/torch_window_variants.py``
on the headline graphs, their launches, checks and timings.  The checks,
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
    ap.add_argument("--widths", action="store_true",
                    help="also every kernel at D = 4 to 512")
    ap.add_argument("--headline", action="store_true",
                    help="also the sweeps on the headline graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_variants_bringup: no CUDA device", file=sys.stderr)
        return 2
    card, _ = chip_smoke.setup()
    log, timings, launched = {}, {}, {}
    if args.headline:
        from ggnn_tpu_torch.data.synthetic import synthetic_batch
        b = synthetic_batch(chip_smoke.NODES, chip_smoke.EDGES,
                            chip_smoke.EDGE_TYPES,
                            annotation_dim=chip_smoke.ANN, seed=0,
                            node_mult=128)
        launched = chip_smoke.variants_phase(b, log, timings)
        del b
        torch.cuda.empty_cache()
    else:
        chip_smoke.variants_fuzz(log)
    if args.widths:
        chip_smoke.check_kernel_widths(log)
    print(json.dumps({"max_abs_err": {k: max(v) for k, v in log.items()},
                      "timings": timings,
                      "launches": {k: v for k, v in launched.items() if v}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
