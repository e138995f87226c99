"""The short first call on the card after the typed pack's bf16 slot
pipeline changes: #1 and #2 (``csrc/typed_block_fused.cu``), #6 and #7
(``csrc/typed_tile_fused.cu``), or the header they share
(``csrc/typed_pipe.cuh``).

    python3 scripts/torch_typed_bringup.py [--headline]

Imports ``chip_smoke.py`` and runs its own checks of the kernels, each
against its plain version and a second run of itself: ``setup()`` (the
build, ptxas's register and spill lines, the headline weights), the typed
seam fuzz (``typed_seam_fuzz``: real-row prefixes at the chunk seams, a
block without a slot, a hub of two work items, a slot list of 288), the
[kernels] fuzz layouts (#1, #2 and #3 in bf16 and f32) and the
[scalefree] fuzz layouts (#6, #7 and #11).  With ``--headline`` also the
uniform headline's #1 and #2 and the scale-free headline's #6 and #7,
checked and timed (their hub block alone too).  Prints the timings as one
JSON line, then the card's nvidia-smi line.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headline", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_typed_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    clock = cs.PhaseClock()
    card, params = cs.setup()
    clock.mark("setup and build")
    log, timings = {}, {}
    cs.typed_seam_fuzz(log)
    clock.mark("typed seams")
    r = np.random.default_rng(7)
    for tag, (n, e, t2, dst_hi, tile_e) in {
            "fuzz": (640, 9000, 6, 640, None),
            "empty_blocks": (1024, 3000, 4, 512, None),
            "cmax_ge_2": (256, 6000, 4, 256, 128)}.items():
        lay = build_typed_dst_layout(
            r.integers(0, n, e), r.integers(0, dst_hi, e),
            r.integers(0, t2, e), (r.random(e) < 0.9).astype(np.float32),
            n, t2, tile_e=tile_e)
        cs.check_kernels(tag, lay.to("cuda"), params, log)
    clock.mark("[kernels] fuzz")
    cs.scalefree_fuzz(params, log)
    clock.mark("[scalefree] fuzz")
    if args.headline:
        b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                            annotation_dim=cs.ANN, seed=0, node_mult=128)
        lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                     b.edge_mask, b.spec.n_pad,
                                     2 * cs.EDGE_TYPES).to("cuda")
        cs.check_kernels("headline", lay, params, log, timings)
        del b, lay
        torch.cuda.empty_cache()
        clock.mark("[kernels] headline")
        b, lay = cs.scalefree_headline(params, log, timings)
        del b, lay
        torch.cuda.empty_cache()
        clock.mark("[scalefree] headline kernels")
    print(json.dumps({"timings": timings}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
