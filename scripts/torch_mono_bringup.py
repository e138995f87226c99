"""The short first call on the card after #11 ``window_block_spmm_mono`` or
#8 ``onehot_segment_scatter_flat`` change (their bf16 pipeline,
``csrc/window_mono_fused.cu`` on ``csrc/mono_pipe.cuh``).

    python3 scripts/torch_mono_bringup.py [--headline]

Imports ``chip_smoke.py`` and runs its own checks, each kernel against its
plain version and a second run of itself: ``setup()`` (the build, ptxas's
register and spill lines, the headline weights), the pipeline's seams
(``mono_seam_fuzz``), #11 at D = 4 … 200 on a hub layout
(``check_window_widths``: the new body at D = 128, the panel kernel at the
others) and on the int8 count stream (``check_count_stream``).  With
``--headline`` also the headline layouts, checked and timed: #8 and #9 on
the uniform headline's ``layout_for_batch`` (``check_legacy_kernels``) and
#11 on its grad half (``check_legacy_grad``), #11's dst-local form on the
scale-free headline's grad layout (``check_window_kernel``), and its
window count form on the community headline's table layout (W 512,
block_rows 512, the XW spill), held per element (``window_sums_bound``)
and timed with its bound.  Prints the timings as one JSON line, then the
card's nvidia-smi line.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--headline", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_mono_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, params = cs.setup()
    clock.mark("setup and build")
    log, timings = {}, {}
    cs.mono_seam_fuzz(log)
    clock.mark("mono seams")
    cs.check_window_widths(log)
    cs.check_count_stream(log)
    clock.mark("widths and count stream")
    if args.headline:
        from ggnn_tpu_torch.data.synthetic import synthetic_batch
        from ggnn_tpu_torch.ops import table as TB
        from ggnn_tpu_torch.ops import window as W
        from ggnn_tpu_torch.ops.legacy import layout_for_batch
        from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
        b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                            annotation_dim=cs.ANN, seed=0, node_mult=128)
        lay = layout_for_batch(b, with_grad=True, device="cuda")
        cs.check_legacy_kernels("headline", lay, cs.NODES, log,
                                params=params, timings=timings)
        cs.check_legacy_grad("headline", lay, log)
        del lay, b
        torch.cuda.empty_cache()
        clock.mark("uniform legacy")
        b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                            annotation_dim=cs.ANN, seed=0, node_mult=128,
                            powerlaw_alpha=cs.ZIPF)
        lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                     b.edge_mask, b.spec.n_pad,
                                     2 * cs.EDGE_TYPES,
                                     with_grad=True).to("cuda")
        cs.check_window_kernel("scalefree", lay, log, timings)
        del lay, b
        torch.cuda.empty_cache()
        clock.mark("scale-free grad")
        b = cs.community_batch()
        lay = cs.bench_window_layout(b, 512, False, True).to("cuda")
        w, bias, _ = cs.window_weights(params, torch.bfloat16)
        h = (torch.rand(cs.NODES, cs.DIM, device="cuda") * 2 - 1).to(
            torch.bfloat16)
        table = TB.node_table(h, w, bias, "block")
        a = lay.arrays
        stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
                  a["win_of_tile"])
        sk = dict(n_blocks=lay.n_blocks, window=lay.window,
                  out_rows=lay.block_rows, packed=lay.packed[0],
                  c_off=a["c_off"])
        got = W.window_block_spmm_mono(table, *stream, **sk)
        cs.same_twice("window_block_spmm_mono", "community table", got,
                      W.window_block_spmm_mono(table, *stream, **sk))
        cs.check("window_block_spmm_mono[community table]", got,
                 W.window_block_spmm_mono_reference(table, *stream, **sk),
                 "bound", torch.bfloat16, log, bound=cs.window_sums_bound(
                     table, (a["c_stream"], a["block_of_tile"],
                             a["win_of_tile"], a["c_off"], lay.n_blocks,
                             lay.packed[0]), lay.window, lay.block_rows))
        del got
        cs.time_window_mono("community table", lay, table)
        clock.mark("community window form")
    print(json.dumps({"timings": timings, "max_abs_err": {
        k: max(v) for k, v in log.items()}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
