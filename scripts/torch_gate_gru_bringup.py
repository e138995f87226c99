"""The short first call on the card after #17 ``sddmm_pallas``
(``csrc/sddmm_blocked.cu``) or #3 ``gru_cell_fwd`` (bf16 at D = 128,
``csrc/gru_cell_pipe.cu``) change.

    python3 scripts/torch_gate_gru_bringup.py [--headline]

Imports ``chip_smoke.py`` and runs its own checks of the two kernels:
``setup()`` (the build, ptxas's register and spill lines), #3's seams
(``gru_cell_seam_fuzz``: 1 block and one fewer and one more than the card's
SMs, |a| ~ 1 and ~ 40; against the plain version, twice bit-equal and
bit-equal to the first body ``gru_cell.cu``) and #17's (``sddmm_seam_fuzz``:
a dst hub past three work items, empty dst blocks, one edge, a src hub,
G = 4, 64, 128, masked or not; against the plain version, twice bit-equal,
bit-equal to the first body ``sddmm.cu`` and on a new layout).  With
``--headline`` also #3 at the uniform headline's 262,144 rows and #17 at
the pallas headline's packed layout (62,516 tiles of 128, G = 128), each
checked the same way and timed against its first body in turns (first,
new, new, first; 10 launches each, CUDA events), and #17's plan on a new
layout (``time_sddmm_plan``).  Prints the timings as one JSON line, then
the card's nvidia-smi line.
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
        print("torch_gate_gru_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, _ = cs.setup()
    clock.mark("setup and build")
    log, out = {}, {}
    cs.gru_cell_seam_fuzz(log)
    clock.mark("#3 seams")
    cs.sddmm_seam_fuzz(log)
    clock.mark("#17 seams")
    if args.headline:
        from ggnn_tpu_torch.data.synthetic import synthetic_batch
        from ggnn_tpu_torch.ops import gru as G
        from ggnn_tpu_torch.ops import spmm as SP
        dev = torch.device("cuda")

        def turns(name, new, first):
            f1 = cs.cuda_ms(first, 10)
            n1 = cs.cuda_ms(new, 10)
            n2 = cs.cuda_ms(new, 10)
            f2 = cs.cuda_ms(first, 10)
            out[name] = {"first_body": [f1, f2], "new": [n1, n2]}
            print(f"  {name}: first body {f1:.3f}/{f2:.3f} ms, new "
                  f"{n1:.3f}/{n2:.3f} ms", flush=True)

        gen = torch.Generator(device=dev).manual_seed(2)
        D = cs.DIM
        h = torch.rand(cs.NODES, D, device=dev, generator=gen) * 2 - 1
        a = torch.randn(cs.NODES, D, device=dev, generator=gen)
        w = [torch.empty(D, k * D, device=dev).uniform_(
            -D ** -0.5, D ** -0.5, generator=gen) for k in (3, 2, 1)]
        b3 = torch.empty(3 * D, device=dev).uniform_(-0.1, 0.1,
                                                     generator=gen)
        ga = (h, a, w[0], b3, w[1], w[2])
        cs.check_gru_cell("headline", ga, log)
        turns("gru_cell_fwd", lambda: G.gru_cell_fwd(*ga),
              lambda: cs.gru_first_body(ga))
        del h, a, ga
        clock.mark("#3 headline")
        b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                            annotation_dim=cs.ANN, seed=0, node_mult=128)
        cols = [torch.as_tensor(x, device=dev) for x in (
            b.edge_src, b.edge_dst, b.edge_type, b.edge_mask,
            b.type_offsets)]
        lay = SP.pack_type_tiles(*cols, 2 * cs.EDGE_TYPES)
        p = torch.randn(b.spec.n_pad, D, device=dev, generator=gen) * 0.1
        q = torch.randn(b.spec.n_pad, D, device=dev, generator=gen) * 0.1
        kw = dict(src=lay["src"], dst=lay["dst"])
        cs.check_sddmm("headline", p, q, log, **kw)
        turns("sddmm_pallas", lambda: SP.sddmm_pallas(p, q, **kw),
              lambda: cs.sddmm_first_body(p, q, **kw))
        cs.time_sddmm_plan(p, q, lay)
        clock.mark("#17 headline")
    print(json.dumps({"ms": out, "max_abs_err": {
        k: max(v) for k, v in log.items()}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
