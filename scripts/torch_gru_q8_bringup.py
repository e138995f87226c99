"""The short first call on the card after #4 ``gru_cell_bwd``
(``csrc/gru_cell_bwd_pipe.cu``) or #15 ``node_table_block_major_q8``
(``csrc/node_table_q8.cu``) change.

    python3 scripts/torch_gru_q8_bringup.py [--headline]

Imports ``chip_smoke.py`` and runs its own checks of the two kernels, each
against its plain version and a second run of itself: ``setup()`` (the
build, ptxas's register and spill lines, the headline weights), #4's seams
(``gru_bwd_seam_fuzz``: 1, 17, 33 and SMs + 1 blocks, da in f32 and bf16)
and #15's (``q8_table_seam_fuzz``: windows of 1, 2, 3, 4 and 16 types,
T2 = 16 and 3, an uneven block count, the all-zero block).  With
``--headline`` also #4 at the uniform headline's 262,144 rows and #15 at
the community headline's (T2 = 16, W 512, the model's weights), checked
and timed (best of 2 × 10 launches, CUDA events).  Prints the timings as
one JSON line, then the card's nvidia-smi line.
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
        print("torch_gru_q8_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import table as TB
    clock = cs.PhaseClock()
    card, params = cs.setup()
    clock.mark("setup and build")
    log, out = {}, {}
    cs.gru_bwd_seam_fuzz(log)
    clock.mark("#4 seams")
    cs.q8_table_seam_fuzz(log)
    clock.mark("#15 seams")
    if args.headline:
        best = lambda fn: min(cs.cuda_ms(fn, 10) for _ in range(2))
        gen = torch.Generator(device="cuda").manual_seed(2)
        bf = torch.bfloat16
        x = cs.gru_bwd_inputs(cs.NODES, bf, gen)
        cs.check_gru_bwd("headline,bfloat16", x, bf, log)
        for da in (torch.float32, bf):
            key = f"gru_cell_bwd_da_{str(da).split('.')[-1]}_ms"
            out[key] = best(lambda: G.gru_cell_bwd(*x, mdt=bf, da_dtype=da))
        del x
        w, b, _ = cs.window_weights(params, bf)
        h = (torch.rand(cs.NODES, cs.DIM, device="cuda", generator=gen) * 2
             - 1).to(bf)
        cs.check_q8_table("headline W512", h, w, b, 512, log)
        out["node_table_block_major_q8_ms"] = best(
            lambda: TB.node_table_block_major_q8(h, w, b, 512))
        clock.mark("headlines")
    print(json.dumps({"ms": out, "max_abs_err": {
        k: max(v) for k, v in log.items()}}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
