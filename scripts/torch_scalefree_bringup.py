"""The short first call on the card after #12
(``csrc/window_ondemand_fused.cu``), #6 (``csrc/typed_tile_fused.cu``) or
the GRU epilogue they share with #13 (``csrc/gru_pipe.cuh``) changes.

    python3 scripts/torch_scalefree_bringup.py

Imports ``chip_smoke.py`` and runs its own checks of the kernels, each
against its plain version and a second run of itself: ``setup()`` (the
build, ptxas's register and spill lines, the headline weights), #13's and
#12's seam fuzz (#13 with ``emit_res`` and q8), the [scalefree] fuzz
layouts (#6 and #7 at tile_e 16 to 256, a hub block of many work items),
the scale-free headline's per-tile kernels (timed; #6 again with |a| ≤
1), [scalefree window] (one unfused request on bench.py's
scalefree_fwd_window layout, step by step, then #12 there, timed) and #12
and #13 on the community headline's on-demand layout (timed).  Prints the
timings as one JSON line.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_scalefree_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, params = cs.setup()
    clock.mark("setup and build")
    log, timings = {}, {}
    cs.window_step_seam_fuzz(log)
    clock.mark("#13 seams")
    cs.ondemand_seam_fuzz(log)
    clock.mark("#12 seams")
    cs.scalefree_fuzz(params, log)
    clock.mark("[scalefree] fuzz")
    b, lay = cs.scalefree_headline(params, log, timings)
    del b, lay
    torch.cuda.empty_cache()
    clock.mark("[scalefree] headline kernels")
    cs.scalefree_window_phase(params, log)
    torch.cuda.empty_cache()
    clock.mark("[scalefree window]")
    lay = cs.bench_window_layout(cs.community_batch(), 512, True,
                                 True).to("cuda")
    cs.check_window_layout("headline on-demand", lay, params, log,
                           timings=timings)
    clock.mark("the community headline's on-demand layout")
    print(json.dumps({"timings": timings}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
