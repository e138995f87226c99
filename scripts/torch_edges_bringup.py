"""The short first call on the card after the port's edges change: the
profiling hooks and the CLI's ``--profile``, the examples, the
distributed example and the dry run.

    python3 scripts/torch_edges_bringup.py

Imports ``chip_smoke.py`` and runs its phases of those: ``setup()`` (the
kernels' build), ``[profile]``, ``[examples]``, ``[distributed example]``
and ``[dryrun]``, with their checks.  Prints each phase's time, their
launches, then the card's nvidia-smi line.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_edges_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, _ = cs.setup()
    clock.mark("setup and build")
    launched = dict.fromkeys(cs.KERNELS, 0)
    for tag, phase in (("[profile]", cs.profile_phase),
                       ("[examples]", lambda: cs.examples_phase({})),
                       ("[distributed example]", cs.dist_example_phase)):
        for k, v in phase().items():
            launched[k] += v
        clock.mark(tag)
    cs.dryrun_phase()
    clock.mark("[dryrun]")
    print(f"launches on the edges' paths "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
