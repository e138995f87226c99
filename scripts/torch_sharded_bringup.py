"""The short first call on the card after the parallel layer
(``ggnn_tpu_torch/parallel``) changes.

    python3 scripts/torch_sharded_bringup.py

Imports ``chip_smoke.py`` and runs its sharded phases: ``setup()`` (the
kernels' build), the GGS-NN cell's batch and typed pack (``ggsnn_batch``),
then ``sharded_phases``: the single-device references on the card, two
ranks on cuda:0 over gloo (``[sharded serve]``, ``[sharded train]``,
``[sharded ggsnn]``, ``[ddp]``, each against the single-device path), and
``[sharded nccl]`` (a world of one rank on NCCL); then ``[dryrun]`` (the
entry forward, ``dryrun_multichip(2)`` and ``(3)``, and node_select on a
batch with an empty slot).  Prints each phase's time, the launches of the
sharded paths, then the card's nvidia-smi line.
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
        print("torch_sharded_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, _ = cs.setup()
    clock.mark("setup and build")
    _, batch, lay = cs.ggsnn_batch()
    holder = [batch, lay]
    del batch, lay
    launched = cs.sharded_phases(holder, clock)
    print(f"launches on the sharded paths "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    cs.dryrun_phase()
    clock.mark("[dryrun]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
