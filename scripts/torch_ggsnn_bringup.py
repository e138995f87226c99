"""The short first call on the card after GGS-NN (``models/ggsnn.py``) or
the native host library (``ggnn_tpu_torch/native``) change.

    python3 scripts/torch_ggsnn_bringup.py

Imports ``chip_smoke.py`` and runs its own GGS-NN and native phases:
``setup()`` (the kernels' build), then ``ggsnn_phases``: ``[ggsnn serve]``
(the headline model as a GGS-NN of 3 rounds on 64 graphs of 4,096 nodes,
both outputs, typed pack fused and pallas, against the plain path on the
card), ``[ggsnn train]`` (3 Adam steps each of the typed pack fused with
both outputs, unfused, and pallas, the first step against the plain path),
the Trainer CLI on bAbI 19 (``babi19_small``, ``babi19``) and ``[native]``
(the native sort and the window Predictor's layout at the community
headline against numpy).  Prints each phase's time, the launches of the
served and trained paths, then the card's nvidia-smi line.
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
        print("torch_ggsnn_bringup: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    clock = cs.PhaseClock()
    card, _ = cs.setup()
    clock.mark("setup and build")
    launched = cs.ggsnn_phases({}, clock)
    print(f"launches on the GGS-NN paths "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
