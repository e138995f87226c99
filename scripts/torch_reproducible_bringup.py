"""The short first call on the card for the fixed-order segment sum, the
``[reproducible]`` and ``[oracle]`` phases of ``chip_smoke.py``.

    python3 scripts/torch_reproducible_bringup.py [--parent DIR] [--train1m]

With ``--parent DIR`` (an unpacked tree of an earlier commit, e.g. ``git
archive HEAD~1 | tar -x -C .chip_scratch/parent``) it first runs this
tree's ``[reproducible]`` cases on DIR's package: this ``chip_smoke.py`` is
copied into DIR and driven from there in a child process (DIR's kernels
built from DIR's sources), every case reported, none raised (the sharded
cases in two ranks spawned on cuda:0).  Then on this tree, in one process:
``setup()`` (the build), ``[segment rows]`` (the kernel against its plain
version at the xla headline and its seams, timed beside ``index_add_``),
``[reproducible]`` and its sharded cases, and ``[oracle]``, each reported
without raising; with ``--train1m`` also ``[1m train]`` (the 1M node-select
steps with the fixed-order normalizer).  Ends with the card's nvidia-smi
line and one JSON line of the cases' results.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

# The driver of a parent tree's run, written into DIR: its top level runs
# again in each spawned rank (before the rank's function is unpickled), so
# the launch counters, which the parent tree's package may lack, are
# stubbed there too.
PARENT_DRIVER = '''
import json, sys
sys.path.insert(0, ".")
import chip_smoke as C
C.zero_counts = lambda: None
C.read_counts = lambda: {}

if __name__ == "__main__":
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    C.setup()
    b = synthetic_batch(C.NODES, C.EDGES, C.EDGE_TYPES,
                        annotation_dim=C.ANN, seed=0, node_mult=128)
    results, _ = C.reproducible_phase(b, strict=False, count=False)
    del b
    C.run_ranks(lambda name, res: results.update(
        C.check_reproducible_sharded(res, C.card_line(), strict=False)),
        phases=(("[reproducible] sharded", C.rank_reproducible),))
    print("PARENT " + json.dumps(results), flush=True)
'''


def run_parent(parent):
    """This tree's [reproducible] cases on ``parent``'s package; returns
    their results (case -> bit-equal)."""
    shutil.copy(os.path.join(HERE, "chip_smoke.py"),
                os.path.join(parent, "chip_smoke.py"))
    with open(os.path.join(parent, "repro_parent.py"), "w") as f:
        f.write(PARENT_DRIVER)
    res = subprocess.run([sys.executable, "repro_parent.py"], cwd=parent,
                         capture_output=True, text=True, timeout=1500)
    print(res.stdout[-20000:], flush=True)
    if res.returncode != 0:
        print(f"[parent] exit {res.returncode}:\n{res.stderr[-6000:]}",
              flush=True)
        return {"error": res.returncode}
    line = next(x for x in res.stdout.splitlines() if x.startswith("PARENT "))
    return json.loads(line[len("PARENT "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--train1m", action="store_true")
    args = ap.parse_args()
    import chip_smoke as C
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    out = {}
    if args.parent:
        out["parent"] = run_parent(os.path.abspath(args.parent))
    clock = C.PhaseClock()
    C.setup()
    clock.mark("setup and build")
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(C.NODES, C.EDGES, C.EDGE_TYPES, annotation_dim=C.ANN,
                        seed=0, node_mult=128)
    log, timings = {}, {}
    try:
        C.segment_rows_phase(b, log, timings)
        out["segment_rows"] = timings.get("segment_rows_sum")
    except Exception as e:          # reported: this script measures
        print(f"[segment rows] FAILED: {e!r}", flush=True)
        out["segment_rows"] = repr(e)
    clock.mark("[segment rows]")
    results, launches = C.reproducible_phase(b, strict=False)
    del b
    torch.cuda.empty_cache()
    C.run_ranks(lambda name, res: results.update(
        C.check_reproducible_sharded(res, C.card_line(), strict=False)),
        phases=(("[reproducible] sharded", C.rank_reproducible),))
    out["change"] = results
    out["launches"] = launches
    clock.mark("[reproducible]")
    oracle = C.oracle_phase(strict=False)
    out["oracle_over"] = sorted(k for k, v in oracle.items() if v[0] > 1.0)
    out["oracle_worst"] = max(oracle.items(), key=lambda kv: kv[1][0])
    clock.mark("[oracle]")
    if args.train1m:
        C.train_1m_phase()
        clock.mark("[1m train]")
    print(C.card_line())
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
