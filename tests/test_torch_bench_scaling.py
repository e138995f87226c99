"""``bench_scaling_gpu.py``, the port of ``bench_scaling.py``, on two gloo
ranks on the CPU (``torch.distributed.run --nproc_per_node 2 ... --device
cpu``) at a tiny size, for halo_overlap and halo_window: its last line is
the reference's JSON record, key for key; P = 1's efficiency is 1.0; each
P's halo size is the JAX package's ``partition_batch``'s on the same
batch; and the edge count behind ``edges_per_sec`` is the JAX batch's
``edge_mask.sum()``."""

import json
import os
import re
import subprocess
import sys

import pytest

from ggnn_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from ggnn_tpu.parallel import partition as JP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(nodes=2048, edges=8192, types=8, dim=8, steps=2)
SHARDS = (1, 2)
STRATEGIES = ("halo_overlap", "halo_window")
KEYS = {"metric", "value", "unit", "vs_baseline", "strategy", "shards",
        "device"}
SHARD_KEYS = {"edges_per_sec", "edges_per_sec_per_chip", "halo_size",
              "efficiency"}


@pytest.fixture(scope="module")
def runs():
    """Both strategies' runs, started together; (stdout, stderr) each."""
    procs = {}
    for s in STRATEGIES:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", os.path.join(REPO,
                                                     "bench_scaling_gpu.py"),
               "--device", "cpu", "--iters", "1", "--strategy", s,
               "--shards", *map(str, SHARDS),
               *(x for k, v in SIZE.items() for x in (f"--{k}", str(v)))]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs[s] = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
    out = {}
    try:
        for s, p in procs.items():
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-4000:]
            out[s] = (stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _jax_batch():
    return jax_synthetic_batch(SIZE["nodes"], SIZE["edges"], SIZE["types"],
                               annotation_dim=8, seed=0,
                               node_mult=128 * max(SHARDS), n_communities=0,
                               p_intra=0.95)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_the_record_is_the_references(runs, strategy):
    """The last line's keys, unit, strategy, device and per-P keys; P = 1's
    efficiency 1.0; value and vs_baseline from the last P's efficiency."""
    rec = json.loads(runs[strategy][0].strip().splitlines()[-1])
    assert set(rec) == KEYS
    assert rec["metric"] == "scaling_efficiency"
    assert rec["unit"] == "frac_of_1chip_per_chip_throughput"
    assert rec["strategy"] == strategy and rec["device"] == "cpu"
    assert list(rec["shards"]) == [str(p) for p in SHARDS]
    for p, r in rec["shards"].items():
        assert set(r) == SHARD_KEYS
        assert r["edges_per_sec"] > 0
        assert r["edges_per_sec_per_chip"] == pytest.approx(
            r["edges_per_sec"] / int(p), abs=0.1)
    assert rec["shards"]["1"]["efficiency"] == 1.0
    last = rec["shards"][str(SHARDS[-1])]["efficiency"]
    assert rec["value"] == last and rec["vs_baseline"] == last / 0.9


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_halo_sizes_and_edge_count_are_the_jax_packages(runs, strategy):
    """Each P's halo size is the JAX partition's; each P's edges_per_sec is
    the JAX batch's directed edges × steps over the best time printed."""
    rec = json.loads(runs[strategy][0].strip().splitlines()[-1])
    jb = _jax_batch()
    n_dir = int(jb.edge_mask.sum())
    err = runs[strategy][1]
    assert f"# {n_dir} directed edges" in err, err
    for P in SHARDS:
        r = rec["shards"][str(P)]
        assert r["halo_size"] == JP.partition_batch(jb, P).halo_size
        best = float(re.search(rf"# P={P}: .* best (\S+) s", err).group(1))
        assert r["edges_per_sec"] == round(n_dir * SIZE["steps"] / best, 1)
