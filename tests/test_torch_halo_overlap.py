"""The exchange in flight while the shard aggregates its own edges
(``ggnn_tpu_torch/parallel/halo.py``: halo_overlap and unfused
halo_window, as the reference's ``ggnn_tpu/parallel/halo.py:183-186``,
``:212-215``).

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``'s
``overlap`` runner; P = 2 on two data replicas) runs each strategy in f32
and bf16 with graph index 1 holding its all-to-all back HOLD_S seconds
each step.  Every rank records ``time.time()`` at the enter and exit of its
``halo/exchange`` and ``halo/local`` spans and at each all-to-all's issue
(the ranks share that clock).  Rank 0's local aggregation has to lie inside
its exchange span and end before its peer has issued the exchange: it
cannot wait on the collective.  The outputs are bit-equal to the serial
composition (the synchronous ``comm.all_to_all``, then the same
aggregations) and within ``tests/test_torch_halo.py``'s tolerances of the
JAX package's ``sharded_propagate``."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_dist_cases as C
from test_torch_halo import CFG, LAYOUTS, _check, _community, _jax_sharded
from torch_dist_worker import RankJob

HOLD_S = 0.5
STRATEGIES = ("halo_overlap", "halo_window")
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = C.overlap_cases(_community(), CFG, LAYOUTS, HOLD_S)
    j = RankJob(cases, 4, tmp_path_factory.mktemp("overlap_ranks"),
                timeout=300)
    j.cases = {c["name"]: c for c in cases}
    yield j
    j.wait()


@pytest.fixture(scope="module")
def refs(job):
    """The JAX references, a few at a time while the ranks run."""
    with ThreadPoolExecutor(max(1, min(3, (os.cpu_count() or 2) - 1))) as ex:
        return dict(zip(job.cases, ex.map(
            lambda n: _jax_sharded(job.cases[n]), job.cases)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_overlap_matches_jax(job, refs, strategy, dtype):
    """The overlapped h against the JAX package's sharded_propagate, at
    test_torch_halo.py's tolerances."""
    name = f"{strategy}-{dtype}"
    _check(C.gather_h(job, name, 2), refs[name], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_local_aggregation_does_not_wait_for_the_peer(job, strategy, dtype):
    """In every step, on both replicas: the local span lies inside the
    exchange span, and ends before the held-back peer issues its
    all-to-all."""
    name = f"{strategy}-{dtype}"
    T = job.cases[name]["cfg"]["n_steps"]
    for r0 in (0, 2):
        me, peer = job.result(name, r0), job.result(name, r0 + 1)
        exch, local = me["t/halo/exchange"], me["t/halo/local"]
        issued = peer["t/issue"][:, 0]
        assert exch.shape == local.shape == (T, 2), (exch, local)
        assert issued.shape == (T,)
        assert (exch[:, 0] <= local[:, 0]).all()
        assert (local[:, 1] <= exch[:, 1]).all()
        early = issued - local[:, 1]
        assert (early > 0).all(), (
            f"rank {r0}'s local aggregation ended {-early} s after its "
            "peer issued the exchange")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_overlap_is_the_serial_composition(job, strategy, dtype):
    """Every rank's h bit-equal to the serial composition's."""
    name = f"{strategy}-{dtype}"
    for r in range(4):
        res = job.result(name, r)
        np.testing.assert_array_equal(res["h"], res["serial"])
