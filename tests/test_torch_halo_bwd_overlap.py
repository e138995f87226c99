"""The backward's reverse exchange in flight while the shard runs its own
backward (``ggnn_tpu_torch/parallel/comm.py``'s two nodes a collective,
``ops/window_step.py``'s split fused step): the transpose of the
reference's overlap, whose ``value_and_grad`` runs straight through the
``shard_map`` (``ggnn_tpu/parallel/halo.py:31-35``, ``:183-186``,
``:213-214``).

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``'s
``bwd_overlap`` runner; P = 2 on two data replicas) runs one
``make_sharded_train_step`` of halo_overlap and unfused halo_window in f32
and bf16 and of fused halo_window at D = 128 (table and on-demand), graph
index 1 holding each reverse all-to-all back HOLD_S seconds.  Every rank
records ``time.time()`` at each reverse collective's issue and wait, at
the backward spans, and at the begin and end of the backward of the nodes
recorded inside each step's ``halo/local`` span (the ranks share that
clock).  In every step rank 0's local backward has to begin after its
reverse issue and end before its peer issues: it cannot wait on the
collective.  The gradients and the Adam step's parameters are bit-equal
to the same step with each reverse collective waited on at its issue, and
the parameters bit-equal on every rank.  halo with a hot set issues the
hot rows' reduce-scatter and the reverse all-to-all before it waits for
either.  ``tests/test_torch_halo_train.py`` holds the same steps'
gradients to the JAX package."""

import numpy as np
import pytest

import torch_dist_cases as C
from test_torch_halo_train import CFG, CFG_WIN, LAYOUTS, LR, _batch
from torch_dist_worker import RankJob

HOLD_S = 0.5
SPLIT = ("halo_overlap-float32", "halo_overlap-bfloat16",
         "halo_window-float32", "halo_window-bfloat16", "fused-table",
         "fused-on-demand")
CASES = SPLIT + ("halo-hot",)


def _cases():
    b = _batch()
    cases = []
    for dt in ("float32", "bfloat16"):
        cfg = dict(CFG, compute_dtype=dt)
        params = C.jax_params(2, **cfg)
        for s in ("halo_overlap", "halo_window"):
            cases.append(dict(name=f"{s}-{dt}", kind="bwd_overlap", P=2,
                              batch=b, params=params, cfg=cfg, strategy=s,
                              lr=LR, layout=LAYOUTS.get((s, 2)),
                              hold_s=HOLD_S))
    pw = C.jax_params(2, **CFG_WIN)
    for od in (False, True):
        cases.append(dict(
            name=f"fused-{'on-demand' if od else 'table'}",
            kind="bwd_overlap", P=2, batch=b, params=pw, cfg=CFG_WIN,
            strategy="halo_window", lr=LR, hold_s=HOLD_S,
            layout=dict(kind="window", window=128, min_edges_per_tile=4,
                        spill_tile_e=None if od else 16, n_message_types=6,
                        with_grad=True, row_major="block", on_demand=od)))
    cases.append(dict(name="halo-hot", kind="bwd_overlap", P=4,
                      batch=C.skewed_batch(1024, 8192, 4, seed=6),
                      params=C.jax_params(0, **CFG), cfg=CFG,
                      strategy="halo", lr=LR, part=dict(hot_thresh=2),
                      hold_s=HOLD_S))
    return cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = _cases()
    j = RankJob(cases, 4, tmp_path_factory.mktemp("bwd_overlap_ranks"),
                timeout=300)
    j.cases = {c["name"]: c for c in cases}
    yield j
    j.wait()


def _issues(res, kind=0):
    """The times of a rank's reverse issues of ``kind`` (0: the
    all-to-all), in forward step order (the backward runs the last step
    first).  The first step sends rows of the initial states, which take
    no gradient: T − 1 of them."""
    rev = res["t/rev"]
    return rev[(rev[:, 1] == kind) & (rev[:, 2] == 0), 0][::-1]


@pytest.mark.parametrize("name", SPLIT)
def test_local_backward_runs_while_the_reverse_exchange_is_in_flight(job,
                                                                     name):
    """In every step with a reverse exchange (all but the first), on both
    replicas: rank 0's local backward begins after its reverse all-to-all
    is issued and ends before the held-back peer issues its own."""
    T = job.cases[name]["cfg"]["n_steps"]
    for r0 in (0, 2):
        me, peer = job.result(name, r0), job.result(name, r0 + 1)
        local, mine, theirs = me["t/local"], _issues(me), _issues(peer)
        assert local.shape == (T, 2) and np.isfinite(local).all(), local
        assert mine.shape == theirs.shape == (T - 1,), (mine, theirs)
        local = local[1:]
        late = local[:, 0] - mine
        assert (late > 0).all(), (
            f"rank {r0}'s local backward began {-late} s before its "
            "reverse all-to-all was issued")
        early = theirs - local[:, 1]
        assert (early > 0).all(), (
            f"rank {r0}'s local backward ended {-early} s after its peer "
            "issued the reverse all-to-all")


@pytest.mark.parametrize("name", SPLIT)
def test_backward_spans_hold_the_local_backward(job, name):
    """``halo/bwd_exchange`` opens before the reverse issue and holds the
    local backward, then ``halo/bwd_wait``, which returns after the peer
    issued; one of each a step with a reverse exchange."""
    T = job.cases[name]["cfg"]["n_steps"]
    for r0 in (0, 2):
        me, peer = job.result(name, r0), job.result(name, r0 + 1)
        exch = me["t/halo/bwd_exchange"][::-1]
        wait = me["t/halo/bwd_wait"][::-1]
        local = me["t/local"][1:]
        assert exch.shape == wait.shape == (T - 1, 2), (exch, wait)
        assert (exch[:, 0] <= _issues(me)).all()
        assert (exch[:, 0] <= local[:, 0]).all()
        assert (local[:, 1] <= wait[:, 0]).all()
        assert (wait[:, 1] <= exch[:, 1]).all()
        assert (wait[:, 1] >= _issues(peer)).all()


@pytest.mark.parametrize("name", CASES)
def test_gradients_are_the_synchronous_orders(job, name):
    """Every rank's loss, gradient leaves and updated parameters bit-equal
    to the same step with each reverse collective waited on at issue."""
    for r in range(4):
        res = job.result(name, r)
        keys = [k for k in res if k == "loss" or k[:2] in ("g/", "p/")]
        assert any(k.startswith("g/") for k in keys)
        assert sorted(keys) == sorted(k[5:] for k in res
                                      if k.startswith("sync/"))
        for k in keys:
            np.testing.assert_array_equal(res[k], res[f"sync/{k}"],
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", CASES)
def test_parameters_equal_on_every_rank(job, name):
    """The parameters after the Adam step bit-equal on every rank."""
    ref = job.result(name, 0)
    for r in range(1, 4):
        res = job.result(name, r)
        for k in ref:
            if k.startswith("p/"):
                np.testing.assert_array_equal(res[k], ref[k],
                                              err_msg=f"rank {r} {k}")


def test_hot_reduce_scatter_and_reverse_all_to_all_issued_together(job):
    """halo with a hot set: in every step with a reverse exchange each
    rank issues the reverse all-to-all and the hot rows' reduce-scatter
    before it waits for either."""
    T = job.cases["halo-hot"]["cfg"]["n_steps"]
    for r in range(4):
        rev = job.result("halo-hot", r)["t/rev"]
        assert rev.shape == (4 * (T - 1), 3), rev
        assert (np.diff(rev[:, 0]) >= 0).all()
        for k in range(T - 1):
            kind, waits = rev[4 * k:4 * k + 4, 1], rev[4 * k:4 * k + 4, 2]
            assert waits.tolist() == [0, 0, 1, 1], (r, k, rev)
            assert sorted(kind[:2].tolist()) == [0, 1], (r, k, rev)
