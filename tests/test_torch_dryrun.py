"""The port's dry-run entry points (``ggnn_tpu_torch/dryrun.py``, the
counterpart of ``__graft_entry__.py``) on the CPU: ``entry``'s flagship
forward against the reference ``entry()``'s on the JAX package's weights
(f32, the xla backend: the same math summed in another order, rtol = atol
= 2e-5 of the largest score, as ``tests/test_torch_legacy.py`` holds f32
states), and ``dryrun_multichip(4, device="cpu")``: four gloo ranks run
the five sharded stages, and every rank reports the same losses and
shapes.  The card-side run is ``chip_smoke.py``'s ``[dryrun]``."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu_torch import dryrun
from ggnn_tpu_torch.models import params_from_numpy

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_forward_matches_the_reference():
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__ as G
    finally:
        sys.path.remove(REPO)
    jfn, (jparams, jarrays) = G.entry()
    ref = np.asarray(jax.jit(jfn)(jparams, jarrays))
    fn, (params, arrays) = dryrun.entry("cpu")
    got = fn(params_from_numpy(jax.tree.map(np.asarray, jparams)), arrays)
    assert got.shape == ref.shape == (4096,)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5 * scale)
    # the port's own weights (seed 0) give finite scores
    assert torch.isfinite(fn(params, arrays)).all()


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)


def test_dryrun_multichip_four_cpu_ranks(monkeypatch, capsys):
    """Four ranks (a 2 × 2 mesh for the data-parallel step, a graph axis
    of 4 for the others): every stage runs, its losses are finite and the
    same on every rank, the shapes are the global ones, and rank 0's line
    is printed."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = dryrun.dryrun_multichip(4, device="cpu")
    assert len(res) == 4
    for r in res[1:]:
        assert r == res[0]
    r = res[0]
    for k in ("train_loss_sum", "window_train_loss_sum",
              "ggsnn_train_loss_sum"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["halo_shape"] == (32, 8)
    assert r["halo_window_shape"] == (512, 8)
    assert r["q8_shape"] == (512, 128) and r["q8_finite"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        dryrun.summary(4, r)


def test_dryrun_multichip_three_cpu_ranks_runs_the_reference_batch(
        monkeypatch, capsys):
    """Three ranks on the reference's batch of 4 graphs of 6 nodes (the
    data-parallel step's parts hold 2, 1 and 1 graphs): every stage runs,
    its losses are finite and the same on every rank, and the halo
    propagation's global shape is the reference's (24, 8)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = dryrun.dryrun_multichip(3, device="cpu")
    assert len(res) == 3
    for r in res[1:]:
        assert r == res[0]
    r = res[0]
    for k in ("train_loss_sum", "window_train_loss_sum",
              "ggsnn_train_loss_sum"):
        assert np.isfinite(r[k]) and r[k] > 0, k
    assert r["halo_shape"] == (24, 8)
    assert r["q8_finite"]
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        dryrun.summary(3, r)
