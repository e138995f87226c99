"""Serving under ``torch.no_grad`` with parameters that take gradients.

The port's custom autograd functions (``TypedFusedStep``,
``FusedWindowStep``, ``AggregateOnehot``) have a training forward that
keeps residuals and needs a layout's grad half.  Inside ``forward`` grad
mode is always off and ``ctx.needs_input_grad`` stays set under
``torch.no_grad``, so the serving decision is made before ``.apply``
(``ops/window.py::takes_grad``).  With trainable parameters under
``no_grad`` each of the three serves as with frozen ones: on a layout
without a grad half, bit for bit, with nothing kept for a backward; under
grad each still takes the training route and saves what it saved before.
CPU only: the wrappers run their plain versions on CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

from ggnn_tpu_torch.models import ModelConfig, propagate
from ggnn_tpu_torch.models.init import init_params
from ggnn_tpu_torch.ops import window_step as WS
from ggnn_tpu_torch.ops.scatter import aggregate_onehot, build_typed_dst_layout
from ggnn_tpu_torch.ops.window import build_window_layout
from ggnn_tpu_torch.train.loop import param_leaves

torch.set_num_threads(1)
N, E, T = 256, 2000, 3


def _edges(seed=0):
    r = np.random.default_rng(seed)
    csize = 64
    dst = r.integers(0, N, E)
    src = np.where(r.random(E) < 0.9,
                   (dst // csize) * csize + r.integers(0, csize, E),
                   r.integers(0, N, E)) % N
    return (src.astype(np.int32), dst.astype(np.int32),
            r.integers(0, 2 * T, E).astype(np.int32),
            (r.random(E) < 0.95).astype(np.float32))


def _params(cfg, trainable):
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    for p in param_leaves(params):
        p.requires_grad_(trainable)
    return params


def _ann(cfg):
    r = np.random.default_rng(2)
    return torch.as_tensor((r.random((N, cfg.annotation_dim)) < 0.3)
                           .astype(np.float32))


def _propagate(cfg, params, layout):
    edges = [torch.as_tensor(x) for x in _edges()]
    return propagate(params["prop"], cfg, _ann(cfg), *edges,
                     scatter_layout=layout)


def _typed(with_grad):
    return build_typed_dst_layout(*_edges(), N, 2 * T,
                                  with_grad=with_grad).to("cpu")


def _window(with_grad):
    return build_window_layout(*_edges(), N, window=128,
                               min_edges_per_tile=4, spill_tile_e=16,
                               n_message_types=2 * T, row_major="block",
                               block_rows=128,
                               with_grad=with_grad).to("cpu")


TYPED = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=T,
                    n_steps=2, backend="onehot", fuse_gru=True,
                    compute_dtype="bfloat16")
WINDOW = ModelConfig(state_dim=128, annotation_dim=2, n_edge_types=T,
                     n_steps=2, backend="window", fuse_gru=True,
                     compute_dtype="bfloat16")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_onehot_serves_without_grad_half(dtype):
    """The fused typed step on a serving layout (no grad half): under
    ``no_grad`` trainable parameters give frozen parameters' h bit for
    bit, where the training forward used to raise."""
    cfg = dataclasses.replace(TYPED, compute_dtype=dtype)
    lay = _typed(with_grad=False)
    with torch.no_grad():
        h_train = _propagate(cfg, _params(cfg, True), lay)
    h_frozen = _propagate(cfg, _params(cfg, False), lay)
    assert h_train.grad_fn is None and not h_train.requires_grad
    assert torch.equal(h_train, h_frozen)


def test_fused_onehot_under_grad_keeps_its_residuals():
    """Under grad the fused typed step still runs the training forward:
    it refuses a layout without a grad half, and on one with it saves the
    full residuals (h, W, W_a, U_zr, U_h, a, z, r, h̃)."""
    params = _params(TYPED, True)
    with pytest.raises(ValueError, match="grad half"):
        _propagate(TYPED, params, _typed(with_grad=False))
    h = _propagate(TYPED, params, _typed(with_grad=True))
    assert type(h.grad_fn).__name__ == "TypedFusedStepBackward"
    assert len(h.grad_fn.saved_tensors) == 9
    h.sum().backward()
    assert all(p.grad is not None for p in param_leaves(params["prop"]))


@pytest.fixture
def emit_res_spy(monkeypatch):
    """Every ``_fused_step_impl`` call's ``emit_res``, in order."""
    seen = []
    impl = WS._fused_step_impl

    def spy(*args, emit_res, **kw):
        seen.append(emit_res)
        return impl(*args, emit_res=emit_res, **kw)
    monkeypatch.setattr(WS, "_fused_step_impl", spy)
    return seen


def test_fused_window_serves_without_residuals(emit_res_spy):
    """The fused window step under ``no_grad`` with trainable parameters
    launches #13 without ``emit_res`` on a serving layout, and its h is
    the frozen parameters' bit for bit."""
    lay = _window(with_grad=False)
    with torch.no_grad():
        h_train = _propagate(WINDOW, _params(WINDOW, True), lay)
    assert emit_res_spy == [False] * WINDOW.n_steps
    h_frozen = _propagate(WINDOW, _params(WINDOW, False), lay)
    assert emit_res_spy == [False] * (2 * WINDOW.n_steps)
    assert h_train.grad_fn is None
    assert torch.equal(h_train, h_frozen)


def test_fused_window_under_grad_keeps_its_residuals(emit_res_spy):
    """Under grad the fused window step launches #13 with ``emit_res``
    and saves (h, W, W_a, U_zr, U_h, residuals), as before."""
    params = _params(WINDOW, True)
    h = _propagate(WINDOW, params, _window(with_grad=True))
    assert emit_res_spy == [True] * WINDOW.n_steps
    node = h.grad_fn.next_functions[0][0]        # under the [:N] slice
    assert type(node).__name__ == "FusedWindowStepBackward"
    assert len(node.saved_tensors) == 6
    h.sum().backward()
    assert all(p.grad is not None for p in param_leaves(params["prop"]))


def _agg_inputs(trainable):
    r = np.random.default_rng(3)
    h = torch.as_tensor(r.standard_normal((N, 8)).astype(np.float32))
    w = torch.as_tensor(r.standard_normal((2 * T, 8, 8)).astype(np.float32))
    b = torch.as_tensor(r.standard_normal((2 * T, 8)).astype(np.float32))
    return [x.requires_grad_(trainable) for x in (h, w, b)]


def test_aggregate_onehot_serves_without_grad_half():
    """``AggregateOnehot``'s aggregation under ``no_grad`` with inputs that
    require a gradient takes a layout without a grad half, keeps no graph,
    and equals the frozen inputs' bit for bit."""
    lay = _typed(with_grad=False)
    h, w, b = _agg_inputs(True)
    with torch.no_grad():
        a_train = aggregate_onehot(h, lay, w, b)
    h, w, b = _agg_inputs(False)
    a_frozen = aggregate_onehot(h, lay, w, b)
    assert a_train.grad_fn is None
    assert torch.equal(a_train, a_frozen)


def test_aggregate_onehot_under_grad_saves_h_and_w():
    """Under grad ``AggregateOnehot`` still refuses a layout without a
    grad half and, with it, saves h and ``msg_w`` for its backward."""
    h, w, b = _agg_inputs(True)
    with pytest.raises(ValueError, match="grad half"):
        aggregate_onehot(h, _typed(with_grad=False), w, b)
    a = aggregate_onehot(h, _typed(with_grad=True), w, b)
    assert type(a.grad_fn).__name__ == "AggregateOnehotBackward"
    saved = a.grad_fn.saved_tensors
    assert len(saved) == 2 and torch.equal(saved[0], h) \
        and torch.equal(saved[1], w)
    a.sum().backward()
    assert h.grad is not None and w.grad is not None and b.grad is not None
