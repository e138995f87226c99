"""The reference's two 1M-node training configurations at a small size,
under remat, against the JAX package: ``1m_train_window``
(tests/test_perf_thresholds.py:65-69: community graph, W 512, block_rows
256, on-demand windows, the XW spill, fused) and
``1m_uniform_train_onehot`` (:87-89: the typed pack, fused; block mode
'auto' and off).

Each case makes its batch with both packages' ``synthetic_batch`` and its
with_grad layout with both builders (array for array), then takes the
gradients of Σh² over the propagation parameters through ``propagate``
with ``remat=True`` over 3 steps, against JAX's ``propagate`` with
``remat=True`` (``jax.checkpoint`` of each step; its Pallas kernels in
interpret mode, the port's wrappers their plain versions).  Tolerances:

- f32: rtol 3e-4, atol 3e-5 (``tests/test_torch_window_train.py``'s
  window train step): the same math, sums in another order, over 3 steps;
- bf16: 2**-8 relative Frobenius error per leaf
  (``tests/test_torch_train_model.py``): a last-bit f32 difference can
  round a value to its bf16 neighbour; such flips are rare and
  unsystematic.

The port's gradients with ``remat=True`` and ``remat=False`` must be
bit-equal: the recompute runs the same functions on the same inputs (one
CPU thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.data.synthetic import synthetic_batch as jax_synthetic
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops.scatter_pallas import build_typed_dst_layout as jax_typed
from ggnn_tpu.ops.window_pallas import build_window_layout as jax_window
from ggnn_tpu_torch.data.synthetic import synthetic_batch
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
from ggnn_tpu_torch.ops.window import build_window_layout
from ggnn_tpu_torch.train.checkpoint import _flatten
from ggnn_tpu_torch.train.loop import param_leaves

torch.set_num_threads(1)

N, E, TYPES, D, STEPS, ANN = 2048, 8000, 4, 128, 3, 8
T2 = 2 * TYPES
RELF_BF16 = 2.0 ** -8

CASES = {
    # name: (backend, fuse_gru, layout option, compute dtype)
    **{f"window_{'fused' if f else 'unfused'}_{dt}":
       ("window", f, None, dt)
       for f in (True, False) for dt in ("float32", "bfloat16")},
    **{f"onehot_block_{bm}_{dt}": ("onehot", True, bm, dt)
       for bm in ("auto", False) for dt in ("float32", "bfloat16")},
}


def _batch(backend):
    """The cell's batch from both packages, checked equal array for
    array."""
    kw = (dict(node_mult=256, n_communities=16, p_intra=0.95)
          if backend == "window" else dict(node_mult=128))
    got = synthetic_batch(N, E, TYPES, annotation_dim=ANN, seed=0, **kw)
    ref = jax_synthetic(N, E, TYPES, annotation_dim=ANN, seed=0, **kw)
    assert vars(got.spec) == vars(ref.spec)
    for k in ("annotations", "edge_src", "edge_dst", "edge_type",
              "edge_mask", "type_offsets"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    return got


def _layouts(backend, block_mode, b):
    """The cell's with_grad layout from both builders (the reference's
    numpy path), checked equal array for array."""
    edges = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask)
    if backend == "window":
        kw = dict(window=512, n_message_types=T2, block_rows=256,
                  typed_spill=True, on_demand=True, row_major="block",
                  with_grad=True)
        got = build_window_layout(*edges, b.spec.n_pad, **kw)
        ref = jax_window(*edges, b.spec.n_pad, use_native=False, **kw)
        assert got.meta == tuple(ref.meta)
        assert got.grad_meta[4] and len(got.spill_meta) > 8, \
            "not the fused backward over the XW spill"
    else:
        got = build_typed_dst_layout(*edges, b.spec.n_pad, T2, with_grad=True,
                                     block_mode=block_mode)
        ref = jax_typed(*edges, b.spec.n_pad, T2, with_grad=True,
                        block_mode=block_mode)
        assert got.meta == ref.meta
        # block mode and the octet grad half engage on 'auto' (#1, #5);
        # off, the per-tile arrays and the legacy grad half (#7, #11)
        auto = block_mode == "auto"
        assert (got.block_meta is not None) == auto
        assert (got.meta[5][0] == "octet") == auto
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        a, v = np.asarray(got.arrays[k]), np.asarray(v)
        assert a.dtype == v.dtype, (k, a.dtype, v.dtype)
        np.testing.assert_array_equal(a, v, err_msg=k)
    return got, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_grads_match_jax(case):
    backend, fuse, block_mode, cdt = CASES[case]
    b = _batch(backend)
    lay, ref_lay = _layouts(backend, block_mode, b)
    mk = dict(state_dim=D, annotation_dim=ANN, n_edge_types=TYPES,
              n_steps=STEPS, backend=backend, fuse_gru=fuse,
              compute_dtype=cdt, remat=True)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                               JaxConfig(**mk)))["prop"]
    edges = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask)
    if backend == "onehot":
        lay = lay.to("cpu")

    def loss_j(p):
        h = jax_propagate(p, JaxConfig(**mk), jnp.asarray(b.annotations),
                          *map(jnp.asarray, edges), scatter_layout=ref_lay)
        return jnp.sum(h * h)

    ref = params_from_numpy(jax.tree.map(np.asarray, jax.grad(loss_j)(
        jax.tree.map(jnp.asarray, params))))

    def grads(remat):
        tp = params_from_numpy(params)
        for p in param_leaves(tp):
            p.requires_grad_(True)
        h = propagate(tp, ModelConfig(**dict(mk, remat=remat)),
                      torch.tensor(b.annotations),
                      *map(torch.tensor, edges), scatter_layout=lay)
        (h * h).sum().backward()
        return {k: p.grad for k, p in _flatten(tp)}

    got = grads(True)
    for k, r in _flatten(ref):
        g, r = got[k].numpy(), r.numpy()
        if cdt == "float32":
            np.testing.assert_allclose(g, r, rtol=3e-4, atol=3e-5,
                                       err_msg=k)
        else:
            err = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
            assert err <= RELF_BF16, (k, err)
    plain = grads(False)
    for k, g in got.items():
        assert torch.equal(g, plain[k]), k


@pytest.mark.parametrize("spread", [0.5, 2.0])
def test_node_select_normalizer_at_1m_nodes(spread):
    """The node-select softmax over one graph of 1,000,192 nodes (the 1M
    cells' loss): its normalizer is the f64 sum rounded once, so the
    probabilities sum to 1 within f32 rounding, and the gradient of a
    target's log-probability sums to 0 over the nodes (the softmax is
    shift-invariant: b2's gradient, SYMMETRIC_LEAVES).  An f32
    ``index_add`` of the 10^6 terms and a gradient through the shift drift
    by 1e-5 and more, in an order the card's atomics pick anew each run."""
    from ggnn_tpu_torch.ops.segment import segment_log_softmax
    n = 1_000_192
    r = np.random.default_rng(3)
    scores = torch.tensor(r.standard_normal(n) * spread, dtype=torch.float32,
                          requires_grad=True)
    seg = torch.zeros(n, dtype=torch.int32)
    seg[-192:] = 1                                  # the padding segment
    mask = (seg == 0).float()
    logp = segment_log_softmax(scores, seg, 2, mask)
    p = torch.exp(logp.detach()[:-192]).double()
    assert abs(p.sum().item() - 1.0) <= 1e-6
    (g,) = torch.autograd.grad(logp[12345], scores)
    assert abs(g.double().sum().item()) <= 1e-6
