"""``propagate(..., h0=...)``: the port's propagation started from a given
state against the JAX package's, on every backend, and the gradient with
respect to that state.

The same seeded numpy inputs (a Zipf-1.2 graph of 1,024 nodes from the
port's ``synthetic_batch``, nodes numbered by degree rank; block mode
declines there, so the onehot backend's block kernels run on a uniform
graph of 512 nodes) go to both packages; the port's wrappers run their
plain versions on the CPU, the JAX kernels Pallas in interpret mode.  f32
compute throughout, so the two sides differ only in the order of their f32
sums.  Tolerances, those of the neighbouring parity tests:

- the states after each step (``tests/test_torch_per_tile.py``'s propagate
  test): rtol = atol = 2e-5 on every row with at most 16 in-edges, and
  1e-4 on every row (a hub row sums hundreds of messages, |a| ≫ 1, and
  the rounding of its f32 sum grows with |a|);
- the gradient of Σ h_T ⊙ w with respect to h0: rtol 1e-4, atol 1e-5 on
  the xla and pallas backends (``tests/test_backend_grads.py``), rtol
  3e-4, atol 3e-5 on the window backend
  (``tests/test_torch_window_train.py``'s gradients through propagate),
  the atol times max(1, max|dh0|): through the hub rows dh0 reaches tens,
  and an element that cancels to near 0 keeps the rounding of its terms
  (as ``make_train_step``'s tests scale their atol by the leaf's
  largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.data.synthetic import synthetic_batch
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops import scatter as S
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)

T = 2                       # edge types (4 message types)


def _powerlaw():
    b = synthetic_batch(1024, 4000, T, annotation_dim=4, seed=0,
                        node_mult=128, powerlaw_alpha=1.2)
    edges = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask)
    return edges, b.spec.n_pad, b.type_offsets


def _uniform():
    r = np.random.default_rng(0)
    N, E = 512, 3000
    edges = (r.integers(0, N, E).astype(np.int32),
             r.integers(0, N, E).astype(np.int32),
             r.integers(0, 2 * T, E).astype(np.int32),
             (r.random(E) < 0.9).astype(np.float32))
    return edges, N, None


def _window_layouts(edges, N, on_demand, with_grad=False):
    kw = dict(window=256, block_rows=128, min_edges_per_tile=4,
              n_message_types=2 * T, row_major="block", typed_spill=True,
              on_demand=on_demand, with_grad=with_grad)
    lay = W.build_window_layout(*edges, N, **kw)
    ref = WP.DeviceWindowLayout(
        meta=lay.meta, arrays={k: jnp.asarray(np.asarray(v))
                               for k, v in lay.arrays.items()})
    return lay, ref


# name: (graph, D, config, layouts (edges, N) -> (port's, reference's))
CASES = {
    "xla": (_powerlaw, 8, dict(backend="xla"), None),
    "onehot_block": (_uniform, 128, dict(backend="onehot", fuse_gru=True),
                     "block"),
    "onehot_per_tile": (_powerlaw, 128, dict(backend="onehot",
                                             fuse_gru=True), "tile"),
    "onehot_per_tile_unfused": (_powerlaw, 128, dict(backend="onehot"),
                                "tile"),
    "window_table": (_powerlaw, 128, dict(backend="window", fuse_gru=True),
                     "table"),
    "window_on_demand": (_powerlaw, 128, dict(backend="window"),
                         "on_demand"),
    "pallas": (_powerlaw, 8, dict(backend="pallas"), None),
}


def _case(name):
    graph, D, cfg, lay = CASES[name]
    edges, N, offsets = graph()
    lay_t = lay_j = None
    if lay in ("block", "tile"):
        lay_j = SP.build_typed_dst_layout(*edges, N, 2 * T)
        lay_t = S.build_typed_dst_layout(*edges, N, 2 * T)
        assert (lay_t.block_meta is not None) == (lay == "block")
        lay_t = lay_t.to("cpu")
    elif lay is not None:
        lay_t, lay_j = _window_layouts(edges, N, lay == "on_demand")
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=T, n_steps=2,
              compute_dtype="float32", **cfg)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3),
                                               JaxConfig(**kw)))["prop"]
    r = np.random.default_rng(1)
    ann = (r.random((N, 4)) < 0.4).astype(np.float32)
    h0 = r.uniform(-1, 1, (N, D)).astype(np.float32)
    return edges, N, offsets, kw, params, ann, h0, lay_t, lay_j


def _jax_args(edges, offsets, lay_j):
    kw = dict(scatter_layout=lay_j)
    if offsets is not None:
        kw["type_offsets"] = jnp.asarray(offsets)
    return tuple(map(jnp.asarray, edges)), kw


def _torch_args(edges, offsets, lay_t):
    kw = dict(scatter_layout=lay_t)
    if offsets is not None:
        kw["type_offsets"] = torch.as_tensor(offsets)
    return tuple(map(torch.as_tensor, edges)), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_propagate_from_h0_matches_jax(name):
    """The per-step states from a random h0 on each backend: the port
    steps from h0, not from the annotations, as the reference does."""
    edges, N, offsets, kw, params, ann, h0, lay_t, lay_j = _case(name)
    je, jkw = _jax_args(edges, offsets, lay_j)
    _, ref = jax_propagate(params, JaxConfig(**kw), jnp.asarray(ann), *je,
                           h0=jnp.asarray(h0), collect_states=True, **jkw)
    te, tkw = _torch_args(edges, offsets, lay_t)
    with torch.no_grad():
        _, got = propagate(params_from_numpy(params), ModelConfig(**kw),
                           torch.tensor(ann), *te, h0=torch.tensor(h0),
                           collect_states=True, **tkw)
        _, plain = propagate(params_from_numpy(params), ModelConfig(**kw),
                             torch.tensor(ann), *te, collect_states=True,
                             **tkw)
    got, ref = got.numpy(), np.asarray(ref)
    low = np.bincount(edges[1][edges[3] > 0], minlength=N) <= 16
    np.testing.assert_allclose(got[:, low], ref[:, low], rtol=2e-5,
                               atol=2e-5)
    assert np.abs(got - ref).max() <= 1e-4
    # h0 is not the padded annotations, so it changes every state
    assert np.abs(got - plain.numpy()).max() > 1e-2


GRAD_CASES = [(b, remat) for b in ("xla", "pallas", "window_table")
              for remat in (False, True)]


@pytest.mark.parametrize("name,remat", GRAD_CASES)
def test_h0_gradient_matches_jax(name, remat):
    """d(Σ h_T ⊙ w)/dh0 through every step's custom backward (the plain
    GRU core, the pallas aggregation's, the fused window step's VJP), with
    and without recomputing each step (``remat``), against jax.grad."""
    edges, N, offsets, kw, params, ann, h0, lay_t, lay_j = _case(name)
    kw["remat"] = remat
    if name.startswith("window"):
        lay_t, lay_j = _window_layouts(edges, N, False, with_grad=True)
    w = np.random.default_rng(2).standard_normal(h0.shape).astype(
        np.float32)
    je, jkw = _jax_args(edges, offsets, lay_j)

    def jloss(h):
        hT = jax_propagate(params, JaxConfig(**kw), jnp.asarray(ann), *je,
                           h0=h, **jkw)
        return jnp.sum(hT * w)
    ref = np.asarray(jax.grad(jloss)(jnp.asarray(h0)))
    te, tkw = _torch_args(edges, offsets, lay_t)
    th0 = torch.tensor(h0, requires_grad=True)
    hT = propagate(params_from_numpy(params), ModelConfig(**kw),
                   torch.tensor(ann), *te, h0=th0, **tkw)
    (hT * torch.tensor(w)).sum().backward()
    rtol, atol = (3e-4, 3e-5) if name.startswith("window") else (1e-4, 1e-5)
    np.testing.assert_allclose(th0.grad.numpy(), ref, rtol=rtol,
                               atol=atol * max(1.0, np.abs(ref).max()))
