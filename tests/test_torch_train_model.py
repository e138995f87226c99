"""The port's training math against the JAX package's: gradients of
``propagate`` through every custom backward (onehot fused, fused with lean
residuals, unfused, remat; the xla backend in bf16, which runs the GRU-cell
kernels' path), the segment softmax, and ``loss_and_metrics`` for the three
ported heads.  The same numpy parameters and graphs go to both packages; the
JAX kernels run in Pallas interpret mode, the port's wrappers their plain
versions.  Tolerances (relative Frobenius error of each gradient leaf):

- f32: 1e-5 — the same math, sums taken in another order;
- bf16 (the compute dtype rounds h, the aggregation, the gate gradients
  and Y at the reference's points): 2**-8, half a bf16 ulp relative — a
  last-bit f32 difference can round a value to its bf16 neighbour, and
  such flips are rare and unsystematic; a systematic error (a missing
  term, a wrong rounding point) moves a leaf by far more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec, batch_graphs
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import loss_and_metrics as jax_loss
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops.scatter_pallas import build_typed_dst_layout as jax_layout
from ggnn_tpu.ops.segment import segment_log_softmax as jax_lsm
from ggnn_tpu.ops.segment import segment_softmax as jax_sm
from ggnn_tpu_torch.models import (ModelConfig, loss_and_metrics,
                                   params_from_numpy, propagate)
from ggnn_tpu_torch.models import ggnn as M
from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
from ggnn_tpu_torch.ops.segment import segment_log_softmax, segment_softmax
from ggnn_tpu_torch.train.loop import param_leaves

torch.set_num_threads(1)
RELF = {"float32": 1e-5, "bfloat16": 2.0 ** -8}


def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                             JaxConfig(**cfg_kw)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_grads(got_tree, ref_tree, tol, zero=()):
    """Every leaf's .grad against the JAX gradient tree.  The leaves in
    ``zero`` have a gradient that vanishes by the model's symmetry, so no
    scale of their own: both must be 0 up to rounding, ≤ 1e-6 of the whole
    gradient's norm."""
    got, ref = _leaves(got_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(ref)
    total = np.sqrt(sum(np.sum(np.asarray(r, np.float64) ** 2)
                        for r in ref.values()))
    for k, r in ref.items():
        g = got[k].grad
        assert g is not None and g.dtype == torch.float32, k
        r = np.asarray(r, np.float64)
        if k in zero:
            assert max(np.abs(g.numpy()).max(), np.abs(r).max()) \
                <= 1e-6 * total, (k, g, r)
            continue
        err = np.linalg.norm(g.numpy() - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= tol, (k, err)


def _trainable(np_tree):
    tree = params_from_numpy(np_tree)
    for p in param_leaves(tree):
        p.requires_grad_(True)
    return tree


MODES = {
    # name: (backend, fuse_gru, compute dtype, extra config)
    "onehot_fused_f32": ("onehot", True, "float32", {}),
    "onehot_fused_bf16": ("onehot", True, "bfloat16", {}),
    "onehot_fused_lean_bf16": ("onehot", True, "bfloat16",
                               {"lean_residuals": True}),
    "onehot_unfused_bf16": ("onehot", False, "bfloat16", {}),
    "onehot_fused_remat_bf16": ("onehot", True, "bfloat16", {"remat": True}),
    "xla_bf16": ("xla", False, "bfloat16", {}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_propagate_grads_match_jax(mode, monkeypatch):
    """d(Σ h_T ⊙ w)/d(prop params) of the port against the JAX package's,
    at D = 128 over 2 steps.  Where the reference runs its Pallas GRU cell
    (bf16, N % 128 == 0) the port's backward goes through gru_cell_bwd."""
    backend, fuse, cdt, extra = MODES[mode]
    N, E, T, D = 256, 1500, 2, 128
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=T, n_steps=2,
              backend=backend, fuse_gru=fuse, compute_dtype=cdt, **extra)
    params = _np_params(kw)
    r = np.random.default_rng(0)
    edges = (r.integers(0, N, E).astype(np.int32),
             r.integers(0, N, E).astype(np.int32),
             r.integers(0, 2 * T, E).astype(np.int32),
             (r.random(E) < 0.9).astype(np.float32))
    ann = (r.random((N, 4)) < 0.4).astype(np.float32)
    w = r.standard_normal((N, D)).astype(np.float32)
    lay_j = lay_t = None
    if backend == "onehot":
        lay_j = jax_layout(*edges, N, 2 * T, with_grad=True)
        lay_t = build_typed_dst_layout(*edges, N, 2 * T,
                                       with_grad=True).to("cpu")

    def jloss(prop):
        h = jax_propagate(prop, JaxConfig(**kw), jnp.asarray(ann),
                          *map(jnp.asarray, edges), scatter_layout=lay_j)
        return jnp.sum(h * w)
    ref_loss, ref = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, params["prop"]))
    bwd_calls, cell_bwd = [], M.gru_cell_bwd

    def spy(*a, **k):
        bwd_calls.append(a[0].shape)
        return cell_bwd(*a, **k)
    monkeypatch.setattr(M, "gru_cell_bwd", spy)
    prop = _trainable(params["prop"])
    h = propagate(prop, ModelConfig(**kw), torch.tensor(ann),
                  *map(torch.tensor, edges), scatter_layout=lay_t)
    loss = (h * torch.tensor(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    _assert_grads(prop, jax.tree.map(np.asarray, ref), RELF[cdt])
    # the GRU-cell backward runs exactly where the reference's Pallas
    # cell would: never on the fused path
    kernel_cell = not fuse and cdt == "bfloat16"
    assert len(bwd_calls) == (2 if kernel_cell else 0)


def test_lean_residuals_keep_the_primal_bit_identical():
    """Lean residuals change what the backward saves, never the forward:
    the fused step's output is bit-identical with full and lean residuals
    (tests/test_scatter_pallas.py holds the reference to the same)."""
    N, E, T, D = 256, 1500, 2, 128
    r = np.random.default_rng(1)
    edges = (r.integers(0, N, E), r.integers(0, N, E),
             r.integers(0, 2 * T, E), np.ones(E, np.float32))
    lay = build_typed_dst_layout(*edges, N, 2 * T, with_grad=True).to("cpu")
    ann = torch.tensor((r.random((N, 4)) < 0.4).astype(np.float32))
    outs = {}
    for lean in (False, True):
        kw = dict(state_dim=D, annotation_dim=4, n_edge_types=T, n_steps=2,
                  backend="onehot", fuse_gru=True, compute_dtype="bfloat16",
                  lean_residuals=lean)
        prop = _trainable(_np_params(kw)["prop"])
        outs[lean] = propagate(prop, ModelConfig(**kw), ann,
                               *map(torch.tensor, edges), scatter_layout=lay)
        assert outs[lean].requires_grad
    assert torch.equal(outs[False], outs[True])


@pytest.mark.parametrize("fn", ["softmax", "log_softmax"])
def test_segment_softmax_matches_jax(fn):
    """Per-segment softmax with padding entries and an all-padding
    segment: values and the gradient of a weighted sum (f32, 1e-6)."""
    r = np.random.default_rng(2)
    n, n_seg = 40, 4
    scores = (r.standard_normal(n) * 3).astype(np.float32)
    seg = np.sort(r.integers(0, n_seg - 1, n)).astype(np.int32)
    seg[-5:] = n_seg - 1                       # the padding segment
    mask = (r.random(n) < 0.8).astype(np.float32)
    mask[-5:] = 0
    w = r.standard_normal(n).astype(np.float32)
    jf, tf = ((jax_sm, segment_softmax) if fn == "softmax"
              else (jax_lsm, segment_log_softmax))
    ref, jvjp = jax.vjp(lambda s: jf(s, jnp.asarray(seg), n_seg,
                                     jnp.asarray(mask)), jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    got = tf(s, torch.tensor(seg), n_seg, torch.tensor(mask))
    (got * torch.tensor(w)).sum().backward()
    valid = mask > 0
    np.testing.assert_allclose(got.detach().numpy()[valid],
                               np.asarray(ref)[valid], rtol=1e-6, atol=1e-6)
    if fn == "softmax":
        np.testing.assert_array_equal(got.detach().numpy()[~valid], 0)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(
        jvjp(jnp.asarray(w))[0]), rtol=1e-6, atol=1e-6)


def _graphs(rng, k, n_classes):
    graphs = []
    for _ in range(k):
        n = int(rng.integers(5, 12))
        m = int(rng.integers(4, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        labels = rng.integers(-1, n_classes, n)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={"node": int(rng.integers(0, n)),
                                    "cls": int(rng.integers(0, n_classes))},
                           node_targets={"node_labels": labels}))
    return graphs


@pytest.mark.parametrize("head", ["node_select", "per_node", "graph_gated"])
def test_loss_and_metrics_match_jax(head, rng):
    """Loss, metrics and every parameter gradient of one padded batch
    (3 real graphs and one padding graph) in f32."""
    spec = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                       annotation_dim=2).round_up()
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              head=head, n_classes=1 if head == "node_select" else 3)
    params = _np_params(kw, seed=2)
    batch = batch_graphs(_graphs(rng, 3, 3), spec)
    arrays = batch.arrays
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda p: jax_loss(p, JaxConfig(**kw), jax.tree.map(
            jnp.asarray, arrays), 4), has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tp = _trainable(params)
    tarrays = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else torch.tensor(v))
               for k, v in arrays.items()}
    loss, m = loss_and_metrics(tp, ModelConfig(**kw), tarrays, 4)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(m[k].detach()), float(ref_m[k]), rtol=1e-5,
                                   err_msg=k)
    # node_select: shifting every score leaves each graph's softmax
    # unchanged, so the output bias has no gradient
    _assert_grads(tp, jax.tree.map(np.asarray, ref_g), RELF["float32"],
                  zero=("/head/b2",) if head == "node_select" else ())


def test_node_select_accuracy_takes_the_first_maximum():
    """The prediction is the first node reaching its graph's maximum, as
    the reference's segment argmax: a tie decides for the lower index."""
    from ggnn_tpu_torch.models.heads import node_select_loss
    scores = torch.tensor([1.0, 3.0, 3.0, 0.0, 2.0, 2.0, 0.0])
    node_graph = torch.tensor([0, 0, 0, 1, 1, 1, 2])
    node_mask = torch.tensor([1.0, 1, 1, 1, 1, 1, 0])
    n_nodes = torch.tensor([3, 3], dtype=torch.int32)
    _, correct, _ = node_select_loss(scores, node_graph, node_mask, n_nodes,
                                     torch.tensor([1, 2]), 2)
    assert correct.tolist() == [True, False]
