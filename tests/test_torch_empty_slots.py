"""Every head's loss on a batch whose real graphs fill ``n_pad`` and whose
last graph slot is empty, against the JAX package's ``loss_and_metrics``
on the same weights (``params_from_numpy``) and the same arrays.

Such a slot has ``n_nodes`` 0 and a node offset of N, one past the last
row: the node-selection loss must neither index past the scores nor let
the slot add a term, a count or a correct answer.  The data-parallel step
(``parallel/train.py``) pads every part to the largest part's graph count,
so a part whose graphs fill its rows gets such a slot.

Tolerances (f32, the xla backend, the same math summed in another
order): the loss ``rtol=1e-5``; ``correct`` and ``count`` exact; the
node-selection gradients within 1e-5 of each leaf's relative Frobenius
norm (``tests/test_torch_train_model.py``'s f32 bound)."""

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import loss_and_metrics as jax_loss
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.models import (ModelConfig, loss_and_metrics,
                                   params_from_numpy)
from ggnn_tpu_torch.models.heads import node_offsets, node_select_loss
from ggnn_tpu_torch.ops.segment import segment_log_softmax
from ggnn_tpu_torch.train.loop import batch_arrays, param_leaves

torch.set_num_threads(1)
K, A, T, C = 3, 2, 3, 3
BASE = dict(state_dim=8, annotation_dim=A, n_edge_types=T, n_steps=3)
HEADS = {
    "node_select": dict(head="node_select"),
    "per_node": dict(head="per_node", n_classes=C),
    "graph_gated": dict(head="graph_gated", n_classes=C),
    "ggsnn_graph": dict(head="ggsnn", n_classes=5, n_rounds=K,
                        ggsnn_output="graph"),
    "ggsnn_node_sup": dict(head="ggsnn", n_classes=5, n_rounds=K,
                           ggsnn_output="node", ann_supervision=True),
}
# graphs' node counts filling 128 rows, then one empty slot
LAYOUTS = {"one_graph": (128,), "two_graphs": (64, 64)}


def _graphs(sizes, seed=0):
    rng = np.random.default_rng(seed)
    graphs = []
    for n in sizes:
        m = 3 * n
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, T, m),
                          rng.integers(0, n, m)], axis=1)
        klen = int(rng.integers(1, K + 1))
        seq = np.full(K, -1, np.int32)
        seq[:klen] = rng.integers(0, 5, klen)
        path = np.full(K, -1, np.int32)
        path[:klen] = rng.integers(0, n, klen)
        graphs.append(dict(
            n_nodes=n, edges=edges,
            annotations=(rng.random((n, A)) < 0.4).astype(np.float32),
            targets={"node": np.asarray(int(rng.integers(0, n)), np.int32),
                     "cls": np.asarray(int(rng.integers(0, C)), np.int32),
                     "seq": seq, "seq_nodes": path},
            node_targets={
                "node_labels": rng.integers(-1, C, n).astype(np.int32),
                "ann_seq": (rng.random((n, K, A)) < 0.5).astype(
                    np.float32)}))
    return graphs


def _batches(sizes):
    """(the port's batch, the JAX package's) of ``sizes``' graphs in
    ``len(sizes) + 1`` slots of 128 rows: the real nodes fill the rows
    and the last slot is empty."""
    graphs = _graphs(sizes)
    kw = dict(n_graphs=len(sizes) + 1, n_pad=128,
              e_pad=2 * sum(g["edges"].shape[0] for g in graphs),
              n_edge_types=T, annotation_dim=A)
    b, jb = batch_graphs(graphs, PaddingSpec(**kw)), \
        jax_batch_graphs(graphs, JaxSpec(**kw))
    assert int(b.node_mask.sum()) == b.spec.n_pad
    assert b.n_nodes[-1] == 0
    return b, jb


def _np_params(cfg_kw):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(3),
                                             JaxConfig(**cfg_kw)))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("head", sorted(HEADS))
def test_loss_on_a_tight_batch_with_an_empty_slot_matches_jax(head, layout):
    """The loss, ``correct`` and ``count`` of every head equal the JAX
    package's; for node_select the gradients too (the slot's clamped,
    masked term adds none)."""
    cfg_kw = dict(BASE, **HEADS[head])
    b, jb = _batches(LAYOUTS[layout])
    G = b.spec.n_graphs
    np_params = _np_params(cfg_kw)
    jarrays = jax.tree.map(jax.numpy.asarray, jb.arrays)
    jcfg = JaxConfig(**cfg_kw)
    fn = lambda p: jax_loss(p, jcfg, jarrays, G)      # noqa: E731
    if head == "node_select":
        fn = jax.value_and_grad(fn, has_aux=True)
    out = jax.jit(fn)(jax.tree.map(jax.numpy.asarray, np_params))
    (jl, jm), jg = out if head == "node_select" else (out, None)

    params = params_from_numpy(np_params)
    for p in param_leaves(params):
        p.requires_grad_(True)
    loss, m = loss_and_metrics(params, ModelConfig(**cfg_kw),
                               batch_arrays(b, "cpu"), G)
    assert torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k in ("correct", "count"):
        assert float(m[k]) == float(jm[k]), k
    if head != "node_select":
        return
    loss.backward()
    ref = {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
           for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    got = {"/".join(str(getattr(q, "key", q)) for q in path): p.grad.numpy()
           for path, p in jax.tree_util.tree_flatten_with_path(
               params, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert sorted(got) == sorted(ref)
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in ref.values()))
    for k, r in ref.items():
        assert np.isfinite(got[k]).all(), k
        if k == "head/b2":      # vanishes by the softmax's shift symmetry
            assert np.abs(got[k]).max() <= 1e-6 * norm, k
            continue
        err = np.linalg.norm(got[k] - r) / max(np.linalg.norm(r), 1e-30)
        assert err <= 1e-5, (k, err)


def test_node_select_loss_without_an_empty_slot_keeps_its_bits():
    """On a batch with padding rows after its graphs (no slot points past
    the scores), the clamped, masked loss is the unclamped product form bit
    for bit."""
    b = batch_graphs(_graphs((50, 60)), PaddingSpec(
        n_graphs=2, n_pad=128, e_pad=2 * 3 * 110, n_edge_types=T,
        annotation_dim=A))
    a = batch_arrays(b, "cpu")
    scores = torch.from_numpy(
        np.random.default_rng(1).standard_normal(128).astype(np.float32))
    loss, correct, mask = node_select_loss(
        scores, a["node_graph"], a["node_mask"], a["n_nodes"],
        a["targets"]["node"], 2)
    tgt = (node_offsets(a["n_nodes"]) + a["targets"]["node"]).long()
    logp = segment_log_softmax(scores, a["node_graph"], 3, a["node_mask"])
    gm = (a["n_nodes"] > 0).float()
    want = (-logp[tgt] * gm).sum() / gm.sum().clamp_min(1.0)
    assert torch.equal(loss, want)
    assert correct.shape == (2,) and torch.equal(mask, gm)
