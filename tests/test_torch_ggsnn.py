"""GGS-NN in the port (``ggnn_tpu_torch/models/ggsnn.py`` and the paths
that run it: ``models/api.py``, ``Predictor``, ``Trainer``) against the JAX
package: the round outputs and annotations on every backend, both outputs,
shared and per-round nets; the gradients of ``loss_and_metrics`` with and
without annotation supervision; the NumPy oracle; the layouts built once
for all rounds; the node loss's tie rule; decoding; a JAX checkpoint
resumed; and bAbI task 19 trained on the CPU.

The same seeded numpy inputs (3 graphs, 3 edge types, D = 8, K = 3
rounds of T = 2 steps) go to both packages; the port's kernel wrappers run
their plain versions on the CPU, the JAX package's Pallas kernels run in
interpret mode.  Tolerances:

- outputs and annotations, f32: max |port − JAX| ≤ 1e-5 · max |JAX| (the
  same math, f32 sums in another order, over K·T steps);
- in bf16 (the xla and pallas backends, D = 16): ≤ 2**-6 · max(1, max
  |JAX|): both packages round to bf16 at the same points, and a last-bit
  difference of an f32 sum can round a value to the other neighbour, which
  the next rounds carry (the bound the card holds the first train step of
  bf16 paths to, ``chip_smoke.py`` ``TOL_TRAIN``);
- gradients of ``loss_and_metrics``: rtol 1e-4, atol 1e-5 ·
  max(1, max|ref|) (``tests/test_torch_propagate_h0.py``'s xla and pallas
  bound), rtol 3e-4, atol 3e-5 · max(1, max|ref|) on the window backend
  (that file's window bound);
- the oracle: rtol 3e-5, atol 3e-6 (``tests/test_oracle_parity.py``).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
from ggnn_tpu.infer import Predictor as JaxPredictor
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import loss_and_metrics as jax_loss_and_metrics
from ggnn_tpu.models.ggsnn import ggsnn_forward as jax_ggsnn_forward
from ggnn_tpu.models.ggsnn import ggsnn_node_loss as jax_node_loss
from ggnn_tpu.oracle import oracle_ggsnn
from ggnn_tpu.ops import scatter_pallas as JSP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu.train import Trainer as JaxTrainer
from ggnn_tpu.train import build_config as jax_build_config
from ggnn_tpu.train.metrics import MetricsLogger as JaxLogger
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy
from ggnn_tpu_torch.models import ggnn as GG
from ggnn_tpu_torch.models import ggsnn as G
from ggnn_tpu_torch.models.api import loss_and_metrics
from ggnn_tpu_torch.models.init import init_params
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import spmm as SP
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.train import Trainer, build_config
from ggnn_tpu_torch.train.checkpoint import _flatten
from ggnn_tpu_torch.train.loop import batch_arrays, param_leaves
from ggnn_tpu_torch.train.metrics import MetricsLogger

torch.set_num_threads(1)

E, A, K, V = 3, 2, 3, 5
_ARRAYS = ("annotations", "node_graph", "node_mask", "edge_src", "edge_dst",
           "edge_type", "edge_mask")


def _graphs(seed, n_graphs=3):
    """Random graphs with GGS-NN targets: tokens ``seq`` and path nodes
    ``seq_nodes`` (−1 past a random length in 1..K), and per-round
    annotation targets ``ann_seq`` [n, K, A]."""
    r = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(r.integers(6, 12))
        m = int(r.integers(5, 2 * n))
        edges = np.stack([r.integers(0, n, m), r.integers(0, E, m),
                          r.integers(0, n, m)], axis=1)
        length = int(r.integers(1, K + 1))
        seq = np.full(K, -1, np.int32)
        seq[:length] = r.integers(0, V, length)
        nodes = np.full(K, -1, np.int32)
        nodes[:length] = r.integers(0, n, length)
        graphs.append(dict(
            n_nodes=n, edges=edges,
            annotations=(r.random((n, A)) < 0.5).astype(np.float32),
            targets={"seq": seq, "seq_nodes": nodes},
            node_targets={"ann_seq": (r.random((n, K, A)) < 0.3).astype(
                np.float32)}))
    return graphs


def _batches(seed):
    """(the JAX batch, the port's batch) of the same graphs: 256 padded
    nodes (a multiple of 128, as the onehot and window layouts want)."""
    graphs = _graphs(seed)
    kw = dict(n_graphs=len(graphs), n_pad=256,
              e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
              n_edge_types=E, annotation_dim=A)
    pads = {"seq": ((K,), -1), "seq_nodes": ((K,), -1)}
    jb = jax_batch_graphs(graphs, JaxSpec(**kw).round_up(), pads)
    tb = batch_graphs(graphs, PaddingSpec(**kw).round_up(), pads)
    return jb, tb


def _kw(backend, output="graph", share=True, dtype="float32", D=8, **extra):
    return dict(state_dim=D, annotation_dim=A, n_edge_types=E, n_steps=2,
                head="ggsnn", n_classes=V, n_rounds=K, ggsnn_output=output,
                share_round_nets=share, backend=backend, compute_dtype=dtype,
                ann_supervision=True, **extra)


def _np_params(kw, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                             JaxConfig(**kw)))


def _layouts(backend, jb, tb, with_grad=False, default=False):
    """(the JAX layout, the port's) of a batch: ``layout_for_batch`` for
    onehot (the port's None with ``default``: its own default layout),
    ``build_window_layout`` (W 64) for window, None otherwise."""
    if backend == "onehot":
        lay_t = (None if default else
                 L.layout_for_batch(tb, with_grad=with_grad, device="cpu"))
        return JSP.layout_for_batch(jb, with_grad=with_grad), lay_t
    if backend == "window":
        args = (jb.edge_src, jb.edge_dst, jb.edge_type, jb.edge_mask,
                jb.spec.n_pad)
        kw = dict(window=64, min_edges_per_tile=4, n_message_types=2 * E,
                  with_grad=with_grad)
        return (WP.build_window_layout(*args, **kw),
                W.build_window_layout(*args, use_native=False, **kw))
    return None, None


def _jax_forward(params, kw, jb, lay):
    return jax_ggsnn_forward(
        jax.tree.map(jnp.asarray, params), JaxConfig(**kw),
        *(jnp.asarray(getattr(jb, k)) for k in _ARRAYS),
        n_graphs=jb.spec.n_graphs, type_offsets=jnp.asarray(jb.type_offsets),
        scatter_layout=lay)


def _torch_forward(params, kw, tb, lay):
    return G.ggsnn_forward(
        params_from_numpy(params), ModelConfig(**kw),
        *(torch.as_tensor(getattr(tb, k)) for k in _ARRAYS),
        n_graphs=tb.spec.n_graphs,
        type_offsets=torch.as_tensor(tb.type_offsets), scatter_layout=lay)


# every backend with both outputs and both settings of share_round_nets
# (two cases each); xla also with the other two pairs
FORWARD_CASES = [(b, out, share) for b in ("xla", "onehot", "onehot_default",
                                            "pallas", "window")
                 for out, share in (("graph", True), ("node", False))] + [
    ("xla", "graph", False), ("xla", "node", True)]


@pytest.mark.parametrize("backend,output,share", FORWARD_CASES)
def test_ggsnn_forward_matches_jax(backend, output, share):
    """The round outputs [K, B, V] / [K, N] and annotations [K, N, A] on
    each backend against the JAX ``ggsnn_forward``; ``onehot_default`` is
    the port's default legacy layout (built once for the rounds) against
    the JAX package's ``layout_for_batch``."""
    jb, tb = _batches(0)
    base = backend.split("_")[0]
    kw = _kw(base, output, share)
    params = _np_params(kw)
    lay_j, lay_t = _layouts(base, jb, tb, default=backend.endswith(
        "default"))
    ref_out, ref_ann = map(np.asarray, _jax_forward(params, kw, jb, lay_j))
    with torch.no_grad():
        out, ann = _torch_forward(params, kw, tb, lay_t)
    want = (K, jb.spec.n_graphs, V) if output == "graph" else (
        K, jb.spec.n_pad)
    assert out.shape == want and ann.shape == (K, jb.spec.n_pad, A)
    for got, ref in ((out.numpy(), ref_out), (ann.numpy(), ref_ann)):
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ggsnn_forward_bf16_matches_jax(backend):
    """bf16 compute (D = 16, f32 sums) against the JAX package: within
    2**-6 · max(1, max|JAX|) (see the module's tolerances)."""
    jb, tb = _batches(1)
    kw = _kw(backend, dtype="bfloat16", D=16)
    params = _np_params(kw)
    ref = [np.asarray(x) for x in _jax_forward(params, kw, jb, None)]
    with torch.no_grad():
        got = [x.numpy() for x in _torch_forward(params, kw, tb, None)]
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 2.0 ** -6 * max(1.0, np.abs(r).max())


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


GRAD_CASES = [(b, out, sup) for b in ("xla", "onehot", "pallas", "window")
              for out, sup in (("graph", True), ("node", False))] + [
    ("xla", "graph", False), ("xla", "node", True)]


@pytest.mark.parametrize("backend,output,ann_seq", GRAD_CASES)
def test_ggsnn_grads_match_jax(backend, output, ann_seq):
    """Gradients of ``loss_and_metrics`` (the sequence loss, with and
    without the annotation BCE of ``ann_seq``) for every out, ann and prop
    leaf against ``jax.grad`` of the JAX ``loss_and_metrics``; every
    round's gradient crosses ``init_state``'s pad into the round before."""
    jb, tb = _batches(2)
    kw = _kw(backend, output, share=output == "node")
    params = _np_params(kw)
    lay_j, lay_t = _layouts(backend, jb, tb, with_grad=True)
    jarrays = jax.tree.map(jnp.asarray, jb.arrays)
    tarrays = batch_arrays(tb, "cpu")
    if not ann_seq:
        del jarrays["targets"]["ann_seq"], tarrays["targets"]["ann_seq"]

    def jloss(p):
        return jax_loss_and_metrics(p, JaxConfig(**kw), jarrays,
                                    jb.spec.n_graphs, scatter_layout=lay_j)
    (jl, jm), ref = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params)
    leaves = dict(_leaves(tp))
    for v in leaves.values():
        v.requires_grad_(True)
    loss, m = loss_and_metrics(tp, ModelConfig(**kw), tarrays,
                               tb.spec.n_graphs, scatter_layout=lay_t)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in ("correct", "count"):
        assert float(m[k]) == float(jm[k])
    ref = dict(_leaves(ref))
    rtol, atol = (3e-4, 3e-5) if backend == "window" else (1e-4, 1e-5)
    assert {k.split("/")[0] for k in leaves} == {"prop", "out", "ann"}
    for (key, g) in zip(leaves, grads):
        r = np.asarray(ref[key])
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(r).max()),
                                   err_msg=key)


def _oracle_batch(seed):
    """``tests/test_oracle_parity.py``'s random graphs (3 to 8 nodes, 4
    edge types) and batch."""
    r = np.random.default_rng(seed)
    graphs = []
    for _ in range(3):
        n = int(r.integers(3, 9))
        m = int(r.integers(1, 2 * n))
        edges = np.stack([r.integers(0, n, m), r.integers(0, 4, m),
                          r.integers(0, n, m)], axis=1)
        graphs.append(dict(n_nodes=n, edges=edges, targets={},
                           annotations=(r.random((n, 2)) < 0.4).astype(
                               np.float32)))
    spec = PaddingSpec(
        n_graphs=3, n_pad=sum(g["n_nodes"] for g in graphs) + 5,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 6,
        n_edge_types=4, annotation_dim=2).round_up()
    return graphs, batch_graphs(graphs, spec)


@pytest.mark.parametrize("output", ["graph", "node"])
def test_ggsnn_oracle_parity(output):
    """The port against ``oracle_ggsnn`` (f64 NumPy) per graph and round,
    as ``tests/test_oracle_parity.py`` holds the JAX package."""
    graphs, b = _oracle_batch(3 if output == "graph" else 4)
    cfg = ModelConfig(state_dim=4, annotation_dim=2, n_edge_types=4,
                      n_steps=3, head="ggsnn", n_classes=V, n_rounds=K,
                      ggsnn_output=output)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4),
                                               JaxConfig(**dataclasses.asdict(
                                                   cfg))))
    with torch.no_grad():
        out, anns = G.ggsnn_forward(
            params_from_numpy(params), cfg,
            *(torch.as_tensor(getattr(b, k)) for k in _ARRAYS),
            n_graphs=b.spec.n_graphs)
    out, anns = out.numpy(), anns.numpy()
    p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref, _, ref_anns = oracle_ggsnn(p64, g["annotations"], g["edges"], 4,
                                        cfg.n_steps, K, output=output)
        sl = slice(offs[gi], offs[gi] + g["n_nodes"])
        for k in range(K):
            got = out[k, sl] if output == "node" else out[k, gi]
            np.testing.assert_allclose(got, ref[k], rtol=3e-5, atol=3e-6)
            np.testing.assert_allclose(anns[k, sl], ref_anns[k + 1],
                                       rtol=3e-5, atol=3e-6)


def test_per_round_ggsnn_nets():
    """Per-round nets (``share_round_nets=False``): every out and ann leaf
    is stacked on a leading K, and round k reads entry k only (zeroing
    round 1's output weights moves round 1's logits and no other round's),
    as ``tests/test_variants.py`` holds the JAX package."""
    _, tb = _batches(5)
    cfg = ModelConfig(**_kw("xla", share=False))
    params = init_params(cfg, torch.Generator().manual_seed(1))
    assert params["out"]["gi_w"].shape[0] == K
    assert params["ann"]["a1"].shape[0] == K
    args = [torch.as_tensor(getattr(tb, k)) for k in _ARRAYS]
    with torch.no_grad():
        out, _ = G.ggsnn_forward(params, cfg, *args, n_graphs=3)
        params["out"]["c2"][1] = 0.0
        out2, _ = G.ggsnn_forward(params, cfg, *args, n_graphs=3)
    assert out.shape == (K, 3, V) and torch.isfinite(out).all()
    assert not torch.allclose(out2[1], out[1])
    assert torch.equal(out2[0], out[0])


@pytest.mark.parametrize("backend", ["onehot", "pallas", "window"])
def test_layouts_built_once_for_all_rounds(backend, monkeypatch):
    """Each default layout is built once before the round loop, and every
    round's ``propagate`` gets the same layout tensors, so the kernels'
    per-layout plans and checks (``cached_per_tensor``, keyed by those
    tensors) are made once for the K rounds: the legacy onehot layout (on
    the host), the pallas type tiles, and a host-form window layout moved
    to the device once."""
    _, tb = _batches(6)
    built, seen = [], []
    for mod, name in ((GG, "build_dst_block_layout"),
                      (SP, "pack_type_tiles")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: (
            built.append(_n), _f(*a, **k))[1])
    propagate = G.propagate

    def spy(*a, scatter_layout=None, tiles_layout=None, **k):
        lay = tiles_layout if backend == "pallas" else scatter_layout
        seen.append(lay)
        return propagate(*a, scatter_layout=scatter_layout,
                         tiles_layout=tiles_layout, **k)
    monkeypatch.setattr(G, "propagate", spy)
    lay = None
    if backend == "window":
        lay = W.build_window_layout(tb.edge_src, tb.edge_dst, tb.edge_type,
                                    tb.edge_mask, tb.spec.n_pad, window=64,
                                    n_message_types=2 * E)
    cfg = ModelConfig(**_kw(backend))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with torch.no_grad():
        G.ggsnn_forward(params, cfg, *(torch.as_tensor(getattr(tb, k))
                                       for k in _ARRAYS), n_graphs=3,
                        scatter_layout=lay)
    assert len(seen) == K
    assert built == {"onehot": ["build_dst_block_layout"],
                     "pallas": ["pack_type_tiles"], "window": []}[backend]
    arrays = [x.arrays if hasattr(x, "arrays") else x for x in seen]
    for other in arrays[1:]:
        assert other.keys() == arrays[0].keys()
        assert all(other[k] is arrays[0][k] for k in other)
    assert sum(torch.is_tensor(v) for v in arrays[0].values()) >= 4


def test_node_loss_picks_the_lowest_node_among_ties():
    """The node loss's per-round prediction is the lowest node index among
    the nodes at their graph's maximum (the reference's ``segment_min``
    over the max positions; padding nodes never win): rounds built with
    ties decide the accuracy, against the JAX ``ggsnn_node_loss``."""
    n_nodes = np.array([4, 3, 0], np.int32)        # a padding graph last
    node_graph = np.array([0, 0, 0, 0, 1, 1, 1, 3, 3], np.int32)
    node_mask = np.array([1] * 7 + [0, 0], np.float32)
    scores = np.array([
        [1.0, 5.0, 5.0, 0.0, 2.0, 2.0, 2.0, 9.0, 9.0],   # ties 1,2 / 4,5,6
        [5.0, 1.0, 1.0, 5.0, 0.0, 3.0, 3.0, 9.0, 9.0],   # ties 0,3 / 5,6
        [0.0, 0.0, 0.0, 0.0, 7.0, 1.0, 7.0, 9.0, 9.0],   # all / 4,6
    ], np.float32)
    # targets (local): round 0 picks 1 and 0 (the lowest), round 1 picks 0
    # and 1 (graph 1: node 5 = local 1), round 2 picks 0 and 0
    for tgt, want in (([[1, 0, 0], [0, 1, 0], [-1, -1, -1]], [1, 1, 0]),
                      ([[2, 3, 0], [0, 2, 0], [-1, -1, -1]], [0, 0, 0]),
                      ([[1, 0, -1], [0, 1, 2], [-1, -1, -1]], [1, 0, 0])):
        tgt = np.asarray(tgt, np.int32)
        ref = jax_node_loss(*map(jnp.asarray, (scores, tgt, node_graph,
                                               node_mask, n_nodes)), 3)
        got = G.ggsnn_node_loss(*map(torch.as_tensor, (
            scores, tgt, node_graph, node_mask, n_nodes)), 3)
        assert got[1].tolist() == np.asarray(ref[1]).tolist() == [
            bool(w) for w in want]
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
    pred = G.segment_first_argmax(torch.as_tensor(scores),
                                  torch.as_tensor(node_graph),
                                  torch.as_tensor(node_mask), 3)
    assert pred.tolist() == [[1, 4, 9], [0, 5, 9], [0, 4, 9]]


@pytest.mark.parametrize("output", ["graph", "node"])
def test_predictor_decodes_ggsnn(output, tmp_path):
    """``Predictor.for_task(19)`` serves GGS-NN: ``decode`` gives per graph
    the local node id of each round (node output) or the tokens before the
    end token n_classes − 1 (graph output), as the JAX Predictor's
    ``_decode`` does on the same outputs; a request through ``predict``
    decodes as the JAX Predictor with the same weights does."""
    pred = Predictor.for_task(19, batch_size=3, device="cpu",
                              ggsnn_output=output)
    cfg = pred.cfg
    assert cfg.head == "ggsnn" and cfg.n_rounds == 3
    graphs = [dict(g, targets={}) for g in _graphs(7)]
    for g in graphs:
        g.pop("node_targets")
    batch = batch_graphs(graphs, pred.spec)
    r = np.random.default_rng(8)
    res = (r.standard_normal((3, 3, cfg.n_classes)) if output == "graph"
           else r.standard_normal((3, pred.spec.n_pad))).astype(np.float32)
    if output == "graph":
        res[1, 0, cfg.n_classes - 1] = 99.0      # graph 0 ends after 1
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    ref = JaxPredictor._decode(types.SimpleNamespace(cfg=jcfg), res, batch, 3)
    assert pred.decode(res, batch, 3) == ref
    if output == "graph":
        assert len(ref[0]) == 1
    else:
        assert all(len(x) == 3 for x in ref)
    jpred = JaxPredictor(jcfg, pred.spec, params=jax.tree.map(
        jnp.asarray, jax.tree.map(lambda t: t.numpy(), pred.params)))
    assert pred.predict(graphs) == jpred.predict(graphs)


@pytest.fixture(scope="module")
def babi19_root(tmp_path_factory):
    from ggnn_tpu.data.generators import generate_all
    root = str(tmp_path_factory.mktemp("babi19"))
    generate_all(root, tasks=(19,), folds=(1,), n_train=50, n_test=50,
                 seed=0)
    return root


@pytest.mark.parametrize("name", ["babi19", "babi19_small"])
def test_resume_jax_ggsnn_checkpoint(name, babi19_root, tmp_path):
    """A JAX Trainer's GGS-NN checkpoint (per-round ``babi19`` nets are
    shared, ``babi19_small`` the node output) resumes in the port's
    Trainer with the same parameters, and one more epoch there matches the
    JAX Trainer's own (rtol 1e-5, atol 1e-6; the node output's score bias,
    whose gradient vanishes by symmetry, within 2·steps·lr, as
    ``tests/test_torch_train_loop.py`` holds node_select's); the port's
    checkpoint resumes in the JAX Trainer."""
    kw = dict(epochs=3, n_train=10, n_test=5, data_root=babi19_root)
    jt = JaxTrainer(jax_build_config(name, **kw), JaxLogger(echo=False))
    jt.train_epoch()
    ck = str(tmp_path / "jax.npz")
    jt.save(ck)
    tt = Trainer(build_config(name, **kw), MetricsLogger(echo=False),
                 device="cpu")
    tt.restore(ck)
    assert (tt.epoch, tt.step) == (jt.epoch, jt.step)

    def close():
        ref = params_from_numpy(jax.tree.map(np.asarray, jt.params))
        for (key, p), (_, v) in zip(_flatten(tt.params), _flatten(ref)):
            if key == "out/b2" and tt.cfg.model.ggsnn_output == "node":
                # the node scores' bias: shifting every score leaves each
                # graph's softmax unchanged, so its gradient is rounding
                # noise that Adam turns into steps of up to lr
                bound = 2 * jt.step * tt.cfg.lr * (1 + 1e-5)
                assert (p.detach() - v).abs().max() <= bound
                continue
            np.testing.assert_allclose(p.detach().numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
    close()
    jt.train_epoch()
    tt.train_epoch()
    close()
    ck2 = str(tmp_path / "port.npz")
    tt.save(ck2)
    assert set(np.load(ck2).files) == set(np.load(ck).files)
    jt2 = JaxTrainer(jax_build_config(name, **kw), JaxLogger(echo=False))
    jt2.restore(ck2)
    assert int(jt2.opt_state[0].count) == tt.step


def test_per_round_checkpoint_round_trips(tmp_path):
    """A per-round GGS-NN tree (``share_round_nets=False``: the stacked
    leading-K out and ann leaves) converts leaf for leaf from the JAX
    package's ``init_params`` (``params_from_numpy``) and saves and loads
    through both packages' checkpoints bit for bit."""
    from ggnn_tpu.train import checkpoint as jax_ckpt
    from ggnn_tpu_torch.train import checkpoint as torch_ckpt
    for share in (True, False):
        kw = _kw("xla", share=share)
        jp = _np_params(kw, seed=3)
        tp = init_params(ModelConfig(**kw))
        jflat, tflat = dict(_leaves(jp)), dict(_leaves(tp))
        assert jflat.keys() == tflat.keys()
        for k in jflat:
            assert jflat[k].shape == tuple(tflat[k].shape), k
            assert jflat[k].dtype == np.float32 and tflat[k].dtype == \
                torch.float32
        conv = params_from_numpy(jp)
        path = str(tmp_path / f"j{share}.npz")
        jax_ckpt.save_checkpoint(path, {"params": jp}, step=1, epoch=1)
        tree, _ = torch_ckpt.load_checkpoint(path, {"params": tp})
        for (k, a), (_, b) in zip(_flatten(tree["params"]), _flatten(conv)):
            assert torch.equal(a, b), k
        path = str(tmp_path / f"t{share}.npz")
        torch_ckpt.save_checkpoint(path, {"params": conv}, step=1, epoch=1)
        back, _ = jax_ckpt.load_checkpoint(path, {"params": jp})
        for (k, a), (_, b) in zip(_leaves(back["params"]), _leaves(jp)):
            assert np.array_equal(np.asarray(a), b), k


def test_babi19_small_node_output_trains(babi19_root):
    """bAbI task 19's node-selection GGS-NN (as
    ``tests/test_ggsnn_node_output.py`` trains the JAX package) trains on
    the CPU: the loss falls and the train accuracy passes 0.2.  The port
    starts from the JAX Trainer's initial parameters: its own generator
    draws others, from which the same 40 epochs of the same math reach
    0.20, against 0.62 from the JAX draw."""
    kw = dict(epochs=40, n_train=50, n_test=20, data_root=babi19_root,
              model_state_dim=8)
    cfg = build_config("babi19", **kw).with_overrides(
        model_ggsnn_output="node")
    t = Trainer(cfg, MetricsLogger(echo=False), device="cpu")
    jt = JaxTrainer(jax_build_config("babi19", **kw).with_overrides(
        model_ggsnn_output="node"), JaxLogger(echo=False))
    with torch.no_grad():
        for p, v in zip(param_leaves(t.params), param_leaves(
                params_from_numpy(jax.tree.map(np.asarray, jt.params)))):
            p.copy_(v)
    first = t.train_epoch()
    for _ in range(39):
        rec = t.train_epoch()
    assert np.isfinite(rec["loss"]) and rec["loss"] < first["loss"]
    assert 0.0 <= t.evaluate()["accuracy"] <= 1.0
    assert rec["accuracy"] > 0.2


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
@pytest.mark.parametrize("output", ["graph", "node"])
def test_ggsnn_forward_on_card(output):
    """On the card (D = 128, bf16, the typed pack fused and the pallas
    backend): the round outputs and annotations against the same forward on
    the CPU (the plain versions), within 2**-6 · max(1, max|CPU|)."""
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    jb, tb = _batches(9)
    for backend, extra in (("onehot", dict(fuse_gru=True)), ("pallas", {})):
        kw = _kw(backend, output, dtype="bfloat16", D=128, **extra)
        params = _np_params(kw)
        lay = None
        if backend == "onehot":
            lay = build_typed_dst_layout(tb.edge_src, tb.edge_dst,
                                         tb.edge_type, tb.edge_mask,
                                         tb.spec.n_pad, 2 * E)
        cfg = ModelConfig(**kw)
        outs = []
        for dev in ("cpu", "cuda"):
            args = [torch.as_tensor(getattr(tb, k), device=dev)
                    for k in _ARRAYS]
            with torch.no_grad():
                outs.append([x.cpu() for x in G.ggsnn_forward(
                    params_from_numpy(params, dev), cfg, *args, n_graphs=3,
                    scatter_layout=None if lay is None else lay.to(dev))])
        for g, r in zip(outs[1], outs[0]):
            assert (g - r).abs().max() <= 2.0 ** -6 * max(1.0,
                                                         r.abs().max())


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA GPU")
def test_ggsnn_train_step_on_card():
    """One ``make_train_step`` of GGS-NN on the card (D = 128, bf16, the
    typed pack built with its grad half, fused): a finite loss, and the
    loss within 1e-3 relative of the same step on the CPU."""
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    from ggnn_tpu_torch.train.loop import make_optimizer, make_train_step
    _, tb = _batches(10)
    cfg = ModelConfig(**_kw("onehot", dtype="bfloat16", D=128,
                            fuse_gru=True))
    lay = build_typed_dst_layout(tb.edge_src, tb.edge_dst, tb.edge_type,
                                 tb.edge_mask, tb.spec.n_pad, 2 * E,
                                 with_grad=True)
    losses = []
    for dev in ("cpu", "cuda"):
        params = init_params(cfg, torch.Generator().manual_seed(0), dev)
        for p in param_leaves(params):
            p.requires_grad_(True)
        step = make_train_step(cfg, 3, make_optimizer(params, 1e-3))
        m = step(params, batch_arrays(tb, dev), lay.to(dev))
        losses.append(float(m["loss_sum"] / m["count"]))
    assert np.isfinite(losses[1])
    assert abs(losses[1] - losses[0]) <= 1e-3 * abs(losses[0])
