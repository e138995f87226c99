"""The port's fixed-order segment sum (``ops/segment_rows.py``,
``csrc/segment_rows.cu``) and the callers rewired onto it, against numpy and
the JAX package.

- The plan against numpy: the entries in a stable sort of their ids,
  the row offsets, each row's chunks of at most k (k = 4 here), the
  workspace slots of the cut rows; made once per index tensor.
- The kernel's schedule emulated on the plan in f32 (each item's rows in
  plan order, then a cut row's partials in chunk order) against numpy's
  sequential sum in the same order: the same bits.
- The plain version (f64 sums, rounded once) against
  ``jax.ops.segment_sum`` on hubs, empty rows, padding and negative ids,
  and one segment of 10^6 rows: f32 within 1e-6·Σ|v| a row (f32 rounding
  of the reference's own sum), f64 within 1e-12·Σ|v|.
- Each rewired caller against its JAX counterpart, forward and VJP, f32
  rtol 1e-5, atol 1e-6·max(1, max|ref|): ``typed_aggregate`` (both
  strategies, a hub), ``typed_aggregate_tiled`` (the pallas backend; JAX
  in interpret mode, the gate's dmask too), ``graph_gated_pool``,
  node_select's softmax and loss (an empty graph slot), and the sharded
  readout of ``parallel/halo.py`` (a world of one rank: the collectives
  stubbed) against the single-device JAX losses.
- No float ``index_add``, ``index_put`` with accumulation, ``scatter_add``
  or ``scatter_reduce`` sum of more than one term an address runs on a
  train step of any backend outside the plain versions (a dispatch mode
  logs every such op on the CPU); plans cached while serving under
  ``torch.inference_mode`` serve a later train step.
- ``cuda`` cases (skipped without a card): the kernel against its plain
  version, two runs bit-equal, and a Trainer's resume bit-exact on the card.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ggnn_tpu.models import heads as JH
from ggnn_tpu.ops import segment as JSG
from ggnn_tpu.ops import spmm_pallas as JS
from ggnn_tpu_torch.data.synthetic import synthetic_batch
from ggnn_tpu_torch.models import ModelConfig
from ggnn_tpu_torch.models import heads as H
from ggnn_tpu_torch.models.init import init_params
from ggnn_tpu_torch.ops import segment as SG
from ggnn_tpu_torch.ops import segment_rows as SR
from ggnn_tpu_torch.ops import spmm as SP
from ggnn_tpu_torch.parallel import halo
from ggnn_tpu_torch.parallel.mesh import Axis
from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                       make_train_step, param_leaves)

torch.set_num_threads(1)
CARD = torch.cuda.is_available()


def seg_case(name, r):
    """(segment ids, n_rows) of a named case."""
    if name == "random":
        return r.integers(0, 40, 300), 40
    if name == "hub":
        return np.where(r.random(500) < 0.6, 3, r.integers(0, 30, 500)), 30
    if name == "empty_rows":
        return r.choice([0, 5, 6, 29], 200), 30
    if name == "padding_ids":
        return np.where(r.random(200) < 0.3, 25, r.integers(0, 25, 200)), 25
    if name == "negative_ids":
        return r.integers(-3, 20, 200), 17
    if name == "all_dropped":
        return np.full(50, 9), 9
    if name == "empty":
        return np.zeros(0, np.int64), 7
    raise ValueError(name)


CASES = ("random", "hub", "empty_rows", "padding_ids", "negative_ids",
         "all_dropped", "empty")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plan_matches_numpy(case, dtype):
    """Order, offsets, chunks and slots against numpy (k = 4)."""
    r = np.random.default_rng(1)
    seg, n = seg_case(case, r)
    k = 4
    t = torch.tensor(seg, dtype=dtype)
    plan = SR.segment_rows_plan(t, n, k)
    assert SR.segment_rows_plan(t, n, k) is plan        # once per tensor
    key = np.where((seg >= 0) & (seg < n), seg, n)
    np.testing.assert_array_equal(plan["order"].numpy(),
                                  np.argsort(key, kind="stable"))
    counts = np.bincount(key, minlength=n + 1)[:n]
    np.testing.assert_array_equal(plan["offsets"].numpy(),
                                  np.concatenate([[0], np.cumsum(counts)]))
    np.testing.assert_array_equal(plan["gather_idx"].numpy(), key)
    items, slots = [], 0
    split = []
    for row in range(n):
        lo = int(np.sum(counts[:row]))
        chunks = [(lo + c, min(lo + c + k, lo + counts[row]))
                  for c in range(0, counts[row], k)]
        cut = len(chunks) > 1
        if cut:
            split.append((row, slots, len(chunks)))
        for b, e in chunks:
            items.append((row, b, e, slots if cut else -1))
            slots += cut
    np.testing.assert_array_equal(plan["items"].numpy().reshape(-1, 4),
                                  np.asarray(items, np.int64).reshape(-1, 4))
    assert plan["n_items"] == len(items) and plan["n_ws"] == slots
    assert plan["n_split"] == len(split)
    got = np.stack([plan[x].numpy() for x in ("split_rows", "split_first",
                                               "split_n")], 1)
    np.testing.assert_array_equal(got, np.asarray(split, np.int64).reshape(
        -1, 3))


def emulate_kernel(vals, plan, n_rows):
    """The two kernels' schedule in the values' dtype: each item adds its
    rows in plan order (into its output row or its slot), then each cut
    row adds its slots in chunk order."""
    order = plan["order"].numpy()
    out = np.zeros((n_rows, vals.shape[1]), vals.dtype)
    ws = np.zeros((plan["n_ws"], vals.shape[1]), vals.dtype)
    for row, b, e, slot in plan["items"].numpy():
        acc = np.zeros(vals.shape[1], vals.dtype)
        for j in range(b, e):
            acc = acc + vals[order[j]]
        (ws if slot >= 0 else out)[slot if slot >= 0 else row] = acc
    for row, first, n in zip(*(plan[x].numpy() for x in (
            "split_rows", "split_first", "split_n"))):
        acc = np.zeros(vals.shape[1], vals.dtype)
        for c in range(n):
            acc = acc + ws[first + c]
        out[row] = acc
    return out


@pytest.mark.parametrize("case", CASES)
def test_kernel_schedule_emulated(case):
    """The emulated schedule equals numpy's sequential sum of each row's
    entries in index order, chunk partials in chunk order (the same bits),
    and the plain version within f32 rounding."""
    r = np.random.default_rng(2)
    seg, n = seg_case(case, r)
    vals = r.standard_normal((seg.shape[0], 3)).astype(np.float32)
    plan = SR.segment_rows_plan(torch.tensor(seg), n, 4)
    got = emulate_kernel(vals, plan, n)
    ref = np.zeros_like(got)
    for row in range(n):
        idx = np.nonzero(seg == row)[0]
        parts = []
        for c in range(0, len(idx), 4):
            acc = np.zeros(3, np.float32)
            for i in idx[c:c + 4]:
                acc = acc + vals[i]
            parts.append(acc)
        if len(parts) == 1:
            ref[row] = parts[0]
        elif parts:
            acc = np.zeros(3, np.float32)
            for p in parts:
                acc = acc + p
            ref[row] = acc
    np.testing.assert_array_equal(got, ref)
    plain = SR.segment_rows_sum(torch.tensor(vals), torch.tensor(seg), n)
    np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES + ("one_segment_1e6",))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_matches_jax_segment_sum(case, dtype):
    """The plain version (f64 sums, rounded once) against
    ``jax.ops.segment_sum`` (ids outside [0, n) dropped by both)."""
    r = np.random.default_rng(3)
    if case == "one_segment_1e6":
        seg, n, D = np.zeros(1_000_000, np.int64), 1, 1
    else:
        (seg, n), D = seg_case(case, r), 5
    vals = r.standard_normal((seg.shape[0], D)).astype(dtype)
    got = SR.segment_rows_sum(torch.tensor(vals), torch.tensor(seg), n)
    assert got.dtype == torch.tensor(vals).dtype and got.shape == (n, D)
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals),
                                             jnp.asarray(seg),
                                             num_segments=n))
    key = np.where((seg >= 0) & (seg < n), seg, n)
    mag = np.zeros((n + 1, D))
    np.add.at(mag, key, np.abs(vals.astype(np.float64)))
    tol = (1e-6 if dtype == "float32" else 1e-12) * mag[:n] + 1e-30
    assert np.all(np.abs(got.numpy() - ref) <= tol)


def _edges(r, N, E, T2, hub=True):
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, N, E).astype(np.int32)
    if hub:                                       # a hub destination
        dst[r.random(E) < 0.4] = 1
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = (r.random(E) < 0.9).astype(np.float32)
    return src, dst, typ, mask


def _assert_close(got, ref, rtol=1e-5, atol=1e-6):
    """rtol, and atol · max(1, max|ref|): a cotangent summed over many
    edges carries the f32 rounding of the reference's own sum at the
    scale of its largest entry."""
    for g, x in zip(got, ref, strict=True):
        x = np.asarray(x)
        np.testing.assert_allclose(g.detach().numpy(), x, rtol=rtol,
                                   atol=atol * max(1.0, np.abs(x).max(
                                       initial=0.0)))


@pytest.mark.parametrize("strategy", ["node_transform", "edge_gather"])
def test_typed_aggregate_matches_jax(strategy):
    """``typed_aggregate`` (xla's aggregation: the gathers' backwards and
    the segment sum through ``segment_rows``) forward and VJP in h, msg_w,
    msg_b against ``jax.vjp`` of the reference's."""
    r = np.random.default_rng(4)
    N, E, T2, D = 50, 600, 4, 6
    src, dst, typ, mask = _edges(r, N, E, T2)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * 0.4).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    ct = r.standard_normal((N, D)).astype(np.float32)
    idx = tuple(map(jnp.asarray, (src, dst, typ, mask)))
    ref, vjp = jax.vjp(lambda *a: JSG.typed_aggregate(
        a[0], *idx, a[1], a[2], strategy=strategy), *map(jnp.asarray,
                                                         (h, w, b)))
    xs = [torch.tensor(x, requires_grad=True) for x in (h, w, b)]
    tidx = tuple(map(torch.tensor, (src, dst, typ, mask)))
    out = SG.typed_aggregate(xs[0], *tidx, xs[1], xs[2], strategy=strategy)
    got = torch.autograd.grad(out, xs, torch.tensor(ct))
    _assert_close([out], [ref])
    _assert_close(got, vjp(jnp.asarray(ct)))


@pytest.mark.parametrize("gated", [False, True])
def test_typed_aggregate_tiled_matches_jax(gated):
    """The pallas backend's aggregation (#16's plain version, the segment
    sum and the backward's Y through ``segment_rows``) on a hub layout:
    forward and the four cotangents against ``jax.vjp`` of the reference's
    ``typed_aggregate_tiled`` in interpret mode."""
    r = np.random.default_rng(5)
    N, E, T2, D, tile_e = 40, 400, 4, 8, 8
    src, dst, typ, mask = _edges(r, N, E, T2)
    order = np.argsort(typ, kind="stable")
    src, dst, typ, mask = src[order], dst[order], typ[order], mask[order]
    offs = np.concatenate([[0], np.cumsum(np.bincount(typ, minlength=T2))]
                          ).astype(np.int32)
    lay = JS.pack_type_tiles(*map(jnp.asarray, (src, dst, typ, mask, offs)),
                             T2, tile_e)
    tlay = {k: (torch.tensor(np.asarray(v)) if k not in ("n_tiles", "tile_e")
                else v) for k, v in lay.items()}
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    gate = (np.asarray(lay["mask"]) * r.random(lay["mask"].shape[0])
            ).astype(np.float32)
    ct = r.standard_normal((N, D)).astype(np.float32)
    ref, vjp = jax.vjp(lambda h_, w_, b_, m_: JS.typed_aggregate_tiled(
        h_, lay, w_, b_, interpret=True, mask=m_ if gated else None),
        *map(jnp.asarray, (h, w, b, gate)))
    xs = [torch.tensor(x, requires_grad=True) for x in (h, w, b, gate)]
    out = SP.typed_aggregate_tiled(xs[0], tlay, xs[1], xs[2],
                                   mask=xs[3] if gated else None)
    got = torch.autograd.grad(out, xs[:4 if gated else 3], torch.tensor(ct))
    refs = vjp(jnp.asarray(ct))
    _assert_close([out], [ref])
    _assert_close(got, refs[:4 if gated else 3])


def _readout_data(r, N=60, B=3, D=6, C=4, empty_slot=True):
    """Node states, annotations and graph ids of B graphs over N rows (the
    last slot empty when ``empty_slot``), padding rows at graph id B."""
    sizes = [22, 17, 0] if empty_slot else [22, 17, 11]
    node_graph = np.full(N, B, np.int32)
    node_mask = np.zeros(N, np.float32)
    at = 0
    for g, n in enumerate(sizes):
        node_graph[at:at + n], node_mask[at:at + n] = g, 1.0
        at += n
    n_nodes = np.asarray(sizes, np.int32)
    h = r.standard_normal((N, D)).astype(np.float32)
    ann = (r.random((N, 2)) < 0.5).astype(np.float32)
    target = np.asarray([5, 16, 0], np.int32)
    cls = np.asarray([1, 3, 0], np.int32)
    return dict(h=h, ann=ann, node_graph=node_graph, node_mask=node_mask,
                n_nodes=n_nodes, target=target, cls=cls, B=B, C=C, D=D)


def _head(r, kind, D, C, A=2):
    hx = D + A
    if kind == "node_select":
        shapes = dict(w1=(hx, D), b1=(D,), w2=(D, 1), b2=(1,))
    else:
        shapes = dict(gi_w=(hx, D), gi_b=(D,), gj_w=(hx, D), gj_b=(D,),
                      c1=(D, D), c1b=(D,), c2=(D, C), c2b=(C,))
    return {k: (r.standard_normal(shapes[k]) * 0.5).astype(np.float32)
            for k in sorted(shapes)}        # jax's order of a dict's leaves


def _jax_loss(kind, d):
    def f(h, head):
        if kind == "node_select":
            scores = JH.node_select_scores(head, h, jnp.asarray(d["ann"]))
            return JH.node_select_loss(
                scores, jnp.asarray(d["node_graph"]),
                jnp.asarray(d["node_mask"]), jnp.asarray(d["n_nodes"]),
                jnp.asarray(d["target"]), d["B"])[0]
        logits = JH.graph_gated_logits(
            head, h, jnp.asarray(d["ann"]), jnp.asarray(d["node_graph"]),
            jnp.asarray(d["node_mask"]), d["B"])
        return JH.graph_class_loss(logits, jnp.asarray(d["cls"]),
                                   jnp.asarray(d["n_nodes"]))[0]
    return f


def _grads_of(loss_fn, h, head):
    th = torch.tensor(h, requires_grad=True)
    thead = {k: torch.tensor(v, requires_grad=True) for k, v in head.items()}
    loss = loss_fn(th, thead)
    grads = torch.autograd.grad(loss, [th, *thead.values()])
    return loss, grads


@pytest.mark.parametrize("kind", ["node_select", "graph_gated"])
def test_readout_matches_jax(kind):
    """node_select's segment softmax and loss (the normalizer, the shift's
    and the target's gradients through ``segment_rows``; an empty slot) and
    the graph_gated pool and loss: loss and gradients in h and every head
    leaf against ``jax.value_and_grad`` of the reference's."""
    r = np.random.default_rng(6)
    d = _readout_data(r)
    head = _head(r, kind, d["D"], d["C"])
    ref, (rh, rhead) = jax.value_and_grad(_jax_loss(kind, d), argnums=(0, 1))(
        jnp.asarray(d["h"]), jax.tree.map(jnp.asarray, head))
    t = {k: torch.tensor(d[k]) for k in ("ann", "node_graph", "node_mask",
                                          "n_nodes", "target", "cls")}

    def loss_fn(h, hd):
        if kind == "node_select":
            scores = H.node_select_scores(hd, h, t["ann"])
            return H.node_select_loss(scores, t["node_graph"], t["node_mask"],
                                      t["n_nodes"], t["target"], d["B"])[0]
        logits = H.graph_gated_logits(hd, h, t["ann"], t["node_graph"],
                                      t["node_mask"], d["B"])
        return H.graph_class_loss(logits, t["cls"], t["n_nodes"])[0]
    loss, grads = _grads_of(loss_fn, d["h"], head)
    _assert_close([loss], [ref])
    _assert_close(grads, [rh, *rhead.values()])


@pytest.mark.parametrize("kind", ["node_select", "graph_gated"])
def test_sharded_readout_matches_jax(kind, monkeypatch):
    """The sharded readout of ``parallel/halo.py`` (the target's score by
    ``pick_node``, the f64 normalizer and the gated pool by
    ``segment_sum``) on a world of one rank (the collectives stubbed to
    what they are there: the identity) against the single-device JAX
    losses."""
    for name in ("psum", "pmax", "pmin"):
        monkeypatch.setattr(halo.comm, name, lambda x, group: x)
    r = np.random.default_rng(7)
    d = _readout_data(r)
    head = _head(r, kind, d["D"], d["C"])
    ref, (rh, rhead) = jax.value_and_grad(_jax_loss(kind, d), argnums=(0, 1))(
        jnp.asarray(d["h"]), jax.tree.map(jnp.asarray, head))
    t = {k: torch.tensor(d[k]) for k in ("ann", "node_graph", "node_mask",
                                          "n_nodes", "target", "cls")}
    axis = Axis("data", None, 1, 0)
    fn = (halo.sharded_node_select_loss if kind == "node_select"
          else halo.sharded_graph_gated_loss)
    tgt = t["target"] if kind == "node_select" else t["cls"]
    loss, grads = _grads_of(lambda h, hd: fn(
        hd, h, t["ann"], t["node_graph"], t["node_mask"], t["n_nodes"], tgt,
        d["B"], axis)[0], d["h"], head)
    _assert_close([loss], [ref])
    _assert_close(grads, [rh, *rhead.values()])


def test_plans_made_while_serving_serve_training():
    """A plan and a flat index cached under ``torch.inference_mode`` (a
    served request) serve a later train step on the same index tensors:
    autograd saves them for the backward, which inference tensors refuse."""
    r = np.random.default_rng(9)
    N, E, T2, D = 30, 200, 3, 4
    src, dst, typ, mask = map(torch.tensor, _edges(r, N, E, T2))
    h = torch.tensor(r.standard_normal((N, D)).astype(np.float32))
    w = torch.tensor(r.standard_normal((T2, D, D)).astype(np.float32))
    b = torch.zeros(T2, D)
    with torch.inference_mode():
        served = SG.typed_aggregate(h, src, dst, typ, mask, w, b)
    hg = h.clone().requires_grad_(True)
    out = SG.typed_aggregate(hg, src, dst, typ, mask, w, b)
    (dh,) = torch.autograd.grad(out.sum(), hg)
    assert torch.equal(out.detach(), served) and torch.isfinite(dh).all()


_ACCUMULATING = ("index_add", "index_put", "scatter_add", "scatter_reduce",
                 "embedding_dense_backward")


class _SumLog(TorchDispatchMode):
    """Logs every float op that adds more than one term into an address
    (index_add, index_put with accumulation, scatter_add, a 'sum' or
    'mean' scatter_reduce), outside the plain versions (functions named
    ``*_reference``)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func)
        if any(k in name for k in _ACCUMULATING):
            hit = self._targets(name, args, kwargs)
            if hit is not None and hit[0].is_floating_point():
                lin = hit[1]
                if lin.numel() != torch.unique(lin).numel():
                    stack = [f.name for f in traceback.extract_stack()]
                    if not any(n.endswith("_reference") for n in stack):
                        self.seen.append((name, tuple(hit[0].shape)))
        return func(*args, **kwargs)

    @staticmethod
    def _targets(name, args, kwargs):
        """(the tensor summed into, the flat address of each term)."""
        if "index_add" in name:
            return args[0], args[2].reshape(-1)
        if "index_put" in name:
            acc = args[3] if len(args) > 3 else kwargs.get("accumulate")
            idx = [i for i in args[1] if i is not None]
            if not acc or not idx:
                return None
            lin = torch.zeros_like(torch.broadcast_tensors(*idx)[0].long())
            for k, i in enumerate(torch.broadcast_tensors(*idx)):
                lin = lin * args[0].shape[k] + i.long()
            return args[0], lin.reshape(-1)
        if "scatter" in name:
            if "scatter_reduce" in name and args[4] not in ("sum", "mean"):
                return None
            self_, dim, index = args[0], args[1], args[2]
            grids = torch.meshgrid(*[torch.arange(s) for s in index.shape],
                                   indexing="ij")
            lin = torch.zeros(index.shape, dtype=torch.long)
            for k in range(index.dim()):
                lin = (lin * self_.shape[k]
                       + (index.long() if k == dim else grids[k]))
            return self_, lin.reshape(-1)
        return args[0], args[1].reshape(-1)


def _typed_pack(b):
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    return build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                  b.edge_mask, b.spec.n_pad, 6,
                                  with_grad=True).to("cpu")


def _legacy(b):
    from ggnn_tpu_torch.ops.legacy import layout_for_batch
    return layout_for_batch(b, with_grad=True, device="cpu")


def _window(b):
    from ggnn_tpu_torch.ops.window import build_window_layout
    return build_window_layout(b.edge_src, b.edge_dst, b.edge_type,
                               b.edge_mask, b.spec.n_pad, window=128,
                               block_rows=128, n_message_types=6,
                               with_grad=True, use_native=False).to("cpu")


TRAIN_PATHS = {
    "xla": (None, {}), "xla_edge_gather": (None, dict(
        agg_strategy="edge_gather")),
    "xla_gated": (None, dict(edge_gates=True)),
    "xla_graph_gated": (None, dict(head="graph_gated", n_classes=3)),
    "pallas_gated": (None, dict(backend="pallas", edge_gates=True)),
    "onehot_typed_fused": (_typed_pack, dict(backend="onehot",
                                             fuse_gru=True, state_dim=128)),
    "onehot_typed": (_typed_pack, dict(backend="onehot", state_dim=128)),
    "onehot_legacy_default": (None, dict(backend="onehot")),
    "onehot_legacy": (_legacy, dict(backend="onehot")),
    "window_fused": (_window, dict(backend="window", fuse_gru=True,
                                   state_dim=128)),
}


@pytest.mark.parametrize("path", list(TRAIN_PATHS))
def test_no_float_accumulation_on_train_step(path):
    """One train step of each backend on the CPU runs no float sum of
    many terms into one address outside the plain versions: every such sum
    goes through ``segment_rows_sum`` (whose CPU form is a plain version)."""
    layout_fn, kw = TRAIN_PATHS[path]
    b = synthetic_batch(512, 3000, 3, annotation_dim=2, seed=0,
                        node_mult=128)
    cfg = ModelConfig(**{"state_dim": 8, "annotation_dim": 2,
                         "n_edge_types": 3, "n_steps": 2, **kw})
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for p in param_leaves(params):
        p.requires_grad_(True)
    arrays = batch_arrays(b, "cpu")
    arrays["targets"] = {"node": torch.tensor([7]),
                         "cls": torch.tensor([1])}
    step = make_train_step(cfg, b.spec.n_graphs,
                           make_optimizer(params, 1e-3))
    lay = layout_fn(b) if layout_fn else None
    with _SumLog() as log:
        step(params, arrays, lay)
    assert log.seen == []


# --- on the card -------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.skipif(not CARD, reason="needs an NVIDIA GPU (the CUDA kernel "
                    "of segment_rows_sum has no CPU form)")
@pytest.mark.parametrize("case", CASES + ("one_segment_1e6",))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(case, dtype):
    """The kernel against its plain version on the card (f32 within
    1e-6·Σ|v| a row, f64 1e-12·Σ|v|), and a second run bit-equal."""
    r = np.random.default_rng(8)
    if case == "one_segment_1e6":
        seg, n, D = np.zeros(1_000_000, np.int64), 1, 1
    else:
        (seg, n), D = seg_case(case, r), 130
    vals = torch.tensor(r.standard_normal((seg.shape[0], D)),
                        dtype=dtype, device="cuda")
    t = torch.tensor(seg, device="cuda")
    got = SR.segment_rows_sum(vals, t, n)
    again = SR.segment_rows_sum(vals, t, n)
    assert torch.equal(got, again)
    ref = SR.segment_rows_sum_reference(vals, t, n)
    mag = SR.segment_rows_sum_reference(vals.abs(), t, n).double()
    tol = (1e-6 if dtype == torch.float32 else 1e-12) * mag + 1e-30
    assert bool(((got.double() - ref.double()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.skipif(not CARD, reason="needs an NVIDIA GPU")
def test_resume_exact_on_card(tmp_path):
    """bAbI 4 on the card with the default xla backend: 3 epochs, save, 3
    more; a restore and 3 more match the uninterrupted run bit for bit,
    every leaf and the Adam state (``tests/test_torch_train_loop.py``'s
    CPU case)."""
    from ggnn_tpu_torch.train import Trainer, build_config
    from ggnn_tpu_torch.train.metrics import MetricsLogger
    quiet = MetricsLogger(echo=False)
    cfg = build_config("babi4", epochs=6)
    t1 = Trainer(cfg, quiet, device="cuda")
    for _ in range(3):
        t1.train_epoch()
    ckpt = str(tmp_path / "ck.npz")
    t1.save(ckpt)
    for _ in range(3):
        t1.train_epoch()
    t2 = Trainer(cfg, quiet, device="cuda")
    t2.restore(ckpt)
    for _ in range(3):
        t2.train_epoch()
    for a, b in zip(param_leaves(t1.params), param_leaves(t2.params)):
        assert torch.equal(a, b)
        s1, s2 = t1.optimizer.state[a], t2.optimizer.state[b]
        assert torch.equal(s1["exp_avg"], s2["exp_avg"])
        assert torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
