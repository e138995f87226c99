"""Sharded propagation over the mesh's 'graph' axis, one process per rank.

The port of ``ggnn_tpu/parallel/halo.py``.  Each rank holds only its own
``[n_local, …]`` rows (what each shard sees inside the reference's
``shard_map``) and runs the T steps with the collectives of
:mod:`~ggnn_tpu_torch.parallel.comm`; halo states travel in the compute
dtype.  Five strategies:

- ``all_gather``: every rank gathers the full node-state array each step
  and aggregates its local (dst-owned) edges (plain typed aggregation);
- ``halo``: the targeted all-to-all of the partition's
  ``halo_send_idx[owner, requester, H]`` plan; the pool each rank gathers
  from is ``[hot ∥ recv ∥ h_local]`` (self-edges index past
  ``P·Hh + P·H``); the hot segment (``partition_batch(hot_thresh=…)``)
  rides one all_gather;
- ``halo_overlap``: local edges read ``h_local`` alone, remote ones the
  pool (the reference's split): the local aggregation runs while the
  exchange is in flight;
- ``halo_onehot``: the pool through the legacy one-hot scatter layouts of
  :func:`~ggnn_tpu_torch.parallel.partition.build_halo_scatter_layouts`
  (``ops/legacy.py``: the pool's 'type'-order table, its gather, then the
  layout's scatter, #11 at a 16-aligned ``tile_e``);
- ``halo_window``: local edges through the window layouts of
  :func:`~ggnn_tpu_torch.parallel.partition.build_halo_window_layouts`,
  remote ones through the pool; fused (``cfg.fuse_gru``) the remote
  partial enters kernel #13 as ``extra_init`` and its cotangent goes back
  through the typed aggregation and the reverse all-to-all; q8 serving
  with ``cfg.quantized_table``.

What runs while the exchange is in flight (issued by
:func:`~ggnn_tpu_torch.parallel.comm.all_to_all_start` before the local
work is queued, waited on by :func:`~ggnn_tpu_torch.parallel.comm.finish`
after it): halo_overlap's local typed aggregation; unfused halo_window's
window aggregation (``aggregate_window``); fused halo_window's node table
(#10, or #15 with q8) and its spill's partial (on-demand: the spill's
partial alone), since #13 takes the remote partial as its init.  halo and
halo_onehot issue the hot rows' all_gather and the all-to-all together and
wait for both; all_gather has no work that reads no gathered row.  The
spans ``halo/exchange`` (issue to wait), ``halo/local`` and ``halo/wait``
(inside it: the local work's launch, then the wait for the exchange
alone) and ``halo/remote`` (the remote edges' aggregation) name each
step's parts in a :mod:`~ggnn_tpu_torch.profiling` trace.

The backward mirrors it (:mod:`~ggnn_tpu_torch.parallel.comm`): each
reverse collective is issued as soon as its cotangent exists, the
backward of what the forward queued while the exchange was in flight runs
beside it, and the wait comes where its cotangent is consumed.  So the
reverse all-to-all overlaps halo_overlap's local typed aggregation's
backward; unfused halo_window's ``AggregateWindow`` backward; fused
halo_window's #14 and spill backward (``window_step_prep(split_grad=
True)``: #4 gives the remote partial's cotangent first).  halo and
halo_onehot issue the hot rows' reduce-scatter and the reverse all-to-all
together, then wait for both; all_gather's reduce-scatter is alone.  The
spans ``halo/bwd_exchange`` (the reverse all-to-all's issue to its wait's
return) and ``halo/bwd_wait`` (the wait alone) name them in a trace.

The GRU cell is the reference's sharded one: ``gru_update`` without a
matmul dtype (f32 matmul inputs), so the halo strategies do not reach the
bf16 cell kernels; halo_window's fused step runs #13 (and #4 in its
backward).  Training differentiates straight through the exchange under
the gradient convention of :mod:`~ggnn_tpu_torch.parallel.comm`: each
rank seeds its replica of the loss with 1/P, psum's backward sums, and the
replicated parameters' gradients are summed over the graph axis.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.models import heads as H
from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.ggnn import fuse_gru, gru_update, init_state
from ggnn_tpu_torch.models.ggsnn import annotation_update
from ggnn_tpu_torch import profiling
from ggnn_tpu_torch.models.init import torch_dtype
from ggnn_tpu_torch.ops.scatter import ScatterLayout, aggregate_onehot
from ggnn_tpu_torch.ops.segment import typed_aggregate
from ggnn_tpu_torch.ops.segment_rows import gather_rows, segment_sum
from ggnn_tpu_torch.ops.window import DeviceWindowLayout
from ggnn_tpu_torch.ops.window_step import (aggregate_window,
                                            gru_window_step,
                                            window_step_prep)
from ggnn_tpu_torch.parallel import comm
from ggnn_tpu_torch.parallel.partition import (PartitionedBatch,
                                               build_halo_scatter_layouts,
                                               build_halo_window_layouts,
                                               local_halo_layout,
                                               split_local_remote)
from ggnn_tpu_torch.train.loop import param_leaves

STRATEGIES = ("halo", "all_gather", "halo_onehot", "halo_overlap",
              "halo_window")
_KERNEL = ("halo_onehot", "halo_window")
_SPLIT = ("halo_overlap", "halo_window")
# the backward's spans of the reverse all-to-all: its issue to its wait's
# return, and the wait alone
_BWD_SPANS = ("halo/bwd_exchange", "halo/bwd_wait")


def _resolve_layout(strategy, parts, cfg, halo_layouts, scatter_tile_e,
                    rank, device):
    """The rank's kernel layout: a layout object as given (on ``device``),
    a stacked ``(arrays, meta)`` pair's row ``rank``, or, with neither,
    built on the host from a :class:`PartitionedBatch`."""
    if strategy not in _KERNEL:
        return None
    if isinstance(halo_layouts, (ScatterLayout, DeviceWindowLayout)):
        return halo_layouts.to(device)
    if halo_layouts is None:
        if not isinstance(parts, PartitionedBatch):
            raise ValueError(f"{strategy} on a rank's LocalParts needs its "
                             "layout (halo_layouts=)")
        if strategy == "halo_onehot":
            halo_layouts = build_halo_scatter_layouts(
                parts, tile_e=scatter_tile_e)
        else:
            # the model's message-type count, not the largest type seen:
            # the table stride is msg_w.shape[0]
            halo_layouts = build_halo_window_layouts(
                parts, n_message_types=cfg.n_message_types)
    return local_halo_layout(halo_layouts, rank, device)


def sharded_propagate(prop: dict, cfg: ModelConfig, mesh,
                      parts, strategy: str = "halo",
                      axis_name: str = "graph", scatter_tile_e: int = 512,
                      halo_layouts=None, node_fn=None, node_fn_args=(),
                      body_fn=None):
    """Run T sharded propagation steps; returns this rank's final states
    h [n_local, D] f32 (rows ``index·n_local …`` of the global h).

    ``parts``: the host :class:`PartitionedBatch` (this rank takes its row
    and copies it to ``mesh.device``; the split of ``halo_overlap`` and
    ``halo_window`` is made here when missing) or the rank's
    :class:`LocalParts` (``parts.local(rank, device)``, made once per
    batch).  ``halo_layouts`` for the kernel strategies: the stacked
    ``(arrays, meta)`` of the partition's layout builders, the rank's
    layout (:func:`~ggnn_tpu_torch.parallel.partition.local_halo_layout`),
    or None to build the default one here from a host partition.

    ``node_fn(h_local, ann_local, node_graph_local, node_mask_local,
    node_fn_args, axis)`` post-processes the final states (a readout with
    cross-rank collectives, :func:`sharded_node_select_loss`); its output
    is returned instead of h.  ``body_fn(run_steps, ann_local,
    node_graph_local, node_mask_local, node_fn_args, axis)`` replaces the
    whole per-rank body: ``run_steps(h0_local)`` runs the T-step recurrence
    from any state and may be called repeatedly (the GGS-NN rounds).
    ``axis`` is the mesh's :class:`~ggnn_tpu_torch.parallel.mesh.Axis`."""
    if body_fn is not None and node_fn is not None:
        raise ValueError("pass node_fn or body_fn, not both")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    axis = mesh.axis(axis_name)
    if parts.n_shards != axis.size:
        raise ValueError(f"a partition of {parts.n_shards} shards on a "
                         f"'{axis_name}' axis of {axis.size} ranks")
    host = isinstance(parts, PartitionedBatch)
    if strategy in _SPLIT and parts.local_edges is None:
        if not host:
            raise ValueError(f"{strategy} needs split_local_remote(parts) "
                             "before parts.local(...)")
        split_local_remote(parts)
    layout = _resolve_layout(strategy, parts, cfg, halo_layouts,
                             scatter_tile_e, axis.index, mesh.device)
    lp = parts.local(axis.index, mesh.device) if host else parts

    group, P = axis.group, axis.size
    n_local, Hs, Hh = lp.n_local, lp.halo_size, lp.hot_size
    cdt = torch_dtype(cfg.compute_dtype)
    fused = fuse_gru(prop["gru"])
    msg_w_c, msg_b_c = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    send_idx = lp.send_idx.reshape(-1).long()
    hot_idx = lp.hot_idx.long() if Hh > 0 else None
    loc, rem = lp.local_edges, lp.remote_edges
    common = dict(dst=lp.edge_dst_local, type=lp.edge_type,
                  mask=lp.edge_mask)
    edges_g = dict(common, src=lp.edge_src_global)   # global source ids
    edges_h = dict(common, src=lp.edge_src_halo)     # pool coordinates

    def start_exchange(hc):
        """Issue this step's exchange of the compute-dtype states ``hc``:
        the hot rows' all_gather, then the all-to-all of the send rows."""
        hot = (comm.all_gather_start(gather_rows(hc, hot_idx), group)
               if Hh > 0 else None)
        send = gather_rows(hc, send_idx).reshape(P, Hs, -1)
        return hc, hot, comm.all_to_all_start(send, group, spans=_BWD_SPANS)

    def finish_exchange(pending):
        """The pool [hot (P·Hh) ∥ recv (P·H) ∥ h_local] in the compute
        dtype."""
        hc, hot, a2a = pending
        segs = [] if hot is None else [comm.finish(hot)]
        segs += [comm.finish(a2a).reshape(-1, hc.shape[-1]), hc]
        return torch.cat(segs)

    def exchange(hc):
        """The pool, both collectives issued before either is waited on."""
        with profiling.annotate("halo/exchange"):
            return finish_exchange(start_exchange(hc))

    def overlapped(hc, local):
        """``local()`` (work that reads no halo row) queued while the
        exchange is in flight; returns (its result, the pool).  The
        ``halo/wait`` span is the wait for the exchange alone."""
        with profiling.annotate("halo/exchange"):
            pending = start_exchange(hc)
            with profiling.annotate("halo/local"):
                out = local()
            with profiling.annotate("halo/wait"):
                return out, finish_exchange(pending)

    def typed(pool, e):
        """The plain typed aggregation of edges ``e`` from ``pool``, with
        the f32 message weights (as the reference's sharded path)."""
        return typed_aggregate(pool, e["src"], e["dst"], e["type"],
                               e["mask"], prop["msg_w"], prop["msg_b"],
                               strategy=cfg.agg_strategy)[:n_local]

    def remote(pool):
        with profiling.annotate("halo/remote"):
            return typed(pool, rem)

    def step(h_local):
        hc = h_local.to(cdt)
        if strategy == "all_gather":
            a = typed(comm.all_gather(hc, group), edges_g)
        elif strategy == "halo":
            a = typed(exchange(hc), edges_h)
        elif strategy == "halo_overlap":
            # the local edges read h_local alone: aggregated while the
            # exchange is in flight (the reference's overlap)
            a_loc, pool = overlapped(hc, lambda: typed(hc, loc))
            a = a_loc + remote(pool)
        elif strategy == "halo_onehot":
            # every edge (local ones by their self-coordinates) through the
            # one-hot layout over the pool
            a = aggregate_onehot(exchange(hc), layout, msg_w_c,
                                 msg_b_c)[:n_local]
        elif cfg.fuse_gru:   # halo_window, fused
            # the remote partial rides #13's init, so #13 waits for the
            # exchange; the table (#10, #15 with q8) and the spill's
            # partial read h_local alone and run while it is in flight
            # (on-demand builds its windows inside #13: only its spill
            # overlaps).  q8 quantizes each rank's own table windows
            # (serving only).  Trained, the aggregation's backward (#14,
            # the spill's) is a node recorded here: it runs while the
            # reverse all-to-all is in flight
            prep, pool = overlapped(hc, lambda: window_step_prep(
                h_local, layout, msg_w_c, msg_b_c,
                quantized=cfg.quantized_table, split_grad=True))
            return gru_window_step(h_local, layout, msg_w_c, msg_b_c,
                                   prop["gru"], extra_init=remote(pool),
                                   quantized=cfg.quantized_table, prep=prep)
        else:                # halo_window, unfused
            a_loc, pool = overlapped(hc, lambda: aggregate_window(
                hc, layout, msg_w_c, msg_b_c)[:n_local])
            a = a_loc + remote(pool)
        return gru_update(prop["gru"], h_local, a, fused)

    def run_steps(h):
        for _ in range(cfg.n_steps):
            h = step(h)
        return h

    ann, ngraph, nmask = lp.annotations, lp.node_graph, lp.node_mask
    if body_fn is not None:
        return body_fn(run_steps, ann, ngraph, nmask, node_fn_args, axis)
    h = run_steps(init_state(ann, cfg.state_dim))
    if node_fn is not None:
        return node_fn(h, ann, ngraph, nmask, node_fn_args, axis)
    return h


def _check_trainable(cfg: ModelConfig) -> None:
    """The quantized fused window step is forward only: refuse to train it
    up front."""
    if cfg.quantized_table:
        raise ValueError(
            "quantized_table=True is a SERVING mode (forward-only int8 "
            "table) and cannot be differentiated; train with "
            "quantized_table=False, then serve the trained weights "
            "quantized (sharded q8 serving works)")


def _layouts(halo_arrays, halo_meta):
    """A step call's ``halo_arrays`` (a stacked dict, paired with the
    factory's ``halo_meta``, or a rank's layout object) as
    :func:`sharded_propagate` takes it."""
    if halo_arrays is None or not isinstance(halo_arrays, dict):
        return halo_arrays
    return (halo_arrays, halo_meta)


def _need_meta(strategy, halo_meta, train: bool):
    if strategy in _KERNEL and halo_meta is None:
        raise ValueError(
            f"strategy {strategy!r} needs halo_meta= from "
            "build_halo_scatter_layouts/build_halo_window_layouts("
            f"{'with_grad=True' if train else ''}); pass the arrays dict "
            "(or the rank's local_halo_layout) to each step call")


def _sum_grads_and_step(params, loss, optimizer, axis):
    """The convention: 1/P seeds this rank's replica of the loss, the
    parameters' gradients are summed over the axis, then the update."""
    (loss / axis.size).backward()
    comm.allreduce_grads([p for p in param_leaves(params)
                          if p.grad is not None], axis.group)
    optimizer.step()


def make_sharded_train_step(cfg: ModelConfig, mesh, optimizer,
                            strategy: str = "halo_overlap",
                            axis_name: str = "graph", loss_fn=None,
                            halo_meta=None):
    """A sharded train step of the propagation parameters: backward through
    the exchange (the all-to-all's is the reverse all-to-all), the
    gradients summed over the ranks, then ``optimizer`` (which holds
    ``prop``'s leaves) steps, identically on every rank.

    ``loss_fn(h_local) -> scalar`` is this rank's share of the objective,
    summed over the ranks (default ``sum(h*h)``, the reference's proxy).
    The kernel strategies need their stacked layouts built
    ``with_grad=True``: ``halo_meta`` here, the arrays (or the rank's
    layout) at each call.  Returns ``train_step(prop, parts,
    halo_arrays=None) -> loss`` (updates ``prop`` in place)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    _check_trainable(cfg)
    _need_meta(strategy, halo_meta, train=True)
    axis = mesh.axis(axis_name)
    if loss_fn is None:
        def loss_fn(h):
            return torch.sum(h * h)

    def train_step(prop, parts, halo_arrays=None):
        optimizer.zero_grad(set_to_none=True)
        h = sharded_propagate(prop, cfg, mesh, parts, strategy=strategy,
                              axis_name=axis_name,
                              halo_layouts=_layouts(halo_arrays, halo_meta))
        loss = comm.psum(loss_fn(h), axis.group)
        _sum_grads_and_step(prop, loss, optimizer, axis)
        return loss.detach()

    return train_step


def _sharded_round_node_nll(head: dict, h, X, node_graph, node_mask,
                            tgt_global, valid, n_graphs: int, axis):
    """A node-selection softmax over graphs that may span ranks: the
    per-rank segment max and exp-sum reduce over the axis (pmax on values
    that take no gradient: the shift cancels out of the log-softmax), the
    target's score comes from its owner rank.  Returns (nll [G], zero where
    not ``valid``; pred [G], each graph's first node at its maximum)."""
    n_local = h.shape[0]
    base = axis.index * n_local
    seg = node_graph.long()
    real = node_mask > 0
    scores = H.node_select_scores(head, h, X)                  # [n_local]
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(real, scores, torch.full_like(scores, neg))
    gmax = comm.pmax(torch.full((n_graphs + 1,), float("-inf"),
                                dtype=scores.dtype, device=scores.device
                                ).scatter_reduce(0, seg, masked.detach(),
                                                 "amax"), axis.group)
    # finite exp arguments on padding rows too (0 there)
    shift = torch.where(real, scores - gmax[seg], torch.zeros_like(scores))
    ex = torch.where(real, torch.exp(shift), torch.zeros_like(scores))
    # summed in f64 and rounded once, as the single-device normalizer
    # (ops/segment.py::_segment_shift)
    sumexp = comm.psum(segment_sum(ex.double(), node_graph, n_graphs + 1),
                       axis.group).to(ex.dtype)
    # the target's score from the rank that holds it (H.pick_node on this
    # rank's rows: 0 where the target lies elsewhere)
    t_score = comm.psum(H.pick_node(scores, node_graph, tgt_global - base,
                                    n_graphs), axis.group)
    logp_t = torch.where(valid, t_score - gmax[:n_graphs] - torch.log(
        sumexp[:n_graphs].clamp_min(1e-30)), torch.zeros_like(t_score))
    idx = base + torch.arange(n_local, device=h.device)
    big = torch.iinfo(torch.int64).max
    is_max = (masked == gmax[seg]) & real
    pred = comm.pmin(torch.full((n_graphs + 1,), big, dtype=torch.int64,
                                device=h.device).scatter_reduce(
        0, seg, torch.where(is_max, idx, torch.full_like(idx, big)),
        "amin")[:n_graphs], axis.group)
    return -logp_t, pred


def sharded_node_select_loss(head: dict, h, ann, node_graph, node_mask,
                             n_nodes, target_local, n_graphs: int, axis):
    """Node-selection softmax cross-entropy over graphs that may span
    ranks (the reference's, pinned to ``heads.node_select_loss``).  Returns
    (loss, correct_sum, count), the same replica on every rank."""
    offs = H.node_offsets(n_nodes)
    tgt_global = (offs + target_local).long()
    graph_mask = n_nodes > 0
    nll, pred = _sharded_round_node_nll(head, h, ann, node_graph, node_mask,
                                        tgt_global, graph_mask, n_graphs,
                                        axis)
    count = graph_mask.float().sum()
    loss = nll.sum() / count.clamp_min(1.0)
    correct = (pred == tgt_global) & graph_mask
    return loss, correct.float().sum(), count


def _gated_pool(head, h, X, node_graph, node_mask, n_graphs, axis):
    """The σ·tanh gated pool, per-rank segment sums psum'd → [G, G_dim]."""
    hx = torch.cat([h.float(), X.float()], dim=1)
    gate = torch.sigmoid(hx @ head["gi_w"].float() + head["gi_b"].float())
    val = torch.tanh(hx @ head["gj_w"].float() + head["gj_b"].float())
    return comm.psum(segment_sum(gate * val * node_mask.float()[:, None],
                                 node_graph, n_graphs), axis.group)


def sharded_graph_gated_loss(head: dict, h, ann, node_graph, node_mask,
                             n_nodes, target_cls, n_graphs: int, axis):
    """Graph-level gated-readout classification over graphs that may span
    ranks: the pool is psum'd, the classifier MLP and the cross-entropy run
    replicated (``heads.graph_gated_logits`` + ``graph_class_loss``)."""
    pooled = _gated_pool(head, h, ann, node_graph, node_mask, n_graphs, axis)
    logits = H._mlp2(head, pooled, "c1", "c1b", "c2", "c2b")
    loss, correct, graph_mask = H.graph_class_loss(logits, target_cls,
                                                   n_nodes)
    return loss, correct.float().sum(), graph_mask.sum()


def sharded_per_node_loss(head: dict, h, ann, node_mask, labels_full, axis):
    """Per-node classification over partitioned nodes: logits and NLL per
    rank, the three normalising sums psum'd (``heads.per_node_loss``).
    ``labels_full`` [n_pad] is replicated (−1 = unlabelled or padding);
    each rank slices its rows."""
    n_local = h.shape[0]
    base = axis.index * n_local
    labels = labels_full[base:base + n_local].long()
    logits = H.per_node_logits(head, h, ann)
    valid = (labels >= 0) & (node_mask > 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -H.pick_class(logp, labels.clamp_min(0))
    nll_sum = comm.psum(torch.where(valid, nll, torch.zeros_like(nll)).sum(),
                        axis.group)
    n_valid = comm.psum(valid.float().sum(), axis.group)
    loss = nll_sum / n_valid.clamp_min(1.0)
    correct = (logits.argmax(-1) == labels) & valid
    return loss, comm.psum(correct.float().sum(), axis.group), n_valid


def sharded_ggsnn_losses(cfg: ModelConfig, run_steps, ann, node_graph,
                         node_mask, nfa, n_graphs: int, axis):
    """Sharded GGS-NN: the K rounds on each rank, per round re-propagating
    from pad(X^{(k)}, D) through ``run_steps``, the round's output (the
    cross-rank node softmax, or the psum'd gated pool into the token
    classifier) and the local rewrite X^{(k+1)} = σ(F_x([h ; X^{(k)}])).
    ``nfa``: the ``out`` / ``ann_net`` round parameters (leading-K stacked
    without ``cfg.share_round_nets``), ``n_nodes`` [G], the targets
    (``seq`` or ``seq_nodes`` [G, K], −1 past each sequence) and optionally
    ``ann_seq`` [n_pad, K, A] (annotation supervision; each rank slices
    its rows).  Returns stack([loss, seq_correct_sum, graph_count]), the
    same replica on every rank."""
    n_local = ann.shape[0]
    n_nodes = nfa["n_nodes"]
    graph_mask = n_nodes > 0
    use_node = cfg.ggsnn_output == "node"
    tgt = nfa["seq_nodes"] if use_node else nfa["seq"]        # [G, K]
    use_sup = cfg.ann_supervision and nfa.get("ann_seq") is not None
    base = axis.index * n_local
    if use_sup:
        ann_tgt = nfa["ann_seq"][base:base + n_local].float()  # [n_local,K,A]
    if use_node:
        offs = H.node_offsets(n_nodes)
    mask = node_mask.float()
    seg = node_graph.long().clamp(0, n_graphs - 1)

    def round_net(tree, k):
        if cfg.share_round_nets:
            return tree
        return {name: v[k] for name, v in tree.items()}

    zero = torch.zeros((), dtype=torch.float32, device=ann.device)
    X = ann.float()
    nll_sum = valid_sum = bce_sum = w_sum = zero
    seq_ok = torch.ones(n_graphs, dtype=torch.bool, device=ann.device)
    for k in range(cfg.n_rounds):
        out_p, ann_p = round_net(nfa["out"], k), round_net(nfa["ann_net"], k)
        tgt_k = tgt[:, k]
        valid_k = (tgt_k >= 0) & graph_mask
        h = run_steps(init_state(X, cfg.state_dim))
        if use_node:
            tgt_global = (offs + tgt_k.clamp_min(0)).long()
            nll_k, pred = _sharded_round_node_nll(
                out_p, h, X, node_graph, node_mask, tgt_global, valid_k,
                n_graphs, axis)
            step_ok = (pred == tgt_global) | ~valid_k
        else:
            pooled = _gated_pool(out_p, h, X, node_graph, node_mask,
                                 n_graphs, axis)
            logits = H._mlp2(out_p, pooled, "c1", "c1b", "c2", "c2b")
            logp = torch.log_softmax(logits, dim=-1)
            nll_k = -H.pick_class(logp, tgt_k.clamp_min(0).long())
            nll_k = torch.where(valid_k, nll_k, torch.zeros_like(nll_k))
            step_ok = (logits.argmax(-1) == tgt_k) | ~valid_k
        X_next = annotation_update(ann_p, h, X) * mask[:, None]
        if use_sup:
            # GGS-NN-opt: BCE on the rewritten annotations, weighted by the
            # round's validity of each node's graph; one psum pair after
            # the rounds
            t_k = ann_tgt[:, k]
            p = X_next.clamp(1e-6, 1.0 - 1e-6)
            bce = -(t_k * torch.log(p) + (1.0 - t_k) * torch.log(1.0 - p))
            w = valid_k.float()[seg] * mask
            bce_sum = bce_sum + (bce * w[:, None]).sum()
            w_sum = w_sum + w.sum()
        X = X_next
        nll_sum = nll_sum + nll_k.sum()
        valid_sum = valid_sum + valid_k.float().sum()
        seq_ok = seq_ok & step_ok
    loss = nll_sum / valid_sum.clamp_min(1.0)
    if use_sup:
        loss = loss + cfg.ann_loss_weight \
            * comm.psum(bce_sum, axis.group) \
            / comm.psum(w_sum, axis.group).clamp_min(1.0)
    correct = (seq_ok & graph_mask).float().sum()
    return torch.stack([loss, correct, graph_mask.float().sum()])


def _make_sharded_objective(cfg, mesh, n_graphs, strategy, axis_name,
                            halo_meta):
    """The loss of the sharded train and eval steps: the configured head's
    cross-rank loss (node_fn) or, for GGS-NN, the rounds (body_fn);
    returns (loss, (correct, count)), the same replica on every rank."""
    if cfg.head not in ("node_select", "graph_gated", "per_node", "ggsnn"):
        raise ValueError(f"unknown head {cfg.head!r}")

    def node_fn(h, ann, ngraph, nmask, nfa, axis):
        if cfg.head == "graph_gated":
            out = sharded_graph_gated_loss(
                nfa["head"], h, ann, ngraph, nmask, nfa["n_nodes"],
                nfa["cls"], n_graphs, axis)
        elif cfg.head == "per_node":
            out = sharded_per_node_loss(nfa["head"], h, ann, nmask,
                                        nfa["node_labels"], axis)
        else:
            out = sharded_node_select_loss(
                nfa["head"], h, ann, ngraph, nmask, nfa["n_nodes"],
                nfa["node"], n_graphs, axis)
        return torch.stack(out)

    def body_fn(run_steps, ann, ngraph, nmask, nfa, axis):
        return sharded_ggsnn_losses(cfg, run_steps, ann, ngraph, nmask, nfa,
                                    n_graphs, axis)

    def objective(params, parts, targets, halo_arrays):
        layouts = _layouts(halo_arrays, halo_meta)
        if cfg.head == "ggsnn":
            nfa = {"out": params["out"], "ann_net": params["ann"],
                   "n_nodes": targets["n_nodes"],
                   **{k: targets[k] for k in ("seq", "seq_nodes", "ann_seq")
                      if k in targets}}
            out = sharded_propagate(
                params["prop"], cfg, mesh, parts, strategy=strategy,
                axis_name=axis_name, halo_layouts=layouts, body_fn=body_fn,
                node_fn_args=nfa)
        else:
            nfa = {"head": params["head"], "n_nodes": targets["n_nodes"],
                   **{k: v for k, v in targets.items()
                      if k in ("node", "cls", "node_labels")}}
            out = sharded_propagate(
                params["prop"], cfg, mesh, parts, strategy=strategy,
                axis_name=axis_name, halo_layouts=layouts, node_fn=node_fn,
                node_fn_args=nfa)
        return out[0], (out[1], out[2])

    return objective


def make_sharded_task_train_step(cfg: ModelConfig, mesh, optimizer,
                                 n_graphs: int,
                                 strategy: str = "halo_overlap",
                                 axis_name: str = "graph",
                                 halo_meta=None):
    """Sharded task training: the whole parameter tree (propagation and
    head or round nets; ``optimizer`` holds its leaves) against the head's
    loss computed with cross-rank collectives, so graphs may span ranks.
    Heads: ``node_select`` (targets ``n_nodes`` [G], ``node`` [G]),
    ``graph_gated`` (``cls``), ``per_node`` (``node_labels`` [n_pad],
    replicated), ``ggsnn`` (``seq`` / ``seq_nodes`` [G, K], optionally
    ``ann_seq`` [n_pad, K, A]); targets are tensors on the rank's device.

    Returns ``train_step(params, parts, targets, halo_arrays=None) ->
    metrics`` (updates ``params`` in place); the metrics are the
    ``loss_sum``, ``correct`` and ``count`` sums of the single-device
    ``make_train_step``."""
    _check_trainable(cfg)
    _need_meta(strategy, halo_meta, train=True)
    objective = _make_sharded_objective(cfg, mesh, n_graphs, strategy,
                                        axis_name, halo_meta)
    axis = mesh.axis(axis_name)

    def train_step(params, parts, targets, halo_arrays=None):
        optimizer.zero_grad(set_to_none=True)
        loss, (correct, count) = objective(params, parts, targets,
                                           halo_arrays)
        _sum_grads_and_step(params, loss, optimizer, axis)
        return {"loss_sum": (loss * count).detach(),
                "correct": correct.detach(), "count": count.detach()}

    return train_step


def make_sharded_eval_step(cfg: ModelConfig, mesh, n_graphs: int,
                           strategy: str = "halo_overlap",
                           axis_name: str = "graph", halo_meta=None):
    """The forward-only counterpart of :func:`make_sharded_task_train_step`:
    ``eval_step(params, parts, targets, halo_arrays=None) -> metrics``."""
    _need_meta(strategy, halo_meta, train=False)
    objective = _make_sharded_objective(cfg, mesh, n_graphs, strategy,
                                        axis_name, halo_meta)

    @torch.no_grad()
    def eval_step(params, parts, targets, halo_arrays=None):
        loss, (correct, count) = objective(params, parts, targets,
                                           halo_arrays)
        return {"loss_sum": loss * count, "correct": correct,
                "count": count}

    return eval_step
