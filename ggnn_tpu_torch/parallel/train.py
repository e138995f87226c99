"""The data-parallel train step: the counterpart of the reference's GSPMD
step (``ggnn_tpu/parallel/train.py``).

For a flattened graph batch the reference shards the node and edge axes
over the whole mesh and lets XLA insert the collectives.  Here each rank of
the mesh takes a contiguous range of whole graphs, cut where the batch's
real nodes split evenly (:func:`part_bounds`, :func:`split_batch`,
:func:`shard_batch_arrays`; any graph count over any rank count, a rank
with fewer graphs padded with empty slots, one with none all padding),
runs the single-device model on them, and the ranks sum: every loss is a
ratio of sums (the graphs with nodes for node_select and graph_gated, the
labelled nodes for per_node, the valid rounds and the supervised
annotation weights for GGS-NN; an empty slot adds to none of them), so
each rank backprops its numerators over the global denominators
(all-reduced, no gradient), the parameter gradients are summed over the
ranks and every rank takes the same optimizer step.  The step equals the
single-device step on the whole batch; its metrics are the whole batch's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.models.api import _ggsnn, loss_and_metrics
from ggnn_tpu_torch.models.ggsnn import (ann_bce_sums, graph_round_nll,
                                         node_round_nll)
from ggnn_tpu_torch.parallel import comm
from ggnn_tpu_torch.train.loop import batch_arrays, param_leaves

# the per-node targets of a batch (node-aligned, leading axis n_pad)
NODE_TARGETS = ("node_labels", "ann_seq")
# the per-graph targets whose empty slots say "no round" (GGS-NN's token
# and path-node sequences); the others pad with 0, as ``batch_graphs`` does
GRAPH_TARGET_PAD = {"seq": -1, "seq_nodes": -1}


def part_bounds(n_nodes, n_parts: int) -> np.ndarray:
    """The graph ranges of the ``n_parts`` parts of a batch whose graphs
    have ``n_nodes`` nodes: int64 [n_parts + 1], part p holding graphs
    ``[bounds[p], bounds[p + 1])``.  Part p ends at the first graph
    boundary at or past (p + 1)/P of the real nodes, so the parts balance
    nodes as the reference's even node-axis sharding does (equal graphs
    that P divides: B/P each); the last part ends at the last slot.  A
    part may hold no graph."""
    n_nodes = np.asarray(n_nodes, np.int64)
    starts = np.concatenate([[0], np.cumsum(n_nodes)])
    ends = np.searchsorted(starts * n_parts,
                           np.arange(1, n_parts + 1) * starts[-1])
    ends[-1] = n_nodes.shape[0]
    return np.concatenate([[0], ends]).astype(np.int64)


def split_batch(batch: GraphBatch, n_parts: int, part: int) -> GraphBatch:
    """Part ``part`` of ``n_parts`` of ``batch`` (:func:`part_bounds`:
    whole, contiguous graphs) as a batch of its own: its graphs' nodes
    (contiguous in the flattened axis) and real edges re-indexed from 0, in
    the batch's (type, dst, src) order, the per-graph and per-node targets
    sliced.  Every part gets the same spec: the largest part's graph count
    and its node and edge counts, rounded up to multiples of 128 and 8.  A
    part with fewer graphs ends in empty slots (``n_nodes`` 0, per-graph
    targets padded with ``GRAPH_TARGET_PAD`` or 0); a part with no graph is
    all padding."""
    spec = batch.spec
    bounds = part_bounds(batch.n_nodes, n_parts)
    b = int(np.diff(bounds).max())
    starts = np.concatenate([[0], np.cumsum(batch.n_nodes)]).astype(np.int64)
    real = batch.edge_mask > 0

    def span(p):
        n0, n1 = starts[bounds[p]], starts[bounds[p + 1]]
        sel = real & (batch.edge_dst >= n0) & (batch.edge_dst < n1)
        return n0, n1, sel

    spans = [span(p) for p in range(n_parts)]
    rup = lambda x, m: max(((x + m - 1) // m) * m, m)
    n_pad = rup(max(int(n1 - n0) for n0, n1, _ in spans), 128)
    e_pad = rup(max(int(sel.sum()) for *_, sel in spans), 8)
    sub = dataclasses.replace(spec, n_graphs=b, n_pad=n_pad, e_pad=e_pad)
    n0, n1, sel = spans[part]
    g0, g1 = int(bounds[part]), int(bounds[part + 1])
    n = int(n1 - n0)
    ann = np.zeros((n_pad, spec.annotation_dim), np.float32)
    ann[:n] = batch.annotations[n0:n1]
    node_graph = np.full(n_pad, b, np.int32)
    node_graph[:n] = batch.node_graph[n0:n1] - g0
    node_mask = np.zeros(n_pad, np.float32)
    node_mask[:n] = batch.node_mask[n0:n1]
    n_nodes = np.zeros(b, batch.n_nodes.dtype)
    n_nodes[:g1 - g0] = batch.n_nodes[g0:g1]
    m = int(sel.sum())
    edges = {}
    for key in ("edge_src", "edge_dst", "edge_type"):
        arr = np.zeros(e_pad, np.int32)
        arr[:m] = getattr(batch, key)[sel] - (n0 if key != "edge_type" else 0)
        edges[key] = arr
    edge_mask = np.zeros(e_pad, np.float32)
    edge_mask[:m] = 1.0
    offsets = np.zeros(spec.n_message_types + 1, np.int32)
    np.cumsum(np.bincount(edges["edge_type"][:m],
                          minlength=spec.n_message_types), out=offsets[1:])
    targets = {}
    for key, val in batch.targets.items():
        val = np.asarray(val)
        if key in NODE_TARGETS:
            out = np.zeros((n_pad, *val.shape[1:]), val.dtype)
            out[:n] = val[n0:n1]
        else:
            out = np.full((b, *val.shape[1:]), GRAPH_TARGET_PAD.get(key, 0),
                          val.dtype)
            out[:g1 - g0] = val[g0:g1]
        targets[key] = out
    return GraphBatch(spec=sub, annotations=ann, node_graph=node_graph,
                      node_mask=node_mask, type_offsets=offsets,
                      n_nodes=n_nodes, edge_mask=edge_mask, targets=targets,
                      **edges)


def shard_batch_arrays(batch: GraphBatch, mesh) -> dict:
    """This rank's part of ``batch`` (:func:`split_batch` over every rank
    of the mesh) as tensors on its device, targets included."""
    return batch_arrays(split_batch(batch, mesh.size, mesh.rank),
                        mesh.device)


def _loss_terms(params, cfg, arrays, n_graphs, scatter_layout):
    """This rank's loss as terms (coefficient, numerator, denominator), the
    whole batch's loss being Σ coefficient · Σ_ranks numerator /
    Σ_ranks denominator; and its (correct, count) sums."""
    if cfg.head != "ggsnn":
        loss, m = loss_and_metrics(params, cfg, arrays, n_graphs,
                                   scatter_layout=scatter_layout)
        # loss = Σ nll / max(count, 1), and Σ nll is 0 where count is
        return [(1.0, loss * m["count"], m["count"])], m["correct"], \
            m["count"]
    out, anns = _ggsnn(params, cfg, arrays, n_graphs, scatter_layout)
    tgts, n_nodes = arrays["targets"], arrays["n_nodes"]
    if cfg.ggsnn_output == "node":
        nll, valid, ok = node_round_nll(out, tgts["seq_nodes"],
                                        arrays["node_graph"],
                                        arrays["node_mask"], n_nodes,
                                        n_graphs)
    else:
        nll, valid, ok = graph_round_nll(out, tgts["seq"], n_nodes)
    terms = [(1.0, nll.sum(), valid.float().sum())]
    if cfg.ann_supervision and "ann_seq" in tgts:
        terms.append((cfg.ann_loss_weight, *ann_bce_sums(
            anns, tgts["ann_seq"], valid, arrays["node_graph"],
            arrays["node_mask"], n_graphs)))
    correct = (ok.all(0) & (n_nodes > 0)).float().sum()
    return terms, correct, (n_nodes > 0).float().sum()


def make_gspmd_train_step(model_cfg, n_graphs: int, optimizer, mesh):
    """The data-parallel step over every rank of ``mesh``: ``n_graphs`` is
    the whole batch's graph count, any count over any rank count (each
    rank runs its part's slots, :func:`split_batch`, the count its arrays
    hold).  Returns ``train_step(params, arrays, scatter_layout=None) ->
    metrics``: ``arrays`` is this rank's part (:func:`shard_batch_arrays`),
    ``scatter_layout`` a layout of it as ``propagate`` takes one;
    ``optimizer`` holds ``params``' leaves, updated in place identically on
    every rank; the metrics are the whole batch's ``loss_sum``, ``correct``
    and ``count``."""
    if model_cfg.quantized_table:
        raise ValueError("quantized_table=True is a serving mode")
    del n_graphs        # the reference's signature; the parts say their own
    group = mesh.group

    def train_step(params, arrays, scatter_layout=None):
        optimizer.zero_grad(set_to_none=True)
        terms, correct, count = _loss_terms(params, model_cfg, arrays,
                                            arrays["n_nodes"].shape[0],
                                            scatter_layout)
        dens = comm.psum(torch.stack([d.detach().float()
                                      for _, _, d in terms]), group)
        objective = sum(c * num / dens[i].clamp_min(1.0)
                        for i, (c, num, _) in enumerate(terms))
        objective.backward()
        comm.allreduce_grads([p for p in param_leaves(params)
                              if p.grad is not None], group)
        optimizer.step()
        loss, correct, count = comm.psum(torch.stack(
            [objective.detach(), correct.detach(), count.detach()]), group)
        return {"loss_sum": loss * count, "correct": correct,
                "count": count}

    return train_step
