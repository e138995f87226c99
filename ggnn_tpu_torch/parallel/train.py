"""The data-parallel train step: the counterpart of the reference's GSPMD
step (``ggnn_tpu/parallel/train.py``).

For a flattened graph batch the reference shards the node and edge axes
over the whole mesh and lets XLA insert the collectives.  Here each rank of
the mesh takes a contiguous range of whole graphs (:func:`split_batch`,
:func:`shard_batch_arrays`), runs the single-device model on them, and the
ranks sum: every loss is a ratio of sums (the graph count for node_select
and graph_gated, the labelled nodes for per_node, the valid rounds and the
supervised annotation weights for GGS-NN), so each rank backprops its
numerators over the global denominators (all-reduced, no gradient), the
parameter gradients are summed over the ranks and every rank takes the same
optimizer step.  The step equals the single-device step on the whole
batch; its metrics are the whole batch's.
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


def split_batch(batch: GraphBatch, n_parts: int, part: int) -> GraphBatch:
    """Graphs ``[part·B/P, (part+1)·B/P)`` of ``batch`` as a batch of their
    own: their nodes (contiguous in the flattened axis) and real edges
    re-indexed from 0, in the batch's (type, dst, src) order, the per-graph
    and per-node targets sliced.  Every part gets the same spec: ``B/P``
    graphs and the largest part's node and edge counts, rounded up to
    multiples of 128 and 8."""
    spec = batch.spec
    B = spec.n_graphs
    if B % n_parts:
        raise ValueError(f"{B} graphs do not split into {n_parts} parts")
    b = B // n_parts
    starts = np.concatenate([[0], np.cumsum(batch.n_nodes)]).astype(np.int64)
    real = batch.edge_mask > 0

    def span(p):
        n0, n1 = starts[p * b], starts[(p + 1) * b]
        sel = real & (batch.edge_dst >= n0) & (batch.edge_dst < n1)
        return n0, n1, sel

    spans = [span(p) for p in range(n_parts)]
    rup = lambda x, m: max(((x + m - 1) // m) * m, m)
    n_pad = rup(max(int(n1 - n0) for n0, n1, _ in spans), 128)
    e_pad = rup(max(int(sel.sum()) for *_, sel in spans), 8)
    sub = dataclasses.replace(spec, n_graphs=b, n_pad=n_pad, e_pad=e_pad)
    n0, n1, sel = spans[part]
    n = int(n1 - n0)
    ann = np.zeros((n_pad, spec.annotation_dim), np.float32)
    ann[:n] = batch.annotations[n0:n1]
    node_graph = np.full(n_pad, b, np.int32)
    node_graph[:n] = batch.node_graph[n0:n1] - part * b
    node_mask = np.zeros(n_pad, np.float32)
    node_mask[:n] = batch.node_mask[n0:n1]
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
            out = val[part * b:(part + 1) * b]
        targets[key] = out
    return GraphBatch(spec=sub, annotations=ann, node_graph=node_graph,
                      node_mask=node_mask, type_offsets=offsets,
                      n_nodes=batch.n_nodes[part * b:(part + 1) * b].copy(),
                      edge_mask=edge_mask, targets=targets, **edges)


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
    the whole batch's graph count (each rank runs ``n_graphs / P`` of
    them).  Returns ``train_step(params, arrays, scatter_layout=None) ->
    metrics``: ``arrays`` is this rank's part (:func:`shard_batch_arrays`),
    ``scatter_layout`` a layout of it as ``propagate`` takes one;
    ``optimizer`` holds ``params``' leaves, updated in place identically on
    every rank; the metrics are the whole batch's ``loss_sum``, ``correct``
    and ``count``."""
    if model_cfg.quantized_table:
        raise ValueError("quantized_table=True is a serving mode")
    P = mesh.size
    if n_graphs % P:
        raise ValueError(f"{n_graphs} graphs do not split over {P} ranks")
    group = mesh.group

    def train_step(params, arrays, scatter_layout=None):
        optimizer.zero_grad(set_to_none=True)
        terms, correct, count = _loss_terms(params, model_cfg, arrays,
                                            n_graphs // P, scatter_layout)
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
