"""Readout heads and their losses on flattened padded batches.

Counterpart of ``ggnn_tpu/models/heads.py``.  Every head reads the final
node states h [N, D] concatenated with the annotations x [N, A]; each loss
returns (scalar loss, per-item ``correct``, the mask of real items).
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops.segment import (masked_segment_max,
                                        segment_log_softmax)


def _mlp2(p, x, w1="w1", b1="b1", w2="w2", b2="b2"):
    hidden = torch.tanh(x @ p[w1].float() + p[b1].float())
    return hidden @ p[w2].float() + p[b2].float()


def node_select_scores(head: dict, h, annotations):
    """o_v = MLP([h_v ; x_v]) → [N] scalar scores."""
    hx = torch.cat([h.float(), annotations.float()], dim=1)
    return _mlp2(head, hx)[:, 0]


def per_node_logits(head: dict, h, annotations):
    """[N, C] per-node class logits."""
    hx = torch.cat([h.float(), annotations.float()], dim=1)
    return _mlp2(head, hx)


def graph_gated_pool(head: dict, h, annotations, node_graph, node_mask,
                     n_graphs: int):
    """h_G = Σ_v σ(i([h;x])) ⊙ tanh(j([h;x])) per graph → [B, G]; padding
    nodes (graph id B, mask 0) add nothing."""
    hx = torch.cat([h.float(), annotations.float()], dim=1)
    gate = torch.sigmoid(hx @ head["gi_w"].float() + head["gi_b"].float())
    val = torch.tanh(hx @ head["gj_w"].float() + head["gj_b"].float())
    vals = gate * val * node_mask.float()[:, None]
    pooled = torch.zeros(n_graphs + 1, vals.shape[1], dtype=vals.dtype,
                         device=vals.device)
    pooled.index_add_(0, node_graph.long(), vals)
    return pooled[:n_graphs]


def graph_gated_logits(head: dict, h, annotations, node_graph, node_mask,
                       n_graphs: int):
    """[B, C] graph-level logits: gated pool + tanh-hidden classifier."""
    hG = graph_gated_pool(head, h, annotations, node_graph, node_mask,
                          n_graphs)
    return _mlp2(head, hG, "c1", "c1b", "c2", "c2b")


def node_offsets(n_nodes):
    """Exclusive cumsum of per-graph node counts → flattened-index base."""
    return torch.cat([torch.zeros(1, dtype=n_nodes.dtype,
                                  device=n_nodes.device),
                      torch.cumsum(n_nodes, 0)[:-1].to(n_nodes.dtype)])


def node_select_loss(scores, node_graph, node_mask, n_nodes, target_local,
                     n_graphs: int):
    """Per-graph softmax-over-nodes cross-entropy and exact-match accuracy;
    returns (loss, correct [B] bool, graph mask [B]).  ``target_local`` is
    the node id within each graph; the prediction is the FIRST node that
    reaches its graph's maximum score."""
    offs = node_offsets(n_nodes)
    target_global = (offs + target_local).long()
    logp = segment_log_softmax(scores, node_graph, n_graphs + 1, node_mask)
    graph_mask = (n_nodes > 0).to(scores.dtype)
    nll = -logp[target_global] * graph_mask
    loss = nll.sum() / graph_mask.sum().clamp_min(1.0)

    seg = node_graph.long()
    masked, seg_max = masked_segment_max(scores, seg, n_graphs + 1,
                                         node_mask)
    is_max = (masked == seg_max[seg]) & (node_mask > 0)
    n = scores.shape[0]
    idx = torch.arange(n, device=scores.device)
    pred = torch.full((n_graphs + 1,), n, dtype=torch.long,
                      device=scores.device).scatter_reduce(
        0, seg, torch.where(is_max, idx, torch.full_like(idx, n)), "amin")
    correct = (pred[:n_graphs] == target_global) & (n_nodes > 0)
    return loss, correct, graph_mask


def graph_class_loss(logits, target, n_nodes):
    """[B, C] logits vs [B] int targets; padding graphs masked out."""
    graph_mask = (n_nodes > 0).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, target.long()[:, None])[:, 0] * graph_mask
    loss = nll.sum() / graph_mask.sum().clamp_min(1.0)
    correct = (logits.argmax(-1) == target) & (n_nodes > 0)
    return loss, correct, graph_mask


def per_node_loss(logits, labels, node_mask):
    """[N, C] logits vs [N] labels (−1 = unlabeled or padding)."""
    valid = (labels >= 0) & (node_mask > 0)
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    loss = nll.sum() / valid.sum().clamp_min(1)
    correct = (logits.argmax(-1) == labels) & valid
    return loss, correct, valid
