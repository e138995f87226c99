"""Readout heads and their losses on flattened padded batches.

Counterpart of ``ggnn_tpu/models/heads.py``.  Every head reads the final
node states h [N, D] concatenated with the annotations x [N, A]; each loss
returns (scalar loss, per-item ``correct``, the mask of real items).
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops.segment import segment_log_softmax
from ggnn_tpu_torch.ops.segment_rows import segment_sum


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
    nodes (graph id B, mask 0) add nothing; the sum in a fixed order
    (``ops/segment_rows.py``)."""
    hx = torch.cat([h.float(), annotations.float()], dim=1)
    gate = torch.sigmoid(hx @ head["gi_w"].float() + head["gi_b"].float())
    val = torch.tanh(hx @ head["gj_w"].float() + head["gj_b"].float())
    return segment_sum(gate * val * node_mask.float()[:, None], node_graph,
                       n_graphs)


def graph_gated_logits(head: dict, h, annotations, node_graph, node_mask,
                       n_graphs: int):
    """[B, C] graph-level logits: gated pool + tanh-hidden classifier."""
    hG = graph_gated_pool(head, h, annotations, node_graph, node_mask,
                          n_graphs)
    return _mlp2(head, hG, "c1", "c1b", "c2", "c2b")


def pick_class(logp, target):
    """logp[..., target] along the last axis: the entries at the target
    class kept, the rest 0, summed (one term a row: exact).  Its backward
    writes g at the target, where a gather's scatters it."""
    hit = torch.arange(logp.shape[-1], device=logp.device) == target[..., None]
    return torch.where(hit, logp, torch.zeros_like(logp)).sum(-1)


def pick_node(logp, node_graph, target_global, n_graphs: int):
    """logp[target_global[b]] for each graph b [n_graphs]: each graph's
    nodes with the target's entry kept and the rest 0, summed by the
    fixed-order segment sum (one term a graph; 0 for a graph whose target
    is none of its nodes, such as an empty slot's).  Its backward is a
    gather, where ``logp[target]``'s is an accumulating scatter."""
    seg = node_graph.long()
    tgt = torch.cat([target_global.long(),
                     target_global.new_full((1,), -1).long()])
    hit = torch.arange(logp.shape[0], device=logp.device) == tgt[seg]
    return segment_sum(torch.where(hit, logp, torch.zeros_like(logp)),
                       node_graph, n_graphs)


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
    reaches its graph's maximum score.  A graph without nodes adds nothing:
    its target may point one past the last row, so its term is masked (the
    reference clamps its gather; :func:`pick_node` reads no row there)."""
    offs = node_offsets(n_nodes)
    target_global = (offs + target_local).long()
    logp = segment_log_softmax(scores, node_graph, n_graphs + 1, node_mask)
    real = n_nodes > 0
    graph_mask = real.to(scores.dtype)
    nll = -pick_node(logp, node_graph, target_global, n_graphs)
    nll = torch.where(real, nll, torch.zeros_like(nll))
    loss = nll.sum() / graph_mask.sum().clamp_min(1.0)

    pred = segment_first_argmax(scores[None], node_graph, node_mask,
                                n_graphs)[0]
    correct = (pred == target_global) & (n_nodes > 0)
    return loss, correct, graph_mask


def segment_first_argmax(scores, node_graph, node_mask, n_graphs: int):
    """Per row of ``scores`` [K, N], each graph's argmax node (global id):
    the LOWEST node index among the nodes that reach its graph's maximum,
    as the reference's ``segment_min`` over the max positions; padding
    nodes (mask 0) never win.  Returns [K, n_graphs] int64 (N for a graph
    without nodes)."""
    K, N = scores.shape
    seg = node_graph.long()[None, :].expand(K, N)
    real = node_mask[None, :] > 0
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(real, scores, torch.full_like(scores, neg))
    seg_max = torch.full((K, n_graphs + 1), float("-inf"),
                         dtype=scores.dtype, device=scores.device
                         ).scatter_reduce(1, seg, masked, "amax")
    is_max = (masked == seg_max.gather(1, seg)) & real
    idx = torch.arange(N, device=scores.device)[None, :].expand(K, N)
    big = torch.full_like(idx, N)
    pred = torch.full((K, n_graphs + 1), N, dtype=torch.long,
                      device=scores.device).scatter_reduce(
        1, seg, torch.where(is_max, idx, big), "amin")
    return pred[:, :n_graphs]


def graph_class_loss(logits, target, n_nodes):
    """[B, C] logits vs [B] int targets; padding graphs masked out."""
    graph_mask = (n_nodes > 0).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -pick_class(logp, target.long()) * graph_mask
    loss = nll.sum() / graph_mask.sum().clamp_min(1.0)
    correct = (logits.argmax(-1) == target) & (n_nodes > 0)
    return loss, correct, graph_mask


def per_node_loss(logits, labels, node_mask):
    """[N, C] logits vs [N] labels (−1 = unlabeled or padding)."""
    valid = (labels >= 0) & (node_mask > 0)
    safe = labels.clamp_min(0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -pick_class(logp, safe)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    loss = nll.sum() / valid.sum().clamp_min(1)
    correct = (logits.argmax(-1) == labels) & valid
    return loss, correct, valid
