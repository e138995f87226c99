"""Readout heads (forward halves) on flattened padded batches.

Counterpart of ``ggnn_tpu/models/heads.py``.  Every head reads the final
node states h [N, D] concatenated with the annotations x [N, A].  The
losses come with training.
"""

from __future__ import annotations

import torch


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
