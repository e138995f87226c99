"""GGS-NN: sequential outputs through repeated (propagate → output →
annotate) rounds.

Counterpart of ``ggnn_tpu/models/ggsnn.py``, with a Python loop over the K
rounds in place of ``lax.scan``.  Each round runs :func:`propagate` from
h = pad(X^{(k)}, D), then the round's output (``graph_gated_logits``, or
``node_select_scores`` for ``cfg.ggsnn_output == 'node'``), then
X^{(k+1)} = σ(F_x([h; X^{(k)}])) · node_mask.  With ``share_round_nets``
the rounds share F_o and F_x; otherwise round k reads entry k of the
stacked leading-K ``out`` / ``ann`` parameters.  The losses mask rounds
past each example's target length (targets padded with −1), so sequences
of any length up to K run under one round count.

The graph's topology is the same in every round, so every layout a
backend builds from the edges is built once, before the round loop, and
handed to each round (``models/ggnn.py::default_layouts``, the helper
``propagate`` uses too): the legacy onehot layout (built on the host), the
pallas type tiles (packed on the device), and a window layout moved to the
device.  Each round then launches on the same layout tensors, so the
kernels' per-layout plans and checks (``cached_per_tensor``) are made once.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.ggnn import default_layouts, propagate
from ggnn_tpu_torch.models.heads import (_mlp2, graph_gated_logits,
                                         node_offsets, node_select_scores,
                                         pick_class, pick_node,
                                         segment_first_argmax)
from ggnn_tpu_torch.ops.segment import segment_log_softmax


def annotation_update(ann: dict, h, annotations):
    """X^{(k+1)} = σ(F_x([h ; X^{(k)}])) per node."""
    hx = torch.cat([h.float(), annotations.float()], dim=1)
    return torch.sigmoid(_mlp2(ann, hx, "a1", "a1b", "a2", "a2b"))


def _round_params(tree: dict, k: int, shared: bool) -> dict:
    return tree if shared else {name: v[k] for name, v in tree.items()}


def ggsnn_forward(params: dict, cfg: ModelConfig, annotations, node_graph,
                  node_mask, edge_src, edge_dst, edge_type, edge_mask,
                  n_graphs: int, type_offsets=None, scatter_layout=None):
    """Per-round outputs and annotations: with ``cfg.ggsnn_output='graph'``
    (the default) token logits [K, B, V]; with ``'node'`` per-node scores
    [K, N] (the round's output is the selected next path node).  Returns
    (outputs, annotations [K, N, A]).

    ``scatter_layout`` is any layout :func:`propagate` takes for the
    ``onehot`` and ``window`` backends; the default layouts are built once
    for all rounds (:func:`~ggnn_tpu_torch.models.ggnn.default_layouts`)."""
    scatter_layout, tiles_layout = default_layouts(
        cfg, annotations.shape[0], annotations.device, edge_src, edge_dst,
        edge_type, edge_mask, type_offsets, scatter_layout)
    shared = cfg.share_round_nets
    X = annotations.float()
    mask = node_mask.float()[:, None]
    outs, anns = [], []
    for k in range(cfg.n_rounds):
        out_p = _round_params(params["out"], k, shared)
        ann_p = _round_params(params["ann"], k, shared)
        h = propagate(params["prop"], cfg, X, edge_src, edge_dst, edge_type,
                      edge_mask, scatter_layout=scatter_layout,
                      tiles_layout=tiles_layout)
        if cfg.ggsnn_output == "node":
            outs.append(node_select_scores(out_p, h, X))          # [N]
        else:
            outs.append(graph_gated_logits(out_p, h, X, node_graph,
                                           node_mask, n_graphs))  # [B, V]
        X = annotation_update(ann_p, h, X) * mask
        anns.append(X)
    return torch.stack(outs), torch.stack(anns)


def ann_bce_sums(anns, ann_targets, valid, node_graph, node_mask, B: int):
    """The GGS-NN-opt annotation BCE's (sum, weight): the BCE summed over
    valid rounds and real nodes, and their count; ``ann_targets`` [N, K,
    A] (node-aligned batching)."""
    t = ann_targets.float().permute(1, 0, 2)                  # [K, N, A]
    p = anns.clamp(1e-6, 1.0 - 1e-6)
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    w = (valid.to(p.dtype)[:, node_graph.long().clamp(0, B - 1)]
         * node_mask.float()[None, :])
    return (bce * w[..., None]).sum(), w.sum()


def _ann_bce(anns, ann_targets, valid, node_graph, node_mask, B: int):
    """The GGS-NN-opt annotation BCE, its mean over valid rounds and real
    nodes."""
    total, weight = ann_bce_sums(anns, ann_targets, valid, node_graph,
                                 node_mask, B)
    return total / weight.clamp_min(1.0)


def graph_round_nll(logits, targets, n_nodes):
    """Per (round, graph) of the token output: (nll [K, B], zero where the
    round is past the sequence or the graph is padding; valid [K, B];
    step_correct [K, B])."""
    tgt = targets.t()                                          # [K, B]
    valid = (tgt >= 0) & (n_nodes[None, :] > 0)
    safe = tgt.clamp_min(0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -pick_class(logp, safe)
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    step_correct = (logits.argmax(-1) == tgt) | ~valid
    return nll, valid, step_correct


def node_round_nll(scores, target_nodes, node_graph, node_mask, n_nodes,
                   n_graphs: int):
    """:func:`graph_round_nll` of the node-selection output: per round a
    softmax over each graph's nodes against the target path node
    (``target_nodes`` [B, K] LOCAL ids), each round's prediction the first
    node at its graph's maximum (:func:`segment_first_argmax`)."""
    tgt = target_nodes.t()                                     # [K, B] local
    valid = (tgt >= 0) & (n_nodes[None, :] > 0)
    offs = node_offsets(n_nodes)
    tgt_global = (offs[None, :] + tgt.clamp_min(0)).long()
    logp = torch.stack([segment_log_softmax(s, node_graph, n_graphs + 1,
                                            node_mask) for s in scores])
    # a padding graph's target may point one past the last row: it picks
    # none of its (no) nodes, and its term is masked
    nll = -torch.stack([pick_node(lp, node_graph, t, n_graphs)
                        for lp, t in zip(logp, tgt_global)])
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    pred = segment_first_argmax(scores, node_graph, node_mask, n_graphs)
    step_correct = (pred == tgt_global) | ~valid
    return nll, valid, step_correct


def ggsnn_loss(logits, targets, n_nodes, anns=None, ann_targets=None,
               node_graph=None, node_mask=None, ann_weight: float = 1.0):
    """Σ_k CE(logits_k, target_k) over the valid rounds (+ the optional
    GGS-NN-opt annotation BCE); exact-match sequence accuracy.  Returns
    (loss, correct [B] bool, graph mask [B])."""
    B = logits.shape[1]
    nll, valid, step_correct = graph_round_nll(logits, targets, n_nodes)
    loss = nll.sum() / valid.sum().clamp_min(1)
    if anns is not None and ann_targets is not None:
        loss = loss + ann_weight * _ann_bce(anns, ann_targets, valid,
                                            node_graph, node_mask, B)
    seq_correct = step_correct.all(0) & (n_nodes > 0)
    return loss, seq_correct, (n_nodes > 0).to(logits.dtype)


def ggsnn_node_loss(scores, target_nodes, node_graph, node_mask, n_nodes,
                    n_graphs: int, anns=None, ann_targets=None,
                    ann_weight: float = 1.0):
    """The loss of the node-selection output (``cfg.ggsnn_output='node'``):
    per round, a softmax over each graph's nodes against the target path
    node (``target_nodes`` [B, K] LOCAL ids, −1 past the path's end);
    exact-match sequence accuracy over the valid rounds (:func:`
    node_round_nll`)."""
    nll, valid, step_correct = node_round_nll(
        scores, target_nodes, node_graph, node_mask, n_nodes, n_graphs)
    loss = nll.sum() / valid.sum().clamp_min(1)
    if anns is not None and ann_targets is not None:
        loss = loss + ann_weight * _ann_bce(anns, ann_targets, valid,
                                            node_graph, node_mask, n_graphs)
    seq_correct = step_correct.all(0) & (n_nodes > 0)
    return loss, seq_correct, (n_nodes > 0).to(scores.dtype)
