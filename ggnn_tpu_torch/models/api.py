"""Top-level model API: ``forward`` and ``loss_and_metrics`` over a padded
batch.

Counterpart of ``ggnn_tpu/models/api.py``.  ``arrays`` is
:attr:`ggnn_tpu.graph.GraphBatch.arrays` with its arrays as tensors on one
device; ``n_graphs`` comes from the PaddingSpec.  ``head='ggsnn'`` runs the
GGS-NN rounds (:mod:`ggnn_tpu_torch.models.ggsnn`).
"""

from __future__ import annotations

from ggnn_tpu_torch.models import heads as H
from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.ggnn import propagate
from ggnn_tpu_torch.models.ggsnn import (ggsnn_forward, ggsnn_loss,
                                         ggsnn_node_loss)


def _ggsnn(params, cfg, arrays, n_graphs, scatter_layout):
    """The GGS-NN rounds on a batch: (outputs, annotations)."""
    return ggsnn_forward(
        params, cfg, arrays["annotations"], arrays["node_graph"],
        arrays["node_mask"], arrays["edge_src"], arrays["edge_dst"],
        arrays["edge_type"], arrays["edge_mask"], n_graphs=n_graphs,
        type_offsets=arrays.get("type_offsets"),
        scatter_layout=scatter_layout)


def forward(params: dict, cfg: ModelConfig, arrays: dict, n_graphs: int,
            scatter_layout=None):
    """Head outputs: node scores [N] / per-node logits [N, C] / graph
    logits [B, C] / GGS-NN round outputs [K, B, V] (or [K, N] with the node
    output).  ``scatter_layout`` is any layout ``propagate`` takes for
    ``cfg.backend == 'onehot'`` (None: the reference's default); the
    ``pallas`` backend packs its tiles from ``arrays["type_offsets"]``."""
    if cfg.head == "ggsnn":
        return _ggsnn(params, cfg, arrays, n_graphs, scatter_layout)[0]
    ann = arrays["annotations"]
    h = propagate(params["prop"], cfg, ann, arrays["edge_src"],
                  arrays["edge_dst"], arrays["edge_type"],
                  arrays["edge_mask"], type_offsets=arrays.get("type_offsets"),
                  scatter_layout=scatter_layout)
    if cfg.head == "node_select":
        return H.node_select_scores(params["head"], h, ann)
    if cfg.head == "per_node":
        return H.per_node_logits(params["head"], h, ann)
    if cfg.head == "graph_gated":
        return H.graph_gated_logits(params["head"], h, ann,
                                    arrays["node_graph"],
                                    arrays["node_mask"], n_graphs)
    raise ValueError(f"unknown head {cfg.head!r}")


def loss_and_metrics(params: dict, cfg: ModelConfig, arrays: dict,
                     n_graphs: int, scatter_layout=None):
    """(scalar loss, metrics dict of 0-d tensors ``loss_sum``, ``correct``,
    ``count``) for one padded batch; ``arrays["targets"]`` holds the
    head's targets as tensors."""
    tgts = arrays["targets"]
    if cfg.head == "ggsnn":
        out, anns = _ggsnn(params, cfg, arrays, n_graphs, scatter_layout)
        sup = cfg.ann_supervision and "ann_seq" in tgts
        ann_kw = dict(anns=anns if sup else None,
                      ann_targets=tgts.get("ann_seq") if sup else None,
                      ann_weight=cfg.ann_loss_weight)
        if cfg.ggsnn_output == "node":
            loss, correct, mask = ggsnn_node_loss(
                out, tgts["seq_nodes"], arrays["node_graph"],
                arrays["node_mask"], arrays["n_nodes"], n_graphs, **ann_kw)
        else:
            loss, correct, mask = ggsnn_loss(
                out, tgts["seq"], arrays["n_nodes"],
                node_graph=arrays["node_graph"],
                node_mask=arrays["node_mask"], **ann_kw)
        count = mask.float().sum()
        return loss, {"loss_sum": loss * count,
                      "correct": correct.float().sum(), "count": count}
    out = forward(params, cfg, arrays, n_graphs, scatter_layout=scatter_layout)
    if cfg.head == "node_select":
        loss, correct, mask = H.node_select_loss(
            out, arrays["node_graph"], arrays["node_mask"], arrays["n_nodes"],
            tgts["node"], n_graphs)
    elif cfg.head == "per_node":
        loss, correct, mask = H.per_node_loss(out, tgts["node_labels"],
                                              arrays["node_mask"])
    elif cfg.head == "graph_gated":
        loss, correct, mask = H.graph_class_loss(out, tgts["cls"],
                                                 arrays["n_nodes"])
    else:
        raise ValueError(f"unknown head {cfg.head!r}")
    count = mask.float().sum()
    metrics = {"loss_sum": loss * count,
               "correct": correct.float().sum(), "count": count}
    return loss, metrics
