"""Top-level model API: ``forward`` and ``loss_and_metrics`` over a padded
batch.

Counterpart of ``ggnn_tpu/models/api.py``.  ``arrays`` is
:attr:`ggnn_tpu.graph.GraphBatch.arrays` with its arrays as tensors on one
device; ``n_graphs`` comes from the PaddingSpec.
"""

from __future__ import annotations

from ggnn_tpu_torch.models import heads as H
from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.ggnn import propagate


def _ggsnn_unported():
    return NotImplementedError(
        "head='ggsnn' (the GGS-NN round loop and its losses) is not ported "
        "yet (ROADMAP.md Queue 1 item 7)")


def forward(params: dict, cfg: ModelConfig, arrays: dict, n_graphs: int,
            scatter_layout=None):
    """Head outputs: node scores [N] / per-node logits [N, C] / graph
    logits [B, C].  ``scatter_layout`` (a device ScatterLayout) selects the
    typed-block kernels when ``cfg.backend == 'onehot'``."""
    if cfg.head == "ggsnn":
        raise _ggsnn_unported()
    ann = arrays["annotations"]
    h = propagate(params["prop"], cfg, ann, arrays["edge_src"],
                  arrays["edge_dst"], arrays["edge_type"],
                  arrays["edge_mask"], scatter_layout=scatter_layout)
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
    if cfg.head == "ggsnn":
        raise _ggsnn_unported()
    tgts = arrays["targets"]
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
