"""Top-level model API: ``forward`` over a padded batch.

Counterpart of ``ggnn_tpu/models/api.py::forward``.  ``arrays`` is
:attr:`ggnn_tpu.graph.GraphBatch.arrays` with its arrays as tensors on one
device; ``n_graphs`` comes from the PaddingSpec.
"""

from __future__ import annotations

from ggnn_tpu_torch.models import heads as H
from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.ggnn import propagate


def forward(params: dict, cfg: ModelConfig, arrays: dict, n_graphs: int,
            scatter_layout=None):
    """Head outputs: node scores [N] / per-node logits [N, C] / graph
    logits [B, C].  ``scatter_layout`` (a device ScatterLayout) selects the
    typed-block kernels when ``cfg.backend == 'onehot'``."""
    if cfg.head == "ggsnn":
        raise NotImplementedError(
            "head='ggsnn' (the GGS-NN round loop) is not ported yet "
            "(ROADMAP.md Queue 1)")
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
