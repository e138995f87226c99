"""Inference / serving API: load a checkpoint, predict on graphs.

Counterpart of ``ggnn_tpu/infer.py``: static-shape padded batching with a
fixed :class:`~ggnn_tpu_torch.graph.PaddingSpec` and task-level decoding
(argmax node / per-node classes / graph class).

For ``backend='onehot'`` each batch gets the typed-pack layout over the dst
space rounded up to the 128-row grid: the per-block kernels where block mode
engages, the per-tile kernels where it declines (hub-heavy and power-law
graphs).  It computes the same function as the JAX Predictor's legacy
table-gather layout, whose kernels are still to be ported.

The model runs on the card unless the caller asks for ``device="cpu"``;
without a CUDA device the default raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ggnn_tpu_torch.data.babi import TASKS
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.models.api import forward
from ggnn_tpu_torch.models.config import ModelConfig, model_config_for_task
from ggnn_tpu_torch.models.init import (device_or_raise, init_params,
                                        params_from_numpy)
from ggnn_tpu_torch.ops.scatter import _rup_block, build_typed_dst_layout
from ggnn_tpu_torch.train.checkpoint import load_checkpoint

_ARRAY_KEYS = ("annotations", "node_graph", "node_mask", "n_nodes",
               "edge_src", "edge_dst", "edge_type", "edge_mask")


class Predictor:
    """Batched predictor over a fixed padding spec.

    ``predict(graphs)`` takes per-graph dicts (``n_nodes/edges/annotations``)
    and returns task-level predictions:

    - node_select → predicted node id per graph
    - per_node    → [n_nodes] class ids per graph
    - graph_gated → class id per graph
    """

    def __init__(self, cfg: ModelConfig, spec: PaddingSpec, params=None,
                 checkpoint_path: str | None = None, device="cuda"):
        self.cfg = cfg
        self.spec = spec
        self.device = device_or_raise(device)
        if params is None:
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 self.device)
            if checkpoint_path:
                tree, _ = load_checkpoint(checkpoint_path,
                                          {"params": params})
                params = tree["params"]
        else:
            params = params_from_numpy(params, self.device)
        self.params = params

    @classmethod
    def for_task(cls, task_id: int, checkpoint_path: str | None = None,
                 batch_size: int = 10, max_nodes: int = 16,
                 max_edges: int = 40, device="cuda",
                 **model_kw) -> "Predictor":
        task = TASKS[task_id]
        cfg = model_config_for_task(task, **model_kw)
        spec = PaddingSpec(
            n_graphs=batch_size, n_pad=batch_size * max_nodes,
            e_pad=batch_size * max_edges * 2,
            n_edge_types=task.n_edge_types,
            annotation_dim=task.annotation_dim).round_up()
        return cls(cfg, spec, checkpoint_path=checkpoint_path, device=device)

    def layout(self, batch):
        """The device scatter layout a batch needs (None for ``xla``)."""
        if self.cfg.backend != "onehot":
            return None
        spec = batch.spec
        return build_typed_dst_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type,
            batch.edge_mask, _rup_block(spec.n_pad),
            n_message_types=2 * spec.n_edge_types).to(self.device)

    @torch.inference_mode()
    def run_batch(self, batch, layout=None) -> np.ndarray:
        """Head outputs for one padded batch, on the host."""
        arrays = {k: torch.as_tensor(getattr(batch, k), device=self.device)
                  for k in _ARRAY_KEYS}
        if layout is None:
            layout = self.layout(batch)
        out = forward(self.params, self.cfg, arrays, self.spec.n_graphs,
                      scatter_layout=layout)
        return out.cpu().numpy()

    def predict(self, graphs: list[dict]) -> list:
        out = []
        B = self.spec.n_graphs
        for i in range(0, len(graphs), B):
            chunk = graphs[i:i + B]
            batch = batch_graphs(chunk, self.spec)
            out.extend(self.decode(self.run_batch(batch), batch, len(chunk)))
        return out

    def decode(self, res, batch, n_real):
        """Task-level predictions of the first ``n_real`` graphs."""
        cfg = self.cfg
        offs = np.concatenate([[0], np.cumsum(batch.n_nodes)])[:-1]
        decoded = []
        for gi in range(n_real):
            n = int(batch.n_nodes[gi])
            if cfg.head == "node_select":
                decoded.append(int(np.argmax(res[offs[gi]:offs[gi] + n])))
            elif cfg.head == "per_node":
                decoded.append(np.argmax(res[offs[gi]:offs[gi] + n], axis=-1))
            elif cfg.head == "graph_gated":
                decoded.append(int(np.argmax(res[gi])))
            else:
                raise ValueError(f"unknown head {cfg.head!r}")
        return decoded
