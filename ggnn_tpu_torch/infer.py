"""Inference / serving API: load a checkpoint, predict on graphs.

Counterpart of ``ggnn_tpu/infer.py``: static-shape padded batching with a
fixed :class:`~ggnn_tpu_torch.graph.PaddingSpec` and task-level decoding
(argmax node / per-node classes / graph class).

For ``backend='onehot'`` each batch gets the layout the JAX Predictor
builds, :func:`~ggnn_tpu_torch.ops.legacy.layout_for_batch` without its grad
half: the legacy table-gather path (the node-transform table, its gather and
the one-hot scatter), with the reference's rounding points.  A caller may
pass a typed pack (``build_typed_dst_layout(...).to(device)``) to
:meth:`Predictor.run_batch` instead: the same function, rounded elsewhere.
For ``backend='window'`` each batch gets the reference's
:func:`~ggnn_tpu_torch.ops.window.window_layout_for_batch` (static tile
budgets, the legacy spill); any other window layout goes through
:meth:`Predictor.run_batch`.  For ``backend='pallas'`` (and ``xla``) a
batch needs no host layout: ``propagate`` packs the type tiles on the device
from the batch's ``type_offsets``.

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
from ggnn_tpu_torch.ops.legacy import layout_for_batch
from ggnn_tpu_torch.ops.window import window_layout_for_batch
from ggnn_tpu_torch.train.checkpoint import load_checkpoint

_ARRAY_KEYS = ("annotations", "node_graph", "node_mask", "n_nodes",
               "edge_src", "edge_dst", "edge_type", "edge_mask",
               "type_offsets")


class Predictor:
    """Batched predictor over a fixed padding spec.

    ``predict(graphs)`` takes per-graph dicts (``n_nodes/edges/annotations``)
    and returns task-level predictions:

    - node_select → predicted node id per graph
    - per_node    → [n_nodes] class ids per graph
    - graph_gated → class id per graph
    - ggsnn       → per graph, the local node id of each round (node
      output), or the tokens before the end token ``n_classes − 1``
      (graph output)
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
        """The device scatter layout a batch needs, as the reference builds
        it: ``layout_for_batch(batch, with_grad=False)`` for ``onehot``,
        ``window_layout_for_batch(batch)`` for ``window``, None for
        ``xla`` and ``pallas`` (its tiles are packed inside
        ``propagate``)."""
        if self.cfg.backend == "window":
            return window_layout_for_batch(batch).to(self.device)
        if self.cfg.backend != "onehot":
            return None
        return layout_for_batch(batch, with_grad=False, device=self.device)

    @torch.inference_mode()
    def run_batch(self, batch, layout=None) -> np.ndarray:
        """Head outputs for one padded batch, on the host; ``layout`` (any
        layout ``propagate`` takes) defaults to :meth:`layout`."""
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
            elif cfg.head == "ggsnn" and cfg.ggsnn_output == "node":
                # round k selects the k-th path node; no end token: the
                # sequence's length is the task's round count
                decoded.append([
                    int(np.argmax(res[k, offs[gi]:offs[gi] + n]))
                    for k in range(res.shape[0])])
            elif cfg.head == "ggsnn":
                toks = []
                for k in range(res.shape[0]):
                    t = int(np.argmax(res[k, gi]))
                    if t == cfg.n_classes - 1:          # the end token
                        break
                    toks.append(t)
                decoded.append(toks)
            else:
                raise ValueError(f"unknown head {cfg.head!r}")
        return decoded
