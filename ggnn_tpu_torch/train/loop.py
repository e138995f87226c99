"""Train and eval steps and the ``Trainer`` (counterpart of
``ggnn_tpu/train/loop.py``).

A train step is zero-grad → ``loss_and_metrics`` → backward → one
``torch.optim.Adam`` step (``AdamW`` with decoupled decay when
``weight_decay > 0``), with optax's defaults (β = (0.9, 0.999), ε = 1e-8).
Parameters are the nested dict of tensors of :func:`init_params`, updated in
place; the optimizer holds their leaves in the checkpoint's key order.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ggnn_tpu_torch.data.babi import TASKS, BabiDataset
from ggnn_tpu_torch.data.generators import generate_all
from ggnn_tpu_torch.data.loader import BatchLoader
from ggnn_tpu_torch.graph import PaddingSpec
from ggnn_tpu_torch.models.api import loss_and_metrics
from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.init import device_or_raise, init_params
from ggnn_tpu_torch.train.checkpoint import (_flatten, load_checkpoint,
                                             save_checkpoint)
from ggnn_tpu_torch.train.config import TrainConfig
from ggnn_tpu_torch.train.metrics import MetricsLogger

_UNPORTED_BACKENDS = {
    "onehot": "the Trainer's onehot backend batches with the legacy onehot "
              "layout (layout_for_batch), ROADMAP Queue 1 item 3",
    "pallas": "the pallas backend (packed_messages), ROADMAP Queue 1 item 6",
    "window": "the window backend, ROADMAP Queue 1 item 5",
}


def param_leaves(params) -> list:
    """The parameter tensors in the checkpoint's key order."""
    return [t for _, t in _flatten(params)]


def make_optimizer(params, lr: float, weight_decay: float = 0.0):
    """Adam over every leaf of ``params``, or AdamW (decoupled decay, as
    ``optax.adamw``) when ``weight_decay > 0``."""
    leaves = param_leaves(params)
    if weight_decay > 0:
        return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def opt_state_tree(optimizer, params) -> dict:
    """The optimizer's state as a tree for the checkpoint: the step count
    and the first and second moments shaped like ``params``."""
    def moments(tree, key):
        if isinstance(tree, dict):
            return {k: moments(v, key) for k, v in tree.items()}
        st = optimizer.state.get(tree, {})
        return st[key].detach().clone() if key in st else \
            torch.zeros_like(tree, memory_format=torch.contiguous_format)
    steps = [float(st["step"]) for st in optimizer.state.values()
             if "step" in st]
    count = int(steps[0]) if steps else 0
    return {"count": torch.tensor(count, dtype=torch.int32),
            "mu": moments(params, "exp_avg"),
            "nu": moments(params, "exp_avg_sq")}


def load_opt_state(optimizer, params, tree) -> None:
    """Put a tree of :func:`opt_state_tree`'s shape back into the
    optimizer (exact: the moments are copied bit for bit)."""
    count = int(tree["count"])
    mus = param_leaves(tree["mu"])
    nus = param_leaves(tree["nu"])
    for p, m, v in zip(param_leaves(params), mus, nus):
        if count == 0:
            optimizer.state.pop(p, None)
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.to(p.device, p.dtype).clone(),
            "exp_avg_sq": v.to(p.device, p.dtype).clone()}


def make_train_step(model_cfg: ModelConfig, n_graphs: int, optimizer):
    """``train_step(params, arrays, scatter_layout=None) -> metrics``: one
    optimizer step on ``params`` (updated in place; ``optimizer`` must hold
    their leaves).  ``scatter_layout`` is any device layout ``propagate``
    takes, e.g. a typed pack built ``with_grad=True``."""
    if model_cfg.quantized_table:
        raise ValueError(
            "quantized_table=True is a SERVING mode (forward-only int8 "
            "table); train with quantized_table=False and quantize the "
            "trained weights for serving")

    def train_step(params, arrays, scatter_layout=None):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_and_metrics(params, model_cfg, arrays, n_graphs,
                                         scatter_layout=scatter_layout)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}
    return train_step


def make_eval_step(model_cfg: ModelConfig, n_graphs: int):
    @torch.no_grad()
    def eval_step(params, arrays, scatter_layout=None):
        _, metrics = loss_and_metrics(params, model_cfg, arrays, n_graphs,
                                      scatter_layout=scatter_layout)
        return metrics
    return eval_step


def batch_arrays(batch, device) -> dict:
    """A GraphBatch's arrays (targets included) as tensors on ``device``."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.as_tensor(x, device=device)
    return conv(batch.arrays)


class Trainer:
    """End-to-end experiment runner for one registered config::

        t = Trainer(build_config("babi4"))
        result = t.run()          # trains, evals, checkpoints, logs
        result["test_accuracy"]

    ``device`` is where the model trains: the card by default, 'cpu' only
    when asked; a 'cuda' request without a card raises."""

    def __init__(self, cfg: TrainConfig,
                 logger: Optional[MetricsLogger] = None, device="cuda"):
        self.device = device_or_raise(device)
        if cfg.model.head == "ggsnn":
            raise NotImplementedError(
                f"config {cfg.name!r} trains a GGS-NN (head='ggsnn'), which "
                "is not ported yet (ROADMAP.md Queue 1 item 7)")
        if cfg.model.backend in _UNPORTED_BACKENDS:
            raise NotImplementedError(
                f"backend={cfg.model.backend!r} is not ported for training: "
                f"{_UNPORTED_BACKENDS[cfg.model.backend]}")
        self.cfg = cfg
        self.logger = logger or MetricsLogger(cfg.metrics_path)
        task = TASKS[cfg.task_id]

        train_path = os.path.join(cfg.data_root, f"processed_{cfg.fold}",
                                  "train", f"{cfg.task_id}_graphs.txt")
        if not os.path.exists(train_path):
            if not cfg.generate_if_missing:
                raise FileNotFoundError(train_path)
            generate_all(cfg.data_root, tasks=(cfg.task_id,),
                         folds=(cfg.fold,),
                         n_train=max(cfg.n_train * task.n_question_types, 50),
                         n_test=max(cfg.n_test * task.n_question_types, 50),
                         seed=cfg.seed)

        self.train_ds = BabiDataset(cfg.data_root, cfg.task_id, "train",
                                    cfg.fold, cfg.question_id, cfg.n_train)
        self.test_ds = BabiDataset(cfg.data_root, cfg.task_id, "test",
                                   cfg.fold, cfg.question_id, cfg.n_test)

        # one static spec covering both splits, as the reference
        max_nodes = max(self.train_ds.max_nodes, self.test_ds.max_nodes)
        max_edges = max(self.train_ds.max_edges, self.test_ds.max_edges)
        self.spec = PaddingSpec(
            n_graphs=cfg.batch_size,
            n_pad=cfg.batch_size * max_nodes,
            e_pad=cfg.batch_size * max_edges * 2,
            n_edge_types=task.n_edge_types,
            annotation_dim=task.annotation_dim).round_up()

        pads = self.train_ds.target_pads()
        self.train_loader = BatchLoader(self.train_ds.graphs, self.spec, pads,
                                        shuffle=True, seed=cfg.seed)
        self.test_loader = BatchLoader(self.test_ds.graphs, self.spec, pads,
                                       shuffle=False)

        self.params = init_params(cfg.model,
                                  torch.Generator().manual_seed(cfg.seed),
                                  self.device)
        for p in param_leaves(self.params):
            p.requires_grad_(True)
        self.optimizer = make_optimizer(self.params, cfg.lr, cfg.weight_decay)
        self.train_step = make_train_step(cfg.model, cfg.batch_size,
                                          self.optimizer)
        self.eval_step = make_eval_step(cfg.model, cfg.batch_size)
        self.step = 0
        self.epoch = 0
        self._eval_cache = None

    # -- checkpointing ----------------------------------------------------
    def _ckpt_tree(self):
        return {"params": self.params,
                "opt_state": opt_state_tree(self.optimizer, self.params)}

    def save(self, path: str) -> None:
        save_checkpoint(path, self._ckpt_tree(), step=self.step,
                        epoch=self.epoch, extra={"config": self.cfg.name})

    def restore(self, path: str) -> None:
        """Resume from a checkpoint this package wrote (exact)."""
        tree, meta = load_checkpoint(path, self._ckpt_tree())
        with torch.no_grad():
            for p, v in zip(param_leaves(self.params),
                            param_leaves(tree["params"])):
                p.copy_(v)
        load_opt_state(self.optimizer, self.params, tree["opt_state"])
        self.step = meta["step"]
        self.epoch = meta["epoch"]
        self.train_loader.epoch = self.epoch

    # -- loops ------------------------------------------------------------
    def train_epoch(self) -> dict:
        sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        edges = 0.0
        t0 = time.perf_counter()
        for batch in self.train_loader.epoch_batches(self.epoch):
            m = self.train_step(self.params,
                                batch_arrays(batch, self.device))
            self.step += 1
            edges += float(batch.edge_mask.sum())
            for k in sums:
                sums[k] += float(m[k])
        dt = time.perf_counter() - t0
        self.epoch += 1
        n = max(sums["count"], 1.0)
        # propagated edge-messages per second (directed edges × T steps)
        eps = edges * self.cfg.model.n_steps / max(dt, 1e-9)
        return {"split": "train", "epoch": self.epoch, "step": self.step,
                "loss": sums["loss_sum"] / n, "accuracy": sums["correct"] / n,
                "epoch_time_s": dt, "edges_per_sec": eps}

    def evaluate(self) -> dict:
        sums = {"loss_sum": 0.0, "correct": 0.0, "count": 0.0}
        if self._eval_cache is None:
            # test topologies are fixed (no shuffle): convert them once
            self._eval_cache = [batch_arrays(b, self.device)
                                for b in self.test_loader.epoch_batches(0)]
        for arrays in self._eval_cache:
            m = self.eval_step(self.params, arrays)
            for k in sums:
                sums[k] += float(m[k])
        n = max(sums["count"], 1.0)
        return {"split": "test", "epoch": self.epoch, "step": self.step,
                "loss": sums["loss_sum"] / n, "accuracy": sums["correct"] / n}

    def run(self) -> dict:
        cfg = self.cfg
        best = 0.0
        for _ in range(cfg.epochs - self.epoch):
            tr = self.train_epoch()
            if self.epoch % cfg.eval_every == 0 or self.epoch == cfg.epochs:
                ev = self.evaluate()
                best = max(best, ev["accuracy"])
                self.logger.log({**tr, "test_loss": ev["loss"],
                                 "test_accuracy": ev["accuracy"]})
            if cfg.checkpoint_every and cfg.checkpoint_dir and \
                    self.epoch % cfg.checkpoint_every == 0:
                self.save(os.path.join(cfg.checkpoint_dir,
                                       f"{cfg.name}_ep{self.epoch}.npz"))
        ev = self.evaluate()
        best = max(best, ev["accuracy"])
        if cfg.checkpoint_dir:
            self.save(os.path.join(cfg.checkpoint_dir,
                                   f"{cfg.name}_final.npz"))
        result = {"config": cfg.name, "epochs": self.epoch,
                  "test_accuracy": ev["accuracy"], "best_accuracy": best,
                  "test_loss": ev["loss"]}
        self.logger.log(result)
        return result
