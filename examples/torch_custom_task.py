#!/usr/bin/env python
"""Using ggnn_tpu_torch as a library on a custom graph task (the port of
``examples/custom_task.py``).

Task: "reachability" — given a directed graph with one edge type and a
marked source node, classify whether a marked target node is reachable
within T hops.  Demonstrates the framework surface a reference user needs:
graph dicts → PaddingSpec → BatchLoader → ModelConfig → train and eval
steps (the xla backend, the graph_gated head, Adam 3e-3, 60 epochs on 200
graphs).

Run: python examples/torch_custom_task.py  [--device cuda|cpu]

Trains on the card by default; without one that raises (``--device cpu``
trains on the CPU).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_example(rng, n_lo=5, n_hi=10):
    n = int(rng.integers(n_lo, n_hi))
    m = int(rng.integers(n, 2 * n))
    edges = np.stack([rng.integers(0, n, m), np.zeros(m, np.int64),
                      rng.integers(0, n, m)], axis=1)
    src, dst = rng.choice(n, 2, replace=False)
    # BFS reachability
    adj = {}
    for (u, _, v) in edges:
        adj.setdefault(int(u), set()).add(int(v))
    seen, frontier = {int(src)}, [int(src)]
    while frontier:
        u = frontier.pop()
        for v in adj.get(u, ()):  # noqa: B020
            if v not in seen:
                seen.add(v)
                frontier.append(v)
    ann = np.zeros((n, 2), np.float32)
    ann[src, 0] = 1.0
    ann[dst, 1] = 1.0
    return dict(n_nodes=n, edges=edges, annotations=ann,
                targets={"cls": np.asarray(int(dst in seen), np.int32)})


def model_config():
    from ggnn_tpu_torch.models import ModelConfig
    return ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=1,
                       n_steps=8, head="graph_gated", n_classes=2)


def run(device="cuda", epochs=60, eval_every=10, params=None, log=print):
    """Train the reachability task and evaluate it every ``eval_every``
    epochs; ``params`` (a numpy tree, e.g. another package's) replaces the
    initial parameters drawn from seed 0.  Returns ``{"losses": [each
    step's loss], "accuracies": {epoch: test accuracy}}``; prints each
    accuracy as the JAX example does."""
    import torch

    from ggnn_tpu_torch.data.loader import BatchLoader
    from ggnn_tpu_torch.graph import PaddingSpec
    from ggnn_tpu_torch.models import init_params, params_from_numpy
    from ggnn_tpu_torch.models.init import device_or_raise
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_eval_step,
                                           make_optimizer, make_train_step,
                                           param_leaves)

    device = device_or_raise(device)
    rng = np.random.default_rng(0)
    train = [make_example(rng) for _ in range(200)]
    test = [make_example(rng) for _ in range(100)]

    B = 20
    spec = PaddingSpec(n_graphs=B, n_pad=B * 10, e_pad=B * 20 * 2,
                       n_edge_types=1, annotation_dim=2).round_up()
    cfg = model_config()
    params = (init_params(cfg, torch.Generator().manual_seed(0), device)
              if params is None else params_from_numpy(params, device))
    for p in param_leaves(params):
        p.requires_grad_(True)
    optimizer = make_optimizer(params, 3e-3)
    train_step = make_train_step(cfg, B, optimizer)
    eval_step = make_eval_step(cfg, B)

    loader = BatchLoader(train, spec, shuffle=True, seed=0)
    test_loader = BatchLoader(test, spec, shuffle=False)
    losses, accuracies = [], {}
    for epoch in range(epochs):
        for batch in loader.epoch_batches():
            m = train_step(params, batch_arrays(batch, device))
            losses.append(float(m["loss_sum"]) / max(float(m["count"]), 1.0))
        if (epoch + 1) % eval_every == 0:
            c = n = 0.0
            for batch in test_loader.epoch_batches(0):
                m = eval_step(params, batch_arrays(batch, device))
                c += float(m["correct"])
                n += float(m["count"])
            accuracies[epoch + 1] = c / n
            log(f"epoch {epoch + 1}: test accuracy {c / n:.3f}")
    return {"losses": losses, "accuracies": accuracies}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where to train (default cuda; without a card it "
                         "raises)")
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
