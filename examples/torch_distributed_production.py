#!/usr/bin/env python
"""Distributed production recipe: sharded training + serving over the ranks
of a ``torch.distributed`` world, with every production lever enabled (the
port of ``examples/distributed_production.py``).

Covers the large-scale surface a reference user needs to migrate:

  1. partition a big graph over P shards, one a rank (dst-owned edges,
     deduplicated halo plan — add ``--hot_thresh`` on skewed cuts to
     broadcast hub rows via one all_gather instead of padding every
     all-to-all pair);
  2. TRAIN through the per-shard window layouts (their grad halves), the
     remote edges through the halo exchange (optionally ``--q8_grads``:
     int8 gradient streams, accuracy-gated);
  3. SERVE the trained weights under ``torch.no_grad`` with the int8 (q8)
     table per shard.

P is the world size, one process a rank:

    torchrun --nproc_per_node P examples/torch_distributed_production.py
        [--device cuda|cpu] [--backend gloo|nccl]

Each rank runs on ``cuda:{LOCAL_RANK % device_count}`` (``--device cpu``:
the CPU); without a card the default raises.  NCCL takes one rank per
device, so ranks that share a card run over gloo (and CPU ranks too); NCCL
otherwise; ``--backend`` overrides the choice.  Run alone, it is a world of
one rank.
"""

import argparse
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def setup(nodes=4096, edges=32768, types=4, dim=128, steps=3,
          hot_thresh=None, q8_grads=False, device=None, params=None,
          log=print):
    """Stage 1 on this rank of an initialised world: the graph (seed 0,
    P communities, 90 % of edges inside one), the model (bf16 compute;
    ``params``, a numpy tree, replaces the weights drawn from seed 0), the
    partition, the mesh and the training layouts.  Returns the state the
    other stages take."""
    import torch
    import torch.distributed as dist

    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models import (ModelConfig, init_params,
                                       params_from_numpy)
    from ggnn_tpu_torch.parallel import make_mesh, partition_batch
    from ggnn_tpu_torch.parallel.partition import (build_halo_window_layouts,
                                                   split_local_remote)
    from ggnn_tpu_torch.train.loop import param_leaves

    P = dist.get_world_size()
    mesh = make_mesh(n_graph=P, device=device)
    batch = synthetic_batch(nodes, edges, types, annotation_dim=4, seed=0,
                            node_mult=P * 128, n_communities=P, p_intra=0.9)
    cfg = ModelConfig(state_dim=dim, annotation_dim=4, n_edge_types=types,
                      n_steps=steps, compute_dtype="bfloat16")
    params = (init_params(cfg, torch.Generator().manual_seed(0), mesh.device)
              if params is None else params_from_numpy(params, mesh.device))
    prop = params["prop"]
    for p in param_leaves(prop):
        p.requires_grad_(True)

    # 1. partition: dst-owned edges, dedup halo (hot-set optional)
    parts = split_local_remote(partition_batch(batch, P,
                                               hot_thresh=hot_thresh))
    log(f"P={P} n_local={parts.n_local} halo={parts.halo_size} "
        f"hot={parts.hot_size}")
    arrays, meta = build_halo_window_layouts(
        parts, window=128, n_message_types=2 * types, with_grad=True,
        row_major="block", grad_quant=q8_grads)
    return dict(P=P, mesh=mesh, cfg=cfg, prop=prop, parts=parts,
                arrays=arrays, meta=meta, types=types, q8_grads=q8_grads,
                losses=[])


def train(state, train_iters=3, log=print):
    """Stage 2: ``train_iters`` sharded Adam steps (1e-3) of the
    propagation weights through halo_window (the optimizer's state carries
    over between calls); returns their losses."""
    from ggnn_tpu_torch.parallel import make_sharded_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer

    optimizer = state.get("optimizer")
    if optimizer is None:
        optimizer = state["optimizer"] = make_optimizer(state["prop"], 1e-3)
    step = make_sharded_train_step(state["cfg"], state["mesh"], optimizer,
                                   strategy="halo_window",
                                   halo_meta=state["meta"])
    losses = []
    for _ in range(train_iters):
        loss = float(step(state["prop"], state["parts"], state["arrays"]))
        log(f"train iter {len(state['losses'])}: loss={loss:.4f}"
            + ("  (int8 gradient streams)" if state["q8_grads"] else ""))
        state["losses"].append(loss)
        losses.append(loss)
    return losses


def serve(state, log=print):
    """Stage 3: the trained weights served under ``torch.no_grad`` through
    halo_window with the q8 table per shard; returns this rank's h
    [n_local, D] f32."""
    import dataclasses

    import torch

    from ggnn_tpu_torch.parallel import sharded_propagate
    from ggnn_tpu_torch.parallel.partition import build_halo_window_layouts

    cfg_q8 = dataclasses.replace(state["cfg"], backend="window",
                                 fuse_gru=True, quantized_table=True)
    arrays_s, meta_s = build_halo_window_layouts(
        state["parts"], window=128, n_message_types=2 * state["types"],
        row_major="block")
    with torch.no_grad():
        h = sharded_propagate(state["prop"], cfg_q8, state["mesh"],
                              state["parts"], strategy="halo_window",
                              halo_layouts=(arrays_s, meta_s))
    shape = (state["P"] * h.shape[0], h.shape[1])
    log(f"served h: {shape} (q8 int8 serving per shard)")
    return h


def run(train_iters=3, log=print, **kw):
    """The three stages on this rank (``kw``: :func:`setup`'s).  Returns
    ``{"losses", "h" (this rank's rows), "prop" (the trained weights)}``."""
    state = setup(log=log, **kw)
    losses = train(state, train_iters, log)
    h = serve(state, log)
    return {"losses": losses, "h": h, "prop": state["prop"]}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=32768)
    ap.add_argument("--types", type=int, default=4)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--train_iters", type=int, default=3)
    ap.add_argument("--hot_thresh", type=int, default=None,
                    help="hot-set hybrid exchange threshold (skewed cuts)")
    ap.add_argument("--q8_grads", action="store_true",
                    help="int8 gradient streams in the sharded backward")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where the ranks run (default cuda; without a "
                         "card it raises)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=["gloo", "nccl"],
                    help="the process group's backend (default: gloo on "
                         "the CPU or where ranks share a card, else nccl)")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    from ggnn_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   is_primary, rank_device)

    device = None if args.device == "cuda" else "cpu"
    rank_device(device)                 # raise before the rendezvous
    if not initialize_multihost(backend=args.backend, device=device):
        # run alone: a world of one rank
        initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend=args.backend, device=device)
    log = print if is_primary() else (lambda *a, **k: None)
    try:
        run(args.train_iters, log, nodes=args.nodes, edges=args.edges,
            types=args.types, dim=args.dim, steps=args.steps,
            hot_thresh=args.hot_thresh, q8_grads=args.q8_grads,
            device=device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
