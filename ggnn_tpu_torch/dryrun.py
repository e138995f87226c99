"""The port's dry-run entry points (the counterpart of
``__graft_entry__.py``).

- :func:`entry` — the flagship forward step (GGNN propagation and the
  node-selection head on a synthetic graph of 4,096 nodes and 32,768
  edges, D = 64, 8 edge types, T = 5) and its inputs, on a device.
- :func:`dryrun_multichip` — spawns ``n`` ranks of a ``torch.distributed``
  world and runs on them, through :mod:`ggnn_tpu_torch.parallel`, one
  step of each sharded path on tiny shapes: the data-parallel train step
  on an ``n_data × n_graph`` mesh, a halo-exchange propagation, a
  halo_window propagation on a community graph, q8 halo_window serving at
  D = 128, the fused halo_window task train step on grad layouts, and the
  sharded GGS-NN train step through halo_overlap; the first, second and
  last on the reference's batch of 4 graphs of 2n nodes.  Each rank
  prints nothing; rank 0's line of losses and shapes is printed.

    python -m ggnn_tpu_torch.dryrun [--ranks N] [--device cuda|cpu]

Runs on the card by default (each rank on ``cuda:{rank % device_count}``,
over gloo where ranks share a card, else NCCL); without one that raises.
"""

from __future__ import annotations

import argparse
import socket
import time

import numpy as np
import torch


def entry(device="cuda"):
    """Returns (fn, (params, arrays)): the flagship forward step,
    ``fn(params, arrays)`` → node scores [4096], and its inputs (random
    weights from seed 0) on ``device``."""
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models import ModelConfig, forward, init_params
    from ggnn_tpu_torch.models.init import device_or_raise
    from ggnn_tpu_torch.train.loop import batch_arrays

    device = device_or_raise(device)
    cfg = ModelConfig(state_dim=64, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select")
    batch = synthetic_batch(4096, 32768, n_edge_types=8, annotation_dim=8,
                            seed=0)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    arrays = batch_arrays(batch, device)
    n_graphs = batch.spec.n_graphs

    def fn(params, arrays):
        with torch.no_grad():
            return forward(params, cfg, arrays, n_graphs)

    return fn, (params, arrays)


def _tiny_batch(n):
    """The reference's tiny batch (``__graft_entry__.py:80-97``): 4 graphs
    of 2n nodes (the data-parallel step gives a rank whole graphs, some
    ranks none where n > 4)."""
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    rng = np.random.default_rng(0)
    n_graphs, n_per, n_et, ann_dim = 4, 2 * n, 4, 2
    graphs = []
    for _ in range(n_graphs):
        m = 3 * n_per // 2
        edges = np.stack([rng.integers(0, n_per, m),
                          rng.integers(0, n_et, m),
                          rng.integers(0, n_per, m)], axis=1)
        ann = (rng.random((n_per, ann_dim)) < 0.3).astype(np.float32)
        graphs.append(dict(n_nodes=n_per, edges=edges, annotations=ann,
                           targets={"node": np.asarray(0, np.int32)}))
    e_pad = -(-2 * n_graphs * (3 * n_per // 2) // (8 * n)) * (8 * n)
    spec = PaddingSpec(n_graphs=n_graphs, n_pad=n_graphs * n_per,
                       e_pad=e_pad, n_edge_types=n_et, annotation_dim=ann_dim)
    return batch_graphs(graphs, spec)


def _stages(n, device):
    """Stages 1-5 on this rank of an initialised world of ``n`` ranks;
    returns its losses and the global shapes of the propagations."""
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models import ModelConfig, init_params
    from ggnn_tpu_torch.parallel import (make_mesh,
                                         make_sharded_task_train_step,
                                         partition_batch, sharded_propagate)
    from ggnn_tpu_torch.parallel.partition import (build_halo_window_layouts,
                                                   split_local_remote)
    from ggnn_tpu_torch.parallel.train import (make_gspmd_train_step,
                                               shard_batch_arrays)
    from ggnn_tpu_torch.train.loop import make_optimizer, param_leaves

    def model(cfg, seed):
        params = init_params(cfg, torch.Generator().manual_seed(seed), dev)
        for p in param_leaves(params):
            p.requires_grad_(True)
        return params, make_optimizer(params, 1e-3)

    def rows(h):
        return (n * h.shape[0], h.shape[1])

    n_data = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n_graph=n // n_data, n_data=n_data, device=device)
    graph_mesh = make_mesh(n_graph=n, n_data=1, device=device)
    dev = graph_mesh.device
    batch = _tiny_batch(n)
    n_graphs, n_et, ann_dim = batch.spec.n_graphs, 4, 2
    cfg = ModelConfig(state_dim=8, annotation_dim=ann_dim, n_edge_types=n_et,
                      n_steps=3, head="node_select")
    params, optimizer = model(cfg, 0)

    # 1) the data-parallel train step over the whole ('data', 'graph') mesh
    train_step = make_gspmd_train_step(cfg, n_graphs, optimizer, mesh)
    metrics = train_step(params, shard_batch_arrays(batch, mesh))

    # 2) halo-exchange propagation over the graph axis
    parts = partition_batch(batch, n)
    with torch.no_grad():
        h = sharded_propagate(params["prop"], cfg, graph_mesh, parts,
                              strategy="halo")

    # 3) halo_window on a community graph of 128-row shards
    cb = synthetic_batch(128 * n, 768 * n, n_et, annotation_dim=ann_dim,
                         seed=1, node_mult=128 * n, n_communities=n,
                         p_intra=0.9)
    cparts = split_local_remote(partition_batch(cb, n))
    with torch.no_grad():
        hw = sharded_propagate(params["prop"], cfg, graph_mesh, cparts,
                               strategy="halo_window")

    # 3b) q8 serving through the sharded fused window step
    cfg_q = ModelConfig(state_dim=128, annotation_dim=ann_dim,
                        n_edge_types=n_et, n_steps=2, head="node_select",
                        backend="window", fuse_gru=True,
                        quantized_table=True)
    params_q = init_params(cfg_q, torch.Generator().manual_seed(5), dev)
    qlay = build_halo_window_layouts(
        cparts, window=128, min_edges_per_tile=8, spill_tile_e=64,
        n_message_types=cfg_q.n_message_types, row_major="block",
        typed_spill=True)
    with torch.no_grad():
        hq = sharded_propagate(params_q["prop"], cfg_q, graph_mesh, cparts,
                               strategy="halo_window", halo_layouts=qlay)

    # 4) sharded task training through the fused window step (#13's
    # emit_res, #4, #14) on grad layouts, the node_select loss across ranks
    warr, wmeta = build_halo_window_layouts(
        cparts, window=128, min_edges_per_tile=8, spill_tile_e=64,
        n_message_types=cfg.n_message_types, with_grad=True,
        row_major="block")
    cfg_f = ModelConfig(state_dim=128, annotation_dim=ann_dim,
                        n_edge_types=n_et, n_steps=3, head="node_select",
                        backend="window", fuse_gru=True)
    params_f, opt_f = model(cfg_f, 3)
    tstep = make_sharded_task_train_step(cfg_f, graph_mesh, opt_f, 1,
                                         strategy="halo_window",
                                         halo_meta=wmeta)
    # cb is one big graph (graph id 0): target = node 0
    ct = {"node": torch.zeros(1, dtype=torch.int32, device=dev),
          "n_nodes": torch.tensor([cb.spec.n_pad], dtype=torch.int32,
                                  device=dev)}
    m3 = tstep(params_f, cparts, ct, warr)

    # 5) sharded GGS-NN: the annotation-rewrite rounds across ranks
    cfg_g = ModelConfig(state_dim=8, annotation_dim=ann_dim,
                        n_edge_types=n_et, n_steps=2, head="ggsnn",
                        n_classes=4, n_rounds=2)
    params_g, opt_g = model(cfg_g, 4)
    gstep = make_sharded_task_train_step(cfg_g, graph_mesh, opt_g, n_graphs,
                                         strategy="halo_overlap")
    gparts = split_local_remote(partition_batch(batch, n))
    gt = {"seq": torch.zeros((n_graphs, 2), dtype=torch.int32, device=dev),
          "n_nodes": torch.as_tensor(batch.n_nodes, device=dev)}
    m4 = gstep(params_g, gparts, gt)
    return {"train_loss_sum": float(metrics["loss_sum"]),
            "halo_shape": rows(h), "halo_window_shape": rows(hw),
            "q8_shape": rows(hq), "q8_finite": bool(torch.isfinite(hq).all()),
            "window_train_loss_sum": float(m3["loss_sum"]),
            "ggsnn_train_loss_sum": float(m4["loss_sum"])}


def summary(n, res) -> str:
    """The reference's one line of losses and shapes."""
    return (f"dryrun_multichip({n}): ok — "
            f"train step loss_sum={res['train_loss_sum']:.4f}, "
            f"halo propagate h shape={res['halo_shape']}, "
            f"halo_window h shape={res['halo_window_shape']}, "
            f"halo_window TRAIN loss_sum={res['window_train_loss_sum']:.4f}, "
            f"ggsnn sharded TRAIN loss_sum={res['ggsnn_train_loss_sum']:.4f}")


def _rank(rank, n, port, device, queue):
    """One rank (a spawned process): joins the world, runs the stages,
    puts (rank, result or traceback) on ``queue``."""
    import os
    import traceback
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        import torch.distributed as dist

        from ggnn_tpu_torch.parallel.multihost import initialize_multihost
        initialize_multihost(f"127.0.0.1:{port}", n, rank, init_timeout_s=120,
                             device=device)
        res = _stages(n, device)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, res))
    except BaseException:
        queue.put((rank, traceback.format_exc()))


def dryrun_multichip(n: int, device=None, timeout: float = 600) -> list:
    """Spawn ``n`` ranks (the ``spawn`` start method) on ``device`` (None:
    each rank's card, ``cuda:{rank % device_count}``, raising without one;
    'cpu' for CPU ranks), run the five stages on each and print rank 0's
    line.  Returns every rank's result (losses and shapes); raises with
    the traceback of a rank that failed or outlived ``timeout`` seconds."""
    import multiprocessing as mp
    import queue as queue_mod

    from ggnn_tpu_torch.parallel.multihost import rank_device
    if device is None:
        rank_device(None)               # raise here without a card
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, n, port, device, q))
             for r in range(n)]
    for p in procs:
        p.start()
    results = [None] * n
    deadline = time.monotonic() + timeout
    try:
        for _ in range(n):
            try:
                rank, res = q.get(timeout=max(1.0,
                                              deadline - time.monotonic()))
            except queue_mod.Empty:
                raise RuntimeError(f"dryrun_multichip({n}): no result within "
                                   f"{timeout} s (a rank hangs)") from None
            if isinstance(res, str):
                raise RuntimeError(f"dryrun_multichip({n}): rank {rank} "
                                   f"failed:\n{res}")
            results[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    print(summary(n, results[0]), flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ggnn_tpu_torch.dryrun")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where to run (default cuda; without a card it "
                         "raises)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry forward ok:", tuple(out.shape), flush=True)
    dryrun_multichip(args.ranks, None if args.device == "cuda" else "cpu")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
