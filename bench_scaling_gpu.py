#!/usr/bin/env python
"""Multi-card scaling benchmark of the PyTorch/CUDA port: edges/s per
device for the sharded halo-exchange propagation
(``ggnn_tpu_torch.parallel.sharded_propagate``) over P graph shards, and
each P's scaling efficiency against the first P (the north star asks
≥ 90 % from one card to many).  The port of ``bench_scaling.py``: the same
CLI, graph, model, partition and JSON line.

One process a rank, started by torchrun (or alone: a world of one):

    torchrun --nproc_per_node 1 bench_scaling_gpu.py [--strategy S]
    torchrun --nproc_per_node 2 bench_scaling_gpu.py --device cpu \\
        --nodes 2048 --edges 8192 --dim 8 --steps 2 --iters 1 --shards 1 2

Each rank joins through ``parallel/multihost.py::initialize_multihost``
(NCCL with a card a rank, gloo where ranks share a card or on the CPU).
For each P the first P ranks form the mesh and propagate; the others wait
at a barrier.  On the card the time of one propagation and its sum comes
from CUDA events after a barrier, on the CPU from ``time.perf_counter``;
each iteration's time is the largest over the ranks; one warm-up, then the
best of ``--iters``.  Rank 0 prints a line a P on stderr, the card's
``nvidia-smi`` line, then the reference's JSON line.  Ranks that share one
card give P > 1 figures that are a functional check, not a scaling number.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

from ggnn_tpu_torch.parallel.halo import STRATEGIES


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--edges", type=int, default=4_000_000)
    ap.add_argument("--types", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--strategy", type=str, default="halo_onehot",
                    choices=STRATEGIES)
    ap.add_argument("--shards", type=int, nargs="*", default=None,
                    help="shard counts to test (default: 1..world size)")
    ap.add_argument("--communities", type=int, default=0,
                    help="community-structured graph (0 = uniform)")
    ap.add_argument("--p_intra", type=float, default=0.95)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: gloo ranks on the CPU (under torchrun "
                         "--nproc_per_node N, the reference's "
                         "--force_cpu_devices N)")
    return ap.parse_args(argv)


def join_world(device: str):
    """Join torchrun's world, or make a world of one; returns the rank's
    device."""
    import torch.distributed as dist
    from ggnn_tpu_torch.parallel.multihost import (initialize_multihost,
                                                   rank_device)
    backend = "gloo" if device == "cpu" else None
    dev = "cpu" if device == "cpu" else None
    if not initialize_multihost(backend=backend, device=dev):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=1, process_id=0, backend=backend,
                             device=dev)
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed world")
    return rank_device(dev)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def shard_layouts(strategy, parts, cfg):
    """The partition's split and stacked kernel layouts, as the reference
    builds them for ``strategy``."""
    from ggnn_tpu_torch.parallel.partition import (build_halo_scatter_layouts,
                                                   build_halo_window_layouts,
                                                   split_local_remote)
    if strategy in ("halo_overlap", "halo_window"):
        split_local_remote(parts)
    if strategy == "halo_onehot":
        return build_halo_scatter_layouts(parts, tile_e=512)
    if strategy == "halo_window":
        return build_halo_window_layouts(
            parts, n_message_types=cfg.n_message_types)
    return None


def timed_run(run, device, group):
    """Seconds of one ``run()`` on this rank, the largest over ``group``."""
    import torch
    import torch.distributed as dist
    from ggnn_tpu_torch.parallel import comm
    dist.barrier(group=group)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        s = run()
        ev[1].record()
        ev[1].synchronize()
        sec = ev[0].elapsed_time(ev[1]) / 1e3
    else:
        t0 = time.perf_counter()
        s = float(run())
        sec = time.perf_counter() - t0
        s = torch.tensor(s)
    if not torch.isfinite(s):
        raise RuntimeError("the propagation's sum is not finite")
    return float(comm.pmax(torch.tensor([sec], dtype=torch.float64,
                                        device=device), group)[0])


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    import torch.distributed as dist
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.parallel import (make_mesh, partition_batch,
                                         sharded_propagate)
    from ggnn_tpu_torch.parallel.partition import local_halo_layout

    device = join_world(args.device)
    world, rank = dist.get_world_size(), dist.get_rank()
    shard_counts = args.shards or [p for p in (1, 2, 4, 8, 16, 32)
                                   if p <= world]
    if max(shard_counts) > world:
        raise ValueError(f"--shards {shard_counts} on a world of {world}")
    batch = synthetic_batch(args.nodes, args.edges, args.types,
                            annotation_dim=8, seed=0,
                            node_mult=128 * max(shard_counts),
                            n_communities=args.communities,
                            p_intra=args.p_intra)
    n_dir = int(batch.edge_mask.sum())
    cfg = ModelConfig(state_dim=args.dim, annotation_dim=8,
                      n_edge_types=args.types, n_steps=args.steps)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    if rank == 0:
        print(f"# {n_dir} directed edges, {batch.spec.n_pad} padded nodes, "
              f"{args.steps} steps a propagation; strategy {args.strategy} "
              f"on a world of {world} ({dist.get_backend()}, {device})",
              file=sys.stderr, flush=True)

    results = {}
    for P in shard_counts:
        mesh = make_mesh(n_graph=P, n_data=1, device=device)
        parts = partition_batch(batch, P)
        lay = shard_layouts(args.strategy, parts, cfg)
        if mesh is not None:
            idx = mesh.axis("graph").index
            lp = parts.local(idx, device)
            llay = None if lay is None else local_halo_layout(lay, idx,
                                                              device)

            def run():
                with torch.inference_mode():
                    h = sharded_propagate(params["prop"], cfg, mesh, lp,
                                          strategy=args.strategy,
                                          halo_layouts=llay)
                    return torch.sum(h)

            timed_run(run, device, mesh.group)
            best = min(timed_run(run, device, mesh.group)
                       for _ in range(args.iters))
            del lp, llay
        dist.barrier()
        if rank == 0:
            eps = n_dir * args.steps / best
            results[P] = {"edges_per_sec": round(eps, 1),
                          "edges_per_sec_per_chip": round(eps / P, 1),
                          "halo_size": parts.halo_size}
            print(f"# P={P}: {eps:.3e} edges/s total, {eps / P:.3e} /chip, "
                  f"H={parts.halo_size}; best {best!r} s of {args.iters}",
                  file=sys.stderr, flush=True)
        del parts, lay

    if rank == 0:
        base = results[shard_counts[0]]["edges_per_sec_per_chip"]
        for P, r in results.items():
            r["efficiency"] = round(r["edges_per_sec_per_chip"] / base, 4)
        if device.type == "cuda":
            print(card_line(), flush=True)
            if world > torch.cuda.device_count():
                print(f"# {world} ranks share {torch.cuda.device_count()} "
                      "card(s) over gloo: the P > 1 figures are a "
                      "functional check, not a scaling number", flush=True)
        print(json.dumps({
            "metric": "scaling_efficiency",
            "value": results[shard_counts[-1]]["efficiency"],
            "unit": "frac_of_1chip_per_chip_throughput",
            "vs_baseline": results[shard_counts[-1]]["efficiency"] / 0.9,
            "strategy": args.strategy,
            "shards": results,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        }), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
