#!/usr/bin/env python
"""Large-graph propagation with the production (one-hot scatter) backend
(the port of ``examples/large_graph.py``).

Demonstrates the scaling surface a reference user graduates to: a
quarter-million-node synthetic graph, the host-built scatter layout (built
once: topology only), bf16 compute with f32 accumulation, and optional
dst-range chunking when the graph pushes device memory.

Three forms:

- default: one legacy layout (``build_dst_block_layout``, tile_e 2048);
- ``--chunks N``: N dst ranges (``build_chunked_dst_layouts``), one range's
  messages alive at a time;
- ``--communities C``: a community-structured graph through the windowed
  block-CSR backend (``build_window_layout``, block_rows
  ``min(512, nodes // C)``).

Run: python examples/torch_large_graph.py [--nodes 262144] [--edges 4000000]
     [--chunks N | --communities C] [--device cuda|cpu]
     (on the CPU the kernels' plain versions run: use tiny sizes there)

The forward runs on the card by default; without one that raises.  Times
come from CUDA events on the card (the host clock on the CPU).
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


@dataclasses.dataclass
class LargeGraph:
    """What :func:`prepare` built: the model, its weights, the batch's
    tensors on the device and the layout (all topology-static)."""

    cfg: object
    prop: dict
    ops: tuple            # annotations, edge_src, edge_dst, edge_type, mask
    layout: object
    n_dir: int            # real directed edges
    build_s: float        # the layout's host build (and copy) seconds


def prepare(nodes=262_144, edges=4_000_000, types=8, dim=128, steps=5,
            chunks=1, communities=0, device="cuda", params=None, log=print):
    """The graph (seed 0), the model (bf16 compute; ``params``, a numpy
    tree, replaces the weights drawn from seed 0) and the layout of the
    chosen form, on ``device``."""
    import torch

    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models import (ModelConfig, init_params,
                                       params_from_numpy)
    from ggnn_tpu_torch.models.init import device_or_raise
    from ggnn_tpu_torch.ops.legacy import (build_chunked_dst_layouts,
                                           build_dst_block_layout)
    from ggnn_tpu_torch.ops.window import build_window_layout

    device = device_or_raise(device)
    log(f"building graph: {nodes} nodes, {edges} edges ...")
    batch = synthetic_batch(nodes, edges, types, annotation_dim=8, seed=0,
                            node_mult=128, n_communities=communities)
    backend = "window" if communities else "onehot"
    cfg = ModelConfig(state_dim=dim, annotation_dim=8, n_edge_types=types,
                      n_steps=steps, backend=backend,
                      compute_dtype="bfloat16")
    params = (init_params(cfg, torch.Generator().manual_seed(0), device)
              if params is None else params_from_numpy(params, device))

    t0 = time.perf_counter()
    host = (batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
            batch.spec.n_pad)
    if communities:
        layout = build_window_layout(
            *host, n_message_types=2 * types,
            block_rows=min(512, nodes // communities)).to(device)
        log(f"window layout: {layout.stats}")
    elif chunks > 1:
        layout = build_chunked_dst_layouts(*host, n_chunks=chunks,
                                           tile_e=2048, device=device)
    else:
        layout = build_dst_block_layout(*host, tile_e=2048).to(device)
    build_s = time.perf_counter() - t0
    log(f"scatter layout built in {build_s:.1f}s (topology-static — reused "
        "across steps and training iterations)")
    ops = tuple(torch.as_tensor(x, device=device) for x in (
        batch.annotations, batch.edge_src, batch.edge_dst, batch.edge_type,
        batch.edge_mask))
    return LargeGraph(cfg=cfg, prop=params["prop"], ops=ops, layout=layout,
                      n_dir=int(batch.edge_mask.sum()), build_s=build_s)


def forward(g: LargeGraph, n_steps=None):
    """The T-step propagation (``n_steps`` of them when given) → h
    [N, D] f32, served (no autograd graph)."""
    import torch

    from ggnn_tpu_torch.models.ggnn import propagate
    cfg = g.cfg if n_steps is None else dataclasses.replace(
        g.cfg, n_steps=n_steps)
    with torch.no_grad():
        return propagate(g.prop, cfg, *g.ops, scatter_layout=g.layout)


def _clock(device):
    """(start, seconds since start): CUDA events on the card."""
    import torch
    if device.type != "cuda":
        t0 = time.perf_counter()
        return lambda: time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()

    def stop():
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return stop


def measure(g: LargeGraph, log=print):
    """The first run (kernel build and per-layout plans included) and one
    steady run.  Returns the numbers it prints and the final h."""
    device = g.ops[0].device
    stop = _clock(device)
    h = forward(g)
    checksum = float(h.sum())
    first_s = stop()
    log(f"compile+first run: {first_s:.1f}s  (checksum {checksum:.4g})")
    stop = _clock(device)
    h = forward(g)
    float(h.sum())
    dt = stop()
    rate = g.n_dir * g.cfg.n_steps / dt
    log(f"steady state: {dt * 1e3:.1f} ms for {g.cfg.n_steps} steps over "
        f"{g.n_dir} directed edges = {rate:.3g} edges/s")
    return {"build_s": g.build_s, "first_s": first_s, "checksum": checksum,
            "steady_ms": dt * 1e3, "edges_per_s": rate, "n_dir": g.n_dir,
            "h": h}


def run(log=print, **kw):
    """:func:`prepare` then :func:`measure` (``kw``: prepare's)."""
    return measure(prepare(log=log, **kw), log)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=262_144)
    ap.add_argument("--edges", type=int, default=4_000_000)
    ap.add_argument("--types", type=int, default=8)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--chunks", type=int, default=1)
    ap.add_argument("--communities", type=int, default=0,
                    help="community-structured graph: switches to the "
                         "windowed block-CSR backend (the clustered-graph "
                         "fast path)")
    ap.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"],
                    help="where to run (default cuda; without a card it "
                         "raises)")
    args = ap.parse_args(argv)
    run(**vars(args))


if __name__ == "__main__":
    main()
