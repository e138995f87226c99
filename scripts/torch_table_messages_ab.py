"""Times kernels #10 and #16 and the paths that run them, for comparing two
trees on one NVIDIA GPU (H100).

    python3 scripts/torch_table_messages_ab.py [--root DIR] [--tag NAME]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events:

- #16 ``packed_messages`` at the uniform headline's packed layout (262,144
  nodes, 8M directed edges: 62,516 tiles of 128), and #10
  ``node_table_block_major`` at the uniform headline (N = 262,144, T2 = 16)
  and at the window 1M graph's rows (N = 1,000,192): best of two runs of
  10 launches;
- ``[pallas serve]``: the device forward of the uniform headline batch with
  ``backend='pallas'``, ungated: median of 3 after a warm-up;
- ``[pallas train]``: 4 ``make_train_step`` steps, ungated and gated: the
  median of the last 3;
- ``[legacy serve]``: the forward with ``backend='onehot'`` on
  ``layout_for_batch`` (the Predictor's layout): median of 3;
- ``[window 1m]``: ``propagate(backend='window')`` on bench.py's
  window_community_1m layout (chip_smoke's ``[window 1m]``): median of 3.
  The two batches are pickled under ``.chip_scratch/`` of the working
  directory, so the later runs of one command skip making them.

Prints the card's nvidia-smi line and one JSON object of the times (ms)
and the two kernels' launch counts over the whole run.
"""

import argparse
import json
import os
import pickle
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, EDGES, EDGE_TYPES, DIM, STEPS, ANN = 262_144, 4_000_000, 8, 128, 5, 8
NODES_W1M, EDGES_W1M, COMMUNITIES_W1M = 1_000_000, 10_000_000, 4096


def events_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters


def median_ms(fn, runs=3):
    """Median device time of ``runs`` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(out)


def cached(name, make):
    path = os.path.join(".chip_scratch", "ab_cache", name)
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    obj = make()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return obj


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_table_messages_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.tag}] ggnn_tpu_torch from "
          f"{os.path.dirname(ggnn_tpu_torch.__file__)}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    out = {}

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    # the two kernels at their headline shapes
    b = cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    T2 = 2 * EDGE_TYPES
    gen = torch.Generator(device=dev).manual_seed(19)
    cols = [torch.as_tensor(x, device=dev) for x in (
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.type_offsets)]
    lay = SP.pack_type_tiles(*cols, T2)
    h = (torch.rand(b.spec.n_pad, DIM, device=dev, generator=gen) * 2
         - 1).to(torch.bfloat16)
    w = (torch.randn(T2, DIM, DIM, device=dev, generator=gen)
         * DIM ** -0.5).to(torch.bfloat16)
    bb = (torch.randn(T2, DIM, device=dev, generator=gen) * 0.1).to(
        torch.bfloat16)
    args16 = (lay["src"], lay["mask"], lay["tile_type"], w, bb)
    out["packed_messages_ms"] = min(
        events_ms(lambda: SP.packed_messages(h, *args16), 10)
        for _ in range(2))
    out["node_table_ms"] = min(
        events_ms(lambda: TB.node_table_block_major(h, w, bb), 10)
        for _ in range(2))
    del lay, cols
    h1 = (torch.rand(1_000_192, DIM, device=dev, generator=gen) * 2
          - 1).to(torch.bfloat16)
    out["node_table_w1m_ms"] = min(
        events_ms(lambda: TB.node_table_block_major(h1, w, bb), 10)
        for _ in range(2))
    del h, h1
    torch.cuda.empty_cache()
    print(f"[{args.tag}] kernels {out}", flush=True)

    # [pallas serve], [pallas train]
    arrays = batch_arrays(b, "cuda")
    target = int(np.random.default_rng(0).integers(0, NODES))
    arrays["targets"] = {"node": torch.tensor([target], dtype=torch.int32,
                                              device=dev)}
    cfg = cfg_of(backend="pallas")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    with torch.inference_mode():
        out["pallas_forward_ms"] = median_ms(
            lambda: forward(params, cfg, arrays, 1))
    for name, gated in (("pallas_train_ms", False),
                        ("pallas_train_gated_ms", True)):
        cfg = cfg_of(backend="pallas", edge_gates=gated)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for p in param_leaves(params):
            p.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(params, 1e-3))
        out[name] = median_ms(lambda: step(params, arrays, None))
        del params, step
        torch.cuda.empty_cache()
    print(f"[{args.tag}] pallas {out}", flush=True)

    # [legacy serve]
    cfg = cfg_of(backend="onehot")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    lay = L.layout_for_batch(b, with_grad=False, device="cuda")
    with torch.inference_mode():
        out["legacy_forward_ms"] = median_ms(
            lambda: forward(params, cfg, arrays, 1, scatter_layout=lay))
    del lay, arrays, b
    torch.cuda.empty_cache()

    # [window 1m]
    t0 = time.perf_counter()
    bw = cached("w1m.pkl", lambda: synthetic_batch(
        NODES_W1M, EDGES_W1M, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=256, n_communities=COMMUNITIES_W1M, p_intra=0.95))
    lw = W.build_window_layout(
        bw.edge_src, bw.edge_dst, bw.edge_type, bw.edge_mask, bw.spec.n_pad,
        window=512, n_message_types=T2, block_rows=256, pack_counts=False,
        typed_spill=False, on_demand=False, row_major="block",
        with_grad=False, grad_quant=False).to("cuda")
    print(f"[{args.tag}] window 1m batch and layout in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = cfg_of(backend="window", fuse_gru=True)
    prop = params["prop"]
    ann = torch.as_tensor(bw.annotations, device=dev)
    edges = [torch.as_tensor(x) for x in (bw.edge_src, bw.edge_dst,
                                          bw.edge_type, bw.edge_mask)]
    with torch.inference_mode():
        out["window_1m_forward_ms"] = median_ms(
            lambda: propagate(prop, cfg, ann, *edges, scatter_layout=lw))
    out["launches_16"] = SP.packed_messages.launches
    out["launches_10"] = TB.node_table_block_major.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
