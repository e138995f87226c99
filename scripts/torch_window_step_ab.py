"""Times kernels #13 and #14 and the paths that run them, for comparing two
trees on one NVIDIA GPU (H100).

    python3 scripts/torch_window_step_ab.py [--root DIR] [--tag NAME]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0) on the community headline (262,144
nodes in 512 communities of 512, 8M directed edges, 95 % inside their
community) and on bench.py's window_community_1m graph, measured with
CUDA events:

- #13 ``window_step_gru`` (random state, init and weights from seed 19):
  on-demand windows on window_community's layout (W 512, block_rows 512,
  the XW spill), its ``emit_res`` form on window_community_train's layout
  (built ``with_grad``), the q8 table and the bf16 table on
  window_community_q8's layout (with #10 ``node_table_block_major``, the
  table's on-chip alternative to on-demand windows), the bf16 table on
  window_community_1m's layout (W 512, block_rows 256, the
  legacy spill) and on-demand at D = 256 (the sums and the wide GRU
  cell); #12 ``window_block_spmm_ondemand`` and #11's window form
  (``window_block_spmm_mono`` over the q8 layout's int8 counts) as the
  unchanged bodies; #14 ``window_bwd_fused`` on the train layout, exact
  and int8 ā at D = 128, exact at D = 256: best of two runs of 10
  launches;
- ``[window serve]``: the device forward (``propagate``, fused) of
  window_community and window_community_q8: median of 3 after a warm-up;
- ``[window train]``: 4 ``make_train_step`` steps of
  window_community_train and window_community_train_q8g: the median of
  the last 3;
- ``[window 1m]``: ``propagate(backend='window')`` on window_community_1m:
  median of 3.

The batches are pickled under ``.chip_scratch/ab_cache/`` of the working
directory, so the later runs of one command skip making them.  Prints the
card's nvidia-smi line and one JSON object of the times (ms) and the two
kernels' launch counts over the whole run.
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


def best_ms(fn, iters=10):
    return min(events_ms(fn, iters) for _ in range(2))


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
        print("torch_window_step_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
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
    T2 = 2 * EDGE_TYPES
    out = {}

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    def layout(bt, block_rows=512, on_demand=True, typed_spill=True,
               **kw):
        return W.build_window_layout(
            bt.edge_src, bt.edge_dst, bt.edge_type, bt.edge_mask,
            bt.spec.n_pad, window=512, n_message_types=T2,
            block_rows=block_rows, typed_spill=typed_spill,
            on_demand=on_demand, row_major="block", **kw).to("cuda")

    def weights(D, gen):
        def rnd(*shape, scale=D ** -0.5):
            return torch.randn(*shape, device=dev, generator=gen) * scale
        return (rnd(T2, D, D).to(torch.bfloat16),
                rnd(T2, D, scale=0.1).to(torch.bfloat16),
                (rnd(D, 3 * D).to(torch.bfloat16), rnd(1, 3 * D, scale=0.1),
                 rnd(D, 2 * D).to(torch.bfloat16),
                 rnd(D, D).to(torch.bfloat16)))

    def step_args(lay, D, gen):
        """#13's arguments on a layout: (h source in bf16, w, b, the
        stream, init, h f32, the GRU weights, the keywords)."""
        a = lay.arrays
        n_rows = lay.n_blocks * lay.block_rows
        w, bb, gw = weights(D, gen)
        h = torch.rand(n_rows, D, device=dev, generator=gen) * 2 - 1
        init = torch.randn(n_rows, D, device=dev, generator=gen) * 0.3
        stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
                  a["win_of_tile"])
        sk = dict(n_blocks=lay.n_blocks, window=lay.window,
                  out_rows=lay.block_rows, packed=False, c_off=a["c_off"])
        return (h[:lay.n_nodes_pad].to(torch.bfloat16), w, bb, stream, init,
                h, gw, sk)

    def time_step(name, lay, D, source, **extra):
        gen = torch.Generator(device=dev).manual_seed(19)
        hc, w, bb, stream, init, h, gw, sk = step_args(lay, D, gen)
        if source == "ondemand":
            tab, kw = hc, dict(msg_w=w, msg_b=bb)
        elif source == "q8":
            tab, sc = TB.node_table_block_major_q8(hc, w, bb, lay.window)
            kw = dict(scales=sc[:, 0])
        else:
            tab, kw = TB.node_table(hc, w, bb, "block"), {}
        out[name] = best_ms(lambda: W.window_step_gru(
            tab, *stream, init, h, *gw, **sk, **kw, **extra))
        return tab, stream, sk

    def time_bwd(name, lay, D, quant):
        gen = torch.Generator(device=dev).manual_seed(41)
        a = lay.arrays
        n_rows = lay.n_blocks * lay.block_rows
        da = torch.randn(n_rows, D, device=dev, generator=gen)
        h = (torch.rand(lay.n_nodes_pad, D, device=dev, generator=gen) * 2
             - 1).to(torch.bfloat16)
        w = (torch.randn(T2, D, D, device=dev, generator=gen)
             * D ** -0.5).to(torch.bfloat16)
        gt = (a["c_stream"], a["gt_tile_start"], a["gt_block_of_tile"],
              a["gt_win_of_tile"], a["gt_c_off"])
        kw = dict(n_wins=lay.grad_meta[0], window=lay.block_rows,
                  out_rows=lay.window, t2=T2)
        if quant:
            q, sc = W.quantize_grad_pow2(da, lay.block_rows)
            da_t, kw["da_scales"] = q.t().contiguous(), sc
        else:
            da_t = da.to(torch.bfloat16).t().contiguous()
        out[name] = best_ms(lambda: W.window_bwd_fused(da_t, *gt, w, h,
                                                       **kw))

    # the kernels on the community headline's layouts
    b = cached("community.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, n_communities=512, p_intra=0.95))
    lay = layout(b)
    hc, stream, sk = time_step("13_ondemand_ms", lay, DIM, "ondemand")
    gen = torch.Generator(device=dev).manual_seed(19)
    w, bb, _ = weights(DIM, gen)
    out["12_ondemand_ms"] = best_ms(lambda: W.window_block_spmm_ondemand(
        hc, w, bb, *stream, sk["c_off"], sk["n_blocks"], sk["window"],
        sk["out_rows"]))
    time_step("13_ondemand_d256_ms", lay, 2 * DIM, "ondemand")
    del lay
    lay = layout(b, on_demand=False)
    tab, stream, sk = time_step("13_q8_ms", lay, DIM, "q8")
    time_step("13_table_ms", lay, DIM, "table")
    out["10_table_ms"] = best_ms(lambda: TB.node_table_block_major(hc, w,
                                                                   bb))
    table = TB.node_table(hc, w, bb, "block")
    out["11_window_form_ms"] = best_ms(lambda: W.window_block_spmm_mono(
        table, *stream, **sk))
    del lay, tab, table
    lay = layout(b, with_grad=True)
    time_step("13_emit_res_ms", lay, DIM, "ondemand", emit_res=True)
    time_bwd("14_exact_ms", lay, DIM, False)
    time_bwd("14_int8_ms", lay, DIM, True)
    time_bwd("14_exact_d256_ms", lay, 2 * DIM, False)
    del lay
    torch.cuda.empty_cache()
    print(f"[{args.tag}] kernels {out}", flush=True)

    # [window serve], [window train]
    arrays = batch_arrays(b, "cuda")
    target = int(np.random.default_rng(0).integers(0, NODES))
    arrays["targets"] = {"node": torch.tensor([target], dtype=torch.int32,
                                              device=dev)}
    for name, q8 in (("serve_community_ms", False),
                     ("serve_community_q8_ms", True)):
        lay = layout(b, on_demand=not q8)
        cfg = cfg_of(backend="window", fuse_gru=True, quantized_table=q8)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        with torch.inference_mode():
            out[name] = median_ms(
                lambda: forward(params, cfg, arrays, 1, scatter_layout=lay))
        del lay, params
        torch.cuda.empty_cache()
    for name, gq in (("train_community_ms", False),
                     ("train_community_q8g_ms", True)):
        lay = layout(b, with_grad=True, grad_quant=gq)
        cfg = cfg_of(backend="window", fuse_gru=True)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for p in param_leaves(params):
            p.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(params, 1e-3))
        out[name] = median_ms(lambda: step(params, arrays, lay))
        del lay, params, step
        torch.cuda.empty_cache()
    del arrays, b
    torch.cuda.empty_cache()
    print(f"[{args.tag}] window {out}", flush=True)

    # [window 1m]: the table source at 1M rows, then the forward
    t0 = time.perf_counter()
    bw = cached("w1m.pkl", lambda: synthetic_batch(
        NODES_W1M, EDGES_W1M, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=256, n_communities=COMMUNITIES_W1M, p_intra=0.95))
    lw = layout(bw, block_rows=256, on_demand=False, typed_spill=False)
    print(f"[{args.tag}] window 1m batch and layout in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    time_step("13_table_w1m_ms", lw, DIM, "table")
    torch.cuda.empty_cache()
    cfg = cfg_of(backend="window", fuse_gru=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    prop = params["prop"]
    ann = torch.as_tensor(bw.annotations, device=dev)
    edges = [torch.as_tensor(x) for x in (bw.edge_src, bw.edge_dst,
                                          bw.edge_type, bw.edge_mask)]
    with torch.inference_mode():
        out["window_1m_forward_ms"] = median_ms(
            lambda: propagate(prop, cfg, ann, *edges, scatter_layout=lw))
    out["launches_13"] = (W.window_step_gru.launches
                          + W.window_step_gru.res_launches)
    out["launches_14"] = W.window_bwd_fused.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
