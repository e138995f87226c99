"""Times kernels #11 ``window_block_spmm_mono`` (each form), #8
``onehot_segment_scatter_flat`` and #9 ``onehot_segment_scatter`` and the
paths that run them, for comparing two trees on one NVIDIA GPU (H100).

    python3 scripts/torch_mono_ab.py [--root DIR] [--tag NAME] [--paths]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events:

- the kernels in bf16, best of two runs of 10 launches: #11's dst-local
  form on the scale-free headline's grad layout (the typed pack's legacy
  grad half, g_tile 256, win_stride 16, Y flushed in bf16); its count form
  on the uniform headline's ``layout_for_batch`` grad half (the int8
  stream at win_stride 16, bf16 out); its window count form on the
  community headline's table layout (W 512, block_rows 512, the XW
  spill); #8 on the uniform headline's ``layout_for_batch`` (tile_e 128)
  and on the four chunk layouts of the chunked 1M graph (tile_e 2048,
  their sum); #9 on the uniform headline's layout without a one-hot
  stream; message rows and G uniform in (−1, 1) from seed 19;
- with ``--paths``, the paths as users run them, each request or train
  step on a layout it has not seen (``Predictor.run_batch`` and the
  ``Trainer`` make one per batch): the median device time of 3 forwards
  or 5 train steps after a warm-up, each on a fresh copy of its layout
  (new tensors, made before the timer starts), so that every run pays
  the kernels' per-layout plans and checks once: the legacy request (the
  forward on ``layout_for_batch``) and unfused train step (on
  ``layout_for_batch(with_grad=True)``), the
  scale-free train steps fused and unfused (the typed pack with its grad
  half), window_community_train (bench.py's layout built ``with_grad``:
  on-demand, the XW spill), the chunked 1M forward, the window
  Predictor's request (the forward on its ``window_layout_for_batch`` of
  the community batch, fused) and the
  bf16-table request unfused (#10 and #11's window form per step);
  and #11's launches in the window train step, each replayed on the
  arguments the step gave it (best of two runs of 10) and summed.

The batches are pickled under ``.chip_scratch/ab_cache/`` of the working
directory, so the later runs of one command skip making them.  Prints the
card's nvidia-smi line and one JSON object of the times (ms) and the
kernels' launch counts.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import torch_scalefree_ab as ab  # noqa: E402  (its timers and caches)

NODES, EDGES, EDGE_TYPES, DIM, STEPS, ANN = 262_144, 4_000_000, 8, 128, 5, 8
NODES_1M, EDGES_1M = 1_048_576, 10_000_000
ZIPF = 1.2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_mono_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
    cs = ab.smoke_helpers()
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
    bf = torch.bfloat16
    T2 = 2 * EDGE_TYPES
    out = {}
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = lambda n: (torch.rand(n, DIM, device=dev, generator=gen) * 2
                      - 1).to(bf)

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    def arrays_of(bt):
        arrays = batch_arrays(bt, "cuda")
        target = int(np.random.default_rng(0).integers(0, bt.spec.n_pad))
        arrays["targets"] = {"node": torch.tensor(
            [target], dtype=torch.int32, device=dev)}
        return arrays

    def fresh(lay):
        """A copy of a layout (or a list of them) whose arrays are new
        tensors: what a new batch's layout is to the kernels' caches."""
        if isinstance(lay, list):
            return [fresh(x) for x in lay]
        f = copy.copy(lay)
        f.arrays = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in lay.arrays.items()}
        return f

    def new_layout_ms(fn, lay, runs=3):
        """Median device time of ``runs`` calls fn(a fresh copy of lay),
        after one warm-up; the copy is made before the timer starts."""
        fn(fresh(lay))
        ts = []
        for _ in range(runs):
            f = fresh(lay)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(f)
            ev[1].record()
            torch.cuda.synchronize()
            ts.append(ev[0].elapsed_time(ev[1]))
            del f
        return sorted(ts)[len(ts) // 2]

    def train_ms(name, arrays, lay, **kw):
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for leaf in param_leaves(p):
            leaf.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
        out[name] = new_layout_ms(lambda f: step(p, arrays, f), lay, runs=5)
        del p, step
        torch.cuda.empty_cache()

    def serve_ms(name, arrays, lay, **kw):
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        with torch.inference_mode():
            out[name] = new_layout_ms(
                lambda f: forward(p, cfg, arrays, 1, scatter_layout=f), lay)
        del p
        torch.cuda.empty_cache()

    # --- the uniform headline: #8, #9, #11's count form -----------------------
    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    lay = L.layout_for_batch(bu, with_grad=True, device="cuda")
    a = lay.arrays
    _, tile_e, max_tiles, nb, _, gm, _, _ = lay.meta
    msgs = rows(a["gather_idx"].shape[0])
    out["8_uniform_ms"] = ab.best_ms(lambda: L.onehot_segment_scatter_flat(
        msgs, a["onehot"], a["tile_start"], a["block_of_tile"], nb, tile_e))
    del msgs
    g_blocks, _, g_tile, _, g_align = gm[:5]
    G = rows(a["g_gather_idx"].shape[0])
    stream = (a["g_onehot"], a["g_tile_start"], a["g_block_of_tile"],
              a["g_tile_msg_off"])
    out["11_counts_legacy_grad_ms"] = ab.best_ms(
        lambda: W.window_block_spmm_mono(
            G, *stream, n_blocks=g_blocks, window=g_tile, win_stride=g_align,
            out_dtype=bf))
    del G, stream
    if args.paths:
        arrays = arrays_of(bu)
        train_ms("legacy_train_ms", arrays, lay, backend="onehot",
                 fuse_gru=False)
        del lay
        torch.cuda.empty_cache()
        lay = L.layout_for_batch(bu, with_grad=False, device="cuda")
        serve_ms("legacy_request_ms", arrays, lay, backend="onehot",
                 fuse_gru=False)
        del arrays
    del lay
    torch.cuda.empty_cache()
    lay = L.build_dst_block_layout(
        bu.edge_src, bu.edge_dst, bu.edge_type, bu.edge_mask, bu.spec.n_pad,
        onehot_stream=False, n_message_types=T2, row_order="block").to("cuda")
    a = lay.arrays
    _, tile_e, max_tiles, nb = lay.meta[:4]
    msgs = rows(a["gather_idx"].shape[0])
    out["9_uniform_ms"] = ab.best_ms(lambda: L.onehot_segment_scatter(
        msgs, a["dst_local"], a["tile_start"], nb, max_tiles, tile_e))
    del lay, a, msgs, bu
    torch.cuda.empty_cache()
    print(f"[{args.tag}] uniform {out}", flush=True)

    # --- the scale-free headline: #11's dst-local form --------------------------
    bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, powerlaw_alpha=ZIPF))
    lay = ab.cached("scalefree_typed_grad.pkl", lambda: S.build_typed_dst_layout(
        bs.edge_src, bs.edge_dst, bs.edge_type, bs.edge_mask, bs.spec.n_pad,
        T2, with_grad=True)).to("cuda")
    a = lay.arrays
    g_blocks, _, g_tile, _, g_align, _ = S.grad_meta(lay)
    G = rows(a["g_gather_idx"].shape[0])
    stream = (a["g_dstl"], a["g_tile_start"], a["g_block_of_tile"],
              a["g_tile_msg_off"])
    out["11_dstl_scalefree_ms"] = ab.best_ms(
        lambda: W.window_block_spmm_mono(
            G, *stream, n_blocks=g_blocks, window=g_tile, win_stride=g_align,
            out_dtype=bf, dstl=True))
    del G, stream, a
    if args.paths:
        arrays = arrays_of(bs)
        train_ms("scalefree_train_fused_ms", arrays, lay, backend="onehot",
                 fuse_gru=True)
        train_ms("scalefree_train_unfused_ms", arrays, lay, backend="onehot",
                 fuse_gru=False)
        del arrays
    del lay, bs
    torch.cuda.empty_cache()
    print(f"[{args.tag}] scale-free {out}", flush=True)

    # --- the community headline: #11's window form, the spill -----------------
    bc = ab.cached("community.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, n_communities=512, p_intra=0.95))

    def window_layout(**kw):
        return W.build_window_layout(
            bc.edge_src, bc.edge_dst, bc.edge_type, bc.edge_mask,
            bc.spec.n_pad, window=512, n_message_types=T2, block_rows=512,
            typed_spill=True, row_major="block", **kw).to("cuda")

    lay = window_layout(on_demand=False)
    params = init_params(cfg_of(backend="window"),
                         torch.Generator().manual_seed(0), "cuda")
    w, b, _ = cs.window_weights(params, bf)
    h = (torch.rand(NODES, DIM, device=dev, generator=gen) * 2 - 1).to(bf)
    table = TB.node_table(h, w, b, "block")
    a = lay.arrays
    stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
              a["win_of_tile"])
    out["11_window_table_ms"] = ab.best_ms(lambda: W.window_block_spmm_mono(
        table, *stream, n_blocks=lay.n_blocks, window=512, out_rows=512,
        c_off=a["c_off"]))
    del table, stream, a, h, params
    arrays = arrays_of(bc)
    if args.paths:
        serve_ms("serve_window_table_unfused_ms", arrays, lay,
                 backend="window", fuse_gru=False)
    del lay
    torch.cuda.empty_cache()
    if args.paths:
        lay = window_layout(on_demand=True, with_grad=True)
        train_ms("train_window_ms", arrays, lay, backend="window",
                 fuse_gru=True)
        # #11 in one more window train step: each launch replayed on the
        # arguments the step gave it
        mono, calls = W.window_block_spmm_mono, []

        def shim(*a, **kw):
            calls.append((a, kw))
            return mono(*a, **kw)

        cfg = cfg_of(backend="window", fuse_gru=True)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for leaf in param_leaves(p):
            leaf.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
        step(p, arrays, lay)
        shim.launches = mono.launches
        W.window_block_spmm_mono = shim
        try:
            step(p, arrays, lay)
            torch.cuda.synchronize()
        finally:
            W.window_block_spmm_mono = mono
            mono.launches = shim.launches
        times = [ab.best_ms(lambda a=a, kw=kw: mono(*a, **kw))
                 for a, kw in calls]
        out["train_window_launches_11_per_step"] = len(calls)
        out["train_window_11_ms_per_step"] = sum(times)
        out["train_window_11_ms"] = [round(t, 4) for t in times]
        del lay, p, step, calls
        torch.cuda.empty_cache()
        # the window Predictor's request: its own static-budget layout
        lay = W.window_layout_for_batch(bc).to("cuda")
        serve_ms("serve_window_predictor_ms", arrays, lay, backend="window",
                 fuse_gru=True)
        del lay
        torch.cuda.empty_cache()
    del arrays, bc
    torch.cuda.empty_cache()
    print(f"[{args.tag}] community {out}", flush=True)

    # --- the chunked 1M graph: #8 at tile_e 2048 --------------------------------
    b1 = ab.cached("uniform_1m.pkl", lambda: synthetic_batch(
        NODES_1M, EDGES_1M, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    chunks = L.build_chunked_dst_layouts(b1.edge_src, b1.edge_dst,
                                         b1.edge_type, b1.edge_mask,
                                         b1.spec.n_pad, n_chunks=4,
                                         tile_e=2048, device="cuda")
    total = 0.0
    for c in chunks:
        a = c.arrays
        msgs = rows(a["gather_idx"].shape[0])
        total += ab.best_ms(lambda a=a, m=msgs: L.onehot_segment_scatter_flat(
            m, a["onehot"], a["tile_start"], a["block_of_tile"], c.meta[3],
            2048))
        del msgs
    out["8_chunked_1m_4_chunks_ms"] = total
    if args.paths:
        cfg = cfg_of(backend="onehot")
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        ann = torch.as_tensor(b1.annotations, device=dev)
        edges = [torch.as_tensor(x) for x in (b1.edge_src, b1.edge_dst,
                                              b1.edge_type, b1.edge_mask)]
        with torch.inference_mode():
            out["chunked_1m_forward_ms"] = new_layout_ms(
                lambda f: propagate(p["prop"], cfg, ann, *edges,
                                    scatter_layout=f), chunks)
        del p, ann, edges
    del chunks, b1
    torch.cuda.empty_cache()
    out["launches_11"] = W.window_block_spmm_mono.launches
    out["launches_8"] = L.onehot_segment_scatter_flat.launches
    out["launches_9"] = L.onehot_segment_scatter.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
