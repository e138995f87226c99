"""Times kernels #12 and #6 and the paths that run them, with the kernels
that share their code, for comparing two trees on one NVIDIA GPU (H100).

    python3 scripts/torch_scalefree_ab.py [--root DIR] [--tag NAME]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events; kernels
through their wrappers on random inputs from seed 19, best of two runs of
10 launches; requests the median device time of 3 forwards after a
warm-up:

- the community headline (262,144 nodes in 512 communities of 512, 8M
  directed edges) on bench.py's window layouts (W 512, block_rows 512, the
  XW spill): #12 ``window_block_spmm_ondemand`` and #13 ``window_step_gru``
  on-demand (window_community), #13 ``emit_res`` and #14
  ``window_bwd_fused`` exact and int8 ā on the layout built ``with_grad``
  (window_community_train), #13 over the q8 table and the bf16 table, with
  and without ``emit_res`` (window_community_q8's layout); the unfused
  on-demand request (#12, the spill's #11, #3 per step);
- the scale-free headline (the same size, Zipf-1.2 endpoints, nodes
  numbered by degree rank) on bench.py's scalefree_fwd_window layout (W
  512, block_rows 128, on-demand, the XW spill): #12 and the unfused
  on-demand request; the layout's tile counts (the largest block's); on
  its typed pack (bench.py's scalefree_fwd_onehot: block mode declines):
  #6 ``typed_step_gru``, #7 ``typed_onehot_scatter`` and the fused request;
- the uniform headline's typed pack built ``with_grad`` (block mode, the
  octet grad layout): #1 ``typed_block_scatter``, #2
  ``typed_block_step_gru``, #5 ``typed_grad_octet_scatter``.

The batches are pickled under ``.chip_scratch/ab_cache/`` of the working
directory, so the later runs of one command skip making them.  Prints the
card's nvidia-smi line and one JSON object of the times (ms), the layout
figures and the two kernels' launch counts over the whole run.
"""

import argparse
import importlib.util
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
ZIPF = 1.2


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


def smoke_helpers():
    """This checkout's chip_smoke.py (its kernel_inputs), loaded by path so
    that the tree under ``--root`` supplies only ``ggnn_tpu_torch``."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_scalefree_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.train.loop import batch_arrays
    cs = smoke_helpers()
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
    out, figs = {}, {}

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    params = init_params(cfg_of(), torch.Generator().manual_seed(0), "cuda")

    def wlayout(bt, block_rows=512, on_demand=True, **kw):
        return W.build_window_layout(
            bt.edge_src, bt.edge_dst, bt.edge_type, bt.edge_mask,
            bt.spec.n_pad, window=512, n_message_types=T2,
            block_rows=block_rows, typed_spill=True, on_demand=on_demand,
            row_major="block", **kw).to("cuda")

    def rnd_weights(gen):
        def rnd(*shape, scale=DIM ** -0.5):
            return torch.randn(*shape, device=dev, generator=gen) * scale
        return (rnd(T2, DIM, DIM).to(torch.bfloat16),
                rnd(T2, DIM, scale=0.1).to(torch.bfloat16),
                (rnd(DIM, 3 * DIM).to(torch.bfloat16),
                 rnd(1, 3 * DIM, scale=0.1),
                 rnd(DIM, 2 * DIM).to(torch.bfloat16),
                 rnd(DIM, DIM).to(torch.bfloat16)))

    def window_inputs(lay):
        gen = torch.Generator(device=dev).manual_seed(19)
        a = lay.arrays
        n_rows = lay.n_blocks * lay.block_rows
        w, bb, gw = rnd_weights(gen)
        h = torch.rand(n_rows, DIM, device=dev, generator=gen) * 2 - 1
        init = torch.randn(n_rows, DIM, device=dev, generator=gen) * 0.3
        stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
                  a["win_of_tile"])
        sk = dict(n_blocks=lay.n_blocks, window=lay.window,
                  out_rows=lay.block_rows, packed=False, c_off=a["c_off"])
        return (h[:lay.n_nodes_pad].to(torch.bfloat16), w, bb, stream,
                init, h, gw, sk)

    def time_12(name, lay):
        hc, w, bb, stream, _, _, _, sk = window_inputs(lay)
        out[name] = best_ms(lambda: W.window_block_spmm_ondemand(
            hc, w, bb, *stream, sk["c_off"], sk["n_blocks"], sk["window"],
            sk["out_rows"]))

    def time_13(name, lay, source, **extra):
        hc, w, bb, stream, init, h, gw, sk = window_inputs(lay)
        if source == "ondemand":
            tab, kw = hc, dict(msg_w=w, msg_b=bb)
        elif source == "q8":
            from ggnn_tpu_torch.ops import table as TB
            tab, sc = TB.node_table_block_major_q8(hc, w, bb, lay.window)
            kw = dict(scales=sc[:, 0])
        else:
            from ggnn_tpu_torch.ops import table as TB
            tab, kw = TB.node_table(hc, w, bb, "block"), {}
        out[name] = best_ms(lambda: W.window_step_gru(
            tab, *stream, init, h, *gw, **sk, **kw, **extra))

    def time_14(name, lay, quant):
        gen = torch.Generator(device=dev).manual_seed(41)
        a = lay.arrays
        da = torch.randn(lay.n_blocks * lay.block_rows, DIM, device=dev,
                         generator=gen)
        h = (torch.rand(lay.n_nodes_pad, DIM, device=dev, generator=gen)
             * 2 - 1).to(torch.bfloat16)
        w = (torch.randn(T2, DIM, DIM, device=dev, generator=gen)
             * DIM ** -0.5).to(torch.bfloat16)
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

    def request_ms(name, batch, layout, **kw):
        arrays = batch_arrays(batch, "cuda")
        cfg = cfg_of(**kw)
        with torch.inference_mode():
            out[name] = median_ms(
                lambda: forward(params, cfg, arrays, 1,
                                scatter_layout=layout))
        del arrays

    def tile_figures(prefix, lay):
        a = lay.arrays
        ts = a["tile_start"]
        real = (a["win_of_tile"] >= 0).long()
        per = torch.zeros(lay.n_blocks, dtype=torch.long, device=dev)
        blk = torch.repeat_interleave(
            torch.arange(lay.n_blocks, device=dev), (ts[1:] - ts[:-1]).long(),
            output_size=int(ts[-1].item()))
        per.index_add_(0, blk, real[:blk.shape[0]])
        big = int(per.argmax().item())
        figs[prefix] = dict(
            n_blocks=lay.n_blocks, real_tiles=int(per.sum().item()),
            largest_block=big, largest_block_tiles=int(per[big].item()),
            blocks_over_32=int((per > 32).sum().item()),
            blocks_empty=int((per == 0).sum().item()),
            stats=str(lay.stats))
        print(f"[{args.tag}] {prefix} tiles {figs[prefix]}", flush=True)

    # --- the community headline -----------------------------------------
    b = cached("community.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, n_communities=512, p_intra=0.95))
    lay = wlayout(b)
    tile_figures("community_ondemand", lay)
    time_12("12_community_ms", lay)
    time_13("13_ondemand_ms", lay, "ondemand")
    request_ms("request_community_unfused_ms", b, lay, backend="window",
               fuse_gru=False)
    del lay
    lay = wlayout(b, with_grad=True)
    time_13("13_ondemand_res_ms", lay, "ondemand", emit_res=True)
    time_14("14_exact_ms", lay, False)
    time_14("14_int8_ms", lay, True)
    del lay
    lay = wlayout(b, on_demand=False)
    time_13("13_q8_ms", lay, "q8")
    time_13("13_table_ms", lay, "table")
    time_13("13_table_res_ms", lay, "table", emit_res=True)
    del lay, b
    torch.cuda.empty_cache()
    print(f"[{args.tag}] community {out}", flush=True)

    # --- the scale-free headline ------------------------------------------
    bs = cached("scalefree.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, powerlaw_alpha=ZIPF))
    t0 = time.perf_counter()
    lay = wlayout(bs, block_rows=128)
    figs["scalefree_window_layout_s"] = time.perf_counter() - t0
    tile_figures("scalefree_ondemand", lay)
    time_12("12_scalefree_ms", lay)
    request_ms("request_scalefree_window_unfused_ms", bs, lay,
               backend="window", fuse_gru=False)
    del lay
    torch.cuda.empty_cache()
    lay = S.build_typed_dst_layout(bs.edge_src, bs.edge_dst, bs.edge_type,
                                   bs.edge_mask, bs.spec.n_pad, T2,
                                   with_grad=False).to("cuda")
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **x["kw"])
    fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
              b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
    out["7_scalefree_ms"] = best_ms(lambda: S.typed_onehot_scatter(**sa))
    out["6_scalefree_ms"] = best_ms(lambda: S.typed_step_gru(**fa))
    del x, sa, fa
    request_ms("request_scalefree_onehot_fused_ms", bs, lay,
               backend="onehot", fuse_gru=True)
    del lay, bs
    torch.cuda.empty_cache()
    print(f"[{args.tag}] scale-free {out}", flush=True)

    # --- the uniform headline's block-mode kernels --------------------------
    bu = cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    lay = S.build_typed_dst_layout(bu.edge_src, bu.edge_dst, bu.edge_type,
                                   bu.edge_mask, bu.spec.n_pad, T2,
                                   with_grad=True).to("cuda")
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    sa = (x["h_pack"], *x["arrs"], x["msg_w"])
    fa = (*sa, x["init"], x["hstate"], x["wa"], x["b3"], x["uzr"], x["uh"])
    out["1_ms"] = best_ms(lambda: S.typed_block_scatter(*sa, **x["kw"]))
    out["2_ms"] = best_ms(lambda: S.typed_block_step_gru(*fa, **x["kw"]))
    del x, sa, fa
    _, _, g_tile, C, R8, span8, n_oct = S.grad_meta(lay)
    arrs = lay.arrays
    octs = (arrs["g_dstl_oct"], arrs["g_slot_off16"], arrs["g_oblk16"])
    gen = torch.Generator(device=dev).manual_seed(2)
    Gp = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                     generator=gen).to(torch.bfloat16)
    out["5_ms"] = best_ms(lambda: S.typed_grad_octet_scatter(
        Gp, *octs, n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8,
        out_dtype=torch.bfloat16))
    del lay, bu, Gp, octs, arrs
    torch.cuda.empty_cache()
    out["launches_12"] = W.window_block_spmm_ondemand.launches
    out["launches_6"] = S.typed_step_gru.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out,
                      "layouts": figs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
