#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ggnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from ``ggnn_tpu_torch/ops/csrc``.
2. Holds each kernel (``typed_block_scatter``, ``typed_block_step_gru``,
   ``gru_cell_fwd``) against its plain PyTorch version on the card, at the
   headline shapes (262,144 nodes, 4M logical / 8M directed edges, 8 edge
   types, D = 128) in bf16 and f32 and on three small fuzz layouts (one
   with empty dst blocks, one with cmax >= 2), and times kernel and plain
   version at the headline in bf16 with CUDA events.
3. Serves: a ``Predictor`` for the headline model (node_select head,
   onehot backend, bf16, T = 5 steps, random weights from seed 0) answers
   three requests of one 262,144-node graph each (seeds 0, 1, 2), fused
   and unfused.  It checks the kernels' launch counts on that path and
   holds every request's node scores against the port's plain path on the
   card.

Any failed check raises, so the exit code is non-zero.  The last three
lines are the kernels JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

NODES, EDGES, EDGE_TYPES, DIM, STEPS, ANN = 262_144, 4_000_000, 8, 128, 5, 8
BF16_ULP = 2.0 ** -7   # one bf16 ulp at 1.0

# Tolerances, checked against |kernel − plain| on the same inputs:
# - scatter: the same bf16-rounded one-hot sums, f32 W_t products summed in
#   another order → max ≤ 2e-5·max(1, max|plain|);
# - GRU cell: the same rounded matmul inputs, f32 sums in another order;
#   outputs stored in bf16 may round to the neighbouring value → max ≤ one
#   bf16 ulp at 1.0 (f32: 1e-4);
# - fused step and served scores (bf16): a, the aggregation, is rounded to
#   bf16 before the gate matmuls, and a last-bit difference in f32 can
#   round it the other way, moving a gate by ulp(a)·|W| → max ≤ 8 ulps at
#   1.0 (6.25e-2) and mean ≤ 1e-3 (rare flips, not a wrong sum); f32: 1e-4.
TOL_F32 = 1e-4
TOL_FLIP_MAX, TOL_FLIP_MEAN = 8 * BF16_ULP, 1e-3

KERNELS = {
    "typed_block_scatter": ("ggnn_tpu_torch/ops/csrc/typed_block.cu",
                            "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "typed_block_step_gru": ("ggnn_tpu_torch/ops/csrc/typed_block.cu",
                             "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "gru_cell_fwd": ("ggnn_tpu_torch/ops/csrc/gru_cell.cu",
                     "ggnn_tpu/ops/gru_pallas.py:41"),
}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def errors(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), d.mean().item(), ref.float().abs().max().item()


def check(name, got, ref, kind, dtype, log):
    """Compare; kind is 'sum' (scatter), 'cell' (GRU cell) or 'flip'."""
    import torch
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    emax, emean, scale = errors(got, ref)
    bf16 = dtype == torch.bfloat16
    if kind == "sum":
        ok, tol = emax <= 2e-5 * max(1.0, scale), 2e-5 * max(1.0, scale)
    elif kind == "cell":
        tol = BF16_ULP if bf16 else TOL_F32
        ok = emax <= tol
    else:
        tol = TOL_FLIP_MAX if bf16 else TOL_F32
        ok = emax <= tol and (not bf16 or emean <= TOL_FLIP_MEAN)
    print(f"  {name}: max_abs_err {emax:.3e} (tol {tol:.3e}) mean_abs_err "
          f"{emean:.3e} max_rel_err {emax / max(scale, 1e-30):.3e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: error over tolerance")
    log.setdefault(name.split("[")[0], []).append(emax)


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def kernel_inputs(layout, dtype, params, seed):
    """Kernel arguments at a layout's shapes: the model's weights and a
    state in (−1, 1) as the GRU keeps it."""
    import torch
    from ggnn_tpu_torch.models.ggnn import fuse_gru
    from ggnn_tpu_torch.ops import scatter as S
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = S.block_args(layout)
    arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
    n_rows = kw["n_blocks"] * 128
    n_nodes = int(layout.arrays["gather_idx"].max().item()) + 1
    h = torch.rand(max(n_nodes, n_rows), DIM, device=dev, generator=g) * 2 - 1
    prop = params["prop"]
    T2 = layout.arrays["indeg"].shape[0]
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    x = dict(
        h_pack=h.to(dtype).index_select(0, layout.arrays["gather_idx"]),
        arrs=arrs, kw=kw, msg_w=prop["msg_w"][:T2].to(dtype),
        init=S.bias_rows(layout, prop["msg_b"][:T2].to(dtype)),
        hstate=h[:n_rows].contiguous(), wa=w_a.to(dtype),
        b3=b_all[None, :].float(), uzr=u_zr.to(dtype),
        uh=prop["gru"]["uh"].to(dtype))
    x["a"] = x["init"] + S.typed_block_scatter_reference(
        x["h_pack"], *arrs, x["msg_w"], **kw)
    return x


def check_kernels(tag, layout, params, log, timings=None):
    import torch
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    print(f"[kernels] {tag}: tile_e={layout.meta[1]} n_blocks="
          f"{layout.meta[3]} (S8, cmax, span_rows)={layout.meta[10]}",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        x = kernel_inputs(layout, dtype, params, seed=1)
        arrs, kw = x["arrs"], x["kw"]
        sa = (x["h_pack"], *arrs, x["msg_w"])
        fa = (*sa, x["init"], x["hstate"], x["wa"], x["b3"], x["uzr"],
              x["uh"])
        ga = (x["hstate"], x["a"], x["wa"], x["b3"][0], x["uzr"], x["uh"])
        dn = str(dtype).split(".")[-1]
        got = S.typed_block_scatter(*sa, **kw)
        torch.cuda.synchronize()
        check(f"typed_block_scatter[{tag},{dn}]", got,
              S.typed_block_scatter_reference(*sa, **kw), "sum", dtype, log)
        empty = (layout.arrays["slot_off16"].reshape(kw["n_blocks"], -1)
                 < 0).all(1)
        if empty.any():
            rows = got.reshape(kw["n_blocks"], 128, DIM)[empty]
            if (rows != 0).any():
                raise AssertionError(f"{tag}: an empty dst block is not 0")
            print(f"  {int(empty.sum())} empty dst blocks are exactly 0",
                  flush=True)
        got = S.typed_block_step_gru(*fa, **kw)
        torch.cuda.synchronize()
        check(f"typed_block_step_gru[{tag},{dn}]", got,
              S.typed_block_step_gru_reference(*fa, **kw), "flip", dtype,
              log)
        outs = G.gru_cell_fwd(*ga, mdt=dtype)
        torch.cuda.synchronize()
        refs = G.gru_cell_fwd_reference(*ga, mdt=dtype)
        for part, o, r in zip(("h", "z", "r", "htil"), outs, refs):
            check(f"gru_cell_fwd[{tag},{dn},{part}]", o, r, "cell", dtype,
                  log)
        if timings is not None and dtype == torch.bfloat16:
            pairs = {
                "typed_block_scatter": (
                    lambda: S.typed_block_scatter(*sa, **kw),
                    lambda: S.typed_block_scatter_reference(*sa, **kw)),
                "typed_block_step_gru": (
                    lambda: S.typed_block_step_gru(*fa, **kw),
                    lambda: S.typed_block_step_gru_reference(*fa, **kw)),
                "gru_cell_fwd": (
                    lambda: G.gru_cell_fwd(*ga, mdt=dtype),
                    lambda: G.gru_cell_fwd_reference(*ga, mdt=dtype)),
            }
            for name, (kern, plain) in pairs.items():
                # plain, kernel, kernel, plain: compare within one card
                p1 = cuda_ms(plain, 3)
                k1 = cuda_ms(kern, 10)
                k2 = cuda_ms(kern, 10)
                p2 = cuda_ms(plain, 3)
                timings[name] = (min(k1, k2), min(p1, p2))
                print(f"  time {name} [bf16 headline]: kernel "
                      f"{k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms",
                      flush=True)
        del x


def request_graph(seed):
    """One serving request: a uniform random graph of the headline size."""
    r = np.random.default_rng(seed)
    edges = np.stack([r.integers(0, NODES, EDGES),
                      r.integers(0, EDGE_TYPES, EDGES),
                      r.integers(0, NODES, EDGES)], axis=1)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=edges, annotations=ann)


def plain_scores(pred, batch, layout):
    """Node scores through the port's plain path on the card: the same
    onehot step with the kernels' plain versions."""
    import torch
    import torch.nn.functional as F
    from ggnn_tpu_torch.models.ggnn import fuse_gru, init_state
    from ggnn_tpu_torch.models.heads import node_select_scores
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    cfg, params = pred.cfg, pred.params
    cdt = torch_dtype(cfg.compute_dtype)
    prop = params["prop"]
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    kw = S.block_args(layout)
    arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
    msg_w = prop["msg_w"].to(cdt)
    bias = S.bias_rows(layout, prop["msg_b"].to(cdt))
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    N, n_rows = h.shape[0], kw["n_blocks"] * 128
    with torch.inference_mode():
        for _ in range(cfg.n_steps):
            h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
            a = bias + S.typed_block_scatter_reference(h_pack, *arrs, msg_w,
                                                       **kw)
            h_pad = F.pad(h, (0, 0, 0, n_rows - N))
            h = G.gru_cell_fwd_reference(h_pad, a, w_a, b_all, u_zr,
                                         prop["gru"]["uh"], mdt=cdt)[0][:N]
        return node_select_scores(params["head"], h, ann).cpu().numpy()


def serve(params, fuse, graphs, plain_cache):
    import torch
    from ggnn_tpu.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    cfg = ModelConfig(state_dim=DIM, annotation_dim=ANN,
                      n_edge_types=EDGE_TYPES, n_steps=STEPS,
                      head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=fuse)
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    pred = Predictor(cfg, spec, params=params, device="cuda")
    mode = "fused" if fuse else "unfused"
    results = []
    for fn in (S.typed_block_scatter, S.typed_block_step_gru,
               G.gru_cell_fwd):
        fn.launches = 0
    for seed, g in graphs:
        t0 = time.perf_counter()
        batch = batch_graphs([g], spec)
        layout = pred.layout(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = pred.run_batch(batch, layout)
        t2 = time.perf_counter()
        answer = pred.decode(scores, batch, 1)[0]
        results.append((seed, batch, layout, scores, answer, t1 - t0,
                        t2 - t1))
    launches = {fn.__name__: fn.launches for fn in (
        S.typed_block_scatter, S.typed_block_step_gru, G.gru_cell_fwd)}
    print(f"[serve] {mode}: launches on the serving path {launches}",
          flush=True)
    n = len(graphs)
    want = ({"typed_block_step_gru": STEPS * n, "typed_block_scatter": 0,
             "gru_cell_fwd": 0} if fuse else
            {"typed_block_step_gru": 0, "typed_block_scatter": STEPS * n,
             "gru_cell_fwd": STEPS * n})
    if launches != want:
        raise AssertionError(f"{mode}: launches {launches}, expected {want}")
    for seed, batch, layout, scores, answer, prep_s, dev_s in results:
        if scores.shape != (NODES,) or not np.isfinite(scores).all():
            raise AssertionError(f"request {seed}: bad scores")
        if seed not in plain_cache:
            plain_cache[seed] = plain_scores(pred, batch, layout)
        ref = plain_cache[seed]
        d = np.abs(scores - ref)
        emax, emean = float(d.max()), float(d.mean())
        ok = emax <= TOL_FLIP_MAX and emean <= TOL_FLIP_MEAN
        # the answer must be a top node of the plain path too (ties within
        # the tolerance may pick another node)
        ok_answer = ref[answer] >= ref.max() - TOL_FLIP_MAX
        rate = 2 * EDGES * STEPS / dev_s
        print(f"[serve] {mode} request seed={seed}: answer node {answer} "
              f"(plain argmax {int(np.argmax(ref))}), scores max_abs_err "
              f"{emax:.3e} mean_abs_err {emean:.3e} (tol "
              f"{TOL_FLIP_MAX:.3e}/{TOL_FLIP_MEAN:.0e}) "
              f"{'ok' if ok and ok_answer else 'FAIL'}; latency "
              f"{prep_s + dev_s:.3f} s = host batch+layout {prep_s:.3f} s + "
              f"device forward {dev_s * 1e3:.2f} ms; "
              f"{rate:.4e} directed-edges*T/s", flush=True)
        if not (ok and ok_answer):
            raise AssertionError(f"{mode} request {seed}: scores disagree "
                                 "with the plain path")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    from ggnn_tpu.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout

    _build.library()
    print(f"[build] {'compiled' if _build.BuildInfo.compiled else 'loaded'}"
          f" {_build.BuildInfo.path} in {_build.BuildInfo.seconds:.1f} s")
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg = ModelConfig(state_dim=DIM, annotation_dim=ANN,
                      n_edge_types=EDGE_TYPES, n_steps=STEPS,
                      head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")

    log, timings = {}, {}
    r = np.random.default_rng(7)
    fuzz = {
        "fuzz": (640, 9000, 6, 640, None),
        "empty_blocks": (1024, 3000, 4, 512, None),
        "cmax_ge_2": (256, 6000, 4, 256, 128),
    }
    for tag, (n, e, t2, dst_hi, tile_e) in fuzz.items():
        lay = build_typed_dst_layout(
            r.integers(0, n, e), r.integers(0, dst_hi, e),
            r.integers(0, t2, e), (r.random(e) < 0.9).astype(np.float32),
            n, t2, tile_e=tile_e)
        if tag == "cmax_ge_2" and lay.meta[10][1] < 2:
            raise AssertionError("fuzz layout did not reach cmax >= 2")
        check_kernels(tag, lay.to("cuda"), params, log)

    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                 b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES)
    print(f"[kernels] headline layout built on the host in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check_kernels("headline", lay.to("cuda"), params, log, timings)
    del lay, b
    torch.cuda.empty_cache()

    graphs = [(seed, request_graph(seed)) for seed in (0, 1, 2)]
    plain_cache = {}
    torch.cuda.reset_peak_memory_stats()
    launched = serve(params, True, graphs, plain_cache)
    launched.update({k: v for k, v in serve(params, False, graphs,
                                            plain_cache).items() if v})
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = timings[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launched[name],
                            max_abs_err=max(log[name]), ms=ms,
                            plain_ms=plain_ms))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
