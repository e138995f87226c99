#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ggnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from ``ggnn_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, at the
   headline shapes (262,144 nodes, 4M logical / 8M directed edges, 8 edge
   types, D = 128) in bf16 and f32 and on four small fuzz layouts built
   with their grad half (one with empty dst blocks, one with cmax >= 2,
   one with B_g % 8 != 0 and empty grad blocks, one with C >= 2 grad
   chunks), and times kernel and plain version at the headline in bf16
   with CUDA events (plain, kernel, kernel, plain).  The forward kernels:
   ``typed_block_scatter``, ``typed_block_step_gru``, ``gru_cell_fwd``; the
   backward kernels: ``gru_cell_bwd`` and ``typed_grad_octet_scatter``.
3. Serves: a ``Predictor`` for the headline model (node_select head,
   onehot backend, bf16, T = 5 steps, random weights from seed 0) answers
   three requests of one 262,144-node graph each (seeds 0, 1, 2), fused
   and unfused.  It checks the kernels' launch counts on that path and
   holds every request's node scores against the port's plain path on the
   card.
4. Trains the headline model (the same configuration, typed layout built
   ``with_grad=True``, node_select loss on a target node from seed 0,
   ``torch.optim.Adam(1e-3)`` over every parameter) for 3 steps through
   ``make_train_step``, fused, fused with lean residuals, and unfused.  It
   checks the launch counts per step, holds the first step's loss and every
   gradient leaf against the same step through the kernels' plain versions
   on the card, and prints step times, peak device memory and the host
   time of the layout.
5. Runs the ``Trainer`` CLI on bAbI task 4 (``--device cuda``) for a few
   epochs and checks its loss is finite.

Any failed check raises, so the exit code is non-zero.  The last three
lines are the kernels JSON, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
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
# - reverse scatter (grad octet): the same f32 sums in another order →
#   f32 max ≤ 2e-5·max(1, max|plain|); flushed to bf16, a last-bit f32
#   difference can round a row to the neighbouring bf16 value → max ≤ one
#   bf16 ulp at the largest value, 2**-7·max(1, max|plain|);
# - GRU backward: every output is a sum over rows or features of products
#   of the same rounded inputs, in another order; in bf16 the gate
#   gradients are rounded before the products and a last-bit f32
#   difference can round one to its neighbour, moving one term by one bf16
#   ulp.  Such flips are rare and unsystematic, so each output's relative
#   Frobenius error stays far below one bf16 ulp: ≤ 2**-8 (bf16), 1e-5 (f32);
# - training, first step against the plain path on the same card, per
#   gradient leaf (relative Frobenius error) and for the loss:
#   f32 (fused; kernels 1 and 5 in their f32 form): the same math summed in
#   another order → every leaf ≤ 1e-4 and the loss within 1e-5 relative;
#   bf16 (the headline): every bf16 rounding point of 5 steps forward and
#   back can round a value to its neighbour, and the node_select softmax
#   passes those flips to every leaf.  Between two faithful versions with
#   the same rounding points (the JAX reference and the port's plain path,
#   this configuration at 4,096 nodes on the CPU) the spread is 3e-3 to
#   6.1e-3 on every leaf; the bound is 2**-6 (1.6e-2) per leaf and 1e-3 on
#   the loss.  A leaf whose gradient vanishes by the model's symmetry
#   (head/b2: shifting every node's score leaves the softmax unchanged, so
#   its gradient Σ_v p_v − 1 is 0 up to f32 rounding in either path) has
#   no scale of its own, so no relative error: both paths must give 0 up
#   to rounding, ≤ 1e-6 of the whole gradient's norm, as the CPU tests
#   hold it (tests/test_torch_train_model.py).
TOL_F32 = 1e-4
TOL_FLIP_MAX, TOL_FLIP_MEAN = 8 * BF16_ULP, 1e-3
TOL_RELF_BF16, TOL_RELF_F32 = 2.0 ** -8, 1e-5
TOL_TRAIN = {"bfloat16": (2.0 ** -6, 1e-3), "float32": (1e-4, 1e-5)}
SYMMETRIC_LEAVES, TOL_SYMMETRIC = ("head/b2",), 1e-6

KERNELS = {
    "typed_block_scatter": ("ggnn_tpu_torch/ops/csrc/typed_block.cu",
                            "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "typed_block_step_gru": ("ggnn_tpu_torch/ops/csrc/typed_block.cu",
                             "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "gru_cell_fwd": ("ggnn_tpu_torch/ops/csrc/gru_cell.cu",
                     "ggnn_tpu/ops/gru_pallas.py:41"),
    "gru_cell_bwd": ("ggnn_tpu_torch/ops/csrc/gru_cell_bwd.cu",
                     "ggnn_tpu/ops/gru_pallas.py:62"),
    "typed_grad_octet_scatter": ("ggnn_tpu_torch/ops/csrc/grad_octet.cu",
                                 "ggnn_tpu/ops/scatter_pallas.py:2120"),
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


def relfro(got, ref) -> float:
    """Relative Frobenius error ‖got − ref‖ / ‖ref‖."""
    return ((got.double() - ref.double()).norm()
            / ref.double().norm().clamp_min(1e-30)).item()


def check(name, got, ref, kind, dtype, log):
    """Compare; kind is 'sum' (scatter), 'cell' (GRU cell), 'flip',
    'flush' (reverse scatter) or 'relfro' (GRU backward)."""
    import torch
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    emax, emean, scale = errors(got, ref)
    bf16 = dtype == torch.bfloat16
    rf = None
    if kind == "sum":
        ok, tol = emax <= 2e-5 * max(1.0, scale), 2e-5 * max(1.0, scale)
    elif kind == "flush":
        tol = (BF16_ULP if bf16 else 2e-5) * max(1.0, scale)
        ok = emax <= tol
    elif kind == "relfro":
        rf = relfro(got, ref)
        tol = TOL_RELF_BF16 if bf16 else TOL_RELF_F32
        ok = rf <= tol
    elif kind == "cell":
        tol = BF16_ULP if bf16 else TOL_F32
        ok = emax <= tol
    else:
        tol = TOL_FLIP_MAX if bf16 else TOL_F32
        ok = emax <= tol and (not bf16 or emean <= TOL_FLIP_MEAN)
    what = (f"rel_frobenius {rf:.3e} (tol {tol:.3e}) max_abs_err {emax:.3e}"
            if rf is not None else
            f"max_abs_err {emax:.3e} (tol {tol:.3e})")
    print(f"  {name}: {what} mean_abs_err {emean:.3e} max_rel_err "
          f"{emax / max(scale, 1e-30):.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
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


def time_pairs(pairs, timings):
    """Time each (kernel, plain) pair in turns, plain, kernel, kernel,
    plain, so both are compared within one card; keep the best of each."""
    for name, (kern, plain) in pairs.items():
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 10)
        k2 = cuda_ms(kern, 10)
        p2 = cuda_ms(plain, 3)
        timings[name] = (min(k1, k2), min(p1, p2))
        print(f"  time {name} [bf16 headline]: kernel {k1:.3f}/{k2:.3f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms", flush=True)


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
            time_pairs({
                "typed_block_scatter": (
                    lambda: S.typed_block_scatter(*sa, **kw),
                    lambda: S.typed_block_scatter_reference(*sa, **kw)),
                "typed_block_step_gru": (
                    lambda: S.typed_block_step_gru(*fa, **kw),
                    lambda: S.typed_block_step_gru_reference(*fa, **kw)),
                "gru_cell_fwd": (
                    lambda: G.gru_cell_fwd(*ga, mdt=dtype),
                    lambda: G.gru_cell_fwd_reference(*ga, mdt=dtype)),
            }, timings)
        del x


def check_grad_kernels(tag, layout, log, timings=None):
    """The backward kernels against their plain versions at the layout's
    shapes: the reverse scatter on a random cotangent pack, and the GRU
    backward on residuals the forward cell makes from random h and a."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    _, B_g, g_tile, C, R8, span8, n_oct = S.grad_meta(layout)
    arrs = layout.arrays
    octs = (arrs["g_dstl_oct"], arrs["g_slot_off16"], arrs["g_oblk16"])
    okw = dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8)
    n_rows = layout.meta[3] * 128
    empty = (arrs["g_slot_off16"].reshape(n_oct * 8, C) < 0).all(1)
    print(f"[kernels] {tag} grad half: B_g={B_g} (B_g % 8 = {B_g % 8}) "
          f"g_tile={g_tile} C={C} n_oct={n_oct} span8={span8}, "
          f"{int(empty.sum())} empty grad blocks of {n_oct * 8}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        Gp = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                         generator=gen).to(dtype)
        got = S.typed_grad_octet_scatter(Gp, *octs, **okw, out_dtype=dtype)
        torch.cuda.synchronize()
        ref = S.typed_grad_octet_scatter_reference(Gp, *octs, **okw,
                                                   out_dtype=dtype)
        check(f"typed_grad_octet_scatter[{tag},{dn}]", got, ref, "flush",
              dtype, log)
        rows = got.reshape(n_oct * 8, 128, DIM)
        if (rows[empty] != 0).any():
            raise AssertionError(f"{tag}: an empty grad block is not 0")
        h = torch.rand(n_rows, DIM, device=dev, generator=gen) * 2 - 1
        a = torch.randn(n_rows, DIM, device=dev, generator=gen)
        g = torch.randn(n_rows, DIM, device=dev, generator=gen)
        w = [torch.empty(DIM, k * DIM, device=dev).uniform_(
            -DIM ** -0.5, DIM ** -0.5, generator=gen) for k in (3, 2, 1)]
        b3 = torch.empty(3 * DIM, device=dev).uniform_(-0.1, 0.1,
                                                        generator=gen)
        _, z, r, ht = G.gru_cell_fwd_reference(h, a, w[0], b3, w[1], w[2],
                                               mdt=dtype)
        args = (g, h.to(dtype), a.to(dtype), z, r, ht, *w)
        outs = G.gru_cell_bwd(*args, mdt=dtype)
        torch.cuda.synchronize()
        refs = G.gru_cell_bwd_reference(*args, mdt=dtype)
        for part, o, rr in zip(("dh", "da", "dW_a", "db", "dU_zr", "dU_h"),
                               outs, refs):
            check(f"gru_cell_bwd[{tag},{dn},{part}]", o, rr, "relfro", dtype,
                  log)
        if timings is not None and dtype == torch.bfloat16:
            time_pairs({
                "typed_grad_octet_scatter": (
                    lambda: S.typed_grad_octet_scatter(
                        Gp, *octs, **okw, out_dtype=dtype),
                    lambda: S.typed_grad_octet_scatter_reference(
                        Gp, *octs, **okw, out_dtype=dtype)),
                "gru_cell_bwd": (
                    lambda: G.gru_cell_bwd(*args, mdt=dtype),
                    lambda: G.gru_cell_bwd_reference(*args, mdt=dtype)),
            }, timings)
        del Gp, got, ref, outs, refs, args


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


def kernel_wrappers():
    """The five kernel wrappers by name (each counts its launches)."""
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    return {"typed_block_scatter": S.typed_block_scatter,
            "typed_block_step_gru": S.typed_block_step_gru,
            "gru_cell_fwd": G.gru_cell_fwd, "gru_cell_bwd": G.gru_cell_bwd,
            "typed_grad_octet_scatter": S.typed_grad_octet_scatter}


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain versions (the same
    function, the same rounding points) for the plain path on the card."""
    from ggnn_tpu_torch.models import ggnn as M
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    swaps = [(S, "typed_block_scatter", S.typed_block_scatter_reference),
             (S, "typed_grad_octet_scatter",
              S.typed_grad_octet_scatter_reference),
             (M, "gru_cell_fwd", G.gru_cell_fwd_reference),
             (M, "gru_cell_bwd", G.gru_cell_bwd_reference)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def headline_cfg(**kw):
    from ggnn_tpu_torch.models.config import ModelConfig
    return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                       n_edge_types=EDGE_TYPES, n_steps=STEPS,
                       head="node_select", backend="onehot", **kw)


def fresh_params(cfg):
    """The headline model's parameters from seed 0, trainable, on the
    card."""
    import torch
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.train.loop import param_leaves
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def train_headline(batch, layout):
    """Three Adam steps of the headline model per mode through
    make_train_step; returns the launch counts of those runs."""
    import torch
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
    arrays = batch_arrays(batch, "cuda")
    target = int(np.random.default_rng(0).integers(0, NODES))
    arrays["targets"] = {"node": torch.tensor([target], dtype=torch.int32,
                                              device="cuda")}
    wrappers = kernel_wrappers()
    modes = {"fused": dict(fuse_gru=True),
             "fused+lean": dict(fuse_gru=True, lean_residuals=True),
             "unfused": dict(fuse_gru=False)}
    total = dict.fromkeys(KERNELS, 0)
    for mode, extra in modes.items():
        cfg = headline_cfg(compute_dtype="bfloat16", **extra)
        params = fresh_params(cfg)
        opt = make_optimizer(params, 1e-3)
        step = make_train_step(cfg, 1, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        events, losses, grads1 = [], [], None
        for i in range(3):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            m = step(params, arrays, layout)
            ev[1].record()
            events.append(ev)
            losses.append(m["loss_sum"] / m["count"])
            if i == 0:
                grads1 = {k: p.grad.detach().clone()
                          for k, p in _flatten(params)}
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = [a.elapsed_time(b) for a, b in events]
        losses = [float(x) for x in losses]
        print(f"[train] {mode}: losses {[f'{x:.6f}' for x in losses]}; "
              f"step ms {[f'{x:.2f}' for x in ms]} (median "
              f"{statistics.median(ms):.2f}, spread {max(ms) - min(ms):.2f}); "
              f"peak device memory {peak:.2f} GiB; launches over 3 steps "
              f"{launches}", flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {mode}: non-finite loss {losses}")
        per = STEPS * 3
        want = (dict(typed_block_scatter=per, typed_block_step_gru=0,
                     gru_cell_fwd=0, gru_cell_bwd=0,
                     typed_grad_octet_scatter=per)
                if cfg.fuse_gru else dict.fromkeys(
                    ("typed_block_scatter", "gru_cell_fwd", "gru_cell_bwd",
                     "typed_grad_octet_scatter"), per)
                | dict(typed_block_step_gru=0))
        if launches != want:
            raise AssertionError(f"train {mode}: launches {launches}, "
                                 f"expected {want}")
        for k in total:
            total[k] += launches[k]
        compare_first_step(mode, cfg, arrays, layout, grads1, losses[0])
        del params, opt, step, grads1
        torch.cuda.empty_cache()
    # the same first step in f32 (fused: kernels 1 and 5 in f32), where
    # nothing rounds to bf16, against its plain path
    cfg = headline_cfg(compute_dtype="float32", fuse_gru=True)
    params = fresh_params(cfg)
    loss, _ = loss_and_metrics(params, cfg, arrays, 1, scatter_layout=layout)
    grads = dict(zip([k for k, _ in _flatten(params)],
                     torch.autograd.grad(loss, param_leaves(params))))
    compare_first_step("fused f32", cfg, arrays, layout, grads,
                       float(loss.detach()))
    return total


def compare_first_step(mode, cfg, arrays, layout, grads, loss_k):
    """The first step's loss and gradient leaves against the same step
    through the kernels' plain versions on the card."""
    import torch
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import param_leaves
    params = fresh_params(cfg)
    with plain_versions():
        loss, _ = loss_and_metrics(params, cfg, arrays, 1,
                                   scatter_layout=layout)
        gp = torch.autograd.grad(loss, param_leaves(params))
    loss = float(loss.detach())
    tol, tol_loss = TOL_TRAIN[cfg.compute_dtype]
    dl = abs(loss_k - loss) / max(abs(loss), 1e-30)
    total = torch.stack([g.double().norm() for g in gp]).norm().item()
    errs, sym = [], 0.0
    for (key, _), g_ref in zip(_flatten(params), gp):
        got = grads[key]
        if not torch.isfinite(got).all():
            raise AssertionError(f"train {mode}: non-finite grad {key}")
        if key in SYMMETRIC_LEAVES:
            sym = max(sym, got.double().norm().item() / total,
                      g_ref.double().norm().item() / total)
            continue
        errs.append((relfro(got, g_ref), key))
    errs.sort(reverse=True)
    ok = dl <= tol_loss and errs[0][0] <= tol and sym <= TOL_SYMMETRIC
    worst = ", ".join(f"{k} {e:.3e}" for e, k in errs[:3])
    print(f"[train] {mode} step 1 vs plain path: loss {loss_k:.6f} vs "
          f"{loss:.6f} (rel {dl:.3e}, tol {tol_loss:.0e}); worst gradient "
          f"leaves (rel_frobenius, tol {tol:.3e}): {worst}; median leaf "
          f"{statistics.median(e for e, _ in errs):.3e}; "
          f"{'/'.join(SYMMETRIC_LEAVES)} {sym:.3e} of the gradient's norm "
          f"(tol {TOL_SYMMETRIC:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"train {mode}: first step disagrees with the "
                             "plain path")


def run_trainer():
    """The Trainer CLI on bAbI task 4 on the card, as a user runs it."""
    cmd = [sys.executable, "-m", "ggnn_tpu_torch.train", "--config", "babi4",
           "--device", "cuda", "--epochs", "10"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"Trainer CLI failed ({res.returncode}):\n"
                             f"{res.stderr[-4000:]}")
    result = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[trainer] {' '.join(cmd[1:])}: {result} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not np.isfinite(result["test_loss"]):
        raise AssertionError("Trainer: non-finite test loss")


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
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")

    cfg = ModelConfig(state_dim=DIM, annotation_dim=ANN,
                      n_edge_types=EDGE_TYPES, n_steps=STEPS,
                      head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")

    log, timings = {}, {}
    r = np.random.default_rng(7)
    fuzz = {
        # tag: (nodes, edges, types, dst range, src range, tile_e,
        #       grad_tile_e)
        "fuzz": (640, 9000, 6, 640, 640, None, None),
        "empty_blocks": (1024, 3000, 4, 512, 1024, None, None),
        "cmax_ge_2": (256, 6000, 4, 256, 256, 128, 128),
        "empty_grad_blocks": (640, 4000, 6, 640, 256, None, None),
    }
    for tag, (n, e, t2, dst_hi, src_hi, tile_e, g_tile) in fuzz.items():
        lay = build_typed_dst_layout(
            r.integers(0, src_hi, e), r.integers(0, dst_hi, e),
            r.integers(0, t2, e), (r.random(e) < 0.9).astype(np.float32),
            n, t2, tile_e=tile_e, with_grad=True, grad_tile_e=g_tile)
        if tag == "cmax_ge_2" and (lay.meta[10][1] < 2 or lay.meta[5][3] < 2):
            raise AssertionError("fuzz layout did not reach cmax, C >= 2")
        if tag == "empty_grad_blocks" and lay.meta[5][1] % 8 == 0:
            raise AssertionError("fuzz layout did not reach B_g % 8 != 0")
        lay = lay.to("cuda")
        check_kernels(tag, lay, params, log)
        check_grad_kernels(tag, lay, log)

    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    t1 = time.perf_counter()
    lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                 b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES,
                                 with_grad=True)
    t2 = time.perf_counter()
    lay = lay.to("cuda")
    torch.cuda.synchronize()
    print(f"[kernels] headline batch made in {t1 - t0:.2f} s; typed layout "
          f"with its grad half built on the host in {t2 - t1:.2f} s and "
          f"copied to the card in {time.perf_counter() - t2:.2f} s; "
          f"grad_meta {lay.meta[5]}", flush=True)
    check_kernels("headline", lay, params, log, timings)
    check_grad_kernels("headline", lay, log, timings)
    torch.cuda.empty_cache()

    graphs = [(seed, request_graph(seed)) for seed in (0, 1, 2)]
    plain_cache = {}
    torch.cuda.reset_peak_memory_stats()
    launched = serve(params, True, graphs, plain_cache)
    launched.update({k: v for k, v in serve(params, False, graphs,
                                            plain_cache).items() if v})
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del graphs, plain_cache
    torch.cuda.empty_cache()

    trained = train_headline(b, lay)
    del lay, b
    torch.cuda.empty_cache()
    launched = {k: launched.get(k, 0) + trained.get(k, 0) for k in KERNELS}
    run_trainer()
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
