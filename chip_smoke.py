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
   with CUDA events (plain, kernel, kernel, plain); each scatter kernel
   must also give the same bits in a second run (no atomics).  The
   forward kernels:
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
6. ``[scalefree]``: the same headline model on a power-law graph of the
   same size (Zipf 1.2 endpoints, nodes numbered by degree rank, made by
   the port's ``synthetic_batch``), where block mode and the octet grad
   layout decline and the per-tile kernels carry the graph.  It holds
   ``typed_onehot_scatter``, ``typed_step_gru`` and
   ``window_block_spmm_mono`` against their plain versions there and on
   five fuzz layouts (uniform with block mode off, span mode, a small
   chunk cap, empty blocks, a hub, the hub again with |a| ≤ 1), per
   element, and each against a second run of itself (bit-equal), times
   them, serves three requests fused and unfused (each step against the
   plain step) and trains 3 Adam steps fused and unfused, with the launch
   counts, the first step's loss against the plain path and the
   aggregation's VJP against its plain version (dh per row off the hub).

Any failed check raises, so the exit code is non-zero.  The last three
lines are the kernels JSON (each kernel's launches on the main paths, its
largest error against its plain version, its time and its plain
version's, its bound from the bytes and operations of the timed inputs at
the card's published peaks, and the time of one PyTorch call computing
the same function where there is one), the ``nvidia-smi`` line and
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
ZIPF = 1.2             # the scale-free graph's power law
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
# The per-tile kernels (#6, #7) and the window kernel (#11), which carry
# power-law graphs: a hub row sums up to 1.5M terms, so one tolerance
# scaled by the output's largest value would be as large as an ordinary
# row's whole value.  They are held per element instead ('bound'):
# - #7 and #11: |kernel − plain| ≤ 2e-5·Σ|terms| of that element (the plain
#   version on |inputs|: f32 sums in another order), plus in bf16 one ulp
#   of every rounded sum that may round the other way: for #7 each tile's
#   one-hot sum of three or more terms, times |W_t| (a sum of one or two
#   terms is the same in every order, so an ordinary row's tiles add
#   nothing), for #11 the flushed output itself, 2**-7·|plain|.  Two
#   faithful versions sit far inside it on average: the mean of |kernel −
#   plain| / bound must stay ≤ 0.1 as well, so a systematic error fails;
# - #6, the fused step, against its plain version: a hub row's |a| makes
#   the ulp of its bf16 rounding large, so each row within 8 bf16 ulps
#   times max(1, max|a_row|) ('flip_rows'); and, exactly, against the GRU
#   cell kernel (#3) applied to #7's sums plus init: the same sums and the
#   same epilogue code (common.cuh), so equal up to TOL_SAME, f32
#   rounding, in every row, the hub's split blocks included; and on a fuzz
#   layout whose blocks split into several work items with |a| ≤ 1, where
#   'flip_rows' is 8 ulps at every row;
# - the aggregation's VJP on the power-law graph: dh per row, over the
#   rows of at most HUB_TERMS terms (the hub rows' whole-tensor error hides
#   them): each row's relative error ≤ TOL_TRAIN and the rows' relative
#   Frobenius error ≤ TOL_RELF (rare flips of the bf16 flush).
TOL_BOUND_MEAN, TOL_SAME, HUB_TERMS = 0.1, 1e-6, 64

# The card's published peaks (NVIDIA H100 SXM data sheet, dense), for each
# kernel's bound: the larger of bytes / HBM rate and operations / the rate
# of their type.
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12

KERNELS = {
    # name: (source, the TPU kernel body it replaces)
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
    "typed_onehot_scatter": ("ggnn_tpu_torch/ops/csrc/typed_tile.cu",
                             "ggnn_tpu/ops/scatter_pallas.py:1416"),
    "typed_step_gru": ("ggnn_tpu_torch/ops/csrc/typed_tile.cu",
                       "ggnn_tpu/ops/scatter_pallas.py:1562"),
    "window_block_spmm_mono": ("ggnn_tpu_torch/ops/csrc/window_mono.cu",
                               "ggnn_tpu/ops/window_pallas.py:787"),
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


def check(name, got, ref, kind, dtype, log, a_rows=None, bound=None):
    """Compare; kind is 'sum' (scatter), 'cell' (GRU cell), 'flip',
    'flip_rows' (per row, scaled by ``a_rows`` = max(1, max|a_row|)),
    'flush' (reverse scatter), 'relfro' (GRU backward), 'bound' (per
    element, against the tensor ``bound``) or 'same' (within TOL_SAME)."""
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
    elif kind == "flip_rows":
        tol = TOL_FLIP_MAX if bf16 else TOL_F32
        ratio = ((got.float() - ref.float()).abs().amax(1)
                 / (tol * a_rows)).max().item()
        print(f"  {name}: rows' max error at {ratio:.3e} of max(1, "
              f"max|a_row|) x {tol:.3e} (largest |a| "
              f"{a_rows.max().item():.4e})", flush=True)
        ok = ratio <= 1.0 and (not bf16 or emean <= TOL_FLIP_MEAN)
    elif kind == "bound":
        ratio = ((got.float() - ref.float()).abs()
                 / bound.clamp_min(1e-30))
        rmax, rmean = ratio.max().item(), ratio.mean().item()
        tol = 1.0
        print(f"  {name}: error at most {rmax:.3e} of its element's bound "
              f"(tol 1), on average {rmean:.3e} (tol {TOL_BOUND_MEAN}); "
              f"bounds {bound.min().item():.3e} .. {bound.max().item():.3e}",
              flush=True)
        ok = rmax <= 1.0 and rmean <= TOL_BOUND_MEAN
    elif kind == "same":
        tol = TOL_SAME
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


def same_twice(name, tag, got, again):
    """A scatter kernel sums in a fixed order (no atomics): a second run on
    the same inputs must give the same bits."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}[{tag}]: two runs differ")
    print(f"  {name}[{tag}]: two runs bit-equal", flush=True)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` over the HBM rate and the operations ``ops`` [(count,
    peak rate of their type)] over their rates."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = sum(c / r for c, r in ops)
    print(f"  bound: {n_bytes / 1e9:.4f} GB -> {t_bytes * 1e3:.4f} ms; "
          f"operations -> {t_ops * 1e3:.4f} ms", flush=True)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_pairs(pairs, timings):
    """Time each kernel against its plain version in turns, plain, kernel,
    kernel, plain, so both are compared within one card, and keep the best
    of each; then the PyTorch call computing the same function, where
    there is one.  ``pairs``: name -> (kernel, plain, library call or None,
    (bound_ms, bound_by))."""
    for name, (kern, plain, lib, (bound_ms, bound_by)) in pairs.items():
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 10)
        k2 = cuda_ms(kern, 10)
        p2 = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 10) if lib is not None else None
        timings[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms)
        print(f"  time {name} [bf16 headline]: kernel {k1:.3f}/{k2:.3f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by}): kernel at "
              f"{bound_ms / min(k1, k2):.3f} of its bound", flush=True)


def kernel_inputs(layout, dtype, params, seed, a_max=None):
    """Kernel arguments at a layout's shapes: the model's weights and a
    state in (−1, 1) as the GRU keeps it.  ``kw`` holds the layout's
    arguments (block mode: the three slot arrays are ``arrs``; per tile:
    all of them are in ``kw``) and ``a`` the aggregation's value.
    ``a_max`` (per tile): the messages and the bias are scaled down so
    that |a| ≤ a_max everywhere."""
    import torch
    from ggnn_tpu_torch.models.ggnn import fuse_gru
    from ggnn_tpu_torch.ops import scatter as S
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout.block_meta is None:
        kw, arrs = S.tile_args(layout), ()
    else:
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
    if arrs:
        x["a"] = x["init"] + S.typed_block_scatter_reference(
            x["h_pack"], *arrs, x["msg_w"], **kw)
    else:
        x["a"] = x["init"] + S.typed_onehot_scatter_reference(
            x["h_pack"], msg_w=x["msg_w"], **kw)
        if a_max is not None:
            s = 0.5 * a_max / x["a"].abs().max().item()
            x["h_pack"] = (x["h_pack"].float() * s).to(dtype)
            x["init"] = x["init"] * s
            x["a"] = x["init"] + S.typed_onehot_scatter_reference(
                x["h_pack"], msg_w=x["msg_w"], **kw)
            if x["a"].abs().max().item() > a_max:
                raise AssertionError("the scaled inputs exceed |a| ≤ a_max")
    return x


def tile_bound(x, kw, dtype):
    """The per-element bound of |typed_onehot_scatter − its plain version|
    (see the tolerances above): 2e-5 of the plain version on |h_pack| and
    |msg_w|, and in bf16 2**-7 (one ulp) of every tile's rounded one-hot
    sum of three or more terms, times |W_t|, added to its block's rows as
    the plain version adds the tile."""
    import torch
    from ggnn_tpu_torch.ops import scatter as S
    h_pack, msg_w = x["h_pack"], x["msg_w"]
    bound = 2e-5 * S.typed_onehot_scatter_reference(
        h_pack.abs(), msg_w=msg_w.abs(), **kw)
    if dtype == torch.float32:
        return bound
    dev = h_pack.device
    real = kw["tile_msg_off"] >= 0
    cols, rows128 = (torch.arange(kw["tile_e"], device=dev),
                     torch.arange(128, device=dev))
    for t in range(msg_w.shape[0]):
        sel = torch.nonzero(real & (kw["tile_type"] == t)).flatten()
        n = sel.numel()
        if n == 0:
            continue
        d = kw["dstl"].long()[kw["c_off"].long()[sel]]
        valid = d >= 0
        src = (kw["tile_msg_off"].long()[sel, None] * kw["align"]
               + cols)[valid]
        tgt = (torch.arange(n, device=dev)[:, None] * 128 + d)[valid]
        p = torch.zeros(n * 128, DIM, device=dev)
        p.index_add_(0, tgt, h_pack.index_select(0, src).float())
        cnt = torch.zeros(n * 128, device=dev)
        cnt.index_add_(0, tgt, torch.ones(tgt.shape[0], device=dev))
        flips = p.to(dtype).float().abs() * (cnt >= 3).float()[:, None]
        bound.index_add_(0, (kw["block_of_tile"].long()[sel, None] * 128
                             + rows128).reshape(-1),
                         BF16_ULP * (flips @ msg_w[t].float().abs()))
        del p, cnt, flips
    return bound


def flush_bound(plain, table, ref, out_dtype):
    """The per-element bound of a reverse scatter against its plain version
    ``plain`` (a function of the table, summing into f32): 2e-5 of the sum
    over |table|, plus in bf16 one ulp of the flushed value, 2**-7·|ref|."""
    import torch
    bound = 2e-5 * plain(table.abs())
    if out_dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.float().abs()
    return bound


def scatter_bound(layout, x, dtype, fused, layout_arrays):
    """The bound of a forward typed scatter (per block or per tile) on
    inputs ``x``: every real edge's h row read once, the layout's arrays,
    W and the output rows (fused: the state, bias and GRU weights too);
    the W_t products at the bf16 tensor rate, the one-hot sums as f32
    adds, the GRU's six products."""
    import torch
    n_real = int(layout.arrays["indeg"].sum().item())
    n_rows = layout.n_blocks * 128
    esize = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (n_real * DIM * esize + nbytes(*layout_arrays, x["msg_w"])
               + n_rows * DIM * 4)
    if layout.block_meta is None:
        n_products = int((layout.arrays["tile_msg_off"] >= 0).sum().item())
    else:
        n_products = int((layout.arrays["slot_off16"] >= 0).sum().item())
    ops = [(2 * 128 * DIM * DIM * n_products, BF16_FLOPS),
           (n_real * DIM, F32_FLOPS)]
    if fused:
        n_bytes += nbytes(x["init"], x["hstate"], x["wa"], x["b3"],
                          x["uzr"], x["uh"])
        ops.append((12 * n_rows * DIM * DIM, BF16_FLOPS))
    return roofline(n_bytes, ops)


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
        same_twice("typed_block_scatter", tag, got,
                   S.typed_block_scatter(*sa, **kw))
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
        same_twice("typed_block_step_gru", tag, got,
                   S.typed_block_step_gru(*fa, **kw))
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
            n_rows = kw["n_blocks"] * 128
            cell_bound = roofline(
                nbytes(*ga) + n_rows * DIM * 4
                + 3 * n_rows * DIM * x["wa"].element_size(),
                [(12 * n_rows * DIM * DIM, BF16_FLOPS)])
            # none of the three has one PyTorch call computing it: the
            # scatters round each slot's one-hot sum before its W_t
            # product, and torch's GRU cell applies r after the U_h product
            time_pairs({
                "typed_block_scatter": (
                    lambda: S.typed_block_scatter(*sa, **kw),
                    lambda: S.typed_block_scatter_reference(*sa, **kw), None,
                    scatter_bound(layout, x, dtype, False, arrs)),
                "typed_block_step_gru": (
                    lambda: S.typed_block_step_gru(*fa, **kw),
                    lambda: S.typed_block_step_gru_reference(*fa, **kw),
                    None, scatter_bound(layout, x, dtype, True, arrs)),
                "gru_cell_fwd": (
                    lambda: G.gru_cell_fwd(*ga, mdt=dtype),
                    lambda: G.gru_cell_fwd_reference(*ga, mdt=dtype), None,
                    cell_bound),
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
        same_twice("typed_grad_octet_scatter", tag, got,
                   S.typed_grad_octet_scatter(Gp, *octs, **okw,
                                              out_dtype=dtype))
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
            n_real = int(arrs["g_indeg"].sum().item())
            octet_bound = roofline(
                n_real * DIM * Gp.element_size() + nbytes(*octs)
                + nbytes(got), [(n_real * DIM, F32_FLOPS)])
            bwd_bound = roofline(
                nbytes(g) + 5 * nbytes(args[1]) + 2 * nbytes(*w)
                + 2 * n_rows * DIM * 4 + 3 * DIM * 4,
                [(24 * n_rows * DIM * DIM, BF16_FLOPS)])
            lib = reverse_library_call(
                Gp, octet_targets(arrs, n_oct, g_tile, C, R8, Gp.shape[0]),
                n_oct * 8 * 128)
            time_pairs({
                "typed_grad_octet_scatter": (
                    lambda: S.typed_grad_octet_scatter(
                        Gp, *octs, **okw, out_dtype=dtype),
                    lambda: S.typed_grad_octet_scatter_reference(
                        Gp, *octs, **okw, out_dtype=dtype), lib,
                    octet_bound),
                # torch's GRU cell is another function (r after U_h)
                "gru_cell_bwd": (
                    lambda: G.gru_cell_bwd(*args, mdt=dtype),
                    lambda: G.gru_cell_bwd_reference(*args, mdt=dtype),
                    None, bwd_bound),
            }, timings)
        del Gp, got, ref, outs, refs, args


def check_tile_kernels(tag, layout, params, log, timings=None, a_max=None):
    """The per-tile kernels against their plain versions at a per-tile
    layout's shapes (per element; the fused step per row, scaled by the
    row's |a|, and exactly against the GRU cell kernel of the plain
    kernel's sums), and each against a second run of itself (bit-equal:
    no atomics); blocks whose only tile is a dummy must come out exactly
    0.  ``a_max``: inputs scaled so that |a| ≤ a_max."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    ts = layout.arrays["tile_start"]
    sizes = ts[1:] - ts[:-1]
    big = int(sizes.argmax().item())
    K = _build.library().ggnn_tile_split()
    print(f"[kernels] {tag}: tile_e={layout.meta[1]} n_blocks="
          f"{layout.meta[3]} tiles={int(ts[-1].item())}; the largest dst "
          f"block ({big}) holds {int(sizes[big].item())} tiles, split into "
          f"items of at most K={K}; {int((sizes > K).sum().item())} blocks "
          f"of several items; chunks "
          f"{None if layout.meta[8] is None else len(layout.meta[8])}, span "
          f"rows {layout.meta[9]}", flush=True)
    if a_max is not None and not (sizes > K).any():
        raise AssertionError(f"{tag}: no block splits into several items")
    kw = S.tile_args(layout)
    dummy = kw["block_of_tile"][kw["tile_msg_off"] < 0].long()
    for dtype in (torch.bfloat16, torch.float32):
        x = kernel_inputs(layout, dtype, params, seed=1, a_max=a_max)
        dn = str(dtype).split(".")[-1]
        sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **kw)
        fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
                  b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
        got = S.typed_onehot_scatter(**sa)
        same_twice("typed_onehot_scatter", tag, got,
                   S.typed_onehot_scatter(**sa))
        check(f"typed_onehot_scatter[{tag},{dn}]", got,
              S.typed_onehot_scatter_reference(**sa), "bound", dtype, log,
              bound=tile_bound(x, kw, dtype))
        if dummy.numel():
            if (got.reshape(-1, 128, DIM)[dummy] != 0).any():
                raise AssertionError(f"{tag}: a block with only a dummy "
                                     "tile is not 0")
            print(f"  {dummy.numel()} blocks with only a dummy tile are "
                  "exactly 0", flush=True)
        sums = got
        got = S.typed_step_gru(**fa)
        same_twice("typed_step_gru", tag, got, S.typed_step_gru(**fa))
        a_rows = x["a"].abs().amax(1).clamp_min(1.0)
        check(f"typed_step_gru[{tag},{dn}]", got,
              S.typed_step_gru_reference(**fa), "flip_rows", dtype, log,
              a_rows=a_rows)
        cell = G.gru_cell_fwd(x["hstate"], sums + x["init"], x["wa"],
                              x["b3"][0], x["uzr"], x["uh"], mdt=dtype)[0]
        torch.cuda.synchronize()
        check(f"typed_step_gru[{tag},{dn}] vs gru_cell_fwd(typed_onehot_"
              f"scatter + init)", got, cell, "same", dtype, {})
        del sums, cell
        if timings is not None and dtype == torch.bfloat16:
            arrays = [kw[k] for k in ("dstl", "tile_start", "block_of_tile",
                                      "tile_msg_off", "c_off", "tile_type")]
            # no PyTorch call computes them: each tile's one-hot sum is
            # rounded before its W_t product
            time_pairs({
                "typed_onehot_scatter": (
                    lambda: S.typed_onehot_scatter(**sa),
                    lambda: S.typed_onehot_scatter_reference(**sa), None,
                    scatter_bound(layout, x, dtype, False, arrays)),
                "typed_step_gru": (
                    lambda: S.typed_step_gru(**fa),
                    lambda: S.typed_step_gru_reference(**fa), None,
                    scatter_bound(layout, x, dtype, True, arrays)),
            }, timings)
            # the hub block's share: the same call with every other
            # block's tiles made dummies
            hub_off = torch.where(kw["block_of_tile"] == big,
                                  kw["tile_msg_off"],
                                  torch.full_like(kw["tile_msg_off"], -1))
            hub_ms = cuda_ms(lambda: S.typed_onehot_scatter(
                **dict(sa, tile_msg_off=hub_off)), 10)
            whole = timings["typed_onehot_scatter"]["ms"]
            print(f"  hub block {big} alone ({int(sizes[big].item())} of "
                  f"{int(ts[-1].item())} tiles): typed_onehot_scatter "
                  f"{hub_ms:.3f} ms, {hub_ms / whole:.3f} of the whole "
                  f"call's {whole:.3f} ms", flush=True)
        del x, got


def check_window_kernel(tag, layout, log, timings=None):
    """window_block_spmm_mono against its plain version on the legacy grad
    layout of a typed pack whose octet layout declined."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    gm = S.grad_meta(layout)
    if gm[0] == "octet":
        raise AssertionError(f"{tag}: the octet grad layout engaged")
    arrs = layout.arrays
    g_blocks, _, g_tile, _, g_align, g_chunks = gm
    ts = arrs["g_tile_start"]
    sizes = ts[1:] - ts[:-1]
    print(f"[kernels] {tag} legacy grad layout: {g_blocks} grad blocks, "
          f"{int(ts[-1].item())} tiles of {g_tile}, largest grad block "
          f"{int(sizes.max().item())} tiles, chunks "
          f"{None if g_chunks is None else len(g_chunks)}", flush=True)
    stream = (arrs["g_dstl"], arrs["g_tile_start"], arrs["g_block_of_tile"],
              arrs["g_tile_msg_off"])
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        Gp = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                         generator=gen).to(dtype)
        kw = dict(n_blocks=g_blocks, window=g_tile, win_stride=g_align,
                  out_dtype=dtype, dstl=True)
        got = W.window_block_spmm_mono(Gp, *stream, **kw)
        same_twice("window_block_spmm_mono", tag, got,
                   W.window_block_spmm_mono(Gp, *stream, **kw))
        ref = W.window_block_spmm_mono_reference(Gp, *stream, **kw)
        check(f"window_block_spmm_mono[{tag},{dn}]", got, ref, "bound", dtype, log, bound=flush_bound(
                  lambda t: W.window_block_spmm_mono_reference(
                      t, *stream, **dict(kw, out_dtype=torch.float32)),
                  Gp, ref, dtype))
        del ref
        if timings is not None and dtype == torch.bfloat16:
            n_real = int(arrs["g_indeg"].sum().item())
            bound = roofline(n_real * DIM * Gp.element_size()
                             + nbytes(*stream) + nbytes(got),
                             [(n_real * DIM, F32_FLOPS)])
            lib = reverse_library_call(
                Gp, window_targets(arrs, g_tile, g_align, g_blocks,
                                   Gp.shape[0]), g_blocks * 128)
            time_pairs({"window_block_spmm_mono": (
                lambda: W.window_block_spmm_mono(Gp, *stream, **kw),
                lambda: W.window_block_spmm_mono_reference(Gp, *stream,
                                                           **kw),
                lib, bound)}, timings)
            # the hub's share: only the grad blocks holding more than one
            # work item (the hub's source rows) keep their tiles
            K = _build.library().ggnn_tile_split()
            hub = sizes[stream[2].long()] > K
            hub_win = torch.where(hub, stream[3],
                                  torch.full_like(stream[3], -1))
            hub_ms = cuda_ms(lambda: W.window_block_spmm_mono(
                Gp, stream[0], stream[1], stream[2], hub_win, **kw), 10)
            whole = timings["window_block_spmm_mono"]["ms"]
            print(f"  the {int((sizes > K).sum().item())} grad blocks of "
                  f"more than {K} tiles alone ({int(hub.sum().item())} of "
                  f"{int(ts[-1].item())} tiles): {hub_ms:.3f} ms, "
                  f"{hub_ms / whole:.3f} of the whole call's {whole:.3f} ms",
                  flush=True)
        del Gp, got


def check_count_stream(log):
    """window_block_spmm_mono on the int8 count stream of the legacy
    layout (aligned with win_stride 16, and dense), as the legacy grad
    layout carries it when its tiles are no multiple of 16."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(11)
    src, dst, typ = (r.integers(0, 768, 5000), r.integers(0, 768, 5000),
                     r.integers(0, 3, 5000))
    for align in (16, None):
        lay = L.build_dst_block_layout(src, dst, typ, np.ones(5000, np.float32),
                                       768, tile_e=128, n_message_types=3,
                                       edge_align=align)
        win = (lay.tile_msg_off if align else
               np.arange(lay.block_of_tile.shape[0], dtype=np.int32))
        args = [torch.as_tensor(a, device=dev) for a in (
            lay.onehot, lay.tile_start, lay.block_of_tile, win)]
        for dtype in (torch.bfloat16, torch.float32):
            table = torch.randn(lay.gather_idx.shape[0], DIM,
                                device=dev).to(dtype)
            kw = dict(n_blocks=lay.n_blocks, window=128, win_stride=align,
                      out_dtype=dtype)
            got = W.window_block_spmm_mono(table, *args, **kw)
            torch.cuda.synchronize()
            ref = W.window_block_spmm_mono_reference(table, *args, **kw)
            check(f"window_block_spmm_mono[counts, stride {align},"
                  f"{str(dtype).split('.')[-1]}]", got, ref, "bound", dtype,
                  log, bound=flush_bound(
                      lambda t: W.window_block_spmm_mono_reference(
                          t, *args, **dict(kw, out_dtype=torch.float32)),
                      table, ref, dtype))


def octet_targets(arrs, n_oct, g_tile, C, R8, n_G):
    """For every row of the octet layout's cotangent pack, the output row
    it adds to (n_oct·8·128, one past the end, for rows no slot reads)."""
    import torch
    dev = arrs["g_gather_idx"].device
    off = arrs["g_slot_off16"].reshape(n_oct, 8, C).long()
    dl = (arrs["g_dstl_oct"].reshape(n_oct, R8, g_tile)[:, :8 * C]
          .reshape(n_oct, 8, C, g_tile).long())
    rows = (((arrs["g_oblk16"].long()[:, None, None] + off) * 16)[..., None]
            + torch.arange(g_tile, device=dev))
    valid = (dl >= 0) & (off[..., None] >= 0)
    blk = torch.arange(n_oct * 8, device=dev).reshape(n_oct, 8, 1, 1)
    tgt = torch.full((n_G,), n_oct * 8 * 128, dtype=torch.long, device=dev)
    tgt[rows[valid]] = (blk * 128 + dl)[valid]
    return tgt


def window_targets(arrs, window, stride, n_blocks, n_G):
    """The same for the legacy grad layout (dense dstl stream)."""
    import torch
    dev = arrs["g_gather_idx"].device
    win = arrs["g_tile_msg_off"].long()
    rows = arrs["g_dstl"][:win.shape[0]].long()
    valid = rows >= 0
    src = (win[:, None] * stride + torch.arange(window, device=dev))[valid]
    tgt = torch.full((n_G,), n_blocks * 128, dtype=torch.long, device=dev)
    tgt[src] = (arrs["g_block_of_tile"].long()[:, None] * 128 + rows)[valid]
    return tgt


def reverse_library_call(G, tgt, n_out):
    """One PyTorch call computing a reverse scatter's sums from the same
    cotangent pack: ``index_add_`` of every row of G into its output row
    (one past the end for unread rows), accumulated in G's dtype; timed as
    a yardstick only, the port never calls it."""
    import torch
    Y = torch.zeros(n_out + 1, G.shape[1], dtype=G.dtype, device=G.device)
    return lambda: Y.index_add_(0, tgt, G)


def request_graph(seed):
    """One serving request: a uniform random graph of the headline size."""
    r = np.random.default_rng(seed)
    edges = np.stack([r.integers(0, NODES, EDGES),
                      r.integers(0, EDGE_TYPES, EDGES),
                      r.integers(0, NODES, EDGES)], axis=1)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=edges, annotations=ann)


def scalefree_graph(seed):
    """One serving request: a power-law graph of the headline size, its
    endpoints drawn as the port's synthetic_batch(powerlaw_alpha=1.2) draws
    them (Zipf 1.2, nodes numbered by degree rank: node 0 is the hub)."""
    r = np.random.default_rng(seed)
    w = (np.arange(NODES, dtype=np.float64) + 1.0) ** -ZIPF
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    src = np.searchsorted(cdf, r.random(EDGES))
    dst = np.searchsorted(cdf, r.random(EDGES))
    typ = r.integers(0, EDGE_TYPES, EDGES)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=np.stack([src, typ, dst], axis=1),
                annotations=ann)


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
    msg_w = prop["msg_w"].to(cdt)
    if layout.block_meta is None:
        kw = S.tile_args(layout)
        scatter = lambda hp: S.typed_onehot_scatter_reference(
            hp, msg_w=msg_w, **kw)
    else:
        kw = S.block_args(layout)
        arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
        scatter = lambda hp: S.typed_block_scatter_reference(hp, *arrs, msg_w,
                                                             **kw)
    bias = S.bias_rows(layout, prop["msg_b"].to(cdt))
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    N, n_rows = h.shape[0], kw["n_blocks"] * 128
    with torch.inference_mode():
        for _ in range(cfg.n_steps):
            h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
            a = bias + scatter(h_pack)
            h_pad = F.pad(h, (0, 0, 0, n_rows - N))
            h = G.gru_cell_fwd_reference(h_pad, a, w_a, b_all, u_zr,
                                         prop["gru"]["uh"], mdt=cdt)[0][:N]
        return node_select_scores(params["head"], h, ann).cpu().numpy()


def stepwise_check(pred, batch, layout, tag, log):
    """Each propagation step of the served path (the per-tile kernels)
    against the plain step from the same input state, so that rounding
    differences do not compound over the steps: per row within 8 bf16
    ulps (f32: 1e-4) of max(1, max|a_row|), mean within 1e-3 in bf16."""
    import torch
    import torch.nn.functional as F
    from ggnn_tpu_torch.models.ggnn import (fuse_gru, gru_update, init_state,
                                            typed_fused_step)
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    cfg, prop = pred.cfg, pred.params["prop"]
    cdt = torch_dtype(cfg.compute_dtype)
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    uh = prop["gru"]["uh"]
    msg_w, msg_b = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    # the fused step rounds the gate inputs to cdt; the unfused one when
    # gru_matmul_compute asks for it
    mdt = (cdt if cdt != torch.float32 and (cfg.fuse_gru
                                             or cfg.gru_matmul_compute)
           else None)
    kw = S.tile_args(layout)
    bias = S.bias_rows(layout, msg_b)
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    N, n_rows = h.shape[0], kw["n_blocks"] * 128
    with torch.inference_mode():
        for t in range(cfg.n_steps):
            if cfg.fuse_gru:
                got = typed_fused_step(layout, h, msg_w, msg_b, w_a, b_all,
                                       u_zr, uh, cdt)
            else:
                a = S.aggregate_forward(h.to(cdt), layout, msg_w, msg_b)
                got = gru_update(prop["gru"], h, a, matmul_dtype=mdt)
            h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
            a_ref = bias + S.typed_onehot_scatter_reference(
                h_pack, msg_w=msg_w, **kw)
            ref = G.gru_cell_fwd_reference(
                F.pad(h, (0, 0, 0, n_rows - N)), a_ref, w_a, b_all, u_zr, uh,
                mdt=mdt)[0][:N]
            check(f"{tag} step {t}", got, ref, "flip_rows", cdt, log,
                  a_rows=a_ref[:N].abs().amax(1).clamp_min(1.0))
            h = got


def serve(params, fuse, graphs, plain_cache, per_request, tag="serve",
          stepwise=False):
    """Three requests through Predictor (host batching, layout, device
    forward), the launch counts against ``per_request`` (kernel -> launches
    per request; every other kernel 0) and every request's scores against
    the plain path.  ``stepwise`` (a power-law graph): a hub row aggregates
    |a| up to 4e5, so the rounding of its sums moves its state by about
    1e-3 even in f32, and every node reads the hub in the next step: over
    5 steps two faithful paths drift apart by percents.  Each request is
    then checked step by step (:func:`stepwise_check`), and the drift of
    its scores is reported."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(state_dim=DIM, annotation_dim=ANN,
                      n_edge_types=EDGE_TYPES, n_steps=STEPS,
                      head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=fuse)
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    pred = Predictor(cfg, spec, params=params, device="cuda")
    mode = "fused" if fuse else "unfused"
    results = []
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
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
    launches = {k: fn.launches for k, fn in wrappers.items()}
    print(f"[{tag}] {mode}: launches on the serving path {launches}",
          flush=True)
    n = len(graphs)
    want = {k: per_request.get(k, 0) * n for k in wrappers}
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
        norm = max(float(np.linalg.norm(ref)), 1e-30)
        rf = float(np.linalg.norm(scores - ref)) / norm
        if stepwise:
            stepwise_check(pred, batch, layout, f"{tag} {mode} seed={seed}",
                           {})
            ok = ok_answer = True
            crit = "reported only; checked step by step"
        else:
            ok = emax <= TOL_FLIP_MAX and emean <= TOL_FLIP_MEAN
            # the answer must be a top node of the plain path too (ties
            # within the tolerance may pick another node)
            ok_answer = ref[answer] >= ref.max() - TOL_FLIP_MAX
            crit = (f"tol {TOL_FLIP_MAX:.3e}/{TOL_FLIP_MEAN:.0e}")
        rate = 2 * EDGES * STEPS / dev_s
        print(f"[{tag}] {mode} request seed={seed}: answer node {answer} "
              f"(plain argmax {int(np.argmax(ref))}), scores max_abs_err "
              f"{emax:.3e} mean_abs_err {emean:.3e} rel_frobenius {rf:.3e} "
              f"({crit}) {'ok' if ok and ok_answer else 'FAIL'}; latency "
              f"{prep_s + dev_s:.3f} s = host batch+layout {prep_s:.3f} s + "
              f"device forward {dev_s * 1e3:.2f} ms; "
              f"{rate:.4e} directed-edges*T/s", flush=True)
        if not (ok and ok_answer):
            raise AssertionError(f"{mode} request {seed}: scores disagree "
                                 "with the plain path")
    return launches


def kernel_wrappers():
    """The eight kernel wrappers by name (each counts its launches)."""
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    return {"typed_block_scatter": S.typed_block_scatter,
            "typed_block_step_gru": S.typed_block_step_gru,
            "gru_cell_fwd": G.gru_cell_fwd, "gru_cell_bwd": G.gru_cell_bwd,
            "typed_grad_octet_scatter": S.typed_grad_octet_scatter,
            "typed_onehot_scatter": S.typed_onehot_scatter,
            "typed_step_gru": S.typed_step_gru,
            "window_block_spmm_mono": W.window_block_spmm_mono}


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain versions (the same
    function, the same rounding points) for the plain path on the card."""
    from ggnn_tpu_torch.models import ggnn as M
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    swaps = [(S, "typed_block_scatter", S.typed_block_scatter_reference),
             (S, "typed_grad_octet_scatter",
              S.typed_grad_octet_scatter_reference),
             (S, "typed_onehot_scatter", S.typed_onehot_scatter_reference),
             (S, "window_block_spmm_mono",
              W.window_block_spmm_mono_reference),
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


def train_headline(batch, layout, modes, tag="train", f32_check=True,
                   stepwise=False):
    """Three Adam steps of the headline model per mode through
    make_train_step; ``modes``: mode -> (config fields, kernel -> launches
    per step; every other kernel 0).  The first step is held to the plain
    path.  ``stepwise`` (a power-law graph): a hub row's GRU sees |a| up to
    4e5, whose rounding decides which of its gates sit off saturation, and
    the hub's cotangent reaches every node; the gradients of 5 steps of two
    faithful paths then differ by O(1) there, so only the loss is held to
    the plain path, the gradients are reported, and the aggregation's VJP
    is held to it instead (:func:`vjp_aggregate_check`).  Returns the
    launch counts of those runs."""
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
    total = dict.fromkeys(KERNELS, 0)
    for mode, (extra, per_step) in modes.items():
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
        print(f"[{tag}] {mode}: losses {[f'{x:.6f}' for x in losses]}; "
              f"step ms {[f'{x:.2f}' for x in ms]} (median "
              f"{statistics.median(ms):.2f}, spread {max(ms) - min(ms):.2f}); "
              f"peak device memory {peak:.2f} GiB; launches over 3 steps "
              f"{launches}", flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {mode}: non-finite loss {losses}")
        want = {k: per_step.get(k, 0) * 3 for k in wrappers}
        if launches != want:
            raise AssertionError(f"train {mode}: launches {launches}, "
                                 f"expected {want}")
        for k in total:
            total[k] += launches[k]
        compare_first_step(f"{tag} {mode}", cfg, arrays, layout, grads1,
                           losses[0], strict=not stepwise)
        if stepwise:
            vjp_aggregate_check(f"{tag} {mode}", cfg, arrays, layout)
        del params, opt, step, grads1
        torch.cuda.empty_cache()
    if f32_check:
        # the same first step in f32 (fused: the scatter and reverse
        # scatter kernels in f32), where nothing rounds to bf16, against
        # its plain path
        cfg = headline_cfg(compute_dtype="float32", fuse_gru=True)
        params = fresh_params(cfg)
        loss, _ = loss_and_metrics(params, cfg, arrays, 1,
                                   scatter_layout=layout)
        grads = dict(zip([k for k, _ in _flatten(params)],
                         torch.autograd.grad(loss, param_leaves(params))))
        compare_first_step(f"{tag} fused f32", cfg, arrays, layout, grads,
                           float(loss.detach()))
    return total


def compare_first_step(mode, cfg, arrays, layout, grads, loss_k,
                       strict=True):
    """The first step's loss and gradient leaves against the same step
    through the kernels' plain versions on the card (``strict=False``: the
    loss is held to its bound, the gradients reported only)."""
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
          f"{total:.4e} (tol {TOL_SYMMETRIC:.0e}) "
          f"{('ok' if ok else 'FAIL') if strict else '(reported only)'}",
          flush=True)
    if not strict:
        ok = dl <= tol_loss
    if not ok:
        raise AssertionError(f"train {mode}: first step disagrees with the "
                             "plain path")


def grad_row_terms(layout, n_nodes, T2):
    """The number of cotangent rows the legacy grad layout sums into each
    node's row of dh (over all message types)."""
    import torch
    from ggnn_tpu_torch.ops import scatter as S
    arrs = layout.arrays
    if "g_dstl" not in arrs:
        raise AssertionError("the legacy grad layout has no g_dstl stream")
    win = arrs["g_tile_msg_off"].long()
    rows = arrs["g_dstl"][:win.shape[0]].long()
    valid = (rows >= 0) & (win >= 0)[:, None]
    cnt = torch.zeros(S.grad_meta(layout)[0] * 128, device=rows.device)
    idx = (arrs["g_block_of_tile"].long()[:, None] * 128 + rows)[valid]
    cnt.index_add_(0, idx, torch.ones(idx.shape[0], device=rows.device))
    return (cnt[:T2 * n_nodes].reshape(n_nodes // 128, T2, 128).sum(1)
            .reshape(n_nodes))


def vjp_aggregate_check(mode, cfg, arrays, layout):
    """The aggregation's VJP through the kernels (the per-tile forward and
    the reverse scatter of the legacy grad layout) against the same VJP
    through their plain versions, from the same input state (the kernel
    path's state after two steps) and the same random cotangent: dh, dW
    and db within TOL_TRAIN's relative Frobenius bound, and dh per row over
    the rows of at most HUB_TERMS terms (see the tolerances above).  The
    aggregation is linear, so this holds the kernels to the plain path
    where the GRU of a hub row cannot (see :func:`train_headline`)."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import scatter as S
    params = fresh_params(cfg)
    prop = params["prop"]
    cdt = torch_dtype(cfg.compute_dtype)
    edges = [arrays[k] for k in ("edge_src", "edge_dst", "edge_type",
                                 "edge_mask")]
    with torch.no_grad():
        h_in = propagate(prop, dataclasses.replace(cfg, n_steps=2),
                         arrays["annotations"], *edges,
                         scatter_layout=layout)
    gen = torch.Generator(device="cuda").manual_seed(5)
    da = torch.randn(h_in.shape, device="cuda", generator=gen)

    def grads():
        xs = [t.detach().to(cdt).requires_grad_(True)
              for t in (h_in, prop["msg_w"], prop["msg_b"])]
        out = S.aggregate_onehot(*xs[:1], layout, *xs[1:])
        return torch.autograd.grad((out * da).sum(), xs)

    got = grads()
    with plain_versions():
        ref = grads()
    tol = TOL_TRAIN[cfg.compute_dtype][0]
    tol_rows = TOL_RELF_BF16 if cdt == torch.bfloat16 else TOL_RELF_F32
    errs = [(relfro(a, b), k) for k, a, b in zip(("dh", "dW", "db"), got,
                                                  ref)]
    terms = grad_row_terms(layout, h_in.shape[0], prop["msg_w"].shape[0])
    small = terms <= HUB_TERMS
    dh, dh_ref = got[0][small].double(), ref[0][small].double()
    row_err = ((dh - dh_ref).norm(dim=1)
               / dh_ref.norm(dim=1).clamp_min(1e-30)).max().item()
    rows_rf = relfro(dh, dh_ref)
    ok = (max(errs)[0] <= tol and row_err <= tol and rows_rf <= tol_rows
          and all(torch.isfinite(a).all() for a in got))
    print(f"[train] {mode} the aggregation's VJP vs plain path (input state "
          f"after 2 steps, random cotangent): rel_frobenius "
          + ", ".join(f"{k} {e:.3e}" for e, k in errs)
          + f" (tol {tol:.3e}); dh over the {int(small.sum())} rows of at "
          f"most {HUB_TERMS} terms (of {small.numel()}, up to "
          f"{int(terms.max())}): worst row {row_err:.3e} (tol {tol:.3e}), "
          f"rel_frobenius {rows_rf:.3e} (tol {tol_rows:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"train {mode}: the aggregation's VJP disagrees "
                             "with the plain path")


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


def scalefree_phase(params, log, timings):
    """[scalefree]: the headline model on a power-law graph of the headline
    size, where block mode and the octet grad layout decline: the per-tile
    kernels and the window kernel against their plain versions (fuzz
    layouts and the headline), timed; three requests served fused and
    unfused; 3 Adam steps trained fused and unfused.  Returns the launch
    counts of the serving and training runs."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    r = np.random.default_rng(9)
    fuzz = {
        # tag: (nodes, edges, types, dst range, hub, layout kwargs)
        "block_mode_off": (640, 9000, 6, 640, False, dict(block_mode=False)),
        "span": (640, 9000, 5, 640, False, dict(block_mode=False,
                                                span_mode=True)),
        "small_chunk_cap": (640, 9000, 5, 640, False,
                            dict(block_mode=False, smem_tile_cap=5)),
        "empty_blocks_tiles": (1024, 3000, 4, 512, False,
                               dict(block_mode=False)),
        "hub": (4096, 60000, 4, 4096, True, dict(tile_e=128,
                                                 grad_tile_e=128)),
    }
    for tag, (n, e, t2, dst_hi, hub, kw) in fuzz.items():
        src, dst = r.integers(0, n, e), r.integers(0, dst_hi, e)
        if hub:     # most edges into 64 dst rows and out of 16 src rows
            dst = np.where(r.random(e) < 0.9, r.integers(0, 64, e), dst)
            src = np.where(r.random(e) < 0.9, r.integers(0, 16, e), src)
        lay = build_typed_dst_layout(
            src, dst, r.integers(0, t2, e),
            (r.random(e) < 0.9).astype(np.float32), n, t2, with_grad=True,
            **kw)
        if lay.block_meta is not None or lay.meta[5][0] == "octet":
            raise AssertionError(f"{tag}: block mode or the octet layout "
                                 "engaged")
        lay = lay.to("cuda")
        check_tile_kernels(tag, lay, params, log)
        if hub:     # the split blocks' fused epilogue at 8 ulps per row
            check_tile_kernels(f"{tag}, |a| <= 1", lay, params, log,
                               a_max=1.0)
        check_window_kernel(tag, lay, log)
    check_count_stream(log)

    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128, powerlaw_alpha=ZIPF)
    t1 = time.perf_counter()
    lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                 b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES,
                                 with_grad=True)
    t2 = time.perf_counter()
    chunks = lay.meta[8]
    print(f"[scalefree] Zipf {ZIPF} batch made in {t1 - t0:.2f} s; typed "
          f"layout with its grad half built on the host in {t2 - t1:.2f} s; "
          f"tile_e {lay.meta[1]}, block mode {lay.meta[10]}, span rows "
          f"{lay.meta[9]}, chunks {chunks}, grad_meta {lay.meta[5]}",
          flush=True)
    if lay.block_meta is not None or lay.meta[5][0] == "octet" \
            or chunks is None or len(chunks) < 2:
        raise AssertionError("scalefree: block mode or the octet layout "
                             "engaged, or the layout is not chunked")
    lay = lay.to("cuda")
    check_tile_kernels("scalefree", lay, params, log, timings)
    check_window_kernel("scalefree", lay, log, timings)
    torch.cuda.empty_cache()

    graphs = [(seed, scalefree_graph(seed)) for seed in (0, 1, 2)]
    plain_cache = {}
    launched = dict.fromkeys(KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    for fuse, per_request in (
            (True, {"typed_step_gru": STEPS}),
            (False, {"typed_onehot_scatter": STEPS, "gru_cell_fwd": STEPS})):
        for k, v in serve(params, fuse, graphs, plain_cache, per_request,
                          tag="scalefree serve", stepwise=True).items():
            launched[k] += v
    print(f"[scalefree serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del graphs, plain_cache
    torch.cuda.empty_cache()

    fused = {"typed_onehot_scatter": STEPS, "window_block_spmm_mono": STEPS}
    unfused = dict(fused, gru_cell_fwd=STEPS, gru_cell_bwd=STEPS)
    trained = train_headline(b, lay, {
        "fused": (dict(fuse_gru=True), fused),
        "unfused": (dict(fuse_gru=False), unfused)},
        tag="scalefree train", f32_check=False, stepwise=True)
    for k, v in trained.items():
        launched[k] += v
    del lay, b
    torch.cuda.empty_cache()
    return launched


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
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
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
    launched = dict.fromkeys(KERNELS, 0)
    for fuse, per_request in (
            (True, {"typed_block_step_gru": STEPS}),
            (False, {"typed_block_scatter": STEPS, "gru_cell_fwd": STEPS})):
        for k, v in serve(params, fuse, graphs, plain_cache,
                          per_request).items():
            launched[k] += v
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del graphs, plain_cache
    torch.cuda.empty_cache()

    fused = {"typed_block_scatter": STEPS, "typed_grad_octet_scatter": STEPS}
    unfused = dict(fused, gru_cell_fwd=STEPS, gru_cell_bwd=STEPS)
    trained = train_headline(b, lay, {
        "fused": (dict(fuse_gru=True), fused),
        "fused+lean": (dict(fuse_gru=True, lean_residuals=True), fused),
        "unfused": (dict(fuse_gru=False), unfused)})
    del lay, b
    torch.cuda.empty_cache()
    for k, v in trained.items():
        launched[k] += v
    run_trainer()

    for k, v in scalefree_phase(params, log, timings).items():
        launched[k] += v
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    if any(m == "ggnn_tpu" or m.startswith("ggnn_tpu.") for m in sys.modules):
        raise AssertionError("the port imported the JAX package")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if launched[name] == 0:
            raise AssertionError(f"{name} was never launched on a main path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launched[name],
                            max_abs_err=max(log[name]), **timings[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
