"""Where the time of kernels #13 and #14 goes, on one NVIDIA GPU (H100):
variants of their sources with one part switched off, each timed at the
community headline.

    python3 scripts/torch_window_step_variants.py

Each variant is ``csrc/window_step_fused.cuh`` or
``csrc/window_bwd_fused.cu`` (with the headers of ``csrc/``) after a few
textual edits (``VARIANTS`` below), compiled with a small C entry by nvcc
for sm_90a into ``ggnn_tpu_torch/_build/variants_window/<name>/`` (one
nvcc per variant, all started together) and loaded with ctypes.  The base
variants must give the library's bits; the others change the result and
are only timed.  Timed with CUDA events (10 launches after a warm-up,
two rounds):

- #13 (bf16, D = 128) on window_community's layout (on-demand, W 512,
  block_rows 512: clusters of 4 CTAs) and its emit_res form on
  window_community_train's: ``nocount`` drops the count copies,
  ``nobuild`` the on-demand build and its inputs' copies (the windows in
  the scratch are then stale), ``nomma`` the
  count product, ``noepi`` the GRU epilogue (the sums are stored instead),
  ``stores`` runs only the epilogue (no tile: the GRU of init and its
  stores), and that without the gates' sigmoid and tanh
  (``stores_nogates``), the init loads (``stores_noinit``) or the h'
  stores (``stores_noout``);
- #14 (bf16, D = 128) on window_community_train's layout, exact and int8
  ā: ``nocount``, ``nopush`` (no āᵀ rows to the other CTAs of the
  cluster), ``nodh`` (no cluster sum and read-modify-write of dhᵀ),
  ``nodw`` (no dWᵀ product and store); ``first`` is the first version
  (window_bwd.cu's body at NP = 1) and ``first_normw`` that version
  without its per-slab read-modify-write of the dWᵀ workspace; at D = 256
  ``first`` (its instantiation for two panels, NP = 2) against
  ``first_np0``, the runtime panel count.

Prints ptxas's registers and spills per variant, the times (ms), and the
card's nvidia-smi line last.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ggnn_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_window")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
NODES, EDGES, EDGE_TYPES, DIM = 262_144, 4_000_000, 8, 128

STEP, BWD, OLD = "window_step_fused.cuh", "window_bwd_fused.cu", \
    "window_bwd.cu"
STEP_ENTRY = """#include "window_step_fused.cuh"
extern "C" int variant(int src, int res, const void* table, long long n_table,
    const void* counts, long long n_c, const void* tile_start,
    const void* win_of_tile, const void* c_off, int n_blocks, int out_rows,
    int window, const void* scales, const void* wbank, const void* bbank,
    int T2, const void* init, const void* hstate, const void* wa,
    const void* b3, const void* uzr, const void* uh, void* out, void* rs,
    void* scr, void* stream) {
#define GO(S, R) return ggnn::wstep::launch_window_step_fused<S, R, false>( \\
    table, n_table, counts, n_c, tile_start, win_of_tile, c_off, n_blocks, \\
    out_rows, window, scales, wbank, bbank, T2, init, hstate, wa, b3, uzr, \\
    uh, out, rs, scr, ggnn::wstep::Items{}, static_cast<cudaStream_t>(stream))
  if (src == 2 && res) GO(2, true);
  if (src == 2) GO(2, false);
  return 1;
}
"""
BWD_ENTRY = """#include "window_bwd_fused.cu"
extern "C" int variant(int quant, const void* dat, const void* scales,
    long long n_cols, const void* counts, const void* walk, const void* goff,
    int BR, int W, int T2, int n_src_blocks, int group, const void* msg_w,
    const void* h, void* dht, void* ws, void* stream) {
  return ggnn::launch_window_bwd_fused(quant, dat, scales, n_cols, counts,
      walk, goff, BR, W, T2, n_src_blocks, group, msg_w, h, dht, ws,
      static_cast<cudaStream_t>(stream));
}
"""
# the first version: window_bwd.cu's own entry, with bf16 D = 128 kept on
# its body
OLD_ENTRY = """#include "window_bwd.cu"
#include "window_bwd_fused.cu"
"""
FIRST = (OLD, "if (dtype == 1 && P == 1 && (W == 128",
         "if (false && dtype == 1 && P == 1 && (W == 128")
NOCOUNT13 = (STEP, "cp16(cd + r * kLd8 + v * 16, C + size_t(r) * window + "
             "v * 16, true);", ";")
NOBUILD = [(STEP, "        build(cur, j, j & 1, 0);\n", ""),
           (STEP, "        if (nxt >= 0) build(nxt, j, j & 1, (i + 1) & 1);\n",
            ""),
           (STEP, "      fetch_h(cur);\n      fetch_wpiece(cur, 0, 0);\n", ""),
           (STEP, "        fetch_h(nxt);\n        fetch_wpiece(nxt, 0, 0);\n",
            ""),
           (STEP, "if (j + 1 < nch) fetch_wpiece(cur, j + 1, (j + 1) & 1);",
            ";"),
           (STEP, "if (nxt >= 0) fetch_wpiece(nxt, j + 1, (j + 1) & 1);",
            ";")]
NOMMA13 = (STEP, "mma_counts_bf16(acc, C, reinterpret_cast<const bf16*>"
           "(bbuf(bst)));", ";")
NOEPI = (STEP, "  // --- the GRU epilogue -------",
         """#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[(orow0 + TA::row(mi, e)) * 128 + TA::col(ni, e)] = acc[mi][ni][e];
  if (out) return;
  // --- the GRU epilogue -------""")
STORES = (STEP, "    int cur = next_tile();", "    int cur = -1;")
NOGATES = [(STEP, "sigmoid_f(", "(", "all"), (STEP, "tanhf(", "(", "all")]
NOINIT = (STEP, "        acc[mi][ni][e] =\n            init ?",
          "        acc[mi][ni][e] =\n            0 ?")
NOOUT = (STEP, "    reinterpret_cast<float4*>(orow + r * 128)[v] =",
         "    if (r < 0) reinterpret_cast<float4*>(orow + r * 128)[v] =")
NOCOUNT14 = (BWD, "      cp16(cd + (QUANT ? perm_s8(k) : k) * kLd8 + "
             "v * 16,\n           C + size_t(k) * W + v * 16, true);", ";")
NOPUSH = (BWD, "        push_block(abuf(st), QUANT ? kLd8 : kLd * 2, q * pf, "
          "pf, 0,\n                   QUANT ? 128 : 256, S, q);", "")
NODH = (BWD, "          reinterpret_cast<float4*>(dcol + (rows0 + dd) * N)[v] = "
        "sum;", "          if (j < 0) reinterpret_cast<float4*>(dcol + "
        "(rows0 + dd) * N)[v] = sum;")
NODW = [(BWD, "        mma_bf16<8>(dw, YS, kLd, HS, kLd);", ""),
        (BWD, "          *reinterpret_cast<float2*>(part + TS::row(mi, e) "
              "* 128 +", "          if (j < 0) *reinterpret_cast<float2*>("
              "part + TS::row(mi, e) * 128 +")]
NORMW = [(OLD, "            wacc[nt][e] =\n                "
               "part[size_t(row0 + frag_row(e)) * D + frag_col(nt, e)];",
          "            wacc[nt][e] = 0.0f;"),
         (OLD, "            part[size_t(row0 + frag_row(e)) * D + "
               "frag_col(nt, e)] =\n                wacc[nt][e];",
          "            if (t < 0) part[size_t(row0 + frag_row(e)) * D + "
          "frag_col(nt, e)] = wacc[nt][e];")]
NP0 = (OLD, "    if (P == 2) GGNN_LAUNCH(T, Q, 2); \\\n", "")
# name -> (entry, [(file, old, new)])
VARIANTS = {
    "step_base": (STEP_ENTRY, []),
    "step_nocount": (STEP_ENTRY, [NOCOUNT13]),
    "step_nobuild": (STEP_ENTRY, NOBUILD),
    "step_nomma": (STEP_ENTRY, [NOMMA13]),
    "step_noepi": (STEP_ENTRY, [NOEPI]),
    "step_stores": (STEP_ENTRY, [STORES]),
    "step_stores_nogates": (STEP_ENTRY, [STORES] + NOGATES),
    "step_stores_noinit": (STEP_ENTRY, [STORES, NOINIT]),
    "step_stores_noout": (STEP_ENTRY, [STORES, NOOUT]),
    "bwd_base": (BWD_ENTRY, []),
    "bwd_nocount": (BWD_ENTRY, [NOCOUNT14]),
    "bwd_nopush": (BWD_ENTRY, [NOPUSH]),
    "bwd_nodh": (BWD_ENTRY, [NODH]),
    "bwd_nodw": (BWD_ENTRY, NODW),
    "bwd_first": (OLD_ENTRY, [FIRST]),
    "bwd_first_normw": (OLD_ENTRY, [FIRST] + NORMW),
    "bwd_first_np0": (OLD_ENTRY, [FIRST, NP0]),
}


def build(name, entry, edits):
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(CSRC, f), d)
    for f, old, new, *every in edits:
        p = os.path.join(d, f)
        with open(p) as fh:
            s = fh.read()
        if old not in s:
            raise RuntimeError(f"{name}: edit not found in {f}: {old!r}")
        with open(p, "w") as fh:
            fh.write(s.replace(old, new, -1 if every else 1))
    src = os.path.join(d, "variant.cu")
    with open(src, "w") as fh:
        fh.write(entry)
    so = os.path.join(d, "libvariant.so")
    from torch.utils.cpp_extension import CUDA_HOME
    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *FLAGS,
                          "-o", so, src], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return so, regs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_window_step_variants: no CUDA device", file=sys.stderr)
        return 2
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import window as W
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, e, ed)
                for n, (e, ed) in VARIANTS.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib_f.result()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for n, (_, regs) in libs.items():
        print(f"  {n}: " + " | ".join(regs[-4:]))
    dev = torch.device("cuda")
    T2 = 2 * EDGE_TYPES
    gen = torch.Generator(device=dev).manual_seed(19)
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=8, seed=0,
                        node_mult=128, n_communities=512, p_intra=0.95)
    P = ctypes.c_void_p
    ptr = _build.ptr

    def rnd(*shape, scale=DIM ** -0.5):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    w = rnd(T2, DIM, DIM).to(torch.bfloat16)
    bias = rnd(T2, DIM, scale=0.1)
    wa, b3 = rnd(DIM, 3 * DIM).to(torch.bfloat16), rnd(3 * DIM, scale=0.1)
    uzr, uh = rnd(DIM, 2 * DIM).to(torch.bfloat16), rnd(DIM, DIM).to(
        torch.bfloat16)
    times = {}

    def timed(name, fn):
        ms = []
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            for _ in range(10):
                fn()
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]) / 10)
        times[name] = ms
        print(f"  {name}: {ms[0]:.3f} / {ms[1]:.3f} ms", flush=True)

    for res_form, grad in ((False, False), (True, True)):
        lay = W.build_window_layout(
            b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
            window=512, n_message_types=T2, block_rows=512, typed_spill=True,
            on_demand=True, row_major="block", with_grad=grad).to("cuda")
        a = lay.arrays
        n_rows = lay.n_blocks * 512
        h = torch.rand(n_rows, DIM, device=dev, generator=gen) * 2 - 1
        hc = h[:lay.n_nodes_pad].to(torch.bfloat16).contiguous()
        init = rnd(n_rows, DIM, scale=0.3)
        out = torch.empty(n_rows, DIM, device=dev)
        rs = (torch.empty(n_rows, 4 * DIM, dtype=torch.bfloat16, device=dev)
              if res_form else None)
        scr = torch.empty(lay.n_blocks, 2 * 512, DIM, dtype=torch.bfloat16,
                          device=dev)
        ref = W.window_step_gru(
            hc, a["c_stream"], a["tile_start"], a["block_of_tile"],
            a["win_of_tile"], init, h, wa, b3[None], uzr, uh,
            n_blocks=lay.n_blocks, window=512, out_rows=512,
            c_off=a["c_off"], msg_w=w, msg_b=bias, emit_res=res_form)
        if res_form:
            ref = ref[0]
        tag = "emit_res" if res_form else "on-demand"
        for n, (so, _) in libs.items():
            if not n.startswith("step_"):
                continue
            lib = ctypes.CDLL(so)
            lib.variant.argtypes = ([ctypes.c_int, ctypes.c_int, P,
                                     ctypes.c_longlong, P, ctypes.c_longlong]
                                    + [P] * 3 + [ctypes.c_int] * 3 + [P] * 3
                                    + [ctypes.c_int] + [P] * 10)
            args = (2, int(res_form), ptr(hc), hc.shape[0],
                    ptr(a["c_stream"]), a["c_stream"].shape[0] // 512,
                    ptr(a["tile_start"]), ptr(a["win_of_tile"]),
                    ptr(a["c_off"]), lay.n_blocks, 512, 512, None, ptr(w),
                    ptr(bias), T2, ptr(init), ptr(h), ptr(wa), ptr(b3),
                    ptr(uzr), ptr(uh), ptr(out), ptr(rs), ptr(scr))

            def go(lib=lib, args=args):
                err = lib.variant(*args,
                                  torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{n}: launch error {err}")
            go()
            torch.cuda.synchronize()
            if n == "step_base" and not torch.equal(out, ref):
                raise AssertionError(f"step_base [{tag}] differs from the "
                                     "library's kernel")
            timed(f"13 {tag} {n}", go)
        del lay, a, h, hc, init, out, rs, scr, ref
        torch.cuda.empty_cache()

    lay = W.build_window_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        window=512, n_message_types=T2, block_rows=512, typed_spill=True,
        on_demand=True, row_major="block", with_grad=True).to("cuda")
    a = lay.arrays
    N = lay.n_nodes_pad
    da = rnd(lay.n_blocks * 512, DIM, scale=1.0)
    hb = (torch.rand(N, DIM, device=dev, generator=gen) * 2 - 1).to(
        torch.bfloat16)
    n_src = N // 128
    for quant in (False, True):
        if quant:
            q, sc = W.quantize_grad_pow2(da, 512)
            da_t = q.t().contiguous()
        else:
            da_t, sc = da.to(torch.bfloat16).t().contiguous(), None
        ref = W.window_bwd_fused(da_t, a["c_stream"], a["gt_tile_start"],
                                 a["gt_block_of_tile"], a["gt_win_of_tile"],
                                 a["gt_c_off"], w, hb,
                                 n_wins=lay.grad_meta[0], window=512,
                                 out_rows=512, t2=T2, da_scales=sc)
        slots = _build.library().ggnn_window_bwd_slots(int(quant), 4)
        tag = "int8" if quant else "exact"
        for n, (so, _) in libs.items():
            if not n.startswith("bwd_") or n == "bwd_first_np0":
                continue
            first = n.startswith("bwd_first")
            group, n_groups = W.bwd_groups(n_src, 2 * 132 if first
                                           else slots)
            dht = torch.empty(DIM, N, device=dev)
            ws = torch.zeros(n_groups, T2, DIM, DIM, device=dev)
            dwt = torch.empty(T2, DIM, DIM, device=dev)
            lib = ctypes.CDLL(so)
            fn = lib.ggnn_window_bwd if first else lib.variant
            n_c = a["c_stream"].shape[0] // 512
            if first:
                fn.argtypes = ([ctypes.c_int] * 2 + [P] * 2
                               + [ctypes.c_longlong, P, ctypes.c_longlong]
                               + [P] * 3 + [ctypes.c_int] * 7 + [P] * 8)
                args = (1, int(quant), ptr(da_t), ptr(sc), da_t.shape[1],
                        ptr(a["c_stream"]), n_c, ptr(a["gt_tile_start"]),
                        ptr(a["gt_win_of_tile"]), ptr(a["gt_c_off"]),
                        lay.n_blocks, 512, 512, T2, n_src, group, DIM,
                        ptr(w), ptr(hb), ptr(dht), ptr(ws), ptr(dwt), None,
                        None)
            else:
                walk, goff = W.bwd_walk(
                    a["gt_tile_start"], a["gt_win_of_tile"], a["gt_c_off"],
                    int(a["gt_tile_start"][-1]), lay.n_blocks, n_c, T2 // 4,
                    group, n_groups)
                fn.argtypes = ([ctypes.c_int] + [P] * 2
                               + [ctypes.c_longlong] + [P] * 3
                               + [ctypes.c_int] * 5 + [P] * 5)
                args = (int(quant), ptr(da_t), ptr(sc), da_t.shape[1],
                        ptr(a["c_stream"]), ptr(walk), ptr(goff), 512, 512,
                        T2, n_src, group, ptr(w), ptr(hb), ptr(dht),
                        ptr(ws))

            def go(fn=fn, args=args):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{n}: launch error {err}")
            go()
            torch.cuda.synchronize()
            if n == "bwd_base" and not torch.equal(dht, ref[0]):
                raise AssertionError(f"bwd_base [{tag}] differs from the "
                                     "library's kernel")
            timed(f"14 {tag} {n}", go)
    # the first version at D = 256: NP = 2 against NP = 0
    D2 = 2 * DIM
    w2 = (torch.randn(T2, D2, D2, device=dev, generator=gen)
          * D2 ** -0.5).to(torch.bfloat16)
    h2 = (torch.rand(N, D2, device=dev, generator=gen) * 2 - 1).to(
        torch.bfloat16)
    da2 = torch.randn(lay.n_blocks * 512, D2, device=dev,
                      generator=gen).to(torch.bfloat16).t().contiguous()
    group, n_groups = W.bwd_groups(n_src, 2 * 132)
    got = {}
    for n in ("bwd_first", "bwd_first_np0"):
        fn = ctypes.CDLL(libs[n][0]).ggnn_window_bwd
        fn.argtypes = ([ctypes.c_int] * 2 + [P] * 2
                       + [ctypes.c_longlong, P, ctypes.c_longlong]
                       + [P] * 3 + [ctypes.c_int] * 7 + [P] * 8)
        dht = torch.empty(D2, N, device=dev)
        ws = torch.zeros(n_groups, T2, D2, D2, device=dev)
        dwt = torch.empty(T2, D2, D2, device=dev)
        args = (1, 0, ptr(da2), None, da2.shape[1], ptr(a["c_stream"]),
                a["c_stream"].shape[0] // 512, ptr(a["gt_tile_start"]),
                ptr(a["gt_win_of_tile"]), ptr(a["gt_c_off"]), lay.n_blocks,
                512, 512, T2, n_src, group, D2, ptr(w2), ptr(h2), ptr(dht),
                ptr(ws), ptr(dwt), None, None)

        def go(fn=fn, args=args, ws=ws):
            ws.zero_()
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{n}: launch error {err}")
        go()
        torch.cuda.synchronize()
        got[n] = dht.clone()
        timed(f"14 exact D=256 {n}", go)
    if not torch.equal(got["bwd_first"], got["bwd_first_np0"]):
        print("  D=256: NP = 0 and NP = 2 differ in their bits", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
