"""Where the time of #11 ``window_block_spmm_mono`` and #8
``onehot_segment_scatter_flat`` in bf16 at D = 128 goes
(``csrc/window_mono_fused.cu`` on ``csrc/mono_pipe.cuh``), on one NVIDIA
GPU (H100), and the parent's kernels against this tree's in one process.

    python3 scripts/torch_mono_variants.py [--parent DIR]

Each kernel variant is ``window_mono_fused.cu`` after a few textual edits
(``VARIANTS`` below), compiled by nvcc for sm_90a into
``ggnn_tpu_torch/_build/variants_mono/<name>/`` (one nvcc per variant, all
started together) and loaded with ctypes; its entry point is the source's
own (``ggnn_mono_fused``), called on the plan the tree's
``ops/window.py::mono_plan`` makes.  Each but ``no_convert`` must give
the library's bits (each work item's sums run in the same order in all of
them):

- ``one_cta_reduce``: a split block's partials summed by one CTA a block
  (the first body's reduce) instead of ``partial_sum.cuh``'s 16 CTAs;
- ``stages_swapped``: the dst-local form on a ring of two stages and the
  count form on three (the tree: three and two);
- ``no_swizzle``: the table rows stored unswizzled (ldmatrix.trans then
  reads 8 rows of one chunk from one bank group);
- ``no_prefetch``: a stage's copies issued after the previous stage's
  products, not during them;
- ``direct_store``: a bf16 output block stored from the fragments (4-byte
  pairs, half of each 32-byte sector a store) instead of through shared
  memory in 16-byte stores;
- ``no_convert``: the count bytes taken as bf16 bits without their
  conversion (wrong sums: timed only, what the conversion costs);

and, on the library's kernel (Python-side):

- ``no_group_skip``: the plan made with every group of every real tile
  (the group mask all true: the all-padding tiles and groups are read);
- ``checks_per_launch``: the plan and the data checks (#8's one-hot check
  too) made again before every launch: what a launch on a layout not
  seen before costs, and what caching them per layout saves on the
  others; its parts alone: ``plan_checks`` (#11's data checks),
  ``plan_mask`` (``group_mask``'s one read of the stream, #8's one-hot
  check in it) and ``plan`` (``mono_plan``, the mask included);
- ``kernel_only``: the item kernel alone (every item writes its block, no
  partial sum).

Inputs (seed 19, uniform in (−1, 1)): #11's dst-local form on the
scale-free headline's grad layout, its count form on the uniform
headline's ``layout_for_batch`` grad half, its window count form on the
community headline's table layout (W 512, block_rows 512), #8 on the
uniform headline's ``layout_for_batch``.  ``--parent DIR`` builds DIR's
``window_mono.cu`` (the first body, with its panel sources) and times its
``ggnn_window_mono`` / ``ggnn_onehot_flat`` against this tree's library in
turns (parent, base, base, parent, three times over) on the same inputs.

Timed with CUDA events (10 launches after a warm-up, best of two rounds,
the variants in turns).  Prints ptxas's registers and spills per variant,
the times (ms) as one JSON line, and the card's nvidia-smi line last.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "ggnn_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_mono")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
PIPE, FUSED = "mono_pipe.cuh", "window_mono_fused.cu"
ONE_CTA_REDUCE = [
    (PIPE, "// One CTA a work item:", """// The first body's reduce: one CTA a split block sums its partials.
template <typename TO>
__global__ void __launch_bounds__(kThreads) one_cta_reduce(
    const int* __restrict__ split, const int* __restrict__ item_first,
    const int* __restrict__ pbase, const float* __restrict__ ws,
    TO* __restrict__ out) {
  const int b = split[blockIdx.x];
  const int n = item_first[b + 1] - item_first[b];
  const float* slot = ws + size_t(pbase[b]) * 128 * 128;
  for (int i = threadIdx.x; i < 128 * 128; i += kThreads) {
    float s = 0.0f;
    for (int k = 0; k < n; ++k) s += slot[size_t(k) * 128 * 128 + i];
    if constexpr (sizeof(TO) == 4)
      out[size_t(b) * 128 * 128 + i] = s;
    else
      out[size_t(b) * 128 * 128 + i] = __float2bfloat16_rn(s);
  }
}

// One CTA a work item:"""),
    (PIPE, """  return launch_partial_sum<256, 4, TO>(split, item_first, pbase, ws,
                                        n_split, 128, out, s);""",
     """  one_cta_reduce<TO><<<n_split, kThreads, 0, s>>>(
      static_cast<const int*>(split), static_cast<const int*>(item_first),
      static_cast<const int*>(pbase), static_cast<const float*>(ws),
      static_cast<TO*>(out));
  return int(cudaGetLastError());""")]
STAGES_SWAPPED = [(FUSED, "IDS ? 3 : 2", "IDS ? 2 : 3")]
NO_SWIZZLE = [(PIPE, "cp16(Bs + k * 128 + ((ch ^ (k & 7)) << 3),",
               "cp16(Bs + k * 128 + (ch << 3),"),
              (PIPE, "pipe::ldsm_x4_trans(b, brow + ((ch ^ (kk & 7)) << 3));",
               "pipe::ldsm_x4_trans(b, brow + (ch << 3));")]
NO_PREFETCH = [
    (PIPE, """    cp_async_wait<STAGES - 2>();""", "    pipe::cp_async_wait_all();"),
    (PIPE, """    __syncthreads();
    if (s + STAGES - 1 < n_st) fetch(s + STAGES - 1);
    pipe::cp_async_commit();
    stage_mma<IDS>(acc, smem + (s % STAGES) * kStage,
                   min(kUnits, wk.y - wk.x - s * kUnits));""",
     """    __syncthreads();
    stage_mma<IDS>(acc, smem + (s % STAGES) * kStage,
                   min(kUnits, wk.y - wk.x - s * kUnits));
    __syncthreads();
    if (s + 1 < n_st) fetch(s + 1);
    pipe::cp_async_commit();"""),
    (PIPE, "  for (int s = 0; s < STAGES - 1; ++s) {\n    if (s < n_st) fetch(s);",
     "  for (int s = 0; s < 1; ++s) {\n    if (s < n_st) fetch(s);")]
DIRECT_STORE = [(PIPE, "constexpr bool kStaged = sizeof(TO) == 2;",
                 "constexpr bool kStaged = false;")]
NO_CONVERT = [(PIPE, """        wpipe::s8x4_to_bf16(w[2 * mi], a[mi][0], a[mi][2]);
        wpipe::s8x4_to_bf16(w[2 * mi + 1], a[mi][1], a[mi][3]);""",
               """        a[mi][0] = a[mi][2] = w[2 * mi];
        a[mi][1] = a[mi][3] = w[2 * mi + 1];""")]
UNROLL2 = [(PIPE, "  for (int i = 0; i < nu; ++i) {\n    uint32_t a[2][4];",
            "#pragma unroll 2\n  for (int i = 0; i < nu; ++i) {\n"
            "    uint32_t a[2][4];")]
NO_ROWCHECK = [(PIPE, "const bool ok = row >= 0 && row < n_table;",
                "const bool ok = true;")]
VARIANTS = {"base": [], "one_cta_reduce": ONE_CTA_REDUCE,
            "unroll2": UNROLL2, "no_rowcheck": NO_ROWCHECK,
            "stages_swapped": STAGES_SWAPPED, "no_swizzle": NO_SWIZZLE,
            "no_prefetch": NO_PREFETCH, "direct_store": DIRECT_STORE,
            "no_convert": NO_CONVERT}
SAME = tuple(n for n in VARIANTS if n != "no_convert")
PARENT_SOURCES = ("window_mono.cu", "window_mono_panel.cu",
                  "window_mono_panel_counts.cu", "window_mono_panel_onehot.cu")


def build(name, edits, sources=("window_mono_fused.cu",), csrc=CSRC):
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(csrc):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(csrc, f), d)
    for f, old, new in edits:
        p = os.path.join(d, f)
        with open(p) as fh:
            s = fh.read()
        if old not in s:
            raise RuntimeError(f"{name}: edit not found in {f}: {old!r}")
        with open(p, "w") as fh:
            fh.write(s.replace(old, new, 1))
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    objs, logs = [], ""
    for src in sources:
        obj = os.path.join(d, src + ".o")
        res = subprocess.run([nvcc, *[f for f in FLAGS if f != "-shared"],
                              "-c", "-o", obj, os.path.join(d, src)],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}"
                               f"{res.stderr}")
        objs.append(obj)
        logs += res.stdout + res.stderr
    so = os.path.join(d, "libvariant.so")
    res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", so, *objs], capture_output=True,
                         text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: link failed\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in logs.splitlines()
            if any(w in line for w in ("entry function", "registers",
                                       "spill"))]
    return so, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="time the parent tree's #11 and #8 against this "
                         "tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_mono_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_scalefree_ab as ab
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    variants = {n: (e,) for n, e in VARIANTS.items()}
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "ggnn_tpu_torch",
                            "ops", "csrc")
        srcs = tuple(f for f in PARENT_SOURCES
                     if os.path.exists(os.path.join(pdir, f)))
        variants = {"base": ([],), "parent": ([], srcs, pdir)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, *v) for n, v in variants.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib_f.result()
    print(f"built {len(libs)} variants and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n, (_, regs) in libs.items():
        print(f"  {n}: {' | '.join(regs)[:900]}")
    fns = {}
    for n, (so, _) in libs.items():
        lib = ctypes.CDLL(so)
        for entry in ("ggnn_mono_fused", "ggnn_window_mono"):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
        if hasattr(lib, "ggnn_onehot_flat"):
            # the first body's entry point: its one-hot flag before the stream
            lib.ggnn_onehot_flat.argtypes = (
                _build._SIGNATURES["ggnn_onehot_flat"][:-1]
                + [ctypes.c_void_p, ctypes.c_void_p])
            lib.ggnn_onehot_flat.restype = ctypes.c_int
        fns[n] = lib

    p = _build.ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = lambda n: (torch.rand(n, cs.DIM, device=dev, generator=gen) * 2
                      - 1).to(bf)
    T2 = 2 * cs.EDGE_TYPES
    cases = {}   # name -> (table, c_stream, plan, window, dstl, n_out, odt,
    #                       the wrapper's call, its arguments)

    def add(name, table, cst, ts, win, c_off, nb, window, stride, out_rows,
            dstl, odt, call):
        plan = W.mono_plan(cst, ts, win, c_off, nb, window, stride, out_rows,
                           dstl)
        cases[name] = dict(table=table, c=cst, plan=plan, window=window,
                           dstl=dstl, n_out=nb * out_rows // 128, odt=odt,
                           call=call,
                           args=(cst, ts, win, c_off, nb, window, stride,
                                 out_rows, dstl))

    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        cs.NODES, cs.EDGES, cs.EDGE_TYPES, annotation_dim=cs.ANN, seed=0,
        node_mult=128))
    lay_u = L.layout_for_batch(bu, with_grad=True, device="cuda")
    a = lay_u.arrays
    _, tile_e, _, nb, _, gm, _, _ = lay_u.meta
    msgs = rows(a["gather_idx"].shape[0])
    win8 = W.tile_arange(a["tile_start"], a["block_of_tile"].shape[0])
    add("8_uniform", msgs, a["onehot"], a["tile_start"], win8, None, nb,
        tile_e, tile_e, 128, False, torch.float32,
        lambda m=msgs, a=a: L.onehot_segment_scatter_flat(
            m, a["onehot"], a["tile_start"], a["block_of_tile"], nb, tile_e))
    g_blocks, _, g_tile, _, g_align = gm[:5]
    G = rows(a["g_gather_idx"].shape[0])
    add("11_counts_legacy_grad", G, a["g_onehot"], a["g_tile_start"],
        a["g_tile_msg_off"], None, g_blocks, g_tile, g_align, 128, False, bf,
        lambda a=a: W.window_block_spmm_mono(
            G, a["g_onehot"], a["g_tile_start"], a["g_block_of_tile"],
            a["g_tile_msg_off"], n_blocks=g_blocks, window=g_tile,
            win_stride=g_align, out_dtype=bf))
    bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
        cs.NODES, cs.EDGES, cs.EDGE_TYPES, annotation_dim=cs.ANN, seed=0,
        node_mult=128, powerlaw_alpha=cs.ZIPF))
    lay_s = ab.cached("scalefree_typed_grad.pkl",
                      lambda: S.build_typed_dst_layout(
                          bs.edge_src, bs.edge_dst, bs.edge_type,
                          bs.edge_mask, bs.spec.n_pad, T2,
                          with_grad=True)).to("cuda")
    s_ = lay_s.arrays
    sg_blocks, _, sg_tile, _, sg_align, _ = S.grad_meta(lay_s)
    Gs = rows(s_["g_gather_idx"].shape[0])
    add("11_dstl_scalefree", Gs, s_["g_dstl"], s_["g_tile_start"],
        s_["g_tile_msg_off"], None, sg_blocks, sg_tile, sg_align, 128, True,
        bf, lambda: W.window_block_spmm_mono(
            Gs, s_["g_dstl"], s_["g_tile_start"], s_["g_block_of_tile"],
            s_["g_tile_msg_off"], n_blocks=sg_blocks, window=sg_tile,
            win_stride=sg_align, out_dtype=bf, dstl=True))
    bc = cs.community_batch()
    lay_c = cs.bench_window_layout(bc, 512, False, True).to("cuda")
    c_ = lay_c.arrays
    params = init_params(ModelConfig(
        state_dim=cs.DIM, annotation_dim=cs.ANN, n_edge_types=cs.EDGE_TYPES,
        n_steps=cs.STEPS, head="node_select", backend="window",
        compute_dtype="bfloat16"), torch.Generator().manual_seed(0), "cuda")
    w, b, _ = cs.window_weights(params, bf)
    h = (torch.rand(cs.NODES, cs.DIM, device=dev, generator=gen) * 2
         - 1).to(bf)
    table = TB.node_table(h, w, b, "block")
    add("11_window_table", table, c_["c_stream"], c_["tile_start"],
        c_["win_of_tile"], c_["c_off"], lay_c.n_blocks, 512, 512, 512, False,
        torch.float32, lambda: W.window_block_spmm_mono(
            table, c_["c_stream"], c_["tile_start"], c_["block_of_tile"],
            c_["win_of_tile"], n_blocks=lay_c.n_blocks, window=512,
            out_rows=512, c_off=c_["c_off"]))
    for name, c in cases.items():
        pl = c["plan"]
        print(f"  {name}: {pl.units.shape[0]} units, {pl.n_items} items, "
              f"{pl.split.shape[0]} split blocks, {pl.n_part} partial slots",
              flush=True)

    def run(lib, c, plan=None):
        pl = c["plan"] if plan is None else plan
        out = torch.empty(c["n_out"] * 128, cs.DIM, dtype=c["odt"],
                          device=dev)
        ws = torch.empty(max(pl.n_part, 1), 128, cs.DIM,
                         dtype=torch.float32, device=dev)

        def go():
            _build.check(lib.ggnn_mono_fused(
                int(c["dstl"]), 1 if c["odt"] == bf else 0, p(c["table"]),
                c["table"].shape[0], p(c["c"]), c["window"], p(pl.units),
                p(pl.work), pl.work.shape[0], p(pl.zero_blk),
                pl.zero_blk.shape[0], p(pl.item_first), p(pl.pbase),
                p(pl.split), pl.split.shape[0], p(ws), p(out), stream()),
                "ggnn_mono_fused")
            return out
        return go

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    res = {}
    if args.parent:
        par = fns["parent"]
        for name, c in cases.items():
            if name == "11_window_table":
                continue      # the parent ran it through window_step.cu
            cst, ts, win, c_off, nb_, window, stride, out_rows, dstl = \
                c["args"]
            item_first, pbase, n_items, n_part = W.split_plan(ts.diff())
            n_items, n_part = int(n_items), int(n_part)
            out = torch.empty(nb_ * 128, cs.DIM, dtype=c["odt"], device=dev)
            ws = torch.empty(max(n_part, 1), 128, cs.DIM,
                             dtype=torch.float32, device=dev)
            bad = torch.zeros(1, dtype=torch.int32, device=dev)
            n_c = cst.shape[0] if dstl else cst.shape[0] // 128
            if name.startswith("8_"):
                go_p = lambda: _build.check(par.ggnn_onehot_flat(
                    1, p(c["table"]), c["table"].shape[0], cs.DIM, p(cst),
                    n_c, p(ts), nb_, window, p(item_first), p(pbase),
                    n_items, n_part, p(ws), p(out), p(bad), stream()),
                    "parent")
            else:
                go_p = lambda: _build.check(par.ggnn_window_mono(
                    1, 1 if c["odt"] == bf else 0, int(dstl), 0,
                    p(c["table"]), c["table"].shape[0], cs.DIM, p(cst), n_c,
                    p(ts), p(win), p(c_off), nb_, 128, window, stride,
                    p(item_first), p(pbase), n_items, n_part, p(ws),
                    p(out), stream()), "parent")
            go_b = run(fns["base"], c)
            t = {"parent": [], "base": []}
            for _ in range(3):
                for k, fn in (("parent", go_p), ("base", go_b),
                              ("base", go_b), ("parent", go_p)):
                    t[k].append(cs.cuda_ms(fn, 10))
            res[name] = {k: [round(x, 4) for x in v] for k, v in t.items()}
            print(f"  {name}: {res[name]}", flush=True)
    else:
        for name, c in cases.items():
            want = c["call"]()
            torch.cuda.synchronize()
            r = {}
            for n in VARIANTS:
                go = run(fns[n], c)
                got = go().clone()
                if n in SAME and not torch.equal(got, want):
                    raise AssertionError(f"{name}: variant {n} changed the "
                                         f"bits")
                r[n] = best(go)
            lib = _build.library()
            r["library"] = best(c["call"])
            mask = W.group_mask
            W.group_mask = lambda *a, **kw: torch.ones_like(mask(*a, **kw))
            try:
                allg = W.mono_plan(*c["args"])
            finally:
                W.group_mask = mask
            r["no_group_skip"] = best(run(lib, c, allg))
            pl = c["plan"]
            wk = pl.work.clone()
            wk[:, 3] = -1
            one = W.MonoPlan(pl.units, wk, pl.zero_blk, pl.item_first,
                             pl.pbase, pl.split[:0], pl.n_items, 0)
            r["kernel_only"] = best(run(lib, c, one))
            onehot_of = name if name.startswith("8_") else None
            checks = lambda c=c, name=name: W._mono_checks(
                name, c["table"].shape[0], *c["args"])
            r["plan_checks"] = best(checks)
            r["plan_mask"] = best(lambda c=c, o=onehot_of: W.group_mask(
                c["c"], c["window"], c["dstl"], o))
            r["plan"] = best(lambda c=c, o=onehot_of: W.mono_plan(
                *c["args"], onehot_of=o))

            def again(c=c, o=onehot_of):
                checks()
                return run(lib, c, W.mono_plan(*c["args"], onehot_of=o))()
            r["checks_per_launch"] = best(again)
            res[name] = {k: round(v, 4) for k, v in r.items()}
            print(f"  {name}: {res[name]}", flush=True)
    print(json.dumps({"ms": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
