"""Where the time of #20 ``window_block_spmm`` (``csrc/window_auto_gather.cu``),
#18 ``onehot_segment_scatter_stream`` and #19 ``onehot_segment_scatter_loopT``
goes on one NVIDIA GPU (H100), and the parent's #19 against this tree's in
one process.

    python3 scripts/torch_auto_stream_variants.py [--parent DIR]

Inputs: #20 on the window sweep's community layout
(``scripts/torch_window_variants.py``: 262,144 nodes, 8M directed edges,
W 512, 128-row blocks, the compact count stream) and a random table
[16·262,144, D] (seed 0); #18 and #19 on the scatter sweep's uniform
layout (``scripts/torch_scatter_variants.py``: the same size, tile_e 2048)
and random messages (seed 0).

#20's kernel variants are ``window_auto_gather.cu`` after one textual edit
each, compiled by nvcc for sm_90a into
``ggnn_tpu_torch/_build/variants_auto/<name>/`` (one nvcc per variant, all
started together) and called through their own ``ggnn_window_auto_gather``
on the tree's plan; each must give the library's bits:

- ``depth2`` / ``depth8``: 2 or 8 table rows in flight a lane (the
  tree: 4);
- ``warp``: a bf16 item on a whole warp, 8 bytes a lane (the tree: a half
  warp, 16 bytes a lane);
- ``min8ctas``: the kernel compiled for 8 CTAs an SM (at most 32
  registers a thread);

and on the library's kernel, other plans (Python-side): ``k64`` /
``k256``, work items of at most 64 or 256 entries (the tree: 128);
``entries8``, entries of 8 bytes {row, count} (the tree: 4 bytes, row << 8
| count).  Then ``plan`` (:func:`window_auto_plan` alone, and one call
profiled by ``torch.profiler``: its ops by device and host time),
``checks_per_launch`` (the data checks and the plan before every launch:
a launch on a layout not seen before), and the yardsticks: #11's window
form on the same layout (``window_block_spmm_mono``, its plan cached) and
``torch.bmm`` of the real tiles' counts and windows gathered beforehand.
#18: the wrapper (#11's count form, ``window_mono_fused.cu``) in turns
with #19's gather on the same arguments (the function #18 computes; the
gather runs #18's other forms) and ``index_add_`` of every message row
(chip_smoke.py's library call), its checks and plan on a new layout, the
plan alone (and profiled).  #19: the wrapper on a new layout, its checks
and plan alone (and profiled), and ``index_add_`` in f32.

``--parent DIR`` also builds DIR's ``onehot_stream.cu`` (the ring body #19
ran through PR 17, and #18 in its f32 and D ≠ 128 forms) and times its
entry point ``ggnn_onehot_loopT`` against this tree's #19 in turns
(parent, parent with the host check its wrapper made before every launch,
tree; forwards then backwards, twice over) in five forms: bf16 and f32 at
D = 128, bf16 at D = 256 and 200 on the uniform layout, and bf16 at
D = 128 on the JAX variant test's layout (tile_e 8, chip_smoke.py's
``tile_e8`` fuzz layout).

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

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
CSRC = os.path.join(ROOT, "ggnn_tpu_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_auto")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GATHER = "window_auto_gather.cu"
DEPTH = "constexpr int kDepth = 4;"
VARIANTS = {
    "base": [],
    "depth2": [(GATHER, DEPTH, "constexpr int kDepth = 2;")],
    "depth8": [(GATHER, DEPTH, "constexpr int kDepth = 8;")],
    "warp": [(GATHER, "constexpr int kLanesBf16 = 16;",
              "constexpr int kLanesBf16 = 32;")],
    "min8ctas": [(GATHER, "__launch_bounds__(kThreads) gather_kernel(",
                  "__launch_bounds__(kThreads, 8) gather_kernel(")],
}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_ENTRIES = {
    # the parent's #19 ring: dtype, msgs, n_msgs, D, onehot, n_tiles,
    # tile_e, tile_start, n_blocks, out, stream
    "ggnn_onehot_loopT": [_I, _P, _L, _I, _P, _I, _I, _P, _I, _P, _P],
}


def build(name, edits, sources=(GATHER,), csrc=CSRC):
    """``sources`` of ``csrc`` after ``edits`` (file, old, new), compiled
    and linked into ``OUT/name/libvariant.so``; returns (path, ptxas's
    register and spill lines)."""
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
        res = subprocess.run([nvcc, *FLAGS, "-c", "-o", obj,
                              os.path.join(d, src)],
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
                    help="time the parent tree's #19 (its ring body) "
                         "against this tree's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_auto_stream_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import torch_scatter_variants as SV
    import torch_window_variants as WV
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    builds = {n: (e,) for n, e in VARIANTS.items()}
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "ggnn_tpu_torch",
                            "ops", "csrc")
        builds["parent"] = ([], ("onehot_stream.cu",), pdir)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, *v) for n, v in builds.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib_f.result()
    print(f"built {len(libs)} variants and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    fns = {}
    for n, (so, regs) in libs.items():
        print(f"  {n}: {' | '.join(regs)[:900]}")
        lib = ctypes.CDLL(so)
        sigs = dict(PARENT_ENTRIES, ggnn_window_auto_gather=_build._SIGNATURES[
            "ggnn_window_auto_gather"])
        for entry, argtypes in sigs.items():
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        fns[n] = lib

    p = _build.ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    def profile(what, fn):
        """The ops of one call of ``fn`` by device time, then host time."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof
        fn()
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as pr:
            fn()
            torch.cuda.synchronize()
        ka = pr.key_averages()
        print(f"  {what}, profiled:", flush=True)
        for key in ("self_device_time_total", "self_cpu_time_total"):
            print(ka.table(sort_by=key, row_limit=12,
                           max_name_column_width=40), flush=True)

    def turns(fns_, rounds=2):
        """Each of ``fns_`` (name -> call) timed in turns, forwards then
        backwards, ``rounds`` times: name -> [ms, ...]."""
        t = {k: [] for k in fns_}
        order = list(fns_)
        for _ in range(rounds):
            for k in order + order[::-1]:
                t[k].append(round(cs.cuda_ms(fns_[k], 10), 4))
        return t

    res = {}
    # --- #20 on the community layout ------------------------------------
    bc = cs.community_batch()
    host = W.build_window_layout(bc.edge_src, bc.edge_dst, bc.edge_type,
                                 bc.edge_mask, bc.spec.n_pad,
                                 window=WV.WINDOW)
    lay = host.to(dev)
    del host
    a = lay.arrays
    nb = lay.n_blocks
    cargs = (a["c_stream"], a["tile_start"], a["block_of_tile"],
             a["win_of_tile"])
    kw = dict(n_blocks=nb, window=WV.WINDOW, c_off=a["c_off"])
    R = 2 * WV.TYPES * bc.spec.n_pad
    del bc
    table = torch.randn(R, cs.DIM, device=dev,
                        generator=gen).to(torch.bfloat16)
    plan = W.window_auto_plan_once("window_block_spmm", R, *cargs,
                                   a["c_off"], nb, WV.WINDOW)
    want = W.window_block_spmm(table, *cargs, **kw)

    def gather(lib, t, pl):
        out = torch.empty(nb * 128, t.shape[1], dtype=torch.float32,
                          device=dev)
        ws = torch.empty(max(pl.n_part, 1), t.shape[1], dtype=torch.float32,
                         device=dev)
        code = G._DTYPE_CODE[t.dtype]

        def go():
            _build.check(lib.ggnn_window_auto_gather(
                code, int(pl.packed), p(t), t.shape[1], p(pl.ent),
                p(pl.items), pl.items.shape[0], p(pl.split),
                pl.split.shape[0], p(pl.item_first), p(pl.pbase), p(ws),
                p(out), stream()), "ggnn_window_auto_gather")
            return out
        return go

    r = {}
    for n in VARIANTS:
        go = gather(fns[n], table, plan)
        if not torch.equal(go().clone(), want):
            raise AssertionError(f"#20 variant {n} changed the bits")
    r.update(turns({n: gather(fns[n], table, plan) for n in VARIANTS}))
    lib = _build.library()
    for n, attr, value in (("k64", "AUTO_SPLIT", 64),
                           ("k256", "AUTO_SPLIT", 256),
                           ("entries8", "_PACK_ROWS", 0)):
        kept = getattr(W, attr)
        setattr(W, attr, value)
        try:
            pl = W.window_auto_plan(a["c_stream"], a["block_of_tile"],
                                    a["win_of_tile"], a["c_off"], nb,
                                    WV.WINDOW, R)
        finally:
            setattr(W, attr, kept)
        got = gather(lib, table, pl)().clone()
        print(f"  #20 {n}: {pl.items.shape[0]} items, {pl.split.shape[0]} "
              f"split rows, max |diff| to the base "
              f"{(got - want).abs().max().item():.3e}", flush=True)
        r[n] = best(gather(lib, table, pl))
        del pl, got
    make_plan = lambda: W.window_auto_plan(
        a["c_stream"], a["block_of_tile"], a["win_of_tile"], a["c_off"], nb,
        WV.WINDOW, R)
    r["plan"] = best(make_plan, 3)
    profile("#20's plan", make_plan)
    r["checks_per_launch"] = best(lambda: W.window_block_spmm(
        table, a["c_stream"], a["tile_start"].clone(), *cargs[2:], **kw), 3)
    real_t = torch.nonzero(a["win_of_tile"] >= 0).flatten()
    cg = a["c_stream"].view(-1, 128, WV.WINDOW)[a["c_off"].long()[real_t]].to(
        table.dtype)
    tg = table.view(-1, WV.WINDOW, cs.DIM)[a["win_of_tile"].long()[real_t]]
    r.update(turns({
        "wrapper": lambda: W.window_block_spmm(table, *cargs, **kw),
        "mono_window_form": lambda: W.window_block_spmm_mono(table, *cargs,
                                                             **kw),
        "torch_bmm": lambda: torch.bmm(cg, tg)}))
    del cg, tg
    res["window_block_spmm"] = r
    del table, want, plan, lay, a, cargs
    torch.cuda.empty_cache()

    # --- #18 and #19 on the uniform layout at tile_e 2048 --------------
    b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                        annotation_dim=cs.ANN, seed=0, node_mult=128)
    _, (tile_e, lay, msgs) = SV.sweep(b, {2048: ()}, keep_last=True)
    del b
    a = lay.arrays
    _, _, max_tiles, nb, *_ = lay.meta
    oh, ts = a["onehot"], a["tile_start"]
    n_tiles = oh.shape[0] // 128
    tgt = cs.legacy_targets(a, nb, tile_e)
    r = {}
    r.update(turns({
        "wrapper": lambda: L.onehot_segment_scatter_stream(
            msgs, oh, ts, nb, max_tiles, tile_e),
        "loopT_gather": lambda: L.onehot_segment_scatter_loopT(
            msgs, oh, ts, nb, tile_e),
        "index_add": cs.reverse_library_call(msgs, tgt, nb * 128)}))
    r["new_layout"] = best(lambda: L.onehot_segment_scatter_stream(
        msgs, oh, ts.clone(), nb, max_tiles, tile_e), 3)
    make_plan = lambda: W.mono_plan(
        oh, ts, W.tile_arange(ts, n_tiles), None, nb, tile_e, tile_e, 128,
        False)
    r["plan"] = best(make_plan, 3)
    profile("#18's plan", make_plan)
    res["onehot_segment_scatter_stream"] = r

    r = {}
    r["new_layout"] = best(lambda: L.onehot_segment_scatter_loopT(
        msgs, oh, ts.clone(), nb, tile_e), 3)
    make_plan = lambda: L.loopT_plan_once(
        "onehot_segment_scatter_loopT", oh, ts.clone(), nb, tile_e)
    r["plan"] = best(make_plan, 3)
    profile("#19's checks and plan", make_plan)
    r["index_add_f32"] = best(cs.reverse_library_call(msgs.float(), tgt,
                                                      nb * 128))
    del tgt
    if args.parent:
        par = fns["parent"]

        def ring(m, oh, ts, nb, tile_e, checks):
            """The parent's #19: its ring body, with its wrapper's host
            check before every launch where ``checks``."""
            out = torch.empty(nb * 128, m.shape[1], dtype=torch.float32,
                              device=dev)
            n_t = oh.shape[0] // 128

            def go():
                if checks:
                    G._scatter_data_checks("p", ts, n_t)
                _build.check(par.ggnn_onehot_loopT(
                    G._DTYPE_CODE[m.dtype], p(m), m.shape[0], m.shape[1],
                    p(oh), n_t, tile_e, p(ts), nb, p(out), stream()),
                    "parent ggnn_onehot_loopT")
                return out
            return go

        def ab(form, m, oh, ts, nb, tile_e):
            tree = lambda: L.onehot_segment_scatter_loopT(m, oh, ts, nb,
                                                          tile_e)
            got = ring(m, oh, ts, nb, tile_e, False)()
            print(f"  #19 {form}: parent - tree max |diff| "
                  f"{(got - tree()).abs().max().item():.3e}", flush=True)
            r[f"parent_ab_{form}"] = turns({
                "parent": ring(m, oh, ts, nb, tile_e, False),
                "parent_with_checks": ring(m, oh, ts, nb, tile_e, True),
                "tree": tree})

        forms = {"bf16_D128": lambda: msgs, "f32_D128": msgs.float,
                 "bf16_D256": lambda: torch.randn(
                     msgs.shape[0], 256, device=dev,
                     generator=gen).to(torch.bfloat16),
                 "bf16_D200": lambda: torch.randn(
                     msgs.shape[0], 200, device=dev,
                     generator=gen).to(torch.bfloat16)}
        for form, make in forms.items():
            ab(form, make(), oh, ts, nb, tile_e)
            torch.cuda.empty_cache()
        rng = np.random.default_rng(53)   # chip_smoke.py's tile_e8 layout
        small = L.build_dst_block_layout(*cs.random_edges(rng, 256, 500, 4),
                                         256, tile_e=8).to(dev)
        sa = small.arrays
        m = torch.randn(sa["gather_idx"].shape[0], 128, device=dev,
                        generator=gen).to(torch.bfloat16)
        ab("tile_e8_bf16_D128", m, sa["onehot"], sa["tile_start"],
           small.meta[3], 8)
    res["onehot_segment_scatter_loopT"] = r
    print(json.dumps({"ms": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
