"""Where the time of #3 ``gru_cell_fwd`` (bf16 at D = 128,
``csrc/gru_cell_pipe.cu`` on ``gru_pipe.cuh::gru_strip``) and #17
``sddmm_pallas`` (``csrc/sddmm_blocked.cu``) goes, on one NVIDIA GPU
(H100).

    python3 scripts/torch_gate_gru_variants.py

Each kernel variant is the tree's source after a few textual edits
(``VARIANTS`` below), compiled by nvcc for sm_90a into
``ggnn_tpu_torch/_build/variants_gate_gru/<name>/`` (one nvcc per variant,
all started together) and loaded with ctypes; its entry point is the
source's own.  Every variant must give the library's bits.  #3's, at the
uniform headline's 262,144 rows (the inputs of
``torch_gate_gru_bringup.py``, seed 2):

- ``l2_prefetch``: a warp's next strip of a and h prefetched into L2 by
  ``cp.async.bulk.prefetch`` while it computes the current one;
  ``l2_prefetch_h``: h alone;
- ``ahead_a``: the next strip's a read into registers before the current
  strip is computed (64 registers more a thread), h at the strip's start;
- ``warps16``: one CTA of 16 warps an SM (128 registers a thread) instead
  of 8 (the 192 KB of resident panels leave room for one CTA an SM, so
  this is the occupancy of two CTAs of 8 warps);

and the first body (``gru_cell.cu``, ``ggnn_gru_cell`` with dtype 1) for
scale.  #17's, on the uniform headline's packed layout (62,516 tiles of
128, G = 128, p and q normal · 0.1 from seed 19), on the plan the tree's
``ops/spmm.py`` makes:

- ``ring4``, ``ring8``: 4 or 8 rows in flight a warp (the tree: 16;
  the ring's depth divides a batch's 32 edges);
- ``k512``, ``k2048``: work items of at most 512 or 2048 edges (the
  tree: 1024; the kernel takes K as an argument);
- ``dst_order``: one slab, the edges grouped by dst block alone;
  ``slab32k``, ``slab128k``: slabs of 32K or 128K rows of p (16.8 or 67
  MB; the tree: 64K, 33.5 MB);

the first body (``sddmm.cu``, ``ggnn_sddmm``), and on the library's
kernel, Python-side: ``plan`` (``sddmm_plan`` alone, 16-bit keys),
``plan_int32`` (the same keys sorted as int32), ``kernel_only`` (the C
entry point on a plan made before), ``wrapper_seen`` (``sddmm_pallas`` on
a layout it has seen: no check, no plan) and ``checks_per_launch``
(``sddmm_pallas`` on copies of src and dst each launch: the two range
checks, one host copy each, and the plan, as on a new layout).

Timed with CUDA events (10 launches after a warm-up, best of two rounds,
the variants in turns, twice over).  Prints ptxas's registers and spills
per variant, the times (ms) as one JSON line, and the card's nvidia-smi
line last.
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
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_gate_gru")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
CELL, PIPE, SD = "gru_cell_pipe.cu", "gru_pipe.cuh", "sddmm_blocked.cu"
def l2_prefetch(arrays):
    """The edit that prefetches a warp's next strip of ``arrays`` into L2
    by cp.async.bulk.prefetch while it computes the current one."""
    lines = "".join(
        f"""      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n"
                   ::"l"({x} + (s + WARPS) * kRowsF),
                   "r"(unsigned(kRowsF * 4)) : "memory");
""" for x in arrays)
    return [(CELL, """    const bool more = s + WARPS < s1;
""", """    const bool more = s + WARPS < s1;
    if (more && (threadIdx.x & 31) == 0) {
""" + lines + """    }
""")]


L2_PREFETCH, L2_PREFETCH_H = l2_prefetch("ah"), l2_prefetch("h")
WARPS16 = [(CELL, "constexpr int kWarps = 8;", "constexpr int kWarps = 16;")]
AHEAD_A = [
    (CELL, """    const size_t o = s * kRowsF;
    wpipe::gru_strip(""", """    const size_t o = s * kRowsF;
    float2 va[8][4];
    if (more) load_rows(a + (s + WARPS) * kRowsF, va);
    wpipe::gru_strip("""),
    (CELL, """    if (more) {
      load_frags(a + (s + WARPS) * kRowsF, af);""", """    if (more) {
      pack_rows(va, af);""")]
RING = lambda n: [(SD, "constexpr int kRegRing = 16;",
                   f"constexpr int kRegRing = {n};")]
VARIANTS = {  # name: (edits, source)
    "cell_base": ([], CELL), "cell_l2_prefetch": (L2_PREFETCH, CELL),
    "cell_l2_prefetch_h": (L2_PREFETCH_H, CELL),
    "cell_ahead_a": (AHEAD_A, CELL), "cell_warps16": (WARPS16, CELL),
    "sd_base": ([], SD), "sd_ring4": (RING(4), SD),
    "sd_ring8": (RING(8), SD),
}


def build(name, edits, source):
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    for f in os.listdir(CSRC):
        if f.endswith((".cuh", ".cu")):
            shutil.copy(os.path.join(CSRC, f), d)
    for f, old, new in edits:
        p = os.path.join(d, f)
        with open(p) as fh:
            s = fh.read()
        if old not in s:
            raise RuntimeError(f"{name}: edit not found in {f}: {old!r}")
        with open(p, "w") as fh:
            fh.write(s.replace(old, new, 1))
    from torch.utils.cpp_extension import CUDA_HOME
    so = os.path.join(d, "libvariant.so")
    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *FLAGS,
                          "-o", so, os.path.join(d, source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return so, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gate_gru_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import spmm as SP
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_scalefree_ab as ab
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, *v) for n, v in VARIANTS.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib = lib_f.result()
    print(f"built {len(libs)} variants and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n, (_, regs) in libs.items():
        print(f"  {n}: {' | '.join(regs)[:600]}")
    fns = {}
    for n, (so, _) in libs.items():
        vl = ctypes.CDLL(so)
        for entry in ("ggnn_gru_cell_pipe", "ggnn_sddmm_blocked"):
            if hasattr(vl, entry):
                getattr(vl, entry).argtypes = _build._SIGNATURES[entry]
                getattr(vl, entry).restype = ctypes.c_int
        fns[n] = vl
    p = _build.ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream
    bf, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")

    def checked(name, err):
        if err:
            raise RuntimeError(f"{name}: launch failed: {err}")

    # --- #3 at the uniform headline's rows -----------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    D = cs.DIM
    h = torch.rand(cs.NODES, D, device=dev, generator=gen) * 2 - 1
    a = torch.randn(cs.NODES, D, device=dev, generator=gen)
    w = [torch.empty(D, k * D, device=dev).uniform_(
        -D ** -0.5, D ** -0.5, generator=gen) for k in (3, 2, 1)]
    b3 = torch.empty(3 * D, device=dev).uniform_(-0.1, 0.1, generator=gen)
    wa, uzr, uh = (x.to(bf).contiguous() for x in w)
    o3 = [torch.empty_like(h)] + [torch.empty(h.shape, dtype=bf, device=dev)
                                  for _ in range(3)]
    nb = cs.NODES // 128

    def cell(entry_lib, entry):
        fn = getattr(entry_lib, entry)
        return lambda: checked(entry, fn(
            1, p(h), p(a), p(wa), p(b3), p(uzr), p(uh), *map(p, o3), nb,
            stream()))

    want3 = [x.clone() for x in cs.gru_first_body((h, a, *w[:1], b3,
                                                   *w[1:]))]
    runs = {f"3:{n}": cell(fns[n], "ggnn_gru_cell_pipe")
            for n in fns if n.startswith("cell_")}
    runs["3:first_body"] = cell(lib, "ggnn_gru_cell")

    # --- #17 on the pallas headline's packed layout --------------------------
    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        cs.NODES, cs.EDGES, cs.EDGE_TYPES, annotation_dim=cs.ANN, seed=0,
        node_mult=128))
    cols = [torch.as_tensor(x, device=dev) for x in (
        bu.edge_src, bu.edge_dst, bu.edge_type, bu.edge_mask,
        bu.type_offsets)]
    lay = SP.pack_type_tiles(*cols, 2 * cs.EDGE_TYPES)
    del cols
    gen = torch.Generator(device=dev).manual_seed(19)
    pp = torch.randn(bu.spec.n_pad, D, device=dev, generator=gen) * 0.1
    qq = torch.randn(bu.spec.n_pad, D, device=dev, generator=gen) * 0.1
    src, dst = lay["src"], lay["dst"]
    E, n_q = src.shape[0], qq.shape[0]
    o17 = torch.empty(E, dtype=f32, device=dev)
    n_qblk = -(-n_q // SP.SDDMM_BLOCK)

    def plan_of(**kw):
        return SP.sddmm_plan(src, dst, pp.shape[0], n_q, D, **kw)

    row_bytes = 4 * D
    plans = {"": plan_of(), "k512": plan_of(k=512), "k2048": plan_of(k=2048),
             "dst_order": plan_of(slab_edges=E + 1),
             "slab32k": plan_of(slab_bytes=32768 * row_bytes),
             "slab128k": plan_of(slab_bytes=131072 * row_bytes)}

    def blocked(vl, plan):
        fn = vl.ggnn_sddmm_blocked
        return lambda: checked("ggnn_sddmm_blocked", fn(
            p(pp), pp.shape[0], p(qq), n_q, D, p(src), p(dst), None, E,
            p(plan["order"]), p(plan["item_first"]), p(plan["key_start"]),
            plan["n_keys"], plan["n_qblk"], plan["k"], plan["grid"], p(o17),
            stream()))

    want17 = cs.sddmm_first_body(pp, qq, src, dst).clone()
    for n in fns:
        if n.startswith("sd_"):
            runs[f"17:{n}"] = blocked(fns[n], plans[""])
    for k in ("k512", "k2048", "dst_order", "slab32k", "slab128k"):
        runs[f"17:{k}"] = blocked(fns["sd_base"], plans[k])
    runs["17:first_body"] = lambda: cs.sddmm_first_body(pp, qq, src, dst)
    runs["17:wrapper_seen"] = lambda: SP.sddmm_pallas(pp, qq, src=src,
                                                      dst=dst)
    runs["17:checks_per_launch"] = lambda: SP.sddmm_pallas(
        pp, qq, src=src.clone(), dst=dst.clone())
    runs["17:plan"] = plan_of
    slab_rows = -(-pp.shape[0] // (plans[""]["n_keys"] // n_qblk))
    runs["17:plan_int32"] = lambda: SP.plan_from_keys(
        (dst // SP.SDDMM_BLOCK).to(torch.int32)
        + (src // slab_rows).to(torch.int32) * n_qblk, plans[""]["n_keys"],
        n_qblk)
    runs["17:kernel_only"] = blocked(lib, plans[""])

    same = {}
    for key, fn in runs.items():
        kern, n = key.split(":")
        print(f"  running {key}", flush=True)
        got = fn()
        torch.cuda.synchronize()
        if kern == "3":
            same[key] = all(torch.equal(x, y) for x, y in zip(o3, want3))
        elif not n.startswith("plan"):
            same[key] = torch.equal(got if torch.is_tensor(got) else o17,
                                    want17)
        if key in same and not same[key]:
            raise AssertionError(f"variant {key} changed the bits")
    for k, plan in plans.items():
        print(f"  plan {k or 'base'}: {int(plan['item_first'][-1])} work "
              f"items over {plan['n_keys']} keys", flush=True)

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    times = {k: [] for k in runs}
    order = list(runs)
    for key in order + order[::-1]:
        times[key].append(best(runs[key]))
    out = {k: round(min(v), 4) for k, v in times.items()}
    print(json.dumps({"ms": out, "all_readings": {
        k: [round(t, 4) for t in v] for k, v in times.items()},
        "same_bits_as_library": same}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
