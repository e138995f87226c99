"""Where the time of the typed pack's bf16 kernels goes, on one NVIDIA GPU
(H100): #1 and #2 (``csrc/typed_block_fused.cu``) and #7
(``csrc/typed_tile_fused.cu``) with one part of their slot pipeline
(``csrc/typed_pipe.cuh``) switched off each, and #7 with other CTA counts
for its second kernel.

    python3 scripts/torch_typed_variants.py [--parent DIR]

Each variant is the sources of ``csrc/`` after a few textual edits
(``VARIANTS`` below), compiled by nvcc for sm_90a into
``ggnn_tpu_torch/_build/variants_typed/<name>/`` (one nvcc per variant,
all started together) and loaded with ctypes; its entry points are the
sources' own.  ``base`` must give the library's bits; the others change
the result and are only timed.  Inputs are chip_smoke.py's
(``kernel_inputs``, seed 19) on the uniform headline's typed pack
(262,144 nodes, 8M directed edges, block mode: #1, #2) and the scale-free
headline's (Zipf 1.2, per tile: #7, #6):

- ``base``; ``noh`` drops the copies of H's rows, ``now`` those of W_t,
  ``nogemm1`` the one-hot product, ``nogemm2`` the W_t product, ``allk``
  runs the one-hot product over a chunk's 128 rows where the slot's real
  rows end before, ``allrows`` (#1, #2) reads every slot's tile_e rows
  instead of its real-row prefix;
- ``rNuK`` (#7): its second kernel at N float4 columns a CTA (4096 / N
  CTAs a split block) and K of a thread's loads in flight, instead of 32
  and 16 (``r64u4``: the first choice, 64 and 4); ``noreduce`` drops it.

``--parent DIR`` compares #6 alone with the tree at DIR instead: DIR's
``typed_tile_fused.cu`` (which must export ``ggnn_typed_step_fused`` with
this tree's signature) is built as the variant ``parent`` beside ``base``,
its #6 must give the library's bits, and the two are timed in turns
(parent, change, change, parent, three times over) in one process on the
same inputs, so that neither the kernel before it nor the card's clocks
favour one tree.

Timed with CUDA events (10 launches after a warm-up, best of two rounds).
Prints ptxas's registers and spills per variant, the times (ms) as one
JSON line, and the card's nvidia-smi line last.
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
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_typed")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
PIPE, BLOCK, TILE = "typed_pipe.cuh", "typed_block_fused.cu", \
    "typed_tile_fused.cu"
NOH = (PIPE, "cp16(hd + r * kLd + v * 8, h_pack + (ok ? row : 0) * 128 + "
       "v * 8, ok);", ";")
NOW = (PIPE, "cp16(wd + r * kLd + v * 8, src + r * 128 + v * 8, true);",
       ";")
NOGEMM1 = (PIPE, "      onehot_mma(p, Dl + (s & 1) * 128, Hs + (s & 1) * "
           "128 * kLd,\n                 min(128, (len - j * 128 + 15) & "
           "~15));\n", "")
NOGEMM2 = (PIPE, "        mma_bf16<8>(acc, Ps, kLd, Ws + wb * 128 * kLd, "
           "kLd);\n", "")
ALLK = (PIPE, "    if (k0 >= nk) break;", "")
ALLROWS = (BLOCK, "s_len[i] = off >= 0 && typ < T2 ? min(dstl_len[row], "
           "tile_e) : 0;", "s_len[i] = off >= 0 && typ < T2 ? tile_e : 0;")


def reduce(threads, unroll):
    return (TILE, "constexpr int kReduceThreads = 32, kReduceUnroll = 16;",
            f"constexpr int kReduceThreads = {threads}, "
            f"kReduceUnroll = {unroll};")


NOREDUCE = (TILE, "    return launch_partial_sum<kReduceThreads, "
            "kReduceUnroll>(\n        split, item_first, pbase, ws, n_split, "
            "128, out, s);", "    return 0;")
# name: (edits, sources the variant's library holds)
BOTH = (BLOCK, TILE)
VARIANTS = {
    "base": ([], BOTH), "noh": ([NOH], BOTH), "now": ([NOW], BOTH),
    "nogemm1": ([NOGEMM1], BOTH), "nogemm2": ([NOGEMM2], BOTH),
    "allk": ([ALLK], BOTH), "allrows": ([ALLROWS], (BLOCK,)),
    "r64u4": ([reduce(64, 4)], (TILE,)), "r32u4": ([reduce(32, 4)], (TILE,)),
    "r256u16": ([reduce(256, 16)], (TILE,)),
    "r128u16": ([reduce(128, 16)], (TILE,)),
    "r64u16": ([reduce(64, 16)], (TILE,)), "noreduce": ([NOREDUCE], (TILE,)),
}


def build(name, edits, sources, csrc=CSRC):
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
    src = os.path.join(d, "variant.cu")
    with open(src, "w") as fh:
        fh.write("".join(f'#include "{s}"\n' for s in sources))
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="compare #6 alone with the tree at this directory")
    args = ap.parse_args()
    variants = VARIANTS
    if args.parent:
        variants = {"base": ([], (TILE,)),
                    "parent": ([], (TILE,), os.path.join(
                        os.path.abspath(args.parent), "ggnn_tpu_torch", "ops",
                        "csrc"))}
    import torch
    if not torch.cuda.is_available():
        print("torch_typed_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
    card = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, *v) for n, v in variants.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib_f.result()
    print(f"built {len(libs)} variants and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n, (_, regs) in libs.items():
        print(f"  {n}: {' | '.join(regs)[:600]}")
    sig = _build._SIGNATURES
    fns = {}
    for n, (so, _) in libs.items():
        lib = ctypes.CDLL(so)
        for entry, key in (("ggnn_typed_block_fused", "ggnn_typed_block_fused"),
                           ("ggnn_typed_onehot_fused",
                            "ggnn_typed_onehot_fused"),
                           ("ggnn_typed_step_fused", "ggnn_typed_step_fused")):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = sig[key]
                getattr(lib, entry).restype = ctypes.c_int
        fns[n] = lib

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    cfg = ModelConfig(state_dim=128, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    p = _build.ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream
    out = {}

    def run(lib, entry, *args):
        def go():
            err = getattr(lib, entry)(*args, stream())
            if err:
                raise RuntimeError(f"{entry}: launch failed: {err}")
        return go

    if args.parent:
        return six_against_parent(cs, S, fns, params, run, best, p, card)

    # --- #1, #2 on the uniform headline -----------------------------------
    b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                        annotation_dim=cs.ANN, seed=0, node_mult=128)
    lay = S.build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                   b.edge_mask, b.spec.n_pad,
                                   2 * cs.EDGE_TYPES).to("cuda")
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    kw, (dstl_blk, slot_off16, blk_off16) = x["kw"], x["arrs"]
    sa = (x["h_pack"], dstl_blk, slot_off16, blk_off16, x["msg_w"])
    fa = (*sa, x["init"], x["hstate"], x["wa"], x["b3"], x["uzr"], x["uh"])
    want = {1: S.typed_block_scatter(*sa, **kw),
            2: S.typed_block_step_gru(*fa, **kw)}
    lens = S.dstl_lengths(dstl_blk)
    nb = kw["n_blocks"]
    for n, lib in fns.items():
        entry = "ggnn_typed_block_fused"
        if not hasattr(lib, entry):
            continue
        for k, fused in ((1, 0), (2, 1)):
            o = torch.empty(nb * 128, 128, device="cuda")
            fn = run(lib, entry, fused, p(x["h_pack"]), x["h_pack"].shape[0],
                     p(dstl_blk), p(slot_off16), p(blk_off16), p(lens),
                     p(x["msg_w"]), nb, x["msg_w"].shape[0], kw["cmax"],
                     kw["S8"], kw["tile_e"], p(x["init"]), p(x["hstate"]),
                     p(x["wa"]), p(x["b3"]), p(x["uzr"]), p(x["uh"]), p(o))
            fn()
            torch.cuda.synchronize()
            if n == "base":
                same = torch.equal(o, want[k])
                print(f"  {n} #{k}: the library's bits: {same}", flush=True)
                if not same:
                    raise AssertionError(f"{n} #{k} differs from the library")
            out[f"{n}_{k}"] = best(fn)
            print(f"  {n} #{k}: {out[f'{n}_{k}']:.3f} ms", flush=True)
    out["library_1"] = best(lambda: S.typed_block_scatter(*sa, **kw))
    out["library_2"] = best(lambda: S.typed_block_step_gru(*fa, **kw))
    del b, lay, x, sa, fa, want
    torch.cuda.empty_cache()

    # --- #7, #6 on the scale-free headline ---------------------------------
    x, sa, fa, head, ws, _keep = scalefree_inputs(cs, S, params, p)
    kw = x["kw"]
    want = {7: S.typed_onehot_scatter(**sa), 6: S.typed_step_gru(**fa)}
    for n, lib in fns.items():
        if not hasattr(lib, "ggnn_typed_onehot_fused"):
            continue
        o = torch.empty(kw["n_blocks"] * 128, 128, device="cuda")
        runs = {7: run(lib, "ggnn_typed_onehot_fused", *head, p(ws), p(o))}
        if n == "base":
            runs[6] = run(lib, "ggnn_typed_step_fused", *head, p(x["init"]),
                          p(x["hstate"]), p(x["wa"]), p(x["b3"]),
                          p(x["uzr"]), p(x["uh"]), p(ws), p(o))
        for k, fn in runs.items():
            fn()
            torch.cuda.synchronize()
            if n == "base":
                same = torch.equal(o, want[k])
                print(f"  {n} #{k}: the library's bits: {same}", flush=True)
                if not same:
                    raise AssertionError(f"{n} #{k} differs from the library")
            out[f"{n}_{k}"] = best(fn)
            print(f"  {n} #{k}: {out[f'{n}_{k}']:.3f} ms", flush=True)
    out["library_7"] = best(lambda: S.typed_onehot_scatter(**sa))
    out["library_6"] = best(lambda: S.typed_step_gru(**fa))
    print(json.dumps({"ms": out}))
    print(card)
    return 0


def scalefree_inputs(cs, S, params, p):
    """#6 and #7's arguments on the scale-free headline: chip_smoke's
    kernel inputs, the wrappers' keyword sets, the entry points' leading
    arguments (``head``), the partials' workspace and the plan's tensors
    (``keep``, which must outlive the launches)."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                        annotation_dim=cs.ANN, seed=0, node_mult=128,
                        powerlaw_alpha=cs.ZIPF)
    lay = S.build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                   b.edge_mask, b.spec.n_pad,
                                   2 * cs.EDGE_TYPES).to("cuda")
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    kw = x["kw"]
    sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **kw)
    fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
              b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
    T2 = x["msg_w"].shape[0]
    item_first, pbase, split, lens, n_items, n_part, n_split = \
        S._fused_tile_plan("variants", x["h_pack"], kw["dstl"],
                           kw["tile_start"], kw["block_of_tile"],
                           kw["tile_msg_off"], kw["c_off"], kw["tile_type"],
                           T2, kw["n_blocks"], kw["tile_e"], kw["align"])
    ws = torch.empty(max(n_part, 1), 128, 128, device="cuda")
    head = (p(x["h_pack"]), x["h_pack"].shape[0], p(kw["dstl"]),
            kw["dstl"].shape[0], p(kw["tile_start"]), p(kw["tile_msg_off"]),
            p(kw["c_off"]), p(kw["tile_type"]), p(lens), p(x["msg_w"]), T2,
            kw["n_blocks"], kw["tile_e"], kw["align"], p(item_first),
            p(pbase), n_items, p(split), n_split)
    return x, sa, fa, head, ws, (item_first, pbase, split, lens)


def six_against_parent(cs, S, fns, params, run, best, p, card):
    """#6 of this tree (``base``) and of the parent, bit-equal to the
    library's, timed in turns."""
    import torch
    x, _, fa, head, ws, _keep = scalefree_inputs(cs, S, params, p)
    want = S.typed_step_gru(**fa)
    outs, fn = {}, {}
    for n in ("parent", "base"):
        outs[n] = torch.empty_like(want)
        fn[n] = run(fns[n], "ggnn_typed_step_fused", *head, p(x["init"]),
                    p(x["hstate"]), p(x["wa"]), p(x["b3"]), p(x["uzr"]),
                    p(x["uh"]), p(ws), p(outs[n]))
        fn[n]()
        torch.cuda.synchronize()
        if not torch.equal(outs[n], want):
            raise AssertionError(f"{n} #6 differs from the library")
        print(f"  {n} #6: the library's bits", flush=True)
    times = {"parent": [], "base": []}
    for _ in range(3):
        for n in ("parent", "base", "base", "parent"):
            times[n].append(best(fn[n]))
    out = {f"{n}_6": t for n, t in times.items()}
    out["change_over_parent"] = (sum(times["base"]) / sum(times["parent"])
                                 - 1.0)
    print(json.dumps({"ms": out}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
