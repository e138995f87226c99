"""Where the time of kernels #6 and #12 goes, on one NVIDIA GPU (H100):
variants of #6's source with one part switched off, and #12 at other
work-item sizes, each timed at the scale-free headline.

    python3 scripts/torch_scalefree_variants.py

Each #6 variant is ``csrc/typed_tile_fused.cu`` (with the headers of
``csrc/``) after a few textual edits (``VARIANTS`` below), compiled by
nvcc for sm_90a into ``ggnn_tpu_torch/_build/variants_scalefree/<name>/``
(one nvcc per variant, all started together) and loaded with ctypes; its
entry point is the source's own ``ggnn_typed_step_fused``.  ``base`` must
give the library's bits; the others change the result and are only timed.
On the scale-free headline's typed pack (262,144 nodes, 8M directed
edges, Zipf 1.2; tile_e 256; chip_smoke.py's inputs, seed 19):

- ``base``; ``noh`` drops the copies of H_t's rows, ``now`` those of W_t,
  ``nogemm1`` the one-hot product, ``nogemm2`` the W_t product,
  ``allk`` runs the one-hot product over a chunk's 128 rows where the
  tile's real rows end before, ``allrows`` also reads every tile's tile_e
  slots instead of its real-row prefix,
  ``noreduce`` drops the second kernel (the split blocks' sums and GRU),
  ``noepi`` stores the single-item blocks' sums instead of running their
  GRU; ``k16`` and ``k64`` cut the blocks into items of 16 and 64 tiles
  (kSplit, common.cuh) instead of 32;
- ``base`` on the hub block alone (every other block's tiles made dummies)
  and without it.

#12 (the library's kernel) on bench.py's scalefree_fwd_window layout and
the community headline's on-demand layout at ONDEMAND_SPLIT 8, 16, 32 and
without a split.  Timed with CUDA events (10 launches after a warm-up,
best of two rounds).  Prints ptxas's registers and spills per variant, the
times (ms), and the card's nvidia-smi line last.
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
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_scalefree")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
SRC = "typed_tile_fused.cu"
ENTRY = """#include "typed_tile_fused.cu"
extern "C" int variant_split() { return ggnn::kSplit; }
"""
NOH = (SRC, "cp16(hd + r * kLd + v * 8, h_pack + (ok ? row : 0) * 128 + "
       "v * 8, ok);", ";")
NOW = (SRC, "cp16(wd + r * kLd + v * 8, src + r * 128 + v * 8, true);", ";")
NOGEMM1 = (SRC, "      onehot_mma(p, Dl + (s & 1) * 128, Hs + (s & 1) * 128 "
           "* kLd,\n                 min(128, (len - j * 128 + 15) & ~15));\n",
           "")
NOGEMM2 = (SRC, "        mma_bf16<8>(acc, Ps, kLd, Ws + wb * 128 * kLd, "
           "kLd);\n", "")
ALLK = (SRC, "    if (k0 >= nk) break;", "")
ALLROWS = (SRC, "    s_len[i] = ok ? min(dstl_len[c], tile_e) : 0;",
           "    s_len[i] = ok ? tile_e : 0;")
NOREDUCE = (SRC, "  if (err != cudaSuccess || n_split == 0) return int(err);",
            "  return int(err);")
NOEPI = (SRC, "  tile_gru_epilogue(Ps, Hs, Ws, hstate + ob, wa, b3, uzr, uh, "
         "out + ob);", "")
K16 = ("common.cuh", "constexpr int kSplit = 32;",
       "constexpr int kSplit = 16;")
K64 = ("common.cuh", "constexpr int kSplit = 32;",
       "constexpr int kSplit = 64;")
VARIANTS = {
    "base": [], "noh": [NOH], "now": [NOW], "nogemm1": [NOGEMM1],
    "nogemm2": [NOGEMM2], "allk": [ALLK], "allrows": [ALLROWS],
    "noreduce": [NOREDUCE], "noepi": [NOEPI], "k16": [K16], "k64": [K64],
}


def build(name, edits):
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
    src = os.path.join(d, "variant.cu")
    with open(src, "w") as fh:
        fh.write(ENTRY)
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
        print("torch_scalefree_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        lib_f = pool.submit(_build.library)
        futs = {n: pool.submit(build, n, e) for n, e in VARIANTS.items()}
        libs = {n: f.result() for n, f in futs.items()}
        lib_f.result()
    print(f"built {len(libs)} variants and the library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n, (_, regs) in libs.items():
        print(f"  {n}: {' | '.join(regs)[:400]}")
    sig = _build._SIGNATURES["ggnn_typed_step_fused"]
    fns = {}
    for n, (so, _) in libs.items():
        lib = ctypes.CDLL(so)
        lib.ggnn_typed_step_fused.argtypes = sig
        lib.ggnn_typed_step_fused.restype = ctypes.c_int
        lib.variant_split.restype = ctypes.c_int
        fns[n] = lib

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    cfg = ModelConfig(state_dim=128, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    b = synthetic_batch(cs.NODES, cs.EDGES, cs.EDGE_TYPES,
                        annotation_dim=cs.ANN, seed=0, node_mult=128,
                        powerlaw_alpha=cs.ZIPF)
    lay = S.build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                   b.edge_mask, b.spec.n_pad,
                                   2 * cs.EDGE_TYPES).to("cuda")
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    kw = x["kw"]
    fa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], init=x["init"],
              hstate=x["hstate"], wa=x["wa"], b3=x["b3"], uzr=x["uzr"],
              uh=x["uh"], **kw)
    ref = S.typed_step_gru(**fa)
    lens = S.dstl_lengths(kw["dstl"])
    ts = kw["tile_start"]
    nb = kw["n_blocks"]
    sizes = ts[1:] - ts[:-1]
    big = int(sizes.argmax().item())
    hub_off = torch.where(kw["block_of_tile"] == big, kw["tile_msg_off"],
                          torch.full_like(kw["tile_msg_off"], -1))
    rest_off = torch.where(kw["block_of_tile"] != big, kw["tile_msg_off"],
                           torch.full_like(kw["tile_msg_off"], -1))
    p = _build.ptr
    out = {}

    def call(lib, K, off):
        nit = ((sizes.clamp_min(0) + K - 1) // K).clamp_min(1)
        item_first = torch.zeros(nb + 1, dtype=torch.int32, device="cuda")
        item_first[1:] = torch.cumsum(nit, 0, dtype=torch.int32)
        pcount = torch.where(nit > 1, nit, torch.zeros_like(nit))
        pbase = (torch.cumsum(pcount, 0, dtype=torch.int32)
                 - pcount).to(torch.int32)
        split = torch.nonzero(nit > 1).flatten().to(torch.int32)
        n_items, n_part = int(item_first[-1]), int(pcount.sum())
        ws = torch.empty(max(n_part, 1), 128, 128, device="cuda")
        o = torch.empty(nb * 128, 128, device="cuda")
        args = (p(fa["h_pack"]), fa["h_pack"].shape[0], p(kw["dstl"]),
                kw["dstl"].shape[0], p(ts), p(off), p(kw["c_off"]),
                p(kw["tile_type"]), p(lens), p(fa["msg_w"]),
                fa["msg_w"].shape[0], nb, kw["tile_e"], kw["align"],
                p(item_first), p(pbase), n_items, p(split), split.shape[0],
                p(fa["init"]), p(fa["hstate"]), p(fa["wa"]), p(fa["b3"]),
                p(fa["uzr"]), p(fa["uh"]), p(ws), p(o),
                torch.cuda.current_stream().cuda_stream)

        def run():
            err = lib.ggnn_typed_step_fused(*args)
            if err:
                raise RuntimeError(f"variant launch failed: {err}")
        run.keep = (ws, item_first, pbase, split)  # alive while run is
        return run, o

    for n, lib in fns.items():
        run, o = call(lib, lib.variant_split(), kw["tile_msg_off"])
        out[f"6_{n}_ms"] = best(run)
        if n == "base":
            torch.cuda.synchronize()
            if not torch.equal(o, ref):
                raise AssertionError("variant base differs from the library")
    run, _ = call(fns["base"], 32, hub_off)
    out["6_base_hub_alone_ms"] = best(run)
    run, _ = call(fns["base"], 32, rest_off)
    out["6_base_without_hub_ms"] = best(run)
    print(f"#6 {out}", flush=True)
    del x, fa, ref, lay
    torch.cuda.empty_cache()

    # #12 at other work-item sizes (the library's kernel)
    gen = torch.Generator(device="cuda").manual_seed(29)
    w, bias, _ = cs.window_weights(params, torch.bfloat16)
    for tag, bt, rows in (
            ("scalefree", b, 128),
            ("community", cs.community_batch(), 512)):
        wl = cs.bench_window_layout(bt, rows, True, True).to("cuda")
        a = wl.arrays
        h = (torch.rand(wl.n_nodes_pad, 128, device="cuda", generator=gen)
             * 2 - 1).to(torch.bfloat16)
        args = (h, w, bias, a["c_stream"], a["tile_start"],
                a["block_of_tile"], a["win_of_tile"], a["c_off"],
                wl.n_blocks, wl.window, rows)
        default = W.ONDEMAND_SPLIT
        for K in (8, 16, 32, 1 << 30):
            W.ONDEMAND_SPLIT = K
            out[f"12_{tag}_split{K if K < 1 << 30 else 'none'}_ms"] = best(
                lambda: W.window_block_spmm_ondemand(*args))
        W.ONDEMAND_SPLIT = default
        del wl, h, args
        torch.cuda.empty_cache()
    print(f"times {out}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
