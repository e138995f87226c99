"""Where the time of kernels #10 and #16 goes, on one NVIDIA GPU (H100):
variants of their sources with one part switched off or done otherwise,
each timed at the uniform headline.

    python3 scripts/torch_table_messages_variants.py

Each variant is ``csrc/node_table.cu`` or ``csrc/packed_messages.cu`` (with
the headers of ``csrc/``) after a few textual edits (``VARIANTS`` below),
compiled by nvcc for sm_90a into ``ggnn_tpu_torch/_build/variants/<name>/``
(one nvcc per variant, all started together) and loaded with ctypes.  The
variants that change no arithmetic must give the base kernel's bits; the
base kernels are held to their plain versions.  Timed with CUDA events
(10 launches after a warm-up, two rounds), beside ``zero_`` of #16's f32
output as the card's write rate:

- #16 at the headline's packed layout (62,516 tiles of 128, D = 128,
  bf16): ``direct`` stores in the mma fragments' pattern (each thread its
  own float2s, 8 rows × 32 bytes a warp instruction) instead of 16-byte
  pieces of whole rows;
  ``nogather`` / ``nostore`` / ``nomma`` drop the h[src] copies, the
  output stores or the product; ``compute_only`` drops copies and stores,
  ``store_only`` copies and product;
- #10 at N = 262,144, T2 = 16, D = 128, bf16: ``nostore``, ``nomma``;
  ``unroll2`` the k-loop of ``mma_pipe.cuh`` unrolled by 2 instead of
  fully; ``one_cta`` one CTA per SM instead of two.

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
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]

NT, PM, HDR = "node_table.cu", "packed_messages.cu", "mma_pipe.cuh"
GATHER = ("pipe::cp_async16(d, h + size_t(s) * D + k0 + v * kVec);", ";")
STORE16 = ("__stcs(reinterpret_cast<float4*>(dst + size_t(r0w + rl) * D +",
           "if (0) __stcs(reinterpret_cast<float4*>(dst + size_t(r0w + rl) "
           "* D +")
MMA16 = ("if (live)\n      tile.mma_chunk(", "if (0)\n      tile.mma_chunk(")
DIRECT = ("      __syncwarp();\n      if (D % 4 == 0) {",
          """      if (D % 4 == 0) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int r = pipe::WarpTile::row(mi, e);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
              const int c = pipe::WarpTile::col(ni, e);
              if (r < n && c < wid)
                __stcs(reinterpret_cast<float2*>(dst + size_t(r) * D + c),
                       *reinterpret_cast<const float2*>(
                           Ow + (r - r0w) * kLdW + c - c0w));
            }
          }
      } else if (false) {""")
NOSTORE10 = ("__stcs(reinterpret_cast<int4*>(dst",
             "if (0) __stcs(reinterpret_cast<int4*>(dst")
NOMMA10 = ("tile.mma_chunk(A_s + (kc - grp * KA)",
           "if (0) tile.mma_chunk(A_s + (kc - grp * KA)")
UNROLL2 = (HDR, "#pragma unroll\n    for (int k0 = 0; k0 < kCols; k0 += 16) {",
           "#pragma unroll 2\n    for (int k0 = 0; k0 < kCols; k0 += 16) {")
ONE_CTA = [("__launch_bounds__(pipe::kThreads, 2)",
            "__launch_bounds__(pipe::kThreads, 1)"),
           ("std::max(1, std::max(per_sm, 1) * pipe::multiprocessors()",
            "std::max(1, pipe::multiprocessors()")]
# name -> (source, [(old, new)] edits of the source or (header, old, new))
VARIANTS = {
    "pm_base": (PM, []),
    "pm_direct": (PM, [DIRECT]),
    "pm_nogather": (PM, [GATHER]),
    "pm_nostore": (PM, [STORE16]),
    "pm_nomma": (PM, [MMA16]),
    "pm_compute_only": (PM, [GATHER, STORE16]),
    "pm_store_only": (PM, [GATHER, MMA16]),
    "nt_base": (NT, []),
    "nt_nostore": (NT, [NOSTORE10]),
    "nt_nomma": (NT, [NOMMA10]),
    "nt_unroll2": (NT, [UNROLL2]),
    "nt_one_cta": (NT, ONE_CTA),
}
SAME_BITS = ("pm_direct", "nt_unroll2", "nt_one_cta")


def build(name, src, edits):
    """Writes the variant's sources and compiles them; returns (name, ptxas
    lines or the failure)."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    texts = {f: open(os.path.join(CSRC, f)).read()
             for f in os.listdir(CSRC) if f.endswith(".cuh") or f == src}
    for e in edits:
        f, old, new = e if len(e) == 3 else (src, *e)
        if old not in texts[f]:
            return name, f"edit not found in {f}: {old[:60]!r}"
        texts[f] = texts[f].replace(old, new)
    for f, t in texts.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(t)
    from torch.utils.cpp_extension import CUDA_HOME
    r = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *FLAGS,
                        "-o", os.path.join(d, "lib.so"),
                        os.path.join(d, src)], capture_output=True, text=True)
    if r.returncode:
        return name, "nvcc failed:\n" + r.stdout + r.stderr
    return name, [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                  if "registers" in ln or "spill" in ln]


def events_ms(fn, iters=10):
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_table_messages_variants: no CUDA device",
              file=sys.stderr)
        return 2
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import table as TB
    shutil.rmtree(OUT, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(pool.map(lambda kv: build(kv[0], *kv[1]),
                              VARIANTS.items()))
    print(f"built {len(built)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, info in built.items():
        print(f"  {name}: {info}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    N, D, T2 = 262_144, 128, 16
    h = (torch.rand(N, D, device=dev, generator=gen) * 2 - 1).bfloat16()
    w = (torch.randn(T2, D, D, device=dev, generator=gen)
         * D ** -0.5).bfloat16()
    b = (torch.randn(T2, D, device=dev, generator=gen) * 0.1).bfloat16()
    bt = synthetic_batch(N, 4_000_000, 8, annotation_dim=8, seed=0,
                         node_mult=128)
    lay = SP.pack_type_tiles(*[torch.as_tensor(x, device=dev) for x in (
        bt.edge_src, bt.edge_dst, bt.edge_type, bt.edge_mask,
        bt.type_offsets)], T2)
    P = lay["src"].shape[0]
    z = torch.empty(P, D, device=dev)
    print(f"zero_ of #16's f32 output [{P}, {D}]: "
          f"{events_ms(lambda: z.zero_()):.3f} ms", flush=True)
    del z
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci = ctypes.c_void_p, ctypes.c_int
    plain = {NT: TB.node_table_block_major_reference(h, w, b),
             PM: SP.packed_messages_reference(h, lay["src"], lay["mask"],
                                              lay["tile_type"], w, b)}
    base = {}
    for rnd in range(2):
        for name, (src, _) in VARIANTS.items():
            if not isinstance(built[name], list):
                continue
            lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
            if src == NT:
                fn = lib.ggnn_node_table
                fn.argtypes = [ci, vp, vp, vp, ci, ci, ci, vp, vp]
                out = torch.empty(N * T2, D, dtype=torch.bfloat16,
                                  device=dev)
                args = (1, h.data_ptr(), w.data_ptr(), b.data_ptr(),
                        N // 128, D, T2, out.data_ptr(), stream)
            else:
                fn = lib.ggnn_packed_messages
                fn.argtypes = [ci, vp, ctypes.c_longlong, ci, vp, vp, vp, ci,
                               ci, vp, vp, ci, vp, vp]
                out = torch.empty(P, D, device=dev)
                args = (1, h.data_ptr(), N, D, lay["src"].data_ptr(),
                        lay["mask"].data_ptr(), lay["tile_type"].data_ptr(),
                        P // 128, 128, w.data_ptr(), b.data_ptr(), T2,
                        out.data_ptr(), stream)
            if fn(*args):
                raise RuntimeError(f"{name}: the launch failed")
            ms = events_ms(lambda: fn(*args))
            note = ""
            if name.endswith("_base"):
                base[src] = out.clone()
                err = (out.float() - plain[src].float()).abs().max().item()
                note = f"; against the plain version max abs err {err:.3e}"
            elif name in SAME_BITS:
                if not torch.equal(out, base[src]):
                    raise AssertionError(f"{name}: not the base kernel's "
                                         "bits")
                note = "; the base kernel's bits"
            print(f"round {rnd} {name}: {ms:.3f} ms{note}", flush=True)
            del out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
