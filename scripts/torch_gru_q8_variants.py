"""Where the time of the redesigned #4 ``gru_cell_bwd`` (bf16, D = 128:
``csrc/gru_cell_bwd_pipe.cu``) and #15 ``node_table_block_major_q8`` (bf16,
D = 128: ``csrc/node_table_q8.cu``) goes, on one NVIDIA GPU (H100), and
the parent's two kernels against this tree's in one process.

    python3 scripts/torch_gru_q8_variants.py [--parent DIR]

Each variant is the sources of ``csrc/`` after a few textual edits
(``VARIANTS`` below), compiled by nvcc for sm_90a into
``ggnn_tpu_torch/_build/variants_gru_q8/<name>/`` (one nvcc per variant,
all started together) and loaded with ctypes; its entry points are the
sources' own (``ggnn_gru_cell_bwd``, ``ggnn_node_table_q8``).  ``base``
must give the library's bits, and so must the variants marked ``same``
in ``SAME``; the others change the result and are only timed.  Inputs: #4
at the uniform headline's 262,144 rows (chip_smoke.py's
``gru_bwd_inputs``, seed 2, da f32), #15 at the community headline's
(262,144 nodes, T2 = 16, W 512: 4 types a window; the model's weights
from seed 0, h uniform in (−1, 1)).

- #4: ``w_reload`` loads the six weight panels again at every 32-row
  sub-block (what keeping them resident saves: the part a ring of stages
  would still pay); ``no_prefetch`` loads a sub-block's g, z, h̃, h and r
  at its start instead of one sub-block ahead; ``chunk_fastest`` runs the
  params pass's grid with the chunk index fastest (the parent's order)
  instead of the product index; ``rows_only``, ``params_only`` and
  ``reduce_only`` launch one of the three kernels; ``reduce_serial_db``
  is ``reduce_only`` with db's block partials summed by one thread a
  column in one loop (the parent's reduce).
- #15: ``q8_a`` runs design (a), the products twice in one CTA a window,
  where the tree runs (b), a cluster of gtypes CTAs with the max
  exchanged through distributed shared memory (both give the same bits);
  ``q8_b_nosync`` drops (b)'s cluster barrier and exchange (each CTA
  quantizes with its own type's max), ``q8_b_nostore`` its int8 stores,
  ``q8_b_norows`` the copies of the source blocks' rows.

``--parent DIR`` times DIR's ``gru_cell_bwd.cu`` and ``node_table_q8.cu``
(built as the variant ``parent``, with DIR's headers) against ``base`` in
turns (parent, base, base, parent, three times over) in one process on the
same inputs, so that neither the kernel before it nor the card's clocks
favour one tree.

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
OUT = os.path.join(ROOT, "ggnn_tpu_torch", "_build", "variants_gru_q8")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
BWD, PIPE, Q8 = "gru_cell_bwd.cu", "gru_cell_bwd_pipe.cu", "node_table_q8.cu"
TOP = "    strip_sync(strip);  // the strip is done with the last sub-block's"
W_RELOAD = (PIPE, TOP, "    __syncthreads();\n    load_panels();\n"
            "    pipe::cp_async_wait_all();\n    __syncthreads();\n" + TOP)
NO_PREFETCH = [(PIPE, "    if (s + 1 < s1) load_gzt(s + 1);\n", ""),
               (PIPE, "    if (s + 1 < s1) load_hr(s + 1);\n", ""),
               (PIPE, TOP, "    load_gzt(s);\n    load_hr(s);\n" + TOP)]
CHUNK_FASTEST = [
    (PIPE, "const int p = blockIdx.x, chunk = blockIdx.y, tid = threadIdx.x;",
     "const int p = blockIdx.y, chunk = blockIdx.x, tid = threadIdx.x;"),
    (PIPE, "<<<dim3(6, n_chunks),", "<<<dim3(n_chunks, 6),")]
NO_ROWS = (PIPE, "  rows<<<n_ctas,", "  if (n_ctas < 0) rows<<<n_ctas,")
NO_PARAMS = (PIPE, "  gbwd::gru_bwd_params_bf16<<<",
             "  if (n_chunks < 0) gbwd::gru_bwd_params_bf16<<<")
NO_REDUCE = (PIPE, "  gbwd::gru_bwd_reduce_bf16<<<",
             "  if (n_chunks < 0) gbwd::gru_bwd_reduce_bf16<<<")
SERIAL_DB = (PIPE, "  for (int b = w; b < n_blocks; b += 8) s += dbp",
             "  for (int b = w == 0 ? 0 : n_blocks; b < n_blocks; ++b) s += "
             "dbp")
Q8_A = (Q8, "P == 1 && gtypes <= ggnn::kMaxCluster", "P == 1 && gtypes < 0")
Q8_NOSYNC = [(Q8, "    wpipe::cluster_sync();  // every CTA's max is in every",
              "    __syncthreads();  // every CTA's max is in every"),
             (Q8, "wpipe::map_rank(&slot[par][rank], tid)",
              "wpipe::map_rank(&slot[par][rank], rank)")]
Q8_NOSTORE = (Q8, "      __stcs(reinterpret_cast<int4*>(dst + r * 128 + v * 16),"
              "\n             *reinterpret_cast<const int4*>(O_s + r * kLd8 + "
              "v * 16));\n    }\n  }\n}\n\nint launch_node_table_q8_cluster",
              "    }\n  }\n}\n\nint launch_node_table_q8_cluster")
Q8_NOROWS = (Q8, "    if (item + 1 < it1) stage_rows(item + 1, st ^ 1);", "")
ALL = (BWD, PIPE, Q8)
# name: (edits, sources the variant's library holds)
VARIANTS = {
    "base": ([], ALL), "w_reload": ([W_RELOAD], (BWD, PIPE)),
    "no_prefetch": (NO_PREFETCH, (BWD, PIPE)),
    "chunk_fastest": (CHUNK_FASTEST, (BWD, PIPE)),
    "rows_only": ([NO_PARAMS, NO_REDUCE], (BWD, PIPE)),
    "params_only": ([NO_ROWS, NO_REDUCE], (BWD, PIPE)),
    "reduce_only": ([NO_ROWS, NO_PARAMS], (BWD, PIPE)),
    "reduce_serial_db": ([NO_ROWS, NO_PARAMS, SERIAL_DB], (BWD, PIPE)),
    "q8_a": ([Q8_A], (Q8,)), "q8_b_nosync": (Q8_NOSYNC, (Q8,)),
    "q8_b_nostore": ([Q8_NOSTORE], (Q8,)),
    "q8_b_norows": ([Q8_NOROWS], (Q8,)),
}
SAME = ("base", "w_reload", "no_prefetch", "chunk_fastest", "q8_a")


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
    cmd = [*FLAGS, "-o", os.path.join(d, "libvariant.so"), src]
    from torch.utils.cpp_extension import CUDA_HOME
    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *cmd],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    regs = [line.strip() for line in (res.stdout + res.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return os.path.join(d, "libvariant.so"), regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="time the parent tree's #4 and #15 against this "
                         "tree's")
    args = ap.parse_args()
    variants = VARIANTS
    if args.parent:
        pdir = os.path.join(os.path.abspath(args.parent), "ggnn_tpu_torch",
                            "ops", "csrc")
        srcs = tuple(f for f in ALL if os.path.exists(os.path.join(pdir, f)))
        variants = {"base": ([], ALL), "parent": ([], srcs, pdir)}
    import torch
    if not torch.cuda.is_available():
        print("torch_gru_q8_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import table as TB
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
        print(f"  {n}: {' | '.join(regs)[:900]}")
    fns = {}
    for n, (so, _) in libs.items():
        lib = ctypes.CDLL(so)
        for entry in ("ggnn_gru_cell_bwd", "ggnn_node_table_q8"):
            if hasattr(lib, entry):
                getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
                getattr(lib, entry).restype = ctypes.c_int
        fns[n] = lib

    p = _build.ptr
    stream = lambda: torch.cuda.current_stream().cuda_stream
    bf, f32 = torch.bfloat16, torch.float32
    dev = torch.device("cuda")

    # --- #4 at the uniform headline's rows ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    x = cs.gru_bwd_inputs(cs.NODES, bf, gen)
    N, D = x[1].shape
    nb = N // 128
    n_chunks = (nb + 15) // 16
    w_a, u_zr, uh = (w.to(bf).contiguous() for w in x[6:])
    o4 = dict(dh=torch.empty(N, D, dtype=f32, device=dev),
              da=torch.empty(N, D, dtype=f32, device=dev),
              gates=torch.empty(3, N, D, dtype=bf, device=dev),
              dbp=torch.empty(nb, 3 * D, dtype=f32, device=dev),
              ws=torch.empty(n_chunks * 6 * D * D, dtype=f32, device=dev),
              dwa=torch.empty(D, 3 * D, dtype=f32, device=dev),
              db=torch.empty(1, 3 * D, dtype=f32, device=dev),
              duzr=torch.empty(D, 2 * D, dtype=f32, device=dev),
              duh=torch.empty(D, D, dtype=f32, device=dev))
    outs4 = ("dh", "da", "dwa", "db", "duzr", "duh")

    def bwd(lib):
        def go():
            err = lib.ggnn_gru_cell_bwd(
                1, 0, p(x[0]), p(x[1]), p(x[2]), p(x[3]), p(x[4]), p(x[5]),
                p(w_a), p(u_zr), p(uh), *(p(o4[k]) for k in (
                    "dh", "da", "gates", "dbp", "ws", "dwa", "db", "duzr",
                    "duh")), nb, stream())
            if err:
                raise RuntimeError(f"ggnn_gru_cell_bwd: launch failed: {err}")
        return go

    want4 = G.gru_cell_bwd(*x, mdt=bf)

    # --- #15 at the community headline --------------------------------------
    cfg = ModelConfig(state_dim=128, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    w, b, _ = cs.window_weights(params, bf)
    h = (torch.rand(cs.NODES, D, device=dev, generator=gen) * 2 - 1).to(bf)
    W_, T2 = 512, w.shape[0]
    tq = torch.empty(cs.NODES * T2, D, dtype=torch.int8, device=dev)
    sc = torch.empty(cs.NODES * T2 // W_, 1, dtype=f32, device=dev)

    def q8(lib):
        def go():
            err = lib.ggnn_node_table_q8(1, p(h), p(w), p(b), cs.NODES // 128,
                                         T2, W_ // 128, 1, p(tq), p(sc),
                                         stream())
            if err:
                raise RuntimeError(f"ggnn_node_table_q8: launch failed: "
                                   f"{err}")
        return go

    want15 = TB.node_table_block_major_q8(h, w, b, W_)

    def best(fn, iters=10):
        return min(cs.cuda_ms(fn, iters) for _ in range(2))

    runs = {}
    for n, lib in fns.items():
        if hasattr(lib, "ggnn_gru_cell_bwd"):
            runs[f"4:{n}"] = bwd(lib)
        if hasattr(lib, "ggnn_node_table_q8"):
            runs[f"15:{n}"] = q8(lib)
    same = {}
    for key, fn in runs.items():
        kern, n = key.split(":")
        print(f"  running {key}", flush=True)
        fn()
        torch.cuda.synchronize()
        if kern == "4":
            ok = all(torch.equal(o4[k], v) for k, v in zip(outs4, want4))
        else:
            ok = torch.equal(tq, want15[0]) and torch.equal(sc, want15[1])
        same[key] = ok
        if n in SAME and not ok:
            raise AssertionError(f"variant {key} changed the bits")
    times = {k: [] for k in runs}
    rounds = 3 if args.parent else 1
    for _ in range(rounds):
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
