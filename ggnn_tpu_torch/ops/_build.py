"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc`` are compiled at first use by ``nvcc`` for
``sm_90a`` (one compiler process per source, run in parallel) and linked into
one shared library with a plain C interface, loaded with ctypes.  The library
lands in ``ggnn_tpu_torch/_build/`` under a name that
hashes the sources and flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time: this module imports on a
machine without CUDA, and the CPU tests import every module.

Each C entry point launches on the stream it is given and returns the
``cudaError_t`` of the launch; :func:`launch` passes the current stream of
the tensors' device and raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dtype, fused, h_pack, n_pack, dstl_blk, slot_off16, blk_off16, msg_w,
    # n_blocks, T2, cmax, S8, tile_e, init, hstate, wa, b3, uzr, uh, out,
    # stream
    "ggnn_typed_block": [_I, _I, _P, ctypes.c_longlong, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # dtype, h, a, wa, b3, uzr, uh, out_h, z, r, ht, n_blocks, stream
    "ggnn_gru_cell": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # dtype, da_narrow, g, h, a, z, r, ht, wa, uzr, uh, dh, da, gates, dbp,
    # ws, dwa, db, duzr, duh, n_blocks, stream
    "ggnn_gru_cell_bwd": [_I, _I] + [_P] * 18 + [_I, _P],
    "ggnn_gru_bwd_chunks": [_I],
    # g_dtype, out_dtype, G, n_G, dstl_oct, slot_off16, oblk16, n_oct,
    # g_tile, C, R8, out, stream
    "ggnn_grad_octet": [_I, _I, _P, ctypes.c_longlong, _P, _P, _P, _I, _I,
                        _I, _I, _P, _P],
    # dtype, fused, h_pack, n_pack, dstl, n_dstl, tile_start, tile_msg_off,
    # c_off, tile_type, msg_w, T2, n_blocks, tile_e, align, item_first,
    # pbase, n_items, n_partial, init, hstate, wa, b3, uzr, uh, ws, out,
    # stream
    "ggnn_typed_tile": [_I, _I, _P, ctypes.c_longlong, _P, ctypes.c_longlong,
                        _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "ggnn_tile_split": [],
    # table_dtype, out_dtype, dstl, table, n_table, c_stream, n_c,
    # tile_start, win_of_tile, c_off, n_blocks, window, stride, item_first,
    # pbase, n_items, n_partial, ws, out, stream
    "ggnn_window_mono": [_I, _I, _I, _P, ctypes.c_longlong, _P,
                         ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _P, _P,
                         _I, _I, _P, _P, _P],
    "ggnn_error_string": [_I],
}


class BuildInfo:
    """What the last build or load did: library path, seconds, ptxas log."""

    path: str = ""
    seconds: float = 0.0
    compiled: bool = False
    log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the port's kernels need nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


@functools.cache
def library() -> ctypes.CDLL:
    """The compiled kernel library (built on first call, then cached)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            digest.update(p.name.encode() + p.read_bytes())
    so = BUILD_DIR / f"libggnn_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    BuildInfo.compiled = not so.exists()
    if BuildInfo.compiled:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        # one nvcc per source, all started together, then one link
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        BuildInfo.log = "".join(logs) + res.stdout + res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ggnn_error_string.restype = ctypes.c_char_p
    BuildInfo.path = str(so)
    BuildInfo.seconds = time.perf_counter() - t0
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = library().ggnn_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def ptr(t) -> int | None:
    """data_ptr() of a tensor, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def launch(fn, name, device, *args) -> None:
    """Call C entry point ``fn`` with ``device`` current and its current
    stream appended to ``args``; raise if the launch failed."""
    import torch
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)
