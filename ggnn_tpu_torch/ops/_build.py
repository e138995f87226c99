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
from concurrent.futures import ThreadPoolExecutor
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
    "ggnn_gru_cell_pipe": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _P],
    # dtype, da_narrow, g, h, a, z, r, ht, wa, uzr, uh, dh, da, gates, dbp,
    # ws, dwa, db, duzr, duh, n_blocks, stream
    "ggnn_gru_cell_bwd": [_I, _I] + [_P] * 18 + [_I, _P],
    "ggnn_gru_bwd_chunks": [_I],
    # dtype, P, h, a, wa, b3, uzr, uh, rh, out_h, z, r, ht, n_blocks, stream
    "ggnn_gru_cell_wide": [_I, _I] + [_P] * 11 + [_I, _P],
    "ggnn_gru_wide_bwd_chunks": [_I],
    # dtype, da_narrow, P, g, h, a, z, r, ht, wa, uzr, uh, dh, da, gates,
    # dbp, ws, dwa, db, duzr, duh, n_blocks, stream
    "ggnn_gru_cell_bwd_wide": [_I, _I, _I] + [_P] * 18 + [_I, _P],
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
    # h_pack, n_pack, dstl, n_dstl, tile_start, tile_msg_off, c_off,
    # tile_type, dstl_len, msg_w, T2, n_blocks, tile_e, align, item_first,
    # pbase, n_items, split, n_split, init, hstate, wa, b3, uzr, uh, ws, out,
    # stream
    "ggnn_typed_step_fused": [_P, ctypes.c_longlong, _P, ctypes.c_longlong,
                              _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P,
                              _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P],
    # the same without init, hstate and the GRU weights (#7's STORE form)
    "ggnn_typed_onehot_fused": [_P, ctypes.c_longlong, _P,
                                ctypes.c_longlong, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _P,
                                _P],
    # fused, h_pack, n_pack, dstl_blk, slot_off16, blk_off16, dstl_len,
    # msg_w, n_blocks, T2, cmax, S8, tile_e, init, hstate, wa, b3, uzr, uh,
    # out, stream
    "ggnn_typed_block_fused": [_I, _P, ctypes.c_longlong, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P, _P],
    # h, n_h, counts, n_c, tile_start, win_of_tile, c_off, n_blocks,
    # out_rows, window, wbank, bbank, T2, item_first, rt, rt_start, pbase,
    # n_items, split_k, split, n_split, ws, scratch, out, stream
    "ggnn_window_ondemand_fused": [_P, ctypes.c_longlong, _P,
                                   ctypes.c_longlong, _P, _P, _P, _I, _I, _I,
                                   _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I,
                                   _P, _P, _P, _P],
    # table_dtype, out_dtype, dstl, packed, table, n_table, D, c_stream,
    # n_c, tile_start, win_of_tile, c_off, n_blocks, out_rows, window,
    # stride, item_first, pbase, n_items, n_partial, ws, out, stream
    "ggnn_window_mono": [_I, _I, _I, _I, _P, ctypes.c_longlong, _I, _P,
                         ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _P,
                         _P, _I, _I, _P, _P, _P],
    # src, dtype, fused, packed, width, table, n_table, counts, n_c,
    # tile_start, win_of_tile, c_off, n_blocks, out_rows, window, scales,
    # wbank, bbank, T2, init, hstate, wa, b3, uzr, uh, out, res, scratch,
    # stream
    "ggnn_window_step": [_I, _I, _I, _I, _I, _P, ctypes.c_longlong, _P,
                         ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _P, _P,
                         _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # dtype, h, msg_w, msg_b, n_blocks, T2, gtypes, P, out, scales, stream
    "ggnn_node_table_q8": [_I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # ids, out_dtype, table, n_table, c_stream, window, units, work,
    # n_work, zero_blk, n_zero, item_first, pbase, split, n_split, ws, out,
    # stream
    "ggnn_mono_fused": [_I, _I, _P, ctypes.c_longlong, _P, _I, _P, _P, _I,
                        _P, _I, _P, _P, _P, _I, _P, _P, _P],
    # dtype, msgs, n_msgs, D, onehot / dst_local, n_tiles, tile_start,
    # n_blocks, tile_e, item_first, pbase, n_items, n_partial, ws, out,
    # stream
    "ggnn_onehot_flat": [_I, _P, ctypes.c_longlong, _I, _P,
                         ctypes.c_longlong, _P, _I, _I, _P, _P, _I, _I, _P,
                         _P, _P],
    "ggnn_onehot_dstl": [_I, _P, ctypes.c_longlong, _I, _P,
                         ctypes.c_longlong, _P, _I, _I, _P, _P, _I, _I, _P,
                         _P, _P],
    # dtype, quant, da_t, scales, n_cols, counts, n_c, gt_start, gt_win,
    # gt_c_off, n_dst_blocks, BR, W, T2, n_src_blocks, group, D, msg_w, h,
    # dht, ws, dwt, walk, goff, stream
    "ggnn_window_bwd": [_I, _I, _P, _P, ctypes.c_longlong, _P,
                        ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # quant, S (the clusters of the bf16 fused backward that fit at once)
    "ggnn_window_bwd_slots": [_I, _I],
    # dtype, h, msg_w, msg_b, n_blocks, D, T2, out, stream
    "ggnn_node_table": [_I, _P, _P, _P, _I, _I, _I, _P, _P],
    # dtype, h, n_h, D, src, mask, tile_type, n_tiles, tile_e, msg_w, msg_b,
    # T2, out, stream
    "ggnn_packed_messages": [_I, _P, ctypes.c_longlong, _I, _P, _P, _P, _I,
                             _I, _P, _P, _I, _P, _P],
    # p, n_p, q, n_q, G, src, dst, mask, E, out, stream
    "ggnn_sddmm": [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _I, _P, _P,
                   _P, ctypes.c_longlong, _P, _P],
    # p, n_p, q, n_q, G, src, dst, mask, E, order, item_first, key_start,
    # n_keys, n_qblk, K, grid, out, stream
    "ggnn_sddmm_blocked": [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _I,
                           _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I,
                           _I, _I, ctypes.c_longlong, _P, _P],
    # dtype, packed, table, D, ent, items, n_items, split, n_split,
    # item_first, pbase, ws, out, stream
    "ggnn_window_auto_gather": [_I, _I, _P, _I, _P, _P, _I, _P, _I, _P, _P,
                                _P, _P, _P],
    # dtype, vec, vals, D, order, items, n_items, ws, split_row,
    # split_first, split_n, n_split, out, stream
    "ggnn_segment_rows": [_I, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I,
                          _P, _P],
    "ggnn_error_string": [_I],
}


class BuildInfo:
    """What the last build or load did: library path, seconds, ptxas log,
    each source's compile seconds."""

    path: str = ""
    per_source: dict = {}
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

        def compile_one(cmd):
            t = time.perf_counter()
            res = subprocess.run(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            return res, time.perf_counter() - t

        with ThreadPoolExecutor(len(cmds)) as pool:
            done = list(pool.map(compile_one, cmds))
        BuildInfo.per_source = {src.name: round(sec, 1)
                                for src, (_, sec) in zip(sources, done)}
        logs = [res.stdout for res, _ in done]
        for cmd, (res, _) in zip(cmds, done):
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                                   f"{' '.join(cmd)}\n{res.stdout}")
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
