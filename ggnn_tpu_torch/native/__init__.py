"""ctypes bindings of the port's native host library (``ggnn_host.cpp``).

The port's copy of ``ggnn_tpu/native``: the same C++ source and entry
points, with results identical to the port's numpy paths
(``tests/test_torch_native.py`` holds them array for array).  The library
is compiled from this directory's ``ggnn_host.cpp`` by ``g++`` at first use
(``$CXX`` if set) into ``ggnn_tpu_torch/_build/``, under a name that hashes
the source and the flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing is built at import time.

There is no silent fallback: a caller that asks for the library (or whose
size picks it) gets it or a :class:`NativeBuildError` carrying the
compiler's message.

- :func:`library` / :func:`build` / :func:`compiler`
- :func:`parse_graph_text_native`: ``data.babi.parse_graph_text``
- :func:`sort_edges_native`: ``graph._sort_edges``
- :func:`halo_plan_native`: the partition core of the reference's
  ``parallel/partition.py``
- :class:`WindowPlanNative`: the middle of ``ops.window.build_window_layout``
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "ggnn_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# the one set of flags (the Makefile calls build()); no -march=native: the
# library may be built on one machine and run on another
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")
# the composite key bound of ggnn_window_plan (about 2**62)
_WINDOW_KEY_MAX = 4.6e18

_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded."""


class BuildInfo:
    """What the last :func:`library` call did: ``compiled`` (False when an
    existing library was loaded), ``path`` and ``seconds``."""
    compiled = False
    path = ""
    seconds = 0.0


def compiler() -> str | None:
    """The C++ compiler :func:`build` runs (``$CXX``, else ``g++``), or
    None where there is none."""
    return shutil.which(os.environ.get("CXX", "g++"))


def build() -> Path:
    """Compile the library if this source, these flags and this compiler
    have no build yet; returns its path.  Raises :class:`NativeBuildError`
    with the compiler's message when it cannot be built."""
    cxx = compiler()
    if cxx is None:
        raise NativeBuildError(
            "the native host library needs a C++ compiler: "
            f"{os.environ.get('CXX', 'g++')!r} was not found")
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    # the compiler's identity is in the name too: a library built on
    # another machine, with another toolchain, is not loaded here
    digest = hashlib.sha256("\n".join((*CXX_FLAGS, version)).encode()
                            + SOURCE.read_bytes())
    so = BUILD_DIR / f"libggnn_host_{digest.hexdigest()[:16]}.so"
    BuildInfo.compiled = not so.exists()
    if BuildInfo.compiled:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"building the native host library failed "
                f"({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}"
                f"{res.stderr}")
        os.replace(tmp, so)      # atomic: concurrent builders race safely
    return so


def library() -> ctypes.CDLL:
    """The loaded library (built on first call, then cached; a failure is
    raised, not cached)."""
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    so = build()
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        raise NativeBuildError(f"loading {so} failed: {e}") from e
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p

    lib.ggnn_parse.restype = vp
    lib.ggnn_parse.argtypes = [ctypes.c_char_p, i64, i32, i32]
    lib.ggnn_parse_num_examples.restype = i64
    lib.ggnn_parse_num_examples.argtypes = [vp]
    lib.ggnn_example_info.argtypes = [vp, i64, i32p, i64p, i32p, i64p, i64p]
    lib.ggnn_example_fill.argtypes = [vp, i64, i32p, i32p, i32p]
    lib.ggnn_parse_free.argtypes = [vp]
    for name in ("ggnn_example_info", "ggnn_example_fill", "ggnn_parse_free",
                 "ggnn_sort_edges", "ggnn_halo_sizes", "ggnn_halo_fill",
                 "ggnn_halo_free", "ggnn_window_plan_sizes",
                 "ggnn_window_plan_export", "ggnn_window_fill_counts",
                 "ggnn_window_fill_counts_t", "ggnn_window_free"):
        getattr(lib, name).restype = None

    lib.ggnn_sort_edges.argtypes = [i64, i32p, i32p, i32p, i32, i32p, i32p,
                                    i32p, i32p]

    lib.ggnn_halo_plan.restype = vp
    lib.ggnn_halo_plan.argtypes = [i64, i32p, i32p, i32p, i32, i64, i32]
    lib.ggnn_halo_sizes.argtypes = [vp, i64p, i64p]
    lib.ggnn_halo_fill.argtypes = [vp, i32p, i32p, i32p, i32p, f32p, i32p,
                                   i32p]
    lib.ggnn_halo_free.argtypes = [vp]

    lib.ggnn_window_plan.restype = vp
    lib.ggnn_window_plan.argtypes = [i64, i64p, i64p, i64, i64, i64, i64,
                                     i64, i32, i32]
    lib.ggnn_window_plan_sizes.argtypes = [vp, i64p, i64p]
    lib.ggnn_window_plan_export.argtypes = [vp, u8p, i64p, i64p]
    lib.ggnn_window_fill_counts.argtypes = [vp, i64p, i64, i32, i8p]
    lib.ggnn_window_fill_counts_t.argtypes = [vp, i64p, i64, i32, i8p]
    lib.ggnn_window_free.argtypes = [vp]
    BuildInfo.path = str(so)
    BuildInfo.seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _ptr(a, ty=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def parse_graph_text_native(text: str, spec) -> list:
    """The native :func:`ggnn_tpu_torch.data.babi.parse_graph_text`."""
    from ggnn_tpu_torch.data.babi import Example

    lib = library()
    raw = text.encode()
    seq = spec.target_kind == "seq"
    h = lib.ggnn_parse(raw, len(raw), spec.n_args, 1 if seq else 0)
    try:
        out = []
        for i in range(lib.ggnn_parse_num_examples(h)):
            n_nodes, qtype = ctypes.c_int32(), ctypes.c_int32()
            n_edges, n_args, n_tgt = (ctypes.c_int64(), ctypes.c_int64(),
                                      ctypes.c_int64())
            lib.ggnn_example_info(h, i, ctypes.byref(n_nodes),
                                  ctypes.byref(n_edges), ctypes.byref(qtype),
                                  ctypes.byref(n_args), ctypes.byref(n_tgt))
            edges = np.empty((n_edges.value, 3), np.int32)
            args = np.empty((n_args.value,), np.int32)
            tgt = np.empty((n_tgt.value,), np.int32)
            lib.ggnn_example_fill(h, i, _ptr(edges), _ptr(args), _ptr(tgt))
            out.append(Example(
                n_nodes=int(n_nodes.value), edges=edges.astype(np.int64),
                question_type=int(qtype.value),
                args=tuple(int(a) for a in args),
                target=tgt if seq else np.asarray(tgt[0], np.int32)))
        return out
    finally:
        lib.ggnn_parse_free(h)


def sort_edges_native(src, dst, typ, n_types: int):
    """The native :func:`ggnn_tpu_torch.graph._sort_edges`: the edges
    sorted by (type, dst, src) and the type offsets [n_types + 1]."""
    lib = library()
    src, dst, typ = _i32(src), _i32(dst), _i32(typ)
    n = src.shape[0]
    if not src.shape == dst.shape == typ.shape == (n,):
        raise ValueError("src, dst and typ must be 1-d of one length")
    if n and (min(src.min(), dst.min(), typ.min()) < 0
              or typ.max() >= n_types):
        raise ValueError(f"node ids must be >= 0 and types in [0, "
                         f"{n_types})")
    o_src, o_dst, o_typ = (np.empty(n, np.int32) for _ in range(3))
    o_off = np.empty(n_types + 1, np.int32)
    lib.ggnn_sort_edges(n, _ptr(src), _ptr(dst), _ptr(typ), n_types,
                        _ptr(o_src), _ptr(o_dst), _ptr(o_typ), _ptr(o_off))
    return o_src, o_dst, o_typ, o_off


def halo_plan_native(src, dst, typ, n_shards: int, n_local: int,
                     n_types: int) -> dict:
    """The partition core of the reference's ``parallel/partition.py``
    over the REAL directed edges (unpadded): per-shard edges sorted by
    (type, local dst), their halo indices and each shard's send lists."""
    lib = library()
    src, dst, typ = _i32(src), _i32(dst), _i32(typ)
    if not src.shape == dst.shape == typ.shape == (src.shape[0],):
        raise ValueError("src, dst and typ must be 1-d of one length")
    if src.shape[0] and (
            min(src.min(), dst.min(), typ.min()) < 0
            or max(src.max(), dst.max()) >= n_shards * n_local
            or typ.max() >= n_types):
        raise ValueError(f"node ids must lie in [0, {n_shards * n_local}) "
                         f"and types in [0, {n_types})")
    h = lib.ggnn_halo_plan(src.shape[0], _ptr(src), _ptr(dst), _ptr(typ),
                           n_shards, n_local, n_types)
    try:
        e_local, H = ctypes.c_int64(), ctypes.c_int64()
        lib.ggnn_halo_sizes(h, ctypes.byref(e_local), ctypes.byref(H))
        P, E, Hs = n_shards, e_local.value, H.value
        esg, esh, edl, ety = (np.empty((P, E), np.int32) for _ in range(4))
        emk = np.empty((P, E), np.float32)
        tof = np.empty((P, n_types + 1), np.int32)
        hsi = np.empty((P, P, Hs), np.int32)
        lib.ggnn_halo_fill(h, _ptr(esg), _ptr(esh), _ptr(edl), _ptr(ety),
                           _ptr(emk, ctypes.c_float), _ptr(tof), _ptr(hsi))
        return {"edge_src_global": esg, "edge_src_halo": esh,
                "edge_dst_local": edl, "edge_type": ety, "edge_mask": emk,
                "type_offsets": tof, "halo_send_idx": hsi,
                "e_local": E, "halo_size": Hs}
    finally:
        lib.ggnn_halo_free(h)


class WindowPlanNative:
    """The native window-layout plan (``ggnn_window_plan``): one radix sort
    of the edges by (tile, table row, dst) in place of the numpy path's
    ``np.unique`` and ``np.add.at`` passes, with the same results.

    ``keep`` (per edge: its tile is dense and its (dst, row) pair within
    ``max_count``), ``dense_keys`` (the kept tiles' keys, ascending),
    ``dense_keys_t`` (the transposed keys, with ``want_grad``), and the
    count streams through :meth:`fill_counts` / :meth:`fill_counts_t`.
    A key space past the plan's bound (:meth:`fits`) raises."""

    def __init__(self, rows, dst, window, block_rows, n_wins, n_blocks,
                 min_edges, max_count, want_grad=False):
        if not self.fits(window, block_rows, n_wins, n_blocks):
            raise ValueError(
                "the native window plan's composite key would overflow "
                f"(n_blocks {n_blocks} x n_wins {n_wins} x window {window} "
                f"x block_rows {block_rows} >= 2**62); build with "
                "use_native=False")
        self._lib = library()
        rows = np.ascontiguousarray(rows, np.int64)
        dst = np.ascontiguousarray(dst, np.int64)
        n = rows.shape[0]
        if dst.shape != (n,) or rows.ndim != 1:
            raise ValueError("rows and dst must be 1-d of one length")
        self._h = self._lib.ggnn_window_plan(
            n, _ptr(rows, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
            window, block_rows, n_wins, n_blocks, min_edges, max_count,
            1 if want_grad else 0)
        if not self._h:
            raise ValueError("ggnn_window_plan refused its key space")
        self._window, self._block_rows = window, block_rows
        nd, ndt = ctypes.c_int64(), ctypes.c_int64()
        self._lib.ggnn_window_plan_sizes(self._h, ctypes.byref(nd),
                                         ctypes.byref(ndt))
        keep = np.empty(n, np.uint8)
        self.dense_keys = np.empty(nd.value, np.int64)
        self.dense_keys_t = np.empty(ndt.value, np.int64)
        self._lib.ggnn_window_plan_export(
            self._h, _ptr(keep, ctypes.c_uint8),
            _ptr(self.dense_keys, ctypes.c_int64),
            _ptr(self.dense_keys_t, ctypes.c_int64))
        self.keep = keep.astype(bool)

    @staticmethod
    def fits(window, block_rows, n_wins, n_blocks) -> bool:
        """Whether the plan's composite key fits its 62 bits."""
        return (float(n_blocks) * float(n_wins) * float(window)
                * float(block_rows)) < _WINDOW_KEY_MAX

    def fill_counts(self, uniq_t, pack: bool,
                    total_tiles: int | None = None) -> np.ndarray:
        """The forward count stream [total·block_rows, window (window/2
        packed)] int8 of the tiles ``uniq_t`` (ascending keys);
        ``total_tiles`` > len(uniq_t) appends all-zero padding tiles."""
        uniq_t = np.ascontiguousarray(uniq_t, np.int64)
        width = self._window // 2 if pack else self._window
        n = uniq_t.shape[0]
        total = n if total_tiles is None else total_tiles
        c = np.zeros((total * self._block_rows, width), np.int8)
        self._lib.ggnn_window_fill_counts(
            self._h, _ptr(uniq_t, ctypes.c_int64), n, 1 if pack else 0,
            _ptr(c, ctypes.c_int8))
        return c

    def fill_counts_t(self, uniq_gt, pack: bool) -> np.ndarray:
        """The transposed stream [len·window, block_rows (/2 packed)] int8
        of the backward tiles ``uniq_gt`` (ascending transposed keys)."""
        uniq_gt = np.ascontiguousarray(uniq_gt, np.int64)
        width = self._block_rows // 2 if pack else self._block_rows
        ct = np.empty((uniq_gt.shape[0] * self._window, width), np.int8)
        self._lib.ggnn_window_fill_counts_t(
            self._h, _ptr(uniq_gt, ctypes.c_int64), uniq_gt.shape[0],
            1 if pack else 0, _ptr(ct, ctypes.c_int8))
        return ct

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ggnn_window_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
