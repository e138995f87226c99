"""Windowed count-matrix SpMM: the CUDA kernel and its plain version.

Counterpart of ``ggnn_tpu/ops/window_pallas.py`` for
:func:`window_block_spmm_mono`, the kernel that reduces the legacy grad
layout of the typed pack's backward (``ops/scatter.py``,
``typed_reverse_scatter``) where the octet layout declines.  The port takes
its unpacked forms: the int32 dst-local stream (``dstl=True``) and the int8
count matrix, any ``win_stride``, ``c_off`` or a dense stream, dummy tiles,
f32 or bf16 output, ``out_rows = 128``.  The int4-packed stream, other
output heights and the window layouts' other kernels are ROADMAP Queue 1
item 5.

The kernel (``csrc/window_mono.cu``) and the per-tile typed kernels
(``csrc/typed_tile.cu``) share the hub split of :func:`split_plan`: each
output block's tiles are cut into work items of at most ``K`` tiles
(``ggnn_tile_split()`` of the library, 32), one CTA per item, with f32
partials summed in item order by a second kernel.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import BLOCK, _DTYPE_CODE, _check_cuda_args

_QUEUE_ITEM_5 = "ROADMAP Queue 1 item 5 (the window backend)"


def split_plan(tile_start, n_blocks: int):
    """The hub split on the device: ``item_first`` [n_blocks + 1] (block b's
    work items are item_first[b] .. item_first[b + 1], at least one) and
    ``pbase`` [n_blocks] (the first workspace slot of a block with more
    than one item), both int32, and the 0-d totals (items, partial slots)
    for the caller to read with its other host checks."""
    K = _build.library().ggnn_tile_split()
    ts = tile_start.to(torch.int32)
    nit = ((ts[1:] - ts[:-1]).clamp_min(0) + K - 1) // K
    nit = nit.clamp_min(1)
    item_first = torch.zeros(n_blocks + 1, dtype=torch.int32,
                             device=ts.device)
    item_first[1:] = torch.cumsum(nit, 0, dtype=torch.int32)
    pcount = torch.where(nit > 1, nit, torch.zeros_like(nit))
    pbase = torch.cumsum(pcount, 0, dtype=torch.int32) - pcount
    return item_first, pbase, item_first[-1], pcount.sum()


def host_ints(*scalars) -> list:
    """Integers and 0-d tensors (on one device) as Python ints, in one
    copy to the host."""
    dev = next((s.device for s in scalars if torch.is_tensor(s)), "cpu")
    return torch.stack([torch.as_tensor(s, device=dev).reshape(()).long()
                        for s in scalars]).tolist()


def _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, out_rows, packed,
                     win_stride, c_off, dstl):
    if dstl and packed:
        raise ValueError("dstl and packed are mutually exclusive")
    if packed:
        raise NotImplementedError(
            f"{name}: the int4-packed count stream is not ported yet "
            f"({_QUEUE_ITEM_5})")
    if out_rows != BLOCK:
        raise NotImplementedError(
            f"{name}: out_rows={out_rows}; the port takes out_rows={BLOCK} "
            f"(the transposed window pass is {_QUEUE_ITEM_5})")
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be [R, D], got "
                         f"{tuple(table.shape)}")
    R = table.shape[0]
    if win_stride is None and R % window:
        raise ValueError("table rows must be a multiple of window")
    n_tiles = win_of_tile.shape[0]
    if tuple(tile_start.shape) != (n_blocks + 1,):
        raise ValueError(f"{name}: tile_start {tuple(tile_start.shape)} is "
                         f"not [n_blocks + 1] = [{n_blocks + 1}]: layout and "
                         f"arguments disagree")
    for arg, t in (("block_of_tile", block_of_tile), ("c_off", c_off)):
        if t is not None and tuple(t.shape) != (n_tiles,):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"[n_tiles] = [{n_tiles}] like win_of_tile")
    want = torch.int32 if dstl else torch.int8
    if c_stream.dim() != 2 or c_stream.shape[1] != window \
            or c_stream.dtype != want:
        raise ValueError(f"{name}: the side stream must be {want} "
                         f"[rows, window={window}], got {c_stream.dtype} "
                         f"{tuple(c_stream.shape)}")
    if not dstl and c_stream.shape[0] % out_rows:
        raise ValueError(f"{name}: the count matrix's rows "
                         f"({c_stream.shape[0]}) are not a multiple of "
                         f"out_rows={out_rows}")
    for arg, t in (("tile_start", tile_start),
                   ("block_of_tile", block_of_tile),
                   ("win_of_tile", win_of_tile), ("c_off", c_off)):
        if t is not None and t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")


def _mono_data_checks(name, table, c_stream, win_of_tile, window, stride,
                      c_off, dstl, extra=()):
    """Refuse windows past the table and side-stream rows past the stream
    (one copy to the host, with ``extra`` 0-d tensors appended)."""
    n_tiles = win_of_tile.shape[0]
    n_c = c_stream.shape[0] if dstl else c_stream.shape[0] // BLOCK
    if n_tiles:
        real = win_of_tile >= 0
        zero = torch.zeros_like(win_of_tile)
        c = (torch.arange(n_tiles, dtype=torch.int32,
                          device=win_of_tile.device)
             if c_off is None else c_off)
        w_max, c_max, c_min, *rest = host_ints(
            torch.where(real, win_of_tile, zero).max(),
            torch.where(real, c, zero).max(),
            torch.where(real, c, zero).min(), *extra)
    else:
        w_max, c_max, c_min, *rest = host_ints(0, 0, 0, *extra)
    if w_max * stride + window > table.shape[0]:
        raise ValueError(f"{name}: window {w_max} reaches row "
                         f"{w_max * stride + window} of a table of "
                         f"{table.shape[0]} rows: it was not gathered with "
                         f"this layout")
    if c_min < 0 or (n_tiles and c_max >= n_c):
        raise ValueError(f"{name}: the tiles address side-stream entries "
                         f"[{c_min}, {c_max}] of {n_c}: layout and "
                         f"arguments disagree")
    return rest


def window_block_spmm_mono_reference(table, c_stream, tile_start,
                                     block_of_tile, win_of_tile,
                                     n_blocks: int, window: int,
                                     out_rows: int = BLOCK,
                                     packed: bool = False,
                                     win_stride: int | None = None,
                                     c_off=None, out_dtype=None,
                                     dstl: bool = False):
    """Plain version of :func:`window_block_spmm_mono`: every nonzero of
    each real tile's C (the one-hot of its dstl row, or its int8 counts)
    adds count·table row to its output row by ``index_add_`` in f32; one
    rounding to ``out_dtype`` at the end."""
    del tile_start, packed
    D, dev = table.shape[-1], table.device
    stride = window if win_stride is None else win_stride
    Y = torch.zeros(n_blocks * out_rows, D, dtype=torch.float32, device=dev)
    real = torch.nonzero(win_of_tile >= 0).flatten()
    c = real if c_off is None else c_off.long()[real]
    base = win_of_tile.long()[real] * stride
    blk = block_of_tile.long()[real] * out_rows
    if dstl:
        rows = c_stream.long()[c]                           # [n, window]
        valid = rows >= 0
        src = (base[:, None] + torch.arange(window, device=dev))[valid]
        Y.index_add_(0, (blk[:, None] + rows)[valid],
                     table.index_select(0, src).float())
    else:
        C = c_stream.reshape(-1, out_rows, window)[c]       # [n, rows, window]
        i, r, j = torch.nonzero(C, as_tuple=True)
        Y.index_add_(0, blk[i] + r, table.index_select(0, base[i] + j).float()
                     * C[i, r, j].float()[:, None])
    return Y.to(torch.float32 if out_dtype is None else out_dtype)


def window_block_spmm_mono(table, c_stream, tile_start, block_of_tile,
                           win_of_tile, n_blocks: int, window: int,
                           out_rows: int = BLOCK, packed: bool = False,
                           win_stride: int | None = None, c_off=None,
                           out_dtype=None, dstl: bool = False):
    """out[b·128:(b+1)·128] = Σ_{tiles t of b, win ≥ 0} C_t ·
    table[win[t]·stride : win[t]·stride + window] → [n_blocks·128, D] in
    ``out_dtype`` (default f32), summed in f32 and rounded once.

    ``table`` [R, D] in the compute dtype; ``c_stream`` the int32 dst-local
    stream [rows, window] (``dstl=True``) or the int8 count matrix
    [n·128, window], addressed per tile by ``c_off`` (None: tile t reads
    entry t); ``win_of_tile`` < 0 marks a dummy tile.  (The TPU kernel's
    grid split and DMA ring depth do not change the sums; the port has
    neither.)  A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/window_mono.cu`` or raises."""
    name = "window_block_spmm_mono"
    _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, out_rows, packed,
                     win_stride, c_off, dstl)
    stride = window if win_stride is None else win_stride
    if table.device.type == "cpu":
        _mono_data_checks(name, table, c_stream, win_of_tile, window, stride,
                          c_off, dstl)
        return window_block_spmm_mono_reference(
            table, c_stream, tile_start, block_of_tile, win_of_tile,
            n_blocks, window, out_rows, packed, win_stride, c_off, out_dtype,
            dstl)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    for what, dt in (("table", table.dtype), ("out_dtype", out_dtype)):
        if dt not in _DTYPE_CODE:
            raise ValueError(f"{name}: {what} {dt} not in {list(_DTYPE_CODE)}")
    D = table.shape[-1]
    named = [("table", table), ("c_stream", c_stream),
             ("tile_start", tile_start), ("win_of_tile", win_of_tile)]
    if c_off is not None:
        named.append(("c_off", c_off))
    _check_cuda_args(name, named, D)
    item_first, pbase, n_items, n_part = split_plan(tile_start, n_blocks)
    n_items, n_part = _mono_data_checks(name, table, c_stream, win_of_tile,
                                        window, stride, c_off, dstl,
                                        (n_items, n_part))
    dev = table.device
    ws = torch.empty(max(n_part, 1), BLOCK, D, dtype=torch.float32,
                     device=dev)
    out = torch.empty(n_blocks * BLOCK, D, dtype=out_dtype, device=dev)
    n_c = c_stream.shape[0] if dstl else c_stream.shape[0] // BLOCK
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_mono, name, dev, _DTYPE_CODE[table.dtype],
        _DTYPE_CODE[out_dtype], int(dstl), p(table), table.shape[0],
        p(c_stream), n_c, p(tile_start), p(win_of_tile), p(c_off), n_blocks,
        window, stride, p(item_first), p(pbase), n_items, n_part, p(ws),
        p(out))
    window_block_spmm_mono.launches += 1
    return out


window_block_spmm_mono.launches = 0
