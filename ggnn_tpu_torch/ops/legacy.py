"""The legacy table-gather onehot path: layouts, kernels, aggregation.

Counterpart of ``ggnn_tpu/ops/scatter_pallas.py``'s legacy layout and its
scatters, array for array and rounding point for rounding point:

- :class:`DstBlockLayout` and :func:`build_dst_block_layout` (host, numpy):
  real directed edges grouped by 128-row destination block, each block's
  edges packed into ``tile_e``-edge tiles; :meth:`DstBlockLayout.to` is the
  reference's ``to_device``, a :class:`~ggnn_tpu_torch.ops.scatter.
  ScatterLayout` with its 8-tuple ``meta``.  The typed pack's backward
  builds its grad layout with it where the octet layout declines.
- :func:`layout_for_batch` (the static-budget layout the reference's
  ``Predictor`` and ``Trainer`` build for ``backend='onehot'``) and
  :func:`build_chunked_dst_layouts` (contiguous dst ranges, so that the
  messages of one range exist at a time: how a 1M-node graph fits).
- :func:`onehot_segment_scatter_flat` (the int8 one-hot stream) and
  :func:`onehot_segment_scatter` (dst-local ids), the two scatters of the
  table-gather forward: each is
  :func:`~ggnn_tpu_torch.ops.window.window_block_spmm_mono` with ``window =
  tile_e`` and tile t reading its own messages, as the reference says of
  them, and runs #11's kernels (bf16 at D = 128:
  ``csrc/window_mono_fused.cu`` on the layout's plan; else entry points of
  ``csrc/window_mono.cu``); :func:`onehot_segment_scatter_mono` is that
  kernel itself.
- :func:`onehot_segment_scatter_stream` (#18) and
  :func:`onehot_segment_scatter_loopT` (#19), the reference's other two
  variants of the one-hot stream scatter, which only its kernel-variant
  sweep and tests run (``scripts/torch_scatter_variants.py`` here): #18
  in bf16 at D = 128 with tile_e % 16 = 0 as #11's count form
  (``csrc/window_mono_fused.cu``); #19 in every form, and #18 in the
  others, as #20's gather-sum (``csrc/window_auto_gather.cu``) on the
  stream's nonzero bytes, listed once per layout by
  :func:`loopT_plan_once`.
- :func:`legacy_forward` (``_aggregate_impl``'s table-gather branch: the
  node-transform table of ``ops/table.py``, the gather, then the scatter
  the layout carries) and :func:`aggregate_onehot_chunked` (forward only,
  as in the reference).  The backward is ``ops/scatter.py::aggregate_bwd``.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import (_DTYPE_CODE, _check_cuda_args,
                                    _scatter_data_checks, host_ints)
from ggnn_tpu_torch.ops.scatter import (BLOCK_N, ScatterLayout, _rup,
                                        _rup_block)
from ggnn_tpu_torch.ops.table import node_table
from ggnn_tpu_torch.ops.window import (cached_per_tensor, group_mask,
                                       launch_mono_fused, launch_window_auto,
                                       mono_plan_once, split_plan,
                                       tile_arange, window_auto_plan,
                                       window_block_spmm_mono)


@dataclasses.dataclass
class DstBlockLayout:
    """Host-built scatter layout (numpy arrays), field for field the
    reference's:

    - ``gather_idx`` [E_pack]: row of the table each packed edge reads
      (``type · N_src + src``, or block-major with ``row_order='block'``);
      padding rows point at 0;
    - ``dst_local`` [E_pack]: ``dst − 128·block``, or −1 for padding;
    - ``tile_start`` [n_blocks + 1] / ``block_of_tile``: the tiles of each
      dst block (at least one per block); ``max_tiles`` their maximum;
    - ``dst_global`` [E_pack]: the global dst, −1 for padding;
    - ``onehot`` [n_tiles·128, tile_e] int8 or ``dstl`` [n_tiles_pad8,
      tile_e] int32: the side stream of the scatter;
    - ``tile_msg_off`` / ``edge_align``: per-tile pack offsets in
      ``edge_align`` units where the pack is aligned;
    - ``grad``: the transposed layout of the backward; ``indeg`` its
      per-(type, dst) edge counts."""

    n_nodes_pad: int
    tile_e: int
    max_tiles: int
    gather_idx: np.ndarray
    dst_local: np.ndarray
    tile_start: np.ndarray
    block_of_tile: np.ndarray
    dst_global: np.ndarray
    onehot: "np.ndarray | None" = None
    grad: "DstBlockLayout | None" = None
    tile_msg_off: "np.ndarray | None" = None
    edge_align: "int | None" = None
    row_order: str = "type"
    indeg: "np.ndarray | None" = None
    dstl: "np.ndarray | None" = None

    @property
    def n_blocks(self) -> int:
        return self.n_nodes_pad // BLOCK_N

    def to(self, device) -> ScatterLayout:
        """The device form, the reference's ``to_device``: the same array
        keys (the grad half's under ``g_``) as tensors on ``device``, and
        ``meta`` = (n_nodes_pad, tile_e, max_tiles, n_blocks, has_onehot,
        grad_meta, edge_align, row_order), ``grad_meta`` = (n_blocks,
        max_tiles, tile_e, has_onehot, edge_align) of the grad half or
        None."""
        arrays = {"gather_idx": self.gather_idx,
                  "tile_start": self.tile_start,
                  "block_of_tile": self.block_of_tile,
                  "dst_local": self.dst_local, "dst_global": self.dst_global}
        for key in ("onehot", "dstl", "tile_msg_off"):
            if getattr(self, key) is not None:
                arrays[key] = getattr(self, key)
        grad_meta = None
        g = self.grad
        if g is not None:
            for key in ("gather_idx", "tile_start", "block_of_tile",
                        "dst_local", "onehot", "dstl", "tile_msg_off",
                        "indeg"):
                if getattr(g, key) is not None:
                    arrays[f"g_{key}"] = getattr(g, key)
            grad_meta = (g.n_blocks, g.max_tiles, g.tile_e,
                         g.onehot is not None, g.edge_align)
        meta = (self.n_nodes_pad, self.tile_e, self.max_tiles, self.n_blocks,
                self.onehot is not None, grad_meta, self.edge_align,
                self.row_order)
        return ScatterLayout(meta, {k: torch.as_tensor(v, device=device)
                                    for k, v in arrays.items()})


def static_tile_budget(e_pad: int, n_rows_pad: int, tile_e: int) -> int:
    """The most tiles any graph of at most ``e_pad`` real edges into
    ``n_rows_pad`` rows packs into: each dst block wastes less than one
    tile, plus one tile per (possibly empty) block.  As ``pad_tiles_to``
    it makes the layout's shapes depend on (e_pad, n_rows_pad, tile_e)
    alone."""
    return -(-e_pad // tile_e) + n_rows_pad // BLOCK_N


def build_dst_block_layout(edge_src, edge_dst, edge_type, edge_mask,
                           n_nodes_pad: int, tile_e: int = 128,
                           with_grad: bool = False,
                           n_message_types: int | None = None,
                           onehot_stream: bool = True,
                           n_src_rows: int | None = None,
                           pad_tiles_to: int | None = None,
                           grad_tile_e: int | None = None,
                           grad_pad_tiles_to: int | None = None,
                           edge_align: int | None = None,
                           row_order: str = "type",
                           dstl_stream: bool = False) -> DstBlockLayout:
    """Group real directed edges by destination block and pack each block
    into ``tile_e``-edge tiles (the reference function, every option).

    - ``with_grad``: also the transposed layout (grouped by table row,
      gathering from dst) and its per-(type, dst) counts;
    - ``n_src_rows``: the source row space, when it differs from the dst
      space (default ``n_nodes_pad``);
    - ``pad_tiles_to`` (``grad_tile_e``, ``grad_pad_tiles_to`` for the grad
      half): pad to a fixed tile count (:func:`static_tile_budget`), the
      extra all-padding tiles going to the last block;
    - ``row_order``: 'type' (row = t·N_src + src) or 'block'
      (row = (src // 128)·T2·128 + t·128 + src % 128);
    - ``edge_align``: pack each block at ``edge_align``-row alignment, with
      per-tile offsets ``tile_msg_off`` (tiles may overlap the next block's
      rows; their side-stream columns there are empty);
    - ``onehot_stream`` / ``dstl_stream``: the int8 one-hot side stream,
      or the int32 dst-local one (needs ``edge_align``), or neither."""
    if n_nodes_pad % BLOCK_N:
        raise ValueError(f"n_nodes_pad must be a multiple of {BLOCK_N}")
    if n_src_rows is None:
        n_src_rows = n_nodes_pad
    if row_order not in ("type", "block"):
        raise ValueError(f"row_order must be 'type' or 'block': {row_order!r}")
    if row_order == "block":
        if n_message_types is None:
            raise ValueError("row_order='block' needs n_message_types")
        if n_src_rows % 128:
            raise ValueError("row_order='block' needs n_src_rows % 128 == 0")
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)

    def table_row(src, typ):
        if row_order == "block":
            return (src // 128) * (n_message_types * 128) \
                + typ * 128 + src % 128
        return typ * n_src_rows + src

    # by dst block, then by table row (order inside a block is free)
    grow = table_row(src, typ)
    order = np.lexsort((grow, dst // BLOCK_N))
    src, dst, typ = src[order], dst[order], typ[order]

    n_blocks = n_nodes_pad // BLOCK_N
    block = dst // BLOCK_N
    counts = np.bincount(block, minlength=n_blocks)
    tiles = (counts + tile_e - 1) // tile_e
    tiles = np.maximum(tiles, 1)          # every block gets a tile
    if pad_tiles_to is not None:
        extra = pad_tiles_to - int(tiles.sum())
        if extra < 0:
            raise ValueError(
                f"pad_tiles_to={pad_tiles_to} < required {int(tiles.sum())}")
        tiles[-1] += extra
    tile_start = np.zeros(n_blocks + 1, np.int32)
    np.cumsum(tiles, out=tile_start[1:])
    max_tiles = (pad_tiles_to if pad_tiles_to is not None
                 else int(tiles.max()) if n_blocks else 1)

    block_edge_start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(counts, out=block_edge_start[1:])
    rank = np.arange(src.shape[0]) - block_edge_start[block]
    tile_msg_off = None
    if edge_align is not None:
        if not onehot_stream:
            raise ValueError("edge_align needs onehot_stream=True (only the "
                             "mono win_stride kernel reads aligned packs)")
        A = edge_align
        if tile_e % A:
            raise ValueError(f"edge_align={A} must divide tile_e={tile_e}")
        base = np.zeros(n_blocks + 1, np.int64)
        np.cumsum(-(-counts // A) * A, out=base[1:])
        e_pack = int(base[-1]) + tile_e
        if pad_tiles_to is not None:
            e_pack = pad_tiles_to * tile_e + tile_e
        pos = base[block] + rank
        tile_of = tile_start[block].astype(np.int64) + rank // tile_e
        col = rank % tile_e
        tile_msg_off = np.zeros(int(tile_start[-1]), np.int32)
        for_blocks = np.repeat(np.arange(n_blocks), tiles.astype(np.int64))
        k_in_block = (np.arange(tile_msg_off.shape[0])
                      - tile_start[for_blocks])
        tile_msg_off[:] = ((base[for_blocks] + k_in_block * tile_e) // A
                           ).astype(np.int32)
        # padding tiles past the last block's range stay inside the pack
        np.minimum(tile_msg_off, (e_pack - tile_e) // A, out=tile_msg_off)
    else:
        e_pack = max(int(tile_start[-1]) * tile_e, tile_e)
        pos = tile_start[block].astype(np.int64) * tile_e + rank
        tile_of = pos // tile_e
        col = pos % tile_e

    gather_idx = np.zeros(e_pack, np.int32)
    dst_local = np.full(e_pack, -1, np.int32)
    dst_global = np.full(e_pack, -1, np.int32)
    gather_idx[pos] = table_row(src, typ).astype(np.int32)
    dst_local[pos] = (dst - block * BLOCK_N).astype(np.int32)
    dst_global[pos] = dst.astype(np.int32)
    block_of_tile = np.repeat(np.arange(n_blocks, dtype=np.int32),
                              tiles.astype(np.int64))
    onehot = None
    dstl = None
    if onehot_stream and dstl_stream:
        if edge_align is None:
            raise ValueError("dstl_stream needs edge_align (only the mono "
                             "win_stride kernel synthesizes one-hots)")
        n_total_tiles = int(tile_start[-1])
        dstl = np.full((_rup(max(n_total_tiles, 1), 8), tile_e), -1,
                       np.int32)
        dstl[tile_of, col] = dst_local[pos]
    elif onehot_stream:
        # per tile, transposed: [n_tiles·128, tile_e]
        n_total_tiles = int(tile_start[-1])
        onehot = np.zeros((n_total_tiles * BLOCK_N, tile_e), np.int8)
        onehot[tile_of * BLOCK_N + dst_local[pos], col] = 1
    grad = None
    if with_grad:
        if n_message_types is None:
            n_message_types = int(typ.max(initial=0)) + 1
        # grouped by table row, gathering from dst; its tile size from its
        # own average block occupancy
        n_rows_grad = _rup_block(n_message_types * n_src_rows)
        if grad_tile_e is not None:
            g_tile = grad_tile_e
        else:
            avg = max(1, src.shape[0] * BLOCK_N // max(n_rows_grad, 1))
            g_tile = 128
            while g_tile < min(avg, tile_e):
                g_tile *= 2
        grad = build_dst_block_layout(
            edge_src=dst, edge_dst=table_row(src, typ),
            edge_type=np.zeros_like(typ),
            edge_mask=np.ones(dst.shape[0], np.float32),
            n_nodes_pad=n_rows_grad,
            tile_e=g_tile, with_grad=False, onehot_stream=onehot_stream,
            n_src_rows=n_nodes_pad, pad_tiles_to=grad_pad_tiles_to,
            edge_align=(16 if onehot_stream and g_tile % 16 == 0 else None),
            dstl_stream=(dstl_stream and onehot_stream
                         and g_tile % 16 == 0))
        grad.indeg = np.bincount(
            typ * np.int64(n_nodes_pad) + dst,
            minlength=n_message_types * n_nodes_pad).reshape(
                n_message_types, n_nodes_pad).astype(np.float32)
    return DstBlockLayout(
        n_nodes_pad=n_nodes_pad, tile_e=tile_e,
        max_tiles=max(max_tiles, 1), gather_idx=gather_idx,
        dst_local=dst_local, tile_start=tile_start,
        block_of_tile=block_of_tile, dst_global=dst_global,
        onehot=onehot, grad=grad, tile_msg_off=tile_msg_off,
        edge_align=edge_align, row_order=row_order, dstl=dstl)


def layout_for_batch(batch, tile_e: int = 128, with_grad: bool = True,
                     device="cuda") -> ScatterLayout:
    """The static-shape layout of a :class:`~ggnn_tpu_torch.graph.
    GraphBatch` (the reference function), on ``device``: tile counts padded
    to the :func:`static_tile_budget` of the batch's PaddingSpec, so every
    batch of a run has the same shapes; block-major table rows where
    ``spec.n_pad % 128 == 0``; with ``with_grad`` the grad half at
    ``tile_e`` 128, its own budget and 16-row alignment."""
    spec = batch.spec
    t2 = 2 * spec.n_edge_types
    # dst rows pad up to the 128-row block grid; the table's source rows
    # stay spec.n_pad (h's row count)
    n_dst = _rup_block(spec.n_pad)
    g_rows = _rup_block(t2 * spec.n_pad)
    return build_dst_block_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_dst, tile_e=tile_e, with_grad=with_grad, n_message_types=t2,
        n_src_rows=spec.n_pad,
        pad_tiles_to=static_tile_budget(spec.e_pad, n_dst, tile_e),
        grad_tile_e=128 if with_grad else None,
        grad_pad_tiles_to=(static_tile_budget(spec.e_pad, g_rows, 128)
                           if with_grad else None),
        row_order="block" if spec.n_pad % 128 == 0 else "type").to(device)


def build_chunked_dst_layouts(edge_src, edge_dst, edge_type, edge_mask,
                              n_nodes_pad: int, n_chunks: int,
                              tile_e: int = 2048, onehot_stream: bool = True,
                              device="cuda") -> list:
    """The layout cut into ``n_chunks`` contiguous dst ranges (the reference
    function), each on ``device``, so that the messages of one range exist
    at a time (peak memory / n_chunks).  Gather rows stay global
    (t·N + src of the whole table); only destinations are chunk-local."""
    if n_nodes_pad % (BLOCK_N * n_chunks):
        raise ValueError("n_nodes_pad must divide into n_chunks×128 blocks")
    rows_per_chunk = n_nodes_pad // n_chunks
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real]
    dst = np.asarray(edge_dst)[real]
    typ = np.asarray(edge_type)[real]
    chunk_of = dst // rows_per_chunk
    layouts = []
    for c in range(n_chunks):
        sel = chunk_of == c
        layouts.append(build_dst_block_layout(
            src[sel], dst[sel] - c * rows_per_chunk, typ[sel],
            np.ones(int(sel.sum()), np.float32), rows_per_chunk,
            tile_e=tile_e, onehot_stream=onehot_stream,
            n_src_rows=n_nodes_pad).to(device))
    return layouts


def _check_scatter_args(name, messages, stream, tile_start, n_blocks,
                        tile_e, n_tiles, stream_shape, stream_dtype):
    if messages.dim() != 2:
        raise ValueError(f"{name}: messages must be [E_pack, D], got "
                         f"{tuple(messages.shape)}")
    if tuple(stream.shape) != stream_shape or stream.dtype != stream_dtype:
        raise ValueError(f"{name}: the side stream must be {stream_dtype} "
                         f"{list(stream_shape)}, got {stream.dtype} "
                         f"{list(stream.shape)}: layout and arguments "
                         f"disagree")
    if tuple(tile_start.shape) != (n_blocks + 1,):
        raise ValueError(f"{name}: tile_start {tuple(tile_start.shape)} is "
                         f"not [n_blocks + 1] = [{n_blocks + 1}]: layout and "
                         f"arguments disagree")
    if tile_start.dtype != torch.int32:
        raise ValueError(f"{name}: tile_start must be int32, got "
                         f"{tile_start.dtype}")
    if messages.shape[0] < n_tiles * tile_e:
        raise ValueError(f"{name}: messages has {messages.shape[0]} rows, "
                         f"fewer than the layout's {n_tiles} tiles of "
                         f"{tile_e} ({n_tiles * tile_e}): it was not gathered "
                         f"with this layout")


def _launch_scatter(entry, name, messages, stream, n_c, tile_start,
                    n_blocks, tile_e, checks, dstl, key=()):
    """Launch a legacy scatter over the hub split: bf16 at D = 128 and
    tile_e % 16 = 0 through ``csrc/window_mono_fused.cu`` on the layout's
    plan (#11's dst-local or count form, window = stride = tile_e, tile t
    reading window t), else through C entry point ``entry`` of
    ``csrc/window_mono.cu``.  The data checks ``checks(extra)`` (which
    return the 0-d ``extra`` tensors as ints), the one-hot check of a
    stream that is not ``dstl`` (:func:`~ggnn_tpu_torch.ops.window.
    group_mask`) and the split run once per layout (``cached_per_tensor``
    on ``tile_start``, ``key`` naming what else the checks read): a launch
    on a layout already seen copies nothing to the host."""
    if messages.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {messages.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    D = messages.shape[-1]
    _check_cuda_args(name, [("messages", messages), ("stream", stream),
                            ("tile_start", tile_start)], D, any_width=True)
    dev = messages.device
    if messages.dtype == torch.bfloat16 and D == BLOCK_N and tile_e % 16 == 0:
        c = stream.view(n_c, tile_e) if dstl else stream
        plan = mono_plan_once(name, messages.shape[0], c, tile_start,
                              tile_arange(tile_start, n_c), None, n_blocks,
                              tile_e, tile_e, BLOCK_N, dstl, checks=checks,
                              key=key, onehot=not dstl)
        return launch_mono_fused(name, messages, c, plan, tile_e, dstl,
                                 n_blocks, torch.float32)

    def split():
        item_first, pbase, n_items, n_part = split_plan(tile_start.diff())
        rest = checks((n_items, n_part))
        if not dstl:
            group_mask(stream, tile_e, False, onehot_of=name)
        return (item_first, pbase, *rest)
    item_first, pbase, n_items, n_part = cached_per_tensor(
        tile_start, (name, "split", messages.shape[0], stream.data_ptr(),
                     tuple(stream.shape), n_blocks, tile_e, *key), split)
    ws = torch.empty(max(n_part, 1), BLOCK_N, D, dtype=torch.float32,
                     device=dev)
    out = torch.empty(n_blocks * BLOCK_N, D, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(entry, name, dev, _DTYPE_CODE[messages.dtype], p(messages),
                  messages.shape[0], D, p(stream), n_c, p(tile_start),
                  n_blocks, tile_e, p(item_first), p(pbase), n_items, n_part,
                  p(ws), p(out))
    return out


def onehot_segment_scatter_flat_reference(messages, onehot_i8, tile_start,
                                          block_of_tile, n_blocks: int,
                                          tile_e: int):
    """Plain version of :func:`onehot_segment_scatter_flat`: every nonzero
    (tile i, row r, column j) of the one-hot stream adds count · message
    row i·tile_e + j to row r of block block_of_tile[i], by ``index_add_``
    in f64, rounded once to f32.  (A hub row sums millions of terms: float
    atomics into one f32 row drift by ~2.6e-3 of its value on the card,
    where the kernel's ordered f32 sums stay within 2.1e-6 of the exact
    sum; see PERF.md, PR 4.)"""
    del tile_start
    D, dev = messages.shape[-1], messages.device
    out = torch.zeros(n_blocks * BLOCK_N, D, dtype=torch.float64, device=dev)
    C = onehot_i8.reshape(-1, BLOCK_N, tile_e)
    i, r, j = torch.nonzero(C, as_tuple=True)
    out.index_add_(0, block_of_tile.long()[i] * BLOCK_N + r,
                   messages.index_select(0, i * tile_e + j).double()
                   * C[i, r, j].double()[:, None])
    return out.float()


def onehot_segment_scatter_flat(messages, onehot_i8, tile_start,
                                block_of_tile, n_blocks: int,
                                tile_e: int = 2048):
    """out[b·128:(b+1)·128] = Σ_{tiles i of b} onehot_iᵀ · messages_i →
    [n_blocks·128, D] f32: tile i's messages are rows [i·tile_e,
    (i+1)·tile_e), its one-hot the int8 rows [i·128, (i+1)·128) of the
    stream (stored transposed, [n_tiles·128, tile_e]: each column at most
    one entry, a 1, as the builders make it); ``block_of_tile`` and
    ``tile_start`` (int32) must agree.  ``messages`` in the compute dtype,
    any D >= 1.  A CPU tensor takes the plain version; a CUDA tensor
    launches, in bf16 at D = 128, ``csrc/window_mono_fused.cu`` (the
    product of each tile's one-hot and messages on the tensor cores, as the
    TPU kernel computes it, over the 16-row groups the one-hot names),
    else ``ggnn_onehot_flat`` of ``csrc/window_mono.cu`` (f32 at D = 128
    decodes each tile's one-hot into dst ids and sums them in order, as
    :func:`onehot_segment_scatter` does); or raises, also when a column of
    the stream is not one-hot (checked once per layout)."""
    name = "onehot_segment_scatter_flat"
    n_tiles = block_of_tile.shape[0]
    _check_scatter_args(name, messages, onehot_i8, tile_start, n_blocks,
                        tile_e, n_tiles, (n_tiles * BLOCK_N, tile_e),
                        torch.int8)
    if block_of_tile.dtype != torch.int32:
        raise ValueError(f"{name}: block_of_tile must be int32, got "
                         f"{block_of_tile.dtype}")
    if messages.device.type == "cpu":
        _scatter_data_checks(name, tile_start, n_tiles,
                             block_of_tile=block_of_tile)
        return onehot_segment_scatter_flat_reference(
            messages, onehot_i8, tile_start, block_of_tile, n_blocks, tile_e)
    if messages.shape[-1] == BLOCK_N and tile_e % 16:
        raise ValueError(f"{name}: the CUDA kernel at D = {BLOCK_N} reads "
                         f"the one-hot in 16-byte rows: tile_e % 16 == 0, "
                         f"got tile_e={tile_e}")
    checks = lambda extra=(): _scatter_data_checks(
        name, tile_start, n_tiles, block_of_tile=block_of_tile, extra=extra)
    out = _launch_scatter(_build.library().ggnn_onehot_flat, name, messages,
                          onehot_i8, n_tiles, tile_start, n_blocks, tile_e,
                          checks, False, key=(block_of_tile.data_ptr(),))
    onehot_segment_scatter_flat.launches += 1
    return out


onehot_segment_scatter_flat.launches = 0


def onehot_segment_scatter_reference(messages, dst_local, tile_start,
                                     n_blocks: int, max_tiles: int,
                                     tile_e: int = 128):
    """Plain version of :func:`onehot_segment_scatter`: every edge e of a
    tile that belongs to a block, with dst_local[e] in [0, 128), adds
    messages[e] to that row of its block, by ``index_add_`` in f64, rounded
    once to f32 (as :func:`onehot_segment_scatter_flat_reference`)."""
    del max_tiles
    D, dev = messages.shape[-1], messages.device
    out = torch.zeros(n_blocks * BLOCK_N, D, dtype=torch.float64, device=dev)
    e = torch.arange(dst_local.shape[0], device=dev)
    blk = torch.searchsorted(tile_start[1:].contiguous(),
                             (e // tile_e).to(tile_start.dtype), right=True)
    d = dst_local.long()
    sel = torch.nonzero((d >= 0) & (d < BLOCK_N) & (blk < n_blocks)).flatten()
    out.index_add_(0, blk[sel] * BLOCK_N + d[sel],
                   messages.index_select(0, sel).double())
    return out.float()


def onehot_segment_scatter(messages, dst_local, tile_start, n_blocks: int,
                           max_tiles: int, tile_e: int = 128):
    """The same scatter from dst-local ids: edge e of tile e // tile_e of
    block b (``tile_start``) adds messages[e] to row b·128 + dst_local[e];
    −1 adds nothing → [n_blocks·128, D] f32.  ``messages`` [E_pack, D] in
    the compute dtype (any D >= 1), ``dst_local`` int32 [E_pack].  (The
    reference's grid runs max_tiles steps per block and clamps; the port
    checks that no block holds more.)  A CPU tensor takes the plain
    version; a CUDA tensor launches #11's dst-local form (bf16 at D = 128:
    ``csrc/window_mono_fused.cu``; else ``ggnn_onehot_dstl`` of
    ``csrc/window_mono.cu``) or raises."""
    name = "onehot_segment_scatter"
    E = dst_local.shape[0]
    if E % tile_e:
        raise ValueError(f"{name}: dst_local has {E} entries, not whole "
                         f"tiles of {tile_e}: layout and arguments disagree")
    n_tiles = E // tile_e
    _check_scatter_args(name, messages, dst_local, tile_start, n_blocks,
                        tile_e, n_tiles, (E,), torch.int32)
    checks = lambda extra=(): _scatter_data_checks(
        name, tile_start, n_tiles, max_tiles=max_tiles, extra=extra)
    if messages.device.type == "cpu":
        checks()
        return onehot_segment_scatter_reference(
            messages, dst_local, tile_start, n_blocks, max_tiles, tile_e)
    out = _launch_scatter(_build.library().ggnn_onehot_dstl, name, messages,
                          dst_local, n_tiles, tile_start, n_blocks, tile_e,
                          checks, True, key=(max_tiles,))
    onehot_segment_scatter.launches += 1
    return out


onehot_segment_scatter.launches = 0


def _stream_tiles(name, messages, onehot_i8, tile_start, n_blocks, tile_e):
    """The argument checks of #18 and #19; returns n_tiles."""
    E = messages.shape[0] if messages.dim() == 2 else -1
    if E % tile_e:
        raise ValueError(f"{name}: messages has {E} rows, not whole tiles "
                         f"of {tile_e}: layout and arguments disagree")
    n_tiles = E // tile_e
    _check_scatter_args(name, messages, onehot_i8, tile_start, n_blocks,
                        tile_e, n_tiles, (n_tiles * BLOCK_N, tile_e),
                        torch.int8)
    return n_tiles


def loopT_plan_once(name, onehot_t, tile_start, n_blocks: int,
                    tile_e: int):
    """The gather plan of #19 ``onehot_segment_scatter_loopT`` (and of #18's
    forms off #11's pipeline: one plan a layout serves both) over one
    layout's stream, made once per layout (``cached_per_tensor`` on
    tile_start; a raise, in ``name``, is not cached): the data checks
    (tile_start runs from 0, never down, to at most the stream's tiles),
    then :func:`~ggnn_tpu_torch.ops.window.
    window_auto_plan` with window = tile_e, tile t reading its own message
    rows (``win_of_tile`` t) into block ``searchsorted(tile_start[1:], t,
    right=True)``, and the tiles past tile_start[-1] marked −1, so that
    they add nothing.  A launch on a layout already seen copies nothing to
    the host.

    It serves ``_scatter_loopT_kernel`` (``ggnn_tpu/ops/scatter_pallas.py:
    672``), which multiplies every one-hot tile with its messages on the
    TPU's matrix unit.  On the card the function is bound by HBM bytes:
    read densely, the one-hot stream is a third of them (1.075 of 3.26 GB
    at the uniform headline, tile_e 2048), yet under 1 % of its bytes are
    not zero, and a dense product of each 128-edge chunk spends its time
    on shared-memory loads of zeros.  The plan lists each nonzero byte
    once as an entry {message row, value} in output-row order, so that a
    launch reads the real message rows once, 4 bytes an entry and the
    output (2.22 GB in bf16 there, 0.66 ms at 3.35 TB/s), and the one-hot
    not at all; ``csrc/window_auto_gather.cu`` sums each row's entries in
    f32 in that order (no atomics: the same bits on every run)."""
    n_tiles = onehot_t.shape[0] // BLOCK_N

    def make():
        _scatter_data_checks(name, tile_start, n_tiles)
        t = torch.arange(n_tiles, dtype=torch.int32, device=tile_start.device)
        used = t < tile_start[-1]
        win = torch.where(used, t, -1)
        blk = torch.searchsorted(tile_start[1:].contiguous(), t, right=True,
                                 out_int32=True)
        return window_auto_plan(onehot_t, torch.where(used, blk, 0), win,
                                None, n_blocks, tile_e, n_tiles * tile_e)
    return cached_per_tensor(
        tile_start, ("loopT plan", tuple(onehot_t.shape),
                     onehot_t.data_ptr(), n_blocks, tile_e), make)


def _launch_gather(name, messages, onehot_i8, tile_start, n_blocks, tile_e):
    """One launch of ``csrc/window_auto_gather.cu`` on the layout's
    :func:`loopT_plan_once` → [n_blocks·128, D] f32."""
    if messages.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {messages.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    _check_cuda_args(name, [("messages", messages), ("onehot", onehot_i8),
                            ("tile_start", tile_start)], messages.shape[-1],
                     any_width=True)
    return launch_window_auto(name, messages, loopT_plan_once(
        name, onehot_i8, tile_start, n_blocks, tile_e))


def onehot_segment_scatter_loopT_reference(messages, onehot_t, tile_start,
                                           n_blocks: int, tile_e: int = 2048):
    """Plain version of :func:`onehot_segment_scatter_loopT` and
    :func:`onehot_segment_scatter_stream`: :func:`onehot_segment_scatter_
    flat_reference` (f64 sums, rounded once to f32) over tiles [0,
    tile_start[-1]), each with the block ``tile_start`` gives it, whatever
    int8 values the stream holds."""
    n_used = host_ints(tile_start[-1])[0]
    tiles = torch.arange(n_used, dtype=torch.int32, device=tile_start.device)
    block_of_tile = torch.searchsorted(tile_start[1:].contiguous(), tiles,
                                       right=True)
    return onehot_segment_scatter_flat_reference(
        messages, onehot_t[:n_used * BLOCK_N], tile_start, block_of_tile,
        n_blocks, tile_e)


def onehot_segment_scatter_stream_reference(messages, onehot_i8, tile_start,
                                            n_blocks: int, max_tiles: int,
                                            tile_e: int = 512):
    """Plain version of :func:`onehot_segment_scatter_stream` (that of
    :func:`onehot_segment_scatter_loopT`)."""
    del max_tiles
    return onehot_segment_scatter_loopT_reference(messages, onehot_i8,
                                                  tile_start, n_blocks, tile_e)


def stream_plan_once(n_msgs: int, onehot_i8, tile_start, n_blocks: int,
                     max_tiles: int, tile_e: int, pipe: bool):
    """#18's data checks (tile_start runs from 0 upward within the stream,
    no block holds more than ``max_tiles`` tiles) and, with ``pipe``, the
    plan of #11's count form over its stream (:func:`~ggnn_tpu_torch.ops.
    window.mono_plan`: window = stride = tile_e, tile t reading window t,
    the blocks from ``tile_start``), made once per layout
    (``cached_per_tensor`` on tile_start; a raise is not cached) → the plan,
    or None without ``pipe``."""
    name = "onehot_segment_scatter_stream"
    n_tiles = onehot_i8.shape[0] // BLOCK_N
    checks = lambda extra=(): _scatter_data_checks(
        name, tile_start, n_tiles, max_tiles=max_tiles, extra=extra)
    if not pipe:
        cached_per_tensor(tile_start, (name, "checks", n_tiles, max_tiles),
                          checks)
        return None
    return mono_plan_once(name, n_msgs, onehot_i8, tile_start,
                          tile_arange(tile_start, n_tiles), None, n_blocks,
                          tile_e, tile_e, BLOCK_N, False, checks=checks,
                          key=(max_tiles,))


def onehot_segment_scatter_stream(messages, onehot_i8, tile_start,
                                  n_blocks: int, max_tiles: int,
                                  tile_e: int = 512):
    """Kernel #18, the reference's two-stream scatter: out[b·128 + r] =
    Σ_{tiles i of b} Σ_j C[i·128 + r, j] · messages[i·tile_e + j] →
    [n_blocks·128, D] f32, with C the int8 stream (cast to the messages'
    dtype, whatever values it holds: no one-hot check, as the TPU kernel)
    and every block written (zeros for a block without tiles).

    ``messages`` [E_pack, D] in the compute dtype (any D), E_pack = n_tiles·
    tile_e; ``onehot_i8`` [n_tiles·128, tile_e] int8, each tile's one-hot
    stored transposed: the array :func:`onehot_segment_scatter_flat` reads
    and the TPU kernel's BlockSpec ``(BLOCK_N, tile_e)`` cuts (its
    docstring's "[E_pack, BLOCK_N]" is wrong); ``tile_start`` int32
    [n_blocks + 1].  The TPU grid runs ``max_tiles`` steps per block and
    drops a block's tiles past it; the port raises when a block holds more.
    A CPU tensor takes the plain version; a CUDA tensor launches, bf16 at
    D = 128 with tile_e % 16 = 0, #11's count form on its pipeline
    (``csrc/window_mono_fused.cu`` on the plan of :func:`stream_plan_once`),
    else #19's gather-sum (``csrc/window_auto_gather.cu`` on the plan of
    :func:`loopT_plan_once`: the same function and arguments); or raises.
    The data checks and the plans run once per layout: a launch on a
    layout already seen copies nothing to the host."""
    name = "onehot_segment_scatter_stream"
    n_tiles = _stream_tiles(name, messages, onehot_i8, tile_start, n_blocks,
                            tile_e)
    if messages.device.type == "cpu":
        _scatter_data_checks(name, tile_start, n_tiles, max_tiles=max_tiles)
        return onehot_segment_scatter_stream_reference(
            messages, onehot_i8, tile_start, n_blocks, max_tiles, tile_e)
    pipe = (messages.dtype == torch.bfloat16
            and messages.shape[1] == BLOCK_N and tile_e % 16 == 0)
    args = (messages.shape[0], onehot_i8, tile_start, n_blocks, max_tiles,
            tile_e)
    if pipe:
        _check_cuda_args(name, [("messages", messages), ("onehot", onehot_i8),
                                ("tile_start", tile_start)], BLOCK_N)
        out = launch_mono_fused(name, messages, onehot_i8,
                                stream_plan_once(*args, True), tile_e, False,
                                n_blocks, torch.float32)
    else:
        stream_plan_once(*args, False)
        out = _launch_gather(name, messages, onehot_i8, tile_start, n_blocks,
                             tile_e)
    onehot_segment_scatter_stream.launches += 1
    return out


onehot_segment_scatter_stream.launches = 0


def onehot_segment_scatter_loopT(messages, onehot_t, tile_start,
                                 n_blocks: int, tile_e: int = 2048):
    """Kernel #19, the reference's looped-DMA form of
    :func:`onehot_segment_scatter_stream`: the same function and arguments
    without ``max_tiles`` (one program per block walks all its tiles), and
    the tiles past tile_start[-1] unused.  A CPU tensor takes the plain
    version; a CUDA tensor, in every dtype (bf16, f32) and width D,
    launches ``csrc/window_auto_gather.cu`` (#20's gather-sum) on the plan
    of :func:`loopT_plan_once` (the stream's nonzero bytes as entries
    {message row, value} in output-row order, made with the data checks
    once per layout: a launch on a layout already seen copies nothing to
    the host), or raises."""
    name = "onehot_segment_scatter_loopT"
    n_tiles = _stream_tiles(name, messages, onehot_t, tile_start, n_blocks,
                            tile_e)
    if messages.device.type == "cpu":
        _scatter_data_checks(name, tile_start, n_tiles)
        return onehot_segment_scatter_loopT_reference(
            messages, onehot_t, tile_start, n_blocks, tile_e)
    out = _launch_gather(name, messages, onehot_t, tile_start, n_blocks,
                         tile_e)
    onehot_segment_scatter_loopT.launches += 1
    return out


onehot_segment_scatter_loopT.launches = 0


def onehot_segment_scatter_mono(messages, onehot_t, tile_start,
                                block_of_tile, n_blocks: int,
                                tile_e: int = 2048, out_dtype=None):
    """The reference's mono variant of :func:`onehot_segment_scatter_flat`:
    :func:`~ggnn_tpu_torch.ops.window.window_block_spmm_mono` with each
    tile reading its own ``tile_e`` message rows (``win_of_tile`` =
    arange), flushed in ``out_dtype``."""
    n_tiles = onehot_t.shape[0] // BLOCK_N
    return window_block_spmm_mono(
        messages, onehot_t, tile_start, block_of_tile,
        tile_arange(tile_start, n_tiles),
        n_blocks=n_blocks, window=tile_e, out_dtype=out_dtype)


def _scatter(msgs, layout):
    """The forward scatter a legacy layout carries: the aligned pack
    through window_block_spmm_mono at win_stride = edge_align, the one-hot
    stream through onehot_segment_scatter_flat, else the dst-local ids."""
    _, tile_e, max_tiles, n_blocks, has_onehot, _, edge_align, _ = \
        layout.meta
    arrs = layout.arrays
    if edge_align is not None:
        use_dstl = "dstl" in arrs
        return window_block_spmm_mono(
            msgs, arrs["dstl"] if use_dstl else arrs["onehot"],
            arrs["tile_start"], arrs["block_of_tile"], arrs["tile_msg_off"],
            n_blocks=n_blocks, window=tile_e, win_stride=edge_align,
            out_rows=BLOCK_N, dstl=use_dstl)
    if has_onehot:
        return onehot_segment_scatter_flat(
            msgs, arrs["onehot"], arrs["tile_start"], arrs["block_of_tile"],
            n_blocks=n_blocks, tile_e=tile_e)
    return onehot_segment_scatter(msgs, arrs["dst_local"], arrs["tile_start"],
                                  n_blocks=n_blocks, max_tiles=max_tiles,
                                  tile_e=tile_e)


def legacy_forward(h, layout: ScatterLayout, msg_w, msg_b):
    """The table-gather aggregation of a legacy layout (the reference's
    ``_aggregate_impl``): the node-transform table in the layout's row
    order (bias inside, rounded to h's dtype), its rows gathered by
    ``gather_idx``, then the scatter → [N, D] f32."""
    table = node_table(h, msg_w, msg_b, layout.meta[7])
    msgs = table.index_select(0, layout.arrays["gather_idx"])
    del table
    return _scatter(msgs, layout)[:h.shape[0]]


def aggregate_onehot_chunked(h, chunk_layouts: list, msg_w, msg_b):
    """The aggregation over the dst ranges of
    :func:`build_chunked_dst_layouts`, one range's messages at a time (the
    reference function): the type-order table, then per chunk the gather
    and its scatter → [N, D] f32.  Forward only, as the reference: a
    request for gradients raises (large-scale training shards instead)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h, msg_w, msg_b)):
        raise ValueError("aggregate_onehot_chunked is forward only; train "
                         "with layout_for_batch(with_grad=True)")
    table = node_table(h, msg_w, msg_b, "type")
    outs = []
    for lay in chunk_layouts:
        msgs = table.index_select(0, lay.arrays["gather_idx"])
        outs.append(_scatter(msgs, lay))
        del msgs
    return torch.cat(outs, dim=0)[:h.shape[0]]
