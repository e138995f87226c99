"""The legacy table-gather scatter layout, ported to numpy array for array.

Counterpart of ``ggnn_tpu/ops/scatter_pallas.py``'s
:class:`DstBlockLayout` and :func:`build_dst_block_layout`: real directed
edges grouped by 128-row destination block, each block's edges packed into
``tile_e``-edge tiles.  The typed pack's backward builds its grad layout
with it where the octet layout declines (``ops/scatter.py``), reduced by
:func:`ggnn_tpu_torch.ops.window.window_block_spmm_mono`.  The legacy
forward path that also reads it (``layout_for_batch``,
``aggregate_onehot_chunked``, the device form of this layout and its
scatter kernels) is ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ggnn_tpu_torch.ops.scatter import BLOCK_N, _rup, _rup_block


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
