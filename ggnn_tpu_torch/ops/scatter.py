"""Typed-pack one-hot aggregation: host layout, CUDA kernels, plain versions.

Counterpart of ``ggnn_tpu/ops/scatter_pallas.py`` for its typed pack:

- :func:`build_typed_dst_layout` is the reference function ported to numpy,
  array for array: edges sorted by (dst block, type, src), per-(block, type)
  groups packed at 16-row alignment; in block mode ``S8`` slots per dst
  block, else (hub-heavy and power-law graphs) the per-tile arrays.
  ``gather_idx`` indexes rows of h.  ``with_grad=True`` adds the grad layout
  of the backward (``g_*`` arrays, ``meta[5]``): the octet layout, or where
  it declines the legacy one of :func:`ggnn_tpu_torch.ops.legacy.
  build_dst_block_layout`.
- :func:`typed_block_scatter` and :func:`typed_block_step_gru` wrap the
  CUDA kernels of ``_typed_block_kernel``'s port, and
  :func:`typed_onehot_scatter` and :func:`typed_step_gru` those of
  ``_typed_onehot_kernel`` and ``_typed_step_kernel``.  The dispatch is by
  dtype and ``tile_e``: bf16 with ``tile_e % 16 == 0`` (every block-mode
  layout) runs the slot pipeline of ``csrc/typed_pipe.cuh``
  (``csrc/typed_block_fused.cu``, ``csrc/typed_tile_fused.cu``: each
  slot's real-row prefix, the one-hot product on the tensor cores); f32,
  and per-tile layouts of another tile_e, the first bodies
  (``csrc/typed_block.cu``, ``csrc/typed_tile.cu``: segment sums);
  :func:`typed_grad_octet_scatter` wraps
  ``csrc/grad_octet.cu`` (the port of ``_grad_octet_kernel``), and the
  legacy grad layout goes through
  :func:`ggnn_tpu_torch.ops.window.window_block_spmm_mono`.  Each has a
  ``_reference`` plain version with the same rounding points.
- :func:`aggregate_onehot` is the full aggregation with the reference's
  custom backward (:class:`AggregateOnehot`, :func:`aggregate_bwd`,
  :func:`reverse_scatter`): for the typed pack the ``h_pack`` gather, the
  kernel and the bias Σ_t indeg_t·b_t; for a legacy layout
  (:class:`ScatterLayout` with ``meta[7]`` its table row order) the
  table-gather forward of ``ops/legacy.py``.

The reference splits per-tile layouts into chunks (``meta[8]``) and reads
block spans (span mode, ``meta[9]``) to fit the TPU's SMEM and VMEM; the
chunks give the same sums as one call, so the port builds both arrays as the
reference does and launches once over all blocks.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The kernels are written for D = 128: a
narrower state runs them zero-padded (:func:`~ggnn_tpu_torch.ops.gru.
pad_width`, exact), D = 128·P in 128-column panels (:func:`_panel_scatter`;
the fused steps then add the GRU cell kernel at that width), and any other
D padded to the next multiple of 128.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import (KERNEL_WIDTH, _DTYPE_CODE,
                                    _check_cuda_args, gru_cell_fwd,
                                    host_ints, kernel_width, narrow_width,
                                    pad_width, gru_cell_fwd_reference)
from ggnn_tpu_torch.ops import segment_rows as SR
from ggnn_tpu_torch.ops.window import (cached_per_tensor, split_plan,
                                       takes_grad, window_block_spmm_mono)

BLOCK_N = 128                  # destination rows per output block
SMEM_TILE_CAP = 40960          # the reference's per-call tile cap (chunking)
SPAN_ROW_CAP = 16384           # largest block span block mode accepts
BLOCK_SLOT_CAP = 160 * 1024    # largest slot array block mode accepts

def _rup_block(x: int) -> int:
    return ((x + BLOCK_N - 1) // BLOCK_N) * BLOCK_N


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ScatterLayout:
    """A scatter layout: ``meta`` is the reference's static tuple, item for
    item (the typed pack's 11-tuple, ``meta[7] == 'typed'``, or the legacy
    layout's 8-tuple, ``meta[7]`` its table row order); ``arrays`` holds
    numpy arrays (host) or tensors (device)."""

    meta: tuple
    arrays: dict

    @property
    def n_blocks(self) -> int:
        return self.meta[3]

    @property
    def typed(self) -> bool:
        return self.meta[7] == "typed"

    @property
    def block_meta(self):
        """(S8, cmax, span_rows) when the typed pack's block mode engaged,
        else None."""
        return self.meta[10] if self.typed else None

    def to(self, device) -> "ScatterLayout":
        """A copy whose arrays are tensors on ``device``."""
        return ScatterLayout(self.meta, {
            k: torch.as_tensor(v, device=device)
            for k, v in self.arrays.items()})


def _chunk_blocks(tile_start, cap: int = SMEM_TILE_CAP):
    """Split blocks at block boundaries so each chunk holds at most ``cap``
    tiles (the reference's ``_chunk_blocks``)."""
    ts = np.asarray(tile_start, np.int64)
    n_blocks = ts.shape[0] - 1
    if int(ts[-1]) <= cap:
        return None
    over = np.flatnonzero(np.diff(ts) > cap)
    if over.size and cap >= SMEM_TILE_CAP:
        b = int(over[0])
        raise ValueError(
            f"dst block {b} alone holds {int(ts[b + 1] - ts[b])} tiles, "
            f"over the chunk cap of {cap}; rebuild the layout with a larger "
            f"tile_e")
    bounds = []
    b0 = 0
    while b0 < n_blocks:
        b1 = int(np.searchsorted(ts, ts[b0] + cap, side="right")) - 1
        b1 = min(max(b1, b0 + 1), n_blocks)
        bounds.append((b0, b1, int(ts[b0]), int(ts[b1])))
        b0 = b1
    return tuple(bounds)


def _grad_layout(arrays, src, dst, typ, T2, n_nodes_pad, grad_tile_e,
                 block_mode, smem_tile_cap=SMEM_TILE_CAP):
    """The reference's grad layout (``scatter_pallas.py:1304-1404``): edges
    regrouped by block-major table row grow(u, t) = (u // 128)·T2·128
    + t·128 + u % 128 into 128-row grad blocks.  The octet layout puts 8
    contiguous blocks to an octet; where it declines (``block_mode=False``
    or hub-heavy grad blocks) the legacy layout of
    :func:`~ggnn_tpu_torch.ops.legacy.build_dst_block_layout` takes its
    place.  Adds the ``g_*`` arrays to ``arrays`` and returns
    ``grad_meta``."""
    grow = (src // 128) * (T2 * 128) + typ * 128 + src % 128
    n_rows_grad = _rup_block(T2 * n_nodes_pad)
    if grad_tile_e is None:
        avg = max(1, src.shape[0] * BLOCK_N // max(n_rows_grad, 1))
        grad_tile_e = 128
        while grad_tile_e < min(avg, 2048):
            grad_tile_e *= 2
    octet_ok = block_mode is not False
    if octet_ok:
        gb = (grow // BLOCK_N).astype(np.int64)
        B_g = n_rows_grad // BLOCK_N
        gcnt_g = np.bincount(gb, minlength=B_g)
        gchunks = -(-gcnt_g // grad_tile_e)
        C_g = max(int(gchunks.max(initial=0)), 1)
        n_oct = -(-B_g // 8)
        R8 = _rup(8 * C_g, 8)
        gb_base = np.zeros(B_g + 1, np.int64)
        np.cumsum(-(-gcnt_g // 16) * 16, out=gb_base[1:])
        oct_start = gb_base[np.minimum(np.arange(n_oct) * 8, B_g)]
        oct_end = gb_base[np.minimum(np.arange(1, n_oct + 1) * 8, B_g)]
        span8 = _rup(int((oct_end - oct_start).max(initial=0))
                     + grad_tile_e, 16)
        n_real_g = int(gchunks.sum())
        octet_ok = (C_g <= 8 and n_oct * 8 * C_g <= BLOCK_SLOT_CAP
                    and span8 <= SPAN_ROW_CAP
                    and n_oct * 8 * C_g <= 3 * max(n_real_g, 1) + 8 * B_g)
    if not octet_ok:
        from ggnn_tpu_torch.ops.legacy import build_dst_block_layout
        g = build_dst_block_layout(
            edge_src=dst, edge_dst=grow, edge_type=np.zeros_like(typ),
            edge_mask=np.ones(dst.shape[0], np.float32),
            n_nodes_pad=n_rows_grad, tile_e=grad_tile_e, onehot_stream=True,
            n_src_rows=n_nodes_pad,
            edge_align=(16 if grad_tile_e % 16 == 0 else None),
            dstl_stream=grad_tile_e % 16 == 0)
        arrays["g_gather_idx"] = g.gather_idx
        arrays["g_tile_start"] = g.tile_start
        arrays["g_block_of_tile"] = g.block_of_tile
        if g.dstl is not None:
            arrays["g_dstl"] = g.dstl
        else:
            arrays["g_onehot"] = g.onehot
        if g.tile_msg_off is not None:
            arrays["g_tile_msg_off"] = g.tile_msg_off
        arrays["g_indeg"] = arrays["indeg"]
        return (g.n_blocks, g.max_tiles, g.tile_e, g.onehot is not None,
                g.edge_align, _chunk_blocks(g.tile_start, smem_tile_cap))
    order_g = np.lexsort((dst, gb))
    g_dst = dst[order_g]
    ggb = gb[order_g]
    g_local = (grow % BLOCK_N)[order_g]
    first_g = np.zeros(B_g + 1, np.int64)
    first_g[1:] = np.cumsum(gcnt_g)
    rank_g = np.arange(g_dst.shape[0]) - first_g[ggb]
    pos_g = gb_base[ggb] + rank_g
    e_pack_g = max(int(gb_base[-1]) + grad_tile_e,
                   int(oct_start.max(initial=0)) + span8)
    g_gather = np.zeros(e_pack_g, np.int32)
    g_gather[pos_g] = g_dst.astype(np.int32)
    # slot (grad block, chunk) → pack offset / 16 relative to the octet's
    # span start; −1 = no chunk
    slot_off = np.full(n_oct * 8 * C_g, -1, np.int32)
    nz = np.nonzero(gchunks)[0]
    reps_g = gchunks[nz]
    t_gb = np.repeat(nz, reps_g)
    t_c = (np.arange(int(reps_g.sum()))
           - np.repeat(np.cumsum(reps_g) - reps_g, reps_g))
    slot_off[t_gb * C_g + t_c] = ((gb_base[t_gb] + t_c * grad_tile_e
                                   - oct_start[t_gb // 8]) // 16)
    g_dstl = np.full((n_oct * R8, grad_tile_e), -1, np.int32)
    g_dstl[(ggb // 8) * R8 + (ggb % 8) * C_g + rank_g // grad_tile_e,
           rank_g % grad_tile_e] = g_local
    arrays["g_gather_idx"] = g_gather
    arrays["g_slot_off16"] = slot_off
    arrays["g_dstl_oct"] = g_dstl
    arrays["g_oblk16"] = (oct_start // 16).astype(np.int32)
    arrays["g_indeg"] = arrays["indeg"]
    return ("octet", B_g, grad_tile_e, C_g, R8, span8, n_oct)


def build_typed_dst_layout(edge_src, edge_dst, edge_type, edge_mask,
                           n_nodes_pad: int, n_message_types: int,
                           tile_e: int | None = None, edge_align: int = 16,
                           with_grad: bool = False,
                           grad_tile_e: int | None = None,
                           smem_tile_cap: int = SMEM_TILE_CAP,
                           span_mode="auto", block_mode="auto"
                           ) -> ScatterLayout:
    """Host layout of the typed pack (the reference function, array for
    array).  Block mode ('auto') engages when the T2·cmax slot grid stays
    bounded; hub-heavy graphs keep the per-tile arrays
    (:func:`typed_onehot_scatter`, :func:`typed_step_gru`).  ``with_grad``
    adds the grad layout of the backward's reverse scatter: the octet
    layout (:func:`typed_grad_octet_scatter`) where it engages, else the
    legacy one (:func:`~ggnn_tpu_torch.ops.window.window_block_spmm_mono`).
    """
    T2 = n_message_types
    if n_nodes_pad % BLOCK_N:
        raise ValueError(f"n_nodes_pad must be a multiple of {BLOCK_N}")
    if tile_e is None:
        # size tiles to the average (block, type) group occupancy
        n_real_e = max(int((np.asarray(edge_mask) > 0).sum()), 1)
        avg = max(1, n_real_e * BLOCK_N // n_nodes_pad // T2)
        tile_e = 128
        while tile_e < min(avg, 2048):
            tile_e *= 2
    if tile_e % edge_align:
        raise ValueError("edge_align must divide tile_e")
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)
    order = np.lexsort((src, typ, dst // BLOCK_N))
    src, dst, typ = src[order], dst[order], typ[order]
    n_blocks = n_nodes_pad // BLOCK_N
    block = dst // BLOCK_N
    gid = block * T2 + typ
    n_groups = n_blocks * T2
    gcnt = np.bincount(gid, minlength=n_groups)
    A = edge_align
    gbase = np.zeros(n_groups + 1, np.int64)
    np.cumsum(-(-gcnt // A) * A, out=gbase[1:])
    e_pack = int(gbase[-1]) + tile_e      # margin: last tile may overrun
    blk_start = gbase[np.arange(n_blocks) * T2]
    blk_end = gbase[np.arange(1, n_blocks + 1) * T2]
    span_rows = int((blk_end - blk_start).max(initial=0)) + tile_e
    span_rows = -(-span_rows // 16) * 16
    gtiles = -(-gcnt // tile_e)
    n_real = int(gtiles.sum())
    cmax = max(int(gtiles.max(initial=0)), 1)
    S8 = _rup(T2 * cmax, 8)
    n_slots = n_blocks * S8
    block_ok = ((block_mode is not False) and A == 16
                and span_rows <= SPAN_ROW_CAP)
    if block_ok and block_mode == "auto":
        block_ok = (cmax <= 8 and n_slots <= BLOCK_SLOT_CAP
                    and n_slots <= 3 * max(n_real, 1) + 8 * n_blocks)
    if block_mode is True and not block_ok:
        warnings.warn(
            "block_mode=True cannot be honored (needs edge_align=16 and "
            f"max block span {span_rows} <= {SPAN_ROW_CAP}); falling back "
            "to the per-tile layout", stacklevel=2)
    if span_mode is True and block_ok:
        warnings.warn(
            "span_mode=True is superseded by block mode (engaged); pass "
            "block_mode=False for the per-tile span layout", stacklevel=2)
    span_auto = span_mode == "auto"
    span_mode = ((True if span_auto else bool(span_mode))
                 and (A == 16) and span_rows <= SPAN_ROW_CAP
                 and not block_ok)
    if span_mode or block_ok:
        e_pack = max(e_pack, int(blk_start.max(initial=0)) + span_rows)
    grp_idx = np.nonzero(gtiles)[0]
    reps = gtiles[grp_idx]
    t_gid = np.repeat(grp_idx, reps)
    t_k = np.arange(n_real) - np.repeat(np.cumsum(reps) - reps, reps)
    first_of_g = np.zeros(n_groups, np.int64)
    first_of_g[1:] = np.cumsum(gcnt)[:-1]
    rank = np.arange(src.shape[0]) - first_of_g[gid]
    pos = gbase[gid] + rank
    gather_idx = np.zeros(e_pack, np.int32)
    gather_idx[pos] = src.astype(np.int32)
    arrays = {"gather_idx": gather_idx,
              "indeg": np.bincount(typ * np.int64(n_nodes_pad) + dst,
                                   minlength=T2 * n_nodes_pad)
              .reshape(T2, n_nodes_pad).astype(np.float32)}
    chunks = None
    if block_ok:
        # slot (b, t, c) at b·S8 + t·cmax + c: pack offset / 16 relative to
        # the block's span start (−1 = empty), and its dst-local row
        slot_off16 = np.full(n_slots, -1, np.int32)
        slot_idx = ((t_gid // T2) * S8 + (t_gid % T2) * cmax + t_k)
        slot_off16[slot_idx] = ((gbase[t_gid] + t_k * tile_e
                                 - blk_start[t_gid // T2]) // 16)
        dstl_blk = np.full((n_slots, tile_e), -1, np.int32)
        e_slot = block * np.int64(S8) + typ * cmax + rank // tile_e
        dstl_blk[e_slot, rank % tile_e] = dst - block * BLOCK_N
        arrays["slot_off16"] = slot_off16
        arrays["dstl_blk"] = dstl_blk
    else:
        # per-tile enumeration (+1 dummy tile per empty block)
        btiles = gtiles.reshape(n_blocks, T2).sum(1)
        need_dummy = btiles == 0
        t_block = (t_gid // T2).astype(np.int32)
        t_type = (t_gid % T2).astype(np.int32)
        t_off = ((gbase[t_gid] + t_k * tile_e) // A).astype(np.int32)
        db = np.nonzero(need_dummy)[0].astype(np.int32)
        all_block = np.concatenate([t_block, db])
        all_type = np.concatenate([t_type, np.zeros(db.size, np.int32)])
        all_off = np.concatenate([t_off, np.full(db.size, -1, np.int32)])
        o2 = np.argsort(all_block, kind="stable")
        block_of_tile = all_block[o2]
        tile_type = all_type[o2]
        tile_msg_off = all_off[o2]            # -1 marks a dummy tile
        c_off = np.where(o2 < n_real, o2, 0).astype(np.int32)
        tile_start = np.zeros(n_blocks + 1, np.int32)
        np.cumsum(np.bincount(block_of_tile, minlength=n_blocks),
                  out=tile_start[1:])
        gt_first = np.zeros(n_groups, np.int64)
        gt_first[grp_idx] = np.cumsum(reps) - reps
        tile_of_edge = gt_first[gid] + rank // tile_e
        dstl = np.full((_rup(max(n_real, 1), 8), tile_e), -1, np.int32)
        dstl[tile_of_edge, rank % tile_e] = dst - block * BLOCK_N
        arrays.update({"dstl": dstl, "tile_start": tile_start,
                       "block_of_tile": block_of_tile,
                       "tile_msg_off": tile_msg_off, "c_off": c_off,
                       "tile_type": tile_type})
        chunks = _chunk_blocks(tile_start, smem_tile_cap)
    if span_mode or block_ok:
        arrays["blk_off16"] = (blk_start // 16).astype(np.int32)
    grad_meta = None
    if with_grad:
        grad_meta = _grad_layout(arrays, src, dst, typ, T2, n_nodes_pad,
                                 grad_tile_e, block_mode, smem_tile_cap)
    if span_mode and span_auto and chunks is not None:
        span_mode = False
        arrays.pop("blk_off16", None)
    meta = (n_nodes_pad, tile_e, 0, n_blocks, True, grad_meta,
            edge_align, "typed", chunks,
            span_rows if span_mode else None,
            (S8, cmax, span_rows) if block_ok else None)
    return ScatterLayout(meta=meta, arrays=arrays)


def _check_block_args(name, h_pack, dstl_blk, slot_off16, blk_off16, msg_w,
                      n_blocks, tile_e, S8, cmax, span_rows):
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    if h_pack.dim() != 2 or h_pack.shape[1] != D or msg_w.shape[1] != D:
        raise ValueError(f"{name}: h_pack {tuple(h_pack.shape)} and msg_w "
                         f"{tuple(msg_w.shape)} disagree on D")
    if tuple(dstl_blk.shape) != (n_blocks * S8, tile_e):
        raise ValueError(f"{name}: dstl_blk {tuple(dstl_blk.shape)} is not "
                         f"[n_blocks·S8, tile_e] = [{n_blocks * S8}, "
                         f"{tile_e}]: layout and arguments disagree")
    if tuple(slot_off16.shape) != (n_blocks * S8,):
        raise ValueError(f"{name}: slot_off16 {tuple(slot_off16.shape)} is "
                         f"not [{n_blocks * S8}]")
    if tuple(blk_off16.shape) != (n_blocks,):
        raise ValueError(f"{name}: blk_off16 {tuple(blk_off16.shape)} is not "
                         f"[{n_blocks}]")
    if _rup(T2 * cmax, 8) != S8:
        raise ValueError(f"{name}: msg_w's {T2} types × cmax {cmax} do not "
                         f"fill the layout's S8 = {S8} slots per block: "
                         f"msg_w does not belong to this layout")
    if h_pack.dtype != msg_w.dtype:
        raise ValueError(f"{name}: h_pack is {h_pack.dtype} but msg_w is "
                         f"{msg_w.dtype}; both must be the compute dtype")
    if h_pack.shape[0] < span_rows:
        raise ValueError(f"{name}: h_pack has {h_pack.shape[0]} rows, fewer "
                         f"than one block span ({span_rows}): it was not "
                         f"gathered with this layout")
    for arg, t in (("dstl_blk", dstl_blk), ("slot_off16", slot_off16),
                   ("blk_off16", blk_off16)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")


def typed_block_scatter_reference(h_pack, dstl_blk, slot_off16, blk_off16,
                                  msg_w, n_blocks: int, tile_e: int, S8: int,
                                  cmax: int, span_rows: int = 0):
    """Plain version of :func:`typed_block_scatter`: per type t, the slot
    one-hot products in f32 by ``index_add_``, rounded to ``msg_w``'s dtype
    per slot, then times W_t in f32."""
    del span_rows
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    dev = h_pack.device
    out = torch.zeros(n_blocks * BLOCK_N, D, dtype=torch.float32, device=dev)
    if n_blocks == 0:
        return out
    dl = dstl_blk.reshape(n_blocks, S8, tile_e).long()
    off = slot_off16.reshape(n_blocks, S8).long()
    base = (blk_off16.long()[:, None] + off) * 16               # [B, S8]
    cols = torch.arange(tile_e, device=dev)
    slot_id = (torch.arange(n_blocks, device=dev)[:, None, None] * cmax
               + torch.arange(cmax, device=dev)[None, :, None])   # [B, c, 1]
    for t in range(T2):
        sl = slice(t * cmax, (t + 1) * cmax)
        d = dl[:, sl]                                          # [B, c, tile_e]
        valid = (d >= 0) & (off[:, sl, None] >= 0)
        rows = (base[:, sl, None] + cols)[valid]
        tgt = ((slot_id * BLOCK_N).expand_as(d) + d)[valid]
        p = torch.zeros(n_blocks * cmax * BLOCK_N, D, dtype=torch.float32,
                        device=dev)
        p.index_add_(0, tgt, h_pack.index_select(0, rows).float())
        p = p.to(msg_w.dtype).float() @ msg_w[t].float()
        out += p.reshape(n_blocks, cmax, BLOCK_N, D).sum(1).reshape(-1, D)
    return out


def typed_block_step_gru_reference(h_pack, dstl_blk, slot_off16, blk_off16,
                                   msg_w, init, hstate, wa, b3, uzr, uh,
                                   n_blocks: int, tile_e: int, S8: int,
                                   cmax: int, span_rows: int = 0):
    """Plain version of :func:`typed_block_step_gru`: the scatter started
    from ``init``, then the GRU cell with matmul inputs in ``wa``'s dtype."""
    a = init.float() + typed_block_scatter_reference(
        h_pack, dstl_blk, slot_off16, blk_off16, msg_w, n_blocks, tile_e,
        S8, cmax, span_rows)
    return gru_cell_fwd_reference(hstate, a, wa, b3, uzr, uh, mdt=wa.dtype)[0]


def block_plan(name, h_pack, dstl_blk, slot_off16, blk_off16, n_blocks,
               tile_e, S8):
    """``csrc/typed_block_fused.cu``'s plan: :func:`dstl_lengths` of
    ``dstl_blk`` (int32 [n_blocks·S8]), after checking that every real
    slot's prefix lies inside ``h_pack`` (one copy to the host); made once
    per layout and pack height, so later calls do not sync with the
    host."""
    return cached_per_tensor(
        dstl_blk, ("typed_block_fused", h_pack.shape[0], n_blocks, tile_e,
                   S8) + tuple(t.data_ptr() for t in (slot_off16,
                                                      blk_off16)),
        lambda: _fused_block_plan(name, h_pack, dstl_blk, slot_off16,
                                  blk_off16, n_blocks, S8))


def _fused_block_plan(name, h_pack, dstl_blk, slot_off16, blk_off16,
                      n_blocks, S8):
    lens = dstl_lengths(dstl_blk)
    off = slot_off16.reshape(n_blocks, S8).long()
    ln = lens.reshape(n_blocks, S8)
    end = torch.where((off >= 0) & (ln > 0),
                      (blk_off16.long()[:, None] + off) * 16 + ln, 0)
    last = host_ints(end.max())[0] if end.numel() else 0
    if last > h_pack.shape[0]:
        raise ValueError(f"{name}: h_pack has {h_pack.shape[0]} rows, fewer "
                         f"than a slot reads ({last}): it was not gathered "
                         f"with this layout")
    return lens


def _launch_block(name, fused, h_pack, dstl_blk, slot_off16, blk_off16,
                  msg_w, n_blocks, tile_e, S8, cmax, init=None, hstate=None,
                  wa=None, b3=None, uzr=None, uh=None):
    D = msg_w.shape[-1]
    if h_pack.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {h_pack.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    named = [("h_pack", h_pack), ("dstl_blk", dstl_blk),
             ("slot_off16", slot_off16), ("blk_off16", blk_off16),
             ("msg_w", msg_w)]
    if fused:
        named += [("init", init), ("hstate", hstate), ("wa", wa),
                  ("b3", b3), ("uzr", uzr), ("uh", uh)]
    for arg, t in named[4:]:
        want = (torch.float32 if arg in ("init", "hstate", "b3")
                else h_pack.dtype)
        if t.dtype != want:
            raise ValueError(f"{name}: {arg} must be {want}, got {t.dtype}")
    _check_cuda_args(name, named, D)
    out = torch.empty(n_blocks * BLOCK_N, D, dtype=torch.float32,
                      device=h_pack.device)
    p = _build.ptr
    if h_pack.dtype == torch.bfloat16:
        # csrc/typed_block_fused.cu: each slot's real prefix only, the
        # one-hot product on the tensor cores (block mode's layouts have
        # tile_e a multiple of 16); f32 runs csrc/typed_block.cu
        if tile_e % 16:
            raise ValueError(f"{name}: tile_e {tile_e} is not a multiple of "
                             f"16, as block mode's layouts' are")
        lens = block_plan(name, h_pack, dstl_blk, slot_off16, blk_off16,
                          n_blocks, tile_e, S8)
        _build.launch(
            _build.library().ggnn_typed_block_fused, name, h_pack.device,
            int(fused), p(h_pack), h_pack.shape[0], p(dstl_blk),
            p(slot_off16), p(blk_off16), p(lens), p(msg_w), n_blocks,
            msg_w.shape[0], cmax, S8, tile_e, p(init), p(hstate), p(wa),
            p(b3), p(uzr), p(uh), p(out))
        return out
    _build.launch(
        _build.library().ggnn_typed_block, name, h_pack.device,
        _DTYPE_CODE[h_pack.dtype], int(fused), p(h_pack), h_pack.shape[0],
        p(dstl_blk), p(slot_off16), p(blk_off16), p(msg_w), n_blocks,
        msg_w.shape[0], cmax, S8, tile_e, p(init), p(hstate), p(wa), p(b3),
        p(uzr), p(uh), p(out))
    return out


def _panel_scatter(kernel, h_pack, msg_w):
    """A typed scatter Σ bf16(onehot·h_pack)·W_t at D = 128·P through the
    D = 128 kernel: output panel q = Σ_kp kernel(h_pack[:, kp], W_t[kp, q]),
    the kp partials added in f32 (the one-hot sums and their rounding are
    per column, so only the order of the f32 sum over D changes)."""
    D = msg_w.shape[-1]
    ps = [slice(q, q + KERNEL_WIDTH) for q in range(0, D, KERNEL_WIDTH)]
    hp = [h_pack[:, s].contiguous() for s in ps]
    cols = []
    for sq in ps:
        acc = None
        for kp, sk in enumerate(ps):
            part = kernel(hp[kp], msg_w[:, sk, sq].contiguous())
            acc = part if acc is None else acc + part
        cols.append(acc)
    return torch.cat(cols, dim=1)


def _pad_step(D, msg_w, init, hstate, wa, b3, uzr, uh):
    """A fused step's weights and state zero-padded to the D = 128 kernel
    (:func:`~ggnn_tpu_torch.ops.gru.pad_width`)."""
    return (pad_width(msg_w, D, rows=True), pad_width(init, D),
            pad_width(hstate, D), pad_width(wa, D, rows=True, groups=3),
            pad_width(b3.reshape(1, -1), D, groups=3),
            pad_width(uzr, D, rows=True, groups=2),
            pad_width(uh, D, rows=True))


def typed_block_scatter(h_pack, dstl_blk, slot_off16, blk_off16, msg_w,
                        n_blocks: int, tile_e: int, S8: int, cmax: int,
                        span_rows: int):
    """Per-block typed-pack scatter: out[b·128:(b+1)·128] =
    Σ_{t,c} bf16(onehot(b,t,c) @ H_chunk) · W_t  → [n_blocks·128, D] f32.

    ``h_pack`` [E_pack, D] and ``msg_w`` [T2, D, D] in the compute dtype;
    the int32 layout arrays as :func:`build_typed_dst_layout` made them.
    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/typed_block_fused.cu`` (bf16) or ``csrc/typed_block.cu`` (f32),
    or raises."""
    _check_block_args("typed_block_scatter", h_pack, dstl_blk, slot_off16,
                      blk_off16, msg_w, n_blocks, tile_e, S8, cmax, span_rows)
    if h_pack.device.type == "cpu":
        return typed_block_scatter_reference(
            h_pack, dstl_blk, slot_off16, blk_off16, msg_w, n_blocks, tile_e,
            S8, cmax, span_rows)
    D = msg_w.shape[-1]
    if D != kernel_width(D):
        # the kernel on zero-padded states (ops/gru.py::pad_width)
        return narrow_width(typed_block_scatter(
            pad_width(h_pack, D), dstl_blk, slot_off16, blk_off16,
            pad_width(msg_w, D, rows=True), n_blocks, tile_e, S8, cmax,
            span_rows), D)
    if D > KERNEL_WIDTH:
        return _panel_scatter(lambda hp, w: typed_block_scatter(
            hp, dstl_blk, slot_off16, blk_off16, w, n_blocks, tile_e, S8,
            cmax, span_rows), h_pack, msg_w)
    out = _launch_block("typed_block_scatter", False, h_pack, dstl_blk,
                        slot_off16, blk_off16, msg_w, n_blocks, tile_e, S8,
                        cmax)
    typed_block_scatter.launches += 1
    return out


def typed_block_step_gru(h_pack, dstl_blk, slot_off16, blk_off16, msg_w,
                         init, hstate, wa, b3, uzr, uh, n_blocks: int,
                         tile_e: int, S8: int, cmax: int, span_rows: int):
    """Fused per-block typed aggregation + GRU step: ``init``
    [n_blocks·128, D] f32 is the Σ_t indeg_t·b_t bias, ``hstate`` the padded
    f32 node state, ``wa``/``uzr``/``uh`` in the compute dtype and ``b3``
    [1, 3D] f32; returns h' [n_blocks·128, D] f32.  The kernels as for
    :func:`typed_block_scatter`, with the GRU step in their epilogue."""
    _check_block_args("typed_block_step_gru", h_pack, dstl_blk, slot_off16,
                      blk_off16, msg_w, n_blocks, tile_e, S8, cmax, span_rows)
    D = msg_w.shape[-1]
    rows = n_blocks * BLOCK_N
    for arg, t, shape in (("init", init, (rows, D)),
                          ("hstate", hstate, (rows, D)),
                          ("wa", wa, (D, 3 * D)), ("uzr", uzr, (D, 2 * D)),
                          ("uh", uh, (D, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"typed_block_step_gru: {arg} "
                             f"{tuple(t.shape)} is not {shape}")
    if b3.numel() != 3 * D:
        raise ValueError(f"typed_block_step_gru: b3 has {b3.numel()} "
                         f"entries, expected {3 * D}")
    if h_pack.device.type == "cpu":
        return typed_block_step_gru_reference(
            h_pack, dstl_blk, slot_off16, blk_off16, msg_w, init, hstate, wa,
            b3, uzr, uh, n_blocks, tile_e, S8, cmax, span_rows)
    if D != kernel_width(D):
        return narrow_width(typed_block_step_gru(
            pad_width(h_pack, D), dstl_blk, slot_off16, blk_off16,
            *_pad_step(D, msg_w, init, hstate, wa, b3, uzr, uh), n_blocks,
            tile_e, S8, cmax, span_rows), D)
    if D > KERNEL_WIDTH:
        # the scatter's panels plus init, then the GRU cell kernel at this
        # width: the fused step's function and rounding points
        a = init + typed_block_scatter(h_pack, dstl_blk, slot_off16,
                                       blk_off16, msg_w, n_blocks, tile_e,
                                       S8, cmax, span_rows)
        return gru_cell_fwd(hstate, a, wa, b3.reshape(-1), uzr, uh,
                            mdt=wa.dtype)[0]
    out = _launch_block("typed_block_step_gru", True, h_pack, dstl_blk,
                        slot_off16, blk_off16, msg_w, n_blocks, tile_e, S8,
                        cmax, init, hstate, wa, b3.reshape(-1), uzr, uh)
    typed_block_step_gru.launches += 1
    return out


typed_block_scatter.launches = 0
typed_block_step_gru.launches = 0


def _check_tile_args(name, h_pack, dstl, tile_start, block_of_tile,
                     tile_msg_off, c_off, tile_type, msg_w, n_blocks, tile_e):
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    if h_pack.dim() != 2 or h_pack.shape[1] != D or msg_w.shape[1] != D:
        raise ValueError(f"{name}: h_pack {tuple(h_pack.shape)} and msg_w "
                         f"{tuple(msg_w.shape)} disagree on D")
    if h_pack.dtype != msg_w.dtype:
        raise ValueError(f"{name}: h_pack is {h_pack.dtype} but msg_w is "
                         f"{msg_w.dtype}; both must be the compute dtype")
    if dstl.dim() != 2 or dstl.shape[1] != tile_e:
        raise ValueError(f"{name}: dstl {tuple(dstl.shape)} is not "
                         f"[rows, tile_e={tile_e}]: layout and arguments "
                         f"disagree")
    if tuple(tile_start.shape) != (n_blocks + 1,):
        raise ValueError(f"{name}: tile_start {tuple(tile_start.shape)} is "
                         f"not [n_blocks + 1] = [{n_blocks + 1}]: layout and "
                         f"arguments disagree")
    n_tiles = block_of_tile.shape[0]
    for arg, t in (("block_of_tile", block_of_tile),
                   ("tile_msg_off", tile_msg_off), ("c_off", c_off),
                   ("tile_type", tile_type)):
        if tuple(t.shape) != (n_tiles,):
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"[n_tiles] = [{n_tiles}]: layout and arguments "
                             f"disagree")
    for arg, t in (("dstl", dstl), ("tile_start", tile_start),
                   ("block_of_tile", block_of_tile),
                   ("tile_msg_off", tile_msg_off), ("c_off", c_off),
                   ("tile_type", tile_type)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")


def _tile_data_checks(name, h_pack, dstl, tile_start, block_of_tile,
                      tile_msg_off, c_off, tile_type, T2, n_blocks, tile_e,
                      align, extra=()):
    """The layout arrays against one another and against the pack: the
    tile counts agree, real tiles address dstl rows, types and blocks that
    exist, and every tile's rows lie inside ``h_pack`` (one copy to the
    host, with ``extra`` 0-d tensors appended)."""
    n_tiles = block_of_tile.shape[0]
    stats = [tile_start[0], tile_start[-1]]
    if n_tiles:
        real = tile_msg_off >= 0
        zero = torch.zeros_like(tile_msg_off)
        for t in (tile_msg_off, c_off, tile_type, block_of_tile):
            v = torch.where(real, t, zero)
            stats += [v.min(), v.max()]
    else:
        stats += [0] * 8
    ts0, ts1, _, off_max, c_min, c_max, ty_min, ty_max, b_min, b_max, \
        *rest = host_ints(*stats, *extra)
    if ts0 != 0 or ts1 != n_tiles:
        raise ValueError(f"{name}: tile_start runs from {ts0} to {ts1}, not "
                         f"over the {n_tiles} tiles: layout and arguments "
                         f"disagree")
    if c_min < 0 or (n_tiles and c_max >= dstl.shape[0]):
        raise ValueError(f"{name}: tiles address dstl rows [{c_min}, "
                         f"{c_max}] of {dstl.shape[0]}: layout and arguments "
                         f"disagree")
    if ty_min < 0 or ty_max >= T2:
        raise ValueError(f"{name}: tile types [{ty_min}, {ty_max}] outside "
                         f"msg_w's {T2} types: msg_w does not belong to this "
                         f"layout")
    if b_min < 0 or b_max >= n_blocks:
        raise ValueError(f"{name}: tiles name blocks [{b_min}, {b_max}] of "
                         f"{n_blocks}: layout and arguments disagree")
    end = off_max * align + tile_e
    if n_tiles and end > h_pack.shape[0]:
        raise ValueError(f"{name}: h_pack has {h_pack.shape[0]} rows, fewer "
                         f"than the last tile reads ({end}): it was not "
                         f"gathered with this layout")
    return rest


def typed_onehot_scatter_reference(h_pack, dstl, tile_start, block_of_tile,
                                   tile_msg_off, c_off, tile_type, msg_w,
                                   n_blocks: int, tile_e: int, align: int):
    """Plain version of :func:`typed_onehot_scatter`: per type t, each real
    tile's one-hot product in f32 by ``index_add_``, rounded to ``msg_w``'s
    dtype per tile, then times W_t in f32; the tiles' products summed into
    their blocks in f64 and rounded once to f32 (a hub row adds thousands
    of tiles: an f32 sum would drift from any exact order)."""
    del tile_start
    return _typed_tile_sums(h_pack, dstl, block_of_tile, tile_msg_off, c_off,
                            tile_type, msg_w, n_blocks, tile_e, align,
                            torch.float64).float()


def _typed_tile_sums(h_pack, dstl, block_of_tile, tile_msg_off, c_off,
                     tile_type, msg_w, n_blocks, tile_e, align, acc_dtype):
    """The per-tile scatter's sums: each tile's product added to its block
    in ``acc_dtype``."""
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    dev = h_pack.device
    out = torch.zeros(n_blocks * BLOCK_N, D, dtype=acc_dtype, device=dev)
    real = tile_msg_off >= 0
    cols = torch.arange(tile_e, device=dev)
    rows128 = torch.arange(BLOCK_N, device=dev)
    for t in range(T2):
        sel = torch.nonzero(real & (tile_type == t)).flatten()
        n = sel.numel()
        if n == 0:
            continue
        d = dstl.long()[c_off.long()[sel]]                      # [n, tile_e]
        valid = d >= 0
        src = (tile_msg_off.long()[sel, None] * align + cols)[valid]
        tgt = (torch.arange(n, device=dev)[:, None] * BLOCK_N + d)[valid]
        p = torch.zeros(n * BLOCK_N, D, dtype=torch.float32, device=dev)
        p.index_add_(0, tgt, h_pack.index_select(0, src).float())
        p = p.to(msg_w.dtype).float() @ msg_w[t].float()
        out.index_add_(0, (block_of_tile.long()[sel, None] * BLOCK_N
                           + rows128).reshape(-1), p.to(acc_dtype))
    return out


def typed_step_gru_reference(h_pack, dstl, tile_start, block_of_tile,
                             tile_msg_off, c_off, tile_type, msg_w, init,
                             hstate, wa, b3, uzr, uh, n_blocks: int,
                             tile_e: int, align: int):
    """Plain version of :func:`typed_step_gru`: the per-tile scatter
    summed in f32, plus ``init``, then the GRU cell with matmul inputs in
    ``wa``'s dtype.  Its sums stay f32, the reference kernel's accumulator
    type: a sum's last bit decides which bf16 neighbour a rounds to before
    the gate matmuls, and the CPU tests hold this step to the reference's
    with one bf16 ulp.  On the card, the kernel is also held to the GRU
    cell of ``init`` plus :func:`typed_onehot_scatter_reference`'s f64
    sums."""
    del tile_start
    a = init.float() + _typed_tile_sums(
        h_pack, dstl, block_of_tile, tile_msg_off, c_off, tile_type, msg_w,
        n_blocks, tile_e, align, torch.float32)
    return gru_cell_fwd_reference(hstate, a, wa, b3, uzr, uh, mdt=wa.dtype)[0]


def dstl_lengths(dstl):
    """Each dstl row's length, its last slot with a dst id ≥ 0 plus one (0
    for none), int32 [n_dstl]: a tile's real rows lie in that prefix of its
    slots (``csrc/typed_pipe.cuh`` reads only those)."""
    slots = torch.arange(1, dstl.shape[1] + 1, dtype=torch.int32,
                         device=dstl.device)
    return torch.where(dstl >= 0, slots, 0).amax(1).to(torch.int32)


def _fused_tile_plan(name, h_pack, dstl, tile_start, block_of_tile,
                     tile_msg_off, c_off, tile_type, T2, n_blocks, tile_e,
                     align):
    """``csrc/typed_tile_fused.cu``'s plan (#6 and #7): the hub split
    (item_first, pbase), the blocks of more than one item first and in
    block order (``split``, int32 [n_blocks], of which the first n_split
    are read), :func:`dstl_lengths`, and the item, partial-slot and split
    counts, after the layout's data checks against the pack."""
    item_first, pbase, n_items, n_part = split_plan(tile_start.diff())
    multi = item_first[1:] - item_first[:-1] > 1
    n_items, n_part, n_split = _tile_data_checks(
        name, h_pack, dstl, tile_start, block_of_tile, tile_msg_off, c_off,
        tile_type, T2, n_blocks, tile_e, align,
        (n_items, n_part, multi.sum()))
    split = torch.argsort((~multi).to(torch.int8), stable=True)
    return (item_first, pbase, split.to(torch.int32), dstl_lengths(dstl),
            n_items, n_part, n_split)


def _launch_tile(name, fused, h_pack, dstl, tile_start, block_of_tile,
                 tile_msg_off, c_off, tile_type, msg_w, n_blocks, tile_e,
                 align, init=None, hstate=None, wa=None, b3=None, uzr=None,
                 uh=None):
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    if h_pack.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {h_pack.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    named = [("h_pack", h_pack), ("dstl", dstl), ("tile_start", tile_start),
             ("tile_msg_off", tile_msg_off), ("c_off", c_off),
             ("tile_type", tile_type), ("msg_w", msg_w)]
    if fused:
        named += [("init", init), ("hstate", hstate), ("wa", wa),
                  ("b3", b3), ("uzr", uzr), ("uh", uh)]
        for arg, t in named[7:]:
            want = (torch.float32 if arg in ("init", "hstate", "b3")
                    else h_pack.dtype)
            if t.dtype != want:
                raise ValueError(f"{name}: {arg} must be {want}, got "
                                 f"{t.dtype}")
    _check_cuda_args(name, named, D)
    dev = h_pack.device
    out = torch.empty(n_blocks * BLOCK_N, D, dtype=torch.float32, device=dev)
    p = _build.ptr
    if h_pack.dtype == torch.bfloat16 and tile_e % 16 == 0:
        # csrc/typed_tile_fused.cu: the one-hot product on the tensor
        # cores over each tile's real prefix; the blocks of more than one
        # item summed by a second kernel (#6: and their GRU run, 8 CTAs a
        # block; #7: float4 columns).  The plan and the layout's checks
        # once per layout and pack height, shared by #6 and #7 (no host
        # sync on later calls).
        item_first, pbase, split, lens, n_items, n_part, n_split = \
            cached_per_tensor(
                tile_start,
                ("typed_step_fused", h_pack.shape[0], n_blocks, tile_e,
                 align, T2) + tuple(t.data_ptr() for t in (
                     dstl, block_of_tile, tile_msg_off, c_off, tile_type)),
                lambda: _fused_tile_plan(
                    name, h_pack, dstl, tile_start, block_of_tile,
                    tile_msg_off, c_off, tile_type, T2, n_blocks, tile_e,
                    align))
        ws = torch.empty(max(n_part, 1), BLOCK_N, D, dtype=torch.float32,
                         device=dev)
        args = (p(h_pack), h_pack.shape[0], p(dstl), dstl.shape[0],
                p(tile_start), p(tile_msg_off), p(c_off), p(tile_type),
                p(lens), p(msg_w), T2, n_blocks, tile_e, align,
                p(item_first), p(pbase), n_items, p(split), n_split)
        lib = _build.library()
        if fused:
            _build.launch(lib.ggnn_typed_step_fused, name, dev, *args,
                          p(init), p(hstate), p(wa), p(b3), p(uzr), p(uh),
                          p(ws), p(out))
        else:
            _build.launch(lib.ggnn_typed_onehot_fused, name, dev, *args,
                          p(ws), p(out))
        return out
    item_first, pbase, n_items, n_part = split_plan(tile_start.diff())
    n_items, n_part = _tile_data_checks(
        name, h_pack, dstl, tile_start, block_of_tile, tile_msg_off, c_off,
        tile_type, T2, n_blocks, tile_e, align, (n_items, n_part))
    ws = torch.empty(max(n_part, 1), BLOCK_N, D, dtype=torch.float32,
                     device=dev)
    _build.launch(
        _build.library().ggnn_typed_tile, name, dev, _DTYPE_CODE[h_pack.dtype],
        int(fused), p(h_pack), h_pack.shape[0], p(dstl), dstl.shape[0],
        p(tile_start), p(tile_msg_off), p(c_off), p(tile_type), p(msg_w), T2,
        n_blocks, tile_e, align, p(item_first), p(pbase), n_items, n_part,
        p(init), p(hstate), p(wa), p(b3), p(uzr), p(uh), p(ws), p(out))
    return out


def typed_onehot_scatter(h_pack, dstl, tile_start, block_of_tile,
                         tile_msg_off, c_off, tile_type, msg_w,
                         n_blocks: int, tile_e: int, align: int):
    """Per-tile typed-pack scatter: out[b·128:(b+1)·128] =
    Σ_{tiles t of b} bf16(onehot(dstl[c_off[t]]) @ H_t) · W[type[t]]
    → [n_blocks·128, D] f32, H_t the ``tile_e`` rows of ``h_pack`` from
    tile_msg_off[t]·align (−1: a dummy tile, adding 0).

    ``h_pack`` [E_pack, D] and ``msg_w`` [T2, D, D] in the compute dtype;
    the int32 layout arrays as :func:`build_typed_dst_layout` made them.
    (The TPU kernel's DMA ring depth and span mode do not change the sums;
    the port has neither.)  A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/typed_tile_fused.cu``'s STORE form (bf16,
    tile_e a multiple of 16) or ``csrc/typed_tile.cu``, or raises."""
    name = "typed_onehot_scatter"
    _check_tile_args(name, h_pack, dstl, tile_start, block_of_tile,
                     tile_msg_off, c_off, tile_type, msg_w, n_blocks, tile_e)
    if h_pack.device.type == "cpu":
        _tile_data_checks(name, h_pack, dstl, tile_start, block_of_tile,
                          tile_msg_off, c_off, tile_type, msg_w.shape[0],
                          n_blocks, tile_e, align)
        return typed_onehot_scatter_reference(
            h_pack, dstl, tile_start, block_of_tile, tile_msg_off, c_off,
            tile_type, msg_w, n_blocks, tile_e, align)
    D = msg_w.shape[-1]
    if D != kernel_width(D):
        return narrow_width(typed_onehot_scatter(
            pad_width(h_pack, D), dstl, tile_start, block_of_tile,
            tile_msg_off, c_off, tile_type, pad_width(msg_w, D, rows=True),
            n_blocks, tile_e, align), D)
    if D > KERNEL_WIDTH:
        return _panel_scatter(lambda hp, w: typed_onehot_scatter(
            hp, dstl, tile_start, block_of_tile, tile_msg_off, c_off,
            tile_type, w, n_blocks, tile_e, align), h_pack, msg_w)
    out = _launch_tile(name, False, h_pack, dstl, tile_start, block_of_tile,
                       tile_msg_off, c_off, tile_type, msg_w, n_blocks,
                       tile_e, align)
    typed_onehot_scatter.launches += 1
    return out


def typed_step_gru(h_pack, dstl, tile_start, block_of_tile, tile_msg_off,
                   c_off, tile_type, msg_w, init, hstate, wa, b3, uzr, uh,
                   n_blocks: int, tile_e: int, align: int):
    """Fused per-tile typed aggregation + GRU step: ``init``
    [n_blocks·128, D] f32 is the Σ_t indeg_t·b_t bias, ``hstate`` the padded
    f32 node state, ``wa``/``uzr``/``uh`` in the compute dtype and ``b3``
    [1, 3D] f32; returns h' [n_blocks·128, D] f32.  The other arguments are
    those of :func:`typed_onehot_scatter`.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/typed_tile_fused.cu`` (bf16,
    tile_e a multiple of 16: the one-hot product on the tensor cores) or
    ``csrc/typed_tile.cu`` (``FUSED = true``), or raises."""
    name = "typed_step_gru"
    _check_tile_args(name, h_pack, dstl, tile_start, block_of_tile,
                     tile_msg_off, c_off, tile_type, msg_w, n_blocks, tile_e)
    D = msg_w.shape[-1]
    rows = n_blocks * BLOCK_N
    for arg, t, shape in (("init", init, (rows, D)),
                          ("hstate", hstate, (rows, D)),
                          ("wa", wa, (D, 3 * D)), ("uzr", uzr, (D, 2 * D)),
                          ("uh", uh, (D, D))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not {shape}")
    if b3.numel() != 3 * D:
        raise ValueError(f"{name}: b3 has {b3.numel()} entries, expected "
                         f"{3 * D}")
    if h_pack.device.type == "cpu":
        _tile_data_checks(name, h_pack, dstl, tile_start, block_of_tile,
                          tile_msg_off, c_off, tile_type, msg_w.shape[0],
                          n_blocks, tile_e, align)
        return typed_step_gru_reference(
            h_pack, dstl, tile_start, block_of_tile, tile_msg_off, c_off,
            tile_type, msg_w, init, hstate, wa, b3, uzr, uh, n_blocks,
            tile_e, align)
    if D != kernel_width(D):
        w, ini, hs, *gw = _pad_step(D, msg_w, init, hstate, wa, b3, uzr, uh)
        return narrow_width(typed_step_gru(
            pad_width(h_pack, D), dstl, tile_start, block_of_tile,
            tile_msg_off, c_off, tile_type, w, ini, hs, *gw, n_blocks,
            tile_e, align), D)
    if D > KERNEL_WIDTH:
        a = init + typed_onehot_scatter(h_pack, dstl, tile_start,
                                        block_of_tile, tile_msg_off, c_off,
                                        tile_type, msg_w, n_blocks, tile_e,
                                        align)
        return gru_cell_fwd(hstate, a, wa, b3.reshape(-1), uzr, uh,
                            mdt=wa.dtype)[0]
    out = _launch_tile(name, True, h_pack, dstl, tile_start, block_of_tile,
                       tile_msg_off, c_off, tile_type, msg_w, n_blocks,
                       tile_e, align, init, hstate, wa, b3.reshape(-1), uzr,
                       uh)
    typed_step_gru.launches += 1
    return out


typed_onehot_scatter.launches = 0
typed_step_gru.launches = 0


def tile_args(layout: ScatterLayout) -> dict:
    """The kernel arguments a per-tile layout (block mode declined)
    supplies."""
    meta = _typed_meta(layout)
    if meta[10] is not None:
        raise ValueError("block mode engaged for this layout: it goes to "
                         "typed_block_scatter / typed_block_step_gru "
                         "(block_args)")
    arrs = layout.arrays
    return dict(dstl=arrs["dstl"], tile_start=arrs["tile_start"],
                block_of_tile=arrs["block_of_tile"],
                tile_msg_off=arrs["tile_msg_off"], c_off=arrs["c_off"],
                tile_type=arrs["tile_type"], n_blocks=meta[3],
                tile_e=meta[1], align=meta[6])


def _typed_meta(layout: ScatterLayout) -> tuple:
    if not layout.typed:
        raise ValueError(
            "a legacy table-gather layout (build_dst_block_layout / "
            "layout_for_batch) has no typed-pack kernel arguments: it goes "
            "to aggregate_onehot, whose forward is ops/legacy.py::"
            "legacy_forward")
    return layout.meta


def block_args(layout: ScatterLayout) -> dict:
    """The kernel arguments a block-mode layout supplies."""
    meta = _typed_meta(layout)
    if meta[10] is None:
        raise ValueError("block mode declined for this layout: its per-tile "
                         "arrays go to typed_onehot_scatter / typed_step_gru "
                         "(tile_args)")
    S8, cmax, span_rows = meta[10]
    arrs = layout.arrays
    return dict(dstl_blk=arrs["dstl_blk"], slot_off16=arrs["slot_off16"],
                blk_off16=arrs["blk_off16"], n_blocks=meta[3],
                tile_e=meta[1], S8=S8, cmax=cmax, span_rows=span_rows)


def bias_rows(layout: ScatterLayout, msg_b):
    """Σ_t indeg_t(v)·b_t for every dst row of the layout, f32 [n_rows, D]."""
    return torch.einsum("tn,td->nd", layout.arrays["indeg"], msg_b.float())


def aggregate_forward(h, layout: ScatterLayout, msg_w, msg_b):
    """The aggregation's value alone (no autograd graph through the
    kernel).  Typed pack: the ``h_pack`` gather, the typed block kernel (or,
    where block mode declined, the per-tile kernel) and the bias.  Legacy
    layout: :func:`ggnn_tpu_torch.ops.legacy.legacy_forward`."""
    if not layout.typed:
        from ggnn_tpu_torch.ops.legacy import legacy_forward
        return legacy_forward(h, layout, msg_w, msg_b)
    N = h.shape[0]
    h_pack = h.index_select(0, layout.arrays["gather_idx"])
    if _typed_meta(layout)[10] is None:
        out = typed_onehot_scatter(h_pack, msg_w=msg_w, **tile_args(layout))
    else:
        kw = block_args(layout)
        out = typed_block_scatter(h_pack, kw.pop("dstl_blk"),
                                  kw.pop("slot_off16"), kw.pop("blk_off16"),
                                  msg_w, **kw)
    return (out + bias_rows(layout, msg_b))[:N]


class AggregateOnehot(torch.autograd.Function):
    """The reference's ``_aggregate_onehot`` custom VJP, applied only when
    the call records a gradient (:func:`~ggnn_tpu_torch.ops.window.
    takes_grad`; serving calls :func:`aggregate_forward` directly): the
    forward is :func:`aggregate_forward` (typed pack or legacy layout); the
    backward is :func:`aggregate_bwd`.  It saves h (in the compute dtype,
    as given) and ``msg_w``, not the gathered pack."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, layout):
        if layout.typed:
            grad_meta(layout)           # refuse a layout with no grad half
        ctx.layout = layout
        ctx.save_for_backward(h, msg_w)
        return aggregate_forward(h, layout, msg_w, msg_b)

    @staticmethod
    def backward(ctx, da):
        h, msg_w = ctx.saved_tensors
        dh, dW, db = aggregate_bwd(ctx.layout, h, msg_w, da.float())
        return dh, dW, db, None


def aggregate_onehot(h, layout: ScatterLayout, msg_w, msg_b):
    """Typed aggregation a_v = Σ_{(u,t,v)} h_u·W_t + b_t through the typed
    pack's kernels or a legacy layout's, differentiable through
    :class:`AggregateOnehot` (a typed pack must then be built
    ``with_grad=True``; a legacy layout without its grad half takes the
    reference's segment sum over ``dst_global``).  ``h`` [N, D] and
    ``msg_w``/``msg_b`` in the compute dtype; returns [N, D] f32.  Serving
    (grad mode off, as under ``torch.no_grad``, or no input that requires a
    gradient) takes any layout and keeps nothing for a backward."""
    if not takes_grad(h, msg_w, msg_b):
        return aggregate_forward(h, layout, msg_w, msg_b)
    return AggregateOnehot.apply(h, msg_w, msg_b, layout)


def grad_meta(layout: ScatterLayout) -> tuple:
    """The grad layout's static meta (the octet layout's, starting with
    "octet", or the legacy one's 6-tuple), or raise if the layout was built
    without its grad half."""
    gm = layout.meta[5] if len(layout.meta) > 5 else None
    if gm is None:
        raise ValueError(
            "the onehot backward needs the grad half of the typed layout: "
            "build it with build_typed_dst_layout(..., with_grad=True)")
    return gm


def _check_octet_args(name, G, dstl_oct, slot_off16, oblk16, n_oct, g_tile,
                      C, R8, span8):
    if G.dim() != 2:
        raise ValueError(f"{name}: G must be [E_pack, D], got "
                         f"{tuple(G.shape)}")
    if R8 < 8 * C:
        raise ValueError(f"{name}: R8 {R8} < 8·C = {8 * C}")
    if tuple(dstl_oct.shape) != (n_oct * R8, g_tile):
        raise ValueError(f"{name}: dstl_oct {tuple(dstl_oct.shape)} is not "
                         f"[n_oct·R8, g_tile] = [{n_oct * R8}, {g_tile}]: "
                         f"layout and arguments disagree")
    if tuple(slot_off16.shape) != (n_oct * 8 * C,):
        raise ValueError(f"{name}: slot_off16 {tuple(slot_off16.shape)} is "
                         f"not [n_oct·8·C] = [{n_oct * 8 * C}]: layout and "
                         f"arguments disagree")
    if tuple(oblk16.shape) != (n_oct,):
        raise ValueError(f"{name}: oblk16 {tuple(oblk16.shape)} is not "
                         f"[{n_oct}]: layout and arguments disagree")
    if G.shape[0] < span8:
        raise ValueError(f"{name}: G has {G.shape[0]} rows, fewer than one "
                         f"octet span ({span8}): it was not gathered with "
                         f"this layout")
    for arg, t in (("dstl_oct", dstl_oct), ("slot_off16", slot_off16),
                   ("oblk16", oblk16)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")


def typed_grad_octet_scatter_reference(G, dstl_oct, slot_off16, oblk16,
                                       n_oct: int, g_tile: int, C: int,
                                       R8: int, span8: int = 0,
                                       out_dtype=None):
    """Plain version of :func:`typed_grad_octet_scatter`: every slot's rows
    summed into their grad block's rows by ``index_add_`` in f64, rounded
    once to ``out_dtype`` (default f32): a hub row's millions of terms
    drift in an f32 ``index_add_``."""
    del span8
    D, dev = G.shape[-1], G.device
    Y = torch.zeros(n_oct * 8 * BLOCK_N, D, dtype=torch.float64, device=dev)
    off = slot_off16.reshape(n_oct, 8, C).long()
    dl = (dstl_oct.reshape(n_oct, R8, g_tile)[:, :8 * C]
          .reshape(n_oct, 8, C, g_tile).long())
    rows = (((oblk16.long()[:, None, None] + off) * 16)[..., None]
            + torch.arange(g_tile, device=dev))
    valid = (dl >= 0) & (off[..., None] >= 0)
    blk = torch.arange(n_oct * 8, device=dev).reshape(n_oct, 8, 1, 1)
    Y.index_add_(0, (blk * BLOCK_N + dl)[valid],
                 G.index_select(0, rows[valid]).double())
    return Y.to(torch.float32 if out_dtype is None else out_dtype)


def typed_grad_octet_scatter(G, dstl_oct, slot_off16, oblk16, n_oct: int,
                             g_tile: int, C: int, R8: int, span8: int,
                             out_dtype=None):
    """Y[row] = Σ_{edges packed to row} G[e] over the octet grad layout →
    [n_oct·8·128, D] in ``out_dtype`` (default f32), summed in f32.

    ``G`` [E_pack_g, D] is the cotangent gathered by ``g_gather_idx``; the
    int32 arrays and the ints are the layout's ``g_*`` arrays and
    ``grad_meta``.  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/grad_octet.cu`` or raises."""
    name = "typed_grad_octet_scatter"
    _check_octet_args(name, G, dstl_oct, slot_off16, oblk16, n_oct, g_tile,
                      C, R8, span8)
    if G.device.type == "cpu":
        return typed_grad_octet_scatter_reference(
            G, dstl_oct, slot_off16, oblk16, n_oct, g_tile, C, R8, span8,
            out_dtype)
    out_dtype = torch.float32 if out_dtype is None else out_dtype
    for what, dt in (("G", G.dtype), ("out_dtype", out_dtype)):
        if dt not in _DTYPE_CODE:
            raise ValueError(f"{name}: {what} {dt} not in {list(_DTYPE_CODE)}")
    D = G.shape[-1]
    if D != kernel_width(D):
        return narrow_width(typed_grad_octet_scatter(
            pad_width(G, D), dstl_oct, slot_off16, oblk16, n_oct, g_tile, C,
            R8, span8, out_dtype), D)
    if D > KERNEL_WIDTH:            # column panels: the sums are per column
        return torch.cat([typed_grad_octet_scatter(
            G[:, q:q + KERNEL_WIDTH].contiguous(), dstl_oct, slot_off16,
            oblk16, n_oct, g_tile, C, R8, span8, out_dtype)
            for q in range(0, D, KERNEL_WIDTH)], dim=1)
    _check_cuda_args(name, [("G", G), ("dstl_oct", dstl_oct),
                            ("slot_off16", slot_off16), ("oblk16", oblk16)],
                     D)
    out = torch.empty(n_oct * 8 * BLOCK_N, D, dtype=out_dtype,
                      device=G.device)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_grad_octet, name, G.device,
        _DTYPE_CODE[G.dtype], _DTYPE_CODE[out_dtype], p(G), G.shape[0],
        p(dstl_oct), p(slot_off16), p(oblk16), n_oct, g_tile, C, R8, p(out))
    typed_grad_octet_scatter.launches += 1
    return out


typed_grad_octet_scatter.launches = 0


def reverse_scatter(layout: ScatterLayout, da, n_rows: int, out_dtype):
    """Y_flat[row(u, t)] = Σ_{(u,t,v)} da[v] over the grad layout (the
    reference's ``_typed_reverse_scatter``), in the layout's table-row
    order; returns the first ``n_rows`` rows.  ``da`` is cast to
    ``out_dtype`` BEFORE the gather, as the reference does, and:

    - the octet layout goes through :func:`typed_grad_octet_scatter`;
    - a legacy grad layout packed at ``edge_align`` through
      :func:`window_block_spmm_mono` (one call over every grad block,
      whatever its chunks), one without alignment through its one-hot
      stream (``onehot_segment_scatter_mono``, the same kernel) or, with no
      stream, its dst-local ids (``onehot_segment_scatter``, f32 out);
    - a legacy layout with no grad half sums f32 ``da`` rows over
      ``dst_global`` into ``gather_idx``'s rows (the reference's segment
      sum, in a fixed order: ``ops/segment_rows.py``)."""
    gm = layout.meta[5]
    arrs = layout.arrays
    if gm is None:
        if layout.typed:
            grad_meta(layout)           # raises: the typed pack needs it
        dg = arrs["dst_global"]
        G = da.index_select(0, dg.clamp_min(0)) * (dg >= 0)[:, None]
        return SR.wide_segment_rows_sum(G, arrs["gather_idx"], n_rows)
    G = da.to(out_dtype).index_select(0, arrs["g_gather_idx"])
    if gm[0] == "octet":
        _, _, g_tile, C, R8, span8, n_oct = gm
        Y_flat = typed_grad_octet_scatter(
            G, arrs["g_dstl_oct"], arrs["g_slot_off16"], arrs["g_oblk16"],
            n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8,
            out_dtype=out_dtype)
        return Y_flat[:n_rows]
    from ggnn_tpu_torch.ops import legacy
    g_blocks, g_max_tiles, g_tile, g_has_onehot, g_align = gm[:5]
    if g_align is not None:
        use_dstl = "g_dstl" in arrs
        Y_flat = window_block_spmm_mono(
            G, arrs["g_dstl"] if use_dstl else arrs["g_onehot"],
            arrs["g_tile_start"], arrs["g_block_of_tile"],
            arrs["g_tile_msg_off"], n_blocks=g_blocks, window=g_tile,
            win_stride=g_align, out_rows=BLOCK_N, out_dtype=out_dtype,
            dstl=use_dstl)
    elif g_has_onehot:
        Y_flat = legacy.onehot_segment_scatter_mono(
            G, arrs["g_onehot"], arrs["g_tile_start"],
            arrs["g_block_of_tile"], n_blocks=g_blocks, tile_e=g_tile,
            out_dtype=out_dtype)
    else:
        Y_flat = legacy.onehot_segment_scatter(
            G, arrs["g_dst_local"], arrs["g_tile_start"], n_blocks=g_blocks,
            max_tiles=g_max_tiles, tile_e=g_tile)
    return Y_flat[:n_rows]


def aggregate_bwd(layout: ScatterLayout, h, msg_w, da):
    """Cotangents (dh, dW, db) of :func:`aggregate_forward` for the output
    cotangent ``da`` [N, D] f32 (the reference's ``_aggregate_bwd``): Y of
    :func:`reverse_scatter`, flushed in h's dtype where a kernel flushes
    it; db from the grad half's per-(type, dst) edge counts, or summed from
    Y; dh and dW from Y's block-major rows (the typed pack, a legacy layout
    with ``row_order='block'``) or type-major ones.  dh comes back in h's
    dtype, dW and db in ``msg_w``'s."""
    T2, D = msg_w.shape[0], msg_w.shape[-1]
    N = h.shape[0]
    block = layout.meta[7] in ("typed", "block")
    if block and N % BLOCK_N:
        raise ValueError(f"the onehot backward needs h's row count to be a "
                         f"multiple of {BLOCK_N} (block-major grad rows), "
                         f"got {N}: pad the batch to the 128-row grid")
    Y_flat = reverse_scatter(layout, da, T2 * N, out_dtype=h.dtype)
    db = None
    if "g_indeg" in layout.arrays:
        # db as one [T2, N]·[N, D] product with the per-(type, dst) edge
        # counts
        g_indeg = layout.arrays["g_indeg"]
        n_dst = g_indeg.shape[1]
        da_db = (torch.nn.functional.pad(da, (0, 0, 0, n_dst - da.shape[0]))
                 if da.shape[0] < n_dst else da[:n_dst])
        db = torch.einsum("tn,nd->td", g_indeg, da_db.float()).to(
            msg_w.dtype)
    # the products: inputs in Y's dtype (the compute dtype where a kernel
    # flushed Y, f32 where Y stayed f32, as the reference promotes), f32
    # sums, one rounding to the output dtype (on the card, cuBLAS may
    # reduce split-K partials of a bf16 product in bf16 unless
    # torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is
    # off)
    w, hy = msg_w.to(Y_flat.dtype), h.to(Y_flat.dtype)
    if block:
        Yb = Y_flat.reshape(N // BLOCK_N, T2, BLOCK_N, D)
        dh = torch.einsum("btsf,tdf->bsd", Yb, w).reshape(N, D)
        dW = torch.einsum("bsd,btsf->tdf",
                          hy.reshape(N // BLOCK_N, BLOCK_N, D), Yb)
        if db is None:
            db = Yb.float().sum((0, 2)).to(msg_w.dtype)
    else:
        Y = Y_flat.reshape(T2, N, D)
        dh = torch.einsum("tnf,tdf->nd", Y, w)
        dW = torch.einsum("nd,tnf->tdf", hy, Y)
        if db is None:
            db = Y.float().sum(1).to(msg_w.dtype)
    return dh.to(h.dtype), dW.to(msg_w.dtype), db
