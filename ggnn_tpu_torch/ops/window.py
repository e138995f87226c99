"""The window backend: its layout, and the windowed count-matrix kernels.

Counterpart of ``ggnn_tpu/ops/window_pallas.py`` (the clustered-graph fast
path: the edges into one destination block that read one ``window``-row
range of the node-transform table collapse into one count matrix C, and
out[block] = Σ_win C · table[win·W : win·W + W]):

- :class:`DeviceWindowLayout` (the same 11-tuple ``meta`` and array keys
  as the reference, numpy on the host, tensors after :meth:`.to
  <DeviceWindowLayout.to>`), :func:`build_window_layout` (the reference's
  numpy path, every option of the forward), :func:`window_layout_for_batch`
  (the static-budget layout of the reference's ``Predictor``),
  :func:`prefer_xw_spill`; ``with_grad`` adds the backward's half
  (:func:`_grad_half`) and ``grad_quant`` its int8 gradients.
- #11 :func:`window_block_spmm_mono` (``csrc/window_mono.cu``): the
  dst-local stream (the legacy grad layouts' reverse scatter and the
  window layouts' spill) and the int8 or int4-packed count matrix with
  output blocks of any multiple of 128 rows.  The per-tile kernels
  (``csrc/typed_tile.cu``) share its hub split :func:`split_plan`.
- #20 :func:`window_block_spmm` (``csrc/window_auto_gather.cu``): the
  reference's auto-pipelined variant of #11 over unpacked 128-row count
  tiles, here a gather-sum of the nonzero counts alone on a plan made once
  per layout (:func:`window_auto_plan`); only the reference's window probe
  and tests run it (``scripts/torch_window_variants.py`` here).
- #12 :func:`window_block_spmm_ondemand` (``csrc/window_ondemand.cu``) and
  #13 :func:`window_step_gru` (``csrc/window_step.cu``, ``_q8.cu``,
  ``_ondemand.cu``; one template, ``csrc/window_step.cuh``): table
  windows built from h blocks on the chip, and the fused step
  (aggregation + GRU epilogue) over a bf16/f32 table, a q8 table with
  power-of-2 window scales, or on-demand windows; with ``emit_res`` it also
  writes the training residuals (``csrc/window_step_res.cu``,
  ``_ondemand_res.cu``).
- the backward: :func:`quantize_grad_pow2` (plain torch, as in the
  reference) and #14 :func:`window_bwd_fused` (``csrc/window_bwd.cu``): dh
  and dW of the window aggregation from the forward count stream, exact or
  with int8 ā.

Each kernel has a ``_reference`` plain version with the same rounding
points; the plain sums run in f64 and round once.  A wrapper takes its
plain version only for CPU tensors; for CUDA tensors it launches the kernel
or raises.  The compositions (spill, ``aggregate_window``,
``gru_window_step``) are in ``ops/window_step.py``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
import weakref

import numpy as np
import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import (BLOCK, KERNEL_WIDTH, _DTYPE_CODE,
                                    _check_cuda_args, _scatter_data_checks,
                                    gru_cell_fwd, gru_cell_fwd_reference,
                                    host_ints, kernel_width, narrow_width,
                                    pad_width)
from ggnn_tpu_torch.ops.table import node_table_block_major_reference

_NONZERO_CHUNK = 1 << 26      # count entries one pass of a plain sum decodes


# --- the layout --------------------------------------------------------------

@dataclasses.dataclass
class DeviceWindowLayout:
    """The windowed layout (the reference's class): ``meta`` = (n_nodes_pad,
    window, n_tiles, n_blocks, spill_meta, row_major, grad_meta, block_rows,
    (pack_fwd, pack_bwd), on_demand, grad_quant); ``arrays``: c_stream,
    tile_start, block_of_tile, win_of_tile, c_off and the spill's ``s_*``
    (and ``sx_src`` for the XW spill), numpy on the host or tensors on a
    device; ``stats``: tile count, stream bytes, spill fraction."""

    meta: tuple
    arrays: dict
    stats: dict | None = dataclasses.field(default=None, compare=False)

    @property
    def n_nodes_pad(self):
        return self.meta[0]

    @property
    def window(self):
        return self.meta[1]

    @property
    def n_tiles(self):
        return self.meta[2]

    @property
    def n_blocks(self):
        return self.meta[3]

    @property
    def spill_meta(self):
        return self.meta[4]

    @property
    def row_major(self):
        return self.meta[5]

    @property
    def grad_meta(self):
        return self.meta[6]

    @property
    def block_rows(self):
        return self.meta[7]

    @property
    def packed(self):
        """(fwd, bwd) int4 count-packing flags."""
        return self.meta[8]

    @property
    def on_demand(self):
        """Table windows built on the chip from h blocks (no [T2·N, D]
        table): :func:`window_block_spmm_ondemand`."""
        return self.meta[9]

    def to(self, device) -> "DeviceWindowLayout":
        """A copy whose arrays are tensors on ``device`` (the host arrays
        are copied as they are: the padded count stream of a static budget
        too)."""
        return DeviceWindowLayout(self.meta, {
            k: torch.as_tensor(v, device=device)
            for k, v in self.arrays.items()}, self.stats)


def _pack_nibbles(c: np.ndarray) -> np.ndarray:
    """[R, W] int8 counts in 0..15 → [R, W/2] bytes: low nibble = column w,
    high nibble = column w + W/2."""
    half = c.shape[1] // 2
    out = c[:, half:].astype(np.uint8)
    out <<= 4
    np.bitwise_or(out, c[:, :half].view(np.uint8), out=out)
    return out.view(np.int8)


# The reference's measured per-row gather cliff of the TPU, which its spill
# heuristic keys on (window_pallas.py:114-121); kept so that the port picks
# the same spill as the reference for the same graph.
GATHER_CLIFF_BYTES = 100e6
# real edges from this many on plan their window layout in the native
# library (the reference's threshold, window_pallas.py:263-264)
NATIVE_PLAN_EDGES = 200_000


def prefer_xw_spill(n_nodes_pad: int, state_dim: int, *,
                    quantized: bool = False,
                    on_demand: bool = False) -> bool:
    """The reference's spill heuristic: the XW (no-table) spill for
    on-demand layouts (they have no table) and for q8 tables while h's bf16
    bytes stay under :data:`GATHER_CLIFF_BYTES`; the legacy table-gather
    spill otherwise."""
    if on_demand:
        return True
    if not quantized:
        return False
    return n_nodes_pad * state_dim * 2 <= GATHER_CLIFF_BYTES


def _type_buckets(spt, t2, spill_bwd_bucket):
    """Per-type padded bucket offsets of the XW spill (the reference's
    rule: a multiple of 8 per type, uniform where that costs at most 2×)."""
    cnt = np.bincount(spt, minlength=t2)
    if spill_bwd_bucket is not None:
        if int(cnt.max(initial=0)) > spill_bwd_bucket:
            raise ValueError(
                f"spill_bwd_bucket={spill_bwd_bucket} < max "
                f"per-type spill count {int(cnt.max())}")
        padded = np.full(t2, spill_bwd_bucket, np.int64)
    else:
        padded = np.maximum(-(-cnt // 8) * 8, 8)
        pmax = int(padded.max())
        if t2 * pmax <= max(2 * int(padded.sum()), 4096):
            padded = np.full(t2, pmax, np.int64)
    offs = np.zeros(t2 + 1, np.int64)
    np.cumsum(padded, out=offs[1:])
    return cnt, offs


def build_window_layout(edge_src, edge_dst, edge_type, edge_mask,
                        n_nodes_pad: int, window: int = 512,
                        min_edges_per_tile: int = 32,
                        n_src_rows: int | None = None,
                        spill_tile_e: int | None = None,
                        n_message_types: int | None = None,
                        row_major: str = "src",
                        with_grad: bool = False,
                        pad_tiles_to: int | None = None,
                        spill_pad_tiles_to: int | None = None,
                        force_spill: bool = False,
                        block_rows: int = BLOCK,
                        pack_counts: bool = False,
                        use_native: bool | None = None,
                        gt_pad_tiles_to: int | None = None,
                        spill_bwd_bucket: int | None = None,
                        spill_bwd_tile_e: int | None = None,
                        spill_bwd_pad_tiles_to: int | None = None,
                        typed_spill: bool = False,
                        spill_dst_order: bool = False,
                        on_demand: bool = False,
                        grad_quant: bool = False) -> DeviceWindowLayout:
    """The reference's host build (numpy), array for array: real edges
    grouped by (dst block of ``block_rows`` rows, ``window``-row window of
    the table); tiles with fewer than ``min_edges_per_tile`` edges, and
    (dst, table row) pairs repeated more than 127 times (15 packed), spill
    to a per-edge layout.  Returns the host form (numpy arrays);
    ``.to(device)`` moves it.

    - ``row_major``: the table's row order, 'block' (row = (src // 128)·
      T2·128 + t·128 + src % 128), 'src' (src·T2 + t) or 'type'
      (t·n_src_rows + src);
    - ``pack_counts``: int4 pairs (column w low, w + W/2 high; W ≥ 256);
    - ``typed_spill``: the XW spill (h rows gathered into type buckets,
      transformed there, then scattered; ``spill_dst_order`` keeps the
      dst order inside a type); otherwise the spill gathers table rows;
    - ``on_demand``: no table (needs 'block', W % 128 == 0, unpacked, the
      XW spill, (T2·128) % W == 0);
    - ``pad_tiles_to`` / ``spill_pad_tiles_to``: static tile budgets (the
      padding tiles go to the last block, the stream is padded too).

    - ``with_grad``: the backward's half (:func:`_grad_half`): transposed
      tiles, the in-degrees of the bias gradient, the spill backward's
      buckets; ``gt_pad_tiles_to``, ``spill_bwd_bucket``,
      ``spill_bwd_tile_e`` and ``spill_bwd_pad_tiles_to`` pin its shapes;
    - ``grad_quant``: int8 gradients in the fused backward (``meta[10]``;
      it warns and stays exact where the fused backward does not apply).

    - ``use_native``: the tile plan and the count streams from the port's
      native host library (:class:`~ggnn_tpu_torch.native.
      WindowPlanNative`, one radix sort in place of the ``np.unique`` and
      ``np.add.at`` passes; the same arrays); None picks it from
      ``NATIVE_PLAN_EDGES`` real edges on where its key fits, as the
      reference; a failed build raises (``native.NativeBuildError``), and
      so does ``True`` where the key does not fit."""
    from ggnn_tpu_torch.ops.legacy import build_dst_block_layout
    if block_rows % BLOCK:
        raise ValueError(f"block_rows must be a multiple of {BLOCK}")
    if n_nodes_pad % block_rows:
        raise ValueError("n_nodes_pad must be a multiple of block_rows")
    if row_major not in ("block", "src", "type"):
        raise ValueError(
            f"row_major must be 'block', 'src' or 'type': {row_major!r}")
    pack_fwd = pack_counts and window >= 256
    pack_bwd = pack_counts and block_rows >= 256
    if pack_counts and not pack_fwd:
        raise ValueError("pack_counts needs window >= 256 (a packed row "
                         "of window/2 bytes must fill the 128-lane tile)")
    if on_demand:
        if row_major != "block" or window % 128 or pack_counts:
            raise ValueError("on_demand needs row_major='block', "
                             "window % 128 == 0, unpacked counts")
        if not typed_spill:
            raise ValueError("on_demand needs typed_spill=True (no table "
                             "exists for the spill to gather)")
    if n_src_rows is None:
        n_src_rows = n_nodes_pad
    real = np.asarray(edge_mask) > 0
    src = np.asarray(edge_src)[real].astype(np.int64)
    dst = np.asarray(edge_dst)[real].astype(np.int64)
    typ = np.asarray(edge_type)[real].astype(np.int64)
    n_edges = src.shape[0]

    t2 = (n_message_types if n_message_types is not None
          else int(typ.max(initial=0)) + 1)
    if row_major == "block":
        if n_src_rows % 128:
            raise ValueError("row_major='block' needs n_src_rows % 128 == 0")
        rows = (src // 128) * (t2 * 128) + typ * 128 + src % 128
    elif row_major == "src":
        rows = src * t2 + typ
    else:
        rows = typ * n_src_rows + src
    n_wins = -(-t2 * n_src_rows // window)
    win = rows // window
    block = dst // block_rows
    n_blocks = n_nodes_pad // block_rows
    key = block * n_wins + win
    max_count = 15 if pack_fwd else 127

    plan = None
    if use_native is None:
        from ggnn_tpu_torch.native import WindowPlanNative
        use_native = (n_edges >= NATIVE_PLAN_EDGES and WindowPlanNative.fits(
            window, block_rows, n_wins, n_blocks))
    if use_native:
        from ggnn_tpu_torch.native import WindowPlanNative
        plan = WindowPlanNative(rows, dst, window, block_rows, n_wins,
                                n_blocks, min_edges_per_tile, max_count,
                                want_grad=with_grad)
        keep = plan.keep
    else:
        _, inv, counts = np.unique(key, return_inverse=True,
                                   return_counts=True)
        keep = (counts >= min_edges_per_tile)[inv.reshape(-1)]
        # (dst, table row) pairs past the count's range spill: the per-edge
        # path takes duplicates as they come
        pair = rows * np.int64(n_nodes_pad) + dst
        _, pinv, pcounts = np.unique(pair, return_inverse=True,
                                     return_counts=True)
        keep &= pcounts[pinv.reshape(-1)] <= max_count

    def decode_rows(r):
        """table row → (type, src) for this row_major."""
        if row_major == "block":
            rpb = t2 * 128
            return (r % rpb) // 128, (r // rpb) * 128 + r % 128
        if row_major == "src":
            return r % t2, r // t2
        return r // n_src_rows, r % n_src_rows

    spill = None
    xw_state = None
    spill_frac = 1.0 - (float(keep.sum()) / max(n_edges, 1))
    if typed_spill and ((~keep).any() or force_spill):
        # the XW spill: h rows gathered into type-major buckets (slot =
        # the edge's bucket row), transformed there, then scattered by the
        # ordinary block layout whose "source row" is that slot
        if pack_counts:
            raise ValueError("typed_spill is incompatible with pack_counts")
        n_spill = int((~keep).sum())
        sp_t, sp_u = decode_rows(rows[~keep])
        sp_d = dst[~keep]
        if spill_dst_order:
            order = np.argsort(sp_t, kind="stable")
        else:
            order = np.argsort(sp_t * np.int64(n_src_rows) + sp_u,
                               kind="stable")
        spt, spu, spd = sp_t[order], sp_u[order], sp_d[order]
        cnt, offs = _type_buckets(spt, t2, spill_bwd_bucket)
        tot = int(offs[-1])
        first_of_t = np.zeros(t2, np.int64)
        first_of_t[1:] = np.cumsum(cnt)[:-1]
        slot = offs[spt] + (np.arange(n_spill) - first_of_t[spt])
        x_src = np.full(tot, n_src_rows, np.int64)   # pad slots → masked
        x_src[slot] = spu
        xw_state = (tuple(int(o) for o in offs), slot, spd, x_src)
        if spill_tile_e is None:
            spill_tile_e = _median_tile(spd, n_nodes_pad)
        spill = build_dst_block_layout(
            slot, spd, np.zeros(n_spill, np.int64),
            np.ones(n_spill, np.float32), n_nodes_pad,
            tile_e=spill_tile_e, n_src_rows=tot,
            pad_tiles_to=spill_pad_tiles_to,
            edge_align=(16 if spill_tile_e % 16 == 0 else None),
            dstl_stream=spill_tile_e % 16 == 0)
    elif (~keep).any() or force_spill:
        # the legacy spill gathers the rows of the same table the windows
        # read (edge_type 0, n_src_rows = the table's rows)
        n_spill = int((~keep).sum())
        if spill_tile_e is None:
            spill_tile_e = _median_tile(dst[~keep], n_nodes_pad)
        spill = build_dst_block_layout(
            rows[~keep], dst[~keep], np.zeros(n_spill, np.int64),
            np.ones(n_spill, np.float32), n_nodes_pad,
            tile_e=spill_tile_e, n_src_rows=t2 * n_src_rows,
            pad_tiles_to=spill_pad_tiles_to,
            edge_align=(16 if spill_tile_e % 16 == 0 else None),
            dstl_stream=spill_tile_e % 16 == 0)

    # the dense tiles, plus one dummy tile (win = −1) per block so that an
    # empty block has a tile; the count stream holds the real tiles only,
    # addressed through c_off
    real_keys = (plan.dense_keys if plan is not None
                 else np.unique(key[keep]))
    dummy = np.arange(n_blocks, dtype=np.int64) * n_wins
    uniq_t = np.unique(np.concatenate([real_keys, dummy]))
    n_tiles = uniq_t.shape[0]
    n_real = real_keys.shape[0]
    is_real = np.isin(uniq_t, real_keys, assume_unique=True)
    block_of_tile = (uniq_t // n_wins).astype(np.int32)
    win_of_tile = np.where(is_real, uniq_t % n_wins, -1).astype(np.int32)
    c_off = np.zeros(n_tiles, np.int32)
    c_off[is_real] = np.arange(n_real, dtype=np.int32)
    tile_counts = np.bincount(block_of_tile, minlength=n_blocks)
    tile_start = np.zeros(n_blocks + 1, np.int32)
    np.cumsum(tile_counts, out=tile_start[1:])

    if pad_tiles_to is not None:
        extra = pad_tiles_to - n_tiles
        if extra < 0:
            raise ValueError(f"pad_tiles_to={pad_tiles_to} < {n_tiles}")
        if extra:
            block_of_tile = np.concatenate(
                [block_of_tile, np.full(extra, n_blocks - 1, np.int32)])
            win_of_tile = np.concatenate(
                [win_of_tile, np.full(extra, -1, np.int32)])
            c_off = np.concatenate([c_off, np.zeros(extra, np.int32)])
            tile_start[-1] += extra
            n_tiles = pad_tiles_to

    # a static budget pads the stream too (its rows are never read)
    stream_tiles = (pad_tiles_to if pad_tiles_to is not None
                    else max(n_real, 1))
    if plan is not None:
        # (the plan's pair filter keeps every count within max_count)
        c = plan.fill_counts(real_keys, pack_fwd, total_tiles=stream_tiles)
    else:
        tile_of_edge = np.searchsorted(real_keys, key[keep])
        c = np.zeros((stream_tiles * block_rows, window), np.int8)
        np.add.at(c, (tile_of_edge * block_rows
                      + (dst[keep] - block[keep] * block_rows),
                      rows[keep] % window), 1)
        # (a static budget's padding rows are never written: the real
        # tiles' rows hold every count)
        if int(c[:max(n_real, 1) * block_rows].sum(dtype=np.int64)) \
                != int(keep.sum()):
            raise ValueError("count-matrix overflow: >127 duplicate edges "
                             "for one (dst, table-row) pair within a tile")
        if pack_fwd:
            c = _pack_nibbles(c)

    arrays = {"c_stream": c, "tile_start": tile_start,
              "block_of_tile": block_of_tile, "win_of_tile": win_of_tile,
              "c_off": c_off}
    spill_meta = None
    if spill is not None:
        sdev = spill.to("cpu")
        for k, v in sdev.arrays.items():
            arrays["s_" + k] = v.numpy()
        spill_meta = sdev.meta
        if xw_state is not None:
            # a 9th spill_meta element, the type buckets' offsets, marks
            # the XW spill; sx_src is each bucket slot's src (pad slots
            # hold n_src_rows and read a zero row)
            arrays["sx_src"] = xw_state[3].astype(np.int32)
            spill_meta = sdev.meta + (xw_state[0],)
    grad_meta = None
    if with_grad:
        grad_meta = _grad_half(
            arrays, win=win, block=block, keep=keep, rows=rows, dst=dst,
            typ=typ, real_keys=real_keys, n_wins=n_wins, n_blocks=n_blocks,
            t2=t2, window=window, block_rows=block_rows,
            n_nodes_pad=n_nodes_pad, n_src_rows=n_src_rows,
            row_major=row_major, pack_counts=pack_counts, pack_bwd=pack_bwd,
            plan=plan, spill=spill, xw_state=xw_state, decode_rows=decode_rows,
            gt_pad_tiles_to=gt_pad_tiles_to,
            spill_bwd_bucket=spill_bwd_bucket,
            spill_bwd_tile_e=spill_bwd_tile_e,
            spill_bwd_pad_tiles_to=spill_bwd_pad_tiles_to)
    if on_demand and (t2 * 128) % window:
        raise ValueError("on_demand needs (T2*128) % window == 0")
    if grad_quant and not (with_grad and grad_meta is not None
                           and grad_meta[4]):
        warnings.warn("grad_quant needs with_grad=True and the fused "
                      "backward stream; running exact bf16 gradients",
                      stacklevel=2)
        grad_quant = False
    lay = DeviceWindowLayout(
        meta=(n_nodes_pad, window, n_tiles, n_blocks, spill_meta, row_major,
              grad_meta, block_rows, (pack_fwd, pack_bwd), on_demand,
              grad_quant),
        arrays=arrays)
    lay.stats = {
        "n_tiles": int(n_tiles), "n_edges": int(n_edges),
        "spill_frac": spill_frac, "window": window,
        "stream_gb": int(c.shape[0]) * c.shape[1] * 1e-9,
        "table_reads_gb": n_real * window * 2 * 1e-9,
        "spill_pack": (int(arrays["s_gather_idx"].shape[0])
                       if "s_gather_idx" in arrays else 0),
    }
    return lay


def _median_tile(ids, n_rows):
    """The spill tile size rule on ``ids`` (rows of ``n_rows``): the median
    128-row block's count, rounded up to a power of two in [128, 2048]."""
    cnts = np.bincount((ids // BLOCK).astype(np.int64),
                       minlength=n_rows // BLOCK)
    med = int(np.median(cnts)) if ids.shape[0] else 0
    tile = 128
    while tile < min(med, 2048):
        tile *= 2
    return tile


def _grad_half(arrays, *, win, block, keep, rows, dst, typ, real_keys,
               n_wins, n_blocks, t2, window, block_rows, n_nodes_pad,
               n_src_rows, row_major, pack_counts, pack_bwd, plan, spill,
               xw_state, decode_rows, gt_pad_tiles_to, spill_bwd_bucket,
               spill_bwd_tile_e, spill_bwd_pad_tiles_to):
    """The reference's ``with_grad`` half (``window_pallas.py:476-649``),
    added to ``arrays``; returns ``grad_meta`` = (n_wins, n_gt_tiles,
    spill_bwd_offsets, spill_bwd_meta, bwd_fwd_stream).

    The transposed tiles ``gt_*`` of Y = Cᵀ·ā: output blocks are the
    W-row table windows (each keeps at least a dummy tile), inputs the dst
    blocks.  Where the fused backward applies (block-major rows, unpacked
    counts, W % 128 == 0 and (T2·128) % W == 0) ``gt_c_off`` points into
    the forward stream; otherwise a transposed stream ``ct_stream`` [n·W,
    block_rows] (int4 pairs with ``pack_bwd``).  ``gt_indeg`` [T2, N] f32
    counts every real edge per (type, dst) for the bias gradient.  The
    spill backward's type-major buckets ``s_bwd_src`` / ``s_bwd_dst``
    (the XW spill's own, where it has them) and, for n_src_rows % 128 ==
    0, the ``sb_*`` layout that scatters the per-edge dh rows to their
    source rows."""
    from ggnn_tpu_torch.ops.legacy import build_dst_block_layout
    real_t = (plan.dense_keys_t if plan is not None
              else np.unique(win[keep] * n_blocks + block[keep]))
    uniq_gt = np.unique(np.concatenate(
        [real_t, np.arange(n_wins, dtype=np.int64) * n_blocks]))
    n_gt = uniq_gt.shape[0]
    n_gt_real = real_t.shape[0]
    is_real_t = np.isin(uniq_gt, real_t, assume_unique=True)
    gt_block = (uniq_gt // n_blocks).astype(np.int32)    # out: window
    gt_win = np.where(is_real_t, uniq_gt % n_blocks,     # in: dst block
                      -1).astype(np.int32)
    gt_counts = np.bincount(gt_block, minlength=n_wins)
    gt_start = np.zeros(n_wins + 1, np.int32)
    np.cumsum(gt_counts, out=gt_start[1:])
    bwd_fwd_stream = (row_major == "block" and not pack_counts
                      and window % 128 == 0 and (t2 * 128) % window == 0)
    gt_c_off = np.zeros(n_gt, np.int32)
    if bwd_fwd_stream:
        # the backward tile (w, B) is the forward tile (B, w) transposed:
        # its offset is the forward real tile's
        fwd_keys = ((real_t % n_blocks) * np.int64(n_wins)
                    + real_t // n_blocks)
        gt_c_off[is_real_t] = np.searchsorted(real_keys,
                                              fwd_keys).astype(np.int32)
    else:
        gt_c_off[is_real_t] = np.arange(n_gt_real, dtype=np.int32)
        if plan is not None:
            ct = plan.fill_counts_t(real_t, pack_bwd)
            if n_gt_real == 0:          # the numpy path's one empty tile
                ct = np.zeros((window, ct.shape[1]), np.int8)
        else:
            key_t = win[keep] * n_blocks + block[keep]
            gt_of_edge = np.searchsorted(real_t, key_t)
            ct = np.zeros((max(n_gt_real, 1) * window, block_rows), np.int8)
            np.add.at(ct, (gt_of_edge * window + rows[keep] % window,
                           dst[keep] - block[keep] * block_rows), 1)
            if pack_bwd:
                ct = _pack_nibbles(ct)
        if gt_pad_tiles_to is not None:
            want = gt_pad_tiles_to * window
            if ct.shape[0] < want:
                ct = np.concatenate(
                    [ct, np.zeros((want - ct.shape[0], ct.shape[1]),
                                  np.int8)])
        arrays["ct_stream"] = ct
    if gt_pad_tiles_to is not None:
        extra = gt_pad_tiles_to - n_gt
        if extra < 0:
            raise ValueError(
                f"gt_pad_tiles_to={gt_pad_tiles_to} < required {n_gt}")
        if extra:
            # dummies on the last window, never a window's first tile
            gt_block = np.concatenate(
                [gt_block, np.full(extra, n_wins - 1, np.int32)])
            gt_win = np.concatenate([gt_win, np.full(extra, -1, np.int32)])
            gt_c_off = np.concatenate([gt_c_off, np.zeros(extra, np.int32)])
            gt_start[-1] += extra
            n_gt = gt_pad_tiles_to
    arrays.update(gt_tile_start=gt_start, gt_block_of_tile=gt_block,
                  gt_win_of_tile=gt_win, gt_c_off=gt_c_off)
    indeg = np.bincount(typ * np.int64(n_nodes_pad) + dst,
                        minlength=t2 * n_nodes_pad)
    arrays["gt_indeg"] = indeg.reshape(t2, n_nodes_pad).astype(np.float32)
    spill_bwd_offsets = spill_bwd_meta = None
    if spill is not None:
        if xw_state is not None:
            # the XW spill's buckets, reused as they are
            offs_t, slot, sp_dst, e_src = xw_state
            offs = np.asarray(offs_t, np.int64)
            tot = int(offs[-1])
            n_sp = slot.shape[0]
            sp_u = e_src[slot]
            e_dst = np.zeros(tot, np.int64)
            e_dst[slot] = sp_dst
        else:
            sp_dst = dst[~keep]
            sp_t, sp_u = decode_rows(rows[~keep])
            order = np.argsort(sp_t * np.int64(n_src_rows) + sp_u,
                               kind="stable")
            sp_t, sp_u, sp_dst = sp_t[order], sp_u[order], sp_dst[order]
            n_sp = sp_t.shape[0]
            cnt, offs = _type_buckets(sp_t, t2, spill_bwd_bucket)
            tot = int(offs[-1])
            first_of_t = np.zeros(t2, np.int64)
            first_of_t[1:] = np.cumsum(cnt)[:-1]
            slot = offs[sp_t] + (np.arange(n_sp) - first_of_t[sp_t])
            e_dst = np.zeros(tot, np.int64)     # padding: row 0, masked h
            e_src = np.full(tot, n_src_rows, np.int64)
            e_dst[slot] = sp_dst
            e_src[slot] = sp_u
        arrays["s_bwd_dst"] = e_dst.astype(np.int32)
        arrays["s_bwd_src"] = e_src.astype(np.int32)
        spill_bwd_offsets = tuple(int(o) for o in offs)
        if n_src_rows % BLOCK == 0:
            sb_tile = (spill_bwd_tile_e if spill_bwd_tile_e is not None
                       else _median_tile(sp_u, n_src_rows))
            mask = np.zeros(tot, np.float32)
            mask[slot] = 1.0
            sb = build_dst_block_layout(
                np.arange(tot, dtype=np.int64), e_src,
                np.zeros(tot, np.int64), mask, n_src_rows, tile_e=sb_tile,
                n_src_rows=tot, pad_tiles_to=spill_bwd_pad_tiles_to,
                edge_align=(16 if sb_tile % 16 == 0 else None),
                dstl_stream=sb_tile % 16 == 0).to("cpu")
            for k, v in sb.arrays.items():
                arrays["sb_" + k] = v.numpy()
            spill_bwd_meta = sb.meta
    return (n_wins, int(n_gt), spill_bwd_offsets, spill_bwd_meta,
            bwd_fwd_stream)


def window_layout_for_batch(batch, window: int = 512,
                            min_edges_per_tile: int = 32,
                            spill_tile_e: int = 128,
                            block_rows: int = BLOCK,
                            pack_counts: bool = False) -> DeviceWindowLayout:
    """The static-budget layout of a :class:`~ggnn_tpu_torch.graph.
    GraphBatch` (the reference function; host form): at most e_pad /
    min_edges dense tiles plus one dummy per block, and the legacy spill at
    its static tile budget, so every batch of one padding spec has the same
    shapes.  Block-major table rows where ``spec.n_pad % 128 == 0``, else
    src-major.  Forward only."""
    from ggnn_tpu_torch.ops.legacy import static_tile_budget
    spec = batch.spec
    t2 = 2 * spec.n_edge_types
    n_dst = -(-spec.n_pad // block_rows) * block_rows
    budget = spec.e_pad // min_edges_per_tile + n_dst // block_rows
    row_major = "block" if spec.n_pad % 128 == 0 else "src"
    return build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        n_dst, window=window, min_edges_per_tile=min_edges_per_tile,
        spill_tile_e=spill_tile_e, n_message_types=t2, row_major=row_major,
        n_src_rows=spec.n_pad, block_rows=block_rows,
        pad_tiles_to=budget, force_spill=True, pack_counts=pack_counts,
        spill_pad_tiles_to=static_tile_budget(spec.e_pad, n_dst,
                                              spill_tile_e))


# --- shared by the kernels' wrappers -----------------------------------------

def split_plan(per, k=None, empty_items=1):
    """The hub split on the device: each dst block's ``per`` [n_blocks]
    tiles cut into work items of at most ``k`` (by default
    ``csrc/common.cuh``'s kSplit, the per-tile kernels' cut of their
    ``tile_start.diff()``): ``item_first`` [n_blocks + 1] (block b's work
    items are item_first[b] .. item_first[b + 1], at least
    ``empty_items``: 1, or 0 where an empty block needs no item) and
    ``pbase`` [n_blocks] (the first workspace slot of a block with more
    than one item), both int32, and the 0-d totals (items, partial slots)
    for the caller to read with its other host checks."""
    K = _build.library().ggnn_tile_split() if k is None else k
    nit = (per.to(torch.int32).clamp_min(0) + K - 1) // K
    nit = nit.clamp_min(empty_items)
    item_first = torch.zeros(per.shape[0] + 1, dtype=torch.int32,
                             device=per.device)
    item_first[1:] = torch.cumsum(nit, 0, dtype=torch.int32)
    pcount = torch.where(nit > 1, nit, torch.zeros_like(nit))
    pbase = torch.cumsum(pcount, 0, dtype=torch.int32) - pcount
    return item_first, pbase, item_first[-1], pcount.sum()


def unpack_counts(c_stream, packed: bool):
    """The count matrix as int8 [rows, window]: an int4-packed stream's
    byte w holds column w (low nibble) and w + W/2 (high nibble)."""
    if not packed:
        return c_stream
    c = c_stream.to(torch.int32)
    return torch.cat([c & 15, (c >> 4) & 15], dim=1).to(torch.int8)


def _count_terms(C, tiles, chunk_rows):
    """Nonzero count entries of tiles ``tiles`` (indices into the first
    axis of C [n, rows, W]) in chunks of about :data:`_NONZERO_CHUNK`
    entries: yields (i, r, j, count), i indexing ``tiles``."""
    per = max(1, _NONZERO_CHUNK // max(chunk_rows, 1))
    for i0 in range(0, tiles.shape[0], per):
        sub = C[tiles[i0:i0 + per]]
        i, r, j = torch.nonzero(sub, as_tuple=True)
        yield i + i0, r, j, sub[i, r, j]


def window_counts_sum(rows_of, c_stream, block_of_tile, win_of_tile, c_off,
                      n_blocks, window, out_rows, packed, stride, D,
                      scales=None, init=None):
    """f64 Σ over every real tile's nonzero counts: count · table row
    (``rows_of(idx)`` → the rows as f64) into its block's output rows, times
    ``scales[win]`` where given, from ``init`` (f32) or zero →
    [n_blocks·out_rows, D] f64."""
    dev = c_stream.device
    Y = torch.zeros(n_blocks * out_rows, D, dtype=torch.float64, device=dev)
    if init is not None:
        Y += init.double()
    real = torch.nonzero(win_of_tile >= 0).flatten()
    c = real if c_off is None else c_off.long()[real]
    base = win_of_tile.long()[real] * stride
    blk = block_of_tile.long()[real] * out_rows
    C = unpack_counts(c_stream, packed).reshape(-1, out_rows, window)
    for i, r, j, cnt in _count_terms(C, c, out_rows * window):
        terms = rows_of(base[i] + j) * cnt.double()[:, None]
        if scales is not None:
            terms *= scales.double()[win_of_tile.long()[real][i]][:, None]
        Y.index_add_(0, blk[i] + r, terms)
    return Y


# --- the plan of #11's and #8's bf16 pipeline (csrc/window_mono_fused.cu) ---

# tiles a work item of csrc/window_mono_fused.cu holds at most (common.cuh's
# kSplit): no accumulator sums a whole hub row
MONO_SPLIT = 32
def group_mask(c_stream, window: int, dstl: bool, onehot_of=None):
    """Which 16-row k-groups of each 128-row stream entry add something →
    bool [entries, ⌈window/16⌉]: the dst-local stream [n, window] (an id
    of the group in [0, 128)), or the int8 count / one-hot matrix [n·128,
    window] (a nonzero byte in the entry's [128, 16] group).  One read of
    the stream on its device.  ``onehot_of``: the name of the scatter that
    takes the int8 matrix as a one-hot stream, whose columns hold at most
    one entry, a 1; it raises with that name otherwise (one copy to the
    host)."""
    ng = -(-window // 16)
    if dstl:
        return ((c_stream & -BLOCK) == 0).view(-1, ng, 16).any(2)
    if onehot_of is None:
        # a group is two 8-byte words of each of the entry's 128 rows
        lo, hi = torch.aminmax(
            c_stream.view(torch.int64).view(-1, BLOCK, window // 8), dim=1)
        return ((lo != 0) | (hi != 0)).view(-1, ng, 2).any(2)
    # entries of 0 or 1 sum over an entry's 128 rows in words of wb bytes
    # without a carry: each byte of a word's sum counts its column
    wb = math.gcd(window, 8)
    wdt = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}[wb]
    n_col = c_stream.view(wdt).view(-1, BLOCK, window // wb).sum(1, dtype=wdt)
    ones = int.from_bytes(b"\x01" * wb, "little")
    bad = [((n_col & ~ones) != 0).any()]
    if c_stream.numel():
        lo, hi = torch.aminmax(c_stream)
        bad.append((lo < 0) | (hi > 1))
    if any(host_ints(*bad)):
        raise ValueError(f"{onehot_of}: a column of the one-hot stream holds "
                         f"more than one entry or an entry other than 1: not "
                         f"a one-hot layout")
    return torch.nn.functional.pad(
        n_col != 0, (0, (16 * ng - window) // wb)).view(-1, ng, 16 // wb).any(2)


@dataclasses.dataclass
class MonoPlan:
    """The units and work items of csrc/window_mono_fused.cu (int32 on the
    layout's device): ``units`` [n_units, 2] {first table row of a 16-row
    group, the offset of its ids or its count rows' first bytes in the
    stream, in 16-byte vectors}; ``work`` [n_work, 4], the work items
    with a unit, in order, each {first unit, end unit, 128-row block,
    partial slot or −1 where it is its block's only item}; ``zero_blk``,
    the blocks without a unit (one item each, zeroed); ``item_first``
    [n_blocks·S + 1], ``pbase``, ``split`` (the blocks of several items)
    and the totals as :func:`split_plan`'s over the plan's 128-row blocks
    (S = out_rows / 128 of them a layout block)."""
    units: torch.Tensor
    work: torch.Tensor
    zero_blk: torch.Tensor
    item_first: torch.Tensor
    pbase: torch.Tensor
    split: torch.Tensor
    n_items: int
    n_part: int


def mono_plan(c_stream, tile_start, win_of_tile, c_off, n_blocks: int,
              window: int, stride: int, out_rows: int, dstl: bool,
              onehot_of=None) -> MonoPlan:
    """The plan of the bf16 pipeline of #11 (and #8, #9), made on the
    device: every tile t of block b (``tile_start``) with win[t] ≥ 0 and
    stream entry c in [0, n_c) (``c_off``, None: t); an output block of
    R = ``out_rows`` = 128·S rows is S blocks of 128 rows, slice s reading
    count rows [s·128, s·128 + 128) of each tile (entry c·S + s of the
    stream's 128-row entries); a (tile, slice)'s window groups that
    :func:`group_mask` marks (``onehot_of``: its check of a one-hot
    stream) make its units {win·stride + 16·g, the group's first byte in
    the stream / 16}; (tile, slice) pairs with no unit are dropped.  Each
    128-row block's pairs, in tile order, are cut by :func:`split_plan`
    into items of at most ``MONO_SPLIT`` pairs, as evenly as their count
    allows.  A few copies to the host (the real pairs and units, the
    totals, the busy items)."""
    dev = tile_start.device
    S = out_rows // BLOCK
    ng = window // 16
    n_c = (c_stream.shape[0] if dstl else c_stream.shape[0] // BLOCK)
    # a unit's group: its offset in the stream in 16-byte vectors
    vec_entry = window // 4 if dstl else BLOCK * window // 16
    if n_c * vec_entry >= 2 ** 31:
        raise ValueError(f"window_block_spmm_mono: a stream of {n_c} entries "
                         f"of {16 * vec_entry} bytes does not fit the plan's "
                         f"int32 units")
    gmask = group_mask(c_stream, window, dstl, onehot_of)
    n_t = win_of_tile.shape[0]
    t = torch.arange(n_t, dtype=tile_start.dtype, device=dev)
    w = win_of_tile.long()
    c = t.long() if c_off is None else c_off.long()
    n_e = n_c // S                      # the layout's stream entries
    # tile t's block (tiles outside tile_start's range belong to none)
    blk = torch.searchsorted(tile_start[1:], t, right=True)
    valid = ((w >= 0) & (c >= 0) & (c < n_e) & (t >= tile_start[0])
             & (t < tile_start[-1]))
    sl = torch.arange(S, device=dev)
    ce = c.clamp(0, max(n_e - 1, 0))[:, None] * S + sl      # [n_t, S]
    m = (gmask[ce] if n_e else torch.zeros(n_t, S, ng, dtype=torch.bool,
                                           device=dev))
    m &= valid[:, None, None]
    # the real (tile, slice) pairs, in block order, then tile order
    pid = torch.nonzero(m.any(2).flatten()).flatten()
    p_blk = (blk[:, None] * S + sl).flatten()[pid]
    if S > 1:
        order = torch.sort(p_blk, stable=True).indices
        pid, p_blk = pid[order], p_blk[order]
    p_e, p_m = ce.flatten()[pid], m.reshape(-1, ng)[pid]
    p_row = w[pid // S] * stride
    nb = n_blocks * S
    per = torch.zeros(nb, dtype=torch.long, device=dev).scatter_add_(
        0, p_blk, torch.ones_like(p_blk))
    item_first, pbase, n_items, n_part = split_plan(per, MONO_SPLIT)
    n_items, n_part = host_ints(n_items, n_part)
    ui, ug = torch.nonzero(p_m, as_tuple=True)
    units = torch.stack([p_row[ui] + 16 * ug,
                         p_e[ui] * vec_entry + (4 if dstl else 1) * ug], 1)
    pstart = torch.zeros(p_m.shape[0] + 1, dtype=torch.long, device=dev)
    pstart[1:] = torch.cumsum(p_m.sum(1), 0)
    nit = item_first.diff().long()
    item_blk = torch.repeat_interleave(torch.arange(nb, device=dev), nit,
                                       output_size=n_items)
    kk = torch.arange(n_items, device=dev) - item_first[item_blk].long()
    first_pair = torch.cumsum(per, 0) - per
    p0 = first_pair[item_blk] + kk * per[item_blk] // nit[item_blk]
    item_u = torch.cat([pstart[p0], pstart[-1:]])
    item_slot = torch.where(nit[item_blk] > 1, pbase[item_blk].long() + kk,
                            torch.full_like(kk, -1))
    busy = item_u[1:] > item_u[:-1]
    work = torch.stack([item_u[:-1], item_u[1:], item_blk, item_slot],
                       1)[busy]
    i32 = lambda x: x.to(torch.int32).contiguous()
    return MonoPlan(i32(units), i32(work), i32(item_blk[~busy]), item_first,
                    pbase, i32(torch.nonzero(nit > 1).flatten()), n_items,
                    n_part)


def launch_mono_fused(name, table, c_stream, plan: MonoPlan, window: int,
                      dstl: bool, n_out_blocks: int, out_dtype):
    """One launch of ``ggnn_mono_fused`` (``csrc/window_mono_fused.cu``)
    on ``plan`` → [n_out_blocks·128, 128] in ``out_dtype`` (f32 or bf16)."""
    dev = table.device
    out = torch.empty(n_out_blocks * BLOCK, KERNEL_WIDTH, dtype=out_dtype,
                      device=dev)
    ws = torch.empty(max(plan.n_part, 1), BLOCK, KERNEL_WIDTH,
                     dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_mono_fused, name, dev, int(dstl),
        _DTYPE_CODE[out_dtype], p(table), table.shape[0], p(c_stream), window,
        p(plan.units), p(plan.work), plan.work.shape[0], p(plan.zero_blk),
        plan.zero_blk.shape[0], p(plan.item_first), p(plan.pbase),
        p(plan.split), plan.split.shape[0], p(ws), p(out))
    return out


# --- #11 window_block_spmm_mono ----------------------------------------------

def _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, out_rows, packed,
                     win_stride, c_off, dstl):
    if dstl and packed:
        raise ValueError("dstl and packed are mutually exclusive")
    if out_rows <= 0:
        raise ValueError(f"{name}: out_rows={out_rows}")
    if dstl and out_rows != BLOCK:
        raise ValueError(f"{name}: the dst-local stream takes out_rows="
                         f"{BLOCK}, got {out_rows}")
    if packed and window % 2:
        raise ValueError(f"{name}: a packed stream needs an even window")
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
    cols = window // 2 if packed else window
    if c_stream.dim() != 2 or c_stream.shape[1] != cols \
            or c_stream.dtype != want:
        raise ValueError(f"{name}: the side stream must be {want} "
                         f"[rows, {'window/2' if packed else 'window'}="
                         f"{cols}], got {c_stream.dtype} "
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


def _mono_data_checks(name, n_table, c_stream, win_of_tile, window, stride,
                      c_off, dstl, out_rows=BLOCK, extra=()):
    """Refuse windows past the table (``n_table`` rows) and side-stream
    entries past the stream (one copy to the host, with ``extra`` 0-d
    tensors appended)."""
    n_tiles = win_of_tile.shape[0]
    n_c = c_stream.shape[0] if dstl else c_stream.shape[0] // out_rows
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
    if w_max * stride + window > n_table:
        raise ValueError(f"{name}: window {w_max} reaches row "
                         f"{w_max * stride + window} of a table of "
                         f"{n_table} rows: it was not gathered with "
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
    each real tile's C (the one-hot of its dstl row, or its int8 / int4
    counts) adds count·table row to its output row by ``index_add_`` in
    f64; one rounding to ``out_dtype`` at the end."""
    del tile_start
    D, dev = table.shape[-1], table.device
    stride = window if win_stride is None else win_stride
    rows_of = lambda idx: table.index_select(0, idx).double()
    if not dstl:
        Y = window_counts_sum(rows_of, c_stream, block_of_tile, win_of_tile,
                              c_off, n_blocks, window, out_rows, packed,
                              stride, D)
        return Y.to(torch.float32 if out_dtype is None else out_dtype)
    Y = torch.zeros(n_blocks * out_rows, D, dtype=torch.float64, device=dev)
    real = torch.nonzero(win_of_tile >= 0).flatten()
    c = real if c_off is None else c_off.long()[real]
    base = win_of_tile.long()[real] * stride
    blk = block_of_tile.long()[real] * out_rows
    rows = c_stream.long()[c]                               # [n, window]
    valid = rows >= 0
    src = (base[:, None] + torch.arange(window, device=dev))[valid]
    Y.index_add_(0, (blk[:, None] + rows)[valid], rows_of(src))
    return Y.to(torch.float32 if out_dtype is None else out_dtype)


def window_block_spmm_mono(table, c_stream, tile_start, block_of_tile,
                           win_of_tile, n_blocks: int, window: int,
                           out_rows: int = BLOCK, packed: bool = False,
                           win_stride: int | None = None, c_off=None,
                           out_dtype=None, dstl: bool = False):
    """out[b·R:(b+1)·R] = Σ_{tiles t of b, win ≥ 0} C_t ·
    table[win[t]·stride : win[t]·stride + window] with R = ``out_rows`` →
    [n_blocks·R, D] in ``out_dtype`` (default f32), summed in f32 and
    rounded once.

    ``table`` [rows, D] in the compute dtype, any D >= 1; ``c_stream``
    the int32 dst-local stream [rows, window] (``dstl=True``, R = 128), the
    int8 count matrix [n·R, window], or with ``packed`` its int4 pairs
    [n·R, window/2]; tile t reads entry ``c_off[t]`` (None: t);
    ``win_of_tile`` < 0 marks a dummy tile.  R: the window layouts'
    128-, 256- and 512-row dst blocks, or for the backward's Y = Cᵀ·ā the
    W-row table windows (any R > 0).  (The TPU kernel's
    grid split and DMA ring depth do not change the sums; the port has
    neither.)  A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/window_mono_fused.cu`` (a bf16 table at D = 128, the dst-local
    stream or int8 counts at R % 128 = 0, window % 16 = 0: the plan of
    :func:`mono_plan`, made once per layout), ``csrc/window_mono.cu`` (f32
    at D = 128, any other D; bf16 at D = 128 and window % 16 ≠ 0: its
    panel kernel), or at D = 128 with int4 counts, R > 128 (f32, or window
    % 16 ≠ 0), or R % 128 ≠ 0 the window step's sums of
    ``csrc/window_step.cu``,
    then one rounding to ``out_dtype``; or raises.  The data checks run
    once per layout (no copy to the host on a layout already seen)."""
    name = "window_block_spmm_mono"
    _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, out_rows, packed,
                     win_stride, c_off, dstl)
    stride = window if win_stride is None else win_stride
    if table.device.type == "cpu":
        _mono_data_checks(name, table.shape[0], c_stream, win_of_tile,
                          window, stride, c_off, dstl, out_rows)
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
    _check_cuda_args(name, named, D, any_width=True)
    if not dstl and out_rows % BLOCK and D != kernel_width(D):
        # output blocks of no multiple of 128 rows (the backward's Y over
        # windows of W % 128 ≠ 0): the window step's route, zero-padded
        return narrow_width(window_block_spmm_mono(
            pad_width(table, D), c_stream, tile_start, block_of_tile,
            win_of_tile, n_blocks, window, out_rows, packed, win_stride,
            c_off, out_dtype, dstl), D)
    args = (c_stream, tile_start, win_of_tile, c_off, n_blocks, window,
            stride, out_rows, dstl)
    if (table.dtype == torch.bfloat16 and D == KERNEL_WIDTH and not packed
            and out_rows % BLOCK == 0 and window % 16 == 0):
        # csrc/window_mono_fused.cu on the layout's plan
        plan = mono_plan_once(name, table.shape[0], *args)
        out = launch_mono_fused(name, table, c_stream, plan, window, dstl,
                                n_blocks * out_rows // BLOCK, out_dtype)
        window_block_spmm_mono.launches += 1
        return out
    if not dstl and (D == KERNEL_WIDTH and (packed or out_rows != BLOCK)
                     or out_rows % BLOCK):
        # the window layouts' int4 and tall count forms at D = 128 (f32,
        # or bf16 at window % 16 ≠ 0),
        # and blocks of no multiple of 128 rows at D = 128·P: the window
        # step's sums without the GRU (csrc/window_step.cu, P 128-column
        # panels)
        if stride != window:
            raise ValueError(f"{name}: int4 counts or out_rows={out_rows} "
                             f"take windows at stride {window}, got "
                             f"win_stride={stride}")
        out = _launch_step(name, _SRC_TABLE, False, table, c_stream,
                           tile_start, win_of_tile, c_off, n_blocks, window,
                           out_rows, packed)
        window_block_spmm_mono.launches += 1
        return out if out_dtype == torch.float32 else out.to(out_dtype)

    def split():
        _mono_checks(name, table.shape[0], *args)
        item_first, pbase, n_items, n_part = split_plan(tile_start.diff())
        return (item_first, pbase, *host_ints(n_items, n_part))
    item_first, pbase, n_items, n_part = cached_per_tensor(
        tile_start, _mono_key("split_plan", table.shape[0], *args), split)
    dev = table.device
    slices = out_rows // BLOCK
    ws = torch.empty(max(n_part * slices, 1), BLOCK, D, dtype=torch.float32,
                     device=dev)
    out = torch.empty(n_blocks * out_rows, D, dtype=out_dtype, device=dev)
    n_c = c_stream.shape[0] if dstl else c_stream.shape[0] // out_rows
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_mono, name, dev, _DTYPE_CODE[table.dtype],
        _DTYPE_CODE[out_dtype], int(dstl), int(packed), p(table),
        table.shape[0], D, p(c_stream), n_c, p(tile_start), p(win_of_tile),
        p(c_off), n_blocks, out_rows, window, stride, p(item_first),
        p(pbase), n_items, n_part, p(ws), p(out))
    window_block_spmm_mono.launches += 1
    return out


def _mono_key(what, n_table, c_stream, tile_start, win_of_tile, c_off,
              n_blocks, window, stride, out_rows, dstl):
    """The key of a layout's cached checks and plan besides its tile_start
    (``cached_per_tensor``): the table's height, the other arrays and the
    arguments."""
    del tile_start
    return (what, n_table, tuple(c_stream.shape), c_stream.dtype,
            c_stream.data_ptr(), win_of_tile.data_ptr(),
            None if c_off is None else c_off.data_ptr(), n_blocks, window,
            stride, out_rows, dstl)


def _mono_checks(name, n_table, c_stream, tile_start, win_of_tile, c_off,
                 n_blocks, window, stride, out_rows, dstl):
    """#11's data checks, in one copy to the host: the windows lie in the
    table, the stream entries in the stream, tile_start runs upward within
    the tiles."""
    del n_blocks
    n_tiles = win_of_tile.shape[0]
    ts0, ts1, c_min = _mono_data_checks(
        name, n_table, c_stream, win_of_tile, window, stride, c_off, dstl,
        out_rows, (tile_start[0], tile_start[-1], tile_start.diff().min()
                   if tile_start.shape[0] > 1 else 0))
    if ts0 < 0 or c_min < 0 or ts1 > n_tiles:
        raise ValueError(f"{name}: tile_start runs from {ts0} to {ts1} "
                         f"(least count {c_min}) over a stream of {n_tiles} "
                         f"tiles: layout and arguments disagree")


def tile_arange(tile_start, n_tiles: int):
    """int32 arange(n_tiles) on tile_start's device, made once per layout:
    the ``win_of_tile`` of a stream whose tile t reads window t (#8, #9)."""
    return cached_per_tensor(tile_start, ("tile_arange", n_tiles),
                             lambda: torch.arange(n_tiles, dtype=torch.int32,
                                                  device=tile_start.device))


def mono_plan_once(name, n_table, c_stream, tile_start, win_of_tile, c_off,
                   n_blocks, window, stride, out_rows, dstl, checks=None,
                   key=(), onehot=False):
    """The layout's :func:`mono_plan`, made once per layout (its arrays,
    the table's height and the arguments: ``cached_per_tensor`` on
    ``tile_start``; ``key``: what else ``checks`` reads) after the data
    checks (#11's, or ``checks()``), which raise there, as the plan's
    check of a one-hot stream (``onehot``, #8) does; later calls copy
    nothing to the host."""
    args = (c_stream, tile_start, win_of_tile, c_off, n_blocks, window,
            stride, out_rows, dstl)

    def make():
        if checks is None:
            _mono_checks(name, n_table, *args)
        else:
            checks()
        return mono_plan(*args, onehot_of=name if onehot else None)
    return cached_per_tensor(
        tile_start, (*_mono_key(name, n_table, *args), *key), make)


window_block_spmm_mono.launches = 0


# --- #20 window_block_spmm ---------------------------------------------------

# entries a work item of csrc/window_auto_gather.cu sums at most: a longer
# output row is cut into several items, whose partials a second kernel adds
AUTO_SPLIT = 128
_PACK_ROWS = 2 ** 24    # tables of fewer rows pack an entry into 4 bytes
_PLAN_BYTES = 1 << 30   # count bytes one pass of window_auto_plan decodes


@dataclasses.dataclass
class AutoPlan:
    """The plan of #20's gather-sum (``csrc/window_auto_gather.cu``), on
    the layout's device: ``ent`` every nonzero count byte of every real
    tile as an entry {table row win·W + j, count}, in order of output row
    (then tile, then j): int32 [nnz] holding row << 8 | count byte
    (``packed``, a table of fewer than ``_PACK_ROWS`` rows) or [nnz, 2]
    {row, count}; ``items`` int32 [n_items, 4], the work items {first entry, end
    entry, output row, partial slot or −1}, at least one an output row, in
    row order; ``item_first`` [rows + 1], ``pbase`` [rows] and ``split``
    (the rows of several items) as :func:`split_plan`'s over the rows."""
    ent: torch.Tensor
    items: torch.Tensor
    item_first: torch.Tensor
    pbase: torch.Tensor
    split: torch.Tensor
    n_part: int
    packed: bool


def _nonzero_bytes(x):
    """Flat indices (int64, ascending) and values of the nonzero bytes of
    the contiguous int8 tensor ``x`` (numel a multiple of 8): the nonzero
    8-byte words first, then their bytes."""
    words = torch.nonzero(x.view(torch.int64).view(-1)).flatten()
    b = x.view(-1, 8)[words].view(-1)
    k = torch.nonzero(b).flatten()
    return words[k // 8] * 8 + k % 8, b[k]


def window_auto_plan(c_stream, block_of_tile, win_of_tile, c_off,
                     n_blocks: int, window: int, n_table: int) -> AutoPlan:
    """The plan of #20's gather-sum, made on the stream's device: every
    tile t with win[t] >= 0 and count entry c (``c_off[t]``, None: t) in
    the stream adds its nonzero count bytes C_c[r][j] as entries {table row
    win[t]·W + j, C_c[r][j]} to output row block_of_tile[t]·128 + r; each
    row's entries (in tile order, then j) are cut by :func:`split_plan`
    into items of at most ``AUTO_SPLIT``, as evenly as their count allows,
    a row without entries one empty item; an entry takes 4 bytes where the
    table has fewer than ``_PACK_ROWS`` rows.  The stream is read in place
    where no two real tiles read one entry (else each pass gathers its
    tiles' entries), in passes of about ``_PLAN_BYTES``, then one stable
    sort by output row; a few copies to the host (each pass's nonzeros,
    the totals)."""
    dev = c_stream.device
    tile_bytes = BLOCK * window
    n_c = c_stream.shape[0] // BLOCK
    n_t = win_of_tile.shape[0]
    n_rows = n_blocks * BLOCK
    packed = n_table < _PACK_ROWS
    c = (torch.arange(n_t, device=dev) if c_off is None else c_off.long())
    real = torch.nonzero((win_of_tile >= 0) & (c >= 0) & (c < n_c)).flatten()
    C = c_stream.view(n_c, tile_bytes)
    base = win_of_tile.long()[real] * window
    blk = block_of_tile.long()[real] * BLOCK
    c = c[real]
    # each stream entry's real tile: where no two real tiles read one
    # entry, the stream is read in place (an entry no real tile reads gets
    # the key n_rows, past every row), else each pass gathers its tiles'
    tile_of = torch.full((n_c,), -1, dtype=torch.long, device=dev)
    idx_real = torch.arange(real.shape[0], device=dev)
    tile_of[c] = idx_real
    in_place = host_ints((tile_of[c] == idx_real).all())[0]
    n_src = n_c if in_place else real.shape[0]
    keys = [torch.zeros(0, dtype=torch.int32, device=dev)]
    ents = [torch.zeros((0,) if packed else (0, 2), dtype=torch.int32,
                        device=dev)]
    per = max(1, _PLAN_BYTES // tile_bytes)
    for i0 in range(0, n_src, per):
        idx, v = _nonzero_bytes(C[i0:i0 + per] if in_place
                                else C.index_select(0, c[i0:i0 + per]))
        i, rem = i0 + idx // tile_bytes, idx % tile_bytes
        if in_place:
            i = tile_of[i]
            key = torch.where(i >= 0, blk[i.clamp_min(0)] + rem // window,
                              n_rows)
            i = i.clamp_min(0)
        else:
            key = blk[i] + rem // window
        keys.append(key.to(torch.int32))
        row = base[i] + rem % window
        if packed:   # row << 8 | count byte, as an int32's bits
            e = (row << 8) | (v.long() & 0xFF)
            ents.append(torch.where(e >= 2 ** 31, e - 2 ** 32,
                                    e).to(torch.int32))
        else:
            ents.append(torch.stack([row, v.long()], 1).to(torch.int32))
    key, order = torch.sort(torch.cat(keys), stable=True)
    rowptr = torch.searchsorted(
        key, torch.arange(n_rows + 1, dtype=torch.int32, device=dev))
    per_row = rowptr.diff()
    item_first, pbase, n_items, n_part = split_plan(per_row, AUTO_SPLIT)
    n_items, n_part, n_ent = host_ints(n_items, n_part, rowptr[-1])
    ent = torch.cat(ents)[order[:n_ent]]
    nit = item_first.diff().long()
    item_row = torch.repeat_interleave(torch.arange(n_rows, device=dev), nit,
                                       output_size=n_items)
    kk = torch.arange(n_items, device=dev) - item_first[item_row].long()
    n_r, nit_r = per_row[item_row], nit[item_row]
    first = rowptr[item_row] + kk * n_r // nit_r
    end = rowptr[item_row] + (kk + 1) * n_r // nit_r
    slot = torch.where(nit_r > 1, pbase[item_row].long() + kk,
                       torch.full_like(kk, -1))
    i32 = lambda x: x.to(torch.int32).contiguous()
    return AutoPlan(ent.contiguous(),
                    i32(torch.stack([first, end, item_row, slot], 1)),
                    item_first, pbase, i32(torch.nonzero(nit > 1).flatten()),
                    n_part, packed)


def _auto_checks(name, n_table, c_stream, tile_start, block_of_tile,
                 win_of_tile, c_off, window):
    """#20's data checks: tile_start runs from 0 upward over every tile and
    agrees with block_of_tile, the windows lie in the table and the
    stream entries in the stream (two copies to the host)."""
    _scatter_data_checks(name, tile_start, win_of_tile.shape[0],
                         block_of_tile=block_of_tile)
    _mono_data_checks(name, n_table, c_stream, win_of_tile, window, window,
                      c_off, False)


def window_auto_plan_once(name, n_table, c_stream, tile_start,
                          block_of_tile, win_of_tile, c_off, n_blocks,
                          window):
    """The layout's :func:`window_auto_plan`, made once per layout (its arrays, the table's height and the arguments:
    ``cached_per_tensor`` on ``tile_start``) after #20's data checks,
    which raise there (a raise is not cached); later calls copy nothing to
    the host."""
    def make():
        _auto_checks(name, n_table, c_stream, tile_start, block_of_tile,
                     win_of_tile, c_off, window)
        return window_auto_plan(c_stream, block_of_tile, win_of_tile, c_off,
                                n_blocks, window, n_table)
    key = (*_mono_key(name, n_table, c_stream, tile_start, win_of_tile,
                      c_off, n_blocks, window, window, BLOCK, False),
           block_of_tile.data_ptr())
    return cached_per_tensor(tile_start, key, make)


def launch_window_auto(name, table, plan: AutoPlan):
    """One launch of ``ggnn_window_auto_gather``
    (``csrc/window_auto_gather.cu``) on ``plan`` → [rows, D] f32."""
    dev, D = table.device, table.shape[-1]
    out = torch.empty(plan.item_first.shape[0] - 1, D, dtype=torch.float32,
                      device=dev)
    ws = torch.empty(max(plan.n_part, 1), D, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_auto_gather, name, dev,
        _DTYPE_CODE[table.dtype], int(plan.packed), p(table), D, p(plan.ent),
        p(plan.items), plan.items.shape[0], p(plan.split),
        plan.split.shape[0], p(plan.item_first), p(plan.pbase), p(ws),
        p(out))
    return out


def window_block_spmm_reference(table, c_stream, tile_start, block_of_tile,
                                win_of_tile, n_blocks: int, window: int,
                                c_off=None):
    """Plain version of :func:`window_block_spmm`: #11's plain version at
    128-row blocks (f64 sums, rounded once to f32)."""
    return window_block_spmm_mono_reference(
        table, c_stream, tile_start, block_of_tile, win_of_tile, n_blocks,
        window, out_rows=BLOCK, c_off=c_off)


def window_block_spmm(table, c_stream, tile_start, block_of_tile,
                      win_of_tile, n_blocks: int, window: int, c_off=None):
    """Kernel #20, the reference's auto-pipelined window SpMM:
    out[b·128:(b+1)·128] = Σ_{tiles t of b, win[t] ≥ 0} C_t ·
    table[win[t]·W : (win[t]+1)·W] → [n_blocks·128, D] f32, summed in f32.

    ``table`` [R, D] in the compute dtype (any D), R a multiple of
    ``window`` (W; the reference raises otherwise, so does the port);
    ``c_stream`` the unpacked int8 counts [n·128, W] (any int8 value
    counts, as the TPU kernel casts them), tile t reading entry
    ``c_off[t]`` (None: t); ``tile_start`` int32 [n_blocks + 1] and
    ``block_of_tile`` must agree; ``win_of_tile`` < 0 marks a dummy tile,
    which adds nothing.  The TPU kernel zeroes a block at its first tile
    (``i == tile_start[b]``) and so never writes a block without tiles; the
    port writes zeros there.  A CPU tensor takes the plain version; a CUDA
    tensor launches ``csrc/window_auto_gather.cu`` (the nonzero counts
    alone, gathered and summed per output row on the layout's plan,
    :func:`window_auto_plan`, made with the data checks once per layout:
    a launch on a layout already seen copies nothing to the host) or
    raises."""
    name = "window_block_spmm"
    _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, BLOCK, False, None,
                     c_off, False)
    if table.device.type == "cpu":
        _auto_checks(name, table.shape[0], c_stream, tile_start,
                     block_of_tile, win_of_tile, c_off, window)
        return window_block_spmm_reference(table, c_stream, tile_start,
                                           block_of_tile, win_of_tile,
                                           n_blocks, window, c_off)
    if table.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: table {table.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    named = [("table", table), ("c_stream", c_stream),
             ("tile_start", tile_start), ("block_of_tile", block_of_tile),
             ("win_of_tile", win_of_tile)]
    if c_off is not None:
        named.append(("c_off", c_off))
    _check_cuda_args(name, named, table.shape[-1], any_width=True)
    plan = window_auto_plan_once(name, table.shape[0], c_stream, tile_start,
                                 block_of_tile, win_of_tile, c_off, n_blocks,
                                 window)
    out = launch_window_auto(name, table, plan)
    window_block_spmm.launches += 1
    return out


window_block_spmm.launches = 0


# --- #12 window_block_spmm_ondemand and #13 window_step_gru ------------------

_SRC_TABLE, _SRC_Q8, _SRC_ONDEMAND = 0, 1, 2


def _check_step_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, c_off, n_blocks, window, out_rows, packed,
                     q8, ondemand, msg_w, msg_b):
    if q8 and packed or ondemand and (q8 or packed):
        raise ValueError("q8 / packed / ondemand are mutually exclusive")
    if table.dim() != 2:
        raise ValueError(f"{name}: table must be [R, D], got "
                         f"{tuple(table.shape)}")
    R, D = table.shape
    if ondemand:
        if window % 128:
            raise ValueError("ondemand needs window % 128 == 0")
        t2 = msg_w.shape[0]
        if (t2 * 128) % window or R % 128:
            raise ValueError("ondemand needs (T2*128) % window == 0 and "
                             "h rows % 128 == 0")
        if tuple(msg_w.shape) != (t2, D, D) or tuple(msg_b.shape) != (t2, D):
            raise ValueError(f"{name}: msg_w {tuple(msg_w.shape)} / msg_b "
                             f"{tuple(msg_b.shape)} are not [T2, D, D] / "
                             f"[T2, D] with h's D = {D}")
    elif R % window:
        raise ValueError("table rows must be a multiple of window")
    # (an on-demand h source's rows need not be whole windows: its windows
    # are 128-row h blocks, hence the stride 128 for this check)
    _check_mono_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, n_blocks, window, out_rows, packed,
                     None if not ondemand else 128, c_off, False)


def window_sums_reference(table, c_stream, block_of_tile, win_of_tile, c_off,
                          n_blocks, window, out_rows, packed, scales=None,
                          msg_w=None, msg_b=None, init=None):
    """The f64 window sums of #12 and #13, a before the GRU (from ``init``
    where given): the table's rows (int8 values times ``scales[win]`` for
    q8), or with ``msg_w`` the on-demand windows of the h source
    ``table``."""
    if msg_w is not None:
        # the windows' rows: a block-major table in the h source's dtype
        table = node_table_block_major_reference(table,
                                                 msg_w.to(table.dtype), msg_b)
    rows_of = lambda idx: table.index_select(0, idx).double()
    return window_counts_sum(rows_of, c_stream, block_of_tile, win_of_tile,
                             c_off, n_blocks, window, out_rows, packed,
                             window, table.shape[-1], scales=scales,
                             init=init)


def window_block_spmm_ondemand_reference(h, msg_w, msg_b, c_stream,
                                         tile_start, block_of_tile,
                                         win_of_tile, c_off, n_blocks: int,
                                         window: int, out_rows: int = BLOCK):
    """Plain version of :func:`window_block_spmm_ondemand`: the windows'
    rows, h·W_t + b_t rounded to h's dtype (the block-major table of
    :func:`~ggnn_tpu_torch.ops.table.node_table_block_major_reference`),
    then the count products summed in f64 and rounded once to f32."""
    del tile_start
    return window_sums_reference(h, c_stream, block_of_tile, win_of_tile,
                                 c_off, n_blocks, window, out_rows, False,
                                 msg_w=msg_w, msg_b=msg_b).float()


def _launch_step(name, src_mode, fused, table, c_stream, tile_start,
                 win_of_tile, c_off, n_blocks, window, out_rows, packed,
                 scales=None, wbank=None, bbank=None, init=None, hstate=None,
                 wa=None, b3=None, uzr=None, uh=None, res=None):
    """Launch ``ggnn_window_step`` of ``csrc/window_step.cu`` after the
    device checks; returns the [n_blocks·out_rows, D] f32 output (the sums
    take D = 128·P in P 128-column panels, the fused step D = 128)."""
    D = table.shape[-1]
    cdt = table.dtype if src_mode != _SRC_Q8 else wa.dtype
    if cdt not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {cdt} not in {list(_DTYPE_CODE)}")
    if src_mode == _SRC_Q8 and table.dtype != torch.int8:
        raise ValueError(f"{name}: a q8 table is int8, got {table.dtype}")
    named = [("table", table), ("c_stream", c_stream),
             ("tile_start", tile_start), ("win_of_tile", win_of_tile)]
    for arg, t in (("c_off", c_off), ("scales", scales), ("msg_w", wbank),
                   ("msg_b", bbank), ("init", init), ("h", hstate),
                   ("wa", wa), ("b3", b3), ("uzr", uzr), ("uh", uh),
                   ("res", res)):
        if t is not None:
            named.append((arg, t))
    _check_cuda_args(name, named, D, wide=not fused)
    n_rows = n_blocks * out_rows
    for arg, t in (("init", init), ("h", hstate)):
        if t is not None and (tuple(t.shape) != (n_rows, D)
                              or t.dtype != torch.float32):
            raise ValueError(f"{name}: {arg} must be f32 [n_blocks·out_rows, "
                             f"D] = [{n_rows}, {D}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for arg, t, shape in (("wa", wa, (D, 3 * D)), ("uzr", uzr, (D, 2 * D)),
                          ("uh", uh, (D, D))):
        if t is not None and (tuple(t.shape) != shape or t.dtype != cdt):
            raise ValueError(f"{name}: {arg} must be {cdt} {list(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    n_table = table.shape[0]
    if src_mode == _SRC_ONDEMAND:
        # windows of the block-major row space of the h source
        n_table = n_table * wbank.shape[0]
    if scales is not None and scales.shape[0] * window != n_table:
        raise ValueError(f"{name}: {scales.shape[0]} scales for a table of "
                         f"{n_table} rows in windows of {window}: the table "
                         f"and its scales do not belong together")
    # the data checks once per layout and table height
    cached_per_tensor(tile_start, _mono_key(
        "checks " + name, n_table, c_stream, tile_start, win_of_tile, c_off,
        n_blocks, window, window, out_rows, False), lambda: _mono_data_checks(
            name, n_table, c_stream, win_of_tile, window, window, c_off,
            False, out_rows) or True)
    out = torch.empty(n_rows, D, dtype=torch.float32, device=table.device)
    scratch = None
    if (fused and src_mode == _SRC_ONDEMAND and cdt == torch.bfloat16
            and out_rows in (128, 256, 512)):
        # the bf16 fused on-demand kernel's window scratch: two slots of
        # ``window`` rows per dst block, each window built once there
        scratch = torch.empty(n_blocks, 2 * window, D, dtype=cdt,
                              device=table.device)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_step, name, table.device, src_mode,
        _DTYPE_CODE[cdt], int(fused), int(packed), D, p(table), table.shape[0],
        p(c_stream), c_stream.shape[0] // out_rows, p(tile_start),
        p(win_of_tile), p(c_off), n_blocks, out_rows, window, p(scales),
        p(wbank), p(bbank), 0 if wbank is None else wbank.shape[0], p(init),
        p(hstate), p(wa), p(b3), p(uzr), p(uh), p(out), p(res), p(scratch))
    return out


# #12's work items: at most this many real tiles of a dst block per CTA (or
# cluster) of csrc/window_ondemand_fused.cu (scripts/torch_scalefree_
# variants.py times 8, 16, 32 and no split)
ONDEMAND_SPLIT = 32


def ondemand_items(tile_start, win_of_tile, c_off, n_c: int, n_blocks: int):
    """#12's plan (``csrc/window_ondemand_fused.cu``): the real tiles (win
    ≥ 0, stream entry in [0, n_c)) in list order, ``rt`` int32, block b's
    at rt[rt_start[b] : rt_start[b + 1]]; each block's cut by
    :func:`split_plan` into work items of at most :data:`ONDEMAND_SPLIT`
    of them (item_first, pbase); ``split``, the blocks of several items.
    Returns (item_first, rt, rt_start, pbase, split) int32 and the item
    and slot counts."""
    dev = tile_start.device
    (t_end,) = host_ints(tile_start[-1])
    idx = torch.arange(t_end, device=dev)
    c = idx if c_off is None else c_off[:t_end].long()
    real = (win_of_tile[:t_end] >= 0) & (c >= 0) & (c < n_c)
    rt = torch.nonzero(real).flatten()
    blk = torch.repeat_interleave(
        torch.arange(n_blocks, device=dev),
        (tile_start[1:] - tile_start[:-1]).long(), output_size=t_end)
    per = torch.bincount(blk[rt], minlength=n_blocks)
    item_first, pbase, n_items, n_part = split_plan(per, ONDEMAND_SPLIT)
    rt_start = torch.zeros(n_blocks + 1, dtype=torch.int32, device=dev)
    rt_start[1:] = torch.cumsum(per, 0)
    split = torch.nonzero(item_first.diff() > 1).flatten()
    n_items, n_part = host_ints(n_items, n_part)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return (item_first, i32(rt), rt_start, pbase, i32(split), n_items,
            n_part)


def window_block_spmm_ondemand(h, msg_w, msg_b, c_stream, tile_start,
                               block_of_tile, win_of_tile, c_off,
                               n_blocks: int, window: int,
                               out_rows: int = BLOCK):
    """#11 with the table windows built on the chip: window w is rows
    [j·128, (j+1)·128) = h[(w // wpb)·128 : +128]·W_{tbase+j} + b_{tbase+j}
    rounded to h's dtype (j < W/128, tbase = (w % wpb)·W/128, wpb =
    T2·128/W), the windows of a block-major table that never exists →
    [n_blocks·out_rows, D] f32.

    ``h`` [N, D] (N % 128 == 0) in the compute dtype, ``msg_w`` [T2, D, D]
    (cast to h's dtype), ``msg_b`` [T2, D] (added in f32); the counts int8
    [n·out_rows, W].  A CPU tensor takes the plain version; a CUDA tensor
    launches ``csrc/window_ondemand_fused.cu`` (bf16, D = 128, 128-, 256-
    or 512-row blocks: each block's real tiles cut into work items,
    :func:`ondemand_items`) or ``csrc/window_ondemand.cu`` (f32; D =
    128·P in P column panels; other D zero-padded,
    :func:`~ggnn_tpu_torch.ops.gru.pad_width`), or raises."""
    name = "window_block_spmm_ondemand"
    N, D = h.shape
    T2 = msg_w.shape[0]
    if window % 128 or (T2 * 128) % window:
        raise ValueError("on-demand windows need W % 128 == 0 and "
                         "(T2*128) % W == 0")
    if N % 128:
        raise ValueError("on-demand windows need N % 128 == 0")
    _check_step_args(name, h, c_stream, tile_start, block_of_tile,
                     win_of_tile, c_off, n_blocks, window, out_rows, False,
                     False, True, msg_w, msg_b)
    if h.device.type == "cpu":
        _mono_data_checks(name, N * T2, c_stream, win_of_tile, window,
                          window, c_off, False, out_rows)
        return window_block_spmm_ondemand_reference(
            h, msg_w, msg_b, c_stream, tile_start, block_of_tile,
            win_of_tile, c_off, n_blocks, window, out_rows)
    if D != kernel_width(D):
        return narrow_width(window_block_spmm_ondemand(
            pad_width(h, D), pad_width(msg_w, D, rows=True),
            pad_width(msg_b, D), c_stream, tile_start, block_of_tile,
            win_of_tile, c_off, n_blocks, window, out_rows), D)
    wbank = msg_w.to(h.dtype).contiguous()
    bbank = msg_b.float().contiguous()
    if h.dtype == torch.bfloat16 and D == 128 and out_rows in (128, 256,
                                                               512):
        out = _launch_ondemand_fused(name, h, c_stream, tile_start,
                                     win_of_tile, c_off, n_blocks, window,
                                     out_rows, wbank, bbank)
    else:
        out = _launch_step(name, _SRC_ONDEMAND, False, h, c_stream,
                           tile_start, win_of_tile, c_off, n_blocks, window,
                           out_rows, False, wbank=wbank, bbank=bbank)
    window_block_spmm_ondemand.launches += 1
    return out


def _launch_ondemand_fused(name, h, c_stream, tile_start, win_of_tile, c_off,
                           n_blocks, window, out_rows, wbank, bbank):
    """#12 in bf16 at D = 128 (``csrc/window_ondemand_fused.cu``): the
    plan of :func:`ondemand_items`, made once per layout, the partial
    slots and the items' window scratch; returns [n_blocks·out_rows, 128]
    f32."""
    D, T2 = h.shape[1], wbank.shape[0]
    named = [("h", h), ("c_stream", c_stream), ("tile_start", tile_start),
             ("win_of_tile", win_of_tile), ("msg_w", wbank),
             ("msg_b", bbank)]
    if c_off is not None:
        named.append(("c_off", c_off))
    _check_cuda_args(name, named, D)
    n_c = c_stream.shape[0] // out_rows

    def plan():
        # the layout's checks against h, then the work items: once per
        # layout and h height (no host sync on later calls)
        _mono_data_checks(name, h.shape[0] * T2, c_stream, win_of_tile,
                          window, window, c_off, False, out_rows)
        return ondemand_items(tile_start, win_of_tile, c_off, n_c, n_blocks)
    item_first, rt, rt_start, pbase, split, n_items, n_part = \
        cached_per_tensor(
            tile_start, ("ondemand_items", h.shape[0], T2, n_blocks, n_c,
                         window, ONDEMAND_SPLIT, win_of_tile.data_ptr(),
                         None if c_off is None else c_off.data_ptr()), plan)
    dev = h.device
    out = torch.empty(n_blocks * out_rows, D, dtype=torch.float32,
                      device=dev)
    ws = torch.empty(max(n_part, 1), out_rows, D, dtype=torch.float32,
                     device=dev)
    scratch = torch.empty(n_items, 2 * window, D, dtype=h.dtype, device=dev)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_ondemand_fused, name, dev, p(h),
        h.shape[0], p(c_stream), n_c, p(tile_start), p(win_of_tile),
        p(c_off), n_blocks, out_rows, window, p(wbank), p(bbank), T2,
        p(item_first), p(rt), p(rt_start), p(pbase), n_items, ONDEMAND_SPLIT,
        p(split), split.shape[0], p(ws), p(scratch), p(out))
    return out


window_block_spmm_ondemand.launches = 0


def window_step_gru_reference(table, c_stream, tile_start, block_of_tile,
                              win_of_tile, init, h, wa, b3, uzr, uh,
                              n_blocks: int, window: int,
                              out_rows: int = BLOCK, packed: bool = False,
                              has_init: bool = True, emit_res: bool = False,
                              scales=None, c_off=None, msg_w=None,
                              msg_b=None):
    """Plain version of :func:`window_step_gru`: a = init + Σ tiles in f64,
    rounded once to f32; then the GRU cell with its matmul inputs (a, h,
    r⊙h) rounded to the weights' dtype, f32 products and gates
    (:func:`~ggnn_tpu_torch.ops.gru.gru_cell_fwd_reference`); with
    ``emit_res`` also (a | z | r | h̃) in the weights' dtype."""
    del tile_start
    a = window_sums_reference(
        table, c_stream, block_of_tile, win_of_tile, c_off, n_blocks, window,
        out_rows, packed, scales=scales, msg_w=msg_w, msg_b=msg_b,
        init=init if has_init else None).float()
    out, z, r, htil = gru_cell_fwd_reference(h, a, wa, b3, uzr, uh,
                                             mdt=wa.dtype)
    if not emit_res:
        return out
    return out, torch.cat([a.to(wa.dtype), z, r, htil], dim=1)


def window_step_gru(table, c_stream, tile_start, block_of_tile, win_of_tile,
                    init, h, wa, b3, uzr, uh, n_blocks: int, window: int,
                    out_rows: int = BLOCK, packed: bool = False,
                    has_init: bool = True, emit_res: bool = False,
                    scales=None, c_off=None, msg_w=None, msg_b=None):
    """One fused window step → h' [n_blocks·out_rows, D] f32: each dst
    block's aggregation a, from ``init`` (the spill's partial, f32) when
    ``has_init`` else zero, plus every real tile's C·window, then the GRU
    epilogue on a with the reference's rounding points (a, h and r⊙h
    rounded to the weights' dtype for the gate products; h kept in f32).

    The table source: ``table`` [R, D] in the compute dtype (the counts
    int8 or, with ``packed``, int4 pairs); with ``scales`` [n_wins] f32 the
    int8 values-only table of :func:`~ggnn_tpu_torch.ops.table.
    node_table_block_major_q8` (an exact int8 product times the window's
    scale); with ``msg_w``/``msg_b`` the h source of on-demand windows (as
    :func:`window_block_spmm_ondemand`).  ``h`` f32 [n_blocks·out_rows, D];
    ``wa`` [D, 3D], ``uzr`` [D, 2D], ``uh`` [D, D] in the compute dtype,
    ``b3`` [1, 3D] f32.  ``emit_res`` (the training residuals; table and
    on-demand sources) returns ``(h', resid)``, resid [n_blocks·out_rows,
    4D] = (a | z | r | h̃) in the compute dtype, each rounded from the
    epilogue's f32 values.  A CPU tensor takes the plain version (any D);
    a CUDA tensor launches at D = 128 ``csrc/window_step_fused_*.cu`` (bf16,
    int8 counts, W % 128 == 0; on-demand windows with 128-, 256- or
    512-row blocks, a block's slices one cluster building each window once
    into a scratch of two windows per block) or ``csrc/window_step.cu``
    (``_res.cu``, ``_ondemand_res.cu`` with ``emit_res``: f32, int4
    counts, other W), at D = 128·P its sums in P 128-column panels and then
    the wide GRU cell kernel, at other D through
    :func:`~ggnn_tpu_torch.ops.gru.pad_width`, or raises."""
    name = "window_step_gru"
    q8 = scales is not None
    ondemand = msg_w is not None
    if emit_res and q8:
        raise ValueError("emit_res (training) and q8 (serving quant) are "
                         "mutually exclusive")
    _check_step_args(name, table, c_stream, tile_start, block_of_tile,
                     win_of_tile, c_off, n_blocks, window, out_rows, packed,
                     q8, ondemand, msg_w, msg_b)
    if table.device.type == "cpu":
        n_table = table.shape[0] * (msg_w.shape[0] if ondemand else 1)
        _mono_data_checks(name, n_table, c_stream, win_of_tile, window,
                          window, c_off, False, out_rows)
        return window_step_gru_reference(
            table, c_stream, tile_start, block_of_tile, win_of_tile, init, h,
            wa, b3, uzr, uh, n_blocks, window, out_rows, packed, has_init,
            emit_res, scales, c_off, msg_w, msg_b)
    D = table.shape[-1]
    if D != kernel_width(D):
        P = lambda x, **kw: pad_width(x, D, **kw)
        res = window_step_gru(
            P(table), c_stream, tile_start, block_of_tile, win_of_tile,
            P(init) if has_init else init, P(h), P(wa, rows=True, groups=3),
            P(b3, groups=3), P(uzr, rows=True, groups=2), P(uh, rows=True),
            n_blocks, window, out_rows, packed, has_init, emit_res, scales,
            c_off, P(msg_w, rows=True) if ondemand else None,
            P(msg_b) if ondemand else None)
        if not emit_res:
            return narrow_width(res, D)
        return narrow_width(res[0], D), narrow_width(res[1], D, groups=4)
    src_mode = _SRC_Q8 if q8 else _SRC_ONDEMAND if ondemand else _SRC_TABLE
    if D > KERNEL_WIDTH:
        # a = init + the window sums (the step's sums without its epilogue,
        # in 128-column panels), then the GRU cell kernel at this width
        # (csrc/gru_cell_wide.cu): the same function and rounding points
        a = _launch_step(
            name, src_mode, False, table, c_stream, tile_start, win_of_tile,
            c_off, n_blocks, window, out_rows, packed,
            scales=scales.float().contiguous() if q8 else None,
            wbank=msg_w.to(table.dtype).contiguous() if ondemand else None,
            bbank=msg_b.float().contiguous() if ondemand else None,
            init=init if has_init else None)
        out, z, r, ht = gru_cell_fwd(h, a, wa, b3.reshape(-1), uzr, uh,
                                     mdt=wa.dtype)
        if emit_res:
            window_step_gru.res_launches += 1
            return out, torch.cat([a.to(wa.dtype), z, r, ht], dim=1)
        window_step_gru.launches += 1
        return out
    resid = None
    if emit_res:
        cdt = table.dtype
        resid = torch.empty(n_blocks * out_rows, 4 * D, dtype=cdt,
                            device=table.device)
    out = _launch_step(
        name, src_mode, True, table, c_stream, tile_start, win_of_tile,
        c_off, n_blocks, window, out_rows, packed,
        scales=scales.float().contiguous() if q8 else None,
        wbank=msg_w.to(table.dtype).contiguous() if ondemand else None,
        bbank=msg_b.float().contiguous() if ondemand else None,
        init=init if has_init else None, hstate=h, wa=wa,
        b3=b3.reshape(-1).float().contiguous(), uzr=uzr, uh=uh, res=resid)
    if emit_res:
        window_step_gru.res_launches += 1
        return out, resid
    window_step_gru.launches += 1
    return out


window_step_gru.launches = 0
window_step_gru.res_launches = 0      # the emit_res form's launches


# --- the backward: quantize_grad_pow2 and #14 window_bwd_fused ---------------

def quantize_grad_pow2(da_pad, block_rows: int):
    """The aggregation's cotangent in int8, one power-of-2 scale per
    ``block_rows``-row ā block (the reference function; plain torch, no
    kernel in either package): e = ceil(log2(max|ā_block| / 127)) clipped
    to [−126, 126], q = round(ā·2^−e) (half to even) clipped to ±127.
    Returns (q int8 [R, D], scales f32 [R / block_rows])."""
    R, D = da_pad.shape
    b = da_pad.float().reshape(R // block_rows, block_rows * D)
    m = b.abs().amax(dim=1)
    e = torch.ceil(torch.log2(m.clamp_min(1e-30) / 127.0)).clamp(-126.0,
                                                                 126.0)
    q = torch.round(b * torch.exp2(-e)[:, None]).clamp(-127, 127)
    return q.to(torch.int8).reshape(R, D), torch.exp2(e)


def bwd_walk(gt_start, gt_win, gt_c_off, n_gt: int, n_dst: int, n_c: int,
             wpb: int, group: int, n_groups: int):
    """#14's walk (``csrc/window_bwd_fused.cu``): the real backward tiles
    (dst block in [0, n_dst), stream tile in [0, n_c)) in the order each
    group of ``group`` source blocks takes them, window j of a block outer,
    block inner, a window's tiles in list order, as int32 rows (dst block,
    stream tile, window, 0) [n_gt, 4] (the other tiles after them); and
    each group's first row, int32 [n_groups + 1].  Window w = b·wpb + j
    holds source block b's j-th window (gt_start [n_wins + 1]); n_gt =
    gt_start[-1], the tiles the windows hold."""
    dev = gt_win.device
    gt_win, gt_c_off = gt_win[:n_gt], gt_c_off[:n_gt]
    w = torch.repeat_interleave(
        torch.arange(gt_start.shape[0] - 1, device=dev),
        (gt_start[1:] - gt_start[:-1]).long(), output_size=n_gt)
    c = gt_c_off.long()
    real = (gt_win >= 0) & (gt_win < n_dst) & (c >= 0) & (c < n_c)
    b, j = w // wpb, w % wpb
    g = b // group
    tt = torch.arange(n_gt, device=dev)
    # the real tiles first, in walk order (no host sync: rows past a
    # group's count are never read)
    key = torch.where(real, ((g * wpb + j) * group + b - g * group) * n_gt
                      + tt, n_groups * wpb * group * n_gt + tt)
    order = torch.argsort(key)
    walk = torch.stack([gt_win.long(), c, w, torch.zeros_like(w)],
                       dim=1)[order].to(torch.int32)
    goff = torch.zeros(n_groups + 1, dtype=torch.long, device=dev)
    goff[1:] = torch.cumsum(torch.zeros(n_groups, dtype=torch.long,
                                        device=dev).scatter_add_(
        0, g, real.long()), 0)
    return walk.contiguous(), goff.to(torch.int32)


def bwd_groups(n_src: int, slots: int):
    """#14's schedule: (group, n_groups), the source blocks of one CTA (or
    cluster) and their count, ``n_src`` blocks over at most ``slots`` at
    once (at least one)."""
    group = -(-n_src // max(1, slots))
    return group, -(-n_src // group)


def window_bwd_fused_reference(da_t, c_stream, tile_start, block_of_tile,
                               win_of_tile, c_off, msg_w, h, n_wins: int,
                               window: int, out_rows: int, t2: int,
                               da_scales=None):
    """Plain version of :func:`window_bwd_fused`: Y = Σ over every real
    backward tile of C_tileᵀ·ā_block (int8 ā times its block's scale) in
    f64, rounded once to h's dtype; then dhᵀ = Σ_t W_t·Y_tᵀ and dWᵀ_t =
    Y_tᵀ·h, f32 products of the rounded values."""
    del tile_start
    D, n_cols = da_t.shape
    N = h.shape[0]
    BR, W = window, out_rows
    cdt = h.dtype
    da = da_t.double().t()                              # [n_cols, D]
    if da_scales is not None:
        da = da * da_scales.double().repeat_interleave(BR)[:, None]
    Y = torch.zeros(n_wins * W, D, dtype=torch.float64, device=h.device)
    real = torch.nonzero(win_of_tile >= 0).flatten()
    src_blk = win_of_tile.long()[real] * BR             # the ā block
    dst_win = block_of_tile.long()[real] * W            # the Y window
    C = c_stream.reshape(-1, BR, W)
    for i, r, j, cnt in _count_terms(C, c_off.long()[real], BR * W):
        Y.index_add_(0, dst_win[i] + j, da[src_blk[i] + r] * cnt.double()[:, None])
    Yb = Y.to(cdt).float().reshape(N // 128, t2, 128, D)
    w = msg_w.to(cdt).float()
    dht = torch.einsum("btsf,tdf->dbs", Yb, w).reshape(D, N)
    dwt = torch.einsum("btsf,bsd->tfd", Yb,
                       h.float().reshape(N // 128, 128, D))
    return dht, dwt


# #14's walk tables (bwd_walk), kept per layout while its arrays live:
# id(backward tile_start) -> (a weak reference to it, {key: table})
_BWD_WALKS: dict = {}


def takes_grad(*tensors) -> bool:
    """Whether a call records a gradient: grad mode on and some input
    requires one.  The custom autograd functions decide between their
    serving and training forwards by it before ``.apply``; inside
    ``forward`` grad mode is always off, and ``ctx.needs_input_grad``
    stays set under ``torch.no_grad``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def cached_per_tensor(t, key, make):
    """``make()``, computed once per (tensor ``t``, ``key``) while ``t``
    lives: what a layout's arrays alone decide, such as #14's walk table,
    #11's plan and the kernels' data checks (a raise is not cached)."""
    entry = _BWD_WALKS.get(id(t))
    if entry is None or entry[0]() is not t:
        entry = (weakref.ref(t, lambda _, i=id(t): _BWD_WALKS.pop(i, None)),
                 {})
        _BWD_WALKS[id(t)] = entry
    if key not in entry[1]:
        entry[1][key] = make()
    return entry[1][key]


def window_bwd_fused(da_t, c_stream, tile_start, block_of_tile, win_of_tile,
                     c_off, msg_w, h, n_wins: int, window: int, out_rows: int,
                     t2: int, da_scales=None):
    """The fused backward of the window aggregation (kernel #14, the
    reference's ``window_bwd_fused``): (dhᵀ [D, N] f32, dWᵀ [T2, D, D]
    f32) without the [T2·N, D] Y in device memory.

    ``da_t`` the transposed cotangent [D, n_blocks·window] in h's dtype,
    or int8 with ``da_scales`` [n_blocks] f32 (:func:`quantize_grad_pow2`);
    ``c_stream`` the FORWARD count stream [n·window, out_rows] int8, read
    through ``c_off``; the backward tiles ``tile_start`` [n_wins + 1],
    ``block_of_tile`` (their window), ``win_of_tile`` (their dst block, < 0
    for a dummy), ``c_off``; ``window`` = the layout's block_rows,
    ``out_rows`` = its W (a multiple of 128 dividing T2·128); ``msg_w``
    [T2, D, D] (cast to h's dtype), ``h`` [N, D] in the compute dtype,
    block-major rows.  A window with no real tile contributes exactly
    zero.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/window_bwd_fused.cu`` (bf16 at D = 128 and W of 128, 256 or 512:
    a cluster of W / 128 CTAs per group of source blocks) or
    ``csrc/window_bwd.cu`` (f32, D = 128·P in 128-column panels; other D
    through :func:`~ggnn_tpu_torch.ops.gru.pad_width`), or raises."""
    name = "window_bwd_fused"
    N, D = h.shape
    quant = da_scales is not None
    if (t2 * 128) % out_rows or out_rows % 128:
        raise ValueError("fused backward needs (T2*128) % W == 0, "
                         "W % 128 == 0")
    if n_wins != (t2 * N) // out_rows:
        raise ValueError("n_wins inconsistent with T2*N/W")
    if N % 128 or window % 128:
        raise ValueError(f"{name}: h rows ({N}) and block_rows ({window}) "
                         f"must be multiples of 128")
    if da_t.dim() != 2 or da_t.shape[0] != D or da_t.shape[1] % window:
        raise ValueError(f"{name}: da_t must be [D, n_blocks·block_rows] = "
                         f"[{D}, k·{window}], got {tuple(da_t.shape)}")
    want = torch.int8 if quant else h.dtype
    if da_t.dtype != want:
        raise ValueError(f"{name}: da_t must be {want}, got {da_t.dtype}")
    n_dst = da_t.shape[1] // window
    if quant and tuple(da_scales.shape) != (n_dst,):
        raise ValueError(f"{name}: da_scales must be [{n_dst}], got "
                         f"{tuple(da_scales.shape)}")
    if tuple(msg_w.shape) != (t2, D, D):
        raise ValueError(f"{name}: msg_w must be [{t2}, {D}, {D}], got "
                         f"{tuple(msg_w.shape)}")
    if c_stream.dim() != 2 or c_stream.shape[1] != out_rows \
            or c_stream.shape[0] % window or c_stream.dtype != torch.int8:
        raise ValueError(f"{name}: c_stream must be the forward int8 stream "
                         f"[n·{window}, {out_rows}], got {c_stream.dtype} "
                         f"{tuple(c_stream.shape)}")
    if tuple(tile_start.shape) != (n_wins + 1,):
        raise ValueError(f"{name}: tile_start {tuple(tile_start.shape)} is "
                         f"not [n_wins + 1] = [{n_wins + 1}]")
    if h.device.type == "cpu":
        return window_bwd_fused_reference(
            da_t, c_stream, tile_start, block_of_tile, win_of_tile, c_off,
            msg_w, h, n_wins, window, out_rows, t2, da_scales)
    if D != kernel_width(D):
        P = lambda x, **kw: pad_width(x, D, **kw)
        dht, dwt = window_bwd_fused(
            P(da_t.t()).t().contiguous(), c_stream, tile_start,
            block_of_tile, win_of_tile, c_off, P(msg_w, rows=True), P(h),
            n_wins, window, out_rows, t2, da_scales)
        return dht[:D].contiguous(), narrow_width(dwt, D, rows=True)
    if h.dtype not in _DTYPE_CODE or (quant and h.dtype != torch.bfloat16):
        raise ValueError(f"{name}: h {h.dtype}: the kernel takes bf16 or "
                         f"f32, and bf16 with int8 gradients")
    msg_w = msg_w.to(h.dtype).contiguous()
    named = [("da_t", da_t), ("c_stream", c_stream),
             ("tile_start", tile_start), ("win_of_tile", win_of_tile),
             ("c_off", c_off), ("msg_w", msg_w), ("h", h)]
    if quant:
        da_scales = da_scales.float().contiguous()
        named.append(("da_scales", da_scales))
    _check_cuda_args(name, named, D, wide=True)
    for arg, t in (("tile_start", tile_start), ("win_of_tile", win_of_tile),
                   ("c_off", c_off)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")
    n_c = c_stream.shape[0] // window

    def tile_range():
        """The tiles' dst blocks and stream tiles against the arguments,
        and the tiles the windows hold (one copy to the host)."""
        if not win_of_tile.shape[0]:
            return 0
        real = win_of_tile >= 0
        zero = torch.zeros_like(win_of_tile)
        b_max, c_max, c_min, t_end = host_ints(
            torch.where(real, win_of_tile, zero).max(),
            torch.where(real, c_off, zero).max(),
            torch.where(real, c_off, zero).min(), tile_start[-1])
        if b_max >= n_dst or c_min < 0 or c_max >= n_c \
                or t_end > win_of_tile.shape[0]:
            raise ValueError(f"{name}: the tiles address dst block {b_max} "
                             f"of {n_dst} and stream tiles [{c_min}, "
                             f"{c_max}] of {n_c}: layout and arguments "
                             f"disagree")
        return t_end
    # once per layout and argument shape (no host sync on later calls)
    t_end = cached_per_tensor(
        tile_start, ("checks " + name, n_dst, n_c, win_of_tile.data_ptr(),
                     c_off.data_ptr()), tile_range)
    n_src = N // 128
    dev = h.device
    if h.dtype == torch.bfloat16 and D == 128 and out_rows in (128, 256,
                                                               512):
        # csrc/window_bwd_fused.cu: clusters of W / 128 CTAs, about one CTA
        # an SM, each group's dWᵀ partial written once
        with torch.cuda.device(dev):
            slots = _build.library().ggnn_window_bwd_slots(int(quant),
                                                           out_rows // 128)
        if slots < 1:
            raise RuntimeError(f"{name}: no cluster of {out_rows // 128} "
                               f"CTAs fits on this card")
        group, n_groups = bwd_groups(n_src, slots)
        ws = torch.empty(n_groups, t2, D, D, dtype=torch.float32, device=dev)
        # the walk table, once per layout (its arrays) and group size
        walk, goff = cached_per_tensor(
            tile_start, (group, t_end, n_dst, n_c, t2, out_rows,
                         win_of_tile.data_ptr(), c_off.data_ptr()),
            lambda: bwd_walk(tile_start, win_of_tile, c_off, t_end, n_dst,
                             n_c, t2 * 128 // out_rows, group, n_groups))
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        group, n_groups = bwd_groups(n_src, 2 * sms)
        ws = torch.zeros(n_groups, t2, D, D, dtype=torch.float32, device=dev)
        walk = goff = None
    dht = torch.empty(D, N, dtype=torch.float32, device=dev)
    dwt = torch.empty(t2, D, D, dtype=torch.float32, device=dev)
    p = _build.ptr
    _build.launch(
        _build.library().ggnn_window_bwd, name, dev, _DTYPE_CODE[h.dtype],
        int(quant), p(da_t), p(da_scales), da_t.shape[1], p(c_stream), n_c,
        p(tile_start), p(win_of_tile), p(c_off), n_dst, window, out_rows,
        t2, n_src, group, D, p(msg_w), p(h), p(dht), p(ws), p(dwt), p(walk),
        p(goff))
    window_bwd_fused.launches += 1
    return dht, dwt


window_bwd_fused.launches = 0
