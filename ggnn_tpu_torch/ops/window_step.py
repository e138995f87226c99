"""The window backend's serving path: its spill, ``aggregate_window`` and
the fused step ``gru_window_step``.

Counterpart of ``ggnn_tpu/ops/window_pallas.py:2004-2320``, forward half,
rounding point for rounding point:

- the spill (edges in tiles too sparse for a count matrix): the legacy
  spill gathers table rows (:func:`_spill_scatter`), the XW spill gathers
  h rows into type buckets and transforms them there
  (:func:`_spill_partial`); either way the block scatter of its layout
  (#11 on the dst-local stream at ``win_stride`` 16, or #8);
- :func:`aggregate_window`: the table (#10, or the 'src'/'type' einsums)
  and #11, or on-demand windows (#12), plus the spill → a [N, D] f32;
- :func:`gru_window_step`: the spill's partial as the init of #13, which
  adds the windows and runs the GRU epilogue, over a bf16/f32 table, a
  q8 table (#15) or on-demand windows.

The backward (``_aggregate_window_bwd``, the fused step's VJP, kernel #14)
is ROADMAP Queue 1 item 5b: under autograd both raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import table as TB
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.ops.window import QUEUE_ITEM_5B, DeviceWindowLayout


def refuse_grad(name, *tensors):
    """Raise where autograd would need the window backend's backward."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name}: gradients through the window "
                                  f"backend are not ported yet "
                                  f"({QUEUE_ITEM_5B})")


def _spill_scatter_msgs(msgs, arrs, spill_meta, prefix="s_"):
    """The spill layout's block scatter of its message pack → f32
    [spill n_nodes_pad, D]: 16-aligned packs through #11 at ``win_stride``
    = edge_align (the dst-local stream where it has one), else #8."""
    s_tile_e, s_blocks = spill_meta[1], spill_meta[3]
    align = spill_meta[6]
    if align is not None:
        use_dstl = (prefix + "dstl") in arrs
        return W.window_block_spmm_mono(
            msgs, arrs[prefix + ("dstl" if use_dstl else "onehot")],
            arrs[prefix + "tile_start"], arrs[prefix + "block_of_tile"],
            arrs[prefix + "tile_msg_off"], n_blocks=s_blocks,
            window=s_tile_e, win_stride=align, dstl=use_dstl)
    return L.onehot_segment_scatter_flat(
        msgs, arrs[prefix + "onehot"], arrs[prefix + "tile_start"],
        arrs[prefix + "block_of_tile"], n_blocks=s_blocks, tile_e=s_tile_e)


def _spill_scatter(table, arrs, spill_meta):
    """The legacy spill: table rows gathered per spilled edge, scattered."""
    return _spill_scatter_msgs(table.index_select(0, arrs["s_gather_idx"]),
                               arrs, spill_meta)


def _spill_partial(h, table, arrs, spill_meta, msg_w, msg_b):
    """The spill's aggregation.  The XW spill (a 9th ``spill_meta``
    element, the type buckets' offsets): h rows gathered by ``sx_src``
    (pad slots read a zero row), h·W_t + b_t per bucket in f32, rounded to
    the compute dtype, then gathered into scatter order by
    ``s_gather_idx``; else the legacy spill from ``table``."""
    if len(spill_meta) <= 8:
        return _spill_scatter(table, arrs, spill_meta)
    offs = spill_meta[8]
    T2, D = msg_w.shape[0], msg_w.shape[2]
    N = h.shape[0]
    src = arrs["sx_src"].long()
    hc = h.to(msg_w.dtype)
    hsp = torch.where((src < N)[:, None], hc[src.clamp(max=N - 1)],
                      torch.zeros((), dtype=hc.dtype, device=hc.device))
    strides = {offs[t + 1] - offs[t] for t in range(T2)}
    if len(strides) == 1:
        P = strides.pop()
        msgs = (torch.einsum("tpd,tdf->tpf", hsp.reshape(T2, P, D).float(),
                             msg_w.float())
                + msg_b.float()[:, None, :]).reshape(-1, D)
    else:
        msgs = torch.cat([hsp[offs[t]:offs[t + 1]].float() @ msg_w[t].float()
                          + msg_b[t].float() for t in range(T2)], dim=0)
    msgs = msgs.to(msg_w.dtype).index_select(0, arrs["s_gather_idx"])
    return _spill_scatter_msgs(msgs, arrs, spill_meta)


def _table_for(h, layout, msg_w, msg_b):
    """The table in the layout's row order, padded to whole windows."""
    table = TB.node_table(h, msg_w, msg_b, layout.row_major)
    pad = (-table.shape[0]) % layout.window
    return F.pad(table, (0, 0, 0, pad)) if pad else table


def _agg_window_impl(h, layout: DeviceWindowLayout, msg_w, msg_b):
    arrs = layout.arrays
    n_blocks, W_, block_rows = layout.n_blocks, layout.window, \
        layout.block_rows
    if layout.on_demand:
        table = None
        out = W.window_block_spmm_ondemand(
            h, msg_w, msg_b, arrs["c_stream"], arrs["tile_start"],
            arrs["block_of_tile"], arrs["win_of_tile"], arrs.get("c_off"),
            n_blocks=n_blocks, window=W_, out_rows=block_rows)
    else:
        table = _table_for(h, layout, msg_w, msg_b)
        out = W.window_block_spmm_mono(
            table, arrs["c_stream"], arrs["tile_start"],
            arrs["block_of_tile"], arrs["win_of_tile"], n_blocks=n_blocks,
            window=W_, out_rows=block_rows, packed=layout.packed[0],
            c_off=arrs.get("c_off"))
    if layout.spill_meta is not None:
        out = out + _spill_partial(h, table, arrs, layout.spill_meta, msg_w,
                                   msg_b)
    return out[:h.shape[0]]


class AggregateWindow(torch.autograd.Function):
    """:func:`aggregate_window` as an autograd node: the forward runs the
    kernels; the backward (the reference's ``_aggregate_window_bwd`` and
    kernel #14) is ROADMAP Queue 1 item 5b and raises, so autograd never
    differentiates the plain versions instead."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, layout):
        return _agg_window_impl(h, layout, msg_w, msg_b)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(f"aggregate_window: the backward is not "
                                  f"ported yet ({QUEUE_ITEM_5B})")


def aggregate_window(h, layout: DeviceWindowLayout, msg_w, msg_b):
    """a = Σ_tiles C · table window (+ the spill) → [N, D] f32, N = h's rows
    (the reference's ``aggregate_window``, forward).  ``h`` [N, D],
    ``msg_w`` [T2, D, D], ``msg_b`` [T2, D] in the compute dtype; the
    table is h·W_t + b_t in the layout's row order, rounded to h's dtype
    (on-demand layouts build its windows on the chip, #12)."""
    return AggregateWindow.apply(h, msg_w, msg_b, layout)


def _gru_weights(gru: dict, cdt):
    wa = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1).to(cdt)
    b3 = torch.cat([gru["bz"], gru["br"], gru["bh"]])[None, :].float()
    uzr = torch.cat([gru["uz"], gru["ur"]], dim=1).to(cdt)
    return wa, b3, uzr, gru["uh"].to(cdt)


def _with_extra(init, extra, n_rows):
    """init plus the external partial ``extra`` [R ≤ n_rows, D] (f32)."""
    if extra is None or extra.shape[0] == 0:
        return init
    return init + F.pad(extra.float(), (0, 0, 0, n_rows - extra.shape[0]))


def gru_window_step(h, layout: DeviceWindowLayout, msg_w, msg_b, gru: dict,
                    quantized: bool = False, extra_init=None):
    """One propagation step h → h' [N, D] f32 through the fused kernel #13
    (the reference's ``gru_window_step``, forward): the table (#10 or the
    einsum for 'src' rows; #15 with ``quantized``; none on-demand), the
    spill's partial as the kernel's init, then the windows and the GRU
    epilogue with its gate products in ``msg_w``'s dtype.

    ``quantized``: the q8 table (int8, power-of-2 window scales); its spill
    is the XW spill (exact, from h) or the legacy one dequantizing the
    gathered int8 rows by ``scales[row // W]``.  ``extra_init`` [R ≤ N, D]:
    an external partial aggregation added to the init.  Serving only:
    under autograd it raises (the fused step's VJP is ROADMAP Queue 1
    item 5b)."""
    refuse_grad("gru_window_step", h, msg_w, msg_b, extra_init,
                *gru.values())
    if extra_init is not None and extra_init.shape[0] > h.shape[0]:
        raise ValueError(
            f"extra_init has {extra_init.shape[0]} rows > h's "
            f"{h.shape[0]}; the fused step's cotangent for extra_init "
            "is a leading slice of da [N, D]")
    W_, n_blocks, spill_meta = layout.window, layout.n_blocks, \
        layout.spill_meta
    row_major, block_rows = layout.row_major, layout.block_rows
    pack_fwd, on_demand = layout.packed[0], layout.on_demand
    if on_demand and quantized:
        raise ValueError("on_demand and quantized_table are mutually "
                         "exclusive serving modes")
    if row_major not in ("block", "src"):
        raise ValueError("gru_window_step needs a row_major='block' or "
                         "'src' layout")
    arrs = layout.arrays
    N, D = h.shape
    cdt = msg_w.dtype
    wa, b3, uzr, uh = _gru_weights(gru, cdt)
    n_rows = n_blocks * block_rows
    has_init = spill_meta is not None or (
        extra_init is not None and extra_init.shape[0] > 0)
    hc = h.to(cdt)
    scales = step_w = step_b = None
    if quantized:
        if row_major != "block":
            raise ValueError("quantized serving needs row_major='block'")
        if pack_fwd:
            raise ValueError("quantized serving is incompatible with "
                             "pack_counts (int8 MXU consumes raw counts)")
        table, scales = TB.node_table_block_major_q8(hc, msg_w, msg_b,
                                                     window=W_)
        scales = scales[:, 0]
        if spill_meta is not None and len(spill_meta) > 8:
            init = _spill_partial(hc, None, arrs, spill_meta, msg_w, msg_b)
        elif spill_meta is not None:
            idx = arrs["s_gather_idx"]
            msgs = (table.index_select(0, idx).float()
                    * scales[idx.long() // W_][:, None]).to(cdt)
            init = _spill_scatter_msgs(msgs, arrs, spill_meta)
        else:
            init = None
    else:
        if on_demand:
            table, step_w, step_b = hc, msg_w, msg_b
        else:
            table = _table_for(hc, layout, msg_w, msg_b)
        init = (_spill_partial(hc, table, arrs, spill_meta, msg_w, msg_b)
                if spill_meta is not None else None)
    if has_init:
        if init is None:
            init = torch.zeros(n_rows, D, dtype=torch.float32,
                               device=h.device)
        init = _with_extra(init, extra_init, n_rows)
    h_pad = F.pad(h.float(), (0, 0, 0, n_rows - N))
    h_new = W.window_step_gru(
        table, arrs["c_stream"], arrs["tile_start"], arrs["block_of_tile"],
        arrs["win_of_tile"], init, h_pad, wa, b3, uzr, uh,
        n_blocks=n_blocks, window=W_, out_rows=block_rows, packed=pack_fwd,
        has_init=has_init, scales=scales, c_off=arrs.get("c_off"),
        msg_w=step_w, msg_b=step_b)
    return h_new[:N]
