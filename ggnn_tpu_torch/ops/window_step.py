"""The window backend's compositions: its spill, ``aggregate_window`` and
the fused step ``gru_window_step``, with their backwards.

Counterpart of ``ggnn_tpu/ops/window_pallas.py:2004-2487``, rounding point
for rounding point:

- the spill (edges in tiles too sparse for a count matrix): the legacy
  spill gathers table rows (:func:`_spill_scatter`), the XW spill gathers
  h rows into type buckets and transforms them there
  (:func:`_spill_partial`); either way the block scatter of its layout
  (#11 on the dst-local stream at ``win_stride`` 16, or #8);
- :func:`aggregate_window`: the table (#10, or the 'src'/'type' einsums)
  and #11, or on-demand windows (#12), plus the spill → a [N, D] f32;
- :func:`gru_window_step`: the spill's partial as the init of #13, which
  adds the windows and runs the GRU epilogue, over a bf16/f32 table, a
  q8 table (#15, forward only) or on-demand windows;
- the backward (:func:`aggregate_window_bwd`, needs a layout built
  ``with_grad=True``): the bias gradient from ``gt_indeg``; dh and dW from
  the fused kernel #14 on the forward count stream (``grad_meta[4]``; int8
  gradients with ``meta[10]``) or from Y = Cᵀ·ā through #11 on the
  transposed stream and the row order's einsums; plus the spill backward
  (:func:`_spill_backward`).  The fused step's VJP (:class:`FusedWindowStep`)
  runs #13 with ``emit_res`` under autograd, then #4 on its residuals and
  :func:`aggregate_window_bwd`; split (``window_step_prep(split_grad=
  True)``), #4 gives the external partial's cotangent at once and
  :func:`aggregate_window_bwd` runs in a node of its own
  (:class:`_SplitAggregateBwd`), recorded where the prep ran.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import table as TB
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.ops.gru import gru_cell_bwd
from ggnn_tpu_torch.ops.window import DeviceWindowLayout


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


def rows_sum(vals, rows, n_rows):
    """out[rows[i]] += vals[i] → f32 [n_rows, D], rows ≥ n_rows dropped:
    the rows sorted (stably), summed by one f64 prefix sum and rounded once,
    so the sums run in one fixed order (no float atomics on the card)."""
    keep = rows < n_rows
    rows, vals = rows[keep], vals[keep]
    out = torch.zeros(n_rows, vals.shape[1], dtype=torch.float32,
                      device=vals.device)
    if rows.shape[0] == 0:
        return out
    order = torch.argsort(rows, stable=True)
    rows = rows[order]
    cs = torch.cumsum(vals[order].double(), 0)
    last = torch.ones_like(rows, dtype=torch.bool)
    last[:-1] = rows[1:] != rows[:-1]
    ends = cs[last]
    out[rows[last]] = (ends - F.pad(ends, (0, 0, 1, 0))[:-1]).float()
    return out


def _spill_backward(arrs, sp_offs, sb_meta, h, da, msg_w):
    """dh and dW of the spilled edges (the reference's ``_spill_backward``;
    db comes from ``gt_indeg``): per-edge cotangent rows in the type-major
    buckets (``s_bwd_dst``, cast to h's dtype before the gather), then
    batched einsums (uniform buckets) or one product per type, f32
    products of the compute-dtype values; the per-edge dh rows rounded to
    h's dtype and scattered by the ``sb_`` layout (#11 or #8), or, where
    the layout has none (n_src_rows % 128 ≠ 0), by :func:`rows_sum`."""
    N, D = h.shape
    T2 = msg_w.shape[0]
    src = arrs["s_bwd_src"].long()
    tot = src.shape[0]
    G = da.to(h.dtype).index_select(0, arrs["s_bwd_dst"].long()).float()
    Hsp = torch.where((src < N)[:, None], h[src.clamp(max=N - 1)],
                      torch.zeros((), dtype=h.dtype, device=h.device)).float()
    w = msg_w.float()
    strides = {sp_offs[t + 1] - sp_offs[t] for t in range(T2)}
    if len(strides) == 1:
        P = strides.pop()
        Gb = G.reshape(T2, P, D)
        dh_e = torch.einsum("tpf,tdf->tpd", Gb, w).reshape(tot, D)
        dW_sp = torch.einsum("tpd,tpf->tdf", Hsp.reshape(T2, P, D), Gb)
    else:
        sl = [slice(sp_offs[t], sp_offs[t + 1]) for t in range(T2)]
        dh_e = torch.cat([G[s] @ w[t].t() for t, s in enumerate(sl)])
        dW_sp = torch.stack([Hsp[s].t() @ G[s] for s in sl])
    if sb_meta is not None:
        msgs = dh_e.to(h.dtype).index_select(0, arrs["sb_gather_idx"])
        dh_sp = _spill_scatter_msgs(msgs, arrs, sb_meta, prefix="sb_")[:N]
    else:
        dh_sp = rows_sum(dh_e, src, N)
    return dh_sp, dW_sp


def aggregate_window_bwd(layout: DeviceWindowLayout, h, msg_w, da):
    """The backward of :func:`aggregate_window` (the reference's
    ``_aggregate_window_bwd``) → (dh in h's dtype, dW and db in msg_w's).
    ``h`` [N, D] the aggregation's input (compute dtype), ``da`` [≤ n_rows,
    D] its cotangent (f32, or the compute dtype from the fused step's
    VJP).  db = gt_indeg · ā (f32, every real edge); dh and dW from #14
    where ``grad_meta[4]`` holds (int8 ā with ``meta[10]``), else from Y =
    Cᵀ·ā (#11 on ``ct_stream``, Y in h's dtype) and the row order's
    einsums; plus :func:`_spill_backward`."""
    meta, arrs = layout.meta, layout.arrays
    n_blocks, W_, block_rows = layout.n_blocks, layout.window, \
        layout.block_rows
    if layout.grad_meta is None:
        raise ValueError("aggregate_window backward needs a layout built "
                         "with_grad=True")
    n_wins, _, sp_offs, sb_meta, fwd_stream = layout.grad_meta
    N, D = h.shape
    T2 = msg_w.shape[0]
    da_f = F.pad(da, (0, 0, 0, n_blocks * block_rows - da.shape[0]))
    da_pad = da_f.to(h.dtype)
    dh_sp = dW_sp = None
    if layout.spill_meta is not None:
        dh_sp, dW_sp = _spill_backward(arrs, sp_offs, sb_meta, h, da_f,
                                       msg_w)
    indeg = arrs["gt_indeg"]
    db = indeg @ da_f[:indeg.shape[1]].float()
    if fwd_stream:
        if N % 128 or n_wins != (T2 * N) // W_:
            raise ValueError(
                f"fused-backward layout mismatch: h has {N} rows but the "
                f"layout was built for {n_wins * W_ // T2}")
        gt = (arrs["c_stream"], arrs["gt_tile_start"],
              arrs["gt_block_of_tile"], arrs["gt_win_of_tile"],
              arrs["gt_c_off"], msg_w, h)
        kw = dict(n_wins=n_wins, window=block_rows, out_rows=W_, t2=T2)
        if meta[10]:
            da_q, da_scl = W.quantize_grad_pow2(da_f, block_rows)
            dht, dWt = W.window_bwd_fused(da_q.t().contiguous(), *gt,
                                          da_scales=da_scl, **kw)
        else:
            dht, dWt = W.window_bwd_fused(da_pad.t().contiguous(), *gt,
                                          **kw)
        dh, dW = dht.t(), dWt.transpose(1, 2)
    else:
        Y = W.window_block_spmm_mono(
            da_pad, arrs["ct_stream"], arrs["gt_tile_start"],
            arrs["gt_block_of_tile"], arrs["gt_win_of_tile"],
            n_blocks=n_wins, window=block_rows, out_rows=W_,
            packed=layout.packed[1], c_off=arrs["gt_c_off"],
            out_dtype=h.dtype)[:T2 * N].float()
        w, hf = msg_w.float(), h.float()
        if layout.row_major == "block":
            Yb = Y.reshape(N // 128, T2, 128, D)
            dh = torch.einsum("btsf,tdf->bsd", Yb, w).reshape(N, D)
            dW = torch.einsum("bsd,btsf->tdf", hf.reshape(N // 128, 128, D),
                              Yb)
        elif layout.row_major == "src":
            Yr = Y.reshape(N, T2, D)
            dh = torch.einsum("ntf,tdf->nd", Yr, w)
            dW = torch.einsum("nd,ntf->tdf", hf, Yr)
        else:
            Yr = Y.reshape(T2, N, D)
            dh = torch.einsum("tnf,tdf->nd", Yr, w)
            dW = torch.einsum("nd,tnf->tdf", hf, Yr)
    if dh_sp is not None:
        dh = dh + dh_sp
        dW = dW + dW_sp
    return dh.to(h.dtype), dW.to(msg_w.dtype), db.to(msg_w.dtype)


class AggregateWindow(torch.autograd.Function):
    """:func:`aggregate_window` as an autograd node: the forward runs the
    kernels, the backward :func:`aggregate_window_bwd` (so autograd never
    differentiates the plain versions)."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, layout):
        ctx.layout = layout
        ctx.save_for_backward(h, msg_w)
        return _agg_window_impl(h, layout, msg_w, msg_b)

    @staticmethod
    def backward(ctx, g):
        h, msg_w = ctx.saved_tensors
        dh, dW, db = aggregate_window_bwd(ctx.layout, h, msg_w, g)
        return dh, dW, db, None


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


@dataclasses.dataclass
class WindowStepPrep:
    """What :func:`gru_window_step` computes before ``extra_init`` is read:
    the table in the layout's row order (h in the compute dtype on-demand;
    int8 with q8 and its window ``scales``) and the spill's partial
    (None without a spill).  Values without autograd history: the fused
    step's backward reaches them through the layout.  ``token`` and
    ``handoff``: the split backward's node (:class:`_SplitAggregateBwd`)
    and what the fused step's node hands it, or None."""

    layout: DeviceWindowLayout
    quantized: bool
    table: torch.Tensor
    scales: torch.Tensor | None
    spill: torch.Tensor | None
    token: torch.Tensor | None = None
    handoff: list | None = None


class _SplitAggregateBwd(torch.autograd.Function):
    """The fused step's aggregation backward as a node of its own, recorded
    by ``window_step_prep(split_grad=True)`` on (h, msg_w, msg_b); its
    output, an empty token, is an input of the step's
    :class:`FusedWindowStep`, whose backward runs #4 alone and hands (dh1,
    da) over through ``handoff``.  This node's backward then runs
    :func:`aggregate_window_bwd` (#14, the spill backward) and returns dh
    = dh1 + dh2 (the unsplit step's one f32 add), dW and db.  The engine
    runs it where the prep stood in the forward: after the backward of all
    that was recorded later (the external partial's, and the reverse
    collective its cotangent feeds), as the reference's graph lets XLA
    schedule ``_aggregate_window_bwd`` beside the reverse all-to-all."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, layout, handoff):
        ctx.layout, ctx.handoff, ctx.h_dtype = layout, handoff, h.dtype
        ctx.save_for_backward(h.to(msg_w.dtype), msg_w)
        return h.new_empty(0, dtype=msg_w.dtype)

    @staticmethod
    def backward(ctx, _):
        hc, msg_w = ctx.saved_tensors
        dh1, da = ctx.handoff.pop()
        dh2, dW, dbm = aggregate_window_bwd(ctx.layout, hc, msg_w, da)
        return ((dh1 + dh2.float()).to(ctx.h_dtype), dW, dbm, None, None)


def window_step_prep(h, layout: DeviceWindowLayout, msg_w, msg_b,
                     quantized: bool = False,
                     split_grad: bool = False) -> WindowStepPrep:
    """The part of :func:`gru_window_step` that reads no ``extra_init``
    (#10 or the 'src' einsum, #15 with ``quantized``, and the spill), to
    run while an external partial is still being made; pass it back as
    ``prep=``.  The same values as the step computes without it.

    ``split_grad`` (where the call records a gradient): the step's
    aggregation backward becomes a node recorded here
    (:class:`_SplitAggregateBwd`), so that it runs while the backward of
    what is recorded between this call and the step (a collective's
    reverse) is in flight; the same values."""
    if layout.on_demand and quantized:
        raise ValueError("on_demand and quantized_table are mutually "
                         "exclusive serving modes")
    if layout.row_major not in ("block", "src"):
        raise ValueError("gru_window_step needs a row_major='block' or "
                         "'src' layout")
    arrs, spill_meta = layout.arrays, layout.spill_meta
    with torch.no_grad():
        hc = h.to(msg_w.dtype)
        scales = None
        if quantized:
            if layout.row_major != "block":
                raise ValueError("quantized serving needs row_major='block'")
            if layout.packed[0]:
                raise ValueError("quantized serving is incompatible with "
                                 "pack_counts (int8 MXU consumes raw "
                                 "counts)")
            table, scales = TB.node_table_block_major_q8(
                hc, msg_w, msg_b, window=layout.window)
            scales = scales[:, 0]
        elif layout.on_demand:
            table = hc
        else:
            table = _table_for(hc, layout, msg_w, msg_b)
        if spill_meta is None:
            spill = None
        elif len(spill_meta) > 8 or not quantized:
            spill = _spill_partial(hc, table, arrs, spill_meta, msg_w, msg_b)
        else:
            # the legacy spill over the q8 table: the gathered int8 rows
            # dequantized by scales[row // W]
            idx = arrs["s_gather_idx"]
            msgs = (table.index_select(0, idx).float()
                    * scales[idx.long() // layout.window][:, None]
                    ).to(msg_w.dtype)
            spill = _spill_scatter_msgs(msgs, arrs, spill_meta)
    prep = WindowStepPrep(layout, quantized, table, scales, spill)
    if split_grad and not quantized and W.takes_grad(h, msg_w, msg_b):
        prep.handoff = []
        prep.token = _SplitAggregateBwd.apply(h, msg_w, msg_b, layout,
                                              prep.handoff)
    return prep


def gru_window_step(h, layout: DeviceWindowLayout, msg_w, msg_b, gru: dict,
                    quantized: bool = False, extra_init=None,
                    prep: WindowStepPrep | None = None):
    """One propagation step h → h' [N, D] f32 through the fused kernel #13
    (the reference's ``gru_window_step``): the table (#10 or the einsum for
    'src' rows; #15 with ``quantized``; none on-demand), the spill's
    partial as the kernel's init, then the windows and the GRU epilogue
    with its gate products in ``msg_w``'s dtype.

    Trainable (:class:`FusedWindowStep`): under autograd the kernel also
    writes the (a | z | r | h̃) residuals, and the backward is #4 on them
    plus :func:`aggregate_window_bwd` (a layout built ``with_grad=True``,
    N % 128 == 0 and D % 128 == 0).  Serving (grad mode off, as under
    ``torch.no_grad``, or no input that requires a gradient) launches it
    without them.

    ``quantized``: the q8 table (int8, power-of-2 window scales), forward
    only; its spill is the XW spill (exact, from h) or the legacy one
    dequantizing the gathered int8 rows by ``scales[row // W]``.
    ``extra_init`` [R ≤ N, D]: an external partial aggregation added to
    the init (differentiable: its cotangent is da's leading rows).
    ``prep``: :func:`window_step_prep` of the same h, layout, weights and
    ``quantized``, made beforehand (None: made here)."""
    if extra_init is not None and extra_init.shape[0] > h.shape[0]:
        raise ValueError(
            f"extra_init has {extra_init.shape[0]} rows > h's "
            f"{h.shape[0]}; the fused step's cotangent for extra_init "
            "is a leading slice of da [N, D]")
    if quantized and W.takes_grad(h, msg_w, msg_b, extra_init,
                                  *gru.values()):
        raise ValueError("quantized=True is a serving mode (a forward-only "
                         "int8 table); train with quantized_table=False")
    if prep is None:
        prep = window_step_prep(h, layout, msg_w, msg_b, quantized)
    elif prep.layout is not layout or prep.quantized != quantized:
        raise ValueError("prep was made for another layout or quantization")
    N, D = h.shape
    if quantized:
        return _quantized_step(h, prep, msg_w, gru, extra_init)
    wa = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1)
    b3 = torch.cat([gru["bz"], gru["br"], gru["bh"]])[None, :]
    uzr = torch.cat([gru["uz"], gru["ur"]], dim=1)
    if extra_init is None:
        extra_init = torch.zeros(0, D, dtype=torch.float32, device=h.device)
    args = (h, msg_w, msg_b, wa, b3, uzr, gru["uh"], extra_init)
    if not W.takes_grad(*args):
        # serving: #13 without residuals, whatever the parameters'
        # requires_grad says under torch.no_grad
        return _fused_step_impl(prep, *args, emit_res=False)[:N]
    return FusedWindowStep.apply(*args, prep.token, prep)[:N]


def _init_stream(init, extra, n_rows, D, device, has_init):
    """The kernel's init: the spill's partial plus the external partial
    ``extra`` [R ≤ n_rows, D] (f32), or None without either."""
    if not has_init:
        return None
    if init is None:
        init = torch.zeros(n_rows, D, dtype=torch.float32, device=device)
    if extra is None or extra.shape[0] == 0:
        return init
    return init + F.pad(extra.float(), (0, 0, 0, n_rows - extra.shape[0]))


def _quantized_step(h, prep, msg_w, gru, extra_init):
    """The q8 serving step (int8 table, #15, then #13's q8 form)."""
    layout = prep.layout
    arrs = layout.arrays
    N, D = h.shape
    wa, b3, uzr, uh = _gru_weights(gru, msg_w.dtype)
    n_rows = layout.n_blocks * layout.block_rows
    has_init = layout.spill_meta is not None or (
        extra_init is not None and extra_init.shape[0] > 0)
    init = _init_stream(prep.spill, extra_init, n_rows, D, h.device,
                        has_init)
    h_pad = F.pad(h.float(), (0, 0, 0, n_rows - N))
    h_new = W.window_step_gru(
        prep.table, arrs["c_stream"], arrs["tile_start"],
        arrs["block_of_tile"], arrs["win_of_tile"], init, h_pad, wa, b3, uzr,
        uh, n_blocks=layout.n_blocks, window=layout.window,
        out_rows=layout.block_rows, packed=False, has_init=has_init,
        scales=prep.scales, c_off=arrs.get("c_off"))
    return h_new[:N]


def _fused_step_impl(prep, h, msg_w, msg_b, wa, b3, uzr, uh, extra,
                     emit_res):
    """#13 over the prepared table (or on-demand windows) with the spill's
    partial plus ``extra`` as init → h' [n_rows, D] (and the residuals)."""
    layout = prep.layout
    arrs = layout.arrays
    N, D = h.shape
    cdt = msg_w.dtype
    step_w, step_b = (msg_w, msg_b) if layout.on_demand else (None, None)
    n_rows = layout.n_blocks * layout.block_rows
    has_init = layout.spill_meta is not None or extra.shape[0] > 0
    init = _init_stream(prep.spill, extra, n_rows, D, h.device, has_init)
    h_pad = F.pad(h.float(), (0, 0, 0, n_rows - N))
    return W.window_step_gru(
        prep.table, arrs["c_stream"], arrs["tile_start"],
        arrs["block_of_tile"], arrs["win_of_tile"], init, h_pad,
        wa.to(cdt).contiguous(), b3.float().contiguous(),
        uzr.to(cdt).contiguous(), uh.to(cdt).contiguous(),
        n_blocks=layout.n_blocks, window=layout.window,
        out_rows=layout.block_rows, packed=layout.packed[0],
        has_init=has_init, emit_res=emit_res, c_off=arrs.get("c_off"),
        msg_w=step_w, msg_b=step_b)


class FusedWindowStep(torch.autograd.Function):
    """The trainable fused step (the reference's ``_fused_gru_step`` and
    its VJP), applied only when the call records a gradient
    (:func:`~ggnn_tpu_torch.ops.window.takes_grad`; serving calls #13
    without residuals directly).  The forward launches #13 with
    ``emit_res`` and saves h in the compute dtype and the residuals; the
    backward runs #4 (``gru_cell_bwd``, da in the compute dtype) on them,
    then :func:`aggregate_window_bwd`; extra's cotangent is da's leading
    rows.  With the prep's ``token`` (split), the backward hands (dh1, da)
    to :class:`_SplitAggregateBwd` and returns no gradient for h, msg_w
    and msg_b: that node returns them."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, wa, b3, uzr, uh, extra, token, prep):
        h_new, resid = _fused_step_impl(prep, h, msg_w, msg_b, wa, b3,
                                        uzr, uh, extra, emit_res=True)
        ctx.layout, ctx.dtypes = prep.layout, (h.dtype, wa.dtype, b3.dtype,
                                          uzr.dtype, uh.dtype, extra.dtype)
        ctx.handoff = None if token is None else prep.handoff
        ctx.n_extra = extra.shape[0]
        ctx.save_for_backward(h.to(msg_w.dtype), msg_w, wa, uzr, uh, resid)
        return h_new

    @staticmethod
    def backward(ctx, g):
        hc, msg_w, wa, uzr, uh, resid = ctx.saved_tensors
        N, D = hc.shape
        if N % 128 or D % 128:
            raise ValueError("the fused window+GRU step takes gradients only "
                             f"for N % 128 == 0 and D % 128 == 0 (got "
                             f"{N}×{D}); use the unfused path "
                             "(cfg.fuse_gru=False)")
        cdt = msg_w.dtype
        a, z, r, htil = (resid[:N, k * D:(k + 1) * D].contiguous()
                         for k in range(4))
        dh1, da, dwa, db3, duzr, duh = gru_cell_bwd(
            g[:N].float().contiguous(), hc, a, z, r, htil, wa, uzr, uh,
            mdt=cdt, da_dtype=cdt)
        h_dt, wa_dt, b3_dt, uzr_dt, uh_dt, e_dt = ctx.dtypes
        if ctx.handoff is not None:
            ctx.handoff.append((dh1, da))
            dh = dW = dbm = None
            d_token = da.new_empty(0)
        else:
            dh2, dW, dbm = aggregate_window_bwd(ctx.layout, hc, msg_w, da)
            dh = (dh1 + dh2.float()).to(h_dt)
            d_token = None
        d_extra = da[:ctx.n_extra].to(e_dt)
        return (dh, dW, dbm, dwa.to(wa_dt), db3.reshape(1, -1).to(b3_dt),
                duzr.to(uzr_dt), duh.to(uh_dt), d_extra, d_token, None)
