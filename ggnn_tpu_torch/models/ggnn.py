"""GGNN propagation: T steps of typed messages + GRU.

Counterpart of ``ggnn_tpu/models/ggnn.py``, with a Python loop in place of
``lax.scan``, ``torch.autograd.Function`` where the reference has a
``custom_vjp`` (:class:`GruCore`, :class:`GruCoreKernel`,
:class:`TypedFusedStep`, and ``AggregateOnehot`` in ``ops/scatter.py``), and
the same dtype decisions:

- aggregation runs in ``cfg.compute_dtype`` (bf16 halves the gather's
  bytes) with f32 accumulation; the state h stays f32;
- the GRU's matmul inputs follow the compute dtype when
  ``cfg.gru_matmul_compute`` (gates and state stay f32);
- the fused onehot step casts its gate matmul inputs to the compute dtype
  whatever ``gru_matmul_compute`` says, as the reference does.

Backends: ``xla`` (plain :func:`ggnn_tpu_torch.ops.segment.typed_aggregate`)
and ``onehot``: through the typed-pack CUDA kernels (per block, or per tile
where block mode declines), fused (GRU in the kernel's epilogue) or not;
through the legacy table-gather layout (``ops/legacy.py``: the table
kernel, then its scatter), which never fuses; or, forward only, through a
list of chunked legacy layouts.  ``window``: the window layouts of
``ops/window.py`` through ``ops/window_step.py``, fused (kernel #13 over a
bf16/f32 table, a q8 table or on-demand windows; trainable but for q8) or
not (``aggregate_window`` then the GRU cell), with their backwards.
``pallas``: the type-tiled layout of ``ops/spmm.py`` (built once, outside
the step loop), kernel #16's per-tile messages and their segment sum, then
the GRU cell.

The SDDMM edge gates (``cfg.edge_gates``) scale each message by
σ(⟨h_u·P, h_v·Q⟩) on the ``xla`` and ``pallas`` backends, the score
through kernel #17; p and q are f32 products of the f32 state (TF32 is
off: ``torch.backends.cuda.matmul.allow_tf32`` is False by default).  On
``onehot`` and ``window`` the reference aggregates ungated; so does the
port, with a warning.
"""

from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.init import torch_dtype
from ggnn_tpu_torch.ops.gru import (_mm, gru_cell_bwd, gru_cell_fwd,
                                    gru_cell_fwd_reference)
from ggnn_tpu_torch.ops.legacy import (DstBlockLayout,
                                       aggregate_onehot_chunked,
                                       build_dst_block_layout)
from ggnn_tpu_torch.ops.scatter import (BLOCK_N, ScatterLayout,
                                        aggregate_bwd, aggregate_forward,
                                        aggregate_onehot, bias_rows,
                                        block_args, grad_meta, tile_args,
                                        typed_block_step_gru, typed_step_gru)
from ggnn_tpu_torch.ops import spmm
from ggnn_tpu_torch.ops.segment import EdgeScore, sddmm, typed_aggregate
from ggnn_tpu_torch.ops.window import DeviceWindowLayout, takes_grad
from ggnn_tpu_torch.ops.window_step import aggregate_window, gru_window_step


def init_state(annotations, state_dim: int):
    """h^(1) = pad(x, D)."""
    return F.pad(annotations.float(), (0, state_dim - annotations.shape[1]))


def fuse_gru(gru: dict) -> tuple:
    """(W_a [D, 3D], b [3D], U_zr [D, 2D]): the gate weights concatenated
    once, outside the step loop."""
    w_a = torch.cat([gru["wz"], gru["wr"], gru["wh"]], dim=1)
    b_all = torch.cat([gru["bz"], gru["br"], gru["bh"]], dim=0)
    u_zr = torch.cat([gru["uz"], gru["ur"]], dim=1)
    return w_a, b_all, u_zr


def gru_update(gru: dict, h, a, fused: tuple | None = None,
               matmul_dtype=None):
    """GRU cell.  With ``matmul_dtype`` set (bf16), N % 128 == 0 and
    D % 128 == 0 the cell goes to :class:`GruCoreKernel` (forward
    :func:`gru_cell_fwd`, backward :func:`gru_cell_bwd`: on the card the
    kernels, or a raise), as the reference runs its Pallas cell; otherwise
    the plain cell with the reference's custom backward (:class:`GruCore`)."""
    if fused is None:
        fused = fuse_gru(gru)
    w_a, b_all, u_zr = fused
    N, D = h.shape
    core = (GruCoreKernel if matmul_dtype is not None and N % 128 == 0
            and D % 128 == 0 else GruCore)
    return core.apply(w_a, b_all, u_zr, gru["uh"], h, a, matmul_dtype)


def _gru_core_bwd(mdt, w_a, u_zr, uh, h, a, z, r, htil, g):
    """The plain GRU backward of the reference (``_gru_core_bwd``): the
    gate gradients are cast to ``mdt`` BEFORE the db sums and the matmuls.
    Returns f32 (dW_a, db, dU_zr, dU_h, dh, da)."""
    mm = lambda x, w: _mm(x, w, mdt)
    h, z, r, htil = (x.float() for x in (h, z, r, htil))
    D = h.shape[-1]
    dz = g * (htil - h)
    dh = g * (1.0 - z)
    dq = (g * z) * (1.0 - htil * htil)
    drh = mm(dq, uh.t())
    duh = mm((r * h).t(), dq)
    dr = drh * h
    dh = dh + drh * r
    dpz = dz * z * (1.0 - z)
    dpr = dr * r * (1.0 - r)
    if mdt is not None:
        dpz, dpr, dq = (x.to(mdt) for x in (dpz, dpr, dq))
    da = (mm(dpz, w_a[:, :D].t()) + mm(dpr, w_a[:, D:2 * D].t())
          + mm(dq, w_a[:, 2 * D:].t()))
    dw_a = torch.cat([mm(a.t(), dpz), mm(a.t(), dpr), mm(a.t(), dq)], dim=1)
    db = torch.cat([x.float().sum(0) for x in (dpz, dpr, dq)])
    dh = dh + mm(dpz, u_zr[:, :D].t()) + mm(dpr, u_zr[:, D:].t())
    du_zr = torch.cat([mm(h.t(), dpz), mm(h.t(), dpr)], dim=1)
    return dw_a, db, du_zr, duh, dh, da


class GruCore(torch.autograd.Function):
    """The plain GRU cell with the reference's minimal-residual custom
    backward (``ggnn.py::_gru_core``): saves h, a and the gates in the
    matmul dtype (h's dtype when none is set)."""

    @staticmethod
    def forward(ctx, w_a, b_all, u_zr, uh, h, a, mdt):
        out, z, r, htil = gru_cell_fwd_reference(h, a, w_a, b_all, u_zr, uh,
                                                 mdt=mdt)
        rdt = h.dtype if mdt is None else mdt
        ctx.mdt, ctx.dtypes = mdt, (h.dtype, a.dtype)
        ctx.save_for_backward(w_a, u_zr, uh, *(x.to(rdt) for x in (
            h, a, z, r, htil)))
        return out

    @staticmethod
    def backward(ctx, g):
        w_a, u_zr, uh, h, a, z, r, htil = ctx.saved_tensors
        dwa, db, duzr, duh, dh, da = _gru_core_bwd(
            ctx.mdt, w_a, u_zr, uh, h, a, z, r, htil, g.float())
        return (dwa.to(w_a.dtype), db.to(w_a.dtype), duzr.to(u_zr.dtype),
                duh.to(uh.dtype), dh.to(ctx.dtypes[0]), da.to(ctx.dtypes[1]),
                None)


class GruCoreKernel(torch.autograd.Function):
    """The GRU cell through the cell kernels (``ggnn.py::_gru_core_pallas``):
    forward :func:`gru_cell_fwd`, backward :func:`gru_cell_bwd`, with h and
    a saved in the matmul dtype beside the kernel's gates."""

    @staticmethod
    def forward(ctx, w_a, b_all, u_zr, uh, h, a, mdt):
        out, z, r, htil = gru_cell_fwd(h, a, w_a, b_all, u_zr, uh, mdt=mdt)
        ctx.mdt, ctx.dtypes = mdt, (h.dtype, a.dtype)
        ctx.save_for_backward(w_a, b_all, u_zr, uh, h.to(mdt), a.to(mdt), z,
                              r, htil)
        return out

    @staticmethod
    def backward(ctx, g):
        w_a, b_all, u_zr, uh, h, a, z, r, htil = ctx.saved_tensors
        dh, da, dwa, db, duzr, duh = gru_cell_bwd(
            g.float().contiguous(), h, a, z, r, htil, w_a, u_zr, uh,
            mdt=ctx.mdt)
        return (dwa.to(w_a.dtype), db.reshape(-1).to(b_all.dtype),
                duzr.to(u_zr.dtype), duh.to(uh.dtype), dh.to(ctx.dtypes[0]),
                da.to(ctx.dtypes[1]), None)


def typed_fused_step(layout: ScatterLayout, h, msg_w, msg_b, w_a, b_all,
                     u_zr, uh, cdt):
    """One fused typed-pack step (aggregation + GRU in the kernel's
    epilogue): the ``h_pack`` gather and the bias stay torch ops.  The
    per-block kernel where block mode engaged, the per-tile one where it
    declined."""
    N = h.shape[0]
    n_rows = layout.n_blocks * BLOCK_N
    h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
    h_pad = F.pad(h.float(), (0, 0, 0, n_rows - N))
    gru = dict(init=bias_rows(layout, msg_b), hstate=h_pad, wa=w_a.to(cdt),
               b3=b_all[None, :].float(), uzr=u_zr.to(cdt), uh=uh.to(cdt))
    if layout.block_meta is None:
        out = typed_step_gru(h_pack, msg_w=msg_w.to(cdt), **gru,
                             **tile_args(layout))
    else:
        kw = block_args(layout)
        out = typed_block_step_gru(
            h_pack, kw.pop("dstl_blk"), kw.pop("slot_off16"),
            kw.pop("blk_off16"), msg_w.to(cdt), **gru, **kw)
    return out[:N]


class TypedFusedStep(torch.autograd.Function):
    """The fused typed-pack step with the reference's custom backward
    (``ggnn.py::_typed_fused_step``), applied only when the call records a
    gradient (:func:`~ggnn_tpu_torch.ops.window.takes_grad`; serving calls
    the fused kernel, :func:`typed_fused_step`, directly).

    The forward is the reference's fwd rule: the aggregation through the
    typed block kernel, then the PLAIN GRU math with matmul inputs in
    ``mdt``; it saves the full residuals (h, a, z, r, h̃ narrow) or, with
    ``lean``, only (h, a) and recomputes the gates in the backward.  The backward is the plain GRU
    backward plus :func:`aggregate_bwd` (the grad-octet kernel); it never
    runs the GRU-cell kernels."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, w_a, b_all, u_zr, uh, layout, mdt,
                lean):
        grad_meta(layout)               # refuse a layout with no grad half
        hc = h.to(msg_w.dtype)
        a = aggregate_forward(hc, layout, msg_w, msg_b)
        out, z, r, htil = gru_cell_fwd_reference(h, a, w_a, b_all, u_zr, uh,
                                                 mdt=mdt)
        rdt = h.dtype if mdt is None else mdt
        ctx.layout, ctx.mdt, ctx.lean, ctx.h_dtype = layout, mdt, lean, h.dtype
        res = (hc, msg_w, w_a, u_zr, uh, a.to(rdt))
        if lean:
            ctx.save_for_backward(*res, b_all)
        else:
            ctx.save_for_backward(*res, z.to(rdt), r.to(rdt), htil.to(rdt))
        return out

    @staticmethod
    def backward(ctx, g):
        hc, msg_w, w_a, u_zr, uh, a, *rest = ctx.saved_tensors
        mdt = ctx.mdt
        if ctx.lean:
            # recompute the gates from the narrow (h, a), as the reference
            (b_all,) = rest
            _, z, r, htil = gru_cell_fwd_reference(
                hc.float(), a.float(), w_a, b_all, u_zr, uh, mdt=mdt)
            z, r, htil = (x.to(hc.dtype) for x in (z, r, htil))
        else:
            z, r, htil = rest
        dwa, db3, duzr, duh, dh1, da = _gru_core_bwd(
            mdt, w_a, u_zr, uh, hc, a, z, r, htil, g.float())
        dh2, dW, dbm = aggregate_bwd(ctx.layout, hc, msg_w, da.float())
        dh = (dh1.float() + dh2.float()).to(ctx.h_dtype)
        return (dh, dW, dbm, dwa.to(w_a.dtype), db3.to(w_a.dtype),
                duzr.to(u_zr.dtype), duh.to(uh.dtype), None, None, None)


def default_layouts(cfg: ModelConfig, n_nodes: int, device, edge_src,
                    edge_dst, edge_type, edge_mask, type_offsets=None,
                    scatter_layout=None, tiles_layout: dict | None = None):
    """The layouts the backend's step reads, (scatter_layout,
    tiles_layout), each built from the edges where none is passed: for
    ``onehot`` the reference's default legacy layout over ``n_nodes`` rows
    (built on the host), for ``pallas`` the type tiles packed from
    ``type_offsets`` (or the counts of the edges with mask > 0 per type).
    A host-form legacy or window layout is moved to ``device``.  Layouts
    are topology only: :func:`propagate` makes them once for its T steps,
    ``ggsnn_forward`` once for its K rounds."""
    if cfg.backend == "onehot" and scatter_layout is None:
        scatter_layout = build_dst_block_layout(
            edge_src.cpu().numpy(), edge_dst.cpu().numpy(),
            edge_type.cpu().numpy(), edge_mask.cpu().numpy(), n_nodes)
    if isinstance(scatter_layout, (DstBlockLayout, DeviceWindowLayout)):
        scatter_layout = scatter_layout.to(device)
    if cfg.backend == "pallas" and tiles_layout is None:
        if type_offsets is None:
            type_offsets = spmm.type_offsets_from_mask(
                edge_type, edge_mask, cfg.n_message_types)
        tiles_layout = spmm.pack_type_tiles(edge_src, edge_dst, edge_type,
                                            edge_mask, type_offsets,
                                            cfg.n_message_types)
    return scatter_layout, tiles_layout


def propagate(prop: dict, cfg: ModelConfig, annotations, edge_src, edge_dst,
              edge_type, edge_mask, h0=None, collect_states: bool = False,
              type_offsets=None, scatter_layout=None,
              tiles_layout: dict | None = None):
    """Run T propagation steps from ``h0`` [N, D] f32 (None: the padded
    annotations, :func:`init_state`); returns the final h [N, D] f32 (and,
    with ``collect_states``, the per-step states stacked to [T, N, D]).
    Every backend's step returns h's gradient, so one that ``h0`` asks
    for reaches it (under ``cfg.remat`` too).

    ``scatter_layout`` for ``backend='onehot'``, as the reference takes it:

    - a typed pack (:func:`~ggnn_tpu_torch.ops.scatter.
      build_typed_dst_layout`, on the device), fused or not; training needs
      it built ``with_grad=True``;
    - a legacy layout (:func:`~ggnn_tpu_torch.ops.legacy.layout_for_batch`,
      or a :class:`~ggnn_tpu_torch.ops.legacy.DstBlockLayout`, moved to h's
      device here), always unfused: ``fuse_gru`` warns, as the reference;
    - a list of chunked legacy layouts (:func:`~ggnn_tpu_torch.ops.legacy.
      build_chunked_dst_layouts`), forward only, unfused;
    - None: the reference's default, the legacy layout built here from the
      edges over h's rows (a multiple of 128), in type order with 128-edge
      tiles and no grad half (its backward sums over ``dst_global``).

    ``scatter_layout`` for ``backend='window'``: a
    :class:`~ggnn_tpu_torch.ops.window.DeviceWindowLayout` (host or device
    form; moved to h's device here), required as in the reference.  Fused
    steps go to ``gru_window_step`` (``quantized=cfg.quantized_table``),
    unfused ones to ``aggregate_window`` then the GRU cell.  Gradients need
    a layout built ``with_grad=True`` (and, fused, N and D multiples of
    128); the q8 table is forward only.

    ``backend='pallas'``: ``tiles_layout`` (a :func:`~ggnn_tpu_torch.ops.
    spmm.pack_type_tiles` dict) or, without it, the layout packed here once
    from ``type_offsets`` (the batch's, or the counts of edges with mask > 0
    per type when None).

    ``cfg.remat`` recomputes each step in the backward
    (``torch.utils.checkpoint``) instead of keeping its residuals, except
    with ``collect_states``, as the reference does."""
    h = init_state(annotations, cfg.state_dim) if h0 is None else h0
    scatter_layout, tiles_layout = default_layouts(
        cfg, h.shape[0], h.device, edge_src, edge_dst, edge_type, edge_mask,
        type_offsets, scatter_layout, tiles_layout)
    fused = fuse_gru(prop["gru"])
    uh = prop["gru"]["uh"]
    cdt = torch_dtype(cfg.compute_dtype)
    msg_w_c = prop["msg_w"].to(cdt)
    msg_b_c = prop["msg_b"].to(cdt)
    gmm = cdt if (cfg.gru_matmul_compute and cdt != torch.float32) else None
    if cfg.edge_gates and cfg.backend in ("onehot", "window"):
        warnings.warn(
            f"edge_gates are not applied with backend={cfg.backend!r}: its "
            "layouts carry no per-edge gate, so the step aggregates "
            "ungated, as the reference does", stacklevel=2)

    def gate_features(h):
        """p = h·P and q = h·Q, f32 products of the f32 state."""
        return (h.float() @ prop["gate_p"].float(),
                h.float() @ prop["gate_q"].float())

    def edge_gate(h):
        """The SDDMM edge gates σ(⟨h_u·P, h_v·Q⟩) folded into the edge
        mask (the reference's ``edge_gate``)."""
        if not cfg.edge_gates:
            return edge_mask
        p, q = gate_features(h)
        return edge_mask * torch.sigmoid(sddmm(p, q, edge_src, edge_dst,
                                               edge_mask))

    if cfg.backend == "onehot":
        if isinstance(scatter_layout, (list, tuple)):
            chunks = list(scatter_layout)

            def step(h):
                a = aggregate_onehot_chunked(h.to(cdt), chunks, msg_w_c,
                                             msg_b_c)
                return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
        else:
            layout = scatter_layout
            if cfg.fuse_gru and layout.typed:
                # gate matmuls in the compute dtype on this path, whatever
                # gru_matmul_compute says (as the reference)
                mdt_f = cdt if cdt != torch.float32 else None

                def step(h):
                    args = (h, msg_w_c, msg_b_c, *fused, uh)
                    if not takes_grad(*args):
                        # serving (#2), also under torch.no_grad with
                        # trainable parameters
                        return typed_fused_step(layout, *args, cdt)
                    return TypedFusedStep.apply(*args, layout, mdt_f,
                                                cfg.lean_residuals)
            else:
                if cfg.fuse_gru:
                    # as the reference: a fuse request never silently
                    # measures the unfused path
                    warnings.warn(
                        "fuse_gru requested with backend='onehot' but the "
                        "scatter layout is not a typed pack (legacy "
                        "table-gather / chunked layouts cannot fuse); "
                        "running the UNFUSED step. Build the layout with "
                        "build_typed_dst_layout(...) to fuse.", stacklevel=2)

                def step(h):
                    a = aggregate_onehot(h.to(cdt), layout, msg_w_c, msg_b_c)
                    return gru_update(prop["gru"], h, a, fused,
                                      matmul_dtype=gmm)
    elif cfg.backend == "window":
        if scatter_layout is None:
            raise ValueError(
                "backend='window' needs a precomputed layout: "
                "build_window_layout(...) (or window_layout_for_batch), "
                "passed as scatter_layout")
        layout = scatter_layout
        if cfg.fuse_gru:
            def step(h):
                return gru_window_step(h, layout, msg_w_c, msg_b_c,
                                       prop["gru"],
                                       quantized=cfg.quantized_table)
        else:
            def step(h):
                a = aggregate_window(h.to(cdt), layout, msg_w_c, msg_b_c)
                return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
    elif cfg.backend == "pallas":
        layout = tiles_layout

        def packed_gate(h):
            if not cfg.edge_gates:
                return None
            p, q = gate_features(h)
            score = EdgeScore.apply(p, q, layout["src"], layout["dst"], None)
            return layout["mask"] * torch.sigmoid(score)

        def step(h):
            a = spmm.typed_aggregate_tiled(h.to(cdt), layout, msg_w_c,
                                           msg_b_c, mask=packed_gate(h))
            return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
    else:
        def step(h):
            a = typed_aggregate(h.to(cdt), edge_src, edge_dst, edge_type,
                                edge_gate(h), msg_w_c, msg_b_c,
                                strategy=cfg.agg_strategy)
            return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)

    if cfg.remat and not collect_states:
        plain_step = step

        def step(h):
            return torch.utils.checkpoint.checkpoint(plain_step, h,
                                                     use_reentrant=False)

    states = []
    for _ in range(cfg.n_steps):
        h = step(h)
        if collect_states:
            states.append(h)
    if collect_states:
        return h, torch.stack(states)
    return h
