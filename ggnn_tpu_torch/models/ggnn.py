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
and ``onehot`` through the typed-pack CUDA kernels (per block, or per tile
where block mode declines), fused (GRU in the kernel's epilogue) or not.
The other backends raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.init import torch_dtype
from ggnn_tpu_torch.ops.gru import (_mm, gru_cell_bwd, gru_cell_fwd,
                                    gru_cell_fwd_reference)
from ggnn_tpu_torch.ops.scatter import (BLOCK_N, ScatterLayout,
                                        aggregate_bwd, aggregate_forward,
                                        aggregate_onehot, bias_rows,
                                        block_args, build_typed_dst_layout,
                                        grad_meta, tile_args,
                                        typed_block_step_gru, typed_step_gru)
from ggnn_tpu_torch.ops.segment import typed_aggregate


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
    (``ggnn.py::_typed_fused_step``).

    Serving (no input needs a gradient) launches the fused kernel
    (:func:`typed_fused_step`).  Under grad the forward is the reference's
    fwd rule: the aggregation through the typed block kernel, then the
    PLAIN GRU math with matmul inputs in ``mdt``; it saves the full
    residuals (h, a, z, r, h̃ narrow) or, with ``lean``, only (h, a) and
    recomputes the gates in the backward.  The backward is the plain GRU
    backward plus :func:`aggregate_bwd` (the grad-octet kernel); it never
    runs the GRU-cell kernels."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, w_a, b_all, u_zr, uh, layout, mdt,
                lean):
        if not any(ctx.needs_input_grad[:7]):
            cdt = msg_w.dtype
            return typed_fused_step(layout, h, msg_w, msg_b, w_a, b_all,
                                    u_zr, uh, cdt)
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


def _unported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               "Queue 1 and Queue 2)")


def propagate(prop: dict, cfg: ModelConfig, annotations, edge_src, edge_dst,
              edge_type, edge_mask, collect_states: bool = False,
              scatter_layout=None):
    """Run T propagation steps; returns the final h [N, D] f32 (and, with
    ``collect_states``, the per-step states stacked to [T, N, D]).

    ``scatter_layout`` is a device :class:`ScatterLayout` from
    :func:`build_typed_dst_layout` for ``backend='onehot'`` (built here from
    the edges when None, with its grad half when grad mode is on); training
    needs it built ``with_grad=True``.  ``cfg.remat`` recomputes each step
    in the backward (``torch.utils.checkpoint``) instead of keeping its
    residuals, except with ``collect_states``, as the reference does."""
    if cfg.edge_gates:
        raise _unported("edge_gates (the SDDMM gates)")
    h = init_state(annotations, cfg.state_dim)
    fused = fuse_gru(prop["gru"])
    uh = prop["gru"]["uh"]
    cdt = torch_dtype(cfg.compute_dtype)
    msg_w_c = prop["msg_w"].to(cdt)
    msg_b_c = prop["msg_b"].to(cdt)
    gmm = cdt if (cfg.gru_matmul_compute and cdt != torch.float32) else None

    if cfg.backend == "onehot":
        if isinstance(scatter_layout, (list, tuple)):
            raise _unported("the chunked onehot layout")
        if scatter_layout is None:
            scatter_layout = build_typed_dst_layout(
                edge_src.cpu().numpy(), edge_dst.cpu().numpy(),
                edge_type.cpu().numpy(), edge_mask.cpu().numpy(),
                -(-h.shape[0] // BLOCK_N) * BLOCK_N,
                cfg.n_message_types,
                with_grad=torch.is_grad_enabled()).to(h.device)
        if cfg.fuse_gru:
            # gate matmuls in the compute dtype on this path, whatever
            # gru_matmul_compute says (as the reference)
            mdt_f = cdt if cdt != torch.float32 else None

            def step(h):
                return TypedFusedStep.apply(h, msg_w_c, msg_b_c, *fused, uh,
                                            scatter_layout, mdt_f,
                                            cfg.lean_residuals)
        else:
            def step(h):
                a = aggregate_onehot(h.to(cdt), scatter_layout, msg_w_c,
                                     msg_b_c)
                return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
    elif cfg.backend == "xla":
        def step(h):
            a = typed_aggregate(h.to(cdt), edge_src, edge_dst, edge_type,
                                edge_mask, msg_w_c, msg_b_c,
                                strategy=cfg.agg_strategy)
            return gru_update(prop["gru"], h, a, fused, matmul_dtype=gmm)
    else:
        raise _unported(f"backend={cfg.backend!r}")

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
