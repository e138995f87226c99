"""GGNN propagation: T steps of typed messages + GRU.

Counterpart of ``ggnn_tpu/models/ggnn.py`` for serving, with a Python loop
in place of ``lax.scan`` and the same dtype decisions:

- aggregation runs in ``cfg.compute_dtype`` (bf16 halves the gather's
  bytes) with f32 accumulation; the state h stays f32;
- the GRU's matmul inputs follow the compute dtype when
  ``cfg.gru_matmul_compute`` (gates and state stay f32);
- the fused onehot step casts its gate matmul inputs to the compute dtype
  whatever ``gru_matmul_compute`` says, as the reference does.

Backends: ``xla`` (plain :func:`ggnn_tpu_torch.ops.segment.typed_aggregate`)
and ``onehot`` through the typed-block CUDA kernel, fused (GRU in the
kernel's epilogue) or not.  The other backends raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ggnn_tpu_torch.models.config import ModelConfig
from ggnn_tpu_torch.models.init import torch_dtype
from ggnn_tpu_torch.ops.gru import gru_cell_fwd, gru_cell_fwd_reference
from ggnn_tpu_torch.ops.scatter import (BLOCK_N, ScatterLayout,
                                        aggregate_onehot, bias_rows,
                                        block_args, build_typed_dst_layout,
                                        typed_block_step_gru)
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
    D % 128 == 0 the cell goes to :func:`gru_cell_fwd`, which on the card
    launches the GRU-cell kernel or raises (as the reference runs its
    Pallas cell); otherwise the plain cell."""
    if fused is None:
        fused = fuse_gru(gru)
    w_a, b_all, u_zr = fused
    N, D = h.shape
    cell = (gru_cell_fwd if matmul_dtype is not None and N % 128 == 0
            and D % 128 == 0 else gru_cell_fwd_reference)
    return cell(h, a, w_a, b_all, u_zr, gru["uh"], mdt=matmul_dtype)[0]


def typed_fused_step(layout: ScatterLayout, h, msg_w, msg_b, w_a, b_all,
                     u_zr, uh, cdt):
    """One fused typed-pack step (aggregation + GRU in the kernel's
    epilogue): the ``h_pack`` gather and the bias stay torch ops."""
    kw = block_args(layout)
    N = h.shape[0]
    n_rows = kw["n_blocks"] * BLOCK_N
    h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
    h_pad = F.pad(h.float(), (0, 0, 0, n_rows - N))
    out = typed_block_step_gru(
        h_pack, kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"),
        msg_w.to(cdt), bias_rows(layout, msg_b), h_pad, w_a.to(cdt),
        b_all[None, :].float(), u_zr.to(cdt), uh.to(cdt), **kw)
    return out[:N]


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
    the edges when None)."""
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
                cfg.n_message_types).to(h.device)
        if cfg.fuse_gru:
            def step(h):
                return typed_fused_step(scatter_layout, h, msg_w_c, msg_b_c,
                                        *fused, uh, cdt)
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

    states = []
    for _ in range(cfg.n_steps):
        h = step(h)
        if collect_states:
            states.append(h)
    if collect_states:
        return h, torch.stack(states)
    return h
