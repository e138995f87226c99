"""Plain typed aggregation: the ``xla`` backend and the ground truth for
the one-hot kernels.  Counterpart of ``ggnn_tpu/ops/segment.py``.

a[v] = Σ over directed edges (u, t, v): h[u]·msg_w[t] + msg_b[t], with two
strategies of the same math:

- ``node_transform``: every node's state times every message type (one
  einsum), then a per-edge gather;
- ``edge_gather``: per-edge weight matrices, contracted per edge.

Products are taken in f32 from inputs in the compute dtype (bf16·bf16 is
exact in f32) and the scatter is the fixed-order f32 segment sum of
``ops/segment_rows.py`` (the gathers' backwards too), so a step gives the
same bits on every run.

:func:`sddmm` gives the per-edge scores of the SDDMM edge gates through
kernel #17 (``ops/spmm.py::sddmm_pallas``), reading p and q by the edge
indices, with a plain backward (:class:`EdgeScore`).
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import spmm
from ggnn_tpu_torch.ops import segment_rows as SR
from ggnn_tpu_torch.ops.segment_rows import (gather_rows, pair_rows,
                                             segment_sum)


def typed_aggregate(h, edge_src, edge_dst, edge_type, edge_mask, msg_w,
                    msg_b, strategy: str = "node_transform"):
    """h [N, D]; edge_src/dst/type [E] int; edge_mask [E] float (1 real,
    0 padding); msg_w [T2, D, D]; msg_b [T2, D].  Returns [N, D] f32;
    padding edges contribute exactly 0."""
    n_pad, D = h.shape
    if strategy == "node_transform":
        transformed = (torch.einsum("nd,tdf->tnf", h.float(), msg_w.float())
                       + msg_b.float()[:, None, :])
        messages = gather_rows(transformed.reshape(-1, D),
                               pair_rows(edge_type, edge_src, n_pad))
    elif strategy == "edge_gather":
        T2 = msg_w.shape[0]
        w_e = gather_rows(msg_w.reshape(T2, -1), edge_type).reshape(-1, D, D)
        messages = (torch.einsum("ed,edf->ef",
                                 gather_rows(h, edge_src).float(),
                                 w_e.float())
                    + gather_rows(msg_b, edge_type).float())
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    messages = messages * edge_mask.float()[:, None]
    return segment_sum(messages, edge_dst, n_pad)


class EdgeScore(torch.autograd.Function):
    """score_e = ⟨p[src_e], q[dst_e]⟩ (· mask_e) through #17.  It saves p,
    q and the indices, never the gathered rows, and regathers them in the
    backward: dp[u] = Σ_{e: src_e = u} ḡ_e·mask_e·q[dst_e], dq likewise
    over dst (f32 sums in a fixed order, ``segment_rows_sum``), and, when
    the mask asks for one, dmask_e = ḡ_e·⟨p[src_e], q[dst_e]⟩ (#17 with a
    mask of ones), as ``jax.grad`` of the reference's ``sddmm``."""

    @staticmethod
    def forward(ctx, p, q, src, dst, mask):
        ctx.save_for_backward(p, q, src, dst, mask)
        return spmm.sddmm_pallas(p, q, src=src, dst=dst, mask=mask)

    @staticmethod
    def backward(ctx, g):
        p, q, src, dst, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        w = g.float() if mask is None else g.float() * mask.float()
        dp = dq = dmask = None
        if need[0]:
            dp = SR.segment_rows_sum(w[:, None] * q.index_select(0, dst),
                                     src, p.shape[0]).to(p.dtype)
        if need[1]:
            dq = SR.segment_rows_sum(w[:, None] * p.index_select(0, src),
                                     dst, q.shape[0]).to(q.dtype)
        if need[4]:
            dmask = (g.float() * spmm.sddmm_pallas(p, q, src=src, dst=dst)
                     ).to(mask.dtype)
        return dp, dq, None, None, dmask


def sddmm(h_src_feat, h_dst_feat, edge_src, edge_dst, edge_mask):
    """Sampled dense-dense matmul: per-edge scores ⟨p[src], q[dst]⟩ times
    the edge mask → [E] f32 (the reference's ``sddmm``; the SDDMM edge
    gates' scores), through kernel #17 without gathering the rows."""
    return EdgeScore.apply(h_src_feat, h_dst_feat, edge_src, edge_dst,
                           edge_mask)


class SegmentMax(torch.autograd.Function):
    """The max of each segment (``scatter_reduce`` 'amax' into −inf), with
    autograd's gradient for it (split evenly among the entries that reach
    the max) but the ties counted in int64, exactly: autograd's backward
    counts them by a float ``scatter_add``."""

    @staticmethod
    def forward(ctx, vals, seg, num_segments):
        init = torch.full((num_segments,), float("-inf"), dtype=vals.dtype,
                          device=vals.device)
        out = init.scatter_reduce(0, seg, vals, "amax")
        ctx.save_for_backward(vals, seg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, seg, out = ctx.saved_tensors
        at_max = vals == out.index_select(0, seg)
        count = (out == float("-inf")).long().index_add_(
            0, seg, at_max.long())
        share = g / count.to(g.dtype)
        return torch.where(at_max, share.index_select(0, seg),
                           torch.zeros_like(vals)), None, None


def masked_segment_max(scores, segment_ids, num_segments: int, mask):
    """(scores with padding entries (mask 0) at the dtype's lowest value,
    the max of each segment; −inf for a segment with no entry)."""
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask > 0, scores, torch.full_like(scores, neg))
    return masked, SegmentMax.apply(masked, segment_ids.long(), num_segments)


def _segment_shift(scores, segment_ids, num_segments: int, mask):
    """(shifted scores, exp of them, normalizer) per segment: padding
    entries sit at the dtype's lowest value and add nothing to the
    normalizer.

    The normalizer and the shift's gradient are summed in f64, in a fixed
    order (``ops/segment_rows.py``), and rounded once: a graph's nodes
    (10^6 in one segment) summed in the order of the card's atomics changed
    the last bits of the softmax's sum and of the shift's gradient (0 where
    only real entries are read) from run to run.  The shifted scores keep
    their values (the f64 difference of two f32 values, rounded once)."""
    neg = torch.finfo(scores.dtype).min
    valid = mask > 0
    masked, seg_max = masked_segment_max(scores, segment_ids, num_segments,
                                         mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    shifted = torch.where(
        valid, (masked.double() - gather_rows(seg_max.double(), segment_ids)
                ).to(scores.dtype),
        torch.full_like(scores, neg))
    expd = torch.exp(shifted) * valid
    denom = segment_sum(expd.double(), segment_ids, num_segments)
    return shifted, expd, denom.to(scores.dtype).clamp_min(1e-30)


def segment_softmax(scores, segment_ids, num_segments: int, mask):
    """Numerically stable softmax within segments (per graph over nodes);
    padding entries (mask 0) get probability 0 and do not affect the
    normalizer.  Counterpart of ``ggnn_tpu/ops/segment.py``."""
    _, expd, denom = _segment_shift(scores, segment_ids, num_segments, mask)
    return expd / gather_rows(denom, segment_ids)


def segment_log_softmax(scores, segment_ids, num_segments: int, mask):
    """log of :func:`segment_softmax` without the intermediate division."""
    shifted, _, denom = _segment_shift(scores, segment_ids, num_segments,
                                       mask)
    return shifted - gather_rows(torch.log(denom), segment_ids)
