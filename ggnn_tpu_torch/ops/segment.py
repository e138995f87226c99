"""Plain typed aggregation: the ``xla`` backend and the ground truth for
the one-hot kernels.  Counterpart of ``ggnn_tpu/ops/segment.py``.

a[v] = Σ over directed edges (u, t, v): h[u]·msg_w[t] + msg_b[t], with two
strategies of the same math:

- ``node_transform``: every node's state times every message type (one
  einsum), then a per-edge gather;
- ``edge_gather``: per-edge weight matrices, contracted per edge.

Products are taken in f32 from inputs in the compute dtype (bf16·bf16 is
exact in f32) and the scatter is ``index_add_`` in f32.

:func:`sddmm` gives the per-edge scores of the SDDMM edge gates through
kernel #17 (``ops/spmm.py::sddmm_pallas``), reading p and q by the edge
indices, with a plain backward (:class:`EdgeScore`).
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import spmm


def typed_aggregate(h, edge_src, edge_dst, edge_type, edge_mask, msg_w,
                    msg_b, strategy: str = "node_transform"):
    """h [N, D]; edge_src/dst/type [E] int; edge_mask [E] float (1 real,
    0 padding); msg_w [T2, D, D]; msg_b [T2, D].  Returns [N, D] f32;
    padding edges contribute exactly 0."""
    n_pad, D = h.shape
    src, dst, typ = edge_src.long(), edge_dst.long(), edge_type.long()
    if strategy == "node_transform":
        transformed = (torch.einsum("nd,tdf->tnf", h.float(), msg_w.float())
                       + msg_b.float()[:, None, :])
        messages = transformed[typ, src]
    elif strategy == "edge_gather":
        messages = (torch.einsum("ed,edf->ef", h[src].float(),
                                 msg_w[typ].float())
                    + msg_b[typ].float())
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    messages = messages * edge_mask.float()[:, None]
    return ScatterRows.apply(messages, dst, n_pad)


class ScatterRows(torch.autograd.Function):
    """out[v] = Σ_{e: dst_e = v} x_e (``index_add_`` into f32 zeros of
    ``n_rows`` rows).  Its backward gathers the cotangent's rows by ``dst``,
    as autograd's does, but saves the index alone: autograd's
    ``index_add`` keeps the [E, D] source alive until the backward, one
    per propagation step."""

    @staticmethod
    def forward(ctx, x, dst, n_rows):
        ctx.save_for_backward(dst)
        out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
        return out.index_add_(0, dst, x)

    @staticmethod
    def backward(ctx, g):
        (dst,) = ctx.saved_tensors
        return g.index_select(0, dst), None, None


class EdgeScore(torch.autograd.Function):
    """score_e = ⟨p[src_e], q[dst_e]⟩ (· mask_e) through #17.  It saves p,
    q and the indices, never the gathered rows, and regathers them in the
    backward: dp[u] = Σ_{e: src_e = u} ḡ_e·mask_e·q[dst_e], dq likewise
    over dst (``index_add_`` in f32).  The mask is data (the batch's edge
    mask) and takes no gradient: a mask that asks for one raises."""

    @staticmethod
    def forward(ctx, p, q, src, dst, mask):
        ctx.save_for_backward(p, q, src, dst, mask)
        return spmm.sddmm_pallas(p, q, src=src, dst=dst, mask=mask)

    @staticmethod
    def backward(ctx, g):
        p, q, src, dst, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        if need[4]:
            raise NotImplementedError(
                "sddmm: the edge mask takes no gradient")
        s, d = src.long(), dst.long()
        w = g.float() if mask is None else g.float() * mask.float()
        dp = dq = None
        if need[0]:
            dp = torch.zeros_like(p).index_add_(
                0, s, w[:, None] * q.index_select(0, d))
        if need[1]:
            dq = torch.zeros_like(q).index_add_(
                0, d, w[:, None] * p.index_select(0, s))
        return dp, dq, None, None, None


def sddmm(h_src_feat, h_dst_feat, edge_src, edge_dst, edge_mask):
    """Sampled dense-dense matmul: per-edge scores ⟨p[src], q[dst]⟩ times
    the edge mask → [E] f32 (the reference's ``sddmm``; the SDDMM edge
    gates' scores), through kernel #17 without gathering the rows."""
    return EdgeScore.apply(h_src_feat, h_dst_feat, edge_src, edge_dst,
                           edge_mask)


def masked_segment_max(scores, segment_ids, num_segments: int, mask):
    """(scores with padding entries (mask 0) at the dtype's lowest value,
    the max of each segment; −inf for a segment with no entry)."""
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(mask > 0, scores, torch.full_like(scores, neg))
    seg_max = torch.full((num_segments,), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    return masked, seg_max.scatter_reduce(0, segment_ids.long(), masked,
                                          "amax")


def _segment_shift(scores, segment_ids, num_segments: int, mask):
    """(shifted scores, exp of them, normalizer) per segment: padding
    entries sit at the dtype's lowest value and add nothing to the
    normalizer.

    The normalizer and the shift's gradient are summed in f64 and rounded
    once: an ``index_add`` in the scores' dtype adds a graph's nodes (10^6
    in one segment) in whatever order the card's atomics take, so their
    last bits, the softmax's sum and the shift's gradient (0 where only
    real entries are read) changed from run to run.  The shifted scores
    keep their values (the f64 difference of two f32 values, rounded
    once)."""
    neg = torch.finfo(scores.dtype).min
    valid = mask > 0
    seg = segment_ids.long()
    masked, seg_max = masked_segment_max(scores, seg, num_segments, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    shifted = torch.where(
        valid, (masked.double() - seg_max.double()[seg]).to(scores.dtype),
        torch.full_like(scores, neg))
    expd = torch.exp(shifted) * valid
    denom = torch.zeros(num_segments, dtype=torch.float64,
                        device=scores.device).index_add(0, seg, expd.double())
    return shifted, expd, denom.to(scores.dtype).clamp_min(1e-30)


def segment_softmax(scores, segment_ids, num_segments: int, mask):
    """Numerically stable softmax within segments (per graph over nodes);
    padding entries (mask 0) get probability 0 and do not affect the
    normalizer.  Counterpart of ``ggnn_tpu/ops/segment.py``."""
    _, expd, denom = _segment_shift(scores, segment_ids, num_segments, mask)
    return expd / denom[segment_ids.long()]


def segment_log_softmax(scores, segment_ids, num_segments: int, mask):
    """log of :func:`segment_softmax` without the intermediate division."""
    shifted, _, denom = _segment_shift(scores, segment_ids, num_segments,
                                       mask)
    return shifted - torch.log(denom)[segment_ids.long()]
