"""Plain typed aggregation: the ``xla`` backend and the ground truth for
the one-hot kernels.  Counterpart of ``ggnn_tpu/ops/segment.py``.

a[v] = Σ over directed edges (u, t, v): h[u]·msg_w[t] + msg_b[t], with two
strategies of the same math:

- ``node_transform``: every node's state times every message type (one
  einsum), then a per-edge gather;
- ``edge_gather``: per-edge weight matrices, contracted per edge.

Products are taken in f32 from inputs in the compute dtype (bf16·bf16 is
exact in f32) and the scatter is ``index_add_`` in f32.
"""

from __future__ import annotations

import torch


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
    out = torch.zeros(n_pad, D, dtype=torch.float32, device=h.device)
    return out.index_add_(0, dst, messages)


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
    normalizer."""
    neg = torch.finfo(scores.dtype).min
    valid = mask > 0
    seg = segment_ids.long()
    masked, seg_max = masked_segment_max(scores, seg, num_segments, mask)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    shifted = torch.where(valid, masked - seg_max[seg],
                          torch.full_like(scores, neg))
    expd = torch.exp(shifted) * valid
    denom = torch.zeros(num_segments, dtype=scores.dtype,
                        device=scores.device).index_add(0, seg, expd)
    return shifted, expd, denom.clamp_min(1e-30)


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
