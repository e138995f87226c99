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
