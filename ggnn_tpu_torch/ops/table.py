"""The node-transform table: h·W_t + b_t for every node and message type.

Counterpart of ``ggnn_tpu/ops/window_pallas.py``'s
:func:`node_table_block_major`, :func:`node_table_block_major_q8` and
``_node_table``.  The legacy table-gather aggregation (``ops/legacy.py``)
gathers its messages from this table; the window backend
(``ops/window_step.py``) reads its windows.

- :func:`node_table_block_major` wraps the CUDA kernel
  ``csrc/node_table.cu`` (the port of ``_table_block_kernel``): rows in
  block-major order, row (i·T2 + t)·128 + s = h[i·128 + s]·W_t + b_t, f32
  sums rounded once to h's dtype.  The reference falls back to XLA for
  weight banks over 6 MB (a VMEM limit of the TPU); the kernel takes every
  size and any width D.  In bf16 it is persistent: a CTA keeps a source
  block's rows in shared memory while W_t streams through a ring, type
  after type.
- :func:`node_table` is ``_node_table``: the block-major kernel for
  ``'block'``, and the ``'type'`` (row t·N + v) and ``'src'`` (row v·T2 + t)
  orders as plain einsums, as the reference computes them outside Pallas.
- :func:`node_table_block_major_q8` wraps ``csrc/node_table_q8.cu`` (the
  port of ``_table_block_q8_kernel``): the same rows quantized to int8 with
  one power-of-2 scale per window of ``window / 128`` types (the window
  backend's q8 serving table).  In bf16 at D = 128 a cluster of
  ``window / 128`` CTAs (up to 8) computes a window, each its own type,
  and they exchange the window's max through distributed shared memory.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import BLOCK, _DTYPE_CODE, _check_cuda_args


def _check_table_args(name, h, msg_w, msg_b):
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be [N, D], got {tuple(h.shape)}")
    N, D = h.shape
    if msg_w.dim() != 3 or tuple(msg_w.shape[1:]) != (D, D):
        raise ValueError(f"{name}: msg_w {tuple(msg_w.shape)} is not "
                         f"[T2, D, D] with h's D = {D}: the weights do not "
                         f"belong to this h")
    if tuple(msg_b.shape) != (msg_w.shape[0], D):
        raise ValueError(f"{name}: msg_b {tuple(msg_b.shape)} is not "
                         f"[T2, D] = [{msg_w.shape[0]}, {D}]: the bias does "
                         f"not belong to msg_w")
    if not (h.dtype == msg_w.dtype == msg_b.dtype):
        raise ValueError(f"{name}: h, msg_w and msg_b must share the compute "
                         f"dtype, got {h.dtype}, {msg_w.dtype}, "
                         f"{msg_b.dtype}")
    if N % BLOCK:
        raise ValueError(f"{name} needs N % {BLOCK} == 0, got N = {N}")


def node_table_block_major_reference(h, msg_w, msg_b):
    """Plain version of :func:`node_table_block_major`: the f32 products
    and bias, permuted to block-major rows, rounded once to h's dtype."""
    N, D = h.shape
    T2 = msg_w.shape[0]
    t = (torch.einsum("nd,tdf->ntf", h.float(), msg_w.float())
         + msg_b.float()[None])
    return (t.reshape(N // BLOCK, BLOCK, T2, D).transpose(1, 2)
            .reshape(-1, D).to(h.dtype))


def node_table_block_major(h, msg_w, msg_b):
    """The node-transform table in block-major row order: row
    (i·T2 + t)·128 + s holds h[i·128 + s]·W_t + b_t, summed in f32 with the
    bias and rounded once to h's dtype → [N·T2, D].

    ``h`` [N, D] (N % 128 == 0), ``msg_w`` [T2, D, D] and ``msg_b``
    [T2, D], all in the compute dtype.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/node_table.cu`` or raises."""
    name = "node_table_block_major"
    _check_table_args(name, h, msg_w, msg_b)
    if h.device.type == "cpu":
        return node_table_block_major_reference(h, msg_w, msg_b)
    if h.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {h.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    N, D = h.shape
    T2 = msg_w.shape[0]
    _check_cuda_args(name, [("h", h), ("msg_w", msg_w), ("msg_b", msg_b)], D,
                     any_width=True)
    out = torch.empty(N * T2, D, dtype=h.dtype, device=h.device)
    p = _build.ptr
    _build.launch(_build.library().ggnn_node_table, name, h.device,
                  _DTYPE_CODE[h.dtype], p(h), p(msg_w), p(msg_b), N // BLOCK,
                  D, T2, p(out))
    node_table_block_major.launches += 1
    return out


node_table_block_major.launches = 0


def node_table(h, msg_w, msg_b, row_order: str):
    """The table in the row order a layout was built for (the reference's
    ``_node_table``): 'block' through :func:`node_table_block_major`;
    'type' (row t·N + v) and 'src' (row v·T2 + t) as f32 einsums with the
    bias, rounded once to h's dtype."""
    if row_order == "block":
        return node_table_block_major(h, msg_w, msg_b)
    D = h.shape[-1]
    spec = {"src": ("nd,tdf->ntf", (None, slice(None), slice(None))),
            "type": ("nd,tdf->tnf", (slice(None), None, slice(None)))}
    if row_order not in spec:
        raise ValueError(f"row_order must be 'block', 'type' or 'src': "
                         f"{row_order!r}")
    eq, bias_idx = spec[row_order]
    t = torch.einsum(eq, h.float(), msg_w.float())
    t += msg_b.float()[bias_idx]        # in place: the f32 table is large
    return t.reshape(-1, D).to(h.dtype)


# log2(127): the exponent e of a window makes max|v|·2^-e at most 127
_LOG2_127 = 6.9886


def _check_q8_args(name, h, msg_w, msg_b, window):
    _check_table_args(name, h, msg_w, msg_b)
    N, D = h.shape
    T2 = msg_w.shape[0]
    if N % 128 or D % 128:
        raise ValueError("q8 table needs N % 128 == 0 and D % 128 == 0")
    if window % 128 or (T2 * 128) % window:
        raise ValueError("window must be a 128-multiple dividing T2*128")


def node_table_block_major_q8_reference(h, msg_w, msg_b, window: int):
    """Plain version of :func:`node_table_block_major_q8`: the f32 table
    v = h·W_t + b_t, per window e = clip(ceil(log2(max(max|v|, 1e-30)) −
    6.9886), ±100), q = clip(round_half_even(v·2^-e), ±127)."""
    N, D = h.shape
    T2 = msg_w.shape[0]
    gtypes = window // 128
    wpb = T2 // gtypes
    v = (torch.einsum("nd,tdf->ntf", h.float(), msg_w.float())
         + msg_b.float()[None])
    v = v.reshape(N // BLOCK, BLOCK, wpb, gtypes, D).permute(0, 2, 3, 1, 4)
    m = v.abs().amax(dim=(2, 3, 4))
    e = torch.ceil(torch.log2(m.clamp_min(1e-30)) - _LOG2_127).clamp(
        -100.0, 100.0)
    q = torch.clamp(torch.round(v * torch.exp2(-e)[..., None, None, None]),
                    -127.0, 127.0).to(torch.int8)
    return q.reshape(-1, D), torch.exp2(e).reshape(-1, 1)


def node_table_block_major_q8(h, msg_w, msg_b, window: int):
    """The block-major table quantized per window: returns (table_q
    [N·T2, D] int8, scales [n_wins, 1] f32).  Window g of source block i
    holds types [g·W/128, (g+1)·W/128); its values v = h·W_t + b_t (f32
    products and bias) share one scale 2^e, e = ceil(log2(max|v|) −
    6.9886) clipped to ±100, and q = clip(round_half_even(v / 2^e), ±127).
    Scales run window-major (window i·T2·128/W + g), as ``win_of_tile``
    indexes them.

    ``h`` [N, D], ``msg_w`` [T2, D, D], ``msg_b`` [T2, D] in the compute
    dtype; N % 128 == 0, D % 128 == 0, W % 128 == 0, (T2·128) % W == 0.  A
    CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/node_table_q8.cu`` (bf16 at D = 128: a cluster of CTAs a window
    up to 8 types, else the products twice; D = 128·P in P column panels)
    or raises."""
    name = "node_table_block_major_q8"
    _check_q8_args(name, h, msg_w, msg_b, window)
    if h.device.type == "cpu":
        return node_table_block_major_q8_reference(h, msg_w, msg_b, window)
    if h.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {h.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    N, D = h.shape
    T2 = msg_w.shape[0]
    _check_cuda_args(name, [("h", h), ("msg_w", msg_w), ("msg_b", msg_b)], D,
                     wide=True)
    out = torch.empty(N * T2, D, dtype=torch.int8, device=h.device)
    scales = torch.empty(N * T2 // window, 1, dtype=torch.float32,
                         device=h.device)
    p = _build.ptr
    _build.launch(_build.library().ggnn_node_table_q8, name, h.device,
                  _DTYPE_CODE[h.dtype], p(h), p(msg_w), p(msg_b), N // BLOCK,
                  T2, window // 128, D // 128, p(out), p(scales))
    node_table_block_major_q8.launches += 1
    return out, scales


node_table_block_major_q8.launches = 0
