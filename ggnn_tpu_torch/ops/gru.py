"""GRU cell forward: the CUDA kernel and its plain PyTorch version.

Counterpart of ``ggnn_tpu/ops/gru_pallas.py::gru_cell_fwd``.  The kernel
(``csrc/gru_cell.cu``) runs the whole cell in one pass per 128-row block and
returns ``(h', z, r, h̃)`` with the residual gates in the matmul dtype, as
the TPU kernel does; serving uses only ``h'``.  The backward kernel comes
with training.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import _build

KERNEL_WIDTH = 128      # the state width D the CUDA kernels take
BLOCK = 128             # rows per CTA
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _mm(x, w, mdt):
    """x·w with inputs rounded to ``mdt`` (when given) and f32 products and
    accumulation; bf16·bf16 products are exact in f32."""
    if mdt is not None:
        x, w = x.to(mdt), w.to(mdt)
    return x.float() @ w.float()


def gru_cell_fwd_reference(h, a, w_a, b_all, u_zr, uh, mdt=torch.bfloat16):
    """Plain version of :func:`gru_cell_fwd` (same rounding points).  With
    ``mdt=None`` the matmuls take their inputs as given and the residuals
    stay f32: the plain cell of a model whose GRU runs outside the kernel."""
    D = h.shape[-1]
    pa = _mm(a, w_a, mdt) + b_all.reshape(1, -1).float()
    ph = _mm(h, u_zr, mdt)
    z = torch.sigmoid(pa[:, :D] + ph[:, :D])
    r = torch.sigmoid(pa[:, D:2 * D] + ph[:, D:])
    htil = torch.tanh(pa[:, 2 * D:] + _mm(r * h, uh, mdt))
    out = (1.0 - z) * h + z * htil
    if mdt is None:
        return out.to(h.dtype), z, r, htil
    return out.to(h.dtype), z.to(mdt), r.to(mdt), htil.to(mdt)


def _check_cuda_args(name, tensors, D):
    dev = tensors[0][1].device
    for arg, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if D != KERNEL_WIDTH:
        raise ValueError(f"{name}: the CUDA kernel takes D={KERNEL_WIDTH}, "
                         f"got D={D} (other widths: ROADMAP Queue 2)")


def gru_cell_fwd(h, a, w_a, b_all, u_zr, uh, mdt=torch.bfloat16):
    """One fused GRU pass: returns ``(h' f32, z, r, h̃)`` with the gates in
    ``mdt``.  ``h``, ``a`` [N, D] f32 with N % 128 == 0; ``w_a`` [D, 3D],
    ``u_zr`` [D, 2D], ``uh`` [D, D] (cast to ``mdt``); ``b_all`` [3D].

    A CPU tensor takes :func:`gru_cell_fwd_reference`; a CUDA tensor
    launches the kernel or raises."""
    if h.device.type == "cpu":
        return gru_cell_fwd_reference(h, a, w_a, b_all, u_zr, uh, mdt)
    N, D = h.shape
    if N % BLOCK:
        raise ValueError(f"gru_cell_fwd needs N % {BLOCK} == 0, got {N}")
    if mdt not in _DTYPE_CODE:
        raise ValueError(f"gru_cell_fwd: mdt {mdt} not in {list(_DTYPE_CODE)}")
    if h.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError("gru_cell_fwd: h and a must be float32")
    if a.shape != h.shape:
        raise ValueError(f"gru_cell_fwd: a {tuple(a.shape)} vs h "
                         f"{tuple(h.shape)}")
    w_a, u_zr, uh = (w.to(mdt).contiguous() for w in (w_a, u_zr, uh))
    b3 = b_all.reshape(-1).float().contiguous()
    if (w_a.shape != (D, 3 * D) or u_zr.shape != (D, 2 * D)
            or uh.shape != (D, D) or b3.shape != (3 * D,)):
        raise ValueError("gru_cell_fwd: weight shapes do not match D")
    _check_cuda_args("gru_cell_fwd", [("h", h), ("a", a), ("w_a", w_a),
                                      ("b_all", b3), ("u_zr", u_zr),
                                      ("uh", uh)], D)
    out = torch.empty_like(h)
    z, r, htil = (torch.empty((N, D), dtype=mdt, device=h.device)
                  for _ in range(3))
    _build.launch(
        _build.library().ggnn_gru_cell, "gru_cell_fwd", h.device,
        _DTYPE_CODE[mdt], h.data_ptr(), a.data_ptr(), w_a.data_ptr(),
        b3.data_ptr(), u_zr.data_ptr(), uh.data_ptr(), out.data_ptr(),
        z.data_ptr(), r.data_ptr(), htil.data_ptr(), N // BLOCK)
    gru_cell_fwd.launches += 1
    return out, z, r, htil


gru_cell_fwd.launches = 0
