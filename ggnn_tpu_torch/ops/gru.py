"""GRU cell forward and backward: the CUDA kernels and their plain PyTorch
versions.

Counterpart of ``ggnn_tpu/ops/gru_pallas.py``.  The forward kernel
(``csrc/gru_cell.cu``) runs the whole cell in one pass per 128-row block and
returns ``(h', z, r, h̃)`` with the residual gates in the matmul dtype, as
the TPU kernel does; serving uses only ``h'``.  The backward kernel
(``csrc/gru_cell_bwd.cu``) turns the cotangent of h' and those residuals
into dh, da and the parameter gradients.
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


def gru_cell_bwd_reference(g, h, a, z, r, htil, w_a, u_zr, uh,
                           mdt=torch.bfloat16, da_dtype=torch.float32):
    """Plain version of :func:`gru_cell_bwd` (the TPU kernel's rounding
    points): every matmul input, gate gradients included, rounded to
    ``mdt``; db summed from the f32 gate gradients."""
    D = h.shape[-1]
    g = g.float()
    h, z, r, htil = (x.float() for x in (h, z, r, htil))

    def mtm(x, y):          # xᵀ·y over the rows
        return _mm(x.t(), y, mdt)

    dz = g * (htil - h)
    dh = g * (1.0 - z)
    dq = (g * z) * (1.0 - htil * htil)
    rh = r * h
    drh = _mm(dq, uh.t(), mdt)
    dh = dh + drh * r
    dpz = dz * z * (1.0 - z)
    dpr = (drh * h) * r * (1.0 - r)
    da = (_mm(dpz, w_a[:, :D].t(), mdt) + _mm(dpr, w_a[:, D:2 * D].t(), mdt)
          + _mm(dq, w_a[:, 2 * D:].t(), mdt))
    dh = (dh + _mm(dpz, u_zr[:, :D].t(), mdt)
          + _mm(dpr, u_zr[:, D:].t(), mdt))
    dwa = torch.cat([mtm(a, dpz), mtm(a, dpr), mtm(a, dq)], dim=1)
    db = torch.cat([dpz.sum(0), dpr.sum(0), dq.sum(0)])[None, :]
    duzr = torch.cat([mtm(h, dpz), mtm(h, dpr)], dim=1)
    duh = mtm(rh, dq)
    return dh, da.to(da_dtype), dwa, db, duzr, duh


def gru_cell_bwd(g, h, a, z, r, htil, w_a, u_zr, uh, mdt=torch.bfloat16,
                 da_dtype=torch.float32):
    """GRU cell backward: returns ``(dh f32, da in da_dtype, dW_a [D, 3D],
    db [1, 3D], dU_zr [D, 2D], dU_h [D, D])``, the parameter gradients in
    f32.  ``g`` [N, D] f32 is the cotangent of h'; the residuals ``h``,
    ``a``, ``z``, ``r``, ``htil`` [N, D] are in ``mdt`` (as
    :func:`gru_cell_fwd` and the GRU's custom backward save them); the
    weights are cast to ``mdt``.

    A CPU tensor takes :func:`gru_cell_bwd_reference`; a CUDA tensor
    launches the kernel (``csrc/gru_cell_bwd.cu``) or raises."""
    if g.device.type == "cpu":
        return gru_cell_bwd_reference(g, h, a, z, r, htil, w_a, u_zr, uh,
                                      mdt, da_dtype)
    N, D = h.shape
    if N % BLOCK:
        raise ValueError(f"gru_cell_bwd needs N % {BLOCK} == 0, got {N}")
    if mdt not in _DTYPE_CODE:
        raise ValueError(f"gru_cell_bwd: mdt {mdt} not in {list(_DTYPE_CODE)}")
    if da_dtype not in (torch.float32, mdt):
        raise ValueError(f"gru_cell_bwd: da_dtype must be float32 or {mdt}")
    if g.dtype != torch.float32:
        raise ValueError("gru_cell_bwd: g must be float32")
    for arg, t in (("h", h), ("a", a), ("z", z), ("r", r), ("htil", htil)):
        if t.dtype != mdt or tuple(t.shape) != (N, D):
            raise ValueError(f"gru_cell_bwd: residual {arg} must be "
                             f"[{N}, {D}] {mdt}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if tuple(g.shape) != (N, D):
        raise ValueError(f"gru_cell_bwd: g {tuple(g.shape)} vs h {(N, D)}")
    w_a, u_zr, uh = (w.to(mdt).contiguous() for w in (w_a, u_zr, uh))
    if (w_a.shape != (D, 3 * D) or u_zr.shape != (D, 2 * D)
            or uh.shape != (D, D)):
        raise ValueError("gru_cell_bwd: weight shapes do not match D")
    _check_cuda_args("gru_cell_bwd", [
        ("g", g), ("h", h), ("a", a), ("z", z), ("r", r), ("htil", htil),
        ("w_a", w_a), ("u_zr", u_zr), ("uh", uh)], D)
    dev, n_blocks = h.device, N // BLOCK
    lib = _build.library()
    n_chunks = lib.ggnn_gru_bwd_chunks(n_blocks)
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((N, D), **f32)
    da = torch.empty((N, D), dtype=da_dtype, device=dev)
    gates = torch.empty((3, N, D), dtype=mdt, device=dev)
    dbp = torch.empty((n_blocks, 3 * D), **f32)
    ws = torch.empty((n_chunks, 6, D, D), **f32)
    dwa = torch.empty((D, 3 * D), **f32)
    db = torch.empty((1, 3 * D), **f32)
    duzr = torch.empty((D, 2 * D), **f32)
    duh = torch.empty((D, D), **f32)
    p = _build.ptr
    _build.launch(
        lib.ggnn_gru_cell_bwd, "gru_cell_bwd", dev, _DTYPE_CODE[mdt],
        int(da_dtype != torch.float32), p(g), p(h), p(a), p(z), p(r),
        p(htil), p(w_a), p(u_zr), p(uh), p(dh), p(da), p(gates), p(dbp),
        p(ws), p(dwa), p(db), p(duzr), p(duh), n_blocks)
    gru_cell_bwd.launches += 1
    return dh, da, dwa, db, duzr, duh


gru_cell_fwd.launches = 0
gru_cell_bwd.launches = 0
