"""GRU cell forward and backward: the CUDA kernels and their plain PyTorch
versions.

Counterpart of ``ggnn_tpu/ops/gru_pallas.py``.  The forward kernel
(``csrc/gru_cell.cu``; bf16 at D = 128 ``csrc/gru_cell_pipe.cu``) runs the
whole cell in one pass over the rows and returns ``(h', z, r, h̃)`` with
the residual gates in the matmul dtype, as the TPU kernel does; serving
uses only ``h'``.  The backward kernel
(``csrc/gru_cell_bwd.cu``; bf16 at D = 128 ``csrc/gru_cell_bwd_pipe.cu``)
turns the cotangent of h' and those residuals into dh, da and the
parameter gradients.
"""

from __future__ import annotations

import torch

from ggnn_tpu_torch.ops import _build

KERNEL_WIDTH = 128      # the state width D the CUDA kernels are written for
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


def kernel_width(D: int) -> int:
    """The state width of the kernel that runs a D-wide state: 128 for
    D ≤ 128, else D rounded up to a multiple of 128 (the wide kernels'
    128-column panels)."""
    return max(KERNEL_WIDTH, -(-D // KERNEL_WIDTH) * KERNEL_WIDTH)


def pad_width(x, D: int, *, rows: bool = False, groups: int = 1):
    """x with its state columns zero-padded from D to :func:`kernel_width`
    (D), so that a CUDA kernel written for D = 128 (or for whole 128-column
    panels) runs a model of another width.

    The last axis is ``groups`` side-by-side groups of D columns (a fused
    GRU weight [D, 3D] has three), each padded on its own; with ``rows``
    the second-to-last axis (a weight's D input rows) is padded too.  The
    kernel's outputs, cut back with :func:`narrow_width`, are exactly the
    unpadded function's:

    - every padded column of h, a, the table and the cotangents, and every
      padded row and column of a weight or bias, is zero, so each product
      over D only adds exact zeros, and a padded output column is a sum of
      zeros;
    - in the GRU a padded column has z = σ(0) = ½ and h̃ = tanh(0) = 0, so
      h' = ½·0 + ½·0 = 0 there, and it feeds no real column (its weight
      rows are zero);
    - in the GRU backward the padded columns of g are zero, so dz, dq, dh
      and the gate gradients are zero there (whatever z holds), and the
      parameter gradients' padded rows and columns are sums of zeros;
    - the q8 table's per-window maximum over |values| is unchanged by zero
      columns, so its scales and int8 values are the unpadded ones."""
    Dk = kernel_width(D)
    pad = Dk - D
    if pad <= 0:
        return x
    if groups > 1:
        x = x.reshape(*x.shape[:-1], groups, D)
    x = torch.nn.functional.pad(x, (0, pad))
    if groups > 1:
        x = x.reshape(*x.shape[:-2], groups * Dk)
    if rows:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    return x.contiguous()


def narrow_width(x, D: int, *, rows: bool = False, groups: int = 1):
    """The inverse of :func:`pad_width`: the first D columns of each of
    ``groups`` column groups (and, with ``rows``, the first D rows)."""
    if x.shape[-1] == groups * D:
        return x
    if groups > 1:
        x = x.reshape(*x.shape[:-1], groups, -1)[..., :D]
        x = x.reshape(*x.shape[:-2], groups * D)
    else:
        x = x[..., :D]
    if rows:
        x = x[..., :D, :]
    return x.contiguous()


def host_ints(*scalars) -> list:
    """Integers and 0-d tensors (on one device) as Python ints, in one
    copy to the host."""
    dev = next((s.device for s in scalars if torch.is_tensor(s)), "cpu")
    return torch.stack([torch.as_tensor(s, device=dev).reshape(()).long()
                        for s in scalars]).tolist()


def _scatter_data_checks(name, tile_start, n_tiles, block_of_tile=None,
                         max_tiles=None, extra=()):
    """tile_start runs from 0, never down, to at most the stream's tiles
    (exactly its tiles with ``block_of_tile``, which must name the same
    block for every tile), and no block holds more than ``max_tiles``
    (one copy to the host, with ``extra`` 0-d tensors appended)."""
    counts = tile_start[1:] - tile_start[:-1]
    stats = [tile_start[0], tile_start[-1], counts.min(), counts.max()]
    if block_of_tile is not None:
        tiles = torch.arange(n_tiles, dtype=torch.int32,
                             device=tile_start.device)
        want = torch.searchsorted(tile_start[1:].contiguous(), tiles,
                                  right=True)
        stats.append((want != block_of_tile).sum())
    ts0, ts1, c_min, c_max, *rest = host_ints(*stats, *extra)
    if block_of_tile is not None:
        bad, *rest = rest
        if bad:
            raise ValueError(f"{name}: block_of_tile names another block "
                             f"than tile_start for {bad} tiles: layout and "
                             f"arguments disagree")
    if ts0 != 0 or c_min < 0 or ts1 > n_tiles or (
            block_of_tile is not None and ts1 != n_tiles):
        raise ValueError(f"{name}: tile_start runs from {ts0} to {ts1} "
                         f"(least count {c_min}) over a stream of {n_tiles} "
                         f"tiles: layout and arguments disagree")
    if max_tiles is not None and c_max > max_tiles:
        raise ValueError(f"{name}: a block holds {c_max} tiles, more than "
                         f"max_tiles={max_tiles}: layout and arguments "
                         f"disagree")
    return rest


def _check_cuda_args(name, tensors, D, any_width=False, wide=False):
    """Device, contiguity and alignment of every tensor, and the width D:
    128 (with ``wide`` any multiple of 128: the kernels' 128-column
    panels), or with ``any_width`` any D >= 1; D None checks the tensors
    only."""
    dev = tensors[0][1].device
    for arg, t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if D is None:
        return
    if any_width:
        if D < 1:
            raise ValueError(f"{name}: the CUDA kernel takes D >= 1, got "
                             f"D={D}")
    elif D != KERNEL_WIDTH and not (wide and D > 0
                                    and D % KERNEL_WIDTH == 0):
        want = (f"a multiple of {KERNEL_WIDTH}" if wide
                else f"D = {KERNEL_WIDTH}")
        raise ValueError(f"{name}: the CUDA kernel takes {want} (the "
                         f"wrappers zero-pad other widths), got D={D}")


def gru_cell_fwd(h, a, w_a, b_all, u_zr, uh, mdt=torch.bfloat16):
    """One fused GRU pass: returns ``(h' f32, z, r, h̃)`` with the gates in
    ``mdt``.  ``h``, ``a`` [N, D] f32 with N % 128 == 0; ``w_a`` [D, 3D],
    ``u_zr`` [D, 2D], ``uh`` [D, D] (cast to ``mdt``); ``b_all`` [3D].

    A CPU tensor takes :func:`gru_cell_fwd_reference`; a CUDA tensor
    launches the kernel (bf16 at D = 128 ``csrc/gru_cell_pipe.cu``, f32
    ``csrc/gru_cell.cu``; at D = 128·P, P > 1, ``csrc/gru_cell_wide.cu``;
    other D through :func:`pad_width`) or raises."""
    if h.device.type == "cpu":
        return gru_cell_fwd_reference(h, a, w_a, b_all, u_zr, uh, mdt)
    N, D = h.shape
    if D != kernel_width(D):
        P = lambda x, **kw: pad_width(x, D, **kw)
        out = gru_cell_fwd(P(h), P(a), P(w_a, rows=True, groups=3),
                           P(b_all.reshape(-1), groups=3),
                           P(u_zr, rows=True, groups=2), P(uh, rows=True),
                           mdt)
        return tuple(narrow_width(x, D) for x in out)
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
                                      ("uh", uh)], D, wide=True)
    out = torch.empty_like(h)
    z, r, htil = (torch.empty((N, D), dtype=mdt, device=h.device)
                  for _ in range(3))
    p = _build.ptr
    if D > KERNEL_WIDTH:        # csrc/gru_cell_wide.cu, 128-column panels
        rh = torch.empty((N, D), dtype=mdt, device=h.device)
        _build.launch(
            _build.library().ggnn_gru_cell_wide, "gru_cell_fwd", h.device,
            _DTYPE_CODE[mdt], D // KERNEL_WIDTH, p(h), p(a), p(w_a), p(b3),
            p(u_zr), p(uh), p(rh), p(out), p(z), p(r), p(htil), N // BLOCK)
        gru_cell_fwd.launches += 1
        return out, z, r, htil
    # bf16: csrc/gru_cell_pipe.cu (weights resident); f32: csrc/gru_cell.cu
    entry = "ggnn_gru_cell_pipe" if mdt == torch.bfloat16 else "ggnn_gru_cell"
    cell_launch(entry, h, a, w_a, b3, u_zr, uh, out, z, r, htil, mdt)
    gru_cell_fwd.launches += 1
    return out, z, r, htil


def cell_launch(entry, h, a, w_a, b3, u_zr, uh, out, z, r, htil, mdt):
    """Launch C entry point ``entry`` of the D = 128 GRU cell
    (``ggnn_gru_cell``, ``csrc/gru_cell.cu``, or its bf16 redesign
    ``ggnn_gru_cell_pipe``) on arguments :func:`gru_cell_fwd` has checked;
    it counts nothing (the checks on the card call the first body
    through it)."""
    p = _build.ptr
    _build.launch(getattr(_build.library(), entry), "gru_cell_fwd", h.device,
                  _DTYPE_CODE[mdt], p(h), p(a), p(w_a), p(b3), p(u_zr),
                  p(uh), p(out), p(z), p(r), p(htil), h.shape[0] // BLOCK)


def gru_cell_bwd_reference(g, h, a, z, r, htil, w_a, u_zr, uh,
                           mdt=torch.bfloat16, da_dtype=torch.float32):
    """Plain version of :func:`gru_cell_bwd` (the TPU kernel's rounding
    points): every matmul input, gate gradients included, rounded to
    ``mdt``; db summed from the f32 gate gradients (in f64, rounded once)."""
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
    # db: column sums in f64, rounded once (the same bits at any width)
    db = torch.cat([x.double().sum(0) for x in (dpz, dpr, dq)]).float()[None]
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
    launches the kernel (``csrc/gru_cell_bwd.cu``, bf16 at D = 128
    ``csrc/gru_cell_bwd_pipe.cu``; at D = 128·P, P > 1,
    ``csrc/gru_cell_wide.cu``; other D through :func:`pad_width`) or
    raises."""
    if g.device.type == "cpu":
        return gru_cell_bwd_reference(g, h, a, z, r, htil, w_a, u_zr, uh,
                                      mdt, da_dtype)
    N, D = h.shape
    if D != kernel_width(D):
        P = lambda x, **kw: pad_width(x, D, **kw)
        dh, da, dwa, db, duzr, duh = gru_cell_bwd(
            *(P(x) for x in (g, h, a, z, r, htil)),
            P(w_a, rows=True, groups=3), P(u_zr, rows=True, groups=2),
            P(uh, rows=True), mdt, da_dtype)
        return (narrow_width(dh, D), narrow_width(da, D),
                narrow_width(dwa, D, rows=True, groups=3),
                narrow_width(db, D, groups=3),
                narrow_width(duzr, D, rows=True, groups=2),
                narrow_width(duh, D, rows=True))
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
        ("w_a", w_a), ("u_zr", u_zr), ("uh", uh)], D, wide=True)
    dev, n_blocks = h.device, N // BLOCK
    lib = _build.library()
    wide = D > KERNEL_WIDTH          # csrc/gru_cell_wide.cu
    n_chunks = (lib.ggnn_gru_wide_bwd_chunks if wide
                else lib.ggnn_gru_bwd_chunks)(n_blocks)
    f32 = dict(dtype=torch.float32, device=dev)
    dh = torch.empty((N, D), **f32)
    da = torch.empty((N, D), dtype=da_dtype, device=dev)
    gates = torch.empty((3, N, D), dtype=mdt, device=dev)
    dbp = torch.empty((n_blocks, 3 * D), **f32)
    # the params kernel's split-K partials; above D = 256 the wide rows
    # kernel first keeps db's per-warp sums there (3·8 per column a block)
    ws = torch.empty(max(n_chunks * 6 * D * D, n_blocks * 24 * D), **f32)
    dwa = torch.empty((D, 3 * D), **f32)
    db = torch.empty((1, 3 * D), **f32)
    duzr = torch.empty((D, 2 * D), **f32)
    duh = torch.empty((D, D), **f32)
    p = _build.ptr
    head = ((lib.ggnn_gru_cell_bwd_wide, "gru_cell_bwd", dev,
             _DTYPE_CODE[mdt], int(da_dtype != torch.float32),
             D // KERNEL_WIDTH) if wide else
            (lib.ggnn_gru_cell_bwd, "gru_cell_bwd", dev, _DTYPE_CODE[mdt],
             int(da_dtype != torch.float32)))
    _build.launch(
        *head, p(g), p(h), p(a), p(z), p(r), p(htil), p(w_a), p(u_zr),
        p(uh), p(dh), p(da), p(gates), p(dbp), p(ws), p(dwa), p(db),
        p(duzr), p(duh), n_blocks)
    gru_cell_bwd.launches += 1
    return dh, da, dwa, db, duzr, duh


gru_cell_fwd.launches = 0
gru_cell_bwd.launches = 0
