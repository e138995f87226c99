"""The ``pallas`` backend's typed SpMM and the SDDMM edge scores.

Counterpart of ``ggnn_tpu/ops/spmm_pallas.py``:

- :func:`pack_type_tiles` repacks type-sorted edges so that every
  ``tile_e`` tile holds one message type (``tiles_budget`` tiles, padding
  slots with src = dst = 0 and mask 0, masked edges dropped), in torch on
  the edges' device, array for array the reference's;
- :func:`packed_messages` wraps kernel #16 (``csrc/packed_messages.cu``,
  the port of ``_messages_kernel``): per tile of type t,
  (h[src]·W_t + b_t)·mask, f32 products of the compute dtype's values and
  f32 output.  The kernel gathers h's rows by ``src`` itself, where the
  reference gathers them with an XLA op before its kernel; in bf16 it is
  persistent, keeping W_t in shared memory across a run of one tile type
  while the next chunk's rows are gathered;
- :func:`sddmm_pallas` wraps kernel #17 (the port of ``_sddmm_kernel``):
  per edge ⟨p[src_e], q[dst_e]⟩, with optional index arrays (none: row e)
  and an optional mask; with both index arrays and G a multiple of 4 up to
  128 it runs ``csrc/sddmm_blocked.cu`` on :func:`sddmm_plan` (the edges
  grouped by src slab and dst block, made once per pair of index arrays),
  else ``csrc/sddmm.cu``;
- :func:`typed_aggregate_tiled` is ``_typed_tiled`` with its custom VJP
  (:class:`TypedTiled`): #16, then the segment sum over ``dst``; the
  backward is the reference's node-side one, with the gate gradient dmask
  recomputing the unmasked messages through #16;
- :func:`typed_aggregate_pallas` builds the layout inline.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The segment sum and the backward's Y are
f32 sums in a fixed order (``ops/segment_rows.py``), as ``ops/segment.py``
sums.
"""

from __future__ import annotations

import weakref

import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.gru import _DTYPE_CODE, _check_cuda_args, host_ints
from ggnn_tpu_torch.ops import segment_rows as SR
from ggnn_tpu_torch.ops.window import cached_per_tensor, split_plan

DEFAULT_TILE_E = 128
SDDMM_BLOCK = 128   # dst rows of a block of #17's plan (sddmm_blocked.cu)
SDDMM_ITEM = 1024   # edges of one of its work items, at most
SDDMM_SLAB_BYTES = 32 << 20   # p rows of a slab of the plan, about
SDDMM_SLAB_EDGES = 256        # edges a (slab, block) key keeps, at least


def tiles_budget(e_pad: int, n_message_types: int,
                 tile_e: int = DEFAULT_TILE_E) -> int:
    """Static upper bound on packed tiles: every type can waste < 1 tile."""
    return (e_pad + tile_e - 1) // tile_e + n_message_types


def pack_type_tiles(edge_src, edge_dst, edge_type, edge_mask, type_offsets,
                    n_message_types: int, tile_e: int = DEFAULT_TILE_E):
    """Repack type-sorted edges so that each ``tile_e`` tile is single-type
    (the reference's ``pack_type_tiles``, on the edges' device).

    Type t's edges ``type_offsets[t] .. type_offsets[t + 1] − 1`` go, in
    order, to the slots that start at its first tile; each type's run is
    padded to whole tiles.  Masked edges (mask ≤ 0) are dropped.  Returns a
    dict of ``src``, ``dst`` (the edges' dtype) and ``mask`` (f32) of
    length ``n_tiles·tile_e`` (padding slots 0), ``tile_type`` [n_tiles]
    int32 (the last type whose first tile is at or before the tile,
    clipped to [0, T2)), ``n_tiles`` and ``tile_e``."""
    dev = edge_src.device
    e_pad = edge_src.shape[0]
    n_tiles = tiles_budget(e_pad, n_message_types, tile_e)
    packed_len = n_tiles * tile_e
    offs = torch.as_tensor(type_offsets, device=dev).long()
    counts = offs[1:] - offs[:-1]
    padded = (counts + tile_e - 1) // tile_e * tile_e
    starts = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)[:-1]])
    typ = edge_type.long()
    idx = torch.arange(e_pad, device=dev)
    pos = starts[typ] + (idx - offs[typ])
    pos = torch.where(edge_mask > 0, pos, torch.full_like(pos, packed_len))
    # XLA's scatter wraps a negative index once and drops what is then out
    # of bounds
    pos = torch.where(pos < 0, pos + packed_len, pos)
    keep = (pos >= 0) & (pos < packed_len)
    pos = pos[keep]

    def scatter(vals, dtype):
        out = torch.zeros(packed_len, dtype=dtype, device=dev)
        out[pos] = vals[keep].to(dtype)
        return out

    tile_starts = starts // tile_e
    tile_ids = torch.arange(n_tiles, device=dev)
    tile_type = torch.searchsorted(tile_starts, tile_ids, right=True) - 1
    tile_type = tile_type.clamp(0, n_message_types - 1).to(torch.int32)
    return {"src": scatter(edge_src, edge_src.dtype),
            "dst": scatter(edge_dst, edge_dst.dtype),
            "mask": scatter(edge_mask, torch.float32),
            "tile_type": tile_type, "n_tiles": n_tiles, "tile_e": tile_e}


def _check_messages_args(name, h, layout_src, layout_mask, tile_type, msg_w,
                         msg_b, tile_e):
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be [N, D], got {tuple(h.shape)}")
    N, D = h.shape
    P = layout_src.shape[0]
    if tile_e <= 0 or P % tile_e:
        raise ValueError(f"{name}: the packed length {P} is not a multiple "
                         f"of tile_e = {tile_e}")
    if tuple(layout_mask.shape) != (P,):
        raise ValueError(f"{name}: layout_mask {tuple(layout_mask.shape)} "
                         f"is not [{P}]: it does not belong to layout_src")
    if tuple(tile_type.shape) != (P // tile_e,):
        raise ValueError(f"{name}: tile_type {tuple(tile_type.shape)} is "
                         f"not [{P // tile_e}] (the packed length over "
                         f"tile_e): layout and arguments disagree")
    if msg_w.dim() != 3 or tuple(msg_w.shape[1:]) != (D, D):
        raise ValueError(f"{name}: msg_w {tuple(msg_w.shape)} is not "
                         f"[T2, D, D] with h's D = {D}")
    if tuple(msg_b.shape) != (msg_w.shape[0], D):
        raise ValueError(f"{name}: msg_b {tuple(msg_b.shape)} is not "
                         f"[T2, D] = [{msg_w.shape[0]}, {D}]")
    if not h.dtype == msg_w.dtype == msg_b.dtype:
        raise ValueError(f"{name}: h, msg_w and msg_b must share the compute "
                         f"dtype, got {h.dtype}, {msg_w.dtype}, "
                         f"{msg_b.dtype}")


def packed_messages_reference(h, layout_src, layout_mask, tile_type, msg_w,
                              msg_b, tile_e: int = DEFAULT_TILE_E):
    """Plain version of :func:`packed_messages`: per message type, the
    gathered rows times W_t as f32 products of the compute dtype's values,
    plus b_t in f32, times the mask."""
    P, D = layout_src.shape[0], h.shape[1]
    etype = tile_type.long().repeat_interleave(tile_e)
    src = layout_src.long()
    out = torch.zeros(P, D, dtype=torch.float32, device=h.device)
    for t in range(msg_w.shape[0]):
        rows = torch.nonzero(etype == t).flatten()
        if rows.numel() == 0:
            continue
        hs = h.index_select(0, src[rows]).float()
        out[rows] = hs @ msg_w[t].float() + msg_b[t].float()
    return out * layout_mask.float()[:, None]


def packed_messages(h, layout_src, layout_mask, tile_type, msg_w, msg_b,
                    tile_e: int = DEFAULT_TILE_E):
    """Masked messages of the packed layout (kernel #16, the reference's
    ``packed_messages``): row j of tile i holds (h[src_j]·W_t + b_t)·mask_j
    with t = tile_type[i] → [n_tiles·tile_e, D] f32.

    ``h`` [N, D], ``msg_w`` [T2, D, D] and ``msg_b`` [T2, D] in one compute
    dtype; ``layout_src`` int32 [P] (P = n_tiles·tile_e), ``layout_mask``
    [P], ``tile_type`` int32 [n_tiles].  A CPU tensor takes the plain
    version; a CUDA tensor launches ``csrc/packed_messages.cu`` (any D:
    zero-filled to the 128-column panels in shared memory) or raises."""
    name = "packed_messages"
    _check_messages_args(name, h, layout_src, layout_mask, tile_type, msg_w,
                         msg_b, tile_e)
    if h.device.type == "cpu":
        return packed_messages_reference(h, layout_src, layout_mask,
                                         tile_type, msg_w, msg_b, tile_e)
    N, D = h.shape
    T2 = msg_w.shape[0]
    P = layout_src.shape[0]
    if h.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {h.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    for arg, t in (("layout_src", layout_src), ("tile_type", tile_type)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {arg} must be int32, got {t.dtype}")
    if layout_mask.dtype != torch.float32:
        raise ValueError(f"{name}: layout_mask must be float32, got "
                         f"{layout_mask.dtype}")
    _check_cuda_args(name, [("h", h), ("layout_src", layout_src),
                            ("layout_mask", layout_mask),
                            ("tile_type", tile_type), ("msg_w", msg_w),
                            ("msg_b", msg_b)], D, any_width=True)
    out = torch.empty(P, D, dtype=torch.float32, device=h.device)
    if P == 0:
        return out
    s_min, s_max, t_min, t_max = host_ints(
        layout_src.min(), layout_src.max(), tile_type.min(), tile_type.max())
    if s_min < 0 or s_max >= N or t_min < 0 or t_max >= T2:
        raise ValueError(f"{name}: the layout addresses rows [{s_min}, "
                         f"{s_max}] of h's {N} and types [{t_min}, {t_max}] "
                         f"of {T2}: layout and arguments disagree")
    p = _build.ptr
    _build.launch(_build.library().ggnn_packed_messages, name, h.device,
                  _DTYPE_CODE[h.dtype], p(h), N, D, p(layout_src),
                  p(layout_mask), p(tile_type), P // tile_e, tile_e,
                  p(msg_w), p(msg_b), T2, p(out))
    packed_messages.launches += 1
    return out


packed_messages.launches = 0


def _check_sddmm_args(name, p, q, src, dst, mask):
    if p.dim() != 2 or q.dim() != 2 or p.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: p {tuple(p.shape)} and q "
                         f"{tuple(q.shape)} must be [*, G] with one G")
    E = src.shape[0] if src is not None else p.shape[0]
    for arg, idx, x in (("src", src, p), ("dst", dst, q)):
        if idx is None and x.shape[0] != E:
            raise ValueError(f"{name}: without {arg}, the rows of "
                             f"{'p' if arg == 'src' else 'q'} are the "
                             f"edges: {x.shape[0]} rows for {E} edges")
        if idx is not None and tuple(idx.shape) != (E,):
            raise ValueError(f"{name}: {arg} {tuple(idx.shape)} is not "
                             f"[{E}]")
    if mask is not None and tuple(mask.shape) != (E,):
        raise ValueError(f"{name}: mask {tuple(mask.shape)} is not [{E}]")
    return E


def sddmm_pallas_reference(p, q, src=None, dst=None, mask=None):
    """Plain version of :func:`sddmm_pallas`: the gathered rows' f32
    products summed over G (times the mask)."""
    pr = p if src is None else p.index_select(0, src.long())
    qr = q if dst is None else q.index_select(0, dst.long())
    out = (pr.float() * qr.float()).sum(-1)
    return out if mask is None else out * mask.float()


def plan_from_keys(key, n_keys: int, n_qblk: int, k: int = SDDMM_ITEM):
    """#17's plan from each edge's key in [0, ``n_keys``) (its q block is
    key % ``n_qblk``): ``order`` [E] int32, the edge ids grouped by key by
    one stable sort; ``key_start`` [n_keys + 1] int32, key j's edges
    order[key_start[j] .. key_start[j + 1]); ``item_first`` [n_keys + 1]
    int32, key j's work items of at most ``k`` edges (none for an empty
    key, :func:`~ggnn_tpu_torch.ops.window.split_plan`); and ``grid``, a
    host bound on the items (E / k rounded up, plus one for each key that
    may hold edges), so that nothing is copied to the host."""
    E = key.shape[0]
    sk, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_keys + 1, dtype=sk.dtype, device=key.device)
    key_start = torch.searchsorted(sk, bounds).to(torch.int32)
    item_first = split_plan(key_start.diff(), k, empty_items=0)[0]
    return {"order": order.to(torch.int32), "key_start": key_start,
            "item_first": item_first, "n_keys": n_keys, "n_qblk": n_qblk,
            "k": k, "grid": -(-E // k) + min(n_keys, E)}


def sddmm_plan(src, dst, n_p: int, n_q: int, G: int, k: int = SDDMM_ITEM,
               slab_bytes: int = SDDMM_SLAB_BYTES,
               slab_edges: int = SDDMM_SLAB_EDGES):
    """The plan of #17's blocked body for the index arrays ``src``,
    ``dst`` [E] (values in [0, n_p) and [0, n_q)) of G-wide p and q rows:
    the edges grouped by (src slab, dst block of :data:`SDDMM_BLOCK`
    rows), slab-major, each key's edges in their order, cut into work
    items of at most ``k`` (:func:`plan_from_keys`).  A slab is about
    ``slab_bytes`` of p, so that the CTAs at work, all in one slab, find
    its rows in L2; q is then staged once per slab and block, so there are
    no more slabs than leave about ``slab_edges`` edges a key (at the
    headline: 4 slabs of 65,536 rows, 977 edges a key; a small graph has
    one slab: the dst-block order).  Torch ops on dst's device: a sort
    (16-bit keys where they fit), a search and a few prefix sums."""
    E = dst.shape[0]
    n_qblk = -(-n_q // SDDMM_BLOCK)
    n_slabs = -(-n_p // max(1, slab_bytes // (4 * G)))
    n_slabs = max(1, min(n_slabs, E // (slab_edges * n_qblk)))
    key = dst.to(torch.int32) // SDDMM_BLOCK
    if n_slabs > 1:
        key = key + src.to(torch.int32) // -(-n_p // n_slabs) * n_qblk
    n_keys = n_slabs * n_qblk
    if n_keys <= torch.iinfo(torch.int16).max:
        key = key.to(torch.int16)
    return plan_from_keys(key, n_keys, n_qblk, k)


def sddmm_plan_for(src, dst, n_p: int, n_q: int, G: int):
    """:func:`sddmm_plan`, made once per pair of index arrays while both
    live (cached on src, checked against dst)."""
    pairs = cached_per_tensor(src, ("sddmm_plan", n_p, n_q, G), dict)
    hit = pairs.get(id(dst))
    if hit is None or hit[0]() is not dst:
        hit = (weakref.ref(dst), sddmm_plan(src, dst, n_p, n_q, G))
        pairs[id(dst)] = hit
    return hit[1]


def sddmm_rows_checked(name, arg, idx, n):
    """``idx``'s values lie in [0, n), checked once per index tensor (one
    copy to the host; a raise is not cached)."""
    def check():
        lo, hi = host_ints(idx.min(), idx.max())
        if lo < 0 or hi >= n:
            raise ValueError(f"{name}: {arg} addresses rows [{lo}, {hi}] of "
                             f"{n}: layout and arguments disagree")
        return True
    cached_per_tensor(idx, ("sddmm_rows", n), check)


def sddmm_pallas(p, q, tile_e: int = DEFAULT_TILE_E, *, src=None, dst=None,
                 mask=None):
    """Per-edge scores ⟨p[src_e], q[dst_e]⟩ (kernel #17, the reference's
    ``sddmm_pallas``) → [E] f32, times ``mask`` [E] when given.

    ``p`` [Np, G] and ``q`` [Nq, G] f32.  Without ``src`` (``dst``) row e
    of p (q) is edge e's, the reference's signature (pre-gathered
    endpoint features); with int32 index arrays the kernel reads the rows
    itself and no [E, G] copy is made.  ``tile_e`` is the reference's
    tile; the kernel takes any E, so E need not be its multiple.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises: with both index arrays and G a multiple of 4 up to 128
    ``csrc/sddmm_blocked.cu`` on :func:`sddmm_plan` (made once per pair
    of index arrays, as the range checks are made once per index array),
    else ``csrc/sddmm.cu``.  Both give the same bits."""
    del tile_e
    name = "sddmm_pallas"
    E = _check_sddmm_args(name, p, q, src, dst, mask)
    if p.device.type == "cpu":
        return sddmm_pallas_reference(p, q, src, dst, mask)
    G = p.shape[1]
    named = [("p", p), ("q", q)]
    for arg, t, want in (("p", p, torch.float32), ("q", q, torch.float32),
                         ("src", src, torch.int32), ("dst", dst, torch.int32),
                         ("mask", mask, torch.float32)):
        if t is None:
            continue
        if t.dtype != want:
            raise ValueError(f"{name}: {arg} must be {want}, got {t.dtype}")
        if arg in ("src", "dst", "mask"):
            named.append((arg, t))
    _check_cuda_args(name, named, None)
    out = torch.empty(E, dtype=torch.float32, device=p.device)
    if E == 0:
        return out
    for idx, n, arg in ((src, p.shape[0], "src"), (dst, q.shape[0], "dst")):
        if idx is not None:
            sddmm_rows_checked(name, arg, idx, n)
    ptr = _build.ptr
    if src is not None and dst is not None and G % 4 == 0 and G <= 128:
        plan = sddmm_plan_for(src, dst, p.shape[0], q.shape[0], G)
        _build.launch(_build.library().ggnn_sddmm_blocked, name, p.device,
                      ptr(p), p.shape[0], ptr(q), q.shape[0], G, ptr(src),
                      ptr(dst), ptr(mask), E, ptr(plan["order"]),
                      ptr(plan["item_first"]), ptr(plan["key_start"]),
                      plan["n_keys"], plan["n_qblk"], plan["k"],
                      plan["grid"], ptr(out))
    else:
        _build.launch(_build.library().ggnn_sddmm, name, p.device, ptr(p),
                      p.shape[0], ptr(q), q.shape[0], G, ptr(src), ptr(dst),
                      ptr(mask), E, ptr(out))
    sddmm_pallas.launches += 1
    return out


sddmm_pallas.launches = 0


class TypedTiled(torch.autograd.Function):
    """The reference's ``_typed_tiled`` with its custom VJP.

    Forward: #16, then the segment sum of the messages over ``dst`` into
    N rows (f32).  Backward, with ḡ_e = mask_e·da[dst_e] and Y[t, u] =
    Σ_{(u,t,v)} ḡ (f32 sums): dh = Σ_t Y_t·W_tᵀ rounded to h's dtype,
    dW_t = hᵀ·Y_t rounded to msg_w's, db_t = Σ_u Y_t[u] rounded to
    msg_b's, and, only when the mask needs a gradient (the edge gates),
    dmask_e = ⟨(h[src_e]·W_t + b_t), da[dst_e]⟩ from #16 with mask 1."""

    @staticmethod
    def forward(ctx, h, msg_w, msg_b, mask, src, dst, tile_type, tile_e):
        msgs = packed_messages(h, src, mask, tile_type, msg_w, msg_b, tile_e)
        out = SR.segment_rows_sum(msgs, dst, h.shape[0])
        ctx.tile_e = tile_e
        ctx.save_for_backward(h, msg_w, msg_b, mask, src, dst, tile_type)
        return out

    @staticmethod
    def backward(ctx, da):
        h, msg_w, msg_b, mask, src, dst, tile_type = ctx.saved_tensors
        need = ctx.needs_input_grad
        N, D = h.shape
        T2 = msg_w.shape[0]
        g = da.float().index_select(0, dst.long())            # [P, D]
        dh = dW = db = dmask = None
        if any(need[:3]):
            Y = SR.segment_rows_sum(g * mask.float()[:, None],
                                    tiled_rows(tile_type, src, ctx.tile_e, N),
                                    T2 * N).reshape(T2, N, D)
            if need[0]:
                dh = torch.einsum("tnf,tdf->nd", Y,
                                  msg_w.float()).to(h.dtype)
            if need[1]:
                dW = torch.einsum("nd,tnf->tdf", h.float(),
                                  Y).to(msg_w.dtype)
            if need[2]:
                db = Y.sum(1).to(msg_b.dtype)
            del Y
        if need[3]:
            un = packed_messages(h, src, torch.ones_like(mask), tile_type,
                                 msg_w, msg_b, ctx.tile_e)
            dmask = (un * g).sum(-1).to(mask.dtype)
        return dh, dW, db, dmask, None, None, None, None


def tiled_rows(tile_type, src, tile_e: int, n: int):
    """Each packed edge's row type·n + src of the [T2·n, D] Y (int64),
    made once per layout: the plan of its sum too."""
    etype = cached_per_tensor(
        tile_type, ("tile_edge_type", tile_e),
        lambda: SR._outside_inference(
            lambda: tile_type.long().repeat_interleave(tile_e)))
    return SR.pair_rows(etype, src, n)


def typed_aggregate_tiled(h, layout: dict, msg_w, msg_b, mask=None):
    """Aggregation over a precomputed type-tiled layout (built once, outside
    the step loop) → [N, D] f32.  ``mask`` overrides the packed mask: the
    per-step SDDMM edge gates (values in [0, 1] scale the messages); it is
    differentiable, as h, msg_w and msg_b are."""
    if mask is None:
        mask = layout["mask"]
    return TypedTiled.apply(h, msg_w, msg_b, mask, layout["src"],
                            layout["dst"], layout["tile_type"],
                            layout["tile_e"])


def type_offsets_from_mask(edge_type, edge_mask, n_message_types: int):
    """Type offsets [T2 + 1] int32 from the counts of real edges (mask > 0)
    per type, as the reference derives them when none are given."""
    counts = torch.zeros(n_message_types, dtype=torch.long,
                         device=edge_type.device)
    counts.index_add_(0, edge_type.long(), (edge_mask > 0).long())
    return torch.cat([counts.new_zeros(1),
                      torch.cumsum(counts, 0)]).to(torch.int32)


def typed_aggregate_pallas(h, edge_src, edge_dst, edge_type, edge_mask,
                           msg_w, msg_b, type_offsets=None,
                           tile_e: int = DEFAULT_TILE_E):
    """Drop-in for :func:`ggnn_tpu_torch.ops.segment.typed_aggregate`: the
    layout built inline (prefer :func:`typed_aggregate_tiled` with a
    layout built once)."""
    if type_offsets is None:
        type_offsets = type_offsets_from_mask(edge_type, edge_mask,
                                              msg_w.shape[0])
    layout = pack_type_tiles(edge_src, edge_dst, edge_type, edge_mask,
                             type_offsets, msg_w.shape[0], tile_e)
    return typed_aggregate_tiled(h, layout, msg_w, msg_b)
