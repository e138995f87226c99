"""Fixed-order float segment sums: the port's ``jax.ops.segment_sum``.

out[r] = Σ_{i: seg_i = r} vals_i for r < n_rows; ids outside [0, n_rows)
(the padding ids) are dropped.  On the card :func:`segment_rows_sum`
launches ``csrc/segment_rows.cu`` on a plan made once per index tensor
(:func:`segment_rows_plan`: the entries in a stable sort of the ids, rows of
more than :data:`SPLIT` entries cut into chunks whose partials a second
kernel adds in chunk order), so the same inputs give the same bits on every
run: no float atomics.  On the CPU it runs its plain version, which sums in
f64 and rounds once.

Every float segment sum of the served and trained paths goes through it:
:class:`SegmentSum` (the sum, differentiable: its backward gathers the
cotangent) and :class:`GatherRows` (a gather whose backward is the sum:
autograd's own backward of ``index_select`` or ``x[idx]`` sums by atomics
or by a sort that serializes a hub row).
"""

from __future__ import annotations

import weakref

import torch

from ggnn_tpu_torch.ops import _build
from ggnn_tpu_torch.ops.window import cached_per_tensor

SPLIT = 256     # entries of a work item: a longer row is cut into chunks
_CODE = {torch.float32: 0, torch.float64: 1}


def _make_plan(seg, n_rows: int, k: int) -> dict:
    """The plan of :func:`segment_rows_plan` (one host copy of three
    counts)."""
    dev = seg.device
    key = seg.long()
    key = torch.where((key >= 0) & (key < n_rows), key,
                      torch.full_like(key, n_rows))
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_rows + 1)[:n_rows]
    offsets = torch.zeros(n_rows + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    nchunk = (counts + k - 1) // k
    split = nchunk > 1
    n_items, n_split, n_ws = (int(x) for x in torch.stack(
        [nchunk.sum(), split.sum(), (nchunk * split).sum()]).tolist())
    rows = torch.arange(n_rows, device=dev)
    row_of = torch.repeat_interleave(rows, nchunk, output_size=n_items)
    first = torch.cumsum(nchunk, 0) - nchunk
    begin = offsets[row_of] + (torch.arange(n_items, device=dev)
                               - first[row_of]) * k
    end = torch.minimum(begin + k, offsets[row_of + 1])
    in_split = split[row_of]
    slot = torch.where(in_split, torch.cumsum(in_split.long(), 0) - 1,
                       torch.full_like(row_of, -1))
    split_rows = rows[split]
    return {"order": order.to(torch.int32),
            "items": torch.stack([row_of, begin, end, slot],
                                 1).to(torch.int32).contiguous(),
            "n_items": n_items,
            "split_rows": split_rows.to(torch.int32),
            "split_first": slot[first[split_rows]].to(torch.int32),
            "split_n": nchunk[split_rows].to(torch.int32),
            "n_split": n_split, "n_ws": n_ws,
            "gather_idx": key, "offsets": offsets}


def segment_rows_plan(seg, n_rows: int, k: int = SPLIT) -> dict:
    """The kernel's plan for index tensor ``seg`` [M] (int32 or int64),
    made once per (tensor, n_rows, k) while ``seg`` lives:

    - ``order`` int32 [M]: the entries by a stable sort of their row (the
      dropped ids, as row n_rows, last), so a row's entries keep their index
      order; ``offsets`` [n_rows + 1]: row r's entries are order[offsets[r]
      : offsets[r + 1]];
    - ``items`` int32 [n_items, 4] {row, begin, end, slot}: each nonempty
      row's entries in chunks of at most ``k``, rows ascending; slot −1 for
      a row of one chunk (its item writes the output row), else the chunk's
      partial row in the workspace, consecutive within a row;
    - ``split_rows``, ``split_first``, ``split_n``: each cut row, its first
      slot and its chunk count (``n_split`` of them, ``n_ws`` slots);
    - ``gather_idx`` int64 [M]: the ids with the dropped ones at n_rows
      (the backward's gather)."""
    if seg.dim() != 1:
        raise ValueError(f"segment_rows_sum: seg must be 1-D, got shape "
                         f"{tuple(seg.shape)}")
    if seg.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"segment_rows_sum: seg must be int32 or int64, "
                         f"got {seg.dtype}")
    if seg.shape[0] >= 2 ** 31:
        raise ValueError("segment_rows_sum: the plan addresses entries in "
                         f"32 bits, got {seg.shape[0]}")
    return cached_per_tensor(seg, ("segment_rows", n_rows, k),
                             lambda: _outside_inference(_make_plan, seg,
                                                        n_rows, k))


def segment_rows_sum_reference(vals, seg, n_rows: int):
    """The plain version: the same sums in f64, rounded once to the values'
    dtype."""
    key = seg.long()
    keep = (key >= 0) & (key < n_rows)
    out = torch.zeros((n_rows, *vals.shape[1:]), dtype=torch.float64,
                      device=vals.device)
    out.index_add_(0, key[keep], vals[keep].double())
    return out.to(vals.dtype)


def segment_rows_sum(vals, seg, n_rows: int):
    """out [n_rows, *vals.shape[1:]] = the rows of ``vals`` [M, ...] summed
    by their id in ``seg`` [M], ids outside [0, n_rows) dropped.  A CPU
    tensor takes the plain version; a CUDA tensor (f32, summed in f32, or
    f64, in f64) launches ``csrc/segment_rows.cu`` on
    :func:`segment_rows_plan` or raises.  No gradient: see
    :class:`SegmentSum`."""
    name = "segment_rows_sum"
    if seg.dim() != 1 or vals.dim() < 1 or vals.shape[0] != seg.shape[0]:
        raise ValueError(f"{name}: vals {tuple(vals.shape)} and seg "
                         f"{tuple(seg.shape)} disagree")
    if vals.device.type == "cpu":
        return segment_rows_sum_reference(vals, seg, n_rows)
    if vals.dtype not in _CODE:
        raise ValueError(f"{name}: the CUDA kernel sums float32 or float64, "
                         f"got {vals.dtype}")
    if seg.device != vals.device:
        raise ValueError(f"{name}: seg is on {seg.device}, vals on "
                         f"{vals.device}")
    M = seg.shape[0]
    v = vals.reshape(M, -1).contiguous()
    D = v.shape[1]
    out = torch.zeros(n_rows, D, dtype=vals.dtype, device=vals.device)
    plan = segment_rows_plan(seg, n_rows)
    if plan["n_items"] and D:
        ws = (torch.empty(plan["n_ws"], D, dtype=vals.dtype,
                          device=vals.device) if plan["n_ws"] else None)
        width = 4 if vals.dtype == torch.float32 else 2
        vec = int(D % width == 0 and v.data_ptr() % 16 == 0)
        ptr = _build.ptr
        _build.launch(_build.library().ggnn_segment_rows, name, vals.device,
                      _CODE[vals.dtype], vec, ptr(v), D, ptr(plan["order"]),
                      ptr(plan["items"]), plan["n_items"], ptr(ws),
                      ptr(plan["split_rows"]), ptr(plan["split_first"]),
                      ptr(plan["split_n"]), plan["n_split"], ptr(out))
        segment_rows_sum.launches += 1
    return out.reshape(n_rows, *vals.shape[1:])


segment_rows_sum.launches = 0


def wide_segment_rows_sum(vals, seg, n_rows: int):
    """:func:`segment_rows_sum` for any float dtype: a narrower one (bf16)
    is summed in f32 and rounded once to its dtype."""
    if vals.dtype in _CODE:
        return segment_rows_sum(vals, seg, n_rows)
    return segment_rows_sum(vals.float(), seg, n_rows).to(vals.dtype)


class SegmentSum(torch.autograd.Function):
    """:func:`segment_rows_sum` with its gradient: the cotangent's rows
    gathered by ``seg`` (zero for a dropped id).  It saves the index
    alone, never the [M, D] values."""

    @staticmethod
    def forward(ctx, vals, seg, n_rows):
        ctx.save_for_backward(seg)
        ctx.n_rows = n_rows
        return wide_segment_rows_sum(vals, seg, n_rows)

    @staticmethod
    def backward(ctx, g):
        (seg,) = ctx.saved_tensors
        idx = segment_rows_plan(seg, ctx.n_rows)["gather_idx"]
        pad = g.new_zeros((1, *g.shape[1:]))
        return torch.cat([g, pad]).index_select(0, idx), None, None


segment_sum = SegmentSum.apply     # (vals, seg, n_rows), differentiable


class GatherRows(torch.autograd.Function):
    """x.index_select(0, idx), whose backward sums the cotangent's rows
    into x's rows by :func:`wide_segment_rows_sum` in a fixed order."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return wide_segment_rows_sum(g, idx, ctx.n_rows), None


gather_rows = GatherRows.apply     # (x, idx), differentiable


def pair_rows(major, minor, n_minor: int):
    """major·n_minor + minor (int64), the flat row of a [n_major, n_minor]
    table, made once per pair of index tensors while both live (cached on
    ``minor``, checked against ``major``): the same tensor for every call,
    so the plans keyed on it are made once too."""
    pairs = cached_per_tensor(minor, ("pair_rows", n_minor), dict)
    hit = pairs.get(id(major))
    if hit is None or hit[0]() is not major:
        hit = (weakref.ref(major), _outside_inference(
            lambda: major.long() * n_minor + minor.long()))
        pairs[id(major)] = hit
    return hit[1]


def _outside_inference(make, *args):
    """``make(*args)`` with inference mode off: what is cached per index
    tensor outlives the call that made it, and a plan or index made while
    serving under ``torch.inference_mode`` must serve a later train step
    too (autograd saves the index for its backward)."""
    with torch.inference_mode(False):
        return make(*args)
