"""Per-element bounds of the bf16 typed scatters (#1 ``typed_block_scatter``,
#7 ``typed_onehot_scatter``) against their plain versions.

The kernels of ``csrc/typed_pipe.cuh`` add a slot's (or tile's) one-hot
terms on the tensor cores, 16 at a k-step, which is not the plain
version's order.  A slot's f32 sum that lies on a bf16 boundary may then
round to the other neighbour before its W_t product.  The bound of an
element is

- 2e-5 of the plain version on |h_pack| and |W| (f32 sums in another
  order), and
- in bf16, one ulp (2**-7) of every slot's rounded one-hot sum of three or
  more terms, times |W_t| (a sum of one or two terms is the same in every
  order), added to its block's rows as the plain version adds the slot.

Two faithful versions sit far inside it on average, so the mean of
|kernel − plain| / bound must stay ≤ ``BOUND_MEAN`` as well: a systematic
error fails even where each element lies within its bound.  Used by
``chip_smoke.py`` and the tests; no kernel path calls them.
"""

import torch

from ggnn_tpu_torch.ops import scatter as S

BF16_ULP = 2.0 ** -7   # one bf16 ulp at 1.0
BOUND_MEAN = 0.1


def bound_ratios(got, ref, bound):
    """(max, mean) of |got − ref| / bound over the elements."""
    ratio = (got.float() - ref.float()).abs() / bound.clamp_min(1e-30)
    return ratio.max().item(), ratio.mean().item()


def within_bound(got, ref, bound) -> bool:
    """Every element within its bound and the mean ratio ≤ BOUND_MEAN."""
    rmax, rmean = bound_ratios(got, ref, bound)
    return rmax <= 1.0 and rmean <= BOUND_MEAN


def _flip_terms(p, cnt, w_t, dtype):
    """One ulp of each rounded slot sum of ≥ 3 terms, times |W_t|."""
    flips = p.to(dtype).float().abs() * (cnt >= 3).float()[:, None]
    return BF16_ULP * (flips @ w_t.float().abs())


def tile_bound(h_pack, msg_w, kw, dtype):
    """The bound of ``typed_onehot_scatter(h_pack, msg_w=msg_w, **kw)``
    (per-tile layout arguments ``kw``), per tile."""
    bound = 2e-5 * S.typed_onehot_scatter_reference(
        h_pack.abs(), msg_w=msg_w.abs(), **kw)
    if dtype == torch.float32:
        return bound
    dev = h_pack.device
    real = kw["tile_msg_off"] >= 0
    cols, rows128 = (torch.arange(kw["tile_e"], device=dev),
                     torch.arange(128, device=dev))
    for t in range(msg_w.shape[0]):
        sel = torch.nonzero(real & (kw["tile_type"] == t)).flatten()
        n = sel.numel()
        if n == 0:
            continue
        d = kw["dstl"].long()[kw["c_off"].long()[sel]]
        valid = d >= 0
        src = (kw["tile_msg_off"].long()[sel, None] * kw["align"]
               + cols)[valid]
        tgt = (torch.arange(n, device=dev)[:, None] * 128 + d)[valid]
        p = torch.zeros(n * 128, h_pack.shape[1], device=dev)
        p.index_add_(0, tgt, h_pack.index_select(0, src).float())
        cnt = torch.zeros(n * 128, device=dev)
        cnt.index_add_(0, tgt, torch.ones(tgt.shape[0], device=dev))
        bound.index_add_(0, (kw["block_of_tile"].long()[sel, None] * 128
                             + rows128).reshape(-1),
                         _flip_terms(p, cnt, msg_w[t], dtype))
        del p, cnt
    return bound


def block_bound(h_pack, msg_w, arrs, kw, dtype):
    """The bound of ``typed_block_scatter(h_pack, *arrs, msg_w, **kw)``
    (``arrs`` = dstl_blk, slot_off16, blk_off16), per slot."""
    bound = 2e-5 * S.typed_block_scatter_reference(
        h_pack.abs(), *arrs, msg_w.abs(), **kw)
    if dtype == torch.float32:
        return bound
    dstl_blk, slot_off16, blk_off16 = arrs
    nb, S8, cmax, tile_e = kw["n_blocks"], kw["S8"], kw["cmax"], kw["tile_e"]
    D, dev = h_pack.shape[1], h_pack.device
    dl = dstl_blk.reshape(nb, S8, tile_e).long()
    off = slot_off16.reshape(nb, S8).long()
    base = (blk_off16.long()[:, None] + off) * 16
    cols = torch.arange(tile_e, device=dev)
    slot_id = (torch.arange(nb, device=dev)[:, None, None] * cmax
               + torch.arange(cmax, device=dev)[None, :, None])
    for t in range(msg_w.shape[0]):
        sl = slice(t * cmax, (t + 1) * cmax)
        d = dl[:, sl]
        valid = (d >= 0) & (off[:, sl, None] >= 0)
        rows = (base[:, sl, None] + cols)[valid]
        tgt = ((slot_id * 128).expand_as(d) + d)[valid]
        p = torch.zeros(nb * cmax * 128, D, device=dev)
        p.index_add_(0, tgt, h_pack.index_select(0, rows).float())
        cnt = torch.zeros(nb * cmax * 128, device=dev)
        cnt.index_add_(0, tgt, torch.ones(tgt.shape[0], device=dev))
        bound += _flip_terms(p, cnt, msg_w[t], dtype).reshape(
            nb, cmax, 128, D).sum(1).reshape(-1, D)
        del p, cnt
    return bound
