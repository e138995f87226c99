"""The typed pack's bf16 slot pipeline (``csrc/typed_pipe.cuh``) of kernels
#1 and #2 (``csrc/typed_block_fused.cu``) and #7's STORE form
(``csrc/typed_tile_fused.cu``), on the CPU: what the pipeline relies on,
and its schedule emulated.

- Each dstl_blk row's real dst ids lie in its prefix
  (``scatter.dstl_lengths``), so that reading only that prefix reads every
  real row: at tile_e 128, 144 and 256, with masked edges and empty slots.
- The block plan (``scatter.block_plan``: the prefix lengths, the layout
  checked against its pack) is made once per layout and pack height, and
  a pack too short for its layout raises.
- The kernels' schedule, emulated in plain torch: slots in list order (by
  type), each slot's real prefix in 128-row chunks, the one-hot sums
  rounded to bf16 once per slot, W switched where the type changes; #7 in
  work items of at most kSplit = 32 tiles whose partials are summed in
  item order.  It gives the plain versions' sums within
  ``ops/bounds.py``'s ``block_bound`` / ``tile_bound`` (2e-5 of the sums
  on |h| and |W|, plus one bf16 ulp of every slot's rounded sum of three
  or more terms, times |W_t|; on average within a tenth of it), and #2 within 8 bf16 ulps of max(1, max|a_row|)
  per row (the criterion chip_smoke holds the fused steps to).
- The plain versions of #1, #2 and #7 against the JAX package (Pallas in
  interpret mode) on the seam layouts: f32 rtol = atol = 1e-5; bf16 scatter
  atol 1e-4 (the same per-slot rounding, f32 W products in another order),
  the bf16 fused step atol one bf16 ulp (a flip before the gate products).

The tests marked ``cuda`` hold the kernels against their plain versions on
the card (chip_smoke's typed seam fuzz and [kernels] checks); they skip
without one.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu_torch.ops import bounds as B
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import scatter as S
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as CS  # noqa: E402  (its seam edge sets)

D = 128
K_SPLIT = 32            # csrc/common.cuh's kSplit
BF16_ULP = B.BF16_ULP
LENGTHS = CS.TYPED_SEAM_LENGTHS


def _seams():
    """chip_smoke.py's typed seam edge sets (its CPU-sized fuzz), by tag:
    (edges, N, T2).  "lengths": dst block i < 8 a type-0 group of
    LENGTHS[i] edges, a type-2 group of 256 more and a type-3 group; block
    8 none; blocks 9-11 random; 10 % more edges masked out.  "hub": dst
    block 0 holds 60 tiles of three types at tile_e 256 (two work items of
    #7, a type change inside each)."""
    return {tag.split(",")[0]: (edges, N, T2)
            for tag, edges, N, T2, _, _ in CS.typed_seam_edges()}


def _block_layout(edges, N, T2, tile_e):
    lay = S.build_typed_dst_layout(*edges, N, T2, tile_e=tile_e,
                                   block_mode=True)
    assert lay.block_meta is not None
    kw = S.block_args(lay)
    arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
    return lay, arrs, kw


def _inputs(lay, N, T2, seed=5):
    r = np.random.default_rng(seed)
    h = torch.tensor(r.uniform(-1, 1, (N, D)).astype(np.float32))
    w = torch.tensor((r.standard_normal((T2, D, D)) * D ** -0.5)
                     .astype(np.float32))
    n_rows = lay.n_blocks * 128
    f = lambda *s, scale: torch.tensor(
        (r.standard_normal(s) * scale).astype(np.float32))
    g = dict(init=f(n_rows, D, scale=0.3),
             hstate=torch.tensor(r.uniform(-1, 1, (n_rows, D))
                                 .astype(np.float32)),
             wa=f(D, 3 * D, scale=D ** -0.5).bfloat16(),
             b3=f(1, 3 * D, scale=0.1), uzr=f(D, 2 * D, scale=D ** -0.5)
             .bfloat16(), uh=f(D, D, scale=D ** -0.5).bfloat16())
    h_pack = h.bfloat16().index_select(0, torch.as_tensor(
        lay.arrays["gather_idx"]).long())
    return h, h_pack, w.bfloat16(), g


@pytest.mark.parametrize("tile_e", [128, 144, 256])
def test_block_real_ids_lie_in_each_rows_prefix(tile_e):
    """Every dstl_blk row's dst ids ≥ 0 fill exactly its prefix of
    dstl_lengths; empty slots (slot_off16 < 0) have length 0; the prefixes
    add up to the real (unmasked) edges."""
    edges, N, T2 = _seams()["lengths"]
    lay, (dstl_blk, slot_off16, _), kw = _block_layout(edges, N, T2, tile_e)
    dl = torch.as_tensor(dstl_blk)
    lens = S.dstl_lengths(dl)
    slot = torch.arange(tile_e)
    inside = slot[None, :] < lens[:, None].long()
    assert ((dl >= 0) == inside).all()
    empty = torch.as_tensor(slot_off16) < 0
    assert empty.any() and (lens[empty] == 0).all()
    assert (lens[~empty] > 0).all()
    assert int(lens.sum()) == int((edges[3] > 0).sum()) < edges[0].shape[0]
    if tile_e == 256:   # the seam lengths are real slots' prefixes
        assert set(LENGTHS) <= set(lens.tolist())


def test_block_plan_is_made_once_per_layout(monkeypatch):
    """block_plan computes a layout's prefix lengths once per (layout, pack
    height), returns dstl_lengths, and refuses a pack too short for the
    slots it names."""
    edges, N, T2 = _seams()["lengths"]
    lay, arrs, kw = _block_layout(edges, N, T2, 256)
    arrs = tuple(torch.as_tensor(a) for a in arrs)
    made = []
    real = S.dstl_lengths
    monkeypatch.setattr(S, "dstl_lengths",
                        lambda dl: made.append(1) or real(dl))
    h_pack = torch.zeros(lay.arrays["gather_idx"].shape[0], D)
    args = (*arrs, kw["n_blocks"], kw["tile_e"], kw["S8"])
    lens = S.block_plan("t", h_pack, *args)
    assert S.block_plan("t", h_pack, *args) is lens and len(made) == 1
    assert torch.equal(lens, real(arrs[0]))
    S.block_plan("t", h_pack[:-1], *args)
    assert len(made) == 2
    with pytest.raises(ValueError, match="not gathered with this layout"):
        S.block_plan("t", h_pack[:200], *args)


def _slot_sum(h_pack, ids, row0, length):
    """One slot's one-hot sums as the pipeline takes them: its real prefix
    in 128-row chunks, each chunk's rows added to their dst rows in f32."""
    p = torch.zeros(128, h_pack.shape[1])
    for j in range(0, length, 128):
        n = min(128, length - j)
        rows = h_pack[row0 + j:row0 + j + n].float()
        d = ids[j:j + n].long()
        ok = (d >= 0) & (d < 128)
        p.index_add_(0, d[ok], rows[ok])
    return p


def _emulate_slots(h_pack, dstl, slots, w):
    """Σ over the list (pack row, type, dstl row, length) in order:
    bf16(slot sums) @ W[type], W switched where the type changes.  Returns
    the f32 sums and the number of W loads."""
    acc = torch.zeros(128, h_pack.shape[1])
    w_type, loads = None, 0
    for row0, typ, c, length in slots:
        if length <= 0:
            continue
        if typ != w_type:
            w_type, loads = typ, loads + 1
        p = _slot_sum(h_pack, dstl[c], row0, length)
        acc += p.bfloat16().float() @ w[w_type].float()
    return acc, loads


def _emulate_blocks(h_pack, arrs, w, kw):
    dstl_blk, slot_off16, blk_off16 = (torch.as_tensor(a) for a in arrs)
    lens = S.dstl_lengths(dstl_blk)
    nb, S8, cmax = kw["n_blocks"], kw["S8"], kw["cmax"]
    out, loads = [], 0
    for b in range(nb):
        slots = []
        for s in range(S8):
            row, off = b * S8 + s, int(slot_off16[b * S8 + s])
            typ = s // cmax
            ok = off >= 0 and typ < w.shape[0]
            slots.append(((int(blk_off16[b]) + off) * 16, typ, row,
                          int(lens[row]) if ok else 0))
        acc, n = _emulate_slots(h_pack, dstl_blk, slots, w)
        out.append(acc)
        loads += n
    return torch.cat(out), loads


@pytest.mark.parametrize("tile_e", [144, 256])
def test_block_schedule_gives_the_plain_sums(tile_e):
    """#1 and #2's schedule (one CTA a block, its slots by type, real
    prefixes in 128-row chunks, one bf16 rounding a slot) against their
    plain versions: #1 within block_bound, #2 per row within 8 bf16 ulps of
    max(1, max|a_row|); a block without a slot gives 0 (#1) and a = init
    (#2); W is loaded once per type a block has."""
    edges, N, T2 = _seams()["lengths"]
    lay, arrs, kw = _block_layout(edges, N, T2, tile_e)
    _, h_pack, w, g = _inputs(lay, N, T2)
    arrs = tuple(torch.as_tensor(a) for a in arrs)
    got, loads = _emulate_blocks(h_pack, arrs, w, kw)
    ref = S.typed_block_scatter(h_pack, *arrs, w, **kw)
    bound = B.block_bound(h_pack, w, arrs, kw, torch.bfloat16)
    assert B.within_bound(got, ref, bound), B.bound_ratios(got, ref, bound)
    nb = kw["n_blocks"]
    empty = (arrs[1].reshape(nb, -1) < 0).all(1)
    assert empty.any() and (got.reshape(nb, 128, D)[empty] == 0).all()
    present = arrs[1].reshape(nb, -1) >= 0
    types = [len({s // kw["cmax"] for s in torch.nonzero(present[b])
                  .flatten().tolist()}) for b in range(nb)]
    assert loads == sum(types)
    a = g["init"] + got
    fused = G.gru_cell_fwd_reference(g["hstate"], a, g["wa"], g["b3"][0],
                                     g["uzr"], g["uh"], mdt=torch.bfloat16)[0]
    ref2 = S.typed_block_step_gru(h_pack, *arrs, w, g["init"], g["hstate"],
                                  g["wa"], g["b3"], g["uzr"], g["uh"], **kw)
    a_rows = a.abs().amax(1).clamp_min(1.0)
    assert ((fused - ref2).abs().amax(1) <= 8 * BF16_ULP * a_rows).all()


def test_tile_store_schedule_gives_the_plain_sums():
    """#7's STORE form: each block's tiles cut into work items of at most
    kSplit (split_plan), each item's tiles through the slot schedule, a
    single item's sums stored, a split block's partials summed in item
    order; against the plain version within tile_bound, and a block with
    only a dummy tile gives 0."""
    edges, N, T2 = _seams()["hub"]
    lay = S.build_typed_dst_layout(*edges, N, T2, tile_e=256,
                                   block_mode=False)
    assert lay.block_meta is None
    kw = S.tile_args(lay.to("cpu"))
    _, h_pack, w, _ = _inputs(lay, N, T2)
    ts = kw["tile_start"]
    item_first, _, _, _ = W.split_plan(ts.diff(), K_SPLIT)
    assert int((item_first.diff() > 1).sum()) >= 1
    lens = S.dstl_lengths(kw["dstl"])
    nb, align = kw["n_blocks"], kw["align"]
    out = []
    changes = 0
    for b in range(nb):
        acc = torch.zeros(128, D)
        for k in range(int(item_first[b + 1] - item_first[b])):
            t0 = int(ts[b]) + k * K_SPLIT
            t1 = min(t0 + K_SPLIT, int(ts[b + 1]))
            slots = []
            for t in range(t0, t1):
                off, c = int(kw["tile_msg_off"][t]), int(kw["c_off"][t])
                typ = int(kw["tile_type"][t])
                slots.append((off * align, typ, c,
                              int(lens[c]) if off >= 0 else 0))
            part, loads = _emulate_slots(h_pack, kw["dstl"], slots, w)
            changes += loads > 1
            acc = acc + part            # the partials in item order
        out.append(acc)
    got = torch.cat(out)
    sa = dict(h_pack=h_pack, msg_w=w, **kw)
    ref = S.typed_onehot_scatter(**sa)
    bound = B.tile_bound(h_pack, w, kw, torch.bfloat16)
    assert B.within_bound(got, ref, bound), B.bound_ratios(got, ref, bound)
    assert changes >= 2     # a type change inside the hub's items
    dummy = kw["block_of_tile"][kw["tile_msg_off"] < 0].long()
    assert dummy.numel() and (got.reshape(nb, 128, D)[dummy] == 0).all()


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_plain_versions_match_jax_on_seams(dtype):
    """#1 and #2's plain versions against the JAX kernels (interpret mode)
    on the seam layout at tile_e 144 (masked edges, an empty block, slots
    whose second chunk is cut short)."""
    jdt, tdt = DTYPES[dtype]
    edges, N, T2 = _seams()["lengths"]
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, tile_e=144,
                                      block_mode=True)
    lay, arrs, kw = _block_layout(edges, N, T2, 144)
    assert lay.meta == lay_j.meta
    h, _, w, g = _inputs(lay, N, T2)
    w = w.float()
    aj = lay_j.arrays
    S8, cmax, span = lay_j.meta[10]
    jkw = dict(n_blocks=lay_j.meta[3], tile_e=144, S8=S8, cmax=cmax,
               span_rows=span, interpret=True)
    jargs = (jnp.asarray(h.numpy(), jdt)[aj["gather_idx"]], aj["dstl_blk"],
             aj["slot_off16"], aj["blk_off16"], jnp.asarray(w.numpy(), jdt))
    h_pack = h.to(tdt).index_select(0, torch.as_tensor(
        lay.arrays["gather_idx"]).long())
    targs = (h_pack, *(torch.as_tensor(a) for a in arrs), w.to(tdt))
    ref = np.asarray(SP.typed_block_scatter(*jargs, **jkw))
    got = S.typed_block_scatter(*targs, **kw).numpy()
    atol = 1e-4 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)
    gj = {k: jnp.asarray(v.float().numpy(),
                         jnp.float32 if k in ("init", "hstate", "b3")
                         else jdt) for k, v in g.items()}
    ref2 = np.asarray(SP.typed_block_step_gru(
        *jargs, gj["init"], gj["hstate"], gj["wa"], gj["b3"], gj["uzr"],
        gj["uh"], **jkw))
    gt = {k: (v if k in ("init", "hstate", "b3") else v.to(tdt))
          for k, v in g.items()}
    got2 = S.typed_block_step_gru(*targs, gt["init"], gt["hstate"],
                                  gt["wa"], gt["b3"], gt["uzr"], gt["uh"],
                                  **kw).numpy()
    tol = BF16_ULP if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got2, ref2, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tile_plain_version_matches_jax_on_hub(dtype):
    """#7's plain version against the JAX kernel (interpret mode) on the
    hub layout (a block of two work items, dummy tiles)."""
    jdt, tdt = DTYPES[dtype]
    edges, N, T2 = _seams()["hub"]
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, tile_e=256,
                                      block_mode=False)
    lay = S.build_typed_dst_layout(*edges, N, T2, tile_e=256,
                                   block_mode=False)
    assert lay.meta == lay_j.meta
    h, _, w, _ = _inputs(lay, N, T2)
    w = w.float()
    a = lay_j.arrays
    span = lay_j.meta[9]
    ref = np.asarray(SP.typed_onehot_scatter(
        jnp.asarray(h.numpy(), jdt)[a["gather_idx"]], a["dstl"],
        a["tile_start"], a["block_of_tile"], a["tile_msg_off"], a["c_off"],
        a["tile_type"], jnp.asarray(w.numpy(), jdt), n_blocks=lay_j.meta[3],
        tile_e=256, align=lay_j.meta[6], span_rows=span,
        blk_off16=a["blk_off16"] if span is not None else None,
        interpret=True))
    kw = S.tile_args(lay.to("cpu"))
    h_pack = h.to(tdt).index_select(0, torch.as_tensor(
        lay.arrays["gather_idx"]).long())
    got = S.typed_onehot_scatter(h_pack, msg_w=w.to(tdt), **kw).numpy()
    atol = 1e-4 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=atol)


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return CS


@pytest.mark.cuda
def test_typed_seams_on_card():
    """#1, #2, #7 and #6 in bf16 on chip_smoke's typed seam layouts
    (prefix lengths 1 … 256 at tile_e 256 and 144, a block without a slot,
    a hub of two work items with type changes inside them, a slot list of
    288; D = 64, 128, 256) against their plain versions, twice bit-equal,
    #7 = #1 and #6 = #2 on the blocks of one work item:
    chip_smoke.typed_seam_fuzz."""
    _card().typed_seam_fuzz({})


@pytest.mark.cuda
@pytest.mark.parametrize("tile_e", [144, 256])
def test_block_kernels_on_card(tile_e):
    """#1 and #2 (bf16 and f32) on this file's seam layout on the card:
    chip_smoke.check_kernels (bf16 #1 within block_bound, #2 per row
    against its plain version and the GRU cell of init + #1's plain
    sums)."""
    cs = _card()
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    cfg = ModelConfig(state_dim=D, annotation_dim=8, n_edge_types=2,
                      n_steps=5, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    edges, N, T2 = _seams()["lengths"]
    lay = S.build_typed_dst_layout(*edges, N, T2, tile_e=tile_e,
                                   block_mode=True)
    cs.check_kernels(f"seams tile_e {tile_e}", lay.to("cuda"), params, {})
