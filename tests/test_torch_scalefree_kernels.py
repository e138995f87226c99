"""Kernels #12 (``window_block_spmm_ondemand``) and #6 (``typed_step_gru``)
on layouts whose hub block holds most of the tiles, the shape of a
power-law graph's, and #12's work-item plan (``ops/window.py::
ondemand_items``, which ``csrc/window_ondemand_fused.cu`` walks).

The same seeded numpy inputs go to both packages; the JAX kernels run in
Pallas interpret mode, the port's wrappers their plain versions (CPU
tensors).  The layouts mirror ``chip_smoke.py``'s "hub" fuzz case: 90 % of
the edges into 64 dst rows (dst block 0; 95 % for #12), from every source
block for #12 (so block 0 addresses every window) and from 16 source rows
for #6.
Tolerances:

- #12 (window sums): f32 rtol = atol = 2e-5; bf16 one bf16 ulp of the
  largest value (``tests/test_torch_window.py``'s);
- #6 (the fused step): per row within 1e-5 (f32) or 8 bf16 ulps (bf16)
  times max(1, max|a_row|), the criterion ``chip_smoke.py`` holds the
  step to: a hub row's |a| is large, and a last-bit difference of its f32
  sum that rounds a the other way before the gate products moves a gate
  by ulp(a)·|W|;
- the plan: exact (integers), and the work items' partials summed in
  item order agree with the plain version to f32 rounding (2e-6 of the
  row's Σ|terms|); blocks without a real tile are exactly 0.

The tests marked ``cuda`` hold the kernels against their plain versions on
the card, each twice bit-equal; they skip without one.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.ops import scatter as S
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 128
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _hub_window_layout(W_, rows, pad=0, N=4096, T2=8, E=12_000, seed=31):
    """An on-demand layout (the XW spill) whose dst block 0 takes 95 % of
    the edges, from every source block; the last dst block gets none;
    ``pad`` dummy tiles appended (a static budget's padding)."""
    r = np.random.default_rng(seed)
    dst = np.where(r.random(E) < 0.95, r.integers(0, 64, E),
                   r.integers(0, N - rows, E))
    src = r.integers(0, N, E)
    edges = (src.astype(np.int32), dst.astype(np.int32),
             r.integers(0, T2, E).astype(np.int32),
             (r.random(E) < 0.9).astype(np.float32))
    kw = dict(window=W_, block_rows=rows, min_edges_per_tile=3,
              n_message_types=T2, row_major="block", on_demand=True,
              typed_spill=True)
    lay = W.build_window_layout(*edges, N, **kw)
    if pad:
        lay = W.build_window_layout(*edges, N, pad_tiles_to=lay.n_tiles + pad,
                                    **kw)
    return lay


def _real_per_block(lay):
    a = lay.arrays
    real = a["win_of_tile"] >= 0
    return np.bincount(a["block_of_tile"][real], minlength=lay.n_blocks)


def _ondemand_inputs(lay, T2=8, seed=7):
    r = np.random.default_rng(seed)
    h = r.standard_normal((lay.n_nodes_pad, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("W_,rows", [(256, 128), (512, 256)])
def test_ondemand_hub_matches_jax(W_, rows, dtype):
    """#12 on a hub layout (block 0 holds most real tiles, more than one
    work item's worth) against the JAX kernel in interpret mode."""
    jdt, tdt = DTYPES[dtype]
    lay = _hub_window_layout(W_, rows)
    per = _real_per_block(lay)
    assert per[0] > W.ONDEMAND_SPLIT and per[0] > per.sum() / 2
    assert per[-1] == 0
    h, w, b = _ondemand_inputs(lay)
    a = lay.arrays
    kw = dict(n_blocks=lay.n_blocks, window=W_, out_rows=rows)
    j = lambda x: jnp.asarray(np.asarray(x))
    ref = np.asarray(WP.window_block_spmm_ondemand(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        j(a["c_stream"]), j(a["tile_start"]), j(a["block_of_tile"]),
        j(a["win_of_tile"]), j(a["c_off"]), interpret=True, **kw))
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    got = W.window_block_spmm_ondemand(
        torch.tensor(h).to(tdt), torch.tensor(w).to(tdt),
        torch.tensor(b).to(tdt), t["c_stream"], t["tile_start"],
        t["block_of_tile"], t["win_of_tile"], t["c_off"], **kw).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
    assert (got[-rows:] == 0).all()


def _plan(lay):
    a = {k: torch.as_tensor(v) for k, v in lay.arrays.items()}
    n_c = a["c_stream"].shape[0] // lay.block_rows
    return a, W.ondemand_items(a["tile_start"], a["win_of_tile"], a["c_off"],
                               n_c, lay.n_blocks)


@pytest.mark.parametrize("W_,rows,pad", [(256, 128, 0), (512, 256, 0),
                                         (256, 128, 40)])
def test_ondemand_items_cover_each_real_tile_once(W_, rows, pad):
    """Each block's work items hold its real tiles once, in list order, at
    most ONDEMAND_SPLIT an item; every block has at least one item (an
    empty block one with none); padding and dummy tiles are in no item;
    the split blocks are those of more than one item, their partial slots
    consecutive."""
    lay = _hub_window_layout(W_, rows, pad=pad)
    a, (item_first, rt, rt_start, pbase, split, n_items, n_part) = _plan(lay)
    K = W.ONDEMAND_SPLIT
    ts, win = a["tile_start"].numpy(), a["win_of_tile"].numpy()
    item_first, rt, rt_start, pbase, split = (
        x.numpy() for x in (item_first, rt, rt_start, pbase, split))
    assert n_items == item_first[-1] and rt.shape[0] == rt_start[-1]
    want_split, slot = [], 0
    for bk in range(lay.n_blocks):
        real = [t for t in range(ts[bk], ts[bk + 1]) if win[t] >= 0]
        n_it = item_first[bk + 1] - item_first[bk]
        assert n_it == max(1, -(-len(real) // K))
        items = [rt[rt_start[bk] + k * K:min(rt_start[bk] + (k + 1) * K,
                                             rt_start[bk + 1])]
                 for k in range(n_it)]
        assert [t for it in items for t in it] == real
        assert all(len(it) <= K for it in items)
        if n_it > 1:
            want_split.append(bk)
            assert pbase[bk] == slot
            slot += n_it
    assert list(split) == want_split and n_part == slot
    assert len(want_split) >= 1
    if pad:
        assert ts[-1] > rt[-1] + 1 or win[ts[-1] - 1] < 0


@pytest.mark.parametrize("k", [1, 3, 32])
def test_split_plan_cuts_each_block_into_items(k):
    """split_plan, the one cut of #6, #7, #11 and #12: a block of n tiles
    gets max(1, ceil(n / k)) items, in block order; a block of several
    items owns that many consecutive partial slots from pbase, and the
    totals are the item and slot counts."""
    per = torch.tensor([0, 1, k, k + 1, 5 * k, 0, 2 * k + 3, 7])
    item_first, pbase, n_items, n_part = W.split_plan(per, k)
    nit = np.maximum(1, -(-per.numpy() // k))
    assert item_first.dtype == pbase.dtype == torch.int32
    assert item_first.tolist() == [0] + np.cumsum(nit).tolist()
    slots = np.where(nit > 1, nit, 0)
    multi = nit > 1
    assert (pbase.numpy()[multi] == (np.cumsum(slots) - slots)[multi]).all()
    assert int(n_items) == nit.sum() and int(n_part) == slots.sum()


def test_ondemand_items_schedule_gives_the_plain_sums():
    """The kernel's schedule on the plan, emulated: each work item sums
    its tiles (the plain version with every other tile made a dummy),
    a split block's partials are added in item order; the result agrees
    with the plain version over all tiles, and empty blocks are exactly
    0."""
    lay = _hub_window_layout(256, 128, pad=20, N=2048, E=6000)
    a, (item_first, rt, rt_start, _, _, _, _) = _plan(lay)
    K = W.ONDEMAND_SPLIT
    h, w, b = (torch.tensor(x) for x in _ondemand_inputs(lay))
    nb, rows = lay.n_blocks, lay.block_rows
    args = (a["c_stream"], a["tile_start"], a["block_of_tile"])
    kw = dict(n_blocks=nb, window=256, out_rows=rows)
    ref = W.window_block_spmm_ondemand_reference(
        h, w, b, *args, a["win_of_tile"], a["c_off"], **kw)
    mag = W.window_block_spmm_ondemand_reference(
        h.abs(), w.abs(), b.abs(), *args, a["win_of_tile"], a["c_off"], **kw)
    got = torch.zeros_like(ref)
    n_items = int(item_first[-1])
    blk_of_item = np.searchsorted(item_first.numpy(), np.arange(n_items),
                                  side="right") - 1
    for it in range(n_items):
        bk = int(blk_of_item[it])
        k = it - int(item_first[bk])
        lo = int(rt_start[bk]) + k * K
        tiles = rt[lo:min(lo + K, int(rt_start[bk + 1]))].long()
        win = torch.full_like(a["win_of_tile"], -1)
        win[tiles] = a["win_of_tile"][tiles]
        part = W.window_block_spmm_ondemand_reference(h, w, b, *args, win,
                                                      a["c_off"], **kw)
        got[bk * rows:(bk + 1) * rows] += part[bk * rows:(bk + 1) * rows]
    assert ((got - ref).abs() <= 2e-6 * mag + 1e-30).all()
    per = _real_per_block(lay)
    empty = np.repeat(per == 0, rows)
    assert empty.any() and (got[empty] == 0).all()


def _hub_tile_layouts(tile_e, T2=4, N=1024, E=12_000, seed=11):
    """chip_smoke.py's "hub" fuzz case at a CPU size: 90 % of the edges
    into 64 dst rows and out of 16 source rows; block mode declines."""
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, N, E), r.integers(0, N, E)
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E), dst)
    src = np.where(r.random(E) < 0.9, r.integers(0, 16, E), src)
    edges = (src.astype(np.int32), dst.astype(np.int32),
             r.integers(0, T2, E).astype(np.int32),
             (r.random(E) < 0.9).astype(np.float32))
    kw = dict(tile_e=tile_e, block_mode=False)
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, **kw)
    assert lay_t.block_meta is None and lay_t.meta == lay_j.meta
    return lay_j, lay_t.to("cpu"), N, T2


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_e", [128, 144])
def test_typed_step_gru_hub_matches_jax(tile_e, dtype):
    """#6 on a hub layout whose block 0 splits into several work items
    (kSplit = 32 tiles an item), at tile_e 128 and 144 (the kernel's
    128-row chunks cut short), against the JAX kernel in interpret
    mode."""
    jdt, tdt = DTYPES[dtype]
    lay_j, lay_t, N, T2 = _hub_tile_layouts(tile_e)
    a = lay_t.arrays
    per = np.bincount(np.asarray(a["block_of_tile"]), minlength=lay_t.n_blocks)
    assert per[0] > 32 and per[0] > per.sum() / 2
    r = np.random.default_rng(12)
    n_rows = lay_t.n_blocks * 128
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(
        np.float32)
    x = dict(h=f(N, D), w=f(T2, D, D, scale=0.2), init=f(n_rows, D,
                                                          scale=0.1),
             hstate=(r.random((n_rows, D)) - 0.5).astype(np.float32),
             wa=f(D, 3 * D, scale=0.08), uzr=f(D, 2 * D, scale=0.08),
             uh=f(D, D, scale=0.08), b3=f(1, 3 * D, scale=0.1))
    aj = lay_j.arrays
    j = lambda k, dt=jdt: jnp.asarray(x[k], dt)
    ref = np.asarray(SP.typed_step_gru(
        jnp.asarray(x["h"], jdt)[aj["gather_idx"]], aj["dstl"],
        aj["tile_start"], aj["block_of_tile"], aj["tile_msg_off"],
        aj["c_off"], aj["tile_type"], j("w"), j("init", jnp.float32),
        j("hstate", jnp.float32), j("wa"), j("b3", jnp.float32), j("uzr"),
        j("uh"), n_blocks=lay_j.meta[3], tile_e=lay_j.meta[1],
        align=lay_j.meta[6], span_rows=None, blk_off16=None,
        interpret=True))
    kw = S.tile_args(lay_t)
    h_pack = torch.tensor(x["h"]).to(tdt).index_select(0, a["gather_idx"])
    t = lambda k, dt=tdt: torch.tensor(x[k]).to(dt)
    got = S.typed_step_gru(h_pack, msg_w=t("w"),
                           init=t("init", torch.float32),
                           hstate=t("hstate", torch.float32), wa=t("wa"),
                           b3=t("b3", torch.float32), uzr=t("uzr"),
                           uh=t("uh"), **kw)
    a_rows = (torch.tensor(x["init"]) + S.typed_onehot_scatter_reference(
        h_pack, msg_w=t("w"), **kw)).abs().amax(1).clamp_min(1.0).numpy()
    tol = 8 * BF16_ULP if dtype == "bfloat16" else 1e-5
    err = np.abs(got.numpy() - ref).max(1)
    assert (err <= tol * a_rows).all(), (err / (tol * a_rows)).max()


def test_typed_step_reads_only_each_tiles_real_prefix():
    """#6's bf16 kernel reads a tile's slots only up to its dstl row's
    length (``dstl_lengths``: its last dst id ≥ 0, plus one): every dst id
    lies before it, and NaN in every h_pack row outside those prefixes
    leaves the plain version's output bit for bit."""
    lay_j, lay_t, N, T2 = _hub_tile_layouts(144)
    kw = S.tile_args(lay_t)
    dstl = kw["dstl"]
    lens = S.dstl_lengths(dstl)
    slot = torch.arange(dstl.shape[1])
    assert (dstl[slot[None, :] >= lens[:, None]] < 0).all()
    has = lens > 0
    assert (dstl[has, lens[has].long() - 1] >= 0).all()
    r = np.random.default_rng(13)
    h_pack = torch.tensor(r.standard_normal(
        (lay_t.arrays["gather_idx"].shape[0], D)).astype(np.float32))
    read = torch.zeros(h_pack.shape[0], dtype=torch.bool)
    for t in torch.nonzero(kw["tile_msg_off"] >= 0).flatten().tolist():
        base = int(kw["tile_msg_off"][t]) * kw["align"]
        read[base:base + int(lens[int(kw["c_off"][t])])] = True
    assert not read.all()
    poisoned = torch.where(read[:, None], h_pack, float("nan"))
    n_rows = lay_t.n_blocks * 128
    g = dict(init=torch.zeros(n_rows, D), hstate=torch.zeros(n_rows, D),
             wa=torch.full((D, 3 * D), 0.01), b3=torch.zeros(1, 3 * D),
             uzr=torch.full((D, 2 * D), 0.01), uh=torch.full((D, D), 0.01))
    w = torch.tensor(r.standard_normal((T2, D, D)).astype(np.float32) * 0.1)
    want = S.typed_step_gru(h_pack, msg_w=w, **g, **kw)
    got = S.typed_step_gru(poisoned, msg_w=w, **g, **kw)
    assert torch.equal(got, want)


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke


@pytest.mark.cuda
def test_ondemand_seams_on_card():
    """#12's bf16 kernel against its plain version on chip_smoke's seam
    layouts (W 128/256/512, 128-/256-/512-row blocks, a hub block of many
    work items, a one-tile block, empty blocks), D = 4 and 128, twice
    bit-equal: chip_smoke.ondemand_seam_fuzz."""
    _card().ondemand_seam_fuzz({})


@pytest.mark.cuda
@pytest.mark.parametrize("W_,rows", [(256, 128), (512, 256)])
def test_ondemand_hub_on_card(W_, rows):
    """#12 on this file's hub layouts on the card, twice bit-equal, within
    chip_smoke's per-element bound of its plain version."""
    cs = _card()
    lay = _hub_window_layout(W_, rows, pad=40).to("cuda")
    a = lay.arrays
    gen = torch.Generator(device="cuda").manual_seed(5)
    w, b, _ = cs.rand_step_weights(D, torch.bfloat16, gen, T2=8)
    h = (torch.rand(lay.n_nodes_pad, D, device="cuda", generator=gen) * 2
         - 1).to(torch.bfloat16)
    args = (h, w, b, a["c_stream"], a["tile_start"], a["block_of_tile"],
            a["win_of_tile"], a["c_off"], lay.n_blocks, W_, rows)
    got = W.window_block_spmm_ondemand(*args)
    cs.same_twice("window_block_spmm_ondemand", "hub", got,
                  W.window_block_spmm_ondemand(*args))
    lay_args = (a["c_stream"], a["block_of_tile"], a["win_of_tile"],
                a["c_off"], lay.n_blocks, False)
    cs.check("window_block_spmm_ondemand[hub]", got,
             W.window_block_spmm_ondemand_reference(*args), "bound",
             torch.bfloat16, {}, bound=cs.window_sums_bound(
                 h, lay_args, W_, rows, msg_w=w, msg_b=b, flip=True))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_e", [128, 144])
def test_typed_step_gru_hub_on_card(tile_e):
    """#6's bf16 kernel on this file's hub layouts on the card: against
    its plain version and the GRU cell of init plus #7's f64 plain sums,
    per row, twice bit-equal (chip_smoke.check_tile_kernels, which also
    holds #7)."""
    cs = _card()
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    cfg = ModelConfig(state_dim=D, annotation_dim=8, n_edge_types=2,
                      n_steps=5, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    _, lay, _, _ = _hub_tile_layouts(tile_e)
    cs.check_tile_kernels(f"hub tile_e {tile_e}", lay.to("cuda"), params, {})
