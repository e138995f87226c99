"""Kernels #11 (``window_block_spmm_mono``: the dst-local, int8 count and
tall count forms) and #8 (``onehot_segment_scatter_flat``) at the seams of
their bf16 pipeline (``csrc/window_mono_fused.cu`` on
``csrc/mono_pipe.cuh``), and that pipeline's plan (``ops/window.py::
mono_plan``: the per-stream group mask, the work items cut from the real
tiles, the partial order) emulated in plain torch.

The same seeded numpy inputs go to both packages; the JAX kernels run in
Pallas interpret mode, the port's wrappers their plain versions (CPU
tensors).  The layouts hold the seams: a hub block of more than 32 tiles
(90 % of the edges into 64 dst rows), a hub tile (every row bound for one
dst), padding tails inside tiles, the all-padding tiles of
``pad_tiles_to``, empty blocks (no edge into the upper dst rows), dummy
tiles (win < 0), windows overlapping at ``win_stride`` 16, counts other
than 1 (window layouts) and 256-row blocks.
Tolerances:

- against the JAX kernels: f32 rtol = 1e-5, atol = 1e-5; bf16 one bf16
  ulp (rtol 2**-7), the flush's rounding (as ``tests/test_torch_per_tile.
  py``'s #11 test);
- the emulated plan: each output element within 2e-6 of its Σ|terms| of
  the plain version's f64 sums (the work items' f32 sums and their
  partials added in item order); blocks without a unit exactly 0;
- the plan's integers: exact.

The tests marked ``cuda`` hold the kernels against their plain versions on
the card, twice bit-equal; they skip without one.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 128
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _edges(seed, N=1024, E=6000, T2=3, hub_tile=True):
    """Edges into the lower half of N dst rows only (the upper blocks stay
    empty), 90 % of them into dst rows [0, 64) (a hub block); with
    ``hub_tile`` 300 more into dst row 5 (tiles whose every row is bound
    for one dst)."""
    r = np.random.default_rng(seed)
    src, typ = r.integers(0, N, E), r.integers(0, T2, E)
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                   r.integers(0, N // 2, E))
    mask = (r.random(E) < 0.95).astype(np.float32)
    if hub_tile:
        src = np.concatenate([src, r.integers(0, N, 300)])
        typ = np.concatenate([typ, np.zeros(300, np.int64)])
        dst = np.concatenate([dst, np.full(300, 5)])
        mask = np.concatenate([mask, np.ones(300, np.float32)])
    return (src.astype(np.int32), dst.astype(np.int32), typ.astype(np.int32),
            mask)


def _legacy(dstl, tile_e=128, pad=7, align=16, seed=21):
    """The legacy layout (the JAX package's builder) with ``pad``
    all-padding tiles appended: #11's dst-local or count form at
    ``win_stride`` 16 (or #8's one-hot stream with ``align`` None)."""
    src, dst, typ, mask = _edges(seed)
    N, T2 = 1024, 3
    base = SP.build_dst_block_layout(src, dst, typ, mask, N, tile_e=tile_e,
                                     n_message_types=T2, edge_align=align,
                                     dstl_stream=dstl)
    lay = SP.build_dst_block_layout(
        src, dst, typ, mask, N, tile_e=tile_e, n_message_types=T2,
        edge_align=align, dstl_stream=dstl,
        pad_tiles_to=base.block_of_tile.shape[0] + pad)
    return lay


def _cases():
    """name -> (table rows, stream, tile_start, block_of_tile,
    win_of_tile, keyword arguments) as numpy."""
    out = {}
    for name, dstl in (("dstl", True), ("counts", False)):
        lay = _legacy(dstl)
        out[name] = (int(lay.gather_idx.shape[0]),
                     lay.dstl if dstl else lay.onehot, lay.tile_start,
                     lay.block_of_tile, lay.tile_msg_off,
                     dict(n_blocks=lay.n_blocks, window=128, win_stride=16,
                          dstl=dstl))
    # dummy tiles inside the legacy dst-local layout, and its stream read
    # through a c_off permutation
    R, stream, ts, bot, win, kw = out["dstl"]
    r = np.random.default_rng(3)
    win = np.where(r.random(win.shape[0]) < 0.2, -1, win).astype(np.int32)
    perm = r.permutation(stream.shape[0])
    out["dstl_dummies_c_off"] = (R, stream[perm], ts, bot, win, dict(
        kw, c_off=np.argsort(perm).astype(np.int32)[:win.shape[0]]))
    # window layouts: counts > 1, dummy tiles, c_off over real tiles; 128-
    # and 256-row blocks
    N = 4096
    src, dst, typ, mask = _edges(31, N=N, E=8000, hub_tile=False)
    src = np.where(np.arange(src.shape[0]) % 3 == 0, src % 64, src)
    for rows in (128, 256):
        lay = WP.build_window_layout(src, dst, typ, mask, N, window=128,
                                     min_edges_per_tile=1, block_rows=rows)
        a = {k: np.asarray(v) for k, v in lay.arrays.items()}
        assert (a["win_of_tile"] < 0).any() and (a["c_stream"] > 1).any()
        out[f"window_rows{rows}"] = (
            3 * N + (-3 * N) % 128, a["c_stream"], a["tile_start"],
            a["block_of_tile"], a["win_of_tile"],
            dict(n_blocks=lay.n_blocks, window=128, c_off=a["c_off"],
                 out_rows=rows, dstl=False))
    return out


CASES = _cases()


def _table(R, seed=7):
    return np.random.default_rng(seed).standard_normal((R, D)).astype(
        np.float32)


def _seams(case):
    """The case's block sizes, hub tiles and empty blocks, asserted."""
    R, stream, ts, bot, win, kw = CASES[case]
    per = np.diff(ts)
    assert per.max() > W.MONO_SPLIT        # a block of several work items
    return per


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_block_spmm_mono_seams_match_jax(case, dtype):
    """#11's plain version against the JAX kernel in interpret mode on the
    seam layouts, the output in the table's dtype as the reverse scatter
    runs it; empty blocks come out exactly 0."""
    jdt, tdt = DTYPES[dtype]
    R, stream, ts, bot, win, kw = CASES[case]
    _seams(case)
    table = _table(R)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = np.asarray(WP.window_block_spmm_mono(
        jnp.asarray(table, jdt), jnp.asarray(stream), jnp.asarray(ts),
        jnp.asarray(bot), jnp.asarray(win), out_dtype=jdt, interpret=True,
        **jkw), np.float32)
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = W.window_block_spmm_mono(
        torch.tensor(table).to(tdt), torch.tensor(stream), torch.tensor(ts),
        torch.tensor(bot), torch.tensor(win), out_dtype=tdt, **tkw)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    got = got.float().numpy()
    rtol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5)
    # blocks without an edge: the upper half of the dst rows
    empty = np.abs(ref).reshape(kw["n_blocks"], -1).max(1) == 0
    assert empty.any() and (got.reshape(kw["n_blocks"], -1)[empty] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_e", [128, 256])
def test_onehot_segment_scatter_flat_seams_match_jax(tile_e, dtype):
    """#8's plain version (the one-hot stream's product) against the JAX
    kernel in interpret mode: a hub block of more than 32 tiles, a hub
    tile, padding tails, all-padding tiles, empty blocks (exactly 0)."""
    jdt, tdt = DTYPES[dtype]
    lay = _legacy(False, tile_e=tile_e, align=None)
    n_tiles = lay.block_of_tile.shape[0]
    assert np.diff(lay.tile_start).max() > W.MONO_SPLIT or tile_e == 256
    msgs = _table(n_tiles * tile_e, seed=9)
    ref = np.asarray(SP.onehot_segment_scatter_flat(
        jnp.asarray(msgs, jdt), jnp.asarray(lay.onehot),
        jnp.asarray(lay.tile_start), jnp.asarray(lay.block_of_tile),
        n_blocks=lay.n_blocks, tile_e=tile_e, interpret=True))
    got = L.onehot_segment_scatter_flat(
        torch.tensor(msgs).to(tdt), torch.tensor(lay.onehot),
        torch.tensor(lay.tile_start), torch.tensor(lay.block_of_tile),
        n_blocks=lay.n_blocks, tile_e=tile_e).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    empty = np.bincount(lay.block_of_tile[(lay.dst_local.reshape(
        n_tiles, tile_e) >= 0).any(1)], minlength=lay.n_blocks) == 0
    assert empty.any() and (got.reshape(-1, 128, D)[empty] == 0).all()


# --- the plan, emulated ------------------------------------------------------

def _torch_case(case):
    R, stream, ts, bot, win, kw = CASES[case]
    t = lambda x: torch.tensor(x) if isinstance(x, np.ndarray) else x
    kw = {k: t(v) for k, v in kw.items()}
    return R, t(stream), t(ts), t(bot), t(win), kw


def _plan(case):
    R, stream, ts, bot, win, kw = _torch_case(case)
    W_ = kw["window"]
    stride = kw.get("win_stride") or W_
    rows = kw.get("out_rows", 128)
    plan = W.mono_plan(stream, ts, win, kw.get("c_off"), kw["n_blocks"], W_,
                       stride, rows, kw["dstl"])
    return plan, (R, stream, ts, bot, win, kw, W_, stride, rows)


def _unit_product(table, stream, unit, W_, dstl):
    """One unit's [128, 128] f64 product: its 16 table rows times its A
    operand (the one-hot of its 16 ids, or its [128, 16] counts)."""
    row, off = int(unit[0]), 16 * int(unit[1])     # the stream's bytes
    B = table[row:row + 16].double()
    if dstl:
        c, j = divmod(off // 4, W_)
        ids = stream[c, j:j + 16].long()
        A = (ids[None, :] == torch.arange(128)[:, None]).double()
    else:
        c, j = divmod(off, 128 * W_)
        A = stream[c * 128:(c + 1) * 128, j:j + 16].double()
    return A @ B


def _emulate(plan, table, stream, W_, dstl, n_out):
    """The kernel's schedule: the blocks without a unit zeroed; each work
    item of ``plan.work`` sums its units in order in f32, a single item
    writes its block, several write partials that are added in item
    order."""
    out = torch.full((n_out * 128, D), float("nan"))
    for b in plan.zero_blk.tolist():
        out[b * 128:(b + 1) * 128] = 0
    parts = {}
    for u0, u1, b, slot in plan.work.tolist():
        acc = torch.zeros(128, D)
        for u in range(u0, u1):
            acc += _unit_product(table, stream, plan.units[u], W_,
                                 dstl).float()
        if slot < 0:
            out[b * 128:(b + 1) * 128] = acc
        else:
            parts.setdefault(b, []).append((slot, acc))
    for b, ps in parts.items():
        ps.sort(key=lambda x: x[0])
        s = torch.zeros(128, D)
        for _, p in ps:
            s += p
        out[b * 128:(b + 1) * 128] = s
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_plan_schedule_gives_the_plain_sums(case):
    """The plan's schedule, emulated (units summed per work item, split
    blocks' partials in item order), agrees with the plain version to f32
    rounding; blocks without a unit are exactly 0."""
    plan, (R, stream, ts, bot, win, kw, W_, stride, rows) = _plan(case)
    table = torch.tensor(_table(R))
    n_out = kw["n_blocks"] * rows // 128
    got = _emulate(plan, table, stream, W_, kw["dstl"], n_out)
    mkw = dict(n_blocks=kw["n_blocks"], window=W_, out_rows=rows,
               win_stride=kw.get("win_stride"), c_off=kw.get("c_off"),
               dstl=kw["dstl"])
    ref = W.window_block_spmm_mono_reference(table, stream, ts, bot, win,
                                             **mkw)
    mag = W.window_block_spmm_mono_reference(table.abs(), stream.abs(), ts,
                                             bot, win, **mkw)
    assert ((got - ref).abs() <= 2e-6 * mag + 1e-30).all()
    touched = torch.zeros(n_out, dtype=torch.bool)
    touched[plan.work[:, 2].long()] = True
    assert (~touched).any() and not touched[plan.zero_blk.long()].any()
    assert (got.reshape(n_out, 128, D)[~touched] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_mono_plan_reads_each_nonzero_group_once(case):
    """The units are each real (tile, slice)'s nonzero 16-row groups, once,
    in block order then tile order then group order: none from a dummy
    tile, an all-padding tile or a group without an id or count; each
    block's items hold its pairs in order, at most MONO_SPLIT each, as
    evenly as split_plan's item count allows, and the blocks of several
    items own consecutive partial slots."""
    plan, (R, stream, ts, bot, win, kw, W_, stride, rows) = _plan(case)
    S, ng, dstl = rows // 128, W_ // 16, kw["dstl"]
    c_off = kw.get("c_off")
    gm = W.group_mask(stream, W_, dstl)
    if dstl:
        want_gm = ((stream >= 0) & (stream < 128)).reshape(-1, ng, 16).any(2)
    else:
        want_gm = (stream.reshape(-1, 128, ng, 16) != 0).any(3).any(1)
    assert torch.equal(gm, want_gm)
    n_e = gm.shape[0] // S
    want, per = [], np.zeros(kw["n_blocks"] * S, np.int64)
    for b in range(kw["n_blocks"]):
        for s in range(S):
            for t in range(int(ts[b]), int(ts[b + 1])):
                c = t if c_off is None else int(c_off[t])
                if int(win[t]) < 0 or not 0 <= c < n_e:
                    continue
                groups = torch.nonzero(gm[c * S + s]).flatten().tolist()
                if groups:
                    per[b * S + s] += 1
                want += [(int(win[t]) * stride + 16 * g,
                          (c * S + s) * (W_ // 4) + 4 * g if dstl
                          else (c * S + s) * 8 * W_ + g) for g in groups]
    assert [tuple(u) for u in plan.units.tolist()] == want
    nit = np.maximum(1, -(-per // W.MONO_SPLIT))
    assert plan.item_first.tolist() == [0] + np.cumsum(nit).tolist()
    assert plan.n_items == nit.sum() and plan.n_part == nit[nit > 1].sum()
    assert plan.split.tolist() == np.nonzero(nit > 1)[0].tolist()
    # the items: those with a unit in ``work`` (in block order, each
    # block's own units in order), the others' blocks in ``zero_blk``
    work = plan.work.numpy()
    assert (np.diff(work[:, 2]) >= 0).all()
    assert work[0, 0] == 0 and (work[1:, 0] == work[:-1, 1]).all()
    assert work[-1, 1] == plan.units.shape[0]
    assert (work[:, 1] > work[:, 0]).all()
    zero = plan.zero_blk.numpy()
    assert zero.tolist() == np.nonzero(per == 0)[0].tolist()
    slot = 0
    for b in range(kw["n_blocks"] * S):
        mine = work[work[:, 2] == b]
        assert len(mine) == (0 if b in zero else nit[b])
        if nit[b] > 1:
            assert mine[:, 3].tolist() == list(range(slot, slot + nit[b]))
            slot += nit[b]
        else:
            assert (mine[:, 3] == -1).all()
    assert slot == plan.n_part


def test_mono_plan_cuts_items_evenly():
    """A block of n real pairs gets ceil(n / MONO_SPLIT) items whose pair
    counts differ by at most one (33 pairs: 17 + 16, not 32 + 1)."""
    plan, (R, stream, ts, bot, win, kw, W_, stride, rows) = _plan("dstl")
    # a unit's pair is its tile's stream entry here (one slice, no c_off)
    pair = plan.units[:, 1] // (W_ // 4)
    sizes = {}
    for u0, u1, b, _ in plan.work.tolist():
        sizes.setdefault(b, []).append(len(set(pair[u0:u1].tolist())))
    split = [v for v in sizes.values() if len(v) > 1]
    assert split
    for v in split:
        assert max(v) - min(v) <= 1 and max(v) <= W.MONO_SPLIT


# --- the pipeline's fragment layouts, emulated ------------------------------

def _perm16(r):
    """mono_pipe.cuh::perm16: the storage row of a group's row r."""
    return ((r & 1) << 3) | (r >> 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ids_fragments_give_the_one_hot_product(seed):
    """The dst-local form's A operand (stage_mma): a lane's 16-byte load of
    ids 4q .. 4q + 3 gives a0 = (id 4q, id 4q + 2) and a2 = (id 4q + 1,
    id 4q + 3) compared with its rows; the group's 16 table rows stored at
    perm16 and read by ldmatrix.trans as the mma's B (k-slot s holds the
    row stored there): the emulated m16n8k16 products over a warp's four
    m16-tiles (its 64 rows) equal onehot(ids) · rows exactly, ids outside
    the tile (−1, ≥ 128) adding nothing."""
    r = np.random.default_rng(seed)
    ids = r.integers(-1, 40, 16)
    ids[r.random(16) < 0.2] = 200
    rows = r.integers(-50, 50, (16, 64)).astype(np.float64)
    Bs = np.zeros_like(rows)
    Bs[[_perm16(k) for k in range(16)]] = rows
    for row0 in (0, 64):                  # the two warps' m-ranges
        got = np.zeros((64, 64))
        for mi in range(4):
            A = np.zeros((16, 16))        # the mma's A, by k-slot
            for lane in range(32):
                g, q = lane >> 2, lane & 3
                x, y, z, w = ids[4 * q:4 * q + 4]
                for ra, slot_rows in ((row0 + 16 * mi + g, g),
                                      (row0 + 16 * mi + g + 8, g + 8)):
                    A[slot_rows, 2 * q] = x == ra
                    A[slot_rows, 2 * q + 1] = z == ra
                    A[slot_rows, 2 * q + 8] = y == ra
                    A[slot_rows, 2 * q + 9] = w == ra
            got[16 * mi:16 * mi + 16] = A @ Bs
        want = (ids[None, :] == np.arange(row0, row0 + 64)[:, None]) @ rows
        np.testing.assert_array_equal(got, want)


def test_stage_copies_cover_each_chunk_once_without_bank_conflicts():
    """fetch_unit: warp w's lanes copy each of its unit's 16 rows × 16
    chunks once (idx = i·32 + lane), the counts' 128 rows once; a chunk c
    of storage row k lands at chunk c ^ (k & 7), so the 8 rows that one
    ldmatrix.trans phase reads at one logical chunk lie in 8 different
    16-byte bank groups, and so do the 8 chunks a quarter-warp writes."""
    seen = np.zeros((16, 16), int)
    for i in range(8):
        for lane in range(32):
            idx = i * 32 + lane
            seen[idx >> 4, idx & 15] += 1
    assert (seen == 1).all()
    assert sorted(i * 32 + lane for i in range(4) for lane in range(32)) \
        == list(range(128))
    phys = lambda k, c: (k * 16 + (c ^ (k & 7))) % 8      # bank group
    for k0 in range(0, 16, 8):
        for c in range(16):
            assert len({phys(k0 + i, c) for i in range(8)}) == 8
    for i in range(8):
        for quarter in range(4):
            idx = [i * 32 + quarter * 8 + t for t in range(8)]
            ks = [_perm16(x >> 4) for x in idx]
            assert len({phys(k, x & 15) for k, x in zip(ks, idx)}) == 8


# --- the checks, once per layout -------------------------------------------

def _count_host_copies(monkeypatch):
    calls = []
    real = G.host_ints

    def counting(*a):
        calls.append(len(a))
        return real(*a)
    for mod in (G, W, L):
        monkeypatch.setattr(mod, "host_ints", counting)
    return calls


def test_mono_plan_is_made_once_per_layout(monkeypatch):
    """mono_plan_once checks and plans a layout once: a second call copies
    nothing to the host and gives the same plan; another table height is
    checked again."""
    R, stream, ts, bot, win, kw = _torch_case("dstl")
    args = (stream, ts, win, None, kw["n_blocks"], 128, 16, 128, True)
    calls = _count_host_copies(monkeypatch)
    plan = W.mono_plan_once("window_block_spmm_mono", R, *args)
    assert calls
    n = len(calls)
    assert W.mono_plan_once("window_block_spmm_mono", R, *args) is plan
    assert len(calls) == n
    assert W.mono_plan_once("window_block_spmm_mono", R + 16,
                            *args) is not plan
    assert len(calls) > n


def test_mono_checks_raise_once_cached():
    """The cached checks raise with the wrappers' messages on a layout
    that does not fit its table or its stream, and again on a second call
    (a raise is not cached)."""
    R, stream, ts, bot, win, kw = _torch_case("counts")
    args = (stream, ts, win, None, kw["n_blocks"], 128, 16, 128, False)
    for _ in range(2):
        with pytest.raises(ValueError, match="not gathered with this layout"):
            W.mono_plan_once("window_block_spmm_mono", R // 2, *args)
    bad_c = torch.full((win.shape[0],), 10 ** 6, dtype=torch.int32)
    for _ in range(2):
        with pytest.raises(ValueError, match="layout and arguments disagree"):
            W.mono_plan_once("window_block_spmm_mono", R, stream, ts, win,
                             bad_c, *args[4:])
    bad_ts = ts.clone()
    bad_ts[-1] = win.shape[0] + 5
    with pytest.raises(ValueError, match="tile_start runs from"):
        W.mono_plan_once("window_block_spmm_mono", R, stream, bad_ts, win,
                         None, *args[4:])


@pytest.mark.parametrize("how", ["two entries", "entry 2", "entry -1"])
def test_onehot_check_refuses_a_stream_that_is_not_one_hot(how):
    """#8's check, in the group mask's one pass over the stream, once per
    layout on the card: a column with two entries or an entry other than 1
    raises today's message; the builder's stream passes, with the count
    form's mask."""
    lay = _legacy(False, align=None)
    onehot = torch.tensor(lay.onehot)
    name = "onehot_segment_scatter_flat"
    assert torch.equal(W.group_mask(onehot, 128, False, onehot_of=name),
                       W.group_mask(onehot, 128, False))
    bad = onehot.clone().reshape(-1, 128, 128)
    if how == "two entries":
        col = torch.nonzero(bad[0].any(0)).flatten()[0]
        row = int(torch.nonzero(bad[0, :, col]).flatten()[0])
        bad[0, (row + 1) % 128, col] = 1
    else:
        i, r, j = (int(x[0]) for x in torch.nonzero(bad, as_tuple=True))
        bad[i, r, j] = 2 if how == "entry 2" else -1
    with pytest.raises(ValueError, match=f"{name}: .* not a one-hot layout"):
        W.group_mask(bad.reshape(onehot.shape), 128, False, onehot_of=name)


@pytest.mark.parametrize("window", [7, 6, 20, 24, 40, 128])
def test_group_mask_at_any_window(window):
    """The one-hot check and mask at windows of no multiple of 16 (the
    kept kernels' tile_e; words of 1, 2 or 8 bytes), the last group short,
    a column of 128 entries refused; the count mask of a
    signed stream whose nonzero bytes cancel in a sum, or make an 8-byte
    word −2**63 alone."""
    rng = np.random.default_rng(window)
    n = 5
    oh = np.zeros((n, 128, window), np.int8)
    for t in range(n):
        cols = rng.choice(window, window // 3, replace=False)
        oh[t, rng.integers(0, 128, cols.size), cols] = 1
    oh[2] = 0
    x = torch.tensor(oh.reshape(n * 128, window))
    ng = -(-window // 16)
    pad = np.zeros((n, 128, ng * 16), bool)
    pad[:, :, :window] = oh != 0
    want = torch.tensor(pad.reshape(n, 128, ng, 16).any((1, 3)))
    assert torch.equal(W.group_mask(x, window, False, onehot_of="f"), want)
    full = x.clone().view(n, 128, window)
    full[1, :, window - 1] = 1                  # 128 entries in a column
    with pytest.raises(ValueError, match="not a one-hot layout"):
        W.group_mask(full.view(x.shape), window, False, onehot_of="f")
    if window % 16 == 0:
        assert torch.equal(W.group_mask(x, window, False), want)
        c = np.zeros((n, 128, window), np.int8)
        c[0, 3, 5], c[0, 90, 5] = 1, -1          # cancel in a column sum
        c[1, 7, 16 * ng - 1] = -128              # a word of −2**63
        c[3, 127, window - 1] = 127
        want_c = (c != 0).reshape(n, 128, ng, 16).any((1, 3))
        got = W.group_mask(torch.tensor(c.reshape(n * 128, window)), window,
                           False)
        assert torch.equal(got, torch.tensor(want_c))


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke


@pytest.mark.cuda
def test_mono_seams_on_card():
    """The bf16 pipeline against the plain versions at chip_smoke's seams
    (#11's three forms at 128- and 256-row blocks, #8 at tile_e 128 and
    2048, #9), f32 and bf16 out, twice bit-equal:
    chip_smoke.mono_seam_fuzz."""
    _card().mono_seam_fuzz({})


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_window_block_spmm_mono_on_card(case, out_dtype):
    """#11's bf16 kernel on this file's seam layouts on the card: within
    chip_smoke's per-element bound of its plain version (flush_bound),
    twice bit-equal, empty blocks exactly 0."""
    cs = _card()
    R, stream, ts, bot, win, kw = _torch_case(case)
    dev = torch.device("cuda")
    mv = lambda x: x.to(dev) if torch.is_tensor(x) else x
    kw = {k: mv(v) for k, v in kw.items()}
    args = [mv(x) for x in (stream, ts, bot, win)]
    odt = getattr(torch, out_dtype)
    table = torch.tensor(_table(R)).to(dev, torch.bfloat16)
    got = W.window_block_spmm_mono(table, *args, out_dtype=odt, **kw)
    cs.same_twice("window_block_spmm_mono", case, got,
                  W.window_block_spmm_mono(table, *args, out_dtype=odt,
                                           **kw))
    ref = W.window_block_spmm_mono_reference(table, *args, out_dtype=odt,
                                             **kw)
    cs.check(f"window_block_spmm_mono[{case}]", got, ref, "bound",
             torch.bfloat16, {}, bound=cs.flush_bound(
                 lambda t: W.window_block_spmm_mono_reference(
                     t, *args, **kw), table, ref, odt))
