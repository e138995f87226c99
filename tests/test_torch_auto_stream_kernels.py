"""Kernels #20 (``window_block_spmm``: the gather-sum of
``csrc/window_auto_gather.cu`` on the plan of ``ops/window.py::
window_auto_plan``) and #18 (``onehot_segment_scatter_stream``: #11's count
form on ``csrc/window_mono_fused.cu``, the plan of ``ops/legacy.py::
stream_plan_once``), their plans emulated in plain torch against the JAX
kernels.

The same seeded numpy inputs go to both packages; the JAX kernels run in
Pallas interpret mode.  The layouts hold the seams: the reference's
variant-test window layout (W 64), a clustered W 256 layout with dummy
tiles and a compact count stream (c_off), a block without tiles, a hub dst
row whose entries several work items share, signed counts (−128, −1, 127
and the like, which the TPU kernels cast and multiply), and for #18 a
stream of values 2, −3 and 127 that is not one-hot.
Tolerances:

- #20's plan rebuilt into count tiles, and the plans' integers: exact;
- the plans' schedules emulated in f32 (work items summed in order, split
  rows' or blocks' partials added in item order) against the JAX kernels:
  the tolerance of ``tests/test_torch_variants.py``'s tests of the same
  functions: f32 rtol = atol = 1e-6; bf16 2e-5·max(1, |ref|) per element
  (bf16·int8 products are exact in f32); at #20's hub rows with signed
  counts (sums of hundreds of terms up to 127·|row|, in another f32 order
  than the JAX kernel's) each element within 2e-6 of its Σ|count·row| of
  the f64 plain sums, and the JAX kernel within 4e-6 of it; the same for
  #18's stream of counts to 127, whose sums cancel;
- #5's plain version at a hub row of 3,000 terms: exactly the f64 sums
  rounded once; against the JAX kernel in bf16 the tolerance of
  ``tests/test_torch_train_ops.py`` (rtol 2**-7, atol 1e-5), in f32 each
  element within 2e-6 of its Σ|terms| (the JAX kernel's f32 sums drift);
- blocks without a tile, or without a real edge: exactly 0.

The tests marked ``cuda`` hold the new bodies (bf16 at D = 128) against
their plain versions on the card, twice bit-equal; they skip without one.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SPJ
from ggnn_tpu.ops import window_pallas as WPJ
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
NAMES = ("c_stream", "tile_start", "block_of_tile", "win_of_tile")


def _close(got, ref, dtype, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
    else:
        assert (np.abs(got - ref) <= 2e-5 * np.maximum(1.0, np.abs(ref))
                ).all(), what


def _edges(rng, N, E, T2, cluster=False, hub=0):
    """Uniform random edges (10 % masked), with ``cluster`` 90 % of the
    sources in their destination's 128-row block, and ``hub`` more edges
    from distinct sources into dst row 5."""
    src = rng.integers(0, N, E)
    dst = rng.integers(0, N, E)
    typ = rng.integers(0, T2, E)
    mask = np.where(rng.random(E) < 0.1, 0.0, 1.0)
    if cluster:
        src = np.where(rng.random(E) < 0.9,
                       (dst // 128) * 128 + rng.integers(0, 128, E),
                       src) % N
    if hub:
        src = np.concatenate([src, rng.permutation(N)[:hub] if hub <= N
                              else rng.integers(0, N, hub)])
        dst = np.concatenate([dst, np.full(hub, 5)])
        typ = np.concatenate([typ, np.zeros(hub, np.int64)])
        mask = np.concatenate([mask, np.ones(hub)])
    return (src.astype(np.int32), dst.astype(np.int32), typ.astype(np.int32),
            mask.astype(np.float32))


def _signed(c, rng):
    """A copy of the count stream with a fifth of its nonzero bytes set to
    2, −3, 127, −128 or −1."""
    c = c.copy()
    flat = c.reshape(-1)
    nz = np.nonzero(flat)[0]
    pick = nz[rng.random(nz.shape[0]) < 0.2]
    flat[pick] = np.array([2, -3, 127, -128, -1], np.int8)[
        rng.integers(0, 5, pick.shape[0])]
    return c


# tag: (N, E, T2, W, min_edges_per_tile, extra dummy tiles, cluster, hub,
#       signed, the block whose tiles are dropped)
WINDOW_CASES = {
    "W64_variants_agree": (512, 900, 4, 64, 1, 0, False, 0, False, None),
    "W256_dummies": (1024, 12_000, 4, 256, 4, 40, True, 0, False, None),
    "W256_block_without_tiles": (1024, 12_000, 4, 256, 4, 40, True, 0,
                                 False, 3),
    "W64_hub_signed": (1024, 6000, 4, 64, 1, 0, True, 900, True, None),
    "W256_hub_signed_dummies": (1024, 12_000, 4, 256, 4, 40, True, 900,
                                True, 3),
}


def _window_case(tag):
    """(layout arrays as numpy, table rows, window, n_blocks)."""
    N, E, T2, Wn, mept, pad, cluster, hub, signed, drop = WINDOW_CASES[tag]
    rng = np.random.default_rng(0)
    edges = _edges(rng, N, E, T2, cluster, hub)
    lay = W.build_window_layout(*edges, N, window=Wn, min_edges_per_tile=mept)
    if pad:
        lay = W.build_window_layout(*edges, N, window=Wn,
                                    min_edges_per_tile=mept,
                                    pad_tiles_to=lay.n_tiles + pad)
    a = {k: np.asarray(v) for k, v in lay.arrays.items()}
    if drop is not None:   # no tile at all for this block
        ts = a["tile_start"]
        t0, t1 = ts[drop], ts[drop + 1]
        keep = np.ones(a["win_of_tile"].shape[0], bool)
        keep[t0:t1] = False
        a["tile_start"] = np.concatenate(
            [ts[:drop + 1], ts[drop + 1:] - (t1 - t0)]).astype(np.int32)
        for k in ("block_of_tile", "win_of_tile", "c_off"):
            a[k] = a[k][keep]
    if signed:
        a["c_stream"] = _signed(a["c_stream"], rng)
    R = T2 * N
    return a, R + (-R) % Wn, Wn, lay.n_blocks


def _plan(tag):
    a, R, Wn, nb = _window_case(tag)
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    plan = W.window_auto_plan(t["c_stream"], t["block_of_tile"],
                              t["win_of_tile"], t["c_off"], nb, Wn, R)
    return plan, a, t, R, Wn, nb


def _entries(plan):
    """(table rows, counts) of the plan's entries as int64."""
    if plan.packed:
        e = plan.ent.long() & 0xFFFFFFFF
        return e >> 8, ((e & 0xFF) ^ 0x80) - 0x80
    return plan.ent[:, 0].long(), plan.ent[:, 1].long()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tag", sorted(WINDOW_CASES))
def test_window_auto_plan_rebuilds_the_real_count_tiles(tag, packed,
                                                        monkeypatch):
    """#20's plan, its entries put back as count bytes of (output block,
    window), equals the stream's real tiles byte for byte (dummy tiles and
    zero bytes give no entry), in 4-byte entries and (as for a table of
    2**24 rows or more) in 8-byte ones; every output row has items in
    order, at most AUTO_SPLIT entries each, cut evenly, covering its
    entries once; the rows of several items own consecutive partial
    slots."""
    if not packed:
        monkeypatch.setattr(W, "_PACK_ROWS", 0)
    plan, a, t, R, Wn, nb = _plan(tag)
    assert plan.packed == packed
    rows, v = _entries(plan)
    items = plan.items.long().numpy()
    n_rows = nb * 128
    # the items: every row, in order, contiguous entries, cut evenly
    assert (np.diff(items[:, 2]) >= 0).all()
    assert items[0, 0] == 0 and (items[1:, 0] == items[:-1, 1]).all()
    assert items[-1, 1] == rows.shape[0]
    per_row = np.bincount(items[:, 2], weights=items[:, 1] - items[:, 0],
                          minlength=n_rows).astype(np.int64)
    nit = np.bincount(items[:, 2], minlength=n_rows)
    assert (nit == np.maximum(1, -(-per_row // W.AUTO_SPLIT))).all()
    sizes = items[:, 1] - items[:, 0]
    assert sizes.max() <= W.AUTO_SPLIT
    assert plan.item_first.tolist() == [0] + np.cumsum(nit).tolist()
    assert plan.split.tolist() == np.nonzero(nit > 1)[0].tolist()
    slot = 0
    for it in items:
        if nit[it[2]] > 1:
            assert it[3] == slot
            slot += 1
        else:
            assert it[3] == -1
    assert slot == plan.n_part
    for r in np.nonzero(nit > 1)[0]:
        s = sizes[items[:, 2] == r]
        assert s.max() - s.min() <= 1
    if "hub" in tag:
        assert 5 in plan.split.tolist()
    # the entries put back into count bytes
    out_row = np.repeat(items[:, 2], sizes)
    got = {}
    for o, row, c in zip(out_row, rows.tolist(), v.tolist()):
        key = (o // 128, row // Wn)
        tile = got.setdefault(key, np.zeros((128, Wn), np.int64))
        assert tile[o % 128, row % Wn] == 0
        tile[o % 128, row % Wn] = c
    want = {}
    c_stream = a["c_stream"].reshape(-1, 128, Wn)
    for tt in range(a["win_of_tile"].shape[0]):
        w = int(a["win_of_tile"][tt])
        if w < 0:
            continue
        key = (int(a["block_of_tile"][tt]), w)
        assert key not in want
        want[key] = c_stream[int(a["c_off"][tt])].astype(np.int64)
    want = {k: x for k, x in want.items() if x.any()}
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k] == want[k]).all(), k
    if "signed" in tag:
        assert v.min() == -128 and v.max() == 127 and (v == -1).any()


def _emulate_auto(plan, table):
    """The kernel's schedule: each item sums count · row over its entries
    in order in f32; a row of one item is its sum, a split row the sum of
    its partials in item order."""
    rows, v = _entries(plan)
    n_rows = plan.item_first.shape[0] - 1
    out = torch.full((n_rows, table.shape[1]), float("nan"))
    x = table.float()
    parts = {}
    for f, e, row, slot in plan.items.tolist():
        acc = torch.zeros(table.shape[1])
        for q in range(f, e):
            acc = acc + float(v[q]) * x[rows[q]]
        if slot < 0:
            out[row] = acc
        else:
            parts.setdefault(row, []).append((slot, acc))
    for row, ps in parts.items():
        s = torch.zeros(table.shape[1])
        for _, p in sorted(ps, key=lambda z: z[0]):
            s = s + p
        out[row] = s
    return out


def _jax_auto(a, table, dtype, nb, Wn):
    return np.asarray(WPJ.window_block_spmm(
        jnp.asarray(table, _JDT[dtype]), *(jnp.asarray(a[k]) for k in NAMES),
        n_blocks=nb, window=Wn, c_off=jnp.asarray(a["c_off"]),
        interpret=True))


def _auto_inputs(tag, dtype, D=16):
    plan, a, t, R, Wn, nb = _plan(tag)
    table = np.random.default_rng(1).standard_normal((R, D)).astype(
        np.float32)
    if dtype == "bfloat16":
        table = np.asarray(jnp.asarray(table, jnp.bfloat16).astype(
            jnp.float32))
    got = _emulate_auto(plan, torch.tensor(table).to(_TDT[dtype]))
    return plan, a, t, R, Wn, nb, table, got.numpy().reshape(nb, 128, D)


@pytest.fixture
def small_items(monkeypatch):
    """Work items of at most 32 entries, so that more rows split."""
    monkeypatch.setattr(W, "AUTO_SPLIT", 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", ["W64_variants_agree", "W256_dummies",
                                 "W256_block_without_tiles"])
def test_window_auto_schedule_matches_jax(tag, dtype, small_items):
    """#20's plan summed as the kernel sums it (f32, item order; items of
    at most 32 entries, so that more rows split) against the JAX kernel in
    interpret mode on the blocks with a tile (the layouts and tolerance of
    ``tests/test_torch_variants.py::test_window_block_spmm_matches_jax``),
    and exactly 0 on the others."""
    plan, a, t, R, Wn, nb, table, g = _auto_inputs(tag, dtype)
    ref = _jax_auto(a, table, dtype, nb, Wn).reshape(g.shape)
    has_tile = np.diff(a["tile_start"]) > 0
    if tag.endswith("tiles"):
        assert not has_tile.all()
    _close(g[has_tile], ref[has_tile], dtype, tag)
    assert (g[~has_tile] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", ["W64_hub_signed", "W256_hub_signed_dummies"])
def test_window_auto_schedule_at_a_hub_with_signed_counts(tag, dtype,
                                                          small_items):
    """The same schedule where a hub row is split into several items and
    the counts are signed (values to ±128): each element within 2e-6 of
    Σ|count·row| of the plain version's f64 sums (f32 sums of up to 32
    entries, then the partials), and the JAX kernel's f32 sums within
    4e-6 of it (two f32 orders); blocks without a tile exactly 0."""
    plan, a, t, R, Wn, nb, table, g = _auto_inputs(tag, dtype)
    assert 5 in plan.split.tolist()
    args = (t["tile_start"], t["block_of_tile"], t["win_of_tile"], nb, Wn)
    tt = torch.tensor(table)
    plain = W.window_block_spmm_reference(tt, t["c_stream"], *args,
                                          c_off=t["c_off"])
    mag = W.window_block_spmm_reference(
        tt.abs(), t["c_stream"].to(torch.int16).abs(), *args,
        c_off=t["c_off"]).numpy().reshape(g.shape)
    plain = plain.numpy().reshape(g.shape)
    assert (np.abs(g - plain) <= 2e-6 * mag + 1e-30).all()
    ref = _jax_auto(a, table, dtype, nb, Wn).reshape(g.shape)
    has_tile = np.diff(a["tile_start"]) > 0
    assert (np.abs(g - ref)[has_tile] <= 4e-6 * mag[has_tile] + 1e-30).all()
    assert (g[~has_tile] == 0).all()


@pytest.mark.parametrize("how", ["two tiles read one entry",
                                 "an entry no real tile reads"])
def test_window_auto_plan_reads_each_real_tiles_entry(how):
    """Where two real tiles read one count entry (the plan then gathers
    the tiles' entries instead of reading the stream in place), the plan
    holds the shared entry's bytes twice; where a real tile turns dummy,
    its entry's nonzero bytes make no entry.  Either way the plan summed
    as the kernel sums it agrees with the plain version (each element
    within 2e-6 of Σ|count·row|)."""
    a, R, Wn, nb = _window_case("W256_dummies")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    real = torch.nonzero(t["win_of_tile"] >= 0).flatten()
    c_off, win = t["c_off"].clone(), t["win_of_tile"].clone()
    cs = t["c_stream"].view(-1, 128 * Wn)
    nz = lambda e: int((cs[int(e)] != 0).sum())
    base = W.window_auto_plan(t["c_stream"], t["block_of_tile"], win, c_off,
                              nb, Wn, R)
    if how == "two tiles read one entry":
        c_off[real[1]] = c_off[real[0]]
        want = (base.ent.shape[0] - nz(t["c_off"][real[1]])
                + nz(c_off[real[0]]))
    else:
        win[real[0]] = -1
        want = base.ent.shape[0] - nz(c_off[real[0]])
    assert nz(t["c_off"][real[0]]) > 0
    plan = W.window_auto_plan(t["c_stream"], t["block_of_tile"], win, c_off,
                              nb, Wn, R)
    assert plan.ent.shape[0] == want
    args = (t["tile_start"], t["block_of_tile"], win, nb, Wn)
    table = torch.randn(R, 8, generator=torch.Generator().manual_seed(2))
    got = _emulate_auto(plan, table)
    ref = W.window_block_spmm_reference(table, t["c_stream"], *args,
                                        c_off=c_off)
    mag = W.window_block_spmm_reference(table.abs(), t["c_stream"], *args,
                                        c_off=c_off)
    assert ((got - ref).abs() <= 2e-6 * mag + 1e-30).all()


# --- #18 ------------------------------------------------------------------

STREAM_CASES = {
    # tag: (N, E, T2, tile_e, dst range, hub edges)
    "tile_e128_empty": (1024, 3000, 4, 128, 512, 0),
    "tile_e128_hub": (1024, 4000, 4, 128, None, 5000),
}


def _stream_case(tag, dtype, seed=0):
    """A legacy layout whose one-hot holds 2, −3 and 127 in place of some
    1s and a second entry, 2, in some columns (not a one-hot), and random
    messages; the blocks without a real edge."""
    N, E, T2, tile_e, dst_hi, hub = STREAM_CASES[tag]
    rng = np.random.default_rng(seed)
    src, dst, typ, mask = _edges(rng, N, E, T2, hub=hub)
    if dst_hi:
        dst = dst % dst_hi
    lay = L.build_dst_block_layout(src, dst, typ, mask, N, tile_e=tile_e)
    oh = lay.onehot.copy().reshape(-1, 128, tile_e)
    i, r, j = np.nonzero(oh)
    pick = rng.random(i.shape[0]) < 0.3
    oh[i[pick], r[pick], j[pick]] = np.array([2, -3, 127], np.int8)[
        rng.integers(0, 3, pick.sum())]
    two = rng.random(i.shape[0]) < 0.1
    oh[i[two], (r[two] + 1) % 128, j[two]] = 2
    oh = oh.reshape(lay.onehot.shape)
    for val in (2, -3, 127):
        assert (oh == val).any()
    msgs = rng.standard_normal((lay.gather_idx.shape[0], 16)).astype(
        np.float32)
    if dtype == "bfloat16":
        msgs = np.asarray(jnp.asarray(msgs, jnp.bfloat16).astype(jnp.float32))
    real = (lay.dst_local.reshape(-1, tile_e) >= 0).any(1)
    has_edge = np.bincount(lay.block_of_tile, weights=real,
                           minlength=lay.n_blocks) > 0
    return lay, oh, msgs, has_edge


def _unit_product(table, stream, unit, W_):
    """One count-form unit's [128, D] f64 product: its 16 table rows times
    its [128, 16] count bytes."""
    row, off = int(unit[0]), 16 * int(unit[1])
    c, j = divmod(off, 128 * W_)
    A = stream[c * 128:(c + 1) * 128, j:j + 16].double()
    return A @ table[row:row + 16].double()


def _emulate_mono(plan, table, stream, W_, n_out):
    """#11's pipeline schedule (as ``tests/test_torch_mono_kernels.py``):
    blocks without a unit zeroed; each work item sums its units in order
    in f32; split blocks' partials added in item order."""
    D = table.shape[1]
    out = torch.full((n_out * 128, D), float("nan"))
    for b in plan.zero_blk.tolist():
        out[b * 128:(b + 1) * 128] = 0
    parts = {}
    for u0, u1, b, slot in plan.work.tolist():
        acc = torch.zeros(128, D)
        for u in range(u0, u1):
            acc += _unit_product(table, stream, plan.units[u], W_).float()
        if slot < 0:
            out[b * 128:(b + 1) * 128] = acc
        else:
            parts.setdefault(b, []).append((slot, acc))
    for b, ps in parts.items():
        s = torch.zeros(128, D)
        for _, p in sorted(ps, key=lambda z: z[0]):
            s += p
        out[b * 128:(b + 1) * 128] = s
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", sorted(STREAM_CASES))
def test_stream_count_schedule_matches_jax(tag, dtype):
    """#18's count-form plan (:func:`stream_plan_once`, the blocks from
    tile_start) summed as #11's pipeline sums it, against the JAX kernel
    in interpret mode on a stream that is not one-hot (2, −3, 127, two
    entries in a column): each element within 2e-6 of Σ|count·message| of
    the plain version's f64 sums, the JAX kernel's f32 sums within 4e-6 of
    it (the counts to 127 make sums that cancel); blocks without a real
    edge exactly 0; the hub block cut into several work items."""
    lay, oh, msgs, has_edge = _stream_case(tag, dtype)
    tile_e, nb = lay.tile_e, lay.n_blocks
    ts = torch.as_tensor(lay.tile_start)
    toh = torch.as_tensor(oh)
    plan = L.stream_plan_once(msgs.shape[0], toh, ts, nb, lay.max_tiles,
                              tile_e, True)
    if tag.endswith("hub"):
        assert plan.split.shape[0] > 0
    tm = torch.tensor(msgs).to(_TDT[dtype])
    got = _emulate_mono(plan, tm, toh, tile_e, nb).numpy()
    ref = np.asarray(SPJ.onehot_segment_scatter_stream(
        jnp.asarray(msgs, _JDT[dtype]), jnp.asarray(oh),
        jnp.asarray(lay.tile_start), n_blocks=nb, max_tiles=lay.max_tiles,
        tile_e=tile_e, interpret=True))
    plain = L.onehot_segment_scatter_stream(tm, toh, ts, nb, lay.max_tiles,
                                            tile_e).numpy()
    mag = L.onehot_segment_scatter_stream_reference(
        tm.abs(), toh.to(torch.int16).abs(), ts, nb, lay.max_tiles,
        tile_e).numpy()
    assert (np.abs(got - plain) <= 2e-6 * mag + 1e-30).all()
    assert (np.abs(got - ref) <= 4e-6 * mag + 1e-30).all()
    g = got.reshape(nb, 128, -1)
    if tag.endswith("empty"):
        assert not has_edge.all()
    assert (g[~has_edge] == 0).all()


# --- the plans, once per layout ---------------------------------------------

def _count_host_copies(monkeypatch):
    calls = []
    real = G.host_ints

    def counting(*a):
        calls.append(len(a))
        return real(*a)
    for mod in (G, W, L):
        monkeypatch.setattr(mod, "host_ints", counting)
    return calls


def test_window_auto_plan_is_made_once_per_layout(monkeypatch):
    """#20's checks and plan run once per layout: a second call copies
    nothing to the host and gives the same plan; another table height is
    checked and planned again."""
    a, R, Wn, nb = _window_case("W256_dummies")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    args = (*(t[k] for k in NAMES), t["c_off"], nb, Wn)
    calls = _count_host_copies(monkeypatch)
    plan = W.window_auto_plan_once("window_block_spmm", R, *args)
    assert calls
    n = len(calls)
    assert W.window_auto_plan_once("window_block_spmm", R, *args) is plan
    assert len(calls) == n
    assert W.window_auto_plan_once("window_block_spmm", R + Wn,
                                   *args) is not plan
    assert len(calls) > n


def test_window_auto_checks_raise_once_cached():
    """The cached checks raise with the wrapper's messages on a layout
    that does not fit its table, its stream or its tile_start, and again
    on a second call (a raise is not cached)."""
    a, R, Wn, nb = _window_case("W64_variants_agree")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    cs, ts, bt, wt, c_off = (*(t[k] for k in NAMES), t["c_off"])
    once = lambda *x: W.window_auto_plan_once("window_block_spmm", *x)
    for _ in range(2):
        with pytest.raises(ValueError, match="not gathered with this layout"):
            once(Wn, cs, ts, bt, wt, c_off, nb, Wn)
    for _ in range(2):
        with pytest.raises(ValueError, match="side-stream entries"):
            once(R, cs, ts, bt, wt, c_off + 1000, nb, Wn)
    bad = bt.clone()
    bad[0] += 1
    for _ in range(2):
        with pytest.raises(ValueError, match="block_of_tile names another"):
            once(R, cs, ts, bad, wt, c_off, nb, Wn)


@pytest.mark.parametrize("pipe", [True, False])
def test_stream_plan_is_made_once_per_layout(monkeypatch, pipe):
    """#18's checks (and, for #11's pipeline, its plan) run once per
    layout and max_tiles: a second call copies nothing to the host; a
    max_tiles below a block's count raises, on every call."""
    lay, oh, msgs, _ = _stream_case("tile_e128_hub", "float32")
    ts, toh = torch.as_tensor(lay.tile_start), torch.as_tensor(oh)
    args = (msgs.shape[0], toh, ts, lay.n_blocks)
    calls = _count_host_copies(monkeypatch)
    plan = L.stream_plan_once(*args, lay.max_tiles, lay.tile_e, pipe)
    assert calls and (plan is None) != pipe
    n = len(calls)
    assert L.stream_plan_once(*args, lay.max_tiles, lay.tile_e, pipe) is plan
    assert len(calls) == n
    for _ in range(2):
        with pytest.raises(ValueError, match="more than max_tiles"):
            L.stream_plan_once(*args, lay.max_tiles - 1, lay.tile_e, pipe)


# --- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(WINDOW_CASES))
def test_window_auto_gather_on_card(tag):
    """#20's gather body in bf16 at D = 128 against its plain version on
    the card (chip_smoke's per-element bound, over |counts|), twice
    bit-equal, blocks without a real tile exactly 0, and the launch
    counted."""
    cs = _card()
    a, R, Wn, nb = _window_case(tag)
    dev = torch.device("cuda")
    t = {k: torch.as_tensor(v).to(dev) for k, v in a.items()}
    before = W.window_block_spmm.launches
    log = {}
    cs.check_window_auto(tag, (*(t[k] for k in NAMES), t["c_off"]), R, Wn,
                         nb, log, (128,))
    assert W.window_block_spmm.launches > before
    assert log["window_block_spmm"]


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(STREAM_CASES))
def test_stream_count_form_on_card(tag):
    """#18 in bf16 at D = 128 (#11's count form) and at D = 16 (#19's
    body) on the stream that is not one-hot, against its plain version
    (chip_smoke's per-element bound, over |stream|), twice bit-equal,
    blocks without a real edge exactly 0."""
    cs = _card()
    lay, oh, _, _ = _stream_case(tag, "bfloat16")
    dlay = lay.to("cuda")
    log = {}
    cs.check_stream_scatters(tag, dlay, log, (16, 128),
                             onehot=torch.as_tensor(oh).to("cuda"))
    assert log["onehot_segment_scatter_stream"]


# --- #5's plain version at a hub row ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_octet_plain_sums_a_hub_row_in_f64(dtype):
    """#5 ``typed_grad_octet_scatter``'s plain version on an octet grad
    layout with a hub row (3,000 edges leave source 5 with type 0: one
    row of Y sums 3,000 cotangent rows) against the JAX kernel in
    interpret mode (bf16 out: the tolerance of
    ``tests/test_torch_train_ops.py``, rtol 2**-7, atol 1e-5; f32: each
    element within 2e-6 of its Σ|terms|, since the JAX kernel's own f32
    sums of the hub row drift past that file's 1e-5), and equal to the
    exact f64 sums (numpy ``add.at``) rounded once."""
    from ggnn_tpu_torch.ops import scatter as S
    r = np.random.default_rng(5)
    N, E, T2, hub, D = 1024, 3000, 4, 3000, 128
    src = np.concatenate([r.integers(0, N, E), np.full(hub, 5)])
    dst = np.concatenate([r.integers(0, N, E), r.integers(0, N, hub)])
    typ = np.concatenate([r.integers(0, T2, E), np.zeros(hub, np.int64)])
    edges = (src.astype(np.int32), dst.astype(np.int32),
             typ.astype(np.int32), np.ones(E + hub, np.float32))
    lay_j = SPJ.build_typed_dst_layout(*edges, N, T2, with_grad=True,
                                       grad_tile_e=512)
    lay = S.build_typed_dst_layout(*edges, N, T2, with_grad=True,
                                   grad_tile_e=512)
    assert lay.meta[5][0] == "octet" and lay_j.meta[5][0] == "octet"
    _, _, g_tile, C, R8, span8, n_oct = lay.meta[5]
    kw = dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8)
    names = ("g_dstl_oct", "g_slot_off16", "g_oblk16")
    jdt, tdt = _JDT[dtype], _TDT[dtype]
    Gp = r.standard_normal((lay.arrays["g_gather_idx"].shape[0], D)).astype(
        np.float32)
    Gp = np.asarray(jnp.asarray(Gp, jdt).astype(jnp.float32))
    ref = SPJ.typed_grad_octet_scatter(
        jnp.asarray(Gp, jdt), *(jnp.asarray(lay_j.arrays[k]) for k in names),
        **kw, out_dtype=jdt, interpret=True)
    got = S.typed_grad_octet_scatter(
        torch.tensor(Gp).to(tdt), *(torch.as_tensor(lay.arrays[k])
                                    for k in names), **kw, out_dtype=tdt)
    ref = np.asarray(ref, np.float32)
    if dtype == "bfloat16":
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7,
                                   atol=1e-5)
    else:   # the JAX kernel's f32 sums of the hub row drift (~3e-5)
        mag = S.typed_grad_octet_scatter(
            torch.tensor(np.abs(Gp)), *(torch.as_tensor(lay.arrays[k])
                                        for k in names), **kw).numpy()
        assert (np.abs(got.numpy() - ref) <= 2e-6 * mag + 1e-30).all()
    # the exact sums: every packed row of each valid slot into its row
    dl = lay.arrays["g_dstl_oct"].reshape(n_oct, R8, g_tile)[:, :8 * C]
    dl = dl.reshape(n_oct, 8, C, g_tile).astype(np.int64)
    off = lay.arrays["g_slot_off16"].reshape(n_oct, 8, C).astype(np.int64)
    rows = ((lay.arrays["g_oblk16"].astype(np.int64)[:, None, None] + off)
            * 16)[..., None] + np.arange(g_tile)
    valid = (dl >= 0) & (off[..., None] >= 0)
    blk = np.arange(n_oct * 8).reshape(n_oct, 8, 1, 1)
    tgt = (blk * 128 + dl)[valid]
    want = np.zeros((n_oct * 8 * 128, D))
    np.add.at(want, tgt, Gp[rows[valid]].astype(np.float64))
    assert np.bincount(tgt).max() >= hub      # the hub row
    exact = torch.tensor(want).to(tdt)
    assert torch.equal(got, exact)
