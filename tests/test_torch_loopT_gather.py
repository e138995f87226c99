"""Kernel #19 ``onehot_segment_scatter_loopT`` as #20's gather-sum
(``csrc/window_auto_gather.cu``) on the plan of ``ops/legacy.py::
loopT_plan_once``: the plan against the stream it lists, its schedule
emulated in plain torch against the JAX kernel, and the checks and plan
made once per layout.

The same seeded numpy inputs go to both packages; the JAX kernel runs in
Pallas interpret mode.  The layouts are ``tests/test_torch_variants.py``'s
``SCATTER_LAYOUTS`` (the reference's variant-test layout at tile_e 8, and
tile_e 128 with empty dst blocks), a hub dst row (its entries cut into
several work items), a ``tile_start`` that ends before the stream does
(the tiles past it unused), and a signed stream that is not one-hot (2,
−3, 127, −128, −1, and a second entry, −1, in some columns), which the
TPU kernel casts and multiplies.  Tolerances:

- the plan put back into one-hot bytes, and its integers: exact;
- the schedule emulated (each work item's entries summed in order by
  f32 fmas, a split row's partials added in item order) against the JAX
  kernel: ``tests/test_torch_variants.py``'s tolerance of the same
  function, f32 rtol = atol = 1e-6, bf16 2e-5·max(1, |ref|) per element;
  on the hub and signed layouts (sums of up to hundreds of terms up to
  127·|row| that cancel, in another f32 order than the JAX kernel's)
  ``tests/test_torch_auto_stream_kernels.py``'s: each element within 2e-6
  of its Σ|value·row| of the plain version's f64 sums, and the JAX kernel
  within 4e-6 of it;
- blocks without a real edge in a used tile: exactly 0.

The test marked ``cuda`` holds the kernel against its plain version on
the card, twice bit-equal; it skips without one.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SPJ
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

LAYOUTS = {
    # tag: (N, E, T2, tile_e, dst range, hub edges into row 5, signed,
    #       the first block whose tiles are cut off the end of tile_start, D)
    "variants_agree": (256, 500, 4, 8, None, 0, False, None, 16),
    "tile_e128_empty": (1024, 3000, 4, 128, 512, 0, False, None, 8),
    "tile_e128_cut": (1024, 3000, 4, 128, 512, 0, False, 3, 8),
    "tile_e128_hub_signed": (1024, 3000, 4, 128, None, 900, True, None, 8),
    "tile_e8_hub_signed_cut": (512, 1500, 4, 8, None, 300, True, 3, 4),
}


def _case(tag, dtype="float32"):
    """(layout, int8 stream, tile_start, messages as f32 numpy holding the
    dtype's values)."""
    N, E, T2, tile_e, dst_hi, hub, signed, cut, D = LAYOUTS[tag]
    rng = np.random.default_rng(0)
    src = rng.integers(0, N, E + hub)
    dst = rng.integers(0, dst_hi or N, E + hub)
    dst[E:] = 5
    typ = rng.integers(0, T2, E + hub)
    mask = np.where(rng.random(E + hub) < 0.1, 0.0, 1.0)
    mask[E:] = 1.0
    lay = L.build_dst_block_layout(
        src.astype(np.int32), dst.astype(np.int32), typ.astype(np.int32),
        mask.astype(np.float32), N, tile_e=tile_e)
    oh = lay.onehot.copy()
    if signed:
        t = oh.reshape(-1, 128, tile_e)
        i, r, j = np.nonzero(t)
        pick = rng.random(i.shape[0]) < 0.2
        t[i[pick], r[pick], j[pick]] = np.array(
            [2, -3, 127, -128, -1], np.int8)[rng.integers(0, 5, pick.sum())]
        two = rng.random(i.shape[0]) < 0.1
        t[i[two], (r[two] + 1) % 128, j[two]] = -1
    ts = lay.tile_start.copy()
    if cut is not None:
        ts[cut + 1:] = ts[cut]
        assert ts[-1] < lay.block_of_tile.shape[0]
        # the tiles cut off hold entries, which must add nothing
        assert oh.reshape(-1, 128 * tile_e)[ts[-1]:].any()
    msgs = rng.standard_normal((lay.gather_idx.shape[0], D)).astype(
        np.float32)
    if dtype == "bfloat16":
        msgs = np.asarray(jnp.asarray(msgs, jnp.bfloat16).astype(jnp.float32))
    return lay, oh, ts, msgs


def _plan(tag):
    lay, oh, ts, _ = _case(tag)
    toh, tts = torch.as_tensor(oh), torch.as_tensor(ts)
    return L.loopT_plan_once("onehot_segment_scatter_loopT", toh, tts,
                             lay.n_blocks, lay.tile_e), lay, oh, ts


def _entries(plan):
    """(message rows, values) of the plan's entries as int64."""
    if plan.packed:
        e = plan.ent.long() & 0xFFFFFFFF
        return e >> 8, ((e & 0xFF) ^ 0x80) - 0x80
    return plan.ent[:, 0].long(), plan.ent[:, 1].long()


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_loopT_plan_rebuilds_the_used_tiles(tag, packed, monkeypatch):
    """#19's plan, its entries put back as bytes of (tile, dst row,
    column), equals the stream's tiles below tile_start[-1], each entry in
    the block tile_start gives its tile, byte for byte; the tiles past
    tile_start[-1] and the zero bytes give no entry; in 4-byte entries
    and (as for a pack of 2**24 rows or more) 8-byte ones.  Every output
    row has its items in order, at most AUTO_SPLIT entries each."""
    if not packed:
        monkeypatch.setattr(W, "_PACK_ROWS", 0)
    plan, lay, oh, ts = _plan(tag)
    assert plan.packed == packed
    tile_e, nb = lay.tile_e, lay.n_blocks
    rows, v = _entries(plan)
    items = plan.items.long().numpy()
    sizes = items[:, 1] - items[:, 0]
    assert (np.diff(items[:, 2]) >= 0).all() and sizes.max() <= W.AUTO_SPLIT
    assert items[0, 0] == 0 and (items[1:, 0] == items[:-1, 1]).all()
    assert np.bincount(items[:, 2], minlength=nb * 128).min() >= 1
    out_row = torch.as_tensor(np.repeat(items[:, 2], sizes))
    tile, col = rows // tile_e, rows % tile_e
    n_used = int(ts[-1])
    assert int(tile.max()) < n_used
    block = np.searchsorted(ts[1:], np.arange(n_used), side="right")
    assert (out_row // 128 == torch.as_tensor(block)[tile]).all()
    got = np.zeros((oh.shape[0] // 128, 128, tile_e), np.int64)
    np.add.at(got, (tile.numpy(), (out_row % 128).numpy(), col.numpy()), 1)
    assert got.max() == 1       # each byte at most once
    got[tile.numpy(), (out_row % 128).numpy(), col.numpy()] = v.numpy()
    want = oh.reshape(-1, 128, tile_e).astype(np.int64)
    want[n_used:] = 0
    assert (got == want).all()
    if "signed" in tag:
        assert v.min() == -128 and v.max() == 127
    if "hub" in tag:
        assert 5 in plan.split.tolist()


def _emulate(plan, msgs):
    """The kernel's schedule: each work item sums value · row over its
    entries in order by f32 fmas (the product exact, one rounding an
    entry); a row of one item is its sum, a split row the f32 sum of its
    partials in item order."""
    rows, v = _entries(plan)
    it = plan.items.long()
    first, end, orow, slot = it.unbind(1)
    x = msgs.double()
    acc = torch.zeros(it.shape[0], msgs.shape[1])
    for k in range(int((end - first).max())):
        live = torch.nonzero(first + k < end).flatten()
        q = first[live] + k
        acc[live] = (acc[live].double()
                     + v[q, None].double() * x[rows[q]]).float()
    out = torch.full((plan.item_first.shape[0] - 1, msgs.shape[1]),
                     float("nan"))
    one = slot < 0
    out[orow[one]] = acc[one]
    for r in plan.split.tolist():
        s = torch.zeros(msgs.shape[1])
        for part in acc[orow == r]:
            s = s + part
        out[r] = s
    return out


@pytest.fixture
def small_items(monkeypatch):
    """Work items of at most 32 entries, so that more rows split."""
    monkeypatch.setattr(W, "AUTO_SPLIT", 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_loopT_gather_schedule_matches_jax(tag, dtype, small_items):
    """The plan summed as the kernel sums it against the JAX kernel in
    interpret mode (the tolerances in the module docstring), and equal to
    the wrapper's plain version within the same bound; blocks without a
    real edge in a used tile exactly 0."""
    plan, lay, oh, ts = _plan(tag)
    _, _, ts, msgs = _case(tag, dtype)
    tile_e, nb = lay.tile_e, lay.n_blocks
    tm = torch.tensor(msgs).to(_TDT[dtype])
    toh, tts = torch.as_tensor(oh), torch.as_tensor(ts)
    got = _emulate(plan, tm).numpy()
    ref = np.asarray(SPJ.onehot_segment_scatter_loopT(
        jnp.asarray(msgs, _JDT[dtype]), jnp.asarray(oh), jnp.asarray(ts),
        n_blocks=nb, tile_e=tile_e, interpret=True), np.float64)
    plain = L.onehot_segment_scatter_loopT(tm, toh, tts, nb, tile_e).numpy()
    if "hub" in tag or "signed" in tag:
        assert plan.split.shape[0] > 0
        mag = L.onehot_segment_scatter_loopT_reference(
            tm.abs(), toh.to(torch.int16).abs(), tts, nb, tile_e).numpy()
        assert (np.abs(got - plain) <= 2e-6 * mag + 1e-30).all()
        assert (np.abs(got - ref) <= 4e-6 * mag + 1e-30).all()
    elif dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, plain, rtol=1e-6, atol=1e-6)
    else:
        for want in (ref, plain):
            assert (np.abs(got - want)
                    <= 2e-5 * np.maximum(1.0, np.abs(want))).all()
    n_used = int(ts[-1])
    real = (lay.dst_local.reshape(-1, tile_e)[:n_used] >= 0).any(1)
    has_edge = np.bincount(
        np.searchsorted(ts[1:], np.arange(n_used), side="right"),
        weights=real, minlength=nb) > 0
    if "empty" in tag or "cut" in tag:
        assert not has_edge.all()
    assert (got.reshape(nb, 128, -1)[~has_edge] == 0).all()


def _count_host_copies(monkeypatch):
    calls = []
    real = G.host_ints

    def counting(*a):
        calls.append(len(a))
        return real(*a)
    for mod in (G, W, L):
        monkeypatch.setattr(mod, "host_ints", counting)
    return calls


def test_loopT_plan_is_made_once_per_layout(monkeypatch):
    """#19's checks and plan run once per layout: a second call, and #18's
    on the same layout, copy nothing to the host and give the same plan;
    another layout (a copy of tile_start) is checked and planned anew."""
    lay, oh, ts, _ = _case("tile_e128_cut")
    toh, tts = torch.as_tensor(oh), torch.as_tensor(ts)
    args = (toh, tts, lay.n_blocks, lay.tile_e)
    calls = _count_host_copies(monkeypatch)
    plan = L.loopT_plan_once("onehot_segment_scatter_loopT", *args)
    assert calls
    n = len(calls)
    assert L.loopT_plan_once("onehot_segment_scatter_loopT", *args) is plan
    assert len(calls) == n
    other = L.loopT_plan_once("onehot_segment_scatter_loopT", toh,
                              tts.clone(), lay.n_blocks, lay.tile_e)
    assert other is not plan and len(calls) > n
    assert torch.equal(other.ent, plan.ent)
    n = len(calls)
    assert L.loopT_plan_once("onehot_segment_scatter_stream", *args) is plan
    assert len(calls) == n


def test_loopT_plan_checks_raise_every_call():
    """A tile_start past the stream's tiles, one that does not start at
    0 and one that runs down raise with the wrapper's message, on every
    call (a raise is not cached); the wrapper raises the same on the
    CPU."""
    lay, oh, ts, msgs = _case("tile_e128_empty")
    toh = torch.as_tensor(oh)
    n_tiles = oh.shape[0] // 128
    bad = []
    for edit in ("past", "start", "down"):
        t = torch.as_tensor(ts).clone()
        if edit == "past":
            t[-1] = n_tiles + 1
        elif edit == "start":
            t[0] = 1
        else:
            t[2] = t[3] + 1
        bad.append(t)
    for t in bad:
        for _ in range(2):
            with pytest.raises(ValueError, match="tile_start runs from"):
                L.loopT_plan_once("onehot_segment_scatter_loopT", toh, t,
                                  lay.n_blocks, lay.tile_e)
        with pytest.raises(ValueError, match="tile_start runs from"):
            L.onehot_segment_scatter_loopT(torch.tensor(msgs), toh, t,
                                           lay.n_blocks, lay.tile_e)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(LAYOUTS))
def test_loopT_gather_on_card(tag):
    """#19 (and #18 in its forms off #11's pipeline) on the gather, in
    bf16 and f32 at D = 1, 16, 128 and 200, against the plain version
    (chip_smoke's per-element bound, over |stream|), twice bit-equal,
    blocks without a real edge exactly 0; the launches counted and no
    host copy on a layout already seen."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    lay, oh, ts, _ = _case(tag)
    lay.tile_start, lay.onehot = ts, oh
    dlay = lay.to("cuda")
    a = dlay.arrays
    log = {}
    before = L.onehot_segment_scatter_loopT.launches
    cs.check_stream_scatters(tag, dlay, log, (1, 16, 128, 200),
                             onehot=a["onehot"])
    assert L.onehot_segment_scatter_loopT.launches > before
    assert log["onehot_segment_scatter_loopT"]
    m = torch.zeros(oh.shape[0] // 128 * lay.tile_e, 8, device="cuda")
    copies = []
    real = G.host_ints
    try:
        for mod in (G, W, L):
            mod.host_ints = lambda *x: copies.append(x) or real(*x)
        L.onehot_segment_scatter_loopT(m, a["onehot"], a["tile_start"],
                                       lay.n_blocks, lay.tile_e)
    finally:
        for mod in (G, W, L):
            mod.host_ints = real
    assert not copies
