"""The port's kernel-variant kernels and its widths past 256 against the JAX
package: the plain versions of #18 ``onehot_segment_scatter_stream``, #19
``onehot_segment_scatter_loopT`` and #20 ``window_block_spmm`` against the
JAX kernels in Pallas interpret mode (the layouts of the reference's
``test_kernel_variants_agree`` and ``test_window_kernel_variants_agree``,
plus tile_e 128, empty blocks, dummy tiles and a block without tiles), the
wrappers' refusals, and ``propagate`` at D = 384 on the xla, onehot, window
and pallas backends.  The same seeded numpy inputs go to both packages; on
the CPU the port's wrappers run their plain versions.  Tests marked
``cuda`` hold the CUDA kernels against the plain versions on the card and
skip here.

Tolerances:

- #18, #19, #20 with f32 inputs: rtol = atol = 1e-6, as the reference's
  tests hold its variants against each other (f32 sums in another order;
  the port's plain sums run in f64);
- with bf16 inputs: 2e-5·max(1, |ref|) per element (bf16·int8 products
  are exact in f32; only the order of the f32 sums differs);
- ``propagate`` at D = 384 in f32: rtol 3e-5, atol 3e-6, the bound of the
  reference's propagate tests (``tests/test_edge_gates.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import scatter_pallas as SPJ
from ggnn_tpu.ops import window_pallas as WPJ
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)


def _random_edges(rng, n_nodes, n_edges, n_types, dst_hi=None):
    """The reference's random_edges (``tests/test_scatter_pallas.py``),
    with dst below ``dst_hi`` (empty dst blocks above it)."""
    src = rng.integers(0, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(0, dst_hi or n_nodes, n_edges).astype(np.int32)
    typ = rng.integers(0, n_types, n_edges).astype(np.int32)
    mask = np.ones(n_edges, np.float32)
    mask[rng.random(n_edges) < 0.1] = 0.0
    return src, dst, typ, mask


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


_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

# --- #18 and #19 --------------------------------------------------------------

SCATTER_LAYOUTS = {
    # tag: (N, E, T2, tile_e, dst range, D); "variants_agree" is the
    # reference's test_kernel_variants_agree layout
    "variants_agree": (256, 500, 4, 8, None, 16),
    "tile_e128_empty": (1024, 3000, 4, 128, 512, 8),
}


def _scatter_case(tag, dtype):
    N, E, T2, tile_e, dst_hi, D = SCATTER_LAYOUTS[tag]
    rng = np.random.default_rng(0)
    lay = L.build_dst_block_layout(*_random_edges(rng, N, E, T2, dst_hi), N,
                                   tile_e=tile_e)
    msgs = rng.standard_normal((lay.gather_idx.shape[0], D)).astype(
        np.float32)
    if dtype == "bfloat16":
        msgs = np.asarray(jnp.asarray(msgs, jnp.bfloat16).astype(jnp.float32))
    return lay, msgs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tag", list(SCATTER_LAYOUTS))
@pytest.mark.parametrize("variant", ["stream", "loopT"])
def test_stream_scatter_matches_jax(variant, tag, dtype):
    """#18 / #19's plain version against the JAX kernel in interpret mode
    (and against #8's output), every block, the empty ones exactly 0."""
    lay, msgs = _scatter_case(tag, dtype)
    tile_e, n_blocks = lay.tile_e, lay.n_blocks
    jm = jnp.asarray(msgs, _JDT[dtype])
    joh, jts = jnp.asarray(lay.onehot), jnp.asarray(lay.tile_start)
    tm = torch.tensor(msgs).to(_TDT[dtype])
    toh, tts = torch.as_tensor(lay.onehot), torch.as_tensor(lay.tile_start)
    if variant == "stream":
        ref = SPJ.onehot_segment_scatter_stream(
            jm, joh, jts, n_blocks=n_blocks, max_tiles=lay.max_tiles,
            tile_e=tile_e, interpret=True)
        got = L.onehot_segment_scatter_stream(tm, toh, tts, n_blocks,
                                              lay.max_tiles, tile_e)
    else:
        ref = SPJ.onehot_segment_scatter_loopT(
            jm, joh, jts, n_blocks=n_blocks, tile_e=tile_e, interpret=True)
        got = L.onehot_segment_scatter_loopT(tm, toh, tts, n_blocks, tile_e)
    _close(got.numpy(), ref, dtype, f"{variant} {tag}")
    flat = L.onehot_segment_scatter_flat(
        tm, toh, tts, torch.as_tensor(lay.block_of_tile), n_blocks, tile_e)
    assert torch.equal(got, flat)
    real = (lay.dst_local.reshape(-1, tile_e) >= 0).any(1)
    has_edge = np.bincount(lay.block_of_tile, weights=real,
                           minlength=n_blocks) > 0
    if tag.endswith("empty"):
        assert not has_edge.all()
    assert (got.reshape(n_blocks, 128, -1)[torch.as_tensor(~has_edge)]
            == 0).all()


def test_stream_scatters_refuse_bad_arguments():
    """#18 raises where a block holds more tiles than max_tiles (the TPU
    grid would drop them); both raise on a one-hot stream whose shape
    disagrees with the messages' tiles, on messages that are not whole
    tiles, and on a tile_start past the stream."""
    lay, msgs = _scatter_case("variants_agree", "float32")
    m = torch.tensor(msgs)
    oh, ts = torch.as_tensor(lay.onehot), torch.as_tensor(lay.tile_start)
    nb, mt, te = lay.n_blocks, lay.max_tiles, lay.tile_e
    with pytest.raises(ValueError, match="more than max_tiles"):
        L.onehot_segment_scatter_stream(m, oh, ts, nb, mt - 1, te)
    for fn in (lambda o, t, mm=m: L.onehot_segment_scatter_stream(
                   mm, o, t, nb, mt, te),
               lambda o, t, mm=m: L.onehot_segment_scatter_loopT(
                   mm, o, t, nb, te)):
        with pytest.raises(ValueError, match="side stream"):
            fn(oh[:-128], ts)
        with pytest.raises(ValueError, match="side stream"):
            fn(oh.reshape(-1, 2 * te)[:, :te + 1].contiguous(), ts)
        bad = ts.clone()
        bad[-1] += 1
        with pytest.raises(ValueError, match="tile_start"):
            fn(oh, bad)
    with pytest.raises(ValueError, match="whole tiles"):
        L.onehot_segment_scatter_loopT(m[:-1], oh, ts, nb, te)


# --- #20 ------------------------------------------------------------------------

WINDOW_LAYOUTS = {
    # tag: (N, E, T2, W, min_edges_per_tile, extra dummy tiles, D);
    # "variants_agree" is the reference's test_window_kernel_variants_agree
    "variants_agree": (512, 900, 4, 64, 1, 0, 16),
    "W256_dummies": (1024, 12_000, 4, 256, 4, 40, 8),
}


def _window_case(tag, dtype, drop_block=None):
    N, E, T2, Wn, mept, pad, D = WINDOW_LAYOUTS[tag]
    rng = np.random.default_rng(0)
    src, dst, typ, mask = _random_edges(rng, N, E, T2)
    if pad:  # clustered, so that windows fill, plus dummy tiles
        src = (np.where(rng.random(E) < 0.9,
                        (dst // 128) * 128 + rng.integers(0, 128, E), src)
               % N).astype(np.int32)
    lay = W.build_window_layout(src, dst, typ, mask, N, window=Wn,
                                min_edges_per_tile=mept)
    if pad:
        lay = W.build_window_layout(src, dst, typ, mask, N, window=Wn,
                                    min_edges_per_tile=mept,
                                    pad_tiles_to=lay.n_tiles + pad)
    a = dict(lay.arrays)
    if drop_block is not None:  # no tile at all for this block
        ts = a["tile_start"]
        t0, t1 = ts[drop_block], ts[drop_block + 1]
        keep = np.ones(a["win_of_tile"].shape[0], bool)
        keep[t0:t1] = False
        a["tile_start"] = np.concatenate(
            [ts[:drop_block + 1], ts[drop_block + 1:] - (t1 - t0)]).astype(
                np.int32)
        for k in ("block_of_tile", "win_of_tile", "c_off"):
            a[k] = a[k][keep]
    R = T2 * N
    table = rng.standard_normal((R + (-R) % Wn, D)).astype(np.float32)
    if dtype == "bfloat16":
        table = np.asarray(jnp.asarray(table, jnp.bfloat16).astype(
            jnp.float32))
    return lay, a, table


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["variants_agree", "W256_dummies",
                                  "W256_block_without_tiles"])
def test_window_block_spmm_matches_jax(case, dtype):
    """#20's plain version against the JAX kernel in interpret mode on the
    blocks that have a tile (the TPU kernel never writes the others), and
    exactly 0 on the others; and equal to #11's output."""
    tag = "W256_dummies" if case.startswith("W256") else case
    lay, a, table = _window_case(
        tag, dtype, drop_block=3 if case.endswith("tiles") else None)
    Wn, nb = lay.window, lay.n_blocks
    names = ("c_stream", "tile_start", "block_of_tile", "win_of_tile")
    ref = np.asarray(WPJ.window_block_spmm(
        jnp.asarray(table, _JDT[dtype]), *(jnp.asarray(a[k]) for k in names),
        n_blocks=nb, window=Wn, c_off=jnp.asarray(a["c_off"]),
        interpret=True))
    tt = torch.tensor(table).to(_TDT[dtype])
    args = [torch.as_tensor(a[k]) for k in names]
    got = W.window_block_spmm(tt, *args, nb, Wn,
                              c_off=torch.as_tensor(a["c_off"]))
    has_tile = np.diff(a["tile_start"]) > 0
    if case == "W256_dummies":
        assert (a["win_of_tile"] < 0).any() and (
            a["c_off"] != np.arange(a["c_off"].shape[0])).any()
    if case.endswith("tiles"):
        assert not has_tile.all()
    g = got.numpy().reshape(nb, 128, -1)
    _close(g[has_tile], ref.reshape(nb, 128, -1)[has_tile], dtype, case)
    assert (g[~has_tile] == 0).all()
    mono = W.window_block_spmm_mono(tt, *args, nb, Wn,
                                    c_off=torch.as_tensor(a["c_off"]))
    assert torch.equal(got, mono)


def test_window_block_spmm_refuses_bad_arguments():
    """#20 raises on a table whose rows are not a multiple of W (as the
    reference), on a count stream of another window or of rows not whole
    128-row tiles, on tiles past the stream, and on block_of_tile that
    disagrees with tile_start."""
    lay, a, table = _window_case("variants_agree", "float32")
    t = {k: torch.as_tensor(v) for k, v in a.items()}
    tt = torch.tensor(table)
    nb, Wn = lay.n_blocks, lay.window

    def run(table=tt, cs=t["c_stream"], bt=t["block_of_tile"],
            c_off=t["c_off"]):
        return W.window_block_spmm(table, cs, t["tile_start"], bt,
                                   t["win_of_tile"], nb, Wn, c_off=c_off)

    run()
    with pytest.raises(ValueError, match="multiple of window"):
        run(table=torch.cat([tt, tt[:1]]))
    with pytest.raises(ValueError, match="side stream"):
        run(cs=t["c_stream"][:, :Wn // 2].contiguous())
    with pytest.raises(ValueError, match="not a multiple"):
        run(cs=t["c_stream"][:-1])
    with pytest.raises(ValueError, match="side-stream entries"):
        run(c_off=t["c_off"] + 1000)
    bt = t["block_of_tile"].clone()
    bt[0] += 1
    with pytest.raises(ValueError, match="block_of_tile names another"):
        run(bt=bt)


# --- propagate at D = 384 --------------------------------------------------------

def _community(seed, N, E, T2, csize=64):
    r = np.random.default_rng(seed)
    dst = r.integers(0, N, E)
    src = np.where(r.random(E) < 0.9,
                   (dst // csize) * csize + r.integers(0, csize, E),
                   r.integers(0, N, E)) % N
    return (src.astype(np.int32), dst.astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.95).astype(np.float32))


@pytest.mark.parametrize("backend", ["xla", "onehot", "window", "pallas"])
def test_propagate_d384_matches_jax(backend):
    """Per-step states of propagate at D = 384 (wider than the 256 the
    port's kernels took before; f32) against the JAX package's on the xla,
    onehot (its default legacy layout), window (one community layout) and
    pallas (type tiles from type_offsets) backends."""
    N, E, T, D = 256, 1500, 2, 384
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=T, n_steps=2,
              backend=backend, compute_dtype="float32", fuse_gru=False)
    params = jax.tree.map(np.asarray,
                          jax_init(jax.random.PRNGKey(3), JaxConfig(**kw)))
    src, dst, typ, mask = _community(5, N, E, 2 * T)
    order = np.argsort(typ, kind="stable")
    src, dst, typ, mask = src[order], dst[order], typ[order], mask[order]
    edges = (src, dst, typ, mask)
    ann = (np.random.default_rng(6).random((N, 4)) < 0.4).astype(np.float32)
    jkw, tkw = {}, {}
    if backend == "window":
        lay = W.build_window_layout(*edges, N, window=256, block_rows=256,
                                    min_edges_per_tile=4,
                                    n_message_types=2 * T,
                                    row_major="block")
        jkw["scatter_layout"] = WPJ.DeviceWindowLayout(
            meta=lay.meta,
            arrays={k: jnp.asarray(v) for k, v in lay.arrays.items()})
        tkw["scatter_layout"] = lay
    if backend == "pallas":
        offs = np.concatenate([[0], np.cumsum(np.bincount(
            typ, minlength=2 * T))]).astype(np.int32)
        jkw["type_offsets"] = jnp.asarray(offs)
        tkw["type_offsets"] = torch.as_tensor(offs)
    _, ref = jax_propagate(params["prop"], JaxConfig(**kw), jnp.asarray(ann),
                           *map(jnp.asarray, edges), collect_states=True,
                           **jkw)
    with torch.no_grad():
        _, got = propagate(params_from_numpy(params["prop"]),
                           ModelConfig(**kw), torch.tensor(ann),
                           *map(torch.tensor, edges), collect_states=True,
                           **tkw)
    for t in range(2):
        np.testing.assert_allclose(got[t].numpy(), np.asarray(ref[t]),
                                   rtol=3e-5, atol=3e-6,
                                   err_msg=f"{backend} step {t}")


# --- on the card ----------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["stream", "loopT"])
def test_stream_scatter_kernels_on_card(variant):
    """#18 / #19 on the card against their plain version at D = 16 (f32 and
    bf16) and D = 384 (bf16), per element within 2e-5 of the sums over
    |messages|, and bit-equal run to run."""
    dev = _cuda()
    lay, _ = _scatter_case("tile_e128_empty", "float32")
    oh = torch.as_tensor(lay.onehot, device=dev)
    ts = torch.as_tensor(lay.tile_start, device=dev)
    fn = (lambda m: L.onehot_segment_scatter_stream(
        m, oh, ts, lay.n_blocks, lay.max_tiles, lay.tile_e)) \
        if variant == "stream" else \
        (lambda m: L.onehot_segment_scatter_loopT(m, oh, ts, lay.n_blocks,
                                                  lay.tile_e))
    plain = lambda m: L.onehot_segment_scatter_stream_reference(
        m, oh, ts, lay.n_blocks, lay.max_tiles, lay.tile_e)
    gen = torch.Generator(device=dev).manual_seed(1)
    for D, dt in ((16, torch.float32), (16, torch.bfloat16),
                  (384, torch.bfloat16)):
        m = torch.randn(lay.gather_idx.shape[0], D, device=dev,
                        generator=gen).to(dt)
        got = fn(m)
        assert torch.equal(got, fn(m))
        assert ((got - plain(m)).abs() <= 2e-5 * plain(m.abs())).all()


@pytest.mark.cuda
def test_window_block_spmm_kernel_on_card():
    """#20 on the card against its plain version on a layout with dummy
    tiles, a compact stream and a block without tiles, at D = 8 (f32,
    bf16) and 384 (bf16); bit-equal run to run."""
    dev = _cuda()
    lay, a, _ = _window_case("W256_dummies", "float32", drop_block=3)
    names = ("c_stream", "tile_start", "block_of_tile", "win_of_tile")
    args = [torch.as_tensor(a[k], device=dev) for k in names]
    c_off = torch.as_tensor(a["c_off"], device=dev)
    kw = dict(n_blocks=lay.n_blocks, window=lay.window, c_off=c_off)
    gen = torch.Generator(device=dev).manual_seed(2)
    for D, dt in ((8, torch.float32), (8, torch.bfloat16),
                  (384, torch.bfloat16)):
        t = torch.randn(4 * 1024, D, device=dev, generator=gen).to(dt)
        got = W.window_block_spmm(t, *args, **kw)
        assert torch.equal(got, W.window_block_spmm(t, *args, **kw))
        ref = W.window_block_spmm_reference(t, *args, **kw)
        mag = W.window_block_spmm_reference(t.abs(), *args, **kw)
        assert ((got - ref).abs() <= 2e-5 * mag).all()


@pytest.mark.cuda
def test_one_kernel_per_family_takes_d384_on_card():
    """One kernel of each family at D = 384 on the card against its plain
    version: the GRU cell (#3, wide panels), the typed scatter (#7, P²
    panel launches), the legacy scatter (#8, the panel kernel), the table
    (#10), the window backward (#14, the runtime panel count) and the
    packed messages (#16)."""
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import table as TB
    dev = _cuda()
    D, bf = 384, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s, sc=1.0: torch.randn(*s, device=dev, generator=gen) * sc
    # #3
    h, av = torch.rand(256, D, device=dev, generator=gen) * 2 - 1, rn(256, D)
    wa, uzr, uh = (rn(D, k * D, sc=D ** -0.5).to(bf) for k in (3, 2, 1))
    b3 = rn(3 * D, sc=0.1)
    got = G.gru_cell_fwd(h, av, wa, b3, uzr, uh)[0]
    ref = G.gru_cell_fwd_reference(h, av, wa, b3, uzr, uh)[0]
    assert (got - ref).abs().max().item() <= 2.0 ** -7
    # #7
    rng = np.random.default_rng(4)
    edges = _random_edges(rng, 512, 4000, 4)
    lay_t = S.build_typed_dst_layout(*edges, 512, 4, block_mode=False).to(dev)
    kt = S.tile_args(lay_t)
    hp = rn(lay_t.arrays["gather_idx"].shape[0], D).to(bf)
    w = rn(4, D, D, sc=D ** -0.5).to(bf)
    got = S.typed_onehot_scatter(hp, msg_w=w, **kt)
    ref = S.typed_onehot_scatter_reference(hp, msg_w=w, **kt)
    mag = S.typed_onehot_scatter_reference(hp.abs(), msg_w=w.abs(), **kt)
    assert ((got - ref).abs() <= 2e-5 * mag + 2.0 ** -7 * mag).all()
    # #8 and #10
    lay_l = L.build_dst_block_layout(*edges, 512, tile_e=128,
                                     n_message_types=4,
                                     row_order="block").to(dev)
    hn = (torch.rand(512, D, device=dev, generator=gen) * 2 - 1).to(bf)
    tab = TB.node_table_block_major(hn, w, rn(4, D, sc=0.1).to(bf))
    msgs = tab.index_select(0, lay_l.arrays["gather_idx"])
    args = (lay_l.arrays["onehot"], lay_l.arrays["tile_start"],
            lay_l.arrays["block_of_tile"], lay_l.meta[3], 128)
    got = L.onehot_segment_scatter_flat(msgs, *args)
    ref = L.onehot_segment_scatter_flat_reference(msgs, *args)
    mag = L.onehot_segment_scatter_flat_reference(msgs.abs(), *args)
    assert ((got - ref).abs() <= 2e-5 * mag).all()
    # #14 exact
    r = np.random.default_rng(5)
    N, E, T2 = 1024, 20_000, 4
    dst = r.integers(0, N, E)
    src = ((dst // 256) * 256 + r.integers(0, 256, E)) % N
    lw = W.build_window_layout(src, dst, r.integers(0, T2, E),
                               np.ones(E, np.float32), N, window=256,
                               block_rows=256, n_message_types=T2,
                               row_major="block", min_edges_per_tile=4,
                               with_grad=True, on_demand=True,
                               typed_spill=True).to(dev)
    assert lw.grad_meta[4]
    aw = lw.arrays
    da_t = rn(D, lw.n_blocks * 256).to(bf)
    hw = (torch.rand(N, D, device=dev, generator=gen) * 2 - 1).to(bf)
    ww = rn(T2, D, D, sc=D ** -0.5).to(bf)
    gt = (aw["c_stream"], aw["gt_tile_start"], aw["gt_block_of_tile"],
          aw["gt_win_of_tile"], aw["gt_c_off"])
    kw = dict(n_wins=lw.grad_meta[0], window=256, out_rows=256, t2=T2)
    got = W.window_bwd_fused(da_t, *gt, ww, hw, **kw)
    ref = W.window_bwd_fused_reference(da_t, *gt, ww, hw, **kw)
    mag = W.window_bwd_fused_reference(da_t.abs(), *gt, ww.abs(), hw.abs(),
                                       **kw)
    for x, y, m in zip(got, ref, mag):
        assert ((x - y).abs() <= (2e-5 + 2.0 ** -7) * m).all()
    # #16
    cols = [torch.as_tensor(c, device=dev) for c in (
        np.sort(r.integers(0, 512, 3000)).astype(np.int32),)]
    src_p = torch.as_tensor(r.integers(0, 512, 3000).astype(np.int32),
                            device=dev)
    typ_p = torch.as_tensor(np.sort(r.integers(0, 4, 3000)).astype(np.int32),
                            device=dev)
    offs = torch.as_tensor(np.concatenate([[0], np.cumsum(np.bincount(
        typ_p.cpu().numpy(), minlength=4))]).astype(np.int32), device=dev)
    pl = SP.pack_type_tiles(src_p, cols[0], typ_p,
                            torch.ones(3000, device=dev), offs, 4, 128)
    pargs = (pl["src"], pl["mask"], pl["tile_type"])
    bb = rn(4, D, sc=0.1).to(bf)
    got = SP.packed_messages(hn, *pargs, w, bb, 128)
    ref = SP.packed_messages_reference(hn, *pargs, w, bb, 128)
    mag = SP.packed_messages_reference(hn.abs(), *pargs, w.abs(), bb.abs(),
                                       128)
    assert ((got - ref).abs() <= 2e-5 * mag).all()
