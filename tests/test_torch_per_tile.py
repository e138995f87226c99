"""The port's per-tile typed kernels (``typed_onehot_scatter``,
``typed_step_gru``), its windowed count-matrix SpMM
(``window_block_spmm_mono``), its legacy layout builder
(``build_dst_block_layout``), and the slice they carry, serving and training
on graphs where block mode and the octet grad layout decline, against the
JAX package.  The same seeded numpy inputs go to both; the JAX kernels run in
Pallas interpret mode, the port's wrappers their plain versions (CPU
tensors).  Tolerances:

- layouts: exact, array for array and dtype for dtype;
- per-tile scatter: f32 rtol = atol = 1e-5 (the same sums in another
  order); bf16 inputs rtol = 1e-5, atol = 1e-4 (each tile's one-hot sum is
  rounded to bf16 at the same point in both, so only the f32 order of the
  W_t products differs), the tolerances of the per-block kernels' tests;
- fused step: one bf16 ulp at 1.0, atol = 2**-7, for an aggregation that
  rounds to the other bf16 neighbour before the gate matmuls (f32: 1e-5);
- window SpMM: f32 rtol = atol = 1e-5; flushed to bf16 rtol = 2**-7, one
  bf16 ulp of the value (the reverse scatter's tolerance);
- propagate: f32 rtol = atol = 2e-5, bf16 atol = 2**-7 (the serving
  tests' tolerances) on every row with at most 16 in-edges.  A hub row
  aggregates hundreds of messages, |a| ≫ 1: in f32 its sum's rounding
  grows with |a|, and it is held to 1e-4, the serving tests' bound against
  the f64 oracle; in bf16 the rounding of a before the gate matmuls has an
  ulp far above 2**-7, and a last-bit f32 difference in the sum that
  rounds a the other way moves a gate by ulp(a)·|W|, so every row is held
  to the criterion chip_smoke.py holds served scores to, max ≤ 8 bf16
  ulps at 1.0 and mean ≤ 1e-3 (rare flips, not a wrong sum);
- gradients: relative Frobenius error per leaf 1e-5 (f32) and 2**-8
  (bf16), the training tests' tolerances.  The loss Σ h_T ⊙ w is a sum of
  N·D terms of both signs that cancels to about 1e-3 of their absolute
  sum, so its error is held to 1e-5 of that absolute sum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.data.synthetic import synthetic_batch
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import scatter as S
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.train.loop import param_leaves

torch.set_num_threads(1)

D = 128
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-4)}


def _graph(seed, N, E, T2, dst_hi=None, hub=False):
    r = np.random.default_rng(seed)
    src = r.integers(0, N, E).astype(np.int32)
    if hub:
        dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                       r.integers(0, N, E)).astype(np.int32)
    else:
        dst = r.integers(0, dst_hi or N, E).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = (r.random(E) < 0.9).astype(np.float32)
    return src, dst, typ, mask


def _powerlaw(N=1024, E=4000, T=2):
    """A Zipf-1.2 graph (both directions, nodes numbered by degree rank)."""
    b = synthetic_batch(N, E, T, annotation_dim=4, seed=0, node_mult=128,
                        powerlaw_alpha=1.2)
    return (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask), b.spec.n_pad


TILE_CASES = {
    # name: (graph kwargs or "powerlaw", N, T2, layout kwargs)
    "hub": (dict(seed=11, E=6000, hub=True), 1024, 4, {"tile_e": 128}),
    "powerlaw": ("powerlaw", 1024, 4, {}),
    "block_mode_false": (dict(seed=1, E=5000), 640, 5,
                         {"block_mode": False}),
    "span": (dict(seed=6, E=9000), 640, 5, {"span_mode": True,
                                           "block_mode": False}),
    "chunked": (dict(seed=5, E=9000), 640, 5, {"smem_tile_cap": 5,
                                              "block_mode": False}),
    "empty_blocks": (dict(seed=3, E=3000, dst_hi=512), 1024, 4,
                     {"block_mode": False}),
}


def _tile_layouts(case, with_grad=False):
    g, N, T2, kw = TILE_CASES[case]
    if g == "powerlaw":
        edges, N = _powerlaw()
    else:
        edges = _graph(g["seed"], N, g["E"], T2,
                       **{k: v for k, v in g.items() if k not in ("seed",
                                                                  "E")})
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, with_grad=with_grad,
                                      **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, with_grad=with_grad,
                                     **kw)
    assert lay_t.block_meta is None and lay_t.meta == lay_j.meta
    if case == "span":
        assert lay_t.meta[9] is not None
    if case == "chunked":
        assert lay_t.meta[8] is not None
    if case == "empty_blocks":
        assert (lay_t.arrays["tile_msg_off"] < 0).any()
    return lay_j, lay_t.to("cpu"), N, T2


def _inputs(seed, N, T2, n_rows):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(
        np.float32)
    return dict(h=f(N, D), w=f(T2, D, D, scale=0.2), init=f(n_rows, D,
                                                           scale=0.1),
                hstate=(r.random((n_rows, D)) - 0.5).astype(np.float32),
                wa=f(D, 3 * D, scale=0.08), uzr=f(D, 2 * D, scale=0.08),
                uh=f(D, D, scale=0.08), b3=f(1, 3 * D, scale=0.1))


def _jax_tile_args(lay_j, h, jdt):
    a = lay_j.arrays
    span = lay_j.meta[9]
    return ((jnp.asarray(h, jdt)[a["gather_idx"]], a["dstl"], a["tile_start"],
             a["block_of_tile"], a["tile_msg_off"], a["c_off"],
             a["tile_type"]),
            dict(n_blocks=lay_j.meta[3], tile_e=lay_j.meta[1],
                 align=lay_j.meta[6], span_rows=span,
                 blk_off16=a["blk_off16"] if span is not None else None,
                 interpret=True))


def _torch_tile_args(lay_t, h, tdt):
    kw = S.tile_args(lay_t)
    h_pack = torch.tensor(h).to(tdt).index_select(0,
                                                  lay_t.arrays["gather_idx"])
    return h_pack, kw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(TILE_CASES))
def test_typed_onehot_scatter_matches_jax(case, dtype):
    """The whole layout in one call on both sides (the JAX kernel has no
    chunk limit in interpret mode); blocks with only a dummy tile are 0."""
    jdt, tdt, atol = DTYPES[dtype]
    lay_j, lay_t, N, T2 = _tile_layouts(case)
    x = _inputs(0, N, T2, lay_t.n_blocks * 128)
    jargs, jkw = _jax_tile_args(lay_j, x["h"], jdt)
    ref = SP.typed_onehot_scatter(*jargs[:7], jnp.asarray(x["w"], jdt),
                                  **jkw)
    h_pack, kw = _torch_tile_args(lay_t, x["h"], tdt)
    got = S.typed_onehot_scatter(h_pack, msg_w=torch.tensor(x["w"]).to(tdt),
                                 **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=atol)
    dummy = kw["block_of_tile"][kw["tile_msg_off"] < 0].long()
    if case == "empty_blocks":
        assert dummy.numel() and (got.reshape(-1, 128, D)[dummy] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["hub", "chunked", "empty_blocks"])
def test_typed_step_gru_matches_jax(case, dtype):
    """The fused per-tile step; a block with only a dummy tile gets the GRU
    of its init row and state."""
    jdt, tdt, _ = DTYPES[dtype]
    lay_j, lay_t, N, T2 = _tile_layouts(case)
    x = _inputs(1, N, T2, lay_t.n_blocks * 128)
    jargs, jkw = _jax_tile_args(lay_j, x["h"], jdt)
    j = lambda k, dt=jdt: jnp.asarray(x[k], dt)
    ref = SP.typed_step_gru(
        *jargs, j("w"), j("init", jnp.float32), j("hstate", jnp.float32),
        j("wa"), j("b3", jnp.float32), j("uzr"), j("uh"), **jkw)
    h_pack, kw = _torch_tile_args(lay_t, x["h"], tdt)
    t = lambda k, dt=tdt: torch.tensor(x[k]).to(dt)
    got = S.typed_step_gru(h_pack, msg_w=t("w"), init=t("init", torch.float32),
                           hstate=t("hstate", torch.float32), wa=t("wa"),
                           b3=t("b3", torch.float32), uzr=t("uzr"),
                           uh=t("uh"), **kw)
    tol = BF16_ULP if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=tol)


def test_per_tile_padding_adds_exactly_zero():
    """Rows of h_pack that no tile reads (−1 dstl entries, group overlap,
    the pack's margin) and dummy tiles add exactly 0: poisoning them leaves
    the output bit-identical."""
    _, lay, N, T2 = _tile_layouts("empty_blocks")
    x = _inputs(2, N, T2, lay.n_blocks * 128)
    h_pack, kw = _torch_tile_args(lay, x["h"], torch.float32)
    w = torch.tensor(x["w"])
    out = S.typed_onehot_scatter(h_pack, msg_w=w, **kw)
    used = torch.zeros(h_pack.shape[0], dtype=torch.bool)
    for t in range(kw["tile_msg_off"].shape[0]):
        off = int(kw["tile_msg_off"][t])
        if off >= 0:
            row = kw["dstl"][int(kw["c_off"][t])]
            used[off * kw["align"] + torch.nonzero(row >= 0).flatten()] = True
    poisoned = h_pack.clone()
    poisoned[~used] = 1e30
    np.testing.assert_array_equal(
        S.typed_onehot_scatter(poisoned, msg_w=w, **kw).numpy(), out.numpy())


def test_per_tile_mismatched_args_raise():
    """Another layout's arrays, a pack shorter than the last tile, a weight
    bank with fewer types than the tiles name, or the wrong index dtype are
    refused before any kernel could read out of bounds."""
    _, lay_a, N, T2 = _tile_layouts("hub")
    _, lay_b, _, _ = _tile_layouts("block_mode_false")
    x = _inputs(3, N, T2, lay_a.n_blocks * 128)
    h_pack, kw = _torch_tile_args(lay_a, x["h"], torch.float32)
    w = torch.tensor(x["w"])
    _, kw_b = _torch_tile_args(lay_b, x["h"][:640], torch.float32)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_onehot_scatter(h_pack, msg_w=w, **{**kw, "c_off":
                                                   kw_b["c_off"]})
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_onehot_scatter(h_pack, msg_w=w, **{**kw, "n_blocks": 3})
    with pytest.raises(ValueError, match="not gathered with this layout"):
        S.typed_onehot_scatter(h_pack[:300], msg_w=w, **kw)
    with pytest.raises(ValueError, match="does not belong"):
        S.typed_onehot_scatter(h_pack, msg_w=w[:2], **kw)
    with pytest.raises(ValueError, match="int32"):
        S.typed_onehot_scatter(h_pack, msg_w=w,
                               **{**kw, "dstl": kw["dstl"].long()})


# --- window_block_spmm_mono -------------------------------------------------

def _mono_inputs(mode):
    """(table rows, stream, tile_start, block_of_tile, win_of_tile, kwargs)
    as numpy, from the legacy layout builder or a window layout."""
    src, dst, typ, mask = _graph(21, 768, 5000, 3)
    if mode == "window_counts":
        # a community graph's window layout: counts > 1, dummy tiles,
        # an explicit c_off over real tiles only
        N = 512
        lay = WP.build_window_layout(src % 64, dst % 256, typ, mask, N,
                                     window=128, min_edges_per_tile=1)
        a = {k: np.asarray(v) for k, v in lay.arrays.items()}
        assert (a["win_of_tile"] < 0).any() and (a["c_stream"] > 1).any()
        return (3 * N + (-3 * N) % 128, a["c_stream"], a["tile_start"],
                a["block_of_tile"], a["win_of_tile"],
                dict(n_blocks=lay.n_blocks, window=128, c_off=a["c_off"],
                     dstl=False))
    aligned = mode != "counts_dense"
    lay = SP.build_dst_block_layout(
        src, dst, typ, mask, 768, tile_e=128, n_message_types=3,
        edge_align=16 if aligned else None, dstl_stream=mode.startswith(
            "dstl"))
    stream = lay.dstl if mode.startswith("dstl") else lay.onehot
    n_tiles = lay.block_of_tile.shape[0]
    kw = dict(n_blocks=lay.n_blocks, window=128,
              win_stride=16 if aligned else None, dstl=mode.startswith("dstl"))
    win = lay.tile_msg_off if aligned else np.arange(n_tiles, dtype=np.int32)
    if mode == "dstl_c_off":
        # the stream's rows permuted, addressed through c_off
        perm = np.random.default_rng(5).permutation(stream.shape[0])
        inv = np.argsort(perm).astype(np.int32)
        stream = stream[perm]
        kw["c_off"] = inv[:n_tiles]
    return (int(lay.gather_idx.shape[0]), stream, lay.tile_start,
            lay.block_of_tile, win, kw)


MONO_MODES = ["dstl", "dstl_c_off", "counts", "counts_dense",
              "window_counts"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", MONO_MODES)
def test_window_block_spmm_mono_matches_jax(mode, dtype):
    """Table and output in the same dtype, as the reverse scatter runs it;
    each mode's stream from the builders that make it."""
    jdt, tdt, _ = DTYPES[dtype]
    R, stream, ts, bot, win, kw = _mono_inputs(mode)
    table = np.random.default_rng(7).standard_normal((R, D)).astype(
        np.float32)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = WP.window_block_spmm_mono(
        jnp.asarray(table, jdt), jnp.asarray(stream), jnp.asarray(ts),
        jnp.asarray(bot), jnp.asarray(win), out_dtype=jdt, interpret=True,
        **jkw)
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = W.window_block_spmm_mono(
        torch.tensor(table).to(tdt), torch.tensor(stream), torch.tensor(ts),
        torch.tensor(bot), torch.tensor(win), out_dtype=tdt, **tkw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    rtol = 1e-5 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=1e-5)


def test_window_block_spmm_mono_refuses_unported_modes():
    """A packed request on an unpacked stream (the packed stream is
    [rows, window/2]), an empty output height, a window past the table and
    a c_off past the stream are refused (the packed stream, 256/512-row
    blocks and the backward's W-row output blocks of any height are tested
    in tests/test_torch_window.py and tests/test_torch_window_train.py)."""
    R, stream, ts, bot, win, kw = _mono_inputs("counts")
    args = (torch.zeros(R, D), torch.tensor(stream), torch.tensor(ts),
            torch.tensor(bot), torch.tensor(win))
    with pytest.raises(ValueError, match="window/2"):
        W.window_block_spmm_mono(*args, **kw, packed=True)
    with pytest.raises(ValueError, match="out_rows=0"):
        W.window_block_spmm_mono(*args, **kw, out_rows=0)
    with pytest.raises(ValueError, match="not gathered with this layout"):
        W.window_block_spmm_mono(torch.zeros(R // 2, D), *args[1:], **kw)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        W.window_block_spmm_mono(*args, **kw, c_off=torch.full(
            (win.shape[0],), 10 ** 6, dtype=torch.int32))


# --- build_dst_block_layout -------------------------------------------------

LEGACY_OPTIONS = {
    "default": {},
    "with_grad": dict(with_grad=True),
    "pad_tiles_to": dict(pad_tiles_to="budget", with_grad=True,
                         grad_tile_e=128, grad_pad_tiles_to="grad_budget"),
    "edge_align": dict(edge_align=16, with_grad=True),
    "dstl_stream": dict(edge_align=16, dstl_stream=True, with_grad=True),
    "row_order_block": dict(row_order="block", n_message_types=4,
                            with_grad=True),
    "n_src_rows": dict(n_src_rows=1024, with_grad=True),
    "no_stream": dict(onehot_stream=False, with_grad=True),
}


def _assert_dst_layouts_equal(got, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name == "grad":
            assert (a is None) == (b is None)
            if b is not None:
                _assert_dst_layouts_equal(a, b)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("opts", sorted(LEGACY_OPTIONS))
def test_build_dst_block_layout_matches_reference(opts):
    """Every field of the layout and of its grad half, array for array."""
    kw = dict(LEGACY_OPTIONS[opts])
    N, T2 = 640, 4
    src, dst, typ, mask = _graph(9, N, 3000, T2)
    if kw.get("pad_tiles_to") == "budget":
        kw["pad_tiles_to"] = L.static_tile_budget(3000, N, 128)
        kw["grad_pad_tiles_to"] = L.static_tile_budget(3000, T2 * N, 128)
        assert kw["pad_tiles_to"] == SP.static_tile_budget(3000, N, 128)
        assert kw["grad_pad_tiles_to"] == SP.static_tile_budget(
            3000, T2 * N, 128)
    if "n_src_rows" in kw:
        src = src + 300                   # sources in their own row space
    ref = SP.build_dst_block_layout(src, dst, typ, mask, N, **kw)
    got = L.build_dst_block_layout(src, dst, typ, mask, N, **kw)
    _assert_dst_layouts_equal(got, ref)


# --- the slice: serving and training where block mode declines -------------

SLICE_CASES = {
    # name: (graph, layout kwargs) -- every case declines block mode and
    # the octet grad layout (the legacy grad layout and kernel 11 run)
    "powerlaw": ("powerlaw", {"tile_e": 128, "grad_tile_e": 128}),
    "block_mode_false": (dict(seed=2, E=3000), {"block_mode": False}),
    "chunked": (dict(seed=4, E=3000), {"block_mode": False,
                                      "smem_tile_cap": 8}),
}


def _slice(case, T=2):
    g, kw = SLICE_CASES[case]
    if g == "powerlaw":
        edges, N = _powerlaw(E=3000, T=T)
    else:
        N = 512
        edges = _graph(g["seed"], N, g["E"], 2 * T)
    lay_j = SP.build_typed_dst_layout(*edges, N, 2 * T, with_grad=True, **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, 2 * T, with_grad=True, **kw)
    assert lay_t.meta == lay_j.meta
    assert lay_t.block_meta is None and lay_t.meta[5][0] != "octet"
    if case == "chunked":
        assert lay_t.meta[8] is not None and lay_t.meta[5][5] is not None
    return edges, N, lay_j, lay_t.to("cpu")


def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                             JaxConfig(**cfg_kw)))


SERVE_MODES = {
    # name: (fuse_gru, compute dtype)
    "fused_bf16": (True, "bfloat16"),
    "fused_f32": (True, "float32"),
    "unfused_bf16": (False, "bfloat16"),
    "unfused_f32": (False, "float32"),
}


@pytest.mark.parametrize("mode", sorted(SERVE_MODES))
@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_per_tile_propagate_matches_jax(case, mode):
    """Serving: the per-step states of propagate (onehot, per-tile kernels)
    against the JAX package's, whose chunked layouts run chunked calls."""
    fuse, cdt = SERVE_MODES[mode]
    edges, N, lay_j, lay_t = _slice(case)
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=2, n_steps=2,
              backend="onehot", fuse_gru=fuse, compute_dtype=cdt)
    params = _np_params(kw)
    ann = (np.random.default_rng(1).random((N, 4)) < 0.4).astype(np.float32)
    _, ref = jax_propagate(params["prop"], JaxConfig(**kw), jnp.asarray(ann),
                           *map(jnp.asarray, edges), collect_states=True,
                           scatter_layout=lay_j)
    with torch.inference_mode():
        _, got = propagate(params_from_numpy(params["prop"]),
                           ModelConfig(**kw), torch.tensor(ann),
                           *map(torch.tensor, edges), collect_states=True,
                           scatter_layout=lay_t)
    ref = np.asarray(ref)
    low = np.bincount(edges[1][edges[3] > 0], minlength=N) <= 16
    np.testing.assert_allclose(got.numpy()[:, low], ref[:, low], rtol=2e-5,
                               atol=BF16_ULP if cdt == "bfloat16" else 2e-5)
    d = np.abs(got.numpy() - ref)
    if cdt == "float32":
        assert d.max() <= 1e-4, d.max()
    else:
        assert d.max() <= 8 * BF16_ULP and d.mean() <= 1e-3, (d.max(),
                                                               d.mean())


TRAIN_MODES = {
    # name: (fuse_gru, compute dtype, extra config)
    "fused_bf16": (True, "bfloat16", {}),
    "fused_lean_bf16": (True, "bfloat16", {"lean_residuals": True}),
    "unfused_bf16": (False, "bfloat16", {}),
    "fused_f32": (True, "float32", {}),
    "fused_lean_f32": (True, "float32", {"lean_residuals": True}),
}
RELF = {"float32": 1e-5, "bfloat16": 2.0 ** -8}
# On the power-law graph, lean residuals run in f32: recomputing the gates
# from the bf16 (h, a) of a hub row (|a| in the hundreds) moves its gate
# gradients by a bf16 ulp of a, which the 2**-8 leaf bound does not cover
# (gru/wh at 5.4e-3 here); lean bf16 runs on the hub-free layout.
TRAIN_CASES = [("powerlaw", m) for m in ("fused_bf16", "unfused_bf16",
                                         "fused_f32", "fused_lean_f32")] + \
    [("block_mode_false", m) for m in ("fused_bf16", "fused_lean_bf16",
                                       "unfused_bf16", "fused_f32")]


@pytest.mark.parametrize("case,mode", TRAIN_CASES)
def test_per_tile_train_grads_match_jax(case, mode):
    """One training step's gradients, d(Σ h_T ⊙ w)/d(prop params) and
    d/dh_0 through the annotations, against jax.grad of the JAX package:
    the forward through the per-tile kernel, the backward's reverse scatter
    through window_block_spmm_mono on the legacy grad layout."""
    fuse, cdt, extra = TRAIN_MODES[mode]
    edges, N, lay_j, lay_t = _slice(case)
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=2, n_steps=2,
              backend="onehot", fuse_gru=fuse, compute_dtype=cdt, **extra)
    params = _np_params(kw)
    r = np.random.default_rng(0)
    ann = r.standard_normal((N, 4)).astype(np.float32)
    w = r.standard_normal((N, D)).astype(np.float32)

    def jloss(prop, ann):
        h = jax_propagate(prop, JaxConfig(**kw), ann,
                          *map(jnp.asarray, edges), scatter_layout=lay_j)
        return jnp.sum(h * w)
    ref_loss, (ref_g, ref_ann) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params["prop"]), jnp.asarray(ann))
    prop = params_from_numpy(params["prop"])
    for p in param_leaves(prop):
        p.requires_grad_(True)
    t_ann = torch.tensor(ann, requires_grad=True)
    h = propagate(prop, ModelConfig(**kw), t_ann, *map(torch.tensor, edges),
                  scatter_layout=lay_t)
    terms = h * torch.tensor(w)
    loss = terms.sum()
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= \
        1e-5 * terms.abs().sum().item()
    tol = RELF[cdt]
    ref_leaves = _flat(jax.tree.map(lambda v: np.asarray(v, np.float64),
                                    ref_g))
    got_leaves = _flat(prop)
    assert sorted(got_leaves) == sorted(ref_leaves)
    for k, p in got_leaves.items():
        err = (np.linalg.norm(p.grad.numpy() - ref_leaves[k])
               / max(np.linalg.norm(ref_leaves[k]), 1e-30))
        assert err <= tol, (k, err)
    ra = np.asarray(ref_ann, np.float64)
    err = np.linalg.norm(t_ann.grad.numpy() - ra) / np.linalg.norm(ra)
    assert err <= tol, ("annotations", err)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tree[k]
    return out


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_per_tile_and_window_kernels_match_reference_on_card(dtype):
    """typed_onehot_scatter, typed_step_gru and window_block_spmm_mono
    against their plain versions on the card, on a hub layout whose hub
    block (and hub grad blocks) are split into several work items, with
    the criteria of chip_smoke.py: scatter max ≤ 2e-5·max(1, max|plain|);
    fused step per row ≤ 8 bf16 ulps (f32: 1e-4) times max(1, max|a_row|),
    mean ≤ 1e-3 in bf16; window SpMM flushed to bf16 within one bf16 ulp of
    the largest value, 2**-7·max(1, max|plain|) (f32: 2e-5·max(1, ...))."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    bf16 = dtype == "bfloat16"
    r = np.random.default_rng(0)
    N, E, T2 = 4096, 60000, 4
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                   r.integers(0, N, E))
    src = np.where(r.random(E) < 0.9, r.integers(0, 16, E),
                   r.integers(0, N, E))
    lay = S.build_typed_dst_layout(src, dst, r.integers(0, T2, E),
                                   np.ones(E, np.float32), N, T2,
                                   with_grad=True, tile_e=128,
                                   grad_tile_e=128)
    assert lay.block_meta is None and lay.meta[5][0] != "octet"
    assert np.diff(lay.arrays["tile_start"]).max() > 32
    assert np.diff(lay.arrays["g_tile_start"]).max() > 32
    lay = lay.to(dev)
    kw = S.tile_args(lay)
    n_rows = lay.n_blocks * 128
    u = lambda *s, b=1.0: torch.tensor(
        r.uniform(-b, b, s).astype(np.float32), device=dev)
    h_pack = u(N, D).to(tdt).index_select(0, lay.arrays["gather_idx"])
    w = u(T2, D, D, b=D ** -0.5).to(tdt)
    got = S.typed_onehot_scatter(h_pack, msg_w=w, **kw)
    ref = S.typed_onehot_scatter_reference(h_pack, msg_w=w, **kw)
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 2e-5 * scale
    g = dict(init=u(n_rows, D, b=0.1), hstate=u(n_rows, D),
             wa=u(D, 3 * D, b=D ** -0.5).to(tdt), b3=u(1, 3 * D, b=0.1),
             uzr=u(D, 2 * D, b=D ** -0.5).to(tdt),
             uh=u(D, D, b=D ** -0.5).to(tdt))
    got = S.typed_step_gru(h_pack, msg_w=w, **g, **kw)
    ref = S.typed_step_gru_reference(h_pack, msg_w=w, **g, **kw)
    a_rows = (g["init"] + S.typed_onehot_scatter_reference(
        h_pack, msg_w=w, **kw)).abs().amax(1).clamp_min(1.0)
    d = (got - ref).abs()
    assert (d.amax(1) <= (8 * BF16_ULP if bf16 else 1e-4) * a_rows).all()
    assert not bf16 or d.mean().item() <= 1e-3
    a = lay.arrays
    gm = S.grad_meta(lay)
    G = u(a["g_gather_idx"].shape[0], D).to(tdt)
    args = (G, a["g_dstl"], a["g_tile_start"], a["g_block_of_tile"],
            a["g_tile_msg_off"])
    mkw = dict(n_blocks=gm[0], window=gm[2], win_stride=gm[4], dstl=True,
               out_dtype=tdt)
    got = W.window_block_spmm_mono(*args, **mkw)
    ref = W.window_block_spmm_mono_reference(*args, **mkw)
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= (
        BF16_ULP if bf16 else 2e-5) * scale
