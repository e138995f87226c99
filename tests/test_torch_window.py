"""The port's window backend (serving) against the JAX package: the layout
(``build_window_layout``, ``window_layout_for_batch``, ``prefer_xw_spill``,
array for array and error for error), the plain versions of kernels #11
(int4-packed stream, 256- and 512-row blocks), #12 (on-demand windows),
#13 (the fused step: table, packed, q8 and on-demand) and #15 (the q8
table) against the JAX kernels in Pallas interpret mode, then
``aggregate_window``, ``gru_window_step``, ``propagate(backend='window')``
and the window ``Predictor``.  The same seeded numpy inputs go to both
packages; on the CPU the port's wrappers run their plain versions.

Tolerances:

- layouts: exact, array for array, dtype for dtype, ``meta`` and ``stats``;
- f32 sums (#11, #12, ``aggregate_window``): rtol = atol = 2e-5 (the same
  f32 products summed in another order; the port's plain sums run in f64);
- bf16 sums: one bf16 ulp of the largest value, 2**-7·max|ref| (an output
  or table row that rounds the other way);
- the fused step and states (#13, ``gru_window_step``, ``propagate``):
  f32 rtol = atol = 2e-5; bf16 2**-7·max|ref| (a = the window sums rounds
  to bf16 before the gate products, and a last-bit difference moves it by
  one ulp);
- q8 (#15): the same exponents where log2(max|v|) − 6.9886 is not within
  1e-6 of an integer (the f32 products differ in their last bits), and the
  dequantized tables within one quantum, 2^e, of each other; the q8 step
  and states as bf16 (both packages are handed the same int8 table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
from ggnn_tpu.infer import Predictor as JaxPredictor
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu.ops.scatter_pallas import static_tile_budget
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops import table as TB
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.ops import window_step as WS

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _edges(seed, N, E, T2, dst_hi=None):
    r = np.random.default_rng(seed)
    return (r.integers(0, N, E).astype(np.int32),
            r.integers(0, dst_hi or N, E).astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.9).astype(np.float32))


def _community(seed, N, E, T2, csize=64, p_intra=0.9, dst_hi=None):
    """Edges mostly inside ``csize``-node communities (dense tiles), the
    rest uniform (spill); dst below ``dst_hi`` (empty blocks above)."""
    r = np.random.default_rng(seed)
    hi = dst_hi or N
    dst = r.integers(0, hi, E)
    intra = r.random(E) < p_intra
    src = np.where(intra, (dst // csize) * csize + r.integers(0, csize, E),
                   r.integers(0, N, E)) % N
    return (src.astype(np.int32), dst.astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.95).astype(np.float32))


def _assert_layouts_equal(got, ref):
    assert got.meta == tuple(ref.meta), (got.meta, ref.meta)
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        v = np.asarray(v)
        a = np.asarray(got.arrays[k])
        assert a.dtype == v.dtype, (k, a.dtype, v.dtype)
        np.testing.assert_array_equal(a, v, err_msg=k)
    assert got.stats == ref.stats


def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray,
                        jax_init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw)))


def _close(got, ref, dtype, what=""):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5,
                                   err_msg=what)
    else:
        tol = BF16_ULP * max(np.abs(ref).max(), 1e-30)
        assert np.abs(got - ref).max() <= tol, (what, np.abs(got - ref).max(),
                                                tol)


# --- the layout --------------------------------------------------------------

N_L, E_L, T2_L = 512, 3000, 6
LAYOUT_CASES = {
    **{f"{rm}-min{m}": dict(row_major=rm, min_edges_per_tile=m, window=64,
                            spill_tile_e=8)
       for rm in ("block", "src", "type") for m in (1, 4, 10_000)},
    "packed": dict(window=256, block_rows=256, pack_counts=True,
                   min_edges_per_tile=2, spill_tile_e=8, n_message_types=4),
    "typed_spill": dict(window=128, row_major="block", typed_spill=True,
                        force_spill=True, min_edges_per_tile=4,
                        spill_tile_e=16),
    "typed_spill_dst_order": dict(window=128, row_major="src",
                                  typed_spill=True, spill_dst_order=True,
                                  min_edges_per_tile=4),
    "typed_spill_bucket": dict(window=64, typed_spill=True,
                               spill_bwd_bucket=600, min_edges_per_tile=3),
    "force_spill_aligned": dict(window=256, block_rows=256,
                                force_spill=True, min_edges_per_tile=180,
                                spill_tile_e=16, n_message_types=4),
    "padded": dict(window=128, row_major="block", force_spill=True,
                   min_edges_per_tile=4, spill_tile_e=128, pad_tiles_to=200,
                   spill_pad_tiles_to=static_tile_budget(E_L, N_L, 128)),
    "on_demand": dict(window=256, row_major="block", typed_spill=True,
                      on_demand=True, force_spill=True, spill_tile_e=16,
                      min_edges_per_tile=4),
    "block_rows_512": dict(window=512, block_rows=512, row_major="block",
                           min_edges_per_tile=2, n_message_types=8),
    "auto_spill_tile": dict(window=128, min_edges_per_tile=6),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_build_window_layout_matches_reference(case):
    """The host build, array for array, with the reference's numpy path,
    on a community graph whose upper dst blocks are empty."""
    kw = dict(LAYOUT_CASES[case])
    T2 = kw.setdefault("n_message_types", T2_L)
    edges = _community(1, N_L, E_L, T2, dst_hi=N_L - 128)
    ref = WP.build_window_layout(*edges, N_L, use_native=False, **kw)
    got = W.build_window_layout(*edges, N_L, use_native=True, **kw)
    _assert_layouts_equal(got, ref)
    dev = got.to("cpu")
    assert all(torch.is_tensor(v) for v in dev.arrays.values())
    assert dev.meta == got.meta and dev.stats == got.stats


@pytest.mark.parametrize("n_pad", [256, 200])
def test_window_layout_for_batch_matches_reference(n_pad):
    """The Predictor's static-budget layout: block-major table rows where
    n_pad % 128 == 0, src-major otherwise."""
    kw = dict(n_graphs=4, n_pad=n_pad, e_pad=800, n_edge_types=3,
              annotation_dim=2)
    r = np.random.default_rng(0)
    graphs = []
    for _ in range(4):
        n = int(r.integers(20, 40))
        m = int(r.integers(n, 3 * n))
        graphs.append(dict(n_nodes=n, edges=np.stack(
            [r.integers(0, n, m), r.integers(0, 3, m), r.integers(0, n, m)],
            axis=1), annotations=(r.random((n, 2)) < 0.5).astype(np.float32)))
    ref = WP.window_layout_for_batch(jax_batch_graphs(graphs, JaxSpec(**kw)))
    got = W.window_layout_for_batch(batch_graphs(graphs, PaddingSpec(**kw)))
    assert got.row_major == ("block" if n_pad % 128 == 0 else "src")
    _assert_layouts_equal(got, ref)


def test_prefer_xw_spill_regimes():
    for n, kw in ((1_000_192, dict(on_demand=True)), (262_144, {}),
                  (1_000_192, {}), (262_144, dict(quantized=True)),
                  (1_000_192, dict(quantized=True)), (512, {})):
        assert W.prefer_xw_spill(n, 128, **kw) == WP.prefer_xw_spill(
            n, 128, **kw)
    assert W.prefer_xw_spill(262_144, 128, quantized=True)
    assert not W.prefer_xw_spill(1_000_192, 128, quantized=True)


ERROR_CASES = {
    "block_rows": dict(block_rows=100),
    "n_nodes_pad": dict(block_rows=384),
    "row_major": dict(row_major="diagonal"),
    "pack_narrow": dict(window=128, pack_counts=True),
    "on_demand_src": dict(window=128, on_demand=True, typed_spill=True),
    "on_demand_no_xw": dict(window=128, row_major="block", on_demand=True),
    "on_demand_t2": dict(window=256, row_major="block", on_demand=True,
                         typed_spill=True, n_message_types=3),
    "typed_packed": dict(window=256, typed_spill=True, pack_counts=True,
                         force_spill=True),
    "n_src_rows": dict(row_major="block", n_src_rows=200),
    "pad_tiles_to": dict(window=64, pad_tiles_to=3),
    "bucket": dict(window=64, typed_spill=True, spill_bwd_bucket=8,
                   min_edges_per_tile=10_000),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_build_window_layout_errors_match_reference(case):
    """Every ValueError of the reference, with its message."""
    kw = dict(window=128, min_edges_per_tile=4, n_message_types=6)
    kw.update(ERROR_CASES[case])
    edges = _edges(2, N_L, E_L, 3)
    with pytest.raises(ValueError) as ref:
        WP.build_window_layout(*edges, N_L, use_native=False, **kw)
    with pytest.raises(ValueError) as got:
        W.build_window_layout(*edges, N_L, **kw)
    assert str(got.value) == str(ref.value)


def test_window_training_half_raises():
    """The training half raises what the reference raises: a
    gt_pad_tiles_to below the tile count, emit_res with the q8 table;
    grad_quant without with_grad warns and stays exact."""
    edges = _edges(2, N_L, E_L, 6)
    kw = dict(window=128, min_edges_per_tile=4, n_message_types=6,
              with_grad=True, gt_pad_tiles_to=3)
    with pytest.raises(ValueError) as ref:
        WP.build_window_layout(*edges, N_L, use_native=False, **kw)
    with pytest.raises(ValueError) as got:
        W.build_window_layout(*edges, N_L, **kw)
    assert str(got.value) == str(ref.value)
    with pytest.warns(UserWarning, match="grad_quant needs with_grad"):
        lay = W.build_window_layout(*edges, N_L, window=128, grad_quant=True)
    assert lay.meta[6] is None and lay.meta[10] is False
    with pytest.raises(ValueError, match="mutually exclusive"):
        W.window_step_gru(*[None] * 11, n_blocks=1, window=128,
                          emit_res=True, scales=torch.ones(1))


# --- the kernels' plain versions against the JAX kernels --------------------

def _kernel_layout(window, block_rows, pack=False, on_demand=False,
                   T2=8, N=1024, seed=3):
    """A community layout over N dst rows whose last dst block is empty
    (a dummy-only block), padded with extra dummy tiles; its blocks start
    with a dummy tile where window 0 holds no edge."""
    edges = _community(seed, N, 12 * N, T2, dst_hi=N - block_rows)
    kw = dict(window=window, block_rows=block_rows, min_edges_per_tile=2,
              n_message_types=T2, row_major="block", pack_counts=pack)
    if on_demand:
        kw.update(on_demand=True, typed_spill=True)
    lay = W.build_window_layout(*edges, N, **kw)
    lay = W.build_window_layout(*edges, N, pad_tiles_to=lay.n_tiles + 5,
                                **kw)
    a = lay.arrays
    first = a["tile_start"][:-1]
    assert (a["win_of_tile"][first] < 0).any(), "no dummy-first block"
    assert (np.diff(a["tile_start"])[-1] > 1
            and (a["win_of_tile"][a["tile_start"][-2]:] < 0).all())
    return lay


def _j(a):
    return jnp.asarray(np.asarray(a))


def _tensors(lay):
    return {k: torch.as_tensor(v) for k, v in lay.arrays.items()}


def _weights(seed, T2, D, cdt):
    r = np.random.default_rng(seed)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    gw = {k: (r.standard_normal(s) * D ** -0.5).astype(np.float32)
          for k, s in (("wa", (D, 3 * D)), ("uzr", (D, 2 * D)),
                       ("uh", (D, D)))}
    gw["b3"] = (r.standard_normal((1, 3 * D)) * 0.1).astype(np.float32)
    jw = {k: jnp.asarray(v, jnp.float32 if k == "b3" else DTYPES[cdt][0])
          for k, v in gw.items()}
    tw = {k: torch.tensor(v).to(torch.float32 if k == "b3"
                                else DTYPES[cdt][1]) for k, v in gw.items()}
    return w, b, jw, tw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form", ["packed_256", "rows_256", "rows_512"])
def test_window_mono_new_forms_match_jax(form, dtype):
    """#11 on the int4-packed stream and at out_rows 256 and 512."""
    jdt, tdt = DTYPES[dtype]
    rows = 512 if form == "rows_512" else 256
    lay = _kernel_layout(512 if rows == 512 else 256, rows,
                         pack=form.startswith("packed"))
    a, t = lay.arrays, _tensors(lay)
    R = lay.n_nodes_pad * 8
    table = np.random.default_rng(5).standard_normal((R, 128)).astype(
        np.float32)
    kw = dict(n_blocks=lay.n_blocks, window=lay.window, out_rows=rows,
              packed=lay.packed[0])
    ref = WP.window_block_spmm_mono(
        jnp.asarray(table, jdt), _j(a["c_stream"]), _j(a["tile_start"]),
        _j(a["block_of_tile"]), _j(a["win_of_tile"]), c_off=_j(a["c_off"]),
        interpret=True, **kw)
    got = W.window_block_spmm_mono(
        torch.tensor(table).to(tdt), t["c_stream"], t["tile_start"],
        t["block_of_tile"], t["win_of_tile"], c_off=t["c_off"], **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, "float32", form)
    # the empty (dummy-only) block is exactly 0
    assert (got[-rows:] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_window_ondemand_matches_jax(dtype):
    """#12: windows built from h blocks, at W 512 and 256-row blocks."""
    jdt, tdt = DTYPES[dtype]
    lay = _kernel_layout(512, 256, on_demand=True)
    a, t = lay.arrays, _tensors(lay)
    w, b, _, _ = _weights(6, 8, 128, dtype)
    h = np.random.default_rng(7).standard_normal((1024, 128)).astype(
        np.float32)
    kw = dict(n_blocks=lay.n_blocks, window=512, out_rows=256)
    ref = WP.window_block_spmm_ondemand(
        jnp.asarray(h, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        _j(a["c_stream"]), _j(a["tile_start"]), _j(a["block_of_tile"]),
        _j(a["win_of_tile"]), _j(a["c_off"]), interpret=True, **kw)
    got = W.window_block_spmm_ondemand(
        torch.tensor(h).to(tdt), torch.tensor(w).to(tdt),
        torch.tensor(b).to(tdt), t["c_stream"], t["tile_start"],
        t["block_of_tile"], t["win_of_tile"], t["c_off"], **kw)
    _close(got.numpy(), ref, dtype, "ondemand")


@pytest.mark.parametrize("window", [256, 512])
def test_node_table_q8_matches_jax(window):
    """#15: exponents equal away from integer boundaries, and the
    dequantized tables within one quantum."""
    w, b, _, _ = _weights(8, 8, 128, "bfloat16")
    h = np.random.default_rng(9).standard_normal((512, 128)).astype(
        np.float32)
    hb = jnp.asarray(h, jnp.bfloat16)
    tq_j, sc_j = WP.node_table_block_major_q8(
        hb, jnp.asarray(w, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        window=window, interpret=True)
    tq, sc = TB.node_table_block_major_q8(
        torch.tensor(h).bfloat16(), torch.tensor(w).bfloat16(),
        torch.tensor(b).bfloat16(), window=window)
    assert tq.dtype == torch.int8 and tuple(tq.shape) == tq_j.shape
    assert tuple(sc.shape) == sc_j.shape == (512 * 8 // window, 1)
    e_j = np.log2(np.asarray(sc_j)[:, 0])
    e_t = np.log2(sc.numpy()[:, 0])
    # the f32 argument of ceil, from the port's plain table
    tab = torch.einsum("nd,tdf->ntf", torch.tensor(h).bfloat16().float(),
                       torch.tensor(w).bfloat16().float()) \
        + torch.tensor(b).bfloat16().float()[None]
    m = tab.reshape(4, 128, 8 * 128 // window, window // 128, 128).abs() \
        .amax(dim=(1, 3, 4)).reshape(-1).numpy()
    arg = np.log2(np.maximum(m, 1e-30)) - 6.9886
    near = np.abs(arg - np.round(arg)) < 1e-6
    assert (e_j == e_t)[~near].all()
    deq = lambda q, s: (np.asarray(q, np.float32)
                        * np.repeat(np.asarray(s)[:, 0], window)[:, None])
    diff = np.abs(deq(tq.numpy(), sc.numpy()) - deq(tq_j, sc_j))
    quantum = np.maximum(np.repeat(np.asarray(sc_j)[:, 0], window),
                         np.repeat(sc.numpy()[:, 0], window))[:, None]
    assert (diff <= quantum).all()


STEP_FORMS = ["table_f32", "table_bf16", "packed_bf16", "q8", "ondemand_f32",
              "ondemand_bf16"]


@pytest.mark.parametrize("has_init", [True, False])
@pytest.mark.parametrize("form", STEP_FORMS)
def test_window_step_gru_matches_jax(form, has_init):
    """#13, each table source, with and without the init stream, on a
    layout with dummy-first blocks, an empty last block and padding
    tiles (W 256, 256-row blocks)."""
    dtype = "float32" if form.endswith("f32") else "bfloat16"
    jdt, tdt = DTYPES[dtype]
    q8, ondemand = form == "q8", form.startswith("ondemand")
    lay = _kernel_layout(256, 256, pack=form.startswith("packed"),
                         on_demand=ondemand)
    a, t = lay.arrays, _tensors(lay)
    N, D, T2 = 1024, 128, 8
    w, b, jw, tw = _weights(10, T2, D, dtype)
    r = np.random.default_rng(11)
    h = (r.random((N, D)) * 2 - 1).astype(np.float32)
    init = (r.standard_normal((N, D)) * 0.5).astype(np.float32)
    hc = torch.tensor(h).to(tdt)
    extra_j, extra_t = {}, {}
    if q8:
        table_t, sc = TB.node_table_block_major_q8(
            hc, torch.tensor(w).to(tdt), torch.tensor(b).to(tdt), window=256)
        table_j = _j(table_t.numpy())
        extra_j["scales"], extra_t["scales"] = _j(sc[:, 0].numpy()), sc[:, 0]
    elif ondemand:
        table_t, table_j = hc, jnp.asarray(h, jdt)
        extra_j.update(msg_w=jnp.asarray(w, jdt), msg_b=jnp.asarray(b, jdt))
        extra_t.update(msg_w=torch.tensor(w).to(tdt),
                       msg_b=torch.tensor(b).to(tdt))
    else:
        table_t = TB.node_table(hc, torch.tensor(w).to(tdt),
                                torch.tensor(b).to(tdt), "block")
        table_j = _j(table_t.float().numpy()).astype(jdt)
    kw = dict(n_blocks=lay.n_blocks, window=256, out_rows=256,
              packed=lay.packed[0], has_init=has_init)
    ref = WP.window_step_gru(
        table_j, _j(a["c_stream"]), _j(a["tile_start"]),
        _j(a["block_of_tile"]), _j(a["win_of_tile"]), jnp.asarray(init),
        jnp.asarray(h), jw["wa"], jw["b3"], jw["uzr"], jw["uh"],
        c_off=_j(a["c_off"]), interpret=True, **kw, **extra_j)
    got = W.window_step_gru(
        table_t, t["c_stream"], t["tile_start"], t["block_of_tile"],
        t["win_of_tile"], torch.tensor(init), torch.tensor(h), tw["wa"],
        tw["b3"], tw["uzr"], tw["uh"], c_off=t["c_off"], **kw, **extra_t)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, dtype, form)


# --- aggregate_window and gru_window_step ------------------------------------

AGG_CASES = {
    # name: (build_window_layout kwargs, N, T2, D)
    **{f"{rm}-min{m}": (dict(window=64, min_edges_per_tile=m,
                             spill_tile_e=8, row_major=rm), 256, 6, 32)
       for rm in ("block", "src", "type") for m in (1, 4, 10_000)},
    "typed_spill_block": (dict(window=64, min_edges_per_tile=4,
                               spill_tile_e=16, row_major="block",
                               force_spill=True, typed_spill=True), 256, 6,
                          32),
    "typed_spill_src_all": (dict(window=64, min_edges_per_tile=10_000,
                                 spill_tile_e=16, row_major="src",
                                 force_spill=True, typed_spill=True), 256,
                            6, 32),
    "on_demand_128": (dict(window=128, min_edges_per_tile=1,
                           spill_tile_e=16, row_major="block",
                           force_spill=True, typed_spill=True,
                           on_demand=True), 256, 6, 32),
    "on_demand_256": (dict(window=256, min_edges_per_tile=4,
                           spill_tile_e=16, row_major="block",
                           force_spill=True, typed_spill=True,
                           on_demand=True), 256, 6, 32),
    "edge_align": (dict(window=256, min_edges_per_tile=180, spill_tile_e=16,
                        block_rows=256, force_spill=True), 512, 4, 32),
    "packed": (dict(window=256, min_edges_per_tile=2, spill_tile_e=8,
                    block_rows=256, pack_counts=True), 512, 4, 32),
}


def _agg_inputs(case, E=None, seed=0):
    kw, N, T2, D = AGG_CASES[case]
    edges = _edges(seed, N, E or (600 if N == 256 else 3000), T2)
    lay = W.build_window_layout(*edges, N, n_message_types=T2, **kw)
    r = np.random.default_rng(seed + 1)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    jlay = WP.DeviceWindowLayout(
        meta=lay.meta, arrays={k: _j(v) for k, v in lay.arrays.items()})
    return lay, jlay, h, w, b


@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_window_matches_jax(case):
    """aggregate_window in f32 on the layouts of the reference's window
    parity tests (every row order and spill regime, the XW spill, on-demand
    windows, the aligned spill, int4 counts)."""
    lay, jlay, h, w, b = _agg_inputs(case)
    ref = WP.aggregate_window(jnp.asarray(h), jlay, jnp.asarray(w),
                              jnp.asarray(b), interpret=True)
    got = WS.aggregate_window(torch.tensor(h), lay.to("cpu"),
                              torch.tensor(w), torch.tensor(b))
    _close(got.numpy(), ref, "float32", case)


def _gru_np(seed, D):
    p = _np_params(dict(state_dim=D, annotation_dim=2, n_edge_types=2),
                   seed)["prop"]["gru"]
    return p


STEP_CASES = {
    # name: (AGG_CASES key or layout kwargs, dtype, quantized, extra_init)
    "dense_src": ("src-min1", "float32", False, False),
    "mixed_block": ("block-min4", "float32", False, False),
    "all_spill": ("block-min10000", "float32", False, False),
    "packed": ("packed", "float32", False, False),
    "edge_align": ("edge_align", "float32", False, False),
    "typed_spill": ("typed_spill_block", "float32", False, False),
    "on_demand": ("on_demand_256", "float32", False, False),
    "extra_init": ("block-min4", "float32", False, True),
    "bf16_on_demand": ("on_demand_128", "bfloat16", False, False),
    "q8_legacy_spill": ("q8_legacy", "bfloat16", True, False),
    "q8_xw_spill": ("q8_xw", "bfloat16", True, False),
    "q8_extra_no_spill": ("q8_nospill", "bfloat16", True, True),
}
Q8_LAYOUTS = {
    "q8_legacy": dict(window=256, min_edges_per_tile=120, spill_tile_e=16,
                      block_rows=256, row_major="block"),
    "q8_xw": dict(window=256, min_edges_per_tile=120, spill_tile_e=16,
                  block_rows=256, row_major="block", typed_spill=True),
    "q8_nospill": dict(window=256, min_edges_per_tile=1, block_rows=256,
                       row_major="block"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_gru_window_step_matches_jax(case):
    """gru_window_step against the reference's on the layouts of its fused
    step tests (dense, mixed, all-spill init only, int4 counts, the aligned
    and XW spills, on-demand windows, an extra init) and of its q8 tests
    (legacy and XW spill, extra init without spill; D = 128)."""
    key, dtype, quantized, extra = STEP_CASES[case]
    jdt, tdt = DTYPES[dtype]
    if key in Q8_LAYOUTS:
        N, T2, D = 256, 4, 128
        edges = _edges(12, N, 3000, T2)
        lay = W.build_window_layout(*edges, N, n_message_types=T2,
                                    **Q8_LAYOUTS[key])
        r = np.random.default_rng(13)
        h = r.standard_normal((N, D)).astype(np.float32)
        w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
        b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
        jlay = WP.DeviceWindowLayout(
            meta=lay.meta, arrays={k: _j(v) for k, v in lay.arrays.items()})
    else:
        lay, jlay, h, w, b = _agg_inputs(key)
        N, D = h.shape
    if case == "bf16_on_demand":
        # the on-demand fused kernel at D = 128, 8 message types
        edges = _edges(14, 256, 600, 8)
        lay = W.build_window_layout(
            *edges, 256, n_message_types=8, window=512, block_rows=256,
            min_edges_per_tile=2, spill_tile_e=16, row_major="block",
            force_spill=True, typed_spill=True, on_demand=True)
        jlay = WP.DeviceWindowLayout(
            meta=lay.meta, arrays={k: _j(v) for k, v in lay.arrays.items()})
        r = np.random.default_rng(15)
        N, D = 256, 128
        h = r.standard_normal((N, D)).astype(np.float32)
        w = (r.standard_normal((8, D, D)) * D ** -0.5).astype(np.float32)
        b = (r.standard_normal((8, D)) * 0.1).astype(np.float32)
    gru = _gru_np(16, D)
    ext = (np.random.default_rng(17).standard_normal((N, D)) * 0.1).astype(
        np.float32) if extra else None
    ref = WP.gru_window_step(
        jnp.asarray(h), jlay, jnp.asarray(w, jdt), jnp.asarray(b, jdt),
        jax.tree.map(lambda x: jnp.asarray(x, jdt), gru), interpret=True,
        quantized=quantized,
        extra_init=None if ext is None else jnp.asarray(ext))
    got = WS.gru_window_step(
        torch.tensor(h), lay.to("cpu"), torch.tensor(w).to(tdt),
        torch.tensor(b).to(tdt),
        {k: torch.tensor(v).to(tdt) for k, v in gru.items()},
        quantized=quantized,
        extra_init=None if ext is None else torch.tensor(ext))
    _close(got.numpy(), ref, dtype, case)


# --- propagate and the Predictor --------------------------------------------

@pytest.mark.parametrize("mode", ["fused", "unfused", "q8"])
def test_propagate_window_matches_jax(mode):
    """Per-step states of propagate(backend='window') against the JAX
    package's on one community layout (bf16, D = 128, 3 steps)."""
    N, E, T = 512, 4000, 2
    kw = dict(state_dim=128, annotation_dim=4, n_edge_types=T, n_steps=3,
              backend="window", compute_dtype="bfloat16",
              fuse_gru=mode != "unfused", quantized_table=mode == "q8")
    params = _np_params(kw, seed=2)
    edges = _community(3, N, E, 2 * T)
    lay = W.build_window_layout(*edges, N, window=256, block_rows=256,
                                min_edges_per_tile=4, n_message_types=2 * T,
                                row_major="block",
                                typed_spill=mode == "q8")
    jlay = WP.DeviceWindowLayout(
        meta=lay.meta, arrays={k: _j(v) for k, v in lay.arrays.items()})
    ann = (np.random.default_rng(4).random((N, 4)) < 0.4).astype(np.float32)
    _, ref = jax_propagate(params["prop"], JaxConfig(**kw), jnp.asarray(ann),
                           *map(jnp.asarray, edges), collect_states=True,
                           scatter_layout=jlay)
    with torch.no_grad():
        _, got = propagate(params_from_numpy(params["prop"]),
                           ModelConfig(**kw), torch.tensor(ann),
                           *map(torch.tensor, edges), collect_states=True,
                           scatter_layout=lay)
    for t in range(3):
        _close(got[t].numpy(), np.asarray(ref[t]), "bfloat16", f"step {t}")


def test_predictor_window_matches_jax():
    """The window Predictor (its own window_layout_for_batch: static
    budgets, the legacy spill, block-major rows) against the JAX
    Predictor's scores, bf16, D = 128, fused."""
    kw = dict(state_dim=128, annotation_dim=2, n_edge_types=3, n_steps=3,
              head="node_select", backend="window", compute_dtype="bfloat16",
              fuse_gru=True)
    spec = dict(n_graphs=4, n_pad=512, e_pad=4800, n_edge_types=3,
                annotation_dim=2)
    r = np.random.default_rng(6)
    graphs = [dict(n_nodes=120, edges=np.stack(
        [r.integers(0, 120, 600), r.integers(0, 3, 600),
         r.integers(0, 120, 600)], axis=1),
        annotations=(r.random((120, 2)) < 0.5).astype(np.float32))
        for _ in range(4)]
    params = _np_params(kw, seed=4)
    pj = JaxPredictor(JaxConfig(**kw), JaxSpec(**spec),
                      params=jax.tree.map(jnp.asarray, params))
    pt = Predictor(ModelConfig(**kw), PaddingSpec(**spec), params=params,
                   device="cpu")
    jb = jax_batch_graphs(graphs, JaxSpec(**spec))
    ref = np.asarray(pj._fwd(pj.params, jax.tree.map(jnp.asarray, jb.arrays),
                             pj._layout(jb)))
    batch = batch_graphs(graphs, PaddingSpec(**spec))
    lay = pt.layout(batch)
    assert lay.row_major == "block" and lay.spill_meta is not None
    got = pt.run_batch(batch)
    assert np.abs(got - ref).max() <= BF16_ULP * np.abs(ref).max()
    assert pt.predict(graphs) == pj.predict(graphs)


def test_window_under_autograd_raises():
    """Under autograd the window backend raises what the reference
    raises: a layout without its grad half refuses the backward, the q8
    step is forward only, propagate needs a layout; with a with_grad
    layout, propagate's gradient of msg_w is the JAX package's."""
    lay, jlay, h, w, b = _agg_inputs("block-min4")
    wt = torch.tensor(w, requires_grad=True)
    a = WS.aggregate_window(torch.tensor(h), lay.to("cpu"), wt,
                            torch.tensor(b))
    with pytest.raises(ValueError, match="with_grad=True"):
        a.sum().backward()
    gru = {k: torch.tensor(v) for k, v in _gru_np(16, 32).items()}
    with pytest.raises(ValueError, match="serving mode"):
        WS.gru_window_step(torch.tensor(h), lay.to("cpu"), wt,
                           torch.tensor(b), gru, quantized=True)
    kw = dict(state_dim=32, annotation_dim=4, n_edge_types=3, n_steps=2,
              backend="window")
    np_prop = _np_params(kw)["prop"]
    params = params_from_numpy(np_prop)
    params["msg_w"].requires_grad_(True)
    edges = _edges(0, 256, 600, 6)
    with pytest.raises(ValueError, match="precomputed layout"):
        propagate(params, ModelConfig(**kw), torch.zeros(256, 4),
                  *map(torch.tensor, edges))
    glay = W.build_window_layout(*edges, 256, n_message_types=6,
                                 with_grad=True, **AGG_CASES["block-min4"][0])
    ann = (np.random.default_rng(3).random((256, 4)) < 0.4).astype(np.float32)
    out = propagate(params, ModelConfig(**kw), torch.tensor(ann),
                    *map(torch.tensor, edges), scatter_layout=glay)
    (out ** 2).sum().backward()
    jglay = WP.DeviceWindowLayout(
        meta=glay.meta, arrays={k: _j(v) for k, v in glay.arrays.items()})
    ref = jax.grad(lambda p: jnp.sum(jax_propagate(
        p, JaxConfig(**kw), jnp.asarray(ann), *map(jnp.asarray, edges),
        scatter_layout=jglay) ** 2))(jax.tree.map(jnp.asarray, np_prop))
    np.testing.assert_allclose(params["msg_w"].grad.numpy(),
                               np.asarray(ref["msg_w"]), rtol=3e-4,
                               atol=3e-5)
