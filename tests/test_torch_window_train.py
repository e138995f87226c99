"""The port's window backend under training against the JAX package: the
``with_grad`` half of ``build_window_layout`` (array for array), the
backward of ``aggregate_window`` on the Y path (#11 over the transposed
stream) and the fused path (#14), the fused step's VJP (#13 with
``emit_res``, #4, the window backward), ``propagate(backend='window')``
and one ``make_train_step``, ``quantize_grad_pow2``, and the plain versions
of #13's ``emit_res`` form and #14 against the JAX kernels in Pallas
interpret mode; then the width padding of the kernels' wrappers.  The same
seeded numpy inputs go to both packages; on the CPU the port's wrappers run
their plain versions.

Tolerances (those of ``tests/test_window_pallas.py`` where it has the
test):

- layouts: exact, array for array, dtype for dtype, ``meta``;
- gradients through ``aggregate_window`` and the fused step: rtol = atol
  = 2e-4; through ``propagate``: rtol 3e-4, atol 3e-5;
- ``quantize_grad_pow2``: bit-equal;
- #13's residuals: f32 rtol = atol = 2e-5; bf16: a within one ulp of its
  largest value (the bf16 window sums' bound), z, r, h̃ within 8 ulps at
  1.0 and 1e-3 on average (a row whose a rounds the other way moves its
  gates by ulp(a)·|W|: the fused step's own bound);
- #14: f32 rtol = atol = 2e-4 (the same f32 products, summed in another
  order); bf16 one ulp of the slab Y times Σ|W| or Σ|h| per element;
- one Adam step (f32): the loss rtol 1e-5; the gradients rtol 1e-4, atol
  1e-5 of the leaf's largest; every parameter rtol 1e-5, atol 1e-6 where
  its gradient is at least 1e-4 of the leaf's largest (Adam's first step
  is lr·sign(g) unless |g| is near ε, so a tiny g's last bits decide it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import loss_and_metrics as jax_loss
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.models.ggnn import gru_update
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.ops import window_step as WS
from ggnn_tpu_torch.train.checkpoint import _flatten
from ggnn_tpu_torch.train.loop import (make_optimizer, make_train_step,
                                       param_leaves)

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7


def _edges(seed, N, E, T2):
    """The reference tests' random_edges, from a seed."""
    r = np.random.default_rng(seed)
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, N, E).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = np.ones(E, np.float32)
    mask[r.random(E) < 0.1] = 0.0
    return src, dst, typ, mask


def _community(seed, N, E, T2, csize=64, dst_hi=None):
    r = np.random.default_rng(seed)
    dst = r.integers(0, dst_hi or N, E)
    intra = r.random(E) < 0.9
    src = np.where(intra, (dst // csize) * csize + r.integers(0, csize, E),
                   r.integers(0, N, E)) % N
    return (src.astype(np.int32), dst.astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.95).astype(np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _both(edges, N, **kw):
    """The port's layout (host form) and the reference's, checked equal
    array for array."""
    got = W.build_window_layout(*edges, N, **kw)
    ref = WP.build_window_layout(*edges, N, use_native=False, **kw)
    assert got.meta == tuple(ref.meta)
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        a, v = np.asarray(got.arrays[k]), np.asarray(v)
        assert a.dtype == v.dtype, (k, a.dtype, v.dtype)
        np.testing.assert_array_equal(a, v, err_msg=k)
    return got, ref


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# --- the with_grad layout -----------------------------------------------------

N_L, E_L, T2_L = 512, 3000, 6
LAYOUT_CASES = {
    **{f"{rm}-min{m}": dict(row_major=rm, min_edges_per_tile=m, window=64,
                            spill_tile_e=8)
       for rm in ("block", "src", "type") for m in (1, 4, 10_000)},
    "packed": dict(window=256, block_rows=256, pack_counts=True,
                   min_edges_per_tile=2, spill_tile_e=8, n_message_types=4),
    "fused_stream": dict(window=256, block_rows=256, row_major="block",
                         min_edges_per_tile=2, n_message_types=4),
    "typed_spill": dict(window=128, row_major="block", typed_spill=True,
                        force_spill=True, min_edges_per_tile=4,
                        spill_tile_e=16),
    "on_demand": dict(window=256, row_major="block", typed_spill=True,
                      on_demand=True, force_spill=True, spill_tile_e=16,
                      min_edges_per_tile=4),
    "grad_quant": dict(window=256, block_rows=256, row_major="block",
                       min_edges_per_tile=2, n_message_types=4,
                       grad_quant=True),
    "pins": dict(window=64, min_edges_per_tile=4, spill_tile_e=8,
                 gt_pad_tiles_to=2000, spill_bwd_bucket=600,
                 spill_bwd_tile_e=16, spill_bwd_pad_tiles_to=200),
    "odd_src_rows": dict(window=64, row_major="src", n_src_rows=200,
                         force_spill=True, min_edges_per_tile=4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_window_packed_parity(case):
    """build_window_layout(with_grad=True): the transposed tiles, the
    forward-stream offsets or the transposed stream (int4 with pack_bwd),
    gt_indeg, the spill backward's buckets and sb_ layout, the pins and
    grad_meta, array for array with the reference's numpy path (the
    ``packed`` case is the reference's test_window_packed_parity[True])."""
    kw = dict(LAYOUT_CASES[case])
    T2 = kw.setdefault("n_message_types", T2_L)
    n_src = kw.get("n_src_rows", N_L)
    edges = _community(1, n_src, E_L, T2, dst_hi=N_L - 128)
    got, _ = _both(edges, N_L, with_grad=True, **kw)
    assert got.grad_meta is not None
    assert got.meta[10] == (case == "grad_quant")


def test_grad_quant_without_fused_stream_warns():
    """grad_quant where the fused backward does not apply (src rows):
    the reference's warning, and exact gradients (meta[10] False)."""
    edges = _community(1, N_L, E_L, T2_L)
    for build in (W.build_window_layout, WP.build_window_layout):
        with pytest.warns(UserWarning, match="fused backward stream"):
            lay = build(*edges, N_L, window=64, with_grad=True,
                        grad_quant=True)
        assert lay.meta[10] is False
    with pytest.raises(ValueError, match="gt_pad_tiles_to=3"):
        W.build_window_layout(*edges, N_L, window=64, with_grad=True,
                              gt_pad_tiles_to=3)


# --- aggregate_window's backward ----------------------------------------------

def _agg_grads(lay, jlay, N, T2, D, seed=0, n_src=None):
    """dh, dW, db of Σ (aggregate_window(h) − tgt)² in both packages."""
    n_src = n_src or N
    h = _rand(seed, n_src, D)
    w = _rand(seed + 1, T2, D, D, scale=0.2)
    b = _rand(seed + 2, T2, D, scale=0.1)
    tgt = _rand(seed + 3, n_src, D)

    def loss_j(h, w, b):
        out = WP.aggregate_window(h, jlay, w, b, interpret=True)
        return jnp.sum((out - tgt) ** 2)

    ref = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (h, w, b)))
    th, tw, tb = (torch.tensor(x, requires_grad=True) for x in (h, w, b))
    out = WS.aggregate_window(th, lay.to("cpu"), tw, tb)
    ((out - torch.tensor(tgt)) ** 2).sum().backward()
    return (th.grad, tw.grad, tb.grad), ref


def _assert_grads(got, ref, rtol=2e-4, atol=2e-4):
    for g, r, name in zip(got, ref, ("dh", "dW", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("row_major,window",
                         [("block", 64), ("block", 128), ("block", 256),
                          ("src", 64), ("type", 64)])
def test_window_grad_parity(row_major, window):
    """The backward of aggregate_window against the reference's: block
    rows with W % 128 == 0 take the fused path (#14), the others the Y
    path (#11 on the transposed stream) and the spill backward."""
    N, E, T2, D = 256, 600, 6, 32
    edges = _edges(0, N, E, T2)
    lay, ref = _both(edges, N, window=window, min_edges_per_tile=4,
                     spill_tile_e=8, n_message_types=T2, row_major=row_major,
                     with_grad=True)
    assert lay.grad_meta[4] == (row_major == "block" and window % 128 == 0
                                and (T2 * 128) % window == 0)
    _assert_grads(*_agg_grads(lay, ref, N, T2, D))


def test_window_grad_parity_dummy_first_windows():
    """The fused backward where many windows start with their dummy tile
    (no real tile at dst block 0): each window's sum must start from zero
    (the reference's kernel once left dh 36 % off)."""
    N, E, T2, D = 384, 2000, 4, 64
    edges = _edges(1, N, E, T2)
    lay, ref = _both(edges, N, window=128, min_edges_per_tile=40,
                     spill_tile_e=8, n_message_types=T2, row_major="block",
                     with_grad=True, force_spill=True)
    assert 0 < lay.stats["spill_frac"] < 0.5 and lay.grad_meta[4]
    gt_win, gt_start = lay.arrays["gt_win_of_tile"], \
        lay.arrays["gt_tile_start"]
    first = gt_start[:-1]
    assert ((gt_win[first] < 0) & (np.diff(gt_start) > 1)).any()
    _assert_grads(*_agg_grads(lay, ref, N, T2, D, seed=4))


def test_window_grad_parity_straddle():
    """Windows that straddle source blocks (T2 = 3, W = 256): the fused
    backward does not apply, the Y path carries it."""
    N, E, T2, D = 256, 700, 3, 32
    edges = _edges(2, N, E, T2)
    lay, ref = _both(edges, N, window=256, min_edges_per_tile=4,
                     spill_tile_e=8, n_message_types=T2, row_major="block",
                     with_grad=True)
    assert not lay.grad_meta[4] and "ct_stream" in lay.arrays
    _assert_grads(*_agg_grads(lay, ref, N, T2, D, seed=8))


@pytest.mark.parametrize("case", ["typed_spill", "packed", "odd_src_rows"])
def test_window_grad_parity_spill_forms(case):
    """The spill backward's other forms: the XW spill's own buckets
    (on-demand windows, fused), int4 transposed counts (pack_bwd), and
    n_src_rows % 128 ≠ 0, where no sb_ layout exists and the dh rows are
    summed by rows_sum (fixed order) as the reference's .at[].add."""
    T2, D = 4, 32
    if case == "typed_spill":
        N, n_src = 256, 256
        kw = dict(window=256, row_major="block", typed_spill=True,
                  on_demand=True, force_spill=True, spill_tile_e=16,
                  min_edges_per_tile=4)
    elif case == "packed":
        N, n_src = 512, 512
        kw = dict(window=256, block_rows=256, pack_counts=True,
                  min_edges_per_tile=2, spill_tile_e=8)
    else:
        N, n_src = 256, 200
        kw = dict(window=64, row_major="src", n_src_rows=n_src,
                  force_spill=True, min_edges_per_tile=4, spill_tile_e=8)
    edges = _edges(3, n_src, 1500, T2)
    lay, ref = _both(edges, N, n_message_types=T2, with_grad=True, **kw)
    if case == "odd_src_rows":
        assert "sb_gather_idx" not in lay.arrays
        assert lay.grad_meta[3] is None
    _assert_grads(*_agg_grads(lay, ref, N, T2, D, seed=12, n_src=n_src))


def test_rows_sum_is_the_ordered_sum():
    """rows_sum against np.add.at in f64: rows past n_rows dropped."""
    r = np.random.default_rng(5)
    rows = r.integers(0, 40, 500)
    vals = r.standard_normal((500, 3)).astype(np.float32)
    want = np.zeros((32, 3))
    keep = rows < 32
    np.add.at(want, rows[keep], vals[keep].astype(np.float64))
    got = WS.rows_sum(torch.tensor(vals), torch.tensor(rows), 32)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# --- quantize_grad_pow2, #13's emit_res and #14 against the JAX kernels -----

def test_quantize_grad_pow2_matches_jax():
    """Bit-equal int8 values and scales, a block of zeros included."""
    da = _rand(6, 1024, 128) * np.repeat(
        np.array([1e-3, 1.0, 37.5, 0.0], np.float32), 256)[:, None]
    qj, sj = WP.quantize_grad_pow2(jnp.asarray(da), 256)
    qt, st = W.quantize_grad_pow2(torch.tensor(da), 256)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    # the zero block's scale 2^-106 multiplies only zeros; XLA's CPU exp2
    # misses that power of two in its last bit, torch's gives it exactly
    np.testing.assert_array_equal(st.numpy()[:3], np.asarray(sj)[:3])
    assert st[3] == 2.0 ** -106 and not qt[768:].any()


def _kernel_layout(window, block_rows, T2=8, N=1024, seed=3, on_demand=False):
    """A community layout with an empty last dst block, padding tiles and
    dummy-first blocks, built with its grad half."""
    edges = _community(seed, N, 12 * N, T2, dst_hi=N - block_rows)
    kw = dict(window=window, block_rows=block_rows, min_edges_per_tile=2,
              n_message_types=T2, row_major="block", with_grad=True)
    if on_demand:
        kw.update(on_demand=True, typed_spill=True)
    return W.build_window_layout(*edges, N, **kw)


@pytest.mark.parametrize("form", ["table_f32", "table_bf16",
                                  "ondemand_bf16"])
def test_window_step_emit_res_matches_jax(form):
    """#13's emit_res form: h' and the residuals (a | z | r | h̃) against
    window_step_gru(emit_res=True) of the JAX package; with q8 it raises
    the reference's ValueError."""
    bf16 = form.endswith("bf16")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    ondemand = form.startswith("ondemand")
    lay = _kernel_layout(256, 256, on_demand=ondemand)
    a, t = lay.arrays, lay.to("cpu").arrays
    N, D, T2 = 1024, 128, 8
    r = np.random.default_rng(11)
    h = (r.random((N, D)) * 2 - 1).astype(np.float32)
    init = (r.standard_normal((N, D)) * 0.5).astype(np.float32)
    w, b = _rand(12, T2, D, D, scale=D ** -0.5), _rand(13, T2, D, scale=0.1)
    gw = {k: _rand(14 + i, *s, scale=D ** -0.5) for i, (k, s) in enumerate(
        (("wa", (D, 3 * D)), ("uzr", (D, 2 * D)), ("uh", (D, D))))}
    b3 = _rand(20, 1, 3 * D, scale=0.1)
    hc = torch.tensor(h).to(tdt)
    if ondemand:
        table_t, table_j = hc, jnp.asarray(h, jdt)
        xj = dict(msg_w=jnp.asarray(w, jdt), msg_b=jnp.asarray(b, jdt))
        xt = dict(msg_w=torch.tensor(w).to(tdt), msg_b=torch.tensor(b).to(tdt))
    else:
        from ggnn_tpu_torch.ops import table as TB
        table_t = TB.node_table(hc, torch.tensor(w).to(tdt),
                                torch.tensor(b).to(tdt), "block")
        table_j = jnp.asarray(table_t.float().numpy()).astype(jdt)
        xj, xt = {}, {}
    kw = dict(n_blocks=lay.n_blocks, window=256, out_rows=256, emit_res=True)
    hj, rj = WP.window_step_gru(
        table_j, _j(a["c_stream"]), _j(a["tile_start"]),
        _j(a["block_of_tile"]), _j(a["win_of_tile"]), jnp.asarray(init),
        jnp.asarray(h), *(jnp.asarray(gw[k], jdt) for k in ("wa",)),
        jnp.asarray(b3), jnp.asarray(gw["uzr"], jdt),
        jnp.asarray(gw["uh"], jdt), c_off=_j(a["c_off"]), interpret=True,
        **kw, **xj)
    ht, rt = W.window_step_gru(
        table_t, t["c_stream"], t["tile_start"], t["block_of_tile"],
        t["win_of_tile"], torch.tensor(init), torch.tensor(h),
        torch.tensor(gw["wa"]).to(tdt), torch.tensor(b3),
        torch.tensor(gw["uzr"]).to(tdt), torch.tensor(gw["uh"]).to(tdt),
        c_off=t["c_off"], **kw, **xt)
    assert rt.dtype == tdt and tuple(rt.shape) == (N, 4 * D)
    got, ref = rt.float().numpy(), np.asarray(rj, np.float32)
    if bf16:
        # a within one ulp of its largest value (as the bf16 window sums);
        # a row whose a rounds the other way moves its gates by
        # ulp(a)·|W|: z, r, h̃ within 8 ulps at 1.0, on average 1e-3 (the
        # fused step's bound)
        d = np.abs(got - ref)
        assert d[:, :D].max() <= BF16_ULP * np.abs(ref[:, :D]).max()
        assert d[:, D:].max() <= 8 * BF16_ULP and d[:, D:].mean() <= 1e-3
        assert np.abs(ht.numpy() - np.asarray(hj)).max() <= \
            8 * BF16_ULP * max(1.0, np.abs(np.asarray(hj)).max())
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        W.window_step_gru(table_t, t["c_stream"], t["tile_start"],
                          t["block_of_tile"], t["win_of_tile"], None, None,
                          None, None, None, None, n_blocks=lay.n_blocks,
                          window=256, emit_res=True,
                          scales=torch.ones(1))


@pytest.mark.parametrize("form", ["exact_f32", "int8_f32", "exact_bf16",
                                  "int8_bf16"])
def test_window_bwd_fused_matches_jax(form):
    """#14's plain version against window_bwd_fused of the JAX package, on
    the forward stream of a layout with dummy-first windows and an empty
    dst block, exact and with int8 gradients."""
    bf16, quant = form.endswith("bf16"), form.startswith("int8")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    lay = _kernel_layout(512, 256)
    a, t = lay.arrays, lay.to("cpu").arrays
    assert lay.grad_meta[4]
    N, D, T2 = 1024, 128, 8
    da = _rand(21, N, D)
    h = _rand(22, N, D)
    w = _rand(23, T2, D, D, scale=D ** -0.5)
    n_wins = lay.grad_meta[0]
    gt = [a[k] for k in ("gt_tile_start", "gt_block_of_tile",
                         "gt_win_of_tile", "gt_c_off")]
    kw = dict(n_wins=n_wins, window=256, out_rows=512, t2=T2)
    if quant:
        qj, sj = WP.quantize_grad_pow2(jnp.asarray(da), 256)
        da_j, da_t = qj.T, torch.tensor(np.asarray(qj).T.copy())
        sc_j, sc_t = sj, torch.tensor(np.asarray(sj))
    else:
        da_j = jnp.asarray(da, jdt).T
        da_t = torch.tensor(da).to(tdt).t().contiguous()
        sc_j = sc_t = None
    dhj, dwj = WP.window_bwd_fused(
        da_j, _j(a["c_stream"]), *map(_j, gt), jnp.asarray(w, jdt),
        jnp.asarray(h, jdt), da_scales=sc_j, interpret=True, **kw)
    dht, dwt = W.window_bwd_fused(
        da_t, t["c_stream"], *(torch.as_tensor(x) for x in gt),
        torch.tensor(w).to(tdt), torch.tensor(h).to(tdt), da_scales=sc_t,
        **kw)
    assert dht.dtype == dwt.dtype == torch.float32
    if not bf16:
        np.testing.assert_allclose(dht.numpy(), np.asarray(dhj), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(dwt.numpy(), np.asarray(dwj), rtol=2e-4,
                                   atol=2e-4)
        return
    # bf16: a slab element Y may round to the neighbouring bf16 value, one
    # ulp of |Y| times the |W| or |h| it multiplies
    Y = W.window_bwd_fused_reference(
        da_t, t["c_stream"], *(torch.as_tensor(x) for x in gt),
        torch.ones(T2, D, D, dtype=tdt), torch.ones(N, D, dtype=tdt),
        da_scales=sc_t, **kw)
    tol_dh = BF16_ULP * Y[0].abs().numpy() + 1e-4
    tol_dw = BF16_ULP * Y[1].abs().numpy() + 1e-4
    assert (np.abs(dht.numpy() - np.asarray(dhj)) <= tol_dh).all()
    assert (np.abs(dwt.numpy() - np.asarray(dwj)) <= tol_dw).all()


# --- the fused step's VJP, propagate and make_train_step ---------------------

@pytest.mark.parametrize("min_edges,on_demand",
                         [(3, False), (150, False), (3, True), (150, True)])
def test_fused_gru_step_grads(min_edges, on_demand):
    """value_and_grad through the fused step (#13 with emit_res, #4 on its
    residuals, the window backward) against the unfused aggregate_window +
    gru_update step of the port, and against the JAX package's fused step,
    for h, msg_w, msg_b and every GRU weight."""
    N, E, T2, D = 512, 3000, 4, 128
    edges = _edges(4, N, E, T2)
    lay, ref_lay = _both(edges, N, window=256, min_edges_per_tile=min_edges,
                         spill_tile_e=8, n_message_types=T2, block_rows=256,
                         with_grad=True, row_major="block",
                         typed_spill=on_demand, on_demand=on_demand)
    prop = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), JaxConfig(state_dim=D, annotation_dim=2,
                                         n_edge_types=2)))["prop"]
    h = _rand(5, N, D)
    names = ["h", "msg_w", "msg_b"] + sorted(prop["gru"])

    def torch_grads(fused):
        x = {"h": h, "msg_w": prop["msg_w"], "msg_b": prop["msg_b"],
             **prop["gru"]}
        x = {k: torch.tensor(np.asarray(v), requires_grad=True)
             for k, v in x.items()}
        gru = {k: x[k] for k in prop["gru"]}
        if fused:
            out = WS.gru_window_step(x["h"], lay.to("cpu"), x["msg_w"],
                                     x["msg_b"], gru)
        else:
            a = WS.aggregate_window(x["h"], lay.to("cpu"), x["msg_w"],
                                    x["msg_b"])
            out = gru_update(gru, x["h"], a)
        loss = (out ** 2).sum()
        loss.backward()
        return loss.item(), [x[k].grad.numpy() for k in names]

    def loss_j(h, msg_w, msg_b, gru):
        return jnp.sum(WP.gru_window_step(h, ref_lay, msg_w, msg_b, gru,
                                          interpret=True) ** 2)

    vj, (gh, gw, gb, ggru) = jax.value_and_grad(loss_j, argnums=(0, 1, 2, 3))(
        jnp.asarray(h), prop["msg_w"], prop["msg_b"], prop["gru"])
    ref = [gh, gw, gb] + [ggru[k] for k in sorted(prop["gru"])]
    vf, gf = torch_grads(True)
    vu, gu = torch_grads(False)
    np.testing.assert_allclose(vf, vu, rtol=1e-5)
    np.testing.assert_allclose(vf, float(vj), rtol=1e-5)
    for name, f, u, j in zip(names, gf, gu, ref):
        np.testing.assert_allclose(f, u, rtol=2e-4, atol=2e-4, err_msg=name)
        np.testing.assert_allclose(f, np.asarray(j), rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_fused_step_refuses_what_the_reference_refuses():
    """Gradients of the fused step need N, D multiples of 128 (the
    reference's ValueError); the q8 step stays forward only; a layout
    without its grad half refuses the backward."""
    N, E, T2, D = 256, 600, 6, 32
    edges = _edges(0, N, E, T2)
    lay = W.build_window_layout(*edges, N, window=64, min_edges_per_tile=4,
                                spill_tile_e=8, n_message_types=T2,
                                with_grad=True)
    gru = {k: torch.tensor(v, requires_grad=True) for k, v in jax.tree.map(
        np.asarray, jax_init(jax.random.PRNGKey(0), JaxConfig(
            state_dim=D, annotation_dim=2, n_edge_types=3)))["prop"]["gru"]
        .items()}
    h = torch.tensor(_rand(1, N, D), requires_grad=True)
    w, b = torch.tensor(_rand(2, T2, D, D)), torch.tensor(_rand(3, T2, D))
    out = WS.gru_window_step(h, lay.to("cpu"), w, b, gru)
    with pytest.raises(ValueError, match="use the unfused path"):
        out.sum().backward()
    with pytest.raises(ValueError, match="serving mode"):
        WS.gru_window_step(h, lay.to("cpu"), w, b, gru, quantized=True)
    fwd = W.build_window_layout(*edges, N, window=64, min_edges_per_tile=4,
                                spill_tile_e=8, n_message_types=T2)
    a = WS.aggregate_window(h, fwd.to("cpu"), w, b)
    with pytest.raises(ValueError, match="with_grad=True"):
        a.sum().backward()


@pytest.mark.parametrize("fuse", [False, True])
def test_window_backend_train_step(fuse):
    """Gradients of Σ h² through propagate(backend='window') over 3 steps
    against the JAX package's (the reference's test at D = 8 unfused; the
    fused step at D = 128, which its VJP needs)."""
    D = 128 if fuse else 8
    N, E, T2 = 256, 500, 6
    edges = _edges(6, N, E, T2)
    lay, ref_lay = _both(edges, N, window=128 if fuse else 64,
                         min_edges_per_tile=4, spill_tile_e=8,
                         n_message_types=T2, row_major="block" if fuse
                         else "src", with_grad=True)
    mk = dict(state_dim=D, annotation_dim=2, n_edge_types=3, n_steps=3,
              backend="window", fuse_gru=fuse)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(4),
                                               JaxConfig(**mk)))["prop"]
    ann = (np.random.default_rng(1).random((N, 2)) < 0.5).astype(np.float32)

    def loss_j(p):
        h = jax_propagate(p, JaxConfig(**mk), jnp.asarray(ann),
                          *map(jnp.asarray, edges), scatter_layout=ref_lay)
        return jnp.sum(h * h)

    ref = jax.grad(loss_j)(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params)
    for p in param_leaves(tp):
        p.requires_grad_(True)
    h = propagate(tp, ModelConfig(**mk), torch.tensor(ann),
                  *map(torch.tensor, edges), scatter_layout=lay)
    (h * h).sum().backward()
    for p, r in zip(param_leaves(tp), param_leaves(params_from_numpy(
            jax.tree.map(np.asarray, ref)))):
        np.testing.assert_allclose(p.grad.numpy(), r.numpy(), rtol=3e-4,
                                   atol=3e-5)


def test_make_train_step_window_matches_jax():
    """One make_train_step (node_select loss, Adam) on a window layout,
    fused, f32, D = 128, against the JAX package's train step with
    optax.adam: the loss and every parameter after the step."""
    N, E, T = 256, 2000, 2
    r = np.random.default_rng(0)
    edges = _community(7, N, E, 2 * T)
    lay, ref_lay = _both(edges, N, window=256, min_edges_per_tile=4,
                         n_message_types=2 * T, row_major="block",
                         with_grad=True, typed_spill=True, on_demand=True,
                         spill_tile_e=16)
    kw = dict(state_dim=128, annotation_dim=4, n_edge_types=T, n_steps=2,
              head="node_select", backend="window", fuse_gru=True)
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(1),
                                               JaxConfig(**kw)))
    arrays = dict(
        annotations=(r.random((N, 4)) < 0.3).astype(np.float32),
        node_graph=np.zeros(N, np.int32), node_mask=np.ones(N, np.float32),
        n_nodes=np.array([N], np.int32), edge_src=edges[0],
        edge_dst=edges[1], edge_type=edges[2], edge_mask=edges[3],
        targets={"node": np.array([7], np.int32)})
    opt = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, params)

    def loss_fn(p):
        return jax_loss(p, JaxConfig(**kw), jax.tree.map(jnp.asarray, arrays),
                        1, scatter_layout=ref_lay)

    (jl, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    upd, _ = opt.update(grads, opt.init(jp), jp)
    jp = optax.apply_updates(jp, upd)
    tp = params_from_numpy(params)
    for p in param_leaves(tp):
        p.requires_grad_(True)
    step = make_train_step(ModelConfig(**kw), 1, make_optimizer(tp, 1e-3))
    tarr = jax.tree.map(torch.as_tensor, arrays)
    m = step(tp, tarr, lay)
    np.testing.assert_allclose(float(m["loss_sum"]), float(jl), rtol=1e-5)
    # the gradients to f32 summation order; the parameters to rtol 1e-5,
    # except where a gradient entry is below 1e-4 of its leaf's largest:
    # Adam's first step is lr·g/(|g| + ε), so such an entry's step follows
    # the last bits of a tiny g (both steps still at most lr)
    start = dict(_flatten(params_from_numpy(params)))
    jg = dict(_flatten(params_from_numpy(jax.tree.map(np.asarray, grads))))
    norm = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jg.values()))
    for (k, p), (_, r_) in zip(_flatten(tp), _flatten(params_from_numpy(
            jax.tree.map(np.asarray, jp)))):
        g = jg[k].numpy()
        scale = np.abs(g).max()
        # (head/b2's gradient vanishes by symmetry: 0 up to 1e-6 of the norm)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * scale + 1e-6 * norm, err_msg=k)
        big = np.abs(g) > max(1e-4 * scale, 1e-6 * norm)
        np.testing.assert_allclose(p.detach().numpy()[big], r_.numpy()[big],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        for x in (p.detach().numpy(), r_.numpy()):
            assert np.abs(x - start[k].numpy()).max() <= 1e-3 * (1 + 1e-5)


# --- the kernels' widths: padding to the D = 128 kernels --------------------

@pytest.mark.parametrize("D", [8, 200])
def test_pad_width_is_exact(D):
    """pad_width / narrow_width around #3, #4 and #13's plain versions
    give the unpadded plain versions' values bit for bit (what the card
    wrappers do at D = 8, padded to the D = 128 kernels, and at D = 200,
    padded to the 256-wide ones, with the kernel in place of the plain
    version)."""
    P = lambda x, **kw: G.pad_width(x, D, **kw)
    N = 256
    h = torch.tensor(np.random.default_rng(0).random((N, D)) * 2 - 1,
                     dtype=torch.float32)
    a, g = torch.tensor(_rand(1, N, D)), torch.tensor(_rand(2, N, D))
    wa = torch.tensor(_rand(3, D, 3 * D, scale=D ** -0.5))
    b3 = torch.tensor(_rand(4, 3 * D, scale=0.1))
    uzr = torch.tensor(_rand(5, D, 2 * D, scale=D ** -0.5))
    uh = torch.tensor(_rand(6, D, D, scale=D ** -0.5))
    for mdt in (torch.bfloat16, torch.float32):
        ref = G.gru_cell_fwd_reference(h, a, wa, b3, uzr, uh, mdt)
        got = G.gru_cell_fwd_reference(
            P(h), P(a), P(wa, rows=True, groups=3), P(b3, groups=3),
            P(uzr, rows=True, groups=2), P(uh, rows=True), mdt)
        for x, y in zip(got, ref):
            assert torch.equal(x[:, :D], y)
        res = (h.to(mdt), a.to(mdt), *ref[1:])
        ref_b = G.gru_cell_bwd_reference(g, *res, wa, uzr, uh, mdt)
        got_b = G.gru_cell_bwd_reference(
            P(g), *map(P, res), P(wa, rows=True, groups=3),
            P(uzr, rows=True, groups=2), P(uh, rows=True), mdt)
        cut = (lambda x: x[:, :D], lambda x: x[:, :D],
               lambda x: G.narrow_width(x, D, rows=True, groups=3),
               lambda x: G.narrow_width(x, D, groups=3),
               lambda x: G.narrow_width(x, D, rows=True, groups=2),
               lambda x: G.narrow_width(x, D, rows=True))
        for c, x, y in zip(cut, got_b, ref_b):
            assert torch.equal(c(x), y)
    # #13 (bf16 table, with emit_res)
    lay = _kernel_layout(128, 128, T2=4, N=512)
    t = lay.to("cpu").arrays
    w = torch.tensor(_rand(7, 4, D, D, scale=D ** -0.5)).bfloat16()
    bb = torch.tensor(_rand(8, 4, D, scale=0.1)).bfloat16()
    from ggnn_tpu_torch.ops import table as TB
    hb = torch.tensor(_rand(9, 512, D)).bfloat16()
    init = torch.tensor(_rand(10, 512, D))
    hs = torch.tensor(_rand(11, 512, D))
    args = lambda tab, ini, hh, ww: (
        tab, t["c_stream"], t["tile_start"], t["block_of_tile"],
        t["win_of_tile"], ini, hh, *ww)
    ws_ = (wa.bfloat16(), b3[None], uzr.bfloat16(), uh.bfloat16())
    ws_p = (P(wa, rows=True, groups=3).bfloat16(), P(b3[None], groups=3),
            P(uzr, rows=True, groups=2).bfloat16(), P(uh, rows=True)
            .bfloat16())
    kw = dict(n_blocks=lay.n_blocks, window=128, emit_res=True,
              c_off=t["c_off"])
    ref = W.window_step_gru(*args(TB.node_table(hb, w, bb, "block"), init,
                                  hs, ws_), **kw)
    got = W.window_step_gru(*args(TB.node_table(P(hb), P(w, rows=True),
                                                P(bb), "block"),
                                  P(init), P(hs), ws_p), **kw)
    assert torch.equal(got[0][:, :D], ref[0])
    assert torch.equal(G.narrow_width(got[1], D, groups=4), ref[1])


@pytest.mark.cuda
def test_predictor_backends_agree_on_card():
    """The reference's test_predictor_backends_agree on the card: the
    window Predictor fused (#13 at D = 8, padded to the D = 128 kernel)
    and unfused, and onehot, give the xla Predictor's predictions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from ggnn_tpu_torch.graph import PaddingSpec
    from ggnn_tpu_torch.infer import Predictor
    rng = np.random.default_rng(0)
    gs = []
    for _ in range(7):
        n = int(rng.integers(5, 12))
        m = int(rng.integers(4, 2 * n))
        gs.append(dict(n_nodes=n, edges=np.stack(
            [rng.integers(0, n, m), rng.integers(0, 3, m),
             rng.integers(0, n, m)], axis=1),
            annotations=(rng.random((n, 2)) < 0.5).astype(np.float32),
            targets={}))
    spec = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                       annotation_dim=2).round_up()
    params = jax.tree.map(np.asarray, jax_init(
        jax.random.PRNGKey(0), JaxConfig(state_dim=8, annotation_dim=2,
                                         n_edge_types=3, n_steps=3,
                                         head="node_select")))
    preds = {}
    for name, backend, fuse in (("xla", "xla", False),
                                ("onehot", "onehot", False),
                                ("window", "window", False),
                                ("window_fused", "window", True)):
        cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                          n_steps=3, head="node_select", backend=backend,
                          fuse_gru=fuse)
        preds[name] = Predictor(cfg, spec, params=params,
                                device="cuda").predict(gs)
    assert preds["onehot"] == preds["xla"]
    assert preds["window"] == preds["xla"]
    assert preds["window_fused"] == preds["xla"]

