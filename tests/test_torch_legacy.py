"""The port's legacy table-gather onehot path against the JAX package: the
device form of the legacy layout, ``layout_for_batch`` and the chunked
layouts (array for array), the table kernel (``node_table_block_major``),
the two one-hot scatters (``onehot_segment_scatter_flat``,
``onehot_segment_scatter``), ``aggregate_onehot`` on legacy layouts with its
custom backward, ``aggregate_onehot_chunked``, and ``propagate`` with a
chunked list, with its default layout and with a fuse request on a legacy
layout.  The same seeded numpy inputs go to both; the JAX kernels run in
Pallas interpret mode, the port's wrappers their plain versions (CPU
tensors).  Tolerances:

- layouts: exact, array for array, dtype for dtype, and ``meta``;
- the scatters: f32 rtol = atol = 2e-5 (the same f32 sums in another
  order); a bf16 message pack is exact in f32, so the same;
- the table: f32 rtol = atol = 2e-5; bf16 one ulp, 2**-7 of the value's
  magnitude (the same bf16 products summed in f32 in another order can
  round the other way);
- aggregation, its VJP and propagate: f32 rtol = atol = 2e-5; bf16
  2**-7 of the largest magnitude (one table row or one flushed Y row that
  rounds the other way);
- the per-edge oracle: every real edge added once, and padding adds exactly
  0 (poisoned rows leave the output bit-identical).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.ops import legacy as L
from ggnn_tpu_torch.ops import scatter as S
from ggnn_tpu_torch.ops import table as TB

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _graph(seed, N, E, T2, dst_hi=None):
    r = np.random.default_rng(seed)
    return (r.integers(0, N, E).astype(np.int32),
            r.integers(0, dst_hi or N, E).astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.9).astype(np.float32))


def _assert_device_layouts_equal(got, ref):
    assert got.meta == tuple(ref.meta), (got.meta, ref.meta)
    assert sorted(got.arrays) == sorted(ref.arrays)
    for k, v in ref.arrays.items():
        v = np.asarray(v)
        a = got.arrays[k].numpy()
        assert a.dtype == v.dtype, k
        np.testing.assert_array_equal(a, v, err_msg=k)


def _graphs(seed, k, n_lo, n_hi, T):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(r.integers(n_lo, n_hi))
        m = int(r.integers(n, 3 * n))
        out.append(dict(n_nodes=n, edges=np.stack(
            [r.integers(0, n, m), r.integers(0, T, m), r.integers(0, n, m)],
            axis=1), annotations=(r.random((n, 2)) < 0.5).astype(np.float32)))
    return out


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("n_pad", [256, 200])
def test_layout_for_batch_matches_reference(n_pad, with_grad):
    """The static-budget layout of a batch, array for array with the
    reference's ``to_device()`` form, with and without its grad half, with
    n_pad % 128 == 0 (block-major rows) and != 0 (type order)."""
    kw = dict(n_graphs=4, n_pad=n_pad, e_pad=800, n_edge_types=3,
              annotation_dim=2)
    graphs = _graphs(0, 4, 20, 40, 3)
    ref = SP.layout_for_batch(jax_batch_graphs(graphs, JaxSpec(**kw)),
                              with_grad=with_grad)
    got = L.layout_for_batch(batch_graphs(graphs, PaddingSpec(**kw)),
                             with_grad=with_grad, device="cpu")
    assert got.meta[7] == ("block" if n_pad % 128 == 0 else "type")
    _assert_device_layouts_equal(got, ref)


DEVICE_OPTIONS = {
    "no_stream": dict(onehot_stream=False, with_grad=True),
    "edge_align": dict(edge_align=16, with_grad=True, n_message_types=4),
    "dstl_stream": dict(edge_align=16, dstl_stream=True, with_grad=True),
    "tile_e_2048": dict(tile_e=2048),
}


@pytest.mark.parametrize("opts", sorted(DEVICE_OPTIONS))
def test_device_form_matches_reference(opts):
    """DstBlockLayout.to against the reference's to_device for the stream
    options the batch layouts do not reach."""
    edges = _graph(1, 640, 3000, 4)
    ref = SP.build_dst_block_layout(*edges, 640, **DEVICE_OPTIONS[opts])
    got = L.build_dst_block_layout(*edges, 640, **DEVICE_OPTIONS[opts])
    _assert_device_layouts_equal(got.to("cpu"), ref.to_device())


@pytest.mark.parametrize("stream", [True, False])
def test_chunked_layouts_match_reference(stream):
    edges = _graph(2, 1024, 5000, 4)
    ref = SP.build_chunked_dst_layouts(*edges, 1024, n_chunks=4, tile_e=256,
                                       onehot_stream=stream)
    got = L.build_chunked_dst_layouts(*edges, 1024, n_chunks=4, tile_e=256,
                                      onehot_stream=stream, device="cpu")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _assert_device_layouts_equal(g, r)


# --- the kernels' plain versions against the JAX kernels --------------------

def _scatter_case(tile_e, seed=3):
    """A layout over 512 dst rows whose upper half is empty (blocks with
    only an all-padding tile), padded with extra all-padding tiles."""
    N, E = 512, 1500
    edges = _graph(seed, N, E, 3, dst_hi=N // 2)
    lay = L.build_dst_block_layout(
        *edges, N, tile_e=tile_e,
        pad_tiles_to=L.static_tile_budget(E, N, tile_e) + 2)
    return lay, lay.to("cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tile_e", [8, 128, 2048])
def test_onehot_scatters_match_jax(tile_e, dtype):
    """#8 (the int8 one-hot stream) and #9 (dst-local ids) against the JAX
    kernels on one message pack, at tile_e 8, 128 and 2048, with empty
    blocks and all-padding tiles."""
    jdt, tdt = DTYPES[dtype]
    host, lay = _scatter_case(tile_e)
    a = lay.arrays
    msgs = np.random.default_rng(4).standard_normal(
        (host.gather_idx.shape[0], 4)).astype(np.float32)
    tm = torch.tensor(msgs).to(tdt)
    ref = SP.onehot_segment_scatter_flat(
        jnp.asarray(msgs, jdt), jnp.asarray(host.onehot),
        jnp.asarray(host.tile_start), jnp.asarray(host.block_of_tile),
        n_blocks=host.n_blocks, tile_e=tile_e, interpret=True)
    got = L.onehot_segment_scatter_flat(tm, a["onehot"], a["tile_start"],
                                        a["block_of_tile"], host.n_blocks,
                                        tile_e)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    ref = SP.onehot_segment_scatter(
        jnp.asarray(msgs, jdt), jnp.asarray(host.dst_local),
        jnp.asarray(host.tile_start), n_blocks=host.n_blocks,
        max_tiles=host.max_tiles, tile_e=tile_e, interpret=True)
    got = L.onehot_segment_scatter(tm, a["dst_local"], a["tile_start"],
                                   host.n_blocks, host.max_tiles, tile_e)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("tile_e", [8, 128, 2048])
def test_onehot_scatters_match_per_edge_oracle(tile_e):
    """Both scatters against an independent per-edge numpy sum (every real
    edge once), and padding slots, empty blocks and all-padding tiles add
    exactly 0: poisoning every message row no real edge reads leaves the
    output bit-identical, and the empty blocks are exactly 0."""
    host, lay = _scatter_case(tile_e, seed=5)
    a = lay.arrays
    msgs = np.random.default_rng(6).standard_normal(
        (host.gather_idx.shape[0], 4)).astype(np.float32)
    real = host.dst_local >= 0
    want = np.zeros((host.n_blocks * 128, 4), np.float64)
    e = np.flatnonzero(real)
    np.add.at(want, host.block_of_tile[e // tile_e] * 128 + host.dst_local[e],
              msgs[e].astype(np.float64))
    poisoned = torch.tensor(np.where(real[:, None], msgs, 1e30).astype(
        np.float32))
    tm = torch.tensor(msgs)
    outs = {
        "flat": lambda m: L.onehot_segment_scatter_flat(
            m, a["onehot"], a["tile_start"], a["block_of_tile"],
            host.n_blocks, tile_e),
        "dstl": lambda m: L.onehot_segment_scatter(
            m, a["dst_local"], a["tile_start"], host.n_blocks,
            host.max_tiles, tile_e)}
    empty = np.bincount(host.dst_global[real] // 128,
                        minlength=host.n_blocks) == 0
    padding_tiles = (host.dst_local.reshape(-1, tile_e) < 0).all(1)
    assert empty.any() and padding_tiles.sum() > empty.sum()
    for name, fn in outs.items():
        got = fn(tm)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5,
                                   err_msg=name)
        np.testing.assert_array_equal(fn(poisoned).numpy(), got.numpy(),
                                      err_msg=name)
        assert (got.reshape(-1, 128, 4)[torch.tensor(empty)] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [4, 128])
def test_node_table_matches_jax(D, dtype):
    """#10 against the JAX kernel, and node_table's 'type' and 'src' orders
    against the reference's _node_table."""
    jdt, tdt = DTYPES[dtype]
    r = np.random.default_rng(7)
    N, T2 = 256, 4
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    jx = [jnp.asarray(x, jdt) for x in (h, w, b)]
    tx = [torch.tensor(x).to(tdt) for x in (h, w, b)]
    for order in ("block", "type", "src"):
        ref = np.asarray(WP._node_table(*jx, order, True), np.float32)
        got = TB.node_table(*tx, order)
        assert got.dtype == tdt and got.shape == (N * T2, D)
        tol = (BF16_ULP * np.abs(ref) + 2e-5 if dtype == "bfloat16"
               else 2e-5 + 2e-5 * np.abs(ref))
        assert (np.abs(got.float().numpy() - ref) <= tol).all(), order


def test_kernel_wrappers_refuse_mismatched_arguments():
    """Another layout's arrays, a pack shorter than its tiles, a
    block_of_tile that disagrees with tile_start, or weights of another
    width are refused before any kernel could read out of bounds."""
    host, lay = _scatter_case(128)
    _, other = _scatter_case(8)
    a, o = lay.arrays, other.arrays
    msgs = torch.zeros(host.gather_idx.shape[0], 4)
    nb = host.n_blocks
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        L.onehot_segment_scatter_flat(msgs, o["onehot"], a["tile_start"],
                                      a["block_of_tile"], nb, 128)
    with pytest.raises(ValueError, match="not gathered with this layout"):
        L.onehot_segment_scatter_flat(msgs[:200], a["onehot"],
                                      a["tile_start"], a["block_of_tile"],
                                      nb, 128)
    shifted = a["block_of_tile"].roll(1)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        L.onehot_segment_scatter_flat(msgs, a["onehot"], a["tile_start"],
                                      shifted, nb, 128)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        L.onehot_segment_scatter(msgs, o["dst_local"], a["tile_start"], nb,
                                 host.max_tiles, 128)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        L.onehot_segment_scatter(msgs, a["dst_local"], a["tile_start"], nb,
                                 1, 128)
    with pytest.raises(ValueError, match="int32"):
        L.onehot_segment_scatter_flat(msgs, a["onehot"], a["tile_start"].long(),
                                      a["block_of_tile"], nb, 128)
    h, w, b = torch.zeros(256, 8), torch.zeros(4, 8, 8), torch.zeros(4, 8)
    with pytest.raises(ValueError, match="do not belong"):
        TB.node_table_block_major(h, w[:, :4], b)
    with pytest.raises(ValueError, match="does not belong"):
        TB.node_table_block_major(h, w, b[:2])
    with pytest.raises(ValueError, match="N % 128"):
        TB.node_table_block_major(h[:200], w, b)


# --- aggregation and its backward -------------------------------------------

AGG_CASES = {
    # name: build_dst_block_layout options (N = 256, T2 = 4)
    "type": {},
    "block": dict(row_order="block", n_message_types=4),
    "no_stream": dict(onehot_stream=False),
    "edge_align": dict(edge_align=16, row_order="block", n_message_types=4),
    "dstl_stream": dict(edge_align=16, dstl_stream=True),
}


def _agg_inputs(D, seed=8):
    r = np.random.default_rng(seed)
    N, T2 = 256, 4
    return (r.standard_normal((N, D)).astype(np.float32),
            (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32),
            (r.standard_normal((T2, D)) * 0.1).astype(np.float32),
            r.standard_normal((N, D)).astype(np.float32))


def _agg_check(opts, with_grad, dtype, D):
    jdt, tdt = DTYPES[dtype]
    edges = _graph(9, 256, 2000, 4)
    lay_j = SP.build_dst_block_layout(*edges, 256, with_grad=with_grad,
                                      **opts).to_device()
    lay_t = L.build_dst_block_layout(*edges, 256, with_grad=with_grad,
                                     **opts).to("cpu")
    h, w, b, da = _agg_inputs(D)
    fj = lambda h, w, b: SP.aggregate_onehot(h, lay_j, w, b, interpret=True)
    ref, vjp = jax.vjp(fj, *(jnp.asarray(x, jdt) for x in (h, w, b)))
    refs = [ref, *vjp(jnp.asarray(da))]
    xs = [torch.tensor(x).to(tdt).requires_grad_(True) for x in (h, w, b)]
    got = S.aggregate_onehot(xs[0], lay_t, *xs[1:])
    gots = [got, *torch.autograd.grad((got * torch.tensor(da)).sum(), xs)]
    for name, g, rf in zip(("a", "dh", "dW", "db"), gots, refs):
        rf = np.asarray(rf, np.float32)
        assert g.shape == rf.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(g.detach().numpy(), rf, rtol=2e-5,
                                       atol=2e-5, err_msg=name)
        else:
            d = np.abs(g.detach().float().numpy() - rf).max()
            assert d <= BF16_ULP * np.abs(rf).max(), (name, d)


@pytest.mark.parametrize("with_grad", [False, True])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_legacy_aggregate_matches_jax(case, with_grad):
    """aggregate_onehot on a legacy layout, value and VJP (dh, dW, db),
    against the JAX package's, f32 at D = 4: type and block order, the
    one-hot stream, dst-local ids, a 16-aligned pack with either stream;
    with the grad half (its reverse scatter kernels) and without (the
    segment sum over dst_global)."""
    _agg_check(AGG_CASES[case], with_grad, "float32", 4)


@pytest.mark.parametrize("case,with_grad", [("block", True), ("type", False),
                                            ("no_stream", True)])
def test_legacy_aggregate_matches_jax_bf16(case, with_grad):
    """The same in bf16 at D = 128, the kernels' headline width."""
    _agg_check(AGG_CASES[case], with_grad, "bfloat16", 128)


@pytest.mark.parametrize("stream", [True, False])
def test_aggregate_onehot_chunked_matches_jax(stream):
    """The chunked forward against the JAX package's (f32, D = 4); it
    refuses a request for gradients, as the reference cannot give them."""
    edges = _graph(10, 512, 3000, 4)
    h, w, b, _ = _agg_inputs(4)
    h = np.concatenate([h, h])
    kw = dict(n_chunks=2, tile_e=256, onehot_stream=stream)
    lay_j = SP.build_chunked_dst_layouts(*edges, 512, **kw)
    lay_t = L.build_chunked_dst_layouts(*edges, 512, device="cpu", **kw)
    ref = SP.aggregate_onehot_chunked(jnp.asarray(h), lay_j, jnp.asarray(w),
                                      jnp.asarray(b), interpret=True)
    got = L.aggregate_onehot_chunked(torch.tensor(h), lay_t, torch.tensor(w),
                                     torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(ValueError, match="forward only"):
        L.aggregate_onehot_chunked(torch.tensor(h), lay_t,
                                   torch.tensor(w, requires_grad=True),
                                   torch.tensor(b))


# --- propagate ---------------------------------------------------------------

def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed),
                                             JaxConfig(**cfg_kw)))


def _propagate_both(N, kw, layouts, warn=False):
    params = _np_params(kw)
    edges = _graph(11, N, 2500, 2 * kw["n_edge_types"])
    ann = (np.random.default_rng(12).random((N, 4)) < 0.4).astype(np.float32)
    lay_j, lay_t = layouts(edges)
    with _warns(warn):
        _, ref = jax_propagate(params["prop"], JaxConfig(**kw),
                               jnp.asarray(ann), *map(jnp.asarray, edges),
                               collect_states=True, scatter_layout=lay_j)
    with _warns(warn):
        with torch.no_grad():
            _, got = propagate(params_from_numpy(params["prop"]),
                               ModelConfig(**kw), torch.tensor(ann),
                               *map(torch.tensor, edges), collect_states=True,
                               scatter_layout=lay_t)
    return got.numpy(), np.asarray(ref)


def _warns(warn):
    return (pytest.warns(UserWarning, match="UNFUSED") if warn
            else contextlib.nullcontext())


def _states_close(got, ref, cdt):
    if cdt == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        assert np.abs(got - ref).max() <= BF16_ULP * max(1.0, np.abs(
            ref).max())


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_propagate_chunked_matches_jax(cdt):
    """Per-step states through a list of chunked layouts (the 1M-node
    path at a small size); fuse_gru is ignored there, as the reference."""
    kw = dict(state_dim=8, annotation_dim=4, n_edge_types=2, n_steps=2,
              backend="onehot", compute_dtype=cdt, fuse_gru=True)
    ck = dict(n_chunks=2, tile_e=2048)
    got, ref = _propagate_both(512, kw, lambda e: (
        SP.build_chunked_dst_layouts(*e, 512, **ck),
        L.build_chunked_dst_layouts(*e, 512, device="cpu", **ck)))
    _states_close(got, ref, cdt)


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_propagate_default_layout_matches_jax(cdt):
    """scatter_layout=None builds the reference's default (the legacy
    layout over h's rows, type order, no grad half) in both packages; h's
    rows must be a multiple of 128 in both."""
    kw = dict(state_dim=8, annotation_dim=4, n_edge_types=2, n_steps=2,
              backend="onehot", compute_dtype=cdt)
    got, ref = _propagate_both(256, kw, lambda e: (None, None))
    _states_close(got, ref, cdt)
    params = _np_params(kw)
    edges = _graph(11, 200, 500, 4)
    with pytest.raises(ValueError, match="multiple of 128"):
        propagate(params_from_numpy(params["prop"]), ModelConfig(**kw),
                  torch.zeros(200, 4), *map(torch.tensor, edges))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_propagate_fuse_on_legacy_layout_warns_and_matches_jax(cdt):
    """fuse_gru with a legacy layout warns and runs the unfused step, in
    both packages, at D = 128 with the block-major table (#10)."""
    kw = dict(state_dim=128, annotation_dim=4, n_edge_types=2, n_steps=2,
              backend="onehot", compute_dtype=cdt, fuse_gru=True)
    opts = dict(row_order="block", n_message_types=4, with_grad=True)
    got, ref = _propagate_both(256, kw, lambda e: (
        SP.build_dst_block_layout(*e, 256, **opts).to_device(),
        L.build_dst_block_layout(*e, 256, **opts)), warn=True)
    _states_close(got, ref, cdt)


def test_legacy_train_grads_match_jax():
    """Gradients of Σ h_T ⊙ w through propagate on layout_for_batch's
    layout (the onehot Trainer's path: #10, #8 forward, #11 backward on the
    16-aligned grad pack), bf16 at D = 128, against jax.grad: relative
    Frobenius error per leaf ≤ 2**-8, the training tests' bound."""
    kw = dict(state_dim=128, annotation_dim=2, n_edge_types=3, n_steps=2,
              backend="onehot", compute_dtype="bfloat16")
    spec = dict(n_graphs=4, n_pad=256, e_pad=1600, n_edge_types=3,
                annotation_dim=2)
    graphs = _graphs(13, 4, 40, 64, 3)
    bj = jax_batch_graphs(graphs, JaxSpec(**spec))
    bt = batch_graphs(graphs, PaddingSpec(**spec))
    lay_j = SP.layout_for_batch(bj, with_grad=True)
    lay_t = L.layout_for_batch(bt, with_grad=True, device="cpu")
    params = _np_params(kw)
    w = np.random.default_rng(14).standard_normal((256, 128)).astype(
        np.float32)
    edges = [bj.edge_src, bj.edge_dst, bj.edge_type, bj.edge_mask]

    def jloss(prop):
        h = jax_propagate(prop, JaxConfig(**kw), jnp.asarray(bj.annotations),
                          *map(jnp.asarray, edges), scatter_layout=lay_j)
        return jnp.sum(h * w)
    ref = jax.tree.map(np.asarray, jax.grad(jloss)(
        jax.tree.map(jnp.asarray, params["prop"])))
    prop = params_from_numpy(params["prop"])
    leaves = []

    def walk(t, r, key=""):
        for k in t:
            if isinstance(t[k], dict):
                walk(t[k], r[k], f"{key}{k}/")
            else:
                t[k].requires_grad_(True)
                leaves.append((f"{key}{k}", t[k], r[k]))
    walk(prop, ref)
    h = propagate(prop, ModelConfig(**kw), torch.tensor(bt.annotations),
                  *map(torch.tensor, edges), scatter_layout=lay_t)
    (h * torch.tensor(w)).sum().backward()
    for key, p, r in leaves:
        err = np.linalg.norm(p.grad.numpy() - r) / max(np.linalg.norm(r),
                                                       1e-30)
        assert err <= 2.0 ** -8, (key, err)


def test_legacy_layout_is_not_a_typed_pack():
    """The typed-pack helpers refuse a legacy layout by name instead of
    reading arrays it does not have."""
    lay = L.build_dst_block_layout(*_graph(15, 256, 500, 4), 256).to("cpu")
    assert not lay.typed and lay.block_meta is None
    with pytest.raises(ValueError, match="legacy table-gather layout"):
        S.tile_args(lay)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 128, 200])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_legacy_kernels_match_reference_on_card(dtype, D):
    """#8, #9 and #10 against their plain versions on the card, on a
    layout with empty blocks and all-padding tiles, with the criteria of
    chip_smoke.py: the scatters within 2e-5 of Σ|terms| per element, the
    table within 1e-5 of Σ|terms| plus (bf16) one ulp of the value; each
    scatter bit-equal to a second run."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    r = np.random.default_rng(16)
    N, T2 = 512, 4
    h = torch.tensor(r.uniform(-1, 1, (N, D)).astype(np.float32),
                     device=dev).to(tdt)
    w = torch.tensor((r.standard_normal((T2, D, D)) * D ** -0.5).astype(
        np.float32), device=dev).to(tdt)
    b = torch.tensor((r.standard_normal((T2, D)) * 0.1).astype(np.float32),
                     device=dev).to(tdt)
    tab = TB.node_table_block_major(h, w, b)
    ref = TB.node_table_block_major_reference(h, w, b).float()
    bound = 1e-5 * TB.node_table_block_major_reference(
        h.float().abs(), w.float().abs(), b.float().abs())
    if tdt == torch.bfloat16:
        bound = bound + BF16_ULP * ref.abs()
    assert ((tab.float() - ref).abs() <= bound).all()
    for tile_e in (128, 2048):
        host = L.build_dst_block_layout(
            *_graph(17, N, 3000, T2, dst_hi=N // 2), N, tile_e=tile_e,
            n_message_types=T2, row_order="block",
            pad_tiles_to=L.static_tile_budget(3000, N, tile_e) + 2)
        a = host.to(dev).arrays
        msgs = tab.index_select(0, a["gather_idx"])
        for kern, plain, args in (
                (L.onehot_segment_scatter_flat,
                 L.onehot_segment_scatter_flat_reference,
                 (a["onehot"], a["tile_start"], a["block_of_tile"],
                  host.n_blocks, tile_e)),
                (L.onehot_segment_scatter, L.onehot_segment_scatter_reference,
                 (a["dst_local"], a["tile_start"], host.n_blocks,
                  host.max_tiles, tile_e))):
            got = kern(msgs, *args)
            assert torch.equal(got, kern(msgs, *args))
            bound = 2e-5 * plain(msgs.abs(), *args)
            assert ((got - plain(msgs, *args)).abs() <= bound).all()
