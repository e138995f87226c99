"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper (``typed_block_scatter``, ``typed_block_step_gru``,
``gru_cell_fwd``) runs its plain version; the JAX kernels run in Pallas
interpret mode, as the JAX package's own tests run them.  The same seeded
numpy inputs go to both.  Tolerances:

- f32: rtol = atol = 1e-5 — the same math, sums taken in another order;
- bf16 inputs (f32 outputs of the scatter): rtol = 1e-5, atol = 1e-4 —
  the one-hot sums are rounded to bf16 at the same points in both, so only
  the f32 order of the W_t products differs;
- bf16 GRU residuals (z, r, h̃ stored in bf16) and GRU outputs computed
  from bf16-rounded matmul inputs: atol = 2**-7, one bf16 ulp at 1.0, for a
  value that lands on the other side of a rounding boundary.

The kernels themselves run only on the card: ``test_*_on_card`` are marked
``cuda`` and skip without a GPU; their criteria are stated there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import gru_pallas as GP
from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import scatter as S

torch.set_num_threads(1)

D = 128
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-5, 1e-4)}
BF16_ULP = 2.0 ** -7


def _graph(seed, N, E, T2, dst_hi=None):
    r = np.random.default_rng(seed)
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, dst_hi or N, E).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = (r.random(E) < 0.9).astype(np.float32)
    return src, dst, typ, mask


def _inputs(seed, N, T2, n_rows):
    r = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (r.standard_normal(s) * scale).astype(
        np.float32)
    return dict(h=f(N, D), w=f(T2, D, D, scale=0.2), b=f(T2, D, scale=0.1),
                init=f(n_rows, D, scale=0.1),
                hstate=(r.random((n_rows, D)) - 0.5).astype(np.float32),
                wa=f(D, 3 * D, scale=0.08), uzr=f(D, 2 * D, scale=0.08),
                uh=f(D, D, scale=0.08), b3=f(1, 3 * D, scale=0.1),
                a=f(n_rows, D))


def _layouts(seed=7, N=640, E=9000, T2=6, **gkw):
    edges = _graph(seed, N, E, T2, **gkw)
    lay_j = SP.build_typed_dst_layout(*edges, N, T2)
    lay_t = S.build_typed_dst_layout(*edges, N, T2)
    assert lay_t.block_meta is not None
    return lay_j, lay_t.to("cpu"), edges


def _block_kw(lay_t):
    kw = S.block_args(lay_t)
    arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
    return arrs, kw


def _jax_block_args(lay_j, h, jdt):
    arrs = lay_j.arrays
    S8, cmax, span = lay_j.meta[10]
    h_pack = jnp.asarray(h, jdt)[arrs["gather_idx"]]
    return ((h_pack, arrs["dstl_blk"], arrs["slot_off16"], arrs["blk_off16"]),
            dict(n_blocks=lay_j.meta[3], tile_e=lay_j.meta[1], S8=S8,
                 cmax=cmax, span_rows=span, interpret=True))


def _torch_h_pack(lay_t, h, tdt):
    return torch.tensor(h).to(tdt).index_select(0,
                                                lay_t.arrays["gather_idx"])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_typed_block_scatter_matches_jax(dtype):
    jdt, tdt, rtol, atol = DTYPES[dtype]
    lay_j, lay_t, _ = _layouts()
    x = _inputs(0, 640, 6, lay_t.n_blocks * 128)
    jargs, jkw = _jax_block_args(lay_j, x["h"], jdt)
    ref = SP.typed_block_scatter(*jargs, jnp.asarray(x["w"], jdt), **jkw)
    arrs, kw = _block_kw(lay_t)
    got = S.typed_block_scatter(_torch_h_pack(lay_t, x["h"], tdt), *arrs,
                                torch.tensor(x["w"]).to(tdt), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_typed_block_step_gru_matches_jax(dtype):
    jdt, tdt, rtol, atol = DTYPES[dtype]
    lay_j, lay_t, _ = _layouts()
    x = _inputs(1, 640, 6, lay_t.n_blocks * 128)
    jargs, jkw = _jax_block_args(lay_j, x["h"], jdt)
    j = lambda k, dt=jdt: jnp.asarray(x[k], dt)
    ref = SP.typed_block_step_gru(
        *jargs, j("w"), j("init", jnp.float32), j("hstate", jnp.float32),
        j("wa"), j("b3", jnp.float32), j("uzr"), j("uh"), **jkw)
    arrs, kw = _block_kw(lay_t)
    t = lambda k, dt=tdt: torch.tensor(x[k]).to(dt)
    got = S.typed_block_step_gru(
        _torch_h_pack(lay_t, x["h"], tdt), *arrs, t("w"),
        t("init", torch.float32), t("hstate", torch.float32), t("wa"),
        t("b3", torch.float32), t("uzr"), t("uh"), **kw)
    tol = BF16_ULP if dtype == "bfloat16" else atol
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gru_cell_fwd_matches_jax(dtype):
    jdt, tdt, rtol, atol = DTYPES[dtype]
    x = _inputs(2, 8, 2, 256)
    ref = GP.gru_cell_fwd(
        jnp.asarray(x["hstate"]), jnp.asarray(x["a"]), jnp.asarray(x["wa"]),
        jnp.asarray(x["b3"][0]), jnp.asarray(x["uzr"]), jnp.asarray(x["uh"]),
        mdt=jnp.dtype(jdt).name, interpret=True)
    got = G.gru_cell_fwd(
        torch.tensor(x["hstate"]), torch.tensor(x["a"]),
        torch.tensor(x["wa"]), torch.tensor(x["b3"][0]),
        torch.tensor(x["uzr"]), torch.tensor(x["uh"]), mdt=tdt)
    tol = BF16_ULP if dtype == "bfloat16" else atol
    for name, g, r in zip(("h", "z", "r", "htil"), got, ref):
        assert g.dtype == (torch.float32 if name == "h" else tdt), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), rtol=rtol,
                                   atol=tol, err_msg=name)


GRU_UPDATE_CASES = {
    # name: (N, D, matmul dtype, goes to the kernel wrapper)
    "bf16_d128": (128, 128, "bfloat16", True),
    "bf16_d256": (128, 256, "bfloat16", True),
    "bf16_n_unaligned": (96, 128, "bfloat16", False),
    "f32": (128, 128, None, False),
}


@pytest.mark.parametrize("case", sorted(GRU_UPDATE_CASES))
def test_gru_update_dispatch_matches_jax(case, monkeypatch):
    """gru_update sends a cell to gru_cell_fwd exactly when the JAX
    package sends it to its Pallas cell (matmul dtype set, N % 128 == 0,
    D % 128 == 0), and matches the JAX cell (tolerances as above)."""
    from ggnn_tpu.models.ggnn import gru_update as jax_gru_update
    from ggnn_tpu_torch.models import ggnn as M
    N, D, mdt, to_kernel = GRU_UPDATE_CASES[case]
    r = np.random.default_rng(8)
    gru = {k: (r.standard_normal((D, D)) * D ** -0.5).astype(np.float32)
           for k in ("wz", "wr", "wh", "uz", "ur", "uh")}
    gru.update({k: (r.standard_normal(D) * 0.1).astype(np.float32)
                for k in ("bz", "br", "bh")})
    h = (r.random((N, D)) - 0.5).astype(np.float32)
    a = r.standard_normal((N, D)).astype(np.float32)
    calls = []

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return G.gru_cell_fwd(*args, **kw)

    monkeypatch.setattr(M, "gru_cell_fwd", spy)
    got = M.gru_update({k: torch.tensor(v) for k, v in gru.items()},
                       torch.tensor(h), torch.tensor(a),
                       matmul_dtype=getattr(torch, mdt) if mdt else None)
    ref = jax_gru_update({k: jnp.asarray(v) for k, v in gru.items()},
                         jnp.asarray(h), jnp.asarray(a), matmul_dtype=mdt)
    assert calls == ([(N, D)] if to_kernel else [])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=BF16_ULP if mdt else 1e-5)


@pytest.mark.parametrize("case", ["empty_blocks", "cmax_ge_2"])
def test_aggregate_matches_per_edge_ground_truth(case):
    """aggregate_onehot against an independent per-edge numpy sum
    (np.add.at in f64, f32 tolerance 1e-4 for sums of ~100 products);
    dst blocks no edge reaches come out exactly 0."""
    if case == "empty_blocks":
        N, E, T2, kw = 1024, 3000, 4, dict(dst_hi=512)
    else:
        N, E, T2, kw = 256, 6000, 4, {}
    src, dst, typ, mask = _graph(3, N, E, T2, **kw)
    lay = S.build_typed_dst_layout(src, dst, typ, mask, N, T2,
                                   tile_e=128 if case == "cmax_ge_2"
                                   else None)
    if case == "cmax_ge_2":
        assert lay.block_meta[1] >= 2
    x = _inputs(4, N, T2, N)
    got = S.aggregate_onehot(torch.tensor(x["h"]), lay.to("cpu"),
                             torch.tensor(x["w"]), torch.tensor(x["b"]))
    ref = np.zeros((N, D))
    real = mask > 0
    msgs = (np.einsum("ed,edf->ef", x["h"][src[real]].astype(np.float64),
                      x["w"][typ[real]]) + x["b"][typ[real]])
    np.add.at(ref, dst[real], msgs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    if case == "empty_blocks":
        assert (got[512:] == 0).all()


def test_padding_slots_add_exactly_zero():
    """Padding entries (dstl −1, and whole empty slots) add exactly 0: the
    scatter output equals the one with the padding rows of h_pack set to
    huge values."""
    lay_j, lay_t, _ = _layouts(seed=3, N=1024, E=3000, T2=4, dst_hi=512)
    x = _inputs(5, 1024, 4, lay_t.n_blocks * 128)
    arrs, kw = _block_kw(lay_t)
    w = torch.tensor(x["w"])
    h_pack = _torch_h_pack(lay_t, x["h"], torch.float32)
    out = S.typed_block_scatter(h_pack, *arrs, w, **kw)
    used = torch.zeros(h_pack.shape[0], dtype=torch.bool)
    dstl, off, blk = arrs
    S8, tile_e = kw["S8"], kw["tile_e"]
    for s in range(dstl.shape[0]):
        if off[s] >= 0:
            base = (int(blk[s // S8]) + int(off[s])) * 16
            cols = torch.nonzero(dstl[s] >= 0).flatten()
            used[base + cols] = True
    poisoned = h_pack.clone()
    poisoned[~used] = 1e30
    np.testing.assert_array_equal(
        S.typed_block_scatter(poisoned, *arrs, w, **kw).numpy(), out.numpy())
    assert (out[512:] == 0).all()


def test_mismatched_layout_and_pack_raise():
    """A layout's arrays with another layout's h_pack or arguments, a
    weight bank whose types do not fill the layout's slot grid, a pack
    shorter than one block span, or a pack and bank in different dtypes
    are refused before any kernel could read out of bounds."""
    _, lay_a, _ = _layouts(seed=7, N=640, E=9000, T2=6)
    _, lay_b, _ = _layouts(seed=3, N=1024, E=3000, T2=4, dst_hi=512)
    x = _inputs(6, 1024, 6, lay_b.n_blocks * 128)
    arrs_b, kw_b = _block_kw(lay_b)
    arrs_a, kw_a = _block_kw(lay_a)
    w6 = torch.tensor(x["w"][:6])
    pack_a = _torch_h_pack(lay_a, x["h"][:640], torch.float32)
    pack_b = _torch_h_pack(lay_b, x["h"], torch.float32)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_block_scatter(pack_a, *arrs_b, w6[:4], **kw_a)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_block_scatter(pack_a, *arrs_a, w6, **kw_b)
    with pytest.raises(ValueError, match="does not belong"):
        S.typed_block_scatter(pack_b, *arrs_b, torch.zeros(9, D, D), **kw_b)
    with pytest.raises(ValueError, match="span"):
        S.typed_block_scatter(pack_a[:16], *arrs_a, w6, **kw_a)
    with pytest.raises(ValueError, match="compute dtype"):
        S.typed_block_scatter(pack_a, *arrs_a, w6.bfloat16(), **kw_a)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernels_match_reference_on_card(dtype):
    """Each kernel against its plain version on the card, with model-scale
    inputs (h in (−1, 1), weights U(±1/√D)).  The kernel sums in another
    order than the plain version's library matmuls, so the criteria are
    those of chip_smoke.py: scatter max ≤ 2e-5·max(1, max|plain|); GRU
    cell max ≤ one bf16 ulp at 1.0 (f32: 1e-4); fused step (bf16) max ≤
    8 ulps at 1.0 and mean ≤ 1e-3, since a last-bit f32 difference can
    round a, the aggregation, to the neighbouring bf16 value before the
    gate matmuls (f32: 1e-4)."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    bf16 = dtype == "bfloat16"
    _, lay, _ = _layouts()
    lay = lay.to(dev)
    r = np.random.default_rng(0)
    n_rows = lay.n_blocks * 128
    u = lambda *s, b=1.0: torch.tensor(
        r.uniform(-b, b, s).astype(np.float32), device=dev)
    x = dict(h=u(640, D), w=u(6, D, D, b=D ** -0.5), b=u(6, D, b=D ** -0.5),
             hstate=u(n_rows, D), wa=u(D, 3 * D, b=D ** -0.5),
             uzr=u(D, 2 * D, b=D ** -0.5), uh=u(D, D, b=D ** -0.5),
             b3=u(1, 3 * D, b=D ** -0.5))
    arrs, kw = _block_kw(lay)
    h_pack = x["h"].to(tdt).index_select(0, lay.arrays["gather_idx"])
    w = x["w"].to(tdt)
    init = S.bias_rows(lay, x["b"].to(tdt))

    def err(got, ref):
        d = (got.float() - ref.float()).abs()
        return d.max().item(), d.mean().item(), ref.abs().max().item()

    got = S.typed_block_scatter(h_pack, *arrs, w, **kw)
    ref = S.typed_block_scatter_reference(h_pack, *arrs, w, **kw)
    emax, _, scale = err(got, ref)
    assert emax <= 2e-5 * max(1.0, scale), emax
    gw = [x[k].to(tdt) for k in ("wa", "uzr", "uh")]
    got = S.typed_block_step_gru(h_pack, *arrs, w, init, x["hstate"],
                                 gw[0], x["b3"], gw[1], gw[2], **kw)
    ref = S.typed_block_step_gru_reference(h_pack, *arrs, w, init,
                                           x["hstate"], gw[0], x["b3"],
                                           gw[1], gw[2], **kw)
    emax, emean, _ = err(got, ref)
    assert emax <= (8 * BF16_ULP if bf16 else 1e-4), emax
    assert not bf16 or emean <= 1e-3, emean
    a = init + S.typed_block_scatter_reference(h_pack, *arrs, w, **kw)
    got = G.gru_cell_fwd(x["hstate"], a, gw[0], x["b3"][0], gw[1], gw[2],
                         mdt=tdt)
    ref = G.gru_cell_fwd_reference(x["hstate"], a, gw[0], x["b3"][0], gw[1],
                                   gw[2], mdt=tdt)
    for name, g, rr in zip(("h", "z", "r", "htil"), got, ref):
        emax, _, _ = err(g, rr)
        assert emax <= (BF16_ULP if bf16 else 1e-4), (name, emax)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_kernels_match_reference_on_card(dtype):
    """gru_cell_bwd and typed_grad_octet_scatter against their plain
    versions on the card, on a layout with B_g % 8 != 0 and empty grad
    blocks.  Criteria of chip_smoke.py: reverse scatter max ≤ 2e-5·max(1,
    max|plain|) in f32 and one bf16 ulp, 2**-7·max(1, max|plain|), flushed
    to bf16 (a last-bit f32 difference can round a sum the other way);
    empty grad blocks exactly 0; GRU backward relative Frobenius error per
    output ≤ 1e-5 (f32) and 2**-8 (bf16: gate gradients rounded before the
    products, flips rare and unsystematic)."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][1]
    bf16 = dtype == "bfloat16"
    N, T2 = 640, 6
    src, dst, typ, mask = _graph(13, N, 4000, T2)
    src = src % 256                       # grad blocks of 3 src blocks empty
    lay = S.build_typed_dst_layout(src, dst, typ, mask, N, T2,
                                   with_grad=True).to(dev)
    _, B_g, g_tile, C, R8, span8, n_oct = S.grad_meta(lay)
    assert B_g % 8 != 0
    arrs = (lay.arrays["g_dstl_oct"], lay.arrays["g_slot_off16"],
            lay.arrays["g_oblk16"])
    kw = dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8,
              out_dtype=tdt)
    gen = torch.Generator(device=dev).manual_seed(0)
    Gp = torch.randn(lay.arrays["g_gather_idx"].shape[0], D, device=dev,
                     generator=gen).to(tdt)
    got = S.typed_grad_octet_scatter(Gp, *arrs, **kw)
    ref = S.typed_grad_octet_scatter_reference(Gp, *arrs, **kw)
    scale = max(1.0, ref.float().abs().max().item())
    assert (got.float() - ref.float()).abs().max().item() <= (
        2.0 ** -7 if bf16 else 2e-5) * scale
    empty = (lay.arrays["g_slot_off16"].reshape(n_oct * 8, C) < 0).all(1)
    assert empty.any()
    assert (got.reshape(n_oct * 8, 128, D)[empty] == 0).all()
    h = torch.rand(N, D, device=dev, generator=gen) * 2 - 1
    a = torch.randn(N, D, device=dev, generator=gen)
    g = torch.randn(N, D, device=dev, generator=gen)
    w = [(torch.rand(D, k * D, device=dev, generator=gen) * 2 - 1) * D ** -0.5
         for k in (3, 2, 1)]
    b3 = torch.zeros(3 * D, device=dev)
    _, z, r, ht = G.gru_cell_fwd_reference(h, a, w[0], b3, w[1], w[2],
                                           mdt=tdt)
    args = (g, h.to(tdt), a.to(tdt), z, r, ht, *w)
    for o, rr in zip(G.gru_cell_bwd(*args, mdt=tdt),
                     G.gru_cell_bwd_reference(*args, mdt=tdt)):
        err = ((o.double() - rr.double()).norm()
               / rr.double().norm().clamp_min(1e-30)).item()
        assert err <= (2.0 ** -8 if bf16 else 1e-5), err
