"""The port's backward ops against the JAX package's: the octet grad layout
of ``build_typed_dst_layout(with_grad=True)``, the reverse scatter
(``typed_grad_octet_scatter``), the GRU backward (``gru_cell_bwd``) and the
onehot aggregation's custom backward.  The same seeded numpy inputs go to
both packages; the JAX kernels run in Pallas interpret mode, the port's
wrappers their plain versions (CPU tensors).  Tolerances:

- layouts: exact, array for array and dtype for dtype (integer
  bookkeeping);
- reverse scatter: f32 rtol = atol = 1e-5 (the same f32 sums in another
  order); bf16 output: one bf16 ulp of the value, rtol = 2**-7 (a last-bit
  f32 difference can round a sum to the neighbouring bf16 value);
- GRU backward and aggregation gradients: f32 rtol = 1e-5 and atol =
  1e-5·max(1, max|ref|) on every output (each entry is a sum of many
  products, and entries that cancel to near 0 keep the rounding of the
  large terms); bf16 (gate gradients and Y rounded to bf16 before the products):
  relative Frobenius error ≤ 2**-8 per output, far below one bf16 ulp of a
  term, since a last-bit f32 difference only rarely moves a rounding.
"""

import jax
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
RELF_BF16 = 2.0 ** -8


def _graph(seed, N, E, T2, dst_hi=None, src_hi=None, hub=False):
    r = np.random.default_rng(seed)
    src = r.integers(0, src_hi or N, E).astype(np.int32)
    if hub:
        # most edges leave a few source nodes: hub-heavy grad blocks
        src = np.where(r.random(E) < 0.9, r.integers(0, 16, E),
                       src).astype(np.int32)
    dst = r.integers(0, dst_hi or N, E).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = (r.random(E) < 0.9).astype(np.float32)
    return src, dst, typ, mask


# the cases of tests/test_torch_layout.py whose octet grad layout engages,
# plus grad-side edge cases
CASES = {
    # name: (seed, N, E, T2, layout kwargs, graph kwargs)
    "uniform_a": (0, 640, 9000, 6, {}, {}),           # B_g = 30: % 8 = 6
    "uniform_b": (1, 384, 2500, 4, {}, {}),
    "uniform_c": (2, 1024, 6000, 10, {"tile_e": 128}, {}),
    "empty_blocks": (3, 1024, 3000, 4, {}, {"dst_hi": 512}),
    "cmax_ge_2": (4, 256, 6000, 4, {"tile_e": 128}, {}),
    "hub_declines": (11, 1024, 6000, 4, {"tile_e": 128}, {"dst_hi": 64}),
    "bg_not_mult8": (12, 384, 2000, 2, {}, {}),        # B_g = 6
    "empty_grad_blocks": (13, 640, 4000, 6, {}, {"src_hi": 256}),
    "grad_chunks_ge_2": (14, 256, 6000, 4, {"grad_tile_e": 128}, {}),
}


def _layouts(case):
    seed, N, E, T2, kw, gkw = CASES[case]
    edges = _graph(seed, N, E, T2, **gkw)
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, with_grad=True, **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, with_grad=True, **kw)
    return lay_j, lay_t, edges


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_layout_matches_reference(case):
    lay_j, lay_t, _ = _layouts(case)
    assert lay_t.meta == lay_j.meta
    assert sorted(lay_t.arrays) == sorted(lay_j.arrays)
    for k, v in lay_j.arrays.items():
        ref = np.asarray(v)
        assert lay_t.arrays[k].dtype == ref.dtype, k
        np.testing.assert_array_equal(lay_t.arrays[k], ref, err_msg=k)
    gm = lay_t.meta[5]
    assert gm[0] == "octet"
    if case in ("uniform_a", "bg_not_mult8", "empty_grad_blocks"):
        assert gm[1] % 8 != 0
    if case == "empty_grad_blocks":
        assert (lay_t.arrays["g_slot_off16"] < 0).any()
    if case == "grad_chunks_ge_2":
        assert gm[3] >= 2


@pytest.mark.parametrize("how", ["block_mode_false", "hub_grad_blocks"])
def test_grad_layout_declined_raises(how):
    """Where the octet layout declines, the reference builds its legacy
    grad layout.  The port used to raise here; it now builds the same
    arrays (exact) and its aggregation backward through
    window_block_spmm_mono gives the JAX package's (dh, dW, db) for one
    random cotangent (tolerances of the module docstring)."""
    N, T2 = 1024, 2
    if how == "block_mode_false":
        edges, kw = _graph(0, N, 3000, T2), {"block_mode": False}
    else:
        edges, kw = _graph(0, N, 6000, T2, hub=True), {"grad_tile_e": 128}
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, with_grad=True, **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, with_grad=True, **kw)
    assert lay_j.meta[5][0] != "octet"
    assert lay_t.meta == lay_j.meta
    assert sorted(lay_t.arrays) == sorted(lay_j.arrays)
    for k, v in lay_j.arrays.items():
        assert lay_t.arrays[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(lay_t.arrays[k], np.asarray(v),
                                      err_msg=k)
    r = np.random.default_rng(6)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * 0.1).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    da = r.standard_normal((N, D)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda h, w, b: SP.aggregate_onehot(h, lay_j, w, b, interpret=True),
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    th, tw, tb = (torch.tensor(x).requires_grad_(True) for x in (h, w, b))
    got = S.aggregate_onehot(th, lay_t.to("cpu"), tw, tb)
    got.backward(torch.tensor(da))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for name, t, rf in zip(("dh", "dW", "db"), (th, tw, tb),
                           vjp(jnp.asarray(da))):
        _assert_close(t.grad, rf, False, name)


def _octet_args(lay):
    _, _, g_tile, C, R8, span8, n_oct = lay.meta[5]
    a = lay.arrays
    return ((a["g_dstl_oct"], a["g_slot_off16"], a["g_oblk16"]),
            dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8))


@pytest.mark.parametrize("case", ["uniform_a", "empty_grad_blocks",
                                  "grad_chunks_ge_2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_typed_grad_octet_scatter_matches_jax(case, dtype):
    lay_j, lay_t, _ = _layouts(case)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    r = np.random.default_rng(3)
    Gp = r.standard_normal((lay_t.arrays["g_gather_idx"].shape[0], D)
                           ).astype(np.float32)
    jarrs, jkw = _octet_args(lay_j)
    ref = SP.typed_grad_octet_scatter(jnp.asarray(Gp, jdt), *jarrs, **jkw,
                                      out_dtype=jdt, interpret=True)
    tarrs, tkw = _octet_args(lay_t.to("cpu"))
    got = S.typed_grad_octet_scatter(torch.tensor(Gp).to(tdt), *tarrs, **tkw,
                                     out_dtype=tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(ref.shape)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=1e-5)


def test_grad_octet_padding_adds_exactly_zero():
    """Rows of G that no slot reads, −1 dstl entries, empty slots, empty
    grad blocks and the rows past B_g in the last octet add exactly 0."""
    _, lay_t, _ = _layouts("empty_grad_blocks")
    lay = lay_t.to("cpu")
    arrs, kw = _octet_args(lay)
    dstl, off, oblk = arrs
    n_oct, C, g_tile = kw["n_oct"], kw["C"], kw["g_tile"]
    Gp = torch.randn(lay.arrays["g_gather_idx"].shape[0], D,
                     generator=torch.Generator().manual_seed(0))
    out = S.typed_grad_octet_scatter(Gp, *arrs, **kw)
    used = torch.zeros(Gp.shape[0], dtype=torch.bool)
    for s in range(off.shape[0]):
        if off[s] >= 0:
            gb, c = divmod(s, C)
            base = (int(oblk[gb // 8]) + int(off[s])) * 16
            row = dstl[(gb // 8) * kw["R8"] + (gb % 8) * C + c]
            used[base + torch.nonzero(row >= 0).flatten()] = True
    poisoned = Gp.clone()
    poisoned[~used] = 1e30
    np.testing.assert_array_equal(
        S.typed_grad_octet_scatter(poisoned, *arrs, **kw).numpy(),
        out.numpy())
    blocks = out.reshape(n_oct * 8, 128, D)
    empty = (off.reshape(n_oct * 8, C) < 0).all(1)
    B_g = lay.meta[5][1]
    assert empty[B_g:].all() and empty[:B_g].any()
    assert (blocks[empty] == 0).all()
    del g_tile


def test_grad_octet_mismatched_args_raise():
    """Another layout's arrays, or a pack shorter than one octet span, are
    refused before any kernel could read out of bounds."""
    _, lay_a, _ = _layouts("uniform_a")
    _, lay_b, _ = _layouts("uniform_b")
    arrs_a, kw_a = _octet_args(lay_a.to("cpu"))
    arrs_b, kw_b = _octet_args(lay_b.to("cpu"))
    Gp = torch.zeros(lay_a.arrays["g_gather_idx"].shape[0], D)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_grad_octet_scatter(Gp, arrs_b[0], *arrs_a[1:], **kw_a)
    with pytest.raises(ValueError, match="layout and arguments disagree"):
        S.typed_grad_octet_scatter(Gp, *arrs_a, **kw_b)
    with pytest.raises(ValueError, match="octet span"):
        S.typed_grad_octet_scatter(Gp[:16], *arrs_a, **kw_a)
    with pytest.raises(ValueError, match="int32"):
        S.typed_grad_octet_scatter(Gp, arrs_a[0].long(), *arrs_a[1:], **kw_a)


def _relfro(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _assert_close(got, ref, bf16, name):
    got = got.float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    if bf16:
        assert _relfro(got, ref) <= RELF_BF16, (name, _relfro(got, ref))
    else:
        np.testing.assert_allclose(
            got, ref, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(ref).max()),
            err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cell_bwd_matches_jax(dtype):
    """The GRU backward against the TPU kernel's (interpret mode) on
    residuals the forward cell made, as the model saves them."""
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    r = np.random.default_rng(4)
    N = 256
    h = (r.random((N, D)) * 2 - 1).astype(np.float32)
    a = r.standard_normal((N, D)).astype(np.float32)
    g = r.standard_normal((N, D)).astype(np.float32)
    w_a, u_zr, uh = ((r.standard_normal((D, k * D)) * D ** -0.5)
                     .astype(np.float32) for k in (3, 2, 1))
    b3 = (r.standard_normal(3 * D) * 0.1).astype(np.float32)
    _, z, rr, ht = GP.gru_cell_fwd(jnp.asarray(h), jnp.asarray(a),
                                   jnp.asarray(w_a), jnp.asarray(b3),
                                   jnp.asarray(u_zr), jnp.asarray(uh),
                                   mdt=dtype, interpret=True)
    res = [np.asarray(x.astype(jnp.float32)) for x in (z, rr, ht)]
    ref = GP.gru_cell_bwd(
        jnp.asarray(g), jnp.asarray(h, jdt), jnp.asarray(a, jdt),
        z, rr, ht, jnp.asarray(w_a), jnp.asarray(u_zr), jnp.asarray(uh),
        mdt=dtype, interpret=True)
    tres = [torch.tensor(x).to(tdt) for x in res]
    got = G.gru_cell_bwd(torch.tensor(g), torch.tensor(h).to(tdt),
                         torch.tensor(a).to(tdt), *tres,
                         torch.tensor(w_a), torch.tensor(u_zr),
                         torch.tensor(uh), mdt=tdt)
    names = ("dh", "da", "dW_a", "db", "dU_zr", "dU_h")
    for name, o, rf in zip(names, got, ref):
        assert o.dtype == torch.float32, name
        _assert_close(o, rf, dtype == "bfloat16", name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregate_onehot_value_and_grads_match_jax(dtype):
    """aggregate_onehot's value and its custom backward's (dh, dW, db)
    against the JAX package's ``_aggregate_onehot`` for one random
    cotangent."""
    lay_j, lay_t, _ = _layouts("uniform_a")
    N, T2 = 640, 6
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    r = np.random.default_rng(5)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * 0.1).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    da = r.standard_normal((N, D)).astype(np.float32)

    def jfn(h, w, b):
        return SP.aggregate_onehot(h, lay_j, w, b, interpret=True)
    ref, vjp = jax.vjp(jfn, jnp.asarray(h, jdt), jnp.asarray(w, jdt),
                       jnp.asarray(b, jdt))
    rdh, rdw, rdb = vjp(jnp.asarray(da))
    th, tw, tb = (torch.tensor(x).to(tdt).requires_grad_(True)
                  for x in (h, w, b))
    got = S.aggregate_onehot(th, lay_t.to("cpu"), tw, tb)
    got.backward(torch.tensor(da))
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-4 if bf16 else 1e-5)
    for name, t, rf in (("dh", th, rdh), ("dW", tw, rdw), ("db", tb, rdb)):
        assert t.grad.dtype == tdt, name
        _assert_close(t.grad, rf, bf16, name)


def test_aggregate_backward_refuses_what_it_cannot_run():
    """A layout without its grad half, or h whose rows are not a multiple
    of 128, raise a clear error instead of computing something else."""
    N, T2 = 640, 6
    edges = _graph(0, N, 9000, T2)
    w = torch.zeros(T2, D, D, requires_grad=True)
    b = torch.zeros(T2, D)
    lay = S.build_typed_dst_layout(*edges, N, T2).to("cpu")
    with pytest.raises(ValueError, match="with_grad=True"):
        S.aggregate_onehot(torch.zeros(N, D), lay, w, b)
    lay = S.build_typed_dst_layout(*edges, N, T2, with_grad=True).to("cpu")
    with pytest.raises(ValueError, match="multiple of 128"):
        S.aggregate_bwd(lay, torch.zeros(600, D), w.detach(),
                        torch.zeros(600, D))
