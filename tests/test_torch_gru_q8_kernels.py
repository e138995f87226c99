"""Kernels #4 ``gru_cell_bwd`` and #15 ``node_table_block_major_q8`` at the
seams of their bf16 CUDA kernels, against the JAX package.

#4's bf16 kernel (``ops/csrc/gru_cell_bwd_pipe.cu``) walks 128-row blocks
on about one CTA per SM and sums the parameter gradients over split-K
chunks of 16 blocks; #15's (``ops/csrc/node_table_q8.cu``) runs a cluster
of W / 128 CTAs a window up to 8 types and two passes of one CTA beyond.
These cases put the work where those splits meet: one block, 17 blocks (a
whole chunk and a partial one), 33; da in f32 and in bf16 (the fused window
step's VJP asks for bf16); windows of 1, 2, 4 and 16 types at T2 = 16 and
of 1 and 3 at T2 = 3; an all-zero source block, whose windows' scale is
exactly 2**-100 and whose q is 0 when the bias is 0.

On the CPU the wrappers run their plain versions, held here to the JAX
kernels in Pallas interpret mode: #4 as ``tests/test_torch_train_ops.py``
(f32 rtol = 1e-5 and atol = 1e-5·max(1, max|ref|); bf16 a relative
Frobenius error ≤ 2**-8 on every output, far below one bf16 ulp of a term);
#15 as ``tests/test_torch_window.py`` (exponents equal away from an
integer boundary of the argument of ceil, the dequantized tables within one
quantum).  Tests marked ``cuda`` hold the CUDA kernels to their plain
versions on the card with chip_smoke.py's criteria (#4 the same relative
Frobenius error; #15 exponents equal away from a boundary and q within one
quantum), each twice bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import gru_pallas as GP
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import table as TB

torch.set_num_threads(1)

D = 128
RELF_BF16 = 2.0 ** -8
GRU_BLOCKS = (1, 17, 33)
# (T2, window): windows of 1, 2, 4, 16 types at T2 = 16; 1 and 3 at T2 = 3
Q8_SEAMS = ((16, 128), (16, 256), (16, 512), (16, 2048), (3, 128), (3, 384))
NAMES = ("dh", "da", "dW_a", "db", "dU_zr", "dU_h")


def _relfro(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _gru_inputs(seed, N):
    """Seeded numpy inputs: h in (−1, 1), a and the cotangent g normal,
    the GRU weights at D**-0.5 and the bias at 0.1."""
    r = np.random.default_rng(seed)
    h = (r.random((N, D)) * 2 - 1).astype(np.float32)
    a = r.standard_normal((N, D)).astype(np.float32)
    g = r.standard_normal((N, D)).astype(np.float32)
    w_a, u_zr, uh = ((r.standard_normal((D, k * D)) * D ** -0.5)
                     .astype(np.float32) for k in (3, 2, 1))
    b3 = (r.standard_normal(3 * D) * 0.1).astype(np.float32)
    return h, a, g, w_a, u_zr, uh, b3


@pytest.mark.parametrize("n_blocks", GRU_BLOCKS)
@pytest.mark.parametrize("dtype,da_dtype", [
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "float32")])
def test_gru_cell_bwd_seams_match_jax(n_blocks, dtype, da_dtype):
    """#4's plain version against the TPU kernel (interpret mode) on the
    residuals the forward cell made, da in f32 or in the compute dtype."""
    N = 128 * n_blocks
    h, a, g, w_a, u_zr, uh, b3 = _gru_inputs(n_blocks, N)
    jdt, tdt, tda = jnp.dtype(dtype), getattr(torch, dtype), \
        getattr(torch, da_dtype)
    _, z, rr, ht = GP.gru_cell_fwd(jnp.asarray(h), jnp.asarray(a),
                                   jnp.asarray(w_a), jnp.asarray(b3),
                                   jnp.asarray(u_zr), jnp.asarray(uh),
                                   mdt=dtype, interpret=True)
    ref = GP.gru_cell_bwd(
        jnp.asarray(g), jnp.asarray(h, jdt), jnp.asarray(a, jdt), z, rr, ht,
        jnp.asarray(w_a), jnp.asarray(u_zr), jnp.asarray(uh), mdt=dtype,
        interpret=True, da_dtype=da_dtype)
    res = [torch.tensor(np.asarray(x.astype(jnp.float32))).to(tdt)
           for x in (z, rr, ht)]
    got = G.gru_cell_bwd(torch.tensor(g), torch.tensor(h).to(tdt),
                         torch.tensor(a).to(tdt), *res, torch.tensor(w_a),
                         torch.tensor(u_zr), torch.tensor(uh), mdt=tdt,
                         da_dtype=tda)
    for name, o, rf in zip(NAMES, got, ref):
        want = tda if name == "da" else torch.float32
        assert o.dtype == want, name
        rf = np.asarray(rf.astype(jnp.float32))
        assert o.shape == rf.shape, name
        if dtype == "bfloat16":
            assert _relfro(o.float().numpy(), rf) <= RELF_BF16, (
                name, _relfro(o.float().numpy(), rf))
        else:
            np.testing.assert_allclose(
                o.numpy(), rf, rtol=1e-5,
                atol=1e-5 * max(1.0, np.abs(rf).max()), err_msg=name)


def _q8_inputs(seed, T2, n_blocks, zero):
    """h normal over ``n_blocks`` source blocks (block 1 all zero with
    ``zero``, and then the bias 0), weights at D**-0.5, bias at 0.1."""
    r = np.random.default_rng(seed)
    h = r.standard_normal((128 * n_blocks, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    if zero:
        h[128:256] = 0.0
        b[:] = 0.0
    return h, w, b


def _exponent_args(h, w, b, window):
    """The plain version's f32 argument of ceil for every window."""
    T2 = w.shape[0]
    nb = h.shape[0] // 128
    tab = torch.einsum("nd,tdf->ntf", h.float(), w.float()) + b.float()[None]
    m = tab.reshape(nb, 128, T2 * 128 // window, window // 128, D).abs() \
        .amax(dim=(1, 3, 4)).reshape(-1)
    return torch.log2(m.clamp_min(1e-30)) - 6.9886


def _check_q8(tq, sc, tq_ref, sc_ref, arg, window):
    """Exponents equal away from an integer boundary of ``arg``; the
    dequantized tables within one quantum of each other."""
    tq, sc = np.asarray(tq), np.asarray(sc, np.float64)[:, 0]
    tq_ref, sc_ref = np.asarray(tq_ref), np.asarray(sc_ref, np.float64)[:, 0]
    assert tq.dtype == np.int8 and tq.shape == tq_ref.shape
    assert sc.shape == sc_ref.shape
    arg = np.asarray(arg, np.float64)
    near = np.abs(arg - np.round(arg)) < 1e-6
    # the exponents (XLA's exp2 on the CPU is a few ulps off 2**-100)
    assert (np.rint(np.log2(sc)) == np.rint(np.log2(sc_ref)))[~near].all()
    rep = lambda s: np.repeat(s, window)[:, None]
    diff = np.abs(tq * rep(sc) - tq_ref * rep(sc_ref))
    assert (diff <= np.maximum(rep(sc), rep(sc_ref))).all()


@pytest.mark.parametrize("T2,window", Q8_SEAMS)
def test_node_table_q8_seams_match_jax(T2, window):
    """#15's plain version against the TPU kernel (interpret mode) at
    windows of 1 to 16 types, T2 = 16 and 3."""
    h, w, b = _q8_inputs(T2 + window, T2, 4, zero=False)
    hb, wb, bb = (torch.tensor(x).bfloat16() for x in (h, w, b))
    tq_j, sc_j = WP.node_table_block_major_q8(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), window=window, interpret=True)
    tq, sc = TB.node_table_block_major_q8(hb, wb, bb, window=window)
    assert tuple(sc.shape) == (4 * T2 * 128 // window, 1)
    _check_q8(tq.numpy(), sc.numpy(), tq_j, sc_j,
              _exponent_args(hb, wb, bb, window), window)


@pytest.mark.parametrize("window", [128, 512])
def test_node_table_q8_zero_block(window):
    """An all-zero source block with a zero bias: its windows' scale is
    exactly 2**-100 and its q 0 in the port; the JAX package gives the
    exponent −100 and q 0 (its exp2 on the CPU rounds 2**-100 a few ulps
    off)."""
    T2 = 16
    h, w, b = _q8_inputs(5, T2, 3, zero=True)
    hb, wb, bb = (torch.tensor(x).bfloat16() for x in (h, w, b))
    tq, sc = TB.node_table_block_major_q8(hb, wb, bb, window=window)
    tq_j, sc_j = WP.node_table_block_major_q8(
        jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b, jnp.bfloat16), window=window, interpret=True)
    wpb = T2 * 128 // window
    assert (sc.numpy()[wpb:2 * wpb] == 2.0 ** -100).all()
    for q_, s_ in ((tq.numpy(), sc.numpy()),
                   (np.asarray(tq_j), np.asarray(sc_j))):
        assert (np.rint(np.log2(s_[wpb:2 * wpb])) == -100).all()
        assert (q_[T2 * 128:2 * T2 * 128] == 0).all()
        assert (np.rint(np.log2(s_[:wpb])) > -100).all()
    _check_q8(tq.numpy(), sc.numpy(), tq_j, sc_j,
              _exponent_args(hb, wb, bb, window), window)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks", GRU_BLOCKS + (133,))
def test_gru_cell_bwd_seams_on_card(n_blocks):
    """#4's bf16 kernel against its plain version, da in f32 and bf16: a
    relative Frobenius error ≤ 2**-8 on each output, twice bit-equal (133
    blocks: one more than an H100's SMs, so one CTA walks two)."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    h, a, g, w_a, u_zr, uh, b3 = (torch.tensor(x, device=dev) for x in
                                  _gru_inputs(n_blocks, 128 * n_blocks))
    bf = torch.bfloat16
    _, z, r, ht = G.gru_cell_fwd_reference(h, a, w_a, b3, u_zr, uh, mdt=bf)
    args = (g, h.to(bf), a.to(bf), z, r, ht, w_a, u_zr, uh)
    for da in (torch.float32, bf):
        got = G.gru_cell_bwd(*args, mdt=bf, da_dtype=da)
        again = G.gru_cell_bwd(*args, mdt=bf, da_dtype=da)
        ref = G.gru_cell_bwd_reference(*args, mdt=bf, da_dtype=da)
        for name, o, o2, rf in zip(NAMES, got, again, ref):
            assert torch.equal(o, o2), (name, da)
            assert o.dtype == rf.dtype, (name, da)
            assert _relfro(o.float().cpu(), rf.float().cpu()) <= RELF_BF16, (
                name, da)


@pytest.mark.cuda
@pytest.mark.parametrize("T2,window", Q8_SEAMS)
@pytest.mark.parametrize("n_blocks,zero", [(7, False), (133, False),
                                           (3, True)])
def test_node_table_q8_seams_on_card(T2, window, n_blocks, zero):
    """#15's bf16 kernel against its plain version: exponents equal away
    from a boundary, q within one quantum, twice bit-equal; the zero block
    exactly 2**-100 and 0."""
    dev = _card()
    hb, wb, bb = (torch.tensor(x, device=dev).bfloat16()
                  for x in _q8_inputs(T2 * window + n_blocks, T2, n_blocks,
                                      zero))
    tq, sc = TB.node_table_block_major_q8(hb, wb, bb, window=window)
    tq2, sc2 = TB.node_table_block_major_q8(hb, wb, bb, window=window)
    assert torch.equal(tq, tq2) and torch.equal(sc, sc2)
    tq_r, sc_r = TB.node_table_block_major_q8_reference(hb, wb, bb, window)
    _check_q8(tq.cpu().numpy(), sc.cpu().numpy(), tq_r.cpu().numpy(),
              sc_r.cpu().numpy(), _exponent_args(hb, wb, bb, window).cpu(),
              window)
    if zero:
        wpb = T2 * 128 // window
        assert (sc[wpb:2 * wpb] == 2.0 ** -100).all()
        assert (tq[T2 * 128:2 * T2 * 128] == 0).all()
