"""Kernels #16 ``packed_messages`` and #10 ``node_table_block_major`` at the
seams of their persistent CUDA kernels, against the JAX package and numpy.

The CUDA kernels walk contiguous ranges of work on about one CTA per SM:
#16 ranges of 128-row chunks of tiles, keeping W_t's panel resident across
a run of equal ``tile_type``; #10 ranges of (source block, type) items,
keeping a block's rows resident across its types.  These layouts put the work
where those ranges and runs meet: an unsorted ``tile_type``, type runs of
1 to 13 tiles over a schedule of 6 chunks a CTA (runs that begin and end
inside one CTA's range and runs across two; ``tile_e`` 128 and 256), a
single tile, one type only, all-padding tiles between real ones; one
source block and several, T2 = 1, 3 and 16.

On the CPU the wrappers run their plain versions, held here to the JAX
kernels in Pallas interpret mode (#16: f32 rtol = atol = 1e-6, bf16 inputs
with f32 sums rtol 1e-5, as ``tests/test_torch_pallas.py``; #10: f32
2e-5, bf16 one bf16 ulp of the value plus 2e-5, as
``tests/test_torch_legacy.py``) and to an f64 numpy construction slot by
slot (rtol 1e-5 of the f64 value's terms).  Tests marked ``cuda`` hold the
CUDA kernels to their plain versions on the card with chip_smoke.py's
criteria (per element 2e-5 of Σ|terms| for #16, 1e-5 of Σ|terms| plus one
bf16 ulp for #10, each twice bit-equal, padding slots exactly zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import spmm_pallas as JS
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu_torch.ops import spmm as SP
from ggnn_tpu_torch.ops import table as TB

torch.set_num_threads(1)

BF16_ULP = 2.0 ** -7
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SEAMS = ("unsorted", "runs tile_e128", "runs tile_e256", "single tile",
         "one type", "padding between")


def _runs(n_tiles, T2):
    """Type runs of 1, 2, 3, 7 and 13 tiles, the types in turn."""
    out, k = [], 0
    while len(out) < n_tiles:
        out += [k % T2] * (1, 2, 3, 7, 13)[k % 5]
        k += 1
    return np.array(out[:n_tiles], np.int32)


def _seam_layout(case, seed=23, n_ctas=8, N=300):
    """A packed layout (src, mask, tile_type) at one of #16's seams, for a
    schedule of ``n_ctas`` CTAs; 10 % of the slots are holes."""
    r = np.random.default_rng(seed)
    tile_e, tt, T2, pad_between = {
        "unsorted": (128, r.integers(0, 6, 40), 6, False),
        "runs tile_e128": (128, _runs(6 * n_ctas, 5), 5, False),
        "runs tile_e256": (256, _runs(3 * n_ctas, 5), 5, False),
        "single tile": (128, np.array([2]), 3, False),
        "one type": (128, np.full(20, 1), 4, False),
        "padding between": (128, np.sort(r.integers(0, 6, 30)), 6, True),
    }[case]
    P = len(tt) * tile_e
    src = r.integers(0, N, P).astype(np.int32)
    mask = (r.random(P) >= 0.1).astype(np.float32)
    if pad_between:
        pad = np.repeat(np.arange(len(tt)) % 3 == 1, tile_e)
        src[pad], mask[pad] = 0, 0.0
    return dict(src=src, mask=mask, tile_type=np.asarray(tt, np.int32),
                tile_e=tile_e, T2=T2, N=N)


def _cta_ranges(n_items, n_ctas):
    return [(n_items * x // n_ctas, n_items * (x + 1) // n_ctas)
            for x in range(n_ctas)]


def _weights(r, N, D, T2):
    h = r.uniform(-1, 1, (N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    return h, w, b


def test_seam_layouts_cover_the_schedule():
    """The runs cases put type runs both inside one CTA's range and across
    two, on 6 chunks a CTA; unsorted types change direction; the padding
    case has whole tiles without a real slot between real ones."""
    for case, cpt in (("runs tile_e128", 1), ("runs tile_e256", 2)):
        lay = _seam_layout(case)
        tt = lay["tile_type"]
        first = [a for a, _ in _cta_ranges(len(tt) * cpt, 8)]
        cta = np.searchsorted(first, np.arange(len(tt)) * cpt, "right") - 1
        starts = np.concatenate([[0], np.nonzero(np.diff(tt))[0] + 1])
        ends = np.concatenate([starts[1:], [len(tt)]]) - 1
        end_cta = np.searchsorted(first, ends * cpt + cpt - 1, "right") - 1
        inside = (end_cta == cta[starts]).sum()
        assert 0 < inside < len(starts), case
    assert (np.diff(_seam_layout("unsorted")["tile_type"]) < 0).any()
    lay = _seam_layout("padding between")
    live = lay["mask"].reshape(-1, 128).sum(1)
    assert (live[1::3] == 0).all() and (live[::3] > 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SEAMS)
def test_packed_messages_seams_match_jax(case, dtype):
    """#16's plain version against the JAX kernel (interpret mode) at the
    seams; padding slots exactly zero."""
    lay = _seam_layout(case)
    D, T2, tile_e = 8, lay["T2"], lay["tile_e"]
    h, w, b = _weights(np.random.default_rng(5), lay["N"], D, T2)
    jdt, tdt = DTYPES[dtype]
    ref = JS.packed_messages(
        jnp.asarray(h, jdt), jnp.asarray(lay["src"]),
        jnp.asarray(lay["mask"]), jnp.asarray(lay["tile_type"]),
        jnp.asarray(w, jdt), jnp.asarray(b, jdt), tile_e=tile_e,
        interpret=True)
    got = SP.packed_messages(
        torch.tensor(h).to(tdt), torch.tensor(lay["src"]),
        torch.tensor(lay["mask"]), torch.tensor(lay["tile_type"]),
        torch.tensor(w).to(tdt), torch.tensor(b).to(tdt), tile_e)
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    assert (got[torch.tensor(lay["mask"]) == 0] == 0).all()


@pytest.mark.parametrize("case", SEAMS)
def test_packed_messages_seams_match_numpy(case):
    """#16's plain version slot by slot against (h[src]·W_t + b_t)·mask in
    f64, t the slot's tile's type, at D = 12 (not a multiple of 8)."""
    lay = _seam_layout(case)
    D, T2, tile_e = 12, lay["T2"], lay["tile_e"]
    h, w, b = _weights(np.random.default_rng(6), lay["N"], D, T2)
    t = np.repeat(lay["tile_type"], tile_e)
    hs = h.astype(np.float64)[lay["src"]]
    want = (np.einsum("pd,pdf->pf", hs, w.astype(np.float64)[t])
            + b.astype(np.float64)[t]) * lay["mask"][:, None]
    terms = (np.einsum("pd,pdf->pf", np.abs(hs), np.abs(w[t]))
             + np.abs(b[t])) * lay["mask"][:, None]
    got = SP.packed_messages(
        torch.tensor(h), torch.tensor(lay["src"]), torch.tensor(lay["mask"]),
        torch.tensor(lay["tile_type"]), torch.tensor(w), torch.tensor(b),
        tile_e).numpy()
    assert (np.abs(got - want) <= 1e-5 * terms + 1e-30).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T2", [1, 3, 16])
@pytest.mark.parametrize("n_blocks", [1, 3])
def test_node_table_seams_match_jax(n_blocks, T2, dtype):
    """#10's plain version against the JAX kernel (interpret mode): one
    source block and three, T2 = 1, 3 and 16."""
    jdt, tdt = DTYPES[dtype]
    D = 8
    h, w, b = _weights(np.random.default_rng(7 + T2), 128 * n_blocks, D, T2)
    ref = np.asarray(WP.node_table_block_major(
        *(jnp.asarray(x, jdt) for x in (h, w, b)), interpret=True),
        np.float32)
    got = TB.node_table_block_major(*(torch.tensor(x).to(tdt)
                                      for x in (h, w, b)))
    assert got.dtype == tdt and got.shape == (128 * n_blocks * T2, D)
    tol = (BF16_ULP * np.abs(ref) + 2e-5 if dtype == "bfloat16"
           else 2e-5 + 2e-5 * np.abs(ref))
    assert (np.abs(got.float().numpy() - ref) <= tol).all()


@pytest.mark.parametrize("T2", [1, 3, 16])
def test_node_table_block_order_matches_numpy(T2):
    """Row (i·T2 + t)·128 + s of #10's plain version is h[i·128 + s]·W_t +
    b_t (f64 construction, f32 value), over three blocks."""
    D, n_blocks = 12, 3
    h, w, b = _weights(np.random.default_rng(9), 128 * n_blocks, D, T2)
    got = TB.node_table_block_major(torch.tensor(h), torch.tensor(w),
                                    torch.tensor(b)).numpy()
    for i in range(n_blocks):
        for t in range(T2):
            rows = h[i * 128:(i + 1) * 128].astype(np.float64)
            want = rows @ w[t].astype(np.float64) + b[t]
            blk = got[(i * T2 + t) * 128:(i * T2 + t + 1) * 128]
            np.testing.assert_allclose(blk, want, rtol=1e-5, atol=1e-6)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 6, 8, 13, 128, 200, 256, 384])
def test_packed_messages_seams_on_card(D):
    """#16's CUDA kernel against its plain version at the seams (a schedule
    of 8 CTAs here; the card runs about one CTA per SM), bf16 and f32: per
    element within 2e-5 of Σ|terms|, twice bit-equal, padding exactly 0."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    for case in SEAMS:
        lay = _seam_layout(case)
        h, w, b = _weights(np.random.default_rng(D), lay["N"], D, lay["T2"])
        args = [torch.tensor(lay[k], device=dev)
                for k in ("src", "mask", "tile_type")]
        for tdt in (torch.bfloat16, torch.float32):
            x = [torch.tensor(v, device=dev).to(tdt) for v in (h, w, b)]
            got = SP.packed_messages(x[0], *args, x[1], x[2], lay["tile_e"])
            assert torch.equal(got, SP.packed_messages(
                x[0], *args, x[1], x[2], lay["tile_e"])), case
            ref = SP.packed_messages_reference(x[0], *args, x[1], x[2],
                                               lay["tile_e"])
            mag = SP.packed_messages_reference(
                x[0].abs(), args[0], args[1].abs(), args[2], x[1].abs(),
                x[2].abs(), lay["tile_e"])
            assert ((got - ref).abs() <= 2e-5 * mag).all(), (case, tdt)
            assert (got[args[1] == 0] == 0).all(), (case, tdt)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 6, 8, 13, 128, 200, 256, 384])
def test_node_table_seams_on_card(D):
    """#10's CUDA kernel against its plain version: one source block and
    150 (CTA ranges begin and end inside a block's types), T2 = 1, 3, 16,
    bf16 and f32: per element within 1e-5 of Σ|terms| plus (bf16) one ulp
    of the value, twice bit-equal."""
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    for n_blocks in (1, 150):
        for T2 in (1, 3, 16):
            h, w, b = _weights(np.random.default_rng(T2), 128 * n_blocks, D,
                               T2)
            for tdt in (torch.bfloat16, torch.float32):
                x = [torch.tensor(v, device=dev).to(tdt) for v in (h, w, b)]
                got = TB.node_table_block_major(*x)
                assert torch.equal(got, TB.node_table_block_major(*x))
                ref = TB.node_table_block_major_reference(*x).float()
                bound = 1e-5 * TB.node_table_block_major_reference(
                    *(v.float().abs() for v in x))
                if tdt == torch.bfloat16:
                    bound = bound + BF16_ULP * ref.abs()
                assert ((got.float() - ref).abs() <= bound).all(), (
                    n_blocks, T2, tdt)
