"""The port's typed-pack layout function against the JAX package's.

``ggnn_tpu_torch.ops.scatter.build_typed_dst_layout`` is a numpy port of
``ggnn_tpu.ops.scatter_pallas.build_typed_dst_layout``; for the same edges
it must give the same ``meta`` and every array equal in value and dtype
(exact: integer bookkeeping, no arithmetic that could round)."""

import numpy as np
import pytest
import torch

from ggnn_tpu.ops import scatter_pallas as SP
from ggnn_tpu_torch.ops import scatter as S

torch.set_num_threads(1)


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


def _assert_same(lay_j, lay_t):
    assert lay_t.meta == lay_j.meta
    assert sorted(lay_t.arrays) == sorted(lay_j.arrays)
    for k, v in lay_j.arrays.items():
        ref = np.asarray(v)
        got = lay_t.arrays[k]
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


CASES = {
    # name: (seed, N, E, T2, layout kwargs, graph kwargs)
    "uniform_a": (0, 640, 9000, 6, {}, {}),
    "uniform_b": (1, 384, 2500, 4, {}, {}),
    "uniform_c": (2, 1024, 6000, 10, {"tile_e": 128}, {}),
    "empty_blocks": (3, 1024, 3000, 4, {}, {"dst_hi": 512}),
    "cmax_ge_2": (4, 256, 6000, 4, {"tile_e": 128}, {}),
    "hub_declines": (11, 1024, 6000, 4, {"tile_e": 128}, {"hub": True}),
    "per_tile_chunked": (5, 640, 9000, 5, {"smem_tile_cap": 5,
                                           "block_mode": False}, {}),
    "per_tile_span": (6, 640, 9000, 5, {"span_mode": True,
                                        "block_mode": False}, {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_reference(case):
    seed, N, E, T2, kw, gkw = CASES[case]
    edges = _graph(seed, N, E, T2, **gkw)
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, **kw)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, **kw)
    _assert_same(lay_j, lay_t)
    if case == "hub_declines":
        assert lay_t.block_meta is None
    elif case == "cmax_ge_2":
        assert lay_t.block_meta[1] >= 2
    elif case == "per_tile_chunked":
        assert lay_t.meta[8] is not None


def test_layout_declined_block_mode_raises_in_aggregate():
    """Where block mode declines (a hub), aggregation runs the per-tile
    kernel's path; it used to raise here and now holds the JAX package's
    ``aggregate_onehot`` (Pallas interpret mode) on the same inputs, in f32
    (rtol = atol = 1e-5: the same sums in another order) and bf16 (rtol =
    1e-5, atol = 1e-4: the per-tile one-hot sums are rounded to bf16 at the
    same points in both, so only the f32 order of the W_t products
    differs)."""
    import jax.numpy as jnp
    N, T2, D = 1024, 4, 128
    edges = _graph(11, N, 6000, T2, hub=True)
    lay_j = SP.build_typed_dst_layout(*edges, N, T2, tile_e=128)
    lay = S.build_typed_dst_layout(*edges, N, T2, tile_e=128)
    assert lay.block_meta is None and lay_j.meta[10] is None
    r = np.random.default_rng(0)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * 0.2).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    for jdt, tdt, atol in ((jnp.float32, torch.float32, 1e-5),
                           (jnp.bfloat16, torch.bfloat16, 1e-4)):
        ref = SP.aggregate_onehot(jnp.asarray(h, jdt), lay_j,
                                  jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                                  interpret=True)
        got = S.aggregate_onehot(torch.tensor(h).to(tdt), lay.to("cpu"),
                                 torch.tensor(w).to(tdt),
                                 torch.tensor(b).to(tdt))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=atol, err_msg=str(tdt))


def test_layout_with_grad_raises():
    """with_grad=True builds the octet grad layout where the reference
    does, and where the reference falls back to its legacy grad layout
    (block_mode=False) the port, which used to raise there, builds the same
    legacy arrays: the whole layout array for array (exact)."""
    edges = _graph(0, 256, 500, 4)
    lay = S.build_typed_dst_layout(*edges, 256, 4, with_grad=True)
    assert lay.meta[5][0] == "octet"
    kw = dict(with_grad=True, block_mode=False)
    lay_j = SP.build_typed_dst_layout(*edges, 256, 4, **kw)
    lay_t = S.build_typed_dst_layout(*edges, 256, 4, **kw)
    _assert_same(lay_j, lay_t)
    assert lay_t.meta[5][0] != "octet" and "g_dstl" in lay_t.arrays


def test_layout_to_device_keeps_meta_and_dtypes():
    edges = _graph(0, 384, 2500, 4)
    lay = S.build_typed_dst_layout(*edges, 384, 4)
    dev = lay.to("cpu")
    assert dev.meta == lay.meta
    for k, v in lay.arrays.items():
        assert torch.is_tensor(dev.arrays[k])
        np.testing.assert_array_equal(dev.arrays[k].numpy(), v)
        assert dev.arrays[k].numpy().dtype == v.dtype
