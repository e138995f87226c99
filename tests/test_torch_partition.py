"""The port's host partition plan (``ggnn_tpu_torch/parallel/partition.py``)
against the JAX package's, array for array (exact: the same integer
arithmetic): ``partition_batch`` through the native plan and the Python
one, with and without the hot set, ``split_local_remote``, and the halo
kernel layouts of both strategies with their common-shape pins; the plan's
invariants and its size on clustered and skewed graphs (the reference's
``tests/test_distributed.py`` and ``test_halo_locality.py``)."""

import ast
import dataclasses
import os

import numpy as np
import pytest

from ggnn_tpu.parallel import partition as JP
from ggnn_tpu_torch import native
from ggnn_tpu_torch.data.synthetic import synthetic_batch
from ggnn_tpu_torch.parallel import partition as PP

import torch_dist_cases as C


def _random_batch(seed, n_mult=8, n_graphs=4):
    rng = np.random.default_rng(seed)
    graphs = C.random_graphs(rng, 12 * n_graphs, 4, 12)
    total = sum(g["n_nodes"] for g in graphs)
    return C.batch_of(graphs, -(-total // n_mult) * n_mult)


def _community(seed=3, p_intra=0.8):
    return synthetic_batch(512, 3000, 3, annotation_dim=2, seed=seed,
                           node_mult=512, n_communities=4, p_intra=p_intra)


def _same(a, b, what=""):
    if isinstance(b, dict) or isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same(a[k], b[k], f"{what}/{k}")
    elif b is None or a is None:
        assert a is None and b is None, what
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)


def _same_parts(got, ref):
    for f in dataclasses.fields(ref):
        _same(getattr(got, f.name), getattr(ref, f.name), f.name)
    assert got.pool_rows == ref.pool_rows


BATCHES = {
    "random8": (lambda: _random_batch(0), 8),
    "random2": (lambda: _random_batch(1, n_mult=16), 2),
    "community4": (_community, 4),
    "skewed4": (lambda: C.skewed_batch(1024, 8192, 4, seed=6), 4),
}


@pytest.mark.parametrize("use_native", (None, False))
@pytest.mark.parametrize("name", sorted(BATCHES))
def test_partition_batch_matches_jax(name, use_native):
    """The plan (native by default, or the Python builder) and its split,
    array for array."""
    if use_native is None and native.compiler() is None:
        pytest.skip("no C++ compiler (g++) for the native plan")
    make, P = BATCHES[name]
    b = make()
    got = PP.split_local_remote(PP.partition_batch(b, P,
                                                   use_native=use_native))
    ref = JP.split_local_remote(JP.partition_batch(
        C.to_jax_batch(b), P, use_native=use_native))
    _same_parts(got, ref)


@pytest.mark.parametrize("hot_thresh", (2, 3))
def test_hot_set_partition_matches_jax(hot_thresh):
    """The hot-set hybrid plan (the Python builder, forced by
    ``hot_thresh``) on a hub-skewed cut, array for array; its pairwise
    plan collapses as the reference's test pins."""
    b = C.skewed_batch(1024, 16384, 8, seed=5)
    got = PP.partition_batch(b, 8, hot_thresh=hot_thresh)
    ref = JP.partition_batch(C.to_jax_batch(b), 8, hot_thresh=hot_thresh)
    _same_parts(got, ref)
    dense = PP.partition_batch(b, 8, use_native=False)
    assert got.hot_size > 0 and got.hot_idx is not None
    if hot_thresh == 3:
        assert got.halo_size < 0.5 * dense.halo_size


def test_native_and_python_plans_agree():
    b = _community(seed=5, p_intra=0.6)
    if native.compiler() is None:
        pytest.skip("no C++ compiler (g++) for the native plan")
    _same_parts(PP.partition_batch(b, 4),
                PP.partition_batch(b, 4, use_native=False))


SCATTER = [dict(tile_e=16, with_grad=True, grad_tile_e=16),
           dict(tile_e=8), dict(tile_e=128, with_grad=True)]


@pytest.mark.parametrize("hot", (False, True))
@pytest.mark.parametrize("kw", SCATTER, ids=("t16g16", "t8", "t128g"))
def test_halo_scatter_layouts_match_jax(kw, hot):
    """The stacked one-hot layouts over the pool, their common meta and
    every array (the hot set's pool rows too)."""
    b = C.skewed_batch(1024, 8192, 4, seed=6)
    part = dict(hot_thresh=2) if hot else dict(use_native=False)
    got = PP.build_halo_scatter_layouts(PP.partition_batch(b, 4, **part),
                                        **kw)
    ref = JP.build_halo_scatter_layouts(JP.partition_batch(
        C.to_jax_batch(b), 4, **part), **kw)
    assert got[1] == ref[1]
    _same(got[0], {k: np.asarray(v) for k, v in ref[0].items()})


WINDOW = {
    "src64": dict(window=64, min_edges_per_tile=4, spill_tile_e=16,
                  n_message_types=6),
    "uneven_spill": dict(window=64, min_edges_per_tile=2000,
                         spill_tile_e=16),
    "grad_src": dict(window=64, min_edges_per_tile=4, spill_tile_e=16,
                     n_message_types=6, with_grad=True),
    "grad_block": dict(window=128, min_edges_per_tile=4, spill_tile_e=16,
                       n_message_types=6, with_grad=True, row_major="block"),
    "typed_spill": dict(window=128, min_edges_per_tile=4, spill_tile_e=16,
                        n_message_types=6, row_major="block",
                        typed_spill=True),
    "on_demand": dict(window=128, min_edges_per_tile=4, spill_tile_e=None,
                      n_message_types=6, with_grad=True, row_major="block",
                      on_demand=True),
    "grad_quant": dict(window=128, min_edges_per_tile=4, spill_tile_e=16,
                       n_message_types=6, with_grad=True, row_major="block",
                       grad_quant=True),
}


@pytest.mark.parametrize("name", sorted(WINDOW))
def test_halo_window_layouts_match_jax(name):
    """The stacked window layouts of the shard-local edges with the
    cross-shard pins (tile counts, spill packs, spill tile, XW buckets, the
    grad half's tiles and buckets): meta and every array."""
    b = _community(seed=5, p_intra=0.6)
    got_p = PP.split_local_remote(PP.partition_batch(b, 4))
    ref_p = JP.split_local_remote(JP.partition_batch(C.to_jax_batch(b), 4))
    got = PP.build_halo_window_layouts(got_p, **WINDOW[name])
    ref = JP.build_halo_window_layouts(ref_p, **WINDOW[name])
    assert got[1] == ref[1]
    _same(got[0], {k: np.asarray(v) for k, v in ref[0].items()})


def test_halo_layouts_refuse_unaligned_shards():
    parts = PP.partition_batch(_random_batch(0), 8, use_native=False)
    with pytest.raises(ValueError, match="n_local % 128"):
        PP.build_halo_scatter_layouts(parts)
    with pytest.raises(ValueError, match="split_local_remote"):
        PP.build_halo_window_layouts(parts)


def test_local_rows_and_layouts():
    """A rank's row: every array at index ``rank`` of the stacked host
    form, on the device asked for."""
    b = _community()
    parts = PP.split_local_remote(PP.partition_batch(b, 4))
    lay = PP.build_halo_window_layouts(parts, window=64,
                                       min_edges_per_tile=4,
                                       spill_tile_e=16, n_message_types=6)
    lp = parts.local(2, "cpu")
    assert (lp.n_shards, lp.n_local, lp.halo_size) == (
        4, parts.n_local, parts.halo_size)
    np.testing.assert_array_equal(lp.send_idx.numpy(),
                                  parts.halo_send_idx[2])
    np.testing.assert_array_equal(lp.local_edges["src"].numpy(),
                                  parts.local_edges["src"][2])
    wl = PP.local_halo_layout(lay, 2, "cpu")
    assert wl.meta == lay[1]["full_meta"]
    for k, v in lay[0].items():
        np.testing.assert_array_equal(wl.arrays[k].numpy(), v[2])


def test_partition_invariants():
    """Every real directed edge once, on its dst's shard; the pool
    coordinates round-trip to the global source (self-edges past P·H);
    edges in type order (the reference's test)."""
    b = _random_batch(0)
    P = 8
    parts = PP.partition_batch(b, P, use_native=False)
    assert parts.n_local * P == b.spec.n_pad
    assert int(parts.edge_mask.sum()) == int(b.edge_mask.sum())
    for s in range(P):
        m = parts.edge_mask[s] > 0
        dl = parts.edge_dst_local[s, m]
        assert ((dl >= 0) & (dl < parts.n_local)).all()
        halo = parts.edge_src_halo[s, m]
        PH = P * parts.halo_size
        is_local = halo >= PH
        owner = np.where(is_local, s, halo // parts.halo_size)
        pos = halo % parts.halo_size
        back = np.where(is_local, s * parts.n_local + (halo - PH),
                        owner * parts.n_local
                        + parts.halo_send_idx[owner, s, pos])
        np.testing.assert_array_equal(back, parts.edge_src_global[s, m])
        np.testing.assert_array_equal(
            is_local, parts.edge_src_global[s, m] // parts.n_local == s)
        et = parts.edge_type[s, m]
        assert (np.diff(et) >= 0).all()
        np.testing.assert_array_equal(
            np.diff(parts.type_offsets[s]),
            np.bincount(et, minlength=b.spec.n_message_types))
    np.testing.assert_array_equal(
        parts.annotations.reshape(-1, b.spec.annotation_dim), b.annotations)


def test_clustered_halo_is_smaller():
    """Community graphs shrink the deduplicated exchange."""
    P = 8
    uni = synthetic_batch(4096, 32768, 4, annotation_dim=2, seed=0,
                          node_mult=P * 8)
    clu = synthetic_batch(4096, 32768, 4, annotation_dim=2, seed=0,
                          node_mult=P * 8, n_communities=P, p_intra=0.95)
    assert (PP.partition_batch(clu, P).halo_size
            < 0.5 * PP.partition_batch(uni, P).halo_size)


def test_halo_plan_size_scaling_skewed():
    """The dense [P, P, H] plan on a skewed cut at P = 32 and 64: its waste
    against the true requests and its bytes, as the reference pins."""
    n_nodes, n_edges = 8192, 65536
    stats = {}
    for P in (32, 64):
        b = C.skewed_batch(n_nodes, n_edges, P)
        parts = PP.partition_batch(b, P)
        plan = parts.halo_send_idx
        assert plan.shape == (P, P, parts.halo_size)
        n_local = n_nodes // P
        src, dst = b.edge_src.astype(np.int64), b.edge_dst.astype(np.int64)
        total = 0
        for s in range(P):
            es = src[dst // n_local == s]
            owners = es // n_local
            for o in range(P):
                if o != s:
                    total += np.unique(es[owners == o] - o * n_local).size
        stats[P] = (parts.halo_size, P * P * parts.halo_size / total)
        assert stats[P][1] > 3.0 and plan.nbytes < 64 * 1024 * 1024
    assert stats[64][0] <= stats[32][0]


def test_rank_worker_imports_no_jax():
    """The rank worker runs the port alone: no import of ``jax`` or
    ``ggnn_tpu`` at any depth."""
    path = os.path.join(os.path.dirname(__file__), "torch_dist_worker.py")
    tree = ast.parse(open(path).read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names
                  if n.split(".")[0] in ("jax", "jaxlib", "ggnn_tpu")]
    assert not found, found
