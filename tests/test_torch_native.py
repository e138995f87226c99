"""The port's native host library (``ggnn_tpu_torch/native``: its own copy
of ``ggnn_host.cpp``, built by g++ at first use into
``ggnn_tpu_torch/_build/``) against the port's numpy paths and against the
JAX package's library (``ggnn_tpu.native``) on the same inputs, array for
array (exact: the same integer arithmetic), as ``tests/test_native.py``
holds the reference; the thresholds at which ``batch_graphs``'s sort and
``build_window_layout`` pick it; and the raises where it cannot be built.
The tests skip only where there is no C++ compiler."""

import numpy as np
import pytest

from ggnn_tpu import native as jax_native
from ggnn_tpu.data.babi import TASKS as JAX_TASKS
from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu.parallel import partition as JP
from ggnn_tpu_torch import graph as GR
from ggnn_tpu_torch import native
from ggnn_tpu_torch.data.babi import TASKS, parse_graph_text
from ggnn_tpu_torch.data.generators import generate_task_file
from ggnn_tpu_torch.ops import window as W

pytestmark = pytest.mark.skipif(native.compiler() is None,
                                reason="no C++ compiler (g++) available")


def _jax_library():
    if not jax_native.build():
        pytest.fail("the JAX package's native library did not build "
                    "where the port's compiler exists")


@pytest.mark.parametrize("task_id", sorted(TASKS))
def test_native_parser_matches_python(task_id):
    """The native parser against the port's ``parse_graph_text`` and the
    JAX package's native parser, example for example."""
    _jax_library()
    text = generate_task_file(task_id, 25, seed=42)
    py = parse_graph_text(text, TASKS[task_id])
    cc = native.parse_graph_text_native(text, TASKS[task_id])
    ref = jax_native.parse_graph_text_native(text, JAX_TASKS[task_id])
    assert len(py) == len(cc) == len(ref) > 0
    for a, b, c in zip(py, cc, ref):
        assert a.n_nodes == b.n_nodes == c.n_nodes
        assert a.question_type == b.question_type == c.question_type
        assert a.args == b.args == c.args
        for x, y in ((a.edges, b.edges), (b.edges, c.edges),
                     (a.target, b.target), (b.target, c.target)):
            np.testing.assert_array_equal(x, y)


def _sorts(src, dst, typ, T):
    _jax_library()
    return (GR.lexsort_edges(src, dst, typ, T),
            native.sort_edges_native(src, dst, typ, T),
            jax_native.sort_edges_native(src, dst, typ, T))


def test_native_sort_edges_matches_python(rng):
    n, T = 5000, 9
    outs = _sorts(rng.integers(0, 300, n), rng.integers(0, 300, n),
                  rng.integers(0, T, n), T)
    for got in outs[1:]:
        for x, y in zip(outs[0], got):
            np.testing.assert_array_equal(x, y)


def test_native_sort_fuzz(rng):
    """Larger random sorts with empty types and duplicates, both of the
    library's sorts (the radix sort from 4,096 edges, the comparison sort
    below)."""
    for _ in range(5):
        n = int(rng.integers(1, 20000))
        T = int(rng.integers(1, 12))
        outs = _sorts(rng.integers(0, 500, n), rng.integers(0, 500, n),
                      rng.integers(0, max(1, T - 2), n), T)
        for got in outs[1:]:
            for x, y in zip(outs[0], got):
                np.testing.assert_array_equal(x, y)


def test_batch_graphs_sorts_natively_from_the_threshold(rng, monkeypatch):
    """``batch_graphs`` sorts in the library from
    ``NATIVE_SORT_THRESHOLD`` directed edges on (the reference's 4,096),
    with the numpy path below; either way its batch equals the JAX
    package's array for array."""
    calls = []
    sort = native.sort_edges_native
    monkeypatch.setattr(native, "sort_edges_native",
                        lambda *a: (calls.append(a[0].shape[0]), sort(*a))[1])
    for m in (GR.NATIVE_SORT_THRESHOLD // 2 - 100, 3000):
        n = 700
        g = dict(n_nodes=n, edges=np.stack(
            [rng.integers(0, n, m), rng.integers(0, 3, m),
             rng.integers(0, n, m)], axis=1),
            annotations=np.ones((n, 2), np.float32), targets={})
        kw = dict(n_graphs=1, n_pad=n, e_pad=2 * m, n_edge_types=3,
                  annotation_dim=2)
        got = GR.batch_graphs([g], GR.PaddingSpec(**kw))
        ref = jax_batch_graphs([g], JaxSpec(**kw))
        for k in ("edge_src", "edge_dst", "edge_type", "edge_mask",
                  "type_offsets"):
            np.testing.assert_array_equal(getattr(got, k), getattr(ref, k))
    assert calls == [6000]


def test_native_halo_plan_matches_python(rng, monkeypatch):
    """The port's halo plan against the JAX package's library on the same
    real edges, and, put in its place, against the reference's numpy
    partition core (``partition_batch(use_native=False)``)."""
    _jax_library()
    graphs = []
    for _ in range(4):
        n = int(rng.integers(6, 14))
        m = int(rng.integers(4, 3 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    total_n = sum(g["n_nodes"] for g in graphs)
    spec = JaxSpec(n_graphs=4, n_pad=((total_n + 31) // 32) * 32,
                   e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                   n_edge_types=3, annotation_dim=2).round_up()
    b = jax_batch_graphs(graphs, spec)
    real = b.edge_mask > 0
    args = (b.edge_src[real], b.edge_dst[real], b.edge_type[real], 8,
            spec.n_pad // 8, 6)
    got, ref = native.halo_plan_native(*args), jax_native.halo_plan_native(
        *args)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    py = JP.partition_batch(b, 8, use_native=False)
    monkeypatch.setattr(jax_native, "halo_plan_native",
                        native.halo_plan_native)
    cc = JP.partition_batch(b, 8, use_native=True)
    assert py.halo_size == cc.halo_size and py.n_local == cc.n_local
    for name in ("edge_src_global", "edge_src_halo", "edge_dst_local",
                 "edge_type", "edge_mask", "type_offsets", "halo_send_idx"):
        np.testing.assert_array_equal(getattr(py, name), getattr(cc, name),
                                      err_msg=name)


def _window_inputs(rng):
    N, E, T2 = 512, 5000, 6
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    typ = rng.integers(0, T2, E).astype(np.int32)
    mask = (rng.random(E) > 0.1).astype(np.float32)
    # a heavily repeated edge: the saturation spill
    src[:40] = 3
    dst[:40] = 7
    typ[:40] = 1
    mask[:40] = 1.0
    return (src, dst, typ, mask, N), T2


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("with_grad", [False, True])
def test_native_window_layout_matches_python(rng, pack, with_grad):
    """``build_window_layout(use_native=True)``: the same meta, stats and
    arrays as the numpy path and as the JAX package's native build, with
    the saturation spill, int4 packing, the grad half and a static tile
    budget."""
    _jax_library()
    args, T2 = _window_inputs(rng)
    kw = dict(window=256, min_edges_per_tile=3, spill_tile_e=8,
              n_message_types=T2, block_rows=256, with_grad=with_grad,
              pack_counts=pack, pad_tiles_to=64)
    py = W.build_window_layout(*args, use_native=False, **kw)
    cc = W.build_window_layout(*args, use_native=True, **kw)
    ref = WP.build_window_layout(*args, use_native=True, **kw)
    assert py.meta == cc.meta == ref.meta
    assert py.stats == cc.stats == ref.stats
    assert set(py.arrays) == set(cc.arrays) == set(ref.arrays)
    for k in py.arrays:
        np.testing.assert_array_equal(py.arrays[k], cc.arrays[k], err_msg=k)
        np.testing.assert_array_equal(cc.arrays[k], np.asarray(ref.arrays[k]),
                                      err_msg=k)


@pytest.mark.parametrize("layout", ["xw_spill", "no_tile"])
def test_native_window_layout_seams(rng, layout):
    """The native plan at its seams: the XW spill of block-major rows (the
    backward reads the forward stream), and a layout of src-major rows
    where no tile is dense (every edge spills; the transposed stream has
    no real tile)."""
    args, T2 = _window_inputs(rng)
    xw = layout == "xw_spill"
    kw = dict(window=128, n_message_types=T2, with_grad=True,
              row_major="block" if xw else "src", typed_spill=xw,
              min_edges_per_tile=3 if xw else 10 ** 6)
    py = W.build_window_layout(*args, use_native=False, **kw)
    cc = W.build_window_layout(*args, use_native=True, **kw)
    assert py.meta == cc.meta and py.stats == cc.stats
    assert set(py.arrays) == set(cc.arrays)
    for k in py.arrays:
        np.testing.assert_array_equal(py.arrays[k], cc.arrays[k], err_msg=k)


def test_window_layout_picks_native_from_the_threshold(rng, monkeypatch):
    """``use_native=None`` plans in the library from ``NATIVE_PLAN_EDGES``
    real edges on (the reference's 200,000) and in numpy below."""
    made = []
    plan = native.WindowPlanNative

    class Spy(plan):
        def __init__(self, *a, **k):
            made.append(len(a[0]))
            super().__init__(*a, **k)
    monkeypatch.setattr(native, "WindowPlanNative", Spy)
    args, T2 = _window_inputs(rng)
    n_real = int((args[3] > 0).sum())
    for limit in (n_real + 1, n_real):
        monkeypatch.setattr(W, "NATIVE_PLAN_EDGES", limit)
        W.build_window_layout(*args, window=256, n_message_types=T2)
    assert made == [n_real]


def test_no_silent_fallback(rng, monkeypatch, tmp_path):
    """Where the library cannot be built, every path that asks for it (or
    whose size picks it) raises with the compiler's message; none falls
    back to numpy.  A key space past the plan's bound raises with
    ``use_native=True``."""
    args, T2 = _window_inputs(rng)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")          # a compiler that fails
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.library()
    with pytest.raises(native.NativeBuildError):
        W.build_window_layout(*args, window=256, n_message_types=T2,
                              use_native=True)
    n = GR.NATIVE_SORT_THRESHOLD
    with pytest.raises(native.NativeBuildError):
        GR._sort_edges(np.zeros(n), np.zeros(n), np.zeros(n), 2)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.library()
    # the numpy paths need no compiler
    GR._sort_edges(np.zeros(n - 1), np.zeros(n - 1), np.zeros(n - 1), 2)
    W.build_window_layout(*args, window=256, n_message_types=T2)
    monkeypatch.undo()
    assert not native.WindowPlanNative.fits(512, 512, 2 ** 25, 2 ** 20)
    with pytest.raises(ValueError, match="overflow"):
        native.WindowPlanNative(np.zeros(1), np.zeros(1), 512, 512, 2 ** 25,
                                2 ** 20, 1, 127)
