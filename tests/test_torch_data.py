"""The port's own copies of the JAX package's numpy-only modules
(``ggnn_tpu_torch.graph`` and ``ggnn_tpu_torch.data``) against the
originals, and the port's independence from the JAX package.

Every comparison here is exact: the copies do integer bookkeeping and the
same seeded numpy draws, so each array must be equal in value and dtype."""

import ast
import dataclasses
import os

import numpy as np
import pytest

from ggnn_tpu import graph as jax_graph
from ggnn_tpu.data import babi as jax_babi
from ggnn_tpu.data import generators as jax_gen
from ggnn_tpu.data import loader as jax_loader
from ggnn_tpu.data import synthetic as jax_synth
from ggnn_tpu_torch import graph as port_graph
from ggnn_tpu_torch.data import babi as port_babi
from ggnn_tpu_torch.data import generators as port_gen
from ggnn_tpu_torch.data import loader as port_loader
from ggnn_tpu_torch.data import synthetic as port_synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    root = os.path.join(REPO, "ggnn_tpu_torch")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_never_imports_the_jax_package():
    """No module of the port and nothing in chip_smoke.py imports
    ``ggnn_tpu`` or ``jax`` (every import statement, at any depth)."""
    found = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("ggnn_tpu", "jax", "jaxlib"):
                    found.append(f"{os.path.relpath(path, REPO)}:"
                                 f"{node.lineno} imports {name}")
    assert not found, "\n".join(found)
    assert len(list(_port_sources())) > 20


def _assert_batches_equal(got, ref):
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(ref.spec)
    for f in dataclasses.fields(ref):
        if f.name == "spec":
            continue
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), f.name
            for k in b:
                assert a[k].dtype == b[k].dtype, (f.name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def _graphs(seed, k, n_types, max_n=12, max_e=30):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(r.integers(1, max_n))
        m = int(r.integers(0, max_e))
        out.append(dict(
            n_nodes=n,
            edges=np.stack([r.integers(0, n, m), r.integers(0, n_types, m),
                            r.integers(0, n, m)], 1),
            annotations=(r.random((n, 3)) < 0.4).astype(np.float32),
            targets={"node": np.array(r.integers(0, n), np.int32),
                     "seq": r.integers(0, 5, int(r.integers(1, 4)))},
            node_targets={"ann": r.random((n, 2)).astype(np.float32)}))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_graphs_matches_reference(seed):
    """batch_graphs (with target pads and node targets) array for array,
    with a batch large enough that the reference's sort may take its C++
    path, which the port replaces by numpy's lexsort."""
    graphs = _graphs(seed, 6, 4)
    graphs.append(dict(n_nodes=3000, annotations=np.zeros((3000, 3)),
                       edges=np.stack([np.arange(5000) % 3000,
                                       np.arange(5000) % 4,
                                       (np.arange(5000) * 7) % 3000], 1)))
    kw = dict(n_graphs=8, n_pad=3200, e_pad=12000, n_edge_types=4,
              annotation_dim=3)
    pads = {"seq": ((4,), -1)}
    ref = jax_graph.batch_graphs(graphs, jax_graph.PaddingSpec(**kw), pads)
    got = port_graph.batch_graphs(graphs, port_graph.PaddingSpec(**kw), pads)
    _assert_batches_equal(got, ref)
    assert port_graph.PaddingSpec(**kw).round_up(16, 64) == \
        port_graph.PaddingSpec(**dataclasses.asdict(
            jax_graph.PaddingSpec(**kw).round_up(16, 64)))


@pytest.mark.parametrize("kind", ["uniform", "communities", "powerlaw"])
def test_synthetic_batch_matches_reference(kind):
    kw = {"uniform": {}, "communities": dict(n_communities=8, p_intra=0.8),
          "powerlaw": dict(powerlaw_alpha=1.2)}[kind]
    ref = jax_synth.synthetic_batch(1000, 6000, 4, annotation_dim=5, seed=3,
                                    node_mult=128, **kw)
    got = port_synth.synthetic_batch(1000, 6000, 4, annotation_dim=5, seed=3,
                                     node_mult=128, **kw)
    _assert_batches_equal(got, ref)


@pytest.mark.parametrize("task_id", [4, 15, 16, 18, 19])
def test_babi_generators_and_parser_match_reference(task_id, tmp_path):
    """The generators write the same text; the parser, the example→graph
    conversion, the dataset and the loader give the same batches."""
    text = port_gen.generate_task_file(task_id, 12, seed=5)
    assert text == jax_gen.generate_task_file(task_id, 12, seed=5)
    t_spec, j_spec = port_babi.TASKS[task_id], jax_babi.TASKS[task_id]
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    got = port_babi.examples_to_graphs(
        port_babi.parse_graph_text(text, t_spec), t_spec)
    ref = jax_babi.examples_to_graphs(
        jax_babi.parse_graph_text(text, j_spec), j_spec)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            for a, b in ((g[k], r[k]),) if not isinstance(r[k], dict) else \
                    ((g[k][n], r[k][n]) for n in r[k]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    root_t, root_j = str(tmp_path / "t"), str(tmp_path / "j")
    port_gen.generate_all(root_t, tasks=(task_id,), n_train=10, n_test=5,
                          seed=1)
    jax_gen.generate_all(root_j, tasks=(task_id,), n_train=10, n_test=5,
                         seed=1)
    qid = 0 if t_spec.n_question_types > 1 else None
    dt = port_babi.BabiDataset(root_t, task_id, "train", question_id=qid)
    dj = jax_babi.BabiDataset(root_j, task_id, "train", question_id=qid)
    assert len(dt) == len(dj)
    assert dt.target_pads() == dj.target_pads()
    assert dataclasses.asdict(dt.padding_spec(4)) == \
        dataclasses.asdict(dj.padding_spec(4))
    lt = port_loader.BatchLoader(dt.graphs, dt.padding_spec(4),
                                 dt.target_pads(), seed=2)
    lj = jax_loader.BatchLoader(dj.graphs, dj.padding_spec(4),
                                dj.target_pads(), seed=2)
    bt, bj = list(lt.epoch_batches(1)), list(lj.epoch_batches(1))
    assert len(bt) == len(bj) == len(lt)
    for a, b in zip(bt, bj):
        _assert_batches_equal(a, b)
