"""The port's NumPy oracle (``ggnn_tpu_torch/oracle``) against the JAX
package's (``ggnn_tpu.oracle``), and the port's CPU forward on every
backend and head against it.

- Every export and helper of the port's oracle gives the same bits as the
  JAX package's on ``tests/test_oracle_parity.py``'s random graphs, with
  the port's parameters (``params_to_numpy``) in f64.
- The port's ``forward`` (f32, on the CPU: the kernels' plain versions) on
  the xla, pallas, onehot and window backends, for every head (GGS-NN with
  both outputs), and ``propagate``'s per-step states, against the port's
  oracle per graph: rtol 2e-5, atol 2e-6 (GGS-NN 3e-5, 3e-6), the
  tolerances of ``tests/test_oracle_parity.py``.
"""

import numpy as np
import pytest
import torch

import ggnn_tpu.oracle as JO
import ggnn_tpu.oracle.numpy_ggnn as JN
import ggnn_tpu_torch.oracle as TO
import ggnn_tpu_torch.oracle.numpy_ggnn as TN
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.models import ModelConfig, propagate
from ggnn_tpu_torch.models.api import forward
from ggnn_tpu_torch.models.init import (init_params, params_from_numpy,
                                        params_to_numpy)
from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)

E, A, D, T, K, V = 3, 2, 4, 4, 3, 5
EXPORTS = ("oracle_propagate", "oracle_propagate_dense", "dense_adjacency",
           "oracle_node_select", "oracle_per_node", "oracle_graph_gated",
           "oracle_ggsnn")
HELPERS = ("aggregate", "directed_edges", "gru_update", "init_state",
           "graph_gated_pool", "annotation_update")


def rand_graph(r, n_lo=3, n_hi=9):
    """``tests/test_oracle_parity.py::rand_graph``."""
    n = int(r.integers(n_lo, n_hi))
    m = int(r.integers(1, 2 * n))
    edges = np.stack([r.integers(0, n, m), r.integers(0, E, m),
                      r.integers(0, n, m)], axis=1)
    ann = (r.random((n, A)) < 0.4).astype(np.float32)
    return dict(n_nodes=n, edges=edges, annotations=ann, targets={})


def f64(tree):
    if isinstance(tree, dict):
        return {k: f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def np_params(head="ggsnn", seed=0, **kw):
    cfg = ModelConfig(state_dim=D, annotation_dim=A, n_edge_types=E,
                      n_steps=T, head=head, n_classes=V, n_rounds=K, **kw)
    return cfg, params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(seed)))


def test_oracle_exports_are_the_reference_names():
    """The same seven exports as ``ggnn_tpu.oracle`` and the helpers."""
    assert sorted(n for n in dir(JO) if n.startswith(("oracle_", "dense_"))
                  ) == sorted(n for n in dir(TO)
                              if n.startswith(("oracle_", "dense_")))
    for name in EXPORTS:
        assert getattr(TO, name) is getattr(TN, name)
    for name in HELPERS:
        assert callable(getattr(TN, name))


@pytest.mark.parametrize("name", EXPORTS + HELPERS)
@pytest.mark.parametrize("gates", [False, True])
def test_oracle_bit_equal_to_reference(name, gates):
    """Each function of the port's oracle against the JAX package's on the
    same f64 inputs: the same bits."""
    r = np.random.default_rng(11 + gates)
    g = rand_graph(r)
    _, params = np_params(edge_gates=gates)
    params = f64(params)
    prop, x, edges = params["prop"], g["annotations"], g["edges"]
    h = r.standard_normal((g["n_nodes"], D))
    de = JN.directed_edges(edges, E)
    args = {
        "oracle_propagate": (prop, x, edges, E, T),
        "oracle_propagate_dense": (prop, x, edges, E, T),
        "dense_adjacency": (g["n_nodes"], edges, E),
        "oracle_node_select": (np_params("node_select")[1]["head"], h, x),
        "oracle_per_node": (np_params("per_node")[1]["head"], h, x),
        "oracle_graph_gated": (np_params("graph_gated")[1]["head"], h, x),
        "oracle_ggsnn": (params, x, edges, E, T, K),
        "aggregate": (h, de, prop["msg_w"], prop["msg_b"],
                      prop.get("gate_p"), prop.get("gate_q")),
        "directed_edges": (edges, E),
        "gru_update": (prop["gru"], h, r.standard_normal(h.shape)),
        "init_state": (x, D),
        "graph_gated_pool": (params["out"], h, x),
        "annotation_update": (params["ann"], h, x),
    }[name]
    args = tuple(f64(a) if isinstance(a, dict) else a for a in args)
    got, ref = getattr(TN, name)(*args), getattr(JN, name)(*args)

    def flat(x):
        if isinstance(x, (list, tuple)):
            return [y for v in x for y in flat(v)]
        return [np.asarray(x)]
    for a, b in zip(flat(got), flat(ref), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def _batch(seed, n_pad=128):
    """Four random graphs in one batch of ``n_pad`` rows (a multiple of
    128, as the onehot and window layouts want)."""
    r = np.random.default_rng(seed)
    graphs = [rand_graph(r) for _ in range(4)]
    spec = PaddingSpec(n_graphs=4, n_pad=n_pad,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 6,
                       n_edge_types=E, annotation_dim=A).round_up()
    return graphs, batch_graphs(graphs, spec)


_ARRAYS = ("annotations", "node_graph", "node_mask", "edge_src", "edge_dst",
           "edge_type", "edge_mask", "n_nodes", "type_offsets")


def _layout(backend, b):
    if backend != "window":
        return None           # onehot: the reference's default legacy one
    return W.build_window_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        window=64, min_edges_per_tile=4, n_message_types=2 * E,
        use_native=False)


BACKENDS = ("xla", "pallas", "onehot", "window")
HEADS = ("node_select", "per_node", "graph_gated", "ggsnn_graph",
         "ggsnn_node")


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_matches_oracle(backend, head):
    """The port's f32 forward on the CPU per graph against the port's f64
    oracle with the same (f32-valued) parameters."""
    graphs, b = _batch(5)
    name, output = (("ggsnn", head[6:]) if head.startswith("ggsnn")
                    else (head, ""))
    cfg, params = np_params(name, seed=2, backend=backend,
                            ggsnn_output=output or "graph")
    arrays = {k: torch.as_tensor(getattr(b, k)) for k in _ARRAYS}
    with torch.no_grad():
        out = forward(params_from_numpy(params), cfg, arrays,
                      b.spec.n_graphs,
                      scatter_layout=_layout(backend, b)).numpy()
    p64 = f64(params)
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        sl = slice(offs[gi], offs[gi] + g["n_nodes"])
        x = g["annotations"]
        if name == "ggsnn":
            refs = TO.oracle_ggsnn(p64, x, g["edges"], E, T, K,
                                   output=output)[0]
            for k in range(K):
                got = out[k, sl] if output == "node" else out[k, gi]
                np.testing.assert_allclose(got, refs[k], rtol=3e-5,
                                           atol=3e-6)
            continue
        h = TO.oracle_propagate(p64["prop"], x, g["edges"], E, T)[-1]
        if name == "node_select":
            got, ref = out[sl], TO.oracle_node_select(p64["head"], h, x)
        elif name == "per_node":
            got, ref = out[sl], TO.oracle_per_node(p64["head"], h, x)
        else:
            got, ref = out[gi], TO.oracle_graph_gated(p64["head"], h, x)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("backend,gates", [(b, False) for b in BACKENDS]
                         + [("xla", True), ("pallas", True)])
def test_propagate_states_match_oracle(backend, gates):
    """Every step's state of the port's ``propagate`` against the oracle's
    (the SDDMM gates on xla and pallas too)."""
    graphs, b = _batch(7)
    cfg, params = np_params("node_select", seed=3, backend=backend,
                            edge_gates=gates)
    prop = params_from_numpy(params)["prop"]
    with torch.no_grad():
        _, states = propagate(
            prop, cfg, *(torch.as_tensor(getattr(b, k)) for k in (
                "annotations", "edge_src", "edge_dst", "edge_type",
                "edge_mask")), collect_states=True,
            type_offsets=torch.as_tensor(b.type_offsets),
            scatter_layout=_layout(backend, b))
    states = states.numpy()
    p64 = f64(params)
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        ref = TO.oracle_propagate(p64["prop"], g["annotations"], g["edges"],
                                  E, T)
        for t in range(T):
            np.testing.assert_allclose(
                states[t, offs[gi]:offs[gi] + g["n_nodes"]], ref[t + 1],
                rtol=2e-5, atol=2e-6)
