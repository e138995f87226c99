"""The port's serving slice against the JAX package and the NumPy oracle:
``propagate`` (xla; onehot fused and unfused), ``forward`` for three heads,
and ``Predictor``.  The same numpy parameters and graphs go to both
packages; on the CPU the port's kernel wrappers run their plain versions
and the JAX package runs its Pallas kernels in interpret mode.

Tolerances: f32 rtol = atol = 2e-5 (the same math over two steps, sums in
another order); bf16 atol = 2**-7, one bf16 ulp at 1.0, for a state whose
gate inputs land on the other side of a rounding boundary; the oracle runs
in f64 and the f32 paths meet it at 1e-4 over three steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec, batch_graphs
from ggnn_tpu.infer import Predictor as JaxPredictor
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import forward as jax_forward
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.oracle import oracle_propagate
from ggnn_tpu.ops.scatter_pallas import build_typed_dst_layout as jax_layout
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import (ModelConfig, forward, params_from_numpy,
                                   propagate)
from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout

torch.set_num_threads(1)
BF16_ULP = 2.0 ** -7


def _np_params(cfg_kw, seed=0):
    params = jax_init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw))
    return jax.tree.map(np.asarray, params)


def _edges(seed, N, E, T2):
    r = np.random.default_rng(seed)
    return (r.integers(0, N, E).astype(np.int32),
            r.integers(0, N, E).astype(np.int32),
            r.integers(0, T2, E).astype(np.int32),
            (r.random(E) < 0.9).astype(np.float32))


MODES = {
    # name: (backend, fuse_gru, compute_dtype)
    "xla_f32": ("xla", False, "float32"),
    "xla_bf16": ("xla", False, "bfloat16"),
    "onehot_f32": ("onehot", False, "float32"),
    "onehot_bf16": ("onehot", False, "bfloat16"),
    "onehot_fused_f32": ("onehot", True, "float32"),
    "onehot_fused_bf16": ("onehot", True, "bfloat16"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_propagate_matches_jax(mode):
    """Per-step states of the port's propagate against the JAX package's
    with the same typed layout, at D = 128 (the kernels' width)."""
    backend, fuse, cdt = MODES[mode]
    N, E, T, D = 512, 3000, 3, 128
    kw = dict(state_dim=D, annotation_dim=4, n_edge_types=T, n_steps=2,
              backend=backend, fuse_gru=fuse, compute_dtype=cdt)
    params = _np_params(kw)
    edges = _edges(0, N, E, 2 * T)
    ann = (np.random.default_rng(1).random((N, 4)) < 0.4).astype(np.float32)
    lay_j = lay_t = None
    if backend == "onehot":
        lay_j = jax_layout(*edges, N, 2 * T)
        lay_t = build_typed_dst_layout(*edges, N, 2 * T).to("cpu")
    _, ref = jax_propagate(params["prop"], JaxConfig(**kw), jnp.asarray(ann),
                           *map(jnp.asarray, edges), collect_states=True,
                           scatter_layout=lay_j)
    _, got = propagate(params_from_numpy(params["prop"]), ModelConfig(**kw),
                       torch.tensor(ann), *map(torch.tensor, edges),
                       collect_states=True, scatter_layout=lay_t)
    assert got.shape == (2, N, D) and got.dtype == torch.float32
    tol = BF16_ULP if cdt == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=tol)


@pytest.mark.parametrize("backend", ["xla", "onehot"])
def test_propagate_matches_oracle_per_step(backend):
    """f32 per-step states against the dense NumPy oracle (f64)."""
    r = np.random.default_rng(5)
    n, T, D = 40, 3, 8
    edges = np.stack([r.integers(0, n, 70), r.integers(0, T, 70),
                      r.integers(0, n, 70)], axis=1)
    ann = (r.random((n, 2)) < 0.5).astype(np.float32)
    spec = PaddingSpec(n_graphs=1, n_pad=128, e_pad=160, n_edge_types=T,
                       annotation_dim=2)
    batch = batch_graphs([dict(n_nodes=n, edges=edges, annotations=ann)],
                         spec)
    kw = dict(state_dim=D, annotation_dim=2, n_edge_types=T, n_steps=3,
              backend=backend)
    params = _np_params(kw, seed=3)
    want = oracle_propagate(params["prop"], ann.astype(np.float64), edges,
                            T, 3)
    _, got = propagate(params_from_numpy(params["prop"]), ModelConfig(**kw),
                       torch.tensor(batch.annotations),
                       torch.tensor(batch.edge_src),
                       torch.tensor(batch.edge_dst),
                       torch.tensor(batch.edge_type),
                       torch.tensor(batch.edge_mask), collect_states=True)
    for t in range(3):
        np.testing.assert_allclose(got[t, :n].numpy(), want[t + 1],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {t}")


def _batch(rng, k, spec):
    graphs = []
    for _ in range(k):
        n = int(rng.integers(5, 12))
        m = int(rng.integers(4, 2 * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, 3, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, 2)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    return graphs


SPEC = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                   annotation_dim=2).round_up()


@pytest.mark.parametrize("head", ["node_select", "per_node", "graph_gated"])
def test_forward_heads_match_jax(head, rng):
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              head=head, n_classes=1 if head == "node_select" else 3)
    params = _np_params(kw, seed=2)
    batch = batch_graphs(_batch(rng, 4, SPEC), SPEC)
    arrays = {k: v for k, v in batch.arrays.items() if k != "targets"}
    ref = jax_forward(params, JaxConfig(**kw),
                      {k: jnp.asarray(v) for k, v in arrays.items()}, 4)
    got = forward(params_from_numpy(params), ModelConfig(**kw),
                  {k: torch.tensor(v) for k, v in arrays.items()}, 4)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("backend", ["xla", "onehot"])
def test_predictor_matches_jax(backend, rng):
    """The same params serve the same answers through both Predictors (the
    JAX one builds its legacy onehot layout, the port the typed pack: the
    same function)."""
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              head="node_select", backend=backend)
    params = _np_params(kw, seed=4)
    graphs = _batch(rng, 7, SPEC)
    pj = JaxPredictor(JaxConfig(**kw), SPEC,
                      params=jax.tree.map(jnp.asarray, params))
    pt = Predictor(ModelConfig(**kw), SPEC, params=params, device="cpu")
    assert pt.predict(graphs) == pj.predict(graphs)
    batch = batch_graphs(graphs[:4], SPEC)
    ref = pj._fwd(pj.params, jax.tree.map(jnp.asarray, batch.arrays),
                  pj._layout(batch))
    np.testing.assert_allclose(pt.run_batch(batch), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("strategy", ["node_transform", "edge_gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_typed_aggregate_matches_jax(strategy, dtype):
    """The plain aggregation (the xla backend) against the JAX package's;
    products of compute-dtype inputs are exact in f32, so only the f32 sum
    order differs: rtol = atol = 2e-5 (values ~10)."""
    from ggnn_tpu.ops.segment import typed_aggregate as jax_agg
    from ggnn_tpu_torch.ops.segment import typed_aggregate
    r = np.random.default_rng(9)
    N, E, T2, D = 96, 700, 4, 16
    src, dst, typ, mask = _edges(9, N, E, T2)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * 0.3).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax_agg(jnp.asarray(h, jdt), jnp.asarray(src), jnp.asarray(dst),
                  jnp.asarray(typ), jnp.asarray(mask), jnp.asarray(w, jdt),
                  jnp.asarray(b, jdt), strategy=strategy)
    got = typed_aggregate(torch.tensor(h).to(tdt), torch.tensor(src),
                          torch.tensor(dst), torch.tensor(typ),
                          torch.tensor(mask), torch.tensor(w).to(tdt),
                          torch.tensor(b).to(tdt), strategy=strategy)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref, np.float32),
                               rtol=2e-5, atol=2e-5)


def test_predictor_for_task_matches_jax():
    """for_task builds the same config and padding spec as the JAX
    package's, and with the JAX model's parameters serves bAbI task 4 with
    the same answers."""
    from ggnn_tpu.data.babi import TASKS, examples_to_graphs, parse_graph_text
    from ggnn_tpu.data.generators import generate_task_file
    pj = JaxPredictor.for_task(4, batch_size=4)
    pt = Predictor.for_task(4, batch_size=4, device="cpu")
    # the port's PaddingSpec is its own copy of the reference's class
    assert dataclasses.asdict(pt.spec) == dataclasses.asdict(pj.spec)
    assert dataclasses.asdict(pt.cfg) == dataclasses.asdict(pj.cfg)
    pt = Predictor(pt.cfg, pt.spec, params=jax.tree.map(np.asarray,
                                                        pj.params),
                   device="cpu")
    task = TASKS[4]
    examples = parse_graph_text(generate_task_file(4, 6, seed=3), task)
    graphs = examples_to_graphs(examples[:6], task)
    assert pt.predict(graphs) == pj.predict(graphs)
