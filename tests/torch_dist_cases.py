"""Inputs shared by the port's sharded CPU tests (not a test module): the
batches of the reference's distributed tests, made with the port's own
graph functions from numpy seeds (the same arrays as the JAX package's,
``tests/test_torch_data.py``), their JAX form, parameters drawn by the JAX
package as numpy trees, and the comparisons."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from ggnn_tpu import graph as JG
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init_params
from ggnn_tpu_torch.graph import GraphBatch, PaddingSpec, batch_graphs


def to_jax_batch(b: GraphBatch) -> JG.GraphBatch:
    """The port's batch as the JAX package's (the same arrays)."""
    fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)
              if f.name != "spec"}
    return JG.GraphBatch(spec=JG.PaddingSpec(**dataclasses.asdict(b.spec)),
                         **fields)


def jax_params(seed: int, **cfg) -> dict:
    """The JAX package's parameters for ``ModelConfig(**cfg)`` from
    ``PRNGKey(seed)``, as a numpy tree."""
    return jax.tree.map(np.asarray,
                        jax_init_params(jax.random.PRNGKey(seed),
                                        JaxConfig(**cfg)))


def random_graphs(rng, n_total, n_lo, n_hi, n_types=3, A=2, deg=3,
                  targets=None):
    """Random graphs of ``n_lo``–``n_hi`` nodes until ``n_total`` minus one
    graph's worth of nodes is reached (the reference tests' loop); each
    gets the per-graph ``targets(rng, n)`` and optional ``node_targets``."""
    graphs, total = [], 0
    while total < n_total - n_hi:
        n = int(rng.integers(n_lo, n_hi))
        m = int(rng.integers(n_lo // 2, deg * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, n_types, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, A)) < 0.4).astype(np.float32)
        g = dict(n_nodes=n, edges=edges, annotations=ann, targets={})
        if targets is not None:
            g.update(targets(rng, n))
        graphs.append(g)
        total += n
    return graphs


def sized_graphs(rng, sizes, n_types=3, A=2, deg=3, targets=None):
    """Random graphs of the node counts ``sizes``, drawn as
    :func:`random_graphs` draws them."""
    graphs = []
    for n in sizes:
        m = int(rng.integers(max(1, n // 2), deg * n))
        edges = np.stack([rng.integers(0, n, m), rng.integers(0, n_types, m),
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, A)) < 0.4).astype(np.float32)
        g = dict(n_nodes=n, edges=edges, annotations=ann, targets={})
        if targets is not None:
            g.update(targets(rng, n))
        graphs.append(g)
    return graphs


def batch_of(graphs, n_pad, n_types=3, A=2, n_graphs=None):
    spec = PaddingSpec(n_graphs=n_graphs or len(graphs), n_pad=n_pad,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=n_types, annotation_dim=A).round_up()
    return batch_graphs(graphs, spec)


def skewed_batch(n_nodes, n_edges, P, seed=0) -> GraphBatch:
    """The reference's hub-skewed cut (``tests/test_halo_locality.py``):
    most sources in shard 0's node range."""
    r = np.random.default_rng(seed)
    n_local = n_nodes // P
    src = np.where(r.random(n_edges) < 0.8,
                   r.integers(0, n_local, n_edges),
                   r.integers(0, n_nodes, n_edges)).astype(np.int32)
    dst = r.integers(0, n_nodes, n_edges).astype(np.int32)
    spec = PaddingSpec(n_graphs=1, n_pad=n_nodes, e_pad=n_edges,
                       n_edge_types=2, annotation_dim=2)
    return GraphBatch(
        spec=spec, annotations=np.zeros((n_nodes, 2), np.float32),
        edge_src=src, edge_dst=dst,
        edge_type=r.integers(0, 2, n_edges).astype(np.int32),
        edge_mask=np.ones(n_edges, np.float32),
        node_mask=np.ones(n_nodes, np.float32),
        node_graph=np.zeros(n_nodes, np.int32),
        type_offsets=np.zeros(5, np.int32),
        n_nodes=np.array([n_nodes], np.int32))


def gather_h(job, name, P):
    """The global h of a sharded case: ranks 0 … P−1 (data replica 0) in
    order; with a second data replica (ranks P … 2P−1 of a world of 2P),
    held bit-equal to the first."""
    parts = [job.result(name, r)["h"] for r in range(P)]
    if job.world == 2 * P:
        for r in range(P):
            np.testing.assert_array_equal(job.result(name, P + r)["h"],
                                          parts[r])
    return np.concatenate(parts)


def flat_tree(tree, prefix=""):
    """{"a/b": leaf} of a nested dict (the worker's key form)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat_tree(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def overlap_cases(batch, cfg, layouts, hold_s, seed=0,
                  strategies=("halo_overlap", "halo_window"),
                  dtypes=("float32", "bfloat16")):
    """The worker's ``overlap`` cases: each strategy (its P = 2 layout from
    ``layouts``) in each compute dtype on ``batch``, graph index 1 holding
    its exchange back ``hold_s`` seconds each step."""
    cases = []
    for dt in dtypes:
        c = dict(cfg, compute_dtype=dt)
        params = jax_params(seed, **c)
        for s in strategies:
            cases.append(dict(name=f"{s}-{dt}", kind="overlap", P=2,
                              batch=batch, params=params, cfg=c, strategy=s,
                              layout=layouts.get((s, 2)), hold_s=hold_s))
    return cases
