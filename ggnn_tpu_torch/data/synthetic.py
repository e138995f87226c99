"""Synthetic large random graphs (the port's own copy of
``ggnn_tpu/data/synthetic.py``): uniform, community-structured or
scale-free, 8 edge types by default.

Generates directly in the framework's flattened type-sorted COO layout
(building a python list of per-graph dicts would not scale), with seeded
determinism for multi-host reproducibility (SURVEY.md §7.2.5)."""

from __future__ import annotations

import numpy as np

from ggnn_tpu_torch.graph import GraphBatch, PaddingSpec, _sort_edges


def synthetic_batch(n_nodes: int, n_edges: int, n_edge_types: int = 8,
                    annotation_dim: int = 8, state_dim: int | None = None,
                    seed: int = 0, node_mult: int = 8,
                    edge_mult: int = 128, n_communities: int = 0,
                    p_intra: float = 0.9,
                    powerlaw_alpha: float = 0.0) -> GraphBatch:
    """One big random graph as a GraphBatch (single graph id 0).

    ``n_edges`` counts LOGICAL edges; the batch holds 2× directed message
    edges.  Edge axis is padded to ``edge_mult`` (Pallas tile friendliness).

    ``n_communities > 0`` produces a community-structured graph: nodes are
    split into contiguous communities and each edge is intra-community with
    probability ``p_intra`` — the locality regime where the deduplicated
    halo plan (parallel/partition.py) shrinks the exchange and where the
    round-2 gather optimizations apply.  Contiguous communities align with
    the contiguous-range shard ownership, as a production partitioner
    (METIS-style) would arrange.
    """
    rng = np.random.default_rng(seed)
    rup = lambda x, m: ((x + m - 1) // m) * m
    n_pad = rup(n_nodes, node_mult)
    e_dir = 2 * n_edges
    e_pad = rup(e_dir, edge_mult)
    spec = PaddingSpec(n_graphs=1, n_pad=n_pad, e_pad=e_pad,
                       n_edge_types=n_edge_types, annotation_dim=annotation_dim)

    if powerlaw_alpha > 0:
        # scale-free endpoints, nodes numbered by degree rank (id 0 = top
        # hub) — the web/social/citation regime.  Hub table rows are then
        # contiguous, so the windowed block-CSR path captures the hub mass
        # in a few hot windows while tail edges spill to the per-edge path.
        w = (np.arange(n_nodes, dtype=np.float64) + 1.0) ** -powerlaw_alpha
        cdf = np.cumsum(w / w.sum())
        cdf[-1] = 1.0  # float rounding can leave cdf[-1] < 1: a draw in
        # [cdf[-1], 1) would yield the out-of-range node id n_nodes
        src = np.searchsorted(cdf, rng.random(n_edges)).astype(np.int64)
        dst = np.searchsorted(cdf, rng.random(n_edges)).astype(np.int64)
    elif n_communities > 0:
        csize = n_nodes // n_communities
        com = rng.integers(0, n_communities, n_edges)
        intra = rng.random(n_edges) < p_intra
        src = rng.integers(0, csize, n_edges) + com * csize
        dst_in = rng.integers(0, csize, n_edges) + com * csize
        dst_out = rng.integers(0, n_nodes, n_edges)
        src = src.astype(np.int64)
        dst = np.where(intra, dst_in, dst_out).astype(np.int64)
    else:
        src = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
        dst = rng.integers(0, n_nodes, n_edges, dtype=np.int64)
    typ = rng.integers(0, n_edge_types, n_edges, dtype=np.int64)

    d_src = np.concatenate([src, dst])
    d_dst = np.concatenate([dst, src])
    d_typ = np.concatenate([typ, typ + n_edge_types])
    d_src, d_dst, d_typ, offsets = _sort_edges(
        d_src, d_dst, d_typ, 2 * n_edge_types)

    edge_src = np.zeros(e_pad, np.int32)
    edge_dst = np.zeros(e_pad, np.int32)
    edge_type = np.zeros(e_pad, np.int32)
    edge_mask = np.zeros(e_pad, np.float32)
    edge_src[:e_dir], edge_dst[:e_dir], edge_type[:e_dir] = d_src, d_dst, d_typ
    edge_mask[:e_dir] = 1.0

    annotations = (rng.random((n_pad, annotation_dim)) < 0.1).astype(np.float32)
    annotations[n_nodes:] = 0.0
    node_graph = np.zeros(n_pad, np.int32)
    node_graph[n_nodes:] = 1
    node_mask = np.zeros(n_pad, np.float32)
    node_mask[:n_nodes] = 1.0
    n_nodes_arr = np.array([n_nodes], np.int32)

    return GraphBatch(
        spec=spec, annotations=annotations, node_graph=node_graph,
        node_mask=node_mask, edge_src=edge_src, edge_dst=edge_dst,
        edge_type=edge_type, edge_mask=edge_mask,
        type_offsets=offsets.astype(np.int32), n_nodes=n_nodes_arr,
        targets={"node": np.zeros((1,), np.int32)})
