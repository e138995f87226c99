"""Static-shape padded graph batch containers: the port's own copy of
``ggnn_tpu/graph.py`` (numpy only; the port imports nothing of the JAX
package).

A batch is a flattened, block-diagonal, edge-type-annotated COO batch:

- all graphs in a batch are concatenated into one node axis of static length
  ``n_pad`` and one edge axis of static length ``e_pad``;
- every logical edge ``(u, t, v)`` is materialized in BOTH directions:
  a forward copy with type ``t`` (the ``in_<t>`` transform) and a reverse
  copy ``(v, t + n_edge_types, u)`` (the ``out_<t>`` transform), so
  propagation is a single typed message pass over ``2·n_edge_types``
  message types;
- edges are sorted by (type, dst, src);
- padding edges carry ``src = dst = 0`` and ``edge_mask = 0``.

From ``NATIVE_SORT_THRESHOLD`` edges on, the sort runs in the port's native
host library (:func:`ggnn_tpu_torch.native.sort_edges_native`, a radix
sort), as the reference's does; its arrays equal the numpy ``lexsort``
path's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

# edge counts from this one on sort in the native library (the reference's
# threshold)
NATIVE_SORT_THRESHOLD = 4096


@dataclasses.dataclass(frozen=True)
class PaddingSpec:
    """Static shape budget for a batch: everything jit sees is fixed by this.

    ``n_pad``/``e_pad`` include *all* graphs in the batch (flattened axes);
    ``e_pad`` counts directed message edges, i.e. 2× the logical edge count.
    """

    n_graphs: int          # B — graphs per batch
    n_pad: int             # total padded node count across the batch
    e_pad: int             # total padded directed-edge count across the batch
    n_edge_types: int      # E — logical edge-type vocabulary (directions double it)
    annotation_dim: int    # width of the node annotation matrix X

    @property
    def n_message_types(self) -> int:
        return 2 * self.n_edge_types

    def round_up(self, mult_nodes: int = 8, mult_edges: int = 8) -> "PaddingSpec":
        """Round padded axes up to hardware-friendly multiples."""
        rup = lambda x, m: ((x + m - 1) // m) * m
        return dataclasses.replace(
            self, n_pad=rup(self.n_pad, mult_nodes), e_pad=rup(self.e_pad, mult_edges)
        )


@dataclasses.dataclass
class GraphBatch:
    """A batch of graphs flattened into static-shape padded arrays.

    All arrays are NumPy on the host side; they cross the jit boundary as-is.
    Shapes (with ``P = spec``):

    - ``annotations``: ``[P.n_pad, P.annotation_dim]`` float32 — node
      annotations X (question-argument markers etc.).
    - ``node_graph``: ``[P.n_pad]`` int32 — graph id per node; padding nodes
      point at graph id ``P.n_graphs`` (one-past-the-end segment).
    - ``node_mask``: ``[P.n_pad]`` float32 — 1.0 for real nodes.
    - ``edge_src`` / ``edge_dst``: ``[P.e_pad]`` int32 — global (flattened)
      node indices; padding edges use 0.
    - ``edge_type``: ``[P.e_pad]`` int32 — message type in
      ``[0, 2·n_edge_types)``; padding edges use 0.
    - ``edge_mask``: ``[P.e_pad]`` float32 — 1.0 for real directed edges.
    - ``type_offsets``: ``[2·n_edge_types + 1]`` int32 — segment boundaries
      into the (type-sorted) edge arrays, for the Pallas type-segment walk.
    - ``n_nodes``: ``[n_graphs]`` int32 — real node count per graph.
    - ``targets``: task-specific target pytree (dict of arrays), see
      :mod:`ggnn_tpu_torch.data.babi`.
    """

    spec: PaddingSpec
    annotations: np.ndarray
    node_graph: np.ndarray
    node_mask: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_type: np.ndarray
    edge_mask: np.ndarray
    type_offsets: np.ndarray
    n_nodes: np.ndarray
    targets: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def arrays(self) -> dict[str, Any]:
        """The pytree of arrays the model consumes (excludes static spec)."""
        return dict(
            annotations=self.annotations,
            node_graph=self.node_graph,
            node_mask=self.node_mask,
            n_nodes=self.n_nodes,
            type_offsets=self.type_offsets,
            edge_src=self.edge_src,
            edge_dst=self.edge_dst,
            edge_type=self.edge_type,
            edge_mask=self.edge_mask,
            targets=self.targets,
        )


def lexsort_edges(src, dst, etype, n_message_types):
    """The numpy sort of :func:`_sort_edges`: the edges by (type, dst, src)
    and the type segment offsets."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    etype = np.asarray(etype, np.int32)
    order = np.lexsort((src, dst, etype))
    src, dst, etype = src[order], dst[order], etype[order]
    counts = np.bincount(etype, minlength=n_message_types)
    offsets = np.zeros(n_message_types + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    return src, dst, etype, offsets


def _sort_edges(src, dst, etype, n_message_types):
    """Sort directed edges by (type, dst, src) and compute type segment
    offsets: from ``NATIVE_SORT_THRESHOLD`` edges on in the native library
    (built at first use; a failed build raises
    ``native.NativeBuildError``), below it :func:`lexsort_edges`."""
    if np.shape(src)[0] >= NATIVE_SORT_THRESHOLD:
        from ggnn_tpu_torch import native
        return native.sort_edges_native(src, dst, etype, n_message_types)
    return lexsort_edges(src, dst, etype, n_message_types)


def batch_graphs(
    graphs: list[dict[str, Any]],
    spec: PaddingSpec,
    target_pads: Optional[dict[str, tuple]] = None,
) -> GraphBatch:
    """Flatten a list of per-graph dicts into one padded :class:`GraphBatch`.

    Each input graph dict has keys:

    - ``n_nodes``: int
    - ``edges``: ``[m, 3]`` int array of ``(src, type, dst)`` with 0-indexed
      LOCAL node ids and 0-indexed logical edge types
    - ``annotations``: ``[n_nodes, annotation_dim]`` float
    - ``targets``: dict of per-graph target arrays (padded per
      ``target_pads``: name -> (pad_shape, pad_value))
    - ``node_targets`` (optional): dict of node-aligned target arrays with
      leading dim ``n_nodes``; batched along the flattened padded node axis
      (e.g. GGS-NN per-round annotation supervision, paper §4)

    Raises if the batch exceeds the spec's static budget.
    """
    B = spec.n_graphs
    if len(graphs) > B:
        raise ValueError(f"batch has {len(graphs)} graphs, spec allows {B}")

    annotations = np.zeros((spec.n_pad, spec.annotation_dim), np.float32)
    node_graph = np.full((spec.n_pad,), B, np.int32)
    node_mask = np.zeros((spec.n_pad,), np.float32)
    n_nodes = np.zeros((B,), np.int32)

    all_src, all_dst, all_type = [], [], []
    node_base = 0
    tgt_lists: dict[str, list] = {}
    node_tgt_lists: dict[str, list] = {}
    for gi, g in enumerate(graphs):
        n = int(g["n_nodes"])
        if node_base + n > spec.n_pad:
            raise ValueError(
                f"node budget exceeded: {node_base + n} > {spec.n_pad}")
        ann = np.asarray(g["annotations"], np.float32)
        annotations[node_base:node_base + n, : ann.shape[1]] = ann
        node_graph[node_base:node_base + n] = gi
        node_mask[node_base:node_base + n] = 1.0
        n_nodes[gi] = n

        edges = np.asarray(g["edges"], np.int64).reshape(-1, 3)
        if edges.size:
            s, t, d = edges[:, 0], edges[:, 1], edges[:, 2]
            if (t >= spec.n_edge_types).any() or (t < 0).any():
                raise ValueError("edge type out of range for spec")
            # forward (the reference's in_<t> transform) and reverse (out_<t>)
            all_src.append(s + node_base)
            all_dst.append(d + node_base)
            all_type.append(t)
            all_src.append(d + node_base)
            all_dst.append(s + node_base)
            all_type.append(t + spec.n_edge_types)
        node_base += n

        for name, value in g.get("targets", {}).items():
            tgt_lists.setdefault(name, []).append(np.asarray(value))
        for name, value in g.get("node_targets", {}).items():
            value = np.asarray(value)
            if value.shape[0] != n:
                raise ValueError(
                    f"node target {name!r} has leading dim {value.shape[0]}, "
                    f"expected n_nodes={n}")
            node_tgt_lists.setdefault(name, []).append(
                (node_base - n, value))  # node_base already advanced

    src = np.concatenate(all_src) if all_src else np.zeros((0,), np.int64)
    dst = np.concatenate(all_dst) if all_dst else np.zeros((0,), np.int64)
    typ = np.concatenate(all_type) if all_type else np.zeros((0,), np.int64)
    if src.shape[0] > spec.e_pad:
        raise ValueError(f"edge budget exceeded: {src.shape[0]} > {spec.e_pad}")
    src, dst, typ, offsets = _sort_edges(src, dst, typ, spec.n_message_types)

    e = src.shape[0]
    edge_src = np.zeros((spec.e_pad,), np.int32)
    edge_dst = np.zeros((spec.e_pad,), np.int32)
    edge_type = np.zeros((spec.e_pad,), np.int32)
    edge_mask = np.zeros((spec.e_pad,), np.float32)
    edge_src[:e], edge_dst[:e], edge_type[:e] = src, dst, typ
    edge_mask[:e] = 1.0

    targets: dict[str, Any] = {}
    target_pads = target_pads or {}
    for name, vals in tgt_lists.items():
        if name in target_pads:
            pad_shape, pad_value = target_pads[name]
            out = np.full((B, *pad_shape), pad_value, dtype=np.asarray(vals[0]).dtype)
            for i, v in enumerate(vals):
                v = np.asarray(v)
                out[(i, *tuple(slice(0, s) for s in v.shape))] = v
        else:
            out = np.full((B, *np.asarray(vals[0]).shape), 0,
                          dtype=np.asarray(vals[0]).dtype)
            for i, v in enumerate(vals):
                out[i] = v
        targets[name] = out

    for name, entries in node_tgt_lists.items():
        trailing = entries[0][1].shape[1:]
        out = np.zeros((spec.n_pad, *trailing), entries[0][1].dtype)
        for base, value in entries:
            out[base:base + value.shape[0]] = value
        targets[name] = out

    return GraphBatch(
        spec=spec,
        annotations=annotations,
        node_graph=node_graph,
        node_mask=node_mask,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_type=edge_type,
        edge_mask=edge_mask,
        type_offsets=offsets,
        n_nodes=n_nodes,
        targets=targets,
    )
