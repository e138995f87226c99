"""Edge partitioning and the halo-exchange plan (numpy, on the host).

The port's copy of ``ggnn_tpu/parallel/partition.py``, array for array:

- every shard owns a contiguous node range of ``n_local = n_pad / P`` rows
  of the flattened node axis; node state h stays sharded at all times;
- every directed message edge lives on the shard owning its
  **destination**, so aggregation is local (into owned rows);
- per propagation step each shard needs the states of remote *source*
  nodes (the "halo").  The exchange pattern is static, so the plan is made
  once per batch:

  * ``halo_send_idx[owner, requester, H]``: the local node ids the owner
    sends to the requester (deduplicated, padded to the largest request
    H);
  * edge sources are remapped to pool coordinates: the pool each shard
    gathers from is ``[hot ∥ recv ∥ h_local]``, remote sources at
    ``P·Hh + owner·H + position``, self-edges past ``P·Hh + P·H``.

Every array keeps the reference's leading ``[P, …]`` shard axis and its
common-shape pins, so the stacked arrays equal the reference's and each
shard's kernels get the same tile budgets.  A rank takes its own row with
:meth:`PartitionedBatch.local` (and :func:`local_halo_layout` for the
kernel strategies' stacked layouts) and copies it to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ggnn_tpu_torch.graph import GraphBatch
from ggnn_tpu_torch.ops.legacy import build_dst_block_layout, static_tile_budget
from ggnn_tpu_torch.ops.scatter import BLOCK_N, ScatterLayout, _rup_block
from ggnn_tpu_torch.ops.window import DeviceWindowLayout, build_window_layout


@dataclasses.dataclass
class PartitionedBatch:
    """Host-side numpy arrays, all with a leading shard axis [P, …]."""

    n_shards: int
    n_local: int
    halo_size: int                 # H
    annotations: np.ndarray        # [P, n_local, A]
    node_mask: np.ndarray          # [P, n_local]
    node_graph: np.ndarray         # [P, n_local]
    edge_src_global: np.ndarray    # [P, E_l] global src ids (all_gather path)
    edge_src_halo: np.ndarray      # [P, E_l] pool coordinates (halo path)
    edge_dst_local: np.ndarray     # [P, E_l] dst - shard_base
    edge_type: np.ndarray          # [P, E_l]
    edge_mask: np.ndarray          # [P, E_l]
    type_offsets: np.ndarray       # [P, T2+1]
    halo_send_idx: np.ndarray      # [P(owner), P(requester), H] local ids
    # the local/remote split (split_local_remote): local edges read h_local
    # directly, remote edges keep pool coordinates; None until then
    local_edges: "dict | None" = None   # src (shard-local ids), dst, type, mask
    remote_edges: "dict | None" = None  # src (pool coords), dst, type, mask
    # the hot-set hybrid exchange: rows requested by >= hot_thresh shards
    # ride one all_gather; hot_size == 0 is the plain dense plan
    hot_size: int = 0              # Hh
    hot_idx: "np.ndarray | None" = None  # [P, Hh] owner's hot local ids

    @property
    def pool_rows(self) -> int:
        """Rows of the per-shard gather pool the halo coords index."""
        return (self.n_shards * self.hot_size
                + self.n_shards * self.halo_size + self.n_local)

    def local(self, rank: int, device) -> "LocalParts":
        """Shard ``rank``'s row of every array, as tensors on ``device``."""
        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x[rank]),
                                   device=device)

        def edges(d):
            return None if d is None else {k: t(v) for k, v in d.items()}

        return LocalParts(
            rank=rank, n_shards=self.n_shards, n_local=self.n_local,
            halo_size=self.halo_size, hot_size=self.hot_size,
            annotations=t(self.annotations), node_mask=t(self.node_mask),
            node_graph=t(self.node_graph),
            edge_src_global=t(self.edge_src_global),
            edge_src_halo=t(self.edge_src_halo),
            edge_dst_local=t(self.edge_dst_local),
            edge_type=t(self.edge_type), edge_mask=t(self.edge_mask),
            send_idx=t(self.halo_send_idx),
            hot_idx=None if self.hot_idx is None else t(self.hot_idx),
            local_edges=edges(self.local_edges),
            remote_edges=edges(self.remote_edges))


@dataclasses.dataclass
class LocalParts:
    """One shard's row of a :class:`PartitionedBatch` on its rank's device:
    what the reference's ``shard_map`` body sees of the stacked arrays.
    ``send_idx`` [P, H] is the shard's owner row of ``halo_send_idx`` (the
    local rows it sends to each requester)."""

    rank: int
    n_shards: int
    n_local: int
    halo_size: int
    hot_size: int
    annotations: torch.Tensor
    node_mask: torch.Tensor
    node_graph: torch.Tensor
    edge_src_global: torch.Tensor
    edge_src_halo: torch.Tensor
    edge_dst_local: torch.Tensor
    edge_type: torch.Tensor
    edge_mask: torch.Tensor
    send_idx: torch.Tensor
    hot_idx: "torch.Tensor | None"
    local_edges: "dict | None"
    remote_edges: "dict | None"


def _rup(x, m):
    return ((x + m - 1) // m) * m


def partition_batch(batch: GraphBatch, n_shards: int,
                    edge_mult: int = 8,
                    use_native: bool | None = None,
                    hot_thresh: int | None = None) -> PartitionedBatch:
    """The halo plan of ``batch`` over ``n_shards`` shards.

    The plan comes from the port's native host library
    (:func:`ggnn_tpu_torch.native.halo_plan_native`) unless
    ``use_native=False``; a failed build raises
    (``native.NativeBuildError``), nothing falls back.  ``hot_thresh``
    enables the hot-set hybrid exchange (owner rows requested by at least
    ``hot_thresh`` distinct shards ride one all_gather instead of padding
    every all-to-all pair to them) and forces the Python builder, whose
    plans the native one does not make."""
    spec = batch.spec
    if spec.n_pad % n_shards:
        raise ValueError(f"n_pad={spec.n_pad} not divisible by P={n_shards}")
    n_local = spec.n_pad // n_shards
    T2 = spec.n_message_types
    if hot_thresh is not None:
        use_native = False

    ann = batch.annotations.reshape(n_shards, n_local, spec.annotation_dim)
    node_mask = batch.node_mask.reshape(n_shards, n_local)
    node_graph = batch.node_graph.reshape(n_shards, n_local)

    if use_native is not False:
        from ggnn_tpu_torch import native
        real = batch.edge_mask > 0
        plan = native.halo_plan_native(
            batch.edge_src[real], batch.edge_dst[real],
            batch.edge_type[real], n_shards, n_local, T2)
        return PartitionedBatch(
            n_shards=n_shards, n_local=n_local,
            halo_size=plan["halo_size"], annotations=ann,
            node_mask=node_mask, node_graph=node_graph,
            edge_src_global=plan["edge_src_global"],
            edge_src_halo=plan["edge_src_halo"],
            edge_dst_local=plan["edge_dst_local"],
            edge_type=plan["edge_type"], edge_mask=plan["edge_mask"],
            type_offsets=plan["type_offsets"],
            halo_send_idx=plan["halo_send_idx"])

    real = batch.edge_mask > 0
    src = batch.edge_src[real].astype(np.int64)
    dst = batch.edge_dst[real].astype(np.int64)
    typ = batch.edge_type[real].astype(np.int64)
    shard_of = dst // n_local

    per_shard = []
    requests: list[list[np.ndarray]] = []  # [s][o] -> sorted unique local ids
    for s in range(n_shards):
        sel = shard_of == s
        es, ed, et = src[sel], dst[sel], typ[sel]
        order = np.lexsort((ed, et))
        es, ed, et = es[order], ed[order], et[order]
        per_shard.append((es, ed, et))
        owners = es // n_local
        # self-edges read h_local directly (pool = … ∥ h_local): they are
        # not exchanged
        requests.append([np.zeros((0,), np.int64) if o == s
                         else np.unique(es[owners == o] - o * n_local)
                         for o in range(n_shards)])

    # hot-set extraction: rows many shards want leave the pairwise plan
    hot_sets = [np.zeros(0, np.int64) for _ in range(n_shards)]
    Hh = 0
    if hot_thresh is not None and n_shards > 1:
        for o in range(n_shards):
            all_req = np.concatenate(
                [requests[s][o] for s in range(n_shards)])
            ids, cnt = np.unique(all_req, return_counts=True)
            hot_sets[o] = ids[cnt >= hot_thresh]   # sorted (np.unique)
        for s in range(n_shards):
            for o in range(n_shards):
                requests[s][o] = np.setdiff1d(requests[s][o], hot_sets[o])
        Hh = max((h_.size for h_ in hot_sets), default=0)
        Hh = _rup(Hh, 8) if Hh else 0

    H = max((len(r) for reqs in requests for r in reqs), default=1)
    H = max(_rup(H, 8), 8)
    e_local = max(_rup(max((len(p[0]) for p in per_shard), default=1),
                       edge_mult), edge_mult)

    edge_src_global = np.zeros((n_shards, e_local), np.int32)
    edge_src_halo = np.zeros((n_shards, e_local), np.int32)
    edge_dst_local = np.zeros((n_shards, e_local), np.int32)
    edge_type = np.zeros((n_shards, e_local), np.int32)
    edge_mask = np.zeros((n_shards, e_local), np.float32)
    type_offsets = np.zeros((n_shards, T2 + 1), np.int32)
    halo_send_idx = np.zeros((n_shards, n_shards, H), np.int32)

    hot_base = n_shards * Hh      # the recv segment starts after hot
    for s in range(n_shards):
        es, ed, et = per_shard[s]
        m = len(es)
        edge_src_global[s, :m] = es
        edge_dst_local[s, :m] = ed - s * n_local
        edge_type[s, :m] = et
        edge_mask[s, :m] = 1.0
        np.cumsum(np.bincount(et, minlength=T2), out=type_offsets[s, 1:])
        owners = es // n_local
        halo = np.empty(m, np.int64)
        for o in range(n_shards):
            osel = owners == o
            if o == s:
                # self-edges index past hot + receive into h_local
                halo[osel] = hot_base + n_shards * H + (es[osel] - s * n_local)
                continue
            req = requests[s][o]
            halo_send_idx[o, s, :len(req)] = req
            loc_ids = es[osel] - o * n_local
            pos = np.searchsorted(req, loc_ids)
            coord = hot_base + o * H + np.minimum(pos, max(len(req) - 1, 0))
            hs = hot_sets[o]
            if hs.size:
                hp = np.searchsorted(hs, loc_ids)
                is_hot = (hp < hs.size) & (
                    hs[np.minimum(hp, hs.size - 1)] == loc_ids)
                coord = np.where(is_hot, o * Hh + hp, coord)
            halo[osel] = coord
        edge_src_halo[s, :m] = halo

    hot_idx = None
    if Hh:
        hot_idx = np.zeros((n_shards, Hh), np.int32)
        for o in range(n_shards):
            hot_idx[o, :hot_sets[o].size] = hot_sets[o]

    return PartitionedBatch(
        n_shards=n_shards, n_local=n_local, halo_size=H,
        annotations=ann, node_mask=node_mask, node_graph=node_graph,
        edge_src_global=edge_src_global, edge_src_halo=edge_src_halo,
        edge_dst_local=edge_dst_local, edge_type=edge_type,
        edge_mask=edge_mask, type_offsets=type_offsets,
        halo_send_idx=halo_send_idx, hot_size=Hh, hot_idx=hot_idx)


def split_local_remote(parts: PartitionedBatch,
                       edge_mult: int = 8) -> PartitionedBatch:
    """Populate ``local_edges`` / ``remote_edges``: local edges (src owned by
    the dst's shard) re-indexed to shard-local source ids, so that their
    aggregation reads ``h_local`` and needs nothing of the exchange; remote
    edges keep their pool coordinates."""
    P, n_local = parts.n_shards, parts.n_local

    sel_local = [(parts.edge_src_global[s] // n_local == s)
                 & (parts.edge_mask[s] > 0) for s in range(P)]
    n_loc = max(_rup(max(int(m.sum()) for m in sel_local), edge_mult),
                edge_mult)
    n_rem = max(_rup(max(int(((parts.edge_mask[s] > 0) & ~sel_local[s]).sum())
                         for s in range(P)), edge_mult), edge_mult)

    def alloc(e):
        return {k: np.zeros((P, e), np.int32) for k in ("src", "dst", "type")} \
            | {"mask": np.zeros((P, e), np.float32)}

    loc, rem = alloc(n_loc), alloc(n_rem)
    for s in range(P):
        lm = sel_local[s]
        rm = (parts.edge_mask[s] > 0) & ~lm
        nl, nr = int(lm.sum()), int(rm.sum())
        loc["src"][s, :nl] = parts.edge_src_global[s][lm] - s * n_local
        loc["dst"][s, :nl] = parts.edge_dst_local[s][lm]
        loc["type"][s, :nl] = parts.edge_type[s][lm]
        loc["mask"][s, :nl] = 1.0
        rem["src"][s, :nr] = parts.edge_src_halo[s][rm]
        rem["dst"][s, :nr] = parts.edge_dst_local[s][rm]
        rem["type"][s, :nr] = parts.edge_type[s][rm]
        rem["mask"][s, :nr] = 1.0
    parts.local_edges = loc
    parts.remote_edges = rem
    return parts


def _stack(lays) -> dict:
    """The per-shard layouts' arrays stacked on a leading [P] axis (numpy)."""
    def host(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return {k: np.stack([host(l.arrays[k]) for l in lays])
            for k in lays[0].arrays}


def build_halo_scatter_layouts(parts: PartitionedBatch, tile_e: int = 128,
                               with_grad: bool = False,
                               grad_tile_e: int = 128):
    """Per-shard legacy scatter layouts (``ops/legacy.py``) for the
    ``halo_onehot`` strategy, stacked with a common shape.

    Sources are pool coordinates (``n_src_rows = pool_rows``), destinations
    the shard's ``n_local`` rows (a multiple of 128).  Tile counts are
    pinned to the static budget of the partition's padded edge count, so
    every shard's arrays stack.  ``with_grad=True`` builds the transposed
    grad layouts too (sharded training).

    Returns (stacked arrays: dict of [P, …] numpy arrays, meta: dict with
    the common ``scatter_meta`` tuple)."""
    P, n_local = parts.n_shards, parts.n_local
    if n_local % BLOCK_N:
        raise ValueError(
            f"halo_onehot needs n_local % {BLOCK_N} == 0, got {n_local}")
    T2 = parts.type_offsets.shape[1] - 1
    n_src = parts.pool_rows          # [hot ∥ recv ∥ h_local]
    e_local = parts.edge_src_halo.shape[1]
    budget = static_tile_budget(e_local, n_local, tile_e)
    g_budget = (static_tile_budget(e_local, _rup_block(T2 * n_src),
                                   grad_tile_e) if with_grad else None)
    lays = [
        build_dst_block_layout(
            parts.edge_src_halo[s], parts.edge_dst_local[s],
            parts.edge_type[s], parts.edge_mask[s], n_local,
            tile_e=tile_e, n_src_rows=n_src, onehot_stream=True,
            with_grad=with_grad, n_message_types=T2,
            pad_tiles_to=budget,
            grad_tile_e=grad_tile_e if with_grad else None,
            grad_pad_tiles_to=g_budget,
            # 16-aligned packs and dst-local streams where the tile allows
            edge_align=(16 if tile_e % 16 == 0 else None),
            dstl_stream=tile_e % 16 == 0).to("cpu")
        for s in range(P)
    ]
    metas = {l.meta for l in lays}
    if len(metas) != 1:
        raise AssertionError(f"per-shard metas diverged: {metas}")
    meta = {"scatter_meta": lays[0].meta, "tile_e": tile_e,
            "n_blocks": n_local // BLOCK_N, "halo_rows": n_src}
    return _stack(lays), meta


def build_halo_window_layouts(parts: PartitionedBatch, window: int = 512,
                              min_edges_per_tile: int = 32,
                              spill_tile_e: int = 512,
                              n_message_types: int | None = None,
                              with_grad: bool = False,
                              row_major: str = "src",
                              typed_spill: bool = False,
                              on_demand: bool = False,
                              grad_quant: bool = False):
    """Per-shard window layouts (``ops/window.py``) over the shard-LOCAL
    edges for the ``halo_window`` strategy: each shard aggregates its
    intra-shard edges through the windowed kernels, its remote edges
    through the pool.  Every shard is rebuilt with the cross-shard pins
    (tile counts, spill packs and tiles, the XW spill's type buckets, the
    grad half's tiles and spill buckets) so the arrays stack and one meta
    serves every shard.  ``with_grad``, ``row_major``, ``typed_spill``,
    ``on_demand`` and ``grad_quant`` as :func:`~ggnn_tpu_torch.ops.window.
    build_window_layout` (``on_demand`` implies ``typed_spill``).

    Returns (stacked arrays: dict of [P, …] numpy arrays, meta: dict)."""
    if parts.local_edges is None:
        raise ValueError("call split_local_remote(parts) first")
    P, n_local = parts.n_shards, parts.n_local
    if n_local % BLOCK_N:
        raise ValueError(
            f"halo_window needs n_local % {BLOCK_N} == 0, got {n_local}")
    loc = parts.local_edges
    if n_message_types is None:
        n_message_types = int(max(
            int(parts.edge_type[s].max(initial=0)) for s in range(P))) + 1
    if on_demand:
        typed_spill = True  # on-demand layouts have no table to gather

    def build(s, pad=None, spad=None, gt_pad=None, sb_bucket=None,
              sb_tile=None, sb_pad=None, stile=None):
        return build_window_layout(
            loc["src"][s], loc["dst"][s], loc["type"][s], loc["mask"][s],
            n_local, window=window, min_edges_per_tile=min_edges_per_tile,
            spill_tile_e=(stile if stile is not None else spill_tile_e),
            n_message_types=n_message_types,
            row_major=row_major, pad_tiles_to=pad, spill_pad_tiles_to=spad,
            force_spill=True, with_grad=with_grad,
            gt_pad_tiles_to=gt_pad, spill_bwd_bucket=sb_bucket,
            spill_bwd_tile_e=sb_tile, spill_bwd_pad_tiles_to=sb_pad,
            typed_spill=typed_spill, on_demand=on_demand,
            grad_quant=grad_quant)

    first = [build(s) for s in range(P)]
    n_tiles = max(l.n_tiles for l in first)
    sp_tiles = max(l.arrays["s_block_of_tile"].shape[0] for l in first)
    pins = {}
    if spill_tile_e is None:
        # the density-derived spill tile, pinned to the cross-shard maximum
        stiles = [l.meta[4][1] for l in first if l.meta[4] is not None]
        if stiles:
            pins["stile"] = max(stiles)
    if typed_spill:
        # the XW spill's type-bucket offsets are static meta: the bucket
        # width is pinned to the cross-shard maximum (spill_bwd_bucket
        # applies to the forward buckets too)
        xw_offs = [l.meta[4][-1] for l in first]
        pins["sb_bucket"] = max(
            max(o[t + 1] - o[t] for t in range(len(o) - 1))
            for o in xw_offs)
    if with_grad:
        pins["gt_pad"] = max(l.arrays["gt_block_of_tile"].shape[0]
                             for l in first)
        offs = [l.grad_meta[2] for l in first]
        pins["sb_bucket"] = max(
            pins.get("sb_bucket", 0),
            max(max(o[t + 1] - o[t] for t in range(len(o) - 1))
                for o in offs))
        sb_metas = [l.grad_meta[3] for l in first]
        if any(m is not None for m in sb_metas):
            pins["sb_tile"] = max(m[1] for m in sb_metas if m is not None)
            pins["sb_pad"] = static_tile_budget(
                n_message_types * pins["sb_bucket"], n_local,
                pins["sb_tile"])
    lays = [build(s, pad=n_tiles, spad=sp_tiles, **pins) for s in range(P)]
    metas = {l.meta for l in lays}
    if len(metas) != 1:
        raise AssertionError(f"per-shard window metas diverged: {metas}")
    meta = {"full_meta": lays[0].meta, "window": window,
            "n_tiles": n_tiles,
            "spill_frac": float(np.mean([l.stats["spill_frac"]
                                         for l in first]))}
    return _stack(lays), meta


def local_halo_layout(halo_layouts, rank: int, device):
    """Shard ``rank``'s layout out of the stacked ``(arrays, meta)`` of
    :func:`build_halo_scatter_layouts` (a
    :class:`~ggnn_tpu_torch.ops.scatter.ScatterLayout`) or
    :func:`build_halo_window_layouts` (a
    :class:`~ggnn_tpu_torch.ops.window.DeviceWindowLayout`), its arrays
    copied to ``device``.  Build it once per batch: the kernels make their
    per-layout plans once per layout tensor."""
    arrays, meta = halo_layouts
    local = {k: torch.as_tensor(np.ascontiguousarray(v[rank]), device=device)
             for k, v in arrays.items()}
    if "scatter_meta" in meta:
        return ScatterLayout(meta["scatter_meta"], local)
    return DeviceWindowLayout(meta["full_meta"], local)
