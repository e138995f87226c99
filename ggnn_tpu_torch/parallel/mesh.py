"""The rank mesh: a 2-D ('data', 'graph') grid over the ranks of an
initialised ``torch.distributed`` world, with one process group per axis.

- ``data``: graph-batch data parallelism;
- ``graph``: edge/node partitioning within a (large) graph.

The graph axis is innermost (consecutive ranks), as the reference lays it
out so that halo exchanges stay between neighbours.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ggnn_tpu_torch.parallel.multihost import rank_device


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its process ``group`` (the
    ranks that share this rank's other coordinate), its ``size`` and this
    rank's ``index`` along it."""

    name: str
    group: object
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``grid`` [n_data, n_graph] of global ranks; ``axes`` by name; the
    rank's ``device``; ``group`` spans every rank of the grid."""

    grid: np.ndarray = dataclasses.field(compare=False)
    axes: dict = dataclasses.field(compare=False)
    group: object
    rank: int
    device: torch.device

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def size(self) -> int:
        return int(self.grid.size)


def make_mesh(n_graph: int | None = None, n_data: int = 1,
              device=None) -> Mesh | None:
    """The ('data', 'graph') mesh over the first ``n_data · n_graph`` ranks
    of the world (all of them on the graph axis by default).  Every rank of
    the world must call it (``dist.new_group`` is collective); a rank
    outside the grid gets None.  ``device`` is the rank's device (default
    :func:`~ggnn_tpu_torch.parallel.multihost.rank_device`: the card, or a
    raise without one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (initialize_multihost)")
    world = dist.get_world_size()
    if n_graph is None:
        n_graph = world // n_data
    if n_data * n_graph > world:
        raise ValueError(f"mesh {n_data}x{n_graph} exceeds {world} ranks")
    device = rank_device(device)
    grid = np.arange(n_data * n_graph).reshape(n_data, n_graph)
    # new_group is collective over the whole world: every rank makes every
    # group, in the same order
    everyone = dist.new_group(grid.reshape(-1).tolist())
    rows = [dist.new_group(grid[d].tolist()) for d in range(n_data)]
    cols = [dist.new_group(grid[:, g].tolist()) for g in range(n_graph)]
    rank = dist.get_rank()
    if rank >= grid.size:
        return None
    d, g = divmod(rank, n_graph)
    axes = {"graph": Axis("graph", rows[d], n_graph, g),
            "data": Axis("data", cols[g], n_data, d)}
    return Mesh(grid=grid, axes=axes, group=everyone, rank=rank,
                device=device)
