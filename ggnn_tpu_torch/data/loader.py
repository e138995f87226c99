"""Static-shape batching iterator (SURVEY.md §2.1 C10).

The port's own copy of ``ggnn_tpu/data/loader.py`` (numpy only).

The reference wraps ``torch.utils.data.DataLoader``; under jit every batch
must have identical shapes, so this loader pads every batch to one
:class:`~ggnn_tpu_torch.graph.PaddingSpec` (per-epoch shuffle, seeded, resumable).
Short final batches are padded with empty graphs (masked out everywhere).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ggnn_tpu_torch.graph import GraphBatch, PaddingSpec, batch_graphs


class BatchLoader:
    def __init__(self, graphs: list[dict], spec: PaddingSpec,
                 target_pads: Optional[dict] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.graphs = graphs
        self.spec = spec
        self.target_pads = target_pads or {}
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        b = self.spec.n_graphs
        if self.drop_last:
            return len(self.graphs) // b
        return (len(self.graphs) + b - 1) // b

    def epoch_batches(self, epoch: Optional[int] = None) -> Iterator[GraphBatch]:
        """Deterministic batches for a given epoch (resume = replay epoch)."""
        ep = self.epoch if epoch is None else epoch
        idx = np.arange(len(self.graphs))
        if self.shuffle:
            rng = np.random.default_rng((self.seed, ep))
            rng.shuffle(idx)
        b = self.spec.n_graphs
        stop = len(idx) - (len(idx) % b) if self.drop_last else len(idx)
        for i in range(0, stop, b):
            chunk = [self.graphs[j] for j in idx[i:i + b]]
            yield batch_graphs(chunk, self.spec, self.target_pads)
        if epoch is None:
            self.epoch += 1
