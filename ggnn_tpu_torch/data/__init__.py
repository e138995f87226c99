"""Data layer: bAbI graph-task parsing, generation, static-shape batching
and synthetic graphs; the port's own copy of ``ggnn_tpu/data`` (numpy only).

SURVEY.md §2.1 C2/C10/C11.  The reference ships committed preprocessed bAbI
graph files; the mount was empty (SURVEY.md §0), so this package vendors
deterministic generators that emit the same text format (SURVEY.md §2.2) and
a parser for it.
"""

from ggnn_tpu_torch.data.babi import (  # noqa: F401
    TASKS,
    TaskSpec,
    BabiDataset,
    parse_graph_file,
    examples_to_graphs,
)
from ggnn_tpu_torch.data.generators import generate_task_file, generate_all  # noqa: F401
from ggnn_tpu_torch.data.loader import BatchLoader  # noqa: F401
from ggnn_tpu_torch.data.synthetic import synthetic_batch  # noqa: F401
