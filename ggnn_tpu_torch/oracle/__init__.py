"""Dependency-free NumPy oracle for GGNN/GGS-NN (SURVEY.md §0.2): the
port's copy of ``ggnn_tpu.oracle``, the same seven exports and helpers
(:mod:`ggnn_tpu_torch.oracle.numpy_ggnn`), numpy only.  The port's tests
and ``chip_smoke.py`` hold its compute paths to it."""

from ggnn_tpu_torch.oracle.numpy_ggnn import (  # noqa: F401
    oracle_propagate,
    oracle_propagate_dense,
    dense_adjacency,
    oracle_node_select,
    oracle_per_node,
    oracle_graph_gated,
    oracle_ggsnn,
)
