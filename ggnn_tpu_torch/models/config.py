"""Model configuration, mirrored field for field from
``ggnn_tpu/models/config.py`` (same defaults, same ``__post_init__``
checks), so one configuration describes a model in both packages.

Canonical hyperparameters follow the reference family / paper:
``state_dim=4, annotation_dim=1, n_steps=5``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    state_dim: int = 4            # D
    annotation_dim: int = 1       # A
    n_edge_types: int = 4         # E (logical; message types = 2E)
    n_steps: int = 5              # T propagation steps
    head: str = "node_select"     # node_select | per_node | graph_gated | ggsnn
    hidden_dim: int = 0           # head MLP hidden (0 → state_dim)
    n_classes: int = 1            # graph classes / per-node classes / seq vocab
    graph_dim: int = 0            # gated-readout width (0 → state_dim)
    n_rounds: int = 1             # GGS-NN output rounds (= max_seq_len)
    ann_supervision: bool = False  # GGS-NN-opt: supervise round annotations
    ann_loss_weight: float = 1.0
    edge_gates: bool = False      # SDDMM edge-feature gates (BASELINE.json:5)
    gate_dim: int = 0             # SDDMM inner dim (0 → state_dim)
    share_round_nets: bool = True  # GGS-NN: share F_o/F_x across rounds
    compute_dtype: str = "float32"  # aggregation dtype (bf16 ok; f32 accum)
    gru_matmul_compute: bool = True  # GRU matmul INPUTS in compute_dtype
                                  # (gates/state/accum stay f32); no-op
                                  # when compute_dtype is float32
    remat: bool = False           # jax.checkpoint each propagation step:
                                  # backward recomputes aggregation instead
                                  # of storing [T, N, D] activations
    ggsnn_output: str = "graph"   # GGS-NN F_o: 'graph' (token per round via
                                  # gated readout) | 'node' (select the next
                                  # path node per round, paper's alternative)
    agg_strategy: str = "node_transform"   # ops.segment strategy
    backend: str = "xla"          # 'xla' | 'pallas' | 'onehot' | 'window'
    fuse_gru: bool = False        # backend='window'|'onehot': run the GRU
                                  # in the aggregation kernel's epilogue
                                  # (gate matmuls in the compute dtype).
                                  # TRAINABLE: window via the emit_res
                                  # custom VJP; onehot's VJP recomputes
                                  # the unfused composition (same cost)
    quantized_table: bool = False  # fuse_gru serving: int8 node-transform
                                  # table with power-of-2 per-window scales
                                  # (int8 MXU dots; ~0.5% aggregation noise)
    lean_residuals: bool = False  # typed fused train: save only (h, a)
                                  # per step and RECOMPUTE z/r/h-tilde in
                                  # the backward (3 cheap matmuls) — cuts
                                  # the stacked residual footprint 2.5×;
                                  # targets the measured backward-chain
                                  # liveness tax (DESIGN.md round 8)
    param_dtype: str = "float32"

    def __post_init__(self):
        if self.backend not in ("xla", "pallas", "onehot", "window"):
            raise ValueError(
                f"unknown backend {self.backend!r}: expected "
                "'xla' | 'pallas' | 'onehot' | 'window'")
        if self.fuse_gru and self.backend not in ("window", "onehot"):
            raise ValueError("fuse_gru needs backend='window' or 'onehot'")
        if self.quantized_table and self.backend != "window":
            raise ValueError("quantized_table needs backend='window'")
        if self.quantized_table and not self.fuse_gru:
            raise ValueError("quantized_table needs fuse_gru=True")
        if self.edge_gates and self.backend in ("onehot", "window"):
            # count-matrix / one-hot layouts are topology-only and cannot
            # carry per-edge data-dependent gates
            raise ValueError(
                f"edge_gates is unsupported with backend={self.backend!r}; "
                "use 'xla' or 'pallas'")

    @property
    def n_message_types(self) -> int:
        return 2 * self.n_edge_types

    @property
    def head_hidden(self) -> int:
        return self.hidden_dim or self.state_dim

    @property
    def readout_dim(self) -> int:
        return self.graph_dim or self.state_dim


def model_config_for_task(task_spec, state_dim: int = 4, n_steps: int = 5,
                          **overrides) -> ModelConfig:
    """Build a ModelConfig from a :class:`ggnn_tpu.data.babi.TaskSpec`."""
    n_classes = {
        "node_select": 1,
        "per_node": max(task_spec.n_classes, 1),
        "graph_gated": task_spec.n_classes,
        "ggsnn": task_spec.n_classes,
    }[task_spec.head]
    return ModelConfig(
        state_dim=state_dim,
        annotation_dim=task_spec.annotation_dim,
        n_edge_types=task_spec.n_edge_types,
        n_steps=n_steps,
        head=task_spec.head,
        n_classes=n_classes,
        n_rounds=task_spec.max_seq_len if task_spec.head == "ggsnn" else 1,
        ann_supervision=(task_spec.head == "ggsnn"),
        **overrides,
    )
