"""bAbI graph-task text format: task specs, parser, example→graph conversion.

The port's own copy of ``ggnn_tpu/data/babi.py`` (numpy only).

Text format contract (SURVEY.md §2.2; reference family's
``babi_data/processed_*/<split>/<task>_graphs.txt``):

Per-example block, blank-line separated::

    <src_node_id> <edge_type_id> <dst_node_id>    # one line per edge, 1-indexed
    ...
    ? <question_type> <arg_node_id(s)> <target>   # one or more question lines

Each (graph, question-line) pair is one example.  Task 19 targets are a
comma-joined SEQUENCE of direction-type ids.  Node/edge-type ids are
1-indexed in the files and 0-indexed everywhere in memory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ggnn_tpu_torch.graph import PaddingSpec

END_TOKEN_NAME = "<end>"


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """Static description of a bAbI graph task (SURVEY.md §2.1, BASELINE.json configs)."""

    task_id: int
    n_edge_types: int        # logical edge-type vocabulary in the files
    annotation_dim: int      # question-argument marker channels
    n_args: int              # argument node ids on the question line
    target_kind: str         # 'node' | 'graph_class' | 'seq'
    head: str                # 'node_select' | 'per_node' | 'graph_gated' | 'ggsnn'
    n_classes: int = 0       # classes for graph_class; step vocab for seq (incl. end)
    n_question_types: int = 1  # >1 → one model per question type (reference family)
    max_seq_len: int = 1     # output rounds for GGS-NN ('seq' targets, incl. end token)
    dir_opposite: tuple = ()  # direction-type involution (n↔s, e↔w) for path walks

    @property
    def seq_vocab(self) -> int:
        """Per-step output vocabulary for 'seq' tasks: directions + end token."""
        return self.n_classes


# Registry — one entry per BASELINE.json config (BASELINE.json:7-11).
TASKS: dict[int, TaskSpec] = {
    4: TaskSpec(task_id=4, n_edge_types=4, annotation_dim=1, n_args=1,
                target_kind="node", head="node_select", n_question_types=4),
    15: TaskSpec(task_id=15, n_edge_types=2, annotation_dim=1, n_args=1,
                 target_kind="node", head="node_select"),
    16: TaskSpec(task_id=16, n_edge_types=2, annotation_dim=1, n_args=1,
                 target_kind="node", head="node_select"),
    18: TaskSpec(task_id=18, n_edge_types=1, annotation_dim=2, n_args=2,
                 target_kind="graph_class", head="graph_gated", n_classes=2,
                 n_question_types=2),
    19: TaskSpec(task_id=19, n_edge_types=4, annotation_dim=2, n_args=2,
                 target_kind="seq", head="ggsnn", n_classes=5,  # 4 dirs + end
                 max_seq_len=3,  # ≤2 hops in bAbI 19 + end token
                 dir_opposite=(1, 0, 3, 2)),  # n↔s, e↔w
}


@dataclasses.dataclass
class Example:
    """One (graph, question) pair, 0-indexed."""

    n_nodes: int
    edges: np.ndarray        # [m, 3] int (src, type, dst), 0-indexed
    question_type: int       # 0-indexed
    args: tuple[int, ...]    # 0-indexed argument node ids
    target: np.ndarray       # shape [] for node/graph_class, [k] for seq


def parse_graph_file(path: str, spec: TaskSpec) -> list[Example]:
    """Parse a ``<task>_graphs.txt`` file into a flat list of examples."""
    with open(path, "r") as f:
        text = f.read()
    return parse_graph_text(text, spec)


def parse_graph_text(text: str, spec: TaskSpec) -> list[Example]:
    examples: list[Example] = []
    edges: list[tuple[int, int, int]] = []
    questions: list[tuple[int, tuple[int, ...], np.ndarray]] = []

    def flush():
        nonlocal edges, questions
        if not edges and not questions:
            return
        max_node = 0
        for s, _, d in edges:
            max_node = max(max_node, s, d)
        for _, args, tgt in questions:
            max_node = max(max_node, *(a + 1 for a in args))
            if spec.target_kind == "node":
                max_node = max(max_node, int(tgt) + 1)
        edge_arr = (np.asarray(edges, np.int64).reshape(-1, 3)
                    - np.array([1, 1, 1]))  # to 0-indexed
        for qtype, args, tgt in questions:
            examples.append(Example(
                n_nodes=max_node, edges=edge_arr, question_type=qtype,
                args=args, target=tgt))
        edges, questions = [], []

    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            flush()
            continue
        toks = line.split()
        if toks[0] == "?":
            qtype = int(toks[1]) - 1
            args = tuple(int(t) - 1 for t in toks[2:2 + spec.n_args])
            tgt_tok = toks[2 + spec.n_args]
            if spec.target_kind == "seq":
                tgt = np.asarray([int(t) - 1 for t in tgt_tok.split(",")], np.int32)
            elif spec.target_kind == "node":
                tgt = np.asarray(int(tgt_tok) - 1, np.int32)
            else:  # graph_class — classes are 1-indexed in files too
                tgt = np.asarray(int(tgt_tok) - 1, np.int32)
            questions.append((qtype, args, tgt))
        else:
            s, t, d = (int(x) for x in toks[:3])
            edges.append((s, t, d))
    flush()
    return examples


def make_annotations(ex: Example, spec: TaskSpec) -> np.ndarray:
    """One-hot question-argument markers X ∈ {0,1}^{n × annotation_dim}
    (SURVEY.md §2.2): channel i marks the i-th argument node."""
    ann = np.zeros((ex.n_nodes, spec.annotation_dim), np.float32)
    for i, a in enumerate(ex.args):
        ann[a, min(i, spec.annotation_dim - 1)] = 1.0
    return ann


def example_targets(ex: Example, spec: TaskSpec) -> dict[str, np.ndarray]:
    if spec.target_kind == "node":
        return {"node": np.asarray(ex.target, np.int32)}
    if spec.target_kind == "graph_class":
        return {"cls": np.asarray(ex.target, np.int32)}
    # seq: append end token (id = n_dirs = n_classes-1), pad later
    seq = np.concatenate([np.asarray(ex.target, np.int32),
                          np.asarray([spec.n_classes - 1], np.int32)])
    if seq.shape[0] > spec.max_seq_len:
        raise ValueError(f"sequence longer than max_seq_len: {seq.shape[0]}")
    return {"seq": seq}


def _step_map(ex: Example, spec: TaskSpec) -> dict:
    """(node, direction) → next node; edge (u,d,v) reads "v is d-of u" and
    walking opposite(d) from v lands back on u."""
    step_to = {}
    for (u, t, v) in ex.edges:
        step_to[(int(u), int(t))] = int(v)
        if spec.dir_opposite:
            step_to.setdefault((int(v), spec.dir_opposite[int(t)]), int(u))
    return step_to


def path_nodes(ex: Example, spec: TaskSpec) -> np.ndarray:
    """Nodes visited after each direction token (the node-selection GGS-NN
    output targets: round k selects the k-th path node)."""
    step_to = _step_map(ex, spec)
    pos = ex.args[0]
    out = []
    for tok in np.asarray(ex.target).ravel():
        pos = step_to.get((pos, int(tok)), pos)
        out.append(pos)
    return np.asarray(out, np.int32)


def ggsnn_annotation_targets(ex: Example, spec: TaskSpec) -> np.ndarray:
    """Per-round annotation targets for GGS-NN-opt supervision (paper §4:
    supervise the intermediate node annotations so the model learns to walk
    the position marker along the path; SURVEY.md §3.4 'annotation
    supervision in the paper's GGS-NN-opt variant').

    Returns [n_nodes, K, annotation_dim]: after emitting round-k's token the
    position marker (channel 0) sits on the walked-to node and the
    destination marker (channel 1) is unchanged.  Rounds past the sequence
    end are masked in the loss (via the -1-padded seq target)."""
    K, A = spec.max_seq_len, spec.annotation_dim
    out = np.zeros((ex.n_nodes, K, A), np.float32)
    step_to = _step_map(ex, spec)
    pos, dst = ex.args[0], ex.args[1]
    toks = [int(x) for x in np.asarray(ex.target).ravel()]
    for k in range(K):
        if k < len(toks):
            pos = step_to.get((pos, toks[k]), pos)  # end/unknown token: stay
        out[pos, k, 0] = 1.0
        out[dst, k, min(1, A - 1)] = 1.0
    return out


def examples_to_graphs(examples: list[Example], spec: TaskSpec) -> list[dict]:
    """Convert parsed examples to the per-graph dicts :func:`batch_graphs` takes."""
    out = []
    for ex in examples:
        g = dict(
            n_nodes=ex.n_nodes,
            edges=ex.edges,
            annotations=make_annotations(ex, spec),
            targets=example_targets(ex, spec),
        )
        if spec.target_kind == "seq":
            g["node_targets"] = {"ann_seq": ggsnn_annotation_targets(ex, spec)}
            g["targets"]["seq_nodes"] = path_nodes(ex, spec)
        out.append(g)
    return out


class BabiDataset:
    """A split of one bAbI graph task, optionally filtered by question type.

    Mirrors the reference family's ``bAbIDataset`` (SURVEY.md §2.1 C2): reads
    ``<root>/processed_<fold>/<split>/<task>_graphs.txt``, filters by
    ``question_id`` for multi-question tasks (reference family behavior), and
    exposes per-example graph dicts plus the padding spec needed to batch them.
    """

    def __init__(self, root: str, task_id: int, split: str = "train",
                 fold: int = 1, question_id: Optional[int] = None,
                 limit: Optional[int] = None):
        self.spec = TASKS[task_id]
        path = os.path.join(root, f"processed_{fold}", split,
                            f"{task_id}_graphs.txt")
        examples = parse_graph_file(path, self.spec)
        if question_id is not None and self.spec.n_question_types > 1:
            examples = [e for e in examples if e.question_type == question_id]
        if limit is not None:
            examples = examples[:limit]
        self.examples = examples
        self.graphs = examples_to_graphs(examples, self.spec)
        self.max_nodes = max((g["n_nodes"] for g in self.graphs), default=1)
        self.max_edges = max((g["edges"].shape[0] for g in self.graphs), default=1)

    def __len__(self) -> int:
        return len(self.graphs)

    def padding_spec(self, batch_size: int) -> PaddingSpec:
        return PaddingSpec(
            n_graphs=batch_size,
            n_pad=batch_size * self.max_nodes,
            e_pad=batch_size * self.max_edges * 2,  # both directions
            n_edge_types=self.spec.n_edge_types,
            annotation_dim=self.spec.annotation_dim,
        ).round_up()

    def target_pads(self) -> dict[str, tuple]:
        if self.spec.target_kind == "seq":
            return {"seq": ((self.spec.max_seq_len,), -1),
                    "seq_nodes": ((self.spec.max_seq_len,), -1)}
        return {}
