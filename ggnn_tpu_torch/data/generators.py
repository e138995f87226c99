"""Deterministic bAbI graph-task generators.

The port's own copy of ``ggnn_tpu/data/generators.py`` (numpy only).

The reference commits preprocessed bAbI graph files generated offline by the
original paper release (SURVEY.md §3.5, C11); the mount was empty
(SURVEY.md §0), so this module regenerates semantically-equivalent data in
the same text format (SURVEY.md §2.2).  Each task's generative story follows
the bAbI task definitions (Weston et al. 2015) as graphs, matching the task
semantics described in BASELINE.json:7-11:

- task 4  (two-argument relations): directional facts; "what is <dir> of X?"
- task 15 (deduction): is-a + afraid-of chains; answer is a class node
- task 16 (induction): is-a + has-color; answer is the sibling's color node
- task 18 (size reasoning): bigger-than partial order; yes/no question
- task 19 (path finding): grid walk; answer is a SEQUENCE of directions

All generators are seeded and pure; files round-trip through
:func:`ggnn_tpu_torch.data.babi.parse_graph_file`.
"""

from __future__ import annotations

import os

import numpy as np

# Direction vocabulary shared by tasks 4 and 19: edge (u, d, v) reads
# "v is <DIRS[d]> of u", i.e. moving from u in direction d reaches v.
DIRS = ("n", "s", "e", "w")
DIR_DELTA = {0: (0, 1), 1: (0, -1), 2: (1, 0), 3: (-1, 0)}
OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}


def _block(edges_1idx, questions) -> str:
    """Render one example block: edges then '?' lines, 1-indexed."""
    lines = [f"{s} {t} {d}" for (s, t, d) in edges_1idx]
    for (qtype, args, tgt) in questions:
        tgt_tok = ",".join(str(x) for x in tgt) if isinstance(tgt, (list, tuple)) else str(tgt)
        lines.append("? " + " ".join(str(x) for x in (qtype, *args)) + " " + tgt_tok)
    return "\n".join(lines)


def _grid_walk(rng: np.random.Generator, n_nodes: int):
    """Random self-avoiding-ish walk on Z²: returns (coords list, tree edges).

    Tree edges are (u, d, v) 0-indexed with geometric consistency — the walk
    guarantees path uniqueness (it is a tree)."""
    pos = {(0, 0): 0}
    coords = [(0, 0)]
    edges = []
    cur = (0, 0)
    cur_id = 0
    tries = 0
    while len(coords) < n_nodes and tries < 200:
        d = int(rng.integers(0, 4))
        dx, dy = DIR_DELTA[d]
        nxt = (cur[0] + dx, cur[1] + dy)
        tries += 1
        if nxt in pos:
            # jump back to a random existing node to branch elsewhere
            cur_id = int(rng.integers(0, len(coords)))
            cur = coords[cur_id]
            continue
        pos[nxt] = len(coords)
        coords.append(nxt)
        edges.append((cur_id, d, len(coords) - 1))
        cur_id = len(coords) - 1
        cur = nxt
    return coords, edges


def gen_task4(rng: np.random.Generator) -> str:
    """Directional facts on a tree; question (d, v) → the unique u with (v,d,u).

    Question reading: "what is <d> of v?" → the node reached from v going d.
    Each tree edge (u, d, v) yields fact lines in one direction only; both
    question polarities are derivable because (u,d,v) ⇔ (v,opp(d),u) and the
    model sees reverse-typed message edges (graph.py)."""
    n = int(rng.integers(4, 9))
    _, edges = _grid_walk(rng, n)
    if not edges:
        edges = [(0, 0, 1)]
    # pick a question: an edge (u, d, v): "what is d of u?" → v
    u, d, v = edges[int(rng.integers(0, len(edges)))]
    if rng.random() < 0.5:
        qtype, qarg, ans = d, u, v
    else:  # ask the reverse question off the same edge
        qtype, qarg, ans = OPPOSITE[d], v, u
    edges_1 = [(s + 1, t + 1, dd + 1) for (s, t, dd) in edges]
    return _block(edges_1, [(qtype + 1, (qarg + 1,), ans + 1)])


def gen_task15(rng: np.random.Generator) -> str:
    """Deduction: instances --is-a(1)--> class --afraid-of(2)--> class.

    Question (1, instance) → the class node its class is afraid of."""
    n_classes = 4
    classes = list(range(n_classes))  # node ids 0..3
    # afraid-of: a permutation-ish map with no self-fear
    fear = [int((c + 1 + rng.integers(0, n_classes - 1)) % n_classes) for c in classes]
    n_inst = int(rng.integers(3, 6))
    edges = []
    inst_class = []
    for i in range(n_inst):
        c = int(rng.integers(0, n_classes))
        inst_class.append(c)
        edges.append((n_classes + i, 0, c))           # is-a
    for c in classes:
        edges.append((c, 1, fear[c]))                  # afraid-of
    qi = int(rng.integers(0, n_inst))
    ans = fear[inst_class[qi]]
    edges_1 = [(s + 1, t + 1, d + 1) for (s, t, d) in edges]
    return _block(edges_1, [(1, (n_classes + qi + 1,), ans + 1)])


def gen_task16(rng: np.random.Generator) -> str:
    """Induction: instance --is-a(1)--> type; instance --has-color(2)--> color.

    Question (1, instance-without-color) → color of its colored sibling."""
    n_types, n_colors = 3, 3
    type_nodes = list(range(n_types))                  # 0..2
    color_nodes = [n_types + c for c in range(n_colors)]  # 3..5
    type_color = [int(rng.integers(0, n_colors)) for _ in type_nodes]
    n_inst = int(rng.integers(3, 6))
    base = n_types + n_colors
    inst_type = [int(rng.integers(0, n_types)) for _ in range(n_inst)]
    # query instance: gets no color edge; every other instance gets its
    # type's canonical color so induction is unambiguous
    qi = int(rng.integers(0, n_inst))
    # ensure the query's type has at least one colored sibling BEFORE
    # emitting edges (the sibling must exist in the actual graph)
    if sum(1 for j in range(n_inst) if j != qi and inst_type[j] == inst_type[qi]) == 0:
        j = (qi + 1) % n_inst
        inst_type[j] = inst_type[qi]
    edges = []
    for i in range(n_inst):
        edges.append((base + i, 0, inst_type[i]))      # is-a
    for j in range(n_inst):
        if j != qi:
            edges.append((base + j, 1, color_nodes[type_color[inst_type[j]]]))
    ans = color_nodes[type_color[inst_type[qi]]]
    edges_1 = [(s + 1, t + 1, d + 1) for (s, t, d) in edges]
    return _block(edges_1, [(1, (base + qi + 1,), ans + 1)])


def gen_task18(rng: np.random.Generator) -> str:
    """Size reasoning: objects in a total order; edge (u,1,v) = "u bigger than v".

    Consecutive-pair chain edges make every comparison derivable by
    transitivity.  Two question types (reference family has qtype per
    phrasing): qtype 1 = "is A bigger than B?", qtype 2 = "is A smaller
    than B?".  Answer classes: 1 = no, 2 = yes."""
    n = int(rng.integers(4, 7))
    order = rng.permutation(n)  # order[0] is biggest
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)
    edges = [(int(order[i]), 0, int(order[i + 1])) for i in range(n - 1)]
    # extra redundant consistent edges
    for _ in range(int(rng.integers(0, 3))):
        i, j = sorted(rng.choice(n, size=2, replace=False).tolist(),
                      key=lambda x: rank[x])
        edges.append((int(i), 0, int(j)))
    a, b = rng.choice(n, size=2, replace=False).tolist()
    qtype = int(rng.integers(0, 2))
    bigger = bool(rank[a] < rank[b])
    yes = bigger if qtype == 0 else (not bigger)
    edges_1 = [(s + 1, t + 1, d + 1) for (s, t, d) in edges]
    return _block(edges_1, [(qtype + 1, (a + 1, b + 1), 2 if yes else 1)])


def gen_task19(rng: np.random.Generator) -> str:
    """Path finding: tree walk on the grid; answer = 2-step direction sequence.

    Question (1, src, dst) where dst is exactly two tree-hops from src; target
    is the comma-joined direction ids of the unique path (GGS-NN, task 19
    [BASELINE.json:10])."""
    while True:
        n = int(rng.integers(5, 8))
        coords, edges = _grid_walk(rng, n)
        n = len(coords)
        if n < 3:
            continue
        # adjacency with directions; tree ⇒ unique paths
        adj: dict[int, list[tuple[int, int]]] = {i: [] for i in range(n)}
        for (u, d, v) in edges:
            adj[u].append((d, v))
            adj[v].append((OPPOSITE[d], u))
        # find all (src, mid, dst) with dst two hops away (dst != src)
        cands = []
        for s in range(n):
            for d1, m in adj[s]:
                for d2, t in adj[m]:
                    if t != s:
                        cands.append((s, t, d1, d2))
        if not cands:
            continue
        s, t, d1, d2 = cands[int(rng.integers(0, len(cands)))]
        edges_1 = [(a + 1, ty + 1, b + 1) for (a, ty, b) in edges]
        return _block(edges_1, [(1, (s + 1, t + 1), (d1 + 1, d2 + 1))])


GENERATORS = {4: gen_task4, 15: gen_task15, 16: gen_task16,
              18: gen_task18, 19: gen_task19}


def generate_task_file(task_id: int, n_examples: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    gen = GENERATORS[task_id]
    return "\n\n".join(gen(rng) for _ in range(n_examples)) + "\n"


def generate_all(root: str, tasks=(4, 15, 16, 18, 19), folds=(1,),
                 n_train: int = 50, n_test: int = 50, seed: int = 0) -> None:
    """Write ``<root>/processed_<fold>/{train,test}/<task>_graphs.txt``.

    Defaults follow the paper's headline setting: 50 training examples per
    task (SURVEY.md §2.2).  Each (fold, split, task) triple gets an
    independent seed so folds are honest resamples."""
    for fold in folds:
        for split, count, salt in (("train", n_train, 0), ("test", n_test, 1)):
            d = os.path.join(root, f"processed_{fold}", split)
            os.makedirs(d, exist_ok=True)
            for t in tasks:
                text = generate_task_file(
                    t, count, seed=hash((seed, fold, salt, t)) % (2**31))
                with open(os.path.join(d, f"{t}_graphs.txt"), "w") as f:
                    f.write(text)
