"""NumPy oracle: dense single-graph GGNN/GGS-NN, straight from SURVEY.md §2.3.

The port's own copy of ``ggnn_tpu/oracle/numpy_ggnn.py``, its math
unchanged (its results are bit-equal to that module's): the port imports
nothing of the JAX package, and this module imports numpy only.

Unbatched, float64-friendly, dense and per-edge — the independent ground
truth for the port's compute paths (the plain torch path, the CUDA kernels,
the sharded halo-exchange path), on the CPU and, from the card's outputs
copied to the host, in ``chip_smoke.py``'s ``[oracle]`` phase.  The
dense-adjacency route mirrors the reference family's
``create_adjacency_matrix`` + ``bmm`` math (SURVEY.md §2.1 C3, §3.2) and is
kept ONLY here; production paths use typed COO.

Parameter tree convention: the tree of :mod:`ggnn_tpu_torch.models`, as
``ggnn_tpu_torch.models.init.params_to_numpy`` gives it (f32 leaves; cast
them to f64 for an f64 oracle):

``prop`` (propagation, SURVEY.md §2.3):
    - ``msg_w``: [2E, D, D] per-message-type weight bank (t < E: forward /
      the reference's ``in_<t>``; t >= E: reverse / ``out_<t>``)
    - ``msg_b``: [2E, D]
    - ``gru``: ``wz uz bz  wr ur br  wh uh bh`` with W applied to the
      aggregated message a and U to the state h:
      ``z = σ(a·wz + h·uz + bz)``, ``r = σ(a·wr + h·ur + br)``,
      ``h̃ = tanh(a·wh + (r⊙h)·uh + bh)``, ``h ← (1−z)⊙h + z⊙h̃``
    - ``gate_p``, ``gate_q`` (with ``edge_gates``): the SDDMM gate's P, Q

Heads (SURVEY.md §2.1 C7a–C7d):
    - node_select / per_node: ``w1 [D+A, H], b1, w2 [H, C], b2`` (C=1 for
      node selection), tanh hidden
    - graph_gated: ``gi_w [D+A, G], gi_b, gj_w [D+A, G], gj_b`` then
      classifier ``c1 [G, G], c1b, c2 [G, C], c2b`` (tanh hidden)
    - ggsnn: ``out`` = a graph_gated head over the per-step vocab (or a
      node_select head for the node output),
      ``ann``  = per-node annotation net ``a1 [D+A, H], a1b, a2 [H, A], a2b``
      (tanh hidden, sigmoid output → next-round annotations X^{(k+1)})
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def dense_adjacency(n: int, edges, n_edge_types: int) -> np.ndarray:
    """Reference-style dense A ∈ R^{n × n·2E} (SURVEY.md §2.1 C3).

    ``edges`` are LOGICAL (src, type, dst), 0-indexed.  In-block
    ``A[dst, t·n + src] = 1``; out-block ``A[src, (t+E)·n + dst] = 1``."""
    E = n_edge_types
    A = np.zeros((n, n * 2 * E), np.float64)
    for (s, t, d) in np.asarray(edges).reshape(-1, 3):
        A[d, t * n + s] += 1.0
        A[s, (t + E) * n + d] += 1.0
    return A


def directed_edges(edges, n_edge_types: int) -> np.ndarray:
    """Logical (src,type,dst) → directed message edges with 2E types
    (forward copy + reverse copy), matching graph.py's convention."""
    e = np.asarray(edges).reshape(-1, 3)
    fwd = e
    rev = np.stack([e[:, 2], e[:, 1] + n_edge_types, e[:, 0]], axis=1)
    return np.concatenate([fwd, rev], axis=0)


def aggregate(h: np.ndarray, dir_edges: np.ndarray, msg_w, msg_b,
              gate_p=None, gate_q=None) -> np.ndarray:
    """a_v = Σ over directed edges (u,t,v): g_uv · (h_u · msg_w[t] + msg_b[t]).

    With ``gate_p/gate_q`` set, g_uv = σ(⟨h_u·P, h_v·Q⟩) — the SDDMM
    edge-feature gate (BASELINE.json:5; capability extension over the
    reference, SURVEY.md §2.4); otherwise g_uv = 1."""
    n, D = h.shape
    a = np.zeros((n, D), h.dtype)
    p = h @ gate_p if gate_p is not None else None
    q = h @ gate_q if gate_q is not None else None
    for (u, t, v) in dir_edges:
        g = _sigmoid(p[u] @ q[v]) if p is not None else 1.0
        a[v] += g * (h[u] @ msg_w[t] + msg_b[t])
    return a


def aggregate_dense(h: np.ndarray, A: np.ndarray, msg_w, msg_b) -> np.ndarray:
    """Reference-style route: per-type transformed states, then A·states
    (SURVEY.md §3.2).  Must equal :func:`aggregate` exactly."""
    n, D = h.shape
    n_types = msg_w.shape[0]  # 2E
    # states[t] = h · W_t + b_t, stacked to [n·2E, D] in type-major order
    states = np.concatenate([h @ msg_w[t] + msg_b[t] for t in range(n_types)], axis=0)
    return A @ states


def gru_update(gru: dict, h: np.ndarray, a: np.ndarray) -> np.ndarray:
    z = _sigmoid(a @ gru["wz"] + h @ gru["uz"] + gru["bz"])
    r = _sigmoid(a @ gru["wr"] + h @ gru["ur"] + gru["br"])
    htil = np.tanh(a @ gru["wh"] + (r * h) @ gru["uh"] + gru["bh"])
    return (1.0 - z) * h + z * htil


def init_state(annotations: np.ndarray, state_dim: int) -> np.ndarray:
    """h^(1) = pad(x, D) (SURVEY.md §2.3)."""
    n, A = annotations.shape
    h = np.zeros((n, state_dim), np.float64)
    h[:, :A] = annotations
    return h


def oracle_propagate(prop: dict, annotations: np.ndarray, edges,
                     n_edge_types: int, n_steps: int,
                     h0: np.ndarray | None = None) -> list[np.ndarray]:
    """T-step propagation; returns [h^(1), h^(2), ..., h^(T+1)] for
    per-step parity checks (BASELINE.json:5 allclose requirement)."""
    D = prop["msg_w"].shape[-1]
    h = init_state(annotations, D) if h0 is None else np.asarray(h0, np.float64)
    de = directed_edges(edges, n_edge_types)
    out = [h]
    for _ in range(n_steps):
        a = aggregate(h, de, prop["msg_w"], prop["msg_b"],
                      prop.get("gate_p"), prop.get("gate_q"))
        h = gru_update(prop["gru"], h, a)
        out.append(h)
    return out


def oracle_propagate_dense(prop: dict, annotations: np.ndarray, edges,
                           n_edge_types: int, n_steps: int) -> list[np.ndarray]:
    """Same recurrence via the reference-style dense adjacency."""
    D = prop["msg_w"].shape[-1]
    h = init_state(annotations, D)
    A = dense_adjacency(h.shape[0], edges, n_edge_types)
    out = [h]
    for _ in range(n_steps):
        a = aggregate_dense(h, A, prop["msg_w"], prop["msg_b"])
        h = gru_update(prop["gru"], h, a)
        out.append(h)
    return out


def _mlp2(p: dict, x: np.ndarray, w1="w1", b1="b1", w2="w2", b2="b2"):
    return np.tanh(x @ p[w1] + p[b1]) @ p[w2] + p[b2]


def oracle_node_select(head: dict, h: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """o_v = MLP([h_v ; x_v]) → per-node scalar score (softmax over nodes
    is part of the loss, not the head) — SURVEY.md §2.1 C7a."""
    hx = np.concatenate([h, annotations], axis=1)
    return _mlp2(head, hx)[:, 0]


def oracle_per_node(head: dict, h: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """[n, C] per-node class scores — SURVEY.md §2.1 C7b."""
    hx = np.concatenate([h, annotations], axis=1)
    return _mlp2(head, hx)


def graph_gated_pool(head: dict, h: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """h_G = Σ_v σ(i([h;x])) ⊙ tanh(j([h;x])) — SURVEY.md §2.1 C7c, paper eq. 7."""
    hx = np.concatenate([h, annotations], axis=1)
    gate = _sigmoid(hx @ head["gi_w"] + head["gi_b"])
    val = np.tanh(hx @ head["gj_w"] + head["gj_b"])
    return (gate * val).sum(axis=0)


def oracle_graph_gated(head: dict, h: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """Graph-level logits via gated readout + tanh-hidden classifier."""
    hG = graph_gated_pool(head, h, annotations)
    return _mlp2(head, hG[None, :], "c1", "c1b", "c2", "c2b")[0]


def annotation_update(ann_net: dict, h: np.ndarray, annotations: np.ndarray) -> np.ndarray:
    """X^{(k+1)} = σ(F_x([h;x])) per node — GGS-NN annotation net (SURVEY.md §3.4)."""
    hx = np.concatenate([h, annotations], axis=1)
    return _sigmoid(_mlp2(ann_net, hx, "a1", "a1b", "a2", "a2b"))


def oracle_ggsnn(params: dict, annotations: np.ndarray, edges,
                 n_edge_types: int, n_steps: int, n_rounds: int,
                 output: str = "graph"):
    """GGS-NN (SURVEY.md §3.4): per round k — propagate T steps from
    h=pad(X^{(k)}), emit the round output, update annotations.
    ``output``: 'graph' (token logits via gated readout) or 'node'
    (node-selection scores — the paper's alternative F_o).  Propagation/
    head weights shared across rounds (paper's shared-weights option).
    Returns (list of per-round outputs, list of per-round final h,
    list of annotations X^{(k)})."""
    prop, out_head, ann_net = params["prop"], params["out"], params["ann"]
    X = np.asarray(annotations, np.float64)
    logits, hs, anns = [], [], [X]
    for _ in range(n_rounds):
        h = oracle_propagate(prop, X, edges, n_edge_types, n_steps)[-1]
        if output == "node":
            logits.append(oracle_node_select(out_head, h, X))
        else:
            logits.append(oracle_graph_gated(out_head, h, X))
        X = annotation_update(ann_net, h, X)
        hs.append(h)
        anns.append(X)
    return logits, hs, anns
