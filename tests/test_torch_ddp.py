"""The port's sharded task training (``make_sharded_task_train_step``, all
four heads and GGS-NN), its sharded eval step and its data-parallel step
(``ggnn_tpu_torch/parallel/train.py``) against the JAX package, at P = 2
and P = 4, the ranks in their own processes; and the multi-process
bootstrap (``parallel/multihost.py``).

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``, which
joins the world from the environment alone) runs every case.  Graphs span
the shard boundaries.  The JAX side is the reference's own yardstick: its
single-device loss and gradients (``loss_and_metrics`` under
``jax.value_and_grad``, stepped by ``optax.adam`` as its
``make_train_step`` does), and for the data-parallel step its
``make_gspmd_train_step`` on the conftest's 8-device CPU mesh.

Tolerances (f32, the same math summed in another order): the reference's
(the loss curve ``rtol=2e-4``, 3e-4 for GGS-NN; metrics ``correct`` and
``count`` exact; parameters after 3 Adam steps ``rtol=2e-3, atol=2e-4``),
and every first-step gradient leaf within 1e-4 of the leaf's scale.  A
leaf whose gradient vanishes by the model's symmetry (the node-selection
score's bias, ``head/b2`` or GGS-NN's ``out/b2``) has no scale of its
own: within 1e-6 of the gradient's norm in both packages, and after the
Adam steps within their budget of lr-sized moves."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch.distributed as dist

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import loss_and_metrics as jax_loss_and_metrics
from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.parallel.train import (make_gspmd_train_step,
                                     shard_batch_arrays as jax_shard)
from ggnn_tpu_torch.parallel import multihost
from ggnn_tpu_torch.parallel.train import (NODE_TARGETS, part_bounds,
                                           split_batch)

import torch_dist_cases as C
from torch_dist_worker import RankJob

LR, STEPS = 1e-2, 3
TOL_GRAD = 1e-4


def _node_target(rng, n):
    return {"targets": {"node": np.asarray(int(rng.integers(0, n)),
                                           np.int32)}}


def _cls_target(rng, n):
    return {"targets": {"cls": np.asarray(int(rng.integers(0, 3)),
                                          np.int32)}}


def _labels(rng, n):
    return {"node_targets": {"node_labels": rng.integers(-1, 3, n).astype(
        np.int32)}}


def _seq(K, sup):
    def make(rng, n):
        klen = int(rng.integers(1, K + 1))
        seq = np.full(K, -1, np.int32)
        seq[:klen] = rng.integers(0, 5, klen)
        nodes = np.full(K, -1, np.int32)
        nodes[:klen] = rng.integers(0, n, klen)
        g = {"targets": {"seq": seq, "seq_nodes": nodes}}
        if sup:
            g["node_targets"] = {"ann_seq": (rng.random((n, K, 2)) < 0.5)
                                 .astype(np.float32)}
        return g
    return make


def _configs():
    """name -> (batch, model config, targets keys, steps)."""
    rng = np.random.default_rng(0)
    base = dict(annotation_dim=2, n_edge_types=3)
    out = {}
    b = C.batch_of(C.random_graphs(rng, 1024, 20, 40,
                                   targets=_node_target), 1024)
    out["ns"] = (b, dict(base, state_dim=8, n_steps=3, head="node_select"),
                 ("node",), STEPS)
    b = C.batch_of(C.random_graphs(rng, 256, 10, 20, targets=_cls_target),
                   256)
    out["gg"] = (b, dict(base, state_dim=8, n_steps=3, head="graph_gated",
                         n_classes=3), ("cls",), STEPS)
    b = C.batch_of(C.random_graphs(rng, 256, 10, 20, targets=_labels), 256)
    out["pn"] = (b, dict(base, state_dim=8, n_steps=3, head="per_node",
                         n_classes=3), ("node_labels",), STEPS)
    g = dict(base, state_dim=8, n_steps=2, head="ggsnn", n_classes=5,
             n_rounds=3)
    b = C.batch_of(C.random_graphs(rng, 256, 10, 20, targets=_seq(3, False)),
                   256)
    out["ggsnn-graph"] = (b, dict(g, ggsnn_output="graph"), ("seq",), STEPS)
    b = C.batch_of(C.random_graphs(rng, 256, 10, 20, targets=_seq(3, True)),
                   256)
    out["ggsnn-node-sup"] = (b, dict(g, ggsnn_output="node",
                                     ann_supervision=True),
                             ("seq_nodes", "ann_seq"), STEPS)
    b = C.batch_of(C.random_graphs(rng, 128, 8, 16, n_types=2,
                                   targets=_seq(2, False)), 128, n_types=2)
    out["ggsnn-perround"] = (b, dict(base, n_edge_types=2, state_dim=8,
                                     n_steps=2, head="ggsnn", n_classes=5,
                                     n_rounds=2, share_round_nets=False),
                             ("seq",), 1)
    # whole graphs per rank: a graph count that 2 and 4 divide (padding
    # graphs of no node at the end)
    graphs = C.random_graphs(rng, 256, 10, 20, targets=_node_target)
    out["ddp-ns"] = (C.batch_of(graphs, 256,
                                n_graphs=-(-len(graphs) // 4) * 4),
                     dict(base, state_dim=8, n_steps=3, head="node_select"),
                     ("node",), 1)
    graphs = C.random_graphs(rng, 256, 10, 20, targets=_seq(3, True))
    out["ddp-ggsnn"] = (C.batch_of(graphs, 256,
                                   n_graphs=-(-len(graphs) // 4) * 4),
                        dict(g, ggsnn_output="node", ann_supervision=True),
                        ("seq_nodes", "ann_seq"), 1)
    # any graph count over any rank count: parts of unequal graph counts
    # (empty slots), ranks with no graph, and a part whose graphs fill its
    # rows with an empty slot after them (128 | 60 + 60 at P = 2)
    heads = {"ns": (_node_target, "ns"), "gg": (_cls_target, "gg"),
             "pn": (_labels, "pn"),
             "ggsnn": (_seq(3, True), "ggsnn-node-sup")}
    for name, (head, n_graphs, _) in UNEVEN.items():
        targets, like = heads[head]
        sizes = ((128, 60, 60) if name.endswith("tight")
                 else rng.integers(10, 20, n_graphs))
        graphs = C.sized_graphs(rng, sizes, targets=targets)
        out[name] = (C.batch_of(graphs, int(sum(sizes))), *out[like][1:3], 1)
    return out


# name -> (head, graphs, ranks) of the uneven data-parallel cases
UNEVEN = {"ddp-ns-3g-2": ("ns", 3, 2), "ddp-ns-2g-4": ("ns", 2, 4),
          "ddp-ns-tight": ("ns", 3, 2),
          "ddp-gg-3g-2": ("gg", 3, 2), "ddp-gg-2g-4": ("gg", 2, 4),
          "ddp-gg-5g-4": ("gg", 5, 4),
          "ddp-pn-3g-2": ("pn", 3, 2), "ddp-pn-2g-4": ("pn", 2, 4),
          "ddp-ggsnn-3g-2": ("ggsnn", 3, 2),
          "ddp-ggsnn-2g-4": ("ggsnn", 2, 4),
          "ddp-ggsnn-6g-4": ("ggsnn", 6, 4)}


CONFIGS = _configs()
WINDOW = dict(kind="window", window=64, min_edges_per_tile=4,
              spill_tile_e=16, n_message_types=6, with_grad=True)
TASKS = [("ns", "halo_overlap"), ("ns", "halo_window"), ("gg", "halo"),
         ("pn", "halo_overlap"), ("ggsnn-graph", "halo_overlap"),
         ("ggsnn-node-sup", "halo"), ("ggsnn-perround", "halo_overlap")]


def _targets(b, keys):
    return {"n_nodes": b.n_nodes, **{k: b.targets[k] for k in keys}}


def _cases():
    cases = []
    for cfg_name, strategy in TASKS:
        b, cfg, keys, steps = CONFIGS[cfg_name]
        for P in (2, 4):
            cases.append(dict(
                name=f"{cfg_name}-{strategy}-{P}", kind="task", P=P,
                batch=b, cfg=cfg, params=C.jax_params(3, **cfg),
                strategy=strategy, lr=LR, steps=steps,
                n_graphs=b.spec.n_graphs, targets=_targets(b, keys),
                layout=WINDOW if strategy == "halo_window" else None))
    for cfg_name in ("ns", "ggsnn-graph"):
        b, cfg, keys, _ = CONFIGS[cfg_name]
        for P in (2, 4):
            cases.append(dict(
                name=f"eval-{cfg_name}-{P}", kind="eval", P=P, batch=b,
                cfg=cfg, params=C.jax_params(3, **cfg),
                strategy="halo_overlap", n_graphs=b.spec.n_graphs,
                targets=_targets(b, keys)))
    ddp = [(f"{c}-{P}", c, P) for c in ("ddp-ns", "ddp-ggsnn")
           for P in (2, 4)]
    ddp += [(name, name, P) for name, (_, _, P) in UNEVEN.items()]
    for name, cfg_name, P in ddp:
        b, cfg, _, _ = CONFIGS[cfg_name]
        cases.append(dict(name=name, kind="ddp", P=P, batch=b, cfg=cfg,
                          lr=LR, params=C.jax_params(3, **cfg),
                          n_graphs=b.spec.n_graphs))
    return cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = _cases()
    j = RankJob(cases, 4, tmp_path_factory.mktemp("task_ranks"),
                timeout=600)
    j.cases = {c["name"]: c for c in cases}
    yield j
    j.wait()


def _jax_curve(cfg_name):
    """The JAX package's single-device run: per step (loss_sum, correct,
    count), the first step's gradients, the parameters after the steps."""
    b, cfg_kw, _, steps = CONFIGS[cfg_name]
    cfg = JaxConfig(**cfg_kw)
    arrays = jax.tree.map(jnp.asarray, C.to_jax_batch(b).arrays)
    G = b.spec.n_graphs
    vg = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_and_metrics(p, cfg, arrays, G), has_aux=True))
    params = jax.tree.map(jnp.asarray, C.jax_params(3, **cfg_kw))
    opt = optax.adam(LR)
    state = opt.init(params)
    metrics, first = [], None
    for _ in range(steps):
        (_, m), g = vg(params)
        metrics.append([float(m[k]) for k in ("loss_sum", "correct",
                                              "count")])
        if first is None:
            first = C.flat_tree(jax.tree.map(np.asarray, g))
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return (np.asarray(metrics), first,
            C.flat_tree(jax.tree.map(np.asarray, params)))


def _jax_gspmd(cfg_name):
    """The JAX package's GSPMD step (one step) on the 8-device mesh:
    (metrics, parameters)."""
    b, cfg_kw, _, _ = CONFIGS[cfg_name]
    cfg = JaxConfig(**cfg_kw)
    arrays = jax.tree.map(jnp.asarray, C.to_jax_batch(b).arrays)
    mesh = jax_make_mesh(n_graph=4, n_data=2)
    opt = optax.adam(LR)
    params = jax.tree.map(jnp.asarray, C.jax_params(3, **cfg_kw))
    step = make_gspmd_train_step(cfg, b.spec.n_graphs, opt, mesh)
    p, _, m = step(params, opt.init(params), jax_shard(arrays, mesh))
    return (np.asarray([float(m[k]) for k in ("loss_sum", "correct",
                                              "count")]),
            C.flat_tree(jax.tree.map(np.asarray, p)))


@pytest.fixture(scope="module")
def refs(job):
    names = [n for n in CONFIGS]
    with ThreadPoolExecutor(max(1, min(3, (os.cpu_count() or 2) - 1))) as ex:
        out = dict(zip(names, ex.map(_jax_curve, names)))
    out["gspmd"] = _jax_gspmd("ddp-ns")
    with ThreadPoolExecutor(max(1, min(3, (os.cpu_count() or 2) - 1))) as ex:
        out.update(zip([f"gspmd/{n}" for n in UNEVEN],
                       ex.map(_jax_gspmd, UNEVEN)))
    return out


def _port(job, name):
    """Rank 0's outputs; every rank of the case holds the same parameters,
    bit for bit."""
    out = job.result(name, 0)
    P = job.cases[name]["P"]
    ranks = range(P) if job.cases[name]["kind"] == "ddp" else range(4)
    for r in ranks:
        other = job.result(name, r)
        for k in out:
            if k.startswith("p/") or k == "metrics":
                np.testing.assert_array_equal(other[k], out[k], err_msg=k)
    return out


def _symmetric(cfg_name):
    """The leaves whose gradient vanishes by the model's symmetry: the
    bias of a node-selection score (shifting every node's score leaves the
    softmax unchanged), so 0 up to round-off in either package."""
    cfg = CONFIGS[cfg_name][1]
    if cfg["head"] == "node_select":
        return ("head/b2",)
    if cfg["head"] == "ggsnn" and cfg.get("ggsnn_output") == "node":
        return ("out/b2",)
    return ()


def _check_grads(out, ref, cfg_name):
    """Every leaf within TOL_GRAD of its scale; a symmetric leaf, which has
    no scale of its own, within 1e-6 of the whole gradient's norm in both
    packages."""
    got = {k[2:]: v for k, v in out.items() if k.startswith("g/")}
    norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                       for v in ref.values()))
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k in _symmetric(cfg_name):
            assert np.abs(got[k]).max() <= 1e-6 * norm, k
            assert np.abs(ref[k]).max() <= 1e-6 * norm, k
            continue
        np.testing.assert_allclose(
            got[k], ref[k], rtol=TOL_GRAD,
            atol=TOL_GRAD * float(np.abs(ref[k]).max()), err_msg=k)


def _check_params(out, ref, steps, cfg_name):
    for k, v in ref.items():
        got = out[f"p/{k}"]
        if k in _symmetric(cfg_name):
            # Adam turns each package's round-off there into lr-sized
            # steps in any direction: bounded by the steps' budget
            assert np.abs(got - v).max() < 3 * LR * steps, k
            continue
        np.testing.assert_allclose(got, v, rtol=2e-3, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("cfg_name,strategy", TASKS)
def test_sharded_task_training_matches_jax(job, refs, cfg_name, strategy,
                                           P):
    """Every head's sharded task step: the loss curve and metrics of each
    step, every first-step gradient leaf, and the parameters after the
    steps, against the JAX package's single-device training."""
    out = _port(job, f"{cfg_name}-{strategy}-{P}")
    metrics, grads, params = refs[cfg_name]
    got = out["metrics"]
    rtol = 3e-4 if cfg_name.startswith("ggsnn") else 2e-4
    np.testing.assert_allclose(got[:, 0] / got[:, 2],
                               metrics[:, 0] / metrics[:, 2], rtol=rtol)
    np.testing.assert_array_equal(got[:, 1:], metrics[:, 1:])
    _check_grads(out, grads, cfg_name)
    _check_params(out, params, CONFIGS[cfg_name][3], cfg_name)


@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("cfg_name", ("ns", "ggsnn-graph"))
def test_sharded_eval_step_matches_jax(job, refs, cfg_name, P):
    """The sharded eval step's metrics against the JAX package's
    single-device metrics at the same parameters."""
    got = _port(job, f"eval-{cfg_name}-{P}")["metrics"]
    np.testing.assert_allclose(got, refs[cfg_name][0][0], rtol=3e-4)


@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("cfg_name", ("ddp-ns", "ddp-ggsnn"))
def test_data_parallel_step_matches_jax(job, refs, cfg_name, P):
    """The data-parallel step (whole graphs per rank, the loss's
    denominators all-reduced, the gradients summed) against the JAX
    package's single-device step: metrics, every gradient leaf, the Adam
    step's parameters; node_select also against its GSPMD step."""
    out = _port(job, f"{cfg_name}-{P}")
    metrics, grads, params = refs[cfg_name]
    np.testing.assert_allclose(out["metrics"][0], metrics[0, 0], rtol=1e-5)
    np.testing.assert_array_equal(out["metrics"][1:], metrics[0, 1:])
    _check_grads(out, grads, cfg_name)
    _check_params(out, params, 1, cfg_name)
    if cfg_name == "ddp-ns":
        g_metrics, g_params = refs["gspmd"]
        np.testing.assert_allclose(out["metrics"], g_metrics, rtol=1e-4)
        _check_params(out, g_params, 1, cfg_name)


@pytest.mark.parametrize("name", sorted(UNEVEN))
def test_data_parallel_step_on_uneven_parts_matches_jax(job, refs, name):
    """The data-parallel step on a graph count the rank count does not
    divide (parts of unequal graph counts padded with empty slots, ranks
    with no graph, a part whose graphs fill its rows): metrics, every
    gradient leaf and the Adam step's parameters against the JAX package's
    single-device step, and against its GSPMD step on the 8-device mesh."""
    out = _port(job, name)
    metrics, grads, params = refs[name]
    np.testing.assert_allclose(out["metrics"][0], metrics[0, 0], rtol=1e-5)
    np.testing.assert_array_equal(out["metrics"][1:], metrics[0, 1:])
    _check_grads(out, grads, name)
    _check_params(out, params, 1, name)
    g_metrics, g_params = refs[f"gspmd/{name}"]
    np.testing.assert_allclose(out["metrics"], g_metrics, rtol=1e-4)
    _check_params(out, g_params, 1, name)


def test_split_batch_keeps_whole_graphs():
    """Each part holds its graphs' nodes and every real edge among them,
    re-indexed from 0; the parts together hold the whole batch, every
    graph once and in order, also where the parts hold unequal graph
    counts (empty slots at their ends) or none."""
    for cfg_name, P in (("ddp-ggsnn", 4), ("ddp-ggsnn-6g-4", 4),
                        ("ddp-ns-2g-4", 4), ("ddp-ns-tight", 2)):
        b = CONFIGS[cfg_name][0]
        parts = [split_batch(b, P, p) for p in range(P)]
        assert len({p.spec for p in parts}) == 1
        assert sum(int(p.edge_mask.sum()) for p in parts) == int(
            b.edge_mask.sum())
        bounds = part_bounds(b.n_nodes, P)
        assert bounds[-1] == b.spec.n_graphs
        if cfg_name == "ddp-ns-tight":      # real rows fill part 0's n_pad
            assert parts[0].node_mask.all() and parts[0].n_nodes[-1] == 0
        if cfg_name == "ddp-ns-2g-4":       # two ranks without a graph
            assert sum(not p.node_mask.any() for p in parts) == 2
        for key, val in [("n_nodes", b.n_nodes), *b.targets.items()]:
            if key in NODE_TARGETS:
                continue
            got = [getattr(p, key) if key == "n_nodes" else p.targets[key]
                   for p in parts]
            # every slot once, in order; then the part's empty slots
            np.testing.assert_array_equal(
                np.concatenate([g[:k] for g, k in
                                zip(got, np.diff(bounds))]), val,
                err_msg=key)
            for g, k in zip(got, np.diff(bounds)):
                assert (g[k:] == (-1 if key.startswith("seq")
                                  else 0)).all(), key
        np.testing.assert_array_equal(
            np.concatenate([p.annotations[p.node_mask > 0] for p in parts]),
            b.annotations[b.node_mask > 0])
        if "ann_seq" in b.targets:
            np.testing.assert_array_equal(
                np.concatenate([p.targets["ann_seq"][p.node_mask > 0]
                                for p in parts]),
                b.targets["ann_seq"][b.node_mask > 0])
        for p, k in zip(parts, np.diff(bounds)):
            m = p.edge_mask > 0
            n = int(p.node_mask.sum())
            assert n == int(p.n_nodes.sum())
            assert (p.edge_src[m] < n).all() and (p.edge_dst[m] < n).all()
            assert (p.node_graph[:n] < k).all()
            assert (p.node_graph[n:] == p.spec.n_graphs).all()
            np.testing.assert_array_equal(np.diff(p.type_offsets),
                                          np.bincount(p.edge_type[m],
                                                      minlength=6))


@pytest.mark.parametrize("n_nodes,P,bounds", [
    ((8,) * 8, 4, (0, 2, 4, 6, 8)),          # equal graphs, P | B: B/P
    ((6,) * 4, 3, (0, 2, 3, 4)),             # the dry run at n = 3
    ((16,) * 4, 8, (0, 1, 1, 2, 2, 3, 3, 4, 4)),   # at n = 8: empty ranks
    ((4096,) * 63, 2, (0, 32, 63)),          # chip_smoke's 63 graphs
    ((4096,), 2, (0, 1, 1)),                 # one graph: rank 1 empty
    ((128, 60, 60), 2, (0, 1, 3)),           # the first part fills 128
    ((5, 0, 5, 0), 2, (0, 1, 4)),            # empty slots in the batch
])
def test_part_bounds_cut_at_the_node_balance(n_nodes, P, bounds):
    """Part p ends at the first graph boundary at or past (p + 1)/P of the
    real nodes, the last at the last slot."""
    np.testing.assert_array_equal(part_bounds(n_nodes, P), bounds)


def test_multihost_noop_single_process(monkeypatch):
    """One process: initialize_multihost does nothing and says so; that
    process is the primary."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()
    assert multihost.is_primary()


def test_multihost_rendezvous_timeout_raises():
    """A rank whose peers never come fails after init_timeout_s, instead
    of hanging the job."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(dist.DistError):
        multihost.initialize_multihost(
            coordinator_address=f"127.0.0.1:{port}", num_processes=2,
            process_id=0, init_timeout_s=2, backend="gloo", device="cpu")
    assert not dist.is_initialized()


def test_rank_device_without_a_card_raises(monkeypatch):
    """The ranks' default device is the card: without one it raises, and
    the CPU is taken only when asked for."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multihost.rank_device()
    with pytest.raises(RuntimeError):
        multihost.initialize_multihost(coordinator_address="127.0.0.1:1",
                                       num_processes=2, process_id=0)
    assert str(multihost.rank_device("cpu")) == "cpu"


def test_env_rendezvous_joined_every_rank(job):
    """The ranks joined the world from the environment alone (torchrun's
    variables) and agreed on who is primary (checked in each rank)."""
    assert job.wait() == [0] * job.world
    for r in range(job.world):
        assert f"RANK_OK {r}" in job.log(r)
