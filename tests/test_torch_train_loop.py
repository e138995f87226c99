"""The port's training layer against the JAX package's: the optimizer
against optax, one ``Trainer`` step from shared initial parameters, bAbI
task 4 to paper-level accuracy, exact checkpoint resume, every registered
config, the CLI without jax, and the paths that are not ported yet.

Tolerances: the optimizer and one Trainer step compare parameters in f32 at
rtol = 1e-5, atol = 1e-6 (Adam's first steps move each entry by about lr ×
sign(g), so gradients that agree to 1e-5 give updates that agree to
lr·1e-5).  The node_select head's output bias is the exception: shifting
every score leaves the softmax unchanged, so its gradient is rounding
noise and Adam's first step moves it by an arbitrary amount up to lr in
either package; it is held to that bound.  Resume is exact (bit for bit).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from ggnn_tpu.train import Trainer as JaxTrainer
from ggnn_tpu.train import build_config as jax_build_config
from ggnn_tpu.train.metrics import MetricsLogger as JaxLogger
from ggnn_tpu_torch.models import ModelConfig, init_params, params_from_numpy
from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
from ggnn_tpu_torch.train import CONFIGS, Trainer, build_config
from ggnn_tpu_torch.train.checkpoint import _flatten
from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                       make_train_step, param_leaves)
from ggnn_tpu_torch.train.metrics import MetricsLogger

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """bAbI data of the size the registered configs generate by default
    (so no test depends on which test generated it first)."""
    from ggnn_tpu.data.babi import TASKS
    from ggnn_tpu.data.generators import generate_all
    root = str(tmp_path_factory.mktemp("babi_data"))
    for tid in (4, 15, 16, 18, 19):
        n = max(50 * TASKS[tid].n_question_types, 50)
        generate_all(root, tasks=(tid,), folds=(1,), n_train=n, n_test=n,
                     seed=0)
    return root


def _quiet():
    return MetricsLogger(echo=False)


def _flat(tree):
    return dict(_flatten(tree))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_optimizer_matches_optax(weight_decay):
    """torch Adam / AdamW as make_optimizer builds them against optax.adam
    / optax.adamw over three steps of the same gradients."""
    r = np.random.default_rng(0)
    tree = {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": r.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
        np.float32), tree) for _ in range(3)]
    opt = (optax.adamw(1e-3, weight_decay=weight_decay) if weight_decay
           else optax.adam(1e-3))
    jp = jax.tree.map(jax.numpy.asarray, tree)
    state = opt.init(jp)
    tp = params_from_numpy(tree)
    for p in param_leaves(tp):
        p.requires_grad_(True)
    topt = make_optimizer(tp, 1e-3, weight_decay)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jax.numpy.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gv in zip(param_leaves(tp), param_leaves(params_from_numpy(g))):
            p.grad = gv
        topt.step()
    for p, ref in zip(param_leaves(tp), param_leaves(
            params_from_numpy(jax.tree.map(np.asarray, jp)))):
        np.testing.assert_allclose(p.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_trainer_step_matches_jax(data_root):
    """One train step of both Trainers on the same bAbI-4 batch, the port
    starting from the JAX Trainer's initial parameters: the same metrics
    and the same parameters after the Adam step."""
    kw = dict(epochs=1, n_train=10, n_test=5, data_root=data_root)
    jt = JaxTrainer(jax_build_config("babi4", **kw), JaxLogger(echo=False))
    tt = Trainer(build_config("babi4", **kw), _quiet(), device="cpu")
    init = params_from_numpy(jax.tree.map(np.asarray, jt.params))
    with torch.no_grad():
        for p, v in zip(param_leaves(tt.params), param_leaves(init)):
            p.copy_(v)
    batch = next(iter(jt.train_loader.epoch_batches(0)))
    jparams, _, jm = jt.train_step(jt.params, jt.opt_state, batch.arrays,
                                   None)
    tm = tt.train_step(tt.params, batch_arrays(batch, "cpu"))
    for k in ("loss_sum", "correct", "count"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    ref = params_from_numpy(jax.tree.map(np.asarray, jparams))
    for (key, p), (_, v) in zip(_flatten(tt.params), _flatten(ref)):
        if key == "head/b2":
            start = _flat(init)[key]
            assert (p.detach() - start).abs().max() <= 1e-3 * (1 + 1e-5)
            assert (v - start).abs().max() <= 1e-3 * (1 + 1e-5)
            continue
        np.testing.assert_allclose(p.detach().numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_babi4_end_to_end(data_root, tmp_path):
    """The port trains bAbI task 4 to ≥ 95 % test accuracy on the CPU (as
    tests/test_train.py holds the JAX package), with parseable metrics."""
    cfg = build_config("babi4", epochs=80, data_root=data_root,
                       metrics_path=str(tmp_path / "m.jsonl"))
    result = Trainer(cfg, MetricsLogger(cfg.metrics_path, echo=False),
                     device="cpu").run()
    assert result["test_accuracy"] >= 0.95
    import json
    lines = [json.loads(line) for line in open(cfg.metrics_path)]
    assert any("test_accuracy" in rec for rec in lines)
    assert all("ts" in rec for rec in lines)


def test_checkpoint_resume_exact(data_root, tmp_path):
    """save/restore of params and the optimizer state reproduces the exact
    training curve."""
    cfg = build_config("babi4", epochs=6, data_root=data_root)
    t1 = Trainer(cfg, _quiet(), device="cpu")
    for _ in range(3):
        t1.train_epoch()
    ckpt = str(tmp_path / "ck.npz")
    t1.save(ckpt)
    for _ in range(3):
        t1.train_epoch()
    t2 = Trainer(cfg, _quiet(), device="cpu")
    with torch.no_grad():                  # another state before restoring
        for p in param_leaves(t2.params):
            p.add_(1.0)
    t2.restore(ckpt)
    assert t2.epoch == 3 and t2.step == t1.step - 3 * len(t1.train_loader)
    for _ in range(3):
        t2.train_epoch()
    for a, b in zip(param_leaves(t1.params), param_leaves(t2.params)):
        assert torch.equal(a, b)
    for a, b in zip(param_leaves(t1.params), param_leaves(t2.params)):
        s1, s2 = t1.optimizer.state[a], t2.optimizer.state[b]
        assert torch.equal(s1["exp_avg"], s2["exp_avg"])
        assert float(s1["step"]) == float(s2["step"])


@pytest.mark.parametrize("name", ["babi4", "babi15", "babi16", "babi18"])
def test_config_builds_and_steps(name, data_root):
    """Every registered config the port can train constructs and takes one
    epoch and one evaluation; the registry mirrors the reference's."""
    assert sorted(CONFIGS) == sorted(
        __import__("ggnn_tpu.train.config", fromlist=["CONFIGS"]).CONFIGS)
    cfg = build_config(name, epochs=1, n_train=10, n_test=5,
                       data_root=data_root)
    ref = jax_build_config(name, epochs=1, n_train=10, n_test=5,
                           data_root=data_root)
    import dataclasses
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    t = Trainer(cfg, _quiet(), device="cpu")
    rec = t.train_epoch()
    assert np.isfinite(rec["loss"])
    assert 0.0 <= t.evaluate()["accuracy"] <= 1.0


@pytest.mark.parametrize("name", ["babi19", "babi19_small"])
def test_ggsnn_configs_raise(name, data_root):
    cfg = build_config(name, epochs=1, n_train=10, n_test=5,
                       data_root=data_root)
    with pytest.raises(NotImplementedError, match="GGS-NN"):
        Trainer(cfg, _quiet(), device="cpu")


def test_unported_training_paths_raise(data_root):
    """The onehot Trainer (the reference batches it with the legacy
    layout) and a CUDA device without a card (the default) raise instead of
    training something else."""
    cfg = build_config("babi4", epochs=1, n_train=10, n_test=5,
                       data_root=data_root, backend="onehot")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        Trainer(cfg, _quiet(), device="cpu")
    if not torch.cuda.is_available():
        # the card is the default device: without one, the default raises
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                Trainer(build_config("babi4", data_root=data_root), _quiet(),
                        **kw)


def test_make_train_step_drives_the_typed_pack():
    """make_train_step takes any scatter layout, as the headline trains:
    three Adam steps through the typed pack (onehot fused, bf16) give
    finite losses, and the first moves every entry by at most lr."""
    N, E, T = 256, 2000, 2
    r = np.random.default_rng(0)
    src, dst = r.integers(0, N, E), r.integers(0, N, E)
    typ = r.integers(0, 2 * T, E)
    lay = build_typed_dst_layout(src, dst, typ, np.ones(E, np.float32), N,
                                 2 * T, with_grad=True).to("cpu")
    cfg = ModelConfig(state_dim=128, annotation_dim=4, n_edge_types=T,
                      n_steps=2, head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=True)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    for p in param_leaves(params):
        p.requires_grad_(True)
    before = [p.detach().clone() for p in param_leaves(params)]
    arrays = dict(
        annotations=torch.tensor((r.random((N, 4)) < 0.3).astype(
            np.float32)),
        node_graph=torch.zeros(N, dtype=torch.int32),
        node_mask=torch.ones(N), n_nodes=torch.tensor([N], dtype=torch.int32),
        edge_src=torch.tensor(src), edge_dst=torch.tensor(dst),
        edge_type=torch.tensor(typ), edge_mask=torch.ones(E),
        targets={"node": torch.tensor([7], dtype=torch.int32)})
    step = make_train_step(cfg, 1, make_optimizer(params, 1e-3))
    losses = []
    for i in range(3):
        losses.append(float(step(params, arrays, lay)["loss_sum"]))
        if i == 0:
            for p, b in zip(param_leaves(params), before):
                assert (p.detach() - b).abs().max() <= 1e-3 * (1 + 1e-5)
    assert np.isfinite(losses).all()


def test_cli_runs_one_epoch_without_jax(data_root):
    """python -m ggnn_tpu_torch.train trains one epoch on the CPU and
    prints its result; jax is never imported."""
    code = (
        "import sys, json, torch\n"
        "torch.set_num_threads(1)\n"
        "from ggnn_tpu_torch.train.__main__ import main\n"
        f"rc = main(['--config', 'babi4', '--epochs', '1', '--n_train', "
        f"'10', '--n_test', '5', '--data_root', {data_root!r}, "
        "'--device', 'cpu'])\n"
        "print('JAX_LOADED', 'jax' in sys.modules, rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "JAX_LOADED False 0"
    import json
    result = json.loads(lines[-2])
    assert result["config"] == "babi4" and result["epochs"] == 1
    assert np.isfinite(result["test_loss"])
