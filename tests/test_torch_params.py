"""The port's configuration, parameters and checkpoints against the JAX
package's, and the port's independence from JAX.  Everything compared here
is exact: dataclass fields, shapes, key paths and stored values."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ggnn_tpu.data.babi import TASKS
from ggnn_tpu.graph import PaddingSpec
from ggnn_tpu.models import config as jax_config
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.train import checkpoint as jax_ckpt
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import config as torch_config
from ggnn_tpu_torch.models import init_params, params_to_numpy
from ggnn_tpu_torch.train import checkpoint as torch_ckpt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_model_config_matches_jax_field_for_field():
    fj = dataclasses.fields(jax_config.ModelConfig)
    ft = dataclasses.fields(torch_config.ModelConfig)
    assert [(f.name, f.type, f.default) for f in ft] == \
        [(f.name, f.type, f.default) for f in fj]
    for kw in (dict(backend="bogus"), dict(fuse_gru=True),
               dict(quantized_table=True), dict(backend="window",
                                                quantized_table=True),
               dict(backend="onehot", edge_gates=True)):
        with pytest.raises(ValueError) as ej:
            jax_config.ModelConfig(**kw)
        with pytest.raises(ValueError) as et:
            torch_config.ModelConfig(**kw)
        assert str(et.value) == str(ej.value)
    for task in TASKS.values():
        assert dataclasses.asdict(torch_config.model_config_for_task(
            task, state_dim=8)) == dataclasses.asdict(
            jax_config.model_config_for_task(task, state_dim=8))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("head", ["node_select", "per_node", "graph_gated",
                                  "ggsnn"])
def test_init_params_layout_matches_jax(head):
    kw = dict(state_dim=8, annotation_dim=3, n_edge_types=2, head=head,
              n_classes=4, n_rounds=2)
    lj = _leaves(jax_init(jax.random.PRNGKey(0),
                          jax_config.ModelConfig(**kw)))
    lt = _leaves(init_params(torch_config.ModelConfig(**kw),
                             torch.Generator().manual_seed(0)))
    assert sorted(lt) == sorted(lj)
    for k, v in lj.items():
        assert tuple(lt[k].shape) == tuple(v.shape), k
        assert lt[k].dtype == torch.float32, k
        fan_in = 8 if "prop" in k else (v.shape[0] if v.ndim > 1 else None)
        if fan_in:
            assert float(lt[k].abs().max()) <= fan_in ** -0.5, k


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=2)
    params_j = jax_init(jax.random.PRNGKey(7), jax_config.ModelConfig(**kw))
    path = str(tmp_path / "model.npz")
    jax_ckpt.save_checkpoint(path, {"params": params_j}, step=5)
    spec = PaddingSpec(n_graphs=2, n_pad=32, e_pad=64, n_edge_types=3,
                       annotation_dim=2)
    pred = Predictor(torch_config.ModelConfig(**kw), spec,
                     checkpoint_path=path, device="cpu")
    want = _leaves(jax.tree.map(np.asarray, params_j))
    got = _leaves(params_to_numpy(pred.params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, meta = torch_ckpt.load_checkpoint(path, {"params": pred.params})
    assert meta["step"] == 5
    back = str(tmp_path / "back.npz")
    torch_ckpt.save_checkpoint(back, {"params": pred.params}, step=6)
    tree, meta = jax_ckpt.load_checkpoint(back, {"params": params_j})
    assert meta["step"] == 6
    for k, v in _leaves(jax.tree.map(np.asarray, tree["params"])).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_port_runs_without_jax():
    """Importing the port and serving on the CPU (both backends; onehot
    through the Predictor's legacy layout, and on the hub graph also
    through a typed pack, whose block mode declines there) never loads
    jax, nor any module of the JAX package."""
    code = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import ModelConfig
from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
r = np.random.default_rng(0)
graphs = [dict(n_nodes=9, edges=np.stack([r.integers(0, 9, 12),
               r.integers(0, 3, 12), r.integers(0, 9, 12)], 1),
               annotations=(r.random((9, 2)) < 0.5).astype(np.float32))
          for _ in range(3)]
hub = [dict(n_nodes=2000, edges=np.stack([r.integers(0, 2000, 8000),
            r.integers(0, 3, 8000), np.where(r.random(8000) < 0.95, 0,
            r.integers(0, 2000, 8000))], 1),
            annotations=(r.random((2000, 2)) < 0.5).astype(np.float32))]
spec = PaddingSpec(n_graphs=2, n_pad=32, e_pad=64, n_edge_types=3,
                   annotation_dim=2)
hub_spec = PaddingSpec(n_graphs=1, n_pad=2048, e_pad=16000, n_edge_types=3,
                       annotation_dim=2)
for backend, fuse in (("xla", False), ("onehot", False), ("onehot", True)):
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=2, backend=backend, fuse_gru=fuse,
                      compute_dtype="bfloat16")
    assert len(Predictor(cfg, spec, device="cpu").predict(graphs)) == 3
    pred = Predictor(cfg, hub_spec, device="cpu")
    assert len(pred.predict(hub)) == 1
    if backend == "onehot":
        batch = batch_graphs(hub, hub_spec)
        assert pred.layout(batch).meta[7] == "block"     # layout_for_batch
        typed = build_typed_dst_layout(
            batch.edge_src, batch.edge_dst, batch.edge_type,
            batch.edge_mask, 2048, 6).to("cpu")
        assert typed.block_meta is None       # the hub: block mode declines
        assert pred.run_batch(batch, typed).shape == (2048,)
loaded = sorted(m for m in sys.modules
                if m == "ggnn_tpu" or m.startswith("ggnn_tpu."))
print("jax" in sys.modules, loaded)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "False []"
