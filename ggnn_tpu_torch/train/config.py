"""Typed experiment configs and their registry, mirrored field for field
from ``ggnn_tpu/train/config.py`` (that module cannot be imported here: the
reference's ``ggnn_tpu.train`` package imports jax).  Every registered
config is a named, typed config with CLI overrides layered on top."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ggnn_tpu_torch.data.babi import TASKS
from ggnn_tpu_torch.models.config import ModelConfig, model_config_for_task


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    name: str
    task_id: int
    model: ModelConfig
    batch_size: int = 10
    lr: float = 1e-3
    weight_decay: float = 0.0           # >0 switches Adam -> AdamW
    epochs: int = 200
    seed: int = 0
    question_id: Optional[int] = None   # filter for multi-question tasks
    fold: int = 1
    n_train: int = 50                   # paper headline: 50 train examples
    n_test: int = 50
    data_root: str = "babi_data"
    generate_if_missing: bool = True
    eval_every: int = 10
    checkpoint_every: int = 0           # epochs; 0 = only at end
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    backend: str = "xla"                # propagate backend: 'xla' | 'pallas'

    def with_overrides(self, **kw) -> "TrainConfig":
        model_kw = {k[len("model_"):]: v for k, v in kw.items()
                    if k.startswith("model_") and v is not None}
        rest = {k: v for k, v in kw.items()
                if not k.startswith("model_") and v is not None}
        model = (dataclasses.replace(self.model, **model_kw) if model_kw
                 else self.model)
        if "backend" in rest:
            model = dataclasses.replace(model, backend=rest["backend"])
        return dataclasses.replace(self, model=model, **rest)


def _babi(name: str, task_id: int, state_dim: int = 4, n_steps: int = 5,
          **kw) -> Callable[[], TrainConfig]:
    def make() -> TrainConfig:
        spec = TASKS[task_id]
        model = model_config_for_task(spec, state_dim=state_dim,
                                      n_steps=n_steps)
        defaults = dict(question_id=0) if spec.n_question_types > 1 else {}
        defaults.update(kw)
        return TrainConfig(name=name, task_id=task_id, model=model,
                           **defaults)
    return make


# the reference's registry, entry for entry (its comments give each
# setting's provenance)
CONFIGS: dict[str, Callable[[], TrainConfig]] = {
    "babi4": _babi("babi4", 4),
    "babi15": _babi("babi15", 15),
    "babi16": _babi("babi16", 16, state_dim=8, n_steps=8),
    "babi18": _babi("babi18", 18, state_dim=6, epochs=600, lr=5e-4),
    "babi19": _babi("babi19", 19, state_dim=16, epochs=400, n_train=250,
                    lr=1e-3),
    "babi19_small": lambda: _babi(
        "babi19_small", 19, state_dim=4, epochs=800, n_train=50,
        lr=5e-3)().with_overrides(model_ggsnn_output="node"),
}


def build_config(name: str, **overrides) -> TrainConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; have {sorted(CONFIGS)}")
    return CONFIGS[name]().with_overrides(**overrides)
