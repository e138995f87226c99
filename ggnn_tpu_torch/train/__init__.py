"""Training: registered configs, train/eval steps, the ``Trainer``, the CLI
(``python -m ggnn_tpu_torch.train``), checkpoints in the reference format
and structured metrics."""

from ggnn_tpu_torch.train.checkpoint import (load_checkpoint,  # noqa: F401
                                             save_checkpoint)
from ggnn_tpu_torch.train.config import (CONFIGS, TrainConfig,  # noqa: F401
                                         build_config)
from ggnn_tpu_torch.train.loop import Trainer  # noqa: F401
