"""GGNN models: configuration, parameters, propagation, heads, forward and
loss."""

from ggnn_tpu_torch.models.api import (forward,  # noqa: F401
                                       loss_and_metrics)
from ggnn_tpu_torch.models.config import (ModelConfig,  # noqa: F401
                                          model_config_for_task)
from ggnn_tpu_torch.models.ggnn import propagate  # noqa: F401
from ggnn_tpu_torch.models.init import (init_params,  # noqa: F401
                                        params_from_numpy, params_to_numpy)
