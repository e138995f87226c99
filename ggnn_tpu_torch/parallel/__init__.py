"""The parallel layer: the rank mesh, edge partitioning, halo-exchange
propagation, the sharded training steps and the multi-process bootstrap,
on ``torch.distributed`` with one process per rank (the port of
``ggnn_tpu/parallel/``).

- :mod:`~ggnn_tpu_torch.parallel.multihost`: the rendezvous
  (``initialize_multihost``) and each rank's device;
- :mod:`~ggnn_tpu_torch.parallel.mesh`: the ('data', 'graph') rank grid
  and its process groups;
- :mod:`~ggnn_tpu_torch.parallel.comm`: the collectives as autograd
  functions, under one gradient convention;
- :mod:`~ggnn_tpu_torch.parallel.partition`: the host partition plan
  (numpy, the reference's arrays) and the halo kernel layouts;
- :mod:`~ggnn_tpu_torch.parallel.halo`: the five strategies, the sharded
  losses and the sharded train and eval steps;
- :mod:`~ggnn_tpu_torch.parallel.train`: the data-parallel step.
"""

from ggnn_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from ggnn_tpu_torch.parallel.partition import partition_batch  # noqa: F401
from ggnn_tpu_torch.parallel.halo import (  # noqa: F401
    make_sharded_eval_step, make_sharded_task_train_step,
    make_sharded_train_step, sharded_node_select_loss, sharded_propagate)
