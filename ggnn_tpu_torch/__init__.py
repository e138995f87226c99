"""ggnn_tpu_torch — the GGNN framework ported to PyTorch and CUDA for an
NVIDIA H100 (Hopper, sm_90a).

The JAX package :mod:`ggnn_tpu` stays the reference.  This package imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its
own copies of the numpy-only modules it needs (:mod:`ggnn_tpu_torch.graph`,
:mod:`ggnn_tpu_torch.data`).  Its entry points run on the card unless the
caller asks for the CPU.

Layering, from the serving entry point down:

- :mod:`ggnn_tpu_torch.infer`          — ``Predictor``: batching, layouts, decode
- :mod:`ggnn_tpu_torch.models`         — config, params, ``forward``,
  ``propagate``, readout heads
- :mod:`ggnn_tpu_torch.train`          — checkpoints in the reference format
- :mod:`ggnn_tpu_torch.ops`            — typed aggregation: plain torch path,
  typed-pack layout, CUDA kernel wrappers
- ``ggnn_tpu_torch/ops/csrc``          — the hand-written CUDA kernels
"""

__version__ = "0.1.0"
