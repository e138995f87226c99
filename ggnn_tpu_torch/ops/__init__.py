"""Typed message aggregation: the plain torch path (``segment``), the
typed-pack layout and block kernels (``scatter``) and the GRU-cell kernel
(``gru``).  The CUDA sources live in ``csrc/`` and build at first use
(``_build``)."""
