"""Typed message aggregation: the plain torch path (``segment``), the
typed-pack layout and its per-block and per-tile kernels (``scatter``), the
legacy scatter layout (``legacy``), the windowed SpMM of its grad layout
(``window``) and the GRU-cell kernels (``gru``).  The CUDA sources live in
``csrc/`` and build at first use (``_build``)."""
