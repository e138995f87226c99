"""Typed message aggregation: the plain torch path (``segment``), the
typed-pack layout and its per-block and per-tile kernels (``scatter``), the
legacy scatter layout (``legacy``), the windowed SpMM of its grad layout
(``window``), the GRU-cell kernels (``gru``) and the per-element bounds
that the card checks hold the bf16 typed scatters to (``bounds``).  The
CUDA sources live in ``csrc/`` and build at first use (``_build``)."""
