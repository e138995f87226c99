"""Profiling hooks (the counterpart of ``ggnn_tpu/profiling.py``) on
``torch.profiler``.

``annotate(name)`` names a span of the trace; ``trace(out_dir, device)``
records one, driven by ``--profile DIR`` on the train CLI.  The trace is a
Chrome trace (``*.json``): open it in Perfetto (ui.perfetto.dev) or
``chrome://tracing``.  On a CUDA device it holds the kernels' launches
(CUPTI), those of the ctypes-loaded kernel library included, beside the
host's operators."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


def annotate(name: str):
    """A named span of the trace, usable as a decorator or a context
    manager (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(out_dir: Optional[str], device="cuda") -> Iterator[None]:
    """Record a profiler trace of the block into ``out_dir`` (a no-op for
    None): CPU activity, plus CUDA activity on a CUDA ``device``.  On exit,
    also by an exception, the device is synchronised and the trace written
    as ``out_dir/trace_<pid>_<ns>.json``."""
    if not out_dir:
        yield
        return
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
