"""Where the time of the window backend's serving path goes, on one NVIDIA
GPU (H100).

    python3 scripts/torch_window_profile.py

The headline model of chip_smoke.py (D = 128, 8 edge types, T = 5, bf16,
node_select, seed-0 weights) on the community headline (262,144 nodes in
512 communities of 512, 8M directed edges, p_intra 0.95; bench.py:457-488):
``torch.profiler`` over one served forward (after one warm-up) through
each of three layouts: the bench's window_community layout (on-demand
windows, the XW spill, block_rows 512, fused), its window_community_q8
layout (the q8 table, the XW spill, fused) and the window Predictor's own
``window_layout_for_batch`` (static budgets, the legacy spill, block_rows
128, fused).  Each prints the device window, the idle share (the window
minus the union of kernel intervals) and the kernels by device time.
"""

import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")

from ggnn_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from ggnn_tpu_torch.models.api import forward  # noqa: E402
from ggnn_tpu_torch.models.config import ModelConfig  # noqa: E402
from ggnn_tpu_torch.models.init import init_params  # noqa: E402
from ggnn_tpu_torch.ops import _build  # noqa: E402
from ggnn_tpu_torch.ops.window import (build_window_layout,  # noqa: E402
                                       window_layout_for_batch)
from ggnn_tpu_torch.train.loop import batch_arrays  # noqa: E402

sys.path.insert(0, "scripts")
from torch_legacy_profile import report  # noqa: E402


def main():
    dev = "cuda"
    _build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    b = synthetic_batch(262_144, 4_000_000, 8, annotation_dim=8, seed=0,
                        node_mult=128, n_communities=512, p_intra=0.95)
    arrays = batch_arrays(b, dev)
    base = dict(state_dim=128, annotation_dim=8, n_edge_types=8, n_steps=5,
                head="node_select", backend="window",
                compute_dtype="bfloat16", fuse_gru=True)
    params = init_params(ModelConfig(**base), torch.Generator().manual_seed(0),
                         dev)
    bench = dict(window=512, n_message_types=16, block_rows=512,
                 row_major="block", typed_spill=True)
    runs = {
        "window_community (on-demand)": (dict(on_demand=True), {}),
        "window_community_q8": ({}, dict(quantized_table=True)),
        "Predictor layout (window_layout_for_batch)": (None, {}),
    }
    for tag, (lay_kw, cfg_kw) in runs.items():
        if lay_kw is None:
            lay = window_layout_for_batch(b).to(dev)
        else:
            lay = build_window_layout(b.edge_src, b.edge_dst, b.edge_type,
                                      b.edge_mask, b.spec.n_pad, **bench,
                                      **lay_kw).to(dev)
        cfg = ModelConfig(**base, **cfg_kw)
        with torch.inference_mode():
            forward(params, cfg, arrays, 1, scatter_layout=lay)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                forward(params, cfg, arrays, 1, scatter_layout=lay)
                torch.cuda.synchronize()
        report(f"served forward, {tag}", prof)
        del lay
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
