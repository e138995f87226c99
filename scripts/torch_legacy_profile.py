"""Where the time of the legacy onehot path goes, on one NVIDIA GPU (H100).

    python3 scripts/torch_legacy_profile.py

The headline model of chip_smoke.py (D = 128, 8 edge types, T = 5, bf16,
node_select, seed-0 weights) on its uniform batch (262,144 nodes, 8M
directed edges) through ``layout_for_batch``: ``torch.profiler`` over one
unfused training step (after two warm-up steps) and over one served forward
(after one warm-up), each printing the device window, the idle share (the
window minus the union of kernel intervals) and the kernels by device time.
"""

import sys

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")

from ggnn_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from ggnn_tpu_torch.models.api import forward  # noqa: E402
from ggnn_tpu_torch.models.config import ModelConfig  # noqa: E402
from ggnn_tpu_torch.models.init import init_params  # noqa: E402
from ggnn_tpu_torch.ops import _build  # noqa: E402
from ggnn_tpu_torch.ops.legacy import layout_for_batch  # noqa: E402
from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,  # noqa: E402
                                       make_train_step, param_leaves)


def report(tag, prof, top=14):
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"[{tag}] the profiler saw no device time", flush=True)
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    window = spans[-1][1] - spans[0][0]
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    print(f"[{tag}] device window {window / 1e3:.2f} ms, busy "
          f"{busy / 1e3:.2f} ms, idle share {1 - busy / window:.4f}",
          flush=True)
    by_name = {}
    for e in kern:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    for name, (t, n) in rows:
        print(f"  {t / 1e3:9.3f} ms {100 * t / busy:5.1f} %  x{n:<4d} "
              f"{name[:110]}", flush=True)


def main():
    dev = "cuda"
    _build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    b = synthetic_batch(262144, 4_000_000, 8, annotation_dim=8, seed=0,
                        node_mult=128)
    cfg = ModelConfig(state_dim=128, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select", backend="onehot",
                      compute_dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    for p in param_leaves(params):
        p.requires_grad_(True)
    arrays = batch_arrays(b, dev)
    arrays["targets"] = {"node": torch.tensor([7], dtype=torch.int32,
                                              device=dev)}
    lay = layout_for_batch(b, with_grad=True, device=dev)
    step = make_train_step(cfg, 1, make_optimizer(params, 1e-3))
    for _ in range(2):
        step(params, arrays, lay)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, arrays, lay)
        torch.cuda.synchronize()
    report("legacy train step", prof)
    serve_lay = layout_for_batch(b, with_grad=False, device=dev)
    with torch.inference_mode():
        forward(params, cfg, arrays, 1, scatter_layout=serve_lay)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward(params, cfg, arrays, 1, scatter_layout=serve_lay)
            torch.cuda.synchronize()
    report("legacy served forward", prof)


if __name__ == "__main__":
    main()
