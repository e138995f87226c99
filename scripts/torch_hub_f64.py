"""The scale-free headline's hub rows against an f64 sum, on one NVIDIA GPU.

    python3 scripts/torch_hub_f64.py

On ``layout_for_batch`` of the Zipf-1.2 graph of ``chip_smoke.py`` (262,144
nodes, 8M directed edges; dst block 0 holds 44,642 tiles), with the
headline model's seed-0 weights, prints how far the legacy scatter kernels
(#8, #9) and two runs of one f32 ``index_add_`` of the same messages lie
from an f64 ``index_add_``: the check that showed the f32 sum, not the
kernels, drifting at a hub row of 1.5M terms.
"""

import sys

import torch

sys.path.insert(0, ".")

from ggnn_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from ggnn_tpu_torch.models.config import ModelConfig  # noqa: E402
from ggnn_tpu_torch.models.init import init_params  # noqa: E402
from ggnn_tpu_torch.ops import _build  # noqa: E402
from ggnn_tpu_torch.ops import legacy as L  # noqa: E402
from ggnn_tpu_torch.ops import table as TB  # noqa: E402


def main():
    dev = "cuda"
    _build.library()
    b = synthetic_batch(262144, 4_000_000, 8, annotation_dim=8, seed=0,
                        node_mult=128, powerlaw_alpha=1.2)
    lay = L.layout_for_batch(b, with_grad=False, device=dev)
    cfg = ModelConfig(state_dim=128, annotation_dim=8, n_edge_types=8,
                      n_steps=5, head="node_select", backend="onehot",
                      compute_dtype="bfloat16")
    prop = init_params(cfg, torch.Generator().manual_seed(0), dev)["prop"]
    g = torch.Generator(device=dev).manual_seed(4)
    h = (torch.rand(262144, 128, device=dev, generator=g) * 2 - 1).to(
        torch.bfloat16)
    tab = TB.node_table_block_major(h, prop["msg_w"].to(torch.bfloat16),
                                    prop["msg_b"].to(torch.bfloat16))
    a = lay.arrays
    msgs = tab.index_select(0, a["gather_idx"])
    nb, te = lay.n_blocks, lay.meta[1]
    dl = a["dst_local"].long()
    e = torch.arange(dl.shape[0], device=dev)
    blk = torch.searchsorted(a["tile_start"][1:].contiguous(),
                             (e // te).int(), right=True)
    sel = torch.nonzero(dl >= 0).flatten()
    tgt = blk[sel] * 128 + dl[sel]

    def index_add(dtype):
        out = torch.zeros(nb * 128, 128, dtype=dtype, device=dev)
        return out.index_add_(0, tgt, msgs.index_select(0, sel).to(dtype))

    ref = index_add(torch.float64)
    runs = {
        "onehot_segment_scatter_flat": L.onehot_segment_scatter_flat(
            msgs, a["onehot"], a["tile_start"], a["block_of_tile"], nb, te),
        "onehot_segment_scatter": L.onehot_segment_scatter(
            msgs, a["dst_local"], a["tile_start"], nb, lay.meta[2], te),
        "f32 index_add_": index_add(torch.float32),
        "f32 index_add_, again": index_add(torch.float32)}
    for name, x in runs.items():
        d = (x.double() - ref).abs()
        r, c = divmod(int(d.argmax()), 128)
        print(f"{name}: max|x - f64| {d.max().item():.4e} at row {r} col "
              f"{c} (f64 {ref[r, c].item():.6f}, x {x[r, c].item():.6f}); "
              f"mean {d.mean().item():.3e}", flush=True)


if __name__ == "__main__":
    main()
