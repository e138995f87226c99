"""Bring-up check of the legacy kernels on one NVIDIA GPU (H100).

    python3 scripts/torch_legacy_bringup.py

Builds the port's CUDA library and prints ptxas's lines for the legacy
kernels, then holds node_table_block_major (#10) at D = 4, 6, 128, 200, the
two legacy one-hot scatters (#8, #9) at D = 4, 8, 128, 200 and tile_e 128
and 2048 (each also against a second run of itself), and
window_block_spmm_mono (#11) at D = 4, 6, 16, 200 on a hub layout against
their plain versions (max |kernel - plain| within one bf16 ulp, or 2e-5,
of max(1, max|plain|)), and times #10, #8 and #9 at the uniform headline
(262,144 nodes, 8M directed edges, layout_for_batch) with CUDA events.
chip_smoke.py holds the same kernels per element; this script is the short
first call after a kernel changes.
"""

import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")

from ggnn_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from ggnn_tpu_torch.ops import _build  # noqa: E402
from ggnn_tpu_torch.ops import legacy as L  # noqa: E402
from ggnn_tpu_torch.ops import table as TB  # noqa: E402
from ggnn_tpu_torch.ops import window as W  # noqa: E402

DEV = "cuda"
BF16, F32 = torch.bfloat16, torch.float32


def cmp(name, got, ref, tol):
    torch.cuda.synchronize()
    d = (got.float() - ref.float()).abs().max().item()
    s = ref.float().abs().max().item()
    print(f"{name}: max|d| {d:.3e} max|ref| {s:.3e} "
          f"{'ok' if d <= tol * max(1, s) else 'FAIL'}", flush=True)


def ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def check_table():
    for D in (4, 6, 128, 200):
        for dt in (F32, BF16):
            h = torch.randn(512, D, device=DEV).to(dt)
            w = (torch.randn(4, D, D, device=DEV) / D ** 0.5).to(dt)
            b = (torch.randn(4, D, device=DEV) * 0.1).to(dt)
            cmp(f"table D={D} {dt}", TB.node_table_block_major(h, w, b),
                TB.node_table_block_major_reference(h, w, b),
                2 ** -7 if dt == BF16 else 1e-5)


def check_scatters(r):
    N, E = 1024, 6000
    for D in (4, 8, 128, 200):
        for tile_e in (128, 2048):
            for dt in (F32, BF16):
                src, dst = r.integers(0, N, E), r.integers(0, N // 2, E)
                lay = L.build_dst_block_layout(
                    src, dst, r.integers(0, 3, E), np.ones(E, np.float32), N,
                    tile_e=tile_e, n_message_types=3,
                    pad_tiles_to=L.static_tile_budget(E, N, tile_e)).to(DEV)
                a, nb = lay.arrays, lay.n_blocks
                msgs = torch.randn(a["gather_idx"].shape[0], D,
                                   device=DEV).to(dt)
                for name, kern, plain, args in (
                        ("flat", L.onehot_segment_scatter_flat,
                         L.onehot_segment_scatter_flat_reference,
                         (a["onehot"], a["tile_start"], a["block_of_tile"],
                          nb, tile_e)),
                        ("dstl", L.onehot_segment_scatter,
                         L.onehot_segment_scatter_reference,
                         (a["dst_local"], a["tile_start"], nb, lay.meta[2],
                          tile_e))):
                    got = kern(msgs, *args)
                    same = torch.equal(got, kern(msgs, *args))
                    cmp(f"{name} D={D} tile_e={tile_e} {dt} same={same}",
                        got, plain(msgs, *args), 2e-5)


def check_window(r):
    N, E = 4096, 60000
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                   r.integers(0, N, E))
    src = r.integers(0, N, E)
    for D in (4, 6, 16, 200):
        for dstl in (True, False):
            lay = L.build_dst_block_layout(
                src, dst, r.integers(0, 3, E), np.ones(E, np.float32), N,
                tile_e=128, n_message_types=3, edge_align=16,
                dstl_stream=dstl)
            st = torch.as_tensor(lay.dstl if dstl else lay.onehot,
                                 device=DEV)
            args = [torch.as_tensor(x, device=DEV) for x in (
                lay.tile_start, lay.block_of_tile, lay.tile_msg_off)]
            for dt in (F32, BF16):
                tab = torch.randn(lay.gather_idx.shape[0], D,
                                  device=DEV).to(dt)
                kw = dict(n_blocks=lay.n_blocks, window=128, win_stride=16,
                          out_dtype=dt, dstl=dstl)
                cmp(f"mono D={D} dstl={dstl} {dt}",
                    W.window_block_spmm_mono(tab, st, *args, **kw),
                    W.window_block_spmm_mono_reference(tab, st, *args, **kw),
                    2 ** -7 if dt == BF16 else 2e-5)


def time_headline():
    t0 = time.time()
    b = synthetic_batch(262144, 4_000_000, 8, annotation_dim=8, seed=0,
                        node_mult=128)
    t1 = time.time()
    lay = L.layout_for_batch(b, with_grad=True, device=DEV)
    torch.cuda.synchronize()
    print(f"batch {t1 - t0:.1f}s layout_for_batch(with_grad) "
          f"{time.time() - t1:.1f}s meta {lay.meta}", flush=True)
    a, nb, te = lay.arrays, lay.n_blocks, lay.meta[1]
    h = (torch.rand(262144, 128, device=DEV) * 2 - 1).to(BF16)
    w = (torch.randn(16, 128, 128, device=DEV) / 128 ** 0.5).to(BF16)
    bb = (torch.randn(16, 128, device=DEV) * 0.1).to(BF16)
    tab = TB.node_table_block_major(h, w, bb)
    cmp("headline table", tab, TB.node_table_block_major_reference(h, w, bb),
        2 ** -7)
    print("table ms", ms(lambda: TB.node_table_block_major(h, w, bb)),
          "plain", ms(lambda: TB.node_table_block_major_reference(h, w, bb),
                      2), flush=True)
    msgs = tab.index_select(0, a["gather_idx"])
    del tab
    flat = (a["onehot"], a["tile_start"], a["block_of_tile"], nb, te)
    cmp("headline flat", L.onehot_segment_scatter_flat(msgs, *flat),
        L.onehot_segment_scatter_flat_reference(msgs, *flat), 2e-5)
    print("flat ms", ms(lambda: L.onehot_segment_scatter_flat(msgs, *flat)),
          "plain", ms(lambda: L.onehot_segment_scatter_flat_reference(
              msgs, *flat), 2), flush=True)
    dstl = (a["dst_local"], a["tile_start"], nb, lay.meta[2], te)
    cmp("headline dstl", L.onehot_segment_scatter(msgs, *dstl),
        L.onehot_segment_scatter_reference(msgs, *dstl), 2e-5)
    print("dstl ms", ms(lambda: L.onehot_segment_scatter(msgs, *dstl)),
          flush=True)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.time()
    _build.library()
    print("build", _build.BuildInfo.compiled, time.time() - t0, flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("node_table", "panel", "window_mono",
                                   "spill", "registers")):
            print("  ptxas:", line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.default_rng(0)
    check_table()
    check_scatters(r)
    check_window(r)
    time_headline()


if __name__ == "__main__":
    main()
