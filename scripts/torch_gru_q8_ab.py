"""Times kernels #4 ``gru_cell_bwd`` and #15 ``node_table_block_major_q8``
and the paths that run them, for comparing two trees on one NVIDIA GPU
(H100).

    python3 scripts/torch_gru_q8_ab.py [--root DIR] [--tag NAME]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events:

- the kernels, best of two runs of 10 launches: #4 at the uniform
  headline's 262,144 rows (chip_smoke.py's ``gru_bwd_inputs``, seed 2) in
  bf16 with da in f32 and in bf16, in f32, and in bf16 at D = 256; #15 at
  the community headline's (T2 = 16, W 512, the model's weights, h
  uniform in (−1, 1)) and at D = 256;
- the paths, the median of 3 after a warm-up: the train step
  (``make_train_step``, Adam) of the uniform headline (262,144 nodes, 8M
  directed edges, the typed pack in block mode with its octet grad
  layout) and of the scale-free headline (the same size, Zipf-1.2
  endpoints, per-tile), each fused (its GRU inside #2 / #6: no #4) and
  unfused (#3 and #4 a step), of window_community_train (the community headline, 512
  communities of 512, on bench.py's layout built ``with_grad``: W 512,
  block_rows 512, on-demand, the XW spill) and of the uniform headline on
  the pallas backend (ungated); and window_community_q8 served (the
  device forward on the q8 layout);
- #4's launches in each train step, and in the window train step the
  spill's #11 ``window_block_spmm_mono``: its launches a step, and the
  sum of those launches' times, each replayed on the arguments the step
  gave it (best of two runs of 10).

The batches and the typed host layouts are pickled under
``.chip_scratch/ab_cache/`` of the working directory, so the later runs of
one command skip making them (the window layouts, gigabytes of counts,
are built anew).  Prints the card's nvidia-smi line and one JSON object of
the times (ms) and launch counts.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "scripts"))
import torch_scalefree_ab as ab  # noqa: E402  (its timers and caches)

NODES, EDGES, EDGE_TYPES, DIM, STEPS, ANN = 262_144, 4_000_000, 8, 128, 5, 8
ZIPF = 1.2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_gru_q8_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
    cs = ab.smoke_helpers()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"[{args.tag}] ggnn_tpu_torch from "
          f"{os.path.dirname(ggnn_tpu_torch.__file__)}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    bf = torch.bfloat16
    T2 = 2 * EDGE_TYPES
    out = {}

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    # --- the kernels ---------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    for name, D, dt, da in (("4_ms", DIM, bf, torch.float32),
                            ("4_da_bf16_ms", DIM, bf, bf),
                            ("4_f32_ms", DIM, torch.float32, torch.float32),
                            ("4_d256_ms", 2 * DIM, bf, torch.float32)):
        x = cs.gru_bwd_inputs(NODES, dt, gen, D=D)
        out[name] = ab.best_ms(lambda: G.gru_cell_bwd(*x, mdt=dt,
                                                      da_dtype=da))
        del x
    torch.cuda.empty_cache()
    params = init_params(cfg_of(backend="window"),
                         torch.Generator().manual_seed(0), "cuda")
    w, b, _ = cs.window_weights(params, bf)
    h = (torch.rand(NODES, DIM, device=dev, generator=gen) * 2 - 1).to(bf)
    out["15_ms"] = ab.best_ms(lambda: TB.node_table_block_major_q8(h, w, b,
                                                                   512))
    D2 = 2 * DIM
    w2 = (torch.rand(T2, D2, D2, device=dev, generator=gen) * 2 - 1).mul(
        D2 ** -0.5).to(bf)
    b2 = (torch.rand(T2, D2, device=dev, generator=gen) * 0.2 - 0.1).to(bf)
    h2 = (torch.rand(NODES, D2, device=dev, generator=gen) * 2 - 1).to(bf)
    out["15_d256_ms"] = ab.best_ms(lambda: TB.node_table_block_major_q8(
        h2, w2, b2, 512))
    del h, h2, w2, b2, params
    torch.cuda.empty_cache()
    print(f"[{args.tag}] kernels {out}", flush=True)

    # --- the paths -----------------------------------------------------------
    def arrays_of(bt):
        arrays = batch_arrays(bt, "cuda")
        target = int(np.random.default_rng(0).integers(0, NODES))
        arrays["targets"] = {"node": torch.tensor(
            [target], dtype=torch.int32, device=dev)}
        return arrays

    def train_ms(name, arrays, lay, **kw):
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for leaf in param_leaves(p):
            leaf.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
        n0 = G.gru_cell_bwd.launches
        out[name] = ab.median_ms(lambda: step(p, arrays, lay))
        out[f"{name[:-3]}_launches_4_per_step"] = (
            G.gru_cell_bwd.launches - n0) / 4
        del p, step
        torch.cuda.empty_cache()

    def typed_layout(name, bt):
        return ab.cached(name, lambda: S.build_typed_dst_layout(
            bt.edge_src, bt.edge_dst, bt.edge_type, bt.edge_mask,
            bt.spec.n_pad, T2, with_grad=True)).to("cuda")

    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    arrays = arrays_of(bu)
    lay = typed_layout("uniform_typed_grad.pkl", bu)
    train_ms("train_uniform_ms", arrays, lay, backend="onehot",
             fuse_gru=True)
    train_ms("train_uniform_unfused_ms", arrays, lay, backend="onehot",
             fuse_gru=False)
    del lay
    train_ms("train_pallas_ms", arrays, None, backend="pallas")
    del arrays, bu
    torch.cuda.empty_cache()
    bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, powerlaw_alpha=ZIPF))
    arrays = arrays_of(bs)
    lay = typed_layout("scalefree_typed_grad.pkl", bs)
    train_ms("train_scalefree_ms", arrays, lay, backend="onehot",
             fuse_gru=True)
    train_ms("train_scalefree_unfused_ms", arrays, lay, backend="onehot",
             fuse_gru=False)
    del lay, arrays, bs
    torch.cuda.empty_cache()
    print(f"[{args.tag}] typed and pallas steps {out}", flush=True)

    bc = ab.cached("community.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, n_communities=512, p_intra=0.95))
    arrays = arrays_of(bc)

    def window_layout(**kw):
        return W.build_window_layout(
            bc.edge_src, bc.edge_dst, bc.edge_type, bc.edge_mask,
            bc.spec.n_pad, window=512, n_message_types=T2, block_rows=512,
            typed_spill=True, row_major="block", **kw).to("cuda")

    lay = window_layout(on_demand=False)
    cfg = cfg_of(backend="window", fuse_gru=True, quantized_table=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    n0 = TB.node_table_block_major_q8.launches
    with torch.inference_mode():
        out["serve_community_q8_ms"] = ab.median_ms(
            lambda: forward(params, cfg, arrays, 1, scatter_layout=lay))
    out["serve_community_q8_launches_15_per_request"] = (
        TB.node_table_block_major_q8.launches - n0) / 4
    del lay, params
    torch.cuda.empty_cache()

    lay = window_layout(on_demand=True, with_grad=True)
    train_ms("train_window_ms", arrays, lay, backend="window",
             fuse_gru=True)
    # #11 in one more window train step: its launches, each replayed on the
    # arguments the step gave it
    mono, calls = W.window_block_spmm_mono, []

    def shim(*a, **kw):
        calls.append((a, kw))
        return mono(*a, **kw)

    cfg = cfg_of(backend="window", fuse_gru=True)
    p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    for leaf in param_leaves(p):
        leaf.requires_grad_(True)
    step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
    step(p, arrays, lay)
    # the wrapper counts its launches through its module-global name
    shim.launches = mono.launches
    W.window_block_spmm_mono = shim
    try:
        step(p, arrays, lay)
        torch.cuda.synchronize()
    finally:
        W.window_block_spmm_mono = mono
        mono.launches = shim.launches
    times = [ab.best_ms(lambda a=a, kw=kw: mono(*a, **kw))
             for a, kw in calls]
    out["train_window_launches_11_per_step"] = len(calls)
    out["train_window_11_ms_per_step"] = sum(times)
    out["train_window_11_calls"] = [
        dict(table=list(a[0].shape), table_dtype=str(a[0].dtype),
             stream=list(a[1].shape), stream_dtype=str(a[1].dtype),
             **{k: kw.get(k) for k in ("n_blocks", "window", "out_rows",
                                       "dstl")}, ms=round(t, 4))
        for (a, kw), t in zip(calls, times)]
    del lay, p, step, calls, arrays, bc
    torch.cuda.empty_cache()
    out["launches_4"] = G.gru_cell_bwd.launches
    out["launches_15"] = TB.node_table_block_major_q8.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
