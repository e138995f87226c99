"""Times kernels #17 ``sddmm_pallas`` and #3 ``gru_cell_fwd`` and the paths
that run them, for comparing two trees on one NVIDIA GPU (H100).

    python3 scripts/torch_gate_gru_ab.py [--root DIR] [--tag NAME] [--paths]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events:

- the kernels, best of two runs of 10 launches: #17 (G = 128, p and q
  normal · 0.1 from seed 19) on the uniform headline's packed layout
  (``pack_type_tiles``: 62,516 tiles of 128, the pallas gate, no mask)
  and on the batch's 8M directed edges with their mask (the xla gate);
  on the packed layout also a launch on copies of src and dst (a layout
  not seen before: the range checks and, in a tree that has one, the
  plan), the median of 5, and the plan alone; #3 in bf16 at the uniform
  headline's 262,144 rows (h uniform in (−1, 1), a normal, weights at
  D**-0.5, seed 2);
- with ``--paths``, the median device time of 3 forwards or 5 train steps
  after a warm-up: the pallas request (``forward``, which packs the
  layout, so #17's plan is made once a request) and train step, gated and
  ungated, on the uniform headline; the unfused uniform and scale-free
  train steps (the typed pack with its grad half, #3 and #4 a step), the
  legacy request (``layout_for_batch``) and the chunked 1M forward (4
  chunks of tile_e 2048), each on the layout reused and on a fresh copy of
  it each call (new tensors, made before the timer starts: what a new
  batch is to the kernels' per-layout caches).

The batches and the typed host layouts are pickled under
``.chip_scratch/ab_cache/`` of the working directory, so the later runs of
one command skip making them.  Prints the card's nvidia-smi line and one
JSON object of the times (ms) and the kernels' launch counts.
"""

import argparse
import copy
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
NODES_1M, EDGES_1M = 1_048_576, 10_000_000
ZIPF = 1.2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--paths", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_gate_gru_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
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
    T2 = 2 * EDGE_TYPES
    out = {}

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           **kw)

    def arrays_of(bt):
        arrays = batch_arrays(bt, "cuda")
        target = int(np.random.default_rng(0).integers(0, bt.spec.n_pad))
        arrays["targets"] = {"node": torch.tensor(
            [target], dtype=torch.int32, device=dev)}
        return arrays

    def fresh(lay):
        """A copy of a layout (or a list of them) whose arrays are new
        tensors: what a new batch's layout is to the kernels' caches."""
        if isinstance(lay, list):
            return [fresh(x) for x in lay]
        if isinstance(lay, dict):
            return {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in lay.items()}
        f = copy.copy(lay)
        f.arrays = {k: v.clone() if torch.is_tensor(v) else v
                    for k, v in lay.arrays.items()}
        return f

    def timed_ms(fn, lay, new, runs):
        """Median device time of ``runs`` calls fn(layout) after one
        warm-up: the layout itself, or with ``new`` a fresh copy each call
        (made before the timer starts)."""
        fn(fresh(lay) if new else lay)
        ts = []
        for _ in range(runs):
            f = fresh(lay) if new else lay
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(f)
            ev[1].record()
            torch.cuda.synchronize()
            ts.append(ev[0].elapsed_time(ev[1]))
            del f
        return sorted(ts)[len(ts) // 2]

    def both(name, fn, lay, runs):
        out[f"{name}_reused_ms"] = timed_ms(fn, lay, False, runs)
        out[f"{name}_new_layout_ms"] = timed_ms(fn, lay, True, runs)

    def train_fn(arrays, **kw):
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for leaf in param_leaves(p):
            leaf.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
        return lambda lay: step(p, arrays, lay)

    def serve_fn(arrays, **kw):
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")

        def run(lay):
            with torch.inference_mode():
                forward(p, cfg, arrays, 1, scatter_layout=lay)
        return run

    # --- the kernels ---------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(2)
    D = DIM
    h = torch.rand(NODES, D, device=dev, generator=gen) * 2 - 1
    a = torch.randn(NODES, D, device=dev, generator=gen)
    w = [torch.empty(D, k * D, device=dev).uniform_(
        -D ** -0.5, D ** -0.5, generator=gen) for k in (3, 2, 1)]
    b3 = torch.empty(3 * D, device=dev).uniform_(-0.1, 0.1, generator=gen)
    out["3_ms"] = ab.best_ms(lambda: G.gru_cell_fwd(h, a, w[0], b3, w[1],
                                                    w[2]))
    del h, a, w, b3
    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    cols = [torch.as_tensor(x, device=dev) for x in (
        bu.edge_src, bu.edge_dst, bu.edge_type, bu.edge_mask,
        bu.type_offsets)]
    lay = SP.pack_type_tiles(*cols, T2)
    gen = torch.Generator(device=dev).manual_seed(19)
    p = torch.randn(bu.spec.n_pad, D, device=dev, generator=gen) * 0.1
    q = torch.randn(bu.spec.n_pad, D, device=dev, generator=gen) * 0.1
    src, dst = lay["src"], lay["dst"]
    out["17_packed_ms"] = ab.best_ms(lambda: SP.sddmm_pallas(p, q, src=src,
                                                             dst=dst))
    out["17_packed_new_layout_ms"] = timed_ms(
        lambda f: SP.sddmm_pallas(p, q, src=f["src"], dst=f["dst"]),
        {"src": src, "dst": dst}, True, 5)
    if hasattr(SP, "sddmm_plan"):
        out["17_plan_ms"] = timed_ms(lambda f: SP.sddmm_plan(
            f["src"], f["dst"], p.shape[0], q.shape[0], D),
            {"src": src, "dst": dst}, True, 5)
    es, ed, em = (x.to(torch.int32) if x.dtype != torch.float32 else x
                  for x in cols[:2] + [cols[3]])
    out["17_xla_ms"] = ab.best_ms(lambda: SP.sddmm_pallas(p, q, src=es,
                                                          dst=ed, mask=em))
    del lay, p, q, src, dst, es, ed, em, cols
    torch.cuda.empty_cache()
    print(f"[{args.tag}] kernels {out}", flush=True)

    if args.paths:
        # --- the pallas backend: the layout packed in each forward ----------
        arrays = arrays_of(bu)
        for gated in (False, True):
            tag = "gated" if gated else "ungated"
            run = serve_fn(arrays, backend="pallas", edge_gates=gated)
            out[f"pallas_request_{tag}_ms"] = timed_ms(run, None, False, 3)
            del run
            step = train_fn(arrays, backend="pallas", edge_gates=gated)
            out[f"pallas_train_{tag}_ms"] = timed_ms(step, None, False, 5)
            del step
            torch.cuda.empty_cache()
        # --- #3 a step: the unfused typed train steps, the legacy request ---
        lay = ab.cached("uniform_typed_grad.pkl",
                        lambda: S.build_typed_dst_layout(
                            bu.edge_src, bu.edge_dst, bu.edge_type,
                            bu.edge_mask, bu.spec.n_pad, T2,
                            with_grad=True)).to("cuda")
        step = train_fn(arrays, backend="onehot", fuse_gru=False)
        both("train_uniform_unfused", step, lay, 5)
        del step, lay
        torch.cuda.empty_cache()
        lay = L.layout_for_batch(bu, with_grad=False, device="cuda")
        run = serve_fn(arrays, backend="onehot", fuse_gru=False)
        both("legacy_request", run, lay, 3)
        del run, lay, arrays
        torch.cuda.empty_cache()
        bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
            NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
            node_mult=128, powerlaw_alpha=ZIPF))
        arrays = arrays_of(bs)
        lay = ab.cached("scalefree_typed_grad.pkl",
                        lambda: S.build_typed_dst_layout(
                            bs.edge_src, bs.edge_dst, bs.edge_type,
                            bs.edge_mask, bs.spec.n_pad, T2,
                            with_grad=True)).to("cuda")
        step = train_fn(arrays, backend="onehot", fuse_gru=False)
        both("train_scalefree_unfused", step, lay, 5)
        del step, lay, arrays, bs
        torch.cuda.empty_cache()
        print(f"[{args.tag}] paths {out}", flush=True)
        # --- the chunked 1M forward ------------------------------------------
        b1 = ab.cached("uniform_1m.pkl", lambda: synthetic_batch(
            NODES_1M, EDGES_1M, EDGE_TYPES, annotation_dim=ANN, seed=0,
            node_mult=128))
        chunks = L.build_chunked_dst_layouts(b1.edge_src, b1.edge_dst,
                                             b1.edge_type, b1.edge_mask,
                                             b1.spec.n_pad, n_chunks=4,
                                             tile_e=2048, device="cuda")
        cfg = cfg_of(backend="onehot")
        prm = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        ann = torch.as_tensor(b1.annotations, device=dev)
        edges = [torch.as_tensor(x) for x in (b1.edge_src, b1.edge_dst,
                                              b1.edge_type, b1.edge_mask)]

        def run_1m(f):
            with torch.inference_mode():
                propagate(prm["prop"], cfg, ann, *edges, scatter_layout=f)
        both("chunked_1m_forward", run_1m, chunks, 3)
        del chunks, b1, prm, ann, edges
        torch.cuda.empty_cache()
    del bu
    out["launches_3"] = G.gru_cell_fwd.launches
    out["launches_17"] = SP.sddmm_pallas.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
