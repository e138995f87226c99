"""Times the typed pack's kernels #1, #2, #6 and #7 and the paths that run
them, for comparing two trees on one NVIDIA GPU (H100).

    python3 scripts/torch_typed_ab.py [--root DIR] [--tag NAME] [--six]

Imports ``ggnn_tpu_torch`` from ``--root`` (default: the checkout that
holds this script), so that one command can time an unpacked parent commit
and this tree in turns (parent, change, change, parent) on one card.  The
headline model of ``chip_smoke.py`` (D = 128, 8 edge types, T = 5, bf16,
node_select, weights from seed 0), measured with CUDA events; kernels
through their wrappers on random inputs from seed 19 (chip_smoke's
``kernel_inputs``), best of two runs of 10 launches; requests and train
steps the median device time of 3 after a warm-up:

- the uniform headline (262,144 nodes, 8M directed edges; the typed pack
  in block mode, its octet grad layout): #1 ``typed_block_scatter``, #2
  ``typed_block_step_gru``, the fused request (#2 per step) and the fused
  train step (#1 and #5 per step, Adam);
- the scale-free headline (the same size, Zipf-1.2 endpoints; block mode
  and the octet layout decline): #6 ``typed_step_gru`` (before and after
  #7), #7 ``typed_onehot_scatter``, the unfused request (#7 and #3 per
  step) and the fused train step (#7 and #11 per step).

The card's SM clock, power draw and temperature (nvidia-smi) are read
after #2 and after each #6 / #7 timing.  ``--six`` times only #6, in four
orders on the scale-free headline: first, after a fixed PyTorch kernel
(``FIXED_MATMULS`` bf16 matmuls of 8192², the same in both trees), after
#7, and after the fixed kernel again.

Batches and layouts are pickled under ``.chip_scratch/ab_cache/`` of the
working directory (the layout builders are host code that both trees
share), so the later runs of one command skip making them.  Prints the
card's nvidia-smi line and one JSON object of the times (ms) and the
kernels' launch counts over the run.
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
FIXED_MATMULS = 30      # about 50 ms on an H100, as long as #7's timing


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the tree whose ggnn_tpu_torch is timed")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--six", action="store_true",
                    help="time only #6, in four orders")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("torch_typed_ab: no CUDA device", file=sys.stderr)
        return 2
    import ggnn_tpu_torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
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
    T2 = 2 * EDGE_TYPES
    out, clocks = {}, {}

    def smi():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()

    def cfg_of(**kw):
        return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                           n_edge_types=EDGE_TYPES, n_steps=STEPS,
                           head="node_select", compute_dtype="bfloat16",
                           backend="onehot", **kw)

    params = init_params(cfg_of(), torch.Generator().manual_seed(0), "cuda")

    def layout(name, b):
        return ab.cached(name, lambda: S.build_typed_dst_layout(
            b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
            T2, with_grad=True)).to("cuda")

    def request_ms(name, b, lay, **kw):
        arrays = batch_arrays(b, "cuda")
        cfg = cfg_of(**kw)
        with torch.inference_mode():
            out[name] = ab.median_ms(
                lambda: forward(params, cfg, arrays, 1, scatter_layout=lay))
        del arrays

    def train_ms(name, b, lay, **kw):
        arrays = batch_arrays(b, "cuda")
        target = int(np.random.default_rng(0).integers(0, NODES))
        arrays["targets"] = {"node": torch.tensor(
            [target], dtype=torch.int32, device="cuda")}
        cfg = cfg_of(**kw)
        p = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        for leaf in param_leaves(p):
            leaf.requires_grad_(True)
        step = make_train_step(cfg, 1, make_optimizer(p, 1e-3))
        out[name] = ab.median_ms(lambda: step(p, arrays, lay))
        del arrays, p, step
        torch.cuda.empty_cache()

    if args.six:
        return six_orders(args, card, ab, cs, params, layout, smi)

    # --- the uniform headline: #1, #2 --------------------------------------
    bu = ab.cached("uniform.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128))
    lay = layout("uniform_typed_grad.pkl", bu)
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    sa = (x["h_pack"], *x["arrs"], x["msg_w"])
    fa = (*sa, x["init"], x["hstate"], x["wa"], x["b3"], x["uzr"], x["uh"])
    out["1_ms"] = ab.best_ms(lambda: S.typed_block_scatter(*sa, **x["kw"]))
    out["2_ms"] = ab.best_ms(lambda: S.typed_block_step_gru(*fa,
                                                            **x["kw"]))
    clocks["after_2"] = smi()
    del x, sa, fa
    request_ms("request_uniform_fused_ms", bu, lay, fuse_gru=True)
    train_ms("train_uniform_fused_ms", bu, lay, fuse_gru=True)
    del lay, bu
    torch.cuda.empty_cache()
    print(f"[{args.tag}] uniform {out}", flush=True)

    # --- the scale-free headline: #7, #6 -----------------------------------
    bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, powerlaw_alpha=ZIPF))
    lay = layout("scalefree_typed_grad.pkl", bs)
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **x["kw"])
    fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
              b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
    # #6 before and after #7: a kernel's reading may depend on what ran
    # just before it on the card (its clocks: nvidia-smi after each)
    out["6_first_ms"] = ab.best_ms(lambda: S.typed_step_gru(**fa))
    clocks["after_6_first"] = smi()
    out["7_ms"] = ab.best_ms(lambda: S.typed_onehot_scatter(**sa))
    clocks["after_7"] = smi()
    out["6_ms"] = ab.best_ms(lambda: S.typed_step_gru(**fa))
    clocks["after_6"] = smi()
    del x, sa, fa
    request_ms("request_scalefree_unfused_ms", bs, lay, fuse_gru=False)
    train_ms("train_scalefree_fused_ms", bs, lay, fuse_gru=True)
    del lay, bs
    torch.cuda.empty_cache()
    for k in ("typed_block_scatter", "typed_block_step_gru",
              "typed_onehot_scatter", "typed_step_gru"):
        out[f"launches_{k}"] = getattr(S, k).launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out,
                      "clocks_sm_power_temp": clocks}))
    return 0


def six_orders(args, card, ab, cs, params, layout, smi):
    """#6 on the scale-free headline: first, after the fixed kernel, after
    #7, after the fixed kernel again; nvidia-smi after each."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops import scatter as S
    bs = ab.cached("scalefree.pkl", lambda: synthetic_batch(
        NODES, EDGES, EDGE_TYPES, annotation_dim=ANN, seed=0,
        node_mult=128, powerlaw_alpha=ZIPF))
    lay = layout("scalefree_typed_grad.pkl", bs)
    x = cs.kernel_inputs(lay, torch.bfloat16, params, seed=19)
    sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **x["kw"])
    fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
              b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
    g = torch.Generator(device="cuda").manual_seed(0)
    m = torch.rand(8192, 8192, device="cuda", generator=g).bfloat16()

    def fixed():
        for _ in range(FIXED_MATMULS):
            torch.matmul(m, m)

    out, clocks = {}, {}
    for key, before in (("6_first_ms", None), ("6_after_fixed_ms", fixed),
                        ("6_after_7_ms",
                         lambda: ab.best_ms(
                             lambda: S.typed_onehot_scatter(**sa))),
                        ("6_after_fixed_again_ms", fixed)):
        if before is not None:
            before()
        out[key] = ab.best_ms(lambda: S.typed_step_gru(**fa))
        clocks[key] = smi()
    out["launches_typed_step_gru"] = S.typed_step_gru.launches
    print(card)
    print(json.dumps({"tag": args.tag, "card": card, "ms": out,
                      "clocks_sm_power_temp": clocks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
