"""Where ``chip_smoke.py``'s bound on the first GGS-NN train step
(``TOL_GGSNN`` = 2**-4 per gradient leaf) lies between sound runs and
faulty ones, on the card.

    python3 scripts/torch_ggsnn_tol_control.py

On ``[ggsnn train]``'s batch (64 graphs of 4,096 nodes and 62,500 edges,
its random targets, annotation supervision on) and configuration (D = 128,
T = 5, K = 3 rounds, bf16 with f32 sums, the typed pack fused), for both
outputs, the first step's gradient leaves are held to the plain path
(the kernels' plain versions, ``chip_smoke.plain_ggsnn``) as
``compare_first_step`` holds them:

- ``kernels``: the step through the kernels (#1, #5), the sound run the
  bound must pass;
- ``plain again``: the plain path a second time (its run-to-run spread);
- ``round 0 prop left out``: the plain path with round 0's propagation
  parameters detached, so the prop leaves miss one round of three;
- ``round 0 ann left out``: the same for round 0's annotation net;
- ``round 2 out left out``: the same for the last round's output net.

The three ``left out`` runs are faults a bound must catch.  Prints, per
output and run, the loss's relative error, the worst leaves (relative
Frobenius, ``SYMMETRIC_LEAVES`` aside) and the median leaf, then the
card's nvidia-smi line.
"""

import argparse
import contextlib
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def detached(tree):
    return {k: detached(v) if isinstance(v, dict) else v.detach()
            for k, v in tree.items()}


@contextlib.contextmanager
def round_left_out(net: str, round_k: int):
    """The GGS-NN forward with ``net``'s parameters ('prop', 'ann' or
    'out') detached in round ``round_k`` only: that round adds nothing to
    their gradient."""
    from ggnn_tpu_torch.models import ggsnn as G
    name = {"prop": "propagate", "ann": "annotation_update",
            "out": ("node_select_scores", "graph_gated_logits")}[net]
    names = name if isinstance(name, tuple) else (name,)
    saved = {n: getattr(G, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def wrap(n):
        def fn(params, *a, **k):
            if calls[n] == round_k:
                params = detached(params)
            calls[n] += 1
            return saved[n](params, *a, **k)
        return fn
    try:
        for n in names:
            setattr(G, n, wrap(n))
        yield
    finally:
        for n, f in saved.items():
            setattr(G, n, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_ggsnn_tol_control: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import batch_arrays, param_leaves

    card, _ = cs.setup()
    _, batch, lay = cs.ggsnn_batch()
    arrays = batch_arrays(batch, "cuda")
    arrays["targets"] = cs.ggsnn_targets(batch)

    def first_step(cfg):
        params = cs.fresh_params(cfg)
        loss, _ = loss_and_metrics(params, cfg, arrays, cs.GGSNN_GRAPHS,
                                   scatter_layout=lay)
        grads = torch.autograd.grad(loss, param_leaves(params))
        return float(loss.detach()), dict(zip(
            [k for k, _ in _flatten(params)], grads))

    runs = {"kernels": contextlib.nullcontext,
            "plain again": cs.plain_ggsnn,
            "round 0 prop left out": lambda: round_left_out("prop", 0),
            "round 0 ann left out": lambda: round_left_out("ann", 0),
            f"round {cs.ROUNDS - 1} out left out": lambda: round_left_out(
                "out", cs.ROUNDS - 1)}
    for output in ("graph", "node"):
        cfg = cs.ggsnn_cfg(output, fuse_gru=True)
        with cs.plain_ggsnn():
            loss_ref, ref = first_step(cfg)
        for name, ctx in runs.items():
            if name == "kernels":
                with ctx():
                    loss, got = first_step(cfg)
            else:
                with cs.plain_ggsnn(), ctx():
                    loss, got = first_step(cfg)
            errs = sorted(((cs.relfro(got[k], ref[k]), k) for k in ref
                           if k not in cs.SYMMETRIC_LEAVES), reverse=True)
            worst = ", ".join(f"{k} {e:.3e}" for e, k in errs[:3])
            verdict = ("passes" if errs[0][0] <= cs.TOL_GGSNN
                       else "fails")
            print(f"[tol control] {output} output, {name}: loss rel "
                  f"{abs(loss - loss_ref) / abs(loss_ref):.3e}; worst "
                  f"leaves {worst}; median leaf "
                  f"{statistics.median(e for e, _ in errs):.3e}; "
                  f"{verdict} TOL_GGSNN {cs.TOL_GGSNN:.3e}", flush=True)
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
