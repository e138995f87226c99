"""The spread of GGS-NN's first-step gradients between two faithful bf16
versions of the same function, on the CPU: the JAX package's
``loss_and_metrics`` and the port's, on the ``xla`` backend (the same
rounding points, f32 sums in another order), from the same parameters and
inputs.  This is the yardstick of ``chip_smoke.py``'s bound on the first
GGS-NN train step (``TOL_GGSNN``), as the 5-step node_select spread is of
``TOL_TRAIN``.

    JAX_PLATFORMS=cpu python tests/ggsnn_spread.py [--graphs 1]

It imports both packages, as the tests do, so it lives beside them (pytest
does not collect it: no ``test_`` prefix).

The configuration of ``chip_smoke.py``'s ``[ggsnn train]`` (D = 128, 8 edge
types, T = 5, bf16 with f32 sums, K = 3 rounds, 5 tokens, annotation
supervision) on ``--graphs`` of its graphs (4,096 nodes and 62,500 edges
each, drawn as ``chip_smoke.ggsnn_graphs`` draws them), with its random
targets (``ggsnn_targets``' rule); both outputs.  Prints, per output, each
leaf's relative Frobenius error ‖port − JAX‖ / ‖JAX‖ (sorted), the loss of
each, and the f32 spread of the same comparison for scale.
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def spread(n_graphs, output, dtype):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from ggnn_tpu.graph import PaddingSpec as JaxSpec
    from ggnn_tpu.graph import batch_graphs as jax_batch_graphs
    from ggnn_tpu.models import ModelConfig as JaxConfig
    from ggnn_tpu.models import init_params as jax_init
    from ggnn_tpu.models import loss_and_metrics as jax_loss
    from ggnn_tpu_torch.models import ModelConfig, params_from_numpy
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import param_leaves

    nodes, edges, types, ann_dim, K, V = 4096, 62_500, 8, 8, 3, 5
    r = np.random.default_rng(0)
    graphs = []
    for _ in range(n_graphs):
        e = np.stack([r.integers(0, nodes, edges), r.integers(0, types, edges),
                      r.integers(0, nodes, edges)], axis=1)
        graphs.append(dict(n_nodes=nodes, edges=e, annotations=(
            r.random((nodes, ann_dim)) < 0.1).astype(np.float32)))
    spec = JaxSpec(n_graphs=n_graphs, n_pad=n_graphs * nodes,
                   e_pad=2 * n_graphs * edges, n_edge_types=types,
                   annotation_dim=ann_dim)
    b = jax_batch_graphs(graphs, spec)
    r = np.random.default_rng(0)
    live = np.arange(K)[None, :] < r.integers(1, K + 1, n_graphs)[:, None]
    targets = {
        "seq": np.where(live, r.integers(0, V, live.shape), -1).astype(
            np.int32),
        "seq_nodes": np.where(live, r.integers(0, nodes, live.shape),
                              -1).astype(np.int32),
        "ann_seq": (r.random((spec.n_pad, K, ann_dim)) < 0.1).astype(
            np.float32)}
    kw = dict(state_dim=128, annotation_dim=ann_dim, n_edge_types=types,
              n_steps=5, head="ggsnn", n_classes=V, n_rounds=K,
              ggsnn_output=output, ann_supervision=True,
              compute_dtype=dtype, backend="xla")
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                               JaxConfig(**kw)))
    arrays = dict(b.arrays, targets=targets)
    jl, jg = jax.value_and_grad(lambda p: jax_loss(
        p, JaxConfig(**kw), jax.tree.map(jnp.asarray, arrays),
        n_graphs)[0])(jax.tree.map(jnp.asarray, params))
    tp = params_from_numpy(params)
    for p in param_leaves(tp):
        p.requires_grad_(True)
    tarrays = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
                   {t: torch.as_tensor(x) for t, x in v.items()})
               for k, v in arrays.items()}
    loss, _ = loss_and_metrics(tp, ModelConfig(**kw), tarrays, n_graphs)
    grads = torch.autograd.grad(loss, param_leaves(tp))
    ref = dict(_flatten(params_from_numpy(jax.tree.map(np.asarray, jg))))
    errs = []
    for (key, _), g in zip(_flatten(tp), grads):
        want = ref[key].double()
        norm = want.norm().item()
        if norm == 0.0:
            continue
        errs.append(((g.double() - want).norm().item() / norm, key))
    errs.sort(reverse=True)
    return float(jl), float(loss.detach()), errs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--graphs", type=int, default=1)
    args = ap.parse_args()
    import torch
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for output in ("graph", "node"):
        for dtype in ("bfloat16", "float32"):
            jl, tl, errs = spread(args.graphs, output, dtype)
            med = sorted(e for e, _ in errs)[len(errs) // 2]
            print(f"{output} output, {dtype}, {args.graphs} graph(s) of "
                  f"4096 nodes: loss JAX {jl:.6f} port {tl:.6f}; leaves' "
                  f"rel_frobenius largest "
                  + ", ".join(f"{k} {e:.3e}" for e, k in errs[:4])
                  + f"; median {med:.3e}; smallest "
                  f"{errs[-1][1]} {errs[-1][0]:.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
