"""The reference's q8 serving accuracy gate on the port's window path.

``tests/test_q8_accuracy.py`` trains a D = 128 per-node student in bf16
on a community graph against a random teacher's labels, then holds the
q8 serving step (int8 table, power-of-2 window scales) to a budget
against the bf16 window step on that trained model.  Here the student is
trained exactly as there (its ``_setup``, in JAX), its parameters carried
into the port with ``params_from_numpy``, and the same budget asserted on
the port's fused window path (``propagate(backend='window')``, its plain
versions on the CPU), bf16 against q8:

- argmax agreement ≥ 0.99 of the nodes at T = 5;
- accuracy delta ≤ 0.01;
- state rel-L2 ≤ 0.02 at T = 5 and ≤ 0.04 at T = 8.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.models.heads import per_node_logits
from ggnn_tpu_torch.ops.window import build_window_layout

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def trained():
    """The reference test's graph, labels and trained student (its
    ``_setup``), as numpy."""
    import jax
    spec = importlib.util.spec_from_file_location(
        "q8_reference", os.path.join(HERE, "test_q8_accuracy.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    batch, _, _, _, labels, params = ref._setup()
    params = jax.tree.map(np.asarray, params)
    return ref, batch, np.asarray(labels), params


def _states(ref, batch, params, T, quantized):
    cfg = ModelConfig(state_dim=ref.D, annotation_dim=ref.A,
                      n_edge_types=ref.ETYPES, n_steps=T, head="per_node",
                      n_classes=ref.CLASSES, compute_dtype="bfloat16",
                      backend="window", fuse_gru=True,
                      quantized_table=quantized)
    lay = build_window_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        batch.spec.n_pad, window=256, n_message_types=2 * ref.ETYPES,
        block_rows=128, row_major="block")
    edges = [torch.as_tensor(np.asarray(x)) for x in (
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask)]
    with torch.no_grad():
        return propagate(params["prop"], cfg,
                         torch.as_tensor(batch.annotations), *edges,
                         scatter_layout=lay)


def test_q8_trained_model_accuracy_on_the_port(trained):
    ref, batch, labels, np_params = trained
    params = params_from_numpy(np_params)
    ann = torch.as_tensor(batch.annotations)
    h_w = _states(ref, batch, params, 5, False)
    h_q8 = _states(ref, batch, params, 5, True)
    logits_w = per_node_logits(params["head"], h_w, ann)
    logits_q8 = per_node_logits(params["head"], h_q8, ann)
    pred_w = logits_w.argmax(-1).numpy()
    pred_q8 = logits_q8.argmax(-1).numpy()
    agree = float((pred_w == pred_q8).mean())
    acc_w = float((pred_w == labels).mean())
    acc_q8 = float((pred_q8 == labels).mean())
    print(f"\nport: window_bf16 acc={acc_w:.4f} q8 acc={acc_q8:.4f} "
          f"argmax_agreement={agree:.4f}")
    assert acc_w >= 0.9, f"the student does not serve on the port: {acc_w}"
    assert agree >= 0.99, f"argmax agreement {agree} < 0.99"
    assert abs(acc_q8 - acc_w) <= 0.01, (acc_q8, acc_w)


def test_q8_error_growth_on_the_port(trained):
    ref, batch, _, np_params = trained
    params = params_from_numpy(np_params)
    errs = {}
    for T in (5, 8):
        h_w = _states(ref, batch, params, T, False)
        h_q8 = _states(ref, batch, params, T, True)
        errs[T] = float((h_q8 - h_w).norm() / h_w.norm())
    print(f"\nport q8 rel-L2 state error: T=5 {errs[5]:.4f}, "
          f"T=8 {errs[8]:.4f}")
    assert errs[5] <= 0.02, errs
    assert errs[8] <= 0.04, errs


def test_q8_grads_training_accuracy_on_the_port(trained):
    """The reference's int8-gradient training gate
    (test_q8_accuracy.py::test_q8_grads_training_accuracy) on the port:
    the fused window step trained 60 Adam steps (3e-3) from the JAX
    package's initial student, with exact bf16 gradients and with int8
    ā (grad_quant: quantize_grad_pow2 and #14's int8 form), on the
    reference's graph and labels.  Its thresholds: median relative loss
    gap over the first 20 steps ≤ 5 %, final accuracy delta ≤ 2 % with
    both ≥ 0.9, the q8 final loss ≤ 2.5× the exact one."""
    import jax
    from ggnn_tpu.models import ModelConfig as JaxConfig
    from ggnn_tpu.models import init_params as jax_init
    from ggnn_tpu_torch.models.heads import per_node_loss
    from ggnn_tpu_torch.train.loop import make_optimizer, param_leaves
    ref, batch, labels, _ = trained
    kw = dict(window=256, n_message_types=2 * ref.ETYPES, block_rows=128,
              row_major="block", with_grad=True)
    edges_np = (batch.edge_src, batch.edge_dst, batch.edge_type,
                batch.edge_mask)
    lay = build_window_layout(*edges_np, batch.spec.n_pad, **kw)
    lay_q = build_window_layout(*edges_np, batch.spec.n_pad, **kw,
                                grad_quant=True)
    assert lay_q.meta[10] and lay.grad_meta[4]
    mk = dict(state_dim=ref.D, annotation_dim=ref.A, n_edge_types=ref.ETYPES,
              n_steps=5, head="per_node", n_classes=ref.CLASSES,
              compute_dtype="bfloat16", backend="window", fuse_gru=True)
    init = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                             JaxConfig(**mk)))
    ann = torch.as_tensor(batch.annotations)
    edges = [torch.as_tensor(np.asarray(x)) for x in edges_np]
    y = torch.tensor(np.array(labels)).long()
    mask = torch.ones(ref.N)

    def train(layout, steps=60):
        params = params_from_numpy(init)
        for p in param_leaves(params):
            p.requires_grad_(True)
        opt = make_optimizer(params, 3e-3)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            h = propagate(params["prop"], ModelConfig(**mk), ann, *edges,
                          scatter_layout=layout)
            loss = per_node_loss(per_node_logits(params["head"], h, ann), y,
                                 mask)[0]
            loss.backward()
            opt.step()
            losses.append(loss.item())
        with torch.no_grad():
            h = propagate(params["prop"], ModelConfig(**mk), ann, *edges,
                          scatter_layout=layout)
            pred = per_node_logits(params["head"], h, ann).argmax(-1)
        return np.asarray(losses), float((pred.numpy() == labels).mean())

    losses_e, acc_e = train(lay)
    losses_q, acc_q = train(lay_q)
    gap = np.abs(losses_q - losses_e) / (np.abs(losses_e) + 1e-6)
    print(f"\nport: exact acc={acc_e:.4f} q8grad acc={acc_q:.4f} early "
          f"median loss gap={np.median(gap[:20]):.4f} final losses "
          f"{losses_e[-1]:.4f}/{losses_q[-1]:.4f}")
    assert acc_e >= 0.9, f"exact-grad training failed to learn: {acc_e}"
    assert acc_q >= 0.9, f"q8-grad training failed to learn: {acc_q}"
    assert abs(acc_q - acc_e) <= 0.02, (acc_q, acc_e)
    assert np.median(gap[:20]) <= 0.05, np.median(gap[:20])
    assert losses_q[-1] <= 2.5 * losses_e[-1] + 1e-3, (losses_q[-1],
                                                       losses_e[-1])
