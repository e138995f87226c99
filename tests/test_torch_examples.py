"""The port's examples (``examples/torch_custom_task.py``,
``examples/torch_large_graph.py``) against the same calls of the JAX
package, with the JAX package's weights carried over by
``params_from_numpy``, and their refusals without a card.

Tolerances:

- the custom task (f32, the xla backend) as ``tests/test_torch_train_loop.
  py`` holds one Trainer step: each of the first 5 Adam steps' losses
  within rtol 1e-5 (the same math summed in another order; Adam's first
  steps move each weight by about lr·sign(g), so agreeing gradients keep
  the losses within rounding), and the test accuracy after one epoch
  equal;
- the large graph (bf16 compute, f32 sums), the final h of each form
  within one bf16 ulp of its largest value, as ``tests/test_torch_legacy.
  py`` holds ``propagate`` on legacy and chunked layouts: a sum that lands
  on a bf16 boundary may round to the other neighbour.

The JAX package runs its Pallas kernels in interpret mode, the port its
kernels' plain versions (CPU tensors)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ggnn_tpu.data.loader import BatchLoader as JaxLoader
from ggnn_tpu.data.synthetic import synthetic_batch as jax_synthetic
from ggnn_tpu.graph import PaddingSpec as JaxSpec
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.ops.scatter_pallas import (build_chunked_dst_layouts,
                                         build_dst_block_layout)
from ggnn_tpu.ops.window_pallas import build_window_layout
from ggnn_tpu.train.loop import make_eval_step, make_train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_ULP = 2.0 ** -7


def load_example(name):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_params(cfg: JaxConfig, seed=0):
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(seed), cfg))


# --- the custom task ---------------------------------------------------------

def test_custom_task_makes_the_reference_graphs():
    """``make_example`` is the reference's, draw for draw."""
    port = load_example("torch_custom_task")
    ref = load_example("custom_task")
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(50):
        a, b = port.make_example(r1), ref.make_example(r2)
        assert a["n_nodes"] == b["n_nodes"]
        np.testing.assert_array_equal(a["edges"], b["edges"])
        np.testing.assert_array_equal(a["annotations"], b["annotations"])
        assert int(a["targets"]["cls"]) == int(b["targets"]["cls"])


def _jax_custom_task(params, epochs):
    """The reference example's loop (``examples/custom_task.py:56-82``):
    each step's loss and the test accuracy at each epoch's end."""
    ref = load_example("custom_task")
    rng = np.random.default_rng(0)
    train = [ref.make_example(rng) for _ in range(200)]
    test = [ref.make_example(rng) for _ in range(100)]
    B = 20
    spec = JaxSpec(n_graphs=B, n_pad=B * 10, e_pad=B * 20 * 2,
                   n_edge_types=1, annotation_dim=2).round_up()
    cfg = JaxConfig(state_dim=8, annotation_dim=2, n_edge_types=1,
                    n_steps=8, head="graph_gated", n_classes=2)
    params = jax.tree.map(jnp.asarray, params)
    optimizer = optax.adam(3e-3)
    opt_state = optimizer.init(params)
    train_step = make_train_step(cfg, B, optimizer)
    eval_step = make_eval_step(cfg, B)
    loader = JaxLoader(train, spec, shuffle=True, seed=0)
    test_loader = JaxLoader(test, spec, shuffle=False)
    losses, accs = [], {}
    for epoch in range(epochs):
        for batch in loader.epoch_batches():
            params, opt_state, m = train_step(params, opt_state,
                                              batch.arrays)
            losses.append(float(m["loss_sum"]) / max(float(m["count"]), 1.0))
        c = n = 0.0
        for batch in test_loader.epoch_batches(0):
            m = eval_step(params, batch.arrays)
            c += float(m["correct"])
            n += float(m["count"])
        accs[epoch + 1] = c / n
    return losses, accs


def test_custom_task_matches_jax():
    """One epoch of the example (10 Adam steps, then the test set) from
    the JAX package's initial weights: the first 5 losses and the test
    accuracy against the reference example's loop."""
    port = load_example("torch_custom_task")
    cfg = port.model_config()
    params = _np_params(JaxConfig(**{f: getattr(cfg, f) for f in (
        "state_dim", "annotation_dim", "n_edge_types", "n_steps", "head",
        "n_classes")}))
    printed = []
    got = port.run(device="cpu", epochs=1, eval_every=1, params=params,
                   log=printed.append)
    losses, accs = _jax_custom_task(params, epochs=1)
    assert len(got["losses"]) == len(losses) == 10
    np.testing.assert_allclose(got["losses"][:5], losses[:5], rtol=1e-5)
    assert got["accuracies"] == accs
    assert printed == [f"epoch 1: test accuracy {accs[1]:.3f}"]


# --- the large graph ---------------------------------------------------------

NODES, EDGES, TYPES, DIM, STEPS = 512, 2500, 2, 8, 2
FORMS = {"single": dict(), "chunks": dict(chunks=2),
         "communities": dict(communities=4)}


def _jax_large_graph(params, chunks=1, communities=0):
    """The reference example's calls (``examples/large_graph.py:51-91``)
    at a tiny size → its final h."""
    b = jax_synthetic(NODES, EDGES, TYPES, annotation_dim=8, seed=0,
                      node_mult=128, n_communities=communities)
    cfg = JaxConfig(state_dim=DIM, annotation_dim=8, n_edge_types=TYPES,
                    n_steps=STEPS,
                    backend="window" if communities else "onehot",
                    compute_dtype="bfloat16")
    host = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad)
    if communities:
        layout = build_window_layout(
            *host, n_message_types=2 * TYPES,
            block_rows=min(512, NODES // communities))
    elif chunks > 1:
        layout = build_chunked_dst_layouts(*host, n_chunks=chunks,
                                           tile_e=2048)
    else:
        layout = build_dst_block_layout(*host, tile_e=2048).to_device()
    return np.asarray(jax_propagate(
        jax.tree.map(jnp.asarray, params["prop"]), cfg,
        *(jnp.asarray(x) for x in (b.annotations, b.edge_src, b.edge_dst,
                                   b.edge_type, b.edge_mask)),
        scatter_layout=layout))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_large_graph_matches_jax(form):
    """Each form's h (one legacy layout, chunked layouts, the window
    layout of a community graph) against the reference example's, and the
    checksum the example prints is h's sum."""
    port = load_example("torch_large_graph")
    params = _np_params(JaxConfig(state_dim=DIM, annotation_dim=8,
                                  n_edge_types=TYPES, n_steps=STEPS))
    printed = []
    got = port.run(nodes=NODES, edges=EDGES, types=TYPES, dim=DIM,
                   steps=STEPS, device="cpu", params=params,
                   log=printed.append, **FORMS[form])
    ref = _jax_large_graph(params, **FORMS[form])
    h = got["h"].numpy()
    assert h.shape == ref.shape == (NODES, DIM)
    assert np.abs(h - ref).max() <= BF16_ULP * max(1.0, np.abs(ref).max())
    assert got["checksum"] == pytest.approx(float(got["h"].sum()), rel=1e-6)
    assert printed[0] == f"building graph: {NODES} nodes, {EDGES} edges ..."
    assert got["n_dir"] == 2 * EDGES
    assert printed[-1].startswith("steady state: ") and \
        f"for {STEPS} steps over {2 * EDGES} directed edges" in printed[-1]


@pytest.mark.parametrize("name", ["torch_custom_task", "torch_large_graph",
                                  "torch_distributed_production"])
def test_examples_default_to_the_card(name):
    """Without a card each example's default (``--device cuda``) raises;
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(name).main([])
