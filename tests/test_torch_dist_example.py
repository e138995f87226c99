"""``examples/torch_distributed_production.py`` at P = 2: two gloo ranks
on the CPU (``tests/torch_dist_worker.py``) run the example's stages
(partition, three sharded halo_window Adam steps on grad layouts, q8
serving of the trained weights under ``torch.no_grad``) from the JAX
package's initial weights, against the JAX example's calls on the
conftest's CPU mesh (``examples/distributed_production.py``: its
``make_sharded_train_step`` and ``sharded_propagate``).

The example computes in bf16, so the tolerances are
``tests/test_torch_halo_train.py``'s bf16 ones: the first step's loss
within rtol 1e-5 and each gradient leaf's relative Frobenius error within
2**-8 (``TOL_GRAD_BF16``: the same rounding points, a state rounded to
the other bf16 neighbour moves the terms it feeds by one ulp).  Later
losses follow Adam steps of lr·sign(g), where a leaf entry whose gradient
is near 0 may step either way in either package: they are held to 1e-4
relative (the CPU reads 6.5e-6).  The served h is held against the JAX
package's q8 sharded forward of the port's trained weights within the
reference's quantization bound (5 % of the largest state,
``tests/test_torch_halo.py``): each side quantizes its own bf16 table
windows.  The trained weights are bit-equal on both ranks."""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ggnn_tpu.data.synthetic import synthetic_batch as jax_synthetic
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.parallel import make_sharded_train_step as jax_train_step
from ggnn_tpu.parallel import partition as JP
from ggnn_tpu.parallel import sharded_propagate as jax_sharded_propagate

import torch_dist_cases as C
from torch_dist_worker import RankJob

P, ITERS = 2, 3
EXAMPLE = dict(nodes=512, edges=3000, types=3, dim=128, steps=2)
TOL_GRAD_BF16 = 2.0 ** -8
TOL_LATER_LOSSES = 1e-4
TOL_Q8 = 0.05


def _cfg(**kw):
    return JaxConfig(state_dim=EXAMPLE["dim"], annotation_dim=4,
                     n_edge_types=EXAMPLE["types"], n_steps=EXAMPLE["steps"],
                     compute_dtype="bfloat16", **kw)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    params = jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0),
                                               _cfg()))
    case = dict(name="example", kind="example", P=P, params=params,
                example=EXAMPLE, train_iters=ITERS)
    j = RankJob([case], P, tmp_path_factory.mktemp("example_ranks"),
                timeout=600)
    j.params = params
    yield j
    j.wait()


def _jax_setup():
    """The JAX example's partition and layouts (its stages 1 and 3)."""
    b = jax_synthetic(EXAMPLE["nodes"], EXAMPLE["edges"], EXAMPLE["types"],
                      annotation_dim=4, seed=0, node_mult=P * 128,
                      n_communities=P, p_intra=0.9)
    parts = JP.split_local_remote(JP.partition_batch(b, P))
    t2 = 2 * EXAMPLE["types"]
    train = JP.build_halo_window_layouts(parts, window=128,
                                         n_message_types=t2, with_grad=True,
                                         row_major="block")
    serve = JP.build_halo_window_layouts(parts, window=128,
                                         n_message_types=t2,
                                         row_major="block")
    return parts, train, serve, jax_make_mesh(n_graph=P)


def _port(job):
    """Rank 0's results; rank 1 trained the same weights, bit for bit."""
    out, other = job.result("example", 0), job.result("example", 1)
    for k in out:
        if k.startswith("p/"):
            np.testing.assert_array_equal(other[k], out[k], err_msg=k)
    np.testing.assert_array_equal(other["losses"], out["losses"])
    return out


def _jax_first_step(cfg, parts, arrays, meta, mesh, prop0):
    """The first step's loss and gradients of Σ h² through the shard_map
    (what the example's step differentiates)."""
    def objective(p):
        h = jax_sharded_propagate(p, cfg, mesh, parts,
                                  strategy="halo_window",
                                  halo_layouts=(arrays, meta))
        return jnp.sum(h * h)
    loss0, g = jax.jit(jax.value_and_grad(objective))(prop0)
    return float(loss0), C.flat_tree(jax.tree.map(np.asarray, g))


def _jax_losses(cfg, parts, arrays, meta, mesh, prop0):
    """The JAX example's three Adam steps (``make_sharded_train_step``)."""
    opt = optax.adam(1e-3)
    step = jax_train_step(cfg, mesh, opt, strategy="halo_window",
                          halo_meta=meta)
    prop, opt_state, losses = prop0, opt.init(prop0), []
    for _ in range(ITERS):
        prop, opt_state, loss = step(prop, opt_state, parts, arrays)
        losses.append(float(loss))
    return losses


def test_distributed_example_matches_jax(job):
    parts, (arrays, meta), (arrays_s, meta_s), mesh = _jax_setup()
    cfg = _cfg()
    args = (cfg, parts, arrays, meta, mesh,
            jax.tree.map(jnp.asarray, job.params["prop"]))
    with ThreadPoolExecutor(2) as ex:       # the two compiles overlap
        first = ex.submit(_jax_first_step, *args)
        later = ex.submit(_jax_losses, *args)
        (loss0, grads), losses = first.result(), later.result()
    out = _port(job)
    got = {k[2:]: v for k, v in out.items() if k.startswith("g/")}
    assert sorted(got) == sorted(grads)
    for k in grads:
        err = np.linalg.norm(got[k] - grads[k]) / (
            np.linalg.norm(grads[k]) + 1e-12)
        assert err <= TOL_GRAD_BF16, (k, err)
    assert len(out["losses"]) == ITERS
    np.testing.assert_allclose(out["losses"][0], loss0, rtol=1e-5)
    np.testing.assert_allclose(out["losses"][0], losses[0], rtol=1e-5)
    np.testing.assert_allclose(out["losses"][1:], losses[1:],
                               rtol=TOL_LATER_LOSSES)

    # q8 serving of the port's trained weights
    trained = {k[2:]: v for k, v in out.items() if k.startswith("p/")}
    flat = C.flat_tree(job.params["prop"])
    prop_t = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(job.params["prop"]),
        [jnp.asarray(trained[k]) for k in sorted(flat)])
    cfg_q8 = _cfg(backend="window", fuse_gru=True, quantized_table=True)
    ref = np.asarray(jax_sharded_propagate(
        prop_t, cfg_q8, mesh, parts, strategy="halo_window",
        halo_layouts=(arrays_s, meta_s)))
    h = np.concatenate([out["h"], job.result("example", 1)["h"]])
    assert h.shape == ref.shape == (EXAMPLE["nodes"], EXAMPLE["dim"])
    assert np.isfinite(h).all()
    err = np.abs(h - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < TOL_Q8, err
