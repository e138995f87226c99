"""The port's sharded train step (``make_sharded_train_step``, the
propagation parameters against ``Σ h²``): the loss and every gradient
leaf, summed over the ranks under the layer's convention (1/P seeds each
rank's replica of the loss, psum's backward sums, the gradients are summed
over the graph axis), against the JAX package, at P = 2 and P = 4.

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``) runs
every case.  f32 cases are held to the JAX package's single-device
``jax.value_and_grad`` (the reference's own tests hold its sharded step to
the same): the same math summed in another order.  bf16 and int8-gradient
cases are held to the JAX package's sharded step on the conftest's CPU mesh
(its gradients through ``shard_map``), with the same rounding points.  The
parameters after the Adam step must be bit-equal on every rank."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.parallel import make_mesh as jax_make_mesh
from ggnn_tpu.parallel import partition as JP
from ggnn_tpu.parallel import sharded_propagate as jax_sharded_propagate
from ggnn_tpu_torch.data.synthetic import synthetic_batch

import torch_dist_cases as C
from torch_dist_worker import RankJob

STRATEGIES = ("all_gather", "halo", "halo_overlap", "halo_onehot",
              "halo_window")
LR = 1e-2
CFG = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
# with their grad halves: P = 2 the dst-local one-hot scatter and 'src'
# window rows (the unfused window backward on its transposed stream); P = 4
# block rows (the fused backward on the forward count stream)
LAYOUTS = {
    ("halo_onehot", 2): dict(kind="scatter", tile_e=16, with_grad=True,
                             grad_tile_e=16),
    ("halo_onehot", 4): dict(kind="scatter", tile_e=16, with_grad=True,
                             grad_tile_e=16),
    ("halo_window", 2): dict(kind="window", window=64, min_edges_per_tile=4,
                             spill_tile_e=16, n_message_types=6,
                             with_grad=True, row_major="src"),
    ("halo_window", 4): dict(kind="window", window=128, min_edges_per_tile=4,
                             spill_tile_e=16, n_message_types=6,
                             with_grad=True, row_major="block"),
}
CFG_WIN = dict(state_dim=128, annotation_dim=2, n_edge_types=3, n_steps=2,
               backend="window", fuse_gru=True)
BF16 = dict(state_dim=8, annotation_dim=2, n_edge_types=2, n_steps=2,
            compute_dtype="bfloat16")
# f32 gradients: the reference's 5e-4 on the Adam step's params, here on
# the gradients themselves (relative to each leaf's largest entry)
TOL_GRAD = 1e-4
# bf16 through the same rounding points as the JAX sharded step: a state
# rounded to the other bf16 neighbour moves the terms it feeds by one ulp,
# 2**-8; each leaf's relative Frobenius error within 2**-8
TOL_GRAD_BF16 = 2.0 ** -8


def _batch():
    return synthetic_batch(512, 3000, 3, annotation_dim=2, seed=7,
                           node_mult=512, n_communities=4, p_intra=0.7)


def _cases():
    b = _batch()
    params = C.jax_params(2, **CFG)
    cases = [dict(name=f"{s}-{P}", kind="train", P=P, batch=b,
                  params=params, cfg=CFG, strategy=s, lr=LR,
                  layout=LAYOUTS.get((s, P)))
             for s in STRATEGIES for P in (2, 4)]
    pw = C.jax_params(2, **CFG_WIN)
    for od in (False, True):
        cases.append(dict(
            name=f"fused-od{od}", kind="train", P=2, batch=b, params=pw,
            cfg=CFG_WIN, strategy="halo_window", lr=LR,
            layout=dict(kind="window", window=128, min_edges_per_tile=4,
                        spill_tile_e=None if od else 16, n_message_types=6,
                        with_grad=True, row_major="block", on_demand=od)))
    hot = C.skewed_batch(1024, 8192, 4, seed=6)
    ph = C.jax_params(0, **BF16)
    for name, part in (("dense", {}), ("hot", dict(hot_thresh=2))):
        cases.append(dict(name=f"bf16-onehot-{name}", kind="train", P=4,
                          batch=hot, params=ph, cfg=BF16,
                          strategy="halo_onehot", lr=1e-3, part=part,
                          layout=dict(kind="scatter", tile_e=128,
                                      with_grad=True)))
    q8 = dict(CFG, compute_dtype="bfloat16")
    cases.append(dict(name="grad_quant", kind="train", P=2, batch=b,
                      params=C.jax_params(2, **q8), cfg=q8,
                      strategy="halo_window", lr=LR,
                      layout=dict(kind="window", window=128,
                                  min_edges_per_tile=4, spill_tile_e=16,
                                  n_message_types=6, with_grad=True,
                                  row_major="block", grad_quant=True)))
    return cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = _cases()
    j = RankJob(cases, 4, tmp_path_factory.mktemp("train_ranks"),
                timeout=600)
    j.cases = {c["name"]: c for c in cases}
    yield j
    j.wait()


def _single_grads(case, cfg_kw):
    """The JAX package's single-device (Σ h², its gradient)."""
    b = case["batch"]
    cfg = JaxConfig(**cfg_kw)
    prop = jax.tree.map(jnp.asarray, case["params"]["prop"])

    def loss(p):
        h = jax_propagate(p, cfg, b.annotations, b.edge_src, b.edge_dst,
                          b.edge_type, b.edge_mask)
        return jnp.sum(h * h)
    val, g = jax.jit(jax.value_and_grad(loss))(prop)
    return float(val), C.flat_tree(jax.tree.map(np.asarray, g))


def _sharded_grads(case):
    """The JAX package's sharded (Σ h², its gradient) through shard_map,
    as its ``make_sharded_train_step`` takes them."""
    jb = C.to_jax_batch(case["batch"])
    cfg = JaxConfig(**case["cfg"])
    part = case.get("part", {})
    parts = JP.split_local_remote(JP.partition_batch(jb, case["P"], **part))
    lay = {k: v for k, v in case["layout"].items() if k != "kind"}
    arrays, meta = (JP.build_halo_scatter_layouts(parts, **lay)
                    if case["layout"]["kind"] == "scatter"
                    else JP.build_halo_window_layouts(parts, **lay))
    mesh = jax_make_mesh(n_graph=case["P"])

    @jax.jit
    def f(prop, parts, arrays):
        def loss(p):
            h = jax_sharded_propagate(p, cfg, mesh, parts,
                                      strategy=case["strategy"],
                                      halo_layouts=(arrays, meta))
            return jnp.sum(h * h)
        return jax.value_and_grad(loss)(prop)

    val, g = f(jax.tree.map(jnp.asarray, case["params"]["prop"]), parts,
               arrays)
    return float(val), C.flat_tree(jax.tree.map(np.asarray, g))


def _port(job, name):
    """Rank 0's loss, gradients and parameters; every rank of the case
    holds the same updated parameters, bit for bit."""
    out = job.result(name, 0)
    for r in range(1, job.world):
        other = job.result(name, r)
        for k in out:
            if k.startswith("p/"):
                np.testing.assert_array_equal(other[k], out[k], err_msg=k)
    grads = {k[2:]: v for k, v in out.items() if k.startswith("g/")}
    params = {k[2:]: v for k, v in out.items() if k.startswith("p/")}
    return float(out["loss"]), grads, params


def _check_grads(got, ref, tol_abs=None, relf=None):
    assert sorted(got) == sorted(ref)
    for k in ref:
        if relf is not None:
            err = np.linalg.norm(got[k] - ref[k]) / (
                np.linalg.norm(ref[k]) + 1e-12)
            assert err <= relf, (k, err)
        else:
            np.testing.assert_allclose(
                got[k], ref[k], rtol=tol_abs,
                atol=tol_abs * max(1.0, float(np.abs(ref[k]).max())),
                err_msg=k)


@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_train_step_grads_match_jax(job, strategy, P):
    """Each strategy's loss and every gradient leaf against the JAX
    package's single-device gradient of Σ h², and the Adam step's
    parameters against optax's step on those gradients."""
    name = f"{strategy}-{P}"
    loss, grads, params = _port(job, name)
    ref_loss, ref_grads = _single_grads(job.cases[name], CFG)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _check_grads(grads, ref_grads, tol_abs=TOL_GRAD)
    prop = jax.tree.map(jnp.asarray, job.cases[name]["params"]["prop"])
    opt = optax.adam(LR)
    g = jax.tree.map(jnp.asarray, jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(prop),
        [ref_grads[k] for k in sorted(ref_grads)]))
    upd, _ = opt.update(g, opt.init(prop), prop)
    ref_params = C.flat_tree(jax.tree.map(
        np.asarray, optax.apply_updates(prop, upd)))
    for k in ref_params:
        np.testing.assert_allclose(params[k], ref_params[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


@pytest.mark.parametrize("on_demand", (False, True))
def test_sharded_train_fused_window_step(job, on_demand):
    """halo_window through the fused window step at D = 128 (#13's
    ``emit_res`` and #14's plain versions; the remote partial's cotangent
    back through the typed aggregation and the reverse all-to-all), its
    XW spill's type buckets pinned across ranks on-demand, against the JAX
    package's single-device gradient of the plain path."""
    name = f"fused-od{on_demand}"
    loss, grads, _ = _port(job, name)
    ref_loss, ref_grads = _single_grads(
        job.cases[name], {k: v for k, v in CFG_WIN.items()
                          if k not in ("backend", "fuse_gru")})
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _check_grads(grads, ref_grads, tol_abs=TOL_GRAD)


def test_hot_set_halo_onehot_grads(job):
    """bf16 halo_onehot training on a hub-skewed cut, dense plan and hot
    set: the dense plan against the JAX package's sharded gradients, and
    the hot set against the dense plan (the reference's tolerances on the
    loss and the updated parameters)."""
    loss_d, grads_d, params_d = _port(job, "bf16-onehot-dense")
    loss_h, _, params_h = _port(job, "bf16-onehot-hot")
    ref_loss, ref_grads = _sharded_grads(job.cases["bf16-onehot-dense"])
    np.testing.assert_allclose(loss_d, ref_loss, rtol=1e-5)
    _check_grads(grads_d, ref_grads, relf=TOL_GRAD_BF16)
    np.testing.assert_allclose(loss_h, loss_d, rtol=1e-5)
    for k in params_d:
        np.testing.assert_allclose(params_h[k], params_d[k], rtol=5e-4,
                                   atol=5e-5, err_msg=k)


def test_sharded_grad_quant_training(job):
    """Sharded halo_window training with int8 gradient streams
    (``grad_quant``): the loss and every leaf against the JAX package's
    sharded step with the same quantization (each rank quantizes its own
    ā to its blocks' power-of-2 scales)."""
    loss, grads, _ = _port(job, "grad_quant")
    ref_loss, ref_grads = _sharded_grads(job.cases["grad_quant"])
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    _check_grads(grads, ref_grads, relf=TOL_GRAD_BF16)
