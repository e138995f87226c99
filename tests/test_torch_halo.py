"""The port's sharded propagation (``ggnn_tpu_torch/parallel/halo.py``)
against the JAX package's, the port's ranks in their own processes.

One job of 4 gloo ranks on the CPU (``tests/torch_dist_worker.py``) runs
every case of this module; P = 2 cases run on two data replicas of the
4-rank world (held bit-equal to each other), P = 4 on all of it.  The JAX
side runs ``sharded_propagate`` on the conftest's 8-device CPU mesh (Pallas
in interpret mode), a few references at a time in threads, while the
ranks compute; the hot-set and clustered cases, like the reference's own
tests, hold the port to the JAX package's single-device ``propagate``.

Tolerances: f32, the same math summed in another order (the reference's
``rtol=2e-5, atol=2e-6``); bf16, the same rounding points (states rounded
to bf16 for the exchange and the messages, f32 sums), where a last-bit
difference of an f32 state could round one pool row to the other bf16
neighbour: each element within one bf16 ulp at 1.0 (2**-8), the mean
within 1e-5 (these inputs measured 2.4e-7 at most)."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from ggnn_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
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
DTYPES = ("float32", "bfloat16")
TOL_F32 = dict(rtol=2e-5, atol=2e-6)
TOL_BF16_MAX, TOL_BF16_MEAN = 2.0 ** -8, 1e-5
CFG = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3)
# D = 128 (the fused window step's width), the fused step and q8 serving
CFG_WIN = dict(state_dim=128, annotation_dim=2, n_edge_types=3, n_steps=2,
               backend="window", fuse_gru=True)
# the layouts of the kernel strategies: P = 2 with the 16-aligned dst-local
# scatter and the 'src'-row window layout; P = 4 with the one-hot stream
# (tile_e 8) and block rows with the XW spill
LAYOUTS = {
    ("halo_onehot", 2): dict(kind="scatter", tile_e=16),
    ("halo_onehot", 4): dict(kind="scatter", tile_e=8),
    ("halo_window", 2): dict(kind="window", window=64, min_edges_per_tile=4,
                             spill_tile_e=16, n_message_types=6),
    ("halo_window", 4): dict(kind="window", window=128, min_edges_per_tile=4,
                             spill_tile_e=16, n_message_types=6,
                             row_major="block", typed_spill=True),
}
WIN_FUSED = dict(kind="window", window=128, min_edges_per_tile=4,
                 spill_tile_e=16, n_message_types=6, row_major="block")


def _community():
    b = synthetic_batch(512, 3000, 3, annotation_dim=2, seed=3,
                        node_mult=512, n_communities=4, p_intra=0.8)
    # no edge of the highest message type: the layouts must address the
    # model's whole table all the same
    b.edge_mask[b.edge_type == 5] = 0.0
    return b


def _fused_batch():
    return synthetic_batch(512, 3000, 3, annotation_dim=2, seed=11,
                           node_mult=512, n_communities=4, p_intra=0.9)


def _cases():
    b = _community()
    cases = []
    for dt in DTYPES:
        cfg = dict(CFG, compute_dtype=dt)
        params = C.jax_params(0, **cfg)
        for P in (2, 4):
            for s in STRATEGIES:
                cases.append(dict(name=f"{s}-{P}-{dt}", kind="propagate",
                                  P=P, batch=b, params=params, cfg=cfg,
                                  strategy=s, layout=LAYOUTS.get((s, P))))
    params = C.jax_params(0, **CFG)
    cases.append(dict(name="halo-2-local", kind="propagate", P=2, batch=b,
                      params=params, cfg=CFG, strategy="halo", local=True))
    cases.append(dict(name="halo_window-2-local", kind="propagate", P=2,
                      batch=b, params=params, cfg=CFG,
                      strategy="halo_window",
                      layout=LAYOUTS[("halo_window", 2)], local=True))
    fb = _fused_batch()
    pw = C.jax_params(2, **CFG_WIN)
    for q8 in (False, True):
        cases.append(dict(name=f"fused-q8{q8}", kind="propagate", P=2,
                          batch=fb, params=pw,
                          cfg=dict(CFG_WIN, quantized_table=q8),
                          strategy="halo_window", layout=WIN_FUSED))
    hot = C.skewed_batch(1024, 8192, 4, seed=6)
    ph = C.jax_params(0, state_dim=8, annotation_dim=2, n_edge_types=2,
                      n_steps=3)
    hcfg = dict(state_dim=8, annotation_dim=2, n_edge_types=2, n_steps=3)
    for s in ("halo", "halo_overlap", "halo_onehot"):
        cases.append(dict(name=f"hot-{s}", kind="propagate", P=4, batch=hot,
                          params=ph, cfg=hcfg, strategy=s,
                          part=dict(hot_thresh=2),
                          layout=(dict(kind="scatter", tile_e=16)
                                  if s == "halo_onehot" else None)))
    clu = synthetic_batch(512, 4096, 3, annotation_dim=2, seed=1,
                          node_mult=32, n_communities=4, p_intra=0.9)
    cases.append(dict(name="clustered", kind="propagate", P=4, batch=clu,
                      params=C.jax_params(0, **CFG), cfg=CFG,
                      strategy="halo_overlap"))
    return cases


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    cases = _cases()
    j = RankJob(cases, 4, tmp_path_factory.mktemp("halo_ranks"),
                timeout=600)
    j.cases = {c["name"]: c for c in cases}
    yield j
    j.wait()


def _jax_sharded(case):
    """The JAX package's sharded_propagate of a case → global h."""
    jb = C.to_jax_batch(case["batch"])
    cfg = JaxConfig(**case["cfg"])
    parts = JP.split_local_remote(JP.partition_batch(jb, case["P"]))
    lay = case.get("layout")
    layouts = None
    if lay is not None:
        kw = {k: v for k, v in lay.items() if k != "kind"}
        layouts = (JP.build_halo_scatter_layouts(parts, **kw)
                   if lay["kind"] == "scatter"
                   else JP.build_halo_window_layouts(parts, **kw))
    prop = jax.tree.map(np.asarray, case["params"]["prop"])
    return np.asarray(jax_sharded_propagate(
        prop, cfg, jax_make_mesh(n_graph=case["P"]), parts,
        strategy=case["strategy"], halo_layouts=layouts))


def _jax_single(case):
    """The JAX package's single-device propagate of a case's batch."""
    b = case["batch"]
    return np.asarray(jax_propagate(
        case["params"]["prop"], JaxConfig(**case["cfg"]), b.annotations,
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask))


@pytest.fixture(scope="module")
def refs(job):
    """Every JAX reference, a few at a time (their compiles overlap)."""
    sharded = [n for n in job.cases if n.count("-") == 2
               and not n.endswith("local")] + ["fused-q8False"]
    single = [n for n in job.cases if n.startswith("hot-")] + ["clustered"]
    with ThreadPoolExecutor(max(1, min(3, (os.cpu_count() or 2) - 1))) as ex:
        out = dict(zip(sharded, ex.map(lambda n: _jax_sharded(job.cases[n]),
                                       sharded)))
    out.update({n: _jax_single(job.cases[n]) for n in single})
    return out


def _check(got, ref, dtype):
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, **TOL_F32)
        return
    d = np.abs(got - ref)
    assert d.max() <= TOL_BF16_MAX * max(1.0, np.abs(ref).max()), d.max()
    assert d.mean() <= TOL_BF16_MEAN, d.mean()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", (2, 4))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sharded_propagate_matches_jax(job, refs, strategy, P, dtype):
    """Each strategy's h, at P = 2 and 4, f32 and bf16, against the JAX
    package's sharded_propagate on the same partition and layouts."""
    name = f"{strategy}-{P}-{dtype}"
    _check(C.gather_h(job, name, P), refs[name], dtype)


@pytest.mark.parametrize("strategy", ("halo", "halo_window"))
def test_local_parts_path_is_the_host_path(job, strategy):
    """A rank's LocalParts and local layout give the host partition's
    path the same bits."""
    np.testing.assert_array_equal(
        C.gather_h(job, f"{strategy}-2-local", 2),
        C.gather_h(job, f"{strategy}-2-float32", 2))


def test_sharded_fused_window_step_matches_jax(job, refs):
    """halo_window through the fused window step (#13's plain version on
    the CPU, the remote partial as ``extra_init``) at D = 128 against the
    JAX package's fused sharded step."""
    _check(C.gather_h(job, "fused-q8False", 2), refs["fused-q8False"],
           "float32")


def test_sharded_halo_window_q8_serving(job):
    """q8 serving through the sharded fused step: each rank quantizes its
    own table windows; the result tracks the exact sharded path within the
    reference's quantization bound (5 % of the largest state)."""
    got = C.gather_h(job, "fused-q8True", 2)
    ref = C.gather_h(job, "fused-q8False", 2)
    assert not np.array_equal(got, ref)
    err = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert err < 0.05, err


@pytest.mark.parametrize("strategy", ("halo", "halo_overlap", "halo_onehot"))
def test_hot_set_exchange_matches_single_device(job, refs, strategy):
    """The hot-set hybrid exchange (``hot_thresh=2`` on a hub-skewed cut,
    P = 4: the hot rows ride an all_gather) against the JAX package's
    single-device propagate (the reference's tolerance)."""
    np.testing.assert_allclose(C.gather_h(job, f"hot-{strategy}", 4),
                               refs[f"hot-{strategy}"], rtol=3e-5,
                               atol=3e-6)


def test_clustered_sharded_propagation_correct(job, refs):
    """halo_overlap on a community graph (P = 4) against the JAX package's
    single-device propagate (the reference's tolerance)."""
    np.testing.assert_allclose(C.gather_h(job, "clustered", 4),
                               refs["clustered"], rtol=3e-5, atol=3e-6)


def test_jax_synthetic_batch_is_the_ports():
    """The cases' batches are the JAX package's arrays."""
    a = _community()
    b = jax_synthetic_batch(512, 3000, 3, annotation_dim=2, seed=3,
                            node_mult=512, n_communities=4, p_intra=0.8)
    b.edge_mask[b.edge_type == 5] = 0.0
    for k in ("edge_src", "edge_dst", "edge_type", "edge_mask",
              "annotations"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
