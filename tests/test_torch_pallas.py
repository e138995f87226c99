"""The port's ``pallas`` backend and SDDMM edge gates against the JAX
package: ``pack_type_tiles`` array for array, the plain versions of kernels
#16 ``packed_messages`` and #17 ``sddmm_pallas`` against the JAX kernels in
Pallas interpret mode, ``typed_aggregate_tiled`` and its VJP (dh, dW, db
and the gate gradient dmask) against ``jax.vjp`` of the reference,
``propagate`` (pallas gated and ungated, xla gated) against the JAX
``propagate`` and the NumPy oracle, gradients of a ``propagate`` loss, the
``pallas`` Predictor and Trainer CLI, gated checkpoints both ways, and the
gates ignored (with a warning) where the reference ignores them.  The same
seeded numpy inputs go to both packages; on the CPU the port's wrappers
run their plain versions.

Tolerances (those of the reference's own tests where it has the test):

- layouts: exact, array for array;
- #16 and #17 plain versions: f32 rtol = atol = 1e-6
  (``tests/test_edge_gates.py``); bf16 inputs with f32 sums rtol 1e-5
  (bf16·bf16 products are exact in f32, the sums' order differs);
- ``typed_aggregate_tiled`` forward and cotangents: rtol 1e-5, atol 1e-6
  in f32;
- ``propagate`` against JAX and the oracle: rtol 3e-5, atol 3e-6
  (``tests/test_edge_gates.py``); the fuzz: rtol 5e-5, atol 5e-6
  (``tests/test_fuzz_parity.py``);
- gradients of a ``propagate`` loss: rtol 1e-4, atol 1e-5
  (``tests/test_backend_grads.py``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.graph import PaddingSpec, batch_graphs
from ggnn_tpu.infer import Predictor as JaxPredictor
from ggnn_tpu.models import ModelConfig as JaxConfig
from ggnn_tpu.models import init_params as jax_init
from ggnn_tpu.models import propagate as jax_propagate
from ggnn_tpu.oracle import oracle_propagate
from ggnn_tpu.ops import spmm_pallas as JS
from ggnn_tpu.ops import window_pallas as WP
from ggnn_tpu.ops.segment import sddmm as jax_sddmm
from ggnn_tpu.train import checkpoint as jax_ckpt
from ggnn_tpu_torch.infer import Predictor
from ggnn_tpu_torch.models import ModelConfig, params_from_numpy, propagate
from ggnn_tpu_torch.models.init import init_params, params_to_numpy
from ggnn_tpu_torch.ops import segment as SG
from ggnn_tpu_torch.ops import spmm as SP
from ggnn_tpu_torch.ops import window as W
from ggnn_tpu_torch.train import checkpoint as torch_ckpt

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray,
                        jax_init(jax.random.PRNGKey(seed), JaxConfig(**cfg_kw)))


def _random_batch(rng, n_graphs=3, n_edge_types=3, annotation_dim=2,
                  empty_types=False, mult_nodes=8):
    """The reference's random_batch (``tests/test_pallas_spmm.py``)."""
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(3, 10))
        m = int(rng.integers(1, 2 * n))
        types = (np.zeros(m, np.int64) if empty_types
                 else rng.integers(0, n_edge_types, m))
        edges = np.stack([rng.integers(0, n, m), types,
                          rng.integers(0, n, m)], axis=1)
        ann = (rng.random((n, annotation_dim)) < 0.5).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    spec = PaddingSpec(
        n_graphs=n_graphs,
        n_pad=sum(g["n_nodes"] for g in graphs) + 3,
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 5,
        n_edge_types=n_edge_types,
        annotation_dim=annotation_dim).round_up(mult_nodes=mult_nodes)
    return graphs, spec, batch_graphs(graphs, spec)


def _edge_args(b, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return tuple(conv(x) for x in (b.annotations, b.edge_src, b.edge_dst,
                                   b.edge_type, b.edge_mask))


def _gated(cfg):
    """A config with the edge gates on, past the __post_init__ check that
    refuses them on the onehot and window backends (the only way to reach
    propagate's handling of that combination in either package)."""
    object.__setattr__(cfg, "edge_gates", True)
    return cfg


# --- the layout ---------------------------------------------------------------

@pytest.mark.parametrize("tile_e", [8, 32])
@pytest.mark.parametrize("empty_types", [False, True])
def test_pack_type_tiles_matches_jax(rng, tile_e, empty_types):
    """Array for array the reference's layout: padding slots with src =
    dst = 0 and mask 0, masked edges dropped, the tile types from
    searchsorted, clipped (tests/test_pallas_spmm.py's cases)."""
    _, spec, b = _random_batch(rng, empty_types=empty_types)
    cols = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.type_offsets)
    ref = JS.pack_type_tiles(*map(jnp.asarray, cols), spec.n_message_types,
                             tile_e)
    got = SP.pack_type_tiles(*map(torch.as_tensor, cols),
                             spec.n_message_types, tile_e)
    assert got["n_tiles"] == ref["n_tiles"] == SP.tiles_budget(
        spec.e_pad, spec.n_message_types, tile_e)
    assert got["tile_e"] == ref["tile_e"]
    for k in ("src", "dst", "mask", "tile_type"):
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.dtype == r.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)
    assert got["mask"].sum().item() == b.edge_mask.sum()


# --- the kernels' plain versions ----------------------------------------------

def _tiles(seed, N, E, T2, tile_e, D, dtype):
    """A packed layout of random type-sorted edges (some masked, types
    3 and 4 empty), h, W and b in ``dtype``."""
    r = np.random.default_rng(seed)
    typ = np.sort(r.integers(0, T2, E))
    typ = np.where((typ == 3) | (typ == 4), 2, typ).astype(np.int32)
    mask = (r.random(E) < 0.85).astype(np.float32)
    counts = np.bincount(typ, minlength=T2)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols = (r.integers(0, N, E).astype(np.int32),
            r.integers(0, N, E).astype(np.int32), typ, mask, offs)
    lay = JS.pack_type_tiles(*map(jnp.asarray, cols), T2, tile_e)
    h = r.standard_normal((N, D)).astype(np.float32)
    w = (r.standard_normal((T2, D, D)) * D ** -0.5).astype(np.float32)
    b = (r.standard_normal((T2, D)) * 0.1).astype(np.float32)
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = dict(h=jnp.asarray(h, jt), w=jnp.asarray(w, jt), b=jnp.asarray(b, jt))
    tx = dict(h=torch.tensor(h).to(tt), w=torch.tensor(w).to(tt),
              b=torch.tensor(b).to(tt))
    tlay = {k: (torch.tensor(np.asarray(v)) if k not in ("n_tiles", "tile_e")
                else v) for k, v in lay.items()}
    return lay, tlay, jx, tx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_e,D", [(8, 4), (32, 8), (128, 16)])
def test_packed_messages_matches_jax(dtype, tile_e, D):
    """#16's plain version against the JAX kernel (interpret mode): f32
    rtol = atol = 1e-6; bf16 inputs, f32 sums, rtol 1e-5."""
    lay, tlay, jx, tx = _tiles(3, 40, 300, 6, tile_e, D, dtype)
    ref = JS.packed_messages(jx["h"], lay["src"], lay["mask"],
                             lay["tile_type"], jx["w"], jx["b"],
                             tile_e=tile_e, interpret=True)
    got = SP.packed_messages(tx["h"], tlay["src"], tlay["mask"],
                             tlay["tile_type"], tx["w"], tx["b"], tile_e)
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    pad = tlay["mask"] == 0
    assert (got[pad] == 0).all()


@pytest.mark.parametrize("G", [16, 5])
def test_sddmm_pallas_matches_jax(rng, G):
    """#17's plain version against the JAX kernel on pre-gathered rows
    (tests/test_edge_gates.py), and its index form (the kernel's null
    indices or int32 arrays) against the reference's ``sddmm``."""
    E = 64
    p = rng.standard_normal((E, G)).astype(np.float32)
    q = rng.standard_normal((E, G)).astype(np.float32)
    src = rng.integers(0, E, E).astype(np.int32)
    dst = rng.integers(0, E, E).astype(np.int32)
    mask = (rng.random(E) < 0.8).astype(np.float32)
    ref = JS.sddmm_pallas(jnp.asarray(p[src]), jnp.asarray(q[dst]),
                          tile_e=8, interpret=True)
    got = SP.sddmm_pallas(torch.tensor(p[src]), torch.tensor(q[dst]),
                          tile_e=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    ref = jax_sddmm(*map(jnp.asarray, (p, q, src, dst, mask)))
    got = SP.sddmm_pallas(*map(torch.tensor, (p, q)),
                          src=torch.tensor(src), dst=torch.tensor(dst),
                          mask=torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    got = SG.sddmm(*map(torch.tensor, (p, q, src, dst, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_sddmm_grads_match_jax(rng):
    """The score's backward (a regather of the rows, fixed-order sums over
    src and dst) against jax.grad of the reference's ``sddmm``."""
    N, E, G = 12, 50, 6
    p = rng.standard_normal((N, G)).astype(np.float32)
    q = rng.standard_normal((N, G)).astype(np.float32)
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    mask = (rng.random(E) < 0.8).astype(np.float32)
    ct = rng.standard_normal(E).astype(np.float32)
    ref = jax.grad(lambda a, b: jnp.sum(jax_sddmm(
        a, b, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask)) * ct),
        argnums=(0, 1))(jnp.asarray(p), jnp.asarray(q))
    xs = [torch.tensor(x, requires_grad=True) for x in (p, q)]
    out = SG.sddmm(*xs, torch.tensor(src), torch.tensor(dst),
                   torch.tensor(mask))
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(), xs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)



def test_sddmm_mask_takes_no_gradient(rng):
    """The edge mask takes its gradient, as the reference's ``sddmm``
    gives it one: dp, dq and dmask_e = ḡ_e·⟨p[src_e], q[dst_e]⟩ (#17
    with a mask of ones) against jax.grad of ``ggnn_tpu.ops.segment.sddmm``
    in all three arguments, f32 rtol 1e-5, atol 1e-6; and a mask that asks
    for none gets none."""
    N, E, G = 6, 20, 4
    p, q = (rng.standard_normal((N, G)).astype(np.float32) for _ in range(2))
    src, dst = (rng.integers(0, N, E).astype(np.int32) for _ in range(2))
    mask = rng.random(E).astype(np.float32)
    ct = rng.standard_normal(E).astype(np.float32)
    ref = jax.grad(lambda a, b, m: jnp.sum(jax_sddmm(
        a, b, jnp.asarray(src), jnp.asarray(dst), m) * ct),
        argnums=(0, 1, 2))(*map(jnp.asarray, (p, q, mask)))
    xs = [torch.tensor(x, requires_grad=True) for x in (p, q, mask)]
    out = SG.sddmm(xs[0], xs[1], torch.tensor(src), torch.tensor(dst), xs[2])
    got = torch.autograd.grad((out * torch.tensor(ct)).sum(), xs)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    out = SG.sddmm(xs[0], xs[1], torch.tensor(src), torch.tensor(dst),
                   xs[2].detach())
    dp, dq = torch.autograd.grad(out.sum(), xs[:2])
    assert dp.shape == p.shape and dq.shape == q.shape

# --- typed_aggregate_tiled and its VJP ----------------------------------------

@pytest.mark.parametrize("gated", [False, True])
def test_typed_aggregate_tiled_vjp_matches_jax(gated):
    """The forward and all four cotangents (dh, dW, db and, with a mask
    that needs one, dmask) against jax.vjp of the reference's
    ``typed_aggregate_tiled`` (interpret mode), f32 rtol 1e-5, atol 1e-6;
    without the gate the port computes no dmask."""
    N, D, T2, tile_e = 40, 8, 6, 8
    lay, tlay, jx, tx = _tiles(5, N, 300, T2, tile_e, D, "float32")
    r = np.random.default_rng(6)
    gate = (np.asarray(lay["mask"]) * r.random(lay["mask"].shape[0])
            ).astype(np.float32)
    da = r.standard_normal((N, D)).astype(np.float32)

    def jf(h, w, b, m):
        return JS.typed_aggregate_tiled(h, lay, w, b, interpret=True,
                                        mask=m if gated else None)
    jm = jnp.asarray(gate)
    ref, vjp = jax.vjp(jf, jx["h"], jx["w"], jx["b"], jm)
    ref_ct = vjp(jnp.asarray(da))
    xs = [t.clone().requires_grad_(True) for t in (tx["h"], tx["w"], tx["b"])]
    m = torch.tensor(gate, requires_grad=True) if gated else None
    got = SP.typed_aggregate_tiled(*xs[:1], tlay, *xs[1:], mask=m)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    cts = torch.autograd.grad(got, xs + ([m] if gated else []),
                              torch.tensor(da))
    names = ("dh", "dW", "db", "dmask")
    for name, g, rr in zip(names, cts, ref_ct):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_dmask_only_when_needed(monkeypatch):
    """#16 runs once in an ungated backward's forward and not again: the
    dmask recompute is skipped when the mask needs no gradient; a gated
    mask's backward recomputes the unmasked messages (#16 with mask 1)."""
    N, D, T2, tile_e = 40, 8, 6, 8
    _, tlay, _, tx = _tiles(7, N, 300, T2, tile_e, D, "float32")
    calls = []
    plain = SP.packed_messages

    def counting(h, src, mask, *a, **k):
        calls.append(bool((mask == 1).all()))
        return plain(h, src, mask, *a, **k)
    monkeypatch.setattr(SP, "packed_messages", counting)
    h = tx["h"].clone().requires_grad_(True)
    SP.typed_aggregate_tiled(h, tlay, tx["w"], tx["b"]).sum().backward()
    assert calls == [False]
    calls.clear()
    m = tlay["mask"].clone().requires_grad_(True)
    SP.typed_aggregate_tiled(h, tlay, tx["w"], tx["b"], mask=m).sum() \
        .backward()
    assert calls == [False, True]


def test_pallas_no_edges():
    """A batch whose every edge is padding aggregates to exactly zero
    (tests/test_pallas_spmm.py::test_pallas_no_edges)."""
    n_pad, e_pad, D = 16, 16, 4
    r = np.random.default_rng(1)
    h = torch.tensor(r.standard_normal((n_pad, D)).astype(np.float32))
    w = torch.tensor(r.standard_normal((4, D, D)).astype(np.float32))
    b = torch.tensor(r.standard_normal((4, D)).astype(np.float32))
    z = torch.zeros(e_pad, dtype=torch.int32)
    out = SP.typed_aggregate_pallas(h, z, z, z, torch.zeros(e_pad), w, b,
                                    type_offsets=torch.zeros(5,
                                                             dtype=torch.int32),
                                    tile_e=8)
    assert out.shape == (n_pad, D) and (out == 0).all()


# --- propagate ----------------------------------------------------------------

CASES = {
    # name: (backend, edge_gates, compute_dtype)
    "pallas": ("pallas", False, "float32"),
    "pallas_gated": ("pallas", True, "float32"),
    "xla_gated": ("xla", True, "float32"),
    "pallas_bf16": ("pallas", False, "bfloat16"),
    "pallas_gated_bf16": ("pallas", True, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_propagate_matches_jax_and_oracle(rng, case):
    """Per-step states of propagate against the JAX package's (rtol 3e-5,
    atol 3e-6 in f32; bf16: both round the same values, rtol 1e-3, atol
    1e-4 of values ≤ 1), and the f32 cases' final states against the
    oracle with gate_p/gate_q (tests/test_edge_gates.py)."""
    backend, gates, cdt = CASES[case]
    graphs, _, b = _random_batch(rng)
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=4,
              backend=backend, edge_gates=gates, compute_dtype=cdt)
    params = _np_params(kw, seed=7)
    _, ref = jax_propagate(params["prop"], JaxConfig(**kw),
                           *_edge_args(b, "jax"), collect_states=True,
                           type_offsets=jnp.asarray(b.type_offsets))
    with torch.no_grad():
        _, got = propagate(params_from_numpy(params["prop"]),
                           ModelConfig(**kw), *_edge_args(b, "torch"),
                           collect_states=True,
                           type_offsets=torch.as_tensor(b.type_offsets))
    tol = dict(rtol=3e-5, atol=3e-6) if cdt == "float32" else \
        dict(rtol=1e-3, atol=1e-4)
    for t in range(4):
        np.testing.assert_allclose(got[t].numpy(), np.asarray(ref[t]),
                                   err_msg=f"step {t}", **tol)
    if cdt != "float32":
        return
    p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for gi, g in enumerate(graphs):
        want = oracle_propagate(p64["prop"], g["annotations"], g["edges"], 3,
                                4)[-1]
        np.testing.assert_allclose(
            got[-1][offs[gi]:offs[gi] + g["n_nodes"]].numpy(), want,
            rtol=3e-5, atol=3e-6)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_pallas_vs_oracle(seed):
    """tests/test_fuzz_parity.py's topologies (density, types, self-loops,
    duplicates, empty types) through the port's pallas backend, ungated
    and gated, against the oracle (rtol 5e-5, atol 5e-6); without
    type_offsets on odd seeds (the counts of real edges per type)."""
    r = np.random.default_rng(1000 + seed)
    E = int(r.integers(1, 6))
    A = int(r.integers(1, 4))
    D = int(r.integers(3, 12))
    T = int(r.integers(1, 7))
    graphs = []
    for _ in range(int(r.integers(1, 5))):
        n = int(r.integers(2, 14))
        m = int(r.integers(0, 3 * n))
        edges = np.stack([r.integers(0, n, m), r.integers(0, E, m),
                          r.integers(0, n, m)], axis=1) if m else \
            np.zeros((0, 3), np.int64)
        ann = (r.random((n, A)) < r.random()).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    spec = PaddingSpec(
        n_graphs=len(graphs),
        n_pad=sum(g["n_nodes"] for g in graphs) + int(r.integers(0, 9)),
        e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
        n_edge_types=E, annotation_dim=A).round_up(mult_nodes=128)
    b = batch_graphs(graphs, spec)
    offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
    for gates in (False, True):
        kw = dict(state_dim=D, annotation_dim=A, n_edge_types=E, n_steps=T,
                  backend="pallas", edge_gates=gates)
        params = _np_params(kw, seed=seed)
        p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        to = torch.as_tensor(b.type_offsets) if seed % 2 == 0 else None
        with torch.no_grad():
            h = propagate(params_from_numpy(params["prop"]),
                          ModelConfig(**kw), *_edge_args(b, "torch"),
                          type_offsets=to).numpy()
        for gi, g in enumerate(graphs):
            ref = oracle_propagate(p64["prop"], g["annotations"], g["edges"],
                                   E, T)[-1]
            np.testing.assert_allclose(
                h[offs[gi]:offs[gi] + g["n_nodes"]], ref, rtol=5e-5,
                atol=5e-6, err_msg=f"gates={gates} seed={seed}")


@pytest.mark.parametrize("edge_gates", [False, True])
def test_pallas_grads_match_jax(rng, edge_gates):
    """Gradients of sum(h²) through propagate(backend='pallas') against the
    JAX package's, every parameter leaf (tests/test_backend_grads.py:
    rtol 1e-4, atol 1e-5)."""
    _, _, b = _random_batch(rng)
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              backend="pallas", edge_gates=edge_gates)
    params = _np_params(kw)

    def jloss(p):
        h = jax_propagate(p["prop"], JaxConfig(**kw), *_edge_args(b, "jax"),
                          type_offsets=jnp.asarray(b.type_offsets))
        return jnp.sum(h ** 2)
    ref = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    prop = params_from_numpy(params["prop"])
    leaves = {}

    def walk(tree, pre):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                v.requires_grad_(True)
                leaves[f"{pre}{k}"] = v
    walk(prop, "")
    h = propagate(prop, ModelConfig(**kw), *_edge_args(b, "torch"),
                  type_offsets=torch.as_tensor(b.type_offsets))
    grads = torch.autograd.grad((h ** 2).sum(), list(leaves.values()))
    assert edge_gates == ("gate_p" in leaves)
    for (k, g) in zip(leaves, grads):
        r = ref["prop"]
        for part in k.split("/"):
            r = r[part]
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("backend", ["onehot", "window"])
def test_gates_ignored_where_the_reference_ignores_them(backend):
    """On onehot and window the reference's propagate aggregates ungated
    whatever cfg.edge_gates says (its ModelConfig refuses the combination;
    a config past that check reaches it): the port's states equal the JAX
    package's there, and the port warns that the gates are not applied."""
    N, E, T = 256, 900, 3
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=T, n_steps=2,
              backend=backend)
    params = _np_params(dict(kw, backend="xla", edge_gates=True), seed=3)
    r = np.random.default_rng(8)
    order = np.argsort(r.integers(0, 2 * T, E), kind="stable")
    edges = (r.integers(0, N, E).astype(np.int32)[order],
             r.integers(0, N, E).astype(np.int32)[order],
             np.sort(r.integers(0, 2 * T, E)).astype(np.int32),
             (r.random(E) < 0.9).astype(np.float32))
    ann = (r.random((N, 2)) < 0.4).astype(np.float32)
    tlay = jlay = None
    if backend == "window":
        tlay = W.build_window_layout(*edges, N, window=256, block_rows=256,
                                     min_edges_per_tile=4,
                                     n_message_types=2 * T, row_major="block")
        jlay = WP.DeviceWindowLayout(
            meta=tlay.meta,
            arrays={k: jnp.asarray(v) for k, v in tlay.arrays.items()})
    ref = jax_propagate(params["prop"], _gated(JaxConfig(**kw)),
                        jnp.asarray(ann), *map(jnp.asarray, edges),
                        scatter_layout=jlay)
    with pytest.warns(UserWarning, match="edge_gates are not applied"):
        with torch.no_grad():
            got = propagate(params_from_numpy(params["prop"]),
                            _gated(ModelConfig(**kw)), torch.tensor(ann),
                            *map(torch.tensor, edges), scatter_layout=tlay)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-6)


# --- serving, training, checkpoints -------------------------------------------

@pytest.mark.parametrize("edge_gates", [False, True])
def test_pallas_predictor_matches_jax(rng, edge_gates):
    """The pallas Predictor (no host layout; the tiles packed in propagate
    from the batch's type_offsets) serves the JAX Predictor's answers and
    scores (f32, D = 8: rtol = atol = 2e-5, as the xla Predictor's)."""
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              head="node_select", backend="pallas", edge_gates=edge_gates)
    params = _np_params(kw, seed=4)
    graphs, _, _ = _random_batch(rng, n_graphs=7)
    spec = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                       annotation_dim=2).round_up()
    pj = JaxPredictor(JaxConfig(**kw), spec,
                      params=jax.tree.map(jnp.asarray, params))
    pt = Predictor(ModelConfig(**kw), spec, params=params, device="cpu")
    assert pt.layout(batch_graphs(graphs[:4], spec)) is None
    assert pt.predict(graphs) == pj.predict(graphs)
    batch = batch_graphs(graphs[:4], spec)
    ref = pj._fwd(pj.params, jax.tree.map(jnp.asarray, batch.arrays), None)
    np.testing.assert_allclose(pt.run_batch(batch), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def babi_root(tmp_path_factory):
    from ggnn_tpu.data.babi import TASKS
    from ggnn_tpu.data.generators import generate_all
    root = str(tmp_path_factory.mktemp("babi_pallas"))
    n = max(50 * TASKS[4].n_question_types, 50)
    generate_all(root, tasks=(4,), folds=(1,), n_train=n, n_test=n, seed=0)
    return root


def test_babi4_pallas_cli_end_to_end(babi_root):
    """python -m ggnn_tpu_torch.train --config babi4 --backend pallas
    --device cpu trains bAbI task 4 to ≥ 95 % test accuracy in 80 epochs,
    as the onehot CLI does, without importing jax."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from ggnn_tpu_torch.train.__main__ import main\n"
        f"rc = main(['--config', 'babi4', '--backend', 'pallas', "
        f"'--epochs', '80', '--data_root', {babi_root!r}, "
        "'--device', 'cpu'])\n"
        "print('JAX_LOADED', 'jax' in sys.modules, rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "JAX_LOADED False 0"
    result = json.loads(lines[-2])
    assert result["epochs"] == 80
    assert result["test_accuracy"] >= 0.95


def test_gated_checkpoint_both_ways(tmp_path):
    """A gated model's checkpoint (gate_p, gate_q among the leaves, of the
    reference's init_params layout) carries from the JAX package to the
    port and back, leaf for leaf, and the port's own init makes the same
    leaves."""
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=2,
              backend="pallas", edge_gates=True, gate_dim=5)
    params_j = jax_init(jax.random.PRNGKey(9), JaxConfig(**kw))
    want = dict(torch_ckpt._flatten(jax.tree.map(np.asarray, params_j)))
    assert want["prop/gate_p"].shape == (8, 5)
    own = dict(torch_ckpt._flatten(params_to_numpy(init_params(
        ModelConfig(**kw), torch.Generator().manual_seed(0)))))
    assert {k: v.shape for k, v in own.items()} == \
        {k: v.shape for k, v in want.items()}
    path = str(tmp_path / "gated.npz")
    jax_ckpt.save_checkpoint(path, {"params": params_j}, step=3)
    spec = PaddingSpec(n_graphs=2, n_pad=32, e_pad=64, n_edge_types=3,
                       annotation_dim=2)
    pred = Predictor(ModelConfig(**kw), spec, checkpoint_path=path,
                     device="cpu")
    got = dict(torch_ckpt._flatten(params_to_numpy(pred.params)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = str(tmp_path / "back.npz")
    torch_ckpt.save_checkpoint(back, {"params": pred.params}, step=4)
    tree, meta = jax_ckpt.load_checkpoint(back, {"params": params_j})
    assert meta["step"] == 4
    for k, v in torch_ckpt._flatten(jax.tree.map(np.asarray,
                                                 tree["params"])):
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_window_bwd_fused_takes_d256_on_card():
    """#14 at D = 256 (and 200, padded to 256) on the card against its
    plain version, exact and with int8 ā: it no longer raises above 128."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    r = np.random.default_rng(2)
    N, E, T2 = 1024, 30_000, 8
    dst = r.integers(0, N, E)
    src = ((dst // 256) * 256 + r.integers(0, 256, E)) % N
    lay = W.build_window_layout(src, dst, r.integers(0, T2, E),
                                np.ones(E, np.float32), N, window=256,
                                block_rows=256, n_message_types=T2,
                                row_major="block", min_edges_per_tile=4,
                                with_grad=True).to("cuda")
    assert lay.grad_meta[4]
    a = lay.arrays
    gt = (a["c_stream"], a["gt_tile_start"], a["gt_block_of_tile"],
          a["gt_win_of_tile"], a["gt_c_off"])
    kw = dict(n_wins=lay.grad_meta[0], window=256, out_rows=256, t2=T2)
    for D in (200, 256):
        gen = torch.Generator(device="cuda").manual_seed(D)
        da = torch.randn(lay.n_blocks * 256, D, device="cuda", generator=gen)
        h = (torch.rand(N, D, device="cuda", generator=gen) * 2 - 1).bfloat16()
        w = (torch.randn(T2, D, D, device="cuda", generator=gen)
             * D ** -0.5).bfloat16()
        q, sc = W.quantize_grad_pow2(da, 256)
        for da_t, scales in ((da.bfloat16().t().contiguous(), None),
                             (q.t().contiguous(), sc)):
            got = W.window_bwd_fused(da_t, *gt, w, h, da_scales=scales, **kw)
            again = W.window_bwd_fused(da_t, *gt, w, h, da_scales=scales,
                                       **kw)
            ref = W.window_bwd_fused_reference(da_t, *gt, w, h,
                                               da_scales=scales, **kw)
            mag = W.window_bwd_fused_reference(
                da_t.abs(), *gt, w.abs(), h.abs(), da_scales=scales, **kw)
            for x, y, z, m in zip(got, again, ref, mag):
                assert torch.equal(x, y)
                assert ((x - z).abs() <= (2e-5 + 2.0 ** -7) * m + 1e-30
                        ).all()
