"""Kernels #17 ``sddmm_pallas`` and #3 ``gru_cell_fwd`` at the seams of
their redesigned CUDA bodies, against the JAX package.

#17's blocked body (``ops/csrc/sddmm_blocked.cu``) runs on a plan made once
per dst array (``ops/spmm.py::sddmm_plan``): the edge ids grouped by dst
block of 128 rows by one stable sort, each block's run cut into work items
of at most K edges.  The plan is checked on CPU tensors: every edge lies in
exactly one item, of its own dst block; items hold 1 … K edges; an empty
block makes no item; a block keeps its edges in their order; the kernel's
lookup of an item's block (``common.cuh::item_block``) finds it.  The
layouts: the pallas backend's packed layout (dst 0 takes every padding
slot), a Zipf-1.2 dst hub, one edge, and 1,037 edges over q of 1,000 rows
with empty blocks.  Scores computed item by item in plan order and written
back by edge id equal the plain version bit for bit, and the JAX package's
``sddmm`` within 1e-5·Σ|p||q| per edge (f32 sums of G unit-normal
products in another order; at G = 128 rtol 1e-6 fails on sums that
cancel); the kernel's lane order (4 products a lane, then the xor
butterfly), emulated in f32, stays within chip_smoke.py's bound of
2e-5·Σ|p||q| per edge.

#3's bf16 body (``ops/csrc/gru_cell_pipe.cu`` on
``gru_pipe.cuh::gru_strip``) gives a warp all 128 columns of a 16-row
strip and keeps its operands in registers.  A lane-by-lane emulation of
its data movement, with the plain version's arithmetic: the A fragments
read from a and h (``load_frags``), the swizzled resident panels read by
``ldmatrix.trans`` (``load_panels``, ``strip_mma``: each fragment product
equals the matrix product), r⊙h made from r's C fragments into the A
fragments of the last product, and the stores (h' as 8-byte pairs; z, r,
h̃ through ``store_group``'s two quad shuffles).  It must give
``gru_cell_fwd_reference``'s bits, and the JAX ``gru_cell_fwd`` in
interpret mode within rtol 1e-5 and one bf16 ulp (2**-7), the cell
tolerance of ``tests/test_torch_kernels.py``.

Tests marked ``cuda`` hold the CUDA kernels to their plain versions on the
card with chip_smoke.py's criteria, twice bit-equal and bit-equal to their
first bodies (``sddmm.cu``; ``gru_cell.cu``'s ``ggnn_gru_cell`` with dtype
1), each called through its C entry point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggnn_tpu.ops import gru_pallas as GP
from ggnn_tpu.ops.segment import sddmm as jax_sddmm
from ggnn_tpu_torch.ops import gru as G
from ggnn_tpu_torch.ops import spmm as SP

torch.set_num_threads(1)

D = 128
BF16_ULP = 2.0 ** -7
PLAN_CASES = ("packed", "zipf hub", "one edge", "uneven")
ITEMS = (64, SP.SDDMM_ITEM)


# --- #17: the plan -----------------------------------------------------------

def _edges(case, seed=0):
    """(src, dst, mask, n_p, n_q) int32 / f32 numpy arrays of a layout."""
    r = np.random.default_rng(seed)
    if case == "packed":
        # the pallas backend's packed layout: type runs padded to whole
        # tiles of 128 with src = dst = 0, masked edges dropped
        N, E, T2 = 700, 6000, 4
        etype = np.sort(r.integers(0, T2, E))
        src, dst = r.integers(0, N, E), r.integers(0, N, E)
        mask = (r.random(E) < 0.8).astype(np.float32)
        offs = np.searchsorted(etype, np.arange(T2 + 1)).astype(np.int32)
        lay = SP.pack_type_tiles(*map(torch.as_tensor, (src, dst, etype,
                                                        mask, offs)), T2)
        s, d = lay["src"].numpy(), lay["dst"].numpy()
        return (s.astype(np.int32), d.astype(np.int32),
                lay["mask"].numpy(), N, N)
    if case == "zipf hub":
        N, E = 3000, 20_000
        dst = np.minimum(r.zipf(1.2, E) - 1, N - 1)
        src = r.integers(0, N, E)
    elif case == "one edge":
        N, E = 300, 1
        src, dst = np.array([N - 1]), np.array([N - 1])
    else:  # 1,037 edges, q of 1,000 rows, blocks 3 and 7 (the last) empty
        N, E = 1000, 1037
        dst = r.integers(0, N, 3 * E)
        dst = dst[~np.isin(dst // 128, (3, 7))][:E]
        src = r.integers(0, N, E)
    mask = (r.random(E) < 0.8).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), mask, N, N


def _items(plan):
    """Each work item of the plan as (key, e0, e1), by the kernel's own
    arithmetic (csrc/sddmm_blocked.cu), its key found as item_block finds
    it: the largest key whose item_first is at most the item."""
    first = plan["item_first"].numpy()
    starts = plan["key_start"].numpy()
    K, n_keys = plan["k"], plan["n_keys"]
    out = []
    for item in range(int(first[n_keys])):
        key = int(np.searchsorted(first[:n_keys], item, side="right")) - 1
        e0 = starts[key] + (item - first[key]) * K
        out.append((key, int(e0), int(min(e0 + K, starts[key + 1]))))
    return out


# slab_bytes: one slab (the dst-block order), or slabs of 100 rows of p
SLABS = (SP.SDDMM_SLAB_BYTES, 100 * 4 * D)


@pytest.mark.parametrize("slab_bytes", SLABS)
@pytest.mark.parametrize("K", ITEMS)
@pytest.mark.parametrize("case", PLAN_CASES)
def test_sddmm_plan_items(case, K, slab_bytes):
    src, dst, _, n_p, n_q = _edges(case)
    E = dst.size
    plan = SP.sddmm_plan(torch.as_tensor(src), torch.as_tensor(dst), n_p,
                         n_q, D, K, slab_bytes=slab_bytes, slab_edges=1)
    order = plan["order"].numpy()
    starts = plan["key_start"].numpy()
    first = plan["item_first"].numpy()
    n_qblk = plan["n_qblk"]
    n_slabs = plan["n_keys"] // n_qblk
    slab_rows = -(-n_p // n_slabs)
    assert plan["order"].dtype == torch.int32
    assert np.array_equal(np.sort(order), np.arange(E))
    assert n_qblk == -(-n_q // 128)
    assert n_slabs == (1 if slab_bytes == SP.SDDMM_SLAB_BYTES
                       else max(1, min(-(-n_p // 100), E // n_qblk)))
    seen = np.zeros(E, np.int64)
    counts = np.diff(starts)
    for key, e0, e1 in _items(plan):
        assert 1 <= e1 - e0 <= K
        assert starts[key] <= e0 < e1 <= starts[key + 1]
        ids = order[e0:e1]
        assert (dst[ids] // 128 == key % n_qblk).all()
        assert (src[ids] // slab_rows == key // n_qblk).all()
        seen[ids] += 1
    assert (seen == 1).all()                 # each edge in exactly one item
    for key in range(plan["n_keys"]):
        ids = order[starts[key]:starts[key + 1]]
        assert (np.diff(ids) > 0).all()      # a key keeps the edge order
        assert first[key + 1] - first[key] == -(-counts[key] // K)
    assert counts.sum() == E
    if case == "uneven" and n_slabs == 1:
        assert counts[3] == counts[7] == 0
        assert first[4] == first[3] and first[8] == first[7]
    if case == "packed" and n_slabs == 1:
        # every padding slot (mask 0) is an edge to dst 0
        assert counts[0] == max(counts)
    assert plan["grid"] >= first[-1]


def _lane_partials(pr, qr):
    """Each lane's partial of each edge [E, 32] on gathered rows [E, G]
    (G % 4 == 0), in f32: lane l adds its 4 products in order."""
    E, G = pr.shape
    part = np.zeros((E, 32), np.float32)
    for l in range(G // 4):
        for i in range(4):
            part[:, l] = part[:, l] + pr[:, 4 * l + i] * qr[:, 4 * l + i]
    return part


def _lane_scores(pr, qr):
    """The first body's sum of the lanes' partials: xor shuffles 16, 8, 4,
    2, 1, each lane adding its partner's value to its own."""
    part = _lane_partials(pr, qr)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lanes ^ off]
    return part[:, 0]


def _fold_scores(pr, qr):
    """sddmm_blocked.cu's batch sum, lane by lane: 32 edges at a time,
    lane l holding its partial of every edge; each round (fold<OFF>) lane
    l keeps the half of its values whose index bit OFF is l's, sends the
    other half to lane l ^ OFF and adds what it receives; lane l ends with
    edge l's sum."""
    E = pr.shape[0]
    part = _lane_partials(pr, qr)
    out = np.zeros(E, np.float32)
    lanes = np.arange(32)
    for b in range(0, E, 32):
        n = min(32, E - b)
        vals = np.zeros((32, 32), np.float32)      # [lane, edge]
        vals[:, :n] = part[b:b + n].T
        for off in (16, 8, 4, 2, 1):
            hi = (lanes & off) != 0
            keep = np.where(hi[:, None], vals[:, off:2 * off], vals[:, :off])
            send = np.where(hi[:, None], vals[:, :off], vals[:, off:2 * off])
            vals = keep + send[lanes ^ off]
        out[b:b + n] = vals[:n, 0]
    return out


@pytest.mark.parametrize("G", [5, 64, 128])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_sddmm_plan_scores(case, G):
    src, dst, mask, n_p, n_q = _edges(case, seed=G)
    r = np.random.default_rng(G + 1)
    p = r.standard_normal((n_p, G)).astype(np.float32)
    q = r.standard_normal((n_q, G)).astype(np.float32)
    tp, tq, ts, td, tm = map(torch.as_tensor, (p, q, src, dst, mask))
    plan = SP.sddmm_plan(ts, td, n_p, n_q, G, 256, slab_bytes=400 * G,
                         slab_edges=1)
    order = plan["order"].long()
    out = torch.full((src.size,), float("nan"))
    for _, e0, e1 in _items(plan):
        ids = order[e0:e1]
        out[ids] = SP.sddmm_pallas_reference(tp, tq, ts[ids], td[ids],
                                             tm[ids])
    ref = SP.sddmm_pallas_reference(tp, tq, ts, td, tm)
    assert torch.equal(out, ref)
    got = SP.sddmm_pallas(tp, tq, src=ts, dst=td, mask=tm)
    assert torch.equal(got, ref)
    # f32 sums of G products in other orders: per edge within 1e-5 of
    # Σ|p||q| against JAX, 2e-5 for the kernel's order (chip_smoke.py)
    mag = (np.abs(p[src]) * np.abs(q[dst])).sum(1) * mask
    jref = np.asarray(jax_sddmm(*map(jnp.asarray, (p, q, src, dst, mask))))
    assert (np.abs(out.numpy() - jref) <= 1e-5 * mag).all()
    if G % 4 == 0:
        lane = _lane_scores(p[src], q[dst])
        assert (np.abs(lane * mask - ref.numpy()) <= 2e-5 * mag).all()
        # the batch sum's rounds give each edge the butterfly's bits
        perm = plan["order"].numpy()
        fold = _fold_scores(p[src[perm]], q[dst[perm]])
        assert np.array_equal(fold, lane[perm])


# --- #3: the strip's data movement, lane by lane -----------------------------

def _bits(x):
    """bf16 bits (int64) of x rounded to bf16, as a numpy array."""
    return (torch.as_tensor(x).to(torch.bfloat16).view(torch.int16)
            .numpy().astype(np.int64) & 0xFFFF)


def _pack(lo, hi):
    return lo | (hi << 16)


def _lane(L):
    return L >> 2, L & 3


def _a_pos(L, kc, i, e):
    """(row, column) of element e of A register i of k chunk kc (mma
    m16n8k16, row-major A) in lane L."""
    g, q = _lane(L)
    return g + 8 * (i & 1), 16 * kc + 8 * (i >> 1) + 2 * q + e


def _c_pos(L, nt, e):
    """(row, column) of element e of n8-tile nt's C fragment in lane L."""
    g, q = _lane(L)
    return g + 8 * (e >> 1), 8 * nt + 2 * q + (e & 1)


def _load_frags(x):
    """gru_cell_pipe.cu::load_frags on a strip [16, 128] f32: lane L's
    A registers [8][4] of bf16 pairs (lane 4g + q reads rows g and g + 8,
    columns 16kc + 8·(i >> 1) + 2q, + 1)."""
    b = _bits(x)
    f = np.zeros((32, 8, 4), np.int64)
    for L in range(32):
        g, q = _lane(L)
        for kc in range(8):
            for i in range(4):
                row = g + 8 * (i & 1)
                col = 16 * kc + 8 * (i >> 1) + 2 * q
                f[L, kc, i] = _pack(b[row, col], b[row, col + 1])
    return f


def _frags_matrix(f):
    """The [16, 128] bf16 bits that A fragments f hold, by the A layout."""
    m = np.full((16, 128), -1, np.int64)
    for L in range(32):
        for kc in range(8):
            for i in range(4):
                for e in range(2):
                    row, col = _a_pos(L, kc, i, e)
                    m[row, col] = (f[L, kc, i] >> (16 * e)) & 0xFFFF
    return m


def _bf16_value(bits):
    return (torch.as_tensor(bits.astype(np.int32).astype(np.int16))
            .view(torch.bfloat16).float().numpy().astype(np.float64))


def _panel_smem(w_a, u_zr, uh):
    """gru_pipe.cuh::load_panels: the six panels' bf16 bits as [6, 128 k,
    16 chunks, 8], row k's chunk c stored at chunk c ^ (k & 7)."""
    mats = [w_a[:, :D], u_zr[:, :D], w_a[:, D:2 * D], u_zr[:, D:],
            w_a[:, 2 * D:], uh]
    smem = np.zeros((6, 128, 16, 8), np.int64)
    for pn, m in enumerate(mats):
        b = _bits(m).reshape(128, 16, 8)
        for k in range(128):
            for c in range(16):
                smem[pn, k, c ^ (k & 7)] = b[k, c]
    return smem, mats


def _b_frags(smem, pn, kc, j):
    """strip_mma's ldmatrix.x4.trans for k chunk kc and column group j:
    lane l addresses row 16kc + (l & 15), chunk 2j + (l >> 4) (stored at
    that chunk ^ (row & 7)); matrix m is the rows lanes 8m .. 8m + 7
    address, and .trans gives lane 4g + q, from matrix m, its elements
    (2q, g) and (2q + 1, g).  Returns [32 lanes][4] bf16 pairs."""
    rows = []
    for l in range(32):
        k, ch = 16 * kc + (l & 15), 2 * j + (l >> 4)
        rows.append(smem[pn, k, ch ^ (k & 7)])
    b = np.zeros((32, 4), np.int64)
    for L in range(32):
        g, q = _lane(L)
        for m in range(4):
            mat = rows[8 * m:8 * m + 8]
            b[L, m] = _pack(mat[2 * q][g], mat[2 * q + 1][g])
    return b


def _store_group(p0, p1):
    """gru_pipe.cuh::store_group on one warp: lane L's pairs p0, p1 [32]
    → the 8 bytes (two bf16 pairs) each lane stores at column 4q of the
    16-column group."""
    w = np.zeros((32, 2), np.int64)
    for L in range(32):
        q = L & 3
        sx = L ^ 3
        x = p0[sx] if (sx & 3) >= 2 else p1[sx]
        sy = (L & ~3) | ((0x2031 >> (4 * q)) & 3)
        y = p0[sy] if sy & 1 else p1[sy]
        w[L, 0] = p0[L] if q == 0 else (x if q == 1 else y)
        w[L, 1] = p1[L] if q == 3 else (x if q == 2 else y)
    return w


def _cell_inputs(seed, N, amp=1.0):
    r = np.random.default_rng(seed)
    h = (r.random((N, D)) * 2 - 1).astype(np.float32)
    a = (r.standard_normal((N, D)) * amp).astype(np.float32)
    w_a, u_zr, uh = ((r.standard_normal((D, k * D)) * D ** -0.5)
                     .astype(np.float32) for k in (3, 2, 1))
    b3 = (r.standard_normal(3 * D) * 0.1).astype(np.float32)
    return h, a, w_a, b3, u_zr, uh


def _emulate_cell(h, a, w_a, b3, u_zr, uh):
    """#3's bf16 body strip by strip, lane by lane, with the plain
    version's arithmetic: returns (h', z, r, h̃) as f32 and bf16 bits."""
    bf = torch.bfloat16
    N = h.shape[0]
    th, ta = torch.as_tensor(h), torch.as_tensor(a)
    pa = G._mm(ta, torch.as_tensor(w_a), bf) + torch.as_tensor(b3)[None]
    ph = G._mm(th, torch.as_tensor(u_zr), bf)
    r_full = torch.sigmoid(pa[:, D:2 * D] + ph[:, D:]).numpy()
    z_full = torch.sigmoid(pa[:, :D] + ph[:, :D]).numpy()
    rh = np.full((N, D), -1, np.int64)
    r_out = np.full((N, D), -1, np.int64)
    for s in range(N // 16):
        rows = slice(16 * s, 16 * s + 16)
        for x, f in ((a, _load_frags(a[rows])), (h, _load_frags(h[rows]))):
            assert np.array_equal(_frags_matrix(f), _bits(x[rows]))
        rs, hs = r_full[rows], h[rows]
        rf = np.zeros((32, 8, 4), np.int64)
        for j in range(8):          # phase 1: rf[j][2t + hr], r's stores
            rp = np.zeros((2, 2, 32), np.int64)
            for L in range(32):
                for t in range(2):
                    for hr in range(2):
                        (r0, c0), (_, c1) = (_c_pos(L, 2 * j + t, 2 * hr),
                                             _c_pos(L, 2 * j + t,
                                                    2 * hr + 1))
                        v = _bits(rs[r0, [c0, c1]] * hs[r0, [c0, c1]])
                        rf[L, j, 2 * t + hr] = _pack(v[0], v[1])
                        u = _bits(rs[r0, [c0, c1]])
                        rp[hr, t, L] = _pack(u[0], u[1])
            for hr in range(2):
                w = _store_group(rp[hr, 0], rp[hr, 1])
                for L in range(32):
                    g, q = _lane(L)
                    for k in range(2):
                        for e in range(2):
                            r_out[16 * s + g + 8 * hr,
                                  16 * j + 4 * q + 2 * k + e] = (
                                w[L, k] >> (16 * e)) & 0xFFFF
        rh[rows] = _frags_matrix(rf)
    assert (rh >= 0).all() and (r_out >= 0).all()
    # the last product on the A fragments made from r's C fragments
    rh_v = torch.as_tensor(_bf16_value(rh)).float()
    ht = torch.tanh(pa[:, 2 * D:] + G._mm(rh_v, torch.as_tensor(uh), bf))
    hp = ((1.0 - torch.as_tensor(z_full)) * th
          + torch.as_tensor(z_full) * ht).numpy()
    # phase 2's stores: h' as 8-byte pairs at the C positions, z and h̃
    # through store_group
    ht = ht.numpy()
    out_h = np.full((N, D), np.nan, np.float32)
    z_out = np.full((N, D), -1, np.int64)
    t_out = np.full((N, D), -1, np.int64)
    for s in range(N // 16):
        for j in range(8):
            for hr in range(2):
                zp = np.zeros((2, 32), np.int64)
                tp = np.zeros((2, 32), np.int64)
                for L in range(32):
                    for t in range(2):
                        (r0, c0), (_, c1) = (_c_pos(L, 2 * j + t, 2 * hr),
                                             _c_pos(L, 2 * j + t,
                                                    2 * hr + 1))
                        row = 16 * s + r0
                        out_h[row, c0:c0 + 2] = hp[row, [c0, c1]]
                        u = _bits(z_full[row, [c0, c1]])
                        zp[t, L] = _pack(u[0], u[1])
                        u = _bits(ht[row, [c0, c1]])
                        tp[t, L] = _pack(u[0], u[1])
                for arr, pp in ((z_out, zp), (t_out, tp)):
                    w = _store_group(pp[0], pp[1])
                    for L in range(32):
                        g, q = _lane(L)
                        for k in range(2):
                            for e in range(2):
                                arr[16 * s + g + 8 * hr,
                                    16 * j + 4 * q + 2 * k + e] = (
                                    w[L, k] >> (16 * e)) & 0xFFFF
    assert not np.isnan(out_h).any()
    return out_h, z_out, r_out, t_out


@pytest.mark.parametrize("amp", [1.0, 40.0])
def test_gru_strip_emulation_matches_reference_and_jax(amp):
    """The emulated strips give gru_cell_fwd_reference's bits (|a| ~ 40:
    saturating gates), and the JAX kernel's values within the cell
    tolerance."""
    x = _cell_inputs(3, 128, amp)
    out_h, z, r, ht = _emulate_cell(*x)
    ref = G.gru_cell_fwd_reference(*map(torch.as_tensor, x),
                                   mdt=torch.bfloat16)
    assert np.array_equal(out_h.view(np.int32),
                          ref[0].numpy().view(np.int32))
    for got, rr in zip((z, r, ht), ref[1:]):
        assert np.array_equal(got, _bits(rr.float()))
    jref = GP.gru_cell_fwd(*map(jnp.asarray, x), mdt="bfloat16",
                           interpret=True)
    got = (out_h, *(_bf16_value(v) for v in (z, r, ht)))
    for g, j in zip(got, jref):
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(j, np.float32), rtol=1e-5,
                                   atol=BF16_ULP)


@pytest.mark.parametrize("pn", range(6))
def test_gru_strip_fragment_products(pn):
    """strip_mma's fragments: the A fragments of a strip (load_frags)
    times the B fragments read by ldmatrix.trans from the swizzled panel
    (load_panels), summed per C element over the 8 k chunks as the mma
    sums them, equal the matrix product of the bf16 values (f64 sums of
    exact products)."""
    h, a, w_a, b3, u_zr, uh = _cell_inputs(5, 16)
    smem, mats = _panel_smem(w_a, u_zr, uh)
    want = _bf16_value(_bits(a)) @ _bf16_value(_bits(mats[pn]))
    halves = lambda f: _bf16_value(np.stack([f & 0xFFFF, f >> 16], -1))
    af = halves(_load_frags(a))                     # [32, 8 kc, 4 i, 2]
    # C element (L, t, e) and k = kk of its chunk: A from lane 4·(row % 8)
    # + (kk % 8) // 2, register 2·(kk ≥ 8) + (row ≥ 8); B from lane 4·col +
    # (kk % 8) // 2, register 2t + (kk ≥ 8); both half kk & 1
    L, t, e, kk = np.meshgrid(np.arange(32), np.arange(2), np.arange(4),
                              np.arange(16), indexing="ij")
    row, col = (L >> 2) + 8 * (e >> 1), 2 * (L & 3) + (e & 1)
    la, ia = 4 * (row % 8) + (kk % 8) // 2, 2 * (kk >= 8) + (row >= 8)
    lb, ib = 4 * col + (kk % 8) // 2, 2 * t + (kk >= 8)
    got = np.full((16, D), np.nan)
    for j in range(8):
        acc = np.zeros((32, 2, 4))
        for kc in range(8):
            bv = halves(_b_frags(smem, pn, kc, j))  # [32, 4, 2]
            acc += (af[la, kc, ia, kk & 1] * bv[lb, ib, kk & 1]).sum(-1)
        for Li in range(32):
            for ti in range(2):
                for ei in range(4):
                    r_, c_ = _c_pos(Li, 2 * j + ti, ei)
                    got[r_, c_] = acc[Li, ti, ei]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# --- on the card -------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sddmm_first_body(p, q, src, dst, mask):
    from ggnn_tpu_torch.ops import _build
    out = torch.empty(src.shape[0], dtype=torch.float32, device=p.device)
    ptr = _build.ptr
    _build.launch(_build.library().ggnn_sddmm, "sddmm_pallas", p.device,
                  ptr(p), p.shape[0], ptr(q), q.shape[0], p.shape[1],
                  ptr(src), ptr(dst), ptr(mask), src.shape[0], ptr(out))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("G", [4, 64, 128])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_sddmm_blocked_on_card(case, G):
    """#17's blocked body against its plain version (2e-5·Σ|p||q| an
    edge), twice bit-equal, bit-equal to the first body and to a run on
    copies of the index arrays (its plan made anew)."""
    dev = _card()
    src, dst, mask, n_p, n_q = _edges(case, seed=G)
    r = np.random.default_rng(G + 1)
    p, q = (torch.tensor(r.standard_normal((n, G)).astype(np.float32),
                         device=dev) for n in (n_p, n_q))
    ts, td, tm = (torch.tensor(x, device=dev) for x in (src, dst, mask))
    for m in (None, tm):
        got = SP.sddmm_pallas(p, q, src=ts, dst=td, mask=m)
        assert torch.equal(got, SP.sddmm_pallas(p, q, src=ts, dst=td,
                                                mask=m))
        assert torch.equal(got, _sddmm_first_body(p, q, ts, td, m))
        assert torch.equal(got, SP.sddmm_pallas(p, q, src=ts.clone(),
                                                dst=td.clone(), mask=m))
        ref = SP.sddmm_pallas_reference(p, q, ts, td, m)
        mag = SP.sddmm_pallas_reference(p.abs(), q.abs(), ts, td,
                                        None if m is None else m.abs())
        assert ((got - ref).abs() <= 2e-5 * mag).all()


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [1.0, 40.0])
@pytest.mark.parametrize("n_blocks", [1, 131, 133])
def test_gru_cell_pipe_on_card(n_blocks, amp):
    """#3's bf16 body against its plain version within one bf16 ulp,
    twice bit-equal, and bit-equal to the first body (131 and 133 blocks:
    one fewer and one more than an H100's SMs)."""
    dev = _card()
    bf = torch.bfloat16
    x = [torch.tensor(v, device=dev)
         for v in _cell_inputs(n_blocks, 128 * n_blocks, amp)]
    got = G.gru_cell_fwd(*x, mdt=bf)
    again = G.gru_cell_fwd(*x, mdt=bf)
    h, a, w_a, b3, u_zr, uh = x
    first = [torch.empty_like(h)] + [torch.empty(h.shape, dtype=bf,
                                                 device=dev)
                                     for _ in range(3)]
    G.cell_launch("ggnn_gru_cell", h, a, w_a.to(bf), b3, u_zr.to(bf),
                  uh.to(bf), *first, bf)
    ref = G.gru_cell_fwd_reference(*x, mdt=bf)
    for o, o2, f, rr in zip(got, again, first, ref):
        assert torch.equal(o, o2) and torch.equal(o, f)
        assert o.dtype == rr.dtype
        assert (o.float() - rr.float()).abs().max().item() <= BF16_ULP
