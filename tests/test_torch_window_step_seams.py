"""The host-side logic and fragment layouts of the bf16 kernels #13
``window_step_gru`` (``csrc/window_step_fused.cuh``) and #14
``window_bwd_fused`` (``csrc/window_bwd_fused.cu``), against numpy
constructions.

The CUDA kernels multiply int8 count chunks as they lie in memory
(``csrc/window_pipe.cuh``): an int8 → bf16 conversion by integer
operations, a k order read from the count rows and matched by the storage
order of the window chunk's rows (``perm_bf16``), int8 B operands read by
ldmatrix.trans on byte pairs and two byte permutes (``perm_s8``), whose
n8-tiles are the even and odd columns of 16-column groups (``PAIR``).
Here each of those is emulated lane by lane, as the PTX instructions
define their fragments, and the emulated mma products must equal the
plain matrix products exactly (integer inputs).  The kernels' schedules
are emulated too: #13's scan of a block's tile list 256 entries at a time,
and #14's walk (window j outer, source block inner, one slab type per CTA
of a cluster) with its group size ``bwd_groups`` and its table
``bwd_walk``, on layouts built by the port's ``build_window_layout``.

Tests marked ``cuda`` hold both CUDA kernels to their plain versions at
the seams on the card with chip_smoke.py's criteria and layouts
(``step_seam_layouts``, ``window_bwd_seam_fuzz``).
"""

import os
import sys

import numpy as np
import pytest
import torch

from ggnn_tpu_torch.ops import window as W

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the CUDA helpers of window_pipe.cuh, in numpy ---------------------------

def _bf16(bits):
    """bf16 bit patterns (uint16 in uint32) → float32 values."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def s8pair_to_bf16(w):
    """(byte 0, byte 2) of each uint32 as two bf16 values, as the kernel's
    integer trick computes them (the subtraction is exact)."""
    w = np.asarray(w, np.uint32)
    m = (w & 0x007f007f) | 0x43004300
    s = (w & 0x00800080) | 0x43004300
    return (_bf16(m & 0xffff) - _bf16(s & 0xffff),
            _bf16(m >> 16) - _bf16(s >> 16))


def perm_bf16(k):
    return (k & ~15) | ((k & 1) << 3) | ((k & 15) >> 1)


def perm_s8(k):
    return (k & ~15) | ((k & 2) << 2) | ((k & 12) >> 1) | (k & 1)


def pair_col(ni, q, e):
    """Tile<8, true>::col within a warp's 64 columns."""
    return (ni >> 1) * 16 + 4 * q + 2 * (e & 1) + (ni & 1)


def _word(bytes4):
    b = np.asarray(bytes4, np.int64) & 0xff
    return int(b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24)


def _byte_perm(x, y, sel):
    src = [(x >> (8 * i)) & 0xff for i in range(4)] + \
        [(y >> (8 * i)) & 0xff for i in range(4)]
    return _word([src[(sel >> (4 * i)) & 0xf] for i in range(4)])


def _bytes(w):
    return np.array([(w >> (8 * i)) & 0xff for i in range(4)],
                    np.uint8).view(np.int8)


def _ldsm_trans_rows(Bs, rows, col_bytes):
    """ldmatrix .trans of one 8 × 8 b16 matrix whose row i is the 16 bytes
    Bs[rows[i], col_bytes : col_bytes + 16] (int8): lane L gets the b16
    elements (row 2(L % 4), col L / 4) and (row 2(L % 4) + 1, col L / 4)."""
    out = []
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        lo = Bs[rows[2 * q], col_bytes + 2 * g: col_bytes + 2 * g + 2]
        hi = Bs[rows[2 * q + 1], col_bytes + 2 * g: col_bytes + 2 * g + 2]
        out.append(_word(np.concatenate([lo, hi])))
    return out


def _mma(afrag, bfrag):
    """D[16 × 8] = A_frag · B_frag of one mma (float64)."""
    return afrag.astype(np.float64) @ bfrag.astype(np.float64)


# --- tests of the fragment layouts ------------------------------------------

@pytest.mark.parametrize("half", [0, 1])
def test_s8_to_bf16_is_exact(half):
    """Every int8 value, in either byte of a pair, converts exactly."""
    x = np.arange(-128, 128, dtype=np.int64)
    y = x[::-1]
    words = [_word([a, 0, b, 0] if half == 0 else [0, a, 0, b])
             for a, b in zip(x, y)]
    lo, hi = s8pair_to_bf16(np.array(words, np.uint32) >> (8 * half))
    np.testing.assert_array_equal(lo, x.astype(np.float32))
    np.testing.assert_array_equal(hi, y.astype(np.float32))


def test_perms_are_permutations_of_each_16_rows():
    k = np.arange(128)
    for perm in (perm_bf16, perm_s8):
        p = perm(k)
        assert sorted(p) == list(k)
        assert (p // 16 == k // 16).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_times_bf16_chunk_matches_product(seed):
    """#13's bf16 product (mma_counts_bf16): a lane's ldmatrix word of 4
    int8 counts becomes a0 = (k 4q, 4q + 2), a2 = (4q + 1, 4q + 3); the
    window chunk's rows stored at perm_bf16 and read by ldmatrix.trans at
    consecutive rows give the matching B fragments: one k32 step of a
    16 × 8 tile equals the plain product."""
    r = np.random.default_rng(seed)
    A = r.integers(-128, 128, (16, 32))
    B = r.integers(-50, 50, (32, 8)).astype(np.float32)
    Bs = np.zeros_like(B)
    Bs[perm_bf16(np.arange(32))] = B
    got = np.zeros((16, 8))
    for st in range(2):
        afrag = np.zeros((16, 16))
        bfrag = np.zeros((16, 8))
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for row in (g, g + 8):
                w = _word(A[row, 16 * st + 4 * q: 16 * st + 4 * q + 4])
                lo, hi = s8pair_to_bf16(np.array([w, w >> 8], np.uint32))
                afrag[row, 2 * q: 2 * q + 2] = lo[0], hi[0]      # a0 / a1
                afrag[row, 8 + 2 * q: 10 + 2 * q] = lo[1], hi[1]  # a2 / a3
            rows = 16 * st + np.arange(16)
            bfrag[2 * q, g], bfrag[2 * q + 1, g] = Bs[rows[2 * q], g], \
                Bs[rows[2 * q + 1], g]
            bfrag[8 + 2 * q, g], bfrag[9 + 2 * q, g] = \
                Bs[rows[8 + 2 * q], g], Bs[rows[9 + 2 * q], g]
        got += _mma(afrag, bfrag)
    np.testing.assert_array_equal(got, A @ B.astype(np.float64))


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_b_by_byte_permutes_matches_product(seed):
    """#13 q8 and #14 int8 (mma_s8_s8): B int8 [32 k][16 n] stored at
    perm_s8, ldmatrix.trans of its four 8-row matrices, byte permutes
    0x6420 / 0x7531: the even and odd n8-tiles (pair_col) of one k32 step
    equal the plain product, exactly in integers."""
    r = np.random.default_rng(seed)
    A = r.integers(-128, 128, (16, 32))
    B = r.integers(-128, 128, (32, 16)).astype(np.int8)
    Bs = np.zeros_like(B)
    Bs[perm_s8(np.arange(32))] = B
    regs = [_ldsm_trans_rows(Bs, np.arange(8 * m, 8 * m + 8), 0)
            for m in range(4)]
    afrag = np.zeros((16, 32))
    bfrag = {0: np.zeros((32, 8)), 1: np.zeros((32, 8))}
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for row in (g, g + 8):
            afrag[row, 4 * q: 4 * q + 4] = A[row, 4 * q: 4 * q + 4]
            afrag[row, 16 + 4 * q: 20 + 4 * q] = A[row, 16 + 4 * q:
                                                   20 + 4 * q]
        for odd, sel in ((0, 0x6420), (1, 0x7531)):
            b0 = _bytes(_byte_perm(regs[0][lane], regs[1][lane], sel))
            b1 = _bytes(_byte_perm(regs[2][lane], regs[3][lane], sel))
            bfrag[odd][4 * q: 4 * q + 4, g] = b0
            bfrag[odd][16 + 4 * q: 20 + 4 * q, g] = b1
    want = A.astype(np.float64) @ B.astype(np.float64)
    for odd in (0, 1):
        got = _mma(afrag, bfrag[odd])
        # n8-tile column c of the even / odd tile is column 2c / 2c + 1
        np.testing.assert_array_equal(got, want[:, odd::2])
        cols = [pair_col(odd, q, e) for q in range(4) for e in (0, 1)]
        assert cols == [2 * (2 * q + e) + odd for q in range(4)
                        for e in (0, 1)]


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_times_counts_matches_product(seed):
    """#14 exact (mma_bf16_counts): the count tile's rows as they lie,
    ldmatrix.trans on byte pairs, each word converted into the even and
    the odd column's B fragment: one k16 step equals the plain product."""
    r = np.random.default_rng(seed)
    A = r.integers(-40, 40, (16, 16)).astype(np.float32)
    C = r.integers(-128, 128, (16, 16)).astype(np.int8)
    regs = [_ldsm_trans_rows(C, np.arange(8 * m, 8 * m + 8), 0)
            for m in range(2)]
    bfrag = {0: np.zeros((16, 8)), 1: np.zeros((16, 8))}
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        for m in range(2):
            lo, hi = s8pair_to_bf16(np.array([regs[m][lane]], np.uint32))
            ev, od = s8pair_to_bf16(np.array([regs[m][lane] >> 8],
                                             np.uint32))
            bfrag[0][8 * m + 2 * q: 8 * m + 2 * q + 2, g] = lo[0], hi[0]
            bfrag[1][8 * m + 2 * q: 8 * m + 2 * q + 2, g] = ev[0], od[0]
    want = A.astype(np.float64) @ C.astype(np.float64)
    for odd in (0, 1):
        np.testing.assert_array_equal(_mma(A, bfrag[odd]), want[:, odd::2])


def test_pair_columns_cover_each_column_once():
    cols = sorted(pair_col(ni, q, e) for ni in range(8) for q in range(4)
                  for e in (0, 1))
    assert cols == list(range(64))


# --- tests of the schedules -------------------------------------------------

@pytest.mark.parametrize("n_src,slots", [(2048, 32), (2048, 33), (133, 132),
                                         (5, 132), (1, 1), (200, 7)])
def test_bwd_groups(n_src, slots):
    """#14's group size: every source block in exactly one group, at most
    ``slots`` groups, all but the last full."""
    group, n_groups = W.bwd_groups(n_src, slots)
    assert n_groups <= slots and (n_groups - 1) * group < n_src \
        <= n_groups * group
    owner = np.arange(n_src) // group
    assert owner.max() == n_groups - 1
    assert (np.bincount(owner)[:-1] == group).all()


def _community_edges(seed, N, E, T2, hub=0.3):
    r = np.random.default_rng(seed)
    dst = r.integers(0, N - 256, E)
    src = np.where(r.random(E) < 0.95,
                   (dst // 256) * 256 + r.integers(0, 256, E),
                   r.integers(0, N, E)) % N
    h = r.random(E) < hub
    src[h] = r.integers(0, 128, int(h.sum()))
    quiet = src // 128 == 3
    src[quiet] += 128
    return src, dst, r.integers(0, T2, E), np.ones(E, np.float32)


def _bwd_walk(a, n_src, W_, BR, T2, n_dst, n_c, slots):
    """#14's walk, as window_bwd_fused.cu's first_real / advance step
    through it: per cluster g and rank q the (window, tile, k-chunk)
    triples in order, and the slabs (b, t) whose ends it reaches."""
    S, wpb, nk = W_ // 128, T2 // (W_ // 128), BR // 128
    gs, gw, gc = a["gt_tile_start"], a["gt_win_of_tile"], a["gt_c_off"]
    group, n_groups = W.bwd_groups(n_src, slots)

    def real(tt):
        return 0 <= gw[tt] < n_dst and 0 <= gc[tt] < n_c

    visits, slabs = {}, {}
    for g in range(n_groups):
        b0, b1 = g * group, min(n_src, (g + 1) * group)

        def first_real(j, b, tt):
            while j < wpb:
                for t_ in range(tt, gs[b * wpb + j + 1]):
                    if real(t_):
                        return (j, b, t_, 0)
                b += 1
                if b == b1:
                    b, j = b0, j + 1
                if j < wpb:
                    tt = gs[b * wpb + j]
            return (wpb, b0, 0, 0)

        for q in range(S):
            seq, ends = [], []
            nxt = first_real(0, b0, gs[b0 * wpb])
            for j in range(wpb):
                for b in range(b0, b1):
                    while nxt[0] == j and nxt[1] == b:
                        cur = nxt
                        nxt = ((cur[0], cur[1], cur[2], cur[3] + 1)
                               if cur[3] + 1 < nk else
                               first_real(cur[0], cur[1], cur[2] + 1))
                        seq.append((b * wpb + j, cur[2], cur[3]))
                    ends.append((b, S * j + q))
            visits[g, q], slabs[g, q] = seq, ends
    return visits, slabs, n_groups


@pytest.mark.parametrize("W_,BR", [(128, 128), (256, 256), (512, 512),
                                   (512, 256)])
def test_bwd_walk_covers_every_tile_and_slab_once(W_, BR):
    """On a with_grad layout (a hub window, windows without a real tile,
    a block count that is not a multiple of the group): each CTA of a
    cluster visits every real backward tile of its group's windows once,
    k-chunk by k-chunk, in list order, and ends every (b, t) slab of its
    type once; over the grid each (b, t) once."""
    N, T2 = 128 * 44, 16
    lay = W.build_window_layout(*_community_edges(3, N, 16 * N, T2), N,
                                window=W_, block_rows=BR, n_message_types=T2,
                                row_major="block", min_edges_per_tile=16,
                                with_grad=True)
    assert lay.grad_meta[4]
    a = lay.arrays
    n_src, n_dst = N // 128, lay.n_blocks
    n_c = a["c_stream"].shape[0] // BR
    slots = 5
    assert n_src % W.bwd_groups(n_src, slots)[0]
    visits, slabs, n_groups = _bwd_walk(a, n_src, W_, BR, T2, n_dst, n_c,
                                        slots)
    S, wpb = W_ // 128, T2 // (W_ // 128)
    group = W.bwd_groups(n_src, slots)[0]
    gs, gw = a["gt_tile_start"], a["gt_win_of_tile"]
    for (g, q), seq in visits.items():
        b0, b1 = g * group, min(n_src, (g + 1) * group)
        want = [(b * wpb + j, tt, kc) for j in range(wpb)
                for b in range(b0, b1)
                for tt in range(gs[b * wpb + j], gs[b * wpb + j + 1])
                if 0 <= gw[tt] < n_dst for kc in range(BR // 128)]
        assert seq == want
    every = sorted(s for v in slabs.values() for s in v)
    assert every == [(b, t) for b in range(n_src) for t in range(T2)]
    assert n_groups * S == len(visits)
    win = np.repeat(np.arange(len(gs) - 1), np.diff(gs))
    real = np.bincount(win[gw >= 0], minlength=len(gs) - 1)
    assert (real == 0).any() and real.max() > 8


@pytest.mark.parametrize("W_,BR", [(128, 128), (256, 256), (512, 512),
                                   (512, 256)])
def test_bwd_walk_table_matches_the_walk(W_, BR):
    """``bwd_walk``, the table #14's CTAs read their real tiles from: per
    group, the rows (dst block, stream tile, window) of the walk above in
    its order, each group's first row in ``goff``."""
    N, T2 = 128 * 44, 16
    lay = W.build_window_layout(*_community_edges(4, N, 16 * N, T2), N,
                                window=W_, block_rows=BR, n_message_types=T2,
                                row_major="block", min_edges_per_tile=16,
                                with_grad=True)
    a = lay.arrays
    n_src, n_dst = N // 128, lay.n_blocks
    n_c = a["c_stream"].shape[0] // BR
    slots = 5
    group, n_groups = W.bwd_groups(n_src, slots)
    walk, goff = W.bwd_walk(*(torch.as_tensor(a[k]) for k in (
        "gt_tile_start", "gt_win_of_tile", "gt_c_off")),
        int(a["gt_tile_start"][-1]), n_dst, n_c, T2 * 128 // W_, group,
        n_groups)
    visits, _, _ = _bwd_walk(a, n_src, W_, BR, T2, n_dst, n_c, slots)
    gw, gc = a["gt_win_of_tile"], a["gt_c_off"]
    assert walk.dtype == torch.int32 and goff.tolist()[0] == 0
    for g in range(n_groups):
        want = [[int(gw[tt]), int(gc[tt]), w, 0]
                for w, tt, kc in visits[g, 0] if kc == 0]
        assert walk[goff[g]:goff[g + 1]].tolist() == want


def test_walk_table_is_made_once_per_layout():
    """#14's wrapper keeps a layout's walk table while the layout's arrays
    live (``cached_per_tensor``): one table per (arrays, group size), none
    after the arrays are gone."""
    made = []

    def make(tag):
        made.append(tag)
        return tag

    a, b = torch.zeros(5, dtype=torch.int32), torch.zeros(5, dtype=torch.int32)
    assert W.cached_per_tensor(a, (2,), lambda: make("a2")) == "a2"
    assert W.cached_per_tensor(a, (2,), lambda: make("again")) == "a2"
    assert W.cached_per_tensor(a, (3,), lambda: make("a3")) == "a3"
    assert W.cached_per_tensor(b, (2,), lambda: make("b2")) == "b2"
    assert made == ["a2", "a3", "b2"]
    n = len(W._BWD_WALKS)
    del a
    assert len(W._BWD_WALKS) == n - 1


def test_step_tile_scan_keeps_list_order():
    """#13's scan of a block's tile list, 256 entries at a time, keeps
    the real tiles (win ≥ 0, stream entry in range) in list order, over a
    block of more than 256 real tiles with dummies and padding between."""
    r = np.random.default_rng(5)
    n = 1500
    win = np.where(r.random(n) < 0.7, r.integers(0, 50, n), -1)
    c_off = np.where(r.random(n) < 0.05, 10 ** 6, np.arange(n))
    n_c = 2000
    t0, t1 = 37, 1400
    got, scan = [], t0
    while scan < t1:
        tc = scan + np.arange(256)
        real = (tc < t1) & (win[np.minimum(tc, n - 1)] >= 0) & \
            (c_off[np.minimum(tc, n - 1)] < n_c)
        m = real.reshape(8, 32)
        before = np.concatenate([[0], np.cumsum(m.sum(1))[:-1]])
        lst = np.full(int(real.sum()), -1)
        for w_ in range(8):
            for lane in np.nonzero(m[w_])[0]:
                lst[before[w_] + m[w_, :lane].sum()] = tc[32 * w_ + lane]
        got += list(lst)
        scan += 256
    want = [t for t in range(t0, t1) if win[t] >= 0 and c_off[t] < n_c]
    assert got == want and len(want) > 256


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    sys.path.insert(0, ROOT)
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    return chip_smoke


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 8, 128])
def test_window_step_seams_on_card(D):
    """#13's kernels against their plain version on chip_smoke's seam
    layouts (W 128/256/512, 128-/256-/512-row blocks, a block of more than
    256 real tiles, blocks without a tile), table, q8 and on-demand, with
    and without emit_res, bf16 and f32: chip_smoke.check_step_case."""
    cs = _card()
    gen = torch.Generator(device="cuda").manual_seed(27)
    for tag, lay in cs.step_seam_layouts():
        lay = lay.to("cuda")
        for dtype in (torch.bfloat16, torch.float32):
            srcs = (("on-demand",) if lay.on_demand else ("table", "q8")
                    if D == 128 and dtype == torch.bfloat16 else ("table",))
            for src in srcs:
                for emit_res in (False,) if src == "q8" else (False, True):
                    cs.check_step_case(tag, lay, src, D, dtype, emit_res,
                                       gen, {})


@pytest.mark.cuda
def test_window_bwd_seams_on_card():
    """#14 against its plain version on chip_smoke's seam layouts (S = 1,
    2, 4, a block count that is not a multiple of the group, a hub window,
    empty windows, int8 scales that differ by block), D = 128, 256, 384,
    exact and int8 ā, bf16 and f32: chip_smoke.window_bwd_seam_fuzz."""
    _card().window_bwd_seam_fuzz({})


@pytest.mark.cuda
def test_window_bwd_fused_syncs_once_per_layout_on_card():
    """#14's wrapper checks a layout's tiles against its arguments once
    (``cached_per_tensor``, as its walk table): a later launch on the same
    layout makes no host sync, as in every backward of a window train
    step.  The layout is the 1m_train_window cell's at 2,048 nodes (W 512,
    block_rows 256, on-demand, the XW spill)."""
    cs = _card()
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    b = synthetic_batch(2048, 8000, 4, seed=0, node_mult=256,
                        n_communities=16, p_intra=0.95)
    lay = W.build_window_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        window=512, n_message_types=8, block_rows=256, typed_spill=True,
        on_demand=True, row_major="block", with_grad=True).to("cuda")
    forms, gt, w, h, kw = cs.bwd_inputs(lay, torch.bfloat16, 48)
    args = (forms["exact"][0], *gt, w, h)
    first = W.window_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = W.window_bwd_fused(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for x, y in zip(first, again):
        assert torch.equal(x, y)
