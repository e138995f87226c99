#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ggnn_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds the CUDA kernels from ``ggnn_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card, at the
   headline shapes (262,144 nodes, 4M logical / 8M directed edges, 8 edge
   types, D = 128) in bf16 and f32 and on four small fuzz layouts built
   with their grad half (one with empty dst blocks, one with cmax >= 2,
   one with B_g % 8 != 0 and empty grad blocks, one with C >= 2 grad
   chunks), and times kernel and plain version at the headline in bf16
   with CUDA events (plain, kernel, kernel, plain); each scatter kernel
   must also give the same bits in a second run (no atomics).  The
   forward kernels:
   ``typed_block_scatter``, ``typed_block_step_gru``, ``gru_cell_fwd``; the
   backward kernels: ``gru_cell_bwd`` and ``typed_grad_octet_scatter``.
   In bf16 #1 is held per element (``ops/bounds.py::block_bound``) and
   #2 also to the GRU cell of init plus #1's plain sums; then the bf16
   slot pipeline of #1, #2, #6 and #7 at its seams (``typed_seam_fuzz``: real-row prefixes of
   1 to 256 rows at tile_e 256 and 144, a block without a slot, a hub of
   two work items with type changes inside them, a slot list of 288; D =
   64, 128, 256), twice bit-equal, and #7 = #1 and #6 = #2 bit for bit on
   the blocks of one work item of the same edges; then #4 at the seams of
   its bf16 kernel (``gru_bwd_seam_fuzz``: 1, 17, 33 and SMs + 1 blocks of
   128 rows, da in f32 and bf16; f32 at 1 and 17), each of its six
   outputs twice bit-equal, as at every layout; then #3 at the seams of
   its bf16 kernel (``gru_cell_seam_fuzz``: 1, SMs − 1 and SMs + 1 blocks
   of 128 rows, |a| ~ 1 and saturating gates at |a| ~ 40), as at every
   layout in bf16 also bit-equal to the first body (``gru_cell.cu``).
3. Serves: a ``Predictor`` for the headline model (node_select head,
   onehot backend, bf16, T = 5 steps, random weights from seed 0) answers
   one request of a 262,144-node graph (seed 0; ``SERVE_REQUESTS``),
   fused and unfused.  It checks the kernels' launch
   counts on that path and holds every request's node scores against the
   port's plain path on the card.
4. Trains the headline model (the same configuration, typed layout built
   ``with_grad=True``, node_select loss on a target node from seed 0,
   ``torch.optim.Adam(1e-3)`` over every parameter) for 3 steps through
   ``make_train_step``, fused, fused with lean residuals, and unfused.  It
   checks the launch counts per step, holds the first step's loss and every
   gradient leaf against the same step through the kernels' plain versions
   on the card, and prints step times, peak device memory and the host
   time of the layout.
5. Runs the ``Trainer`` CLI on bAbI task 4 (``--device cuda``) for a few
   epochs and checks its loss is finite; beside it, at once, the CLI with
   ``--backend onehot`` (phase 9).
6. The legacy table-gather path (``ops/legacy.py``) of the same headline
   model on the same uniform batch.  ``[legacy kernels]``:
   ``node_table_block_major`` (#10), ``onehot_segment_scatter_flat`` (#8)
   and ``onehot_segment_scatter`` (#9) against their plain versions, each
   twice (bit-equal), per element, on fuzz layouts (empty blocks, the
   all-padding tail of ``pad_tiles_to``, tile_e 128 and 2048, D = 4 and
   128, f32 and bf16; #10 also at the seams of its persistent schedule:
   one source block and 150, T2 = 1, 3 and 16, D = 4 to 384), the bf16
   pipeline of #11 and #8 (``csrc/window_mono_fused.cu``) at its seams
   (``mono_seam_fuzz``: #11's dst-local, count and 256/512-row count
   forms, f32 and bf16 out, #8 at tile_e 128 and 2048, #9; a hub block
   of many work items, a hub tile, padding tails, all-padding and dummy
   tiles, a ``c_off`` permutation, empty blocks exactly 0) and on
   ``layout_for_batch`` of the headline (64,548
   forward tiles, 95,268 grad tiles; timed), with
   ``window_block_spmm_mono`` (#11) on its grad half, and #11 at D = 4, 6,
   8, 16, 128 and 200 on a hub layout.  ``[legacy serve]``: one
   request through ``Predictor``'s own layout with a fuse request (it
   warns and runs unfused: #10, #8 and the GRU cell per step).
   ``[legacy train]``: 3 unfused Adam steps on
   ``layout_for_batch(with_grad=True)`` (#10, #8, #11, #3, #4 per step),
   the first against the plain path, and one forward on the bench's
   ``--legacy_pack`` layout (#10 and #11 at window 2048).
   ``[no_stream]``: one step without a one-hot stream (#9 forward and
   backward).
7. ``[scalefree]``: the same headline model on a power-law graph of the
   same size (Zipf 1.2 endpoints, nodes numbered by degree rank, made by
   the port's ``synthetic_batch``), where block mode and the octet grad
   layout decline and the per-tile kernels carry the graph.  It holds
   ``typed_onehot_scatter``, ``typed_step_gru`` and
   ``window_block_spmm_mono`` against their plain versions there and on
   five fuzz layouts (uniform with block mode off, span mode, a small
   chunk cap, empty blocks, a hub, the hub again with |a| ≤ 1), per
   element, and each against a second run of itself (bit-equal), times
   them, serves one request fused and unfused (each step against the
   plain step) and trains 3 Adam steps fused and unfused, with the launch
   counts, the first step's loss against the plain path and the
   aggregation's VJP against its plain version (dh per row off the hub);
   then #8, #9 and #10 on the graph's ``layout_for_batch`` (its hub block
   holds about 44K tiles).  #6's bf16 kernel is held on the fuzz layouts
   (tile_e 16 to 256) and the headline against its plain version and the
   GRU cell of init plus #7's f64 plain sums, and at the headline again
   with |a| ≤ 1 (8 ulps a row, the hub's split blocks included).
   ``[scalefree window]``: the request of the same graph through
   ``run_batch`` unfused on bench.py's scalefree_fwd_window layout (W 512,
   block_rows 128, on-demand, the XW spill; dst block 0 holds about 3.5K
   of its 9K real tiles), built by the request's layout function (#12, the
   spill's #11 and the GRU cell per step), each step against the plain
   step; then on that layout #12 against its plain version, twice
   bit-equal, its work items printed, timed with its bound.
8. ``[chunked 1M]``: the reference's large-graph configuration
   (1,048,576 nodes, 10M logical edges, the headline model) through
   ``build_chunked_dst_layouts(n_chunks=4, tile_e=2048)``: one forward
   through ``propagate`` (20 launches of #8), then every step against the
   plain step from the same state.
9. The ``Trainer`` CLI with ``--backend onehot`` (the legacy layout of
   ``layout_for_batch``; at D = 4 it launches #8 and #11), run with phase
   5's.
10. The window backend (``ops/window.py``, ``ops/window_step.py``) on
   community graphs (bench.py:457-523: nodes in communities of 512, each
   edge inside its community with probability 0.95).  ``[window
   kernels]``: #11 (int8 and int4 counts, 128-, 256- and 512-row blocks),
   #12 ``window_block_spmm_ondemand``, #13 ``window_step_gru`` (bf16/f32
   table, q8, on-demand; with and without init) and #15
   ``node_table_block_major_q8`` against their plain versions, each twice
   (bit-equal), on fuzz layouts (W 128/256/512 with block_rows
   128/256/512, a block without a real tile, ``pad_tiles_to`` padding,
   dummy-first blocks; f32 and bf16), #13 at the seams of its bf16 kernel
   (``window_step_seam_fuzz``: clusters of 1, 2, 4 CTAs, 1, 2, 4 chunks a
   window, a block of more than 256 real tiles, blocks without one, D =
   4, 8, 128, emit_res and q8), #12 at the seams of its bf16 kernel
   (``ondemand_seam_fuzz``: clusters of 1, 2, 4 CTAs, 1, 2, 4 chunks a
   window, a hub block cut into many work items, a one-tile block, empty
   blocks, D = 4 and 128), #15 at the seams of its bf16 kernels
   (``q8_table_seam_fuzz``: windows of 1, 2, 4, 16 types at T2 = 16 and
   of 1, 3 at T2 = 3, 133 source blocks, an all-zero block with a zero
   bias: scale 2**-100, q 0) and on the community headline's two
   bench layouts (262,144 nodes, 8M directed edges, W 512, block_rows 512,
   the XW spill: on-demand, and the q8 record's table), timed.  ``[window
   serve]``: one request through the window ``Predictor`` (its own
   ``window_layout_for_batch``, fused), then the bench's window_community
   (on-demand) and window_community_q8 layouts through ``run_batch`` fused,
   and each unfused, with launch counts and scores against the plain path.
   ``[window 1m]``: bench.py's window_community_1m (1,000,192 nodes, 20M
   directed edges, a bf16 table, the legacy spill, block_rows 256): one
   5-step fused forward, then each step against the plain step.
   ``[1m train]``: the reference's two single-device training
   configurations at 1M nodes (tests/test_perf_thresholds.py:65-69 and
   :87-89), nothing cut, both under ``remat``: 1m_train_window (the same
   graph, its layout built ``with_grad``, block_rows 256, W 512, on-demand
   windows, the XW spill, the fused step: per step #13 ``emit_res`` and
   the spill's #11 2T, #4, #14 and the spill backward's #11 T) and
   1m_uniform_train_onehot (1,000,064 nodes, the typed pack fused: #1 2T,
   #5 T).  For each the batch's and the layout's host seconds, its copy
   and stats, 3 Adam steps (step ms, peak device memory, the launch
   counts per step), the first held to the plain path on the card
   (``TOL_TRAIN``; the plain path's f64 sums fit beside the layout: about
   50 GiB at its peak).
11. ``[window train]``: the window backend's training path.  #14
   ``window_bwd_fused`` (exact and int8 ā) and #13's ``emit_res`` form
   against their plain versions, each twice (bit-equal), on fuzz layouts
   built ``with_grad`` (dummy-first and empty windows, a hub window, W and
   block_rows 128 to 512, on-demand, f32 and bf16) and the Y path where
   the fused backward does not apply (odd T2, 'src' rows at W 192 and
   512, int4 transposed counts: #11 on ``ct_stream``), #14 at the seams of
   its bf16 kernel (``window_bwd_seam_fuzz``: S = 1, 2, 4, a block count
   that is not a multiple of the group, per-block int8 scales, D = 128,
   256, 384); then bench.py's
   window_community_train and window_community_train_q8g (the community
   headline, its layout built ``with_grad``, on-demand, the XW spill): #14
   and #13 ``emit_res`` timed, #11 on the spill both ways timed with its
   bound (``time_spill_mono``), the unfused aggregation's VJP against the
   plain path, and 3 Adam steps through ``make_train_step`` (launch
   counts, the first step against the plain path, step times, peak
   memory, the layout's host seconds); #3, #4, #13, #14 and #15 timed at
   D = 256 on that layout (``TIMED_WIDTHS``).
12. ``[widths]``: every kernel at D = 4, 8, 16 (zero-padded to the D = 128
   kernels), 128, 200 (padded to 256), 256, 320 (padded to 384), 384 and
   512 (``WIDE_DIMS``; no kernel caps D) against its plain version, twice
   bit-equal, #14 (exact and int8 ā) among them; one fused window train
   step at D = 256 (#13 emit_res, the wide #4, #14) against the plain path;
   and the reference's ``test_predictor_backends_agree`` at D = 8: xla,
   onehot and window (fused and unfused) Predictors predict alike.
13. The ``pallas`` backend and the SDDMM edge gates (``ops/spmm.py``), run
   after phase 6 on its uniform headline batch.  ``[pallas kernels]``: #16
   ``packed_messages`` and #17 ``sddmm_pallas`` against their plain
   versions, per element and twice bit-equal, on fuzz layouts (tile_e 8,
   32, 128; empty types; a type ending on a tile boundary; holes and
   all-padding tail tiles; a hub; f32 and bf16; #16 at D = 4 to 384, #17
   at G = 5, 64, 128 with E not a multiple of 128 and on the fuzz
   layouts' packed src and dst; #16 also at the seams of its persistent
   schedule: an unsorted tile_type, type runs inside one CTA's range and
   across two, a single tile, one type, all-padding tiles between real
   ones; #17 at the seams of its plan, ``sddmm_seam_fuzz``: a dst hub
   past three work items, empty dst blocks, one edge, a src hub), #17
   with both index arrays also bit-equal to its first body (``sddmm.cu``)
   and to a run on copies of the arrays (its plan made anew), then at the
   headline's packed layout (bench.py --backend pallas: 62,516 tiles of
   128), timed, with #17's plan on a new layout.
   ``[pallas serve]``: two requests through ``Predictor(backend=
   'pallas')``, ungated and gated, then the headline batch through
   ``run_batch`` (launch counts, device ms, peak memory, each step against
   the plain step).  ``[pallas train]``: 3 Adam steps ungated and gated,
   the first against the plain path.  Then the ``Trainer`` CLI with
   ``--backend pallas`` (it must launch #16).
14. ``[variants]``, on the same uniform batch: #18
   ``onehot_segment_scatter_stream``, #19 ``onehot_segment_scatter_loopT``
   and #20 ``window_block_spmm``, which only the reference's kernel-variant
   sweeps and tests run.  Fuzz: #18 and #19 on the JAX variant test's
   layout (tile_e 8), at tile_e 128 and 2048 with empty dst blocks and on
   a hub block of several hundred tiles (#19's hub row split into
   partials); #20 at W 64, and W 256 and 512 with dummy tiles, a compact
   count stream and a block without tiles; D = 1 to 384, f32 and bf16,
   per element and twice bit-equal; #18 raises below a block's tile
   count; #18 and #19 on a signed stream that is not one-hot (2, −3, 127,
   −128, −1); #19's seams (:func:`loopT_seam_fuzz`: tile_start ending
   before the stream, 4- and 8-byte plan entries); #20's plan seams (a
   hub row cut into several work items, signed counts, W 64, 256 and
   512).  Then the main path: the two sweeps of
   ``scripts/torch_scatter_variants.py`` (tile_e 2048: flat #8, stream
   #18, loopT #19, mono #11) and ``scripts/torch_window_variants.py`` (the
   probe's community graph, W 512: #11, #20, ``aggregate_window``),
   imported, their launches counted; on their layouts and inputs each
   variant against the plain version (#18 and #19 also in f32), and #18,
   #19 and #20 timed (#19 and #20 against their plans' bounds, the dense
   stream's printed beside them; #18 and #19 also in f32, beside one f32
   ``index_add_``), #18, #19 and #20 also on a new layout (their checks
   and plans included), and #11's window form beside #20.
   ``[segment rows]``, on the same batch: the port's fixed-order segment
   sum (``segment_rows_sum``, ``csrc/segment_rows.cu``; no TPU kernel
   behind it: the JAX package's ``jax.ops.segment_sum``) at the xla
   headline's shapes (f32 messages [8M, 128] summed by edge_dst) and on
   the pallas layout's packed messages (TypedTiled's forward sum),
   against its plain version per element, twice bit-equal, timed beside
   the f32 ``index_add_`` it replaces and its plan on a new index tensor;
   then at its seams (empty rows, padding and negative ids, one row of
   1,000,192 entries in f64 and f32, n_rows 262,147, Zipf hubs; D = 1, 2,
   7, 128, 130).  ``[reproducible]``: each case twice from the same state,
   every output, loss, gradient leaf and Adam moment bit-equal: one
   headline request through xla, gated pallas and the graph_gated head,
   the GGS-NN cell's 64 graphs through pallas, one train step through xla
   and through gated pallas, and the bAbI 4 Trainer on the card (3
   epochs, save, 3 more; restored, 3 more: the same leaves and Adam state
   as the uninterrupted run); the sharded halo requests (node_select,
   graph_gated) run in the ranks of phase 15.  ``[oracle]``: the port's
   NumPy oracle (``ggnn_tpu_torch/oracle``) in f64 on the host against the
   card's per-step states and head outputs on every backend through its
   kernels (xla, pallas with and without the gates, the typed pack in
   block mode and per tile, the legacy layout, the window table, on-demand
   and q8), f32 and bf16, every head, GGS-NN's K rounds, on fuzz graphs
   (self loops, duplicate edges, empty types, isolated nodes) and a graph
   of 4,096 nodes with a hub.

15. The parallel layer (``ggnn_tpu_torch/parallel``), after ``[ggsnn
   train]``: the single-device references on the card first ('xla' with
   the sharded path's f32 GRU matmul inputs; the GGS-NN cell's typed pack
   fused for [ddp]), then two ranks spawned on cuda:0 over gloo (NCCL
   takes one rank per device; CUDA tensors staged through pinned host
   buffers), each building the partition and every shard's layouts as
   the reference's host does.  ``[sharded serve]``: the uniform headline
   through all_gather, halo, halo_overlap and halo_onehot (#11), the
   community headline through halo_window fused on the bf16 table (#10,
   #13, the XW spill's #11), on-demand and unfused (#10, #11), and q8
   serving (#15); each against single-device ``propagate``
   (``TOL_SHARDED``), halo and halo_overlap against all_gather and
   on-demand against the table at the [serve] tolerance, q8 against the
   exact step; the exchange timed alone.  ``[overlap]``: one halo_overlap
   and one unfused halo_window forward traced on each rank
   (``profiling.trace``), rank 1 holding each all-to-all back
   ``OVERLAP_HOLD_S`` before it issues it (the ranks meet at a barrier
   just before each issue, so the hold counts from a common start, and
   Python's cyclic collector is off during the trace): in every step
   rank 0's local
   aggregation's kernels must all end at least half the hold before its
   wait for the exchange (``halo/wait``) returns; in ``[sharded train]``
   its mirror: one traced node_select train step through halo_overlap
   and one through fused halo_window (on-demand), rank 1 holding each
   reverse all-to-all back as long: in every step with a reverse
   exchange rank 0's local backward kernels (launched between the
   reverse issue and ``halo/bwd_wait``: the local typed aggregation's
   backward; #14 and the spill backward) must end as long before that
   wait returns.
   ``[reproducible] sharded``: one halo request of the uniform headline
   with the node_select and the graph_gated head (propagation, head and
   loss with cross-rank collectives), each twice, bit-equal on each rank.
   ``[sharded train]``: one node_select task step each through halo_onehot
   and halo_window (on-demand, exact and int8 gradients), the loss, every
   gradient leaf and the updated parameters against the single-device
   step, the parameters bit-equal on both ranks.  ``[sharded ggsnn]``: one
   GGS-NN task step on the [ggsnn *] cell (64 graphs of 4,096 nodes, K = 3)
   through halo; ``[ddp]``: one data-parallel step on its 64 graphs (32 a
   rank, each with its typed pack, #1 and #5).  ``[sharded nccl]``: a
   world of one rank on NCCL in this process (the asynchronous exchange
   on NCCL's stream), one halo and one halo_overlap propagate and one
   task step.  Each rank's launches, step ms, error and peak memory are
   printed; two ranks on one card give no scaling number.  ``[scaling]``:
   ``bench_scaling_gpu.py`` through ``torch.distributed.run``, at its
   defaults on one rank (halo_overlap), then on two ranks sharing the card
   (``--shards 1 2 --iters 2``): the reference's JSON keys, P = 1's
   efficiency 1.0.
16. The edges, after the sharded phases and ``[native]``.
   ``[profile]``: the Trainer CLI with ``--backend onehot --profile DIR``
   (a child process, beside the two bAbI 19 CLIs, ``BABI19_RUNS``); the
   trace must name the device kernels that #8's
   and #11's wrappers launch on that path (a probe runs each alone on the
   CLI's first batch under ``torch.profiler``); the five ops of the most
   device time are printed.  ``[examples]``: ``examples/torch_large_graph.
   py`` at its defaults (the headline's size) in its three forms (one
   legacy layout, 4 chunks, a window layout over 512 communities), the
   launches of its two forwards, its checksum, final h and first step's h
   against the plain path ('flip'); then ``examples/torch_custom_task.py``
   (``CUSTOM_TASK_EPOCHS``).
   ``[distributed example]``: the distributed example's body on two ranks
   on cuda:0 over gloo at the community headline's scale
   (``DIST_EXAMPLE_ITERS`` train iterations, then q8 serving under
   ``torch.no_grad``: finite losses and h, the parameters bit-equal on the
   ranks, no ``emit_res`` launch while serving).  ``[dryrun]``:
   ``ggnn_tpu_torch.dryrun.entry("cuda")`` against its plain run, then
   ``dryrun_multichip(2)`` and ``(3)`` and the distributed example's entry
   (``torch.distributed.run --nproc_per_node 2`` at its default size),
   all three at once (the spawned ranks' launches are not counted).

The typed-pack phases (2-4, 7) hand ``Predictor.run_batch`` the typed pack
they build; the Predictor's own layout is the legacy one (phase 6).

Any failed check raises, so the exit code is non-zero.  The last three
lines are the kernels JSON (22 kernels; each kernel's launches on
the main paths, its largest error against its plain version, its time and
its plain version's, its bound from the bytes and operations of the timed
inputs at the card's published peaks, and the time of one PyTorch call computing
the same function where there is one), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np

NODES, EDGES, EDGE_TYPES, DIM, STEPS, ANN = 262_144, 4_000_000, 8, 128, 5, 8
ZIPF = 1.2             # the scale-free graph's power law
# The request seeds of the serving phases before [pallas serve], which
# serves two through one Predictor (one Predictor serving different graphs
# in a row stays checked there, its per-index plans included); the others
# serve one each, which keeps the whole run in its time budget.  [serve]
# served two (seeds 0 and 1) and [pallas serve] three until their last
# requests made room for [segment rows], [reproducible] and [oracle].
SERVE_REQUESTS = (0,)
EARLIER_REQUESTS = (0,)
BF16_ULP = 2.0 ** -7   # one bf16 ulp at 1.0

# Tolerances, checked against |kernel − plain| on the same inputs:
# - scatter (#1 in f32, csrc/typed_block.cu): the same one-hot sums, f32
#   W_t products summed in another order → max ≤ 2e-5·max(1, max|plain|);
#   #1 in bf16 (csrc/typed_block_fused.cu), whose tensor cores add a
#   k-step's 16 one-hot terms at once, so that a slot's f32 sum on a bf16
#   boundary may round to the other neighbour: per element ('bound',
#   ggnn_tpu_torch/ops/bounds.py::block_bound), 2e-5 of the plain version
#   on |h_pack| and |W| plus one bf16 ulp of every slot's rounded sum of
#   three or more terms, times |W_t| (a sum of one or two terms is the
#   same in every order), and the mean of |kernel − plain| / bound ≤ 0.1,
#   as #7 is held (ops/bounds.py::tile_bound);
# - GRU cell: the same rounded matmul inputs, f32 sums in another order;
#   outputs stored in bf16 may round to the neighbouring value → max ≤ one
#   bf16 ulp at 1.0 (f32: 1e-4);
# - fused step (#2) and served scores (bf16): a, the aggregation, is
#   rounded to bf16 before the gate matmuls, and a last-bit difference in
#   f32 can round it the other way, moving a gate by ulp(a)·|W| → max ≤ 8
#   ulps at 1.0 (6.25e-2) and mean ≤ 1e-3 (rare flips, not a wrong sum);
#   f32: 1e-4.  #2 in bf16 is also held per row ('flip_rows') to the GRU
#   cell of init plus #1's plain sums, as #6 is held to #7's;
# - reverse scatter (grad octet): the same f32 sums in another order →
#   f32 max ≤ 2e-5·max(1, max|plain|); flushed to bf16, a last-bit f32
#   difference can round a row to the neighbouring bf16 value → max ≤ one
#   bf16 ulp at the largest value, 2**-7·max(1, max|plain|);
# - GRU backward: every output is a sum over rows or features of products
#   of the same rounded inputs, in another order; in bf16 the gate
#   gradients are rounded before the products and a last-bit f32
#   difference can round one to its neighbour, moving one term by one bf16
#   ulp.  Such flips are rare and unsystematic, so each output's relative
#   Frobenius error stays far below one bf16 ulp: ≤ 2**-8 (bf16), 1e-5 (f32);
# - training, first step against the plain path on the same card, per
#   gradient leaf (relative Frobenius error) and for the loss:
#   f32 (fused; kernels 1 and 5 in their f32 form): the same math summed in
#   another order → every leaf ≤ 1e-4 and the loss within 1e-5 relative;
#   bf16 (the headline): every bf16 rounding point of 5 steps forward and
#   back can round a value to its neighbour, and the node_select softmax
#   passes those flips to every leaf.  Between two faithful versions with
#   the same rounding points (the JAX reference and the port's plain path,
#   this configuration at 4,096 nodes on the CPU) the spread is 3e-3 to
#   6.1e-3 on every leaf; the bound is 2**-6 (1.6e-2) per leaf and 1e-3 on
#   the loss.  A leaf whose gradient vanishes by the model's symmetry
#   (head/b2: shifting every node's score leaves the softmax unchanged, so
#   its gradient Σ_v p_v − 1 is 0 up to f32 rounding in either path; so is
#   out/b2, the bias of GGS-NN's node output, per graph and round) has
#   no scale of its own, so no relative error: both paths must give 0 up
#   to rounding, ≤ 1e-6 of the whole gradient's norm, as the CPU tests
#   hold it (tests/test_torch_train_model.py).
TOL_F32 = 1e-4
TOL_FLIP_MAX, TOL_FLIP_MEAN = 8 * BF16_ULP, 1e-3
TOL_RELF_BF16, TOL_RELF_F32 = 2.0 ** -8, 1e-5
TOL_TRAIN = {"bfloat16": (2.0 ** -6, 1e-3), "float32": (1e-4, 1e-5)}
SYMMETRIC_LEAVES, TOL_SYMMETRIC = ("head/b2", "out/b2"), 1e-6
# The per-tile kernels (#6, #7) and the window kernel (#11), which carry
# power-law graphs: a hub row sums up to 1.5M terms, so one tolerance
# scaled by the output's largest value would be as large as an ordinary
# row's whole value.  They are held per element instead ('bound'):
# - #7 and #11: |kernel − plain| ≤ 2e-5·Σ|terms| of that element (the plain
#   version on |inputs|: f32 sums in another order), plus in bf16 one ulp
#   of every rounded sum that may round the other way: for #7 each tile's
#   one-hot sum of three or more terms, times |W_t| (a sum of one or two
#   terms is the same in every order, so an ordinary row's tiles add
#   nothing), for #11 the flushed output itself, 2**-7·|plain|.  Two
#   faithful versions sit far inside it on average: the mean of |kernel −
#   plain| / bound must stay ≤ 0.1 as well, so a systematic error fails;
# - #6, the fused step, against its plain version: a hub row's |a| makes
#   the ulp of its bf16 rounding large, so each row within 8 bf16 ulps
#   times max(1, max|a_row|) ('flip_rows'); in bf16 (csrc/
#   typed_tile_fused.cu, whose tensor cores add a tile's one-hot terms in
#   another order than #7's segment sums) also against the GRU cell of
#   init plus #7's plain version (f64 sums), 'flip_rows' again; in f32
#   (typed_tile.cu, #7's body) exactly against the GRU cell kernel (#3)
#   applied to #7's sums plus init: the same sums and the same epilogue
#   code (common.cuh), so equal up to TOL_SAME, f32 rounding, in every
#   row, the hub's split blocks included; and on a fuzz layout whose
#   blocks split into several work items with |a| ≤ 1, where 'flip_rows'
#   is 8 ulps at every row;
# - the aggregation's VJP on the power-law graph: dh per row, over the
#   rows of at most HUB_TERMS terms (the hub rows' whole-tensor error hides
#   them): each row's relative error ≤ TOL_TRAIN and the rows' relative
#   Frobenius error ≤ TOL_RELF (rare flips of the bf16 flush).
TOL_BOUND_MEAN, TOL_SAME, HUB_TERMS = 0.1, 1e-6, 64
# - int8 gradients (window_community_train_q8g), the first step's gradient
#   leaves against the plain path: each path quantizes its own ā to 255
#   levels of its block's power-of-2 scale, and the two ā differ in the
#   last bits of their bf16 roundings, so some percent of the elements land
#   on the neighbouring level, one quantum (1/127 of the block's largest
#   |ā|) apart; over 5 steps these differences reach every leaf as the
#   quantization noise itself does.  The bound is 2**-4 per leaf (the loss,
#   computed before any quantization, keeps its 1e-3); #14's int8 form is
#   held per element on the same int8 ā in its own check.
TOL_Q8G = 2.0 ** -4
# - GGS-NN's first train step (K = 3 rounds of T = 5 steps, the annotation
#   BCE), per gradient leaf against the plain path: 15 chained bf16 steps
#   forward and back, and each graph's loss reads a gated sum over its
#   4,096 nodes, so the bf16 flips reach every leaf further than in the
#   5-step node_select step.  Between two faithful versions with the same
#   rounding points (the JAX package and the port on the xla backend, this
#   configuration on the CPU, tests/ggsnn_spread.py) the graph
#   output's leaves spread by 2.2e-4 to 6.7e-3 on one graph and 7.0e-4 to
#   2.4e-2 (median 1.7e-2) on 8 graphs, the node output's by up to 3.6e-3
#   on 8 (out/b2 aside, SYMMETRIC_LEAVES); the bound is 2**-4 per leaf
#   (the loss keeps its 1e-3).  On an H100 (700 W), at this check's 64
#   graphs, scripts/torch_ggsnn_tol_control.py reads the kernels' worst
#   leaf at 2.25e-2 and a step with one round of one net's gradient left
#   out at 0.36 or more on that net's leaves.
TOL_GGSNN = 2.0 ** -4

# The card's published peaks (NVIDIA H100 SXM data sheet, dense), for each
# kernel's bound: the larger of bytes / HBM rate and operations / the rate
# of their type.
HBM_BPS, BF16_FLOPS, F32_FLOPS, INT8_OPS = 3.35e12, 989e12, 67e12, 1979e12

KERNELS = {
    # name: (source, the TPU kernel body it replaces)
    "typed_block_scatter": ("ggnn_tpu_torch/ops/csrc/typed_block_fused.cu",
                            "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "typed_block_step_gru": ("ggnn_tpu_torch/ops/csrc/typed_block_fused.cu",
                             "ggnn_tpu/ops/scatter_pallas.py:1873"),
    "gru_cell_fwd": ("ggnn_tpu_torch/ops/csrc/gru_cell_pipe.cu",
                     "ggnn_tpu/ops/gru_pallas.py:41"),
    "gru_cell_bwd": ("ggnn_tpu_torch/ops/csrc/gru_cell_bwd_pipe.cu",
                     "ggnn_tpu/ops/gru_pallas.py:62"),
    "typed_grad_octet_scatter": ("ggnn_tpu_torch/ops/csrc/grad_octet.cu",
                                 "ggnn_tpu/ops/scatter_pallas.py:2120"),
    "typed_onehot_scatter": ("ggnn_tpu_torch/ops/csrc/typed_tile_fused.cu",
                             "ggnn_tpu/ops/scatter_pallas.py:1416"),
    "typed_step_gru": ("ggnn_tpu_torch/ops/csrc/typed_tile_fused.cu",
                       "ggnn_tpu/ops/scatter_pallas.py:1562"),
    "window_block_spmm_mono": (
        "ggnn_tpu_torch/ops/csrc/window_mono_fused.cu",
        "ggnn_tpu/ops/window_pallas.py:787"),
    "onehot_segment_scatter_flat": (
        "ggnn_tpu_torch/ops/csrc/window_mono_fused.cu",
        "ggnn_tpu/ops/scatter_pallas.py:618"),
    "onehot_segment_scatter": ("ggnn_tpu_torch/ops/csrc/window_mono_fused.cu",
                               "ggnn_tpu/ops/scatter_pallas.py:506"),
    "node_table_block_major": ("ggnn_tpu_torch/ops/csrc/node_table.cu",
                               "ggnn_tpu/ops/window_pallas.py:1499"),
    "window_block_spmm_ondemand": (
        "ggnn_tpu_torch/ops/csrc/window_ondemand_fused.cu",
        "ggnn_tpu/ops/window_pallas.py:1017"),
    "window_step_gru": (
        "ggnn_tpu_torch/ops/csrc/window_step_fused_ondemand.cu",
        "ggnn_tpu/ops/window_pallas.py:1666"),
    "node_table_block_major_q8": ("ggnn_tpu_torch/ops/csrc/node_table_q8.cu",
                                  "ggnn_tpu/ops/window_pallas.py:1555"),
    "window_step_gru[emit_res]": (
        "ggnn_tpu_torch/ops/csrc/window_step_fused_ondemand_res.cu",
        "ggnn_tpu/ops/window_pallas.py:1666"),
    "window_bwd_fused": ("ggnn_tpu_torch/ops/csrc/window_bwd_fused.cu",
                         "ggnn_tpu/ops/window_pallas.py:1204"),
    "packed_messages": ("ggnn_tpu_torch/ops/csrc/packed_messages.cu",
                        "ggnn_tpu/ops/spmm_pallas.py:82"),
    "sddmm_pallas": ("ggnn_tpu_torch/ops/csrc/sddmm_blocked.cu",
                     "ggnn_tpu/ops/spmm_pallas.py:129"),
    # bf16 at D = 128 (the sweep's form); f32, other D and tile_e % 16 != 0
    # run #19's gather, csrc/window_auto_gather.cu
    "onehot_segment_scatter_stream": (
        "ggnn_tpu_torch/ops/csrc/window_mono_fused.cu",
        "ggnn_tpu/ops/scatter_pallas.py:559"),
    "onehot_segment_scatter_loopT": (
        "ggnn_tpu_torch/ops/csrc/window_auto_gather.cu",
        "ggnn_tpu/ops/scatter_pallas.py:672"),
    "window_block_spmm": ("ggnn_tpu_torch/ops/csrc/window_auto_gather.cu",
                          "ggnn_tpu/ops/window_pallas.py:704"),
    # the port's fixed-order float segment sums; the JAX package sums them
    # with jax.ops.segment_sum (no Pallas kernel)
    "segment_rows_sum": ("ggnn_tpu_torch/ops/csrc/segment_rows.cu",
                         "ggnn_tpu/ops/segment.py:57"),
}
# Kernels of the port with no TPU kernel behind them: expect_counts holds
# them only where a path names them (they launch on every path that sums
# floats by segment: xla, pallas, the losses).
PORT_ONLY = ("segment_rows_sum",)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def errors(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), d.mean().item(), ref.float().abs().max().item()


def relfro(got, ref) -> float:
    """Relative Frobenius error ‖got − ref‖ / ‖ref‖."""
    return ((got.double() - ref.double()).norm()
            / ref.double().norm().clamp_min(1e-30)).item()


def check(name, got, ref, kind, dtype, log, a_rows=None, bound=None):
    """Compare; kind is 'sum' (scatter), 'cell' (GRU cell), 'flip',
    'flip_rows' (per row, scaled by ``a_rows`` = max(1, max|a_row|)),
    'flush' (reverse scatter), 'relfro' (GRU backward), 'bound' (per
    element, against the tensor ``bound``) or 'same' (within TOL_SAME)."""
    import torch
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if tuple(got.shape) != tuple(ref.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    emax, emean, scale = errors(got, ref)
    bf16 = dtype == torch.bfloat16
    rf = None
    if kind == "sum":
        ok, tol = emax <= 2e-5 * max(1.0, scale), 2e-5 * max(1.0, scale)
    elif kind == "flush":
        tol = (BF16_ULP if bf16 else 2e-5) * max(1.0, scale)
        ok = emax <= tol
    elif kind == "relfro":
        rf = relfro(got, ref)
        tol = TOL_RELF_BF16 if bf16 else TOL_RELF_F32
        ok = rf <= tol
    elif kind == "cell":
        tol = BF16_ULP if bf16 else TOL_F32
        ok = emax <= tol
    elif kind == "flip_rows":
        tol = TOL_FLIP_MAX if bf16 else TOL_F32
        ratio = ((got.float() - ref.float()).abs().amax(1)
                 / (tol * a_rows)).max().item()
        print(f"  {name}: rows' max error at {ratio:.3e} of max(1, "
              f"max|a_row|) x {tol:.3e} (largest |a| "
              f"{a_rows.max().item():.4e})", flush=True)
        ok = ratio <= 1.0 and (not bf16 or emean <= TOL_FLIP_MEAN)
    elif kind == "bound":
        ratio = ((got.float() - ref.float()).abs()
                 / bound.clamp_min(1e-30))
        rmax, rmean = ratio.max().item(), ratio.mean().item()
        tol = 1.0
        print(f"  {name}: error at most {rmax:.3e} of its element's bound "
              f"(tol 1), on average {rmean:.3e} (tol {TOL_BOUND_MEAN}); "
              f"bounds {bound.min().item():.3e} .. {bound.max().item():.3e}",
              flush=True)
        ok = rmax <= 1.0 and rmean <= TOL_BOUND_MEAN
    elif kind == "same":
        tol = TOL_SAME
        ok = emax <= tol
    else:
        tol = TOL_FLIP_MAX if bf16 else TOL_F32
        ok = emax <= tol and (not bf16 or emean <= TOL_FLIP_MEAN)
    what = (f"rel_frobenius {rf:.3e} (tol {tol:.3e}) max_abs_err {emax:.3e}"
            if rf is not None else
            f"max_abs_err {emax:.3e} (tol {tol:.3e})")
    print(f"  {name}: {what} mean_abs_err {emean:.3e} max_rel_err "
          f"{emax / max(scale, 1e-30):.3e} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: error over tolerance")
    key = max((k for k in KERNELS if name.startswith(k + "[")), key=len,
              default=name.split("[")[0])
    log.setdefault(key, []).append(emax)


def same_twice(name, tag, got, again):
    """A scatter kernel sums in a fixed order (no atomics): a second run on
    the same inputs must give the same bits."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}[{tag}]: two runs differ")
    print(f"  {name}[{tag}]: two runs bit-equal", flush=True)


def cuda_ms(fn, iters):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def window_bytes(win_of_tile, window, esize) -> int:
    """The bytes of the table windows that a layout's real tiles address,
    each window read once however many blocks share it."""
    import torch
    real = win_of_tile[win_of_tile >= 0]
    return torch.unique(real).numel() * window * DIM * esize


def ondemand_h_bytes(win_of_tile, window, T2, esize=2) -> int:
    """The bytes of the 128-row h blocks that a layout's real tiles'
    on-demand windows are built from (window w from block w // wpb, wpb =
    T2·128 / W), each block read once however many tiles address it."""
    import torch
    real = win_of_tile[win_of_tile >= 0]
    wpb = T2 * 128 // window
    return torch.unique(real // wpb).numel() * 128 * DIM * esize


def roofline(n_bytes, ops):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of ``n_bytes`` over the HBM rate and the operations ``ops`` [(count,
    peak rate of their type)] over their rates."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = sum(c / r for c, r in ops)
    print(f"  bound: {n_bytes / 1e9:.4f} GB -> {t_bytes * 1e3:.4f} ms; "
          f"operations -> {t_ops * 1e3:.4f} ms", flush=True)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_pairs(pairs, timings, what="bf16 headline"):
    """Time each kernel against its plain version in turns, plain, kernel,
    kernel, plain, so both are compared within one card, and keep the best
    of each; then the PyTorch call computing the same function, where
    there is one.  ``pairs``: name -> (kernel, plain, library call or None,
    (bound_ms, bound_by)); ``what`` names the inputs in the printed
    lines."""
    for name, (kern, plain, lib, (bound_ms, bound_by)) in pairs.items():
        p1 = cuda_ms(plain, 3)
        k1 = cuda_ms(kern, 10)
        k2 = cuda_ms(kern, 10)
        p2 = cuda_ms(plain, 3)
        lib_ms = cuda_ms(lib, 10) if lib is not None else None
        timings[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms)
        print(f"  time {name} [{what}]: kernel {k1:.3f}/{k2:.3f} ms, "
              f"plain {p1:.3f}/{p2:.3f} ms, library call "
              f"{'none' if lib_ms is None else f'{lib_ms:.3f} ms'}, bound "
              f"{bound_ms:.4f} ms ({bound_by}): kernel at "
              f"{bound_ms / min(k1, k2):.3f} of its bound", flush=True)


def kernel_inputs(layout, dtype, params, seed, a_max=None):
    """Kernel arguments at a layout's shapes: the model's weights and a
    state in (−1, 1) as the GRU keeps it.  ``kw`` holds the layout's
    arguments (block mode: the three slot arrays are ``arrs``; per tile:
    all of them are in ``kw``) and ``a`` the aggregation's value.
    ``a_max`` (per tile): the messages and the bias are scaled down so
    that |a| ≤ a_max everywhere."""
    import torch
    from ggnn_tpu_torch.models.ggnn import fuse_gru
    from ggnn_tpu_torch.ops import scatter as S
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    if layout.block_meta is None:
        kw, arrs = S.tile_args(layout), ()
    else:
        kw = S.block_args(layout)
        arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
    n_rows = kw["n_blocks"] * 128
    n_nodes = int(layout.arrays["gather_idx"].max().item()) + 1
    h = torch.rand(max(n_nodes, n_rows), DIM, device=dev, generator=g) * 2 - 1
    prop = params["prop"]
    T2 = layout.arrays["indeg"].shape[0]
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    x = dict(
        h_pack=h.to(dtype).index_select(0, layout.arrays["gather_idx"]),
        arrs=arrs, kw=kw, msg_w=prop["msg_w"][:T2].to(dtype),
        init=S.bias_rows(layout, prop["msg_b"][:T2].to(dtype)),
        hstate=h[:n_rows].contiguous(), wa=w_a.to(dtype),
        b3=b_all[None, :].float(), uzr=u_zr.to(dtype),
        uh=prop["gru"]["uh"].to(dtype))
    if arrs:
        x["a"] = x["init"] + S.typed_block_scatter_reference(
            x["h_pack"], *arrs, x["msg_w"], **kw)
    else:
        x["a"] = x["init"] + S.typed_onehot_scatter_reference(
            x["h_pack"], msg_w=x["msg_w"], **kw)
        if a_max is not None:
            s = 0.5 * a_max / x["a"].abs().max().item()
            x["h_pack"] = (x["h_pack"].float() * s).to(dtype)
            x["init"] = x["init"] * s
            x["a"] = x["init"] + S.typed_onehot_scatter_reference(
                x["h_pack"], msg_w=x["msg_w"], **kw)
            if x["a"].abs().max().item() > a_max:
                raise AssertionError("the scaled inputs exceed |a| ≤ a_max")
    return x


def flush_bound(plain, table, ref, out_dtype):
    """The per-element bound of a reverse scatter against its plain version
    ``plain`` (a function of the table, summing into f32): 2e-5 of the sum
    over |table|, plus in bf16 one ulp of the flushed value, 2**-7·|ref|."""
    import torch
    bound = 2e-5 * plain(table.abs())
    if out_dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.float().abs()
    return bound


def scatter_bound(layout, x, dtype, fused, layout_arrays):
    """The bound of a forward typed scatter (per block or per tile) on
    inputs ``x``: every real edge's h row read once, the layout's arrays,
    W and the output rows (fused: the state, bias and GRU weights too);
    the W_t products at the bf16 tensor rate, the one-hot sums as f32
    adds, the GRU's six products."""
    import torch
    n_real = int(layout.arrays["indeg"].sum().item())
    n_rows = layout.n_blocks * 128
    esize = torch.tensor([], dtype=dtype).element_size()
    n_bytes = (n_real * DIM * esize + nbytes(*layout_arrays, x["msg_w"])
               + n_rows * DIM * 4)
    if layout.block_meta is None:
        n_products = int((layout.arrays["tile_msg_off"] >= 0).sum().item())
    else:
        n_products = int((layout.arrays["slot_off16"] >= 0).sum().item())
    ops = [(2 * 128 * DIM * DIM * n_products, BF16_FLOPS),
           (n_real * DIM, F32_FLOPS)]
    if fused:
        n_bytes += nbytes(x["init"], x["hstate"], x["wa"], x["b3"],
                          x["uzr"], x["uh"])
        ops.append((12 * n_rows * DIM * DIM, BF16_FLOPS))
    return roofline(n_bytes, ops)


def check_kernels(tag, layout, params, log, timings=None):
    import torch
    from ggnn_tpu_torch.ops import bounds as B
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    print(f"[kernels] {tag}: tile_e={layout.meta[1]} n_blocks="
          f"{layout.meta[3]} (S8, cmax, span_rows)={layout.meta[10]}",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        x = kernel_inputs(layout, dtype, params, seed=1)
        arrs, kw = x["arrs"], x["kw"]
        sa = (x["h_pack"], *arrs, x["msg_w"])
        fa = (*sa, x["init"], x["hstate"], x["wa"], x["b3"], x["uzr"],
              x["uh"])
        ga = (x["hstate"], x["a"], x["wa"], x["b3"][0], x["uzr"], x["uh"])
        dn = str(dtype).split(".")[-1]
        got = S.typed_block_scatter(*sa, **kw)
        same_twice("typed_block_scatter", tag, got,
                   S.typed_block_scatter(*sa, **kw))
        ref = S.typed_block_scatter_reference(*sa, **kw)
        if dtype == torch.bfloat16:   # csrc/typed_block_fused.cu
            check(f"typed_block_scatter[{tag},{dn}]", got, ref, "bound",
                  dtype, log, bound=B.block_bound(x["h_pack"], x["msg_w"],
                                                  arrs, kw, dtype))
        else:
            check(f"typed_block_scatter[{tag},{dn}]", got, ref, "sum",
                  dtype, log)
        del ref
        empty = (layout.arrays["slot_off16"].reshape(kw["n_blocks"], -1)
                 < 0).all(1)
        if empty.any():
            rows = got.reshape(kw["n_blocks"], 128, DIM)[empty]
            if (rows != 0).any():
                raise AssertionError(f"{tag}: an empty dst block is not 0")
            print(f"  {int(empty.sum())} empty dst blocks are exactly 0",
                  flush=True)
        got = S.typed_block_step_gru(*fa, **kw)
        same_twice("typed_block_step_gru", tag, got,
                   S.typed_block_step_gru(*fa, **kw))
        check(f"typed_block_step_gru[{tag},{dn}]", got,
              S.typed_block_step_gru_reference(*fa, **kw), "flip", dtype,
              log)
        if dtype == torch.bfloat16:
            check(f"typed_block_step_gru[{tag},{dn}] vs the GRU cell of "
                  f"init + typed_block_scatter_reference", got,
                  G.gru_cell_fwd_reference(*ga, mdt=dtype)[0],
                  "flip_rows", dtype, log,
                  a_rows=x["a"].abs().amax(1).clamp_min(1.0))
        if dtype == torch.bfloat16:   # csrc/gru_cell_pipe.cu
            check_gru_cell(f"{tag},{dn}", ga, log)
        else:
            outs = G.gru_cell_fwd(*ga, mdt=dtype)
            torch.cuda.synchronize()
            refs = G.gru_cell_fwd_reference(*ga, mdt=dtype)
            for part, o, r in zip(("h", "z", "r", "htil"), outs, refs):
                check(f"gru_cell_fwd[{tag},{dn},{part}]", o, r, "cell",
                      dtype, log)
        if timings is not None and dtype == torch.bfloat16:
            n_rows = kw["n_blocks"] * 128
            cell_bound = roofline(
                nbytes(*ga) + n_rows * DIM * 4
                + 3 * n_rows * DIM * x["wa"].element_size(),
                [(12 * n_rows * DIM * DIM, BF16_FLOPS)])
            # none of the three has one PyTorch call computing it: the
            # scatters round each slot's one-hot sum before its W_t
            # product, and torch's GRU cell applies r after the U_h product
            time_pairs({
                "typed_block_scatter": (
                    lambda: S.typed_block_scatter(*sa, **kw),
                    lambda: S.typed_block_scatter_reference(*sa, **kw), None,
                    scatter_bound(layout, x, dtype, False, arrs)),
                "typed_block_step_gru": (
                    lambda: S.typed_block_step_gru(*fa, **kw),
                    lambda: S.typed_block_step_gru_reference(*fa, **kw),
                    None, scatter_bound(layout, x, dtype, True, arrs)),
                "gru_cell_fwd": (
                    lambda: G.gru_cell_fwd(*ga, mdt=dtype),
                    lambda: G.gru_cell_fwd_reference(*ga, mdt=dtype), None,
                    cell_bound),
            }, timings)
        del x


# Real-row prefix lengths at the seams of typed_pipe.cuh's 128-row chunks
# and 16-row k-steps.
TYPED_SEAM_LENGTHS = (1, 15, 16, 17, 127, 128, 129, 256)


def typed_seam_edges():
    """(tag, edges, N, T2, tile_e, widths) at the seams of the bf16 slot
    pipeline (csrc/typed_pipe.cuh) of #1, #2, #6 and #7:

    - "lengths": block i < 8 holds a type-0 group of TYPED_SEAM_LENGTHS[i]
      edges, a type-2 group of 256 more (a second slot of that prefix at
      tile_e 256) and a type-3 group of another length; block 8 none;
      blocks 9-11 random edges; 10 % more edges masked out; at tile_e 256
      and 144 (a slot's second chunk cut short), widths 64 (zero-padded),
      128 and 256 (two panels);
    - "hub": dst block 0 holds 60 tiles of three types (two work items of
      #6/#7 with a type change inside each, 20 slots a type in block
      mode);
    - "many slots": 36 types, tile_e 16, dst block 0 with eight slots of
      every type (S8 = 288: the slot list read in two groups)."""
    r = np.random.default_rng(33)

    def rand_block(b, n, T2):
        return (r.integers(0, 128 * 12, n), 128 * b + r.integers(0, 128, n),
                r.integers(0, T2, n))

    L = TYPED_SEAM_LENGTHS
    parts = []
    for i, n in enumerate(L):
        for t, m in ((0, n), (2, 256 + n), (3, L[(i + 3) % len(L)])):
            parts.append((r.integers(0, 128 * 12, m),
                          128 * i + r.integers(0, 128, m), np.full(m, t)))
    parts += [rand_block(b, 500, 4) for b in (9, 10, 11)]
    src, dst, typ = (np.concatenate(x) for x in zip(*parts))
    n_mask = src.shape[0] // 10
    mask = np.concatenate([np.ones(src.shape[0], np.float32),
                           np.zeros(n_mask, np.float32)])
    extra = rand_block(int(r.integers(0, 12)), n_mask, 4)
    edges = tuple(np.concatenate([a, b]) for a, b in zip((src, dst, typ),
                                                         extra)) + (mask,)
    for tile_e in (256, 144):
        yield f"lengths, tile_e {tile_e}", edges, 128 * 12, 4, tile_e, (
            64, DIM, 256)
    parts = [(r.integers(0, 128 * 12, 5000), r.integers(0, 128, 5000),
              np.full(5000, t)) for t in (0, 1, 3)]
    parts += [rand_block(b, 700, 4) for b in range(1, 12, 2)]
    src, dst, typ = (np.concatenate(x) for x in zip(*parts))
    yield "hub", (src, dst, typ, np.ones(src.shape[0], np.float32)), \
        128 * 12, 4, 256, (DIM,)
    T2 = 36
    parts = [(r.integers(0, 128 * 12, 125), r.integers(0, 128, 125),
              np.full(125, t)) for t in range(T2)]
    parts += [rand_block(b, 300, T2) for b in (1, 4, 7)]
    src, dst, typ = (np.concatenate(x) for x in zip(*parts))
    yield "many slots", (src, dst, typ, np.ones(src.shape[0], np.float32)), \
        128 * 12, T2, 16, (DIM,)


def typed_seam_fuzz(log):
    """[kernels] #1, #2, #7 and #6 in bf16 at the seams of their slot
    pipeline (:func:`typed_seam_edges`): each edge set as a block-mode
    layout (#1, #2) and a per-tile layout (#7, #6), each kernel against
    its plain version (#1 and #7 per element, #2 and #6 per row, #2 also
    against the GRU cell of init plus #1's plain sums), twice bit-equal; a
    block without an edge is exactly 0 (#1, #7).  The two layouts hold the
    same edges in the same slots in the same order, and the four kernels
    share the pipeline, so on every block of one work item #7 must give
    #1's bits and #6 #2's."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import bounds as B
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(34)
    K = _build.library().ggnn_tile_split()
    for tag, (src, dst, typ, mask), N, T2, tile_e, dims in typed_seam_edges():
        blay = S.build_typed_dst_layout(src, dst, typ, mask, N, T2,
                                        tile_e=tile_e, block_mode=True)
        tlay = S.build_typed_dst_layout(src, dst, typ, mask, N, T2,
                                        tile_e=tile_e, block_mode=False)
        if blay.block_meta is None or tlay.block_meta is not None:
            raise AssertionError(f"typed seams {tag}: the layouts' modes")
        blay, tlay = blay.to("cuda"), tlay.to("cuda")
        bkw = S.block_args(blay)
        arrs = (bkw.pop("dstl_blk"), bkw.pop("slot_off16"),
                bkw.pop("blk_off16"))
        tkw = S.tile_args(tlay)
        nb = bkw["n_blocks"]
        sizes = tkw["tile_start"].diff()
        single = sizes <= K
        lens = S.dstl_lengths(arrs[0])[arrs[1] >= 0]
        print(f"[kernels] typed seams {tag}: {nb} blocks, (S8, cmax) "
              f"({bkw['S8']}, {bkw['cmax']}), {int(lens.numel())} real "
              f"slots, prefix lengths {sorted(set(lens.tolist()))[:12]}...; "
              f"{int(sizes.sum())} tiles, largest block "
              f"{int(sizes.max())} (items of {K})", flush=True)
        if tag == "hub" and bool(single.all()):
            raise AssertionError("typed seams hub: no block splits")
        if tag == "many slots" and bkw["S8"] <= 256:
            raise AssertionError("typed seams many slots: S8 <= 256")
        empty = (arrs[1].reshape(nb, -1) < 0).all(1)
        for D in dims:
            w, _, gw = rand_step_weights(D, bf, gen, T2=T2)
            h = (torch.rand(N, D, device="cuda", generator=gen) * 2
                 - 1).to(bf)
            init = torch.randn(N, D, device="cuda", generator=gen) * 0.3
            hstate = torch.rand(N, D, device="cuda", generator=gen) * 2 - 1
            st = dict(init=init, hstate=hstate, **gw)
            name = f"seam {tag},D={D}"
            hb = h.index_select(0, blay.arrays["gather_idx"])
            ht = h.index_select(0, tlay.arrays["gather_idx"])
            got1 = S.typed_block_scatter(hb, *arrs, w, **bkw)
            same_twice("typed_block_scatter", name, got1,
                       S.typed_block_scatter(hb, *arrs, w, **bkw))
            ref1 = S.typed_block_scatter_reference(hb, *arrs, w, **bkw)
            check(f"typed_block_scatter[{name}]", got1, ref1, "bound", bf,
                  log, bound=B.block_bound(hb, w, arrs, bkw, bf))
            if (got1.reshape(nb, 128, D)[empty] != 0).any():
                raise AssertionError(f"typed seams {tag}: a block without "
                                     "a slot is not 0")
            a1 = init + ref1
            a_rows = a1.abs().amax(1).clamp_min(1.0)
            del ref1
            fa = (hb, *arrs, w, init, hstate, gw["wa"], gw["b3"], gw["uzr"],
                  gw["uh"])
            got2 = S.typed_block_step_gru(*fa, **bkw)
            same_twice("typed_block_step_gru", name, got2,
                       S.typed_block_step_gru(*fa, **bkw))
            check(f"typed_block_step_gru[{name}]", got2,
                  S.typed_block_step_gru_reference(*fa, **bkw), "flip_rows",
                  bf, log, a_rows=a_rows)
            check(f"typed_block_step_gru[{name}] vs the GRU cell of init + "
                  f"typed_block_scatter_reference", got2,
                  G.gru_cell_fwd_reference(
                      hstate, a1, gw["wa"], gw["b3"][0], gw["uzr"],
                      gw["uh"], mdt=bf)[0], "flip_rows", bf, log,
                  a_rows=a_rows)
            sa = dict(h_pack=ht, msg_w=w, **tkw)
            got7 = S.typed_onehot_scatter(**sa)
            same_twice("typed_onehot_scatter", name, got7,
                       S.typed_onehot_scatter(**sa))
            check(f"typed_onehot_scatter[{name}]", got7,
                  S.typed_onehot_scatter_reference(**sa), "bound", bf, log,
                  bound=B.tile_bound(ht, w, tkw, bf))
            got6 = S.typed_step_gru(**sa, **st)
            same_twice("typed_step_gru", name, got6,
                       S.typed_step_gru(**sa, **st))
            check(f"typed_step_gru[{name}]", got6,
                  S.typed_step_gru_reference(**sa, **st), "flip_rows", bf,
                  log, a_rows=a_rows)
            for k1, o1, k2, o2 in (("#7", got7, "#1", got1),
                                   ("#6", got6, "#2", got2)):
                if not torch.equal(o1.reshape(nb, 128, D)[single],
                                   o2.reshape(nb, 128, D)[single]):
                    raise AssertionError(
                        f"typed seams {tag}, D={D}: {k1} differs from {k2} "
                        "on a block of one work item")
            print(f"  typed seams {tag}, D={D}: #7 = #1 and #6 = #2 bit for "
                  f"bit on the {int(single.sum())} blocks of one work item",
                  flush=True)
            del got1, got2, got6, got7, hb, ht
        del blay, tlay
        torch.cuda.empty_cache()


def check_grad_kernels(tag, layout, log, timings=None):
    """The backward kernels against their plain versions at the layout's
    shapes: the reverse scatter on a random cotangent pack, and the GRU
    backward on residuals the forward cell makes from random h and a."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    _, B_g, g_tile, C, R8, span8, n_oct = S.grad_meta(layout)
    arrs = layout.arrays
    octs = (arrs["g_dstl_oct"], arrs["g_slot_off16"], arrs["g_oblk16"])
    okw = dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8)
    n_rows = layout.meta[3] * 128
    empty = (arrs["g_slot_off16"].reshape(n_oct * 8, C) < 0).all(1)
    print(f"[kernels] {tag} grad half: B_g={B_g} (B_g % 8 = {B_g % 8}) "
          f"g_tile={g_tile} C={C} n_oct={n_oct} span8={span8}, "
          f"{int(empty.sum())} empty grad blocks of {n_oct * 8}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        Gp = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                         generator=gen).to(dtype)
        got = S.typed_grad_octet_scatter(Gp, *octs, **okw, out_dtype=dtype)
        same_twice("typed_grad_octet_scatter", tag, got,
                   S.typed_grad_octet_scatter(Gp, *octs, **okw,
                                              out_dtype=dtype))
        ref = S.typed_grad_octet_scatter_reference(Gp, *octs, **okw,
                                                   out_dtype=dtype)
        check(f"typed_grad_octet_scatter[{tag},{dn}]", got, ref, "flush",
              dtype, log)
        rows = got.reshape(n_oct * 8, 128, DIM)
        if (rows[empty] != 0).any():
            raise AssertionError(f"{tag}: an empty grad block is not 0")
        args = gru_bwd_inputs(n_rows, dtype, gen)
        w = args[6:]
        outs = check_gru_bwd(f"{tag},{dn}", args, dtype, log)
        if timings is not None and dtype == torch.bfloat16:
            n_real = int(arrs["g_indeg"].sum().item())
            octet_bound = roofline(
                n_real * DIM * Gp.element_size() + nbytes(*octs)
                + nbytes(got), [(n_real * DIM, F32_FLOPS)])
            bwd_bound = roofline(
                nbytes(args[0]) + 5 * nbytes(args[1]) + 2 * nbytes(*w)
                + 2 * n_rows * DIM * 4 + 3 * DIM * 4,
                [(24 * n_rows * DIM * DIM, BF16_FLOPS)])
            lib = reverse_library_call(
                Gp, octet_targets(arrs, n_oct, g_tile, C, R8, Gp.shape[0]),
                n_oct * 8 * 128)
            time_pairs({
                "typed_grad_octet_scatter": (
                    lambda: S.typed_grad_octet_scatter(
                        Gp, *octs, **okw, out_dtype=dtype),
                    lambda: S.typed_grad_octet_scatter_reference(
                        Gp, *octs, **okw, out_dtype=dtype), lib,
                    octet_bound),
                # torch's GRU cell is another function (r after U_h)
                "gru_cell_bwd": (
                    lambda: G.gru_cell_bwd(*args, mdt=dtype),
                    lambda: G.gru_cell_bwd_reference(*args, mdt=dtype),
                    None, bwd_bound),
            }, timings)
        del Gp, got, ref, outs, args


def gru_bwd_inputs(n_rows, dtype, gen, D=DIM):
    """#4's arguments for ``n_rows`` rows: the cotangent g, h, a and the
    residuals z, r, h̃ that the forward cell makes from random h and a,
    and the GRU weights."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    dev = torch.device("cuda")
    h = torch.rand(n_rows, D, device=dev, generator=gen) * 2 - 1
    a = torch.randn(n_rows, D, device=dev, generator=gen)
    g = torch.randn(n_rows, D, device=dev, generator=gen)
    w = [torch.empty(D, k * D, device=dev).uniform_(
        -D ** -0.5, D ** -0.5, generator=gen) for k in (3, 2, 1)]
    b3 = torch.empty(3 * D, device=dev).uniform_(-0.1, 0.1, generator=gen)
    _, z, r, ht = G.gru_cell_fwd_reference(h, a, w[0], b3, w[1], w[2],
                                           mdt=dtype)
    return (g, h.to(dtype), a.to(dtype), z, r, ht, *w)


def check_gru_bwd(tag, args, dtype, log, da_dtype=None):
    """#4 on ``args`` against its plain version (relative Frobenius error
    of each of its six outputs), and a second run bit-equal on all six."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    kw = dict(mdt=dtype, da_dtype=da_dtype or torch.float32)
    outs = G.gru_cell_bwd(*args, **kw)
    again = G.gru_cell_bwd(*args, **kw)
    refs = G.gru_cell_bwd_reference(*args, **kw)
    for part, o, o2, rr in zip(("dh", "da", "dW_a", "db", "dU_zr", "dU_h"),
                               outs, again, refs):
        same_twice("gru_cell_bwd", f"{tag},{part}", o, o2)
        check(f"gru_cell_bwd[{tag},{part}]", o, rr, "relfro", dtype, log)
    return outs


def gru_bwd_seam_fuzz(log):
    """[kernels] #4 at the seams of its bf16 kernel, da in f32 and in bf16
    (the fused window step's VJP): one 128-row block, 17 (a split-K chunk
    of 16 blocks and a partial one), 33, and one block more than the card
    has SMs (the persistent rows pass then gives one CTA two blocks); in
    f32 one block and 17."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(41)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n_blocks in (1, 17, 33, sms + 1):
        for dtype, das in ((torch.bfloat16, (torch.float32, torch.bfloat16)),
                           (torch.float32, (torch.float32,))):
            if dtype == torch.float32 and n_blocks > 17:
                continue
            args = gru_bwd_inputs(128 * n_blocks, dtype, gen)
            for da in das:
                check_gru_bwd(f"seam {n_blocks} blocks,"
                              f"{str(dtype).split('.')[-1]},da "
                              f"{str(da).split('.')[-1]}", args, dtype, log,
                              da_dtype=da)
            del args


def gru_first_body(ga):
    """#3's first body in bf16 (``csrc/gru_cell.cu``, ``ggnn_gru_cell``
    with dtype 1) on the arguments ``ga`` of ``gru_cell_fwd``, called
    through its C entry point: (h', z, r, h̃)."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    bf = torch.bfloat16
    h, a, w_a, b_all, u_zr, uh = ga
    w_a, u_zr, uh = (w.to(bf).contiguous() for w in (w_a, u_zr, uh))
    b3 = b_all.reshape(-1).float().contiguous()
    out = torch.empty_like(h)
    z, r, ht = (torch.empty(h.shape, dtype=bf, device=h.device)
                for _ in range(3))
    G.cell_launch("ggnn_gru_cell", h, a, w_a, b3, u_zr, uh, out, z, r, ht,
                  bf)
    return out, z, r, ht


def check_gru_cell(tag, ga, log):
    """#3 in bf16 (``csrc/gru_cell_pipe.cu``) on ``ga``: each output
    against the plain version ('cell'), twice bit-equal, and bit-equal to
    the first body (:func:`gru_first_body`)."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    bf = torch.bfloat16
    outs = G.gru_cell_fwd(*ga, mdt=bf)
    again = G.gru_cell_fwd(*ga, mdt=bf)
    first = gru_first_body(ga)
    torch.cuda.synchronize()
    refs = G.gru_cell_fwd_reference(*ga, mdt=bf)
    differ = []
    for part, o, f in zip(("h", "z", "r", "htil"), outs, first):
        d = (o.float() - f.float()).abs()
        if not torch.equal(o, f):
            differ.append(f"{part}: {int((d > 0).sum())} elements, at most "
                          f"{d.max().item():.3e}")
    if differ:
        raise AssertionError(f"gru_cell_fwd[{tag}]: not the first body's "
                             f"bits ({'; '.join(differ)})")
    for part, o, o2, r in zip(("h", "z", "r", "htil"), outs, again, refs):
        same_twice("gru_cell_fwd", f"{tag},{part}", o, o2)
        check(f"gru_cell_fwd[{tag},{part}]", o, r, "cell", bf, log)
    print(f"  gru_cell_fwd[{tag}]: h', z, r, h̃ bit-equal to the first "
          f"body (gru_cell.cu)", flush=True)


def gru_cell_seam_fuzz(log):
    """[kernels] #3's bf16 body at the seams of its persistent CTAs (one an
    SM, 8 warps, a warp a 16-row strip): one 128-row block (one CTA), one
    block fewer and one more than the card has SMs (every CTA 8 strips;
    strip ranges of 8 and 16), each with |a| ~ 1 and with saturating gates
    (|a| ~ 40: σ at 0 and 1, tanh at ±1): against the plain version,
    twice bit-equal and bit-equal to the first body."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(43)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    for n_blocks in (1, sms - 1, sms + 1):
        for amp in (1.0, 40.0):
            N = 128 * n_blocks
            h = torch.rand(N, DIM, device=dev, generator=gen) * 2 - 1
            a = torch.randn(N, DIM, device=dev, generator=gen) * amp
            w = [torch.empty(DIM, k * DIM, device=dev).uniform_(
                -DIM ** -0.5, DIM ** -0.5, generator=gen) for k in (3, 2, 1)]
            b3 = torch.empty(3 * DIM, device=dev).uniform_(-0.1, 0.1,
                                                          generator=gen)
            check_gru_cell(f"seam {n_blocks} blocks,|a|~{amp:g}",
                           (h, a, w[0], b3, w[1], w[2]), log)


def check_tile_kernels(tag, layout, params, log, timings=None, a_max=None,
                       dtypes=None):
    """The per-tile kernels against their plain versions at a per-tile
    layout's shapes (per element; the fused step per row, scaled by the
    row's |a|, and exactly against the GRU cell kernel of the plain
    kernel's sums), and each against a second run of itself (bit-equal:
    no atomics); blocks whose only tile is a dummy must come out exactly
    0.  ``a_max``: inputs scaled so that |a| ≤ a_max; ``dtypes``: by
    default bf16 and f32."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import bounds as B
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    ts = layout.arrays["tile_start"]
    sizes = ts[1:] - ts[:-1]
    big = int(sizes.argmax().item())
    K = _build.library().ggnn_tile_split()
    print(f"[kernels] {tag}: tile_e={layout.meta[1]} n_blocks="
          f"{layout.meta[3]} tiles={int(ts[-1].item())}; the largest dst "
          f"block ({big}) holds {int(sizes[big].item())} tiles, split into "
          f"items of at most K={K}; {int((sizes > K).sum().item())} blocks "
          f"of several items; chunks "
          f"{None if layout.meta[8] is None else len(layout.meta[8])}, span "
          f"rows {layout.meta[9]}", flush=True)
    if a_max is not None and not (sizes > K).any():
        raise AssertionError(f"{tag}: no block splits into several items")
    kw = S.tile_args(layout)
    dummy = kw["block_of_tile"][kw["tile_msg_off"] < 0].long()
    for dtype in dtypes or (torch.bfloat16, torch.float32):
        x = kernel_inputs(layout, dtype, params, seed=1, a_max=a_max)
        dn = str(dtype).split(".")[-1]
        sa = dict(h_pack=x["h_pack"], msg_w=x["msg_w"], **kw)
        fa = dict(sa, init=x["init"], hstate=x["hstate"], wa=x["wa"],
                  b3=x["b3"], uzr=x["uzr"], uh=x["uh"])
        got = S.typed_onehot_scatter(**sa)
        same_twice("typed_onehot_scatter", tag, got,
                   S.typed_onehot_scatter(**sa))
        check(f"typed_onehot_scatter[{tag},{dn}]", got,
              S.typed_onehot_scatter_reference(**sa), "bound", dtype, log,
              bound=B.tile_bound(x["h_pack"], x["msg_w"], kw, dtype))
        if dummy.numel():
            if (got.reshape(-1, 128, DIM)[dummy] != 0).any():
                raise AssertionError(f"{tag}: a block with only a dummy "
                                     "tile is not 0")
            print(f"  {dummy.numel()} blocks with only a dummy tile are "
                  "exactly 0", flush=True)
        sums = got
        got = S.typed_step_gru(**fa)
        same_twice("typed_step_gru", tag, got, S.typed_step_gru(**fa))
        a_rows = x["a"].abs().amax(1).clamp_min(1.0)
        check(f"typed_step_gru[{tag},{dn}]", got,
              S.typed_step_gru_reference(**fa), "flip_rows", dtype, log,
              a_rows=a_rows)
        if dtype == torch.float32:
            cell = G.gru_cell_fwd(x["hstate"], sums + x["init"], x["wa"],
                                  x["b3"][0], x["uzr"], x["uh"],
                                  mdt=dtype)[0]
            torch.cuda.synchronize()
            check(f"typed_step_gru[{tag},{dn}] vs gru_cell_fwd(typed_"
                  f"onehot_scatter + init)", got, cell, "same", dtype, {})
        else:
            cell = G.gru_cell_fwd_reference(x["hstate"], x["a"], x["wa"],
                                            x["b3"][0], x["uzr"], x["uh"],
                                            mdt=dtype)[0]
            check(f"typed_step_gru[{tag},{dn}] vs the GRU cell of init + "
                  f"typed_onehot_scatter_reference (f64 sums)", got, cell,
                  "flip_rows", dtype, log, a_rows=a_rows)
        del sums, cell
        if timings is not None and dtype == torch.bfloat16:
            arrays = [kw[k] for k in ("dstl", "tile_start", "block_of_tile",
                                      "tile_msg_off", "c_off", "tile_type")]
            # no PyTorch call computes them: each tile's one-hot sum is
            # rounded before its W_t product
            time_pairs({
                "typed_onehot_scatter": (
                    lambda: S.typed_onehot_scatter(**sa),
                    lambda: S.typed_onehot_scatter_reference(**sa), None,
                    scatter_bound(layout, x, dtype, False, arrays)),
                "typed_step_gru": (
                    lambda: S.typed_step_gru(**fa),
                    lambda: S.typed_step_gru_reference(**fa), None,
                    scatter_bound(layout, x, dtype, True, arrays)),
            }, timings)
            # the hub block's share: the same call with every other
            # block's tiles made dummies
            hub_off = torch.where(kw["block_of_tile"] == big,
                                  kw["tile_msg_off"],
                                  torch.full_like(kw["tile_msg_off"], -1))
            for kname, fn, args in (
                    ("typed_onehot_scatter", S.typed_onehot_scatter, sa),
                    ("typed_step_gru", S.typed_step_gru, fa)):
                hub_ms = cuda_ms(lambda: fn(**dict(args,
                                                   tile_msg_off=hub_off)), 10)
                whole = timings[kname]["ms"]
                print(f"  hub block {big} alone ({int(sizes[big].item())} of "
                      f"{int(ts[-1].item())} tiles): {kname} {hub_ms:.3f} "
                      f"ms, {hub_ms / whole:.3f} of the whole call's "
                      f"{whole:.3f} ms", flush=True)
        del x, got


def check_window_kernel(tag, layout, log, timings=None):
    """window_block_spmm_mono against its plain version on the legacy grad
    layout of a typed pack whose octet layout declined."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    gm = S.grad_meta(layout)
    if gm[0] == "octet":
        raise AssertionError(f"{tag}: the octet grad layout engaged")
    arrs = layout.arrays
    g_blocks, _, g_tile, _, g_align, g_chunks = gm
    ts = arrs["g_tile_start"]
    sizes = ts[1:] - ts[:-1]
    print(f"[kernels] {tag} legacy grad layout: {g_blocks} grad blocks, "
          f"{int(ts[-1].item())} tiles of {g_tile}, largest grad block "
          f"{int(sizes.max().item())} tiles, chunks "
          f"{None if g_chunks is None else len(g_chunks)}", flush=True)
    stream = (arrs["g_dstl"], arrs["g_tile_start"], arrs["g_block_of_tile"],
              arrs["g_tile_msg_off"])
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        Gp = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                         generator=gen).to(dtype)
        kw = dict(n_blocks=g_blocks, window=g_tile, win_stride=g_align,
                  out_dtype=dtype, dstl=True)
        got = W.window_block_spmm_mono(Gp, *stream, **kw)
        same_twice("window_block_spmm_mono", tag, got,
                   W.window_block_spmm_mono(Gp, *stream, **kw))
        ref = W.window_block_spmm_mono_reference(Gp, *stream, **kw)
        check(f"window_block_spmm_mono[{tag},{dn}]", got, ref, "bound", dtype, log, bound=flush_bound(
                  lambda t: W.window_block_spmm_mono_reference(
                      t, *stream, **dict(kw, out_dtype=torch.float32)),
                  Gp, ref, dtype))
        del ref
        if timings is not None and dtype == torch.bfloat16:
            n_real = int(arrs["g_indeg"].sum().item())
            bound = roofline(n_real * DIM * Gp.element_size()
                             + nbytes(*stream) + nbytes(got),
                             [(n_real * DIM, F32_FLOPS)])
            lib = reverse_library_call(
                Gp, window_targets(arrs, g_tile, g_align, g_blocks,
                                   Gp.shape[0]), g_blocks * 128)
            time_pairs({"window_block_spmm_mono": (
                lambda: W.window_block_spmm_mono(Gp, *stream, **kw),
                lambda: W.window_block_spmm_mono_reference(Gp, *stream,
                                                           **kw),
                lib, bound)}, timings)
            # the hub's share: only the grad blocks holding more than one
            # work item (the hub's source rows) keep their tiles
            K = _build.library().ggnn_tile_split()
            hub = sizes[stream[2].long()] > K
            hub_win = torch.where(hub, stream[3],
                                  torch.full_like(stream[3], -1))
            hub_ms = cuda_ms(lambda: W.window_block_spmm_mono(
                Gp, stream[0], stream[1], stream[2], hub_win, **kw), 10)
            whole = timings["window_block_spmm_mono"]["ms"]
            print(f"  the {int((sizes > K).sum().item())} grad blocks of "
                  f"more than {K} tiles alone ({int(hub.sum().item())} of "
                  f"{int(ts[-1].item())} tiles): {hub_ms:.3f} ms, "
                  f"{hub_ms / whole:.3f} of the whole call's {whole:.3f} ms",
                  flush=True)
        del Gp, got


def check_count_stream(log):
    """window_block_spmm_mono on the int8 count stream of the legacy
    layout (aligned with win_stride 16, and dense), as the legacy grad
    layout carries it when its tiles are no multiple of 16."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(11)
    src, dst, typ = (r.integers(0, 768, 5000), r.integers(0, 768, 5000),
                     r.integers(0, 3, 5000))
    for align in (16, None):
        lay = L.build_dst_block_layout(src, dst, typ, np.ones(5000, np.float32),
                                       768, tile_e=128, n_message_types=3,
                                       edge_align=align)
        win = (lay.tile_msg_off if align else
               np.arange(lay.block_of_tile.shape[0], dtype=np.int32))
        args = [torch.as_tensor(a, device=dev) for a in (
            lay.onehot, lay.tile_start, lay.block_of_tile, win)]
        for dtype in (torch.bfloat16, torch.float32):
            table = torch.randn(lay.gather_idx.shape[0], DIM,
                                device=dev).to(dtype)
            kw = dict(n_blocks=lay.n_blocks, window=128, win_stride=align,
                      out_dtype=dtype)
            got = W.window_block_spmm_mono(table, *args, **kw)
            torch.cuda.synchronize()
            ref = W.window_block_spmm_mono_reference(table, *args, **kw)
            check(f"window_block_spmm_mono[counts, stride {align},"
                  f"{str(dtype).split('.')[-1]}]", got, ref, "bound", dtype,
                  log, bound=flush_bound(
                      lambda t: W.window_block_spmm_mono_reference(
                          t, *args, **dict(kw, out_dtype=torch.float32)),
                      table, ref, dtype))


def octet_targets(arrs, n_oct, g_tile, C, R8, n_G):
    """For every row of the octet layout's cotangent pack, the output row
    it adds to (n_oct·8·128, one past the end, for rows no slot reads)."""
    import torch
    dev = arrs["g_gather_idx"].device
    off = arrs["g_slot_off16"].reshape(n_oct, 8, C).long()
    dl = (arrs["g_dstl_oct"].reshape(n_oct, R8, g_tile)[:, :8 * C]
          .reshape(n_oct, 8, C, g_tile).long())
    rows = (((arrs["g_oblk16"].long()[:, None, None] + off) * 16)[..., None]
            + torch.arange(g_tile, device=dev))
    valid = (dl >= 0) & (off[..., None] >= 0)
    blk = torch.arange(n_oct * 8, device=dev).reshape(n_oct, 8, 1, 1)
    tgt = torch.full((n_G,), n_oct * 8 * 128, dtype=torch.long, device=dev)
    tgt[rows[valid]] = (blk * 128 + dl)[valid]
    return tgt


def window_targets(arrs, window, stride, n_blocks, n_G):
    """The same for the legacy grad layout (dense dstl stream)."""
    import torch
    dev = arrs["g_gather_idx"].device
    win = arrs["g_tile_msg_off"].long()
    rows = arrs["g_dstl"][:win.shape[0]].long()
    valid = rows >= 0
    src = (win[:, None] * stride + torch.arange(window, device=dev))[valid]
    tgt = torch.full((n_G,), n_blocks * 128, dtype=torch.long, device=dev)
    tgt[src] = (arrs["g_block_of_tile"].long()[:, None] * 128 + rows)[valid]
    return tgt


def reverse_library_call(G, tgt, n_out):
    """One PyTorch call computing a reverse scatter's sums from the same
    cotangent pack: ``index_add_`` of every row of G into its output row
    (one past the end for unread rows), accumulated in G's dtype; timed as
    a yardstick only, the port never calls it."""
    import torch
    Y = torch.zeros(n_out + 1, G.shape[1], dtype=G.dtype, device=G.device)
    return lambda: Y.index_add_(0, tgt, G)


def request_graph(seed):
    """One serving request: a uniform random graph of the headline size."""
    r = np.random.default_rng(seed)
    edges = np.stack([r.integers(0, NODES, EDGES),
                      r.integers(0, EDGE_TYPES, EDGES),
                      r.integers(0, NODES, EDGES)], axis=1)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=edges, annotations=ann)


def scalefree_graph(seed):
    """One serving request: a power-law graph of the headline size, its
    endpoints drawn as the port's synthetic_batch(powerlaw_alpha=1.2) draws
    them (Zipf 1.2, nodes numbered by degree rank: node 0 is the hub)."""
    r = np.random.default_rng(seed)
    w = (np.arange(NODES, dtype=np.float64) + 1.0) ** -ZIPF
    cdf = np.cumsum(w / w.sum())
    cdf[-1] = 1.0
    src = np.searchsorted(cdf, r.random(EDGES))
    dst = np.searchsorted(cdf, r.random(EDGES))
    typ = r.integers(0, EDGE_TYPES, EDGES)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=np.stack([src, typ, dst], axis=1),
                annotations=ann)


def plain_scores(pred, batch, layout):
    """Node scores of a typed pack through the port's plain path on the
    card: the same onehot step with the kernels' plain versions."""
    import torch
    import torch.nn.functional as F
    from ggnn_tpu_torch.models.ggnn import fuse_gru, init_state
    from ggnn_tpu_torch.models.heads import node_select_scores
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    cfg, params = pred.cfg, pred.params
    cdt = torch_dtype(cfg.compute_dtype)
    prop = params["prop"]
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    msg_w = prop["msg_w"].to(cdt)
    if layout.block_meta is None:
        kw = S.tile_args(layout)
        scatter = lambda hp: S.typed_onehot_scatter_reference(
            hp, msg_w=msg_w, **kw)
    else:
        kw = S.block_args(layout)
        arrs = (kw.pop("dstl_blk"), kw.pop("slot_off16"), kw.pop("blk_off16"))
        scatter = lambda hp: S.typed_block_scatter_reference(hp, *arrs, msg_w,
                                                             **kw)
    bias = S.bias_rows(layout, prop["msg_b"].to(cdt))
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    N, n_rows = h.shape[0], kw["n_blocks"] * 128
    with torch.inference_mode():
        for _ in range(cfg.n_steps):
            h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
            a = bias + scatter(h_pack)
            h_pad = F.pad(h, (0, 0, 0, n_rows - N))
            h = G.gru_cell_fwd_reference(h_pad, a, w_a, b_all, u_zr,
                                         prop["gru"]["uh"], mdt=cdt)[0][:N]
        return node_select_scores(params["head"], h, ann).cpu().numpy()


def stepwise_check(pred, batch, layout, tag, log):
    """Each propagation step of the served path (the per-tile kernels)
    against the plain step from the same input state, so that rounding
    differences do not compound over the steps: per row within 8 bf16
    ulps (f32: 1e-4) of max(1, max|a_row|), mean within 1e-3 in bf16."""
    import torch
    import torch.nn.functional as F
    from ggnn_tpu_torch.models.ggnn import (fuse_gru, gru_update, init_state,
                                            typed_fused_step)
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    cfg, prop = pred.cfg, pred.params["prop"]
    cdt = torch_dtype(cfg.compute_dtype)
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    uh = prop["gru"]["uh"]
    msg_w, msg_b = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    # the fused step rounds the gate inputs to cdt; the unfused one when
    # gru_matmul_compute asks for it
    mdt = (cdt if cdt != torch.float32 and (cfg.fuse_gru
                                             or cfg.gru_matmul_compute)
           else None)
    kw = S.tile_args(layout)
    bias = S.bias_rows(layout, msg_b)
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    N, n_rows = h.shape[0], kw["n_blocks"] * 128
    with torch.inference_mode():
        for t in range(cfg.n_steps):
            if cfg.fuse_gru:
                got = typed_fused_step(layout, h, msg_w, msg_b, w_a, b_all,
                                       u_zr, uh, cdt)
            else:
                a = S.aggregate_forward(h.to(cdt), layout, msg_w, msg_b)
                got = gru_update(prop["gru"], h, a, matmul_dtype=mdt)
            h_pack = h.to(cdt).index_select(0, layout.arrays["gather_idx"])
            a_ref = bias + S.typed_onehot_scatter_reference(
                h_pack, msg_w=msg_w, **kw)
            ref = G.gru_cell_fwd_reference(
                F.pad(h, (0, 0, 0, n_rows - N)), a_ref, w_a, b_all, u_zr, uh,
                mdt=mdt)[0][:N]
            check(f"{tag} step {t}", got, ref, "flip_rows", cdt, log,
                  a_rows=a_ref[:N].abs().amax(1).clamp_min(1.0))
            h = got


def typed_layout(pred, batch):
    """The typed pack of a request over the dst space rounded up to the
    128-row grid (block mode where it engages), built by the caller and
    handed to ``Predictor.run_batch``."""
    from ggnn_tpu_torch.ops.scatter import _rup_block, build_typed_dst_layout
    return build_typed_dst_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        _rup_block(batch.spec.n_pad),
        n_message_types=2 * batch.spec.n_edge_types).to("cuda")


def plain_run(pred, batch, layout, keep=()):
    """Node scores of any layout through the port's plain path on the card:
    ``Predictor.run_batch`` with every kernel call routed to its plain
    version (but those named in ``keep``)."""
    with plain_versions(keep):
        return pred.run_batch(batch, layout)


def serve(params, fuse, graphs, plain_cache, per_request, tag="serve",
          stepwise=False, layout_fn=typed_layout, plain_fn=None,
          label=None, cfg_kw=None):
    """Requests through Predictor (host batching, layout from
    ``layout_fn``, device forward), the launch counts against
    ``per_request`` (kernel -> launches per request; every other kernel 0)
    and every request's scores against the plain path (``plain_fn``, by
    default :func:`plain_scores` of the typed pack).  ``stepwise`` (a
    power-law graph): a hub row aggregates |a| up to 4e5, so the rounding
    of its sums moves its state by about 1e-3 even in f32, and every node
    reads the hub in the next step: over 5 steps two faithful paths drift
    apart by percents.  Each request is then checked step by step
    (:func:`stepwise_check`), and the drift of its scores is reported."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.config import ModelConfig
    cfg = ModelConfig(**{**dict(
        state_dim=DIM, annotation_dim=ANN, n_edge_types=EDGE_TYPES,
        n_steps=STEPS, head="node_select", backend="onehot",
        compute_dtype="bfloat16", fuse_gru=fuse), **(cfg_kw or {})})
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    pred = Predictor(cfg, spec, params=params, device="cuda")
    plain_fn = plain_fn or plain_scores
    mode = label or ("fused" if fuse else "unfused")
    results = []
    zero_counts()
    for seed, g in graphs:
        t0 = time.perf_counter()
        batch = batch_graphs([g], spec)
        layout = layout_fn(pred, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scores = pred.run_batch(batch, layout)
        t2 = time.perf_counter()
        answer = pred.decode(scores, batch, 1)[0]
        results.append((seed, batch, layout, scores, answer, t1 - t0,
                        t2 - t1))
    launches = read_counts()
    print(f"[{tag}] {mode}: launches on the serving path {launches}",
          flush=True)
    expect_counts(f"{tag} {mode}", launches,
                  {k: v * len(graphs) for k, v in per_request.items()})
    for seed, batch, layout, scores, answer, prep_s, dev_s in results:
        if scores.shape != (NODES,) or not np.isfinite(scores).all():
            raise AssertionError(f"request {seed}: bad scores")
        if seed not in plain_cache:
            plain_cache[seed] = plain_fn(pred, batch, layout)
        ref = plain_cache[seed]
        d = np.abs(scores - ref)
        emax, emean = float(d.max()), float(d.mean())
        norm = max(float(np.linalg.norm(ref)), 1e-30)
        rf = float(np.linalg.norm(scores - ref)) / norm
        if stepwise:
            (stepwise if callable(stepwise) else stepwise_check)(
                pred, batch, layout, f"{tag} {mode} seed={seed}", {})
            ok = ok_answer = True
            crit = "reported only; checked step by step"
        else:
            ok = emax <= TOL_FLIP_MAX and emean <= TOL_FLIP_MEAN
            # the answer must be a top node of the plain path too (ties
            # within the tolerance may pick another node)
            ok_answer = ref[answer] >= ref.max() - TOL_FLIP_MAX
            crit = (f"tol {TOL_FLIP_MAX:.3e}/{TOL_FLIP_MEAN:.0e}")
        rate = 2 * EDGES * STEPS / dev_s
        print(f"[{tag}] {mode} request seed={seed}: answer node {answer} "
              f"(plain argmax {int(np.argmax(ref))}), scores max_abs_err "
              f"{emax:.3e} mean_abs_err {emean:.3e} rel_frobenius {rf:.3e} "
              f"({crit}) {'ok' if ok and ok_answer else 'FAIL'}; latency "
              f"{prep_s + dev_s:.3f} s = host batch+layout {prep_s:.3f} s + "
              f"device forward {dev_s * 1e3:.2f} ms; "
              f"{rate:.4e} directed-edges*T/s", flush=True)
        if not (ok and ok_answer):
            raise AssertionError(f"{mode} request {seed}: scores disagree "
                                 "with the plain path")
    return launches


def kernel_wrappers():
    """The kernel wrappers by name (each counts its launches in
    ``.launches``; #13's emit_res form in ``window_step_gru.res_launches``,
    read through :func:`counter`)."""
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import segment_rows as SR
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    return {"typed_block_scatter": S.typed_block_scatter,
            "typed_block_step_gru": S.typed_block_step_gru,
            "gru_cell_fwd": G.gru_cell_fwd, "gru_cell_bwd": G.gru_cell_bwd,
            "typed_grad_octet_scatter": S.typed_grad_octet_scatter,
            "typed_onehot_scatter": S.typed_onehot_scatter,
            "typed_step_gru": S.typed_step_gru,
            "window_block_spmm_mono": W.window_block_spmm_mono,
            "onehot_segment_scatter_flat": L.onehot_segment_scatter_flat,
            "onehot_segment_scatter": L.onehot_segment_scatter,
            "node_table_block_major": TB.node_table_block_major,
            "window_block_spmm_ondemand": W.window_block_spmm_ondemand,
            "window_step_gru": W.window_step_gru,
            "node_table_block_major_q8": TB.node_table_block_major_q8,
            "window_step_gru[emit_res]": W.window_step_gru,
            "window_bwd_fused": W.window_bwd_fused,
            "packed_messages": SP.packed_messages,
            "sddmm_pallas": SP.sddmm_pallas,
            "onehot_segment_scatter_stream": L.onehot_segment_scatter_stream,
            "onehot_segment_scatter_loopT": L.onehot_segment_scatter_loopT,
            "window_block_spmm": W.window_block_spmm,
            "segment_rows_sum": SR.segment_rows_sum}


def counter(name):
    """The attribute of the wrapper that counts kernel ``name``."""
    return "res_launches" if name.endswith("[emit_res]") else "launches"


def zero_counts():
    for k, fn in kernel_wrappers().items():
        setattr(fn, counter(k), 0)


def read_counts():
    return {k: getattr(fn, counter(k))
            for k, fn in kernel_wrappers().items()}


def expect_counts(tag, launches, want):
    """Every kernel's launches against ``want`` (kernel -> launches; every
    other TPU kernel 0; a PORT_ONLY kernel only where ``want`` names
    it)."""
    full = {k: want.get(k, 0) for k in KERNELS
            if k in want or k not in PORT_ONLY}
    launches = {k: v for k, v in launches.items() if k in full}
    if launches != full:
        raise AssertionError(f"{tag}: launches {launches}, expected {full}")


@contextlib.contextmanager
def plain_versions(keep=()):
    """Route the model's kernel calls to their plain versions (the same
    function, the same rounding points) for the plain path on the card;
    the kernels named in ``keep`` stay."""
    from ggnn_tpu_torch.models import ggnn as M
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import segment_rows as SR
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.ops import window_step as WS
    swaps = [(SP, "packed_messages", SP.packed_messages_reference),
             (SR, "segment_rows_sum", SR.segment_rows_sum_reference),
             (SP, "sddmm_pallas", SP.sddmm_pallas_reference),
             (L, "onehot_segment_scatter_flat",
              L.onehot_segment_scatter_flat_reference),
             (L, "onehot_segment_scatter", L.onehot_segment_scatter_reference),
             (L, "window_block_spmm_mono", W.window_block_spmm_mono_reference),
             (TB, "node_table_block_major",
              TB.node_table_block_major_reference),
             (S, "typed_block_scatter", S.typed_block_scatter_reference),
             (S, "typed_grad_octet_scatter",
              S.typed_grad_octet_scatter_reference),
             (S, "typed_onehot_scatter", S.typed_onehot_scatter_reference),
             (S, "window_block_spmm_mono",
              W.window_block_spmm_mono_reference),
             (M, "gru_cell_fwd", G.gru_cell_fwd_reference),
             (M, "gru_cell_bwd", G.gru_cell_bwd_reference),
             (W, "window_block_spmm_mono",
              W.window_block_spmm_mono_reference),
             (W, "window_block_spmm_ondemand",
              W.window_block_spmm_ondemand_reference),
             (W, "window_step_gru", W.window_step_gru_reference),
             (W, "window_bwd_fused", W.window_bwd_fused_reference),
             (WS, "gru_cell_bwd", G.gru_cell_bwd_reference),
             (TB, "node_table_block_major_q8",
              TB.node_table_block_major_q8_reference)]
    swaps = [x for x in swaps if x[1] not in keep]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def headline_cfg(**kw):
    from ggnn_tpu_torch.models.config import ModelConfig
    kw.setdefault("backend", "onehot")
    return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                       n_edge_types=EDGE_TYPES, n_steps=STEPS,
                       head="node_select", **kw)


def fresh_params(cfg):
    """The headline model's parameters from seed 0, trainable, on the
    card."""
    import torch
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.train.loop import param_leaves
    params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params


def train_headline(batch, layout, modes, tag="train", f32_check=True,
                   stepwise=False, steps=3, grad_tol=None, cfg_fn=None,
                   n_graphs=1, targets=None):
    """``steps`` Adam steps of the headline model per mode through
    make_train_step; ``modes``: mode -> (config fields, kernel -> launches
    per step; every other kernel 0).  The first step is held to the plain
    path.  ``stepwise`` (a power-law graph): a hub row's GRU sees |a| up to
    4e5, whose rounding decides which of its gates sit off saturation, and
    the hub's cotangent reaches every node; the gradients of 5 steps of two
    faithful paths then differ by O(1) there, so only the loss is held to
    the plain path, the gradients are reported, and the aggregation's VJP
    is held to it instead (:func:`vjp_aggregate_check`).  ``cfg_fn``
    (fields -> ModelConfig; :func:`headline_cfg` by default), ``n_graphs``
    and ``targets`` (the batch's target tensors; a node_select target from
    seed 0 by default) serve other heads.  Returns the launch counts of
    those runs."""
    import torch
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step, param_leaves)
    arrays = batch_arrays(batch, "cuda")
    if targets is None:
        target = int(np.random.default_rng(0).integers(0, NODES))
        targets = {"node": torch.tensor([target], dtype=torch.int32,
                                        device="cuda")}
    arrays["targets"] = targets
    cfg_fn = cfg_fn or headline_cfg
    total = dict.fromkeys(KERNELS, 0)
    for mode, (extra, per_step) in modes.items():
        cfg = cfg_fn(compute_dtype="bfloat16", **extra)
        params = fresh_params(cfg)
        opt = make_optimizer(params, 1e-3)
        step = make_train_step(cfg, n_graphs, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        events, losses, grads1 = [], [], None
        for i in range(steps):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            m = step(params, arrays, layout)
            ev[1].record()
            events.append(ev)
            losses.append(m["loss_sum"] / m["count"])
            if i == 0:
                grads1 = {k: p.grad.detach().clone()
                          for k, p in _flatten(params)}
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ms = [a.elapsed_time(b) for a, b in events]
        losses = [float(x) for x in losses]
        print(f"[{tag}] {mode}: losses {[f'{x:.6f}' for x in losses]}; "
              f"step ms {[f'{x:.2f}' for x in ms]} (median "
              f"{statistics.median(ms):.2f}, spread {max(ms) - min(ms):.2f}); "
              f"peak device memory {peak:.2f} GiB; launches over {steps} "
              f"steps {launches}", flush=True)
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {mode}: non-finite loss {losses}")
        expect_counts(f"{tag} {mode}", launches,
                      {k: v * steps for k, v in per_step.items()})
        for k in total:
            total[k] += launches[k]
        compare_first_step(f"{tag} {mode}", cfg, arrays, layout, grads1,
                           losses[0], strict=not stepwise, tol=grad_tol,
                           n_graphs=n_graphs)
        if stepwise:
            vjp_aggregate_check(f"{tag} {mode}", cfg, arrays, layout)
        del params, opt, step, grads1
        torch.cuda.empty_cache()
    if f32_check:
        # the same first step in f32 (fused: the scatter and reverse
        # scatter kernels in f32), where nothing rounds to bf16, against
        # its plain path
        cfg = headline_cfg(compute_dtype="float32", fuse_gru=True)
        params = fresh_params(cfg)
        loss, _ = loss_and_metrics(params, cfg, arrays, 1,
                                   scatter_layout=layout)
        grads = dict(zip([k for k, _ in _flatten(params)],
                         torch.autograd.grad(loss, param_leaves(params))))
        compare_first_step(f"{tag} fused f32", cfg, arrays, layout, grads,
                           float(loss.detach()))
    return total


def compare_first_step(mode, cfg, arrays, layout, grads, loss_k,
                       strict=True, tol=None, n_graphs=1):
    """The first step's loss and gradient leaves against the same step
    through the kernels' plain versions on the card (``strict=False``: the
    loss is held to its bound, the gradients reported only; ``tol``: the
    leaves' bound in place of TOL_TRAIN's)."""
    import torch
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import param_leaves
    params = fresh_params(cfg)
    with plain_versions():
        loss, _ = loss_and_metrics(params, cfg, arrays, n_graphs,
                                   scatter_layout=layout)
        gp = torch.autograd.grad(loss, param_leaves(params))
    loss = float(loss.detach())
    tol_leaf, tol_loss = TOL_TRAIN[cfg.compute_dtype]
    tol = tol_leaf if tol is None else tol
    dl = abs(loss_k - loss) / max(abs(loss), 1e-30)
    total = torch.stack([g.double().norm() for g in gp]).norm().item()
    errs, sym = [], 0.0
    for (key, _), g_ref in zip(_flatten(params), gp):
        got = grads[key]
        if not torch.isfinite(got).all():
            raise AssertionError(f"train {mode}: non-finite grad {key}")
        if key in SYMMETRIC_LEAVES:
            sym = max(sym, got.double().norm().item() / total,
                      g_ref.double().norm().item() / total)
            continue
        errs.append((relfro(got, g_ref), key))
    errs.sort(reverse=True)
    ok = dl <= tol_loss and errs[0][0] <= tol and sym <= TOL_SYMMETRIC
    worst = ", ".join(f"{k} {e:.3e}" for e, k in errs[:3])
    print(f"[train] {mode} step 1 vs plain path: loss {loss_k:.6f} vs "
          f"{loss:.6f} (rel {dl:.3e}, tol {tol_loss:.0e}); worst gradient "
          f"leaves (rel_frobenius, tol {tol:.3e}): {worst}; median leaf "
          f"{statistics.median(e for e, _ in errs):.3e}; "
          f"{'/'.join(SYMMETRIC_LEAVES)} {sym:.3e} of the gradient's norm "
          f"{total:.4e} (tol {TOL_SYMMETRIC:.0e}) "
          f"{('ok' if ok else 'FAIL') if strict else '(reported only)'}",
          flush=True)
    if not strict:
        ok = dl <= tol_loss
    if not ok:
        raise AssertionError(f"train {mode}: first step disagrees with the "
                             "plain path")


def grad_row_terms(layout, n_nodes, T2):
    """The number of cotangent rows the legacy grad layout sums into each
    node's row of dh (over all message types)."""
    import torch
    from ggnn_tpu_torch.ops import scatter as S
    arrs = layout.arrays
    if "g_dstl" not in arrs:
        raise AssertionError("the legacy grad layout has no g_dstl stream")
    win = arrs["g_tile_msg_off"].long()
    rows = arrs["g_dstl"][:win.shape[0]].long()
    valid = (rows >= 0) & (win >= 0)[:, None]
    cnt = torch.zeros(S.grad_meta(layout)[0] * 128, device=rows.device)
    idx = (arrs["g_block_of_tile"].long()[:, None] * 128 + rows)[valid]
    cnt.index_add_(0, idx, torch.ones(idx.shape[0], device=rows.device))
    return (cnt[:T2 * n_nodes].reshape(n_nodes // 128, T2, 128).sum(1)
            .reshape(n_nodes))


def vjp_aggregate_check(mode, cfg, arrays, layout):
    """The aggregation's VJP through the kernels (the per-tile forward and
    the reverse scatter of the legacy grad layout) against the same VJP
    through their plain versions, from the same input state (the kernel
    path's state after two steps) and the same random cotangent: dh, dW
    and db within TOL_TRAIN's relative Frobenius bound, and dh per row over
    the rows of at most HUB_TERMS terms (see the tolerances above).  The
    aggregation is linear, so this holds the kernels to the plain path
    where the GRU of a hub row cannot (see :func:`train_headline`)."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import scatter as S
    params = fresh_params(cfg)
    prop = params["prop"]
    cdt = torch_dtype(cfg.compute_dtype)
    edges = [arrays[k] for k in ("edge_src", "edge_dst", "edge_type",
                                 "edge_mask")]
    with torch.no_grad():
        h_in = propagate(prop, dataclasses.replace(cfg, n_steps=2),
                         arrays["annotations"], *edges,
                         scatter_layout=layout)
    gen = torch.Generator(device="cuda").manual_seed(5)
    da = torch.randn(h_in.shape, device="cuda", generator=gen)

    def grads():
        xs = [t.detach().to(cdt).requires_grad_(True)
              for t in (h_in, prop["msg_w"], prop["msg_b"])]
        out = S.aggregate_onehot(*xs[:1], layout, *xs[1:])
        return torch.autograd.grad((out * da).sum(), xs)

    got = grads()
    with plain_versions():
        ref = grads()
    tol = TOL_TRAIN[cfg.compute_dtype][0]
    tol_rows = TOL_RELF_BF16 if cdt == torch.bfloat16 else TOL_RELF_F32
    errs = [(relfro(a, b), k) for k, a, b in zip(("dh", "dW", "db"), got,
                                                  ref)]
    terms = grad_row_terms(layout, h_in.shape[0], prop["msg_w"].shape[0])
    small = terms <= HUB_TERMS
    dh, dh_ref = got[0][small].double(), ref[0][small].double()
    row_err = ((dh - dh_ref).norm(dim=1)
               / dh_ref.norm(dim=1).clamp_min(1e-30)).max().item()
    rows_rf = relfro(dh, dh_ref)
    ok = (max(errs)[0] <= tol and row_err <= tol and rows_rf <= tol_rows
          and all(torch.isfinite(a).all() for a in got))
    print(f"[train] {mode} the aggregation's VJP vs plain path (input state "
          f"after 2 steps, random cotangent): rel_frobenius "
          + ", ".join(f"{k} {e:.3e}" for e, k in errs)
          + f" (tol {tol:.3e}); dh over the {int(small.sum())} rows of at "
          f"most {HUB_TERMS} terms (of {small.numel()}, up to "
          f"{int(terms.max())}): worst row {row_err:.3e} (tol {tol:.3e}), "
          f"rel_frobenius {rows_rf:.3e} (tol {tol_rows:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"train {mode}: the aggregation's VJP disagrees "
                             "with the plain path")


# The Trainer CLI in a child process, as a user runs it, reporting the
# launch counts of its process on stderr when it ends.
TRAINER_CHILD = """
import json, runpy, sys
sys.argv = ["ggnn_tpu_torch.train"] + sys.argv[1:]
try:
    runpy.run_module("ggnn_tpu_torch.train", run_name="__main__")
finally:
    from ggnn_tpu_torch.ops import (gru, legacy, scatter, segment_rows, spmm,
                                    table, window)
    fns = [gru.gru_cell_fwd, gru.gru_cell_bwd, legacy.onehot_segment_scatter,
           legacy.onehot_segment_scatter_flat,
           table.node_table_block_major, window.window_block_spmm_mono,
           scatter.typed_block_scatter, scatter.typed_block_step_gru,
           scatter.typed_grad_octet_scatter, scatter.typed_onehot_scatter,
           scatter.typed_step_gru, spmm.packed_messages, spmm.sddmm_pallas,
           segment_rows.segment_rows_sum]
    print("LAUNCHES " + json.dumps({f.__name__: f.launches for f in fns}),
          file=sys.stderr)
"""


def run_trainers(*runs):
    """Each of ``runs`` (keyword dicts of :func:`run_trainer`) in its own
    child process, all started together (bAbI's small batches leave the
    card mostly idle); returns their launch counts, in order."""
    started = []
    for kw in runs:
        backend = kw.get("backend", "xla")
        args = ["--config", kw.get("config", "babi4"), "--device", "cuda",
                "--epochs", "3"]
        if backend != "xla":
            args += ["--backend", backend]
        args += list(kw.get("extra", ()))
        proc = subprocess.Popen([sys.executable, "-c", TRAINER_CHILD, *args],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((proc, args, backend, kw.get("want", ()),
                        time.perf_counter()))
    out = []
    try:
        for proc, args, backend, want, t0 in started:
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"Trainer CLI failed ({proc.returncode})"
                                     f":\n{stderr[-4000:]}")
            result = json.loads(stdout.strip().splitlines()[-1])
            launches = json.loads(next(
                line for line in stderr.splitlines()
                if line.startswith("LAUNCHES "))[len("LAUNCHES "):])
            print(f"[trainer] python -m ggnn_tpu_torch.train "
                  f"{' '.join(args)}: {result} in "
                  f"{time.perf_counter() - t0:.1f} s"
                  f"{'' if len(runs) == 1 else f' (one of {len(runs)} at once)'}"
                  f"; launches { {k: v for k, v in launches.items() if v} }",
                  flush=True)
            if not np.isfinite(result["test_loss"]):
                raise AssertionError("Trainer: non-finite test loss")
            for k in want:
                if not launches[k]:
                    raise AssertionError(f"Trainer --backend {backend}: {k} "
                                         "was never launched")
            out.append(launches)
    finally:
        for proc, *_ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def run_trainer(backend="xla", want=(), config="babi4", extra=()):
    """``python -m ggnn_tpu_torch.train --config babi4 --device cuda
    --epochs 3 [--backend ...] [extra ...]`` in a child process (on bAbI
    task 4, or the task of ``config``, as a user runs it); ``want``: the
    kernels it must have launched.  Returns the child's launch counts."""
    return run_trainers(dict(backend=backend, want=want, config=config,
                             extra=extra))[0]


def scalefree_phase(params, log, timings):
    """[scalefree]: the headline model on a power-law graph of the headline
    size, where block mode and the octet grad layout decline: the per-tile
    kernels and the window kernel against their plain versions (fuzz
    layouts and the headline), timed; one request served fused and
    unfused; 3 Adam steps trained fused and unfused; then [scalefree
    window] (#12 on bench.py's scalefree_fwd_window layout and its unfused
    request).  Returns the launch counts of the serving and training
    runs."""
    import torch
    scalefree_fuzz(params, log)
    b, lay = scalefree_headline(params, log, timings)
    from ggnn_tpu_torch.ops.legacy import layout_for_batch
    check_legacy_kernels("scalefree legacy",
                         layout_for_batch(b, with_grad=False, device="cuda"),
                         NODES, log, params=params, report_f32=True)
    torch.cuda.empty_cache()

    graphs = [(seed, scalefree_graph(seed)) for seed in EARLIER_REQUESTS]
    plain_cache = {}
    launched = dict.fromkeys(KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    for fuse, per_request in (
            (True, {"typed_step_gru": STEPS}),
            (False, {"typed_onehot_scatter": STEPS, "gru_cell_fwd": STEPS})):
        for k, v in serve(params, fuse, graphs, plain_cache, per_request,
                          tag="scalefree serve", stepwise=True).items():
            launched[k] += v
    print(f"[scalefree serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    graph = dict(graphs)[0]
    del graphs, plain_cache
    torch.cuda.empty_cache()

    fused = {"typed_onehot_scatter": STEPS, "window_block_spmm_mono": STEPS}
    unfused = dict(fused, gru_cell_fwd=STEPS, gru_cell_bwd=STEPS)
    trained = train_headline(b, lay, {
        "fused": (dict(fuse_gru=True), fused),
        "unfused": (dict(fuse_gru=False), unfused)},
        tag="scalefree train", f32_check=False, stepwise=True)
    for k, v in trained.items():
        launched[k] += v
    del lay, b
    torch.cuda.empty_cache()
    for k, v in scalefree_window_phase(params, log, graph).items():
        launched[k] += v
    return launched


def scalefree_fuzz(params, log):
    """[scalefree] on small layouts where block mode declines: uniform with
    block mode off, span mode, a small chunk cap, empty blocks, tile_e 16
    and 144 (#6's chunks of 128 rows cut short), a hub (twice: the second
    with |a| ≤ 1); the per-tile kernels and #11 on the grad half."""
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    r = np.random.default_rng(9)
    fuzz = {
        # tag: (nodes, edges, types, dst range, hub, layout kwargs)
        "block_mode_off": (640, 9000, 6, 640, False, dict(block_mode=False)),
        "span": (640, 9000, 5, 640, False, dict(block_mode=False,
                                                span_mode=True)),
        "small_chunk_cap": (640, 9000, 5, 640, False,
                            dict(block_mode=False, smem_tile_cap=5)),
        "empty_blocks_tiles": (1024, 3000, 4, 512, False,
                               dict(block_mode=False)),
        "tile_e 16": (640, 9000, 6, 640, False,
                      dict(block_mode=False, tile_e=16)),
        "hub": (4096, 60000, 4, 4096, True, dict(tile_e=128,
                                                 grad_tile_e=128)),
        "hub, tile_e 144": (4096, 60000, 6, 4096, True,
                            dict(tile_e=144, grad_tile_e=128)),
    }
    for tag, (n, e, t2, dst_hi, hub, kw) in fuzz.items():
        src, dst = r.integers(0, n, e), r.integers(0, dst_hi, e)
        if hub:     # most edges into 64 dst rows and out of 16 src rows
            dst = np.where(r.random(e) < 0.9, r.integers(0, 64, e), dst)
            src = np.where(r.random(e) < 0.9, r.integers(0, 16, e), src)
        lay = build_typed_dst_layout(
            src, dst, r.integers(0, t2, e),
            (r.random(e) < 0.9).astype(np.float32), n, t2, with_grad=True,
            **kw)
        if lay.block_meta is not None or lay.meta[5][0] == "octet":
            raise AssertionError(f"{tag}: block mode or the octet layout "
                                 "engaged")
        lay = lay.to("cuda")
        check_tile_kernels(tag, lay, params, log)
        if tag == "hub":  # the split blocks' fused epilogue at 8 ulps a row
            check_tile_kernels(f"{tag}, |a| <= 1", lay, params, log,
                               a_max=1.0)
        check_window_kernel(tag, lay, log)
    check_count_stream(log)


def scalefree_headline(params, log, timings):
    """The scale-free headline batch (Zipf 1.2, 262,144 nodes, 8M directed
    edges) and its typed layout built with its grad half, on the card, with
    the per-tile kernels and #11 checked and timed there.  Returns (batch,
    layout)."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128, powerlaw_alpha=ZIPF)
    t1 = time.perf_counter()
    lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                 b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES,
                                 with_grad=True)
    t2 = time.perf_counter()
    chunks = lay.meta[8]
    print(f"[scalefree] Zipf {ZIPF} batch made in {t1 - t0:.2f} s; typed "
          f"layout with its grad half built on the host in {t2 - t1:.2f} s; "
          f"tile_e {lay.meta[1]}, block mode {lay.meta[10]}, span rows "
          f"{lay.meta[9]}, chunks {chunks}, grad_meta {lay.meta[5]}",
          flush=True)
    if lay.block_meta is not None or lay.meta[5][0] == "octet" \
            or chunks is None or len(chunks) < 2:
        raise AssertionError("scalefree: block mode or the octet layout "
                             "engaged, or the layout is not chunked")
    lay = lay.to("cuda")
    check_tile_kernels("scalefree", lay, params, log, timings)
    # #6's split blocks, the hub's 698 items included, at 8 ulps a row
    check_tile_kernels("scalefree, |a| <= 1", lay, params, log, a_max=1.0,
                       dtypes=(torch.bfloat16,))
    check_window_kernel("scalefree", lay, log, timings)
    torch.cuda.empty_cache()
    return b, lay


def scalefree_window_phase(params, log, graph=None):
    """[scalefree window]: a scale-free request (``graph``, by default
    :func:`scalefree_graph` of seed 0) through run_batch unfused on
    bench.py's scalefree_fwd_window layout (bench.py:192-244 with
    --powerlaw 1.2 --on_demand: W 512, block_rows 128, on-demand windows,
    the XW spill), which the request's layout_fn builds from its batch:
    #12, the spill's #11 and the GRU cell per step, each step against the
    plain step; then on that layout #12 against its plain version per
    element and twice bit-equal, its work items, timed with its bound.
    Returns the request's launch counts."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    t0 = time.perf_counter()
    graph = scalefree_graph(0) if graph is None else graph
    built = {}

    def layout_fn(pred, batch):
        built["lay"] = bench_window_layout(batch, 128, True, True).to("cuda")
        return built["lay"]
    launches = serve(
        params, False, [(0, graph)], {},
        dict(window_block_spmm_ondemand=STEPS, window_block_spmm_mono=STEPS,
             gru_cell_fwd=STEPS), tag="scalefree window serve",
        layout_fn=layout_fn, plain_fn=plain_run, label="on-demand, unfused",
        stepwise=window_unfused_stepwise, cfg_kw=dict(backend="window"))
    lay = built.pop("lay")
    a = lay.arrays
    nb, rows, W_ = lay.n_blocks, lay.block_rows, lay.window
    n_c = a["c_stream"].shape[0] // rows
    item_first, _, rt_start, _, split, n_items, n_part = W.ondemand_items(
        a["tile_start"], a["win_of_tile"], a["c_off"], n_c, nb)
    per = (rt_start[1:] - rt_start[:-1]).long()
    big = int(per.argmax().item())
    n_real = int(per.sum().item())
    print(f"[scalefree window] request served and checked in "
          f"{time.perf_counter() - t0:.2f} s; layout stats {lay.stats}; "
          f"{nb} blocks, {n_real} real tiles, the largest block ({big}) "
          f"{int(per[big].item())}, {int((per == 0).sum().item())} blocks "
          f"without one; {n_items} work items of at most "
          f"{W.ONDEMAND_SPLIT} tiles, {split.numel()} blocks split into "
          f"{n_part} partials", flush=True)
    w, bias, _ = window_weights(params, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(29)
    h = (torch.rand(lay.n_nodes_pad, DIM, device="cuda", generator=gen)
         * 2 - 1).to(torch.bfloat16)
    stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
              a["win_of_tile"])
    args = (h, w, bias, *stream, a["c_off"], nb, W_, rows)
    got = W.window_block_spmm_ondemand(*args)
    same_twice("window_block_spmm_ondemand", "scalefree", got,
               W.window_block_spmm_ondemand(*args))
    lay_args = (a["c_stream"], a["block_of_tile"], a["win_of_tile"],
                a["c_off"], nb, False)
    check("window_block_spmm_ondemand[scalefree,bfloat16]", got,
          W.window_block_spmm_ondemand_reference(*args), "bound",
          torch.bfloat16, log, bound=window_sums_bound(
              h, lay_args, W_, rows, msg_w=w, msg_b=bias, flip=True))
    del got
    nnz = int((a["c_stream"] != 0).sum().item())
    local = {}
    time_pairs({"window_block_spmm_ondemand": (
        lambda: W.window_block_spmm_ondemand(*args),
        lambda: W.window_block_spmm_ondemand_reference(*args), None,
        roofline(n_real * rows * W_
                 + ondemand_h_bytes(a["win_of_tile"], W_, w.shape[0])
                 + nb * rows * DIM * 4 + nbytes(w, bias, a["win_of_tile"],
                                                a["c_off"]),
                 [(2 * nnz * DIM, BF16_FLOPS),
                  (2 * n_real * W_ * DIM * DIM, BF16_FLOPS)]))}, local)
    print(f"[scalefree window] #12 on the scale-free layout: "
          f"{json.dumps(local)}", flush=True)
    del args, h, lay
    torch.cuda.empty_cache()
    return launches


def window_unfused_stepwise(pred, batch, layout, tag, log):
    """Each unfused window step of a served request (``aggregate_window``,
    then the GRU cell) against the plain step from the same input state:
    per row within 8 bf16 ulps of max(1, max|a_row|), mean within 1e-3 (a
    power-law graph's hub rows make the steps' drift compound, see
    :func:`serve`)."""
    import torch
    from ggnn_tpu_torch.models.ggnn import gru_update, init_state
    from ggnn_tpu_torch.ops import window_step as WS
    cfg, prop = pred.cfg, pred.params["prop"]
    cdt = torch.bfloat16
    gmm = cdt if cfg.gru_matmul_compute else None
    w, b = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    ann = torch.as_tensor(batch.annotations, device="cuda")
    h = init_state(ann, cfg.state_dim)
    with torch.inference_mode():
        for t in range(cfg.n_steps):
            a = WS.aggregate_window(h.to(cdt), layout, w, b)
            got = gru_update(prop["gru"], h, a, matmul_dtype=gmm)
            with plain_versions():
                a_ref = WS.aggregate_window(h.to(cdt), layout, w, b)
                ref = gru_update(prop["gru"], h, a_ref, matmul_dtype=gmm)
            check(f"{tag} step {t}", got, ref, "flip_rows", cdt, log,
                  a_rows=a_ref.abs().amax(1).clamp_min(1.0))
            h = got


def table_bound(h, w, b, ref, dtype):
    """The per-element bound of |node_table_block_major − its plain
    version|: 1e-5 of the element's Σ|h_k·W_kf| + |b_f| (f32 sums in
    another order), plus in bf16 one ulp of the rounded value,
    2**-7·|ref|."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    bound = 1e-5 * TB.node_table_block_major_reference(
        h.float().abs(), w.float().abs(), b.float().abs())
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * ref.float().abs()
    return bound


def legacy_targets(arrs, n_blocks, tile_e):
    """For every row of a legacy layout's message pack, the output row it
    adds to (n_blocks·128, one past the end, for padding rows)."""
    import torch
    dl = arrs["dst_local"].long()
    e = torch.arange(dl.shape[0], device=dl.device)
    blk = torch.searchsorted(arrs["tile_start"][1:].contiguous(),
                             (e // tile_e).int(), right=True)
    return torch.where(dl >= 0, blk * 128 + dl,
                       torch.full_like(dl, n_blocks * 128))


def f32_atomic_sum(msgs, tgt, n_out):
    """The legacy scatter's sums as one f32 ``index_add_`` (float atomics
    into each output row): what the plain versions computed before they
    summed in f64, reported beside them at a hub."""
    import torch
    out = torch.zeros(n_out + 1, msgs.shape[1], device=msgs.device)
    return out.index_add_(0, tgt, msgs.float())[:n_out]


def check_legacy_kernels(tag, lay, n_src, log, params=None, timings=None,
                         dims=(DIM,), seed=4, T2=2 * EDGE_TYPES,
                         report_f32=False):
    """The legacy forward's kernels against their plain versions at a
    legacy layout's shapes, each twice (bit-equal): the table (#10, where
    the rows are block-major; else the plain 'type' einsum feeds the
    scatters), #8 on the one-hot stream where there is one, #9 on the
    dst-local ids, held per element ('bound').  Blocks with no real edge
    must come out exactly 0.  ``params``: the model's weights at D = 128
    (else random); ``timings``: time them in bf16 at D = 128;
    ``report_f32``: report how far one f32 ``index_add_`` of the same
    messages lies from the plain version's f64 sums (a hub row)."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import table as TB
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    meta, arrs = lay.meta, lay.arrays
    _, tile_e, max_tiles, n_blocks, has_onehot, _, _, order = meta
    n_tiles = arrs["block_of_tile"].shape[0]
    real = arrs["dst_local"].reshape(n_tiles, tile_e) >= 0
    per_block = torch.zeros(n_blocks, device=dev).index_add_(
        0, arrs["block_of_tile"].long(), real.sum(1).float())
    empty = per_block == 0
    sizes = arrs["tile_start"][1:] - arrs["tile_start"][:-1]
    print(f"[legacy kernels] {tag}: tile_e={tile_e} n_blocks={n_blocks} "
          f"tiles={n_tiles} (max_tiles {max_tiles}, the largest block "
          f"{int(sizes.max().item())}), {int((~real.any(1)).sum().item())} "
          f"all-padding tiles, {int(empty.sum().item())} empty blocks, "
          f"row order {order}, one-hot stream {has_onehot}", flush=True)
    for D in dims:
        for dtype in (torch.bfloat16, torch.float32):
            dn = f"{str(dtype).split('.')[-1]},D={D}"
            h = (torch.rand(n_src, D, device=dev, generator=gen) * 2
                 - 1).to(dtype)
            if params is not None and D == DIM:
                w = params["prop"]["msg_w"][:T2].detach().to(dtype)
                b = params["prop"]["msg_b"][:T2].detach().to(dtype)
            else:
                w = (torch.randn(T2, D, D, device=dev, generator=gen)
                     * D ** -0.5).to(dtype)
                b = (torch.randn(T2, D, device=dev, generator=gen)
                     * 0.1).to(dtype)
            if order == "block":
                tab = TB.node_table_block_major(h, w, b)
                same_twice("node_table_block_major", f"{tag},{dn}", tab,
                           TB.node_table_block_major(h, w, b))
                ref = TB.node_table_block_major_reference(h, w, b)
                check(f"node_table_block_major[{tag},{dn}]", tab, ref,
                      "bound", dtype, log,
                      bound=table_bound(h, w, b, ref, dtype))
                del ref
            else:
                tab = TB.node_table(h, w, b, order)
            msgs = tab.index_select(0, arrs["gather_idx"])
            if report_f32 and D == DIM:
                plain = L.onehot_segment_scatter_reference(
                    msgs, arrs["dst_local"], arrs["tile_start"], n_blocks,
                    max_tiles, tile_e)
                d = (f32_atomic_sum(msgs, legacy_targets(
                    arrs, n_blocks, tile_e), n_blocks * 128) - plain).abs()
                i = int(d.argmax().item())
                print(f"  [{tag},{dn}] one f32 index_add_ (float atomics) "
                      f"against the plain version's f64 sums: max "
                      f"{d.max().item():.4e} at row {i // D} (value "
                      f"{plain.reshape(-1)[i].item():.6e}); mean "
                      f"{d.mean().item():.3e}", flush=True)
                del plain, d
            scat = {}
            if has_onehot:
                args = (arrs["onehot"], arrs["tile_start"],
                        arrs["block_of_tile"], n_blocks, tile_e)
                scat["onehot_segment_scatter_flat"] = (
                    lambda m, a=args: L.onehot_segment_scatter_flat(m, *a),
                    lambda m, a=args: L.onehot_segment_scatter_flat_reference(
                        m, *a))
            args = (arrs["dst_local"], arrs["tile_start"], n_blocks,
                    max_tiles, tile_e)
            scat["onehot_segment_scatter"] = (
                lambda m, a=args: L.onehot_segment_scatter(m, *a),
                lambda m, a=args: L.onehot_segment_scatter_reference(m, *a))
            for name, (kern, plain) in scat.items():
                got = kern(msgs)
                same_twice(name, f"{tag},{dn}", got, kern(msgs))
                ref = plain(msgs)
                check(f"{name}[{tag},{dn}]", got, ref, "bound", dtype, log,
                      bound=flush_bound(plain, msgs, ref, torch.float32))
                if empty.any():
                    if (got.reshape(n_blocks, 128, D)[empty] != 0).any():
                        raise AssertionError(f"{name}[{tag}]: an empty block "
                                             "is not 0")
                del got, ref
            if timings is not None and dtype == torch.bfloat16 and D == DIM:
                n_real = int(real.sum().item())
                out_bytes = n_blocks * 128 * D * 4
                rows = n_real * D * msgs.element_size()
                t_bound = roofline(
                    nbytes(h, w, b, tab),
                    [(2 * n_src * D * T2 * D, BF16_FLOPS)])
                lib_table = lambda: (
                    torch.einsum("nd,tdf->ntf", h, w) + b).reshape(
                        n_src // 128, 128, T2, D).transpose(1, 2).reshape(
                            -1, D)
                pairs = {"node_table_block_major": (
                    lambda: TB.node_table_block_major(h, w, b),
                    lambda: TB.node_table_block_major_reference(h, w, b),
                    lib_table, t_bound)}
                # one PyTorch call computing the same sums: index_add_ of
                # every message row into its output row, in the pack's
                # dtype (a yardstick of speed only)
                lib = reverse_library_call(
                    msgs, legacy_targets(arrs, n_blocks, tile_e),
                    n_blocks * 128)
                stream_bytes = {
                    "onehot_segment_scatter_flat": nbytes(
                        arrs["onehot"], arrs["tile_start"],
                        arrs["block_of_tile"]),
                    "onehot_segment_scatter": nbytes(arrs["dst_local"],
                                                     arrs["tile_start"])}
                for name, (kern, plain) in scat.items():
                    pairs[name] = (
                        lambda k=kern: k(msgs), lambda p=plain: p(msgs), lib,
                        roofline(rows + stream_bytes[name] + out_bytes,
                                 [(n_real * D, F32_FLOPS)]))
                time_pairs(pairs, timings)
            del tab, msgs


def check_legacy_grad(tag, lay, log):
    """window_block_spmm_mono on a legacy layout's grad half as its
    backward runs it (the int8 count stream at win_stride 16, flushed in
    the compute dtype)."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    arrs = lay.arrays
    g_blocks, _, g_tile, _, g_align = lay.meta[5]
    stream = (arrs["g_onehot"], arrs["g_tile_start"],
              arrs["g_block_of_tile"], arrs["g_tile_msg_off"])
    print(f"[legacy kernels] {tag} grad half: {g_blocks} grad blocks, "
          f"{stream[2].shape[0]} tiles of {g_tile}, edge_align {g_align}",
          flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        G = torch.randn(arrs["g_gather_idx"].shape[0], DIM, device=dev,
                        generator=gen).to(dtype)
        kw = dict(n_blocks=g_blocks, window=g_tile, win_stride=g_align,
                  out_dtype=dtype)
        got = W.window_block_spmm_mono(G, *stream, **kw)
        same_twice("window_block_spmm_mono", f"{tag} grad", got,
                   W.window_block_spmm_mono(G, *stream, **kw))
        ref = W.window_block_spmm_mono_reference(G, *stream, **kw)
        check(f"window_block_spmm_mono[{tag} grad,"
              f"{str(dtype).split('.')[-1]}]", got, ref, "bound", dtype, log,
              bound=flush_bound(
                  lambda t: W.window_block_spmm_mono_reference(
                      t, *stream, **dict(kw, out_dtype=torch.float32)),
                  G, ref, dtype))
        del G, got, ref


def check_window_widths(log, dims=(4, 6, 8, 16, 128, 200)):
    """window_block_spmm_mono at widths other than 128 (the bAbI models'
    D = 4 to 16, 200 over two column panels, or the given ``dims``) and at
    128 on the same layouts: a hub layout whose hub blocks split into
    several work items, with the dst-local and the int8 count streams, f32
    and bf16, per element and bit-equal to a second run."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(12)
    N, E = 4096, 60000
    dst = np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                   r.integers(0, N, E))
    src, typ = r.integers(0, N, E), r.integers(0, 3, E)
    for dstl in (True, False):
        lay = L.build_dst_block_layout(src, dst, typ, np.ones(E, np.float32),
                                       N, tile_e=128, n_message_types=3,
                                       edge_align=16, dstl_stream=dstl)
        args = [torch.as_tensor(a, device=dev) for a in (
            lay.dstl if dstl else lay.onehot, lay.tile_start,
            lay.block_of_tile, lay.tile_msg_off)]
        if not (np.diff(lay.tile_start) > 32).any():
            raise AssertionError("widths: no block splits into items")
        for D in dims:
            for dtype in (torch.bfloat16, torch.float32):
                table = torch.randn(lay.gather_idx.shape[0], D,
                                    device=dev).to(dtype)
                kw = dict(n_blocks=lay.n_blocks, window=128, win_stride=16,
                          out_dtype=dtype, dstl=dstl)
                got = W.window_block_spmm_mono(table, *args, **kw)
                tag = (f"D={D}, {'dstl' if dstl else 'counts'},"
                       f"{str(dtype).split('.')[-1]}")
                same_twice("window_block_spmm_mono", tag, got,
                           W.window_block_spmm_mono(table, *args, **kw))
                ref = W.window_block_spmm_mono_reference(table, *args, **kw)
                check(f"window_block_spmm_mono[{tag}]", got, ref, "bound",
                      dtype, log, bound=flush_bound(
                          lambda t: W.window_block_spmm_mono_reference(
                              t, *args, **dict(kw, out_dtype=torch.float32)),
                          table, ref, dtype))


def table_seam_fuzz(log, dims=(4, 6, 8, 13, 128, 200, 256, 384)):
    """[legacy kernels] #10 at the seams of its persistent schedule: one
    source block (N = 128) and 150 blocks (a CTA's range of (block, type)
    items then begins and ends inside a block's types), T2 = 1, 3 and 16,
    at ``dims`` in bf16 and f32 (6 and 13: the element-wise copies of
    widths that are not whole 16-byte vectors), against its plain version
    per element (:func:`table_bound`) and twice bit-equal."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    dev = torch.device("cuda")
    for N in (128, 128 * 150):
        for T2 in (1, 3, 16):
            for D in dims:
                for dtype in (torch.bfloat16, torch.float32):
                    tag = (f"seams N={N},T2={T2},D={D},"
                           f"{str(dtype).split('.')[-1]}")
                    gen = torch.Generator(device=dev).manual_seed(D + T2)
                    h = (torch.rand(N, D, device=dev, generator=gen) * 2
                         - 1).to(dtype)
                    w = (torch.randn(T2, D, D, device=dev, generator=gen)
                         * D ** -0.5).to(dtype)
                    b = (torch.randn(T2, D, device=dev, generator=gen)
                         * 0.1).to(dtype)
                    tab = TB.node_table_block_major(h, w, b)
                    same_twice("node_table_block_major", tag, tab,
                               TB.node_table_block_major(h, w, b))
                    ref = TB.node_table_block_major_reference(h, w, b)
                    check(f"node_table_block_major[{tag}]", tab, ref,
                          "bound", dtype, log,
                          bound=table_bound(h, w, b, ref, dtype))
                    del tab, ref
    print("[legacy kernels] #10 seams: N = 128 and 19,200, T2 = 1, 3, 16, "
          f"D = {dims}, bf16 and f32: ok", flush=True)


def legacy_fuzz(log):
    """[legacy kernels] on small layouts: empty blocks (the upper half of
    the dst rows has no edge), the all-padding tail of pad_tiles_to,
    tile_e 128 and 2048, D = 4 and 128, f32 and bf16; then #10 at the
    seams of its schedule (:func:`table_seam_fuzz`)."""
    from ggnn_tpu_torch.ops import legacy as L
    r = np.random.default_rng(13)
    N, E, T2 = 1024, 6000, 6
    src, dst = r.integers(0, N, E), r.integers(0, N // 2, E)
    typ, mask = r.integers(0, T2, E), (r.random(E) < 0.9).astype(np.float32)
    for tile_e in (128, 2048):
        lay = L.build_dst_block_layout(
            src, dst, typ, mask, N, tile_e=tile_e, n_message_types=T2,
            row_order="block",
            pad_tiles_to=L.static_tile_budget(E, N, tile_e) + 3)
        check_legacy_kernels(f"fuzz tile_e={tile_e}", lay.to("cuda"), N, log,
                             dims=(4, DIM), T2=T2)
    table_seam_fuzz(log)


def mono_seam_edges(seed, N=4096, E=40000, T2=3):
    """The seam layouts' edges: 90 % of E into dst rows [0, 64), the rest
    into the lower half of the N rows, 600 more into dst row 5."""
    r = np.random.default_rng(seed)
    src, typ = r.integers(0, N, E + 600), r.integers(0, T2, E + 600)
    dst = np.concatenate([np.where(r.random(E) < 0.9, r.integers(0, 64, E),
                                   r.integers(0, N // 2, E)),
                          np.full(600, 5)])
    return src, dst, typ, (r.random(E + 600) < 0.95).astype(np.float32)


def mono_seam_layouts():
    """The seams of #11's and #8's bf16 pipeline on small layouts (4,096
    nodes): a hub block of far more than 32 tiles (90 % of the edges into
    dst rows [0, 64)), a hub tile (600 edges into dst row 5), padding tails
    inside tiles, all-padding tiles (``pad_tiles_to``), empty blocks (no
    edge into the upper half of the dst rows), windows overlapping at
    ``win_stride`` 16, dummy tiles (20 % of the tiles' windows set to −1)
    and a stream read through a ``c_off`` permutation; window layouts with
    counts above 1 at W 128/256/512 and blocks of 128 to 512 rows.  Yields
    (tag, table rows, (stream, tile_start, block_of_tile, win_of_tile),
    keyword arguments of #11) on the card."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    N, T2 = 4096, 3
    src, dst, typ, mask = mono_seam_edges(41)
    r = np.random.default_rng(42)
    t = lambda x: torch.as_tensor(np.asarray(x), device="cuda")
    for dstl in (True, False):
        for tile_e in (128, 256):
            base = L.build_dst_block_layout(src, dst, typ, mask, N,
                                            tile_e=tile_e, n_message_types=T2,
                                            edge_align=16, dstl_stream=dstl)
            lay = L.build_dst_block_layout(
                src, dst, typ, mask, N, tile_e=tile_e, n_message_types=T2,
                edge_align=16, dstl_stream=dstl,
                pad_tiles_to=base.block_of_tile.shape[0] + 5)
            form = "dstl" if dstl else "counts"
            stream = lay.dstl if dstl else lay.onehot
            kw = dict(n_blocks=lay.n_blocks, window=tile_e, win_stride=16,
                      dstl=dstl)
            R = lay.gather_idx.shape[0]
            yield (f"{form} tile_e={tile_e}", R, tuple(t(x) for x in (
                stream, lay.tile_start, lay.block_of_tile,
                lay.tile_msg_off)), kw)
            n_tiles = lay.block_of_tile.shape[0]
            win = np.where(r.random(n_tiles) < 0.2, -1,
                           lay.tile_msg_off).astype(np.int32)
            n_c = stream.shape[0] // (1 if dstl else 128)
            perm = r.permutation(n_c)
            inv = np.argsort(perm).astype(np.int32)
            permuted = (stream[perm] if dstl else stream.reshape(
                n_c, 128, tile_e)[perm].reshape(stream.shape))
            yield (f"{form} tile_e={tile_e} dummies c_off", R,
                   tuple(t(x) for x in (permuted, lay.tile_start,
                                        lay.block_of_tile, win)),
                   dict(kw, c_off=t(inv[:n_tiles])))
    for W_, rows in ((128, 128), (256, 256), (512, 512), (128, 512)):
        lay = W.build_window_layout(
            src, dst, typ, mask, N, window=W_, min_edges_per_tile=1,
            n_message_types=T2, block_rows=rows)
        a = {k: t(v) for k, v in lay.arrays.items()}
        yield (f"window W={W_} rows={rows}", T2 * N + (-T2 * N) % W_,
               (a["c_stream"], a["tile_start"], a["block_of_tile"],
                a["win_of_tile"]),
               dict(n_blocks=lay.n_blocks, window=W_, out_rows=rows,
                    c_off=a["c_off"], dstl=False))


def mono_seam_fuzz(log):
    """[legacy kernels] #11's and #8's bf16 pipeline
    (``csrc/window_mono_fused.cu``) against their plain versions at the
    seams of :func:`mono_seam_layouts`: #11 in its dst-local, count and
    tall count forms, output f32 and bf16; #8 at tile_e 128 and 2048 and #9
    at tile_e 128 and 256 (f32 out) on the same edges, and #9 at tile_e 24
    (``csrc/window_mono.cu``'s panel kernel).  Each per element within
    :func:`flush_bound`, twice bit-equal, and every block without a term
    exactly 0; #8 refuses a stream with an entry 2."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    gen = torch.Generator(device="cuda").manual_seed(43)
    n_checks = 0

    def held(name, tag, run, plain, table, out_dtype):
        got = run(table)
        same_twice(name, tag, got, run(table))
        ref = plain(table)
        bound = flush_bound(plain, table, ref, out_dtype)
        check(f"{name}[{tag}]", got, ref, "bound", table.dtype, log,
              bound=bound)
        empty = bound.reshape(-1, 128 * bound.shape[1]).amax(1) == 0
        if not empty.any():
            raise AssertionError(f"{name}[{tag}]: the layout has no empty "
                                 f"block")
        if (got.reshape(empty.shape[0], -1)[empty] != 0).any():
            raise AssertionError(f"{name}[{tag}]: a block without a term "
                                 f"is not 0")

    n_split = 0
    for tag, R, args, kw in mono_seam_layouts():
        n_split += int((args[1].diff() > 32).any().item())
        table = (torch.rand(R, DIM, device="cuda", generator=gen) * 2
                 - 1).to(torch.bfloat16)
        for out_dtype in (torch.float32, torch.bfloat16):
            held("window_block_spmm_mono",
                 f"{tag},{str(out_dtype).split('.')[-1]}",
                 lambda x, o=out_dtype: W.window_block_spmm_mono(
                     x, *args, out_dtype=o, **kw),
                 lambda x: W.window_block_spmm_mono_reference(
                     x, *args, **kw), table, out_dtype)
            n_checks += 1
    if n_split < 6:
        raise AssertionError(f"mono seams: {n_split} layouts with a block of "
                             f"several work items")
    N, T2 = 4096, 3
    src, dst, typ, mask = mono_seam_edges(44)
    for tile_e in (128, 256, 2048, 24):
        base = L.build_dst_block_layout(src, dst, typ, mask, N,
                                        tile_e=tile_e, n_message_types=T2)
        lay = L.build_dst_block_layout(
            src, dst, typ, mask, N, tile_e=tile_e, n_message_types=T2,
            pad_tiles_to=base.block_of_tile.shape[0] + 3).to("cuda")
        a, nb, mt = lay.arrays, lay.meta[3], lay.meta[2]
        msgs = (torch.rand(a["gather_idx"].shape[0], DIM, device="cuda",
                           generator=gen) * 2 - 1).to(torch.bfloat16)
        if tile_e in (128, 2048):
            fa = (a["onehot"], a["tile_start"], a["block_of_tile"], nb,
                  tile_e)
            held("onehot_segment_scatter_flat", f"seams tile_e={tile_e}",
                 lambda x, f=fa: L.onehot_segment_scatter_flat(x, *f),
                 lambda x, f=fa: L.onehot_segment_scatter_flat_reference(
                     x, *f), msgs, torch.float32)
            n_checks += 1
            # a stream that is not one-hot: refused by the plan's pass
            bad = a["onehot"].clone()
            bad.view(-1)[torch.nonzero(bad.view(-1))[0]] = 2
            try:
                L.onehot_segment_scatter_flat(msgs, bad, *fa[1:])
            except ValueError as e:
                if "not a one-hot layout" not in str(e):
                    raise
            else:
                raise AssertionError("onehot_segment_scatter_flat: a "
                                     "stream with an entry 2 was taken")
            del bad
        if tile_e != 2048:
            da = (a["dst_local"], a["tile_start"], nb, mt, tile_e)
            held("onehot_segment_scatter", f"seams tile_e={tile_e}",
                 lambda x, d=da: L.onehot_segment_scatter(x, *d),
                 lambda x, d=da: L.onehot_segment_scatter_reference(x, *d),
                 msgs, torch.float32)
            n_checks += 1
    print(f"[legacy kernels] mono seams: {n_checks} checks of the bf16 "
          f"pipeline (#11 dst-local, counts, tall counts; #8; #9; #9 at "
          f"tile_e 24 on the panel kernel), each twice bit-equal; #8's "
          f"one-hot check refuses a bad stream: ok", flush=True)


def time_spill_mono(lay, timings):
    """[window train] #11 on a window train step's XW spill, forward
    (``s_``) and backward (``sb_``), replayed on the layout's own
    arguments with random bf16 message rows: its time and its bound (the
    real rows' bytes: each pack row whose dst id is ≥ 0, read once; the
    dst-local stream, tile_start and windows; the f32 output), printed,
    and the sum of one step's ten launches."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    a = lay.arrays
    gen = torch.Generator(device="cuda").manual_seed(45)
    total = 0.0
    for prefix, meta in (("s_", lay.spill_meta), ("sb_", lay.grad_meta[3])):
        if meta[6] is None or prefix + "dstl" not in a:
            print(f"  {prefix} spill: not the dst-local form", flush=True)
            continue
        stream = (a[prefix + "dstl"], a[prefix + "tile_start"],
                  a[prefix + "block_of_tile"], a[prefix + "tile_msg_off"])
        kw = dict(n_blocks=meta[3], window=meta[1], win_stride=meta[6],
                  dstl=True)
        msgs = (torch.rand(a[prefix + "gather_idx"].shape[0], DIM,
                           device="cuda", generator=gen) * 2
                - 1).to(torch.bfloat16)
        ms = min(cuda_ms(lambda: W.window_block_spmm_mono(
            msgs, *stream, **kw), 10) for _ in range(2))
        n_real = int((stream[0] >= 0).sum().item())
        print(f"  time window_block_spmm_mono [{prefix} spill: "
              f"{stream[0].shape[0]} tiles of {meta[1]}, {meta[3]} blocks, "
              f"{n_real} real rows of {msgs.shape[0]}]: {ms:.4f} ms; bound",
              flush=True)
        bound_ms, _ = roofline(n_real * DIM * 2 + nbytes(*stream)
                               + meta[3] * 128 * DIM * 4,
                               [(n_real * DIM, F32_FLOPS)])
        timings[f"window_block_spmm_mono[{prefix}spill]"] = dict(
            ms=ms, bound_ms=bound_ms)
        total += ms
    print(f"  #11 on the spill: {STEPS} launches each way a step, "
          f"{STEPS * total:.3f} ms a step", flush=True)


def legacy_phase(params, b, log, timings):
    """The legacy table-gather path at the headline (the uniform batch
    ``b``): [legacy kernels], [legacy serve], [legacy train] with the
    bench's --legacy_pack forward, and [no_stream].  Returns the launch
    counts of the main-path runs."""
    import warnings
    import torch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.train.loop import batch_arrays
    launched = dict.fromkeys(KERNELS, 0)
    legacy_fuzz(log)
    mono_seam_fuzz(log)
    check_window_widths(log)
    t0 = time.perf_counter()
    lay = L.layout_for_batch(b, with_grad=True, device="cuda")
    torch.cuda.synchronize()
    print(f"[legacy kernels] headline layout_for_batch(with_grad=True) "
          f"built and copied in {time.perf_counter() - t0:.2f} s; meta "
          f"{lay.meta}", flush=True)
    # the static budgets of a batch of NODES nodes and 2·EDGES directed
    # edges: 64,548 forward and 95,268 grad tiles at the headline
    budgets = (L.static_tile_budget(2 * EDGES, NODES, 128),
               L.static_tile_budget(2 * EDGES, 2 * EDGE_TYPES * NODES, 128))
    if (lay.arrays["block_of_tile"].shape[0], lay.meta[5][1]) != budgets:
        raise AssertionError(f"the headline layout's tile counts are not its "
                             f"static budgets {budgets}")
    check_legacy_kernels("headline", lay, NODES, log, params=params,
                         timings=timings)
    check_legacy_grad("headline", lay, log)
    torch.cuda.empty_cache()

    # [legacy serve]: the Predictor's own layout, a fuse request
    graphs = [(seed, request_graph(seed)) for seed in EARLIER_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k, v in serve(params, True, graphs, {}, {
                "node_table_block_major": STEPS,
                "onehot_segment_scatter_flat": STEPS,
                "gru_cell_fwd": STEPS}, tag="legacy serve",
                layout_fn=lambda pred, batch: pred.layout(batch),
                plain_fn=plain_run,
                label="fuse_gru=True requested (legacy layout)").items():
            launched[k] += v
    if not any("UNFUSED" in str(w.message) for w in caught):
        raise AssertionError("legacy serve: the fuse request did not warn")
    print(f"[legacy serve] the fuse request warned and ran unfused; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB", flush=True)
    del graphs
    torch.cuda.empty_cache()

    # [legacy train]: layout_for_batch(with_grad=True), unfused
    per_step = {"node_table_block_major": STEPS,
                "onehot_segment_scatter_flat": STEPS,
                "window_block_spmm_mono": STEPS, "gru_cell_fwd": STEPS,
                "gru_cell_bwd": STEPS}
    for k, v in train_headline(b, lay, {
            "unfused": (dict(fuse_gru=False), per_step)},
            tag="legacy train", f32_check=False).items():
        launched[k] += v
    del lay
    torch.cuda.empty_cache()

    # one forward with the bench's --legacy_pack layout (bench.py:258-271)
    t0 = time.perf_counter()
    lay = L.build_dst_block_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        tile_e=2048, n_message_types=2 * EDGE_TYPES, edge_align=16,
        row_order="block").to("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    arrays = batch_arrays(b, "cuda")
    cfg = headline_cfg(compute_dtype="bfloat16")
    zero_counts()
    with torch.inference_mode():
        scores = forward(params, cfg, arrays, 1, scatter_layout=lay)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read_counts()
        with plain_versions():
            ref = forward(params, cfg, arrays, 1, scatter_layout=lay)
    expect_counts("legacy_pack forward", launches, {
        "node_table_block_major": STEPS, "window_block_spmm_mono": STEPS,
        "gru_cell_fwd": STEPS})
    for k, v in launches.items():
        launched[k] += v
    check("legacy_pack forward scores", scores, ref, "flip", torch.bfloat16,
          {})
    print(f"[legacy train] --legacy_pack forward (tile_e 2048, edge_align "
          f"16, block order; {lay.arrays['block_of_tile'].shape[0]} tiles): "
          f"layout {t1 - t0:.2f} s on the host, forward {1e3 * (t2 - t1):.2f}"
          f" ms; launches {launches}", flush=True)
    del lay, scores, ref
    torch.cuda.empty_cache()

    # [no_stream]: no one-hot stream, dst-local ids both ways
    t0 = time.perf_counter()
    lay = L.build_dst_block_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        onehot_stream=False, with_grad=True, n_message_types=2 * EDGE_TYPES,
        row_order="block").to("cuda")
    torch.cuda.synchronize()
    print(f"[no_stream] layout with its grad half built in "
          f"{time.perf_counter() - t0:.2f} s; meta {lay.meta}", flush=True)
    for k, v in train_headline(b, lay, {"unfused": (dict(fuse_gru=False), {
            "node_table_block_major": STEPS,
            "onehot_segment_scatter": 2 * STEPS, "gru_cell_fwd": STEPS,
            "gru_cell_bwd": STEPS})}, tag="no_stream", f32_check=False,
            steps=1).items():
        launched[k] += v
    del lay
    torch.cuda.empty_cache()
    return launched


NODES_1M, EDGES_1M = 1_048_576, 10_000_000


def chunked_phase(params, log):
    """[chunked 1M]: the reference's large-graph configuration at full
    width (examples/large_graph.py: 1,048,576 nodes, 10M logical / 20M
    directed edges, 8 types, D = 128, T = 5, bf16), through
    build_chunked_dst_layouts(n_chunks=4, tile_e=2048): one forward
    through propagate (20 launches of #8), then each step from the same
    state against the plain step.  Returns its launch counts."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.ggnn import (fuse_gru, gru_update, init_state,
                                            propagate)
    from ggnn_tpu_torch.ops import legacy as L
    t0 = time.perf_counter()
    b = synthetic_batch(NODES_1M, EDGES_1M, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    t1 = time.perf_counter()
    chunks = L.build_chunked_dst_layouts(b.edge_src, b.edge_dst, b.edge_type,
                                         b.edge_mask, b.spec.n_pad,
                                         n_chunks=4, tile_e=2048,
                                         device="cuda")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tiles = [c.arrays["block_of_tile"].shape[0] for c in chunks]
    print(f"[chunked 1M] batch ({b.spec.n_pad} nodes, "
          f"{int(b.edge_mask.sum())} directed edges) made in {t1 - t0:.2f} s;"
          f" 4 chunk layouts (tiles {tiles}, one-hot "
          f"{sum(nbytes(c.arrays['onehot']) for c in chunks) / 1e9:.2f} GB) "
          f"built and copied in {t2 - t1:.2f} s", flush=True)
    cfg = headline_cfg(compute_dtype="bfloat16")
    prop = params["prop"]
    ann = torch.as_tensor(b.annotations, device="cuda")
    edges = [torch.as_tensor(x) for x in (b.edge_src, b.edge_dst,
                                          b.edge_type, b.edge_mask)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = propagate(prop, cfg, ann, *edges, scatter_layout=chunks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_counts("chunked 1M", launches, {
        "onehot_segment_scatter_flat": 4 * STEPS, "gru_cell_fwd": STEPS})
    if not torch.isfinite(h).all() or tuple(h.shape) != (NODES_1M, DIM):
        raise AssertionError("chunked 1M: bad states")
    print(f"[chunked 1M] forward ({STEPS} steps) {1e3 * (t1 - t0):.2f} ms on "
          f"the card (host clock around it), peak device memory "
          f"{peak:.2f} GiB; {2 * EDGES_1M * STEPS / (t1 - t0):.4e} "
          f"directed-edges*T/s; launches {launches}", flush=True)
    del h
    # each step from the same state against the plain step
    cdt = torch.bfloat16
    fused = fuse_gru(prop["gru"])
    w, bias = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    h = init_state(ann, DIM)
    with torch.inference_mode():
        for t in range(STEPS):
            a = L.aggregate_onehot_chunked(h.to(cdt), chunks, w, bias)
            got = gru_update(prop["gru"], h, a, fused, matmul_dtype=cdt)
            with plain_versions():
                a_ref = L.aggregate_onehot_chunked(h.to(cdt), chunks, w,
                                                   bias)
                ref = gru_update(prop["gru"], h, a_ref, fused,
                                 matmul_dtype=cdt)
            check(f"onehot_segment_scatter_flat[chunked 1M step {t}]", a,
                  a_ref, "sum", cdt, log)
            check(f"chunked 1M step {t}", got, ref, "flip_rows", cdt, {},
                  a_rows=a_ref.abs().amax(1).clamp_min(1.0))
            h = got
            del a, a_ref, ref
    del chunks, b, h
    torch.cuda.empty_cache()
    return launches



# --- the window backend (PR 5): [window kernels], [window serve], [window 1m]

WINDOW, COMMUNITY = 512, 512      # bench.py: window 512, nodes // 512
TIMED_WIDTHS = (256,)    # the wide kernels timed at the headline (more:
                         # scripts/torch_window_bringup.py --train --wide)
NODES_W1M, EDGES_W1M, COMMUNITIES_W1M = 1_000_000, 10_000_000, 4096


def community_graph(seed):
    """One serving request of the community headline (bench.py:457-466):
    262,144 nodes in 512 communities of 512, 4M logical edges, each inside
    its community with probability 0.95, drawn as the port's
    synthetic_batch(n_communities=512, p_intra=0.95) draws them."""
    r = np.random.default_rng(seed)
    n_com = NODES // COMMUNITY
    com = r.integers(0, n_com, EDGES)
    intra = r.random(EDGES) < 0.95
    src = r.integers(0, COMMUNITY, EDGES) + com * COMMUNITY
    dst_in = r.integers(0, COMMUNITY, EDGES) + com * COMMUNITY
    dst = np.where(intra, dst_in, r.integers(0, NODES, EDGES))
    typ = r.integers(0, EDGE_TYPES, EDGES)
    ann = (r.random((NODES, ANN)) < 0.1).astype(np.float32)
    return dict(n_nodes=NODES, edges=np.stack([src, typ, dst], axis=1),
                annotations=ann)


@functools.cache
def community_batch():
    """The community headline's batch (bench.py:457-466: 262,144 nodes in
    512 communities of 512, 8M directed edges, 95 % inside their
    community), made once for [variants], [window kernels] and [window
    train]: the window probe's graph (scripts/torch_window_variants.py)."""
    _, WV = sweep_scripts()
    if (WV.TYPES, WV.DIM) != (EDGE_TYPES, DIM):
        raise AssertionError("the window probe's graph is not the headline's")
    return WV.community_batch(NODES, EDGES)


def bench_window_layout(b, block_rows, on_demand, typed_spill,
                        pack=False, with_grad=False, grad_quant=False):
    """bench.py's window layout (bench.py:209-244): window 512,
    min_edges_per_tile 32, block-major rows, the spill tile from the
    spill's density; the train records build it ``with_grad`` (and
    ``grad_quant`` for window_community_train_q8g)."""
    from ggnn_tpu_torch.ops import window as W
    return W.build_window_layout(
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad,
        window=WINDOW, n_message_types=2 * EDGE_TYPES, block_rows=block_rows,
        pack_counts=pack, typed_spill=typed_spill, on_demand=on_demand,
        row_major="block", with_grad=with_grad, grad_quant=grad_quant)


def window_weights(params, dtype, T2=2 * EDGE_TYPES):
    from ggnn_tpu_torch.models.ggnn import fuse_gru
    prop = params["prop"]
    w_a, b_all, u_zr = fuse_gru(prop["gru"])
    return (prop["msg_w"][:T2].detach().to(dtype),
            prop["msg_b"][:T2].detach().to(dtype),
            dict(wa=w_a.detach().to(dtype),
                 b3=b_all[None, :].detach().float(),
                 uzr=u_zr.detach().to(dtype),
                 uh=prop["gru"]["uh"].detach().to(dtype)))


def check_q8_table(tag, h, w, b, window, log):
    """#15 against its plain version and the exact values, in chunks of
    source blocks; two runs bit-equal.
    - Exponents: equal to the plain version's except where its argument of
      ceil lies within 1e-6 of an integer (those counted).
    - Rounding: x = v/2^e with v = h·W_t + b_t in f64, and slack = (D + 2)
      ·2^-24·(|h|·|W_t| + |b_t|)/2^e, which bounds the error of any f32
      evaluation of v in quanta.  Every q lies within 0.5 + slack of x (a
      kernel that truncated or floored would be up to one quantum off).
    - q equals the plain version's q element for element, except in a
      window whose exponents differ, or where x lies within slack of a
      half-integer (the two f32 values may round to either side there;
      those counted)."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    tq, sc = TB.node_table_block_major_q8(h, w, b, window)
    same_twice("node_table_block_major_q8", tag, tq,
               TB.node_table_block_major_q8(h, w, b, window)[0])
    N, D = h.shape
    T2, gt = w.shape[0], window // 128
    wpb = T2 // gt                        # windows per 128-row source block
    w64, b64 = w.double(), b.double()
    gam = (D + 2) * 2.0 ** -24
    rep = lambda s_: s_[:, None].expand(-1, window).reshape(-1, 1)
    n_e = n_near = n_tie = 0
    err_x = err_x_raw = err_p = abs_p = 0.0
    step = 256                            # source blocks per chunk
    for i0 in range(0, N // 128, step):
        i1 = min(i0 + step, N // 128)
        nb, hb = i1 - i0, h[i0 * 128:i1 * 128]
        rq, rs = TB.node_table_block_major_q8_reference(hb, w, b, window)
        kq = tq[i0 * T2 * 128:i1 * T2 * 128]
        ks, rs = sc[i0 * wpb:i1 * wpb, 0], rs[:, 0]
        # the plain version's argument of ceil, as it computes it (f32)
        m = (torch.einsum("nd,tdf->ntf", hb.float(), w.float())
             + b.float()[None]).reshape(nb, 128, wpb, gt, D).abs().amax(
                 dim=(1, 3, 4)).reshape(-1)
        arg = torch.log2(m.clamp_min(1e-30)) - 6.9886
        near = (arg - torch.round(arg)).abs() < 1e-6
        diff_e = ks != rs
        if (diff_e & ~near).any():
            raise AssertionError(f"node_table_block_major_q8[{tag}]: "
                                 f"{int((diff_e & ~near).sum())} exponents "
                                 f"differ away from an integer boundary")
        n_e += int(diff_e.sum())
        n_near += int(near.sum())
        block_major = lambda x: x.reshape(nb, 128, T2, D).permute(
            0, 2, 1, 3).reshape(-1, D)
        scale = rep(ks.double())
        x = block_major(torch.einsum("nd,tdf->ntf", hb.double(), w64)
                        + b64[None]) / scale
        slack = gam * block_major(torch.einsum(
            "nd,tdf->ntf", hb.double().abs(), w64.abs())
            + b64.abs()[None]) / scale
        dq = (kq.double() - x).abs()
        err_x = max(err_x, (dq - slack).max().item())
        err_x_raw = max(err_x_raw, dq.max().item())
        tie = ((x - torch.floor(x)) - 0.5).abs() <= slack
        n_tie += int((tie & ~rep(diff_e)).sum())
        differ = (kq != rq) & ~tie & ~rep(diff_e)
        if differ.any():
            raise AssertionError(f"node_table_block_major_q8[{tag}]: "
                                 f"{int(differ.sum())} elements differ from "
                                 f"the plain version's away from a "
                                 f"half-integer")
        dd = (kq.float() * rep(ks) - rq.float() * rep(rs)).abs()
        abs_p = max(abs_p, dd.max().item())
        err_p = max(err_p, (dd / torch.maximum(rep(ks), rep(rs))).max()
                    .item())
        del x, slack, dq, tie, differ, dd
    ok = err_x <= 0.5
    print(f"  node_table_block_major_q8[{tag}]: {n_e} of {sc.shape[0]} "
          f"exponents differ ({n_near} arguments within 1e-6 of an integer); "
          f"|q - v/2^e| at most {err_x_raw:.6f} quantum, less the f32 slack "
          f"{err_x:.6f} (tol 0.5); q equal to the plain version's away from "
          f"{n_tie} elements within the slack of a half-integer; |deq - "
          f"deq_plain| at most {err_p:.3f} quantum "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"node_table_block_major_q8[{tag}]: q is over "
                             f"half a quantum from v")
    log.setdefault("node_table_block_major_q8", []).append(abs_p)
    return tq, sc


# #15's seams: (T2, window, source blocks, bias) — windows of 1, 2, 4, 16
# types at T2 = 16 and of 1, 3 at T2 = 3; 133 blocks leave the persistent
# CTAs (and clusters) uneven; "zero" makes the bias 0 and source block 1
# all zero, so that its windows' scale is 2^-100 and their q 0.
Q8_SEAMS = ((16, 128, 7, "rand"), (16, 256, 7, "rand"),
            (16, 512, 133, "rand"), (16, 2048, 5, "rand"),
            (3, 128, 7, "rand"), (3, 384, 7, "rand"), (16, 512, 9, "zero"))


def q8_table_seam_fuzz(log):
    """[window kernels] #15 at its seams (``Q8_SEAMS``) with
    :func:`check_q8_table`'s criteria, and the all-zero block exactly."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(43)
    bf = torch.bfloat16
    for T2, W_, nb, kind in Q8_SEAMS:
        h = (torch.rand(nb * 128, DIM, device="cuda", generator=gen) * 2
             - 1).to(bf)
        w = torch.empty(T2, DIM, DIM, device="cuda").uniform_(
            -DIM ** -0.5, DIM ** -0.5, generator=gen).to(bf)
        b = torch.empty(T2, DIM, device="cuda").uniform_(
            -0.1, 0.1, generator=gen).to(bf)
        if kind == "zero":
            h[128:256] = 0
            b.zero_()
        tq, sc = check_q8_table(f"seam T2={T2},W={W_},blocks={nb},{kind}",
                                h, w, b, W_, log)
        if kind == "zero":
            wpb = T2 * 128 // W_
            if not (sc[wpb:2 * wpb] == 2.0 ** -100).all() or \
                    (tq[T2 * 128:2 * T2 * 128] != 0).any():
                raise AssertionError("node_table_block_major_q8: the zero "
                                     "block's scale is not 2^-100 or its q "
                                     "not 0")
            print("  node_table_block_major_q8[seam zero]: the zero block's "
                  "scales are 2^-100, its q 0", flush=True)
        del h, w, b, tq, sc


def window_sums_bound(table, lay_args, window, out_rows, scales=None,
                      msg_w=None, msg_b=None, flip=False):
    """The per-element bound of a window sum against its plain version:
    2e-5 of Σ|count·row| (f32 sums in another order), plus with ``flip``
    one bf16 ulp of every term, 2**-7·Σ|count·row|.  On-demand windows
    (``msg_w``: table is the h source) are built by the kernel as bf16
    roundings of f32 sums h·W_t + b_t taken in another order: their rows
    in the 2e-5 term are the magnitudes |h|·|W_t| + |b_t| (a window value
    that cancels to near 0 keeps the f32 rounding of its terms, several
    bf16 ulps of itself), and ``flip`` adds the ulp of the rounded row."""
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    c_stream, block_of_tile, win_of_tile, c_off, n_blocks, packed = lay_args

    def sums(rows):
        return W.window_sums_reference(rows, c_stream, block_of_tile,
                                       win_of_tile, c_off, n_blocks, window,
                                       out_rows, packed,
                                       scales=scales).float()
    ulp = BF16_ULP if flip else 0.0
    if msg_w is None:
        return (2e-5 + ulp) * sums(table.abs())
    rows = TB.node_table_block_major_reference(table, msg_w.to(table.dtype),
                                               msg_b)
    mag = TB.node_table_block_major_reference(
        table.abs(), msg_w.abs().to(table.dtype), msg_b.abs())
    return 2e-5 * sums(mag) + ulp * sums(rows.abs())


def check_window_layout(tag, lay, params, log, dtypes=(None,), timings=None,
                        q8=True):
    """The window kernels at one layout's shapes, each against its plain
    version and a second run of itself: #11 (table layouts: the int8 or
    int4 counts at out_rows = block_rows), #12 (on-demand layouts), #13
    (every table source the layout takes: a bf16/f32 table, q8, on-demand;
    with and without init) and #15.  Blocks with no real tile give exactly
    init (sums) or the GRU of init.  ``timings``: time #12, #13, #15 in
    bf16 (and #11's window form, printed)."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    a = lay.arrays
    W_, rows, nb = lay.window, lay.block_rows, lay.n_blocks
    n_rows = nb * rows
    N = lay.n_nodes_pad
    packed, ondemand = lay.packed[0], lay.on_demand
    real = a["win_of_tile"] >= 0
    n_real = int(real.sum().item())
    sizes = (a["tile_start"][1:] - a["tile_start"][:-1])
    per_block = torch.zeros(nb, device=dev).index_add_(
        0, a["block_of_tile"].long(), real.float())
    empty = per_block == 0
    stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
              a["win_of_tile"])
    lay_args = (a["c_stream"], a["block_of_tile"], a["win_of_tile"],
                a["c_off"], nb, packed)
    print(f"[window kernels] {tag}: W={W_} block_rows={rows} blocks={nb} "
          f"tiles={lay.n_tiles} (real {n_real}, largest block "
          f"{int(sizes.max().item())}), {int(empty.sum().item())} blocks "
          f"without a real tile, packed {packed}, on-demand {ondemand}, "
          f"stream {a['c_stream'].numel() / 1e9:.3f} GB, spill "
          f"{None if lay.spill_meta is None else lay.spill_meta[:2]}",
          flush=True)
    for dt in dtypes:
        dtype = dt or torch.bfloat16
        dn = str(dtype).split(".")[-1]
        w, b, gw = window_weights(params, dtype)
        h = torch.rand(N, DIM, device=dev, generator=gen) * 2 - 1
        hc = h.to(dtype)
        init = torch.randn(n_rows, DIM, device=dev, generator=gen) * 0.3
        hp = h[:n_rows] if N >= n_rows else torch.nn.functional.pad(
            h, (0, 0, 0, n_rows - N))
        sk = dict(n_blocks=nb, window=W_, out_rows=rows, packed=packed,
                  c_off=a["c_off"])
        sources = {}
        if ondemand:
            sources["ondemand"] = (hc, dict(msg_w=w, msg_b=b), {})
            got = W.window_block_spmm_ondemand(hc, w, b, *stream,
                                               a["c_off"], nb, W_, rows)
            same_twice("window_block_spmm_ondemand", f"{tag},{dn}", got,
                       W.window_block_spmm_ondemand(hc, w, b, *stream,
                                                    a["c_off"], nb, W_,
                                                    rows))
            ref = W.window_block_spmm_ondemand_reference(
                hc, w, b, *stream, a["c_off"], nb, W_, rows)
            check(f"window_block_spmm_ondemand[{tag},{dn}]", got, ref,
                  "bound", dtype, log, bound=window_sums_bound(
                      hc, lay_args, W_, rows, msg_w=w, msg_b=b,
                      flip=dtype == torch.bfloat16))
            if empty.any() and (got.reshape(nb, rows, DIM)[empty] != 0).any():
                raise AssertionError(f"window_block_spmm_ondemand[{tag}]: a "
                                     f"block without tiles is not 0")
            del got, ref
        else:
            table = TB.node_table(hc, w, b, "block")
            sources["table"] = (table, {}, {})
            got = W.window_block_spmm_mono(table, *stream, **sk)
            same_twice("window_block_spmm_mono", f"{tag},{dn}", got,
                       W.window_block_spmm_mono(table, *stream, **sk))
            ref = W.window_block_spmm_mono_reference(table, *stream, **sk)
            check(f"window_block_spmm_mono[{tag},{dn}]", got, ref, "bound",
                  dtype, log, bound=window_sums_bound(table, lay_args, W_,
                                                      rows))
            if empty.any() and (got.reshape(nb, rows, DIM)[empty] != 0).any():
                raise AssertionError(f"window_block_spmm_mono[{tag}]: a "
                                     f"block without tiles is not 0")
            del got, ref
            if q8 and not packed and dtype == torch.bfloat16:
                tq, sc = check_q8_table(f"{tag},{dn}", hc, w, b, W_, log)
                sources["q8"] = (tq, dict(scales=sc[:, 0]),
                                 dict(scales=sc[:, 0]))
        for src, (tab, kw, bkw) in sources.items():
            for has_init in (True, False):
                args = (tab, *stream, init, hp, gw["wa"], gw["b3"],
                        gw["uzr"], gw["uh"])
                got = W.window_step_gru(*args, has_init=has_init, **sk, **kw)
                same_twice("window_step_gru", f"{tag},{src},{dn}", got,
                           W.window_step_gru(*args, has_init=has_init, **sk,
                                             **kw))
                ref = W.window_step_gru_reference(*args, has_init=has_init,
                                                  **sk, **kw)
                a_ref = W.window_sums_reference(
                    tab, *lay_args[:4], nb, W_, rows, packed,
                    init=init if has_init else None, **kw).float()
                check(f"window_step_gru[{tag},{src},{dn},init={has_init}]",
                      got, ref, "flip_rows", dtype, log,
                      a_rows=a_ref.abs().amax(1).clamp_min(1.0))
                del got, ref, a_ref
        if timings is not None and dtype == torch.bfloat16:
            time_window_kernels(tag, lay, hc, w, b, gw, init, hp, sources,
                                stream, sk, n_real, timings)


def time_window_kernels(tag, lay, hc, w, b, gw, init, hp, sources, stream,
                        sk, n_real, timings):
    """#12, #13 and #15 at the headline in bf16, kernel and plain version
    in turns, with their bounds: the count stream's real tiles, the h
    blocks or table windows they read (each once), init, h and h' (#13),
    the table and scales (#15); products of the nonzero counts, of the
    on-demand windows (each real tile's once) and of the GRU, at the
    card's peak for their type.  (No single PyTorch call builds windows, quantizes per window or
    runs a GRU epilogue on a sparse product: library_ms is null.)"""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    a = lay.arrays
    W_, rows, nb = lay.window, lay.block_rows, lay.n_blocks
    n_rows = nb * rows
    ccols = a["c_stream"].shape[1]
    count_bytes = n_real * rows * ccols
    nnz = int((a["c_stream"] != 0).sum().item())
    row_bytes = n_rows * DIM * 4
    pairs = {}
    if "ondemand" in sources:
        win_ops = (2 * n_real * W_ * DIM * DIM, BF16_FLOPS)
        pairs["window_block_spmm_ondemand"] = (
            lambda: W.window_block_spmm_ondemand(
                hc, w, b, *stream, a["c_off"], nb, W_, rows),
            lambda: W.window_block_spmm_ondemand_reference(
                hc, w, b, *stream, a["c_off"], nb, W_, rows), None,
            roofline(count_bytes
                     + ondemand_h_bytes(a["win_of_tile"], W_, w.shape[0])
                     + row_bytes
                     + nbytes(w, b, a["win_of_tile"], a["c_off"]),
                     [(2 * nnz * DIM, BF16_FLOPS), win_ops]))
    for src in ("ondemand", "q8"):
        if (src not in sources or "window_step_gru" in pairs
                or "window_step_gru" in timings):
            continue
        tab, kw, _ = sources[src]
        args = (tab, *stream, init, hp, gw["wa"], gw["b3"], gw["uzr"],
                gw["uh"])
        read = (ondemand_h_bytes(a["win_of_tile"], W_, w.shape[0])
                if src == "ondemand"
                else window_bytes(a["win_of_tile"], W_, 1))
        ops = [(2 * nnz * DIM, INT8_OPS if src == "q8" else BF16_FLOPS),
               (12 * n_rows * DIM * DIM, BF16_FLOPS)]
        if src == "ondemand":
            ops.append((2 * n_real * W_ * DIM * DIM, BF16_FLOPS))
        pairs["window_step_gru"] = (
            lambda args=args, kw=kw: W.window_step_gru(*args, **sk, **kw),
            lambda args=args, kw=kw: W.window_step_gru_reference(*args, **sk,
                                                                 **kw),
            None, roofline(count_bytes + read + 3 * row_bytes
                           + nbytes(*gw.values(), a["win_of_tile"],
                                    a["c_off"]), ops))
        print(f"  window_step_gru is timed with the {src} table source",
              flush=True)
    if "q8" in sources:
        N, T2 = hc.shape[0], w.shape[0]
        pairs["node_table_block_major_q8"] = (
            lambda: TB.node_table_block_major_q8(hc, w, b, W_),
            lambda: TB.node_table_block_major_q8_reference(hc, w, b, W_),
            None, roofline(nbytes(hc, w, b) + N * T2 * DIM
                           + N * T2 // W_ * 4,
                           [(2 * N * T2 * DIM * DIM, BF16_FLOPS)]))
    local = {}
    time_pairs(pairs, local)
    for k, v in local.items():
        if k not in timings:
            timings[k] = v
    if "table" in sources or "q8" in sources:
        time_window_mono(tag, lay, TB.node_table(hc, w, b, "block"))


def time_window_mono(tag, lay, table):
    """#11's window form (the unfused table path) at one layout, bf16:
    its time and its bound (the real tiles' counts, their table windows,
    the output), printed."""
    from ggnn_tpu_torch.ops import window as W
    a = lay.arrays
    W_, rows = lay.window, lay.block_rows
    stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
              a["win_of_tile"])
    sk = dict(n_blocks=lay.n_blocks, window=W_, out_rows=rows,
              packed=lay.packed[0], c_off=a["c_off"])
    n_real = int((a["win_of_tile"] >= 0).sum().item())
    nnz = int((W.unpack_counts(a["c_stream"], lay.packed[0]) != 0)
              .sum().item())
    mono_ms = cuda_ms(lambda: W.window_block_spmm_mono(table, *stream, **sk),
                      10)
    print(f"  time window_block_spmm_mono [{tag}, W {W_}, out_rows {rows}, "
          f"{'int4 packed' if sk['packed'] else 'int8'} counts]: "
          f"{mono_ms:.3f} ms; bound", flush=True)
    roofline(n_real * rows * a["c_stream"].shape[1]
             + window_bytes(a["win_of_tile"], W_, 2)
             + lay.n_blocks * rows * DIM * 4, [(2 * nnz * DIM, BF16_FLOPS)])


def window_fuzz(params, log):
    """[window kernels] on small layouts: W 128/256/512 with block_rows
    128/256/512, int8 and int4 counts, on-demand, a last block without a
    real tile, pad_tiles_to padding, blocks whose first tile is a dummy;
    f32 and bf16."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    r = np.random.default_rng(22)
    N, T2 = 2048, 2 * EDGE_TYPES
    for W_, rows in ((128, 128), (256, 256), (512, 512)):
        E = 40_000
        dst = r.integers(0, N - rows, E)
        src = np.where(r.random(E) < 0.9,
                       (dst // 256) * 256 + r.integers(0, 256, E),
                       r.integers(0, N, E)) % N
        edges = (src, dst, r.integers(0, T2, E), np.ones(E, np.float32))
        for mode in ("table", "packed", "ondemand"):
            if mode == "packed" and W_ < 256:
                continue
            kw = dict(window=W_, block_rows=rows, n_message_types=T2,
                      row_major="block", min_edges_per_tile=4,
                      pack_counts=mode == "packed")
            if mode == "ondemand":
                kw.update(on_demand=True, typed_spill=True)
            lay = W.build_window_layout(*edges, N, **kw)
            lay = W.build_window_layout(*edges, N, **kw,
                                        pad_tiles_to=lay.n_tiles + 300)
            a = lay.arrays
            if not (a["win_of_tile"][a["tile_start"][:-1]] < 0).any():
                raise AssertionError("window fuzz: no dummy-first block")
            check_window_layout(f"fuzz W{W_} rows{rows} {mode}",
                                lay.to("cuda"), params, log,
                                dtypes=(None, torch.float32))


def rand_step_weights(D, dtype, gen, T2=2 * EDGE_TYPES):
    """Random message and GRU weights at width D (the seam fuzz's models
    have no width of their own)."""
    import torch
    dev = torch.device("cuda")

    def rnd(*shape, scale=D ** -0.5):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    return (rnd(T2, D, D).to(dtype), rnd(T2, D, scale=0.1).to(dtype),
            dict(wa=rnd(D, 3 * D).to(dtype), b3=rnd(1, 3 * D, scale=0.1),
                 uzr=rnd(D, 2 * D).to(dtype), uh=rnd(D, D).to(dtype)))


def step_seam_layouts():
    """(tag, layout) at the seams of #13's bf16 kernel
    (csrc/window_step_fused.cuh): W 128, 256, 512 (1, 2, 4 chunks a
    window) with 128-, 256- and 512-row blocks (on-demand: clusters of 1,
    2, 4 CTAs), table and on-demand; dst block 0 with more than 256 real
    tiles (edges from every source block and type: the tile list is
    scanned 256 entries at a time), two blocks without any edge (init
    only), the last source block's windows addressed."""
    from ggnn_tpu_torch.ops import window as W
    r = np.random.default_rng(24)
    N, T2, E = 10_240, 2 * EDGE_TYPES, 60_000
    for W_, rows in ((128, 128), (256, 256), (512, 512), (128, 512),
                     (512, 128)):
        hub = r.random(E) < 0.3
        dst = np.where(hub, r.integers(0, rows, E), r.integers(0, N, E))
        src = np.where(hub, r.integers(0, N, E),
                       (dst // 512) * 512 + r.integers(0, 512, E)) % N
        src[:64] = N - 1 - r.integers(0, 128, 64)
        for blk in (2, N // rows - 1):
            sel = dst // rows == blk
            dst[sel] = rows + dst[sel] % rows
        typ = r.integers(0, T2, E)
        for on_demand in (False, True):
            kw = dict(window=W_, block_rows=rows, n_message_types=T2,
                      row_major="block", min_edges_per_tile=2)
            if on_demand:
                kw.update(on_demand=True, typed_spill=True)
            lay = W.build_window_layout(src, dst, typ,
                                        np.ones(E, np.float32), N, **kw)
            a = lay.arrays
            real = a["win_of_tile"] >= 0
            first = int(real[a["tile_start"][0]:a["tile_start"][1]].sum())
            per = np.bincount(a["block_of_tile"][real],
                              minlength=lay.n_blocks)
            if first <= 256 or (per == 0).sum() < 2:
                raise AssertionError(f"step seams W{W_} rows{rows}: block 0 "
                                     f"has {first} real tiles, "
                                     f"{(per == 0).sum()} blocks none")
            yield (f"W{W_} rows{rows} {'on-demand' if on_demand else 'table'}"
                   f" (block 0: {first} real tiles)"), lay


def check_step_case(tag, lay, src, D, dtype, emit_res, gen, log):
    """#13 on one layout, source, width and dtype against its plain version
    (h' and a per row within 8 ulps of max(1, max|a_row|), z, r, h̃ within
    8 ulps), twice bit-equal; with emit_res the residuals' h' is the
    serving kernel's, and a block without a real tile has a = init
    exactly."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    a = lay.arrays
    nb, rows, W_ = lay.n_blocks, lay.block_rows, lay.window
    n_rows = nb * rows
    T2 = 2 * EDGE_TYPES
    w, b, gw = rand_step_weights(D, dtype, gen, T2)
    h = torch.rand(n_rows, D, device=dev, generator=gen) * 2 - 1
    hc = h[:lay.n_nodes_pad].to(dtype)
    init = torch.randn(n_rows, D, device=dev, generator=gen) * 0.3
    if src == "on-demand":
        tab, kw = hc, dict(msg_w=w, msg_b=b)
    elif src == "table":
        tab, kw = TB.node_table(hc, w, b, "block"), {}
    else:
        tab, sc = TB.node_table_block_major_q8(hc, w, b, W_)
        kw = dict(scales=sc[:, 0])
    sk = dict(n_blocks=nb, window=W_, out_rows=rows, packed=False,
              c_off=a["c_off"], **kw)
    stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
              a["win_of_tile"])
    args = (tab, *stream, init, h, gw["wa"], gw["b3"], gw["uzr"], gw["uh"])
    dn = str(dtype).split(".")[-1]
    name = (f"window_step_gru{'[emit_res]' if emit_res else ''}"
            f"[seam {tag},{src},D={D},{dn}")
    got = W.window_step_gru(*args, emit_res=emit_res, **sk)
    again = W.window_step_gru(*args, emit_res=emit_res, **sk)
    ref = W.window_step_gru_reference(*args, emit_res=emit_res, **sk)
    a_ref = W.window_sums_reference(
        tab, a["c_stream"], a["block_of_tile"], a["win_of_tile"], a["c_off"],
        nb, W_, rows, False, init=init, **kw).float()
    a_rows = a_ref.abs().amax(1).clamp_min(1.0)
    if not emit_res:
        same_twice("window_step_gru", name[len("window_step_gru["):], got,
                   again)
        check(f"{name}]", got, ref, "flip_rows", dtype, log, a_rows=a_rows)
        return
    for part, x, y in zip(("h", "resid"), got, again):
        same_twice("window_step_gru[emit_res]", f"seam {tag},{part}", x, y)
    if not torch.equal(W.window_step_gru(*args, **sk), got[0]):
        raise AssertionError(f"{name}]: h' differs from the serving "
                             f"kernel's")
    (got, res), (ref, rres) = got, ref
    check(f"{name},h]", got, ref, "flip_rows", dtype, log, a_rows=a_rows)
    check(f"{name},a]", res[:, :D], rres[:, :D], "flip_rows", dtype, log,
          a_rows=a_rows)
    check(f"{name},zrh]", res[:, D:], rres[:, D:], "flip", dtype, log)
    real = a["win_of_tile"] >= 0
    per = torch.zeros(nb, device=dev).index_add_(
        0, a["block_of_tile"].long(), real.float())
    empty = (per == 0).repeat_interleave(rows)
    if not torch.equal(res[empty, :D], init[empty].to(dtype)):
        raise AssertionError(f"{name}]: a block without a real tile has a "
                             f"!= init")


def window_step_seam_fuzz(log):
    """[window kernels] #13 at the seams of its bf16 kernel
    (:func:`step_seam_layouts`), D = 4, 8 (zero-padded to the D = 128
    kernel) and 128 in bf16, and D = 128 in f32 (the first version's body):
    the table, q8 (D = 128, bf16) and on-demand sources, with and without
    emit_res (not q8)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(26)
    for tag, lay in step_seam_layouts():
        lay = lay.to("cuda")
        print(f"[window kernels] step seams {tag}: {lay.n_blocks} blocks, "
              f"{lay.n_tiles} tiles", flush=True)
        for D in (4, 8, 128):
            for dtype in ((torch.bfloat16, torch.float32) if D == DIM
                          else (torch.bfloat16,)):
                srcs = (("on-demand",) if lay.on_demand else
                        ("table", "q8") if D == DIM and dtype ==
                        torch.bfloat16 else ("table",))
                for src in srcs:
                    for emit_res in ((False,) if src == "q8"
                                     else (False, True)):
                        check_step_case(tag, lay, src, D, dtype, emit_res,
                                        gen, log)
        del lay
        torch.cuda.empty_cache()


def ondemand_seam_layouts():
    """(tag, layout) at the seams of #12's bf16 kernel
    (csrc/window_ondemand_fused.cu): W 128, 256, 512 (1, 2, 4 chunks a
    window) with 128-, 256- and 512-row blocks (clusters of 1, 2, 4 CTAs),
    on-demand with the XW spill; dst block 0 a hub whose real tiles are
    cut into many work items, block 1 the block of a single real tile, two
    blocks without any edge, the last source block's windows addressed."""
    from ggnn_tpu_torch.ops import window as W
    r = np.random.default_rng(27)
    N, T2, E = 10_240, 2 * EDGE_TYPES, 60_000
    for W_, rows in ((128, 128), (256, 256), (512, 512), (128, 512),
                     (512, 128), (256, 128)):
        hub = r.random(E) < 0.3
        dst = np.where(hub, r.integers(0, rows, E),
                       r.integers(2 * rows, N, E))
        src = np.where(hub, r.integers(0, N, E),
                       (dst // 512) * 512 + r.integers(0, 512, E)) % N
        src[:64] = N - 1 - r.integers(0, 128, 64)
        typ = r.integers(0, T2, E)
        one = np.arange(E - 8, E)    # block 1: 8 edges of one window
        dst[one], src[one] = rows + one % rows, 5 * 128 + one % 128
        typ[one] = 0
        for blk in (3, N // rows - 1):
            sel = dst // rows == blk
            dst[sel] = 2 * rows + dst[sel] % rows
        lay = W.build_window_layout(
            src, dst, typ, np.ones(E, np.float32), N, window=W_,
            block_rows=rows, n_message_types=T2, row_major="block",
            min_edges_per_tile=2, on_demand=True, typed_spill=True)
        a = lay.arrays
        real = a["win_of_tile"] >= 0
        per = np.bincount(a["block_of_tile"][real], minlength=lay.n_blocks)
        if (per[0] <= 4 * W.ONDEMAND_SPLIT or per[1] != 1
                or (per == 0).sum() < 2):
            raise AssertionError(f"#12 seams W{W_} rows{rows}: blocks 0 and "
                                 f"1 hold {per[0]} and {per[1]} real "
                                 f"tiles, {(per == 0).sum()} blocks none")
        yield (f"W{W_} rows{rows} (block 0: {per[0]} real tiles, "
               f"{-(-per[0] // W.ONDEMAND_SPLIT)} items)"), lay


def ondemand_seam_fuzz(log):
    """[window kernels] #12 at the seams of its bf16 kernel
    (:func:`ondemand_seam_layouts`), D = 4 (zero-padded to the D = 128
    kernel) and 128, against its plain version per element, twice
    bit-equal; a block without a real tile is exactly 0."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    gen = torch.Generator(device="cuda").manual_seed(28)
    for tag, lay in ondemand_seam_layouts():
        lay = lay.to("cuda")
        a = lay.arrays
        nb, rows, W_ = lay.n_blocks, lay.block_rows, lay.window
        print(f"[window kernels] #12 seams {tag}: {nb} blocks, "
              f"{lay.n_tiles} tiles", flush=True)
        stream = (a["c_stream"], a["tile_start"], a["block_of_tile"],
                  a["win_of_tile"])
        lay_args = (a["c_stream"], a["block_of_tile"], a["win_of_tile"],
                    a["c_off"], nb, False)
        real = a["win_of_tile"] >= 0
        per = torch.zeros(nb, device="cuda").index_add_(
            0, a["block_of_tile"].long(), real.float())
        for D in (4, DIM):
            w, b, _ = rand_step_weights(D, torch.bfloat16, gen)
            h = (torch.rand(lay.n_nodes_pad, D, device="cuda",
                            generator=gen) * 2 - 1).to(torch.bfloat16)
            args = (h, w, b, *stream, a["c_off"], nb, W_, rows)
            got = W.window_block_spmm_ondemand(*args)
            same_twice("window_block_spmm_ondemand", f"seam {tag},D={D}",
                       got, W.window_block_spmm_ondemand(*args))
            check(f"window_block_spmm_ondemand[seam {tag},D={D}]", got,
                  W.window_block_spmm_ondemand_reference(*args), "bound",
                  torch.bfloat16, log, bound=window_sums_bound(
                      h, lay_args, W_, rows, msg_w=w, msg_b=b, flip=True))
            if (got.reshape(nb, rows, D)[per == 0] != 0).any():
                raise AssertionError(f"#12 seams {tag}: a block without a "
                                     "real tile is not 0")
        del lay
        torch.cuda.empty_cache()


def window_bwd_seam_fuzz(log):
    """[window train] #14 at the seams of its bf16 kernel
    (csrc/window_bwd_fused.cu): S = 1, 2, 4 slabs a window (W 128, 256,
    512; 128-, 256- and 512-row blocks, and 256 under W 512), a number of
    source blocks that is not a multiple of the card's group size, a
    window addressed by every dst block (source block 0), windows without
    a real tile (source block 3 sends nothing), ā whose int8 scales differ
    by block (powers of 2 over 2**-6 .. 2**6); D = 128, 256 and 384 (the
    wider ones on the first version's body) in bf16 and D = 128 in f32,
    exact and int8 ā (check_window_bwd)."""
    import torch
    from ggnn_tpu_torch.ops import _build
    from ggnn_tpu_torch.ops import window as W
    r = np.random.default_rng(25)
    T2 = 2 * EDGE_TYPES
    for W_, rows in ((128, 128), (256, 256), (512, 512), (512, 256)):
        slots = min(_build.library().ggnn_window_bwd_slots(q, W_ // 128)
                    for q in (0, 1))
        n_src = next(n for n in range(slots + 1, 8 * slots)
                     if n % -(-n // slots) and n % (rows // 128) == 0)
        group = -(-n_src // slots)
        N = 128 * n_src
        E = 16 * N
        dst = r.integers(0, N - rows, E)
        src = np.where(r.random(E) < 0.95,
                       (dst // 256) * 256 + r.integers(0, 256, E),
                       r.integers(0, N, E)) % N
        hub = r.random(E) < 0.3
        src[hub] = r.integers(0, 128, int(hub.sum()))
        quiet = src // 128 == 3
        src[quiet] = src[quiet] + 128
        edges = (src, dst, r.integers(0, T2, E), np.ones(E, np.float32))
        lay = W.build_window_layout(*edges, N, window=W_, block_rows=rows,
                                    n_message_types=T2, row_major="block",
                                    min_edges_per_tile=16, with_grad=True)
        if not lay.grad_meta[4]:
            raise AssertionError("bwd seams: not the fused path")
        a = lay.arrays
        per_win = np.diff(a["gt_tile_start"])
        tag = (f"seam W{W_} rows{rows} n_src {n_src} (group {group} of "
               f"{slots} clusters)")
        print(f"[window train] bwd seams {tag}: largest window "
              f"{per_win.max()} tiles, {(per_win <= 1).sum()} of "
              f"{per_win.size} windows without a real tile", flush=True)
        lay = lay.to("cuda")
        for D in (DIM, 2 * DIM, 3 * DIM):
            for dtype in ((torch.bfloat16, torch.float32) if D == DIM
                          else (torch.bfloat16,)):
                check_window_bwd(f"{tag},D={D}", lay, log, dtype, D=D,
                                 spread=True)
        del lay
        torch.cuda.empty_cache()


def window_kernels_phase(params, log, timings):
    """[window kernels]: the fuzz layouts, then the community headline's
    two bench layouts (bench.py:466-488: on-demand with the XW spill, and
    the q8 record's table with the XW spill; W 512, block_rows 512),
    checked and timed."""
    import torch
    window_fuzz(params, log)
    window_step_seam_fuzz(log)
    ondemand_seam_fuzz(log)
    q8_table_seam_fuzz(log)
    t0 = time.perf_counter()
    b = community_batch()
    print(f"[window kernels] community batch made (or reused) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    layouts = {}
    for name, on_demand in (("on-demand", True), ("q8 table", False)):
        t1 = time.perf_counter()
        lay = bench_window_layout(b, 512, on_demand, True)
        t2 = time.perf_counter()
        layouts[name] = lay.to("cuda")
        torch.cuda.synchronize()
        print(f"[window kernels] headline {name} layout built on the host in "
              f"{t2 - t1:.2f} s, copied in {time.perf_counter() - t2:.2f} s; "
              f"stats {lay.stats}", flush=True)
    for name, lay in layouts.items():
        check_window_layout(f"headline {name}", lay, params, log,
                            timings=timings)
    del layouts
    torch.cuda.empty_cache()
    # #11 on the bench's --pack layout (int4 counts, the legacy spill)
    t1 = time.perf_counter()
    lay = bench_window_layout(b, 512, False, False, pack=True).to("cuda")
    torch.cuda.synchronize()
    print(f"[window kernels] headline packed layout built and copied in "
          f"{time.perf_counter() - t1:.2f} s; stats {lay.stats}", flush=True)
    w, bias, _ = window_weights(params, torch.bfloat16)
    h = (torch.rand(NODES, DIM, device="cuda") * 2 - 1).to(torch.bfloat16)
    from ggnn_tpu_torch.ops import table as TB
    time_window_mono("headline packed", lay, TB.node_table(h, w, bias,
                                                           "block"))
    del lay, b
    torch.cuda.empty_cache()


def window_serve_phase(params):
    """[window serve]: one community request through the window
    Predictor (its own window_layout_for_batch: static budgets, the legacy
    spill, block_rows 128), fused, bf16; then the bench's window_community
    layout (on-demand, XW spill, block_rows 512) and window_community_q8
    layout (q8 table, XW spill) through run_batch, fused, and each of the
    two unfused (#12; #10 and #11's 512-row counts), one request each.
    Every request's scores against the port's plain path on the card (the
    q8 request's plain path keeps the kernel's q8 table, which #15's own
    check holds against its plain version: a table element one quantum
    apart moves a sum by count·2^e, far past a bf16 ulp).  Returns the
    launch counts."""
    import torch
    from ggnn_tpu_torch.graph import batch_graphs
    launched = dict.fromkeys(KERNELS, 0)
    spill = {"window_block_spmm_mono": STEPS}
    torch.cuda.reset_peak_memory_stats()
    # one request at a time: each static-budget layout holds a 16.5 GB
    # count stream on the card
    for seed in EARLIER_REQUESTS:
        for k, v in serve(params, True, [(seed, community_graph(seed))], {},
                          dict(spill, node_table_block_major=STEPS,
                               window_step_gru=STEPS),
                          tag="window serve", layout_fn=lambda pred, batch:
                          pred.layout(batch), plain_fn=plain_run,
                          label="fused (Predictor.layout: "
                                "window_layout_for_batch)",
                          cfg_kw=dict(backend="window")).items():
            launched[k] += v
        torch.cuda.empty_cache()
    print(f"[window serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    one = [(0, community_graph(0))]
    from ggnn_tpu_torch.graph import PaddingSpec
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    bb = batch_graphs([one[0][1]], spec)
    t0 = time.perf_counter()
    lay_od = bench_window_layout(bb, 512, True, True).to("cuda")
    t1 = time.perf_counter()
    lay_q8 = bench_window_layout(bb, 512, False, True).to("cuda")
    torch.cuda.synchronize()
    print(f"[window serve] bench layouts of request 0: on-demand "
          f"{t1 - t0:.2f} s, q8 table {time.perf_counter() - t1:.2f} s "
          f"(host build and copy)", flush=True)
    runs = (
        ("window_community (on-demand, XW spill, fused)", lay_od,
         dict(fuse_gru=True), dict(spill, window_step_gru=STEPS), ()),
        ("window_community_q8 (q8 table, XW spill, fused)", lay_q8,
         dict(fuse_gru=True, quantized_table=True),
         dict(spill, node_table_block_major_q8=STEPS, window_step_gru=STEPS),
         ("node_table_block_major_q8",)),
        ("on-demand, unfused", lay_od, dict(fuse_gru=False),
         dict(window_block_spmm_ondemand=STEPS, window_block_spmm_mono=STEPS,
              gru_cell_fwd=STEPS), ()),
        ("bf16 table, unfused", lay_q8, dict(fuse_gru=False),
         dict(node_table_block_major=STEPS, window_block_spmm_mono=2 * STEPS,
              gru_cell_fwd=STEPS), ()),
    )
    for label, lay, kw, want, keep in runs:
        fuse = kw.pop("fuse_gru")
        for k, v in serve(params, fuse, one, {}, want, tag="window serve",
                          layout_fn=lambda pred, batch, lay=lay: lay,
                          plain_fn=lambda pred, batch, layout, keep=keep:
                          plain_run(pred, batch, layout, keep),
                          label=label, stepwise=(window_stepwise(keep)
                                                 if keep else False),
                          cfg_kw=dict(backend="window", **kw)).items():
            launched[k] += v
    del lay_od, lay_q8
    torch.cuda.empty_cache()
    return launched


def window_stepwise(keep):
    """Each fused window step of a served request against the plain step
    from the same input state (the plain path keeping the kernels named in
    ``keep``): per row within 8 bf16 ulps of max(1, max|a_row|), mean within
    1e-3.  A q8 request is checked so: the int8 table of each step is a
    function of that step's h, so two paths whose h differ in last bits
    quantize a few elements a quantum apart from the next step on, and
    their states drift apart by more than their rounding over the steps
    (the drift of the scores is reported)."""
    def run(pred, batch, layout, tag, log):
        import torch
        from ggnn_tpu_torch.models.ggnn import init_state
        from ggnn_tpu_torch.ops import window_step as WS
        cfg, prop = pred.cfg, pred.params["prop"]
        cdt = torch.bfloat16
        w, b = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
        ann = torch.as_tensor(batch.annotations, device="cuda")
        h = init_state(ann, cfg.state_dim)
        with torch.inference_mode():
            for t in range(cfg.n_steps):
                got = WS.gru_window_step(h, layout, w, b, prop["gru"],
                                         quantized=cfg.quantized_table)
                with plain_versions(keep):
                    ref = WS.gru_window_step(h, layout, w, b, prop["gru"],
                                             quantized=cfg.quantized_table)
                    a_ref = WS.aggregate_window(h.to(cdt), layout, w, b)
                check(f"{tag} step {t}", got, ref, "flip_rows", cdt, log,
                      a_rows=a_ref.abs().amax(1).clamp_min(1.0))
                h = got
    return run


def window_1m_phase(params, log):
    """[window 1m]: bench.py's window_community_1m (bench.py:508-523):
    1,000,000 nodes (1,000,192 padded) in 4,096 communities, 10M logical /
    20M directed edges, the headline model, a prebuilt bf16 table, the
    legacy spill, block_rows 256, W 512: one 5-step fused forward through
    propagate, then each step from the same state against the plain step.
    Returns its launch counts."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.models.ggnn import init_state, propagate
    from ggnn_tpu_torch.ops import window_step as WS
    t0 = time.perf_counter()
    b = synthetic_batch(NODES_W1M, EDGES_W1M, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=256,
                        n_communities=COMMUNITIES_W1M, p_intra=0.95)
    t1 = time.perf_counter()
    lay = bench_window_layout(b, 256, False, False)
    t2 = time.perf_counter()
    lay = lay.to("cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    print(f"[window 1m] batch ({b.spec.n_pad} nodes, "
          f"{int(b.edge_mask.sum())} directed edges) made in {t1 - t0:.2f} s;"
          f" layout built on the host in {t2 - t1:.2f} s and copied in "
          f"{t3 - t2:.2f} s; stats {lay.stats}; spill meta "
          f"{lay.spill_meta[:2]}", flush=True)
    cfg = headline_cfg(compute_dtype="bfloat16", fuse_gru=True)
    cfg = type(cfg)(**{**cfg.__dict__, "backend": "window"})
    prop = params["prop"]
    ann = torch.as_tensor(b.annotations, device="cuda")
    edges = [torch.as_tensor(x) for x in (b.edge_src, b.edge_dst,
                                          b.edge_type, b.edge_mask)]
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = propagate(prop, cfg, ann, *edges, scatter_layout=lay)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    spill_kernel = ("window_block_spmm_mono" if lay.spill_meta[6] is not None
                    else "onehot_segment_scatter_flat")
    expect_counts("window 1m", launches, {
        "node_table_block_major": STEPS, "window_step_gru": STEPS,
        spill_kernel: STEPS})
    if not torch.isfinite(h).all() or tuple(h.shape) != (b.spec.n_pad, DIM):
        raise AssertionError("window 1m: bad states")
    print(f"[window 1m] forward ({STEPS} steps) {1e3 * (t1 - t0):.2f} ms on "
          f"the card (host clock around it), peak device memory "
          f"{peak:.2f} GiB; {2 * EDGES_W1M * STEPS / (t1 - t0):.4e} "
          f"directed-edges*T/s; launches {launches}", flush=True)
    del h
    cdt = torch.bfloat16
    w, bias = prop["msg_w"].to(cdt), prop["msg_b"].to(cdt)
    h = init_state(ann, DIM)
    with torch.inference_mode():
        for t in range(STEPS):
            got = WS.gru_window_step(h, lay, w, bias, prop["gru"])
            with plain_versions():
                a_ref = WS.aggregate_window(h.to(cdt), lay, w, bias)
                ref = WS.gru_window_step(h, lay, w, bias, prop["gru"])
            check(f"window 1m step {t}", got, ref, "flip_rows", cdt, log,
                  a_rows=a_ref.abs().amax(1).clamp_min(1.0))
            h = got
            del a_ref, ref
    del lay, b, h
    torch.cuda.empty_cache()
    return launches


# --- [1m train]: the reference's two single-device training configurations
# at 1M nodes (tests/test_perf_thresholds.py:65-69 and :87-89), under remat

TRAIN_1M = ("1m_train_window", "1m_uniform_train_onehot")


def batch_1m(name):
    """The cell's batch: 1,000,000 nodes, 10M logical / 20M directed edges,
    8 types, seed 0; 1m_train_window in 4,096 communities (95 % of the
    edges inside), padded to 256 rows (1,000,192), the uniform one to 128
    (1,000,064)."""
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    if name == "1m_train_window":
        return synthetic_batch(NODES_W1M, EDGES_W1M, EDGE_TYPES,
                               annotation_dim=ANN, seed=0, node_mult=256,
                               n_communities=COMMUNITIES_W1M, p_intra=0.95)
    return synthetic_batch(NODES_W1M, EDGES_W1M, EDGE_TYPES,
                           annotation_dim=ANN, seed=0, node_mult=128)


def layout_1m(name, b):
    """The cell's with_grad layout as bench.py builds it: the window one
    (bench.py:209-244) with block_rows 256, on-demand windows and the XW
    spill that prefer_xw_spill picks for on-demand; the typed pack
    (bench.py:277-283) with block mode 'auto'."""
    if name == "1m_train_window":
        return bench_window_layout(b, 256, True, True, with_grad=True)
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    return build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                  b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES,
                                  with_grad=True, block_mode="auto")


def cell_1m(name, lay):
    """(config fields, kernel -> launches per Adam step) of the cell's
    fused remat step.  Under ``torch.utils.checkpoint`` grad mode is on in
    the first forward, so each step's training forward runs twice (there
    and in the backward's recompute) and its backward once: window, #13
    ``emit_res`` and the XW spill's #11 2T, #4, #14 and the spill
    backward's #11 T; onehot, #1 (#7 where block mode declines) 2T and #5
    T."""
    if name == "1m_train_window":
        if not lay.grad_meta[4] or lay.spill_meta is None \
                or len(lay.spill_meta) <= 8:
            raise AssertionError(f"{name}: not the fused backward over the "
                                 "XW spill")
        per = {"window_step_gru[emit_res]": 2 * STEPS,
               "gru_cell_bwd": STEPS, "window_bwd_fused": STEPS}
        spill = ("window_block_spmm_mono" if lay.spill_meta[6] is not None
                 else "onehot_segment_scatter_flat")
        per[spill] = per.get(spill, 0) + 2 * STEPS
        sb = lay.grad_meta[3]
        if sb is not None:
            k = ("window_block_spmm_mono" if sb[6] is not None
                 else "onehot_segment_scatter_flat")
            per[k] = per.get(k, 0) + STEPS
        return dict(backend="window", fuse_gru=True, remat=True), per
    if lay.meta[5][0] != "octet":
        raise AssertionError(f"{name}: the grad half is not the octet layout")
    fwd = ("typed_block_scatter" if lay.block_meta is not None
           else "typed_onehot_scatter")
    return (dict(backend="onehot", fuse_gru=True, remat=True),
            {fwd: 2 * STEPS, "typed_grad_octet_scatter": STEPS})


def build_1m(name):
    """The cell's batch and its layout on the card, with host seconds, copy
    seconds and the layout's stats printed."""
    import torch
    t0 = time.perf_counter()
    b = batch_1m(name)
    t1 = time.perf_counter()
    lay = layout_1m(name, b)
    t2 = time.perf_counter()
    lay = lay.to("cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if name == "1m_train_window":
        stats = (f"stats {lay.stats}; grad_meta {lay.grad_meta[:2]} fused "
                 f"{lay.grad_meta[4]}; spill meta {lay.spill_meta[:2]}")
    else:
        stats = (f"tile_e {lay.meta[1]}, {lay.n_blocks} blocks, block mode "
                 f"{lay.block_meta}, grad_meta {lay.meta[5]}")
    n_bytes = sum(a.numel() * a.element_size() for a in lay.arrays.values())
    print(f"[1m train] {name}: batch ({b.spec.n_pad} nodes, "
          f"{int(b.edge_mask.sum())} directed edges) made in {t1 - t0:.2f} "
          f"s; with_grad layout built on the host in {t2 - t1:.2f} s and "
          f"copied in {t3 - t2:.2f} s ({n_bytes / 2 ** 30:.2f} GiB on the "
          f"card); {stats}", flush=True)
    return b, lay


def train_1m_phase():
    """[1m train]: the headline model trained at the reference's two 1M
    configurations, nothing cut: 1m_train_window (on-demand windows, the
    fused step, block_rows 256, W 512) and 1m_uniform_train_onehot (the
    typed pack, fused), both with ``remat=True``.  For each, 3 Adam steps
    through make_train_step (step ms, peak device memory, the launch counts
    per step), the first held to the plain path on the card.  Returns
    their launch counts."""
    import torch
    launched = dict.fromkeys(KERNELS, 0)
    for name in TRAIN_1M:
        b, lay = build_1m(name)
        fields, per_step = cell_1m(name, lay)
        got = train_headline(b, lay, {name: (fields, per_step)},
                             tag="1m train", f32_check=False)
        for k, v in got.items():
            launched[k] += v
        del b, lay
        torch.cuda.empty_cache()
    return launched


# --- [window train]: the window backend's training path (#13 emit_res, #14) --

def bwd_inputs(lay, dtype, seed, D=DIM, spread=False):
    """The fused backward's inputs at a with_grad layout's shapes: the
    transposed cotangent āᵀ (and its int8 form with scales), h and W;
    ``spread``: each dst block's ā scaled by its own power of 2 in
    [2**-6, 2**6], so the int8 form's scales differ by block."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_rows = lay.n_blocks * lay.block_rows
    n_wins = lay.grad_meta[0]
    T2 = n_wins * lay.window // lay.n_nodes_pad
    da = torch.randn(n_rows, D, device=dev, generator=gen)
    if spread:
        k = torch.randint(-6, 7, (lay.n_blocks,), device=dev, generator=gen)
        da = da * torch.exp2(k.float()).repeat_interleave(lay.block_rows)[
            :, None]
    q, sc = W.quantize_grad_pow2(da, lay.block_rows)
    h = (torch.rand(lay.n_nodes_pad, D, device=dev, generator=gen) * 2
         - 1).to(dtype)
    w = (torch.randn(T2, D, D, device=dev, generator=gen)
         * D ** -0.5).to(dtype)
    a = lay.arrays
    gt = (a["c_stream"], a["gt_tile_start"], a["gt_block_of_tile"],
          a["gt_win_of_tile"], a["gt_c_off"])
    kw = dict(n_wins=n_wins, window=lay.block_rows, out_rows=lay.window,
              t2=T2)
    return dict(exact=(da.to(dtype).t().contiguous(), None),
                int8=(q.t().contiguous(), sc)), gt, w, h, kw


def window_bwd_bound(lay, kw, da_t, sc, gt, w, h):
    """#14's bound on a layout: the count stream's real tiles, āᵀ (and its
    scales), W, h, the backward tile arrays and the outputs once; the
    nonzero counts' products (int8 with ``sc``) and the four [128, D]·[D,
    D] products of every non-empty slab."""
    import torch
    a = lay.arrays
    D = h.shape[1]
    real = a["gt_win_of_tile"] >= 0
    n_real = int(real.sum().item())
    nnz = int((a["c_stream"] != 0).sum().item())
    wins = torch.zeros(kw["n_wins"], device="cuda").index_add_(
        0, a["gt_block_of_tile"].long(), real.float())
    slabs = int((wins > 0).sum().item()) * (lay.window // 128)
    return roofline(
        n_real * lay.block_rows * lay.window + nbytes(da_t, w, h)
        + (0 if sc is None else nbytes(sc))
        + nbytes(*gt[1:]) + D * h.shape[0] * 4 + nbytes(w) * 2,
        [(2 * nnz * D, BF16_FLOPS if sc is None else INT8_OPS),
         (4 * slabs * 128 * D * D, BF16_FLOPS)])


def check_window_bwd(tag, lay, log, dtype, timings=None, D=DIM,
                     spread=False):
    """#14 against its plain version on a layout whose backward takes the
    fused path, exact and with int8 ā, per element: 2e-5 of the plain
    version on |ā|, |W|, |h| (f32 sums in another order), plus in bf16 one
    ulp of every slab value (Y rounds to bf16 from the kernel's f32 sum
    and the plain version's f64 one), mean ≤ 0.1 of it; each twice,
    bit-equal.  ``timings``: time the exact form (bf16) against its plain
    version, with its bound."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    forms, gt, w, h, kw = bwd_inputs(lay, dtype, 41, D, spread)
    dn = str(dtype).split(".")[-1]
    flip = BF16_ULP if dtype == torch.bfloat16 else 0.0
    for form, (da_t, sc) in forms.items():
        if form == "int8" and dtype != torch.bfloat16:
            continue
        args = (da_t, *gt, w, h)
        got = W.window_bwd_fused(*args, da_scales=sc, **kw)
        again = W.window_bwd_fused(*args, da_scales=sc, **kw)
        for part, x, y in zip(("dhT", "dWT"), got, again):
            same_twice("window_bwd_fused", f"{tag},{form},{dn},{part}", x, y)
        ref = W.window_bwd_fused_reference(*args, da_scales=sc, **kw)
        mag = W.window_bwd_fused_reference(
            da_t.abs(), *gt, w.abs(), h.abs(), da_scales=sc, **kw)
        for part, x, r, m in zip(("dhT", "dWT"), got, ref, mag):
            check(f"window_bwd_fused[{tag},{form},{dn},{part}]", x, r,
                  "bound", dtype, log, bound=(2e-5 + flip) * m)
        del got, again, ref, mag
    if timings is None:
        return
    for form, (da_t, sc) in forms.items():
        args = (da_t, *gt, w, h)
        bound = window_bwd_bound(lay, kw, da_t, sc, gt, w, h)
        local = {}
        time_pairs({"window_bwd_fused": (
            lambda args=args, sc=sc: W.window_bwd_fused(*args, da_scales=sc,
                                                        **kw),
            lambda args=args, sc=sc: W.window_bwd_fused_reference(
                *args, da_scales=sc, **kw), None, bound)}, local)
        print(f"  window_bwd_fused [{tag}, {form} ā] timed above "
              f"(no PyTorch call sums a count-matrix product into a fused "
              f"dh/dW epilogue: library_ms null)", flush=True)
        if form == "exact":
            timings["window_bwd_fused"] = local["window_bwd_fused"]
        else:
            timings["window_bwd_fused"]["int8_ms"] = \
                local["window_bwd_fused"]["ms"]


def check_emit_res(tag, lay, params, log, dtype, timings=None):
    """#13's emit_res form against its plain version (the same epilogue,
    rounding point for rounding point) at a layout's shapes: h' per row
    within 8 ulps of max(1, max|a_row|) (a rounds to T before the gate
    products), the residual a likewise, z, r, h̃ within 8 ulps at 1.0 and
    1e-3 on average; both outputs twice, bit-equal; the residuals' h' is
    the serving kernel's h', bit for bit."""
    import torch
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(43)
    a = lay.arrays
    nb, rows, W_ = lay.n_blocks, lay.block_rows, lay.window
    n_rows = nb * rows
    w, b, gw = window_weights(params, dtype)
    h = torch.rand(n_rows, DIM, device=dev, generator=gen) * 2 - 1
    hc = h[:lay.n_nodes_pad].to(dtype)
    init = torch.randn(n_rows, DIM, device=dev, generator=gen) * 0.3
    if lay.on_demand:
        tab, kw = hc, dict(msg_w=w, msg_b=b)
    else:
        tab, kw = TB.node_table(hc, w, b, "block"), {}
    sk = dict(n_blocks=nb, window=W_, out_rows=rows, packed=lay.packed[0],
              c_off=a["c_off"], **kw)
    args = (tab, a["c_stream"], a["tile_start"], a["block_of_tile"],
            a["win_of_tile"], init, h, gw["wa"], gw["b3"], gw["uzr"],
            gw["uh"])
    dn = str(dtype).split(".")[-1]
    got, res = W.window_step_gru(*args, emit_res=True, **sk)
    got2, res2 = W.window_step_gru(*args, emit_res=True, **sk)
    same_twice("window_step_gru[emit_res]", f"{tag},{dn},h", got, got2)
    same_twice("window_step_gru[emit_res]", f"{tag},{dn},resid", res, res2)
    serving = W.window_step_gru(*args, **sk)
    if not torch.equal(serving, got):
        raise AssertionError(f"window_step_gru[emit_res][{tag}]: h' differs "
                             f"from the serving kernel's")
    ref, rres = W.window_step_gru_reference(*args, emit_res=True, **sk)
    a_rows = rres[:, :DIM].float().abs().amax(1).clamp_min(1.0)
    name = f"window_step_gru[emit_res][{tag},{dn}"
    check(f"{name},h]", got, ref, "flip_rows", dtype, log, a_rows=a_rows)
    check(f"{name},a]", res[:, :DIM], rres[:, :DIM], "flip_rows", dtype, log,
          a_rows=a_rows)
    check(f"{name},zrh]", res[:, DIM:], rres[:, DIM:], "flip", dtype, log)
    del got2, res2, serving, ref, rres
    if timings is None:
        return
    real = a["win_of_tile"] >= 0
    n_real = int(real.sum().item())
    nnz = int((a["c_stream"] != 0).sum().item())
    read = (ondemand_h_bytes(a["win_of_tile"], W_, w.shape[0])
            if lay.on_demand else window_bytes(a["win_of_tile"], W_, 2))
    ops = [(2 * nnz * DIM, BF16_FLOPS), (12 * n_rows * DIM * DIM, BF16_FLOPS)]
    if lay.on_demand:
        ops.append((2 * n_real * W_ * DIM * DIM, BF16_FLOPS))
    bound = roofline(n_real * rows * W_ + read + 3 * n_rows * DIM * 4
                     + nbytes(res) + nbytes(*gw.values(), a["win_of_tile"],
                                            a["c_off"]), ops)
    time_pairs({"window_step_gru[emit_res]": (
        lambda: W.window_step_gru(*args, emit_res=True, **sk),
        lambda: W.window_step_gru_reference(*args, emit_res=True, **sk),
        None, bound)}, timings)


def check_y_path(tag, lay, log):
    """The backward's Y path (a layout whose fused backward does not
    apply): #11 over the transposed count stream ``ct_stream`` with roles
    swapped (out_rows = W, window = block_rows, int4 with pack_bwd), Y in
    bf16, against its plain version per element (flush_bound), twice
    bit-equal."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    a = lay.arrays
    gen = torch.Generator(device="cuda").manual_seed(44)
    n_rows = lay.n_blocks * lay.block_rows
    da = torch.randn(n_rows, DIM, device="cuda", generator=gen).to(
        torch.bfloat16)
    args = (a["ct_stream"], a["gt_tile_start"], a["gt_block_of_tile"],
            a["gt_win_of_tile"])
    kw = dict(n_blocks=lay.grad_meta[0], window=lay.block_rows,
              out_rows=lay.window, packed=lay.packed[1], c_off=a["gt_c_off"],
              out_dtype=torch.bfloat16)
    print(f"[window train] Y path {tag}: row_major {lay.row_major}, W "
          f"{lay.window}, block_rows {lay.block_rows}, packed "
          f"{lay.packed[1]}, {lay.grad_meta[1]} transposed tiles",
          flush=True)
    got = W.window_block_spmm_mono(da, *args, **kw)
    same_twice("window_block_spmm_mono", f"Y {tag}", got,
               W.window_block_spmm_mono(da, *args, **kw))
    ref = W.window_block_spmm_mono_reference(da, *args, **kw)
    check(f"window_block_spmm_mono[Y {tag}]", got, ref, "bound",
          torch.bfloat16, log, bound=flush_bound(
              lambda t: W.window_block_spmm_mono_reference(
                  t, *args, **dict(kw, out_dtype=torch.float32)),
              da, ref, torch.bfloat16))


def window_grad_fuzz(params, log):
    """[window train] on small layouts built with their grad half: #14 on
    layouts whose windows start with their dummy tile, with empty windows
    and a hub window (every dst block reads source block 0), at W 128,
    256, 512 and block_rows 128, 256, 512, bf16 and f32, exact and int8;
    #13's emit_res (table and on-demand); the Y path where the fused
    backward does not apply: odd T2 (3, W 256: windows straddle source
    blocks), 'src' rows with W 192 (a last slice of 64 rows) and 512, and
    int4 transposed counts (pack_bwd)."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    r = np.random.default_rng(23)
    N, T2 = 2048, 2 * EDGE_TYPES
    for W_, rows in ((128, 128), (256, 256), (512, 512), (512, 256)):
        E = 40_000
        dst = r.integers(0, N - rows, E)
        src = np.where(r.random(E) < 0.95,
                       (dst // 256) * 256 + r.integers(0, 256, E),
                       r.integers(0, N, E)) % N
        hub = r.random(E) < 0.02
        src[hub] = r.integers(0, 128, int(hub.sum()))
        edges = (src, dst, r.integers(0, T2, E), np.ones(E, np.float32))
        for ondemand in (False, True):
            kw = dict(window=W_, block_rows=rows, n_message_types=T2,
                      row_major="block", min_edges_per_tile=16,
                      with_grad=True)
            if ondemand:
                kw.update(on_demand=True, typed_spill=True)
            lay = W.build_window_layout(*edges, N, **kw)
            a = lay.arrays
            first = a["gt_tile_start"][:-1]
            if not ((a["gt_win_of_tile"][first] < 0)
                    & (np.diff(a["gt_tile_start"]) > 1)).any():
                raise AssertionError("window grad fuzz: no dummy-first window")
            if not lay.grad_meta[4]:
                raise AssertionError("window grad fuzz: not the fused path")
            lay = lay.to("cuda")
            tag = f"fuzz W{W_} rows{rows}{' on-demand' if ondemand else ''}"
            for dtype in (torch.bfloat16, torch.float32):
                if not ondemand:
                    check_window_bwd(tag, lay, log, dtype)
                check_emit_res(tag, lay, params, log, dtype)
    Nm = 32_768
    E = 400_000
    dst = r.integers(0, Nm, E)
    src = ((dst // 512) * 512 + r.integers(0, 512, E)) % Nm
    for name, T2_, kw in (
            ("odd T2", 3, dict(window=256, block_rows=256,
                               row_major="block")),
            ("src W192", T2, dict(window=192, row_major="src")),
            ("src W512", T2, dict(window=512, row_major="src")),
            ("packed", T2, dict(window=512, block_rows=256, pack_counts=True,
                                row_major="block"))):
        edges = (src, dst, r.integers(0, T2_, E), np.ones(E, np.float32))
        lay = W.build_window_layout(*edges, Nm, n_message_types=T2_,
                                    min_edges_per_tile=4, with_grad=True,
                                    **kw)
        if lay.grad_meta[4] or "ct_stream" not in lay.arrays:
            raise AssertionError(f"{name}: expected the Y path")
        check_y_path(name, lay.to("cuda"), log)


def window_vjp_check(tag, lay, params, log, prefix="[window train]"):
    """The unfused window step's aggregation VJP (the Y path or #14, the
    spill backward) against its plain version on the card, from a random
    state and cotangent: dh, dW, db within TOL_TRAIN's relative Frobenius
    bound.  A typed pack (``lay.meta[0]`` rows) is held so through
    ``aggregate_onehot`` (#1 or #7, then #5)."""
    import torch
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window_step as WS
    typed = isinstance(lay, S.ScatterLayout)
    agg = S.aggregate_onehot if typed else WS.aggregate_window
    n = lay.meta[0]
    gen = torch.Generator(device="cuda").manual_seed(45)
    w, b, _ = window_weights(params, torch.bfloat16)
    h = (torch.rand(n, DIM, device="cuda", generator=gen) * 2
         - 1).to(torch.bfloat16)
    da = torch.randn(n, DIM, device="cuda", generator=gen)

    def grads():
        xs = [t.detach().requires_grad_(True) for t in (h, w, b)]
        out = agg(xs[0], lay, xs[1], xs[2])
        return torch.autograd.grad((out * da).sum(), xs)

    got = grads()
    with plain_versions():
        ref = grads()
    tol = TOL_TRAIN["bfloat16"][0]
    errs = [(relfro(x, y), k) for k, x, y in zip(("dh", "dW", "db"), got,
                                                  ref)]
    ok = max(errs)[0] <= tol and all(torch.isfinite(x).all() for x in got)
    print(f"{prefix} {tag} the aggregation's VJP vs plain path: "
          f"rel_frobenius " + ", ".join(f"{k} {e:.3e}" for e, k in errs)
          + f" (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{tag}: the window VJP disagrees with the "
                             "plain path")


def time_wide_kernels(lay, D=256):
    """#3, #4, #13 (on-demand, and its emit_res form), #14 (exact ā) and
    #15 at a wide D on the community headline's shapes (the
    window_community_train layout, 262,144 rows), bf16, each against its
    plain version in turns (plain, kernel, kernel, plain), printed with its
    bound: the wide kernels' times for PERF.md (the kernels JSON holds the
    D = 128 ones)."""
    import torch
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(46)
    rn = lambda *s_, sc=1.0: torch.randn(*s_, device="cuda",
                                         generator=gen) * sc
    a = lay.arrays
    nb, rows, W_ = lay.n_blocks, lay.block_rows, lay.window
    n = nb * rows
    T2 = 2 * EDGE_TYPES
    h = torch.rand(n, D, device="cuda", generator=gen) * 2 - 1
    av = rn(n, D)
    wa, uzr, uh = (rn(D, k * D, sc=D ** -0.5).to(dt) for k in (3, 2, 1))
    b3 = rn(3 * D, sc=0.1)
    w, b = rn(T2, D, D, sc=D ** -0.5).to(dt), rn(T2, D, sc=0.1).to(dt)
    _, z, r, ht = G.gru_cell_fwd_reference(h, av, wa, b3, uzr, uh, mdt=dt)
    bargs = (rn(n, D), h.to(dt), av.to(dt), z, r, ht, wa, uzr, uh)
    sargs = (h.to(dt), a["c_stream"], a["tile_start"], a["block_of_tile"],
             a["win_of_tile"], rn(n, D, sc=0.3), h, wa, b3[None], uzr, uh)
    sk = dict(n_blocks=nb, window=W_, out_rows=rows, c_off=a["c_off"],
              msg_w=w, msg_b=b)
    real = int((a["win_of_tile"] >= 0).sum().item())
    nnz = int((a["c_stream"] != 0).sum().item())
    step_bytes = (real * rows * W_ + real * 128 * D * 2 + 3 * n * D * 4
                  + nbytes(wa, uzr, uh, w))
    step_ops = [(2 * nnz * D, BF16_FLOPS), (2 * real * W_ * D * D, BF16_FLOPS),
                (12 * n * D * D, BF16_FLOPS)]
    pairs = {
        "gru_cell_fwd": (
            lambda: G.gru_cell_fwd(h, av, wa, b3, uzr, uh, mdt=dt),
            lambda: G.gru_cell_fwd_reference(h, av, wa, b3, uzr, uh, mdt=dt),
            None, roofline(2 * n * D * 4 + n * D * 4 + 3 * n * D * 2
                           + nbytes(wa, uzr, uh),
                           [(12 * n * D * D, BF16_FLOPS)])),
        "gru_cell_bwd": (
            lambda: G.gru_cell_bwd(*bargs, mdt=dt),
            lambda: G.gru_cell_bwd_reference(*bargs, mdt=dt), None,
            roofline(n * D * 4 + 5 * n * D * 2 + 2 * n * D * 4
                     + 2 * nbytes(wa, uzr, uh),
                     [(24 * n * D * D, BF16_FLOPS)])),
        "window_step_gru": (
            lambda: W.window_step_gru(*sargs, **sk),
            lambda: W.window_step_gru_reference(*sargs, **sk), None,
            roofline(step_bytes, step_ops)),
        "window_step_gru[emit_res]": (
            lambda: W.window_step_gru(*sargs, emit_res=True, **sk),
            lambda: W.window_step_gru_reference(*sargs, emit_res=True, **sk),
            None, roofline(step_bytes + n * 4 * D * 2, step_ops)),
        "node_table_block_major_q8": (
            lambda: TB.node_table_block_major_q8(h.to(dt), w, b, W_),
            lambda: TB.node_table_block_major_q8_reference(h.to(dt), w, b,
                                                           W_), None,
            roofline(n * D * 2 + nbytes(w, b) + n * T2 * D + n * T2 // W_ * 4,
                     [(2 * n * T2 * D * D, BF16_FLOPS)]))}
    forms, gt, wb, hb, bkw = bwd_inputs(lay, dt, 48, D)
    bargs14 = (forms["exact"][0], *gt, wb, hb)
    pairs["window_bwd_fused"] = (
        lambda: W.window_bwd_fused(*bargs14, **bkw),
        lambda: W.window_bwd_fused_reference(*bargs14, **bkw), None,
        window_bwd_bound(lay, bkw, forms["exact"][0], None, gt, wb, hb))
    print(f"[window train] the wide kernels at D = {D}, {n} rows (timed "
          f"for PERF.md; the JSON line holds D = 128):", flush=True)
    time_pairs(pairs, {})


def window_train_phase(params, log, timings, timed_widths=TIMED_WIDTHS):
    """[window train]: the window backend's training path.  The fuzz
    layouts (:func:`window_grad_fuzz`), then bench.py's two window train
    records on the community headline (bench.py:495-535, its layout built
    with_grad: W 512, block_rows 512, on-demand, the XW spill, block-major
    rows): window_community_train (exact bf16 gradients, #14) and
    window_community_train_q8g (grad_quant: int8 ā).  For each: #14 and
    #13's emit_res against their plain versions at its shapes (timed), the
    unfused step's aggregation VJP against the plain path, then 3 Adam
    steps of the headline model through make_train_step (fused: per step
    and T, #13 emit_res, #4 on its residuals, #14, the spill's #11 forward
    and backward), the first against the plain path on the card.  Returns
    the launch counts of the train steps.  ``timed_widths``: the D at
    which :func:`time_wide_kernels` times the wide kernels."""
    import torch
    window_grad_fuzz(params, log)
    window_bwd_seam_fuzz(log)
    t0 = time.perf_counter()
    b = community_batch()
    print(f"[window train] community batch made (or reused) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    launched = dict.fromkeys(KERNELS, 0)
    for name, gq in (("window_community_train", False),
                     ("window_community_train_q8g", True)):
        t1 = time.perf_counter()
        lay = bench_window_layout(b, 512, True, True, with_grad=True,
                                  grad_quant=gq)
        t2 = time.perf_counter()
        lay = lay.to("cuda")
        torch.cuda.synchronize()
        print(f"[window train] {name}: with_grad layout built on the host in "
              f"{t2 - t1:.2f} s, copied in {time.perf_counter() - t2:.2f} s; "
              f"grad_meta {lay.grad_meta[:3]} fused {lay.grad_meta[4]} "
              f"grad_quant {lay.meta[10]}; stats {lay.stats}", flush=True)
        if not lay.grad_meta[4] or lay.meta[10] != gq:
            raise AssertionError(f"{name}: not the fused backward")
        if not gq:
            check_window_bwd("headline", lay, log, torch.bfloat16, timings)
            check_emit_res("headline on-demand", lay, params, log,
                           torch.bfloat16, timings)
            window_vjp_check(name, lay, params, log)
            time_spill_mono(lay, {})
            for D in timed_widths:
                time_wide_kernels(lay, D)
        spill = ("window_block_spmm_mono" if lay.spill_meta[6] is not None
                 else "onehot_segment_scatter_flat")
        sb = ("window_block_spmm_mono" if lay.grad_meta[3][6] is not None
              else "onehot_segment_scatter_flat")
        per_step = {"window_step_gru[emit_res]": STEPS,
                    "gru_cell_bwd": STEPS, "window_bwd_fused": STEPS}
        for k in (spill, sb):
            per_step[k] = per_step.get(k, 0) + STEPS
        got = train_headline(b, lay, {name: (
            dict(fuse_gru=True, backend="window"), per_step)},
            tag="window train", f32_check=False,
            grad_tol=TOL_Q8G if gq else None)
        for k, v in got.items():
            launched[k] += v
        del lay
        torch.cuda.empty_cache()
    del b
    return launched


def pallas_fuzz_edges(r, N, E, T2, empty=(), boundary=None, hub=0.0,
                      masked=0.1):
    """Type-sorted random edges (as graph.py sorts them) and their type
    offsets over every edge slot: the types in ``empty`` hold none, type
    ``boundary`` = (t, tile_e) holds a whole number of tiles, a share
    ``hub`` of the edges leaves node 0 and another enters node 1, and a
    share ``masked`` is masked (holes in their tiles)."""
    typ = r.integers(0, T2, E)
    for t in empty:
        typ[typ == t] = (t + 1) % T2
    if boundary is not None:
        t, tile_e = boundary
        sel = np.nonzero(typ == t)[0]
        keep = max(len(sel) // tile_e, 1) * tile_e
        if len(sel) >= keep:
            typ[sel[keep:]] = (t + 1) % T2
        else:
            typ[np.nonzero(typ != t)[0][:keep - len(sel)]] = t
    typ = np.sort(typ)
    src, dst = r.integers(0, N, E), r.integers(0, N, E)
    src[r.random(E) < hub] = 0
    dst[r.random(E) < hub] = 1
    mask = (r.random(E) >= masked).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(np.bincount(typ, minlength=T2))])
    return (src.astype(np.int32), dst.astype(np.int32), typ.astype(np.int32),
            mask, offs.astype(np.int32))


def check_packed_messages(tag, h, lay, w, b, log):
    """#16 against its plain version per element: 2e-5 of the plain version
    on |h|, |W|, |b| (the same f32 products of the same values, summed in
    another order), mean ≤ 0.1 of it; twice, bit-equal; every padding slot
    exactly zero."""
    from ggnn_tpu_torch.ops import spmm as SP
    args = (lay["src"], lay["mask"], lay["tile_type"])
    got = SP.packed_messages(h, *args, w, b, lay["tile_e"])
    same_twice("packed_messages", tag, got,
               SP.packed_messages(h, *args, w, b, lay["tile_e"]))
    ref = SP.packed_messages_reference(h, *args, w, b, lay["tile_e"])
    mag = SP.packed_messages_reference(h.abs(), lay["src"],
                                       lay["mask"].abs(), lay["tile_type"],
                                       w.abs(), b.abs(), lay["tile_e"])
    check(f"packed_messages[{tag}]", got, ref, "bound", h.dtype, log,
          bound=2e-5 * mag)
    if (got[lay["mask"] == 0] != 0).any():
        raise AssertionError(f"packed_messages[{tag}]: a padding slot "
                             "holds a nonzero message")


def cta_ranges(n_items, n_ctas):
    """The contiguous item ranges of the persistent kernels #10 and #16
    (``mma_pipe.cuh``): CTA x takes items [n·x/G, n·(x+1)/G)."""
    return [(n_items * x // n_ctas, n_items * (x + 1) // n_ctas)
            for x in range(n_ctas)]


def run_seams(tile_type, cpt, n_ctas):
    """How the runs of equal ``tile_type`` fall on the CTAs' ranges of
    128-row chunks (``cpt`` chunks a tile): (runs inside one range, runs
    across two or more)."""
    first = [a for a, _ in cta_ranges(len(tile_type) * cpt, n_ctas)]
    cta = np.searchsorted(first, np.arange(len(tile_type)) * cpt,
                          side="right") - 1
    last = np.searchsorted(first, np.arange(len(tile_type)) * cpt + cpt - 1,
                           side="right") - 1
    starts = np.concatenate([[0], np.nonzero(np.diff(tile_type))[0] + 1])
    ends = np.concatenate([starts[1:], [len(tile_type)]]) - 1
    across = int((last[ends] != cta[starts]).sum())
    return len(starts) - across, across


def packed_seam_layouts(r, n_ctas, N=2000):
    """Packed layouts at the seams of #16's persistent schedule, built by
    hand (tile_type in any order): an unsorted tile_type; type runs of 1,
    2, 3, 7 and 13 tiles on 6 chunks a CTA, so runs begin and end inside
    one CTA's range and across two (tile_e 128, and 256: two chunks a
    tile); a single tile; one type only; every third tile all padding
    between real ones.  Each has holes (masked slots).  Returns tag ->
    (layout dict, T2)."""
    def runs(n_tiles, T2):
        out, k = [], 0
        while len(out) < n_tiles:
            out += [k % T2] * (1, 2, 3, 7, 13)[k % 5]
            k += 1
        return np.array(out[:n_tiles])

    cases = {
        "unsorted": (128, r.integers(0, 6, 700), 6, False),
        "runs tile_e128": (128, runs(6 * n_ctas, 5), 5, False),
        "runs tile_e256": (256, runs(3 * n_ctas, 5), 5, False),
        "single tile": (128, np.array([2]), 3, False),
        "one type": (128, np.full(400, 1), 4, False),
        "padding between": (128, np.sort(r.integers(0, 6, 500)), 6, True),
    }
    out = {}
    for tag, (tile_e, tt, T2, pad_between) in cases.items():
        P = len(tt) * tile_e
        src = r.integers(0, N, P)
        mask = (r.random(P) >= 0.1).astype(np.float32)
        if pad_between:
            pad = np.repeat(np.arange(len(tt)) % 3 == 1, tile_e)
            src[pad], mask[pad] = 0, 0.0
        out[tag] = ({"src": src.astype(np.int32), "mask": mask,
                     "tile_type": tt.astype(np.int32), "tile_e": tile_e,
                     "n_tiles": len(tt)}, T2)
    return out


def packed_seam_fuzz(log, dims=(4, 6, 8, 13, 128, 200, 256, 384)):
    """[pallas kernels] #16 at the seams of its persistent schedule
    (:func:`packed_seam_layouts`, 128-column panels on the card's SMs), at
    ``dims`` in bf16 and f32 (6 and 13: the element-wise copies and stores
    of widths that are not whole 16-byte vectors), with
    check_packed_messages' criteria."""
    import torch
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    N = 2000
    for tag, (lay, T2) in packed_seam_layouts(np.random.default_rng(23),
                                              n_sm, N).items():
        inside, across = run_seams(lay["tile_type"],
                                   -(-lay["tile_e"] // 128), n_sm)
        print(f"[pallas kernels] seams {tag}: {lay['n_tiles']} tiles of "
              f"{lay['tile_e']}, T2 {T2}; at D <= 128 on {n_sm} CTAs "
              f"{inside} type runs inside one CTA's range, {across} across "
              f"two or more", flush=True)
        if tag.startswith("runs") and not (inside and across):
            raise AssertionError(f"seams {tag}: no run inside one CTA's "
                                 "range or none across two")
        lay = {k: (torch.as_tensor(v, device=dev)
                   if isinstance(v, np.ndarray) else v)
               for k, v in lay.items()}
        for D in dims:
            for dtype in (torch.bfloat16, torch.float32):
                gen = torch.Generator(device=dev).manual_seed(D)
                h = (torch.rand(N, D, device=dev, generator=gen) * 2
                     - 1).to(dtype)
                w = (torch.randn(T2, D, D, device=dev, generator=gen)
                     * D ** -0.5).to(dtype)
                bb = (torch.randn(T2, D, device=dev, generator=gen)
                      * 0.1).to(dtype)
                dn = str(dtype).split(".")[-1]
                check_packed_messages(f"seams {tag},D={D},{dn}", h, lay, w,
                                      bb, log)


def sddmm_first_body(p, q, src=None, dst=None, mask=None):
    """#17's first body (``csrc/sddmm.cu``, ``ggnn_sddmm``) on the
    arguments of ``sddmm_pallas``, called through its C entry point."""
    import torch
    from ggnn_tpu_torch.ops import _build
    E = src.shape[0] if src is not None else p.shape[0]
    out = torch.empty(E, dtype=torch.float32, device=p.device)
    ptr = _build.ptr
    _build.launch(_build.library().ggnn_sddmm, "sddmm_pallas", p.device,
                  ptr(p), p.shape[0], ptr(q), q.shape[0], p.shape[1],
                  ptr(src), ptr(dst), ptr(mask), E, ptr(out))
    return out


def check_sddmm(tag, p, q, log, **kw):
    """#17 against its plain version per element: 2e-5 of Σ|p||q| (f32
    sums in another order), mean ≤ 0.1 of it; twice, bit-equal.  With both
    index arrays also bit-equal to the first body (``sddmm.cu``: the
    blocked body sums each edge in its order) and to a run on copies of
    the index arrays (a new layout: the plan made anew)."""
    import torch
    from ggnn_tpu_torch.ops import spmm as SP
    got = SP.sddmm_pallas(p, q, **kw)
    same_twice("sddmm_pallas", tag, got, SP.sddmm_pallas(p, q, **kw))
    if kw.get("src") is not None and kw.get("dst") is not None:
        if not torch.equal(got, sddmm_first_body(p, q, **kw)):
            raise AssertionError(f"sddmm_pallas[{tag}]: not the first "
                                 f"body's bits")
        fresh = dict(kw, src=kw["src"].clone(), dst=kw["dst"].clone())
        if not torch.equal(got, SP.sddmm_pallas(p, q, **fresh)):
            raise AssertionError(f"sddmm_pallas[{tag}]: a new layout's "
                                 f"plan gives other bits")
        print(f"  sddmm_pallas[{tag}]: bit-equal to the first body and on "
              f"a new layout", flush=True)
    ref = SP.sddmm_pallas_reference(p, q, **kw)
    mag = SP.sddmm_pallas_reference(
        p.abs(), q.abs(), **{k: (v.abs() if k == "mask" else v)
                             for k, v in kw.items()})
    check(f"sddmm_pallas[{tag}]", got, ref, "bound", torch.float32, log,
          bound=2e-5 * mag)


def sddmm_seam_edges(seed, n_p, n_q, k):
    """Index arrays at the seams of #17's plan ((src slab, dst block of
    128 rows) keys cut into work items of at most ``k`` edges; these
    graphs have one slab): tag -> (src, dst) int32 on the card."""
    import torch
    r = np.random.default_rng(seed)
    blocks = -(-n_q // 128)
    hub = np.concatenate([np.zeros(3 * k + 5, np.int64),
                          r.integers(0, n_q, 2000)])
    rest = r.integers(0, n_q, 6000)
    keep = ~np.isin(rest // 128, (2, blocks - 1))
    uneven = r.integers(0, n_q, 10_037)
    cases = {
        "dst hub past 3 items": (r.integers(0, n_p, hub.size), hub),
        "empty blocks": (r.integers(0, n_p, int(keep.sum())), rest[keep]),
        "one edge": (np.array([n_p - 1]), np.array([n_q - 1])),
        "uneven, src hub": (np.where(np.arange(uneven.size) < 3000, 0,
                                     r.integers(0, n_p, uneven.size)),
                            uneven),
    }
    return {t: tuple(torch.as_tensor(x.astype(np.int32), device="cuda")
                     for x in c) for t, c in cases.items()}


def sddmm_seam_fuzz(log):
    """[pallas kernels] #17's blocked body at the seams of its plan: a dst
    hub past three work items, dst blocks without an edge (the last one
    too), one edge, 10,037 edges with a src hub, q of 1000 rows (a last
    block of 104), G = 4, 64 and 128, with and without a mask; then p of
    262,144 rows (4 src slabs at G = 128, 2 at G = 64); each with
    :func:`check_sddmm`'s criteria (the plain version, twice bit-equal,
    the first body's bits, a new layout's plan)."""
    import torch
    from ggnn_tpu_torch.ops import spmm as SP
    dev = torch.device("cuda")
    n_p, n_q = 1500, 1000
    for tag, (src, dst) in sddmm_seam_edges(
            23, n_p, n_q, SP.SDDMM_ITEM).items():
        E = src.shape[0]
        for G in (4, 64, 128):
            gen = torch.Generator(device=dev).manual_seed(G + E)
            p = torch.randn(n_p, G, device=dev, generator=gen)
            q = torch.randn(n_q, G, device=dev, generator=gen)
            mask = (torch.rand(E, device=dev, generator=gen) < 0.7).float()
            check_sddmm(f"seam {tag},G={G}", p, q, log, src=src, dst=dst)
            check_sddmm(f"seam {tag},G={G},masked", p, q, log, src=src,
                        dst=dst, mask=mask)
    # p of 262,144 rows: 4 src slabs at G = 128, 2 at G = 64
    n_p, E = 262_144, 40_000
    gen = torch.Generator(device=dev).manual_seed(29)
    src = torch.randint(0, n_p, (E,), device=dev, generator=gen,
                        dtype=torch.int32)
    dst = torch.randint(0, n_q, (E,), device=dev, generator=gen,
                        dtype=torch.int32)
    for G in (64, 128):
        p = torch.randn(n_p, G, device=dev, generator=gen)
        q = torch.randn(n_q, G, device=dev, generator=gen)
        plan = SP.sddmm_plan(src, dst, n_p, n_q, G)
        check_sddmm(f"seam {plan['n_keys'] // plan['n_qblk']} src slabs,"
                    f"G={G}", p, q, log, src=src, dst=dst)


def pallas_kernels_phase(b, log, timings):
    """[pallas kernels]: #16 ``packed_messages`` and #17 ``sddmm_pallas``
    against their plain versions, per element and twice bit-equal, on fuzz
    layouts (tile_e 8, 32 and 128; empty types; a type segment ending on a
    tile boundary; holes and all-padding tail tiles; a hub; f32 and bf16;
    #16 at D = 4, 8, 128, 200, 256 and 384; #17 at G = 5, 64 and 128 with E not
    a multiple of 128, with and without index arrays and mask), #16 at the
    seams of its persistent schedule (:func:`packed_seam_fuzz`), then both
    at the uniform headline's packed layout (bench.py --backend pallas:
    62,516 tiles of 128), timed against their plain versions and one
    PyTorch call each."""
    import torch
    from ggnn_tpu_torch.ops import spmm as SP
    dev = torch.device("cuda")
    r = np.random.default_rng(17)
    fuzz = {
        # tag: (N, E, T2, tile_e, empty types, boundary type, hub share,
        #       masked share)
        "tile_e8": (300, 2000, 6, 8, (2,), None, 0.0, 0.1),
        "tile_e32 boundary": (500, 5000, 8, 32, (), 1, 0.0, 0.0),
        "tile_e128 hub": (1000, 20_000, 16, 128, (5, 15), None, 0.3, 0.1),
        "tile_e128 masked": (700, 6000, 4, 128, (0,), 2, 0.05, 0.6),
    }
    for tag, (N, E, T2, tile_e, empty, bnd, hub, masked) in fuzz.items():
        cols = pallas_fuzz_edges(r, N, E, T2, empty,
                                 None if bnd is None else (bnd, tile_e),
                                 hub, masked)
        if bnd is not None and (cols[4][bnd + 1] - cols[4][bnd]) % tile_e:
            raise AssertionError(f"{tag}: type {bnd} does not end on a tile "
                                 "boundary")
        lay = SP.pack_type_tiles(*(torch.as_tensor(c, device=dev)
                                   for c in cols), T2, tile_e)
        live = lay["mask"].reshape(-1, tile_e).sum(1)
        print(f"[pallas kernels] fuzz {tag}: {lay['n_tiles']} tiles of "
              f"{tile_e}, {int((live == 0).sum().item())} without a real "
              f"edge; tile types {lay['tile_type'].tolist()[:40]}",
              flush=True)
        for D in (4, 8, 128, 200, 256, 384):
            for dtype in (torch.bfloat16, torch.float32):
                gen = torch.Generator(device=dev).manual_seed(D)
                h = (torch.rand(N, D, device=dev, generator=gen) * 2
                     - 1).to(dtype)
                w = (torch.randn(T2, D, D, device=dev, generator=gen)
                     * D ** -0.5).to(dtype)
                bb = (torch.randn(T2, D, device=dev, generator=gen)
                      * 0.1).to(dtype)
                dn = str(dtype).split(".")[-1]
                check_packed_messages(f"{tag},D={D},{dn}", h, lay, w, bb,
                                      log)
        for G in (64, 128):     # the pallas gate: the packed src and dst
            gen = torch.Generator(device=dev).manual_seed(G + N)
            p = torch.randn(N, G, device=dev, generator=gen)
            q = torch.randn(N, G, device=dev, generator=gen)
            check_sddmm(f"{tag},G={G},packed", p, q, log, src=lay["src"],
                        dst=lay["dst"])
    packed_seam_fuzz(log)
    sddmm_seam_fuzz(log)
    E = 10_000 + 37                 # not a multiple of 128
    for G in (5, 64, 128):
        gen = torch.Generator(device=dev).manual_seed(G)
        Np = 900
        p = torch.randn(Np, G, device=dev, generator=gen)
        q = torch.randn(Np, G, device=dev, generator=gen)
        src = torch.randint(0, Np, (E,), device=dev, generator=gen,
                            dtype=torch.int32)
        src[:E // 3] = 0            # a hub row
        dst = torch.randint(0, Np, (E,), device=dev, generator=gen,
                            dtype=torch.int32)
        mask = (torch.rand(E, device=dev, generator=gen) < 0.8).float()
        check_sddmm(f"G={G},indexed", p, q, log, src=src, dst=dst)
        check_sddmm(f"G={G},indexed,masked", p, q, log, src=src, dst=dst,
                    mask=mask)
        check_sddmm(f"G={G},gathered", p.index_select(0, src.long()),
                    q.index_select(0, dst.long()), log)

    t0 = time.perf_counter()
    T2 = 2 * EDGE_TYPES
    cols = [torch.as_tensor(x, device=dev) for x in (
        b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.type_offsets)]
    lay = SP.pack_type_tiles(*cols, T2)
    torch.cuda.synchronize()
    P_ = lay["src"].shape[0]
    n_real = int((lay["mask"] > 0).sum().item())
    budget = SP.tiles_budget(b.spec.e_pad, T2)
    print(f"[pallas kernels] headline: {lay['n_tiles']} tiles of "
          f"{lay['tile_e']} (tiles_budget {budget}), {n_real} real edges "
          f"in {P_} slots, packed on the card in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if lay["n_tiles"] != budget or n_real != int(b.edge_mask.sum()):
        raise AssertionError("headline: not the bench's packed layout")
    gen = torch.Generator(device=dev).manual_seed(19)
    h = (torch.rand(b.spec.n_pad, DIM, device=dev, generator=gen) * 2
         - 1).to(torch.bfloat16)
    w = (torch.randn(T2, DIM, DIM, device=dev, generator=gen)
         * DIM ** -0.5).to(torch.bfloat16)
    bb = (torch.randn(T2, DIM, device=dev, generator=gen) * 0.1).to(
        torch.bfloat16)
    check_packed_messages("headline,bf16", h, lay, w, bb, log)
    torch.cuda.empty_cache()
    args = (lay["src"], lay["mask"], lay["tile_type"])
    hs = h.index_select(0, lay["src"].long()).reshape(lay["n_tiles"],
                                                      lay["tile_e"], DIM)
    wg = w.index_select(0, lay["tile_type"].long())
    time_pairs({"packed_messages": (
        lambda: SP.packed_messages(h, *args, w, bb),
        lambda: SP.packed_messages_reference(h, *args, w, bb),
        lambda: torch.bmm(hs, wg),
        roofline(nbytes(h, *args, w, bb) + P_ * DIM * 4,
                 [(2 * n_real * DIM * DIM, BF16_FLOPS)]))}, timings)
    print("  packed_messages library call: torch.bmm of the tile-viewed "
          "h[src] with W[tile_type] (both gathered beforehand; bf16 out, "
          "no bias, no mask)", flush=True)
    del hs, wg
    torch.cuda.empty_cache()
    p = torch.randn(b.spec.n_pad, DIM, device=dev, generator=gen) * 0.1
    q = torch.randn(b.spec.n_pad, DIM, device=dev, generator=gen) * 0.1
    kw = dict(src=lay["src"], dst=lay["dst"])
    check_sddmm("headline", p, q, log, **kw)
    pg = p.index_select(0, lay["src"].long())
    qg = q.index_select(0, lay["dst"].long())
    time_pairs({"sddmm_pallas": (
        lambda: SP.sddmm_pallas(p, q, **kw),
        lambda: SP.sddmm_pallas_reference(p, q, **kw),
        lambda: torch.einsum("eg,eg->e", pg, qg),
        roofline(nbytes(p, q, lay["src"], lay["dst"]) + P_ * 4,
                 [(2 * P_ * DIM, F32_FLOPS)]))}, timings)
    print("  sddmm_pallas library call: torch.einsum('eg,eg->e') on the "
          "rows gathered beforehand", flush=True)
    time_sddmm_plan(p, q, lay)
    del pg, qg, lay
    torch.cuda.empty_cache()


def time_sddmm_plan(p, q, lay):
    """#17 on a new layout: its plan alone, and a launch on copies of the
    packed src and dst (the range checks, the plan and the kernel; the two
    copies included), against a launch on the layout seen before; the
    bytes the blocked body gathers (each edge's p row, each work item's q
    block, from L2 or HBM) and their time at the HBM rate."""
    import torch
    from ggnn_tpu_torch.ops import spmm as SP
    src, dst = lay["src"], lay["dst"]
    G = p.shape[1]
    make = lambda: SP.sddmm_plan(src, dst, p.shape[0], q.shape[0], G)
    plan_ms = cuda_ms(make, 5)
    new_ms = cuda_ms(lambda: SP.sddmm_pallas(p, q, src=src.clone(),
                                             dst=dst.clone()), 5)
    seen_ms = cuda_ms(lambda: SP.sddmm_pallas(p, q, src=src, dst=dst), 10)
    plan = make()
    n_items = int(plan["item_first"][-1].item())
    gather = (src.shape[0] * G + n_items * SP.SDDMM_BLOCK * G) * 4
    print(f"  sddmm_pallas on a new layout: plan {plan_ms:.3f} ms, launch "
          f"with checks and plan {new_ms:.3f} ms, on the layout seen "
          f"{seen_ms:.3f} ms; {n_items} work items of at most "
          f"{SP.SDDMM_ITEM} edges over {plan['n_keys']} (src slab, dst "
          f"block) keys ({plan['n_keys'] // plan['n_qblk']} slabs); "
          f"gathered rows {gather / 1e9:.3f} GB -> "
          f"{gather / HBM_BPS * 1e3:.4f} ms at the HBM rate", flush=True)


def pallas_stepwise(tag, cfg, prop, arrays, log):
    """Each step of propagate(backend='pallas') on a batch against the
    plain step from the same input state: per row within 8 bf16 ulps of
    max(1, max|a_row|) (the aggregation rounds to bf16 before the gate
    products), mean within 1e-3."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.init import torch_dtype
    from ggnn_tpu_torch.ops import spmm as SP
    one = dataclasses.replace(cfg, n_steps=1)
    cdt = torch_dtype(cfg.compute_dtype)
    edges = [arrays[k] for k in ("edge_src", "edge_dst", "edge_type",
                                 "edge_mask")]
    lay = SP.pack_type_tiles(*edges, arrays["type_offsets"],
                             cfg.n_message_types)
    h = arrays["annotations"].float()
    h = torch.nn.functional.pad(h, (0, cfg.state_dim - h.shape[1]))
    with torch.inference_mode():
        for t in range(cfg.n_steps):
            got = propagate(prop, one, h, *edges, tiles_layout=lay)
            with plain_versions():
                ref = propagate(prop, one, h, *edges, tiles_layout=lay)
                mask = None
                if cfg.edge_gates:
                    score = SP.sddmm_pallas_reference(
                        h @ prop["gate_p"].float(),
                        h @ prop["gate_q"].float(), lay["src"], lay["dst"])
                    mask = lay["mask"] * torch.sigmoid(score)
                a = SP.typed_aggregate_tiled(
                    h.to(cdt), lay, prop["msg_w"].to(cdt),
                    prop["msg_b"].to(cdt), mask=mask)
            check(f"{tag} step {t}", got, ref, "flip_rows", cdt, log,
                  a_rows=a.abs().amax(1).clamp_min(1.0))
            h = got


def pallas_serve_phase(b, log):
    """[pallas serve]: two requests (uniform graphs of the headline size)
    through ``Predictor(backend='pallas')``, ungated and with the edge
    gates (gate_dim 0: G = 128), the launch counts and the scores against
    the plain path; then the uniform headline batch through ``run_batch``:
    the launch counts of #16, #17 and #3, the device forward, the peak
    memory, and each step against the plain step.  Returns the launches."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.train.loop import batch_arrays
    launched = dict.fromkeys(KERNELS, 0)
    graphs = [(seed, request_graph(seed)) for seed in (0, 1)]
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    for gated in (False, True):
        label = "gated" if gated else "ungated"
        cfg = headline_cfg(backend="pallas", edge_gates=gated,
                           compute_dtype="bfloat16")
        params = init_params(cfg, torch.Generator().manual_seed(0), "cuda")
        per = {"packed_messages": STEPS, "gru_cell_fwd": STEPS}
        if gated:
            per["sddmm_pallas"] = STEPS
        torch.cuda.reset_peak_memory_stats()
        got = serve(params, False, graphs, {}, per, tag="pallas serve",
                    layout_fn=lambda pred, batch: None,
                    plain_fn=lambda pred, batch, layout: plain_run(
                        pred, batch, None),
                    label=label, cfg_kw=dict(backend="pallas",
                                             edge_gates=gated))
        for k, v in got.items():
            launched[k] += v
        print(f"[pallas serve] {label}: peak device memory over the "
              f"requests {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        pred = Predictor(cfg, spec, params=params, device="cuda")
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores = pred.run_batch(b)
        t1 = time.perf_counter()
        launches = read_counts()
        expect_counts(f"pallas serve {label} run_batch", launches, per)
        for k, v in launches.items():
            launched[k] += v
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        arrays = batch_arrays(b, "cuda")
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.inference_mode():
            ev[0].record()
            forward(params, cfg, arrays, 1)
            ev[1].record()
        torch.cuda.synchronize()
        if scores.shape != (b.spec.n_pad,) or not np.isfinite(scores).all():
            raise AssertionError(f"pallas serve {label}: bad scores")
        print(f"[pallas serve] {label} headline batch through run_batch: "
              f"{t1 - t0:.3f} s on the host clock (copies in and out "
              f"included), device forward {ev[0].elapsed_time(ev[1]):.2f} "
              f"ms (CUDA events, a second forward); peak device memory "
              f"{peak:.2f} GiB; launches {launches}", flush=True)
        pallas_stepwise(f"pallas serve {label}", cfg, params["prop"],
                        arrays, log)
        del pred, params, arrays
        torch.cuda.empty_cache()
    return launched


def pallas_train_phase(b):
    """[pallas train]: 3 Adam steps of the headline model through
    make_train_step on the uniform headline batch, backend='pallas',
    ungated and gated (per step: #16 T times in the forward and, gated, T
    more in the backward for dmask; #17 T times in a gated forward; #3
    and #4 T times each), the first step against the plain path.  Returns
    the launches."""
    per = {"packed_messages": STEPS, "gru_cell_fwd": STEPS,
           "gru_cell_bwd": STEPS}
    gated = dict(per, packed_messages=2 * STEPS, sddmm_pallas=STEPS)
    return train_headline(b, None, {
        "pallas": (dict(backend="pallas"), per),
        "pallas gated": (dict(backend="pallas", edge_gates=True), gated)},
        tag="pallas train", f32_check=False)


def pallas_phases(b, log, timings, serve_and_train=True):
    """Phase 13 on the uniform headline batch ``b``: ``[pallas kernels]``,
    then (with ``serve_and_train``) ``[pallas serve]``, ``[pallas
    train]`` and the Trainer CLI with ``--backend pallas``.  Returns the
    launches of the serving and training paths."""
    pallas_kernels_phase(b, log, timings)
    launched = {}
    if serve_and_train:
        for phase in (lambda: pallas_serve_phase(b, log),
                      lambda: pallas_train_phase(b),
                      lambda: run_trainer("pallas",
                                          want=("packed_messages",))):
            for k, v in phase().items():
                launched[k] = launched.get(k, 0) + v
    return launched


# --- [variants]: #18, #19 and #20, through the kernel-variant sweeps --------

VARIANT_DIMS = (1, 4, 16, 128, 200, 256, 384)


def sweep_scripts():
    """The two sweep scripts (``scripts/torch_scatter_variants.py``,
    ``scripts/torch_window_variants.py``) as modules, so that the sweeps'
    sequence lives in one place."""
    import os
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts")
    if here not in sys.path:
        sys.path.insert(0, here)
    import torch_scatter_variants
    import torch_window_variants
    return torch_scatter_variants, torch_window_variants


def random_edges(r, N, E, T2, dst_hi=None, hub=0.0):
    """Edges as the JAX package's scatter tests draw them
    (tests/test_scatter_pallas.py::random_edges: uniform, 10 % padding),
    with dst in [0, dst_hi) and a share ``hub`` into rows [0, 64)."""
    src = r.integers(0, N, E).astype(np.int32)
    dst = r.integers(0, N if dst_hi is None else dst_hi, E).astype(np.int32)
    if hub:
        dst = np.where(r.random(E) < hub, r.integers(0, 64, E),
                       dst).astype(np.int32)
    typ = r.integers(0, T2, E).astype(np.int32)
    mask = np.where(r.random(E) < 0.1, 0.0, 1.0).astype(np.float32)
    return src, dst, typ, mask


def stream_scatters(lay, extra=False, onehot=None):
    """The stream scatters of a legacy device layout as name -> (kernel,
    the plain version) on a message pack: #18 and #19 (with ``extra`` also
    #8 and #11's mono form, the sweep's other variants of the same
    function), all held against #18's plain version; ``onehot``: another
    int8 stream of the layout's shape in place of its one-hot."""
    from ggnn_tpu_torch.ops import legacy as L
    _, tile_e, max_tiles, n_blocks, *_ = lay.meta
    a = lay.arrays
    oh, ts, bt = a["onehot"], a["tile_start"], a["block_of_tile"]
    if onehot is not None:
        oh = onehot
    plain = lambda m: L.onehot_segment_scatter_stream_reference(
        m, oh, ts, n_blocks, max_tiles, tile_e)
    kern = {"onehot_segment_scatter_stream":
            lambda m: L.onehot_segment_scatter_stream(m, oh, ts, n_blocks,
                                                      max_tiles, tile_e),
            "onehot_segment_scatter_loopT":
            lambda m: L.onehot_segment_scatter_loopT(m, oh, ts, n_blocks,
                                                     tile_e)}
    if extra:
        kern["onehot_segment_scatter_flat"] = (
            lambda m: L.onehot_segment_scatter_flat(m, oh, ts, bt, n_blocks,
                                                    tile_e))
        kern["window_block_spmm_mono"] = (
            lambda m: L.onehot_segment_scatter_mono(m, oh, ts, bt, n_blocks,
                                                    tile_e))
    return kern, plain


def abs_parts(c):
    """Int8 streams of nonnegative values that sum to |c| (|−128| does not
    fit an int8): max(c, 0), max(−1 − c, 0) and [c < 0]."""
    import torch
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    return [torch.maximum(c, zero), torch.maximum(-1 - c, zero),
            (c < 0).to(c.dtype)]


def signed_stream(c, r, cols_too=True):
    """A copy of the int8 stream ``c`` [n·128, width] whose nonzero bytes
    are, at random, 2, −3, 127, −128 or −1 (a fifth each, a fifth of them
    changed), and (``cols_too``) whose columns with an entry gain a second
    one, −1, in the next row: not a one-hot; zero stays zero elsewhere."""
    import torch
    out = c.clone()
    flat = out.view(-1)
    nz = torch.nonzero(flat).flatten()
    pick = nz[torch.as_tensor(r.random(nz.shape[0]) < 0.2, device=c.device)]
    vals = torch.tensor([2, -3, 127, -128, -1], dtype=torch.int8,
                        device=c.device)
    flat[pick] = vals[torch.as_tensor(r.integers(0, 5, pick.shape[0]),
                                      device=c.device)]
    if cols_too:
        width = c.shape[1]
        two = nz[torch.as_tensor(r.random(nz.shape[0]) < 0.1,
                                 device=c.device)]
        row = two // width
        nxt = (row // 128) * 128 + (row % 128 + 1) % 128
        dst = nxt * width + two % width
        flat[dst[flat[dst] == 0]] = -1
    for v in (2, -3, 127, -128, -1):
        if not (flat == v).any():
            raise AssertionError(f"the signed stream holds no {v}")
    return out


def check_stream_scatters(tag, lay, log, dims, msgs=None, extra=False,
                          onehot=None):
    """#18 and #19 (``extra``: also #8 and #11's mono form) against the
    plain version on a legacy layout, per element ('bound': 2e-5 of the
    plain sums over |messages| and |stream|, the bound of #8), each twice
    bit-equal, blocks without a real edge exactly 0; random messages at
    each D of ``dims`` in bf16 and f32, or the given bf16 ``msgs``;
    ``onehot``: another int8 stream in place of the layout's (signed
    values, columns of two entries: :func:`signed_stream`)."""
    import torch
    dev = torch.device("cuda")
    a = lay.arrays
    _, tile_e, max_tiles, n_blocks, *_ = lay.meta
    n_tiles = a["block_of_tile"].shape[0]
    real = a["dst_local"].reshape(n_tiles, tile_e) >= 0
    empty = torch.zeros(n_blocks, device=dev).index_add_(
        0, a["block_of_tile"].long(), real.sum(1).float()) == 0
    sizes = a["tile_start"][1:] - a["tile_start"][:-1]
    print(f"[variants] {tag}: tile_e={tile_e} n_blocks={n_blocks} tiles="
          f"{n_tiles} (max_tiles {max_tiles}, the largest block "
          f"{int(sizes.max().item())}), {int(empty.sum().item())} blocks "
          f"without a real edge", flush=True)
    kern, plain = stream_scatters(lay, extra, onehot)
    if onehot is None:
        plain_abs = plain
    else:   # the sums over |stream|
        parts = [stream_scatters(lay, onehot=p)[1] for p in abs_parts(onehot)]
        plain_abs = lambda m: sum(f(m) for f in parts)
    gen = torch.Generator(device=dev).manual_seed(len(tag))
    cases = ([(msgs.shape[1], msgs.dtype, msgs)] if msgs is not None else
             [(D, dt, None) for D in dims
              for dt in (torch.bfloat16, torch.float32)])
    for D, dtype, m in cases:
        if m is None:
            m = torch.randn(n_tiles * tile_e, D, device=dev,
                            generator=gen).to(dtype)
        dn = f"{str(dtype).split('.')[-1]},D={D}"
        ref = plain(m)
        bound = flush_bound(plain_abs, m, ref, torch.float32)
        for name, fn in kern.items():
            got = fn(m)
            same_twice(name, f"{tag},{dn}", got, fn(m))
            check(f"{name}[{tag},{dn}]", got, ref, "bound", dtype, log,
                  bound=bound)
            if (got.reshape(n_blocks, 128, D)[empty] != 0).any():
                raise AssertionError(f"{name}[{tag}]: a block without a "
                                     "real edge is not 0")
            del got
        del ref, bound


def drop_block_tiles(a, n_blocks, b):
    """A window layout's tile arrays without block b's tiles (tile_start,
    block_of_tile, win_of_tile, c_off): block b then has no tile at all."""
    import torch
    ts = a["tile_start"]
    t0, t1 = int(ts[b].item()), int(ts[b + 1].item())
    keep = torch.ones(a["win_of_tile"].shape[0], dtype=torch.bool,
                      device=ts.device)
    keep[t0:t1] = False
    ts2 = ts.clone()
    ts2[b + 1:] -= t1 - t0
    return (ts2, a["block_of_tile"][keep].contiguous(),
            a["win_of_tile"][keep].contiguous(), a["c_off"][keep].contiguous())


def check_window_auto(tag, lay_args, table_rows, window, n_blocks, log,
                      dims, table=None, with_mono=False):
    """#20 (``with_mono``: also #11) against its plain version on one
    window layout's arrays ``lay_args`` (c_stream, tile_start,
    block_of_tile, win_of_tile, c_off), per element (window_sums_bound:
    2e-5 of Σ|count·row|, over |counts| where they are signed), twice
    bit-equal, a block without a real tile exactly 0; random tables of
    ``table_rows`` rows at each D of ``dims`` in bf16 and f32, or the given
    ``table``.  Prints #20's plan (entries, work items, split rows)."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    c_stream, ts, bt, wt, c_off = lay_args
    real = (wt >= 0).float()
    n_real = torch.zeros(n_blocks, device=dev).index_add_(0, bt.long(), real)
    empty = n_real == 0
    print(f"[variants] {tag}: W {window}, {n_blocks} blocks, "
          f"{wt.shape[0]} tiles ({int(real.sum().item())} real, "
          f"{int((wt < 0).sum().item())} dummy; {c_stream.shape[0] // 128} "
          f"count tiles), {int((ts[1:] == ts[:-1]).sum().item())} blocks "
          f"without a tile, {int(empty.sum().item())} without a real one",
          flush=True)
    plan = W.window_auto_plan_once("window_block_spmm", table_rows, c_stream,
                                   ts, bt, wt, c_off, n_blocks, window)
    per_item = plan.items[:, 1] - plan.items[:, 0]
    print(f"  window_block_spmm plan: {plan.ent.shape[0]} entries "
          f"({'4' if plan.packed else '8'} bytes), {plan.items.shape[0]} "
          f"work items of at most {int(per_item.max().item())} entries, "
          f"{plan.split.shape[0]} rows of several items "
          f"({plan.n_part} partials)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(window + len(tag))
    cases = ([(table.shape[1], table.dtype, table)] if table is not None
             else [(D, dt, None) for D in dims
                   for dt in (torch.bfloat16, torch.float32)])
    kw = dict(n_blocks=n_blocks, window=window, c_off=c_off)
    fns = {"window_block_spmm": W.window_block_spmm}
    if with_mono:
        fns["window_block_spmm_mono"] = W.window_block_spmm_mono
    signed = bool((c_stream < 0).any().item())
    streams = abs_parts(c_stream) if signed else [c_stream]
    for D, dtype, t in cases:
        if t is None:
            t = torch.randn(table_rows, D, device=dev, generator=gen).to(dtype)
        dn = f"{str(dtype).split('.')[-1]},D={D}"
        ref = W.window_block_spmm_reference(t, c_stream, ts, bt, wt, **kw)
        bound = sum(window_sums_bound(t, (c, bt, wt, c_off, n_blocks, False),
                                      window, 128) for c in streams)
        for name, fn in fns.items():
            got = fn(t, c_stream, ts, bt, wt, **kw)
            same_twice(name, f"{tag},{dn}", got,
                       fn(t, c_stream, ts, bt, wt, **kw))
            check(f"{name}[{tag},{dn}]", got, ref, "bound", dtype, log,
                  bound=bound)
            if (got.reshape(n_blocks, 128, D)[empty] != 0).any():
                raise AssertionError(f"{name}[{tag}]: a block without a "
                                     "real tile is not 0")
            del got
        del ref, bound
    return plan


def auto_seam_fuzz(log, dims=(16, 128, 200)):
    """#20's plan at its seams: window layouts at W 64, 256 and 512 with a
    hub dst row (2,000 edges from distinct sources into row 5: one output
    row cut into several work items, their partials summed by the second
    kernel), dummy tiles (pad_tiles_to) and a compact count stream (c_off)
    at W 256 and 512, a block without tiles, and the counts signed
    (:func:`signed_stream`: 2, −3, 127, −128 and −1 beside the layout's
    counts); each at ``dims`` in bf16 and f32 (check_window_auto)."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(61)
    seams = {
        # tag: (N, E, T2, W, min_edges_per_tile, extra dummy tiles)
        "W64 hub signed": (1024, 8000, 4, 64, 1, 0),
        "W256 hub dummies signed": (2048, 40_000, 8, 256, 8, 50),
        "W512 hub dummies signed": (4096, 60_000, 8, 512, 8, 80),
    }
    for tag, (N, E, T2, Wn, mept, pad) in seams.items():
        src, dst, typ, mask = random_edges(r, N, E, T2)
        src = np.where(r.random(E) < 0.9,
                       (dst // 256) * 256 + r.integers(0, 256, E), src) % N
        hub = min(2000, N - 24)
        src[:hub] = r.permutation(N)[:hub]
        dst[:hub], typ[:hub], mask[:hub] = 5, 0, 1.0
        host = W.build_window_layout(src, dst, typ, mask, N, window=Wn,
                                     min_edges_per_tile=mept)
        if pad:
            host = W.build_window_layout(
                src, dst, typ, mask, N, window=Wn, min_edges_per_tile=mept,
                pad_tiles_to=host.n_tiles + pad)
        a = host.to(dev).arrays
        R = T2 * N
        args = (signed_stream(a["c_stream"], r, cols_too=False),
                *drop_block_tiles(a, host.n_blocks, 3))
        plan = check_window_auto(tag, args, R + (-R) % Wn, Wn,
                                 host.n_blocks, log, dims)
        if not (plan.split == 5).any():
            raise AssertionError(f"{tag}: the hub row is not split")
        if int((plan.items[:, 1] - plan.items[:, 0]).max().item()) > \
                W.AUTO_SPLIT:
            raise AssertionError(f"{tag}: a work item over AUTO_SPLIT")


def loopT_seam_fuzz(hosts, log, r):
    """#19's gather (``csrc/window_auto_gather.cu`` on the plan of
    ``ops/legacy.py::loopT_plan_once``) at its seams, on the host layouts
    of :func:`variants_fuzz`: the hub block's plan (its hub row split into
    partials, no work item over AUTO_SPLIT); tile_start ending before the
    stream (the tiles past it hold entries, which must add nothing) with a
    signed stream that is not one-hot, in 4-byte plan entries at tile_e
    128 and in 8-byte ones at tile_e 2048 (``_PACK_ROWS`` lowered, as for
    a pack of 2**24 rows or more); at D = 1, 16, 128 and 200 in bf16 and
    f32, #18 beside it (:func:`check_stream_scatters`)."""
    import dataclasses

    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    name = "onehot_segment_scatter_loopT"
    lay = hosts["tile_e128 hub"].to(dev)
    a = lay.arrays
    plan = L.loopT_plan_once(name, a["onehot"], a["tile_start"], lay.meta[3],
                             lay.meta[1])
    n_max = int((plan.items[:, 1] - plan.items[:, 0]).max().item())
    print(f"  {name} plan [tile_e128 hub]: {plan.ent.shape[0]} entries, "
          f"{plan.items.shape[0]} work items of at most {n_max} entries, "
          f"{plan.split.shape[0]} rows split ({plan.n_part} partials)",
          flush=True)
    if not plan.split.numel() or n_max > W.AUTO_SPLIT:
        raise AssertionError(f"{name}: the hub rows are not split into "
                             f"items of at most {W.AUTO_SPLIT} entries")
    del lay, a, plan
    for tag, packed in (("tile_e128 empty", True),
                        ("tile_e2048 empty", False)):
        host = hosts[tag]
        ts = host.tile_start.copy()
        ts[3:] = ts[2]
        tile_e = host.tile_e
        if not host.onehot.reshape(-1, 128 * tile_e)[ts[-1]:].any():
            raise AssertionError(f"{tag}: no entry past tile_start[-1]")
        lay = dataclasses.replace(host, tile_start=ts).to(dev)
        oh = signed_stream(lay.arrays["onehot"], r)
        kept = W._PACK_ROWS
        if not packed:
            W._PACK_ROWS = 0
        try:
            check_stream_scatters(
                f"{tag} cut signed, {4 if packed else 8}-byte entries", lay,
                log, (1, 16, 128, 200), onehot=oh)
            plan = L.loopT_plan_once(name, oh, lay.arrays["tile_start"],
                                     lay.meta[3], tile_e)
        finally:
            W._PACK_ROWS = kept
        if plan.packed != packed:
            raise AssertionError(f"{name}[{tag}]: the plan's entries are "
                                 f"not {4 if packed else 8} bytes")


def variants_fuzz(log):
    """The fuzz of [variants]: #18 and #19 on the JAX package's variant
    test layout (tests/test_scatter_pallas.py:144-146: 256 nodes, 500
    edges, tile_e 8), at tile_e 128 and 2048 with empty dst blocks and on a
    hub block of several hundred tiles; #20 on its variant test layout
    (tests/test_window_pallas.py:303-306: W 64) and on W 256 and 512
    layouts with dummy tiles (pad_tiles_to), a compact count stream
    (c_off) and a block without tiles; D = 1, 4, 16, 128, 200, 256, 384 in
    bf16 and f32; #18 and #19 again on the tile_e 2048 and hub layouts with
    a signed stream that is not one-hot (:func:`signed_stream`) at D = 16,
    128 and 200; #19's seams (:func:`loopT_seam_fuzz`); then #20's plan
    seams (:func:`auto_seam_fuzz`).  #18 must
    raise when max_tiles is below a block's count, in both of its
    routes."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(53)
    signed, hosts = {}, {}
    fuzz = {
        # tag: (N, E, T2, tile_e, dst range, hub share)
        "tile_e8": (256, 500, 4, 8, None, 0.0),
        "tile_e128 empty": (1024, 6000, 6, 128, 512, 0.0),
        "tile_e2048 empty": (2048, 30_000, 6, 2048, 1024, 0.0),
        "tile_e128 hub": (1024, 60_000, 4, 128, None, 0.9),
    }
    for tag, (N, E, T2, tile_e, dst_hi, hub) in fuzz.items():
        lay = L.build_dst_block_layout(*random_edges(r, N, E, T2, dst_hi, hub),
                                       N, tile_e=tile_e)
        if hub and lay.max_tiles < 300:
            raise AssertionError(f"{tag}: the hub block holds only "
                                 f"{lay.max_tiles} tiles")
        check_stream_scatters(tag, lay.to(dev), log, VARIANT_DIMS)
        hosts[tag] = lay
        if tile_e >= 128:
            signed[tag] = lay.to(dev)
    for tag in ("tile_e2048 empty", "tile_e128 hub"):
        lay = signed[tag]
        check_stream_scatters(f"{tag} signed", lay, log, (16, 128, 200),
                              onehot=signed_stream(lay.arrays["onehot"], r))
    loopT_seam_fuzz(hosts, log, r)
    # max_tiles below a block's count: the TPU grid would drop tiles
    a = lay.arrays
    for D, dt in ((4, torch.float32), (128, torch.bfloat16)):
        try:
            L.onehot_segment_scatter_stream(
                torch.zeros(a["block_of_tile"].shape[0] * 128, D, device=dev,
                            dtype=dt),
                a["onehot"], a["tile_start"], lay.meta[3], lay.meta[2] - 1,
                128)
        except ValueError as e:
            print(f"  onehot_segment_scatter_stream: max_tiles below a "
                  f"block's count raises at D = {D} ({e})", flush=True)
        else:
            raise AssertionError("#18 ran with max_tiles below a block's "
                                 "count")
    wfuzz = {
        # tag: (N, E, T2, W, min_edges_per_tile, extra dummy tiles)
        "W64": (512, 900, 4, 64, 1, 0),
        "W256 dummies": (2048, 40_000, 8, 256, 8, 50),
        "W512 dummies": (4096, 60_000, 8, 512, 8, 80),
    }
    for tag, (N, E, T2, Wn, mept, pad) in wfuzz.items():
        src, dst, typ, mask = random_edges(r, N, E, T2)
        if pad:   # clustered, so that windows fill: src near dst
            src = np.where(r.random(E) < 0.9,
                           (dst // 256) * 256 + r.integers(0, 256, E),
                           src) % N
        host = W.build_window_layout(src, dst, typ, mask, N, window=Wn,
                                     min_edges_per_tile=mept)
        if pad:
            host = W.build_window_layout(
                src, dst, typ, mask, N, window=Wn, min_edges_per_tile=mept,
                pad_tiles_to=host.n_tiles + pad)
        lay = host.to(dev)
        a = lay.arrays
        R = T2 * N
        args = (a["c_stream"], a["tile_start"], a["block_of_tile"],
                a["win_of_tile"], a["c_off"])
        if pad:
            if (a["c_off"] == torch.arange(a["c_off"].shape[0],
                                           device=dev)).all():
                raise AssertionError(f"{tag}: the count stream is not "
                                     "compact")
            args = (a["c_stream"], *drop_block_tiles(a, lay.n_blocks, 3))
        check_window_auto(tag, args, R + (-R) % Wn, Wn, lay.n_blocks, log,
                          VARIANT_DIMS)
    try:
        W.window_block_spmm(torch.zeros(R + (-R) % Wn + 1, 4, device=dev),
                            *args[:4], lay.n_blocks, Wn, c_off=args[4])
    except ValueError as e:
        print(f"  window_block_spmm: table rows not a multiple of W raise "
              f"({e})", flush=True)
    else:
        raise AssertionError("#20 ran on a table of rows not a multiple "
                             "of W")
    auto_seam_fuzz(log)


def variants_phase(b, log, timings):
    """``[variants]``: #18 ``onehot_segment_scatter_stream``, #19
    ``onehot_segment_scatter_loopT`` and #20 ``window_block_spmm``, the
    three kernels only the reference's kernel-variant sweeps and tests
    run.  The fuzz (:func:`variants_fuzz`); then the main path: the scatter
    sweep of ``scripts/torch_scatter_variants.py`` at tile_e 2048 on the
    uniform headline batch ``b`` (flat #8, stream #18, loopT #19, mono
    #11), and the window sweep of ``scripts/torch_window_variants.py`` on
    the probe's community graph (#11, #20, then ``aggregate_window``), each
    with the counts set to 0 before it and read after it.  On the sweeps'
    own layouts and inputs, #8, #18, #19 and #11 are held against the
    plain version (and #11 against #20's), and #18, #19 and #20 timed
    against their plain versions and one PyTorch call (#18 and #19 also in
    f32).  Returns the main path's launch counts."""
    import torch
    SV, WV = sweep_scripts()
    variants_fuzz(log)
    zero_counts()
    _, (tile_e, lay, msgs) = SV.sweep(
        b, {2048: ("flat", "stream", "loopT", "mono")}, keep_last=True)
    launched = read_counts()
    zero_counts()
    _, (wlay, table) = WV.sweep(community_batch(), keep=True)
    for k, v in read_counts().items():
        launched[k] += v
    print(f"[variants] the sweeps' launches "
          f"{ {k: v for k, v in launched.items() if v} }", flush=True)
    for k in ("onehot_segment_scatter_flat", "onehot_segment_scatter_stream",
              "onehot_segment_scatter_loopT", "window_block_spmm_mono",
              "window_block_spmm"):
        if not launched[k]:
            raise AssertionError(f"[variants] the sweeps did not launch {k}")

    check_stream_scatters("headline tile_e=2048", lay, log, (), msgs=msgs,
                          extra=True)
    # #18's and #19's f32 forms (both on #19's gather) at the headline too
    m32 = msgs.float()
    check_stream_scatters("headline tile_e=2048 f32", lay, log, (), msgs=m32)
    from ggnn_tpu_torch.ops import legacy as L
    a = lay.arrays
    n_blocks = lay.meta[3]
    oh, ts = a["onehot"], a["tile_start"]
    n_real = int((a["dst_local"] >= 0).sum().item())
    kern, plain = stream_scatters(lay)
    tgt = legacy_targets(a, n_blocks, tile_e)
    out_bytes = n_blocks * 128 * DIM * 4
    # the bounds: the dense stream's (the real rows, the one-hot, out),
    # which #18's count form reads, and #19's plan's (its entries and
    # items, each real row once, out), which a launch on a layout seen is
    # held to
    dense = roofline(n_real * DIM * msgs.element_size() + nbytes(oh, ts)
                     + out_bytes, [(n_real * DIM, F32_FLOPS)])
    plan = L.loopT_plan_once("onehot_segment_scatter_loopT", oh, ts,
                             n_blocks, tile_e)
    print(f"  onehot_segment_scatter_loopT plan: {plan.ent.shape[0]} entries "
          f"of {'4' if plan.packed else '8'} bytes ({n_real} real edges), "
          f"{plan.items.shape[0]} work items, {plan.split.shape[0]} rows "
          f"split", flush=True)
    planned = {m.dtype: roofline(
        nbytes(plan.ent, plan.items) + n_real * DIM * m.element_size()
        + out_bytes, [(2 * plan.ent.shape[0] * DIM, F32_FLOPS)])
        for m in (msgs, m32)}
    del plan
    pairs = lambda m, lib, bounds: {
        name: (lambda k=k: k(m), lambda: plain(m), lib, bounds[name])
        for name, k in kern.items()}
    time_pairs(pairs(msgs, reverse_library_call(msgs, tgt, n_blocks * 128),
                     {"onehot_segment_scatter_stream": dense,
                      "onehot_segment_scatter_loopT": planned[msgs.dtype]}),
               timings)
    timings["onehot_segment_scatter_loopT"]["dense_bound_ms"] = dense[0]
    # the f32 forms against one f32 index_add_ (float atomics into f32)
    f32 = {}
    time_pairs(pairs(m32, reverse_library_call(m32, tgt, n_blocks * 128),
                     dict.fromkeys(kern, planned[torch.float32])), f32,
               "f32 headline")
    for name, t in f32.items():
        timings[name].update({f"f32_{k}": v for k, v in t.items()
                              if k != "bound_by"})
    del m32, tgt, f32
    # #18 and #19 on a new layout: their checks and plans (a copy of
    # tile_start is a layout not seen before), as a user of a new layout
    # pays them
    for name, fn in (
            ("onehot_segment_scatter_stream",
             lambda t: L.onehot_segment_scatter_stream(
                 msgs, oh, t, n_blocks, lay.meta[2], tile_e)),
            ("onehot_segment_scatter_loopT",
             lambda t: L.onehot_segment_scatter_loopT(msgs, oh, t, n_blocks,
                                                      tile_e))):
        new_ms = cuda_ms(lambda: fn(ts.clone()), 3)
        timings[name]["new_layout_ms"] = new_ms
        print(f"  {name} on a new layout (checks and plan included): "
              f"{new_ms:.3f} ms; on the layout seen "
              f"{timings[name]['ms']:.3f} ms", flush=True)
    plan_ms = cuda_ms(lambda: L.loopT_plan_once(
        "onehot_segment_scatter_loopT", oh, ts.clone(), n_blocks, tile_e), 3)
    print(f"  onehot_segment_scatter_loopT's checks and plan alone: "
          f"{plan_ms:.3f} ms", flush=True)
    # a launch on the layout seen copies nothing to the host: every copy
    # of the checks and plans goes through host_ints
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import window as W
    copies, host_ints = [], G.host_ints
    try:
        for mod in (G, W, L):
            mod.host_ints = lambda *x: copies.append(x) or host_ints(*x)
        L.onehot_segment_scatter_loopT(msgs, oh, ts, n_blocks, tile_e)
    finally:
        for mod in (G, W, L):
            mod.host_ints = host_ints
    if copies:
        raise AssertionError(f"onehot_segment_scatter_loopT copied to the "
                             f"host {len(copies)} times on a layout seen")
    print("  onehot_segment_scatter_loopT on the layout seen: no copy to "
          "the host", flush=True)
    del lay, msgs, kern, plain, oh, ts
    torch.cuda.empty_cache()

    wa = wlay.arrays
    args = (wa["c_stream"], wa["tile_start"], wa["block_of_tile"],
            wa["win_of_tile"], wa["c_off"])
    R = table.shape[0]
    check_window_auto("headline community W=512", args, R, 512,
                      wlay.n_blocks, log, (), table=table, with_mono=True)
    real_t = torch.nonzero(wa["win_of_tile"] >= 0).flatten()
    n_real_t = real_t.shape[0]
    nnz = int((wa["c_stream"] != 0).sum().item())
    kw = dict(n_blocks=wlay.n_blocks, window=512, c_off=wa["c_off"])
    # the PyTorch call: one batched product of every real tile's counts
    # (bf16) with its table window, both gathered beforehand (untimed);
    # the per-block sum that would follow is not in it
    cg = wa["c_stream"].view(-1, 128, 512)[wa["c_off"].long()[real_t]].to(
        table.dtype)
    tg = table.view(-1, 512, DIM)[wa["win_of_tile"].long()[real_t]]
    from ggnn_tpu_torch.ops import window as W
    # the bounds: the dense stream's (each real count tile, each window it
    # addresses once, the output) and the plan's (its entries and items,
    # each table row an entry names once, the output), which a launch on a
    # layout seen before is held to
    dense = roofline(n_real_t * 128 * 512
                     + window_bytes(wa["win_of_tile"], 512,
                                    table.element_size())
                     + nbytes(*args[1:]) + wlay.n_blocks * 128 * DIM * 4,
                     [(2 * nnz * DIM, BF16_FLOPS)])
    plan = W.window_auto_plan_once("window_block_spmm", R, *args[:4],
                                   args[4], wlay.n_blocks, 512)
    rows = ((plan.ent.long() & 0xFFFFFFFF) >> 8 if plan.packed
            else plan.ent[:, 0])
    n_rows = torch.unique(rows).numel()
    planned = roofline(nbytes(plan.ent, plan.items)
                       + n_rows * DIM * table.element_size()
                       + wlay.n_blocks * 128 * DIM * 4,
                       [(2 * plan.ent.shape[0] * DIM, F32_FLOPS)])
    print(f"  window_block_spmm bounds: dense stream {dense[0]:.4f} ms, plan "
          f"{planned[0]:.4f} ms ({plan.ent.shape[0]} entries of "
          f"{'4' if plan.packed else '8'} bytes naming {n_rows} table rows, "
          f"{plan.items.shape[0]} work items, {plan.split.shape[0]} rows "
          f"split)", flush=True)
    time_pairs({"window_block_spmm": (
        lambda: W.window_block_spmm(table, *args[:4], **kw),
        lambda: W.window_block_spmm_reference(table, *args[:4], **kw),
        lambda: torch.bmm(cg, tg), planned)}, timings)
    # on a new layout (a copy of tile_start): the checks and the plan
    # included; beside it #11's window form on the same layout
    ts = args[1]
    new_ms = cuda_ms(lambda: W.window_block_spmm(
        table, args[0], ts.clone(), *args[2:4], **kw), 3)
    plan_ms = cuda_ms(lambda: W.window_auto_plan(
        args[0], args[2], args[3], args[4], wlay.n_blocks, 512, R), 3)
    mono_ms = cuda_ms(lambda: W.window_block_spmm_mono(table, *args[:4],
                                                       **kw), 10)
    print(f"  window_block_spmm on a new layout (checks and plan included): "
          f"{new_ms:.3f} ms (the plan alone {plan_ms:.3f} ms, against the "
          f"dense bound {dense[0]:.4f} ms); on the layout seen "
          f"{timings['window_block_spmm']['ms']:.3f} ms; #11's window form "
          f"on the same layout {mono_ms:.3f} ms", flush=True)
    del plan, rows
    del wlay, table, cg, tg
    torch.cuda.empty_cache()
    return launched


def widths_phase(log):
    """``[widths]``: :func:`check_kernel_widths`, then the fused window
    train step at D = 256 (:func:`window_step_d256`)."""
    check_kernel_widths(log)
    window_step_d256()


def window_step_d256():
    """One fused window train step at D = 256 (FusedWindowStep: #13's
    emit_res form, i.e. its sums then the wide cell; the wide #4; then #14
    in two 128-column panels) on a grad fuzz layout, its gradients against
    the plain path from the same state and cotangent: every leaf within
    the bf16 first-step bound (relative Frobenius, TOL_TRAIN)."""
    import torch
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.ops import window_step as WS
    dev = torch.device("cuda")
    r = np.random.default_rng(29)
    N, E, T2, D = 2048, 40_000, 8, 256
    dst = r.integers(0, N - 256, E)
    src = np.where(r.random(E) < 0.9,
                   (dst // 256) * 256 + r.integers(0, 256, E),
                   r.integers(0, N, E)) % N
    lay = W.build_window_layout(src, dst, r.integers(0, T2, E),
                                np.ones(E, np.float32), N, window=256,
                                block_rows=256, n_message_types=T2,
                                row_major="block", min_edges_per_tile=4,
                                with_grad=True, on_demand=True,
                                typed_spill=True).to(dev)
    if not lay.grad_meta[4]:
        raise AssertionError("window D=256 step: not the fused backward")
    gen = torch.Generator(device=dev).manual_seed(47)
    rn = lambda *s, sc=1.0: torch.randn(*s, device=dev, generator=gen) * sc
    h0 = torch.rand(N, D, device=dev, generator=gen) * 2 - 1
    w0, b0 = rn(T2, D, D, sc=D ** -0.5), rn(T2, D, sc=0.1)
    gru0 = {k: rn(D, D, sc=D ** -0.5) for k in ("wz", "wr", "wh", "uz",
                                                "ur", "uh")}
    gru0.update({k: rn(D, sc=0.1) for k in ("bz", "br", "bh")})
    cot = rn(N, D)

    def grads():
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  {"h": h0, "msg_w": w0, "msg_b": b0, **gru0}.items()}
        gru = {k: leaves[k] for k in gru0}
        out = WS.gru_window_step(leaves["h"], lay,
                                 leaves["msg_w"].to(torch.bfloat16),
                                 leaves["msg_b"].to(torch.bfloat16), gru)
        g = torch.autograd.grad((out * cot).sum(), list(leaves.values()))
        return dict(zip(leaves, g))

    zero_counts()
    got = grads()
    launches = {k: v for k, v in read_counts().items() if v}
    for k in ("window_step_gru[emit_res]", "gru_cell_bwd",
              "window_bwd_fused"):
        if not launches.get(k):
            raise AssertionError(f"window D=256 step: {k} not launched "
                                 f"({launches})")
    with plain_versions():
        ref = grads()
    tol = TOL_TRAIN["bfloat16"][0]
    errs = sorted(((relfro(got[k], ref[k]), k) for k in got), reverse=True)
    ok = errs[0][0] <= tol and all(torch.isfinite(x).all()
                                   for x in got.values())
    print(f"[widths] a fused window train step at D = {D} (launches "
          f"{launches}) vs the plain path: worst leaves (rel_frobenius) "
          + ", ".join(f"{k} {e:.3e}" for e, k in errs[:4])
          + f" (tol {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("window D=256 step: gradients disagree with "
                             "the plain path")


WIDE_DIMS = (320, 384, 512)     # the widths past 256 every kernel takes


def check_kernel_widths(log):
    """Every kernel at the widths the reference takes: #1-#7, #10, #12, #13
    (and emit_res) and #14 (exact and int8 ā) at D = 4, 8, 16, 128, 200,
    256 and WIDE_DIMS, #15 at the multiples of 128 among them, bf16 and
    f32, against their plain versions and a second run of themselves
    (bit-equal), with the tolerances of the D = 128 checks (bf16 #1 per
    element, ``ops/bounds.py::block_bound``); then #8, #9,
    #10, #11, #16 and #18-#20 at WIDE_DIMS.  D < 128 runs the D = 128
    kernels zero-padded (ops/gru.py::pad_width), D = 128·P the wide forms
    (the GRU cell's P panels, the window sums' and #14's P column panels,
    the typed scatters' P² panel products), other D padded to the next
    multiple of 128 (200 to 256, 320 to 384).  (#16 and #17 take their
    other widths in [pallas kernels], #18-#20 in [variants].)"""
    import torch
    from ggnn_tpu_torch.ops import bounds as B
    from ggnn_tpu_torch.ops import gru as G
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import table as TB
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(31)
    N, E, T2 = 640, 9000, 6
    edges = (r.integers(0, N, E), r.integers(0, N, E), r.integers(0, T2, E),
             (r.random(E) < 0.9).astype(np.float32))
    lay_b = S.build_typed_dst_layout(*edges, N, T2, with_grad=True).to(dev)
    lay_t = S.build_typed_dst_layout(*edges, N, T2, block_mode=False).to(dev)
    kb = S.block_args(lay_b)
    arrs = (kb.pop("dstl_blk"), kb.pop("slot_off16"), kb.pop("blk_off16"))
    kt = S.tile_args(lay_t)
    _, _, g_tile, C, R8, span8, n_oct = S.grad_meta(lay_b)
    octs = (lay_b.arrays["g_dstl_oct"], lay_b.arrays["g_slot_off16"],
            lay_b.arrays["g_oblk16"])
    okw = dict(n_oct=n_oct, g_tile=g_tile, C=C, R8=R8, span8=span8)
    Nw = 2048
    dst = r.integers(0, Nw - 256, 40_000)
    src = np.where(r.random(40_000) < 0.9,
                   (dst // 256) * 256 + r.integers(0, 256, 40_000),
                   r.integers(0, Nw, 40_000)) % Nw
    wedges = (src, dst, r.integers(0, 8, 40_000), np.ones(40_000, np.float32))
    lay_w = W.build_window_layout(*wedges, Nw, window=256, block_rows=256,
                                  n_message_types=8, row_major="block",
                                  min_edges_per_tile=4, with_grad=True,
                                  on_demand=True, typed_spill=True).to(dev)
    aw = lay_w.arrays
    wstream = (aw["c_stream"], aw["tile_start"], aw["block_of_tile"],
               aw["win_of_tile"])
    wsk = dict(n_blocks=lay_w.n_blocks, window=256, out_rows=256,
               c_off=aw["c_off"])

    def run(name, tag, kern, plain, kind, dtype, **ck):
        got = kern()
        again = kern()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        ref = plain()
        ref = ref if isinstance(ref, tuple) else (ref,)
        for i, (x, y, z) in enumerate(zip(got, again, ref)):
            part = f"{tag},{i}" if len(got) > 1 else tag
            same_twice(name, part, x, y)
            k = kind[i] if isinstance(kind, tuple) else kind
            c = {kk: (v[i] if isinstance(v, tuple) else v)
                 for kk, v in ck.items()}
            check(f"{name}[widths {part}]", x, z, k, dtype, log, **c)

    for D in (4, 8, 16, 128, 200, 256) + WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            tag = f"D={D},{dn}"
            gen = torch.Generator(device=dev).manual_seed(D)
            rn = lambda *s, sc=1.0: torch.randn(*s, device=dev,
                                                generator=gen) * sc
            w = rn(T2, D, D, sc=D ** -0.5).to(dtype)
            gw = dict(wa=rn(D, 3 * D, sc=D ** -0.5).to(dtype),
                      b3=rn(1, 3 * D, sc=0.1),
                      uzr=rn(D, 2 * D, sc=D ** -0.5).to(dtype),
                      uh=rn(D, D, sc=D ** -0.5).to(dtype))
            gargs = (gw["wa"], gw["b3"], gw["uzr"], gw["uh"])
            # #1, #2
            hp = rn(lay_b.arrays["gather_idx"].shape[0], D).to(dtype)
            nr = kb["n_blocks"] * 128
            init = rn(nr, D, sc=0.1)
            hs = torch.rand(nr, D, device=dev, generator=gen) * 2 - 1
            # bf16 #1 (csrc/typed_block_fused.cu) per element, as at D = 128
            bf = dtype == torch.bfloat16
            run("typed_block_scatter", tag,
                lambda: S.typed_block_scatter(hp, *arrs, w, **kb),
                lambda: S.typed_block_scatter_reference(hp, *arrs, w, **kb),
                "bound" if bf else "sum", dtype,
                **(dict(bound=B.block_bound(hp, w, arrs, kb,
                                            dtype)) if bf else {}))
            run("typed_block_step_gru", tag,
                lambda: S.typed_block_step_gru(hp, *arrs, w, init, hs,
                                               *gargs, **kb),
                lambda: S.typed_block_step_gru_reference(
                    hp, *arrs, w, init, hs, *gargs, **kb), "flip", dtype)
            # #3, #4
            a = rn(nr, D)
            run("gru_cell_fwd", tag,
                lambda: G.gru_cell_fwd(hs, a, gw["wa"], gw["b3"][0],
                                       gw["uzr"], gw["uh"], mdt=dtype),
                lambda: G.gru_cell_fwd_reference(hs, a, gw["wa"],
                                                 gw["b3"][0], gw["uzr"],
                                                 gw["uh"], mdt=dtype),
                "cell", dtype)
            _, z, rg, ht = G.gru_cell_fwd_reference(
                hs, a, gw["wa"], gw["b3"][0], gw["uzr"], gw["uh"], mdt=dtype)
            bargs = (rn(nr, D), hs.to(dtype), a.to(dtype), z, rg, ht,
                     gw["wa"], gw["uzr"], gw["uh"])
            run("gru_cell_bwd", tag,
                lambda: G.gru_cell_bwd(*bargs, mdt=dtype),
                lambda: G.gru_cell_bwd_reference(*bargs, mdt=dtype),
                "relfro", dtype)
            # #5
            Gp = rn(lay_b.arrays["g_gather_idx"].shape[0], D).to(dtype)
            run("typed_grad_octet_scatter", tag,
                lambda: S.typed_grad_octet_scatter(Gp, *octs, **okw,
                                                   out_dtype=dtype),
                lambda: S.typed_grad_octet_scatter_reference(
                    Gp, *octs, **okw, out_dtype=dtype), "flush", dtype)
            # #6, #7
            ht_ = rn(lay_t.arrays["gather_idx"].shape[0], D).to(dtype)
            nt = kt["n_blocks"] * 128
            x = dict(h_pack=ht_, msg_w=w)
            run("typed_onehot_scatter", tag,
                lambda: S.typed_onehot_scatter(ht_, msg_w=w, **kt),
                lambda: S.typed_onehot_scatter_reference(ht_, msg_w=w, **kt),
                "bound", dtype, bound=B.tile_bound(ht_, w, kt, dtype))
            init_t = rn(nt, D, sc=0.1)
            hs_t = torch.rand(nt, D, device=dev, generator=gen) * 2 - 1
            a_t = init_t + S.typed_onehot_scatter_reference(ht_, msg_w=w,
                                                            **kt)
            run("typed_step_gru", tag,
                lambda: S.typed_step_gru(ht_, msg_w=w, init=init_t,
                                         hstate=hs_t, wa=gw["wa"],
                                         b3=gw["b3"], uzr=gw["uzr"],
                                         uh=gw["uh"], **kt),
                lambda: S.typed_step_gru_reference(
                    ht_, msg_w=w, init=init_t, hstate=hs_t, wa=gw["wa"],
                    b3=gw["b3"], uzr=gw["uzr"], uh=gw["uh"], **kt),
                "flip_rows", dtype,
                a_rows=a_t.abs().amax(1).clamp_min(1.0))
            # #10
            hn = (torch.rand(Nw, D, device=dev, generator=gen) * 2
                  - 1).to(dtype)
            w8, b8 = rn(8, D, D, sc=D ** -0.5).to(dtype), rn(8, D,
                                                             sc=0.1).to(dtype)
            run("node_table_block_major", tag,
                lambda: TB.node_table_block_major(hn, w8, b8),
                lambda: TB.node_table_block_major_reference(hn, w8, b8),
                "flush", dtype)
            # #12, #13 (and emit_res) on-demand, #14
            lay_args = (aw["c_stream"], aw["block_of_tile"],
                        aw["win_of_tile"], aw["c_off"], lay_w.n_blocks, False)
            run("window_block_spmm_ondemand", tag,
                lambda: W.window_block_spmm_ondemand(hn, w8, b8, *wstream,
                                                     **wsk),
                lambda: W.window_block_spmm_ondemand_reference(
                    hn, w8, b8, *wstream, **wsk), "bound", dtype,
                bound=window_sums_bound(hn, lay_args, 256, 256, msg_w=w8,
                                        msg_b=b8,
                                        flip=dtype == torch.bfloat16))
            nr_w = lay_w.n_blocks * 256
            init_w = rn(nr_w, D, sc=0.3)
            hs_w = torch.rand(nr_w, D, device=dev, generator=gen) * 2 - 1
            sargs = (hn, *wstream, init_w, hs_w, *gargs)
            a_w = W.window_sums_reference(
                hn, *lay_args[:4], lay_w.n_blocks, 256, 256, False,
                msg_w=w8, msg_b=b8, init=init_w).float()
            a_rows = a_w.abs().amax(1).clamp_min(1.0)
            run("window_step_gru", tag,
                lambda: W.window_step_gru(*sargs, msg_w=w8, msg_b=b8, **wsk),
                lambda: W.window_step_gru_reference(*sargs, msg_w=w8,
                                                    msg_b=b8, **wsk),
                "flip_rows", dtype, a_rows=a_rows)
            run("window_step_gru[emit_res]", tag,
                lambda: W.window_step_gru(*sargs, msg_w=w8, msg_b=b8,
                                          emit_res=True, **wsk),
                lambda: W.window_step_gru_reference(
                    *sargs, msg_w=w8, msg_b=b8, emit_res=True, **wsk),
                ("flip_rows", "flip"), dtype, a_rows=(a_rows, None))
            check_window_bwd(f"widths D={D}", lay_w, log, dtype, D=D)
            if D % 128 == 0 and dtype == torch.bfloat16:
                check_q8_table(f"widths D={D}", hn, w8, b8, 256, log)
    wide_legacy_pallas_variants(log)


def wide_legacy_pallas_variants(log):
    """The kernels of the legacy, pallas and variant paths at WIDE_DIMS:
    #10, #8 and #9 (check_legacy_kernels on a small legacy layout with
    empty blocks), #11 (check_window_widths' hub layout), #16 (a packed
    layout with an empty type), #18 and #19 (a tile_e 128 layout), #20 (a
    W 256 layout), each against its plain version and twice bit-equal."""
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import spmm as SP
    from ggnn_tpu_torch.ops import window as W
    dev = torch.device("cuda")
    r = np.random.default_rng(59)
    N, E, T2 = 1024, 6000, 6
    src, dst = r.integers(0, N, E), r.integers(0, N // 2, E)
    typ, mask = r.integers(0, T2, E), (r.random(E) < 0.9).astype(np.float32)
    lay = L.build_dst_block_layout(src, dst, typ, mask, N, tile_e=128,
                                   n_message_types=T2, row_order="block")
    check_legacy_kernels("widths", lay.to(dev), N, log, dims=WIDE_DIMS, T2=T2)
    check_stream_scatters("widths tile_e128", lay.to(dev), log, WIDE_DIMS)
    check_window_widths(log, WIDE_DIMS)
    cols = pallas_fuzz_edges(r, 500, 4000, 6, (2,), None, 0.1, 0.1)
    play = SP.pack_type_tiles(*(torch.as_tensor(c, device=dev)
                                for c in cols), 6, 128)
    for D in WIDE_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator(device=dev).manual_seed(D)
            h = (torch.rand(500, D, device=dev, generator=gen) * 2
                 - 1).to(dtype)
            w = (torch.randn(6, D, D, device=dev, generator=gen)
                 * D ** -0.5).to(dtype)
            bb = (torch.randn(6, D, device=dev, generator=gen)
                  * 0.1).to(dtype)
            check_packed_messages(
                f"widths D={D},{str(dtype).split('.')[-1]}", h, play, w, bb,
                log)
    Nw, Ew = 2048, 40_000
    src, dst, typ, mask = random_edges(r, Nw, Ew, 8)
    src = np.where(r.random(Ew) < 0.9,
                   (dst // 256) * 256 + r.integers(0, 256, Ew), src) % Nw
    wlay = W.build_window_layout(src, dst, typ, mask, Nw, window=256,
                                 min_edges_per_tile=8).to(dev)
    a = wlay.arrays
    check_window_auto("widths W256", (a["c_stream"], a["tile_start"],
                                      a["block_of_tile"], a["win_of_tile"],
                                      a["c_off"]), 8 * Nw, 256,
                      wlay.n_blocks, log, WIDE_DIMS)


def predictor_widths():
    """The reference's test_predictor_backends_agree (tests/test_infer.py)
    on the card: a D = 8 model (random weights from seed 0) serving seven
    small graphs through the xla, onehot and window (fused: #13 at D = 8
    through its padded D = 128 kernel, and unfused) Predictors; their
    predictions must be equal."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    rng = np.random.default_rng(0)
    gs = []
    for _ in range(7):
        n = int(rng.integers(5, 12))
        m = int(rng.integers(4, 2 * n))
        gs.append(dict(n_nodes=n, edges=np.stack(
            [rng.integers(0, n, m), rng.integers(0, 3, m),
             rng.integers(0, n, m)], axis=1),
            annotations=(rng.random((n, 2)) < 0.5).astype(np.float32),
            targets={}))
    spec = PaddingSpec(n_graphs=4, n_pad=64, e_pad=96, n_edge_types=3,
                       annotation_dim=2).round_up()
    kw = dict(state_dim=8, annotation_dim=2, n_edge_types=3, n_steps=3,
              head="node_select")
    params = init_params(ModelConfig(**kw), torch.Generator().manual_seed(0),
                         "cuda")
    zero_counts()
    preds = {}
    for name, backend, fuse in (("xla", "xla", False),
                                ("onehot", "onehot", False),
                                ("window", "window", False),
                                ("window_fused", "window", True)):
        cfg = ModelConfig(**kw, backend=backend, fuse_gru=fuse)
        preds[name] = Predictor(cfg, spec, params=params,
                                device="cuda").predict(gs)
    launches = {k: v for k, v in read_counts().items() if v}
    print(f"[widths] D = 8 Predictors: {preds}; launches {launches}",
          flush=True)
    if launches.get("window_step_gru", 0) == 0:
        raise AssertionError("widths: the fused window Predictor did not "
                             "launch #13")
    for name in ("onehot", "window", "window_fused"):
        if preds[name] != preds["xla"]:
            raise AssertionError(f"widths: the {name} Predictor's "
                                 f"predictions differ from xla's")


# --- GGS-NN and the native host plan: [ggsnn serve], [ggsnn train], the
# Trainer CLI on bAbI task 19, [native] -------------------------------------

# The headline model as a GGS-NN with bAbI task 19's round count (its
# max_seq_len, 3) and vocabulary (4 directions and the end token), on a
# batch of 64 graphs of 4,096 nodes and 62,500 logical edges each: the
# headline's 262,144 nodes and 8M directed edges.
GGSNN_GRAPHS, GGSNN_NODES, GGSNN_EDGES = 64, 4096, 62_500
ROUNDS, VOCAB = 3, 5


def ggsnn_graphs(seed=0):
    """The GGS-NN request: 64 uniform random graphs, drawn from ``seed`` as
    :func:`request_graph` draws one."""
    r = np.random.default_rng(seed)
    graphs = []
    for _ in range(GGSNN_GRAPHS):
        n, m = GGSNN_NODES, GGSNN_EDGES
        edges = np.stack([r.integers(0, n, m), r.integers(0, EDGE_TYPES, m),
                          r.integers(0, n, m)], axis=1)
        ann = (r.random((n, ANN)) < 0.1).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann))
    return graphs


def ggsnn_cfg(output="graph", **kw):
    """The headline model (D = 128, 8 edge types, T = 5, bf16 with f32
    sums) as a GGS-NN of ``ROUNDS`` rounds, annotation supervision on."""
    from ggnn_tpu_torch.models.config import ModelConfig
    kw.setdefault("backend", "onehot")
    kw.setdefault("compute_dtype", "bfloat16")
    return ModelConfig(state_dim=DIM, annotation_dim=ANN,
                       n_edge_types=EDGE_TYPES, n_steps=STEPS, head="ggsnn",
                       n_classes=VOCAB, n_rounds=ROUNDS, ggsnn_output=output,
                       ann_supervision=True, **kw)


@contextlib.contextmanager
def plain_ggsnn():
    """:func:`plain_versions`, and the fused typed steps (#2, #6) routed to
    their plain versions as well."""
    from ggnn_tpu_torch.models import ggnn as M
    from ggnn_tpu_torch.ops import scatter as S
    saved = M.typed_block_step_gru, M.typed_step_gru
    with plain_versions():
        M.typed_block_step_gru = S.typed_block_step_gru_reference
        M.typed_step_gru = S.typed_step_gru_reference
        try:
            yield
        finally:
            M.typed_block_step_gru, M.typed_step_gru = saved


def ggsnn_run(cfg, params, arrays, layout, annotations=None):
    """(outputs, annotations) of the GGS-NN rounds on the card."""
    import torch
    from ggnn_tpu_torch.models.ggsnn import ggsnn_forward
    ann = arrays["annotations"] if annotations is None else annotations
    with torch.inference_mode():
        return ggsnn_forward(
            params, cfg, ann, arrays["node_graph"], arrays["node_mask"],
            arrays["edge_src"], arrays["edge_dst"], arrays["edge_type"],
            arrays["edge_mask"], n_graphs=GGSNN_GRAPHS,
            type_offsets=arrays["type_offsets"], scatter_layout=layout)


def ggsnn_checks(tag, cfg, params, arrays, layout, log):
    """The served rounds against the port's plain path on the card, at the
    tolerances of [serve] (a bf16 value within 8 ulps at 1.0, the mean
    within 1e-3): the outputs and annotations of all K rounds, and each
    round from the kernel path's X^{(k)} (the round's outputs and
    X^{(k+1)}), so that rounding differences do not compound."""
    import dataclasses
    import torch
    got = ggsnn_run(cfg, params, arrays, layout)
    with plain_ggsnn():
        ref = ggsnn_run(cfg, params, arrays, layout)
    for what, g, r in zip(("outputs", "annotations"), got, ref):
        check(f"{tag}: {what} of all {ROUNDS} rounds", g, r, "flip",
              torch.bfloat16, log)
    one = dataclasses.replace(cfg, n_rounds=1)
    X = arrays["annotations"].float()
    for k in range(ROUNDS):
        g = ggsnn_run(one, params, arrays, layout, X)
        with plain_ggsnn():
            r = ggsnn_run(one, params, arrays, layout, X)
        for what, a, b in zip(("outputs", "X'"), g, r):
            check(f"{tag}: round {k} {what} from the same X", a[0], b[0],
                  "flip", torch.bfloat16, log)
        X = g[1][0]


def ggsnn_batch():
    """The GGS-NN request batched (``batch_graphs``: the native sort of 8M
    directed edges) and its typed pack, built ``with_grad`` for the train
    phase and served as it is, on the card; prints the host seconds."""
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.ops.scatter import _rup_block, build_typed_dst_layout
    graphs = ggsnn_graphs(0)
    spec = PaddingSpec(n_graphs=GGSNN_GRAPHS, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    t0 = time.perf_counter()
    batch = batch_graphs(graphs, spec)
    t1 = time.perf_counter()
    lay = build_typed_dst_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        _rup_block(spec.n_pad), n_message_types=2 * EDGE_TYPES,
        with_grad=True)
    t2 = time.perf_counter()
    lay = lay.to("cuda")
    print(f"[ggsnn serve] {GGSNN_GRAPHS} graphs of {GGSNN_NODES} nodes and "
          f"{GGSNN_EDGES} edges: batch_graphs {t1 - t0:.2f} s on the host; "
          f"typed pack with its grad half {t2 - t1:.2f} s (block mode "
          f"{lay.block_meta is not None}, grad_meta {lay.meta[5]})",
          flush=True)
    return graphs, batch, lay


def ggsnn_serve_phase(graphs, batch, lay, log):
    """[ggsnn serve]: the GGS-NN request through ``Predictor.run_batch``,
    both outputs, on the typed pack fused (#2 at every step of every round)
    and on ``backend='pallas'`` (#16 and #3); the launch counts, device ms
    a request (CUDA events around a second forward), the peak memory, the
    decoded answers and the checks of :func:`ggsnn_checks`; the pallas
    Predictor's ``predict`` on the graphs decodes as ``run_batch`` does.
    Returns the launches."""
    import torch
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.train.loop import batch_arrays
    launched = dict.fromkeys(KERNELS, 0)
    arrays = batch_arrays(batch, "cuda")
    fused = ("typed_block_step_gru" if lay.block_meta is not None
             else "typed_step_gru")
    for output in ("graph", "node"):
        for path, kw, layout, per in (
                ("typed fused", dict(fuse_gru=True), lay, {fused: STEPS}),
                ("pallas", dict(backend="pallas"), None,
                 {"packed_messages": STEPS, "gru_cell_fwd": STEPS})):
            cfg = ggsnn_cfg(output, **kw)
            params = init_params(cfg, torch.Generator().manual_seed(0),
                                 "cuda")
            pred = Predictor(cfg, batch.spec, params=params, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            res = pred.run_batch(batch, layout)
            t1 = time.perf_counter()
            launches = read_counts()
            expect_counts(f"ggsnn serve {output} {path}", launches,
                          {k: v * ROUNDS for k, v in per.items()})
            for k, v in launches.items():
                launched[k] += v
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            answers = pred.decode(res, batch, GGSNN_GRAPHS)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            with torch.inference_mode():
                ev[0].record()
                forward(params, cfg, arrays, GGSNN_GRAPHS, layout)
                ev[1].record()
            torch.cuda.synchronize()
            want = ((ROUNDS, GGSNN_GRAPHS, VOCAB) if output == "graph"
                    else (ROUNDS, NODES))
            if res.shape != want or not np.isfinite(res).all():
                raise AssertionError(f"ggsnn serve {output} {path}: bad "
                                     f"outputs {res.shape}")
            if len(answers) != GGSNN_GRAPHS:
                raise AssertionError("ggsnn serve: not every graph decoded")
            rate = 2 * EDGES * STEPS * ROUNDS / (ev[0].elapsed_time(ev[1])
                                                 * 1e-3)
            print(f"[ggsnn serve] {output} output, {path}: run_batch "
                  f"{t1 - t0:.3f} s on the host clock (copies in and out "
                  f"included); device forward "
                  f"{ev[0].elapsed_time(ev[1]):.2f} ms a request of "
                  f"{ROUNDS} rounds x {STEPS} steps (CUDA events, a second "
                  f"forward; {rate:.4e} directed-edges*T*K/s); peak device "
                  f"memory {peak:.2f} GiB; launches "
                  f"{ {k: v for k, v in launches.items() if v} }; answers of "
                  f"graphs 0-2 {answers[:3]}", flush=True)
            ggsnn_checks(f"ggsnn serve {output} {path}", cfg, params, arrays,
                         layout, log)
            if path == "pallas" and output == "node":
                # the pallas aggregation sums the messages with f32
                # index_add_ (atomics: last bits vary from run to run), so
                # a node near its graph's top may win in one run and not
                # in another: each round's answer must be a top node of
                # run_batch's scores within the tolerance, as [serve]
                # holds its answers
                t0 = time.perf_counter()
                again = pred.predict(graphs)
                secs = time.perf_counter() - t0
                base = np.arange(GGSNN_GRAPHS) * GGSNN_NODES
                top = res.reshape(ROUNDS, GGSNN_GRAPHS, GGSNN_NODES).max(2)
                picked = np.stack([res[k, base + np.array(
                    [a[k] for a in again])] for k in range(ROUNDS)])
                moved = sum(a != b for a, b in zip(again, answers))
                print(f"[ggsnn serve] Predictor.predict of the "
                      f"{GGSNN_GRAPHS} graphs (pallas, node output): "
                      f"{secs:.3f} s on the host clock; {moved} of "
                      f"{GGSNN_GRAPHS} answers differ from run_batch's, the "
                      f"picked scores at most "
                      f"{float((top - picked).max()):.3e} under their "
                      f"graph's top (tol {TOL_FLIP_MAX:.3e})", flush=True)
                if (top - picked).max() > TOL_FLIP_MAX:
                    raise AssertionError("ggsnn serve: predict picks a node "
                                         "that is not a top node")
            del pred, params, res
            torch.cuda.empty_cache()
    return launched


def ggsnn_targets(batch):
    """Random GGS-NN targets from seed 0: per graph a length in 1..K, the
    tokens ``seq`` and path nodes ``seq_nodes`` (−1 past it), and the
    annotation targets ``ann_seq`` [N, K, A] (one in ten set)."""
    import torch
    r = np.random.default_rng(0)
    live = (np.arange(ROUNDS)[None, :]
            < r.integers(1, ROUNDS + 1, GGSNN_GRAPHS)[:, None])
    seq = np.where(live, r.integers(0, VOCAB, live.shape), -1)
    nodes = np.where(live, r.integers(0, GGSNN_NODES, live.shape), -1)
    ann = (r.random((batch.spec.n_pad, ROUNDS, ANN)) < 0.1)
    return {"seq": torch.tensor(seq, dtype=torch.int32, device="cuda"),
            "seq_nodes": torch.tensor(nodes, dtype=torch.int32,
                                      device="cuda"),
            "ann_seq": torch.tensor(ann, dtype=torch.float32, device="cuda")}


def ggsnn_train_phase(batch, lay):
    """[ggsnn train]: 3 Adam steps of the GGS-NN through make_train_step on
    the request's batch with random targets and the annotation BCE: on the
    typed pack fused (#1 and #5 at each step of each round) with the graph
    and the node output, unfused (+ #3, #4) and on pallas (#16, #3, #4);
    the first step against the plain path, step ms, peak memory.  Returns
    the launches.  The first step's leaves are held to ``TOL_GGSNN``."""
    per = ROUNDS * STEPS
    fused = {"typed_block_scatter": per, "typed_grad_octet_scatter": per}
    unfused = dict(fused, gru_cell_fwd=per, gru_cell_bwd=per)
    pallas = {"packed_messages": per, "gru_cell_fwd": per,
              "gru_cell_bwd": per}
    targets = ggsnn_targets(batch)
    launched = {}
    for layout, modes in (
            (lay, {"typed fused": (dict(fuse_gru=True), fused),
                   "typed fused, node output": (
                       dict(fuse_gru=True, output="node"), fused),
                   "typed unfused": (dict(fuse_gru=False), unfused)}),
            (None, {"pallas": (dict(backend="pallas"), pallas)})):
        got = train_headline(batch, layout, modes, tag="ggsnn train",
                             f32_check=False, cfg_fn=ggsnn_cfg,
                             n_graphs=GGSNN_GRAPHS, targets=targets,
                             grad_tol=TOL_GGSNN)
        for k, v in got.items():
            launched[k] = launched.get(k, 0) + v
    return launched


# The Trainer CLI on bAbI task 19 from ``babi_data/``: ``babi19_small``
# (the node output) and ``babi19`` (the graph output), 3 epochs each
BABI19_RUNS = (dict(config="babi19_small"), dict(config="babi19"))


def babi19_trainers():
    """The BABI19_RUNS on the card, both at once; prints their test loss
    and accuracy."""
    run_trainers(*BABI19_RUNS)


def native_phase():
    """[native]: the port's native host library at the community headline:
    ``batch_graphs``'s sort of its 8M directed edges and the window
    Predictor's layout (``window_layout_for_batch``: the 16.5 GB padded
    count stream of its static budget), native and numpy, array for array
    equal; prints each one's host seconds."""
    from ggnn_tpu_torch import native
    from ggnn_tpu_torch.graph import lexsort_edges
    from ggnn_tpu_torch.ops import window as W
    native.library()
    print(f"[native] {native.BuildInfo.path} "
          f"{'compiled' if native.BuildInfo.compiled else 'loaded'} in "
          f"{native.BuildInfo.seconds:.2f} s", flush=True)
    s, t, d = community_graph(0)["edges"].T
    edges = (np.concatenate([s, d]), np.concatenate([d, s]),
             np.concatenate([t, t + EDGE_TYPES]))
    secs, out = {}, {}
    for use, sort in ((True, native.sort_edges_native),
                      (False, lexsort_edges)):
        t0 = time.perf_counter()
        out[use] = sort(*edges, 2 * EDGE_TYPES)
        secs[use] = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(out[True], out[False])):
        raise AssertionError("native: the sorts differ")
    print(f"[native] sort of {edges[0].shape[0]} directed edges: native "
          f"{secs[True]:.3f} s, numpy {secs[False]:.3f} s on the host; "
          f"equal", flush=True)
    del out, edges
    b = community_batch()
    lays, limit = {}, W.NATIVE_PLAN_EDGES
    for use in (True, False):
        # the Predictor's own call, its plan picked by the threshold: 0
        # (native) or past every graph (numpy)
        W.NATIVE_PLAN_EDGES = 0 if use else float("inf")
        try:
            t0 = time.perf_counter()
            lays[use] = W.window_layout_for_batch(b)
            secs[use] = time.perf_counter() - t0
        finally:
            W.NATIVE_PLAN_EDGES = limit
    a, c = lays[True], lays[False]
    same = (a.meta == c.meta and a.stats == c.stats
            and a.arrays.keys() == c.arrays.keys()
            and all(np.array_equal(a.arrays[k], c.arrays[k])
                    for k in a.arrays))
    if not same:
        raise AssertionError("native: the window layouts differ")
    print(f"[native] window_layout_for_batch of the community headline "
          f"({a.stats['n_tiles']} tiles, a {a.stats['stream_gb']:.2f} GB "
          f"count stream): native {secs[True]:.3f} s, numpy "
          f"{secs[False]:.3f} s on the host; meta, stats and "
          f"{len(a.arrays)} arrays equal", flush=True)


def ggsnn_phases(log, clock, sharded=None, babi19=True):
    """The GGS-NN phases, the bAbI 19 Trainer CLIs (unless ``babi19`` is
    False: the caller runs BABI19_RUNS) and [native]; returns the launches
    of the serving and training paths.  ``sharded(holder, clock)`` (the
    sharded phases) runs after [ggsnn train] on ``holder = [batch, typed
    pack]``, which it empties once it no longer needs them; its launches
    are added."""
    import torch
    graphs, batch, lay = ggsnn_batch()
    launched = ggsnn_serve_phase(graphs, batch, lay, log)
    del graphs
    clock.mark("[ggsnn serve]")
    for k, v in ggsnn_train_phase(batch, lay).items():
        launched[k] += v
    holder = [batch, lay]
    del batch, lay
    torch.cuda.empty_cache()
    clock.mark("[ggsnn train]")
    if sharded is not None:
        for k, v in sharded(holder, clock).items():
            launched[k] += v
    del holder
    torch.cuda.empty_cache()
    if babi19:
        babi19_trainers()
        clock.mark("the Trainer CLI, bAbI 19")
    native_phase()
    clock.mark("[native]")
    return launched


# --- the parallel layer: sharded phases on one card, two gloo ranks --------

SHARDED_P = 2           # ranks of the sharded phases, both on cuda:0
SHARDED_TIMEOUT = 900   # seconds the ranks get, their set-up included
# Tolerances of the sharded paths against the port's single-device path on
# the card (bf16, the headline model).  The single-device reference is
# ``propagate`` (backend 'xla') with ``gru_matmul_compute=False``: the
# reference's sharded GRU cell takes f32 matmul inputs, so this is the
# single-device path with the sharded path's GRU; the message weights take
# bf16 values (:func:`sharded_params`), so the typed strategies (all_gather,
# halo, halo_overlap) take the reference's products and differ from it by
# the order of their sums alone (on an H100 at 700 W: 2.2e-3 at most,
# 7.7e-5 on average).  halo_onehot still rounds its table rows to bf16 and
# the fused window step its gate inputs, which the reference does not:
# 1.3e-2 and 3.3e-2 at most, 1.9e-3 on average there (0.031 and 1.9e-3 on
# the CPU at 16,384 nodes with the port's plain versions); the bound is
# 2**-4 and 4e-3.  Paths that share their rounding points are held to each
# other at the [serve] tolerance (TOL_FLIP_MAX, TOL_FLIP_MEAN: halo and
# halo_overlap against all_gather, the on-demand window step against the
# table one); q8 serving to the exact sharded step (TOL_SHARDED_Q8).  First
# train steps: the loss within 1e-3 and every gradient leaf within
# TOL_TRAIN's bf16 bound (2**-6; the H100 read 1.14e-2 at most, on
# halo_onehot's), GGS-NN's within TOL_GGSNN (8.9e-3 there); with int8
# gradients (grad_quant), whose quantization noise the single-device exact
# step does not have, 0.3 (the H100 read 0.121, the CPU 0.17).  One Adam
# step moves an element by lr at most, so the updated parameters lie within
# 2·lr of the reference's step.
TOL_SHARDED = (2.0 ** -4, 4e-3)
TOL_SHARDED_Q8G = 0.3
# q8 serving against the exact sharded step: the reference's test holds 3
# steps of 1,024 nodes within 5 % of the largest state; over the
# headline's 5 steps and 262,144 nodes the quantization noise's tail
# reaches further (the card: 10.6 % of the largest state at one element,
# 1.5 % relative Frobenius), so the largest error within 2**-2 of the
# largest state and the relative Frobenius error within 2**-5
TOL_SHARDED_Q8 = (2.0 ** -2, 2.0 ** -5)
SHARDED_LR = 1e-3
# the sharded phases' device; their other values in CPU rehearsals
SHARDED_DEVICE = "cuda"
NCCL = "nccl"


def sharded_cfg(**kw):
    """The headline model as the sharded phases run it (bf16)."""
    kw.setdefault("backend", "xla")
    return headline_cfg(compute_dtype="bfloat16", **kw)


def sharded_params(cfg):
    """:func:`fresh_params` with the message weights and biases rounded to
    bf16 values (kept in f32).  The reference's typed strategies multiply
    the bf16 pool by the f32 weights, the single-device path by their bf16
    copy: with bf16 values both take the same products, so the sharded
    steps and their single-device references share their rounding points
    but for the order of the sums (a 3-round GGS-NN's gated pool over
    4,096 nodes a graph turned the weights' rounding alone into gradient
    differences of 0.44 on its readout gate)."""
    import torch
    params = fresh_params(cfg)
    with torch.no_grad():
        for k in ("msg_w", "msg_b"):
            w = params["prop"][k]
            w.copy_(w.to(torch.bfloat16).float())
    return params


def node_target():
    """train_headline's node_select target (seed 0)."""
    return int(np.random.default_rng(0).integers(0, NODES))


def flat_grads(params):
    """{leaf: its .grad on the host}."""
    from ggnn_tpu_torch.train.checkpoint import _flatten
    return {k: p.grad.detach().float().cpu() for k, p in _flatten(params)
            if p.grad is not None}


def flat_params(params):
    from ggnn_tpu_torch.train.checkpoint import _flatten
    return {k: p.detach().float().cpu() for k, p in _flatten(params)}


def timed(fn):
    """(fn's result, its ms by CUDA events, the launches it made)."""
    import torch
    torch.cuda.synchronize()
    zero_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1]), read_counts()


def params_same_on_ranks(params, group):
    """Every rank's parameters bit-equal to rank 0's (its flat copy
    all-gathered over ``group``)."""
    import torch
    from ggnn_tpu_torch.parallel import comm
    from ggnn_tpu_torch.train.loop import param_leaves
    flat = torch.cat([p.detach().float().reshape(-1)
                      for p in param_leaves(params)])
    everyone = comm.all_gather(flat[None], group)
    return all(torch.equal(everyone[0], x) for x in everyone)


def rank_serve(mesh, state):
    """[sharded serve] on this rank: the uniform headline through
    all_gather, halo, halo_overlap and halo_onehot, then the community
    headline through halo_window fused (the bf16 table, on-demand) and q8
    serving; each forward once to make the per-layout plans, then once
    counted and timed; the exchange alone."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.parallel import comm, sharded_propagate
    from ggnn_tpu_torch.train.loop import param_leaves
    from ggnn_tpu_torch.parallel.partition import (
        build_halo_scatter_layouts, build_halo_window_layouts,
        local_halo_layout, partition_batch, split_local_remote)
    axis, dev = mesh.axis("graph"), mesh.device
    r, P = axis.index, axis.size
    out, runs = {"host_s": {}}, {}
    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    parts = split_local_remote(partition_batch(b, P))
    scat = build_halo_scatter_layouts(parts, tile_e=512, with_grad=True)
    state["uniform"] = (parts.local(r, dev), local_halo_layout(scat, r, dev),
                        scat[1])
    out["host_s"]["uniform partition and one-hot layouts"] = \
        time.perf_counter() - t0
    out["halo_size"] = parts.halo_size
    del b, parts, scat
    t0 = time.perf_counter()
    cb = community_batch()
    cparts = split_local_remote(partition_batch(cb, P))
    wl = {}
    for od in (False, True):
        lay = build_halo_window_layouts(
            cparts, window=WINDOW, spill_tile_e=None,
            n_message_types=2 * EDGE_TYPES, row_major="block",
            typed_spill=True, on_demand=od, with_grad=True)
        wl[od] = (local_halo_layout(lay, r, dev), lay[1])
    state["community"] = (cparts.local(r, dev), wl)
    out["host_s"]["community partition and window layouts"] = \
        time.perf_counter() - t0
    out["community_halo_size"] = cparts.halo_size
    del cparts

    params = sharded_params(sharded_cfg())
    for p in param_leaves(params):
        # served: with parameters that take gradients the fused window
        # step writes its training residuals (#13's emit_res form)
        p.requires_grad_(False)
    lp, slay, _ = state["uniform"]
    clp = state["community"][0]
    wcfg = sharded_cfg(backend="window", fuse_gru=True)
    paths = [(s, sharded_cfg(), lp, slay if s == "halo_onehot" else None)
             for s in ("all_gather", "halo", "halo_overlap", "halo_onehot")]
    paths += [("halo_window table", wcfg, clp, wl[False][0]),
              ("halo_window on-demand", wcfg, clp, wl[True][0]),
              ("halo_window unfused", dataclasses.replace(wcfg,
                                                          fuse_gru=False),
               clp, wl[False][0]),
              ("halo_window q8", dataclasses.replace(wcfg,
                                                     quantized_table=True),
               clp, wl[False][0])]
    for tag, cfg, parts_, lay in paths:
        def run():
            with torch.inference_mode():
                return sharded_propagate(params["prop"], cfg, mesh, parts_,
                                         strategy=tag.split()[0],
                                         halo_layouts=lay)
        run()
        h, ms, launches = timed(run)
        runs[tag] = dict(h=h.float().cpu(), ms=ms, launches=launches)
        if tag in OVERLAP_PATHS:
            out.setdefault("overlap", {})[tag] = traced_held(
                run, dev, r, overlap_steps)

    # the exchange alone: the send rows gathered, the all-to-all (staged
    # through pinned host buffers: gloo), the pool concatenated
    hc = torch.randn(lp.n_local, DIM, device=dev).to(torch.bfloat16)
    idx = lp.send_idx.reshape(-1).long()

    def exchange():
        send = hc.index_select(0, idx).reshape(P, lp.halo_size, DIM)
        recv = comm.all_to_all(send, axis.group)
        return torch.cat([recv.reshape(-1, DIM), hc])

    def gather():
        return comm.all_gather(hc, axis.group)

    out["exchange_ms"] = cuda_ms(exchange, 5)
    out["gather_ms"] = cuda_ms(gather, 5)
    out["exchange_mb"] = 2 * P * lp.halo_size * DIM * 2 / 2 ** 20
    return with_runs(out, runs)


# The forwards whose exchange must overlap their local aggregation on the
# card ([overlap] in [sharded serve]).  In the traced forward rank 1 holds
# each all-to-all back OVERLAP_HOLD_S before it issues it, so rank 0's
# collective cannot complete before then: rank 0's local kernels must all
# end at least half the hold before its wait for the exchange returns.
# Had the issue waited for the collective, they would start after it.
# The backward's mirror ([overlap] in [sharded train]): traced train steps
# of OVERLAP_BWD_PATHS, rank 1 holding each reverse all-to-all back
# OVERLAP_HOLD_S; rank 0's local backward kernels (launched between its
# reverse issue and its wait) must end as long before its wait returns.
OVERLAP_PATHS = ("halo_overlap", "halo_window unfused")
OVERLAP_BWD_PATHS = ("halo_overlap", "halo_window")
OVERLAP_HOLD_S = 0.2


def trace_spans(path, names):
    """A Chrome trace of ``profiling.trace``: ({name: its spans (start,
    end), in time order} for ``names``, which must pair up; the kernels
    as (launch, start, end)).  A kernel is tied to its launch by the
    trace's correlation id; device and host times share the trace's clock
    (µs)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {n: sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("name") == n)
             for n in names}
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    kernels = [(launched[e["args"]["correlation"]], e["ts"],
                e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched]
    if len({len(v) for v in spans.values()}) != 1:
        raise AssertionError(f"[overlap] unpaired spans: "
                             f"{ {k: len(v) for k, v in spans.items()} }")
    return spans, kernels


def overlap_steps(path):
    """Per step of a traced sharded forward, in ms: (the device time of
    the kernels launched inside the step's ``halo/local`` span, the part of
    it inside the ``halo/wait`` span, the time from the last of them to the
    wait's end, the ``halo/exchange`` span)."""
    spans, kernels = trace_spans(path, ("halo/exchange", "halo/local",
                                        "halo/wait"))
    steps = []
    for (x0, x1), (l0, l1), (w0, w1) in zip(*spans.values()):
        mine = [(a, b) for t, a, b in kernels if l0 <= t <= l1]
        inside = sum(max(0.0, min(b, w1) - max(a, w0)) for a, b in mine)
        last = max((b for _, b in mine), default=w1)
        steps.append((sum(b - a for a, b in mine) / 1e3, inside / 1e3,
                      (w1 - last) / 1e3, (x1 - x0) / 1e3))
    return steps


def overlap_bwd_steps(path):
    """Per step with a reverse exchange of a traced sharded train step, in
    ms: (the device time of the kernels launched between the reverse
    all-to-all's issue and its wait, i.e. from the start of
    ``halo/bwd_exchange`` to that of ``halo/bwd_wait``: the local
    backward; the time from the last of them to the wait's end; the
    ``halo/bwd_exchange`` span; the ``halo/bwd_wait`` span)."""
    spans, kernels = trace_spans(path, ("halo/bwd_exchange",
                                        "halo/bwd_wait"))
    steps = []
    for (x0, x1), (w0, w1) in zip(*spans.values()):
        mine = [(a, b) for t, a, b in kernels if x0 <= t <= w0]
        last = max((b for _, b in mine), default=w1)
        steps.append((sum(b - a for a, b in mine) / 1e3, (w1 - last) / 1e3,
                      (x1 - x0) / 1e3, (w1 - w0) / 1e3))
    return steps


def traced_held(run, dev, rank, parse, backward=False):
    """``parse`` of the trace of one ``run()`` on this rank, rank 1 holding
    each all-to-all (``backward``: each reverse all-to-all) back
    OVERLAP_HOLD_S before it issues it.  The ranks meet at a barrier (a
    gloo group of their own) just before each such issue, so the hold
    counts from a common start on every rank: how far apart the ranks
    arrive (the profiler's start takes each process its own time) does
    not eat into it.  Python's cyclic collector is run before the trace
    and kept off during it: a rank's full collection takes 150-200 ms on
    the card's host, and one that fell between rank 0's issue and its
    local launches would eat the margin that the check reads."""
    import gc
    import os
    import shutil
    import torch.distributed as dist
    from ggnn_tpu_torch import profiling
    from ggnn_tpu_torch.parallel import comm
    name = "_backward" if backward else "all_to_all_start"
    own = getattr(comm, name)
    sync = dist.new_group(backend="gloo")

    def held(*args, **kw):
        if not backward or args[0] == "all_to_all":
            dist.barrier(group=sync)
            if rank == 1:
                time.sleep(OVERLAP_HOLD_S)
        return own(*args, **kw)

    out_dir = repo_file(".chip_scratch", f"overlap_{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    setattr(comm, name, held)
    collecting = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with profiling.trace(out_dir, dev):
            run()
    finally:
        if collecting:
            gc.enable()
        setattr(comm, name, own)
        dist.destroy_process_group(sync)
    (trace,) = os.listdir(out_dir)
    steps = parse(os.path.join(out_dir, trace))
    shutil.rmtree(out_dir)
    return steps


def check_overlap(serve, card):
    """[overlap]: in every step of each traced forward, rank 0's local
    aggregation's kernels all ended at least half of rank 1's hold before
    rank 0's wait for the exchange returned."""
    margin = OVERLAP_HOLD_S * 1e3 / 2
    for tag in OVERLAP_PATHS:
        for r, res in enumerate(serve):
            steps = res["overlap"][tag]
            if len(steps) != STEPS:
                raise AssertionError(f"[overlap] {tag} rank {r}: "
                                     f"{len(steps)} traced steps, not "
                                     f"{STEPS}")
            print(f"[overlap] rank {r} {tag} (rank 1 held "
                  f"{OVERLAP_HOLD_S} s a step): per step, the local "
                  f"aggregation's kernels (ms) "
                  f"{[round(x[0], 3) for x in steps]}, of which inside the "
                  f"wait for the exchange {[round(x[1], 3) for x in steps]}; "
                  "the last of them ended before the wait returned by "
                  f"{[round(x[2], 3) for x in steps]}; the exchange span "
                  f"{[round(x[3], 3) for x in steps]} (traced); card "
                  f"{card}", flush=True)
            if r == 0 and not all(x[0] > 0 and x[2] >= margin
                                  for x in steps):
                raise AssertionError(f"[overlap] {tag} rank 0: a step's "
                                     "local aggregation did not end "
                                     f"{margin} ms before its exchange "
                                     "completed: per step (kernels ms, of "
                                     "which in the wait, margin, exchange "
                                     f"span) {steps}")


def check_overlap_bwd(train, card):
    """[overlap], the backward: in every step with a reverse exchange (the
    first step's sent rows take no gradient) of each traced train step,
    rank 0's local backward kernels all ended at least half of rank 1's
    hold before rank 0's wait for the reverse all-to-all returned."""
    margin = OVERLAP_HOLD_S * 1e3 / 2
    for tag in OVERLAP_BWD_PATHS:
        for r, res in enumerate(train):
            steps = res["overlap"][tag]
            if len(steps) != STEPS - 1:
                raise AssertionError(f"[overlap] backward {tag} rank {r}: "
                                     f"{len(steps)} traced reverse "
                                     f"exchanges, not {STEPS - 1}")
            print(f"[overlap] backward rank {r} {tag} train step (rank 1 "
                  f"held each reverse all-to-all {OVERLAP_HOLD_S} s): per "
                  "step, the local backward's kernels (ms) "
                  f"{[round(x[0], 3) for x in steps]}; the last of them "
                  "ended before the wait returned by "
                  f"{[round(x[1], 3) for x in steps]}; the reverse exchange "
                  f"span {[round(x[2], 3) for x in steps]}, its wait "
                  f"{[round(x[3], 3) for x in steps]} (traced); card {card}",
                  flush=True)
            if r == 0 and not all(x[0] > 0 and x[1] >= margin
                                  for x in steps):
                raise AssertionError(f"[overlap] backward {tag} rank 0: a "
                                     "step's local backward did not end "
                                     f"{margin} ms before its reverse "
                                     "exchange completed: per step "
                                     "(kernels ms, margin, exchange span, "
                                     f"wait) {steps}")


def with_runs(out, runs):
    """A rank phase's results: ``runs`` (path -> its results) under
    "out", their launch counts under "launches"."""
    out["out"] = runs
    out["launches"] = {tag: res["launches"] for tag, res in runs.items()}
    return out


def rank_train(mesh, state):
    """[sharded train] on this rank: one node_select task step each
    through halo_onehot (the uniform headline) and halo_window (the
    community headline, on-demand, exact and with int8 gradients); then
    [overlap]'s traced train steps (:func:`overlap_bwd_steps`)."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.parallel import make_sharded_task_train_step
    from ggnn_tpu_torch.train.loop import make_optimizer
    axis = mesh.axis("graph")
    dev = mesh.device
    lp, slay, smeta = state["uniform"]
    clp, wl = state["community"]
    wlay, wmeta = wl[True]
    # grad_quant sets the layout's meta[10] alone (build_window_layout:
    # the arrays are those of the exact layout)
    qlay = dataclasses.replace(wlay, meta=wlay.meta[:10] + (True,))
    qmeta = dict(wmeta, full_meta=qlay.meta)
    targets = {"n_nodes": torch.tensor([NODES], dtype=torch.int32,
                                       device=dev),
               "node": torch.tensor([node_target()], dtype=torch.int32,
                                    device=dev)}
    wcfg = sharded_cfg(backend="window", fuse_gru=True)
    runs = {}
    for tag, cfg, parts_, lay, meta in (
            ("halo_onehot", sharded_cfg(), lp, slay, smeta),
            ("halo_window", wcfg, clp, wlay, wmeta),
            ("halo_window grad_quant", wcfg, clp, qlay, qmeta)):
        params = sharded_params(cfg)
        opt = make_optimizer(params, SHARDED_LR)
        step = make_sharded_task_train_step(
            cfg, mesh, opt, 1, strategy=tag.split()[0], halo_meta=meta)
        m, ms, launches = timed(lambda: step(params, parts_, targets, lay))
        runs[tag] = dict(loss=float(m["loss_sum"] / m["count"]), ms=ms,
                        launches=launches,
                        same=params_same_on_ranks(params, axis.group),
                        grads=flat_grads(params) if mesh.rank == 0 else None,
                        params=flat_params(params) if mesh.rank == 0
                        else None)
        del params, opt, step
        torch.cuda.empty_cache()
    # [overlap], the backward: one traced step each (after one untraced,
    # which makes the per-layout plans)
    out = {"overlap": {}}
    for tag, cfg, parts_, lay, meta in (
            ("halo_overlap", sharded_cfg(), lp, None, None),
            ("halo_window", wcfg, clp, wlay, wmeta)):
        params = sharded_params(cfg)
        opt = make_optimizer(params, SHARDED_LR)
        step = make_sharded_task_train_step(cfg, mesh, opt, 1, strategy=tag,
                                            halo_meta=meta)
        step(params, parts_, targets, lay)
        out["overlap"][tag] = traced_held(
            lambda: step(params, parts_, targets, lay), dev, axis.index,
            overlap_bwd_steps, backward=True)
        del params, opt, step
        torch.cuda.empty_cache()
    return with_runs(out, runs)


def ggsnn_cell(device):
    """The [ggsnn *] phases' cell: the batch of 64 graphs of 4,096 nodes
    with the targets of :func:`ggsnn_targets` (host copies in
    ``batch.targets``), and those targets on ``device`` with ``n_nodes``."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    spec = PaddingSpec(n_graphs=GGSNN_GRAPHS, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    batch = batch_graphs(ggsnn_graphs(0), spec)
    targets = {k: v.to(device) for k, v in ggsnn_targets(batch).items()}
    batch.targets = {k: v.cpu().numpy() for k, v in targets.items()}
    targets["n_nodes"] = torch.as_tensor(batch.n_nodes, device=device)
    return batch, targets


# graph counts of the uneven [ddp] steps: parts of 32 and 31 graphs (one
# empty slot), and one graph (rank 1 all padding)
DDP_UNEVEN = (63, 1)


def ggsnn_sub_cell(n, targets):
    """The GGS-NN cell's first ``n`` graphs as a batch of ``n`` slots (their
    rows and edges alone), with the cell's ``targets`` (host arrays) for
    them in ``batch.targets``."""
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    spec = PaddingSpec(n_graphs=n, n_pad=n * GGSNN_NODES,
                       e_pad=2 * n * GGSNN_EDGES, n_edge_types=EDGE_TYPES,
                       annotation_dim=ANN)
    batch = batch_graphs(ggsnn_graphs(0)[:n], spec)
    batch.targets = {"seq": targets["seq"][:n],
                     "seq_nodes": targets["seq_nodes"][:n],
                     "ann_seq": targets["ann_seq"][:spec.n_pad]}
    return batch


def typed_grad_pack(batch, device):
    """The typed pack of ``batch`` with its grad half, on ``device``."""
    from ggnn_tpu_torch.ops.scatter import _rup_block, build_typed_dst_layout
    return build_typed_dst_layout(
        batch.edge_src, batch.edge_dst, batch.edge_type, batch.edge_mask,
        _rup_block(batch.spec.n_pad), n_message_types=2 * EDGE_TYPES,
        with_grad=True).to(device)


def rank_ggsnn(mesh, state):
    """[sharded ggsnn] on this rank: one sharded GGS-NN task step (the
    graph output, annotation supervision) through halo; then [ddp]: one
    data-parallel step of the same cell, each rank with its 32 graphs'
    typed pack, fused; then one on the cell's first 63 graphs (32 and 31
    graphs, the second part ending in an empty slot) and one on its first
    graph (rank 1 all padding)."""
    import torch
    from ggnn_tpu_torch.parallel import make_sharded_task_train_step
    from ggnn_tpu_torch.parallel.partition import partition_batch
    from ggnn_tpu_torch.parallel.train import (make_gspmd_train_step,
                                               split_batch)
    from ggnn_tpu_torch.train.loop import batch_arrays, make_optimizer
    axis, dev = mesh.axis("graph"), mesh.device
    out, runs = {"host_s": {}}, {}
    t0 = time.perf_counter()
    batch, targets = ggsnn_cell(dev)
    lp = partition_batch(batch, axis.size).local(axis.index, dev)
    out["host_s"]["ggsnn batch and partition"] = time.perf_counter() - t0
    cfg = ggsnn_cfg("graph", backend="xla")
    params = sharded_params(cfg)
    opt = make_optimizer(params, SHARDED_LR)
    step = make_sharded_task_train_step(cfg, mesh, opt, GGSNN_GRAPHS,
                                        strategy="halo")
    m, ms, launches = timed(lambda: step(params, lp, targets))
    runs["ggsnn"] = dict(loss=float(m["loss_sum"] / m["count"]), ms=ms,
                        launches=launches,
                        same=params_same_on_ranks(params, axis.group),
                        grads=flat_grads(params) if mesh.rank == 0 else None)
    del params, opt, step, lp
    torch.cuda.empty_cache()

    # [ddp]: the cell's 64 graphs, then DDP_UNEVEN's counts
    cfg = ggsnn_cfg("graph", fuse_gru=True)
    for tag, n in (("ddp", GGSNN_GRAPHS),
                   *((f"ddp{n}", n) for n in DDP_UNEVEN)):
        t0 = time.perf_counter()
        whole = batch if n == GGSNN_GRAPHS else ggsnn_sub_cell(
            n, batch.targets)
        sub = split_batch(whole, mesh.size, mesh.rank)
        lay = typed_grad_pack(sub, dev)
        arrays = batch_arrays(sub, dev)
        out["host_s"][f"{tag} split and typed pack"] = \
            time.perf_counter() - t0
        params = sharded_params(cfg)
        opt = make_optimizer(params, SHARDED_LR)
        step = make_gspmd_train_step(cfg, n, opt, mesh)
        m, ms, launches = timed(lambda: step(params, arrays, lay))
        runs[tag] = dict(loss=float(m["loss_sum"] / m["count"]), ms=ms,
                         launches=launches,
                         graphs=int((sub.n_nodes > 0).sum()),
                         slots=sub.spec.n_graphs, rows=sub.spec.n_pad,
                         same=params_same_on_ranks(params, axis.group),
                         grads=flat_grads(params) if mesh.rank == 0
                         else None)
        del params, opt, step, lay, arrays, sub, whole
        torch.cuda.empty_cache()
    return with_runs(out, runs)


def tree_map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)


def host_copy(x):
    """Tensors as numpy arrays: a rank's results cross the queue by value
    (torch's shared-memory handles would die with the rank)."""
    import torch
    return x.numpy() if isinstance(x, torch.Tensor) else x


def tensor_copy(x):
    import torch
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def rank_reproducible(mesh, state):
    """[reproducible] sharded, on this rank: one halo request of the
    uniform headline (``make_sharded_eval_step``: propagation, the head and
    its loss with cross-rank collectives) with the node_select and the
    graph_gated head, each twice from the same state; the loss and this
    rank's final states must hold the same bits."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.parallel import sharded_propagate
    from ggnn_tpu_torch.parallel.halo import make_sharded_eval_step
    from ggnn_tpu_torch.train.loop import param_leaves
    dev = mesh.device
    if "uniform" not in state:
        from ggnn_tpu_torch.data.synthetic import synthetic_batch
        from ggnn_tpu_torch.parallel.partition import (partition_batch,
                                                       split_local_remote)
        b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                            seed=0, node_mult=128)
        parts = split_local_remote(partition_batch(b, mesh.axis(
            "graph").size))
        state["uniform"] = (parts.local(mesh.axis("graph").index, dev),
                            None, None)
    lp = state["uniform"][0]
    zero_counts()
    runs, same = {}, {}
    for head in ("node_select", "graph_gated"):
        cfg = dataclasses.replace(sharded_cfg(), head=head,
                                  n_classes=1 if head == "node_select" else 4)
        params = sharded_params(cfg)
        for p in param_leaves(params):
            p.requires_grad_(False)
        targets = {"n_nodes": torch.tensor([NODES], dtype=torch.int32,
                                           device=dev),
                   "node": torch.tensor([node_target()], dtype=torch.int32,
                                        device=dev),
                   "cls": torch.tensor([1], dtype=torch.int32, device=dev)}
        step = make_sharded_eval_step(cfg, mesh, 1, strategy="halo")

        def run():
            with torch.inference_mode():
                m = step(params, lp, targets)
                h = sharded_propagate(params["prop"], cfg, mesh, lp,
                                      strategy="halo")
            return {"loss": m["loss_sum"].float().cpu(), "h": h.cpu()}
        first, again = run(), run()
        same[head] = all(torch.equal(first[k], again[k]) for k in first)
        runs[f"halo {head}"] = dict(loss=first["loss"], same=same[head],
                                    launches={})
    launches = read_counts()
    runs["halo node_select"]["launches"] = launches
    return with_runs({"same": same}, runs)


def check_reproducible_sharded(results, card, strict=True):
    """Every rank's two sharded runs bit-equal, and the ranks' losses the
    same replica."""
    out = {}
    for head in ("node_select", "graph_gated"):
        same = all(res["same"][head] for res in results)
        losses = [float(res["out"][f"halo {head}"]["loss"]) for res in results]
        out[f"sharded halo {head} request"] = same
        print(f"[reproducible] sharded halo {head} request, {SHARDED_P} "
              f"ranks: two runs {'bit-equal' if same else 'DIFFER'} on "
              f"every rank; the ranks' loss sums {losses} ({card})",
              flush=True)
        if strict and not same:
            raise AssertionError(f"[reproducible] sharded halo {head}: two "
                                 "runs differ")
    phase_footer("[reproducible] sharded", results)
    return out


RANK_PHASES = (("[sharded serve]", rank_serve),
               ("[reproducible] sharded", rank_reproducible),
               ("[sharded train]", rank_train),
               ("[sharded ggsnn] and [ddp]", rank_ggsnn))


def sharded_rank(rank, world, port, queue, phases=RANK_PHASES):
    """One rank of the sharded phases (a spawned process on the card):
    joins the gloo world, loads the kernels, runs each phase of ``phases``
    (name, function of (mesh, state)) and puts (rank, phase, results) on
    ``queue``; a failure puts its traceback and ends the process with exit
    code 1."""
    import os
    import traceback
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        import torch
        from ggnn_tpu_torch.ops import _build
        from ggnn_tpu_torch.parallel import make_mesh
        from ggnn_tpu_torch.parallel.multihost import initialize_multihost
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = None if SHARDED_DEVICE == "cuda" else SHARDED_DEVICE
        initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                             num_processes=world, process_id=rank,
                             init_timeout_s=120, backend="gloo", device=dev)
        _build.library()
        mesh = make_mesh(n_graph=world, device=dev)
        state = {}
        for name, phase in phases:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = phase(mesh, state)
            torch.cuda.synchronize()
            res["wall_s"] = time.perf_counter() - t0
            res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            queue.put((rank, name, tree_map_leaves(host_copy, res)))
        torch.distributed.destroy_process_group()
        queue.put((rank, "done", None))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        queue.close()
        queue.join_thread()
        os._exit(1)


def run_ranks(on_phase, world=SHARDED_P, phases=RANK_PHASES):
    """Spawn ``world`` ranks of :func:`sharded_rank` running ``phases``
    (the ``spawn`` start method: CUDA is initialised here) on a free
    rendezvous port; as soon as every rank has reported a phase,
    ``on_phase(phase, [result of rank 0, rank 1, …])`` checks it.  A rank
    that fails or outlives SHARDED_TIMEOUT fails the phase."""
    import multiprocessing as mp
    import queue as queue_mod
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank,
                         args=(r, world, port, q, phases))
             for r in range(world)]
    for p in procs:
        p.start()
    results, done = {}, 0
    deadline = time.monotonic() + SHARDED_TIMEOUT
    try:
        while done < world:
            try:
                rank, name, res = q.get(timeout=max(
                    1.0, deadline - time.monotonic()))
            except queue_mod.Empty:
                raise AssertionError(
                    f"sharded ranks: no result within {SHARDED_TIMEOUT} s "
                    "(a rank hangs)") from None
            if name == "error":
                raise AssertionError(f"sharded rank {rank} failed:\n{res}")
            if name == "done":
                done += 1
                continue
            got = results.setdefault(name, [None] * world)
            got[rank] = tree_map_leaves(tensor_copy, res)
            if all(x is not None for x in got):
                on_phase(name, results.pop(name))
        for p in procs:
            p.join(timeout=60)
            if p.exitcode != 0:
                raise AssertionError(f"sharded rank exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def single_device_refs(b, holder):
    """The single-device path on the card, before the ranks start: the
    first GGS-NN step through the cell's whole typed pack fused (the [ddp]
    reference; ``holder`` is emptied after it) and through the typed packs
    of its first 63 graphs and its first graph (the uneven [ddp] steps'),
    then on 'xla' with f32 GRU
    matmul inputs (the sharded path's cell): the GGS-NN cell's first step,
    the uniform and community headline forwards (``propagate``) and their
    first node_select steps.  The 'xla' steps recompute each propagation
    step in the backward (``cfg.remat``: the same values, without keeping
    15 steps' node-transform operands)."""
    import torch
    from ggnn_tpu_torch.models import propagate
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import batch_arrays, param_leaves

    def first_step(cfg, arrays, n_graphs, layout=None):
        params = sharded_params(cfg)
        loss, _ = loss_and_metrics(params, cfg, arrays, n_graphs,
                                   scatter_layout=layout)
        g = torch.autograd.grad(loss, param_leaves(params))
        return dict(loss=float(loss.detach()), params=params, grads={
            k: x.float().cpu() for (k, _), x in zip(_flatten(params), g)})

    refs = {}
    batch, lay = holder
    arrays = batch_arrays(batch, SHARDED_DEVICE)
    arrays["targets"] = ggsnn_targets(batch)
    cfg = ggsnn_cfg("graph", fuse_gru=True)
    refs["ddp"] = first_step(cfg, arrays, GGSNN_GRAPHS, lay)
    holder.clear()
    del lay
    torch.cuda.empty_cache()
    host = {k: v.cpu().numpy() for k, v in arrays["targets"].items()}
    for n in DDP_UNEVEN:
        sub = ggsnn_sub_cell(n, host)
        refs[f"ddp{n}"] = first_step(cfg, batch_arrays(sub, SHARDED_DEVICE),
                                     n, typed_grad_pack(sub, SHARDED_DEVICE))
        del sub
        torch.cuda.empty_cache()
    refs["ggsnn"] = first_step(ggsnn_cfg("graph", backend="xla",
                                         gru_matmul_compute=False,
                                         remat=True), arrays, GGSNN_GRAPHS)
    del arrays, batch
    for name, batch in (("uniform", b), ("community", community_batch())):
        arrays = batch_arrays(batch, SHARDED_DEVICE)
        arrays["targets"] = {"node": torch.tensor(
            [node_target()], dtype=torch.int32, device=SHARDED_DEVICE)}
        cfg = sharded_cfg(gru_matmul_compute=False, remat=True)
        refs[name] = first_step(cfg, arrays, 1)
        with torch.no_grad():
            refs[name]["h"] = propagate(
                refs[name]["params"]["prop"], cfg, arrays["annotations"],
                arrays["edge_src"], arrays["edge_dst"], arrays["edge_type"],
                arrays["edge_mask"]).float().cpu()
        del arrays
    torch.cuda.empty_cache()
    return refs


def hold(name, got, ref, tol_max, tol_mean):
    """|got − ref| within (tol_max · max(1, max|ref|), tol_mean); prints
    and returns the largest error."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(ref.shape)}")
    d = (got.double() - ref.double()).abs()
    emax, emean = d.max().item(), d.mean().item()
    tol = tol_max * max(1.0, ref.abs().max().item())
    ok = emax <= tol and emean <= tol_mean
    print(f"  {name}: max_abs_err {emax:.3e} (tol {tol:.3e}) mean_abs_err "
          f"{emean:.3e} (tol {tol_mean:.1e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: error over tolerance")
    return emax


def hold_step(name, res, ref, tol, lr=None):
    """A first train step against the single-device one: the loss within
    1e-3, every gradient leaf's relative Frobenius error within ``tol``
    (a leaf that vanishes by symmetry within TOL_SYMMETRIC of the
    gradient's norm), and with ``lr`` the updated parameters within 2·lr
    of the reference's Adam step."""
    import torch
    dl = abs(res["loss"] - ref["loss"]) / max(abs(ref["loss"]), 1e-30)
    total = torch.stack([g.double().norm()
                         for g in ref["grads"].values()]).norm().item()
    errs, sym = [], 0.0
    for k, g_ref in ref["grads"].items():
        got = res["grads"][k]
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite gradient {k}")
        if k in SYMMETRIC_LEAVES:
            sym = max(sym, got.double().norm().item() / total,
                      g_ref.double().norm().item() / total)
            continue
        errs.append((relfro(got, g_ref), k))
    errs.sort(reverse=True)
    ok = dl <= 1e-3 and errs[0][0] <= tol and sym <= TOL_SYMMETRIC
    moved = ""
    if lr is not None:
        from ggnn_tpu_torch.train.checkpoint import _flatten
        p = {k: v.detach().clone() for k, v in _flatten(ref["params"])}
        opt = torch.optim.Adam(list(p.values()), lr=lr, betas=(0.9, 0.999),
                               eps=1e-8)
        for k, v in p.items():
            v.grad = ref["grads"][k].to(v.device)
        opt.step()
        far = max((res["params"][k] - v.float().cpu()).abs().max().item()
                  for k, v in p.items())
        ok = ok and far <= 2 * lr * (1 + 1e-3)
        moved = f"; updated parameters within {far:.3e} of its Adam step " \
                f"(tol {2 * lr:.1e})"
    print(f"  {name}: loss {res['loss']:.6f} vs {ref['loss']:.6f} (rel "
          f"{dl:.3e}, tol 1e-3); worst leaves (rel_frobenius, tol "
          f"{tol:.3e}) " + ", ".join(f"{k} {e:.3e}" for e, k in errs[:3])
          + f"; {'/'.join(SYMMETRIC_LEAVES)} {sym:.3e} of the norm"
          + moved + f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: disagrees with the single-device "
                             "step")
    return errs[0][0]


def rank_line(phase, rank, tag, res, card, err=None, extra=""):
    launches = {k: v for k, v in res["launches"].items() if v}
    print(f"{phase} rank {rank} {tag}: step {res['ms']:.2f} ms (CUDA "
          f"events){extra}; largest error against the single-device path "
          f"{'not compared' if err is None else f'{err:.3e}'}; launches "
          f"{launches}; card {card}", flush=True)


def must_launch(tag, launches, names):
    """The kernels a sharded path has to have run."""
    for n in names:
        if not launches[n]:
            raise AssertionError(f"{tag}: {n} was never launched")


def sharded_phases(holder, clock, extra=()):
    """The parallel layer on the card (``ggnn_tpu_torch/parallel``), two
    ranks on cuda:0 over gloo (NCCL takes one rank per device), at the
    headline width: [sharded serve] (with [overlap]), [sharded train],
    [sharded ggsnn], [ddp], each against the single-device path; then
    [sharded nccl] and [scaling].
    ``holder`` = [the GGS-NN cell's batch, its typed pack] (emptied once the
    [ddp] reference is made); ``extra``: more rank phases, (name, function
    of (mesh, state), check of (results, refs, card)), run after
    RANK_PHASES.  Returns the ranks' launches on the sharded main paths."""
    import torch
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    t_start = time.perf_counter()
    card = card_line()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    refs = single_device_refs(b, holder)
    torch.cuda.empty_cache()
    clock.mark("[sharded] single-device references")
    launched = dict.fromkeys(KERNELS, 0)
    checks = {"[sharded serve]": check_sharded_serve,
              "[reproducible] sharded": lambda results, refs, card:
              check_reproducible_sharded(results, card),
              "[sharded train]": check_sharded_train,
              "[sharded ggsnn] and [ddp]": check_sharded_ggsnn,
              **{name: check for name, _, check in extra}}

    def on_phase(name, results):
        for res in results:
            for launches in res["launches"].values():
                for k, v in launches.items():
                    launched[k] += v
        checks[name](results, refs, card)
        clock.mark(f"{name} ({SHARDED_P} ranks, their set-up included)")

    run_ranks(on_phase, phases=RANK_PHASES + tuple(
        (name, fn) for name, fn, _ in extra))
    nccl_phase(b, refs["uniform"], card)
    clock.mark("[sharded nccl]")
    del b, refs
    torch.cuda.empty_cache()
    scaling_phase()
    clock.mark("[scaling]")
    print(f"[sharded] the sharded phases took "
          f"{time.perf_counter() - t_start:.1f} s of wall time; two ranks "
          "share one card over a host-staged transport, so their times are "
          "no scaling number", flush=True)
    return launched


# bench_scaling_gpu.py's runs in [scaling]: (ranks, arguments)
SCALING_RUNS = ((1, ("--strategy", "halo_overlap")),
                (2, ("--strategy", "halo_overlap", "--shards", "1", "2",
                     "--iters", "2")))
SCALING_KEYS = {"metric", "value", "unit", "vs_baseline", "strategy",
                "shards", "device"}


def scaling_phase():
    """[scaling]: ``bench_scaling_gpu.py`` (the port of bench_scaling.py)
    through ``torch.distributed.run`` for each of SCALING_RUNS: exit 0, its
    per-P lines, the card's line and its JSON line, which must hold the
    reference's keys with P = 1's efficiency 1.0."""
    for n, extra in SCALING_RUNS:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(n),
               repo_file("bench_scaling_gpu.py"), *extra]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        print(f"[scaling] torchrun --nproc_per_node {n} bench_scaling_gpu.py "
              f"{' '.join(extra)} (rc {res.returncode}, "
              f"{time.perf_counter() - t0:.1f} s):", flush=True)
        for line in res.stderr.splitlines():
            if line.startswith("# "):
                print(f"  {line}", flush=True)
        lines = res.stdout.strip().splitlines()
        for line in lines:
            print(f"  {line}", flush=True)
        if res.returncode != 0 or not lines:
            raise AssertionError(f"[scaling] bench_scaling_gpu.py failed:\n"
                                 f"{res.stderr[-4000:]}")
        rec = json.loads(lines[-1])
        if set(rec) != SCALING_KEYS or \
                rec["unit"] != "frac_of_1chip_per_chip_throughput" or \
                rec["shards"]["1"]["efficiency"] != 1.0:
            raise AssertionError(f"[scaling] not the reference's record: "
                                 f"{rec}")


def phase_footer(phase, results):
    for r, res in enumerate(results):
        print(f"{phase} rank {r}: host seconds {res.get('host_s', {})}; "
              f"phase {res['wall_s']:.1f} s; peak device memory "
              f"{res['peak_gib']:.2f} GiB", flush=True)


def check_sharded_serve(serve, refs, card):
    """[sharded serve]'s results against the single-device forwards."""
    import torch
    n_loc = NODES // SHARDED_P
    for r, res in enumerate(serve):
        print(f"[sharded serve] rank {r}: halo size {res['halo_size']} "
              f"(uniform), {res['community_halo_size']} (community); the "
              f"exchange alone {res['exchange_ms']:.3f} ms for "
              f"{res['exchange_mb']:.1f} MiB sent and received (halo, "
              f"staged through pinned host buffers), the all_gather "
              f"{res['gather_ms']:.3f} ms", flush=True)
    for tag in ("all_gather", "halo", "halo_overlap", "halo_onehot",
                "halo_window table", "halo_window on-demand",
                "halo_window unfused", "halo_window q8"):
        ref = refs["community" if "window" in tag else "uniform"]["h"]
        h = torch.cat([res["out"][tag]["h"] for res in serve])
        if tag == "halo_window q8":
            exact = torch.cat([res["out"]["halo_window table"]["h"]
                               for res in serve])
            rel = ((h - exact).abs().max() / exact.abs().max()).item()
            rf = relfro(h, exact)
            ok = rel <= TOL_SHARDED_Q8[0] and rf <= TOL_SHARDED_Q8[1] \
                and not torch.equal(h, exact)
            print(f"  [sharded serve] q8 against the exact sharded table "
                  f"step: max_abs_err {rel:.3e} of the largest state (tol "
                  f"{TOL_SHARDED_Q8[0]:.3e}), rel_frobenius {rf:.3e} (tol "
                  f"{TOL_SHARDED_Q8[1]:.3e}) {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError("sharded q8 serving off its bound")
            errs = [None] * len(serve)
        else:
            hold(f"[sharded serve] {tag} against single-device propagate",
                 h, ref, *TOL_SHARDED)
            errs = [(res["out"][tag]["h"] - ref[r * n_loc:(r + 1) * n_loc])
                    .abs().max().item() for r, res in enumerate(serve)]
        for r, res in enumerate(serve):
            rank_line("[sharded serve]", r, tag, res["out"][tag], card,
                      errs[r])
    for tag, other in (("halo", "all_gather"), ("halo_overlap", "all_gather"),
                       ("halo_window on-demand", "halo_window table")):
        hold(f"[sharded serve] {tag} against {other}",
             torch.cat([res["out"][tag]["h"] for res in serve]),
             torch.cat([res["out"][other]["h"] for res in serve]),
             TOL_FLIP_MAX, TOL_FLIP_MEAN)
    for tag, names in (("halo_onehot", ("window_block_spmm_mono",)),
                       ("halo_window table", ("node_table_block_major",
                                              "window_step_gru")),
                       ("halo_window unfused", ("node_table_block_major",
                                                "window_block_spmm_mono")),
                       ("halo_window q8", ("node_table_block_major_q8",
                                           "window_step_gru"))):
        must_launch(f"[sharded serve] {tag}", serve[0]["launches"][tag],
                    names)
    check_overlap(serve, card)
    phase_footer("[sharded serve]", serve)


def check_sharded_train(train, refs, card):
    """[sharded train]'s first steps against the single-device ones."""
    for tag, ref, tol in (
            ("halo_onehot", refs["uniform"], TOL_TRAIN["bfloat16"][0]),
            ("halo_window", refs["community"], TOL_TRAIN["bfloat16"][0]),
            ("halo_window grad_quant", refs["community"], TOL_SHARDED_Q8G)):
        err = hold_step(f"[sharded train] {tag}", train[0]["out"][tag], ref,
                        tol, lr=SHARDED_LR)
        for r, res in enumerate(train):
            out = res["out"][tag]
            if not out["same"]:
                raise AssertionError(f"[sharded train] {tag}: rank {r}'s "
                                     "parameters differ from rank 0's")
            rank_line("[sharded train]", r, tag, out, card, err,
                      f", loss {out['loss']:.6f}, parameters bit-equal on "
                      "the ranks")
    must_launch("[sharded train] halo_window",
                train[0]["launches"]["halo_window"],
                ("window_step_gru[emit_res]", "window_bwd_fused",
                 "gru_cell_bwd"))
    check_overlap_bwd(train, card)
    phase_footer("[sharded train]", train)


def check_sharded_ggsnn(gg, refs, card):
    """[sharded ggsnn] and [ddp] (the cell's 64 graphs and DDP_UNEVEN's
    counts) against the single-device steps."""
    ddp = ["ddp", *(f"ddp{n}" for n in DDP_UNEVEN)]
    for tag, phase in (("ggsnn", "[sharded ggsnn]"),
                       *((t, "[ddp]") for t in ddp)):
        err = hold_step(f"{phase} {tag}", gg[0]["out"][tag], refs[tag],
                        TOL_GGSNN)
        for r, res in enumerate(gg):
            out = res["out"][tag]
            if not out["same"]:
                raise AssertionError(f"{phase} {tag}: rank {r}'s parameters "
                                     "differ from rank 0's")
            part = ("" if tag == "ggsnn" else
                    f", {out['graphs']} graphs in {out['slots']} slots of "
                    f"{out['rows']} rows")
            rank_line(phase, r, tag, out, card, err,
                      f", loss {out['loss']:.6f}{part}, parameters "
                      "bit-equal on the ranks")
    for tag in ddp:
        must_launch(f"[ddp] {tag}", gg[0]["launches"][tag],
                    ("typed_block_scatter", "typed_grad_octet_scatter"))
    phase_footer("[sharded ggsnn] and [ddp]", gg)


def nccl_phase(b, ref, card):
    """[sharded nccl]: a world of one rank on NCCL in this process (the
    transport the caller names: nccl, with the device tensors; the
    exchange issued asynchronously on NCCL's stream): one halo and one
    halo_overlap propagate and one node_select task step, each against the
    single-device path; the group is destroyed after."""
    import socket
    import torch
    import torch.distributed as dist
    from ggnn_tpu_torch.parallel import (make_mesh,
                                         make_sharded_task_train_step,
                                         partition_batch, sharded_propagate)
    from ggnn_tpu_torch.parallel.multihost import initialize_multihost
    from ggnn_tpu_torch.parallel.partition import split_local_remote
    from ggnn_tpu_torch.train.loop import make_optimizer
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = None if SHARDED_DEVICE == "cuda" else SHARDED_DEVICE
    initialize_multihost(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=1, process_id=0, init_timeout_s=120,
                         backend=NCCL, device=dev)
    try:
        if dist.get_backend() != NCCL:
            raise AssertionError("[sharded nccl]: not an NCCL group")
        mesh = make_mesh(n_graph=1, device=dev)
        lp = split_local_remote(partition_batch(b, 1)).local(0, mesh.device)
        cfg = sharded_cfg()
        params = sharded_params(cfg)
        for strategy in ("halo", "halo_overlap"):
            def run():
                with torch.inference_mode():
                    return sharded_propagate(params["prop"], cfg, mesh, lp,
                                             strategy=strategy)
            run()
            h, ms, launches = timed(run)
            err = hold(f"[sharded nccl] {strategy} against single-device "
                       "propagate", h.float().cpu(), ref["h"], *TOL_SHARDED)
            rank_line("[sharded nccl]", 0, strategy,
                      dict(ms=ms, launches=launches), card, err)
        targets = {"n_nodes": torch.tensor([NODES], dtype=torch.int32,
                                           device=mesh.device),
                   "node": torch.tensor([node_target()], dtype=torch.int32,
                                        device=mesh.device)}
        opt = make_optimizer(params, SHARDED_LR)
        step = make_sharded_task_train_step(cfg, mesh, opt, 1,
                                            strategy="halo")
        m, ms, launches = timed(lambda: step(params, lp, targets))
        res = dict(loss=float(m["loss_sum"] / m["count"]),
                   grads=flat_grads(params), params=flat_params(params))
        err = hold_step("[sharded nccl] halo node_select step", res, ref,
                        TOL_TRAIN["bfloat16"][0], lr=SHARDED_LR)
        rank_line("[sharded nccl]", 0, "halo train step",
                  dict(ms=ms, launches=launches), card, err)
    finally:
        dist.destroy_process_group()


# --- the edges: [profile], [examples], [distributed example], [dryrun] -------

# The kernels the Trainer CLI with --backend onehot launches at babi4's
# D = 4 (#8 forward, #11 on the legacy grad half), which [profile] finds in
# its trace.
PROFILE_KERNELS = ("onehot_segment_scatter_flat", "window_block_spmm_mono")
# examples/torch_large_graph.py's forms at its defaults (262,144 nodes, 4M
# logical edges, 8 types, D = 128, T = 5, bf16: the headline's NODES,
# EDGES, EDGE_TYPES, DIM, STEPS) and the launches of its
# two forwards (the first and the steady one): the legacy layout and the
# chunks run #8 and the GRU cell; the window layout #11's window form and
# its spill's #11
LARGE_GRAPH_FORMS = {
    "one layout": ({}, {"onehot_segment_scatter_flat": 2 * STEPS,
                        "gru_cell_fwd": 2 * STEPS}),
    "4 chunks": (dict(chunks=4), {"onehot_segment_scatter_flat": 8 * STEPS,
                                  "gru_cell_fwd": 2 * STEPS}),
    "512 communities": (dict(communities=512),
                        {"window_block_spmm_mono": 4 * STEPS,
                         "gru_cell_fwd": 2 * STEPS})}
# The distributed example's train iterations and the custom task's epochs
# (cut from 3 and 60 to make room for [scaling] in the time limit)
DIST_EXAMPLE_ITERS = 1
CUSTOM_TASK_EPOCHS = 20


def repo_file(*parts):
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *parts)


def load_example(name):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", repo_file("examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_kernels(path):
    """{device kernel name: (launches, device µs)} of a Chrome trace that
    ``torch.profiler`` wrote."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            n, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, us + float(e.get("dur", 0.0)))
    return out


def own_kernels(names):
    """The kernels of the port's library among trace kernel names (not
    PyTorch's own, ``at::``)."""
    return {n for n in names if "at::" not in n}


def probe_kernel_names(names, out_dir):
    """{wrapper: the device kernel names it launches on the onehot
    Trainer's path}: babi4's first batch through one train step records
    each wrapper's first call, which then runs again alone under
    ``torch.profiler``."""
    import os
    import torch
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import scatter as S
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.train import Trainer, build_config
    from ggnn_tpu_torch.train.loop import batch_arrays
    from ggnn_tpu_torch.train.metrics import MetricsLogger
    t = Trainer(build_config("babi4", backend="onehot", epochs=1),
                MetricsLogger(echo=False), device="cuda")
    batch = next(t.train_loader.epoch_batches(0))
    wrappers = kernel_wrappers()
    calls, swaps = {}, []

    def recording(name, fn):
        # the wrapper counts its launches on its module's name, the shim
        # while it stands there: it carries the wrapper's attributes
        @functools.wraps(fn)
        def shim(*a, **k):
            calls.setdefault(name, (a, k))
            return fn(*a, **k)
        return shim
    for name in names:
        fn = wrappers[name]
        for mod in (L, S, W):
            if getattr(mod, name, None) is fn:
                swaps.append((mod, name, fn))
                setattr(mod, name, recording(name, fn))
    try:
        t.train_step(t.params, batch_arrays(batch, "cuda"), t._layout(batch))
    finally:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
    out = {}
    for name in names:
        a, k = calls[name]
        wrappers[name](*a, **k)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wrappers[name](*a, **k)
            torch.cuda.synchronize()
        path = os.path.join(out_dir, f"probe_{name}.json")
        prof.export_chrome_trace(path)
        out[name] = own_kernels(trace_kernels(path))
    return out


def profile_phase():
    """[profile]: the Trainer CLI with ``--backend onehot --profile DIR``
    on the card (a child process, 3 epochs of babi4, started with the
    BABI19_RUNS beside it): the trace must exist
    and name the device kernels of #8 and #11, as a probe of each wrapper
    alone on the same path names them; prints the five ops of the most
    device time.  Returns the child's launch counts."""
    import glob
    import os
    import shutil
    out_dir = repo_file(".chip_scratch", "profile")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    try:
        launches = run_trainers(dict(backend="onehot", want=PROFILE_KERNELS,
                                     extra=("--profile", out_dir)),
                                *BABI19_RUNS)[0]
        traces = glob.glob(os.path.join(out_dir, "trace_*.json"))
        if len(traces) != 1:
            raise AssertionError(f"[profile]: {len(traces)} traces in "
                                 f"{out_dir}")
        size = os.path.getsize(traces[0])
        kernels = trace_kernels(traces[0])
        probes = probe_kernel_names(PROFILE_KERNELS, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    total = sum(us for _, us in kernels.values())
    own = own_kernels(kernels)
    print(f"[profile] trace of {size / 2**20:.1f} MiB: {len(kernels)} device "
          f"kernels ({len(own)} of the port's library), {total / 1e3:.2f} ms "
          f"of device time in "
          f"{sum(n for n, _ in kernels.values())} launches; card "
          f"{card_line()}", flush=True)
    for name, (n, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:5]:
        print(f"  {us / 1e3:9.3f} ms in {n:6d} launches: {name[:150]}",
              flush=True)
    for wrapper, names in probes.items():
        if not names:
            raise AssertionError(f"[profile]: {wrapper} alone launched no "
                                 "kernel the trace could name")
        missing = names - set(kernels)
        print(f"[profile] {wrapper} ({launches[wrapper]} launches counted "
              f"by the child) launches {sorted(names)}: "
              f"{'in the trace' if not missing else 'MISSING'}", flush=True)
        if missing:
            raise AssertionError(f"[profile]: the trace does not name "
                                 f"{wrapper}'s kernels {sorted(missing)}")
    # every counted launch shows in the trace (#8 and #11 may share a body:
    # at D = 4 both run the panel kernel)
    both = set().union(*probes.values())
    traced = sum(kernels[k][0] for k in both)
    counted = sum(launches[w] for w in PROFILE_KERNELS)
    print(f"[profile] their kernels' launches in the trace {traced}, the "
          f"wrappers' counted launches {counted}", flush=True)
    if traced < counted:
        raise AssertionError("[profile]: the trace holds fewer launches of "
                             "#8's and #11's kernels than were counted")
    return launches


def examples_phase(log):
    """[examples]: ``examples/torch_large_graph.py`` at its defaults in its
    three forms (one legacy layout, 4 chunks, a window layout over 512
    communities): its printed lines, the launches of its two forwards, and
    its checksum, final h and first step's h against the same calls with
    the kernels' plain versions on the card ('flip': the served-score
    tolerance; the checksum within TOL_FLIP_MEAN per element, the bound the
    mean error puts on a sum); then ``examples/torch_custom_task.py`` on
    the card.  Returns the launches."""
    import torch
    LG = load_example("torch_large_graph")
    launched = dict.fromkeys(KERNELS, 0)
    cdt = torch.bfloat16
    for form, (kw, want) in LARGE_GRAPH_FORMS.items():
        tag = f"[examples] large_graph, {form}"
        g = LG.prepare(nodes=NODES, edges=EDGES, types=EDGE_TYPES, dim=DIM,
                       steps=STEPS, device="cuda",
                       log=lambda m: print(f"{tag}: {m}"), **kw)
        torch.cuda.synchronize()
        zero_counts()
        res = LG.measure(g, log=lambda m: print(f"{tag}: {m}"))
        launches = read_counts()
        expect_counts(tag, launches, want)
        for k, v in launches.items():
            launched[k] += v
        with plain_versions():
            h_ref = LG.forward(g)
        check(f"{tag} h", res["h"], h_ref, "flip", cdt, {})
        ref_sum = float(h_ref.double().sum())
        tol = TOL_FLIP_MEAN * h_ref.numel()
        print(f"  {tag} checksum {res['checksum']:.6e} against the plain "
              f"path's {ref_sum:.6e} (tol {tol:.3e})", flush=True)
        if abs(res["checksum"] - ref_sum) > tol:
            raise AssertionError(f"{tag}: checksum over tolerance")
        h1 = LG.forward(g, n_steps=1)
        with plain_versions():
            h1_ref = LG.forward(g, n_steps=1)
        check(f"{tag} first step", h1, h1_ref, "flip", cdt, {})
        print(f"{tag}: layout {res['build_s']:.2f} s on the host, first run "
              f"{res['first_s']:.3f} s, steady {res['steady_ms']:.2f} ms "
              f"({res['edges_per_s']:.4e} edges/s); launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        del g, res, h_ref, h1, h1_ref
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    CT = load_example("torch_custom_task")
    res = CT.run("cuda", epochs=CUSTOM_TASK_EPOCHS,
                 log=lambda m: print(f"[examples] custom_task: {m}"))
    accs = list(res["accuracies"].values())
    if not all(0.0 <= a <= 1.0 for a in accs) or not np.isfinite(
            res["losses"]).all():
        raise AssertionError("[examples] custom_task: bad losses or "
                             "accuracies")
    print(f"[examples] custom_task: {len(res['losses'])} steps in "
          f"{time.perf_counter() - t0:.1f} s, accuracies {accs}", flush=True)
    return launched


def rank_dist_example(mesh, state):
    """[distributed example] on this rank: the example's stages
    (examples/torch_distributed_production.py: partition, halo_window
    training on grad layouts, q8 serving under ``torch.no_grad``) at D =
    128 on the community headline's scale (262,144 nodes, 4M logical / 8M
    directed edges, the example's P communities, 90 % inside), each
    stage's launches counted."""
    import torch
    EX = load_example("torch_distributed_production")
    dev = None if SHARDED_DEVICE == "cuda" else SHARDED_DEVICE
    log = (lambda m: print(f"[distributed example] rank 0: {m}",
                           flush=True)) if mesh.rank == 0 else (
        lambda m: None)
    out, runs = {"host_s": {}}, {}
    t0 = time.perf_counter()
    st = EX.setup(nodes=NODES, edges=EDGES, dim=DIM, device=dev, log=log)
    out["host_s"]["batch, partition and train layouts"] = \
        time.perf_counter() - t0
    losses, ms, launches = timed(
        lambda: EX.train(st, DIST_EXAMPLE_ITERS, log))
    runs["train"] = dict(losses=np.asarray(losses), ms=ms,
                         launches=launches,
                         same=params_same_on_ranks(st["prop"],
                                                   st["mesh"].group))
    t0 = time.perf_counter()
    h, ms, launches = timed(lambda: EX.serve(st, log))
    runs["serve"] = dict(ms=ms, launches=launches,
                         finite=bool(torch.isfinite(h).all()),
                         shape=tuple(h.shape), wall_s=time.perf_counter() - t0)
    return with_runs(out, runs)


def check_dist_example(results, card):
    """[distributed example]'s checks: finite losses, the same on both
    ranks, the parameters bit-equal, finite served h, no ``emit_res``
    launch while serving."""
    for r, res in enumerate(results):
        tr, sv = res["out"]["train"], res["out"]["serve"]
        print(f"[distributed example] rank {r}: {DIST_EXAMPLE_ITERS} train "
              f"iterations {tr['ms']:.1f} ms, losses "
              f"{[float(x) for x in tr['losses']]}, "
              f"launches { {k: v for k, v in tr['launches'].items() if v} };"
              f" q8 serving {sv['ms']:.1f} ms (its layouts included), h "
              f"{sv['shape']}, launches "
              f"{ {k: v for k, v in sv['launches'].items() if v} }; card "
              f"{card}", flush=True)
        if not np.isfinite(tr["losses"]).all() or not sv["finite"]:
            raise AssertionError(f"[distributed example] rank {r}: "
                                 "non-finite losses or h")
        if not tr["same"]:
            raise AssertionError(f"[distributed example] rank {r}: the "
                                 "parameters differ between the ranks")
        if sv["launches"]["window_step_gru[emit_res]"]:
            raise AssertionError("[distributed example]: serving launched "
                                 "#13's emit_res form")
        must_launch(f"[distributed example] rank {r} serve", sv["launches"],
                    ("window_step_gru", "node_table_block_major_q8"))
    if not np.array_equal(results[0]["out"]["train"]["losses"],
                          results[1]["out"]["train"]["losses"]):
        raise AssertionError("[distributed example]: the ranks' losses "
                             "differ")
    phase_footer("[distributed example]", results)


def dist_example_entry():
    """The example's real entry, ``python -m torch.distributed.run
    --nproc_per_node 2 examples/torch_distributed_production.py`` at its
    default size (a child job on this card over gloo)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
           "--master_port", str(port),
           repo_file("examples", "torch_distributed_production.py")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    lines = res.stdout.strip().splitlines()
    print(f"[distributed example] torchrun --nproc_per_node 2 (rc "
          f"{res.returncode}, {time.perf_counter() - t0:.1f} s):", flush=True)
    for line in lines:
        print(f"  {line}", flush=True)
    if res.returncode != 0 or not lines or \
            not lines[-1].startswith("served h: (4096, 128)"):
        raise AssertionError(f"[distributed example] torchrun failed:\n"
                             f"{res.stderr[-4000:]}")


def dist_example_phase():
    """[distributed example]: the example's body on two ranks on cuda:0
    over gloo at the community headline's scale (its real entry through
    torchrun runs beside [dryrun]).  Returns the ranks' launches."""
    launched = dict.fromkeys(KERNELS, 0)
    card = card_line()

    def on_phase(name, results):
        for res in results:
            for launches in res["launches"].values():
                for k, v in launches.items():
                    launched[k] += v
        check_dist_example(results, card)

    run_ranks(on_phase, phases=(("[distributed example]",
                                 rank_dist_example),))
    return launched


def dryrun_phase(beside=None):
    """[dryrun]: ``ggnn_tpu_torch.dryrun.entry("cuda")``'s forward against
    its plain run (the flagship forward is the xla backend in f32: it
    launches no kernel, so the two are one path and must agree within
    TOL_F32), then ``dryrun_multichip(2)`` and ``(3)`` on the card (two
    and three spawned ranks on cuda:0 over gloo, the package's own entry;
    their launches are not counted here), each on the reference's batch of
    4 graphs (halo shape (8n, 8); at n = 3 the data-parallel parts hold 2,
    1 and 1 graphs), and :func:`empty_slot_check`; ``beside()`` (another
    small check) runs with the two dry runs, at once."""
    import torch
    from ggnn_tpu_torch import dryrun
    fn, args = dryrun.entry("cuda")
    zero_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    launches = read_counts()
    with plain_versions():
        ref = fn(*args)
    check("[dryrun] entry forward", out, ref, "flip", torch.float32, {})
    expect_counts("[dryrun] entry", launches, {})
    print(f"[dryrun] entry forward {tuple(out.shape)}: finite, no kernel "
          "launched (xla, f32)", flush=True)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        # both worlds at once: their ranks' start-up dominates, the card
        # is mostly idle at these shapes
        runs = {n: ex.submit(dryrun.dryrun_multichip, n) for n in (2, 3)}
        other = None if beside is None else ex.submit(beside)
        results = {n: f.result() for n, f in runs.items()}
        if other is not None:
            other.result()
    for n, res in results.items():
        if any(r != res[0] for r in res[1:]) or not all(
                np.isfinite(res[0][k]) for k in (
                    "train_loss_sum", "window_train_loss_sum",
                    "ggsnn_train_loss_sum")) or not res[0]["q8_finite"]:
            raise AssertionError(f"[dryrun] the ranks disagree or a loss is "
                                 f"not finite: {res}")
        # the reference's batch: 4 graphs of 2n nodes
        if res[0]["halo_shape"] != (8 * n, 8):
            raise AssertionError(f"[dryrun] dryrun_multichip({n}): halo "
                                 f"shape {res[0]['halo_shape']}, the "
                                 f"reference's is {(8 * n, 8)}")
        print(f"[dryrun] dryrun_multichip({n}) on the card (2 and 3 at "
              f"once, {time.perf_counter() - t0:.1f} s): {res[0]}",
              flush=True)
    empty_slot_check()


def empty_slot_check():
    """node_select's loss on the card on a batch whose one graph of 128
    nodes fills ``n_pad`` and whose second slot is empty (its node offset
    one past the last row), against the same call on the CPU: the loss
    within 1e-5, ``correct`` and ``count`` equal (xla, f32: no kernel)."""
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.models.api import loss_and_metrics
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params, params_from_numpy
    from ggnn_tpu_torch.train.loop import batch_arrays
    r = np.random.default_rng(0)
    n, m = 128, 384
    graph = dict(n_nodes=n, edges=np.stack([
        r.integers(0, n, m), r.integers(0, 3, m), r.integers(0, n, m)], 1),
        annotations=(r.random((n, 2)) < 0.4).astype(np.float32),
        targets={"node": np.asarray(int(r.integers(0, n)), np.int32)})
    batch = batch_graphs([graph], PaddingSpec(
        n_graphs=2, n_pad=n, e_pad=2 * m, n_edge_types=3, annotation_dim=2))
    cfg = ModelConfig(state_dim=8, annotation_dim=2, n_edge_types=3,
                      n_steps=3, head="node_select")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    got = {}
    zero_counts()
    for dev in ("cuda", "cpu"):
        with torch.no_grad():
            loss, met = loss_and_metrics(params_from_numpy(params, dev), cfg,
                                         batch_arrays(batch, dev), 2)
        got[dev] = [loss.item(), met["correct"].item(), met["count"].item()]
    expect_counts("[dryrun] node_select, empty slot", read_counts(), {})
    (lc, cc, nc), (lh, ch, nh) = got["cuda"], got["cpu"]
    ok = abs(lc - lh) <= 1e-5 * abs(lh) and (cc, nc) == (ch, nh) \
        and np.isfinite(lc)
    print(f"[dryrun] node_select on one graph of {n} nodes filling n_pad "
          f"{n} and an empty slot: loss {lc:.7f} on the card, {lh:.7f} on "
          f"the CPU (tol 1e-5 relative), correct {cc:.0f} / {ch:.0f}, count "
          f"{nc:.0f} / {nh:.0f} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("[dryrun] node_select's loss on an empty slot "
                             "differs between the card and the CPU")


# --- [segment rows], [reproducible], [oracle] --------------------------------

# segment_rows_sum against its plain version (f64 sums, rounded once): the
# kernel adds each row's terms in f32 in the plan's order, so each element
# within 2e-5·Σ|terms| of it (as #7 and #11 are held, 'bound'), the mean
# within TOL_BOUND_MEAN of that; f64 values within 1e-12·Σ|terms|.
SEG_BOUND = {"float32": 2e-5, "float64": 1e-12}
# The seams of its plan: (name, entries, n_rows, D, dtype, ids) with ids
# 'uniform' (every row about entries / n_rows terms), 'sparse' (terms in a
# few rows, most rows empty), 'padding' (a third of the ids ≥ n_rows or
# negative: dropped), 'one_row' (every entry in row 0: cut into chunks of
# SPLIT, their partials added in chunk order), 'zipf' (hub rows).
SEG_SEAMS = (("empty rows", 50_000, 100_003, 128, "float32", "sparse"),
             ("padding ids", 200_000, 30_011, 130, "float32", "padding"),
             ("one row of 1,000,192", 1_000_192, 1, 1, "float64", "one_row"),
             ("one row of 1,000,192", 1_000_192, 1, 128, "float32",
              "one_row"),
             ("n_rows 262,147", 3_000_000, 262_147, 7, "float32", "uniform"),
             ("n_rows 262,147", 3_000_000, 262_147, 2, "float64", "uniform"),
             ("zipf hubs", 2_000_000, 65_537, 128, "float32", "zipf"))


def seam_ids(kind, n, n_rows, r):
    """The segment ids of a seam case, on the card."""
    import torch
    if kind == "sparse":
        ids = r.choice(r.integers(0, n_rows, 40), n)
    elif kind == "padding":
        ids = r.integers(0, n_rows, n)
        drop = r.random(n) < 1 / 3
        ids[drop] = r.choice([-1, n_rows, n_rows + 5], int(drop.sum()))
    elif kind == "one_row":
        ids = np.zeros(n, np.int64)
    elif kind == "zipf":
        ids = np.minimum(r.zipf(ZIPF, n) - 1, n_rows - 1)
    else:
        ids = r.integers(0, n_rows, n)
    return torch.tensor(ids, dtype=torch.int32, device="cuda")


def check_segment_rows(name, vals, seg, n_rows, log):
    """The kernel twice (bit-equal) against its plain version, per element
    within SEG_BOUND·Σ|terms|."""
    import torch
    from ggnn_tpu_torch.ops import segment_rows as SR
    got = SR.segment_rows_sum(vals, seg, n_rows)
    same_twice("segment_rows_sum", name, got,
               SR.segment_rows_sum(vals, seg, n_rows))
    ref = SR.segment_rows_sum_reference(vals, seg, n_rows)
    mag = SR.segment_rows_sum_reference(vals.abs(), seg, n_rows)
    bound = SEG_BOUND[str(vals.dtype).split(".")[1]] * mag.double() + 1e-30
    check(f"segment_rows_sum[{name}]", got.double(), ref.double(), "bound",
          vals.dtype, log, bound=bound)
    return got


def segment_rows_phase(b, log, timings):
    """[segment rows]: the port's fixed-order segment sum (csrc/
    segment_rows.cu) at the xla headline's shapes: the f32 messages [8M,
    128] of the uniform batch summed by its edge_dst (ScatterRows of the
    xla backend), then the same sum of the pallas layout's packed messages
    (TypedTiled's forward sum), each against its plain version, twice
    bit-equal, timed (kernel, plain version, the f32 ``index_add_`` it
    replaces: the library call; a new index tensor's first call, its plan
    included); then the seams of SEG_SEAMS."""
    import torch
    from ggnn_tpu_torch.ops import segment_rows as SR
    from ggnn_tpu_torch.ops import spmm as SP
    gen = torch.Generator(device="cuda").manual_seed(21)
    dst = torch.as_tensor(b.edge_dst, device="cuda")
    vals = torch.randn(dst.shape[0], DIM, generator=gen, device="cuda")
    check_segment_rows("headline", vals, dst, NODES, log)
    plan = SR.segment_rows_plan(dst, NODES)
    print(f"  segment_rows_sum[headline]: {dst.shape[0]} entries into "
          f"{NODES} rows, {plan['n_items']} work items, {plan['n_split']} "
          f"rows cut into {plan['n_ws']} chunks", flush=True)
    out_b = NODES * DIM * 4
    bound = roofline(nbytes(vals, plan["order"], plan["items"]) + out_b,
                     [(vals.numel(), F32_FLOPS)])

    def library():
        return torch.zeros(NODES, DIM, device="cuda").index_add_(
            0, dst.long(), vals)
    time_pairs({"segment_rows_sum": (
        lambda: SR.segment_rows_sum(vals, dst, NODES),
        lambda: SR.segment_rows_sum_reference(vals, dst, NODES),
        library, bound)}, timings, what="f32 xla headline (ScatterRows)")

    def first_call():
        return SR.segment_rows_sum(vals, dst.clone(), NODES)
    first = [cuda_ms(first_call, 1) for _ in range(3)]
    print(f"  segment_rows_sum[headline]: a new index tensor's first call, "
          f"its plan included, {min(first):.3f} ms ({first})", flush=True)

    typ = torch.as_tensor(b.edge_type, device="cuda")
    mask = torch.as_tensor(b.edge_mask, device="cuda")
    lay = SP.pack_type_tiles(
        torch.as_tensor(b.edge_src, device="cuda"), dst, typ, mask,
        torch.as_tensor(b.type_offsets, device="cuda"), 2 * EDGE_TYPES)
    msgs = torch.randn(lay["dst"].shape[0], DIM, generator=gen, device="cuda")
    check_segment_rows("pallas headline", msgs, lay["dst"], NODES, log)
    t = {}
    time_pairs({"typed_tiled_sum": (
        lambda: SR.segment_rows_sum(msgs, lay["dst"], NODES),
        lambda: SR.segment_rows_sum_reference(msgs, lay["dst"], NODES),
        lambda: torch.zeros(NODES, DIM, device="cuda").index_add_(
            0, lay["dst"].long(), msgs),
        roofline(nbytes(msgs) + out_b, [(msgs.numel(), F32_FLOPS)]))},
        t, what="TypedTiled's forward sum, f32 pallas headline")
    del vals, msgs, lay
    r = np.random.default_rng(22)
    for name, n, n_rows, D, dt, kind in SEG_SEAMS:
        seg = seam_ids(kind, n, n_rows, r)
        v = torch.randn(n, D, generator=gen, device="cuda",
                        dtype=getattr(torch, dt))
        check_segment_rows(f"{name} D={D} {dt}", v, seg, n_rows, log)
    torch.cuda.empty_cache()


def host_tree(tree):
    """A tree of tensors (dicts, lists, tuples) as numpy on the host (bf16
    as f32, exactly)."""
    import torch
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_tree(v) for v in tree]
    if torch.is_tensor(tree):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def bit_equal(a, b) -> bool:
    """Two host trees (of :func:`host_tree`) hold the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bit_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(bit_equal(x, y)
                                        for x, y in zip(a, b))
    bits = [np.ascontiguousarray(x).reshape(-1).view(np.uint8)
            for x in (a, b)]
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(*bits))


def repro_case(results, tag, run, strict):
    """Run ``run()`` (a tree of tensors) twice from the same state; records
    whether both runs hold the same bits, and raises on a difference when
    ``strict``."""
    import torch
    first = host_tree(run())
    torch.cuda.synchronize()
    same = bit_equal(first, host_tree(run()))
    results[tag] = same
    print(f"[reproducible] {tag}: two runs "
          f"{'bit-equal' if same else 'DIFFER'}", flush=True)
    if strict and not same:
        raise AssertionError(f"[reproducible] {tag}: two runs differ")


def repro_train_step(cfg, batch, targets, n_graphs, layout=None):
    """One Adam step from the headline's seed-0 parameters: (loss, every
    gradient leaf, the updated parameters, Adam's moments)."""
    import torch
    from ggnn_tpu_torch.train.checkpoint import _flatten
    from ggnn_tpu_torch.train.loop import (batch_arrays, make_optimizer,
                                           make_train_step)
    arrays = batch_arrays(batch, "cuda")
    arrays["targets"] = targets
    params = fresh_params(cfg)
    opt = make_optimizer(params, 1e-3)
    m = make_train_step(cfg, n_graphs, opt)(params, arrays, layout)
    flat = dict(_flatten(params))
    return {"loss": m["loss_sum"],
            "grads": {k: p.grad for k, p in flat.items()},
            "params": {k: p.detach() for k, p in flat.items()},
            "adam": {k: [opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"]]
                     for k, p in flat.items()}}


def repro_trainer(results, strict):
    """The bAbI 4 Trainer on the card (its default xla backend): 3 epochs,
    save, 3 more; a second Trainer restores the checkpoint and trains 3
    more: every leaf and Adam's state must match the uninterrupted run bit
    for bit (tests/test_torch_train_loop.py's CPU check)."""
    import tempfile
    import torch
    from ggnn_tpu_torch.train import Trainer, build_config
    from ggnn_tpu_torch.train.loop import param_leaves
    from ggnn_tpu_torch.train.metrics import MetricsLogger
    cfg = build_config("babi4", epochs=6)
    t0 = time.perf_counter()
    t1 = Trainer(cfg, MetricsLogger(echo=False), device="cuda")
    with tempfile.TemporaryDirectory() as d:
        for _ in range(3):
            t1.train_epoch()
        ckpt = f"{d}/resume.npz"
        t1.save(ckpt)
        for _ in range(3):
            t1.train_epoch()
        t2 = Trainer(cfg, MetricsLogger(echo=False), device="cuda")
        t2.restore(ckpt)
        for _ in range(3):
            t2.train_epoch()
    same = True
    for a, b in zip(param_leaves(t1.params), param_leaves(t2.params)):
        s1, s2 = t1.optimizer.state[a], t2.optimizer.state[b]
        same &= (torch.equal(a, b) and torch.equal(s1["exp_avg"],
                                                   s2["exp_avg"])
                 and torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
                 and float(s1["step"]) == float(s2["step"]))
    results["babi4 Trainer resume"] = bool(same)
    print(f"[reproducible] babi4 Trainer (xla, the card): 3 epochs, save, 3 "
          f"more; restored and 3 more: every leaf and Adam's state "
          f"{'bit-equal' if same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if strict and not same:
        raise AssertionError("[reproducible] the resumed run left the "
                             "uninterrupted one")


def reproducible_phase(b, strict=True, count=True):
    """[reproducible]: each case twice from the same state, every output,
    loss, gradient leaf and Adam moment bit-equal: one headline request
    (``Predictor.run_batch`` of the uniform batch ``b``) through xla, pallas
    with the edge gates and the graph_gated head (xla); the GGS-NN cell's
    64 graphs through pallas (outputs and annotations of its 3 rounds);
    one train step each through xla and gated pallas; then the bAbI 4
    Trainer's resume (:func:`repro_trainer`).  The sharded halo requests
    run in the ranks (:func:`rank_reproducible`).  ``strict`` raises on a
    difference (a parent tree's run records them); ``count`` reads the
    launch counts (the segment sum must run on these paths).  Returns
    (results, launches)."""
    import dataclasses
    import torch
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    from ggnn_tpu_torch.infer import Predictor
    from ggnn_tpu_torch.models.ggsnn import ggsnn_forward
    from ggnn_tpu_torch.train.loop import batch_arrays
    results = {}
    if count:
        zero_counts()
    spec = PaddingSpec(n_graphs=1, n_pad=NODES, e_pad=2 * EDGES,
                       n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    for tag, kw, head in (
            ("xla request", dict(backend="xla"), "node_select"),
            ("pallas gated request", dict(backend="pallas", edge_gates=True),
             "node_select"),
            ("graph_gated request (xla)", dict(backend="xla"),
             "graph_gated")):
        cfg = dataclasses.replace(
            headline_cfg(compute_dtype="bfloat16", **kw), head=head,
            n_classes=4 if head == "graph_gated" else 1)
        pred = Predictor(cfg, spec, params=fresh_params(cfg), device="cuda")
        with torch.no_grad():
            repro_case(results, tag, lambda: torch.as_tensor(
                pred.run_batch(b)), strict)
        del pred
    cfg = ggsnn_cfg(backend="pallas")
    gspec = PaddingSpec(n_graphs=GGSNN_GRAPHS, n_pad=NODES, e_pad=2 * EDGES,
                        n_edge_types=EDGE_TYPES, annotation_dim=ANN)
    arrays = batch_arrays(batch_graphs(ggsnn_graphs(0), gspec), "cuda")
    params = fresh_params(cfg)

    def ggsnn():
        with torch.no_grad():
            return ggsnn_forward(
                params, cfg, arrays["annotations"], arrays["node_graph"],
                arrays["node_mask"], arrays["edge_src"], arrays["edge_dst"],
                arrays["edge_type"], arrays["edge_mask"],
                n_graphs=GGSNN_GRAPHS, type_offsets=arrays["type_offsets"])
    repro_case(results, "pallas GGS-NN request (64 graphs)", ggsnn, strict)
    del arrays, params
    target = {"node": torch.tensor([node_target()], dtype=torch.int32,
                                   device="cuda")}
    for tag, kw in (("xla train step", dict(backend="xla")),
                    ("gated pallas train step", dict(backend="pallas",
                                                     edge_gates=True))):
        cfg = headline_cfg(compute_dtype="bfloat16", **kw)
        repro_case(results, tag,
                   lambda: repro_train_step(cfg, b, target, 1), strict)
        torch.cuda.empty_cache()
    repro_trainer(results, strict)
    launches = read_counts() if count else {}
    if count and not launches["segment_rows_sum"]:
        raise AssertionError("[reproducible]: segment_rows_sum was never "
                             "launched on these paths")
    print(f"[reproducible] {sum(results.values())} of {len(results)} cases "
          f"bit-equal; launches {launches}", flush=True)
    return results, launches


# The [oracle] phase: the port's NumPy oracle (ggnn_tpu_torch/oracle) in
# f64 on the host against the card's outputs.  Its graphs: 24 fuzz graphs
# of 2 to 13 nodes (tests/test_fuzz_parity.py's generator; each with a self
# loop and a duplicate edge, edge types 2 and 3 never drawn, its last node
# isolated) in one batch of 512 rows, and one graph of 4,096 nodes and
# 8,000 logical edges, 800 of them into node 7 (a hub); D = 128 (the
# kernels' width), 4 edge types, T = 3 steps, K = 3 GGS-NN rounds.
# Tolerances, |card − oracle|:
# - f32 on the fuzz graphs: tests/test_oracle_parity.py's rtol 2e-5, atol
#   2e-6 per element (GGS-NN 3e-5, 3e-6);
# - f32 on the hub graph, whose hub sums 800 messages a step in f32 and
#   whose state every neighbour reads in the next step: the bounds the
#   card's f32 paths are held to against their plain versions, max ≤
#   TOL_F32·max(1, max|oracle|) and the relative Frobenius error ≤
#   TOL_RELF_F32;
# - bf16: the card rounds h, W and the messages to bf16 at every step (and
#   a, before the gate matmuls), the oracle nothing.  The states are held
#   as [serve] holds a hub's rows ('flip_rows'): each row within
#   TOL_FLIP_MAX (8 bf16 ulps at 1.0) times max(1, max|a_row|) over the
#   steps (the oracle's aggregation), the relative Frobenius error within
#   TOL_TRAIN's bf16 bound (2**-6); the node heads within TOL_FLIP_MAX
#   times max(1, max|oracle|) and 2**-6; a graph's outputs (graph_gated,
#   and GGS-NN's K rounds, outputs and annotations), which sum every
#   node's rounding, within TOL_GGSNN (2**-4) relative Frobenius and
#   TOL_FLIP_MAX times max(1, max|oracle|) (the CPU's plain versions read
#   at most 7.5e-3 relative Frobenius there);
# - q8 (the int8 table): the q8 serving bound TOL_SHARDED_Q8 in place of
#   TOL_FLIP_MAX and the relative Frobenius bound, its states' rows scaled
#   by max(1, max|a_row|) as in bf16 (the hub's quantization step grows with
#   its |a| as its rounding does).
ORACLE_E, ORACLE_A, ORACLE_T, ORACLE_K = 4, 2, 3, 3
ORACLE_F32 = (2e-5, 2e-6)
ORACLE_F32_GGSNN = (3e-5, 3e-6)
ORACLE_HEADS = ("node_select", "per_node", "graph_gated", "ggsnn_graph",
                "ggsnn_node")


def oracle_fuzz_graphs(seed=0, n_graphs=24):
    """tests/test_fuzz_parity.py's random graphs, each with a self loop and
    a duplicate edge, edge types 0 and 1 only (2 and 3 empty), and its last
    node isolated."""
    r = np.random.default_rng(1000 + seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(r.integers(2, 14))
        m = int(r.integers(2, 3 * n))
        edges = np.stack([r.integers(0, n - 1, m), r.integers(0, 2, m),
                          r.integers(0, n - 1, m)], axis=1)
        edges[0, 2] = edges[0, 0]
        edges[1] = edges[0]
        ann = (r.random((n, ORACLE_A)) < r.random()).astype(np.float32)
        graphs.append(dict(n_nodes=n, edges=edges, annotations=ann,
                           targets={}))
    return graphs


def oracle_hub_graph(seed=0, n=4096, m=8_000, hub=7, into_hub=800):
    """One graph of ``n`` nodes and ``m`` logical edges, ``into_hub`` of
    them into node ``hub``."""
    r = np.random.default_rng(seed)
    dst = r.integers(0, n, m)
    dst[r.choice(m, into_hub, replace=False)] = hub
    edges = np.stack([r.integers(0, n, m), r.integers(0, ORACLE_E, m), dst],
                     axis=1)
    ann = (r.random((n, ORACLE_A)) < 0.3).astype(np.float32)
    return [dict(n_nodes=n, edges=edges, annotations=ann, targets={})]


def oracle_batch(graphs, n_pad):
    from ggnn_tpu_torch.graph import PaddingSpec, batch_graphs
    spec = PaddingSpec(n_graphs=len(graphs), n_pad=n_pad,
                       e_pad=2 * sum(g["edges"].shape[0] for g in graphs) + 8,
                       n_edge_types=ORACLE_E, annotation_dim=ORACLE_A
                       ).round_up(mult_nodes=128)
    return batch_graphs(graphs, spec)


def oracle_cfg(head, **kw):
    """The phase's model with head ``head`` (ORACLE_HEADS' names)."""
    from ggnn_tpu_torch.models.config import ModelConfig
    ggsnn = head.startswith("ggsnn")
    return ModelConfig(
        state_dim=DIM, annotation_dim=ORACLE_A, n_edge_types=ORACLE_E,
        n_steps=ORACLE_T, head="ggsnn" if ggsnn else head, n_classes=4,
        n_rounds=ORACLE_K, ggsnn_output=head[6:] if ggsnn else "graph", **kw)


def oracle_refs(graphs, p64, head, propagated=None):
    """The oracle per graph: (the states [h^(1) … h^(T+1)], each row's
    largest |a| over the steps, the head's output); GGS-NN: (None, None,
    (round outputs, annotations X^(2) …)).  ``propagated`` (states and
    a_rows per graph, keyed by the bytes of ``p64["prop"]``) is filled and
    reused: the node heads share their propagation parameters."""
    from ggnn_tpu_torch import oracle as O
    from ggnn_tpu_torch.oracle.numpy_ggnn import aggregate, directed_edges
    refs = []
    prop = p64["prop"]
    key = b"".join(np.ascontiguousarray(v).tobytes() for v in
                   tree_leaves(prop))
    known = (propagated if propagated is not None else {}).setdefault(
        key, {})
    for gi, g in enumerate(graphs):
        x = g["annotations"].astype(np.float64)
        if head.startswith("ggsnn"):
            outs, _, anns = O.oracle_ggsnn(p64, x, g["edges"], ORACLE_E,
                                           ORACLE_T, ORACLE_K,
                                           output=head[6:])
            refs.append((None, None, (outs, anns[1:])))
            continue
        if gi not in known:
            states = O.oracle_propagate(prop, x, g["edges"], ORACLE_E,
                                        ORACLE_T)
            de = directed_edges(g["edges"], ORACLE_E)
            known[gi] = states, np.max(
                [np.abs(aggregate(h, de, prop["msg_w"], prop["msg_b"],
                                  prop.get("gate_p"),
                                  prop.get("gate_q"))).max(1)
                 for h in states[:-1]], axis=0)
        states, a_rows = known[gi]
        out = {"node_select": O.oracle_node_select,
               "per_node": O.oracle_per_node,
               "graph_gated": O.oracle_graph_gated}[head](
                   p64["head"], states[-1], x)
        refs.append((states, a_rows, out))
    return refs


def tree_leaves(tree):
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def oracle_hold(tag, got, ref, dtype, results, kind, hub=False, a_rows=None,
                q8=False):
    """|got − ref| within the phase's tolerance for ``dtype`` and ``kind``
    ('states' with each row's ``a_rows``, 'node', 'graph', 'ggsnn'); keeps
    the worst ratio to it, the max and mean error and the relative
    Frobenius error under ``tag``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"[oracle] {tag}: shape {got.shape} vs "
                             f"{ref.shape} or non-finite")
    d = np.abs(got - ref)
    emax = float(d.max(initial=0.0))
    top = max(1.0, float(np.abs(ref).max(initial=0.0)))
    rf = float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))
    if dtype == "bfloat16":
        tol, relf = ((TOL_SHARDED_Q8[0], TOL_SHARDED_Q8[1]) if q8 else
                     (TOL_FLIP_MAX, TOL_GGSNN if kind in ("graph", "ggsnn")
                      else TOL_TRAIN[dtype][0]))
        if kind == "states":
            rows = d.reshape(d.shape[0], -1).max(1, initial=0.0)
            ratio = float((rows / (tol * np.maximum(1.0, a_rows))
                           ).max(initial=0.0))
        else:
            ratio = emax / (tol * top)
        ratio = max(ratio, rf / relf)
    elif hub:
        ratio = max(emax / (TOL_F32 * top), rf / TOL_RELF_F32)
    else:
        rtol, atol = ORACLE_F32_GGSNN if kind == "ggsnn" else ORACLE_F32
        ratio = float((d / (atol + rtol * np.abs(ref))).max(initial=0.0))
    prev = results.get(tag, (0.0, 0.0, 0.0, 0.0))
    results[tag] = (max(prev[0], ratio), max(prev[1], emax),
                    max(prev[2], float(d.mean()) if d.size else 0.0),
                    max(prev[3], rf))


def oracle_run(cfg, params, b, layout):
    """The card's outputs on batch ``b``: (the per-step states [T, N, D],
    the head's outputs); GGS-NN: (None, (outputs, annotations))."""
    import torch
    from ggnn_tpu_torch.models.api import forward
    from ggnn_tpu_torch.models.ggnn import propagate
    from ggnn_tpu_torch.models.ggsnn import ggsnn_forward
    from ggnn_tpu_torch.train.loop import batch_arrays
    arrays = batch_arrays(b, "cuda")
    with torch.no_grad():
        if cfg.head == "ggsnn":
            out = ggsnn_forward(
                params, cfg, arrays["annotations"], arrays["node_graph"],
                arrays["node_mask"], arrays["edge_src"], arrays["edge_dst"],
                arrays["edge_type"], arrays["edge_mask"],
                n_graphs=b.spec.n_graphs, type_offsets=arrays["type_offsets"],
                scatter_layout=layout)
            return None, tuple(x.float().cpu().numpy() for x in out)
        _, states = propagate(
            params["prop"], cfg, arrays["annotations"], arrays["edge_src"],
            arrays["edge_dst"], arrays["edge_type"], arrays["edge_mask"],
            collect_states=True, type_offsets=arrays["type_offsets"],
            scatter_layout=layout)
        out = forward(params, cfg, arrays, b.spec.n_graphs,
                      scatter_layout=layout)
    return states.float().cpu().numpy(), out.float().cpu().numpy()


def oracle_layout(kind, b):
    """The layout of a path's ``kind`` for batch ``b``, on the card."""
    from ggnn_tpu_torch.ops import legacy as L
    from ggnn_tpu_torch.ops import window as W
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    args = (b.edge_src, b.edge_dst, b.edge_type, b.edge_mask, b.spec.n_pad)
    if kind in ("typed block", "per-tile"):
        return build_typed_dst_layout(
            *args, 2 * ORACLE_E,
            block_mode="auto" if kind == "typed block" else False).to("cuda")
    if kind == "legacy":
        return L.layout_for_batch(b, device="cuda")
    return W.build_window_layout(
        *args, window=8 * 128, min_edges_per_tile=4,
        n_message_types=2 * ORACLE_E, block_rows=128, typed_spill=True,
        on_demand=kind == "window on-demand", row_major="block").to("cuda")


# (path, config, the layout's kind, the kernels it must launch)
ORACLE_PATHS = (
    ("xla", dict(backend="xla"), None, ("segment_rows_sum",)),
    ("pallas", dict(backend="pallas"), None, ("packed_messages",)),
    ("pallas gated", dict(backend="pallas", edge_gates=True), None,
     ("packed_messages", "sddmm_pallas")),
    ("onehot typed block", dict(backend="onehot", fuse_gru=True),
     "typed block", ("typed_block_step_gru",)),
    ("onehot per-tile", dict(backend="onehot", fuse_gru=True), "per-tile",
     ("typed_step_gru",)),
    ("onehot legacy", dict(backend="onehot"), "legacy",
     ("node_table_block_major", "onehot_segment_scatter_flat")),
    ("window table", dict(backend="window", fuse_gru=True), "window table",
     ("window_step_gru",)),
    ("window on-demand", dict(backend="window", fuse_gru=True),
     "window on-demand", ("window_step_gru",)),
    ("window q8", dict(backend="window", fuse_gru=True,
                       quantized_table=True), "window table",
     ("node_table_block_major_q8",)),
)
# the paths that also run every head, and GGS-NN (both outputs)
ORACLE_HEAD_PATHS = ("xla", "onehot typed block", "pallas")
ORACLE_GGSNN_PATHS = ("xla", "pallas", "onehot typed block")


def oracle_cases(path, kw):
    """(head, compute dtype) of a path: node_select (with its states) in
    f32 and bf16, q8 in bf16 alone; the other heads on ORACLE_HEAD_PATHS,
    GGS-NN on ORACLE_GGSNN_PATHS."""
    heads = ["node_select"]
    if path in ORACLE_HEAD_PATHS:
        heads += ["per_node", "graph_gated"]
    if path in ORACLE_GGSNN_PATHS:
        heads += ["ggsnn_graph", "ggsnn_node"]
    dts = ("bfloat16",) if kw.get("quantized_table") else ("float32",
                                                            "bfloat16")
    return [(h, dt) for h in heads for dt in dts]


def oracle_phase(strict=True):
    """[oracle]: on every path of ORACLE_PATHS through its kernels (each
    must launch), the card's per-step states and head outputs on the fuzz
    batch and the hub graph against the port's NumPy oracle in f64 on the
    host (:func:`oracle_cases`: f32 and bf16, every head, GGS-NN's K rounds
    of outputs and annotations).  ``strict`` raises over a tolerance."""
    import torch
    from ggnn_tpu_torch.models.init import init_params, params_to_numpy
    t0 = time.perf_counter()
    sets = {"fuzz": oracle_fuzz_graphs(), "hub": oracle_hub_graph()}
    batches = {k: oracle_batch(g, 512 if k == "fuzz" else 4096)
               for k, g in sets.items()}
    params, refs, propagated = {}, {}, {k: {} for k in sets}
    for head in ORACLE_HEADS:
        for gated in (False, True) if head == "node_select" else (False,):
            cfg = oracle_cfg(head, edge_gates=gated)
            prm = init_params(cfg, torch.Generator().manual_seed(5), "cuda")
            p64 = tree_map_leaves(lambda x: np.asarray(x, np.float64),
                                  params_to_numpy(prm))
            params[head, gated] = prm
            for k, graphs in sets.items():
                refs[head, gated, k] = oracle_refs(graphs, p64, head,
                                                   propagated[k])
    t_ref = time.perf_counter() - t0
    results = {}
    for path, kw, kind, must in ORACLE_PATHS:
        gated = kw.get("edge_gates", False)
        q8 = bool(kw.get("quantized_table"))
        for head, dt in oracle_cases(path, kw):
            cfg = oracle_cfg(head, compute_dtype=dt, **kw)
            for k, b in batches.items():
                lay = oracle_layout(kind, b) if kind else None
                zero_counts()
                states, out = oracle_run(cfg, params[head, gated], b, lay)
                counts = read_counts()
                missing = [x for x in must if not counts[x]]
                if missing:
                    raise AssertionError(f"[oracle] {path} {dt} {head}: "
                                         f"{missing} not launched")
                hold = functools.partial(oracle_hold, dtype=dt,
                                         results=results, hub=k == "hub",
                                         q8=q8)
                offs = np.concatenate([[0], np.cumsum(b.n_nodes)])[:-1]
                for gi, g in enumerate(sets[k]):
                    sl = slice(offs[gi], offs[gi] + g["n_nodes"])
                    st, a_rows, ref = refs[head, gated, k][gi]
                    if head.startswith("ggsnn"):
                        for r_ in range(ORACLE_K):
                            hold(f"{path} {dt} {head} {k} outputs",
                                 out[0][r_, sl] if head == "ggsnn_node"
                                 else out[0][r_, gi], ref[0][r_],
                                 kind="ggsnn")
                            hold(f"{path} {dt} {head} {k} annotations",
                                 out[1][r_, sl], ref[1][r_], kind="ggsnn")
                        continue
                    if head == "node_select":
                        for t in range(ORACLE_T):
                            hold(f"{path} {dt} states {k}", states[t, sl],
                                 st[t + 1], kind="states", a_rows=a_rows)
                    hold(f"{path} {dt} {head} {k}",
                         out[gi] if head == "graph_gated" else out[sl], ref,
                         kind="graph" if head == "graph_gated" else "node")
                del lay
    torch.cuda.empty_cache()
    bad = sorted(k for k, v in results.items() if v[0] > 1.0)
    for tag, (ratio, emax, emean, rf) in sorted(results.items()):
        print(f"[oracle] {tag}: max_abs_err {emax:.3e} mean_abs_err "
              f"{emean:.3e} rel_frobenius {rf:.3e}, {ratio:.3e} of its "
              f"tolerance "
              f"{'ok' if ratio <= 1.0 else 'FAIL'}", flush=True)
    worst = max(results.items(), key=lambda kv: kv[1][0])
    print(f"[oracle] {len(results)} checks against the f64 oracle on the "
          f"host ({t_ref:.1f} s of its time); the worst, {worst[0]}, at "
          f"{worst[1][0]:.3e} of its tolerance; {len(bad)} over it; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if strict and bad:
        raise AssertionError(f"[oracle] over tolerance: {bad}")
    return results



def setup():
    """Print the card and the software, build the port's kernels from the
    checkout (nvcc seconds per source, ptxas's register and spill lines),
    and make the headline model's random weights (seed 0) on the card.
    Returns (the nvidia-smi line, the params)."""
    import torch
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    from ggnn_tpu_torch.models.config import ModelConfig
    from ggnn_tpu_torch.models.init import init_params
    from ggnn_tpu_torch.ops import _build

    _build.library()
    print(f"[build] {'compiled' if _build.BuildInfo.compiled else 'loaded'}"
          f" {_build.BuildInfo.path} in {_build.BuildInfo.seconds:.1f} s; "
          f"nvcc seconds per source {_build.BuildInfo.per_source}")
    for line in _build.BuildInfo.log.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print(f"  ptxas: {line.strip()}")

    cfg = ModelConfig(state_dim=DIM, annotation_dim=ANN,
                      n_edge_types=EDGE_TYPES, n_steps=STEPS,
                      head="node_select", backend="onehot",
                      compute_dtype="bfloat16", fuse_gru=True)
    return card, init_params(cfg, torch.Generator().manual_seed(0), "cuda")


class PhaseClock:
    """Prints each phase's wall seconds and the run's total so far, so that
    a run's log shows where its time limit goes."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def mark(self, phase):
        now = time.perf_counter()
        print(f"[time] {phase}: {now - self.last:.1f} s (run "
              f"{now - self.t0:.1f} s)", flush=True)
        self.last = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 2
    from ggnn_tpu_torch.data.synthetic import synthetic_batch
    from ggnn_tpu_torch.ops.scatter import build_typed_dst_layout
    clock = PhaseClock()
    card, params = setup()
    clock.mark("setup and build")

    log, timings = {}, {}
    r = np.random.default_rng(7)
    fuzz = {
        # tag: (nodes, edges, types, dst range, src range, tile_e,
        #       grad_tile_e)
        "fuzz": (640, 9000, 6, 640, 640, None, None),
        "empty_blocks": (1024, 3000, 4, 512, 1024, None, None),
        "cmax_ge_2": (256, 6000, 4, 256, 256, 128, 128),
        "empty_grad_blocks": (640, 4000, 6, 640, 256, None, None),
    }
    for tag, (n, e, t2, dst_hi, src_hi, tile_e, g_tile) in fuzz.items():
        lay = build_typed_dst_layout(
            r.integers(0, src_hi, e), r.integers(0, dst_hi, e),
            r.integers(0, t2, e), (r.random(e) < 0.9).astype(np.float32),
            n, t2, tile_e=tile_e, with_grad=True, grad_tile_e=g_tile)
        if tag == "cmax_ge_2" and (lay.meta[10][1] < 2 or lay.meta[5][3] < 2):
            raise AssertionError("fuzz layout did not reach cmax, C >= 2")
        if tag == "empty_grad_blocks" and lay.meta[5][1] % 8 == 0:
            raise AssertionError("fuzz layout did not reach B_g % 8 != 0")
        lay = lay.to("cuda")
        check_kernels(tag, lay, params, log)
        check_grad_kernels(tag, lay, log)
    typed_seam_fuzz(log)
    gru_bwd_seam_fuzz(log)
    gru_cell_seam_fuzz(log)

    t0 = time.perf_counter()
    b = synthetic_batch(NODES, EDGES, EDGE_TYPES, annotation_dim=ANN,
                        seed=0, node_mult=128)
    t1 = time.perf_counter()
    lay = build_typed_dst_layout(b.edge_src, b.edge_dst, b.edge_type,
                                 b.edge_mask, b.spec.n_pad, 2 * EDGE_TYPES,
                                 with_grad=True)
    t2 = time.perf_counter()
    lay = lay.to("cuda")
    torch.cuda.synchronize()
    print(f"[kernels] headline batch made in {t1 - t0:.2f} s; typed layout "
          f"with its grad half built on the host in {t2 - t1:.2f} s and "
          f"copied to the card in {time.perf_counter() - t2:.2f} s; "
          f"grad_meta {lay.meta[5]}", flush=True)
    check_kernels("headline", lay, params, log, timings)
    check_grad_kernels("headline", lay, log, timings)
    torch.cuda.empty_cache()
    clock.mark("[kernels]")

    graphs = [(seed, request_graph(seed)) for seed in SERVE_REQUESTS]
    plain_cache = {}
    torch.cuda.reset_peak_memory_stats()
    launched = dict.fromkeys(KERNELS, 0)
    for fuse, per_request in (
            (True, {"typed_block_step_gru": STEPS}),
            (False, {"typed_block_scatter": STEPS, "gru_cell_fwd": STEPS})):
        for k, v in serve(params, fuse, graphs, plain_cache,
                          per_request).items():
            launched[k] += v
    print(f"[serve] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del graphs, plain_cache
    torch.cuda.empty_cache()
    clock.mark("[serve]")

    fused = {"typed_block_scatter": STEPS, "typed_grad_octet_scatter": STEPS}
    unfused = dict(fused, gru_cell_fwd=STEPS, gru_cell_bwd=STEPS)
    trained = train_headline(b, lay, {
        "fused": (dict(fuse_gru=True), fused),
        "fused+lean": (dict(fuse_gru=True, lean_residuals=True), fused),
        "unfused": (dict(fuse_gru=False), unfused)})
    del lay
    torch.cuda.empty_cache()
    for k, v in trained.items():
        launched[k] += v
    clock.mark("[train]")
    for launches in run_trainers(dict(), dict(backend="onehot", want=(
            "onehot_segment_scatter_flat", "window_block_spmm_mono"))):
        for k, v in launches.items():
            launched[k] += v
    clock.mark("the Trainer CLI, xla and onehot")

    for k, v in legacy_phase(params, b, log, timings).items():
        launched[k] += v
    torch.cuda.empty_cache()
    clock.mark("[legacy *]")
    for k, v in pallas_phases(b, log, timings).items():
        launched[k] += v
    clock.mark("[pallas *]")
    for k, v in variants_phase(b, log, timings).items():
        launched[k] += v
    clock.mark("[variants]")
    segment_rows_phase(b, log, timings)
    clock.mark("[segment rows]")
    for k, v in reproducible_phase(b)[1].items():
        launched[k] += v
    del b
    torch.cuda.empty_cache()
    clock.mark("[reproducible]")
    oracle_phase()
    clock.mark("[oracle]")

    for k, v in scalefree_phase(params, log, timings).items():
        launched[k] += v
    clock.mark("[scalefree]")
    for k, v in chunked_phase(params, log).items():
        launched[k] += v
    clock.mark("[chunked 1M]")
    window_kernels_phase(params, log, timings)
    clock.mark("[window kernels]")
    for tag, phase in (
            ("[window serve]", lambda: window_serve_phase(params)),
            ("[window 1m]", lambda: window_1m_phase(params, log)),
            ("[1m train]", train_1m_phase),
            ("[window train]",
             lambda: window_train_phase(params, log, timings))):
        for k, v in phase().items():
            launched[k] += v
        clock.mark(tag)
    widths_phase(log)
    predictor_widths()
    clock.mark("[widths]")
    for k, v in ggsnn_phases(log, clock, sharded_phases,
                             babi19=False).items():
        launched[k] += v
    # the small child processes run beside each other: [profile]'s CLI with
    # the bAbI 19 CLIs, the distributed example's entry with the dry runs
    for tag, phase in (("[profile] and the Trainer CLI, bAbI 19",
                        profile_phase),
                       ("[examples]", lambda: examples_phase(log)),
                       ("[distributed example]", dist_example_phase)):
        for k, v in phase().items():
            if k in launched:
                launched[k] += v
        clock.mark(tag)
    dryrun_phase(beside=dist_example_entry)
    clock.mark("[dryrun] and the distributed example's entry")
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    if any(m == "ggnn_tpu" or m.startswith("ggnn_tpu.") for m in sys.modules):
        raise AssertionError("the port imported the JAX package")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        if launched[name] == 0:
            raise AssertionError(f"{name} was never launched on a main path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=launched[name],
                            max_abs_err=max(log[name]), **timings[name]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
