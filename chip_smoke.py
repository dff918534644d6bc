#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root

Phases (any failure exits non-zero; none is caught and passed over):

1. Build every CUDA source under ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per file, in parallel) and print the card's name and power
   limit.
2. Hold each kernel against its plain PyTorch version on the card
   (bit-exact; ``leaf_gather`` within 1e-4, another summation order):
   8/16/32-bit plans with values >= 2^31, record counts not a multiple
   of 32, word counts not a power of two, 1-3 shards, every index
   boundary (chunk values 0 and 2^k - 1, the always-true -1), ragged
   per-column plans, 1-3 compound terms, scalars 0, 2^n - 1, >= 2^31
   and with bits above ``n_bits``, leaf addresses -1 and >= L, logits
   +-0, +-NaN, +-inf and denormals with V not a multiple of 4;
   ``temporal_encode`` at every chunk width 1-16 (W below, off and, for
   k <= 8, many times the 32-word tile; values outside ``[0, 2^k)``; an
   unaligned view), ``gbdt_leafbits_banked`` on random LUTs in both of
   its layouts (B = 1 and not a multiple of 16, W not a multiple of the
   word slice, zero masks, indices on the card outside the LUT, 12,864
   indices an instance);
   ``leaf_gather`` at B 1, 31, 33, 2^16 + 5 by T 1-1001 (ragged rows)
   by L 1, 2, 64, with L 65 and 128 (leaves read through L1), each
   route and an unaligned view bit-equal; ``minp_mask`` at one element,
   rows spanning many tiles with V % 4 = 1, 2, 3, B = 128 and 70,000
   rows of 3, for every chunking; the row gather of ``clutch_merge``,
   ``clutch_merge_banked`` and the compound kernel at every templated
   chunk count (1, 5, 8) and the generic one (2, 3, 4, 6, 16), with
   16-byte and 4-byte row loads (W % 4 != 0, a LUT view one word off),
   repeated rows and steps with lt == le, 70,000 banks of a narrow LUT,
   compounds of 40 terms, of more than 12,288 row indices (once the
   limit of the card) and of 1,000 terms (the term program in device
   memory); ``gbdt_leafbits_sum`` bit for bit against its plain version
   and ``assemble_leaves`` at B 1, 31, 256, 2^16 + 5 by T 1, 129, 1000,
   1001 by depth 1, 6, 7, 8 (L 128 and 256 through L1), with L 65 and
   an unaligned view of the leaves bit-equal to the staged route;
   and the comparison front-ends against NumPy.
3. Table path at full width: ``Table.generate(2**25, 32, num_features=8)``
   (33.5M records, 2 shards, 8 chunks of 4 bits: an 8.6 GB LUT) through
   ``PudSession.query`` -- Q1-Q5 and two ``Compound`` shapes, each equal
   to its NumPy reference (Q4 within 1e-9, as ``check`` holds it).
4. GBDT path: ``ObliviousForest.random(1000, 6, 28, n_bits=8)`` through
   ``PudSession.predict`` on 2^16 instances; leaf addresses exact,
   predictions (summed on the card by ``gbdt_leafbits_sum``, which must
   have launched) bit-equal to ``assemble_leaves`` over the reference
   addresses.
5. Kernel front-ends at full width, on phase 3's column 0 and phase 4's
   forest: ``clutch_compare`` and ``bitserial_compare`` at 8/16/32 bits
   (equal words), ``clutch_compare_banked`` over two banks with a -1
   bank, ``range_count`` for Q1 (count equal to the NumPy reference and
   to phase 3's Q1 bitmap), ``gbdt_leaf_sum`` over phase 4's leaf
   addresses (within 1e-3 of ``assemble_leaves``, two launches
   bit-equal).
6. LM serving at full width: ``minitron-8b`` (7.73 B parameters, bf16,
   random weights from ``torch.Generator("cuda").manual_seed(0)``)
   serves 16 requests of 256-token prompts, 32 new tokens each, through
   ``ServeEngine(num_slots=8, max_len=1024)`` with the min-p sampler on
   the ``minp_mask`` kernel (one launch per decode step); decode at
   position 254 within a stated bf16 tolerance of ``forward_logits``;
   on a decode step's ``[8, 256000]`` logits the kernel equals its
   plain version and the float comparison bit for bit, and 4,096 draws
   land in the kept set.
7. The other block kinds at full width, one arch at a time (each freed
   before the next): ``granite-moe-3b-a800m`` (MoE, 40 experts top-8,
   3.37 B parameters), ``rwkv6-3b`` (RWKV time and channel mix, 3.07 B)
   and ``jamba-v0.1-52b`` cut to one period of 8 of its 32 layers (7
   mamba, 1 attention, 4 MoE of 16 experts top-2; 13.3 B: the 32 layers
   would not fit one 80 GB card), bf16 random weights from
   ``torch.Generator("cuda").manual_seed(0)``, each serve 8 requests of
   256-token prompts, 16 new tokens each, through
   ``ServeEngine(num_slots=8, max_len=512)`` with min-p 0.05 on the
   ``minp_mask`` kernel (one launch per decode step); the mask on a
   decode step's ``[8, V_pad]`` logits equal to its plain version bit for
   bit; decode at position 255 against ``forward_logits`` (MoE on the
   no-drop capacity factor, ``num_experts``) within the bf16 tolerance,
   granite's on a float32 copy of its weights within a float32 one (in
   bf16 its top-8 of 40 routing parts between the two, see
   ``ARCH_PATHS``); a decode step profiled.  Then
   ``whisper-base`` at full size: 1,500 synthetic frames (a 30-s window)
   encoded for a batch of 2, 8 prompt tokens prefilled, 8 decode steps
   against the cross K/V, each within the bf16 tolerance of
   ``forward_logits``.
8. Time each kernel (CUDA events around launches, and ``cold_ms``: one
   launch after an L2 flush), its plain version, its bound and, where
   one PyTorch call computes the same function, that call, at the paths'
   shapes; for ``minp_mask`` also the floor of a pass over the same
   bytes (``y.copy_(x)``, cold) and both warm (logits in L2), for the
   merges and predicates the floor of one pass over the rows they read
   (``x.amax(dim=0)`` over a contiguous ``[rows, words]`` tensor, cold),
   and the predicate and compound timed again on the LUT and on a fresh
   copy of it (``cold_ms_again``, ``cold_ms_fresh_lut``), and
   ``gbdt_leafbits_sum`` at both predict cells' batches (2^16 and 256
   instances) beside the host's ``assemble_leaves``;
   the ``kernels`` JSON line and the ok line are printed after phase 13.
9. Training, on a clean card (the LUT, forest and models of
   phases 3-7 dropped): reduced ``granite-moe-3b-a800m`` in float32,
   two train steps and two compressed DDP steps on the card and on the
   CPU from one set of parameters, loss and grad_norm within 1e-5
   relative; then ``granite-moe-3b-a800m`` at full width and depth
   (3.37 B parameters, bf16, float32 moments, remat on) trained 6 steps
   through ``make_train_step`` on ``SHAPES["train_4k"]`` cut to a global
   batch of 4 (4 microbatches of one 4,096-token sequence) from
   ``SyntheticLM(seed=0)``, ``OptConfig(lr=3e-4, warmup_steps=2,
   total_steps=6)``: every loss finite, the step-0 loss within 1.5 of
   ln(vocab) + 2, step 0's batch lower after the 6 steps; step times,
   peak memory and a profiled step.  Then the restart through
   ``run_training`` at full width cut to 4 of 32 layers (a checkpoint
   of the full model is 33.7 GB, and the card's machine allows 45 GiB
   of disk writes a run): 6 steps against 3 steps, a checkpoint and a
   fresh resumed run to step 6, steps 3-5 within 2e-3; the checkpoint
   save and restore times; a step there with remat and without.  Of
   our kernels only ``rmsnorm`` runs in a train step (forward; its
   gradient is its plain version's, recomputed).
10. The reference's "opt" variant (``repro_torch.launch.dryrun.
    apply_variant``) at full width, after phase 9, each part on a freed
    card and nothing written to disk: (a) ``granite-moe-3b-a800m``
    under ``apply_variant(.., "opt", SHAPES["train_4k"])``
    (``attn_q_chunk=2048``, ``attn_shard_heads``, ``attn_scores_bf16``,
    ``moe_dp_sharding``): first each layer's attention (two query blocks
    of 2,048) against the plain config's (one block of 4,096) on the
    hidden states of a plain ``forward_logits`` of one 4,096-token
    sequence, within phase 6's bf16 tolerance; then trained as in phase 9:
    losses finite, step 0's within 2e-2 relative of phase 9's, step 0's
    batch lower after the steps; step times, peak, a profiled step, and
    the model FLOP share of both steps (``launch/roofline.py``); (b)
    ``rwkv6-3b``: the prefill of one 256-token prompt with
    ``rwkv_chunk=64`` against the time-step loop, last logits within
    phase 7's bf16 tolerance and the RWKV states within 2^-4 of the
    largest, then
    the "opt" config serving 8 requests of 257 tokens as phase 7 serves
    (``minp_mask`` once per decode step; its launches join the
    ``kernels`` line's); (c) ``minitron-8b`` at B = 1 against a cache of
    262,144 positions of random bf16 K/V (``long_500k`` cut from
    524,288), 8 decode steps with ``sp_decode`` and the same 8 without:
    logits within phase 6's bf16 tolerance, each step's K/V row written
    at its position (changed there, the fill on both sides, the two
    runs' rows within that tolerance), a step of each profiled; (d)
    ``pipeline_forward`` over 4 stages of [4096, 4096] bf16 weights on
    the card, 8 microbatches of [512, 4096], bit-equal to the stages
    run in order.  (a), (c) and (d) launch none of our kernels.
11. Per-column representations, last: a TPC-H ``lineitem`` table of
    2^25 records (about SF 5's 30 M rows), eight integer columns
    declared 32-bit with the specification's value ranges
    (:data:`LINEITEM_COLUMNS`, uniform from a seed, each maximum placed
    once), created twice in one ``PudSession(backend="fused")``:
    ``fixed`` (8 chunks of 4 bits, an 8.59 GB LUT) and
    ``representation="auto"``, whose
    plans must equal :data:`LINEITEM_AUTO_PLANS` (held against the
    reference's chooser by ``tests/test_torch_planner.py``) and whose
    LUT must be smaller.  Phase 3's batch shape (scalars in each
    column's range, and up to 2^32 - 1 past a narrow column's maximum)
    and TPC-H Q6's WHERE clause as a bitmap and a count run on both,
    each result equal to its NumPy reference; ``l_shipdate`` is recoded
    12/3 -> 12/2 (the table then reads ``"evicted"``) and the batch runs
    again; the adaptive-precision forest (1000 trees, depth 6, 28
    features, declared 16 bits, thresholds below 400) is loaded
    ``fixed`` and ``auto`` and predicts 2^16 instances below 2^16,
    bit-equal to ``assemble_leaves`` over the reference addresses.
    Each job's WHERE launch and each forest's leaf bits are timed again
    cold, after the launch counts are read.  A ``phase11`` JSON line on
    standard output gives plans, LUT sizes, build and rebuild seconds,
    each job's wall-clock, cold time, bound and distinct rows, the
    forests and the launches.
12. The PuD serving stack under offered load, last, in the shapes of
    ``benchmarks/serving_load.py``: its 8-bit, 8-feature table at 2^25
    records (2 shards, 2 chunks) and a forest of 1000 trees of depth 6
    over its 8 features, served by ``repro_torch.serve``'s
    ``ServingLoop`` (``AdmissionController``, capacity 24, starvation
    bound 12; ``DeadlineBatcher``; batches of 6) over a ``PudService``.
    The probe batch (Q1, Q2, Q3, Q5) runs once, exact, then 3 times:
    its median wall-clock ``m_probe`` gives the capacity 4 / ``m_probe``
    and the interactive deadline ``m_probe``.  Runs: interactive
    (Q1-Q3, weight 4, the deadline) and bulk (Q4, Q5, counted
    ``merge="dram"`` compounds, 30 % predicts of 8 instances; weight 1)
    arrivals, 40 each, Poisson at 0.15, 0.5 and 1.5 times the capacity
    and bursty at 0.5 (on and off windows of 0.632 ``m_probe``); then
    16 synchronized cohorts (four Q1s with a deadline of 0.2
    ``m_probe``, two Q5 or compound scans) with splitting and without.
    Each run is profiled.  Checks: every committed response of the 0.5x
    Poisson run and the split cohorts equals its NumPy reference (a
    seeded 8 of each other run's), every failure carries an error and
    every unexecuted request a 429, p99 >= p50, each committed
    sub-batch's shares sum to its job's wall-clock and stack into the
    dispatch's makespan, and the predicate, compound and leaf-bits
    kernels launch.  A ``phase12`` JSON line on standard output gives
    each run's p50, p99, goodput, sheds, splits, probes against
    committed jobs (and the discarded probes' wall-clock), simulated
    against real seconds, and the device-busy share, with the
    wall-clock of every one-request job by query kind.
13. The machine backend, last: ``PudSession(num_devices=8,
    arch=MODIFIED)`` (``backend="machine"``, ``cost.DESKTOP``) over
    the command-level PuD model whose bank state lives on the card:
    phase 12's table at 2^25 records (2 shards a device, 16 groups of
    32 banks, 2 chunks: 248 of 1,016 rows, 4.29 GB of int32 bank
    state), loaded through ``temporal_encode``; phase 3's query shapes
    at ``mx = 255`` and the last compound merged on the host too, each
    equal to NumPy and to the same session's ``backend="fused"`` job
    bit for bit, every group's PuD ops equal to the closed form; the
    table dropped and loaded ``method="bitserial"`` for the same
    queries; phase 12's forest on 2 groups of 4 banks a device
    (``replicate="rowclone"``, 64 instances a wave), 4,096 instances
    bit-equal to ``assemble_leaves`` and to the fused job, ops equal to
    ``gbdt_ops_per_instance`` times the waves; an evict with reload
    and a ``defragment`` (64 banks moved), 512 instances again after
    each.  A ``phase13`` JSON line gives the card's numbers (job
    wall-clock; each load, run under ``torch.profiler``, split into
    power-up draw, upload and the profiler's spans, with the device
    time of its ``temporal_encode`` launches; bank-state bytes, peak
    memory) beside the modeled DDR4 ones (makespan, device
    span, commands, energy, Clutch over bit-serial).  Its GBDT job runs
    under ``verify="strict"``, its lint timed apart.
14. Verified, autoscaled machine serving, last, after phase 13's
    session is freed: a ``repro_torch.analysis.pudlint``
    ``TraceCollector`` is installed before any of the phase's subarrays
    exists; ``mutations.self_test()`` with its subarrays on the card
    (every seeded class flagged with its code, the baselines clean);
    ``PudSession(num_devices=16, arch=MODIFIED, verify="strict")`` on
    ``cost.DESKTOP`` (on phase 13's 8 devices the table fills every bank
    and the forest would evict it) holding phase 12's table at 2^25
    records (2 shards a device: 512 banks, 4.29 GB of bank state) and
    forest (``load_vector`` through
    ``temporal_encode`` for both), whose load traces the collector
    lints; the probe batch's modeled makespan gives the capacity and
    the deadline, as ``benchmarks/serving_load.py`` derives them; one
    Poisson point at 0.5x that capacity (phase 12's 40 arrivals a class)
    served twice on the same arrivals by ``ServingLoop``, plain and with a
    ``UtilizationAutoscaler`` that re-evaluates every job (the session's
    config restored between).  Checks: every committed response of the
    autoscaled run exact against NumPy (a seeded 8 of the plain run's),
    every job linted strict, every dispatched resource's traces empty
    after its dispatch, at least one decision and each one's
    ``predicted_ns <= static_best_ns``, the collector's final drain
    clean with a PL401 record for every dispatched request, and a
    committed job's timeline made invalid two ways (``mutations.
    mut_op_swap``, PL307; pin bytes on its first in-DRAM wave, the edit
    of ``mut_clone_io``, PL306) raising ``PudLintError`` from
    ``Timeline.verify``.  A ``phase14`` JSON line gives the card's
    numbers (loads, bank-state bytes, peak memory, host seconds of each
    job's lint, of the drains and of each autoscaler decision, phase
    13's GBDT lint) beside the modeled ones (p50, p99, goodput and the
    decisions on the loop's simulated clock of ``cost.DESKTOP``
    makespans).

15. The mesh layer, last, on a one-rank NCCL group over a local store
    (destroyed after (b)): (a) phase 9's reduced granite in float32
    trained 2 steps through ``jit_train_step`` on ``make_host_mesh()``
    (1 x 1), each step's loss and grad_norm within 1e-5 of phase 9's
    ``make_train_step`` on the card (step 1 holds step 0's update);
    then ``granite-moe-3b-a800m`` at full width trained 2 steps of
    phase 9's 4 x 4,096 tokens the same way, parameters and moments
    DTensors on the card, step 0's loss and grad_norm within phase 10's
    2e-2 of phase 9's; (b) phase 3's table and phase 4's forest through
    ``FusedTableExec`` / ``FusedGbdtExec`` with ``mesh=shard_mesh(2)``
    (one rank on one card, so it holds both shards): every bitmap and
    count equal to its NumPy reference and to phase 3's, leaf addresses
    and predictions to phase 4's, and ``temporal_encode``,
    ``fused_predicate_banked``, ``fused_compound_banked`` and
    ``gbdt_leafbits_banked`` launched (their launches join the
    ``kernels`` line's); (c) the dry run's cells
    (:data:`DRYRUN_CELLS`, one per block kind) on the fake 256-rank
    production mesh, each ``python -m repro_torch.launch.dryrun`` in a
    process of its own, all started together after (b) (on the CPU,
    once nothing on the card is timed): per-device parameter and moment
    bytes times 256 at least the whole tensors', the model-FLOP ratio
    finite and positive.  A ``phase15`` JSON line gives (a)-(b)'s
    numbers on the card and (c)'s, labelled modeled.

Launch counts are set to 0 just before each path runs and read just
after; a kernel of the path with no launch fails the run.  Progress and
a detailed JSON report (per-query wall-clock, launch counts per path,
bound inputs, peak memory) go to standard error.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import timeit
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the float32 rate
# outside the tensor cores, the highest non-tensor rate in the table --
# used for these kernels' integer logic, so the bound stays a lower bound.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

KERNEL_META = {
    "temporal_encode": (
        "src/repro_torch/kernels/csrc/temporal_encode.cu",
        "src/repro/kernels/temporal_encode.py:35"),
    "fused_predicate_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:162"),
    "fused_compound_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:251"),
    "gbdt_leafbits_banked": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:323"),
    "clutch_merge": (
        "src/repro_torch/kernels/csrc/clutch_merge.cu",
        "src/repro/kernels/clutch_merge.py:36"),
    "clutch_merge_banked": (
        "src/repro_torch/kernels/csrc/clutch_merge.cu",
        "src/repro/kernels/clutch_merge.py:74"),
    "fused_range_count": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "src/repro/kernels/fused_query.py:73"),
    "bitserial_cmp": (
        "src/repro_torch/kernels/csrc/bitserial_cmp.cu",
        "src/repro/kernels/bitserial_cmp.py:29"),
    "leaf_gather": (
        "src/repro_torch/kernels/csrc/leaf_gather.cu",
        "src/repro/kernels/leaf_gather.py:41"),
    "gbdt_leafbits_sum": (
        "src/repro_torch/kernels/csrc/fused_query.cu",
        "none: the reference sums on the host (apps/gbdt.py "
        "assemble_leaves)"),
    "minp_mask": (
        "src/repro_torch/kernels/csrc/minp_mask.cu",
        "src/repro/kernels/minp_mask.py:47"),
    "selective_scan": (
        "src/repro_torch/kernels/csrc/selective_scan.cu",
        "none: the reference scans with lax.scan in XLA (models/ssm.py "
        "mamba_block)"),
    "rmsnorm": (
        "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "none: the reference leaves its norm to XLA (models/layers.py "
        "rmsnorm)"),
}

# (n_bits, chunks) of the compare front-ends, as in the reference's
# kernel benchmark (benchmarks/kernel_wallclock.py)
COMPARE_PLANS = ((8, 1), (16, 2), (32, 5))
# leaf_gather sums in another order than its plain version
LEAF_TOL = 1e-4
# phase 6: minitron-8b at full width, 16 requests through 8 slots
LM_ARCH = "minitron-8b"
LM_REQUESTS, LM_SLOTS, LM_MAX_LEN = 16, 8, 1024
LM_PROMPT, LM_NEW, LM_DRAWS = 256, 32, 4096
# decode vs forward in bf16, as fractions of the largest logit: 2^-4 is
# 16 bf16 ulps of it (max error), 2^-6 4 ulps (mean error)
DECODE_TOL, DECODE_MEAN_TOL = 2.0 ** -4, 2.0 ** -6
# phase 7: (arch, layers kept or None, parameter count, dtype of the
# decode-vs-forward check), 8 requests through 8 slots; whisper's 30-s
# window of frames.  granite's check runs on a float32 copy of its
# weights: in bf16 the forward (GEMMs over 512 rows) and the prefill (510)
# round differently, which flips a token's top-8 of 40 experts where the
# 8th and 9th router logits lie 7e-6 apart, and the flips cascade through
# attention (on the card: 9 of 510 prompt tokens routed otherwise at layer
# 1, ~450 from layer 20; decode vs forward then 7.2 on logits of 8.75).
# In float32 no token is routed otherwise and they agree within 6.1e-4.
ARCH_PATHS = (("granite-moe-3b-a800m", None, 3_374_679_552, "float32"),
              ("rwkv6-3b", None, 3_073_313_280, "bfloat16"),
              ("jamba-v0.1-52b", 8, 13_295_235_072, "bfloat16"))
# the decode-vs-forward check in float32, as fractions of the largest
# logit: 2^-10 (max error; 8.5e-3 at 8.7) and 2^-14 (mean)
F32_DECODE_TOL, F32_DECODE_MEAN_TOL = 2.0 ** -10, 2.0 ** -14
ARCH_REQUESTS, ARCH_SLOTS, ARCH_MAX_LEN = 8, 8, 512
ARCH_PROMPT, ARCH_NEW = 256, 16
WHISPER_PARAMS, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = (
    97_271_808, 1500, 8, 8)
# phase 9: granite-moe-3b-a800m trained at full width (bf16 parameters,
# float32 moments, remat on): SHAPES["train_4k"] cut to a global batch
# of 4 (4 microbatches of one 4,096-token sequence), 6 steps from
# SyntheticLM(seed=0), a restart at step 3; the restart is held within
# the reference's own 2e-3 (tests/test_train_system.py), since the
# index backward (embedding, MoE combine) adds with atomics on the card
TRAIN_ARCH, TRAIN_PARAMS = "granite-moe-3b-a800m", 3_374_679_552
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 4096, 4, 4
TRAIN_STEPS, TRAIN_RESTART = 6, 3
# the restart runs full width at 4 of 32 layers: a checkpoint of the full
# model is 33.7 GB (bf16 parameters, two float32 moments) and the restart
# writes three, where the card's machine allows 45 GiB of disk writes a
# run; at 4 layers one is 5.6 GB
TRAIN_RESTART_LAYERS = 4
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
RESTART_TOL = 2e-3
# the step-0 loss of random weights: within 1.5 of ln(vocab) + 2.  The
# final norm multiplies the unit-RMS stream by 1 + scale = 2 at init and
# the head's entries are N(0, 1/d_model), so the logits are N(0, 2^2)
# and E[logsumexp] = ln(vocab) + 2^2 / 2 (reduced granite: 8.24 against
# ln(512) + 2 = 8.24, in both packages); the gold logit averages 0
LOSS0_TOL, LOSS0_ABOVE_LN_V = 1.5, 2.0
# reduced granite in float32, the card against the CPU: two train steps
# and two compressed DDP steps from the same parameters, loss and
# grad_norm within 1e-5 relative (float32 sums in other orders)
CARD_CPU_RTOL = 1e-5
# phase 10: the reference's "opt" variant (launch/dryrun.py
# apply_variant) at full width.  (a) granite under apply_variant(..,
# "opt", SHAPES["train_4k"]): each layer's attention against the plain
# config's on the hidden states of one sequence of TRAIN_SEQ tokens; then
# trained as in phase 9, step 0's loss within 2e-2 relative of phase 9's
# (the same weights and batch; scores kept in bf16 up to the softmax,
# which phase 9 casts to float32 first)
OPT_LOSS0_RTOL = 2e-2
# (b) rwkv6-3b: one 256-token prompt prefilled (a multiple of
# rwkv_chunk=64, so the chunked form runs) with the chunk and without;
# then ARCH_REQUESTS prompts of 257 tokens served (the engine prefills
# all but the last token: 256)
OPT_RWKV_ARCH, OPT_RWKV_PROMPT = "rwkv6-3b", 256
# (c) minitron-8b decoded at B = 1 against a cache of 262,144 positions
# of random bf16 K/V (SHAPES["long_500k"] cut from 524,288: there the
# cache is 68.7 GB beside 15.5 GB of weights), 8 steps with sp_decode
# and 8 without, at the positions just before the cache's last
OPT_LONG_ARCH, OPT_LONG_SEQ, OPT_LONG_STEPS = "minitron-8b", 262_144, 8
# (d) pipeline_forward over 4 stages of [4096, 4096] bf16 weights
# (minitron's width), tanh(x @ W) as in the reference's test, 8
# microbatches of [512, 4096]
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS, PIPE_WIDTH = 4, 8, 512, 4096
# phase 11: TPC-H lineitem at SF 5 (about 30 M rows; here phase 3's 2^25
# records), eight integer columns declared 32-bit, with the value ranges
# of the TPC-H specification (prices in cents, discount and tax in
# hundredths, ship date in days from 1992-01-01): (name, low, high)
LINEITEM_RECORDS = 2 ** 25
LINEITEM_COLUMNS = (
    ("l_orderkey", 1, 120_000_000), ("l_partkey", 1, 1_000_000),
    ("l_suppkey", 1, 50_000), ("l_quantity", 1, 50),
    ("l_extendedprice", 90_000, 10_494_950), ("l_discount", 0, 10),
    ("l_tax", 0, 8), ("l_shipdate", 0, 2_526))
# the (n_bits, num_chunks) representation="auto" gives each column, on
# each arch (tests/test_torch_planner.py holds these against the
# reference's chooser on a sample of the same ranges)
LINEITEM_AUTO_PLANS = {
    "modified": ((27, 7), (20, 5), (16, 4), (6, 1), (24, 6), (4, 1),
                 (4, 1), (12, 3)),
    "unmodified": ((27, 9), (20, 6), (16, 4), (6, 1), (24, 8), (4, 1),
                   (4, 1), (12, 3)),
}
# phase 12: the PuD serving stack under offered load, in the shapes of
# benchmarks/serving_load.py: its 8-bit, 8-feature table (seed 13) at
# phase 3's record count (2 shards, the paper's 2 chunks), and phase 4's
# 1000 trees of depth 6 over the table's 8 features, since the bulk mix
# draws its instances over them
SERVE_RECORDS = 2 ** 25
SERVE_MAX_BATCH = 6
SERVE_LOAD_FRACS = (0.15, 0.5, 1.5)   # x the probed capacity
SERVE_ARRIVALS = 40                   # per class and run
# the bursty point's on and off windows, in probe makespans: the
# reference benchmark's 4e5 ns over its own probe makespan of 633,050 ns
SERVE_BURST_WINDOW = 0.632
SERVE_COHORTS = 16
# committed responses checked against NumPy in a run that is not
# checked in full (the 0.5x Poisson point and the split cohorts are)
SERVE_SAMPLE = 8
# phase 13: the machine backend (the PuD model, bank state on the card)
# over phase 12's table and forest on 8 DESKTOP devices (2 shards of 32
# banks each: 512 banks of 1,024 rows x 64 Ki columns, 4.29 GB); 64
# forest replicas of 4 banks predict 4,096 instances, 512 again after
# the evict and the defragmentation
MACHINE_DEVICES = 8
MACHINE_BATCH = 4096
MACHINE_RECHECK = 512
# phase 14: phase 12's table and forest in a machine session under
# verify="strict", serving phase 12's mixes at 0.5x the capacity of its
# own modeled probe makespan.  16 DESKTOP devices, not phase 13's 8: the
# table fills 8 devices' 512 banks, so the forest would evict it at every
# switch between them; on 16 it takes 32 of each device's 64 banks (still
# 512 banks, 4.29 GB) and the forest 8
VERIFY_DEVICES = 16
VERIFY_LOAD_FRAC = 0.5
# phase 15: the mesh layer.  (a) phase 9's granite, 2 steps through
# jit_train_step on a one-rank make_host_mesh(); (c) one dry-run cell per
# block kind on the fake 256-rank production mesh, a subprocess each
# (the fake group and the card's NCCL group cannot both be the default
# group of one process)
MESH_TRAIN_STEPS = 2
DRYRUN_CELLS = (("granite-moe-3b-a800m", "train_4k"),
                ("minitron-8b", "decode_32k"),
                ("rwkv6-3b", "long_500k"),
                ("jamba-v0.1-52b", "prefill_32k"))
DRYRUN_TIMEOUT_S = 600
# selective_scan at the Jamba2 Mini cell's shapes: (sequences, tokens)
# of a batch-1 prefill of 4,999 tokens and of a decode step of 128 slots,
# at d_inner 8,192 and d_state 16
SCAN_SHAPES = ((1, 4999), (128, 1))
SCAN_DIN, SCAN_N = 8192, 16
# the kernel against its plain version.  In bf16 the plain version rounds
# delta = softplus(dt + bias) to bf16 (2^-9 of it, which enters
# exp(delta A) times |delta A|), and the scan's output before the D term
# and the gate (three more roundings); the kernel keeps float32 and rounds
# y once: y and the float32 state within 2^-6 of their largest |value| (4
# bf16 ulps of it), y within 2^-10 on average.  In float32 (exp2 of a
# product against exp, in another order) both within 1e-4 of the largest.
SCAN_BF16_TOL, SCAN_Y_MEAN_TOL, SCAN_F32_TOL = 2.0 ** -6, 2.0 ** -10, 1e-4
# rmsnorm at the Jamba2 Mini cell's shapes: (tokens, groups, d, row
# stride): a prefill's and a decode step's hidden rows, a token's dt
# (256 of the 288 x_proj columns) and its B and C side by side
NORM_SHAPES = ((4999, 1, 4096, 4096), (112, 1, 4096, 4096),
               (4999, 1, 256, 288), (4999, 2, 16, 288))
# the kernel against its plain version: the same float32 arithmetic but
# for the order of the sum of squares, rounded once; bf16 within 2^-7 of
# the largest |y| (2 ulps of it), float32 within 1e-5
NORM_BF16_TOL, NORM_F32_TOL = 2.0 ** -7, 1e-5
# minp_mask edge values: +-0, +-NaN, +-inf, denormals, the fill itself
MINP_EDGE = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1e-45,
                      -1e-45, 1e-38, -1e-38, -1e30, 3.0, -3.0, 1e30],
                     np.float32)
# and the boundaries of the kernel's tiling (tiles of 4,096 floats inside
# a row, a persistent grid): one element; rows spanning many tiles with
# V % 4 = 1, 2, 3 (rows off the 16-byte grid); B > 8 (the [128, 256000]
# batch phase 8 times); many rows of a few elements
MINP_EDGE_SHAPES = ((1, 100), (4, 1024), (8, 50000), (3, 7), (5, 301),
                    (2, 1), (16, 2050), (1, 1), (7, 300001), (9, 99998),
                    (3, 1234567), (128, 256000), (70000, 3))


def expect(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def same_bits(torch, a, b) -> bool:
    """Float tensors equal bit for bit (NaN payloads included)."""
    torch.cuda.synchronize()
    return a.shape == b.shape and torch.equal(
        a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def minp_edge_batch(rng, b: int, v: int):
    """Logits [b, v] (normal * 8), each row starting with the edge
    values; thresholds [b]: one equal to a logit, then +0.0, -0.0, a
    denormal and +NaN, then normal draws."""
    x = (rng.normal(size=(b, v)) * 8).astype(np.float32)
    m = min(v, MINP_EDGE.size)
    x[:, :m] = MINP_EDGE[:m]
    tau = rng.normal(size=b).astype(np.float32)
    special = np.array([x[0, v // 2], 0.0, -0.0, 1e-45, np.nan], np.float32)
    tau[:min(b, special.size)] = special[:b]
    return x, tau


def column_bits(torch, col: np.ndarray, n_bits: int):
    """The top ``n_bits`` of a 32-bit column: (uint32 NumPy values, the
    same bits as an int32 tensor on the card)."""
    v = (col >> np.uint64(32 - n_bits)).astype(np.uint32)
    return v, torch.from_numpy(v.view(np.int32)).to(torch.device("cuda"))


def lineitem_columns(n: int, seed: int) -> list:
    """``n`` records of :data:`LINEITEM_COLUMNS`, uniform in each range
    from ``seed``, each column's maximum placed once (at record 7) so
    the inferred widths do not depend on the draw."""
    rng = np.random.default_rng(seed)
    cols = []
    for _, lo, hi in LINEITEM_COLUMNS:
        c = rng.integers(lo, hi + 1, n, dtype=np.uint64)
        c[7] = hi
        cols.append(c)
    return cols


def leafsum_case(torch, g, b: int, t: int, d: int):
    """Random [b, t] leaf addresses of depth ``d`` (int32), [t, 2^d]
    float32 leaves over six decades, and the addresses' leaf bits
    [b, ceil(t * d / 32) + 1] as ``gbdt_leafbits_banked`` lays them out
    (node ``t * d + k`` at word / bit ``(t * d + k) // 32``, ``% 32``),
    on the generator's device."""
    from repro_torch.kernels.common import to_int32_bits

    dev = g.device
    at = torch.randint(0, 1 << d, (b, t), generator=g, device=dev,
                       dtype=torch.int32)
    lv = torch.randn((t, 1 << d), generator=g, device=dev) * 10.0 ** (
        6 * torch.rand((t, 1 << d), generator=g, device=dev) - 3)
    w = -(-t * d // 32) + 1
    shifts = torch.arange(d - 1, -1, -1, device=dev)
    bits = ((at.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(b, -1)
    bits = torch.nn.functional.pad(bits, (0, w * 32 - t * d))
    words = (bits.view(b, w, 32) << torch.arange(32, device=dev)).sum(-1)
    return at, lv, to_int32_bits(words)


def scan_inputs(torch, g, bsz: int, s: int, din: int, dtype,
                with_state: bool, wide: bool = False,
                param_dtype=None):
    """Inputs of ``selective_scan`` at the scales of the Jamba2 Mini cell's
    mixer (normed B and C, a pre-activation dt of about 2, a dt bias,
    ``A_log`` and ``D`` of 1, in ``param_dtype``, float32 unless named);
    with ``wide`` x and z are the halves of one [B, S, 2 din] tensor, as
    ``mamba_block`` hands over z."""
    def n(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dt)
    if wide:
        x, z = n(bsz, s, 2 * din, std=2.0).chunk(2, dim=-1)
    else:
        x, z = n(bsz, s, din, std=2.0), n(bsz, s, din, std=2.0)
    dt, b, c = n(bsz, s, din, std=2.0), n(bsz, s, SCAN_N, std=2.0), n(
        bsz, s, SCAN_N, std=2.0)
    pdt = param_dtype or torch.float32
    a_log, d, bias = (n(din, SCAN_N, dt=pdt), n(din, dt=pdt), n(din, dt=pdt))
    state = n(bsz, din, SCAN_N, dt=torch.float32) if with_state else None
    return (x, dt, z, b, c, a_log, d, bias), state


def scan_gaps(torch, got, want) -> dict:
    """The kernel's (y, state) against the plain version's: the largest
    and mean |difference| of y and the largest of the state, each over
    the largest |value| of the plain version's."""
    (y, h), (wy, wh) = got, want
    torch.cuda.synchronize()
    dy = (y.float() - wy.float()).abs()
    top_y = float(wy.float().abs().max())
    return {"y_max": float(dy.max()) / top_y,
            "y_mean": float(dy.mean()) / top_y,
            "state_max": float((h - wh).abs().max())
            / float(wh.abs().max())}


def check_selective_scan(torch) -> int:
    """``selective_scan`` against its plain version on the card: din not
    a multiple of a block's 64 channels, S not a multiple of the 32-step
    chunk, several sequences, x and z as halves of one wider tensor, with
    and without a carried state, float32 and bfloat16; then the cell's
    shapes (``SCAN_SHAPES``) in bfloat16."""
    import repro_torch.kernels as K
    from repro_torch.kernels import ref

    g = torch.Generator("cuda").manual_seed(11)
    n_checks = 0
    cases = [(bsz, s, din, dtype, st, wide)
             for bsz, s, din in ((1, 1, 64), (3, 45, 100), (2, 130, 256))
             for dtype in (torch.float32, torch.bfloat16)
             for st in (False, True) for wide in (False, True)]
    # the cell's shapes, its parameters in bfloat16 as the benchmark draws
    # them (the wrapper hands the kernel float32 copies)
    cases += [(bsz, s, SCAN_DIN, torch.bfloat16, bsz > 1, True)
              for bsz, s in SCAN_SHAPES]
    for bsz, s, din, dtype, st, wide in cases:
        args, state = scan_inputs(
            torch, g, bsz, s, din, dtype, st, wide,
            torch.bfloat16 if din == SCAN_DIN else None)
        before = K.selective_scan.launches
        gap = scan_gaps(torch, K.selective_scan(*args, state),
                        ref.selective_scan_ref(*args, state))
        what = (f"selective_scan B={bsz} S={s} din={din} {dtype} "
                f"state={st} wide={wide}: {gap}")
        expect(K.selective_scan.launches == before + 1, f"{what} launched")
        if dtype == torch.float32:
            expect(gap["y_max"] <= SCAN_F32_TOL
                   and gap["state_max"] <= SCAN_F32_TOL, what)
        else:
            expect(gap["y_max"] <= SCAN_BF16_TOL
                   and gap["y_mean"] <= SCAN_Y_MEAN_TOL
                   and gap["state_max"] <= SCAN_BF16_TOL, what)
        n_checks += 1
        del args, state
    return n_checks


def norm_case(torch, g, tokens: int, groups: int, d: int, ld: int, dtype,
              scale_dtype):
    """``rmsnorm``'s inputs: x a [tokens, groups, d] view of rows of ``ld``
    elements (as ``mamba_block`` hands over dt, or B and C), scale
    [groups, d] (or [d] for one group) near 0."""
    base = (torch.randn(tokens, ld, generator=g, device="cuda") * 3).to(dtype)
    x = base[:, ld - groups * d:].unflatten(-1, (groups, d))
    if groups == 1:
        x = x[:, 0]
    shape = (groups, d) if groups > 1 else (d,)
    scale = (torch.randn(shape, generator=g, device="cuda") * 0.1).to(
        scale_dtype)
    return x, scale


def check_rmsnorm(torch) -> int:
    """``rmsnorm`` against its plain version on the card: odd widths and
    row counts, strided rows, groups, both dtypes of x and of the scale;
    then the cell's shapes."""
    import repro_torch.kernels as K
    from repro_torch.kernels import ref

    g = torch.Generator("cuda").manual_seed(13)
    n_checks = 0
    cases = [(t, gr, d, ld) for t, gr, d, ld in
             ((1, 1, 1, 1), (3, 1, 33, 40), (9, 2, 16, 40), (17, 3, 5, 15))]
    cases += list(NORM_SHAPES)
    for t, gr, d, ld in cases:
        for dtype in (torch.float32, torch.bfloat16):
            for sdt in (torch.float32, torch.bfloat16):
                x, scale = norm_case(torch, g, t, gr, d, ld, dtype, sdt)
                before = K.rmsnorm.launches
                got, want = K.rmsnorm(x, scale, 1e-6), ref.rmsnorm_ref(
                    x, scale, 1e-6)
                torch.cuda.synchronize()
                tol = NORM_F32_TOL if dtype == torch.float32 else NORM_BF16_TOL
                err = float((got.float() - want.float()).abs().max()) / max(
                    float(want.float().abs().max()), 1e-30)
                expect(K.rmsnorm.launches == before + 1 and got.shape ==
                       want.shape and err <= tol,
                       f"rmsnorm T={t} G={gr} d={d} ld={ld} {dtype} scale "
                       f"{sdt}: {err}")
                n_checks += 1
    return n_checks


def norm_timing(torch, flush, cold: dict) -> dict:
    """``rmsnorm`` at the cell's shapes in bfloat16: its time (events,
    and cold after an L2 flush), the plain version's, the library's
    (``F.rms_norm`` with the weight ``1 + scale``, one group only) and
    the bytes bound (x read and y written at 2 bytes)."""
    import torch.nn.functional as F

    import repro_torch.kernels as K
    from repro_torch.kernels import ref

    g = torch.Generator("cuda").manual_seed(14)
    out = {}
    for t, gr, d, ld in NORM_SHAPES:
        x, scale = norm_case(torch, g, t, gr, d, ld, torch.bfloat16,
                             torch.bfloat16)
        key = f"rmsnorm {t}x{gr}x{d}"

        def call():
            return K.rmsnorm(x, scale, 1e-6)
        cold[key] = cold_ms(torch, call, flush)
        nbytes = 2 * t * gr * d * 2
        out[f"{t}x{gr}x{d}"] = {
            "ms": median_ms(torch, call), "cold_ms": cold[key],
            "plain_ms": median_ms(torch, lambda: ref.rmsnorm_ref(
                x, scale, 1e-6), reps=5),
            "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes,
            "max_abs_err": max_abs_err(torch, call().float(),
                                       ref.rmsnorm_ref(x, scale,
                                                       1e-6).float())}
        if gr == 1:
            w = (1 + scale.float()).to(x.dtype)
            out[f"{t}x{gr}x{d}"]["library_ms"] = median_ms(
                torch, lambda: F.rms_norm(x, (d,), w, 1e-6))
    return out


def scan_timing(torch, flush, cold: dict) -> dict:
    """``selective_scan`` at the cell's shapes in bfloat16: its time
    (events, and cold after an L2 flush), the plain version's, the bytes
    bound (x, dt, z read and y written at 2 bytes, B and C at 2, the
    float32 state written and read where it comes in) and the largest
    gaps from the plain version."""
    import repro_torch.kernels as K
    from repro_torch.kernels import ref

    g = torch.Generator("cuda").manual_seed(12)
    out = {}
    for bsz, s in SCAN_SHAPES:
        args, state = scan_inputs(torch, g, bsz, s, SCAN_DIN, torch.bfloat16,
                                  bsz > 1, wide=True,
                                  param_dtype=torch.bfloat16)
        key = f"selective_scan {bsz}x{s}"

        def call():
            return K.selective_scan(*args, state)
        cold[key] = cold_ms(torch, call, flush)
        nbytes = (bsz * s * (4 * SCAN_DIN + 2 * SCAN_N) * 2
                  + bsz * SCAN_DIN * SCAN_N * 4 * (1 + (state is not None)))
        out[f"{bsz}x{s}"] = {
            "ms": median_ms(torch, call), "cold_ms": cold[key],
            "plain_ms": median_ms(torch, lambda: ref.selective_scan_ref(
                *args, state), reps=3),
            "bound_ms": bound(nbytes, 0)[0], "bytes": nbytes,
            "gaps": scan_gaps(torch, call(),
                              ref.selective_scan_ref(*args, state))}
        del args, state
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- #
# Phase 2: every kernel against its plain version, small edge cases
# --------------------------------------------------------------------- #

def check_kernels(torch) -> int:
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.core.encoding import ColumnPlan, make_plan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.common import quad_rows, unpack_bits_torch
    from repro_torch.kernels.fused_session import FusedGbdtExec, FusedTableExec
    from repro_torch.kernels.leaf_gather import route as leaf_route

    cuda = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_checks = 0

    def same(a, b, what):
        nonlocal n_checks
        torch.cuda.synchronize()
        expect(a.shape == b.shape and torch.equal(a.cpu(), b.cpu()), what)
        n_checks += 1

    def agree(ok, what):
        nonlocal n_checks
        expect(ok, what)
        n_checks += 1

    def random_terms(n_terms, one_range=False):
        """A compound shape: 1-2 ranges a term (one with ``one_range``),
        random AND/OR within and between the terms."""
        tr = (1,) * n_terms if one_range else tuple(
            int(x) for x in rng.integers(1, 3, n_terms))
        return (tr, tuple(bool(x) for x in rng.integers(0, 2, n_terms)),
                tuple(bool(x) for x in rng.integers(0, 2, n_terms - 1)))

    # temporal_encode at every chunk width: W below one 32-word tile, W
    # not a multiple of it, and (k <= 8, where the plain version's
    # [R, 32 W] booleans stay small) W large enough that every warp of
    # the persistent grid walks several tiles; values below 0 and at or
    # above 2^k (no plane set / every plane set, as in the plain version)
    for k in range(1, 17):
        for w in (5, 45, 1000) + ((300_007,) if k <= 8 else ()):
            v = rng.integers(0, 1 << k, (w, 32)).astype(np.int32)
            v[0, :4] = [0, (1 << k) - 1, -5, 1 << k]
            v[-1, -1] = 2 ** 31 - 1
            vt = torch.from_numpy(v).to(cuda)
            same(K.temporal_encode(vt, k),
                 ref.temporal_encode_ref(vt.reshape(-1), k),
                 f"temporal_encode k={k} W={w}")
    # a view that is not 16-byte aligned (the wrapper copies it)
    flat = torch.from_numpy(rng.integers(0, 16, 1 + 45 * 32).astype(
        np.int32)).to(cuda)
    vt = flat[1:].view(45, 32)
    same(K.temporal_encode(vt, 4), ref.temporal_encode_ref(vt.reshape(-1), 4),
         "temporal_encode from an unaligned view")

    # encode_lut on the card (kernel) == on the CPU (plain version)
    for n_bits, c, n in ((8, 1, 1000), (8, 2, 12001), (16, 4, 4097),
                         (32, 5, 999), (32, 8, 12001)):
        v = rng.integers(0, 1 << n_bits, n, dtype=np.uint64)
        v[:2] = [0, (1 << n_bits) - 1]
        if n_bits == 32:
            v[2] = 1 << 31
        vt = torch.from_numpy(v.astype(np.uint32).view(np.int32))
        for comp in (False, True):
            plan = make_plan(n_bits, c)
            same(ops.encode_lut(vt.to(cuda), plan, complement=comp),
                 ops.encode_lut(vt, plan, complement=comp),
                 f"encode_lut {n_bits}/{c} n={n} comp={comp}")

    # predicates and compounds over tables: uniform and ragged plans
    cases = [(8, 2, 1, None), (16, 4, 2, None), (32, 8, 3, None),
             (16, 4, 2, [ColumnPlan(16, 4), ColumnPlan(5, 2),
                         ColumnPlan(9, 3)])]
    for n_bits, c, shards, plans in cases:
        n = 5001
        widths = [p.n_bits for p in plans] if plans else [n_bits] * 3
        cols = [rng.integers(0, 1 << wb, n, dtype=np.uint64)
                for wb in widths]
        for col, wb in zip(cols, widths):
            col[:2] = [0, (1 << wb) - 1]
        if n_bits == 32:
            cols[0][2] = 1 << 31
        t = Table(n_bits, cols)
        gx = FusedTableExec(t, shards, c, plans=plans, device=cuda)
        px = FusedTableExec(t, shards, c, plans=plans, device="cpu")
        same(gx.lut, px.lut, f"table LUT {n_bits}-bit x{shards}")
        mx = (1 << n_bits) - 1
        ranges = [(0, 0, mx), (1, mx // 3, 2 * mx // 3), (2, 0, 1),
                  (0, mx - 1, mx), (1, int(rng.integers(0, mx)), mx),
                  (2, mx // 7, mx // 2)]
        for r1, r2 in zip(ranges, ranges[1:]):
            for nr, disj in ((1, False), (2, False), (2, True)):
                rr = [r1, r2][:nr]
                idx = np.concatenate([gx._range_idx(*r) for r in rr])
                got = K.fused_predicate_banked(gx.lut, idx, gx.num_chunks,
                                               nr, disj)
                want = ref.fused_predicate_banked_ref(gx.lut, idx,
                                                      gx.num_chunks, nr, disj)
                same(got[0], want[0], f"predicate bitmap {rr} {disj}")
                same(got[1], want[1], f"predicate count {rr} {disj}")
        for shape in (((1,), (False,), ()),
                      ((2, 1), (True, False), (False,)),
                      ((1, 2, 2), (False, False, True), (True, False))):
            nr = sum(shape[0])
            idx = np.concatenate([gx._range_idx(*r) for r in ranges[:nr]])
            got = K.fused_compound_banked(gx.lut, idx, gx.num_chunks, *shape)
            want = ref.fused_compound_banked_ref(gx.lut, idx, gx.num_chunks,
                                                 *shape)
            same(got[0], want[0], f"compound bitmap {shape}")
            same(got[1], want[1], f"compound count {shape}")
        # random rows anywhere in the LUT, 3 terms
        idx = rng.integers(0, gx.lut.shape[1], 5 * 4 * gx.num_chunks)
        shape = ((1, 2, 2), (False, True, False), (False, True))
        got = K.fused_compound_banked(gx.lut, idx.astype(np.int32),
                                      gx.num_chunks, *shape)
        want = ref.fused_compound_banked_ref(gx.lut, idx, gx.num_chunks,
                                             *shape)
        same(got[0], want[0], "compound bitmap, random rows")
        same(got[1], want[1], "compound count, random rows")
        # 40 terms (beyond the former limit of 32); at 32 bits / 8 chunks
        # also 400 terms (12,800 indices, beyond the former 12,288) and
        # 1,000 terms (the term program read from device memory)
        for n_terms, one_range in ((40, False), (400, True), (1000, True)):
            if one_range and c != 8:
                continue
            shape = random_terms(n_terms, one_range)
            rr = [ranges[int(i)] for i in rng.integers(0, len(ranges),
                                                       sum(shape[0]))]
            idx = np.concatenate([gx._range_idx(*r) for r in rr])
            got = K.fused_compound_banked(gx.lut, idx, gx.num_chunks, *shape)
            want = ref.fused_compound_banked_ref(gx.lut, idx, gx.num_chunks,
                                                 *shape)
            same(got[0], want[0], f"compound bitmap, {n_terms} terms")
            same(got[1], want[1], f"compound count, {n_terms} terms")

    # the row gather of merge_kernel and compound_kernel (csrc/clutch.cuh
    # :: merge_side) on random LUTs: every templated chunk count (1, 5,
    # 8) and the generic one (2, 3, 4, 6, 16); W % 4 == 0 (16-byte row loads), W % 4 != 0 and a view
    # one word off the 16-byte grid (4-byte loads); indices drawn mostly
    # from a few rows, so steps with lt == le, runs of one row and other
    # repeats occur, some on the card outside [0, R) (clamped by the
    # kernel; the plain versions are given them clamped); bank 0 names
    # one row only (an always-true bank)
    def gather_idx(shape, r):
        n = int(np.prod(shape))
        pool = rng.integers(0, r, 4)
        x = np.where(rng.random(n) < 0.6, rng.choice(pool, n),
                     rng.integers(-2, r + 2, n))
        return torch.from_numpy(x.astype(np.int32).reshape(shape)).to(cuda)

    def word_lut(shape, off=0):
        n = int(np.prod(shape))
        flat = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n + off)
                                .astype(np.int32)).to(cuda)
        return flat[off:].view(*shape)

    for c in (1, 2, 3, 4, 5, 6, 8, 16):
        r = 2 * c + 3
        for b, w, off in ((3, 8, 0), (2, 1001, 0), (2, 4096, 1),
                          (1, 5000, 0), (5, 3, 0)):
            lut = word_lut((b, r, w), off)
            agree(quad_rows(lut) == (w % 4 == 0 and off == 0),
                  f"gather route W={w} offset={off}")
            lt, le = gather_idx((b, c), r), gather_idx((b, c), r)
            lt[0], le[0] = lt[0, 0].clamp(0, r - 1), lt[0, 0].clamp(0, r - 1)
            lt_c, le_c = lt.clamp(0, r - 1), le.clamp(0, r - 1)
            what = f"C={c} B={b} W={w} offset={off}"
            same(K.clutch_merge_banked(lut, lt, le),
                 ref.clutch_merge_banked_ref(lut, lt_c, le_c),
                 f"clutch_merge_banked {what}")
            same(K.clutch_merge(lut[-1], lt[-1], le[-1]),
                 ref.clutch_merge_ref(lut[-1], lt_c[-1], le_c[-1]),
                 f"clutch_merge {what}")
            lut = word_lut((b, 4 * c, w), off)
            for n_terms in (1, 3, 40):
                shape = random_terms(n_terms)
                idx = gather_idx((sum(shape[0]) * 4 * c,), 4 * c)
                got = K.fused_compound_banked(lut, idx, c, *shape)
                want = ref.fused_compound_banked_ref(
                    lut, idx.clamp(0, 4 * c - 1), c, *shape)
                same(got[0], want[0], f"compound bitmap {n_terms} {what}")
                same(got[1], want[1], f"compound count {n_terms} {what}")
    # 70,000 banks of a narrow LUT (beyond a grid's y dimension), with
    # 4-byte and 16-byte row loads
    for w in (3, 4):
        lut = word_lut((70_000, 13, w))
        lt, le = gather_idx((70_000, 5), 13), gather_idx((70_000, 5), 13)
        same(K.clutch_merge_banked(lut, lt, le),
             ref.clutch_merge_banked_ref(lut, lt.clamp(0, 12),
                                         le.clamp(0, 12)),
             f"clutch_merge_banked 70,000 banks W={w}")
    del lut, lt, le, lt_c, le_c, idx

    # GBDT leaf bits: 8/16-bit, a narrowed plan, the always-true -1
    for n_bits, c, plan in ((8, 1, None), (16, 2, None),
                            (16, 3, ColumnPlan(10, 3))):
        f = G.ObliviousForest.random(37, 5, 6, plan.n_bits if plan
                                     else n_bits, seed=n_bits)
        f.n_bits = n_bits
        gx = FusedGbdtExec(f, c, plan=plan, device=cuda)
        X = rng.integers(0, 1 << n_bits, (70, 6), dtype=np.uint64)
        X[0], X[1] = 0, (1 << n_bits) - 1
        expect(np.array_equal(gx.leaf_addrs(X),
                              G.reference_leaf_addrs(f, X)),
               f"leaf addresses {n_bits}-bit plan={plan}")
        n_checks += 1
        a = rng.integers(-1, 1 << gx.plan.n_bits, 70 * 6).astype(np.int64)
        a[:6] = -1
        lt, le = ops.resolve_indices_banked(gx.plan, a)
        lt, le = lt.reshape(70, 6, -1), le.reshape(70, 6, -1)
        idx = np.concatenate([lt, le], axis=2).reshape(70, -1)
        same(K.gbdt_leafbits_banked(gx.lut, gx.masks, idx, gx.num_chunks, 6),
             ref.gbdt_leafbits_banked_ref(gx.lut, gx.masks,
                                          torch.from_numpy(idx).to(cuda),
                                          gx.num_chunks, 6),
             f"leaf bits with -1 lanes {n_bits}-bit")

    # GBDT leaf bits on random LUTs, both layouts of leafbits_kernel
    # (fused_query.leafbits_layout): B not a multiple of the 16-instance
    # group, B = 1, W not a multiple of the 64-word slice, masks zero on
    # whole slices (skipped features), row indices on the card outside
    # [0, R) (clamped by the kernel; the plain version is given them
    # clamped), 2C = 64 index slots, features staged in several passes,
    # 12,864 indices an instance; R = 1000 and R = 2000 read their rows
    # from global memory
    for b, w, r, c, f in ((70, 100, 264, 1, 28), (1, 256, 264, 1, 28),
                          (37, 33, 1000, 2, 6), (45, 130, 2000, 3, 5),
                          (200, 64, 40, 32, 2), (300, 70, 50, 2, 40),
                          (16, 1, 9, 1, 3), (20, 64, 40, 32, 201)):
        lut = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (r, w))
                               .astype(np.int32)).to(cuda)
        masks = rng.integers(-2 ** 31, 2 ** 31, (f + 3, w)).astype(np.int32)
        masks[:, 64:] = 0
        masks = torch.from_numpy(masks).to(cuda)
        idx = torch.from_numpy(rng.integers(-2, r + 2, (b, f * 2 * c))
                               .astype(np.int32)).to(cuda)
        same(K.gbdt_leafbits_banked(lut, masks, idx, c, f),
             ref.gbdt_leafbits_banked_ref(lut, masks, idx.clamp(0, r - 1),
                                          c, f),
             f"leaf bits B={b} W={w} R={r} C={c} F={f}")

    # compare kernels and front-ends: 8/16/32-bit plans, N not a multiple
    # of 32, W not a power of two (12001 -> 384 words)
    for n_bits, c, n in ((8, 1, 1000), (8, 2, 12001), (16, 2, 4097),
                         (16, 4, 999), (32, 5, 12001), (32, 8, 5001)):
        mx = (1 << n_bits) - 1
        plan = make_plan(n_bits, c)
        v = rng.integers(0, 1 << n_bits, n, dtype=np.uint64).astype(np.uint32)
        v[:2] = [0, mx]
        if n_bits == 32:
            v[2] = 1 << 31
        vt = torch.from_numpy(v.view(np.int32)).to(cuda)
        scalars = [0, 1, 1 << (n_bits - 1), mx - 1, mx,
                   int(rng.integers(0, mx))]
        if n_bits == 32:
            scalars.append(3_000_000_000)
        lut = ops.encode_lut(vt, plan)
        for a in scalars:
            lt, le = ops.resolve_indices(plan, a)
            same(K.clutch_merge(lut, lt, le),
                 ref.clutch_merge_ref(lut, lt, le),
                 f"clutch_merge {n_bits}/{c} n={n} a={a}")
            agree(np.array_equal(ops.clutch_compare(vt, a, plan).cpu().numpy(),
                                 v.astype(np.int64) > a),
                  f"clutch_compare {n_bits}/{c} n={n} a={a}")
        # bit-serial: scalars with bits above n_bits read only the low bits
        planes = ops.encode_bitplanes(vt, n_bits)
        above = [0xFFFFFFFF] + ([(mx + 1) | 5] if n_bits < 32 else [])
        for a in scalars + above:
            got = K.bitserial_cmp(planes, a, n_bits)
            same(got, ref.bitserial_cmp_ref(planes, a, n_bits),
                 f"bitserial_cmp {n_bits} n={n} a={a}")
            bits = unpack_bits_torch(got, n).bool().cpu().numpy()
            agree(np.array_equal(bits, v.astype(np.int64) > (a & mx)),
                  f"bitserial_compare {n_bits} n={n} a={a}")
        # banked: three banks, one always true (-1)
        vb = rng.integers(0, 1 << n_bits, (3, n), dtype=np.uint64
                          ).astype(np.uint32)
        vbt = torch.from_numpy(vb.view(np.int32)).to(cuda)
        a = np.array([-1, mx, int(rng.integers(0, mx))], np.int64)
        blt, ble = ops.resolve_indices_banked(plan, a)
        luts = torch.stack([ops.encode_lut(x, plan) for x in vbt])
        same(K.clutch_merge_banked(luts, blt, ble),
             ref.clutch_merge_banked_ref(luts, blt, ble),
             f"clutch_merge_banked {n_bits}/{c} n={n}")
        agree(np.array_equal(
            ops.clutch_compare_banked(vbt, a, plan).cpu().numpy(),
            vb.astype(np.int64) > a[:, None]),
            f"clutch_compare_banked {n_bits}/{c} n={n}")
        # range count over the normal and complement LUTs
        lut_c = ops.encode_lut(vt, plan, complement=True)
        for x0, x1 in ((0, mx), (mx - 1, mx), (0, 1), (mx // 5, 4 * mx // 5),
                       (1 << (n_bits - 1), mx)):
            idx = np.concatenate(ops.resolve_indices(plan, x0)
                                 + ops.resolve_indices(plan, mx - x1))
            got = K.fused_range_count(lut, lut_c, idx, c)
            want = ref.fused_range_count_ref(lut, lut_c, idx, c)
            same(got[0], want[0], f"range_count bitmap {n_bits} ({x0}, {x1})")
            same(got[1], want[1], f"range_count count {n_bits} ({x0}, {x1})")
            agree(int(got[1]) == int(((v > x0) & (v < x1)).sum()),
                  f"range_count vs NumPy {n_bits} ({x0}, {x1})")

    # leaf_gather at the boundaries of its tiling (one lane per instance,
    # 256 instances a block, 32-tree tiles): B below, at and past a warp
    # and past a block; T below, at, off and past the tile and the 4-tree
    # chunk (T % 4 != 0 takes the 4-byte route); L = 1, 2 and 64 (leaves
    # staged) and 65, 128 (leaves through L1); and the three shapes held
    # here before (L = 32 among them).  Each case: within
    # LEAF_TOL of the plain version, two launches bit-equal, and
    # addresses -1 and >= L add nothing (with B >= 3 rows 0 and 1 are all
    # -1 and all L; every out-of-range address swapped for another leaves
    # the bits).
    g = torch.Generator(cuda).manual_seed(0)
    big = 2 ** 16 + 5
    cases = [(b, t, nl) for nl in (1, 2, 64) for t in (1, 3, 4, 5, 7, 130,
                                                        1000, 1001)
             for b in (1, 31, 33, big)]
    cases += [(33, 7, 65), (big, 130, 65), (31, 1000, 128), (77, 1001, 128),
              (33, 7, 32), (1000, 130, 64), (77, 1000, 64)]
    for b, t, nl in cases:
        at = torch.randint(-1, nl + 3, (b, t), generator=g, device=cuda,
                           dtype=torch.int32)
        if b >= 3:
            at[0], at[1] = -1, nl
        lv = torch.randn((t, nl), generator=g, device=cuda)
        got = K.leaf_gather(at, lv)
        err = max_abs_err(torch, got, ref.leaf_gather_ref(at, lv))
        what = f"leaf_gather B={b} T={t} L={nl}"
        agree(err <= LEAF_TOL, f"{what}: {err}")
        agree(torch.equal(got, K.leaf_gather(at, lv)),
              f"{what}: two launches differ")
        swapped = torch.where(at < 0, nl + 7, torch.where(at >= nl, -1, at))
        agree(same_bits(torch, K.leaf_gather(swapped, lv), got)
              and (b < 3 or float(got[0]) == float(got[1]) == 0.0),
              f"{what}: addresses -1 and >= L add something")
        del at, swapped
    # the routes give the same bits: the 4-byte route on an unaligned view
    # of aligned rows, and the leaves read through L1 (one zero column
    # more: L = 65) against staged
    for b, t in ((33, 1000), (big, 1000), (300, 4)):
        at = torch.randint(-1, 65, (b, t), generator=g, device=cuda,
                           dtype=torch.int32)
        lv = torch.randn((t, 64), generator=g, device=cuda)
        want = K.leaf_gather(at, lv)
        flat = torch.empty(b * t + 1, dtype=torch.int32, device=cuda)
        flat[1:] = at.reshape(-1)
        view = flat[1:].view(b, t)
        agree(leaf_route(t, 64, at.data_ptr()) == (True, True)
              and leaf_route(t, 64, view.data_ptr()) == (False, True),
              f"leaf_gather routes B={b} T={t}")
        agree(same_bits(torch, K.leaf_gather(view, lv), want),
              f"leaf_gather B={b} T={t}: 4-byte route on an unaligned view")
        lv65 = torch.nn.functional.pad(lv, (0, 1))
        agree(same_bits(torch, K.leaf_gather(at, lv65), want),
              f"leaf_gather B={b} T={t}: leaves through L1 vs staged")
        del at, flat, view

    # gbdt_leafbits_sum: predictions from random leaf bits, bit for bit
    # against its plain version on the card and assemble_leaves over the
    # same addresses on the host; B within, at and past a 32-instance
    # round and a block's most instances (256), T below 8, past one
    # 128-tree block and the cells' 1000 (1001: a tail of 1), depth 1 and
    # 6-8 (L 128 and 256: leaves through L1); then a table one leaf
    # wider (65 a tree: through L1) and an unaligned view of the leaves
    # (4-byte staging) against the staged 16-byte route; and 20,000
    # trees, past NumPy's 8,192-value buffer, where NumPy versions sum in
    # two orders (ref.numpy_row_run)
    cases = [(b, t, d) for b in (1, 31, 256, big)
             for t in (1, 129, 1000, 1001) for d in (1, 6, 7, 8)]
    for b, t, d in cases + [(31, 20_000, 6)]:
        at, lv, bm = leafsum_case(torch, g, b, t, d)
        got = K.gbdt_leafbits_sum(bm, lv, t, d)
        what = f"gbdt_leafbits_sum B={b} T={t} D={d}"
        agree(same_bits(torch, got, ref.gbdt_leafbits_sum_ref(
            bm, lv, t, d)), f"{what} vs its plain version")
        agree(got.cpu().numpy().tobytes() == G.assemble_leaves(
            lv.cpu().numpy(), at.cpu().numpy()).tobytes(),
            f"{what} vs assemble_leaves")
        if d == 6 and t == 1000 and b in (31, big):
            lv65 = torch.nn.functional.pad(lv, (0, 1))
            agree(same_bits(torch, K.gbdt_leafbits_sum(
                bm, lv65, t, d), got), f"{what}: L = 65 vs staged")
            flat = torch.empty(t * 64 + 1, device=cuda)
            flat[1:] = lv.reshape(-1)
            agree(same_bits(torch, K.gbdt_leafbits_sum(
                bm, flat[1:].view(t, 64), t, d), got),
                f"{what}: unaligned leaves vs aligned")
        del at, lv, bm, got

    # minp_mask: +-0, +-NaN, +-inf, denormals, tau equal to a logit; V not
    # a multiple of 4 (rows off the 16-byte grid), an unaligned view, and
    # every chunking the kernel takes; compared as bit patterns (NaN)
    for b, v in MINP_EDGE_SHAPES:
        x, tau = minp_edge_batch(rng, b, v)
        xt, tt = torch.from_numpy(x).to(cuda), torch.from_numpy(tau).to(cuda)
        for chunks in ((8, 8, 8, 8), (16, 16), (32,), (4,) * 8,
                       (5, 7, 9, 11)):
            agree(same_bits(torch, K.minp_mask(xt, tt, chunks),
                            ref.minp_mask_ref(xt, tt, chunks)),
                  f"minp_mask {b}x{v} chunks={chunks}")
        flat = torch.empty(b * v + 1, device=cuda)
        flat[1:] = xt.reshape(-1)
        agree(same_bits(torch, K.minp_mask(flat[1:].view(b, v), tt),
                        ref.minp_mask_ref(xt, tt)),
              f"minp_mask {b}x{v} from an unaligned view")
        agree(same_bits(torch, ops.sample_threshold_mask(x, tau),
                        ref.minp_mask_ref(xt, tt)),
              f"sample_threshold_mask {b}x{v} on NumPy input")
    return n_checks + check_selective_scan(torch) + check_rmsnorm(torch)


# --------------------------------------------------------------------- #
# Phases 3-4: the main path through the session
# --------------------------------------------------------------------- #

def table_queries(Q, mx: int):
    qa = dict(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
              y1=3 * mx // 4)
    qb = dict(fi=2, x0=mx // 3, x1=mx, fj=5, y0=0, y1=mx // 5)
    return [
        ("Q1", Q.Q1(fi=0, x0=mx // 8, x1=mx // 2)),
        ("Q2", Q.Q2(**qa)),
        ("Q3", Q.Q3(**qa)),
        ("Q4", Q.Q4(fk=2, **qa)),
        ("Q5", Q.Q5(fl=3, fk=2, **qa)),
        ("Compound(Q1 and Q3)", Q.Compound(
            (Q.Q1(fi=4, x0=mx // 10, x1=9 * mx // 10), Q.Q3(**qb)),
            ("and",))),
        ("Compound(Q1 or Q2 and Q3), count", Q.Compound(
            (Q.Q1(fi=6, x0=0, x1=mx // 16), Q.Q2(**qa), Q.Q3(**qb)),
            ("or", "and"), count=True)),
    ]


def run_table_path(torch, report):
    import repro_torch.kernels as K
    from repro_torch.apps.predicate import Table
    from repro_torch.pud import PudSession, queries as Q

    t0 = time.perf_counter()
    table = Table.generate(2 ** 25, 32, num_features=8, seed=0)
    report["table_generate_s"] = time.perf_counter() - t0
    session = PudSession(backend="fused")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    handle = session.create_table(table, name="lineitem_like")
    torch.cuda.synchronize()
    report["table_build_s"] = time.perf_counter() - t0
    jobs = []
    for name, q in table_queries(Q, (1 << 32) - 1):
        job = session.query(handle, q)
        jobs.append((name, q, job))
    counts = K.launch_counts()
    ex = session.executor(handle)
    report["table"] = {
        "records": table.num_records, "n_bits": 32, "features": 8,
        "shards": ex.num_shards, "chunks": ex.num_chunks,
        "lut_shape": list(ex.lut.shape),
        "lut_gb": ex.lut.numel() * 4 / 1e9,
        "launches": counts,
        "queries": {},
    }
    for name, q, job in jobs:
        want = q.reference(table)
        got = job.result
        if isinstance(want, np.ndarray):
            expect(np.array_equal(got, want), f"{name} bitmap")
            summary = int(got.sum())
        else:
            expect(q.check(table, got), f"{name}: {got} vs {want}")
            summary = got
        report["table"]["queries"][name] = {
            "wallclock_ms": job.wallclock_ns / 1e6, "result": summary}
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked"):
        expect(counts[k] > 0, f"{k} not launched on the table path")
    return session, handle, counts


def run_gbdt_path(torch, report):
    import repro_torch.kernels as K
    from repro_torch import tracing
    from repro_torch.apps import gbdt as G
    from repro_torch.pud import PudSession

    forest = G.ObliviousForest.random(num_trees=1000, depth=6,
                                      num_features=28, n_bits=8, seed=0)
    X = np.random.default_rng(1).integers(0, 256, (2 ** 16, 28),
                                          dtype=np.uint64)
    session = PudSession(backend="fused")
    K.reset_launch_counts()
    handle = session.load_forest(forest, name="higgs_like")
    job = session.predict(handle, X)
    counts = K.launch_counts()
    for k in ("temporal_encode", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched on the GBDT path")
    # the predictions are summed on the card, one launch a predict call
    expect(tracing.counters()["launch.gbdt_leafbits_sum"] > 0,
           "gbdt_leafbits_sum not launched on the GBDT path")
    ex = session.executor(handle)
    # reference_leaf_addrs returns a Fortran-ordered array, and NumPy's
    # float32 sum in assemble_leaves rounds differently along a strided
    # axis; the port and the reference's executors both hold C-ordered
    # addresses, so the bit-exact check feeds C-ordered ones
    addrs = np.ascontiguousarray(np.concatenate(
        [G.reference_leaf_addrs(forest, X[i:i + 8192])
         for i in range(0, X.shape[0], 8192)]))
    got_addrs = ex.leaf_addrs(X)
    expect(np.array_equal(got_addrs, addrs), "leaf addresses")
    expect(np.array_equal(job.result,
                          G.assemble_leaves(forest.leaves, addrs)),
           "predictions bit-equal to assemble_leaves")
    # reference_predict sums the 1000 trees in another order, so float32
    # rounding differs: agreement within 1e-3 is all it can give
    want = G.reference_predict(forest, X)
    err = float(np.abs(job.result - want).max())
    expect(err <= 1e-3, f"predictions vs reference_predict: {err}")
    report["gbdt"] = {
        "trees": 1000, "depth": 6, "features": 28, "n_bits": 8,
        "instances": X.shape[0], "chunks": ex.num_chunks,
        "lut_shape": list(ex.lut.shape),
        "masks_shape": list(ex.masks.shape),
        "predict_wallclock_ms": job.wallclock_ns / 1e6,
        "max_abs_err_vs_reference_predict": err,
        "launches": counts,
    }
    return session, handle, X, got_addrs, job.result, counts


# --------------------------------------------------------------------- #
# Phase 5: the kernel front-ends at full width
# --------------------------------------------------------------------- #

def run_front_ends(torch, table, q1_count, forest, addrs, predictions,
                   report):
    """Drive the front-ends of ``repro_torch.kernels.ops`` on phase 3's
    column 0 and phase 4's forest and leaf addresses; each result is
    checked against NumPy or against the session's own result."""
    import repro_torch.kernels as K
    from repro_torch.apps.predicate import reference_q1
    from repro_torch.core.encoding import make_plan
    from repro_torch.kernels import ops

    cuda = torch.device("cuda")
    col = table.features[0]
    wall = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        return out

    K.reset_launch_counts()
    for n_bits, c in COMPARE_PLANS:
        v, vt = column_bits(torch, col, n_bits)
        a, plan = 1 << (n_bits - 1), make_plan(n_bits, c)
        got = timed(f"clutch_compare {n_bits}/{c}",
                    lambda: ops.clutch_compare(vt, a, plan))
        expect(np.array_equal(got.cpu().numpy(), v > a),
               f"clutch_compare {n_bits}/{c} vs NumPy")
        del got
        lut = ops.encode_lut(vt, plan)
        words = ops.compare_gt_scalar(lut, *ops.resolve_indices(plan, a))
        del lut                           # 1-2 GB: free before the next
        planes = timed(f"encode_bitplanes {n_bits}",
                       lambda: ops.encode_bitplanes(vt, n_bits))
        bits = timed(f"bitserial_compare {n_bits}",
                     lambda: ops.bitserial_compare(planes, a, n_bits))
        expect(torch.equal(words, bits),
               f"bitserial_compare {n_bits} vs compare_gt_scalar words")
        del planes, words, bits, vt

    # two banks of 2^24 records, the second always true
    v, vt = column_bits(torch, col, 32)
    vb, vbt = v.reshape(2, -1), vt.view(2, -1)
    a = np.array([1 << 31, -1], np.int64)
    got = timed("clutch_compare_banked 32/5",
                lambda: ops.clutch_compare_banked(vbt, a, make_plan(32, 5)))
    got = got.cpu().numpy()
    expect(np.array_equal(got[0], vb[0] > (1 << 31)),
           "clutch_compare_banked bank 0 vs NumPy")
    expect(got[1].all(), "clutch_compare_banked: the -1 bank is not all true")
    del vbt, got

    # Q1 of phase 3 as one fused range count on column 0, 32 bits / 8
    mx = (1 << 32) - 1
    x0, x1 = mx // 8, mx // 2
    plan = make_plan(32, 8)
    lut = ops.encode_lut(vt, plan)
    lut_c = ops.encode_lut(vt, plan, complement=True)
    idx = np.concatenate(ops.resolve_indices(plan, x0)
                         + ops.resolve_indices(plan, mx - x1))
    _, cnt = timed("range_count 32/8",
                   lambda: ops.range_count(lut, lut_c, idx, 8))
    want = int(reference_q1(table, 0, x0, x1).sum())
    expect(int(cnt) == want, f"range_count {int(cnt)} vs reference {want}")
    expect(int(cnt) == q1_count,
           f"range_count {int(cnt)} vs phase 3's Q1 bitmap {q1_count}")
    del vt, lut, lut_c

    # phase 4's leaf addresses summed on the card
    at = torch.from_numpy(addrs).to(cuda)
    lv = torch.from_numpy(forest.leaves).to(cuda)
    pred = timed("gbdt_leaf_sum", lambda: ops.gbdt_leaf_sum(at, lv))
    expect(torch.equal(pred, ops.gbdt_leaf_sum(at, lv)),
           "gbdt_leaf_sum: two launches differ")
    err = float(np.abs(pred.cpu().numpy() - predictions).max())
    expect(err <= 1e-3, f"gbdt_leaf_sum vs assemble_leaves: {err}")

    counts = K.launch_counts()
    for k in ("clutch_merge", "clutch_merge_banked", "fused_range_count",
              "bitserial_cmp", "leaf_gather"):
        expect(counts[k] > 0, f"{k} not launched on the front-end path")
    report["front_ends"] = {
        "records": int(col.shape[0]), "wallclock_ms": wall,
        "range_count": int(cnt),
        "gbdt_leaf_sum_max_abs_err_vs_assemble_leaves": err,
        "launches": counts,
    }
    return counts


# --------------------------------------------------------------------- #
# Phase 6: LM serving at full width
# --------------------------------------------------------------------- #

def run_lm_path(torch, report):
    """Serve ``minitron-8b`` at full width (bf16, random weights from a
    seed) through ``ServeEngine`` with the min-p sampler on the
    ``minp_mask`` kernel; check decode against forward and the sampler
    on a decode step's logits.  Returns the launch counts of the engine
    run and one decode step's [8, V] logits with their thresholds."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import lm as M
    from repro_torch.serve.engine import (
        Request,
        SamplerConfig,
        ServeEngine,
        gumbel_max,
        threshold_mask,
    )

    cuda = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = param_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    expect(all(t.dtype == torch.bfloat16 and t.is_cuda for t in leaves),
           "minitron-8b parameters are not bf16 on the card")
    expect(abs(n_params - 7.73e9) < 0.01e9, f"{n_params} parameters")

    # the engine run: 16 equal-length prompts, so each request decodes at
    # its own positions (every slot decodes at the largest position)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, LM_PROMPT)
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for i in range(LM_REQUESTS)]
    sc = SamplerConfig()
    eng = ServeEngine(cfg, params, num_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      sc=sc)
    cache_bytes = sum(t.numel() * t.element_size()
                      for blk in eng.cache.values() for t in blk.values())
    prefill_ms, step_ms = [], []

    eng.add_request = timed_calls(torch, eng.add_request, prefill_ms)
    eng.step = timed_calls(torch, eng.step, step_ms)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = K.launch_counts()
    expect(sorted(r.rid for r in done) == list(range(LM_REQUESTS)),
           "not every request finished")
    for r in done:
        expect(len(r.out_tokens) == LM_NEW and
               all(0 <= t < cfg.vocab for t in r.out_tokens),
               f"request {r.rid}: {len(r.out_tokens)} tokens, "
               f"range [{min(r.out_tokens)}, {max(r.out_tokens)}]")
    expect(counts["minp_mask"] == len(step_ms) > 0,
           f"minp_mask launched {counts['minp_mask']} times in "
           f"{len(step_ms)} decode steps")
    tokens = sum(len(r.out_tokens) for r in done)

    # decode against forward in bf16: 2 prompts of 255 tokens, prefill
    # 254, decode position 254.  Both run 32 bf16 layers, with the
    # activations rounded at other places (batched GEMMs of 254 rows
    # against GEMVs of 2) and the logits rounded to bf16 in lm_head,
    # where one ulp is 2^-4 at magnitudes 8-16: they agree to a few
    # ulps, not bit for bit.
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, LM_PROMPT - 1))).to(cuda)
    full = M.forward_logits(cfg, params, {"tokens": toks})[:, -1]
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :-1]},
                         max_len=LM_MAX_LEN)
    step, _ = M.decode_step(cfg, params, cache, toks[:, -1:],
                            LM_PROMPT - 2)
    del cache
    diff = (step[:, 0] - full).abs()
    scale = float(full.abs().max())
    dec_err, dec_mean = float(diff.max()), float(diff.mean())
    expect(dec_err <= DECODE_TOL * scale and dec_mean <= DECODE_MEAN_TOL
           * scale, f"decode vs forward: max {dec_err}, mean {dec_mean}, "
           f"largest logit {scale}")
    same_argmax = (step[:, 0].argmax(-1) == full.argmax(-1)).tolist()
    del full, step

    # the sampler on a decode step's [8, V] logits: the next step of the
    # served cache, fed the last requests' last tokens
    last = torch.from_numpy(np.array(
        [[r.out_tokens[-1]] for r in done[-LM_SLOTS:]])).to(cuda)
    pos = LM_PROMPT - 1 + LM_NEW
    logits, _ = M.decode_step(cfg, params, eng.cache, last, pos)
    logits = logits[:, 0].contiguous()
    expect(not bool(torch.isnan(logits).any())
           and not bool((logits == 0).any()),
           "these logits hold a NaN or a zero: the float comparison "
           "would differ from the kernel")
    tau, masked = threshold_mask(logits, sc)
    expect(same_bits(torch, masked, ref.minp_mask_ref(logits, tau)),
           "minp_mask vs its plain version on real logits")
    expect(same_bits(torch, masked, torch.where(
        logits >= tau[:, None], logits, ref.MINP_FILL)),
        "minp_mask vs the float comparison on real logits")
    kept = masked > ref.MINP_FILL
    g = torch.Generator("cuda").manual_seed(0)
    draws = torch.stack([gumbel_max(masked, g)
                         for _ in range(LM_DRAWS // LM_SLOTS)])
    expect(bool(kept.gather(1, draws.T).all()),
           "a draw landed outside the kept set")

    step_sorted = sorted(step_ms)
    report["lm"] = {
        "arch": LM_ARCH, "dtype": "bfloat16", "params": n_params,
        "param_gb": param_bytes / 1e9, "kv_cache_gb": cache_bytes / 1e9,
        "init_s": init_s, "requests": LM_REQUESTS, "prompt": LM_PROMPT,
        "new_tokens": LM_NEW, "slots": LM_SLOTS, "max_len": LM_MAX_LEN,
        "engine_s": run_s, "tokens": tokens, "tok_per_s": tokens / run_s,
        "decode_steps": len(step_ms),
        "decode_step_ms_median": float(np.median(step_ms)),
        "decode_step_ms_min_max": [step_sorted[0], step_sorted[-1]],
        "prefill_ms_median": float(np.median(prefill_ms)),
        "prefill_ms_min_max": [min(prefill_ms), max(prefill_ms)],
        "decode_vs_forward_max_abs_err": dec_err,
        "decode_vs_forward_mean_abs_err": dec_mean,
        "largest_logit": scale, "decode_forward_same_argmax": same_argmax,
        "kept_per_row": kept.sum(-1).tolist(),
        "draws": int(draws.numel()),
        "peak_gb_lm_phase": torch.cuda.max_memory_allocated() / 1e9,
        "launches": counts,
    }
    report["lm"]["device_busy"] = profile_decode_step(
        torch, lambda: M.decode_step(cfg, params, eng.cache, last, pos))
    del eng, params
    free(torch)
    return counts, logits, tau


def timed_calls(torch, fn, into: list):
    """``fn`` wrapped to append each call's wall-clock ms, between two
    synchronises, to ``into``."""
    def run(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t) * 1e3)
        return out
    return run


def profile_decode_step(torch, fn, reps: int = 5, ops: int = 0) -> dict:
    """One step (a decode step, or a train step) under
    ``torch.profiler``: the kernels' summed device time against the
    step's wall-clock (median of ``reps`` unprofiled steps), the five
    largest device-time entries and, if ``ops``, the ``ops`` PyTorch
    operators whose kernels took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        t_trace = time.perf_counter()
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    expect(device_ms > 0, "the profiler saw no device time")
    wall = float(np.median(walls))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    out = {"step_wall_ms": wall, "device_ms": device_ms,
           "device_idle_share": max(0.0, 1 - device_ms / wall),
           "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                   for e in top]}
    if ops:
        cpu = sorted((e for e in averages if e.device_type.name == "CPU"),
                     key=lambda e: -e.self_device_time_total)[:ops]
        out["top_ops"] = [[e.key, e.self_device_time_total / 1e3, e.count]
                          for e in cpu]
    # the host seconds the trace took to collect and sum, after the step
    out["trace_s"] = time.perf_counter() - t_trace
    return out


# --------------------------------------------------------------------- #
# Phase 7: the MoE, RWKV, hybrid and encoder-decoder archs
# --------------------------------------------------------------------- #

def param_leaves(tree) -> list:
    out = []
    for v in tree.values():
        out.extend(param_leaves(v) if isinstance(v, dict) else [v])
    return out


def free(torch) -> None:
    """Return the memory of dropped models to the card (an engine whose
    methods were wrapped for timing holds itself in a cycle)."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def decode_vs_forward(torch, step, full, vocab: int, what: str,
                      f32: bool = False) -> dict:
    """A decode step's logits [B, V_pad] against the forward's at the
    same position, over the ``vocab`` real logits (the padding ones are
    -2e38 in both), within a tolerance of the largest: phase 6's bf16
    one, or the float32 one."""
    step, full = step[:, :vocab], full[:, :vocab]
    diff = (step - full).abs()
    scale = float(full.abs().max())
    err, mean = float(diff.max()), float(diff.mean())
    tol, mean_tol = ((F32_DECODE_TOL, F32_DECODE_MEAN_TOL) if f32
                     else (DECODE_TOL, DECODE_MEAN_TOL))
    expect(err <= tol * scale and mean <= mean_tol * scale,
           f"{what}: decode vs forward max {err}, mean {mean}, largest "
           f"logit {scale}")
    return {"max_abs_err": err, "mean_abs_err": mean, "largest_logit": scale,
            "same_argmax": (step.argmax(-1) == full.argmax(-1)).tolist()}


def serve_arch(torch, arch: str, layers: int | None, n_expected: int,
               check_dtype: str) -> tuple[dict, dict]:
    """Serve ``arch`` at full width (``layers`` kept, if cut) through
    ``ServeEngine`` with the min-p sampler on the ``minp_mask`` kernel;
    check the mask on a decode step's logits, then decode against
    forward in ``check_dtype``.  Returns (the arch's report, the engine
    run's launch counts)."""
    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import lm as M
    from repro_torch.serve.engine import (
        Request,
        SamplerConfig,
        ServeEngine,
        threshold_mask,
    )

    cuda = torch.device("cuda")
    cfg = get_config(arch)
    rep: dict = {"arch": arch, "dtype": "bfloat16", "reduced": {}}
    if layers is not None:
        rep["reduced"] = {"num_layers": [cfg.num_layers, layers]}
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    leaves = param_leaves(params)
    rep["params"] = sum(t.numel() for t in leaves)
    rep["param_gb"] = sum(t.numel() * t.element_size() for t in leaves) / 1e9
    expect(all(t.is_cuda for t in leaves) and rep["params"] == n_expected,
           f"{arch}: {rep['params']} parameters, expected {n_expected}")
    del leaves

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, ARCH_PROMPT)
                    .astype(np.int32), max_new_tokens=ARCH_NEW)
            for i in range(ARCH_REQUESTS)]
    sc = SamplerConfig()
    eng = ServeEngine(cfg, params, num_slots=ARCH_SLOTS,
                      max_len=ARCH_MAX_LEN, sc=sc)
    prefill_ms, step_ms = [], []

    eng.add_request = timed_calls(torch, eng.add_request, prefill_ms)
    eng.step = timed_calls(torch, eng.step, step_ms)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = K.launch_counts()
    rep["peak_gb_serving"] = torch.cuda.max_memory_allocated() / 1e9
    expect(sorted(r.rid for r in done) == list(range(ARCH_REQUESTS)),
           f"{arch}: not every request finished")
    for r in done:
        expect(len(r.out_tokens) == ARCH_NEW and
               all(0 <= t < cfg.vocab for t in r.out_tokens),
               f"{arch} request {r.rid}: {len(r.out_tokens)} tokens")
    expect(counts["minp_mask"] == len(step_ms) > 0,
           f"{arch}: minp_mask launched {counts['minp_mask']} times in "
           f"{len(step_ms)} decode steps")
    tokens = sum(len(r.out_tokens) for r in done)

    # the mask on the next decode step of the served cache
    last = torch.from_numpy(np.array(
        [[r.out_tokens[-1]] for r in done[-ARCH_SLOTS:]])).to(cuda)
    pos = ARCH_PROMPT - 1 + ARCH_NEW
    logits, _ = M.decode_step(cfg, params, eng.cache, last, pos)
    logits = logits[:, 0].contiguous()
    tau, masked = threshold_mask(logits, sc)
    expect(same_bits(torch, masked, ref.minp_mask_ref(logits, tau)),
           f"{arch}: minp_mask vs its plain version on real logits")
    step_sorted = sorted(step_ms)
    rep.update({
        "requests": ARCH_REQUESTS, "prompt": ARCH_PROMPT,
        "new_tokens": ARCH_NEW, "slots": ARCH_SLOTS,
        "max_len": ARCH_MAX_LEN, "mask_shape": list(logits.shape),
        "engine_s": run_s, "tokens": tokens, "tok_per_s": tokens / run_s,
        "decode_steps": len(step_ms),
        "decode_step_ms_median": float(np.median(step_ms)),
        "decode_step_ms_min_max": [step_sorted[0], step_sorted[-1]],
        "prefill_ms_median": float(np.median(prefill_ms)),
        "prefill_ms_min_max": [min(prefill_ms), max(prefill_ms)],
        "kept_per_row": (masked > ref.MINP_FILL).sum(-1).tolist(),
        "launches": counts,
    })
    rep["device_busy"] = profile_decode_step(
        torch, lambda: M.decode_step(cfg, params, eng.cache, last, pos))
    del eng, logits, masked
    free(torch)
    torch.cuda.reset_peak_memory_stats()

    # decode at position 255 against the forward over 2 x 256 tokens; an
    # MoE on the no-drop factor, since at 1.25 a forward of 512 tokens
    # drops assignments that a decode of 2 keeps
    check = dataclasses.replace(cfg, param_dtype=check_dtype,
                                compute_dtype=check_dtype)
    if cfg.moe is not None:
        check = dataclasses.replace(check, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    if check_dtype != cfg.param_dtype:
        params = cast_tree(params, getattr(torch, check_dtype))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, ARCH_PROMPT))).to(cuda)
    full = M.forward_logits(check, params, {"tokens": toks})[:, -1]
    _, cache = M.prefill(check, params, {"tokens": toks[:, :-1]},
                         max_len=ARCH_MAX_LEN)
    step, _ = M.decode_step(check, params, cache, toks[:, -1:],
                            ARCH_PROMPT - 1)
    rep["decode_vs_forward"] = decode_vs_forward(
        torch, step[:, 0], full, cfg.vocab, arch,
        f32=check_dtype == "float32")
    rep["decode_vs_forward"]["dtype"] = check_dtype
    rep["peak_gb_check"] = torch.cuda.max_memory_allocated() / 1e9
    del full, step, cache, params
    free(torch)
    return rep, counts


def cast_tree(tree: dict, dtype) -> dict:
    """A copy of a parameter tree with each leaf in ``dtype``, each
    source leaf dropped as soon as it is copied."""
    out = {}
    for name in list(tree):
        v = tree.pop(name)
        out[name] = cast_tree(v, dtype) if isinstance(v, dict) else \
            v.to(dtype)
    return out


def run_whisper(torch) -> dict:
    """whisper-base at full size: encode 1,500 synthetic frames for a
    batch of 2, prefill 8 tokens, decode 8 steps against the cross K/V,
    each step against ``forward_logits`` at its position."""
    from repro_torch.configs import get_config
    from repro_torch.models import frontends as F
    from repro_torch.models import lm as M

    cfg = get_config("whisper-base")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in param_leaves(params))
    expect(n_params == WHISPER_PARAMS, f"whisper: {n_params} parameters")
    enc = F.synthetic_embeds(cfg, 2, WHISPER_FRAMES,
                             torch.Generator("cuda").manual_seed(1))
    total = WHISPER_PROMPT + WHISPER_STEPS
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, total))).to(torch.device("cuda"))
    full = M.forward_logits(cfg, params, {"enc_embeds": enc, "tokens": toks})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, cache = M.prefill(cfg, params, {"enc_embeds": enc,
                                       "tokens": toks[:, :WHISPER_PROMPT]},
                         max_len=total)
    cross = M._cross_kv(cfg, params, M._encode(cfg, params, enc))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    steps, step_ms = [], []
    for pos in range(WHISPER_PROMPT, total):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, cache = M.decode_step(cfg, params, cache,
                                      toks[:, pos:pos + 1], pos, cross=cross)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        steps.append(decode_vs_forward(torch, logits[:, 0], full[:, pos],
                                       cfg.vocab, f"whisper position {pos}"))
    rep = {"arch": "whisper-base", "dtype": "bfloat16", "params": n_params,
           "batch": 2, "frames": WHISPER_FRAMES, "prompt": WHISPER_PROMPT,
           "decode_steps": WHISPER_STEPS,
           "prefill_and_encode_ms": prefill_ms,
           "decode_step_ms_median": float(np.median(step_ms)),
           "decode_vs_forward_max_abs_err": max(s["max_abs_err"]
                                                for s in steps),
           "decode_vs_forward_mean_abs_err": max(s["mean_abs_err"]
                                                 for s in steps),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, cache, cross, full, enc
    free(torch)
    return rep


def run_arch_paths(torch, report) -> dict:
    """Phase 7; returns the launch counts summed over its engine runs."""
    report["archs"] = []
    total: dict = {}
    for arch, layers, n_params, check_dtype in ARCH_PATHS:
        t0 = time.perf_counter()
        rep, counts = serve_arch(torch, arch, layers, n_params, check_dtype)
        rep["phase_s"] = time.perf_counter() - t0
        report["archs"].append(rep)
        log(f"phase 7: {arch} ok {json.dumps(rep)}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    report["whisper"] = run_whisper(torch)
    log(f"phase 7: whisper-base ok {json.dumps(report['whisper'])}")
    return total


# --------------------------------------------------------------------- #
# Phase 9: training at full width
# --------------------------------------------------------------------- #

def card_vs_cpu_training(torch) -> dict:
    """Reduced granite in float32 from one set of parameters, on the card
    and on the CPU: two train steps (2 microbatches) and two compressed
    DDP steps, loss and grad_norm within ``CARD_CPU_RTOL``."""
    import copy

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist import ddp as D
    from repro_torch.models import lm as M
    from repro_torch.serve.engine import to_device
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    cfg = get_config(TRAIN_ARCH).reduced()
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    cpu_params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    src = SyntheticLM(cfg, SHAPES["train_4k"].reduced(), seed=0,
                      microbatches=2)
    out: dict = {}
    for dev in ("cuda", "cpu"):
        params = to_device(copy.deepcopy(cpu_params), torch.device(dev))
        opt = O.init_opt_state(oc, params)
        step = T.make_train_step(cfg, oc)
        rows = []
        for i in range(2):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in src.batch_at(i).items()}
            params, opt, st = step(params, opt, batch)
            rows.append([float(st["loss"]), float(st["grad_norm"])])
        params = to_device(copy.deepcopy(cpu_params), torch.device(dev))
        opt, err = O.init_opt_state(oc, params), D.init_error_state(params)
        dstep = D.make_ddp_step(cfg, oc, compress=True)
        for i in range(2):
            batch = {k: torch.from_numpy(v[0]).to(dev)
                     for k, v in src.batch_at(i).items()}
            params, opt, err, loss = dstep(params, opt, err, batch)
            rows.append([float(loss)])
        out[dev] = rows
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        for x, y in zip(a, b):
            expect(np.isfinite(x) and abs(x - y) <= CARD_CPU_RTOL * abs(y),
                   f"card vs CPU, step row {i}: {a} vs {b}")
    return {"train_loss_grad_norm": out["cuda"][:2],
            "cpu": out["cpu"][:2], "ddp_loss": out["cuda"][2:],
            "ddp_loss_cpu": out["cpu"][2:], "rtol": CARD_CPU_RTOL}


class CheckpointTimer:
    """Wraps the checkpoint manager's ``save`` and ``restore`` while a run
    lasts, timing each save through its write (the loop waits for it at
    the end of a run anyway) and each restore."""

    def __init__(self, torch) -> None:
        from repro_torch.train import checkpoint as C

        self.torch, self.C = torch, C
        self.saves: list[float] = []
        self.restores: list[float] = []
        self.saved_bytes = 0

    def __enter__(self):
        torch, mgr_cls = self.torch, self.C.CheckpointManager
        save, restore = mgr_cls.save, mgr_cls.restore
        self._orig = save, restore

        def timed_save(mgr, step, tree, *a, **kw):
            t = time.perf_counter()
            save(mgr, step, tree, *a, **kw)
            mgr.wait()
            self.saves.append(time.perf_counter() - t)
            self.saved_bytes = sum(x.numel() * x.element_size()
                                   for x in param_leaves(tree))

        def timed_restore(mgr, *a, **kw):
            t = time.perf_counter()
            out = restore(mgr, *a, **kw)
            torch.cuda.synchronize()
            self.restores.append(time.perf_counter() - t)
            return out

        mgr_cls.save, mgr_cls.restore = timed_save, timed_restore
        return self

    def __exit__(self, *exc) -> None:
        self.C.CheckpointManager.save, self.C.CheckpointManager.restore = \
            self._orig


def train_full_depth(torch, cfg, shape, oc) -> dict:
    """The full model trained ``TRAIN_STEPS`` steps through
    ``make_train_step`` on ``SyntheticLM(seed=0)``'s batches, as
    ``run_training`` feeds them, each step timed (synchronised); then a
    step profiled.  No checkpoint: one of the full model is 33.7 GB."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    n_params = sum(t.numel() for t in param_leaves(params))
    expect(n_params == TRAIN_PARAMS, f"{n_params} parameters")
    opt = O.init_opt_state(oc, params)
    step = T.make_train_step(cfg, oc)
    src = SyntheticLM(cfg, shape, seed=0, microbatches=TRAIN_MICRO)
    losses, norms, steps_ms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in src.batch_at(i).items()}
        t = time.perf_counter()
        params, opt, st = step(params, opt, batch)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(st["loss"]))
        norms.append(float(st["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the loss of step 0's batch again, after the steps: each step draws
    # new sequences of a 49,155-token bigram chain, so the logged loss of
    # an untrained model spreads by a few hundredths from batch to batch,
    # while the batch the model was stepped on must come out lower
    with torch.no_grad():
        b0 = {k: torch.from_numpy(v).cuda()
              for k, v in src.batch_at(0).items()}
        refit = float(torch.stack([
            M.forward_loss(cfg, params, {k: v[i] for k, v in b0.items()})
            for i in range(TRAIN_MICRO)]).mean())
    busy = profile_decode_step(torch, lambda: step(params, opt, batch),
                               reps=2, ops=16)
    del params, opt, batch, b0
    free(torch)
    med = float(np.median(steps_ms[1:]))
    return {"params": n_params, "losses": losses, "grad_norms": norms,
            "step0_batch_loss_after": refit,
            "step_ms": steps_ms, "step_ms_median_1_5": med,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (med / 1e3),
            "peak_gb": peak, "device_busy": busy}


def remat_cost(torch, cfg, shape, oc) -> dict:
    """Step wall-clock with remat on and off (median of 2 steps after one
    more), on the model cut to ``TRAIN_RESTART_LAYERS``: at full depth
    the activations without remat do not fit the card."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    src = SyntheticLM(cfg, shape, seed=0, microbatches=TRAIN_MICRO)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in src.batch_at(0).items()}
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        params = M.init_params(c, torch.Generator("cuda").manual_seed(0))
        opt = O.init_opt_state(oc, params)
        step = T.make_train_step(c, oc)
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            step(params, opt, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        out["remat" if remat else "no_remat"] = {
            "step_ms": float(np.median(walls[1:])),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, opt, step
        free(torch)
    return out


def run_training_path(torch, report) -> dict:
    """Phase 9: full-width granite trained on the card, 6 steps at full
    depth through ``make_train_step`` (step times, peak memory, a step
    profiled), then the restart through ``run_training`` at
    ``TRAIN_RESTART_LAYERS``: 6 steps uninterrupted, against 3 steps, a
    checkpoint and a fresh resumed run to step 6.  Returns the launch
    counts of our kernels over the training (only ``rmsnorm`` is on a
    train step's path)."""
    import shutil
    import tempfile

    import repro_torch.kernels as K
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import optimizer as O
    from repro_torch.train.loop import TrainConfig, run_training

    t_phase = time.perf_counter()
    rep: dict = {"arch": TRAIN_ARCH, "seq_len": TRAIN_SEQ,
                 "global_batch": TRAIN_BATCH, "microbatches": TRAIN_MICRO,
                 "reduced": {"global_batch": [256, TRAIN_BATCH]}}
    rep["card_vs_cpu"] = card_vs_cpu_training(torch)
    log(f"phase 9: reduced granite, card vs CPU ok "
        f"{json.dumps(rep['card_vs_cpu'])}")
    free(torch)

    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    oc = O.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, opt_dtype=cfg.opt_dtype)
    K.reset_launch_counts()
    rep.update(train_full_depth(torch, cfg, shape, oc))
    log(f"phase 9: full depth {json.dumps(rep)}")
    losses = rep["losses"]
    expect(all(np.isfinite(losses)), f"training losses {losses}")
    loss0 = float(np.log(cfg.vocab)) + LOSS0_ABOVE_LN_V
    expect(abs(losses[0] - loss0) <= LOSS0_TOL,
           f"step-0 loss {losses[0]} vs ln(vocab) + 2 = {loss0}")
    expect(rep["step0_batch_loss_after"] < losses[0],
           f"the loss did not fall: step 0's batch {losses[0]} before, "
           f"{rep['step0_batch_loss_after']} after {TRAIN_STEPS} steps")

    cut = dataclasses.replace(cfg, num_layers=TRAIN_RESTART_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def train(name: str, steps: int, every: int,
              timer: CheckpointTimer) -> dict:
        tc = TrainConfig(steps=steps, microbatches=TRAIN_MICRO,
                         checkpoint_every=every, log_every=1,
                         checkpoint_dir=os.path.join(tmp, name),
                         keep_checkpoints=1)
        with timer:
            out = run_training(cut, shape, tc, oc)
        free(torch)
        return out

    timers = [CheckpointTimer(torch) for _ in range(3)]
    try:
        full = train("a", TRAIN_STEPS, 10 ** 9, timers[0])
        shutil.rmtree(os.path.join(tmp, "a"))
        train("b", TRAIN_RESTART, TRAIN_RESTART, timers[1])
        resumed = train("b", TRAIN_STEPS, TRAIN_RESTART, timers[2])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rep["remat_cost"] = remat_cost(torch, cut, shape, oc)
    launches = K.launch_counts()
    want = [r["loss"] for r in full["log"]][TRAIN_RESTART:]
    got = [r["loss"] for r in resumed["log"]]
    expect(resumed["steps"] == TRAIN_STEPS - TRAIN_RESTART and
           np.allclose(got, want, rtol=RESTART_TOL, atol=RESTART_TOL),
           f"restarted losses {got} vs {want}")
    rep["restart"] = {
        "reduced": {"num_layers": [cfg.num_layers, TRAIN_RESTART_LAYERS]},
        "losses": [r["loss"] for r in full["log"]], "resumed_losses": got,
        "max_abs_diff": float(np.max(np.abs(np.subtract(got, want)))),
        "checkpoint_gb": timers[1].saved_bytes / 1e9,
        "save_s": [t for tm in timers for t in tm.saves],
        "restore_s": timers[2].restores,
    }
    rep["launches"] = launches
    rep["phase_s"] = time.perf_counter() - t_phase
    report["train"] = rep
    return launches


# --------------------------------------------------------------------- #
# Phase 10: the reference's "opt" variant at full width
# --------------------------------------------------------------------- #

def model_flop_share(cfg, step_ms: float) -> dict:
    """Model FLOPs of a train step (6 N_active D, ``launch/roofline.py``)
    over the step's seconds, against the card's dense bf16 peak."""
    from repro_torch.launch import roofline as R
    from repro_torch.launch.dryrun import abstract_params, active_params

    active = active_params(cfg, abstract_params(cfg))
    flops = R.model_flops_train(active, TRAIN_BATCH * TRAIN_SEQ)
    return {"active_params": active, "model_flops": flops,
            "model_tflop_per_s": flops / (step_ms / 1e3) / 1e12,
            "share_of_peak": flops / (step_ms / 1e3) / R.PEAK_FLOPS,
            "peak_tflop_per_s": R.PEAK_FLOPS / 1e12, "card": card_line()}


def opt_vs_plain_attention(torch, base, cfg) -> dict:
    """Each layer's attention under the "opt" config ``cfg`` against the
    plain ``base``'s on the same input: the hidden states of a plain
    ``forward_logits`` of one ``TRAIN_SEQ``-token sequence through phase
    9's weights, every layer within phase 6's bf16 tolerance of its
    largest output.  The whole model is not compared: a token routed to
    another top-8 of 40 experts by a rounding apart (as phase 7 found)
    changes every later position it reaches."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as M

    attention, errs = L.attention, []

    def both(c, p, x, q_pos, *args, **kw):
        y = attention(c, p, x, q_pos, *args, **kw)
        d = (attention(cfg, p, x, q_pos, *args, **kw).float()
             - y.float()).abs()
        errs.append((float(d.max()), float(d.mean()),
                     float(y.float().abs().max())))
        return y

    params = M.init_params(base, torch.Generator("cuda").manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, base.vocab, (1, TRAIN_SEQ))).cuda()
    L.attention = both
    try:
        with torch.no_grad():
            M.forward_logits(base, params, {"tokens": toks})
    finally:
        L.attention = attention
    expect(len(errs) == base.num_layers,
           f"{len(errs)} attention layers of {base.num_layers} compared")
    for i, (err, mean, scale) in enumerate(errs):
        expect(err <= DECODE_TOL * scale and mean <= DECODE_MEAN_TOL * scale,
               f"{TRAIN_ARCH} layer {i} attention, opt vs plain: max "
               f"{err}, mean {mean}, largest {scale}")
    del params
    free(torch)
    return {"dtype": "bfloat16", "positions": TRAIN_SEQ,
            "query_blocks": -(-TRAIN_SEQ // cfg.attn_q_chunk),
            "layers": len(errs),
            "max_rel_err": max(e / s for e, _, s in errs),
            "mean_rel_err": max(m / s for _, m, s in errs)}


def opt_training(torch, plain: dict) -> dict:
    """(a) granite at full width and depth under the "opt" variant: its
    attention against the plain config's, then trained as phase 9 trains
    it (``plain``: phase 9's report)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.train import optimizer as O

    base = get_config(TRAIN_ARCH)
    cfg = apply_variant(base, "opt", SHAPES["train_4k"])
    expect(cfg.attn_q_chunk == 2048 and cfg.attn_shard_heads and
           cfg.attn_scores_bf16 and cfg.moe_dp_sharding,
           f"the opt variant of {TRAIN_ARCH}: {cfg}")
    expect(TRAIN_SEQ > cfg.attn_q_chunk,
           f"{TRAIN_SEQ} tokens run as one query block")
    attention = opt_vs_plain_attention(torch, base, cfg)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    oc = O.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS, opt_dtype=cfg.opt_dtype)
    rep = train_full_depth(torch, cfg, shape, oc)
    losses, loss0 = rep["losses"], plain["losses"][0]
    expect(all(np.isfinite(losses)), f"opt training losses {losses}")
    expect(abs(losses[0] - loss0) <= OPT_LOSS0_RTOL * abs(loss0),
           f"opt step-0 loss {losses[0]} vs phase 9's {loss0}")
    expect(rep["step0_batch_loss_after"] < losses[0],
           f"opt: step 0's batch {losses[0]} before, "
           f"{rep['step0_batch_loss_after']} after {TRAIN_STEPS} steps")
    rep.update({
        "knobs": {k: getattr(cfg, k) for k in (
            "attn_q_chunk", "attn_shard_heads", "attn_scores_bf16",
            "moe_dp_sharding")},
        "reduced": {"global_batch": [256, TRAIN_BATCH]},
        "attention_vs_plain": attention,
        "loss0_plain": loss0,
        "step_ms_median_1_5_plain": plain["step_ms_median_1_5"],
        "peak_gb_plain": plain["peak_gb"],
        "mfu": model_flop_share(cfg, rep["step_ms_median_1_5"]),
        "mfu_plain": model_flop_share(base, plain["step_ms_median_1_5"])})
    return rep


def timed_ms(torch, fn, reps: int) -> tuple[float, list, object]:
    """``fn`` once to warm up, then ``reps`` times, each synchronised:
    (median ms, the times, the last result)."""
    out = fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return float(np.median(walls)), walls, out


def opt_rwkv(torch, dev: str = "cuda") -> tuple[dict, dict]:
    """(b) rwkv6-3b at full width: the prefill of one 256-token prompt
    with ``rwkv_chunk=64`` (the chunked form) against ``None`` (the
    time-step loop), within phase 7's bf16 tolerance; then the "opt"
    config serving as phase 7 serves.  Returns (report, the engine run's
    launch counts)."""
    import repro_torch.kernels as K
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.models import lm as M
    from repro_torch.serve.engine import Request, ServeEngine

    base = get_config(OPT_RWKV_ARCH)
    cfg = apply_variant(base, "opt", SHAPES["prefill_32k"])
    expect(cfg.rwkv_chunk == 64 and OPT_RWKV_PROMPT % 64 == 0,
           f"rwkv_chunk {cfg.rwkv_chunk}")
    scan = dataclasses.replace(cfg, rwkv_chunk=None)
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(base, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab, (1, OPT_RWKV_PROMPT))).to(dev)
    rep: dict = {"arch": OPT_RWKV_ARCH, "dtype": "bfloat16",
                 "prompt": OPT_RWKV_PROMPT, "rwkv_chunk": cfg.rwkv_chunk}
    with torch.no_grad():
        out = {}
        for name, c, reps in (("chunked", cfg, 5), ("scan", scan, 2)):
            ms, walls, out[name] = timed_ms(
                torch, lambda c=c: M.prefill(c, params, {"tokens": toks}),
                reps)
            rep[f"prefill_ms_{name}"], rep[f"prefill_ms_{name}_all"] = \
                ms, walls
    (lc, cc), (ls, cs) = out["chunked"], out["scan"]
    rep["chunked_vs_scan"] = decode_vs_forward(
        torch, lc[:, 0], ls[:, 0], base.vocab, "rwkv prefill, chunked vs "
        "the time-step loop")
    st_c, st_s = cc["block0"]["state"].float(), cs["block0"]["state"].float()
    rep["state_max_rel_err"] = float((st_c - st_s).abs().max()
                                     / st_s.abs().max())
    expect(rep["state_max_rel_err"] <= DECODE_TOL,
           f"rwkv prefill, chunked vs the time-step loop: states "
           f"{rep['state_max_rel_err']} of the largest apart")
    del out, lc, cc, ls, cs, st_c, st_s

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, base.vocab,
                                               OPT_RWKV_PROMPT + 1)
                    .astype(np.int32), max_new_tokens=ARCH_NEW)
            for i in range(ARCH_REQUESTS)]
    eng = ServeEngine(cfg, params, num_slots=ARCH_SLOTS,
                      max_len=ARCH_MAX_LEN, device=dev)
    prefill_ms, step_ms = [], []

    eng.add_request = timed_calls(torch, eng.add_request, prefill_ms)
    eng.step = timed_calls(torch, eng.step, step_ms)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = K.launch_counts()
    expect(sorted(r.rid for r in done) == list(range(ARCH_REQUESTS)) and
           all(len(r.out_tokens) == ARCH_NEW and
               all(0 <= t < base.vocab for t in r.out_tokens)
               for r in done), "opt rwkv serving: requests unfinished")
    expect(counts["minp_mask"] == len(step_ms) > 0,
           f"opt rwkv serving: minp_mask launched {counts['minp_mask']} "
           f"times in {len(step_ms)} decode steps")
    tokens = sum(len(r.out_tokens) for r in done)
    rep.update({
        "serve": {"requests": ARCH_REQUESTS,
                  "prompt": OPT_RWKV_PROMPT + 1, "new_tokens": ARCH_NEW,
                  "slots": ARCH_SLOTS, "engine_s": run_s, "tokens": tokens,
                  "tok_per_s": tokens / run_s,
                  "prefill_ms_median": float(np.median(prefill_ms)),
                  "decode_step_ms_median": float(np.median(step_ms)),
                  "decode_steps": len(step_ms), "launches": counts},
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    del eng, params
    free(torch)
    return rep, counts


def opt_long_decode(torch, dev: str = "cuda") -> dict:
    """(c) minitron-8b at B = 1 against a cache of ``OPT_LONG_SEQ``
    random bf16 positions: ``OPT_LONG_STEPS`` decode steps with
    ``sp_decode`` (the "opt" config of ``long_500k``) and the same steps
    without, on one cache (each run rewrites the rows it reads before it
    reads them).  The logits agree within phase 6's bf16 tolerance; each
    run's K/V rows land at the positions decoded (changed there, equal
    to the random fill on both sides) and agree between the runs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import apply_variant
    from repro_torch.models import lm as M

    base = get_config(OPT_LONG_ARCH)
    sp = apply_variant(base, "opt", SHAPES["long_500k"])
    expect(sp.sp_decode, "the long_500k variant sets sp_decode")
    plain = dataclasses.replace(sp, sp_decode=False)
    s, n = OPT_LONG_SEQ, OPT_LONG_STEPS
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(base, torch.Generator(dev).manual_seed(0), dev)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in param_leaves(params))
    cache = M.init_cache(base, 1, s, dev)
    gen = torch.Generator(dev).manual_seed(4)
    kv = [cache[b][name] for b in sorted(cache) for name in ("k", "v")]
    for leaf in kv:
        for i in range(leaf.shape[0]):
            leaf[i].normal_(generator=gen)
    cache_bytes = sum(t.numel() * t.element_size() for t in kv)
    p0 = s - n - 1                   # rows p0-1 and s-1 stay the fill
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.vocab, (1, n))).to(dev)

    def rows() -> list:
        return [leaf[:, :, p0 - 1:].clone() for leaf in kv]

    fill = rows()
    runs: dict = {}
    with torch.no_grad():
        for name, c in (("sp", sp), ("plain", plain)):
            M.decode_step(c, params, cache, toks[:, :1], p0)   # warm-up
            logits, walls = [], []
            for t in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, _ = M.decode_step(c, params, cache, toks[:, t:t + 1],
                                       p0 + t)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                logits.append(out[:, 0])
            # the last step again, profiled: it rewrites its row with the
            # same bits
            busy = profile_decode_step(
                torch, lambda c=c: M.decode_step(
                    c, params, cache, toks[:, -1:], p0 + n - 1),
                reps=2, ops=8)
            runs[name] = {"logits": logits, "ms": walls, "rows": rows(),
                          "device_busy": busy}
    for name, run in runs.items():
        for f, r in zip(fill, run["rows"]):
            expect(torch.equal(r[:, :, 0], f[:, :, 0]) and
                   torch.equal(r[:, :, -1], f[:, :, -1]),
                   f"long decode ({name}): a row outside the decoded "
                   f"positions changed")
            expect(all(not torch.equal(r[:, :, 1 + t], f[:, :, 1 + t])
                       for t in range(n)),
                   f"long decode ({name}): a decoded row kept the fill")
    row_err = max(float((a[:, :, 1:-1].float() - b[:, :, 1:-1].float())
                        .abs().max() / b[:, :, 1:-1].float().abs().max())
                  for a, b in zip(runs["sp"]["rows"], runs["plain"]["rows"]))
    expect(row_err <= DECODE_TOL,
           f"long decode: K/V rows, sp vs plain, {row_err} of the largest")
    steps = [decode_vs_forward(torch, a, b, base.vocab,
                               f"long decode at {p0 + t}, sp vs plain")
             for t, (a, b) in enumerate(zip(runs["sp"]["logits"],
                                            runs["plain"]["logits"]))]
    bound_ms = (param_bytes + cache_bytes) / PEAK_BYTES_S * 1e3
    rep = {"arch": OPT_LONG_ARCH, "dtype": "bfloat16", "batch": 1,
           "cache_positions": s, "positions": [p0, p0 + n - 1],
           "reduced": {"seq_len": [SHAPES["long_500k"].seq_len, s]},
           "cache_gb": cache_bytes / 1e9, "param_gb": param_bytes / 1e9,
           "step_ms_sp": runs["sp"]["ms"],
           "step_ms_plain": runs["plain"]["ms"],
           "step_ms_sp_median": float(np.median(runs["sp"]["ms"])),
           "step_ms_plain_median": float(np.median(runs["plain"]["ms"])),
           "bound_ms": bound_ms, "kv_rows_max_rel_diff": row_err,
           "device_busy_sp": runs["sp"]["device_busy"],
           "device_busy_plain": runs["plain"]["device_busy"],
           "logits_max_abs_err": max(x["max_abs_err"] for x in steps),
           "logits_mean_abs_err": max(x["mean_abs_err"] for x in steps),
           "same_argmax": [x["same_argmax"][0] for x in steps],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, cache, kv, runs, fill
    free(torch)
    return rep


def opt_pipeline(torch, dev: str = "cuda") -> dict:
    """(d) ``pipeline_forward`` over ``PIPE_STAGES`` stages on the card,
    bit-equal to each microbatch run through the stages in order."""
    from repro_torch.dist.pipeline import pipeline_forward

    gen = torch.Generator(dev).manual_seed(6)
    ws = torch.randn(PIPE_STAGES, PIPE_WIDTH, PIPE_WIDTH, generator=gen,
                     device=dev, dtype=torch.bfloat16) * PIPE_WIDTH ** -0.5
    xs = torch.randn(PIPE_MICRO, PIPE_ROWS, PIPE_WIDTH, generator=gen,
                     device=dev, dtype=torch.bfloat16)

    def stage(w, x):
        return torch.tanh(x @ w)

    def in_order():
        outs = []
        for m in range(PIPE_MICRO):
            x = xs[m]
            for w in ws:
                x = stage(w, x)
            outs.append(x)
        return torch.stack(outs)

    devices = [torch.device(dev)] * PIPE_STAGES
    with torch.no_grad():
        ms, _, got = timed_ms(
            torch, lambda: pipeline_forward(stage, devices, ws, xs), 5)
        ms_seq, _, want = timed_ms(torch, in_order, 5)
    expect(torch.equal(got, want) and bool(torch.isfinite(got).all()),
           "pipeline_forward vs the stages run in order")
    return {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
            "microbatch": [PIPE_ROWS, PIPE_WIDTH], "dtype": "bfloat16",
            "ticks": PIPE_MICRO + PIPE_STAGES - 1, "bit_equal": True,
            "ms": ms, "ms_in_order": ms_seq}


def run_opt_variant(torch, report, dev: str = "cuda") -> dict:
    """Phase 10: (a) training, (b) rwkv prefill and serving, (c)
    long-context decode, (d) ``pipeline_forward``, each on a freed card.
    Returns the launch counts of our kernels in (b)'s serving; (a), (c)
    and (d) launch none (checked)."""
    import repro_torch.kernels as K

    def none_launched(what: str) -> None:
        counts = K.launch_counts()
        expect(not any(counts.values()),
               f"{what} launched kernels of ours: {counts}")

    t_phase = time.perf_counter()
    rep: dict = {}
    K.reset_launch_counts()
    rep["train"] = opt_training(torch, report["train"])
    none_launched("the opt training")
    free(torch)
    rep["train"]["part_s"] = time.perf_counter() - t_phase
    log(f"phase 10: (a) opt training ok {json.dumps(rep['train'])}")
    t = time.perf_counter()
    rep["rwkv"], counts = opt_rwkv(torch, dev)
    rep["rwkv"]["part_s"] = time.perf_counter() - t
    log(f"phase 10: (b) rwkv prefill and serving ok "
        f"{json.dumps(rep['rwkv'])}")
    K.reset_launch_counts()
    t = time.perf_counter()
    rep["long_decode"] = opt_long_decode(torch, dev)
    rep["long_decode"]["part_s"] = time.perf_counter() - t
    log(f"phase 10: (c) long-context decode ok "
        f"{json.dumps(rep['long_decode'])}")
    t = time.perf_counter()
    rep["pipeline"] = opt_pipeline(torch, dev)
    rep["pipeline"]["part_s"] = time.perf_counter() - t
    log(f"phase 10: (d) pipeline_forward ok {json.dumps(rep['pipeline'])}")
    none_launched("the long-context decode or the pipeline")
    rep["launches"] = counts
    rep["phase_s"] = time.perf_counter() - t_phase
    report["opt"] = rep
    return counts


# --------------------------------------------------------------------- #
# Phase 11: per-column representations on a TPC-H lineitem table
# --------------------------------------------------------------------- #

def lineitem_queries(Q):
    """Phase 3's batch shape over :data:`LINEITEM_COLUMNS` (0 orderkey,
    1 partkey, 2 suppkey, 3 quantity, 4 extendedprice, 5 discount, 6
    tax, 7 shipdate), scalars inside each column's range (and past a
    narrow column's maximum, up to 2^32 - 1), then TPC-H Q6's WHERE
    clause as a bitmap and as a count."""
    top = (1 << 32) - 1
    qa = dict(fi=7, x0=365, x1=1460, fj=3, y0=10, y1=30)
    qb = dict(fi=5, x0=6, x1=top, fj=6, y0=2, y1=9)
    q6 = ((Q.Q1(fi=7, x0=729, x1=1095), Q.Q1(fi=5, x0=4, x1=8),
           Q.Q1(fi=3, x0=0, x1=24)), ("and", "and"))
    return [
        ("Q1", Q.Q1(fi=7, x0=365, x1=1460)),
        ("Q2", Q.Q2(fi=3, x0=10, x1=30, fj=4, y0=1_000_000,
                    y1=5_000_000)),
        ("Q3", Q.Q3(**qb)),
        ("Q4", Q.Q4(fk=4, **qa)),
        ("Q5", Q.Q5(fl=1, fk=2, fi=0, x0=1_000_000, x1=60_000_000, fj=5,
                    y0=8, y1=top)),
        ("Compound(Q1 and Q3)", Q.Compound(
            (Q.Q1(fi=2, x0=100, x1=40_000), Q.Q3(**qb)), ("and",))),
        ("Compound(Q1 or Q2 and Q3), count", Q.Compound(
            (Q.Q1(fi=6, x0=0, x1=2), Q.Q2(**qa), Q.Q3(**qb)),
            ("or", "and"), count=True)),
        ("Q6 WHERE", Q.Compound(*q6)),
        ("Q6 WHERE, count", Q.Compound(*q6, count=True)),
    ]


class KernelCalls:
    """Within ``with``, record each predicate, compound and leaf-bits
    launch the executors make (their wrappers still run and count), so
    a job's launches can be timed again alone afterwards."""

    NAMES = ("fused_predicate_banked", "fused_compound_banked",
             "gbdt_leafbits_banked")

    def __init__(self):
        from repro_torch.kernels import fused_session

        self.module = fused_session
        self.calls: list = []

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            def record(*args, _fn=fn, _name=name):
                self.calls.append((_name, _fn, args))
                return _fn(*args)
            setattr(self.module, name, record)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def time_launch(torch, call, flush) -> dict:
    """A recorded launch timed again alone, cold, its indices already on
    the card.  A predicate or compound also gets its byte bound: the
    distinct rows it reads (the pad lanes' constant rows once), the
    bitmap it writes and its indices."""
    name, fn, args = call
    idx = np.asarray(args[2] if name == "gbdt_leafbits_banked" else args[1])
    didx = torch.from_numpy(idx).to(args[0].device)
    if name == "gbdt_leafbits_banked":
        lut, masks, _, *rest = args
        return {"cold_ms": cold_ms(
            torch, lambda: fn(lut, masks, didx, *rest), flush)}
    lut, _, c, *rest = args
    n_ranges = len(idx) // (4 * c)
    s, _, w = lut.shape
    n_rows = read_rows(idx, c, n_ranges)
    b_ms, b_by = bound(n_rows * s * w * 4 + s * w * 4 + idx.nbytes,
                       s * w * (n_ranges * (2 * (c - 1) * 5 + 1) + n_ranges))
    return {"kernel": name, "chunks": c, "ranges": n_ranges,
            "rows_read": n_rows,
            "cold_ms": cold_ms(torch, lambda: fn(lut, didx, c, *rest),
                               flush),
            "bound_ms": b_ms, "bound_by": b_by}


def lineitem_summary(rep: dict) -> dict:
    """Phase 11's numbers for standard output: plans, LUT sizes, build
    and rebuild seconds, each job's wall-clock with its WHERE launch's
    cold time and bound, the forests and the launches."""
    def jobs(batch):
        return {name: [round(r["wallclock_ms"], 3), round(r["cold_ms"], 4),
                       round(r["bound_ms"], 4), r["rows_read"]]
                for name, r in batch.items()}

    return {
        "plans": {m: t["plans"] for m, t in rep["tables"].items()},
        "lut_gb": {m: t["lut_gb"] for m, t in rep["tables"].items()},
        "build_s": {m: t["build_s"] for m, t in rep["tables"].items()},
        "planner_s": rep["planner_s"],
        "jobs [wall ms, cold ms, bound ms, rows]": {
            m: jobs(b) for m, b in rep["queries"].items()},
        "recode": {k: rep["recode"][k] for k in ("column", "plan",
                                                 "rebuild_s", "lut_gb")},
        "forests": rep["forests"], "launches": rep["launches"]}


def run_lineitem_path(torch, report) -> dict:
    """Phase 11: one ``lineitem`` table of 2^25 records laid out twice in
    one session, ``fixed`` and ``representation="auto"``; the batch on
    both, bit-exact; ``l_shipdate`` recoded and the batch again; then
    the adaptive-precision forest ``fixed`` and ``auto``.  The launch
    counts are read before any launch is timed again."""
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.pud import PudSession, planner, queries as Q

    t_phase = time.perf_counter()
    rep: dict = {"records": LINEITEM_RECORDS,
                 "columns": [c[0] for c in LINEITEM_COLUMNS]}
    t0 = time.perf_counter()
    table = Table(32, lineitem_columns(LINEITEM_RECORDS, seed=0))
    rep["generate_s"] = time.perf_counter() - t0
    session = PudSession(backend="fused")
    # the planner alone, its probe cache cold: the CPU seconds it adds
    # to a create_table
    planner._probe_makespan.cache_clear()
    t0 = time.perf_counter()
    planner.choose_representation(table, session.arch)
    rep["planner_s"] = time.perf_counter() - t0
    # the adaptive-precision forest (benchmarks/adaptive_precision.py's
    # shape) at phase 4's size
    rng = np.random.default_rng(32)
    forest = G.ObliviousForest(
        rng.integers(0, 28, size=(1000, 6)).astype(np.int32),
        rng.integers(0, 400, size=(1000, 6)).astype(np.uint64),
        rng.normal(size=(1000, 64)).astype(np.float32), 16, 28)
    X = np.random.default_rng(33).integers(0, 1 << 16, (2 ** 16, 28),
                                           dtype=np.uint64)
    addrs = np.ascontiguousarray(np.concatenate(
        [G.reference_leaf_addrs(forest, X[i:i + 8192])
         for i in range(0, X.shape[0], 8192)]))
    want_preds = G.assemble_leaves(forest.leaves, addrs)
    queries = lineitem_queries(Q)
    wants = [q.reference(table) for _, q in queries]

    K.reset_launch_counts()
    handles, tables = {}, {}
    for mode in ("fixed", "auto"):
        t0 = time.perf_counter()
        handles[mode] = session.create_table(
            table, name=f"lineitem_{mode}", representation=mode)
        torch.cuda.synchronize()
        ex = session.executor(handles[mode])
        plans = [(c["n_bits"], c["num_chunks"])
                 for c in handles[mode].representation["columns"]]
        tables[mode] = {
            "build_s": time.perf_counter() - t0, "plans": plans,
            "lut_shape": list(ex.lut.shape),
            "lut_gb": ex.lut.numel() * 4 / 1e9,
            "report_lut_rows": handles[mode].representation["lut_rows"]}
    rep["tables"] = tables
    want_plans = [list(p) for p in LINEITEM_AUTO_PLANS[session.arch.value]]
    expect([list(p) for p in tables["auto"]["plans"]] == want_plans,
           f"auto plans {tables['auto']['plans']} vs {want_plans}")
    expect(tables["auto"]["lut_gb"] < tables["fixed"]["lut_gb"],
           f"auto LUT {tables['auto']['lut_gb']:.2f} GB not below fixed "
           f"{tables['fixed']['lut_gb']:.2f} GB")

    def run_batch(mode: str) -> dict:
        out = {}
        with KernelCalls() as rec:
            for (name, q), want in zip(queries, wants):
                job = session.query(handles[mode], q)
                got = job.result
                if isinstance(want, np.ndarray):
                    expect(np.array_equal(got, want),
                           f"phase 11 {mode} {name} bitmap")
                    summary = int(got.sum())
                else:
                    expect(type(got) is type(want) and got == want,
                           f"phase 11 {mode} {name}: {got} vs {want}")
                    summary = got
                out[name] = {"wallclock_ms": job.wallclock_ns / 1e6,
                             "result": summary, "calls": rec.take()}
        return out

    batches = {mode: run_batch(mode) for mode in ("fixed", "auto")}
    new = session.recode_column(handles["auto"], 7, num_chunks=2)
    expect((new.n_bits, new.num_chunks) == (12, 2), f"recode gave {new}")
    expect(handles["auto"].status == "evicted",
           f"after the recode the table is {handles['auto'].status}")
    t0 = time.perf_counter()
    ex = session.executor(handles["auto"])
    torch.cuda.synchronize()
    rep["recode"] = {"column": LINEITEM_COLUMNS[7][0], "plan": [12, 2],
                     "rebuild_s": time.perf_counter() - t0,
                     "lut_gb": ex.lut.numel() * 4 / 1e9}
    batches["recoded"] = run_batch("auto")

    forests, gbdt_calls = {}, {}
    for mode in ("fixed", "auto"):
        h = session.load_forest(forest, name=f"forest_{mode}",
                                representation=mode)
        with KernelCalls() as rec:
            job = session.predict(h, X)
        expect(np.array_equal(job.result, want_preds),
               f"phase 11 {mode} forest predictions")
        gex = session.executor(h)
        (gbdt_calls[mode],) = rec.take()
        forests[mode] = {
            "plan": [int(gex.plan.n_bits), gex.num_chunks],
            "lut_shape": list(gex.lut.shape),
            "predict_wallclock_ms": job.wallclock_ns / 1e6}
    counts = K.launch_counts()
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched in phase 11")
    rep["launches"] = counts

    # each job's first launch (its WHERE clause) and each forest's
    # leaf bits, timed again alone
    flush = torch.ones(64 << 20, dtype=torch.int32,
                       device=torch.device("cuda"))
    for mode, batch in batches.items():
        for r in batch.values():
            calls = r.pop("calls")
            r["launches"] = len(calls)
            r.update(time_launch(torch, calls[0], flush))
    rep["queries"] = batches
    for mode, call in gbdt_calls.items():
        forests[mode]["gbdt_leafbits_banked_cold_ms"] = time_launch(
            torch, call, flush)["cold_ms"]
    rep["forests"] = forests
    del flush, batches, gbdt_calls, ex, gex, session, handles
    free(torch)
    rep["phase_s"] = time.perf_counter() - t_phase
    report["lineitem"] = rep
    return counts


# --------------------------------------------------------------------- #
# Phase 12: the PuD serving stack under offered load
# --------------------------------------------------------------------- #

def serving_mixes(Arr, deadline_ns: float):
    """``benchmarks/serving_load.py``'s ``_mixes``: light deadline-bearing
    queries (weight 4) against scans and GBDT inference (weight 1)."""
    interactive = Arr.WorkloadMix(
        table="events", kinds=("q1", "q2", "q3"),
        classes=(Arr.ClassSpec("interactive", weight=4.0,
                               deadline_ns=deadline_ns),))
    bulk = Arr.WorkloadMix(
        table="events", forest="rank", predict_frac=0.3, predict_batch=8,
        kinds=("q4", "q5", "compound"),
        classes=(Arr.ClassSpec("bulk", weight=1.0),))
    return interactive, bulk


def serving_arrivals(Arr, rate_rps: float, deadline_ns: float, seed: int,
                     burst_ns: float | None = None) -> list:
    """Merged interactive + bulk open-loop arrivals at ``rate_rps`` in
    all (half each), Poisson, or bursty with on and off windows of
    ``burst_ns``."""
    inter, bulk = serving_mixes(Arr, deadline_ns)
    gen, kw = Arr.poisson_arrivals, {}
    if burst_ns is not None:
        gen = Arr.bursty_arrivals
        kw = dict(on_ns=burst_ns, off_ns=burst_ns, burst_factor=4.0)
    a = gen(inter, rate_rps=rate_rps / 2, n=SERVE_ARRIVALS, seed=seed, **kw)
    b = gen(bulk, rate_rps=rate_rps / 2, n=SERVE_ARRIVALS, seed=seed + 1,
            rid_base=100_000, **kw)
    return sorted(a + b, key=lambda x: x.arrive_ns)


def probe_batch(Q, mx: int = 255) -> list:
    """``serving_load.py``'s capacity probe: Q1, Q2, Q3 and Q5."""
    return [Q.Q1(fi=0, x0=mx // 8, x1=mx // 2),
            Q.Q2(fi=0, x0=mx // 8, x1=mx // 2, fj=1, y0=mx // 4,
                 y1=3 * mx // 4),
            Q.Q3(fi=1, x0=mx // 8, x1=mx // 2, fj=2, y0=mx // 4,
                 y1=3 * mx // 4),
            Q.Q5(fl=3, fk=2, fi=0, x0=mx // 8, x1=mx // 2, fj=1,
                 y0=mx // 4, y1=3 * mx // 4)]


def burst_cohorts(Arr, period_ns: float, deadline_ns: float,
                  seed: int) -> list:
    """``serving_load.py``'s synchronized cohorts: every ``period_ns``
    four interactive Q1s (tight deadline) arrive with two bulk scans."""
    inter = Arr.WorkloadMix(
        table="events", kinds=("q1",),
        classes=(Arr.ClassSpec("interactive", weight=4.0,
                               deadline_ns=deadline_ns),))
    bulk = Arr.WorkloadMix(
        table="events", kinds=("q5", "compound"),
        classes=(Arr.ClassSpec("bulk", weight=1.0),))
    rng = np.random.default_rng(seed)
    out = []
    for b in range(SERVE_COHORTS):
        t0 = b * period_ns
        out += [inter.sample_request(rng, b * 100 + k, t0)
                for k in range(4)]
        out += [bulk.sample_request(rng, b * 100 + 10 + k, t0)
                for k in range(2)]
    return out


def recording_batcher(B, S):
    """A service that keeps each probe (its rids, attributed latencies
    and job) and a batcher that keeps each dispatch's outcome with its
    probes, so phase 12 can check attribution and results afterwards."""

    class RecordingService(S.PudService):
        def __init__(self, session):
            super().__init__(session)
            self.probes = []

        def _run_batch(self, handle, kind, reqs):
            resps = super()._run_batch(handle, kind, reqs)
            self.probes.append(([r.rid for r in reqs],
                                [r.latency_ns for r in resps],
                                self.last_job))
            return resps

    class RecordingBatcher(B.DeadlineBatcher):
        def __init__(self, service, enabled=True):
            super().__init__(service, enabled=enabled)
            self.dispatches = []

        def dispatch(self, handle, kind, reqs):
            first = len(self.service.probes)
            out = super().dispatch(handle, kind, reqs)
            self.dispatches.append((out, self.service.probes[first:]))
            return out

    return RecordingService, RecordingBatcher


def check_attribution(out, probes) -> None:
    """A dispatch's committed sub-batches, in commit order: each one's
    attributed shares sum to its job's measured wall-clock (within 1e-9
    relative: shares rounded and summed again), each committed response
    is its share offset by the spans committed before it, and the
    outcome's makespan is the last offset plus its span (both exact:
    the batcher's own arithmetic)."""
    committed = [p for p in probes if any(p[2] is j for j in out.jobs)]
    expect(len(committed) == len(out.jobs),
           f"{len(out.jobs)} committed jobs, {len(committed)} probes found")
    by_rid = {r.rid: r for r in out.responses}
    offset = 0.0
    for rids, lats, job in committed:
        wall = job.wallclock_ns
        expect(abs(sum(lats) - wall) <= 1e-9 * wall,
               f"shares {sum(lats)} ns vs the job's wall-clock {wall} ns")
        for rid, lat in zip(rids, lats):
            expect(by_rid[rid].latency_ns == offset + lat,
                   f"request {rid}: latency {by_rid[rid].latency_ns} vs "
                   f"{offset} + {lat}")
        offset = offset + max(lats)
    expect(out.makespan_ns == offset,
           f"makespan {out.makespan_ns} vs the offsets' {offset}")


def check_served_result(req, got, table, forest) -> None:
    """A request's result against its NumPy reference: bitmaps and
    counts exact, Q4's mean within 1e-9 (``check``), predictions
    bit-equal to ``assemble_leaves`` over the reference addresses."""
    from repro_torch.apps import gbdt as G

    if req.query is not None:
        want = req.query.reference(table)
        if isinstance(want, np.ndarray):
            expect(np.array_equal(got, want),
                   f"request {req.rid} {req.query}: bitmap")
        else:
            expect(req.query.check(table, got),
                   f"request {req.rid} {req.query}: {got} vs {want}")
        return
    X = np.asarray(req.X, dtype=np.uint64)
    addrs = np.ascontiguousarray(G.reference_leaf_addrs(forest, X))
    expect(np.array_equal(got, G.assemble_leaves(forest.leaves, addrs)),
           f"request {req.rid}: predictions")


def profiled_run(torch, fn):
    """``fn()`` under ``torch.profiler``: its result, the host seconds it
    took and the device milliseconds the profiler saw (kernels and
    copies)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type.name == "CUDA") / 1e3
    return out, real_s, device_ms


def run_serving_path(torch, report) -> dict:
    """Phase 12: ``repro_torch.serve``'s loop, admission and deadline
    batcher over a ``PudService`` on the card, under
    ``benchmarks/serving_load.py``'s offered loads.  Every check fails
    the run; the serving numbers are reported, not gated."""
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.pud import PudSession, queries as Q
    from repro_torch.serve import admission as A, arrivals as Arr
    from repro_torch.serve import batcher as B, loop as L
    from repro_torch.serve import pud_service as S

    t_phase = time.perf_counter()
    table = Table.generate(SERVE_RECORDS, 8, num_features=8, seed=13)
    forest = G.ObliviousForest.random(num_trees=1000, depth=6,
                                      num_features=8, n_bits=8, seed=7)
    generate_s = time.perf_counter() - t_phase
    rep: dict = {
        "records": SERVE_RECORDS, "n_bits": 8, "features": 8,
        "trees": 1000, "depth": 6, "generate_s": generate_s,
        "departures": "the table is declared 8-bit (serving_load.py's "
                      "width) where phase 3's is 32-bit; the forest has "
                      "8 features where phase 4's has 28, since the bulk "
                      "mix draws instances over the table's 8"}
    session = PudSession(backend="fused")
    K.reset_launch_counts()
    t0 = time.perf_counter()
    session.create_table(table, name="events")
    session.load_forest(forest, name="rank")
    torch.cuda.synchronize()
    rep["build_s"] = time.perf_counter() - t0
    RecordingService, RecordingBatcher = recording_batcher(B, S)
    svc = RecordingService(session)
    ex = session.executor(svc._handle("events", "query"))
    rep.update(shards=ex.num_shards, chunks=ex.num_chunks,
               lut_shape=list(ex.lut.shape),
               lut_gb=ex.lut.numel() * 4 / 1e9)

    # capacity and deadline from the probe batch's measured wall-clock
    probe = probe_batch(Q)
    tbl = svc._handle("events", "query")
    warm = session.query(tbl, probe)
    for q, got in zip(probe, warm.result):
        check_served_result(S.PudRequest(rid=-1, resource="events", query=q),
                            got, table, forest)
    walls = [session.query(tbl, probe).wallclock_ns for _ in range(3)]
    m_probe = float(np.median(walls))
    cap_rps = len(probe) / (m_probe / 1e9)
    deadline_ns = 1.0 * m_probe
    tight_ns = 0.2 * m_probe
    rep.update(probe_wallclock_ms=[w / 1e6 for w in walls],
               m_probe_ms=m_probe / 1e6, cap_rps=cap_rps,
               deadline_ms=deadline_ns / 1e6, tight_deadline_ms=tight_ns / 1e6)
    classes = (Arr.ClassSpec("interactive", weight=4.0,
                             deadline_ns=deadline_ns),
               Arr.ClassSpec("bulk", weight=1.0))
    burst_classes = (Arr.ClassSpec("interactive", weight=4.0,
                                   deadline_ns=tight_ns),
                     Arr.ClassSpec("bulk", weight=1.0))
    cohorts = burst_cohorts(Arr, 4.0 * m_probe, tight_ns, seed=22)
    runs = [(f"poisson_x{frac}", classes,
             serving_arrivals(Arr, frac * cap_rps, deadline_ns, 20 + i),
             True, frac == 0.5)
            for i, frac in enumerate(SERVE_LOAD_FRACS)]
    runs += [(f"bursty_x{SERVE_LOAD_FRACS[1]}", classes,
              serving_arrivals(Arr, SERVE_LOAD_FRACS[1] * cap_rps,
                               deadline_ns, 21,
                               burst_ns=SERVE_BURST_WINDOW * m_probe),
              True, False),
             ("cohorts_split", burst_classes, cohorts, True, True),
             ("cohorts_nosplit", burst_classes, cohorts, False, False)]

    rng = np.random.default_rng(12)
    rep["runs"] = {}
    singles: dict = {}
    for name, cls, arrivals, split, full in runs:
        batcher = RecordingBatcher(svc, enabled=split)
        adm = A.AdmissionController(cls, capacity=4 * SERVE_MAX_BATCH,
                                    starvation_bound=2 * SERVE_MAX_BATCH)
        loop = L.ServingLoop(svc, adm, batcher, max_batch=SERVE_MAX_BATCH)
        svc.probes.clear()
        res, real_s, device_ms = profiled_run(torch,
                                              lambda: loop.run(arrivals))
        expect(res.offered == len(arrivals),
               f"{name}: {res.offered} records of {len(arrivals)} arrivals")
        for r in res.records:
            expect(r.ok or bool(r.error), f"{name}: failed request {r.rid} "
                   "carries no error")
            expect(r.start_ns is not None or r.error.startswith("429 "),
                   f"{name}: shed request {r.rid} has a non-429 error "
                   f"{r.error!r}")
        if res.completed >= 2:
            expect(res.p99_ns >= res.p50_ns,
                   f"{name}: p99 {res.p99_ns} < p50 {res.p50_ns}")
        requests = {a.rid: a.request for a in arrivals}
        # each job of one request, committed or not, by query kind
        for rids, _, job in svc.probes:
            if len(rids) == 1:
                q = requests[rids[0]].query
                kind = "predict" if q is None else q.to_tuple()[0]
                singles.setdefault(kind, []).append(job.wallclock_ns / 1e6)
        committed = []
        for out, probes in batcher.dispatches:
            check_attribution(out, probes)
            committed += [r for r in out.responses if r.ok]
        expect(len(committed) == res.completed,
               f"{name}: {len(committed)} ok responses, "
               f"{res.completed} completed records")
        if not full and len(committed) > SERVE_SAMPLE:
            pick = rng.choice(len(committed), SERVE_SAMPLE, replace=False)
            committed = [committed[i] for i in sorted(pick)]
        # the NumPy references run in threads (their passes over the
        # 2^25 records release the interpreter lock), after the run
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            for done in [pool.submit(check_served_result, requests[r.rid],
                                     r.result, table, forest)
                         for r in committed]:
                done.result()
        check_s = time.perf_counter() - t0
        jobs = [j for out, _ in batcher.dispatches for j in out.jobs]
        committed_ids = {id(j) for j in jobs}
        discarded = [p[2].wallclock_ns for out, probes in batcher.dispatches
                     for p in probes if id(p[2]) not in committed_ids]
        rep["runs"][name] = {
            **res.to_json(), "split": split,
            "p50_ms": res.p50_ns / 1e6, "p99_ms": res.p99_ns / 1e6,
            "duration_s": res.duration_ns / 1e9, "real_s": real_s,
            "committed_jobs": len(jobs),
            "committed_wall_s": sum(j.wallclock_ns for j in jobs) / 1e9,
            "discarded_probes": len(discarded),
            "discarded_wall_s": sum(discarded) / 1e9,
            "device_ms": device_ms,
            "device_busy": device_ms / 1e3 / real_s,
            "results_checked": len(committed), "check_s": check_s}
    rep["single_job_ms [median, min, max, jobs]"] = {
        k: [float(np.median(v)), min(v), max(v), len(v)]
        for k, v in sorted(singles.items())}
    counts = K.launch_counts()
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched in phase 12")
    rep["launches"] = counts
    del svc, session, ex, tbl, warm, batcher, loop
    free(torch)
    rep["phase_s"] = time.perf_counter() - t_phase
    report["serving"] = rep
    return counts


def serving_summary(rep: dict) -> dict:
    """Phase 12's numbers for standard output."""
    keys = ("offered", "completed", "shed", "splits", "probes",
            "committed_jobs", "discarded_probes", "p50_ms", "p99_ms",
            "goodput_rps", "duration_s", "real_s", "committed_wall_s",
            "discarded_wall_s", "device_busy", "results_checked", "check_s")
    return {
        **{k: rep[k] for k in ("records", "lut_gb", "generate_s", "build_s",
                               "m_probe_ms",
                               "cap_rps", "deadline_ms", "tight_deadline_ms",
                               "departures", "launches", "phase_s",
                               "single_job_ms [median, min, max, jobs]")},
        "runs": {name: {k: r[k] for k in keys}
                 for name, r in rep["runs"].items()}}


# --------------------------------------------------------------------- #
# Phase 13: the machine backend, its bank state on the card
# --------------------------------------------------------------------- #

def machine_queries(Q, mx: int):
    """Phase 3's query shapes at ``mx``, the compound merged in the banks
    (``"dram"``) and the same compound merged on the host."""
    qs = table_queries(Q, mx)
    name, comp = qs[-1]
    return qs + [(name.replace("count", "count, host merge"),
                  dataclasses.replace(comp, merge="host"))]


def machine_pud_ops(q: tuple, cmp: int, modified: bool) -> int:
    """Closed form of the PuD ops one bank group issues for a query wire
    tuple (``QueryBatchExecutor`` on ``PudQueryEngine``), with ``cmp``
    the ops of one comparison (``clutch_op_count`` or
    ``bitserial_op_count``) and none of the scalars on a boundary: a
    range is two saved comparisons (plus the NOT of ``<`` on Modified
    PuD), a MAJ3 AND (4 ops on Modified PuD, 5 on Unmodified) and a save
    copy; a wave adds its MAJ3 merge of two ranges and one park copy; an
    in-bank compound merge is 3 ops a connective (Ambit)."""
    maj = 4 if modified else 5
    rng = 2 * cmp + 2 + int(modified) + maj + 1

    def term(t):
        return rng if t[0] == "q1" else 2 * rng + maj + 1

    name = q[0]
    if name == "q1":
        return rng + 1
    if name in ("q2", "q3", "q4"):
        return 2 * rng + maj + 1
    if name == "q5":
        return 2 * rng + maj + 1 + rng + 1
    _, _, merge, ops, terms = q
    if merge == "dram":
        return sum(term(t) for t in terms) + 3 * len(ops) + 1
    return sum(rng + 1 if t[0] == "q1" else 2 * rng + maj + 1
               for t in terms)


def job_ops(job) -> dict:
    """PuD ops and READs per bank group in a machine job's timeline."""
    out: dict = {}
    for w in job.timeline.waves:
        pud, reads = out.get(w.group, (0, 0))
        if w.op.value == "read":
            reads += 1
        elif w.op.value != "write":
            pud += 1
        out[w.group] = (pud, reads)
    return out


def modeled(job, sys_cfg) -> dict:
    """A machine job's modeled numbers: the DRAM model of ``sys_cfg``,
    not the card's time."""
    from repro_torch.core import cost

    counts: dict = {}
    for w in job.timeline.waves:
        counts[w.op.value] = counts.get(w.op.value, 0) + 1
    return {"makespan_ns": job.stats.makespan_ns,
            "device_span_ns": job.timeline.device_span_ns,
            "overlapped_ns": job.stats.overlapped_ns,
            "serialized_ns": job.stats.serialized_ns,
            "energy_nj": cost.timeline_cost(job.timeline, sys_cfg).energy_nj,
            "commands": counts}


def run_machine_path(torch, report) -> dict:
    """Phase 13: ``PudSession(backend="machine")`` over the command-level
    PuD model whose bank state lives on the card.
    Every machine result is held against its NumPy reference and the
    same session's ``backend="fused"`` job bit for bit, every job's
    PuD ops per bank group against the closed forms, and the forest's
    predictions again after an evict with reload and a
    defragmentation.  Returns the launch counts of the path."""
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.core import cost
    from repro_torch.core.bitserial import bitserial_op_count
    from repro_torch.core.clutch import clutch_op_count
    from repro_torch.core.machine import PuDArch
    from repro_torch.pud import PudSession, queries as Q

    from torch.profiler import ProfilerActivity, profile

    records, batch = SERVE_RECORDS, MACHINE_BATCH
    t_phase = time.perf_counter()
    table = Table.generate(records, 8, num_features=8, seed=13)
    forest = G.ObliviousForest.random(num_trees=1000, depth=6,
                                      num_features=8, n_bits=8, seed=7)
    X = np.random.default_rng(14).integers(0, 256, (batch, 8),
                                           dtype=np.uint64)
    rep: dict = {"records": records, "n_bits": 8, "features": 8,
                 "devices": MACHINE_DEVICES, "system": cost.DESKTOP.name,
                 "arch": "modified", "generate_s":
                 time.perf_counter() - t_phase,
                 "modeled": "DRAM time and energy are the model of "
                            f"{cost.DESKTOP.name} (DDR4-2666), not the "
                            "card's"}
    torch.cuda.reset_peak_memory_stats()
    session = PudSession(num_devices=MACHINE_DEVICES,
                         arch=PuDArch.MODIFIED)
    sys_cfg = session.sys_cfg
    queries = machine_queries(Q, 255)
    refs = {}
    t0 = time.perf_counter()
    for name, q in queries:
        refs[name] = q.reference(table)
    rep["numpy_reference_s"] = time.perf_counter() - t0
    K.reset_launch_counts()

    def load(method: str) -> tuple:
        # under the profiler, whose spans split the load's host time:
        # the engines' record shards, load_vector's chunk extraction and
        # its upload, launch and row writes; it also reads the device
        # time of the temporal_encode launches and of the host copies
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            h = session.create_table(table, name=f"events_{method}",
                                     method=method)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        ex = session.executor(h)
        subs = [sub for _, sub in ex.placements]
        spans = {"PudQueryEngine.shard": 0.0, "load_vector.extract": 0.0,
                 "load_vector.encode": 0.0}
        encode_ms = htod_ms = 0.0
        for e in prof.key_averages():
            if e.device_type.name == "CPU":
                if e.key in spans:   # (not the spans' device-side twins)
                    spans[e.key] = e.cpu_time_total / 1e6
            elif e.device_type.name == "CUDA":
                if "temporal_encode_kernel" in e.key:
                    encode_ms += e.self_device_time_total / 1e3
                elif "HtoD" in e.key:
                    htod_ms += e.self_device_time_total / 1e3
        out = {
            "load_s": load_s,
            "powerup_draw_s": sum(s.powerup_ns[0] for s in subs) / 1e9,
            "upload_s": sum(s.powerup_ns[1] for s in subs) / 1e9,
            "shard_s": spans["PudQueryEngine.shard"],
            "chunk_extract_s": spans["load_vector.extract"],
            "chunk_upload_encode_write_s": spans["load_vector.encode"],
            "temporal_encode_device_ms": encode_ms,
            "htod_copies_device_ms": htod_ms,
            "groups": len(subs), "banks": sum(s.num_banks for s in subs),
            "cols": subs[0].num_cols,
            "rows_used": subs[0]._alloc_ptr,
            "bank_state_bytes": sum(s.state.numel() * 4 for s in subs),
            "chunks": getattr(ex.engines[0], "num_chunks", None)}
        # the rest of create_table: the table's checks, the planner's
        # admission, the executor's and engines' bookkeeping, the sync
        out["other_s"] = load_s - sum(out[k] for k in (
            "powerup_draw_s", "upload_s", "shard_s", "chunk_extract_s",
            "chunk_upload_encode_write_s"))
        return h, out

    def run_queries(h, method: str, cmp: int) -> dict:
        out = {}
        for name, q in queries:
            t0 = time.perf_counter()
            job = session.query(h, q)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            want = refs[name]
            if isinstance(want, np.ndarray):
                expect(np.array_equal(job.result, want),
                       f"machine {method} {name}: bitmap")
            elif isinstance(want, float):   # Q4's mean, as check holds it
                expect(abs(job.result - want) < 1e-9,
                       f"machine {method} {name}: {job.result} vs {want}")
            else:
                expect(job.result == want,
                       f"machine {method} {name}: {job.result} vs {want}")
            fused = session.query(h, q, backend="fused") \
                if method == "clutch" else None
            if fused is not None:
                same = (np.array_equal(job.result, fused.result)
                        if isinstance(want, np.ndarray)
                        else job.result == fused.result)
                expect(same, f"machine {name} differs from fused")
            ops = job_ops(job)
            want_ops = machine_pud_ops(q.to_tuple(), cmp, modified=True)
            expect(len(ops) == 2 * MACHINE_DEVICES and all(
                p == want_ops for p, _ in ops.values()),
                f"machine {method} {name}: PuD ops per group "
                f"{sorted(set(p for p, _ in ops.values()))} vs the "
                f"closed form {want_ops}")
            out[name] = {"card_wall_s": wall_s,
                         "pud_ops_per_group": want_ops,
                         "reads_per_group": max(r for _, r in ops.values()),
                         "fused_wall_ms": None if fused is None
                         else fused.wallclock_ns / 1e6,
                         **modeled(job, sys_cfg)}
        return out

    # ---- the table, Clutch (the paper's 2 chunks) then bit-serial ---- #
    h, rep["clutch_load"] = load("clutch")
    groups = 2 * MACHINE_DEVICES
    banks = groups * -(-(-(-records // groups)) // 65536)  # 512 at 2^25
    expect(rep["clutch_load"]["banks"] == banks,
           f"{rep['clutch_load']['banks']} banks, not {banks}")
    cmp = clutch_op_count(rep["clutch_load"]["chunks"], PuDArch.MODIFIED)
    rep["clutch"] = run_queries(h, "clutch", cmp)
    session.drop(h)
    h, rep["bitserial_load"] = load("bitserial")
    rep["bitserial"] = run_queries(
        h, "bitserial", bitserial_op_count(8, PuDArch.MODIFIED))
    session.drop(h)
    # modeled: the makespan holds the host merges the card's host timed;
    # the device span is the DRAM side alone
    rep["clutch_over_bitserial_modeled"] = {
        name: {k: rep["clutch"][name][k] / rep["bitserial"][name][k]
               for k in ("makespan_ns", "device_span_ns")}
        for name, _ in queries}

    # ---- the forest: 2 groups of 4 banks a device, rowclone replicas -- #
    t0 = time.perf_counter()
    fh = session.load_forest(forest, name="rank", groups_per_device=2,
                             banks_per_group=4, replicate="rowclone")
    torch.cuda.synchronize()
    fex = session.executor(fh)
    rep["forest_load_s"] = time.perf_counter() - t0
    rep["forest_wave_width"] = fex.wave_width
    expect(fex.wave_width == 64, f"wave width {fex.wave_width}")
    addrs = np.ascontiguousarray(G.reference_leaf_addrs(forest, X))
    want = G.assemble_leaves(forest.leaves, addrs)
    ref_err = float(np.abs(want - G.reference_predict(forest, X)).max())
    expect(ref_err <= 1e-3, f"assemble_leaves vs reference_predict {ref_err}")

    def predict(fh, n: int, what: str) -> tuple:
        t0 = time.perf_counter()
        job = session.predict(fh, X[:n])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        expect(np.array_equal(job.result, want[:n]),
               f"machine predictions {what}")
        return job, wall_s

    # this job alone runs under verify="strict", its lint timed apart
    # (``card_wall_s`` holds it)
    lint_s: list = []
    timed_lint(session, lint_s)
    session.verify = "strict"
    job, wall_s = predict(fh, batch, "")
    session.verify = "off"
    expect(len(lint_s) == 1, f"{len(lint_s)} lints of the GBDT job")
    fused = session.predict(fh, X, backend="fused")
    expect(np.array_equal(fused.result, job.result),
           "machine predictions differ from fused")
    per_inst = G.gbdt_ops_per_instance(forest, fex.engines[0].num_chunks,
                                       PuDArch.MODIFIED)
    waves = -(-batch // fex.wave_width)
    ops = job_ops(job)
    expect(all(p == waves * per_inst for p, _ in ops.values()),
           f"GBDT PuD ops per group {sorted(set(ops.values()))} vs "
           f"{waves} waves x {per_inst}")
    rep["gbdt"] = {"instances": batch, "waves": waves,
                   "pud_ops_per_instance": per_inst,
                   "card_wall_s": wall_s, "lint_s": lint_s[0],
                   "scheduled_waves": len(job.timeline.waves),
                   "fused_wall_ms": fused.wallclock_ns / 1e6,
                   **modeled(job, sys_cfg)}
    del fex

    # ---- planner: evict and reload, then defragment ------------------- #
    session.evict(fh)
    expect(fh.status == "evicted", f"status {fh.status} after evict")
    _, rep["reload_predict_s"] = predict(fh, MACHINE_RECHECK, "after the reload")
    fh2 = session.load_forest(forest, name="rank2", groups_per_device=2,
                              banks_per_group=4, replicate="rowclone")
    session.drop(fh)
    holes = [d.largest_free_run for d in session.devices]
    moved = sum(d.defragment() for d in session.devices)
    expect(moved == 16 * 4, f"{moved} banks moved, not 64")
    _, rep["defrag_predict_s"] = predict(fh2, MACHINE_RECHECK,
                                         "after the defragmentation")
    rep["planner"] = {**session.planner_stats(),
                      "largest_free_run_before_defrag": holes,
                      "defrag_banks_moved": moved}
    session.drop(fh2)
    counts = K.launch_counts()
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched on the machine path")
    rep["launches"] = counts
    rep["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rep["phase_s"] = time.perf_counter() - t_phase
    report["machine"] = rep
    return counts


def timed_lint(session, into: list, streams: dict | None = None) -> None:
    """Wrap ``session._lint_job``: each call's host seconds go to
    ``into``, and each job's linted streams to ``streams`` by the id of
    its timeline."""
    real = session._lint_job

    def lint(ex, timeline):
        t0 = time.perf_counter()
        real(ex, timeline)
        into.append(time.perf_counter() - t0)
        if streams is not None:
            streams[id(timeline)] = ex._job_streams()

    session._lint_job = lint


def machine_summary(rep: dict) -> dict:
    """Phase 13's numbers for standard output: the card's own (wall
    seconds, load split, state bytes, peak memory) beside the modeled
    DESKTOP DRAM numbers, each labelled."""
    jobs = {f"{m}:{name}": {k: r[k] for k in (
        "card_wall_s", "fused_wall_ms", "makespan_ns", "device_span_ns",
        "energy_nj", "commands")}
        for m in ("clutch", "bitserial") for name, r in rep[m].items()}
    return {**{k: rep[k] for k in (
        "records", "devices", "system", "modeled", "generate_s",
        "clutch_load", "bitserial_load", "forest_load_s",
        "clutch_over_bitserial_modeled", "gbdt", "reload_predict_s",
        "defrag_predict_s", "launches", "max_memory_allocated_gb",
        "phase_s")}, "jobs": jobs}


# --------------------------------------------------------------------- #
# Phase 14: verified, autoscaled machine serving
# --------------------------------------------------------------------- #

def pin_bytes(tl, PuDOp):
    """``mutations.mut_clone_io``'s edit (pin bytes on an in-DRAM wave)
    on the timeline's first in-DRAM wave: a ``cost.DESKTOP`` job issues
    no MRACT wave, the one ``mut_clone_io`` looks for."""
    waves = list(tl.waves)
    k = next(i for i, w in enumerate(waves)
             if w.op not in (PuDOp.READ, PuDOp.WRITE))
    waves[k] = dataclasses.replace(waves[k], io_bytes=16.0)
    return dataclasses.replace(tl, waves=waves)


def run_verified_serving_path(torch, report) -> dict:
    """Phase 14: phase 13's machine session under ``verify="strict"``,
    every trace it records linted, serving phase 12's mixes plain and
    autoscaled.  Every check fails the run; the serving numbers are the
    loop's simulated clock of modeled makespans and are reported, not
    gated.  Returns the launch counts of the path."""
    import repro_torch.kernels as K
    from repro_torch.analysis import mutations, pudlint
    from repro_torch.apps import gbdt as G
    from repro_torch.apps.predicate import Table
    from repro_torch.core import machine as M
    from repro_torch.core.machine import PuDArch, PuDOp
    from repro_torch.pud import PudSession, queries as Q
    from repro_torch.serve import admission as A, arrivals as Arr
    from repro_torch.serve import autoscaler as AS
    from repro_torch.serve import batcher as B, loop as L
    from repro_torch.serve import pud_service as S

    t_phase = time.perf_counter()
    table = Table.generate(SERVE_RECORDS, 8, num_features=8, seed=13)
    forest = G.ObliviousForest.random(num_trees=1000, depth=6,
                                      num_features=8, n_bits=8, seed=7)
    rep: dict = {"records": SERVE_RECORDS, "devices": VERIFY_DEVICES,
                 "arrivals_per_class": SERVE_ARRIVALS,
                 "load_frac": VERIFY_LOAD_FRAC,
                 "modeled": "p50, p99, goodput, durations and decisions "
                            "are the loop's simulated clock: makespans of "
                            "cost.DESKTOP (DDR4-2666, host merges timed "
                            "on the card's host), not the card's time"}
    collector = pudlint.TraceCollector()
    M._LINT_REGISTRY = collector
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        st = mutations.self_test(device="cuda")   # raises on a miss
        rep["self_test"] = {"classes": st["classes"],
                            "distinct_codes": st["distinct_codes"],
                            "s": time.perf_counter() - t0}
        expect(st["classes"] == 21 and st["distinct_codes"] >= 8,
               f"self-test {st}")

        session = PudSession(num_devices=VERIFY_DEVICES,
                             arch=PuDArch.MODIFIED, backend="machine",
                             verify="strict")
        lint_s: list = []
        streams_of: dict = {}
        timed_lint(session, lint_s, streams_of)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        th = session.create_table(table, name="events")
        torch.cuda.synchronize()
        rep["table_load_s"] = time.perf_counter() - t0
        enc_table = K.launch_counts()["temporal_encode"]
        t0 = time.perf_counter()
        fh = session.load_forest(forest, name="rank", groups_per_device=2,
                                 banks_per_group=4, replicate="rowclone")
        torch.cuda.synchronize()
        rep["forest_load_s"] = time.perf_counter() - t0
        enc_all = K.launch_counts()["temporal_encode"]
        expect(th.status == fh.status == "ready",
               f"after the loads: table {th.status}, forest {fh.status}")
        expect(enc_table > 0 and enc_all > enc_table,
               f"temporal_encode launched {enc_table} times for the table, "
               f"{enc_all - enc_table} for the forest")
        rep["temporal_encode_launches"] = {"table": enc_table,
                                           "forest": enc_all - enc_table}
        subs = {h.name: [sub for _, sub in session.executor(h).placements]
                for h in (th, fh)}
        rep["bank_state_bytes"] = {name: sum(x.state.numel() * 4 for x in v)
                                   for name, v in subs.items()}
        rep["banks"] = {name: sum(x.num_banks for x in v)
                        for name, v in subs.items()}
        expect(rep["bank_state_bytes"]["events"] == 2 ** 32,
               f"table bank state {rep['bank_state_bytes']['events']} bytes")
        # the loads' whole traces, from reset, and the self-test's
        t0 = time.perf_counter()
        loads = collector.drain()
        rep["load_drain_s"] = time.perf_counter() - t0
        rep["subarrays_registered"] = collector.count
        expect(loads.ok, "load traces: " + loads.summary())

        # capacity and deadline from the probe batch's modeled makespan
        probe = probe_batch(Q)
        job = session.query(th, probe)
        session.clear_traces(th)        # one job a resource between lints
        with ThreadPoolExecutor(4) as pool:
            for done in [pool.submit(
                    check_served_result,
                    S.PudRequest(rid=-1, resource="events", query=q),
                    got, table, forest)
                    for q, got in zip(probe, job.result)]:
                done.result()
        m_probe = job.makespan_ns
        cap_rps = len(probe) / (m_probe / 1e9)
        deadline_ns = 1.0 * m_probe
        rep.update(m_probe_ms_modeled=m_probe / 1e6,
                   cap_rps_modeled=cap_rps,
                   deadline_ms_modeled=deadline_ns / 1e6)
        classes = (Arr.ClassSpec("interactive", weight=4.0,
                                 deadline_ns=deadline_ns),
                   Arr.ClassSpec("bulk", weight=1.0))
        arrivals = serving_arrivals(Arr, VERIFY_LOAD_FRAC * cap_rps,
                                    deadline_ns, 23)
        requests = {a.rid: a.request for a in arrivals}

        RecordingService, RecordingBatcher = recording_batcher(B, S)
        svc = RecordingService(session)
        cfg, hosts = session.sys_cfg, session.hosts
        planner0 = session.planner_stats()
        rng = np.random.default_rng(14)
        rep["runs"] = {}
        runs = {}
        for name in ("plain", "autoscaled"):
            session.sys_cfg = cfg
            session.set_hosts(hosts)
            scaler, decide_s = None, []
            if name == "autoscaled":
                scaler = AS.UtilizationAutoscaler(
                    session, lane_options=(1, 2, 4),
                    host_options=("shared", "per-device"), window=1,
                    lo_util=0.0, hi_util=0.0)   # re-evaluates every job
                rescale = scaler._rescale

                def timed_rescale(ex, util, rescale=rescale):
                    t0 = time.perf_counter()
                    out = rescale(ex, util)
                    decide_s.append(time.perf_counter() - t0)
                    return out

                scaler._rescale = timed_rescale
            batcher = RecordingBatcher(svc)
            adm = A.AdmissionController(classes,
                                        capacity=4 * SERVE_MAX_BATCH,
                                        starvation_bound=2 * SERVE_MAX_BATCH)
            loop = L.ServingLoop(svc, adm, batcher, autoscaler=scaler,
                                 max_batch=SERVE_MAX_BATCH)
            dispatch = loop._dispatch
            retired = []

            def checked_dispatch(taken, now, res, dispatch=dispatch,
                                 retired=retired):
                n0 = len(res.records)
                out = dispatch(taken, now, res)
                for rname in {requests[r.rid].resource_name
                              for r in res.records[n0:]
                              if r.start_ns is not None}:
                    ex = session.planner.resources[rname].executor
                    expect(ex is not None, f"{name}: {rname} was evicted")
                    expect(all(not e.sub.trace.entries
                               and not e.sub.trace.host_events
                               for e in ex.engines),
                           f"{name}: {rname}'s traces not retired")
                    retired.append(rname)
                return out

            loop._dispatch = checked_dispatch
            svc.probes.clear()
            n_lint = len(lint_s)
            t0 = time.perf_counter()
            res = loop.run(arrivals)
            torch.cuda.synchronize()
            real_s = time.perf_counter() - t0
            jobs_run = len(svc.probes)
            expect(len(lint_s) - n_lint == jobs_run,
                   f"{name}: {len(lint_s) - n_lint} lints of {jobs_run} "
                   "jobs")
            expect(res.offered == len(arrivals),
                   f"{name}: {res.offered} records of {len(arrivals)}")
            for r in res.records:
                expect(r.ok or bool(r.error),
                       f"{name}: failed request {r.rid} carries no error")
            committed = [r for out, _ in batcher.dispatches
                         for r in out.responses if r.ok]
            expect(len(committed) == res.completed,
                   f"{name}: {len(committed)} ok responses, "
                   f"{res.completed} completed")
            full = name == "autoscaled"
            if not full and len(committed) > SERVE_SAMPLE:
                pick = rng.choice(len(committed), SERVE_SAMPLE, replace=False)
                committed = [committed[i] for i in sorted(pick)]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(4) as pool:
                for done in [pool.submit(check_served_result,
                                         requests[r.rid], r.result, table,
                                         forest) for r in committed]:
                    done.result()
            check_s = time.perf_counter() - t0
            if scaler is not None:
                expect(len(scaler.decisions) >= 1,
                       "the always-trigger autoscaler took no decision")
                for d in scaler.decisions:
                    expect(d.predicted_ns <= d.static_best_ns,
                           f"decision {d} slower than the best static")
                expect(res.decisions == scaler.decisions,
                       "report.decisions differ from the scaler's")
            lints = lint_s[n_lint:]
            runs[name] = (res, batcher)
            rep["runs"][name] = {
                **res.to_json(),
                "p50_ms_modeled": res.p50_ns / 1e6,
                "p99_ms_modeled": res.p99_ns / 1e6,
                "duration_s_modeled": res.duration_ns / 1e9,
                "real_s": real_s, "jobs": jobs_run,
                "committed_jobs": sum(len(out.jobs)
                                      for out, _ in batcher.dispatches),
                "dispatches_retired": len(retired),
                "lint_s_median": float(np.median(lints)),
                "lint_s_max": max(lints), "lint_s_total": sum(lints),
                "results_checked": len(committed), "check_s": check_s,
                "decisions [host_lanes, hosts, predicted_ns, baseline_ns]":
                    None if scaler is None else [
                        [d.host_lanes, d.hosts, d.predicted_ns,
                         d.baseline_ns] for d in scaler.decisions],
                "autoscaler_s_per_decision": decide_s or None}
        session.sys_cfg = cfg
        session.set_hosts(hosts)
        planner1 = session.planner_stats()
        expect(planner1["evictions"] == planner0["evictions"],
               f"the planner evicted while serving: {planner1}")
        rep["planner"] = planner1

        # a committed job's timeline made invalid must not verify
        out, _ = runs["plain"][1].dispatches[0]
        tl = out.jobs[0].timeline
        streams = streams_of[id(tl)]
        expect(tl.verify(sys_cfg=cfg, streams=streams).ok,
               "a committed job's timeline does not verify")
        negative = {}
        for what, bad, code in (
                ("mut_op_swap", mutations.mut_op_swap(tl, streams), "PL307"),
                ("pin_bytes", pin_bytes(tl, PuDOp), "PL306")):
            try:
                bad.verify(sys_cfg=cfg, streams=streams)
                expect(False, f"{what}: Timeline.verify did not raise")
            except pudlint.PudLintError as err:
                codes = sorted(err.report.codes())
                expect(code in codes, f"{what}: {codes}, not {code}")
                negative[what] = codes
        rep["negative"] = negative

        # PL401: every dispatched request audited once, then the drain
        dispatched = sorted(r.rid for res, _ in runs.values()
                            for r in res.records if r.start_ns is not None)
        audited = sorted(x["rid"] for x in collector._serving)
        expect(audited == dispatched,
               f"{len(audited)} PL401 records of {len(dispatched)} "
               "dispatched requests")
        rep["pl401_records"] = len(audited)
        t0 = time.perf_counter()
        final = collector.drain()
        rep["final_drain_s"] = time.perf_counter() - t0
        expect(final.ok, "final drain: " + final.summary())
        rep["final_drain_diagnostics"] = len(final.diagnostics)
        rep["jobs_linted"] = len(lint_s)
        rep["lint_s_median"] = float(np.median(lint_s))
        rep["lint_s_max"] = max(lint_s)
        counts = K.launch_counts()
        expect(counts["temporal_encode"] == enc_all,
               "temporal_encode launched outside the loads")
        rep["launches"] = counts
        rep["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    finally:
        M._LINT_REGISTRY = None
    del session, svc, runs, job, tl, streams, streams_of, out, subs
    free(torch)
    rep["phase_s"] = time.perf_counter() - t_phase
    report["verified_serving"] = rep
    return counts


def verified_summary(rep: dict, machine: dict) -> dict:
    """Phase 14's numbers for standard output: the card's own (host
    seconds, bytes, peak memory), phase 13's GBDT lint, and the modeled
    serving numbers, each labelled."""
    keys = ("offered", "completed", "shed", "splits", "probes", "jobs",
            "committed_jobs", "p50_ms_modeled", "p99_ms_modeled",
            "goodput_rps", "duration_s_modeled", "real_s",
            "dispatches_retired", "lint_s_median", "lint_s_max",
            "results_checked", "check_s",
            "decisions [host_lanes, hosts, predicted_ns, baseline_ns]",
            "autoscaler_s_per_decision")
    return {**{k: rep[k] for k in (
        "records", "devices", "modeled", "self_test", "table_load_s",
        "forest_load_s", "bank_state_bytes", "banks",
        "temporal_encode_launches", "load_drain_s", "final_drain_s",
        "subarrays_registered", "m_probe_ms_modeled", "cap_rps_modeled",
        "deadline_ms_modeled", "jobs_linted", "lint_s_median", "lint_s_max",
        "pl401_records", "negative", "max_memory_allocated_gb",
        "phase_s")},
        "phase13_gbdt_lint_s": machine["gbdt"]["lint_s"],
        "phase13_gbdt_scheduled_waves": machine["gbdt"]["scheduled_waves"],
        "runs": {name: {k: r[k] for k in keys}
                 for name, r in rep["runs"].items()}}


# --------------------------------------------------------------------- #
# Phase 15: the mesh layer
# --------------------------------------------------------------------- #

def mesh_train_reduced(torch, plain_rows: list) -> list:
    """Phase 9's reduced granite in float32 on the card, 2 steps (2
    microbatches) through ``jit_train_step`` on a one-rank host mesh:
    each step's loss and grad_norm within ``CARD_CPU_RTOL`` of phase 9's
    ``make_train_step`` on the card (``plain_rows``), so step 1's loss
    holds step 0's update and the gradients accumulated on DTensors."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import device_put, shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    cfg = get_config(TRAIN_ARCH).reduced()
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    mesh = make_host_mesh()
    pspecs = M.param_specs(cfg)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = device_put(params, shardings(mesh, pspecs, params))
    opt = O.init_opt_state(oc, params)
    opt = device_put(opt, shardings(mesh, O.opt_state_specs(pspecs), opt))
    src = SyntheticLM(cfg, SHAPES["train_4k"].reduced(), seed=0,
                      microbatches=2)
    first = src.batch_at(0)
    step = T.jit_train_step(cfg, oc, mesh, {
        k: (tuple(v.shape), str(v.dtype)) for k, v in first.items()})
    rows = []
    for i in range(2):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in src.batch_at(i).items()}
        params, opt, st = step(params, opt, batch)
        rows.append([float(st["loss"]), float(st["grad_norm"])])
    for i, (a, b) in enumerate(zip(rows, plain_rows)):
        for x, y in zip(a, b):
            expect(np.isfinite(x) and abs(x - y) <= CARD_CPU_RTOL * abs(y),
                   f"reduced mesh vs plain step {i}: {a} vs {b}")
    del params, opt
    free(torch)
    return rows


def mesh_training(torch, plain: dict) -> dict:
    """(a) full-width granite, 2 steps of phase 9's batches through
    ``jit_train_step`` on a one-rank host mesh: step 0's loss and
    grad_norm within phase 10's 2e-2 of phase 9's (``plain``, phase 9's
    report), parameters and moments DTensors on the card; before it the
    reduced model's 2 steps against phase 9's within 1e-5
    (:func:`mesh_train_reduced`)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.sharding import device_put, shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as T

    reduced = mesh_train_reduced(
        torch, plain["card_vs_cpu"]["train_loss_grad_norm"])
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    oc = O.OptConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=MESH_TRAIN_STEPS, opt_dtype=cfg.opt_dtype)
    mesh = make_host_mesh()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pspecs = M.param_specs(cfg)
    params = M.init_params(cfg, torch.Generator("cuda").manual_seed(0))
    params = device_put(params, shardings(mesh, pspecs, params))
    opt = O.init_opt_state(oc, params)
    opt = device_put(opt, shardings(mesh, O.opt_state_specs(pspecs), opt))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def on_card(tree) -> bool:
        return all(isinstance(t, DTensor) and t.to_local().is_cuda
                   for t in param_leaves(tree))

    expect(on_card(params) and on_card(opt),
           "parameters and moments on the card as DTensors")
    src = SyntheticLM(cfg, shape, seed=0, microbatches=TRAIN_MICRO)
    first = {k: torch.from_numpy(v) for k, v in src.batch_at(0).items()}
    step = T.jit_train_step(cfg, oc, mesh, {
        k: (tuple(v.shape), str(v.dtype)) for k, v in first.items()})
    losses, norms, steps_ms = [], [], []
    for i in range(MESH_TRAIN_STEPS):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in src.batch_at(i).items()}
        t = time.perf_counter()
        params, opt, st = step(params, opt, batch)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(st["loss"]))
        norms.append(float(st["grad_norm"]))
    expect(all(np.isfinite(losses + norms)),
           f"mesh training losses {losses}, grad norms {norms}")
    for what, got, want in (("loss", losses[0], plain["losses"][0]),
                            ("grad_norm", norms[0],
                             plain["grad_norms"][0])):
        expect(abs(got - want) <= OPT_LOSS0_RTOL * abs(want),
               f"mesh step-0 {what} {got} vs phase 9's {want}")
    expect(on_card(params) and on_card(opt),
           "parameters and moments stay DTensors on the card")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, batch
    free(torch)
    return {"mesh": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
            "reduced_f32_loss_grad_norm": reduced,
            "losses": losses, "grad_norms": norms,
            "losses_phase9": plain["losses"][:MESH_TRAIN_STEPS],
            "grad_norms_phase9": plain["grad_norms"][:MESH_TRAIN_STEPS],
            "step_ms": steps_ms, "setup_s": setup_s, "peak_gb": peak}


def mesh_session(torch, table, tshape: dict, forest, X, addrs, predictions
                 ) -> tuple[dict, dict]:
    """(b) phase 3's table and phase 4's forest through the fused
    executors over ``shard_mesh(2)`` (one rank here): every bitmap and
    count equal to its NumPy reference and to phase 3's, the leaf
    addresses and predictions to phase 4's, bit for bit.  Returns (the
    report, the launch counts)."""
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.dist.sharding import shard_mesh
    from repro_torch.kernels.fused_session import (
        FusedGbdtExec,
        FusedTableExec,
    )
    from repro_torch.pud import queries as Q

    mesh = shard_mesh(tshape["shards"])
    K.reset_launch_counts()
    t0 = time.perf_counter()
    tx = FusedTableExec(table, tshape["shards"], tshape["chunks"],
                        mesh=mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    expect(tx.lut.shape[0] == tshape["shards"] // mesh.size(),
           f"rank LUT of {tx.lut.shape[0]} shards")
    queries = {}
    for name, q in table_queries(Q, (1 << 32) - 1):
        t = time.perf_counter()
        got = tx.run([q.to_tuple()])[0]
        wall = (time.perf_counter() - t) * 1e3
        want = q.reference(table)
        if isinstance(want, np.ndarray):
            expect(np.array_equal(got, want), f"mesh {name} bitmap")
            summary = int(got.sum())
        else:
            expect(q.check(table, got), f"mesh {name}: {got} vs {want}")
            summary = got
        expect(summary == tshape["queries"][name]["result"],
               f"mesh {name}: {summary} vs phase 3's "
               f"{tshape['queries'][name]['result']}")
        queries[name] = {"wallclock_ms": wall, "result": summary}
    del tx
    free(torch)
    gx = FusedGbdtExec(forest, tshape["forest_chunks"], mesh=mesh)
    t = time.perf_counter()
    got_addrs = gx.leaf_addrs(X)
    predict_ms = (time.perf_counter() - t) * 1e3
    expect(np.array_equal(got_addrs, addrs), "mesh leaf addresses")
    expect(np.array_equal(G.assemble_leaves(forest.leaves, got_addrs),
                          predictions), "mesh predictions")
    counts = K.launch_counts()
    for k in ("temporal_encode", "fused_predicate_banked",
              "fused_compound_banked", "gbdt_leafbits_banked"):
        expect(counts[k] > 0, f"{k} not launched on the mesh path")
    del gx
    free(torch)
    return ({"mesh": [mesh.size()], "shards": tshape["shards"],
             "lut_build_s": build_s, "queries": queries,
             "leaf_addrs_ms": predict_ms, "launches": counts}, counts)


def run_dryrun(out_dir: str) -> dict:
    """(c) the dry run of :data:`DRYRUN_CELLS` on the fake 256-rank
    production mesh, one ``python -m repro_torch.launch.dryrun`` process
    a cell, all started together once the card's phases are done (on
    the CPU; the fake group needs a process of its own), and their
    records: each cell's per-device bytes, roofline terms and bottleneck
    (modeled, 256 x H100); per-device parameter and moment bytes times
    the chips at least the whole tensors' bytes, and a finite, positive
    model-FLOP ratio."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "CUDA_VISIBLE_DEVICES": ""}
    t0 = time.perf_counter()
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--out", out_dir],
        env=env, cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for cell in DRYRUN_CELLS}
    try:
        for (arch, shape), proc in procs.items():
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            _, err = proc.communicate(timeout=max(left, 1.0))
            expect(proc.returncode == 0, f"dry run {arch} {shape}: exit "
                   f"{proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.perf_counter() - t0
    cells = {}
    for arch, shape in DRYRUN_CELLS:
        path = Path(out_dir) / f"{arch}_{shape}_pod1.json"
        r = json.loads(path.read_text())
        chips = r["chips"]
        expect(chips == 256 and r["mesh"] == "16x16", f"{path.name} mesh")
        for k, v in r["per_device_bytes"].items():
            expect(v * chips >= r["unsharded_bytes"][k],
                   f"{arch} {shape}: {k} {v} x {chips} < "
                   f"{r['unsharded_bytes'][k]}")
        ratio = r["model_flops_ratio"]
        expect(np.isfinite(ratio) and ratio > 0,
               f"{arch} {shape}: model_flops_ratio {ratio}")
        cells[f"{arch} {shape}"] = {
            k: r[k] for k in ("microbatches", "memory_analysis",
                              "per_device_bytes", "unsharded_bytes",
                              "full_step_collectives", "roofline",
                              "model_flops_ratio", "compile_s", "total_s")}
    return {"cells": cells, "wall_s": wall_s,
            "label": "modeled, 256 x H100 (fake process group)"}


def run_mesh_path(torch, report, table, tshape, forest, X, addrs,
                  predictions) -> dict:
    """Phase 15: the mesh layer on a one-rank NCCL group (a local
    store; destroyed at the end of (b)): (a) training through
    ``jit_train_step``, (b) the fused session over ``shard_mesh(2)``,
    then (c) the dry run's cells.  Returns the launch counts of (b)."""
    import torch.distributed as dist

    t_phase = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        rep = {"train": mesh_training(torch, report["train"])}
        log(f"phase 15a: mesh training ok {json.dumps(rep['train'])}")
        rep["session"], counts = mesh_session(
            torch, table, tshape, forest, X, addrs, predictions)
        log(f"phase 15b: fused session over the mesh ok "
            f"{json.dumps(rep['session'])}")
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as out:
        rep["dryrun"] = run_dryrun(out)
    rep["phase_s"] = time.perf_counter() - t_phase
    report["mesh"] = rep
    return counts


def mesh_summary(rep: dict) -> dict:
    """Phase 15's stdout line: the card's numbers, then the dry run's,
    labelled modeled."""
    cells = {}
    for name, c in rep["dryrun"]["cells"].items():
        rf = c["roofline"]
        cells[name] = {
            "argument_bytes_per_device":
                c["memory_analysis"]["argument_size_in_bytes"],
            "t_compute_s": rf["t_compute_s"], "t_memory_s": rf["t_memory_s"],
            "t_collective_s": rf["t_collective_s"],
            "bottleneck": rf["bottleneck"],
            "model_flops_ratio": c["model_flops_ratio"]}
    return {"train": {k: rep["train"][k] for k in (
                "reduced_f32_loss_grad_norm", "losses", "losses_phase9",
                "grad_norms", "grad_norms_phase9", "step_ms", "peak_gb")},
            "session": {"queries": rep["session"]["queries"],
                        "leaf_addrs_ms": rep["session"]["leaf_addrs_ms"],
                        "launches": rep["session"]["launches"]},
            "dryrun": {"label": rep["dryrun"]["label"], "cells": cells,
                       "wall_s": rep["dryrun"]["wall_s"]},
            "phase_s": rep["phase_s"]}


# --------------------------------------------------------------------- #
# Phase 8: times and bounds at the main path's shapes
# --------------------------------------------------------------------- #

def median_ms(torch, fn, reps: int = 20, batch: int = 1) -> float:
    """Median over ``reps`` of the time between two CUDA events around
    ``batch`` calls, per call; a batch keeps kernels of a few
    microseconds above the events' own resolution."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return float(np.median(times))


def cold_ms(torch, fn, flush, reps: int = 20) -> float:
    """Median time of one launch with the L2 cache flushed before it
    (``flush``, a buffer several times the 50 MB L2, is read first; a
    read and not a write, so no dirty line is left for the kernel to
    write back): the kernel's own time on data in device memory, as the
    byte bound assumes.  The flush keeps the card busy while the host
    runs the wrapper, so the events see the kernel and not the host."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        flush.max()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def warm_ms(torch, fn, touch, reps: int = 20) -> float:
    """Median time of one launch on inputs in L2: ``touch`` reads them
    first (as ``amax`` reads the logits right before the mask on the LM
    path).  A busy wait on the card ahead of both keeps the host's
    wrapper time out of the event pair, so the events see the kernel."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000)
        touch()
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(torch, a, b) -> int | float:
    torch.cuda.synchronize()
    if a.shape != b.shape:
        raise RuntimeError(f"shapes differ: {a.shape} vs {b.shape}")
    if a.is_floating_point():
        return float((a - b).abs().max())
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def read_rows(idx: np.ndarray, c: int, n_ranges: int) -> int:
    """Distinct LUT rows a predicate reads (``le[0]`` of a side is never
    read)."""
    rows = set()
    for rix in range(n_ranges):
        for side in (0, 2 * c):
            o = rix * 4 * c + side
            rows.update(int(i) for i in idx[o:o + c])
            rows.update(int(i) for i in idx[o + c + 1:o + 2 * c])
    return len(rows)


def merge_rows(lt, le) -> int:
    """Distinct rows one Algorithm 1 merge reads (``le[0]`` never)."""
    return len({int(i) for i in lt} | {int(i) for i in le[1:]})


def measure(torch, table_ex, gbdt_ex, X, addrs, lm_logits, lm_tau, launches,
            report):
    import repro_torch.kernels as K
    from repro_torch.apps import gbdt as G
    from repro_torch.core.encoding import make_plan
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.common import quad_rows
    from repro_torch.kernels.leaf_gather import route as leaf_route
    from repro_torch.pud import queries as Q

    cuda = torch.device("cuda")
    rows = []
    # every kernel is also timed alone after an L2 flush (report
    # "cold_ms", and the row's "cold_ms"): the time its byte bound is for
    cold = report.setdefault("cold_ms", {})
    flush = torch.ones(64 << 20, dtype=torch.int32, device=cuda)
    # an empty launch (a spin of 0 cycles) timed the same way: the part
    # of every cold time that is not the kernel's work
    empty_ms = cold_ms(torch, lambda: torch.cuda._sleep(0), flush)

    def floor(n_rows: int, words: int) -> dict:
        """The floor of one pass over the rows a gather reads: the bytes
        its bound counts, read by x.amax(dim=0) from a contiguous
        [n_rows, words] int32 tensor, cold; beside it the empty launch."""
        x = torch.ones((n_rows, words), dtype=torch.int32, device=cuda)
        ms = cold_ms(torch, lambda: x.amax(dim=0), flush)
        del x
        return {"floor_amax_cold_ms": ms, "empty_launch_cold_ms": empty_ms}

    def entry(name, got, want, ms, plain_ms, nbytes, nops, extra=None,
              tol=0, library_ms=None, cold_key=None):
        b_ms, b_by = bound(nbytes, nops)
        err = 0
        for g, w in zip(got, want):
            err = max(err, max_abs_err(torch, g, w))
        expect(err <= tol, f"{name} disagrees with its plain version: {err}")
        src, rep = KERNEL_META[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": err, "ms": ms,
                     "cold_ms": cold[cold_key or name], "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        if extra:
            report.setdefault("bounds", {})[name] = extra

    # temporal_encode: one 4-bit chunk of one table shard's column
    w = table_ex.lut.shape[2]
    k = table_ex._cplans[0].widths[0]
    vals = torch.randint(0, 1 << k, (w, 32), dtype=torch.int32, device=cuda)
    r = (1 << k) - 1
    got = K.temporal_encode(vals, k)
    want = ref.temporal_encode_ref(vals.reshape(-1), k)
    cold["temporal_encode"] = cold_ms(
        torch, lambda: K.temporal_encode(vals, k), flush)
    entry("temporal_encode", [got], [want],
          median_ms(torch, lambda: K.temporal_encode(vals, k)),
          median_ms(torch, lambda: ref.temporal_encode_ref(
              vals.reshape(-1), k), reps=5),
          w * 32 * 4 + r * w * 4, r * w * 32,
          {"shape": [w, 32], "k": k})

    # fused_predicate_banked: Q2's two ranges over the full stacked LUT
    lut = table_ex.lut
    s, _, w = lut.shape
    c = table_ex.num_chunks
    mx = (1 << 32) - 1
    q2 = table_queries(Q, mx)[1][1]
    idx = np.concatenate([table_ex._range_idx(q2.fi, q2.x0, q2.x1),
                          table_ex._range_idx(q2.fj, q2.y0, q2.y1)])
    didx = q2_idx = torch.from_numpy(idx).to(cuda)
    got = K.fused_predicate_banked(lut, didx, c, 2, False)
    want = ref.fused_predicate_banked_ref(lut, idx, c, 2, False)
    n_rows = read_rows(idx, c, 2)
    maj_ops = 2 * 2 * (c - 1) * 5 + 2 * 2
    cold["fused_predicate_banked"] = cold_ms(
        torch, lambda: K.fused_predicate_banked(lut, didx, c, 2, False), flush)
    entry("fused_predicate_banked", got, want,
          median_ms(torch, lambda: K.fused_predicate_banked(
              lut, didx, c, 2, False)),
          median_ms(torch, lambda: ref.fused_predicate_banked_ref(
              lut, idx, c, 2, False), reps=5),
          n_rows * s * w * 4 + s * w * 4 + idx.nbytes,
          s * w * (maj_ops + 1),
          {"lut_shape": list(lut.shape), "rows_read": n_rows,
           "quad_rows": quad_rows(lut),
           **floor(n_rows, s * w)})

    # fused_compound_banked: the 3-term compound of the table path
    cq = table_queries(Q, mx)[6][1]
    ranges, t_nr, t_disj = [], [], []
    for term in cq.terms:
        tk, *tp = term.to_tuple()
        rr = [tuple(tp)] if tk == "q1" else [tuple(tp[:3]), tuple(tp[3:])]
        ranges += rr
        t_nr.append(len(rr))
        t_disj.append(tk == "q3")
    conn = tuple(op == "or" for op in cq.ops)
    idx = np.concatenate([table_ex._range_idx(*r) for r in ranges])
    didx = torch.from_numpy(idx).to(cuda)
    shape = (tuple(t_nr), tuple(t_disj), conn)
    got = K.fused_compound_banked(lut, didx, c, *shape)
    want = ref.fused_compound_banked_ref(lut, idx, c, *shape)
    n_rows = read_rows(idx, c, len(ranges))
    cold["fused_compound_banked"] = cold_ms(
        torch, lambda: K.fused_compound_banked(lut, didx, c, *shape), flush)
    entry("fused_compound_banked", got, want,
          median_ms(torch, lambda: K.fused_compound_banked(
              lut, didx, c, *shape)),
          median_ms(torch, lambda: ref.fused_compound_banked_ref(
              lut, idx, c, *shape), reps=5),
          n_rows * s * w * 4 + s * w * 4 + idx.nbytes,
          s * w * (len(ranges) * (2 * (c - 1) * 5 + 1) + len(ranges)),
          {"terms": [list(x) for x in shape], "rows_read": n_rows,
           "quad_rows": quad_rows(lut),
           **floor(n_rows, s * w)})
    # rows 2-3 timed again, then on a fresh copy of the LUT: a slow state
    # of the card or process (PERF.md) shows in all of them as in the
    # first timing; one of the LUT's placement would leave the copy fast
    fresh = lut.clone()
    for name, fn in (
            ("fused_predicate_banked",
             lambda x: K.fused_predicate_banked(x, q2_idx, c, 2, False)),
            ("fused_compound_banked",
             lambda x: K.fused_compound_banked(x, didx, c, *shape))):
        report["bounds"][name].update(
            cold_ms_again=cold_ms(torch, lambda: fn(lut), flush),
            cold_ms_fresh_lut=cold_ms(torch, lambda: fn(fresh), flush))
    del fresh

    # gbdt_leafbits_banked: the 2^16-instance batch
    glut, masks = gbdt_ex.lut, gbdt_ex.masks
    gc, f = gbdt_ex.num_chunks, gbdt_ex.forest.num_features
    cols = []
    for fi in range(f):
        cols += list(ops.resolve_indices_banked(
            gbdt_ex.plan, X[:, fi].astype(np.int64)))
    gidx = torch.from_numpy(np.concatenate(cols, axis=1)).to(cuda)
    got = K.gbdt_leafbits_banked(glut, masks, gidx, gc, f)
    want = ref.gbdt_leafbits_banked_ref(glut, masks, gidx, gc, f)
    b, gw = gidx.shape[0], glut.shape[1]
    dram = (glut.numel() + masks.numel() + gidx.numel() + b * gw) * 4
    l2 = b * gw * 4 * f * (2 * gc - 1 + 1)
    cold["gbdt_leafbits_banked"] = cold_ms(
        torch, lambda: K.gbdt_leafbits_banked(glut, masks, gidx, gc, f), flush)
    entry("gbdt_leafbits_banked", [got], [want],
          median_ms(torch, lambda: K.gbdt_leafbits_banked(
              glut, masks, gidx, gc, f)),
          median_ms(torch, lambda: ref.gbdt_leafbits_banked_ref(
              glut, masks, gidx, gc, f), reps=5),
          dram, b * gw * f * ((gc - 1) * 5 + 2),
          {"lut_shape": list(glut.shape), "masks_shape": list(masks.shape),
           "idx_shape": list(gidx.shape), "dram_bytes": dram,
           "l2_bytes": l2})
    # the launch's fixed part: the same batch with one feature (the LUT
    # slices staged, the indices loaded, the whole bitmap written)
    g1 = gidx[:, :2 * gc].contiguous()
    report["bounds"]["gbdt_leafbits_banked"]["one_feature_cold_ms"] = cold_ms(
        torch, lambda: K.gbdt_leafbits_banked(glut, masks, g1, gc, 1), flush)

    # gbdt_leafbits_sum: that batch's leaf bits summed to predictions
    # (bulk-65536's shape), and its first 256 rows (online-256's); beside
    # them the host's assemble_leaves over the same addresses, which the
    # kernel replaces on the predict path
    lv, t, d = gbdt_ex.leaves, gbdt_ex.forest.num_trees, gbdt_ex.forest.depth
    nw = -(-t * d // 32)
    sums = {}
    for nb in (b, 256):
        bm = got[:nb]
        cold[f"gbdt_leafbits_sum {nb}"] = cold_ms(
            torch, lambda: K.gbdt_leafbits_sum(bm, lv, t, d), flush)
        sums[nb] = {
            "ms": median_ms(torch, lambda: K.gbdt_leafbits_sum(bm, lv, t, d),
                            batch=10),
            "cold_ms": cold[f"gbdt_leafbits_sum {nb}"],
            "plain_ms": median_ms(torch, lambda: ref.gbdt_leafbits_sum_ref(
                bm, lv, t, d), reps=5),
            "bound_ms": bound((nb * nw + t * lv.shape[1] + nb) * 4, nb * t)[0],
            "host_assemble_ms": 1e3 * min(timeit.repeat(
                lambda: G.assemble_leaves(gbdt_ex.forest.leaves,
                                          addrs[:nb]), number=1, repeat=3))}
    entry("gbdt_leafbits_sum", [K.gbdt_leafbits_sum(got, lv, t, d)],
          [ref.gbdt_leafbits_sum_ref(got, lv, t, d)], sums[b]["ms"],
          sums[b]["plain_ms"], (b * nw + t * lv.shape[1] + b) * 4, b * t,
          {"bitmap_shape": list(got.shape), "leaves_shape": list(lv.shape),
           "bitmap_bytes_read": b * nw * 4, "online_256": sums[256],
           "bulk_host_assemble_ms": sums[b]["host_assemble_ms"]},
          cold_key=f"gbdt_leafbits_sum {b}")

    # The front-end path's kernels, at its shapes: CUDA events around
    # batches of 10 launches, since several bounds are a few microseconds.

    def kernel_ms(name, fn):
        cold[name] = cold_ms(torch, fn, flush)
        return median_ms(torch, fn, batch=10)

    def plain(fn):
        return median_ms(torch, fn, reps=5)

    col = table_ex.table.features[0]
    ratios = []
    for n_bits, c in COMPARE_PLANS:
        _, vt = column_bits(torch, col, n_bits)
        a, plan = 1 << (n_bits - 1), make_plan(n_bits, c)
        lut = ops.encode_lut(vt, plan)
        lt, le = (torch.from_numpy(x).to(cuda)
                  for x in ops.resolve_indices(plan, a))
        w = lut.shape[1]
        got = K.clutch_merge(lut, lt, le)
        want = ref.clutch_merge_ref(lut, lt, le)
        clutch_ms = kernel_ms(f"clutch_merge {n_bits}/{c}",
                              lambda: K.clutch_merge(lut, lt, le))
        clutch_plain = plain(lambda: ref.clutch_merge_ref(lut, lt, le))
        n_rows = merge_rows(lt.tolist(), le.tolist())
        clutch_bytes = (n_rows + 1) * w * 4 + 2 * c * 4
        clutch_ops = w * 5 * (c - 1)
        quad = quad_rows(lut)
        del lut
        planes = ops.encode_bitplanes(vt, n_bits)
        bgot = K.bitserial_cmp(planes, a, n_bits)
        bwant = ref.bitserial_cmp_ref(planes, a, n_bits)
        bs_ms = kernel_ms(f"bitserial_cmp {n_bits}",
                          lambda: K.bitserial_cmp(planes, a, n_bits))
        bs_plain = plain(lambda: ref.bitserial_cmp_ref(planes, a, n_bits))
        bs_bytes, bs_ops = (n_bits + 1) * w * 4, w * 5 * n_bits
        ratios.append({
            "n_bits": n_bits, "chunks": c, "words": w,
            "clutch_ms": clutch_ms, "bitserial_ms": bs_ms,
            "time_ratio": bs_ms / clutch_ms,
            "cold_time_ratio": cold[f"bitserial_cmp {n_bits}"]
            / cold[f"clutch_merge {n_bits}/{c}"],
            "clutch_rows_read": n_rows,
            "byte_ratio": bs_bytes / clutch_bytes,
            "byte_ratio_2c_rows": (n_bits + 1) / (2 * c)})
        if n_bits == 32:
            entry("clutch_merge", [got], [want], clutch_ms, clutch_plain,
                  clutch_bytes, clutch_ops,
                  {"lut_words": w, "plan": [n_bits, c], "a": a,
                   "rows_read": n_rows, "quad_rows": quad,
                   **floor(n_rows, w)},
                  cold_key=f"clutch_merge {n_bits}/{c}")
            entry("bitserial_cmp", [bgot], [bwant], bs_ms, bs_plain,
                  bs_bytes, bs_ops,
                  {"planes_shape": list(planes.shape), "a": a},
                  cold_key=f"bitserial_cmp {n_bits}")
        del planes, vt
    report["clutch_vs_bitserial"] = ratios

    # clutch_merge_banked: two banks of 2^24, the second always true
    plan = make_plan(32, 5)
    _, vt = column_bits(torch, col, 32)
    luts = torch.stack([ops.encode_lut(x, plan) for x in vt.view(2, -1)])
    blt, ble = (torch.from_numpy(x).to(cuda) for x in
                ops.resolve_indices_banked(plan, np.array([1 << 31, -1])))
    b, _, w = luts.shape
    n_rows = sum(merge_rows(x, y) for x, y in zip(blt.tolist(), ble.tolist()))
    entry("clutch_merge_banked", [K.clutch_merge_banked(luts, blt, ble)],
          [ref.clutch_merge_banked_ref(luts, blt, ble)],
          kernel_ms("clutch_merge_banked 32/5",
                    lambda: K.clutch_merge_banked(luts, blt, ble)),
          plain(lambda: ref.clutch_merge_banked_ref(luts, blt, ble)),
          (n_rows + b) * w * 4 + blt.numel() * 8, b * w * 5 * 4,
          # the floor reads the same rows and writes one [W] row, where
          # the kernel writes B
          {"lut_shape": list(luts.shape), "rows_read": n_rows,
           "quad_rows": quad_rows(luts), **floor(n_rows, w)},
          cold_key="clutch_merge_banked 32/5")
    del luts

    # fused_range_count: Q1's range on column 0, 32 bits / 8 chunks
    mx, plan = (1 << 32) - 1, make_plan(32, 8)
    lut = ops.encode_lut(vt, plan)
    lut_c = ops.encode_lut(vt, plan, complement=True)
    idx = np.concatenate(ops.resolve_indices(plan, mx // 8)
                         + ops.resolve_indices(plan, mx - mx // 2))
    didx = torch.from_numpy(idx).to(cuda)
    w = lut.shape[1]
    n_rows = merge_rows(idx[:8], idx[8:16]) + merge_rows(idx[16:24],
                                                         idx[24:])
    entry("fused_range_count", K.fused_range_count(lut, lut_c, didx, 8),
          ref.fused_range_count_ref(lut, lut_c, idx, 8),
          kernel_ms("fused_range_count 32/8",
                    lambda: K.fused_range_count(lut, lut_c, didx, 8)),
          plain(lambda: ref.fused_range_count_ref(lut, lut_c, idx, 8)),
          (n_rows + 1) * w * 4 + idx.nbytes, w * (2 * 5 * 7 + 2),
          {"lut_shape": list(lut.shape), "rows_read": n_rows},
          cold_key="fused_range_count 32/8")
    del vt, lut, lut_c

    # leaf_gather: the GBDT path's [65536, 1000] leaf addresses
    at = torch.from_numpy(addrs).to(cuda)
    lv = torch.from_numpy(gbdt_ex.forest.leaves).to(cuda)
    b, t = at.shape
    nl = lv.shape[1]
    # the yardstick: one PyTorch call for the same sum over in-range
    # addresses, offset into the flattened table (never used by the port)
    flat = at.to(torch.int64) + torch.arange(t, device=cuda) * nl
    table = lv.reshape(-1, 1)
    lib_ms = median_ms(torch, lambda: torch.nn.functional.embedding_bag(
        flat, table, mode="sum"), batch=10)
    lib_err = max_abs_err(torch, torch.nn.functional.embedding_bag(
        flat, table, mode="sum")[:, 0], K.leaf_gather(at, lv))
    entry("leaf_gather", [K.leaf_gather(at, lv)],
          [ref.leaf_gather_ref(at, lv)],
          kernel_ms("leaf_gather", lambda: K.leaf_gather(at, lv)),
          plain(lambda: ref.leaf_gather_ref(at, lv)),
          (b * t + t * nl + b) * 4, b * t,
          {"addrs_shape": [b, t], "leaves_shape": [t, nl],
           "route_vec_staged": list(leaf_route(t, nl, at.data_ptr())),
           # the floor of one pass over the addresses: a PyTorch max
           "addrs_read_cold_ms": cold_ms(torch, lambda: at.max(), flush),
           "library_max_abs_err": lib_err},
          cold_key="leaf_gather",
          tol=LEAF_TOL, library_ms=lib_ms)

    # minp_mask: the LM path's [8, 256000] decode-step logits, and 16
    # copies of them as a [128, 256000] batch (report).  Beside the
    # kernel: the floor of a pass over the same bytes (y.copy_(x), cold),
    # and both warm, with the logits in L2 as amax leaves them on the path
    def library(x, t):
        return torch.where(x >= t[:, None], x, ref.MINP_FILL)

    minp = {}
    for reps in (16, 1):
        x = lm_logits.repeat(reps, 1).contiguous()
        t = lm_tau.repeat(reps)
        y = torch.empty_like(x)
        b, v = x.shape
        got, want = K.minp_mask(x, t), ref.minp_mask_ref(x, t)
        expect(same_bits(torch, got, want), f"minp_mask {b}x{v} bits")
        ms = kernel_ms(f"minp_mask {b}x{v}", lambda: K.minp_mask(x, t))
        lib_ms = median_ms(torch, lambda: library(x, t), batch=10)
        cold[f"torch.where {b}x{v}"] = cold_ms(torch, lambda: library(x, t),
                                               flush)
        cold[f"copy_ {b}x{v}"] = cold_ms(torch, lambda: y.copy_(x), flush)
        minp[f"{b}x{v}"] = {
            "ms": ms, "cold_ms": cold[f"minp_mask {b}x{v}"],
            "warm_ms": warm_ms(torch, lambda: K.minp_mask(x, t),
                               lambda: x.amax(-1)),
            "copy_cold_ms": cold[f"copy_ {b}x{v}"],
            "empty_launch_cold_ms": empty_ms,
            "copy_warm_ms": warm_ms(torch, lambda: y.copy_(x),
                                    lambda: x.amax(-1)),
            "plain_ms": plain(lambda: ref.minp_mask_ref(x, t)),
            "library_ms": lib_ms,
            "library_cold_ms": cold[f"torch.where {b}x{v}"],
            "bound_ms": bound(2 * b * v * 4 + 4 * b, 0)[0]}
        del y
    report["minp_mask"] = minp
    main_path = minp[f"{LM_SLOTS}x{v}"]
    entry("minp_mask", [got], [want], main_path["ms"], main_path["plain_ms"],
          2 * b * v * 4 + 4 * b, b * v * 5,
          {"logits_shape": [b, v], "chunks": [8, 8, 8, 8],
           "ops_counted": "per element: 3 for the map (shift, or, xor), "
                          "1 compare, 1 select",
           **{k: main_path[k] for k in ("warm_ms", "copy_cold_ms",
                                        "copy_warm_ms",
                                        "empty_launch_cold_ms")}},
          library_ms=main_path["library_ms"],
          cold_key=f"minp_mask {LM_SLOTS}x{v}")

    # selective_scan: the Jamba2 Mini cell's batch-1 prefill of 4,999
    # tokens (the row) and decode step of 128 slots (report)
    scan = report["selective_scan"] = scan_timing(torch, flush, cold)
    pre = scan[f"{SCAN_SHAPES[0][0]}x{SCAN_SHAPES[0][1]}"]
    rows.append({"name": "selective_scan", "route": "cuda",
                 "source": KERNEL_META["selective_scan"][0],
                 "replaces": KERNEL_META["selective_scan"][1],
                 "launches": launches["selective_scan"],
                 "max_abs_err": pre["gaps"]["y_max"], "ms": pre["ms"],
                 "cold_ms": pre["cold_ms"], "plain_ms": pre["plain_ms"],
                 "bound_ms": pre["bound_ms"], "bound_by": "bytes",
                 "library_ms": None})

    # rmsnorm: the cell's prefill rows (the row) and its other shapes
    norms = report["rmsnorm"] = norm_timing(torch, flush, cold)
    row = norms["4999x1x4096"]
    rows.append({"name": "rmsnorm", "route": "cuda",
                 "source": KERNEL_META["rmsnorm"][0],
                 "replaces": KERNEL_META["rmsnorm"][1],
                 "launches": launches["rmsnorm"],
                 "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                 "cold_ms": row["cold_ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": "bytes",
                 "library_ms": row["library_ms"]})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False")
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        log(f"chip_smoke: no repro_torch sources under {SRC}")
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    report: dict = {}
    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    card = card_line()
    log(f"phase 1: built in {report['build_s']:.1f} s on {card}")

    return run_phases(torch, report, t0, card)


def run_phases(torch, report: dict, t0: float, card: str) -> int:
    """Phases 2-15 and the closing lines."""
    report["kernel_checks"] = check_kernels(torch)
    log(f"phase 2: {report['kernel_checks']} kernel checks passed")

    tsession, thandle, tcounts = run_table_path(torch, report)
    log(f"phase 3: table path ok {json.dumps(report['table']['queries'])}")
    gsession, ghandle, X, addrs, predictions, gcounts = run_gbdt_path(
        torch, report)
    log(f"phase 4: GBDT path ok, predict "
        f"{report['gbdt']['predict_wallclock_ms']:.1f} ms")

    table_ex, gbdt_ex = tsession.executor(thandle), gsession.executor(ghandle)
    fcounts = run_front_ends(
        torch, table_ex.table, report["table"]["queries"]["Q1"]["result"],
        gbdt_ex.forest, addrs, predictions, report)
    log(f"phase 5: front-ends ok {json.dumps(report['front_ends'])}")

    lcounts, lm_logits, lm_tau = run_lm_path(torch, report)
    log(f"phase 6: LM serving ok {json.dumps(report['lm'])}")
    acounts = run_arch_paths(torch, report)

    launches = {k: tcounts[k] + gcounts[k] + fcounts[k] + lcounts[k]
                + acounts[k] for k in tcounts}
    rows = measure(torch, table_ex, gbdt_ex, X, addrs, lm_logits, lm_tau,
                   launches, report)
    report["kernels"] = rows
    # phase 9 on a clean card: the LUT, the forest and the models go;
    # phase 15 keeps phases 3-4's host data (table, forest, instances,
    # addresses, predictions) to hold its mesh path against
    table, forest = table_ex.table, gbdt_ex.forest
    tshape = {"shards": table_ex.num_shards, "chunks": table_ex.num_chunks,
              "forest_chunks": gbdt_ex.num_chunks,
              "queries": report["table"]["queries"]}
    del tsession, thandle, gsession, ghandle, table_ex, gbdt_ex
    del lm_logits, lm_tau
    free(torch)
    tlaunches = run_training_path(torch, report)
    expect(not any(v for k, v in tlaunches.items() if k != "rmsnorm"),
           f"training launched kernels of ours: {tlaunches}")
    log(f"phase 9: training ok {json.dumps(report['train'])}")
    free(torch)
    ocounts = run_opt_variant(torch, report)
    for row in rows:
        row["launches"] += ocounts[row["name"]]
    log(f"phase 10: opt variant ok in {report['opt']['phase_s']:.1f} s")
    free(torch)
    lcounts11 = run_lineitem_path(torch, report)
    for row in rows:
        row["launches"] += lcounts11[row["name"]]
    log(f"phase 11: lineitem ok in {report['lineitem']['phase_s']:.1f} s")
    scounts = run_serving_path(torch, report)
    for row in rows:
        row["launches"] += scounts[row["name"]]
    log(f"phase 12: serving ok in {report['serving']['phase_s']:.1f} s")
    free(torch)
    mcounts = run_machine_path(torch, report)
    for row in rows:
        row["launches"] += mcounts[row["name"]]
    log(f"phase 13: machine backend ok in "
        f"{report['machine']['phase_s']:.1f} s")
    free(torch)
    vcounts = run_verified_serving_path(torch, report)
    for row in rows:
        row["launches"] += vcounts[row["name"]]
    log(f"phase 14: verified serving ok in "
        f"{report['verified_serving']['phase_s']:.1f} s")
    free(torch)
    pcounts = run_mesh_path(torch, report, table, tshape, forest, X, addrs,
                            predictions)
    for row in rows:
        row["launches"] += pcounts[row["name"]]
    log(f"phase 15: mesh ok in {report['mesh']['phase_s']:.1f} s")

    report["card"] = card
    report["device"] = torch.cuda.get_device_name(0)
    report["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["total_s"] = time.perf_counter() - t0
    log("report " + json.dumps(report))

    print("phase11 " + json.dumps(lineitem_summary(report["lineitem"])),
          flush=True)
    print("phase12 " + json.dumps(serving_summary(report["serving"])),
          flush=True)
    print("phase13 " + json.dumps(machine_summary(report["machine"])),
          flush=True)
    print("phase14 " + json.dumps(verified_summary(
        report["verified_serving"], report["machine"])), flush=True)
    print("phase15 " + json.dumps(mesh_summary(report["mesh"])), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
