#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--json PATH] [--only-serve | --only-train |
                                         --only-lm-mesh | --only-tune |
                                         --only-distributed |
                                         --only-examples]

Run from the root of a checkout; it needs no build step (the kernels
build from ``src/repro_torch/kernels/csrc`` at first use) and one card.

1. Build the CUDA kernels with nvcc for sm_90a; print the card and the
   build time.
2. End-to-end parity at T = 512, materialize mode: the kernel plan twice
   (bitwise equal outputs: no non-deterministic scatter) and the plain
   plan (equal labels).
3. The same at T = 512 in fused mode: the fused kernel plan twice
   (bitwise), the fused plan with plain segmentation and clustering
   (equal labels), the materialize kernel plan (equal labels, the max
   difference of ``sim`` printed); once more with ``delta_t > 0``.
4. The two main paths: ``run_dsc`` on the repo's per-device
   configuration ``dsc_brest`` (4096 AIS-like vessels x 128 points, 8
   lanes, w = 20, TSA2) with the kernel plan, first in materialize mode,
   then in fused mode.  Launch counts are zeroed just before each run and
   read just after; each run must launch exactly its path's kernels.
   Prints stage times (CUDA events), clustering rounds, peak device memory
   and the cluster / member / outlier counts; the fused labels must equal
   the materialize labels.
5. Each kernel against its plain PyTorch version on the card, on its main
   path's full-size inputs: integer / boolean outputs equal, float outputs
   bitwise equal.  Times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call.  The chunk time
   bounds every join kernel's sweep reads, built by their own kernel,
   bitwise the plain version's.  K1's, K2's and K4's (group, chunk) skip
   counts equal the plain mirrors' (K1's, over flattened groups, equal
   K2's at M = 128); the pair slots they evaluate are printed beside those
   of every pair and the needed ones, with ptxas' registers and spills.
   K5 at every round state of the materialize run (recorded by wrapping
   its wrapper, ``recorded_rounds``): bitwise, timed, with its active rows
   and bound, and the sums over the run.  K6 on the run's final
   representatives and on a seeded half of the rows: bitwise its plain
   twin, timed per call and as device time (a CUDA graph), with its bound
   and the floor of one launch.  K16 (the row moments of alpha, which
   replaces no TPU kernel) on the run's matrix: bitwise its plain tree,
   timed beside the plain version and its bound.  (Every main run logs its stages'
   parts by its own events: the slot table, the dense matrix's
   normalization, the thresholds and the round loop, the dotted keys of
   ``run_dsc``'s ``stage_times``.)  K3 on the
   raw words (the kernel never reads an invalid position's), bitwise the
   plain version on the masked words, timed with its bound.  (A
   materialize run returns its cube in ``DSCOutput.join``: checked, then
   dropped.)
6. The fused path at ``dsc_sis`` (8192 vessels x 128 points, S = 65,536;
   the same generator and parameters): launch counts, sanity checks,
   stage times and peak memory; K5 at every round of that run (bitwise,
   timed), K6 on its final representatives and K16 on its matrix
   (bitwise, timed as at dsc_brest); then K2 and K4 on its inputs, timed and bitwise their plain
   versions on the first 256 rows, and K3 on K2's words, bitwise and timed
   with its bound.

Top-K similarity (``sim_mode="topk"``, the default K = 32 and widening):

* T = 512, both modes with the kernel plan: labels equal to the dense
  runs, the ``TopKSim`` bitwise ``topk_from_dense`` of the dense matrix
  at the final K (after step 3);
* the fused top-K path at ``dsc_brest`` (after step 4): launch counts
  (K7 = dispatches x S/Sb, K8 = rounds summed over the dispatches, K9 =
  dispatches), labels equal to the dense fused run, the same bitwise list
  check, stage times, final K, dispatches and a peak below one ``[S, S]``
  float32 matrix;
* K7 (one panel, bitwise against its plain version and against K4's
  ``raw``; its (group, chunk) skip counts equal to the plain mirror's;
  timed alone from a CUDA graph, per prepared call and through the public
  wrapper), K8 against its plain version, and K9 at every dispatch's K
  (each dispatch's claim-max inputs recorded on the host by
  ``recorded_claims`` in a second run of the path): bitwise, timed, with
  its bound, and the sums (in step 5);
* the fused top-K path at ``dsc_sis``: labels equal to the dense dsc_sis
  run's (after step 6).

The launcher and the stage entry points (after the fused top-K run at
dsc_brest; launch counts zeroed just before each run and read just
after):

* ``repro_torch.launch.run_dsc.main`` in this process with ``--config
  dsc_brest --n-trajs 4096 --segmentation tsa2 --plan`` the fused kernel
  plan (a JSON file written by ``EnginePlan.save`` under ``build/``): its
  labels, ``member_sim``, alpha and k bitwise the fused main run's, and
  its launch counts equal to that run's; its wall (with the data
  generation, also timed alone) and peak allocation printed.  The same
  with the deprecated flags (``--mode fused --use-kernel
  --seg-use-kernel --cluster-use-kernel``) against the ``--plan`` run,
  and (after the dsc_sis fused run) with ``--config dsc_sis --n-trajs
  8192`` against that run;
* the seven stage entry points chained on dsc_brest with the fused and
  the materialize kernel plans: every field bitwise the main run's, with
  its launch counts (materialize: ``run_stage_vote_from_join`` on the
  chain's cube equal to ``run_stage_join``'s votes and words);
  ``run_dsc_lowerable`` with the fused kernel plan: every field bitwise
  the main fused run's;
* (before LCSS) the S2T baseline on the card and on the CPU, on the
  figure-1 scenario: equal labels.

The resilient runner, the streaming service and the launcher's options
for them (after the stage entry points; launch counts zeroed just before
each run or advance and read just after; wall, peak, checkpoint bytes and
seconds per save printed):

* ``run_resilient`` at dsc_brest with the fused top-K kernel plan,
  checkpoints under a temporary directory (its free disk printed),
  ``on_overflow="widen"``: with ``FaultPlan(crash_at="cluster")`` it must
  raise ``InjectedCrash`` (launching K2, K3 and K7); the resume must give
  ``resumed_from == 3``, one widen fewer than the main run's dispatches,
  launch only K7, K8 and K9 (the widen re-runs similarity from the
  segment checkpoint), and equal the main fused top-K run field for
  field (labels, lists, final K, sscr);
* the streaming service at full width: the 4,096 dsc_brest vessels
  submitted in time order, 32,768 fixes a batch (13 advances), T = 4096,
  M = 128, K = 8, w = 6, TSA1, dsc_brest's eps, the whole span as
  horizon, a batch's span plus twice the mean interval as allowed
  lateness (at least 99% of the fixes admitted), absolute thresholds
  from a batch run over the same data (``stream_thresholds``); each
  advance launches K1 for the delta join and K9 for the claim-max, the
  run K8 (its ms, dirty rows, pass-2 rows and launches printed); at the
  middle and the last advance the standing
  lists, spill and labels bitwise ``run_dsc`` with the materialize top-K
  kernel plan over the window; once, 64 dirty rows of the cube bitwise
  K1's plain twin under the rows' bbox mask; balanced books; a peak below
  60 GB (the cube is 17.2 GB);
* kill and resume at T = 512 (the first 512 vessels, batches of 4,096
  fixes: a snapshot's cube is 0.27 GB, not 17.2): a crash entering
  advance 3, a resume from the snapshot, the final state bitwise an
  uninterrupted run's;
* the launcher in this process at its default size: ``--stream
  --resume-dir`` (exit 0), a ``{"crash_at": "cluster"}`` fault plan (6)
  and the resume (0, labels of a plain run), ``--on-overflow raise`` (3),
  ``--on-dirty fail`` with a poison record (7), ``--backpressure block
  --queue-cap 10`` (8).

Index pruning (``use_index=True``, the pruned kernels K10-K13):

* T = 512: the materialize, fused and fused top-K kernel plans with the
  index give the labels of the same plans without it (after the top-K
  parity step);
* dsc_brest as the launcher lays it out (after the brest main paths): the
  three pruned paths, each launching exactly its kernels; labels, ``sim``
  and the top-K lists equal to the unpruned runs'; then K10 bitwise K1
  (its skip counts equal to the plain mirror's over the plan; timed with
  and without the two fills it no longer needs),
  K11 bitwise K2 (vote and words), K12 bitwise K4 (the skip counts of
  both equal to the plain mirror's over the plan), K13 bitwise K7 on
  every panel, and the skip counts of both equal to the plain mirror's on
  every panel; tile counts, tile-list widths, planning ms, stage times and
  peak memory printed;
* the same 4096 vessels with rows stably sorted by lane (the layout of
  ``benchmarks/kernel_bench.py``), where the plans skip tiles: the three
  unpruned and the three pruned paths, the same checks, and each pruned
  kernel against its plain version (timed, with its bound).

The entry points off the DSC paths (after the dsc_sis runs):

* LCSS (``lcss_similarity``, K14) on the lane-sorted dsc_brest vessels,
  each paired with the next 8 rows (B = 32,768 pairs of 128 x 128 points,
  dsc_brest's eps): one launch on the entry point's run; the kernel
  bitwise its sheared plain twin on every pair, the row scan on the first
  pairs, and itself on the swapped pairs; 0 <= weighted <= count <=
  min(n, m); the cells its time test rejects (no match among them), and
  its bound beside the former count (the whole weight on every valid
  cell);
* attention (``flash_attention``, K15) at the shapes of two models the
  repo supports: smollm-360m prefill (15 heads, 5 KV, hd 64, L = 4096,
  causal) in float32 and bfloat16, a gemma2-2b local layer (8 heads, 4
  KV, hd 256, softcap 50, window 4096, L = 8192) in bfloat16, and one
  gemma2-2b decode step (Lq = 1 against M = 8192, ``max_kv``), and the
  gemma2-2b local layer in float32 with q unscaled, so that the scores
  reach into the softcap, and one small hd-512 case for the general path:
  one launch per case on the entry point's run; each against the plain
  version within its stated tolerance, timed, and the smollm cases beside
  ``scaled_dot_product_attention(is_causal=True)``; the K15 path each case
  took (``bf16_mma``, ``f32_tiled`` or ``general``, and its key split),
  and the tiles it skipped out of those it swept, equal to the plain
  mirror of its tile test.

The LM serving path (``phase_serve``, after attention and before the
autotuner, or alone with ``--only-serve``); no TPU kernel lies on it (the
reference's attention is plain XLA), and every part must launch no
custom kernel (counts zeroed just before it, read just after):

* every architecture at its reduced config, the same params on the card
  and on the CPU: the full forward's logits and aux, a prefill of L - 1
  tokens into the caches and one decode step (logits and every cache
  leaf) within ``SERVE_ULPS`` bf16 ulps; the MoE expert choices under the
  margin rule; on the card, decode after prefill against the full
  forward (atol = rtol = 2e-2, as ``tests/test_arch_smoke.py``);
* smollm-360m at full width (seeded init on the card, the count of every
  parameter but the norm scales equal to ``param_count()``) through
  ``ServeEngine``: 16 requests in 8 slots, 32 new tokens, ``max_len``
  4096, prompts in 1536-3072 with a 3072 in each wave (online-path
  prefills); 2 prefill calls, 62 decode steps; one request's tokens
  against full forwards on the card fed its tokens, under the margin
  rule; prefill ms per wave and decode ms per step (CUDA events),
  tokens/s, peak;
* gemma2-2b at full width, one wave of 2 x 4608 (past the 4096 window),
  ``max_len`` 5120, 8 decode steps: times and peak;
* the port's launcher in this process, ``--arch smollm-360m --full``.

The LM training path (``phase_train``, after the serving phase, or alone
with ``--only-train``); no TPU kernel lies on it and the reference has no
backward kernel, so every part must launch no custom kernel (counts
zeroed just before it, read just after):

* every architecture at its reduced config, the same params and
  ``TokenPipeline`` batch on the card and on the CPU, one ``train_step``
  (remat=True): ``lr`` bitwise, the loss within 2**-9, the grad norm
  within 2**-6 relative, each moment leaf within 10% relative L2 and
  cosine 0.995 (``tests/test_torch_train.py``'s bounds), the new params
  within lr / 1000 where both first moments share a sign and exceed 1e-5
  and within 2 lr everywhere, MoE choices under the margin rule; on the
  card the step lowers its batch's loss;
* smollm-360m at full width, B = 4 x 4,096 ``TokenPipeline`` tokens (the
  train_4k shape's length, its global batch 256 cut to 4), 4 steps at
  remat=True: losses and grad norms finite, the last two losses below
  the first two; one more step from the same state and batch at each
  remat mode: the loss bitwise remat=True's, each leaf's update within
  ``TRAIN_REMAT_REL`` of it; step ms (CUDA events), tokens/s, each mode's
  peak above the held state;
* zamba2-1.2b at full width, B = 2 x 2,048, 2 steps: finite, the shared
  attention block's first moments (its gradient summed over its 6 uses)
  finite and non-zero; step ms and peak;
* the port's training launcher in this process, ``--arch smollm-360m
  --full --steps 10 --batch 8 --seq 512 --ckpt-every 5 --device cuda``,
  then ``--steps 15 --resume`` (logs ``resumed from step 10``).

The distributed LM (``phase_lm_mesh``, after the training phase, or
alone with ``--only-lm-mesh``): one ``spawn`` of four ranks that share
this card over gloo; no part launches a custom kernel (counts zeroed just
before each part, read just after; no TPU kernel lies on this path):

* qwen2-moe-a2.7b at full width (d_model 2,048, 16 heads, 60 routed
  experts top-4, d_expert 1,408, 4 shared, vocab 151,936), its depth cut
  from 24 to 2 layers (every rank holds the global f32 parameters, 7 GB),
  on (data, model) = (2, 2), 30 experts a rank: B = 4 prompts of 1,024
  tokens through ``prefill_step`` and 16 greedy ``decode_step`` calls
  with ``mesh=`` and ``dp_axes=("data",)``; every rank's logits, tokens,
  cache and MoE outputs bitwise equal; rank 0 then holds every MoE call
  of the run (each step, each layer) against the local ``moe_ffn`` on
  each data shard's block of the same recorded input (y within
  ``SERVE_ULPS`` row by row, aux and dropped bitwise), and runs each data
  shard's requests alone without a mesh, fed the mesh run's tokens:
  logits within ``SERVE_ULPS`` at every step, else the token under the
  margin rule (at most ``LM_MESH_LOW_MAX`` rows at a low margin); then
  one prefill with the int8 dispatch: layer 0's MoE output within 0.05
  relative of the bf16 dispatch's, the dispatch's bytes half;
* one ``train_step(mesh=, dp_axes=("data",))`` per MoE family, reduced,
  on the card and on gloo CPU ranks (the same processes): within the
  training phase's bounds, every rank's new state bitwise equal;
* ``pipeline_apply`` over smollm-360m's 32 layers at full width, 4 stages
  of 8 on (pod, data) = (4, 1), 4 microbatches of B = 8 x 512: the
  forward bitwise rank 0's sequential composition of the same stages over
  the same microbatches, each stage's gradient within ``PIPE_GRAD_REL``
  of autograd through it; bubble 3/7.

It prints prefill ms, decode ms a step, each collective's calls, MB sent
and seconds a rank (``MeshComm.stats`` with ``timing`` on), each rank's
peak and the card's used peak, beside the card's name and power limit.

The plan autotuner (``phase_tune``, before the multi-device phase, or
alone with ``--only-tune``): ``repro_torch.tune.autotune``'s sweeps on
the card, each with its launch counts zeroed just before it and read
just after (exactly its kernels), every candidate verified bit for bit
before it is ranked; per candidate it prints the wall (the minimum of
``TUNE_ITERS`` timed calls after a warm one), the interface bytes and
the allocation peak of the timed calls:

* ``tune_join`` at dsc_brest (T = 4096) from the materialize kernel plan
  (the oracle and candidate 0: K1, K3, K5, K6) against the seven fused
  rows of ``join_candidates`` (K2, K3, K4, K5, K6; one computation, since
  no kernel reads the tile fields): 8 of 8 verified, labels 8 / 7,430 /
  552;
* ``tune_cluster_tiles`` on that oracle's ``[S, S]`` and table (S =
  32,768): the plain round engine (candidate 0) beside K5 / K6 (1-5), 6
  of 6 bitwise the plain oracle on all six fields;
* ``tune_pipeline`` at T = 1024 from the fused kernel plan through a
  ``PlanStore`` saved to a temporary file and reloaded: every candidate
  verified, the reloaded stage winners merge to the tuned plan, whose
  labels equal the base plan's;
* the top-K panel height at dsc_brest, K = 4,096: ``sweep`` over the
  fused top-K kernel plan at Sb = 128, 256, 512, 1024, 2048, measured by
  ``measure_call`` over ``run_dsc_lowerable``; every Sb bitwise Sb = 128
  (lists, spill, moments, labels) and launching K7 S/Sb times a call;
* ``tune_comm`` on a (2, 2) mesh of four gloo ranks at T = 512 (the
  materialize kernel plan, allgather): 4 of 4 verified on every rank,
  every rank naming the same winner on the same agreed walls.

The multi-device program (last; ``phase_distributed``, or alone with
``--only-distributed``): ``repro_torch.distributed.mesh.spawn`` starts a
(part, model) = (2, 2) mesh of four ranks that share this card over gloo
(payloads staged through host memory), each rank running ``DIST_JOBS``
through ``run_dsc_distributed`` with its launch counts zeroed just before
each run and read just after:

* the main run, dsc_brest (T = 4096, TSA2) cut into two temporal
  partitions, the fused top-K kernel plan from K = 32 with
  ``on_overflow="widen"``: every rank launches exactly K2, K4, K3, K8,
  K9 and the chunk bounds (K2 and K3 once, per widen dispatch K4 and K9
  once; the bounds once for K2 and once a dispatch); run again, bitwise
  and with the same launches, recording its kernels' operands; every
  rank assembles the same output;
* the fused dense kernel plan (K5, K6) there: the labels of the main run;
* at T = 512: the materialize kernel plan (K1) with the labels of the
  fused top-K run; the ring twins (top-K, and materialize with the
  allgather strategy) bitwise their barrier twins on every label field;
  the stage chain of ``build_dsc_stage_programs`` bitwise the monolith
  with its launches; the plain plan (from K = 32 with widen) gives the
  labels of the fused top-K kernel plan; then mesh (1, 2) against
  one-device ``run_dsc``;
* every kernel of these paths against its plain version at the operands
  the program gave it, on every rank (``recorded_program`` wraps the
  wrappers in the recorded rerun, the dense run and mat_512): each call's
  wrapper again and its plain version bitwise the run's outputs (the
  chunk bounds, K3 on the compacted TSA2 words, K8 at every round and K9
  at every dispatch on the merged lists, K5 at every round and K6 on the
  partition's ``[S, S]``, K1 on the halo candidates); K2 and K4 on the
  whole partition again, and their plain versions on 8 blocks of 16
  partition rows from the first to the last (K4 with the program's slot
  maps); each timed beside its plain version.

It prints each run's wall, phase times (CUDA events), collectives (calls,
MB sent, seconds) and peak allocation per rank, the card's used peak over
the phase (all processes), and the cluster / member / outlier counts,
beside the card's name and power limit.

Then the distributed resilient runner (``phase_resilient_distributed``,
also under ``--only-distributed``), ``run_resilient_distributed`` on the
same (2, 2) mesh, checkpoints under a fresh temporary directory:

* dsc_brest (T = 4096), the fused top-K kernel plan from K = 32 with
  widen: ``FaultPlan(crash_at="cluster")`` through the runner's own spawn
  must come back as ``InjectedCrash`` in this process; the resume (on
  ranks this script spawns, its launches zeroed just before it and read
  just after: exactly K4, K8, K9 and the chunk bounds) must give
  ``resumed_from == 3``, one widen fewer than the main run's dispatches,
  and labels, ``member_sim``, ``vote``, ``active`` and ``sim_diag``
  bitwise the main monolith run's; it prints both walls, the saves (GB
  written, seconds a save on rank 0's writer thread and on its calling
  thread), each rank's peak allocation, the card's used peak and the
  collectives' share of the resume's wall;
* at T = 512: the materialize kernel plan (K1, K3, K5, K6) crashed at each
  of the five stages and resumed, each bitwise its straight run (which
  equals the monolith's mat_512); an applied rebalance (fused top-K,
  partition 1 slowed by 30 s at ``join``) bitwise a straight run at the
  applied cut; a fused top-K crash at cluster on (2, 2) resumed on a
  (1, 2) mesh with ``elastic_resume=True``, bitwise a straight run there;
* every kernel these runs launch (K1-K6, K8, K9, the chunk bounds)
  against its plain version at the resilient runs' own operands
  (``recorded_program`` in the resume, the materialize straight run and
  the rebalanced run).

The examples (``phase_examples``, last, or alone with
``--only-examples``): each module of ``repro_torch.examples`` through its
``main`` on the card, against the same example under ``--device cpu``:

* quickstart (``run_dsc``'s default plan, no kernel): printed lines and
  ``member_of`` / ``is_rep`` / ``is_outlier`` bitwise the CPU run's;
* maritime_clustering on one spawn of its (part, model) = (4, 2) mesh,
  eight gloo ranks on the card: on every rank the lines and labels
  bitwise the eight CPU ranks' run, and exactly the kernels of its
  materialize plan (K1 and the chunk bounds; its clustering runs the
  plain engine, as the reference's ``use_kernel=True`` alias sets), their
  launches a rank printed;
* serve_lm: requests, tokens, decode steps, prefill calls and padding
  waste equal the CPU's (host bookkeeping);
* train_lm, its 300 steps from the CPU's init: the loss drops, and the
  first is within 2**-9 (the training phase's bound) of the CPU's run of
  12 steps;

with the phase's wall, each example's wall and the card's used peak (all
processes).

Prints one JSON ``kernels`` line, then the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any mismatch or
error exits non-zero without the result line; so does a machine without a
card or a directory without the port.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 outside
# the tensor cores is 67 TFLOP/s counting an FMA as two operations, so
# 33.5e12 f32 instructions per second for code built with -fmad=false;
# bf16 in the tensor cores 989 TFLOP/s (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_OPS_PER_S = F32_FLOPS_PER_S / 2
BF16_FLOPS_PER_S = 989e12
# f32 operations of one K1 pair evaluation: dx, dy, dx*dx, dy*dy, the sum,
# dt and the two threshold compares (no FMA)
K1_OPS_PER_PAIR = 8
# point pairs of one (group of 8 reference points, chunk of 8 candidate
# points) pair that K7 / K13 evaluate when they keep it (M, Mc multiples
# of 8, as at dsc_brest and dsc_sis)
PANEL_SLOTS = 64
REPLACES = {
    "stjoin_best_match": "src/repro/kernels/stjoin/stjoin.py:893",
    "stjoin_vote_fused": "src/repro/kernels/stjoin/stjoin.py:583",
    "jaccard_window": "src/repro/kernels/jaccard/jaccard.py:72",
    "stjoin_sim_fused": "src/repro/kernels/stjoin/stjoin.py:711",
    "stjoin_sim_panel_fused": "src/repro/kernels/stjoin/stjoin.py:444",
    "round_scan": "src/repro/kernels/cluster/cluster.py:99",
    "claim_max": "src/repro/kernels/cluster/cluster.py:120",
    "topk_round_scan": "src/repro/kernels/cluster/cluster.py:195",
    "topk_claim_max": "src/repro/kernels/cluster/cluster.py:216",
    "stjoin_best_match_pruned": "src/repro/kernels/stjoin/stjoin.py:811",
    "stjoin_vote_fused_pruned": "src/repro/kernels/stjoin/stjoin.py:637",
    "stjoin_sim_fused_pruned": "src/repro/kernels/stjoin/stjoin.py:763",
    "stjoin_sim_panel_fused_pruned":
        "src/repro/kernels/stjoin/stjoin.py:515",
    "lcss_wavefront": "src/repro/kernels/lcss/lcss.py:57",
    "flash_attention_fwd": "src/repro/kernels/attention/flash.py:83",
}
CSRC = "src/repro_torch/kernels/csrc/"
# the source of each kernel outside dsc_kernels.cu
SOURCES = {"lcss_wavefront": "lcss_kernels.cu",
           "flash_attention_fwd": "attention_kernels.cu"}
# the kernels each main path launches, and no other (every path's join
# reads the chunk time bounds, and every path's thresholds the row moments
# of alpha (dense: the [S, S] matrix, top-K: each panel), which replace no
# TPU kernel)
PATH_KERNELS = {path: {"chunk_time_bounds", "sim_row_moments", *names}
                for path, names in {
    "materialize": {"stjoin_best_match", "jaccard_window", "round_scan",
                    "claim_max"},
    "fused": {"stjoin_vote_fused", "jaccard_window", "stjoin_sim_fused",
              "round_scan", "claim_max"},
    "materialize_topk": {"stjoin_best_match", "jaccard_window",
                         "topk_round_scan", "topk_claim_max"},
    "fused_topk": {"stjoin_vote_fused", "jaccard_window",
                   "stjoin_sim_panel_fused", "topk_round_scan",
                   "topk_claim_max"},
    "materialize+index": {"stjoin_best_match_pruned", "jaccard_window",
                          "round_scan", "claim_max"},
    "fused+index": {"stjoin_vote_fused_pruned", "jaccard_window",
                    "stjoin_sim_fused_pruned", "round_scan", "claim_max"},
    "fused_topk+index": {"stjoin_vote_fused_pruned", "jaccard_window",
                         "stjoin_sim_panel_fused_pruned", "topk_round_scan",
                         "topk_claim_max"},
}.items()}
PRUNED_PATHS = ("materialize", "fused", "fused_topk")
LABELS = ("member_of", "is_rep", "is_outlier")


class Failed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (no host
    overhead between the kernels, unlike ``time_ms`` on back-to-back
    calls, which a small kernel can outrun)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes: float, ops: float = 0.0, rate: float = F32_OPS_PER_S):
    """The larger of the bytes over HBM's rate and the operations over
    ``rate`` (f32 instructions by default)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def window_partners(batch, eps_t: float):
    """Per valid point ``[T, M]`` (0 elsewhere): the valid points of the
    other trajectories with |dt| <= eps_t, the pairs whose distance the
    join needs.  A kernel that uses the time order of each trajectory's
    points evaluates only these; K1 as built evaluates all P * C * Mc."""
    t = batch.t.double()
    tv = torch.where(batch.valid, t, torch.inf)
    lo, hi = t - eps_t, t + eps_t
    flat = tv.flatten().sort().values
    every = (torch.searchsorted(flat, hi, right=True)
             - torch.searchsorted(flat, lo))
    rows = tv.sort(dim=1).values
    own = (torch.searchsorted(rows, hi, right=True)
           - torch.searchsorted(rows, lo))
    return torch.where(batch.valid, every - own, 0)


def k1_window_pairs(batch, eps_t: float) -> int:
    """(ref point, candidate point) pairs of the self-join that the join
    needs (``window_partners`` summed)."""
    return int(window_partners(batch, eps_t).sum())


def brest_batch(n_vessels: int, dev, delta_t: float = 0.0,
                sort_by_lane: bool = False):
    """The launcher's ``dsc_brest`` data and parameters
    (``repro.launch.run_dsc``: eps_sp = 0.15 * diameter, eps_t = mean
    sampling interval, delta_t = 0, w = 20, tau = 0.4, -1 sigma
    thresholds, 8 subtrajectories per trajectory) with TSA2.  The
    launcher's own default for dsc_brest is TSA1 (the registry's
    ``segmentation="tsa1"``); TSA2 is chosen here so that the Jaccard
    kernel runs: the launcher equivalent is ``--config dsc_brest
    --n-trajs 4096 --segmentation tsa2``.  ``dsc_sis`` has the same
    generator and parameters at 8192 vessels.

    ``sort_by_lane``: the same vessels and parameters with the rows stably
    sorted by lane, ids following their rows (the layout of
    ``benchmarks/kernel_bench.py``): tiles of 32 neighbouring rows then
    stay on few lanes, and the index plans skip tiles."""
    from repro_torch.core.types import DSCParams, TrajectoryBatch
    from repro_torch.data.synthetic import ais_like, default_dsc_params_for
    batch, lanes = ais_like(n_vessels=n_vessels, max_points=128, n_lanes=8,
                            seed=0, device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=delta_t,
                       w=20, tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                       max_subtrajs_per_traj=8, segmentation="tsa2")
    if sort_by_lane:
        o = torch.from_numpy(lanes.argsort(kind="stable")).to(dev)
        batch = TrajectoryBatch(x=batch.x[o], y=batch.y[o], t=batch.t[o],
                                valid=batch.valid[o],
                                traj_id=batch.traj_id[o])
    return batch, params


def kernel_plan(path: str = "materialize"):
    """The kernel plan of a path: ``"materialize"``, ``"fused"``,
    ``"materialize_topk"`` or ``"fused_topk"`` (the default K and panel),
    with the index where the path ends in ``"+index"``."""
    from repro_torch.core.plan import EnginePlan
    path, _, index = path.partition("+")
    mode, _, sim = path.partition("_")
    return EnginePlan(mode=mode, use_kernel=True, seg_use_kernel=True,
                      cluster_use_kernel=True, sim_mode=sim or "dense",
                      cluster_engine="rounds", use_index=index == "index")


def check_output(out, batch, params):
    """The repo's own sanity conditions on a pipeline output."""
    T, M = batch.x.shape
    S = T * params.max_subtrajs_per_traj
    r = out.result
    check(out.vote.shape == (T, M) and torch.isfinite(out.vote).all(),
          "vote: shape or non-finite values")
    if out.sim is None:
        tk = out.sim_topk
        check(tk.ids.shape == tk.sims.shape == (S, tk.k)
              and torch.isfinite(tk.sims).all(),
              "top-K lists: shape or non-finite values")
        check(bool(((tk.ids >= -1) & (tk.ids < S)).all())
              and bool((tk.sims >= 0).all())
              and bool((tk.sims[:, :-1] >= tk.sims[:, 1:]).all())
              and bool(((tk.ids >= 0) == (tk.sims > 0)).all()),
              "top-K lists: ids out of range or sims not descending")
        check(int(out.sim_overflow) == 0, "top-K certificate fails")
    else:
        check(out.sim.shape == (S, S) and torch.isfinite(out.sim).all(),
              "sim: shape or non-finite values")
        # Eq. 2 divides by min(|r'|, |s'|), so entries may exceed 1
        check(bool((out.sim >= 0).all()), "negative similarity")
    check(torch.isfinite(r.alpha_used) and torch.isfinite(r.k_used),
          "alpha / k not finite")
    members = ~r.is_rep & (r.member_of >= 0)
    owners = r.member_of[members].long()
    check(bool(r.is_rep[owners].all()), "a member's owner is no rep")
    check(bool((r.member_of[r.is_rep] == torch.nonzero(r.is_rep)[:, 0]
                .to(torch.int32)).all()), "a rep does not own itself")
    check(not bool((r.is_outlier & (r.is_rep | members)).any()),
          "an outlier is also clustered")
    check(int(r.is_rep.sum()) > 0, "no cluster found")
    check(0.0 < float(out.sscr) and float(out.rmse) <= params.eps_sp,
          "sscr / rmse out of range")


def same_labels(a, b, what: str):
    for f in LABELS:
        check(torch.equal(getattr(a.result, f), getattr(b.result, f)),
              f"{what}: {f} differs")


def same_topk(out, dense, what: str):
    """``out``'s lists bitwise ``topk_from_dense`` of ``dense``'s matrix at
    the final K, field by field."""
    from repro_torch.core.similarity import topk_from_dense
    want = topk_from_dense(dense.sim, dense.table, out.sim_topk.k)
    for f in ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq"):
        check(torch.equal(getattr(out.sim_topk, f), getattr(want, f)),
              f"{what}: TopKSim.{f} not bitwise topk_from_dense")


def diff_fields(a, b, what: str = "out") -> list[str]:
    """The fields (dataclasses, tensors, numbers, None, recursively) where
    ``a`` and ``b`` are not bitwise equal."""
    import dataclasses
    if a is None or b is None:
        return [] if a is None and b is None else [what]
    if torch.is_tensor(a):
        same = a.dtype == b.dtype and torch.equal(a, b)
        return [] if same else [what]
    if dataclasses.is_dataclass(a):
        return [d for f in dataclasses.fields(a)
                for d in diff_fields(getattr(a, f.name), getattr(b, f.name),
                                     f"{what}.{f.name}")]
    return [] if a == b else [what]


def phase_parity(dev):
    """T = 512: kernel plan twice (bitwise), plain plan (equal labels)."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    k1 = run_dsc(batch, params, plan=kernel_plan(), device=dev)
    k2 = run_dsc(batch, params, plan=kernel_plan(), device=dev)
    diffs = diff_fields(k1, k2)
    check(not diffs, f"kernel plan not deterministic: {diffs}")
    plain = run_dsc(batch, params, device=dev)
    for f in ("member_of", "is_rep", "is_outlier"):
        check(torch.equal(getattr(k1.result, f), getattr(plain.result, f)),
              f"T=512 kernel vs plain plan: {f} differs")
    check_output(k1, batch, params)
    log(f"phase parity (T=512): kernel plan deterministic; labels equal to "
        f"the plain plan; {int(k1.result.is_rep.sum())} clusters, "
        f"{int(k1.result.is_outlier.sum())} outliers, rounds {k1.rounds}")


def phase_parity_fused(dev):
    """T = 512, fused mode, with delta_t = 0 and > 0: the fused kernel plan
    twice (bitwise), the fused plan with plain segmentation and clustering
    (equal labels; K2 and K4 run on the card in any fused plan), and the
    materialize kernel plan (equal labels, the sim difference printed)."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.core.plan import EnginePlan
    batch, params = brest_batch(512, dev)
    for k in (0.0, 3.0):
        p = params.replace(delta_t=k * params.eps_t)
        f1 = run_dsc(batch, p, plan=kernel_plan("fused"), device=dev)
        f2 = run_dsc(batch, p, plan=kernel_plan("fused"), device=dev)
        diffs = diff_fields(f1, f2)
        check(not diffs, f"fused kernel plan not deterministic: {diffs}")
        others = {"fused plain": run_dsc(batch, p, device=dev,
                                         plan=EnginePlan(mode="fused")),
                  "materialize kernel": run_dsc(batch, p, device=dev,
                                                plan=kernel_plan())}
        for name, o in others.items():
            for f in ("member_of", "is_rep", "is_outlier"):
                check(torch.equal(getattr(f1.result, f),
                                  getattr(o.result, f)),
                      f"T=512 delta_t={p.delta_t:.6g}: fused kernel vs "
                      f"{name} plan: {f} differs")
        check_output(f1, batch, p)
        sim_diff = float((f1.sim - others["materialize kernel"].sim)
                         .abs().max())
        log(f"phase parity fused (T=512, delta_t={p.delta_t:.6g}): "
            f"deterministic; labels equal to the fused plain and the "
            f"materialize kernel plans; max |sim fused - sim materialize| "
            f"= {sim_diff}; {int(f1.result.is_rep.sum())} clusters, "
            f"{int(f1.result.is_outlier.sum())} outliers, "
            f"rounds {f1.rounds}")


def phase_parity_topk(dev):
    """T = 512, top-K with the kernel plan in both modes: labels equal to
    the dense kernel runs and the lists bitwise ``topk_from_dense`` of
    the dense matrix at the final K."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    for mode in ("materialize", "fused"):
        dense = run_dsc(batch, params, plan=kernel_plan(mode), device=dev)
        out = run_dsc(batch, params, plan=kernel_plan(mode + "_topk"),
                      device=dev)
        check(out.sim is None, f"T=512 {mode} top-K: a dense matrix")
        same_labels(out, dense, f"T=512 {mode} top-K vs dense")
        same_topk(out, dense, f"T=512 {mode} top-K")
        check(torch.equal(out.sscr, dense.sscr), f"T=512 {mode}: sscr")
        check_output(out, batch, params)
        log(f"phase parity top-K (T=512, {mode}): labels equal to the dense "
            f"run, lists bitwise topk_from_dense; final K={out.sim_topk.k} "
            f"after {out.dispatches} dispatches, rounds {out.rounds}")


def phase_parity_index(dev):
    """T = 512: each kernel plan with the index gives the labels of the
    same plan without it."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    for path in PRUNED_PATHS:
        dense = run_dsc(batch, params, plan=kernel_plan(path), device=dev)
        out = run_dsc(batch, params, plan=kernel_plan(path + "+index"),
                      device=dev)
        same_labels(out, dense, f"T=512 {path}: index vs no index")
        check_output(out, batch, params)
    log("phase parity index (T=512): labels with the index equal those "
        f"without it on {', '.join(PRUNED_PATHS)}")


def same_pruned(outs, pouts, what: str):
    """The pruned paths' outputs against the unpruned ones: labels, the
    dense ``sim`` and the top-K lists bitwise."""
    for path in PRUNED_PATHS:
        a, b = outs[path], pouts[path]
        same_labels(b, a, f"{what} {path}: index vs no index")
        check(torch.equal(b.seg.sub_local, a.seg.sub_local),
              f"{what} {path}: sub_local differs")
        if a.sim is not None:
            check(torch.equal(b.sim, a.sim), f"{what} {path}: sim differs")
        else:
            check(torch.equal(b.sim_topk.ids, a.sim_topk.ids)
                  and torch.equal(b.sim_topk.sims, a.sim_topk.sims),
                  f"{what} {path}: top-K lists differ")
    log(f"{what}: with the index, labels, sub_local, sim and the top-K "
        "lists equal the unpruned runs'")


def plan_index(batch, params, report, name: str):
    """Both tile plans of the batch's self-join, timed (host clock around
    synchronized calls, the transposition of the fused plan included):
    ``(join tile_ids, fused FusedTilePlan)``."""
    from repro_torch.kernels.stjoin import ops as sj
    eps = (params.eps_sp, params.eps_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask, counts, _ = sj.plan_join_index(batch, batch, *eps)
    join_ids = sj._compact(mask, counts, None, "pruned join")
    torch.cuda.synchronize()
    join_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fplan = sj.plan_fused_tiles(*(batch.x, batch.y, batch.t,
                                  batch.valid) * 2, *eps)
    _ = fplan.by_row, fplan.by_tile
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    jk, jd = int(counts.sum()), mask.numel()
    fk = int((fplan.tile_ids >= 0).sum())
    fd = fplan.tile_ids.shape[0] * -(-batch.num_trajs // sj.FUSED_BC)
    log(f"index plans ({name}): join {jk} of {jd} tiles kept "
        f"({100 * jk / jd:.2f}%), tile_ids {list(join_ids.shape)}, planned "
        f"in {join_ms:.2f} ms; fused {fk} of {fd} tiles kept "
        f"({100 * fk / fd:.2f}%), tile_ids {list(fplan.tile_ids.shape)}, "
        f"planned and transposed in {fused_ms:.2f} ms")
    report[f"{name}_index_plans"] = dict(
        join_kept=jk, join_dense=jd, join_width=join_ids.shape[1],
        join_plan_ms=join_ms, fused_kept=fk, fused_dense=fd,
        fused_width=fplan.tile_ids.shape[1], fused_plan_ms=fused_ms)
    return join_ids, fplan


def kept_window_pairs(batch, eps_t: float, tile_ids, bp: int, bc: int,
                      rows=None, cands=None) -> int:
    """``window_partners`` restricted to the (block of ``bp`` points,
    tile of ``bc`` candidates) pairs a plan keeps: the (point, candidate
    point) pairs with |dt| <= eps_t of another trajectory that a pruned
    kernel has to evaluate.  ``rows`` / ``cands``: only the points of
    these reference rows / of these candidates (closed ranges)."""
    from repro_torch.kernels.stjoin.ref import tile_keep
    T, M = batch.x.shape
    t = batch.t.double()
    tv = torch.where(batch.valid, t, torch.inf)
    lo, hi = (t - eps_t).reshape(-1), (t + eps_t).reshape(-1)
    rows_sorted = tv.sort(dim=1).values
    own = (torch.searchsorted(rows_sorted, (t + eps_t), right=True)
           - torch.searchsorted(rows_sorted, (t - eps_t))).reshape(-1)
    keep = tile_keep(tile_ids, -(-T // bc))
    pts = torch.arange(T * M, device=t.device)
    ok = batch.valid.reshape(-1)
    if rows is not None:
        ok = ok & (pts // M >= rows[0]) & (pts // M <= rows[1])
    c_lo, c_hi = (0, T - 1) if cands is None else cands
    total = 0
    for j in range(c_lo // bc, c_hi // bc + 1):
        a, b = max(j * bc, c_lo), min((j + 1) * bc, c_hi + 1)
        seq = tv[a:b].reshape(-1).sort().values
        p = torch.nonzero(ok & keep[pts // bp, j])[:, 0]
        cnt = (torch.searchsorted(seq, hi[p], right=True)
               - torch.searchsorted(seq, lo[p]))
        mine = (p // M >= a) & (p // M < b)
        total += int((cnt - torch.where(mine, own[p], 0)).sum())
    return total


def live_reads(pairs, bp: int, bc: int, P: int, C: int, cands=None):
    """The reference points ``[P]`` and candidates ``[C]`` (bool) that a
    pruned kernel reads for the live (block, tile) entries ``pairs
    [n, 2]``: the points of each block, the candidates of each tile
    (``cands``: only those in this closed range)."""
    dev = pairs.device
    pts = torch.zeros(P, dtype=torch.bool, device=dev)
    cand = torch.zeros(C, dtype=torch.bool, device=dev)
    blk, tile = pairs[:, 0].long().unique(), pairs[:, 1].long().unique()
    p = (blk[:, None] * bp + torch.arange(bp, device=dev)).reshape(-1)
    pts[p[p < P]] = True
    c = (tile[:, None] * bc + torch.arange(bc, device=dev)).reshape(-1)
    lo, hi = (0, C - 1) if cands is None else cands
    cand[c[(c >= lo) & (c <= hi)]] = True
    return pts, cand


def read_bytes(pts, cand, Mc: int, gids: bool = False) -> int:
    """``join_input_bytes`` of the points and candidates read (``gids``:
    with their slot maps, 4 bytes a point)."""
    n_p, n_c = int(pts.sum()), int(cand.sum())
    return (join_input_bytes(n_p, n_c, Mc)
            + (4 * (n_p + n_c * Mc) if gids else 0))


def phase_pruned_kernels(batch, params, sub, join_ids, fplan, launches,
                         rows, name: str, n_plain: int):
    """K10-K13 on the batch's plans, each against its dense kernel bit for
    bit (K13 on every panel) and against its plain version bit for bit,
    on the first ``n_plain`` reference rows (K13 on one whole panel).
    With ``n_plain`` = T, each is also timed, with its bound, into
    ``rows``.  ``sub``: the main path's segmentation (``sub_local``).  The
    plain versions of K11 and K12 share one pruned plain join (the fused
    plan's), as K2's and K4's share K1's: their plain time is that join's
    plus their tail.  A bound counts the operands a kernel reads for its
    plan's live entries (``live_reads``), those entries, its outputs, and
    the pairs its kept tiles need (``kept_window_pairs``)."""
    from repro_torch.core.similarity import plan_panel, scatter_raw, slot_ids
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import (run_refine,
                                                stjoin_pruned_ref,
                                                stjoin_sim_panel_fused_ref,
                                                vote_words_ref)
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    ref_ops, cand_ops = sj._flat_operands(*arrs)
    gid = slot_ids(sub, ms_, S)
    tiles = (fplan.tile_ids, M, fplan.bc)
    timed = n_plain == T
    nP, nS = n_plain * M, n_plain * ms_
    head = tuple(a[:nP] for a in ref_ops)   # the first rows' points
    rng = f"rows [0, {n_plain})"

    # ---- K10 against K1 and its plain version -----------------------------
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)
    kw, ki = sj.stjoin_best_match_pruned(*ref_ops, *cand_ops, join_ids,
                                         *eps[:2], stats=stats)
    mirror = sj.join_skip_counts(batch.t, batch.valid, batch.t, batch.valid,
                                 params.eps_t, tile_ids=join_ids)
    kept_pairs = kept_window_pairs(batch, params.eps_t, join_ids, sj.JOIN_BP,
                                   sj.JOIN_BC)
    live, _ = sj._live_pairs(join_ids)
    log(f"{name}: K10 {live.shape[0]} planned (block, tile) pairs; "
        + sweep_skips(stats, mirror, live.shape[0] * sj.JOIN_BP * sj.JOIN_BC
                      * Mc, K1_OPS_PER_PAIR * kept_pairs, "K10"))
    dw, di = sj.stjoin_best_match(*ref_ops, *cand_ops, *eps[:2])
    check(torch.equal(kw, dw) and torch.equal(ki, di),
          f"{name}: K10 not bitwise K1")
    del dw, di
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_pruned_ref(
        *head, *cand_ops, join_ids, *eps[:2], bp=sj.JOIN_BP,
        bc=sj.JOIN_BC)), reps=1, warmup=0)
    pw, pi = plain_out.pop()
    err = float((kw[:nP] - pw).abs().max())
    check(torch.equal(kw[:nP], pw) and torch.equal(ki[:nP], pi),
          f"{name}: K10 not bitwise its plain version on {rng} (max err "
          f"{err})")
    del pw, pi
    ms = time_ms(lambda: sj.stjoin_best_match_pruned(
        *ref_ops, *cand_ops, join_ids, *eps[:2], out_w=kw, out_idx=ki),
        reps=3)
    ms1 = time_ms(lambda: sj.stjoin_best_match(
        *ref_ops, *cand_ops, *eps[:2], out_w=kw, out_idx=ki), reps=3)
    # K10 writes every output itself; the two fills of [P, C] a wrapper
    # would add before it, timed alone on the same outputs
    fills = time_ms(lambda: (kw.zero_(), ki.fill_(-1)), reps=3)
    log(f"{name}: K10 {ms:.3f} ms (no fills: it writes every output), with "
        f"the two fills of its outputs {ms + fills:.3f} ms (fills alone "
        f"{fills:.3f} ms); K1 {ms1:.3f} ms, on the same inputs")
    if timed:
        K = join_ids.shape[1]           # a row shorter than K reads its -1
        short = int(((join_ids >= 0).sum(1) < K).sum())
        nbytes = (read_bytes(*live_reads(live, sj.JOIN_BP, sj.JOIN_BC, P,
                                         C), Mc)
                  + 4 * (live.shape[0] + short) + 8 * P * C)
        kernel_row(rows, "stjoin_best_match_pruned", launches, err, ms,
                   plain, bound_ms(nbytes, K1_OPS_PER_PAIR * kept_pairs))
        log(f"  K10: {live.shape[0]} live entries, {kept_pairs} needed "
            "pairs in kept tiles; library none")
    del kw, ki
    # the materialize join stage's join, whole (plan, fills, K10 / K1), in
    # turns: dense, index, index, dense
    join = {False: sj.best_match_join_kernel, True: sj.best_match_join_pruned}
    jms = {False: 0.0, True: 0.0}
    for idx in (False, True, True, False):
        jms[idx] += time_ms(lambda: join[idx](batch, batch, *eps[:2]),
                            reps=2) / 2
    log(f"{name}: the join, whole wrapper: with the index {jms[True]:.3f} "
        f"ms (plan, K10), dense {jms[False]:.3f} ms (K1)")

    # ---- K11 against K2, K12 against K4 -----------------------------------
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)
    kv, kwords = sj.stjoin_vote_fused_arrays(*arrs, *eps, tile_ids=fplan,
                                             stats=stats)
    mirror = sj.fused_skip_counts(batch.t, batch.valid, batch.t, batch.valid,
                                  params.eps_t, tile_ids=fplan)
    n_pairs = sj.fused_pairs(T, C, fplan).shape[0]
    needed = K1_OPS_PER_PAIR * kept_window_pairs(
        batch, params.eps_t, fplan.tile_ids, M, fplan.bc)
    log(f"{name}: K11 {n_pairs} (row, candidate) pairs planned; "
        + sweep_skips(stats, mirror, n_pairs * M * Mc, needed, "K11"))
    dv, dwords = sj.stjoin_vote_fused_arrays(*arrs, *eps)
    check(torch.equal(kv, dv) and torch.equal(kwords, dwords),
          f"{name}: K11 vote / words not bitwise K2's")
    del dv, dwords
    stats.zero_()
    raw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps,
                              tile_ids=fplan, stats=stats)
    log(f"{name}: K12 " + sweep_skips(stats, mirror, n_pairs * M * Mc,
                                      needed, "K12"))
    draw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps)
    check(torch.equal(raw, draw), f"{name}: K12 raw not bitwise K4's")
    del draw
    if timed:
        ms11 = time_ms(lambda: sj.stjoin_vote_fused_arrays(
            *arrs, *eps, tile_ids=fplan), reps=3)
        ms12 = time_ms(lambda: sj.stjoin_sim_fused(
            batch, batch, sub, sub, ms_, *eps, tile_ids=fplan), reps=3)

    # ---- K11 and K12 against their plain versions -------------------------
    plain_out = []
    join_ms = time_ms(lambda: plain_out.append(stjoin_pruned_ref(
        *head, *cand_ops, fplan.tile_ids, *eps[:2], bp=M, bc=fplan.bc)),
        reps=1, warmup=0)
    pw, pi = plain_out.pop()
    ref_t = batch.t.reshape(-1)[:nP]
    tail = time_ms(lambda: plain_out.append(vote_words_ref(
        run_refine(pw, None, ref_t, M, params.delta_t)[0])), reps=1,
        warmup=0)
    pv, pwords = plain_out.pop()
    err = float((kv.view(-1)[:nP] - pv).abs().max())
    check(torch.equal(kv.view(-1)[:nP], pv)
          and torch.equal(kwords.view(P, -1)[:nP], pwords),
          f"{name}: K11 not bitwise its plain version on {rng} (max err "
          f"{err})")
    W = pwords.shape[1]
    del pv, pwords
    live, _ = fplan.by_row
    if timed:
        fpairs = needed // K1_OPS_PER_PAIR
        reads = live_reads(live, M, fplan.bc, P, C)
        K = fplan.tile_ids.shape[1]     # a row shorter than K reads its -1
        short = int(((fplan.tile_ids >= 0).sum(1) < K).sum())
        kernel_row(rows, "stjoin_vote_fused_pruned", launches, err, ms11,
                   join_ms + tail,
                   bound_ms(read_bytes(*reads, Mc)
                            + 4 * (live.shape[0] + short) + P * 4
                            + P * W * 4, K1_OPS_PER_PAIR * fpairs))
    w_r, i_r = run_refine(pw, pi, ref_t, M, params.delta_t)
    del pw, pi
    tail = time_ms(lambda: plain_out.append(scatter_raw(
        w_r.view(n_plain, M, C), i_r.view(n_plain, M, C),
        slot_ids(sub[:n_plain], ms_, nS), gid, nS, S)), reps=1, warmup=0)
    praw = plain_out.pop()
    err = float((raw[:nS] - praw).abs().max())
    check(torch.equal(raw[:nS], praw),
          f"{name}: K12 not bitwise its plain version on {rng} (max err "
          f"{err})")
    if timed:
        kernel_row(rows, "stjoin_sim_fused_pruned", launches, err, ms12,
                   join_ms + tail,
                   bound_ms(read_bytes(*reads, Mc, gids=True)
                            + 8 * live.shape[0] + S * S * 4,
                            K1_OPS_PER_PAIR * fpairs))
        log(f"  K11 / K12 plain = the pruned plain join {join_ms:.1f} ms + "
            f"their tails; {live.shape[0]} live entries, {fpairs} needed "
            "pairs in kept tiles; library none")
    del w_r, i_r, praw, kv, kwords

    # ---- K13 against K7, every panel (each call timed), skip counts ---------
    Sb = plan_panel(S)
    sweeps = {"K13": sj.sim_panel_sweep(batch, batch, sub, sub, ms_, *eps,
                                        tile_ids=fplan),
              "K7": sj.sim_panel_sweep(batch, batch, sub, sub, ms_, *eps)}
    swept = {k: 0.0 for k in sweeps}
    counts = {k: [0, 0] for k in sweeps}
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)

    def timed_panel(key):
        stats.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sweeps[key](p0, panel=Sb, stats=stats)
        end.record()
        end.synchronize()
        swept[key] += start.elapsed_time(end)
        got, want = stats.tolist(), sweeps[key].skip_counts(p0, panel=Sb)
        check(got == list(want), f"{name}: {key} panel {p0} swept / skipped "
              f"{got} (group, chunk) pairs, the mirror {want}")
        counts[key] = [a + b for a, b in zip(counts[key], got)]
        return out

    for p0 in range(0, S, Sb):
        f13, r13 = timed_panel("K13")
        f7, r7 = timed_panel("K7")
        check(torch.equal(f13, f7) and torch.equal(r13, r7),
              f"{name}: K13 panel {p0} not bitwise K7's")
        check(torch.equal(f13, raw[p0:p0 + Sb])
              and torch.equal(r13, raw.T[p0:p0 + Sb]),
              f"{name}: K13 panel {p0} not bitwise K12's raw")
    del raw, f7, r7
    log(f"{name}: K10 bitwise K1, K11 bitwise K2 (vote, words), K12 bitwise "
        f"K4, K13 bitwise K7 on all {S // Sb} panels; all panels, one "
        f"prepared call each (CUDA events): K13 {swept['K13']:.1f} ms, K7 "
        f"{swept['K7']:.1f} ms; (group, chunk) pairs skipped of swept, "
        f"equal to the mirror on every panel: K13 {counts['K13'][1]} of "
        f"{counts['K13'][0]}, K7 {counts['K7'][1]} of {counts['K7'][0]}")

    # ---- K13 against its plain version, one panel in the middle ------------
    p0 = (S // Sb // 2) * Sb
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_sim_panel_fused_ref(
        *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
        n_dst=S, p0=p0, panel=Sb, tiles=tiles)), reps=1, warmup=0)
    pf, pr = plain_out.pop()
    f13, r13 = sj.stjoin_sim_panel_fused(batch, batch, sub, sub, ms_, *eps,
                                         p0=p0, panel=Sb, tile_ids=fplan)
    err = max(float((f13 - pf).abs().max()), float((r13 - pr).abs().max()))
    check(torch.equal(f13, pf) and torch.equal(r13, pr),
          f"{name}: K13 not bitwise its plain version on panel {p0} (max "
          f"err {err})")
    log(f"{name}: K10, K11, K12 bitwise their plain versions on {rng}, K13 "
        f"on panel [{p0}, {p0 + Sb})")
    if timed:
        wrapper = time_ms(lambda: sj.stjoin_sim_panel_fused(
            batch, batch, sub, sub, ms_, *eps, p0=p0, panel=Sb,
            tile_ids=fplan), reps=10)
        call = time_ms(lambda: sweeps["K13"](p0, panel=Sb), reps=10)
        ms = graph_ms(lambda: sweeps["K13"](p0, panel=Sb))
        stats.zero_()
        sweeps["K13"](p0, panel=Sb, stats=stats)
        skips = panel_skips(sweeps["K13"], p0, Sb, stats, f"{name}: K13")
        # the panel's live entries, sliced as the wrapper slices them
        t_lo, t_hi = p0 // ms_, (p0 + Sb - 1) // ms_
        fwd_pairs, blocks = fplan.by_row
        rev_pairs, tile_of = fplan.by_tile
        f0, f1 = (int(i) for i in blocks.searchsorted([t_lo, t_hi + 1]))
        r0, r1 = (int(i) for i in tile_of.searchsorted(
            [t_lo // fplan.bc, t_hi // fplan.bc + 1]))
        fp, fc = live_reads(fwd_pairs[f0:f1], M, fplan.bc, P, C)
        rp, rc = live_reads(rev_pairs[r0:r1], M, fplan.bc, P, C,
                            cands=(t_lo, t_hi))
        pairs = (kept_window_pairs(batch, params.eps_t, fplan.tile_ids, M,
                                   fplan.bc, rows=(t_lo, t_hi))
                 + kept_window_pairs(batch, params.eps_t, fplan.tile_ids, M,
                                     fplan.bc, cands=(t_lo, t_hi)))
        nbytes = (read_bytes(fp | rp, fc | rc, Mc, gids=True)
                  + 8 * (f1 - f0 + r1 - r0) + 2 * Sb * S * 4)
        kernel_row(rows, "stjoin_sim_panel_fused_pruned", launches, err, ms,
                   plain, bound_ms(nbytes, K1_OPS_PER_PAIR * pairs))
        log(f"  K13 panel [{p0}, {p0 + Sb}): {f1 - f0} forward and "
            f"{r1 - r0} reverse live entries, {int((fp | rp).sum())} "
            f"reference points and {int((fc | rc).sum())} candidates read; "
            f"{skips}; {pairs} needed pairs; kernel alone {ms:.4f} ms (CUDA "
            f"graph, its two zero fills included), per call {call:.4f} ms "
            f"(prepared), {wrapper:.4f} ms (public wrapper); library none")


def phase_index(dev, report, batch, params, name: str, outs=None):
    """The three pruned paths on one batch (and, without ``outs``, the
    three unpruned ones first), their outputs compared; returns each
    kernel's launch count in the pruned run of its path (K11 runs in two
    paths, once in each) and the fused segmentation."""
    outs = dict(outs or {})
    for path in PRUNED_PATHS:
        if path not in outs:
            outs[path] = phase_main(dev, report, path, name=name,
                                    data=(batch, params))[2]
    pouts, launches = {}, {}
    for path in PRUNED_PATHS:
        _, _, pouts[path], n = phase_main(dev, report, path + "+index",
                                          name=name, data=(batch, params))
        for k, v in n.items():      # a kernel's count in its path's run
            launches[k] = max(launches.get(k, 0), v)
    same_pruned(outs, pouts, name)
    return launches, pouts["fused"].seg.sub_local


@contextlib.contextmanager
def recorded_rounds():
    """Yields a list that collects each clustering round's ``(unresolved,
    is_rep)``, by wrapping the K5 wrapper that the dense engine imports at
    each call (``kernels.cluster.ops.cluster_round_scan``); every round
    still launches K5 through the real wrapper, counted as before."""
    from repro_torch.kernels.cluster import ops
    real, states = ops.cluster_round_scan, []

    def record(sim, rank, unresolved, is_rep, alpha, **knobs):
        states.append((unresolved.clone(), is_rep.clone()))
        return real(sim, rank, unresolved, is_rep, alpha, **knobs)

    ops.cluster_round_scan = record
    try:
        yield states
    finally:
        ops.cluster_round_scan = real


@contextlib.contextmanager
def recorded_claims():
    """Yields a list that collects each top-K dispatch's claim-max inputs
    ``(ids, sims, rank, is_rep, valid, alpha)``, copied to the host, by
    wrapping the K9 wrapper that the top-K engine imports at each call
    (``kernels.cluster.ops.topk_cluster_assign``); every dispatch still
    launches K9 through the real wrapper, counted as before."""
    from repro_torch.kernels.cluster import ops
    real, calls = ops.topk_cluster_assign, []

    def record(ids, sims, rank, is_rep, valid, alpha, **knobs):
        calls.append((*(t.cpu() for t in (ids, sims, rank, is_rep, valid)),
                      float(alpha)))
        return real(ids, sims, rank, is_rep, valid, alpha, **knobs)

    ops.topk_cluster_assign = record
    try:
        yield calls
    finally:
        ops.topk_cluster_assign = real


def k9_bytes(valid, K: int) -> int:
    """K9's bytes: the valid rows' ids and sims (8 bytes an entry), rank,
    is_rep and valid (6 bytes a row), the two outputs (8 bytes a row)."""
    S = valid.shape[0]
    return int(valid.sum()) * K * 8 + S * 6 + S * 8


def phase_main(dev, report, mode: str, n_vessels: int = 4096,
               name: str = "dsc_brest", data=None, rounds=None):
    """One main path at full size (``data``: its ``(batch, params)``, else
    ``brest_batch(n_vessels)``); launch counts read around it.  Peak
    memory is the run's own: the peak allocation above what was
    allocated just before it.  ``rounds`` (a list, dense paths): filled
    with each clustering round's ``(unresolved, is_rep)``."""
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc
    batch, params = data or brest_batch(n_vessels, dev)
    T, M = batch.x.shape
    log(f"main path ({mode}): {name} T={T} M={M} "
        f"S={T * params.max_subtrajs_per_traj} "
        f"eps_sp={params.eps_sp:.6g} eps_t={params.eps_t:.6g}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with (recorded_rounds() if rounds is not None
          else contextlib.nullcontext([])) as states:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_dsc(batch, params, plan=kernel_plan(mode), device=dev,
                      stage_times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    if rounds is not None:
        check(len(states) == out.rounds,
              f"{mode}: {len(states)} rounds recorded, {out.rounds} run")
        rounds.extend(states)
    peak = torch.cuda.max_memory_allocated() - base
    ran = {k for k, n in launches.items() if n > 0}
    check(ran == PATH_KERNELS[mode],
          f"{mode} path launched {sorted(ran)}, expected "
          f"{sorted(PATH_KERNELS[mode])}")
    if "_topk" in mode:
        from repro_torch.core.similarity import plan_panel
        S = out.table.num_slots
        panels = out.dispatches * S // plan_panel(S)
        want = {"topk_round_scan": out.rounds,
                "topk_claim_max": out.dispatches,
                "sim_row_moments": panels}
        for panel in ("stjoin_sim_panel_fused",
                      "stjoin_sim_panel_fused_pruned"):
            if panel in ran:
                want[panel] = panels
        check(out.sim is None and peak < S * S * 4,
              f"{mode}: a [S, S] matrix was built (peak {peak} B)")
    else:
        want = {"round_scan": out.rounds}
    # the chunk bounds: once per join call (K2 and K4 each), once per
    # top-K dispatch
    want["chunk_time_bounds"] = (1 + ("fused" in mode)
                                 * (out.dispatches if "_topk" in mode else 1))
    for k in ran - set(want):
        want[k] = 1
    check(all(launches[k] == n for k, n in want.items()),
          f"{mode} path: launches {launches}, expected {want}")
    check_output(out, batch, params)
    # materialize mode returns its cube (held to the end of the run, so in
    # its peak); no later phase reads it, so it goes here
    if mode.startswith("materialize"):
        check(out.join is not None
              and out.join.best_w.shape == (T, M, batch.num_trajs),
              f"{mode}: DSCOutput.join is not the [T, M, C] cube")
    else:
        check(out.join is None, f"{mode}: DSCOutput.join is not None")
    out.join = None
    r = out.result
    members = int((~r.is_rep & (r.member_of >= 0)).sum())
    # the stages' parts, cut by the run's own events: the slot table, the
    # dense matrix's normalization, the thresholds (row moments over
    # [S, S] or the lists'), the round loop (a K5 / K8 launch and a host
    # sync a round)
    parts = {k: v for k, v in times.items() if "." in k}
    want_parts = {"segment.table", "cluster.thresholds",
                  "cluster.round_loop"}
    if "_topk" not in mode:
        want_parts.add("similarity.finalize")
    check(set(parts) == want_parts
          and all(v <= times[k.split(".")[0]] for k, v in parts.items()),
          f"{mode}: stage parts {parts} against stages {times}")
    log("stage ms (CUDA events): " + ", ".join(
        f"{k}={v:.3f}" for k, v in times.items()))
    topk_k = None if out.sim_topk is None else out.sim_topk.k
    log(f"main path ({mode}, {name}) wall s={wall:.3f} rounds={out.rounds} "
        f"dispatches={out.dispatches} final_K={topk_k} "
        f"peak_alloc_GB={peak / 1e9:.3f} clusters={int(r.is_rep.sum())} "
        f"members={members} outliers={int(r.is_outlier.sum())} "
        f"alpha={float(r.alpha_used):.6g} k={float(r.k_used):.6g}")
    log(f"launches: {launches}")
    report[f"{name}_{mode}"] = dict(
        stage_ms=times, wall_s=wall, rounds=out.rounds,
        dispatches=out.dispatches, final_k=topk_k,
        peak_alloc_bytes=peak, clusters=int(r.is_rep.sum()),
        members=members, outliers=int(r.is_outlier.sum()),
        launches=launches)
    return batch, params, out, launches


RESULT_FIELDS = ("member_of", "is_rep", "is_outlier", "member_sim",
                 "alpha_used", "k_used")


def launcher_plan_file(mode: str) -> str:
    """``kernel_plan(mode)`` saved by the port's ``EnginePlan.save`` under
    the git-ignored ``build/``."""
    path = ROOT / "build" / "chip_smoke" / f"plan_{mode}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    kernel_plan(mode).save(path)
    return str(path)


def launcher_run(report, name: str, argv: list, want, want_launches):
    """``repro_torch.launch.run_dsc.main(argv)`` in this process, launch
    counts zeroed just before it and read just after: equal to
    ``want_launches`` (the same path's ``phase_main`` run), and the
    labels, ``member_sim``, alpha and k bitwise ``want``'s (that run's
    ``ClusteringResult``).  Logs the wall (data generation included,
    timed alone beside it) and the run's own peak allocation."""
    from repro_torch import kernels
    from repro_torch.data.synthetic import default_dsc_params_for
    from repro_torch.launch import run_dsc as launcher
    args = launcher.build_parser().parse_args(argv)
    rc = launcher.get_dsc_config(args.config)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    default_dsc_params_for(launcher.make_dataset(
        rc.name, args.n_trajs, rc.max_points, device="cuda"))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = launcher.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    check(launches == want_launches,
          f"launcher ({name}): launches {launches}, expected "
          f"{want_launches}")
    for f in RESULT_FIELDS:
        check(torch.equal(getattr(out.result, f), getattr(want, f)),
              f"launcher ({name}): {f} not bitwise the main path's")
    r = out.result
    log(f"launcher ({name}): {' '.join(argv)}")
    log(f"launcher ({name}) wall s={wall:.3f} of which data generation "
        f"s={data_s:.3f} (timed alone) peak_alloc_GB={peak / 1e9:.3f} "
        f"clusters={int(r.is_rep.sum())} outliers={int(r.is_outlier.sum())};"
        f" labels, member_sim, alpha, k and launches equal the main path's")
    report[f"launcher_{name}"] = dict(argv=argv, wall_s=wall,
                                      data_s=data_s, peak_alloc_bytes=peak,
                                      launches=launches)
    return out


def stage_chain(batch, params, plan):
    """The stage entry points chained as ``run_dsc`` runs its stages (one
    dispatch: the dense paths).  Materialize mode runs ``run_stage_join``,
    then ``run_stage_vote_from_join`` on its cube (equal to the join
    stage's votes and words, checked) and goes on from those."""
    from repro_torch.core import dsc
    tile_ids = None
    if plan.mode == "fused":
        tile_ids, plan = dsc.plan_fused_tile_ids(batch, params, plan)
        join = None
        vote, masks = dsc.run_stage_join_fused(batch, params,
                                               tile_ids=tile_ids, plan=plan)
    else:
        join, vote0, masks0 = dsc.run_stage_join(batch, params, plan)
        vote, masks = dsc.run_stage_vote_from_join(batch, params, join,
                                                   plan)
        check(torch.equal(vote, vote0) and torch.equal(masks, masks0),
              "run_stage_vote_from_join differs from run_stage_join")
        del vote0, masks0
    seg, table = dsc.run_stage_segment(batch, params, vote, masks, plan)
    del masks
    sim, topk = dsc.run_stage_similarity(batch, params, join, seg, table,
                                         tile_ids=tile_ids, plan=plan)
    result, overflow = dsc.run_stage_cluster(sim, table, params, plan)
    sscr, rmse = dsc.run_stage_score(result, sim, params)
    return dict(join=join, vote=vote, seg=seg, table=table, sim=sim,
                sim_topk=topk, sim_overflow=overflow, result=result,
                sscr=sscr, rmse=rmse)


def phase_stages(dev, report, batch, params, runs):
    """The seven stage entry points on dsc_brest, each path's launch
    counts zeroed just before the chain and read just after: the fused
    and the materialize kernel plans, every field bitwise the main run's
    (``runs[mode]``: its output and launches; its cube was dropped, so
    the chain's is checked by the votes and words it gives), with the
    same launches; then ``run_dsc_lowerable`` with the fused kernel plan,
    every field bitwise the main fused run's."""
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc_lowerable
    for mode in ("fused", "materialize"):
        want, want_launches = runs[mode]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = stage_chain(batch, params, kernel_plan(mode))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        check(launches == want_launches,
              f"stage chain ({mode}): launches {launches}, expected "
              f"{want_launches}")
        if mode == "materialize":
            check(got.pop("join").best_w.shape == (batch.num_trajs,
                                                   batch.max_points,
                                                   batch.num_trajs),
                  "stage chain (materialize): no [T, M, C] cube")
        diffs = [d for f, v in got.items()
                 for d in diff_fields(v, getattr(want, f), f)]
        check(not diffs, f"stage chain ({mode}): {diffs} not bitwise "
                         "run_dsc's")
        log(f"stage chain ({mode}, dsc_brest): the seven stage entry "
            f"points' outputs bitwise run_dsc's, same launches; wall "
            f"s={wall:.3f}")
        report[f"stage_chain_{mode}"] = dict(wall_s=wall, launches=launches)
        del got
    want, want_launches = runs["fused"]
    kernels.reset_launch_counts()
    low = run_dsc_lowerable(batch, params, kernel_plan("fused"), device=dev)
    launches = dict(kernels.LAUNCHES)
    diffs = diff_fields(low, want)
    check(not diffs and launches == want_launches,
          f"run_dsc_lowerable (fused): {diffs} differ, launches {launches}")
    log("run_dsc_lowerable (fused, dsc_brest): every field bitwise "
        "run_dsc's, same launches")


# ---------------------------------------------------------------------------
# The resilient runner, the streaming service and the launcher's
# resilient and stream options
# ---------------------------------------------------------------------------

# the kernels the resumed fused top-K run launches: the widen re-runs
# similarity (K7 and the row moments a panel) from the segment checkpoint
RESUME_KERNELS = {"chunk_time_bounds", "stjoin_sim_panel_fused",
                  "sim_row_moments", "topk_round_scan", "topk_claim_max"}
# the stream at full width: records per submission batch
STREAM_BATCH = 32768
# kernels an advance of the TSA1 stream launches: K1 (and the candidates'
# chunk time bounds) for the delta join, K9 for the claim-max; K8 when a
# round runs (a warm prefix can resolve every slot)
STREAM_NEED = {"stjoin_best_match", "chunk_time_bounds", "topk_claim_max"}
STREAM_KERNELS = STREAM_NEED | {"topk_round_scan"}
# the stream kill-and-resume phase: its window and its batches
RESUME_T_CAP = 512
RESUME_BATCH = 4096


@contextlib.contextmanager
def recorded_saves():
    """Every checkpoint write as ``(step, bytes, seconds)`` (on the writer
    thread for async saves), and every stage save's seconds on the calling
    thread (the host copy and hand-off), by wrapping the port's
    ``save_checkpoint`` and ``_StageLoop._save``."""
    import numpy as np
    from repro_torch.checkpoint import checkpointer
    from repro_torch.run import resilient
    real_write, real_save = checkpointer.save_checkpoint, \
        resilient._StageLoop._save
    writes, calls = [], []

    def write(root, step, tree, meta=None):
        t0 = time.perf_counter()
        out = real_write(root, step, tree, meta=meta)
        _, leaves = checkpointer._flatten_with_paths(tree)
        writes.append((step, sum(v.nbytes if hasattr(v, "nbytes")
                                 else np.asarray(v).nbytes for v in leaves),
                       time.perf_counter() - t0))
        return out

    def save(self, step, stage, state):
        t0 = time.perf_counter()
        real_save(self, step, stage, state)
        calls.append(time.perf_counter() - t0)

    checkpointer.save_checkpoint = write
    resilient._StageLoop._save = save
    try:
        yield writes, calls
    finally:
        checkpointer.save_checkpoint = real_write
        resilient._StageLoop._save = real_save


def free_disk(path) -> str:
    import shutil
    u = shutil.disk_usage(path)
    return f"{u.free / 1e9:.1f} GB free of {u.total / 1e9:.1f} GB"


def phase_resilient(dev, report, batch, params, tout, tlaunches):
    """The resilient runner at dsc_brest with the fused top-K kernel plan,
    checkpoints under a temporary directory, ``on_overflow="widen"``: a
    run with ``FaultPlan(crash_at="cluster")`` must raise ``InjectedCrash``
    (launching the join, segmentation and first similarity kernels), then
    the resume: ``resumed_from == 3``, one widen fewer than the main run's
    dispatches, only K7, K8 and K9 (and the chunk bounds) launched, K8's
    launches the main run's, and labels, lists, final K and sscr bitwise
    the main fused top-K run's (``tout``)."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.run import FaultPlan, InjectedCrash, run_resilient
    from repro_torch.core.similarity import plan_panel
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    log(f"resilient (dsc_brest, fused top-K): checkpoints under a "
        f"temporary directory, {free_disk(root)}")
    plan = kernel_plan("fused_topk")
    try:
        with recorded_saves() as (writes, calls):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            try:
                run_resilient(batch, params, plan=plan, checkpoint_dir=root,
                              on_overflow="widen", device=dev,
                              fault_plan=FaultPlan(crash_at="cluster"))
                check(False, "resilient: the crash at 'cluster' did not "
                             "raise")
            except InjectedCrash:
                pass
            torch.cuda.synchronize()
            crash_s = time.perf_counter() - t0
            crash_launches = dict(kernels.LAUNCHES)
            crash_peak = torch.cuda.max_memory_allocated() - base
            want = {"chunk_time_bounds", "stjoin_vote_fused",
                    "jaccard_window", "stjoin_sim_panel_fused",
                    "sim_row_moments"}
            check({k for k, n in crash_launches.items() if n} == want,
                  f"resilient crash run launched {crash_launches}")
            n_crash_writes = len(writes)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = run_resilient(batch, params, plan=plan,
                                checkpoint_dir=root, on_overflow="widen",
                                device=dev)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() - base
        ran = {k for k, n in launches.items() if n}
        S = tout.table.num_slots
        check(ran == RESUME_KERNELS,
              f"resilient resume launched {sorted(ran)}, expected "
              f"{sorted(RESUME_KERNELS)}")
        check(res.resumed_from == 3,
              f"resilient: resumed_from={res.resumed_from}, expected 3")
        check(res.widen_count == tout.dispatches - 1,
              f"resilient: widen_count={res.widen_count}, main run "
              f"dispatches {tout.dispatches}")
        want = {"stjoin_sim_panel_fused":
                res.widen_count * S // plan_panel(S),
                "sim_row_moments": res.widen_count * S // plan_panel(S),
                "topk_claim_max": tout.dispatches,
                "topk_round_scan": tlaunches["topk_round_scan"],
                "chunk_time_bounds": res.widen_count}
        check(all(launches[k] == n for k, n in want.items()),
              f"resilient resume: launches {launches}, expected {want}")
        out = res.output
        diffs = [f for f in RESULT_FIELDS
                 if not torch.equal(getattr(out.result, f),
                                    getattr(tout.result, f))]
        diffs += [f for f in ("ids", "sims", "spill", "degree", "row_sum",
                              "row_sumsq")
                  if not torch.equal(getattr(out.sim_topk, f),
                                     getattr(tout.sim_topk, f))]
        check(not diffs and torch.equal(out.sscr, tout.sscr)
              and out.sim_topk.k == tout.sim_topk.k,
              f"resilient resume: {diffs} (or sscr, final K) not bitwise "
              "the main fused top-K run's")
        ckpt_bytes = sum(b for _, b, _ in writes)
        save_s = [s for _, _, s in writes]
        disk = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())
        log(f"resilient (dsc_brest, fused top-K): crash run wall "
            f"s={crash_s:.3f} peak_alloc_GB={crash_peak / 1e9:.3f} "
            f"({n_crash_writes} saves); resume wall s={resume_s:.3f} "
            f"peak_alloc_GB={peak / 1e9:.3f} resumed_from=3 "
            f"widen_count={res.widen_count} final_K={out.sim_topk.k}; "
            f"labels, lists, final K and sscr bitwise the main run's")
        log(f"resilient checkpoints: {len(writes)} saves, "
            f"{ckpt_bytes / 1e9:.3f} GB written, s per save (writer thread) "
            f"mean {sum(save_s) / len(save_s):.3f} max {max(save_s):.3f}; "
            f"s per save on the calling thread (host copy) mean "
            f"{sum(calls) / len(calls):.3f} max {max(calls):.3f}; "
            f"{disk / 1e9:.3f} GB on disk at the end")
        log(f"resilient resume launches: {launches}")
        report["resilient_dsc_brest_fused_topk"] = dict(
            crash_wall_s=crash_s, crash_peak_alloc_bytes=crash_peak,
            crash_launches=crash_launches, resume_wall_s=resume_s,
            resume_peak_alloc_bytes=peak, launches=launches,
            widen_count=res.widen_count, final_k=out.sim_topk.k,
            saves=len(writes), checkpoint_bytes=ckpt_bytes,
            save_s=save_s, save_call_s=calls, disk_bytes_end=disk)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def batch_span(records) -> float:
    """The longest event-time span of one submission batch."""
    import numpy as np
    return max(float(np.float64(r.t.max()) - np.float64(r.t.min()))
               for r in records)


def stream_config(batch, params, alpha, k, t_cap, records, **kw):
    """The stream's configuration over ``batch`` at dsc_brest's eps
    (0.15 x diameter, the mean sampling interval), absolute thresholds
    ``alpha`` / ``k``, the whole span as horizon, and as allowed lateness
    the longest span of one of ``records``' batches plus twice the mean
    interval (a batch's watermark is its newest fix less the lateness: a
    smaller one drops the batch's own older fixes); TSA1, w = 6, K = 8, 4
    subtrajectories a trajectory (the service's default)."""
    import numpy as np
    from repro_torch.stream import StreamConfig
    t = batch.t[batch.valid].cpu().numpy()
    span = float(np.float64(t.max()) - np.float64(t.min()))
    return StreamConfig(t_cap=t_cap, m_cap=batch.max_points,
                        eps_sp=params.eps_sp, eps_t=params.eps_t,
                        alpha_abs=alpha, k_abs=k,
                        allowed_lateness=(batch_span(records)
                                          + 2.0 * params.eps_t),
                        horizon=span, k=8, w=6, segmentation="tsa1", **kw)


def stream_oracle(drv, what: str):
    """The standing lists, spill and labels bitwise ``run_dsc`` over the
    window with the materialize top-K kernel plan (K1 joins the window as
    the delta join does), ``sim_topk=K``, ``on_overflow="degrade"``."""
    from repro_torch.core.dsc import run_dsc
    K = drv.config.k
    plan = kernel_plan("materialize_topk").replace(sim_topk=K)
    t0 = time.perf_counter()
    out = run_dsc(drv.window_batch(), drv.config.params, plan=plan,
                  on_overflow="degrade", device=drv.device)
    out.join = None
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    diffs = [f for f, got in (("ids", drv.standing_ids[:, :K]),
                              ("sims", drv.standing_sims[:, :K]),
                              ("spill", drv.standing_sims[:, K]))
             if not torch.equal(getattr(out.sim_topk, f), got)]
    diffs += [f for f in ("member_of", "member_sim", "is_rep", "is_outlier")
              if not torch.equal(getattr(out.result, f), getattr(drv, f))]
    check(not diffs, f"stream ({what}): {diffs} not bitwise the batch "
                     "oracle's")
    reps = int(out.result.is_rep.sum())
    del out
    torch.cuda.empty_cache()
    return oracle_s, reps


def k1_delta_check(drv, rows, what: str):
    """The cube's rows and columns ``rows`` bitwise K1's plain twin under
    the rows' bbox pair mask (the masked plain delta join)."""
    import numpy as np
    from repro_torch.core.types import TrajectoryBatch
    from repro_torch.index.grid import exact_pair_mask
    from repro_torch.kernels.stjoin.ops import _flat_operands
    from repro_torch.kernels.stjoin.ref import stjoin_ref
    c = drv.config
    win = drv.window_batch()
    mask = exact_pair_mask(drv._boxes(rows), drv._boxes(),
                           np.float32(c.eps_sp), np.float32(c.eps_t))
    r = torch.from_numpy(rows).to(drv.device)
    sub = TrajectoryBatch(x=win.x[r], y=win.y[r], t=win.t[r],
                          valid=win.valid[r], traj_id=win.traj_id[r])
    for ref, cand, m, got in (
            (sub, win, mask, (drv.cube_w[r], drv.cube_idx[r])),
            (win, sub, mask.T, (drv.cube_w[:, :, r], drv.cube_idx[:, :, r]))):
        ops = _flat_operands(ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
                             cand.x, cand.y, cand.t, cand.valid,
                             cand.traj_id)
        w, i = stjoin_ref(*ops[0], *ops[1], c.eps_sp, c.eps_t,
                          pair_mask=m.repeat_interleave(c.m_cap, dim=0))
        check(torch.equal(w.view(got[0].shape), got[0])
              and torch.equal(i.view(got[1].shape), got[1]),
              f"stream ({what}): the K1 delta join differs from the "
              "masked plain join")
        del w, i


def stream_thresholds(batch, cfg):
    """Absolute thresholds for the stream: the ``alpha_used`` and
    ``k_used`` of a batch run over the same data with the stream's
    parameters and the library's default thresholds (the mean similarity
    and the mean voting; dsc_brest's -1 sigma gives a negative alpha,
    which a stream refuses).  The fused kernel plan; not a counted run."""
    from repro_torch.core.dsc import run_dsc
    p = cfg.params.replace(alpha_abs=-1.0, k_abs=-1.0)
    out = run_dsc(batch, p, plan=kernel_plan("fused"), device=batch.device)
    alpha, k = float(out.result.alpha_used), float(out.result.k_used)
    del out
    torch.cuda.empty_cache()
    return alpha, k


def phase_stream(dev, report):
    """The streaming service at full width: the 4,096 dsc_brest vessels
    (T = 4096, M = 128, the cube [T, M, T] on the card) submitted in time
    order, 32,768 fixes a batch, one advance a batch, absolute thresholds
    from ``stream_thresholds``.  Launch counts zeroed before each advance
    and read after it: K1 and K9 each advance, K8 in the run, nothing
    else.  At least 99% of the fixes admitted.  At one advance in the middle and at the
    last, the standing lists, spill and labels bitwise the batch oracle;
    at the first advance with at least 64 dirty rows, 64 of them held
    against the masked plain join; the books balance.  Returns the
    thresholds."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.data.synthetic import stream_records
    from repro_torch.serve.stream import StreamService
    batch, params = brest_batch(4096, dev)
    records = stream_records(batch, batch_size=STREAM_BATCH)
    cfg = stream_config(batch, params, 0.0, 0.0, batch.num_trajs, records,
                        queue_cap=STREAM_BATCH)
    alpha, k = stream_thresholds(batch, cfg)
    cfg = dataclasses.replace(cfg, alpha_abs=alpha, k_abs=k).validate()
    n_fix = sum(r.n for r in records)
    log(f"stream (dsc_brest): T={cfg.t_cap} M={cfg.m_cap} "
        f"S={cfg.t_cap * cfg.max_subs} K={cfg.k} {n_fix} fixes in "
        f"{len(records)} batches of {STREAM_BATCH}; eps_sp={cfg.eps_sp:.6g} "
        f"eps_t={cfg.eps_t:.6g} alpha_abs={cfg.alpha_abs:.6g} "
        f"k_abs={cfg.k_abs:.6g} horizon={cfg.horizon:.6g} "
        f"allowed_lateness={cfg.allowed_lateness:.6g}")
    del batch
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    svc = StreamService(cfg, device=dev)
    drv = svc.driver
    dirty_of = {}
    real_join = drv._delta_join

    def delta_join(D, win):
        dirty_of[drv.advance_count] = D
        return real_join(D, win)

    drv._delta_join = delta_join
    mid = len(records) // 2
    per_adv, peak, checked_rows, oracles, scans = [], 0, None, {}, 0
    for i, recs in enumerate(records):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        drv.submit(recs)
        summary = drv.advance()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        check(STREAM_NEED <= set(launches) <= STREAM_KERNELS,
              f"stream advance {i} launched {launches}")
        scans += launches.get("topk_round_scan", 0)
        per_adv.append(dict(ms=ms, dirty_rows=summary["dirty_rows"],
                            sim_rows=summary["sim_rows"],
                            pass2_rows=summary["pass2_rows"],
                            rounds=summary["rounds"],
                            warm_prefix=summary["warm_prefix"],
                            k1_launches=launches.get("stjoin_best_match", 0),
                            launches=launches, reps=summary["reps"]))
        log(f"stream advance {i}: ms={ms:.1f} dirty_rows="
            f"{summary['dirty_rows']} sim_rows={summary['sim_rows']} "
            f"pass2_rows={summary['pass2_rows']} launches={launches} "
            f"rounds={summary['rounds']} "
            f"warm_prefix={summary['warm_prefix']} reps={summary['reps']}")
        if checked_rows is None and summary["dirty_rows"] >= 64:
            checked_rows = dirty_of[i][:64]
            k1_delta_check(drv, checked_rows, f"advance {i}")
        if i in (mid, len(records) - 1):
            oracles[i] = stream_oracle(drv, f"advance {i}")
    acc = svc.accounting()
    check(acc["balanced"], f"stream: books do not balance {acc}")
    check(scans > 0, "stream: no advance launched topk_round_scan")
    check(acc["inserted"] >= 0.99 * n_fix,
          f"stream: {acc['inserted']} of {n_fix} fixes admitted")
    check(checked_rows is not None, "stream: no advance had 64 dirty rows")
    check(peak < 60e9, f"stream: peak {peak / 1e9:.3f} GB over 60 GB")
    ms_all = [a["ms"] for a in per_adv]
    log(f"stream (dsc_brest): {len(per_adv)} advances, ms per advance mean "
        f"{sum(ms_all) / len(ms_all):.1f} min {min(ms_all):.1f} max "
        f"{max(ms_all):.1f}; K1 launches "
        f"{sum(a['k1_launches'] for a in per_adv)}; peak_alloc_GB="
        f"{peak / 1e9:.3f} (the cube 17.18); lists and labels bitwise the "
        f"batch oracle at advances {sorted(oracles)} (oracle s "
        f"{', '.join(f'{s:.2f}' for s, _ in oracles.values())}); the K1 "
        f"delta join of 64 dirty rows bitwise the masked plain join; "
        f"books balance ({acc['inserted']} of {n_fix} fixes inserted, "
        f"{acc['late_dropped']} late)")
    report["stream_dsc_brest"] = dict(advances=per_adv, peak_alloc_bytes=peak,
                                      accounting=acc, fixes=n_fix,
                                      alpha_abs=alpha, k_abs=k,
                                      oracle_s={str(a): v[0] for a, v in
                                                oracles.items()})
    del svc, drv, delta_join, real_join
    gc.collect()        # the instrumented driver refers to itself
    torch.cuda.empty_cache()
    return alpha, k


def stream_state(drv) -> dict:
    """The service's state that a resume must reproduce."""
    out = {f: getattr(drv, f).clone() for f in (
        "standing_ids", "standing_sims", "member_of", "member_sim",
        "is_rep", "is_outlier", "cube_w", "cube_idx", "sub_local", "vote")}
    out["store"] = [a.copy() for a in (drv.xs, drv.ys, drv.ts, drv.valid)]
    out["stats"] = drv.stats()
    return out


def phase_stream_resume(dev, report, alpha, k):
    """Kill and resume at T = ``RESUME_T_CAP`` (the first 512 dsc_brest
    vessels; a snapshot holds a 0.27 GB cube): a service with a snapshot every 3
    advances crashes entering advance 3, a new one resumes from the
    snapshot and finishes; its state (cube, lists, labels, store, books)
    equals an uninterrupted run's bitwise."""
    import shutil
    import tempfile
    from repro_torch.core.types import TrajectoryBatch
    from repro_torch.data.synthetic import stream_records
    from repro_torch.run import FaultInjector, FaultPlan, InjectedCrash
    from repro_torch.serve.stream import StreamService
    full, params = brest_batch(4096, dev)
    n = RESUME_T_CAP
    batch = TrajectoryBatch(x=full.x[:n], y=full.y[:n], t=full.t[:n],
                            valid=full.valid[:n], traj_id=full.traj_id[:n])
    records = stream_records(batch, batch_size=RESUME_BATCH)
    cfg = stream_config(batch, params, alpha, k, n, records,
                        queue_cap=RESUME_BATCH, snapshot_every=3)
    del full, batch
    t0 = time.perf_counter()
    ref = StreamService(cfg, device=dev)
    ref.run(records)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    want = stream_state(ref.driver)
    del ref
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_stream_"))
    log(f"stream kill and resume (T={n}): {len(records)} batches of "
        f"{RESUME_BATCH}; snapshots under a temporary directory, "
        f"{free_disk(root)}")
    try:
        with recorded_saves() as (writes, _):
            svc = StreamService(cfg, checkpoint_dir=str(root), device=dev,
                                injector=FaultInjector(
                                    FaultPlan(crash_at_advance=3)))
            try:
                svc.run(records)
                check(False, "stream: the crash at advance 3 did not raise")
            except InjectedCrash:
                pass
            del svc
            t0 = time.perf_counter()
            svc = StreamService(cfg, checkpoint_dir=str(root), device=dev)
            resumed_at = svc.driver.advance_count
            svc.run(records)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
        check(svc.resumed and resumed_at == 3,
              f"stream: resumed={svc.resumed} at advance {resumed_at}")
        got = stream_state(svc.driver)
        diffs = [k for k, v in want.items() if not (
            torch.equal(v, got[k]) if torch.is_tensor(v) else
            all((a == b).all() for a, b in zip(v, got[k]))
            if isinstance(v, list) else v == got[k])]
        check(not diffs, f"stream resume: {diffs} differ from the "
                         "uninterrupted run")
        snap_b = [b for _, b, _ in writes]
        snap_s = [s for _, _, s in writes]
        log(f"stream kill and resume (T={n}): uninterrupted run s="
            f"{ref_s:.3f}; resumed at advance 3, resumed run s="
            f"{resume_s:.3f}; state bitwise the uninterrupted run's; "
            f"{len(writes)} snapshots of {max(snap_b) / 1e9:.3f} GB, s per "
            f"snapshot mean {sum(snap_s) / len(snap_s):.3f}")
        report["stream_resume"] = dict(
            uninterrupted_s=ref_s, resume_s=resume_s, snapshots=len(writes),
            snapshot_bytes=snap_b, snapshot_s=snap_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_launcher_exits(dev, report):
    """The launcher in this process at its default size (dsc_synth) on the
    card: ``--stream --resume-dir`` (exit 0, the books balance), the
    ``{"crash_at": "cluster"}`` fault plan (exit 6) then the resume (exit
    0, labels bitwise a plain launcher run's), ``--on-overflow raise``
    (3), ``--on-dirty fail`` with a poison record (7) and ``--backpressure
    block --queue-cap 10`` (8)."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.launch import run_dsc as launcher
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_launcher_"))

    def run(argv):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            out, code = launcher.main(argv), 0
        except SystemExit as e:
            out, code = None, e.code
        torch.cuda.synchronize()
        return code, out, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    try:
        for name, plan in (("crash", {"crash_at": "cluster"}),
                           ("poison", {"stream_poison": [[1, 3]]})):
            (root / f"{name}.json").write_text(json.dumps(plan))
        cases = [
            ("stream", ["--stream", "--resume-dir", str(root / "svc")], 0),
            ("crash", ["--resume-dir", str(root / "ck"), "--fault-plan",
                       str(root / "crash.json")], 6),
            ("resume", ["--resume-dir", str(root / "ck")], 0),
            ("overflow", ["--sim-mode", "topk", "--sim-topk", "2",
                          "--on-overflow", "raise"], 3),
            ("poison", ["--stream", "--on-dirty", "fail", "--fault-plan",
                        str(root / "poison.json")], 7),
            ("backpressure", ["--stream", "--backpressure", "block",
                              "--queue-cap", "10"], 8)]
        _, plain, _, _ = run([])
        rows = {}
        for name, argv, want in cases:
            code, out, s, launches = run(argv)
            check(code == want, f"launcher ({name}): exit {code}, expected "
                                f"{want}")
            if name == "stream":
                check(launches.get("stjoin_best_match", 0) > 0,
                      "launcher --stream launched no K1")
            if name == "resume":
                for f in LABELS:
                    check(torch.equal(getattr(out.result, f),
                                      getattr(plain.result, f)),
                          f"launcher resume: {f} differs from a plain run")
            rows[name] = dict(argv=argv, exit=code, wall_s=s,
                              launches={k: n for k, n in launches.items()
                                        if n})
            log(f"launcher ({name}): {' '.join(argv)} -> exit {code} in "
                f"{s:.3f} s")
        report["launcher_exits"] = rows
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# The plan autotuner (repro_torch.tune) on the card
# ---------------------------------------------------------------------------

# the kernels each sweep launches, and no other (the counts are zeroed just
# before a sweep and read just after)
TUNE_KERNELS = {
    "join": {"chunk_time_bounds", "stjoin_best_match", "stjoin_vote_fused",
             "stjoin_sim_fused", "jaccard_window", "sim_row_moments",
             "round_scan", "claim_max"},
    "cluster": {"sim_row_moments", "round_scan", "claim_max"},
    "pipeline": {"chunk_time_bounds", "stjoin_best_match",
                 "stjoin_vote_fused", "stjoin_sim_fused", "jaccard_window",
                 "sim_row_moments", "round_scan", "claim_max"},
    "panel": PATH_KERNELS["fused_topk"],
}
TUNE_ITERS = 3
# the top-K panel heights swept at dsc_brest (K = 4,096, the main fused
# top-K run's final K): every one a divisor of S = 32,768
TUNE_PANELS = (128, 256, 512, 1024, 2048)
TUNE_K = 4096


def plan_delta(plan, base) -> str:
    """The fields where ``plan`` differs from ``base``."""
    b = base.to_dict()
    d = {k: v for k, v in plan.to_dict().items() if v != b[k]}
    return ", ".join(f"{k}={v}" for k, v in d.items()) or "base"


def log_sweep(name: str, res, card: str, extra=None) -> list:
    """One line a candidate (its wall, interface bytes and the allocation
    peak of its timed calls), then the winner; the rows for the report."""
    base = res.candidates[0].plan
    rows = []
    for i, c in enumerate(res.candidates):
        more = "" if extra is None else f"; {extra[i]}"
        log(f"  tune {name} [{i}] {plan_delta(c.plan, base)}: wall "
            f"ms={c.wall_s * 1e3:.3f} interface MB="
            f"{c.peak_interface_bytes / 1e6:.3f} peak GB="
            f"{c.peak_buffer_bytes / 1e9:.3f} verified={c.verified}{more}")
        rows.append(c.to_dict())
    w = res.candidates.index(res.winner)
    log(f"tune {name} ({card}): bucket {res.bucket}, "
        f"{sum(c.verified for c in res.candidates)} / {len(res.candidates)} "
        f"verified, winner [{w}] {plan_delta(res.winner.plan, base)}")
    return rows


def tune_launched(name: str, launches: dict):
    ran = {k for k, n in launches.items() if n > 0}
    check(ran == TUNE_KERNELS[name],
          f"tune {name}: launched {sorted(ran)}, expected "
          f"{sorted(TUNE_KERNELS[name])}")


def all_verified(name: str, res, n: int):
    check(len(res.candidates) == n
          and all(c.verified for c in res.candidates),
          f"tune {name}: {[c.note for c in res.candidates]} "
          f"({len(res.candidates)} candidates, expected {n})")


def tune_comm_rank(sizes):
    """``tune_comm`` on this rank of a ``sizes`` mesh at T = 512 (the
    materialize kernel plan, allgather), launch counts zeroed just before
    it and read just after."""
    from repro_torch import kernels
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.tune.autotune import tune_comm
    _, params, parts = dist_data(512, sizes[0])
    base = kernel_plan("materialize").replace(sim_strategy="allgather")
    kernels.reset_launch_counts()
    res = tune_comm(parts, params, Mesh(sizes, "gloo", "cuda"), base=base)
    return res, dict(kernels.LAUNCHES)


def phase_tune(dev, report, card: str):
    """The autotuner's sweeps on the card: the join and cluster sweeps at
    dsc_brest, the whole pipeline at T = 1024 through a plan store, the
    top-K panel height at dsc_brest, the comm schedules on a (2, 2)
    mesh."""
    import dataclasses
    import tempfile
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc, run_dsc_lowerable
    from repro_torch.core.plan import EnginePlan
    from repro_torch.distributed.mesh import Mesh, spawn
    from repro_torch.tune.autotune import (PlanStore, measure_call,
                                           shape_bucket, sweep,
                                           tune_cluster_tiles, tune_join,
                                           tune_pipeline)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = report["tune"] = {"card": card}

    # 1. the join sweep at dsc_brest: the materialize kernel plan (the
    # oracle and candidate 0) against seven fused rows
    batch, params = brest_batch(4096, dev)
    base = kernel_plan("materialize")
    oracle = run_dsc_lowerable(batch, params, base, device=dev)
    oracle = dataclasses.replace(oracle, join=None)     # the 17.2 GB cube
    check(dist_counts(oracle) == "clusters=8 members=7430 outliers=552",
          f"tune join oracle: {dist_counts(oracle)}")
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    res = tune_join(batch, params, base=base, iters=TUNE_ITERS,
                    oracle=oracle, device=dev)
    launches = dict(kernels.LAUNCHES)
    tune_launched("join", launches)
    all_verified("join", res, 8)
    out["join"] = dict(s=time.perf_counter() - t0, launches=launches,
                       candidates=log_sweep("join (dsc_brest T=4096)", res,
                                            card))
    log(f"tune join: labels {dist_counts(oracle)}; the sweep "
        f"{out['join']['s']:.1f} s")

    # 2. the cluster sweep on that oracle's [S, S] and table: the plain
    # round engine (candidate 0) beside K5 / K6 (candidates 1-5)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    res = tune_cluster_tiles(oracle.sim, oracle.table, params,
                             base=EnginePlan(), iters=TUNE_ITERS,
                             device=dev)
    launches = dict(kernels.LAUNCHES)
    tune_launched("cluster", launches)
    all_verified("cluster", res, 6)
    check(not res.candidates[0].plan.cluster_use_kernel
          and all(c.plan.cluster_use_kernel for c in res.candidates[1:]),
          "tune cluster: candidate 0 is not the plain engine")
    out["cluster"] = dict(s=time.perf_counter() - t0, launches=launches,
                          candidates=log_sweep("cluster (dsc_brest "
                                               "S=32768)", res, card))
    del oracle, res
    torch.cuda.empty_cache()

    # 3. the whole pipeline at T = 1024 through a plan store file
    b1, p1 = brest_batch(1024, dev)
    pbase = kernel_plan("fused")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "plans.json")
        store = PlanStore(path)
        kernels.reset_launch_counts()
        tuned, results = tune_pipeline(b1, p1, base=pbase, store=store,
                                       device=dev)
        launches = dict(kernels.LAUNCHES)
        store.save()
        again = PlanStore(path)
        got = {stage: again.get(stage, r.bucket)
               for stage, r in results.items()}
    tune_launched("pipeline", launches)
    # the base plan already runs the cluster kernels: 5 cluster candidates
    for stage, n in (("join", 8), ("cluster", 5), ("similarity", 4)):
        all_verified(f"pipeline {stage}", results[stage], n)
        check(got[stage] == results[stage].winner.plan,
              f"tune pipeline: the reloaded store's {stage} plan is not "
              "the winner")
    merged = got["join"].replace(
        cluster_engine=got["cluster"].cluster_engine,
        cluster_use_kernel=got["cluster"].cluster_use_kernel,
        cluster_bu=got["cluster"].cluster_bu,
        cluster_bs=got["cluster"].cluster_bs,
        sim_panel=got["similarity"].sim_panel)
    check(merged == tuned, f"tune pipeline: the reloaded store merges to "
                           f"{merged}, not {tuned}")
    s = time.perf_counter() - t0
    same_labels(run_dsc(b1, p1, plan=tuned, device=dev),
                run_dsc(b1, p1, plan=pbase, device=dev),
                "tune pipeline: the merged plan against the base plan")
    out["pipeline"] = dict(s=s, launches=launches, tuned=tuned.to_dict(),
                           stages={k: log_sweep(f"pipeline {k} (T=1024)", r,
                                                card)
                                   for k, r in results.items()})
    log(f"tune pipeline (T=1024; {card}): {s:.1f} s; the store reloads to "
        f"the merged plan ({plan_delta(tuned, pbase)}); its labels equal "
        "the base plan's")
    del b1, results
    torch.cuda.empty_cache()

    # 4. the top-K panel height at dsc_brest, K = 4,096, through the public
    # sweep: every Sb bitwise Sb = 128 (lists, spill, moments, labels)
    S = batch.num_trajs * params.max_subtrajs_per_traj
    cands = [kernel_plan("fused_topk").replace(sim_topk=TUNE_K, sim_panel=sb)
             for sb in TUNE_PANELS]
    want = run_dsc_lowerable(batch, params, cands[0], device=dev)
    check(int(want.sim_overflow) == 0 and want.sim_topk.k == TUNE_K,
          "tune panel: the certificate fails at K = 4096")
    k7 = "stjoin_sim_panel_fused"
    per_call = {}

    def measure(plan):
        before = kernels.LAUNCHES[k7]
        got = measure_call(
            lambda b: run_dsc_lowerable(b, params, plan, device=dev),
            (batch,), iters=TUNE_ITERS, device=dev)
        per_call[plan.sim_panel] = ((kernels.LAUNCHES[k7] - before)
                                    / (TUNE_ITERS + 1))
        return got

    def verify(o, plan):
        return (not diff_fields(o.sim_topk, want.sim_topk)
                and all(torch.equal(getattr(o.result, f),
                                    getattr(want.result, f))
                        for f in LABELS))

    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    res = sweep("similarity", shape_bucket(S=S, K=TUNE_K), cands, measure,
                verify)
    launches = dict(kernels.LAUNCHES)
    tune_launched("panel", launches)
    all_verified("panel", res, len(TUNE_PANELS))
    for sb in TUNE_PANELS:
        check(per_call[sb] == S // sb, f"tune panel Sb={sb}: "
                                       f"{per_call[sb]} K7 launches a call")
    out["panel"] = dict(
        s=time.perf_counter() - t0, launches=launches, k7_per_call=per_call,
        candidates=log_sweep(
            "panel (dsc_brest S=32768 K=4096)", res, card,
            [f"K7 launches a call {per_call[sb]:.0f}" for sb in TUNE_PANELS]))
    log(f"tune panel: Sb {', '.join(map(str, TUNE_PANELS))} bitwise Sb = "
        f"128 (lists, spill, moments, labels {dist_counts(want)})")
    del batch, want, res
    torch.cuda.empty_cache()

    # 5. the comm schedules on a (2, 2) mesh of four gloo ranks at T = 512
    t0 = time.perf_counter()
    ranks = spawn(tune_comm_rank, Mesh((2, 2), "gloo", "cuda"), (2, 2),
                  timeout=600)
    r0 = ranks[0][0]
    for r, (res, launches) in enumerate(ranks):
        all_verified(f"comm rank {r}", res, 4)
        ran = {k for k, n in launches.items() if n > 0}
        check(ran == DIST_KERNELS["materialize"],
              f"tune comm rank {r}: launched {sorted(ran)}")
        check(res.winner.plan == r0.winner.plan
              and [c.wall_s for c in res.candidates]
              == [c.wall_s for c in r0.candidates],
              f"tune comm rank {r}: another winner or walls than rank 0")
    out["comm"] = dict(s=time.perf_counter() - t0,
                       candidates=log_sweep("comm (mesh 2x2, T=512)", r0,
                                            card))
    log("tune comm: every rank named the same winner, on the same agreed "
        "walls")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tune phase ({card}): wall s={out['phase_s']:.1f}")


# ---------------------------------------------------------------------------
# The multi-device program: a (part, model) mesh of four ranks on this one
# card, gloo with host staging
# ---------------------------------------------------------------------------

# the kernels each distributed path launches on every rank, and no other
# (every kernel path's row moments of its column block, one a similarity
# pass)
DIST_KERNELS = {
    "fused_topk": {"chunk_time_bounds", "stjoin_vote_fused",
                   "stjoin_sim_fused", "jaccard_window", "sim_row_moments",
                   "topk_round_scan", "topk_claim_max"},
    "fused": {"chunk_time_bounds", "stjoin_vote_fused", "stjoin_sim_fused",
              "jaccard_window", "sim_row_moments", "round_scan",
              "claim_max"},
    "materialize": {"chunk_time_bounds", "stjoin_best_match",
                    "jaccard_window", "sim_row_moments", "round_scan",
                    "claim_max"},
    "plain": set(),
}
RINGS = dict(halo_stream="ring", sim_exchange="ring")
# job -> (vessels, path, plan fields beyond the path's, on_overflow, the
# kernels whose calls the run records for the checks after it); the main
# run at dsc_brest, then again recording its kernels' operands, the dense
# case there (K5, K6), the variants at T = 512 (K1 in mat_512) and the
# plain plan at T = 512 (from K = 32 with widen, as topk_512; at dsc_brest
# its plain join alone took 79 s a rank)
DIST_JOBS = {
    "main": (4096, "fused_topk", dict(sim_topk=32), "widen", ()),
    "main_again": (4096, "fused_topk", dict(sim_topk=32), "widen",
                   ("chunk_time_bounds", "stjoin_vote_fused",
                    "jaccard_window", "stjoin_sim_fused", "topk_round_scan",
                    "topk_claim_max")),
    "dense": (4096, "fused", {}, "raise", ("sim_row_moments", "round_scan",
                                         "claim_max")),
    "topk_512": (512, "fused_topk", dict(sim_topk=32), "widen", ()),
    "topk_512_ring": (512, "fused_topk", dict(sim_topk=32, **RINGS),
                      "widen", ()),
    "topk_512_k32": (512, "fused_topk", dict(sim_topk=32), "degrade", ()),
    "mat_512": (512, "materialize", {}, "raise", ("stjoin_best_match",)),
    "mat_512_allgather": (512, "materialize",
                          dict(sim_strategy="allgather"), "raise", ()),
    "mat_512_ring": (512, "materialize",
                     dict(sim_strategy="allgather", **RINGS), "raise", ()),
    "plain_512": (512, "plain", dict(sim_mode="topk", sim_topk=32),
                  "widen", ()),
}
DIST_LABELS = ("member_of", "member_sim", "is_rep", "is_outlier")
# the partition rows at which K2 and K4 are held against their plain
# versions: DIST_BLOCKS blocks of DIST_BLOCK_ROWS rows spread from the
# first row to the last, shifted by the rank (the plain versions take
# about 19 ms a row each at dsc_brest)
DIST_BLOCKS, DIST_BLOCK_ROWS = 8, 16


def dist_plan(path: str, extra: dict):
    from repro_torch.core.plan import EnginePlan
    if path == "plain":
        return EnginePlan(**extra)
    return kernel_plan(path).replace(**extra)


def dist_data(n_vessels: int, P: int):
    """``brest_batch(n_vessels)`` on the host, cut into P partitions."""
    from repro_torch.core.partitioning import partition_batch
    batch, params = brest_batch(n_vessels, "cpu")
    return batch, params, partition_batch(batch, P)


def dist_rows(T: int, rank: int) -> torch.Tensor:
    """The checked partition rows of ``rank`` (``DIST_BLOCKS``)."""
    n = DIST_BLOCK_ROWS
    starts = [min(i * (T - n) // (DIST_BLOCKS - 1) + rank * n, T - n)
              for i in range(DIST_BLOCKS)]
    rows = torch.cat([torch.arange(a, a + n) for a in starts]).unique()
    return rows.cuda()


# kernel -> (module, wrapper) as the program's callers import it at each
# call
def dist_wrappers():
    from repro_torch.kernels.cluster import ops as cops
    from repro_torch.kernels.jaccard import ops as jops
    from repro_torch.kernels.stjoin import ops as sops
    return {"chunk_time_bounds": (sops, "chunk_time_bounds"),
            "stjoin_best_match": (sops, "stjoin_best_match"),
            "stjoin_vote_fused": (sops, "stjoin_vote_fused_arrays"),
            "stjoin_sim_fused": (sops, "stjoin_sim_fused_arrays"),
            "jaccard_window": (jops, "window_jaccard"),
            "round_scan": (cops, "cluster_round_scan"),
            "claim_max": (cops, "cluster_assign"),
            "topk_round_scan": (cops, "topk_cluster_round_scan"),
            "topk_claim_max": (cops, "topk_cluster_assign"),
            "sim_row_moments": (cops, "sim_row_moments")}


@contextlib.contextmanager
def recorded_program(names, rows):
    """Yields ``rec``: for each kernel of ``names``, the list of its
    wrapper's calls in the run (operands and outputs), kept by wrapping
    the wrapper at its module, which the program's callers import at each
    call; every call still launches its kernel through the real wrapper,
    counted as before.  Operands are cloned on the card, except: K4 keeps
    its first call and, of its ``[S, S_loc]`` output, the slots of the
    partition ``rows``; K8 and K9 keep their ``[S, K]`` lists on the host,
    once a dispatch (``rec["lists"]``); K5 and K6 keep a reference to
    ``sim`` (the run does not write it after it is built); K16 keeps a
    reference to its first call's column block (which the run does not
    write either) and every call's outputs: each similarity pass of a run
    builds the same block, so the first call's operands stand for every
    call."""
    import weakref
    wrappers = dist_wrappers()
    rec = {n: [] for n in names}
    rec["lists"] = []
    cur = [None]                    # the current dispatch's ids
    cl = lambda v: v.clone() if torch.is_tensor(v) else v

    def dispatch(ids, sims):
        if cur[0] is None or cur[0]() is not ids:
            rec["lists"].append((ids.cpu(), sims.cpu()))
            cur[0] = weakref.ref(ids)
        return len(rec["lists"]) - 1

    def keep(name, a, kw, out):
        outs = out if isinstance(out, tuple) else (out,)
        if name == "stjoin_sim_fused":
            if rec[name]:
                return
            T, S_loc = a[0].shape[0], a[13]
            ms = a[12] // T
            rec[name].append(dict(args=[cl(v) for v in a], kw=kw,
                                  rows=out.view(T, ms, S_loc)[rows].clone()))
            return
        if name in ("topk_round_scan", "topk_claim_max"):
            rec[name].append(dict(d=dispatch(a[0], a[1]),
                                  args=[cl(v) for v in a[2:]],
                                  out=[cl(o) for o in outs]))
            return
        if name == "sim_row_moments":
            rec[name].append(dict(
                args=None if rec[name] else [a[0], *(cl(v) for v in a[1:])],
                out=[cl(o) for o in outs]))
            return
        if name in ("round_scan", "claim_max"):
            check(not rec[name] or rec[name][0]["args"][0] is a[0],
                  f"{name}: the run's calls read more than one sim")
            rec[name].append(dict(args=[a[0], *(cl(v) for v in a[1:])],
                                  out=[cl(o) for o in outs]))
            return
        rec[name].append(dict(args=[cl(v) for v in a], kw=dict(kw),
                              out=[cl(o) for o in outs]))

    def wrap(name, real):
        def record(*a, **kw):
            out = real(*a, **kw)
            keep(name, a, kw, out)
            return out
        return record

    reals = {n: getattr(*wrappers[n]) for n in names}
    for n in names:
        setattr(wrappers[n][0], wrappers[n][1], wrap(n, reals[n]))
    try:
        yield rec
    finally:
        for n in names:
            setattr(wrappers[n][0], wrappers[n][1], reals[n])


def dist_job(name, parts, params, mesh, plan, on_overflow, record=()):
    """One run of the program on this rank, with its launches, phase
    times (CUDA events), collectives, wall and peak allocation; with
    ``record``, the calls of those kernels (``recorded_program``) under
    ``"rec"``."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.distributed import run_dsc_distributed
    from repro_torch.distributed.mesh import current
    comm = current()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = dist_rows(parts.x.shape[1], comm.rank)
    times = {}
    with (recorded_program(record, rows) if record
          else contextlib.nullcontext(None)) as rec:
        dist.barrier()
        kernels.reset_launch_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        out = run_dsc_distributed(parts, params, mesh, plan=plan,
                                  on_overflow=on_overflow, stage_times=times)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    if comm.rank == 0:
        log(f"  distributed {name} (rank 0): wall s={wall:.3f}; " + ", ".join(
            f"{k}={v:.1f}" for k, v in times.items()) + " ms")
    return dict(out=out, launches=launches, stats=dict(comm.stats),
                times=times, wall=wall, rec=rec, rows=rows,
                peak=torch.cuda.max_memory_allocated() - base)


def dist_chain(parts, params, mesh, plan):
    """The five stage functions of ``build_dsc_stage_programs`` in order,
    with the launches they make."""
    from repro_torch import kernels
    from repro_torch.core.distributed import (DistributedDSCOutput,
                                              build_dsc_stage_programs)
    kernels.reset_launch_counts()
    st = build_dsc_stage_programs(parts, params, mesh, plan=plan)
    pts = (parts.x, parts.y, parts.t, parts.valid, parts.traj_id,
           parts.ranges)
    j = st["join"](*pts)
    table, labels = st["segment"](parts.t, parts.valid, j[0], j[1])
    sim = st["similarity"](*pts, labels, table, *j[2:])
    c = st["cluster"](table, sim[-1], *sim[:-1])
    final = st["refine"](c[0], c[1], c[2], sim[-1], c[4], c[5])
    return DistributedDSCOutput(result=final, table=table, vote=j[0],
                                active=sim[-1], sim_diag=c[6]), \
        dict(kernels.LAUNCHES)


def timed_once(fn):
    """``(ms, fn())`` of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def same_bits(got, want) -> bool:
    got = got if isinstance(got, (tuple, list)) else (got,)
    return len(got) == len(want) and all(
        (g is None and w is None) or (g is not None and w is not None
                                      and torch.equal(g, w))
        for g, w in zip(got, want))


def dist_check_calls(name, calls, kernel, plain, job):
    """Every recorded call of ``name``: its wrapper on the call's operands
    again gives the run's outputs bit for bit, and so does ``plain`` on
    the same operands.  Times the first call's kernel and plain version.
    Returns the kernel's row for the parent."""
    ms = plain_ms = None
    for i, c in enumerate(calls):
        check(same_bits(kernel(c), c["out"]),
              f"distributed {job}: {name} call {i} not bitwise on rerun")
        p_ms, p = timed_once(lambda: plain(c))
        check(same_bits(p, c["out"]),
              f"distributed {job}: {name} call {i} not bitwise its plain "
              "version")
        if i == 0:
            ms, plain_ms = time_ms(lambda: kernel(c), reps=3), p_ms
    shape = [tuple(v.shape) for v in calls[0]["args"] if torch.is_tensor(v)]
    return dict(name=name, job=job, calls=len(calls), shape=shape, ms=ms,
                plain_ms=plain_ms, rows="all")


def dist_check_lists(name, rec, kernel, plain, job):
    """K8 or K9 at every recorded call, the dispatch's ``[S, K]`` lists
    brought back to the card: bitwise on rerun and against ``plain``;
    timed at the last dispatch's first call."""
    calls, lists, on_card = rec[name], rec["lists"], {}
    last = calls[-1]["d"]
    ms = plain_ms = None
    for i, c in enumerate(calls):
        if c["d"] not in on_card:
            on_card.clear()
            on_card[c["d"]] = tuple(t.cuda() for t in lists[c["d"]])
        ids, sims = on_card[c["d"]]
        run_k = lambda: kernel(ids, sims, *c["args"])
        run_p = lambda: plain(ids, sims, *c["args"])
        check(same_bits(run_k(), c["out"]),
              f"distributed {job}: {name} call {i} not bitwise on rerun")
        check(same_bits(run_p(), c["out"]),
              f"distributed {job}: {name} call {i} (K={ids.shape[1]}) not "
              "bitwise its plain version")
        if ms is None and c["d"] == last:
            ms = time_ms(run_k, reps=5)
            plain_ms = time_ms(run_p, reps=3)
            shape = (tuple(ids.shape),)
    return dict(name=name, job=job, calls=len(calls), shape=shape, ms=ms,
                plain_ms=plain_ms, rows="all",
                dispatch_k=sorted({lists[c["d"]][0].shape[1]
                                   for c in calls}))


def dist_check_rows(name, c, rows, job):
    """K2 or K4: the wrapper again on the run's operands (the whole
    partition against the rank's candidates; bitwise the run's outputs on
    the checked rows, and timed), and the plain version on the checked
    ``rows`` against the run's outputs there: K4 with the program's slot
    maps, the rows' slots renumbered from 0."""
    from repro_torch.kernels.stjoin import ops as sops
    from repro_torch.kernels.stjoin.ref import (stjoin_sim_fused_ref,
                                                stjoin_vote_fused_ref)
    a, kw = c["args"], c["kw"]
    px, py, pt, pv, tid = a[:5]
    T, Mp = px.shape
    n = rows.numel()
    if name == "stjoin_vote_fused":
        cand, eps = a[5:10], a[10:13]
        kernel = lambda: sops.stjoin_vote_fused_arrays(*a, **kw)
        check(same_bits(kernel(), c["out"]),
              f"distributed {job}: K2 not bitwise on rerun")
        ref_ops, cand_ops = sops._flat_operands(
            px[rows], py[rows], pt[rows], pv[rows], tid[rows], *cand)
        p_ms, (vp, wp) = timed_once(lambda: stjoin_vote_fused_ref(
            *ref_ops, *cand_ops, *eps, M=Mp))
        vk, wk = c["out"]
        check(torch.equal(vk[rows].reshape(-1), vp)
              and torch.equal(wk[rows].reshape(wp.shape), wp),
              f"distributed {job}: K2 not bitwise its plain version on the "
              "checked rows")
        cells = int((vk > 0).sum())
    else:
        gid_own, cand, cid, gidc_l = a[5], a[6:10], a[10], a[11]
        S, S_loc, eps = a[12], a[13], a[14:17]
        ms_ = S // T
        kernel = lambda: sops.stjoin_sim_fused_arrays(*a, **kw)
        again = kernel().view(T, ms_, S_loc)[rows]
        check(torch.equal(again, c["rows"]),
              f"distributed {job}: K4 not bitwise on rerun")
        del again
        g = gid_own[rows]
        local = (g - rows[:, None].to(g.dtype) * ms_
                 + torch.arange(n, device=g.device, dtype=g.dtype)[:, None]
                 * ms_)
        g_l = torch.where(g < S, local, n * ms_).to(torch.int32)
        ref_ops, cand_ops = sops._flat_operands(
            px[rows], py[rows], pt[rows], pv[rows], tid[rows], *cand[:4],
            cid)
        p_ms, rp = timed_once(lambda: stjoin_sim_fused_ref(
            *ref_ops, g_l.reshape(-1), *cand_ops, gidc_l, *eps, M=Mp,
            n_src=n * ms_, n_dst=S_loc))
        check(torch.equal(rp, c["rows"].reshape(n * ms_, S_loc)),
              f"distributed {job}: K4 not bitwise its plain version on the "
              "checked rows (the program's slot maps)")
        cells = int((rp > 0).sum())
    ms = time_ms(kernel, reps=3)
    return dict(name=name, job=job, calls=1,
                shape=[(T, Mp), tuple(a[5 if name == "stjoin_vote_fused"
                                        else 6].shape)],
                ms=ms, plain_ms=p_ms, rows=n, cells=cells)


def dist_checks(job, rec, rows):
    """Each kernel that ``job`` recorded against its plain version at the
    run's own operands (``recorded_program``); K5 and K6, whose plain
    versions build several ``[S, S]`` temporaries, one rank after
    another."""
    import torch.distributed as dist
    from repro_torch.core.segmentation import tsa2_signal
    from repro_torch.distributed.mesh import current
    from repro_torch.kernels.cluster import ref as cref
    from repro_torch.kernels.stjoin import ref as sref
    from repro_torch.kernels.stjoin.ops import PANEL_CHUNK
    w = dist_wrappers()
    real = lambda n: getattr(*w[n])
    out = []
    for name in rec:
        calls = rec[name]
        if name == "lists":
            continue
        check(len(calls) > 0, f"distributed {job}: {name} recorded no call")
        if name in ("stjoin_vote_fused", "stjoin_sim_fused"):
            out.append(dist_check_rows(name, calls[0], rows, job))
        elif name in ("topk_round_scan", "topk_claim_max"):
            plain = (cref.topk_round_scan_ref if name == "topk_round_scan"
                     else cref.topk_claim_max_ref)
            out.append(dist_check_lists(name, rec, real(name), plain, job))
        elif name == "chunk_time_bounds":
            out.append(dist_check_calls(
                name, calls, lambda c: real(name)(*c["args"]),
                lambda c: sref.chunk_time_bounds(*c["args"], PANEL_CHUNK),
                job))
        elif name == "jaccard_window":
            out.append(dist_check_calls(
                name, calls, lambda c: real(name)(*c["args"], **c["kw"]),
                lambda c: tsa2_signal(torch.where(
                    c["args"][1][..., None], c["args"][0], 0), c["kw"]["w"]),
                job))
        elif name == "stjoin_best_match":
            out.append(dist_check_calls(
                name, calls, lambda c: real(name)(*c["args"]),
                lambda c: sref.stjoin_ref(*c["args"]), job))
        elif name == "sim_row_moments":
            row = dist_check_calls(
                name, calls[:1], lambda c: real(name)(*c["args"]),
                lambda c: cref.sim_row_moments_ref(*c["args"]), job)
            for i, c in enumerate(calls[1:], 1):
                check(same_bits(c["out"], calls[0]["out"]),
                      f"distributed {job}: {name} call {i}'s outputs differ "
                      "from the first's (the same block every pass)")
            out.append(dict(row, calls=len(calls)))
    dense = [n for n in ("round_scan", "claim_max") if n in rec]
    comm = current()
    for r in range(comm.mesh.size if dense else 0):
        if r == comm.rank:
            for name in dense:
                plain = (cref.round_scan_ref if name == "round_scan"
                         else cref.cluster_assign_ref)
                out.append(dist_check_calls(
                    name, rec[name], lambda c: real(name)(*c["args"]),
                    lambda c: plain(*c["args"]), job))
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def dist_rank(sizes):
    """Every job of a ``sizes`` mesh on this rank (the mesh's ranks run
    this together): the jobs of ``DIST_JOBS`` on ``(2, 2)``, each
    recording job's kernels checked right after it, then the stage chain;
    on ``(1, 2)`` the fused top-K kernel plan at T = 512 beside one-device
    ``run_dsc``."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.distributed.mesh import Mesh, current
    mesh = Mesh(sizes, "gloo", "cuda")
    current().timing = True
    res, data = {}, {}
    if sizes == (1, 2):
        batch, params, parts = dist_data(512, 1)
        plan = dist_plan("fused_topk", dict(sim_topk=32))
        res["p1_512"] = dist_job("p1_512", parts, params, mesh, plan,
                                 "widen")
        one = run_dsc(batch, params, plan=plan, device="cuda")
        res["p1_512_single"] = {f: getattr(one.result, f)
                                for f in DIST_LABELS}
        return res
    res["checks"] = []
    for name, (n, path, extra, policy, record) in DIST_JOBS.items():
        if n not in data:
            data.clear()
            data[n] = dist_data(n, sizes[0])
        _, params, parts = data[n]
        res[name] = job = dist_job(name, parts, params, mesh,
                                   dist_plan(path, extra), policy, record)
        rec = job.pop("rec")
        if record:
            res["checks"] += dist_checks(name, rec, job["rows"])
        del rec
        if name == "topk_512_k32":
            res["chain_512"], res["chain_512_launches"] = dist_chain(
                parts, params, mesh, dist_plan(path, extra))
    return res


def dist_check_output(out, T: int, Mp: int, S: int, what: str):
    """The repo's sanity conditions on a distributed output."""
    r = out.result
    check(out.vote.shape == (2, T, Mp) and bool(torch.isfinite(out.vote)
                                                .all()),
          f"{what}: vote shape or non-finite values")
    check(out.active.shape == (2, S) and out.sim_diag.shape == (2, 4)
          and bool(torch.isfinite(out.sim_diag).all()),
          f"{what}: active / sim_diag shape or values")
    check(int(out.sim_diag[:, 3].sum()) == 0, f"{what}: certificate fails")
    members = ~r.is_rep & (r.member_of >= 0)
    check(bool(r.is_rep[r.member_of[members].long()].all()),
          f"{what}: a member's owner is no rep")
    check(not bool((r.is_outlier & (r.is_rep | members)).any()),
          f"{what}: an outlier is also clustered")
    seen = out.active.any(0)
    check(bool((r.is_rep | members | r.is_outlier)[seen].all()),
          f"{what}: an active slot has no state")
    check(int(r.is_rep.sum()) > 0, f"{what}: no cluster found")


def dist_counts(out) -> str:
    r = out.result
    members = int((~r.is_rep & (r.member_of >= 0)).sum())
    return (f"clusters={int(r.is_rep.sum())} members={members} "
            f"outliers={int(r.is_outlier.sum())}")


def card_used_peak(stop, peak: list) -> None:
    """Poll the card's used memory (every process on it) until ``stop``."""
    free0, total = torch.cuda.mem_get_info(0)
    while not stop.is_set():
        free, _ = torch.cuda.mem_get_info(0)
        peak[0] = max(peak[0], total - free)
        stop.wait(0.05)


def phase_distributed(report, card: str):
    """The multi-device program on this card: mesh (2, 2) over gloo with
    host staging (four processes), then mesh (1, 2)."""
    import threading
    from repro_torch.distributed.mesh import Mesh, spawn
    torch.cuda.empty_cache()
    stop, peak = threading.Event(), [0]
    poll = threading.Thread(target=card_used_peak, args=(stop, peak))
    poll.start()
    t0 = time.perf_counter()
    try:
        ranks = spawn(dist_rank, Mesh((2, 2), "gloo", "cuda"), (2, 2),
                      timeout=900)
        p1 = spawn(dist_rank, Mesh((1, 2), "gloo", "cuda"), (1, 2),
                   timeout=300)
    finally:
        stop.set()
        poll.join()
    phase_s = time.perf_counter() - t0
    r0 = ranks[0]
    # every rank assembles the same output
    for name in DIST_JOBS:
        for r, res in enumerate(ranks[1:], 1):
            diffs = diff_fields(res[name]["out"], r0[name]["out"])
            check(not diffs, f"distributed {name}: rank {r} differs from "
                             f"rank 0 in {diffs}")
    # launches: exactly the path's kernels on every rank; the fused top-K
    # path K2 and K3 once a run, per dispatch K4 and K9 once, the chunk
    # bounds once a run and once a dispatch
    for name, (n, path, _, _, _) in DIST_JOBS.items():
        for r, res in enumerate(ranks):
            ln = res[name]["launches"]
            ran = {k for k, v in ln.items() if v > 0}
            check(ran == DIST_KERNELS[path],
                  f"distributed {name} rank {r}: launched {sorted(ran)}, "
                  f"expected {sorted(DIST_KERNELS[path])}")
            if path == "fused_topk":
                d = ln["topk_claim_max"]
                check(ln["stjoin_vote_fused"] == ln["jaccard_window"] == 1
                      and ln["stjoin_sim_fused"] == d
                      and ln["chunk_time_bounds"] == 1 + d
                      and ln["topk_round_scan"] >= d,
                      f"distributed {name} rank {r}: launches {ln}")
            # K16 once a similarity pass: K4's count on the fused paths,
            # one run's single pass on the materialize path
            if path != "plain":
                passes = ln["stjoin_sim_fused"] if path != "materialize" else 1
                check(ln["sim_row_moments"] == passes,
                      f"distributed {name} rank {r}: K16 launched "
                      f"{ln['sim_row_moments']} times for {passes} "
                      "similarity passes")
    main = r0["main"]["out"]
    T, Mp = 4096, main.vote.shape[2]
    S = T * 8
    dist_check_output(main, T, Mp, S, "distributed main")
    diffs = diff_fields(r0["main_again"]["out"], main)
    check(not diffs, f"distributed main: rerun not bitwise: {diffs}")
    for r, res in enumerate(ranks):
        check(res["main_again"]["launches"] == res["main"]["launches"],
              f"distributed main rank {r}: the recorded rerun launched "
              "otherwise")
    for a, b, fields in (
            ("plain_512", "topk_512", LABELS),
            ("dense", "main", LABELS),
            ("mat_512", "topk_512", LABELS),
            ("mat_512_allgather", "mat_512", LABELS),
            ("topk_512_ring", "topk_512", DIST_LABELS),
            ("mat_512_ring", "mat_512_allgather", DIST_LABELS)):
        for f in fields:
            check(torch.equal(getattr(r0[a]["out"].result, f),
                              getattr(r0[b]["out"].result, f)),
                  f"distributed {a} vs {b}: {f} differs")
    for r, res in enumerate(ranks):
        diffs = diff_fields(res["chain_512"], res["topk_512_k32"]["out"])
        check(not diffs, f"distributed stage chain rank {r}: {diffs} not "
                         "bitwise the monolith")
        check(res["chain_512_launches"] == res["topk_512_k32"]["launches"],
              f"distributed stage chain rank {r}: launches differ")
    for f in LABELS:
        check(torch.equal(getattr(p1[0]["p1_512"]["out"].result, f),
                          p1[0]["p1_512_single"][f]),
              f"distributed P = 1 vs run_dsc: {f} differs")
    # every kernel of the distributed paths held against its plain
    # version at the operands of a run on every rank (the ranks check and
    # fail themselves; here: that none was left out)
    every = set().union(*DIST_KERNELS.values())
    for r, res in enumerate(ranks):
        got = {c["name"] for c in res["checks"]}
        check(got == every, f"distributed rank {r}: kernels checked "
                            f"{sorted(got)}, expected {sorted(every)}")
        for c in res["checks"]:
            if c["name"] in ("stjoin_vote_fused", "stjoin_sim_fused"):
                check(c["cells"] > 0, f"distributed rank {r}: {c['name']} "
                                      "checked on rows with no match")
    log(f"distributed (gloo, 4 ranks on one card via host memory; {card}): "
        f"phase wall s={phase_s:.1f}, card used peak "
        f"GB={peak[0] / 1e9:.3f} (all processes)")
    dispatches = r0["main"]["launches"]["topk_claim_max"]
    log(f"distributed main (fused top-K, dsc_brest T={T} Mp={Mp}, mesh "
        f"2x2; {card}): dispatches={dispatches} {dist_counts(main)}; "
        f"bitwise on rerun; every rank's output equal")
    rows = {}
    for name in DIST_JOBS:
        walls = [res[name]["wall"] for res in ranks]
        peaks = [res[name]["peak"] / 1e9 for res in ranks]
        coll = [sum(v[2] for v in res[name]["stats"].values())
                for res in ranks]
        rows[name] = dict(
            wall_s=walls, peak_alloc_GB=peaks, collective_s=coll,
            phase_ms=[res[name]["times"] for res in ranks],
            collectives=[res[name]["stats"] for res in ranks],
            launches=[res[name]["launches"] for res in ranks],
            counts=dist_counts(r0[name]["out"]))
        log(f"distributed {name} ({card}): wall s per rank "
            + ", ".join(f"{w:.3f}" for w in walls)
            + "; collectives s per rank "
            + ", ".join(f"{c:.3f}" for c in coll)
            + "; peak alloc GB per rank "
            + ", ".join(f"{p:.3f}" for p in peaks)
            + f"; {rows[name]['counts']}")
    for r, res in enumerate(ranks):
        m = res["main"]
        log(f"  main rank {r} phase ms (CUDA events): " + ", ".join(
            f"{k}={v:.1f}" for k, v in m["times"].items()))
        log(f"  main rank {r} collectives (calls, MB sent, s): " + ", ".join(
            f"{k}=({v[0]}, {v[1] / 1e6:.1f}, {v[2]:.3f})"
            for k, v in sorted(m["stats"].items())))
        log(f"  main rank {r} launches: " + ", ".join(
            f"{k}={v}" for k, v in m["launches"].items() if v))
    for r, res in enumerate(ranks):
        for c in res["checks"]:
            log(f"  rank {r} {c['name']} ({c['job']}): {c['calls']} calls "
                f"at {c['shape']}, bitwise on rerun and against the plain "
                f"version (rows: {c['rows']}"
                + (f", K {c['dispatch_k']}" if "dispatch_k" in c else "")
                + f"); {c['ms']:.3f} ms, plain {c['plain_ms']:.3f} ms "
                f"({card})")
    log("distributed P = 1 (mesh 1x2, T=512): labels equal one-device "
        "run_dsc's; stage chain (T=512) bitwise the monolith, same "
        "launches; ring twins bitwise; plain plan T=512 labels equal the "
        "fused top-K kernel plan's; dense T=4096 labels equal the main "
        "run's")
    report["distributed"] = dict(card=card, phase_s=phase_s,
                                 card_used_peak_bytes=peak[0], jobs=rows,
                                 checks=[res["checks"] for res in ranks])
    phase_resilient_distributed(report, card, r0)


# ---------------------------------------------------------------------------
# The distributed resilient runner on the card
# ---------------------------------------------------------------------------

# kernels the main resume launches (the join and segment state is
# restored; each widen reruns the similarity stage, row moments included)
RDIST_RESUME_KERNELS = {"chunk_time_bounds", "stjoin_sim_fused",
                        "sim_row_moments", "topk_round_scan",
                        "topk_claim_max"}
RDIST_MAT_RECORD = ("chunk_time_bounds", "stjoin_best_match",
                    "jaccard_window", "round_scan", "claim_max")
RDIST_TOPK_RECORD = ("chunk_time_bounds", "stjoin_vote_fused",
                     "jaccard_window", "stjoin_sim_fused", "topk_round_scan",
                     "topk_claim_max")
RDIST_STAGES = ("join", "segment", "similarity", "cluster", "refine")


def rdist_run(name, parts, params, mesh, plan, record=(), **kw):
    """One ``run_resilient_distributed`` on this rank (the mesh's ranks
    run it together), with its launches (zeroed just before, read just
    after), wall, collectives, peak allocation and checkpoint saves; an
    ``InjectedCrash`` is kept as its text.  With ``record``, the calls of
    those kernels are checked against their plain versions after it."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.distributed.mesh import current
    from repro_torch.run import InjectedCrash, run_resilient_distributed
    comm = current()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = dist_rows(parts.x.shape[1], comm.rank)
    res = err = None
    with (recorded_program(record, rows) if record
          else contextlib.nullcontext(None)) as rec, \
            recorded_saves() as (writes, calls):
        dist.barrier()
        kernels.reset_launch_counts()
        comm.reset_stats()
        t0 = time.perf_counter()
        try:
            res = run_resilient_distributed(parts, params, mesh, plan=plan,
                                            **kw)
        except InjectedCrash as e:
            err = f"{type(e).__name__}: {e}"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    job = dict(res=res, err=err, launches=launches, stats=dict(comm.stats),
               wall=wall, peak=torch.cuda.max_memory_allocated() - base,
               writes=list(writes), calls=list(calls))
    if record:
        job["checks"] = dist_checks(f"resilient {name}", rec, rows)
    del rec
    return job


def rdist_rank(sizes, root):
    """This rank's resilient runs (the mesh's ranks run this together):
    on (2, 2) the main resume from ``root/main``, then the T = 512 runs
    (materialize crashes, the rebalance, the elastic crash into
    ``root/elastic``); on (1, 2) the elastic resume and its straight
    run."""
    from repro_torch.core.partitioning import repartition_batch
    from repro_torch.distributed.mesh import Mesh, current
    from repro_torch.run import FaultPlan, RebalancePolicy
    mesh = Mesh(sizes, "gloo", "cuda")
    current().timing = True
    topk = dist_plan("fused_topk", dict(sim_topk=32))
    out = {}
    if sizes == (1, 2):
        _, params, parts = dist_data(512, 1)
        out["elastic"] = rdist_run("elastic", parts, params, mesh, topk,
                                   checkpoint_dir=f"{root}/elastic",
                                   on_overflow="widen", elastic_resume=True)
        out["p1"] = rdist_run("p1", parts, params, mesh, topk,
                              on_overflow="widen")
        return out
    _, params, parts = dist_data(4096, 2)
    out["resume"] = rdist_run("main resume", parts, params, mesh, topk,
                              record=tuple(sorted(RDIST_RESUME_KERNELS)),
                              checkpoint_dir=f"{root}/main",
                              on_overflow="widen")
    _, params, parts = dist_data(512, 2)
    mat = dist_plan("materialize", {})
    out["mat"] = rdist_run("mat_512", parts, params, mesh, mat,
                           record=RDIST_MAT_RECORD)
    for stage in RDIST_STAGES:
        d = f"{root}/mat_{stage}"
        out[f"mat_crash_{stage}"] = rdist_run(
            f"mat crash {stage}", parts, params, mesh, mat,
            checkpoint_dir=d, fault_plan=FaultPlan(crash_at=stage))
        out[f"mat_resume_{stage}"] = rdist_run(
            f"mat resume {stage}", parts, params, mesh, mat,
            checkpoint_dir=d)
    out["rb"] = rb = rdist_run(
        "rebalance", parts, params, mesh, topk, record=RDIST_TOPK_RECORD,
        on_overflow="widen", fault_plan=FaultPlan(slow=(("join", 1, 30.0),)),
        rebalance=RebalancePolicy(mode="apply"))
    edges = [e for e in rb["res"].events
             if e["event"] == "rebalanced"][0]["edges"]
    import numpy as np
    out["rb_oracle"] = rdist_run(
        "rebalance oracle", repartition_batch(parts, np.asarray(edges)),
        params, mesh, topk, on_overflow="widen")
    out["el_crash"] = rdist_run(
        "elastic crash", parts, params, mesh, topk,
        checkpoint_dir=f"{root}/elastic", on_overflow="widen",
        fault_plan=FaultPlan(crash_at="cluster"))
    return out


def rdist_same(a, b, what: str):
    """Two distributed outputs bitwise: every result field, ``vote``,
    ``active`` and ``sim_diag``."""
    diffs = diff_fields(a, b)
    check(not diffs, f"{what}: not bitwise ({diffs})")


def phase_resilient_distributed(report, card: str, mono: dict):
    """``run_resilient_distributed`` on the (2, 2) mesh of this card (the
    module docstring's last part); ``mono`` is rank 0's results of
    ``phase_distributed``'s jobs (the main run's output, its launches)."""
    import shutil
    import tempfile
    import threading
    from repro_torch.distributed.mesh import Mesh, spawn
    from repro_torch.run import FaultPlan, InjectedCrash
    from repro_torch.run import run_resilient_distributed
    root = tempfile.mkdtemp(prefix="chip_smoke_rdist_")
    log(f"resilient distributed: checkpoints under a temporary directory, "
        f"{free_disk(root)}")
    _, params, parts = dist_data(4096, 2)
    mesh = Mesh((2, 2), "gloo", "cuda")
    plan = dist_plan("fused_topk", dict(sim_topk=32))
    torch.cuda.empty_cache()
    stop, peak = threading.Event(), [0]
    poll = threading.Thread(target=card_used_peak, args=(stop, peak))
    poll.start()
    try:
        t0 = time.perf_counter()
        crash = None
        try:
            run_resilient_distributed(
                parts, params, mesh, plan=plan, checkpoint_dir=f"{root}/main",
                on_overflow="widen", fault_plan=FaultPlan(crash_at="cluster"))
        except InjectedCrash as e:
            crash = e
        crash_s = time.perf_counter() - t0
        check(type(crash) is InjectedCrash
              and str(crash) == "injected crash at stage 'cluster'",
              f"resilient distributed: the crash came back as {crash!r}")
        t0 = time.perf_counter()
        ranks = spawn(rdist_rank, mesh, (2, 2), root, timeout=900)
        p1 = spawn(rdist_rank, Mesh((1, 2), "gloo", "cuda"), (1, 2), root,
                   timeout=300)
        spawn_s = time.perf_counter() - t0
    finally:
        stop.set()
        poll.join()
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    main = mono["main"]["out"]
    dispatches = mono["main"]["launches"]["topk_claim_max"]
    for r, res in enumerate(ranks):
        job = res["resume"]
        ran = {k for k, n in job["launches"].items() if n}
        check(ran == RDIST_RESUME_KERNELS,
              f"resilient distributed resume rank {r}: launched "
              f"{sorted(ran)}, expected {sorted(RDIST_RESUME_KERNELS)}")
        check(job["launches"]["topk_claim_max"] == dispatches,
              f"resilient distributed resume rank {r}: "
              f"{job['launches']['topk_claim_max']} dispatches, the main "
              f"run {dispatches}")
        check(job["launches"]["sim_row_moments"]
              == job["launches"]["stjoin_sim_fused"],
              f"resilient distributed resume rank {r}: K16 not once a "
              f"similarity pass ({job['launches']})")
        rr = job["res"]
        check(rr.resumed_from == 3 and rr.widen_count == dispatches - 1,
              f"resilient distributed resume rank {r}: resumed_from="
              f"{rr.resumed_from} widen_count={rr.widen_count}")
        rdist_same(rr.output, main,
                   f"resilient distributed resume rank {r} vs the main run")
    # T = 512: the materialize crashes, the rebalance, the elastic resume
    for r, res in enumerate(ranks):
        check({k for k, n in res["mat"]["launches"].items() if n}
              == DIST_KERNELS["materialize"],
              f"resilient distributed mat_512 rank {r}: launches "
              f"{res['mat']['launches']}")
        rdist_same(res["mat"]["res"].output, mono["mat_512"]["out"],
                   f"resilient distributed mat_512 rank {r} vs the monolith")
        for stage in RDIST_STAGES:
            check(res[f"mat_crash_{stage}"]["err"]
                  == f"InjectedCrash: injected crash at stage {stage!r}",
                  f"resilient distributed mat crash {stage} rank {r}: "
                  f"{res[f'mat_crash_{stage}']['err']}")
            rs = res[f"mat_resume_{stage}"]["res"]
            check(rs.resumed_from == RDIST_STAGES.index(stage),
                  f"resilient distributed mat resume {stage}: resumed_from"
                  f"={rs.resumed_from}")
            rdist_same(rs.output, res["mat"]["res"].output,
                       f"resilient distributed mat resume {stage} rank {r}")
        rb = res["rb"]["res"]
        check(rb.rebalance_count == 1
              and {k for k, n in res["rb"]["launches"].items() if n}
              == DIST_KERNELS["fused_topk"],
              f"resilient distributed rebalance rank {r}: "
              f"rebalance_count={rb.rebalance_count}, launches "
              f"{res['rb']['launches']}")
        rdist_same(rb.output, res["rb_oracle"]["res"].output,
                   f"resilient distributed rebalance rank {r} vs a straight "
                   "run at its cut")
        check(res["el_crash"]["err"] ==
              "InjectedCrash: injected crash at stage 'cluster'",
              f"resilient distributed elastic crash rank {r}")
    for r, res in enumerate(p1):
        el = res["elastic"]["res"]
        check(el.resumed_from == 2
              and any(e["event"] == "elastic_resume" for e in el.events),
              f"resilient distributed elastic rank {r}: resumed_from="
              f"{el.resumed_from}")
        rdist_same(el.output, res["p1"]["res"].output,
                   f"resilient distributed elastic (2, 2) -> (1, 2) rank {r}"
                   " vs a straight run at P = 1")
    want = {"chunk_time_bounds", "stjoin_best_match", "stjoin_vote_fused",
            "stjoin_sim_fused", "jaccard_window", "round_scan", "claim_max",
            "sim_row_moments", "topk_round_scan", "topk_claim_max"}
    for r, res in enumerate(ranks):
        got = {c["name"] for j in ("resume", "mat", "rb")
               for c in res[j]["checks"]}
        check(got == want, f"resilient distributed rank {r}: kernels "
                           f"checked {sorted(got)}, expected {sorted(want)}")
    job = r0["resume"]
    writes = job["writes"]
    gb = sum(b for _, b, _ in writes) / 1e9
    wsec = [s for _, _, s in writes]
    csec = job["calls"]
    walls = [res["resume"]["wall"] for res in ranks]
    coll = [sum(v[2] for v in res["resume"]["stats"].values())
            for res in ranks]
    peaks = [res["resume"]["peak"] / 1e9 for res in ranks]
    log(f"resilient distributed main (dsc_brest T=4096, fused top-K from "
        f"K=32, widen, mesh 2x2, gloo, 4 ranks on one card; {card}): crash "
        f"at cluster through the runner's spawn: InjectedCrash in the "
        f"parent, wall s={crash_s:.3f}; resume wall s per rank "
        + ", ".join(f"{w:.3f}" for w in walls)
        + f" (both spawns s={spawn_s:.1f}); resumed_from=3 widen_count="
        f"{job['res'].widen_count}; labels, member_sim, vote, active and "
        f"sim_diag bitwise the main monolith run's")
    log(f"resilient distributed saves (rank 0): {len(writes)} saves, "
        f"{gb:.3f} GB written; s per save on the writer thread mean "
        f"{sum(wsec) / max(len(wsec), 1):.3f} max {max(wsec, default=0):.3f};"
        f" on the calling thread (host copy) mean "
        f"{sum(csec) / max(len(csec), 1):.3f} max {max(csec, default=0):.3f}")
    log(f"resilient distributed resume: peak alloc GB per rank "
        + ", ".join(f"{p:.3f}" for p in peaks)
        + f"; card used peak GB={peak[0] / 1e9:.3f} (all processes, the "
        f"crash and both spawns); collectives s per rank "
        + ", ".join(f"{c:.3f}" for c in coll) + ", share of the wall "
        + ", ".join(f"{c / w:.3f}" for c, w in zip(coll, walls)))
    for r, res in enumerate(ranks):
        log(f"  resume rank {r} collectives (calls, MB sent, s): " + ", ".join(
            f"{k}=({v[0]}, {v[1] / 1e6:.1f}, {v[2]:.3f})"
            for k, v in sorted(res["resume"]["stats"].items())))
        log(f"  resume rank {r} launches: " + ", ".join(
            f"{k}={v}" for k, v in res["resume"]["launches"].items() if v))
    t512 = {j: [res[j]["wall"] for res in ranks]
            for j in ("mat", "rb", "rb_oracle", "el_crash")}
    t512.update({j: [res[j]["wall"] for res in p1] for j in ("elastic",
                                                              "p1")})
    log("resilient distributed T=512: materialize crash at each stage and "
        "resume bitwise the straight run (= the monolith's mat_512); "
        "rebalance (rebalance_count=1) bitwise a straight run at its cut; "
        "elastic (2, 2) -> (1, 2) resumed_from=2 bitwise a straight run at "
        "P = 1; walls s (rank 0) " + ", ".join(
            f"{k}={v[0]:.3f}" for k, v in t512.items()))
    for r, res in enumerate(ranks):
        for j in ("resume", "mat", "rb"):
            for c in res[j]["checks"]:
                log(f"  rank {r} {c['name']} ({c['job']}): {c['calls']} "
                    f"calls at {c['shape']}, bitwise on rerun and against "
                    f"the plain version (rows: {c['rows']}); {c['ms']:.3f} "
                    f"ms, plain {c['plain_ms']:.3f} ms ({card})")
    report["resilient_distributed"] = dict(
        card=card, crash_wall_s=crash_s, resume_wall_s=walls,
        spawns_s=spawn_s, widen_count=job["res"].widen_count,
        saves=len(writes), checkpoint_bytes=sum(b for _, b, _ in writes),
        save_writer_s=wsec, save_call_s=csec, peak_alloc_GB=peaks,
        card_used_peak_bytes=peak[0], collective_s=coll,
        collectives=[res["resume"]["stats"] for res in ranks],
        launches=[res["resume"]["launches"] for res in ranks],
        walls_512=t512,
        checks=[[c for j in ("resume", "mat", "rb") for c in res[j]["checks"]]
                for res in ranks])


# ---------------------------------------------------------------------------
# The examples (repro_torch.examples) on the card, each against its CPU run
# ---------------------------------------------------------------------------

# the kernels of the maritime example's path on every rank: its
# ``use_kernel=True`` is the reference's deprecated alias of
# ``EnginePlan(use_kernel=True)``, the materialize join kernel alone (the
# clustering and segmentation stay on their plain engines, TSA1)
MARITIME_KERNELS = {"stjoin_best_match", "chunk_time_bounds"}
EXAMPLE_MESH = (4, 2)
# the served requests' counts, as the serving launcher logs them
SERVE_COUNTS = re.compile(r"served (\d+) requests, (\d+) tokens in .*; "
                          r"(\d+) decode steps, (\d+) prefill calls, "
                          r"padding waste ([\d.]+)")


class LogLines:
    """The messages of one logger while the context is open."""

    def __init__(self, name: str):
        import logging
        self.logger = logging.getLogger(name)
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def run_example(mod, argv) -> tuple:
    """``(printed lines, returned value, wall s)`` of ``mod.main(argv)``
    (the launch counts zeroed just before)."""
    import io
    from repro_torch import kernels
    buf = io.StringIO()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    if "cuda" in argv:
        torch.cuda.synchronize()
    return buf.getvalue().splitlines(), out, time.perf_counter() - t0


def launched() -> dict:
    from repro_torch import kernels
    return {k: n for k, n in kernels.LAUNCHES.items() if n}


def maritime_rank() -> dict:
    """The maritime example's ``main`` on this rank of its (4, 2) mesh on
    the card: its lines, labels, launches, wall and peak allocation."""
    from repro_torch.examples import maritime_clustering
    torch.cuda.reset_peak_memory_stats()
    lines, out, wall = run_example(maritime_clustering,
                                   ["--device", "cuda"])
    return dict(lines=lines, launches=launched(), wall=wall,
                labels={f: getattr(out.result, f) for f in LABELS},
                peak=torch.cuda.max_memory_allocated())


def train_state_on_host():
    """A stand-in for ``launch.train.make_train_state`` that seeds the
    init on the CPU and moves it to the card: the card run starts from
    the CPU run's weights (the card's generator draws other numbers)."""
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState

    def make(cfg, *, generator, device=None, ep_degree=1):
        gen = torch.Generator().manual_seed(generator.initial_seed())
        params = tf.init_model(cfg, generator=gen, device="cpu",
                               ep_degree=ep_degree).to(device)
        return TrainState(params, adamw_init(params))
    return make


def phase_examples(report, card: str):
    """``repro_torch.examples``: each example's ``main`` on the card against
    the same example under ``--device cpu``.  quickstart and maritime: the
    printed lines and ``member_of`` / ``is_rep`` / ``is_outlier`` bitwise
    (maritime on every rank of one spawn of its (4, 2) mesh, each rank
    launching exactly ``MARITIME_KERNELS``); serve_lm: the served counts
    equal; train_lm (its 300 steps from the CPU's init): the loss drops
    and the first is within ``TRAIN_LOSS_TOL`` of the CPU's (12 steps)."""
    import tempfile
    import threading
    from repro_torch.distributed.mesh import Mesh, spawn
    from repro_torch.examples import (maritime_clustering, quickstart,
                                      serve_lm, train_lm)
    from repro_torch.launch import train as train_launcher
    torch.cuda.empty_cache()
    stop, peak = threading.Event(), [0]
    poll = threading.Thread(target=card_used_peak, args=(stop, peak))
    poll.start()
    t0 = time.perf_counter()
    walls, rep = {}, {}
    try:
        # ---- quickstart: run_dsc's default plan (no kernel) -------------
        lines, out, walls["quickstart"] = run_example(
            quickstart, ["--device", "cuda"])
        check(not launched(), f"quickstart launched {launched()}")
        clines, cout, walls["quickstart_cpu"] = run_example(
            quickstart, ["--device", "cpu"])
        check(lines == clines, f"quickstart: card lines {lines} differ "
                               f"from the CPU's {clines}")
        for f in LABELS:
            check(torch.equal(getattr(out.result, f).cpu(),
                              getattr(cout.result, f)),
                  f"quickstart: {f} differs from the CPU run's")
        rep["quickstart"] = lines
        # ---- maritime: 8 ranks on the card, then 8 CPU ranks -----------
        tm = time.perf_counter()
        ranks = spawn(maritime_rank, Mesh(EXAMPLE_MESH, "gloo", "cuda"),
                      timeout=600)
        walls["maritime"] = time.perf_counter() - tm
        clines, cout, walls["maritime_cpu"] = run_example(
            maritime_clustering, ["--device", "cpu"])
        for r, res in enumerate(ranks):
            check(res["lines"] == clines,
                  f"maritime rank {r}: lines {res['lines']} differ from "
                  f"the CPU's {clines}")
            for f in LABELS:
                check(torch.equal(res["labels"][f], getattr(cout.result, f)),
                      f"maritime rank {r}: {f} differs from the CPU run's")
            check(set(res["launches"]) == MARITIME_KERNELS,
                  f"maritime rank {r}: launched {res['launches']}, "
                  f"expected {sorted(MARITIME_KERNELS)}")
        rep["maritime"] = dict(
            lines=ranks[0]["lines"],
            launches=[res["launches"] for res in ranks],
            rank_walls_s=[res["wall"] for res in ranks],
            rank_peaks=[res["peak"] for res in ranks])
        # ---- serve_lm: the served counts, card against CPU -------------
        with LogLines("repro_torch.serve") as logged:
            _, done, walls["serve_lm"] = run_example(
                serve_lm, ["--device", "cuda"])
            check(not launched(), f"serve_lm launched {launched()}")
            _, cdone, walls["serve_lm_cpu"] = run_example(
                serve_lm, ["--device", "cpu"])
        counts = [SERVE_COUNTS.search(x).groups() for x in logged
                  if SERVE_COUNTS.search(x)]
        check(len(counts) == 2 and counts[0] == counts[1],
              f"serve_lm: served counts card / CPU {counts}")
        check([(r.uid, len(r.out)) for r in done]
              == [(r.uid, len(r.out)) for r in cdone],
              "serve_lm: requests or token counts differ from the CPU's")
        rep["serve_lm"] = counts[0]
        # ---- train_lm: 300 steps on the card from the CPU's init --------
        real = train_launcher.make_train_state
        train_launcher.make_train_state = train_state_on_host()
        try:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as d:
                tlines, losses, walls["train_lm"] = run_example(
                    train_lm, ["--device", "cuda", "--ckpt-dir", d])
                check(not launched(), f"train_lm launched {launched()}")
        finally:
            train_launcher.make_train_state = real
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as d:
            _, closses, walls["train_lm_cpu"] = run_example(
                train_lm, ["--device", "cpu", "--steps", "12",
                           "--ckpt-dir", d])
        first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        check(len(losses) == 300 and last < first,
              f"train_lm: {len(losses)} steps, loss {first} -> {last}")
        diff = abs(losses[0] - closses[0])
        check(diff <= TRAIN_LOSS_TOL,
              f"train_lm: first loss {losses[0]} vs the CPU's {closses[0]}")
        rep["train_lm"] = dict(first=losses[0], cpu_first=closses[0],
                               mean_first10=first, mean_last10=last)
    finally:
        stop.set()
        poll.join()
    phase_s = time.perf_counter() - t0
    report["examples"] = dict(card=card, phase_s=phase_s, walls_s=walls,
                              card_used_peak_bytes=peak[0], **rep)
    log(f"examples phase ({card}): wall s={phase_s:.1f}, card used peak "
        f"GB={peak[0] / 1e9:.3f} (all processes); walls s: " + ", ".join(
            f"{k}={v:.2f}" for k, v in walls.items()))
    log(f"  quickstart: lines and labels bitwise the CPU run's; "
        f"{rep['quickstart'][0]}")
    ln = ranks[0]["launches"]
    log(f"  maritime_clustering (mesh 4x2, 8 gloo ranks on the card): "
        f"lines and labels bitwise the CPU ranks' on every rank; launches "
        f"a rank: " + ", ".join(f"{k}={v}" for k, v in sorted(ln.items()))
        + f" (every rank the same: "
        f"{all(r['launches'] == ln for r in ranks)}); "
        f"{ranks[0]['lines'][1]}")
    log(f"  serve_lm: requests, tokens, decode steps, prefill calls, padding "
        f"waste {rep['serve_lm']}, the CPU's")
    log(f"  train_lm: 300 steps, loss {rep['train_lm']['mean_first10']:.4f} "
        f"-> {rep['train_lm']['mean_last10']:.4f}; first {losses[0]:.6f}, "
        f"the CPU's {closses[0]:.6f} (|diff| {diff:.2e} <= "
        f"{TRAIN_LOSS_TOL:.2e})")


def phase_s2t(dev):
    """The S2T baseline (``core.baselines.s2t``: the plain DSC core on the
    batch's device, SaCO on the host) on the card and on the CPU, on the
    figure-1 scenario of ``tests/test_baselines.py``: equal labels."""
    import numpy as np
    from repro_torch.core.baselines.s2t import s2t_clustering
    from repro_torch.data.synthetic import figure1_scenario
    got = {}
    for d in (dev, "cpu"):
        batch, _ = figure1_scenario(n_per_route=3, points_per_leg=16,
                                    seed=2, device=d)
        got[str(d)] = s2t_clustering(batch, eps_sp=0.42, eps_t=1.0, w=5,
                                     tau=0.2)
    g, c = got[str(dev)], got["cpu"]
    for f in ("member_of", "is_rep", "is_outlier"):
        check(np.array_equal(g[f], c[f]), f"s2t: {f} differs card / CPU")
    check(int(g["is_rep"].sum()) > 0, "s2t: no representative")
    err = float(np.abs(g["sim"] - c["sim"]).max())
    log(f"s2t (figure-1, S={len(g['is_rep'])}): labels on the card equal "
        f"the CPU's; {int(g['is_rep'].sum())} reps, "
        f"{int(g['is_outlier'].sum())} outliers; max |sim card - sim CPU| "
        f"= {err}")


def kernel_row(rows, name, launches, err, ms, plain, bound, lib=None):
    b, by = bound
    rows.append({"name": name, "route": "cuda",
                 "source": CSRC + SOURCES.get(name, "dsc_kernels.cu"),
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b:.4f} ({by}) library_ms={lib}")


def join_input_bytes(P: int, C: int, Mc: int) -> int:
    """Reference x, y, t, id (f32 / i32) and ok (bool) per point;
    candidate x, y, t, ok per point and one id per trajectory."""
    return P * (4 * 4 + 1) + C * Mc * (3 * 4 + 1) + C * 4


def k5_bytes(S: int, active: int) -> int:
    """K5's bytes: the active rows of [S, S] f32, rank (i32) and the two
    flags read once, the two outputs written once."""
    return active * S * 4 + S * 6 + S * 2


def k5_rounds(sim, rank, alpha, states, name: str, report) -> list:
    """K5 at every recorded round state of one run: bitwise its plain
    version, timed alone (CUDA events, 5 calls), with the round's active
    rows and byte bound; the sums over the run are logged and reported."""
    from repro_torch.kernels.cluster.ops import cluster_round_scan
    from repro_torch.kernels.cluster.ref import round_scan_ref
    S = sim.shape[0]
    per = []
    for k, (unres, rep) in enumerate(states):
        kb, kc = cluster_round_scan(sim, rank, unres, rep, alpha)
        pb, pc = round_scan_ref(sim, rank, unres, rep, alpha)
        check(torch.equal(kb, pb) and torch.equal(kc, pc),
              f"{name}: K5 differs from the plain version at round {k}")
        active = int((unres | rep).sum())
        ms = time_ms(lambda: cluster_round_scan(sim, rank, unres, rep,
                                                alpha))
        b, _ = bound_ms(k5_bytes(S, active))
        per.append(dict(round=k, active=active, ms=ms, bound_ms=b))
    tot, tot_b = sum(r["ms"] for r in per), sum(r["bound_ms"] for r in per)
    log(f"  K5 per round ({name}, S={S}; bitwise the plain version at "
        "every round): " + "; ".join(
            f"{r['round']}: {r['active']} rows {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f})" for r in per))
    log(f"  K5 over the run ({name}): {len(per)} rounds {tot:.4f} ms, "
        f"bound {tot_b:.4f} ms ({tot_b / tot:.1%} of it)")
    report[f"k5_rounds {name}"] = dict(rounds=per, sum_ms=tot,
                                       sum_bound_ms=tot_b)
    return per


def k6_bytes(R: int, n_valid: int, S: int) -> int:
    """K6's bytes: the representative rows' valid columns of [S, S] f32
    and their ranks, is_rep and valid (a byte a slot), the two outputs."""
    return 4 * R * n_valid + 4 * R + 2 * S + 8 * S


def launch_floor_ms() -> float:
    """Device time of one near-empty kernel (``torch.cuda._sleep(0)``),
    replayed from a CUDA graph as ``graph_ms`` replays a wrapper: the floor
    of a launch, which K6's two kernels pay twice."""
    return graph_ms(lambda: torch.cuda._sleep(0))


def k16_check(sim, valid, name: str, report) -> dict:
    """K16 (the row moments of alpha) on one run's ``[S, S]`` matrix:
    bitwise its plain tree, timed (CUDA events) beside the plain version
    and its bound, one read of the valid rows (an invalid row is not
    read)."""
    from repro_torch.kernels.cluster.ops import sim_row_moments
    from repro_torch.kernels.cluster.ref import sim_row_moments_ref
    got = sim_row_moments(sim, valid, valid)
    want = sim_row_moments_ref(sim, valid, valid)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"{name}: K16 not bitwise the plain tree")
    ms = time_ms(lambda: sim_row_moments(sim, valid, valid), reps=20)
    plain = time_ms(lambda: sim_row_moments_ref(sim, valid, valid), reps=3)
    rows = int(valid.sum())
    b, by = bound_ms(rows * sim.shape[1] * sim.element_size())
    row = dict(ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
               valid_rows=rows, positive=int(got[0].sum()))
    log(f"  K16 ({name}, [{sim.shape[0]}, {sim.shape[1]}], {rows} valid "
        f"rows): bitwise the plain tree; kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b:.4f} ms ({by}, {b / ms:.1%} of it); "
        f"{row['positive']} positive entries")
    report[f"k16 {name}"] = row
    return row


def k6_check(sim, rank, rep, valid, alpha, name: str, report) -> dict:
    """K6 on one instance: bit for bit its plain twin
    (``cluster_assign_ref``), timed per call through the wrapper (CUDA
    events around 20 back-to-back calls) and as device time (a CUDA graph
    of 20 calls), with its byte bound and the launch floor."""
    from repro_torch.kernels.cluster.ops import cluster_assign
    from repro_torch.kernels.cluster.ref import cluster_assign_ref
    kw, ks = cluster_assign(sim, rank, rep, valid, alpha)
    pw, ps = cluster_assign_ref(sim, rank, rep, valid, alpha)
    err = float((kw - pw).abs().max())
    check(torch.equal(ks, ps), f"K6 ({name}): best_slot differs")
    check(torch.equal(kw.view(torch.int32), pw.view(torch.int32)),
          f"K6 ({name}): best_w not bitwise (max err {err})")
    S = sim.shape[0]
    R, n_valid = int(rep.sum()), int(valid.sum())
    call = lambda: cluster_assign(sim, rank, rep, valid, alpha)
    res = dict(R=R, S=S, ms=time_ms(call, reps=20), device_ms=graph_ms(call),
               plain_ms=time_ms(lambda: cluster_assign_ref(
                   sim, rank, rep, valid, alpha), reps=3),
               bound_ms=bound_ms(k6_bytes(R, n_valid, S))[0],
               floor_ms=launch_floor_ms(), claimed=int((ks >= 0).sum()),
               err=err)
    log(f"  K6 ({name}): R={R} of S={S} rows, {res['claimed']} columns "
        f"claimed; bitwise the plain twin; {res['ms']:.4f} ms per call, "
        f"{res['device_ms']:.4f} ms device (CUDA graph), plain "
        f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.5f} ms (bytes; "
        f"{res['bound_ms'] / res['device_ms']:.1%} of the device time), "
        f"launch floor {res['floor_ms']:.4f} ms a kernel")
    report[f"k6 {name}"] = res
    return res


def k3_check(words, valid, w: int, name: str):
    """K3 on one path's TSA2 words: bitwise its plain version (the masked
    words through ``tsa2_signal``), timed through the wrapper on the raw
    words (the kernel never reads an invalid position's words), with its
    byte bound: the valid positions' words, the flags and ``d``.  Returns
    ``(ms, plain_ms, max_abs_err, bound)``."""
    from repro_torch.core.segmentation import tsa2_signal
    from repro_torch.kernels.jaccard.ops import slab_plan, window_jaccard
    from repro_torch import kernels
    T, M, W = words.shape
    kd = window_jaccard(words, valid, w=w)
    masked = torch.where(valid[..., None], words, 0)
    pd = tsa2_signal(masked, w)
    err = float((kd - pd).abs().max())
    check(torch.equal(kd, pd), f"{name}: K3 d not bitwise (max err {err})")
    ms = time_ms(lambda: window_jaccard(words, valid, w=w), reps=10)
    plain = time_ms(lambda: tsa2_signal(masked, w), reps=3)
    n_valid = int(valid.sum())
    bound = bound_ms(n_valid * W * 4 + T * M * 5)
    J, spill = slab_plan(M, W, kernels.smem_optin(0))
    log(f"  K3 ({name}): [{T}, {M}, {W}] words, {n_valid} valid positions, "
        f"w={w}, slab {J} columns{' (global scratch)' if spill else ''}; "
        f"bitwise the plain version; {ms:.4f} ms through the wrapper, "
        f"plain {plain:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
        f"{bound[0] / ms:.1%} of it)")
    return ms, plain, err, bound


def phase_kernels(batch, params, out, launches, rows, states, report):
    """K1, K3, K5 and K6 against their plain versions on the materialize
    path's inputs (K5 at every round ``states`` recorded).  Returns K1's
    plain output and time for the fused kernels' plain versions."""
    from repro_torch.core import voting
    from repro_torch.core.clustering import visit_order
    from repro_torch.kernels.cluster.ops import cluster_round_scan
    from repro_torch.kernels.cluster.ref import round_scan_ref
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import chunk_time_bounds, stjoin_ref
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M

    # ---- the chunk time bounds every sweep reads: kernel and plain -------
    lo, hi = sj.chunk_time_bounds(batch.t, batch.valid)
    plo, phi = chunk_time_bounds(batch.t, batch.valid, sj.PANEL_CHUNK)
    check(torch.equal(lo, plo) and torch.equal(hi, phi),
          "chunk time bounds: the kernel's differ from the plain version's")
    b_ms = time_ms(lambda: sj.chunk_time_bounds(batch.t, batch.valid),
                   reps=20)
    b_plain = time_ms(lambda: chunk_time_bounds(batch.t, batch.valid,
                                                sj.PANEL_CHUNK), reps=20)
    log(f"  chunk time bounds [{C}, {lo.shape[1]}]: bitwise the plain "
        f"version; kernel {b_ms:.4f} ms, plain {b_plain:.4f} ms")
    del lo, hi, plo, phi

    # ---- K1: the full [P, C] join, kernel and plain ----------------------
    ref_ops = (batch.x.reshape(-1), batch.y.reshape(-1), batch.t.reshape(-1),
               batch.traj_id[:, None].expand(T, M).reshape(-1).contiguous(),
               batch.valid.reshape(-1), batch.x, batch.y, batch.t,
               batch.traj_id, batch.valid, params.eps_sp, params.eps_t)
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)
    kw, ki = sj.stjoin_best_match(*ref_ops, stats=stats)
    mirror = sj.join_skip_counts(batch.t, batch.valid, batch.t, batch.valid,
                                 params.eps_t)
    k2_mirror = sj.fused_skip_counts(batch.t, batch.valid, batch.t,
                                     batch.valid, params.eps_t)
    check(list(mirror) == list(k2_mirror),
          f"K1's mirror {mirror} differs from K2's {k2_mirror} at M = {M}")
    ms = time_ms(lambda: sj.stjoin_best_match(*ref_ops, out_w=kw,
                                              out_idx=ki), reps=3)
    plain_out = []
    k1_plain = time_ms(lambda: plain_out.append(stjoin_ref(*ref_ops)),
                       reps=1, warmup=0)
    pw, pi = plain_out.pop()
    check(torch.equal(ki, pi), "K1 best_idx differs from the plain version")
    err = float((kw - pw).abs().max())
    check(torch.equal(kw, pw), f"K1 best_w not bitwise (max err {err})")
    matched = int((ki >= 0).sum())
    needed = k1_window_pairs(batch, params.eps_t)
    kernel_row(rows, "stjoin_best_match", launches, err, ms, k1_plain,
               bound_ms(join_input_bytes(P, C, Mc) + 8 * P * C,
                        K1_OPS_PER_PAIR * needed))
    log("  K1 " + sweep_skips(stats, mirror, P * C * Mc,
                              K1_OPS_PER_PAIR * needed, "K1")
        + f" (the same counts as K2's at M = {M}); matched (p, c)={matched};"
        f" ptxas {PTXAS.get(SWEEP_PTXAS['stjoin_best_match'], NOT_BUILT)}")

    # ---- K3: the packed TSA2 words of that join --------------------------
    from repro_torch.core.types import JoinResult
    words = voting.neighbor_mask_packed(
        JoinResult(best_w=kw.view(T, M, C), best_idx=ki.view(T, M, C)))
    del kw, ki
    ms, plain, err, bound = k3_check(words, batch.valid, params.w,
                                     "dsc_brest")
    kernel_row(rows, "jaccard_window", launches, err, ms, plain, bound)
    del words

    # ---- K5 at every round of the main path's run ------------------------
    sim, table, alpha = out.sim, out.table, out.result.alpha_used
    S = sim.shape[0]
    _, rank = visit_order(table)
    per = k5_rounds(sim, rank, alpha, states, "dsc_brest materialize",
                    report)
    # beside the rounds: no row unresolved, the final representatives
    final = (torch.zeros_like(table.valid), out.result.is_rep.clone())
    kb, kc = cluster_round_scan(sim, rank, *final, alpha)
    pb, pc = round_scan_ref(sim, rank, *final, alpha)
    check(torch.equal(kb, pb) and torch.equal(kc, pc),
          "K5 differs from the plain version on the final state")
    unres, rep = states[0]
    plain = time_ms(lambda: round_scan_ref(sim, rank, unres, rep, alpha),
                    reps=3)
    predf = ((sim > 0.0) & (sim >= alpha)
             & (rank[:, None] < rank[None, :])).to(torch.float32)
    uf = unres.to(torch.float32)
    lib = time_ms(lambda: uf @ predf)
    del predf
    kernel_row(rows, "round_scan", launches, 0.0, per[0]["ms"], plain,
               bound_ms(k5_bytes(S, per[0]["active"])), lib)
    log(f"  K5 row: round 0, {per[0]['active']} active rows of {S}")

    # ---- K16, the row moments of alpha, on the run's matrix -------------
    k16_check(sim, table.valid, "dsc_brest materialize", report)

    # ---- K6 on the final representatives, then on half the rows ---------
    k6 = k6_check(sim, rank, out.result.is_rep, table.valid, alpha,
                  "dsc_brest materialize, final reps", report)
    kernel_row(rows, "claim_max", launches, k6["err"], k6["ms"],
               k6["plain_ms"], (k6["bound_ms"], "bytes"))
    g = torch.Generator(device=sim.device).manual_seed(0)
    half = torch.rand(S, generator=g, device=sim.device) < 0.5
    k6_check(sim, rank, half, table.valid, alpha,
             "dsc_brest matrix, R = S/2 (seeded rows)", report)
    return pw, pi, k1_plain


def phase_fused_kernels(batch, params, fout, launches, pw, pi, k1_plain,
                        rows):
    """K2 and K4 against their plain versions on the fused path's inputs.
    The plain versions start from K1's plain output (the same join), so
    their time is K1's plain time plus that of the refine and the
    consumer.  No single PyTorch call computes either function (a best
    match, a run refine and a sum or a keyed scatter in one), so neither
    has a library time."""
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.core.similarity import scatter_raw, slot_ids
    from repro_torch.kernels.stjoin.ref import run_refine, vote_words_ref
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    ref_t = batch.t.reshape(-1)
    ops = K1_OPS_PER_PAIR * k1_window_pairs(batch, params.eps_t)
    sweep_ms = K1_OPS_PER_PAIR * P * C * Mc / F32_OPS_PER_S * 1e3

    # ---- K2: vote sums and packed words ----------------------------------
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)
    kv, kw = sj.stjoin_vote_fused_arrays(*arrs, *eps, stats=stats)
    mirror = sj.fused_skip_counts(batch.t, batch.valid, batch.t, batch.valid,
                                  params.eps_t)
    log("  K2 " + sweep_skips(stats, mirror, P * C * Mc, ops, "K2"))
    ms = time_ms(lambda: sj.stjoin_vote_fused_arrays(*arrs, *eps), reps=3)
    plain_out = []
    tail = time_ms(lambda: plain_out.append(vote_words_ref(
        run_refine(pw, None, ref_t, M, params.delta_t)[0])), reps=1,
        warmup=0)
    pv, pwords = plain_out.pop()
    check(torch.equal(kw.view(P, -1), pwords),
          "K2 words differ from the plain version")
    err = float((kv.view(-1) - pv).abs().max())
    check(torch.equal(kv.view(-1), pv), f"K2 vote not bitwise (max err {err})")
    W = pwords.shape[1]
    kernel_row(rows, "stjoin_vote_fused", launches, err, ms, k1_plain + tail,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + P * W * 4, ops))
    log(f"  K2 plain = K1 plain {k1_plain:.1f} ms + refine, vote and words "
        f"{tail:.1f} ms; full-sweep floor {sweep_ms:.4f} ms; library none; "
        f"ptxas {PTXAS.get(SWEEP_PTXAS['stjoin_vote_fused'], NOT_BUILT)}")
    del kv, kw, pv, pwords

    # ---- K4: the raw similarity scatter ----------------------------------
    sub = fout.seg.sub_local
    stats.zero_()
    raw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps, stats=stats)
    log("  K4 " + sweep_skips(stats, mirror, P * C * Mc, ops, "K4"))
    ms = time_ms(lambda: sj.stjoin_sim_fused(batch, batch, sub, sub, ms_,
                                             *eps), reps=3)
    w_r, i_r = run_refine(pw, pi, ref_t, M, params.delta_t)
    gid = slot_ids(sub, ms_, S)
    plain_out = []
    tail = time_ms(lambda: plain_out.append(scatter_raw(
        w_r.view(T, M, C), i_r.view(T, M, C), gid, gid, S, S)), reps=1,
        warmup=0)
    praw = plain_out.pop()
    err = float((raw - praw).abs().max())
    check(torch.equal(raw, praw), f"K4 raw not bitwise (max err {err})")
    kernel_row(rows, "stjoin_sim_fused", launches, err, ms, k1_plain + tail,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + C * Mc * 4
                        + S * S * 4, ops))
    log(f"  K4 plain = K1 plain {k1_plain:.1f} ms + refine and scatter "
        f"{tail:.1f} ms; {int((praw > 0).sum())} nonzero cells of {S * S}; "
        f"full-sweep floor {sweep_ms:.4f} ms; library none; ptxas "
        f"{PTXAS.get(SWEEP_PTXAS['stjoin_sim_fused'], NOT_BUILT)}")
    return raw


def sweep_skips(stats, mirror, pair_slots: int, ops: int, what: str) -> str:
    """The (group, chunk) pairs a K1 / K2 / K4 / K10 / K11 / K12 launch
    tested and skipped (``stats``), held equal to the plain mirror, and the
    pair slots the kept ones hold against every pair of the launch and the
    pairs needed (``ops``: their f32 operations), as a log phrase."""
    swept, skipped = stats.tolist()
    check([swept, skipped] == list(mirror),
          f"{what}: swept / skipped {swept} / {skipped} (group, chunk) "
          f"pairs, the mirror {mirror[0]} / {mirror[1]}")
    slots = (swept - skipped) * PANEL_SLOTS
    return (f"{skipped} of {swept} (group, chunk) pairs skipped (equal to "
            f"the mirror; {100 * (swept - skipped) / max(swept, 1):.2f}% "
            f"kept), {slots} pair slots evaluated of {pair_slots} "
            f"({pair_slots / max(slots, 1):.1f}x fewer), "
            f"{ops // K1_OPS_PER_PAIR} needed "
            f"({max(slots, 1) / max(ops // K1_OPS_PER_PAIR, 1):.1f}x those)")


def phase_fused_head(batch, params, sub, report, name: str, n_plain: int):
    """K2 and K4 on the fused path's inputs (``sub``: its segmentation),
    timed, and bitwise against their plain versions on the first
    ``n_plain`` reference rows against every candidate (the plain join of
    every row would not fit at dsc_sis: [P, C] = 8.6e9 pairs)."""
    from repro_torch.core.similarity import slot_ids
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import (stjoin_sim_fused_ref,
                                                stjoin_vote_fused_ref)
    T, M = batch.x.shape
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    nP, nS = n_plain * M, n_plain * ms_
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    ref_ops, cand_ops = sj._flat_operands(*arrs)
    head = tuple(a[:nP] for a in ref_ops)
    kv, kw = sj.stjoin_vote_fused_arrays(*arrs, *eps)
    ms2 = time_ms(lambda: sj.stjoin_vote_fused_arrays(*arrs, *eps), reps=3)
    pv, pw = stjoin_vote_fused_ref(*head, *cand_ops, *eps, M=M)
    check(torch.equal(kv.view(-1)[:nP], pv)
          and torch.equal(kw.view(T * M, -1)[:nP], pw),
          f"{name}: K2 vote / words not bitwise the plain version on rows "
          f"[0, {n_plain})")
    del pv, pw
    k3 = k3_check(kw.view(T, M, -1), batch.valid, params.w, name)
    report[f"{name}_k3"] = dict(zip(("ms", "plain_ms", "max_abs_err",
                                     "bound_ms"), k3[:3] + k3[3][:1]))
    del kv, kw
    raw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps)
    ms4 = time_ms(lambda: sj.stjoin_sim_fused(batch, batch, sub, sub, ms_,
                                              *eps), reps=3)
    praw = stjoin_sim_fused_ref(
        *head, slot_ids(sub[:n_plain], ms_, nS).view(-1), *cand_ops,
        slot_ids(sub, ms_, S), *eps, M=M, n_src=nS, n_dst=S)
    check(torch.equal(raw[:nS], praw),
          f"{name}: K4 raw not bitwise the plain version on rows "
          f"[0, {n_plain})")
    log(f"{name}: K2 (vote, words) and K4 (raw) bitwise their plain "
        f"versions on rows [0, {n_plain}); K2 {ms2:.3f} ms, K4 {ms4:.3f} ms "
        "(CUDA events, public wrappers)")
    report[f"{name}_fused_kernels"] = dict(k2_ms=ms2, k4_ms=ms4,
                                           plain_rows=n_plain)
    del raw, praw


def panel_skips(sweep, p0: int, Sb: int, stats, what: str) -> str:
    """The (group, chunk) pairs a K7 / K13 call tested and skipped
    (``stats``), held equal to the plain mirror, and the pair slots the
    kept ones hold against those of every pair swept, as a log phrase."""
    swept, skipped = stats.tolist()
    want = sweep.skip_counts(p0, panel=Sb)
    check([swept, skipped] == list(want),
          f"{what} panel {p0}: swept / skipped {swept} / {skipped} (group, "
          f"chunk) pairs, the mirror {want[0]} / {want[1]}")
    T, M, _, Mc = sweep.shape
    n = sweep.pairs(p0, panel=Sb).shape[0]
    slots = (swept - skipped) * PANEL_SLOTS
    return (f"{skipped} of {swept} (group, chunk) pairs skipped (equal to "
            f"the mirror), {slots} pair slots evaluated of the {n * M * Mc} "
            f"of its {n} (row, candidate) pairs")


def phase_topk_kernels(batch, params, tout, launches, raw, rows):
    """K7, K8 and K9 against their plain versions on the fused top-K
    path's inputs: K7 on one panel (also bitwise against K4's ``raw``, its
    skip counts against the plain mirror; timed alone from a CUDA graph,
    per prepared call and per call of the public wrapper), K8 on the final
    lists, K9 at every dispatch's lists (recorded in a second run; returns
    its per-dispatch times).  No single PyTorch call computes any of them:
    K7 is a best match, a run refine and a keyed scatter in two
    orientations; K8 and K9 gather rank and state at the list ids and
    reduce each row by a predicate or a two-key (weight, rank) order."""
    from repro_torch.core.clustering import visit_order
    from repro_torch.core.similarity import (finalize_sim_panel, plan_panel,
                                             sim_row_moments, slot_ids,
                                             topk_reduce_rows)
    from repro_torch.kernels.cluster.ops import (topk_cluster_assign,
                                                 topk_cluster_round_scan)
    from repro_torch.kernels.cluster.ref import (topk_claim_max_ref,
                                                 topk_round_scan_ref)
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import stjoin_sim_panel_fused_ref
    T, M = batch.x.shape
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    Sb = plan_panel(S)
    eps = (params.eps_sp, params.eps_t, params.delta_t)

    # ---- K7: one panel in the middle, both slabs -------------------------
    sub = tout.seg.sub_local
    p0 = (S // Sb // 2) * Sb
    sweep = sj.sim_panel_sweep(batch, batch, sub, sub, ms_, *eps)
    stats = torch.zeros(2, dtype=torch.int64, device=batch.x.device)
    fwd, rev = sweep(p0, panel=Sb, stats=stats)
    skips = panel_skips(sweep, p0, Sb, stats, "K7")
    wrapper = time_ms(lambda: sj.stjoin_sim_panel_fused(
        batch, batch, sub, sub, ms_, *eps, p0=p0, panel=Sb), reps=10)
    call = time_ms(lambda: sweep(p0, panel=Sb), reps=10)
    ms = graph_ms(lambda: sweep(p0, panel=Sb))
    ref_ops, cand_ops = sj._flat_operands(
        *(batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2)
    gid = slot_ids(sub, ms_, S)
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_sim_panel_fused_ref(
        *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
        n_dst=S, p0=p0, panel=Sb)), reps=1, warmup=0)
    pf, pr = plain_out.pop()
    err = max(float((fwd - pf).abs().max()), float((rev - pr).abs().max()))
    check(torch.equal(fwd, pf) and torch.equal(rev, pr),
          f"K7 slabs not bitwise the plain version (max err {err})")
    check(torch.equal(fwd, raw[p0:p0 + Sb])
          and torch.equal(rev, raw.T[p0:p0 + Sb]),
          "K7 slabs not bitwise K4's raw rows / transposed columns")
    partners = window_partners(batch, params.eps_t)
    t_lo, t_hi = p0 // ms_, (p0 + Sb - 1) // ms_
    pairs = 2 * int(partners[t_lo:t_hi + 1].sum())
    P, C, Mc = T * M, T, M
    kernel_row(rows, "stjoin_sim_panel_fused", launches, err, ms, plain,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + C * Mc * 4
                        + 2 * Sb * S * 4,
                        K1_OPS_PER_PAIR * pairs))
    log(f"  K7 panel [{p0}, {p0 + Sb}): rows {t_lo}..{t_hi}; {skips}; "
        f"{pairs} needed pairs (|dt| <= eps_t); "
        f"{int((pf > 0).sum())} + {int((pr > 0).sum())} nonzero cells; "
        f"kernel alone {ms:.4f} ms (CUDA graph), per call {call:.4f} ms "
        f"(prepared), {wrapper:.4f} ms (public wrapper: slot-map check and "
        "chunk bounds); library none")
    tk, table = tout.sim_topk, tout.table

    def panel_tail():
        sim_rows = finalize_sim_panel(fwd, rev, p0, table)
        sim_row_moments(sim_rows, table.valid[p0:p0 + Sb], table.valid)
        return topk_reduce_rows(sim_rows, tk.k)

    log(f"  the rest of one panel at the final K={tk.k} (finalize, row "
        f"moments, stable sort): {time_ms(panel_tail, reps=10):.4f} ms")
    del fwd, rev, pf, pr

    # ---- K8 / K9: the final [S, K] lists and round states ----------------
    alpha = tout.result.alpha_used
    K = tk.k
    _, rank = visit_order(table)
    potential = table.valid & (table.voting >= tout.result.k_used)
    states = [(potential.clone(), torch.zeros_like(potential))]
    b, c = topk_cluster_round_scan(tk.ids, tk.sims, rank, *states[0], alpha)
    frontier = states[0][0] & (~b | c)
    states.append((states[0][0] & ~frontier, frontier & ~c))
    states.append((torch.zeros_like(potential), tout.result.is_rep.clone()))
    for unres, rep in states:
        kb, kc = topk_cluster_round_scan(tk.ids, tk.sims, rank, unres, rep,
                                         alpha)
        pb, pc = topk_round_scan_ref(tk.ids, tk.sims, rank, unres, rep,
                                     alpha)
        check(torch.equal(kb, pb) and torch.equal(kc, pc),
              "K8 differs from the plain version")
    unres, rep = states[0]
    ms = time_ms(lambda: topk_cluster_round_scan(tk.ids, tk.sims, rank,
                                                 unres, rep, alpha))
    plain = time_ms(lambda: topk_round_scan_ref(tk.ids, tk.sims, rank,
                                                unres, rep, alpha), reps=3)
    kernel_row(rows, "topk_round_scan", launches, 0.0, ms, plain,
               bound_ms(S * K * 8.0 + S * 6 + S * 2))
    log(f"  K8 timed at round 0 on the final lists, K={K}")

    return k9_dispatches(batch, params, tout, launches, rows)


def k9_dispatches(batch, params, tout, launches, rows):
    """K9 at every dispatch's K of the fused top-K path: a second run of
    the path records each dispatch's claim-max inputs on the host (the
    main run's wall and peak stay its own; the last dispatch's inputs are
    the main run's final lists and representatives).  Each bitwise its
    plain version, timed with its bound; the sums logged, the final K's
    row added.  Returns the per-dispatch times."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.kernels.cluster.ops import topk_cluster_assign
    from repro_torch.kernels.cluster.ref import topk_claim_max_ref
    tk, S = tout.sim_topk, tout.table.num_slots
    with recorded_claims() as calls:
        again = run_dsc(batch, params, plan=kernel_plan("fused_topk"),
                        device=batch.x.device)
    same_labels(again, tout, "dsc_brest: the recorded fused top-K run")
    check(len(calls) == tout.dispatches,
          f"K9: {len(calls)} claim-max calls recorded, "
          f"{tout.dispatches} dispatches run")
    del again
    per, dev = [], batch.x.device
    for i, call in enumerate(calls):
        ids, sims, rank_, rep, valid = (t.to(dev) for t in call[:5])
        a = call[5]
        if i == len(calls) - 1:
            check(torch.equal(ids, tk.ids) and torch.equal(sims, tk.sims)
                  and torch.equal(rep, tout.result.is_rep),
                  "K9: the last recorded dispatch is not the main run's")
        kw, ks = topk_cluster_assign(ids, sims, rank_, rep, valid, a)
        pw, ps = topk_claim_max_ref(ids, sims, rank_, rep, valid, a)
        err = float((kw - pw).abs().max())
        K = ids.shape[1]
        check(torch.equal(ks, ps), f"K9 best_slot differs at K={K}")
        check(torch.equal(kw, pw),
              f"K9 best_w not bitwise at K={K} (max err {err})")
        fn = lambda: topk_cluster_assign(ids, sims, rank_, rep, valid, a)
        ms = time_ms(fn, reps=20)
        b = bound_ms(k9_bytes(valid, K))
        per.append(dict(K=K, reps=int(rep.sum()), ms=ms,
                        device_ms=graph_ms(fn), bound_ms=b[0], err=err))
    plain = time_ms(lambda: topk_claim_max_ref(ids, sims, rank_, rep, valid,
                                               a), reps=3)
    kernel_row(rows, "topk_claim_max", launches, err, ms, plain, b)
    tot, tot_b = sum(p["ms"] for p in per), sum(p["bound_ms"] for p in per)
    dev_ms = sum(p["device_ms"] for p in per)
    log("  K9 at every dispatch (K: ms per call / device ms / bound ms): "
        + "; ".join(f"{p['K']}: {p['ms']:.4f} / {p['device_ms']:.4f} / "
                    f"{p['bound_ms']:.4f}" for p in per)
        + f"; sums {tot:.4f} / {dev_ms:.4f} / {tot_b:.4f} ms (the bound "
        f"{tot_b / dev_ms:.1%} of the device time); {int(valid.sum())} "
        f"valid rows of {S}; the row above is the final K={per[-1]['K']} "
        "(per call: CUDA events around 20 back-to-back wrapper calls; "
        "device: a CUDA graph of them)")
    return dict(dispatches=per, sum_ms=tot, sum_device_ms=dev_ms,
                sum_bound_ms=tot_b)


# f32 instructions that any exact LCSS schedule needs: one maximum a
# channel on every cell whose points are both valid (a cell that does not
# match takes max(L[i, j-1], L[i-1, j]): lcss_kernels.cu::lcss_pair; a
# row or column whose point is invalid matches nothing and, L being
# non-decreasing along both axes, copies the row above or the column
# before exactly, with no arithmetic) and the time test there (dt and its
# compare); the rest of the weight (dx, dy, two products, their sum, the
# square root, its compare) where the time test passes; the division, the
# subtraction and an add and two maxima a channel where the points match
LCSS_OPS_CELL, LCSS_OPS_TIME, LCSS_OPS_WEIGHT, LCSS_OPS_MATCH = 2, 2, 7, 8
# the former count, shown beside: the whole weight on every valid cell
# (10), the division and subtraction on every match (2), and an add and
# three maxima a channel on every cell (8)
LCSS_OPS_VALID_OLD, LCSS_OPS_MATCH_OLD, LCSS_OPS_DP_OLD = 10, 2, 8
LCSS_PARTNERS = 8          # each trajectory is paired with the next 8 rows


def lcss_pairs(dev):
    """K14's full-width operands: the lane-sorted dsc_brest vessels, each
    paired with the next ``LCSS_PARTNERS`` rows (mod T); ``(the 8 [B, M]
    operands, (eps_sp, eps_t))``."""
    batch, params = brest_batch(4096, dev, sort_by_lane=True)
    T = batch.num_trajs
    ri = torch.arange(T, device=dev).repeat_interleave(LCSS_PARTNERS)
    si = (ri + torch.arange(1, LCSS_PARTNERS + 1, device=dev)
          .repeat(T)) % T
    cols = (batch.x, batch.y, batch.t, batch.valid)
    ops = [c[ri].contiguous() for c in cols] + [c[si].contiguous()
                                                 for c in cols]
    return ops, (params.eps_sp, params.eps_t)


def phase_lcss(dev, report, rows):
    """K14 at dsc_brest: the lane-sorted vessels, each paired with the next
    ``LCSS_PARTNERS`` rows (mod T), dsc_brest's eps.  ``lcss_similarity``
    once with the counts read around it; then the kernel bitwise its
    sheared plain twin (every pair), the row scan (the first pairs) and
    itself on the swapped pairs, timed with its bound.  No single PyTorch
    call computes the DP: library none."""
    from repro_torch import kernels
    from repro_torch.kernels.lcss import ops as lo
    from repro_torch.kernels.lcss import ref as lr
    ops, eps = lcss_pairs(dev)
    B, M = ops[0].shape
    log(f"lcss (K14): {B} pairs of lane-sorted dsc_brest vessels, N=M={M}, "
        f"eps_sp={eps[0]:.6g} eps_t={eps[1]:.6g}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim = lo.lcss_similarity(*ops, *eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ran = {k: n for k, n in launches.items() if n}
    check(ran == {"lcss_wavefront": 1},
          f"lcss_similarity launched {ran}, expected one lcss_wavefront")
    check(sim.shape == (B, 2) and bool(torch.isfinite(sim).all()),
          "lcss: similarity shape or non-finite values")

    got = lo.lcss_wavefront(*ops, *eps)
    n = ops[3].sum(1)
    m = ops[7].sum(1)
    check(bool((got[:, 0] >= 0).all()) and bool((got[:, 0] <= got[:, 1])
                                                .all())
          and bool((got[:, 1] <= torch.minimum(n, m)).all()),
          "lcss: not 0 <= weighted <= count <= min(n, m)")
    check(torch.equal(lo.lcss_wavefront(*ops[4:], *ops[:4], *eps), got),
          "lcss: the swapped pairs score differently")
    head = [o[:64] for o in ops]
    check(torch.equal(lr.lcss_ref(*head, *eps), got[:64]),
          "lcss: K14 not bitwise the row scan on the first 64 pairs")
    ms = time_ms(lambda: lo.lcss_wavefront(*ops, *eps), reps=10)
    out = []
    plain = time_ms(lambda: out.append(lr.lcss_wavefront_ref(
        lr.shear_weights(*ops, *eps))), reps=1, warmup=0)
    twin = out.pop()
    err = float((got - twin).abs().max())
    check(torch.equal(got, twin),
          f"lcss: K14 not bitwise its sheared plain twin (max err {err})")
    del twin, out
    torch.cuda.empty_cache()
    wu = lr.match_weights(*ops, *eps)
    matched = int((wu[:, 1] > 0).sum())
    del wu
    cnt = lr.prefilter_counts(*ops, *eps)
    check(cnt["matched"] == matched,
          f"lcss: the time test keeps {cnt['matched']} matches of {matched}")
    cells, valid_cells = cnt["cells"], cnt["valid"]
    op_count = ((LCSS_OPS_CELL + LCSS_OPS_TIME) * valid_cells
                + LCSS_OPS_WEIGHT * cnt["timed"] + LCSS_OPS_MATCH * matched)
    old_count = (LCSS_OPS_VALID_OLD * valid_cells
                 + LCSS_OPS_MATCH_OLD * matched + LCSS_OPS_DP_OLD * cells)
    nbytes = B * 2 * M * 13 + B * 2 * 4
    bound = bound_ms(nbytes, op_count)
    check(ms >= bound[0], f"lcss: K14 reads {ms} ms, below its bound")
    kernel_row(rows, "lcss_wavefront", launches, err, ms, plain, bound)
    nz = int((got[:, 1] > 0).sum())
    log(f"  K14: {cells} cells, {valid_cells} with both points valid, "
        f"{cnt['timed']} past the time test ({valid_cells - cnt['timed']} "
        f"rejected by it; the weight is formed on the rest), {matched} "
        f"matching; {nz} of {B} pairs share a point; mean similarity "
        f"(weighted, count) {sim.mean(0).tolist()}; the entry point's run "
        f"{wall * 1e3:.3f} ms (host clock); library none")
    log(f"  K14 bound: {op_count} f32 instructions "
        f"({bound_ms(nbytes, op_count)[0]:.4f} ms); the former count "
        f"{old_count} ({bound_ms(nbytes, old_count)[0]:.4f} ms)")
    report["lcss"] = dict(pairs=B, N=M, M=M, **cnt, sharing_pairs=nz,
                          ms=ms, plain_ms=plain, wall_ms=wall * 1e3,
                          ops=op_count, ops_old_count=old_count,
                          launches=launches)


# (name, dtype, B, L query, M keys, KV, G, hd, mask, softcap, q scale) at
# the shapes of configs/smollm_360m.py and configs/gemma2_2b.py, and one
# head dim past the fast paths' 256.  The decode step attends keys [0,
# 6000] of an 8192-slot cache.  With q scaled by
# hd**-0.5 the scores are about N(0, 1) and a softcap of 50 does nothing,
# so the last case leaves q unscaled (scores about N(0, hd)): there tanh
# bends the scores, in float32, where a flipped bfloat16 rounding of a
# score would not swamp the check
ATTN_CASES = (
    ("smollm-360m prefill f32", torch.float32, 1, 4096, 4096, 5, 3, 64,
     dict(), None, 64 ** -0.5),
    ("smollm-360m prefill bf16", torch.bfloat16, 1, 4096, 4096, 5, 3, 64,
     dict(), None, 64 ** -0.5),
    ("gemma2-2b local prefill bf16", torch.bfloat16, 1, 8192, 8192, 4, 2,
     256, dict(window=4096), 50.0, 256 ** -0.5),
    ("gemma2-2b decode bf16", torch.bfloat16, 1, 1, 8192, 4, 2, 256,
     dict(max_kv=6000), 50.0, 256 ** -0.5),
    ("gemma2-2b local prefill f32, q unscaled", torch.float32, 1, 8192,
     8192, 4, 2, 256, dict(window=4096), 50.0, 1.0),
    ("hd-512 general bf16", torch.bfloat16, 1, 1024, 1024, 2, 2, 512,
     dict(window=256), None, 512 ** -0.5),
)


def attention_inputs(dev, case, seed):
    """q (times the case's scale; the models scale it by hd**-0.5), k, v
    from a seed; positions; the mask arguments."""
    _, dtype, B, Lq, M, KV, G, hd, mask, _, q_scale = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Lq, KV, G, hd), generator=g, device=dev) * q_scale
    k = torch.randn((B, M, KV, hd), generator=g, device=dev)
    v = torch.randn((B, M, KV, hd), generator=g, device=dev)
    qp = torch.arange(M - Lq, M, dtype=torch.int32, device=dev)
    if "max_kv" in mask:
        qp = torch.full((1,), mask["max_kv"], dtype=torch.int32, device=dev)
    kp = torch.arange(M, dtype=torch.int32, device=dev)
    return [t.to(dtype) for t in (q, k, v)], qp, kp


def phase_attention(dev, report, rows):
    """K15 at the models' shapes: ``flash_attention`` once per case with the
    counts read around those calls; then each case's path and tile counts
    (a second call, bitwise the first, counting the tiles it swept and
    skipped against ``tile_class_ref``), the case against the plain
    version (within ``kernel_tolerance``; the largest share of it used is
    logged) and timed with its bound, per call (``time_ms``) and as
    device time (``graph_ms``, replayed from a CUDA graph); the smollm
    cases beside ``scaled_dot_product_attention(is_causal=True)`` on the
    same values laid out as it takes them (the layout change untimed).
    The JSON row is the float32 smollm case; the others are logged."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.attention import ops as ao
    from repro_torch.kernels.attention.ref import (attention_mask,
                                                   flash_attention_ref,
                                                   kernel_tolerance,
                                                   tile_class_ref)
    inputs = [attention_inputs(dev, c, i) for i, c in enumerate(ATTN_CASES)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [ao.flash_attention(q, k, v, qp, kp, softcap=c[9], device=dev,
                               **c[8])
            for c, ((q, k, v), qp, kp) in zip(ATTN_CASES, inputs)]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ran = {k: n for k, n in launches.items() if n}
    check(ran == {"flash_attention_fwd": len(ATTN_CASES)},
          f"flash_attention launched {ran}, expected "
          f"{len(ATTN_CASES)} flash_attention_fwd")
    report["attention"] = {}
    for case, ((q, k, v), qp, kp), got in zip(ATTN_CASES, inputs, outs):
        name, dtype, B, Lq, M, KV, G, hd, mask, cap, _ = case
        args = (mask.get("window", ao.HUGE), mask.get("prefix", 0),
                mask.get("max_kv", ao.HUGE))
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name}: output shape, dtype or non-finite values")
        plan = ao.plan_for(q, k, v)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        again = ao.flash_attention_fwd(q, k, v, qp, kp, *args, softcap=cap,
                                       stats=stats)
        check(torch.equal(again, got), f"{name}: K15 not bitwise repeatable")
        del again
        cls = tile_class_ref(qp, kp, *args, G=G, rows=plan.rows,
                             keys=plan.keys)
        swept, skipped = stats.tolist()
        mirror = [cls.numel() * B * KV, int((cls == 0).sum()) * B * KV]
        check([swept, skipped] == mirror,
              f"{name}: K15 swept / skipped {swept} / {skipped} tiles, the "
              f"mirror {mirror[0]} / {mirror[1]}")
        kname = k15_kernel(plan, hd, dtype)
        log(f"  {name}: path {plan.path} ({plan.rows} rows x {plan.keys} "
            f"keys a tile, {plan.nsplit} key splits of "
            f"{plan.tiles_per_split} tiles); skipped {skipped} of {swept} "
            f"(row block, tile) pairs, as the mirror; "
            f"{int((cls == 2).sum()) * B * KV} fully kept; ptxas {kname}: "
            f"{PTXAS.get(kname, 'not built in this run')}")
        res = []            # warmed: a cold first call spreads 3x
        plain = time_ms(lambda: res.append(flash_attention_ref(
            q, k, v, qp, kp, *args, softcap=cap)), reps=3)
        want = res.pop()
        ok = attention_mask(qp, kp, *args)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        share = diff / kernel_tolerance(q, k, v, qp, kp, *args, cap, want)
        used, at = share.reshape(-1).max(0)
        used, at = float(used), int(at)
        row = at // (KV * G * hd) % Lq
        log(f"  {name}: {used:.4g} of the tolerance used, most at query "
            f"{row} ({int(ok[row].sum())} keys kept; K15 "
            f"{float(got.reshape(-1)[at]):.6g}, plain "
            f"{float(want.reshape(-1)[at]):.6g})")
        check(used <= 1.0,
              f"{name}: K15 outside its tolerance of the plain version "
              f"(max err {err}, {used:.3g} of the tolerance)")
        if dtype == torch.bfloat16:     # each against float32 arithmetic
            exact = flash_attention_ref(q.float(), k.float(), v.float(), qp,
                                        kp, *args, softcap=cap)
            log(f"  {name}: max |K15 - f32| = "
                f"{float((got.float() - exact).abs().max())}, max |plain - "
                f"f32| = {float((want.float() - exact).abs().max())}")
            del exact
        del want, res, diff, share
        if cap:             # how far the scores reach into the softcap
            s = torch.einsum("blkgh,bmkh->blkgm", q[:, -256:].float(),
                             k.float())
            log(f"  {name}: max |q.k| over the last 256 query rows = "
                f"{float(s.abs().max()):.4g} (softcap {cap})")
            del s
        call = lambda: ao.flash_attention_fwd(q, k, v, qp, kp, *args,
                                              softcap=cap)
        ms = time_ms(call, reps=20, warmup=3)
        dev_ms = graph_ms(call)
        pairs = int(ok.sum())                       # unmasked
        flops = 4 * hd * pairs * B * KV * G
        # k and v of the keys some row keeps (of all, if a row keeps none:
        # it averages every v), q in and out, the positions
        keys = int(ok.any(0).sum()) if bool(ok.any(1).all()) else M
        esize = q.element_size()
        nbytes = 2 * q.numel() * esize + 2 * B * keys * KV * hd * esize \
            + 4 * (Lq + M)
        rate = F32_FLOPS_PER_S if dtype == torch.float32 else \
            BF16_FLOPS_PER_S
        bound = bound_ms(nbytes, flops, rate)
        lib = None
        if name.startswith("smollm"):
            H = KV * G
            qs = q.reshape(B, Lq, H, hd).transpose(1, 2).contiguous()
            ks, vs = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                      .contiguous() for t in (k, v))
            sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  scale=1.0)
            lerr = float((sdpa.transpose(1, 2).reshape(q.shape).float()
                          - got.float()).abs().max())
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, scale=1.0), reps=3)
            del qs, ks, vs, sdpa
            log(f"  {name}: max |K15 - SDPA| = {lerr}")
        log(f"  {name}: B={B} Lq={Lq} M={M} KV={KV} G={G} hd={hd} "
            f"mask={mask} softcap={cap}: err={err} ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]}; "
            f"{pairs} unmasked pairs, {keys} keys read, {flops:.4g} flops) "
            f"tolerance_used={used:.4g} library_ms={lib} "
            f"graph_ms={dev_ms:.4f} (device time, replayed)")
        report["attention"][name] = dict(
            err=err, tolerance_used=used, ms=ms, graph_ms=dev_ms,
            plain_ms=plain,
            path=plan.path, nsplit=plan.nsplit, tiles_swept=swept,
            tiles_skipped=skipped,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            pairs=pairs, keys=keys, flops=flops)
        if name == ATTN_CASES[0][0]:
            kernel_row(rows, "flash_attention_fwd", launches, err, ms, plain,
                       bound, lib)
    del outs, inputs


# ------------------------------------------------------------- LM serving

# bf16 ulps of the largest value compared, card against the CPU (the
# whole-model tolerance of tests/test_torch_models.py: cuBLAS and the CPU's
# GEMMs sum in other orders, and a bf16 rounding that falls the other way
# moves a value by an ulp, a few of which add up through the layers)
SERVE_ULPS = 8
SERVE_ARCH = "smollm-360m"
SERVE_SLOTS, SERVE_MAX_NEW, SERVE_MAX_LEN = 8, 32, 4096
# 7 prompts drawn in [1536, 3072) and 9 of exactly 3072: the queue is
# sorted (stably) by length, so each wave of 8 holds a 3072 and every
# prefill is 3072 long (> ATTN_CHUNK_THRESHOLD: the online path, with
# whole 512-query and 1024-key chunks of the 4096-slot cache)
SERVE_SHORT, SERVE_LONG = 7, 9
SERVE_PROMPT = (1536, 3072)
# the full-forward chain right-pads its sequence to 3584 = 7 x 512, so the
# online path keeps whole chunks (a length like 3073 halves them to 1);
# causal masking keeps the pads out of the last real position's logits
SERVE_CHAIN_LEN = 3584
GEMMA_ARCH, GEMMA_B, GEMMA_PROMPT, GEMMA_MAX_LEN, GEMMA_STEPS = (
    "gemma2-2b", 2, 4608, 5120, 8)


def ulps_tol(want: torch.Tensor, ulps: int = SERVE_ULPS) -> float:
    import math
    top = float(want.detach().float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def top_gap(row: torch.Tensor) -> float:
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def serve_close(got, want, what: str) -> float:
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs "
                                   f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: not finite")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = ulps_tol(want)
    check(err <= tol, f"{what}: max |card - cpu| {err} > {tol}")
    return err


@contextlib.contextmanager
def recorded_moe(seen: list):
    """Record every MoE layer's input during the block."""
    from repro_torch.models import moe
    real = moe.moe_ffn

    def rec(p, h, cfg, **kw):
        seen.append(h.detach().clone())
        return real(p, h, cfg, **kw)
    moe.moe_ffn = rec
    try:
        yield
    finally:
        moe.moe_ffn = real


def moe_aux_bound(cfg, cpu_params, seen) -> tuple[float, int]:
    """Each recorded card layer input routed again on the CPU: the expert
    choices equal where the CPU's k-th / (k+1)-th and top-1 / top-2 router
    probabilities differ by more than 2**-7 of the largest (the margin
    rule).  Returns the bound on |card aux - cpu aux| that the rows which
    are not sure allow (E / N a row, over the layers' mean), and their
    count."""
    from repro_torch.models import moe
    layers = cpu_params["layers"]["moe"].tree()
    low = 0
    e_over_n = 0.0
    for i, h in enumerate(seen):
        p = {k: v[i] for k, v in layers.items()}
        hc = h.cpu()
        D = hc.shape[-1]
        logits = (hc.reshape(-1, D).bfloat16()
                  @ p["router"].bfloat16()).float()
        probs, _, eidx = moe._route(logits, cfg.moe, logits.shape[1])
        card_logits = (h.reshape(-1, D).bfloat16()
                       @ p["router"].to(h.device).bfloat16()).float()
        _, _, card_eidx = moe._route(card_logits, cfg.moe,
                                     card_logits.shape[1])
        k, tol = cfg.moe.top_k, 2.0 ** -7 * float(probs.max())
        srt = probs.sort(dim=-1, descending=True).values
        sure = ((srt[:, k - 1] - srt[:, k] > tol)
                & (srt[:, 0] - srt[:, 1] > tol))
        same = (card_eidx.cpu().sort(-1).values
                == eidx.sort(-1).values).all(-1)
        check(bool(same[sure].all()), f"MoE layer {i}: a sure expert "
                                      f"choice differs card vs CPU")
        low += int((~sure).sum())
        e_over_n = probs.shape[1] / probs.shape[0]
    return e_over_n * low / max(len(seen), 1), low


def serve_tokens(cfg, B: int, L: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks, L) if cfg.family == "audio" else (B, L)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                              .astype(np.int32))
    fe = None
    if cfg.family == "vlm":
        fe = torch.from_numpy(rng.normal(
            0, 1, (B, cfg.vision_tokens, cfg.d_vision)).astype(np.float32))
    return tokens, fe


def phase_serve_reduced(dev, report):
    """Every architecture at its reduced config, the same params on the card
    and on the CPU: the full forward's logits and aux, a prefill of L - 1
    tokens into the caches and one decode step (logits and every cache
    leaf) within ``SERVE_ULPS`` ulps; the MoE aux within the margin rule's
    bound; on the card, the decode logits against the full forward's last
    position (``tests/test_arch_smoke.py``'s atol = rtol = 2e-2)."""
    import copy
    from repro_torch import kernels
    from repro_torch.configs import ARCHITECTURES, get_arch, reduced_config
    from repro_torch.models import transformer as tf
    out = {}
    B, L = 2, 12
    for i, arch in enumerate(ARCHITECTURES):
        cfg = reduced_config(get_arch(arch))
        cpu = tf.init_model(cfg, generator=torch.Generator().manual_seed(i),
                            device="cpu")
        card = copy.deepcopy(cpu).to(dev)
        tokens, fe = serve_tokens(cfg, B, L, i)
        td, fd = tokens.to(dev), None if fe is None else fe.to(dev)
        prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
        seen = []
        kernels.reset_launch_counts()
        with torch.no_grad():
            with recorded_moe(seen):
                gl, gaux, _ = tf.forward(card, td, cfg, frontend_inputs=fd)
            cl, caux, _ = tf.forward(cpu, tokens, cfg, frontend_inputs=fe)
            errs = [serve_close(gl, cl, f"{arch} forward logits")]
            if cfg.family == "moe":
                bound, low = moe_aux_bound(cfg, cpu, seen)
                err = abs(float(gaux["moe_aux"]) - float(caux["moe_aux"]))
                tol = 1e-3 * float(caux["moe_aux"]) + bound
                check(err <= tol, f"{arch} moe_aux: {err} > {tol}")
                check(float(gaux["moe_dropped"]) == float(
                    caux["moe_dropped"]) == 0.0, f"{arch}: tokens dropped")
            gc = tf.init_cache(cfg, B, L + prefix, device=dev)
            cc = tf.init_cache(cfg, B, L + prefix, device="cpu")
            gp, _, gc = tf.forward(card, td[..., :L - 1], cfg,
                                   frontend_inputs=fd, cache=gc,
                                   cache_index=0)
            cp, _, cc = tf.forward(cpu, tokens[..., :L - 1], cfg,
                                   frontend_inputs=fe, cache=cc,
                                   cache_index=0)
            errs.append(serve_close(gp, cp, f"{arch} prefill logits"))
            errs += [serve_close(gc[k], cc[k], f"{arch} prefill cache {k}")
                     for k in cc]
            gd, _, gc = tf.forward(card, td[..., L - 1:], cfg, cache=gc,
                                   cache_index=prefix + L - 1)
            cd, _, cc = tf.forward(cpu, tokens[..., L - 1:], cfg, cache=cc,
                                   cache_index=prefix + L - 1)
            errs.append(serve_close(gd, cd, f"{arch} decode logits"))
            errs += [serve_close(gc[k], cc[k], f"{arch} decode cache {k}")
                     for k in cc]
            dev_err = float((gd[:, -1] - gl[:, -1]).abs().max())
            check(torch.allclose(gd[:, -1], gl[:, -1], atol=2e-2,
                                 rtol=2e-2),
                  f"{arch}: decode after prefill vs full forward on the "
                  f"card: {dev_err}")
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        check(not launched, f"{arch}: the LM path launched {launched}")
        out[arch] = {"max_err_card_cpu": max(errs),
                     "decode_vs_forward": dev_err,
                     "moe_rows_not_sure": low if cfg.family == "moe"
                     else None}
        log(f"serve reduced ({arch}, {cfg.family}): logits, caches and aux "
            f"on the card equal the CPU's within {SERVE_ULPS} bf16 ulps "
            f"(max |card - cpu| {max(errs):.6g}); decode vs full forward "
            f"{dev_err:.6g} (atol 2e-2)"
            + (f"; MoE rows not sure {low}" if cfg.family == "moe" else ""))
        del card, gc, cc
    report["serve_reduced"] = out


class StepTimer:
    """CUDA events around every call of the engine module's prefill and
    decode steps (the engine looks them up at call time); each step's
    logits are checked finite, and those of one slot kept."""

    def __init__(self, slot=None):
        self.slot = slot
        self.calls = []       # (kind, start, end)
        self.rows = []

    @contextlib.contextmanager
    def active(self):
        from repro_torch.serve import engine
        real = {n: getattr(engine, n) for n in ("prefill_step",
                                                 "decode_step")}

        def wrap(name):
            def step(*a, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                logits, cache = real[name](*a, **kw)
                e.record()
                self.calls.append((name, s, e))
                check(bool(torch.isfinite(logits).all()),
                      f"{name}: logits not finite")
                if self.slot is not None:
                    self.rows.append(logits[self.slot].float().clone())
                return logits, cache
            return step
        for n in real:
            setattr(engine, n, wrap(n))
        try:
            yield self
        finally:
            for n, f in real.items():
                setattr(engine, n, f)

    def ms(self, name: str) -> list[float]:
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for n, s, e in self.calls if n == name]


def serve_params(cfg, seed: int, dev):
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    params = tf.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in params.parameters())
    norms = sum(p.numel() for name, p in params.named_parameters()
                if name.endswith(".scale"))
    check(n - norms == cfg.param_count(),
          f"{cfg.name}: {n - norms} parameters besides the norm scales, "
          f"param_count() {cfg.param_count()}")
    return params, n, norms, init_s


def decode_op_count(params, cfg, dev) -> int:
    """Top-level aten operators one decode step dispatches (a host-side
    profile, no device activity traced): the host's share of a step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import decode_step
    cache = tf.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN, device=dev)
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    decode_step(params, tok, cache, 100, cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decode_step(params, tok, cache, 101, cfg)
    torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::")))


def phase_serve_smollm(dev, report, card: str):
    """smollm-360m at full width through ``ServeEngine``: 16 requests in 8
    slots, 32 new tokens each, ``max_len`` 4096, two waves whose prefills
    are 3072 long (the online path); the counters; one request's tokens
    against a chain of full forwards on the card (fed the engine's
    tokens) under the margin rule; prefill ms per wave and decode ms per
    step (CUDA events), tokens/s (host clock around ``run``), peak.  The
    probe's engine logits must lie within ``SERVE_ULPS`` ulps of the
    forward's at every step, and its token must be the forward's argmax
    wherever the forward's top-1 / top-2 gap exceeds twice the step's
    largest logit difference (the margin rule at the measured bound)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_arch(SERVE_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, n, norms, init_s = serve_params(cfg, 0, dev)
    # warm the card's libraries (cuBLAS handles, the allocator) on a short
    # request; untimed
    warm = ServeEngine(params, cfg, n_slots=SERVE_SLOTS, max_len=256)
    warm.submit(Request(uid=0, prompt=np.arange(64, dtype=np.int32),
                        max_new=2))
    warm.run()
    rng = np.random.default_rng(0)
    lens = [int(x) for x in rng.integers(*SERVE_PROMPT, SERVE_SHORT)]
    lens += [SERVE_PROMPT[1]] * SERVE_LONG
    rng.shuffle(lens)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab_size, L)
                    .astype(np.int32), max_new=SERVE_MAX_NEW)
            for u, L in enumerate(lens)]
    order = sorted(reqs, key=lambda r: len(r.prompt))
    probe = order[SERVE_SLOTS - 1]          # the first wave's 3072 prompt
    check(len(probe.prompt) == SERVE_PROMPT[1], "probe is not 3072 long")
    eng = ServeEngine(params, cfg, n_slots=SERVE_SLOTS,
                      max_len=SERVE_MAX_LEN)
    for r in reqs:
        eng.submit(r)
    timer = StepTimer(slot=SERVE_SLOTS - 1)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timer.active():
        done = eng.run()
    wall = time.perf_counter() - t0
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"serving launched {launched}")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(len(done) == 16 and all(len(r.out) == SERVE_MAX_NEW
                                  for r in done),
          "a request did not return its 32 tokens")
    check(eng.prefill_calls == 2 and eng.decode_steps == 62,
          f"prefill_calls {eng.prefill_calls}, decode_steps "
          f"{eng.decode_steps} (want 2, 62)")
    prefill = timer.ms("prefill_step")
    decode = timer.ms("decode_step")
    # the probe's logits: its wave's prefill and 31 decode steps
    rows = timer.rows[:SERVE_MAX_NEW]
    toks = probe.out
    chain_err, sure, first_low = 0.0, 0, None
    for t in range(SERVE_MAX_NEW):
        seq = np.zeros((1, SERVE_CHAIN_LEN), np.int32)
        cur = np.concatenate([probe.prompt, np.asarray(toks[:t], np.int32)])
        seq[0, :len(cur)] = cur
        with torch.no_grad():
            logits = tf.forward(params, torch.from_numpy(seq).to(dev),
                                cfg)[0][0, len(cur) - 1]
        err = float((logits - rows[t]).abs().max())
        check(err <= ulps_tol(logits),
              f"smollm probe step {t}: max |engine - forward| logit {err} "
              f"> {ulps_tol(logits)}")
        chain_err = max(chain_err, err)
        # each logit within err of the forward's: where the forward's two
        # best lie more than 2 err apart, no token but its argmax is the
        # engine's argmax
        if top_gap(logits) > 2 * err:
            check(int(logits.argmax()) == toks[t],
                  f"smollm probe step {t}: engine token {toks[t]}, full "
                  f"forward {int(logits.argmax())} at a sure margin")
            sure += 1
        elif first_low is None:
            first_low = t
    tok_s = sum(len(r.out) for r in done) / wall
    ops = decode_op_count(params, cfg, dev)
    res = {"params": n, "norm_scales": norms, "init_s": init_s,
           "decode_aten_ops": ops,
           "prefill_ms": prefill, "decode_ms_mean": sum(decode) / len(decode),
           "decode_ms_min": min(decode), "decode_ms_max": max(decode),
           "wall_s": wall, "tokens_per_s": tok_s, "peak_gb": peak,
           "prompt_lens": lens, "chain_steps_sure": sure,
           "chain_first_low_margin": first_low,
           "chain_max_abs_logit_diff": chain_err, "card": card}
    report["serve_smollm"] = res
    log(f"serve ({SERVE_ARCH} full: 32 layers, d 960, 15/5 heads, vocab "
        f"49152; {n} parameters, {norms} of them norm scales; init "
        f"{init_s:.2f} s): 16 requests in {SERVE_SLOTS} slots, "
        f"{SERVE_MAX_NEW} new tokens each, max_len {SERVE_MAX_LEN}; "
        f"prefill_calls 2, decode_steps 62; prefill ms per wave (3072 "
        f"tokens x 8 rows) " + ", ".join(f"{x:.1f}" for x in prefill)
        + f"; decode ms per step mean {res['decode_ms_mean']:.2f} (min "
        f"{min(decode):.2f}, max {max(decode):.2f}; {ops} top-level aten "
        f"ops a step, the host's dispatch); wall {wall:.2f} s, "
        f"{tok_s:.1f} tokens/s; peak {peak:.3f} GB ({card})")
    log(f"serve ({SERVE_ARCH}): request {probe.uid}'s 32 tokens against "
        f"full forwards on the card: max |engine - forward| logit "
        f"{chain_err:.6g} (within {SERVE_ULPS} ulps at every step); tokens "
        f"equal at the {sure} steps whose margin exceeds twice it, first "
        f"low margin at step {first_low}")
    del params, eng, timer
    torch.cuda.empty_cache()


def phase_serve_gemma(dev, report, card: str):
    """gemma2-2b at full width for one wave: B = 2 prompts of 4608 (longer
    than the 4096 window, so the local layers mask), ``max_len`` 5120, 8
    decode steps; softcaps, gemma norms and hd 256 on the way."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_arch(GEMMA_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, n, norms, init_s = serve_params(cfg, 1, dev)
    rng = np.random.default_rng(1)
    eng = ServeEngine(params, cfg, n_slots=GEMMA_B, max_len=GEMMA_MAX_LEN)
    for u in range(GEMMA_B):
        eng.submit(Request(uid=u, prompt=rng.integers(
            0, cfg.vocab_size, GEMMA_PROMPT).astype(np.int32),
            max_new=GEMMA_STEPS + 1))
    timer = StepTimer()
    kernels.reset_launch_counts()
    with timer.active():
        done = eng.run()
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"serving launched {launched}")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(eng.prefill_calls == 1 and eng.decode_steps == GEMMA_STEPS
          and all(len(r.out) == GEMMA_STEPS + 1 for r in done),
          "gemma2-2b wave: counters")
    prefill, decode = timer.ms("prefill_step"), timer.ms("decode_step")
    report["serve_gemma"] = {"params": n, "init_s": init_s,
                             "prefill_ms": prefill[0], "decode_ms": decode,
                             "peak_gb": peak, "card": card}
    log(f"serve ({GEMMA_ARCH} full: 26 layers, d 2304, 8/4 heads, hd 256, "
        f"window 4096, vocab 256000; {n} parameters): one wave of "
        f"{GEMMA_B} x {GEMMA_PROMPT}, max_len {GEMMA_MAX_LEN}; prefill "
        f"{prefill[0]:.1f} ms, decode ms per step mean "
        f"{sum(decode) / len(decode):.2f}; peak {peak:.3f} GB (the "
        f"[2, 4608, 256000] f32 logits alone 9.4 GB) ({card})")
    del params, eng, timer
    torch.cuda.empty_cache()


def phase_serve_launcher(report):
    """The port's launcher in this process: ``--arch smollm-360m --full``
    at its defaults (16 requests, 4 slots, prompts of 16-32, 16 new
    tokens, max_len 128)."""
    from repro_torch import kernels
    from repro_torch.launch import serve as launcher
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = launcher.main(["--arch", SERVE_ARCH, "--full"])
    wall = time.perf_counter() - t0
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"the serving launcher launched {launched}")
    check(len(done) == 16 and all(len(r.out) == 16 for r in done),
          "launcher: 16 requests of 16 tokens")
    report["serve_launcher_s"] = wall
    log(f"serve launcher (--arch {SERVE_ARCH} --full): 16 requests, 256 "
        f"tokens, wall {wall:.2f} s (init included)")


def phase_serve(dev, report, card: str):
    """The LM serving path (no TPU kernel lies on it: the reference's
    attention is plain XLA, and no custom kernel launches here)."""
    phase_serve_reduced(dev, report)
    phase_serve_smollm(dev, report, card)
    phase_serve_gemma(dev, report, card)
    phase_serve_launcher(report)


# the LM training phase: every family reduced (card against CPU, the
# bounds of tests/test_torch_train.py), smollm-360m at full width with the
# train_4k shape's sequence (the global batch cut from 256 to 4), zamba2-1.2b
# at full width, the training launcher run and resumed
TRAIN_KW = dict(peak_lr=1e-2, warmup=2, total_steps=10)
TRAIN_LOSS_TOL = 2.0 ** -9
TRAIN_GNORM_REL = 2.0 ** -6
TRAIN_REL, TRAIN_COS = 0.1, 0.995
TRAIN_ARCH, TRAIN_B, TRAIN_L, TRAIN_STEPS = "smollm-360m", 4, 4096, 4
TRAIN_FULL_KW = dict(peak_lr=1e-3, warmup=2, total_steps=10_000)
# the remat modes' new params against remat=True's: the card's atomic
# scatter adds in the backward reorder f32 sums, and Adam divides by
# sqrt(v), so where v is tiny such a change moves an element's update by
# up to its whole size: each leaf's update within this relative L2, each
# element within 2 lr
TRAIN_REMAT_REL = 0.05
ZAMBA_ARCH, ZAMBA_B, ZAMBA_L, ZAMBA_STEPS = "zamba2-1.2b", 2, 2048, 2


def host_leaves(tree) -> list:
    from repro_torch.optim.adamw import tree_leaves
    return [x.detach().float().cpu().numpy() for x in tree_leaves(tree)]


def leaf_close(got, want, paths, rel, cos, what) -> tuple[float, float]:
    """Per leaf: relative L2 within ``rel`` (of the leaf's norm, or of
    1/256 of the largest leaf norm where the leaf's is smaller) and, above
    that floor, the cosine at least ``cos``; the worst (rel, cos) above the
    floor."""
    import numpy as np
    floor = max(float(np.linalg.norm(w.astype(np.float64))) for w in want)
    floor /= 256
    worst = (0.0, 1.0)
    for p, g, w in zip(paths, got, want):
        g, w = g.astype(np.float64), w.astype(np.float64)
        nw, err = float(np.linalg.norm(w)), float(np.linalg.norm(g - w))
        check(np.isfinite(g).all(), f"{what} {p}: not finite")
        check(err <= rel * max(nw, floor),
              f"{what} {p}: |card - cpu| {err} > {rel} x {max(nw, floor)}")
        if nw >= floor:
            c = float((g * w).sum() / (np.linalg.norm(g) * nw))
            check(c >= cos, f"{what} {p}: cosine {c} < {cos}")
            worst = (max(worst[0], err / nw), min(worst[1], c))
    return worst


def train_batch(cfg, B: int, L: int, step: int, dev, seed: int = 0):
    """``TokenPipeline``'s batch ``step`` on ``dev``: tokens, labels,
    frontend (None outside vlm)."""
    from repro_torch.data.pipeline import TokenPipeline
    b = TokenPipeline(cfg, B, L, seed=seed).batch_at(step)
    fe = b.get("frontend")
    return (torch.from_numpy(b["tokens"]).to(dev),
            torch.from_numpy(b["labels"]).to(dev),
            None if fe is None else torch.from_numpy(fe).to(dev))


def phase_train_reduced(dev, report):
    """Every architecture at its reduced config, the same params and
    ``TokenPipeline`` batch on the card and on the CPU: one ``train_step``
    each (remat=True): ``lr`` bitwise, the loss within 2**-9, the grad norm
    within 2**-6 relative, each moment leaf within 10% relative L2 and
    cosine 0.995 (above 1/256 of the largest leaf norm), the new params
    within lr / 1000 where both first moments share a sign and exceed 1e-5
    and within 2 lr everywhere (a bf16 sign flip of a tiny gradient); MoE
    choices under the margin rule.  On the card the step lowers the loss
    of its own batch (``tests/test_arch_smoke.py``'s check)."""
    import copy
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import ARCHITECTURES, get_arch, reduced_config
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.train.step import TrainState, loss_and_grads, train_step
    out = {}
    for i, arch in enumerate(ARCHITECTURES):
        cfg = reduced_config(get_arch(arch))
        cpu = tf.init_model(cfg, generator=torch.Generator().manual_seed(i),
                            device="cpu")
        before = copy.deepcopy(cpu)
        card = copy.deepcopy(cpu).to(dev)
        cs, gs = TrainState(cpu, adamw_init(cpu)), TrainState(
            card, adamw_init(card))
        ct, cl, cf = train_batch(cfg, 2, 32, 0, "cpu", seed=i)
        gt, gl, gf = (ct.to(dev), cl.to(dev),
                      None if cf is None else cf.to(dev))
        seen = []
        kernels.reset_launch_counts()
        with recorded_moe(seen):
            gs, gm = train_step(gs, gt, gl, cfg, frontend_inputs=gf,
                                **TRAIN_KW)
        cs, cm = train_step(cs, ct, cl, cfg, frontend_inputs=cf, **TRAIN_KW)
        with torch.no_grad():
            after = float(loss_and_grads(gs.params, gt, gl, cfg,
                                         frontend_inputs=gf)[0])
        launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
        check(not launched, f"{arch}: training launched {launched}")
        m = {k: float(v) for k, v in gm.items()}
        c = {k: float(v) for k, v in cm.items()}
        check(all(np.isfinite(v) for v in m.values()), f"{arch}: {m}")
        check(m["lr"] == c["lr"], f"{arch}: lr {m['lr']} vs {c['lr']}")
        check(abs(m["loss"] - c["loss"]) <= TRAIN_LOSS_TOL,
              f"{arch}: loss card {m['loss']} cpu {c['loss']}")
        check(abs(m["grad_norm"] / c["grad_norm"] - 1) <= TRAIN_GNORM_REL,
              f"{arch}: grad norm card {m['grad_norm']} cpu "
              f"{c['grad_norm']}")
        check(after < m["loss"], f"{arch}: one step on the card did not "
                                 f"lower its batch's loss ({m['loss']} -> "
                                 f"{after})")
        low = 0
        if cfg.family == "moe":
            # the forward's layer inputs (remat recomputes them once more
            # in the backward)
            with torch.no_grad():
                bound, low = moe_aux_bound(cfg, before,
                                           seen[:cfg.n_layers
                                                - cfg.moe.first_k_dense])
            err = abs(m["moe_aux"] - c["moe_aux"])
            check(err <= 1e-3 * c["moe_aux"] + bound,
                  f"{arch} moe_aux: {err} > {1e-3 * c['moe_aux'] + bound}")
        paths = _flatten_with_paths(cs.params.tree())[0]
        keep = [j for j, p in enumerate(paths)
                if not (low and p.startswith("layers/moe"))]
        worst = {}
        for what, g, w in (("mu", gs.opt.mu, cs.opt.mu),
                           ("nu", gs.opt.nu, cs.opt.nu)):
            g, w = host_leaves(g), host_leaves(w)
            worst[what] = leaf_close([g[j] for j in keep],
                                     [w[j] for j in keep],
                                     [paths[j] for j in keep], TRAIN_REL,
                                     TRAIN_COS, f"{arch} {what}")
        lr, flips, n = c["lr"], 0, 0
        for p, a, b, ma, mb in zip(paths, host_leaves(gs.params),
                                   host_leaves(cs.params),
                                   host_leaves(gs.opt.mu),
                                   host_leaves(cs.opt.mu)):
            d = np.abs(a - b)
            ulps = 2 * np.spacing(np.abs(b))
            sure = ((np.sign(ma) == np.sign(mb)) & (np.abs(ma) > 1e-5)
                    & (np.abs(mb) > 1e-5))
            check(bool((d[sure] <= lr * 1e-3 + ulps[sure]).all()),
                  f"{arch} {p}: new params differ where the step is sure")
            check(bool((d <= 2 * lr + ulps).all()),
                  f"{arch} {p}: new params differ by more than 2 lr")
            flips += int((np.sign(ma) != np.sign(mb)).sum())
            n += ma.size
        out[arch] = {"loss_card": m["loss"], "loss_cpu": c["loss"],
                     "loss_after": after, "grad_norm_card": m["grad_norm"],
                     "grad_norm_cpu": c["grad_norm"], "mu_worst": worst["mu"],
                     "nu_worst": worst["nu"], "sign_flips": flips / n,
                     "moe_rows_not_sure": low if cfg.family == "moe"
                     else None}
        log(f"train reduced ({arch}, {cfg.family}): loss card {m['loss']:.6f}"
            f" cpu {c['loss']:.6f} -> {after:.6f} after the step; grad norm "
            f"{m['grad_norm']:.5f} / {c['grad_norm']:.5f}; moments worst rel "
            f"{max(worst['mu'][0], worst['nu'][0]):.4f}, cos "
            f"{min(worst['mu'][1], worst['nu'][1]):.5f}; first-moment signs "
            f"differ at {flips / n:.4%} of the elements"
            + (f"; MoE rows not sure {low}" if cfg.family == "moe" else ""))
        del card, gs, cs
    report["train_reduced"] = out


def clone_state(state):
    from repro_torch.optim.adamw import tree_leaves
    return [x.detach().clone() for x in (
        tree_leaves(state.params) + tree_leaves(state.opt.mu)
        + tree_leaves(state.opt.nu))] + [state.opt.step.clone()]


@torch.no_grad()
def restore_state(state, saved):
    from repro_torch.optim.adamw import AdamWState, tree_leaves
    from repro_torch.train.step import TrainState
    mine = (tree_leaves(state.params) + tree_leaves(state.opt.mu)
            + tree_leaves(state.opt.nu))
    torch._foreach_copy_(mine, saved[:-1])
    return TrainState(state.params, AdamWState(
        saved[-1].clone(), state.opt.mu, state.opt.nu))


def timed_step(step_fn, state, batch):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    state, metrics = step_fn(state, batch[0], batch[1],
                             frontend_inputs=batch[2])
    e.record()
    return state, metrics, (s, e)


def phase_train_smollm(dev, report, card: str):
    """smollm-360m at full width (32 layers, d 960, vocab 49,152), B = 4
    sequences of 4,096 ``TokenPipeline`` tokens (the train_4k shape's
    length; its global batch 256 cut to 4), 4 steps at remat=True: every
    loss and grad norm finite, the last two losses below the first two;
    then one more step from the same state and batch at each remat mode:
    the loss bitwise remat=True's, the new params within
    ``TRAIN_REMAT_REL``; step ms (CUDA events), tokens/s and each mode's
    peak above the held state."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train.step import TrainState, make_train_step
    cfg = get_arch(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, n, norms, init_s = serve_params(cfg, 0, dev)
    state = TrainState(params, adamw_init(params))
    steps = {r: make_train_step(cfg, remat=r, **TRAIN_FULL_KW)
             for r in (True, False, "dots")}
    kernels.reset_launch_counts()
    metrics, events = [], []
    for i in range(TRAIN_STEPS):
        batch = train_batch(cfg, TRAIN_B, TRAIN_L, i, dev)
        state, m, ev = timed_step(steps[True], state, batch)
        metrics.append(m)
        events.append(ev)
    torch.cuda.synchronize()
    peak_steps = (torch.cuda.max_memory_allocated() - base) / 1e9
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(all(np.isfinite(losses + gnorms)),
          f"smollm training: losses {losses}, grad norms {gnorms}")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]),
          f"smollm training: loss did not fall: {losses}")
    # one more step from the same state and batch at each remat mode
    saved = clone_state(state)
    p8 = saved[:len(tree_leaves(params))]
    batch = train_batch(cfg, TRAIN_B, TRAIN_L, TRAIN_STEPS, dev)
    modes, diffs, want = {}, {}, None
    for r in (True, False, "dots"):
        state = restore_state(state, saved)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        state, m, (s, e) = timed_step(steps[r], state, batch)
        torch.cuda.synchronize()
        modes[r] = {"loss": m["loss"].clone(), "lr": float(m["lr"]),
                    "ms": s.elapsed_time(e),
                    "peak_gb": (torch.cuda.max_memory_allocated() - held)
                    / 1e9, "held_gb": held / 1e9}
        got = tree_leaves(state.params)
        if r is True:
            want = [x.detach().clone() for x in got]
            continue
        check(torch.equal(modes[r]["loss"], modes[True]["loss"]),
              f"remat={r!r}: loss {float(modes[r]['loss'])} is not "
              f"remat=True's {float(modes[True]['loss'])} bitwise")
        worst, top, same = 0.0, 0.0, True
        for a, b, p0 in zip(got, want, p8):
            a = a.detach()
            ua, ub = (a - p0).double(), (b - p0).double()
            nb = float(ub.norm())
            rel = float((ua - ub).norm()) / nb if nb else 0.0
            worst = max(worst, rel)
            top = max(top, float((a - b).abs().max()))
            same = same and torch.equal(a, b)
        lr = modes[True]["lr"]
        check(worst <= TRAIN_REMAT_REL, f"remat={r!r}: a leaf's update "
                                        f"{worst} from remat=True's")
        check(top <= 2 * lr * (1 + 1e-3) + 1e-6,
              f"remat={r!r}: an element {top} from remat=True's")
        diffs[r] = {"update_rel": worst, "max_abs": top, "bitwise": same}
    del want
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"training launched {launched}")
    lr = modes[True]["lr"]
    tok = TRAIN_B * TRAIN_L
    steady = ms[1:]
    res = {"params": n, "init_s": init_s, "losses": losses,
           "grad_norms": gnorms, "step_ms": ms,
           "step_ms_mean": sum(steady) / len(steady),
           "tokens_per_s": tok / (sum(steady) / len(steady) / 1e3),
           "peak_gb_train_steps": peak_steps,
           "remat": {str(r): {k: v for k, v in d.items() if k != "loss"}
                     | {"loss": float(d["loss"])} for r, d in modes.items()},
           "remat_vs_true": {str(r): d for r, d in diffs.items()},
           "card": card}
    report["train_smollm"] = res
    log(f"train ({TRAIN_ARCH} full: 32 layers, d 960, vocab 49152; {n} "
        f"parameters; init {init_s:.2f} s): B {TRAIN_B} x L {TRAIN_L}, "
        f"{TRAIN_STEPS} steps at remat=True: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.3f}" for x in gnorms) + "; step ms "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" (mean after the first {res['step_ms_mean']:.1f}, "
          f"{res['tokens_per_s']:.0f} tokens/s); peak {peak_steps:.3f} GB "
          f"({card})")
    for r, d in modes.items():
        extra = "" if r is True else (
            f"; loss bitwise remat=True's, params: update rel "
            f"{diffs[r]['update_rel']:.3g}, max |diff| "
            f"{diffs[r]['max_abs']:.3g} (lr {lr:.3g}), bitwise "
            f"{diffs[r]['bitwise']}")
        log(f"train ({TRAIN_ARCH}) step {TRAIN_STEPS + 1} at remat={r!r}: "
            f"{d['ms']:.1f} ms, loss {float(d['loss']):.6f}, peak "
            f"{d['peak_gb']:.3f} GB above the {d['held_gb']:.3f} GB held"
            + extra)
    del params, state, saved, p8, modes, steps
    torch.cuda.empty_cache()


def phase_train_zamba(dev, report, card: str):
    """zamba2-1.2b at full width (38 Mamba-2 layers, d 2048, the shared
    attention block after every 6th), B = 2 x 2,048, 2 steps at remat=True:
    losses and grad norms finite; after the first step the shared block's
    first moments (0.1 x its clipped gradient, the sum over its 6 uses)
    finite and non-zero in every leaf; step ms and peak."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState, make_train_step
    cfg = get_arch(ZAMBA_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = tf.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    n = sum(p.numel() for p in params.parameters())
    state = TrainState(params, adamw_init(params))
    step = make_train_step(cfg, **TRAIN_FULL_KW)
    kernels.reset_launch_counts()
    out, shared = [], None
    for i in range(ZAMBA_STEPS):
        batch = train_batch(cfg, ZAMBA_B, ZAMBA_L, i, dev, seed=2)
        state, m, ev = timed_step(step, state, batch)
        if i == 0:
            shared = {k: (float(v.norm()), bool(torch.isfinite(v).all()))
                      for k, v in zip(*_flatten_with_paths(
                          state.opt.mu["shared_attn"]))}
        out.append((float(m["loss"]), float(m["grad_norm"]), ev))
    torch.cuda.synchronize()
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"zamba2 training launched {launched}")
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    check(all(np.isfinite([lo, g]).all() for lo, g, _ in out),
          f"zamba2: {[(lo, g) for lo, g, _ in out]}")
    check(all(fin and nrm > 0 for nrm, fin in shared.values()),
          f"zamba2: the shared block's gradient: {shared}")
    ms = [s.elapsed_time(e) for _, _, (s, e) in out]
    report["train_zamba"] = {"params": n, "losses": [o[0] for o in out],
                             "grad_norms": [o[1] for o in out],
                             "step_ms": ms, "peak_gb": peak,
                             "shared_mu_norms": {k: v[0] for k, v in
                                                 shared.items()},
                             "card": card}
    log(f"train ({ZAMBA_ARCH} full: 38 layers, d 2048, the shared block "
        f"every 6; {n} parameters): B {ZAMBA_B} x L {ZAMBA_L}, remat=True: "
        f"losses " + ", ".join(f"{o[0]:.4f}" for o in out)
        + "; grad norms " + ", ".join(f"{o[1]:.3f}" for o in out)
        + "; step ms " + ", ".join(f"{x:.1f}" for x in ms)
        + f"; the shared block's first moments finite and non-zero in all "
          f"{len(shared)} leaves (smallest norm "
          f"{min(v[0] for v in shared.values()):.3g}); peak {peak:.3f} GB "
          f"({card})")
    del params, state
    torch.cuda.empty_cache()


def phase_train_launcher(report):
    """The port's training launcher in this process, twice: ``--arch
    smollm-360m --full --steps 10 --batch 8 --seq 512 --ckpt-every 5
    --device cuda`` into a fresh directory, then the same with ``--steps
    15 --resume``: the second logs ``resumed from step 10`` and trains 5
    steps; every loss finite."""
    import math
    import tempfile
    from repro_torch import kernels
    from repro_torch.launch import train as launcher
    walls = []
    with LogLines("repro_torch") as lines:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as d:
            argv = ["--arch", TRAIN_ARCH, "--full", "--batch", "8", "--seq",
                    "512", "--ckpt-dir", d, "--ckpt-every", "5",
                    "--device", "cuda"]
            kernels.reset_launch_counts()
            runs = []
            for extra in (["--steps", "10"], ["--steps", "15", "--resume"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs.append(launcher.main(argv + extra))
                walls.append(time.perf_counter() - t0)
            disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                       if f.is_file()) / 1e9
    launched = {k: c for k, c in kernels.LAUNCHES.items() if c}
    check(not launched, f"the training launcher launched {launched}")
    check([len(r) for r in runs] == [10, 5],
          f"launcher: {[len(r) for r in runs]} steps, want 10 then 5")
    check(all(math.isfinite(x) for r in runs for x in r),
          f"launcher: losses {runs}")
    check("resumed from step 10" in lines,
          "launcher: the second run did not log 'resumed from step 10'")
    verdicts = [x for x in lines if "->" in x]
    report["train_launcher"] = {"walls_s": walls, "losses": runs,
                                "verdicts": verdicts, "disk_gb": disk}
    log(f"train launcher (--arch {TRAIN_ARCH} --full --batch 8 --seq 512, "
        f"--ckpt-every 5): 10 steps in {walls[0]:.2f} s, then --steps 15 "
        f"--resume ('resumed from step 10') in {walls[1]:.2f} s (init, "
        f"checkpoints included; {disk:.2f} GB on disk at the end); "
        + "; ".join(verdicts))


def phase_train(dev, report, card: str):
    """The LM training path (no TPU kernel lies on it, and the reference
    has no backward kernel: no custom kernel launches here)."""
    phase_train_reduced(dev, report)
    phase_train_smollm(dev, report, card)
    phase_train_zamba(dev, report, card)
    phase_train_launcher(report)


# ---------------------------------------------------------------------------
# The distributed LM on the card
# ---------------------------------------------------------------------------

# qwen2-moe-a2.7b at full width, its depth cut from 24 to 2 layers: every
# rank holds the global f32 parameters (the reference's global view), 7 GB
# at 2 layers; B = 4 requests (2 per data shard) of 1,024 prompt tokens,
# 16 greedy decode steps
LM_MESH_ARCH, LM_MESH_LAYERS = "qwen2-moe-a2.7b", 2
LM_MESH_B, LM_MESH_L, LM_MESH_STEPS = 4, 1024, 16
LM_MESH_AXES = ("data", "model")
LM_MESH_DP = ("data",)
# the int8 dispatch against the bf16 one: tests/test_moe_ep.py's bound
LM_MESH_INT8_REL = 0.05
# the (step, row) logits of the mesh run that may lie beyond SERVE_ULPS of
# one device's at a margin too low to hold their token: at most one in 8
# of the 68.  Past layer 0 the inputs differ by roundings (the shared
# experts' halves sum through a psum), and a row whose k-th and (k+1)-th
# router probabilities are that close may route otherwise; a broken
# exchange moves every row (the EP path itself is held by
# lm_mesh_ep_check)
LM_MESH_LOW_MAX = 8
# training on the mesh: each MoE family reduced (full width cannot train
# here: four ranks each holding the global params, grads and two moments
# need about 21 GB a rank even at one layer)
LM_MESH_TRAIN = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")
# the pipeline: smollm-360m's 32 layers at full width, 4 stages of 8 on
# (pod, data) = (4, 1), 4 microbatches of B = 8 x 512
PIPE_ARCH, PIPE_STAGES, PIPE_B, PIPE_L, PIPE_MICRO = (
    "smollm-360m", 4, 8, 512, 4)
# each stage's gradient against autograd through the sequential
# composition, relative L2 a leaf: the forward is bitwise; the backward
# sums the same per-microbatch products in another order, and the output
# cotangent passes the masked psum's transpose (divided by the 4 stages in
# bf16, summed back in rank order: a bf16 rounding, 2**-8 relative)
PIPE_GRAD_REL = 2.0 ** -6


def digest(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (bitwise equality across
    ranks without sending the tensors)."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()


@contextlib.contextmanager
def recorded_calls(module, name: str, seen: list):
    """Record every call of ``module.name`` as ``(args, outputs)`` (the
    first positional argument and the outputs, detached)."""
    real = getattr(module, name)

    def rec(*a, **kw):
        out = real(*a, **kw)
        seen.append((a[1].detach(), tuple(o.detach() for o in out)))
        return out
    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, real)


def lm_mesh_serve_run(comm, params, cfg, tokens, steps: int):
    """``prefill_step`` and ``steps`` greedy ``decode_step`` calls with
    ``mesh=`` on this rank, into a cache of ``LM_MESH_L + LM_MESH_STEPS``
    positions (the same for every run: the attention's shapes, hence its
    roundings, follow the cache's length): the logits of each (on the
    card), the tokens, each call's MoE layers' (input, (y, aux, dropped))
    (``seen[step][layer]``), the collectives' statistics of each, the
    CUDA-event ms of each call, and the launches (zeroed just before, read
    just after)."""
    from repro_torch import kernels
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import decode_step, prefill_step
    dev = tokens.device
    B, L = tokens.shape
    cache = tf.init_cache(cfg, B, LM_MESH_L + LM_MESH_STEPS, device=dev)
    seen, stats, ms = [], {}, []
    comm.timing = True
    kernels.reset_launch_counts()
    for i in range(steps + 1):
        comm.reset_stats()
        comm.phase = "prefill" if i == 0 else "decode"
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        step = []
        with recorded_calls(moe, "moe_ffn_shard_map", step):
            s.record()
            if i == 0:
                logits, cache = prefill_step(params, tokens, cache, cfg,
                                             mesh=comm.mesh,
                                             dp_axes=LM_MESH_DP)
                rows, toks = [], []
            else:
                logits, cache = decode_step(params, toks[-1][:, None],
                                            cache, L + i - 1, cfg,
                                            mesh=comm.mesh,
                                            dp_axes=LM_MESH_DP)
            e.record()
        seen.append(step)
        rows.append(logits)
        toks.append(logits.argmax(-1).to(torch.int32))
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
        for k, v in comm.stats.items():
            row = stats.setdefault(k, [0, 0, 0.0])
            for j in range(3):
                row[j] += v[j]
    comm.timing = False
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    check(not launched, f"lm mesh serving launched {launched}")
    return dict(rows=rows, toks=toks, seen=seen, stats=stats, ms=ms,
                cache=cache)


def lm_mesh_oracle(params, cfg, tokens, run, d: int, B_d: int):
    """Data shard ``d``'s requests alone through ``prefill_step`` /
    ``decode_step`` without a mesh (fed the mesh run's tokens).  At every
    step each row's logits lie within ``SERVE_ULPS`` of the mesh run's, or
    else its token follows the margin rule (the mesh run's greedy token
    is the oracle's argmax wherever the oracle's top-1 / top-2 gap exceeds
    twice the row's largest difference).  Per MoE layer of the prefill:
    whether its input equals the mesh run's bitwise, and its dropped
    slots."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serve.engine import decode_step, prefill_step
    L = tokens.shape[1]
    sl = slice(d * B_d, (d + 1) * B_d)
    steps = len(run["rows"]) - 1
    cache = tf.init_cache(cfg, B_d, LM_MESH_L + LM_MESH_STEPS,
                          device=tokens.device)
    seen = []
    with recorded_calls(moe, "moe_ffn", seen):
        logits, cache = prefill_step(params, tokens[sl], cache, cfg)
    worst, within, sure, low = 0.0, 0, 0, 0
    for i in range(steps + 1):
        if i:
            logits, cache = decode_step(params, run["toks"][i - 1][sl, None],
                                        cache, L + i - 1, cfg)
        for b in range(B_d):
            want = logits[b]
            err = float((run["rows"][i][sl][b] - want).abs().max())
            worst = max(worst, err)
            if err <= ulps_tol(want):
                within += 1
            elif top_gap(want) > 2 * err:
                check(int(want.argmax()) == int(run["toks"][i][sl][b]),
                      f"lm mesh shard {d} step {i} row {b}: token differs "
                      f"at a sure margin (logits {err} apart)")
                sure += 1
            else:
                low += 1
    n_slots = B_d * L * cfg.moe.top_k
    layers = [dict(h_bitwise=torch.equal(h, mh[sl]),
                   dropped_slots=round(float(o[2]) * n_slots))
              for (h, o), (mh, _) in zip(seen, run["seen"][0])]
    return dict(worst=worst, within=within, sure=sure, low=low,
                layers=layers)


def lm_mesh_ep_check(params, cfg, run, n_dp: int, m: int) -> dict:
    """Every MoE call of the mesh run (each step, each layer) against the
    port's local ``moe_ffn`` on each data shard's block of the same
    recorded input, on this card.  The shard's routing and capacity are
    its own, so the dropped slots and aux equal bitwise (the mesh's
    ``pmean``: the ranks' values summed in rank order, then divided), and
    y lies row by row within ``SERVE_ULPS`` bf16 ulps of the row's
    largest |y|: only roundings differ (each rank's expert GEMMs run
    [E / m, m C] rows instead of [E, C]; the shared experts' column halves
    sum through a ``psum``).  A wrong regrouping, expert slice or combine
    moves y by its own size.  Returns the worst row's error in those ulps,
    the rows and calls compared, and the prefill's dropped slots (mesh,
    local)."""
    from repro_torch.models import moe
    layers = params["layers"]["moe"].tree()
    worst, n_rows, n_calls, prefill_slots = 0.0, 0, 0, []
    for i, step in enumerate(run["seen"]):
        for l, (x, (y, aux, drop)) in enumerate(step):
            p = {k: v[l].detach() for k, v in layers.items()}
            B_d, L, D = x.shape[0] // n_dp, x.shape[1], x.shape[2]
            n_slots = B_d * L * cfg.moe.top_k
            auxes, drops, slots = [], [], 0
            for d in range(n_dp):
                sl = slice(d * B_d, (d + 1) * B_d)
                with torch.no_grad():
                    yl, al, dl = moe.moe_ffn(p, x[sl], cfg.moe)
                got = y[sl].float().reshape(-1, D)
                want = yl.float().reshape(-1, D)
                err = (got - want).abs().amax(-1)
                ulp = torch.exp2(torch.floor(torch.log2(
                    want.abs().amax(-1))) - 7)
                ratio = torch.where(err == 0, torch.zeros_like(err),
                                    err / ulp)
                r = float(ratio.max())
                check(r <= SERVE_ULPS,
                      f"lm mesh EP step {i} layer {l} shard {d}: y "
                      f"{r:.3g} bf16 ulps off the local moe_ffn's "
                      f"(> {SERVE_ULPS}; max |diff| {float(err.max())})")
                worst = max(worst, r)
                n_rows += got.shape[0]
                auxes += [al] * m
                drops += [dl] * m
                slots += round(float(dl) * n_slots)
            for what, got, vals in (("aux", aux, auxes),
                                    ("dropped", drop, drops)):
                acc = vals[0]
                for v in vals[1:]:
                    acc = acc + v
                want = acc / len(vals)
                check(torch.equal(got, want),
                      f"lm mesh EP step {i} layer {l}: {what} "
                      f"{float(got)} vs the shards' local {float(want)}")
            n_calls += 1
            if i == 0:
                prefill_slots.append((round(float(drop) * n_slots * n_dp),
                                      slots))
    return dict(worst_ulps=worst, rows=n_rows, calls=n_calls,
                dropped_slots=prefill_slots)


def lm_mesh_serve(comm, dev) -> dict:
    """qwen2-moe-a2.7b at full width on (data, model) = (2, 2): the mesh
    run, every rank's bits, rank 0's one-device oracle per data shard,
    then one prefill with the int8 dispatch."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(get_arch(LM_MESH_ARCH),
                              n_layers=LM_MESH_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = comm.mesh.shape["model"]
    params = tf.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, ep_degree=m)
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_MESH_B, LM_MESH_L)).astype(np.int32)).to(dev)
    # warm the card's libraries and the allocator on a short prompt and
    # one step; untimed
    lm_mesh_serve_run(comm, params, cfg, tokens[:, :64], 1)
    torch.cuda.empty_cache()
    run = lm_mesh_serve_run(comm, params, cfg, tokens, LM_MESH_STEPS)
    out = {"params": n_params, "prefill_ms": run["ms"][0],
           "decode_ms": run["ms"][1:], "stats": run["stats"],
           "digest": digest(run["rows"] + run["toks"]
                            + [v for _, v in sorted(run["cache"].items())]
                            + [o[j] for st in run["seen"] for _, o in st
                               for j in range(3)]),
           "dropped": [float(o[2]) for _, o in run["seen"][0]],
           "aux": [float(o[1]) for _, o in run["seen"][0]]}
    for i, row in enumerate(run["rows"]):
        check(bool(torch.isfinite(row).all()) and row.shape ==
              (LM_MESH_B, cfg.vocab_size), f"lm mesh step {i}: logits")
    n_dp = comm.mesh.shape["data"]
    B_d = LM_MESH_B // n_dp
    if comm.rank == 0:
        out["ep"] = lm_mesh_ep_check(params, cfg, run, n_dp, m)
        oracle = [lm_mesh_oracle(params, cfg, tokens, run, d, B_d)
                  for d in range(n_dp)]
        torch.cuda.empty_cache()
        low = sum(o["low"] for o in oracle)
        check(low <= LM_MESH_LOW_MAX,
              f"lm mesh: {low} (step, row) logits beyond {SERVE_ULPS} ulps "
              f"of one device's at a low margin (> {LM_MESH_LOW_MAX})")
        out["oracle"] = oracle
    # the int8 dispatch: one prefill
    cfg_q = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, quantize_dispatch=True))
    runq = lm_mesh_serve_run(comm, params, cfg_q, tokens, 0)
    check(torch.equal(runq["seen"][0][0][0], run["seen"][0][0][0]),
          "lm mesh int8 dispatch: layer 0's input is not the bf16 run's")
    y, yq = (r["seen"][0][0][1][0].float() for r in (run, runq))
    out["int8_rel"] = float((yq - y).abs().max() / y.abs().max())
    check(out["int8_rel"] < LM_MESH_INT8_REL,
          f"lm mesh int8 dispatch: layer 0 relative error "
          f"{out['int8_rel']} >= {LM_MESH_INT8_REL}")
    out["int8_logits_rel"] = float(
        (runq["rows"][0] - run["rows"][0]).abs().max()
        / run["rows"][0].abs().max())
    out["int8_prefill_ms"] = runq["ms"][0]
    out["int8_stats"] = runq["stats"]
    out["int8_digest"] = digest(runq["rows"])
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, run, runq
    torch.cuda.empty_cache()
    return out


def lm_mesh_train(dev) -> dict:
    """One ``train_step(mesh=, dp_axes=("data",))`` per MoE family,
    reduced, on a (2, 2) mesh of these ranks on the card and again on
    the CPU (the same ranks, a gloo mesh on ``"cpu"``): card against CPU
    within the CPU tests' bounds, MoE choices under the margin rule; no
    custom kernel launched."""
    import copy
    import numpy as np
    from repro_torch import kernels
    from repro_torch.checkpoint.checkpointer import _flatten_with_paths
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import TrainState, train_step
    out = {}
    for i, arch in enumerate(LM_MESH_TRAIN):
        cfg = reduced_config(get_arch(arch))
        base = tf.init_model(cfg, generator=torch.Generator().manual_seed(i),
                             device="cpu", ep_degree=2)
        tok, lab, _ = train_batch(cfg, 4, 32, 0, "cpu", seed=i)
        res = {}
        for where in ("cuda", "cpu"):
            mesh = Mesh((2, 2), "gloo", where, LM_MESH_AXES)
            p = copy.deepcopy(base).to(where)
            state = TrainState(p, adamw_init(p))
            seen = []
            threads = torch.get_num_threads()
            if where == "cpu":
                torch.set_num_threads(2)
            kernels.reset_launch_counts()
            with recorded_calls(moe, "moe_ffn_shard_map", seen):
                state, m = train_step(state, tok.to(where), lab.to(where),
                                      cfg, mesh=mesh, dp_axes=LM_MESH_DP,
                                      **TRAIN_KW)
            torch.set_num_threads(threads)
            launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
            check(not launched, f"{arch} mesh step launched {launched}")
            res[where] = (state, {k: float(v) for k, v in m.items()}, seen)
        (gs, gm, seen), (cs, cm, _) = res["cuda"], res["cpu"]
        check(gm["lr"] == cm["lr"], f"{arch} mesh: lr")
        check(abs(gm["loss"] - cm["loss"]) <= TRAIN_LOSS_TOL,
              f"{arch} mesh: loss card {gm['loss']} cpu {cm['loss']}")
        check(abs(gm["grad_norm"] / cm["grad_norm"] - 1) <= TRAIN_GNORM_REL,
              f"{arch} mesh: grad norm card {gm['grad_norm']} cpu "
              f"{cm['grad_norm']}")
        n_moe = cfg.n_layers - cfg.moe.first_k_dense
        with torch.no_grad():
            bound, low = moe_aux_bound(cfg, base,
                                       [h for h, _ in seen[:n_moe]])
        check(abs(gm["moe_aux"] - cm["moe_aux"])
              <= 1e-3 * cm["moe_aux"] + bound, f"{arch} mesh: moe_aux")
        paths = _flatten_with_paths(cs.params.tree())[0]
        keep = [j for j, p in enumerate(paths)
                if not (low and p.startswith("layers/moe"))]
        worst = {}
        for what, g, w in (("mu", gs.opt.mu, cs.opt.mu),
                           ("nu", gs.opt.nu, cs.opt.nu)):
            g, w = host_leaves(g), host_leaves(w)
            worst[what] = leaf_close([g[j] for j in keep],
                                     [w[j] for j in keep],
                                     [paths[j] for j in keep], TRAIN_REL,
                                     TRAIN_COS, f"{arch} mesh {what}")
        lr = cm["lr"]
        for p, a, b, ma, mb in zip(paths, host_leaves(gs.params),
                                   host_leaves(cs.params),
                                   host_leaves(gs.opt.mu),
                                   host_leaves(cs.opt.mu)):
            d = np.abs(a - b)
            ulps = 2 * np.spacing(np.abs(b))
            sure = ((np.sign(ma) == np.sign(mb)) & (np.abs(ma) > 1e-5)
                    & (np.abs(mb) > 1e-5))
            check(bool((d[sure] <= lr * 1e-3 + ulps[sure]).all())
                  and bool((d <= 2 * lr + ulps).all()),
                  f"{arch} mesh {p}: new params card vs cpu")
        from repro_torch.optim.adamw import tree_leaves
        out[arch] = dict(
            loss_card=gm["loss"], loss_cpu=cm["loss"],
            grad_norm_card=gm["grad_norm"], grad_norm_cpu=cm["grad_norm"],
            aux_card=gm["moe_aux"], aux_cpu=cm["moe_aux"],
            mu_worst=worst["mu"], nu_worst=worst["nu"], rows_not_sure=low,
            digest=digest(tree_leaves(gs.params) + tree_leaves(gs.opt.mu)
                          + tree_leaves(gs.opt.nu)))
    return out


def lm_mesh_pipeline(dev) -> dict:
    """``pipeline_apply`` over smollm-360m's 32 layers at full width, 4
    stages of 8 on (pod, data) = (4, 1), 4 microbatches of B = 8 x 512:
    the forward (no grad), then forward and backward of mean(y**2);
    rank 0 holds the forward bitwise against the sequential composition
    of the same stages over the same microbatches, and each stage's
    gradient within ``PIPE_GRAD_REL`` of autograd through it."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.distributed.mesh import Mesh, comm_for
    from repro_torch.distributed.pipeline import bubble_fraction, \
        pipeline_apply
    from repro_torch.models import layers as Lyr
    from repro_torch.models import transformer as tf
    cfg = get_arch(PIPE_ARCH)
    mesh = Mesh((PIPE_STAGES, 1), "gloo", "cuda", ("pod", "data"))
    comm = comm_for(mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = tf.init_model(cfg, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    per = cfg.n_layers // PIPE_STAGES

    def stages(tree):
        return {k: stages(v) if isinstance(v, dict)
                else v.detach().reshape(PIPE_STAGES, per, *v.shape[1:])
                for k, v in tree.items()}
    stage_params = stages(params.tree()["layers"])
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (PIPE_B, PIPE_L)).astype(np.int32)).to(dev)
    with torch.no_grad():
        x = Lyr.embed(params["embed"], tokens, scale_by_sqrt_d=cfg.embed_scale)
    positions = torch.arange(PIPE_L, dtype=torch.int32, device=dev)
    windows = tf._layer_windows(cfg)

    def stage_fn(p, xb):
        for lp, win in zip(tf._unstack(p), windows):
            xb, _ = tf.dense_block(lp, xb, cfg, positions, win)
        return xb

    fn = pipeline_apply(stage_fn, mesh, stage_axis="pod", n_micro=PIPE_MICRO,
                        data_axes=("data",))
    with torch.no_grad():               # warm: the shapes' first launches
        fn(stage_params, x)
    kernels.reset_launch_counts()
    comm.reset_stats()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    with torch.no_grad():
        y = fn(stage_params, x)
    e.record()
    torch.cuda.synchronize()
    fwd_ms = s.elapsed_time(e)

    def leaves(t):
        return [v for k in sorted(t) for v in (
            leaves(t[k]) if isinstance(t[k], dict) else [t[k]])]

    def with_grad(t):
        return {k: with_grad(v) if isinstance(v, dict)
                else v.clone().requires_grad_() for k, v in t.items()}
    sp = with_grad(stage_params)
    s.record()
    loss = (fn(sp, x).float() ** 2).mean()
    grads = torch.autograd.grad(loss, leaves(sp))
    e.record()
    torch.cuda.synchronize()
    train_ms = s.elapsed_time(e)
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    check(not launched, f"the pipeline launched {launched}")
    out = {"fwd_ms": fwd_ms, "fwd_bwd_ms": train_ms,
           "bubble": bubble_fraction(PIPE_STAGES, PIPE_MICRO),
           "stats": dict(comm.stats), "digest": digest([y, *grads])}
    if comm.rank == 0:
        sq = with_grad(stage_params)

        def seq(p):
            mbs = []
            for mb in x.reshape(PIPE_MICRO, -1, *x.shape[1:]):
                for st in range(PIPE_STAGES):
                    mb = stage_fn(_stage_of(p, st), mb)
                mbs.append(mb)
            return torch.cat(mbs)
        with torch.no_grad():
            check(torch.equal(seq(stage_params), y),
                  "pipeline forward: not bitwise the sequential composition")
        want = torch.autograd.grad((seq(sq).float() ** 2).mean(), leaves(sq))
        rel = [float((g.double() - w.double()).norm() / w.double().norm())
               for g, w in zip(grads, want)]
        check(max(rel) <= PIPE_GRAD_REL, f"pipeline gradients: worst leaf "
                                         f"{max(rel)} > {PIPE_GRAD_REL}")
        out["grad_rel"] = rel
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, stage_params, sp, grads, y
    torch.cuda.empty_cache()
    return out


def _stage_of(tree, st: int):
    return {k: _stage_of(v, st) if isinstance(v, dict) else v[st]
            for k, v in tree.items()}


def lm_mesh_rank() -> dict:
    """One rank of the distributed-LM phase (its parts in order)."""
    from repro_torch.distributed.mesh import current
    dev = torch.device("cuda")
    comm = current()
    t0 = time.perf_counter()
    out = {"serve": lm_mesh_serve(comm, dev)}
    t1 = time.perf_counter()
    out["train"] = lm_mesh_train(dev)
    t2 = time.perf_counter()
    out["pipeline"] = lm_mesh_pipeline(dev)
    out["walls_s"] = [t1 - t0, t2 - t1, time.perf_counter() - t2]
    return out


def phase_lm_mesh(report, card: str):
    """The distributed LM on this card: four gloo ranks, the serving run
    (qwen2-moe-a2.7b at full width on (data, model) = (2, 2) with its
    one-device oracle and the int8 dispatch), the reduced mesh training
    steps against the CPU, and the 32-layer smollm pipeline (module
    docstring)."""
    import threading
    from repro_torch.distributed.mesh import Mesh, spawn
    torch.cuda.empty_cache()
    stop, peak = threading.Event(), [0]
    poll = threading.Thread(target=card_used_peak, args=(stop, peak))
    poll.start()
    t0 = time.perf_counter()
    try:
        ranks = spawn(lm_mesh_rank, Mesh((2, 2), "gloo", "cuda",
                                         LM_MESH_AXES), timeout=900)
    finally:
        stop.set()
        poll.join()
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for part, key in (("serve", "digest"), ("serve", "int8_digest"),
                          ("pipeline", "digest")):
            check(res[part][key] == r0[part][key],
                  f"lm mesh {part}: rank {r}'s {key} differs from rank 0's")
        for arch in LM_MESH_TRAIN:
            check(res["train"][arch]["digest"] == r0["train"][arch]["digest"],
                  f"lm mesh train {arch}: rank {r}'s state differs")
    sv = r0["serve"]
    dec = sv["decode_ms"]
    log(f"lm mesh ({card}; 4 gloo ranks on one card, payloads through host "
        f"memory): phase wall {wall:.1f} s (parts on rank 0: serve "
        f"{r0['walls_s'][0]:.1f}, train {r0['walls_s'][1]:.1f}, pipeline "
        f"{r0['walls_s'][2]:.1f} s); card used peak "
        f"{peak[0] / 1e9:.3f} GB (all processes); no custom kernel launched")
    log(f"lm mesh serve ({LM_MESH_ARCH} full width, {LM_MESH_LAYERS} of 24 "
        f"layers, {sv['params']} parameters a rank; (data, model) = (2, 2), "
        f"30 experts a rank; B {LM_MESH_B} x {LM_MESH_L}, {LM_MESH_STEPS} "
        f"greedy steps): prefill {sv['prefill_ms']:.1f} ms, decode mean "
        f"{sum(dec) / len(dec):.2f} ms a step (min {min(dec):.2f}, max "
        f"{max(dec):.2f}; CUDA events, collectives timed) on rank 0; "
        f"dropped per layer {sv['dropped']}; every rank bitwise equal")
    for d, o in enumerate(sv["oracle"]):
        log(f"  data shard {d} vs its requests alone without a mesh: "
            f"{o['within']} of {o['within'] + o['sure'] + o['low']} "
            f"(step, row) logits within {SERVE_ULPS} ulps, {o['sure']} "
            f"beyond with the token equal at a sure margin, {o['low']} at a "
            f"low margin (<= {LM_MESH_LOW_MAX} in all); max |logit diff| "
            f"{o['worst']:.6g}; per MoE layer of the prefill (input "
            f"bitwise, dropped slots): " + ", ".join(
                f"({x['h_bitwise']}, {x['dropped_slots']})"
                for x in o["layers"]))
    ep = sv["ep"]
    log(f"  EP against the local moe_ffn on each shard's recorded input: "
        f"{ep['calls']} MoE calls ({LM_MESH_STEPS + 1} steps x "
        f"{LM_MESH_LAYERS} layers), {ep['rows']} rows; y worst row "
        f"{ep['worst_ulps']:.3f} bf16 ulps of its largest |y| (<= "
        f"{SERVE_ULPS}); aux and dropped bitwise; the prefill's dropped "
        f"slots per layer (mesh, local) {ep['dropped_slots']}")
    for r, res in enumerate(ranks):
        s = res["serve"]
        log(f"  rank {r}: peak alloc {s['peak_gb']:.3f} GB; collectives "
            "(calls, MB sent, s): " + ", ".join(
                f"{k}=({v[0]}, {v[1] / 1e6:.1f}, {v[2]:.3f})"
                for k, v in sorted(s["stats"].items())))
    bf = sum(v[1] for k, v in sv["stats"].items()
             if k.startswith("prefill.all_to_all"))
    q = sum(v[1] for k, v in sv["int8_stats"].items()
            if k.startswith("prefill.all_to_all"))
    # the return all_to_all stays bf16: the dispatch's bytes are the rest
    ratio = (q - bf / 2) / (bf / 2)
    check(0.45 <= ratio <= 0.55, f"lm mesh int8: dispatch bytes ratio "
                                 f"{ratio}")
    log(f"lm mesh int8 dispatch: prefill {sv['int8_prefill_ms']:.1f} ms; "
        f"layer-0 MoE output within {sv['int8_rel']:.4f} relative of the "
        f"bf16 dispatch's (< {LM_MESH_INT8_REL}), logits "
        f"{sv['int8_logits_rel']:.4f}; all_to_all MB sent a rank "
        f"{q / 1e6:.1f} vs {bf / 1e6:.1f} (dispatch {ratio:.3f} of bf16's)")
    for arch, t in r0["train"].items():
        log(f"lm mesh train ({arch} reduced, (2, 2), card vs CPU ranks): "
            f"loss {t['loss_card']:.6f} / {t['loss_cpu']:.6f}, grad norm "
            f"{t['grad_norm_card']:.5f} / {t['grad_norm_cpu']:.5f}, aux "
            f"{t['aux_card']:.6f} / {t['aux_cpu']:.6f}; moments worst rel "
            f"{max(t['mu_worst'][0], t['nu_worst'][0]):.4f}; rows not sure "
            f"{t['rows_not_sure']}; every rank's new state bitwise equal")
    pp = r0["pipeline"]
    log(f"lm mesh pipeline ({PIPE_ARCH} full width, {PIPE_STAGES} stages "
        f"of 8 layers on (pod, data) = ({PIPE_STAGES}, 1), {PIPE_MICRO} "
        f"microbatches of B {PIPE_B} x {PIPE_L}; bubble {pp['bubble']:.4f}):"
        f" forward {pp['fwd_ms']:.1f} ms, forward + backward "
        f"{pp['fwd_bwd_ms']:.1f} ms on rank 0; forward bitwise the "
        f"sequential composition; stage gradients worst rel "
        f"{max(pp['grad_rel']):.3g} (<= {PIPE_GRAD_REL}); peak "
        f"{pp['peak_gb']:.3f} GB; collectives " + ", ".join(
            f"{k}=({v[0]}, {v[1] / 1e6:.1f}, {v[2]:.3f})"
            for k, v in sorted(pp["stats"].items())))
    report["lm_mesh"] = dict(card=card, wall_s=wall,
                             card_used_peak_bytes=peak[0],
                             ranks=[{k: v for k, v in res.items()}
                                    for res in ranks])


def kernel_name(line: str) -> str | None:
    """The kernel a ptxas ``Function properties for <mangled>`` line is
    about: the ``<length><name>`` of the mangled name that ends in
    ``_kernel`` (its template arguments in their mangled form), or None."""
    mangled = line.split("Function properties for", 1)[1].strip()
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):        # a length may follow digits
            n, at = int(digits[i:]), m.end()
            name = mangled[at:at + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I(\w+?)EE", mangled[at + n:])
                return name + (f"<{t.group(1)}>" if t else "")
    return None


# ptxas' registers and spills of each kernel instantiation, by name (empty
# when the library was already built)
PTXAS: dict[str, str] = {}
# the kernel instantiation each sweeping launcher runs (K4 / K12 launch the
# forward blocks of K7's / K13's kernel, K10 K1's kernel, K11 K2's kernel)
SWEEP_PTXAS = {"stjoin_best_match": "stjoin_best_match_kernel",
               "stjoin_vote_fused": "stjoin_vote_fused_kernel",
               "stjoin_sim_fused": "stjoin_sim_panel_fused_kernel"}
NOT_BUILT = "not built in this run"


def log_ptxas(build_log: str) -> None:
    """One line per kernel from ``nvcc --ptxas-options=-v``: its
    registers and spills (nothing when the library was already built)."""
    name, spill = None, ""
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            PTXAS[name] = f"{line.split(':', 1)[1].strip()}; {spill}"
            log(f"  ptxas: {name}: {PTXAS[name]}")
        elif "error" in line:
            log("  ptxas: " + line.strip())


def k15_kernel(plan, hd: int, dtype) -> str:
    """The ptxas name of the kernel instantiation a K15 plan launches."""
    if plan.path == "general":
        return "attn_general_kernel<" + ("f>" if dtype == torch.float32
                                         else "13__nv_bfloat16>")
    hd_class = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return f"attn_{plan.path}_kernel<Li{hd_class}ELi{plan.keys}>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every number to this file")
    ap.add_argument("--only-distributed", action="store_true",
                    help="build, run the multi-device phase alone and exit "
                         "(no result line)")
    ap.add_argument("--only-tune", action="store_true",
                    help="build, run the autotuner phase alone and exit "
                         "(no result line)")
    ap.add_argument("--only-serve", action="store_true",
                    help="build, run the LM serving phase alone and exit "
                         "(no result line)")
    ap.add_argument("--only-train", action="store_true",
                    help="build, run the LM training phase alone and exit "
                         "(no result line)")
    ap.add_argument("--only-lm-mesh", action="store_true",
                    help="build, run the distributed-LM phase alone and "
                         "exit (no result line)")
    ap.add_argument("--only-examples", action="store_true",
                    help="build, run the examples phase alone and exit "
                         "(no result line)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s into {kernels.build_dir()}")
    if kernels.build_seconds:       # a fresh build: one nvcc per source
        steps = kernels.build_seconds
        log("  build steps (s): " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in steps.items())
            + f"; one after another {sum(steps.values()):.1f}")
    log_ptxas(kernels.build_log)
    report = {"card": card, "build_s": build_s,
              "build_steps_s": kernels.build_seconds}
    only = {"tune": args.only_tune, "serve": args.only_serve,
            "train": args.only_train, "lm_mesh": args.only_lm_mesh,
            "distributed": args.only_distributed,
            "examples": args.only_examples}
    if any(only.values()):
        name = next(k for k, v in only.items() if v)
        if name == "tune":
            phase_tune(dev, report, card)
        elif name == "serve":
            phase_serve(dev, report, card)
        elif name == "train":
            phase_train(dev, report, card)
        elif name == "lm_mesh":
            phase_lm_mesh(report, card)
        elif name == "examples":
            phase_examples(report, card)
        else:
            phase_distributed(report, card)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(report, indent=1) + "\n")
        log(f"{name} phase alone: passed")
        return 0

    walls, last = {}, [time.perf_counter()]

    def mark(name: str) -> None:
        """The wall since the previous mark, under ``name``."""
        now = time.perf_counter()
        walls[name] = now - last[0]
        last[0] = now

    phase_parity(dev)
    phase_parity_fused(dev)
    phase_parity_topk(dev)
    phase_parity_index(dev)
    mark("parity T=512")
    brest_rounds = []
    batch, params, out, launches = phase_main(dev, report, "materialize",
                                              rounds=brest_rounds)
    _, _, fout, flaunches = phase_main(dev, report, "fused")
    same_labels(fout, out, "dsc_brest: fused vs materialize path")
    sim_diff = float((out.sim - fout.sim).abs().max())
    log(f"dsc_brest: fused labels equal the materialize labels; "
        f"max |sim fused - sim materialize| = {sim_diff}")
    _, _, tout, tlaunches = phase_main(dev, report, "fused_topk")
    same_labels(tout, fout, "dsc_brest: fused top-K vs fused dense path")
    same_topk(tout, fout, "dsc_brest: fused top-K")
    check(torch.equal(tout.sscr, fout.sscr), "dsc_brest: top-K sscr")
    log("dsc_brest: fused top-K labels equal the dense fused labels; lists "
        "bitwise topk_from_dense of the dense matrix")
    brest_argv = ["--config", "dsc_brest", "--n-trajs", "4096",
                  "--segmentation", "tsa2"]
    lout = launcher_run(report, "dsc_brest",
                        brest_argv + ["--plan", launcher_plan_file("fused")],
                        fout.result, flaunches)
    launcher_run(report, "dsc_brest_flags",
                 brest_argv + ["--mode", "fused", "--use-kernel",
                               "--seg-use-kernel", "--cluster-use-kernel"],
                 lout.result, flaunches)
    del lout
    phase_stages(dev, report, batch, params,
                 dict(fused=(fout, flaunches), materialize=(out, launches)))
    mark("dsc_brest paths, launcher, stage chain")
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    phase_resilient(dev, report, batch, params, tout, tlaunches)
    alpha, k = phase_stream(dev, report)
    phase_stream_resume(dev, report, alpha, k)
    phase_launcher_exits(dev, report)
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - held
    check(left < 64 << 20, f"the resilient and stream phases left "
                           f"{left / 1e9:.3f} GB allocated on the card")
    mark("resilient, stream, launcher exits")
    join_ids, fplan = plan_index(batch, params, report, "dsc_brest")
    _, sub = phase_index(dev, report, batch, params, "dsc_brest",
                         outs=dict(materialize=out, fused=fout,
                                   fused_topk=tout))
    rows = []
    pw, pi, k1_plain = phase_kernels(batch, params, out, launches, rows,
                                     brest_rounds, report)
    del brest_rounds
    raw = phase_fused_kernels(batch, params, fout, flaunches, pw, pi,
                              k1_plain, rows)
    report["k9_dispatches"] = phase_topk_kernels(batch, params, tout,
                                                 tlaunches, raw, rows)
    del out, fout, tout, pw, pi, raw
    torch.cuda.empty_cache()
    phase_pruned_kernels(batch, params, sub, join_ids, fplan, {}, rows,
                         "dsc_brest", n_plain=1024)
    del join_ids, fplan
    sbatch, _ = brest_batch(4096, dev, sort_by_lane=True)
    name = "dsc_brest_lanes"
    join_ids, fplan = plan_index(sbatch, params, report, name)
    ilaunches, sub = phase_index(dev, report, sbatch, params, name)
    torch.cuda.empty_cache()
    phase_pruned_kernels(sbatch, params, sub, join_ids, fplan, ilaunches,
                         rows, name, n_plain=sbatch.num_trajs)
    del sbatch, join_ids, fplan, sub
    torch.cuda.empty_cache()
    mark("dsc_brest index and kernel checks")
    sis_rounds = []
    sbatch, sparams, sout, slaunches = phase_main(dev, report, "fused",
                                                  n_vessels=8192,
                                                  name="dsc_sis",
                                                  rounds=sis_rounds)
    from repro_torch.core.clustering import visit_order
    srank = visit_order(sout.table)[1]
    k5_rounds(sout.sim, srank, sout.result.alpha_used, sis_rounds,
              "dsc_sis fused", report)
    del sis_rounds
    k6_check(sout.sim, srank, sout.result.is_rep, sout.table.valid,
             sout.result.alpha_used, "dsc_sis fused, final reps", report)
    k16_check(sout.sim, sout.table.valid, "dsc_sis fused", report)
    dense_labels = [getattr(sout.result, f).cpu() for f in LABELS]
    sub, sres = sout.seg.sub_local, sout.result
    del sout
    torch.cuda.empty_cache()
    launcher_run(report, "dsc_sis",
                 ["--config", "dsc_sis", "--n-trajs", "8192",
                  "--segmentation", "tsa2", "--plan",
                  launcher_plan_file("fused")], sres, slaunches)
    del sres
    torch.cuda.empty_cache()
    phase_fused_head(sbatch, sparams, sub, report, "dsc_sis", n_plain=256)
    del sbatch, sub
    torch.cuda.empty_cache()
    _, _, stout, _ = phase_main(dev, report, "fused_topk", n_vessels=8192,
                                name="dsc_sis")
    for f, want in zip(LABELS, dense_labels):
        check(torch.equal(getattr(stout.result, f).cpu(), want),
              f"dsc_sis: fused top-K vs fused dense path: {f} differs")
    log("dsc_sis: fused top-K labels equal the dense fused labels")
    del stout
    torch.cuda.empty_cache()
    mark("dsc_sis")
    phase_s2t(dev)
    phase_lcss(dev, report, rows)
    torch.cuda.empty_cache()
    phase_attention(dev, report, rows)
    torch.cuda.empty_cache()
    mark("s2t, lcss, attention")
    phase_serve(dev, report, card)
    torch.cuda.empty_cache()
    mark("serve")
    phase_train(dev, report, card)
    torch.cuda.empty_cache()
    mark("train")
    phase_lm_mesh(report, card)
    mark("lm_mesh")
    phase_tune(dev, report, card)
    mark("tune")
    phase_distributed(report, card)
    mark("distributed, resilient distributed")
    phase_examples(report, card)
    mark("examples")
    total = time.perf_counter() - t0
    report["phase_walls_s"] = dict(build=build_s, **walls, total=total)
    log(f"smoke walls ({card}): build {build_s:.1f} s, " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; total {total:.1f} s")
    order = list(REPLACES)
    rows.sort(key=lambda r: order.index(r["name"]))
    check(len(rows) == len(REPLACES),
          f"{len(rows)} kernel rows, expected {len(REPLACES)}")
    report["kernels"] = rows
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
