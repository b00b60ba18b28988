#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --b4-parent DIR   # B4 of the checkout DIR against this one's, nothing else

Phases (any failure raises and exits non-zero before the result line):

1. device: require CUDA; print the card's name and power limit;
2. build: compile the four hand-written CUDA kernels (``nvcc``, one
   process per source, in parallel) and print the build seconds and
   ptxas's registers, shared memory and spills of every kernel;
3. kernels against their plain versions on the card, bit for bit, at
   d in {997, 40522, 118282} and M in {1, 5, 100, 300}, and at ResNet-18's
   d = 11,172,042 with M in {1, 8}, plus the
   padded-tail poison case and theta_hat against the Eq.-13 estimate of
   the vote counts; then ``bit_aggregate`` at d = 997 for M from 1 to
   150,001 (random, all-ones and all-zeros wires) and at M = 10,000 with
   d = 118,282, writing nothing at or beyond n; ``prox_sgd`` at d = 0, 1,
   2 and 3 (mod 4) and M in {1, 7, 100}, with w0 shared and full, out of
   place and in place (``out=``), at the geometries of B4_GEOMETRIES, on
   its scalar path and on arrays off their 16-byte boundaries; and every
   kernel in its batched form, one launch for a group of E in {1, 3, 8}
   runs, each with its own range b, w0 row and coefficients (B4 also at
   ResNet-18's width with 3 rows a run, which its row groups do not divide);
   and B1 through ``ops.quant_pack_u`` on top-k row sets (k = 11,828 and 99,
   not multiples of 8, one b row a client), and the sparse compressor's
   kernel wire against its plain one; and the single-client entries
   ``kernels.stoch_quant_compress`` / ``stoch_quant_pack`` (B1; B2 with a
   residual given or wanted) at d in SINGLE_CLIENT_D;
4. main path: ``FLSimulation`` with probit_plus, dynamic b and the kernels,
   on the paper's MLP at its default width (hidden 128, d = 118,282) with
   100 clients, 3 rounds in each of four variants: (a) plain, (b) error
   feedback, (c) 30% sign_flip Byzantines, (d) 30% bit_flip Byzantines.
   Each variant's launch counts are zeroed just before it and read just
   after, and must equal its own expected counts (per round: one
   ``stoch_quant_pack``, or one ``stoch_quant_ef`` with error feedback,
   one ``bit_aggregate`` and one ``prox_sgd`` per local step); every kernel
   must have run. Then (a) again with ``engine="ref"`` (the plain versions,
   on the card): every round's theta_hat, loss and b must equal the kernel
   run exactly;
4b. Byzantine grid (the paper's Table I, ``benchmarks/table1_byzantine.py``)
   at the main path's width with the kernels, fixed b and 10% Byzantines:
   probit_plus under gaussian, alie and ipm; signsgd_mv, rsa, fedavg and
   fed_gm under gaussian, sign_flip, zero_gradient and sample_duplicate;
   probit_plus with oracle b and with half participation. Each run's launch
   counts are zeroed just before it and must equal its own expected counts
   (the baselines launch only ``prox_sgd``), every round must equal its
   ``engine="ref"`` rerun exactly, theta_hat must keep its scheme's bound
   (PRoBit+ ``|theta_i| <= b_i``, signSGD-MV ``|theta_i|`` in {0, step},
   RSA ``|theta_i| <= step * M``) and every loss must be finite; each run
   prints its round wall times and final accuracy. ``prng.normal`` and
   ``prng.choice`` on the card must equal their CPU results bit for bit;
4c. vision: the paper's image models through the same round (probit_plus,
   dynamic b, the kernels) on ``make_image_classification`` data with the
   main path's cohort: ``cnn16-m100`` (``init_cnn`` at its defaults, 28x28x1,
   d = 206,874) in variants (a) and (b), and ``resnet18w64-m100``
   (``init_resnet(width=64)``, ResNet-18's blocks, 32x32x3, d = 11,172,042)
   in (a). Each run has its own launch counts (those of phase 4), equals
   its ``engine="ref"`` rerun in theta_hat, loss and b in every round, has
   finite losses, and prints its round wall times, peak device memory, d,
   wire row bytes and accuracy;
4d. asynchronous and streamed rounds (ASYNC_STREAM) on the main path's MLP
   and cohort: (e) a buffer of 100, zero latency and decay, which must equal
   (a) bit for bit in every round; (f) a buffer of 50, latency 1, decay 0.5
   and 10% straggler+sign_flip Byzantines, printing buf_fill and mean_age;
   (g) streamed in chunks of 25 (theta and b equal to (a)'s, the count of
   differing coordinates printed) and (g1) in one chunk (equal to (a)). Then
   ``resnet18w64-m300-stream``: ResNet-18 at full width, 300 stateless
   clients streamed 50 at a time, 1 round (2 before phase 7's grid (i1)
   of wire and tree groups), printing its peak memory beside
   the dense round's, reckoned from 4c's peak at 100 clients. Each run has
   its own launch counts (B1 once a chunk, B4 once a local step of each
   chunk, B3 never) and equals its ``engine="ref"`` rerun in every round;
5. times: each kernel at the shapes of (a) and at ResNet-18's (M = 100,
   d = 11,172,042) against its plain version, its
   byte bound and the card's measured copy bandwidth; then
   ``bit_aggregate`` at d = 118,282 and M from 100 to 10,000, through the
   wrapper and at every cluster size, beside the time of an empty kernel
   launched the same way, and the SASS instructions of its counting loop;
   ``prox_sgd`` (in place, as the round runs it) from d = 118,282 to
   11,172,042 and at M * d ~ 1.1e9 with 1,000 and 10,000 clients, beside
   PyTorch's fused SGD on the same tensors, and at both main shapes every
   candidate geometry of ``b4_candidates`` and the old out-of-place call;
   B1 at the top-k wire's shape (M = 100 rows of k = 11,828 values);
   B1 and B2 on one client's row at d = 118,282 and 11,172,042, the kernel
   alone and the whole single-client entry (its Threefry draw included);
   and the grid's plain-torch stages (FedAvg, Fed-GM's 16 Weiszfeld steps,
   the sign wire and its counts, the oracle range, the gaussian attack's
   draw) at the main path's shapes, each as device time (one call captured
   in a CUDA graph and replayed) and as eager stream time;
7. campaign (``repro_torch.sim``, phase 7) on the main path's MLP with the
   kernels, 3 rounds: (h) Table I's 28 cells (4 attacks x 7 methods, the
   async row included) and (i) Fig. 4's 11 cells (fused M-sweeps of PRoBit+
   and FedAvg, eps at M = 20), each over seeds 0 and 1, (i1) phase 8's
   (k) 2-bit wire, (l-dp) 4-bit wire under DP, (m) mixed widths, (n-ef)
   top-k with error feedback, and its (o) sum, (o-med) median and (o-buf)
   buffered trees, each a group of seeds 0 and 1 at the main path's
   cohort, and (j) (a) with seeds 0-7 as one group of 8 runs. Each grid
   runs through ``run_campaign`` (launch counts zeroed just before, read
   just after); each group's prepared runner again, with its own launch
   counts and seconds (one B1 a round, one B3 a round unless masked or
   asynchronous, one B4 a local step for a whole group; Table I's
   asynchronous row runs as one group; each (i1) group launches one run's
   phase-8 counts, once for the group, and prints its ``wall_s`` beside
   its runs' sequential seconds), equal to the
   campaign's trajectories and to its
   ``engine="ref"`` rerun exactly; every run against its sequential
   ``FLSimulation`` run (b exact, loss within rtol 1e-6, accuracy within
   1e-6), counting the runs equal bit for bit. (j) also reports its steady
   round time, peak memory and nvidia-smi busy share beside the
   sequential runs'; first, whether a run's gradient among a group's rows
   equals its own (``campaign_model_rows``). It runs between phases 4d and
   5, and phase 5 also times each kernel's batched call at E = 8, M = 100;
8. wires and trees (WIRES_TREES, after phase 7), on the main path's MLP
   and cohort, 3 rounds: the 2- and 4-bit wires, the 4-bit wire under DP
   (randomized response; the rr_gamma range printed), mixed widths and all
   one bit (``client_bits``, without the kernels), top-k with and without
   error feedback, and the count trees: a sum tree of 4 edges in chunks of
   25 (equal to 4d's (g) in theta and b), median and trimmed merges and a
   buffered root, each under a Byzantine edge, and the sum tree on the
   4-bit wire. Each run has its own launch counts (B4 a local step of each
   chunk, B1 once a chunk on the one-bit wire and once a round on the top-k
   wire, never on the k-bit wire; B3 never) and equals its
   ``engine="ref"`` rerun in every round; each prints its round times, its
   wire bytes a row and its peak memory (the ``"phase": "wires_trees"``
   lines);
9. lm (after phase 8): ``repro_torch.launch.train``'s set-up, batches and
   step at qwen2-1.5b's published width (28 layers, d_model 1,536, vocab
   151,936; 15 leaves, d = 1,777,088,000; random weights from the port's
   Threefry) with the trainer's defaults (4 clients, 2 local steps of 2
   sequences of 128 tokens): (p) PRoBit+ on the kernel wire for 1 round
   (3 before phase 10 was added, 2 before phase 13: the 1,000 s ceiling;
   (r) covers a second round at full width), one B1 a (client, leaf) and
   one B3 a leaf each round (60 and 15), every
   round equal to its ``engine="ref"`` step on the same inputs (new
   parameters bit for bit, b and both losses exact), its wire ~1/32 of f32;
   (p16) the 16-bit draws and (p-avg) FedAvg, one round each, launching
   nothing. Each prints its round seconds, peak memory, wire bytes (packed,
   ideal, int8, f32), init seconds, the busy share nvidia-smi reads over
   its last round and its next-to-last round's stream ms by stage (the
   only round's in a one-round run: forward and backward, local update,
   compress, estimate). Then (q): ``aggregate_pytree`` with error feedback on
   the reduced qwen2 (B2 and B3 once a leaf a round), two rounds, equal to
   ``stream_aggregate_pytree`` in chunks of 2 and to ``engine="ref"``
   (the ``"phase": "lm"`` lines). Then the MoE and xLSTM families, each
   two rounds of PRoBit+ on the kernel wire beside their ``engine="ref"``
   steps ((s) one round since phase 7's grid (i1) of wire and tree
   groups), with the same clients and local steps: (r) Qwen3-30B-A3B at its
   published widths (d_model 2,048, 128 experts, top-8, expert width 768,
   vocab 151,936) cut to 2 of its 48 layers (13 leaves, d =
   1,868,572,672; B1 104, B3 26; 4 layers until phase 12 took the time;
   its round 0 is kept for phase 12), and (s) xLSTM-350M at its published
   widths cut to 8 of its 24 layers, one 7:1 pattern of mLSTM and sLSTM
   blocks (92 leaves, d = 241,634,360; whole until phase 11 took the time)
   at 512 tokens a sequence, so the mLSTM carries its state across two
   chunks of 256 (B1 368, B3 92). Then the
   Mamba hybrid and the frontends (ROADMAP A12c, A12e), the same way: (t)
   HuBERT-XLarge whole (48 layers, non-causal, layernorm, tanh-GELU, the
   encoder-only head; 15 leaves, d = 945,258,240) on the trainer's stub of
   128 frames, all masked, 1 round (B1 60, B3 15; 2 rounds until PR 24's
   phase 12); (u) Pixtral-12B at its
   published widths (d_model 5,120, 32/8 heads of 128, d_ff 14,336, vocab
   131,072) cut to 2 of its 40 layers (13 leaves, d = 1,913,676,800 with
   the projector), 1,024 stub patches before 1,024 tokens, 1 round (B1 52,
   B3 13); (v) Jamba-1.5-Large at its published widths (d_model 8,192,
   Mamba d_in 16,384, d_state 16, dt_rank 512; NoPE attention, 64/8
   heads; d_ff 24,576) cut to the pattern (mamba, attn), 2 of its 72 layers
   and 2 of its 16 experts, top-2 kept (27 leaves, d = 3,457,064,960), at
   512 tokens, so the Mamba scan carries its state across two chunks of
   256, 1 round (B1 108, B3 27). The rounds run without the unit
   checkpoint (the trainer's ``--remat`` off); after (p), (r) and (t)
   (REMAT_PROBE) one client's forward alone and its forward and backward
   with and without the checkpoint are timed, their gradients bit for bit
   (``remat_probe`` in the line). Phase 5 then times B1 and B3 at
   qwen2-1.5b's largest leaf and at the MoE's, ``blocks[0].ffn.w1`` of (r)
   (``kernels_at_lm_leaf``,
   ``kernels_at_lm_moe_leaf``; ``at_lm_leaf`` and ``at_lm_moe_leaf`` in
   their rows);
10. serve (ROADMAP A13, the ``"phase": "serve"`` lines): the final
   parameters of phase 9's (p) qwen2-1.5b (whole), (s) xLSTM-350M (8
   layers) and (v) Jamba-1.5-Large (2 layers) runs, each served through
   ``repro_torch.serving.ServingEngine`` right after its run, before the
   next one starts (no model is made again, no peak rises above phase
   9's): a static batch of 8, a cache of 512, 32 new tokens, greedy;
   qwen2 12 prompts of 16-128 tokens (two waves) and a sampled wave at
   T = 0.8, seed 0, repeated bit for bit; xLSTM and Jamba one wave of 8
   prompts of 16-64. Each prints its tokens a second, ms a step, peak
   memory, nvidia-smi's busy share (over the traffic, run again until 3 s
   have passed; every rerun must give the same tokens), cache bytes and
   set-up seconds beside the card's name and power limit, and must
   launch no kernel. Over 128 positions of 8 drawn sequences the whole
   model's decode logits must be finite and, at position 0, within
   SERVE_BARS of prefill's (the agreement at later positions is printed:
   the reference's init makes decode and prefill part with depth, ROADMAP
   C); each kind of layer alone, at the published widths, must give every
   prompt's first token as prefill's argmax at its last position (where
   prefill's top two are within one bf16 step, a token within one step of
   its top), decode logits within SERVE_BARS of prefill's at every position and (attention)
   a ring of 64 slots equal to the full cache within them while the
   history fits it, finite after;
11. mesh (ROADMAP A14a, after phase 10; the ``"phase": "mesh"`` line): the
   client axis over MESH_RANKS gloo ranks that share the card, started
   here with ``torch.multiprocessing`` (spawn) and a ``FileStore`` in a
   temporary directory, each with this script's deterministic settings,
   and stopped at MESH_TIMEOUT_S: (w) ``stream_shard`` of the main path's
   cohort in chunks of 25, 2 rounds; (x) ``tree_shard`` of it as 4 edges of
   25; (y) ``run_campaign(shard=True)`` of phase 7's cohort group, 4 runs a
   rank; (z) qwen2-1.5b at its published widths cut to 2 layers, its 4
   clients as 2 scan steps of 2 pods on a ("pod",) mesh, one round. Each is
   held to the same configuration in this process: (w) theta_hat, loss and
   b bit for bit, theta_mse within rtol 1e-6; (x) every metric bit for bit;
   (y) every run to phase 7's (b exact, loss rtol 1e-6, accuracy 1e-6; the
   runs equal bit for bit counted); (z) parameters, b and losses bit for
   bit, and the one-process step held to the (4, 1) layout of the same
   clients (parameters and b bit for bit, losses rtol 1e-6). Every sharded
   run must report MESH_RANKS ranks and each rank its own expected launches
   (B1, B4; B3 in (y) and (z)); the line gives each run's round seconds,
   collectives (calls, bytes, host ms), each rank's peak and the spawn and
   set-up seconds. Two ranks on one card measure the protocol's host and
   collective cost, not a speed-up. The ranks' process group is the
   port's host-staged backend (``distributed.STAGED_BACKEND``: gloo on host
   copies), which DTensor's own collectives of phase 12 need;
12. model axis (ROADMAP A14b, on phase 11's ranks; the ``"phase":
   "model_axis"`` line): (aa) after (z) each rank runs one round of phase
   9's (r) (Qwen3-30B-A3B cut to 2 layers, its clients, first batch and
   key) with the parameters as DTensors on a ("data", "model") = (1, 2)
   mesh (MODEL_AXIS_MESH; each rank draws only its shards) and each
   pattern unit checkpointed (the trainer's ``--remat``): 64 of the 128
   experts a rank, the attention heads, the FFN and the vocabulary over
   "model", the f32 router replicated. Each rank holds (r)'s round 0, kept
   by phase 9 in the ranks' temporary directory: b exact, both losses within rtol 1e-3, at most 0.5%
   of the parameters apart (MODEL_AXIS_BARS, counted once over the ranks);
   each launches B1 once a (client, leaf) and B3 once a leaf over the
   leaves it holds (52 and 13), and prints its step seconds, peak and
   collectives (the staged backend's calls, bytes and host ms). (bb) beside
   phase 9 (the card busy, the host mostly idle), a subprocess runs
   ``python -m repro_torch.launch.dryrun`` with DRYRUN_ARGV (Qwen3-30B-A3B
   whole at train_4k on a fake world of 2 x 16 x 16 ranks, fake tensors on
   device type "cuda"), read after the ranks and killed at
   DRYRUN_DEADLINE_S: its report must say ``status: ok``, name collectives
   over each of "pod", "data" and "model", and count the step's dot FLOPs
   (a device's times 512) within bounds that the config alone gives
   (:func:`dryrun_dot_band`); the line prints its wall and trace seconds,
   its dot FLOPs over ``6 N T`` and its peak bytes a device beside the
   card's memory;
13. theorems (ROADMAP A16, after phase 12; the ``"phase": "theorems"``
   lines, one a check): (cc) the paper's Theorems 1-3 through the
   functional one-bit API (``core.stochastic_binarize``,
   ``probit_plus_from_updates``, ``probit_plus_aggregate``, ``flip_codes``,
   ``privacy_loss``) at the MLP's width d = 118,282, every draw batched:
   Theorem 1's error formula within 2% at M in {8, 32, 128, 512} with 16
   draws each (theta clipped to [-b, b], the theorem's premise), M times the error equal within 4% across them, the mean of
   64 draws at M = 32 within 6 standard errors of FedAvg's; Theorem 2's
   ``2 beta ||b||`` bound (x 1.05) under ``flip_codes`` of the same draws at
   M = 100, beta in {0.1, 0.2, 0.4}; one client at 1e9 moving no estimate
   by more than 2b/M (f32 ulps aside); Theorem 3's privacy loss within
   epsilon (x 1.0001) for epsilon in {0.05, 0.1, 0.5, 1} at b's floor; and
   at each M B3 on one draw's packed codes equal to
   ``probit_plus_aggregate`` bit for bit. (dd) the grids of the reference's
   ``tests/test_statistical.py`` through ``run_campaign`` with the kernels
   (B1, B3, B4), each with its plan's launch counts: the log-log slope of
   theta_mse over M in {8, 16, 32, 64} in [-1.35, -0.65] and falling, with
   no DP and at epsilon 0.1; accuracy under bit_flip within 0.1 / 0.12 of
   the clean run; the straggler+sign_flip grid within 0.1 / 0.15 with
   buf_fill > 0.5 and finite mean_age, its asynchronous groups (one a
   byz_frac, 4 runs each) each run as one group, with its own launches and
   seconds, and every run held to its sequential ``FLSimulation`` run (b
   exact, loss rtol 1e-6, accuracy 1e-6). Nothing is written to the repo;
6. with ``--profile`` only: (a) on the MLP and on ``resnet18w64-m100``:
   the device busy share as nvidia-smi reads it over unprofiled rounds and
   as the union of the kernels' records of one round under
   ``torch.profiler`` (by CUDA stream), stream ms by round step (CUDA
   events), the round's FLOPs and its top operators and kernels.

The last four lines are the script's total seconds (``"phase":
"total"``), the per-kernel JSON, the card line and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit). A
# kernel's operations are counted against the f32 rate, B3's one-bit vote
# adds too: bytes bound B3 at any rate above 8 operations per wire byte at
# 3.35 TB/s (26.8 T/s), which one-bit adds, 32 to a logic instruction, exceed.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

MAIN = dict(n_clients=100, per_client=100, hidden=128, rounds=3, local_epochs=2, batch_size=10)
# The FLConfig fields every main-path run sets (make_sim), besides its variant's.
MAIN_CFG = {"n_clients": MAIN["n_clients"], "rounds": MAIN["rounds"], "local_epochs": MAIN["local_epochs"],
            "batch_size": MAIN["batch_size"], "use_kernels": True, "aggregator": "probit_plus", "b_mode": "dynamic"}
VARIANTS = {
    "a": {},
    "b": {"error_feedback": True},
    "c": {"byz_frac": 0.3, "attack": "sign_flip"},
    "d": {"byz_frac": 0.3, "attack": "bit_flip"},
}
# Phase 4b: the Table I grid, on the main path's model and cohort.
GRID_BASE = {"b_mode": "fixed", "byz_frac": 0.1}
GRID = {
    **{f"probit_plus/{a}": {"attack": a} for a in ("gaussian", "alie", "ipm")},
    **{f"{agg}/{a}": {"aggregator": agg, "attack": a}
       for agg in ("signsgd_mv", "rsa", "fedavg", "fed_gm")
       for a in ("gaussian", "sign_flip", "zero_gradient", "sample_duplicate")},
    "probit_plus/oracle_b": {"b_mode": "oracle"},
    "probit_plus/participation_0.5": {"participation": 0.5},
}
# Phase 4c: (model, init kwargs, image side, channels, variants, d).
VISION = {
    "cnn16-m100": ("cnn", {"width": 16}, 28, 1, ("a", "b"), 206_874),
    "resnet18w64-m100": ("resnet", {"width": 64, "blocks": (2, 2, 2, 2), "in_ch": 3}, 32, 3, ("a",), 11_172_042),
}
RESNET_D = VISION["resnet18w64-m100"][-1]
# Phase 4d: the buffered-asynchronous and streamed rounds on the main path's
# model and cohort: (e) async at a full buffer, zero latency and decay,
# which is the synchronous round; (f) async under the straggler attack;
# (g) streamed in chunks of 25; (g1) streamed in one chunk of 100.
ASYNC_STREAM = {
    "e": {"async_buffer": 100},
    "f": {"async_buffer": 50, "async_latency": 1.0, "staleness_decay": 0.5, "byz_frac": 0.1,
          "attack": "straggler+sign_flip"},
    "g": {"client_chunk": 25},
    "g1": {"client_chunk": 100},
}
# ... then ResNet-18 at full width with 300 stateless clients, streamed 50 at
# a time: a cohort whose dense round would not fit in the card's memory; 1
# round (2 until phase 7's grid (i1) of wire and tree groups pushed the
# script past the 1,000 s ceiling).
RESNET_STREAM = ("resnet18w64-m300-stream", "resnet18w64-m100",
                 {"n_clients": 300, "client_chunk": 50, "stateless_clients": True, "rounds": 1})
# Phase 8: the k-bit, mixed-width and top-k wires and the count trees on the
# main path's model and cohort: (k), (l) k-bit; (l-dp) the randomized-
# response wire; (m) mixed widths and (m1) all one bit, both without the
# kernels (the reference refuses client_bits with them); (n), (n-ef) top-k;
# (o) a sum tree of 4 edges in chunks of 25, (o-med), (o-trim), (o-buf)
# with a Byzantine edge, (o-k4) (o) on the 4-bit wire.
TREE = {"tree_edges": 4, "client_chunk": 25}
WIRES_TREES = {
    "k": {"wire_bits": 2},
    "l": {"wire_bits": 4},
    "l-dp": {"wire_bits": 4, "dp_epsilon": 0.1},
    "m": {"client_bits": (1,) * 50 + (2,) * 25 + (4,) * 25, "use_kernels": False},
    "m1": {"client_bits": (1,) * 100, "use_kernels": False},
    "n": {"topk_frac": 0.1},
    "n-ef": {"topk_frac": 0.1, "error_feedback": True},
    "o": TREE,
    "o-med": {**TREE, "edge_merge": "median", "byz_edges": 1, "edge_attack": "edge_sign_flip"},
    "o-trim": {**TREE, "edge_merge": "trimmed", "edge_trim": 1, "byz_edges": 1, "edge_attack": "edge_inflate"},
    "o-buf": {**TREE, "edge_buffer": 2, "async_latency": 1.0, "staleness_decay": 0.5, "byz_edges": 1,
              "edge_attack": "edge_replay"},
    "o-k4": {**TREE, "wire_bits": 4},
}
TOPK_FRAC = 0.1
KERNELS = {
    # name: (CUDA source, Pallas call it replaces)
    "stoch_quant_pack": ("src/repro_torch/kernels/csrc/stoch_quant.cu", "src/repro/kernels/stoch_quant.py:77"),
    "stoch_quant_ef": ("src/repro_torch/kernels/csrc/stoch_quant.cu", "src/repro/kernels/stoch_quant.py:114"),
    "bit_aggregate": ("src/repro_torch/kernels/csrc/bit_aggregate.cu", "src/repro/kernels/bit_aggregate.py:89"),
    "prox_sgd": ("src/repro_torch/kernels/csrc/prox_sgd.cu", "src/repro/kernels/prox_sgd.py:51"),
}


# Phase 9: the federated LM round of repro_torch.launch.train at qwen2-1.5b's
# published width (28 layers, d_model 1,536, vocab 151,936; 15 parameter
# leaves, d = 1,777,088,000) with the trainer's defaults: 4 clients, 2 local
# steps of 2 sequences of 128 tokens, at a learning rate of 1e-8: the
# reference's init (fan_in = shape[-2], 1/sqrt(12) for the (1536, 12, 128)
# attention projections) makes 28 layers' gradients reach 1e11-1e13, and
# one SGD step at the trainer's 0.01 makes the next local loss NaN in the
# reference and the port alike (ROADMAP C). (p) PRoBit+ on the kernel wire, one
# round (2 until phase 13 took the time; (r) runs 2 at full width) beside
# its engine="ref" rerun; (p16) the 16-bit draws, which stay
# plain; (p-avg) the full-precision FedAvg baseline; both one round. Then
# (q): aggregate_pytree with error feedback on the reduced qwen2 through B2
# and B3, two rounds, against stream_aggregate_pytree and engine="ref".
LM_ARCH = "qwen2-1.5b"
LM_COMMON = ["--clients", "4", "--local-steps", "2", "--per-batch", "2", "--seq", "128", "--lr", "1e-8"]
LM_ARGS = ["--arch", LM_ARCH] + LM_COMMON
LM_VARIANTS = {
    "p": ["--rounds", "1"],
    "p16": ["--rounds", "1", "--rand-bits", "16"],
    "p-avg": ["--rounds", "1", "--aggregator", "fedavg_fp32"],
}
LM_Q = {"clients": 4, "client_chunk": 2, "rounds": 2}
# The trainer's --remat (each pattern unit checkpointed, the reference's
# backbone default) is off in phase 9's rounds; lm_remat_probe times one
# client's forward and backward with and without it on these runs' batches
# (phase 12's (aa) runs its round with it on).
REMAT_PROBE = ("p", "r", "t")
REMAT_PROBE_REPS = 3
# (r) and (s): the MoE FFN and the xLSTM mixers (ROADMAP A12b, A12d) in the
# same round, with LM_COMMON's clients, local steps and learning rate. The
# run's name, the config, its cut (dataclasses.replace of the published
# config; the trainer has no depth flag) and the trainer's extra flags.
# Qwen3-30B-A3B whole is 30,532,110,336 parameters (61.1 GB in bf16); the
# round holds the parameters, a local copy, the next copy and the
# gradients, so it is cut to 2 of its 48 layers at its published widths (4
# until phase 12 took the time; phase 12 holds its model axis to this run's
# round 0).
# xLSTM-350M keeps 8 of its 24 layers, one whole 7:1 pattern (7 mLSTM, 1
# sLSTM), at 512 tokens a sequence: two mLSTM chunks of 256. It ran whole
# until phase 11 (the mesh) pushed the script past the 1,000 s ceiling: its
# sLSTM loop over time is the slowest per parameter of phase 9. It runs 1
# round (2 until phase 7's grid (i1) of wire and tree groups pushed the
# script past the 1,000 s ceiling; (r) covers a second round).
# (t), (u) and (v): the frontends and the Mamba hybrid (ROADMAP A12e,
# A12c). HuBERT-XLarge runs whole on the trainer's stub frames, 1 round (2
# until phase 12 and the unit checkpoint, now off in phase 9, pushed the
# script past the 1,000 s ceiling). Pixtral-12B
# (12.27e9 parameters whole) keeps 2 of its 40 layers and its 1,024 stub
# patches; its 1,024 tokens make 2,048 positions, whole chunks of the
# attention's 512 and 1,024 (the reference's rule). Jamba-1.5-Large's MoE
# layer alone is 16 x 3 x 8,192 x 24,576 = 9.66e9 parameters, so it keeps
# the reduced config's pattern (mamba, attn), 2 of its 72 layers and 2 of
# its 16 experts (top-2), at 512 tokens: two Mamba chunks of 256.
LM_FAMILIES = {
    "r": ("qwen3-moe-30b-a3b-l2-m4", "qwen3-moe-30b-a3b", {"n_layers": 2}, ["--rounds", "2"],
          {"d": 1_868_572_672, "leaves": 13}),
    "s": ("xlstm-350m-l8-m4", "xlstm-350m", {"n_layers": 8}, ["--rounds", "1", "--seq", "512"],
          {"d": 241_634_360, "leaves": 92}),
    "t": ("hubert-xlarge-m4", "hubert-xlarge", {}, ["--rounds", "1"], {"d": 945_258_240, "leaves": 15}),
    "u": ("pixtral-12b-l2-m4", "pixtral-12b", {"n_layers": 2}, ["--rounds", "1", "--seq", "1024"],
          {"d": 1_913_676_800, "leaves": 13}),
    "v": ("jamba-1.5-large-398b-l2-m4", "jamba-1.5-large-398b",
          {"pattern": ("mamba", "attn"), "n_layers": 2, "n_experts": 2}, ["--rounds", "1", "--seq", "512"],
          {"d": 3_457_064_960, "leaves": 27}),
}
# Phase 10: serving (ROADMAP A13) of the parameters that phase 9's (p), (s)
# and (v) end with, each served as soon as its run ends, before the next
# run starts: the run's name -> (prompts, their lengths' range, a sampled
# wave, a ring run). Every engine has SERVE_CFG's static batch of 8, cache of
# 512 and 32 new tokens; prompts and their lengths are drawn from the port's
# Threefry (SERVE_SEED). The checks run over SERVE_CHECK positions: decode
# against prefill, and a ring of SERVE_RING slots against the full cache.
SERVE = {
    "p": {"prompts": 12, "lens": (16, 128), "sampled": True, "ring": True},
    "s": {"prompts": 8, "lens": (16, 64), "sampled": False, "ring": False},
    "v": {"prompts": 8, "lens": (16, 64), "sampled": False, "ring": True},
}
SERVE_CFG = {"batch_size": 8, "max_len": 512, "max_new_tokens": 32}
SERVE_T, SERVE_SEED, SERVE_CHECK, SERVE_RING = 0.8, 11, 128, 64
# Decode against prefill (and the ring against the full cache) at bf16, for
# each kind of layer alone: the largest logit difference at most [0] of the
# largest |logit| of the run, the mean at most [1] of it; the bf16 bars of
# the prefill tests at that scale (0.5 and 0.02 on logits up to ~5; with a
# Mamba mixer, whose state sums the bf16 in_proj's one-step differences,
# 2.0 and 0.03).
SERVE_BARS = {"dense": (0.1, 0.004), "mamba": (0.4, 0.006)}
# The largest leaves at which phase 5 times B1 (one client's row) and B3
# (the round's 4 rows): qwen2-1.5b's blocks[0].ffn.w1 (28 x 1,536 x 8,960)
# and (r)'s blocks[0].ffn.w1 (2 x 128 x 2,048 x 768: it moves with (r)'s
# cut, 4 layers until phase 12).
LM_LEAVES = {"at_lm_leaf": 28 * 1_536 * 8_960, "at_lm_moe_leaf": 2 * 128 * 2_048 * 768}
# Phase 11: the client axis over a mesh of gloo ranks (ROADMAP A14a). The
# machine has one card and NCCL refuses two ranks on one device, so
# MESH_RANKS gloo ranks share cuda:0 (gloo crosses CUDA tensors through host
# copies): they measure the protocol's collectives and host cost, not a
# speed-up. (w) the main path's cohort streamed in chunks of 25, 50
# stateless clients a rank; (x) the same cohort as a sum tree of 4 edges of
# 25, 2 a rank; (y) phase 7's cohort group ((a) with seeds 0-7, 3 rounds),
# 4 runs a rank; (z) qwen2-1.5b at its published widths cut to 2 of its 28
# layers, its 4 clients as 2 scan steps of 2 pods, one pod a rank, 1 round.
MESH_RANKS = 2
MESH_FL = {
    "w": {"client_chunk": 25, "stateless_clients": True, "rounds": 2, "stream_shard": True},
    "x": {"tree_edges": 4, "client_chunk": 25, "stateless_clients": True, "rounds": 2, "tree_shard": True},
}
MESH_LM_CUT = {"n_layers": 2}
MESH_LM_LAYOUTS = {"pods": (2, 2), "one_pod": (4, 1)}  # (m_seq, n_pods) of the 4 clients
MESH_TIMEOUT_S = 420
# Phase 12: the model axis (ROADMAP A14b), on phase 11's ranks and alongside
# them. (aa) each rank, after (z), runs one round of phase 9's (r)
# (Qwen3-30B-A3B cut to 2 layers, (r)'s clients, batches and key) with the
# parameters as DTensors on a ("data", "model") = (1, MESH_RANKS) mesh: 64 of
# the 128 experts a rank, the heads, the FFN and the 151,936-token
# vocabulary over "model", the f32 router replicated (FSDP over "data" is
# one rank wide); held to (r)'s round 0 with the port's bf16 bars (b exact,
# losses within rtol 1e-3, at most 0.5% of the parameters apart). DTensor's
# own collectives cross the ranks through the host-staged backend
# (distributed.STAGED_BACKEND), which phase 11's ranks now start. (bb) the
# dry run of the whole model at train_4k on a fake world of 2 x 16 x 16
# ranks, a subprocess started before phase 9 (whose rounds keep the card,
# not the host, busy) and read after the ranks, with DRYRUN_DEADLINE_S.
MODEL_AXIS_MESH = ((1, MESH_RANKS), ("data", "model"))
MODEL_AXIS_BARS = {"loss_rtol": 1e-3, "params_apart": 0.005}
DRYRUN_ARGV = ["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k", "--multi-pod"]
DRYRUN_WORLD = 512
DRYRUN_DEADLINE_S = 900
# Phase 3: the single-client kernel entries (kernels.stoch_quant_compress,
# stoch_quant_pack) at a short row, the MLP's width and ResNet-18's.
SINGLE_CLIENT_D = (997, 118_282, RESNET_D)
# Phase 13: the paper's theorem layer (ROADMAP A16) at the MLP's width. (cc)
# Theorems 1-3 through the functional one-bit API: the error formula at each
# of THEOREM_MS with THEOREM_REPS draws (bar 2%), M times the error equal
# across them (bar 4%), unbiasedness over THEOREM_UNBIASED (M, reps) (6
# standard errors), Theorem 2's bound at THEOREM_BYZ_M and THEOREM_BETAS,
# magnitude immunity, Theorem 3 at THEOREM_EPS, and B3 against
# probit_plus_aggregate on one draw's codes at each M. (dd) the grids of the
# reference's tests/test_statistical.py through repro_torch.sim with the
# kernels, at its data, model, seeds and bars.
THEOREM_D = 118_282
THEOREM_MS = (8, 32, 128, 512)
THEOREM_REPS = 16
THEOREM_BARS = {"error_rel": 0.02, "m_times_error_spread": 0.04, "unbiased_se": 6.0, "byz_slack": 1.05,
                "privacy_slack": 1.0001}
THEOREM_UNBIASED = (32, 64)
THEOREM_BYZ_M = 100
THEOREM_BETAS = (0.1, 0.2, 0.4)
THEOREM_EPS = (0.05, 0.1, 0.5, 1.0)
STAT_M_GRID = (8, 16, 32, 64)
STAT_SLOPE = (-1.35, -0.65)
STAT_PER_CLIENT = 50


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int = 30, warmup: int = 3, repeats: int = 5) -> float:
    """Device milliseconds per call: the median of :func:`timed_batches`."""
    return statistics.median(timed_batches(fn, reps, warmup, repeats))


def timed_batches(fn, reps: int = 30, warmup: int = 3, repeats: int = 5) -> list[float]:
    """Device milliseconds per call in each of ``repeats`` batches of
    ``reps`` calls, each batch timed by CUDA events.

    A ``torch.cuda._sleep`` kernel runs before each batch and holds the
    stream while the host queues every call behind it, so the events time
    the device work back to back, not the host's Python overhead per
    launch. The sleep grows until it outlasts the host's queueing.
    """
    import torch

    for _ in range(warmup):
        fn()
    cycles = 20_000_000
    batches = []
    while len(batches) < repeats:
        torch.cuda.synchronize()
        s0, s1, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(4))
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        h0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        if host_ms < s0.elapsed_time(s1):
            batches.append(start.elapsed_time(end) / reps)
        else:
            require(cycles < 2_000_000_000, f"host needs {host_ms} ms to queue {reps} calls")
            cycles *= 4
    return batches


class Checker:
    """Bitwise comparison of a kernel with its plain version; keeps the
    largest absolute difference seen per kernel (0 when all agree)."""

    def __init__(self):
        self.max_err: dict[str, float] = {}
        self.count: dict[str, int] = {}

    def same(self, name: str, got, want, what: str) -> None:
        import torch

        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name} {what}: {got.dtype}{tuple(got.shape)} vs {want.dtype}{tuple(want.shape)}")
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        self.max_err[name] = max(self.max_err.get(name, 0.0), err)
        self.count[name] = self.count.get(name, 0) + 1
        require(torch.equal(got, want), f"{name} {what}: differs from its plain version (max |diff| {err})")


def check_kernels(chk: Checker, dev) -> None:
    """Phase 3: every kernel against its plain version on the card."""
    import torch
    import torch.nn.functional as F

    from repro_torch import prng
    from repro_torch.core.aggregation import ml_estimate_from_counts
    from repro_torch.core.quantizer import packed_counts
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.prox_sgd import prox_sgd
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    shapes = [(d, (1, 5, 100, 300)) for d in (997, 40522, 118282)] + [(RESNET_D, (1, 8))]
    for d, cohorts in shapes:
        d_pad = ops.padded_len(d)
        pad = d_pad - d
        b = torch.full((d,), 0.01, device=dev)
        b[:7] = torch.tensor([0.0, -0.01, 1e-30, 0.02, 0.005, 0.0, 3.0], device=dev)  # guards
        b_p = F.pad(b, (0, pad), value=1.0)
        for m in cohorts:
            tag = f"d={d} M={m}"
            delta = F.pad(0.02 * randn(m, d), (0, pad), value=-1.0)
            delta[:, 7] = b[7]  # |delta| == b exactly: p is 0 or 1
            u = F.pad(torch.rand(m, d, generator=gen, device=dev), (0, pad), value=1.0)
            res = F.pad(0.005 * randn(m, d), (0, pad))
            packed = stoch_quant_pack(delta, b_p, u)
            chk.same("stoch_quant_pack", packed, ref.stoch_quant_compress_ref(delta, b_p, u)[0], tag)
            got_p, got_r = stoch_quant_ef(delta, res, b_p, u)
            want_p, want_r = ref.stoch_quant_compress_ref(delta, b_p, u, res, want_residual=True)
            chk.same("stoch_quant_ef", got_p, want_p, tag + " wire")
            chk.same("stoch_quant_ef", got_r, want_r, tag + " residual")

            # through ops: the Threefry uniform schedule and the wire width
            key = prng.fold_in(prng.key(7, dev), m)
            deltas = delta[:, :d].contiguous()
            for resid in (None, res[:, :d].contiguous()):
                kp, kr = ops.stoch_quant_compress_batch(key, deltas, b, residual=resid,
                                                        want_residual=resid is not None, engine="cuda")
                rp, rr = ops.stoch_quant_compress_batch(key, deltas, b, residual=resid,
                                                        want_residual=resid is not None, engine="ref")
                name = "stoch_quant_pack" if resid is None else "stoch_quant_ef"
                chk.same(name, kp, rp, tag + " ops wire")
                if resid is not None:
                    chk.same(name, kr, rr, tag + " ops residual")

            b_agg = F.pad(b.abs(), (0, pad))
            theta = bit_aggregate(packed, b_agg)
            chk.same("bit_aggregate", theta, ref.bit_aggregate_ref(packed, b_agg), tag)
            theta_d = ops.bit_aggregate(packed, b.abs(), d, engine="cuda")
            want = ml_estimate_from_counts(packed_counts(packed)[:d], m, b.abs())
            chk.same("bit_aggregate", theta_d, want, tag + " vs Eq.-13 of packed_counts")

            w, g, mom = randn(m, d), randn(m, d), 0.1 * randn(m, d)
            coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
            for w0 in (0.9 * w[0], 0.9 * w):
                want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)
                w_in, m_in = w.clone(), mom.clone()
                for got, how in ((prox_sgd(w, w0.contiguous(), g, mom, coeffs), ""),
                                 (prox_sgd(w_in, w0.contiguous(), g, m_in, coeffs, out=(w_in, m_in)),
                                  " in place")):
                    chk.same("prox_sgd", got[0], want[0], tag + how + " w")
                    chk.same("prox_sgd", got[1], want[1], tag + how + " momentum")

    # Padded-tail poison: n % 8 != 0 and M % 8 != 0; all-ones pad bits must
    # never reach theta_hat[:n].
    n, m = 997, 5
    pbytes = ops.padded_len(n) // 8
    packed = torch.randint(0, 256, (m, pbytes), generator=gen, device=dev, dtype=torch.uint8)
    b = randn(n).abs()
    base = ops.bit_aggregate(packed, b, n, engine="cuda")
    poisoned = packed.clone()
    full = n // 8
    poisoned[:, full] |= (0xFF << (8 - (8 * (full + 1) - n))) & 0xFF
    poisoned[:, full + 1:] = 0xFF
    chk.same("bit_aggregate", ops.bit_aggregate(poisoned, b, n, engine="cuda"), base, "padded-tail poison")
    chk.same("bit_aggregate", base, ops.bit_aggregate(packed, b, n, engine="ref"), "poison base vs ref")


# B3's client counts (phase 3): every cluster size of launch_geometry (1
# block a tile to M = 384, 2 at 500, 4 at 1,000, 8 beyond), past 2**16
# votes a coordinate (70,001), and past one flush of the byte-lane counters,
# which every row stream reaches beyond 4,080 rows (150,001).
B3_CHECK_M = (1, 7, 8, 100, 255, 256, 257, 500, 1_000, 70_001, 150_001)


def check_bit_aggregate(chk: Checker, dev) -> None:
    """Phase 3, B3 in depth: bit for bit against its plain version at d = 997
    for every M of B3_CHECK_M (random, all-ones and all-zeros wires) and at
    M = 10,000 with the main path's d = 118,282; no write at or beyond n (a
    poisoned tail of the output buffer survives the launch); and rows that
    are not 4-byte aligned."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bit_aggregate import bit_aggregate

    gen = torch.Generator(device=dev).manual_seed(4321)
    cases = [(997, m) for m in B3_CHECK_M] + [(118_282, 10_000)]
    for n, m in cases:
        p = ops.padded_len(n) // 8
        b = torch.rand(8 * p, generator=gen, device=dev) + 0.5
        random = torch.randint(0, 256, (m, p), generator=gen, device=dev, dtype=torch.uint8)
        fills = {"random": random}
        if n == 997 and m in (255, 256, 70_001, 150_001) or n == 118_282:
            fills["ones"] = torch.full_like(random, 0xFF)
            fills["zeros"] = torch.zeros_like(random)
        for fill, packed in fills.items():
            tag = f"n={n} M={m} {fill}"
            buf = torch.full((8 * p,), float("nan"), device=dev)
            got = bit_aggregate(packed, b[:n], out=buf[:n])
            chk.same("bit_aggregate", got, ref.bit_aggregate_ref(packed, b[:n]), tag)
            chk.same("bit_aggregate", got, ref.bit_aggregate_ref(packed, b)[:n], tag + " vs the 8P result")
            require(bool(buf[n:].isnan().all()), f"bit_aggregate {tag}: wrote at or beyond n")

    # Rows off 4-byte boundaries (P = 125, and a wire one byte past its
    # allocation): the kernel reads bytes, not words.
    for m in (7, 500, 70_001):
        flat = torch.randint(0, 256, (m * 125 + 1,), generator=gen, device=dev, dtype=torch.uint8)
        b = torch.rand(997, generator=gen, device=dev)
        for packed in (flat[:-1].view(m, 125), flat[1:].view(m, 125)):
            chk.same("bit_aggregate", bit_aggregate(packed, b), ref.bit_aggregate_ref(packed, b),
                     f"n=997 P=125 M={m} unaligned")


# B4's shapes (phase 3): d = 0, 1, 2 and 3 (mod 4), so every row alignment
# of the peel; 997 under one column tile, 4099 and 40522 not a multiple of
# it. M = 7 does not divide the row groups of B4_GEOMETRIES.
B4_CHECK_D = (4096, 997, 40_522, 4_099)
B4_CHECK_M = (1, 7, 100)
# (tile, rows per group, CTAs) launched through the C entry besides the
# wrapper's own: one CTA walking every unit, groups that do not divide M,
# fewer CTAs than units, more CTAs than units, the smallest and largest tile.
B4_GEOMETRIES = ((2048, 1, 1), (2048, 3, 5), (1024, 100, 2), (8192, 2, 1000), (4, 5, 7), (256, 4, 64))


def check_prox_sgd(chk: Checker, dev) -> None:
    """Phase 3, B4 in depth: bit for bit against its plain version for every
    d of B4_CHECK_D and M of B4_CHECK_M, with w0 shared and full: through
    the wrapper out of place and in place (``out=`` aliasing w and the
    momentum), through the C entry at every geometry of B4_GEOMETRIES, on
    the scalar path alone (``vector`` = 0), on arrays that all start 4 bytes
    past a 16-byte boundary (the vector path from another phase), and with
    only ``w`` off its boundary (the wrapper takes the scalar path)."""
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.prox_sgd import launch_geometry, occupancy, prox_sgd

    gen = torch.Generator(device=dev).manual_seed(2468)
    lib = _build.library("prox_sgd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
    for d in B4_CHECK_D:
        for m in B4_CHECK_M:
            w, g, mom = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
            for w0 in (0.9 * w[0] + 0.1, 0.9 * w + 0.1):
                tag = f"d={d} M={m} w0={'shared' if w0.dim() == 1 else 'full'}"
                want_w, want_m = ref.prox_sgd_ref(w, w0, g, mom, coeffs)

                def same(got, what):
                    chk.same("prox_sgd", got[0], want_w, f"{tag} {what} w")
                    chk.same("prox_sgd", got[1], want_m, f"{tag} {what} momentum")

                same(prox_sgd(w, w0, g, mom, coeffs), "wrapper")
                w_in, m_in = w.clone(), mom.clone()
                got = prox_sgd(w_in, w0, g, m_in, coeffs, out=(w_in, m_in))
                require(got[0] is w_in and got[1] is m_in, f"prox_sgd {tag}: out= not returned")
                same(got, "in place")
                shared = w0.dim() == 1
                chosen = launch_geometry(m, d, *occupancy(dev.index, shared))
                for tile, rows, ctas in (chosen, *B4_GEOMETRIES):
                    for vector in (1, 0):
                        w_out, m_out = torch.full_like(w, float("nan")), torch.full_like(w, float("nan"))
                        rc = lib.probit_prox_sgd(w.data_ptr(), w0.data_ptr(), g.data_ptr(), mom.data_ptr(),
                                                 w_out.data_ptr(), m_out.data_ptr(), coeffs.data_ptr(), 0, m, d,
                                                 m if shared else 1, tile, rows, ctas, vector, stream)
                        require(rc == 0, f"prox_sgd {tag} geometry {(tile, rows, ctas)}: cudaError_t {rc}")
                        same((w_out, m_out), f"geometry {(tile, rows, ctas)} vector={vector}")
                # every operand 4 bytes past a 16-byte boundary, then w alone
                flats = [torch.empty(m * d + 1, device=dev) for _ in range(5 if shared else 6)]
                views = [f[1:].view(m, d) for f in flats]
                for v, src in zip(views, (w, g, mom, w, mom, w0)):
                    v.copy_(src)
                w_in, g_in, m_in, w_io, m_io = views[:5]
                w0_in = w0 if shared else views[5]
                same(prox_sgd(w_in, w0_in, g_in, m_in, coeffs), "4 bytes off")
                same(prox_sgd(w_io, w0_in, g_in, m_io, coeffs, out=(w_io, m_io)), "4 bytes off, in place")
                same(prox_sgd(w_in, w0, g, mom, coeffs), "w alone 4 bytes off")


# Batched kernels (phase 3): a campaign group of E runs in one launch, each
# run with its own range b, counts, w0 row and coefficients; (M, d) of the
# runs at the MLP's width and, for B4, 3 rows a run at ResNet-18's width,
# where units take two rows, so a row group does not divide a run.
BATCH_CHECK_E = (1, 3, 8)
BATCH_CHECK_SHAPES = ((5, 40_522), (100, 118_282))


def check_batched(chk: Checker, dev) -> None:
    """Phase 3, the batched form of every kernel bit for bit against its
    plain version at E in BATCH_CHECK_E: B1, B2 and B3 through the wrappers
    (B3 also against each run's own call), B4 through the wrapper out of
    place and in place and through the C entry at other geometries."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.ops import padded_len
    from repro_torch.kernels.prox_sgd import prox_sgd
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(1357)
    lib = _build.library("prox_sgd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for e in BATCH_CHECK_E:
        for m, d in BATCH_CHECK_SHAPES:
            tag = f"E={e} M={m} d={d}"
            pad = padded_len(d) - d
            b = F.pad(0.005 + 0.02 * torch.rand(e, d, generator=gen, device=dev), (0, pad), value=1.0)
            delta = F.pad(0.02 * torch.randn(e * m, d, generator=gen, device=dev), (0, pad), value=-1.0)
            u = F.pad(torch.rand(e * m, d, generator=gen, device=dev), (0, pad), value=1.0)
            res = F.pad(0.005 * torch.randn(e * m, d, generator=gen, device=dev), (0, pad))
            packed = stoch_quant_pack(delta, b, u)
            chk.same("stoch_quant_pack", packed, ref.stoch_quant_compress_ref(delta, b, u)[0], tag)
            got = stoch_quant_ef(delta, res, b, u)
            want = ref.stoch_quant_compress_ref(delta, b, u, res, want_residual=True)
            chk.same("stoch_quant_ef", got[0], want[0], tag + " wire")
            chk.same("stoch_quant_ef", got[1], want[1], tag + " residual")
            wire, b_n = packed.view(e, m, -1), b[:, :d].contiguous()
            theta = bit_aggregate(wire, b_n)
            chk.same("bit_aggregate", theta, ref.bit_aggregate_ref(wire, b_n), tag)
            for i in range(e):
                chk.same("bit_aggregate", theta[i], bit_aggregate(wire[i].contiguous(), b_n[i].contiguous()),
                         f"{tag} run {i} alone")
            del delta, u, res, packed, got, want
        coeffs = torch.stack([0.01 + 0.01 * torch.arange(e, device=dev), 0.2 * (torch.arange(e, device=dev) % 2),
                              torch.full((e,), 0.5, device=dev)], -1).contiguous()
        for rows, d in ((100, 118_282), (5, 4_099), (3, RESNET_D)):
            tag = f"E={e} rows={rows} d={d}"
            w, g, mom = (torch.randn(e * rows, d, generator=gen, device=dev) for _ in range(3))
            w0 = torch.randn(e, d, generator=gen, device=dev)
            want_w, want_m = ref.prox_sgd_ref(w, w0, g, mom, coeffs)
            got = prox_sgd(w, w0, g, mom, coeffs)
            chk.same("prox_sgd", got[0], want_w, tag + " w")
            chk.same("prox_sgd", got[1], want_m, tag + " momentum")
            w_io, m_io = w.clone(), mom.clone()
            prox_sgd(w_io, w0, g, m_io, coeffs, out=(w_io, m_io))
            chk.same("prox_sgd", w_io, want_w, tag + " in place w")
            chk.same("prox_sgd", m_io, want_m, tag + " in place momentum")
            del got, w_io, m_io
            for geometry in ((2048, 1, 1), (2048, 2, 7), (1024, 4, 64)):
                w_out, m_out = torch.full_like(w, float("nan")), torch.full_like(w, float("nan"))
                rc = lib.probit_prox_sgd(w.data_ptr(), w0.data_ptr(), g.data_ptr(), mom.data_ptr(), w_out.data_ptr(),
                                         m_out.data_ptr(), coeffs.data_ptr(), 3, e * rows, d, rows, *geometry, 1,
                                         stream)
                require(rc == 0, f"prox_sgd {tag} geometry {geometry}: cudaError_t {rc}")
                chk.same("prox_sgd", w_out, want_w, f"{tag} geometry {geometry} w")
                chk.same("prox_sgd", m_out, want_m, f"{tag} geometry {geometry} momentum")
                del w_out, m_out
            del w, g, mom, w0, want_w, want_m
        torch.cuda.empty_cache()


def check_topk_pack(chk: Checker, dev) -> None:
    """Phase 3: B1 through ``ops.quant_pack_u`` on top-k row sets, one launch
    for the cohort with one b row a client (E = M elements of one row
    each), k not a multiple of 8: M = 100 at d = 118,282 (k = 11,828, the
    main path's) and M = 7 at d = 997 (k = 99), each with tied magnitudes
    across the k-th position, bit for bit against the plain version; and
    the sparse compressor's kernel wire against its plain one (indices and
    bytes)."""
    import torch

    from repro_torch import prng
    from repro_torch.core import build_pipeline
    from repro_torch.core.sparse import topk_indices
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2468)
    for m, d in ((100, 118_282), (7, 997)):
        k = max(int(d * TOPK_FRAC), 1)
        tag = f"top-k M={m} d={d} k={k}"
        eff = 0.02 * torch.randn(m, d, generator=gen, device=dev)
        eff[:, : d // 2] = torch.round(eff[:, : d // 2] * 100) / 100  # ties, zeros among them
        b_vec = torch.full((d,), 0.01, device=dev)
        idx = topk_indices(eff, k)
        d_sel, b_sel = eff.gather(1, idx), b_vec[idx]
        u = prng.uniform(prng.split(prng.key(3, dev), m), (k,))
        got = ops.quant_pack_u(d_sel, b_sel, u, engine="cuda")
        require(got.shape == (m, ops.padded_len(k) // 8), f"{tag}: shape {tuple(got.shape)}")
        chk.same("stoch_quant_pack", got, ops.quant_pack_u(d_sel, b_sel, u, engine="ref"), tag)
        wires = [build_pipeline("probit_plus", topk_frac=TOPK_FRAC, use_kernels=kern, engine=eng).compress_wire(
            prng.key(5, dev), eff, torch.tensor(0.01, device=dev), torch.zeros_like(eff))[0]
            for kern, eng in ((True, "cuda"), (False, None))]
        chk.same("stoch_quant_pack", wires[0].packed, wires[1].packed, tag + " sparse wire vs plain compressor")
        require(torch.equal(wires[0].indices, wires[1].indices), f"{tag}: indices differ")


def check_single_client(chk: Checker, dev) -> int:
    """Phase 3: one client's ``kernels.stoch_quant_compress`` and
    ``stoch_quant_pack`` on the kernel engine (B1; B2 with a residual given
    or wanted) against the plain engine, bit for bit, at each d of
    SINGLE_CLIENT_D; returns the number of comparisons."""
    import torch

    from repro_torch import kernels, prng

    gen = torch.Generator(device=dev).manual_seed(4321)
    n = 0
    for d in SINGLE_CLIENT_D:
        delta = 0.02 * torch.randn(d, generator=gen, device=dev)
        res = 0.005 * torch.randn(d, generator=gen, device=dev)
        b = torch.full((d,), 0.01, device=dev)
        b[:3] = torch.tensor([0.0, 1e-30, 3.0], device=dev)  # guards
        delta[3] = 0.01  # |delta| == b exactly: p is 0 or 1
        key = prng.fold_in(prng.key(11, dev), d)
        for resid, want_res in ((None, False), (res, False), (None, True), (res, True)):
            name = "stoch_quant_pack" if resid is None and not want_res else "stoch_quant_ef"
            tag = f"single client d={d} residual={resid is not None} want_residual={want_res}"
            kp, kr = kernels.stoch_quant_compress(key, delta, b, resid, want_residual=want_res, engine="cuda")
            rp, rr = kernels.stoch_quant_compress(key, delta, b, resid, want_residual=want_res, engine="ref")
            chk.same(name, kp, rp, tag + " wire")
            n += 1
            if want_res:
                chk.same(name, kr, rr, tag + " residual")
                n += 1
        chk.same("stoch_quant_pack", kernels.stoch_quant_pack(key, delta, b, engine="cuda"),
                 kernels.stoch_quant_pack(key, delta, b, engine="ref"), f"single client d={d} stoch_quant_pack")
        n += 1
    return n


def _split_clients(x, y, n_clients: int):
    """Label-skew partition of a cohort (2 classes a client)."""
    import numpy as np

    from repro_torch.data import partition_label_skew

    parts = partition_label_skew(y, n_clients, 2, MAIN["per_client"], seed=0)
    return np.stack([x[i] for i in parts]), np.stack([y[i] for i in parts])


@functools.lru_cache(maxsize=None)
def _task(name: str = "mlp128-m100", dev=None, n_clients: int = MAIN["n_clients"]):
    """A configuration's data for ``n_clients`` clients, initial weights (on
    the card when ``dev`` is given), loss and accuracy, made once from
    seeds: the main path's MLP or one of VISION."""
    from repro_torch import prng
    from repro_torch.data import make_classification, make_image_classification
    from repro_torch.models import MODELS, accuracy, init_mlp, mlp_logits, xent_loss

    if name == "mlp128-m100":
        (xtr, ytr), (xte, yte) = make_classification(0, n_train=10_000, n_test=2_000)
        p0, logits = init_mlp(prng.key(0), hidden=MAIN["hidden"]), mlp_logits
    else:
        model, init_kw, img, channels, _, _ = VISION[name]
        (xtr, ytr), (xte, yte) = make_image_classification(0, img=img, channels=channels,
                                                           n_train=10_000, n_test=2_000)
        init, logits = MODELS[model]
        p0 = init(prng.key(0, dev), **init_kw)
    cx, cy = _split_clients(xtr, ytr, n_clients)
    return (p0, cx, cy, {"x": xte, "y": yte}, functools.partial(xent_loss, logits),
            functools.partial(accuracy, logits))


def make_sim(dev, extra: dict, engine=None, task: str = "mlp128-m100"):
    from repro_torch.fl import FLConfig, FLSimulation

    cfg = FLConfig(**{**MAIN_CFG, **extra})
    p0, cx, cy, test, loss_fn, acc_fn = _task(task, None if task == "mlp128-m100" else dev, cfg.n_clients)
    return FLSimulation(cfg, p0, loss_fn, acc_fn, cx, cy, test, device=dev, engine=engine)


def expected_launches(name: str) -> dict:
    """Kernel launches of one variant's run: per round one compression (B2
    with error feedback, else B1), one count (B3) and one prox step (B4)
    per local step."""
    rounds = MAIN["rounds"]
    steps = MAIN["local_epochs"] * MAIN["per_client"] // MAIN["batch_size"]
    ef = VARIANTS[name].get("error_feedback", False)
    return {"stoch_quant_pack": 0 if ef else rounds, "stoch_quant_ef": rounds if ef else 0,
            "bit_aggregate": rounds, "prox_sgd": rounds * steps}


def run_sim(dev, name: str, extra: dict, engine=None, task: str = "mlp128-m100") -> dict:
    """One FLSimulation run on the card: each round's loss, b, theta_hat and
    wall time, the kernel launches of this run alone (counts zeroed just
    before it and read just after), the accuracy, d, the wire row bytes and
    the peak device memory (allocator peak from before the set-up)."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    sim = make_sim(dev, extra, engine, task)
    recs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, met in sim.iter_rounds():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs.append({"loss": met["loss"].item(), "b": met["b"].item(),
                     "theta": met["theta"].clone(), "seconds": t1 - t0,
                     **{k: met[k].item() for k in ("buf_fill", "mean_age") if k in met}})
        t0 = t1
    require(set(_build.launches) <= set(KERNELS), f"{task} {name}: unknown kernel {dict(_build.launches)}")
    launches = {k: _build.launches[k] for k in KERNELS}
    return {"rounds": recs, "launches": launches, "acc": sim.evaluate(), "d": sim.d,
            "wire_row_bytes": sim.pipeline.compressor.wire_bytes(sim.d),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def main_path(dev, engine=None, variants=VARIANTS):
    """Phase 4: FLSimulation on the card; returns per-variant round records
    and the kernel launches of each variant's own run."""
    return {name: run_sim(dev, name, extra, engine) for name, extra in variants.items()}


def vision_runs(dev) -> dict:
    """Phase 4c: each VISION configuration and variant through the kernels,
    its launch counts, its engine="ref" rerun round for round, finite
    losses, b's moves and theta_hat's width (check_main_path), and its
    printed wall times and peak memory."""
    import numpy as np
    import torch

    from repro_torch.fl import FLConfig

    runs = {}
    for config, (_, _, _, _, variants, d) in VISION.items():
        for v in variants:
            tag = f"{config}/{v}"
            run = run_sim(dev, v, VARIANTS[v], task=config)
            ref = run_sim(dev, v, VARIANTS[v], engine="ref", task=config)
            want = expected_launches(v)
            require(run["d"] == d, f"{tag}: d = {run['d']}, expected {d}")
            require(run["launches"] == want, f"{tag}: launches {run['launches']} != expected {want}")
            require(not any(ref["launches"].values()), f"{tag}: the engine='ref' run launched {ref['launches']}")
            require(len(run["rounds"]) == len(ref["rounds"]) == MAIN["rounds"], f"{tag}: rounds differ")
            for t, (k, r) in enumerate(zip(run["rounds"], ref["rounds"])):
                require(np.isfinite(k["loss"]), f"{tag} round {t}: loss {k['loss']}")
                require(torch.equal(k["theta"], r["theta"]) and k["loss"] == r["loss"] and k["b"] == r["b"],
                        f"{tag} round {t}: differs from the engine='ref' run")
            check_main_path({tag: run}, FLConfig().b_init)
            print(json.dumps({"phase": "vision", "run": tag, "d": run["d"], "wire_row_bytes": run["wire_row_bytes"],
                              "launches": run["launches"],
                              "round_seconds": [r["seconds"] for r in run["rounds"]],
                              "round_seconds_ref": [r["seconds"] for r in ref["rounds"]],
                              "peak_gb": run["peak_bytes"] / 1e9, "peak_gb_ref": ref["peak_bytes"] / 1e9,
                              "loss": [r["loss"] for r in run["rounds"]], "b": [r["b"] for r in run["rounds"]],
                              "acc": run["acc"], "equal_rounds": MAIN["rounds"]}), flush=True)
            runs[tag] = run
    return runs


def async_stream_expected_launches(extra: dict) -> dict:
    """One phase-4d run's launches: one compression (B1) a chunk of clients
    (the whole cohort in an asynchronous round) and one prox step (B4) a
    local step of each chunk; no vote count (B3): the weighted and streamed
    estimates count with plain torch, as the reference does."""
    rounds, n = extra.get("rounds", MAIN["rounds"]), extra.get("n_clients", MAIN["n_clients"])
    chunks = -(-n // (extra.get("client_chunk") or n))
    steps = MAIN["local_epochs"] * MAIN["per_client"] // MAIN["batch_size"]
    return {"stoch_quant_pack": rounds * chunks, "stoch_quant_ef": 0, "bit_aggregate": 0,
            "prox_sgd": rounds * chunks * steps}


def check_against_ref(tag: str, run: dict, ref: dict, rounds: int) -> None:
    """A kernel run equals its engine="ref" rerun in every round (theta,
    loss and b) and the rerun launched nothing."""
    import torch

    require(not any(ref["launches"].values()), f"{tag}: the engine='ref' run launched {ref['launches']}")
    require(len(run["rounds"]) == len(ref["rounds"]) == rounds, f"{tag}: rounds differ")
    for t, (k, r) in enumerate(zip(run["rounds"], ref["rounds"])):
        require(torch.equal(k["theta"], r["theta"]) and k["loss"] == r["loss"] and k["b"] == r["b"],
                f"{tag} round {t}: differs from the engine='ref' run")


def async_stream_runs(dev, main: dict, resnet_dense_peak_bytes: int) -> dict:
    """Phase 4d: each ASYNC_STREAM variant through the kernels and its
    engine="ref" rerun, with its launch counts and checks; (e) and (g1)
    equal variant (a) of phase 4 in every round (theta, loss, b), and so
    do (g)'s theta and b (cuBLAS gives a batch of 25 clients the bits of a
    batch of 100 on the H100; the loss sums chunk by chunk). Then
    RESNET_STREAM and its rerun, its peak memory below the card's and below
    the dense round's, reckoned from this run's dense ResNet-18 peak at
    M = 100 (every plane of the dense round scales with M)."""
    import torch

    from repro_torch.fl import FLConfig

    runs = {}
    a_rounds = main["a"]["rounds"]
    for v, extra in ASYNC_STREAM.items():
        tag = f"mlp128-m100/{v}"
        run = run_sim(dev, v, extra)
        ref = run_sim(dev, v, extra, engine="ref")
        want = async_stream_expected_launches(extra)
        require(run["launches"] == want, f"{tag}: launches {run['launches']} != expected {want}")
        check_against_ref(tag, run, ref, MAIN["rounds"])
        check_main_path({tag: run}, FLConfig().b_init)
        differ = [int((k["theta"] != r["theta"]).sum()) for k, r in zip(run["rounds"], a_rounds)]
        same_as_a = all(k["loss"] == r["loss"] and k["b"] == r["b"] for k, r in zip(run["rounds"], a_rounds))
        if v in ("e", "g1"):
            require(not any(differ) and same_as_a, f"{tag}: differs from (a): {differ} coordinates of theta")
        elif v == "g":
            require(not any(differ) and all(k["b"] == r["b"] for k, r in zip(run["rounds"], a_rounds)),
                    f"{tag}: {differ} coordinates of theta differ from (a), or b does")
        print(json.dumps({"phase": "async_stream", "run": tag, "config": extra, "launches": run["launches"],
                          "round_seconds": [r["seconds"] for r in run["rounds"]],
                          "round_seconds_ref": [r["seconds"] for r in ref["rounds"]],
                          "theta_coords_differing_from_a": differ, "equal_to_a": not any(differ) and same_as_a,
                          "loss": [r["loss"] for r in run["rounds"]], "b": [r["b"] for r in run["rounds"]],
                          **{k: [r[k] for r in run["rounds"]] for k in ("buf_fill", "mean_age")
                             if k in run["rounds"][0]},
                          "acc": run["acc"], "peak_gb": run["peak_bytes"] / 1e9, "equal_rounds": MAIN["rounds"]}),
              flush=True)
        runs[tag] = run

    name, task, extra = RESNET_STREAM
    run = run_sim(dev, name, extra, task=task)
    ref = run_sim(dev, name, extra, engine="ref", task=task)
    want = async_stream_expected_launches(extra)
    require(run["d"] == RESNET_D, f"{name}: d = {run['d']}")
    require(run["launches"] == want, f"{name}: launches {run['launches']} != expected {want}")
    check_against_ref(name, run, ref, extra["rounds"])
    check_main_path({name: run}, FLConfig().b_init)
    dense_gb = resnet_dense_peak_bytes * extra["n_clients"] / MAIN["n_clients"] / 1e9
    card_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    require(run["peak_bytes"] / 1e9 < min(dense_gb, card_gb), f"{name}: peak {run['peak_bytes'] / 1e9} GB")
    print(json.dumps({"phase": "async_stream", "run": name, "config": extra, "d": run["d"],
                      "launches": run["launches"], "round_seconds": [r["seconds"] for r in run["rounds"]],
                      "round_seconds_ref": [r["seconds"] for r in ref["rounds"]],
                      "peak_gb": run["peak_bytes"] / 1e9, "peak_gb_ref": ref["peak_bytes"] / 1e9,
                      "dense_peak_gb_reckoned": dense_gb, "card_gb": card_gb,
                      "loss": [r["loss"] for r in run["rounds"]], "b": [r["b"] for r in run["rounds"]],
                      "acc": run["acc"], "equal_rounds": extra["rounds"]}), flush=True)
    runs[name] = run
    return runs


def wires_trees_expected_launches(extra: dict) -> dict:
    """One phase-8 run's launches. With the kernels: one prox step (B4) a
    local step of each chunk (the whole cohort in a dense round); the
    one-bit wire's pack kernel (B1) once a chunk, and the top-k wire's once
    a round (``quant_pack_u``, the cohort's gathered values in one launch,
    error feedback or not); no B1 on the k-bit wire and no vote count (B3)
    anywhere: the reference has no kernel for the k-bit quantizer or the
    k-bit, sparse and tree estimates. Without the kernels, none."""
    rounds, n = MAIN["rounds"], MAIN["n_clients"]
    steps = MAIN["local_epochs"] * MAIN["per_client"] // MAIN["batch_size"]
    out = dict.fromkeys(KERNELS, 0)
    if not extra.get("use_kernels", True):
        return out
    from repro_torch.fl.hierarchy import edge_slices

    chunk = extra.get("client_chunk")
    slices = edge_slices(n, extra.get("tree_edges") or 1)
    chunks = sum(-(-n_e // (chunk or n_e)) for _, n_e in slices)
    out["prox_sgd"] = rounds * chunks * steps
    if extra.get("topk_frac", 1.0) < 1.0:
        out["stoch_quant_pack"] = rounds
    elif extra.get("wire_bits", 1) == 1:
        out["stoch_quant_ef" if extra.get("error_feedback") else "stoch_quant_pack"] = rounds * chunks
    return out


def wire_row_bytes(cfg, d: int) -> float:
    """Uplink bytes of a client's row as the run's wire carries it: the
    top-k price (indices and codes), the mean over a mixed-width cohort, or
    the compressor's padded row."""
    from repro_torch.core.quantizer import padded_dim, wire_bytes

    if cfg.topk_frac < 1.0:
        return wire_bytes(d, topk_frac=cfg.topk_frac)
    comp = cfg.pipeline().compressor
    if cfg.client_bits:
        d_pad = padded_dim(d, comp.chunk)
        return sum(wire_bytes(d, k, d_pad=d_pad) for k in cfg.client_bits) / len(cfg.client_bits)
    return comp.wire_bytes(d)


def wires_trees_runs(dev, main: dict, stream: dict) -> dict:
    """Phase 8: each WIRES_TREES variant through the kernels (where it has
    any) and its engine="ref" rerun, with its launch counts, every round
    equal to the rerun's (theta, loss, b), finite, b moving as the
    controller moves it; (o) equal to phase 4d's (g) in theta and b, the
    reference's zero-staleness claim (its loss sums edge by edge). (m1),
    one group of one-bit clients, is (a)'s wire but the mixed-width merge's
    ``sum_g w_g theta_g / sum_g w_g`` rounds twice: its first round's theta
    is held within 2 ulps of (a)'s and the count of coordinates that differ
    is printed. (l-dp) prints the randomized-response weight of each
    round's range."""
    import numpy as np
    import torch

    from repro_torch.core import rr_gamma
    from repro_torch.fl import FLConfig

    runs, t0 = {}, time.perf_counter()
    for v, extra in WIRES_TREES.items():
        tag = f"mlp128-m100/{v}"
        run = run_sim(dev, v, extra)
        ref = run_sim(dev, v, extra, engine="ref")
        want = wires_trees_expected_launches(extra)
        require(run["launches"] == want, f"{tag}: launches {run['launches']} != expected {want}")
        check_against_ref(tag, run, ref, MAIN["rounds"])
        check_main_path({tag: run}, FLConfig().b_init)
        cfg = FLConfig(**{**MAIN_CFG, **extra})
        line = {"phase": "wires_trees", "run": tag, "config": {k: (list(x) if isinstance(x, tuple) else x)
                                                                for k, x in extra.items()},
                "launches": run["launches"], "round_seconds": [r["seconds"] for r in run["rounds"]],
                "round_seconds_ref": [r["seconds"] for r in ref["rounds"]],
                "wire_row_bytes": wire_row_bytes(cfg, run["d"]), "peak_gb": run["peak_bytes"] / 1e9,
                "loss": [r["loss"] for r in run["rounds"]], "b": [r["b"] for r in run["rounds"]],
                **{k: [r[k] for r in run["rounds"]] for k in ("buf_fill", "mean_age") if k in run["rounds"][0]},
                "acc": run["acc"], "equal_rounds": MAIN["rounds"]}
        if v == "o":
            g = stream["mlp128-m100/g"]["rounds"]
            differ = [int((k["theta"] != r["theta"]).sum()) for k, r in zip(run["rounds"], g)]
            require(not any(differ) and all(k["b"] == r["b"] for k, r in zip(run["rounds"], g)),
                    f"{tag}: {differ} coordinates of theta differ from phase 4d's (g), or b does")
            line["theta_coords_differing_from_g"] = differ
        if v == "m1":
            a = main["a"]["rounds"]
            t_m1, t_a = run["rounds"][0]["theta"], a[0]["theta"]
            ulps = ((t_m1 - t_a).abs() / torch.finfo(torch.float32).eps / t_a.abs().clamp(min=1e-30)).max().item()
            require(ulps <= 4.0, f"{tag}: round 0 theta {ulps} ulps from (a)'s")
            line["theta_coords_differing_from_a"] = [int((k["theta"] != r["theta"]).sum())
                                                     for k, r in zip(run["rounds"], a)]
            line["round0_max_rel_diff_from_a_in_eps"] = ulps
        if v == "l-dp":
            bs = [FLConfig().b_init] + [r["b"] for r in run["rounds"][:-1]]
            gammas = [rr_gamma(cfg.dp_epsilon, cfg.l1_sensitivity, torch.tensor([b]), cfg.wire_bits).item() for b in bs]
            require(all(0.0 < x < 1.0 for x in gammas), f"{tag}: rr_gamma {gammas}")
            line["rr_gamma"] = [min(gammas), max(gammas)]
        require(all(np.isfinite(r["loss"]) for r in run["rounds"]), f"{tag}: loss")
        print(json.dumps(line), flush=True)
        runs[tag] = run
    print(json.dumps({"phase": "wires_trees_done", "seconds": time.perf_counter() - t0, "runs": len(runs)}),
          flush=True)
    return runs


def grid_expected_launches(extra: dict) -> dict:
    """One grid run's launches: PRoBit+ compresses (B1) and counts (B3)
    once a round whatever its cohort; every scheme takes one prox step (B4)
    a local step for the whole active cohort."""
    rounds = MAIN["rounds"]
    probit = extra.get("aggregator", "probit_plus") == "probit_plus"
    return {"stoch_quant_pack": rounds if probit else 0, "stoch_quant_ef": 0,
            "bit_aggregate": rounds if probit else 0,
            "prox_sgd": rounds * MAIN["local_epochs"] * MAIN["per_client"] // MAIN["batch_size"]}


def grid_run(dev, name: str, extra: dict, engine=None) -> dict:
    """One Byzantine-grid run: launches of its own run, each round's theta,
    loss, b and wall time, and the bound its scheme puts on theta (checked
    after the round's timing)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    sim = make_sim(dev, extra, engine)
    cfg = sim.cfg
    recs = []
    w_prev = sim.w_global
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t, met in sim.iter_rounds():
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        theta, loss = met["theta"].clone(), met["loss"].item()
        tag = f"grid {name} round {t}"
        require(np.isfinite(loss) and bool(torch.isfinite(theta).all()), f"{tag}: loss {loss} or theta not finite")
        mag = theta.abs()
        if cfg.aggregator == "probit_plus":
            if cfg.b_mode == "oracle":
                # b_i = max_m |delta_i^m|, and the deltas of an attack-free
                # full cohort are the new local models minus the old global
                require(cfg.attack == "none" and cfg.participation == 1.0, f"{tag}: no oracle bound")
                bound = (sim.w_locals - w_prev).abs().amax(0)
            else:
                require(cfg.b_mode == "fixed" and not cfg.dp_epsilon, f"{tag}: no scalar bound")
                bound = torch.tensor(np.float32(cfg.b_init), device=dev)
            require(bool((mag <= bound).all()), f"{tag}: |theta| exceeds b by {(mag - bound).max().item()}")
        elif cfg.aggregator == "signsgd_mv":
            step = np.float32(cfg.agg_step)
            require(bool(((mag == 0) | (mag == step)).all()), f"{tag}: |theta| outside {{0, step}}")
        elif cfg.aggregator == "rsa":
            cap = np.float32(cfg.agg_step) * np.float32(cfg.n_active)
            require(bool((mag <= cap).all()), f"{tag}: |theta| {mag.max().item()} > step * M = {cap}")
        recs.append({"loss": loss, "b": met["b"].item(), "theta": theta, "seconds": seconds})
        w_prev = sim.w_global
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    launches = {k: _build.launches[k] for k in KERNELS}
    require(set(_build.launches) <= set(KERNELS), f"grid {name}: unknown kernel {dict(_build.launches)}")
    return {"rounds": recs, "launches": launches, "acc": sim.evaluate(), "peak_bytes": torch.cuda.max_memory_allocated(dev)}


def byzantine_grid(dev) -> dict:
    """Phase 4b: every GRID run through the kernels, its launch counts, its
    engine="ref" rerun round for round, and its printed times; then
    prng.normal and prng.choice on the card against the CPU."""
    import torch

    from repro_torch import prng

    runs = {}
    for name, over in GRID.items():
        extra = {**GRID_BASE, **over}
        run = grid_run(dev, name, extra)
        ref = grid_run(dev, name, extra, engine="ref")
        want = grid_expected_launches(extra)
        require(run["launches"] == want, f"grid {name}: launches {run['launches']} != expected {want}")
        require(not any(ref["launches"].values()), f"grid {name}: the engine='ref' run launched {ref['launches']}")
        require(len(run["rounds"]) == len(ref["rounds"]) == MAIN["rounds"], f"grid {name}: rounds differ")
        for t, (k, r) in enumerate(zip(run["rounds"], ref["rounds"])):
            require(torch.equal(k["theta"], r["theta"]) and k["loss"] == r["loss"] and k["b"] == r["b"],
                    f"grid {name} round {t}: differs from the engine='ref' run")
        print(json.dumps({"phase": "byzantine_grid", "run": name, "config": extra, "launches": run["launches"],
                          "round_seconds": [r["seconds"] for r in run["rounds"]],
                          "round_seconds_ref": [r["seconds"] for r in ref["rounds"]],
                          "loss": [r["loss"] for r in run["rounds"]], "b": [r["b"] for r in run["rounds"]],
                          "acc": run["acc"], "peak_gb": run["peak_bytes"] / 1e9}), flush=True)
        runs[name] = run

    key = prng.fold_in(prng.key(13), 1)
    normal = prng.normal(key.to(dev), (30, 118_282), scale=10.0).cpu()
    require(torch.equal(normal.view(torch.int32), prng.normal(key, (30, 118_282), scale=10.0).view(torch.int32)),
            "prng.normal on the card differs from the CPU's")
    for n in (100, 1_000, 2_000):
        require(torch.equal(prng.choice(key.to(dev), n, (n // 2,)).cpu(), prng.choice(key, n, (n // 2,))),
                f"prng.choice(n={n}) on the card differs from the CPU's")
    print(json.dumps({"phase": "byzantine_grid_done", "runs": len(runs), "equal_rounds": MAIN["rounds"],
                      "normal_shape": [30, 118_282], "choice_n": [100, 1_000, 2_000]}), flush=True)
    return runs


# Phase 7: the campaign engine (repro_torch.sim) on the paper's MLP at full
# width with the kernels, 3 rounds, seeds (0, 1): (h) Table I's 28 cells
# (benchmarks/table1_byzantine.py: 4 attacks x 7 methods, the async row
# included); (i) Fig. 4's 11 cells (benchmarks/fig4_clients_privacy.py:
# M-sweeps of PRoBit+ and FedAvg, eps at M = 20); (j) phase 4's (a) with
# seeds 0-7 as one group of 8 runs of 100 clients.
TABLE1_ATTACKS = ("gaussian", "sign_flip", "zero_gradient", "sample_duplicate")
TABLE1_METHODS = (
    ("probit_plus", {}),
    ("probit_plus_dp", {"dp_epsilon": 0.1}),
    ("probit_plus_async", {"async_buffer": 10, "async_latency": 1.0, "staleness_decay": 0.5}),
    ("rsa", {"aggregator": "rsa"}),
    ("signsgd_mv", {"aggregator": "signsgd_mv"}),
    ("fed_gm", {"aggregator": "fed_gm"}),
    ("fedavg", {"aggregator": "fedavg"}),
)
FIG4_CLIENTS = (5, 10, 20, 40)
FIG4_EPSILONS = (1.0, 0.1, 0.01)
# Phase 7 (i1): phase 8's runs on the k-bit (with DP), mixed-width and top-k
# (with error feedback) wires and its sum, median and buffered trees, each a
# campaign group of its seeds.
WIRE_GROUP_CELLS = ("k", "l-dp", "m", "n-ef", "o", "o-med", "o-buf")
CAMPAIGN_SEEDS = (0, 1)
COHORT_SEEDS = tuple(range(8))


def campaign_specs() -> dict:
    """Phase 7's grids as campaign specs, written out here (this script
    imports neither ``benchmarks`` nor the JAX package)."""
    from repro_torch.sim import CampaignSpec, CellSpec

    common = {"rounds": MAIN["rounds"], "local_epochs": MAIN["local_epochs"], "batch_size": MAIN["batch_size"],
              "use_kernels": True}
    table1 = CampaignSpec(
        base={**common, "n_clients": 10, "byz_frac": 0.1, "b_mode": "fixed"},
        cells=tuple(CellSpec(f"{attack}_{name}", {"aggregator": "probit_plus", **kw, "attack": attack})
                    for attack in TABLE1_ATTACKS for name, kw in TABLE1_METHODS),
        seeds=CAMPAIGN_SEEDS)
    fig4 = CampaignSpec(
        base={**common, "aggregator": "probit_plus"},
        cells=tuple(CellSpec(f"M={m}_{short}", {"n_clients": m, "aggregator": agg})
                    for m in FIG4_CLIENTS for short, agg in (("probit", "probit_plus"), ("fedavg", "fedavg")))
        + tuple(CellSpec(f"eps={eps}", {"n_clients": 20, "dp_epsilon": eps}) for eps in FIG4_EPSILONS),
        seeds=CAMPAIGN_SEEDS)
    wire_groups = CampaignSpec(
        base={**common, "n_clients": MAIN["n_clients"], "aggregator": "probit_plus", "b_mode": "dynamic"},
        cells=tuple(CellSpec(name, WIRES_TREES[name]) for name in WIRE_GROUP_CELLS), seeds=CAMPAIGN_SEEDS)
    cohort = CampaignSpec(
        base={**common, "n_clients": MAIN["n_clients"], "aggregator": "probit_plus", "b_mode": "dynamic"},
        cells=(CellSpec("a"),), seeds=COHORT_SEEDS)
    return {"table1": table1, "fig4": fig4, "wire_groups": wire_groups, "cohort": cohort}


def campaign_task(dev, engine=None):
    """The campaign's task provider: phase 4's MLP data split among each
    cell's clients (100 samples a client), on the card."""
    from repro_torch.sim import Task

    @functools.lru_cache(maxsize=None)
    def task(n_clients: int):
        p0, cx, cy, test, loss_fn, acc_fn = _task("mlp128-m100", None, n_clients)
        return Task(p0, loss_fn, acc_fn, cx, cy, test, device=dev, engine=engine)

    return lambda cfg: task(cfg.n_clients)


def wire_or_tree(cfg) -> bool:
    """Is the group's config a tree or on the k-bit, mixed-width or top-k
    wire (phase 8's variants)? Read from the config here, not from the code
    under test."""
    return bool(cfg.tree_edges or cfg.wire_bits > 1 or cfg.client_bits is not None or cfg.topk_frac < 1.0)


def campaign_expected_launches(group, cfgs, n_seeds: int, per_client: int = MAIN["per_client"]) -> dict:
    """One group's launches, for all its runs at once: B1 once a round (a
    streamed group: once a chunk of each round) and B4 once a local step
    (of each chunk), and B3 once a round only when synchronous, unstreamed
    and unmasked (PRoBit+; a fused group's, an asynchronous group's and a
    streamed group's estimates count with the plain weighted or streamed
    counts). A tree or a k-bit, mixed-width or top-k group launches what
    one of its runs does in phase 8 (:func:`wires_trees_expected_launches`,
    at the main path's cohort), once for the group: a tree B1 (B2 with
    error feedback) once an edge's chunk and B4 once a local step of each
    chunk, a top-k group B1 once a round, a k-bit or mixed-width group no
    B1, and none of them B3."""
    import dataclasses

    cfg = cfgs[group.cell_idx[0]]
    if wire_or_tree(cfg):
        require((cfg.n_clients, cfg.rounds, cfg.local_epochs, cfg.batch_size, per_client)
                == tuple(MAIN[k] for k in ("n_clients", "rounds", "local_epochs", "batch_size", "per_client")),
                "a tree or wire group is counted at the main path's cohort")
        return wires_trees_expected_launches(dataclasses.asdict(cfg))
    steps = cfg.local_epochs * per_client // cfg.batch_size
    chunk = group.client_chunk or cfg.client_chunk
    chunks = -(-group.m_pad // chunk) if chunk else 1
    probit = cfg.aggregator == "probit_plus"
    dense_sync = cfg.async_buffer == 0 and not chunk and not group.fused
    return {"stoch_quant_pack": cfg.rounds * chunks if probit else 0, "stoch_quant_ef": 0,
            "bit_aggregate": cfg.rounds if probit and dense_sync else 0, "prox_sgd": cfg.rounds * steps * chunks}


def group_run(dev, group, cfgs, spec, engine=None, task_fn=None) -> dict:
    """One plan group through its prepared runner (the one run_campaign
    calls) on ``task_fn``'s tasks (phase 7's by default): the
    trajectories, each run's final global model (one row a run: the
    rounds ran once for the group), the group's own launches and its
    seconds."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.sim import campaign
    from repro_torch.sim.plan import CompileCache

    task_fn = task_fn or campaign_task(dev, engine)
    prepare, args, *_ = campaign._prepare_group(group, cfgs, spec, task_fn, with_acc=True, shard=False,
                                                cache=CompileCache())
    runner = prepare(*args)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    traj, final = runner.run()
    torch.cuda.synchronize()
    return {"traj": {k: v.cpu() for k, v in traj.items()}, "final": final, "launches": dict(_build.launches),
            "seconds": time.perf_counter() - t0, "runs": final.shape[0] if final.dim() == 2 else 1}


def sequential_run(dev, cfg, task_fn=None) -> dict:
    """One cell and seed through FLSimulation on the card, on ``task_fn``'s
    task (phase 7's by default): each round's loss, b, accuracy and wall
    time, and the final global model."""
    import torch

    from repro_torch.fl import FLSimulation

    if task_fn is None:
        p0, cx, cy, test, loss_fn, acc_fn = _task("mlp128-m100", None, cfg.n_clients)
    else:
        t = task_fn(cfg)
        p0, loss_fn, acc_fn, cx, cy, test = t.init_params, t.loss_fn, t.acc_fn, t.client_x, t.client_y, t.test
    sim = FLSimulation(cfg, p0, loss_fn, acc_fn, cx, cy, test, device=dev)
    recs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, met in sim.iter_rounds():
        rec = {"loss": met["loss"].item(), "b": met["b"].item(), "acc": sim.evaluate()}
        rec["seconds"] = time.perf_counter() - t0
        recs.append(rec)
        t0 = time.perf_counter()
    return {"rounds": recs, "final": sim.w_global}


def hold_groups(dev, tag: str, spec, plan, result, task_fn=None, per_client: int = MAIN["per_client"],
                with_ref: bool = True) -> dict:
    """Each plan group of a campaign already run (``result``) through its
    prepared runner again on ``task_fn``'s tasks (phase 7's by default),
    with its own launch counts (:func:`campaign_expected_launches`) and
    seconds, run as one group where its config calls for it, its
    trajectories equal to the campaign's; with ``with_ref`` equal to its
    engine="ref" rerun exactly; every cell and seed against its sequential
    FLSimulation run (b exact, loss within rtol 1e-6, accuracy within
    1e-6), counting the runs equal bit for bit in the final model and every
    loss."""
    import dataclasses

    import numpy as np
    import torch

    cfgs = spec.configs()
    n_seeds = len(spec.seeds)
    groups, finals, seq_s, exact, n_runs = [], [], 0.0, 0, 0
    for group, stats in zip(plan.groups, result.groups):
        names = [spec.cells[i].name for i in group.cell_idx]
        require(stats["cells"] == names, f"{tag}: group order {stats['cells']} != {names}")
        run = group_run(dev, group, cfgs, spec, task_fn=task_fn)
        want = campaign_expected_launches(group, cfgs, n_seeds, per_client)
        got = {k: run["launches"].get(k, 0) for k in KERNELS}
        require(got == want, f"{tag} {names}: launches {got} != expected {want}")
        e_runs = len(group.cell_idx) * n_seeds
        require(run["runs"] == e_runs, f"{tag} {names}: {run['runs']} runs in one group, {e_runs} in the plan")
        if with_ref:
            ref = group_run(dev, group, cfgs, spec, "ref")
            require(not ref["launches"], f"{tag} {names}: the engine='ref' run launched {ref['launches']}")
            require(torch.equal(run["final"], ref["final"]) and set(run["traj"]) == set(ref["traj"])
                    and all(torch.equal(run["traj"][k], ref["traj"][k]) for k in run["traj"]),
                    f"{tag} {names}: differs from its engine='ref' rerun")
        group_seq_s = 0.0
        for j, i in enumerate(group.cell_idx):
            cell = result.cell(spec.cells[i].name)
            for s, seed in enumerate(spec.seeds):
                e = j * n_seeds + s
                for metric, values in run["traj"].items():
                    require(np.array_equal(cell.metrics[metric][s], values[e].numpy()),
                            f"{tag} {names[j]} seed {seed}: the runner's {metric} differs from the campaign's")
                seq = sequential_run(dev, dataclasses.replace(cfgs[i], seed=seed), task_fn)
                group_seq_s += sum(r["seconds"] for r in seq["rounds"])
                loss, b, acc = (np.asarray([r[k] for r in seq["rounds"]]) for k in ("loss", "b", "acc"))
                run_tag = f"{tag} {names[j]} seed {seed}"
                require(np.array_equal(cell.metrics["b"][s], b.astype(np.float32)),
                        f"{run_tag}: b {cell.metrics['b'][s]} != {b}")
                require(np.allclose(cell.metrics["loss"][s], loss, rtol=1e-6, atol=0), f"{run_tag}: loss differs")
                require(np.allclose(cell.metrics["acc"][s], acc, rtol=0, atol=1e-6), f"{run_tag}: acc differs")
                require(bool(np.isfinite(cell.metrics["loss"][s]).all()), f"{run_tag}: loss not finite")
                n_runs += 1
                exact += int(torch.equal(run["final"][e], seq["final"])
                             and np.array_equal(cell.metrics["loss"][s], loss.astype(np.float32)))
        seq_s += group_seq_s
        finals.append(run["final"].cpu())
        groups.append({"cells": names, "fused": stats["fused"], "m_pad": stats["m_pad"], "n_elems": stats["n_elems"],
                       "wall_s": stats["wall_s"], "compile_s": stats["compile_s"],
                       "cells_per_sec": stats["cells_per_sec"], "launches": got, "runner_seconds": run["seconds"],
                       "sequential_round_seconds_sum": group_seq_s,
                       # the runner's own rounds (synchronized) against the
                       # same runs one at a time; the campaign's wall_s
                       # also holds the dispatch of the groups after it
                       "group_speedup": group_seq_s / run["seconds"]})
    return {"groups": groups, "finals": finals, "sequential_round_seconds_sum": seq_s, "runs": n_runs,
            "bit_exact_runs": exact}


def campaign_phase(dev, name: str, spec, keep: bool = False) -> dict:
    """Phase 7, one grid: its plan; run_campaign through the kernels, its
    launches zeroed just before and read just after; then each group held
    (:func:`hold_groups`) to its own launches, the campaign's trajectories,
    its engine="ref" rerun and its runs' sequential FLSimulation runs.
    With ``keep`` the result also holds the campaign's result and each
    group's final models (phase 11 holds its sharded campaign to them)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.sim import plan_campaign, run_campaign
    from repro_torch.sim.plan import CompileCache

    plan = plan_campaign(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    result = run_campaign(spec, campaign_task(dev), plan=plan, compile_cache=CompileCache())
    wall = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in KERNELS}
    require(set(_build.launches) <= set(KERNELS), f"campaign {name}: unknown kernel {dict(_build.launches)}")
    peak = torch.cuda.max_memory_allocated(dev)
    held = hold_groups(dev, f"campaign {name}", spec, plan, result)
    out = {"phase": "campaign", "grid": name, "describe": plan.describe(), "cells": len(spec.cells),
           "seeds": list(spec.seeds), "runs": held["runs"], "programs": plan.n_programs, "wall_s": wall,
           "result_wall_s": result.wall_s, "cells_per_sec": result.cells_per_sec,
           "sequential_round_seconds_sum": held["sequential_round_seconds_sum"], "peak_gb": peak / 1e9,
           "launches": launches, "equal_to_ref_groups": len(held["groups"]), "equal_to_sequential_runs": held["runs"],
           "bit_exact_runs_final_model_and_loss": held["bit_exact_runs"], "groups": held["groups"],
           "final_acc": {c.name: c.final("acc")[0] for c in result.cells}}
    print(json.dumps(out), flush=True)
    return {"launches": launches, "stats": out, **({"result": result, "finals": held["finals"]} if keep else {})}


def cohort_phase(dev, spec, main_a: dict) -> dict:
    """Phase 7 (j): the cohort group of 8 runs of 100 clients, round by
    round through the round's group form (its steady round time and peak
    memory), nvidia-smi's busy share over its rounds and over the
    sequential driver's rounds of one run, against the 8 sequential runs'
    round times; then the campaign's checks (:func:`campaign_phase`)."""
    import torch

    from repro_torch import prng
    from repro_torch.fl import rounds as R
    from repro_torch.sim import batched, campaign, plan_campaign
    from repro_torch.sim.plan import CompileCache

    (group,) = plan_campaign(spec).groups
    cfgs = spec.configs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    prepare, args, *_ = campaign._prepare_group(group, cfgs, spec, campaign_task(dev), with_acc=True, shard=False,
                                                cache=CompileCache())
    runner = prepare(*args)
    require(runner.keys.shape == (len(spec.seeds), 2), "the cohort group is not one group of its runs")
    state, keys = batched.init_group_state(runner.ctx, runner.b_inits), runner.keys

    def rounds(n: int, timed: bool) -> list:
        nonlocal state, keys
        seconds = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            keys, kb, kr = prng.split(keys, 3).unbind(-2)
            state, _ = R.fl_round(runner.ctx, runner.group_params, kr, state, R.round_batches(runner.ctx, kb))
            R.accuracy(runner.ctx, state.w_global)
            if timed:
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return seconds

    round_s = rounds(MAIN["rounds"], True)
    peak = torch.cuda.max_memory_allocated(dev)
    steady = statistics.mean(round_s[1:])
    smi_group = smi_busy_share(lambda: rounds(max(6, int(4.0 / steady) + 1), False))
    seq_steady = statistics.mean(r["seconds"] for r in main_a["rounds"][1:])
    sim = make_sim(dev, VARIANTS["a"])
    it = sim.iter_rounds(max(8, int(4.0 / seq_steady) + 1) + 1)
    next(it)

    def seq_rounds():
        for _ in it:
            pass
        torch.cuda.synchronize()

    smi_seq = smi_busy_share(seq_rounds)
    del runner, state, sim
    torch.cuda.empty_cache()
    checked = campaign_phase(dev, "cohort", spec, keep=True)
    out = {"phase": "campaign_cohort", "E": len(spec.seeds), "M": MAIN["n_clients"], "d": 118_282,
           "rows": len(spec.seeds) * MAIN["n_clients"], "plane_mb": len(spec.seeds) * MAIN["n_clients"] * 118_282 * 4 / 1e6,
           "round_seconds": round_s, "steady_round_s": steady, "peak_gb": peak / 1e9,
           "smi_busy_share": smi_group, "sequential_smi_busy_share": smi_seq,
           "sequential_steady_round_s_one_run": seq_steady,
           "sequential_steady_round_s_8_runs": seq_steady * len(spec.seeds),
           "speedup_steady_rounds": seq_steady * len(spec.seeds) / steady,
           "cells_per_sec": checked["stats"]["cells_per_sec"], "campaign_wall_s": checked["stats"]["wall_s"],
           "sequential_round_seconds_sum": checked["stats"]["sequential_round_seconds_sum"]}
    print(json.dumps(out), flush=True)
    return checked


def model_rows(dev) -> dict:
    """Phase 7: why the round's group form takes each run's loss and gradient
    on its own rows. For the MLP at full width and runs of M = 10 and 100
    clients in a group of 8: whether a run's per-client losses and
    gradient computed among all 8M rows equal the run's own (M rows, a
    fresh tensor) bit for bit, and on the run's slice of the group's plane;
    the largest relative gradient difference; and the stream ms of one
    step's gradient both ways (:func:`stream_ms`)."""
    import torch

    from repro_torch import prng
    from repro_torch.fl import FLConfig
    from repro_torch.fl import rounds as R

    out, e = {}, len(COHORT_SEEDS)
    for m in (10, MAIN["n_clients"]):
        p0, cx, cy, test, loss_fn, acc_fn = _task("mlp128-m100", None, m)
        ctx = R.make_context(FLConfig(n_clients=m), p0, loss_fn, acc_fn, cx, cy, test, device=dev)
        gen = torch.Generator(device=dev).manual_seed(m)
        w = ctx.w0 + 0.01 * torch.randn(e * m, ctx.d, generator=gen, device=dev)
        group = R.round_batches(ctx, torch.stack([prng.key(s, dev) for s in range(e)]))
        batch = {k: v.reshape((e * m,) + v.shape[2:])[:, 0].contiguous() for k, v in group.items()}

        def loss_grad(w_rows, b):
            wg = w_rows.detach().requires_grad_(True)
            loss = ctx.loss_fn(ctx.unravel(wg), b)
            return loss.detach(), torch.autograd.grad(loss.sum(), wg)[0]

        def by_run():
            return [loss_grad(w[i * m:(i + 1) * m], {k: v[i * m:(i + 1) * m] for k, v in batch.items()})
                    for i in range(e)]

        all_loss, all_grad = loss_grad(w, batch)
        among, sliced, rel = [], [], 0.0
        for i, (s_loss, s_grad) in enumerate(by_run()):
            rows = slice(i * m, (i + 1) * m)
            own_loss, own_grad = loss_grad(w[rows].clone(), {k: v[rows].clone() for k, v in batch.items()})
            among.append(bool(torch.equal(all_loss[rows], own_loss) and torch.equal(all_grad[rows], own_grad)))
            sliced.append(bool(torch.equal(s_loss, own_loss) and torch.equal(s_grad, own_grad)))
            rel = max(rel, ((all_grad[rows] - own_grad).abs().max() / own_grad.abs().max()).item())
        out[f"M={m}"] = {"runs_equal_among_all_rows": sum(among), "runs_equal_on_own_rows": sum(sliced), "runs": e,
                         "max_rel_grad_diff_among_all_rows": rel,
                         "step_gradient_ms_all_rows": stream_ms(lambda: loss_grad(w, batch)),
                         "step_gradient_ms_by_run": stream_ms(by_run)}
        require(all(sliced), f"M={m}: a run's gradient on its own rows differs from the run alone")
    return {"phase": "campaign_model_rows", **out}


def campaign_runs(dev, main: dict) -> dict:
    """Phase 7: every grid of :func:`campaign_specs`; returns each one's
    launch counts for the kernel line, each requiring the launches of the
    path (B1, B3, B4)."""
    specs = campaign_specs()
    t0 = time.perf_counter()
    print(json.dumps(model_rows(dev)), flush=True)
    runs = {f"campaign/{name}": campaign_phase(dev, name, specs[name]) for name in ("table1", "fig4", "wire_groups")}
    runs["campaign/cohort"] = cohort_phase(dev, specs["cohort"], main["a"])
    for name in ("stoch_quant_pack", "bit_aggregate", "prox_sgd"):
        require(all(run["launches"][name] for grid, run in runs.items()
                    if grid != "campaign/wire_groups" or name != "bit_aggregate"),
                f"phase 7 never launched {name} in a grid")
    # (i1): the trees' and the top-k group's B1, every group's B4, once for
    # the group; no B3 (the k-bit, mixed-width, sparse and tree estimates
    # have no kernel)
    wire = runs["campaign/wire_groups"]
    want = {k: sum(g["launches"][k] for g in wire["stats"]["groups"]) for k in KERNELS}
    require(wire["launches"] == want and want["stoch_quant_pack"] and want["prox_sgd"] and not want["bit_aggregate"],
            f"phase 7 (i1): launches {wire['launches']}, its groups' {want}")
    print(json.dumps({"phase": "campaign_done", "seconds": time.perf_counter() - t0,
                      "launches": {k: run["launches"] for k, run in runs.items()}}), flush=True)
    return runs


# CUPTI's own records, which the profiler lists beside the kernels: host
# waits and buffer handling, not device work.
CUPTI_OVERHEAD = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")


def step_stream_ms(it, pipeline_cls) -> dict:
    """Stream ms of each step of the next round of ``it``, unprofiled: CUDA
    events recorded where the host enters and leaves local training and the
    estimate (``rounds.local_prox_train`` and ``pipeline_cls.estimate``
    wrapped for the round). Each span is the device time of the step's
    kernels plus any idle gap inside it, so in a round whose device is busy
    throughout it is the step's device time."""
    import unittest.mock as mock

    import torch

    from repro_torch.fl import rounds

    marks = {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def around(fn, before, after):
        def wrapped(*args, **kwargs):
            mark(before)
            out = fn(*args, **kwargs)
            mark(after)
            return out
        return wrapped

    with mock.patch.object(rounds, "local_prox_train", around(rounds.local_prox_train, "train0", "train1")), \
            mock.patch.object(pipeline_cls, "estimate", around(pipeline_cls.estimate, "est0", "est1")):
        torch.cuda.synchronize()
        mark("start")
        next(it)
        mark("end")
        torch.cuda.synchronize()
    order = ("start", "train0", "train1", "est0", "est1", "end")
    steps = ("batches", "local_train", "compress", "estimate", "finish")
    return {name: marks[a].elapsed_time(marks[b]) for name, a, b in zip(steps, order, order[1:])}


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                        _output_padding, _groups, output_mask, out_shape=None, **kwargs) -> int:
    """FLOPs of ``aten.convolution_backward``, grouped convolutions included:
    each gradient asked for costs what the forward costs. (torch's own
    formula counts a grouped weight gradient ``groups`` times over.)"""
    from torch.utils.flop_counter import conv_flop_count

    return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed=transposed) * sum(map(bool, output_mask[:2]))


def kernel_spans(events) -> dict:
    """The device kernels' records of one profiled round, by CUDA stream:
    ``union_ms`` is the time at least one kernel ran (the device's busy
    time), ``sum_ms`` the records' total. Within one stream kernels run one
    after another, so there each stream's union equals its sum up to the
    timestamps' rounding (``max_in_stream_overlap_ms``); records overlap
    only across streams, where kernels run at the same time."""
    from torch.autograd import DeviceType

    def union_sum(spans):
        union, end = 0.0, float("-inf")
        for lo, hi in sorted(spans):
            if hi > end:
                union += hi - max(lo, end)
                end = hi
        return union / 1e3, sum(hi - lo for lo, hi in spans) / 1e3

    by_stream = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name not in CUPTI_OVERHEAD and not e.name.startswith("round."):
            by_stream.setdefault(e.device_resource_id, []).append((e.time_range.start, e.time_range.end))
    union_ms, sum_ms = union_sum([span for spans in by_stream.values() for span in spans])
    streams = {}
    for sid, spans in sorted(by_stream.items(), key=lambda kv: -len(kv[1])):
        s_union, s_sum = union_sum(spans)
        streams[str(sid)] = {"kernels": len(spans), "sum_ms": s_sum, "union_ms": s_union}
    return {"union_ms": union_ms, "sum_ms": sum_ms, "streams": streams,
            "max_in_stream_overlap_ms": max((v["sum_ms"] - v["union_ms"] for v in streams.values()), default=0.0)}


def smi_busy_share(run) -> dict:
    """The device's busy share while ``run()`` runs, read by the driver
    rather than by the profiler: ``nvidia-smi``'s ``utilization.gpu`` (the
    share of its last sample period in which one or more kernels ran),
    polled every 100 ms. Samples from the first second are dropped, so every
    sample's period lies inside the run; the poller is stopped after."""
    import datetime
    import threading

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=timestamp,utilization.gpu",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    lines, first = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            first.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        require(first.wait(30), "nvidia-smi printed no utilization sample")
        t0 = datetime.datetime.now()
        run()
        t1 = datetime.datetime.now()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        reader.join(timeout=30)
    samples = []
    for line in lines:
        stamp, util = (f.strip() for f in line.split(","))
        t = datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
        if t0 + datetime.timedelta(seconds=1) <= t <= t1:
            samples.append(float(util))
    require(len(samples) >= 5, f"only {len(samples)} nvidia-smi samples inside a {t1 - t0} run")
    return {"share": statistics.mean(samples) / 100, "samples": len(samples),
            "min": min(samples) / 100, "seconds": (t1 - t0).total_seconds()}


# Rounds whose busy share nvidia-smi reads, per task: a few seconds of each.
SMI_ROUNDS = {"mlp128-m100": 40, "resnet18w64-m100": 1}


def profile_round(dev, task: str = "mlp128-m100") -> dict:
    """``--profile``: steady rounds of variant (a) of ``task``: one under
    ``torch.utils.flop_counter`` (the round's floating-point operations,
    convolutions and matmuls, by operator); one unprofiled, timed by step
    with CUDA events (:func:`step_stream_ms`); ``SMI_ROUNDS[task]``
    unprofiled, with the busy share nvidia-smi reads (:func:`smi_busy_share`);
    one under torch.profiler: host time of each round step (the ``round.*``
    ranges of fl/rounds.py), device time by operator and by kernel, and the
    busy share from the kernels' records, by stream (:func:`kernel_spans`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    def dev_ms(e, attr):
        us = getattr(e, attr, None)
        if us is None:
            us = getattr(e, attr.replace("device", "cuda"), 0.0)
        return us / 1e3

    sim = make_sim(dev, VARIANTS["a"], task=task)
    it = sim.iter_rounds(4 + SMI_ROUNDS[task])
    next(it)  # warm-up round
    with FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flops}) as flops:
        next(it)
    stream_ms = step_stream_ms(it, type(sim.pipeline))

    def smi_rounds():
        for _ in range(SMI_ROUNDS[task]):
            next(it)
        torch.cuda.synchronize()

    smi = smi_busy_share(smi_rounds)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        next(it)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and e.key not in CUPTI_OVERHEAD
               and not e.key.startswith("round.")]
    spans = kernel_spans(prof.events())
    require(spans["union_ms"] > 0, "the profiler saw no device time")
    host_ops = [e for e in avgs if e.device_type == DeviceType.CPU and not e.key.startswith("round.")
                and e.key not in CUPTI_OVERHEAD]
    top = sorted(host_ops, key=lambda e: dev_ms(e, "self_device_time_total"), reverse=True)[:15]
    top_kernels = sorted(kernels, key=lambda e: dev_ms(e, "self_device_time_total"), reverse=True)[:10]
    steps = [e for e in prof.events() if e.name.startswith("round.") and e.device_type == DeviceType.CPU]
    return {
        "phase": "profile", "task": task, "d": sim.d, "round_wall_ms": wall_ms,
        "device_busy_ms": spans["union_ms"], "kernel_ms_sum": spans["sum_ms"],
        "busy_share": spans["union_ms"] / wall_ms, "kernel_streams": spans["streams"],
        "max_in_stream_overlap_ms": spans["max_in_stream_overlap_ms"],
        "smi_busy_share": smi, "steps_stream_ms_unprofiled": stream_ms,
        "round_flops": flops.get_total_flops(),
        "round_flops_by_op": {str(k): v for k, v in flops.get_flop_counts()["Global"].items()},
        "local_train_tflops_per_s": flops.get_total_flops() / (stream_ms["local_train"] * 1e-3) / 1e12,
        # per round step: host time inside its range
        "steps_host_ms": {e.name: e.cpu_time_total / 1e3 for e in steps},
        "kernel_launches": sum(e.count for e in kernels),
        "top_ops": [{"name": e.key, "device_ms": dev_ms(e, "self_device_time_total"), "calls": e.count}
                    for e in top],
        "top_kernels": [{"name": e.key[:120], "device_ms": dev_ms(e, "self_device_time_total"), "calls": e.count}
                        for e in top_kernels],
    }


def check_main_path(runs, b_init: float) -> None:
    import numpy as np
    import torch

    for name, run in runs.items():
        b_prev = np.float32(b_init)
        for t, rec in enumerate(run["rounds"]):
            require(np.isfinite(rec["loss"]), f"variant {name} round {t}: loss {rec['loss']}")
            th = rec["theta"]
            require(th.shape == (run["d"],) and bool(torch.isfinite(th).all()), f"variant {name}: bad theta")
            moves = {np.float32(b_prev * np.float32(1.01)), np.float32(b_prev * np.float32(0.98))}
            require(np.float32(rec["b"]) in moves, f"variant {name} round {t}: b {rec['b']} from {b_prev}")
            b_prev = np.float32(rec["b"])


def kernel_times(dev, m: int, d: int, copy_gbs: float, elements: int = 1) -> dict:
    """Phase 5: each kernel at (m, d) against its plain version: device ms
    a launch, bytes, byte and operation bound, copy bound and GB/s; with
    ``elements`` > 1, the batched call of a campaign group of that many
    runs of m clients each (its own range b, w0 row and coefficients a
    run). Every input is made first, in one order of draws, and all stay
    live while the kernels are timed (at ResNet-18's shape, M = 100 and
    d = 11,172,042, 27 GB), then freed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.prox_sgd import prox_sgd
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(99)
    e, rows = elements, elements * m
    d_pad = ops.padded_len(d)
    p = d_pad // 8
    pad = d_pad - d
    delta = F.pad(0.01 * torch.randn(rows, d, generator=gen, device=dev), (0, pad), value=-1.0)
    res = F.pad(0.005 * torch.randn(rows, d, generator=gen, device=dev), (0, pad))
    u = F.pad(torch.rand(rows, d, generator=gen, device=dev), (0, pad), value=1.0)
    b = F.pad(torch.full((e, d), 0.01, device=dev), (0, pad), value=1.0)
    packed = stoch_quant_pack(delta, b, u).view(e, m, p) if e > 1 else stoch_quant_pack(delta, b[0], u)
    b_n = b[:, :d].contiguous() if e > 1 else b[0, :d]
    w = torch.randn(rows, d, generator=gen, device=dev)
    w0 = torch.randn(e, d, generator=gen, device=dev)
    g = torch.randn(rows, d, generator=gen, device=dev)
    mom = torch.randn(rows, d, generator=gen, device=dev)
    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev).expand(e, 3).contiguous()
    b_rows = b if e > 1 else b[0]
    b3_bytes, b3_ops = b3_work(m, d)
    b4_bytes, b4_ops = b4_work(m, d)

    # (kernel call, plain call, bytes moved, f32-class operations)
    cases = {
        "stoch_quant_pack": (lambda: stoch_quant_pack(delta, b_rows, u),
                             lambda: ref.stoch_quant_compress_ref(delta, b_rows, u),
                             8 * rows * d_pad + 4 * e * d_pad + rows * p, 7 * rows * d_pad),
        "stoch_quant_ef": (lambda: stoch_quant_ef(delta, res, b_rows, u),
                           lambda: ref.stoch_quant_compress_ref(delta, b_rows, u, res, want_residual=True),
                           16 * rows * d_pad + 4 * e * d_pad + rows * p, 9 * rows * d_pad),
        "bit_aggregate": (lambda: bit_aggregate(packed, b_n),
                          lambda: ref.bit_aggregate_ref(packed, b_n),
                          e * b3_bytes, e * b3_ops),
        # in place, as the round runs it (local_prox_train)
        "prox_sgd": (lambda: prox_sgd(w, w0, g, mom, coeffs, out=(w, mom)),
                     lambda: ref.prox_sgd_ref(w, w0, g, mom, coeffs, out=(w, mom)),
                     e * b4_bytes, e * b4_ops),
    }
    out = {}
    for name, (kern, plain, nbytes, ops_n) in cases.items():
        ms = timed_ms(kern)
        plain_ms = timed_ms(plain, reps=10)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops_n / PEAK_F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "gbs": nbytes / (ms * 1e-3) / 1e9, "share_of_bound": bound / ms,
            "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3,
            "shape": f"E={e} M={m} d={d} d_pad={d_pad}" if e > 1 else f"M={m} d={d} d_pad={d_pad}",
        }
    out["prox_sgd"]["fused_sgd_ms"] = stream_ms(fused_sgd(w, g, mom), reps=20)
    del cases, delta, res, u, packed, w, g, mom
    torch.cuda.empty_cache()
    return out


def topk_pack_times(dev, copy_gbs: float, m: int = 100, d: int = 118_282) -> dict:
    """Phase 5: B1 at the top-k wire's shape, as ``ops.quant_pack_u`` launches
    it for the main path (M rows of k = int(0.1 d) = 11,828 gathered values,
    padded to padded_len(k), one b row a client), against its plain
    version and its byte bound: each row's values, uniforms and range read
    once, its packed bytes written once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import padded_len
    from repro_torch.kernels.stoch_quant import stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(77)
    k = int(d * TOPK_FRAC)
    width = padded_len(k)
    pad = width - k
    delta = F.pad(0.01 * torch.randn(m, k, generator=gen, device=dev), (0, pad), value=-1.0)
    b = F.pad(0.005 + 0.01 * torch.rand(m, k, generator=gen, device=dev), (0, pad), value=1.0)
    u = F.pad(torch.rand(m, k, generator=gen, device=dev), (0, pad), value=1.0)
    ms = timed_ms(lambda: stoch_quant_pack(delta, b, u))
    plain_ms = timed_ms(lambda: ref.stoch_quant_compress_ref(delta, b, u), reps=10)
    nbytes, ops_n = 12 * m * width + m * width // 8, 7 * m * width
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops_n / PEAK_F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    return {"shape": f"M={m} k={k} padded={width} (d={d}, topk_frac={TOPK_FRAC})", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
            "gbs": nbytes / (ms * 1e-3) / 1e9, "share_of_bound": bound / ms,
            "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3}


def lm_leaf_times(dev, copy_gbs: float, d: int, m: int = 4) -> dict:
    """Phase 5: B1 and B3 at an LM leaf of d coordinates as phase 9
    launches them: B1 on one client's row (delta, b and u read once, the
    packed row written once), B3 on the round's M = 4 stored rows of that
    leaf (the rows and b read once, theta written once), each against its
    plain version on the same inputs."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.bit_aggregate import bit_aggregate
    from repro_torch.kernels.ops import padded_len
    from repro_torch.kernels.stoch_quant import stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(91)
    width = padded_len(d)
    require(width == d, f"the LM leaf {d} is not a whole number of kernel rows")
    delta = 0.01 * torch.randn(1, width, generator=gen, device=dev)
    b = torch.full((width,), 0.01, device=dev)
    u = torch.rand(1, width, generator=gen, device=dev)
    rows = torch.randint(0, 256, (m, width // 8), generator=gen, device=dev, dtype=torch.uint8)
    out = {}
    cases = {
        "stoch_quant_pack": (lambda: stoch_quant_pack(delta, b, u), lambda: ref.stoch_quant_compress_ref(delta, b, u),
                             12 * width + width // 8, 7 * width, f"M=1 d={d}"),
        "bit_aggregate": (lambda: bit_aggregate(rows, b), lambda: ref.bit_aggregate_ref(rows, b),
                          *b3_work(m, d), f"M={m} d={d} P={width // 8}"),
    }
    for name, (kern, plain, nbytes, ops_n, shape) in cases.items():
        ms = timed_ms(kern, reps=10)
        plain_ms = timed_ms(plain, reps=3, repeats=3)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops_n / PEAK_F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                     "gbs": nbytes / (ms * 1e-3) / 1e9, "share_of_bound": bound / ms,
                     "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3}
    del delta, b, u, rows, cases
    torch.cuda.empty_cache()
    return out


def single_client_times(dev, copy_gbs: float, d: int) -> dict:
    """Phase 5: B1 and B2 on one client's row of d coordinates, as the
    single-client entry launches them (delta, b and u read once, and the
    residual for B2; the packed row and B2's new residual written once),
    each against its plain version; and the whole entry
    ``kernels.stoch_quant_compress`` (its Threefry draw of the row's
    uniforms and the padding included) on each engine."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels, prng
    from repro_torch.kernels import ref
    from repro_torch.kernels.stoch_quant import stoch_quant_ef, stoch_quant_pack

    gen = torch.Generator(device=dev).manual_seed(93)
    width = kernels.padded_len(d)
    raw = 0.01 * torch.randn(d, generator=gen, device=dev)
    raw_res = 0.005 * torch.randn(d, generator=gen, device=dev)
    delta = F.pad(raw, (0, width - d), value=-1.0).reshape(1, width)
    res = F.pad(raw_res, (0, width - d)).reshape(1, width)
    u = F.pad(torch.rand(d, generator=gen, device=dev), (0, width - d), value=1.0).reshape(1, width)
    b = torch.full((width,), 0.01, device=dev)
    key = prng.fold_in(prng.key(12, dev), 3)
    cases = {
        "stoch_quant_pack": (lambda: stoch_quant_pack(delta, b, u), lambda: ref.stoch_quant_compress_ref(delta, b, u),
                             12 * width + width // 8, 7 * width,
                             lambda e: kernels.stoch_quant_compress(key, raw, b[:d], engine=e)),
        "stoch_quant_ef": (lambda: stoch_quant_ef(delta, res, b, u),
                           lambda: ref.stoch_quant_compress_ref(delta, b, u, res, want_residual=True),
                           20 * width + width // 8, 9 * width,
                           lambda e: kernels.stoch_quant_compress(key, raw, b[:d], raw_res, want_residual=True,
                                                                  engine=e)),
    }
    out = {}
    for name, (kern, plain, nbytes, ops_n, entry) in cases.items():
        ms = timed_ms(kern)
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops_n / PEAK_F32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        out[name] = {"shape": f"M=1 d={d} d_pad={width}", "ms": ms, "plain_ms": timed_ms(plain, reps=10),
                     "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bytes": nbytes,
                     "gbs": nbytes / (ms * 1e-3) / 1e9, "share_of_bound": bound / ms,
                     "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3,
                     "entry_ms": stream_ms(functools.partial(entry, "cuda")),
                     "entry_plain_ms": stream_ms(functools.partial(entry, "ref"))}
    del delta, res, u, cases
    torch.cuda.empty_cache()
    return out


def b4_work(m: int, d: int) -> tuple[int, int]:
    """(bytes, operations) of B4 on an ``(m, d)`` cohort with one shared w0
    row: w, grad and momentum read and w' and m' written once, w0 read once;
    6 operations an element."""
    return 20 * m * d + 4 * d, 6 * m * d


def fused_sgd(w, g, mom):
    """A yardstick of B4's traffic, not of its function: PyTorch's fused SGD
    with momentum on the same (M, d) tensors reads the parameters, the
    gradient and the momentum buffer and writes the parameters and the
    buffer (no w0); in place, like the round's B4. The call waits for the
    device before it returns, so it is timed on the stream (:func:`stream_ms`),
    not queued behind a device sleep."""
    import torch

    return functools.partial(torch._fused_sgd_, [w], [g], [mom], weight_decay=0.0, momentum=0.5, lr=0.01,
                             dampening=0.0, nesterov=False, maximize=False, is_first_step=False)


def kernel_rows(runs: dict, chk: Checker, at_main: dict, at_resnet: dict, at_group: dict, at_topk: dict,
                at_lm: dict) -> list[dict]:
    """The per-kernel JSON rows: times at the main path's shapes, with the
    same at ResNet-18's and the batched call at E = 8 runs of the main
    path's cohort beside them, B1 at the top-k wire's shape, and B1 and B3
    at the largest leaves of qwen2-1.5b and of the MoE (``at_lm``, by
    LM_LEAVES' keys) and B1 and B2 on one client's row (the single-client
    entry); ``launches`` is the sum over every run of phases 4, 4b, 4c, 4d,
    7, 8, 9, 11 (each rank's) and 13 of each one's own count, by run beside
    it."""
    rows = []
    for name, (source, replaces) in KERNELS.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(run["launches"][name] for run in runs.values()),
            "launches_by_variant": {v: run["launches"][name] for v, run in runs.items()},
            "max_abs_err": chk.max_err[name], "library_ms": None,
            **at_main[name], f"at_{RESNET_D}": at_resnet[name], "batched_E8_M100": at_group[name],
            **({"at_topk_M100": at_topk} if name == "stoch_quant_pack" else {}),
            **{where: times[name] for where, times in at_lm.items() if name in times},
        })
    return rows


def lm_expected_launches(n_leaves: int, clients: int, rounds: int, args) -> dict:
    """One phase-9 run's launches: on the kernel wire (PRoBit+ at 32-bit
    draws) one B1 a (client, leaf) and one B3 a leaf, each round; nothing
    at 16-bit draws (the reference refuses them on the kernel wire) or
    under FedAvg; never B2 (error feedback is off) or B4 (the LM's local
    step is plain bf16 without momentum, as in the reference)."""
    kernel_wire = args.aggregator == "probit_plus" and args.rand_bits == 32
    return {"stoch_quant_pack": clients * n_leaves * rounds if kernel_wire else 0, "stoch_quant_ef": 0,
            "bit_aggregate": n_leaves * rounds if kernel_wire else 0, "prox_sgd": 0}


def lm_stage_ms(fn) -> dict:
    """Stream ms of the LM round's stages while ``fn()`` runs one round,
    unprofiled: CUDA events around each call of the model's forward and
    backward (``fl_step._value_and_grad``), the local update
    (``fl_step._local_step``), a client leaf's compression (B1 with its
    Threefry uniforms, ``ClientCompressor.compress``) and a leaf's estimate
    (B3, ``AggregatorPipeline.estimate``), summed by stage; ``other`` is the
    rest of the round (the model difference, the new parameters, host
    gaps). In a round whose device is busy throughout, a stage's stream ms
    is its device time."""
    import unittest.mock as mock

    import torch

    from repro_torch.core.aggregation import AggregatorPipeline, ClientCompressor
    from repro_torch.launch import fl_step

    spans = {k: [] for k in ("forward_backward", "local_update", "compress", "estimate")}

    def around(f, name):
        def wrapped(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = f(*args, **kwargs)
            b.record()
            spans[name].append((a, b))
            return out
        return wrapped

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with mock.patch.object(fl_step, "_value_and_grad", around(fl_step._value_and_grad, "forward_backward")), \
            mock.patch.object(fl_step, "_local_step", around(fl_step._local_step, "local_update")), \
            mock.patch.object(ClientCompressor, "compress", around(ClientCompressor.compress, "compress")), \
            mock.patch.object(AggregatorPipeline, "estimate", around(AggregatorPipeline.estimate, "estimate")):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    out = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    out["round"] = start.elapsed_time(end)
    out["other"] = out["round"] - sum(out[k] for k in spans)
    return out


def lm_remat_probe(dev, run, params, batch) -> dict:
    """The local step's model alone on one client's first batch of ``batch``
    (``run``'s round batch): the forward without gradients, and the
    forward and backward (``fl_step._value_and_grad``) with each pattern
    unit checkpointed (the trainer's ``--remat``) and without: stream ms
    (CUDA events; the least of REMAT_PROBE_REPS) and the peak GB above the
    memory held before each. The two gradients must agree bit for bit."""
    import torch

    from repro_torch import tree
    from repro_torch.launch import fl_step
    from repro_torch.models import train_loss

    sb = {k: v[0, 0, 0] for k, v in batch.items()}
    leaves = tree.leaves(params)

    def timed(fn):
        best, peak = float("inf"), 0
        for _ in range(REMAT_PROBE_REPS):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            best = min(best, a.elapsed_time(b))
            peak = max(peak, torch.cuda.max_memory_allocated(dev) - base)
            del out
        return best, peak / 1e9

    def forward():
        with torch.no_grad():
            return train_loss(params, sb, run.cfg)

    out = {}
    out["forward_ms"], out["forward_peak_gb"] = timed(forward)
    for tag, remat in (("plain", False), ("remat", True)):
        out[f"fwd_bwd_{tag}_ms"], out[f"fwd_bwd_{tag}_peak_gb"] = timed(
            lambda remat=remat: fl_step._value_and_grad(leaves, params, sb, run.cfg, remat))
    g0 = fl_step._value_and_grad(leaves, params, sb, run.cfg, False)[1]
    g1 = fl_step._value_and_grad(leaves, params, sb, run.cfg, True)[1]
    differ = sum(int((x != y).sum()) for x, y in zip(g0, g1))
    require(differ == 0, f"remat probe: {differ} gradient entries differ with the unit checkpoint")
    del g0, g1
    torch.cuda.empty_cache()
    return out


def lm_run(dev, name: str, argv: list, with_ref: bool, cut: dict | None = None, keep: bool = False,
           keep_round0: bool = False, remat_probe: bool = False) -> dict:
    """One phase-9 variant through ``repro_torch.launch.train``'s own set-up,
    batches and step (``argv`` the trainer's flags; ``cut`` replaces fields
    of the ``--arch`` config, as the trainer has no depth flag): each
    round's losses, b, seconds and peak memory, the launches of the kernel
    steps (zeroed just before each, read just after), the stream ms by
    stage of the next-to-last round (of the only round of a one-round run),
    the busy share nvidia-smi reads over the last round, and, with
    ``with_ref``, each round against the
    ``engine="ref"`` step on the same inputs (new parameters bit for bit,
    b and both losses exact; it must launch nothing). With ``keep`` the
    result also holds the config and the final parameters (``"served"``),
    for phase 10; with ``keep_round0``, round 0's new parameters (on the
    host), b and losses (``"round0"``), for phase 12; with
    ``remat_probe``, :func:`lm_remat_probe` on round 0's batch and the
    final parameters (``"remat_probe"``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs, prng, tree
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.fl_step import make_fl_train_step

    args = train.parse_args(argv)
    cfg = dataclasses.replace(configs.get_config(args.arch), **cut) if cut else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = train.setup(args, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree.leaves(run.params)
    d, n_leaves, wire = sum(w.numel() for w in leaves), len(leaves), run.wire
    del leaves
    ref_step = make_fl_train_step(run.cfg, run.fl, engine="ref") if with_ref else None
    params, b, key = run.params, torch.tensor(args.b_init, dtype=torch.float32, device=dev), prng.key(1, dev)
    launches = {k: 0 for k in KERNELS}
    recs, busy, stages = [], None, None
    for r in range(args.rounds):
        batch = train.round_batch(run, args, r)
        key, kr = prng.split(key, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        out = []

        def step():
            out.append(run.step(params, b, batch, kr))
            torch.cuda.synchronize()

        def staged():
            nonlocal stages
            stages = lm_stage_ms(step)

        run_round = staged if r == max(args.rounds - 2, 0) else step
        t1 = time.perf_counter()
        if r == args.rounds - 1:
            busy = smi_busy_share(run_round)
        else:
            run_round()
        sec = time.perf_counter() - t1
        require(set(_build.launches) <= set(KERNELS), f"lm {name}: unknown kernel {dict(_build.launches)}")
        for k in KERNELS:
            launches[k] += _build.launches[k]
        new, b_new, met = out.pop()
        rec = {"loss_first": met["loss_first"].item(), "loss_last": met["loss_last"].item(), "b": b_new.item(),
               "seconds": sec, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        require(np.isfinite(rec["loss_first"]) and np.isfinite(rec["loss_last"]), f"lm {name} round {r}: {rec}")
        moves = {np.float32(np.float32(b.item()) * np.float32(f)) for f in (1.01, 0.98)}
        require(np.float32(rec["b"]) in moves, f"lm {name} round {r}: b {rec['b']} from {b.item()}")
        require(met["wire_bytes"] == run.wire["wire_bytes"], f"lm {name}: wire bytes {met['wire_bytes']} vs {run.wire}")
        if with_ref:
            _build.reset_launches()
            t1 = time.perf_counter()
            r_new, r_b, r_met = ref_step(params, b, batch, kr)
            torch.cuda.synchronize()
            rec["seconds_ref"] = time.perf_counter() - t1
            require(not any(_build.launches.values()), f"lm {name}: the engine='ref' step launched {_build.launches}")
            differ = sum(int((x != y).sum()) for x, y in zip(tree.leaves(new), tree.leaves(r_new)))
            require(differ == 0, f"lm {name} round {r}: {differ} parameters differ from the engine='ref' step")
            require(r_b.item() == rec["b"], f"lm {name} round {r}: b {rec['b']} vs ref {r_b.item()}")
            for k in ("loss_first", "loss_last"):
                require(r_met[k].item() == rec[k], f"lm {name} round {r}: {k} {rec[k]} vs ref {r_met[k].item()}")
            del r_new
        moved = sum(int((x != y).sum()) for x, y in zip(tree.leaves(new), tree.leaves(params)))
        require(moved > 0, f"lm {name} round {r}: no parameter moved")
        rec["params_moved"] = moved
        recs.append(rec)
        if keep_round0 and r == 0:
            round0 = {"params": [w.cpu() for w in tree.leaves(new)], "b": rec["b"], "loss_first": rec["loss_first"],
                      "loss_last": rec["loss_last"]}
        params, b = new, b_new
        del new
    want = lm_expected_launches(n_leaves, args.clients, args.rounds, args)
    require(launches == want, f"lm {name}: launches {launches} != expected {want}")
    probe = lm_remat_probe(dev, run, params, train.round_batch(run, args, 0)) if remat_probe else None
    served = (run.cfg, params) if keep else None
    del params, run, ref_step
    torch.cuda.empty_cache()
    return {"rounds": recs, "launches": launches, "expected_launches": want, "d": d, "leaves": n_leaves,
            "wire": wire, "init_seconds": init_s, "busy_last_round": busy,
            "stage_stream_ms_next_to_last_round": stages,
            "forward_backward_ms": None if stages is None else stages["forward_backward"], "with_ref": with_ref,
            **({"served": served} if keep else {}), **({"round0": round0} if keep_round0 else {}),
            **({"remat_probe": probe} if remat_probe else {})}


def lm_pytree_ef(dev) -> dict:
    """Phase 9 (q): ``aggregate_pytree`` with error feedback over the reduced
    qwen2's tree on the card, two rounds (the residuals carried): its B2 and
    B3 launches, each round equal to ``stream_aggregate_pytree`` in chunks of
    two clients (which launches B2 a chunk and counts with the plain int32
    count) and to the ``engine="ref"`` pipeline, thetas and residuals bit for
    bit."""
    import torch

    from repro_torch import configs, prng, tree
    from repro_torch.core import build_pipeline
    from repro_torch.fl import pytree_wire as pw
    from repro_torch.kernels import _build
    from repro_torch.models import build_specs, init_params

    m, chunk, rounds = LM_Q["clients"], LM_Q["client_chunk"], LM_Q["rounds"]
    cfg = configs.reduced(configs.get_config(LM_ARCH))
    params = init_params(build_specs(cfg), prng.key(0, dev))
    n_leaves = len(tree.leaves(params))
    gen = torch.Generator(device=dev).manual_seed(19)
    kern = build_pipeline("probit_plus", error_feedback=True, use_kernels=True)
    ref = build_pipeline("probit_plus", error_feedback=True, use_kernels=True, engine="ref")
    states = {k: pw.init_wire_state(params, m) for k in ("oneshot", "stream", "ref")}
    b = torch.tensor(0.01, device=dev)
    launches = {"oneshot": {k: 0 for k in KERNELS}, "stream": {k: 0 for k in KERNELS}}
    t0 = time.perf_counter()
    for r in range(rounds):
        deltas = tree.tree_map(lambda w: 0.01 * torch.randn((m,) + tuple(w.shape), generator=gen, device=dev), params)
        key = prng.fold_in(prng.key(7, dev), r)
        _build.reset_launches()
        t1, states["oneshot"] = pw.aggregate_pytree(kern, key, deltas, b, states["oneshot"])
        torch.cuda.synchronize()
        for k in KERNELS:
            launches["oneshot"][k] += _build.launches[k]
        _build.reset_launches()
        t2, states["stream"] = pw.stream_aggregate_pytree(kern, key, deltas, b, states["stream"], client_chunk=chunk)
        torch.cuda.synchronize()
        for k in KERNELS:
            launches["stream"][k] += _build.launches[k]
        _build.reset_launches()
        t3, states["ref"] = pw.aggregate_pytree(ref, key, deltas, b, states["ref"])
        require(not any(_build.launches.values()), f"lm q: the engine='ref' pipeline launched {_build.launches}")
        for other, st in ((t2, states["stream"]), (t3, states["ref"])):
            require(all(torch.equal(x, y) for x, y in zip(tree.leaves(t1), tree.leaves(other))),
                    f"lm q round {r}: theta differs between one-shot, streamed and ref")
            require(all(torch.equal(x, y) for x, y in zip(tree.leaves(states["oneshot"].residuals),
                                                          tree.leaves(st.residuals))),
                    f"lm q round {r}: residuals differ between one-shot, streamed and ref")
    zero = {k: 0 for k in KERNELS}
    want = {"oneshot": {**zero, "stoch_quant_ef": n_leaves * rounds, "bit_aggregate": n_leaves * rounds},
            "stream": {**zero, "stoch_quant_ef": n_leaves * rounds * (m // chunk)}}
    require(launches == want, f"lm q: launches {launches} != expected {want}")
    res_mass = max(float(x.abs().max()) for x in tree.leaves(states["oneshot"].residuals))
    require(res_mass > 0, "lm q: error feedback carried no mass")
    return {"phase": "lm", "run": "q", "arch": cfg.name, "d": sum(w.numel() for w in tree.leaves(params)),
            "leaves": n_leaves, "clients": m, "client_chunk": chunk, "rounds": rounds, "launches": launches,
            "expected_launches": want, "equal_rounds": rounds, "max_abs_residual": res_mass,
            "seconds": time.perf_counter() - t0}


def lm_runs(dev) -> tuple[dict, dict]:
    """Phase 9: LM_VARIANTS, (q), then LM_FAMILIES; prints one ``"phase":
    "lm"`` line a run. The wire of every run on the kernel wire must be
    ~1/32 of f32. Phase 10 serves the final parameters of each run in
    SERVE right after it (a ``"phase": "serve"`` line). Returns the runs and
    (r)'s round 0 (its new parameters on the host, b and losses), which
    phase 12 holds its model axis to."""
    import torch

    runs, served_s, t0, kept = {}, [], time.perf_counter(), {}

    def one(name, label, argv, with_ref, cut=None, want=None):
        run = lm_run(dev, name, argv, with_ref=with_ref, cut=cut, keep=name in SERVE, keep_round0=name == "r",
                     remat_probe=name in REMAT_PROBE)
        if name == "r":
            kept.update(run.pop("round0"))
        served = run.pop("served", None)
        line = {"phase": "lm", "run": label, "argv": argv, **({"cut": cut} if cut else {}), **run}
        if with_ref:
            ratio = run["wire"]["wire_bytes_f32"] / run["wire"]["wire_bytes"]
            require(31.0 < ratio <= 32.0, f"lm {name}: packed wire is 1/{ratio} of f32")
            line["f32_over_packed"] = ratio
        if want:
            require({k: run[k] for k in want} == want, f"lm {name}: d and leaves {run['d']}, {run['leaves']} != {want}")
        print(json.dumps(line), flush=True)
        runs[f"lm/{name}"] = run
        if served is not None:
            line = serve_run(dev, name, label, *served)
            print(json.dumps(line), flush=True)
            served_s.append(line["phase_seconds"])
            del served
            torch.cuda.empty_cache()

    for name, argv in LM_VARIANTS.items():
        one(name, f"{LM_ARCH}/{name}", LM_ARGS + argv, with_ref=name == "p")
    q = lm_pytree_ef(dev)
    print(json.dumps(q), flush=True)
    runs["lm/q-oneshot"] = {"launches": q["launches"]["oneshot"]}
    runs["lm/q-stream"] = {"launches": q["launches"]["stream"]}
    for name, (label, arch, cut, extra, want) in LM_FAMILIES.items():
        one(name, f"{label}/{name}", ["--arch", arch] + LM_COMMON + extra, with_ref=True, cut=cut, want=want)
    require(len(served_s) == len(SERVE), f"phase 10 served {len(served_s)} of {len(SERVE)} models")
    print(json.dumps({"phase": "lm_done", "seconds": time.perf_counter() - t0 - sum(served_s)}), flush=True)
    print(json.dumps({"phase": "serve_done", "seconds": sum(served_s), "models": len(served_s)}), flush=True)
    return runs, kept


def serve_prompts(vocab: int, n: int, lens: tuple[int, int]) -> list:
    """Phase 10's prompts: ``n`` lengths in ``[lens[0], lens[1]]`` and the
    tokens of each, drawn from the port's Threefry at SERVE_SEED."""
    from repro_torch import prng

    key = prng.key(SERVE_SEED)
    sizes = prng.randint(prng.fold_in(key, 0), (n,), lens[0], lens[1] + 1).tolist()
    return [prng.randint(prng.fold_in(prng.fold_in(key, 1), i), (k,), 0, vocab).tolist() for i, k in enumerate(sizes)]


def serve_layers(cfg, params) -> list:
    """The served model's layers one at a time, one of each kind (mixer and
    FFN): ``(tag, config, parameters)``, the parameters the first rep of
    that pattern position of ``params`` (views: nothing is made anew)."""
    import dataclasses

    from repro_torch.tree import tree_map

    out, seen = [], set()
    for u in range(cfg.unit):
        kind = (cfg.mixer_at(u), cfg.ffn_at(u))
        if kind in seen:
            continue
        seen.add(kind)
        moe_every = 1 if kind[1] == "moe" else 2 if cfg.n_experts else cfg.moe_every
        one = dataclasses.replace(cfg, pattern=(kind[0],), n_layers=1, moe_every=moe_every)
        require(one.ffn_at(0) == kind[1], f"serve {cfg.name}: layer {u} cut to {one.ffn_at(0)}")
        out.append((f"{u}:{'+'.join(kind)}", one,
                    {**params, "blocks": [tree_map(lambda a: a[:1], params["blocks"][u])]}))
    return out


def bf16_step(x: float) -> float:
    """One bf16 rounding step (ulp) at |x|."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 0.0


def first_tokens(dev, cfg, params, prompts, out) -> list:
    """Each prompt's first generated token beside prefill's logits at its
    last position: the argmax, the gap to the second, and whether the
    decoded token is prefill's argmax or, where prefill's top two are tied
    at bf16's resolution (the head's product is rounded to bf16), one of
    the tokens within one bf16 step of the top (``tie``)."""
    import torch

    from repro_torch.models import prefill

    rows = []
    with torch.no_grad():
        for p, o in zip(prompts, out):
            last = prefill(params, {"tokens": torch.tensor([p], device=dev)}, cfg)[0, -1]
            top2 = torch.topk(last, 2).values.tolist()
            step = bf16_step(top2[0])
            rows.append({"len": len(p), "decode": o[0], "prefill": int(last.argmax()), "top2_gap": top2[0] - top2[1],
                         "tie": top2[0] - top2[1] <= step and last[o[0]].item() >= top2[0] - step})
    return rows


def serve_check(dev, cfg, params, ring: bool, bars: tuple | None) -> dict:
    """Decode against prefill over SERVE_CHECK positions of a batch of 8
    drawn sequences, each position's decode logits against prefill's, and,
    with ``ring``, a ring of SERVE_RING slots stepped beside the full cache,
    against it while the history fits the ring and finite after. Returns
    the differences, relative to the largest prefill logit. Every logit must
    be finite, and position 0 (one key: nothing for the attention to
    amplify) within the dense bars; with ``bars``, every position and the
    ring within them too."""
    import torch

    from repro_torch import prng
    from repro_torch.models import init_cache, prefill, serve_step

    b = SERVE_CFG["batch_size"]
    toks = prng.randint(prng.fold_in(prng.key(SERVE_SEED), 2), (b, SERVE_CHECK), 0, cfg.vocab).to(dev)
    worst = {"decode_max": 0.0, "decode_mean": 0.0, "ring_max": 0.0, "ring_mean": 0.0}
    agree, finite, at0 = 0, True, None
    with torch.no_grad():
        pre = prefill(params, {"tokens": toks}, cfg)
        scale = pre.abs().max().item()
        full = init_cache(cfg, b, SERVE_CHECK, dev)
        rc = init_cache(cfg, b, SERVE_RING, dev) if ring else None
        for t in range(SERVE_CHECK):
            tok = {"tokens": toks[:, t : t + 1]}
            lf, full = serve_step(params, full, tok, t, cfg)
            diff = (lf - pre[:, t]).abs()
            at0 = diff.max().item() / scale if t == 0 else at0
            worst["decode_max"] = max(worst["decode_max"], diff.max().item() / scale)
            worst["decode_mean"] = max(worst["decode_mean"], diff.mean().item() / scale)
            agree += int((lf.argmax(-1) == pre[:, t].argmax(-1)).sum())
            finite &= bool(torch.isfinite(lf).all())
            if ring:
                lr, rc = serve_step(params, rc, tok, t, cfg, window=SERVE_RING)
                finite &= bool(torch.isfinite(lr).all())
                if t < SERVE_RING:
                    diff = (lr - lf).abs()
                    worst["ring_max"] = max(worst["ring_max"], diff.max().item() / scale)
                    worst["ring_mean"] = max(worst["ring_mean"], diff.mean().item() / scale)
    out = {"positions": SERVE_CHECK, "max_abs_prefill_logit": scale, "position0_max": at0, **worst,
           "argmax_agree_share": agree / (b * SERVE_CHECK), "ring": ring, "finite": finite, "bars": bars}
    require(finite, f"serve {cfg.name}: a logit is not finite {out}")
    require(at0 <= SERVE_BARS["dense"][0], f"serve {cfg.name}: position 0 against prefill {out}")
    if bars:
        require(worst["decode_max"] <= bars[0] and worst["decode_mean"] <= bars[1],
                f"serve {cfg.name}: decode against prefill {out}")
        require(not ring or (worst["ring_max"] <= bars[0] and worst["ring_mean"] <= bars[1]),
                f"serve {cfg.name}: the ring of {SERVE_RING} against the full cache {out}")
    return out


def serve_run(dev, name: str, label: str, cfg, params) -> dict:
    """Phase 10: serve phase 9's final parameters of run ``name`` through
    ``repro_torch.serving.ServingEngine`` (SERVE[name]'s traffic, greedy):
    the tokens a second and ms a step of its first run, peak memory,
    nvidia-smi's busy share over the traffic, run again until 3 s have
    passed (each rerun must give the same tokens), the cache's bytes and
    the engine's set-up seconds (no init: the parameters are phase 9's). Checks on the whole model: no kernel launch; every
    request gets its 32 tokens; with a sampled wave, T = SERVE_T at seed 0
    twice, the same tokens; :func:`serve_check` without bars (finite, and
    position 0 within them), its first tokens against prefill's argmax
    printed. Then every kind of layer of the model alone, at full width
    (:func:`serve_layers`): every prompt's first token prefill's argmax (or
    a bf16 tie of it, :func:`first_tokens`) and :func:`serve_check` within
    SERVE_BARS. At full depth the reference's init makes decode and prefill
    part (ROADMAP C, "Decode at depth"), in the reference as in the port."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.tree import leaves

    spec, t_start = SERVE[name], time.perf_counter()
    prompts = serve_prompts(cfg.vocab, spec["prompts"], spec["lens"])
    if name == "p":  # greedy ties go to the first index, as jnp.argmax breaks them
        ties = torch.zeros(SERVE_CFG["batch_size"], cfg.vocab, device=dev)
        first = cfg.vocab // 3
        ties[:, [cfg.vocab - 1, first, cfg.vocab // 2, first + 1]] = 1.0
        require(torch.argmax(ties, -1).tolist() == [first] * SERVE_CFG["batch_size"], "argmax ties on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, ServeConfig(**SERVE_CFG))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cache_bytes = sum(v.numel() * v.element_size() for v in leaves(eng.cache))
    runs = []

    def traffic():  # at least once, and until 3 s have passed (nvidia-smi's samples)
        t_end = time.perf_counter() + 3.0
        while not runs or time.perf_counter() < t_end:
            t0 = time.perf_counter()
            runs.append((eng.generate(prompts), time.perf_counter() - t0))

    busy = smi_busy_share(traffic)
    (out, wall), steps = runs[0], eng.steps
    n_new = SERVE_CFG["max_new_tokens"]
    require(all(len(o) == n_new and all(0 <= t < cfg.vocab for t in o) for o in out), f"serve {label}: {out}")
    require(all(r == out for r, _ in runs[1:]), f"serve {label}: a greedy rerun gave other tokens")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    firsts = first_tokens(dev, cfg, params, prompts, out)
    line = {"phase": "serve", "run": label, "arch": cfg.name, "layers": cfg.n_layers, "card": card_line(),
            "config": SERVE_CFG, "prompts": len(prompts), "prompt_lens": [len(p) for p in prompts],
            "waves": math.ceil(len(prompts) / SERVE_CFG["batch_size"]), "steps": steps, "seconds": wall,
            "tokens_per_s": len(prompts) * n_new / wall,
            "slot_tokens_per_s": steps * SERVE_CFG["batch_size"] / wall, "ms_per_step": 1e3 * wall / steps,
            "peak_gb": peak_gb, "busy": busy, "runs": len(runs), "cache_bytes": cache_bytes, "setup_seconds": setup_s,
            "first_tokens_agree": sum(f["decode"] == f["prefill"] for f in firsts)}
    if spec["sampled"]:
        seng = ServingEngine(cfg, params, ServeConfig(**SERVE_CFG, temperature=SERVE_T))
        wave = prompts[: SERVE_CFG["batch_size"]]
        t0 = time.perf_counter()
        s1 = seng.generate(wave, seed=0)
        sampled_s = time.perf_counter() - t0
        s2 = seng.generate(wave, seed=0)
        require(s1 == s2, f"serve {label}: the sampled wave did not repeat")
        require(s1 != out[: len(wave)], f"serve {label}: T = {SERVE_T} sampled the greedy tokens")
        line["sampled"] = {"temperature": SERVE_T, "seed": 0, "requests": len(wave), "seconds": sampled_s,
                           "tokens_per_s": len(wave) * n_new / sampled_s, "repeats_bit_for_bit": True}
        del seng
    del eng
    line["whole"] = serve_check(dev, cfg, params, spec["ring"], None)
    line["layers_alone"] = {}
    for tag, one, one_params in serve_layers(cfg, params):
        bars = SERVE_BARS["mamba" if one.mixer_at(0) == "mamba" else "dense"]
        one_out = ServingEngine(one, one_params, ServeConfig(**{**SERVE_CFG, "max_new_tokens": 1})).generate(prompts)
        rows = first_tokens(dev, one, one_params, prompts, one_out)
        require(all(r["decode"] == r["prefill"] or r["tie"] for r in rows), f"serve {label} layer {tag}: {rows}")
        line["layers_alone"][tag] = {"first_tokens_agree": sum(r["decode"] == r["prefill"] for r in rows),
                                     "first_tokens_tied": sum(r["decode"] != r["prefill"] for r in rows),
                                     **serve_check(dev, one, one_params, spec["ring"] and one.mixer_at(0) == "attn",
                                                   bars)}
    require(not any(_build.launches.values()), f"serve {label}: the serving path launched {_build.launches}")
    line["phase_seconds"] = time.perf_counter() - t_start
    return line


def graph_ms(fn) -> float:
    """Device ms of one call of a many-kernel stage: the call is captured
    once in a CUDA graph and :func:`timed_ms` replays the graph, one launch a
    call (eager calls queued behind the device sleep would fill the
    launch queue and stall the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return timed_ms(graph.replay, reps=10)


def stream_ms(fn, reps: int = 5) -> float:
    """Ms of one eager call on the stream, the host's launch gaps included:
    CUDA events around ``reps`` back-to-back calls after a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stage_times(dev) -> dict:
    """Phase 5: the grid's plain-torch stages at the main path's shapes
    (M = 100, d = 118,282): the servers' estimates, the sign wire, the
    oracle range and the gaussian attack's draw. ``device_ms`` is the
    kernels' time (:func:`graph_ms`); ``eager_ms`` what an eager call
    holds the stream, launch gaps included (:func:`stream_ms`)."""
    import torch

    from repro_torch import prng
    from repro_torch.core import aggregation as agg
    from repro_torch.core.bcontrol import oracle_b
    from repro_torch.core.privacy import DPConfig
    from repro_torch.core.quantizer import packed_counts, packed_sign_batch

    m, d = MAIN["n_clients"], 118_282
    gen = torch.Generator(device=dev).manual_seed(5)
    u = 0.01 * torch.randn(m, d, generator=gen, device=dev)
    packed = packed_sign_batch(u)
    wire = agg.PackedWire(packed=packed, b=torch.ones(d, device=dev), d=d)
    key = prng.key(3, dev)
    n_byz = int(m * GRID_BASE["byz_frac"])
    cases = {
        "fedavg_aggregate": lambda: agg.fedavg_aggregate(u),
        "geometric_median_16": lambda: agg.geometric_median(u, 16),
        "packed_sign_batch": lambda: packed_sign_batch(u),
        "packed_counts": lambda: packed_counts(packed),
        "signsgd_mv_estimate": lambda: agg.SignSGDMVServer().aggregate(wire),
        "oracle_b": lambda: oracle_b(u, DPConfig(0.0)),
        "normal_gaussian_attack": lambda: prng.normal(key, (n_byz, d), scale=10.0),
    }
    return {"phase": "stage_times", "shape": f"M={m} d={d} n_byz={n_byz}",
            "device_ms": {name: graph_ms(fn) for name, fn in cases.items()},
            "eager_ms": {name: stream_ms(fn) for name, fn in cases.items()}}


def b3_work(m: int, d: int) -> tuple[int, int]:
    """(bytes, operations) that B3's inputs need for ``m`` clients and ``d``
    coordinates, whatever the implementation: the ceil(d / 8) wire bytes of
    each row, b read and theta_hat written at length d; one vote add per
    coordinate per client (8 a wire byte) and the estimate's 4 operations
    per coordinate. Wire bytes past ceil(d / 8) hold no coordinate and are
    not read."""
    return m * ((d + 7) // 8) + 8 * d, m * d + 4 * d


# B3 over the cohort (phase 5): the main path's M = 100; 1,000, whose wire
# stays in the 50 MB L2 across repetitions; 10,000, well past it; and 300
# and 3,000, between the cluster sizes that launch_geometry picks.
B3_SWEEP_M = (100, 300, 1_000, 3_000, 10_000)
L2_BYTES = 50 << 20


def b3_sweep(dev, copy_gbs: float) -> dict:
    """Phase 5, B3 over the cohort: d = 118,282 and M in B3_SWEEP_M, each
    with its bytes, bound and share of bound through the wrapper (the
    cluster size launch_geometry picks), and the C entry's time at every
    cluster size, each checked against the wrapper's result first; the
    time of an empty kernel launched like B3 at M = 100
    (``launch_floor_ms``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.bit_aggregate import bit_aggregate, launch_geometry

    d = 118_282
    p = ops.padded_len(d) // 8
    gen = torch.Generator(device=dev).manual_seed(77)
    b = torch.rand(d, generator=gen, device=dev)
    out = torch.empty(d, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library("bit_aggregate")
    tiles, cluster = launch_geometry(B3_SWEEP_M[0], d)

    def empty():
        require(lib.probit_bit_aggregate_empty(tiles * cluster, cluster, stream) == 0, "empty launch failed")

    floor_batches = timed_batches(empty)
    rows = []
    for m in B3_SWEEP_M:
        packed = torch.randint(0, 256, (m, p), generator=gen, device=dev, dtype=torch.uint8)
        wrapper = functools.partial(bit_aggregate, packed, b)
        want = wrapper()
        batches = timed_batches(wrapper)
        ms = statistics.median(batches)
        nbytes, ops_n = b3_work(m, d)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_bytes, ops_n / PEAK_F32_OPS_PER_S * 1e3)
        tiles_m, picked = launch_geometry(m, d)
        recip = float(np.float32(1.0) / np.float32(m))
        by_cluster = {}
        for size in (1, 2, 4, 8):
            def launch():
                rc = lib.probit_bit_aggregate(packed.data_ptr(), b.data_ptr(), out.data_ptr(), m, p, d, recip,
                                              tiles_m, size, 1, stream)
                require(rc == 0, f"bit_aggregate M={m} cluster={size}: cudaError_t {rc}")

            out.fill_(float("nan"))
            launch()
            require(torch.equal(out, want), f"bit_aggregate M={m} cluster={size}: differs from the wrapper")
            by_cluster[size] = timed_ms(launch)
        rows.append({"M": m, "d": d, "P": p, "bytes": nbytes, "l2_resident": nbytes < L2_BYTES,
                     "bound_ms": bound, "bound_by": "bytes" if bound == t_bytes else "operations",
                     "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3,
                     "ms": ms, "min_ms": min(batches), "max_ms": max(batches),
                     "gbs": nbytes / (ms * 1e-3) / 1e9, "share_of_bound": bound / ms,
                     "tiles": tiles_m, "cluster": picked, "ms_by_cluster": by_cluster})
    return {"phase": "b3_sweep", "launch_floor_ms": statistics.median(floor_batches),
            "launch_floor_range_ms": [min(floor_batches), max(floor_batches)],
            "launch_floor_geometry": {"blocks": tiles * cluster, "cluster": cluster}, "rows": rows,
            "sass": b3_sass()}


# B4 over the cohort (phase 5): (M, d) at M = 100 from the MLP's width to
# ResNet-18's, then at M * d ~ 1.1e9 with more clients.
B4_SWEEP = ((100, 118_282), (100, 1_117_204), (100, RESNET_D), (1_000, 1_117_204), (10_000, 111_720))


def b4_candidates(m: int, d: int, device_index: int) -> dict:
    """Named (tile, rows per group, CTAs, vector) launches of B4 at (m, d):
    launch_geometry's choice and the variants that each undo one of its
    decisions (PERF.md, B4's suspects)."""
    from repro_torch.kernels.prox_sgd import launch_geometry, occupancy

    sms, per_sm = occupancy(device_index, True)
    tile, rows, ctas = launch_geometry(m, d, sms, per_sm)

    def units(tile, rows):
        return -(-d // tile) * -(-m // rows)

    waves = -(-ctas // (sms * per_sm))
    return {
        "chosen": (tile, rows, ctas, 1),
        "scalar": (tile, rows, ctas, 0),  # 4-byte accesses only
        "rows_1": (tile, 1, units(tile, 1), 1),  # w0 staged for every row
        "rows_4": (tile, 4, units(tile, 4), 1),
        "rows_all": (tile, m, units(tile, m), 1),  # w0 staged once: one unit a tile walks all M rows
        "persistent_waves": (tile, rows, -(-ctas // waves), 1),  # one wave of CTAs walking the units
        "tile_1024": (1024, 2 * rows, units(1024, 2 * rows), 1),
        "tile_4096": (4096, rows, units(4096, rows), 1),
    }


def b4_parent_ab(dev, parent: pathlib.Path) -> dict:
    """``--b4-parent DIR``: B4 of another checkout (DIR, whose C entry takes
    ``(eta, lam, mu)`` by value and a ``w0_row_stride``, as before the
    campaign's batched form) against this one's, in one process, at the
    MLP's shape and at ResNet-18's (M = 100, w0 one shared row, in place as
    the round runs it): built with this checkout's nvcc flags, checked bit
    for bit against each other, then timed (:func:`timed_ms`) in the order
    parent, this, this, parent."""
    import ctypes

    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.prox_sgd import launch_geometry, occupancy, prox_sgd

    src = parent / "src" / "repro_torch" / "kernels" / "csrc" / "prox_sgd.cu"
    out_dir = ROOT / "build" / "b4_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "prox_sgd_parent.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)], capture_output=True,
                          text=True)
    require(proc.returncode == 0, f"nvcc failed for the parent's prox_sgd.cu:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    P, I64, F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
    lib.probit_prox_sgd.argtypes = (P, P, P, P, P, P, F32, F32, F32, I64, I64, I64, I64, I64, I64, I64, P)
    lib.probit_prox_sgd.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
    eta, lam, mu = coeffs[0].tolist()
    gen = torch.Generator(device=dev).manual_seed(1357)
    shapes = []
    for m, d in ((MAIN["n_clients"], 118_282), (MAIN["n_clients"], RESNET_D)):
        w, g, mom = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
        w0 = torch.randn(d, generator=gen, device=dev)
        tile, rows, ctas = launch_geometry(m, d, *occupancy(dev.index, True))

        def parent_call(w_io=w, m_io=mom):
            rc = lib.probit_prox_sgd(w_io.data_ptr(), w0.data_ptr(), g.data_ptr(), m_io.data_ptr(), w_io.data_ptr(),
                                     m_io.data_ptr(), eta, lam, mu, m, d, 0, tile, rows, ctas, 1, stream)
            require(rc == 0, f"parent prox_sgd at M={m} d={d}: cudaError_t {rc}")

        w1, m1, w2, m2 = w.clone(), mom.clone(), w.clone(), mom.clone()
        parent_call(w1, m1)
        prox_sgd(w2, w0, g, m2, coeffs, out=(w2, m2))
        parent_call(w1, m1)
        prox_sgd(w2, w0, g, m2, coeffs, out=(w2, m2))
        require(torch.equal(w1, w2) and torch.equal(m1, m2), f"B4 at M={m} d={d} differs from the parent's")
        del w1, m1, w2, m2
        calls = {"parent": parent_call, "this": lambda: prox_sgd(w, w0, g, mom, coeffs, out=(w, mom))}
        order = ("parent", "this", "this", "parent")
        times = [timed_ms(calls[name]) for name in order]
        shapes.append({"m": m, "d": d, "geometry": [tile, rows, ctas], "order": list(order), "ms": times,
                       **{name: [t for o, t in zip(order, times) if o == name] for name in calls}})
        del w, g, mom, w0
        torch.cuda.empty_cache()
    return {"phase": "b4_parent_ab", "parent": str(parent), "shapes": shapes}


def b4_sweep(dev, copy_gbs: float) -> dict:
    """Phase 5, B4 over the cohort: for each (M, d) of B4_SWEEP, in place
    through the wrapper (launch_geometry's choice) with its bytes, bound and
    share of bound, and PyTorch's fused SGD on the same tensors
    (``fused_sgd_ms``); at the MLP's and ResNet-18's shapes, every launch of
    :func:`b4_candidates` through the C entry, each checked against the
    plain version first, and the wrapper out of place with torch's NaN fill
    of its two fresh outputs on (as the round ran B4 before in-place
    updates)."""
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.prox_sgd import launch_geometry, occupancy, prox_sgd

    gen = torch.Generator(device=dev).manual_seed(88)
    lib = _build.library("prox_sgd")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms, per_sm = occupancy(dev.index, True)
    coeffs = ops.prox_coeffs(0.01, 0.2, 0.5, dev)
    rows = []
    for m, d in B4_SWEEP:
        w, g, mom = (torch.randn(m, d, generator=gen, device=dev) for _ in range(3))
        w0 = torch.randn(d, generator=gen, device=dev)
        nbytes, ops_n = b4_work(m, d)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        bound = max(t_bytes, ops_n / PEAK_F32_OPS_PER_S * 1e3)
        row = {"M": m, "d": d, "bytes": nbytes, "bound_ms": bound,
               "bound_by": "bytes" if bound == t_bytes else "operations",
               "copy_bound_ms": nbytes / (copy_gbs * 1e9) * 1e3,
               "geometry": launch_geometry(m, d, sms, per_sm)}
        if (m, d) in ((100, 118_282), (100, RESNET_D)):
            w_out, m_out = torch.empty_like(w), torch.empty_like(w)
            by_candidate = {}
            for name, (tile, group_rows, ctas, vector) in b4_candidates(m, d, dev.index).items():
                def launch(w_o=w_out, m_o=m_out):
                    rc = lib.probit_prox_sgd(w.data_ptr(), w0.data_ptr(), g.data_ptr(), mom.data_ptr(),
                                             w_o.data_ptr(), m_o.data_ptr(), coeffs.data_ptr(), 0, m, d, m, tile,
                                             group_rows, ctas, vector, stream)
                    require(rc == 0, f"prox_sgd {name} at M={m} d={d}: cudaError_t {rc}")

                w_out.fill_(float("nan"))
                m_out.fill_(float("nan"))
                launch()
                want = ref.prox_sgd_ref(w, w0, g, mom, coeffs)  # of this candidate's inputs
                require(torch.equal(w_out, want[0]) and torch.equal(m_out, want[1]),
                        f"prox_sgd {name} at M={m} d={d}: differs from the plain version")
                del want
                ms = timed_ms(functools.partial(launch, w, mom))  # in place
                by_candidate[name] = {"geometry": [tile, group_rows, ctas], "vector": vector, "ms": ms,
                                      "share_of_bound": bound / ms}
            del w_out, m_out
            torch.utils.deterministic.fill_uninitialized_memory = True
            row["out_of_place_nan_fill_ms"] = timed_ms(lambda: prox_sgd(w, w0, g, mom, coeffs))
            torch.utils.deterministic.fill_uninitialized_memory = False
            row["candidates"] = by_candidate
        batches = timed_batches(lambda: prox_sgd(w, w0, g, mom, coeffs, out=(w, mom)))
        ms = statistics.median(batches)
        row.update({"ms": ms, "min_ms": min(batches), "max_ms": max(batches), "gbs": nbytes / (ms * 1e-3) / 1e9,
                    "share_of_bound": bound / ms, "fused_sgd_ms": stream_ms(fused_sgd(w, g, mom), reps=20)})
        rows.append(row)
        del w, g, mom, w0
        torch.cuda.empty_cache()
    return {"phase": "b4_sweep", "sms": sms, "blocks_per_sm": per_sm, "rows": rows}


def kernel_resources() -> dict:
    """ptxas's report of every kernel (the build's ``-Xptxas -v`` log):
    registers, barriers, shared memory, stack and spills, by kernel."""
    import re

    from repro_torch.kernels import _build

    report, name = {}, None
    for source in _build.SOURCES:
        for line in _build.build_log(source).splitlines():
            if m := re.search(r"Function properties for (\S+)", line):
                name = m.group(1)
                report[name] = []
            elif name and ("stack frame" in line or "Used" in line):
                report[name].append(line.split(":", 1)[-1].strip())
    require(report, "no ptxas report in the build log")
    demangled = subprocess.run([str(pathlib.Path(_build._nvcc()).with_name("cu++filt"))], input="\n".join(report),
                               capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()
    return {re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::|\((?:int|bool)\)", "", full[:full.rindex("(")]):
            ", ".join(lines) for full, lines in zip(demangled, report.values())}


def b3_sass() -> dict:
    """SASS of B3's counting loop in the aligned kernel with 8 blocks a tile
    (``cuobjdump -sass`` of the built library). The loop runs from the
    target of its longest backward branch to that branch; its steady path
    takes every forward branch inside it (the full 16-row group, no
    flush), and covers 64 wire bytes a thread."""
    import collections
    import re

    from repro_torch.kernels import _build

    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(_build._target("bit_aggregate"))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    body = text.split("bit_aggregate_kernelILi8ELb1E", 1)[1].split("Function :", 1)[0]
    ins = {int(a, 16): op.strip() for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)}
    jumps = {a: int(t, 16) for a, op in ins.items() for t in re.findall(r"\bBRA\s+0x([0-9a-f]+)", op)}
    head, edge = max(((t, a) for a, t in jumps.items() if t < a), key=lambda x: x[1] - x[0])
    addrs = sorted(ins)
    following = dict(zip(addrs, addrs[1:]))
    path, at = [], head
    while at != edge:
        require(head <= at < edge, f"B3's SASS: the steady path leaves the loop at {at:#x}")
        path.append(at)
        at = jumps[at] if jumps.get(at, -1) > at else following[at]
    path.append(edge)
    opcodes = collections.Counter(
        next(t for t in ins[a].split() if not t.startswith("@")).split(".")[0] for a in path)
    return {"kernel": "bit_aggregate_kernel<8, aligned>", "loop_instructions": sum(head <= a <= edge for a in ins),
            "full_group_instructions": len(path), "per_wire_byte": len(path) / 64,
            "full_group_opcodes": dict(opcodes)}


def copy_bandwidth_gbs(dev) -> float:
    """Measured device-to-device copy rate: (read + write) bytes / time of a
    256 MiB f32 copy, the memcpy-bound method of benchmarks/kernels_micro.py."""
    import torch

    n = (256 << 20) // 4
    src = torch.ones(n, device=dev)
    dst = torch.empty_like(src)
    ms = timed_ms(lambda: dst.copy_(src), reps=20)
    return 2 * 4 * n / (ms * 1e-3) / 1e9


def mesh_fl_run(dev, extra: dict) -> dict:
    """Phase 11, (w) or (x): one FLSimulation of the main path's model and
    cohort with ``extra``: each round's loss, b, theta_mse, theta_hat (on
    the host), edge_mass_min (a tree) and seconds (host clock after a
    synchronize), the launches, the collectives, the ranks the round spread
    over, the clients whose data this process holds, its peak memory and the
    final model. Without a process group (the one-process run) the round
    warns that sharding is a no-op and runs unsharded."""
    import warnings

    import torch

    from repro_torch import distributed
    from repro_torch.fl.hierarchy import tree_shard_devices
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    distributed.reset_collectives()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        sim = make_sim(dev, extra)
    recs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, met in sim.iter_rounds():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs.append({"seconds": t1 - t0, "theta": met["theta"].cpu(),
                     **{k: met[k].item() for k in ("loss", "b", "theta_mse", "edge_mass_min") if k in met}})
        t0 = t1
    require(set(_build.launches) <= set(KERNELS), f"mesh: unknown kernel {dict(_build.launches)}")
    return {"rounds": recs, "launches": {k: _build.launches[k] for k in KERNELS},
            "ranks": distributed.group_size(sim.ctx.group), "tree_ranks": tree_shard_devices(sim.ctx),
            "client_rows": sim.ctx.client_x.shape[0], "collectives": dict(distributed.collectives),
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9, "final": sim.w_global.cpu()}


def mesh_campaign_run(dev) -> dict:
    """Phase 11, (y), on a rank: phase 7's cohort campaign with
    ``shard=True`` (launches, collectives and peak of this rank, the
    gathered metrics of every cell, the group records), then this rank's
    block of the group's runs through the prepared runner again, for their
    final models."""
    import torch

    from repro_torch import distributed
    from repro_torch.kernels import _build
    from repro_torch.sim import campaign, plan_campaign, run_campaign
    from repro_torch.sim.plan import CompileCache

    spec = campaign_specs()["cohort"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    distributed.reset_collectives()
    t0 = time.perf_counter()
    result = run_campaign(spec, campaign_task(dev), shard=True, compile_cache=CompileCache())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.launches[k] for k in KERNELS}
    collectives = dict(distributed.collectives)
    (group,) = plan_campaign(spec, shard=True).groups
    prepare, args, *_ = campaign._prepare_group(group, spec.configs(), spec, campaign_task(dev), with_acc=True,
                                                shard=True, cache=CompileCache())
    _, finals = prepare(*args).run()
    return {"cells": {c.name: {k: v.tolist() for k, v in c.metrics.items()} for c in result.cells},
            "groups": result.groups, "finals": finals.cpu(), "wall_s": wall, "launches": launches,
            "collectives": collectives, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def mesh_lm_run(dev, layouts: dict, mesh: bool) -> dict:
    """Phase 11, (z): the trainer's set-up of qwen2-1.5b cut by MESH_LM_CUT,
    then one step of its 4 clients' first round in each ``(m_seq, n_pods)``
    layout from the same parameters, on a ("pod",) mesh of every rank when
    ``mesh``: each step's losses, b, seconds, peak, launches, collectives
    and a digest of every new parameter leaf's bytes."""
    import contextlib
    import dataclasses
    import hashlib

    import torch

    from repro_torch import configs, distributed, prng, tree
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    args = train.parse_args(["--arch", LM_ARCH, *LM_COMMON, "--rounds", "1", "--device", str(dev)])
    run = train.setup(args, dataclasses.replace(configs.get_config(LM_ARCH), **MESH_LM_CUT))
    first = train.round_batch(run, args, 0)
    _, kr = prng.split(prng.key(1, dev), 2)
    b = torch.tensor(args.b_init, dtype=torch.float32, device=dev)
    pod_mesh = make_mesh((layouts["pods"][1],), ("pod",), dev.type) if mesh else None
    out = {"d": sum(w.numel() for w in tree.leaves(run.params)), "leaves": len(tree.leaves(run.params))}
    for name, (m_seq, n_pods) in layouts.items():
        batch = {k: v.reshape((m_seq, n_pods) + v.shape[2:]) for k, v in first.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        distributed.reset_collectives()
        t0 = time.perf_counter()
        with distributed.set_mesh(pod_mesh) if mesh else contextlib.nullcontext():
            new, b_new, met = run.step(run.params, b, batch, kr)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        out[name] = {"seconds": sec, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                     "loss_first": met["loss_first"].item(), "loss_last": met["loss_last"].item(),
                     "b": b_new.item(), "launches": {k: _build.launches[k] for k in KERNELS},
                     "collectives": dict(distributed.collectives),
                     "digests": [hashlib.sha256(w.contiguous().view(-1).view(torch.uint8).cpu().numpy()).hexdigest()
                                 for w in tree.leaves(new)]}
        del new
    del run
    torch.cuda.empty_cache()
    return out


def mesh_expected_launches(n_leaves: int) -> dict:
    """Each rank's launches in phase 11: (w) and (x) one B1 a chunk of its
    50 clients and one B4 a local step of each, every round; (y) its 4 runs
    as one group, one B1 and one B3 a round and one B4 a local step; (z)
    one B1 a (client, leaf) of its pod's 2 clients and one B3 a leaf over
    the gathered rows of all 4."""
    steps = MAIN["local_epochs"] * MAIN["per_client"] // MAIN["batch_size"]
    chunks = MAIN["n_clients"] // MESH_RANKS // MESH_FL["w"]["client_chunk"]
    fl = {"stoch_quant_pack": MESH_FL["w"]["rounds"] * chunks, "stoch_quant_ef": 0, "bit_aggregate": 0,
          "prox_sgd": MESH_FL["w"]["rounds"] * chunks * steps}
    clients = MESH_LM_LAYOUTS["pods"][0]
    return {"w": fl, "x": fl,
            "y": {"stoch_quant_pack": MAIN["rounds"], "stoch_quant_ef": 0, "bit_aggregate": MAIN["rounds"],
                  "prox_sgd": MAIN["rounds"] * steps},
            "z": {"stoch_quant_pack": clients * n_leaves, "stoch_quant_ef": 0, "bit_aggregate": n_leaves,
                  "prox_sgd": 0}}


def model_axis_expected_launches(n_leaves: int) -> dict:
    """Each rank's launches in phase 12 (aa): one B1 a (client, leaf) over
    the shards it holds (every leaf, sharded or replicated) and one B3 a
    leaf."""
    clients = int(LM_COMMON[LM_COMMON.index("--clients") + 1])
    return {"stoch_quant_pack": clients * n_leaves, "stoch_quant_ef": 0, "bit_aggregate": n_leaves, "prox_sgd": 0}


def model_axis_run(dev, r0_path: str) -> dict:
    """Phase 12 (aa), on a rank: the trainer's set-up of phase 9's (r) with
    its parameters as DTensors on MODEL_AXIS_MESH, then one round on (r)'s
    first batch and key: the step's seconds, peak, launches and collectives
    (the staged backend's calls, bytes and host ms among them), b, the
    losses, and the parameters that differ from (r)'s round 0 (read from
    ``r0_path``), each coordinate counted on one rank only."""
    import dataclasses

    import torch
    from torch.distributed.tensor import Shard

    from repro_torch import configs, distributed, prng, tree
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh

    _, arch, cut, extra, _ = LM_FAMILIES["r"]
    args = train.parse_args(["--arch", arch, *LM_COMMON, *extra, "--remat", "--device", str(dev)])
    mesh = make_mesh(*MODEL_AXIS_MESH, device_type="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run = train.setup(args, dataclasses.replace(configs.get_config(arch), **cut), mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = train.round_batch(run, args, 0)
    _, kr = prng.split(prng.key(1, dev), 2)
    b = torch.tensor(args.b_init, dtype=torch.float32, device=dev)
    _build.reset_launches()
    distributed.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with distributed.set_mesh(mesh):
        new, b_new, met = run.step(run.params, b, batch, kr)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    out = {"step_s": sec, "init_s": init_s, "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": {k: _build.launches[k] for k in KERNELS}, "collectives": dict(distributed.collectives),
           "b": b_new.item(), "loss_first": met["loss_first"].item(), "loss_last": met["loss_last"].item()}
    ref = torch.load(r0_path, mmap=True, weights_only=False)["params"]
    coord = mesh.get_coordinate()
    apart = held = sharded = 0
    for w, whole in zip(tree.leaves(new), ref, strict=True):
        sharded += any(isinstance(p, Shard) and mesh.size(i) > 1 for i, p in enumerate(w.placements))
        if not all(isinstance(p, Shard) or coord[i] == 0 for i, p in enumerate(w.placements)):
            continue  # another rank counts this replicated coordinate
        local, off = distributed.shard_bounds(tuple(w.shape), mesh, w.placements)
        piece = whole[tuple(slice(o, o + n) for o, n in zip(off, local))].to(dev)
        apart += int((w.to_local() != piece).sum())
        held += piece.numel()
    out.update(apart=apart, held=held, leaves=len(ref), sharded_leaves=sharded)
    del new, run
    torch.cuda.empty_cache()
    return out


def dryrun_start() -> dict:
    """Phase 12 (bb): start the dry run of DRYRUN_ARGV (a subprocess) and a
    thread that collects its output and the time it ends."""
    import threading

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = {"t0": time.perf_counter()}
    run["proc"] = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV], env=env,
                                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def collect():
        run["out"], run["err"] = run["proc"].communicate()
        run["t1"] = time.perf_counter()

    run["thread"] = threading.Thread(target=collect, daemon=True)
    run["thread"].start()
    return run


def dryrun_stop(run: dict) -> None:
    """Kill the dry run if it still runs."""
    if run["proc"].poll() is None:
        run["proc"].kill()
    run["thread"].join(30)


def dryrun_finish(run: dict) -> dict:
    """Phase 12 (bb): wait for the dry run (killed at DRYRUN_DEADLINE_S from
    its start) and hold its report: status ok, collectives over each of
    "pod", "data" and "model", and the step's dot FLOPs (a device's times
    DRYRUN_WORLD) within :func:`dryrun_dot_band`; its wall seconds, and
    its peak bytes per device beside the card's memory."""
    import torch

    run["thread"].join(max(DRYRUN_DEADLINE_S - (time.perf_counter() - run["t0"]), 1.0))
    if run["thread"].is_alive():
        dryrun_stop(run)
        require(False, f"phase 12 (bb): the dry run ran past {DRYRUN_DEADLINE_S} s")
    proc, out, err = run["proc"], run["out"], run["err"]
    require(proc.returncode == 0, f"phase 12 (bb): the dry run exited {proc.returncode}: {err[-2000:]}")
    rep = json.loads(next(line for line in out.splitlines() if line.startswith("{")))
    require(rep["status"] == "ok", f"phase 12 (bb): {rep.get('error')}")
    calls = rep["collective_calls_by_dim"]
    require(all(calls.get(d, 0) > 0 for d in ("pod", "data", "model")), f"phase 12 (bb): collectives by dim {calls}")
    dots = rep["dot_flops_per_device"] * DRYRUN_WORLD
    lo, hi, model_flops = dryrun_dot_band()
    require(lo <= dots <= hi, f"phase 12 (bb): {dots:.4e} dot FLOPs, outside [{lo:.4e}, {hi:.4e}]")
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    keys = ("arch", "shape", "mesh", "engine", "device", "status", "t_lower_s", "traces", "extrapolated",
            "fit_wire_row_remainder_bytes", "global_flops", "flops_per_device", "dot_flops_per_device", "bytes_per_device", "collective_link_bytes",
            "cross_pod_link_bytes", "n_collectives", "collectives_by_kind", "collectives_by_dim",
            "collective_calls_by_dim", "t_compute_s", "t_memory_s", "t_memory_measured_s", "t_collective_s",
            "bottleneck", "arg_bytes_per_device", "temp_bytes_per_device", "peak_bytes_per_device", "hardware")
    return {"argv": DRYRUN_ARGV, "wall_s": run["t1"] - run["t0"], **{k: rep[k] for k in keys},
            "dot_flops": dots, "dot_band": [lo, hi], "dots_over_6NT": dots / model_flops,
            "card_bytes": card_bytes, "peak_over_card": rep["peak_bytes_per_device"] / card_bytes}


def dryrun_dot_band() -> tuple[float, float, float]:
    """Bounds on the dot FLOPs of DRYRUN_ARGV's train step from its config
    alone, and ``6 N T`` (N the active parameters, T the step's tokens:
    every client's sequences, one local step each). Every parameter but
    the embedding table enters one product in the forward and two in the
    backward (at least ``6 (N - V d) T``); at most, each enters four (the
    checkpointed unit's forward runs twice), an expert's with up to the
    capacity factor's share of slots, and each attention layer adds its
    two products over the whole context in each of those four passes
    (``16 S H hd T``, no causal skipping)."""
    from repro_torch import configs
    from repro_torch.models import SHAPES

    cfg = configs.get_config(DRYRUN_ARGV[DRYRUN_ARGV.index("--arch") + 1])
    shape = SHAPES[DRYRUN_ARGV[DRYRUN_ARGV.index("--shape") + 1]]
    n, tokens = cfg.n_active_params(), shape.global_batch * shape.seq_len
    n_attn = sum(cfg.mixer_at(i % cfg.unit) == "attn" for i in range(cfg.n_layers))
    lo = 6 * (n - cfg.vocab * cfg.d_model) * tokens
    hi = (8 * max(cfg.capacity_factor, 1.0) * n + 16 * n_attn * shape.seq_len * cfg.n_heads * cfg.head_dim) * tokens
    return float(lo), float(hi), float(6 * n * tokens)


def mesh_rank(rank: int, world: int, store: str, out_dir: str, t_spawn: float, r0_path: str) -> None:
    """Phase 11, one of the MESH_RANKS ranks (a spawned process): the
    parent's deterministic settings, a process group of the host-staged
    backend (gloo on host copies) through a FileStore, the card shared with
    the other ranks; then (w), (x), (y), (z) and phase 12's (aa), saved to
    ``out_dir/rank<k>.pt``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import STAGED_BACKEND

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(STAGED_BACKEND, store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        torch.zeros(1, device=dev)
        dist.barrier()
        res = {"setup_s": time.time() - t_spawn}
        res.update({name: mesh_fl_run(dev, extra) for name, extra in MESH_FL.items()})
        res["y"] = mesh_campaign_run(dev)
        res["z"] = mesh_lm_run(dev, {"pods": MESH_LM_LAYOUTS["pods"]}, mesh=True)
        res["aa"] = model_axis_run(dev, r0_path)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_mesh_ranks(world: int, r0: dict) -> tuple[list, float]:
    """Start ``world`` :func:`mesh_rank` processes and wait for them, at
    most MESH_TIMEOUT_S seconds: their results and the wall seconds. ``r0``
    (phase 9 (r)'s round 0) is left for them in the temporary directory
    they share. A rank that raises fails the phase; at the time limit every
    rank is killed and the phase fails."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        r0_path = os.path.join(tmp, "r0.pt")
        torch.save(r0, r0_path)
        t0 = time.time()
        ctx = mp.start_processes(mesh_rank, args=(world, os.path.join(tmp, "store"), tmp, t0, r0_path), nprocs=world,
                                 join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                require(time.time() - t0 < MESH_TIMEOUT_S, f"phase 11: the ranks ran past {MESH_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        wall = time.time() - t0
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)], wall


def mesh_phase(dev, cohort: dict, r0: dict, dry) -> dict:
    """Phase 11: the one-process runs of (w), (x) and (z) here, then
    MESH_RANKS gloo ranks sharing the card run them sharded with (y); each
    rank is held to the one-process run: (w) theta_hat, loss and b bit for
    bit (theta_mse rtol 1e-6: its delta sum crosses ranks as a sum); (x)
    every metric bit for bit; (y) every run of the gathered cohort against
    phase 7's unsharded run (``cohort``: b exact, loss rtol 1e-6, accuracy
    1e-6), the runs whose final model and losses are the same bits counted;
    (z) the 2-pod-rank step's parameters, b and losses bit for bit against
    the one-process step with 2 pods, which is held to the (4, 1) layout of
    the same clients (parameters and b bit for bit, losses rtol 1e-6). Each
    sharded run must report MESH_RANKS ranks. Prints one ``"phase": "mesh"``
    line. Then phase 12: (aa) from the ranks, held to ``r0`` (phase 9 (r)'s
    round 0), and (bb), the dry run ``dry`` (:func:`dryrun_start`'s, started
    before phase 9); prints one ``"phase":
    "model_axis"`` line. Returns each run's launches summed over the
    ranks."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    one = {name: mesh_fl_run(dev, extra) for name, extra in MESH_FL.items()}
    one["z"] = mesh_lm_run(dev, MESH_LM_LAYOUTS, mesh=False)
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t0
    ranks, ranks_wall = spawn_mesh_ranks(MESH_RANKS, r0)
    bb = dryrun_finish(dry)
    for k, r in enumerate(ranks):
        for name in MESH_FL:
            got, want = r[name], one[name]
            require(got["ranks"] == MESH_RANKS and want["ranks"] == 1, f"mesh {name} rank {k}: ran over {got['ranks']}")
            require(got["client_rows"] == MAIN["n_clients"] // MESH_RANKS, f"mesh {name} rank {k}: holds "
                    f"{got['client_rows']} clients' data")
            require(got["tree_ranks"] == (MESH_RANKS if name == "x" else 1), f"mesh {name}: tree ranks {got['tree_ranks']}")
            for t, (a, c) in enumerate(zip(got["rounds"], want["rounds"], strict=True)):
                require(torch.equal(a["theta"], c["theta"]), f"mesh {name} rank {k} round {t}: theta differs")
                for m in ("loss", "b", "edge_mass_min"):
                    require(a.get(m) == c.get(m), f"mesh {name} rank {k} round {t}: {m} {a.get(m)} vs {c.get(m)}")
                exact_mse = name == "x"
                require(a["theta_mse"] == c["theta_mse"] if exact_mse
                        else np.isclose(a["theta_mse"], c["theta_mse"], rtol=1e-6, atol=0),
                        f"mesh {name} rank {k} round {t}: theta_mse {a['theta_mse']} vs {c['theta_mse']}")
            require(torch.equal(got["final"], want["final"]), f"mesh {name} rank {k}: final model differs")
        y = r["y"]
        require([g["n_devices"] for g in y["groups"]] == [MESH_RANKS], f"mesh y rank {k}: groups {y['groups']}")
        res, finals = cohort["result"], cohort["finals"][0]
        n_seeds = len(COHORT_SEEDS)
        block = -(-n_seeds // MESH_RANKS)
        exact = 0
        for cell in res.cells:
            mine = y["cells"][cell.name]
            for s in range(n_seeds):
                tag = f"mesh y rank {k} {cell.name} seed {COHORT_SEEDS[s]}"
                require(np.array_equal(np.asarray(mine["b"][s], np.float32), cell.metrics["b"][s]), f"{tag}: b differs")
                require(np.allclose(mine["loss"][s], cell.metrics["loss"][s], rtol=1e-6, atol=0), f"{tag}: loss")
                require(np.allclose(mine["acc"][s], cell.metrics["acc"][s], rtol=0, atol=1e-6), f"{tag}: acc")
            for j, s in enumerate(range(k * block, min((k + 1) * block, n_seeds))):
                exact += int(torch.equal(y["finals"][j], finals[s])
                             and np.array_equal(np.asarray(mine["loss"][s], np.float32), cell.metrics["loss"][s]))
        y["bit_exact_runs_of_this_rank"] = exact
        z, z1 = r["z"]["pods"], one["z"]
        require(z["digests"] == z1["pods"]["digests"], f"mesh z rank {k}: parameters differ from one process")
        for m in ("b", "loss_first", "loss_last"):
            require(z[m] == z1["pods"][m], f"mesh z rank {k}: {m} {z[m]} vs one process {z1['pods'][m]}")
    require(one["z"]["pods"]["digests"] == one["z"]["one_pod"]["digests"]
            and one["z"]["pods"]["b"] == one["z"]["one_pod"]["b"],
            "mesh z: the (2, 2) layout's parameters or b differ from the (4, 1) layout's")
    for m in ("loss_first", "loss_last"):
        require(np.isclose(one["z"]["pods"][m], one["z"]["one_pod"][m], rtol=1e-6, atol=0),
                f"mesh z: {m} of the two layouts")
    want = mesh_expected_launches(one["z"]["leaves"])
    for k, r in enumerate(ranks):
        for name, got in (("w", r["w"]), ("x", r["x"]), ("y", r["y"]), ("z", r["z"]["pods"])):
            require(got["launches"] == want[name], f"mesh {name} rank {k}: launches {got['launches']} != {want[name]}")

    def summary(run, keys):
        return {k: run[k] for k in keys if k in run}

    line = {
        "phase": "mesh", "ranks": MESH_RANKS, "backend": "staged (gloo on host copies)", "card": card_line(),
        "seconds": time.perf_counter() - t0,
        "one_process_seconds": one_s, "ranks_wall_s": ranks_wall,
        "spawn_and_setup_s": [r["setup_s"] for r in ranks],
        "runs": {
            **{name: {"config": extra, "d": one[name]["final"].numel(),
                      "one_process_round_s": [x["seconds"] for x in one[name]["rounds"]],
                      "one_process_peak_gb": one[name]["peak_gb"],
                      "ranks": [{"round_s": [x["seconds"] for x in r[name]["rounds"]],
                                 **summary(r[name], ("launches", "collectives", "peak_gb"))} for r in ranks],
                      "loss": [x["loss"] for x in one[name]["rounds"]], "b": [x["b"] for x in one[name]["rounds"]]}
               for name, extra in MESH_FL.items()},
            "y": {"runs": len(COHORT_SEEDS), "runs_a_rank": -(-len(COHORT_SEEDS) // MESH_RANKS),
                  "ranks": [{"campaign_wall_s": r["y"]["wall_s"], "bit_exact_runs": r["y"]["bit_exact_runs_of_this_rank"],
                             **summary(r["y"], ("launches", "collectives", "peak_gb"))} for r in ranks],
                  "groups": ranks[0]["y"]["groups"]},
            "z": {"arch": LM_ARCH, "cut": MESH_LM_CUT, "d": one["z"]["d"], "leaves": one["z"]["leaves"],
                  "layouts": MESH_LM_LAYOUTS,
                  "one_process": {name: summary(one["z"][name], ("seconds", "peak_gb", "loss_first", "loss_last", "b",
                                                                 "launches"))
                                  for name in MESH_LM_LAYOUTS},
                  "ranks": [{"step_s": r["z"]["pods"]["seconds"], "b1_launches": r["z"]["pods"]["launches"]["stoch_quant_pack"],
                             "b3_launches": r["z"]["pods"]["launches"]["bit_aggregate"],
                             **summary(r["z"]["pods"], ("collectives", "peak_gb"))} for r in ranks]},
        },
    }
    print(json.dumps(line), flush=True)
    aa = [r["aa"] for r in ranks]
    want_aa = model_axis_expected_launches(aa[0]["leaves"])
    for k, a in enumerate(aa):
        require(a["launches"] == want_aa, f"model_axis aa rank {k}: launches {a['launches']} != {want_aa}")
        require(a["b"] == r0["b"], f"model_axis aa rank {k}: b {a['b']} vs (r) round 0 {r0['b']}")
        for m in ("loss_first", "loss_last"):
            require(np.isclose(a[m], r0[m], rtol=MODEL_AXIS_BARS["loss_rtol"], atol=0),
                    f"model_axis aa rank {k}: {m} {a[m]} vs (r) round 0 {r0[m]}")
        require(a["sharded_leaves"] > 0, f"model_axis aa rank {k}: no leaf is sharded")
    held, apart = sum(a["held"] for a in aa), sum(a["apart"] for a in aa)
    d = sum(w.numel() for w in r0["params"])
    require(held == d, f"model_axis aa: the ranks hold {held} of the {d} parameters")
    require(apart <= MODEL_AXIS_BARS["params_apart"] * d, f"model_axis aa: {apart} of {d} parameters apart")
    model_line = {
        "phase": "model_axis", "card": card_line(),
        "aa": {"arch": LM_FAMILIES["r"][0], "mesh": MODEL_AXIS_MESH, "d": d, "leaves": aa[0]["leaves"],
               "bars": MODEL_AXIS_BARS, "params_apart": apart, "params_apart_share": apart / d,
               "r_round0": {k: r0[k] for k in ("b", "loss_first", "loss_last")},
               "ranks": [{k: a[k] for k in ("step_s", "init_s", "peak_gb", "launches", "collectives", "b", "loss_first",
                                            "loss_last", "sharded_leaves")} for a in aa]},
        "bb": bb,
    }
    print(json.dumps(model_line), flush=True)
    return {f"mesh/{name}": {"launches": {n: sum(r[name]["launches"][n] for r in ranks) for n in KERNELS}}
            for name in ("w", "x", "y")} | {
        "mesh/z": {"launches": {n: sum(r["z"]["pods"]["launches"][n] for r in ranks) for n in KERNELS}},
        "model_axis/aa": {"launches": {n: sum(a["launches"][n] for a in aa) for n in KERNELS}}}


def theorem_line(check: str, ok: bool, **fields) -> None:
    """Print one phase-13 check as a JSON line, then raise if it missed."""
    print(json.dumps({"phase": "theorems", "check": check, "ok": bool(ok), **fields}), flush=True)
    require(ok, f"theorems {check}: {fields}")


def hetero_updates(key, m: int, d: int, scale: float = 0.01):
    """Heterogeneous client updates around a common theta (the reference
    tests' model of paper Fig. 1): theta ~ scale N(0, 1), noise scale/2."""
    from repro_torch import prng

    theta = scale * prng.normal(key, (d,))
    return theta + scale * 0.5 * prng.normal(prng.fold_in(key, 1), (m, d))


def wire_codes(codes):
    """(M, d) codes -> the (M, padded_len(d)/8) kernel wire (pad bits 0)."""
    import torch.nn.functional as F

    from repro_torch.core import pack_bits
    from repro_torch.kernels import padded_len

    m, d = codes.shape
    return pack_bits(F.pad(codes, (0, padded_len(d) - d), value=-1)).view(m, -1)


def theorem_checks(dev) -> dict:
    """Phase 13 (cc): Theorems 1-3 at THEOREM_D through the functional
    one-bit API on the card, every draw batched (all clients of a block of
    repetitions in one Threefry pass), only estimates kept across blocks;
    one JSON line a check. Returns the seconds a part."""
    import torch

    from repro_torch import kernels, prng
    from repro_torch.core import (DPConfig, dp_b_floor, flip_codes, privacy_loss, probit_plus_aggregate,
                                  probit_plus_from_updates, stochastic_binarize)
    from repro_torch.core.quantizer import uniform_block_rows

    d, reps, bars, secs = THEOREM_D, THEOREM_REPS, THEOREM_BARS, {}

    # Theorem 1: every client at theta, so the only error is quantization.
    # theta is clipped to [-b, b], the theorem's premise b >= |delta|: the
    # 0.27% of coordinates past 3 sigma would add a clipping bias
    # (|theta| - b)^2 that no M removes (+2.2% of the error at M = 512).
    t0 = time.perf_counter()
    key = prng.key(1, dev)
    b = 0.06
    theta0 = 0.02 * prng.normal(key, (d,))
    theta = torch.clamp(theta0, -b, b)
    clip_bias = float(((theta0.double().abs() - b).clamp(min=0.0) ** 2).sum())
    bvec = torch.full((d,), b, device=dev)
    m_err = {}
    for m in THEOREM_MS:
        upd = theta.expand(m, d)
        keys = prng.split(prng.fold_in(key, m), reps)
        est = probit_plus_from_updates(keys, upd, bvec)
        errs = ((est.double() - theta.double()) ** 2).sum(-1)
        expected = float((b * b - theta.double() ** 2).sum() / m)
        measured = float(errs.mean())
        rel = abs(measured - expected) / expected
        # the wire cross-check: repetition 0's codes on the kernel wire
        codes = stochastic_binarize(prng.split(keys[0], m), upd, bvec)
        theta_k = kernels.bit_aggregate(wire_codes(codes), bvec, d, engine="cuda")
        theta_c = probit_plus_aggregate(codes, bvec)
        same = torch.equal(theta_k, theta_c) and torch.equal(theta_c, est[0])
        diff = float((theta_k - theta_c).abs().max())
        del codes
        theorem_line(f"theorem1_error_M{m}", rel < bars["error_rel"], m=m, d=d, reps=reps, measured=measured,
                     expected=expected, rel_err=rel, bar=bars["error_rel"], rep_rel_sd=float(errs.std() / errs.mean()))
        theorem_line(f"wire_B3_M{m}", same, m=m, d=d, max_abs_diff=diff,
                     note="B3 on the packed codes == probit_plus_aggregate == the batched estimate, bit for bit")
        m_err[m] = m * measured
    spread = max(m_err.values()) / min(m_err.values()) - 1.0
    theorem_line("theorem1_rate_M_times_error", spread <= bars["m_times_error_spread"],
                 m_times_error={str(k): v for k, v in m_err.items()}, spread=spread,
                 bar=bars["m_times_error_spread"], coords_clipped=int((theta0.abs() > b).sum()),
                 clip_bias_unclipped=clip_bias,
                 clip_bias_over_error={str(k): clip_bias * k / v for k, v in m_err.items()})
    m, u_reps = THEOREM_UNBIASED
    key = prng.key(0, dev)
    upd = hetero_updates(key, m, d)
    b_u = float(upd.abs().max()) + 0.01
    mean_est = probit_plus_from_updates(prng.split(prng.fold_in(key, 7), u_reps), upd,
                                        torch.full((d,), b_u, device=dev)).double().mean(0)
    se = b_u / math.sqrt(m * u_reps)
    worst = float((mean_est - upd.double().mean(0)).abs().max())
    theorem_line("theorem1_unbiased", worst < bars["unbiased_se"] * se, m=m, d=d, reps=u_reps,
                 max_abs_dev=worst, se=se, bar_se=bars["unbiased_se"])
    torch.cuda.synchronize()
    secs["theorem1"] = time.perf_counter() - t0

    # Theorem 2: the worst-case bit adversary on the same draws
    t0 = time.perf_counter()
    m = THEOREM_BYZ_M
    key = prng.key(2, dev)
    upd = hetero_updates(key, m, d)
    bvec = torch.full((d,), float(upd.abs().max()) + 0.01, device=dev)
    keys = prng.split(prng.fold_in(key, 3), reps)
    clean = torch.zeros(d, dtype=torch.float64, device=dev)
    att = {beta: torch.zeros_like(clean) for beta in THEOREM_BETAS}
    step = uniform_block_rows(m * d)
    for r0 in range(0, reps, step):
        codes = stochastic_binarize(prng.split(keys[r0:r0 + step], m).movedim(-2, 0), upd.unsqueeze(1), bvec)
        clean += probit_plus_aggregate(codes, bvec).sum(0, dtype=torch.float64)
        for beta in THEOREM_BETAS:
            att[beta] += probit_plus_aggregate(flip_codes(codes, int(m * beta)), bvec).sum(0, dtype=torch.float64)
        del codes
    for beta in THEOREM_BETAS:
        dev_norm = float(torch.linalg.norm((clean - att[beta]) / reps))
        bound = 2 * beta * float(torch.linalg.norm(bvec.double()))
        theorem_line(f"theorem2_beta{beta}", dev_norm <= bound * bars["byz_slack"], m=m, d=d, reps=reps,
                     n_byz=int(m * beta), deviation=dev_norm, bound=bound, slack=bars["byz_slack"])
    # magnitude immunity: one client sends 1e9, the same keys
    evil = upd.clone()
    evil[0] = 1e9
    keys = prng.split(prng.fold_in(key, 5), reps)
    shift = (probit_plus_from_updates(keys, upd, bvec) - probit_plus_from_updates(keys, evil, bvec)).abs()
    b_i = float(bvec[0])
    bar = 2 * b_i / m + 2 * b_i * 2.0**-23  # 2b/M, up to two f32 ulps of b
    fedavg = float((evil.mean(0) - upd.mean(0)).abs().max())
    theorem_line("magnitude_immunity", float(shift.max()) <= bar and fedavg > 1e6, m=m, d=d, reps=reps,
                 max_abs_shift=float(shift.max()), bar=bar, fedavg_shift=fedavg)
    torch.cuda.synchronize()
    secs["theorem2"] = time.perf_counter() - t0

    # Theorem 3: b at the floor keeps the privacy loss within epsilon
    t0 = time.perf_counter()
    delta1 = 2e-4
    for eps in THEOREM_EPS:
        losses = []
        for seed in range(4):
            key = prng.key(seed, dev)
            delta_a = 0.01 * prng.normal(key, (d,))
            v = prng.normal(prng.fold_in(key, 1), (d,))
            delta_b = delta_a + v / v.abs().sum() * delta1
            floor = dp_b_floor(torch.maximum(delta_a.abs(), delta_b.abs()).max(), DPConfig(eps, delta1))
            losses.append(float(privacy_loss(delta_a, delta_b, torch.full((d,), float(floor), device=dev))))
        theorem_line(f"theorem3_eps{eps}", max(losses) <= eps * bars["privacy_slack"], d=d, seeds=4,
                     privacy_loss=losses, bound=eps * bars["privacy_slack"])
    secs["theorem3"] = time.perf_counter() - t0
    return secs


def statistical_task(dev):
    """The reference's tests/test_statistical.py task on the card:
    make_classification(0, 4,000 / 400), the MLP at hidden 16 from key 0,
    label skew of STAT_PER_CLIENT samples a client (seed 1) for each M."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.data import make_classification, partition_label_skew
    from repro_torch.models import accuracy, init_mlp, mlp_logits, xent_loss
    from repro_torch.sim import Task

    (xtr, ytr), (xte, yte) = make_classification(0, n_train=4000, n_test=400)
    p0 = init_mlp(prng.key(0), hidden=16)

    @functools.lru_cache(maxsize=None)
    def task(m: int):
        parts = partition_label_skew(ytr, m, 2, STAT_PER_CLIENT, seed=1)
        return Task(p0, functools.partial(xent_loss, mlp_logits), functools.partial(accuracy, mlp_logits),
                    np.stack([xtr[i] for i in parts]), np.stack([ytr[i] for i in parts]), {"x": xte, "y": yte},
                    device=dev)

    return lambda cfg: task(cfg.n_clients)


def statistical_specs() -> dict:
    """The three grids of tests/test_statistical.py, with the kernels."""
    from repro_torch.sim import CampaignSpec

    one_over_m = {
        f"one_over_m_eps{eps}": CampaignSpec.from_grid(
            {"rounds": 8, "local_epochs": 1, "b_mode": "fixed", "b_init": 0.1, "dp_epsilon": eps,
             "use_kernels": True}, {"n_clients": STAT_M_GRID}, seeds=(0, 1, 2))
        for eps in (0.0, 0.1)}
    bit_flip = CampaignSpec.from_grid(
        {"n_clients": 16, "rounds": 30, "local_epochs": 2, "attack": "bit_flip", "use_kernels": True},
        {"byz_frac": [0.0, 0.2, 0.4]}, seeds=(0, 1))
    straggler = CampaignSpec.from_grid(
        {"n_clients": 16, "rounds": 30, "local_epochs": 2, "attack": "straggler+sign_flip", "async_buffer": 16,
         "async_latency": 1.0, "use_kernels": True},
        {"byz_frac": [0.0, 0.125, 0.25], "staleness_decay": [0.0, 0.5]}, seeds=(0, 1))
    return {**one_over_m, "bit_flip": bit_flip, "straggler": straggler}


def statistical_checks(dev) -> dict:
    """Phase 13 (dd): each grid through run_campaign on the card, its
    launches zeroed just before and read just after and equal to its plan's
    (campaign_expected_launches), then the reference test's bars; one JSON
    line a grid. Returns each grid's launches and seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.sim import plan_campaign, run_campaign
    from repro_torch.sim.plan import CompileCache

    task_fn = statistical_task(dev)
    out = {}
    for name, spec in statistical_specs().items():
        plan = plan_campaign(spec)
        cfgs = spec.configs()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        result = run_campaign(spec, task_fn, plan=plan, compile_cache=CompileCache())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _build.launches[k] for k in KERNELS}
        require(set(_build.launches) <= set(KERNELS), f"statistical {name}: unknown kernel {dict(_build.launches)}")
        want = {k: 0 for k in KERNELS}
        for group in plan.groups:
            for k, v in campaign_expected_launches(group, cfgs, len(spec.seeds), STAT_PER_CLIENT).items():
                want[k] += v
        require(launches == want, f"statistical {name}: launches {launches} != expected {want}")
        line = {"phase": "theorems", "check": f"statistical_{name}", "kernels": all(c.use_kernels for c in cfgs),
                "groups": [g["cells"] for g in result.groups], "seconds": wall, "launches": launches}
        if name == "straggler":
            # the asynchronous groups, each run as one group: each group's
            # own launches and seconds, and each run against its sequential run
            held = hold_groups(dev, f"statistical {name}", spec, plan, result, task_fn, STAT_PER_CLIENT,
                               with_ref=False)
            line.update(held_groups=held["groups"], equal_to_sequential_runs=held["runs"],
                        bit_exact_runs_final_model_and_loss=held["bit_exact_runs"])
        if name.startswith("one_over_m"):
            mses = [result.cell(f"n_clients={m}").mean_over_rounds("theta_mse") for m in STAT_M_GRID]
            slope = float(np.polyfit(np.log(STAT_M_GRID), np.log(mses), 1)[0])
            ok = STAT_SLOPE[0] <= slope <= STAT_SLOPE[1] and all(a > b for a, b in zip(mses, mses[1:]))
            line.update(theta_mse=mses, slope=slope, window=STAT_SLOPE)
        elif name == "bit_flip":
            acc = {f: float(result.cell(f"byz_frac={f}").metrics["acc"][:, -5:].mean()) for f in (0.0, 0.2, 0.4)}
            ok = acc[0.2] >= acc[0.0] - 0.1 and acc[0.4] >= acc[0.0] - 0.12
            line.update(acc_last5={str(k): v for k, v in acc.items()}, bars=[0.1, 0.12])
        else:
            cells = {(f, dc): result.cell(f"byz_frac={f}|staleness_decay={dc}")
                     for f in (0.0, 0.125, 0.25) for dc in (0.0, 0.5)}
            acc = {k: float(c.metrics["acc"][:, -5:].mean()) for k, c in cells.items()}
            ok = all(acc[(0.125, dc)] >= acc[(0.0, dc)] - 0.1 and acc[(0.25, dc)] >= acc[(0.0, dc)] - 0.15
                     for dc in (0.0, 0.5))
            fill = min(float(c.metrics["buf_fill"][:, -1].min()) for c in cells.values())
            finite = all(bool(np.isfinite(c.metrics["mean_age"]).all()) for c in cells.values())
            ok = ok and fill > 0.5 and finite
            line.update(acc_last5={f"{f}|{dc}": v for (f, dc), v in acc.items()}, bars=[0.1, 0.15],
                        buf_fill_last_min=fill, mean_age_finite=finite)
        line["ok"] = bool(ok)
        print(json.dumps(line), flush=True)
        require(ok, f"statistical {name}: {line}")
        out[name] = {"launches": launches, "seconds": wall}
    return out


def theorem_phase(dev) -> dict:
    """Phase 13: (cc) then (dd), the launch counts zeroed just before and
    read just after; every kernel of the path (B1, B3, B4) must have run."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _build.reset_launches()
    secs = theorem_checks(dev)
    cc_launches = {k: _build.launches[k] for k in KERNELS}
    require(cc_launches["bit_aggregate"] == len(THEOREM_MS), f"theorems (cc): launches {cc_launches}")
    grids = statistical_checks(dev)
    launches = {k: cc_launches[k] + sum(g["launches"][k] for g in grids.values()) for k in KERNELS}
    for name in ("stoch_quant_pack", "bit_aggregate", "prox_sgd"):
        require(launches[name], f"phase 13 never launched {name}")
    line = {"phase": "theorems_done", "seconds": time.perf_counter() - t0, "cc_seconds": secs,
            "dd_seconds": {k: g["seconds"] for k, g in grids.items()}, "launches": launches}
    print(json.dumps(line), flush=True)
    return {"theorems": {"launches": launches}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="phase 6: one profiled round of (a) on the MLP and on ResNet-18")
    parser.add_argument("--b4-parent", type=pathlib.Path, metavar="DIR",
                        help="only time B4 of the checkout DIR against this one's (no other phase)")
    args = parser.parse_args()
    t_script = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    build_s = _build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s, "dir": str(_build.build_dir()),
                      "ptxas": kernel_resources()}), flush=True)
    if args.b4_parent:
        torch.utils.deterministic.fill_uninitialized_memory = False
        print(json.dumps(b4_parent_ab(dev, args.b4_parent.resolve())), flush=True)
        return 0

    chk = Checker()
    t0 = time.perf_counter()
    check_kernels(chk, dev)
    check_bit_aggregate(chk, dev)
    check_prox_sgd(chk, dev)
    check_batched(chk, dev)
    check_topk_pack(chk, dev)
    single = check_single_client(chk, dev)
    torch.cuda.synchronize()
    print(json.dumps({"phase": "kernels_vs_plain", "checked": sorted(chk.count), "comparisons": chk.count,
                      "single_client_comparisons": single, "single_client_d": SINGLE_CLIENT_D,
                      "max_abs_err": chk.max_err, "seconds": time.perf_counter() - t0}), flush=True)
    require(sorted(chk.count) == sorted(KERNELS), f"not every kernel was checked: {sorted(chk.count)}")

    from repro_torch.fl import FLConfig

    runs = main_path(dev)
    print(json.dumps({"phase": "main_path",
                      **{k: {"launches": v["launches"], "expected_launches": expected_launches(k),
                             "loss": [r["loss"] for r in v["rounds"]], "b": [r["b"] for r in v["rounds"]],
                             "round_seconds": [r["seconds"] for r in v["rounds"]], "acc": v["acc"],
                             "d": v["d"], "wire_row_bytes": v["wire_row_bytes"], "peak_gb": v["peak_bytes"] / 1e9}
                         for k, v in runs.items()}}), flush=True)
    for name, run in runs.items():
        require(run["launches"] == expected_launches(name),
                f"variant {name}: launches {run['launches']} != expected {expected_launches(name)}")
    for name in KERNELS:
        require(any(run["launches"][name] for run in runs.values()), f"main path never launched {name}")
    check_main_path(runs, FLConfig().b_init)

    ref_runs = main_path(dev, engine="ref", variants={"a": VARIANTS["a"]})
    require(not any(ref_runs["a"]["launches"].values()),
            f"the engine='ref' run launched a kernel: {ref_runs['a']['launches']}")
    for t, (k_rec, r_rec) in enumerate(zip(runs["a"]["rounds"], ref_runs["a"]["rounds"])):
        require(torch.equal(k_rec["theta"], r_rec["theta"]), f"round {t}: theta differs from the ref run")
        require(k_rec["loss"] == r_rec["loss"], f"round {t}: loss {k_rec['loss']} vs ref {r_rec['loss']}")
        require(k_rec["b"] == r_rec["b"], f"round {t}: b {k_rec['b']} vs ref {r_rec['b']}")
    require(len(runs["a"]["rounds"]) == len(ref_runs["a"]["rounds"]) == MAIN["rounds"],
            "the kernel and ref runs of (a) ran different numbers of rounds")
    print(json.dumps({"phase": "ref_rerun", "equal_rounds": MAIN["rounds"],
                      "round_seconds_ref": [r["seconds"] for r in ref_runs["a"]["rounds"]]}), flush=True)

    grid = byzantine_grid(dev)
    vision = vision_runs(dev)
    async_stream = async_stream_runs(dev, runs, vision["resnet18w64-m100/a"]["peak_bytes"])
    campaigns = campaign_runs(dev, runs)
    wires_trees = wires_trees_runs(dev, runs, async_stream)
    # phase 12 (bb), the dry run, traces on the host while phase 9's rounds
    # keep the card busy
    dry = dryrun_start()
    try:
        lm, r_round0 = lm_runs(dev)
        mesh = mesh_phase(dev, campaigns["campaign/cohort"], r_round0, dry)
    finally:
        dryrun_stop(dry)
    del r_round0
    theorems = theorem_phase(dev)

    # Phase 5 times kernels, not allocations: under deterministic algorithms
    # every torch.empty is filled with NaN by a kernel of its own.
    torch.utils.deterministic.fill_uninitialized_memory = False
    copy_gbs = copy_bandwidth_gbs(dev)
    at_main = kernel_times(dev, MAIN["n_clients"], 118_282, copy_gbs)
    at_resnet = kernel_times(dev, MAIN["n_clients"], RESNET_D, copy_gbs)
    at_group = kernel_times(dev, MAIN["n_clients"], 118_282, copy_gbs, elements=len(COHORT_SEEDS))
    at_topk = topk_pack_times(dev, copy_gbs)
    at_lm = {where: lm_leaf_times(dev, copy_gbs, d) for where, d in LM_LEAVES.items()}
    at_single = {f"single_client_d{d}": single_client_times(dev, copy_gbs, d) for d in (THEOREM_D, RESNET_D)}
    rows = kernel_rows({**runs, **grid, **vision, **async_stream, **campaigns, **wires_trees, **lm, **mesh, **theorems},
                       chk, at_main, at_resnet, at_group, at_topk, {**at_lm, **at_single})
    print(json.dumps({"phase": "times", "card": card, "copy_gbs": copy_gbs,
                      "round_seconds_a": [r["seconds"] for r in runs["a"]["rounds"]],
                      f"kernels_at_{RESNET_D}": at_resnet, "kernels_batched_E8_M100": at_group,
                      "stoch_quant_pack_at_topk_M100": at_topk,
                      **{f"kernels_{where}": times for where, times in at_lm.items()},
                      **{f"kernels_{where}": times for where, times in at_single.items()}}), flush=True)
    print(json.dumps(stage_times(dev)), flush=True)
    print(json.dumps(b3_sweep(dev, copy_gbs)), flush=True)
    print(json.dumps(b4_sweep(dev, copy_gbs)), flush=True)
    if args.profile:
        for task in ("mlp128-m100", "resnet18w64-m100"):
            print(json.dumps(profile_round(dev, task)), flush=True)
    print(json.dumps({"phase": "total", "seconds": time.perf_counter() - t_script}), flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
