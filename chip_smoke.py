#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--only PHASE ...]

Phases (any failure exits non-zero):
  1. environment: card name and power limit, torch and CUDA versions, TF32 flags;
  2. kernel build from the sources in this checkout (one nvcc per source, all
     started together, timed);
  3. every kernel against its plain PyTorch version on the card, bit for bit,
     at the main path's shapes and over a seeded sweep (int8 tables on the
     card and in pinned host memory; update+sample in its single-leaf form
     and in its list form, every leaf of a record in one launch); times
     (the one-launch flat step beside the three single-leaf launches it
     replaced), bounds, and the host link's measured rate, which bounds the
     kernels that touch pinned tables; the rate at which gather_dequant_rows
     reads pinned memory, and encode_scatter_rows writes it, beside the copy
     engine's, from 2 to 128 rows, and the same gather on device copies of
     the tables; the quantizer with its input in L2 and stopped after each
     of its three phases, and the launch floor (an empty kernel launched as
     a plain grid and as clusters of 8) beside every int8 kernel; the
     quantizer on rows that tell IEEE division from a reciprocal multiply;
     and the unfused cold pass's one launch, update+sample with its int8
     leaf dequantized on the gather (f32, bf16, f16 records; pinned and
     device tables), against update+sample then dequantize_rows' plain
     version, and timed against the two launches it replaces; the tap
     strategies' records at full width (image, label, task and der's dense
     logits [1000] or top-8 pairs, or grasp_embed's embedding [2048]) in one
     launch, on device tables and in the cold tier's pinned layout;
  4. the port's ResNet-50 at full width on the card against the same model
     on the CPU, on a small input;
  5. the flat main path: ``ContinualTrainer`` on ``resnet50_cl.full()``
     (224x224x3, 1000 classes, 4 tasks of 250 classes) with async rehearsal,
     reservoir policy and a flat buffer of 4 x 500 records, for 2 tasks x 4
     steps. It checks that every buffer update+sample went through the CUDA
     kernel, one launch a step for the record's three leaves, and that
     losses, buffer fill and the accuracy matrix are sane;
  6. the tiered store driven directly at full row width (4 buckets x 4 hot
     slots, 4 x 1000 int8 cold slots in pinned host memory, a stage of 8):
     fused and unfused kernels on the card and the plain versions on the CPU,
     fed the same rows, agree on every leaf and every sample bit for bit, and
     the cold tier adds nothing to the card's allocated memory;
  7. the tiered main path: the trainer of phase 5 with ``tiering="host"``
     (that tiered store), once with the fused kernels and once without. Each
     float-leaf kernel of the setting launches once per step (unfused:
     quantize_rows; its cold sample is dequantized by an update+sample
     launch, so dequantize_rows launches 0 times), update+sample as often as
     the tiered step's callers ask (3 a step, fused or not), the histories
     of ``rep_checksum`` and ``buffer_fill`` are identical, and the buffer
     outgrows the hot tier;
 13. the split pipelined step (run after phase 7, with TF32 still on):
     ``ContinualTrainer(step_form='split')`` on phase 5's flat and phase 7's
     unfused tiered configuration, the issue half on its own CUDA stream;
     fingerprints and launches equal to the fused runs', and both forms'
     median steps (their profiles, ``repro_torch.profile_main_path``, run
     apart from the script, for time).
 14. strategies and policies on the main path (after phase 13, TF32 on):
     ``ContinualTrainer`` on phase 5's configuration with der_pp (dense
     logits, flat), der with top_k 8 on phase 7's tiered store (unfused,
     then fused: identical fingerprints), grasp_embed with the grasp policy
     (flat), and rehearsal under fifo and under class_balanced (flat, 1
     task); each checks one update+sample launch a flat step for the whole
     record (3 a tiered step), one quantize_rows launch a step per float
     leaf on the unfused tiered store, der's distill finite and positive,
     the policy aux on the card, and prints its median step beside phase 5's;
     then der_pp steps at phase 4's small input, the card against the CPU
     through the ``rows`` seam, TF32 off.
 17. the domain-incremental and blurry-boundary scenarios on the main path
     (after phase 14, TF32 on): ``ContinualTrainer(run, name)`` on phase 5's
     model and cuts with each scenario's own rehearsal defaults and a
     buffer of 2000 records: domain_incremental (4 domains over 1000 shared
     classes, class_balanced, 4 buckets x 500 slots) and blurry_boundary (4
     tasks x 250 classes, blur 0.25, reservoir, one bucket a class: 1000 x
     2 slots, records without a task id); each checks one update+sample
     launch a step and no other kernel, finite losses, buffer_fill growing
     and a finite accuracy matrix, and prints its median step beside phase
     5's.
 18. the resilient main path (after phase 17, TF32 on), in deterministic
     mode (cuDNN and PyTorch deterministic, ``CUBLAS_WORKSPACE_CONFIG=:4096:8``;
     ops without a deterministic implementation are reported), checkpoints
     in temporary directories deleted after each run, the buffers cut to 4
     x 100 flat and 4 x 200 cold slots for time: (a) phase 5's flat
     configuration with ``ResilienceConfig(checkpoint_every=3,
     max_restarts=2)``, a clean run and one with a failure injected before
     step 5: restarts 0 and 1, histories, losses, accuracy matrices and final
     checkpoints bit for bit, 8 and 10 update+sample launches; (b) the same
     on phase 7's fused tiered store, its int8 kernels once a step, replays
     included, the restored cold tier pinned; (c) stale steps (delay 0.5,
     staleness 2): update+sample launches = steps - stale steps; (d)
     ``scale_carry`` 1 -> 2 -> 1 of the restored flat and tiered carries,
     every record kept; (e) ``OnlineLearner`` at SmolLM-135M full width, 2
     rounds, a transient failure (a restart, every round trained) and a
     persistent one (training off, serving on the last checkpoint's weights
     bit for bit); (f) the train CLI with ``--ckpt-dir --resilience``, 1
     task of 2 steps, a restart checkpoint every step. Checkpoint bytes,
     save (snapshot, write) and restore ms, the median step beside phase
     5's.
Phases 8-12 are the language-model inference path, with TF32 off:
  8. flash attention against its plain version at SmolLM-135M's (hd 64)
     and Gemma-2B's (hd 256, MQA) prefill shapes (f32 on the 3xTF32 wgmma
     kernel, bf16 on the bf16 wgmma kernel) and over a seeded sweep (the
     JAX kernel tests' cases, an H2O-Danube case, hd 80, window 4096, S
     8192, in both dtypes, the bf16 kernel's edges, and at hd 256 a window,
     S 64 and S 100 without causal in both dtypes); times beside
     ``F.scaled_dot_product_attention`` and the bound (for f32 the 3xTF32
     tensor-core bound, the FMA bound beside it);
  9. the SSD scan against its plain version and the model's ``ssd_chunked``
     at Mamba2-370M's prefill shapes and over a sweep (bf16 among it, at the
     path's shapes too, its error beside one bf16 ulp of the output), and
     each of its three kernels against its plain stage (bf16: stages 1 and 3
     on the bf16 tensor cores); times and bounds of the f32 and bf16
     instances at the path's shapes, whole and kernel by kernel;
 10. SmolLM-135M, Mamba2-370M, StableLM-3B and Gemma-2B at full width on
     the card against the CPU (the same weights, B 1, S 128);
 11. prefill at full width (B 4, S 2048): ``build_model(cfg).forward`` with
     the kernels (30, 32 and 18 flash launches; 48 scans of 3 kernels each)
     against the plain path, in f32 and in bf16
     (``StackCtx(compute_dtype=bfloat16)``, held against the f32 plain
     path; logits compared in chunks: Gemma-2B's are 8.4 GB in f32); median
     time, tokens/s, peak memory;
 12. greedy serving (batch 4, prompt 32, gen 16) for the four models through
     ``repro_torch.launch.serve`` and ``DecodeEngine``, decode logits against
     the teacher-forced forward;
 15. continual LM training (after phase 12, TF32 off): ``ContinualTrainer``
     on ``TokenClassIncremental`` at full width on the run the train CLI
     builds (``launch.train.build_run``; its defaults: seq 128, batch 8,
     AdamW lr 3e-3, f32 compute, async reservoir rehearsal, 16 slots a
     bucket, vocab min(V, 2048)): SmolLM-135M 2 tasks x 8 steps,
     Mamba2-370M 2 x 4; SmolLM-135M with der_pp top-16 on the tiered store,
     unfused and fused (1 x 4), at bf16 compute (1 x 4) and on
     ``DriftStream`` (2 anchors x 4). Each run: losses finite, task 0's loss
     falling, 1 update+sample launch a flat step and 3 a tiered step, the
     int8 kernels once a step on ``logit_vals``, no flash or scan launch;
     median step, peak memory, prefetch-wait share and the accuracy matrix
     printed. Then SmolLM-135M through the CLI's ``main`` on the card (2 x
     8, its eval lines and launches; the mesh backend at 1x1, 1
     representative a step) and through the mesh backend with exchange
     local (2 x 8, the carry run's rows and fingerprints), each median step
     beside the carry run's; update+sample and the int8 kernels on
     these token records against their plain versions, and reduced LM steps
     on the card against the CPU through the ``rows`` seam.
 16. online serving (after phase 15, TF32 off): ``OnlineLearner(run).run()``
     on the serve CLI's ``--online`` run at its defaults (batch 4, prompt 32,
     gen 16, rounds of 1 train step, a drift over 3 anchors, AdamW f32,
     async reservoir), cut to 4 of its 8 rounds for time, with
     SmolLM-135M, then Mamba2-370M, at full width over a drift stream of
     min(V, 2048) ids. Each run: every round trained at freshness 1,
     admission 1.0, finite losses, 4 update+sample launches and no other
     kernel, the serving copy equal to the train weights bit for bit; decode
     tokens/s per sequence beside phase 12's, train ms a round, the handoff
     copy's ms, peak memory. Then SmolLM-135M with a failure injected before
     round 3's step: every round still served and serving ends on round 2's
     handed-off weights bit for bit. Then
     ``serve.main(["--online"])`` on the card at the CLI's defaults.
 19. the mesh backend (after phase 16): (a) phase 5's flat configuration
     through ``ContinualTrainer(mesh=make_mesh((1, 1), ...),
     exchange='local')`` with TF32 on, as phase 5 ran: its ``rep_checksum``
     and ``buffer_fill`` history equal to phase 5's, losses within rtol
     1e-4; (c) phase 7's tiered store, unfused then fused, 1 task through
     the same backend: 3 update+sample launches a step and the setting's
     int8 kernels once a step, phase 7's task-0 fingerprints, the cold tier
     pinned; (b) SmolLM-135M at full width through ``launch.train.main``
     with ``--mesh 1x1 --exchange full --ckpt-every 2``, 1 task x 4 steps,
     in a world-1 NCCL group and deterministic mode (TF32 off): one
     update+sample launch a step and no other kernel, an
     ``all_to_all_single`` on NCCL for each record leaf and the valid mask
     every step, a 1-row pending slot, finite losses, and the step-2
     checkpoint restored in a new group and replayed to step 4 bit for bit.
     Median steps beside phases 5's and 15's, peak memory.
 20. telemetry (after phase 19), in deterministic mode, TF32 on for the
     ResNet: (a) phase 5's flat configuration, 1 task, with ``run.obs`` off
     and then on (a ``dir``): the loss, ``rep_checksum`` and ``buffer_fill``
     histories bit for bit, the same launches, ``obs/fill`` equal to
     ``buffer_fill`` every step, a valid ``trace.json`` with ``eval`` and
     ``checkpoint_save`` spans, the median steps side by side; the same
     toggle on phase 7's fused tiered store (off, on); (b)
     ``obs.PhasePipeline`` on the flat and the fused tiered store, 4 steps
     each against the fused step bit for bit, the mean of each phase span
     (the paper's Fig. 6 breakdown) and the launches (the flat step's one
     update+sample launch split in two); (c) the mesh backend at 1x1 in a
     world-1 NCCL group, resilient with obs on, a failure injected: the
     ranks' agreement runs as collectives, the final state equals the
     clean run's bit for bit, and ``events.jsonl`` holds one ``restart``
     and the trace one ``restore`` span; (d) ``serve --obs DIR
     --metrics-port 0`` at SmolLM-135M full width: ``/metrics`` scraped
     once, and ``prefill`` and ``decode`` spans in the trace.
 21. the MoE and hybrid stacks (after phase 12, TF32 off): flash attention
     at Mixtral-8x7B's prefill (hd 128, H 32, KV 8, window 4096, S 8192) and
     the SSD scan at Jamba-v0.1's (H 128, P 64, N 16), f32 and bf16, against
     their plain versions, timed beside them (flash also beside SDPA with the
     window as its mask) and their bounds; then Mixtral-8x7B (4 of 32
     layers), Phi-3.5-MoE (4 of 32) and Jamba-v0.1 (one 8-layer unit of 32)
     at the published widths, weights drawn on the card from a seed, one
     arch at a time: prefill with the kernels against the plain path in f32
     and bf16 (Mixtral B 1 x S 8192, the others B 4 x S 2048), the routing
     pinned from the plain f32 forward (``repro_torch.testdata.routing``),
     4, 4 and 1 flash launches and 21 scan kernels (Jamba) a forward, the
     pairs that would choose another expert unpinned and the share dropped
     at capacity factor 1.25; ``DecodeEngine`` (batch 4, prompt 32, gen 16,
     capacity factor E / k) against the teacher-forced forward, routing
     pinned to the decode steps', and the serve CLI on the reduced config;
     the reduced config on the card against the CPU.
 22. the enc-dec and VLM stacks served, the MoE and hybrid stacks trained
     (after phase 21, TF32 off): flash attention at Qwen2-VL-72B's prefill
     (hd 128, H 64 over KV 8: 8 query heads a KV head, causal, S 2048), f32
     and bf16, against its plain version, timed beside it, SDPA and the
     bound; Qwen2-VL-72B at its published width cut to 2 of 80 layers,
     weights drawn on the card: prefill of B 4 x S 2048 patch-stub
     embeddings at an image block's M-RoPE positions with the kernels
     against the plain path in f32 and bf16 (phase 11's bounds, 2 flash
     launches a forward), ``DecodeEngine`` on token prompts against the
     teacher-forced forward, the serve CLI on the reduced config;
     Whisper-tiny whole (B 8, 1500 frames, 448 tokens): the kernel flag on,
     f32 against the CPU, bf16 bit for bit the flag-off forward, 0 launches
     of every kernel, decode over the encoder's output against the
     teacher-forced decoder, ``serve.main`` at full width; then
     ``launch.train.main(["--arch", ...])`` at the CLI's defaults, 2 x 4
     steps, on Mixtral-8x7B cut to 1 layer at the published widths and on
     Jamba-v0.1 reduced (Phi-3.5-MoE, whose MoE path is Mixtral's, is
     served in phase 21 and not trained here, for time): finite losses, one
     update+sample launch a step and no other kernel, and two backward
     passes of one batch bit for bit in deterministic mode.
 23. the model axis on one card (after phase 22, TF32 off): flash attention
     at one rank's share of Mixtral-8x7B's prefill at M = 2 (H 16, KV 4) and
     the SSD scan at Mamba2-370M's 16 local heads, f32 and bf16, against
     their plain versions, timed, SDPA (flash) and the bounds; the
     references in this process (the unsharded plain forwards, the train
     and serve CLIs at --mesh 1x1); then two processes through
     ``runtime.multiproc`` in a gloo group, both on cuda:0, a 1 x 2 mesh:
     (a) Mixtral-8x7B at the published widths cut to 2 of 32 layers,
     prefill B 1 x S 8192 tensor-parallel with the kernels on each rank's
     local heads (2 flash launches a forward per rank), f32 and bf16,
     routing pinned to the unsharded forward's, each rank's vocab shard of
     the logits within phase 11's bounds of the unsharded plain forward's;
     (b) Mamba2-370M whole, B 4 x S 2048, 48 x 3 scan launches per rank on
     16 local heads, the same checks; (c) ``launch.train.main --mesh 1x2``
     on Mamba2-370M, 2 x 4 steps in f32: finite losses, one update+sample
     launch a step per rank, the replicated parameters bit for bit on both
     ranks, the first step's loss within 1e-5 of the 1x1 run's; (d)
     ``serve.main --mesh 1x2`` on Mamba2-370M gives the 1x1 run's token
     ids. Every collective is a gloo ``all_reduce`` of CUDA tensors; a rank
     whose collective fails fails the phase. Times are those of one card
     shared by 2 processes over gloo, not of tensor parallelism across
     cards.
 24. the train step's memory knobs (after phase 23, TF32 off): (a) one
     train step of SmolLM-135M whole, B 4 x S 2048, f32, in deterministic
     mode under each of ``TrainConfig.remat`` none, dots and full: the loss
     and every gradient bit for bit across them, each one's median step and
     peak memory (full must hold less above the weights than dots, and dots
     less than none); then
     two processes over gloo on cuda:0: (c) on a 1 x 2 mesh,
     ``build_prefill_step`` with ``sequence_parallel`` off and on for
     phase 23's Mixtral-8x7B (2 layers, B 1 x S 8192) and Mamba2-370M (B 4
     x S 2048), f32 and bf16, routing pinned to the run without: the logits
     within phase 11's bounds of the run without, the same flash and scan
     launches (2, and 48 x 3, a rank), each one's peak; (b) on a 2 x 1 mesh,
     ``ContinualTrainer`` on the train CLI's run of Mamba2-370M (cut to 12
     of 48 layers, for time), 4
     steps f32 in deterministic mode, without and with ``zero1``, the
     gradient clip off and then on: each rank's moment bytes (their numel
     x 4) halved but for the 1-D leaves the rule leaves whole, its peak,
     one update+sample launch a step per rank, every parameter bit for bit
     on both ranks; clip off, the run without's bit for bit; clip on (its
     norm sums the slices in another order), each step's ``obs/grad_norm``
     within 1e-6 of the run without's, and the leaf farthest from it named
     with AdamW's second moment there.
 25. the ghost block and the model axis's restarts, tap strategies and
     encoder-decoder (after phase 24, TF32 off for its ranks): (a)
     ``resnet50_cl.ghostnet()`` at full width (224x224x3, 1000 classes), its
     forward on the card against the CPU as phase 4's, then
     ``ContinualTrainer`` on phase 5's flat configuration with it (running
     phase 5 itself when it did not run): one update+sample launch a step,
     finite losses, its median step beside phase 5's (both with TF32 on, as
     phase 5 runs); then two processes
     over gloo on cuda:0, a 1 x 2 mesh: (b) ``ContinualTrainer`` on the
     train CLI's Mamba2-370M run (1 task of 4 steps, f32, cut to 12 of 48
     layers as phase 23's training) with ``resilience`` in deterministic
     mode, clean and with model rank 1 failing before step 3: every rank
     restarts once and ends with the clean run's parameters, buffer and
     losses bit for bit, one update+sample launch a step a rank (the
     replayed step's included); (c) der_pp storing the whole vocabulary's
     top-16 pairs from the vocab-sharded logits on the same run: one launch
     a step a rank, finite losses, the two ranks' buffers the same bits;
     (d) ``serve.main --arch whisper-tiny --mesh 1x2`` gives the 1x1 run's
     token ids.
 26. GPipe, the sequence-sharded decode cache and the dry run (after phase
     20, TF32 off for its ranks): two processes over gloo on cuda:0, (a)
     SmolLM-135M whole in bf16 cut into 2 stages of 15 layers
     (``parallel.pipeline_apply`` through ``testdata.pipelined_forward``),
     phase 11's prefill (B 4 x S 2048) in 4 micro-batches: the logits within
     phase 11's bf16 bound of the f32 plain path, 60 flash launches a stage
     (15 layers x 4 micro-batches: the idle ticks run nothing), the
     pipelined forward's time beside the unpipelined one (gloo's host round
     trip: the handoff goes through host copies); (b) the same arch served
     through ``build_decode_step`` on a 1 x 2 row against 1 x 1 (batch 4,
     prompt 32, gen 16, f32 compute): the cache's sequence split over the
     row (3 KV heads do not divide 2), each rank's cache bytes half of 1 x
     1's and the ids 1 x 1's with a bf16 cache; a float8_e4m3fn cache half
     of bf16's bytes, its logits teacher-forced on the bf16 ids within 0.25
     of the bf16 cache's largest |logit|; (c) the dry run
     (``launch.dryrun.count_step``) of phase 11's bf16 prefill at 1 x 1:
     its argument bytes equal the state's on the card, its counted peak
     beside ``torch.cuda.max_memory_allocated``, the roofline's ideal time
     beside the measured forward.
 27. the port's invariant lint (``python -m repro_torch.analysis.lint``)
     over ``src/repro_torch``, this script and ``tests/test_torch_*.py``, in
     a subprocess under this machine's Python and torch: it must exit 0 (no
     finding, no unparsable file), and ``--list-rules`` must list the ten
     rules; the files checked, the findings suppressed and the lint's
     seconds are printed beside the card's name and power limit.
Each phase prints the seconds it took.

The second line from the end is a JSON object with one entry per kernel
(time, launches, bound, plain and library times); the last line is
``{"ok": true, "device": {...}}``. ``--only`` runs phases 1, 2 and the named
ones and prints neither line. The script needs ``src/repro_torch`` beside
it and a visible CUDA device; without either it fails before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores (NVIDIA data sheet)
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
L2_FLUSH_BYTES = 64 << 20  # larger than the 50 MB L2
LINK_PROBE_BYTES = 256 << 20  # pinned <-> device copy that measures the host link

# Data-scale cuts of the main path; the model's widths and the image size are
# never cut.
TASKS_RUN = 2  # of the stream's 4 tasks
STEPS_PER_TASK = 4
EVAL_PER_CLASS = 2
BATCH, REPS, CANDS, SLOTS = 16, 2, 4, 500  # b, r, c per worker; slots per bucket
# The tiered store's cuts: 4 hot slots per bucket only so that 8 steps
# overflow the hot tier and demote; a stage of 2c rows (the default).
BUCKETS, HOT, COLD, STAGE = 4, 4, 1000, 2 * CANDS
# Phase 18's buffers, for time: 4 x 100 flat slots and 4 x 200 cold slots
# (its checkpoints about 0.5 GB flat, 0.3 GB tiered, where phase 5's sizes
# gave 1.41 and 0.82 GB).
RES_SLOTS, RES_COLD = 100, 200
# The LM path: prefill of B sequences of S tokens at full width; serving at
# the reference CLI's defaults. Widths and depths are the published ones.
LM_ARCHS = ("smollm-135m", "mamba2-370m", "stablelm-3b", "gemma-2b")
SOURCES = ("rehearsal_ops", "quantize", "flash_attention", "flash_attention_sm90", "ssd_scan",
           "ssd_scan_sm90")
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, PROMPT, GEN = 4, 32, 16


class Phases:
    """``phase(name)`` starts phase ``name`` after printing the seconds the
    one before it took; ``phase.end()`` prints the last one's."""

    def __init__(self):
        self.name, self.start = None, 0.0

    def end(self):
        if self.name is not None:
            print(f"(phase {self.name}: {time.perf_counter() - self.start:.1f} s)", flush=True)

    def __call__(self, name: str):
        self.end()
        self.name, self.start = name.split()[0], time.perf_counter()
        print(f"\n== {name}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


HOLD_CYCLES = 2_000_000  # about 1 ms of GPU spin at the H100's clock


def time_ms(fn, iters: int = 30, warmup: int = 3, hold: bool = True, cold: bool = True) -> float:
    """Median time of ``fn`` in ms between CUDA events over ``iters`` runs,
    each started with a cold L2 (the train step evicts it between buffer
    updates; ``cold=False`` leaves the L2 as the last run left it, so a
    kernel's inputs are read from it). With ``hold`` the GPU spins before the
    start event while the host enqueues ``fn``, so the events time the device
    work alone; without it they also time the GPU idling on the host's launch
    overhead."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        if cold:
            flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        if hold:
            torch.cuda.synchronize()  # one run in flight at a time
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return bool(torch.equal(a, b))


CHUNK = 1 << 26  # elements compared at a time: a full-width logits tensor is 2.1 G


def _chunks(a: torch.Tensor, b: torch.Tensor):
    """Matching flat pieces of ``a`` and ``b``, so that their float64 copies
    stay small beside Gemma-2B's 8.4 GB f32 logits."""
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    a, b = a.reshape(-1), b.reshape(-1)
    for i in range(0, a.numel(), CHUNK):
        yield a[i:i + CHUNK].double(), b[i:i + CHUNK].double()


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b|; NaN if any element of either is NaN (torch's max keeps a
    NaN, Python's ``max`` over the chunks would drop one)."""
    if a.numel() == 0:
        return 0.0
    return float(torch.stack([(x - y).abs().max() for x, y in _chunks(a, b)]).max())


# ---------------------------------------------------------------------------
# phase 3: the rehearsal kernel against its plain version
# ---------------------------------------------------------------------------


def check_pair(ops, ref, buffer, cands, cand_rows, samp_rows):
    """Kernel and plain version on clones of the same inputs; returns the
    largest absolute difference, after asserting bit equality."""
    kb, kr = ops.rehearsal_update_sample(buffer.clone(), cands, cand_rows, samp_rows)
    pb, pr = ref.rehearsal_update_sample_ref(buffer.clone(), cands, cand_rows, samp_rows)
    torch.cuda.synchronize()
    if not (same_bits(kb, pb) and same_bits(kr, pr)):
        raise AssertionError(
            f"kernel != plain version: buffer {tuple(buffer.shape)} {buffer.dtype}, "
            f"C={cands.shape[0]}, S={samp_rows.shape[0]}, max abs err "
            f"{max(abs_err(kb, pb), abs_err(kr, pr))}")
    return max(abs_err(kb, pb), abs_err(kr, pr))


def sweep(ops, ref, seed: int = 0) -> float:
    """Seeded sweep: duplicates, rows < 0 and >= R, clamped samples, f32 and
    i32, 16-byte and 4-byte paths (odd widths, offset candidate pointers)."""
    rng = np.random.default_rng(seed)
    worst, n = 0.0, 0
    for r in (1, 7, 64, 300):
        for width in (1, 3, 4, 37, 1024, 8195):
            for dtype in (torch.float32, torch.int32):
                c, s = int(rng.integers(0, 41)), int(rng.integers(0, 10))
                if dtype == torch.float32:
                    buf = torch.randn((r, width), device="cuda")
                    big = torch.randn((c + 1, width), device="cuda")
                else:
                    buf = torch.randint(-2**31, 2**31 - 1, (r, width), device="cuda",
                                        dtype=torch.int32)
                    big = torch.randint(-2**31, 2**31 - 1, (c + 1, width),
                                        device="cuda", dtype=torch.int32)
                cands = big[1:] if n % 2 else big[:c]  # offset pointer every other case
                cand_rows = torch.as_tensor(rng.integers(-3, r + 3, size=c),
                                            dtype=torch.int32, device="cuda")
                samp_rows = torch.as_tensor(rng.integers(-2, r + 2, size=s),
                                            dtype=torch.int32, device="cuda")
                worst = max(worst, check_pair(ops, ref, buf, cands, cand_rows, samp_rows))
                n += 1
    print(f"sweep: {n} cases bit-equal to the plain version")
    return worst


def check_leaves(ops, ref, tables, cands, cand_rows, samp_rows):
    """The list form (one launch for every leaf) against the plain version
    leaf by leaf, on clones of the same inputs; asserts bit equality and one
    launch."""
    got_tables = [t.clone() for t in tables]
    before = ops.rehearsal_update_sample.launches
    got = ops.rehearsal_update_sample_leaves(got_tables, cands, cand_rows, samp_rows)
    launched = ops.rehearsal_update_sample.launches - before
    for i, (table, cand) in enumerate(zip(tables, cands)):
        pb, pr = ref.rehearsal_update_sample_ref(table.clone(), cand, cand_rows, samp_rows)
        torch.cuda.synchronize()
        if not (same_bits(got_tables[i], pb) and same_bits(got[i], pr)):
            raise AssertionError(
                f"list form != plain version on leaf {i}: table {tuple(table.shape)} "
                f"{table.dtype}, C={cand.shape[0]}, S={samp_rows.shape[0]}")
    moves = cand_rows.shape[0] + samp_rows.shape[0] > 0
    if launched != int(moves):
        raise AssertionError(f"the list form launched {launched} kernels, expected {int(moves)}")


def leaves_sweep(ops, ref, seed: int = 2):
    """Seeded sweep of the list form: 1 to 5 leaves of f32, i32 and int8 rows
    of mixed widths (the 16-, 4- and 1-byte paths in one launch), shared
    duplicates, drops, clamped samples and empty candidate sets."""
    rng = np.random.default_rng(seed)
    n = 0
    for r in (1, 7, 300):
        for n_leaves in (1, 3, 5):
            for c in (0, 5, 33):
                tables, cands = [], []
                for i in range(n_leaves):
                    width = int(rng.choice([1, 3, 4, 37, 1024, 8195, 150528]))
                    dtype = (torch.float32, torch.int32, torch.int8)[(i + n) % 3]
                    lo, hi = (-127, 128) if dtype == torch.int8 else (-2**31, 2**31 - 1)
                    tables.append(torch.randint(lo, hi, (r, width), dtype=dtype, device="cuda")
                                  if dtype != torch.float32
                                  else torch.randn((r, width), device="cuda"))
                    big = (torch.randint(lo, hi, (c + 1, width), dtype=dtype, device="cuda")
                           if dtype != torch.float32 else torch.randn((c + 1, width),
                                                                      device="cuda"))
                    cands.append(big[1:] if (n + i) % 2 else big[:c])  # offset pointers
                cand_rows = torch.as_tensor(rng.integers(-3, r + 3, size=c), dtype=torch.int32,
                                            device="cuda")
                samp_rows = torch.as_tensor(rng.integers(-2, r + 2, size=int(rng.integers(0, 6))),
                                            dtype=torch.int32, device="cuda")
                check_leaves(ops, ref, tables, cands, cand_rows, samp_rows)
                n += 1
    print(f"list-form sweep: {n} cases, one launch each, bit-equal to the plain version "
          f"leaf by leaf")


def check_pinned_leaves(ops, ref, tables, cands, cand_rows, samp_rows):
    """The list form on tables in pinned host memory (the cold tier) against
    the plain version on device copies, leaf by leaf; asserts bit equality
    and one launch."""
    want_tables = [t.to("cuda") for t in tables]
    before = ops.rehearsal_update_sample.launches
    got = ops.rehearsal_update_sample_leaves(tables, cands, cand_rows, samp_rows)
    if ops.rehearsal_update_sample.launches - before != 1:
        raise AssertionError("the list form on pinned tables was not one launch")
    for i, (table, want_table, cand) in enumerate(zip(tables, want_tables, cands)):
        pb, pr = ref.rehearsal_update_sample_ref(want_table, cand, cand_rows, samp_rows)
        torch.cuda.synchronize()
        if not (same_bits(table, pb) and same_bits(got[i], pr)):
            raise AssertionError(f"pinned list form != plain version on leaf {i}: table "
                                 f"{tuple(table.shape)} {table.dtype}")


def strategy_records(ops, ref, leaves, cands, cand_rows, samp_rows):
    """The tap strategies' records at full width through one update+sample
    launch, bit for bit against the plain version leaf by leaf: der's image
    f32 [150528], label and task i32 and either dense logits f32 [1000] or
    the top-8 pairs (logit_vals f32 [8], logit_idx i32 [8]), and
    grasp_embed's embedding f32 [2048]; on the flat buffer's device tables
    at the main path's rows, and in the cold tier's pinned layout (int8 q
    and f32 scale per float field, i32 fields raw) at the tiered path's."""
    rows_total = leaves["images"].shape[0]
    extra = {"der, dense logits": [(torch.float32, 1000)],
             "der, top-8 pairs": [(torch.float32, 8), (torch.int32, 8)],
             "grasp_embed": [(torch.float32, 2048)]}

    def rand(shape, dtype, where="cuda"):
        if dtype == torch.float32:
            return torch.randn(shape, device=where)
        lo, hi = (-127, 128) if dtype == torch.int8 else (-2**31, 2**31 - 1)
        return torch.randint(lo, hi, shape, dtype=dtype, device=where)

    for name, fields in extra.items():
        tables = list(leaves.values()) + [rand((rows_total, w), d) for d, w in fields]
        batch = list(cands.values()) + [rand((BATCH, w), d) for d, w in fields]
        check_leaves(ops, ref, tables, batch, cand_rows, samp_rows)
    cold_rows = BUCKETS * COLD
    base = [(torch.int8, leaves["images"].shape[1]), (torch.float32, 1), (torch.int32, 1),
            (torch.int32, 1)]
    common = [rand((cold_rows, w), d, "cpu").pin_memory() for d, w in base]
    flush_rows = torch.tensor([3, cold_rows, 17, cold_rows, 2500, cold_rows, 3999, cold_rows],
                              dtype=torch.int32, device="cuda")
    cold_samp = torch.tensor([17, 1000], dtype=torch.int32, device="cuda")
    for name, fields in extra.items():
        cold_fields = [(torch.int8, w) if d == torch.float32 else (d, w) for d, w in fields]
        cold_fields += [(torch.float32, 1) for d, _ in fields if d == torch.float32]
        tables = common + [rand((cold_rows, w), d, "cpu").pin_memory() for d, w in cold_fields]
        batch = [rand((STAGE, t.shape[1]), t.dtype) for t in tables]
        check_pinned_leaves(ops, ref, tables, batch, flush_rows, cold_samp)
    print(f"tap strategies' records, one launch each, bit-equal to the plain version leaf "
          f"by leaf: {', '.join(extra)}; flat ({rows_total} rows on the card, 4-5 leaves) "
          f"and cold ({cold_rows} rows pinned, 6-7 leaves)")


def main_path_inputs(rows_total: int, seed: int = 1):
    """Row vectors at the main path's shapes: C = b = 16 candidates of which
    c = 4 are accepted (distinct rows; the rest carry the out-of-range drop
    row K*slots), and S = r = 2 sampled rows."""
    rng = np.random.default_rng(seed)
    cand_rows = np.full(BATCH, rows_total, np.int32)
    accepted = rng.choice(BATCH, size=CANDS, replace=False)
    cand_rows[accepted] = rng.choice(rows_total, size=CANDS, replace=False)
    samp_rows = rng.integers(0, rows_total, size=REPS).astype(np.int32)
    return (torch.as_tensor(cand_rows, device="cuda"),
            torch.as_tensor(samp_rows, device="cuda"))


def kernel_phase(ops, ref, image_len: int):
    rows_total = 4 * SLOTS
    leaves = {
        "images": torch.randn((rows_total, image_len), device="cuda"),
        "label": torch.randint(0, 1000, (rows_total, 1), device="cuda", dtype=torch.int32),
        "task": torch.randint(0, 4, (rows_total, 1), device="cuda", dtype=torch.int32),
    }
    cands = {
        "images": torch.randn((BATCH, image_len), device="cuda"),
        "label": torch.randint(0, 1000, (BATCH, 1), device="cuda", dtype=torch.int32),
        "task": torch.randint(0, 4, (BATCH, 1), device="cuda", dtype=torch.int32),
    }
    cand_rows, samp_rows = main_path_inputs(rows_total)
    worst = 0.0
    for name in leaves:
        worst = max(worst, check_pair(ops, ref, leaves[name], cands[name],
                                      cand_rows, samp_rows))
    print(f"main-path shapes: images {tuple(leaves['images'].shape)} f32, label/task "
          f"{tuple(leaves['label'].shape)} i32 -- bit-equal")
    check_leaves(ops, ref, list(leaves.values()), list(cands.values()), cand_rows, samp_rows)
    print("main-path shapes, list form: the three leaves in one launch -- bit-equal")
    worst = max(worst, sweep(ops, ref))
    leaves_sweep(ops, ref)
    strategy_records(ops, ref, leaves, cands, cand_rows, samp_rows)

    # the work of one step: one launch for the record's three leaves
    tables, batches = list(leaves.values()), list(cands.values())

    def kernel_step():
        ops.rehearsal_update_sample_leaves(tables, batches, cand_rows, samp_rows)

    def single(name):  # one leaf through the single-leaf form: one launch
        return lambda: ops.rehearsal_update_sample(leaves[name], cands[name], cand_rows,
                                                   samp_rows)

    def three_launch_step():  # the step before the list form: one launch per leaf
        for name in leaves:
            ops.rehearsal_update_sample(leaves[name], cands[name], cand_rows, samp_rows)

    def plain_step():
        for name in leaves:
            ref.rehearsal_update_sample_ref(leaves[name], cands[name], cand_rows,
                                            samp_rows)

    # library yardstick: index_copy_ on deduplicated rows, then index_select
    rows_list = cand_rows.tolist()
    winners = [i for i, row in enumerate(rows_list)
               if 0 <= row < rows_total and row not in rows_list[i + 1:]]
    win_rows = cand_rows[winners].long()
    win_cands = {k: v[winners].contiguous() for k, v in cands.items()}
    samp_long = samp_rows.long().clamp(0, rows_total - 1)

    def library_step():
        for name in leaves:
            leaves[name].index_copy_(0, win_rows, win_cands[name])
            leaves[name].index_select(0, samp_long)

    ms = time_ms(kernel_step)
    three_ms = time_ms(three_launch_step)
    per_leaf = {name: time_ms(single(name)) for name in leaves}
    plain_ms = time_ms(plain_step)
    library_ms = time_ms(library_step)
    ms_again = time_ms(kernel_step)
    three_again = time_ms(three_launch_step)
    host_ms = time_ms(kernel_step, hold=False)
    three_host_ms = time_ms(three_launch_step, hold=False)
    library_host_ms = time_ms(library_step, hold=False)
    accepted = len(winners)
    moved_rows = 2 * accepted + 2 * REPS  # read + write of each accepted and sampled row
    row_bytes = sum(v.shape[1] * v.element_size() for v in leaves.values())
    index_bytes = 4 * (BATCH + REPS)  # one launch reads the row vectors once
    total_bytes = moved_rows * row_bytes + index_bytes
    bound_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    print(f"one step (3 leaves, {accepted} accepted + {REPS} sampled rows, "
          f"{total_bytes} bytes), device time: kernel, one launch {ms:.4f} ms (repeat "
          f"{ms_again:.4f}) = {total_bytes / ms / 1e6:.1f} GB/s; three single-leaf launches "
          f"{three_ms:.4f} ms (repeat {three_again:.4f}), of which alone: "
          + ", ".join(f"{name} {t:.4f} ms" for name, t in per_leaf.items())
          + f"; plain {plain_ms:.4f} ms, index_copy_+index_select {library_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms (bytes at {HBM_BYTES_PER_S / 1e12} TB/s)")
    print(f"same step with the GPU waiting on the host's launches: kernel, one launch "
          f"{host_ms:.4f} ms, three launches {three_host_ms:.4f} ms, "
          f"index_copy_+index_select {library_host_ms:.4f} ms")
    return {"name": "rehearsal_update_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rehearsal_ops.cu",
            "replaces": "src/repro/kernels/rehearsal_ops.py:225",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
            "ms_three_launches": three_ms}


def link_rates():
    """Host-link rate in bytes/s each way, from a large pinned <-> device
    copy timed between CUDA events: (host to device, device to host)."""
    host = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(LINK_PROBE_BYTES, dtype=torch.uint8, device="cuda")
    h2d = time_ms(lambda: dev.copy_(host, non_blocking=True), iters=10)
    d2h = time_ms(lambda: host.copy_(dev, non_blocking=True), iters=10)
    rates = (LINK_PROBE_BYTES / h2d * 1e3, LINK_PROBE_BYTES / d2h * 1e3)
    print(f"host link, {LINK_PROBE_BYTES >> 20} MiB pinned <-> device copy: host to device "
          f"{rates[0] / 1e9:.2f} GB/s ({h2d:.4f} ms), device to host {rates[1] / 1e9:.2f} "
          f"GB/s ({d2h:.4f} ms)")
    return rates


def pinned_update_sample(ops, ref, link_d2h: float):
    """The unfused cold scatter: rehearsal_update_sample on a pinned int8
    table at the tiered path's shapes (4 accepted stage rows written over the
    host link, 2 sampled rows read back). Printed, not in the kernels line."""
    rows_total, width = BUCKETS * COLD, 150528
    table = torch.zeros((rows_total, width), dtype=torch.int8, pin_memory=True)
    cands = torch.randint(-127, 128, (STAGE, width), dtype=torch.int8, device="cuda")
    cand_rows = torch.tensor([3, rows_total, 17, rows_total, 2500, rows_total, 3999,
                              rows_total], dtype=torch.int32, device="cuda")
    samp_rows = torch.tensor([17, 1000], dtype=torch.int32, device="cuda")
    _, got = ops.rehearsal_update_sample(table, cands, cand_rows, samp_rows)
    want_table = table.to("cuda")  # after the kernel's writes
    torch.cuda.synchronize()
    _, want = ref.rehearsal_update_sample_ref(want_table, cands, cand_rows, samp_rows)
    if not same_bits(got, want):
        raise AssertionError("pinned-table update+sample != plain version")
    ms = time_ms(lambda: ops.rehearsal_update_sample(table, cands, cand_rows, samp_rows))
    device_table = table.to("cuda")
    dev_ms = time_ms(lambda: ops.rehearsal_update_sample(device_table, cands, cand_rows,
                                                         samp_rows))
    link_bytes = (4 + REPS) * width
    print(f"rehearsal_update_sample, int8 [{rows_total}, {width}] table in pinned host "
          f"memory, 4 rows written + {REPS} read: {ms:.4f} ms (same call on a device "
          f"table {dev_ms:.4f} ms); link bound {link_bytes / link_d2h * 1e3:.5f} ms")


def int8_sweep(qz, ops, ref, seed: int = 0):
    """Seeded sweep of the four int8 kernels against their plain versions:
    ragged widths (int8 rows not a multiple of 4 bytes), duplicates, rows < 0
    and >= R, clamped samples, f32/bf16/f16 records, tables on the card and
    in pinned host memory, offset input pointers."""
    rng = np.random.default_rng(seed)
    n = 0
    for r in (1, 7, 300):
        for width in (1, 3, 4, 37, 1024, 8195):
            for where in ("device", "pinned"):
                dtype = (torch.float32, torch.bfloat16, torch.float16)[n % 3]
                c, s = int(rng.integers(0, 13)), int(rng.integers(0, 10))
                q = torch.as_tensor(rng.integers(-127, 128, (r, width)), dtype=torch.int8)
                scales = torch.as_tensor(rng.uniform(1e-4, 4.0, (r, 1)), dtype=torch.float32)
                if where == "pinned":
                    q, scales = q.pin_memory(), scales.pin_memory()
                else:
                    q, scales = q.cuda(), scales.cuda()
                big = (torch.randn((c + 1, width), device="cuda") * 3).to(dtype)
                x = big[1:] if n % 2 else big[:c]  # offset pointer every other case
                rows = torch.as_tensor(rng.integers(-2, r + 2, c), dtype=torch.int32,
                                       device="cuda")
                samp = torch.as_tensor(rng.integers(-2, r + 2, s), dtype=torch.int32,
                                       device="cuda")
                want_q, want_s = q.to("cuda", copy=True), scales.to("cuda", copy=True)
                ops.encode_scatter_rows(q, scales, x, rows)
                ref.encode_scatter_rows_ref(want_q, want_s, x, rows)
                got = ops.gather_dequant_rows(q, scales, samp, dtype)
                want = ref.gather_dequant_rows_ref(want_q, want_s, samp, dtype)
                kq, ks = qz.quantize_rows(x)
                pq, ps = ref.quantize_rows_ref(x)
                _, kr = ops.rehearsal_update_sample(q, kq, rows, samp)  # the byte path
                _, pr = ref.rehearsal_update_sample_ref(want_q, kq, rows, samp)
                torch.cuda.synchronize()
                pairs = [(q, want_q), (scales, want_s), (got, want), (kq, pq), (ks, ps),
                         (qz.dequantize_rows(kq, ks, dtype), ref.dequantize_rows_ref(pq, ps, dtype)),
                         (kr, pr)]
                for a, b in pairs:
                    if not same_bits(a, b):
                        raise AssertionError(
                            f"int8 kernel != plain version: table [{r}, {width}] {where}, "
                            f"{dtype}, C={c}, S={s}")
                n += 1
    print(f"int8 sweep: {n} cases, four kernels and the byte path bit-equal to the plain "
          f"versions")


def halfway_cases(qz, ops, ref, n_rows: int = 64):
    """quantize_rows and encode_scatter_rows (device and pinned tables) on
    rows whose x / scale lands on or one ulp beside a half-integer
    (``repro_torch.testdata.halfway_rows``), at a width that takes the
    scalar layout and one that takes the 16-byte one. The set tells the IEEE
    division from a multiply by the reciprocal: that shortcut must disagree
    with the plain version on it."""
    from repro_torch.testdata import HALFWAY_WIDTH, halfway_rows
    differ = 0
    for width in (HALFWAY_WIDTH, 1024):
        x = torch.from_numpy(halfway_rows(n_rows, width, seed=width)).cuda()
        pq, ps = ref.quantize_rows_ref(x)
        recip = torch.clamp(torch.round(x * (1.0 / ps)), -127, 127).to(torch.int8)
        differ += int((recip != pq).sum())
        kq, ks = qz.quantize_rows(x)
        torch.cuda.synchronize()
        if not (same_bits(kq, pq) and same_bits(ks, ps)):
            raise AssertionError(f"quantize_rows != plain version on the half-way rows "
                                 f"[{n_rows}, {width}]")
        rows = torch.arange(2 * n_rows - 1, -1, -2, dtype=torch.int32, device="cuda")
        rows[::5] = -1
        for where in ("device", "pinned"):
            q = torch.zeros((2 * n_rows, width), dtype=torch.int8)
            scales = torch.ones((2 * n_rows, 1))
            q, scales = (q.pin_memory(), scales.pin_memory()) if where == "pinned" else \
                (q.cuda(), scales.cuda())
            want_q, want_s = q.to("cuda", copy=True), scales.to("cuda", copy=True)
            ops.encode_scatter_rows(q, scales, x, rows)
            ref.encode_scatter_rows_ref(want_q, want_s, x, rows)
            torch.cuda.synchronize()
            if not (same_bits(q, want_q) and same_bits(scales, want_s)):
                raise AssertionError(f"encode_scatter_rows ({where}) != plain version on the "
                                     f"half-way rows [{n_rows}, {width}]")
    if differ == 0:
        raise AssertionError("the half-way rows do not tell division from the reciprocal")
    return (f"half-way rows ({2 * n_rows} x {3 * 252} values): bit-equal through "
            f"quantize_rows and encode_scatter_rows; x * (1/scale) would move {differ} of them")


def quantize_phases(x, phases: int):
    """quantize_rows' kernel on f32 x stopped after ``phases`` of its three
    phases (csrc/quantize.cu::quantize_rows_phases), to time each phase. Not
    counted on quantize_rows.launches. Returns (q, scales)."""
    from repro_torch.kernels import build
    fn = build.c_function("quantize", "quantize_rows_phases",
                          [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 +
                          [ctypes.c_int, ctypes.c_void_p])
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((x.shape[0], 1), device=x.device)
    err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), x.shape[0], x.shape[1], phases,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"quantize_rows_phases ({phases}) failed: CUDA error {err}")
    return q, scales


def quantizer_anatomy(qz, ops, x, pinned: tuple, device: tuple, flush_rows):
    """Where the quantizer's time goes at the path's shapes (one cluster of
    8 blocks a row): with x already in L2 (the read from HBM's share),
    stopped after each of its phases, and the flush of encode_scatter_rows
    into device copies of the tables (the host link's share)."""
    cold = time_ms(lambda: qz.quantize_rows(x))
    warm = time_ms(lambda: qz.quantize_rows(x), cold=False)
    ms = [time_ms(lambda: quantize_phases(x, p)) for p in (1, 2, 3)]
    print(f"quantize_rows f32 {list(x.shape)}, clusters of 8 blocks a row "
          f"({8 * x.shape[0]} CTAs): {cold:.4f} ms, x in L2 {warm:.4f} ms; the kernel stopped "
          f"after each phase: load and reduce {ms[0]:.4f} ms, + the maxima's exchange and "
          f"scale {ms[1]:.4f} ms, + quantize and store {ms[2]:.4f} ms")
    to_pinned = time_ms(lambda: ops.encode_scatter_rows(*pinned, x, flush_rows))
    to_device = time_ms(lambda: ops.encode_scatter_rows(*device, x, flush_rows))
    print(f"encode_scatter_rows, the path's flush: pinned tables {to_pinned:.4f} ms, device "
          f"copies of the tables {to_device:.4f} ms, so the link costs "
          f"{to_pinned - to_device:.4f} ms of it")


def launch_floors(rows: int) -> dict:
    """Device time of an empty kernel of ``rows`` x 8 blocks of 512 threads,
    timed as the int8 kernels are: as a plain grid (key "grid") and as
    clusters of 8 (key "cluster")."""
    from repro_torch.kernels import build
    fn = build.c_function("quantize", "launch_floor", [ctypes.c_int] * 2 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def launch(clustered):
        err = fn(rows * 8, clustered, stream)
        if err != 0:
            raise RuntimeError(f"launch_floor (clustered {clustered}) failed: CUDA error {err}")

    floors = {"grid": time_ms(lambda: launch(0)), "cluster": time_ms(lambda: launch(1))}
    print(f"launch floor, an empty kernel of {rows} x 8 blocks of 512 threads: plain grid "
          f"{floors['grid']:.4f} ms, clusters of 8 {floors['cluster']:.4f} ms")
    return floors


def pinned_read_curve(ops, q_table, s_table):
    """How fast a kernel reads pinned host memory as the bytes grow: the
    gather of n distinct cold-tier rows against the copy engine moving the
    same bytes (n consecutive rows) from pinned memory to the card."""
    width = q_table.shape[1]
    for n in (2, 8, 32, 128):
        rows = torch.arange(0, n * 7, 7, dtype=torch.int32, device="cuda")
        dst = torch.empty((n, width), dtype=torch.int8, device="cuda")
        kernel = time_ms(lambda: ops.gather_dequant_rows(q_table, s_table, rows))
        copy = time_ms(lambda: dst.copy_(q_table[:n], non_blocking=True))
        print(f"  pinned read of {n} int8 rows ({n * width} B): gather_dequant_rows {kernel:.4f} ms "
              f"= {n * width / kernel / 1e6:.2f} GB/s; copy engine {copy:.4f} ms = "
              f"{n * width / copy / 1e6:.2f} GB/s")


def pinned_write_curve(ops, q_table, s_table, d2h: float):
    """How fast encode_scatter_rows writes pinned host memory as the bytes
    grow: n distinct cold-tier rows (f32 staged rows read from the card)
    against the copy engine moving the same int8 bytes from the card to
    pinned memory."""
    width = q_table.shape[1]
    for n in (2, 4, 8, 32, 128):
        rows = torch.arange(0, n * 7, 7, dtype=torch.int32, device="cuda")
        x = torch.randn((n, width), device="cuda")
        src = torch.zeros((n, width), dtype=torch.int8, device="cuda")
        kernel = time_ms(lambda: ops.encode_scatter_rows(q_table, s_table, x, rows))
        copy = time_ms(lambda: q_table[:n].copy_(src, non_blocking=True))
        print(f"  pinned write of {n} int8 rows ({n * width} B): encode_scatter_rows "
              f"{kernel:.4f} ms = {n * width / kernel / 1e6:.2f} GB/s; copy engine {copy:.4f} "
              f"ms = {n * width / copy / 1e6:.2f} GB/s (256 MiB copy: {d2h / 1e9:.2f} GB/s)")


def int8_kernel_phase(qz, ops, ref, link: tuple):
    """The four int8 kernels at the tiered path's shapes (f32 image rows of
    150,528 values, a stage of 8 rows of which 4 are written, 2 sampled rows,
    cold tables [4000, 150528] int8 in pinned host memory); their times,
    plain times and bounds. Returns their kernels-line entries."""
    h2d, d2h = link
    width, rows_total = 150528, BUCKETS * COLD
    q_table = torch.zeros((rows_total, width), dtype=torch.int8, pin_memory=True)
    s_table = torch.ones((rows_total, 1), dtype=torch.float32, pin_memory=True)
    x = torch.randn((STAGE, width), device="cuda") * 3
    # a steady-state flush: 4 staged evictions, 4 empty stage rows dropped
    flush = torch.tensor([12, rows_total, 2017, rows_total, 1003, rows_total, 3998,
                          rows_total], dtype=torch.int32, device="cuda")
    samp = torch.tensor([2017, 12], dtype=torch.int32, device="cuda")
    written, sampled = int(((flush >= 0) & (flush < rows_total)).sum()), samp.shape[0]

    ops.encode_scatter_rows(q_table, s_table, x, flush)
    got = ops.gather_dequant_rows(q_table, s_table, samp)
    q_dev, s_dev = torch.zeros((rows_total, width), dtype=torch.int8, device="cuda"), \
        torch.ones((rows_total, 1), device="cuda")
    ref.encode_scatter_rows_ref(q_dev, s_dev, x, flush)
    want = ref.gather_dequant_rows_ref(q_dev, s_dev, samp)
    kq, ks = qz.quantize_rows(x)
    pq, ps = ref.quantize_rows_ref(x)
    kd = qz.dequantize_rows(kq[:REPS].contiguous(), ks[:REPS].contiguous())
    pd = ref.dequantize_rows_ref(pq[:REPS], ps[:REPS])
    torch.cuda.synchronize()
    checks = {"encode_scatter_rows table": (q_table, q_dev),
              "encode_scatter_rows scales": (s_table, s_dev),
              "gather_dequant_rows": (got, want), "quantize_rows q": (kq, pq),
              "quantize_rows scales": (ks, ps), "dequantize_rows": (kd, pd)}
    for what, (a, b) in checks.items():
        if not same_bits(a, b):
            raise AssertionError(f"{what}: kernel != plain version at the path's shapes")
    errs = {"gather_dequant_rows": abs_err(got, want), "quantize_rows": abs_err(kq, pq),
            "dequantize_rows": abs_err(kd, pd), "encode_scatter_rows": abs_err(
                q_table[flush[flush < rows_total].long().cpu()].cuda(),
                q_dev[flush[flush < rows_total].long()])}
    print(f"path shapes: stage f32 [{STAGE}, {width}] ({written} rows written), "
          f"{sampled} sampled rows, cold tables [{rows_total}, {width}] int8 + "
          f"[{rows_total}, 1] f32 in pinned host memory -- bit-equal")
    int8_sweep(qz, ops, ref)

    q2, s2 = kq[:REPS].contiguous(), ks[:REPS].contiguous()
    timed = {
        "quantize_rows": (lambda: qz.quantize_rows(x), lambda: ref.quantize_rows_ref(x)),
        "dequantize_rows": (lambda: qz.dequantize_rows(q2, s2),
                            lambda: ref.dequantize_rows_ref(q2, s2)),
        "gather_dequant_rows": (lambda: ops.gather_dequant_rows(q_table, s_table, samp),
                                lambda: ref.gather_dequant_rows_ref(q_dev, s_dev, samp)),
        "encode_scatter_rows": (lambda: ops.encode_scatter_rows(q_table, s_table, x, flush),
                                lambda: ref.encode_scatter_rows_ref(q_dev, s_dev, x, flush)),
    }
    # bytes each function must move: (HBM bytes, host-link bytes, link rate)
    f32_row, i8_row = 4 * width, width
    moved = {
        "quantize_rows": (STAGE * (f32_row + i8_row + 4), 0, h2d),
        "dequantize_rows": (REPS * (i8_row + 4 + f32_row), 0, h2d),
        "gather_dequant_rows": (sampled * f32_row + 4 * sampled, sampled * (i8_row + 4), h2d),
        "encode_scatter_rows": (written * f32_row + 4 * STAGE, written * (i8_row + 4), d2h),
    }
    replaces = {"quantize_rows": "src/repro/kernels/quantize.py:44",
                "dequantize_rows": "src/repro/kernels/quantize.py:69",
                "gather_dequant_rows": "src/repro/kernels/rehearsal_ops.py:283",
                "encode_scatter_rows": "src/repro/kernels/rehearsal_ops.py:351"}
    sources = {"quantize_rows": "src/repro_torch/kernels/csrc/quantize.cu",
               "dequantize_rows": "src/repro_torch/kernels/csrc/quantize.cu",
               "gather_dequant_rows": "src/repro_torch/kernels/csrc/rehearsal_ops.cu",
               "encode_scatter_rows": "src/repro_torch/kernels/csrc/rehearsal_ops.cu"}
    # dequantize_rows at the f32 record dtype is one PyTorch call: int8 [R, L]
    # times f32 [R, 1] promotes to f32 and rounds once, the plain version's
    # bits. The other three need more than one call (a row max, a division
    # and a rounding; or an index on top), so they have no library time.
    library = {"dequantize_rows": lambda: torch.mul(q2, s2)}
    if not same_bits(torch.mul(q2, s2), ref.dequantize_rows_ref(q2, s2)):
        raise AssertionError("torch.mul(q, scales) != dequantize_rows' plain version")
    # gather_dequant_rows' plain version gathers from device copies of the
    # tables (q_dev, s_dev), so it never crosses the host link; the kernel on
    # those device copies shows the link's share of the kernel's time
    gather_dev_ms = time_ms(lambda: ops.gather_dequant_rows(q_dev, s_dev, samp))
    pinned_read_curve(ops, q_table, s_table)
    entries = []
    for name, (kernel, plain) in timed.items():
        ms, plain_ms, ms_again = time_ms(kernel), time_ms(plain), time_ms(kernel)
        library_ms = time_ms(library[name]) if name in library else None
        hbm, link_bytes, rate = moved[name]
        hbm_ms, link_ms = hbm / HBM_BYTES_PER_S * 1e3, link_bytes / rate * 1e3
        bound_ms = max(hbm_ms, link_ms)
        at = "host link" if link_ms > hbm_ms else "HBM"
        lib = (f"torch.mul {library_ms:.4f} ms" if library_ms is not None
               else "no single PyTorch call computes it (library_ms null)")
        plain_what = (" (a gather from device copies of the tables: no host link)"
                      if name == "gather_dequant_rows" else "")
        print(f"{name}: kernel {ms:.4f} ms (repeat {ms_again:.4f}), plain {plain_ms:.4f} ms"
              f"{plain_what}, bound {bound_ms:.5f} ms by bytes over the {at} (HBM {hbm} B = "
              f"{hbm_ms:.5f} ms, link {link_bytes} B = {link_ms:.5f} ms); {lib}")
        entries.append({"name": name, "route": "cuda", "source": sources[name],
                        "replaces": replaces[name], "max_abs_err": errs[name],
                        "ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": "bytes", "bound_at": at,
                        "library_ms": library_ms})
        if name == "gather_dequant_rows":
            rate = link_bytes / ms / 1e6
            print(f"gather_dequant_rows reads pinned host memory at {rate:.2f} GB/s "
                  f"({link_bytes} B in {ms:.4f} ms, launch included) against the copy "
                  f"engine's {h2d / 1e9:.2f} GB/s host to device; the same kernel on device "
                  f"copies of the tables {gather_dev_ms:.4f} ms, so the link costs "
                  f"{ms - gather_dev_ms:.4f} ms of it")
            entries[-1].update({"ms_device_tables": gather_dev_ms, "pinned_read_GBps": rate,
                                "copy_engine_GBps": h2d / 1e9})
    # the probes below come after the timed kernels, so that none of their
    # launches or pinned writes precedes a timing
    floors = launch_floors(STAGE)
    for entry in entries:
        clustered = entry["name"] in ("quantize_rows", "encode_scatter_rows")
        entry["launch_floor_ms"] = floors["cluster" if clustered else "grid"]
    print("  beside the launch floor: " + ", ".join(
        f"{e['name']} {e['ms']:.4f} ms (floor {e['launch_floor_ms']:.4f})" for e in entries))
    print(halfway_cases(qz, ops, ref))
    pinned_write_curve(ops, q_table, s_table, d2h)
    quantizer_anatomy(qz, ops, x, (q_table, s_table), (q_dev, s_dev), flush)
    return entries


def check_folded(ops, ref, tables, cands, cand_rows, samp_rows, dtype, what):
    """The dequantizing update+sample (one launch) against its plain version
    (update+sample leaf by leaf on device copies of the tables, then
    dequantize_rows_ref) on clones of the same inputs: every table and every
    sample bit for bit, one launch. Returns the max abs error of the
    dequantized sample."""
    got_tables = [t.clone().pin_memory() if t.is_pinned() else t.clone() for t in tables]
    want_tables = [t.to("cuda", copy=True) for t in tables]
    before = ops.rehearsal_update_sample.launches
    got = ops.rehearsal_update_sample_leaves(got_tables, cands, cand_rows, samp_rows,
                                             {0: (1, dtype)})
    launched = ops.rehearsal_update_sample.launches - before
    want = ref.rehearsal_update_sample_leaves_ref(want_tables, cands, cand_rows, samp_rows,
                                                  {0: (1, dtype)})
    torch.cuda.synchronize()
    if launched != 1 or not all(same_bits(a, b) for a, b in zip(got, want)) or not all(
            same_bits(a, b) for a, b in zip(got_tables, want_tables)):
        raise AssertionError(f"dequantizing update+sample != plain version ({what}), "
                             f"launches {launched}")
    return abs_err(got[0], want[0])


def folded_sweep(ops, ref, seed: int = 4):
    """The dequantizing update+sample over f32, bf16 and f16 records, pinned
    and device tables, widths that take the 16-, 4- and 1-value paths and an
    offset candidate pointer: duplicate and dropped targets, and a sample of
    a row written in the same launch, in every case."""
    rng = np.random.default_rng(seed)
    n = 0
    for where in ("pinned", "device"):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for r, width, c, s in ((300, 150528, 8, 2), (40, 37, 16, 5), (9, 8, 12, 3),
                                   (7, 64, 1, 4)):
                q = torch.as_tensor(rng.integers(-127, 128, (r, width)), dtype=torch.int8)
                scale = torch.as_tensor(rng.uniform(1e-3, 4.0, (r, 1)), dtype=torch.float32)
                label = torch.as_tensor(rng.integers(0, 1000, (r, 1)), dtype=torch.int32)
                tables = [t.pin_memory() if where == "pinned" else t.cuda()
                          for t in (q, scale, label)]
                big = torch.as_tensor(rng.integers(-127, 128, (c + 1, width)), dtype=torch.int8,
                                      device="cuda")
                cands = [big[1:] if n % 2 else big[:c],
                         torch.as_tensor(rng.uniform(1e-3, 4.0, (c, 1)), dtype=torch.float32,
                                         device="cuda"),
                         torch.as_tensor(rng.integers(0, 1000, (c, 1)), dtype=torch.int32,
                                         device="cuda")]
                rows = rng.integers(-2, r + 2, c)
                rows[0] = rows[-1] = r // 2  # a duplicate target: the last one wins
                samp = rng.integers(-1, r + 1, s)
                samp[0] = r // 2  # a row written in this launch
                check_folded(ops, ref, tables, cands,
                             torch.as_tensor(rows, dtype=torch.int32, device="cuda"),
                             torch.as_tensor(samp, dtype=torch.int32, device="cuda"), dtype,
                             f"{where} [{r}, {width}] {dtype} C={c} S={s}")
                n += 1
    print(f"dequantizing update+sample sweep: {n} cases, one launch each, bit-equal to "
          f"update+sample then dequantize_rows_ref")


def folded_phase(qz, ops, ref, link: tuple) -> dict:
    """The unfused cold pass's launch with dequantize_rows folded in, at the
    unfused tiered step's shapes: the stage's 8 quantized rows (4 written),
    S = 2, the cold record's four leaves (int8 q [4000, 150528], f32 scale,
    i32 label and task) in pinned host memory. Held against its plain
    version on pinned and device tables and over ``folded_sweep``; timed
    against the two launches it replaces (update+sample, then
    dequantize_rows on the gathered rows), in turns. Returns the numbers
    for the dequantize_rows entry of the kernels line."""
    h2d, d2h = link
    width, rows_total = 150528, BUCKETS * COLD
    gen = torch.Generator().manual_seed(5)
    tables = [torch.randint(-127, 128, (rows_total, width), dtype=torch.int8, generator=gen),
              torch.rand((rows_total, 1), generator=gen) * 4 + 1e-3,
              torch.randint(0, 1000, (rows_total, 1), dtype=torch.int32, generator=gen),
              torch.randint(0, BUCKETS, (rows_total, 1), dtype=torch.int32, generator=gen)]
    tables = [t.pin_memory() for t in tables]
    kq, ks = qz.quantize_rows(torch.randn((STAGE, width), device="cuda") * 3)
    cands = [kq, ks, torch.randint(0, 1000, (STAGE, 1), dtype=torch.int32, device="cuda"),
             torch.randint(0, BUCKETS, (STAGE, 1), dtype=torch.int32, device="cuda")]
    # a steady-state flush (4 staged evictions, 4 empty stage rows dropped) and
    # a cold sample of two rows the flush does not write: both cross the link
    flush = torch.tensor([12, rows_total, 2017, rows_total, 1003, rows_total, 3998,
                          rows_total], dtype=torch.int32, device="cuda")
    samp = torch.tensor([17, 1000], dtype=torch.int32, device="cuda")
    written, sampled = 4, samp.shape[0]
    fresh = torch.tensor([2017, 17], dtype=torch.int32, device="cuda")  # one row just written
    err = max(check_folded(ops, ref, tables, cands, flush, rows, torch.float32,
                           f"path shapes, pinned, samples {rows.tolist()}")
              for rows in (samp, fresh))
    device_tables = [t.to("cuda") for t in tables]
    err = max(err, check_folded(ops, ref, device_tables, cands, flush, samp, torch.float32,
                                "path shapes, device tables"))
    print(f"path shapes: cold record q [{rows_total}, {width}] int8 + scale, label, task, "
          f"pinned and on the card; stage [{STAGE}] ({written} written), {sampled} sampled "
          f"(and one just written) -- the dequantizing update+sample bit-equal to "
          f"update+sample then dequantize_rows_ref")
    folded_sweep(ops, ref)

    dequant = {0: (1, torch.float32)}

    def folded():
        ops.rehearsal_update_sample_leaves(tables, cands, flush, samp, dequant)

    def two_launches():
        q, s = ops.rehearsal_update_sample_leaves(tables, cands, flush, samp)[:2]
        qz.dequantize_rows(q, s)

    def plain():
        ref.rehearsal_update_sample_leaves_ref(device_tables, cands, flush, samp, dequant)

    # in turns, folded / two / two / folded, three rounds: the link's rate
    # wanders between readings by more than the launch the fold removes
    readings = {folded: [], two_launches: []}
    for _ in range(3):
        for fn in (folded, two_launches, two_launches, folded):
            readings[fn].append(time_ms(fn))
    ms_folded, ms_two = (statistics.median(readings[fn]) for fn in (folded, two_launches))
    plain_ms = time_ms(plain)
    device_ms = time_ms(lambda: ops.rehearsal_update_sample_leaves(device_tables, cands, flush,
                                                                   samp, dequant))
    row_bytes = width + 4 + 4 + 4  # q, scale, label, task
    write_link, read_link = written * row_bytes, sampled * row_bytes
    hbm = written * row_bytes + sampled * (4 * width + 12) + 4 * (STAGE + sampled)
    parts = {"link writes": write_link / d2h * 1e3, "link reads": read_link / h2d * 1e3,
             "HBM": hbm / HBM_BYTES_PER_S * 1e3}
    bound_ms = max(parts.values())
    print(f"unfused cold pass, one launch with the dequantizing gather: median {ms_folded:.4f} "
          f"ms of {[round(t, 4) for t in readings[folded]]}; the two launches it replaces "
          f"(update+sample, then dequantize_rows of the gathered rows): median {ms_two:.4f} ms "
          f"of {[round(t, 4) for t in readings[two_launches]]}; plain "
          f"{plain_ms:.4f} ms; the same launch on device copies of the tables {device_ms:.4f} "
          f"ms; bound {bound_ms:.5f} ms, the larger of "
          + ", ".join(f"{k} {v:.5f}" for k, v in parts.items())
          + f" (link writes {write_link} B at {d2h / 1e9:.2f} GB/s, reads {read_link} B at "
          f"{h2d / 1e9:.2f} GB/s, HBM {hbm} B)")
    return {"ms_folded": ms_folded, "ms_folded_readings": readings[folded],
            "ms_two_launches": ms_two, "ms_two_launches_readings": readings[two_launches],
            "plain_ms_folded": plain_ms,
            "ms_folded_device_tables": device_ms, "bound_ms_folded": bound_ms,
            "max_abs_err_folded": err, "folded_into": "rehearsal_update_sample"}


# ---------------------------------------------------------------------------
# phase 4: the model on the card against the CPU
# ---------------------------------------------------------------------------


def model_phase(cfg, label: str = "ResNet-50"):
    from repro_torch.models.resnet import apply_cnn, init_cnn

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model_cpu = init_cnn(torch.Generator().manual_seed(7), cfg, "cpu")
        model_gpu = init_cnn(torch.Generator().manual_seed(7), cfg, "cuda")
        x = torch.as_tensor(np.random.default_rng(7).normal(size=(2, 32, 32, 3)),
                            dtype=torch.float32)
        with torch.no_grad():
            want = apply_cnn(model_cpu, x)
            got = apply_cnn(model_gpu, x.cuda()).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    # f32 both sides, different convolution algorithms and reduction orders
    tol = 1e-4 * scale + 1e-5
    print(f"{label} full width, 2 images 32x32, TF32 off: logits {tuple(got.shape)}, "
          f"max |card - cpu| {err:.3e} (tolerance {tol:.3e}, |logit| max {scale:.3f})")
    if got.shape != (2, cfg.num_classes) or not math.isfinite(err) or err > tol:
        raise AssertionError("the model on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


class EvalCachedStream:
    """A stream whose eval sets are drawn once: they are pure functions of
    (seed, task), and the runs of one phase share them instead of drawing
    hundreds of 224x224x3 images on the host for every evaluation."""

    def __init__(self, stream):
        self._stream, self._evals = stream, {}

    def __getattr__(self, name):
        return getattr(self._stream, name)

    def eval_set(self, task: int):
        if task not in self._evals:
            self._evals[task] = self._stream.eval_set(task)
        return self._evals[task]


@functools.lru_cache(maxsize=None)
def class_incremental_stream(cfg, seed: int = 0):
    """The main path's ``ScenarioConfig`` (4 tasks x 250 classes, its cuts)
    and its class-incremental stream (``EVAL_PER_CLASS`` eval images a
    class), built once a (config, seed): the stream is a pure function of
    its config, and the ResNet runs of every phase share it and its eval
    sets (``EvalCachedStream``)."""
    from repro_torch.configs.base import ScenarioConfig
    from repro_torch.data import ClassIncrementalImages, ImageStreamConfig

    sc = ScenarioConfig(num_tasks=4, classes_per_task=250, image_size=cfg.image_size,
                        batch_size=BATCH, epochs_per_task=1,
                        steps_per_epoch=STEPS_PER_TASK, seed=seed)
    return sc, EvalCachedStream(ClassIncrementalImages(ImageStreamConfig(
        num_tasks=sc.num_tasks, classes_per_task=sc.classes_per_task,
        image_size=sc.image_size, noise=sc.noise, eval_per_class=EVAL_PER_CLASS,
        seed=1234 + seed)))


def class_incremental_trainer(cfg, rehearsal, seed: int = 0, obs=None, stream_cfg=None,
                              **kw):
    """``ContinualTrainer`` on ``cfg`` over ``class_incremental_stream`` (of
    ``stream_cfg``, default ``cfg``: a model of the same image size shares
    the stream) with the rehearsal fields ``rehearsal`` (r, c and async mode
    fixed) and the ``ObsConfig`` ``obs`` (default: off); ``kw`` goes to the
    trainer."""
    from repro_torch.configs.base import ObsConfig, RehearsalConfig, RunConfig
    from repro_torch.scenario import ClassIncremental, ContinualTrainer

    sc, stream = class_incremental_stream(stream_cfg or cfg, seed)
    run = RunConfig(model=cfg, scenario=sc, obs=obs or ObsConfig(), rehearsal=RehearsalConfig(
        num_representatives=REPS, num_candidates=CANDS, mode="async", **rehearsal))
    return ContinualTrainer(run, ClassIncremental(sc, stream=stream), device="cuda", **kw)


FLAT = dict(slots_per_bucket=SLOTS, policy="reservoir", tiering="off")


def tiered_rehearsal(fused: bool) -> dict:
    return dict(policy="reservoir", tiering="host", hot_slots=HOT, cold_slots=COLD,
                fused_kernels=fused)


def main_path(counters, cfg, seed: int = 0, step_form: str = "fused", losses_out=None):
    """The flat main path through ``ContinualTrainer(step_form=...)``
    (``fit_flat``). Returns the update+sample launches, the fingerprints and
    the median step in ms; the losses go into ``losses_out`` when given."""
    print(f"cuts (data scale only): tasks run {TASKS_RUN} of 4, "
          f"{STEPS_PER_TASK} steps per task, eval_per_class {EVAL_PER_CLASS}; "
          f"b={BATCH} r={REPS} c={CANDS}, 4 buckets x {SLOTS} slots")
    trainer = class_incremental_trainer(cfg, FLAT, seed, step_form=step_form)
    return fit_flat(counters, trainer, f"flat, step_form={step_form!r}", losses_out)


def fit_flat(counters, trainer, what: str, losses_out=None):
    """``trainer.fit`` over the first ``TASKS_RUN`` tasks, every launch
    counter set to 0 just before and read just after. Checks one
    update+sample launch a step (a flat buffer) and no other kernel, finite
    losses, a growing ``buffer_fill`` and a finite accuracy matrix. Returns
    the update+sample launches, the ``(rep_checksum, buffer_fill)`` history
    and the median step in ms; the losses go into ``losses_out`` when
    given."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit(num_tasks=TASKS_RUN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters["rehearsal_update_sample"].launches
    others = {name: fn.launches for name, fn in counters.items()
              if name != "rehearsal_update_sample"}
    steps = TASKS_RUN * STEPS_PER_TASK
    print(what)

    fills = [h["buffer_fill"] for h in result.history]
    acc = result.accuracy_matrix
    print(f"losses {result.losses}")
    print(f"buffer_fill {fills}")
    print(f"rep_checksum {[h['rep_checksum'] for h in result.history]}")
    print(f"accuracy matrix (top-1) {acc.tolist()}")
    step_ms = statistics.median(result.step_seconds) * 1e3
    wait_share = sum(result.prefetch_wait_seconds) / sum(result.step_seconds)
    print(f"median step {step_ms:.1f} ms (all steps {[round(t * 1e3, 1) for t in result.step_seconds]}), "
          f"prefetch wait {wait_share:.4f} of step time, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, fit wall {wall:.1f} s")
    print(f"kernel launches on the main path: {launches} (one for the "
          f"{len(trainer.item_spec)} leaves x {steps} steps)")
    if launches != steps:
        raise AssertionError(f"expected {steps} kernel launches, saw {launches}")
    if any(others.values()):
        raise AssertionError(f"the flat path launched other kernels: {others}")
    if len(result.losses) != steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite or missing losses: {result.losses}")
    if not fills[-1] > fills[0]:
        raise AssertionError(f"buffer_fill did not grow: {fills}")
    if acc.shape != (TASKS_RUN, TASKS_RUN) or not np.isfinite(acc).all():
        raise AssertionError(f"bad accuracy matrix {acc}")
    prints = [(h["rep_checksum"], h["buffer_fill"]) for h in result.history]
    if losses_out is not None:
        losses_out.extend(result.losses)
    return launches, prints, step_ms


# ---------------------------------------------------------------------------
# phase 6: the tiered store at full row width, card against CPU
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _state_leaves(st):
    for part in ("hot", "cold"):
        buf = getattr(st, part)
        yield from _leaves({f"{part}.data": buf.data, f"{part}.counts": buf.counts,
                            f"{part}.seen": buf.seen})
    yield from _leaves({"stage": st.stage, "stage_labels": st.stage_labels,
                        "stage_valid": st.stage_valid})


def _on_cpu(rows):
    """Row vectors (nested named tuples, a policy's aux dict, None),
    copied to the CPU."""
    if isinstance(rows, torch.Tensor):
        return rows.cpu()
    if isinstance(rows, dict):
        return {k: _on_cpu(v) for k, v in rows.items()}
    if isinstance(rows, tuple) and hasattr(rows, "_fields"):
        return type(rows)(*(_on_cpu(x) for x in rows))
    return rows


def tiered_phase(cfg, steps: int = 6, seed: int = 3):
    """Drive ``tiered_update_sample`` directly: the unfused and fused kernels
    on the card and the plain versions on the CPU, fed the same planned rows
    and batches, must agree on every leaf and every sample bit for bit."""
    from repro_torch.buffer.state import ItemSpec
    from repro_torch.buffer.tiered import init_tiered, plan_tiered, tiered_update_sample

    spec = {"images": ItemSpec((cfg.image_size, cfg.image_size, cfg.channels), torch.float32),
            "label": ItemSpec((), torch.int32), "task": ItemSpec((), torch.int32)}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    states = {fused: init_tiered(spec, BUCKETS, HOT, COLD, STAGE, device="cuda")
              for fused in (False, True)}
    grew = torch.cuda.memory_allocated() - before
    cold_bytes = sum(leaf.numel() * leaf.element_size()
                     for _, leaf in _leaves(states[False].cold.data))
    pinned = all(leaf.device.type == "cpu" and leaf.is_pinned()
                 for st in states.values() for _, leaf in _leaves(st.cold.data))
    print(f"two tiered stores on the card: device memory grew {grew} B; each cold tier "
          f"{cold_bytes} B in pinned host memory ({pinned}), hot tier "
          f"{BUCKETS}x{HOT} + stage {STAGE} rows on the card")
    if not pinned or grew >= cold_bytes:
        raise AssertionError("the cold tier is not (only) in pinned host memory")
    plain = init_tiered(spec, BUCKETS, HOT, COLD, STAGE, device="cpu")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    for step in range(steps):
        batch = {"images": torch.randn((BATCH,) + spec["images"].shape, device="cuda"),
                 "label": torch.as_tensor(rng.integers(0, 1000, BATCH), dtype=torch.int32,
                                          device="cuda"),
                 "task": torch.as_tensor(rng.integers(0, BUCKETS, BATCH), dtype=torch.int32,
                                         device="cuda")}
        # every candidate accepted, so the hot tier overflows and demotes early
        rows = plan_tiered(states[False], batch["task"], gen, BATCH, REPS)
        outs = {}
        for fused in (False, True):
            states[fused], reps, valid = tiered_update_sample(states[fused], batch, rows,
                                                              fused=fused)
            outs[fused] = (reps, valid)
        plain, reps, valid = tiered_update_sample(
            plain, {k: v.cpu() for k, v in batch.items()}, _on_cpu(rows))
        outs["plain"] = (reps, valid)
        for what in (True, "plain"):
            if not same_bits(outs[what][1], outs[False][1]) or not all(
                    same_bits(outs[what][0][k], outs[False][0][k]) for k in spec):
                raise AssertionError(f"step {step}: samples differ ({what} vs unfused)")
    torch.cuda.synchronize()
    ref_leaves = dict(_state_leaves(plain))
    for name, st in (("unfused", states[False]), ("fused", states[True])):
        for leaf_name, leaf in _state_leaves(st):
            if not same_bits(leaf, ref_leaves[leaf_name]):
                raise AssertionError(f"{name} tiered state leaf {leaf_name} differs from "
                                     f"the plain versions on the CPU")
    cold_fill = int(states[True].cold.counts.sum())
    print(f"{steps} tiered steps at full row width: unfused and fused kernels == plain "
          f"versions on the CPU on every leaf and sample, bit for bit; cold fill "
          f"{cold_fill}, hot fill {int(states[True].hot.counts.sum())}")
    if cold_fill == 0:
        raise AssertionError("nothing was demoted into the cold tier")


# ---------------------------------------------------------------------------
# phase 7: the tiered main path
# ---------------------------------------------------------------------------


def tiered_main_path(counters, cfg, fused: bool, seed: int = 0, step_form: str = "fused"):
    """The trainer of phase 5 on the tiered store. Returns the launches of
    each kernel, the fingerprints and the median step in ms."""
    trainer = class_incremental_trainer(cfg, tiered_rehearsal(fused), seed,
                                        step_form=step_form)
    rcfg = trainer.rcfg
    print(f"tiered, fused_kernels={fused}, step_form={step_form!r}: {rcfg.num_buckets} buckets"
          f" x {rcfg.resolved_hot_slots} hot + {rcfg.resolved_cold_slots} cold slots, stage "
          f"{rcfg.resolved_demote_stage}")
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    result = trainer.fit(num_tasks=TASKS_RUN)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = TASKS_RUN * STEPS_PER_TASK
    fills = [h["buffer_fill"] for h in result.history]
    prints = [(h["rep_checksum"], h["buffer_fill"]) for h in result.history]
    step_ms = statistics.median(result.step_seconds) * 1e3
    print(f"losses {result.losses}")
    print(f"buffer_fill {fills}")
    print(f"rep_checksum {[h['rep_checksum'] for h in result.history]}")
    print(f"median step {step_ms:.1f} ms (all steps "
          f"{[round(t * 1e3, 1) for t in result.step_seconds]}), launches {launches}")
    # unfused: quantize_rows on the stage; the cold sample is dequantized by
    # the update+sample launch that gathers it, so dequantize_rows is never
    # launched
    float_kernels = (("encode_scatter_rows", "gather_dequant_rows") if fused
                     else ("quantize_rows",))
    # per step: the cold leaves' flush+sample (fused: one launch for the raw
    # leaves, label and task; unfused: one launch for the int8 q and scale
    # leaves and the raw leaves together, dequantizing the sampled q rows),
    # the evicted gather (one launch for the 3 record leaves) and the hot
    # push+sample (one launch)
    update_sample = 1 + 1 + 1
    want = {name: (steps if name in float_kernels else 0) for name in counters}
    want["rehearsal_update_sample"] = update_sample * steps
    if launches != want:
        raise AssertionError(f"expected launches {want}, saw {launches}")
    if len(result.losses) != steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite or missing losses: {result.losses}")
    if not fills[-1] > BUCKETS * HOT:
        raise AssertionError(f"buffer_fill {fills[-1]} never outgrew the hot tier's "
                             f"{BUCKETS * HOT} slots, so the cold tier holds nothing")
    return launches, prints, step_ms


# ---------------------------------------------------------------------------
# phase 13: the split pipelined step, the issue half on its own stream
# ---------------------------------------------------------------------------


def split_phase(counters, cfg, fused_runs: dict):
    """``ContinualTrainer(step_form='split')`` on the configurations of phases
    5 and 7 (flat, and tiered unfused): the histories of ``rep_checksum``
    and ``buffer_fill`` must equal the fused runs' (``fused_runs``, from
    phases 5 and 7 when they ran, else run here), with the same launch
    counts, and the two forms' median steps. The profiles of both forms
    (``repro_torch.profile_main_path --split``) run apart from the script,
    for time; the ``cuda`` tests hold the split halves' streams."""
    def run(tiered: bool, step_form: str):
        if tiered:
            return tiered_main_path(counters, cfg, False, step_form=step_form)
        return main_path(counters, cfg, step_form=step_form)

    steps_ms = {}
    for name, tiered in (("flat", False), ("tiered, unfused", True)):
        fused = fused_runs.get(name) or run(tiered, "fused")
        split = run(tiered, "split")
        if split[1] != fused[1]:
            raise AssertionError(f"{name}: split and fused histories of (rep_checksum, "
                                 f"buffer_fill) differ: {split[1]} vs {fused[1]}")
        if split[0] != fused[0]:
            raise AssertionError(f"{name}: split launches {split[0]} != fused {fused[0]}")
        steps_ms[name] = (fused[2], split[2])
        print(f"{name}: split == fused fingerprints over {len(split[1])} steps, launches "
              f"{split[0]}; median step fused {fused[2]:.1f} ms, split {split[2]:.1f} ms")
    return steps_ms


# ---------------------------------------------------------------------------
# phase 14: strategies and policies on the main path
# ---------------------------------------------------------------------------


def strategy_main_path(counters, cfg, strategy: str, *, policy: str = "reservoir",
                       top_k: int = 0, tiered: bool = False, fused: bool = False,
                       tasks: int = TASKS_RUN, seed: int = 0):
    """``ContinualTrainer`` on the configuration of phase 5 (``tiered``: of
    phase 7) with another strategy or policy. Every counter is set to 0 just
    before ``fit`` and read just after. Checks that every update+sample went
    through the kernel (one launch a flat step for the whole record, three a
    tiered step), that the unfused tiered store quantizes each float leaf
    once a step, that der's distillation term is finite and positive once
    replay rows are valid, and that the policy's aux stays on the card.
    Returns the launches, the fingerprints and the median step in ms."""
    from repro_torch.configs.base import RehearsalConfig, RunConfig, StrategyConfig
    from repro_torch.scenario import ClassIncremental, ContinualTrainer

    sc, stream = class_incremental_stream(cfg, seed)
    sc = dataclasses.replace(sc, strategy=strategy)
    store = (dict(tiering="host", hot_slots=HOT, cold_slots=COLD, fused_kernels=fused)
             if tiered else dict(slots_per_bucket=SLOTS, tiering="off"))
    run = RunConfig(model=cfg, scenario=sc, strategy=StrategyConfig(top_k=top_k),
                    rehearsal=RehearsalConfig(num_representatives=REPS, num_candidates=CANDS,
                                              mode="async", policy=policy, **store))
    trainer = ContinualTrainer(run, ClassIncremental(sc, stream=stream), device="cuda")
    if trainer.rcfg.policy != policy:
        raise AssertionError(f"the trainer runs policy {trainer.rcfg.policy!r}, not {policy!r}")
    fields = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
              for k, v in trainer.item_spec.items()}
    name = (f"{strategy}, policy {policy}" + (f", top_k {top_k}" if top_k else "")
            + (f", tiered {'fused' if fused else 'unfused'}" if tiered else ", flat"))
    print(f"{name}: record {fields}")
    step, per_step = trainer._step_fn, []

    def watched(carry, batch, key, rows=None):
        carry, m = step(carry, batch, key, rows)
        aux = (carry.buffer.hot if tiered else carry.buffer).aux
        on_card = aux == () or all(v.device.type == "cuda" for v in aux.values())
        per_step.append((m.get("distill"), on_card))
        return carry, m

    trainer._step_fn = watched
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    result = trainer.fit(num_tasks=tasks)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    steps = tasks * STEPS_PER_TASK
    fills = [h["buffer_fill"] for h in result.history]
    prints = [(h["rep_checksum"], h["buffer_fill"]) for h in result.history]
    step_ms = statistics.median(result.step_seconds) * 1e3
    distill = [float(d) for d, _ in per_step if d is not None]
    print(f"losses {result.losses}")
    print(f"buffer_fill {fills}; rep_checksum {[h['rep_checksum'] for h in result.history]}")
    if distill:
        print(f"distill {distill}")
    print(f"median step {step_ms:.1f} ms (all steps "
          f"{[round(t * 1e3, 1) for t in result.step_seconds]}), launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    floats = [k for k, v in trainer.item_spec.items() if v.dtype.is_floating_point]
    want = {k: 0 for k in counters}
    want["rehearsal_update_sample"] = (3 if tiered else 1) * steps
    if tiered:
        for kernel in (("encode_scatter_rows", "gather_dequant_rows") if fused
                       else ("quantize_rows",)):
            want[kernel] = len(floats) * steps
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want}, saw {launches}")
    if len(result.losses) != steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"{name}: non-finite or missing losses {result.losses}")
    if not all(on_card for _, on_card in per_step):
        raise AssertionError(f"{name}: the policy's aux left the card")
    if strategy.startswith("der"):
        # the pending slot of step 0 is empty; from step 2 on it holds valid
        # rows sampled from a buffer that step 0 filled
        if len(distill) != steps or not all(math.isfinite(d) for d in distill) or not all(
                d > 0 for d in distill[2:]):
            raise AssertionError(f"{name}: distill {distill}")
    # class_balanced accepts ever fewer candidates of a filling bucket, so
    # within one task the fill may stand still for a few steps; a second
    # task opens an empty bucket
    if not (fills[0] > 0 and fills == sorted(fills) and (tasks < 2 or fills[-1] > fills[0])):
        raise AssertionError(f"{name}: buffer_fill {fills}")
    return launches, prints, step_ms


def der_card_against_cpu(cfg, steps: int = 2, seed: int = 7):
    """der_pp steps of ``make_cl_step`` at phase 4's small input (4 images
    32x32 at full width, 1000 classes), the card against the CPU from the
    same weights, fed the same rows (planned on the CPU, through the
    ``rows`` seam), TF32 off: the image, label and task leaves of the buffer
    bit for bit, the stored logits and the loss within 1e-4 of their
    largest value (f32 both sides, other convolution algorithms)."""
    from repro_torch.buffer.state import ItemSpec, plan_update_sample
    from repro_torch.configs.base import RehearsalConfig, StrategyConfig, TrainConfig
    from repro_torch.models import apply_cnn, cnn_outputs, cross_entropy, init_cnn
    from repro_torch.optim import make_optimizer
    from repro_torch.strategy import init_carry, make_cl_step

    rcfg = RehearsalConfig(num_buckets=BUCKETS, slots_per_bucket=8, num_representatives=REPS,
                           num_candidates=4, mode="async", label_field="label")
    spec = {"images": ItemSpec((32, 32, 3), torch.float32), "label": ItemSpec((), torch.int32),
            "task": ItemSpec((), torch.int32),
            "logits": ItemSpec((cfg.num_classes,), torch.float32)}
    init, update = make_optimizer(TrainConfig(peak_lr=0.05, warmup_steps=1))

    def loss_fn(model, batch):
        return cross_entropy(apply_cnn(model, batch["images"])[:, None, :],
                             batch["label"][:, None]), {}

    def forward_outputs(model, batch):
        return cnn_outputs(model, batch["images"])

    devices = {"cpu": "cpu", "card": "cuda"}
    carries, step_fns = {}, {}
    for key, dev in devices.items():
        model = init_cnn(torch.Generator().manual_seed(seed), cfg, dev)
        carries[key] = init_carry(model, init(dict(model.named_parameters())), spec, rcfg,
                                  label_field="label", seed=3, device=dev)
        step_fns[key] = make_cl_step(loss_fn, update, rcfg, strategy="der_pp",
                                     exchange="local", label_field="label",
                                     strategy_cfg=StrategyConfig(alpha=0.5, beta=0.5),
                                     forward_outputs=forward_outputs,
                                     aux_spec={"logits": spec["logits"]}, device=dev)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(steps):
            batch = {"images": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                     "label": rng.integers(0, cfg.num_classes, 4).astype(np.int32),
                     "task": rng.integers(0, BUCKETS, 4).astype(np.int32)}
            rows = plan_update_sample(carries["cpu"].buffer, torch.from_numpy(batch["task"]),
                                      gen, 4, REPS)
            metrics = {}
            for key, dev in devices.items():
                dev_rows = type(rows)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                                        for x in rows))
                carries[key], metrics[key] = step_fns[key](carries[key], batch, s,
                                                           rows=dev_rows)
            got, want = carries["card"].buffer.data, carries["cpu"].buffer.data
            for name in ("images", "label", "task"):
                if not same_bits(got[name], want[name]):
                    raise AssertionError(f"der_pp step {s}: buffer leaf {name} differs")
            scale = float(want["logits"].abs().max())
            err = abs_err(got["logits"].cpu(), want["logits"])
            loss_err = abs(float(metrics["card"]["loss"]) - float(metrics["cpu"]["loss"]))
            loss_tol = 1e-4 * abs(float(metrics["cpu"]["loss"]))
            print(f"der_pp step {s}, card against CPU (TF32 off, same rows): images/label/"
                  f"task leaves bit-equal; logits leaf max |card - cpu| {err:.3e} (tolerance "
                  f"{1e-4 * scale:.3e}); loss {float(metrics['card']['loss']):.6f} vs "
                  f"{float(metrics['cpu']['loss']):.6f} (tolerance {loss_tol:.3e}); distill "
                  f"{float(metrics['card']['distill']):.4e} vs "
                  f"{float(metrics['cpu']['distill']):.4e}")
            if not (scale > 0 and err <= 1e-4 * scale and loss_err <= loss_tol):
                raise AssertionError(f"der_pp step {s}: the card disagrees with the CPU")
        if not float(metrics["cpu"]["distill"]) > 0:
            raise AssertionError("the der_pp check never distilled")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def strategy_phase(counters, cfg, fused_runs: dict):
    """Phase 14: der_pp flat, der top-8 on the tiered store (unfused, then
    fused: identical fingerprints), grasp_embed with the grasp policy, and
    the rehearsal strategy under fifo and under class_balanced (1 task), each
    run's median step beside phase 5's flat rehearsal step from this
    process; then one der_pp check of the card against the CPU."""
    base = fused_runs.get("flat") or main_path(counters, cfg)
    runs = {}
    runs["der_pp, flat"] = strategy_main_path(counters, cfg, "der_pp")
    tiered = {f: strategy_main_path(counters, cfg, "der", top_k=8, tiered=True, fused=f)
              for f in (False, True)}
    runs["der top-8, tiered unfused"] = tiered[False]
    runs["der top-8, tiered fused"] = tiered[True]
    if tiered[False][1] != tiered[True][1]:
        raise AssertionError(f"der tiered: fused and unfused fingerprints differ: "
                             f"{tiered[False][1]} vs {tiered[True][1]}")
    runs["grasp_embed + grasp, flat"] = strategy_main_path(counters, cfg, "grasp_embed",
                                                           policy="grasp")
    for policy in ("fifo", "class_balanced"):
        runs[f"rehearsal + {policy}, flat, 1 task"] = strategy_main_path(
            counters, cfg, "rehearsal", policy=policy, tasks=1)
    print(f"der tiered: fused == unfused fingerprints over {len(tiered[True][1])} steps")
    for name, (launches, _, step_ms) in runs.items():
        print(f"phase 14 {name}: median step {step_ms:.1f} ms (phase 5 flat rehearsal "
              f"{base[2]:.1f} ms), launches {({k: v for k, v in launches.items() if v})}")
    der_card_against_cpu(cfg)
    return runs


# ---------------------------------------------------------------------------
# phases 8-12: the language-model inference path
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 17: the domain-incremental and blurry-boundary scenarios
# ---------------------------------------------------------------------------


def vision_scenario_path(counters, cfg, name: str, seed: int = 0):
    """``ContinualTrainer(run, name)`` on ``resnet50_cl.full()`` with phase
    5's cuts (``fit_flat``), the scenario's own rehearsal defaults
    (``auto_defaults``) and a buffer of 2000 records: domain_incremental
    (4 domains over 1000 shared classes, class_balanced, 4 buckets x 500
    slots), blurry_boundary (4 tasks x 250 classes, blur 0.25, reservoir, one
    bucket per class: 1000 x 2 slots). The blurry stream holds
    ``EVAL_PER_CLASS`` eval images a class; the domain stream's eval set
    covers every class at one image a class (1000 a domain)."""
    from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig
    from repro_torch.data import (BlurryBoundaryImages, BlurryStreamConfig,
                                  DomainIncrementalImages, DomainStreamConfig)
    from repro_torch.scenario import BlurryBoundary, ContinualTrainer, DomainIncremental

    sc = ScenarioConfig(name=name, num_tasks=4, classes_per_task=250, num_classes=1000,
                        image_size=cfg.image_size, batch_size=BATCH, epochs_per_task=1,
                        steps_per_epoch=STEPS_PER_TASK, seed=seed, blur=0.25)
    if name == "domain_incremental":
        slots = SLOTS
        scenario = DomainIncremental(sc, stream=DomainIncrementalImages(DomainStreamConfig(
            num_tasks=sc.num_tasks, num_classes=sc.num_classes, image_size=sc.image_size,
            noise=sc.noise, domain_shift=sc.domain_shift, eval_per_class=1,
            seed=1234 + seed)))
    else:
        slots = 2000 // (sc.num_tasks * sc.classes_per_task)
        scenario = BlurryBoundary(sc, stream=BlurryBoundaryImages(BlurryStreamConfig(
            num_tasks=sc.num_tasks, classes_per_task=sc.classes_per_task,
            image_size=sc.image_size, noise=sc.noise, eval_per_class=EVAL_PER_CLASS,
            task_len=sc.steps_per_task, blur=sc.blur, seed=1234 + seed)))
    run = RunConfig(model=cfg, scenario=sc, rehearsal=RehearsalConfig(
        slots_per_bucket=slots, num_representatives=REPS, num_candidates=CANDS, mode="async"))
    trainer = ContinualTrainer(run, scenario, device="cuda")
    rc = trainer.rcfg
    print(f"{name}: record {({k: tuple(v.shape) for k, v in trainer.item_spec.items()})}, "
          f"bucket field {scenario.buffer_task_field!r}, policy {rc.policy}, "
          f"{rc.num_buckets} buckets x {rc.slots_per_bucket} slots; tasks run {TASKS_RUN} of "
          f"{sc.num_tasks}, {STEPS_PER_TASK} steps per task, b={BATCH} r={REPS} c={CANDS}")
    want = (("class_balanced", 4, SLOTS) if name == "domain_incremental"
            else ("reservoir", 1000, 2))
    if (rc.policy, rc.num_buckets, rc.slots_per_bucket) != want:
        raise AssertionError(f"{name}: rehearsal {rc} is not {want}")
    out = fit_flat(counters, trainer, name)
    del trainer
    torch.cuda.empty_cache()
    return out


def vision_scenario_phase(counters, cfg, fused_runs: dict):
    """Phase 17: both scenarios on the main path, each median step beside
    phase 5's (run here when phase 5 did not run)."""
    base = fused_runs.get("flat") or main_path(counters, cfg)
    for name in ("domain_incremental", "blurry_boundary"):
        launches, _, step_ms = vision_scenario_path(counters, cfg, name)
        print(f"{name}: median step {step_ms:.1f} ms beside phase 5's {base[2]:.1f} ms "
              f"(class_incremental, reservoir, 4 x 500); update+sample launches {launches}")


def tf32_off():
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32 off: torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def close(got, want, atol, rtol, what):
    """Assert |got - want| <= atol + rtol |want| everywhere; return max |err|.
    An element that is NaN on either side fails (``<=`` is false for it)."""
    worst, bad = [], False
    for g, w in _chunks(got, want):
        err = (g - w).abs()
        worst.append(err.max())
        bad = bad or not bool((err <= atol + rtol * w.abs()).all())
    worst = float(torch.stack(worst).max()) if worst else 0.0
    if bad or not math.isfinite(worst):
        raise AssertionError(f"{what}: max abs err {worst:.3e} beyond atol {atol} rtol {rtol}")
    return worst


def comparisons_catch_nan():
    """``close`` raises and ``abs_err`` gives NaN for a NaN in any chunk, the
    last included."""
    want = torch.zeros(CHUNK + 3, device="cuda")
    got = want.clone()
    got[-1] = float("nan")
    if not math.isnan(abs_err(got, want)):
        raise AssertionError("abs_err dropped a NaN")
    try:
        close(got, want, 1.0, 1.0, "NaN self-check")
    except AssertionError:
        print(f"close() and abs_err() catch a NaN in the last of 2 chunks of {CHUNK} elements")
        return
    raise AssertionError("close() passed a NaN")


def _randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dtype).to("cuda")


# (atol, rtol) of the flash kernel against its plain version. f32 as
# tests/test_kernels.py:34. bf16: rtol 2**-7 is one bf16 ulp of the output;
# the tensor-core kernel also rounds P to bf16 before P.V, as SDPA does, where
# the plain version keeps it f32. That rounding (2**-9 of each p) shows most
# where a few large terms p.v cancel to a small output: the least atol that
# passes at rtol 2**-7 read 3.03e-3 at SmolLM-135M's prefill shapes and at
# most 2.84e-3 over the sweep below (NVIDIA H100 80GB HBM3), so atol is 4e-3.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 2 ** -7)}


def small_outputs(got, want, rtol):
    """The flash error where outputs are small, which the absolute tolerance
    alone bounds: the largest error over |want| < 0.1, and the least atol
    that would pass with this rtol."""
    err = (got.double() - want.double()).abs()
    small = want.double().abs() < 0.1
    worst_small = float(err[small].max()) if bool(small.any()) else 0.0
    need = float((err - rtol * want.double().abs()).max())
    return f"over |want| < 0.1: max abs err {worst_small:.3e}; least atol at rtol {rtol:g}: {need:.3e}"


# The shapes phase 8 holds and times: each model's prefill (B 4, S = T =
# 2048) at its head dim, and the suffix of its numbers in the kernels line.
FLASH_TIMED = (("SmolLM-135M", 9, 3, 64, ""), ("Gemma-2B", 8, 1, 256, "_hd256"))
FLASH_DESIGN = {("", torch.float32): "3xTF32 wgmma", ("", torch.bfloat16): "wgmma + TMA",
                ("_hd256", torch.float32): "3xTF32 wgmma, 16-key tiles split in registers, "
                                           "two CTAs a query tile (128 output dims each)",
                ("_hd256", torch.bfloat16): "wgmma + TMA, m64n256k16 P.V, 2 stages, a "
                                            "producer warpgroup with setmaxnreg"}


def flash_phase(fa, ref):
    """Flash attention against its plain version; times at SmolLM-135M's
    (hd 64) and Gemma-2B's (hd 256) prefill shapes. Returns its kernels-line
    entry."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(8)
    b, s = PREFILL_B, PREFILL_S
    runs, errs = {}, {}
    for model, h, kv, hd, tag in FLASH_TIMED:
        for dtype in (torch.float32, torch.bfloat16):
            q = _randn((b, s, h, hd), gen, dtype)
            k, v = _randn((b, s, kv, hd), gen, dtype), _randn((b, s, kv, hd), gen, dtype)
            got = fa.flash_attention(q, k, v)
            want = ref.flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            errs[tag, dtype] = close(got.float(), want.float(), *FLASH_TOL[dtype],
                                     f"flash {model} {dtype}")
            runs[tag, dtype] = (q, k, v)
            print(f"{model} prefill shapes q [{b}, {s}, {h}, {hd}], k/v [{b}, {s}, {kv}, {hd}] "
                  f"{dtype}: max abs err {errs[tag, dtype]:.3e} (atol, rtol "
                  f"{FLASH_TOL[dtype]}); {small_outputs(got, want, FLASH_TOL[dtype][1])}")
            del got, want
    # the JAX kernel tests' cases (test_kernels.py:17-24, 39-45), H2O-Danube
    # (hd 80, window 4096, S 8192) in both dtypes, and the bf16 kernel's edges:
    # hd 32 at S 64 (less than one 128-query tile), a window without causal
    # where rows see no key (64 queries, 32 keys, window 8); at Gemma-2B's hd
    # 256 and MQA, a window, S 64 (less than one tile of either kernel) and
    # a ragged S without causal, in both dtypes
    sweep = [(1, 64, 64, 2, 2, 32, 0, True, torch.float32),
             (2, 128, 128, 4, 2, 32, 0, True, torch.float32),
             (1, 128, 128, 8, 1, 64, 0, True, torch.float32),
             (2, 128, 128, 6, 3, 64, 64, True, torch.float32),
             (1, 256, 256, 4, 4, 128, 128, True, torch.float32),
             (2, 64, 64, 4, 2, 32, 0, True, torch.bfloat16),
             (1, 128, 128, 2, 2, 32, 0, True, torch.float32),
             (1, 8192, 8192, 32, 8, 80, 4096, True, torch.float32),
             (1, 8192, 8192, 32, 8, 80, 4096, True, torch.bfloat16),
             (1, 64, 32, 4, 2, 32, 8, False, torch.bfloat16),
             (2, 256, 256, 4, 2, 128, 0, True, torch.bfloat16)]
    for dtype in (torch.float32, torch.bfloat16):
        sweep += [(1, 2048, 2048, 8, 1, 256, 300, True, dtype),
                  (2, 64, 64, 8, 1, 256, 0, True, dtype),
                  (1, 100, 100, 4, 2, 256, 0, False, dtype)]
    for cb, cs, ct, ch, ckv, chd, win, causal, dtype in sweep:
        q = _randn((cb, cs, ch, chd), gen, dtype)
        k, v = _randn((cb, ct, ckv, chd), gen, dtype), _randn((cb, ct, ckv, chd), gen, dtype)
        got = fa.flash_attention(q, k, v, window=win, causal=causal)
        want = ref.flash_attention_ref(q, k, v, window=win, causal=causal)
        torch.cuda.synchronize()
        case = (cb, cs, ct, ch, ckv, chd, win, causal, dtype)
        err = close(got.float(), want.float(), *FLASH_TOL[dtype], f"flash sweep {case}")
        if dtype == torch.bfloat16 or chd == 256:
            print(f"  {case}: max abs err {err:.3e}; {small_outputs(got, want, FLASH_TOL[dtype][1])}")
        del q, k, v, got, want
    print(f"sweep: {len(sweep)} cases within tolerance (incl. H2O-Danube: H 32, KV 8, hd 80, "
          f"window 4096, S 8192, f32 and bf16; hd 256: window 300 at S 2048, S 64, S 100 "
          f"without causal, f32 and bf16)")

    entry = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
             "source_bf16": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention.py:73"}
    for (tag, dtype), (q, k, v) in runs.items():
        b, s, h, hd = q.shape
        suffix = tag + ("" if dtype == torch.float32 else "_bf16")
        design = FLASH_DESIGN[tag, dtype]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [B, H, S, hd] views

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        lib = library().transpose(1, 2)
        want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        lib_tol = 2e-2 if dtype == torch.bfloat16 else 2e-5  # SDPA rounds P to bf16
        lib_err = close(lib.float(), want.float(), lib_tol, lib_tol, f"SDPA hd {hd} {dtype}")
        print(f"SDPA hd {hd} {dtype} against the plain version: max abs err {lib_err:.3e}; "
              f"{small_outputs(lib, want, FLASH_TOL[dtype][1])}")
        del lib, want
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=10)
        library_ms = time_ms(library)
        ms_again = time_ms(lambda: fa.flash_attention(q, k, v))
        flops = 2 * b * h * s * s * hd  # the causal half of QK^T and PV
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v)) + q.numel() * q.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if dtype == torch.float32:
            # 3xTF32: three TF32 products per f32 product on the tensor cores;
            # the f32 function's own rate (FMA pipes) is printed beside it
            ops_ms = 3 * flops / TF32_FLOPS * 1e3
            fma_ms = flops / F32_FLOPS * 1e3
            rate = (f"3 x {flops / 1e9:.2f} GFLOP at {TF32_FLOPS / 1e12:g} TFLOP/s TF32 = "
                    f"{ops_ms:.4f} ms; FMA bound {fma_ms:.4f} ms at {F32_FLOPS / 1e12:g} "
                    f"TFLOP/s f32")
        else:
            ops_ms = flops / BF16_FLOPS * 1e3
            rate = f"{flops / 1e9:.2f} GFLOP at {BF16_FLOPS / 1e12:g} TFLOP/s = {ops_ms:.4f} ms"
        bound_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        print(f"flash_attention hd {hd} {dtype} ({design}): kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms; max abs err "
              f"vs plain: kernel {errs[tag, dtype]:.3e}, SDPA {lib_err:.3e}; bound "
              f"{bound_ms:.4f} ms by {by} ({rate}; {nbytes} B = {bytes_ms:.4f} ms); kernel at "
              f"{flops / ms / 1e9:.2f} TFLOP/s of f32 products, {bound_ms / ms:.3f} of its bound")
        entry.update({f"design{suffix}": design, f"max_abs_err{suffix}": errs[tag, dtype],
                      f"ms{suffix}": ms, f"ms_repeat{suffix}": ms_again,
                      f"plain_ms{suffix}": plain_ms, f"bound_ms{suffix}": bound_ms,
                      f"bound_by{suffix}": by, f"library_ms{suffix}": library_ms})
        if dtype == torch.float32:
            entry[f"bound_ms_fma{tag}"] = max(fma_ms, bytes_ms)
    del runs
    return entry


def ssd_plain(ref, x, dt, a_head, bmat, cmat, chunk):
    """The SSD wrapper's steps with the plain chunked scan, on the card."""
    b, s, h, p = x.shape
    n, q = bmat.shape[-1], min(chunk, s)
    nc = s // q
    cum = torch.cumsum((dt.float() * a_head.float()).reshape(b, nc, q, h), dim=2)
    y = ref.ssd_scan_chunked_ref(x.reshape(b, nc, q, h, p), dt.float().reshape(b, nc, q, h),
                                 cum, bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n))
    return y.reshape(b, s, h, p)


def _ssd_inputs(gen, b, s, h, p, n, dtype=torch.float32):
    x = _randn((b, s, h, p), gen, dtype, 0.5)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen)).cuda()
    a = -torch.exp(torch.randn((h,), generator=gen) * 0.3).cuda()
    return x, dt, a, _randn((b, s, n), gen, dtype, 0.5), _randn((b, s, n), gen, dtype, 0.5)


def ssd_stages(ssd, ref, x, dt, a_head, bmat, cmat, q):
    """Each CUDA stage of the scan against its plain stage on the same inputs
    (kernel layout); returns the largest error."""
    b, s, h, p = x.shape
    n, nc = bmat.shape[-1], s // q
    xk, dtk = x.reshape(b, nc, q, h, p), dt.float().reshape(b, nc, q, h)
    bk, ck = bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n)
    before = ssd.ssd_scan.launches
    states, cum = ssd.chunk_states(xk, dtk, a_head, bk)
    want_states, want_cum = ref.ssd_chunk_states_ref(xk, dtk, a_head, bk)
    want_in, _ = ref.ssd_pass_states_ref(states, cum)
    state_in = ssd.pass_states(states.clone(), cum)
    y = ssd.chunk_output(xk, dtk, cum, bk, ck, state_in)
    want_y = ref.ssd_chunk_output_ref(xk, dtk, cum, bk, ck, state_in)
    torch.cuda.synchronize()
    if ssd.ssd_scan.launches != before + ssd.KERNELS_PER_CALL:
        raise AssertionError("the scan's stages did not launch one kernel each")
    # the state sums run over up to 128 steps in another order: the scan's
    # own tolerance (tests/test_kernels.py:71) holds for each stage. The
    # states are f32 from the same inputs in either dtype; only bf16 y is
    # rounded to bf16, on both sides
    tol = (5e-4, 1e-3)
    tol_y = tol if x.dtype == torch.float32 else (2e-2, 2e-2)
    close(cum, want_cum, 1e-5, 1e-5, f"ssd chunk_states' cum vs plain {x.dtype}")
    if x.dtype == torch.bfloat16 and not same_bits(cum, want_cum):
        print(f"  note: the bf16 chain's cum differs from torch.cumsum's by up to "
              f"{abs_err(cum, want_cum):.3e}")
    return max(close(states, want_states, *tol, f"ssd chunk_states vs plain {x.dtype}"),
               close(state_in, want_in, *tol, f"ssd pass_states vs plain {x.dtype}"),
               close(y.float(), want_y.float(), *tol_y, f"ssd chunk_output vs plain {x.dtype}"))


def ssd_stage_times(ssd, x, dt, a_head, bmat, cmat, q):
    """Device ms of each kernel of one ``ssd_scan`` call on these inputs, each
    timed alone with what its wrapper launches besides (f32: ``chunk_states``
    computes cum in torch, ``dt * A`` and a cumsum, before its kernel)."""
    b, s, h, p = x.shape
    n, nc = bmat.shape[-1], s // q
    xk, dtk = x.reshape(b, nc, q, h, p), dt.float().reshape(b, nc, q, h)
    bk, ck = bmat.reshape(b, nc, q, n), cmat.reshape(b, nc, q, n)
    states, cum = ssd.chunk_states(xk, dtk, a_head, bk)
    scratch = states.clone()  # pass_states works in place: time it on a copy
    state_in = ssd.pass_states(states, cum)
    parts = {"chunk_states": time_ms(lambda: ssd.chunk_states(xk, dtk, a_head, bk)),
             "pass_states": time_ms(lambda: ssd.pass_states(scratch, cum)),
             "chunk_output": time_ms(lambda: ssd.chunk_output(xk, dtk, cum, bk, ck, state_in))}
    if x.dtype == torch.float32:  # the torch cumsum inside chunk_states, alone
        parts["of_which_cumsum"] = time_ms(lambda: torch.cumsum(dtk * a_head, dim=2))
    return parts


def bf16_ulp(t: torch.Tensor) -> float:
    """One bf16 ulp at the largest |t|: 2**(floor(log2 max|t|) - 7)."""
    return 2.0 ** (math.floor(math.log2(float(t.abs().max()))) - 7)


def ssd_phase(ssd, ref):
    """The SSD scan and each of its three kernels against their plain versions
    and the model's chunked path at Mamba2-370M's prefill shapes. Returns its
    kernels-line entry."""
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator().manual_seed(9)
    b, s, h, p, n, q = PREFILL_B, PREFILL_S, 32, 64, 128, 128
    args = _ssd_inputs(gen, b, s, h, p, n)
    before = ssd.ssd_scan.launches
    got = ssd.ssd_scan(*args, chunk=q)
    want = ssd_plain(ref, *args, q)
    model, _ = ssd_chunked(*args, chunk=q)
    torch.cuda.synchronize()
    if ssd.ssd_scan.launches != before + ssd.KERNELS_PER_CALL:
        raise AssertionError(f"one scan launched {ssd.ssd_scan.launches - before} kernels, "
                             f"expected {ssd.KERNELS_PER_CALL}")
    worst = close(got, want, 5e-4, 1e-3, "ssd vs plain")  # tests/test_kernels.py:71
    err_model = close(got, model, 5e-4, 1e-3, "ssd vs ssd_chunked")
    stage_err = ssd_stages(ssd, ref, *args, q)
    print(f"Mamba2-370M prefill shapes x [{b}, {s}, {h}, {p}], B/C [{b}, {s}, {n}], chunk "
          f"{q}: max abs err {worst:.3e} vs plain, {err_model:.3e} vs the model's ssd_chunked "
          f"(atol 5e-4, rtol 1e-3); chunk_states, pass_states and chunk_output each against "
          f"its plain stage: max abs err {stage_err:.3e}")
    sweep = [(1, 32, 4, 16, 8, 8, torch.float32), (2, 64, 8, 16, 16, 16, torch.float32),
             (1, 64, 8, 32, 8, 64, torch.float32), (1, 128, 16, 64, 128, 32, torch.float32),
             (1, 48, 3, 20, 40, 48, torch.float32),
             (2, 256, 32, 64, 128, 128, torch.bfloat16),
             # test_kernels.py:52-57, ragged, bf16; bf16 at the path's shapes
             (PREFILL_B, PREFILL_S, 32, 64, 128, 128, torch.bfloat16)]
    entry_err_bf16 = None  # the scan's max abs err in bf16 at the path's shapes
    for cb, cs, ch, cp, cn, cq, dtype in sweep:
        cargs = _ssd_inputs(gen, cb, cs, ch, cp, cn, dtype)
        tol = (5e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
        case = (cb, cs, ch, cp, cn, cq, dtype)
        want_case = ssd_plain(ref, *cargs, cq).float()
        got_case = ssd.ssd_scan(*cargs, chunk=cq).float()
        err = close(got_case, want_case, *tol, f"ssd sweep {case}")
        stage_err = ssd_stages(ssd, ref, *cargs, min(cq, cs))
        if dtype == torch.bfloat16:
            moved = int((got_case != want_case).sum())
            print(f"  {case}: max abs err {err:.3e} (the scan, atol, rtol {tol}; one bf16 ulp "
                  f"at max |y| {float(want_case.abs().max()):.3f} is {bf16_ulp(want_case):.4e}; "
                  f"{moved} of {got_case.numel()} outputs differ from the plain version's), "
                  f"{stage_err:.3e} (its stages)")
            if cs == s and cb == b:
                entry_err_bf16 = err
        del cargs, want_case, got_case
    print(f"sweep: {len(sweep)} cases within tolerance, the whole scan and each stage")

    entry = {"name": "ssd_scan", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
             "source_bf16": "src/repro_torch/kernels/csrc/ssd_scan_sm90.cu",
             "design": "f32 FMA, 3 kernels", "design_bf16": "wgmma stages 1 and 3, split f32 operands",
             "replaces": "src/repro/kernels/ssd_scan.py:70", "max_abs_err": worst,
             "max_abs_err_bf16": entry_err_bf16,
             "library_ms": None, "kernels_per_call": ssd.KERNELS_PER_CALL}
    nc = s // q
    # the products the function needs: the lower triangle of C.B^T once per
    # (batch, chunk); per head the lower-triangular W.x, C.state and the
    # state update
    flops = b * nc * (q * (q + 1) * n + h * (q * (q + 1) * p + 4 * q * n * p))
    bf16_args = _ssd_inputs(gen, b, s, h, p, n, torch.bfloat16)  # the bf16 prefill's instance
    for dtype, targs, peak in ((torch.float32, args, F32_FLOPS),
                               (torch.bfloat16, bf16_args, BF16_FLOPS)):
        ms = time_ms(lambda: ssd.ssd_scan(*targs, chunk=q))
        plain_ms = time_ms(lambda: ssd_plain(ref, *targs, q), iters=10)
        model_ms = time_ms(lambda: ssd_chunked(*targs, chunk=q), iters=10)
        ms_again = time_ms(lambda: ssd.ssd_scan(*targs, chunk=q))
        # x and y, B and C at the input's width; dt and cum f32
        width = targs[0].element_size()
        nbytes = (2 * targs[0].numel() * width + 2 * targs[1].numel() * 4
                  + 2 * targs[3].numel() * width)
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        where = "f32" if dtype == torch.float32 else "bf16 tensor cores"
        print(f"ssd_scan {dtype} ({ssd.KERNELS_PER_CALL} kernels): {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; includes the wrapper's cumsum), plain {plain_ms:.4f} ms, the "
              f"model's ssd_chunked {model_ms:.4f} ms; bound {bound_ms:.4f} ms by {by} "
              f"({flops / 1e9:.2f} GFLOP at {peak / 1e12:g} TFLOP/s {where} = {ops_ms:.4f} ms; "
              f"x, y, dt, cum, B, C {nbytes} B = {bytes_ms:.4f} ms); no single PyTorch call "
              f"computes the scan (library_ms null); kernels at {flops / ms / 1e9:.2f} TFLOP/s")
        suffix = "" if dtype == torch.float32 else "_bf16"
        entry.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                      f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": by})
        parts = ssd_stage_times(ssd, *targs, q)
        stages = sum(v for k, v in parts.items() if not k.startswith("of_which"))
        print(f"ssd_scan {dtype} by kernel, each timed alone: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
              + f"; sum of the three {stages:.4f} ms against the whole call's {ms:.4f}")
        entry.update({f"ms_{k}{suffix}": v for k, v in parts.items()})
    return entry


class LMWeights:
    """Each LM arch's model and full-width weights, drawn once from one seed
    on the card (``draw_on_card``: the host takes tens of seconds for a
    2.5-2.8 B model) and held on the host for phases 10-12. A phase moves
    one arch's weights to the card (``on_card``) and back before the next,
    so a peak it reads holds that arch's weights alone."""

    def __init__(self, seed: int = 10):
        self.seed, self.held = seed, {}

    def on_host(self, arch: str):
        """(cfg, model, params) of ``arch`` on the host, drawn at first use."""
        from repro_torch.configs import get_config

        if arch not in self.held:
            cfg = get_config(arch)
            model, params, _ = draw_on_card(cfg, PREFILL_S, self.seed)
            self.held[arch] = cfg, model, params.to("cpu")
            torch.cuda.empty_cache()
        return self.held[arch]

    @contextlib.contextmanager
    def on_card(self, arch: str):
        """(cfg, model, params) of ``arch`` with params moved to the card for
        the block, and back to the host after it."""
        cfg, model, params = self.on_host(arch)
        try:
            yield cfg, model, params.to("cuda")
        finally:
            params.to("cpu")
            torch.cuda.empty_cache()


def lm_model_phase(weights: LMWeights):
    """Every model of the LM path at full width on the card against the CPU:
    the same weights, on the host and then on the card."""
    from repro_torch.models import StackCtx

    for arch in LM_ARCHS:
        cfg, model, params = weights.on_host(arch)
        toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            want, _ = model.forward(params, {"tokens": toks}, StackCtx(cfg, use_kernel=True))
            with weights.on_card(arch) as (_, _, params):
                got, _ = model.forward(params, {"tokens": toks.cuda()},
                                       StackCtx(cfg, use_kernel=True))
                got = got.cpu()
        scale = float(want.abs().max())
        tol = 1e-4 * scale + 1e-5  # f32 both sides, other kernels and summation orders
        err = close(got, want, tol, 0.0, f"{arch} card vs cpu")
        print(f"{arch} full width ({cfg.param_count() / 1e6:.1f} M parameters), B 1, S 128, "
              f"kernels on the card vs plain versions on the CPU: logits {tuple(got.shape)}, "
              f"max |card - cpu| {err:.3e} (tolerance {tol:.3e}, |logit| max {scale:.3f})")


def _timed_call(fn, reps: int = 4):
    """Median host time of a synchronised ``fn()`` over reps - 1 runs after
    one."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs[1:])


def _timed_forward(model, params, batch, ctx, reps: int = 4):
    """Median host time of a synchronised forward of ``batch``."""
    return _timed_call(lambda: model.forward(params, batch, ctx), reps)


def _counted_call(fn, counters):
    """``fn()`` with every launch count set to 0 just before it: (its
    result, launches by kernel, peak device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kernel in counters.values():
        kernel.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: kernel.launches for name, kernel in counters.items()}, \
        torch.cuda.max_memory_allocated()


def _counted_forward(model, params, batch, ctx, counters):
    """One forward of ``batch``, counted (``_counted_call``): (logits,
    launches by kernel, peak device memory)."""
    return _counted_call(lambda: model.forward(params, batch, ctx)[0], counters)


def prefill_phase(counters, ssd, weights: LMWeights):
    """Prefill at full width with the kernels (the LM main path) against the
    plain path, in f32 and in bf16. Returns each arch's launches per f32
    forward by kernel."""
    launches = {}
    for arch in LM_ARCHS:
        with weights.on_card(arch) as (cfg, model, params):
            launches[arch] = _prefill_arch(counters, ssd, arch, cfg, model, params)
    return launches


def _mixers(cfg):
    """(attention layers, SSM layers, MoE layers) of ``cfg``."""
    n = cfg.num_layers
    attn = sum(cfg.layer_kind(i) == "attn" for i in range(n))
    return attn, n - attn, sum(cfg.layer_is_moe(i) for i in range(n))


def dropped_shares(cfg, pins):
    """Each MoE layer's share of (token, choice) pairs dropped at the config's
    capacity, from the routings ``pins``."""
    from repro_torch.models import moe

    shares = []
    for _, experts in pins:
        cap = moe.expert_capacity(experts.shape[0], cfg)
        keep = moe.dispatch(experts, cfg.num_experts, cap)[2]
        shares.append(float((~keep).float().mean()))
    return shares


def _prefill_arch(counters, ssd, arch, cfg, model, params, b=PREFILL_B, s=PREFILL_S,
                  batch=None):
    """Prefill of B x S tokens (or of ``batch``, the VLM's embeddings and
    positions) with the kernels against the plain path, in f32 and bf16; an
    MoE layer's routing is pinned from the plain f32 forward
    (``repro_torch.testdata.routing``, which has nothing to pin without one).
    Returns the launches per f32 forward by kernel."""
    from repro_torch.models import StackCtx, moe
    from repro_torch.testdata import moved_pairs, routing

    toks = batch if batch is not None else {"tokens": torch.randint(
        0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(2)).cuda()}
    n_attn, n_ssm, n_moe = _mixers(cfg)
    expect = {name: 0 for name in counters}
    expect.update(flash_attention=n_attn, ssd_scan=n_ssm * ssd.KERNELS_PER_CALL)
    tokens = b * s
    with torch.no_grad():
        with routing() as pins:
            want, _ = model.forward(params, toks, StackCtx(cfg, use_kernel=False))
        scale = float(want.abs().max())
        if n_moe:
            print(f"{arch} prefill B {b} x S {s}: pairs dropped at capacity factor "
                  f"{cfg.capacity_factor} by MoE layer: "
                  + ", ".join(f"{x:.4f}" for x in dropped_shares(cfg, pins))
                  + f" (capacity {moe.expert_capacity(tokens, cfg)} a layer)")
        for dtype in (torch.float32, torch.bfloat16):
            fast = StackCtx(cfg, use_kernel=True, compute_dtype=dtype)
            slow = StackCtx(cfg, use_kernel=False, compute_dtype=dtype)
            with routing(pins) as calls:
                got, seen, peak = _counted_forward(model, params, toks, fast, counters)
            if seen != expect:
                raise AssertionError(f"{arch} {dtype}: expected launches {expect}, saw {seen}")
            if got.shape != (b, s, cfg.vocab_size) or got.dtype != dtype:
                raise AssertionError(f"bad logits {tuple(got.shape)} {got.dtype}")
            if dtype == torch.float32:
                launched = seen
                # f32 both paths; the kernels sum attention / the scan in
                # another order than cuBLAS and the plain path's einsums.
                # The CPU parity tests show ~1e-6 of the largest logit
                # between the packages; 1e-4 leaves a factor of 100 for 30
                # and 48 layers of compounding.
                tol = 1e-4 * scale + 1e-5
                err = close(got, want, tol, 0.0, f"{arch} prefill kernels vs plain path")
                check = f"max |kernels - plain| {err:.3e} (tolerance {tol:.3e})"
            else:
                # bf16 against the f32 plain path: the kernel path may stray
                # at most twice as far as the bf16 plain path does, plus
                # 1e-3 of the largest logit (the bf16 flash kernel rounds
                # P to bf16 where the plain path keeps f32 probabilities)
                with routing(pins):
                    plain16, _ = model.forward(params, toks, slow)
                ref_err = abs_err(plain16.float(), want)
                tol = 2 * ref_err + 1e-3 * scale
                err = close(got.float(), want, tol, 0.0, f"{arch} bf16 prefill kernels vs f32")
                check = (f"max |kernels - f32 plain| {err:.3e}, bf16 plain path's "
                         f"{ref_err:.3e} (tolerance {tol:.3e})")
                del plain16
            del got
            routed = (f"; routing pinned, {moved_pairs(calls, pins)} of "
                      f"{tokens * cfg.num_experts_per_tok * n_moe} pairs would choose another "
                      f"expert unpinned" if n_moe else "")
            t_fast = _timed_forward(model, params, toks, fast)
            t_slow = _timed_forward(model, params, toks, slow)
            t_again = _timed_forward(model, params, toks, fast)
            print(f"{arch} prefill {str(dtype)[6:]} B {b} x S {s}: {seen['flash_attention']} "
                  f"flash_attention and {seen['ssd_scan']} ssd_scan launches per forward"
                  f"{routed}; logits {check}; median forward with kernels "
                  f"{t_fast * 1e3:.1f} ms (again {t_again * 1e3:.1f}) = {tokens / t_fast:.0f} "
                  f"tokens/s, plain path {t_slow * 1e3:.1f} ms = {tokens / t_slow:.0f} tokens/s; "
                  f"peak memory with kernels {peak / 2**30:.2f} GiB")
        del want
    return launched


# the serve CLI draws its weights on the host (a CPU generator), tens of
# seconds for these archs: it serves them at full width cut to this depth
SERVE_CLI_LAYERS = {"stablelm-3b": 4, "gemma-2b": 4}


@contextlib.contextmanager
def serve_depth(serve, layers: int):
    """The serve CLI's ``get_config`` with the model cut to ``layers`` layers
    (0: whole), restored after."""
    get_config = serve.get_config
    if layers:
        serve.get_config = lambda arch: dataclasses.replace(get_config(arch),
                                                            num_layers=layers)
    try:
        yield
    finally:
        serve.get_config = get_config


def serving_phase(weights: LMWeights, seed: int = 12):
    """Greedy serving at full width: the CLI's path (which draws its own
    weights from ``seed``; ``SERVE_CLI_LAYERS`` cut its depth), and
    DecodeEngine's decode logits at every prompt position against the
    teacher-forced forward on the held weights, whole. Returns the CLI
    path's decode tokens/s per sequence by arch."""
    from repro_torch.launch import serve

    decode = {}
    for arch in LM_ARCHS:
        layers = SERVE_CLI_LAYERS.get(arch, 0)
        with serve_depth(serve, layers):
            res = serve.main(["--arch", arch, "--batch", str(SERVE_B), "--prompt-len",
                              str(PROMPT), "--gen-len", str(GEN), "--seed", str(seed)])
        decode[arch] = res.tokens_per_second
        if res.tokens.shape != (SERVE_B, GEN) or res.tokens.device.type != "cuda":
            raise AssertionError(f"bad generation {tuple(res.tokens.shape)} {res.tokens.device}")
        depth = f" at {layers} layers" if layers else ""
        print(f"{arch} serve (CLI path{depth}): prefill {res.prefill_seconds:.3f} s for {PROMPT} "
              f"tokens x {SERVE_B}, decode {res.decode_seconds:.3f} s = "
              f"{res.tokens_per_second:.1f} tok/s per sequence")
        del res
        with weights.on_card(arch) as (cfg, model, params):
            _decode_arch(arch, cfg, model, params, seed)
    return decode


def _decode_arch(arch, cfg, model, params, seed):
    from repro_torch.models import StackCtx
    from repro_torch.serving import DecodeEngine

    gen = torch.Generator().manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT), generator=gen).cuda()
    ctx = StackCtx(cfg)
    res = DecodeEngine(model, ctx).generate(params, prompts, GEN)
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": prompts}, StackCtx(cfg, use_kernel=True))
        caches = model.init_cache(params, SERVE_B, PROMPT + GEN, dtype=torch.float32)
        outs = []
        for t in range(PROMPT):
            logits, caches = model.decode(params, {"token": prompts[:, t:t + 1]}, caches, t,
                                          ctx)
            outs.append(logits)
        dec = torch.cat(outs, dim=1)
        first = torch.argmax(dec[:, -1], dim=-1)
    err = close(dec, full, 2e-3, 2e-3, f"{arch} decode vs teacher-forced forward")
    if not torch.equal(first, res.tokens[:, 0]):
        raise AssertionError(f"{arch}: the engine's first token differs from the decode loop's")
    print(f"{arch} DecodeEngine: decode logits at all {PROMPT} prompt positions vs the "
          f"teacher-forced forward (kernels): max abs err {err:.3e} (atol = rtol = 2e-3); "
          f"prefill {res.prefill_seconds:.3f} s, {res.tokens_per_second:.1f} tok/s per "
          f"sequence")


# ---------------------------------------------------------------------------
# phase 15: continual LM training
# ---------------------------------------------------------------------------

# The train CLI's one-device run (``repro_torch.launch.train.build_run``) at
# its defaults: seq 128, global batch 8, AdamW at lr 3e-3 with 20 warm-up
# steps, f32 compute, async reservoir rehearsal with 16 slots a bucket and
# the config's r 7 and c 14, the scenario's vocab min(V, 2048). Cut in data
# scale only: the steps a task.
LM_SEQ, LM_BATCH, LM_SLOTS, LM_REPS, LM_CANDS, LM_TOPK = 128, 8, 16, 7, 14, 16
LM_STEPS = {"smollm-135m": 8, "mamba2-370m": 4}


def lm_cli_run(arch: str, *, steps: int, tasks: int = 2, strategy: str = "",
               top_k: int = 0, tiered: bool = False, fused: bool = False,
               dtype: str = "float32", scenario: str = "class_incremental", seed: int = 0):
    """The ``RunConfig`` the train CLI builds for these flags, with the
    tiered store's kernels (``fused``), the compute dtype and the scenario
    set on it where they differ from the CLI's (it has no flag for them).
    Checks that the CLI's defaults are the settings printed above."""
    from repro_torch.launch import train as train_cli

    flags = ["--arch", arch, "--tasks", str(tasks), "--steps-per-task", str(steps),
             "--seed", str(seed)]
    flags += ["--strategy", strategy] if strategy else []
    flags += ["--der-top-k", str(top_k)] if top_k else []
    flags += ["--tiering", "host"] if tiered else []
    run = train_cli.build_run(train_cli.parse_args(flags))
    rc, sc, tr = run.rehearsal, run.scenario, run.train
    got = (sc.seq_len, sc.batch_size, rc.slots_per_bucket, rc.num_representatives,
           rc.num_candidates, tr.optimizer, tr.peak_lr, tr.warmup_steps, tr.compute_dtype,
           rc.mode, rc.policy)
    want = (LM_SEQ, LM_BATCH, LM_SLOTS, LM_REPS, LM_CANDS, "adamw", 3e-3, 20, "float32",
            "async", "reservoir")
    if got != want:
        raise AssertionError(f"the train CLI's defaults moved: {got}, phase 15 reads {want}")
    return dataclasses.replace(
        run, train=dataclasses.replace(tr, compute_dtype=dtype),
        rehearsal=dataclasses.replace(rc, fused_kernels=fused),
        scenario=dataclasses.replace(sc, name=scenario))


def lm_train_run(counters, arch: str, *, steps: int, tasks: int = 2,
                 strategy: str = "rehearsal", top_k: int = 0, tiered: bool = False,
                 fused: bool = False, dtype: str = "float32",
                 scenario: str = "class_incremental", seed: int = 0, mesh_local: bool = False):
    """``ContinualTrainer`` on a token scenario at full width, on the train
    CLI's run (``lm_cli_run``): the carry backend, or with ``mesh_local``
    the mesh backend at 1x1 with ``exchange='local'`` (the carry backend's
    r rows a step). Every counter is set to 0 just before
    ``fit`` and read just after. Checks every loss finite, task 0's loss
    (der: its CE on the new rows) lower at its last step than at its first,
    one update+sample launch a flat step (three a tiered step), the int8
    kernels once a step per float leaf on the tiered store, and no flash or
    scan launch (training runs the plain mixers). Prints the median step,
    peak device memory, prefetch-wait share, launches and accuracy matrix;
    returns the launches and the ``(rep_checksum, buffer_fill)`` history."""
    from repro_torch.scenario import ContinualTrainer

    run = lm_cli_run(arch, steps=steps, tasks=tasks, strategy=strategy, top_k=top_k,
                     tiered=tiered, fused=fused, dtype=dtype, scenario=scenario, seed=seed)
    name = (f"{arch} {scenario} {strategy}" + (f" top-{top_k}" if top_k else "")
            + (f", tiered {'fused' if fused else 'unfused'}" if tiered else ", flat")
            + f", {dtype}, {tasks} x {steps} steps" + (", mesh 1x1 local" if mesh_local else ""))
    if mesh_local:
        from repro_torch.launch.mesh import make_mesh

        if strategy.startswith("der"):
            raise ValueError("the mesh run reads no per-step ce")
        trainer = ContinualTrainer(run, device="cuda", mesh=make_mesh((1, 1), ("data", "model")),
                                   exchange="local")
        ce = []
    else:
        trainer = ContinualTrainer(run, device="cuda")
        step, ce = trainer._step_fn, []

        def watched(carry, batch, key, rows=None):
            carry, m = step(carry, batch, key, rows)
            ce.append(m.get("ce"))
            return carry, m

        trainer._step_fn = watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_steps = tasks * steps
    floats = [k for k, v in trainer.item_spec.items() if v.dtype.is_floating_point]
    want = {k: 0 for k in counters}
    want["rehearsal_update_sample"] = (3 if tiered else 1) * n_steps
    if tiered:
        for kernel in (("encode_scatter_rows", "gather_dequant_rows") if fused
                       else ("quantize_rows",)):
            want[kernel] = len(floats) * n_steps
    step_ms = statistics.median(result.step_seconds) * 1e3
    wait_share = sum(result.prefetch_wait_seconds) / sum(result.step_seconds)
    falling = ([float(c) for c in ce[:steps]] if strategy.startswith("der")
               else result.losses[:steps])
    print(f"{name}: record {({k: tuple(v.shape) for k, v in trainer.item_spec.items()})}")
    print(f"  losses {[round(x, 4) for x in result.losses]}"
          + (f"; ce {[round(x, 4) for x in falling]}" if strategy.startswith("der") else ""))
    print(f"  median step {step_ms:.2f} ms (all {[round(t * 1e3, 1) for t in result.step_seconds]}"
          f"); peak device memory {peak / 2**30:.2f} GiB; prefetch-wait share "
          f"{wait_share:.4f}; fit {seconds:.1f} s")
    print(f"  launches {({k: v for k, v in launches.items() if v})}: update+sample "
          f"{launches['rehearsal_update_sample'] / n_steps:g} a step")
    print(f"  accuracy matrix ({'eval loss' if scenario == 'class_incremental' else 'top-1'}) "
          f"{result.accuracy_matrix.round(4).tolist()}")
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want}, saw {launches}")
    if len(result.losses) != n_steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"{name}: non-finite or missing losses {result.losses}")
    if not falling[-1] < falling[0]:
        raise AssertionError(f"{name}: task 0's loss did not fall: {falling}")
    acc = result.accuracy_matrix[np.tril_indices(tasks)]
    if not np.isfinite(acc).all() or (scenario == "drift_stream" and not (
            (acc >= 0) & (acc <= 1)).all()):
        raise AssertionError(f"{name}: accuracy matrix {result.accuracy_matrix}")
    history = [(h["rep_checksum"], h["buffer_fill"]) for h in result.history]
    del trainer, result
    torch.cuda.empty_cache()
    return {"launches": launches, "history": history, "step_ms": step_ms}


@contextlib.contextmanager
def cut_depth(train_cli, layers):
    """The train CLI's ``build_run`` with the model cut to ``layers`` layers
    (0: as the CLI builds it), restored after."""
    build_run = train_cli.build_run

    def cut(args):
        run = build_run(args)
        return run if not layers else dataclasses.replace(
            run, model=dataclasses.replace(run.model, num_layers=layers))

    train_cli.build_run = cut
    try:
        yield
    finally:
        train_cli.build_run = build_run


def lm_cli_main(counters, arch: str = "smollm-135m", tasks: int = 2, steps: int = 4,
                layers: int = 0, reduced: bool = False):
    """The train CLI itself, ``launch.train.main``, at full width (or with
    ``layers`` layers, or ``reduced``) on its default device (the card),
    ``tasks`` x ``steps`` steps. Counters are set to 0 just before and read
    just after. Checks one update+sample launch a step and no other kernel,
    every logged loss finite and an eval line for every task seen after each
    task; prints the CLI's log lines, every step and the peak memory.
    Returns the launches and the median step in ms."""
    import logging

    from repro_torch.launch import train as train_cli

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep, log = Keep(), logging.getLogger(train_cli.log.name)
    log.addHandler(keep)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    try:
        with cut_depth(train_cli, layers):
            result = train_cli.main(["--arch", arch, "--tasks", str(tasks), "--steps-per-task",
                                     str(steps)] + (["--reduced"] if reduced else []))
        torch.cuda.synchronize()
    finally:
        log.removeHandler(keep)
    launches = {k: fn.launches for k, fn in counters.items()}
    depth = "reduced" if reduced else f"{layers} layers" if layers else "full depth"
    print(f"{arch} ({depth}) through the train CLI ({tasks} x {steps} steps): "
          + " | ".join(line for line in lines if not line.startswith("step "))
          + f"; losses {[round(x, 4) for x in result.losses]}; steps "
          f"{[round(t * 1e3, 1) for t in result.step_seconds]} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = dict({k: 0 for k in counters}, rehearsal_update_sample=tasks * steps)
    evals = [line for line in lines if line.startswith("eval after task")]
    if launches != want:
        raise AssertionError(f"train CLI: expected launches {want}, saw {launches}")
    if "device=cuda" not in lines[0] or len(evals) != tasks * (tasks + 1) // 2:
        raise AssertionError(f"train CLI: log lines {lines}")
    if len(result.losses) != tasks * steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"train CLI: non-finite or missing losses {result.losses}")
    return {"launches": launches, "step_ms": statistics.median(result.step_seconds) * 1e3}


def token_record_kernels(qz, ops, ref, seed: int = 15):
    """update+sample on phase 15's token records (the buffer of 2 buckets x
    16 slots: tokens and labels i32 [128], task i32; der top-16 adds
    logit_vals f32 and logit_idx i32 [128 x 16]) in one launch, and in the
    cold tier's pinned layout (2 x 48 slots: logit_vals as int8 rows of 2048
    and their f32 scales, the rest raw), plain and with logit_vals
    dequantized on the gather; the int8 kernels on logit_vals rows (a stage
    of 2c = 28); all bit for bit against the plain versions."""
    rng = np.random.default_rng(seed)
    hot_rows, cold_rows, stage = 2 * LM_SLOTS, 2 * 3 * LM_SLOTS, 2 * LM_CANDS
    width = LM_SEQ * LM_TOPK

    def rand(shape, dtype, where="cuda"):
        if dtype == torch.float32:
            return torch.randn(shape, device=where) * 8  # logit-like values
        lo, hi = (-127, 128) if dtype == torch.int8 else (0, 49152)
        return torch.randint(lo, hi, shape, dtype=dtype, device=where)

    def rows(n, total, drops=0):
        out = np.concatenate([rng.choice(total, n - drops, replace=False),
                              np.full(drops, total)]).astype(np.int32)
        return torch.as_tensor(out, device="cuda")

    base = [(torch.int32, LM_SEQ), (torch.int32, LM_SEQ), (torch.int32, 1)]
    topk = base + [(torch.float32, width), (torch.int32, width)]
    cand_rows, samp_rows = rows(LM_BATCH, hot_rows), rows(LM_REPS, hot_rows)
    for fields in (base, topk):
        tables = [rand((hot_rows, w), d) for d, w in fields]
        cands = [rand((LM_BATCH, w), d) for d, w in fields]
        check_leaves(ops, ref, tables, cands, cand_rows, samp_rows)
    cold = [(torch.int8, width), (torch.float32, 1)] + base + [(torch.int32, width)]
    flush, cold_samp = rows(stage, cold_rows, drops=stage // 2), rows(LM_REPS, cold_rows)
    tables = [rand((cold_rows, w), d, "cpu").pin_memory() for d, w in cold]
    batch = [rand((stage, w), d) for d, w in cold]
    batch[1] = batch[1].abs() / 127  # scales
    check_pinned_leaves(ops, ref, tables, batch, flush, cold_samp)
    check_folded(ops, ref, tables, batch, flush, cold_samp, torch.float32, "logit_vals")
    q, scales = tables[0], tables[1]
    want_q, want_s = q.to("cuda", copy=True), scales.to("cuda", copy=True)
    x = rand((stage, width), torch.float32)
    kq, ks = qz.quantize_rows(x)
    pq, ps = ref.quantize_rows_ref(x)
    ops.encode_scatter_rows(q, scales, x, flush)
    ref.encode_scatter_rows_ref(want_q, want_s, x, flush)
    got = ops.gather_dequant_rows(q, scales, cold_samp, torch.float32)
    want = ref.gather_dequant_rows_ref(want_q, want_s, cold_samp, torch.float32)
    torch.cuda.synchronize()
    for what, a, b in (("quantize_rows q", kq, pq), ("quantize_rows scale", ks, ps),
                       ("encode_scatter_rows q", q, want_q),
                       ("encode_scatter_rows scale", scales, want_s),
                       ("gather_dequant_rows", got, want)):
        if not same_bits(a, b):
            raise AssertionError(f"{what} != plain version on logit_vals rows [{stage}, {width}]")
    print(f"token records: update+sample one launch, bit-equal to the plain version leaf by "
          f"leaf ({hot_rows} rows, 3 and 5 leaves; cold {cold_rows} rows pinned, 6 leaves, "
          f"plain and dequantizing logit_vals); quantize_rows, encode_scatter_rows and "
          f"gather_dequant_rows bit-equal on logit_vals rows [{stage}, {width}]")


def lm_train_card_against_cpu(steps: int = 2, seed: int = 16):
    """``make_cl_step`` with the LM loss and AdamW on the reduced SmolLM-135M
    and Mamba2-370M (4 layers, d 128, vocab 512) at seq 32, b 4, r 3, c 4,
    async rehearsal: the card against the CPU from the same weights, fed the
    same rows (planned on the CPU, through the ``rows`` seam), TF32 off. The
    buffer's leaves and the pending slot bit for bit; the loss within 1e-4
    of its value (f32 both sides, other summation orders)."""
    from repro_torch.buffer.state import ItemSpec, plan_update_sample
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import RehearsalConfig, TrainConfig
    from repro_torch.models import StackCtx, build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.strategy import init_carry, make_cl_step

    seq, b = 32, 4
    rcfg = RehearsalConfig(num_buckets=2, slots_per_bucket=4, num_representatives=3,
                           num_candidates=4, mode="async", label_field="labels")
    spec = {"tokens": ItemSpec((seq,), torch.int32), "labels": ItemSpec((seq,), torch.int32),
            "task": ItemSpec((), torch.int32)}
    init, update = make_optimizer(TrainConfig(optimizer="adamw", peak_lr=3e-3, warmup_steps=2,
                                              linear_scaling=False))
    for arch in LM_STEPS:
        cfg = get_reduced(arch)
        lm, ctx = build_model(cfg), StackCtx(cfg)
        carries, step_fns = {}, {}
        for dev in ("cpu", "cuda"):
            model = lm.init(torch.Generator().manual_seed(seed), seq, dev)
            carries[dev] = init_carry(model, init(dict(model.named_parameters())), spec, rcfg,
                                      label_field="labels", seed=3, device=dev)
            step_fns[dev] = make_cl_step(lambda m, bt: lm.loss(m, bt, ctx), update, rcfg,
                                         exchange="local", label_field="labels", device=dev)
        rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)
        for s in range(steps):
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, seq)).astype(np.int32),
                     "labels": rng.integers(0, cfg.vocab_size, (b, seq)).astype(np.int32),
                     "task": rng.integers(0, 2, b).astype(np.int32)}
            rows = plan_update_sample(carries["cpu"].buffer, torch.from_numpy(batch["task"]),
                                      gen, rcfg.num_candidates, rcfg.num_representatives)
            losses = {}
            for dev in ("cpu", "cuda"):
                dev_rows = type(rows)(*(x.to(dev) if isinstance(x, torch.Tensor) else x
                                        for x in rows))
                carries[dev], m = step_fns[dev](carries[dev], batch, s, rows=dev_rows)
                losses[dev] = float(m["loss"])
            got, want = carries["cuda"], carries["cpu"]
            for k in spec:
                if not (same_bits(got.buffer.data[k], want.buffer.data[k])
                        and same_bits(got.pipe.reps[k], want.pipe.reps[k])):
                    raise AssertionError(f"{arch} LM step {s}: buffer leaf {k} differs")
            tol = 1e-4 * abs(losses["cpu"])
            print(f"{arch} reduced LM step {s}, card against CPU (TF32 off, same rows): buffer "
                  f"and pending slot bit-equal; loss {losses['cuda']:.6f} vs "
                  f"{losses['cpu']:.6f} (tolerance {tol:.3e})")
            if abs(losses["cuda"] - losses["cpu"]) > tol:
                raise AssertionError(f"{arch} LM step {s}: the card disagrees with the CPU")


def lm_train_phase(counters, qz, ops, ref):
    """Phase 15: SmolLM-135M (8 steps a task) and Mamba2-370M (4) on 2 tasks
    of TokenClassIncremental; SmolLM-135M with der_pp top-16 on the tiered
    store, unfused then fused (identical fingerprints), at bf16 compute, and
    on DriftStream, each on the train CLI's run; SmolLM-135M through the
    train CLI's ``main`` (the mesh backend at 1x1, exchange full: 1
    representative a step), 2 tasks x 8 steps, and through the mesh backend
    with exchange local (the carry run's rows; its fingerprints equal the
    carry run's), each median step printed beside the carry run's; the
    token records' kernels against their plain versions; the reduced
    card-against-CPU steps. Returns each run's launches and history by
    name."""
    print(f"card: {gpu_name_and_power()}")
    print(f"data-scale cuts (widths and depths are the published ones): seq {LM_SEQ}, "
          f"batch {LM_BATCH} + r {LM_REPS}, {LM_STEPS} steps a task, 2 tasks, 16 eval "
          f"sequences a task; the scenario's vocab min(V, 2048)")
    runs = {}
    for arch in LM_STEPS:
        runs[arch] = lm_train_run(counters, arch, steps=LM_STEPS[arch])
    der = {f: lm_train_run(counters, "smollm-135m", steps=4, tasks=1, strategy="der_pp",
                           top_k=LM_TOPK, tiered=True, fused=f) for f in (False, True)}
    if der[False]["history"] != der[True]["history"]:
        raise AssertionError(f"der_pp tiered: fused and unfused fingerprints differ: "
                             f"{der[False]['history']} vs {der[True]['history']}")
    runs["smollm-135m der_pp top-16 tiered unfused"] = der[False]
    runs["smollm-135m der_pp top-16 tiered fused"] = der[True]
    runs["smollm-135m bf16"] = lm_train_run(counters, "smollm-135m", steps=4, tasks=1,
                                            dtype="bfloat16")
    runs["smollm-135m drift_stream"] = lm_train_run(counters, "smollm-135m", steps=4,
                                                    scenario="drift_stream")
    print(f"der_pp tiered: fused == unfused fingerprints over {len(der[True]['history'])} steps")
    smol = LM_STEPS["smollm-135m"]
    runs["smollm-135m train CLI"] = cli = lm_cli_main(counters, steps=smol)
    runs["smollm-135m mesh 1x1 local"] = mesh = lm_train_run(counters, "smollm-135m", steps=smol,
                                                             mesh_local=True)
    carry = runs["smollm-135m"]
    if mesh["history"] != carry["history"]:
        raise AssertionError(f"mesh 1x1 local fingerprints {mesh['history']} differ from the "
                             f"carry backend's {carry['history']}")
    print(f"SmolLM-135M f32, 2 x {smol} steps, median step: carry backend "
          f"{carry['step_ms']:.2f} ms (r {LM_REPS}); mesh backend 1x1, exchange local "
          f"{mesh['step_ms']:.2f} ms (r {LM_REPS}, the same fingerprints); the train CLI, "
          f"mesh 1x1, exchange full {cli['step_ms']:.2f} ms (1 representative a step)")
    token_record_kernels(qz, ops, ref)
    lm_train_card_against_cpu()
    return runs


# ---------------------------------------------------------------------------
# phase 16: online serving at full width
# ---------------------------------------------------------------------------

# The serve CLI's --online run (``launch.serve.build_online_run``) at its
# defaults (batch 4, prompt 32, gen 16: records of 47 tokens; 8 rounds of 1
# train step; a drift over 3 anchors; AdamW at 3e-3, f32; the drift stream's
# rehearsal defaults: async reservoir, one bucket an anchor, 16 slots, r 7,
# c 14) with the model at full width and the stream over min(V, 2048) ids.
# The learner runs ONLINE_ROUNDS of the CLI's ONLINE_CLI_ROUNDS rounds, for
# time (the CLI's own case keeps its 8, on the reduced LM); the injected
# failure comes at round ONLINE_FAIL_AT, after two rounds that trained.
ONLINE_CLI_ROUNDS, ONLINE_ROUNDS, ONLINE_PHASES, ONLINE_FAIL_AT = 8, 3, 3, 2
ONLINE_ARCHS = ("smollm-135m", "mamba2-370m")


def online_run(arch: str):
    """The ``RunConfig`` of the serve CLI's ``--online`` at its defaults, with
    ``arch`` at full width in place of the reduced LM, the drift stream over
    min(V, 2048) ids and ``ONLINE_ROUNDS`` rounds."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    args = serve.parse_args(["--online"])
    got = (args.batch, args.prompt_len, args.gen_len, args.rounds, args.train_every,
           args.phases, args.dtype)
    want = (SERVE_B, PROMPT, GEN, ONLINE_CLI_ROUNDS, 1, ONLINE_PHASES, "float32")
    if got != want:
        raise AssertionError(f"the serve CLI's --online defaults moved: {got}, phase 16 "
                             f"reads {want}")
    run = serve.build_online_run(args)
    cfg = get_config(arch)
    return dataclasses.replace(
        run, model=cfg, online=dataclasses.replace(run.online, rounds=ONLINE_ROUNDS),
        scenario=dataclasses.replace(run.scenario, vocab_size=min(cfg.vocab_size, 2048)))


class OnlineTimes:
    """Wraps a learner's train round and weight handoff: the host time of
    each round's train steps (to the card's end, synchronised), the card's
    time of each handoff copy (CUDA events), and a copy of the weights that
    each handoff published, for the rounds in ``keep``."""

    def __init__(self, learner, keep=()):
        self.train_ms, self.handoff_ms, self.kept = [], [], {}
        train, handoff = learner._train_round, learner._handoff

        def timed_train(carry, records, train_step):
            t0 = time.perf_counter()
            try:
                return train(carry, records, train_step)
            finally:
                torch.cuda.synchronize()
                self.train_ms.append((time.perf_counter() - t0) * 1e3)

        def timed_handoff(serving, params):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            handoff(serving, params)
            end.record()
            end.synchronize()
            self.handoff_ms.append(start.elapsed_time(end))
            if len(self.handoff_ms) - 1 in keep:
                self.kept[len(self.handoff_ms) - 1] = {
                    k: v.clone() for k, v in serving.state_dict().items()}

        learner._train_round, learner._handoff = timed_train, timed_handoff


def _same_weights(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(same_bits(a[k], b[k]) for k in a)


def online_arch(counters, arch: str, decode_cli: dict, fail: bool = False):
    """``OnlineLearner(run).run()`` on the card (its default device) on
    ``online_run(arch)``, every counter set to 0 just before ``run`` and
    read just after. Checks, for the normal run: every round trained at
    freshness 1, admission 1.0, finite losses, one update+sample launch a
    round and no other kernel, the serving copy equal to the train weights
    bit for bit. With ``fail``, a failure injected before round
    ``ONLINE_FAIL_AT``'s step: every round still served, training off from
    that round, and serving ends on the weights the round before handed off,
    bit for bit. Prints decode tokens/s per sequence beside phase 12's CLI
    path, the train ms a round, the handoff copy's ms and the peak memory."""
    from repro_torch.serving import OnlineLearner

    def hook(step):
        if step >= ONLINE_FAIL_AT:
            raise RuntimeError(f"injected failure before train step {step}")

    run = online_run(arch)
    learner = OnlineLearner(run, failure_hook=hook if fail else None)
    times = OnlineTimes(learner, keep=(ONLINE_FAIL_AT - 1,) if fail else ())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    res = learner.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    hist = res.history
    losses = [h["loss"] for h in hist]
    name = f"{arch} online" + (f", failure before round {ONLINE_FAIL_AT}" if fail else "")
    tok_s = statistics.median(h["tokens_per_second"] for h in hist)
    tr, rc = learner.trainer, learner.trainer.rcfg
    print(f"{name}: record {({k: tuple(v.shape) for k, v in tr.item_spec.items()})}, "
          f"rehearsal {rc.mode} {rc.policy} {rc.num_buckets} x {rc.slots_per_bucket}, "
          f"r {rc.num_representatives}, c {rc.num_candidates}; {tr.device}")
    print(f"  losses {[round(x, 4) for x in losses]}; trained "
          f"{[int(h['trained']) for h in hist]}; freshness "
          f"{[int(h['freshness']) for h in hist]}; admission {res.admission_rate}")
    print(f"  decode {tok_s:.1f} tok/s per sequence, median of {len(hist)} rounds (phase 12's "
          f"CLI path: {decode_cli.get(arch, 'not run')}); train "
          f"{statistics.median(times.train_ms):.2f} ms a round (all "
          f"{[round(t, 1) for t in times.train_ms]}); handoff copy "
          f"{statistics.median(times.handoff_ms):.4f} ms (all "
          f"{[round(t, 4) for t in times.handoff_ms]}) for "
          f"{sum(p.numel() * p.element_size() for p in res.params.parameters()) / 1e9:.3f} GB; "
          f"peak device memory {peak / 2**30:.2f} GiB; run {seconds:.1f} s")
    print(f"  launches {({k: v for k, v in launches.items() if v})}; accuracy by anchor "
          f"{[round(a, 4) for a in res.accuracy]}")
    trained = sum(h["trained"] for h in hist)
    want = dict({k: 0 for k in counters}, rehearsal_update_sample=int(trained))
    if launches != want:
        raise AssertionError(f"{name}: expected launches {want}, saw {launches}")
    if len(hist) != ONLINE_ROUNDS or res.last_tokens.device.type != "cuda" or tuple(
            res.last_tokens.shape) != (SERVE_B, GEN):
        raise AssertionError(f"{name}: {len(hist)} rounds, last tokens "
                             f"{tuple(res.last_tokens.shape)} on {res.last_tokens.device}")
    if fail:
        expect = [1.0] * ONLINE_FAIL_AT + [0.0] * (ONLINE_ROUNDS - ONLINE_FAIL_AT)
        fresh = [1.0] * (ONLINE_FAIL_AT + 1) + [float(r - ONLINE_FAIL_AT + 1) for r in range(
            ONLINE_FAIL_AT + 1, ONLINE_ROUNDS)]
        if (not res.train_disabled or [h["trained"] for h in hist] != expect
                or [h["freshness"] for h in hist] != fresh):
            raise AssertionError(f"{name}: trained {[h['trained'] for h in hist]}, freshness "
                                 f"{[h['freshness'] for h in hist]}")
        if not _same_weights(res.params.state_dict(), times.kept[ONLINE_FAIL_AT - 1]):
            raise AssertionError(f"{name}: serving left round {ONLINE_FAIL_AT - 1}'s weights")
        print(f"  serving kept round {ONLINE_FAIL_AT - 1}'s handed-off weights bit for bit")
    else:
        if res.train_disabled or trained != ONLINE_ROUNDS or res.admission_rate != 1.0:
            raise AssertionError(f"{name}: trained {trained} of {ONLINE_ROUNDS} rounds, "
                                 f"admission {res.admission_rate}")
        if any(h["freshness"] != 1.0 for h in hist):
            raise AssertionError(f"{name}: freshness {[h['freshness'] for h in hist]}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: non-finite losses {losses}")
        if not _same_weights(res.params.state_dict(), res.carry.params.state_dict()):
            raise AssertionError(f"{name}: the serving copy differs from the train weights")
        print("  serving copy == train weights bit for bit")
    del learner, res
    torch.cuda.empty_cache()
    return {"decode_tok_s": tok_s, "train_ms": statistics.median(times.train_ms),
            "handoff_ms": statistics.median(times.handoff_ms), "peak_gib": peak / 2**30}


def online_cli(counters):
    """``serve.main(["--online"])``: the reduced 2-layer LM on the card at the
    CLI's defaults. Checks its 8 rounds trained at freshness 1, one
    update+sample launch a round and no other kernel."""
    from repro_torch.launch import serve

    for fn in counters.values():
        fn.launches = 0
    res = serve.main(["--online"])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve --online (CLI defaults): losses "
          f"{[round(h['loss'], 4) for h in res.history]}, decode "
          f"{res.decode_tokens_per_second:.1f} tok/s per sequence, admission "
          f"{res.admission_rate}, launches {({k: v for k, v in launches.items() if v})}")
    if launches != dict({k: 0 for k in counters}, rehearsal_update_sample=ONLINE_CLI_ROUNDS):
        raise AssertionError(f"serve --online: launches {launches}")
    if (res.last_tokens.device.type != "cuda" or res.train_disabled
            or [h["freshness"] for h in res.history] != [1.0] * ONLINE_CLI_ROUNDS):
        raise AssertionError(f"serve --online: {res.history}")


def online_phase(counters, decode_cli: dict):
    """Phase 16: OnlineLearner at full width (SmolLM-135M, then Mamba2-370M),
    SmolLM-135M again with a failure injected, then the CLI."""
    print(f"card: {gpu_name_and_power()}")
    out = {arch: online_arch(counters, arch, decode_cli) for arch in ONLINE_ARCHS}
    online_arch(counters, ONLINE_ARCHS[0], decode_cli, fail=True)
    online_cli(counters)
    return out


# ---------------------------------------------------------------------------
# phase 18: the resilient main path
# ---------------------------------------------------------------------------

# ResilienceConfig of cases (a)-(c): full-carry checkpoints every 3 steps and
# at each task's start, and a failure injected before absolute step 5 (mid
# task 1, off a checkpoint), so that the restart restores the checkpoint of
# step 4 (task 1's start) and replays step 4.
# Cases (e) and (f) are cut for time to 2 online rounds and 2 CLI steps.
RES_EVERY, RES_FAIL_AT, RES_ONLINE_ROUNDS, RES_CLI_STEPS = 3, 5, 2, 2
RES_REPLAYED = RES_FAIL_AT - max(RES_FAIL_AT // RES_EVERY * RES_EVERY,
                                 RES_FAIL_AT // STEPS_PER_TASK * STEPS_PER_TASK)


@contextlib.contextmanager
def deterministic_mode():
    """cuDNN and PyTorch in deterministic mode and cuBLAS on a fixed
    workspace (``CUBLAS_WORKSPACE_CONFIG=:4096:8``) for the phase, restored
    after. ``warn_only``: an op without a deterministic implementation warns
    instead of raising, and the caller reports those warnings (yielded).
    Uninitialised memory is not filled (``fill_uninitialized_memory``): the
    fills are launches of their own on a host-bound step, and determinism
    does not need them."""
    import warnings

    import torch.utils.deterministic as det

    prev = (os.environ.get("CUBLAS_WORKSPACE_CONFIG"), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        if prev[0] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev[0]
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[1:3]
        torch.use_deterministic_algorithms(prev[3], warn_only=prev[4])
        det.fill_uninitialized_memory = prev[5]


def _fail_once(at: int):
    from repro_torch.runtime import InjectedFailure

    fired = []

    def hook(step):
        if step == at and not fired:
            fired.append(step)
            raise InjectedFailure(f"injected failure before step {step}")

    return hook


def _state_of(path: str):
    """Every array of a checkpoint's ``state.npz``: sha256 digests, and the
    model's arrays themselves."""
    import hashlib

    digests, params = {}, {}
    with np.load(os.path.join(path, "state.npz")) as z:
        for k in z.files:
            a = z[k]
            digests[k] = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            if k.startswith("params/"):
                params[k] = a
    return digests, params


def resilient_fit(counters, cfg, rehearsal, res, hook=None, keep_carry=False,
                  tasks=TASKS_RUN):
    """One resilient fit of phase 5's configuration (``rehearsal`` for the
    buffer) over ``tasks`` tasks, with checkpoints in a temporary directory,
    deleted after. Every counter is set to 0 just before ``fit`` and read
    just after. Returns the result, the launches, the final per-task
    checkpoint (digests and model arrays), and with ``keep_carry`` the final
    state restored into a fresh carry, with its restore timed and a
    synchronous save of it (bytes, snapshot and write seconds)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager

    tmp = tempfile.mkdtemp(prefix="repro_phase18_")
    try:
        trainer = class_incremental_trainer(cfg, rehearsal, ckpt_dir=tmp, resilience=res,
                                            overrides={"failure_hook": hook} if hook else None)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit(num_tasks=tasks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        final = _state_of(os.path.join(tmp, f"step_{tasks - 1:010d}"))
        carry = timing = None
        if keep_carry:
            template = trainer._init(trainer.seed)
            t0 = time.perf_counter()
            carry, _ = CheckpointManager(tmp).restore(template)
            restore = time.perf_counter() - t0
            mgr = CheckpointManager(os.path.join(tmp, "timed"), async_save=False)
            mgr.save(0, carry)
            timing = dict(mgr.last_save, restore_seconds=restore)
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return result, launches, final, wall, carry, timing


def _prints(result):
    return [(h["task"], h["step"], h["loss"], h["rep_checksum"], h["buffer_fill"])
            for h in result.history]


def _max_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a)


def resilient_case(counters, cfg, name, rehearsal, float_kernels, base_ms):
    """Cases (a) and (b): a clean resilient fit, then one with a failure
    injected before step ``RES_FAIL_AT``. Holds: restarts 0 then 1; the
    histories (loss, ``rep_checksum``, ``buffer_fill``), losses, accuracy
    matrices and final checkpoints (model, optimizer, buffer, pending slot)
    bit for bit; update+sample launches (3 a tiered step) and the float
    kernels' once a step, replayed steps included; restore seconds above 0.
    When the two runs differ, a second clean run measures the card's own
    spread: if it differs too, that is reported, the fingerprints are held
    bit for bit and the losses and the model within that spread."""
    from repro_torch.configs.base import ResilienceConfig

    res = ResilienceConfig(checkpoint_every=RES_EVERY, max_restarts=2)
    steps = TASKS_RUN * STEPS_PER_TASK
    clean, cl_launch, cl_final, cl_wall, _, _ = resilient_fit(counters, cfg, rehearsal, res)
    chaos, ch_launch, ch_final, ch_wall, carry, timing = resilient_fit(
        counters, cfg, rehearsal, res, hook=_fail_once(RES_FAIL_AT), keep_carry=True)
    per_step = 3 if rehearsal.get("tiering") == "host" else 1
    step_ms = statistics.median(clean.step_seconds) * 1e3
    print(f"{name}: clean fit {cl_wall:.1f} s, failed fit {ch_wall:.1f} s; restarts "
          f"{clean.restarts}, {chaos.restarts}; restore {chaos.resilience_stats}; "
          f"median step {step_ms:.1f} ms (all {[round(t * 1e3, 1) for t in clean.step_seconds]})"
          f" beside phase 5's {base_ms}")
    snap, write = timing["snapshot_seconds"] * 1e3, timing["write_seconds"] * 1e3
    print(f"  checkpoint {timing['bytes'] / 1e9:.3f} GB: save {snap + write:.1f} ms "
          f"(snapshot {snap:.1f} ms: card to host and host copies; write {write:.1f} ms), "
          f"restore {timing['restore_seconds'] * 1e3:.1f} ms")
    print(f"  launches clean {({k: v for k, v in cl_launch.items() if v})}, failed "
          f"{({k: v for k, v in ch_launch.items() if v})}")
    want = {k: 0 for k in counters}
    for run_launches, n in ((cl_launch, steps), (ch_launch, steps + RES_REPLAYED)):
        w = dict(want, rehearsal_update_sample=per_step * n, **{k: n for k in float_kernels})
        if run_launches != w:
            raise AssertionError(f"{name}: expected launches {w}, saw {run_launches}")
    if clean.restarts != 0 or chaos.restarts != 1:
        raise AssertionError(f"{name}: restarts {clean.restarts}, {chaos.restarts}")
    if not chaos.resilience_stats["restore_seconds"] > 0:
        raise AssertionError(f"{name}: restore_seconds {chaos.resilience_stats}")
    if not all(math.isfinite(x) for x in clean.losses + chaos.losses):
        raise AssertionError(f"{name}: non-finite losses {clean.losses} {chaos.losses}")
    same = (_prints(clean) == _prints(chaos) and clean.losses == chaos.losses
            and np.array_equal(clean.accuracy_matrix, chaos.accuracy_matrix)
            and cl_final[0] == ch_final[0])
    if same:
        print(f"  failed run == clean run bit for bit: {len(clean.history)} history "
              f"entries, {steps} losses, the accuracy matrix and all "
              f"{len(cl_final[0])} arrays of the final checkpoint")
    else:
        again = resilient_fit(counters, cfg, rehearsal, res)
        spread = max(abs(a - b) for a, b in zip(clean.losses, again[0].losses))
        p_spread = _max_diff(cl_final[1], again[2][1])
        print(f"  FINDING: the failed run differs from the clean one; two clean runs "
              f"differ by {spread:.3e} in loss and {p_spread:.3e} in the model")
        if spread == 0 and p_spread == 0:
            raise AssertionError(f"{name}: the clean runs agree bit for bit, the failed "
                                 f"run does not: {_prints(clean)} vs {_prints(chaos)}")
        fp = [(t, s, c, f) for t, s, _, c, f in _prints(clean)]
        if fp != [(t, s, c, f) for t, s, _, c, f in _prints(chaos)]:
            raise AssertionError(f"{name}: fingerprints differ: {_prints(chaos)}")
        loss_d = max(abs(a - b) for a, b in zip(clean.losses, chaos.losses))
        par_d = _max_diff(cl_final[1], ch_final[1])
        if loss_d > spread or par_d > p_spread:
            raise AssertionError(f"{name}: failed run off by {loss_d:.3e} (loss), "
                                 f"{par_d:.3e} (model), beyond the clean spread")
    return carry, step_ms, cl_launch, ch_launch


def record_multiset(state) -> dict:
    """Each tier's stored records as a multiset of (bucket, sha256 of every
    leaf's bytes), the labels included."""
    import collections
    import hashlib

    from repro_torch.buffer.state import tree_map
    from repro_torch.buffer.tiered import TieredState

    tiers = {"hot": state.hot, "cold": state.cold} if isinstance(state, TieredState) else {
        "flat": state}
    out = {}
    for tier, buf in tiers.items():
        counts = buf.counts.tolist()
        leaves = []
        tree_map(lambda leaf: leaves.append(leaf), buf.data)
        bag = collections.Counter()
        for b, n in enumerate(counts):
            for s in range(n):
                h = hashlib.sha256()
                for leaf in leaves:
                    h.update(leaf[b, s].detach().cpu().numpy().tobytes())
                bag[(b, h.hexdigest())] += 1
        out[tier] = bag
    return out


def scale_case(carry, policy: str, what: str):
    """Case (d): ``scale_carry`` 1 -> 2 -> 1 of a restored carry: every
    record kept (a multiset per tier), the cold tier still pinned."""
    from repro_torch.buffer.tiered import TieredState
    from repro_torch.runtime import scale_carry

    def pooled(carries):
        out = {}
        for c in carries:
            for tier, bag in record_multiset(c.buffer).items():
                out[tier] = out.get(tier, bag - bag) + bag
        return out

    before = pooled([carry])
    two, s_grow = scale_carry([carry], 2, policy=policy)
    one, s_shrink = scale_carry(two, 1, policy=policy)
    n = sum(sum(b.values()) for b in before.values())
    if pooled(two) != before or pooled(one) != before:
        raise AssertionError(f"{what}: records changed across 1 -> 2 -> 1")
    if isinstance(carry.buffer, TieredState):
        for c in two + one:
            for leaf in c.buffer.cold.data.values():
                if not all(t.is_pinned() for t in leaf.values()):
                    raise AssertionError(f"{what}: the cold tier left pinned memory")
    print(f"{what}: scale_carry 1 -> 2 in {s_grow * 1e3:.1f} ms, 2 -> 1 in "
          f"{s_shrink * 1e3:.1f} ms; all {n} records kept "
          f"({({t: sum(b.values()) for t, b in before.items()})})")


def online_resilient(counters, persistent: bool):
    """Case (e): ``OnlineLearner`` at SmolLM-135M full width on the serve
    CLI's ``--online`` run, ``RES_ONLINE_ROUNDS`` rounds, checkpoints every
    step. Transient: a failure before step 1, absorbed by a restart, every
    round trained. Persistent: every step from 1 fails, the budget is spent,
    every round is still served and serving ends on the last checkpoint's
    weights bit for bit."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ResilienceConfig
    from repro_torch.runtime import InjectedFailure
    from repro_torch.serving import OnlineLearner

    run = online_run("smollm-135m")
    run = dataclasses.replace(
        run, online=dataclasses.replace(run.online, rounds=RES_ONLINE_ROUNDS),
        resilience=ResilienceConfig(checkpoint_every=1, max_restarts=1 if persistent else 2))

    def dead(step):
        if step >= 1:
            raise InjectedFailure(f"train step {step} down")

    tmp = tempfile.mkdtemp(prefix="repro_phase18_online_")
    try:
        learner = OnlineLearner(run, ckpt_dir=tmp,
                                failure_hook=dead if persistent else _fail_once(1))
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = learner.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        trained = [int(h["trained"]) for h in res.history]
        name = "persistent" if persistent else "transient"
        print(f"(e) online, {name} failure: restarts {res.restarts}, trained {trained}, "
              f"freshness {[int(h['freshness']) for h in res.history]}, train disabled "
              f"{res.train_disabled}, launches {({k: v for k, v in launches.items() if v})}, "
              f"{seconds:.1f} s")
        if launches != dict({k: 0 for k in counters}, rehearsal_update_sample=sum(trained)):
            raise AssertionError(f"online {name}: launches {launches}")
        if len(res.history) != RES_ONLINE_ROUNDS:
            raise AssertionError(f"online {name}: {len(res.history)} rounds served")
        if persistent:
            if not res.train_disabled or trained != [1] + [0] * (RES_ONLINE_ROUNDS - 1):
                raise AssertionError(f"online persistent: trained {trained}")
            last, meta = CheckpointManager(os.path.join(tmp, "resilient")).restore(
                learner.trainer._init(learner.trainer.seed))
            if not _same_weights(res.params.state_dict(), last.params.state_dict()):
                raise AssertionError("online persistent: serving is not the last checkpoint")
            print(f"  serving == the last checkpoint's weights (step {meta['step']}) bit for bit")
        elif res.restarts < 1 or res.train_disabled or trained != [1] * RES_ONLINE_ROUNDS:
            raise AssertionError(f"online transient: restarts {res.restarts}, trained {trained}")
        del learner, res
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def train_cli_resilient(counters):
    """Case (f): ``launch.train.main`` at SmolLM-135M full width, 1 task x
    ``RES_CLI_STEPS`` steps, with ``--ckpt-dir --resilience
    --resilience-checkpoint-every 1``."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    tmp = tempfile.mkdtemp(prefix="repro_phase18_cli_")
    try:
        for fn in counters.values():
            fn.launches = 0
        res = train.main(["--arch", "smollm-135m", "--tasks", "1", "--steps-per-task",
                          str(RES_CLI_STEPS), "--ckpt-dir", tmp, "--resilience",
                          "--resilience-checkpoint-every", "1"])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        steps = CheckpointManager(os.path.join(tmp, "resilient")).list_steps()
        print(f"(f) train CLI --resilience: losses {[round(x, 4) for x in res.losses]}, "
              f"restarts {res.restarts}, stats {res.resilience_stats}, restart checkpoints "
              f"{steps}, launches {({k: v for k, v in launches.items() if v})}")
        if (res.restarts or len(res.losses) != RES_CLI_STEPS
                or not all(math.isfinite(x) for x in res.losses)
                or steps != list(range(RES_CLI_STEPS + 1))
                or launches != dict({k: 0 for k in counters},
                                    rehearsal_update_sample=RES_CLI_STEPS)):
            raise AssertionError(f"train CLI --resilience: {res.losses}, {steps}, {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def resilient_phase(counters, cfg, fused_runs: dict):
    """Phase 18, in deterministic mode: (a) flat and (b) fused tiered
    restarts, (c) stale steps, (d) scale, (e) online, (f) the train CLI.
    Returns each run's launches by kernel."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ResilienceConfig
    from repro_torch.runtime import TRANSIENT_EXCEPTIONS

    print(f"card: {gpu_name_and_power()}; free disk under {tempfile.gettempdir()}: "
          f"{shutil.disk_usage(tempfile.gettempdir()).free / 1e9:.1f} GB (a flat checkpoint "
          f"is about 0.5 GB, and a run keeps up to 3 + {TASKS_RUN}); buffers cut to "
          f"{BUCKETS} x {RES_SLOTS} flat and {BUCKETS} x {RES_COLD} cold slots")
    print(f"retried: {[e.__name__ for e in TRANSIENT_EXCEPTIONS]}")
    base = fused_runs.get("flat")
    base_ms = f"{base[2]:.1f} ms" if base else "not run"
    launches = {}
    res_flat = dict(FLAT, slots_per_bucket=RES_SLOTS)
    with deterministic_mode() as caught:
        flat, flat_ms, launches["flat_clean"], launches["flat_failed"] = resilient_case(
            counters, cfg, "(a) flat", res_flat, (), base_ms)
        tiered, _, launches["tiered_fused_clean"], launches["tiered_fused_failed"] = \
            resilient_case(counters, cfg, "(b) tiered, fused kernels",
                           dict(tiered_rehearsal(True), cold_slots=RES_COLD),
                           ("gather_dequant_rows", "encode_scatter_rows"), base_ms)
        if not all(t.is_pinned() for leaf in tiered.buffer.cold.data.values()
                   for t in leaf.values()):
            raise AssertionError("(b): the restored cold tier is not in pinned memory")
        print("(b): the restored cold tier is in pinned memory")
        stale = ResilienceConfig(checkpoint_every=RES_EVERY, max_restarts=2,
                                 straggler_delay_prob=0.5, max_staleness=2)
        result, launches["stale"], _, wall, _, _ = resilient_fit(counters, cfg, res_flat, stale,
                                                                 tasks=1)
        n_stale, fresh = (int(result.resilience_stats["stale_steps"]),
                          launches["stale"]["rehearsal_update_sample"])
        steps = STEPS_PER_TASK
        print(f"(c) stale steps: {n_stale} of {steps}, update+sample launches {fresh}, "
              f"losses {result.losses}, {wall:.1f} s")
        if (not n_stale > 0 or fresh != steps - n_stale
                or not all(math.isfinite(x) for x in result.losses)):
            raise AssertionError(f"(c): stale {n_stale}, launches {launches['stale']}")
        scale_case(flat, "reservoir", "(d) flat")
        scale_case(tiered, "reservoir", "(d) tiered")
        del flat, tiered
        torch.cuda.empty_cache()
        launches["online_transient"] = online_resilient(counters, persistent=False)
        launches["online_persistent"] = online_resilient(counters, persistent=True)
        launches["train_cli"] = train_cli_resilient(counters)
    ops = sorted({str(w.message).split(" does not")[0] for w in caught
                  if "deterministic" in str(w.message)})
    print(f"ops without a deterministic implementation on this path: {ops or 'none'}")
    print(f"median resilient flat step {flat_ms:.1f} ms beside phase 5's {base_ms}")
    return launches


# ---------------------------------------------------------------------------
# phase 19: the mesh backend
# ---------------------------------------------------------------------------

# The train CLI's SmolLM-135M run of phase 19 (b): its defaults at full
# width, 1 task of MESH_LM_STEPS steps, a checkpoint every MESH_CKPT_EVERY.
MESH_LM_STEPS, MESH_CKPT_EVERY = 4, 2


@contextlib.contextmanager
def tf32_as_phase_5():
    """TF32 on for the phase, as phase 5 ran, restored after."""
    prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def mesh_flat(counters, cfg, base, base_losses):
    """(a) phase 5's flat configuration through ``ContinualTrainer(mesh=1x1,
    exchange='local')``: its ``(rep_checksum, buffer_fill)`` history equal
    to phase 5's (``base``) and its losses within rtol 1e-4 of phase 5's.
    Returns the update+sample launches and the median step in ms."""
    from repro_torch.launch.mesh import make_mesh

    trainer = class_incremental_trainer(cfg, FLAT, mesh=make_mesh((1, 1), ("data", "model")),
                                        exchange="local")
    losses = []
    launches, prints, step_ms = fit_flat(counters, trainer, "(a) flat, mesh 1x1, "
                                         "exchange='local'", losses)
    if prints != base[1]:
        raise AssertionError(f"(a) mesh fingerprints {prints} != phase 5's {base[1]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
    if len(losses) != len(base_losses) or rel > 1e-4:
        raise AssertionError(f"(a) losses {losses} vs phase 5's {base_losses}: rel {rel}")
    print(f"(a) fingerprints == phase 5's over {len(prints)} steps; largest relative loss "
          f"difference {rel:.3e}; median step {step_ms:.1f} ms beside phase 5's "
          f"{base[2]:.1f} ms")
    del trainer
    torch.cuda.empty_cache()
    return launches, step_ms


def mesh_tiered(counters, cfg, fused: bool, base_prints):
    """(c) phase 7's tiered store (unfused or fused kernels) through the mesh
    backend at 1x1, ``exchange='local'``, 1 task: 3 update+sample launches a
    step and the setting's int8 kernels once a step, the fingerprints of
    phase 7's first task, the cold tier pinned. Returns the launches."""
    from repro_torch.launch.mesh import make_mesh

    trainer = class_incremental_trainer(cfg, tiered_rehearsal(fused),
                                        mesh=make_mesh((1, 1), ("data", "model")),
                                        exchange="local")
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    result = trainer.fit(num_tasks=1)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    floats = ("encode_scatter_rows", "gather_dequant_rows") if fused else ("quantize_rows",)
    want = {name: STEPS_PER_TASK if name in floats else 0 for name in counters}
    want["rehearsal_update_sample"] = 3 * STEPS_PER_TASK
    prints = [(h["rep_checksum"], h["buffer_fill"]) for h in result.history]
    buffer = trainer.final_state[2]
    pinned = all(t.is_pinned() for leaf in buffer.cold.data.values() for t in leaf.values())
    print(f"(c) tiered {'fused' if fused else 'unfused'}, mesh 1x1: launches {launches}; "
          f"cold tier pinned {pinned}, placement {trainer.built.meta['cold_placement']}; "
          f"median step {statistics.median(result.step_seconds) * 1e3:.1f} ms")
    if launches != want:
        raise AssertionError(f"(c) expected launches {want}, saw {launches}")
    if prints != base_prints[:STEPS_PER_TASK]:
        raise AssertionError(f"(c) mesh fingerprints {prints} != phase 7's {base_prints}")
    if not pinned or trainer.built.meta["cold_placement"] != "pinned_host":
        raise AssertionError("(c) the cold tier is not in pinned host memory")
    if not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"(c) non-finite losses {result.losses}")
    del trainer, result, buffer
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def world_of_one(rendezvous: str):
    """The ``runtime.multiproc`` environment of a one-rank group meeting
    through ``rendezvous``, restored after."""
    from repro_torch.runtime import multiproc

    keys = (multiproc.ENV_RENDEZVOUS, multiproc.ENV_NPROCS, multiproc.ENV_PID)
    prev = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict(zip(keys, (rendezvous, "1", "0"))))
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mesh_lm_cli(counters, lm_ms):
    """(b) SmolLM-135M at full width through ``launch.train.main(["--mesh",
    "1x1", "--exchange", "full", "--ckpt-every", "2", ...])`` in a world-1
    NCCL group (the CLI joins it through ``runtime.multiproc``), in
    deterministic mode: one update+sample launch a step and no other kernel,
    ``all_to_all_single`` on the card for every record leaf and the valid
    mask each step, a 1-row pending slot, finite losses. Then a new world-1
    group restores the step-2 checkpoint, replays steps 2-3, and ends on the
    step-4 checkpoint bit for bit. Returns the launches."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import snapshot
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import shard_host_batch
    from repro_torch.rng import fold_in
    from repro_torch.runtime import multiproc
    from repro_torch.scenario import ContinualTrainer, TokenClassIncremental

    tmp = tempfile.mkdtemp(prefix="mesh_phase_")
    flags = ["--arch", "smollm-135m", "--mesh", "1x1", "--exchange", "full", "--tasks", "1",
             "--steps-per-task", str(MESH_LM_STEPS), "--ckpt-every", str(MESH_CKPT_EVERY),
             "--ckpt-dir", os.path.join(tmp, "ckpt")]
    a2a, calls = dist.all_to_all_single, []

    def counted(out, inp, *args, **kwargs):
        calls.append((inp.device.type, dist.get_backend(kwargs.get("group"))))
        return a2a(out, inp, *args, **kwargs)

    try:
        with deterministic_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters.values():
                fn.launches = 0
            dist.all_to_all_single = counted
            try:
                with world_of_one(os.path.join(tmp, "rendezvous")):
                    res = train_cli.main(flags)
            finally:
                dist.all_to_all_single = a2a
            torch.cuda.synchronize()
            launches = {k: fn.launches for k, fn in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            step_ms = statistics.median(res.step_seconds) * 1e3
            leaves = 3  # tokens, labels, task; then the valid mask
            print(f"(b) SmolLM-135M through the train CLI, mesh 1x1, exchange full, world-1 "
                  f"group: losses {[round(x, 4) for x in res.losses]}; launches "
                  f"{({k: v for k, v in launches.items() if v})}; all_to_all_single calls "
                  f"{len(calls)} on {sorted(set(calls))}; median step {step_ms:.2f} ms "
                  f"beside phase 15's SmolLM-135M {lm_ms}; peak device memory "
                  f"{peak / 2**30:.2f} GiB")
            want = dict({k: 0 for k in counters}, rehearsal_update_sample=MESH_LM_STEPS)
            if launches != want:
                raise AssertionError(f"(b) expected launches {want}, saw {launches}")
            if calls != [("cuda", "nccl")] * ((leaves + 1) * MESH_LM_STEPS):
                raise AssertionError(f"(b) all_to_all_single calls {calls}")
            if not all(math.isfinite(x) for x in res.losses):
                raise AssertionError(f"(b) non-finite losses {res.losses}")
            # the restart, in a new world-1 group
            with world_of_one(os.path.join(tmp, "rendezvous2")):
                multiproc.init_from_env("nccl")
            try:
                run = train_cli.build_run(train_cli.parse_args(flags))
                mesh = make_mesh((1, 1), ("data", "model"))
                trainer = ContinualTrainer(run, TokenClassIncremental(run.scenario),
                                           device="cuda", mesh=mesh, exchange="full",
                                           ckpt_dir=os.path.join(tmp, "ckpt"))
                state, meta = trainer.restore_mesh_state(step=MESH_CKPT_EVERY)
                step = trainer.mesh_step()
                for s in range(int(meta["global_step"]), MESH_LM_STEPS):
                    batch = shard_host_batch(trainer.scenario.batch(0, LM_BATCH, s), mesh)
                    state, _ = step(state, batch, fold_in(run.scenario.seed, s))
                want_state, _ = trainer.restore_mesh_state(step=MESH_LM_STEPS)
                got, ref = snapshot(state)[0], snapshot(want_state)[0]
                same = set(got) == set(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
                rows = int(want_state[4].shape[0])
                print(f"(b) pending slot {rows} row(s), valid {want_state[4].tolist()}; "
                      f"step-{MESH_CKPT_EVERY} checkpoint restored and replayed to step "
                      f"{MESH_LM_STEPS}: {len(ref)} leaves bit for bit {same}")
                if rows != 1 or not bool(want_state[4].all()):
                    raise AssertionError(f"(b) the pending slot holds {rows} rows")
                if not same:
                    bad = [k for k in ref if not np.array_equal(got[k], ref[k])]
                    raise AssertionError(f"(b) the replay differs from the step-"
                                         f"{MESH_LM_STEPS} checkpoint in {bad[:8]}")
                del trainer, state, want_state, step, got, ref
            finally:
                gc.collect()
                dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return launches, step_ms


def mesh_phase(counters, cfg, fused_runs: dict, base_losses: list, lm_runs: dict):
    """Phase 19: (a) and (c) on the ResNet with TF32 on (phase 5's
    setting; phases 5 and 7 run here when they did not), then (b) on the LM
    with TF32 off (phase 15's). Returns each run's launches by kernel."""
    print(f"card: {gpu_name_and_power()}")
    launches = {}
    with tf32_as_phase_5():
        if "flat" not in fused_runs:
            base_losses.clear()
            fused_runs["flat"] = main_path(counters, cfg, losses_out=base_losses)
        flat, flat_ms = mesh_flat(counters, cfg, fused_runs["flat"], base_losses)
        launches["flat_1x1_local"] = {"rehearsal_update_sample": flat}
        for fused in (False, True):
            name = f"tiered, {'fused' if fused else 'unfused'}"
            if name not in fused_runs:
                fused_runs[name] = tiered_main_path(counters, cfg, fused)
            launches[f"tiered_{'fused' if fused else 'unfused'}_1x1_local"] = mesh_tiered(
                counters, cfg, fused, fused_runs[name][1])
    lm, lm_cli = lm_runs.get("smollm-135m"), lm_runs.get("smollm-135m train CLI")
    lm_ms = f"{lm['step_ms']:.2f} ms" if lm else "not run"
    launches["smollm_cli_1x1_nccl"], cli_ms = mesh_lm_cli(counters, lm_ms)
    print(f"median steps: (a) flat mesh {flat_ms:.1f} ms beside phase 5's "
          f"{fused_runs['flat'][2]:.1f} ms; (b) SmolLM-135M CLI {cli_ms:.2f} ms beside phase "
          f"15's carry run {lm_ms} and phase 15's CLI run (no checkpoint, not deterministic) "
          + (f"{lm_cli['step_ms']:.2f} ms" if lm_cli else "not run"))
    return launches




# ---------------------------------------------------------------------------
# phase 20: telemetry on the main path, and an agreed restart
# ---------------------------------------------------------------------------

# Phase 20's cuts: phase 5's configuration for 1 task of STEPS_PER_TASK
# steps; restart checkpoints every OBS_RES_EVERY steps and a failure before
# step OBS_FAIL_AT, so that the step-2 checkpoint is restored and one step
# replays. Serving: SmolLM-135M at full width, a short prompt and generation.
OBS_RES_EVERY, OBS_FAIL_AT, OBS_PROMPT, OBS_GEN = 2, 3, 8, 8


def _fingerprint_rows(result):
    return [(h["loss"], h["rep_checksum"], h["buffer_fill"]) for h in result.history]


def _zero(counters):
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0


def _read(counters) -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counters.items()}


def _state_tensors(tree, path=""):
    """``(path, tensor or host value)`` of every leaf of a state tuple."""
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.named_parameters():
            yield f"{path}/{name}", t.detach()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_tensors(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _state_tensors(v, f"{path}/{i}")
    elif tree is not None:
        yield path, tree


def _same_state(a, b) -> bool:
    la, lb = list(_state_tensors(a)), list(_state_tensors(b))
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(la, lb))


def obs_toggle(counters, cfg, tmp: str):
    """(a) phase 5's flat configuration, 1 task, each run checkpointing its
    task, in turns: obs off, on (with ``dir``), on, off. The histories of
    loss, ``rep_checksum`` and ``buffer_fill`` bit for bit, the same
    launches, ``obs/fill`` equal to ``buffer_fill`` every step, and a valid
    ``trace.json`` with ``eval`` and ``checkpoint_save`` spans. The medians
    leave out each fit's first step (the card's set-up, 3.4 s in the first
    fit of a process). Returns the launches of each setting."""
    from repro_torch import obs
    from repro_torch.configs.base import ObsConfig

    runs, launches, steps = [], {}, {"off": [], "on": []}
    for i, name in enumerate(("off", "on", "on", "off")):
        ocfg = (ObsConfig(enabled=True, dir=os.path.join(tmp, "obs_a")) if name == "on"
                else ObsConfig())
        trainer = class_incremental_trainer(cfg, FLAT, obs=ocfg,
                                            ckpt_dir=os.path.join(tmp, f"ckpt_a_{i}"))
        _zero(counters)
        result = trainer.fit(num_tasks=1)
        launches[name] = _read(counters)
        runs.append((name, result))
        steps[name] += [t * 1e3 for t in result.step_seconds[1:]]
        del trainer
        torch.cuda.empty_cache()
    obs.shutdown()
    off, on = runs[0][1], runs[1][1]
    ms = {k: statistics.median(v) for k, v in steps.items()}
    print(f"(a) flat, 1 task x {STEPS_PER_TASK} steps, fits off, on, on, off: median step "
          f"(steps 2-{STEPS_PER_TASK} of each fit) obs off {ms['off']:.2f} ms, obs on "
          f"{ms['on']:.2f} ms; all steps "
          f"{[(n, [round(t * 1e3, 1) for t in r.step_seconds]) for n, r in runs]}; launches "
          f"{({k: v for k, v in launches['on'].items() if v})}")
    print(f"(a) gauges of the last step: "
          f"{ {k: v for k, v in on.history[-1].items() if k.startswith('obs/')} }")
    for name, r in runs:
        if _fingerprint_rows(r) != _fingerprint_rows(off) or r.losses != off.losses:
            raise AssertionError(f"(a) obs {name} changed the run: {_fingerprint_rows(off)} "
                                 f"vs {_fingerprint_rows(r)}")
    want = dict({k: 0 for k in counters}, rehearsal_update_sample=STEPS_PER_TASK)
    if launches["off"] != want or launches["on"] != want:
        raise AssertionError(f"(a) launches {launches}, expected {want}")
    if [h["obs/fill"] for h in on.history] != [h["buffer_fill"] for h in on.history]:
        raise AssertionError(f"(a) obs/fill != buffer_fill: {on.history}")
    if off.obs is not None or "obs/grad_norm" not in on.obs:
        raise AssertionError(f"(a) result.obs {off.obs} / {on.obs}")
    with open(os.path.join(tmp, "obs_a", "trace.json")) as f:
        doc = json.load(f)
    problems = obs.validate_trace(doc)
    spans = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    print(f"(a) trace.json: {len(doc['traceEvents'])} events, spans {sorted(spans)}, "
          f"problems {problems}")
    if problems or not {"eval", "checkpoint_save"} <= spans:
        raise AssertionError(f"(a) trace: {problems}, spans {spans}")
    return launches


def obs_toggle_tiered(counters, cfg):
    """(a) on phase 7's fused tiered store, 1 task: obs off, then on. The
    histories bit for bit, the same launches (3 update+sample, one
    ``encode_scatter_rows`` and one ``gather_dequant_rows`` a step), the
    tiered gauges present and ``obs/fill`` equal to ``buffer_fill``.
    Returns the launches of each run."""
    from repro_torch.configs.base import ObsConfig

    runs, launches = {}, {}
    for name, ocfg in (("off", ObsConfig()), ("on", ObsConfig(enabled=True))):
        trainer = class_incremental_trainer(cfg, tiered_rehearsal(True), obs=ocfg)
        _zero(counters)
        runs[name] = trainer.fit(num_tasks=1)
        launches[name] = _read(counters)
        del trainer
        torch.cuda.empty_cache()
    off, on = runs["off"], runs["on"]
    last = {k: v for k, v in on.history[-1].items() if k.startswith("obs/")}
    print(f"(a) fused tiered, 1 task x {STEPS_PER_TASK} steps: median step (steps 2-"
          f"{STEPS_PER_TASK}) obs off {statistics.median(off.step_seconds[1:]) * 1e3:.2f} ms, "
          f"on {statistics.median(on.step_seconds[1:]) * 1e3:.2f} ms; launches "
          f"{({k: v for k, v in launches['on'].items() if v})}; gauges of the last step {last}")
    if _fingerprint_rows(off) != _fingerprint_rows(on) or off.losses != on.losses:
        raise AssertionError(f"(a) tiered: obs on changed the run: {_fingerprint_rows(off)} "
                             f"vs {_fingerprint_rows(on)}")
    want = dict({k: 0 for k in counters}, rehearsal_update_sample=3 * STEPS_PER_TASK,
                encode_scatter_rows=STEPS_PER_TASK, gather_dequant_rows=STEPS_PER_TASK)
    if launches["off"] != want or launches["on"] != want:
        raise AssertionError(f"(a) tiered: launches {launches}, expected {want}")
    if ([h["obs/fill"] for h in on.history] != [h["buffer_fill"] for h in on.history]
            or not {"obs/hot_fill", "obs/cold_fill", "obs/demotions"} <= set(last)):
        raise AssertionError(f"(a) tiered gauges: {on.history}")
    return launches


def gauge_cost(carry, rcfg, calls: int = 20):
    """The host's time for one step's gauges on a live flat carry (each call
    ended by a synchronisation; their device work is a few small kernels):
    ``step_metrics`` whole, the parameter norm alone, and ``step_metrics``
    with its one read back (``read_gauges``)."""
    from repro_torch.configs.base import ObsConfig
    from repro_torch.obs.metrics import read_gauges, step_metrics, tree_l2

    norm, ocfg = torch.zeros((), device="cuda"), ObsConfig(enabled=True)

    def gauges():
        return step_metrics(buffer=carry.buffer, rcfg=rcfg, valid=carry.pipe.valid,
                            new_rows=BATCH, grad_norm=norm, params=carry.params,
                            staleness=1.0, cfg=ocfg)

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e3

    ms = {"step_metrics": timed(gauges), "param_norm": timed(lambda: tree_l2(carry.params)),
          "with_read": timed(lambda: read_gauges(gauges()))}
    print(f"(b) the gauges' host cost a step (ms, mean of {calls} calls each ended by a "
          f"synchronisation): {({k: round(v, 3) for k, v in ms.items()})}")


def phase_pipeline_case(counters, cfg, name: str, rehearsal):
    """(b) ``obs.PhasePipeline`` against the fused step (``make_cl_step``,
    the trainer's own) on the same batches, from the same initial carry:
    the loss, ``rep_checksum`` and ``buffer_fill`` of every step bit for
    bit. Prints the mean of each phase span and the fused step's time.
    Returns the launches of each."""
    from repro_torch.obs import PHASES, PhasePipeline, Tracer
    from repro_torch.optim import make_optimizer
    from repro_torch.rng import fold_in

    trainer = class_incremental_trainer(cfg, rehearsal)
    source, seed = trainer._source(0), trainer.seed
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in source(s).items()}
               for s in range(STEPS_PER_TASK)]
    pipeline = PhasePipeline(trainer.loss_fn, make_optimizer(trainer.run.train)[1],
                             trainer.rcfg, label_field=trainer.label_field,
                             task_field=trainer.scenario.buffer_task_field,
                             tracer=Tracer(enabled=True), device="cuda")
    prints, launches, step_ms = {}, {}, {}
    for form, step in (("fused", trainer._step_fn), ("phases", pipeline.step)):
        carry = trainer._init(seed)
        rows, times = [], []
        _zero(counters)
        for s, batch in enumerate(batches):
            t0 = time.perf_counter()
            carry, m = step(carry, batch, fold_in(seed, s))
            rows.append((float(m["loss"]), float(m["rep_checksum"]), float(m["buffer_fill"])))
            times.append((time.perf_counter() - t0) * 1e3)
        launches[form], prints[form], step_ms[form] = _read(counters), rows, times
        if form == "fused" and name == "flat":
            gauge_cost(carry, trainer.rcfg)
        del carry
        torch.cuda.empty_cache()
    stats = pipeline.tracer.span_stats()
    means = {p: round(stats[p]["mean_us"] / 1e3, 3) for p in PHASES if p in stats}
    print(f"(b) {name}: PhasePipeline {STEPS_PER_TASK} steps, phase means (ms, first step "
          f"included) {means}, their sum {sum(means.values()):.3f} ms; per step "
          f"{[round(t, 1) for t in step_ms['phases']]} ms; the fused step "
          f"{[round(t, 1) for t in step_ms['fused']]} ms; launches fused "
          f"{({k: v for k, v in launches['fused'].items() if v})}, phases "
          f"{({k: v for k, v in launches['phases'].items() if v})}")
    if prints["phases"] != prints["fused"]:
        raise AssertionError(f"(b) {name}: PhasePipeline {prints['phases']} != fused "
                             f"{prints['fused']}")
    if (rehearsal.get("tiering") != "host"
            and launches["phases"]["rehearsal_update_sample"] != 2 * STEPS_PER_TASK):
        # the fused step's one update+sample launch is two here: the update
        # (issue_sample), then the sample's gather (all_to_all)
        raise AssertionError(f"(b) {name}: launches {launches['phases']}")
    want = set(PHASES) if rehearsal.get("tiering") == "host" else set(PHASES) - {"demote_stage"}
    if set(stats) != want or any(v["count"] != STEPS_PER_TASK for v in stats.values()):
        raise AssertionError(f"(b) {name}: spans {stats}")
    del trainer, pipeline
    return launches


def agreed_restart(counters, cfg, tmp: str):
    """(c) phase 5's flat configuration through the mesh backend at 1x1
    (``exchange='local'``) in a world-1 NCCL group, so that the
    ``ResilientLoop``'s decisions run as collectives, with obs on: a clean
    resilient fit of 1 task, then one with a failure before step
    ``OBS_FAIL_AT``. Restarts 0 and 1, the histories, losses and the final
    state bit for bit; ``events.jsonl`` holds one ``restart`` and the trace
    one ``restore`` span. Returns the launches of each run."""
    import gc

    import torch.distributed as dist

    from repro_torch import obs
    from repro_torch.configs.base import ObsConfig, ResilienceConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    with world_of_one(os.path.join(tmp, "rendezvous_c")):
        multiproc.init_from_env("nccl")
    runs, states, launches = {}, {}, {}
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        res = ResilienceConfig(checkpoint_every=OBS_RES_EVERY, max_restarts=2)
        obs_dir = os.path.join(tmp, "obs_c")
        for name, ocfg, hook in (("clean", ObsConfig(enabled=True), None),
                                 ("failed", ObsConfig(enabled=True, dir=obs_dir),
                                  _fail_once(OBS_FAIL_AT))):
            trainer = class_incremental_trainer(
                cfg, FLAT, obs=ocfg, mesh=mesh, exchange="local",
                ckpt_dir=os.path.join(tmp, f"ckpt_c_{name}"), resilience=res,
                overrides={"failure_hook": hook} if hook else None)
            _zero(counters)
            runs[name] = trainer.fit(num_tasks=1)
            launches[name] = _read(counters)
            states[name] = trainer.final_state
            del trainer
        restores = [e for e in obs.get_tracer().events() if e["name"] == "restore"]
        obs.shutdown()
        events = obs.read_events(os.path.join(obs_dir, "events.jsonl"))
        same = _same_state(states["clean"], states["failed"])
        del states
    finally:
        gc.collect()
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    clean, failed = runs["clean"], runs["failed"]
    restarts = [e for e in events if e["kind"] == "restart"]
    replayed = OBS_FAIL_AT - OBS_FAIL_AT // OBS_RES_EVERY * OBS_RES_EVERY
    print(f"(c) mesh 1x1 in a world-1 NCCL group, restart checkpoints every {OBS_RES_EVERY}: "
          f"restarts {clean.restarts}, {failed.restarts}; restart events {restarts}; restore "
          f"span {[round(e['dur'] / 1e3, 1) for e in restores]} ms; resilience "
          f"{failed.resilience_stats}; launches clean "
          f"{({k: v for k, v in launches['clean'].items() if v})}, failed "
          f"{({k: v for k, v in launches['failed'].items() if v})}; final state bit for bit "
          f"{same}; median step {statistics.median(clean.step_seconds) * 1e3:.1f} ms")
    if clean.restarts != 0 or failed.restarts != 1 or len(restarts) != 1 or len(restores) != 1:
        raise AssertionError(f"(c) restarts {clean.restarts} {failed.restarts}, events "
                             f"{restarts}, restore spans {restores}")
    if (_fingerprint_rows(clean) != _fingerprint_rows(failed) or clean.losses != failed.losses
            or not same):
        raise AssertionError(f"(c) the failed run differs from the clean one: "
                             f"{_fingerprint_rows(clean)} vs {_fingerprint_rows(failed)}, "
                             f"state equal {same}")
    for name, n in (("clean", STEPS_PER_TASK), ("failed", STEPS_PER_TASK + replayed)):
        if launches[name] != dict({k: 0 for k in counters}, rehearsal_update_sample=n):
            raise AssertionError(f"(c) {name}: launches {launches[name]}")
    return launches


def serve_with_obs(tmp: str):
    """(d) ``serve --obs DIR --metrics-port 0`` at SmolLM-135M full width:
    the endpoint scraped once while it is up (just before the CLI shuts it
    down), its ``repro_serve_decode_tokens_per_second`` equal to the
    result's, and ``prefill`` and ``decode`` spans in the trace."""
    import urllib.request

    from repro_torch import obs
    from repro_torch.launch import serve

    real, scraped = obs.start_metrics_server, []

    def start(registry, port=0, host="127.0.0.1"):
        server, bound = real(registry, port=port, host=host)
        stop = server.shutdown

        def shutdown():
            url = f"http://127.0.0.1:{bound}/metrics"
            scraped.append(urllib.request.urlopen(url, timeout=30).read().decode())
            stop()

        server.shutdown = shutdown
        return server, bound

    d = os.path.join(tmp, "obs_d")
    obs.start_metrics_server = start
    try:
        res = serve.main(["--arch", "smollm-135m", "--batch", str(SERVE_B), "--prompt-len",
                          str(OBS_PROMPT), "--gen-len", str(OBS_GEN), "--obs", d,
                          "--metrics-port", "0"])
    finally:
        obs.start_metrics_server = real
    lines = [line for text in scraped for line in text.splitlines()
             if line.startswith("repro_serve_decode_tokens_per_second ")]
    with open(os.path.join(d, "trace.json")) as f:
        doc = json.load(f)
    spans = {e["name"]: e["dur"] / 1e3 for e in doc["traceEvents"] if e.get("ph") == "X"}
    print(f"(d) serve --obs --metrics-port 0, SmolLM-135M, batch {SERVE_B}, prompt "
          f"{OBS_PROMPT}, gen {OBS_GEN}: scraped {lines}; spans (ms) "
          f"{ {k: round(v, 2) for k, v in spans.items()} }; prefill "
          f"{res.prefill_seconds:.4f} s, decode {res.tokens_per_second:.1f} tok/s per sequence")
    if len(scraped) != 1 or lines != [f"repro_serve_decode_tokens_per_second "
                                      f"{res.tokens_per_second!r}"]:
        raise AssertionError(f"(d) scraped {scraped}")
    if obs.validate_trace(doc) or not {"prefill", "decode"} <= set(spans):
        raise AssertionError(f"(d) trace {obs.validate_trace(doc)}, spans {spans}")


def obs_phase(counters, cfg):
    """Phase 20, in deterministic mode, TF32 on for the ResNet (phase 5's
    setting): (a) the obs toggle, flat and fused tiered, (b) PhasePipeline
    flat and fused tiered,
    (c) an agreed restart with obs on, (d) serving with obs. Temporary
    directories are deleted after. Returns each run's launches by kernel."""
    import shutil
    import tempfile

    print(f"card: {gpu_name_and_power()}")
    tmp = tempfile.mkdtemp(prefix="repro_phase20_")
    launches = {}
    try:
        with deterministic_mode(), tf32_as_phase_5():
            a = obs_toggle(counters, cfg, tmp)
            launches["obs_off"], launches["obs_on"] = a["off"], a["on"]
            a = obs_toggle_tiered(counters, cfg)
            launches["obs_off_tiered_fused"] = a["off"]
            launches["obs_on_tiered_fused"] = a["on"]
            for name, rehearsal in (("flat", FLAT), ("tiered_fused", tiered_rehearsal(True))):
                b = phase_pipeline_case(counters, cfg, name, rehearsal)
                launches[f"phase_pipeline_{name}"] = b["phases"]
                launches[f"fused_{name}"] = b["fused"]
            c = agreed_restart(counters, cfg, tmp)
            launches["restart_clean"], launches["restart_failed"] = c["clean"], c["failed"]
        serve_with_obs(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 21: the MoE and hybrid stacks at full width
# ---------------------------------------------------------------------------

# Published widths; depth cut to a whole period of the layer pattern (arch:
# layers, prefill batch, prefill length). Mixtral: every layer MoE, its
# long-context prefill at S 8192, where the 4096 window masks half the keys
# of the later queries; Phi-3.5-MoE at phase 11's prefill; Jamba: one unit
# of 8 layers (attention at 4, MoE at the odd ones).
MOE_CUTS = {"mixtral-8x7b": (4, 1, 8192), "phi3.5-moe-42b-a6.6b": (4, 4, 2048),
            "jamba-v0.1-52b": (8, 4, 2048)}
MOE_SEED = 21


def draw_on_card(cfg, max_seq: int, seed: int):
    """``cfg``'s weights drawn on the card from a CUDA generator seeded with
    ``seed`` (the init functions' ``torch.randn(..., generator=gen)`` draw
    there under a ``torch.device("cuda")`` context), and their count."""
    from repro_torch.models import build_model

    model = build_model(cfg)
    with torch.device("cuda"):
        params = model.init(torch.Generator(device="cuda").manual_seed(seed), max_seq,
                            device="cuda")
    torch.cuda.synchronize()
    if not all(p.is_cuda for p in params.parameters()):
        raise AssertionError(f"{cfg.name}: a weight was drawn off the card")
    return model, params, sum(p.numel() for p in params.parameters())


def moe_arch(arch: str):
    """(cfg, model, params) of ``arch`` at MOE_CUTS' depth, its weights drawn
    on the card from a CUDA generator seeded with MOE_SEED: the init
    functions' ``torch.randn(..., generator=gen)`` draw there under a
    ``torch.device("cuda")`` context (``LMWeights`` draws on the host, where
    a 2.5-2.8 B model takes tens of seconds; Jamba's cut is 13 B)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch), num_layers=MOE_CUTS[arch][0])
    t0 = time.perf_counter()
    model, params, n = draw_on_card(cfg, MOE_CUTS[arch][2], MOE_SEED)
    print(f"{arch}: {cfg.num_layers} of {get_config(arch).num_layers} layers at the published "
          f"widths (the host's share of a forward is larger than at full depth), "
          f"{n / 1e9:.3f} B parameters ({n * 4 / 1e9:.1f} GB f32) drawn on the card from "
          f"torch.Generator(device='cuda').manual_seed({MOE_SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, model, params


def moe_serving(arch, cfg, params, seed: int = 12):
    """DecodeEngine on the full-width weights at ``capacity_factor = E / k``
    (nothing drops in a prefill of 128 tokens or a decode step of 4): the
    decode logits at every prompt position against the teacher-forced
    forward with the kernels, the routing of that forward pinned to the
    decode loop's; then the serve CLI on the reduced config."""
    from repro_torch.launch import serve
    from repro_torch.models import StackCtx, build_model
    from repro_torch.serving import DecodeEngine
    from repro_torch.testdata import moved_pairs, routing

    cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    model = build_model(cfg)
    n_moe = _mixers(cfg)[2]
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                            generator=torch.Generator().manual_seed(seed + 1)).cuda()
    ctx = StackCtx(cfg)
    res = DecodeEngine(model, ctx).generate(params, prompts, GEN)
    with torch.no_grad():
        caches = model.init_cache(params, SERVE_B, PROMPT + GEN, dtype=torch.float32)
        outs = []
        with routing() as dec_calls:
            for t in range(PROMPT):
                logits, caches = model.decode(params, {"token": prompts[:, t:t + 1]}, caches, t,
                                              ctx)
                outs.append(logits)
        dec = torch.cat(outs, dim=1)
        first = torch.argmax(dec[:, -1], dim=-1)
        # the decode loop's routings (step-major, [4, k] each) as the
        # forward's (one a MoE layer over the 4 x 32 tokens, row-major)
        pins = []
        for layer in range(n_moe):
            steps = dec_calls[layer::n_moe]
            pins.append(tuple(torch.stack([c[j] for c in steps], dim=1).reshape(
                SERVE_B * PROMPT, -1) for j in (0, 1)))
        with routing(pins) as calls:
            full, _ = model.forward(params, {"tokens": prompts}, StackCtx(cfg, use_kernel=True))
    err = close(dec, full, 2e-3, 2e-3, f"{arch} decode vs teacher-forced forward")
    if not torch.equal(first, res.tokens[:, 0]):
        raise AssertionError(f"{arch}: the engine's first token differs from the decode loop's")
    print(f"{arch} DecodeEngine (capacity factor {cfg.capacity_factor:g}): decode logits at all "
          f"{PROMPT} prompt positions vs the teacher-forced forward (kernels, routing pinned to "
          f"the decode steps'; {moved_pairs(calls, pins)} of {2 * SERVE_B * PROMPT * n_moe} "
          f"pairs would choose another expert unpinned): max abs err {err:.3e} (atol = rtol = "
          f"2e-3); prefill {res.prefill_seconds:.3f} s, {res.tokens_per_second:.1f} tok/s per "
          f"sequence (batch {SERVE_B}, gen {GEN})")
    cli = serve.main(["--arch", arch, "--reduced", "--batch", str(SERVE_B), "--prompt-len",
                      str(PROMPT), "--gen-len", str(GEN), "--seed", str(seed)])
    if cli.tokens.shape != (SERVE_B, GEN) or cli.tokens.device.type != "cuda":
        raise AssertionError(f"bad generation {tuple(cli.tokens.shape)} {cli.tokens.device}")
    print(f"{arch} serve --reduced on the card (CLI path): prefill {cli.prefill_seconds:.3f} s, "
          f"{cli.tokens_per_second:.1f} tok/s per sequence")


def moe_reduced_card_against_cpu(arch, seed: int = 10):
    """The reduced config, the same weights on the CPU and on the card, B 1, S
    128, kernels on (their plain versions on the CPU), the card's routing
    pinned from the CPU's."""
    import copy

    from repro_torch.configs import get_reduced
    from repro_torch.models import StackCtx, build_model
    from repro_torch.testdata import moved_pairs, routing

    cfg = get_reduced(arch)
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(seed), 128, device="cpu")
    card = copy.deepcopy(host).to("cuda")
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        with routing() as pins:
            want, _ = model.forward(host, {"tokens": toks}, StackCtx(cfg, use_kernel=True))
        with routing(pins) as calls:
            got, _ = model.forward(card, {"tokens": toks.cuda()}, StackCtx(cfg, use_kernel=True))
            got = got.cpu()
    scale = float(want.abs().max())
    tol = 1e-4 * scale + 1e-5
    err = close(got, want, tol, 0.0, f"{arch} reduced card vs cpu")
    print(f"{arch} reduced ({cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_experts} "
          f"experts), B 1, S 128, kernels on the card vs plain versions on the CPU, routing "
          f"pinned from the CPU ({moved_pairs(calls, pins)} pairs would move unpinned): max "
          f"|card - cpu| {err:.3e} (tolerance {tol:.3e})")


def _window_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal attention over ``s`` positions computes
    with ``window`` (0: none)."""
    w = window or s
    return sum(min(i + 1, w) for i in range(s))


def flash_at(fa, ref, gen, shape, label: str, suffix: str) -> dict:
    """Flash attention at ``shape`` = (B, S, H, KV, hd, window), f32 and
    bf16: against its plain version, timed beside the plain version, SDPA
    with the window as its mask and the bound. Returns the kernels-line
    update, each key ending in ``suffix`` (``_bf16`` added for bf16)."""
    import torch.nn.functional as F

    b, s, h, kv, hd, win = shape
    out = {}
    pairs = _window_pairs(s, win)
    flops = 4 * b * h * hd * pairs  # QK^T and PV over the visible pairs
    qpos = torch.arange(s, device="cuda")
    mask = (qpos[None, :] <= qpos[:, None]) & (qpos[None, :] > qpos[:, None] - win)
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((b, s, h, hd), gen, dtype)
        k, v = _randn((b, s, kv, hd), gen, dtype), _randn((b, s, kv, hd), gen, dtype)
        got = fa.flash_attention(q, k, v, window=win)
        want = ref.flash_attention_ref(q, k, v, window=win)
        torch.cuda.synchronize()
        err = close(got.float(), want.float(), *FLASH_TOL[dtype], f"flash {label} {dtype}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_err = abs_err(library().transpose(1, 2).float(), want.float())
        del got, want
        ms = time_ms(lambda: fa.flash_attention(q, k, v, window=win))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, window=win), iters=5)
        library_ms = time_ms(library, iters=10)
        nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (3 * flops / TF32_FLOPS if dtype == torch.float32 else flops / BF16_FLOPS) * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        key = suffix + ("" if dtype == torch.float32 else "_bf16")
        print(f"flash_attention at {label} q [{b}, {s}, {h}, {hd}], k/v [{b}, {s}, "
              f"{kv}, {hd}], window {win}, {dtype}: max abs err {err:.3e} vs plain (atol, rtol "
              f"{FLASH_TOL[dtype]}), SDPA {lib_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f}"
              f" ms, SDPA (the window as a boolean mask) {library_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {by} ({flops / 1e9:.2f} GFLOP over {pairs} visible pairs a "
              f"head, {'3 x at TF32' if dtype == torch.float32 else 'at bf16'}; {nbytes} B = "
              f"{bytes_ms:.4f} ms); kernel at {bound_ms / ms:.3f} of its bound")
        out.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms, f"bound_ms{key}": bound_ms,
                    f"bound_by{key}": by, f"library_ms{key}": library_ms,
                    f"max_abs_err{key}": err})
        del q, k, v, qt, kt, vt
    return out


def scan_at(ssd, ref, gen, shape, label: str, suffix: str) -> dict:
    """The SSD scan at ``shape`` = (B, S, H, P, N, chunk), f32 and bf16:
    against its plain version (and stage by stage), timed beside it, and
    the bound. Returns the kernels-line update (keys as ``flash_at``'s)."""
    b, s, h, p, n, chunk = shape
    out = {}
    nc = s // chunk
    flops = b * nc * (chunk * (chunk + 1) * n + h * (chunk * (chunk + 1) * p + 4 * chunk * n * p))
    for dtype, peak in ((torch.float32, F32_FLOPS), (torch.bfloat16, BF16_FLOPS)):
        args = _ssd_inputs(gen, b, s, h, p, n, dtype)  # dt = softplus(.) >= 0, A = -exp(.) < 0
        tol = (5e-4, 1e-3) if dtype == torch.float32 else (2e-2, 2e-2)
        err = close(ssd.ssd_scan(*args, chunk=chunk).float(),
                    ssd_plain(ref, *args, chunk).float(), *tol, f"ssd {label} {dtype}")
        stage_err = ssd_stages(ssd, ref, *args, chunk)
        ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk))
        plain_ms = time_ms(lambda: ssd_plain(ref, *args, chunk), iters=10)
        width = args[0].element_size()
        nbytes = 2 * args[0].numel() * width + 2 * args[1].numel() * 4 + 2 * args[3].numel() * width
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        key = suffix + ("" if dtype == torch.float32 else "_bf16")
        print(f"ssd_scan at {label} x [{b}, {s}, {h}, {p}], B/C [{b}, {s}, {n}], chunk "
              f"{chunk}, {dtype}: max abs err {err:.3e} vs plain (atol, rtol {tol}), stages "
              f"{stage_err:.3e}; {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"by {by} ({flops / 1e9:.2f} GFLOP = {ops_ms:.4f} ms; {nbytes} B = "
              f"{bytes_ms:.4f} ms); kernels at {bound_ms / ms:.3f} of their bound")
        out.update({f"ms{key}": ms, f"plain_ms{key}": plain_ms, f"bound_ms{key}": bound_ms,
                    f"bound_by{key}": by, f"max_abs_err{key}": err})
        del args
    return out


def moe_kernel_shapes(fa, ssd, ref):
    """Flash attention at Mixtral's prefill (B 1, S 8192, H 32, KV 8, hd 128,
    window 4096) and the SSD scan at Jamba's (B 4, S 2048, H 128, P 64, N
    16, chunk 128), f32 and bf16: against their plain versions, timed beside
    the plain version, SDPA with the window as its mask (flash) and the
    bound. Returns the two kernels-line updates."""
    gen = torch.Generator().manual_seed(21)
    flash = flash_at(fa, ref, gen, (1, 8192, 32, 8, 128, 4096), "Mixtral's prefill",
                     "_hd128_swa")
    scan = scan_at(ssd, ref, gen, (4, 2048, 128, 64, 16, 128), "Jamba's prefill", "_jamba")
    return flash, scan


def moe_phase(counters, fa, ssd, ref):
    """Phase 21: the kernels at the new shapes, then each arch in turn (its
    weights freed before the next): prefill, serving, the reduced config on
    the card against the CPU. Returns (launches per f32 forward by arch, the
    flash and scan entries' updates)."""
    flash, scan = moe_kernel_shapes(fa, ssd, ref)
    torch.cuda.empty_cache()
    launches = {}
    for arch in MOE_CUTS:
        cfg, model, params = moe_arch(arch)
        launches[arch] = _prefill_arch(counters, ssd, arch, cfg, model, params,
                                       *MOE_CUTS[arch][1:])
        moe_serving(arch, cfg, params)
        del params
        torch.cuda.empty_cache()
        moe_reduced_card_against_cpu(arch)
    return launches, flash, scan


# ---------------------------------------------------------------------------
# phase 22: the enc-dec and VLM stacks served, the MoE and hybrid stacks trained
# ---------------------------------------------------------------------------

# Qwen2-VL-72B at its published width cut to 2 of 80 layers (for time; the
# whole model is 288 GB f32); Whisper-tiny whole, at its published
# context of 1500 encoder frames and 448 decoder tokens; training cuts
# Mixtral-8x7B to 1 layer at its published widths (1.71 B parameters,
# about 28 B a parameter at AdamW's peak) and runs Jamba-v0.1 reduced (one full-width unit is 13.3 B parameters, 370 GB
# under AdamW).
VLM_ARCH, VLM_LAYERS, VLM_SEED = "qwen2-vl-72b", 2, 22
WHISPER_B, WHISPER_FRAMES, WHISPER_TOKENS = 8, 1500, 448
TRAIN_CUTS = {"mixtral-8x7b": 1, "jamba-v0.1-52b": 0}  # 0: reduced
TRAIN_TASKS, TRAIN_STEPS = 2, 4


def _to_card(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}


def vlm_kernel_shape(fa, ref):
    """Flash attention at Qwen2-VL-72B's prefill (B 4, S 2048, H 64, KV 8:
    8 query heads a KV head, hd 128, causal, no window), f32 and bf16,
    against its plain version; timed beside the plain version, SDPA and the
    bound. Returns the flash entry's update."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(22)
    b, s, h, kv, hd = PREFILL_B, PREFILL_S, 64, 8, 128
    pairs = _window_pairs(s, 0)
    flops = 4 * b * h * hd * pairs  # QK^T and PV over the visible pairs
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn((b, s, h, hd), gen, dtype)
        k, v = _randn((b, s, kv, hd), gen, dtype), _randn((b, s, kv, hd), gen, dtype)
        got = fa.flash_attention(q, k, v)
        want = ref.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = close(got.float(), want.float(), *FLASH_TOL[dtype], f"flash Qwen2-VL {dtype}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        lib_err = abs_err(library().transpose(1, 2).float(), want.float())
        del got, want
        ms = time_ms(lambda: fa.flash_attention(q, k, v))
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v), iters=5)
        library_ms = time_ms(library, iters=10)
        nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = (3 * flops / TF32_FLOPS if dtype == torch.float32 else flops / BF16_FLOPS) * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        suffix = "_hd128_g8" + ("" if dtype == torch.float32 else "_bf16")
        print(f"flash_attention at Qwen2-VL-72B's prefill q [{b}, {s}, {h}, {hd}], k/v [{b}, "
              f"{s}, {kv}, {hd}] (G = {h // kv}), causal, {dtype}: max abs err {err:.3e} vs "
              f"plain (atol, rtol {FLASH_TOL[dtype]}), SDPA {lib_err:.3e}; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
              f"{by} ({flops / 1e9:.2f} GFLOP over {pairs} visible pairs a head, "
              f"{'3 x at TF32' if dtype == torch.float32 else 'at bf16'}; {nbytes} B = "
              f"{bytes_ms:.4f} ms); kernel at {bound_ms / ms:.3f} of its bound")
        out.update({f"ms{suffix}": ms, f"plain_ms{suffix}": plain_ms,
                    f"bound_ms{suffix}": bound_ms, f"bound_by{suffix}": by,
                    f"library_ms{suffix}": library_ms, f"max_abs_err{suffix}": err})
        del q, k, v, qt, kt, vt
    return out


def vlm_path(counters, ssd):
    """Qwen2-VL-72B at its published width, 2 layers (VLM_LAYERS): the prefill of B 4 x S
    2048 patch-stub embeddings at the image block's M-RoPE positions
    (``repro_torch.testdata.family_batch``) with the kernels against the
    plain path, f32 and bf16 (phase 11's bounds, 4 flash launches a
    forward); then DecodeEngine on token prompts, its decode logits at every
    prompt position against the teacher-forced forward with the kernels, and
    the serve CLI on the reduced config. Returns the launches a forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.testdata import family_batch

    cfg = dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    model, params, n = draw_on_card(cfg, PREFILL_S, VLM_SEED)
    print(f"{VLM_ARCH}: {VLM_LAYERS} of {get_config(VLM_ARCH).num_layers} layers at the "
          f"published widths, {n / 1e9:.3f} B parameters ({n * 4 / 1e9:.1f} GB f32) drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    batch = _to_card({k: v for k, v in family_batch(cfg, PREFILL_B, PREFILL_S, seed=2).items()
                      if k != "labels"})
    pos = batch["positions"][0]
    block = int((pos[:, 0] == 0).sum())  # the patches' t is 0, the text's past the block
    rows, cols = int(pos[:block, 1].max()) + 1, int(pos[:block, 2].max()) + 1
    print(f"{VLM_ARCH} inputs: embeddings {tuple(batch['embeddings'].shape)}, M-RoPE positions "
          f"{tuple(batch['positions'].shape)}: an image block of {rows} x {cols} patches at "
          f"(0, row, col), then {PREFILL_S - rows * cols} text positions from "
          f"{int(pos[rows * cols, 0])} in all three components")
    launches = _prefill_arch(counters, ssd, VLM_ARCH, cfg, model, params, batch=batch)
    del batch
    torch.cuda.empty_cache()
    _decode_arch(VLM_ARCH, cfg, model, params, seed=12)  # token prompts, 1-D positions
    del params
    torch.cuda.empty_cache()
    cli = serve.main(["--arch", VLM_ARCH, "--reduced", "--batch", str(SERVE_B), "--prompt-len",
                      str(PROMPT), "--gen-len", str(GEN), "--seed", "12"])
    if cli.tokens.shape != (SERVE_B, GEN) or cli.tokens.device.type != "cuda":
        raise AssertionError(f"bad generation {tuple(cli.tokens.shape)} {cli.tokens.device}")
    print(f"{VLM_ARCH} serve --reduced on the card (CLI path): prefill "
          f"{cli.prefill_seconds:.3f} s, {cli.tokens_per_second:.1f} tok/s per sequence")
    return launches


def whisper_path(counters):
    """Whisper-tiny whole: B 8 x 1500 frames x 448 tokens, the kernel flag on,
    f32 on the card against the same forward on the CPU, bf16 bit for bit
    against the flag off (no kernel runs on this path, as in the reference)
    and beside the f32 CPU logits; 0 launches of every kernel; median
    forward and peak memory. Then the enc-dec decode over a cache projected
    from the encoder's output against the teacher-forced decoder, and the
    serve CLI at full width. Returns the launches a forward."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import StackCtx, build_model
    from repro_torch.models import transformer as tf
    from repro_torch.testdata import family_batch

    cfg = get_config("whisper-tiny")
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(VLM_SEED), WHISPER_FRAMES, device="cpu")
    card = copy.deepcopy(host).to("cuda")
    n = sum(p.numel() for p in host.parameters())
    np_batch = family_batch(cfg, WHISPER_B, WHISPER_TOKENS, seed=3, frames=WHISPER_FRAMES)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items() if k != "labels"}
    on_card = {k: v.cuda() for k, v in batch.items()}
    print(f"whisper-tiny whole: {cfg.num_encoder_layers} + {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {n / 1e6:.2f} M parameters; frames {tuple(batch['frames'].shape)}, "
          f"tokens {tuple(batch['tokens'].shape)}")
    expect = {name: 0 for name in counters}
    with torch.no_grad():
        t0 = time.perf_counter()
        want, _ = model.forward(host, batch, StackCtx(cfg))
        cpu_s = time.perf_counter() - t0
        scale = float(want.abs().max())
        for dtype in (torch.float32, torch.bfloat16):
            fast = StackCtx(cfg, use_kernel=True, compute_dtype=dtype)
            got, seen, peak = _counted_forward(model, card, on_card, fast, counters)
            if seen != expect:
                raise AssertionError(f"whisper-tiny {dtype}: expected launches {expect}, saw "
                                     f"{seen}")
            if got.shape != (WHISPER_B, WHISPER_TOKENS, cfg.vocab_size) or got.dtype != dtype:
                raise AssertionError(f"bad logits {tuple(got.shape)} {got.dtype}")
            if dtype == torch.float32:
                tol = 1e-4 * scale + 1e-5
                err = close(got.cpu(), want, tol, 0.0, "whisper-tiny card vs cpu")
                check = f"max |card - cpu| {err:.3e} (tolerance {tol:.3e})"
            else:
                plain, _ = model.forward(card, on_card, StackCtx(cfg, compute_dtype=dtype))
                if not same_bits(got, plain):
                    raise AssertionError("whisper-tiny bf16: the kernel flag changed the logits")
                err = abs_err(got.float().cpu(), want)
                if not err < 0.1 * scale:
                    raise AssertionError(f"whisper-tiny bf16: {err:.3e} from the f32 logits")
                check = (f"bit for bit the flag-off forward's; max |bf16 card - f32 cpu| "
                         f"{err:.3e} ({err / scale:.2e} of the largest |logit|)")
                del plain
            del got
            t_fwd = _timed_forward(model, card, on_card, fast)
            tokens = WHISPER_B * (WHISPER_FRAMES + WHISPER_TOKENS)
            print(f"whisper-tiny {str(dtype)[6:]} forward B {WHISPER_B}: 0 launches of every "
                  f"kernel; logits {check}; median forward {t_fwd * 1e3:.1f} ms = "
                  f"{tokens / t_fwd:.0f} frames+tokens/s; peak memory {peak / 2**30:.2f} GiB; "
                  f"the CPU's f32 forward {cpu_s:.1f} s")
        ctx = StackCtx(cfg)
        toks = on_card["tokens"][:4, :PROMPT]
        enc_out = tf.encode(card, on_card["frames"][:4], cfg, ctx)
        full = tf.decode_train_encdec(card, toks, enc_out, cfg, ctx)
        caches = tf.init_encdec_cache(card, cfg, 4, PROMPT, enc_out=enc_out, dtype=torch.float32)
        outs = []
        for t in range(PROMPT):
            logits, caches = tf.decode_step_encdec(card, {"token": toks[:, t:t + 1]}, caches, t,
                                                   cfg, ctx)
            outs.append(logits)
    err = close(torch.cat(outs, 1), full, 2e-3, 2e-3, "whisper-tiny decode vs teacher forcing")
    print(f"whisper-tiny decode over the encoder's output of {WHISPER_FRAMES} frames (cross K/V "
          f"projected once) vs the teacher-forced decoder, {PROMPT} positions x 4: max abs err "
          f"{err:.3e} (atol = rtol = 2e-3)")
    del card, enc_out, full, caches, on_card
    res = serve.main(["--arch", "whisper-tiny", "--batch", str(SERVE_B), "--prompt-len",
                      str(PROMPT), "--gen-len", str(GEN), "--seed", "12"])
    if res.tokens.shape != (SERVE_B, GEN) or res.tokens.device.type != "cuda":
        raise AssertionError(f"bad generation {tuple(res.tokens.shape)} {res.tokens.device}")
    print(f"whisper-tiny serve (CLI path, full width; zero cross K/V as the reference serves): "
          f"prefill {res.prefill_seconds:.3f} s for {PROMPT} tokens x {SERVE_B}, decode "
          f"{res.decode_seconds:.3f} s = {res.tokens_per_second:.1f} tok/s per sequence")
    return dict(expect)


def backward_bits(arch: str, seed: int = 23):
    """Two backward passes of the same batch (8 x 128 tokens, the model at
    TRAIN_CUTS' depth, weights drawn on the card) give the same gradient
    bits in deterministic mode; also read outside it. The dispatch's
    gathers backward are ``index_put_`` with accumulation: each token gets
    its two choices onto a zero, so the sums do not depend on their order."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import StackCtx

    layers = TRAIN_CUTS[arch]
    cfg = (dataclasses.replace(get_config(arch), num_layers=layers) if layers
           else get_reduced(arch))
    model, params, n = draw_on_card(cfg, LM_SEQ, seed)
    gen = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ), generator=gen).cuda()
             for k in ("tokens", "labels")}
    ctx = StackCtx(cfg)

    def grads():
        params.zero_grad(set_to_none=True)
        loss, _ = model.loss(params, batch, ctx)
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().clone()
                                      for k, p in params.named_parameters()}

    with deterministic_mode() as caught:
        (l1, g1), (l2, g2) = grads(), grads()
    same = [k for k in g1 if same_bits(g1[k], g2[k])]
    del g2
    _, g3 = grads()
    loose = sum(same_bits(g1[k], g3[k]) for k in g1)
    params.zero_grad(set_to_none=True)
    print(f"{arch} ({n / 1e9:.3f} B parameters): two backward passes in deterministic mode, "
          f"loss {l1:.6f} and {l2:.6f}: {len(same)} of {len(g1)} gradients bit for bit; "
          f"outside deterministic mode {loose} of {len(g1)} equal the first; warnings "
          f"{sorted({str(w.message)[:80] for w in caught})}")
    if len(same) != len(g1) or l1 != l2:
        raise AssertionError(f"{arch}: repeated backward passes differ in "
                             f"{sorted(set(g1) - set(same))}")
    del model, params, g1, g3
    torch.cuda.empty_cache()


def encdec_vlm_phase(counters, fa, ssd, ref):
    """Phase 22: flash at the VLM's G = 8 shape; Qwen2-VL-72B (2 layers) and
    Whisper-tiny served; Mixtral-8x7B (1 layer) and Jamba (reduced) trained through the train CLI, each with its repeated backward
    held bit for bit. Returns (launches per forward by arch, the flash
    entry's update, the training runs' launches by name)."""
    flash = vlm_kernel_shape(fa, ref)
    torch.cuda.empty_cache()
    launches = {VLM_ARCH: vlm_path(counters, ssd), "whisper-tiny": whisper_path(counters)}
    trained = {}
    for arch, layers in TRAIN_CUTS.items():
        trained[f"{arch} train CLI"] = lm_cli_main(counters, arch, TRAIN_TASKS, TRAIN_STEPS,
                                                   layers=layers, reduced=not layers)["launches"]
        torch.cuda.empty_cache()
        backward_bits(arch)
    return launches, flash, trained

# ---------------------------------------------------------------------------
# phase 23: the model axis on one card (two processes over gloo)
# ---------------------------------------------------------------------------

# Mixtral-8x7B at its published widths cut to 2 of 32 layers (prefill B 1 x S
# 8192: the 4096 window bites), Mamba2-370M whole (B 4 x S 2048); training
# (at 12 of 48 layers: a step's gloo round trips scale with depth) and
# serving (whole) through the CLIs on Mamba2-370M. M = 2 ranks share cuda:0:
# NCCL refuses two ranks on one device, gloo takes CUDA tensors.
MA_RANKS, MA_SEED = 2, 23
MA_MIXTRAL = ("mixtral-8x7b", 2, 1, 8192)  # arch, layers, B, S
MA_MAMBA = ("mamba2-370m", 0, 4, 2048)  # 0 layers: whole
MA_TRAIN = ["--arch", "mamba2-370m", "--tasks", "2", "--steps-per-task", "4"]
MA_TRAIN_LAYERS = 12
MA_SERVE = ["--arch", "mamba2-370m", "--batch", str(SERVE_B), "--prompt-len", "8",
            "--gen-len", "8"]
GLOO = "one card, 2 processes over gloo"


def _ma_cfg(arch: str, layers: int):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _ma_tokens(cfg, b: int, s: int):
    return torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(MA_SEED + 1)).cuda()


@contextlib.contextmanager
def f32_run(train_cli):
    """The train CLI's ``build_run`` in f32 (its dtype on one worker; bf16
    on more), restored after: the model axis's losses are compared with the
    1x1 run's, which a bf16 row-parallel sum would keep 1e-3 apart."""
    build_run = train_cli.build_run

    def f32(args):
        run = build_run(args)
        return dataclasses.replace(run, train=dataclasses.replace(run.train,
                                                                  compute_dtype="float32"))

    train_cli.build_run = f32
    try:
        yield
    finally:
        train_cli.build_run = build_run


def ma_reference(arch: str, layers: int, b: int, s: int, tmp: str) -> dict:
    """The unsharded plain forward on the card, weights drawn on it from
    MA_SEED: f32 (its routing recorded) and bf16 on that routing. Writes
    the f32 logits and the routing under ``tmp`` for the ranks; returns the
    largest |logit| and the bf16 plain path's error against f32."""
    from repro_torch.models import StackCtx
    from repro_torch.testdata import routing

    cfg = _ma_cfg(arch, layers)
    model, params, n = draw_on_card(cfg, s, MA_SEED)
    toks = {"tokens": _ma_tokens(cfg, b, s)}
    with torch.no_grad():
        with routing() as pins:
            want, _ = model.forward(params, toks, StackCtx(cfg))
        with routing(pins):
            plain16, _ = model.forward(params, toks, StackCtx(cfg, compute_dtype=torch.bfloat16))
        ref_err = abs_err(plain16.float(), want)
    scale = float(want.abs().max())
    torch.save({"logits": want.cpu(), "pins": [(g.cpu(), e.cpu()) for g, e in pins]},
               os.path.join(tmp, f"{arch}.pt"))
    print(f"{arch} ({cfg.num_layers} layers, {n / 1e9:.3f} B parameters drawn on the card) "
          f"unsharded plain forward B {b} x S {s}: |logit| max {scale:.3f}, bf16 plain path "
          f"{ref_err:.3e} from f32")
    del model, params, want, plain16
    torch.cuda.empty_cache()
    return {"scale": scale, "ref_err16": ref_err}


def ma_train_cli(counters, mesh: str, init: bool = False) -> dict:
    """``launch.train.main(MA_TRAIN + ["--mesh", mesh])`` in f32 (``f32_run``)
    at ``MA_TRAIN_LAYERS`` layers (``cut_depth``)
    on the card, counters set to 0 just before and read just after. Returns
    the losses, the launches, the trainer's final parameters (on the host;
    with ``init``, its initial ones too), the names of the sharded ones, the
    median step and the peak memory."""
    from repro_torch.launch import train as train_cli

    made = []

    class Kept(train_cli.ContinualTrainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    cls, train_cli.ContinualTrainer = train_cli.ContinualTrainer, Kept
    _zero(counters)
    torch.cuda.reset_peak_memory_stats()
    try:
        with cut_depth(train_cli, MA_TRAIN_LAYERS), f32_run(train_cli):
            res = train_cli.main(MA_TRAIN + ["--mesh", mesh])
    finally:
        train_cli.ContinualTrainer = cls
    launches = _read(counters)
    trainer, params = made[0], made[0].final_state[0]
    out = {"losses": res.losses, "launches": launches,
           "params": {k: p.detach().cpu() for k, p in params.named_parameters()},
           "sharded": sorted(getattr(params, "tp_sharded", ())),
           "step_ms": statistics.median(res.step_seconds) * 1e3,
           "peak": torch.cuda.max_memory_allocated()}
    if init:
        out["init"] = {k: p.detach().cpu() for k, p in
                       trainer.init_params_fn(trainer.seed).named_parameters()}
    return out


class _Collectives:
    """Counts the ``torch.distributed`` collectives the port issues
    (``all_reduce``, ``all_to_all_single``) while installed: the calls since
    the last ``take``, and over the whole run every call and those whose
    operands are CUDA tensors."""

    NAMES = ("all_reduce", "all_to_all_single")

    def __init__(self):
        import torch.distributed as dist

        self.calls = self.total = self.cuda = 0
        for name in self.NAMES:
            setattr(dist, name, self._counted(getattr(dist, name)))

    def _counted(self, inner):
        def counted(*a, **kw):
            tensors = [t for t in a if isinstance(t, torch.Tensor)]
            self.calls += 1
            self.total += 1
            self.cuda += int(bool(tensors) and all(t.is_cuda for t in tensors))
            return inner(*a, **kw)

        return counted

    def take(self) -> int:
        n, self.calls = self.calls, 0
        return n


def ma_rank_forward(counters, mesh, arch: str, layers: int, b: int, s: int, tmp: str,
                    ref: dict, reduces) -> dict:
    """One rank's tensor-parallel prefill through ``launch.steps.
    build_prefill_step`` with the kernels, f32 and bf16, its weights drawn
    on the card from MA_SEED and cut to its shards, routing pinned to the
    unsharded forward's: its vocab shard of the logits against the slice of
    the unsharded f32 plain forward's, within phase 11's bounds; launches,
    gloo all_reduces, peak memory and median time of a step."""
    from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.testdata import routing

    cfg = _ma_cfg(arch, layers)
    saved = torch.load(os.path.join(tmp, f"{arch}.pt"), mmap=True)
    toks = {"tokens": _ma_tokens(cfg, b, s)}
    n_attn, n_ssm, _ = _mixers(cfg)
    expect = dict({k: 0 for k in counters}, flash_attention=n_attn, ssd_scan=n_ssm * 3)
    out, params = {}, None
    for dtype in ("float32", "bfloat16"):
        built = build_prefill_step(RunConfig(
            model=cfg, train=TrainConfig(compute_dtype=dtype),
            scenario=ScenarioConfig(modality="tokens", batch_size=b, seq_len=s)), mesh)
        mp = built.ctx.mp
        if params is None:
            with torch.device("cuda"):
                params = built.model.init(torch.Generator(device="cuda").manual_seed(MA_SEED),
                                          s, "cuda", mp)
            v = cfg.vocab_size // mp.size
            want = saved["logits"][..., mp.index * v:(mp.index + 1) * v].cuda()
            out["local_heads"] = ((params.layers[0].attn.wq.shape[1] // cfg.head_dim,
                                   params.layers[0].attn.wk.shape[1] // cfg.head_dim)
                                  if n_attn and cfg.layer_kind(0) == "attn" else
                                  (params.layers[0].ssm.A_log.shape[0],))
        with routing(saved["pins"]):
            reduces.take()
            got, seen, peak = _counted_call(lambda: built.fn(params, toks), counters)
            n_reduce = reduces.take()
        if seen != expect:
            raise AssertionError(f"{arch} rank {mp.index} {dtype}: launches {seen}, want {expect}")
        if got.shape != (b, s, v) or got.dtype != built.ctx.compute_dtype:
            raise AssertionError(f"{arch} rank {mp.index}: logits {tuple(got.shape)} {got.dtype}")
        tol = (1e-4 * ref["scale"] + 1e-5 if dtype == "float32"
               else 2 * ref["ref_err16"] + 1e-3 * ref["scale"])
        err = close(got.float(), want, tol, 0.0, f"{arch} rank {mp.index} {dtype} vs unsharded")
        del got
        with routing(saved["pins"] * 2):
            ms = _timed_call(lambda: built.fn(params, toks), reps=2) * 1e3
        key = "f32" if dtype == "float32" else "bf16"
        out[key] = {"err": err, "tol": tol, "launches": seen, "all_reduces": n_reduce,
                    "peak": peak, "ms": ms}
    del params, want
    torch.cuda.empty_cache()
    return out


def model_axis_rank(tmp: str):
    """One rank of phase 23's two (``runtime.multiproc`` starts it with
    ``python -c``): joins the gloo group on cuda:0, runs (a) to (d) and
    writes its results to ``tmp/rank<i>.json``, its trained parameters to
    ``tmp/rank<i>_params.pt``."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rehearsal_ops as ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.init_from_env("gloo")
    counters = {"rehearsal_update_sample": ops.rehearsal_update_sample,
                "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan}
    reduces = _Collectives()
    with open(os.path.join(tmp, "refs.json")) as f:
        refs = json.load(f)
    mesh = make_mesh((1, world), ("data", "model"), "cuda")
    out = {"rank": rank, "backend": dist.get_backend()}
    for arch, layers, b, s in (MA_MIXTRAL, MA_MAMBA):
        out[arch] = ma_rank_forward(counters, mesh, arch, layers, b, s, tmp, refs[arch],
                                    reduces)
    reduces.take()
    train = ma_train_cli(counters, f"1x{world}")
    train["all_reduces"] = reduces.take()
    torch.save(train.pop("params"), os.path.join(tmp, f"rank{rank}_params.pt"))
    out["train"] = train
    res = serve.main(MA_SERVE + ["--mesh", f"1x{world}"])
    out["serve"] = {"tokens": res.tokens.cpu().tolist(), "all_reduces": reduces.take(),
                    "decode_tok_s": res.tokens_per_second}
    out["collectives"], out["cuda_collectives"] = reduces.total, reduces.cuda
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import gc

    gc.collect()
    dist.destroy_process_group()


# the trained parameters at --mesh 1x2 against 1x1's, f32 with TF32 off: a
# tensor's ||p_1x2 - p_1x1|| over its update ||p_1x1 - p_init||, on the
# rank's slice; and each of the 8 losses, relative. H100 readings at 12
# layers: at most 3.8e-4 (a dt_bias) and 2.7e-7; at 48 layers 6.1e-3 and
# 1.9e-5, and 2.09 for the tensors when f's backward skips its all_reduce
MA_PARAM_TOL, MA_LOSS_TOL = 1e-2, 1e-5


def ma_trained_against_1x1(rank: int, got: dict, sharded, one: dict, cfg):
    """The largest relative update error of rank ``rank``'s trained
    parameters ``got`` (its shards; ``sharded`` names them) against the
    slices of the 1x1 run's, and the tensor that has it."""
    from repro_torch.parallel import ModelParallel, param_spec, shard_param

    if set(got) != set(one["params"]):
        raise AssertionError(f"rank {rank}: parameters {sorted(set(got) ^ set(one['params']))}")
    mp, worst, split = ModelParallel(None, MA_RANKS, rank), (0.0, ""), set()
    for k, full in one["params"].items():
        spec = param_spec(k, tuple(full.shape), cfg, MA_RANKS)
        if "model" in spec:
            split.add(k)
        want, start = shard_param(full, spec, mp), shard_param(one["init"][k], spec, mp)
        if got[k].shape != want.shape:
            raise AssertionError(f"rank {rank} {k}: {tuple(got[k].shape)} vs {tuple(want.shape)}")
        moved = float((want - start).double().norm())
        rel = float((got[k] - want).double().norm()) / max(moved, 1e-30)
        worst = max(worst, (rel, k))
    if split != set(sharded):
        raise AssertionError(f"rank {rank}: sharded {sorted(split ^ set(sharded))} against the "
                             f"rule table")
    if worst[0] > MA_PARAM_TOL:
        raise AssertionError(f"rank {rank}: trained {worst[1]} {worst[0]:.3e} of its update from "
                             f"1x1's (tolerance {MA_PARAM_TOL})")
    return worst


def model_axis_phase(counters, fa, ssd, ref):
    """Phase 23. Returns the kernels-line updates: flash's and the scan's
    times at the local heads, and every kernel's launches on the ranks."""
    import shutil
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.runtime import multiproc

    gen = torch.Generator().manual_seed(MA_SEED)
    flash = flash_at(fa, ref, gen, (1, 8192, 16, 4, 128, 4096),
                     "one rank's share of Mixtral's prefill at M = 2", "_tp2_h16_kv4_swa")
    scan = scan_at(ssd, ref, gen, (4, 2048, 16, 64, 128, 128),
                   "one rank's share of Mamba2-370M's prefill at M = 2", "_tp2_h16")
    tmp = tempfile.mkdtemp(prefix="repro_phase23_")
    try:
        refs = {arch: ma_reference(arch, layers, b, s, tmp)
                for arch, layers, b, s in (MA_MIXTRAL, MA_MAMBA)}
        with open(os.path.join(tmp, "refs.json"), "w") as f:
            json.dump(refs, f)
        one = ma_train_cli(counters, "1x1", init=True)
        print(f"mamba2-370m ({MA_TRAIN_LAYERS} layers) train CLI --mesh 1x1, f32: losses "
              f"{[round(x, 5) for x in one['losses']]}, median step {one['step_ms']:.1f} ms")
        served = serve.main(MA_SERVE + ["--mesh", "1x1"]).tokens.cpu().tolist()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        procs = multiproc.launch_workers(
            f"import chip_smoke; chip_smoke.model_axis_rank({tmp!r})", MA_RANKS,
            pythonpath=ROOT + os.pathsep + os.path.join(ROOT, "src"), rendezvous_dir=tmp,
            timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            print(p.stdout[-3000:], end="")
        bad = [(i, p.returncode, p.stderr[-4000:]) for i, p in enumerate(procs) if p.returncode]
        if bad:
            raise AssertionError(f"phase 23 ranks failed: {bad}")
        ranks, trained = [], []
        for i in range(MA_RANKS):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
            trained.append(torch.load(os.path.join(tmp, f"rank{i}_params.pt")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{MA_RANKS} ranks in {wall:.1f} s ({GLOO}, backend {ranks[0]['backend']})")
    for r in ranks:
        print(f"rank {r['rank']}: {r['cuda_collectives']} of its {r['collectives']} collectives "
              f"(all_reduce, all_to_all_single) took CUDA tensors")
        if r["cuda_collectives"] != r["collectives"] or not r["collectives"]:
            raise AssertionError(f"rank {r['rank']}: {r['collectives'] - r['cuda_collectives']} "
                                 f"collectives took host tensors")
    launches = {}
    for r in ranks:
        i = r["rank"]
        for arch, layers, b, s in (MA_MIXTRAL, MA_MAMBA):
            got = r[arch]
            for key in ("f32", "bf16"):
                g = got[key]
                print(f"rank {i} {arch} prefill step {key} B {b} x S {s} on local heads "
                      f"{tuple(got['local_heads'])}: max |shard - unsharded plain| "
                      f"{g['err']:.3e} (tolerance {g['tol']:.3e}); launches "
                      f"{({k: v for k, v in g['launches'].items() if v})}; gloo all_reduces "
                      f"a forward {g['all_reduces']}; median step {g['ms']:.1f} ms ({GLOO});"
                      f" peak memory {g['peak'] / 2**30:.2f} GiB")
            launches[f"{arch} rank {i}"] = got["f32"]["launches"]
        t = r["train"]
        steps = len(t["losses"])
        rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], one["losses"])]
        worst, name = ma_trained_against_1x1(i, trained[i], t["sharded"], one,
                                             _ma_cfg("mamba2-370m", MA_TRAIN_LAYERS))
        print(f"rank {i} train CLI --mesh 1x{MA_RANKS} ({MA_TRAIN_LAYERS} layers), f32: losses "
              f"{[round(x, 5) for x in t['losses']]}; launches "
              f"{({k: v for k, v in t['launches'].items() if v})}; gloo all_reduces "
              f"{t['all_reduces']} over the fit ({t['all_reduces'] / steps:.1f} a step, evals "
              f"included); median step {t['step_ms']:.1f} ms ({GLOO}) beside 1x1's "
              f"{one['step_ms']:.1f} ms; peak memory {t['peak'] / 2**30:.2f} GiB; "
              f"{len(t['sharded'])} sharded tensors; losses at most {max(rel):.2e} from 1x1's, "
              f"relative (tolerance {MA_LOSS_TOL}); trained parameters at most {worst:.3e} of "
              f"their update from 1x1's ({name}; tolerance {MA_PARAM_TOL})")
        if steps != 8 or not all(math.isfinite(x) for x in t["losses"]):
            raise AssertionError(f"rank {i} train: losses {t['losses']}")
        if t["launches"]["rehearsal_update_sample"] != steps or any(
                v for k, v in t["launches"].items() if k != "rehearsal_update_sample"):
            raise AssertionError(f"rank {i} train: launches {t['launches']}")
        if len(rel) != len(one["losses"]) or max(rel) > MA_LOSS_TOL:
            raise AssertionError(f"rank {i}: losses {t['losses']} vs 1x1 {one['losses']}")
        launches[f"mamba2-370m train CLI 1x{MA_RANKS} rank {i}"] = t["launches"]
        if r["serve"]["tokens"] != served:
            raise AssertionError(f"rank {i} serve --mesh 1x{MA_RANKS}: {r['serve']['tokens']} "
                                 f"vs 1x1 {served}")
        print(f"rank {i} serve --mesh 1x{MA_RANKS}: token ids == 1x1's ({len(served)} x "
              f"{len(served[0])}); gloo all_reduces {r['serve']['all_reduces']}; "
              f"{r['serve']['decode_tok_s']:.1f} tok/s per sequence ({GLOO})")
    sharded = set(ranks[0]["train"]["sharded"])
    replicated = [k for k in trained[0] if k not in sharded]
    differ = [k for k in replicated if not torch.equal(trained[0][k], trained[1][k])]
    if differ or not replicated:
        raise AssertionError(f"replicated parameters differ across the ranks: {differ}")
    print(f"after training: {len(replicated)} replicated tensors bit for bit on both ranks, "
          f"{len(sharded)} sharded")
    flash["launches_model_axis"] = {k: v["flash_attention"] for k, v in launches.items()
                                    if v["flash_attention"]}
    scan["launches_model_axis"] = {k: v["ssd_scan"] for k, v in launches.items()
                                   if v["ssd_scan"]}
    return flash, scan, {k: v["rehearsal_update_sample"] for k, v in launches.items()
                         if v["rehearsal_update_sample"]}


# ---------------------------------------------------------------------------
# phase 24: the train step's memory knobs (remat, ZeRO-1, sequence parallelism)
# ---------------------------------------------------------------------------

MK_REMAT = ("smollm-135m", 4, 2048)  # arch, B, S
MK_POLICIES = ("none", "dots", "full")
# arch, steps (the train CLI's run, 1 task), layers (cut for time, as phase
# 23's training)
MK_ZERO1 = ("mamba2-370m", 4, 12)
MK_SEED = 29


def remat_policies(counters):
    """(a) One train step (forward and backward of the LM loss) of
    SmolLM-135M whole at B 4 x S 2048, f32, under each checkpoint policy in
    deterministic mode: the loss and every gradient bit for bit across the
    policies, each policy's median step and the peak device memory above
    the weights. Training runs the plain mixers: no kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import StackCtx

    arch, b, s = MK_REMAT
    cfg = get_config(arch)
    model, params, n = draw_on_card(cfg, s, MK_SEED)
    gen = torch.Generator(device="cuda").manual_seed(MK_SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, (b, s), device="cuda", generator=gen)
             for k in ("tokens", "labels")}
    out, want = {}, None
    with deterministic_mode() as caught:
        for policy in MK_POLICIES:
            ctx = StackCtx(cfg=cfg, remat=policy)

            def step():
                params.zero_grad(set_to_none=True)
                loss, _ = model.loss(params, batch, ctx)
                loss.backward()
                return loss

            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            loss, launches, peak = _counted_call(step, counters)
            grads = {k: p.grad for k, p in params.named_parameters()}
            if want is None:
                want = (loss.detach().clone(), {k: g.clone() for k, g in grads.items()})
            differ = [k for k, g in grads.items() if not same_bits(g, want[1][k])]
            if not same_bits(loss.detach(), want[0]) or differ or not math.isfinite(float(loss)):
                raise AssertionError(f"{arch} remat {policy}: loss {float(loss)} against "
                                     f"{float(want[0])}; gradients differ: {differ[:5]}")
            if any(launches.values()):
                raise AssertionError(f"{arch} remat {policy}: launches {launches}")
            ms = _timed_call(step, reps=4) * 1e3
            out[policy] = {"ms": ms, "peak": peak, "above_weights": peak - base}
            print(f"{arch} ({n / 1e6:.1f} M parameters) train step B {b} x S {s} f32, remat "
                  f"{policy}: loss {float(loss):.6f}, bit for bit the first policy's with "
                  f"every gradient; median step {ms:.1f} ms; peak device memory "
                  f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the weights "
                  f"and gradients held before the step)")
    params.zero_grad(set_to_none=True)
    del model, params, want, grads
    torch.cuda.empty_cache()
    if caught:
        print(f"deterministic-mode warnings: {sorted({str(w.message)[:80] for w in caught})}")
    return out


def mk_prefill(counters, mesh, arch: str, layers: int, b: int, s: int) -> dict:
    """(c) One rank's prefill through ``build_prefill_step`` with
    ``sequence_parallel`` off then on, f32 then bf16, its weights drawn on
    the card from MA_SEED and cut to its shards, routing pinned to the f32
    run without: the logits against the run without within phase 11's
    bounds (f32: 1e-4 of the largest |logit| + 1e-5; bf16: against the f32
    run without, twice the bf16 run without's error + 1e-3 of the largest
    |logit|), the same launches, and each call's peak above the memory held
    before it."""
    from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.testdata import routing

    cfg = _ma_cfg(arch, layers)
    toks = {"tokens": _ma_tokens(cfg, b, s)}
    n_attn, n_ssm, _ = _mixers(cfg)
    expect = dict({k: 0 for k in counters}, flash_attention=n_attn, ssd_scan=n_ssm * 3)
    out, params, f32_off, pins = {}, None, None, None
    for dtype in ("float32", "bfloat16"):
        got, ms = {}, {}
        for sp in (False, True):
            built = build_prefill_step(RunConfig(
                model=cfg, train=TrainConfig(compute_dtype=dtype, sequence_parallel=sp),
                scenario=ScenarioConfig(modality="tokens", batch_size=b, seq_len=s)), mesh)
            mp = built.ctx.mp
            if params is None:
                with torch.device("cuda"):
                    params = built.model.init(
                        torch.Generator(device="cuda").manual_seed(MA_SEED), s, "cuda", mp)
            torch.cuda.synchronize()
            held, t0 = torch.cuda.memory_allocated(), time.perf_counter()
            with routing(pins) as seen:
                logits, launches, peak = _counted_call(lambda: built.fn(params, toks), counters)
            ms[sp] = (time.perf_counter() - t0) * 1e3
            pins, peak = (pins if pins is not None else seen), peak - held
            if launches != expect:
                raise AssertionError(f"{arch} rank {mp.index} {dtype} sp={sp}: launches "
                                     f"{launches}, want {expect}")
            got[sp] = (logits, launches, peak)
        if f32_off is None:
            f32_off = got[False][0].float()
        scale = float(f32_off.abs().max())
        if dtype == "float32":
            tol = 1e-4 * scale + 1e-5
            want = got[False][0]
        else:
            tol = 2 * abs_err(got[False][0].float(), f32_off) + 1e-3 * scale
            want = f32_off
        err = close(got[True][0].float(), want.float(), tol, 0.0,
                    f"{arch} rank {mp.index} {dtype} sequence-parallel vs not")
        key = "f32" if dtype == "float32" else "bf16"
        out[key] = {"err": err, "tol": tol, "bits": same_bits(got[True][0], got[False][0]),
                    "launches": got[True][1], "peak_off": got[False][2], "peak_on": got[True][2],
                    "ms_off": ms[False], "ms_on": ms[True]}
        del got
    del params, f32_off
    torch.cuda.empty_cache()
    return out


def mk_zero1(counters, mesh) -> dict:
    """(b) ``ContinualTrainer(mesh=2x1)`` on the train CLI's run of
    Mamba2-370M at 12 of 48 layers (1 task of MK_ZERO1 steps, f32), without then with
    ``zero1``, in deterministic mode, first with the gradient clip off and
    then on (the run's own clip, the obs gauges on for each step's
    ``obs/grad_norm``): each run's moment bytes on this rank, its peak, its
    update+sample launches, and the parameters' digests (the parent
    compares the ranks and the runs) and largest gap from the run without.
    Clip off, the runs are the same bit for bit: on 2 ranks a
    reduce-scatter is the all-reduce's sum. Clip on, the norm sums each cut
    parameter's slices first, another order: the step's norms agree within
    rounding, and the leaf whose parameters end farthest from the run
    without is reported with what AdamW's second moment says of its
    gradient there."""
    import hashlib

    from repro_torch.configs.base import ObsConfig
    from repro_torch.optim.optimizers import lr_schedule, zero1_dims
    from repro_torch.parallel import Zero1
    from repro_torch.scenario import ContinualTrainer

    arch, steps, layers = MK_ZERO1
    out, base = {}, {}
    with deterministic_mode():
        for clip in (False, True):
            for zero1 in (False, True):
                run = lm_cli_run(arch, steps=steps, tasks=1)
                run = dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                                         num_layers=layers))
                train = dataclasses.replace(run.train, zero1=zero1,
                                            grad_clip=run.train.grad_clip if clip else 0.0)
                run = dataclasses.replace(run, train=train, obs=ObsConfig(enabled=clip))
                trainer = ContinualTrainer(run, device="cuda", mesh=mesh, exchange="full")
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                _zero(counters)
                result = trainer.fit()
                launches = _read(counters)
                peak = torch.cuda.max_memory_allocated()
                params, opt = trainer.final_state[0], trainer.final_state[1]
                named = {k: p.detach() for k, p in params.named_parameters()}
                moments = [t for m in (opt.mu, opt.nu) for t in m.values()]
                cut = zero1_dims(named, Zero1(None, mesh.size(0), 0), params.layout_specs)
                digest = hashlib.sha256()
                for k in sorted(named):
                    digest.update(named[k].cpu().numpy().tobytes())
                entry = {"losses": result.losses, "launches": launches, "peak": peak,
                         "clip": train.grad_clip,
                         "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
                         "param_bytes": sum(p.numel() * 4 for p in named.values()),
                         # both moments, f32: a cut parameter's slice, the rest whole
                         "moment_bytes_rule": 8 * sum(
                             p.numel() // (mesh.size(0) if zero1 and k in cut else 1)
                             for k, p in named.items()),
                         "digest": digest.hexdigest(), "meta": trainer.built.meta["zero1"],
                         "step_ms": statistics.median(result.step_seconds) * 1e3,
                         "grad_norms": [h["obs/grad_norm"] for h in result.history] if clip
                         else []}
                if not zero1:
                    base = {"params": {k: p.cpu() for k, p in named.items()},
                            "nu": {k: t.cpu() for k, t in opt.nu.items()}}
                else:
                    gaps = {k: float((p.cpu() - base["params"][k]).abs().max())
                            / max(float(base["params"][k].abs().max()), 1e-30)
                            for k, p in named.items()}
                    leaf = max(gaps, key=gaps.get)
                    delta = (named[leaf].cpu() - base["params"][leaf]).abs()
                    at = int(delta.reshape(-1).argmax())
                    rms = base["nu"][leaf].sqrt().reshape(-1)  # |gradient|, AdamW's view
                    entry.update(rel_gap=gaps[leaf], leaf=leaf, leaf_shape=list(delta.shape),
                                 gap_abs=float(delta.reshape(-1)[at]),
                                 moved=int((delta > 1e-6 * float(
                                     base["params"][leaf].abs().max())).sum()),
                                 rms_at=float(rms[at]), rms_median=float(rms.median()),
                                 rms_max=float(rms.max()),
                                 lr_sum=sum(lr_schedule(train, mesh.size(0))(t)
                                            for t in range(steps)))
                out[("zero1" if zero1 else "base") + ("_clip" if clip else "")] = entry
                del trainer, result, params, opt, named, moments
                torch.cuda.empty_cache()
    return out


def memory_knob_rank(tmp: str):
    """One rank of phase 24's two (``runtime.multiproc`` starts it): joins
    the gloo group on cuda:0, runs (c) on a 1 x 2 mesh and (b) on a 2 x 1
    mesh, and writes its results to ``tmp/rank<i>.json``."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rehearsal_ops as ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.init_from_env("gloo")
    counters = {"rehearsal_update_sample": ops.rehearsal_update_sample,
                "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan}
    out = {"rank": rank}
    row = make_mesh((1, world), ("data", "model"), "cuda")
    for arch, layers, b, s in (MA_MIXTRAL, MA_MAMBA):
        out[arch] = mk_prefill(counters, row, arch, layers, b, s)
    out["zero1"] = mk_zero1(counters, make_mesh((world, 1), ("data", "model"), "cuda"))
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import gc

    gc.collect()
    dist.destroy_process_group()


def memory_knobs_phase(counters) -> tuple:
    """Phase 24. Returns the kernels-line updates: the flash and scan
    launches of the sequence-parallel prefill on each rank, and the
    update+sample launches of the ZeRO-1 runs."""
    import shutil
    import tempfile

    from repro_torch.runtime import multiproc

    remat = remat_policies(counters)
    kept = [remat[p]["above_weights"] for p in ("full", "dots", "none")]
    if not kept[0] < kept[1] < kept[2]:
        raise AssertionError(f"remat: full, dots and none keep {kept} bytes above the "
                             f"weights, not in that order")
    tmp = tempfile.mkdtemp(prefix="repro_phase24_")
    try:
        t0 = time.perf_counter()
        procs = multiproc.launch_workers(
            f"import chip_smoke; chip_smoke.memory_knob_rank({tmp!r})", MA_RANKS,
            pythonpath=ROOT + os.pathsep + os.path.join(ROOT, "src"), rendezvous_dir=tmp,
            timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            print(p.stdout[-3000:], end="")
        bad = [(i, p.returncode, p.stderr[-4000:]) for i, p in enumerate(procs) if p.returncode]
        if bad:
            raise AssertionError(f"phase 24 ranks failed: {bad}")
        ranks = []
        for i in range(MA_RANKS):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{MA_RANKS} ranks in {wall:.1f} s ({GLOO})")
    launches = {}
    for r in ranks:
        i = r["rank"]
        for arch, layers, b, s in (MA_MIXTRAL, MA_MAMBA):
            for key in ("f32", "bf16"):
                g = r[arch][key]
                times = (f"; one forward {g['ms_on']:.1f} ms on, {g['ms_off']:.1f} ms off "
                         f"(host clock, synchronised)")
                print(f"rank {i} {arch} prefill B {b} x S {s} {key}, sequence_parallel on the "
                      f"1 x {MA_RANKS} row: max |on - {'off' if key == 'f32' else 'f32 off'}| "
                      f"{g['err']:.3e} (tolerance {g['tol']:.3e}; on == off bit for bit: "
                      f"{g['bits']}); launches {({k: v for k, v in g['launches'].items() if v})}"
                      f" as without; the call's peak above the memory held before it "
                      f"{g['peak_on'] / 2**30:.3f} GiB on, {g['peak_off'] / 2**30:.3f} GiB off"
                      f"{times} ({GLOO})")
            launches[f"{arch} sequence-parallel prefill rank {i}"] = r[arch]["f32"]["launches"]
        z = r["zero1"]
        steps = MK_ZERO1[1]
        for name in ("base", "zero1", "base_clip", "zero1_clip"):
            e = z[name]
            print(f"rank {i} {MK_ZERO1[0]} ContinualTrainer mesh {MA_RANKS}x1, {steps} steps "
                  f"f32, grad_clip {e['clip']}, zero1 {e['meta']}: moments "
                  f"{e['moment_bytes']} bytes (parameters {e['param_bytes']}); peak memory "
                  f"{e['peak'] / 2**30:.2f} GiB; median step {e['step_ms']:.1f} ms; losses "
                  f"{[round(x, 5) for x in e['losses']]}; launches "
                  f"{({k: v for k, v in e['launches'].items() if v})} ({GLOO})")
            if e["launches"]["rehearsal_update_sample"] != steps or any(
                    v for k, v in e["launches"].items() if k != "rehearsal_update_sample"):
                raise AssertionError(f"rank {i} {name}: launches {e['launches']}")
            if len(e["losses"]) != steps or not all(math.isfinite(x) for x in e["losses"]):
                raise AssertionError(f"rank {i} {name}: losses {e['losses']}")
        if not (z["zero1"]["meta"] and z["zero1_clip"]["meta"] and not z["base"]["meta"]
                and not z["base_clip"]["meta"]):
            raise AssertionError(f"rank {i}: meta zero1 {z['base']['meta']}, "
                                 f"{z['zero1']['meta']}")
        if any(z[k]["moment_bytes"] != z[k]["moment_bytes_rule"] for k in z) or \
                z["base"]["moment_bytes"] != 2 * z["base"]["param_bytes"] or \
                not z["zero1"]["moment_bytes"] < 0.51 * z["base"]["moment_bytes"]:
            raise AssertionError(f"rank {i}: moment bytes {z['zero1']['moment_bytes']} with "
                                 f"zero1, {z['base']['moment_bytes']} without")
        if z["zero1"]["rel_gap"] > 1e-6 or z["zero1"]["digest"] != z["base"]["digest"]:
            raise AssertionError(f"rank {i}: zero1's parameters {z['zero1']['rel_gap']:.3e} of "
                                 f"a tensor's largest entry from the run without")
        whole = (z["zero1"]["moment_bytes"] - z["base"]["moment_bytes"] // 2) // 4
        print(f"rank {i}: zero1 halves the moments ({z['zero1']['moment_bytes']} of "
              f"{z['base']['moment_bytes']} bytes, the rule's count exactly; the moments of "
              f"{whole} parameter elements stay whole: the 1-D leaves whose one dim the "
              f"reference's spec puts on the model axis); its parameters the run without's "
              f"bit for bit (largest gap {z['zero1']['rel_gap']:.3e})")
        c, w = z["zero1_clip"], z["base_clip"]
        norm_gap = max(abs(a - b) / b for a, b in zip(c["grad_norms"], w["grad_norms"]))
        if len(c["grad_norms"]) != steps or norm_gap > 1e-6:
            raise AssertionError(f"rank {i}: the clip's norms with zero1 {c['grad_norms']}, "
                                 f"without {w['grad_norms']}")
        print(f"rank {i}: grad_clip {c['clip']}: each step's obs/grad_norm with zero1 within "
              f"{norm_gap:.3e} of the run without ({w['grad_norms']}); the parameters' "
              f"largest gap {c['rel_gap']:.3e} of a tensor's largest entry, in {c['leaf']} "
              f"{c['leaf_shape']} ({c['moved']} elements moved by over 1e-6 of it): "
              f"{c['gap_abs']:.3e} where sqrt(nu) is {c['rms_at']:.3e} (the leaf's median "
              f"{c['rms_median']:.3e}, max {c['rms_max']:.3e}); the learning rates of the "
              f"{steps} steps sum to {c['lr_sum']:.3e}")
        launches[f"{MK_ZERO1[0]} zero1 mesh {MA_RANKS}x1 rank {i}"] = \
            z["zero1"]["launches"]
    for name in ("base", "zero1", "base_clip", "zero1_clip"):
        if len({r["zero1"][name]["digest"] for r in ranks}) != 1:
            raise AssertionError(f"{name}: the ranks' parameters differ")
    print(f"after training: every parameter bit for bit on both ranks, with and without zero1")
    return ({k: v["flash_attention"] for k, v in launches.items() if v["flash_attention"]},
            {k: v["ssd_scan"] for k, v in launches.items() if v["ssd_scan"]},
            {k: v["rehearsal_update_sample"] for k, v in launches.items()
             if v["rehearsal_update_sample"]}, remat)


# ---------------------------------------------------------------------------
# phase 25: the ghost block; restarts, tap strategies and Whisper on a model axis
# ---------------------------------------------------------------------------

# (b) and (c): the train CLI's Mamba2-370M run (phase 24 (b)'s, 1 task of
# GR_STEPS steps, f32) on a 1 x 2 mesh, cut to MA_TRAIN_LAYERS layers as
# phase 23's training is (a step's gloo round trips scale with depth).
# Restart checkpoints every GR_EVERY steps; model rank 1 fails before step
# GR_FAIL_AT, so that every rank restores step GR_FAIL_AT - 1 and replays
# it. (d): Whisper-tiny whole through the serve CLI.
GR_STEPS, GR_EVERY, GR_FAIL_AT, GR_TOPK = 4, 2, 3, 16
GR_SERVE = ["--arch", "whisper-tiny", "--batch", str(SERVE_B), "--prompt-len", "8",
            "--gen-len", "8"]


def ghost_path(counters, base_ms):
    """(a) ``resnet50_cl.ghostnet()`` at full width: its forward on the card
    against the CPU as phase 4 holds ResNet-50's (TF32 off), then
    ``ContinualTrainer`` on phase 5's flat configuration with it, TF32 on as
    phase 5 runs (``fit_flat``: one update+sample launch a step, finite
    losses), its median step beside phase 5's."""
    from repro_torch.configs import resnet50_cl

    cfg = resnet50_cl.ghostnet()
    model_phase(cfg, "GhostNet-50 (ghost blocks, stages (2, 2, 4, 2))")
    trainer = class_incremental_trainer(cfg, FLAT, stream_cfg=resnet50_cl.full())
    launches, _, step_ms = fit_flat(counters, trainer, "ghostnet, flat, step_form='fused'")
    print(f"ghostnet median step {step_ms:.1f} ms beside phase 5's ResNet-50 {base_ms:.1f} ms "
          f"({gpu_name_and_power()})")
    del trainer
    torch.cuda.empty_cache()
    return launches


def _digest(named) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(named):
        h.update(named[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gr_fit(counters, mesh, tmp: str, name: str, strategy: str = "", top_k: int = 0,
           fail_rank: int = -1, resilient: bool = True) -> dict:
    """One ``ContinualTrainer`` run of (b) or (c) on this rank, in
    deterministic mode: with ``resilient``, restart checkpoints every
    GR_EVERY steps under ``tmp/name``, and ``fail_rank`` failing once before
    step GR_FAIL_AT. Every counter is set to 0 just before ``fit`` and read
    just after. Returns the losses, restarts, launches, the stored record
    fields and digests of the parameters and of the buffer."""
    from repro_torch.configs.base import ResilienceConfig
    from repro_torch.scenario import ContinualTrainer, TokenClassIncremental

    import torch.distributed as dist

    run = lm_cli_run("mamba2-370m", steps=GR_STEPS, tasks=1, strategy=strategy, top_k=top_k)
    run = dataclasses.replace(run, model=dataclasses.replace(run.model,
                                                             num_layers=MA_TRAIN_LAYERS))
    hook = _fail_once(GR_FAIL_AT) if dist.get_rank() == fail_rank else None
    kw = dict(ckpt_dir=os.path.join(tmp, name),
              resilience=ResilienceConfig(checkpoint_every=GR_EVERY)) if resilient else {}
    trainer = ContinualTrainer(run, TokenClassIncremental(run.scenario), device="cuda",
                               mesh=mesh, overrides={"failure_hook": hook} if hook else None,
                               **kw)
    _zero(counters)
    result = trainer.fit()
    launches = _read(counters)
    params, _, buffer = trainer.final_state[:3]
    out = {"losses": result.losses, "restarts": result.restarts, "launches": launches,
           "aux_fields": sorted(trainer.aux_spec),
           "params": _digest(dict(params.named_parameters())),
           "buffer": _digest(buffer.data), "step_ms": statistics.median(result.step_seconds) * 1e3}
    del trainer, result, params, buffer
    torch.cuda.empty_cache()
    return out


def ghost_rank(tmp: str):
    """One rank of phase 25's two (``runtime.multiproc`` starts it): joins
    the gloo group on cuda:0, runs (b), (c) and (d) on a 1 x 2 mesh and
    writes its results to ``tmp/rank<i>.json``."""
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rehearsal_ops as ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.init_from_env("gloo")
    counters = {"rehearsal_update_sample": ops.rehearsal_update_sample,
                "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan}
    mesh = make_mesh((1, world), ("data", "model"), "cuda")
    out = {"rank": rank}
    with deterministic_mode():
        out["clean"] = gr_fit(counters, mesh, tmp, "clean")
        out["failed"] = gr_fit(counters, mesh, tmp, "failed", fail_rank=1)
        out["der_pp"] = gr_fit(counters, mesh, tmp, "der_pp", strategy="der_pp", top_k=GR_TOPK,
                               resilient=False)
    res = serve.main(GR_SERVE + ["--mesh", f"1x{world}"])
    out["serve"] = {"tokens": res.tokens.cpu().tolist(), "decode_tok_s": res.tokens_per_second}
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    import gc

    gc.collect()
    dist.destroy_process_group()


def ghost_and_model_axis_phase(counters, fused_runs: dict, cfg) -> dict:
    """Phase 25. Returns the update+sample launches of each run, by name."""
    import shutil
    import tempfile

    from repro_torch.launch import serve
    from repro_torch.runtime import multiproc

    with tf32_as_phase_5():
        if "flat" not in fused_runs:
            fused_runs["flat"] = main_path(counters, cfg)
        launches = {"ghostnet flat": ghost_path(counters, fused_runs["flat"][2])}
    served = serve.main(GR_SERVE + ["--mesh", "1x1"]).tokens.cpu().tolist()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="repro_phase25_")
    try:
        t0 = time.perf_counter()
        procs = multiproc.launch_workers(
            f"import chip_smoke; chip_smoke.ghost_rank({tmp!r})", MA_RANKS,
            pythonpath=ROOT + os.pathsep + os.path.join(ROOT, "src"), rendezvous_dir=tmp,
            timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            print(p.stdout[-3000:], end="")
        bad = [(i, p.returncode, p.stderr[-4000:]) for i, p in enumerate(procs) if p.returncode]
        if bad:
            raise AssertionError(f"phase 25 ranks failed: {bad}")
        ranks = []
        for i in range(MA_RANKS):
            with open(os.path.join(tmp, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{MA_RANKS} ranks in {wall:.1f} s ({GLOO})")
    replayed = GR_FAIL_AT - GR_FAIL_AT // GR_EVERY * GR_EVERY
    for r in ranks:
        i = r["rank"]
        for name in ("clean", "failed", "der_pp"):
            g = r[name]
            want = GR_STEPS + (replayed if name == "failed" else 0)
            print(f"rank {i} mamba2-370m ({MA_TRAIN_LAYERS} layers) 1 x {MA_RANKS} {name}: "
                  f"losses {[round(x, 5) for x in g['losses']]}, restarts {g['restarts']}, "
                  f"record fields beyond the tokens' {g['aux_fields']}, launches "
                  f"{({k: v for k, v in g['launches'].items() if v})} (want {want} "
                  f"update+sample), median step {g['step_ms']:.1f} ms ({GLOO})")
            if (g["launches"]["rehearsal_update_sample"] != want
                    or any(v for k, v in g["launches"].items()
                           if k != "rehearsal_update_sample")):
                raise AssertionError(f"rank {i} {name}: launches {g['launches']}")
            if len(g["losses"]) != GR_STEPS or not all(math.isfinite(x) for x in g["losses"]):
                raise AssertionError(f"rank {i} {name}: losses {g['losses']}")
            launches[f"mamba2-370m 1x{MA_RANKS} {name} rank {i}"] = \
                g["launches"]["rehearsal_update_sample"]
        c, f = r["clean"], r["failed"]
        if f["restarts"] != 1 or c["restarts"] or f["params"] != c["params"] or \
                f["losses"] != c["losses"] or f["buffer"] != c["buffer"]:
            raise AssertionError(f"rank {i}: the failed run (restarts {f['restarts']}) differs "
                                 f"from the clean one")
        print(f"rank {i}: model rank 1 failed before step {GR_FAIL_AT}; this rank restarted "
              f"once, replayed {replayed} step, and ended with the clean run's parameters, "
              f"buffer and losses bit for bit")
        if r["der_pp"]["aux_fields"] != ["logit_idx", "logit_vals"]:
            raise AssertionError(f"rank {i} der_pp: record fields {r['der_pp']['aux_fields']}")
        if r["serve"]["tokens"] != served:
            raise AssertionError(f"rank {i} serve whisper-tiny --mesh 1x{MA_RANKS}: "
                                 f"{r['serve']['tokens']} vs 1x1 {served}")
        print(f"rank {i} serve --arch whisper-tiny --mesh 1x{MA_RANKS}: token ids == 1x1's "
              f"({len(served)} x {len(served[0])}); {r['serve']['decode_tok_s']:.1f} tok/s "
              f"per sequence ({GLOO})")
    for name in ("clean", "failed", "der_pp"):
        if len({r[name]["buffer"] for r in ranks}) != 1:
            raise AssertionError(f"{name}: the two model ranks' buffers differ")
    print("the two model ranks hold the same buffer in every run (der_pp's top-"
          f"{GR_TOPK} records included)")
    return launches


# ---------------------------------------------------------------------------
# phase 26: GPipe, the sequence-sharded decode cache, the dry run
# ---------------------------------------------------------------------------

# (a) SmolLM-135M whole, bf16, in GP_STAGES stages of 15 layers over 2 gloo
# ranks on cuda:0, phase 11's prefill (B PREFILL_B x S PREFILL_S) in
# GP_MICRO micro-batches of one sequence; (b) the same arch served at 1 x 2
# against 1 x 1 (serving's batch, prompt and generation: a cache of 48
# slots, split over the row since its 3 KV heads do not divide 2), bf16 and
# float8_e4m3fn caches, and bf16 compute; (c) the dry run of phase 11's bf16
# prefill at 1 x 1.
GP_ARCH, GP_STAGES, GP_MICRO, GP_SEED = "smollm-135m", 2, 4, 26
# fp8 against bf16 cache storage, teacher-forced on the bf16 run's ids: the
# logits within FP8_BOUND of the bf16 run's largest |logit| (e4m3 keeps 3
# mantissa bits, bf16 7: each stored K/V moves by up to 2**-4 of itself; the
# card read 0.081 of it, the same decode on the CPU 0.078: the bound is
# about 1.85 times those)
FP8_BOUND = 0.15
# the fp8 cache at 1 x 2 against the fp8 cache at 1 x 1 (f32 compute, TF32
# off, teacher-forced): the row's f32 sums move a K/V across an e4m3
# rounding boundary now and then, a 2**-4 jump that the later layers carry
# into more crossings; the card read 0.0168 of the largest |logit| (this
# bound was set from that reading, about twice it)
FP8_SPLIT = 0.035


def _sc_decode(mesh, cfg, kv_dtype: str, prompts, feed=None, generate: bool = True,
               compute: str = "float32", whole_cache: bool = False):
    """Decode through ``build_decode_step`` on ``mesh`` (``compute`` dtype;
    ``kv_dtype`` cache storage; weights drawn on the card from GP_SEED, this
    rank's shards): the greedy ids (``generate``), each step's logits
    teacher-forced on ``feed`` (gathered over the row), the rank's cache
    bytes and its cache split. ``whole_cache`` builds the step with no
    sequence split (every rank holds the whole cache, as before the split
    existed): it tells a difference the split makes from one the
    tensor-parallel MLP and head make, whose sums over the row round apart
    from 1 x 1's single product."""
    from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
    from repro_torch.launch import steps
    from repro_torch.parallel.tensor import gather_vocab
    from repro_torch.serving import DecodeEngine

    b, p = prompts.shape
    run = RunConfig(model=cfg, train=TrainConfig(compute_dtype=compute, kv_dtype=kv_dtype),
                    scenario=ScenarioConfig(modality="tokens", batch_size=b, seq_len=p + GEN))
    shards = steps.cache_shards
    if whole_cache:
        steps.cache_shards = lambda *a, **k: None
    try:
        built = steps.build_decode_step(run, mesh)
    finally:
        steps.cache_shards = shards
    with torch.device("cuda"):
        params = built.model.init(torch.Generator(device="cuda").manual_seed(GP_SEED), p + GEN,
                                  device="cuda", mp=built.ctx.mp)
    caches = built.model.init_cache(params, b, p + GEN, dtype=built.cache_dtype,
                                    mp=built.ctx.mp, seq=built.ctx.kv_seq)
    nbytes = sum(t.numel() * t.element_size() for c in caches for t in c.values())
    t0 = time.perf_counter()
    ids = DecodeEngine(built.model, built.ctx, cache_dtype=built.cache_dtype,
                       step=built.fn).generate(params, prompts, GEN).tokens.cpu() \
        if generate else None
    logits = []
    if feed is not None:
        with torch.no_grad():
            for t in range(feed.shape[1] - 1):
                lg, caches = built.fn(params, caches, {"token": feed[:, t:t + 1]}, t)
                if lg.shape[-1] != cfg.vocab_size:
                    lg = gather_vocab(lg, built.ctx.mp)
                logits.append(lg.float())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = {k: (v.size, list(v.axes)) for k, v in (built.ctx.kv_seq or {}).items() if v}
    return {"ids": ids, "logits": torch.cat(logits, 1).cpu() if logits else None,
            "cache_bytes": nbytes, "split": split, "wall": wall,
            "dtype": str(caches[0]["k"].dtype)}


def gpipe_rank(counters, cfg, pipe_mesh) -> dict:
    """(a) on this rank: the pipelined bf16 prefill against the unpipelined
    forward (kernels on) and the f32 plain path, its flash launches counted
    from 0, both forwards' times."""
    from repro_torch.models import StackCtx
    from repro_torch.parallel.pipeline import host_staged
    from repro_torch.testdata import pipelined_forward

    model, params, _ = draw_on_card(cfg, PREFILL_S, GP_SEED)
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                                    generator=torch.Generator().manual_seed(2)).cuda()}
    fast = StackCtx(cfg, use_kernel=True, compute_dtype=torch.bfloat16, remat="none")
    with torch.no_grad():
        want, _ = model.forward(params, toks, StackCtx(cfg, use_kernel=False, remat="none"))
        plain16, _ = model.forward(params, toks, StackCtx(cfg, use_kernel=False,
                                                          compute_dtype=torch.bfloat16,
                                                          remat="none"))
        whole, whole_seen, _ = _counted_forward(model, params, toks, fast, counters)

        def piped():
            return pipelined_forward(pipe_mesh, params, toks, cfg, fast, GP_MICRO)

        got, seen, peak = _counted_call(piped, counters)
        ms_pipe = _timed_call(piped) * 1e3
        ms_whole = _timed_forward(model, params, toks, fast) * 1e3
    scale = float(want.abs().max())
    ref_err = abs_err(plain16.float(), want)
    return {"err": abs_err(got.float(), want), "tol": 2 * ref_err + 1e-3 * scale,
            "ref_err": ref_err, "gap_whole": abs_err(got.float(), whole.float()),
            "launches": seen, "whole_launches": whole_seen, "ms_pipe": ms_pipe,
            "ms_whole": ms_whole, "peak": peak, "scale": scale,
            "host_staged": host_staged(pipe_mesh.get_group(0)),
            "shape": list(got.shape), "dtype": str(got.dtype)}


def gpipe_cache_rank(tmp: str):
    """One rank of phase 26's two (``runtime.multiproc`` starts it): joins
    the gloo group on cuda:0, runs (a) on a 2-stage ``pipe`` mesh and (b)'s
    1 x 2 decodes, and writes its results to ``tmp/rank<i>.pt``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = multiproc.init_from_env("gloo")
    cfg = get_config(GP_ARCH)
    out = {"rank": rank,
           "gpipe": gpipe_rank({"flash_attention": fa.flash_attention}, cfg,
                               make_mesh((world,), ("pipe",), "cuda"))}
    row = make_mesh((1, world), ("data", "model"), "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                            generator=torch.Generator().manual_seed(3)).cuda()
    feed = torch.load(os.path.join(tmp, "feed.pt")).cuda()
    out["bf16"] = _sc_decode(row, cfg, "bfloat16", prompts)
    out["fp8"] = _sc_decode(row, cfg, "float8_e4m3fn", prompts, feed, generate=False)
    out["bf16c"] = _sc_decode(row, cfg, "bfloat16", prompts, feed, generate=False,
                              compute="bfloat16")
    out["bf16c_whole"] = _sc_decode(row, cfg, "bfloat16", prompts, feed, generate=False,
                                    compute="bfloat16", whole_cache=True)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    import gc

    gc.collect()
    dist.destroy_process_group()


def dry_run_against_the_card(cfg) -> dict:
    """(c) the dry run of phase 11's bf16 prefill at 1 x 1 (rank 0, nothing
    allocated) against the same step on the card: the arguments' bytes
    exactly, the peaks side by side, the roofline's ideal time beside the
    measured forward."""
    import torch.distributed as dist

    from repro_torch.analysis import roofline
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.base import RunConfig, TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_prefill_step

    if dist.is_initialized():
        raise AssertionError("phase 26 (c) needs no process group: an earlier phase left one")
    shape = ShapeConfig("phase11", PREFILL_S, PREFILL_B, "prefill")
    t0 = time.perf_counter()
    counts = dryrun.count_step(cfg, shape, (1, 1), ("data", "model"), compute_dtype="bfloat16")
    t_dry = time.perf_counter() - t0
    run = RunConfig(model=cfg, train=TrainConfig(compute_dtype="bfloat16"))
    built = build_prefill_step(run, make_mesh((1, 1), ("data", "model"), "cuda"))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = built.model.init(torch.Generator().manual_seed(GP_SEED), PREFILL_S, "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                                     generator=torch.Generator().manual_seed(2),
                                     dtype=torch.int32).cuda()}
    real = {"params": sum(t.numel() * t.element_size() for t in params.state_dict().values()),
            "batch": sum(t.numel() * t.element_size() for t in batch.values())}
    logits = built.fn(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"(c) logits {tuple(logits.shape)} not finite")
    del logits
    ms = _timed_call(lambda: built.fn(params, batch)) * 1e3
    compute_s, memory_s = roofline.ideal_seconds(cfg, "prefill", PREFILL_B * PREFILL_S,
                                                 PREFILL_S, 1, 1, compute_dtype="bfloat16")
    ideal_ms = max(compute_s, memory_s) * 1e3
    rec = roofline.analyze(arch=GP_ARCH, shape="phase11", mesh_name="1x1", kind="prefill",
                           chips=1, cost={"flops": counts["flops"],
                                          "bytes accessed": counts["bytes"]},
                           collectives=[roofline.Collective(*c) for c in counts["collectives"]],
                           active_params=cfg.active_param_count(),
                           tokens_per_step=PREFILL_B * PREFILL_S, compute_dtype="bfloat16")
    del params, batch
    torch.cuda.empty_cache()
    return {"arguments": counts["argument_bytes"], "real": real,
            "dry_peak": counts["peak_bytes"], "card_peak": peak, "flops": counts["flops"],
            "bytes": counts["bytes"], "ideal_ms": ideal_ms, "compute_ms": compute_s * 1e3,
            "memory_ms": memory_s * 1e3, "ms": ms, "share": ideal_ms / ms,
            "counted_compute_ms": rec.compute_s * 1e3, "counted_memory_ms": rec.memory_s * 1e3,
            "dry_s": t_dry}


def gpipe_cache_dryrun_phase(counters) -> dict:
    """Phase 26. Returns the flash launches of each rank's pipelined prefill
    (the kernels line's ``launches_gpipe``)."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import multiproc

    cfg = get_config(GP_ARCH)
    print(f"card: {gpu_name_and_power()}")
    # (b) at 1 x 1 in this process, with TF32 off as on the ranks: the ids
    # the row must give, the feed, and the logits the row's are held to
    one = make_mesh((1, 1), ("data", "model"), "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_B, PROMPT),
                            generator=torch.Generator().manual_seed(3)).cuda()
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        whole16 = _sc_decode(one, cfg, "bfloat16", prompts)
        feed = torch.cat([prompts.cpu(), whole16["ids"]], 1)
        whole16["logits"] = _sc_decode(one, cfg, "bfloat16", prompts, feed.cuda(),
                                       generate=False)["logits"]
        whole8 = _sc_decode(one, cfg, "float8_e4m3fn", prompts)
        whole8["logits"] = _sc_decode(one, cfg, "float8_e4m3fn", prompts, feed.cuda(),
                                      generate=False)["logits"]
        whole16c = _sc_decode(one, cfg, "bfloat16", prompts, feed.cuda(), generate=False,
                              compute="bfloat16")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    tmp = tempfile.mkdtemp(prefix="repro_phase26_")
    try:
        torch.save(feed, os.path.join(tmp, "feed.pt"))
        t0 = time.perf_counter()
        procs = multiproc.launch_workers(
            f"import chip_smoke; chip_smoke.gpipe_cache_rank({tmp!r})", MA_RANKS,
            pythonpath=ROOT + os.pathsep + os.path.join(ROOT, "src"), rendezvous_dir=tmp,
            timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            print(p.stdout[-3000:], end="")
        bad = [(i, p.returncode, p.stderr[-4000:]) for i, p in enumerate(procs) if p.returncode]
        if bad:
            raise AssertionError(f"phase 26 ranks failed: {bad}")
        ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt")) for i in range(MA_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"{MA_RANKS} ranks in {wall:.1f} s ({GLOO})")
    per_stage = cfg.num_layers // GP_STAGES
    expect = per_stage * GP_MICRO  # idle ticks skipped: a stage runs each micro-batch once
    launches, fails = {}, []

    def argmax_steps(a, b):
        return int((a.argmax(-1) != b.argmax(-1)).sum())

    for r in ranks:
        i, g = r["rank"], r["gpipe"]
        launches[f"{GP_ARCH} GPipe stage {i}"] = g["launches"]["flash_attention"]
        print(f"(a) rank {i}: {GP_ARCH} bf16 prefill B {PREFILL_B} x S {PREFILL_S} in "
              f"{GP_STAGES} stages of {per_stage} layers, {GP_MICRO} micro-batches: logits "
              f"{g['shape']} {g['dtype']}, max |GPipe - f32 plain| {g['err']:.3e} (phase 11's "
              f"bound {g['tol']:.3e}: twice the bf16 plain path's {g['ref_err']:.3e} + 1e-3 x "
              f"{g['scale']:.3f}); max |GPipe - unpipelined kernels| {g['gap_whole']:.3e}; "
              f"flash launches {g['launches']['flash_attention']} (expected {expect}: "
              f"{per_stage} layers x {GP_MICRO} micro-batches, idle ticks skipped; the "
              f"unpipelined forward {g['whole_launches']['flash_attention']}); pipelined "
              f"forward {g['ms_pipe']:.1f} ms against the unpipelined {g['ms_whole']:.1f} ms "
              f"(host clock, synchronised: gloo's host round trip; the handoff "
              f"{'through host copies' if g['host_staged'] else 'in device memory'}, "
              f"{GLOO}); the call's peak {g['peak'] / 2**30:.3f} GiB")
        if g["err"] > g["tol"] or not math.isfinite(g["err"]):
            fails.append(f"(a) rank {i}: GPipe logits {g['err']:.3e} > {g['tol']:.3e}")
        if g["launches"]["flash_attention"] != expect or \
                g["whole_launches"]["flash_attention"] != cfg.num_layers:
            fails.append(f"(a) rank {i}: flash launches {g['launches']}, "
                         f"unpipelined {g['whole_launches']}")
        if g["shape"] != [PREFILL_B, PREFILL_S, cfg.vocab_size]:
            fails.append(f"(a) rank {i}: logits {g['shape']}")
        for key, want in (("bf16", whole16), ("fp8", whole8)):
            got = r[key]
            print(f"(b) rank {i} {key} cache at 1 x {MA_RANKS} (f32 compute): cache "
                  f"{got['dtype']} {got['cache_bytes']} bytes on the rank, 1 x 1's "
                  f"{want['cache_bytes']}; split {got['split']}; "
                  + (f"ids {got['ids'].tolist()} (1 x 1: {want['ids'].tolist()}); generate "
                     f"{got['wall']:.2f} s ({GLOO}; 1 x 1 {want['wall']:.2f} s)"
                     if got["ids"] is not None else
                     f"teacher-forced on the bf16 ids in {got['wall']:.2f} s"))
            if got["cache_bytes"] * MA_RANKS != want["cache_bytes"] or got["split"] != {
                    "k": (MA_RANKS, ["model"])}:
                fails.append(f"(b) rank {i} {key}: cache bytes {got['cache_bytes']} "
                             f"against 1 x 1's {want['cache_bytes']}, split {got['split']}")
        if not torch.equal(r["bf16"]["ids"], whole16["ids"]):
            fails.append(f"(b) rank {i}: the bf16 ids differ from 1 x 1's")
        scale = float(whole16["logits"].abs().max())
        gap = abs_err(r["fp8"]["logits"], whole16["logits"])
        split8 = abs_err(r["fp8"]["logits"], whole8["logits"])
        print(f"(b) rank {i}: teacher-forced on the bf16 ids, max |fp8 cache at 1 x 2 - bf16 "
              f"cache at 1 x 1| logits {gap:.3e} (bound {FP8_BOUND} x {scale:.3f}), max |fp8 "
              f"cache at 1 x 2 - fp8 cache at 1 x 1| {split8:.3e} (bound {FP8_SPLIT} x "
              f"{scale:.3f}); greedy ids at 1 x 1 with the fp8 cache {whole8['ids'].tolist()}, "
              f"with bf16 {whole16['ids'].tolist()}")
        if r["fp8"]["cache_bytes"] * 2 != r["bf16"]["cache_bytes"]:
            fails.append(f"(b) rank {i}: fp8 cache {r['fp8']['cache_bytes']} bytes, "
                         f"bf16 {r['bf16']['cache_bytes']}")
        if not gap <= FP8_BOUND * scale:
            fails.append(f"(b) rank {i}: fp8 logits {gap:.3e} from bf16's")
        if not split8 <= FP8_SPLIT * scale:
            fails.append(f"(b) rank {i}: fp8 logits at 1 x 2 {split8:.3e} from 1 x 1's")
        # bf16 compute, the reference's decode cells' dtype: the split cache's
        # combine at 1 x 2 held against the f32 1 x 1 logits within phase 11's
        # bound, twice the bf16 1 x 1 path's error there; beside it the same
        # decode with the whole cache on each rank, which tells the split's
        # own rounding from the tensor-parallel sums'
        c16, c16w = r["bf16c"], r["bf16c_whole"]
        ref16 = abs_err(whole16c["logits"], whole16["logits"])
        err16 = abs_err(c16["logits"], whole16["logits"])
        tol16 = 2 * ref16 + 1e-3 * scale
        print(f"(b) rank {i} bf16 compute, bf16 cache at 1 x {MA_RANKS}, split {c16['split']}, "
              f"teacher-forced: max |1 x 2 - f32 1 x 1| logits {err16:.3e} (bound {tol16:.3e}: "
              f"twice the bf16 1 x 1 path's {ref16:.3e} + 1e-3 x {scale:.3f}); max |split - "
              f"whole cache at 1 x 2| {abs_err(c16['logits'], c16w['logits']):.3e}, max |whole "
              f"cache at 1 x 2 - bf16 1 x 1| {abs_err(c16w['logits'], whole16c['logits']):.3e}; "
              f"of {SERVE_B} x {c16['logits'].shape[1]} steps' argmax, split against bf16 1 x 1 "
              f"{argmax_steps(c16['logits'], whole16c['logits'])} differ, whole cache against "
              f"bf16 1 x 1 {argmax_steps(c16w['logits'], whole16c['logits'])}, split against "
              f"whole {argmax_steps(c16['logits'], c16w['logits'])}")
        if not err16 <= tol16 or c16["split"] != {"k": (MA_RANKS, ["model"])} or c16w["split"]:
            fails.append(f"(b) rank {i}: bf16-compute logits at 1 x 2 {err16:.3e} > "
                         f"{tol16:.3e}, splits {c16['split']} / {c16w['split']}")
    if fails:
        raise AssertionError("; ".join(fails))
    d = dry_run_against_the_card(cfg)
    print(f"(c) dry run of phase 11's bf16 prefill at 1 x 1 ({d['dry_s']:.1f} s on the host, "
          f"nothing allocated): arguments {d['arguments']} bytes; on the card {d['real']}; "
          f"peak {d['dry_peak']} bytes counted (arguments + the most live temporaries, "
          f"unfused), torch.cuda.max_memory_allocated {d['card_peak']} above the memory held "
          f"before; {d['flops']:.4e} flops and {d['bytes']:.4e} bytes counted (their times at "
          f"the card's peaks {d['counted_compute_ms']:.3f} and {d['counted_memory_ms']:.3f} "
          f"ms); the roofline's ideal {d['ideal_ms']:.3f} ms (compute {d['compute_ms']:.3f}, "
          f"memory {d['memory_ms']:.3f}) beside the measured forward {d['ms']:.3f} ms: share "
          f"{d['share']:.4f} ({gpu_name_and_power()})")
    if d["arguments"] != d["real"]:
        raise AssertionError(f"(c) the dry run's arguments {d['arguments']} are not the card's "
                             f"{d['real']}")
    return launches


LINT_RULES = ["RPL001", "RPL002", "RPL010", "RPL020", "RPL021", "RPL030", "RPL031",
              "RPL032", "RPL040", "RPL041"]


def lint_phase(card: str) -> None:
    """Phase 27: the port's replint over the port's tree in a subprocess,
    as a user runs it; any finding, unparsable file or missing rule fails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH")) if p))
    tests = sorted(os.path.join("tests", n) for n in os.listdir(os.path.join(ROOT, "tests"))
                   if n.startswith("test_torch_") and n.endswith(".py"))
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd + ["src/repro_torch", "chip_smoke.py"] + tests + ["--json"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"replint exited {out.returncode}:\n{out.stdout[-6000:]}\n"
                             f"{out.stderr[-3000:]}")
    report = json.loads(out.stdout)
    listing = subprocess.run(cmd + ["--list-rules"], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
    codes = [line.split()[0] for line in listing.stdout.splitlines() if line.strip()]
    if listing.returncode != 0 or codes != LINT_RULES:
        raise AssertionError(f"replint --list-rules exited {listing.returncode} with "
                             f"{codes}, not {LINT_RULES}: {listing.stderr[-2000:]}")
    package = sum(n.endswith(".py") for _, _, names in os.walk(
        os.path.join(ROOT, "src", "repro_torch")) for n in names)
    if report["findings"] or report["errors"] or \
            report["files_checked"] != package + 1 + len(tests):
        raise AssertionError(f"replint's report: {report}")
    print(f"replint (python {sys.version.split()[0]}, torch {torch.__version__}): "
          f"{report['files_checked']} files checked ({len(tests)} test files), 0 findings, "
          f"{report['suppressed']} suppressed, in {seconds:.2f} s; {len(codes)} rules "
          f"listed ({card})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU.")
    ap.add_argument("--only", type=int, nargs="+", metavar="PHASE",
                    help="run phases 1, 2 and these only (3-27), and print no result lines")
    only = set(ap.parse_args(argv).only or ())
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; run it on an NVIDIA GPU")
    from repro_torch.configs import resnet50_cl
    from repro_torch.kernels import build, ref, rehearsal_ops as ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ssd_scan as ssd

    def run(n: int) -> bool:
        return not only or n in only

    counters = {"rehearsal_update_sample": ops.rehearsal_update_sample,
                "quantize_rows": qz.quantize_rows, "dequantize_rows": qz.dequantize_rows,
                "gather_dequant_rows": ops.gather_dequant_rows,
                "encode_scatter_rows": ops.encode_scatter_rows,
                "flash_attention": fa.flash_attention, "ssd_scan": ssd.ssd_scan}

    phase = Phases()
    phase("1 environment")
    card = gpu_name_and_power()
    torch.backends.cudnn.allow_tf32 = True  # convolutions in TF32 (cuDNN default)
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    comparisons_catch_nan()

    phase("2 kernel build")
    t0 = time.perf_counter()
    paths = build.build(SOURCES)
    print(f"built {[os.path.relpath(p, ROOT) for p in paths]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in build.BUILD_LOG.items():
        print(f"[{name}] {log}")

    cfg = resnet50_cl.full()
    if run(3):
        phase("3 kernels against their plain versions")
        entry = kernel_phase(ops, ref, cfg.image_size * cfg.image_size * cfg.channels)
        link = link_rates()
        pinned_update_sample(ops, ref, link[1])
        int8_entries = int8_kernel_phase(qz, ops, ref, link)
        folded = folded_phase(qz, ops, ref, link)

    if run(4):
        phase("4 model on the card against the CPU")
        model_phase(cfg)

    fused_runs, phase5_losses, lm_runs = {}, [], {}
    if run(5):
        phase("5 main path: ContinualTrainer on resnet50_cl.full()")
        fused_runs["flat"] = main_path(counters, cfg, losses_out=phase5_losses)
        flat_launches = fused_runs["flat"][0]

    if run(6):
        phase("6 tiered store at full row width: card against CPU")
        tiered_phase(cfg)

    if run(7):
        phase("7 tiered main path: ContinualTrainer, tiering='host', unfused then fused")
        runs = {fused: tiered_main_path(counters, cfg, fused) for fused in (False, True)}
        fused_runs["tiered, unfused"], fused_runs["tiered, fused"] = runs[False], runs[True]
        if runs[False][1] != runs[True][1]:
            raise AssertionError("fused and unfused tiered runs differ in rep_checksum / "
                                 f"buffer_fill: {runs[False][1]} vs {runs[True][1]}")
        print(f"fused == unfused fingerprints over {len(runs[True][1])} steps; median step "
              f"unfused {runs[False][2]:.1f} ms, fused {runs[True][2]:.1f} ms")

    if run(13):
        phase("13 split pipelined step: the issue half on its own CUDA stream")
        split_phase(counters, cfg, fused_runs)

    if run(14):
        phase("14 strategies and policies on the main path")
        strategy_phase(counters, cfg, fused_runs)

    if run(17):
        phase("17 the domain-incremental and blurry-boundary scenarios on the main path")
        vision_scenario_phase(counters, cfg, fused_runs)

    if run(18):
        phase("18 the resilient main path: checkpoints, restarts, stale steps, scale")
        res_launches = resilient_phase(counters, cfg, fused_runs)

    tf32_off()
    if run(8):
        phase("8 flash attention against its plain version")
        flash_entry = flash_phase(fa, ref)

    if run(9):
        phase("9 SSD scan against its plain version")
        ssd_entry = ssd_phase(ssd, ref)

    weights = LMWeights()
    if run(10):
        phase("10 the LM path's models at full width on the card against the CPU")
        lm_model_phase(weights)

    if run(11):
        phase("11 LM main path: prefill at full width, kernels against the plain path")
        launches = prefill_phase(counters, ssd, weights)

    decode_cli = {}
    if run(12):
        phase("12 LM serving: greedy decode at full width")
        decode_cli = serving_phase(weights)
    del weights
    torch.cuda.empty_cache()

    if run(21):
        phase("21 MoE and hybrid stacks at full width: Mixtral-8x7B, Phi-3.5-MoE, Jamba-v0.1")
        moe_launches, moe_flash, moe_scan = moe_phase(counters, fa, ssd, ref)

    if run(22):
        phase("22 Qwen2-VL-72B and Whisper-tiny served; Mixtral and Jamba trained")
        vlm_launches, vlm_flash, moe_trained = encdec_vlm_phase(counters, fa, ssd, ref)

    if run(23):
        phase("23 the model axis on one card: 2 gloo ranks, tensor-parallel prefill, train, serve")
        ma_flash, ma_scan, ma_update = model_axis_phase(counters, fa, ssd, ref)

    if run(24):
        phase("24 the train step's memory knobs: remat, ZeRO-1 and sequence parallelism")
        mk_flash, mk_scan, mk_update, _ = memory_knobs_phase(counters)

    if run(25):
        phase("25 the ghost block; restarts, der_pp and Whisper on a model axis of 2")
        gr_launches = ghost_and_model_axis_phase(counters, fused_runs, cfg)

    if run(15):
        phase("15 LM training: ContinualTrainer on the token scenarios at full width")
        lm_runs = lm_train_phase(counters, qz, ops, ref)

    if run(16):
        phase("16 online serving: OnlineLearner at full width")
        online_phase(counters, decode_cli)

    if run(19):
        phase("19 the mesh backend: ContinualTrainer(mesh=1x1) and launch.train --mesh 1x1")
        mesh_launches = mesh_phase(counters, cfg, fused_runs, phase5_losses, lm_runs)

    if run(20):
        phase("20 telemetry: obs on the main path, PhasePipeline, an agreed restart, serving")
        obs_launches = obs_phase(counters, cfg)

    if run(26):
        phase("26 GPipe on 2 gloo ranks; the sequence-sharded decode cache; the dry run")
        gp_flash = gpipe_cache_dryrun_phase(counters)

    if run(27):
        phase("27 the port's invariant lint on the card's machine")
        lint_phase(card)
    phase.end()

    if only:
        print(f"phases {sorted(only)} passed; no result lines without every phase")
        return
    entry["launches"] = flat_launches
    for e in int8_entries:
        e["launches"] = runs[e["name"] in ("gather_dequant_rows", "encode_scatter_rows")][0][
            e["name"]]
    for e in int8_entries:
        if e["name"] == "dequantize_rows":
            e.update(folded)
    # the launches of phase 15's runs, each counted from 0 over its own fit,
    # and of phase 22's MoE and hybrid training runs
    lm_launches = {name: r["launches"] for name, r in lm_runs.items()}
    lm_launches.update(moe_trained)
    for e in [entry] + int8_entries:
        e["launches_lm_train"] = {name: n[e["name"]] for name, n in lm_launches.items()
                                  if n[e["name"]]}
        # phase 18's runs, each counted from 0 (failed runs: replays included)
        e["launches_resilient"] = {name: n[e["name"]] for name, n in res_launches.items()
                                   if n[e["name"]]}
        # phase 19's runs through the mesh backend, each counted from 0
        e["launches_mesh"] = {name: n[e["name"]] for name, n in mesh_launches.items()
                              if n.get(e["name"])}
        # phase 20's runs (obs off and on, PhasePipeline and the fused step
        # beside it, the agreed restart), each counted from 0
        e["launches_obs"] = {name: n[e["name"]] for name, n in obs_launches.items()
                             if n.get(e["name"])}
    # phase 23's train CLI on each rank of the model axis, counted from 0
    entry["launches_model_axis"] = ma_update
    # phase 24: the ZeRO-1 trainer's and the sequence-parallel prefill's, each
    # rank's counted from 0
    entry["launches_zero1"] = mk_update
    # phase 25: the ghost ResNet's flat fit, and on each rank of the 1 x 2 row
    # the resilient runs (the failed one's replay included) and der_pp's
    entry["launches_phase25"] = gr_launches
    flash_entry["launches_sequence_parallel"] = mk_flash
    ssd_entry["launches_sequence_parallel"] = mk_scan
    # phase 11's launches a forward: SmolLM-135M's and Mamba2-370M's, then
    # every arch's, phase 21's at its cuts of depth; phase 21's times at
    # the MoE and hybrid stacks' shapes
    launches.update(moe_launches)
    launches.update(vlm_launches)
    flash_entry.update(vlm_flash)
    flash_entry.update(ma_flash)  # phase 23: the local heads of a rank, its launches
    # phase 26: each GPipe stage's launches in one pipelined prefill
    flash_entry["launches_gpipe"] = gp_flash
    ssd_entry.update(ma_scan)
    for target, name, arch, update in (
            (flash_entry, "flash_attention", "smollm-135m", moe_flash),
            (ssd_entry, "ssd_scan", "mamba2-370m", moe_scan)):  # scan: layers x 3 kernels
        target["launches"] = launches[arch][name]
        target["launches_by_arch"] = {a: n[name] for a, n in launches.items() if n[name]}
        target.update(update)
    print(card)
    print(json.dumps({"kernels": [entry] + int8_entries + [flash_entry, ssd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
