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
     fingerprints and launches equal to the fused runs', then both forms
     profiled (``repro_torch.profile_main_path``, one process each, so that
     no profiler session runs in this one): median step, idle share,
     the stream each kernel ran on, and the issue half's time during the
     train half's kernels.
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
     in temporary directories deleted after each run: (a) phase 5's flat
     configuration with ``ResilienceConfig(checkpoint_every=3,
     max_restarts=2)``, a clean run and one with a failure injected before
     step 5: restarts 0 and 1, histories, losses, accuracy matrices and final
     checkpoints bit for bit, 8 and 10 update+sample launches; (b) the same
     on phase 7's fused tiered store, its int8 kernels once a step, replays
     included, the restored cold tier pinned; (c) stale steps (delay 0.5,
     staleness 2): update+sample launches = steps - stale steps; (d)
     ``scale_carry`` 1 -> 2 -> 1 of the restored flat and tiered carries,
     every record kept; (e) ``OnlineLearner`` at SmolLM-135M full width, 4
     rounds, a transient failure (a restart, every round trained) and a
     persistent one (training off, serving on the last checkpoint's weights
     bit for bit); (f) the train CLI with ``--ckpt-dir --resilience``.
     Checkpoint bytes, save (snapshot, write) and restore ms, the median
     step beside phase 5's.
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
     4, its eval lines and launches), update+sample and the int8 kernels on
     these token records against their plain versions, and reduced LM steps
     on the card against the CPU through the ``rows`` seam.
 16. online serving (after phase 15, TF32 off): ``OnlineLearner(run).run()``
     on the serve CLI's ``--online`` run at its defaults (batch 4, prompt 32,
     gen 16, 8 rounds of 1 train step, a drift over 3 anchors, AdamW f32,
     async reservoir) with SmolLM-135M, then Mamba2-370M, at full width over
     a drift stream of min(V, 2048) ids. Each run: every round trained at
     freshness 1, admission 1.0, finite losses, 8 update+sample launches and
     no other kernel, the serving copy equal to the train weights bit for
     bit; decode tokens/s per sequence beside phase 12's, train ms a round,
     the handoff copy's ms, peak memory. Then SmolLM-135M with a failure
     injected before round 5's step: every round still served and serving
     ends on round 4's handed-off weights bit for bit. Then
     ``serve.main(["--online"])`` on the card at the CLI's defaults.
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


def model_phase(cfg):
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
    print(f"ResNet-50 full width, 2 images 32x32, TF32 off: logits {tuple(got.shape)}, "
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


def class_incremental_trainer(cfg, rehearsal, seed: int = 0, **kw):
    """``ContinualTrainer`` on ``cfg`` over ``class_incremental_stream`` with
    the rehearsal fields ``rehearsal`` (r, c and async mode fixed); ``kw``
    goes to the trainer."""
    from repro_torch.configs.base import RehearsalConfig, RunConfig
    from repro_torch.scenario import ClassIncremental, ContinualTrainer

    sc, stream = class_incremental_stream(cfg, seed)
    run = RunConfig(model=cfg, scenario=sc, rehearsal=RehearsalConfig(
        num_representatives=REPS, num_candidates=CANDS, mode="async", **rehearsal))
    return ContinualTrainer(run, ClassIncremental(sc, stream=stream), device="cuda", **kw)


FLAT = dict(slots_per_bucket=SLOTS, policy="reservoir", tiering="off")


def tiered_rehearsal(fused: bool) -> dict:
    return dict(policy="reservoir", tiering="host", hot_slots=HOT, cold_slots=COLD,
                fused_kernels=fused)


def main_path(counters, cfg, seed: int = 0, step_form: str = "fused"):
    """The flat main path through ``ContinualTrainer(step_form=...)``
    (``fit_flat``). Returns the update+sample launches, the fingerprints and
    the median step in ms."""
    print(f"cuts (data scale only): tasks run {TASKS_RUN} of 4, "
          f"{STEPS_PER_TASK} steps per task, eval_per_class {EVAL_PER_CLASS}; "
          f"b={BATCH} r={REPS} c={CANDS}, 4 buckets x {SLOTS} slots")
    trainer = class_incremental_trainer(cfg, FLAT, seed, step_form=step_form)
    return fit_flat(counters, trainer, f"flat, step_form={step_form!r}")


def fit_flat(counters, trainer, what: str):
    """``trainer.fit`` over the first ``TASKS_RUN`` tasks, every launch
    counter set to 0 just before and read just after. Checks one
    update+sample launch a step (a flat buffer) and no other kernel, finite
    losses, a growing ``buffer_fill`` and a finite accuracy matrix. Returns
    the update+sample launches, the ``(rep_checksum, buffer_fill)`` history
    and the median step in ms."""
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


def profile_subprocess(tiered: bool, split: bool) -> dict:
    """``repro_torch.profile_main_path`` in a process of its own (its
    profiler session cannot touch the later phases' host times); prints its
    report and returns its JSON."""
    import tempfile
    flags = (["--tiered"] if tiered else []) + (["--split"] if split else [])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.profile_main_path", "--steps", "6",
             "--warmup", "3", "--out", path, *flags], capture_output=True, text=True,
            timeout=600, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        print(proc.stdout, end="")
        if proc.returncode != 0:
            raise AssertionError(f"profile_main_path {flags} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        with open(path) as f:
            return json.load(f)


def split_phase(counters, cfg, fused_runs: dict):
    """``ContinualTrainer(step_form='split')`` on the configurations of phases
    5 and 7 (flat, and tiered unfused): the histories of ``rep_checksum``
    and ``buffer_fill`` must equal the fused runs' (``fused_runs``, from
    phases 5 and 7 when they ran, else run here), with the same launch
    counts. Then the profiled step (``repro_torch.profile_main_path``) of
    both forms: median step, idle share, and on which stream the issue
    half's kernels ran and how much of them ran during the train half's."""
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
    profiles = {}
    for name, tiered in (("flat", False), ("tiered, unfused", True)):
        for form in ("fused", "split"):
            out = profile_subprocess(tiered, form == "split")
            st = out["streams"]
            on_train = st["buffer_kernel_streams"] == [st["train_stream"]]
            if not st["buffer_kernel_streams"] or on_train != (form == "fused"):
                raise AssertionError(f"{name} {form}: update+sample ran on streams "
                                     f"{st['buffer_kernel_streams']}, the train stream is "
                                     f"{st['train_stream']}")
            profiles[(name, form)] = out
            torch.cuda.empty_cache()
    for name in steps_ms:
        f, sp = profiles[(name, "fused")], profiles[(name, "split")]
        print(f"{name}: trainer median step fused {steps_ms[name][0]:.1f} ms, split "
              f"{steps_ms[name][1]:.1f} ms; profiled step wall fused "
              f"{f['wall_ms_per_step']:.2f} ms, split {sp['wall_ms_per_step']:.2f} ms; idle "
              f"share fused {f['device_idle_share']:.4f}, split {sp['device_idle_share']:.4f}")
    return steps_ms, profiles


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
    bucket per class: 1000 x 2 slots). The streams hold ``EVAL_PER_CLASS``
    eval images a class: the domain stream's eval set covers every class."""
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
            noise=sc.noise, domain_shift=sc.domain_shift, eval_per_class=EVAL_PER_CLASS,
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
    on the host and held there for phases 10-12: drawing a 2.5-2.8 B model
    takes the host tens of seconds. A phase moves one arch's weights to the
    card (``on_card``) and back before the next, so a peak it reads holds
    that arch's weights alone."""

    def __init__(self, seed: int = 10):
        self.seed, self.held = seed, {}

    def on_host(self, arch: str):
        """(cfg, model, params) of ``arch`` on the host, drawn at first use."""
        from repro_torch.configs import get_config
        from repro_torch.models import build_model

        if arch not in self.held:
            cfg = get_config(arch)
            model = build_model(cfg)
            self.held[arch] = cfg, model, model.init(
                torch.Generator().manual_seed(self.seed), PREFILL_S, device="cpu")
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


def _timed_forward(model, params, toks, ctx, reps: int = 4):
    """Median host time of a synchronised forward over reps - 1 runs after one."""
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.forward(params, {"tokens": toks}, ctx)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return statistics.median(runs[1:])


def _counted_forward(model, params, toks, ctx, counters):
    """One forward with every launch count set to 0 just before it: (logits,
    launches by kernel, peak device memory)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    out, _ = model.forward(params, {"tokens": toks}, ctx)
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in counters.items()}, \
        torch.cuda.max_memory_allocated()


def prefill_phase(counters, ssd, weights: LMWeights):
    """Prefill at full width with the kernels (the LM main path) against the
    plain path, in f32 and in bf16. Returns each arch's kernel and its
    launches per f32 forward."""
    launches = {}
    for arch in LM_ARCHS:
        with weights.on_card(arch) as (cfg, model, params):
            launches[arch] = _prefill_arch(counters, ssd, arch, cfg, model, params)
    return launches


def _prefill_arch(counters, ssd, arch, cfg, model, params):
    from repro_torch.models import StackCtx

    toks = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S),
                         generator=torch.Generator().manual_seed(2)).cuda()
    kernel = "ssd_scan" if cfg.family == "ssm" else "flash_attention"
    per_layer = ssd.KERNELS_PER_CALL if kernel == "ssd_scan" else 1
    expect = {name: (cfg.num_layers * per_layer if name == kernel else 0) for name in counters}
    tokens = PREFILL_B * PREFILL_S
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": toks}, StackCtx(cfg, use_kernel=False))
        scale = float(want.abs().max())
        for dtype in (torch.float32, torch.bfloat16):
            fast = StackCtx(cfg, use_kernel=True, compute_dtype=dtype)
            slow = StackCtx(cfg, use_kernel=False, compute_dtype=dtype)
            got, seen, peak = _counted_forward(model, params, toks, fast, counters)
            if seen != expect:
                raise AssertionError(f"{arch} {dtype}: expected launches {expect}, saw {seen}")
            if got.shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or got.dtype != dtype:
                raise AssertionError(f"bad logits {tuple(got.shape)} {got.dtype}")
            if dtype == torch.float32:
                launched = kernel, seen[kernel]
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
                plain16, _ = model.forward(params, {"tokens": toks}, slow)
                ref_err = abs_err(plain16.float(), want)
                tol = 2 * ref_err + 1e-3 * scale
                err = close(got.float(), want, tol, 0.0, f"{arch} bf16 prefill kernels vs f32")
                check = (f"max |kernels - f32 plain| {err:.3e}, bf16 plain path's "
                         f"{ref_err:.3e} (tolerance {tol:.3e})")
                del plain16
            del got
            t_fast = _timed_forward(model, params, toks, fast)
            t_slow = _timed_forward(model, params, toks, slow)
            t_again = _timed_forward(model, params, toks, fast)
            print(f"{arch} prefill {str(dtype)[6:]} B {PREFILL_B} x S {PREFILL_S}: "
                  f"{seen[kernel]} {kernel} launches per forward ({per_layer} per layer); "
                  f"logits {check}; median forward with kernels {t_fast * 1e3:.1f} ms (again "
                  f"{t_again * 1e3:.1f}) = {tokens / t_fast:.0f} tokens/s, plain path "
                  f"{t_slow * 1e3:.1f} ms = {tokens / t_slow:.0f} tokens/s; peak memory with "
                  f"kernels {peak / 2**30:.2f} GiB")
        del want
    return launched


def serving_phase(weights: LMWeights, seed: int = 12):
    """Greedy serving at full width: the CLI's path (which draws its own
    weights from ``seed``), and DecodeEngine's decode logits at every prompt
    position against the teacher-forced forward on the held weights.
    Returns the CLI path's decode tokens/s per sequence by arch."""
    from repro_torch.launch import serve

    decode = {}
    for arch in LM_ARCHS:
        res = serve.main(["--arch", arch, "--batch", str(SERVE_B), "--prompt-len", str(PROMPT),
                          "--gen-len", str(GEN), "--seed", str(seed)])
        decode[arch] = res.tokens_per_second
        if res.tokens.shape != (SERVE_B, GEN) or res.tokens.device.type != "cuda":
            raise AssertionError(f"bad generation {tuple(res.tokens.shape)} {res.tokens.device}")
        print(f"{arch} serve (CLI path): prefill {res.prefill_seconds:.3f} s for {PROMPT} "
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
                 scenario: str = "class_incremental", seed: int = 0):
    """``ContinualTrainer`` on a token scenario at full width, on the train
    CLI's run (``lm_cli_run``). Every counter is set to 0 just before
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
            + f", {dtype}, {tasks} x {steps} steps")
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
    return {"launches": launches, "history": history}


def lm_cli_main(counters, arch: str = "smollm-135m", tasks: int = 2, steps: int = 4):
    """The train CLI itself, ``launch.train.main``, at full width on its
    default device (the card), ``tasks`` x ``steps`` steps. Counters are set
    to 0 just before and read just after. Checks one update+sample launch a
    step and no other kernel, every logged loss finite and an eval line for
    every task seen after each task; prints the CLI's log lines."""
    import logging

    from repro_torch.launch import train as train_cli

    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep, log = Keep(), logging.getLogger(train_cli.log.name)
    log.addHandler(keep)
    for fn in counters.values():
        fn.launches = 0
    try:
        result = train_cli.main(["--arch", arch, "--tasks", str(tasks),
                                 "--steps-per-task", str(steps)])
        torch.cuda.synchronize()
    finally:
        log.removeHandler(keep)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"{arch} through the train CLI ({tasks} x {steps} steps): "
          + " | ".join(line for line in lines if not line.startswith("step "))
          + f"; losses {[round(x, 4) for x in result.losses]}")
    want = dict({k: 0 for k in counters}, rehearsal_update_sample=tasks * steps)
    evals = [line for line in lines if line.startswith("eval after task")]
    if launches != want:
        raise AssertionError(f"train CLI: expected launches {want}, saw {launches}")
    if "device=cuda" not in lines[0] or len(evals) != tasks * (tasks + 1) // 2:
        raise AssertionError(f"train CLI: log lines {lines}")
    if len(result.losses) != tasks * steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"train CLI: non-finite or missing losses {result.losses}")
    return {"launches": launches}


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
    train CLI's ``main``, 2 tasks x 4 steps; the token records' kernels
    against their plain versions; the reduced card-against-CPU steps. Returns each run's
    launches and history by name."""
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
    runs["smollm-135m train CLI"] = lm_cli_main(counters)
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
ONLINE_ROUNDS, ONLINE_PHASES, ONLINE_FAIL_AT = 8, 3, 5
ONLINE_ARCHS = ("smollm-135m", "mamba2-370m")


def online_run(arch: str):
    """The ``RunConfig`` of the serve CLI's ``--online`` at its defaults, with
    ``arch`` at full width in place of the reduced LM and the drift stream
    over min(V, 2048) ids."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    args = serve.parse_args(["--online"])
    got = (args.batch, args.prompt_len, args.gen_len, args.rounds, args.train_every,
           args.phases, args.dtype)
    want = (SERVE_B, PROMPT, GEN, ONLINE_ROUNDS, 1, ONLINE_PHASES, "float32")
    if got != want:
        raise AssertionError(f"the serve CLI's --online defaults moved: {got}, phase 16 "
                             f"reads {want}")
    run = serve.build_online_run(args)
    cfg = get_config(arch)
    return dataclasses.replace(run, model=cfg, scenario=dataclasses.replace(
        run.scenario, vocab_size=min(cfg.vocab_size, 2048)))


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
    CLI's defaults. Checks 8 rounds trained at freshness 1, one update+sample
    launch a round and no other kernel."""
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
    if launches != dict({k: 0 for k in counters}, rehearsal_update_sample=ONLINE_ROUNDS):
        raise AssertionError(f"serve --online: launches {launches}")
    if (res.last_tokens.device.type != "cuda" or res.train_disabled
            or [h["freshness"] for h in res.history] != [1.0] * ONLINE_ROUNDS):
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
RES_EVERY, RES_FAIL_AT, RES_ONLINE_ROUNDS = 3, 5, 4
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
        print(f"online, {name} failure: restarts {res.restarts}, trained {trained}, "
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
    """Case (f): ``launch.train.main`` at SmolLM-135M full width, 1 task x 4
    steps, with ``--ckpt-dir --resilience --resilience-checkpoint-every 2``."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    tmp = tempfile.mkdtemp(prefix="repro_phase18_cli_")
    try:
        for fn in counters.values():
            fn.launches = 0
        res = train.main(["--arch", "smollm-135m", "--tasks", "1", "--steps-per-task", "4",
                          "--ckpt-dir", tmp, "--resilience",
                          "--resilience-checkpoint-every", "2"])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
        steps = CheckpointManager(os.path.join(tmp, "resilient")).list_steps()
        print(f"train CLI --resilience: losses {[round(x, 4) for x in res.losses]}, restarts "
              f"{res.restarts}, stats {res.resilience_stats}, restart checkpoints {steps}, "
              f"launches {({k: v for k, v in launches.items() if v})}")
        if (res.restarts or len(res.losses) != 4
                or not all(math.isfinite(x) for x in res.losses) or steps != [0, 2, 4]
                or launches != dict({k: 0 for k in counters}, rehearsal_update_sample=4)):
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
          f"is about 1.3 GB, and a run keeps up to 3 + {TASKS_RUN})")
    print(f"retried: {[e.__name__ for e in TRANSIENT_EXCEPTIONS]}")
    base = fused_runs.get("flat")
    base_ms = f"{base[2]:.1f} ms" if base else "not run"
    launches = {}
    with deterministic_mode() as caught:
        flat, flat_ms, launches["flat_clean"], launches["flat_failed"] = resilient_case(
            counters, cfg, "(a) flat", FLAT, (), base_ms)
        tiered, _, launches["tiered_fused_clean"], launches["tiered_fused_failed"] = \
            resilient_case(counters, cfg, "(b) tiered, fused kernels", tiered_rehearsal(True),
                           ("gather_dequant_rows", "encode_scatter_rows"), base_ms)
        if not all(t.is_pinned() for leaf in tiered.buffer.cold.data.values()
                   for t in leaf.values()):
            raise AssertionError("(b): the restored cold tier is not in pinned memory")
        print("(b): the restored cold tier is in pinned memory")
        stale = ResilienceConfig(checkpoint_every=RES_EVERY, max_restarts=2,
                                 straggler_delay_prob=0.5, max_staleness=2)
        result, launches["stale"], _, wall, _, _ = resilient_fit(counters, cfg, FLAT, stale,
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


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke test of the port on one NVIDIA GPU.")
    ap.add_argument("--only", type=int, nargs="+", metavar="PHASE",
                    help="run phases 1, 2 and these only (3-18), and print no result lines")
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

    fused_runs = {}
    if run(5):
        phase("5 main path: ContinualTrainer on resnet50_cl.full()")
        fused_runs["flat"] = main_path(counters, cfg)
        flat_launches = fused_runs["flat"][0]

    if run(6):
        phase("6 tiered store at full row width: card against CPU")
        tiered_phase(cfg)

    if run(7):
        phase("7 tiered main path: ContinualTrainer, tiering='host', unfused then fused")
        runs = {fused: tiered_main_path(counters, cfg, fused) for fused in (False, True)}
        fused_runs["tiered, unfused"] = runs[False]
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

    if run(15):
        phase("15 LM training: ContinualTrainer on the token scenarios at full width")
        lm_runs = lm_train_phase(counters, qz, ops, ref)

    if run(16):
        phase("16 online serving: OnlineLearner at full width")
        online_phase(counters, decode_cli)
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
    # the launches of phase 15's runs, each counted from 0 over its own fit
    lm_launches = {name: r["launches"] for name, r in lm_runs.items()}
    for e in [entry] + int8_entries:
        e["launches_lm_train"] = {name: n[e["name"]] for name, n in lm_launches.items()
                                  if n[e["name"]]}
        # phase 18's runs, each counted from 0 (failed runs: replays included)
        e["launches_resilient"] = {name: n[e["name"]] for name, n in res_launches.items()
                                   if n[e["name"]]}
    # phase 11's launches a forward: SmolLM-135M's, then every arch's
    flash_entry["launches"] = launches["smollm-135m"][1]
    flash_entry["launches_by_arch"] = {a: n for a, (k, n) in launches.items()
                                       if k == "flash_attention"}
    ssd_entry["launches"] = launches["mamba2-370m"][1]  # num_layers x KERNELS_PER_CALL
    print(card)
    print(json.dumps({"kernels": [entry] + int8_entries + [flash_entry, ssd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
