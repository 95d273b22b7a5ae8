#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. environment: card name and power limit, torch and CUDA versions, TF32 flags;
  2. kernel build from the sources in this checkout (nvcc, timed);
  3. every kernel against its plain PyTorch version on the card, bit for bit,
     at the main path's shapes and over a seeded sweep; times and bounds;
  4. the port's ResNet-50 at full width on the card against the same model
     on the CPU, on a small input;
  5. the main path: ``ContinualTrainer`` on ``resnet50_cl.full()`` (224x224x3,
     1000 classes, 4 tasks of 250 classes) with async rehearsal, reservoir
     policy and a flat buffer of 4 x 500 records, for 2 tasks x 4 steps. It
     checks that every buffer update+sample went through the CUDA kernel and
     that losses, buffer fill and the accuracy matrix are sane.

The second line from the end is a JSON object with one entry per kernel
(time, launches, bound, plain and library times); the last line is
``{"ok": true, "device": {...}}``. The script needs ``src/repro_torch`` beside
it and a visible CUDA device; without either it fails before printing a result.
"""
from __future__ import annotations

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
L2_FLUSH_BYTES = 64 << 20  # larger than the 50 MB L2

# Data-scale cuts of the main path; the model's widths and the image size are
# never cut.
TASKS_RUN = 2  # of the stream's 4 tasks
STEPS_PER_TASK = 4
EVAL_PER_CLASS = 2
BATCH, REPS, CANDS, SLOTS = 16, 2, 4, 500  # b, r, c per worker; slots per bucket


def phase(name: str):
    print(f"\n== {name}", flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


HOLD_CYCLES = 2_000_000  # about 1 ms of GPU spin at the H100's clock


def time_ms(fn, iters: int = 30, warmup: int = 3, hold: bool = True) -> float:
    """Median time of ``fn`` in ms between CUDA events over ``iters`` runs,
    each started with a cold L2 (the train step evicts it between buffer
    updates). With ``hold`` the GPU spins before the start event while the
    host enqueues ``fn``, so the events time the device work alone; without
    it they also time the GPU idling on the host's launch overhead."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
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
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.double() - b.double()).abs().max())


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
    worst = max(worst, sweep(ops, ref))

    # the work of one step: 3 calls (one per record leaf)
    def kernel_step():
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
    plain_ms = time_ms(plain_step)
    library_ms = time_ms(library_step)
    ms_again = time_ms(kernel_step)
    host_ms = time_ms(kernel_step, hold=False)
    library_host_ms = time_ms(library_step, hold=False)
    accepted = len(winners)
    moved_rows = 2 * accepted + 2 * REPS  # read + write of each accepted and sampled row
    row_bytes = sum(v.shape[1] * v.element_size() for v in leaves.values())
    index_bytes = len(leaves) * 4 * (BATCH + REPS)
    total_bytes = moved_rows * row_bytes + index_bytes
    bound_ms = total_bytes / HBM_BYTES_PER_S * 1e3
    print(f"one step (3 leaves, {accepted} accepted + {REPS} sampled rows, "
          f"{total_bytes} bytes), device time: kernel {ms:.4f} ms (repeat "
          f"{ms_again:.4f}), plain {plain_ms:.4f} ms, index_copy_+index_select "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms (bytes at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s)")
    print(f"same step with the GPU waiting on the host's launches: kernel "
          f"{host_ms:.4f} ms, index_copy_+index_select {library_host_ms:.4f} ms")
    return {"name": "rehearsal_update_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rehearsal_ops.cu",
            "replaces": "src/repro/kernels/rehearsal_ops.py:225",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}


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


def main_path(ops, cfg, seed: int = 0):
    from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig
    from repro_torch.data import ClassIncrementalImages, ImageStreamConfig
    from repro_torch.scenario import ClassIncremental, ContinualTrainer

    sc = ScenarioConfig(num_tasks=4, classes_per_task=250, image_size=cfg.image_size,
                        batch_size=BATCH, epochs_per_task=1,
                        steps_per_epoch=STEPS_PER_TASK, seed=seed)
    run = RunConfig(model=cfg, scenario=sc, rehearsal=RehearsalConfig(
        slots_per_bucket=SLOTS, num_representatives=REPS, num_candidates=CANDS,
        mode="async", policy="reservoir", tiering="off"))
    stream = ClassIncrementalImages(ImageStreamConfig(
        num_tasks=sc.num_tasks, classes_per_task=sc.classes_per_task,
        image_size=sc.image_size, noise=sc.noise, eval_per_class=EVAL_PER_CLASS,
        seed=1234 + seed))
    print(f"cuts (data scale only): tasks run {TASKS_RUN} of {sc.num_tasks}, "
          f"{STEPS_PER_TASK} steps per task, eval_per_class {EVAL_PER_CLASS}; "
          f"b={BATCH} r={REPS} c={CANDS}, {sc.num_tasks} buckets x {SLOTS} slots")
    trainer = ContinualTrainer(run, ClassIncremental(sc, stream=stream), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.rehearsal_update_sample.launches = 0
    t0 = time.perf_counter()
    result = trainer.fit(num_tasks=TASKS_RUN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.rehearsal_update_sample.launches
    steps = TASKS_RUN * STEPS_PER_TASK

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
    print(f"kernel launches on the main path: {launches} (3 leaves x {steps} steps)")
    if launches != 3 * steps:
        raise AssertionError(f"expected {3 * steps} kernel launches, saw {launches}")
    if len(result.losses) != steps or not all(math.isfinite(x) for x in result.losses):
        raise AssertionError(f"non-finite or missing losses: {result.losses}")
    if not fills[-1] > fills[0]:
        raise AssertionError(f"buffer_fill did not grow: {fills}")
    if acc.shape != (TASKS_RUN, TASKS_RUN) or not np.isfinite(acc).all():
        raise AssertionError(f"bad accuracy matrix {acc}")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; run it on an NVIDIA GPU")
    from repro_torch.configs import resnet50_cl
    from repro_torch.kernels import build, ref, rehearsal_ops as ops

    phase("1 environment")
    card = gpu_name_and_power()
    torch.backends.cudnn.allow_tf32 = True  # convolutions in TF32 (cuDNN default)
    torch.backends.cuda.matmul.allow_tf32 = True
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    print(f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    phase("2 kernel build")
    t0 = time.perf_counter()
    paths = build.build(["rehearsal_ops"])
    print(f"built {[os.path.relpath(p, ROOT) for p in paths]} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in build.BUILD_LOG.items():
        print(f"[{name}] {log}")

    cfg = resnet50_cl.full()
    phase("3 kernels against their plain versions")
    entry = kernel_phase(ops, ref, cfg.image_size * cfg.image_size * cfg.channels)

    phase("4 model on the card against the CPU")
    model_phase(cfg)

    phase("5 main path: ContinualTrainer on resnet50_cl.full()")
    entry["launches"] = main_path(ops, cfg)

    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
