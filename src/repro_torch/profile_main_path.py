#!/usr/bin/env python3
"""Where the time of the port's main-path train step goes, on one GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_main_path [--steps 3] [--out FILE]
        [--tiered [--fused]]

Builds the step ``chip_smoke.py`` drives (ResNet-50 at full width, 224x224x3,
1000 classes, async rehearsal, b=16 r=2 c=4, 4 x 500 buffer slots; with
``--tiered`` the tiered store of its phase 7, 4 x 4 hot and 4 x 1000 int8
cold slots in pinned host memory, ``--fused`` for the fused kernels) through
the public API, warms it up, then runs ``--steps`` steps under
``torch.profiler``. Prints the median wall time of a step (timed without the
profiler), the device-busy time and idle share of it, and device time by
kernel group (convolution and matmul, GroupNorm, cuDNN layout transposes,
elementwise, reductions, the buffer's kernels, the rest), plus the top
kernels; writes the same as JSON to ``--out``.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

GROUPS = (("buffer kernels", ("update_sample_kernel", "quantize_rows_kernel",
                               "dequantize_rows_kernel")),
          ("groupnorm", ("RowwiseMoments", "ComputeInternalGradients", "GroupNorm",
                         "group_norm", "ComputeFusedParams", "GammaBeta")),
          ("layout transpose", ("nchwToNhwc", "nhwcToNchw")),
          ("convolution/matmul", ("conv", "gemm", "cutlass", "xmma", "wgrad", "dgrad",
                                  "implicit", "winograd", "fft", "cudnn")),
          ("elementwise/copy", ("elementwise", "clamp", "copy", "Memcpy", "memset",
                                "fill", "CatArrayBatched")),
          ("reduction", ("reduce", "Reduce")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiered", action="store_true", help="the tiered store")
    ap.add_argument("--fused", action="store_true", help="its fused kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile_main_path: needs a CUDA device")

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import resnet50_cl
    from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig
    from repro_torch.optim import make_optimizer
    from repro_torch.rng import fold_in
    from repro_torch.scenario import ClassIncremental
    from repro_torch.strategy import init_carry, make_cl_step

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    cfg = resnet50_cl.full()
    sc = ScenarioConfig(num_tasks=4, classes_per_task=250, image_size=224, batch_size=16)
    tiering = (dict(tiering="host", hot_slots=4, cold_slots=1000, fused_kernels=args.fused)
               if args.tiered else {})
    run = RunConfig(model=cfg, scenario=sc, rehearsal=RehearsalConfig(
        num_buckets=4, slots_per_bucket=500, num_representatives=2, num_candidates=4,
        mode="async", label_field="label", **tiering))
    scenario = ClassIncremental(sc)
    problem = scenario.build_problem(run, "cuda")
    init, update = make_optimizer(run.train)
    model = problem.init_params_fn(0)
    carry = init_carry(model, init(dict(model.named_parameters())), scenario.item_spec,
                       run.rehearsal, label_field="label", device="cuda")
    step = make_cl_step(problem.loss_fn, update, run.rehearsal, label_field="label",
                        device="cuda")
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in scenario.batch(0, sc.batch_size, s).items()}
               for s in range(args.warmup + args.steps)]
    for s in range(args.warmup):
        carry, m = step(carry, batches[s], fold_in(0, s))
    torch.cuda.synchronize()
    # wall time without the profiler (its host-side tracing slows the host),
    # reading the loss each step as the trainer does
    walls = []
    for s in range(args.warmup, args.warmup + args.steps):
        t0 = time.perf_counter()
        carry, m = step(carry, batches[s], fold_in(0, s))
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(args.warmup, args.warmup + args.steps):
            carry, m = step(carry, batches[s], fold_in(0, s))
            float(m["loss"])
    torch.cuda.synchronize()

    by_group, kernels = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if not dev_us or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((ev.key, dev_us / 1e3 / args.steps, ev.count // args.steps))
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3 / args.steps
    device_ms = sum(by_group.values())
    kernels.sort(key=lambda k: -k[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "buffer": ("tiered, fused" if args.fused else "tiered")
           if args.tiered else "flat", "steps": args.steps, "wall_ms_per_step": wall_ms,
           "device_ms_per_step": device_ms,
           "device_idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
           "device_ms_by_group": by_group,
           "top_kernels": [{"name": n[:120], "ms_per_step": t, "launches_per_step": c}
                           for n, t, c in kernels[:15]]}
    print(f"card: {card}; buffer: {out['buffer']}")
    print(f"per step: wall {wall_ms:.2f} ms (median, unprofiled), device busy "
          f"{device_ms:.2f} ms "
          f"(idle share {out['device_idle_share']:.3f})")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:22s} {t:9.3f} ms  {t / device_ms:6.1%}")
    for k in out["top_kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms x{k['launches_per_step']:<4d} {k['name']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
