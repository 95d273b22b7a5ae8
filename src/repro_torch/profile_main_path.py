#!/usr/bin/env python3
"""Where the time of the port's main-path train step goes, on one GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_main_path [--steps 3] [--out FILE]
        [--tiered [--fused]] [--split] [--lm ARCH [--dtype bfloat16] [--remat POLICY]]

Builds the step ``chip_smoke.py`` drives (ResNet-50 at full width, 224x224x3,
1000 classes, async rehearsal, b=16 r=2 c=4, 4 x 500 buffer slots; with
``--tiered`` the tiered store of its phase 7, 4 x 4 hot and 4 x 1000 int8
cold slots in pinned host memory, ``--fused`` for the fused kernels) through
the public API, warms it up, then runs ``--steps`` steps under
``torch.profiler``. ``--split`` runs the split form
(``make_pipelined_halves``: the train half, then the issue half on its own
CUDA stream) in place of the fused ``make_cl_step``. ``--lm ARCH`` profiles
the LM train step of ``chip_smoke.py``'s phase 15 in place of the ResNet's
(``TokenClassIncremental`` at full width with the train CLI's one-device
settings: seq 128, b 8, r 7, c 14, AdamW, 2 x 16 buffer slots, TF32 off;
``--dtype bfloat16`` computes in bf16, ``--remat`` sets
``TrainConfig.remat``, ``dots`` by default). Prints the median wall
time of a step (timed without the profiler; beside it the host's time to
dispatch the step, each half's in the split form, and to wait for the
loss), the device-busy time (the
union of kernel intervals, so kernels of two streams that overlap count
once) and idle share of it, device time by kernel group (convolution and
matmul, GroupNorm, cuDNN layout transposes, elementwise, reductions, the
buffer's kernels, the rest), the top kernels, and the kernels of each
stream: which stream the buffer's kernels ran on, and how much of the other
streams' kernel time ran while the train stream's kernels ran. Writes the
same as JSON to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

GROUPS = (("buffer kernels", ("update_sample_kernel", "quantize_rows_kernel")),
          ("softmax/logsumexp", ("softmax", "logsumexp", "LogSoftmax")),
          ("groupnorm", ("RowwiseMoments", "ComputeInternalGradients", "GroupNorm",
                         "group_norm", "ComputeFusedParams", "GammaBeta")),
          ("layout transpose", ("nchwToNhwc", "nhwcToNchw")),
          ("convolution/matmul", ("conv", "gemm", "cutlass", "xmma", "wgrad", "dgrad",
                                  "implicit", "winograd", "fft", "cudnn", "nvjet")),
          ("elementwise/copy", ("elementwise", "clamp", "copy", "Memcpy", "memset",
                                "fill", "CatArrayBatched")),
          ("reduction", ("reduce", "Reduce")))
BUFFER_KERNEL = "update_sample_kernel"  # every form's update+sample launch
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in the trace


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _union_ms(spans) -> float:
    """Total length in ms of the union of (start_us, end_us) spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def _overlap_ms(spans, cover) -> float:
    """ms of ``spans`` that fall inside the union of ``cover``."""
    merged = []
    for a, b in sorted(cover):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    total = 0.0
    for a, b in spans:
        for c, d in merged:
            if c >= b:
                break
            total += max(0.0, min(b, d) - max(a, c))
    return total / 1e3


def trace_kernels(prof):
    """(name, stream, start_us, end_us) of every kernel, memcpy and memset
    on the device in the profiler's trace. Raises if the trace holds no
    kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [(e["name"], e.get("args", {}).get("stream", e.get("tid")), float(e["ts"]),
                float(e["ts"]) + float(e["dur"]))
               for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not any(e.get("cat") == "kernel" for e in events):
        raise RuntimeError("the profiler's trace holds no kernel: no device activity")
    return kernels


def idle_gaps(kernels, steps: int, top: int = 8):
    """Where the device waits: the gaps of the union of all device activity,
    their total in ms a step, and the ``top`` largest with the activity
    that ends before and starts after each."""
    spans = sorted((a, b, name) for name, _, a, b in kernels)
    gaps, end, last = [], None, None
    for a, b, name in spans:
        if end is not None and a > end:
            gaps.append(((a - end) / 1e3, last, name))
        if end is None or b > end:
            end, last = b, name
    gaps.sort(key=lambda g: -g[0])
    return {"idle_ms_per_step": sum(g[0] for g in gaps) / steps,
            "largest": [{"ms": ms, "after": before[:70], "before": after[:70]}
                        for ms, before, after in gaps[:top]]}


def stream_report(kernels, steps: int):
    """Per stream: kernels and device ms a step, top kernels; the train stream
    (the one with the most device time), the streams the buffer's
    update+sample kernel ran on, and the ms a step of every other stream's
    kernels that ran while the train stream's kernels ran."""
    by_stream = {}
    for name, stream, a, b in kernels:
        by_stream.setdefault(str(stream), []).append((name, a, b))
    times = {s: sum(b - a for _, a, b in ks) / 1e3 / steps for s, ks in by_stream.items()}
    train = max(times, key=times.get)
    cover = [(a, b) for _, a, b in by_stream[train]]
    report = {}
    for s, ks in by_stream.items():
        names = {}
        for name, a, b in ks:
            names[name] = names.get(name, 0.0) + (b - a) / 1e3 / steps
        top = sorted(names.items(), key=lambda kv: -kv[1])[:6]
        entry = {"kernels_per_step": len(ks) / steps, "device_ms_per_step": times[s],
                 "top": [{"name": n[:100], "ms_per_step": t} for n, t in top]}
        if s != train:
            spans = [(a, b) for _, a, b in ks]
            entry["ms_during_train_kernels_per_step"] = _overlap_ms(spans, cover) / steps
            entry["kernels_overlapping_train"] = sum(
                _overlap_ms([(a, b)], cover) > 0 for a, b in spans) / steps
        report[s] = entry
    buffer_streams = sorted({str(s) for name, s, _, _ in kernels if BUFFER_KERNEL in name})
    return {"train_stream": train, "buffer_kernel_streams": buffer_streams, "streams": report}


def _resnet_run(tiered: bool, fused: bool):
    """The ResNet main path's run and scenario (phases 5 and 7), TF32 on."""
    from repro_torch.configs import resnet50_cl
    from repro_torch.configs.base import RehearsalConfig, RunConfig, ScenarioConfig
    from repro_torch.scenario import ClassIncremental

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    sc = ScenarioConfig(num_tasks=4, classes_per_task=250, image_size=224, batch_size=16)
    tiering = (dict(tiering="host", hot_slots=4, cold_slots=1000, fused_kernels=fused)
               if tiered else {})
    run = RunConfig(model=resnet50_cl.full(), scenario=sc, rehearsal=RehearsalConfig(
        num_buckets=4, slots_per_bucket=500, num_representatives=2, num_candidates=4,
        mode="async", label_field="label", **tiering))
    return run, ClassIncremental(sc)


def _lm_run(arch: str, dtype: str, tiered: bool, fused: bool, remat: str = "dots"):
    """Phase 15's LM run and scenario at full width, TF32 off: the train
    CLI's one-device run for ``arch`` (``launch.train.build_run``), with the
    compute dtype, the checkpoint policy and the tiered store's kernels set
    on it."""
    import dataclasses

    from repro_torch.launch import train as train_cli
    from repro_torch.scenario import TokenClassIncremental

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    run = train_cli.build_run(train_cli.parse_args(
        ["--arch", arch] + (["--tiering", "host"] if tiered else [])))
    run = dataclasses.replace(
        run, train=dataclasses.replace(run.train, compute_dtype=dtype, remat=remat),
        rehearsal=dataclasses.replace(run.rehearsal, fused_kernels=fused))
    return run, TokenClassIncremental(run.scenario)


def profile(steps: int = 3, warmup: int = 3, tiered: bool = False, fused: bool = False,
            split: bool = False, lm: str = "", dtype: str = "float32",
            remat: str = "dots") -> dict:
    """Build, warm up, time and profile the main-path step (see the module
    note; ``lm`` names an LM arch to profile phase 15's step). Returns the
    report as a dict."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.optim import make_optimizer
    from repro_torch.rng import fold_in
    from repro_torch.strategy import TrainCarry, init_carry, make_cl_step, make_pipelined_halves

    run, scenario = (_lm_run(lm, dtype, tiered, fused, remat) if lm
                     else _resnet_run(tiered, fused))
    sc, label = run.scenario, scenario.label_field
    problem = scenario.build_problem(run, "cuda")
    init, update = make_optimizer(run.train)
    model = problem.init_params_fn(0)
    carry = init_carry(model, init(dict(model.named_parameters())), scenario.item_spec,
                       run.rehearsal, label_field=label, device="cuda")
    marks = []  # host clock after the train half's dispatch (split form)
    if split:
        train_half, issue_half = make_pipelined_halves(problem.loss_fn, update, run.rehearsal,
                                                       label_field=label, device="cuda")

        def step(carry, batch, key):
            model, opt, m = train_half(carry.params, carry.opt, carry.pipe, batch)
            marks.append(time.perf_counter())
            buffer, pipe = issue_half(carry.buffer, carry.pipe, batch, key)
            return TrainCarry(model, opt, buffer, pipe), m
    else:
        step = make_cl_step(problem.loss_fn, update, run.rehearsal, label_field=label,
                            device="cuda")
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in scenario.batch(0, sc.batch_size, s).items()}
               for s in range(warmup + steps)]
    for s in range(warmup):
        carry, m = step(carry, batches[s], fold_in(0, s))
    torch.cuda.synchronize()
    # wall time without the profiler (its host-side tracing slows the host),
    # reading the loss each step as the trainer does
    walls, host = [], {"dispatch": [], "loss_wait": [], "train_dispatch": [],
                       "issue_dispatch": []}
    for s in range(warmup, warmup + steps):
        marks.clear()
        t0 = time.perf_counter()
        carry, m = step(carry, batches[s], fold_in(0, s))
        t1 = time.perf_counter()
        float(m["loss"])
        t2 = time.perf_counter()
        walls.append((t2 - t0) * 1e3)
        host["dispatch"].append((t1 - t0) * 1e3)
        host["loss_wait"].append((t2 - t1) * 1e3)
        if marks:
            host["train_dispatch"].append((marks[0] - t0) * 1e3)
            host["issue_dispatch"].append((t1 - marks[0]) * 1e3)
    wall_ms = statistics.median(walls)
    host_ms = {k: statistics.median(v) for k, v in host.items() if v}
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for s in range(warmup, warmup + steps):
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
        kernels.append((ev.key, dev_us / 1e3 / steps, ev.count // steps))
        g = group_of(ev.key)
        by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3 / steps
    device_ms = sum(by_group.values())
    traced = trace_kernels(prof)
    busy_ms = _union_ms([(a, b) for _, _, a, b in traced]) / steps
    kernels.sort(key=lambda k: -k[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    buffer = ("tiered, fused" if fused else "tiered") if tiered else "flat"
    return {"card": card, "model": f"{lm} {dtype} remat {remat}" if lm else "resnet50_cl",
            "buffer": buffer, "step_form": "split" if split else "fused",
            "steps": steps, "wall_ms_per_step": wall_ms, "wall_ms_steps": walls,
            "host_ms_per_step": host_ms,
            "device_ms_per_step": device_ms, "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
            "device_ms_by_group": by_group, "streams": stream_report(traced, steps),
            "idle_gaps": idle_gaps(traced, steps),
            "top_kernels": [{"name": n[:120], "ms_per_step": t, "launches_per_step": c}
                            for n, t, c in kernels[:15]]}


def print_report(out: dict):
    print(f"card: {out['card']}; model: {out['model']}; buffer: {out['buffer']}; step form: "
          f"{out['step_form']}")
    print(f"per step: wall {out['wall_ms_per_step']:.2f} ms (median, unprofiled), device "
          f"busy {out['device_busy_ms_per_step']:.2f} ms (kernel time summed over streams "
          f"{out['device_ms_per_step']:.2f}; idle share {out['device_idle_share']:.4f})")
    print("  host, medians a step: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out["host_ms_per_step"].items())
          + f"; walls {[round(w, 2) for w in out['wall_ms_steps']]}")
    by_group = out["device_ms_by_group"]
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:22s} {t:9.3f} ms  {t / out['device_ms_per_step']:6.1%}")
    for k in out["top_kernels"]:
        print(f"  {k['ms_per_step']:9.3f} ms x{k['launches_per_step']:<4d} {k['name']}")
    gaps = out["idle_gaps"]
    print(f"device idle between activities: {gaps['idle_ms_per_step']:.3f} ms a step "
          f"(the profiled window); largest: " + "; ".join(
              f"{g['ms']:.3f} ms after {g['after'][:40]!r} before {g['before'][:40]!r}"
              for g in gaps["largest"]))
    st = out["streams"]
    print(f"streams: train stream {st['train_stream']}, update+sample kernel on "
          f"{st['buffer_kernel_streams']}")
    for s, e in st["streams"].items():
        during = ("" if "ms_during_train_kernels_per_step" not in e else
                  f", {e['ms_during_train_kernels_per_step']:.4f} ms of it during the train "
                  f"stream's kernels ({e['kernels_overlapping_train']:.1f} kernels a step)")
        print(f"  stream {s}: {e['kernels_per_step']:.1f} kernels, "
              f"{e['device_ms_per_step']:.4f} ms a step{during}; "
              + ", ".join(f"{k['name'][:48]} {k['ms_per_step']:.4f}" for k in e["top"]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--tiered", action="store_true", help="the tiered store")
    ap.add_argument("--fused", action="store_true", help="its fused kernels")
    ap.add_argument("--split", action="store_true",
                    help="the split form: the issue half on its own stream")
    ap.add_argument("--lm", default="", metavar="ARCH",
                    help="profile phase 15's LM train step of this arch")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the LM's compute dtype")
    ap.add_argument("--remat", default="dots", choices=("none", "dots", "dots_no_batch", "full"),
                    help="the LM's activation checkpointing policy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile_main_path: needs a CUDA device")
    out = profile(args.steps, args.warmup, args.tiered, args.fused, args.split, args.lm,
                  args.dtype, args.remat)
    print_report(out)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
