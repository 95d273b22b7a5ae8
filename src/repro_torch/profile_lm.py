#!/usr/bin/env python3
"""Where the time of the port's LM prefill and decode goes, on one GPU.

    PYTHONPATH=src python3 -m repro_torch.profile_lm [--arch smollm-135m]
        [--dtype {float32,bfloat16}] [--out FILE]

Builds the model at full width (random weights from a seed, f32, TF32 off),
runs it with activations in ``--dtype`` (``StackCtx.compute_dtype``) and
profiles two things with ``torch.profiler`` at ``chip_smoke.py``'s
shapes: one prefill forward of 4 x 2048 tokens with the hand-written
kernels (phase 11), and 8 greedy decode steps of 4 sequences against a
cache of 48 slots (phase 12's prompt 32 + gen 16). For each it prints the
wall time (host clock around synchronised work, without the profiler), the
device-busy time and idle share, the CUDA kernels launched and the aten
operator calls (nested ones included) per call, and device time by kernel
group; writes the same as
JSON to ``--out``. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

BATCH, SEQ = 4, 2048  # the prefill of chip_smoke.py phase 11
CACHE_LEN, STEPS = 48, 8  # decode against phase 12's cache (prompt 32 + gen 16)
GROUPS = (("flash_attention", ("flash_fwd",)),
          ("ssd_scan", ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_output")),
          ("matmul", ("gemm", "cutlass", "xmma", "sm90_", "ampere_", "dot_kernel", "nvjet")),
          ("softmax/reduction", ("softmax", "Softmax", "reduce", "Reduce")),
          ("elementwise/copy", ("elementwise", "copy", "Memcpy", "memset", "fill",
                                "CatArrayBatched", "index", "gather", "scatter")))


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def _profile(fn, reps: int):
    """Median wall ms of ``fn`` (synchronised, unprofiled), then one profiled
    run of ``reps`` calls: device ms, kernels and operators per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / reps)
    wall_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_group, launches, ops = {}, 0, 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if dev_us:
                g = group_of(ev.key)
                by_group[g] = by_group.get(g, 0.0) + dev_us / 1e3 / reps
                launches += ev.count
        elif ev.key.startswith("aten::"):
            ops += ev.count
    device_ms = sum(by_group.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1.0 - device_ms / wall_ms, "kernels_per_call": launches / reps,
            "aten_calls_per_call": ops / reps, "device_ms_by_group": by_group}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile_lm: needs a CUDA device")

    from repro_torch.configs import get_config
    from repro_torch.models import StackCtx, build_model

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, SEQ, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (BATCH, SEQ), generator=gen).cuda()
    dtype = getattr(torch, args.dtype)
    ctx = StackCtx(cfg, use_kernel=True, compute_dtype=dtype)
    caches = model.init_cache(params, BATCH, CACHE_LEN, dtype=dtype)
    state = {"t": 0}

    def decode_step():
        t = state["t"] % CACHE_LEN
        model.decode(params, {"token": toks[:, t:t + 1]}, caches, t, ctx)
        state["t"] += 1

    with torch.inference_mode():
        out = {"prefill": _profile(lambda: model.forward(params, {"tokens": toks}, ctx), 1),
               "decode_step": _profile(decode_step, STEPS)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out.update(card=card, arch=args.arch, dtype=args.dtype, batch=BATCH, seq=SEQ)
    print(f"card: {card}; {args.arch} in {args.dtype}, batch {BATCH}, prefill of {SEQ} tokens, "
          f"{STEPS} decode steps against {CACHE_LEN} cache slots")
    for name in ("prefill", "decode_step"):
        r = out[name]
        print(f"{name}: wall {r['wall_ms']:.2f} ms, device busy {r['device_ms']:.2f} ms (idle "
              f"share {r['device_idle_share']:.3f}), {r['kernels_per_call']:.0f} kernels and "
              f"{r['aten_calls_per_call']:.0f} aten calls per call")
        for g, t in sorted(r["device_ms_by_group"].items(), key=lambda kv: -kv[1]):
            print(f"  {g:20s} {t:9.3f} ms  {t / r['device_ms']:6.1%}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
