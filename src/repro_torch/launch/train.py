"""Training entry: continual LM training with distributed rehearsal.

The CLI builds a ``RunConfig`` (with its ``ScenarioConfig``) and a token
class-incremental scenario, and ``ContinualTrainer``'s mesh backend
(``launch.steps.build_train_step``, the reference's pjit route) trains it
task after task, evaluating every task seen so far after each (per-task
eval loss, lower is better). Every ``--mesh DATAxMODEL`` goes through the
mesh backend, 1x1 included, as in the reference; it computes in f32 on one
worker and in bf16 on more. A model axis over 1 is tensor parallelism: the
M ranks of a row hold the shards of one model (``parallel.tensor``).

    python -m repro_torch.launch.train --arch smollm-135m                 # one card
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 4x1    # four cards
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2    # 2 x TP 2
    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --tasks 2 --steps-per-task 4 --seq-len 32 --global-batch 4 --device cpu

Each rank is one process: started by torchrun, or by
``runtime.multiproc.launch_workers`` (a file rendezvous, the CPU's gloo
ranks), and each joins the group through ``runtime.multiproc.init_from_env``
(NCCL on cards, gloo on the CPU). Without either, the run is one process on
a mesh of one worker, with no group. ``--exchange`` picks the rehearsal
exchange (``full`` over every rank, ``pod_local`` within the ``data`` axis,
``local`` none); a one-worker mesh's full exchange keeps one representative
a step, as the reference's does.

``--arch`` takes every decoder: the dense, SSM, MoE and hybrid stacks (the
MoE loss adds 0.01 x the load-balance aux, on N workers the mean of the
ranks' aux). The enc-dec and VLM archs train on frames or embeddings,
which the token records do not hold, and raise ``ValueError``. The
scenario draws its tokens from the first ``min(vocab, 2048)`` ids while
the model keeps its full vocabulary, as in the reference. Weights are
random, drawn from ``--seed``. ``--ckpt-dir`` checkpoints the full state
every ``--ckpt-every`` steps and after every task (one directory a rank on
more than one worker); with ``--resilience`` each task's steps run in the
``ResilientLoop`` (restart checkpoints every ``--resilience-checkpoint-every``
steps under ``resilient`` in the rank's directory, bounded retry with
backoff; on more than one worker every rank of the mesh, the model ranks
included, agrees on every restart):

    python -m repro_torch.launch.train --arch smollm-135m --reduced --device cpu \
        --tasks 1 --steps-per-task 4 --ckpt-dir /tmp/ck --resilience
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import (
    RehearsalConfig,
    ResilienceConfig,
    RunConfig,
    ScenarioConfig,
    StrategyConfig,
    TrainConfig,
)
from repro_torch.launch.mesh import describe, make_mesh, memory_kinds
from repro_torch.scenario import ContinualTrainer, TokenClassIncremental
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.train")

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL, one process a rank (MODEL: tensor parallelism)")
    ap.add_argument("--tasks", type=int, default=2)
    ap.add_argument("--steps-per-task", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mode", default="async", choices=["async", "sync", "off"])
    ap.add_argument("--strategy", default="",
                    help="training strategy (rehearsal | der | der_pp | grasp_embed | "
                         "incremental); default: rehearsal, or incremental when --mode off")
    ap.add_argument("--der-alpha", type=float, default=0.5,
                    help="DER: weight of the logit-MSE distillation term")
    ap.add_argument("--der-beta", type=float, default=0.5,
                    help="DER++: weight of the replay-row CE term")
    ap.add_argument("--der-top-k", type=int, default=0,
                    help="store top-k (value, index) logit pairs instead of the dense "
                         "vocab row (0 = dense)")
    ap.add_argument("--exchange", default="full", choices=["full", "pod_local", "local"])
    ap.add_argument("--policy", default="reservoir",
                    help="buffer policy (reservoir|fifo|class_balanced|grasp)")
    ap.add_argument("--tiering", default="off", choices=["off", "host", "on"],
                    help="two-tier buffer: cold records in host memory as int8")
    ap.add_argument("--hot-slots", type=int, default=0,
                    help="tiered: hot (device) slots/bucket; 0 = slots_per_bucket")
    ap.add_argument("--cold-slots", type=int, default=0,
                    help="tiered: cold (host int8) slots/bucket; 0 = 3x hot")
    ap.add_argument("--slots-per-bucket", type=int, default=16)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint the full carry after every task")
    ap.add_argument("--ckpt-every", type=int, default=100,
                    help="with --ckpt-dir: checkpoint every this many steps")
    ap.add_argument("--resilience", action="store_true",
                    help="run the steps in runtime.ResilientLoop (checkpointed restart; "
                         "needs --ckpt-dir)")
    ap.add_argument("--resilience-checkpoint-every", type=int, default=25)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--backoff-base", type=float, default=0.0,
                    help="restart r sleeps min(backoff-max, base * 2^(r-1)) s")
    ap.add_argument("--backoff-max", type=float, default=30.0)
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="wall-clock step budget (s); an overrun flags the next exchange "
                         "as straggling (bounded-staleness reuse)")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    return ap.parse_args(argv)


def mesh_shape(args):
    """``(data, model)`` of ``--mesh``."""
    d, m = (int(x) for x in args.mesh.split("x"))
    return d, m


def build_run(args) -> RunConfig:
    """The reference CLI's ``RunConfig``: f32 compute on a mesh of one
    worker, bf16 on more."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    strategy = args.strategy or ("rehearsal" if args.mode != "off" else "incremental")
    d, m = mesh_shape(args)
    return RunConfig(
        model=cfg,
        train=TrainConfig(optimizer=args.optimizer, peak_lr=args.lr, warmup_steps=20,
                          linear_scaling=False,
                          compute_dtype="float32" if d * m == 1 else "bfloat16"),
        rehearsal=RehearsalConfig(num_buckets=max(args.tasks, 2), mode=args.mode,
                                  slots_per_bucket=args.slots_per_bucket,
                                  policy=args.policy, tiering=args.tiering,
                                  hot_slots=args.hot_slots, cold_slots=args.cold_slots),
        strategy=StrategyConfig(alpha=args.der_alpha, beta=args.der_beta,
                                top_k=args.der_top_k),
        scenario=ScenarioConfig(
            name="class_incremental", modality="tokens", strategy=strategy,
            num_tasks=args.tasks, epochs_per_task=1, steps_per_epoch=args.steps_per_task,
            batch_size=args.global_batch, seed=args.seed,
            vocab_size=min(cfg.vocab_size, 2048), seq_len=args.seq_len,
            auto_defaults=False),  # the CLI's rehearsal flags are authoritative
        resilience=ResilienceConfig(
            checkpoint_every=args.resilience_checkpoint_every,
            max_restarts=args.max_restarts, backoff_base=args.backoff_base,
            backoff_max=args.backoff_max,
            step_timeout=args.step_timeout) if args.resilience else None)


def join_group(device):
    """This rank's device, and whether this call joined a process group:
    under torchrun or ``runtime.multiproc`` each rank joins its group (NCCL
    on cards, gloo on the CPU) on the card of its local rank; otherwise the
    run is one process and no group."""
    import torch
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.runtime import multiproc

    device = resolve_device(device)
    if not multiproc.launched() or dist.is_initialized():
        return device, False
    if device.type == "cuda":
        device = torch.device("cuda", multiproc.local_rank())
        torch.cuda.set_device(device)
    multiproc.init_from_env("nccl" if device.type == "cuda" else "gloo")
    return device, True


def main(argv=None):
    args = parse_args(argv)
    run = build_run(args)
    device, joined = join_group(args.device)
    try:
        res = _train(args, run, device)
    finally:
        if joined:
            import gc

            import torch.distributed as dist

            gc.collect()  # the trainer's step held the group
            dist.destroy_process_group()
    return res


def _train(args, run, device):
    cfg, strategy = run.model, run.scenario.strategy
    mesh = make_mesh(mesh_shape(args), ("data", "model"), device.type)
    trainer = ContinualTrainer(run, TokenClassIncremental(run.scenario), device=device,
                               mesh=mesh, exchange=args.exchange, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every)
    log.info("arch=%s params=%.1fM device=%s mesh=%s mode=%s strategy=%s", cfg.name,
             cfg.param_count() / 1e6, trainer.device, describe(mesh), args.mode, strategy)
    if strategy in ("der", "der_pp") and args.der_top_k:
        log.info("der: storing top-%d logit (val,idx) pairs per position (alpha=%.2f "
                 "beta=%.2f)", args.der_top_k, args.der_alpha, args.der_beta)
    if run.rehearsal.tiered:
        log.info("tiered buffer: hot=%d cold=%d slots/bucket; mesh memory kinds: %s; cold "
                 "tier in %s", run.rehearsal.resolved_hot_slots,
                 run.rehearsal.resolved_cold_slots, sorted(memory_kinds(mesh)),
                 trainer.built.meta["cold_placement"])
    t_start = time.time()
    res = trainer.fit()
    for i, loss in enumerate(res.losses):
        if i % max(args.log_every, 1) == 0:
            log.info("step %d loss=%.4f", i, loss)
    for task in range(args.tasks):
        for j in range(task + 1):
            log.info("eval after task %d on task %d: loss=%.4f", task, j,
                     res.accuracy_matrix[task, j])
    if res.resilience_stats is not None:
        log.info("resilience: restarts=%d stale_steps=%d restore=%.3fs", res.restarts,
                 int(res.resilience_stats.get("stale_steps", 0)),
                 res.resilience_stats.get("restore_seconds", 0.0))
    log.info("done: %d steps in %.1fs", args.tasks * args.steps_per_task,
             time.time() - t_start)
    return res


if __name__ == "__main__":
    main()
