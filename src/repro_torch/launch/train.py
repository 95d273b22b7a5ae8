"""Training entry: continual LM training with rehearsal, on one device.

The CLI builds a ``RunConfig`` (and its ``ScenarioConfig``) and a token
class-incremental scenario, and ``ContinualTrainer`` trains it task after
task, evaluating every task seen so far after each (per-task eval loss,
lower is better). ``--mesh 1x1`` is the one layout ported: one process on
one device, computing in f32, as the reference sets for one device.

    python -m repro_torch.launch.train --arch smollm-135m                 # on the card
    python -m repro_torch.launch.train --arch smollm-135m --reduced \\
        --tasks 2 --steps-per-task 4 --seq-len 32 --global-batch 4 --device cpu

The scenario draws its tokens from the first ``min(vocab, 2048)`` ids while
the model keeps its full vocabulary, as in the reference. Weights are
random, drawn from ``--seed``. ``--ckpt-dir`` checkpoints the full carry
after every task; with ``--resilience`` each task's steps run in the
``ResilientLoop`` (restart checkpoints every ``--resilience-checkpoint-every``
steps under ``<ckpt-dir>/resilient``, bounded retry with backoff, and
bounded-staleness reuse past ``--step-timeout``):

    python -m repro_torch.launch.train --arch smollm-135m --reduced --device cpu \
        --tasks 1 --steps-per-task 4 --ckpt-dir /tmp/ck --resilience

The options that need a mesh (``--mesh`` other than 1x1, ``--exchange`` and
``--ckpt-every``, which only the pjit backend reads) raise
``NotImplementedError`` naming their ROADMAP item whenever they are given.
"""
from __future__ import annotations

import argparse
import logging
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
from repro_torch.scenario import ContinualTrainer, TokenClassIncremental

log = logging.getLogger("repro_torch.train")

# Options of the reference's CLI that the port has not yet, and their items.
# Each is refused whenever it is given: the exchange has peers only on a mesh,
# and only the pjit backend reads --ckpt-every.
UNPORTED_ITEMS = {"--mesh": 13, "--exchange": 13, "--exchange pod_local": "2-3",
                  "--ckpt-every": 13}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL; only 1x1 is ported")
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
    ap.add_argument("--exchange", default=None, choices=["full", "pod_local", "local"],
                    help="not ported yet: one process has no peers to exchange with")
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
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="not ported yet: only the pjit backend reads it")
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


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for every option the port has not yet
    that was given, naming each with its ROADMAP Queue 1 item."""
    given = {flag: getattr(args, flag[2:].replace("-", "_")) is not None
             for flag in UNPORTED_ITEMS if " " not in flag}
    given.update({"--mesh": args.mesh != "1x1",
                  "--exchange": args.exchange in ("full", "local"),
                  "--exchange pod_local": args.exchange == "pod_local"})
    unported = [f"{flag} (ROADMAP Queue 1 item {UNPORTED_ITEMS[flag]})"
                for flag, on in given.items() if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")


def build_run(args) -> RunConfig:
    """The reference CLI's ``RunConfig`` for one device (f32 compute)."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    strategy = args.strategy or ("rehearsal" if args.mode != "off" else "incremental")
    return RunConfig(
        model=cfg,
        train=TrainConfig(optimizer=args.optimizer, peak_lr=args.lr, warmup_steps=20,
                          linear_scaling=False, compute_dtype="float32"),
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


def main(argv=None):
    args = parse_args(argv)
    check_ported(args)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run = build_run(args)
    cfg, strategy = run.model, run.scenario.strategy
    trainer = ContinualTrainer(run, TokenClassIncremental(run.scenario), device=args.device,
                               ckpt_dir=args.ckpt_dir)
    log.info("arch=%s params=%.1fM device=%s mode=%s strategy=%s", cfg.name,
             cfg.param_count() / 1e6, trainer.device, args.mode, strategy)
    if strategy in ("der", "der_pp") and args.der_top_k:
        log.info("der: storing top-%d logit (val,idx) pairs per position (alpha=%.2f "
                 "beta=%.2f)", args.der_top_k, args.der_alpha, args.der_beta)
    if run.rehearsal.tiered:
        from repro_torch.buffer.tiered import resolve_cold_placement

        log.info("tiered buffer: hot=%d cold=%d slots/bucket; cold tier in %s",
                 run.rehearsal.resolved_hot_slots, run.rehearsal.resolved_cold_slots,
                 resolve_cold_placement(trainer.device))
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
