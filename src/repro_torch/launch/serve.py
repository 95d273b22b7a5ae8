"""Serving entry: prefill a prompt batch, then batched greedy decode with KV
caches, on one device.

    python -m repro_torch.launch.serve --arch smollm-135m            # on the card
    python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu
    python -m repro_torch.launch.serve --online                       # serve and learn

Weights are random, drawn from ``--seed``; so are the prompts (from a
``torch.Generator``: the port cannot reproduce ``jax.random``'s bits). The path
decodes token by token and runs no hand-written kernel, as in the reference.

``--online`` switches to the continual-serving loop (``OnlineLearner``):
requests come from the task-free ``drift_stream`` scenario, each round's
traffic is admitted into the rehearsal buffer, and train steps between the
rounds keep the served weights current. As in the reference, it serves the
reduced 2-layer LM over a vocab of 128 (``--arch`` and ``--reduced`` do not
apply) on one device: a ``--mesh`` other than 1x1 is logged and ignored.
``--ckpt-dir`` gives the learner its checkpoint directory, where a resilient
run (``RunConfig.resilience``) keeps its restart checkpoints.
"""
from __future__ import annotations

import argparse
import logging

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import StackCtx, build_model
from repro_torch.serving import DecodeEngine

log = logging.getLogger("repro_torch.serve")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1", help="only 1x1 is ported")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES),
                    help="serving compute and cache dtype")
    ap.add_argument("--device", default=None, help="default: the card (cuda)")
    ap.add_argument("--online", action="store_true",
                    help="continually learn from the served traffic "
                         "(drift_stream scenario + rehearsal buffer)")
    ap.add_argument("--rounds", type=int, default=8,
                    help="--online: serve rounds (one request batch each)")
    ap.add_argument("--train-every", type=int, default=1,
                    help="--online: train steps interleaved per round")
    ap.add_argument("--phases", type=int, default=3,
                    help="--online: anchor distributions the traffic drifts across")
    ap.add_argument("--ckpt-dir", default="",
                    help="--online: the learner's checkpoint directory")
    ap.add_argument("--obs", default="", metavar="DIR", help="not ported yet")
    ap.add_argument("--metrics-port", type=int, default=-1, metavar="PORT",
                    help="not ported yet")
    return ap.parse_args(argv)


# Flags the port does not have yet, by ROADMAP Queue 1 item: the mesh (13,
# ignored under --online as in the reference) and telemetry (14).
UNPORTED_ITEMS = {"--mesh": 13, "--obs": 14, "--metrics-port": 14}


def main(argv=None):
    """Serve once (returns the ``GenResult``) or, with ``--online``, run the
    serve/train interleave (returns the ``OnlineResult``)."""
    args = parse_args(argv)
    given = {"--mesh": args.mesh != "1x1" and not args.online, "--obs": bool(args.obs),
             "--metrics-port": args.metrics_port >= 0}
    unported = [f"{flag} (ROADMAP Queue 1 item {UNPORTED_ITEMS[flag]})"
                for flag, on in given.items() if on]
    if unported:
        raise NotImplementedError(f"not ported yet: {', '.join(unported)}")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    if args.online:
        return _serve_online(args)
    return _serve_once(args)


def _serve_once(args):
    """One prefill + greedy generation pass. Returns the ``GenResult``."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    max_len = args.prompt_len + args.gen_len
    model = build_model(cfg)
    ctx = StackCtx(cfg=cfg, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(args.seed)
    params = model.init(gen, max_seq=max_len, device=device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).to(device)
    res = DecodeEngine(model, ctx, cache_dtype=dtype).generate(params, prompts, args.gen_len)
    log.info("arch=%s device=%s batch=%d prefill(%d tok)=%.3fs decode(%d tok)=%.3fs "
             "(%.1f tok/s/seq)", cfg.name, device, args.batch, args.prompt_len,
             res.prefill_seconds, res.tokens.shape[1], res.decode_seconds,
             res.tokens_per_second)
    print("generated token ids (first sequence):", res.tokens[0].tolist())
    return res


def build_online_run(args):
    """The ``RunConfig`` of ``--online``, the reference's: the reduced 2-layer
    LM over a drift stream of 128 ids (``model=None``), AdamW at 3e-3 with 4
    warm-up steps, f32 training, records of prompt + gen - 1 tokens."""
    from repro_torch.configs.base import OnlineConfig, RunConfig, ScenarioConfig, TrainConfig

    seq_len = args.prompt_len + args.gen_len - 1
    return RunConfig(
        model=None,  # the reduced 2-layer token LM (build_token_lm's default)
        train=TrainConfig(optimizer="adamw", peak_lr=3e-3, warmup_steps=4,
                          linear_scaling=False, compute_dtype="float32"),
        scenario=ScenarioConfig(
            name="drift_stream", modality="tokens", num_tasks=args.phases,
            epochs_per_task=1, steps_per_epoch=max(2, args.rounds // max(args.phases, 1)),
            batch_size=args.batch, seed=args.seed, vocab_size=128, seq_len=seq_len),
        online=OnlineConfig(enabled=True, rounds=args.rounds, requests_per_round=args.batch,
                            prompt_len=args.prompt_len, train_every=args.train_every))


def _serve_online(args):
    """Continual serving: drift_stream traffic in, fresh weights out.
    Returns the ``OnlineResult``."""
    from repro_torch.serving import OnlineLearner

    if args.mesh != "1x1":
        log.info("--online trains on the single-device carry backend; --mesh %s ignored",
                 args.mesh)
    learner = OnlineLearner(build_online_run(args), ckpt_dir=args.ckpt_dir,
                            serve_dtype=DTYPES[args.dtype], device=args.device)
    result = learner.run()
    log.info("online: device=%s rounds=%d decode=%.1f tok/s/seq admission=%.2f "
             "freshness=%d restarts=%d acc=%s", learner.trainer.device, args.rounds,
             result.decode_tokens_per_second, result.admission_rate,
             int(result.freshness_rounds), result.restarts,
             [round(a, 3) for a in result.accuracy])
    print("generated token ids (first sequence, final round):", result.last_tokens[0].tolist())
    return result


if __name__ == "__main__":
    main()
