"""Serving entry: prefill a prompt batch, then batched greedy decode with KV
caches, through ``launch.steps.build_decode_step`` on a ``--mesh DATAxMODEL``.

    python -m repro_torch.launch.serve --arch smollm-135m            # on the card
    python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mesh 2x2   # 2 x TP 2
    python -m repro_torch.launch.serve --online                       # serve and learn

On a mesh of more than one rank each rank is one process (torchrun, or
``runtime.multiproc``, as for ``launch.train``): the D data replicas each
decode their slice of the batch, tensor-parallel over the M ranks of their
model row, and the rank of global index 0 prints every slice's tokens,
gathered over its data-parallel group. Every family serves on a model
axis, the encoder-decoder included.

Weights are random, drawn from ``--seed``; so are the prompts (from a
``torch.Generator``: the port cannot reproduce ``jax.random``'s bits). The path
decodes token by token and runs no hand-written kernel, as in the reference.
Every registered arch serves token prompts: Qwen2-VL-72B decodes them at 1-D
positions broadcast to its three M-RoPE components, and Whisper-tiny's
decoder attends to zero cross-attention K/V (a stubbed frame window), as the
reference serves both.

``--online`` switches to the continual-serving loop (``OnlineLearner``):
requests come from the task-free ``drift_stream`` scenario, each round's
traffic is admitted into the rehearsal buffer, and train steps between the
rounds keep the served weights current. As in the reference, it serves the
reduced 2-layer LM over a vocab of 128 (``--arch`` and ``--reduced`` do not
apply) on one device: a ``--mesh`` other than 1x1 is logged and ignored, as
the reference does (``repro/launch/serve.py:128-130``).
``--ckpt-dir`` gives the learner its checkpoint directory, where a resilient
run (``RunConfig.resilience``) keeps its restart checkpoints.

``--obs DIR`` writes the trace (``prefill`` and ``decode`` spans; under
``--online`` also each round's ``serve_round``, ``online_train`` and
``weight_handoff``) and the event log there; ``--metrics-port PORT``
serves the gauges (prefill seconds, decode tokens/s, batch size; the online
learner's round gauges) in the Prometheus text format at
``http://127.0.0.1:PORT/metrics`` while it runs (0: a free port, logged).
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.configs import get_config, get_reduced
from repro_torch.serving import DecodeEngine
from repro_torch.utils.logging import get_logger

log = get_logger("repro_torch.serve")

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL: data replicas x tensor-parallel ranks, one process a "
                         "rank")
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
    ap.add_argument("--obs", default="", metavar="DIR",
                    help="write trace.json and events.jsonl under DIR")
    ap.add_argument("--metrics-port", type=int, default=-1, metavar="PORT",
                    help="serve Prometheus text gauges at /metrics on PORT (0: a free "
                         "port; default: no endpoint)")
    return ap.parse_args(argv)


def main(argv=None):
    """Serve once (returns the ``GenResult``) or, with ``--online``, run the
    serve/train interleave (returns the ``OnlineResult``)."""
    args = parse_args(argv)
    registry = server = None
    if args.obs:
        obs.configure(args.obs)
    if args.metrics_port >= 0:
        registry = obs.MetricsRegistry()
        server, port = obs.start_metrics_server(registry, port=args.metrics_port)
        log.info("prometheus /metrics on http://127.0.0.1:%d/metrics", port)
    # the endpoint and the trace come down on every exit path
    try:
        if args.online:
            return _serve_online(args, registry)
        return _serve_once(args, registry)
    finally:
        if args.obs:
            obs.shutdown()  # writes trace.json, closes events.jsonl
        if server is not None:
            server.shutdown()


def _serve_once(args, registry=None):
    """One prefill + greedy generation pass. Returns the ``GenResult`` (on a
    mesh, its tokens those of the whole batch); its rates go to
    ``registry`` when given."""
    from repro_torch.configs.base import RunConfig, ScenarioConfig, TrainConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.launch.train import join_group
    from repro_torch.parallel import batch_slice, dp_group

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    d, m = (int(x) for x in args.mesh.split("x"))
    dtype = DTYPES[args.dtype]
    max_len = args.prompt_len + args.gen_len
    device, joined = join_group(args.device)
    try:
        mesh = make_mesh((d, m), ("data", "model"), device.type)
        built = build_decode_step(RunConfig(
            model=cfg, train=TrainConfig(compute_dtype=args.dtype),
            scenario=ScenarioConfig(modality="tokens", batch_size=args.batch,
                                    seq_len=max_len)), mesh)
        gen = torch.Generator().manual_seed(args.seed)
        params = built.model.init(gen, max_seq=max_len, device=device, mp=built.ctx.mp)
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                generator=gen)[batch_slice(args.batch, mesh)].to(device)
        res = DecodeEngine(built.model, built.ctx, cache_dtype=dtype, step=built.fn).generate(
            params, prompts, args.gen_len)
        res = res._replace(tokens=_gather_rows(res.tokens, args.batch, mesh, dp_group(mesh)))
        first = dist.get_rank() == 0 if dist.is_initialized() else True
    finally:
        if joined:
            import gc

            gc.collect()
            dist.destroy_process_group()
    log.info("arch=%s device=%s mesh=%s batch=%d prefill(%d tok)=%.3fs decode(%d tok)=%.3fs "
             "(%.1f tok/s/seq)", cfg.name, device, args.mesh, args.batch, args.prompt_len,
             res.prefill_seconds, res.tokens.shape[1], res.decode_seconds,
             res.tokens_per_second)
    if registry is not None:
        registry.set("repro_serve_prefill_seconds", res.prefill_seconds,
                     help="wall-clock seconds to prefill the prompt batch")
        registry.set("repro_serve_decode_tokens_per_second", res.tokens_per_second,
                     help="greedy-decode throughput per sequence")
        registry.set("repro_serve_batch_size", args.batch)
    if first:
        print("generated token ids (first sequence):", res.tokens[0].tolist())
    return res


def _gather_rows(tokens: torch.Tensor, batch: int, mesh, group) -> torch.Tensor:
    """Every data replica's rows of the batch, from this rank's slice (an
    ``all_reduce`` of zero-padded slices over the data-parallel group)."""
    if group is None:
        return tokens
    from repro_torch.parallel import batch_slice

    full = tokens.new_zeros((batch,) + tuple(tokens.shape[1:]))
    full[batch_slice(batch, mesh)] = tokens
    dist.all_reduce(full, group=group)
    return full


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


def _serve_online(args, registry=None):
    """Continual serving: drift_stream traffic in, fresh weights out.
    Returns the ``OnlineResult``; the round gauges go to ``registry``."""
    from repro_torch.serving import OnlineLearner

    if args.mesh != "1x1":
        log.info("--online trains on the single-device carry backend; --mesh %s ignored, "
                 "as the reference does", args.mesh)
    learner = OnlineLearner(build_online_run(args), ckpt_dir=args.ckpt_dir,
                            serve_dtype=DTYPES[args.dtype], registry=registry,
                            device=args.device)
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
