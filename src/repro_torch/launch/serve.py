"""Serving entry: prefill a prompt batch, then batched greedy decode with KV
caches, on one device.

    python -m repro_torch.launch.serve --arch smollm-135m            # on the card
    python -m repro_torch.launch.serve --arch mamba2-370m --reduced --device cpu

Weights are random, drawn from ``--seed``; so are the prompts (from a
``torch.Generator``: the port cannot reproduce ``jax.random``'s bits). The path
decodes token by token and runs no hand-written kernel, as in the reference.
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
    ap.add_argument("--online", action="store_true", help="not ported yet")
    ap.add_argument("--obs", default="", metavar="DIR", help="not ported yet")
    ap.add_argument("--metrics-port", type=int, default=-1, metavar="PORT",
                    help="not ported yet")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    unported = [flag for flag, on in (("--mesh " + args.mesh, args.mesh != "1x1"),
                                      ("--online", args.online), ("--obs", bool(args.obs)),
                                      ("--metrics-port", args.metrics_port >= 0)) if on]
    if unported:
        raise NotImplementedError(f"{', '.join(unported)}: not ported yet (ROADMAP Queue 1 "
                                  f"items 12-14)")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
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


if __name__ == "__main__":
    main()
