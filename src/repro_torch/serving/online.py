"""OnlineLearner: the serve/train interleave.

Each round serves one request batch through the :class:`DecodeEngine`, admits
the traffic (prompt + the decode continuation, re-labelled by content bucket)
into the rehearsal buffer, and runs ``train_every`` rehearsal steps whose
representatives are one step stale. The weights they produce are handed to
serving at the round boundary.

The weight handoff. The train step updates its parameters in place
(``TrainCarry.params``), so serving decodes from a copy of its own: made once
at the start, and refreshed after every round that trained without a fault,
one device-to-device copy per tensor. A train step that fails after the
optimizer has written some of its tensors therefore never reaches serving,
which keeps the last handed-off weights bit for bit. The reference gets the
same guarantee from its undonated carry.

Failure containment. With ``run.resilience`` (and a ``ckpt_dir``), a
round's steps run in the trainer's ``ResilientLoop``: a transient failure is
restored from the round's last checkpoint and replayed, and ``restarts``
counts the restarts absorbed. When the restart budget is spent, the last
checkpoint is restored into the carry, serving's copy is refreshed from the
restored weights, and training is disabled. Without resilience, any
exception on the train side disables training for the rest of the run.
Either way it is logged at WARNING, and every later round still serves.
Freshness is measured in rounds since the last weight handoff as the
serving step sees it: 1 in steady state, the one-step staleness the paper
trades for never blocking.

Not ported yet, and refused: the metrics registry (``registry``; ROADMAP
Queue 1 item 14). The reference's tracer spans and event-bus publications
wait for the same item; its check that serving reads live (undonated)
arrays has no counterpart, since the port donates nothing. The trainer is
one process, so the rehearsal exchange has no peers.
"""
from __future__ import annotations

import copy
import logging
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import RunConfig
from repro_torch.models import StackCtx
from repro_torch.rng import fold_in
from repro_torch.scenario import ContinualTrainer
from repro_torch.scenario.scenarios import build_token_lm
from repro_torch.serving.engine import DecodeEngine, GenResult

log = logging.getLogger("repro_torch.online")


class OnlineResult(NamedTuple):
    history: List[Dict[str, float]]  # one entry per serve round
    decode_tokens_per_second: float  # mean per-sequence decode throughput
    admission_rate: float  # admitted request rows / served request rows
    freshness_rounds: float  # freshness the final round decoded with (steady state: 1)
    accuracy: List[float]  # per-anchor-phase next-token accuracy at the end
    restarts: int  # restarts the train side's ResilientLoop absorbed
    train_disabled: bool  # True once a train step has failed
    freshness_evals: List[Dict[str, float]]  # periodic drifted-slice evals
    params: Any  # the weights serving ended on (its own copy)
    carry: Any  # the train side's TrainCarry (buffer + pipeline state)
    last_tokens: Any  # [batch, gen_len] ids of the final round's decode


class OnlineLearner:
    """Interleaved serve/train loop over a task-free traffic stream.

    Args:
      run: ``RunConfig``; ``run.online`` holds the interleave knobs,
        ``run.scenario`` names the traffic scenario (``drift_stream``), and
        ``run.rehearsal``/``run.strategy`` shape the buffer as in offline
        training.
      scenario: optional explicit Scenario (else resolved from ``run``). Must
        be a token scenario whose records carry ``tokens``/``labels`` rows.
      ckpt_dir: the trainer's checkpoint directory; with ``run.resilience``
        the ``ResilientLoop`` keeps its restart checkpoints under it.
      serve_dtype: compute and cache dtype of the serving forward; training
        keeps ``run.train.compute_dtype``.
      registry: not ported yet (item 14); must be None.
      failure_hook: fault injection point, called with the absolute
        train-step id before each train step (replayed steps included).
      device: ``None`` (the card) or ``"cpu"``.
    """

    def __init__(self, run: RunConfig, scenario=None, *, ckpt_dir: str = "",
                 serve_dtype=torch.float32, registry=None, failure_hook=None, device=None):
        if registry is not None:
            raise NotImplementedError(
                "the online gauges (registry) are not ported yet (ROADMAP Queue 1 item 14)")
        self.ocfg = run.online
        self.failure_hook = failure_hook
        self.trainer = ContinualTrainer(run, scenario, device=device, ckpt_dir=ckpt_dir)
        tr = self.trainer
        if "tokens" not in tr.scenario.item_spec:
            raise ValueError(
                "OnlineLearner needs a token scenario (records with 'tokens'/'labels' "
                f"rows); got {tr.scenario.name!r}")
        self.scenario = tr.scenario
        self.seq_len = self.scenario.item_spec["tokens"].shape[0]
        self.gen_len = self.ocfg.resolved_gen_len(self.seq_len)
        if (self.ocfg.enabled and self.ocfg.store_decode
                and self.ocfg.prompt_len + self.gen_len != self.seq_len + 1):
            raise ValueError(
                f"prompt_len={self.ocfg.prompt_len} + gen_len={self.gen_len} must equal "
                f"seq_len+1={self.seq_len + 1} so admitted records fill the scenario's "
                f"[seq_len] token/label layout (store_decode=False lifts this)")
        # the serving forward: the model the train side builds, in its own dtype
        model, _, _ = build_token_lm(run, self.scenario.stream.cfg.vocab_size)
        self.engine = DecodeEngine(model, StackCtx(cfg=model.cfg, compute_dtype=serve_dtype),
                                   cache_dtype=serve_dtype)

    def _admit_records(self, req: Dict[str, np.ndarray],
                       gen: GenResult) -> Dict[str, torch.Tensor]:
        """Buffer records from one round of traffic, built on the host. With
        ``store_decode`` the record is prompt ++ continuation shifted into
        (tokens, labels); otherwise the raw request rows. The bucket field is
        recomputed from the record's own content (``stream.bucket_of``).
        ``gen.tokens`` comes out of inference mode, so it goes through numpy:
        the records reach the device as ordinary tensors that autograd can
        save."""
        if self.ocfg.store_decode:
            prompts = np.asarray(req["tokens"][:, :self.ocfg.prompt_len])
            full = np.concatenate([prompts, gen.tokens.cpu().numpy()], axis=1)
            tokens = full[:, :-1].astype(np.int32)
            labels = full[:, 1:].astype(np.int32)
        else:
            tokens = np.asarray(req["tokens"], np.int32)
            labels = np.asarray(req["labels"], np.int32)
        rec = {"tokens": tokens, "labels": labels}
        bucket = self.scenario.buffer_task_field
        if bucket in self.scenario.item_spec and bucket not in rec:
            stream = self.scenario.stream
            if hasattr(stream, "bucket_of"):
                rec[bucket] = stream.bucket_of(tokens)
            else:
                rec[bucket] = np.asarray(req[bucket], np.int32)
        return {k: torch.as_tensor(v, device=self.trainer.device) for k, v in rec.items()}

    @staticmethod
    @torch.no_grad()
    def _handoff(serving, params) -> None:
        """Publish the train weights to serving: one device-to-device copy
        per parameter tensor (the LMs hold no buffers), ordered after the
        train step on the same stream."""
        for dst, src in zip(serving.parameters(), params.parameters()):
            dst.copy_(src)

    def _train_round(self, carry, records, train_step: int):
        """``train_every`` steps on this round's records; returns the carry
        and the last step's metrics. Raises whatever a step raises."""
        tr, metrics = self.trainer, {}
        for i in range(self.ocfg.train_every):
            if self.failure_hook is not None:
                self.failure_hook(train_step + i)
            carry, metrics = tr._step_fn(carry, records, fold_in(tr.seed, train_step + i))
        return carry, metrics

    def _resilient_round(self, rloop, carry, records, train_step: int):
        """``train_every`` steps on this round's records in the trainer's
        ``ResilientLoop`` (the round's first checkpoint is taken at its
        start); returns the carry, the last step's metrics and the restarts
        absorbed. Raises when the restart budget is spent."""
        tr = self.trainer
        carry, hist, restarts = rloop.run(carry, lambda step: records, tr.seed,
                                          self.ocfg.train_every, start_step=train_step,
                                          failure_hook=self.failure_hook)
        return carry, hist[-1] if hist else {}, restarts

    def run(self) -> OnlineResult:
        tr, ocfg = self.trainer, self.ocfg
        carry = tr._init(tr.seed)
        serving = copy.deepcopy(carry.params).requires_grad_(False)  # serving's own weights
        rloop = None
        if tr.resilience is not None:
            rloop = tr._resilient_loop(tr._step_fn, tr._stale_step_fn)
        history: List[Dict[str, float]] = []
        freshness_evals: List[Dict[str, float]] = []
        tok_s: List[float] = []
        served = admitted = restarts = 0
        train_disabled = False
        last_handoff = -1  # the round whose training produced the serving weights
        train_step = 0
        last_tokens = None

        for r in range(ocfg.rounds):
            req = self.scenario.batch(0, ocfg.requests_per_round, r)
            prompts = torch.as_tensor(req["tokens"][:, :ocfg.prompt_len], device=tr.device)
            freshness = r - last_handoff
            res = self.engine.generate(serving, prompts, self.gen_len)
            last_tokens = res.tokens
            served += int(prompts.shape[0])
            tok_s.append(res.tokens_per_second)

            trained = False
            loss = float("nan")
            if ocfg.enabled and ocfg.train_every > 0 and not train_disabled:
                records = self._admit_records(req, res)
                try:
                    if rloop is not None:
                        carry, metrics, n = self._resilient_round(rloop, carry, records,
                                                                  train_step)
                        restarts += n
                    else:
                        carry, metrics = self._train_round(carry, records, train_step)
                    loss = float(metrics["loss"])  # waits for the round's steps
                except Exception as e:  # noqa: BLE001 -- serving must survive the train side
                    train_disabled = True
                    log.warning("online: training disabled at round %d: %s: %s", r,
                                type(e).__name__, str(e)[:200], exc_info=True)
                    if rloop is not None:
                        # the failed step wrote the carry in place: go back to
                        # the last checkpoint and serve its weights
                        carry, _ = rloop.ckpt.restore(carry)
                        self._handoff(serving, carry.params)
                else:
                    trained = True
                    train_step += ocfg.train_every
                    admitted += int(prompts.shape[0])
                    self._handoff(serving, carry.params)
                    last_handoff = r

            rate = admitted / served
            history.append({"round": r, "loss": loss, "trained": float(trained),
                            "freshness": float(freshness),
                            "tokens_per_second": res.tokens_per_second,
                            "admission_rate": rate})
            if ocfg.freshness_every and (r + 1) % ocfg.freshness_every == 0:
                stream = self.scenario.stream
                phase = stream.phase_weight(r)[0] if hasattr(stream, "phase_weight") else 0
                freshness_evals.append({"round": r, "phase": phase,
                                        "accuracy": tr.eval_fn(serving, phase)})

        accuracy = [tr.eval_fn(serving, p) for p in range(tr.num_tasks)]
        return OnlineResult(
            history=history,
            decode_tokens_per_second=float(np.mean(tok_s)),
            admission_rate=admitted / served,
            freshness_rounds=history[-1]["freshness"],
            accuracy=accuracy, restarts=restarts, train_disabled=train_disabled,
            freshness_evals=freshness_evals, params=serving, carry=carry,
            last_tokens=last_tokens)
