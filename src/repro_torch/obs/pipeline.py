"""The pipelined step in its four phases, one trace span each.

A span on the host bounds work on the card only when it ends with a
synchronisation, and the fused step (``make_cl_step``) launches its work
as one stream of kernels. So ``PhasePipeline`` runs the pipelined
rehearsal step as four separately launched phases and synchronises the card
after each:

  ``consume_reps``  the train half: the batch augmented with the pending
                    representatives issued at t-1, the forward, the
                    backward and the optimizer step (``make_pipelined_halves``);
  ``demote_stage``  tiered only: the staged demotions written into the cold
                    tier (``tiered_flush``: the int8 encode);
  ``issue_sample``  the Alg-1 push of this batch into the (hot) buffer
                    (``local_update``, or ``tiered_push``): one update launch;
  ``all_to_all``    the sample of step t+1's representatives
                    (``buffer_sample``): one gather launch; on one process
                    the exchange is the local draw (the span's ``exchange``
                    argument says which).

The fused step launches the update and the sample of the flat buffer as
one ``rehearsal_update_sample``; here they are two (``update_only``, then
``sample_only``'s gather). The draws are replayed exactly: one generator
seeded with ``fold_in(pipe.key, 0)`` serves the phases in the fused step's
order (flush, push, hot sample, cold sample, mix on the tiered store), so a
``PhasePipeline`` run equals ``make_cl_step``'s bit for bit, its
``rep_checksum``, ``buffer_fill`` and loss included. One process, plain
rehearsal: the instrumented form of the step, not another backend.
"""
from __future__ import annotations

# This module is the *instrumented step pipeline*, not a gauge: it replays the
# fused step's generator draw for draw (pinned in tests/test_torch_obs.py), so
# the obs-code-must-not-consume-RNG rule does not apply to it.
# replint: disable=RPL041

from typing import Optional

import torch

from repro_torch.buffer import api as buffer_api
from repro_torch.buffer import tiered as tiered_mod
from repro_torch.buffer.policies import resolve_policy
from repro_torch.buffer.state import local_update, mask_invalid
from repro_torch.device import resolve_device
from repro_torch.obs.trace import get_tracer
from repro_torch.rng import fold_in, generator
from repro_torch.strategy.step import (
    PipelinedRehearsalCarry,
    TrainCarry,
    make_pipelined_halves,
    rep_checksum,
)

PHASES = ("consume_reps", "demote_stage", "issue_sample", "all_to_all")


class PhasePipeline:
    """``step(carry, batch, key) -> (carry, metrics)`` with a span a phase;
    the metrics carry the fused step's ``rep_checksum`` and ``buffer_fill``."""

    def __init__(self, loss_fn, opt_update, rcfg, *, exchange: str = "local",
                 label_field: Optional[str] = None, task_field: Optional[str] = None,
                 tracer=None, obs=None, device=None):
        if rcfg is None or not rcfg.enabled:
            raise ValueError("PhasePipeline needs an enabled RehearsalConfig")
        self.rcfg, self.exchange, self.tracer = rcfg, exchange, tracer
        self.device = resolve_device(device)
        self.label_field = buffer_api.resolve_field(label_field, rcfg, "label_field", "label")
        self.task_field = buffer_api.resolve_field(task_field, rcfg, "task_field", "task")
        self.train_half, _ = make_pipelined_halves(
            loss_fn, opt_update, rcfg, exchange=exchange, label_field=label_field,
            task_field=task_field, device=self.device, obs=obs)
        self.policy = resolve_policy(getattr(rcfg, "policy", None))
        self.fused = bool(getattr(rcfg, "fused_kernels", False))

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, carry: TrainCarry, batch, key: int):
        tracer = self.tracer if self.tracer is not None else get_tracer()
        pipe, rcfg = carry.pipe, self.rcfg
        with tracer.span("consume_reps", cat="pipeline"):
            model, opt, metrics = self.train_half(carry.params, carry.opt, pipe, batch)
            checksum = rep_checksum(mask_invalid(pipe.reps, pipe.valid, self.label_field),
                                    pipe.valid, self.label_field)
            self._wait()
        # the fused issue half's generator, drawn in its order
        gen = generator(fold_in(pipe.key, 0), self.device)
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        labels, buf = batch[self.task_field], carry.buffer
        if rcfg.tiered:
            with tracer.span("demote_stage", cat="pipeline"):
                buf = tiered_mod.tiered_flush(buf, gen, fused=self.fused)
                self._wait()
            with tracer.span("issue_sample", cat="pipeline"):
                buf = tiered_mod.tiered_push(buf, batch, labels, gen, rcfg.num_candidates,
                                             self.policy)
                self._wait()
        else:
            with tracer.span("issue_sample", cat="pipeline"):
                buf = local_update(buf, batch, labels, gen, rcfg.num_candidates, self.policy)
                self._wait()
        with tracer.span("all_to_all", cat="pipeline", exchange=self.exchange):
            reps, valid = buffer_api.buffer_sample(buf, gen, rcfg.num_representatives, rcfg)
            self._wait()
        metrics = dict(metrics, rep_checksum=checksum,
                       buffer_fill=buffer_api.buffer_fill(buf).float())
        return TrainCarry(model, opt, buf, PipelinedRehearsalCarry(reps, valid, key),
                          carry.ef), metrics
