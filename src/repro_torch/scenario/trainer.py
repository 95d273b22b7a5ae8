"""ContinualTrainer: the entry path for continual training (carry backend).

``ContinualTrainer(run, scenario).fit()`` composes

    RunConfig + Scenario
        ├─ scenario.apply_defaults(run.rehearsal)   # policy/bucketing defaults
        ├─ scenario.build_problem(run, device)      # init_params / loss / eval / tap
        ├─ Strategy.record_fields                   # tap strategies' extra fields
        ├─ make_cl_step + init_carry                # buffer + pipeline slot
        │  (step_form='split': make_pipelined_halves, the issue half on its
        │   own CUDA stream)
        ├─ Prefetcher                               # background Load stage
        ├─ ResilientLoop + CheckpointManager        # resilience=: restarts,
        │                                           # stale steps; per-task saves
        └─ accuracy-matrix evaluation               # paper Eq. (1)

The model is the scenario's ``nn.Module``: the CNN of the vision scenario,
or the LM (a ``Decoder``) of the token scenarios, which train through the
plain mixers with autograd. The buffer buckets by the scenario's
``buffer_task_field`` (``DriftStream``: the content label ``"label"``,
while the loss reads ``"labels"``).

The reference's other options are not ported yet and raise: ``mesh`` (the
pjit backend, ROADMAP Queue 1 item 13) and ``obs`` (item 14).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.buffer.api import resolve_field
from repro_torch.configs.base import RehearsalConfig, RunConfig
from repro_torch.data import Cursor, Prefetcher
from repro_torch.device import resolve_device
from repro_torch.rng import fold_in
from repro_torch.scenario.base import Scenario, get_scenario


def _not_ported(what: str, item: int):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


class ContinualTrainer:
    """Scenario-first continual-training facade.

    Args:
      run: the ``RunConfig``; ``run.scenario`` holds the schedule and names the
        scenario when ``scenario`` is not passed.
      scenario: a ``Scenario`` instance, a registry name, or None.
      device: ``None`` (cuda) or ``"cpu"``; without a card only ``"cpu"`` runs.
      strategy: a registered strategy name; default ``run.scenario.strategy``.
        Its hyper-parameters come from ``run.strategy``; a strategy with a
        recommended policy (grasp_embed: grasp) gets it when the config
        leaves the policy at its default.
      step_form: ``'fused'`` (one call a step) or ``'split'`` (the train half,
        then the issue half on its own CUDA stream; the pipelined
        ``rehearsal`` strategy only, as in the reference).
      ckpt_dir: checkpoints of the full carry (model, optimizer, buffer with
        its policy aux, pending slot) after every task, as ``step_<task>``.
      ckpt_every: read only by the pjit backend (ROADMAP Queue 1 item 13);
        accepted, as in the reference.
      resilience: a ``ResilienceConfig`` (or None; ``run.resilience`` is the
        config-file spelling) runs each task's steps in a
        ``runtime.ResilientLoop``: periodic full-carry checkpoints under
        ``ckpt_dir/resilient`` and a cursor rewind give a bit-exact restart
        after a transient failure, and the wall-clock ``step_timeout`` feeds
        the bounded-staleness straggler path (the plain pipelined rehearsal
        step only). Needs ``ckpt_dir`` and ``step_form='fused'``.
      overrides: ``{"failure_hook": fn}``, the chaos injection point: called
        with the absolute step id before each resilient step.
    The trainer is one process, so the rehearsal exchange has no peers.
    """

    def __init__(self, run: RunConfig, scenario=None, *, device=None,
                 strategy: Optional[str] = None, mesh=None, step_form: str = "fused",
                 resilience=None, ckpt_dir: str = "", ckpt_every: int = 0, obs=None,
                 overrides: Optional[Dict[str, Any]] = None):
        from repro_torch.optim import make_optimizer
        from repro_torch.runtime.sanitizer import sanitize_enabled
        from repro_torch.strategy import (STRATEGIES, get_strategy, make_cl_step,
                                          make_pipelined_halves, make_stale_step)

        if mesh is not None:
            _not_ported("the mesh (pjit) backend", 13)
        if step_form not in ("fused", "split"):
            raise ValueError(f"unknown step_form {step_form!r}")
        if obs is not None:
            _not_ported("telemetry (obs)", 14)
        unknown = set(overrides or {}) - {"failure_hook"}
        if unknown:
            raise TypeError(f"unknown trainer overrides: {sorted(unknown)}")
        self._failure_hook = (overrides or {}).get("failure_hook")
        self.resilience = resilience if resilience is not None else run.resilience
        if self.resilience is not None and not ckpt_dir:
            raise ValueError("resilience= needs ckpt_dir: the ResilientLoop's restart "
                             "path restores from ckpt_dir/resilient")
        if self.resilience is not None and step_form != "fused":
            raise ValueError("resilience= needs step_form='fused': the split form's two "
                             "halves have no single step the ResilientLoop can retry "
                             "atomically")
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.device = resolve_device(device)
        self.run = run

        sc = run.scenario
        if isinstance(scenario, str):
            self.scenario: Scenario = get_scenario(dataclasses.replace(sc, name=scenario))
        else:
            self.scenario = get_scenario(scenario if scenario is not None else sc)
        self.strategy = strategy or sc.strategy
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; expected one of "
                             f"{sorted(STRATEGIES)}")
        self.strat = get_strategy(self.strategy)
        self.scfg = run.strategy
        self.num_tasks = self.scenario.num_tasks
        self.epochs_per_task = sc.epochs_per_task
        self.steps_per_epoch = sc.steps_per_epoch
        self.batch_size = sc.batch_size
        self.seed = sc.seed

        rcfg = run.rehearsal
        if sc.auto_defaults:
            rcfg = self.scenario.apply_defaults(rcfg)
            if not self.strat.uses_buffer:
                rcfg = dataclasses.replace(rcfg, mode="off")
            elif self.strat.recommended_policy and rcfg.policy == RehearsalConfig().policy:
                rcfg = dataclasses.replace(rcfg, policy=self.strat.recommended_policy)
        self.rcfg = rcfg
        self.label_field = resolve_field(self.scenario.label_field, rcfg,
                                         "label_field", "label")
        problem = self.scenario.build_problem(run, self.device)
        self.init_params_fn = problem.init_params_fn
        self.loss_fn = problem.loss_fn
        self.eval_fn = problem.eval_fn
        self.forward_outputs = problem.forward_outputs
        self.item_spec = self.scenario.item_spec
        # tap strategies extend the record with fields derived from the
        # model's outputs; the buffer, exchange and tiers see the joined spec
        self.aux_spec = self._strategy_aux_spec()
        self.item_spec = dict(self.item_spec, **self.aux_spec)
        self.init_opt_fn, opt_update = make_optimizer(run.train)
        if rcfg.enabled and self.scenario.buffer_task_field not in self.item_spec:
            raise ValueError(
                f"scenario {self.scenario.name!r} declares bucket field "
                f"{self.scenario.buffer_task_field!r} but its records only carry "
                f"{sorted(self.item_spec)}")
        # one sanitizer a trainer: the fused, stale and split-half wrappers
        # share a single slot clock
        sanitize = sanitize_enabled(run)
        self._step_fn = self._halves = self._stale_step_fn = None
        if step_form == "split":
            if self.strategy != "rehearsal" or not rcfg.is_pipelined:
                raise ValueError("step_form='split' needs the single-device "
                                 "pipelined rehearsal path (mode='async')")
            self._halves = make_pipelined_halves(
                self.loss_fn, opt_update, rcfg, label_field=self.label_field,
                task_field=self.scenario.buffer_task_field, device=self.device,
                sanitize=sanitize)
        else:
            self._step_fn = make_cl_step(
                self.loss_fn, opt_update, rcfg, strategy=self.strat,
                label_field=self.label_field, task_field=self.scenario.buffer_task_field,
                compress=run.train.grad_compress, strategy_cfg=self.scfg,
                forward_outputs=self.forward_outputs, aux_spec=self.aux_spec,
                device=self.device, sanitize=sanitize)
        # The bounded-staleness reuse path: only the plain pipelined rehearsal
        # step carries a pending sample to consume again (tap strategies need
        # the fresh forward's values); elsewhere a straggling exchange is
        # waited for, never replaced by another program.
        if (self.resilience is not None and self.strat.uses_buffer
                and not self.strat.needs_outputs and rcfg.enabled and rcfg.is_pipelined):
            self._stale_step_fn = make_stale_step(
                self.loss_fn, opt_update, rcfg, label_field=self.label_field,
                device=self.device,
                sanitize=getattr(self._step_fn, "_sanitizer", None) or sanitize)

    def _strategy_aux_spec(self):
        """The strategy's extra record field specs (``{}`` without a tap):
        the tap's per-record output specs, from one forward of a one-record
        zero batch, handed to ``Strategy.record_fields``."""
        from repro_torch.strategy import outputs_row_spec

        if not (self.strat.needs_outputs and self.strat.uses_buffer and self.rcfg.enabled):
            return {}
        if self.forward_outputs is None:
            raise TypeError(f"strategy {self.strategy!r} needs the model-outputs tap; the "
                            f"scenario's Problem provides no forward_outputs")
        row_spec = outputs_row_spec(self.forward_outputs, self.init_params_fn(self.seed),
                                    self.item_spec, self.device)
        return dict(self.strat.record_fields(self.item_spec, row_spec, self.scfg))

    def _source(self, task: int) -> Callable[[int], Dict[str, np.ndarray]]:
        """cursor -> raw batch for the given task segment, strategy-aware."""
        if self.strat.cumulative_data:
            return lambda cur: self.scenario.cumulative_batch(task, self.batch_size, cur)
        return lambda cur: self.scenario.batch(task, self.batch_size, cur)

    def _to_device(self, x):
        return torch.as_tensor(x, device=self.device)

    @staticmethod
    def _history_entry(task: int, step: int, loss: float, metrics) -> Dict[str, float]:
        entry = {"task": task, "step": step, "loss": loss}
        for k in ("rep_checksum", "buffer_fill"):
            if k in metrics:
                entry[k] = float(metrics[k])
        return entry

    def _init(self, seed: int):
        from repro_torch.strategy import init_carry

        model = self.init_params_fn(seed)
        opt = self.init_opt_fn(dict(model.named_parameters()))
        return init_carry(model, opt, self.item_spec, self.rcfg,
                          label_field=self.label_field, seed=self.seed,
                          device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _split_step(self, carry, batch, key: int, record: bool):
        """One step of the split form: the train half, then the issue half
        (on its own stream on a card). The fingerprints the fused step emits
        (``rep_checksum`` of the consumed pending slot, ``buffer_fill`` after
        the issue) are computed only on the steps the history records."""
        from repro_torch.buffer.api import buffer_fill
        from repro_torch.strategy import TrainCarry, rep_checksum

        train_half, issue_half = self._halves
        consumed = carry.pipe
        model, opt, metrics = train_half(carry.params, carry.opt, consumed, batch)
        buffer, pipe = issue_half(carry.buffer, consumed, batch, key)
        if record:
            issue_half.join()  # the buffer's counts are written on the issue stream
            metrics = dict(metrics, buffer_fill=buffer_fill(buffer).float(),
                           rep_checksum=rep_checksum(consumed.reps, consumed.valid,
                                                     self.label_field))
        return TrainCarry(model, opt, buffer, pipe), metrics

    def _resilient_loop(self, step_fn, stale_step_fn=None):
        """The ``ResilientLoop`` of ``self.resilience``: its checkpoints live
        under ``ckpt_dir/resilient`` (global-step ids; the per-task saves use
        task ids, so the two must not share a directory), and the straggler
        policy is seeded anew, so that every fit draws the same delays."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.runtime.fault_tolerance import (InjectedFailure, ResilientLoop,
                                                         StragglerPolicy)

        res = self.resilience
        straggler = None
        if res.straggler_delay_prob > 0.0 or res.step_timeout > 0.0:
            straggler = StragglerPolicy(res.straggler_delay_prob, res.max_staleness,
                                        seed=self.seed)
        return ResilientLoop(
            step_fn=step_fn, ckpt=CheckpointManager(os.path.join(self.ckpt_dir, "resilient")),
            checkpoint_every=res.checkpoint_every, max_restarts=res.max_restarts,
            retry_on=None if res.retry_transient else (InjectedFailure,),
            backoff_base=res.backoff_base, backoff_max=res.backoff_max,
            step_timeout=res.step_timeout, straggler=straggler,
            stale_step_fn=stale_step_fn)

    def _timed(self, fn, loads: Dict[str, float]):
        """``fn`` with ``step_seconds`` (from the batch load to the loss on
        the host, as in the plain loop) and ``prefetch_wait_seconds`` (the
        batch load: no prefetcher reads ahead of a loop that can rewind) in
        its metrics; ``loads["last"]`` holds the last load's seconds."""

        @functools.wraps(fn)
        def step(carry, batch, key):
            t0 = time.perf_counter()
            carry, metrics = fn(carry, batch, key)
            loss = float(metrics["loss"])  # waits for the step's work on the card
            return carry, dict(metrics, loss=loss, prefetch_wait_seconds=loads["last"],
                               step_seconds=time.perf_counter() - t0 + loads["last"])

        return step

    def _checkpoint_task(self, task: int, carry, global_step: int, manager):
        """The full carry: the buffer with its policy aux (and the tiered
        stage) and the pending slot, so that a restore rebuilds none of them
        from init."""
        if manager is not None:
            manager.save(task, {"params": carry.params, "opt": carry.opt,
                                "buffer": carry.buffer, "pipe": carry.pipe},
                         {"task": task, "global_step": global_step})

    def fit(self, num_tasks: Optional[int] = None):
        """Train through the first ``num_tasks`` tasks (default: all) and
        return a ``CLRunResult`` (Eq.-1 matrix, runtimes, loss history).

        The loss of every step is read back to the host (one synchronisation
        with the card per step) and recorded with the step's wall time and
        the time it waited on the prefetcher. With ``resilience``, the steps
        run in the ``ResilientLoop``, batches come straight off the
        cursor-pure stream (a prefetcher's read-ahead cannot be rewound), and
        the per-step records are those of the committed steps."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.core.cl_loop import CLRunResult

        T = self.num_tasks if num_tasks is None else num_tasks
        if not 1 <= T <= self.num_tasks:
            raise ValueError(f"num_tasks={num_tasks} outside 1..{self.num_tasks}")
        manager = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        rloop, loads = None, {"last": 0.0}
        if self.resilience is not None:
            rloop = self._resilient_loop(
                self._timed(self._step_fn, loads),
                self._stale_step_fn and self._timed(self._stale_step_fn, loads))
        carry = self._init(self.seed)
        acc = np.zeros((T, T))
        runtimes, history = [], []
        losses, step_seconds, waits = [], [], []
        res_stats: Dict[str, float] = {}
        global_step = 0
        for task in range(T):
            if self.strat.fresh_params_per_task:
                carry = self._init(fold_in(self.seed, 1000 + task))
                n_steps = self.epochs_per_task * self.steps_per_epoch * (task + 1)
            else:
                n_steps = self.epochs_per_task * self.steps_per_epoch
            source = self._source(task)
            t0 = time.perf_counter()
            if rloop is not None:
                def batch_fn(cur, _src=source):
                    t_load = time.perf_counter()
                    batch = {k: self._to_device(v) for k, v in _src(cur).items()}
                    loads["last"] = time.perf_counter() - t_load
                    return batch

                carry, loop_hist, _ = rloop.run(carry, batch_fn, self.seed, n_steps,
                                                start_step=global_step,
                                                failure_hook=self._failure_hook)
                global_step += n_steps
                for s, m in enumerate(loop_hist):
                    losses.append(m["loss"])
                    step_seconds.append(m["step_seconds"])
                    waits.append(m["prefetch_wait_seconds"])
                    if s % max(1, n_steps // 4) == 0:
                        history.append(self._history_entry(task, s, m["loss"], m))
                for k, v in rloop.stats.items():
                    res_stats[k] = res_stats.get(k, 0.0) + v
            else:
                pf = Prefetcher(lambda cur, _src=source: _src(cur.step),
                                cursor=Cursor(task, global_step),
                                convert=self._to_device, limit=n_steps).start()
                try:
                    for s in range(n_steps):
                        t_step = time.perf_counter()
                        _, batch = pf.next()
                        waits.append(time.perf_counter() - t_step)
                        record = s % max(1, n_steps // 4) == 0
                        key = fold_in(self.seed, global_step)
                        if self._halves is not None:
                            carry, metrics = self._split_step(carry, batch, key, record)
                        else:
                            carry, metrics = self._step_fn(carry, batch, key)
                        loss = float(metrics["loss"])
                        step_seconds.append(time.perf_counter() - t_step)
                        losses.append(loss)
                        global_step += 1
                        if record:
                            history.append(self._history_entry(task, s, loss, metrics))
                finally:
                    pf.stop()
            self._sync()
            runtimes.append(time.perf_counter() - t0)
            for j in range(task + 1):
                acc[task, j] = self.eval_fn(carry.params, j)
            self._checkpoint_task(task, carry, global_step, manager)

        if manager is not None:
            manager.wait()
        final = float(np.mean(acc[T - 1, :T]))
        return CLRunResult(strategy=self.strategy, accuracy_matrix=acc,
                           task_runtimes=runtimes, final_accuracy=final,
                           history=history, losses=losses, step_seconds=step_seconds,
                           prefetch_wait_seconds=waits,
                           restarts=int(res_stats.get("restarts", 0)),
                           resilience_stats=res_stats or None)
