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
        └─ accuracy-matrix evaluation               # paper Eq. (1)

The model is the scenario's ``nn.Module``: the CNN of the vision scenario,
or the LM (a ``Decoder``) of the token scenarios, which train through the
plain mixers with autograd. The buffer buckets by the scenario's
``buffer_task_field`` (``DriftStream``: the content label ``"label"``,
while the loss reads ``"labels"``).

The reference's other options are not ported yet and raise: ``mesh`` (the
pjit backend, ROADMAP Queue 1 item 13), ``resilience`` and ``ckpt_dir``
(item 10) and ``obs`` (item 14).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

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
    The trainer is one process, so the rehearsal exchange has no peers.
    """

    def __init__(self, run: RunConfig, scenario=None, *, device=None,
                 strategy: Optional[str] = None, mesh=None, step_form: str = "fused",
                 resilience=None, ckpt_dir: str = "", obs=None):
        from repro_torch.optim import make_optimizer
        from repro_torch.strategy import (STRATEGIES, get_strategy, make_cl_step,
                                          make_pipelined_halves)

        if mesh is not None:
            _not_ported("the mesh (pjit) backend", 13)
        if step_form not in ("fused", "split"):
            raise ValueError(f"unknown step_form {step_form!r}")
        if resilience is not None or run.resilience is not None:
            _not_ported("the resilient loop", 10)
        if ckpt_dir:
            _not_ported("checkpointing", 10)
        if obs is not None:
            _not_ported("telemetry (obs)", 14)
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
        self._step_fn = self._halves = None
        if step_form == "split":
            if self.strategy != "rehearsal" or not rcfg.is_pipelined:
                raise ValueError("step_form='split' needs the single-device "
                                 "pipelined rehearsal path (mode='async')")
            self._halves = make_pipelined_halves(
                self.loss_fn, opt_update, rcfg, label_field=self.label_field,
                task_field=self.scenario.buffer_task_field, device=self.device)
        else:
            self._step_fn = make_cl_step(
                self.loss_fn, opt_update, rcfg, strategy=self.strat,
                label_field=self.label_field, task_field=self.scenario.buffer_task_field,
                compress=run.train.grad_compress, strategy_cfg=self.scfg,
                forward_outputs=self.forward_outputs, aux_spec=self.aux_spec,
                device=self.device)

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

    def fit(self, num_tasks: Optional[int] = None):
        """Train through the first ``num_tasks`` tasks (default: all) and
        return a ``CLRunResult`` (Eq.-1 matrix, runtimes, loss history).

        The loss of every step is read back to the host (one synchronisation
        with the card per step) and recorded with the step's wall time and
        the time it waited on the prefetcher."""
        from repro_torch.core.cl_loop import CLRunResult

        T = self.num_tasks if num_tasks is None else num_tasks
        if not 1 <= T <= self.num_tasks:
            raise ValueError(f"num_tasks={num_tasks} outside 1..{self.num_tasks}")
        carry = self._init(self.seed)
        acc = np.zeros((T, T))
        runtimes, history = [], []
        losses, step_seconds, waits = [], [], []
        global_step = 0
        for task in range(T):
            if self.strat.fresh_params_per_task:
                carry = self._init(fold_in(self.seed, 1000 + task))
                n_steps = self.epochs_per_task * self.steps_per_epoch * (task + 1)
            else:
                n_steps = self.epochs_per_task * self.steps_per_epoch
            source = self._source(task)
            pf = Prefetcher(lambda cur, _src=source: _src(cur.step),
                            cursor=Cursor(task, global_step),
                            convert=self._to_device, limit=n_steps).start()
            t0 = time.perf_counter()
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

        final = float(np.mean(acc[T - 1, :T]))
        return CLRunResult(strategy=self.strategy, accuracy_matrix=acc,
                           task_runtimes=runtimes, final_accuracy=final,
                           history=history, losses=losses, step_seconds=step_seconds,
                           prefetch_wait_seconds=waits)
