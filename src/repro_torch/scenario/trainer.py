"""ContinualTrainer: the entry path for continual training.

``ContinualTrainer(run, scenario).fit()`` composes

    RunConfig + Scenario
        ├─ scenario.apply_defaults(run.rehearsal)   # policy/bucketing defaults
        ├─ scenario.build_problem(run, device)      # init_params / loss / eval / tap
        ├─ Strategy.record_fields                   # tap strategies' extra fields
        ├─ make_cl_step + init_carry   (carry)      # buffer + pipeline slot
        │  (step_form='split': make_pipelined_halves, the issue half on its
        │   own CUDA stream)
        │  ──or── build_train_step + materialize_state (mesh backend)
        ├─ Prefetcher                               # background Load stage
        ├─ ResilientLoop + CheckpointManager        # resilience=: restarts,
        │                                           # stale steps; per-task saves
        └─ accuracy-matrix evaluation               # paper Eq. (1)

The model is the scenario's ``nn.Module``: the CNN of the vision scenario,
or the LM (a ``Decoder``) of the token scenarios, which train through the
plain mixers with autograd. The buffer buckets by the scenario's
``buffer_task_field`` (``DriftStream``: the content label ``"label"``,
while the loss reads ``"labels"``).

With ``mesh`` (``launch.mesh.make_mesh``), the trainer is one rank of a
data- and tensor-parallel run: the mesh backend
(``launch.steps.build_train_step``, the reference's pjit route) steps this
rank's shard of the model, its buffer, pending slot and slice of the global
batch, with the exchange over its model column's data-parallel ranks and
the gradients summed over them. Every rank runs the same ``fit``.

``run.obs`` (``ObsConfig``) turns the telemetry on: the steps' ``obs/*``
gauges in the history and in ``CLRunResult.obs``, and with ``run.obs.dir``
the trace (``eval`` spans here, the runtime's checkpoint, restore and
reshard spans) and the event log written there.
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
from repro_torch.obs.metrics import read_gauges
from repro_torch.obs.trace import get_tracer
from repro_torch.rng import fold_in
from repro_torch.scenario.base import Scenario, get_scenario


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
      mesh: a mesh (``launch.mesh.make_mesh``) trains through the mesh
        backend instead of ``make_cl_step``; ``None`` is the carry backend.
      exchange: the rehearsal exchange (full | pod_local | local).
      ckpt_every: the mesh backend also saves every ``ckpt_every`` steps
        (0: after every task only), as ``step_<global step>``; each rank of
        an N-rank run saves under ``ckpt_dir/rank_<dp index>``, or on a
        model axis over 1 ``ckpt_dir/rank_<dp index>_<model index>``.
      resilience: a ``ResilienceConfig`` (or None; ``run.resilience`` is the
        config-file spelling) runs each task's steps in a
        ``runtime.ResilientLoop``: periodic full-carry checkpoints under
        ``ckpt_dir/resilient`` and a cursor rewind give a bit-exact restart
        after a transient failure, and the wall-clock ``step_timeout`` feeds
        the bounded-staleness straggler path (the plain pipelined rehearsal
        step only). Needs ``ckpt_dir`` and ``step_form='fused'``. On a mesh
        of more than one worker each rank's loop keeps its checkpoints under
        ``ckpt_dir/rank_<dp index>/resilient`` (on a model axis over 1
        ``ckpt_dir/rank_<dp index>_<model index>/resilient``, each rank
        restoring its own shards), and the ranks agree on every restart
        over every rank of the mesh (``ResilientLoop(group=...)``): a
        failure on any rank restarts them all from the same step.
      overrides: ``{"failure_hook": fn}``, the chaos injection point: called
        with the absolute step id before each resilient step.
    Without a mesh the trainer is one process, so the rehearsal exchange
    has no peers.
    """

    def __init__(self, run: RunConfig, scenario=None, *, device=None,
                 strategy: Optional[str] = None, mesh=None, exchange: str = "full",
                 step_form: str = "fused", resilience=None, ckpt_dir: str = "",
                 ckpt_every: int = 0, overrides: Optional[Dict[str, Any]] = None):
        from repro_torch.optim import make_optimizer
        from repro_torch.runtime.sanitizer import sanitize_enabled
        from repro_torch.strategy import (STRATEGIES, get_strategy, make_cl_step,
                                          make_pipelined_halves, make_stale_step)

        if step_form not in ("fused", "split"):
            raise ValueError(f"unknown step_form {step_form!r}")
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
        mp = None
        if mesh is not None:
            from repro_torch.parallel import model_parallel

            mp = model_parallel(mesh)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.mesh, self.exchange, self.mp = mesh, exchange, mp
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
        problem = self.scenario.build_problem(run, self.device, mp)
        self.init_params_fn = problem.init_params_fn
        self.loss_fn = problem.loss_fn
        self.eval_fn = problem.eval_fn
        self.forward_outputs = problem.forward_outputs
        self.vocab_mp = problem.vocab_mp
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
        self._step_fn = self._halves = self._stale_step_fn = self.built = None
        if mesh is not None:
            from repro_torch.launch.steps import build_train_step

            if step_form != "fused":
                raise ValueError("step_form='split' needs the single-device pipelined "
                                 "rehearsal path (mode='async')")
            # the effective rehearsal config (scenario defaults applied above)
            # drives the builder too: both backends bucket and mask alike
            mesh_run = dataclasses.replace(
                run, rehearsal=rcfg,
                scenario=dataclasses.replace(sc, strategy=self.strategy))
            self.built = build_train_step(
                mesh_run, mesh, scenario=self.scenario, exchange=exchange,
                buffer_budget_bytes=None, strategy=self.strat, device=self.device,
                problem=problem, aux_spec=self.aux_spec, label_field=self.label_field,
                task_field=self.scenario.buffer_task_field)
        elif step_form == "split":
            if self.strategy != "rehearsal" or not rcfg.is_pipelined:
                raise ValueError("step_form='split' needs the single-device "
                                 "pipelined rehearsal path (mode='async')")
            self._halves = make_pipelined_halves(
                self.loss_fn, opt_update, rcfg, label_field=self.label_field,
                task_field=self.scenario.buffer_task_field, device=self.device,
                obs=run.obs, sanitize=sanitize)
        else:
            self._step_fn = make_cl_step(
                self.loss_fn, opt_update, rcfg, strategy=self.strat,
                label_field=self.label_field, task_field=self.scenario.buffer_task_field,
                compress=run.train.grad_compress, strategy_cfg=self.scfg,
                forward_outputs=self.forward_outputs, aux_spec=self.aux_spec,
                device=self.device, obs=run.obs, sanitize=sanitize)
        # The bounded-staleness reuse path: only the plain pipelined rehearsal
        # step carries a pending sample to consume again (tap strategies need
        # the fresh forward's values); elsewhere a straggling exchange is
        # waited for, never replaced by another program.
        if (self.resilience is not None and mesh is None and self.strat.uses_buffer
                and not self.strat.needs_outputs and rcfg.enabled and rcfg.is_pipelined):
            self._stale_step_fn = make_stale_step(
                self.loss_fn, opt_update, rcfg, label_field=self.label_field,
                device=self.device, obs=run.obs,
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
                                    self.item_spec, self.device, self.vocab_mp)
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
        """One history record: the loss, the buffer fingerprints, and the
        ``obs/*`` gauges when the step emits them (one copy to the host)."""
        entry = {"task": task, "step": step, "loss": loss}
        for k in ("rep_checksum", "buffer_fill"):
            if k in metrics:
                entry[k] = float(metrics[k])
        entry.update(read_gauges(metrics))
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

    def _rank_dir(self) -> str:
        """This rank's checkpoint directory: ``ckpt_dir``, or
        ``ckpt_dir/rank_<dp index>`` on a mesh of more than one worker, or
        ``ckpt_dir/rank_<dp index>_<model index>`` on a model axis over 1
        (each rank of a model row holds its own shards)."""
        from repro_torch.parallel import dp_index

        if self.mp is not None:
            return os.path.join(self.ckpt_dir, f"rank_{dp_index(self.mesh)}_{self.mp.index}")
        if self.built is None or self.built.meta["n_dp"] == 1:
            return self.ckpt_dir
        return os.path.join(self.ckpt_dir, f"rank_{dp_index(self.mesh)}")

    def _resilient_loop(self, step_fn, stale_step_fn=None):
        """The ``ResilientLoop`` of ``self.resilience``: its checkpoints live
        under ``resilient`` in this rank's directory (global-step ids; the
        per-task saves use task ids, so the two must not share a directory),
        and the straggler policy is seeded anew, so that every fit draws the
        same delays. On a mesh with a process group, the loop's decisions
        are collective over every rank of the mesh: the data-parallel ranks
        and, on a model axis over 1, the model ranks of each row, whose
        steps pair their collectives as well."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.runtime.fault_tolerance import (InjectedFailure, ResilientLoop,
                                                         StragglerPolicy)

        res = self.resilience
        straggler = None
        if res.straggler_delay_prob > 0.0 or res.step_timeout > 0.0:
            straggler = StragglerPolicy(res.straggler_delay_prob, res.max_staleness,
                                        seed=self.seed)
        group = None
        if self.mesh is not None:
            from repro_torch.parallel import mesh_group

            group = mesh_group(self.mesh)
        return ResilientLoop(
            step_fn=step_fn,
            ckpt=CheckpointManager(os.path.join(self._rank_dir(), "resilient")),
            checkpoint_every=res.checkpoint_every, max_restarts=res.max_restarts,
            retry_on=None if res.retry_transient else (InjectedFailure,),
            backoff_base=res.backoff_base, backoff_max=res.backoff_max,
            step_timeout=res.step_timeout, straggler=straggler,
            stale_step_fn=stale_step_fn, group=group)

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

    def _run_task(self, state, step, source, task: int, n_steps: int, start: int, rloop,
                  loads: Dict[str, float], rec: "_Records", after_step=None):
        """One task's ``n_steps`` steps from the absolute step ``start``:
        ``step(state, batch, key, record) -> (state, metrics)``, batches
        from ``source(cursor)``. With ``rloop`` the steps run in the
        ``ResilientLoop`` (batches straight off the cursor-pure stream: a
        prefetcher's read-ahead cannot be rewound) and the records are those
        of the committed steps; otherwise behind a prefetcher, and
        ``after_step(state, global_step, task)`` follows each step. Returns
        the state."""
        if rloop is not None:
            def batch_fn(cur):
                t_load = time.perf_counter()
                batch = {k: self._to_device(v) for k, v in source(cur).items()}
                loads["last"] = time.perf_counter() - t_load
                return batch

            state, loop_hist, _ = rloop.run(state, batch_fn, self.seed, n_steps,
                                            start_step=start, failure_hook=self._failure_hook)
            for s, m in enumerate(loop_hist):
                rec.add(task, s, n_steps, m["loss"], m, m["step_seconds"],
                        m["prefetch_wait_seconds"])
            for k, v in rloop.stats.items():
                rec.res_stats[k] = rec.res_stats.get(k, 0.0) + v
            return state
        pf = Prefetcher(lambda cur: source(cur.step), cursor=Cursor(task, start),
                        convert=self._to_device, limit=n_steps).start()
        try:
            for s in range(n_steps):
                t_step = time.perf_counter()
                _, batch = pf.next()
                wait = time.perf_counter() - t_step
                state, metrics = step(state, batch, fold_in(self.seed, start + s),
                                      s % max(1, n_steps // 4) == 0)
                loss = float(metrics["loss"])
                rec.add(task, s, n_steps, loss, metrics, time.perf_counter() - t_step, wait)
                if after_step is not None:
                    after_step(state, start + s + 1, task)
        finally:
            pf.stop()
        return state

    def _evaluate(self, acc, task: int, params):
        """Row ``task`` of the accuracy matrix, in one ``eval`` span (each
        eval reads its result back: the span ends with the card's work)."""
        with get_tracer().span("eval", cat="trainer", task=task):
            for j in range(task + 1):
                acc[task, j] = self.eval_fn(params, j)

    def fit(self, num_tasks: Optional[int] = None):
        """Train through the first ``num_tasks`` tasks (default: all) and
        return a ``CLRunResult`` (Eq.-1 matrix, runtimes, loss history).

        The loss of every step is read back to the host (one synchronisation
        with the card per step) and recorded with the step's wall time and
        the time it waited on the prefetcher. With ``resilience``, the steps
        run in the ``ResilientLoop``, batches come straight off the
        cursor-pure stream (a prefetcher's read-ahead cannot be rewound), and
        the per-step records are those of the committed steps.

        With ``run.obs.enabled`` the history entries carry the ``obs/*``
        gauges, folded into ``result.obs`` (``{last, mean, max, n}`` a key);
        with ``run.obs.dir`` too, the fit installs a live tracer and event
        bus (``obs.configure``) and writes ``trace.json`` there at its end
        (``obs.flush``; ``events.jsonl`` streams)."""
        from repro_torch import obs

        T = self.num_tasks if num_tasks is None else num_tasks
        if not 1 <= T <= self.num_tasks:
            raise ValueError(f"num_tasks={num_tasks} outside 1..{self.num_tasks}")
        ocfg = self.run.obs
        to_dir = ocfg.enabled and bool(ocfg.dir)
        if to_dir:
            obs.configure(ocfg.dir, trace=ocfg.trace, events=ocfg.events)
        try:
            result = self._fit_mesh(T) if self.built is not None else self._fit_carry(T)
        finally:
            if to_dir:
                obs.flush()
        if ocfg.enabled:
            writer = obs.MetricsWriter()
            for entry in result.history:
                writer.add(entry)
            if writer.series:
                result.obs = writer.summary()
        return result

    def _fit_carry(self, T: int):
        """``fit`` through the carry backend (``make_cl_step``)."""
        from repro_torch.checkpoint import CheckpointManager

        manager = CheckpointManager(self.ckpt_dir) if self.ckpt_dir else None
        rloop, loads = None, {"last": 0.0}
        if self.resilience is not None:
            rloop = self._resilient_loop(
                self._timed(self._step_fn, loads),
                self._stale_step_fn and self._timed(self._stale_step_fn, loads))

        def step(carry, batch, key, record):
            if self._halves is not None:
                return self._split_step(carry, batch, key, record)
            return self._step_fn(carry, batch, key)

        carry = self._init(self.seed)
        acc, rec = np.zeros((T, T)), _Records()
        global_step = 0
        for task in range(T):
            if self.strat.fresh_params_per_task:
                carry = self._init(fold_in(self.seed, 1000 + task))
                n_steps = self.epochs_per_task * self.steps_per_epoch * (task + 1)
            else:
                n_steps = self.epochs_per_task * self.steps_per_epoch
            t0 = time.perf_counter()
            carry = self._run_task(carry, step, self._source(task), task, n_steps,
                                   global_step, rloop, loads, rec)
            global_step += n_steps
            self._sync()
            rec.runtimes.append(time.perf_counter() - t0)
            self._evaluate(acc, task, carry.params)
            self._checkpoint_task(task, carry, global_step, manager)

        if manager is not None:
            manager.wait()
        return rec.result(self.strategy, acc)

    # ------------------------------------------------------------------ mesh
    def mesh_step(self):
        """The mesh backend's step on a state tuple ``(params, opt, buffer,
        reps, valid, issue_key)`` (``(params, opt)`` without rehearsal):
        ``step(state, batch, key) -> (state, metrics)`` with ``batch`` this
        rank's shard. Step t's issue draws with the key carried from step
        t-1 (``issue_key``), and ``key``, step t's own, is carried to step
        t+1: the carry backend's RNG lineage, so both backends draw the same
        sequence for the same run."""
        fn, off = self.built.fn, self.built.meta["mode"] == "off"

        def step(state, batch, key: int):
            if off:
                params, opt, metrics = fn(state[0], state[1], batch, key)
                return (params, opt), metrics
            *out, metrics = fn(*state[:5], batch, state[5])
            return (*out, key), metrics

        step._sanitizer = getattr(fn, "_sanitizer", None)
        return step

    def mesh_state(self):
        """The mesh backend's initial state tuple (see ``mesh_step``)."""
        state = materialize_state(self.built, self.run, self.mesh, self.seed)
        if self.built.meta["mode"] == "off":
            return state[:2]
        return state + (self.seed,)

    _TREE = ("params", "opt", "buffer", "reps", "valid", "issue_key")

    def mesh_tree(self, state) -> Dict[str, Any]:
        """The checkpoint tree of a mesh state tuple: ``{"params", "opt"}``,
        plus ``"buffer"``, ``"reps"``, ``"valid"`` and ``"issue_key"`` with
        rehearsal."""
        return dict(zip(self._TREE, state))

    def restore_mesh_state(self, step: Optional[int] = None):
        """This rank's state tuple restored from its checkpoint at ``step``
        (``None``: the newest readable one) under ``ckpt_dir``, and the
        checkpoint's metadata (``global_step``, ``task``)."""
        from repro_torch.checkpoint import CheckpointManager

        tree, meta = CheckpointManager(self._rank_dir()).restore(
            self.mesh_tree(self.mesh_state()), step)
        return tuple(tree[k] for k in self._TREE if k in tree), meta

    def _fit_mesh(self, T: int):
        """``fit`` through the mesh backend: this rank's state, its shard of
        every global batch, a save every ``ckpt_every`` steps (outside the
        ``ResilientLoop``, which keeps its own) and after every task unless
        the last step just saved, and per-task eval. The last state tuple
        stays on ``self.final_state``."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.launch.steps import shard_host_batch

        manager = CheckpointManager(self._rank_dir()) if self.ckpt_dir else None
        mesh_step, loads = self.mesh_step(), {"last": 0.0}
        rloop = None
        if self.resilience is not None:
            rloop = self._resilient_loop(self._timed(mesh_step, loads))
        saved = {"at": None}

        def save(state, global_step: int, task: int):
            manager.save(global_step, self.mesh_tree(state),
                         {"task": task, "global_step": global_step})
            saved["at"] = global_step

        def after_step(state, global_step: int, task: int):
            if manager is not None and self.ckpt_every and global_step % self.ckpt_every == 0:
                save(state, global_step, task)

        state = self.mesh_state()
        acc, rec = np.zeros((T, T)), _Records()
        global_step = 0
        for task in range(T):
            n_steps = self.epochs_per_task * self.steps_per_epoch
            t0 = time.perf_counter()
            state = self._run_task(
                state, lambda st, batch, key, _: mesh_step(st, batch, key),
                lambda cur, _src=self._source(task): shard_host_batch(_src(cur), self.mesh),
                task, n_steps, global_step, rloop, loads, rec, after_step)
            global_step += n_steps
            self._sync()
            rec.runtimes.append(time.perf_counter() - t0)
            self._evaluate(acc, task, state[0])
            if manager is not None and saved["at"] != global_step:
                save(state, global_step, task)

        if manager is not None:
            manager.wait()
        self.final_state = state
        return rec.result(self.strategy, acc)


class _Records:
    """The per-step records of a fit and the ``CLRunResult`` they make."""

    def __init__(self):
        self.history, self.losses, self.step_seconds, self.waits = [], [], [], []
        self.runtimes, self.res_stats = [], {}

    def add(self, task: int, s: int, n_steps: int, loss: float, metrics, seconds: float,
            wait: float):
        self.losses.append(loss)
        self.step_seconds.append(seconds)
        self.waits.append(wait)
        if s % max(1, n_steps // 4) == 0:
            self.history.append(ContinualTrainer._history_entry(task, s, loss, metrics))

    def result(self, strategy: str, acc):
        from repro_torch.core.cl_loop import CLRunResult

        T = acc.shape[0]
        return CLRunResult(strategy=strategy, accuracy_matrix=acc, task_runtimes=self.runtimes,
                           final_accuracy=float(np.mean(acc[T - 1, :T])),
                           history=self.history, losses=self.losses,
                           step_seconds=self.step_seconds, prefetch_wait_seconds=self.waits,
                           restarts=int(self.res_stats.get("restarts", 0)),
                           resilience_stats=self.res_stats or None)


def materialize_state(built, run, mesh, key: int):
    """This rank's initial ``(params, opt, buffer, reps, valid)`` for a
    built mesh step (``(params, opt, None, None, None)`` without rehearsal):
    the model from ``key``, its optimizer state (this rank's slices of the
    moments under ``TrainConfig.zero1``), the empty buffer the config
    describes (flat or tiered, its policy's aux initialised, the cold tier
    in pinned host memory on CUDA) and a pending slot of
    ``built.pending_rows`` invalid records (their labels masked to -1: the
    first step trains un-augmented)."""
    from repro_torch.buffer import api as buffer_api
    from repro_torch.buffer.state import mask_invalid

    params = built.problem.init_params_fn(key)
    opt = built.init_opt(dict(params.named_parameters()), getattr(params, "layout_specs", None))
    if built.meta["mode"] == "off":
        return params, opt, None, None, None
    device, rcfg, rows = built.device, built.rcfg, built.pending_rows
    buffer = buffer_api.init_from_config(built.item_spec, rcfg, device)
    reps = {k: torch.zeros((rows,) + tuple(s.shape), dtype=s.dtype, device=device)
            for k, s in built.item_spec.items()}
    valid = torch.zeros((rows,), dtype=torch.bool, device=device)
    return params, opt, buffer, mask_invalid(reps, valid, rcfg.label_field), valid
