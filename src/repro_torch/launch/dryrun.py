"""Dry run: count one rank's step of every (arch x shape x mesh) cell at the
production mesh, on the CPU, with nothing allocated.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape decode_32k --mesh single

The reference lowers and compiles each cell's XLA program over 256 or 512
fake devices and reads XLA's cost and memory analyses
(``repro/launch/dryrun.py``). Torch has no compiled program to read, so the
port runs the work instead:

  * one rank (rank 0) of the production mesh, ``(16, 16)`` over ``('data',
    'model')`` or ``(2, 16, 16)`` with ``pod`` (``launch.mesh.
    make_production_mesh``), inside a fake process group of 256 or 512
    ranks (``torch.testing._internal.distributed.fake_pg``: every
    collective returns at once);
  * the port's own step, ``launch.steps.build_train_step``,
    ``build_prefill_step`` or ``build_decode_step``, on its state and batch
    drawn under ``FakeTensorMode``: shapes and dtypes only;
  * ``FlopCounterMode`` counts the flops (matrix products, convolutions and
    attention: elementwise work is not counted);
  * a ``TorchDispatchMode`` sums the bytes every op reads and writes (views
    move none). This count is unfused: an upper bound beside XLA's fused
    "bytes accessed". The same mode records each ``c10d`` call (kind,
    per-rank result bytes, group size) for the roofline's collective term,
    and tracks the bytes of the tensors the step allocates that are still
    alive, for a peak above the arguments;
  * the arguments' bytes per rank (parameters, optimizer state, buffer,
    pending slot, caches and the batch) are exact.

On fake CPU tensors the kernel wrappers take their plain versions, so flash
attention and the SSD scan count as the plain versions' work (the reference
likewise counts XLA's attention, not Pallas). The port keeps its weights in
f32 on every path, as its serve CLI draws them; the reference's dry run
stores serving weights in bf16. A step that reads a value back to the host
(``.item()``, a data-dependent shape) cannot run on fake tensors: its cell
prints ``FAIL`` with the op and the line that asked, and counts in the exit
code. No number is estimated in its place.

``--method scaled`` counts two shallow depths (one and two units of the
stack) and fits the full depth: every per-step count is affine in the layer
count. ``--method scan`` (the reference's name) runs the full depth.
Records go to ``--out`` (default ``dryrun_torch/``) as one JSON a cell.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import roofline
from repro_torch.configs import ARCHS, SHAPES, cell_applicable, get_config
from repro_torch.configs.base import (RehearsalConfig, RunConfig, ScenarioConfig, ShapeConfig,
                                      StrategyConfig, TrainConfig)

NOTES = ("flops: FlopCounterMode (products, convolutions, attention); bytes: every op's "
         "reads and writes unfused, an upper bound beside XLA's fused bytes accessed; "
         "kernels: their plain versions on fake CPU tensors")

# c10d op -> roofline kind
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "send/recv", "recv_": "send/recv",
}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "_local_scalar_dense", "lift_fresh", "set_"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what one step does: ``bytes`` every op reads and writes
    (views none), ``collectives`` (``roofline.Collective`` a ``c10d`` call;
    a kind the roofline has no formula for raises, naming the op), and
    ``peak_live`` (the most bytes of the tensors made inside that were
    alive at once). Works on fake and on real tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.collectives: List[roofline.Collective] = []
        self.live = 0
        self.peak_live = 0
        self._refs: Dict[int, list] = {}

    def _hold(self, t: torch.Tensor, fresh: bool) -> None:
        storage = t.untyped_storage()._cdata
        entry = self._refs.get(storage)
        if entry is None:
            if not fresh:
                return
            entry = self._refs[storage] = [0, t.untyped_storage().nbytes()]
            self.live += entry[1]
            self.peak_live = max(self.peak_live, self.live)
        entry[0] += 1
        weakref.finalize(t, self._drop, storage)

    def _drop(self, storage: int) -> None:
        entry = self._refs.get(storage)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._refs[storage]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        rets = func._schema.returns
        view = any(r.alias_info is not None and not r.alias_info.is_write for r in rets)
        outs = _tensors(out)
        if ns != "aten" or not outs:  # metadata (prim.device, sizes): no traffic
            return out
        if view or name in _NO_TRAFFIC:
            for t in _tensors(out):
                self._hold(t, False)
            return out
        inplace = any(r.alias_info is not None and r.alias_info.is_write for r in rets)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
        self.bytes += sum(_nbytes(t) for t in outs)
        for t in outs:
            self._hold(t, not inplace)
        return out

    def _collective(self, name: str, args, out) -> None:
        if name in ("barrier", "monitored_barrier_"):
            return
        if name not in _C10D:
            raise NotImplementedError(f"c10d.{name}: a collective the roofline has no "
                                      f"formula for")
        kind = _C10D[name]
        group = dist.ProcessGroup.unbox(next(a for a in args
                                             if isinstance(a, torch.ScriptObject)))
        # the first argument is the result: the in-place tensors, or the output
        nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
        self.collectives.append(roofline.Collective(kind, nbytes, int(group.size())))


def _host_line(exc: BaseException) -> str:
    """The innermost line of the port that raised ``exc``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename and not f.filename.endswith("dryrun.py")]
    if not frames:
        return ""
    f = frames[-1]
    return f" at {os.path.relpath(f.filename)}:{f.lineno}"


def _fail_reason(exc: BaseException) -> str:
    op = getattr(exc, "func", None)
    what = f"{type(exc).__name__}" + (f" in {op}" if op is not None else "")
    return f"{what}{_host_line(exc)}: {str(exc).splitlines()[0][:200] if str(exc) else ''}"


# ---------------------------------------------------------------------------
# The model side of a train cell
# ---------------------------------------------------------------------------


def _record_spec(cfg, seq_len: int) -> Dict[str, Any]:
    """A train record of ``cfg``'s family, the reference's ``input_specs``
    without the batch axis."""
    from repro_torch.buffer.state import ItemSpec

    s = seq_len
    if cfg.family == "encdec":
        return {"frames": ItemSpec((s, cfg.d_model), torch.float32),
                "tokens": ItemSpec((s,), torch.int32), "labels": ItemSpec((s,), torch.int32),
                "task": ItemSpec((), torch.int32)}
    if cfg.frontend == "patch_stub":
        return {"embeddings": ItemSpec((s, cfg.d_model), torch.float32),
                "positions": ItemSpec((s, 3), torch.int32),
                "labels": ItemSpec((s,), torch.int32), "task": ItemSpec((), torch.int32)}
    return {"tokens": ItemSpec((s,), torch.int32), "labels": ItemSpec((s,), torch.int32),
            "task": ItemSpec((), torch.int32)}


def _shape_scenario(cfg, seq_len: int, num_tasks: int):
    """A scenario of records shaped like ``cfg``'s inputs and no stream:
    the model side of a train cell for every family (the token scenarios
    refuse the enc-dec and the VLM, whose records they cannot fill)."""
    from repro_torch.models import StackCtx, build_model
    from repro_torch.models.transformer import vocab_mp
    from repro_torch.parallel import seq_parallel
    from repro_torch.scenario.base import Problem, Scenario

    class ShapeScenario(Scenario):
        name = "dryrun"
        label_field = "labels"

        @property
        def seq_len(self) -> int:
            return seq_len

        @property
        def num_tasks(self) -> int:
            return num_tasks

        @property
        def item_spec(self):
            return _record_spec(cfg, seq_len)

        def batch(self, task, batch_size, cursor):
            raise NotImplementedError("the dry run's scenario has no stream")

        def eval_set(self, task):
            raise NotImplementedError("the dry run's scenario has no stream")

        def build_problem(self, run, device, mp=None) -> Problem:
            lm = build_model(cfg)
            tcfg = run.train
            dtype = torch.float32 if tcfg.compute_dtype == "float32" else torch.bfloat16
            ctx = StackCtx(cfg=cfg, compute_dtype=dtype,
                           mp=seq_parallel(mp, tcfg.sequence_parallel), remat=tcfg.remat)

            def init_params_fn(seed: int):
                return lm.init(torch.Generator().manual_seed(seed), seq_len, device, mp)

            def loss_fn(model, batch):
                loss, _ = lm.loss(model, batch, ctx)
                return loss, {}

            outputs = None if lm.outputs is None else (lambda m, b: lm.outputs(m, b, ctx))
            return Problem(init_params_fn, loss_fn, None, outputs, vocab_mp(cfg, ctx))

    return ShapeScenario()


# ---------------------------------------------------------------------------
# Counting one rank's step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks (none for one) for the
    duration; refuses to replace a group already in use."""
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the dry run makes its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh_for(mesh_shape, axes):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(tuple(mesh_shape), tuple(axes), "cpu")


def _batch(cfg, shape: ShapeConfig, rows: int, kind: str):
    """The rank's batch of ``rows`` rows (empty tensors: nothing is read)."""
    b, s, d = rows, shape.seq_len, cfg.d_model
    if kind == "decode":
        if cfg.frontend == "patch_stub":
            return {"embedding": torch.zeros((b, 1, d))}
        return {"token": torch.zeros((b, 1), dtype=torch.long)}
    spec = _record_spec(cfg, s)
    out = {k: torch.zeros((b,) + tuple(v.shape), dtype=v.dtype) for k, v in spec.items()}
    if kind != "train":
        out = {k: v for k, v in out.items() if k not in ("labels", "task")}
    return out


def _train_run(cfg, shape, tcfg, mode, strategy, der_top_k, num_tasks=2):
    return RunConfig(
        model=cfg, train=tcfg,
        rehearsal=RehearsalConfig(mode=mode, label_field="labels", task_field="task",
                                  num_buckets=num_tasks),
        strategy=StrategyConfig(top_k=der_top_k),
        scenario=ScenarioConfig(name="class_incremental", modality="tokens",
                                strategy=strategy, num_tasks=num_tasks,
                                batch_size=shape.global_batch, vocab_size=cfg.vocab_size,
                                seq_len=shape.seq_len, auto_defaults=False))


def count_step(cfg, shape: ShapeConfig, mesh_shape, axes, *, rank: int = 0,
               mode: str = "async", remat: str = "dots", exchange: str = "full",
               compute_dtype: str = "bfloat16", attn: str = "auto", sp: bool = False,
               param_dtype: str = "float32", zero1: bool = False,
               kv_dtype: str = "bfloat16", strategy: str = "rehearsal",
               der_top_k: int = 0, fake: bool = True) -> dict:
    """Run rank ``rank``'s step of ``cfg`` at ``shape`` on a ``mesh_shape``
    mesh over ``axes`` and count it. ``fake``: inside a fake process group
    of the mesh's size, every tensor under ``FakeTensorMode``; otherwise in
    the caller's process group on real CPU tensors (the collective records
    of the two are compared). Returns the counts, the arguments' bytes by
    part and the built step's meta."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import steps

    world = 1
    for n in mesh_shape:
        world *= n
    tcfg = TrainConfig(optimizer="adamw", remat=remat, compute_dtype=compute_dtype,
                       attn_impl=attn, sequence_parallel=sp, param_dtype=param_dtype,
                       zero1=zero1, kv_dtype=kv_dtype)
    group = fake_world(world, rank) if fake else contextlib.nullcontext()
    with group:
        mesh = _mesh_for(mesh_shape, axes)
        from repro_torch.parallel import dp_size

        if shape.kind == "decode":  # the caches' groups, made on real tensors
            steps.cache_shards(cfg, mesh, shape.global_batch, shape.seq_len)

        n_dp = dp_size(mesh)
        rows = shape.global_batch // n_dp if shape.global_batch % n_dp == 0 else \
            shape.global_batch
        tensors = FakeTensorMode(allow_non_fake_inputs=True) if fake else \
            contextlib.nullcontext()
        counter, flops = StepCounter(), FlopCounterMode(display=False)
        t0 = time.perf_counter()
        with tensors:
            if shape.kind == "train":
                run = _train_run(cfg, shape, tcfg, mode, strategy, der_top_k)
                built = steps.build_train_step(
                    run, mesh, scenario=_shape_scenario(cfg, shape.seq_len, 2),
                    exchange=exchange, device="cpu")
                from repro_torch.scenario.trainer import materialize_state

                params, opt, buf, reps, valid = materialize_state(built, run, mesh, 0)
                batch = _batch(cfg, shape, rows, "train")
                parts = {"params": params.state_dict(), "opt": opt, "buffer": buf,
                         "pending": (reps, valid), "batch": batch}
                meta = dict(built.meta, item_spec=built.item_spec)
                args = (params, opt, buf, reps, valid, batch, 0) if meta["mode"] != "off" \
                    else (params, opt, batch, 0)
                fn = built.fn
            else:
                run = RunConfig(model=cfg, train=tcfg, scenario=ScenarioConfig(
                    modality="tokens", batch_size=shape.global_batch,
                    seq_len=shape.seq_len))
                build = steps.build_prefill_step if shape.kind == "prefill" else \
                    steps.build_decode_step
                built = build(run, mesh)
                params = built.model.init(torch.Generator().manual_seed(0), shape.seq_len,
                                          "cpu", built.ctx.mp)
                batch = _batch(cfg, shape, rows, shape.kind)
                parts = {"params": params.state_dict(), "batch": batch}
                if shape.kind == "decode":
                    caches = built.model.init_cache(params, rows, shape.seq_len,
                                                    dtype=built.cache_dtype, mp=built.ctx.mp,
                                                    seq=built.ctx.kv_seq)
                    parts["caches"] = caches
                    args = (params, caches, batch, shape.seq_len - 1)
                else:
                    args = (params, batch)
                meta = {"kind": shape.kind,
                        "tokens_per_step": shape.global_batch * (
                            1 if shape.kind == "decode" else shape.seq_len)}
                if shape.kind == "decode":
                    meta["cache_len"] = shape.seq_len
                    meta["kv_seq"] = {k: None if v is None else list(v.axes)
                                      for k, v in (built.ctx.kv_seq or {}).items()}
                fn = built.fn
            t_build = time.perf_counter() - t0
            arg_bytes = {k: sum(_nbytes(t) for t in _tensors(v)) for k, v in parts.items()}
            with flops, counter:
                fn(*args)
        t_run = time.perf_counter() - t0 - t_build
    meta.setdefault("tokens_per_step", shape.global_batch * shape.seq_len)
    item_spec = meta.pop("item_spec", None)
    return {"item_spec": item_spec, "flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes), "ops": counter.ops,
            "collectives": [tuple(c) for c in counter.collectives],
            "argument_bytes": arg_bytes, "argument_bytes_total": sum(arg_bytes.values()),
            "peak_bytes": sum(arg_bytes.values()) + counter.peak_live,
            "build_s": round(t_build, 1), "run_s": round(t_run, 1), "meta": meta,
            "chips": world, "rows": rows}


# ---------------------------------------------------------------------------
# The cost model of the rehearsal buffer
# ---------------------------------------------------------------------------


def rehearsal_buffer_cost(built, rcfg) -> dict:
    """Per-DP-worker rehearsal-buffer memory model, tiering- and
    strategy-aware (the reference's). ``built``: a ``BuiltStep`` (its
    ``item_spec``, the stored record, and ``meta``).

    Flat (``tiering='off'``): ``K x slots`` raw rows on the device. Tiered
    (``'host'``): the hot tier plus the raw demotion staging rows on the
    device, the cold tier's ``K x cold_slots`` int8 rows in pinned host
    memory (per float leaf: 1 byte an element + a 4-byte row scale; integer
    leaves raw). The ``aux_*`` entries break out the tap strategies' stored
    fields (``meta['aux_fields']``)."""
    from repro_torch.buffer.tiered import resolve_cold_placement

    if built.meta.get("mode", "off") == "off":
        return {"mode": "off", "hot_hbm_bytes": 0, "cold_host_bytes": 0,
                "total_bytes": 0, "rows_per_bucket": 0}
    aux_fields = dict(built.meta.get("aux_fields", {}))
    raw_row = cold_row = 0
    for spec in built.item_spec.values():
        n = 1
        for d in spec.shape:
            n *= d
        itemsize = torch.empty((), dtype=spec.dtype).element_size()
        raw_row += n * itemsize
        cold_row += n + 4 if spec.dtype.is_floating_point else n * itemsize
    aux_row = sum(aux_fields.values())
    k = rcfg.num_buckets
    hot_slots = built.meta["slots_per_bucket"]
    if rcfg.tiered:
        cold_slots = rcfg.resolved_cold_slots
        stage = rcfg.resolved_demote_stage
        hot = k * hot_slots * raw_row + stage * raw_row
        cold = k * cold_slots * cold_row
        rows = hot_slots + cold_slots
    else:
        cold_slots = stage = 0
        hot = k * hot_slots * raw_row
        cold = 0
        rows = hot_slots
    device = getattr(built, "device", None) or torch.device("cpu")
    return {
        "mode": "tiered" if cold_slots else "flat",
        "cold_placement": resolve_cold_placement(device) if cold_slots else None,
        "raw_row_bytes": raw_row,
        "cold_row_bytes": cold_row,
        "strategy": built.meta.get("strategy", "rehearsal"),
        "aux_fields": aux_fields,
        "aux_row_bytes": int(aux_row),
        "aux_hot_bytes": int(aux_row) * k * hot_slots,
        "hot_slots_per_bucket": hot_slots,
        "cold_slots_per_bucket": cold_slots,
        "demote_stage_rows": stage,
        "hot_hbm_bytes": int(hot),
        "cold_host_bytes": int(cold),
        "total_bytes": int(hot + cold),
        "rows_per_bucket": rows,
        "capacity_multiplier": round(rows / max(1, hot_slots), 3),
    }


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _record(cfg, arch, shape, mesh_name, counts, compute_dtype, notes) -> dict:
    result = roofline.analyze(
        arch=arch, shape=shape.name, mesh_name=mesh_name, kind=shape.kind,
        chips=counts["chips"], cost={"flops": counts["flops"], "bytes accessed": counts["bytes"]},
        collectives=[roofline.Collective(*c) for c in counts["collectives"]],
        active_params=cfg.active_param_count(),
        tokens_per_step=counts["meta"]["tokens_per_step"],
        memory_bytes=counts["peak_bytes"], compute_dtype=compute_dtype, notes=notes)
    record = dataclasses.asdict(result)
    record.update(status="ok", build_s=counts["build_s"], run_s=counts["run_s"],
                  ops=counts["ops"], total_params=cfg.param_count(), meta=counts["meta"],
                  memory_analysis={"argument_bytes": counts["argument_bytes_total"],
                                   "arguments": counts["argument_bytes"],
                                   "peak_bytes": counts["peak_bytes"]})
    return record


def _count_cell(cfg, arch, shape, multi_pod, *, capacity=1.25, tiering="off", cold_slots=0,
                **kw) -> dict:
    if capacity != 1.25:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    mesh_shape, axes = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    counts = count_step(cfg, shape, mesh_shape, axes, **kw)
    mesh_name = "multi" if multi_pod else "single"
    notes = (f"mode={counts['meta'].get('mode', '-')} remat={kw.get('remat', 'dots')} "
             f"exchange={kw.get('exchange', 'full')}; {NOTES}")
    record = _record(cfg, arch, shape, mesh_name, counts, kw.get("compute_dtype", "bfloat16"),
                     notes)
    if shape.kind == "train":
        slots = counts["meta"].get("slots_per_bucket", 0)
        rcfg = RehearsalConfig(mode=kw.get("mode", "async"), num_buckets=2, tiering=tiering,
                               hot_slots=slots, cold_slots=cold_slots)
        from types import SimpleNamespace

        record["rehearsal_buffer"] = rehearsal_buffer_cost(
            SimpleNamespace(meta=counts["meta"], item_spec=counts["item_spec"]), rcfg)
        from repro_torch.obs.metrics import estimate_obs_cost

        record["obs_cost"] = estimate_obs_cost(
            rcfg, has_aux=bool(counts["meta"].get("aux_fields")),
            policy=getattr(rcfg, "policy", None))
    return record


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, out_dir: str = "dryrun_torch",
             tag: str = "", **kw) -> dict:
    """Count one cell at the full depth and write its record."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    if not ok:
        return {"cell": cell_id, "status": "skipped", "reason": reason}
    record = _count_cell(cfg, arch, shape, multi_pod, **kw)
    record["cell"] = cell_id
    _write(out_dir, cell_id, record)
    return record


def _write(out_dir: str, cell_id: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(record, f, indent=1)


def _affine_scale(r1: dict, r2: dict, l1: int, l2: int, l_full: int) -> dict:
    """Linear extrapolation of additive cost fields from two shallow counts.

    Every per-step count is affine in layer count (const embed/logits/buffer
    part + per-layer part): c(L) = c(l1) + (c(l2)-c(l1))/(l2-l1) * (L-l1),
    exact at a third depth (``tests/test_torch_dryrun.py``)."""
    def ex(a, b):
        return a + (b - a) * (l_full - l1) / (l2 - l1)

    out = dict(r2)
    for k in ("flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip"):
        out[k] = ex(r1[k], r2[k])
    per = {}
    kinds = set(r1["per_collective"]) | set(r2["per_collective"])
    for kind in kinds:
        d1 = r1["per_collective"].get(kind, {"bytes": 0.0, "count": 0})
        d2 = r2["per_collective"].get(kind, {"bytes": 0.0, "count": 0})
        per[kind] = {"bytes": ex(d1["bytes"], d2["bytes"]),
                     "count": ex(d1["count"], d2["count"])}
    out["per_collective"] = per
    if r1.get("memory_analysis") and r2.get("memory_analysis"):
        m1, m2 = r1["memory_analysis"], r2["memory_analysis"]
        out["memory_analysis"] = {k: int(ex(m1[k], m2[k])) for k in m1
                                  if isinstance(m1[k], (int, float))}
    # recompute derived terms from the scaled primitives
    peak = out.get("peak_flops", roofline.PEAK_FLOPS)
    t = roofline.terms(out["flops_per_chip"], out["bytes_per_chip"],
                       out["collective_bytes_per_chip"], peak)
    out["compute_s"], out["memory_s"], out["collective_s"] = (
        t["compute"], t["memory"], t["collective"])
    out["bottleneck"] = max(t, key=t.get)
    glob = max(out["flops_per_chip"] * out["chips"], 1.0)
    out["useful_ratio"] = out["model_flops"] / glob
    ideal_s = (out["model_flops"] / out["chips"]) / peak
    out["roofline_fraction"] = ideal_s / max(max(t.values()), 1e-12)
    out["depth_fit"] = {"l1": l1, "l2": l2, "l_full": l_full,
                        "run_s": [r1.get("run_s"), r2.get("run_s")]}
    return out


def run_cell_scaled(arch: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    """The two-depth fit: count one and two units of the stack, extrapolate
    to the full depth (shallow stacks are counted whole)."""
    from repro_torch.models.transformer import unit_period

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    tag = kw.pop("tag", "") or "scaled"
    out_dir = kw.pop("out_dir", "dryrun_torch")
    cell_id = f"{arch}__{shape_name}__{mesh_name}__{tag}"
    if not ok:
        return {"cell": cell_id, "status": "skipped", "reason": reason}
    period = unit_period(cfg)
    l_full = cfg.num_layers
    l1, l2 = period, 2 * period
    if l_full <= max(8, l2):
        rec = _count_cell(cfg, arch, shape, multi_pod, **kw)
        rec["depth_fit"] = {"l1": l_full, "l2": l_full, "l_full": l_full}
    else:
        recs = []
        for depth in (l1, l2):
            sub = dataclasses.replace(cfg, num_layers=depth)
            if cfg.num_encoder_layers:
                sub = dataclasses.replace(sub, num_encoder_layers=max(
                    1, cfg.num_encoder_layers * depth // l_full))
            recs.append(_count_cell(sub, arch, shape, multi_pod, **kw))
        # the useful flops of the full depth (the shallow records hold theirs)
        full = (6 if shape.kind == "train" else 2) * cfg.active_param_count() * \
            recs[1]["meta"]["tokens_per_step"]
        rec = _affine_scale(*(dict(r, model_flops=full) for r in recs), l1, l2, l_full)
        rec["total_params"] = cfg.param_count()
    rec["cell"], rec["status"] = cell_id, "ok"
    _write(out_dir, cell_id, rec)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all"] + list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mode", default="async", choices=["async", "sync", "off"],
                    help="rehearsal mode for train cells")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--exchange", default="full", choices=["full", "pod_local", "local"])
    ap.add_argument("--capacity", type=float, default=1.25)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--attn", default="auto", choices=["auto", "blocked", "naive"])
    ap.add_argument("--sp", action="store_true", help="Megatron sequence parallelism")
    ap.add_argument("--param-dtype", default="float32")
    ap.add_argument("--zero1", action="store_true", help="shard optimizer state over data")
    ap.add_argument("--kv-dtype", default="bfloat16",
                    help="decode-cache storage dtype (bfloat16 | float8_e4m3fn)")
    ap.add_argument("--tiering", default="off", choices=["off", "host"],
                    help="model a host int8 cold tier in the buffer cost model")
    ap.add_argument("--cold-slots", type=int, default=0,
                    help="cold rows/bucket for the tiered cost model (0 -> 3x hot)")
    ap.add_argument("--strategy", default="rehearsal",
                    help="training strategy for train cells (rehearsal | der | der_pp | "
                         "grasp_embed)")
    ap.add_argument("--der-top-k", type=int, default=0,
                    help="DER stored-logit top-k compression (0 = dense rows)")
    ap.add_argument("--method", default="scan", choices=["scan", "scaled"],
                    help="scan: the full depth; scaled: the two-depth fit")
    ap.add_argument("--out", default="dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                mesh_name = "multi" if multi else "single"
                tag = args.tag or ("scaled" if args.method == "scaled" else "")
                cell_id = f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")
                if args.skip_existing and os.path.exists(os.path.join(args.out,
                                                                      cell_id + ".json")):
                    print(f"SKIP(existing) {cell_id}", flush=True)
                    continue
                try:
                    runner = run_cell_scaled if args.method == "scaled" else run_cell
                    rec = runner(
                        arch, shape, multi, mode=args.mode, remat=args.remat,
                        exchange=args.exchange, capacity=args.capacity,
                        compute_dtype=args.compute_dtype, attn=args.attn, sp=args.sp,
                        param_dtype=args.param_dtype, zero1=args.zero1,
                        kv_dtype=args.kv_dtype, tiering=args.tiering,
                        cold_slots=args.cold_slots, strategy=args.strategy,
                        der_top_k=args.der_top_k, out_dir=args.out, tag=args.tag)
                    if rec["status"] == "skipped":
                        print(f"SKIP {cell_id}: {rec['reason']}", flush=True)
                    else:
                        print(f"OK   {cell_id} run={rec.get('run_s')}s "
                              f"flops/chip={rec['flops_per_chip']:.3e} "
                              f"coll/chip={rec['collective_bytes_per_chip']:.3e} "
                              f"bottleneck={rec['bottleneck']} "
                              f"roofline={rec['roofline_fraction']:.3f}", flush=True)
                except Exception as exc:  # a cell that cannot run on fake tensors
                    failures += 1
                    print(f"FAIL {cell_id}: {_fail_reason(exc)}", flush=True)
                    if dist.is_initialized():
                        dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
