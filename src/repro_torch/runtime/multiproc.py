"""Real multi-process groups on one host: N OS processes in one
``torch.distributed`` group (gloo on the CPU).

A test host has one card, or none; this gives the closest faithful stand-in
for the paper's multi-node runs: collectives genuinely cross process
boundaries, a rank can genuinely die (``os._exit``), and the survivors
genuinely restart from checkpoints. NCCL across cards needs more than one
card and is not exercised here.

Topology travels in ``REPRO_MP_*`` environment variables: the parent builds
each child's (``worker_env``), spawns plain ``python -c`` children
(``launch_workers``), and each child calls ``init_from_env()`` first. The
ranks meet through a file (``init_method="file://..."``), not a port chosen
ahead: a port closed by the parent can be taken by another process before
rank 0 binds it.

Typical worker body::

    from repro_torch.runtime import multiproc
    rank, world = multiproc.init_from_env()        # joins the group
    ...train, checkpoint per rank, maybe os._exit(1) on cue...

A worker that leaves normally drops every object holding the group (a built
step holds it) and runs ``gc.collect()`` before
``torch.distributed.destroy_process_group()``, so that gloo's threads are
joined there and not in the interpreter's teardown.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

ENV_RENDEZVOUS = "REPRO_MP_RENDEZVOUS"
ENV_NPROCS = "REPRO_MP_NPROCS"
ENV_PID = "REPRO_MP_PID"


def distributed_available() -> Tuple[bool, str]:
    """(ok, reason): can this interpreter run a localhost gloo group? Checked
    without initialising anything, so that callers can skip, and say why."""
    import torch.distributed as dist

    if not dist.is_available():
        return False, "torch.distributed is not built into this torch"
    if not dist.is_gloo_available():
        return False, "torch.distributed has no gloo backend in this torch"
    return True, "ok"


def worker_env(num_processes: int, process_id: int, rendezvous: str,
               base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of one spawned worker: the ``REPRO_MP_*`` topology
    ``init_from_env`` reads. ``rendezvous`` is the path of the group's
    rendezvous file (it must not exist yet, and the same for every rank)."""
    env = dict(os.environ if base_env is None else base_env)
    env[ENV_RENDEZVOUS] = rendezvous
    env[ENV_NPROCS] = str(num_processes)
    env[ENV_PID] = str(process_id)
    return env


def init_from_env(backend: str = "gloo") -> Tuple[int, int]:
    """Join the group described by ``REPRO_MP_*``. Returns (rank, world)."""
    import torch.distributed as dist

    rank, world = int(os.environ[ENV_PID]), int(os.environ[ENV_NPROCS])
    dist.init_process_group(backend, init_method=f"file://{os.environ[ENV_RENDEZVOUS]}",
                            rank=rank, world_size=world)
    return rank, world


def launch_workers(worker_src: str, num_processes: int, *, timeout: float = 240.0,
                   extra_env: Optional[Dict[str, str]] = None,
                   pythonpath: Optional[str] = None,
                   rendezvous_dir: Optional[str] = None):
    """Spawn ``num_processes`` children running ``python -c worker_src`` in
    one group (a fresh rendezvous file in ``rendezvous_dir``, a new
    temporary directory by default); wait for all; return each rank's
    ``CompletedProcess`` (returncode, stdout, stderr).

    A worker that exits non-zero is not an error here: killing ranks is the
    point. A worker that outlives ``timeout`` is killed and reported with
    returncode ``-9``."""
    rendezvous = os.path.join(rendezvous_dir or tempfile.mkdtemp(prefix="repro_mp_"),
                              "rendezvous")
    procs: List[subprocess.Popen] = []
    for pid in range(num_processes):
        env = worker_env(num_processes, pid, rendezvous)
        if pythonpath:
            env["PYTHONPATH"] = pythonpath + os.pathsep + env.get("PYTHONPATH", "")
        env.update(extra_env or {})
        procs.append(subprocess.Popen([sys.executable, "-c", worker_src], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
            rc = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            rc = -9
        results.append(subprocess.CompletedProcess(p.args, rc, out, err))
    return results
