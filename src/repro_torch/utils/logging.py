"""Rank-aware logging: the ``[rank N]`` prefix and ``REPRO_LOG_LEVEL``.

An N-rank run (``runtime.multiproc``, torchrun) writes to one terminal, so
every line says which rank wrote it. The rank is ``runtime.multiproc``'s
``REPRO_MP_PID``, else the rank in the default ``torch.distributed`` group
when one is up, else torchrun's ``RANK``.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

# The rank variable of runtime.multiproc's workers (multiproc imports it
# from here: this module must not import the runtime package).
ENV_PID = "REPRO_MP_PID"


def process_rank() -> Optional[int]:
    """This process's rank, or None in a process that is no rank of a group."""
    pid = os.environ.get(ENV_PID, "")
    if pid:
        return int(pid)
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    rank = os.environ.get("RANK", "")
    return int(rank) if rank else None


def get_logger(name: str = "repro_torch") -> logging.Logger:
    """Stderr logger with rank-aware formatting.

    * The format carries a ``[rank N]`` prefix when this process is a rank
      (``process_rank``).
    * The level comes from ``REPRO_LOG_LEVEL`` (default INFO) and is
      re-applied on every call, so an environment change between calls takes
      effect.
    * The handler this function installs is tagged and updated in place:
      repeated calls never stack handlers, and a logger that already has a
      caller's own handlers gets none.
    * Records still propagate, so a handler on an ancestor (pytest's log
      capture) sees them too: the entry points configure no root handler,
      which would print each line twice.
    """
    logger = logging.getLogger(name)
    rank = process_rank()
    prefix = "" if rank is None else f"[rank {rank}] "
    fmt = logging.Formatter(f"%(asctime)s {prefix}%(name)s %(levelname)s %(message)s",
                            "%H:%M:%S")
    ours = [h for h in logger.handlers if getattr(h, "_repro_handler", False)]
    if ours:
        for h in ours:
            h.setFormatter(fmt)
    elif not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler._repro_handler = True
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    level_name = os.environ.get("REPRO_LOG_LEVEL", "").strip().upper()
    level = getattr(logging, level_name, None) if level_name else None
    logger.setLevel(level if isinstance(level, int) else logging.INFO)
    return logger
