"""Host data pipeline: background prefetch + device placement + resumable cursor.

Plays DALI's role from the paper (§V): mini-batches are produced and copied
to the device on a background thread so the Load step overlaps the training
iteration. The cursor (task id, step within task) replays the exact stream
position.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np


@dataclass
class Cursor:
    task: int = 0
    step: int = 0


class _FetchError:
    """Sentinel carrying an exception from the prefetch thread to ``next()``."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _EndOfStream:
    """Sentinel the worker enqueues after its last ``limit``-bounded fetch, so
    a ``next()`` past the limit raises instead of blocking forever."""


class Prefetcher:
    """Wraps ``fetch(cursor) -> batch`` with a bounded background prefetch queue.

    ``convert`` (e.g. a copy to the card) is applied to every batch leaf on
    the background thread, so the host-to-device copy overlaps training
    instead of sitting on the critical path.
    """

    def __init__(self, fetch: Callable[[Cursor], Dict[str, np.ndarray]],
                 cursor: Optional[Cursor] = None,
                 convert: Optional[Callable] = None,
                 limit: Optional[int] = None):
        self._fetch = fetch
        self.cursor = cursor or Cursor()
        self._convert = convert
        self._limit = limit  # max fetches; None = unbounded (stop() bounds it)
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exhausted = False  # worker hit the limit and enqueued _EndOfStream
        self._served = 0  # batches handed out by next(), either path

    def _load(self, cur: Cursor):
        batch = self._fetch(cur)
        if self._convert is not None:
            batch = {k: self._convert(v) for k, v in batch.items()}
        return batch

    def _worker(self, start: Cursor):
        cur = Cursor(start.task, start.step)
        fetched = 0
        while not self._stop.is_set():
            if self._limit is not None and fetched >= self._limit:
                self._enqueue((None, _EndOfStream()))
                return
            try:
                batch = self._load(cur)
            except BaseException as e:  # surface in next(), don't hang the consumer
                batch = _FetchError(e)
            self._enqueue((Cursor(cur.task, cur.step), batch))
            if isinstance(batch, _FetchError):
                return
            fetched += 1
            cur.step += 1

    def _enqueue(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._worker, args=(self.cursor,), daemon=True)
            self._thread.start()
        return self

    def next(self):
        if self._exhausted or (self._limit is not None
                               and self._served >= self._limit):
            raise StopIteration(f"prefetch limit ({self._limit}) reached")
        if self._thread is None:  # synchronous path
            batch = self._load(self.cursor)
            cur = Cursor(self.cursor.task, self.cursor.step)
            self.cursor.step += 1
            self._served += 1
            return cur, batch
        cur, batch = self._q.get()
        if isinstance(batch, _EndOfStream):
            self._exhausted = True
            self.stop()
            raise StopIteration(f"prefetch limit ({self._limit}) reached")
        if isinstance(batch, _FetchError):
            # the producer exited; reset so a retry takes the synchronous path
            self.stop()
            raise batch.exc
        self.cursor = Cursor(cur.task, cur.step + 1)
        self._served += 1
        return cur, batch

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
            self._thread = None
