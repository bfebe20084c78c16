"""multiprocessing.Pool API over cluster tasks.

Parity target: reference python/ray/util/multiprocessing/pool.py — drop-in
Pool so `from multiprocessing import Pool` code scales past one machine by
switching the import.

Counterpart: ray_tpu/util/multiprocessing.py (copied).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Optional

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs: list, single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        out = ray_tpu_torch.get(self._refs, timeout=timeout)
        return out[0] if self._single else out

    def wait(self, timeout: Optional[float] = None):
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                           timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0.001)
            return True
        except Exception:
            return False


class Pool:
    """Task-backed process pool. `processes` caps in-flight submissions on
    the synchronous paths (map/starmap/imap*); the async paths submit
    eagerly and rely on cluster CPUs for limiting."""

    def __init__(self, processes: Optional[int] = None):
        self._processes = processes
        self._closed = False

        @ray_tpu_torch.remote
        def _run(fn, args, kwargs):
            return fn(*args, **(kwargs or {}))

        self._run = _run

    def apply(self, fn: Callable, args: tuple = (), kwds: dict | None = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: dict | None = None) -> AsyncResult:
        assert not self._closed, "Pool is closed"
        return AsyncResult([self._run.remote(fn, tuple(args), kwds)], True)

    def _windowed(self, submits: list) -> list:
        """Run thunks with at most `processes` in flight."""
        if not self._processes:
            return [t() for t in submits]
        out = [None] * len(submits)
        in_flight: dict = {}
        i = 0
        while i < len(submits) or in_flight:
            while i < len(submits) and len(in_flight) < self._processes:
                out[i] = submits[i]()
                in_flight[out[i]] = i
                i += 1
            if in_flight:
                done, _ = ray_tpu_torch.wait(list(in_flight), num_returns=1,
                                       timeout=10)
                for d in done:
                    in_flight.pop(d, None)
        return out

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> list:
        assert not self._closed, "Pool is closed"
        refs = self._windowed(
            [lambda v=v: self._run.remote(fn, (v,), None) for v in iterable])
        return ray_tpu_torch.get(refs, timeout=None)

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        assert not self._closed, "Pool is closed"
        refs = [self._run.remote(fn, (v,), None) for v in iterable]
        return AsyncResult(refs, False)

    def starmap(self, fn: Callable, iterable: Iterable[tuple]) -> list:
        assert not self._closed, "Pool is closed"
        refs = self._windowed(
            [lambda v=v: self._run.remote(fn, tuple(v), None)
             for v in iterable])
        return ray_tpu_torch.get(refs, timeout=None)

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        refs = [self._run.remote(fn, (v,), None) for v in iterable]
        for r in refs:
            yield ray_tpu_torch.get(r, timeout=None)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        pending = [self._run.remote(fn, (v,), None) for v in iterable]
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1,
                                               timeout=None)
            for d in done:
                yield ray_tpu_torch.get(d, timeout=60)

    def close(self):
        self._closed = True

    def terminate(self):
        self._closed = True

    def join(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
