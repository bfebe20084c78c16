"""ActorPool: load-balance work over a fixed set of actors.

Parity target: reference python/ray/util/actor_pool.py (ActorPool —
submit/get_next/get_next_unordered/map/map_unordered/has_next/has_free/
push/pop_idle).

Counterpart: ray_tpu/util/actor_pool.py (copied).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: list):
        self._idle = list(actors)
        self._future_to_actor: dict = {}
        self._index_to_future: dict[int, Any] = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list[tuple[Callable, Any]] = []

    def submit(self, fn: Callable, value):
        """fn(actor, value) -> ObjectRef; queued if no actor is idle."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = (self._next_task_index, actor)
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._index_to_future) or bool(self._pending_submits)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._pending_submits

    def _return_actor(self, actor):
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    def get_next(self, timeout: float | None = None):
        """Next result in SUBMISSION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        # Skip indices already consumed by get_next_unordered (mixed usage).
        while (self._next_return_index not in self._index_to_future
               and self._next_return_index < self._next_task_index):
            self._next_return_index += 1
        idx = self._next_return_index
        if idx not in self._index_to_future:
            raise StopIteration("no pending results")
        ref = self._index_to_future[idx]
        from ray_tpu_torch.exceptions import GetTimeoutError

        try:
            out = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise  # task still running: bookkeeping stays intact
        except Exception:
            # Task COMPLETED with an error: the actor is free again.
            self._index_to_future.pop(idx, None)
            self._next_return_index += 1
            _i, actor = self._future_to_actor.pop(ref)
            self._return_actor(actor)
            raise
        self._index_to_future.pop(idx, None)
        self._next_return_index += 1
        _i, actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return out

    def get_next_unordered(self, timeout: float | None = None):
        """Next result in COMPLETION order."""
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        done, _ = ray_tpu_torch.wait(list(self._future_to_actor),
                               num_returns=1, timeout=timeout)
        if not done:
            raise TimeoutError("get_next_unordered timed out")
        ref = done[0]
        idx, actor = self._future_to_actor.pop(ref)
        self._index_to_future.pop(idx, None)
        if idx == self._next_return_index:
            self._next_return_index += 1
        self._return_actor(actor)
        return ray_tpu_torch.get(ref, timeout=timeout)

    def map(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable) -> Iterator:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def push(self, actor):
        self._return_actor(actor)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None
