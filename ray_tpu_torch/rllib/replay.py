"""Prioritized experience replay, sharded across buffer actors.

Parity target: reference rllib/utils/replay_buffers/prioritized_episode_
buffer.py (proportional prioritization, IS weights) hosted the way the
reference hosts buffers for distributed DQN — as actors the runners push
to and the learner samples from (sharding = one buffer actor per shard,
reference utils/actor_manager round-robin).

Counterpart: ray_tpu/rllib/replay.py (copied).
"""

from __future__ import annotations

import numpy as np

import ray_tpu_torch


class PrioritizedReplayBuffer:
    """Proportional prioritized replay (Schaul et al. 2015): P(i) ~ p_i^a,
    importance weights w_i = (N * P(i))^-beta / max w. Circular numpy
    storage; O(n) sampling via cumulative sums (fine at 1e5 scale on the
    CPU hosts that run buffer actors)."""

    def __init__(self, capacity: int = 100_000, alpha: float = 0.6):
        self.capacity = capacity
        self.alpha = alpha
        self._storage: dict[str, np.ndarray] = {}
        self._priorities = np.zeros(capacity, np.float64)
        self._next = 0
        self._size = 0
        self._max_priority = 1.0

    def __len__(self):
        return self._size

    def add_batch(self, batch: dict):
        """batch: dict of [B, ...] arrays (obs/actions/rewards/next_obs/
        dones). New transitions get max priority so everything is seen at
        least once."""
        n = len(next(iter(batch.values())))
        if not self._storage:
            for k, v in batch.items():
                v = np.asarray(v)
                self._storage[k] = np.zeros((self.capacity,) + v.shape[1:],
                                            v.dtype)
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._storage[k][idx] = np.asarray(v)
        self._priorities[idx] = self._max_priority
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        return self._size

    def sample(self, batch_size: int, beta: float = 0.4,
               normalize: bool = True):
        """-> (batch dict, indices, is_weights). Empty dict if not enough
        data yet. normalize=False returns RAW (N*P)^-beta weights so a
        sharded group can normalize by the GLOBAL max instead (per-shard
        maxima would systematically over-weight low-priority shards)."""
        if self._size == 0:
            return {}, np.zeros(0, np.int64), np.zeros(0, np.float32)
        pri = self._priorities[:self._size] ** self.alpha
        probs = pri / pri.sum()
        idx = np.random.choice(self._size, size=batch_size, p=probs)
        weights = ((self._size * probs[idx]) ** (-beta)).astype(np.float32)
        if normalize:
            weights = weights / weights.max()
        batch = {k: v[idx] for k, v in self._storage.items()}
        return batch, idx.astype(np.int64), weights

    def update_priorities(self, indices, priorities):
        priorities = np.abs(np.asarray(priorities, np.float64)) + 1e-6
        self._priorities[np.asarray(indices, np.int64)] = priorities
        self._max_priority = max(self._max_priority,
                                 float(priorities.max(initial=0.0)))

    def stats(self) -> dict:
        return {"size": self._size, "max_priority": self._max_priority}


class ReplayBufferGroup:
    """Sharded buffer fleet: runners push round-robin, the learner samples
    proportionally from every shard and merges (reference: multiple
    replay-shard actors behind the DQN algorithm)."""

    def __init__(self, num_shards: int = 1, capacity: int = 100_000,
                 alpha: float = 0.6):
        actor_cls = ray_tpu_torch.remote(num_cpus=0)(PrioritizedReplayBuffer)
        per = max(1, capacity // num_shards)
        self.shards = [actor_cls.remote(per, alpha)
                       for _ in range(num_shards)]
        self._rr = 0

    def add_batch(self, batch: dict):
        shard = self.shards[self._rr % len(self.shards)]
        self._rr += 1
        return shard.add_batch.remote(batch)

    def sample(self, batch_size: int, beta: float):
        """-> (merged batch, [(shard_i, indices)], weights)."""
        per = max(1, batch_size // len(self.shards))
        reps = ray_tpu_torch.get(
            [s.sample.remote(per, beta, False) for s in self.shards],
            timeout=120)
        batches, index_map, weights = [], [], []
        for i, (b, idx, w) in enumerate(reps):
            if len(idx) == 0:
                continue
            batches.append(b)
            index_map.append((i, idx))
            weights.append(w)
        if not batches:
            return {}, [], np.zeros(0, np.float32)
        merged = {k: np.concatenate([b[k] for b in batches])
                  for k in batches[0]}
        w = np.concatenate(weights)
        return merged, index_map, (w / w.max()).astype(np.float32)

    def update_priorities(self, index_map, td_errors: np.ndarray):
        off = 0
        refs = []
        for shard_i, idx in index_map:
            n = len(idx)
            refs.append(self.shards[shard_i].update_priorities.remote(
                idx, td_errors[off:off + n]))
            off += n
        ray_tpu_torch.get(refs, timeout=60)

    def size(self) -> int:
        reps = ray_tpu_torch.get([s.stats.remote() for s in self.shards],
                                 timeout=60)
        return sum(r["size"] for r in reps)

    def stop(self):
        for s in self.shards:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass
