"""Pubsub: subscribe to cluster event channels or publish app events.

Parity target: reference src/ray/pubsub/publisher.h:300 (GCS pubsub) +
python subscriber surface (ray._private.gcs_pubsub). Built-in channels the
controller publishes on: "actor" (lifecycle transitions), "node" (up/down),
"job" (terminal status). Any other channel name is application-defined —
`publish()` fans a payload out to every subscriber of that channel.

Counterpart: ray_tpu/util/pubsub.py (copied).
"""

from __future__ import annotations

import queue
from typing import Iterable, Optional

from ray_tpu_torch._private.worker import global_worker


def publish(channel: str, payload) -> None:
    """Fan `payload` (any picklable value) out to the channel's subscribers."""
    w = global_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() first")
    w.controller.push_threadsafe("publish", channel=channel, payload=payload)


class Subscriber:
    """Queue-backed subscription to one or more channels.

    Usage::

        sub = pubsub.subscribe(["actor", "my-channel"])
        ch, payload = sub.poll(timeout=5)   # None on timeout
        sub.close()
    """

    def __init__(self, channels: Iterable[str]):
        self._w = global_worker()
        if self._w is None:
            raise RuntimeError("ray_tpu_torch.init() first")
        self._channels = set(channels)
        self._q: "queue.Queue[tuple]" = queue.Queue()
        self._w.pubsub_listeners.append(self._on_event)
        self._w.io.run(self._w.controller.call(
            "subscribe", channels=sorted(self._channels)), timeout=30)

    def _on_event(self, channel: str, payload):
        if channel in self._channels:
            self._q.put((channel, payload))

    def poll(self, timeout: Optional[float] = None):
        """Next (channel, payload), or None on timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def __iter__(self):
        while True:
            item = self.poll()
            if item is not None:
                yield item

    def close(self):
        try:
            self._w.pubsub_listeners.remove(self._on_event)
        except ValueError:
            pass
        try:
            self._w.io.run(self._w.controller.call(
                "subscribe", channels=[], unsubscribe=sorted(self._channels)),
                timeout=10)
        except Exception:
            pass


def subscribe(channels) -> Subscriber:
    if isinstance(channels, str):
        channels = [channels]
    return Subscriber(channels)
