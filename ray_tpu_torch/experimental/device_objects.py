"""Device objects (experimental): actor-resident `torch.Tensor` ObjectRefs.

Parity target: the reference runtime's direct-transport design for GPU
objects (`ray.experimental` GPU objects / compiled-graph direct transports):
device-resident values stay behind ObjectRefs in the producing actor and
move peer-to-peer, instead of round-tripping host -> object store -> host.
See `ray_tpu_torch._private.device_store` for the mechanism and README "Device
objects" for the tiering / ownership / fallback rules.

With the plane enabled (default; `RT_DEVICE_OBJECTS=0` disables), any
contiguous `torch.Tensor` at or above `RT_DEVICE_OBJECT_MIN_BYTES` returned
from a task/actor or passed to `ray_tpu_torch.put()` rides it automatically —
there is nothing to call. This module is the introspection surface.

Counterpart: ray_tpu/experimental/device_objects.py.
"""

from __future__ import annotations

from ray_tpu_torch._private import device_store
from ray_tpu_torch._private.rtconfig import CONFIG


def is_enabled() -> bool:
    """Whether the device object plane is on in this process
    (`RT_DEVICE_OBJECTS` / `_system_config={"device_objects": ...}`)."""
    return bool(CONFIG.device_objects)


def device_object_stats() -> dict:
    """This process's DeviceObjectTable residency: `{"count", "bytes"}` of
    arrays currently pinned by objects this process produced. The
    cluster-wide view is the `rt_device_objects_{count,bytes}` gauges
    (`ray_tpu_torch.util.state.metrics()`) and the `plane` column of
    `ray_tpu_torch.util.state.list_objects()`."""
    return device_store.table_stats()


def would_ride_device_plane(value) -> bool:
    """Whether `value` would be pinned device-side if returned from a task
    or actor right now (type/size/layout gates included)."""
    return device_store.eligible(value)
