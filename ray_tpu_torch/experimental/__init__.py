"""Experimental surfaces (reference ray.experimental): the device object
plane (`device_objects`).

Counterpart: ray_tpu/experimental/__init__.py, without the compiled-graph
channels, which come with the compiled DAG."""

from ray_tpu_torch.experimental import device_objects  # noqa: F401
