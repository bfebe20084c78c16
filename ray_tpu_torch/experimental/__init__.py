"""Experimental surfaces (reference ray.experimental): compiled-graph
channels (`channel`) and the device object plane (`device_objects`).

Counterpart: ray_tpu/experimental/__init__.py."""

from ray_tpu_torch.experimental import device_objects  # noqa: F401
