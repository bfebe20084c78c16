"""Exceptions of the port.

Counterpart: ray_tpu/exceptions.py, of which only what the serving slice
raises is copied.
"""


class RayTpuError(Exception):
    """Base class of the port's errors."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """A wait for a result timed out; the message names what was awaited."""
