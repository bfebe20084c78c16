"""The runtime flags the port reads, each overridable by its environment
variable `RT_<NAME>` (the same names as the reference's registry).

Counterpart: ray_tpu/_private/rtconfig.py, of which only the flags below
are copied.
"""

from __future__ import annotations

import os

_DEFAULTS = {
    # Continuous-engine prefill lane: admissions (prefill + first-token
    # sample) run on their own thread and splice into the running batch at
    # chunk boundaries. False restores inline admission in the scheduler.
    "llm_prefill_lane": True,
}


class _Config:
    """Attribute access to the flags: `RT_<NAME>` when set, else the
    default. Booleans read "1", "true" and "yes" as true."""

    def __getattr__(self, name: str):
        if name not in _DEFAULTS:
            raise AttributeError(f"Unknown config flag {name}")
        default = _DEFAULTS[name]
        env = os.environ.get(f"RT_{name.upper()}")
        if env is None:
            return default
        if isinstance(default, bool):
            return env.lower() in ("1", "true", "yes")
        return type(default)(env)


CONFIG = _Config()
