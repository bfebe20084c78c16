"""Trial bookkeeping.

Parity target: reference python/ray/tune/experiment/trial.py (Trial status
machine PENDING/RUNNING/PAUSED/TERMINATED/ERROR).

Counterpart: ray_tpu/tune/trial.py (copied).
"""

from __future__ import annotations

import uuid
from typing import Any, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, config: dict, trial_dir: str):
        self.trial_id = uuid.uuid4().hex[:8]
        self.config = config
        self.trial_dir = trial_dir
        self.status = PENDING
        self.runner = None  # actor handle while RUNNING
        self.last_result: Optional[dict] = None
        self.results: list[dict] = []
        self.checkpoint_path: Optional[str] = None
        self.restore_from: Optional[str] = None  # set by PBT exploit
        #: checkpoint dir this trial pinned as its restore source (PBT
        #: clone-from-donor / error restart); released by the controller
        #: once the trial checkpoints for itself or stops.
        self.pinned_source: Optional[str] = None
        #: how many times this trial has been started (error restarts, PBT
        #: exploits); namespaces checkpoint dirs so a restart never
        #: overwrites an earlier incarnation's (possibly pinned) checkpoint.
        self.incarnation = 0
        self.error: Optional[str] = None
        self.iteration = 0
        # scheduler scratch (e.g. ASHA rungs this trial has been recorded at)
        self.sched_state: dict[str, Any] = {}

    def metric(self, name: str, default=None):
        if self.last_result is None:
            return default
        return self.last_result.get(name, default)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iteration})"
