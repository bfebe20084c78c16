"""In-trial session: the bridge between user training code and the Tune
controller.

Parity target: reference python/ray/tune/trainable/function_trainable.py
(_StatusReporter / session.report) — the function trainable runs in its own
thread and hands results to the controller through a queue; report() blocks
until the controller-side consumer has taken the result, keeping iteration
cadence aligned with scheduler decisions.

Counterpart: ray_tpu/tune/_session.py (copied).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ray_tpu_torch import storage
from ray_tpu_torch.train import checkpoint as ckpt_mod
from ray_tpu_torch.train.checkpoint import Checkpoint

_session: Optional["_TuneSession"] = None
_lock = threading.Lock()


class StopTrial(BaseException):
    """Raised inside the trainable's thread to unwind when the controller
    stops the trial (BaseException so user `except Exception` can't eat it)."""


class _TuneSession:
    def __init__(self, trial_id: str, trial_dir: str,
                 restore_from: Optional[str], incarnation: int = 0):
        self.trial_id = trial_id
        self.trial_dir = trial_dir
        self.restore_from = restore_from
        # Which start of this trial we are (error restarts, PBT exploits):
        # checkpoint dirs are namespaced by it so a restarted trial can
        # never OVERWRITE an earlier incarnation's checkpoint — which a
        # PBT clone may have pinned as its restore source (pins prevent
        # deletion; unique names prevent overwrite).
        self.incarnation = incarnation
        self.queue: "queue.Queue" = queue.Queue(maxsize=1)
        self.stopped = threading.Event()
        self.iteration = 0
        self._ckpt_seq = 0

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        if self.stopped.is_set():
            raise StopTrial()
        self.iteration += 1
        ckpt_path = None
        if checkpoint is not None:
            self._ckpt_seq += 1
            ckpt_path = storage.join(
                self.trial_dir,
                f"checkpoint_i{self.incarnation}_{self._ckpt_seq:06d}")
            if checkpoint.path != ckpt_path:
                # Through the storage seam: manifest-committed upload
                # (sync — tune cadence is controller-paced), then
                # keep-last-K retention. Pinned checkpoints (a PBT
                # clone's restore donor) survive retention.
                with checkpoint.as_directory() as src:
                    ckpt_mod.upload_directory(src, ckpt_path,
                                              step=self._ckpt_seq)
                from ray_tpu_torch._private.rtconfig import CONFIG

                if CONFIG.ckpt_keep:
                    ckpt_mod.retention(self.trial_dir, CONFIG.ckpt_keep)
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", self.iteration)
        self.queue.put(("report", metrics, ckpt_path))

    def get_checkpoint(self) -> Optional[Checkpoint]:
        if self.restore_from:
            return Checkpoint(self.restore_from)
        return None


def init_session(trial_id: str, trial_dir: str, restore_from: Optional[str],
                 incarnation: int = 0) -> _TuneSession:
    global _session
    with _lock:
        _session = _TuneSession(trial_id, trial_dir, restore_from,
                                incarnation)
        return _session


def get_session() -> _TuneSession:
    if _session is None:
        raise RuntimeError(
            "ray_tpu_torch.tune.report()/get_checkpoint() must be called from "
            "inside a trial launched by Tuner.fit()")
    return _session


def report(metrics: dict, *, checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()
