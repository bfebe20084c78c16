"""The per-trial actor: hosts the user trainable.

Parity target: reference python/ray/tune/trainable/ — the controller talks
to one actor per live trial (tune_controller.py:666 step loop ->
_actor_to_trial futures). Function trainables run in a daemon thread and
communicate through the session queue; class trainables (reference
Trainable API: setup/step/save_checkpoint/load_checkpoint) are stepped by
the same loop so the controller sees one uniform next_result() interface.

Counterpart: ray_tpu/tune/_runner.py (copied).
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Optional

from ray_tpu_torch.tune import _session


class TrialRunner:
    """NOT decorated: the controller wraps it with ray_tpu_torch.remote(...) so
    per-trial resources can be attached."""

    def __init__(self, trainable, config: dict, trial_id: str, trial_dir: str,
                 restore_from: Optional[str] = None, incarnation: int = 0):
        from ray_tpu_torch import storage

        storage.makedirs(trial_dir)
        self.sess = _session.init_session(trial_id, trial_dir, restore_from,
                                          incarnation)
        self.trainable = trainable
        self.config = config
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        sess = self.sess
        try:
            if isinstance(self.trainable, type):
                self._run_class_trainable()
            else:
                out = self.trainable(self.config)
                if isinstance(out, dict):
                    sess.queue.put(("final", dict(out), None))
        except _session.StopTrial:
            pass
        except BaseException:  # noqa: BLE001 - report, don't kill the actor
            sess.queue.put(("error", traceback.format_exc(), None))
            return
        sess.queue.put(("done", None, None))

    def _run_class_trainable(self):
        """Reference Trainable class API: setup/step/save/load_checkpoint."""
        from ray_tpu_torch.train.checkpoint import Checkpoint

        sess = self.sess
        t = self.trainable()
        if hasattr(t, "setup"):
            t.setup(self.config)
        if sess.restore_from and hasattr(t, "load_checkpoint"):
            # Materialize through the storage plane when the checkpoint
            # lives on a non-local backend; local dirs pass through as-is.
            with Checkpoint(sess.restore_from).as_directory() as d:
                t.load_checkpoint(d)
        while not sess.stopped.is_set():
            result = t.step()
            ckpt = None
            if hasattr(t, "save_checkpoint"):
                import tempfile

                with tempfile.TemporaryDirectory() as d:
                    t.save_checkpoint(d)
                    if os.listdir(d):
                        ckpt = Checkpoint(d)
                        sess.report(result, checkpoint=ckpt)
                        continue
            sess.report(result)

    def next_result(self, timeout: float = 10.0):
        """Block up to `timeout` for the next event. Returns (kind, payload,
        checkpoint_path) or None on timeout. kinds: report|final|error|done."""
        import queue as _q

        try:
            return self.sess.queue.get(timeout=timeout)
        except _q.Empty:
            return None

    def stop(self):
        """Ask the trainable to unwind at its next report()."""
        self.sess.stopped.set()
        # Unblock a report() currently waiting for the queue slot.
        try:
            self.sess.queue.get_nowait()
        except Exception:
            pass
        return True
