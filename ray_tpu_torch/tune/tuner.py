"""Tuner + the trial event-loop controller.

Parity target: reference python/ray/tune/tuner.py:43 (Tuner, fit:312),
tune/execution/tune_controller.py:68 (TuneController; step loop :666 —
start trials, collect actor futures, route results to scheduler/searcher,
stop/perturb/restart), tune/result_grid.py (ResultGrid).

Execution model: one actor per live trial hosting the trainable
(ray_tpu_torch/tune/_runner.py); the controller's loop multiplexes
`next_result()` futures over ray_tpu_torch.wait — the same shape as the
reference's _actor_to_trial future bookkeeping, minus the placement-group
indirection (trial resources ride the actor's own resource request).

Counterpart: ray_tpu/tune/tuner.py (copied; a `TorchTrainer` passed as the
trainable runs as a trial, where the reference takes a `JaxTrainer`).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch import storage
from ray_tpu_torch.train import TorchTrainer, RunConfig
from ray_tpu_torch.train import checkpoint as ckpt_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune._runner import TrialRunner
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trial import ERROR, PENDING, RUNNING, TERMINATED, Trial

logger = logging.getLogger(__name__)


@dataclass
class TuneConfig:
    """reference tune/tune_config.py."""

    metric: Optional[str] = None
    mode: Optional[str] = None  # "min" | "max"
    num_samples: int = 1
    scheduler: Optional[Any] = None
    #: a search.Searcher (e.g. TPESearcher): trials are then SUGGESTED
    #: sequentially from completed results instead of pre-sampled
    search_alg: Optional[Any] = None
    max_concurrent_trials: Optional[int] = None
    seed: Optional[int] = None
    resources_per_trial: Optional[dict] = None


@dataclass
class Result:
    """reference air/result.py Result."""

    metrics: Optional[dict]
    config: dict
    checkpoint: Optional[Checkpoint]
    error: Optional[str]
    path: str
    trial_id: str

    @property
    def best_checkpoint(self):
        return self.checkpoint


class ResultGrid:
    """reference tune/result_grid.py."""

    def __init__(self, results: list[Result], metric: Optional[str],
                 mode: Optional[str]):
        self._results = results
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def num_errors(self) -> int:
        return sum(1 for r in self._results if r.error is not None)

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode or "max"
        if metric is None:
            raise ValueError("pass metric= (or set TuneConfig.metric)")
        ok = [r for r in self._results
              if r.metrics is not None and metric in r.metrics]
        if not ok:
            raise RuntimeError("no trial reported metric " + metric)
        return (max if mode == "max" else min)(
            ok, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = dict(r.metrics or {})
            row["trial_id"] = r.trial_id
            for k, v in r.config.items():
                row[f"config/{k}"] = v
            rows.append(row)
        return pd.DataFrame(rows)


class TuneController:
    """Event loop over trial actors (reference tune_controller.py:68)."""

    WAIT_S = 3.0
    RESULT_TIMEOUT_S = 2.0

    def __init__(self, trainable: Callable, configs: list[dict],
                 tune_config: TuneConfig, run_config: RunConfig,
                 exp_dir: str, param_space: Optional[dict] = None,
                 trials: Optional[list] = None,
                 searcher_pre_observed: bool = False):
        self.trainable = trainable
        self.tc = tune_config
        self.rc = run_config
        self.exp_dir = exp_dir
        self.param_space = param_space or {}
        self.searcher = tune_config.search_alg
        if trials is not None:
            self.trials = trials  # Tuner.restore passes rebuilt trials
        else:
            self.trials = [Trial(cfg, "") for cfg in configs]
        for t in self.trials:
            t.trial_dir = storage.join(exp_dir, f"trial_{t.trial_id}")
        if self.searcher is not None:
            self.searcher.set_search_properties(
                tune_config.metric, tune_config.mode, self.param_space)
            # Feed restored finished trials back into the model — but ONLY
            # when the searcher did not arrive via the pickled tune_config
            # (Tuner.restore): that searcher's internal state already
            # contains these observations, and replaying them would
            # double-count each result and skew e.g. the TPE quantile
            # split. The replay exists for callers who wire a FRESH
            # searcher to restored trials.
            if not searcher_pre_observed:
                for t in self.trials:
                    if t.status == TERMINATED and t.last_result:
                        self.searcher.observe(t.config, t.last_result)
        self.scheduler = tune_config.scheduler or sched_mod.FIFOScheduler()
        self.scheduler.setup(tune_config.metric, tune_config.mode)
        self._futures: dict = {}  # next_result future -> (trial, runner)
        self._restarts: dict[str, int] = {}  # trial_id -> failure count

    # ----------------------------------------------------------- lifecycle
    def _remote_runner(self):
        res = dict(self.tc.resources_per_trial or {"CPU": 1})
        num_cpus = res.pop("CPU", 1)
        return ray_tpu_torch.remote(num_cpus=num_cpus, resources=res or None,
                              max_concurrency=2)(TrialRunner)

    def _start(self, trial: Trial):
        runner_cls = self._remote_runner()
        trial.incarnation += 1
        trial.runner = runner_cls.remote(
            self.trainable, trial.config, trial.trial_id, trial.trial_dir,
            trial.restore_from, trial.incarnation - 1)
        trial.runner.start.remote()
        trial.status = RUNNING
        self._ask(trial)

    def _ask(self, trial: Trial):
        fut = trial.runner.next_result.remote(self.RESULT_TIMEOUT_S)
        self._futures[fut] = (trial, trial.runner)

    def _kill(self, trial: Trial):
        runner, trial.runner = trial.runner, None
        if runner is not None:
            try:
                runner.stop.remote()
                ray_tpu_torch.kill(runner)
            except Exception:
                pass

    def _stop_trial(self, trial: Trial, status: str = TERMINATED,
                    error: Optional[str] = None):
        trial.status = status
        trial.error = error
        self._kill(trial)
        self._release_restore_pin(trial)
        self.scheduler.on_trial_complete(self, trial)
        if self.searcher is not None:
            self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
        try:
            self.save_experiment_state()
        except Exception:
            logger.exception("tune: experiment-state save failed")

    # --------------------------------------------------- checkpoint pinning
    # A trial restoring from a checkpoint it does not own (PBT exploit
    # clones from a donor; error-restarts re-read the trial's own last
    # dir) must keep that dir alive: the donor's retention/GC or a later
    # overwrite would otherwise corrupt the clone's restore source. Pins
    # are refcount marker files on the storage backend — visible to the
    # donor's session process — released once the trial has written a
    # checkpoint of its own (or stopped).
    def _pin_restore_source(self, trial: Trial, path: Optional[str]):
        self._release_restore_pin(trial)
        trial.restore_from = path
        if path:
            try:
                ckpt_mod.pin(path, owner=f"trial-{trial.trial_id}")
                trial.pinned_source = path
            except Exception:
                logger.exception("tune: pinning %s failed", path)

    def _release_restore_pin(self, trial: Trial):
        if trial.pinned_source:
            ckpt_mod.unpin(trial.pinned_source,
                           owner=f"trial-{trial.trial_id}")
            trial.pinned_source = None

    def exploit(self, trial: Trial, donor: Trial, new_config: dict):
        """PBT: restart `trial` from donor's checkpoint with a perturbed
        config (reference pbt.py _exploit:405)."""
        logger.info("tune: trial %s exploits %s", trial.trial_id, donor.trial_id)
        self._kill(trial)
        trial.config = new_config
        self._pin_restore_source(trial, donor.checkpoint_path)
        self._start(trial)

    # ----------------------------------------------------- experiment state
    def save_experiment_state(self):
        """Durable trial table (reference experiment_state-*.json written by
        the TuneController): enough to Tuner.restore() an interrupted
        experiment — finished trials keep results, unfinished ones re-run
        from their last checkpoint."""
        import cloudpickle

        state = {
            "num_samples": self.tc.num_samples,
            "metric": self.tc.metric,
            "mode": self.tc.mode,
            # Full configs ride pickled so restore keeps the searcher,
            # scheduler, concurrency cap, and failure policy.
            "tune_config": cloudpickle.dumps(self.tc).hex(),
            "run_config": cloudpickle.dumps(self.rc).hex(),
            "param_space": cloudpickle.dumps(self.param_space).hex(),
            "trainable": cloudpickle.dumps(self.trainable).hex(),
            "trials": [{
                "trial_id": t.trial_id,
                "config": cloudpickle.dumps(t.config).hex(),
                "status": t.status,
                "last_result": t.last_result,
                "checkpoint_path": t.checkpoint_path,
                "error": t.error,
                "iteration": t.iteration,
            } for t in self.trials],
        }
        import json

        def _default(o):
            # User metrics are full of numpy scalars on this stack; a
            # TypeError here would silently freeze the durable state.
            try:
                return float(o)
            except (TypeError, ValueError):
                return repr(o)

        # storage.put is atomic on every backend — the experiment state
        # file is either the old or the new version, never torn.
        storage.put(storage.join(self.exp_dir, "experiment_state.json"),
                    json.dumps(state, default=_default).encode())

    def _maybe_suggest(self) -> Optional[Trial]:
        """Searcher-driven trial creation (sequential; reference
        SearchGenerator)."""
        if self.searcher is None or len(self.trials) >= self.tc.num_samples:
            return None
        t = Trial({}, "")
        cfg = self.searcher.suggest(t.trial_id)
        if cfg is None:
            return None
        t.config = cfg
        t.trial_dir = storage.join(self.exp_dir, f"trial_{t.trial_id}")
        self.trials.append(t)
        return t

    # ---------------------------------------------------------- event loop
    def run(self) -> list[Trial]:
        # Restored TERMINATED/errored-out trials are not re-queued.
        pending = deque(t for t in self.trials if t.status == PENDING)
        if self.tc.max_concurrent_trials:
            limit = self.tc.max_concurrent_trials
        elif self.searcher is not None:
            # Searcher-driven runs MUST stay bounded or every sample is
            # suggested before any result lands and the model never sees
            # an observation (TPE degenerates to pure random). Default to
            # the searcher's startup width.
            limit = max(1, getattr(self.searcher, "n_startup", 4) or 4)
        else:
            limit = max(1, len(self.trials))
        while True:
            running = [t for t in self.trials if t.status == RUNNING]
            while pending and len(running) < limit:
                t = pending.popleft()
                self._start(t)
                running.append(t)
            while self.searcher is not None and len(running) < limit:
                t = self._maybe_suggest()
                if t is None:
                    break
                self._start(t)
                running.append(t)
            if not running and not pending:
                break
            if not self._futures:
                time.sleep(0.05)
                continue
            done, _ = ray_tpu_torch.wait(list(self._futures), num_returns=1,
                                   timeout=self.WAIT_S)
            for fut in done:
                trial, runner = self._futures.pop(fut)
                if trial.runner is not runner:
                    continue  # stale future from a pre-exploit incarnation
                try:
                    event = ray_tpu_torch.get(fut, timeout=5)
                except Exception as e:  # actor died (or was killed)
                    if trial.status == RUNNING:
                        self._on_trial_error(trial, repr(e))
                    continue
                self._on_event(trial, event)
        return self.trials

    def _on_event(self, trial: Trial, event):
        if event is None:  # poll timeout: keep listening
            self._ask(trial)
            return
        kind, payload, ckpt_path = event
        if kind in ("report", "final"):
            metrics = dict(payload)
            trial.last_result = metrics
            trial.results.append(metrics)
            trial.iteration = metrics.get("training_iteration", trial.iteration)
            if ckpt_path:
                trial.checkpoint_path = ckpt_path
                # The trial now owns a durable checkpoint of its own: the
                # borrowed restore source (if any) can be collected.
                self._release_restore_pin(trial)
            if kind == "final":
                self._stop_trial(trial)
                return
            if self._hit_stop_criteria(metrics):
                self._stop_trial(trial)
                return
            runner_before = trial.runner
            decision = self.scheduler.on_trial_result(self, trial, metrics)
            if trial.runner is not runner_before:
                # Scheduler restarted the trial (PBT exploit): _start
                # already enqueued the new incarnation's poller — asking
                # again would double-poll and reorder reports.
                return
            if decision == sched_mod.STOP:
                self._stop_trial(trial)
            else:
                self._ask(trial)
        elif kind == "done":
            if trial.status == RUNNING:
                self._stop_trial(trial)
        elif kind == "error":
            self._on_trial_error(trial, payload)

    def _on_trial_error(self, trial: Trial, err: str):
        n = self._restarts.get(trial.trial_id, 0)
        maxf = self.rc.failure_config.max_failures
        if maxf == -1 or n < maxf:
            self._restarts[trial.trial_id] = n + 1
            logger.warning("tune: trial %s failed (%d/%s), restarting",
                           trial.trial_id, n + 1, maxf)
            self._kill(trial)
            self._pin_restore_source(trial, trial.checkpoint_path)
            self._start(trial)
        else:
            logger.error("tune: trial %s failed:\n%s", trial.trial_id, err)
            self._stop_trial(trial, status=ERROR, error=err)

    def _hit_stop_criteria(self, metrics: dict) -> bool:
        stop = getattr(self.rc, "stop", None)
        if not stop:
            return False
        return any(metrics.get(k) is not None and metrics[k] >= v
                   for k, v in stop.items())


def _trainable_from_trainer(trainer: TorchTrainer) -> Callable:
    """Run a TorchTrainer as a trial (reference base_trainer.py:651 wraps
    every Trainer into a Tune trial; param_space["train_loop_config"]
    overrides merge into the trainer's config)."""

    def _fit_trial(config):
        import dataclasses

        from ray_tpu_torch.tune import _session

        cfg = dict(trainer._config or {})
        cfg.update(config.get("train_loop_config", config))
        sess = _session.get_session()
        run_cfg = dataclasses.replace(
            trainer._run_config, storage_path=os.path.join(
                sess.trial_dir, "train"), name=None)
        t = TorchTrainer(trainer._train_fn, train_loop_config=cfg,
                       scaling_config=trainer._scaling,
                       run_config=run_cfg, datasets=trainer._datasets)
        res = t.fit()
        sess.report(dict(res.metrics or {}),
                    checkpoint=res.checkpoint)

    return _fit_trial


class Tuner:
    """reference tune/tuner.py:43."""

    def __init__(self, trainable, *, param_space: Optional[dict] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 _restored_trials: Optional[list] = None,
                 _exp_dir: Optional[str] = None):
        if isinstance(trainable, TorchTrainer):
            trainable = _trainable_from_trainer(trainable)
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._restored_trials = _restored_trials
        self._exp_dir = _exp_dir
        # True when restore() unpickled the tune_config: its searcher's
        # state already includes every finished trial's observation.
        self._searcher_from_pickle = False

    @classmethod
    def restore(cls, path: str, trainable=None) -> "Tuner":
        """Resume an interrupted experiment from its directory (reference
        tuner.py Tuner.restore): finished trials keep their results;
        unfinished/errored trials re-run from their last checkpoint."""
        import json

        import cloudpickle

        state = json.loads(storage.get_bytes(
            storage.join(path, "experiment_state.json")))
        if trainable is None:
            trainable = cloudpickle.loads(
                bytes.fromhex(state["trainable"]))
        elif isinstance(trainable, TorchTrainer):
            trainable = _trainable_from_trainer(trainable)
        param_space = cloudpickle.loads(bytes.fromhex(state["param_space"]))
        trials = []
        for ts in state["trials"]:
            t = Trial(cloudpickle.loads(bytes.fromhex(ts["config"])), "")
            t.trial_id = ts["trial_id"]
            t.last_result = ts["last_result"]
            t.checkpoint_path = ts["checkpoint_path"]
            t.iteration = ts.get("iteration", 0)
            if ts["status"] == TERMINATED:
                t.status = TERMINATED  # keep the result; don't re-run
            else:
                # RUNNING (interrupted) / PENDING / ERROR: re-run, resuming
                # from the last checkpoint when one exists.
                t.status = PENDING
                t.restore_from = ts["checkpoint_path"]
            trials.append(t)
        if state.get("tune_config"):
            tc = cloudpickle.loads(bytes.fromhex(state["tune_config"]))
        else:
            tc = TuneConfig(metric=state.get("metric"),
                            mode=state.get("mode"),
                            num_samples=state.get("num_samples", len(trials)))
        rc = (cloudpickle.loads(bytes.fromhex(state["run_config"]))
              if state.get("run_config") else RunConfig())
        tuner = cls(trainable, param_space=param_space, tune_config=tc,
                    run_config=rc, _restored_trials=trials,
                    _exp_dir=path)
        tuner._searcher_from_pickle = bool(state.get("tune_config"))
        return tuner

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        if self._exp_dir is not None:
            exp_dir = self._exp_dir
        else:
            name = self._run_config.name or f"tune_{int(time.time())}"
            exp_dir = storage.join(self._run_config.resolved_storage(), name)
        storage.makedirs(exp_dir)
        if self._restored_trials is not None:
            configs = []
        elif tc.search_alg is not None:
            configs = []  # suggested live by the searcher
        else:
            configs = BasicVariantGenerator(tc.seed).generate(
                self._param_space, tc.num_samples)
        controller = TuneController(self._trainable, configs, tc,
                                    self._run_config, exp_dir,
                                    param_space=self._param_space,
                                    trials=self._restored_trials,
                                    searcher_pre_observed=self._searcher_from_pickle)
        controller.save_experiment_state()
        trials = controller.run()
        results = [
            Result(metrics=t.last_result, config=t.config,
                   checkpoint=Checkpoint(t.checkpoint_path)
                   if t.checkpoint_path else None,
                   error=t.error, path=t.trial_dir, trial_id=t.trial_id)
            for t in trials
        ]
        return ResultGrid(results, tc.metric, tc.mode)
