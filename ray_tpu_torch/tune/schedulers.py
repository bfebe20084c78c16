"""Trial schedulers: FIFO, ASHA, PBT.

Parity target: reference python/ray/tune/schedulers/trial_scheduler.py
(CONTINUE/STOP decisions), async_hyperband.py (AsyncHyperBandScheduler /
ASHA — rungs at grace_period * rf^k, cutoff at the top 1/rf quantile), and
pbt.py (PopulationBasedTraining — exploit top quantile + explore by
perturbing hyperparams, pbt.py:405 _exploit).

Counterpart: ray_tpu/tune/schedulers.py (copied).
"""

from __future__ import annotations

import random
from typing import Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    """Run every trial to completion (reference trial_scheduler.py:94)."""

    metric: Optional[str] = None
    mode: Optional[str] = None

    def setup(self, metric: Optional[str], mode: Optional[str]):
        """Adopt the TuneConfig metric/mode unless the scheduler was built
        with its own (shared by every metric-driven scheduler below)."""
        self.metric = getattr(self, "metric", None) or metric
        self.mode = getattr(self, "mode", None) or mode or "max"

    def _score(self, result) -> Optional[float]:
        """Result's metric in +is-better units (None if absent)."""
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result) -> str:
        return CONTINUE

    def on_trial_complete(self, controller, trial):
        pass


class ASHAScheduler(FIFOScheduler):
    """Async successive halving (reference async_hyperband.py:343 _Bracket:
    on_result records the metric at the highest rung <= t and stops the
    trial if it falls below the rung's top-1/rf cutoff)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.max_t = max_t
        if reduction_factor <= 1:
            raise ValueError("reduction_factor must be > 1")
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung milestones, ascending: grace, grace*rf, grace*rf^2, ... < max_t
        self.rungs: list[float] = []
        r = grace_period
        while r < max_t:
            self.rungs.append(r)
            r *= reduction_factor
        # rung value -> list of recorded metric values (in +is-better units)
        self._recorded: dict[float, list[float]] = {r: [] for r in self.rungs}


    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        score = self._score(result)
        if score is None:
            return CONTINUE
        decision = CONTINUE
        seen = trial.sched_state.setdefault("asha_rungs", set())
        for rung in self.rungs:
            if t < rung or rung in seen:
                continue
            seen.add(rung)
            recorded = self._recorded[rung]
            recorded.append(score)
            # Cutoff: top 1/rf of everything recorded at this rung so far.
            if len(recorded) >= self.rf:
                k = max(1, int(len(recorded) / self.rf))
                cutoff = sorted(recorded, reverse=True)[k - 1]
                if score < cutoff:
                    decision = STOP
        return decision


class PopulationBasedTraining(FIFOScheduler):
    """PBT: at each perturbation_interval, bottom-quantile trials clone the
    config+checkpoint of a top-quantile trial and perturb hyperparams
    (reference pbt.py _exploit:405 / _explore:88)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[dict] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self._rng = random.Random(seed)

    def setup(self, metric, mode):
        self.metric = self.metric or metric
        self.mode = self.mode or mode or "max"

    def _score(self, trial) -> Optional[float]:
        v = trial.metric(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def _explore(self, config: dict) -> dict:
        """Perturb mutated hyperparams *1.2/*0.8 or resample (reference
        pbt.py _explore:88)."""
        from ray_tpu_torch.tune.search import Domain

        out = dict(config)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob:
                if isinstance(spec, Domain):
                    out[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    out[key] = self._rng.choice(spec)
                elif callable(spec):
                    out[key] = spec()
            elif isinstance(out.get(key), (int, float)):
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                out[key] = type(out[key])(out[key] * factor)
            elif isinstance(spec, list) and out.get(key) in spec:
                # shift to a neighboring value
                i = spec.index(out[key])
                out[key] = spec[max(0, min(len(spec) - 1,
                                           i + self._rng.choice((-1, 1))))]
        return out

    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        last = trial.sched_state.get("pbt_last_perturb", 0)
        if t - last < self.interval:
            return CONTINUE
        trial.sched_state["pbt_last_perturb"] = t
        peers = [tr for tr in controller.trials
                 if self._score(tr) is not None]
        if len(peers) < 2:
            return CONTINUE
        ranked = sorted(peers, key=self._score, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:k], ranked[-k:]
        if trial not in bottom or trial in top:
            return CONTINUE
        donor = self._rng.choice(top)
        if donor.checkpoint_path is None:
            return CONTINUE
        new_config = self._explore(donor.config)
        controller.exploit(trial, donor, new_config)
        return CONTINUE  # controller restarts the trial; no stop decision

    def on_trial_complete(self, controller, trial):
        pass


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose best result so far is worse than the median of the
    running averages of other trials at the same step (reference
    tune/schedulers/median_stopping_rule.py: MedianStoppingRule)."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 grace_period: int = 1, min_samples_required: int = 3):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        self.grace_period = grace_period
        self.min_samples_required = min_samples_required
        # trial id -> list of scores (in +is-better units)
        self._scores: dict = {}


    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        score = self._score(result)
        if score is None:
            return CONTINUE
        self._scores.setdefault(trial.trial_id, []).append(score)
        if t < self.grace_period:
            return CONTINUE
        # Compare against other trials' running averages truncated to the
        # same REPORT COUNT as this trial — all-time averages would judge
        # late starters against finished trials' full runs, and slicing by
        # the raw time_attr value breaks for non-unit attrs like
        # timesteps_total (reference: median of running averages at the
        # same time step).
        upto = len(self._scores[trial.trial_id])
        others = [vals[:upto] for tid, vals in self._scores.items()
                  if tid != trial.trial_id and vals]
        if len(others) < self.min_samples_required:
            return CONTINUE
        medians = sorted(sum(vals) / len(vals) for vals in others)
        median = medians[len(medians) // 2]
        best = max(self._scores[trial.trial_id])
        return STOP if best < median else CONTINUE


class HyperBandScheduler(FIFOScheduler):
    """Synchronous HyperBand-style banding (reference
    tune/schedulers/hyperband.py, simplified to a single bracket):
    successive halving at milestones max_t/rf^k — at each milestone the
    bottom (1 - 1/rf) fraction of trials that reported there stop."""

    def __init__(self, time_attr: str = "training_iteration",
                 metric: Optional[str] = None, mode: Optional[str] = None,
                 max_t: int = 81, reduction_factor: float = 3):
        self.time_attr = time_attr
        self.metric, self.mode = metric, mode
        if reduction_factor <= 1:
            raise ValueError("reduction_factor must be > 1")
        self.max_t = max_t
        self.rf = reduction_factor
        milestones = []
        t = max_t
        while t >= 1:
            milestones.append(int(t))
            t /= reduction_factor
        self.milestones = sorted(set(milestones))[:-1]  # drop max_t itself
        self._recorded: dict[int, list[float]] = {m: [] for m in self.milestones}
        # milestone -> {trial_id: score}: cutoffs are re-evaluated on every
        # later report, so a bad trial that crossed a milestone before its
        # peers recorded there still gets halved once they do.
        self._at: dict[int, dict] = {m: {} for m in self.milestones}


    def on_trial_result(self, controller, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        score = self._score(result)
        if score is None:
            return CONTINUE
        seen = trial.sched_state.setdefault("hb_milestones", set())
        for m in self.milestones:
            if t >= m and m not in seen:
                seen.add(m)
                self._recorded[m].append(score)
                self._at[m][trial.trial_id] = score
        # Judge ONLY at the highest crossed milestone: a stale low-rung
        # cutoff must not retroactively kill a trial that already survived
        # (and improved past) higher rungs.
        crossed = [m for m in self.milestones if t >= m]
        if not crossed:
            return CONTINUE
        m = crossed[-1]
        rec = self._recorded[m]
        if len(rec) >= self.rf:
            keep = max(1, int(len(rec) / self.rf))
            cutoff = sorted(rec, reverse=True)[keep - 1]
            if self._at[m][trial.trial_id] < cutoff:
                return STOP
        return CONTINUE
