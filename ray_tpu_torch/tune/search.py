"""Search spaces + the basic variant generator.

Parity target: reference python/ray/tune/search/sample.py (Domain/Float/
Integer/Categorical, uniform:437, loguniform:480, choice:413, randint:500)
and search/basic_variant.py (BasicVariantGenerator — grid cartesian product
x num_samples random sampling).

Counterpart: ray_tpu/tune/search.py (copied).
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Callable, Optional


class Domain:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if log and lower <= 0:
            raise ValueError("loguniform requires lower > 0")
        self.lower, self.upper, self.log = lower, upper, log

    def sample(self, rng):
        if self.log:
            import math

            return math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
        return rng.uniform(self.lower, self.upper)


class Integer(Domain):
    def __init__(self, lower: int, upper: int):
        self.lower, self.upper = lower, upper

    def sample(self, rng):
        return rng.randrange(self.lower, self.upper)


class Categorical(Domain):
    def __init__(self, categories):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        return self.fn(None)


def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def choice(categories) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: list) -> dict:
    return {"grid_search": list(values)}


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


def _walk(space: dict, path=()):
    """Yield (path, value) leaves of a nested param space dict."""
    for k, v in space.items():
        if isinstance(v, dict) and not _is_grid(v):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _set_path(d: dict, path: tuple, value):
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


class BasicVariantGenerator:
    """Grid cartesian product x num_samples; non-grid Domains resampled per
    variant (reference basic_variant.py)."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def generate(self, param_space: dict, num_samples: int) -> list[dict]:
        leaves = list(_walk(param_space or {}))
        grid_axes = [(p, v["grid_search"]) for p, v in leaves if _is_grid(v)]
        combos = list(itertools.product(*[vals for _p, vals in grid_axes])) or [()]
        configs = []
        for _ in range(max(1, num_samples)):
            for combo in combos:
                cfg: dict = {}
                for (p, v) in leaves:
                    if _is_grid(v):
                        continue
                    _set_path(cfg, p, v.sample(self._rng)
                              if isinstance(v, Domain) else v)
                for (p, _vals), val in zip(grid_axes, combo):
                    _set_path(cfg, p, val)
                configs.append(cfg)
        return configs


# ---------------------------------------------------------------- searchers
class Searcher:
    """Model-based suggestion contract (reference tune/search/searcher.py:
    suggest(trial_id) -> config, on_trial_complete(trial_id, result)).
    Used by TuneController when TuneConfig.search_alg is set — trials are
    suggested SEQUENTIALLY as capacity frees, not pre-generated."""

    def set_search_properties(self, metric: str, mode: str,
                              param_space: dict):
        self.metric = metric
        self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str, result: Optional[dict]):
        pass

    def observe(self, config: dict, result: Optional[dict]):
        """Feed an externally-evaluated (config, result) pair into the
        model (experiment restore; reference Searcher.add_evaluated_point).
        No-op for model-free searchers."""


class TPESearcher(Searcher):
    """Native Tree-structured Parzen Estimator (Bergstra et al. 2011) —
    the role the reference fills with OptunaSearch (tune/search/optuna/
    optuna_search.py, whose default sampler is also TPE), with no external
    dependency. Observations split into good/bad by the objective's top
    `gamma` quantile; candidates are drawn from the good-points density
    l(x) and ranked by l(x)/g(x). Floats (linear/log) use Parzen windows,
    integers round the continuous result, categoricals use smoothed
    count ratios."""

    def __init__(self, n_startup: int = 8, gamma: float = 0.25,
                 n_candidates: int = 24, seed: Optional[int] = None):
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.rng = random.Random(seed)
        self._observations: list[tuple[dict, float]] = []  # (config, obj)
        self._live: dict[str, dict] = {}
        self.metric = None
        self.mode = "max"
        self.param_space: dict = {}

    # -- sampling helpers ---------------------------------------------------
    def _random_config(self) -> dict:
        out: dict = {}
        for path, dom in _walk(self.param_space):
            if _is_grid(dom):
                _set_path(out, path, self.rng.choice(dom["grid_search"]))
            elif isinstance(dom, Domain):
                _set_path(out, path, dom.sample(self.rng))
            else:
                _set_path(out, path, dom)
        return out

    @staticmethod
    def _get_path(cfg: dict, path: tuple):
        for p in path:
            cfg = cfg[p]
        return cfg

    def _parzen_best(self, good: list[float], bad: list[float],
                     lower: float, upper: float) -> float:
        """Draw candidates from Parzen windows over `good`, score by
        l/g density ratio, return the best candidate."""
        import math

        span = upper - lower

        def mixture_pdf(x, points, bw):
            # Gaussian mixture + one uniform prior component over the range
            # (keeps g(x) > 0 and leaves room for exploration).
            dens = 1.0 / span
            for p in points:
                dens += math.exp(-0.5 * ((x - p) / bw) ** 2) / (
                    bw * math.sqrt(2 * math.pi))
            return dens / (len(points) + 1)

        # Bandwidth shrinks with the number of good points; the +1 keeps a
        # SINGLE good anchor from getting a whole-range window (candidates
        # then clamp-pile at the domain edges and the model degenerates to
        # edge-probing — observed on log domains).
        bw_good = max(span / (1.0 + len(good)), span * 0.02)
        bw_bad = max(span / (1.0 + math.sqrt(len(bad) or 1)), span * 0.02)
        best_x, best_score = None, -1.0
        for _ in range(self.n_candidates):
            anchor = self.rng.choice(good)
            x = min(upper, max(lower, self.rng.gauss(anchor, bw_good)))
            score = (mixture_pdf(x, good, bw_good)
                     / mixture_pdf(x, bad or [0.5 * (lower + upper)], bw_bad))
            if score > best_score:
                best_x, best_score = x, score
        return best_x

    def _suggest_dim(self, dom, good_vals: list, bad_vals: list):
        import math

        if _is_grid(dom) or isinstance(dom, Categorical):
            cats = dom["grid_search"] if _is_grid(dom) else dom.categories
            # smoothed count ratio; keys by index to tolerate unhashables
            def counts(vals):
                c = [1.0] * len(cats)  # +1 Dirichlet smoothing
                for v in vals:
                    for i, cat in enumerate(cats):
                        if cat == v:
                            c[i] += 1.0
                            break
                total = sum(c)
                return [x / total for x in c]

            lp, gp = counts(good_vals), counts(bad_vals)
            # sample candidates from l, keep the best l/g ratio
            best_i, best_score = 0, -1.0
            for _ in range(self.n_candidates):
                i = self.rng.choices(range(len(cats)), weights=lp)[0]
                score = lp[i] / gp[i]
                if score > best_score:
                    best_i, best_score = i, score
            return cats[best_i]
        if isinstance(dom, Float):
            if dom.log:
                lo, hi = math.log(dom.lower), math.log(dom.upper)
                g = [math.log(v) for v in good_vals]
                b = [math.log(v) for v in bad_vals]
                return math.exp(self._parzen_best(g, b, lo, hi))
            return self._parzen_best(good_vals, bad_vals, dom.lower, dom.upper)
        if isinstance(dom, Integer):
            x = self._parzen_best([float(v) for v in good_vals],
                                  [float(v) for v in bad_vals],
                                  dom.lower, dom.upper)
            return int(min(dom.upper, max(dom.lower, round(x))))
        if isinstance(dom, Function):
            return dom.sample(self.rng)
        return dom  # fixed value

    # -- Searcher contract --------------------------------------------------
    def suggest(self, trial_id: str) -> dict:
        obs = self._observations
        if len(obs) < self.n_startup:
            cfg = self._random_config()
            self._live[trial_id] = cfg
            return cfg
        sign = 1.0 if (self.mode or "max") == "max" else -1.0
        ranked = sorted(obs, key=lambda o: sign * o[1], reverse=True)
        n_good = max(1, int(len(ranked) * self.gamma))
        good, bad = ranked[:n_good], ranked[n_good:]
        cfg: dict = {}
        for path, dom in _walk(self.param_space):
            gv = [self._get_path(c, path) for c, _ in good]
            bv = [self._get_path(c, path) for c, _ in bad]
            _set_path(cfg, path, self._suggest_dim(dom, gv, bv))
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id: str, result: Optional[dict]):
        cfg = self._live.pop(trial_id, None)
        if cfg is None:
            return
        self.observe(cfg, result)

    def observe(self, config: dict, result: Optional[dict]):
        if not config or not result or self.metric not in result:
            return
        try:
            obj = float(result[self.metric])
        except (TypeError, ValueError):
            return
        if obj != obj:  # NaN would corrupt the good/bad quantile split
            return
        self._observations.append((config, obj))
