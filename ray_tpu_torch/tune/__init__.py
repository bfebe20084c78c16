"""ray_tpu_torch.tune — distributed hyperparameter tuning.

Parity target: reference python/ray/tune (Tuner/TuneConfig/ResultGrid,
search spaces, ASHA/PBT schedulers). The hyperparameter axis of SURVEY
§2.4's parallelism strategies: trials are actors scheduled like any other
workload, so tuning composes with training/PGs/FT for free.

Counterpart: ray_tpu/tune/__init__.py (copied).
"""

from ray_tpu_torch.tune._session import get_checkpoint, report
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    FIFOScheduler,
    PopulationBasedTraining,
)
from ray_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.search import Searcher, TPESearcher
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import Result, ResultGrid, TuneConfig, Tuner

__all__ = [
    "ASHAScheduler",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "FIFOScheduler",
    "PopulationBasedTraining",
    "Result",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "Trial",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "sample_from",
    "uniform",
]
