"""Hyperparameter tuning (ref capability: ray.tune — a trial-actor
controller with searchers and early-stopping/PBT schedulers).  The port
of the JAX package's ``tune/``; it imports no torch."""

from ant_ray_tpu_torch.tune.schedulers import (
    AsyncHyperBandScheduler,
    FIFOScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ant_ray_tpu_torch.tune.search import (
    BasicVariantGenerator,
    Searcher,
    TPESearcher,
)
from ant_ray_tpu_torch.tune.trainable import Trainable
from ant_ray_tpu_torch.tune.tuner import (
    Result,
    ResultGrid,
    TuneConfig,
    Tuner,
    choice,
    grid_search,
    loguniform,
    randint,
    report,
    uniform,
)

__all__ = [
    "AsyncHyperBandScheduler",
    "BasicVariantGenerator",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Result",
    "ResultGrid",
    "Searcher",
    "TPESearcher",
    "Trainable",
    "TrialScheduler",
    "TuneConfig",
    "Tuner",
    "choice",
    "grid_search",
    "loguniform",
    "randint",
    "report",
    "uniform",
]
