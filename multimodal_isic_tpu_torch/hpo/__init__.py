"""Hyperparameter search for the MIL trainables: spaces, ASHA, the
sequential runner and packed trial cohorts (counterpart of
``multimodal_isic_tpu/hpo``)."""

from .asha import ASHAScheduler  # noqa: F401
from .population import (  # noqa: F401
    run_population_search, train_mil_population,
)
from .runner import Trial, TrialStopped, run_search  # noqa: F401
from .space import (  # noqa: F401
    GRAPH_MIL_SPACE, MIL_SPACE, Choice, LogUniform, QRandInt, Uniform,
    sample_config,
)
