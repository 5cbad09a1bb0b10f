"""Reports across runs, learning curves and the slice viewer
(``dct_tpu/postprocessing``)."""
from .plot import plot_learning_curves  # noqa: F401
from .report import aggregate_ensemble_results  # noqa: F401
