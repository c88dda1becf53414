"""Async windowed-retrain pipeline (counterpart of
``lightgbm_tpu/pipeline/``).

``RetrainPipeline`` overlaps host prep (labeling, featurization, binning)
of window N+1 with training of window N on the card while a
``PredictionServer`` keeps answering through atomic model swaps;
``BinMapperCache`` keeps the bin boundaries across windows and re-runs
find-bin only when the bin-occupancy drift statistic crosses its
threshold.
"""

from .bins import BinMapperCache
from .core import (PipelineError, PreppedWindow, RetrainPipeline,
                   WindowResult, densify_csr_rows)

__all__ = ["BinMapperCache", "PipelineError", "PreppedWindow",
           "RetrainPipeline", "WindowResult", "densify_csr_rows"]
