"""Synthetic token data: the serving traffic's prompt text and the
trainer's batches."""
from .pipeline import (DataConfig, Pipeline, SyntheticCorpus, global_batch,
                       make_pipeline)

__all__ = ["DataConfig", "Pipeline", "SyntheticCorpus", "global_batch",
           "make_pipeline"]
