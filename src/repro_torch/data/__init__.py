"""Synthetic batches and the step-keyed data pipeline (the port of
``repro.data``)."""
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synth import batch_shapes, make_batch

__all__ = ["batch_shapes", "make_batch", "DataPipeline"]
