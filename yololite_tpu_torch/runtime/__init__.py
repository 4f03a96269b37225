"""Serving runtime: the exported predict graph and the sustained double-buffered inference pipeline."""

from yololite_tpu_torch.runtime.export import export_predict, load_exported, predict_graph
from yololite_tpu_torch.runtime.pipeline import InferencePipeline, PipelineStats

__all__ = ("InferencePipeline", "PipelineStats", "export_predict", "load_exported", "predict_graph")
