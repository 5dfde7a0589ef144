"""Data pipeline: skew-aware document packing (Reshape on length buckets)."""
from .pipeline import PipelineConfig, SkewAwarePipeline, zipf_doc_lengths

__all__ = ["PipelineConfig", "SkewAwarePipeline", "zipf_doc_lengths"]
