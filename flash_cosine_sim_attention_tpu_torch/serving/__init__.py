from .engine import InferenceEngine
from .paged_engine import PagedInferenceEngine

__all__ = ["InferenceEngine", "PagedInferenceEngine"]
