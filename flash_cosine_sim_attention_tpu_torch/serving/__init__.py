from .engine import InferenceEngine
from .paged_engine import PagedInferenceEngine
from .spec_engine import SpeculativeEngine

__all__ = ["InferenceEngine", "PagedInferenceEngine", "SpeculativeEngine"]
