from .engine import InferenceEngine

__all__ = ["InferenceEngine"]
