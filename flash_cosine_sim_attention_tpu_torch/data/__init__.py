from .loader import TextSampler, synthetic_corpus

__all__ = ["TextSampler", "synthetic_corpus"]
