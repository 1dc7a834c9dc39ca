"""KV-cached generation and sampling for the torch port."""

from .engine import DecodeParams, align_cache_len, generate, generate_events
from .sampling import SamplingParams, sample_logits

__all__ = ["DecodeParams", "SamplingParams", "align_cache_len", "generate",
           "generate_events", "sample_logits"]
