"""KV-cached generation, sampling and continuous-batching serving for
the torch port."""

from .engine import (DecodeParams, align_cache_len, generate,
                     generate_events, generate_sliding)
from .sampling import (SamplingParams, pack_sampling, sample_logits,
                       sample_logits_batched, unpack_sampling)

__all__ = ["DecodeParams", "SamplingParams", "align_cache_len", "generate",
           "generate_events", "generate_sliding", "pack_sampling",
           "sample_logits", "sample_logits_batched", "unpack_sampling"]
