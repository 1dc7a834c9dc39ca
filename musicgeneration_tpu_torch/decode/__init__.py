"""Generation, speculative decoding, beam search, sampling and
continuous-batching serving for the torch port."""

from .beam import beam_search, replicate_for_beams
from .engine import (DecodeParams, align_cache_len, expand_controls,
                     generate, generate_dp, generate_events,
                     generate_sliding, generate_tp)
from .sampling import (SamplingParams, pack_sampling, sample_logits,
                       sample_logits_batched, unpack_sampling)
from .speculative import SpecParams, generate_speculative

__all__ = ["DecodeParams", "SamplingParams", "SpecParams", "align_cache_len",
           "beam_search", "expand_controls", "generate", "generate_dp",
           "generate_events", "generate_tp",
           "generate_sliding", "generate_speculative", "pack_sampling",
           "replicate_for_beams", "sample_logits", "sample_logits_batched",
           "unpack_sampling"]
