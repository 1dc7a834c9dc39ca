"""Model families of the torch port: the MusicTransformer, the Compound
Word transformer and the GRU language models (EventMelodyRNN,
PerformanceRNN); ``registry.get_model`` looks them up by name."""

from .cp_transformer import CPTransformer, cp_transformer_defaults
from .event_rnn import EventMelodyRNN
from .music_transformer import MusicTransformer, music_transformer_defaults
from .performance_rnn import PerformanceRNN
from .registry import get_model

__all__ = ["CPTransformer", "EventMelodyRNN", "MusicTransformer",
           "PerformanceRNN", "cp_transformer_defaults", "get_model",
           "music_transformer_defaults"]
