"""Model families of the torch port: the MusicTransformer and the GRU
language models (EventMelodyRNN, PerformanceRNN)."""

from .event_rnn import EventMelodyRNN
from .music_transformer import MusicTransformer, music_transformer_defaults
from .performance_rnn import PerformanceRNN

__all__ = ["EventMelodyRNN", "MusicTransformer", "PerformanceRNN",
           "music_transformer_defaults"]
