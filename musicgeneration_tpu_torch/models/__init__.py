"""Model families of the torch port: the MusicTransformer, the Compound
Word transformer, the GRU language models (EventMelodyRNN,
PerformanceRNN), the LSTM one (MelodyRNN) and PoPMAG (melody ->
arrangement over MuMIDI); ``registry.get_model`` looks them up by
name."""

from .cp_transformer import CPTransformer, cp_transformer_defaults
from .event_rnn import EventMelodyRNN
from .melody_rnn import MelodyRNN
from .music_transformer import MusicTransformer, music_transformer_defaults
from .performance_rnn import PerformanceRNN
from .popmag import PoPMAGRNN
from .registry import get_model

__all__ = ["CPTransformer", "EventMelodyRNN", "MelodyRNN",
           "MusicTransformer", "PerformanceRNN", "PoPMAGRNN",
           "cp_transformer_defaults", "get_model",
           "music_transformer_defaults"]
