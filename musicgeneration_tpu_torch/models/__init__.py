"""Model families of the torch port (MusicTransformer, for now)."""

from .music_transformer import MusicTransformer, music_transformer_defaults

__all__ = ["MusicTransformer", "music_transformer_defaults"]
