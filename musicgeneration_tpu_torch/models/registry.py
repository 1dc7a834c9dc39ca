"""Model registry: name -> (module class, default config builder).

The port of ``musicgeneration_tpu/models/registry.py``: one lookup the
trainer and the CLIs share. Each family's module registers itself with
``register_model``; ``get_model`` imports the families first, so every
registered name is known to it."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Type

_REGISTRY: Dict[str, Tuple[type, Callable[..., dict]]] = {}


def register_model(name: str,
                   default_config: Optional[Callable[..., dict]] = None):
    def wrap(cls: Type):
        _REGISTRY[name] = (cls, default_config or (lambda **kw: dict(kw)))
        return cls

    return wrap


def _import_families() -> None:
    """Import every family's module (each registers itself)."""
    from . import (cp_transformer, event_rnn,  # noqa: F401
                   melody_rnn, music_transformer, performance_rnn, popmag)


def get_model(name: str) -> Tuple[type, Callable[..., dict]]:
    """(class, defaults builder) of the family ``name``; an unknown name
    raises KeyError listing the registered ones."""
    _import_families()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_models() -> list:
    """The registered family names, sorted."""
    _import_families()
    return sorted(_REGISTRY)
