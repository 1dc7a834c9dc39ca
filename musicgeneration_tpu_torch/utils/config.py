"""Dataclass config tree with dotted CLI overrides (no eval).

A copy of ``musicgeneration_tpu/utils/config.py`` (pure Python), kept in
the port so that it imports nothing of the JAX package.

The reference configures each model with a `config.py` module of plain
constants plus string overrides parsed by `params2dict`, which calls
`eval` on user input (mg/model/utils/shared.py:73-81 — applied at
Event_MelodyRNN/train.py:124-126).  This module keeps the good part —
derive vocab sizes from the tokenizer spec, override any field from the
CLI — and drops the eval: values are parsed with `ast.literal_eval`
(literals only) after type-directed coercion against the dataclass
field's annotation.

Usage:
    @dataclasses.dataclass
    class TrainConfig(Config):
        model: ModelConfig = field(default_factory=ModelConfig)
        batch_size: int = 8
        lr: float | None = None

    cfg = TrainConfig()
    cfg = apply_overrides(cfg, ["batch_size=32", "model.d_model=512"])
"""

from __future__ import annotations

import ast
import dataclasses
import typing
from typing import Any, Dict, List, Optional, Sequence


@dataclasses.dataclass
class Config:
    """Base class: adds dict round-trip + pretty repr to config nodes."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            ftype = _unwrap_optional(f.type, cls)
            if (isinstance(v, dict) and isinstance(ftype, type)
                    and dataclasses.is_dataclass(ftype)):
                v = ftype.from_dict(v) if issubclass(ftype, Config) else \
                    ftype(**v)
            kwargs[f.name] = v
        return cls(**kwargs)


def _unwrap_optional(tp: Any, owner: type) -> Any:
    """Resolve string annotations and Optional[X] → X."""
    if isinstance(tp, str):
        hints = typing.get_type_hints(owner)
        # find which field this annotation belongs to is done by caller;
        # fall back to literal resolution
        try:
            tp = eval(tp, vars(typing), {})  # annotations only, not user data
        except Exception:
            return str
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: str, ftype: Any) -> Any:
    """Parse a CLI string into ftype. Literals only — never eval."""
    ftype = ftype if not isinstance(ftype, str) else None
    if ftype is bool or (ftype is None and value.lower() in
                         ("true", "false")):
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if value.lower() in ("none", "null"):
        return None
    if ftype is int:
        return int(value)
    if ftype is float:
        return float(value)
    if ftype is str:
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value  # bare string


def apply_overrides(cfg: Any, overrides: Sequence[str]) -> Any:
    """Return a copy of dataclass `cfg` with `a.b.c=value` overrides set."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} is not key=value")
        key, value = item.split("=", 1)
        cfg = _set_dotted(cfg, key.strip().split("."), value.strip())
    return cfg


def _set_dotted(node: Any, path: List[str], value: str) -> Any:
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot descend into non-config node for "
                        f"{'.'.join(path)}")
    name, rest = path[0], path[1:]
    fields = {f.name: f for f in dataclasses.fields(node)}
    if name not in fields:
        raise KeyError(
            f"unknown config field {name!r}; valid: {sorted(fields)}")
    if rest:
        child = getattr(node, name)
        new_child = _set_dotted(child, rest, value)
        return dataclasses.replace(node, **{name: new_child})
    hints = typing.get_type_hints(type(node))
    ftype = _unwrap_optional(hints.get(name, fields[name].type), type(node))
    return dataclasses.replace(node, **{name: _coerce(value, ftype)})


def config_from_args(cfg: Any, argv: Optional[Sequence[str]] = None,
                     description: str = "") -> Any:
    """argparse front-end: `prog key=value key2=value2 ...`."""
    import argparse

    p = argparse.ArgumentParser(description=description)
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="dotted config overrides, e.g. model.d_model=512")
    args = p.parse_args(argv)
    return apply_overrides(cfg, args.overrides)
