"""Carry JAX-trained weights into the port.

``state_dict_from_jax`` maps the JAX package's flax MusicTransformer
parameter tree (nested dicts of numpy arrays, unrolled ``layer_i`` or
stacked ``layers_scan``) to the port's ``state_dict``, under the
reference names that ``musicgeneration_tpu/cli/export_checkpoint.py:
70-95`` writes; ``event_rnn_state_dict_from_jax``,
``performance_rnn_state_dict_from_jax`` and
``popmag_state_dict_from_jax`` are the port's copies of
``export_event_rnn`` / ``export_performance_rnn`` / ``export_popmag``
(:98-147), ``melody_rnn_state_dict_from_jax`` maps a flax MelodyRNN tree
to the port's MelodyRNN names (the JAX package exports no MelodyRNN
``.pth``: its module names with torch's LSTM layout, ``lstm.weight_ih_l
{k}``, ...; ``models/melody_rnn.py``), and
``cp_transformer_state_dict_from_jax`` maps a flax
CPTransformer tree (unrolled or ``layers_scan``) to the port's own CP
names (the JAX package exports no CP ``.pth``): ``embed_<field>.weight``,
``layers.<i>.`` + the ``EncoderLayer`` names, ``head_<field>.weight`` /
``.bias`` (``models/cp_transformer.py``). Flax kernels are [in, out] (a
GRU's [in, 3H]); torch weights are [out, in].

``load_checkpoint`` reads what ``python -m
musicgeneration_tpu.cli.export_checkpoint runs/x model.pth`` writes for
the four families it exports: a MusicTransformer's ``{'net':
state_dict, 'optimizer': {}, 'epoch': step}``, an EventMelodyRNN's or
PoPMAG's bare state dict, a PerformanceRNN's session dict
``{'model_config', 'model_state', 'model_optimizer_state'}``; or the
port's own training checkpoints (``utils/checkpoint.py``), a
CPTransformer's and the RNN families' among them, with the config they
record (its ``scheme`` and ``model_kwargs``; a MelodyRNN's
``attn_length`` comes from there, as the weights do not hold it). It
infers the family and shape from the
state dict and loads it with ``strict=True``. The port reads no flax msgpack.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .models.cp_transformer import CPTransformer
from .models.event_rnn import EventMelodyRNN
from .models.melody_rnn import MelodyRNN
from .models.music_transformer import MusicTransformer
from .models.performance_rnn import PerformanceRNN
from .models.popmag import PoPMAGRNN


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _unstack_layers(params: Mapping[str, Any]) -> Dict[str, Any]:
    """A ``layers_scan`` tree (leading [L, ...] axis on every leaf) as
    unrolled ``layer_i`` subtrees; other trees pass through."""
    if "layers_scan" not in params:
        return dict(params)
    out = {k: v for k, v in params.items() if k != "layers_scan"}
    stacked = params["layers_scan"]

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    probe = stacked
    while isinstance(probe, Mapping):
        probe = next(iter(probe.values()))
    for i in range(np.asarray(probe).shape[0]):
        out[f"layer_{i}"] = take(stacked, i)
    return out


def _lin(p, name: str, sd) -> None:
    sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _t(p["bias"])


def _encoder_layer(lp, pre: str, sd) -> None:
    """One flax ``EncoderLayer`` subtree -> the port's names under
    ``pre``."""
    for name in ("Wq", "Wk", "Wv", "fc"):
        _lin(lp["rga"][name], f"{pre}.rga.{name}", sd)
    sd[f"{pre}.rga.E"] = _t(lp["rga"]["E"])
    _lin(lp["ffn_pre"], f"{pre}.FFN_pre", sd)
    _lin(lp["ffn_suf"], f"{pre}.FFN_suf", sd)
    for ln, name in (("ln1", "layernorm1"), ("ln2", "layernorm2")):
        sd[f"{pre}.{name}.weight"] = _t(lp[ln]["scale"])
        sd[f"{pre}.{name}.bias"] = _t(lp[ln]["bias"])


def state_dict_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax MusicTransformer params -> the port's (reference-named)
    state_dict of float32 tensors."""
    params = _unstack_layers(params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["Decoder.embedding.weight"] = _t(params["embedding"]["embedding"])
    i = 0
    while f"layer_{i}" in params:
        _encoder_layer(params[f"layer_{i}"], f"Decoder.enc_layers.{i}", sd)
        i += 1
    _lin(params["fc"], "fc", sd)
    return sd


def cp_transformer_state_dict_from_jax(
        params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax CPTransformer params (``layer_i`` or ``layers_scan``) -> the
    port's CP state dict of float32 tensors (module docstring)."""
    from .tokenizers.cp import field_names

    params = _unstack_layers(params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in field_names():
        sd[f"embed_{name}.weight"] = _t(params[f"embed_{name}"]["embedding"])
    i = 0
    while f"layer_{i}" in params:
        _encoder_layer(params[f"layer_{i}"], f"layers.{i}", sd)
        i += 1
    for name in field_names():
        _lin(params[f"head_{name}"], f"head_{name}", sd)
    return sd


def _gru(p, name: str, sd) -> None:
    """The JAX GRUStack's (or LSTMStack's) ``l{k}_*`` ([in, 3H] or
    [in, 4H]) -> nn.GRU (nn.LSTM) names."""
    k = 0
    while f"l{k}_w_ih" in p:
        sd[f"{name}.weight_ih_l{k}"] = _t(p[f"l{k}_w_ih"]).T.contiguous()
        sd[f"{name}.weight_hh_l{k}"] = _t(p[f"l{k}_w_hh"]).T.contiguous()
        sd[f"{name}.bias_ih_l{k}"] = _t(p[f"l{k}_b_ih"])
        sd[f"{name}.bias_hh_l{k}"] = _t(p[f"l{k}_b_hh"])
        k += 1


def event_rnn_state_dict_from_jax(params: Mapping[str, Any]
                                  ) -> "OrderedDict[str, torch.Tensor]":
    """Flax EventMelodyRNN params -> the reference state dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["event_embedding.weight"] = _t(params["event_embedding"]["embedding"])
    _lin(params["inithid_fc"], "inithid_fc", sd)
    _gru(params["gru"], "rnn", sd)
    _lin(params["output_fc"], "output_fc", sd)
    return sd


def performance_rnn_state_dict_from_jax(params: Mapping[str, Any]
                                        ) -> "OrderedDict[str, torch.Tensor]":
    """Flax PerformanceRNN params -> the reference state dict (the
    session dict's ``model_state``)."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["event_embedding.weight"] = _t(params["event_embedding"]["embedding"])
    _lin(params["inithid_fc"], "inithid_fc", sd)
    _lin(params["concat_input_fc"], "concat_input_fc", sd)
    _gru(params["gru"], "gru", sd)
    _lin(params["output_fc"], "output_fc", sd)
    return sd


def melody_rnn_state_dict_from_jax(params: Mapping[str, Any]
                                   ) -> "OrderedDict[str, torch.Tensor]":
    """Flax MelodyRNN params -> the port's MelodyRNN state dict: the JAX
    module names with torch's LSTM layout (``lstm.weight_ih_l{k}``
    [4H, in], ...; the JAX package has no MelodyRNN exporter) and, with
    attention, ``attn_query``/``attn_key``/``attn_v`` (no bias) and
    ``attn_mix``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["embedding.weight"] = _t(params["embedding"]["embedding"])
    _gru(params["lstm"], "lstm", sd)
    for name in ("attn_query", "attn_key", "attn_v"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["kernel"]).T.contiguous()
    if "attn_mix" in params:
        _lin(params["attn_mix"], "attn_mix", sd)
    _lin(params["decoder"], "decoder", sd)
    return sd


def popmag_state_dict_from_jax(params: Mapping[str, Any]
                               ) -> "OrderedDict[str, torch.Tensor]":
    """Flax PoPMAGRNN params -> the reference state dict (the port's copy
    of ``export_popmag``): the three heads as ``output_fc.0/1/2``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["event_embedding.weight"] = _t(params["event_embedding"]["embedding"])
    _lin(params["inithid_fc"], "inithid_fc", sd)
    _gru(params["encoder"], "encoder", sd)
    _gru(params["decoder"], "decoder", sd)
    for i, head in enumerate(("head_type", "head_pitch", "head_duration")):
        _lin(params[head], f"output_fc.{i}", sd)
    return sd


def _gru_layers(sd, name: str) -> int:
    n = 0
    while f"{name}.weight_ih_l{n}" in sd:
        n += 1
    return n


def model_from_state_dict(sd: Mapping[str, torch.Tensor], device="cuda",
                          dtype=torch.float32, decode_quant: str = "none",
                          attn_length: Optional[int] = None):
    """Build the model whose family and shape are read off ``sd`` (a
    MusicTransformer's, EventMelodyRNN's, PerformanceRNN's or PoPMAG's
    reference state dict, a CPTransformer's: ``embed_<field>`` /
    ``head_<field>`` keys, or a MelodyRNN's: ``lstm.*`` and ``decoder``)
    and load it with ``strict=True``, for inference: its parameters are
    frozen (``requires_grad_(True)`` to train it). Any other state dict
    raises ValueError naming what it holds. decode_quant: the
    transformers' ("none" or "int8"); an RNN family takes only "none".
    attn_length: a MelodyRNN's attention window, which its weights do not
    hold; None gives 40 (Magenta's ``attention_rnn``) where the state
    dict has attention weights, else 0."""
    if "rnn.weight_ih_l0" in sd and "event_embedding.weight" in sd:
        model = EventMelodyRNN(
            event_dim=sd["event_embedding.weight"].shape[0],
            init_dim=sd["inithid_fc.weight"].shape[1],
            hidden_dim=sd["rnn.weight_hh_l0"].shape[1],
            num_layers=_gru_layers(sd, "rnn"), dtype=dtype, device=device)
    elif "gru.weight_ih_l0" in sd and "concat_input_fc.weight" in sd:
        event_dim = sd["event_embedding.weight"].shape[0]
        model = PerformanceRNN(
            event_dim=event_dim,
            control_dim=sd["concat_input_fc.weight"].shape[1] - event_dim - 1,
            init_dim=sd["inithid_fc.weight"].shape[1],
            hidden_dim=sd["gru.weight_hh_l0"].shape[1],
            num_layers=_gru_layers(sd, "gru"), dtype=dtype, device=device)
    elif "encoder.weight_ih_l0" in sd and "output_fc.0.weight" in sd:
        model = _popmag(sd, device, dtype)
    elif "lstm.weight_ih_l0" in sd and "decoder.weight" in sd:
        model = _melody_rnn(sd, device, dtype, attn_length)
    elif "Decoder.embedding.weight" in sd:
        model = _music_transformer(sd, device, dtype, decode_quant)
    elif "embed_family.weight" in sd and "head_family.weight" in sd:
        model = _cp_transformer(sd, device, dtype, decode_quant)
    else:
        keys = sorted(sd)
        raise ValueError(
            "not a checkpoint of a family the port runs (MusicTransformer, "
            "CPTransformer, EventMelodyRNN, PerformanceRNN, MelodyRNN, "
            "PoPMAG): its "
            f"state dict holds {len(keys)} keys, {keys[:6]}")
    if decode_quant != "none" and model.family not in (
            "music_transformer", "cp_transformer"):
        raise ValueError(f"decode_quant {decode_quant!r} applies to the "
                         "transformer families (the fused decode kernels); "
                         f"this checkpoint holds a {model.family}")
    model.load_state_dict(sd, strict=True)
    return model.requires_grad_(False)


def _music_transformer(sd, device, dtype, decode_quant) -> MusicTransformer:
    emb = sd["Decoder.embedding.weight"]
    num_layers = 0
    while f"Decoder.enc_layers.{num_layers}.rga.E" in sd:
        num_layers += 1
    e = sd["Decoder.enc_layers.0.rga.E"]
    model = MusicTransformer(
        vocab_size=emb.shape[0], num_layers=num_layers, d_model=emb.shape[1],
        max_seq=e.shape[0], head_dim=e.shape[1],
        ffn_dim=sd["Decoder.enc_layers.0.FFN_pre.weight"].shape[0],
        dtype=dtype, device=device, decode_quant=decode_quant)
    return model


def _popmag(sd, device, dtype) -> PoPMAGRNN:
    """PoPMAG's shape as ``cli/import_checkpoint.py::convert_popmag``
    (:154-180) reads it: event_dim from the head widths (out_len[0] =
    event_dim - 1 - note_on - note_duration, network.py:50), bar_dim the
    embedding's remaining rows."""
    heads = [sd[f"output_fc.{i}.weight"].shape[0] for i in range(3)]
    event_dim = heads[0] + 1 + heads[1] + heads[2]
    emb = sd["event_embedding.weight"]
    return PoPMAGRNN(
        event_dim=event_dim, bar_dim=emb.shape[0] - event_dim,
        init_dim=sd["inithid_fc.weight"].shape[1], embed_dim=emb.shape[1],
        hidden_dim=sd["encoder.weight_hh_l0"].shape[1],
        num_layers=_gru_layers(sd, "encoder"), dtype=dtype, device=device)


def _melody_rnn(sd, device, dtype, attn_length) -> MelodyRNN:
    has_attn = "attn_key.weight" in sd
    if attn_length is None:
        attn_length = 40 if has_attn else 0
    if has_attn != (attn_length > 0):
        raise ValueError(f"attn_length={attn_length} does not match the "
                         "state dict (attention weights "
                         f"{'present' if has_attn else 'absent'})")
    emb = sd["embedding.weight"]
    return MelodyRNN(
        vocab_size=emb.shape[0], embed_size=emb.shape[1],
        hidden_dim=sd["lstm.weight_hh_l0"].shape[1],
        num_layers=_gru_layers(sd, "lstm"), attn_length=attn_length,
        dtype=dtype, device=device)


def _cp_transformer(sd, device, dtype, decode_quant) -> CPTransformer:
    num_layers = 0
    while f"layers.{num_layers}.rga.E" in sd:
        num_layers += 1
    return CPTransformer(
        num_layers=num_layers, d_model=sd["embed_family.weight"].shape[1],
        max_seq=sd["layers.0.rga.E"].shape[0], dtype=dtype, device=device,
        decode_quant=decode_quant)


_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def recorded_dtype(config: Mapping) -> torch.dtype:
    """The compute dtype a ``cli.train`` step file's config records
    (``config["model_kwargs"]["dtype"]``, as the JAX CLI's
    ``build_session`` rebuilds the model from ``model_kwargs``); float32
    where it records none (an exported ``.pth``)."""
    name = (config.get("model_kwargs") or {}).get("dtype", "float32")
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPE_NAMES:
        raise ValueError(f"recorded model dtype {name!r} is not one of "
                         f"{sorted(_DTYPE_NAMES)}")
    return _DTYPE_NAMES[name]


def recorded_quant(config: Mapping) -> str:
    """The ``decode_quant`` a ``cli.train`` step file's config records
    (``config["model_kwargs"]["decode_quant"]``, as the JAX CLI rebuilds
    the model from ``model_kwargs``); "none" where it records none (an
    exported ``.pth``)."""
    return (config.get("model_kwargs") or {}).get("decode_quant", "none")


_DEFAULT_SCHEMES = {"melody_rnn": "melody", "cp_transformer": "cp",
                    "popmag": "mumidi"}


def recorded_scheme(family: str, config: Mapping) -> str:
    """The token scheme a checkpoint decodes through: the one its
    ``cli.train`` run recorded (``config["scheme"]``), else the family's
    (an exported ``.pth`` carries none): ``melody`` for a MelodyRNN,
    ``cp`` for a CPTransformer, ``mumidi`` for PoPMAG, ``midilike``
    for the MusicTransformer and the GRU families."""
    return config.get("scheme") or _DEFAULT_SCHEMES.get(family, "midilike")


def load_checkpoint(path: str, device="cuda", dtype=torch.float32,
                    with_config: bool = False,
                    decode_quant: Optional[str] = None):
    """A model from an exported ``.pth`` (``{'net': state_dict, ...}``,
    a PerformanceRNN session dict ``{'model_state': state_dict, ...}``,
    or a bare state dict), a training checkpoint ``step-<N>.pt`` of
    ``cli.train`` (``{'model': state_dict, ...}``), or a directory of
    those (its newest step). The family is read off the state dict
    (``model_from_state_dict``; ``model.family`` names it).

    dtype: the compute dtype, or None for the one the checkpoint records
    (``recorded_dtype``); decode_quant likewise ("none" or "int8", or
    None for ``recorded_quant``). With ``with_config`` returns (model,
    the recorded config: a step file's ``config``, its ``scheme`` among
    it, else {}; ``recorded_scheme`` reads it)."""
    if os.path.isdir(path):
        from .utils.checkpoint import latest_checkpoint
        newest = latest_checkpoint(path)
        if newest is None:
            raise FileNotFoundError(f"no step-<N>.pt checkpoint in {path}")
        path = newest
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj
    for key in ("model", "net", "model_state"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            sd = obj[key]
            break
    config = {}
    if isinstance(obj, Mapping) and isinstance(obj.get("config"), Mapping) \
            and sd is obj.get("model"):
        config = dict(obj["config"])
    if dtype is None:
        dtype = recorded_dtype(config)
    if decode_quant is None:
        decode_quant = recorded_quant(config)
    model = model_from_state_dict(
        sd, device=device, dtype=dtype, decode_quant=decode_quant,
        attn_length=(config.get("model_kwargs") or {}).get("attn_length"))
    return (model, config) if with_config else model
