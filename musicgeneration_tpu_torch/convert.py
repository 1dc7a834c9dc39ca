"""Carry JAX-trained MusicTransformer weights into the port.

``state_dict_from_jax`` maps the JAX package's flax parameter tree (nested
dicts of numpy arrays, unrolled ``layer_i`` or stacked ``layers_scan``) to
the port's ``state_dict``, under the reference names that
``musicgeneration_tpu/cli/export_checkpoint.py:70-95`` writes. Flax
kernels are [in, out]; torch Linear weights are [out, in].

``load_checkpoint`` reads the ``.pth`` that
``python -m musicgeneration_tpu.cli.export_checkpoint runs/mt model.pth``
writes (``{'net': state_dict, 'optimizer': {}, 'epoch': step}``), infers
the model's shape from it and loads it with ``strict=True``. The port
reads no flax msgpack.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .models.music_transformer import MusicTransformer


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


def state_dict_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax MusicTransformer params -> the port's (reference-named)
    state_dict of float32 tensors."""
    params = _unstack_layers(params)
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def lin(p, name):
        sd[f"{name}.weight"] = _t(p["kernel"]).T.contiguous()
        sd[f"{name}.bias"] = _t(p["bias"])

    def ln(p, name):
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])

    sd["Decoder.embedding.weight"] = _t(params["embedding"]["embedding"])
    i = 0
    while f"layer_{i}" in params:
        lp = params[f"layer_{i}"]
        pre = f"Decoder.enc_layers.{i}"
        for name in ("Wq", "Wk", "Wv", "fc"):
            lin(lp["rga"][name], f"{pre}.rga.{name}")
        sd[f"{pre}.rga.E"] = _t(lp["rga"]["E"])
        lin(lp["ffn_pre"], f"{pre}.FFN_pre")
        lin(lp["ffn_suf"], f"{pre}.FFN_suf")
        ln(lp["ln1"], f"{pre}.layernorm1")
        ln(lp["ln2"], f"{pre}.layernorm2")
        i += 1
    lin(params["fc"], "fc")
    return sd


def model_from_state_dict(sd: Mapping[str, torch.Tensor], device="cuda",
                          dtype=torch.float32) -> MusicTransformer:
    """Build a MusicTransformer whose shape is read off ``sd`` and load
    it with ``strict=True``."""
    emb = sd["Decoder.embedding.weight"]
    num_layers = 0
    while f"Decoder.enc_layers.{num_layers}.rga.E" in sd:
        num_layers += 1
    e = sd["Decoder.enc_layers.0.rga.E"]
    model = MusicTransformer(
        vocab_size=emb.shape[0], num_layers=num_layers, d_model=emb.shape[1],
        max_seq=e.shape[0], head_dim=e.shape[1],
        ffn_dim=sd["Decoder.enc_layers.0.FFN_pre.weight"].shape[0],
        dtype=dtype, device=device)
    model.load_state_dict(sd, strict=True)
    return model


def load_checkpoint(path: str, device="cuda",
                    dtype=torch.float32) -> MusicTransformer:
    """A MusicTransformer from an exported ``.pth``
    (``{'net': state_dict, ...}``, or a bare state_dict)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["net"] if "net" in obj else obj
    return model_from_state_dict(sd, device=device, dtype=dtype)
