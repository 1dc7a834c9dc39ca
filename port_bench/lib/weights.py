"""Weights made from the seed, on the device, in one draw.

Every parameter of a model is filled from one ``torch.randn`` of the
model's whole size, drawn on the run's device from a generator seeded
with the run's seed, then scaled per leaf by the configuration's rule.
The reference gets the same tensors, as f32 copies.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch


def seed_word(seed: int, tag: int) -> int:
    """A 63-bit generator seed that is a pure function of (seed, tag)."""
    w = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), int(tag)]
                               ).generate_state(2, np.uint32)
    return ((int(w[0]) << 32) | int(w[1])) & ((1 << 63) - 1)


def device_generator(device: torch.device, seed: int, tag: int
                     ) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_word(seed, tag))
    return gen


@torch.no_grad()
def fill(model: torch.nn.Module, seed: int,
         rule: Callable[[str, Tuple[int, ...]], Tuple[float, float]]
         ) -> Dict[str, torch.Tensor]:
    """Fill every parameter of ``model`` with mean + std * N(0, 1),
    (mean, std) = ``rule(name, shape)``, from one draw on the model's
    device. Returns {name: f32 copy} for the reference."""
    params = list(model.named_parameters())
    device = params[0][1].device
    total = sum(p.numel() for _, p in params)
    flat = torch.randn(total, generator=device_generator(device, seed, 7),
                       device=device)
    out, at = {}, 0
    for name, p in params:
        mean, std = rule(name, tuple(p.shape))
        v = flat[at:at + p.numel()].view(p.shape) * std + mean
        p.copy_(v)
        out[name] = v.float().clone()
        at += p.numel()
    return out


def transformer_rule(name: str, shape) -> Tuple[float, float]:
    """MusicTransformer leaves: matrices N(0, 1/fan_in), embeddings N(0,
    1/d), the relative tables E N(0, 1) (the reference's torch.randn),
    LayerNorm scales 1 + N(0, 0.02^2), biases and LayerNorm shifts N(0,
    0.02^2) (non-zero, so a bias the program drops shows)."""
    if name.endswith(".E"):
        return 0.0, 1.0
    if "embedding" in name:
        return 0.0, 1.0 / math.sqrt(shape[1])
    if "layernorm" in name and name.endswith("weight"):
        return 1.0, 0.02
    if len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 0.02


def rnn_rule(name: str, shape) -> Tuple[float, float]:
    """GRU-family leaves: the recurrent stack's weights and biases N(0,
    1/(3H)) (the standard deviation of torch's U(-1/sqrt(H), 1/sqrt(H))),
    other matrices N(0, 1/fan_in), other biases N(0, 0.02^2)."""
    if name.startswith("gru."):
        hidden = shape[0] // 3
        return 0.0, 1.0 / math.sqrt(3 * hidden)
    if len(shape) == 2:
        return 0.0, 1.0 / math.sqrt(shape[1])
    return 0.0, 0.02


RULES = {"transformer": transformer_rule, "rnn": rnn_rule}
