"""KV-cached autoregressive generation.

The port of ``musicgeneration_tpu/decode/engine.py``'s single-device
path: one-pass prefill of the (optionally bucketed) prompt through the
relative-attention kernel, then one fused decode step per generated
token. JAX ran the loop as one compiled ``lax.scan``; here it is a
Python loop that keeps tokens on the device and never syncs the host.
``generate_sliding`` continues past max_seq by re-priming a window.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .sampling import SamplingParams, sample_logits


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    max_len: int                  # cache length (prompt + generated)
    steps: int                    # tokens to generate
    sampling: SamplingParams = SamplingParams()


def align_cache_len(model, max_len: int) -> int:
    """Round a KV-cache length up to a 128-row multiple, or to a 16-row
    multiple where 128 would pass the model's max_seq: the JAX engine's
    rule for its fused decode (engine.py:57-81), kept so a cache has the
    same shape on both sides. Kernel B itself takes any length."""
    if max_len % 128 == 0:
        return max_len
    aligned = -(-max_len // 128) * 128
    if aligned > getattr(model, "max_seq", 1 << 30):
        aligned = -(-max_len // 16) * 16
    return aligned


@torch.no_grad()
def generate(model, prompt: torch.Tensor,
             generator: Optional[torch.Generator],
             decode_params: DecodeParams,
             prompt_len: Optional[int] = None) -> torch.Tensor:
    """prompt: [B, P] int tokens -> generated tokens [B, steps] int64, on
    the model's device.

    generator: a ``torch.Generator`` on the model's device for sampled
    decoding (greedy ignores it). prompt_len: the true prompt length when
    ``prompt`` is padded with ``model.pad_id`` to a bucket length."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=model.device)
    b, p = prompt.shape
    dp = decode_params
    if p + dp.steps > dp.max_len:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds cache max_len "
            f"({dp.max_len}); the KV cache would overflow")
    if p + dp.steps > model.max_seq:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds the model's "
            f"max_seq ({model.max_seq}): the positional and relative "
            "tables end there")
    cache_len = align_cache_len(model, dp.max_len)
    if prompt_len is None:
        logits, cache = model.prefill(prompt, cache_len)
        t = p
    else:
        if not 0 < prompt_len <= p:
            raise ValueError(f"prompt_len {prompt_len} outside (0, {p}]")
        logits, cache = model.prefill(prompt, cache_len,
                                      last_idx=prompt_len - 1)
        t = int(prompt_len)
    stacked = model.decode_weights()
    out = torch.empty(b, dp.steps, dtype=torch.long, device=model.device)
    for i in range(dp.steps):
        token = sample_logits(logits, dp.sampling, generator)
        out[:, i] = token
        logits, cache = model.decode_step(token, cache, t, stacked)
        t += 1
    return out


def generate_events(model, prompt_ids, steps: int,
                    max_len: Optional[int] = None,
                    sampling: SamplingParams = SamplingParams(),
                    generator: Optional[torch.Generator] = None
                    ) -> np.ndarray:
    """Host-friendly wrapper: 1D prompt ids -> 1D numpy continuation."""
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64))[None]
    max_len = max_len or (prompt.shape[1] + steps)
    dp = DecodeParams(max_len=max_len, steps=steps, sampling=sampling)
    return generate(model, prompt, generator, dp)[0].cpu().numpy()


def generate_sliding(model, prompt, generator: Optional[torch.Generator],
                     steps: int, window: int = 512,
                     sampling: SamplingParams = SamplingParams()
                     ) -> np.ndarray:
    """Unbounded-length generation by window re-priming
    (engine.py:416-452): generate in cached chunks of a 2*window cache;
    when it fills, re-prime from the last ``window`` tokens and go on.

    prompt: [B, P] ints; returns [B, steps] numpy int64. Chunks draw
    from ``generator`` in turn (greedy ignores it)."""
    if 2 * window > model.max_seq:
        raise ValueError(
            f"window ({window}) must be <= max_seq//2 ({model.max_seq // 2})"
            ": the sliding cache spans 2*window positions, all of which "
            "must stay inside the model's position/E tables")
    max_len = 2 * window
    produced = []
    ctx = np.asarray(prompt, np.int64)[:, -window:]
    remaining = steps
    while remaining > 0:
        chunk = min(remaining, max_len - ctx.shape[1])
        dp = DecodeParams(max_len=max_len, steps=chunk, sampling=sampling)
        out = generate(model, torch.from_numpy(ctx), generator,
                       dp).cpu().numpy()
        produced.append(out)
        remaining -= chunk
        ctx = np.concatenate([ctx, out], axis=1)[:, -window:]
    return np.concatenate(produced, axis=1)[:, :steps]
