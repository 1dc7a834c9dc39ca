"""Compound-word generation: a prefill, then one decode step per row.

The port of ``musicgeneration_tpu/decode/cp_generate.py``. Type-first
sampling (Hsiao et al. 2021): every head is drawn, then the fields the
drawn FAMILY does not own are forced to their ignore ids, so a metric
row never carries pitch/duration/velocity and a note row never carries
position/tempo/chord, whatever the heads said. The prompt goes through
one ``CPTransformer.prefill`` (kernel A on the card), each row through
``decode_step`` (kernel B); the loop keeps rows on the device and never
reads them back. With ``mesh=`` the batch's rows are split over the
data shards of a virtual mesh (``engine.run_data_parallel``), each shard
drawing from its own stream.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..tokenizers import cp
from .engine import align_cache_len, run_data_parallel
from .sampling import SamplingParams, sample_logits

# fields each family owns: the metric fields are ignored on note rows,
# the note fields on every other row
_METRIC_FIELDS = (1, 2, 3, 4)
_NOTE_FIELDS = (5, 6, 7)
_MASKS: Dict[torch.device, tuple] = {}


def _field_masks(device: torch.device) -> tuple:
    """(ignore ids [1, 8] int64, metric-field mask [1, 8], note-field mask
    [1, 8]) on ``device``, made once: a host-to-device copy every row
    would wait for the work queued before it."""
    if device not in _MASKS:
        cols = torch.arange(cp.WIDTH)
        _MASKS[device] = tuple(y[None].to(device) for y in (
            torch.tensor(cp.ignore_ids()),
            (cols >= _METRIC_FIELDS[0]) & (cols <= _METRIC_FIELDS[-1]),
            cols >= _NOTE_FIELDS[0]))
    return _MASKS[device]


def _mask_row(row: torch.Tensor) -> torch.Tensor:
    """[B, 8] int rows -> the same rows with the ignore id in every field
    the row's family does not own."""
    ign, metric, note = _field_masks(row.device)
    is_note = (row[:, 0] == cp.FAMILY_NOTE)[:, None]
    drop = (is_note & metric) | (~is_note & note)
    return torch.where(drop, ign.to(row.dtype), row)


def sample_row(logits: List[torch.Tensor], temperature: float, greedy: bool,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """The 8 heads' logits [B, fd] -> one masked row [B, 8] int64: each
    field the argmax (greedy) or a draw at ``temperature`` from
    ``generator``, field by field in order."""
    sp = SamplingParams(temperature=max(temperature, 1e-6), greedy=greedy)
    cols = [sample_logits(lg, sp, generator) for lg in logits]
    return _mask_row(torch.stack(cols, dim=-1))


@torch.no_grad()
def generate_cp(model, prompt_rows, steps: int,
                max_len: Optional[int] = None, temperature: float = 1.0,
                greedy: bool = False,
                generator: Optional[torch.Generator] = None,
                mesh=None, seed: int = 0) -> torch.Tensor:
    """prompt_rows: [B, P, 8] ints (an array, or a tensor on any device)
    -> generated rows [B, steps, 8] int64 on the model's device.

    The cache holds ``max_len`` rows (default P + steps), rounded by
    ``align_cache_len`` as the JAX engine does. Each step samples the
    row from the previous logits (``sample_row``) and feeds it through
    ``decode_step``. ``generator``: a ``torch.Generator`` on the model's
    device for sampled rows (greedy ignores it).

    mesh: optional virtual mesh; the batch's rows are split over its data
    shards (B must divide by the data axis), each shard drawing from
    ``engine.shard_generator(seed, i)`` in place of ``generator``: greedy
    rows equal those of ``mesh=None``."""
    if not torch.is_tensor(prompt_rows):
        prompt_rows = np.asarray(prompt_rows, np.int64)
    if mesh is not None:
        if generator is not None:
            raise ValueError("with mesh= each data shard draws from its own "
                             "generator: pass seed=, not generator=")
        rows = torch.as_tensor(prompt_rows, dtype=torch.long)
        return run_data_parallel(
            model, mesh, seed, rows.shape[0],
            lambda m, r, gen: generate_cp(m, rows[r], steps, max_len,
                                          temperature, greedy, gen))
    prompt = torch.as_tensor(prompt_rows, dtype=torch.long,
                             device=model.device)
    if prompt.dim() != 3 or prompt.shape[2] != cp.WIDTH:
        raise ValueError(f"prompt_rows must be [B, P, {cp.WIDTH}]; got "
                         f"{tuple(prompt.shape)}")
    b, p, _ = prompt.shape
    max_len = max_len or (p + steps)
    if p + steps > max_len:
        raise ValueError(f"prompt ({p}) + steps ({steps}) exceeds max_len "
                         f"({max_len})")
    if p + steps > model.max_seq:
        raise ValueError(f"prompt ({p}) + steps ({steps}) exceeds the "
                         f"model's max_seq ({model.max_seq}): the positional "
                         "and relative tables end there")
    logits, cache = model.prefill(prompt, align_cache_len(model, max_len))
    stacked = model.decode_weights()
    out = torch.empty(b, steps, cp.WIDTH, dtype=torch.long,
                      device=model.device)
    t = p
    for i in range(steps):
        row = sample_row(logits, temperature, greedy, generator)
        out[:, i] = row
        logits, cache = model.decode_step(row, cache, t, stacked)
        t += 1
    return out
