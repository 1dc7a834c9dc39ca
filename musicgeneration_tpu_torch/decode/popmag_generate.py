"""PoPMAG arrangement generation: a typed decode loop per target bar.

The port of ``musicgeneration_tpu/decode/popmag_generate.py`` (reference
PoPMAG_RNN/network.py:216-301 ``decoder_one_step`` and :366-417
``generate_arrangement``):

* each target bar starts from the compound row (bar_id(k), pos_id(0),
  0, 0, BAR_TOKEN, 0, 0) and runs a fixed ``max_steps`` (200) decoder
  steps with a per-row done mask that a bar token sets, as the JAX
  ``lax.scan`` does: no early exit, and nothing read back to the host
  inside the loop (state and tokens stay on the device, updated with
  ``torch.where``),
* the drawn event type (head 0 + shift 289) drives the typed state:
  position and tempo class/value set their slots; chord and track go in
  the "velocity" slot (network.py:264-281); a note_velocity event also
  takes the pitch (head 1, +128 on the drum track, +shift 1) and the
  duration (head 2, +shift 257), three tokens,
* a row's hidden freezes once its bar is done (the JAX default
  ``freeze_done_hidden=True``: the reference's per-row intent), so a
  result does not depend on ``max_steps`` once a bar has ended,
* across bars the hidden carries as enc_h(bar k) -> decode bar k, then
  hidden = enc_h + dec_h (network.py:407-417); the bar-position id is
  min(k, bar_dim - 1) + EVENT_DIM.

Every decoder step is ``PoPMAGRNN.decode_compound_step``: kernel D on
CUDA, one launch a GRU layer, so a bar is exactly ``max_steps`` x L
launches whatever the done mask says. Draws come from one
``torch.Generator`` in the order type, pitch, duration each step (JAX
splits its key per bar and per step: the streams differ, the sets and
distributions do not). ``generate_arrangement_dp`` splits the batch's
rows over the data shards of a virtual mesh.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import vocab
from ..data import mumidi_packing as mp
from .engine import run_data_parallel
from .sampling import SamplingParams, sample_logits

_R = mp.SPEC.feat_ranges()
_DRUM_ID = _R["track"].start + vocab.MUMIDI_TRACK_IDX["drum"]
# event-type classes of the typed state update (0: any other token)
_BAR, _POS, _CLS, _VAL, _CHD, _TRK, _VEL = range(1, 8)
_CLASS_OF = (("bar", _BAR), ("position", _POS), ("tempo_class", _CLS),
             ("tempo_value", _VAL), ("chord", _CHD), ("track", _TRK),
             ("note_velocity", _VEL))
_TABLES: Dict[torch.device, torch.Tensor] = {}


def _class_table(device: torch.device) -> torch.Tensor:
    """Each token id's class (int64, one entry for every id head 0 can
    give after its shift), made once a device: a host-to-device copy
    every step would wait for the work queued before it."""
    if device not in _TABLES:
        table = torch.zeros(mp.SHIFT[0] + mp.MX_DIM, dtype=torch.long)
        for name, cls in _CLASS_OF:
            table[_R[name].start:_R[name].stop] = cls
        _TABLES[device] = table.to(device)
    return _TABLES[device]


@torch.no_grad()
def decode_bar_steps(model, enc_h: torch.Tensor, bar_embed: torch.Tensor, *,
                     max_steps: int, greedy: bool, temperature: float,
                     generator: Optional[torch.Generator] = None):
    """One target bar's typed decode loop (shared by
    ``generate_arrangement`` and the serving engine). enc_h: [L, B, H],
    the encoder's hidden entering the bar; bar_embed: [B] int bar-position
    ids (per-row bar cursors in the serving pool). Returns (tokens [B,
    max_steps, 3] int64, valid [B, max_steps, 3] bool, dec_h [L, B, H]),
    all on the device."""
    dev = enc_h.device
    b = enc_h.shape[1]
    sp = SamplingParams(temperature=max(temperature, 1e-6), greedy=greedy)
    table = _class_table(dev)
    bar_embed = bar_embed.to(dev, torch.long)
    zeros = torch.zeros(b, dtype=torch.long, device=dev)
    compound = torch.stack([bar_embed, zeros + mp.POS0, zeros, zeros,
                            zeros + mp.BAR_TOKEN, zeros, zeros], dim=-1)
    pos, cls_, val, vel = zeros, zeros, zeros, zeros
    track = zeros - 1
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    h = enc_h
    tokens = torch.empty(max_steps, b, 3, dtype=torch.long, device=dev)
    valid = torch.empty(max_steps, b, 3, dtype=torch.bool, device=dev)
    for i in range(max_steps):
        logits, h_next = model.decode_compound_step(compound, h)
        etype = sample_logits(logits[:, 0], sp, generator) + mp.SHIFT[0]
        pitch = (sample_logits(logits[:, 1], sp, generator)
                 + torch.where(track == _DRUM_ID, 128, 0) + mp.SHIFT[1])
        dur = sample_logits(logits[:, 2], sp, generator) + mp.SHIFT[2]
        cls = table[etype]
        active = ~done
        is_vel = (cls == _VEL) & active
        pos = torch.where((cls == _POS) & active, etype, pos)
        cls_ = torch.where((cls == _CLS) & active, etype, cls_)
        val = torch.where((cls == _VAL) & active, etype, val)
        # chord and track land in the velocity slot (network.py:271-281)
        vel = torch.where(((cls == _CHD) | (cls == _TRK) | (cls == _VEL))
                          & active, etype, vel)
        track = torch.where((cls == _TRK) & active, etype, track)
        compound = torch.stack([bar_embed, pos, cls_, val, vel,
                                torch.where(is_vel, pitch, 0),
                                torch.where(is_vel, dur, 0)], dim=-1)
        emit1 = active & (cls != _BAR)
        emit23 = emit1 & is_vel
        tokens[i] = torch.stack([etype, pitch, dur], dim=-1)
        valid[i] = torch.stack([emit1, emit23, emit23], dim=-1)
        # a done row keeps its bar-end h; the bar-token step's own update
        # is kept (done was False entering it)
        h = torch.where(done[None, :, None], h, h_next)
        done = done | (cls == _BAR)
    return tokens.transpose(0, 1), valid.transpose(0, 1), h


@torch.no_grad()
def generate_arrangement(model, init, src, src_len, n_target_bar: int,
                         max_steps: int = 200, greedy: bool = True,
                         temperature: float = 1.0,
                         generator: Optional[torch.Generator] = None):
    """init [B, init_dim], src [B, bars, S, 7] compound melody, src_len
    [B, bars] (arrays or tensors on any device) -> (tokens [B,
    n_target_bar, max_steps, 3] int64, valid [B, n_target_bar, max_steps,
    3] bool) on the model's device. Bar k >= bars re-reads the last
    melody bar (the JAX ``dynamic_index_in_dim`` clamp). ``generator``: a
    ``torch.Generator`` on the model's device for sampled draws."""
    dev = model.device
    init = torch.as_tensor(init, dtype=torch.float32, device=dev)
    src = torch.as_tensor(src, device=dev).long()
    src_len = torch.as_tensor(src_len, device=dev).long()
    b, bars = src.shape[0], src.shape[1]
    hidden = model.init_to_hidden(init)
    src_e = model.compression(src)
    tokens, valid = [], []
    for k in range(n_target_bar):
        kk = min(k, bars - 1)
        enc_h = model.encode_bar(src_e[:, kk], hidden, src_len[:, kk])
        bar_embed = torch.full((b,), min(k, model.bar_dim - 1)
                               + mp.EVENT_DIM, dtype=torch.long, device=dev)
        tok, val, dec_h = decode_bar_steps(
            model, enc_h, bar_embed, max_steps=max_steps, greedy=greedy,
            temperature=temperature, generator=generator)
        hidden = enc_h + dec_h                         # network.py:414
        tokens.append(tok)
        valid.append(val)
    return torch.stack(tokens, dim=1), torch.stack(valid, dim=1)


def flatten_arrangement(tokens, valid) -> List[np.ndarray]:
    """(tokens, valid) [B, bars, steps, 3] -> one 1-D int64 token array a
    batch row; each bar's stream starts with a bar token
    (network.py:226-228)."""
    tokens = np.asarray(tokens.cpu() if torch.is_tensor(tokens) else tokens)
    valid = np.asarray(valid.cpu() if torch.is_tensor(valid) else valid)
    out = []
    for bi in range(tokens.shape[0]):
        seq = []
        for k in range(tokens.shape[1]):
            seq.append(mp.BAR_TOKEN)
            # row-major over (step, field): the emission order
            seq.extend(int(x) for x in tokens[bi, k][valid[bi, k]])
        out.append(np.asarray(seq, np.int64))
    return out


def generate_arrangement_dp(model, init, src, src_len, n_target_bar: int,
                            mesh, max_steps: int = 200, greedy: bool = True,
                            temperature: float = 1.0, seed: int = 0):
    """Data-parallel arrangement (JAX ``generate_arrangement_dp``): the
    batch's rows (independent latents and melodies) split over the data
    shards of a virtual ``mesh``, each shard running
    ``generate_arrangement`` on its rows (kernel D at B / dp rows) with
    ``engine.shard_generator(seed, i)``. Greedy rows equal the unsharded
    call's. B must divide by the data axis."""
    init = torch.as_tensor(init, dtype=torch.float32)
    src, src_len = torch.as_tensor(src), torch.as_tensor(src_len)
    return run_data_parallel(
        model, mesh, seed, init.shape[0],
        lambda m, r, gen: generate_arrangement(
            m, init[r], src[r], src_len[r], n_target_bar,
            max_steps=max_steps, greedy=greedy, temperature=temperature,
            generator=gen))
