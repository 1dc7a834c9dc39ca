"""Window sampling and padded batching over token arrays.

A copy of ``musicgeneration_tpu/data/batching.py`` (numpy only), so the
port's batches are byte-equal to the JAX package's for the same RNG.

Parity targets:
* Event_Dataset.batches — the full (file, window-start) index list with a
  stride (mg/model/utils/data.py:74-78) and the SegBatchify time-major
  [window, batch] stacking (data.py:104-123),
* Data.slide_seq2seq_batch — sample files, crop length+1 at a random
  offset, x=[:-1], y=[1:] (mg/model/MusicTransformer/data.py:42-67),
* SeqBatchify — sort-by-length descending, zero-pad, labels = shifted
  unpadded tails (data.py:23-36).

All outputs are numpy, with fixed shapes per config.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def window_indices(seq_lens: Sequence[int], window: int,
                   stride: int) -> np.ndarray:
    """[(seq_idx, start)] for every window position in every sequence
    (Event_Dataset.batches, data.py:74-78).

    Quirk-faithful: the reference uses `range(0, n - window, stride)` —
    an EXCLUSIVE stop — so a sequence of exactly `window` tokens yields
    zero windows and a tail window landing exactly at n - window is
    dropped. Reproduced, as the JAX package does."""
    out = []
    for i, n in enumerate(seq_lens):
        for start in range(0, n - window, stride):
            out.append((i, start))
    return np.asarray(out, np.int64).reshape(-1, 2)


def gather_windows(seqs: Sequence[np.ndarray], indices: np.ndarray,
                   window: int, time_major: bool = True) -> np.ndarray:
    """Materialize [window, batch] (time-major, SegBatchify parity) or
    [batch, window] token blocks."""
    batch = np.stack([
        np.asarray(seqs[i][s:s + window]) for i, s in indices
    ])  # [batch, window]
    return batch.T if time_major else batch


def slide_seq2seq_batch(
    seqs: Sequence[np.ndarray], batch_size: int, length: int,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random files + random crops of length+1; x/y shifted views
    (MusicTransformer/data.py:42-67). Returns ([B, L], [B, L]) int32."""
    eligible = [s for s in seqs if len(s) > length]
    if not eligible:
        raise ValueError(f"no sequence longer than {length}")
    picks = rng.randint(0, len(eligible), batch_size)
    data = np.zeros((batch_size, length + 1), np.int32)
    for row, pick in enumerate(picks):
        s = eligible[pick]
        start = rng.randint(0, len(s) - length)
        data[row] = s[start:start + length + 1]
    return data[:, :-1], data[:, 1:]


@dataclasses.dataclass
class SeqBatch:
    tokens: np.ndarray   # [B, L_max] zero-padded
    lengths: np.ndarray  # [B]
    labels: np.ndarray   # concat of shifted unpadded tails


def pad_and_batch_sequences(seqs: Sequence[np.ndarray],
                            pad_to: int | None = None) -> SeqBatch:
    """SeqBatchify parity (data.py:23-36): sort by length descending,
    zero-pad, labels = concatenation of each sequence's tokens[1:]."""
    order = np.argsort([-len(s) for s in seqs], kind="stable")
    ss = [np.asarray(seqs[i], np.int64) for i in order]
    lengths = np.asarray([len(s) for s in ss], np.int32)
    l_max = pad_to or int(lengths.max())
    tokens = np.zeros((len(ss), l_max), np.int32)
    for i, s in enumerate(ss):
        tokens[i, :len(s)] = s
    labels = np.concatenate([s[1:] for s in ss]).astype(np.int32)
    return SeqBatch(tokens=tokens, lengths=lengths, labels=labels)


def add_noise(inputs: np.ndarray, pad_id: int, rate: float = 0.01,
              rng: np.random.RandomState | None = None) -> np.ndarray:
    """Random token corruption (reference MusicTransformer/data.py:125-133):
    replace `rate` of each row's positions with uniform tokens < pad_id.
    Returns a corrupted copy (the reference mutates in place)."""
    rng = rng or np.random.RandomState()
    out = np.array(inputs, copy=True)
    seq_len = out.shape[-1]
    num_mask = int(rate * seq_len)
    if num_mask == 0:
        return out
    for row in out.reshape(-1, seq_len):
        idx = rng.choice(seq_len, size=num_mask, replace=False)
        row[idx] = rng.randint(0, pad_id, size=num_mask)
    return out
