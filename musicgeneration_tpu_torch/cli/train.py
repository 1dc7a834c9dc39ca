"""Train any family the port runs on a tokenized corpus.

    python -m musicgeneration_tpu_torch.cli.train <shard_dir> \\
        model=music_transformer steps=2000 ckpt_dir=runs/mt \\
        model.dtype=bfloat16 [--device cuda]

The port of ``musicgeneration_tpu.cli.train``. Each family trains on the
corpus ``cli.tokenize`` wrote for it:

* ``model=music_transformer`` on a ``midilike``, ``midilike_control``,
  ``remi``, ``pedal`` or ``melody`` corpus (vocabulary 309, 309, 337, 390
  and 131: the codec's ids and a pad id on top; the pedal codec's own
  PAD 388 and EOS 389 are ids of the model's vocabulary, and the loss
  ignores id 389): ``slide_seq2seq`` crops, label-smoothed CE, Noam
  warmup (causal masking only, ``pad_in_input=False``: crops hold no pad
  id). ``distill_from=<run>`` trains it against a frozen teacher, a
  ``cli.train`` MusicTransformer run of the same scheme and seq_len:
  loss = (1 - distill_alpha) * smoothed CE + distill_alpha * T^2 *
  KL(teacher_T || student_T), T = ``distill_temp``, the KL averaged over
  the positions whose label is not the pad id. The recipe for a
  ``cli.generate --spec`` draft: ``model.num_layers=2 model.d_model=128
  distill_from=<target run>`` on the target's corpus (with the target's
  ``model.max_seq`` where its run set one, so that the draft's cache is
  as long as the target's);
* ``model=cp_transformer`` on a ``cp`` corpus: random crops of seq_len +
  1 compound rows (max_seq = seq_len), the weighted mean CE of the 8
  field heads (``cp_head_weights``, normalised to mean 1);
* ``model=popmag`` on a ``mumidi`` corpus: melody/arrangement pairs cut
  at ``max_bars`` and at the first bar longer than ``max_bar_len`` (the
  arrangement's ``max_bar_len - 1``), packed to [B, max_bars,
  max_bar_len, 7], the masked 3-head CE (``popmag_masked_loss``);
* ``model=event_rnn`` and ``model=performance_rnn`` on any flat token
  corpus, ``midilike``, ``remi``, ``pedal`` or ``melody`` (event_dim =
  the scheme's vocabulary less the pad id, as the JAX CLI sets it: 308,
  336, 389 and 129), the target the whole input: row t predicts token t
  from the primary event and tokens [:t] (reference
  Event_MelodyRNN/train.py:340); and ``model=performance_rnn`` on a
  ``midilike_control`` corpus, random crops of aligned tokens and
  per-event controls (24 wide, recovered from the stored 13 bytes);
* ``model=melody_rnn`` on a ``melody`` corpus (note arrays, vocabulary
  130; ``model.attn_length=40`` for the attention variant): crops, CE on
  the shifted tokens. Another scheme exits: its ids would index past the
  130-row embedding, which the JAX CLI builds whatever the scheme.

The RNN families train with plain CE and Adam at a fixed 1e-3 unless
``peak_lr`` says otherwise, f32 unless ``model.dtype=bfloat16``, the GRU
families from a normal latent [B, init_dim] drawn per micro-batch from
the step's generator (the dropout masks follow from it).

``train_mode`` (JAX ``cli/train.py:36-50``): ``crop`` (the default);
``segment`` (windows of the shortest file's length, capped at seq_len +
1, stride a third of it, shuffled per epoch; reference Event_MelodyRNN
train.py:311-325); ``window`` (``window_size``/``stride_size`` windows,
the loss on the whole window; with ``teacher_forcing_ratio`` < 1,
scheduled sampling: one Bernoulli draw a step, shared by the batch,
feeds the ground truth or the model's own argmax); ``sequence`` (whole
files, length-sorted and padded to ``seq_pad_to``, default the longest
file, the masked CE over positions 1 <= t < len; EventMelodyRNN only).
``window`` and ``sequence`` are for the unconditioned GRU families;
the CP transformer, PoPMAG and conditioned PerformanceRNN keep their
own streams in any mode. Every stream is a pure function of (seed,
batch index) and equals the JAX CLI's bit for bit, across epochs too.

Dotted overrides (bare keys set ``TrainCLIConfig``, ``model.<field>``
the model constructor), the counter-indexed batch stream (step s
consumes batch s, so a resumed run replays the uninterrupted run's
batches), auto-resume from ``ckpt_dir`` with a warning when the seed
changed, Adam and the optax clip (train/trainer.py). Runs on ``--device
cuda`` unless told otherwise; a missing GPU is an error.

Checkpoints (``ckpt_dir/step-<N>.pt``, utils/checkpoint.py) carry the
model under the reference names (MelodyRNN: ``models/melody_rnn.py``)
and the run's config, its ``scheme`` and ``model_kwargs`` among it;
``cli.generate`` and ``cli.serve`` read the directory.

Mesh training (the MusicTransformer; the JAX CLI's, :774-795):
``dp=N`` splits every batch's rows over N data shards, ``sp=M`` cuts
every crop (or segment window) into M sequence shards and runs
attention as the ring (``attention_impl="ring"``, ``parallel/``), ``tp=K``
runs every layer, the embedding and the head on K head shards
(``parallel/tensor_parallel.py``: each rank holds num_heads / K heads,
ffn_dim / K hidden units, d_model / K embedding columns), ``pp=P`` cuts
the layers into P pipeline stages run as GPipe over
``pp_microbatches`` micro-batches (0: P; ``parallel/pipeline.py``), and
``fsdp=true`` shards parameter and Adam-state storage over the data
shards (FSDP2; ``train/trainer.py``). One process per shard, dp x sp x
tp x pp of them, started with ``torchrun``:

    torchrun --nproc-per-node 4 -m musicgeneration_tpu_torch.cli.train \\
        <shard_dir> dp=2 tp=2 ...

which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` (a single process with ``fsdp=true`` or ``dp=1`` and
none of them set trains unsharded, as JAX does on one device). dp
defaults to WORLD_SIZE / (sp * tp * pp), and the product must equal
WORLD_SIZE; each rank runs on ``cuda:LOCAL_RANK`` over NCCL (``--device
cpu``: gloo). Rank r is shard (d, s, m, p) with r = ((d * sp + s) * tp +
m) * pp + p, as JAX lays out its mesh: every rank reads the same global
batch stream and takes rows ``[d, d + 1) * B / dp`` of each of the
``accum_steps`` micro-batches (where dp does not divide batch_size, its
even share of the accumulated rows) and columns ``[s, s + 1) * W / sp``
of the batch's width W (seq_len for a crop, ``window - 1`` for a
segment window), so the global batch is the one-process run's, bit for
bit; batch_size * accum_steps must divide by dp, seq_len by sp, and in
segment mode the window's inputs by sp (a window cut short by the
shortest file may not: that run exits before any process group forms,
naming the window and the file's length); with pp,
batch_size by pp_microbatches and the micro-batch by dp, num_layers by
pp; with tp, num_heads and ffn_dim by tp. pp composes with dp only.
Losses are global means, as the one-process step's. Rank 0 alone writes
checkpoints (in the one-device layout, gathered over every axis, so a
run resumes with another mesh and ``cli.generate`` reads it as it is),
``meta.json``, the metrics file and the profile, every rank prints its
step lines, and every rank resumes from ``ckpt_dir``. ``distill_from``
composes with dp, tp and fsdp, not with sp or pp.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import itertools
import json
import os
import sys
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..utils.config import Config, apply_overrides

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# model.<field> overrides each family takes
_MODEL_KEYS = {
    "music_transformer": ("vocab_size", "num_layers", "d_model", "max_seq",
                          "head_dim", "ffn_dim", "dtype", "dropout_rate",
                          "pad_in_input", "logits_dtype", "remat",
                          "decode_quant"),
    "cp_transformer": ("num_layers", "d_model", "max_seq", "dtype",
                       "dropout_rate", "decode_quant"),
    "popmag": ("event_dim", "bar_dim", "init_dim", "embed_dim",
               "hidden_dim", "num_layers", "dropout_rate", "dtype"),
    "event_rnn": ("event_dim", "init_dim", "hidden_dim", "num_layers",
                  "dropout_rate", "dtype"),
    "performance_rnn": ("event_dim", "control_dim", "init_dim",
                        "hidden_dim", "num_layers", "dropout_rate",
                        "dtype"),
    "melody_rnn": ("vocab_size", "embed_size", "hidden_dim", "num_layers",
                   "dropout_rate", "attn_length", "dtype"),
}
_GRU_FAMILIES = ("event_rnn", "performance_rnn")
TRAIN_MODES = ("crop", "segment", "window", "sequence")


@dataclasses.dataclass
class TrainCLIConfig(Config):
    model: str = "music_transformer"
    steps: int = 1000
    batch_size: int = 8
    seq_len: int = 512            # LM crop length (reference max_seq)
    train_mode: str = "crop"      # crop | segment | window | sequence
    window_size: int = 200        # window mode (Event_MelodyRNN/config.py:20)
    stride_size: int = 10
    # window-mode scheduled sampling: the probability that a step's next
    # input is the ground truth rather than the model's own argmax; 1.0
    # (the reference's config, config.py:22) is pure teacher forcing
    teacher_forcing_ratio: float = 1.0
    seq_pad_to: Optional[int] = None  # sequence mode (default: longest)
    # draft distillation (music_transformer): a frozen teacher run's
    # token distributions; loss = (1 - alpha) * smoothed CE + alpha *
    # T^2 * KL(teacher_T || student_T). Train-time only: the CLIs that
    # rebuild a run ignore a recorded teacher path.
    distill_from: Optional[str] = None
    distill_alpha: float = 0.5
    distill_temp: float = 1.0
    accum_steps: int = 1
    label_smoothing: float = 0.1
    warmup_steps: int = 4000
    peak_lr: Optional[float] = None   # fixed LR (RNN families: 1e-3)
    max_grad_norm: float = 1.0
    seed: int = 42
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 500
    log_every: int = 10
    eval_every: int = 0
    eval_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    profile_dir: Optional[str] = None
    profile_steps: int = 5        # traced steps [10, 10 + profile_steps)
    # -- mesh training (music_transformer; parallel/mesh.py): one process
    # per shard. dp = data parallel (defaults to WORLD_SIZE / (sp*tp*pp)),
    # tp = tensor parallel (head shards), sp = sequence parallel (switches
    # attention to the ring), fsdp = storage sharded over the data shards,
    # pp = pipeline stages (GPipe over pp_microbatches micro-batches per
    # train(-accum) batch, 0 -> pp); pp composes with dp only
    dp: Optional[int] = None
    tp: int = 1
    sp: int = 1
    fsdp: bool = False
    pp: int = 1
    pp_microbatches: int = 0
    # CP per-head loss weights, in tokenizers/cp field order (family,
    # position, tempo_class, tempo_value, chord, pitch, duration,
    # velocity), normalised to mean 1; None = equal
    cp_head_weights: Optional[tuple] = None
    # PoPMAG bucketing: every batch is [B, max_bars, max_bar_len, 7]
    max_bars: int = 16
    max_bar_len: int = 96


# the schemes the MusicTransformer trains on (a flat token stream each)
LM_SCHEMES = ("midilike", "midilike_control", "remi", "pedal", "melody")


def _default_vocab(scheme: str, model: str) -> int:
    """The vocabulary the JAX CLI derives from the scheme (its
    ``_default_vocab``; reference MusicTransformer/config.py:11-16): the
    codec's dim + 1 pad for the MIDI-like schemes and REMI (309, 337),
    the pedal codec's 388 + pad + eos (390), the 130 note-array ids for
    ``melody``; a scheme without a flat token stream exits, naming
    ``model``."""
    if scheme in ("midilike", "midilike_control"):
        from ..tokenizers.midilike import EventSeq
        return EventSeq.dim() + 1
    if scheme == "remi":
        from ..tokenizers.remi import REMI_EventSeq
        return REMI_EventSeq.dim() + 1
    if scheme == "pedal":
        from ..tokenizers import pedal_midilike
        return pedal_midilike.VOCAB_SIZE + 2
    if scheme == "melody":
        from ..tokenizers.melody import MELODY_VOCAB
        return MELODY_VOCAB
    raise SystemExit(f"model={model} trains on a flat token corpus, one of "
                     f"{list(LM_SCHEMES)}; this one is {scheme!r}")


def lm_vocab(scheme: str) -> int:
    """The MusicTransformer's vocabulary on ``scheme`` (the JAX CLI's
    :454-463): the scheme's default, and on ``melody`` a pad id over the
    130 note-array ids, which are all meaningful (129 = no event)."""
    return _default_vocab(scheme, "music_transformer") + (scheme == "melody")


def _batch_rng(seed: int, idx: int, tag: int = 0) -> np.random.RandomState:
    """Counter-based per-batch RNG: batch ``idx`` is a pure function of
    (seed, idx), so a resumed run regenerates exactly the batch an
    uninterrupted run would consume at the same step (the JAX CLI's
    stream, cli/train.py:121-130)."""
    ss = np.random.SeedSequence([int(seed), int(tag), int(idx)])
    return np.random.RandomState(ss.generate_state(4))


def _indexed_stream(batch_at, start: int = 0) -> Iterator:
    """batch_at(start), batch_at(start + 1), ... : step s consumes batch
    index s (the resume cursor is the step number itself)."""
    return (batch_at(i) for i in itertools.count(start))


def _lm_batch_fn(corpus, cfg: TrainCLIConfig):
    """slide_seq2seq_batch stream (MusicTransformer/data.py:63-67),
    indexed by batch number."""
    from ..data.batching import slide_seq2seq_batch

    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        return slide_seq2seq_batch(seqs, b, cfg.seq_len,
                                   _batch_rng(cfg.seed, idx))

    return batch_at


def segment_window(lens, seq_len: int) -> int:
    """Segment mode's window: the shortest sequence's length, capped at
    seq_len + 1 (its inputs are the first window - 1 tokens)."""
    return min(min(lens), seq_len + 1)


def _segment_batch_fn(corpus, cfg: TrainCLIConfig):
    """Segment mode (reference Event_MelodyRNN train.py:311-325): window
    = the shortest sequence's length, capped at seq_len + 1, stride
    window // 3, the whole (file, start) list shuffled per epoch. Batch
    idx maps to (epoch, position); the epoch's permutation comes from
    (seed, epoch), so a resumed run lands mid-epoch on the window the
    uninterrupted run would see. Returns (x, y): the windows' [:-1] and
    [1:]."""
    from ..data.batching import gather_windows, window_indices

    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    lens = [len(s) for s in seqs]
    window = segment_window(lens, cfg.seq_len)
    stride = max(window // 3, 1)
    indices = window_indices(lens, window, stride)
    b = cfg.batch_size * cfg.accum_steps
    if len(indices) < b:
        raise ValueError(
            f"segment mode: only {len(indices)} windows (window={window}, "
            f"stride={stride}) for batch {b}: corpus too small (the "
            "reference's indexing yields no window for the shortest file, "
            "data.py:77's exclusive stop)")
    # batches per epoch, as range(0, len(order) - b + 1, b)
    per_epoch = (len(indices) - b) // b + 1

    def batch_at(idx: int):
        epoch, pos = divmod(idx, per_epoch)
        order = _batch_rng(cfg.seed, epoch, tag=1).permutation(len(indices))
        sel = indices[order[pos * b:pos * b + b]]
        batch = gather_windows(seqs, sel, window,
                               time_major=False).astype(np.int32)
        return batch[:, :-1], batch[:, 1:]

    return batch_at


def _window_batch_fn(corpus, cfg: TrainCLIConfig):
    """Window mode (reference Event_MelodyRNN train.py:209-218): fixed
    ``window_size``/``stride_size`` windows over every file, shuffled per
    epoch, the last partial batch dropped. Returns (x, y), both the
    whole window: the model drops the last input itself and the loss
    covers the window (train.py:233)."""
    from ..data.batching import gather_windows, window_indices

    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    w = cfg.window_size
    indices = window_indices([len(s) for s in seqs], w, cfg.stride_size)
    b = cfg.batch_size * cfg.accum_steps
    if len(indices) < b:
        raise ValueError(
            f"window mode: only {len(indices)} windows (window_size={w}, "
            f"stride_size={cfg.stride_size}) for batch {b}: corpus too "
            "small (data.py:77's exclusive stop drops exactly fitting "
            "tails)")
    per_epoch = (len(indices) - b) // b + 1

    def batch_at(idx: int):
        epoch, pos = divmod(idx, per_epoch)
        order = _batch_rng(cfg.seed, epoch, tag=1).permutation(len(indices))
        sel = indices[order[pos * b:pos * b + b]]
        batch = gather_windows(seqs, sel, w, time_major=False).astype(
            np.int32)
        return batch, batch

    return batch_at


def _sequence_batch_fn(corpus, cfg: TrainCLIConfig):
    """Sequence mode (reference Event_MelodyRNN train.py:263-272): whole
    sequences, shuffled per epoch, the last partial batch dropped, each
    batch sorted by length, descending, and zero-padded to one length
    (``seq_pad_to``, default the longest sequence: SeqBatchify,
    data.py:23-36). Returns ({"tokens" [B, pad], "lengths" [B]}, a dummy
    [B] target)."""
    from ..data.batching import pad_and_batch_sequences

    seqs = [np.asarray(corpus[i]) for i in range(len(corpus))]
    max_len = max(len(s) for s in seqs)
    pad_to = cfg.seq_pad_to or max_len
    if max_len > pad_to:
        raise ValueError(
            f"sequence mode: longest corpus sequence ({max_len}) exceeds "
            f"seq_pad_to={pad_to}; raise it (cutting whole sequences would "
            "change the reference semantics)")
    b = cfg.batch_size * cfg.accum_steps
    if len(seqs) < b:
        raise ValueError(f"sequence mode: {len(seqs)} sequences < batch {b} "
                         "(no batch once the last partial one is dropped)")
    per_epoch = len(seqs) // b

    def batch_at(idx: int):
        epoch, pos = divmod(idx, per_epoch)
        order = _batch_rng(cfg.seed, epoch, tag=2).permutation(len(seqs))
        pick = order[pos * b:pos * b + b]
        sb = pad_and_batch_sequences([seqs[i] for i in pick], pad_to=pad_to)
        return ({"tokens": sb.tokens, "lengths": sb.lengths},
                np.zeros((b,), np.int32))

    return batch_at


def _control_batch_fn(corpus, cfg: TrainCLIConfig):
    """Aligned random crops of tokens and controls for PerformanceRNN on
    a ``midilike_control`` corpus (the JAX CLI's ``_control_batch_fn``).
    Returns ({"tokens" [B, L], "controls" [B, L, 24] f32}, tokens): the
    target is the crop itself."""
    from ..tokenizers.midilike import ControlSeq

    pairs = []
    for i in range(len(corpus)):
        toks = np.asarray(corpus[i])
        ctrl = np.asarray(corpus.pair(i, "controls"), np.uint8).reshape(-1,
                                                                         13)
        if len(toks) > cfg.seq_len:
            pairs.append((toks, ctrl))
    if not pairs:
        raise ValueError(f"no sequence longer than {cfg.seq_len}")
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        rng = _batch_rng(cfg.seed, idx)
        xs = np.zeros((b, cfg.seq_len), np.int32)
        cs = np.zeros((b, cfg.seq_len, ControlSeq.dim()), np.float32)
        for row in range(b):
            toks, ctrl = pairs[rng.randint(0, len(pairs))]
            start = rng.randint(0, len(toks) - cfg.seq_len)
            xs[row] = toks[start:start + cfg.seq_len]
            cs[row] = ControlSeq.recover_compressed_array(
                ctrl[start:start + cfg.seq_len])
        return {"tokens": xs, "controls": cs}, xs

    return batch_at


def _cp_batch_fn(corpus, cfg: TrainCLIConfig):
    """Random crops of seq_len + 1 compound rows (the shards store the
    [T, 8] rows flattened), indexed by batch number: x the first seq_len
    rows, y the last (the JAX CLI's ``_cp_batch_fn``)."""
    from ..tokenizers.cp import WIDTH

    seqs = [np.asarray(corpus[i]).reshape(-1, WIDTH)
            for i in range(len(corpus))]
    seqs = [s for s in seqs if len(s) > cfg.seq_len]
    if not seqs:
        raise ValueError(f"no CP sequence longer than {cfg.seq_len} rows")
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        rng = _batch_rng(cfg.seed, idx)
        xs = np.zeros((b, cfg.seq_len + 1, WIDTH), np.int32)
        for row in range(b):
            s = seqs[rng.randint(0, len(seqs))]
            start = rng.randint(0, len(s) - cfg.seq_len)
            xs[row] = s[start:start + cfg.seq_len + 1]
        return xs[:, :-1], xs[:, 1:]

    return batch_at


def _popmag_batch_fn(corpus, cfg: TrainCLIConfig):
    """Melody/arrangement pairs of a ``mumidi`` corpus, packed per batch
    index (the JAX CLI's ``_popmag_batch_fn``): each pair is cut at
    ``max_bars`` and at its first overlong bar (clipping inside a bar
    would cut compound groups mid-way; the arrangement keeps one slot for
    the trailing bar token ``pack_batch`` appends). Returns ``batch_at``
    giving (x, y): x the packed batch as a dict of arrays, y a dummy."""
    from ..data.mumidi_packing import pack_batch
    from ..tokenizers.mumidi import MuMIDI_EventSeq

    seg = MuMIDI_EventSeq.segmentation
    pairs = []
    for i in range(len(corpus)):
        mel = seg(np.asarray(corpus.pair(i, "melody"), np.int64))
        arr = seg(np.asarray(corpus.pair(i, "arrangement"), np.int64))
        n = min(len(mel), len(arr), cfg.max_bars)
        for k in range(n):
            if (len(mel[k]) > cfg.max_bar_len
                    or len(arr[k]) > cfg.max_bar_len - 1):
                n = k
                break
        if n:
            pairs.append((list(mel[:n]), list(arr[:n])))
    if not pairs:
        raise ValueError("no usable melody/arrangement pairs in corpus")
    b = cfg.batch_size * cfg.accum_steps

    def batch_at(idx: int):
        picks = _batch_rng(cfg.seed, idx).randint(0, len(pairs), b)
        batch = pack_batch([pairs[p] for p in picks],
                           pad_bars_to=cfg.max_bars,
                           pad_len_to=cfg.max_bar_len)
        return dataclasses.asdict(batch), np.zeros(b, np.int32)

    return batch_at


def popmag_loss_fn(init_dim: int):
    """The PoPMAG objective (the JAX CLI's loss): a normal latent [B,
    init_dim] drawn from the micro-batch's generator, the training
    forward with dropout from the same generator, and
    ``popmag_masked_loss`` over the packed labels. Returns ``loss_fn(model,
    x, y, generator) -> (loss, accuracy)`` for ``make_train_step``."""
    from ..train.objective import popmag_masked_loss

    def loss_fn(model, x, y, generator):
        src = x["src"]
        init = torch.randn(src.shape[0], init_dim, generator=generator,
                           device=src.device)
        logits = model(init, src, x["src_len"], x["tar"], x["tar_len"],
                       deterministic=False, generator=generator)
        return popmag_masked_loss(logits, x["labels"], x["label_mask"])

    return loss_fn


def cp_loss_fn(head_weights: Optional[tuple], n_heads: int):
    """The CP objective (the JAX CLI's ``cp_loss_fn``): the weighted mean
    over the 8 field heads of each head's mean cross-entropy, the weights
    normalised to mean 1 (equal when None), and the mean of the heads'
    accuracies. Returns ``loss_fn(model, x, y, generator) -> (loss,
    accuracy)`` for ``make_train_step``."""
    if head_weights is None:
        head_w = (1.0,) * n_heads
    else:
        if len(head_weights) != n_heads:
            raise ValueError(f"cp_head_weights needs {n_heads} entries "
                             f"(got {len(head_weights)})")
        w = np.asarray(head_weights, np.float32)
        head_w = tuple(float(x) for x in (w / w.mean()))

    def loss_fn(model, x, y, generator):
        logits = model(x, deterministic=False, generator=generator)
        loss = acc = 0.0
        for i, lg in enumerate(logits):
            tgt = y[..., i].long()
            lp = torch.log_softmax(lg, dim=-1)
            loss = loss + head_w[i] * -torch.gather(
                lp, -1, tgt[..., None]).mean()
            acc = acc + (lg.argmax(-1) == tgt).float().mean()
        return loss / len(logits), acc / len(logits)

    return loss_fn


def gru_objective(model, tokens, init, controls=None,
                  deterministic: bool = True, generator=None):
    """The GRU families' teacher-forced loss on a [B, L] batch (the JAX
    CLI's ``apply_fn`` and default objective): logits row t predicts
    tokens[t] from the primary event and tokens[:t] (EventMelodyRNN's
    extra last row dropped), plain mean CE over every token. controls:
    PerformanceRNN's [B, L, C] or None. Returns (loss, accuracy)."""
    from ..train.objective import smooth_cross_entropy, token_accuracy

    args = (init, tokens.T) if controls is None else (
        init, tokens.T, controls.transpose(0, 1))
    logits = model(*args, deterministic=deterministic, generator=generator)
    if logits.shape[0] == tokens.shape[1] + 1:
        logits = logits[:-1]
    logits = logits.transpose(0, 1)
    return (smooth_cross_entropy(logits, tokens, model.event_dim, 0.0),
            token_accuracy(logits, tokens))


def sequence_objective(model, tokens, lengths, init,
                       deterministic: bool = True, generator=None):
    """Sequence mode's loss (the JAX CLI's ``seq_loss_fn``; reference
    Event_MelodyRNN/train.py:285-295): the padded batch through the
    packed-sequence forward, mean CE over the positions 1 <= t <
    lengths[b] (the labels are each sequence's tokens[1:len]), and the
    accuracy over the same positions. Returns (loss, accuracy)."""
    logits = model(init, tokens.T, lengths=lengths,
                   deterministic=deterministic, generator=generator)
    logits = logits[:-1].transpose(0, 1).float()            # [B, L, V]
    t_pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    mask = ((t_pos >= 1) & (t_pos < lengths[:, None])).float()
    tok_lp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                          tokens.long()[..., None])[..., 0]
    n = mask.sum().clamp_min(1.0)
    acc = ((logits.argmax(-1) == tokens).float() * mask).sum() / n
    return -(tok_lp * mask).sum() / n, acc


def scheduled_objective(model, tokens, init, draws,
                        deterministic: bool = True, generator=None):
    """Window mode's scheduled-sampling loss (the JAX CLI's
    ``sched_loss_fn``): ``scheduled_sampling_logits`` over the [B, W]
    window with the step draws [W - 1], mean CE over the window. Returns
    (loss, accuracy)."""
    from ..models.event_rnn import scheduled_sampling_logits
    from ..train.objective import smooth_cross_entropy, token_accuracy

    logits = scheduled_sampling_logits(
        model, init, tokens.T, draws, deterministic=deterministic,
        generator=generator).transpose(0, 1)
    return (smooth_cross_entropy(logits, tokens, model.event_dim, 0.0),
            token_accuracy(logits, tokens))


def gru_loss_fn(cfg: TrainCLIConfig, init_dim: int):
    """``loss_fn(model, x, y, generator)`` of a GRU family for
    ``make_train_step``: a normal latent [B, init_dim] drawn from the
    micro-batch's generator (the reference draws a fresh latent a batch,
    Event_MelodyRNN/train.py:334), then, in window mode below a
    teacher-forcing ratio of 1, one Bernoulli draw a step shared by the
    batch; dropout masks from the same generator. The target is the
    input itself (y is ignored)."""
    ratio = float(cfg.teacher_forcing_ratio)

    def latent(tokens, generator):
        return torch.randn(tokens.shape[0], init_dim, generator=generator,
                           device=tokens.device)

    if cfg.train_mode == "sequence":
        def loss_fn(model, x, y, generator):
            tokens = x["tokens"]
            return sequence_objective(model, tokens, x["lengths"],
                                      latent(tokens, generator),
                                      deterministic=False,
                                      generator=generator)
    elif cfg.train_mode == "window" and ratio < 1.0:
        def loss_fn(model, x, y, generator):
            init = latent(x, generator)
            draws = torch.rand(x.shape[1] - 1, generator=generator,
                               device=x.device) < ratio
            return scheduled_objective(model, x, init, draws,
                                       deterministic=False,
                                       generator=generator)
    else:
        def loss_fn(model, x, y, generator):
            tokens, controls = ((x["tokens"], x["controls"])
                                if isinstance(x, dict) else (x, None))
            return gru_objective(model, tokens, latent(tokens, generator),
                                 controls, deterministic=False,
                                 generator=generator)
    return loss_fn


def melody_loss_fn(tcfg):
    """MelodyRNN's ``loss_fn`` (the JAX CLI's time-major ``apply_fn`` and
    default objective): logits of the [B, L] input, plain mean CE on the
    shifted target y."""
    from ..train.objective import smooth_cross_entropy, token_accuracy

    def loss_fn(model, x, y, generator):
        logits = model(x.T, deterministic=False,
                       generator=generator).transpose(0, 1)
        return (smooth_cross_entropy(logits, y, tcfg.vocab_size,
                                     tcfg.label_smoothing, tcfg.pad_id),
                token_accuracy(logits, y, tcfg.pad_id))

    return loss_fn


def distill_loss_fn(tcfg, teacher, alpha: float, temp: float):
    """The distillation objective (the JAX CLI's ``_make_distill_loss``):
    (1 - alpha) * smoothed CE(labels) + alpha * T^2 * KL(teacher_T ||
    student_T), the log-softmaxes in f32, the KL averaged over the
    positions whose label is not ``tcfg.pad_id``. The teacher runs its
    deterministic forward under ``no_grad``. Returns ``loss_fn(model, x,
    y, generator, denom=None) -> (loss, accuracy)`` for
    ``make_train_step``; under a data-parallel mesh ``denom`` is the
    global count of kept labels and every average is this shard's share
    of the global one (JAX takes both over the global batch)."""
    from ..train.objective import smooth_cross_entropy, token_accuracy

    def loss_fn(model, x, y, generator, denom=None):
        s_logits = model(x, deterministic=False, generator=generator)
        with torch.no_grad():
            t_logits = teacher(x, deterministic=True)
        ce = smooth_cross_entropy(s_logits, y, tcfg.vocab_size,
                                  tcfg.label_smoothing, tcfg.pad_id, denom)
        t_lp = torch.log_softmax(t_logits.float() / temp, dim=-1)
        s_lp = torch.log_softmax(s_logits.float() / temp, dim=-1)
        kl = (t_lp.exp() * (t_lp - s_lp)).sum(-1)
        mask = ((y != tcfg.pad_id) if tcfg.pad_id is not None
                else torch.ones_like(y, dtype=torch.bool)).float()
        n = mask.sum().clamp_min(1.0) if denom is None else denom
        kl = (kl * mask).sum() / n * (temp ** 2)
        return ((1.0 - alpha) * ce + alpha * kl,
                token_accuracy(s_logits, y, tcfg.pad_id, denom))

    return loss_fn


def load_teacher(cfg: TrainCLIConfig, student, device):
    """The frozen teacher of ``cfg.distill_from`` (the JAX CLI's
    ``_load_teacher``): a ``cli.train`` step file or run directory of a
    MusicTransformer trained at the student's seq_len (the relative
    attention tables are max_seq-sized) on the student's vocabulary,
    built as the student is (``build_model``, ``pad_in_input=False``)
    from its recorded config, model_kwargs and dtype, with gradients off
    and in eval mode."""
    from ..utils.checkpoint import restore_checkpoint

    payload = restore_checkpoint(cfg.distill_from)
    meta = payload.get("config") or {}
    if "cli" not in meta:
        raise SystemExit("distill_from checkpoint has no CLI config")
    t_cli = TrainCLIConfig.from_dict(meta["cli"])
    if t_cli.model != "music_transformer":
        raise SystemExit("distill_from must be a music_transformer "
                         "checkpoint")
    if t_cli.seq_len != cfg.seq_len:
        raise SystemExit(
            f"teacher was trained at seq_len={t_cli.seq_len}, "
            f"student at {cfg.seq_len} — they must match (relative "
            "attention position tables are max_seq-sized)")
    teacher, _, _ = build_model(t_cli, meta.get("scheme", "midilike"),
                                dict(meta.get("model_kwargs") or {}),
                                device)
    if teacher.vocab_size != student.vocab_size:
        raise SystemExit(
            f"teacher vocab ({teacher.vocab_size}) != student vocab "
            f"({student.vocab_size}) — distill on the same scheme")
    teacher.load_state_dict(payload["model"], strict=True)
    return teacher.requires_grad_(False).eval()


def build_model(cfg: TrainCLIConfig, scheme: str,
                model_kwargs: Dict[str, Any], device, mesh=None,
                distill: bool = False):
    """(model, trainer config, loss_fn or None for the default objective)
    for ``cfg``; the model's initial weights come from a CPU generator
    seeded with ``cfg.seed``. With a ``mesh`` attention runs as the ring
    over it. The family comes from the model registry; a train mode a
    family does not take exits, as in the JAX CLI (:556-560, :797-806).
    ``distill`` (train time only) turns ``cfg.distill_from`` on: a
    rebuilt run's recorded teacher path is otherwise ignored."""
    from ..models.registry import get_model
    from ..train.trainer import TrainerConfig

    if cfg.model not in _MODEL_KEYS:
        try:
            get_model(cfg.model)
        except KeyError as e:
            raise SystemExit(str(e)) from None
        raise SystemExit(f"the port trains model={', '.join(_MODEL_KEYS)}; "
                         f"{cfg.model} is not ported to cli.train yet")
    if cfg.train_mode not in TRAIN_MODES:
        raise SystemExit(f"unknown train_mode={cfg.train_mode!r}; one of "
                         f"{list(TRAIN_MODES)}")
    if cfg.train_mode == "sequence" and cfg.model != "event_rnn":
        raise SystemExit("train_mode=sequence is the reference "
                         "Event_MelodyRNN path (train.py:263-309): use "
                         "model=event_rnn")
    if cfg.train_mode in ("window", "sequence") and (
            cfg.model not in _GRU_FAMILIES or scheme == "midilike_control"):
        raise SystemExit(
            f"train_mode={cfg.train_mode} is wired for the plain RNN "
            "families (model=event_rnn|performance_rnn on an unconditioned "
            "scheme)")
    if mesh is not None and cfg.model != "music_transformer":
        raise SystemExit("mesh training (dp/tp/sp/pp/fsdp) is wired for "
                         "model=music_transformer")
    cls, defaults = get_model(cfg.model)
    kw = dict(model_kwargs)  # never mutate the caller's dict
    unknown = sorted(set(kw) - set(_MODEL_KEYS[cfg.model]))
    if unknown:
        raise SystemExit(f"unknown model overrides {unknown}; the port's "
                         f"{cfg.model} takes {list(_MODEL_KEYS[cfg.model])}")
    for key in ("dtype", "logits_dtype"):
        if isinstance(kw.get(key), str):
            kw[key] = _DTYPES[kw[key]]
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.model == "popmag":
        if scheme != "mumidi":
            raise SystemExit(f"model=popmag trains on a 'mumidi' corpus "
                             f"(cli.tokenize --scheme mumidi); this one is "
                             f"{scheme!r}")
        model = cls(**kw, device=device, generator=gen)
        tcfg = TrainerConfig(
            vocab_size=0, accum_steps=cfg.accum_steps,
            max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr or 1e-3)
        return model, tcfg, popmag_loss_fn(model.init_dim)
    if cfg.model == "cp_transformer":
        if scheme != "cp":
            raise SystemExit(f"model=cp_transformer trains on a 'cp' corpus "
                             f"(cli.tokenize --scheme cp); this one is "
                             f"{scheme!r}")
        model = cls(**{**defaults(max_seq=cfg.seq_len), **kw},
                    device=device, generator=gen)
        tcfg = TrainerConfig(
            vocab_size=0, label_smoothing=0.0, d_model=model.d_model,
            warmup_steps=cfg.warmup_steps, accum_steps=cfg.accum_steps,
            max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr)
        return model, tcfg, cp_loss_fn(cfg.cp_head_weights,
                                       len(model.field_dims))
    if cfg.model == "melody_rnn":
        if scheme != "melody":
            raise SystemExit(f"model=melody_rnn trains on a 'melody' corpus "
                             f"(cli.tokenize --scheme melody); this one is "
                             f"{scheme!r}")
        vocab = kw.pop("vocab_size", _default_vocab(scheme, cfg.model))
        model = cls(vocab_size=vocab, **kw, device=device, generator=gen)
        tcfg = TrainerConfig(
            vocab_size=vocab, pad_id=None, label_smoothing=0.0,
            accum_steps=cfg.accum_steps, max_grad_norm=cfg.max_grad_norm,
            peak_lr=cfg.peak_lr or 1e-3)
        return model, tcfg, melody_loss_fn(tcfg)
    if cfg.model in _GRU_FAMILIES:
        vocab = kw.pop("event_dim", _default_vocab(scheme, cfg.model) - 1)
        model = cls(event_dim=vocab, **kw, device=device, generator=gen)
        tcfg = TrainerConfig(
            vocab_size=vocab, pad_id=None, label_smoothing=0.0,
            accum_steps=cfg.accum_steps, max_grad_norm=cfg.max_grad_norm,
            peak_lr=cfg.peak_lr or 1e-3)
        return model, tcfg, gru_loss_fn(cfg, model.init_dim)
    vocab = kw.pop("vocab_size", lm_vocab(scheme))
    # not recorded in the checkpoint's model_kwargs
    if mesh is not None and mesh.size > 1:
        kw.update(attention_impl="ring", mesh=mesh)
    elif mesh is not None and mesh.model > 1:
        kw.update(mesh=mesh)
    # crops are dense windows: the training model skips pad masking
    model = cls(**{**defaults(vocab_size=vocab, max_seq=cfg.seq_len),
                   "pad_in_input": False, **kw},
                device=device, generator=gen)
    # the pad id is the vocabulary's last id, as JAX's TrainerConfig
    # sets it: on `pedal` that is 389, the codec's EOS, not its PAD 388
    tcfg = TrainerConfig(
        vocab_size=model.vocab_size, pad_id=model.vocab_size - 1,
        label_smoothing=cfg.label_smoothing, d_model=model.d_model,
        warmup_steps=cfg.warmup_steps, accum_steps=cfg.accum_steps,
        max_grad_norm=cfg.max_grad_norm, peak_lr=cfg.peak_lr)
    if distill and cfg.distill_from:
        teacher = load_teacher(cfg, model, device)
        return model, tcfg, distill_loss_fn(tcfg, teacher, cfg.distill_alpha,
                                            cfg.distill_temp)
    if mesh is not None and mesh.pipe > 1:
        from ..parallel.pipeline import make_pipeline_apply
        return model, tcfg, pipeline_loss_fn(
            tcfg, make_pipeline_apply(model, mesh,
                                      cfg.pp_microbatches or mesh.pipe))
    return model, tcfg, None


def pipeline_loss_fn(tcfg, apply):
    """The LM objective on the pipelined forward ``apply``
    (``make_pipeline_apply``); ``apply`` rides along as ``.apply`` for
    the eval step."""
    from ..train.objective import smooth_cross_entropy, token_accuracy

    def loss_fn(model, x, y, generator, denom=None):
        logits = apply(x, deterministic=False, generator=generator)
        return (smooth_cross_entropy(logits, y, tcfg.vocab_size,
                                     tcfg.label_smoothing, tcfg.pad_id,
                                     denom),
                token_accuracy(logits, y, tcfg.pad_id, denom))

    loss_fn.apply = apply
    return loss_fn


def _parse(argv):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("data_dir", help="tokenized shard directory "
                   "(from cli.tokenize)")
    p.add_argument("overrides", nargs="*", metavar="key=value",
                   help="dotted overrides; bare keys hit TrainCLIConfig, "
                        "'model.<field>' goes to the model constructor")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    model_kwargs: Dict[str, Any] = {}
    plain = []
    for item in args.overrides:
        key, _, value = item.partition("=")
        if key.startswith("model."):
            try:
                model_kwargs[key[6:]] = ast.literal_eval(value)
            except (ValueError, SyntaxError):
                model_kwargs[key[6:]] = value
        else:
            plain.append(item)
    return args, apply_overrides(TrainCLIConfig(), plain), model_kwargs


def init_mesh(cfg: TrainCLIConfig, device_arg: str):
    """The (data, seq, model[, pipe]) mesh ``cfg`` asks for, over a
    process group made from the ``torchrun`` environment, or None for one
    process started without it (``fsdp=true`` or ``dp=1`` there shard
    nothing, as JAX's mesh of one device). Refuses what the JAX CLI
    refuses (:774-791, and its pipeline's :97-100, :197-210), before any
    group forms."""
    from .. import resolve_device
    from ..parallel.mesh import make_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if not (world > 1 or cfg.sp > 1 or cfg.tp > 1 or cfg.pp > 1
            or cfg.fsdp or cfg.dp is not None):
        return None
    if cfg.model != "music_transformer":
        raise SystemExit("mesh training (dp/tp/sp/pp/fsdp) is wired for "
                         "model=music_transformer")
    if cfg.pp > 1 and (cfg.tp > 1 or cfg.sp > 1 or cfg.fsdp):
        raise SystemExit("pp composes with dp only (not tp/sp/fsdp)")
    if cfg.distill_from and (cfg.sp > 1 or cfg.pp > 1):
        raise SystemExit("distill_from composes with dp/fsdp meshes only "
                         "(the teacher forward is an unsharded plain apply)")
    rest = cfg.sp * cfg.tp * cfg.pp
    dp = cfg.dp if cfg.dp is not None else world // rest
    if dp < 1 or dp * rest != world:
        axes = "".join(f" x {k}={v}" for k, v in (
            ("sp", cfg.sp), ("tp", cfg.tp), ("pp", cfg.pp))
            if v > 1 or k == "sp")
        raise SystemExit(
            f"dp={dp}{axes} runs one process per shard, but WORLD_SIZE is "
            f"{world}: start it with torchrun --nproc-per-node "
            f"{max(dp, 1) * rest}")
    if (cfg.batch_size * cfg.accum_steps) % dp:
        raise SystemExit("batch_size*accum_steps must divide dp")
    if cfg.seq_len % cfg.sp:
        raise SystemExit(f"seq_len={cfg.seq_len} is not divisible by "
                         f"sp={cfg.sp}")
    if cfg.pp > 1:
        n_micro = cfg.pp_microbatches or cfg.pp
        if cfg.batch_size % n_micro:
            raise SystemExit(f"batch_size={cfg.batch_size} must divide by "
                             f"pp_microbatches={n_micro}")
        if (cfg.batch_size // n_micro) % dp:
            raise SystemExit(f"microbatch {cfg.batch_size // n_micro} not "
                             f"divisible by data={dp}")
    if cfg.eval_dir and cfg.eval_every and cfg.batch_size % dp:
        raise SystemExit(f"eval batches of batch_size={cfg.batch_size} rows "
                         f"must divide by dp={dp}")
    port = os.environ.get("MASTER_PORT")
    if port is None:
        if world > 1:
            raise SystemExit("WORLD_SIZE > 1 needs MASTER_ADDR and "
                             "MASTER_PORT (torchrun sets them)")
        return None
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", rank))
    device = resolve_device(device_arg)
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    import torch.distributed as dist
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=(f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:"
                     f"{port}"),
        world_size=world, rank=rank)
    return make_mesh(dp=dp, sp=cfg.sp, tp=cfg.tp, pp=cfg.pp, fsdp=cfg.fsdp,
                     device=device)


def _mesh_shard(batch_at, mesh, cfg: TrainCLIConfig):
    """batch_at with each array cut to this rank's part of the global
    batch: its data shard's rows of every micro-batch (where dp does not
    divide batch_size, its even share of the accumulated rows:
    ``train.trainer.micro_runs``), its ring index's sequence columns.
    The model shards and stages of a data shard take the same part."""
    if mesh is None:
        return batch_at
    a, dp = cfg.accum_steps, mesh.data

    def cols(x):
        # the batch's own width: seq_len for a crop, a segment window's
        # inputs (which the shortest file may cut below seq_len)
        per = x.shape[1] // mesh.size
        return x[:, mesh.rank * per:(mesh.rank + 1) * per]

    def rows(x):
        if cfg.batch_size % dp:
            per = x.shape[0] // dp
            return x[mesh.data_rank * per:(mesh.data_rank + 1) * per]
        x = x.reshape(a, x.shape[0] // a, *x.shape[1:])
        per = x.shape[1] // dp
        x = x[:, mesh.data_rank * per:(mesh.data_rank + 1) * per]
        return x.reshape(a * per, *x.shape[2:])

    return lambda idx: tuple(cols(rows(x)) for x in batch_at(idx))


def check_segment_sp(data_dir: str, cfg: TrainCLIConfig) -> None:
    """Segment mode under sp > 1: every rank takes (window - 1) / sp of
    the window's input columns, and the window follows the corpus's
    shortest file, so the corpus is read here, before any process group
    forms; a window whose inputs sp does not divide exits, naming the
    window, sp and the file's length (the JAX CLI fails there too, in
    its ring's sharding)."""
    if (cfg.sp <= 1 or cfg.train_mode != "segment"
            or cfg.model != "music_transformer"):
        return
    from ..data.pipeline import TokenCorpus

    lens = TokenCorpus(data_dir, limlen=_limlen(cfg)).lengths()
    if not lens.size:
        return  # the batch stream names the empty corpus
    window = segment_window(lens, cfg.seq_len)
    if (window - 1) % cfg.sp:
        raise SystemExit(
            f"train_mode=segment sp={cfg.sp}: the window is {window} tokens "
            f"(the shortest file's {int(lens.min())}, capped at seq_len + 1 "
            f"= {cfg.seq_len + 1}), and its {window - 1} input columns do "
            f"not divide by sp={cfg.sp}; drop the shortest files or pick a "
            "seq_len that caps the window")


def main(argv=None) -> int:
    args, cfg, model_kwargs = _parse(argv)
    check_segment_sp(args.data_dir, cfg)
    mesh = init_mesh(cfg, args.device)
    try:
        return _train(args, cfg, model_kwargs, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _limlen(cfg: TrainCLIConfig) -> int:
    """The shortest sequence the corpus keeps, per family and mode (the
    JAX CLI's, :757-770)."""
    if cfg.model == "popmag":
        return 0
    if cfg.model == "cp_transformer":
        # the shards store flattened [T, 8] rows: limlen counts flat tokens
        return (cfg.seq_len + 1) * 8
    if cfg.train_mode in ("segment", "sequence"):
        # segment windows shrink to the shortest file; sequence mode
        # takes any file with a label token
        return 2
    if cfg.train_mode == "window":
        return cfg.window_size + 1   # at least one strided window
    return cfg.seq_len + 1


def _batch_fn(corpus, cfg: TrainCLIConfig, scheme: str):
    """The batch stream of the family and mode (the JAX CLI's
    dispatch, :808-818): the CP transformer, PoPMAG and a conditioned
    PerformanceRNN keep their own streams in any mode."""
    if cfg.model == "popmag":
        return _popmag_batch_fn(corpus, cfg)
    if cfg.model == "cp_transformer":
        return _cp_batch_fn(corpus, cfg)
    if cfg.model == "performance_rnn" and scheme == "midilike_control":
        return _control_batch_fn(corpus, cfg)
    return {"segment": _segment_batch_fn, "window": _window_batch_fn,
            "sequence": _sequence_batch_fn}.get(
                cfg.train_mode, _lm_batch_fn)(corpus, cfg)


def _tokens_per_batch(corpus, cfg: TrainCLIConfig) -> int:
    """Tokens a step trains on, for the step lines' rate (window mode:
    the window; sequence mode: the corpus's mean length)."""
    b = cfg.batch_size * cfg.accum_steps
    if cfg.train_mode == "window":
        return b * cfg.window_size
    if cfg.train_mode == "sequence":
        return int(np.mean(corpus.lengths()) * b)
    return b * cfg.seq_len


def _train(args, cfg: TrainCLIConfig, model_kwargs, mesh) -> int:
    from .. import resolve_device
    from ..data.batching import slide_seq2seq_batch
    from ..data.pipeline import TokenCorpus
    from ..data.prefetch import prefetch_to_device, to_device
    from ..train.loop import LoopConfig, run_loop
    from ..train.trainer import (create_train_state, make_eval_step,
                                 make_optimizer, make_train_step)
    from ..utils.checkpoint import Checkpointer, list_checkpoints

    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank = mesh.global_rank if mesh is not None else 0
    with open(os.path.join(args.data_dir, "manifest.json")) as f:
        scheme = json.load(f)["scheme"]
    model, tcfg, loss_fn = build_model(cfg, scheme, model_kwargs, device,
                                       mesh, distill=True)
    corpus = TokenCorpus(args.data_dir, limlen=_limlen(cfg),
                         key="melody" if scheme == "mumidi" else "tokens")
    print(f"corpus: {len(corpus)} sequences (scheme={scheme})")
    batch_at = _batch_fn(corpus, cfg, scheme)
    if cfg.model == "music_transformer":
        batch_at = _mesh_shard(batch_at, mesh, cfg)

    # step s consumes batch s, so starting the stream at the checkpoint's
    # next step replays exactly the uninterrupted batch sequence
    start_step = 0
    if cfg.ckpt_dir:
        ckpts = list_checkpoints(cfg.ckpt_dir)
        if ckpts:
            start_step = ckpts[-1][0] + 1
            meta = Checkpointer(cfg.ckpt_dir).read_meta()
            if meta and meta.get("data_seed") not in (None, cfg.seed):
                print(f"WARNING: resuming with seed={cfg.seed} but the "
                      f"checkpoint was written with data_seed="
                      f"{meta['data_seed']} — the resumed batch stream "
                      "will NOT continue the original sequence")

    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=cfg.seed, mesh=mesh)
    train_step = make_train_step(tx, tcfg, loss_fn=loss_fn, mesh=mesh)

    eval_step = eval_batches = None
    # the JAX CLI evaluates only the LM
    if cfg.eval_dir and cfg.model == "music_transformer":
        eval_corpus = TokenCorpus(cfg.eval_dir, limlen=_limlen(cfg))
        eval_seqs = [np.asarray(eval_corpus[i])
                     for i in range(len(eval_corpus))]

        def eval_batches():
            r = np.random.RandomState(0)
            for _ in range(4):
                batch = slide_seq2seq_batch(eval_seqs, cfg.batch_size,
                                            cfg.seq_len, r)
                yield to_device(_mesh_shard(
                    lambda _: batch, mesh,
                    dataclasses.replace(cfg, accum_steps=1))(0), device)

        eval_step = make_eval_step(tcfg, mesh=mesh,
                                   apply=getattr(loss_fn, "apply", None))

    loop_cfg = LoopConfig(
        total_steps=cfg.steps, ckpt_dir=cfg.ckpt_dir,
        ckpt_every=cfg.ckpt_every, log_every=cfg.log_every,
        eval_every=cfg.eval_every, metrics_path=cfg.metrics_path,
        profile_dir=cfg.profile_dir, profile_steps=cfg.profile_steps,
        rank=rank,
        stream_meta={"data_seed": cfg.seed, "train_mode": cfg.train_mode,
                     "model": cfg.model})
    stream = prefetch_to_device(_indexed_stream(batch_at, start_step),
                                size=2, device=device)
    try:
        run_loop(state, train_step, stream, loop_cfg, eval_step=eval_step,
                 eval_batches=eval_batches,
                 tokens_per_batch=_tokens_per_batch(corpus, cfg),
                 config_dict={"cli": cfg.to_dict(), "scheme": scheme,
                              "model_kwargs": model_kwargs})
    finally:
        stream.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
