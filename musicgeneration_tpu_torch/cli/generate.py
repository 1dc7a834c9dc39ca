"""Generate MIDI from a MusicTransformer, CPTransformer, EventMelodyRNN,
PerformanceRNN, MelodyRNN or PoPMAG checkpoint on the GPU.

    python -m musicgeneration_tpu_torch.cli.generate model.pth out.mid \\
        --prime prompt.mid --steps 512 --temperature 1.0 --topk 0

The checkpoint is what ``python -m musicgeneration_tpu.cli.export_checkpoint
runs/x model.pth`` writes (the family is read off its state dict), or the
port's own ``cli.train`` checkpoint directory (its newest ``step-<N>.pt``)
or one file of it. A MusicTransformer's prime is tokenized with the
codec of the scheme its ``cli.train`` run recorded (``midilike``,
``midilike_control``, ``remi``, ``pedal`` or ``melody``; the MIDI-like
codec for an exported ``.pth``), and the continuation is written through
the same codec (ids past the codec's vocabulary, e.g. the pad id, are
dropped; the pedal codec drops them itself); a checkpoint whose
vocabulary is not its scheme's exits. A MusicTransformer prime is padded
to a power-of-two bucket (>= 16) as the JAX CLI does; a GRU model takes
its prime one token at a time, unpadded. A MusicTransformer continuation
past max_seq (batch 1) re-primes a sliding window of max_seq // 2.

A MusicTransformer adds ``--quant int8``: weight-only int8 decode (the
decode step's six matrices, and the verify forward's where C is a power
of two in [8, 128], in int8 with per-column scales; a ``cli.train``
checkpoint may record it), and ``--spec lookup|DRAFT``: speculative decoding,
each verify forward checking ``--spec-chunk`` tokens (kernel E on the
card), proposals from prompt lookup (``--spec-ngram``) or from a draft
MusicTransformer of the same vocabulary (``DRAFT``: any checkpoint this
CLI reads), loaded in the same ``--dtype`` on the same device, with
the ``decode_quant`` its own checkpoint records. Greedy output equals
plain decoding's; the prime is not bucketed.

A CPTransformer (a ``cli.train model=cp_transformer`` checkpoint) takes
its prime as Compound Word rows of ``--prime`` (at most ``--prime-len``
rows; a bare bar-marker row without one), cut to max_seq - steps rows,
samples each row type-first (``decode/cp_generate.py``; ``--temperature
0`` is greedy, ``--topk``/``--topp`` are refused) and writes the rows
through the CP codec. ``--batch``, ``--include-prime`` and ``--quant
int8`` apply as for the MusicTransformer.

A PoPMAG checkpoint (a ``cli.train model=popmag`` run or a reference
``.pth``) arranges a melody: ``--prime <melody.mid>`` is required; its
melody track is encoded with the MuMIDI codec, cut to the run's
``max_bars`` and at its first bar longer than ``max_bar_len`` (16 and 96
for a ``.pth``), and packed to compound rows; ``--batch N`` draws N
latents from ``--seed`` and writes ``<stem>-000.mid``...; each row is
arranged bar by bar (``decode/popmag_generate.py``, 200 decoder steps a
bar through kernel D; ``--temperature 0`` is greedy; ``--topk``,
``--topp``, ``--spec``, ``--beam`` and ``--control`` are refused) and
written through the MuMIDI codec.

The RNN families (EventMelodyRNN, PerformanceRNN, MelodyRNN) take the
prime one token at a time, unpadded, and write through the codec of the
scheme their ``cli.train`` run recorded (the GRU families: ``midilike``,
``midilike_control``, ``remi``, ``pedal`` or ``melody``, ids past the
codec's vocabulary dropped as for the MusicTransformer; the MIDI-like
codec for an exported ``.pth``; MelodyRNN's note arrays for a MelodyRNN:
the prime through ``midi_to_note_array``, ids >= 130 dropped before
``note_array_to_midi``). The GRU families add ``--beam N`` (beam search;
``--stochastic-beam`` for Gumbel-perturbed selection), and
PerformanceRNN ``--control`` (``'PITCH_HISTOGRAM;NOTE_DENSITY'``, e.g.
``'2,0,1,1,0,1,0,1,1,0,0,1;4'`` or ``';3'`` for uniform pitches,
repeated every step; or a ``midilike_control`` corpus directory or one
``.npz`` shard of it, whose per-event control sequence drives every
step: ``--control-index`` picks the sequence, else one drawn by
``RandomState(--seed)``), a latent per batch row (``--init-zero`` for
zeros) and a prime that starts with the primary event.

``--dp N`` splits ``--batch``'s rows over N data shards
(``decode.generate_dp``; CP ``generate_cp(mesh=)``; PoPMAG
``generate_arrangement_dp``): on ``cuda`` the first N visible devices,
one shard each (the model copied to each); on the CPU N shards of the
CPU. It exits, as the JAX CLI's ``_dp_mesh`` does, when fewer devices
are visible or the batch does not divide; ``--spec``, ``--beam`` and a
continuation past max_seq do not take it. Greedy output equals ``--dp
1``'s; sampled shards draw from their own streams, seeded from
``--seed`` and the shard index. ``--tp M`` (the MusicTransformer) runs
each data shard on M head shards (``decode.generate_tp``), on the first
dp x M visible devices (data shard i's head shards on devices i * M ..
i * M + M - 1); its output, greedy or sampled, is ``--tp 1``'s, byte for
byte (one sampler over the summed logits, ``--seed``'s generator). It
takes no ``--quant``, ``--spec``, ``--beam`` or continuation past
max_seq, and pins the unquantized step as the JAX CLI pins its XLA
decode path. Runs on ``--device cuda`` by default; a missing GPU is an
error, not a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dp_mesh(dp: int, batch: int, device, tp: int = 1):
    """--dp/--tp: a virtual mesh of ``dp`` data shards of ``tp`` model
    shards each, the first dp * tp visible CUDA devices (on the CPU,
    dp * tp shards of it); exits as the JAX CLI's ``_dp_mesh`` does on a
    batch that does not divide or too few devices."""
    from ..parallel.mesh import make_mesh

    if batch % dp:
        raise SystemExit(f"--batch {batch} not divisible by --dp {dp}")
    need = dp * tp
    dev = torch.device(device)
    if dev.type != "cuda":
        return make_mesh(dp=dp, tp=tp, devices=[dev] * need)
    have = torch.cuda.device_count()
    if have < need:
        raise SystemExit(f"--dp {dp}{f' x --tp {tp}' if tp > 1 else ''} "
                         f"needs {need} devices, have {have}")
    return make_mesh(dp=dp, tp=tp, devices=[torch.device("cuda", i)
                                            for i in range(need)])


def _dtype(args):
    """--dtype, or None: the dtype the checkpoint records (float32 for
    an exported .pth)."""
    return None if args.dtype is None else _DTYPES[args.dtype]


# the token schemes the RNN families decode through (the port's codecs):
# every flat scheme, as the JAX CLI's
RNN_SCHEMES = ("midilike", "midilike_control", "remi", "pedal", "melody")


def prime_tokens(prime: Optional[str], prime_len: int,
                 scheme: str = "midilike") -> List[int]:
    """Tokenize a prompt MIDI with the scheme's codec (the JAX CLI's
    ``_prime_tokens``): MIDI-like events, REMI words, the pedal codec's
    ``encode_midi`` or ``melody``'s note arrays; default prime = [24, 28,
    31] (MusicTransformer/generate.py:103-110)."""
    if prime is None:
        return [24, 28, 31]
    if scheme in ("midilike", "midilike_control"):
        from ..tokenizers import midilike
        arr = midilike.extract_events(prime).to_array()
    elif scheme == "remi":
        from ..tokenizers import remi
        arr = remi.REMI_EventSeq.to_array(
            remi.REMI_EventSeq.extract_events(prime))
    elif scheme == "pedal":
        from ..tokenizers import pedal_midilike
        arr = np.asarray(pedal_midilike.encode_midi(prime))
    elif scheme == "melody":
        from ..tokenizers import melody
        arr = melody.midi_to_note_array(prime)
    else:
        raise ValueError(f"cannot prime scheme {scheme!r}")
    return [int(t) for t in arr[:prime_len]]


def write_midi(tokens: np.ndarray, path: str,
               scheme: str = "midilike") -> None:
    """Write tokens through the scheme's codec (the JAX CLI's
    ``_write_midi``): ids past its vocabulary (a pad id, say) are
    dropped first; the pedal codec's ``decode_midi`` drops them itself."""
    tokens = np.asarray(tokens)
    if scheme in ("midilike", "midilike_control"):
        from ..tokenizers import midilike
        tokens = tokens[tokens < midilike.EventSeq.dim()]
        midilike.write_midi(midilike.EventSeq.from_array(tokens), path)
    elif scheme == "remi":
        from ..tokenizers import remi
        tokens = tokens[tokens < remi.REMI_EventSeq.dim()]
        remi.REMI_EventSeq.write_midi(
            remi.REMI_EventSeq.from_array(tokens), path)
    elif scheme == "pedal":
        from ..tokenizers import pedal_midilike
        pedal_midilike.decode_midi([int(t) for t in tokens], path)
    elif scheme == "melody":
        from ..tokenizers import melody
        melody.note_array_to_midi(tokens[tokens < melody.MELODY_VOCAB], path)
    else:
        raise ValueError(f"cannot write scheme {scheme!r}")


def transformer_scheme(model, config) -> str:
    """The scheme a MusicTransformer checkpoint decodes through: the one
    its ``cli.train`` run recorded, else (an exported ``.pth``)
    ``midilike``. A scheme without a codec here, or a vocabulary that is
    not the scheme's, exits."""
    from ..convert import recorded_scheme
    from .train import LM_SCHEMES, lm_vocab

    scheme = recorded_scheme(model.family, config)
    if scheme not in LM_SCHEMES:
        raise SystemExit(f"the MusicTransformer decodes through "
                         f"{list(LM_SCHEMES)}; this run recorded scheme "
                         f"{scheme!r}")
    if model.vocab_size != lm_vocab(scheme):
        raise SystemExit(
            f"the checkpoint's vocabulary ({model.vocab_size}) is not the "
            f"{scheme!r} codec's ({lm_vocab(scheme)})"
            + ("" if config.get("scheme") else
               ": an exported .pth records no scheme and decodes as "
               "midilike; generate from its cli.train run instead"))
    return scheme


def rnn_scheme(model, config) -> str:
    """The scheme an RNN checkpoint decodes through: the one its
    ``cli.train`` run recorded, else (an exported ``.pth``) ``melody``
    for a MelodyRNN and ``midilike`` for the GRU families. A scheme
    without a codec in the port exits."""
    from ..convert import recorded_scheme

    scheme = recorded_scheme(model.family, config)
    if scheme not in RNN_SCHEMES:
        raise SystemExit(f"the port decodes the RNN families through "
                         f"{list(RNN_SCHEMES)}; this run recorded "
                         f"scheme {scheme!r}")
    return scheme


def bucket_prompt(prompt: np.ndarray, steps: int, max_seq: int,
                  pad_id: int):
    """Pad [B, P] to the next power-of-two bucket >= 16 when the bucket
    still fits max_seq (cli/generate.py:419-441). Returns (prompt,
    prompt_len or None)."""
    bucket = 16
    while bucket < prompt.shape[1]:
        bucket *= 2
    if bucket + steps > max_seq:
        return prompt, None
    p_true = prompt.shape[1]
    return (np.pad(prompt, ((0, 0), (0, bucket - p_true)),
                   constant_values=pad_id), p_true)


def parse_control(spec: str, index: Optional[int], seed: int) -> np.ndarray:
    """``--control`` -> [S, control_dim] (cli/generate.py:139-169 of the
    JAX CLI): the per-event control sequence of a ``midilike_control``
    corpus directory or ``.npz`` shard, else 'p1,...,p12;density' (an
    empty histogram is uniform), one control repeated every step."""
    from ..tokenizers.midilike import Control, ControlSeq

    if os.path.isdir(spec):
        comp = load_corpus_controls(spec, index, seed)
        return ControlSeq.recover_compressed_array(comp)
    if os.path.isfile(spec):
        comp = load_compressed_controls(spec, index, seed)
        return ControlSeq.recover_compressed_array(comp)
    if ";" not in spec:
        raise SystemExit(f"--control {spec!r} is neither a file nor a "
                         "'PITCH_HISTOGRAM;NOTE_DENSITY' spec")
    hist_s, dens_s = spec.split(";")
    vals = [v for v in hist_s.split(",") if v]
    if not vals:
        hist = (np.ones(12) / 12).tolist()
    else:
        hist = np.array([float(v) for v in vals])
        if hist.size != 12 or np.any(hist < 0):
            raise SystemExit("--control pitch histogram needs 12 "
                             "non-negative values")
        hist = (hist / hist.sum() if hist.sum() else np.ones(12) / 12).tolist()
    density = int(dens_s)
    if density not in range(len(ControlSeq.note_density_bins)):
        raise SystemExit(f"--control note density must be in "
                         f"[0, {len(ControlSeq.note_density_bins)})")
    return Control(hist, density).to_array()[None]


def load_corpus_controls(path: str, index: Optional[int],
                         seed: int) -> np.ndarray:
    """Compressed [S, 13] controls of one sequence of a corpus directory
    that ``cli.tokenize --scheme midilike_control`` wrote: sequence
    ``index``, else one drawn by ``RandomState(seed)`` (the JAX CLI's
    ``_load_compressed_controls``, :172-193). A directory of another
    scheme exits."""
    from ..data.pipeline import TokenCorpus

    manifest = os.path.join(path, "manifest.json")
    scheme = None
    if os.path.exists(manifest):
        import json
        with open(manifest) as f:
            scheme = json.load(f).get("scheme")
    if scheme != "midilike_control":
        raise SystemExit(f"--control {path!r} is not a midilike_control "
                         f"corpus (its manifest names scheme {scheme!r}); "
                         "tokenize with --scheme midilike_control")
    corpus = TokenCorpus(path)
    if not len(corpus):
        raise SystemExit(f"no sequences in corpus {path!r}")
    i = (np.random.RandomState(seed).randint(0, len(corpus))
         if index is None else index)
    return np.asarray(corpus.pair(i, "controls"), np.uint8).reshape(-1, 13)


def load_compressed_controls(path: str, index: Optional[int],
                             seed: int) -> np.ndarray:
    """Compressed [S, 13] controls of one sequence of a ``.npz`` shard
    that ``cli.tokenize --scheme midilike_control`` wrote (a random one
    unless ``index``, as the JAX CLI). The shard keeps them flat under
    ``controls_data`` with element ``controls_offsets``
    (``data/pipeline.py::_write_shard``); ``controls``, the key the JAX
    CLI reads, is taken too."""
    with np.load(path) as z:
        key = next((k for k in ("controls_data", "controls") if k in z),
                   None)
        if key is None or "controls_offsets" not in z:
            raise SystemExit(f"{path!r} has no control data (tokenize "
                             "with --scheme midilike_control)")
        offs = z["controls_offsets"]
        i = (np.random.RandomState(seed).randint(0, len(offs) - 1)
             if index is None else index)
        return np.asarray(z[key][offs[i]:offs[i + 1]],
                          np.uint8).reshape(-1, 13)


def rnn_prime(model, prime: Optional[str], prime_len: int,
              scheme: str = "midilike") -> List[int]:
    """The RNN families' prompt: PerformanceRNN starts from its primary
    event (reference generate.py:171-175), then the prime's tokens if
    any; EventMelodyRNN and MelodyRNN take the prime (default [24, 28,
    31]), tokenized with the scheme's codec."""
    if model.family == "performance_rnn":
        return [model.primary_event] + (
            [] if prime is None else prime_tokens(prime, prime_len, scheme))
    return prime_tokens(prime, prime_len, scheme)


def melody_compound_from_midi(prime: str, max_bars: int, max_bar_len: int):
    """A melody MIDI -> packed compound rows (src [bars, S, 7] int32,
    src_len [bars] int32) for PoPMAG (the JAX CLI's
    ``_melody_compound_from_midi``; reference PoPMAG_RNN/generate.py:
    150-177): the melody track in MuMIDI, cut to ``max_bars`` and at the
    first bar longer than ``max_bar_len`` (as the training batches).
    Raises ValueError when the file has no melody and arrangement tracks
    or no usable bar."""
    from ..data import mumidi_packing as mp
    from ..tokenizers.mumidi import MuMIDI_EventSeq

    melody_events, _ = MuMIDI_EventSeq.extract_split_events(prime)
    if melody_events is None:
        raise ValueError(
            f"prime {prime!r} has no extractable melody track: PoPMAG "
            "needs a multi-track MIDI with a 'melody' instrument and at "
            "least one arrangement role (MuMIDI extract_split_events "
            "returned None, the reference's skip condition)")
    melody = MuMIDI_EventSeq.to_array(melody_events).astype(np.int64)
    bars = list(MuMIDI_EventSeq.segmentation(melody))[:max_bars]
    for k, bar in enumerate(bars):
        if len(bar) > max_bar_len:
            bars = bars[:k]
            break
    if not bars:
        raise ValueError("prime melody has no usable bars after MuMIDI "
                         "encoding (first bar longer than max_bar_len?)")
    packed, lens = mp.pack_compound(bars, 0)
    src = np.zeros((len(packed), max(len(a) for a in packed), 7), np.int32)
    for gi, arr in enumerate(packed):
        src[gi, :len(arr)] = arr
    return src, np.maximum(np.asarray(lens, np.int32), 1)


def popmag_limits(config) -> tuple:
    """(max_bars, max_bar_len) a ``cli.train`` run recorded in its
    checkpoint's config (``load_checkpoint(..., with_config=True)``), else
    (an exported ``.pth``, config {}) the training CLI's defaults (16,
    96)."""
    cli = config.get("cli") or {}
    return int(cli.get("max_bars", 16)), int(cli.get("max_bar_len", 96))


def beam_decode(model, prompt: torch.Tensor, steps: int, beam: int,
                temperature: float, stochastic: bool,
                generator: Optional[torch.Generator], controls=None,
                cache0=None) -> torch.Tensor:
    """(Stochastic) beam search for a GRU model (the JAX CLI's
    ``_beam_decode``): prompt [1, P] runs through ``decode_step`` up to
    its last token, the state is replicated per beam, and the search
    starts from the last token. controls: optional [1 or S, 1, C]; the
    search's step i takes control row P - 1 + i. Returns [steps]."""
    from ..decode import beam_search, expand_controls, replicate_for_beams

    p = prompt.shape[1]
    cache = cache0 if cache0 is not None else model.init_cache(1)
    ctrl = (None if controls is None else expand_controls(
        torch.as_tensor(controls, dtype=torch.float32, device=model.device),
        p + steps))
    for i in range(p - 1):
        args = () if ctrl is None else (ctrl[i],)
        _, cache = model.decode_step(prompt[:, i], cache, *args)
    cache = replicate_for_beams(cache, beam, batch_axis=1)
    if ctrl is None:
        step_fn, per_step = model.decode_step, None
    else:
        def step_fn(tokens, state, c):
            return model.decode_step(tokens, state,
                                     c.expand(tokens.shape[0], -1))
        per_step = ctrl[p - 1:p - 1 + steps, 0]
    seq = beam_search(step_fn, cache, prompt[:, -1], steps=steps,
                      beam_size=beam, vocab_size=model.event_dim,
                      generator=generator, temperature=temperature,
                      stochastic=stochastic, state_batch_axis=1,
                      per_step_inputs=per_step)
    return seq[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="exported .pth, or a cli.train "
                   "checkpoint directory (newest step) or step-<N>.pt")
    p.add_argument("output", help="output .mid path")
    p.add_argument("--steps", type=int, default=512)
    p.add_argument("--prime", default=None, help="prompt MIDI file")
    p.add_argument("--prime-len", type=int, default=500,
                   help="max prompt tokens (reference generate.py:106)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="0 = greedy")
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--topp", type=float, default=1.0,
                   help="nucleus sampling mass; 1.0 (or 0) = off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=1,
                   help="generate N continuations in one batch; N>1 writes "
                        "<stem>-000.mid ...")
    p.add_argument("--dp", type=int, default=1,
                   help="shard the batch over N devices (data-parallel "
                        "decode over the first N visible GPUs, their shards "
                        "run one after another from this host thread; "
                        "--batch must divide by N; greedy output equals "
                        "--dp 1's, sampled shards draw from their own "
                        "streams)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel decode (music_transformer): each "
                        "data shard's heads and FFN over N devices "
                        "(decode.generate_tp; composes with --dp as a dp x "
                        "tp mesh of the first dp*tp GPUs). Byte-identical "
                        "to --tp 1")
    p.add_argument("--include-prime", action="store_true",
                   help="write prompt + continuation")
    p.add_argument("--beam", type=int, default=0,
                   help="beam size (GRU families; reference beam_search, "
                        "Event_MelodyRNN/network.py:166-268)")
    p.add_argument("--stochastic-beam", action="store_true",
                   help="Gumbel-perturbed beam (reference "
                        "stochastic_beam_search)")
    p.add_argument("--control", default=None,
                   help="PerformanceRNN conditioning: "
                        "'PITCH_HISTOGRAM;NOTE_DENSITY' like "
                        "'2,0,1,1,0,1,0,1,1,0,0,1;4' or ';3' (uniform "
                        "pitches), or a midilike_control corpus directory "
                        "or .npz shard")
    p.add_argument("--control-index", type=int, default=None,
                   help="sequence index inside a --control corpus or shard "
                        "(default: drawn from --seed)")
    p.add_argument("--init-zero", action="store_true",
                   help="PerformanceRNN: zero latent instead of N(0, 1)")
    p.add_argument("--spec", default=None, metavar="lookup|DRAFT",
                   help="speculative decoding (music_transformer): "
                        "'lookup' proposes by n-gram prompt lookup, "
                        "otherwise a draft music_transformer checkpoint "
                        "proposes (decode/speculative.py)")
    p.add_argument("--spec-chunk", type=int, default=8,
                   help="tokens per speculative verify forward")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="lookup match length (--spec lookup)")
    p.add_argument("--quant", default="none", choices=("none", "int8"),
                   help="weight-only int8 decode (the transformers): the "
                        "decode step's and the verify forward's matrices "
                        "in int8 with per-column scales; 'none' keeps what "
                        "a cli.train checkpoint records")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                   help="compute dtype (default: the one a cli.train "
                        "checkpoint records, else float32)")
    args = p.parse_args(argv)

    from ..convert import load_checkpoint

    try:
        model, config = load_checkpoint(
            args.checkpoint, device=args.device, dtype=_dtype(args),
            with_config=True,
            decode_quant=None if args.quant == "none" else args.quant)
    except ValueError as e:  # e.g. --quant int8 on a GRU checkpoint
        raise SystemExit(f"{args.checkpoint}: {e}") from None
    if args.tp > 1:
        if model.family != "music_transformer":
            raise SystemExit("--tp applies to model=music_transformer")
        if args.quant != "none":
            raise SystemExit("--quant rides the fused kernels; --tp pins "
                             "the unquantized decode step (pick one)")
        # the JAX CLI pins its XLA decode path, which has no int8: a
        # recorded model.decode_quant=int8 does not apply
        model.decode_quant = "none"
    if model.family == "cp_transformer":
        return _generate_cp(model, args)
    if model.family == "popmag":
        return _generate_popmag(model, args, config)
    if args.spec is not None:
        if model.family != "music_transformer":
            raise SystemExit("--spec needs a music_transformer target "
                             "(chunked verify forward)")
        if args.tp > 1:
            raise SystemExit("--spec with --tp is not supported")
        if args.dp > 1 or args.beam > 1:
            raise SystemExit("--spec is mutually exclusive with --dp "
                             "and --beam")
    if model.family != "music_transformer":
        return _generate_rnn(model, args, rnn_scheme(model, config))
    if args.beam > 1 or args.control is not None:
        raise SystemExit("--beam and --control are for the GRU families "
                         "(event_rnn / performance_rnn)")
    return _generate_transformer(model, args,
                                 transformer_scheme(model, config))


def _sampling(args):
    from ..decode import SamplingParams
    # temperature 0 = greedy; top_p 0 means off, as the JAX CLI
    return SamplingParams(temperature=args.temperature, top_k=args.topk,
                          top_p=args.topp if args.topp > 0 else 1.0,
                          greedy=(args.temperature == 0.0))


def _write_outputs(outs, prime, args, scheme: str = "midilike") -> None:
    nb = len(outs)
    stem, ext = os.path.splitext(args.output)
    for i, row in enumerate(outs):
        tokens = (np.concatenate([np.asarray(prime, np.int64), row])
                  if args.include_prime else row)
        path = args.output if nb == 1 else f"{stem}-{i:03d}{ext or '.mid'}"
        write_midi(tokens, path, scheme)
        print(f"wrote {path} ({len(tokens)} tokens)")


def _generate_rnn(model, args, scheme: str) -> int:
    """EventMelodyRNN / PerformanceRNN / MelodyRNN: sampled or greedy
    generation through ``decode.generate`` (``generate_dp`` with --dp), or
    (stochastic) beam search for the GRU families."""
    from ..decode import DecodeParams, generate, generate_dp

    if model.family == "melody_rnn" and args.beam > 1:
        raise SystemExit("--beam is for the GRU families (event_rnn / "
                         "performance_rnn), as in the JAX CLI")
    controls = cache0 = None
    if args.control is not None:
        if model.family != "performance_rnn":
            raise SystemExit("--control is PerformanceRNN conditioning "
                             "(reference PerformanceRNN/generate.py)")
        ctrl = parse_control(args.control, args.control_index, args.seed)
        if args.steps <= 0:
            # reference: the length defaults to the control sequence's
            if ctrl.shape[0] <= 1:
                raise SystemExit("--steps must be given with a single "
                                 "control spec")
            args.steps = int(ctrl.shape[0])
        elif 1 < ctrl.shape[0] < args.steps:
            raise SystemExit(
                f"control sequence ({ctrl.shape[0]}) shorter than --steps "
                f"({args.steps}) (reference expand_controls asserts "
                "controls.shape[0] >= steps, network.py:97-104)")
        controls = torch.from_numpy(ctrl.astype(np.float32))[:, None, :]
    if args.steps <= 0:
        raise SystemExit("--steps must be positive")
    nb = max(args.batch, 1)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    if model.family == "performance_rnn":
        # each batch row gets its own latent (generate.py:356-375 of the
        # JAX CLI), drawn on the CPU so one seed gives one latent anywhere
        init = (torch.zeros(nb, model.init_dim) if args.init_zero else
                torch.randn(nb, model.init_dim,
                            generator=torch.Generator().manual_seed(
                                args.seed + 7)))
        cache0 = model.init_cache(nb, init=init)
    prime = rnn_prime(model, args.prime, args.prime_len, scheme)
    prompt = torch.tensor([prime] * nb, dtype=torch.long,
                          device=model.device)
    if controls is not None:
        controls = controls.expand(-1, nb, -1)
    if args.beam > 1:
        if nb > 1:
            raise SystemExit("--batch and --beam are mutually exclusive "
                             "(a beam already explores N hypotheses)")
        if args.dp > 1:
            raise SystemExit("--dp/--tp do not apply to beam search "
                             "(single-hypothesis-set decode)")
        outs = beam_decode(model, prompt, args.steps, args.beam,
                           args.temperature or 1.0, args.stochastic_beam,
                           gen, controls, cache0)[None]
    else:
        dp = DecodeParams(max_len=len(prime) + args.steps, steps=args.steps,
                          sampling=_sampling(args))
        if args.dp > 1:
            outs = generate_dp(model, prompt, args.seed, dp,
                               dp_mesh(args.dp, nb, args.device),
                               controls=controls, cache0=cache0)
        else:
            outs = generate(model, prompt, gen, dp, controls=controls,
                            cache0=cache0)
    _write_outputs(outs.cpu().numpy(), prime, args, scheme)
    return 0


def _generate_cp(model, args) -> int:
    """Compound-word continuation (the JAX CLI's ``_generate_cp``): prime
    rows from a MIDI (or a bare bar-marker row) -> type-first sampled
    rows -> MIDI."""
    from ..decode.cp_generate import generate_cp
    from ..tokenizers import cp as cp_codec

    if (args.spec is not None or args.beam > 1 or args.control is not None
            or args.topk or 0 < args.topp < 1.0):
        raise SystemExit("--spec, --beam, --control, --topk and --topp do "
                         "not apply to compound-word rows (type-first "
                         "sampling draws each field categorically)")
    if args.prime is not None:
        rows = cp_codec.extract_events(args.prime)[:args.prime_len]
        if not len(rows):
            raise SystemExit("prime MIDI produced no CP rows")
    else:  # start at a bar marker
        rows = [cp_codec._row(cp_codec.FAMILY_METRIC, position=0)]
    rows = np.asarray(rows, np.int64)[:max(1, model.max_seq - args.steps)]
    nb = max(args.batch, 1)
    if args.dp > 1:  # each data shard seeds its own stream from --seed
        shard = dict(mesh=dp_mesh(args.dp, nb, args.device), seed=args.seed)
    else:
        shard = dict(generator=torch.Generator(
            device=model.device).manual_seed(args.seed))
    try:
        out = generate_cp(model, np.tile(rows[None], (nb, 1, 1)), args.steps,
                          max_len=rows.shape[0] + args.steps,
                          temperature=args.temperature or 1.0,
                          greedy=(args.temperature == 0.0), **shard)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    stem, ext = os.path.splitext(args.output)
    for i, gen_rows in enumerate(out.cpu().numpy()):
        all_rows = (np.concatenate([rows, gen_rows]) if args.include_prime
                    else gen_rows)
        path = args.output if nb == 1 else f"{stem}-{i:03d}{ext or '.mid'}"
        cp_codec.write_midi(all_rows, path)
        print(f"wrote {path} ({len(all_rows)} compound rows)")
    return 0


def _generate_popmag(model, args, config) -> int:
    """Melody MIDI -> multi-track arrangement MIDI (the JAX CLI's
    ``_generate_arrangement``; reference PoPMAG_RNN/generate.py:177)."""
    from ..decode.popmag_generate import (flatten_arrangement,
                                          generate_arrangement,
                                          generate_arrangement_dp)
    from ..tokenizers.mumidi import MuMIDI_EventSeq

    if args.prime is None:
        raise SystemExit("popmag needs --prime <melody midi> (melody -> "
                         "arrangement seq2seq)")
    if (args.spec is not None or args.beam > 1 or args.control is not None
            or args.topk or 0 < args.topp < 1.0):
        raise SystemExit("--spec, --beam, --control, --topk and --topp do "
                         "not apply to PoPMAG (typed heads, greedy or one "
                         "temperature)")
    try:
        src, src_len = melody_compound_from_midi(
            args.prime, *popmag_limits(config))
    except ValueError as e:
        raise SystemExit(str(e)) from None
    nb = max(args.batch, 1)
    n_bars = src.shape[0]
    # one latent a row, drawn on the CPU: one seed gives one latent anywhere
    init = torch.randn(nb, model.init_dim,
                       generator=torch.Generator().manual_seed(args.seed))
    src, src_len = np.tile(src[None], (nb, 1, 1, 1)), np.tile(src_len[None],
                                                             (nb, 1))
    kwargs = dict(greedy=(args.temperature == 0.0),
                  temperature=args.temperature or 1.0)
    if args.dp > 1:
        tokens, valid = generate_arrangement_dp(
            model, init, src, src_len, n_bars,
            dp_mesh(args.dp, nb, args.device), seed=args.seed + 1, **kwargs)
    else:
        gen = torch.Generator(device=model.device).manual_seed(args.seed + 1)
        tokens, valid = generate_arrangement(
            model, init, src, src_len, n_bars, generator=gen, **kwargs)
    stem, ext = os.path.splitext(args.output)
    for i, flat in enumerate(flatten_arrangement(tokens, valid)):
        path = args.output if nb == 1 else f"{stem}-{i:03d}{ext or '.mid'}"
        MuMIDI_EventSeq.write_midi(MuMIDI_EventSeq.from_array(flat), path)
        print(f"wrote {path} ({len(flat)} tokens, {n_bars} bars)")
    return 0


def _generate_transformer(model, args, scheme: str = "midilike") -> int:
    from ..decode import (DecodeParams, generate, generate_dp,
                          generate_sliding, generate_tp)

    prime = prime_tokens(args.prime, args.prime_len, scheme)
    nb = max(args.batch, 1)
    prompt = np.tile(np.asarray(prime, np.int64)[None], (nb, 1))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    if len(prime) + args.steps > model.max_seq:
        if nb > 1 or args.dp > 1 or args.tp > 1 or args.spec is not None:
            raise SystemExit(
                f"prime ({len(prime)}) + steps ({args.steps}) exceeds "
                f"max_seq ({model.max_seq}): --batch/--dp/--tp/--spec with "
                "a continuation beyond max_seq (sliding window) is not "
                "supported")
        # the cache spans 2 * window rows, inside the relative table
        outs = generate_sliding(model, prompt, gen, args.steps,
                                window=max(model.max_seq // 2, 16),
                                sampling=_sampling(args))
    elif args.spec is not None:
        outs = _speculative(model, prompt, gen, args)
    else:
        prompt, prompt_len = bucket_prompt(prompt, args.steps, model.max_seq,
                                           model.pad_id)
        dp = DecodeParams(max_len=prompt.shape[1] + args.steps,
                          steps=args.steps, sampling=_sampling(args))
        if args.tp > 1:  # --tp 1's generator: the same draws
            outs = generate_tp(model, prompt, gen, dp,
                               dp_mesh(args.dp, nb, args.device, args.tp),
                               prompt_len)
        elif args.dp > 1:
            outs = generate_dp(model, prompt, args.seed, dp,
                               dp_mesh(args.dp, nb, args.device), prompt_len)
        else:
            outs = generate(model, torch.from_numpy(prompt), gen, dp,
                            prompt_len)
        outs = outs.cpu().numpy()
    _write_outputs(outs, prime, args, scheme)
    return 0


def _speculative(model, prompt: np.ndarray, gen, args) -> np.ndarray:
    """--spec: lookup proposals or a draft checkpoint's; prints the
    acceptance line of the JAX CLI."""
    from ..convert import load_checkpoint
    from ..decode import DecodeParams, SpecParams, generate_speculative

    draft = None
    if args.spec != "lookup":
        draft = load_checkpoint(args.spec, device=args.device,
                                dtype=model.dtype)
        if draft.family != "music_transformer":
            raise SystemExit("--spec draft must be a music_transformer "
                             f"checkpoint (or 'lookup'); {args.spec} holds "
                             f"a {draft.family}")
        if draft.vocab_size != model.vocab_size:
            raise SystemExit(
                f"draft vocab ({draft.vocab_size}) != target vocab "
                f"({model.vocab_size}): train the draft on the same scheme")
    spec = SpecParams(chunk=args.spec_chunk, ngram=args.spec_ngram)
    dp = DecodeParams(max_len=prompt.shape[1] + args.steps, steps=args.steps,
                      sampling=_sampling(args))
    try:
        outs, stats = generate_speculative(
            model, torch.from_numpy(prompt), gen, dp, draft_model=draft,
            spec=spec, with_stats=True)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    print(f"speculative: {stats['iterations']} verify forwards for "
          f"{args.steps} tokens (mean accepted {stats['mean_accepted']:.2f}/"
          f"{spec.chunk - 1})")
    return outs.cpu().numpy()


if __name__ == "__main__":
    sys.exit(main())
