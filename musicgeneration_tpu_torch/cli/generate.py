"""Generate MIDI from a MusicTransformer, CPTransformer, EventMelodyRNN or
PerformanceRNN checkpoint on the GPU.

    python -m musicgeneration_tpu_torch.cli.generate model.pth out.mid \\
        --prime prompt.mid --steps 512 --temperature 1.0 --topk 0

The checkpoint is what ``python -m musicgeneration_tpu.cli.export_checkpoint
runs/x model.pth`` writes (the family is read off its state dict), or the
port's own ``cli.train`` checkpoint directory (its newest ``step-<N>.pt``)
or one file of it. The prime is tokenized with the MIDI-like codec and
the continuation is written through the same codec (ids >= the codec's
dim, e.g. the pad id, are dropped). A MusicTransformer prime is padded
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

The GRU families add ``--beam N`` (beam search; ``--stochastic-beam``
for Gumbel-perturbed selection), and PerformanceRNN ``--control``
(``'PITCH_HISTOGRAM;NOTE_DENSITY'``, e.g. ``'2,0,1,1,0,1,0,1,1,0,0,1;4'``
or ``';3'`` for uniform pitches, repeated every step; or a
``midilike_control`` ``.npz`` shard whose per-event control sequence
drives every step, ``--control-index`` picking the sequence), a latent
per batch row (``--init-zero`` for zeros) and a prime that starts with
the primary event. Runs on ``--device cuda`` by default; a missing GPU
is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(args):
    """--dtype, or None: the dtype the checkpoint records (float32 for
    an exported .pth)."""
    return None if args.dtype is None else _DTYPES[args.dtype]


def prime_tokens(prime: Optional[str], prime_len: int) -> List[int]:
    """Tokenize a prompt MIDI; default prime = [24, 28, 31]
    (MusicTransformer/generate.py:103-110)."""
    if prime is None:
        return [24, 28, 31]
    from ..tokenizers import midilike
    arr = midilike.extract_events(prime).to_array()
    return [int(t) for t in arr[:prime_len]]


def write_midi(tokens: np.ndarray, path: str) -> None:
    from ..tokenizers import midilike
    tokens = np.asarray(tokens)
    tokens = tokens[tokens < midilike.EventSeq.dim()]
    midilike.write_midi(midilike.EventSeq.from_array(tokens), path)


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
    JAX CLI): a ``.npz`` shard's per-event control sequence, else
    'p1,...,p12;density' (an empty histogram is uniform), one control
    repeated every step."""
    from ..tokenizers.midilike import Control, ControlSeq

    if os.path.isdir(spec):
        raise SystemExit(
            "--control with a corpus directory needs `cli.tokenize --scheme "
            "midilike_control`, which comes with a later slice of the port; "
            "pass one .npz shard of such a corpus, or a "
            "'PITCH_HISTOGRAM;NOTE_DENSITY' spec")
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


def rnn_prime(model, prime: Optional[str], prime_len: int) -> List[int]:
    """The GRU families' prompt: PerformanceRNN starts from its primary
    event (reference generate.py:171-175), then the prime's tokens if
    any; EventMelodyRNN takes the prime (default [24, 28, 31])."""
    if model.family == "performance_rnn":
        return [model.primary_event] + (
            [] if prime is None else prime_tokens(prime, prime_len))
    return prime_tokens(prime, prime_len)


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
                        "pitches), or a midilike_control .npz shard")
    p.add_argument("--control-index", type=int, default=None,
                   help="sequence index inside a --control shard "
                        "(default: random)")
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
        model = load_checkpoint(
            args.checkpoint, device=args.device, dtype=_dtype(args),
            decode_quant=None if args.quant == "none" else args.quant)
    except ValueError as e:  # e.g. --quant int8 on a GRU checkpoint
        raise SystemExit(f"{args.checkpoint}: {e}") from None
    if model.family == "cp_transformer":
        return _generate_cp(model, args)
    if args.spec is not None:
        if model.family != "music_transformer":
            raise SystemExit("--spec needs a music_transformer target "
                             "(chunked verify forward)")
        if args.beam > 1:
            raise SystemExit("--spec is mutually exclusive with --beam")
    if model.family != "music_transformer":
        return _generate_rnn(model, args)
    if args.beam > 1 or args.control is not None:
        raise SystemExit("--beam and --control are for the GRU families "
                         "(event_rnn / performance_rnn)")
    return _generate_transformer(model, args)


def _sampling(args):
    from ..decode import SamplingParams
    # temperature 0 = greedy; top_p 0 means off, as the JAX CLI
    return SamplingParams(temperature=args.temperature, top_k=args.topk,
                          top_p=args.topp if args.topp > 0 else 1.0,
                          greedy=(args.temperature == 0.0))


def _write_outputs(outs, prime, args) -> None:
    nb = len(outs)
    stem, ext = os.path.splitext(args.output)
    for i, row in enumerate(outs):
        tokens = (np.concatenate([np.asarray(prime, np.int64), row])
                  if args.include_prime else row)
        path = args.output if nb == 1 else f"{stem}-{i:03d}{ext or '.mid'}"
        write_midi(tokens, path)
        print(f"wrote {path} ({len(tokens)} tokens)")


def _generate_rnn(model, args) -> int:
    """EventMelodyRNN / PerformanceRNN: sampled or greedy generation
    through ``decode.generate``, or (stochastic) beam search."""
    from ..decode import DecodeParams, generate

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
    prime = rnn_prime(model, args.prime, args.prime_len)
    prompt = torch.tensor([prime] * nb, dtype=torch.long,
                          device=model.device)
    if controls is not None:
        controls = controls.expand(-1, nb, -1)
    if args.beam > 1:
        if nb > 1:
            raise SystemExit("--batch and --beam are mutually exclusive "
                             "(a beam already explores N hypotheses)")
        outs = beam_decode(model, prompt, args.steps, args.beam,
                           args.temperature or 1.0, args.stochastic_beam,
                           gen, controls, cache0)[None]
    else:
        dp = DecodeParams(max_len=len(prime) + args.steps, steps=args.steps,
                          sampling=_sampling(args))
        outs = generate(model, prompt, gen, dp, controls=controls,
                        cache0=cache0)
    _write_outputs(outs.cpu().numpy(), prime, args)
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
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    try:
        out = generate_cp(model, np.tile(rows[None], (nb, 1, 1)), args.steps,
                          max_len=rows.shape[0] + args.steps,
                          temperature=args.temperature or 1.0,
                          greedy=(args.temperature == 0.0), generator=gen)
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


def _generate_transformer(model, args) -> int:
    from ..decode import DecodeParams, generate, generate_sliding

    prime = prime_tokens(args.prime, args.prime_len)
    nb = max(args.batch, 1)
    prompt = np.tile(np.asarray(prime, np.int64)[None], (nb, 1))
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    if len(prime) + args.steps > model.max_seq:
        if nb > 1 or args.spec is not None:
            raise SystemExit(
                f"prime ({len(prime)}) + steps ({args.steps}) exceeds "
                f"max_seq ({model.max_seq}): --batch/--spec with a "
                "continuation beyond max_seq (sliding window) is not "
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
        outs = generate(model, torch.from_numpy(prompt), gen, dp,
                        prompt_len).cpu().numpy()
    _write_outputs(outs, prime, args)
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
