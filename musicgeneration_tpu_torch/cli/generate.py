"""Generate MIDI from an exported MusicTransformer checkpoint on the GPU.

    python -m musicgeneration_tpu_torch.cli.generate model.pth out.mid \\
        --prime prompt.mid --steps 512 --temperature 1.0 --topk 0

``model.pth`` is what ``python -m musicgeneration_tpu.cli.export_checkpoint
runs/mt model.pth`` writes. The prime is tokenized with the MIDI-like
codec, padded to a power-of-two bucket (>= 16) as the JAX CLI does, and
the continuation is written through the same codec (ids >= the codec's
dim, e.g. the pad id, are dropped). Runs on ``--device cuda`` by
default; a missing GPU is an error, not a fallback.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="exported .pth checkpoint")
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
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="float32", choices=sorted(_DTYPES))
    args = p.parse_args(argv)

    from ..convert import load_checkpoint
    from ..decode import DecodeParams, SamplingParams, generate

    model = load_checkpoint(args.checkpoint, device=args.device,
                            dtype=_DTYPES[args.dtype])
    prime = prime_tokens(args.prime, args.prime_len)
    if len(prime) + args.steps > model.max_seq:
        raise SystemExit(
            f"prime ({len(prime)}) + steps ({args.steps}) exceeds max_seq "
            f"({model.max_seq}); sliding-window generation is not ported")
    nb = max(args.batch, 1)
    prompt = np.tile(np.asarray(prime, np.int64)[None], (nb, 1))
    prompt, prompt_len = bucket_prompt(prompt, args.steps, model.max_seq,
                                       model.pad_id)
    # temperature 0 = greedy; top_p 0 means off, as the JAX CLI
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.topk,
                              top_p=args.topp if args.topp > 0 else 1.0,
                              greedy=(args.temperature == 0.0))
    dp = DecodeParams(max_len=prompt.shape[1] + args.steps,
                      steps=args.steps, sampling=sampling)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    outs = generate(model, torch.from_numpy(prompt), gen, dp,
                    prompt_len).cpu().numpy()
    stem, ext = os.path.splitext(args.output)
    for i, row in enumerate(outs):
        tokens = (np.concatenate([np.asarray(prime, np.int64), row])
                  if args.include_prime else row)
        path = args.output if nb == 1 else f"{stem}-{i:03d}{ext or '.mid'}"
        write_midi(tokens, path)
        print(f"wrote {path} ({len(tokens)} tokens)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
