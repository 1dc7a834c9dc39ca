"""musicgeneration_tpu_torch — the PyTorch/CUDA port of musicgeneration_tpu.

The flagship MusicTransformer's paths: generation (prompt MIDI -> tokens
(``tokenizers.midilike``), one-pass prefill through the hand-written
relative-attention kernel (``ops.fused_attention``), a per-token decode
step through the hand-written fused decode kernel (``ops.fused_decode``),
top-k/nucleus sampling (``decode.sampling``), tokens -> MIDI); training
(``train``, ``cli.train``, the attention backward kernel); and
continuous-batching serving (``decode.serving``, ``cli.serve``, kernel
B's ragged mode). Weights come from the JAX package's exported ``.pth``
or the port's own training checkpoints (``convert.load_checkpoint``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is none raises. This package imports
neither jax nor ``musicgeneration_tpu``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present (the port never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
