"""Import a reference (torch) checkpoint into a ``cli.train`` run of the
port: the port of ``musicgeneration_tpu.cli.import_checkpoint``.

The reference saves three on-disk formats:

* ``{'net': state_dict, 'optimizer': ..., 'epoch': N}`` —
  MusicTransformer (``MusicTransformer/train.py:201-211``)
* ``{'model_config': ..., 'model_state': state_dict,
  'model_optimizer_state': ...}`` — PerformanceRNN session dicts
  (``PerformanceRNN/train.py:195-201``)
* bare ``state_dict`` — Event_MelodyRNN / PoPMAG_RNN
  (``Event_MelodyRNN/train.py:188-195``, ``PoPMAG_RNN/train.py:185``)

This CLI detects the format and the model family from the tensor keys,
infers the hyperparameters from the tensor shapes, and writes a
``step-<N>.pt`` with the config the JAX CLI writes (``cli``, ``scheme``,
``model_kwargs``, ``imported_from``). The port's state dicts carry the
reference names, so the weights are kept as they are (in float32).
``cli.generate``, ``cli.serve`` and ``cli.eval`` read the directory::

    python -m musicgeneration_tpu_torch.cli.import_checkpoint \\
        train-3049-0.6044921875.pth runs/imported [--scheme remi]
    python -m musicgeneration_tpu_torch.cli.generate runs/imported out.mid

Imported checkpoints carry model parameters only (no optimizer state),
as the JAX CLI's do: use them for generation or eval; ``cli.train``
refuses to resume from them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, Optional, Tuple


def _gru_layers(sd: Dict[str, Any], key: str) -> int:
    n = 0
    while f"{key}.weight_ih_l{n}" in sd:
        n += 1
    return n


# --------------------------------------------------------------------------
# Per-family shape inference: state_dict -> (model_kwargs, scheme)
# --------------------------------------------------------------------------

def convert_music_transformer(sd: Dict[str, Any]):
    """network.MusicTransformer (Decoder = Encoder of EncoderLayers,
    layers.py:136-161 + 207-233, final fc network.py:33)."""
    n_layers = 0
    while f"Decoder.enc_layers.{n_layers}.rga.Wq.weight" in sd:
        n_layers += 1
    vocab = sd["fc.weight"].shape[0]
    kwargs = {"vocab_size": vocab, "num_layers": n_layers,
              "d_model": sd["Decoder.embedding.weight"].shape[1],
              "max_seq": sd["Decoder.enc_layers.0.rga.E"].shape[0]}
    # reference vocab = event_dim + pad(s) per scheme (config.py:11-16)
    scheme = {309: "midilike", 337: "remi", 390: "pedal",
              131: "melody"}.get(vocab)
    return kwargs, scheme


def convert_event_rnn(sd: Dict[str, Any]):
    """Event_Melody_RNN (Event_MelodyRNN/network.py:12-33)."""
    kwargs = {
        "event_dim": sd["event_embedding.weight"].shape[0],
        "init_dim": sd["inithid_fc.weight"].shape[1],
        "hidden_dim": sd["output_fc.weight"].shape[1],
        "num_layers": _gru_layers(sd, "rnn"),
    }
    return kwargs, "midilike"


def convert_performance_rnn(sd: Dict[str, Any]):
    """PerformanceRNN (PerformanceRNN/network.py:16-42): concat input =
    [event embed (event_dim) | default flag (1) | control (control_dim)]."""
    event_dim = sd["event_embedding.weight"].shape[0]
    kwargs = {
        "event_dim": event_dim,
        "control_dim": sd["concat_input_fc.weight"].shape[1] - event_dim - 1,
        "init_dim": sd["inithid_fc.weight"].shape[1],
        "hidden_dim": sd["gru.weight_hh_l0"].shape[1],
        "num_layers": _gru_layers(sd, "gru"),
    }
    return kwargs, "midilike_control"


def convert_popmag(sd: Dict[str, Any]):
    """PoPMAG_RNN (PoPMAG_RNN/network.py:20-57): event_dim recovered from
    the head widths (out_len[0] = event_dim - 1 - note_on - note_duration,
    :50), bar_dim = embedding rows - event_dim."""
    head_widths = [sd[f"output_fc.{i}.weight"].shape[0] for i in range(3)]
    event_dim = head_widths[0] + 1 + head_widths[1] + head_widths[2]
    emb = sd["event_embedding.weight"]
    kwargs = {
        "event_dim": event_dim,
        "bar_dim": emb.shape[0] - event_dim,
        "init_dim": sd["inithid_fc.weight"].shape[1],
        "embed_dim": emb.shape[1],
        "hidden_dim": sd["encoder.weight_hh_l0"].shape[1],
        "num_layers": _gru_layers(sd, "encoder"),
    }
    return kwargs, "mumidi"


_FAMILIES = {
    "music_transformer": convert_music_transformer,
    "event_rnn": convert_event_rnn,
    "performance_rnn": convert_performance_rnn,
    "popmag": convert_popmag,
}


def detect_format(ckpt: Any) -> Tuple[Dict[str, Any], int]:
    """-> (state_dict, step). Handles all three reference save formats."""
    if isinstance(ckpt, dict) and "net" in ckpt:
        # MusicTransformer {'net','optimizer','epoch'} (train.py:203)
        return dict(ckpt["net"]), int(ckpt.get("epoch", 0) or 0)
    if isinstance(ckpt, dict) and "model_state" in ckpt:
        # PerformanceRNN session dict (train.py:195-201)
        return dict(ckpt["model_state"]), 0
    if isinstance(ckpt, dict) and all(
            hasattr(v, "shape") for v in ckpt.values()):
        return dict(ckpt), 0  # bare state_dict
    raise SystemExit(
        "unrecognized checkpoint layout: expected the reference's "
        "{'net',...}, {'model_state',...} or a bare state_dict; got "
        f"keys {sorted(ckpt)[:8] if isinstance(ckpt, dict) else type(ckpt)}")


def detect_family(sd: Dict[str, Any]) -> str:
    if any(k.startswith("Decoder.enc_layers.") for k in sd):
        return "music_transformer"
    if "concat_input_fc.weight" in sd:
        return "performance_rnn"
    if "encoder.weight_ih_l0" in sd and "decoder.weight_ih_l0" in sd:
        return "popmag"
    if "rnn.weight_ih_l0" in sd:
        return "event_rnn"
    raise SystemExit(
        "cannot identify the model family from state_dict keys "
        f"(sample: {sorted(sd)[:6]}); pass --model explicitly")


def import_torch_checkpoint(path: str, out_dir: str,
                            model: Optional[str] = None,
                            scheme: Optional[str] = None,
                            step: Optional[int] = None) -> Dict[str, Any]:
    """Convert ``path`` (a reference .pth) into out_dir/step-N.pt and
    return the written config."""
    import torch

    from ..utils.checkpoint import write_payload
    from .train import TrainCLIConfig

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except OSError:
        raise   # missing/unreadable file: full unpickling won't help
    except Exception:
        # session dicts can carry non-tensor config objects; the file is
        # user-supplied, so the fallback matches torch<2.6 semantics
        print("NOTE: weights_only load failed, retrying with full "
              "unpickling (only import checkpoints you trust)",
              file=sys.stderr)
        ckpt = torch.load(path, map_location="cpu", weights_only=False)

    sd, ckpt_step = detect_format(ckpt)
    family = model or detect_family(sd)
    if family not in _FAMILIES:
        raise SystemExit(f"unknown --model {family!r} "
                         f"(one of {sorted(_FAMILIES)})")
    kwargs, inferred_scheme = _FAMILIES[family](sd)
    scheme = scheme or inferred_scheme
    if scheme is None:
        raise SystemExit(
            f"cannot infer the token scheme from vocab "
            f"{kwargs.get('vocab_size')}; pass --scheme")

    cli = TrainCLIConfig(model=family)
    if "max_seq" in kwargs:
        cli.seq_len = kwargs["max_seq"]
    config = {"cli": cli.to_dict(), "scheme": scheme,
              "model_kwargs": kwargs, "imported_from": path}
    n = ckpt_step if step is None else step
    weights = {k: torch.as_tensor(v).float().contiguous()
               for k, v in sd.items()}
    out = write_payload(out_dir, n, {"step": int(n), "model": weights,
                                     "config": config})
    print(f"imported {family} ({scheme}) -> {out}")
    print(f"  model_kwargs: {kwargs}")
    return config


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m musicgeneration_tpu_torch.cli.import_checkpoint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_ckpt", help="reference .pth file")
    p.add_argument("out_dir", help="output checkpoint directory")
    p.add_argument("--model", default=None,
                   help="model family override (auto-detected from the "
                        f"state_dict keys): one of {sorted(_FAMILIES)}")
    p.add_argument("--scheme", default=None,
                   help="token scheme override (auto-inferred from the "
                        "vocab size where unambiguous)")
    p.add_argument("--step", type=int, default=None,
                   help="step label for the written checkpoint "
                        "(default: the reference's saved epoch, or 0)")
    args = p.parse_args(argv)
    import_torch_checkpoint(args.torch_ckpt, args.out_dir,
                            model=args.model, scheme=args.scheme,
                            step=args.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
