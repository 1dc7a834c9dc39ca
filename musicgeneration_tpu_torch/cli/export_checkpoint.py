"""Export a ``cli.train`` run of the port to the reference's torch
format: the port of ``musicgeneration_tpu.cli.export_checkpoint``, the
inverse of ``cli.import_checkpoint``.

Formats written, as each reference trainer saves them:

* music_transformer -> ``{'net': state_dict, 'optimizer': {},
  'epoch': step}`` (``MusicTransformer/train.py:201-211``; the optimizer
  entry is empty, as the JAX CLI writes it: exported checkpoints are for
  generation and finetune-init, not for resuming torch's optimizer)
* performance_rnn -> ``{'model_config', 'model_state',
  'model_optimizer_state'}`` session dict
  (``PerformanceRNN/train.py:195-201``; model_config mirrors
  ``PerformanceRNN/config.py:6-13``)
* event_rnn / popmag -> bare ``state_dict``
  (``Event_MelodyRNN/train.py:188-195``, ``PoPMAG_RNN/train.py:185``)

The port's step files already hold each family's state dict under the
reference names (``convert.py``), so the export writes them in float32
and wraps them. MelodyRNN and the CP transformer have no reference
format and are refused, as in the JAX CLI.

    python -m musicgeneration_tpu_torch.cli.export_checkpoint runs/mt out.pth
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict

import torch


def export_music_transformer(sd: Dict[str, torch.Tensor],
                             kwargs: Dict[str, Any], step: int):
    dh = int(sd["Decoder.enc_layers.0.rga.E"].shape[-1])
    if dh != 64:
        raise ValueError(
            f"head_dim={dh} has no reference analogue: the reference "
            "hard-codes h = d_model // 64 (MusicTransformer/layers.py:"
            "45-60), so its E table is [max_seq, 64] — only "
            "head_dim=64 checkpoints can round-trip")
    return {"net": sd, "optimizer": {}, "epoch": int(step)}


def export_event_rnn(sd, kwargs, step):
    return sd


def export_performance_rnn(sd, kwargs, step):
    # PerformanceRNN/config.py:6-13 field names; every shape-derivable
    # field comes from the state dict the reference's strict load checks
    event_dim = sd["event_embedding.weight"].shape[0]
    gru_layers = 0
    while f"gru.weight_ih_l{gru_layers}" in sd:
        gru_layers += 1
    model_config = {
        "init_dim": sd["inithid_fc.weight"].shape[1],
        "event_dim": event_dim,
        "control_dim": (sd["concat_input_fc.weight"].shape[1]
                        - event_dim - 1),
        "hidden_dim": sd["gru.weight_hh_l0"].shape[1],
        "gru_layers": gru_layers,
        "gru_dropout": kwargs.get("dropout_rate", 0.3),
    }
    return {"model_config": model_config, "model_state": sd,
            "model_optimizer_state": {}}


def export_popmag(sd, kwargs, step):
    return sd


_FAMILIES = {
    "music_transformer": export_music_transformer,
    "event_rnn": export_event_rnn,
    "performance_rnn": export_performance_rnn,
    "popmag": export_popmag,
}


def export_torch_checkpoint(ckpt_dir: str, out_path: str) -> str:
    """Convert the newest checkpoint in ``ckpt_dir`` (or a step file) to
    the reference's torch format at ``out_path``."""
    from ..utils.checkpoint import restore_checkpoint

    payload = restore_checkpoint(ckpt_dir)
    meta = payload.get("config", {})
    if "cli" not in meta:
        raise SystemExit("checkpoint has no CLI config; re-save with "
                         "cli.train (or import_checkpoint) first")
    family = meta["cli"].get("model", "music_transformer")
    if family not in _FAMILIES:
        raise SystemExit(
            f"model {family!r} has no reference torch format "
            f"(exportable: {sorted(_FAMILIES)})")
    sd = {k: v.float().contiguous() for k, v in payload["model"].items()}
    step = payload.get("step", 0)
    obj = _FAMILIES[family](sd, dict(meta.get("model_kwargs", {})), step)
    torch.save(obj, out_path)
    print(f"exported {family} step {step} -> {out_path}")
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m musicgeneration_tpu_torch.cli.export_checkpoint",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("ckpt_dir", help="checkpoint file or directory "
                   "(latest step is used)")
    p.add_argument("output", help="output .pth path")
    args = p.parse_args(argv)
    export_torch_checkpoint(args.ckpt_dir, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
