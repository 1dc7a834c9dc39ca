"""PoPMAG: melody -> arrangement seq2seq over MuMIDI compound tokens.

The port of ``musicgeneration_tpu/models/popmag.py``, with the reference
PoPMAG_RNN's architecture (mg/model/PoPMAG_RNN/network.py:19-417) and
state-dict names (``event_embedding``, ``inithid_fc``, ``encoder``,
``decoder``, ``output_fc.0/1/2``; ``export_popmag``,
``cli/export_checkpoint.py:136-147``):

* one shared embedding table of event_dim + bar_dim rows (bar-position
  ids live above the event vocab, network.py:38,60-66),
* compound input = the SUM of the 7 slot embeddings (``compression``,
  network.py:141-149); slot id 0 is the MuMIDI 'empty' token and adds
  its embedding (a reference quirk, kept),
* an encoder GRU over melody bar k and a decoder GRU over arrangement
  bar k, with packed-sequence semantics (per-bar true lengths) and the
  carried state hidden_{k+1} = enc_hidden_k + dec_hidden_k
  (network.py:323-363),
* 3 output heads, event type (196) / pitch (256) / duration (32), padded
  to f32 [.., 3, 256] with -1e10 (``final_predict``); raw logits, as the
  JAX module (the reference's double softmax is not kept),
* defaults: embed 256, hidden 256, 2 layers, init_dim 32, bar_dim 188,
  dropout 0.5 between GRU layers in training.

Parameters are float32; ``dtype`` is the compute dtype. The training
``forward`` and ``encode_bar`` run ``GRUStack.forward`` in plain torch
(the JAX module's ``lax.scan``); ``decode_compound_step`` runs the
decoder's step through ``GRUStack.step``, kernel D on CUDA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..data import mumidi_packing as mp
from ..ops.gru import GRUStack
from .event_rnn import reset_rnn_parameters
from .music_transformer import _linear
from .registry import register_model


@register_model("popmag")
class PoPMAGRNN(nn.Module):
    family = "popmag"

    def __init__(self, event_dim: int = mp.EVENT_DIM,
                 bar_dim: int = mp.DEFAULT_BAR_DIM, init_dim: int = 32,
                 embed_dim: int = 256, hidden_dim: int = 256,
                 num_layers: int = 2, dropout_rate: float = 0.5,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.event_dim = event_dim
        self.bar_dim = bar_dim
        self.init_dim = init_dim
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.dropout_rate = dropout_rate
        self.dtype = dtype
        self.event_embedding = nn.Embedding(event_dim + bar_dim, embed_dim,
                                            device=device)
        self.inithid_fc = nn.Linear(init_dim, num_layers * hidden_dim,
                                    device=device)
        self.encoder = GRUStack(embed_dim, hidden_dim, num_layers,
                                dtype=dtype, device=device,
                                dropout_rate=dropout_rate)
        self.decoder = GRUStack(embed_dim, hidden_dim, num_layers,
                                dtype=dtype, device=device,
                                dropout_rate=dropout_rate)
        self.output_fc = nn.ModuleList(
            nn.Linear(hidden_dim, n, device=device) for n in mp.OUT_LEN)
        reset_rnn_parameters(self, generator)

    @property
    def device(self) -> torch.device:
        return self.inithid_fc.weight.device

    def init_to_hidden(self, init: torch.Tensor) -> torch.Tensor:
        """init: [B, init_dim] -> [L, B, H] (network.py:68-74)."""
        b = init.shape[0]
        out = torch.tanh(_linear(self.inithid_fc, init, self.dtype))
        return out.reshape(b, self.num_layers,
                           self.hidden_dim).transpose(0, 1).contiguous()

    def compression(self, compound: torch.Tensor) -> torch.Tensor:
        """[..., 7] compound ids -> [..., embed_dim], the summed slot
        embeddings (network.py:141-149)."""
        return F.embedding(compound.long(), self.event_embedding.weight).to(
            self.dtype).sum(-2)

    def final_predict(self, outputs: torch.Tensor) -> torch.Tensor:
        """[..., H] -> f32 [..., 3, MX_DIM] logits, -1e10 in each head's
        padding."""
        heads = [F.pad(_linear(fc, outputs, self.dtype).float(),
                       (0, mp.MX_DIM - n), value=-1e10)
                 for fc, n in zip(self.output_fc, mp.OUT_LEN)]
        return torch.stack(heads, dim=-2)

    def forward(self, init: torch.Tensor, src: torch.Tensor,
                src_len: torch.Tensor, tar: torch.Tensor,
                tar_len: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward (reference ``Train``, network.py:323-363).

        init: [B, init_dim]; src/tar: [B, bars, bar_len, 7] compound ids
        with the SAME bar count; *_len: [B, bars]. Returns logits [B,
        bars, tar_len, 3, MX_DIM] (f32). With ``deterministic=False`` the
        GRUs' inter-layer dropout draws from ``generator``.

        Each bar's GRUs run to the longest length in the batch (read to
        the host once a call), not to the padded width: the steps past
        every row's length change no hidden and give zero outputs, so the
        logits are the JAX module's, which scans the whole width."""
        hidden = self.init_to_hidden(init)
        s_len, t_len = (int(v) for v in torch.stack(
            [src_len.max(), tar_len.max()]).tolist())
        s_len = min(max(s_len, 1), src.shape[2])
        t_len = min(max(t_len, 1), tar.shape[2])
        src_e = self.compression(src[:, :, :s_len])   # [B, bars, S, E]
        tar_e = self.compression(tar[:, :, :t_len])   # [B, bars, T, E]
        outs = []
        for k in range(src.shape[1]):
            _, enc_h = self.encoder(
                src_e[:, k].transpose(0, 1), hidden, lengths=src_len[:, k],
                deterministic=deterministic, generator=generator)
            dec_out, dec_h = self.decoder(
                tar_e[:, k].transpose(0, 1), enc_h, lengths=tar_len[:, k],
                deterministic=deterministic, generator=generator)
            hidden = enc_h + dec_h                      # network.py:354
            outs.append(dec_out.transpose(0, 1))
        dec_outs = F.pad(torch.stack(outs, dim=1),
                         (0, 0, 0, tar.shape[2] - t_len))
        return self.final_predict(dec_outs)

    # -- generation -----------------------------------------------------------

    def encode_bar(self, src_bar_e: torch.Tensor, hidden: torch.Tensor,
                   lengths: torch.Tensor) -> torch.Tensor:
        """One melody bar -> the encoder's hidden [L, B, H]. src_bar_e:
        [B, S, E] (``compression`` of the bar's rows)."""
        _, enc_h = self.encoder(src_bar_e.transpose(0, 1), hidden,
                                lengths=lengths)
        return enc_h

    def decode_compound_step(self, compound: torch.Tensor,
                             hidden: torch.Tensor):
        """One decoder step through ``GRUStack.step`` (kernel D on CUDA).
        compound: [B, 7] -> (logits [B, 3, MX_DIM] f32, hidden [L, B,
        H])."""
        out, hidden = self.decoder.step(self.compression(compound), hidden)
        return self.final_predict(out), hidden
