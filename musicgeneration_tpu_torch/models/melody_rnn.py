"""MelodyRNN: LSTM language model over monophonic note arrays.

The port of ``musicgeneration_tpu/models/melody_rnn.py`` (reference
Melody_RNN, mg/model/MelodyRNN/train_basic_rnn.py:184-230):

* Embedding(130, 64) -> 2 x LSTM(64, dropout 0.5 between layers) ->
  Linear(64, 130) over the note-array vocabulary (0-127 pitch, 128 off,
  129 no event; ``tokenizers/melody.py``),
* ``attn_length > 0`` adds the JAX module's attention variant (Magenta's
  ``attention_rnn``, attn_length 40): each step attends additively
  (Bahdanau) over the previous ``attn_length`` top-layer outputs and
  mixes the context into the output: tanh(attn_mix([h, context])).

State-dict names are the JAX module's names with torch's LSTM layout
(the JAX package exports no MelodyRNN ``.pth``): ``embedding.weight``,
``lstm.weight_ih_l{k}`` / ``weight_hh_l{k}`` / ``bias_ih_l{k}`` /
``bias_hh_l{k}``, ``attn_query.weight``, ``attn_key.weight``,
``attn_v.weight`` (no biases), ``attn_mix.weight`` / ``.bias``,
``decoder.weight`` / ``.bias``. Parameters are float32; ``dtype`` is the
compute dtype.

The training ``forward`` runs the LSTM over the whole sequence and the
attention over every step at once (each step's window of W previous
outputs gathered, the unfilled start masked). ``decode_step`` carries
(h, c), the last W top-layer outputs oldest first (``attn_buf`` [W, B,
H]) and a per-row count ``attn_n`` [B], so rows admitted at different
times into a serving pool each mask their own unfilled window. No
kernel lies on either path: the JAX package's LSTM step is its scan too.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.lstm import LSTMStack
from ..tokenizers.melody import MELODY_VOCAB
from .event_rnn import reset_rnn_parameters
from .music_transformer import _linear
from .registry import register_model

NEG = -1e9


@register_model("melody_rnn")
class MelodyRNN(nn.Module):
    family = "melody_rnn"

    def __init__(self, vocab_size: int = MELODY_VOCAB, embed_size: int = 64,
                 hidden_dim: int = 64, num_layers: int = 2,
                 dropout_rate: float = 0.5, attn_length: int = 0,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.embed_size = embed_size
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.attn_length = attn_length
        self.dtype = dtype
        self.embedding = nn.Embedding(vocab_size, embed_size, device=device)
        self.lstm = LSTMStack(embed_size, hidden_dim, num_layers, dtype=dtype,
                              device=device, dropout_rate=dropout_rate)
        if attn_length > 0:
            self.attn_query = nn.Linear(hidden_dim, hidden_dim, bias=False,
                                        device=device)
            self.attn_key = nn.Linear(hidden_dim, hidden_dim, bias=False,
                                      device=device)
            self.attn_v = nn.Linear(hidden_dim, 1, bias=False, device=device)
            self.attn_mix = nn.Linear(2 * hidden_dim, hidden_dim,
                                      device=device)
        self.decoder = nn.Linear(hidden_dim, vocab_size, device=device)
        reset_rnn_parameters(self, generator)

    @property
    def device(self) -> torch.device:
        return self.decoder.weight.device

    def _lin(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if layer.bias is None:
            return F.linear(x.to(self.dtype), layer.weight.to(self.dtype))
        return _linear(layer, x, self.dtype)

    def _mix(self, h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self._lin(self.attn_mix,
                                    torch.cat([h, context], dim=-1)))

    def forward(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """tokens: [T, B] ints (time-major) -> logits [T, B, vocab] f32.
        With ``lengths`` [B], padded positions neither advance the state
        nor give output (torch ``pack_padded_sequence``,
        train_basic_rnn.py:223-226); dropout between the LSTM layers
        when not ``deterministic``, its masks from ``generator``."""
        b = tokens.shape[1]
        xs = F.embedding(tokens.long(), self.embedding.weight.to(self.dtype))
        outputs, _ = self.lstm(xs, self.lstm.zero_state(b, xs.device),
                               lengths=lengths, deterministic=deterministic,
                               generator=generator)
        if self.attn_length > 0:
            outputs = self._windowed_attention(outputs)
        return self._lin(self.decoder, outputs).float()

    def _windowed_attention(self, outputs: torch.Tensor) -> torch.Tensor:
        """Each step t attends over outputs[t - W:t] (zeros before the
        start, masked), the window oldest first as ``decode_step``'s
        buffer; the key product is taken once per output."""
        w = self.attn_length
        t_len, b, hd = outputs.shape
        pad = outputs.new_zeros(w, b, hd)
        # win[t, j] = outputs[t + j - w]: the w outputs before step t
        idx = (torch.arange(t_len, device=outputs.device)[:, None]
               + torch.arange(w, device=outputs.device)[None, :])
        keys = torch.cat([pad, self._lin(self.attn_key, outputs)])[idx]
        vals = torch.cat([pad, outputs])[idx]                  # [T, W, B, H]
        q = self._lin(self.attn_query, outputs)                # [T, B, H]
        scores = self._lin(self.attn_v, torch.tanh(keys + q[:, None]))
        valid = (idx >= w)[:, :, None, None]
        weights = torch.softmax(torch.where(valid, scores, NEG), dim=1)
        context = (weights * vals).sum(dim=1)                  # [T, B, H]
        return self._mix(outputs, context)

    # -- incremental decoding -------------------------------------------------

    @torch.no_grad()
    def init_cache(self, batch: int, init=None) -> Dict:
        """The decode state: {"h", "c"} [L, B, H] zeros and, with
        attention, "attn_buf" [W, B, H] and "attn_n" [B]. MelodyRNN has
        no latent: ``init`` must be None."""
        if init is not None:
            raise ValueError("MelodyRNN has no init latent")
        h, c = self.lstm.zero_state(batch, self.device)
        cache = {"h": h, "c": c}
        if self.attn_length > 0:
            cache["attn_buf"] = torch.zeros(
                self.attn_length, batch, self.hidden_dim, dtype=self.dtype,
                device=self.device)
            cache["attn_n"] = torch.zeros(batch, dtype=torch.long,
                                          device=self.device)
        return cache

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Dict):
        """token: [B] ints -> (logits [B, vocab] f32, new cache)."""
        x = F.embedding(token.long(), self.embedding.weight.to(self.dtype))
        out, (h, c) = self.lstm.step(x, (cache["h"], cache["c"]))
        new = {"h": h, "c": c}
        if self.attn_length > 0:
            w = self.attn_length
            buf, n = cache["attn_buf"], cache["attn_n"]
            # the buffer is oldest first: its last min(n, w) rows are real
            valid = (torch.arange(w, device=n.device)[:, None]
                     >= (w - n.clamp_max(w))[None, :])[..., None]
            scores = self._lin(self.attn_v, torch.tanh(
                self._lin(self.attn_key, buf)
                + self._lin(self.attn_query, out)[None]))      # [W, B, 1]
            weights = torch.softmax(torch.where(valid, scores, NEG), dim=0)
            out = self._mix(out, (weights * buf).sum(dim=0))
            new["attn_buf"] = torch.cat([buf[1:], h[-1][None]])
            new["attn_n"] = n + 1
        return self._lin(self.decoder, out).float(), new
