"""MusicTransformer: decoder-only transformer with relative global attention.

The port of ``musicgeneration_tpu/models/music_transformer.py`` for
generation, with the reference's architecture (mg/model/MusicTransformer/
{network.py:14-40, layers.py:42-233}):

* embedding * sqrt(d_model) + the reference's sinusoid,
* N x [RGA -> post-LN -> FFN(relu) -> post-LN], heads = d_model // 64,
  LayerNorm eps 1e-6, final Linear to vocab, pad id = vocab_size - 1,

and the reference's state-dict names (``Decoder.embedding.weight``,
``Decoder.enc_layers.{i}.rga.Wq.weight``, ..., ``fc.weight``), so a
checkpoint from ``musicgeneration_tpu.cli.export_checkpoint`` loads with
``load_state_dict(strict=True)``.

Parameters are float32; ``dtype`` is the compute dtype (bfloat16 on the
card), as the JAX module's ``dtype``. Full-sequence attention runs
``ops.fused_attention`` (kernel A forward and kernel C backward on CUDA)
and the decode step ``ops.fused_decode`` (kernel B on CUDA) over the
fused cache layout ``[L, B, S, d]``.

``forward`` is the training forward: it runs under autograd, with
dropout at the JAX module's three sites (after embedding + position,
after attention, after the FFN) drawn from an explicit
``torch.Generator``, ``pad_in_input``, ``logits_dtype`` and ``remat``
(``torch.utils.checkpoint`` per layer). The JAX ``scan_layers`` (a
compile-size lever of XLA) has no counterpart here.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops.fused_attention import fused_relative_attention
from ..ops.fused_decode import WEIGHT_KEYS, fused_decode_step
from ..ops.relative_attention import sinusoid_position_encoding

Cache = Dict[str, torch.Tensor]


def _linear(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """nn.Linear computed in ``dtype`` (flax Dense(dtype=...))."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    values by 1 / (1 - rate) in x's dtype. The mask is drawn from
    ``generator`` (on x's device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, result in x's dtype (flax
    LayerNorm(dtype=...))."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight,
                        ln.bias, ln.eps).to(x.dtype)


class RelativeGlobalAttentionBlock(nn.Module):
    """Multi-head self-attention with learned relative embeddings
    (layers.py:42-133)."""

    def __init__(self, d_model: int, num_heads: int, max_seq: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.Wq = nn.Linear(d_model, d_model, device=device)
        self.Wk = nn.Linear(d_model, d_model, device=device)
        self.Wv = nn.Linear(d_model, d_model, device=device)
        self.fc = nn.Linear(d_model, d_model, device=device)
        self.E = nn.Parameter(torch.empty(max_seq, d_model // num_heads,
                                          device=device))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, -1).transpose(1, 2).contiguous()

    def forward(self, x: torch.Tensor,
                key_pad: Optional[torch.Tensor] = None,
                return_kv: bool = False):
        """x: [B, L, d] -> [B, L, d] (and k, v: [B, H, L, dh])."""
        q = self._heads(_linear(self.Wq, x, self.dtype))
        k = self._heads(_linear(self.Wk, x, self.dtype))
        v = self._heads(_linear(self.Wv, x, self.dtype))
        out = fused_relative_attention(q, k, v, self.E.float(), key_pad,
                                       causal=True)
        b, h, l, dh = out.shape
        out = _linear(self.fc, out.transpose(1, 2).reshape(b, l, h * dh),
                      self.dtype)
        return (out, k, v) if return_kv else out


class EncoderLayer(nn.Module):
    """RGA + FFN with post-LN (layers.py:136-161)."""

    def __init__(self, d_model: int, num_heads: int, max_seq: int,
                 ffn_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.rga = RelativeGlobalAttentionBlock(d_model, num_heads, max_seq,
                                                dtype=dtype, device=device)
        self.FFN_pre = nn.Linear(d_model, ffn_dim, device=device)
        self.FFN_suf = nn.Linear(ffn_dim, d_model, device=device)
        self.layernorm1 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.layernorm2 = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward_kv(self, x: torch.Tensor,
                   key_pad: Optional[torch.Tensor] = None):
        """Full-sequence forward that also returns this layer's K/V."""
        attn, k, v = self.rga(x, key_pad, return_kv=True)
        out1 = _layer_norm(self.layernorm1, attn + x)
        ffn = _linear(self.FFN_suf,
                      torch.relu(_linear(self.FFN_pre, out1, self.dtype)),
                      self.dtype)
        return _layer_norm(self.layernorm2, out1 + ffn), k, v

    def forward(self, x: torch.Tensor,
                key_pad: Optional[torch.Tensor] = None,
                drop: Optional[Callable] = None) -> torch.Tensor:
        """Training forward (layers.py:136-161): ``drop`` is the dropout
        applied after attention (drop1) and after the FFN (drop2), or
        None."""
        attn = self.rga(x, key_pad)
        if drop is not None:
            attn = drop(attn)
        out1 = _layer_norm(self.layernorm1, attn + x)
        ffn = _linear(self.FFN_suf,
                      torch.relu(_linear(self.FFN_pre, out1, self.dtype)),
                      self.dtype)
        if drop is not None:
            ffn = drop(ffn)
        return _layer_norm(self.layernorm2, out1 + ffn)


class _Decoder(nn.Module):
    """Holds the reference's ``Decoder.*`` parameters."""

    def __init__(self, vocab_size, num_layers, d_model, num_heads, max_seq,
                 ffn_dim, dtype, device):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, d_model, device=device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, max_seq, ffn_dim, dtype=dtype,
                         device=device)
            for _ in range(num_layers))


class MusicTransformer(nn.Module):
    """vocab 309, 6 layers, d_model 256, max_seq 2048 is the flagship
    (``music_transformer_defaults``). ``generator``: optional CPU
    ``torch.Generator`` for the random initial weights (see
    ``reset_parameters``). ``pad_in_input=False`` asserts that training
    inputs hold no pad id (dense crops): ``forward`` then masks causally
    only and the kernels take no key_pad; prefill and decode always mask
    pads."""

    def __init__(self, vocab_size: int = 390, num_layers: int = 6,
                 d_model: int = 256, max_seq: int = 2048,
                 head_dim: int = 64, ffn_dim: int = 0,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.1, pad_in_input: bool = True,
                 logits_dtype=torch.float32, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        if d_model % head_dim:
            raise ValueError(f"d_model {d_model} not divisible by head_dim "
                             f"{head_dim}")
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.max_seq = max_seq
        self.num_heads = d_model // head_dim
        self.ffn_dim = ffn_dim or d_model // 2
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.pad_in_input = pad_in_input
        self.logits_dtype = logits_dtype
        self.remat = remat
        self.Decoder = _Decoder(vocab_size, num_layers, d_model,
                                self.num_heads, max_seq, self.ffn_dim,
                                dtype, device)
        self.fc = nn.Linear(d_model, vocab_size, device=device)
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoid_position_encoding(max_seq, d_model)
                             ).to(device),
            persistent=False)
        self.reset_parameters(generator)

    @property
    def pad_id(self) -> int:
        return self.vocab_size - 1

    @property
    def device(self) -> torch.device:
        return self.fc.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights drawn on the CPU (so one seed gives the same
        model on every device): Linear weights N(0, 1/fan_in), biases 0,
        LayerNorm 1/0, embeddings N(0, 1/d_model), E ~ N(0, 1) (the
        reference's torch.randn, layers.py:60)."""
        for name, p in self.named_parameters():
            if name.endswith(".E"):
                std = 1.0
            elif "embedding" in name:
                std = 1.0 / math.sqrt(p.shape[1])
            elif name.endswith("weight") and p.dim() == 2:
                std = 1.0 / math.sqrt(p.shape[1])
            elif "layernorm" in name and name.endswith("weight"):
                p.fill_(1.0)
                continue
            else:
                p.zero_()
                continue
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        scale = torch.tensor(math.sqrt(self.d_model), dtype=torch.float32)
        w = self.Decoder.embedding.weight.to(self.dtype)
        return w[tokens] * scale.to(self.dtype).to(w.device)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, L] int tokens -> logits [B, L, vocab] in
        ``logits_dtype`` (f32 by default), with autograd. With
        ``deterministic=False`` dropout draws its masks from
        ``generator`` (on the model's device); with ``remat`` the
        generator is rewound for each layer's recompute, so give each
        forward a generator of its own."""
        key_pad = (x == self.pad_id).float() if self.pad_in_input else None
        h = self._embed(x) + self.pos_table[:x.shape[1]].to(self.dtype)[None]
        drop = None
        if not deterministic and self.dropout_rate > 0.0:
            def drop(y):
                return dropout(y, self.dropout_rate, generator)
            h = drop(h)
        for layer in self.Decoder.enc_layers:
            if self.remat and torch.is_grad_enabled():
                h = _remat(layer, h, key_pad, drop, generator)
            else:
                h = layer(h, key_pad, drop)
        return _linear(self.fc, h, self.dtype).to(self.logits_dtype)

    # -- incremental decoding -------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        shape = (self.num_layers, batch, cache_len, self.d_model)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, x: torch.Tensor, cache_len: int,
                last_idx: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
        """One-pass prompt ingestion: x [B, P] -> (logits [B, vocab] f32 at
        position ``last_idx`` (default P-1), cache [L, B, cache_len, d]).

        ``last_idx`` serves bucketed prompts padded with pad_id past the
        true prompt: causal masking keeps the pad tail from reaching any
        position <= last_idx, and generation overwrites its cache rows."""
        b, p = x.shape
        if p > cache_len:
            raise ValueError(f"prompt ({p}) longer than the cache "
                             f"({cache_len})")
        key_pad = (x == self.pad_id).float()
        h = self._embed(x) + self.pos_table[:p].to(self.dtype)[None]
        cache = self.init_cache(b, cache_len)
        for i, layer in enumerate(self.Decoder.enc_layers):
            h, k, v = layer.forward_kv(h, key_pad)
            # [B, H, P, dh] -> fused layout rows [B, P, d]
            cache["k"][i, :, :p] = k.transpose(1, 2).reshape(b, p, -1)
            cache["v"][i, :, :p] = v.transpose(1, 2).reshape(b, p, -1)
        h_last = h[:, -1] if last_idx is None else h[:, last_idx]
        return _linear(self.fc, h_last, self.dtype).float(), cache

    @torch.no_grad()
    def decode_weights(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Stacked [L, ...] weights for ``fused_decode_step`` (matrices
        [in, out], in the compute dtype) and the stacked E tables
        [L, max_seq, dh] f32. Build once per generation, not per token."""
        def mats(layer):
            r = layer.rga
            return {
                "wq": r.Wq.weight.T, "bq": r.Wq.bias,
                "wk": r.Wk.weight.T, "bk": r.Wk.bias,
                "wv": r.Wv.weight.T, "bv": r.Wv.bias,
                "wfc": r.fc.weight.T, "bfc": r.fc.bias,
                "ln1_scale": layer.layernorm1.weight,
                "ln1_bias": layer.layernorm1.bias,
                "ffn1_w": layer.FFN_pre.weight.T,
                "ffn1_b": layer.FFN_pre.bias,
                "ffn2_w": layer.FFN_suf.weight.T,
                "ffn2_b": layer.FFN_suf.bias,
                "ln2_scale": layer.layernorm2.weight,
                "ln2_bias": layer.layernorm2.bias,
            }
        per_layer = [mats(layer) for layer in self.Decoder.enc_layers]
        w_all = {k: torch.stack([m[k] for m in per_layer]).to(
            self.dtype).contiguous() for k in WEIGHT_KEYS}
        e_all = torch.stack([layer.rga.E for layer in self.Decoder.enc_layers]
                            ).float().contiguous()
        return w_all, e_all

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache, t: int,
                    stacked) -> Tuple[torch.Tensor, Cache]:
        """token: [B] int at absolute position t -> (logits [B, vocab]
        f32, cache with row t written in place). ``stacked``: the
        ``decode_weights()`` pair."""
        w_all, e_all = stacked
        h = self._embed(token) + self.pos_table[t].to(self.dtype)
        h, cache["k"], cache["v"] = fused_decode_step(
            h, t, e_all, w_all, cache["k"], cache["v"], self.num_heads)
        return _linear(self.fc, h, self.dtype).float(), cache


def _remat(layer: EncoderLayer, h, key_pad, drop, generator):
    """One layer under ``torch.utils.checkpoint`` (the JAX ``nn.remat``):
    its activations are recomputed in the backward pass, with the
    dropout generator rewound so the recompute draws the same masks."""
    state = generator.get_state() if generator is not None else None

    def run(x):
        if state is not None:
            generator.set_state(state)
        return layer(x, key_pad, drop)

    return checkpoint(run, h, use_reentrant=False, preserve_rng_state=False)


def music_transformer_defaults(**overrides) -> dict:
    cfg = dict(vocab_size=309, num_layers=6, d_model=256, max_seq=2048)
    cfg.update(overrides)
    return cfg
