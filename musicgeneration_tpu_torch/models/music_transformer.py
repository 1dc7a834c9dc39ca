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
``ops.fused_attention`` (kernel A forward and kernel C backward on CUDA),
the decode step and the speculative verify forward ``ops.fused_decode``
(kernels B and E on CUDA) and the opt-in decode loop ``ops.decode_loop``
(kernel F) over the fused cache layout ``[L, B, S, d]``.
``decode_quant="int8"`` (the JAX module's field) runs the decode step,
and the verify forward where the JAX module takes its kernel, on
weight-only int8 matrices (``quantize_stream_weights``).

``attention_impl="ring"`` or ``"ring_pallas"`` with a ``mesh``
(``parallel.make_mesh``) runs full-sequence attention sequence-parallel
over the mesh's ``seq`` axis: the plain ring, or kernel G per round with
the plain ring's backward (``parallel/``). On a virtual mesh the model
takes the global ``[B, L]``; on a process group each rank gives its own
``[B, L / n]`` shard and the positional rows are taken at its global
offset.

With a ``mesh`` whose ``model`` axis is > 1 (``parallel.make_mesh(tp=N)``)
the layers, the embedding and the head run on head shards
(``parallel/tensor_parallel.py``): each model shard's Wq/Wk/Wv rows give
its num_heads / tp heads, kernel A (and kernel C in the backward, or the
ring on each head shard with ``attention_impl="ring"``/``"ring_pallas"``)
runs on [B, H / tp, L, 64] with the whole E, and the row-split fc,
FFN_suf and head sum their partial products in f32. Where tp does not
divide num_heads (or ffn_dim, or d_model), the attention block (or the
FFN, or the embedding and head) is replicated instead: every shard runs
all of it, kernel A on all heads, with no reduce. On a virtual mesh
the parameters stay whole and the shards run one after another on views
of them; on a process group each rank holds its shard
(``tensor_parallel.shard_params``). Such a model decodes through
``decode.generate_tp``.

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
from ..ops.decode_loop import (fused_decode_loop, loop_takes_cluster,
                               pack_loop_matrices)
from ..ops.fused_attention import fused_relative_attention
from ..ops.fused_decode import (WEIGHT_KEYS, fused_decode_chunk,
                                fused_decode_step, quantize_stream_weights)
from ..ops.relative_attention import sinusoid_position_encoding
from ..parallel import tensor_parallel as tp
from ..parallel.ring_attention import ring_relative_attention
from ..parallel.ring_attention_pallas import ring_relative_attention_pallas
from .registry import register_model

Cache = Dict[str, torch.Tensor]
ATTENTION_IMPLS = ("auto", "ring", "ring_pallas")


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


def _tp(mesh) -> bool:
    return mesh is not None and mesh.model > 1


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm with f32 statistics, result in x's dtype (flax
    LayerNorm(dtype=...))."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight,
                        ln.bias, ln.eps).to(x.dtype)


class RelativeGlobalAttentionBlock(nn.Module):
    """Multi-head self-attention with learned relative embeddings
    (layers.py:42-133)."""

    def __init__(self, d_model: int, num_heads: int, max_seq: int,
                 dtype=torch.float32, device=None,
                 attention_impl: str = "auto", mesh=None):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.dtype = dtype
        self.attention_impl = attention_impl
        self.mesh = mesh
        self.Wq = nn.Linear(d_model, d_model, device=device)
        self.Wk = nn.Linear(d_model, d_model, device=device)
        self.Wv = nn.Linear(d_model, d_model, device=device)
        self.fc = nn.Linear(d_model, d_model, device=device)
        self.E = nn.Parameter(torch.empty(max_seq, d_model // num_heads,
                                          device=device))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, -1, self.head_dim).transpose(1, 2).contiguous()

    def attend(self, q, k, v, e, key_pad=None) -> torch.Tensor:
        """Causal relative attention of [B, H', L, dh] heads with the E
        table ``e`` (f32): kernel A, or the ring over the mesh's seq
        axis."""
        if self.attention_impl == "auto":
            return fused_relative_attention(q, k, v, e, key_pad, causal=True)
        ring = (ring_relative_attention_pallas
                if self.attention_impl == "ring_pallas"
                else ring_relative_attention)
        return ring(q, k, v, e, self.mesh, causal=True, key_pad=key_pad)

    def forward(self, x: torch.Tensor,
                key_pad: Optional[torch.Tensor] = None,
                return_kv: bool = False):
        """x: [B, L, d] -> [B, L, d] (and k, v: [B, H, L, dh])."""
        q = self._heads(_linear(self.Wq, x, self.dtype))
        k = self._heads(_linear(self.Wk, x, self.dtype))
        v = self._heads(_linear(self.Wv, x, self.dtype))
        out = self.attend(q, k, v, self.E.float(), key_pad)
        b, h, l, dh = out.shape
        out = _linear(self.fc, out.transpose(1, 2).reshape(b, l, h * dh),
                      self.dtype)
        return (out, k, v) if return_kv else out


class EncoderLayer(nn.Module):
    """RGA + FFN with post-LN (layers.py:136-161)."""

    def __init__(self, d_model: int, num_heads: int, max_seq: int,
                 ffn_dim: int, dtype=torch.float32, device=None,
                 attention_impl: str = "auto", mesh=None):
        super().__init__()
        self.dtype = dtype
        self.mesh = mesh
        self.rga = RelativeGlobalAttentionBlock(
            d_model, num_heads, max_seq, dtype=dtype, device=device,
            attention_impl=attention_impl, mesh=mesh)
        self.FFN_pre = nn.Linear(d_model, ffn_dim, device=device)
        self.FFN_suf = nn.Linear(ffn_dim, d_model, device=device)
        self.layernorm1 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.layernorm2 = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward_kv(self, x: torch.Tensor,
                   key_pad: Optional[torch.Tensor] = None):
        """Full-sequence forward that also returns this layer's K/V."""
        if _tp(self.mesh):
            raise ValueError("a model on a tensor-parallel mesh decodes "
                             "through decode.generate_tp")
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
        if _tp(self.mesh):
            return self.forward_tp(x, key_pad, drop)
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

    def tp_split(self, mesh) -> Tuple[bool, bool]:
        """Whether ``mesh``'s model axis splits this layer's heads and its
        FFN; a block it does not divide is replicated (every shard
        computes all of it, with no reduce)."""
        return (tp.divides(self.rga.num_heads, mesh),
                tp.divides(self.FFN_pre.out_features, mesh))

    def tp_weights(self, m: int, mesh=None) -> Dict[str, torch.Tensor]:
        """Model shard ``m``'s matrices (nn.Linear layout), its slices of
        the split layers' biases and E (f32; E and the biases have their
        gradients summed over the model axis, each shard's being
        partial), on ``mesh`` (default: the layer's). A replicated block
        (``tp_split``) gives every shard its whole weights and biases."""
        r, mesh = self.rga, mesh or self.mesh
        heads, ffn = self.tp_split(mesh)

        def mat(p, dim, split):
            return tp.local(p, dim, mesh, m) if split else p

        def bias(p, split):
            return tp.part(tp.copy_to_model(p, mesh), 0, mesh, m) \
                if split else p

        return {"wq": mat(r.Wq.weight, 0, heads), "bq": bias(r.Wq.bias, heads),
                "wk": mat(r.Wk.weight, 0, heads), "bk": bias(r.Wk.bias, heads),
                "wv": mat(r.Wv.weight, 0, heads), "bv": bias(r.Wv.bias, heads),
                "wfc": mat(r.fc.weight, 1, heads),
                "w1": mat(self.FFN_pre.weight, 0, ffn),
                "b1": bias(self.FFN_pre.bias, ffn),
                "w2": mat(self.FFN_suf.weight, 1, ffn),
                "e": (tp.copy_to_model(r.E, mesh) if heads else r.E).float()}

    def forward_tp(self, x: torch.Tensor,
                   key_pad: Optional[torch.Tensor] = None,
                   drop: Optional[Callable] = None, return_kv: bool = False,
                   weights: Optional[list] = None, mesh=None):
        """The layer on head shards of ``mesh`` (default: the layer's):
        ``weights`` holds one ``tp_weights`` dict a model shard this
        process runs (default: this layer's own), each with the
        ``"device"`` its shard runs on, current while it runs (default:
        x's). Returns [B, L, d] on the first shard's device, and with
        ``return_kv`` the shards' K and V lists ([B, H / tp, L, dh]
        each). A replicated block (``tp_split``) runs once, on the first
        shard's weights (the same on every shard), and its K and V lists
        hold one [B, H, L, dh] tensor."""
        mesh, dt, r = mesh or self.mesh, self.dtype, self.rga
        heads, ffn = self.tp_split(mesh)
        if weights is None:
            weights = [self.tp_weights(m, mesh) for m in tp.shards(mesh)]

        def lin(y, w, b=None):
            return F.linear(y.to(dt), w.to(dt), None if b is None
                            else b.to(dt))

        xc = tp.copy_to_model(x, mesh) if heads else x
        parts, ks, vs = [], [], []
        for w in weights if heads else weights[:1]:
            dev = w.get("device", x.device)
            with tp.on(dev):
                xs = xc.to(dev)
                q, k, v = (r._heads(lin(xs, w["w" + c], w["b" + c]))
                           for c in "qkv")
                kp = None if key_pad is None else key_pad.to(dev)
                out = r.attend(q, k, v, w["e"].to(dev), kp)
                b, h, l, dh = out.shape
                parts.append(lin(out.transpose(1, 2).reshape(b, l, h * dh),
                                 w["wfc"], None if heads else r.fc.bias))
            ks.append(k)
            vs.append(v)
        attn = tp.reduce_from_model(parts, mesh, r.fc.bias, dt) if heads \
            else parts[0]
        if drop is not None:
            attn = drop(attn)
        out1 = _layer_norm(self.layernorm1, attn + x)
        oc = tp.copy_to_model(out1, mesh) if ffn else out1
        parts = []
        for w in weights if ffn else weights[:1]:
            hid = torch.relu(lin(oc.to(w.get("device", x.device)), w["w1"],
                                 w["b1"]))
            parts.append(lin(hid, w["w2"], None if ffn else
                             self.FFN_suf.bias))
        ffn_out = tp.reduce_from_model(parts, mesh, self.FFN_suf.bias, dt) \
            if ffn else parts[0]
        if drop is not None:
            ffn_out = drop(ffn_out)
        out = _layer_norm(self.layernorm2, out1 + ffn_out)
        return (out, ks, vs) if return_kv else out


def stack_decode_weights(layers, dtype, quant: str = "none"
                         ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The ``EncoderLayer``s' weights stacked [L, ...] for
    ``fused_decode_step`` (matrices [in, out], in ``dtype``) and their E
    tables [L, max_seq, dh] f32; with ``quant="int8"`` the weights dict
    also holds, under "int8", (``quantize_stream_weights`` of the stack,
    its scales), quantized from the ``dtype`` stack as the JAX
    ``fused_layer_stack_step`` does."""
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown decode_quant {quant!r}")

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
    per_layer = [mats(layer) for layer in layers]
    w_all = {k: torch.stack([m[k] for m in per_layer]).to(dtype).contiguous()
             for k in WEIGHT_KEYS}
    e_all = torch.stack([layer.rga.E for layer in layers]).float().contiguous()
    if quant == "int8":
        w_all["int8"] = quantize_stream_weights(w_all)
    return w_all, e_all


class _Decoder(nn.Module):
    """Holds the reference's ``Decoder.*`` parameters."""

    def __init__(self, vocab_size, num_layers, d_model, num_heads, max_seq,
                 ffn_dim, dtype, device, attention_impl, mesh):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, d_model, device=device)
        self.enc_layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, max_seq, ffn_dim, dtype=dtype,
                         device=device, attention_impl=attention_impl,
                         mesh=mesh)
            for _ in range(num_layers))


@register_model("music_transformer",
                lambda **kw: music_transformer_defaults(**kw))
class MusicTransformer(nn.Module):
    """vocab 309, 6 layers, d_model 256, max_seq 2048 is the flagship
    (``music_transformer_defaults``). ``generator``: optional CPU
    ``torch.Generator`` for the random initial weights (see
    ``reset_parameters``). ``pad_in_input=False`` asserts that training
    inputs hold no pad id (dense crops): ``forward`` then masks causally
    only and the kernels take no key_pad; prefill and decode always mask
    pads. ``decode_quant``: "none" or "int8", weight-only int8 in the
    decode step and the verify forward (``decode_weights``).
    ``attention_impl``: "auto" (kernel A, or its plain version on the
    CPU), "ring" or "ring_pallas" (sequence-parallel over ``mesh``, which
    they need); the JAX module's "xla" and "pallas" are not taken."""

    family = "music_transformer"

    def __init__(self, vocab_size: int = 390, num_layers: int = 6,
                 d_model: int = 256, max_seq: int = 2048,
                 head_dim: int = 64, ffn_dim: int = 0,
                 dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.1, pad_in_input: bool = True,
                 logits_dtype=torch.float32, remat: bool = False,
                 decode_quant: str = "none", attention_impl: str = "auto",
                 mesh=None):
        super().__init__()
        if decode_quant not in ("none", "int8"):
            raise ValueError(f"unknown decode_quant {decode_quant!r}")
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl {attention_impl!r} is not one of "
                             f"{ATTENTION_IMPLS}")
        if attention_impl != "auto" and mesh is None:
            raise ValueError(f'attention_impl="{attention_impl}" needs mesh=')
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
        self.decode_quant = decode_quant
        self.attention_impl = attention_impl
        self.mesh = mesh if attention_impl != "auto" or _tp(mesh) else None
        self.Decoder = _Decoder(vocab_size, num_layers, d_model,
                                self.num_heads, max_seq, self.ffn_dim,
                                dtype, device, attention_impl, self.mesh)
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
        # sqrt(d_model) rounded to the compute dtype, as a Python float: a
        # scalar tensor copied to the device would sync the host per call
        scale = float(torch.tensor(math.sqrt(self.d_model)).to(self.dtype))
        w = self.Decoder.embedding.weight
        if _tp(self.mesh) and tp.divides(self.d_model, self.mesh):
            # d_model-split: gather before the scale
            return tp.gather_from_model(
                [tp.local(w, 1, self.mesh, m).to(self.dtype)[tokens]
                 for m in tp.shards(self.mesh)], self.mesh) * scale
        return w.to(self.dtype)[tokens] * scale

    def embed_positions(self, x: torch.Tensor,
                        drop: Optional[Callable] = None) -> torch.Tensor:
        """The trunk's input: embedding * sqrt(d_model) + the positional
        rows (at a process-group ring rank's global offset), then the
        embedding dropout ``drop`` if given."""
        off = (self.mesh.rank * x.shape[1]
               if self.mesh is not None and not self.mesh.virtual else 0)
        h = self._embed(x) + self.pos_table[off:off + x.shape[1]].to(
            self.dtype)[None]
        return h if drop is None else drop(h)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """The output Linear in the compute dtype, cast to
        ``logits_dtype``; on head shards its input columns are split and
        the partial logits summed."""
        if not (_tp(self.mesh) and tp.divides(self.d_model, self.mesh)):
            return _linear(self.fc, h, self.dtype).to(self.logits_dtype)
        hc = tp.copy_to_model(h, self.mesh)
        parts = [F.linear(tp.part(hc, -1, self.mesh, m).to(self.dtype),
                          tp.local(self.fc.weight, 1, self.mesh, m).to(
                              self.dtype))
                 for m in tp.shards(self.mesh)]
        return tp.reduce_from_model(parts, self.mesh, self.fc.bias,
                                    self.dtype).to(self.logits_dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, L] int tokens -> logits [B, L, vocab] in
        ``logits_dtype`` (f32 by default), with autograd. With
        ``deterministic=False`` dropout draws its masks from
        ``generator`` (on the model's device); with ``remat`` the
        generator is rewound for each layer's recompute, so give each
        forward a generator of its own. On a process-group mesh x is
        this rank's sequence shard, at global offset ``rank * L``."""
        key_pad = (x == self.pad_id).float() if self.pad_in_input else None
        drop = None
        if not deterministic and self.dropout_rate > 0.0:
            def drop(y):
                return dropout(y, self.dropout_rate, generator)
        h = self.embed_positions(x, drop)
        for layer in self.Decoder.enc_layers:
            if self.remat and torch.is_grad_enabled():
                h = _remat(layer, h, key_pad, drop, generator)
            else:
                h = layer(h, key_pad, drop)
        return self.head(h)

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
        With ``cache_len == P`` (serving's admission) the cache is just
        the prompt's rows.

        ``last_idx`` serves bucketed prompts padded with pad_id past the
        true prompt: causal masking keeps the pad tail from reaching any
        position <= last_idx, and generation overwrites its cache rows."""
        b, p = x.shape
        if p > cache_len:
            raise ValueError(f"prompt ({p}) longer than the cache "
                             f"({cache_len})")
        key_pad = (x == self.pad_id).float()
        h = self._embed(x) + self.pos_table[:p].to(self.dtype)[None]
        shape = (self.num_layers, b, cache_len, self.d_model)
        cache = {"k": torch.empty(shape, dtype=self.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=self.dtype, device=x.device)}
        for c in cache.values():
            c[:, :, p:].zero_()  # only the rows past the prompt
        for i, layer in enumerate(self.Decoder.enc_layers):
            h, k, v = layer.forward_kv(h, key_pad)
            # [B, H, P, dh] -> fused layout rows [B, P, d]
            cache["k"][i, :, :p] = k.transpose(1, 2).reshape(b, p, -1)
            cache["v"][i, :, :p] = v.transpose(1, 2).reshape(b, p, -1)
        h_last = h[:, -1] if last_idx is None else h[:, last_idx]
        return _linear(self.fc, h_last, self.dtype).float(), cache

    @torch.no_grad()
    def decode_weights(self, quant: Optional[str] = None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Stacked [L, ...] weights for ``fused_decode_step`` (matrices
        [in, out], in the compute dtype) and the stacked E tables
        [L, max_seq, dh] f32. Build once per generation, not per token.

        quant: "none" or "int8", by default ``decode_quant``. With int8
        the weights dict also holds, under "int8", the pair
        (``quantize_stream_weights`` of the stacked weights, their
        scales): quantized from the compute-dtype stack, as the JAX
        module's ``fused_layer_stack_step``. ``decode_step`` and
        ``decode_chunk`` pick the pair they run."""
        quant = self.decode_quant if quant is None else quant
        return stack_decode_weights(self.Decoder.enc_layers, self.dtype, quant)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, cache: Cache, t: int,
                    stacked, start: Optional[torch.Tensor] = None,
                    start_min: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """token: [B] int at absolute position t -> (logits [B, vocab]
        f32, cache with row t written in place). ``stacked``: the
        ``decode_weights()`` pair.

        start: optional [B] int32 on the device, for ragged
        (continuous-batching) decode: row b's sequence occupies cache
        rows [start[b], t], so its position is t - start[b] (the
        positional row is gathered per row) and attention masks the rows
        below start[b]; the relative bias depends only on t - s.
        start_min: optional int <= min(start), the live-window floor
        kernel B skips below (the JAX module's decode_step,
        music_transformer.py:483-523). Int8 ``stacked`` weights (an int8
        model's ``decode_weights()``) run kernel B's int8 mode."""
        w_all, e_all = stacked
        w_all, scales = w_all.get("int8", (w_all, None))
        pos = (self.pos_table[t] if start is None
               else self.pos_table[(t - start).long()])
        h = self._embed(token) + pos.to(self.dtype)
        h, cache["k"], cache["v"] = fused_decode_step(
            h, t, e_all, w_all, cache["k"], cache["v"], self.num_heads,
            start=start, start_min=start_min, scales=scales)
        return _linear(self.fc, h, self.dtype).float(), cache

    @torch.no_grad()
    def decode_chunk(self, tokens: torch.Tensor, cache: Cache, t: int,
                     stacked) -> Tuple[torch.Tensor, Cache]:
        """Verify forward of speculative decoding: tokens [B, C] at
        absolute positions t..t+C-1 -> (logits [B, C, vocab] f32, cache
        with rows [t, t+C) written in place); logits[:, i] follow
        tokens[:, i]. Position by position equal to C ``decode_step``
        calls, in one pass over the weights and the cache (kernel E on
        CUDA; the JAX module's decode_chunk, music_transformer.py:525-581).
        Requires t + C <= max_seq.

        Int8 ``stacked`` weights run kernel E's int8 mode only where the
        JAX module takes its chunk kernel: C a power of two in [8, 128]
        and max_seq >= 128. Any other C runs on the full-precision
        weights, as the JAX module's XLA chunk does."""
        c = tokens.shape[1]
        if t + c > self.max_seq:
            raise ValueError(f"chunk rows [{t}, {t + c}) pass max_seq "
                             f"({self.max_seq})")
        w_all, e_all = stacked
        scales = None
        if c & (c - 1) == 0 and 8 <= c <= 128 and self.max_seq >= 128:
            w_all, scales = w_all.get("int8", (w_all, None))
        h = self._embed(tokens) + self.pos_table[t:t + c].to(self.dtype)[None]
        h, cache["k"], cache["v"] = fused_decode_chunk(
            h, t, e_all, w_all, cache["k"], cache["v"], self.num_heads,
            scales=scales)
        return _linear(self.fc, h, self.dtype).float(), cache


    @torch.no_grad()
    def loop_weights(self) -> Tuple[torch.Tensor, ...]:
        """The decode loop's other inputs, in the compute dtype: the
        embedding [V, d], the positional table [max_seq, d] and the head's
        weight [V, d] and bias [V]. Build once per generation."""
        return tuple(y.to(self.dtype).contiguous() for y in (
            self.Decoder.embedding.weight, self.pos_table, self.fc.weight,
            self.fc.bias))

    @torch.no_grad()
    def decode_loop(self, last_logits: torch.Tensor, t: int,
                    generator: Optional[torch.Generator], cache: Cache,
                    steps: int, temperature: float = 1.0,
                    greedy: bool = False, top_k: int = 0, top_p: float = 1.0,
                    chunk: int = 32) -> Tuple[torch.Tensor, Cache]:
        """Generate ``steps`` tokens after position t - 1 in
        ceil(steps / chunk) launches of ``fused_decode_loop`` (kernel F on
        CUDA), each running ``chunk`` whole sampling steps (the last may be
        shorter); the JAX module's decode_loop (music_transformer.py:
        583-635). last_logits: [B, vocab] f32, the logits of position
        t - 1. Returns (tokens [B, steps] int64, cache with rows
        [t, t + steps) written in place).

        The per-chunk seeds are drawn once, as one device tensor, from
        ``generator`` (the counterpart of ``fold_in(rng, chunk_idx)``);
        greedy runs draw none. Sampled runs take the kernel's Philox
        stream, not ``torch.multinomial``'s, so the same generator gives
        other (identically distributed) tokens than the step path. The
        loop runs on the full-precision weights whatever ``decode_quant``
        says, as the JAX module's loop does."""
        b = last_logits.shape[0]
        n_chunks = -(-steps // chunk)
        stacked = self.decode_weights(quant="none")
        embed, pos, fc_w, fc_b = self.loop_weights()
        w = stacked[0]
        # kernel F's cluster body reads six matrices repacked: once here
        packed = (pack_loop_matrices(w) if cache["k"].is_cuda
                  and loop_takes_cluster(
                      self.d_model, w["ffn1_w"].shape[-1], fc_w.shape[0],
                      cache["k"].shape[2], self.num_heads, self.dtype)
                  else None)
        if greedy:
            seeds = torch.zeros(n_chunks, dtype=torch.long,
                                device=self.device)
        else:
            seeds = torch.randint(0, (1 << 31) - 1, (n_chunks,),
                                  generator=generator, device=self.device)
        logits = last_logits.float().clone()  # the carried logits
        out = torch.empty(b, steps, dtype=torch.long, device=self.device)
        for i in range(n_chunks):
            c = min(chunk, steps - i * chunk)
            fused_decode_loop(
                logits, t, seeds[i:i + 1], embed, pos, stacked[1],
                stacked[0], fc_w, fc_b, cache["k"], cache["v"],
                self.num_heads, c, temperature, greedy, top_k, top_p,
                tokens=out[:, i * chunk:i * chunk + c], packed=packed)
            t += c
        return out, cache


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
