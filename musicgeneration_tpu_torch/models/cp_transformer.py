"""CPTransformer: transformer LM over Compound Word rows.

The port of ``musicgeneration_tpu/models/cp_transformer.py`` (the
Compound Word Transformer recipe, Hsiao et al., AAAI 2021): the 8 field
embeddings of a row (``tokenizers/cp.py``) are summed into one d_model
vector and scaled by sqrt(d_model), the sinusoid position is added, the
MusicTransformer's ``EncoderLayer`` trunk (relative global attention,
post-LN, ReLU FFN of d_model // 2) runs causally, and 8 output heads
predict the next row's fields.

Parameters are float32; ``dtype`` is the compute dtype (bfloat16 on the
card), as the JAX module's ``dtype``. ``forward`` (training) runs kernel
A forward and kernel C backward through ``ops.fused_attention`` with no
key padding (CP crops hold no pad rows); ``prefill`` runs kernel A and
fills the fused cache ``[L, B, S, d]``; ``decode_step`` runs kernel B
through ``ops.fused_decode`` (ragged ``start``/``start_min`` for
serving; int8 with ``decode_quant="int8"``). On CPU tensors the plain
versions run.

With a ``mesh`` whose model axis is > 1 the trunk runs on head shards
(``EncoderLayer`` on its ``mesh``; a block tp does not divide is
replicated), each field embedding is split by d_model columns (where tp
divides it) and gathered, and each head follows JAX's default rule:
split by its output columns where the model axis divides the field's
size, else replicated (``parallel.mesh.param_placements``). Mesh training
of the CP transformer is refused by ``cli.train`` as in JAX; the dry run
(``graft_entry.dryrun_multichip``) takes one step of it.

State-dict names (the port's own: the JAX package exports no CP
``.pth``): ``embed_<field>.weight`` [field_dim, d] for each field of
``cp.field_names()``; ``layers.<i>.`` + the port's ``EncoderLayer`` names
(``rga.Wq``/``Wk``/``Wv``/``fc`` ``.weight``/``.bias``, ``rga.E``,
``FFN_pre``, ``FFN_suf``, ``layernorm1``, ``layernorm2``); and
``head_<field>.weight`` [field_dim, d], ``head_<field>.bias``.
``convert.cp_transformer_state_dict_from_jax`` maps a flax tree to them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.fused_decode import fused_decode_step
from ..ops.relative_attention import sinusoid_position_encoding
from ..parallel import tensor_parallel as tp
from ..parallel.mesh import model_dim
from ..tokenizers import cp
from .music_transformer import (EncoderLayer, _linear, _tp, dropout,
                                stack_decode_weights)
from .registry import register_model

Cache = Dict[str, torch.Tensor]


def cp_transformer_defaults(**overrides) -> dict:
    cfg = dict(num_layers=4, d_model=256, max_seq=1024, dropout_rate=0.1)
    cfg.update(overrides)
    return cfg


@register_model("cp_transformer", cp_transformer_defaults)
class CPTransformer(nn.Module):
    """4 layers, d_model 256, max_seq 1024 are the repo's defaults
    (``cp_transformer_defaults``); as in the JAX module the heads are 64
    wide, the FFN is d_model // 2 and the fields are ``cp.field_dims()``
    ([4, 18, 4, 61, 62, 128, 65, 5]). ``generator``: optional CPU
    ``torch.Generator`` for the random initial weights
    (``reset_parameters``). ``decode_quant``: "none" or "int8",
    weight-only int8 in the decode step (``decode_weights``)."""

    family = "cp_transformer"

    def __init__(self, num_layers: int = 4, d_model: int = 256,
                 max_seq: int = 1024, dtype=torch.float32, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.1, decode_quant: str = "none",
                 mesh=None):
        super().__init__()
        if decode_quant not in ("none", "int8"):
            raise ValueError(f"unknown decode_quant {decode_quant!r}")
        if d_model % 64:
            raise ValueError(f"d_model {d_model} is not a multiple of the "
                             "64-wide heads")
        device = resolve_device(device)
        self.mesh = mesh if _tp(mesh) else None
        self.field_dims = tuple(cp.field_dims())
        self.num_layers = num_layers
        self.d_model = d_model
        self.max_seq = max_seq
        self.num_heads = d_model // 64
        self.ffn_dim = d_model // 2
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.decode_quant = decode_quant
        for fd, name in zip(self.field_dims, cp.field_names()):
            self.add_module(f"embed_{name}",
                            nn.Embedding(fd, d_model, device=device))
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, self.num_heads, max_seq, self.ffn_dim,
                         dtype=dtype, device=device, mesh=self.mesh)
            for _ in range(num_layers))
        for fd, name in zip(self.field_dims, cp.field_names()):
            self.add_module(f"head_{name}",
                            nn.Linear(d_model, fd, device=device))
        self.register_buffer(
            "pos_table",
            torch.from_numpy(sinusoid_position_encoding(max_seq, d_model)
                             ).to(device),
            persistent=False)
        self.reset_parameters(generator)

    @property
    def device(self) -> torch.device:
        return self.pos_table.device

    def _fields(self, kind: str) -> List[nn.Module]:
        return [getattr(self, f"{kind}_{name}") for name in cp.field_names()]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Random weights drawn on the CPU (one seed, one model on every
        device), as ``MusicTransformer.reset_parameters``: embeddings and
        Linear weights N(0, 1/d_in), biases 0, LayerNorm 1/0, E ~
        N(0, 1)."""
        for name, p in self.named_parameters():
            if name.endswith(".E"):
                std = 1.0
            elif p.dim() == 2:
                std = 1.0 / math.sqrt(p.shape[1])
            elif "layernorm" in name and name.endswith("weight"):
                p.fill_(1.0)
                continue
            else:
                p.zero_()
                continue
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """x: [..., 8] int rows -> summed field embeddings [..., d] in the
        compute dtype, times sqrt(d_model) rounded to it (the JAX
        module's ``_embed``)."""
        # F.embedding, not advanced indexing: its backward sorts the
        # indices and reduces each run, where index_put's is serial over
        # duplicates (tables of 4-128 rows, B*T indices each)
        embeds = self._fields("embed")
        scale = float(torch.tensor(math.sqrt(self.d_model)).to(self.dtype))
        mesh = self.mesh

        def summed(weight):
            h = F.embedding(x[..., 0], weight(embeds[0]).to(self.dtype))
            for i in range(1, len(embeds)):
                h = h + F.embedding(x[..., i],
                                    weight(embeds[i]).to(self.dtype))
            return h

        if mesh is None or not tp.divides(self.d_model, mesh):
            return summed(lambda e: e.weight) * scale
        return tp.gather_from_model(
            [summed(lambda e, m=m: tp.local(e.weight, 1, mesh, m))
             for m in tp.shards(mesh)], mesh) * scale

    def _heads(self, h: torch.Tensor) -> List[torch.Tensor]:
        if self.mesh is None:
            return [_linear(head, h, self.dtype).float()
                    for head in self._fields("head")]
        mesh, dt, out = self.mesh, self.dtype, []
        hc = tp.copy_to_model(h, mesh)
        for head in self._fields("head"):
            w = head.weight
            if model_dim("head.weight", w.shape) == 0 and \
                    head.bias.shape[0] % mesh.model == 0:
                # split by output columns: each shard's logits, gathered
                b = tp.copy_to_model(head.bias, mesh)
                out.append(tp.gather_from_model(
                    [F.linear(hc.to(dt), tp.local(w, 0, mesh, m).to(dt),
                              tp.part(b, 0, mesh, m).to(dt))
                     for m in tp.shards(mesh)], mesh).float())
            else:
                out.append(_linear(head, h, dt).float())
        return out

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """x: [B, T, 8] int rows -> list of 8 per-field logits [B, T, fd]
        f32, with autograd. Causal only: CP crops carry no pad rows. With
        ``deterministic=False`` the layers' dropout (after attention and
        after the FFN, as the JAX module: none after the embedding) draws
        its masks from ``generator``."""
        t = x.shape[1]
        h = self._embed(x) + self.pos_table[:t].to(self.dtype)[None]
        drop = None
        if not deterministic and self.dropout_rate > 0.0:
            def drop(y):
                return dropout(y, self.dropout_rate, generator)
        for layer in self.layers:
            h = layer(h, None, drop)
        return self._heads(h)

    # -- incremental decoding -------------------------------------------------

    def init_cache(self, batch: int, cache_len: int) -> Cache:
        shape = (self.num_layers, batch, cache_len, self.d_model)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    @torch.no_grad()
    def prefill(self, rows: torch.Tensor, cache_len: int
                ) -> Tuple[List[torch.Tensor], Cache]:
        """One-pass prompt ingestion: rows [B, P, 8] -> (list of the last
        position's per-field logits [B, fd] f32, cache [L, B, cache_len,
        d] with rows [0, P) filled and the rest zero). Causal, no key
        padding: rows past a prompt's true end (serving's bucket tail)
        reach no earlier row."""
        b, p, _ = rows.shape
        if p > cache_len:
            raise ValueError(f"prompt ({p}) longer than the cache "
                             f"({cache_len})")
        h = self._embed(rows) + self.pos_table[:p].to(self.dtype)[None]
        shape = (self.num_layers, b, cache_len, self.d_model)
        cache = {"k": torch.empty(shape, dtype=self.dtype, device=rows.device),
                 "v": torch.empty(shape, dtype=self.dtype, device=rows.device)}
        for c in cache.values():
            c[:, :, p:].zero_()
        for i, layer in enumerate(self.layers):
            h, k, v = layer.forward_kv(h)
            cache["k"][i, :, :p] = k.transpose(1, 2).reshape(b, p, -1)
            cache["v"][i, :, :p] = v.transpose(1, 2).reshape(b, p, -1)
        return self._heads(h[:, -1]), cache

    @torch.no_grad()
    def decode_weights(self, quant: Optional[str] = None
                       ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Stacked trunk weights and E tables for ``decode_step``, as
        ``MusicTransformer.decode_weights`` (``quant``: "none" or "int8",
        by default ``decode_quant``). Build once per generation."""
        quant = self.decode_quant if quant is None else quant
        return stack_decode_weights(self.layers, self.dtype, quant)

    @torch.no_grad()
    def decode_step(self, row: torch.Tensor, cache: Cache, t: int, stacked,
                    start: Optional[torch.Tensor] = None,
                    start_min: Optional[int] = None
                    ) -> Tuple[List[torch.Tensor], Cache]:
        """row: [B, 8] int at absolute position t -> (list of per-field
        logits [B, fd] f32, cache with row t written in place).
        ``stacked``: the ``decode_weights()`` pair (int8 weights run
        kernel B's int8 mode).

        start / start_min: ragged continuous-batching bounds, as
        ``MusicTransformer.decode_step``: row b occupies cache rows
        [start[b], t], its position is t - start[b], and kernel B skips
        the rows below ``start_min`` <= min(start)."""
        w_all, e_all = stacked
        w_all, scales = w_all.get("int8", (w_all, None))
        pos = (self.pos_table[t] if start is None
               else self.pos_table[(t - start).long()])
        h = self._embed(row) + pos.to(self.dtype)
        h, cache["k"], cache["v"] = fused_decode_step(
            h, t, e_all, w_all, cache["k"], cache["v"], self.num_heads,
            start=start, start_min=start_min, scales=scales)
        return self._heads(h), cache
