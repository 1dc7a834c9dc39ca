"""Speculative decoding: draft, verify C tokens in one forward, accept.

The port of ``musicgeneration_tpu/decode/speculative.py``. Each
iteration proposes C-1 tokens after the pending one, runs the target's
verify forward over the C tokens at once (``MusicTransformer.
decode_chunk``, kernel E on CUDA), samples the target's own token at
every position, accepts the leading proposals that equal those samples
(min-synchronised across the batch, since the cache keeps one position)
and emits the first non-matching sample as a bonus token. Greedy runs
are token-identical to ``decode.generate``; sampled runs draw from the
same per-position conditionals through a different use of the
generator. A rejection needs no rollback: rows past ``t`` are stale and
every later forward overwrites or masks them.

Proposals come from prompt lookup (the latest earlier occurrence of the
last n-gram proposes what followed it) or from a draft MusicTransformer
stepping greedily through ``decode_step`` (kernel B on CUDA).

JAX ran the loop as one compiled ``while_loop``. Here it is a host loop
that keeps the tokens on the device and reads one value back per verify
forward: the accepted count ``a``, which is the step ``t`` advances by
and so decides the next forward's position. That read is the loop's only
host synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .engine import DecodeParams, align_cache_len
from .sampling import sample_logits


@dataclasses.dataclass(frozen=True)
class SpecParams:
    """chunk: tokens per verify forward, the pending token plus chunk-1
    proposals; ngram: lookup match length (ignored with a draft)."""

    chunk: int = 8
    ngram: int = 3


def _lookup_propose(ctx: torch.Tensor, n_tot: int, g: int,
                    n_prop: int) -> torch.Tensor:
    """Prompt-lookup proposals. ctx: [B, T] token buffer whose first
    n_tot entries are live (prompt + emitted), the last one pending.
    Per row, the latest i <= n_tot-2 where the g-gram ending at i equals
    the one ending at n_tot-1 proposes ctx[i+1 : i+1+n_prop]; with no
    match, the tokens after n_tot-2 (a repeat of the pending one). Reads
    nothing back."""
    b, t_max = ctx.shape
    pos = torch.arange(t_max, device=ctx.device)
    g0 = min(max(n_tot - g, 0), t_max - g)   # dynamic_slice's clamp
    gram = ctx[:, g0:g0 + g]
    ok = ((pos >= g - 1) & (pos <= n_tot - 2))[None, :]
    for o in range(g):
        idx = torch.clamp(pos - (g - 1) + o, 0, t_max - 1)
        ok = ok & (ctx[:, idx] == gram[:, o:o + 1])
    i_star = torch.where(ok, pos[None, :], -1).amax(1)
    i_star = torch.where(i_star < 0, n_tot - 2, i_star)
    gather = torch.clamp(i_star[:, None] + 1
                         + torch.arange(n_prop, device=ctx.device)[None, :],
                         0, t_max - 1)
    return torch.gather(ctx, 1, gather)


def _check(model, draft_model, p: int, dp: DecodeParams, spec: SpecParams):
    """The JAX function's validations; returns (cache_len,
    draft_cache_len)."""
    if not (hasattr(model, "decode_chunk") and hasattr(model, "max_seq")):
        raise ValueError(
            "speculative decoding needs a chunk-verify target with a "
            f"position-indexed cache (decode_chunk/prefill); "
            f"{type(model).__name__} has neither (the GRU families decode "
            "through generate())")
    if spec.chunk < 2:
        raise ValueError("spec.chunk must be >= 2 (1 proposal minimum)")
    need = p + dp.steps + spec.chunk
    if need > model.max_seq:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) + chunk ({spec.chunk}) = "
            f"{need} exceeds max_seq ({model.max_seq}); speculative "
            "decoding needs `chunk` positions of headroom")
    cache_len = align_cache_len(model, min(need, model.max_seq))
    if draft_model is None:
        return cache_len, 0
    if not hasattr(draft_model, "prefill"):
        raise ValueError("draft model needs a position-indexed cache "
                         "(prefill/decode_step); recurrent drafts are not "
                         "supported")
    if need > draft_model.max_seq:
        raise ValueError(f"draft max_seq ({draft_model.max_seq}) < prompt "
                         f"+ steps + chunk ({need})")
    return cache_len, align_cache_len(draft_model,
                                      min(need, draft_model.max_seq))


@torch.no_grad()
def generate_speculative(model, prompt: torch.Tensor,
                         generator: Optional[torch.Generator],
                         decode_params: DecodeParams, *, draft_model=None,
                         spec: SpecParams = SpecParams(),
                         with_stats: bool = False):
    """Speculative counterpart of ``decode.generate``: prompt [B, P] ->
    tokens [B, steps] int64 on the model's device. ``draft_model=None``
    proposes by prompt lookup; otherwise a MusicTransformer of the same
    vocabulary drafts (a draft is one model object: its weights come with
    it). ``generator`` drives the target's sampling (greedy ignores it).
    With ``with_stats`` also returns {"emitted", "iterations",
    "mean_accepted"}: mean_accepted is the mean number of accepted
    proposals per verify forward (0 to chunk-1)."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=model.device)
    b, p = prompt.shape
    dp = decode_params
    c, steps = spec.chunk, dp.steps
    cache_len, draft_cache_len = _check(model, draft_model, p, dp, spec)

    logits, cache = model.prefill(prompt, cache_len)
    stacked = model.decode_weights()
    if draft_model is not None:
        _, d_cache = draft_model.prefill(prompt, draft_cache_len)
        d_stacked = draft_model.decode_weights()
    ctx = torch.zeros(b, p + steps + c, dtype=torch.long,
                      device=model.device)
    ctx[:, :p] = prompt
    ctx[:, p] = sample_logits(logits, dp.sampling, generator)
    n, t, iters = 1, p, 0
    while n < steps:
        n_tot = p + n
        pending = ctx[:, n_tot - 1]
        if draft_model is None:
            proposals = _lookup_propose(ctx, n_tot, spec.ngram, c - 1)
        else:
            # c greedy draft steps; the last only writes the draft cache
            # row of proposal c-1 (its output is discarded)
            tok, outs = pending, []
            for i in range(c):
                d_logits, d_cache = draft_model.decode_step(
                    tok, d_cache, t + i, d_stacked)
                tok = d_logits.argmax(-1)
                outs.append(tok)
            proposals = torch.stack(outs[:c - 1], dim=1)
        inputs = torch.cat([pending[:, None], proposals], dim=1)
        logits, cache = model.decode_chunk(inputs, cache, t, stacked)
        u = sample_logits(logits.reshape(b * c, -1), dp.sampling,
                          generator).reshape(b, c)
        lead = torch.cumprod((u[:, :c - 1] == proposals).long(), dim=1)
        a = int(lead.sum(1).min())    # the loop's one host sync
        emit = torch.cat([proposals, u[:, -1:]], dim=1)
        emit[:, a] = u[:, a]
        ctx[:, n_tot:n_tot + c] = emit
        n += a + 1
        t += a + 1
        iters += 1
    tokens = ctx[:, p:p + steps]
    if not with_stats:
        return tokens
    # the first token is sampled before the loop; each iteration emits
    # its accepted proposals and one bonus sample
    return tokens, {"emitted": n, "iterations": iters,
                    "mean_accepted": (n - 1 - iters) / max(iters, 1)}
