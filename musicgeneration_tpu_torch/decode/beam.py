"""Beam search and stochastic (Gumbel) beam search.

The port of ``musicgeneration_tpu/decode/beam.py``, with the reference
RNN beam searches' semantics (PerformanceRNN/network.py:156-257;
Event_MelodyRNN/network.py:166-268):

* scores accumulate RAW logits / temperature, with no log-softmax
  (network.py:205-209); ``normalize=True`` accumulates log-probs,
* the search starts from one live beam: beams 1.. start at ``NEG_INF``
  (PerformanceRNN); ``all_beams_live=True`` starts every beam at 0
  (Event_MelodyRNN, observable only under stochastic selection),
* stochastic mode adds Gumbel(0, 1) noise to the expanded scores,
  selects by the perturbed score and accumulates the unperturbed one,
* the result is the sequence of the best-scoring final beam per batch.

Top-k ties break to the lower flat index, as ``jax.lax.top_k`` does: the
selection is a stable descending sort. The state is a tree (dicts,
lists, tuples) of tensors whose batch axis holds batch * beam rows; each
step gathers it by parent beam into new tensors. Noise is drawn with an
explicit ``torch.Generator``, or passed in pre-drawn (``gumbel_noise``)
for replay and for tests against the JAX search.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

StepFn = Callable[..., Tuple[torch.Tensor, Any]]
NEG_INF = -1e30


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather_beams(tree, beam_idx: torch.Tensor, batch: int, beam: int,
                  batch_axis: int = 0):
    """Reindex a tree whose tensors carry batch*beam rows at
    ``batch_axis`` by parent beam ``beam_idx`` [batch, beam]."""
    flat = (beam_idx + beam * torch.arange(batch, device=beam_idx.device)
            [:, None]).reshape(-1)
    return _tree_map(lambda x: x.index_select(batch_axis, flat), tree)


def replicate_for_beams(tree, beam_size: int, batch_axis: int = 0):
    """Tile a state tree to batch*beam rows along its batch axis."""
    return _tree_map(lambda x: x.repeat_interleave(beam_size, dim=batch_axis),
                     tree)


@torch.no_grad()
def beam_search(step_fn: StepFn, init_state: Any, first_token: torch.Tensor,
                steps: int, beam_size: int, vocab_size: int,
                generator: Optional[torch.Generator] = None,
                temperature: float = 1.0, stochastic: bool = False,
                normalize: bool = False, state_batch_axis: int = 0,
                per_step_inputs: Optional[torch.Tensor] = None,
                all_beams_live: bool = False,
                gumbel_noise: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Returns the best sequences [batch, steps] int64.

    step_fn(tokens [batch*beam], state[, extra]) -> (logits
    [batch*beam, V], state). init_state: tree with batch*beam rows
    (``replicate_for_beams``). first_token: [batch] ints fed to every
    beam at step 0. per_step_inputs: optional tensor with a leading
    ``steps`` axis; row i goes to step_fn as its third argument.
    gumbel_noise: optional pre-drawn [steps, batch, beam*V] Gumbel(0, 1)
    noise for the stochastic search; else it is drawn from ``generator``
    (on the logits' device)."""
    batch = first_token.shape[0]
    device = first_token.device
    tokens = first_token.long().repeat_interleave(beam_size)
    if all_beams_live:
        scores = torch.zeros(batch, beam_size, device=device)
    else:
        scores = torch.full((batch, beam_size), NEG_INF, device=device)
        scores[:, 0] = 0.0
    seqs = torch.zeros(batch, beam_size, steps, dtype=torch.long,
                       device=device)
    state = init_state
    for i in range(steps):
        if per_step_inputs is None:
            logits, state = step_fn(tokens, state)
        else:
            logits, state = step_fn(tokens, state, per_step_inputs[i])
        logits = logits.float() / temperature
        if normalize:
            logits = torch.log_softmax(logits, dim=-1)
        flat = (scores[:, :, None]
                + logits.reshape(batch, beam_size, vocab_size)
                ).reshape(batch, beam_size * vocab_size)
        sel = flat
        if stochastic:
            if gumbel_noise is not None:
                noise = torch.as_tensor(gumbel_noise[i], dtype=torch.float32,
                                        device=flat.device)
            else:
                u = torch.rand(flat.shape, generator=generator,
                               device=flat.device)
                noise = -torch.log(-torch.log(
                    u.clamp(torch.finfo(torch.float32).tiny, 1.0)))
            sel = flat + noise
        top_idx = torch.sort(sel, dim=-1, descending=True,
                             stable=True).indices[:, :beam_size]
        scores = torch.gather(flat, 1, top_idx)
        beam_idx = top_idx // vocab_size
        tok_idx = top_idx % vocab_size
        state = _gather_beams(state, beam_idx, batch, beam_size,
                              state_batch_axis)
        seqs = torch.gather(seqs, 1, beam_idx[:, :, None].expand(-1, -1,
                                                                 steps))
        seqs[:, :, i] = tok_idx
        tokens = tok_idx.reshape(-1)
    best = torch.argmax(scores, dim=-1)
    return seqs[torch.arange(batch, device=device), best]
