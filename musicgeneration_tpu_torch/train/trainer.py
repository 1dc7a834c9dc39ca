"""Train and eval steps for the MusicTransformer LM.

The port of ``musicgeneration_tpu/train/trainer.py``: forward,
label-smoothed CE, backward, gradient accumulation over ``accum_steps``
micro-batches (gradients summed, then divided by the count, as the JAX
scan does), and the optax chain ``clip_by_global_norm`` -> ``adam`` with
the Noam schedule, mirrored on torch tensors:

* the global norm is taken before clipping and reported as
  ``grad_norm``; gradients are scaled by ``max_norm / norm`` (as
  ``(g / norm) * max_norm``) only when ``norm >= max_norm``. This is not
  ``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``;
* Adam keeps optax's update rule and rounding order: ``mu = (1 - b1) g +
  b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias corrections
  ``1 - b^count`` in f32, ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by
  ``-lr``; not ``torch.optim.Adam``;
* the learning rate reads the optimizer's own update count (starting at
  0, clamped to 1 inside ``noam_schedule``), not the loop's step, so a
  skipped step does not advance the schedule.

PyTorch runs eagerly: the step updates the model's parameters and the
Adam moments in place, and reads the loss and the gradient norm to the
host once per step (the non-finite guard and the clip decide there).

Over a process-group mesh (``parallel.make_mesh``; each rank holds one
sequence shard of every row) each rank's loss is its local sum over the
GLOBAL count of kept targets, the gradients are all-reduced (summed)
before the global-norm clip and the metrics are summed, so every rank
takes the step one device would take on the global batch. Each rank folds
its rank into its dropout stream. On a virtual mesh one process holds the
global batch and the step is the single-device step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .objective import smooth_cross_entropy, token_accuracy
from .schedule import noam_schedule

_DROPOUT_TAG = 0x64726f70  # separates dropout seeds from the data stream


@dataclasses.dataclass
class TrainerConfig:
    vocab_size: int
    label_smoothing: float = 0.1
    pad_id: Optional[int] = None
    warmup_steps: int = 4000
    d_model: int = 256
    accum_steps: int = 1
    max_grad_norm: Optional[float] = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.98  # reference train.py:143
    adam_eps: float = 1e-9
    peak_lr: Optional[float] = None  # fixed-lr override


@dataclasses.dataclass
class AdamState:
    count: int                   # optax's update count
    mu: List[torch.Tensor]       # first moments, in parameter order
    nu: List[torch.Tensor]       # second moments


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_state: AdamState
    dropout_seed: int


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, b1, b2,
    eps))`` with ``lr`` the Noam schedule or ``peak_lr``."""

    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        if cfg.peak_lr is not None:
            peak = np.float32(cfg.peak_lr)
            self.schedule = lambda count: peak
        else:
            self.schedule = noam_schedule(cfg.d_model, cfg.warmup_steps)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        zeros = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                 for p in params]
        return AdamState(count=0, mu=zeros,
                         nu=[torch.zeros_like(z) for z in zeros])

    def lr(self, count: int) -> float:
        return float(self.schedule(count))

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, grad_norm: float) -> AdamState:
        """One update, in place on ``params`` and ``state``; ``grad_norm``
        is ``global_norm(grads)`` read to the host."""
        cfg = self.cfg
        if cfg.max_grad_norm and not grad_norm < cfg.max_grad_norm:
            grads = torch._foreach_div(grads, grad_norm)
            torch._foreach_mul_(grads, cfg.max_grad_norm)
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        bc1 = np.float32(1.0) - np.float32(b1) ** np.float32(count)
        bc2 = np.float32(1.0) - np.float32(b2) ** np.float32(count)
        upd = torch._foreach_div(state.mu, float(bc1))
        den = torch._foreach_div(state.nu, float(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.adam_eps)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr(state.count))
        torch._foreach_add_(params, upd)
        state.count = count
        return state


def make_optimizer(cfg: TrainerConfig) -> Optimizer:
    return Optimizer(cfg)


def create_train_state(model: torch.nn.Module, tx: Optimizer,
                       dropout_seed: int) -> TrainState:
    """Step 0, fresh Adam moments for ``model``'s parameters."""
    return TrainState(step=0, model=model,
                      opt_state=tx.init(list(model.parameters())),
                      dropout_seed=int(dropout_seed))


def dropout_generator(seed: int, step: int, micro: int,
                      device, rank: int = 0) -> torch.Generator:
    """The dropout stream of one micro-batch, a pure function of (seed,
    step, micro) as the JAX step's ``fold_in(dropout_rng, step)``: a
    resumed run draws the masks the uninterrupted run would. Four words
    of entropy, so it never aliases the CLI's three-word batch stream;
    a sequence-parallel rank > 0 adds its rank as a fifth."""
    words = [int(seed), _DROPOUT_TAG, int(step), int(micro)]
    w = np.random.SeedSequence(words + ([int(rank)] if rank else [])
                               ).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(w[0]) << 32) | int(w[1])) & ((1 << 63) - 1))
    return gen


def _group(mesh) -> Optional[dist.ProcessGroup]:
    return mesh.group if mesh is not None and not mesh.virtual else None


def _objective(logits, y, cfg: TrainerConfig, group):
    """(loss, accuracy) of one (shard of a) batch: over a process group,
    the local sums over the global count of kept targets."""
    denom = None
    if group is not None:
        keep = (y != cfg.pad_id) if cfg.pad_id is not None \
            else torch.ones_like(y, dtype=torch.bool)
        denom = keep.sum().float()
        dist.all_reduce(denom, group=group)
        denom = denom.clamp_min(1.0)
    loss = smooth_cross_entropy(logits, y, cfg.vocab_size,
                                cfg.label_smoothing, cfg.pad_id, denom)
    return loss, token_accuracy(logits, y, cfg.pad_id, denom)


def make_train_step(tx: Optimizer, cfg: TrainerConfig,
                    loss_fn: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, x, y, guard=False) -> (state,
    metrics)``.

    x, y: [accum * B, L] int tensors on the model's device, split into
    ``accum_steps`` micro-batches (on a process-group ``mesh``, this
    rank's sequence shard of them). ``loss_fn(model, x, y, generator) ->
    (loss, accuracy)`` replaces the default objective (over a process
    group it must return this rank's share of the global mean). With
    ``guard`` a non-finite loss leaves parameters and optimizer state
    untouched (``train.loop._guarded``); the step counter moves on either
    way. Metrics are host floats."""
    group = _group(mesh)
    rank = mesh.rank if group is not None else 0

    def default_loss(model, x, y, generator):
        logits = model(x, deterministic=False, generator=generator)
        return _objective(logits, y, cfg, group)

    loss_of = loss_fn or default_loss

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   guard: bool = False):
        model = state.model
        params = list(model.parameters())
        for p in params:
            p.grad = None
        a = cfg.accum_steps
        xs = x.reshape(a, x.shape[0] // a, *x.shape[1:])
        ys = y.reshape(a, y.shape[0] // a, *y.shape[1:])
        loss = acc = 0.0
        for i in range(a):
            gen = dropout_generator(state.dropout_seed, state.step, i,
                                    x.device, rank)
            l_i, acc_i = loss_of(model, xs[i], ys[i], gen)
            l_i.backward()  # sums into .grad across micro-batches
            loss = loss + l_i.detach()
            acc = acc + acc_i.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if group is not None:
            # one all-reduce of every gradient and of the two metrics
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [torch.stack([loss, acc]).float()])
            dist.all_reduce(flat, group=group)
            grads = [f.view_as(g) for f, g in zip(
                torch.split(flat[:-2], [g.numel() for g in grads]), grads)]
            loss, acc = flat[-2], flat[-1]
        if a > 1:
            torch._foreach_div_(grads, a)
            loss, acc = loss / a, acc / a
        gnorm = global_norm(grads)
        loss_h, acc_h, gnorm_h = torch.stack(
            [loss.float(), acc.float(), gnorm.float()]).tolist()
        metrics: Dict[str, float] = {"loss": loss_h, "accuracy": acc_h,
                                     "grad_norm": gnorm_h}
        finite = math.isfinite(loss_h)
        if finite or not guard:
            tx.update(params, grads, state.opt_state, gnorm_h)
        if guard:
            metrics["skipped"] = int(not finite)
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: TrainerConfig, mesh=None) -> Callable:
    """Returns ``eval_step(model, x, y) -> {"loss", "accuracy"}``
    (deterministic forward, no autograd; over a process-group ``mesh``
    the metrics of the global batch on every rank)."""
    group = _group(mesh)

    @torch.no_grad()
    def eval_step(model, x, y) -> Dict[str, torch.Tensor]:
        logits = model(x, deterministic=True)
        stats = torch.stack(_objective(logits, y, cfg, group))
        if group is not None:
            dist.all_reduce(stats, group=group)
        return {"loss": stats[0], "accuracy": stats[1]}

    return eval_step
