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

Over a mesh (``parallel.make_mesh``) the step is the one one device
takes on the GLOBAL batch, as JAX's SPMD step is: each data shard's loss
is its local sum over the global count of kept targets of the
micro-batch (JAX takes one mean over the global batch,
``train/objective.py:51-54``; DDP's average of per-rank means would
differ wherever shards hold different numbers of pad targets), so the
shards' gradients and metrics sum to the global ones, and the
global-norm clip reads the global norm. On a process group (each rank
one shard: its data shard's rows, its ring index's sequence columns)
gradients and metrics are all-reduced over every rank; with ``fsdp``
the parameters and Adam moments are DTensor shards over the data group
(FSDP2's ``fully_shard``, its reduce-scatter summing instead of
averaging), the optimizer runs on the shards and the norm sums the
shards' squares over the data group. Each rank folds its (data, seq)
index into its dropout stream.

With tensor parallelism (``model`` > 1) or pipeline stages (``pipe`` >
1) on a process group, each rank holds its part of the parameters
(``parallel.tensor_parallel.shard_params``, called by
``create_train_state``), and Adam's moments follow that layout. The
ranks of one model shard or stage sum their gradients and metrics over
``batch_group`` (the data and seq ranks), the model shards of a data
shard draw the same dropout masks, and the global norm sums the squares
of split parameters over the model (or pipe) group and counts replicated
ones once. Gradients of replicated tensors that each shard uses in part
(E, the split layers' biases; the pipeline's embedding) are summed in
the backward (``copy_to_model``).

When the data axis does not divide the micro-batch (batch_size % dp !=
0, batch_size * accum_steps % dp == 0), each rank holds an even share of
the accumulated batch's rows, and each row's loss is divided by the
global count of kept targets of its own micro-batch (then by
accum_steps, as always): JAX's objective, with no rank left without
rows.

On a virtual mesh one process holds the global batch and the whole
parameters, and the step is the single-device step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..utils.profiling import span
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


def global_norm(tensors: List[torch.Tensor],
                split: Optional[Sequence[bool]] = None,
                group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm).
    DTensor shards (fsdp) give the norm of the whole tensors: the shards'
    sums of squares are summed over their mesh's group. With ``group``
    (a process group's model or pipe group) the tensors flagged in
    ``split`` are this rank's parts of tensors split over it: their
    squares are summed over it, the others' counted once."""
    dtensor = bool(tensors) and isinstance(tensors[0], DTensor)
    if not dtensor and group is None:
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(tensors)))
    local = torch.stack(torch._foreach_norm(
        [t.to_local() if isinstance(t, DTensor) else t
         for t in tensors])).float()
    sq = local * local
    if group is None:
        total = sq.sum()
        dist.all_reduce(total, group=tensors[0].device_mesh.get_group())
        return total.sqrt()
    flags = torch.tensor(list(split), dtype=torch.bool, device=sq.device)
    parts = torch.stack([sq[flags].sum(), sq[~flags].sum()])
    if dtensor:
        dist.all_reduce(parts, group=tensors[0].device_mesh.get_group())
    spread = parts[0].clone()
    dist.all_reduce(spread, group=group)
    return (spread + parts[1]).sqrt()


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


def shard_model(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """``fully_shard`` (FSDP2) each encoder layer and then the whole model
    over the mesh's data group, in place: parameters become DTensor
    shards, gathered whole for each forward and backward. The gradient
    reduce-scatter sums (divide factor 1): each rank's loss is already
    its share of the global mean."""
    from torch.distributed.fsdp import fully_shard

    dm = mesh.device_mesh["data"]
    units = list(model.Decoder.enc_layers) + [model]
    for unit in units:
        fully_shard(unit, mesh=dm)
    for unit in units:  # each FSDP module reduces its own parameters
        unit.set_gradient_divide_factor(1.0)
        # gloo has no PREMUL_SUM: reduce with a plain sum (the same values)
        if hasattr(unit, "set_force_sum_reduction_for_comms"):
            unit.set_force_sum_reduction_for_comms(True)
    return model


def create_train_state(model: torch.nn.Module, tx: Optimizer,
                       dropout_seed: int, mesh=None) -> TrainState:
    """Step 0, fresh Adam moments for ``model``'s parameters. On a
    process-group ``mesh`` with a model or pipe axis the parameters are
    cut to this rank's part first (``tensor_parallel.shard_params``);
    with ``fsdp`` the model is sharded (``shard_model``); the moments
    take the parameters' layout."""
    if mesh is not None and not mesh.virtual:
        from ..parallel.tensor_parallel import shard_params
        shard_params(model, mesh)
    if mesh is not None and mesh.fsdp:
        shard_model(model, mesh)
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


def _world(mesh) -> Optional[dist.ProcessGroup]:
    """The group gradients and metrics are summed over: the ranks holding
    the same model shard and stage (the whole world without tp or pp)."""
    return mesh.batch_group if mesh is not None and not mesh.virtual \
        else None


def kept_count(y: torch.Tensor, cfg: TrainerConfig, group=None
               ) -> torch.Tensor:
    """The number of targets the objective keeps (those not ``pad_id``)
    in ``y``, summed over ``group`` when given, at least 1, as f32."""
    keep = (y != cfg.pad_id) if cfg.pad_id is not None \
        else torch.ones_like(y, dtype=torch.bool)
    n = keep.sum().float()
    if group is not None:
        dist.all_reduce(n, group=group)
    return n.clamp_min(1.0)


def _objective(logits, y, cfg: TrainerConfig, denom=None):
    """(loss, accuracy) of one (shard of a) batch: with ``denom`` the
    local sums over that count of kept targets (the global one), else the
    means."""
    loss = smooth_cross_entropy(logits, y, cfg.vocab_size,
                                cfg.label_smoothing, cfg.pad_id, denom)
    return loss, token_accuracy(logits, y, cfg.pad_id, denom)


def _rows(x, sl: slice):
    """Rows ``sl`` of x (or of each tensor of a dict)."""
    return {k: v[sl] for k, v in x.items()} if isinstance(x, dict) \
        else x[sl]


def micro_runs(n: int, a: int, mesh=None) -> List[Tuple[int, slice]]:
    """(global micro-batch index, rows) of this rank's ``n`` rows of an
    accumulated batch of ``a`` micro-batches: n / a rows of each where a
    divides n (every rank holds rows of every micro-batch); otherwise
    (the data axis does not divide the micro-batch) the rank's
    contiguous share ``[data_rank * n, (data_rank + 1) * n)`` of the
    global rows, cut where a micro-batch ends."""
    if n % a == 0:
        per = n // a
        return [(i, slice(i * per, (i + 1) * per)) for i in range(a)]
    b = n * mesh.data // a
    lo = mesh.data_rank * n
    return [(i, slice(max(i * b, lo) - lo, min((i + 1) * b, lo + n) - lo))
            for i in range(lo // b, (lo + n - 1) // b + 1)]


def _kept_counts(y, runs, a: int, cfg: TrainerConfig, group) -> torch.Tensor:
    """Each micro-batch's count of kept targets summed over ``group``, at
    least 1, as f32 [a]."""
    counts = torch.zeros(a, device=y.device)
    for i, sl in runs:
        counts[i] += kept_count(y[sl], cfg)
    dist.all_reduce(counts, group=group)
    return counts.clamp_min(1.0)


def make_train_step(tx: Optimizer, cfg: TrainerConfig,
                    loss_fn: Optional[Callable] = None,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, x, y, guard=False) -> (state,
    metrics)``.

    x, y: [accum * B, ...] tensors on the model's device (x may be a dict
    of them, as PoPMAG's packed batch), split into ``accum_steps``
    micro-batches along axis 0, key by key (on a process-group ``mesh``,
    this rank's rows and sequence columns of each). ``loss_fn(model, x,
    y, generator) -> (loss, accuracy)`` replaces the default objective;
    over a process group it is called with ``denom=``, the micro-batch's
    global count of kept targets, and must return this rank's share of
    the global mean (local sums over ``denom``). With ``guard`` a
    non-finite loss leaves parameters and optimizer state untouched
    (``train.loop._guarded``); the step counter moves on either way.
    Metrics are host floats."""
    world = _world(mesh)
    rank = mesh.batch_rank if world is not None else 0
    ring = mesh.group if world is not None and mesh.size > 1 else None

    def default_loss(model, x, y, generator, denom=None):
        logits = model(x, deterministic=False, generator=generator)
        return _objective(logits, y, cfg, denom)

    loss_of = loss_fn or default_loss

    def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
                   guard: bool = False):
        with span("trainer.step"):
            return _train_step(state, x, y, guard)

    def _train_step(state, x, y, guard):
        model = state.model
        params = list(model.parameters())
        for p in params:
            p.grad = None
        a = cfg.accum_steps
        device = y.device
        runs = micro_runs(y.shape[0], a, mesh)
        denoms = None
        if world is not None:
            with span("trainer.exchange"):
                denoms = _kept_counts(y, runs, a, cfg, world)
        loss = acc = 0.0
        for i, sl in runs:
            with span("trainer.forward"):
                gen = dropout_generator(state.dropout_seed, state.step, i,
                                        device, rank)
                kw = {} if world is None else {"denom": denoms[i]}
                l_i, acc_i = loss_of(model, _rows(x, sl), y[sl], gen, **kw)
            with span("trainer.backward"):
                l_i.backward()  # sums into .grad across micro-batches
            loss = loss + l_i.detach()
            acc = acc + acc_i.detach()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        stats = torch.stack([loss, acc]).float()
        if world is not None:
            with span("trainer.exchange"):
                if isinstance(grads[0], DTensor):
                    # fsdp: the reduce-scatter summed each shard over the
                    # data group; the ring's ranks hold the same shards
                    if ring is not None:
                        for g in grads:
                            dist.all_reduce(g.to_local(), group=ring)
                    dist.all_reduce(stats, group=world)
                else:
                    # one all-reduce of every gradient and of the two
                    # metrics
                    flat = torch.cat([g.reshape(-1) for g in grads]
                                     + [stats])
                    dist.all_reduce(flat, group=world)
                    grads = [f.view_as(g) for f, g in zip(
                        torch.split(flat[:-2], [g.numel() for g in grads]),
                        grads)]
                    stats = flat[-2:]
        loss, acc = stats[0], stats[1]
        if a > 1:
            torch._foreach_div_(grads, a)
            loss, acc = loss / a, acc / a
        with span("trainer.sync"):
            layout = getattr(model, "tp_layout", None)
            if layout is None:
                gnorm = global_norm(grads)
            else:
                gnorm = global_norm(grads, [layout.split(n) for n, _ in
                                            model.named_parameters()],
                                    layout.axis_group)
            loss_h, acc_h, gnorm_h = torch.stack(
                [loss.float(), acc.float(), gnorm.float()]).tolist()
        metrics: Dict[str, float] = {"loss": loss_h, "accuracy": acc_h,
                                     "grad_norm": gnorm_h}
        finite = math.isfinite(loss_h)
        with span("trainer.optimizer"):
            if finite or not guard:
                tx.update(params, grads, state.opt_state, gnorm_h)
            for p in params:
                p.grad = None
        if guard:
            metrics["skipped"] = int(not finite)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(cfg: TrainerConfig, mesh=None,
                   apply: Optional[Callable] = None) -> Callable:
    """Returns ``eval_step(model, x, y) -> {"loss", "accuracy"}``
    (deterministic forward, no autograd; over a process-group ``mesh``
    x, y are this rank's shard and every rank gets the metrics of the
    global batch). ``apply(x)`` replaces ``model(x)`` (the pipeline's
    forward)."""
    world = _world(mesh)

    @torch.no_grad()
    def eval_step(model, x, y) -> Dict[str, torch.Tensor]:
        logits = (model(x, deterministic=True) if apply is None
                  else apply(x))
        denom = kept_count(y, cfg, world) if world is not None else None
        stats = torch.stack(_objective(logits, y, cfg, denom))
        if world is not None:
            dist.all_reduce(stats, group=world)
        return {"loss": stats[0], "accuracy": stats[1]}

    return eval_step
