"""Autoregressive generation.

The port of ``musicgeneration_tpu/decode/engine.py``'s single-device
path. A MusicTransformer takes a one-pass prefill of the (optionally
bucketed) prompt through the relative-attention kernel, then one fused
decode step per generated token, or, with ``use_loop_kernel``, chunks
of whole sampling-and-decode steps in one launch each (kernel F). A
model without ``prefill`` (the RNN families) feeds the prompt one token
at a time through ``decode_step`` (the GRU families: kernel D once per
prompt token; MelodyRNN: its LSTM step and attention window in plain
torch), optionally from a latent-seeded state ``cache0`` and with
PerformanceRNN ``controls``. JAX ran the loops as compiled
``lax.scan``s; here they are Python loops that keep tokens on the
device and never sync the host. ``generate_sliding`` continues past
max_seq by re-priming a window. ``generate_dp`` splits the batch's rows
over the data shards of a virtual mesh (``parallel.make_mesh(dp=N,
devices=...)``), each shard running ``generate`` on its rows with its
own generator (and its own copy of the model on another device).
``generate_tp`` runs a MusicTransformer on head shards over the model axis
of a virtual mesh (``make_mesh(dp=N, tp=M, devices=...)``): each model
shard holds its heads' weights and KV cache on its device, the prefill is
the tensor-parallel forward through kernel A, and each step is the
sharded layer step written here (products, attention over the local
heads' cache, partial sums), with the logits summed to one tensor that
``generate``'s sampler draws from with ``generate``'s generator.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .sampling import SamplingParams, sample_logits


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    max_len: int                  # cache length (prompt + generated)
    steps: int                    # tokens to generate
    sampling: SamplingParams = SamplingParams()
    # opt-in, as in the JAX engine (engine.py:37-49): generate in chunks of
    # whole sampling-and-decode steps, one kernel-F launch per chunk
    # (``MusicTransformer.decode_loop``). Greedy runs give the step path's
    # tokens; sampled runs draw from the kernel's Philox stream, so the
    # same generator gives other (identically distributed) tokens.
    use_loop_kernel: bool = False


def align_cache_len(model, max_len: int) -> int:
    """Round a KV-cache length up to a 128-row multiple, or to a 16-row
    multiple where 128 would pass the model's max_seq: the JAX engine's
    rule for its fused decode (engine.py:57-81), kept so a cache has the
    same shape on both sides. Kernel B itself takes any length."""
    if max_len % 128 == 0:
        return max_len
    aligned = -(-max_len // 128) * 128
    if aligned > getattr(model, "max_seq", 1 << 30):
        aligned = -(-max_len // 16) * 16
    return aligned


def expand_controls(controls: torch.Tensor, steps: int) -> torch.Tensor:
    """[1 or S, B, C] -> [steps, B, C] (reference PerformanceRNN
    network.py:97-104; engine.py:84-96): a single control repeats at
    every step; a per-step sequence is cut to ``steps``, repeating its
    last row where it is short (the engine consumes one extra trailing
    control for the final, unused logits)."""
    if controls.dim() != 3:
        raise ValueError(f"controls must be [S, B, C]; got "
                         f"{tuple(controls.shape)}")
    s = controls.shape[0]
    if s == 1:
        return controls.expand(steps, *controls.shape[1:])
    idx = torch.arange(steps, device=controls.device).clamp_max(s - 1)
    return controls[idx]


@torch.no_grad()
def generate(model, prompt: torch.Tensor,
             generator: Optional[torch.Generator],
             decode_params: DecodeParams,
             prompt_len: Optional[int] = None,
             controls: Optional[torch.Tensor] = None,
             cache0: Optional[dict] = None) -> torch.Tensor:
    """prompt: [B, P] int tokens -> generated tokens [B, steps] int64, on
    the model's device.

    generator: a ``torch.Generator`` on the model's device for sampled
    decoding (greedy ignores it). prompt_len: the true prompt length when
    ``prompt`` is padded (with ``model.pad_id`` for a MusicTransformer)
    to a bucket length. controls: optional [1 or S, B, C] PerformanceRNN
    conditioning, one row per decode step (``expand_controls``): prompt
    token i takes row i, generated token g row P + g. cache0: optional
    start state (``model.init_cache(B, init=z)``) for the GRU families."""
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=model.device)
    b, p = prompt.shape
    dp = decode_params
    if p + dp.steps > dp.max_len:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds cache max_len "
            f"({dp.max_len}); the KV cache would overflow")
    if prompt_len is not None and not 0 < prompt_len <= p:
        raise ValueError(f"prompt_len {prompt_len} outside (0, {p}]")
    if not hasattr(model, "prefill"):
        return _generate_stepwise(model, prompt, generator, dp, prompt_len,
                                  controls, cache0)
    if controls is not None or cache0 is not None:
        raise ValueError("controls and cache0 are for the GRU families")
    if p + dp.steps > model.max_seq:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds the model's "
            f"max_seq ({model.max_seq}): the positional and relative "
            "tables end there")
    cache_len = align_cache_len(model, dp.max_len)
    if prompt_len is None:
        logits, cache = model.prefill(prompt, cache_len)
        t = p
    else:
        logits, cache = model.prefill(prompt, cache_len,
                                      last_idx=prompt_len - 1)
        t = int(prompt_len)
    sp = dp.sampling
    if dp.use_loop_kernel and hasattr(model, "decode_loop"):
        # the JAX engine's conditions (engine.py:228-234): no controls and
        # no cache0 (both refused above for this family); the kernel's
        # limits raise, never falling back to the step path
        out, _ = model.decode_loop(logits, t, generator, cache, dp.steps,
                                   sp.temperature, sp.greedy, sp.top_k,
                                   sp.top_p)
        return out
    stacked = model.decode_weights()
    out = torch.empty(b, dp.steps, dtype=torch.long, device=model.device)
    for i in range(dp.steps):
        token = sample_logits(logits, dp.sampling, generator)
        out[:, i] = token
        logits, cache = model.decode_step(token, cache, t, stacked)
        t += 1
    return out


def _generate_stepwise(model, prompt, generator, dp: DecodeParams,
                       prompt_len: Optional[int], controls, cache0):
    """``generate`` for a model without ``prefill``: the prompt's tokens
    through ``decode_step`` one at a time, then sample and step. The JAX
    engine pads a prompt to a bucket and masks the padded steps only to
    reuse one compiled scan; the state after the true prompt is the
    same, so only ``prompt_len`` tokens run here."""
    b, p = prompt.shape
    n = p if prompt_len is None else int(prompt_len)
    if controls is not None:
        if prompt_len is not None and prompt_len != p:
            raise ValueError("controls + a padded prompt are not supported "
                             "together (control/step alignment assumes the "
                             "unpadded prompt)")
        controls = expand_controls(
            torch.as_tensor(controls, dtype=torch.float32,
                            device=model.device), p + dp.steps)
    cache = cache0 if cache0 is not None else model.init_cache(b)

    def step(token, cache, i):
        if controls is None:
            return model.decode_step(token, cache)
        return model.decode_step(token, cache, controls[i])

    for i in range(n):
        logits, cache = step(prompt[:, i], cache, i)
    out = torch.empty(b, dp.steps, dtype=torch.long, device=model.device)
    for g in range(dp.steps):
        token = sample_logits(logits, dp.sampling, generator)
        out[:, g] = token
        logits, cache = step(token, cache, n + g)
    return out


def generate_events(model, prompt_ids, steps: int,
                    max_len: Optional[int] = None,
                    sampling: SamplingParams = SamplingParams(),
                    generator: Optional[torch.Generator] = None
                    ) -> np.ndarray:
    """Host-friendly wrapper: 1D prompt ids -> 1D numpy continuation."""
    prompt = torch.as_tensor(np.asarray(prompt_ids, np.int64))[None]
    max_len = max_len or (prompt.shape[1] + steps)
    dp = DecodeParams(max_len=max_len, steps=steps, sampling=sampling)
    return generate(model, prompt, generator, dp)[0].cpu().numpy()


def generate_sliding(model, prompt, generator: Optional[torch.Generator],
                     steps: int, window: int = 512,
                     sampling: SamplingParams = SamplingParams()
                     ) -> np.ndarray:
    """Unbounded-length generation by window re-priming
    (engine.py:416-452): generate in cached chunks of a 2*window cache;
    when it fills, re-prime from the last ``window`` tokens and go on.

    prompt: [B, P] ints; returns [B, steps] numpy int64. Chunks draw
    from ``generator`` in turn (greedy ignores it)."""
    if 2 * window > model.max_seq:
        raise ValueError(
            f"window ({window}) must be <= max_seq//2 ({model.max_seq // 2})"
            ": the sliding cache spans 2*window positions, all of which "
            "must stay inside the model's position/E tables")
    max_len = 2 * window
    produced = []
    ctx = np.asarray(prompt, np.int64)[:, -window:]
    remaining = steps
    while remaining > 0:
        chunk = min(remaining, max_len - ctx.shape[1])
        dp = DecodeParams(max_len=max_len, steps=chunk, sampling=sampling)
        out = generate(model, torch.from_numpy(ctx), generator,
                       dp).cpu().numpy()
        produced.append(out)
        remaining -= chunk
        ctx = np.concatenate([ctx, out], axis=1)[:, -window:]
    return np.concatenate(produced, axis=1)[:, :steps]


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """Data shard ``shard``'s sampling stream, a pure function of (seed,
    shard), as JAX folds the shard index into its key: the shards draw
    independent streams of the single-device sampler's distribution."""
    w = np.random.SeedSequence([int(seed), int(shard)]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(w[0]) << 32) | int(w[1])) & ((1 << 63) - 1))
    return gen


def run_data_parallel(model, mesh, seed: int, batch: int, fn: Callable):
    """``fn(model_i, rows_i, generator_i)`` for each data shard i of the
    virtual ``mesh``, one after another on this host thread, with the
    shard's CUDA device current (the kernel wrappers launch into the
    current device's stream): the model on the shard's device (``model``
    itself where it sits there, else a copy made for this call), the
    shard's rows of the batch (a slice: rows [i * B / dp, (i + 1) * B /
    dp)) and ``shard_generator(seed, i)``. Returns the shards' outputs
    (tensors, or tuples of them, batch on axis 0) concatenated on
    ``model``'s device. No collective runs: the shards share nothing."""
    if not mesh.virtual:
        raise ValueError("data-parallel decode holds every data shard in "
                         "this process: give it a virtual mesh "
                         "(make_mesh(dp=N, devices=[...]))")
    if mesh.size != 1:
        raise ValueError(f"data-parallel decode takes a mesh with sp=1; got "
                         f"sp={mesh.size}")
    if batch % mesh.data:
        raise ValueError(f"batch {batch} not divisible by the data axis "
                         f"({mesh.data})")
    per = batch // mesh.data
    replicas = {model.device: model}
    outs = []
    for i, dev in enumerate(mesh.devices):
        guard = torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext()
        with guard:
            if dev not in replicas:
                replicas[dev] = copy.deepcopy(model).to(dev)
            outs.append(fn(replicas[dev], slice(i * per, (i + 1) * per),
                           shard_generator(seed, i, dev)))
    home = model.device
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[k].to(home) for o in outs])
                     for k in range(len(outs[0])))
    return torch.cat([o.to(home) for o in outs])


def _cache_rows(cache0: Optional[dict], rows: slice, device):
    """A shard's part of a GRU start state: [L, B, ...] leaves cut on
    axis 1; leaves of fewer dims carry no batch axis and are kept whole
    (JAX's ``generate_dp`` cache specs)."""
    if cache0 is None:
        return None
    return {k: (v[:, rows] if v.dim() >= 2 else v).to(device)
            for k, v in cache0.items()}


@torch.no_grad()
def generate_dp(model, prompt, seed: int, decode_params: DecodeParams,
                mesh, prompt_len: Optional[int] = None,
                controls: Optional[torch.Tensor] = None,
                cache0: Optional[dict] = None) -> torch.Tensor:
    """Data-parallel batched decode over the data shards of a virtual
    ``mesh`` (JAX ``decode/engine.py::generate_dp``): prompt [B, P] ->
    tokens [B, steps] on the model's device. Each shard runs ``generate``
    on its rows (its prefill and decode steps launch kernels A and B, or
    D, at B / dp rows), with ``shard_generator(seed, i)``; controls [1 or
    S, B, C] and cache0 ([L, B, ...] leaves) are cut on their batch axis.
    Greedy decoding gives ``generate``'s tokens; sampled rows come from
    the shards' own streams. B must divide by the data axis."""
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    if controls is not None:
        controls = torch.as_tensor(controls, dtype=torch.float32)

    def shard(m, rows, gen):
        ctrl = None if controls is None else controls[:, rows].to(m.device)
        return generate(m, prompt[rows].to(m.device), gen, decode_params,
                        prompt_len, ctrl, _cache_rows(cache0, rows,
                                                      m.device))

    return run_data_parallel(model, mesh, seed, prompt.shape[0], shard)


class _TPDecoder:
    """One data shard of ``generate_tp``: the model's replicated tensors
    on the shard's first device (``home``), each model shard's weights,
    head columns and KV cache on its own device."""

    def __init__(self, model, mesh, devices):
        from ..parallel import tensor_parallel as tp

        self.tp, self.mesh, self.devices = tp, mesh, devices
        self.home = devices[0]
        self.model = model if model.device == self.home \
            else copy.deepcopy(model).to(self.home)
        self.layers = [
            [dict({k: v.detach().to(dev).contiguous() for k, v in
                   layer.tp_weights(m, mesh).items()}, device=dev)
             for m, dev in enumerate(devices)]
            for layer in self.model.Decoder.enc_layers]
        fc = self.model.fc.weight.detach()
        self.head_w = [tp.part(fc, 1, mesh, m).to(dev, model.dtype)
                       .contiguous() for m, dev in enumerate(devices)]
        self.cache = None

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """[B, d] -> f32 logits [B, vocab]: the head's partial products
        over its input columns, summed."""
        m, tp = self.model, self.tp
        parts = []
        for i, (w, dev) in enumerate(zip(self.head_w, self.devices)):
            with tp.on(dev):
                parts.append(F.linear(
                    tp.part(h, -1, self.mesh, i).to(dev, m.dtype), w))
        return tp.reduce_from_model(parts, self.mesh, m.fc.bias,
                                    m.dtype).float()

    def prefill(self, x: torch.Tensor, cache_len: int, last: int):
        """The tensor-parallel forward of prompt x [B, P] (kernel A on
        each shard's heads), filling each shard's cache [L, B, cache_len,
        d / tp]; returns the logits of position ``last``."""
        m = self.model
        b, p = x.shape
        key_pad = (x == m.pad_id).float()
        h = m.embed_positions(x)
        dloc = m.d_model // self.mesh.model
        self.cache = [{k: torch.zeros(m.num_layers, b, cache_len, dloc,
                                      dtype=m.dtype, device=dev)
                       for k in "kv"} for dev in self.devices]
        for li, layer in enumerate(m.Decoder.enc_layers):
            h, ks, vs = layer.forward_tp(h, key_pad, None, True,
                                         self.layers[li], self.mesh)
            for c, k, v in zip(self.cache, ks, vs):
                c["k"][li, :, :p] = k.transpose(1, 2).reshape(b, p, -1)
                c["v"][li, :, :p] = v.transpose(1, 2).reshape(b, p, -1)
        return self.logits(h[:, last])

    def step(self, token: torch.Tensor, t: int) -> torch.Tensor:
        """token [B] at position t -> f32 logits [B, vocab], each shard's
        cache row t written: every layer as Wq/Wk/Wv rows, attention over
        the shard's heads' cache rows [0, t] with the relative bias,
        partial fc and FFN products summed."""
        m, tp, dt = self.model, self.tp, self.model.dtype
        h = m._embed(token) + m.pos_table[t].to(dt)
        max_seq = m.max_seq
        for li, layer in enumerate(m.Decoder.enc_layers):
            parts = []
            for w, c in zip(self.layers[li], self.cache):
                dev = w["device"]
                with tp.on(dev):
                    xs = h.to(dev, dt)
                    q, k, v = (F.linear(xs, w["w" + n].to(dt),
                                        w["b" + n].to(dt)) for n in "qkv")
                    c["k"][li, :, t] = k
                    c["v"][li, :, t] = v
                    b, dh = q.shape[0], w["e"].shape[-1]
                    keys = c["k"][li, :, :t + 1].float().view(b, t + 1, -1,
                                                              dh)
                    vals = c["v"][li, :, :t + 1].float().view(b, t + 1, -1,
                                                              dh)
                    qh = q.float().view(b, -1, dh)
                    e_rows = w["e"][max_seq - 1 - t:max_seq]  # s = 0..t
                    logits = (torch.einsum("bhd,bshd->bhs", qh, keys)
                              + torch.einsum("bhd,sd->bhs", qh, e_rows)
                              ) / math.sqrt(dh)
                    attn = torch.einsum("bhs,bshd->bhd",
                                        torch.softmax(logits, -1), vals)
                    parts.append(F.linear(attn.reshape(b, -1).to(dt),
                                          w["wfc"].to(dt)))
            attn = tp.reduce_from_model(parts, self.mesh, layer.rga.fc.bias,
                                        dt)
            out1 = _layer_norm(layer.layernorm1, attn + h)
            parts = []
            for w in self.layers[li]:
                with tp.on(w["device"]):
                    hid = torch.relu(F.linear(out1.to(w["device"]),
                                              w["w1"].to(dt),
                                              w["b1"].to(dt)))
                    parts.append(F.linear(hid, w["w2"].to(dt)))
            ffn = tp.reduce_from_model(parts, self.mesh, layer.FFN_suf.bias,
                                       dt)
            h = _layer_norm(layer.layernorm2, out1 + ffn)
        return self.logits(h)


def _layer_norm(ln, x):
    from ..models.music_transformer import _layer_norm as norm
    return norm(ln, x)


@torch.no_grad()
def generate_tp(model, prompt, seed: Union[int, torch.Generator],
                decode_params: DecodeParams, mesh,
                prompt_len: Optional[int] = None) -> torch.Tensor:
    """Tensor-parallel decode of a MusicTransformer over the model axis of a
    virtual ``mesh``, optionally with data shards (a dp x tp mesh; JAX
    ``decode/engine.py::generate_tp``): prompt [B, P] -> tokens [B,
    steps] on the model's device.

    Data shard i takes rows [i * B / dp, (i + 1) * B / dp); model shard m
    of it holds heads [m * H / tp, (m + 1) * H / tp) of every layer, the
    matching FFN hidden units and head columns, and their KV cache, on
    ``mesh.model_devices[i][m]``, current while it runs. The prefill runs
    kernel A on each shard's heads; the steps are the sharded layer step
    (no kernel B: JAX's tensor-parallel step is XLA's partition of its
    XLA decode step). Every step the data shards' logits, each summed
    over the model shards, form one [B, vocab] tensor that
    ``sample_logits`` draws from with one generator: ``seed`` (an int:
    ``torch.Generator(device).manual_seed(seed)`` on the first shard's
    device, as ``cli.generate`` makes for ``generate``; or a generator),
    so greedy and sampled tokens are ``generate``'s. Refuses what JAX
    refuses: heads or the FFN not divisible by the model axis, a batch
    not divisible by the data axis, int8 weights and the decode loop
    (both ride the fused kernels)."""
    if not mesh.virtual:
        raise ValueError("generate_tp holds every shard in this process: "
                         "give it a virtual mesh (make_mesh(dp=N, tp=M, "
                         "devices=[...]))")
    if mesh.size != 1 or mesh.pipe != 1:
        raise ValueError(f"generate_tp takes a (data, model) mesh; got "
                         f"sp={mesh.size}, pp={mesh.pipe}")
    n_model, n_data = mesh.model, mesh.data
    for what, n in (("num_heads", model.num_heads),
                    ("ffn_dim", model.ffn_dim)):
        if n % n_model:
            raise ValueError(f"{what}={n} not divisible by the model axis "
                             f"({n_model})")
    if model.decode_quant != "none" or decode_params.use_loop_kernel:
        raise ValueError(
            "generate_tp shards the unquantized decode step; int8 weights "
            "and the decode loop ride the fused kernels (B, E, F) on one "
            "device")
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    b, p = prompt.shape
    if b % n_data:
        raise ValueError(f"batch {b} not divisible by the data axis "
                         f"({n_data})")
    dp = decode_params
    if p + dp.steps > dp.max_len:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds cache max_len "
            f"({dp.max_len}); the KV cache would overflow")
    if p + dp.steps > model.max_seq:
        raise ValueError(
            f"prompt ({p}) + steps ({dp.steps}) exceeds the model's "
            f"max_seq ({model.max_seq}): the positional and relative "
            "tables end there")
    if prompt_len is not None and not 0 < prompt_len <= p:
        raise ValueError(f"prompt_len {prompt_len} outside (0, {p}]")
    cache_len = align_cache_len(model, dp.max_len)
    t = p if prompt_len is None else int(prompt_len)
    per = b // n_data
    shards = [_TPDecoder(model, mesh, devs) for devs in mesh.model_devices]
    home = shards[0].home
    gen = seed if isinstance(seed, torch.Generator) or seed is None \
        else torch.Generator(device=home).manual_seed(int(seed))

    def gathered(fn):
        outs = []
        for i, sh in enumerate(shards):
            with sh.tp.on(sh.home):
                outs.append(fn(i, sh).to(home))
        return torch.cat(outs)

    logits = gathered(lambda i, sh: sh.prefill(
        prompt[i * per:(i + 1) * per].to(sh.home), cache_len, t - 1))
    out = torch.empty(b, dp.steps, dtype=torch.long, device=home)
    for i in range(dp.steps):
        token = sample_logits(logits, dp.sampling, gen)
        out[:, i] = token
        logits = gathered(lambda j, sh: sh.step(
            token[j * per:(j + 1) * per].to(sh.home), t))
        t += 1
    return out.to(model.device)
