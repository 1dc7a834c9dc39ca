"""The chunked decode loop: C whole sampling-and-decode steps per launch
(kernel F) and its plain version.

The counterpart of ``musicgeneration_tpu/ops/pallas_decode_loop.py``.
``fused_decode_loop`` launches the hand-written CUDA kernel of
``csrc/fused_decode.cu`` (``mg_decode_loop``) for CUDA tensors and runs
``fused_decode_loop_plain`` for CPU tensors; there is no other path.
Each of the C steps of a launch:

1. samples from the carried logits: greedy argmax (the lowest index on
   ties), or the Gumbel-max trick over ``logits * (1 / max(T, 1e-6))``
   after ``sample_mask`` when top-k or top-p is set;
2. embeds the token as the step path does: the embedding row in the
   model dtype times sqrt(d) (rounded to the model dtype), rounded, plus
   the positional row in the model dtype;
3. runs every layer (``fused_decode_step_plain``'s arithmetic), writing
   the step's K/V rows into the caches IN PLACE at row t (the JAX kernel
   returned the chunk's rows and its caller inserted them);
4. runs the output head, rounded to the model dtype and carried as f32.

The random stream. The TPU kernel drew from the core's own PRNG
(``pltpu.prng_seed``/``prng_random_bits``), which has no counterpart
here, so the port defines its own: Philox4x32-10 with

    key     = (seed & 0xffffffff, seed >> 32)
    counter = (v // 4, b, t, 0), taking output word v % 4,

for vocabulary entry v of batch row b sampling the token at absolute
position t. The kernel uses the same layout, so kernel and plain version
draw identical bits. The Gumbel noise is the TPU kernel's
(pallas_decode_loop.py:223-227): u = max((bits >> 8) * 2^-24, 1e-10),
g = -log(-log(u)).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build
from .fused_decode import (MAX_D, MAX_FFN, WEIGHT_KEYS, _check,
                           fused_decode_step_plain)

_MASK32 = 0xFFFFFFFF
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
NEG = -1e30  # what sample_mask gives an excluded entry
SMEM_LIMIT = 232448  # dynamic shared memory one block may take (227 KB)
LOOP_THREADS = 512   # threads of kernel F's one-block body (one a batch row)
# kernel F's cluster body (bf16): a cluster of LOOP_NC CTAs of 256 threads
# per batch row, each with up to LOOP_MAX_SLOTS weight slots, LOOP_RED
# floats of partial sums, and its prefix rows staged in what shared memory
# is left
LOOP_NC, LOOP_MAX_SLOTS, LOOP_RED = 8, 3, 12 * 256
_PACKED_KEYS = ("wq", "wk", "wv", "wfc", "ffn1_w", "ffn2_w")


# -- the sampler --------------------------------------------------------------

def sortable_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 key, strictly monotone in float order (negatives XOR
    their low 31 bits; the sign bit keeps them below the positives)."""
    s = x.contiguous().view(torch.int32)
    return s ^ ((s >> 31) & 0x7FFFFFFF)


def mask_search(key: torch.Tensor, pred_stat, threshold: float
                ) -> torch.Tensor:
    """Smallest int32 T with stat-of-keys-strictly-above-T < threshold,
    by a 32-step bisection. key: [B, V] int32; ``pred_stat(mid)`` -> [B, 1]
    f32 stat over {key > mid}; returns T [B, 1] int32."""
    b = key.shape[0]
    lo = torch.full((b, 1), _INT32_MIN, dtype=torch.int32, device=key.device)
    hi = torch.full((b, 1), _INT32_MAX, dtype=torch.int32, device=key.device)
    thr = torch.tensor(threshold, dtype=torch.float32, device=key.device)
    for _ in range(32):
        # overflow-safe floor((lo + hi) / 2)
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        up = pred_stat(mid) >= thr
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    return hi


def sample_mask(scaled: torch.Tensor, top_k: int, top_p: float
                ) -> torch.Tensor:
    """The XLA sampler's top-k / top-p masking of temperature-scaled
    logits [B, V] f32, without sorting: excluded entries drop to -1e30,
    kept entries keep their exact values.

    * top-k keeps element i iff #(l_j > l_i) < k (ties at the boundary
      are all kept, like ``logits < kth``),
    * top-p, after top-k, keeps element i iff the probability mass
      strictly above l_i is < p (p clamped to 1e-9, so the argmax always
      stays),

    both as an integer threshold on order-isomorphic int32 keys found by
    bisection (count / masked-mass reductions per step).

    Boundary tolerance: the top-p mass here sums masked probabilities in
    UNSORTED f32 order while the XLA sampler cumsums sorted probs — when
    the cumulative mass lands within float-reassociation distance (~1e-7
    relative) of p EXACTLY at a kept/dropped boundary, the two could keep
    different (both valid, off-by-one-element) sets. Set equality is
    fuzz-locked at V=309 and V=4096 (tests/test_torch_decode_loop.py)
    where no such collision occurs with random logits; an adversarial p
    chosen equal to a partial sum could differ by the boundary element."""
    v = scaled.shape[1]
    key = sortable_key(scaled)
    if top_k and 0 < top_k < v:
        t_k = mask_search(
            key, lambda mid: (key > mid).float().sum(-1, keepdim=True),
            float(top_k))
        kept = key >= t_k
        scaled = torch.where(kept, scaled, torch.full_like(scaled, NEG))
        key = torch.where(kept, key, torch.full_like(key, _INT32_MIN))
    if top_p < 1.0:
        m = scaled.amax(-1, keepdim=True)
        ex = torch.exp(scaled - m)
        probs = ex / ex.sum(-1, keepdim=True)
        zero = torch.zeros_like(probs)
        t_p = mask_search(
            key, lambda mid: torch.where(key > mid, probs, zero).sum(
                -1, keepdim=True),
            float(np.float32(max(top_p, 1e-9))))
        scaled = torch.where(key >= t_p, scaled, torch.full_like(scaled, NEG))
    return scaled


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * x (x: int64 holding
    u32 values), in 16-bit pieces so no int64 product overflows."""
    p_lo = (m & 0xFFFF) * x               # < 2^48
    p_hi = (m >> 16) * x                  # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 (Salmon et al., SC 2011; Random123's constants):
    counter [..., 4] and key [..., 2] int64 tensors holding u32 words ->
    [..., 4] int64 u32 words. Broadcasts counter against key."""
    c = [counter[..., i].long() & _MASK32 for i in range(4)]
    k0, k1 = key[..., 0].long() & _MASK32, key[..., 1].long() & _MASK32
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(torch.broadcast_tensors(*c), -1)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from u32 random words (int64 tensor), as the TPU
    kernel draws it: u = max((bits >> 8) * 2^-24, 1e-10); -log(-log(u))."""
    u = torch.clamp_min((bits >> 8).float() * (1.0 / float(1 << 24)), 1e-10)
    return -torch.log(-torch.log(u))


def loop_bits(seed: torch.Tensor, rows: torch.Tensor, t: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """The random words [N, vocab] of N draws: draw n is batch row
    ``rows[n]`` sampling position ``t[n]`` under ``seed[n]`` (int64 [N]
    tensors on one device; see the module docstring for the layout)."""
    dev = seed.device
    groups = torch.arange((vocab + 3) // 4, dtype=torch.int64, device=dev)
    n = seed.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    counter = torch.stack(torch.broadcast_tensors(
        groups[None, :], rows.long()[:, None], t.long()[:, None],
        zero), -1)                                          # [N, G, 4]
    s = seed.long()
    key = torch.stack([s & _MASK32, (s >> 32) & _MASK32], -1)[:, None]
    return philox4x32_10(counter, key).reshape(n, -1)[:, :vocab]


def inv_temperature(temperature: float) -> float:
    """1 / max(T, 1e-6) as an f32 value: the scale the sampler multiplies
    the logits by, the same number in the kernel and here."""
    return float(np.float32(1.0 / max(float(temperature), 1e-6)))


def loop_sample(logits: torch.Tensor, seed: torch.Tensor, rows: torch.Tensor,
                t: torch.Tensor, temperature: float = 1.0,
                greedy: bool = False, top_k: int = 0, top_p: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the loop's sampler, plain: logits [N, V] f32 and the
    per-draw seed, batch row and position (int64 [N]) -> (tokens [N]
    int64, the masked scaled logits [N, V] the draw was taken over; the
    raw logits when greedy)."""
    if greedy:
        return torch.argmax(logits, -1), logits
    scaled = logits * inv_temperature(temperature)
    if (top_k and top_k > 0) or top_p < 1.0:
        scaled = sample_mask(scaled, top_k, top_p)
    g = gumbel(loop_bits(seed, rows, t, logits.shape[1]))
    return torch.argmax(scaled + g, -1), scaled


def embed_scale(d: int, dtype) -> float:
    """sqrt(d) rounded to the model dtype, as ``MusicTransformer._embed``."""
    return float(torch.tensor(math.sqrt(d)).to(dtype))


# -- the loop -----------------------------------------------------------------

def fused_decode_loop_plain(logits, t0: int, seed, embed, pos, e_all,
                            weights, fc_w, fc_b, k_cache, v_cache,
                            num_heads: int, chunk: int,
                            temperature: float = 1.0, greedy: bool = False,
                            top_k: int = 0, top_p: float = 1.0,
                            tokens: Optional[torch.Tensor] = None,
                            packed: Optional[list] = None):
    """Plain PyTorch version of kernel F (any device). ``chunk`` steps from
    the carried ``logits`` [B, V] f32 at positions t0..t0+chunk-1; the
    other arguments as ``fused_decode_loop`` (``packed`` is not read: the
    plain version reads the stacked weights). Writes the tokens into
    ``tokens`` [B, chunk] (allocated when None), the last logits into
    ``logits`` and the K/V rows [t0, t0+chunk) into the caches, all in
    place, and returns (tokens, logits)."""
    b = logits.shape[0]
    d = embed.shape[1]
    dev = logits.device
    if tokens is None:
        tokens = torch.empty(b, chunk, dtype=torch.long, device=dev)
    scale = embed_scale(d, embed.dtype)
    rows = torch.arange(b, device=dev)
    seeds = seed.reshape(1).expand(b)
    cur = logits
    for i in range(chunk):
        t = t0 + i
        tok, _ = loop_sample(cur, seeds, rows,
                             torch.full((b,), t, dtype=torch.long,
                                        device=dev),
                             temperature, greedy, top_k, top_p)
        tokens[:, i] = tok
        h = embed[tok] * scale + pos[t]
        h, k_cache, v_cache = fused_decode_step_plain(
            h, t, e_all, weights, k_cache, v_cache, num_heads)
        cur = F.linear(h, fc_w, fc_b).float()
    logits.copy_(cur)
    return tokens, logits


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def loop_cluster_layout(d: int, f: int, vocab: int, cache_len: int,
                        num_heads: int) -> Tuple[int, int]:
    """(bytes before the weight slots, bytes of one slot) of a CTA of
    kernel F's bf16 body (mirrors ``LcLayout`` in csrc/fused_decode.cu):
    the logits and the sampler's probabilities [V rounded up to 4]; x, q,
    row t's k and v (bf16), the attention output, out1, z, the FFN hidden
    layer and a product's outputs; the partial sums; the other CTAs'
    head maxima and (l, PV) sums; the CTA's scores [H, ceil(S / nc) +
    1]; the reductions' scratch; the layer's vectors (bf16: five bias
    slices of d / nc, one of the FFN slice, the two layer norms'
    parameters over d); the mbarriers of the slots and of the staged
    rows. A slot holds the largest weight slice:
    d x d / nc, d x the FFN slice, FFN x d / nc, or the head's ceil(V /
    nc) rows."""
    nc = LOOP_NC
    ds, fsl = d // nc, _round_up(-(-f // nc), 8)
    vsl, sl = -(-vocab // nc), -(-cache_len // nc) + 1
    rest = (8 * _round_up(vocab, 4) + 4 * 2 * d + 2 * 2 * d + 4 * 3 * d
            + 4 * _round_up(f, 4) + 4 * max(d, f) + 4 * LOOP_RED
            + 4 * nc * num_heads + 4 * nc * (num_heads + d)
            + 4 * num_heads * sl + 256
            + 2 * _round_up(5 * ds + fsl + 4 * d, 8)
            + 8 * (LOOP_MAX_SLOTS + 1))
    slot = 2 * max(d * ds, d * fsl, f * ds, vsl * d)
    return _round_up(rest, 128), _round_up(slot, 128)


def loop_cluster_slots(d: int, f: int, vocab: int, cache_len: int,
                       num_heads: int) -> int:
    """The weight slots a CTA of kernel F's bf16 body takes: as many as
    its shared memory holds past the rest, at most LOOP_MAX_SLOTS."""
    rest, slot = loop_cluster_layout(d, f, vocab, cache_len, num_heads)
    return max(0, min(LOOP_MAX_SLOTS, (SMEM_LIMIT - rest) // slot))


def loop_cluster_cap(d: int, f: int, vocab: int, cache_len: int,
                     num_heads: int) -> int:
    """The prefix rows (K and V in bf16, E in f32) a CTA of kernel F's bf16
    body stages: what its shared memory holds past the slots."""
    rest, slot = loop_cluster_layout(d, f, vocab, cache_len, num_heads)
    ns = loop_cluster_slots(d, f, vocab, cache_len, num_heads)
    return max(0, (SMEM_LIMIT - rest - ns * slot) // (4 * d + 256))


def loop_takes_cluster(d: int, f: int, vocab: int, cache_len: int,
                       num_heads: int, dtype=torch.bfloat16) -> bool:
    """Whether kernel F runs its cluster body on these widths: bf16, d a
    multiple of 8 * LOOP_NC and two weight slots past the rest of a CTA's
    shared memory (mirrors ``loop_cluster_fits`` in csrc/fused_decode.cu).
    Other widths, and f32, run the one-block-a-row body."""
    return (dtype == torch.bfloat16 and d % (8 * LOOP_NC) == 0
            and loop_cluster_slots(d, f, vocab, cache_len, num_heads) >= 2)


def _packed_shape(key: str, w: torch.Tensor) -> Tuple[int, ...]:
    n = w.shape[-1]
    cols = _round_up(-(-n // LOOP_NC), 8) if key == "ffn1_w" else n // LOOP_NC
    return (w.shape[0], LOOP_NC, w.shape[1], cols)


def pack_loop_matrices(weights) -> list:
    """The six matrices of kernel F's cluster body (wq, wk, wv, wfc, ffn1_w,
    ffn2_w of ``fused_decode_step``'s stacked [L, K, N] weights) repacked
    [L, nc, K, N / nc], so that each cluster CTA's column slice of a
    layer's matrix is one contiguous bulk copy; ffn1_w's columns
    zero-padded to nc 8-aligned slices first. New tensors; the weights are
    not written. Build them once with the weights, as
    ``MusicTransformer.decode_loop`` does, and pass them to every
    ``fused_decode_loop`` call."""
    out = []
    for key in _PACKED_KEYS:
        w = weights[key]
        shape = _packed_shape(key, w)
        if shape[1] * shape[3] != w.shape[-1]:
            w = F.pad(w, (0, shape[1] * shape[3] - w.shape[-1]))
        out.append(w.reshape(shape[0], shape[2], shape[1], shape[3])
                   .permute(0, 2, 1, 3).contiguous())
    return out


def loop_smem_bytes(d: int, f: int, vocab: int, cache_len: int,
                    num_heads: int, dtype=torch.bfloat16) -> int:
    """Dynamic shared memory of one of kernel F's blocks. The cluster body
    (``loop_takes_cluster``): a CTA's ``loop_cluster_layout``, its slots and
    its staged rows. The one-block body: the logits and the sampler's
    probabilities [V rounded up to 4], five [max(d, f)] activation
    buffers, the matvec / PV partials [8 x 512], the attention scores
    [H, S + 1] and the reduction scratch (mirrors ``loop_smem`` in
    csrc/fused_decode.cu)."""
    if loop_takes_cluster(d, f, vocab, cache_len, num_heads, dtype):
        rest, slot = loop_cluster_layout(d, f, vocab, cache_len, num_heads)
        return (rest + loop_cluster_slots(d, f, vocab, cache_len, num_heads)
                * slot + loop_cluster_cap(d, f, vocab, cache_len, num_heads)
                * (4 * d + 256))
    w = max(d, f)
    return 4 * (2 * (-(-vocab // 4) * 4) + 5 * w + 8 * LOOP_THREADS
                + num_heads * (cache_len + 1) + 64)


def loop_kernel_limits(d: int, dh: int, f: int, vocab: int, cache_len: int,
                       num_heads: int, dtype=torch.bfloat16) -> None:
    """Raise unless kernel F takes these widths in ``dtype``: dh = 64, d
    <= 1024 (one warp per head), FFN <= 4096 and a multiple of 8 (16-byte
    weight loads), and the shared memory of the body the widths choose
    (``loop_takes_cluster``) within one block's 227 KB. This limit
    replaces the TPU's ``decode_loop_vmem_bytes``."""
    if dh != 64 or d > MAX_D or f > MAX_FFN or f % 8:
        raise ValueError(f"kernel F takes dh = 64, d <= {MAX_D} and FFN <= "
                         f"{MAX_FFN} (a multiple of 8); got dh={dh}, d={d}, "
                         f"FFN={f}")
    smem = loop_smem_bytes(d, f, vocab, cache_len, num_heads, dtype)
    if smem > SMEM_LIMIT:
        raise ValueError(f"kernel F needs {smem} bytes of shared memory for "
                         f"vocab {vocab}, cache {cache_len}, d {d}, FFN {f}: "
                         f"past the {SMEM_LIMIT} one block may take")


def _check_loop(logits, t0, seed, embed, pos, e_all, weights, fc_w, fc_b,
                k_cache, v_cache, num_heads, chunk, tokens):
    cuda_build.refuse_dtensors("the decode loop", logits, embed, pos, fc_w,
                               fc_b, tokens)
    if logits.dim() != 2 or logits.dtype != torch.float32:
        raise ValueError(f"logits must be [B, V] float32; got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    b, v = logits.shape
    dtype = k_cache.dtype
    if embed.dim() != 2 or embed.shape[0] != v:
        raise ValueError(f"embed must be [{v}, d]; got {tuple(embed.shape)}")
    d = embed.shape[1]
    x = torch.empty(b, d, dtype=embed.dtype, device=embed.device)
    nl, _, s, _, dh, f = _check(x, t0, e_all, weights, k_cache, v_cache,
                                num_heads, None, None)
    if chunk < 1 or t0 + chunk > min(s, e_all.shape[1]):
        raise ValueError(f"chunk {chunk} at t0={t0}: rows [{t0}, "
                         f"{t0 + chunk}) must lie in the cache ({s}) and the "
                         f"relative table ({e_all.shape[1]})")
    for name, y, shape in (("pos", pos, (pos.shape[0], d)),
                           ("fc_w", fc_w, (v, d)), ("fc_b", fc_b, (v,))):
        if tuple(y.shape) != shape or y.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}; got "
                             f"{tuple(y.shape)} {y.dtype}")
    if pos.shape[0] < t0 + chunk:
        raise ValueError(f"pos has {pos.shape[0]} rows; the chunk needs "
                         f"{t0 + chunk}")
    if seed.numel() != 1 or seed.dtype != torch.int64:
        raise ValueError("seed must be one int64 element")
    if tokens is not None and (tuple(tokens.shape) != (b, chunk)
                               or tokens.dtype != torch.long
                               or tokens.stride(1) != 1):
        raise ValueError(f"tokens must be a [{b}, {chunk}] int64 view with "
                         "unit column stride")
    if any(y.device != logits.device for y in (
            seed, embed, pos, e_all, fc_w, fc_b, k_cache)
           + (() if tokens is None else (tokens,))):
        raise ValueError("every tensor must be on one device")
    return nl, b, s, d, dh, f, v


def fused_decode_loop(logits: torch.Tensor, t0: int, seed: torch.Tensor,
                      embed: torch.Tensor, pos: torch.Tensor,
                      e_all: torch.Tensor, weights, fc_w: torch.Tensor,
                      fc_b: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, num_heads: int, chunk: int,
                      temperature: float = 1.0, greedy: bool = False,
                      top_k: int = 0, top_p: float = 1.0,
                      tokens: Optional[torch.Tensor] = None,
                      packed: Optional[list] = None):
    """``chunk`` whole generation steps in one launch.

    logits: [B, V] f32, the logits of position t0 - 1 (carried: the last
    step's are written back into it); t0: int, the first position
    written; seed: one int64 element on the device (this chunk's seed,
    never read back by the wrapper); embed: [V, d], pos: [>= t0+chunk, d],
    fc_w: [V, d] (the head's ``weight``), fc_b: [V], all in the model
    dtype; e_all, weights, k_cache, v_cache as ``fused_decode_step``;
    tokens: optional [B, chunk] int64 view (unit column stride) to write
    the tokens into; packed: ``pack_loop_matrices(weights)``, which the
    cluster body reads (built once with the weights; needed where
    ``loop_takes_cluster``, else not read). Returns (tokens, logits); the
    caches get rows [t0, t0+chunk) in place.

    CPU tensors run the plain version. CUDA tensors launch kernel F (its
    limits in ``loop_kernel_limits``, 16-byte aligned contiguous tensors)
    or raise: its cluster body, 8 CTAs a batch row, on the bf16 widths
    ``loop_takes_cluster`` admits, else its one-block-a-row body.
    ``launches`` counts its CUDA launches: one per chunk."""
    nl, b, s, d, dh, f, v = _check_loop(
        logits, t0, seed, embed, pos, e_all, weights, fc_w, fc_b, k_cache,
        v_cache, num_heads, chunk, tokens)
    if logits.device.type == "cpu":
        return fused_decode_loop_plain(
            logits, t0, seed, embed, pos, e_all, weights, fc_w, fc_b,
            k_cache, v_cache, num_heads, chunk, temperature, greedy, top_k,
            top_p, tokens)
    if logits.device.type != "cuda":
        raise ValueError(f"unsupported device {logits.device}")
    loop_kernel_limits(d, dh, f, v, s, num_heads, k_cache.dtype)
    ws = [weights[k] for k in WEIGHT_KEYS]
    cluster = loop_takes_cluster(d, f, v, s, num_heads, k_cache.dtype)
    if cluster:
        want = [_packed_shape(k, weights[k]) for k in _PACKED_KEYS]
        if packed is None or [tuple(p.shape) for p in packed] != want or any(
                p.dtype != k_cache.dtype or p.device != logits.device
                for p in packed):
            raise ValueError("kernel F's cluster body reads the matrices "
                             "pack_loop_matrices(weights) gives: shapes "
                             f"{want} in {k_cache.dtype} on the device")
    else:
        packed = []
    # the seed is read as one scalar: any element of a seeds tensor
    dense = ([logits, embed, pos, e_all, fc_w, fc_b, k_cache, v_cache] + ws
             + list(packed))
    if not all(y.is_contiguous() and y.data_ptr() % 16 == 0 for y in dense):
        raise ValueError("kernel F takes contiguous, 16-byte aligned tensors")
    if tokens is None:
        tokens = torch.empty(b, chunk, dtype=torch.long, device=logits.device)
    lib = cuda_build.load("fused_decode")
    fn = lib.mg_decode_loop
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    wptrs = (ctypes.c_void_p * 16)(*[w.data_ptr() for w in ws])
    bf16 = k_cache.dtype == torch.bfloat16
    pptrs = (ctypes.c_void_p * 6)(*[p.data_ptr() for p in packed]) \
        if cluster else None
    rc = fn(int(bf16), nl, logits.data_ptr(),
            tokens.data_ptr(), tokens.stride(0), seed.data_ptr(), wptrs,
            pptrs, embed.data_ptr(), pos.data_ptr(), fc_w.data_ptr(),
            fc_b.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            e_all.data_ptr(), b, chunk, s, d, num_heads, f, v, t0,
            e_all.shape[1], embed_scale(d, k_cache.dtype),
            inv_temperature(temperature), int(greedy), *_mask_args(
                top_k, top_p, v), torch.cuda.current_stream(
                logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode loop kernel failed: CUDA error {rc}")
    fused_decode_loop.launches += 1
    return tokens, logits


fused_decode_loop.launches = 0


def _mask_args(top_k: int, top_p: float, vocab: int) -> tuple:
    """(k, use_p, p) as the kernel takes them: k is 0 unless 0 < top_k <
    V; the top-p threshold max(p, 1e-9) in f32, used only when p < 1."""
    k = int(top_k) if top_k and 0 < top_k < vocab else 0
    return k, int(top_p < 1.0), float(np.float32(max(top_p, 1e-9)))


def loop_sample_kernel(logits: torch.Tensor, seed: torch.Tensor,
                       rows: torch.Tensor, t: torch.Tensor,
                       temperature: float = 1.0, greedy: bool = False,
                       top_k: int = 0, top_p: float = 1.0):
    """Kernel F's sampler alone on the card (``mg_loop_sample``), for
    holding it against ``loop_sample``: logits [N, V] f32 and int64 [N]
    seeds, batch rows and positions -> (tokens [N] int64, masked scaled
    logits [N, V] f32). Not a path of the model; it adds no launch."""
    n, v = logits.shape
    if logits.device.type != "cuda" or logits.dtype != torch.float32:
        raise ValueError("loop_sample_kernel takes f32 CUDA logits")
    if 4 * (2 * v + 64) > SMEM_LIMIT:
        raise ValueError(f"vocab {v} is past the sampler's shared memory")
    args = [y.contiguous() for y in (logits, seed.long(), rows.int(),
                                     t.int())]
    tokens = torch.empty(n, dtype=torch.long, device=logits.device)
    masked = torch.empty_like(logits)
    fn = cuda_build.load("fused_decode").mg_loop_sample
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    rc = fn(args[0].data_ptr(), tokens.data_ptr(), masked.data_ptr(),
            args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(), n, v,
            inv_temperature(temperature), int(greedy),
            *_mask_args(top_k, top_p, v),
            torch.cuda.current_stream(logits.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"loop sampler kernel failed: CUDA error {rc}")
    return tokens, masked
