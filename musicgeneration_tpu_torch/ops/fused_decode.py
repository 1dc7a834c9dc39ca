"""Fused decode step and chunk-verify forward through every layer:
kernels B and E and their plain versions.

``fused_decode_step`` is the counterpart of ``musicgeneration_tpu/ops/
pallas_decode.py::fused_decode_step``, ``fused_decode_chunk`` of its
``fused_decode_chunk``. Both launch hand-written CUDA kernels of
``csrc/fused_decode.cu`` for CUDA tensors and run their plain versions
for CPU tensors; there is no other path. Per layer both compute the qkv projections, attention over the
live cache rows [0, t] with the relative bias ``q . E[max_seq-1-t+s]``,
the output projection, residual, post-LN, FFN (ReLU), residual, post-LN,
rounding to the model dtype where ``_layer_step`` does
(pallas_decode.py:131-134, :343-356) and casting P to the cache dtype
before PV (:249).

Ragged mode (continuous-batching serving, pallas_decode.py:1108-1121):
with ``start`` ([B] int32) row b attends only the rows [start[b], t];
``start_min`` <= min(start) is the live-window floor below which no row
attends, so the kernel skips those rows' splits entirely. Any value in
[0, min(start)] gives the same function.

Chunk mode (the verify forward of speculative decoding): C tokens at
positions t..t+C-1; query c attends the rows [0, t+c] with the bias
``q . E[max_seq-1-(t+c)+s]``, which, once the chunk's rows are in the
cache, is the Pallas kernel's "prefix [0, t) + in-chunk causal" split.
It equals C chained decode steps.

Weight-only int8 (``scales``, pallas_decode.py:933-951, :781-824): the
six matrices (``MATRIX_KEYS``) come as int8 from
``quantize_stream_weights`` with one f32 scale per (layer, output
column); each product is the f32 dot of the activations with the int8
values, times the column's scale, then the bias, then the rounding to
the model dtype. Biases, LN and the caches stay in the model dtype. The
TPU took int8 only in its weight-streaming mode (d_model a multiple of
256); here both kernels take it at every width they take.

Both write the new K/V rows into the caches IN PLACE (rows [t, t+C))
and return the same cache tensors; the JAX kernels returned the rows and
their callers wrote them with ``dynamic_update_slice``.

On the card both run three launches a layer over R = B * C rows. In
bf16 (unquantized and int8) they run on the tensor cores
(``csrc/decode_tc.cuh``): the qkv projection spread over column blocks,
one split tile of attention shared by B and E (the queries as the M rows
of ``mma.sync``), and the tail as one thread-block cluster per 16 rows
whose CTAs own column slices of the weights; in f32 they run the
CUDA-core body of ``csrc/fused_decode.cu``. Kernel E equals C chained
kernel-B steps bit for bit in both.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .relative_attention import relative_chunk_bias

# keys of the stacked weights dict, in kernel argument order; matrices
# are [L, in, out] (the flax kernel layout), vectors [L, n]
WEIGHT_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wfc", "bfc",
               "ln1_scale", "ln1_bias", "ffn1_w", "ffn1_b",
               "ffn2_w", "ffn2_b", "ln2_scale", "ln2_bias")
# the six matrices weight-only int8 quantizes (pallas_decode.py:930)
MATRIX_KEYS = ("wq", "wk", "wv", "wfc", "ffn1_w", "ffn2_w")
_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 1024     # kernel B's shared-memory budget for d_model
MAX_FFN = 4096   # and for the FFN width
MAX_CHUNK = 128  # kernel E's largest chunk (its shared-memory budget)


def _layer_norm(y, scale, bias, eps):
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * scale + bias


def quantize_stream_weights(weights):
    """Weight-only int8 (pallas_decode.py::quantize_stream_weights): per
    (layer, output column) symmetric scales s = max(max |w| / 127, 1e-12)
    over the input dimension, in f32, and q = clip(round(w / s), -127,
    127) as int8, for the six ``MATRIX_KEYS`` of the stacked weights as
    given (the model dtype, upcast to f32). Returns (qweights: the dict
    with those six replaced, the vectors as they were; scales: {key: [L,
    d_out] f32}). ``torch.round`` rounds half to even as ``jnp.round``."""
    q = dict(weights)
    scales = {}
    for k in MATRIX_KEYS:
        w = weights[k].float()                                # [L, in, out]
        s = (w.abs().amax(dim=1) / 127.0).clamp_min(1e-12)     # [L, out]
        q[k] = torch.round(w / s[:, None, :]).clamp(-127, 127).to(
            torch.int8).contiguous()
        scales[k] = s.contiguous()
    return q, scales


def _layer_weights(weights, scales, li: int):
    """Layer li's weights in f32 and its product ``mm(inp, key)``: inp @
    w[key], times the output columns' scales where the matrix is int8."""
    w = {key: weights[key][li].float() for key in WEIGHT_KEYS}
    if scales is None:
        return w, lambda inp, key: inp @ w[key]
    sc = {key: scales[key][li] for key in MATRIX_KEYS}
    return w, lambda inp, key: (inp @ w[key]) * sc[key]


def fused_decode_step_plain(x, t: int, e_all, weights, k_cache, v_cache,
                            num_heads: int, start=None, start_min=None,
                            scales=None, eps: float = 1e-6):
    """Plain PyTorch version of kernel B (any device). With ``start`` it
    reads ``start`` back to assert ``start_min <= min(start)`` and
    ``max(start) <= t``, which the kernel trusts its caller for. With
    ``scales`` the six matrices are int8 (``quantize_stream_weights``)."""
    b, d = x.shape
    dh = d // num_heads
    max_seq = e_all.shape[1]
    io, cd = x.dtype, k_cache.dtype
    scale = 1.0 / math.sqrt(dh)
    lo = _start_min(start, start_min, t)
    if start is not None:
        lo_row, hi_row = int(start.min()), int(start.max())
        if not lo <= lo_row <= hi_row <= t:
            raise ValueError(f"need start_min ({lo}) <= start (min "
                             f"{lo_row}, max {hi_row}) <= t ({t})")
        # [B, 1, s]: the rows below each row's start take no weight
        masked = (torch.arange(lo, t + 1, device=x.device)[None, None]
                  < start.to(x.device, torch.long)[:, None, None])

    def rnd(y, dtype=io):
        return y.to(dtype).float()

    h = x.float()
    for li in range(k_cache.shape[0]):
        w, mm = _layer_weights(weights, scales, li)
        q = rnd(mm(h, "wq") + w["bq"])
        k_new = rnd(mm(h, "wk") + w["bk"])
        v_new = rnd(mm(h, "wv") + w["bv"])
        k_cache[li, :, t] = k_new.to(cd)
        v_cache[li, :, t] = v_new.to(cd)
        n = t + 1 - lo
        keys = k_cache[li, :, lo:t + 1].float().view(b, n, num_heads, dh)
        vals = v_cache[li, :, lo:t + 1].float().view(b, n, num_heads, dh)
        qh = q.view(b, num_heads, dh)
        e_rows = e_all[li, max_seq - 1 - t + lo:max_seq].float()  # s = lo..t
        logits = (torch.einsum("bhd,bshd->bhs", qh, keys)
                  + torch.einsum("bhd,sd->bhs", qh, e_rows)) * scale
        if start is not None:
            logits = logits.masked_fill(masked, float("-inf"))
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        lsum = p.sum(-1, keepdim=True).clamp_min(1e-30)
        attn = torch.einsum("bhs,bshd->bhd", rnd(p, cd), vals) / lsum
        h = _tail(attn.reshape(b, d), h, w, mm, io, eps)
    return h.to(io), k_cache, v_cache


def _tail(attn, h, w, mm, io, eps):
    """The layer after attention, with the TPU kernels' rounding points
    (pallas_decode.py:343-356, :610-621): attn, the output projection,
    out1, the FFN hidden layer and output and the layer output go to the
    model dtype ``io``. attn, h: [R, d] f32; ``mm``: the layer's product
    (``_layer_weights``)."""
    def rnd(y):
        return y.to(io).float()

    attn = rnd(mm(rnd(attn), "wfc") + w["bfc"])
    out1 = rnd(_layer_norm(attn + h, w["ln1_scale"], w["ln1_bias"], eps))
    hid = torch.relu(rnd(mm(out1, "ffn1_w") + w["ffn1_b"]))
    ffn = rnd(mm(hid, "ffn2_w") + w["ffn2_b"])
    return rnd(_layer_norm(out1 + ffn, w["ln2_scale"], w["ln2_bias"], eps))


def fused_decode_chunk_plain(x, t: int, e_all, weights, k_cache, v_cache,
                             num_heads: int, scales=None, eps: float = 1e-6):
    """Plain PyTorch version of kernel E (any device): x [B, C, d] at
    positions t..t+C-1 -> (out [B, C, d], k_cache, v_cache), the caches
    written in place at rows [t, t+C). Rounds where _layer_chunk_step
    does (pallas_decode.py:434-442, :534, :599, :610-621). ``scales`` as
    ``fused_decode_step_plain``."""
    b, c, d = x.shape
    dh = d // num_heads
    io, cd = x.dtype, k_cache.dtype
    scale = 1.0 / math.sqrt(dh)
    n = t + c
    # [C, n]: query c (position t + c) sees the rows s <= t + c
    future = (torch.arange(n, device=x.device)[None, :]
              > t + torch.arange(c, device=x.device)[:, None])

    def rnd(y, dtype=io):
        return y.to(dtype).float()

    h = x.reshape(b * c, d).float()
    for li in range(k_cache.shape[0]):
        w, mm = _layer_weights(weights, scales, li)
        q = rnd(mm(h, "wq") + w["bq"])
        k_cache[li, :, t:n] = rnd(mm(h, "wk") + w["bk"]).view(b, c, d).to(cd)
        v_cache[li, :, t:n] = rnd(mm(h, "wv") + w["bv"]).view(b, c, d).to(cd)
        keys = k_cache[li, :, :n].float().view(b, n, num_heads, dh)
        vals = v_cache[li, :, :n].float().view(b, n, num_heads, dh)
        qh = q.view(b, c, num_heads, dh).transpose(1, 2)       # [B, H, C, dh]
        logits = (torch.einsum("bhcd,bshd->bhcs", qh, keys)
                  + relative_chunk_bias(qh, e_all[li], t, n)) * scale
        logits = logits.masked_fill(future, float("-inf"))
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        lsum = p.sum(-1, keepdim=True).clamp_min(1e-30)
        attn = torch.einsum("bhcs,bshd->bhcd", rnd(p, cd), vals) / lsum
        h = _tail(attn.transpose(1, 2).reshape(b * c, d), h, w, mm, io, eps)
    return h.view(b, c, d).to(io), k_cache, v_cache


def _start_min(start, start_min, t: int) -> int:
    """The first cache row any batch row attends: ``start_min``, or 0."""
    if start_min is None:
        return 0
    if start is None:
        raise ValueError("start_min requires start (ragged decode)")
    if not 0 <= start_min <= t:
        raise ValueError(f"start_min {start_min} outside [0, t={t}]")
    return int(start_min)


def _check(x, t, e_all, weights, k_cache, v_cache, num_heads, start,
           scales):
    cuda_build.refuse_dtensors("the fused decode", x, e_all, weights,
                               k_cache, v_cache, start, scales)
    if x.dim() != 2:
        raise ValueError(f"x must be [B, d]; got {tuple(x.shape)}")
    b, d = x.shape
    if d % num_heads:
        raise ValueError(f"d_model {d} not divisible by {num_heads} heads")
    dh = d // num_heads
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError("caches must share one [L, B, S, d] shape")
    nl, cb, s, cd = k_cache.shape
    if (cb, cd) != (b, d):
        raise ValueError(f"cache {tuple(k_cache.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES or k_cache.dtype != x.dtype \
            or v_cache.dtype != x.dtype:
        raise TypeError(f"x and the caches must share one dtype of "
                        f"{_DTYPES}")
    if e_all.dim() != 3 or e_all.shape[0] != nl or e_all.shape[2] != dh \
            or e_all.dtype != torch.float32:
        raise ValueError(f"e_all must be [{nl}, max_seq, {dh}] float32; "
                         f"got {tuple(e_all.shape)} {e_all.dtype}")
    if not 0 <= t < min(s, e_all.shape[1]):
        raise ValueError(f"position t={t} outside the cache ({s}) or the "
                         f"relative table ({e_all.shape[1]})")
    f = weights["ffn1_w"].shape[-1]
    shapes = {"wq": (d, d), "bq": (d,), "wk": (d, d), "bk": (d,),
              "wv": (d, d), "bv": (d,), "wfc": (d, d), "bfc": (d,),
              "ln1_scale": (d,), "ln1_bias": (d,), "ffn1_w": (d, f),
              "ffn1_b": (f,), "ffn2_w": (f, d), "ffn2_b": (d,),
              "ln2_scale": (d,), "ln2_bias": (d,)}
    int8 = weights["wq"].dtype == torch.int8
    if int8 and scales is None:
        raise ValueError("int8 weights need their scales dict "
                         "(quantize_stream_weights)")
    if scales is not None and not int8:
        raise ValueError("scales are for int8 weights "
                         "(quantize_stream_weights); got "
                         f"{weights['wq'].dtype} weights")
    for key in WEIGHT_KEYS:
        w = weights[key]
        if tuple(w.shape) != (nl,) + shapes[key]:
            raise ValueError(f"weights[{key!r}] must be "
                             f"{(nl,) + shapes[key]}; got {tuple(w.shape)}")
        dtype = torch.int8 if int8 and key in MATRIX_KEYS else x.dtype
        if w.dtype != dtype or w.device != x.device:
            raise TypeError(f"weights[{key!r}] must be {dtype} on "
                            f"{x.device}; got {w.dtype} on {w.device}")
    if scales is not None:
        if sorted(scales) != sorted(MATRIX_KEYS):
            raise ValueError(f"scales must hold {MATRIX_KEYS}; got "
                             f"{tuple(sorted(scales))}")
        for key in MATRIX_KEYS:
            sc, want = scales[key], (nl, shapes[key][1])
            if (tuple(sc.shape) != want or sc.dtype != torch.float32
                    or sc.device != x.device):
                raise ValueError(f"scales[{key!r}] must be {want} float32 "
                                 f"on {x.device}; got {tuple(sc.shape)} "
                                 f"{sc.dtype} {sc.device}")
    if any(y.device != x.device for y in (e_all, k_cache, v_cache)):
        raise ValueError("x, e_all and the caches must be on one device")
    if start is not None and (tuple(start.shape) != (b,)
                              or start.dtype != torch.int32
                              or start.device != x.device):
        raise ValueError(f"start must be [{b}] int32 on {x.device}; got "
                         f"{tuple(start.shape)} {start.dtype} "
                         f"{start.device}")
    return nl, b, s, d, dh, f


def _kernel_inputs(kernel: str, x, dh: int, d: int, f: int, weights,
                   scales, tensors):
    """Raise unless kernel B or E takes these inputs on the card; return
    the 16 weight pointers in ``WEIGHT_KEYS`` order and the six scale
    pointers in ``MATRIX_KEYS`` order (None without int8)."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if dh != 64 or d > MAX_D or f > MAX_FFN:
        raise ValueError(f"kernel {kernel} takes dh = 64, d <= {MAX_D} and "
                         f"FFN <= {MAX_FFN}; got dh={dh}, d={d}, FFN={f}")
    ws = [weights[k] for k in WEIGHT_KEYS]
    ss = [] if scales is None else [scales[k] for k in MATRIX_KEYS]
    if not all(y.is_contiguous() for y in tensors + ws + ss):
        raise ValueError(f"kernel {kernel} takes contiguous tensors")
    wptrs = (ctypes.c_void_p * 16)(*[w.data_ptr() for w in ws])
    sptrs = None if scales is None else (ctypes.c_void_p * 6)(
        *[y.data_ptr() for y in ss])
    return wptrs, sptrs


def fused_decode_step(x: torch.Tensor, t: int, e_all: torch.Tensor,
                      weights, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      num_heads: int, start: torch.Tensor = None,
                      start_min: int = None, scales=None):
    """All-layers decode step. x: [B, d] (embedded + positioned) in the
    model dtype; t: int position; e_all: [L, max_seq, dh] float32;
    weights: dict of stacked [L, ...] arrays (``WEIGHT_KEYS``, model
    dtype); k_cache/v_cache: [L, B, S, d] in the model dtype. Returns
    (out [B, d], k_cache, v_cache), the caches updated in place at row t.

    start: optional [B] int32 on x's device, each row's first live cache
    row (<= t); start_min: optional int <= min(start), requires start.
    The wrapper does not read ``start`` back (that would sync the host
    every step): the caller guarantees both bounds.

    scales: optional {key: [L, d_out] f32} of ``MATRIX_KEYS``, from
    ``quantize_stream_weights``: the six matrices of ``weights`` are then
    int8 (weight-only int8); int8 weights without it raise.

    CPU tensors run the plain version. CUDA tensors launch kernel B
    (dh = 64, d <= 1024, FFN <= 4096, contiguous inputs) or raise.
    ``launches`` counts its CUDA launches with model-dtype weights,
    ``int8_launches`` those with int8 weights: three per layer."""
    nl, b, s, d, dh, f = _check(x, t, e_all, weights, k_cache, v_cache,
                                num_heads, start, scales)
    lo = _start_min(start, start_min, t)
    if x.device.type == "cpu":
        return fused_decode_step_plain(x, t, e_all, weights, k_cache,
                                       v_cache, num_heads, start, start_min,
                                       scales)
    wptrs, sptrs = _kernel_inputs("B", x, dh, d, f, weights, scales,
                                  [x, e_all, k_cache, v_cache]
                                  + ([] if start is None else [start]))
    lib = cuda_build.load("fused_decode")
    fn = lib.mg_decode_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    xbuf = x.to(torch.float32, copy=True)  # the kernel overwrites it
    qbuf = torch.empty(b, d, dtype=torch.float32, device=x.device)
    split0 = lo // 128  # the attention's 128-row splits below it are skipped
    nsplit = (t + 1 + 127) // 128 - split0
    part = torch.empty(b * num_heads, nsplit, dh + 2, dtype=torch.float32,
                       device=x.device)
    rc = fn(int(x.dtype == torch.bfloat16), nl, xbuf.data_ptr(),
            qbuf.data_ptr(), part.data_ptr(), wptrs, sptrs,
            k_cache.data_ptr(), v_cache.data_ptr(), e_all.data_ptr(),
            start.data_ptr() if start is not None else None, b, s, d,
            num_heads, f, t, e_all.shape[1], split0,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode step kernel failed: CUDA error {rc}")
    if scales is None:
        fused_decode_step.launches += 3 * nl
    else:
        fused_decode_step.int8_launches += 3 * nl
    return xbuf.to(x.dtype), k_cache, v_cache


fused_decode_step.launches = 0
fused_decode_step.int8_launches = 0


def fused_decode_chunk(x: torch.Tensor, t: int, e_all: torch.Tensor,
                       weights, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, num_heads: int, scales=None):
    """All-layers chunk-verify forward. x: [B, C, d] (embedded +
    positioned, position t + c in row c) in the model dtype, 2 <= C <=
    128; t: int, t + C <= the cache length and max_seq; the other
    arguments (``scales`` too) as ``fused_decode_step``. Returns (out
    [B, C, d], k_cache, v_cache), the caches written in place at rows
    [t, t+C).

    CPU tensors run the plain version. CUDA tensors launch kernel E
    (dh = 64, d <= 1024, FFN <= 4096, contiguous inputs) or raise; the
    wrapper never reads a tensor back. ``launches`` and
    ``int8_launches`` count its CUDA launches as ``fused_decode_step``'s
    do: three per layer."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, d]; got {tuple(x.shape)}")
    b, c, _ = x.shape
    if not 2 <= c <= MAX_CHUNK:
        raise ValueError(f"chunk C={c} outside [2, {MAX_CHUNK}]")
    nl, b, s, d, dh, f = _check(x[:, 0], t, e_all, weights, k_cache,
                                v_cache, num_heads, None, scales)
    if t + c > min(s, e_all.shape[1]):
        raise ValueError(f"rows [{t}, {t + c}) pass the cache ({s}) or the "
                         f"relative table ({e_all.shape[1]})")
    if x.device.type == "cpu":
        return fused_decode_chunk_plain(x, t, e_all, weights, k_cache,
                                        v_cache, num_heads, scales)
    wptrs, sptrs = _kernel_inputs("E", x, dh, d, f, weights, scales,
                                  [e_all, k_cache, v_cache])
    lib = cuda_build.load("fused_decode")
    fn = lib.mg_decode_chunk
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.POINTER(ctypes.c_void_p)] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    # the kernel overwrites its input rows
    xbuf = x.reshape(b * c, d).to(torch.float32, copy=True)
    qbuf = torch.empty(b * c, d, dtype=torch.float32, device=x.device)
    nsplit = (t + c + 127) // 128
    part = torch.empty(b * c * num_heads, nsplit, dh + 2,
                       dtype=torch.float32, device=x.device)
    rc = fn(int(x.dtype == torch.bfloat16), nl, xbuf.data_ptr(),
            qbuf.data_ptr(), part.data_ptr(), wptrs, sptrs,
            k_cache.data_ptr(), v_cache.data_ptr(), e_all.data_ptr(), b, c,
            s, d, num_heads, f, t, e_all.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunk-verify kernel failed: CUDA error {rc}")
    if scales is None:
        fused_decode_chunk.launches += 3 * nl
    else:
        fused_decode_chunk.int8_launches += 3 * nl
    return xbuf.view(b, c, d).to(x.dtype), k_cache, v_cache


fused_decode_chunk.launches = 0
fused_decode_chunk.int8_launches = 0
