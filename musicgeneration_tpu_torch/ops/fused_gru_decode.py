"""One stacked-GRU decode step: kernel D and its plain version.

The counterpart of ``musicgeneration_tpu/ops/pallas_gru_decode.py::
fused_gru_step``. ``fused_gru_step`` launches the hand-written CUDA
kernel ``csrc/fused_gru_decode.cu`` for CUDA tensors and runs
``fused_gru_step_plain`` for CPU tensors; there is no other path. Per
layer both compute ``gi = x W_ih^T + b_ih`` and ``gh = h[l] W_hh^T +
b_hh`` with f32 sums rounded to the model dtype, the r/z/n gates and
``h' = (1 - z) n + z h`` in f32, and store ``h'`` in the model dtype as
the next layer's input (pallas_gru_decode.py:52-72).

``pack_gru_weights`` puts a model's ``nn.GRU``-layout parameters into
the kernel's layout once: matrices in the model dtype, each row
zero-padded to a multiple of 8 elements (16-byte rows for the kernel's
vector loads), biases in f32 after a round trip through the model dtype
(the JAX module casts its biases to its dtype). The model's parameters
keep their reference shapes.

Both functions return NEW tensors: ``h_new`` [L, B, H] and ``out`` =
``h_new[-1]`` (a view of it). The inputs are never written.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from . import cuda_build

_DTYPES = (torch.float32, torch.bfloat16)
_ROWS = 8            # the f32 body's batch rows per block (GRU_ROWS)
_SMEM_MAX = 232448   # shared memory a block can have on sm_90
# the bf16 body (gru_layer_tc_kernel): a cluster of _NC CTAs splits K, a
# block takes _NB batch rows; its shared memory (GruSmem) holds 6 weight
# tiles of 16 rows and the x and h rows over one CTA's K range, and the
# cluster's partial sums
_NC, _NB, _UC, _TC_WARPS = 4, 32, 4, 6


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _kr(width: int) -> int:
    """k16 steps of one CTA's K range (gru_kr)."""
    return (-(-width // 16) + _NC - 1) // _NC


def smem_bytes(dtype, in_dim: int, hidden: int) -> int:
    """Dynamic shared memory of kernel D's blocks (mirrors ``gru_tc_smem``
    and the f32 body's staging in csrc/fused_gru_decode.cu)."""
    width = _round8(max(in_dim, hidden))
    if dtype == torch.float32:
        return 4 * _ROWS * (width + _round8(hidden))
    ld_ih = 16 * _kr(width) + 8
    ld_hh = 16 * _kr(_round8(hidden)) + 8
    return (2 * (3 * 16 + _NB) * (ld_ih + ld_hh)
            + 4 * _NC * _TC_WARPS * _UC * _NB)


def pack_gru_weights(layers: Sequence[Tuple[torch.Tensor, ...]],
                     dtype) -> Dict[str, List[torch.Tensor]]:
    """``[(w_ih [3H, in_l], w_hh [3H, H], b_ih [3H], b_hh [3H]), ...]``
    (one tuple per layer, ``nn.GRU`` layout) -> the kernel's packed
    weights: ``w_ih``/``w_hh`` lists of [3H, round_up(width, 8)] matrices
    in ``dtype``, ``b_ih``/``b_hh`` lists of [3H] f32 vectors."""
    packed = {"w_ih": [], "w_hh": [], "b_ih": [], "b_hh": []}
    for w_ih, w_hh, b_ih, b_hh in layers:
        for key, w in (("w_ih", w_ih), ("w_hh", w_hh)):
            rows, width = w.shape
            buf = torch.zeros(rows, _round8(width), dtype=dtype,
                              device=w.device)
            buf[:, :width] = w.detach()
            packed[key].append(buf)
        for key, b in (("b_ih", b_ih), ("b_hh", b_hh)):
            packed[key].append(b.detach().to(dtype).float().contiguous())
    return packed


def fused_gru_step_plain(x: torch.Tensor, h: torch.Tensor,
                         weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D (any device); arguments as
    ``fused_gru_step``."""
    io = h.dtype
    hidden = h.shape[-1]
    inp = x.float()
    new_h = []
    for li in range(h.shape[0]):
        width = inp.shape[-1]
        w_ih = weights["w_ih"][li][:, :width].float()
        w_hh = weights["w_hh"][li][:, :hidden].float()
        gi = (inp @ w_ih.T + weights["b_ih"][li]).to(io).float()
        h_prev = h[li].float()
        gh = (h_prev @ w_hh.T + weights["b_hh"][li]).to(io).float()
        r = torch.sigmoid(gi[:, :hidden] + gh[:, :hidden])
        z = torch.sigmoid(gi[:, hidden:2 * hidden] + gh[:, hidden:2 * hidden])
        n = torch.tanh(gi[:, 2 * hidden:] + r * gh[:, 2 * hidden:])
        h_l = ((1.0 - z) * n + z * h_prev).to(io)
        new_h.append(h_l)
        inp = h_l.float()
    h_new = torch.stack(new_h)
    return h_new[-1], h_new


def _check(x, h, weights):
    if x.dim() != 2 or h.dim() != 3 or h.shape[1] != x.shape[0]:
        raise ValueError(f"x must be [B, in] and h [L, B, H]; got "
                         f"{tuple(x.shape)} and {tuple(h.shape)}")
    nl, b, hidden = h.shape
    if h.dtype not in _DTYPES or x.dtype != h.dtype:
        raise TypeError(f"x and h must share one dtype of {_DTYPES}; got "
                        f"{x.dtype} and {h.dtype}")
    for key in ("w_ih", "w_hh", "b_ih", "b_hh"):
        if len(weights[key]) != nl:
            raise ValueError(f"weights[{key!r}] has {len(weights[key])} "
                             f"layers, h has {nl}")
    for li in range(nl):
        width = x.shape[1] if li == 0 else hidden
        shapes = {"w_ih": (3 * hidden, _round8(width)),
                  "w_hh": (3 * hidden, _round8(hidden)),
                  "b_ih": (3 * hidden,), "b_hh": (3 * hidden,)}
        for key, shape in shapes.items():
            w = weights[key][li]
            want = torch.float32 if key[0] == "b" else h.dtype
            if tuple(w.shape) != shape or w.dtype != want:
                raise ValueError(f"weights[{key!r}][{li}] must be {shape} "
                                 f"{want}; got {tuple(w.shape)} {w.dtype}")
            if w.device != h.device:
                raise ValueError(f"weights[{key!r}][{li}] is on {w.device}, "
                                 f"h on {h.device}")
    if x.device != h.device:
        raise ValueError(f"x is on {x.device}, h on {h.device}")
    return nl, b, hidden


def fused_gru_step(x: torch.Tensor, h: torch.Tensor,
                   weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of an L-layer GRU. x: [B, in] layer-0 input and h:
    [L, B, H] hidden, both in the model dtype (f32 or bf16); weights:
    ``pack_gru_weights``'s dict. Returns (out [B, H], h_new [L, B, H]),
    new tensors (out is ``h_new[-1]``).

    CPU tensors run the plain version. CUDA tensors launch kernel D
    (contiguous x, h and weights; bf16 on the tensor cores, f32 on the
    CUDA cores) or raise. ``launches`` counts its CUDA launches: one per
    layer."""
    nl, b, hidden = _check(x, h, weights)
    if x.device.type == "cpu":
        return fused_gru_step_plain(x, h, weights)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not all(t.is_contiguous() for t in [x, h] + [
            w for key in ("w_ih", "w_hh", "b_ih", "b_hh")
            for w in weights[key]]):
        raise ValueError("kernel D takes contiguous x, h and weights")
    smem = smem_bytes(h.dtype, x.shape[1], hidden)
    if smem > _SMEM_MAX:
        raise ValueError(f"kernel D stages {smem} bytes of shared memory at "
                         f"in={x.shape[1]}, H={hidden}; the card has "
                         f"{_SMEM_MAX}")
    lib = cuda_build.load("fused_gru_decode")
    fn = lib.mg_gru_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.POINTER(ctypes.c_void_p)] * 4
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    h_new = torch.empty_like(h)
    ptrs = [(ctypes.c_void_p * nl)(*[w.data_ptr() for w in weights[key]])
            for key in ("w_ih", "w_hh", "b_ih", "b_hh")]
    rc = fn(int(h.dtype == torch.bfloat16), nl, x.data_ptr(), x.shape[1],
            h.data_ptr(), h_new.data_ptr(), *ptrs, b, hidden,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"GRU step kernel failed: CUDA error {rc}")
    fused_gru_step.launches += nl
    return h_new[-1], h_new


fused_gru_step.launches = 0
