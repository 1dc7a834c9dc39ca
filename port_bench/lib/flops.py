"""Operation and byte counts of the kernels and steps the benchmark
reads, and the card's published peaks.

Copied from the repository's own arithmetic, so that it stays fixed
under the benchmark: ``bench.py::train_step_flops`` (causal attention
halved; its TPU peak is not carried over) and ``chip_smoke.py``'s
``bound`` rule (each input read once, each output written once, the
least time the larger of bytes over HBM bandwidth and operations over
the bf16 peak), with the launch shapes of kernels A and C
(``shard_attn_bound``) and kernel D (``gru_bound``).
"""

from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16"
            ) -> Tuple[float, str]:
    """Least seconds of a launch and what bounds it ("bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_step_flops(batch: int, seq: int, d: int, n_layers: int,
                     vocab: int, ffn_dim: int = 0) -> float:
    """Analytic MusicTransformer train-step FLOPs (2 per MAC, the step
    3x the forward): per layer the q, k, v and out projections, the two
    FFN matmuls and the causal QK^T, QE^T and PV terms, plus the head."""
    ffn = ffn_dim or d // 2
    per_layer = (4 * 2 * batch * seq * d * d
                 + 2 * 2 * batch * seq * d * ffn
                 + 3 * batch * seq * seq * d)
    head = 2 * batch * seq * d * vocab
    return 3 * (n_layers * per_layer + head)


def attn_fwd_cost(b: int, h: int, l: int, dh: int, elem: int = 2
                  ) -> Tuple[float, float]:
    """Kernel A, causal, no key_pad: q, k, v read and out written in the
    compute dtype, the E rows used (f32) read, the LSE (f32) written;
    three 64-deep products (q.k, q.E, p.v) per causal (t, s <= t)."""
    bh = b * h
    nbytes = 4 * bh * l * dh * elem + l * dh * 4 + bh * l * 4
    flops = 3 * 2 * dh * bh * l * (l + 1) / 2
    return nbytes, flops


def attn_bwd_cost(b: int, h: int, l: int, dh: int, elem: int = 2
                  ) -> Tuple[float, float]:
    """Kernel C (prep, dq + dkv and dE launches together): q, k, v, O, dO
    read and dQ, dK, dV written in the compute dtype, the LSE (f32)
    read, E read and dE written (f32); eight 64-deep products per causal
    pair (the recomputed q.k and q.E, dO.v, and the dV, dK, dQ's two legs
    and dE sums)."""
    bh = b * h
    nbytes = 8 * bh * l * dh * elem + bh * l * 4 + 2 * l * dh * 4
    flops = 8 * 2 * dh * bh * l * (l + 1) / 2
    return nbytes, flops


def gru_step_cost(b: int, in_dim: int, hidden: int, layers: int,
                  elem: int = 2) -> Tuple[float, float]:
    """One GRU decode step of every layer (kernel D, one launch a layer):
    the weights (rows of their true width) read in the compute dtype, the
    f32 biases, x and h read and the new h written; 2 * b * 3H * (in_l +
    H) operations a layer."""
    widths = [in_dim] + [hidden] * (layers - 1)
    w_elems = sum(3 * hidden * (w + hidden) for w in widths)
    nbytes = (w_elems * elem + 2 * layers * 3 * hidden * 4 + b * in_dim * elem
              + 2 * layers * b * hidden * elem)
    flops = sum(2 * b * 3 * hidden * (w + hidden) for w in widths)
    return nbytes, flops
