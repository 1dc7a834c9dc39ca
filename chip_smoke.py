"""Drive the PyTorch/CUDA port's generation (step by step and through
the decode loop), speculative decoding, serving and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first failure raises and the exit code is non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the hand-written kernels from ``musicgeneration_tpu_torch/csrc``
   (one ``nvcc`` per source, started together; kernels B and E share
   ``fused_decode.cu``) and print each kernel's ptxas line;
3. kernel A (relative attention, prefill) against its plain PyTorch
   version at B8 H4 L512 dh64 max_seq 2048, f32 (TF32 off) and bf16,
   with and without key padding, non-causal, and at L 100 (a ragged
   tile, as short prompts give);
4. kernel B (fused decode step) against its plain version at the
   flagship width (6 layers, d 256, B 8, cache 1024) for several t,
   f32 and bf16, and at B 1 and B 3; then kernel C (relative attention
   backward) against its plain backward at B8 H4 L512 dh64, max_seq 512
   (training) and 2048, f32 (TF32 off) and bf16, causal and not, with
   and without key padding, and at L 100; kernel E (the chunk-verify
   forward) against its plain version at the flagship width, f32 and
   bf16, B 1, 4 and 8, C 2, 5, 8 and 64, t 1, across the 128-row split,
   755 and max_seq - C, the cache rows outside [t, t+C) unchanged; then
   one kernel-E call against C chained kernel-B steps (outputs and
   caches); kernel F (the decode loop: C whole sampling-and-decode steps
   per launch) against its plain version, greedy in f32 and bf16 at B 1
   and 8, C 1, 7 and 32, t0 1, 127, 128, 755 and 2047 - C (a bf16 row may
   part only at a near tie, which is printed), and sampled in f32 with
   fixed seeds (T 1; T 0.9 top-k 20; top-p 0.9), the cache rows outside
   [t0, t0+C) unchanged;
5. end to end at full width (vocab 309, 6 layers, d 256, max_seq 2048,
   seeded random weights) through the user's entry point: the weights
   saved as a .pth, a prime MIDI written, ``cli.generate`` run on them
   (B 8, prime 500 tokens bucketed to 512, 512 sampled bf16 tokens,
   8 MIDI files written and read back) with the launch counters of both
   kernels read around it; the same generation timed through
   ``decode.generate``; then greedy in f32 for 64 tokens, where the
   kernel path's tokens must equal the plain path's; the decode loop:
   kernel F's sampler alone against the plain sampler bit for bit (V 309
   with ties, V 384 padded, V 4096), chi2 < 52 of 64 x 64 first-token
   draws through ``decode.generate(use_loop_kernel=True)`` in three
   modes, the same generation as above through the loop (exactly 6 A,
   16 F and 0 B launches), greedy f32 loop path == step path at 64 and
   70 tokens, and B 8 bf16 tokens/s of the step and loop paths
   interleaved;
6. training at full width (vocab 309, 6 layers, d 256, 4 heads, FFN 128,
   max_seq = seq_len 512, B 8): synthetic MIDI files written with the
   port's MIDI writer and tokenized by ``cli.tokenize``; one f32 train
   step (dropout 0) through kernels A and C against one through their
   plain versions (loss, grad norm, Adam moments, parameters); ``cli.train``
   in bf16 with dropout 0.1 for 30 steps, checkpointing every 10, with the
   launch counters of kernels A and C read around it and every loss
   finite; the same run interrupted at step 20 and resumed (it must start
   at batch 20 and repeat the uninterrupted losses); ``cli.generate`` from
   the checkpoint directory;
7. serving at full width through ``cli.serve``: kernel B's ragged mode
   (per-row ``start``, ``start_min`` 0 and min(start)) against its plain
   version in f32 and bf16; ``cli.serve`` in file mode with its defaults
   (8 slots, segments of 64, depth 2) on 24 requests (prompts of 1-500
   tokens from the prime MIDI, 64-768 new tokens, four with eos, four
   with their own sampling, one sliding window of 256 for 2,560 tokens)
   in bf16, every MIDI read back and the launch counters of kernels A
   and B read around it (6 per admission, 18 per decode step); greedy
   f32 serving of 8 staggered requests through the kernels against the
   plain versions, token for token; HTTP mode on an ephemeral port
   (``/generate``, ``/stream``, ``/cancel``);
8. speculative decoding at full width through ``cli.generate --spec``
   (bf16, the 500-token prime, 512 sampled tokens, ``--spec-chunk 8``):
   lookup at B 1 and B 4, a seeded random 2-layer d_model 128 draft
   checkpoint, the target as its own draft, with the launch counters of
   kernels A, E and B read around each run and checked exactly (A: one
   prefill of the target and one of the draft; E: 18 per verify forward;
   B: 8 x 3 x the draft's layers per verify forward) and every MIDI read
   back; greedy f32 speculation against greedy f32 ``decode.generate``
   token for token (lookup at B 1 and B 3; self-draft, every proposal
   accepted); B 1 bf16 greedy tokens/s of plain, lookup and self-draft
   runs interleaved;
9. timings at the main paths' shapes: each kernel, its plain version, its
   bound and, where one PyTorch call computes the same function,
   ``F.scaled_dot_product_attention`` with the relative bias materialized
   as ``attn_mask`` (forward for kernel A, forward + backward for kernel
   C); ragged kernel B at t 1023 with a live window of 256, under
   ``start_min`` 0 and min(start); the bf16 train step over 25 warm
   steps (CUDA events) and a ``torch.profiler`` window over 5 of them;
   ``torch.profiler`` windows over 32 bf16 decode steps, over one
   serving segment and over 8 verify iterations of lookup and of
   self-draft speculation (device time by kernel, the device's busy
   share); kernel E at C 8, t 755, B 1 and B 8 beside its plain version,
   its bound and one kernel-B step; kernel F at C 32, t0 755, B 8 and
   B 1 beside its plain version and its bound, and a ``torch.profiler``
   window over the loop path's 16 chunks;
10. the GRU families (EventMelodyRNN 308/32/512/3, PerformanceRNN with 24
   controls; seeded random weights saved in the reference formats, a
   bare state dict and a session dict): kernel D (the stacked-GRU step)
   against its plain version at in 308 and 512, H 512, 3 layers, B 1,
   4, 8 and 64, f32 and bf16, and at in 32, H 32, 2 layers (run with the
   other kernel checks); ``cli.generate`` for each family (B 8, the
   prime's first 500 tokens, 512 sampled bf16 tokens, PerformanceRNN
   under ``--control``; then ``--beam 4`` and ``--stochastic-beam`` at
   B 1) with kernel D's launches exactly L x the decode steps and every
   MIDI read back; decode tokens/s at B 8; greedy f32 generation and
   greedy f32 serving of 8 staggered requests, kernel path == plain
   path; ``cli.serve`` file mode with its defaults (8 slots, segments of
   64, depth 2, boost 8) on 24 requests (prompts of 1-500 tokens, 64-768
   new, eos, own sampling, ``init_seed``, PerformanceRNN control rows)
   with exact launches; kernel D's device time warm and with L2 flushed
   at B 8 and B 1, its plain version, its bound, ``torch.nn.GRU``
   (cuDNN) over one step; a ``torch.profiler`` window over 32 decode
   steps;
11. weight-only int8 decode (``decode_quant="int8"``): the int8 modes of
   kernels B (non-ragged at t 755, ragged at t 1023 with ``start_min``)
   and E (C 8, B 1 and 8) against their plain int8 versions at the
   flagship's shapes, f32 and bf16, kernel E against C chained int8
   kernel-B steps bit for bit, each within 3e-2 relative of the
   unquantized kernel, int8 weights without scales refused; kernel B at
   the d 1024 rung (bench.py:455-464: 16 heads, FFN 512), unquantized
   and int8, against its plain version; greedy f32 on an int8 model,
   kernel path == plain path, for ``decode.generate`` and serving of 8
   staggered requests, and lookup speculation at B 1 == ``generate``;
   ``cli.generate --quant int8`` (bf16, B 8, the 500-token prime, 512
   sampled tokens: exactly 18 int8 kernel-B launches per decode step)
   and ``--spec lookup --quant int8`` (exactly 18 int8 kernel-E launches
   per verify forward); device times of the int8 modes beside the
   unquantized kernels, their plain versions and bounds (the flagship
   and the d 1024 rung); decode tokens/s int8 against unquantized at
   both widths (B 8, a 16-token prompt, 512 tokens, cache 1024);
12. one JSON line of kernels, the card's line, and the final JSON line.

Imports nothing of JAX or of ``musicgeneration_tpu``. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(1)

from musicgeneration_tpu_torch.cli.generate import (  # noqa: E402
    bucket_prompt, parse_control, prime_tokens, write_midi)
from musicgeneration_tpu_torch.cli import train as train_cli  # noqa: E402
from musicgeneration_tpu_torch.cli.generate import main as cli_main  # noqa: E402
from musicgeneration_tpu_torch.cli.serve import main as serve_main  # noqa: E402
from musicgeneration_tpu_torch.cli.tokenize import (  # noqa: E402
    main as tokenize_main)
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus  # noqa: E402
from musicgeneration_tpu_torch.decode import (  # noqa: E402
    DecodeParams, SamplingParams, SpecParams, generate, generate_speculative)
from musicgeneration_tpu_torch.decode.serving import (  # noqa: E402
    ContinuousBatcher)
from musicgeneration_tpu_torch.decode.serving_rnn import (  # noqa: E402
    RNNContinuousBatcher)
from musicgeneration_tpu_torch.models import music_transformer as mt  # noqa: E402
from musicgeneration_tpu_torch.models import (  # noqa: E402
    EventMelodyRNN, PerformanceRNN)
from musicgeneration_tpu_torch.ops import gru as gru_mod  # noqa: E402
from musicgeneration_tpu_torch.ops import cuda_build  # noqa: E402
from musicgeneration_tpu_torch.ops.decode_loop import (  # noqa: E402
    fused_decode_loop, fused_decode_loop_plain, gumbel, inv_temperature,
    loop_bits, loop_sample, loop_sample_kernel, sample_mask)
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention, fused_relative_attention_bwd,
    fused_relative_attention_bwd_plain, fused_relative_attention_plain)
from musicgeneration_tpu_torch.ops.fused_decode import (  # noqa: E402
    fused_decode_chunk, fused_decode_chunk_plain, fused_decode_step,
    fused_decode_step_plain)
from musicgeneration_tpu_torch.ops.fused_gru_decode import (  # noqa: E402
    fused_gru_step, fused_gru_step_plain, pack_gru_weights)
from musicgeneration_tpu_torch.tokenizers import midilike  # noqa: E402
from musicgeneration_tpu_torch.train.trainer import (  # noqa: E402
    create_train_state, make_optimizer, make_train_step)
from musicgeneration_tpu_torch.utils.checkpoint import (  # noqa: E402
    list_checkpoints)
from musicgeneration_tpu_torch.utils.config import apply_overrides  # noqa: E402

DEV = torch.device("cuda")
# scratch files (checkpoint, prime, MIDI) go under the git-ignored build
# directory of the checkout
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "musicgeneration_tpu_torch", "_build")
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core / f32 FLOP/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# stated tolerances (max abs error, kernel vs plain on the same inputs):
# f32 differs only in summation order; bf16 also rounds P against a
# running (kernel) vs final (plain) max and rounds every intermediate,
# so an output may differ by a few bf16 ulps
TOL_A = {torch.float32: 1e-4, torch.bfloat16: 3.2e-2}
TOL_B = {torch.float32: 1e-4, torch.bfloat16: 1.25e-1}
# kernel C, max |kernel - plain| / max |plain| for each of dq, dk, dv, dE
# (dE sums B*H*L^2 terms, so its error is stated relative to its size):
# f32 differs in summation order only; in bf16 both round g and p to
# bf16, and logits that differ in the last f32 bit can flip a rounding,
# so a few bf16 ulps (2^-8 relative each) of the largest gradient
TOL_C = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# train-step parity (f32): Adam moments within this fraction of each
# tensor's largest entry (plus 1e-6 of the largest over all tensors: the
# K-projection bias has a zero gradient in exact arithmetic)
TOL_MOMENT = 1e-3
# main-path shapes
B, H, DH, L_PREFILL, MAX_SEQ = 8, 4, 64, 512, 2048
L_TRAIN = 512  # cli.train's seq_len: the training model's max_seq
N_MIDI, TRAIN_STEPS, CKPT_EVERY, CUT, PROFILE_STEPS = 16, 30, 10, 20, 5
GEN_PRIME, GEN_STEPS = 100, 256  # generation from the trained checkpoint
N_LAYERS, D_MODEL, VOCAB = 6, 256, 309
PROMPT, STEPS, GREEDY_STEPS = 500, 512, 64
T_TIMED = PROMPT + STEPS // 2 - 1  # mid-run decode position
# serving: cli.serve's defaults, prompt lengths cut from the prime MIDI
SLOTS, SEG, DEPTH = 8, 64, 2
SERVE_PROMPTS = (1, 3, 64, 200, 500)
N_SERVE, SERVE_WINDOW, WINDOW_NEW = 24, 256, 2560
T_RAGGED, LIVE = 1023, 256  # ragged timing: t, live window of the rows
# the GRU families at the reference's full width: EventMelodyRNN 308/32/
# 512/3, PerformanceRNN with 24 controls (event_rnn.py:44-49,
# performance_rnn.py:45-49)
EVENT_DIM, INIT_DIM, RNN_HIDDEN, RNN_LAYERS, CONTROL_DIM = 308, 32, 512, 3, 24
# kernel D vs plain, max abs: f32 differs in summation order only; bf16
# rounds gi and gh to bf16, where sums that differ in the last f32 bit
# can flip a rounding, and the layer outputs are bf16 (one ulp of a
# value near 1 is 2^-7)
TOL_D = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
RNN_PROMPT, RNN_STEPS, RNN_GREEDY, BEAM, RNN_BOOST = 500, 512, 64, 4, 8
# speculative decoding: cli.generate --spec-chunk 8 on the 500-token
# prime, 512 new tokens; the draft checkpoint is a seeded random 2-layer
# d_model 128 MusicTransformer (dh 64, as kernel B takes)
SPEC_CHUNK, DRAFT_LAYERS, DRAFT_D = 8, 2, 128
SPEC_GREEDY, SPEC_ROUNDS, SPEC_PROFILE = 128, 3, 8
# kernel E's check: C of 2-64 at B 1, 4, 8 (2 to 128 are taken)
CHUNKS, CHUNK_BATCHES = (2, 5, 8, 64), (1, 4, 8)
PERF_CONTROL = "2,0,1,1,0,1,0,1,1,0,0,1;4"
# the decode loop (kernel F): chunk 32 on the main path; its check takes
# C 1, 7, 32 at B 1 and 8; the distribution check draws 64 rows x 64
# seeds of first tokens and holds them to chi2 < 52 (tests/
# test_tpu_sampling.py's statistic); the loop/step rates take 3 rounds
LOOP_CHUNK, LOOP_CHUNKS, LOOP_GREEDY_LONG = 32, (1, 7, 32), 70
DIST_ROWS, DIST_SEEDS, CHI2_CRIT, LOOP_ROUNDS = 64, 64, 52.0, 3
LOOP_MODES = (("T 1", SamplingParams(temperature=1.0)),
              ("T 0.9 top-k 20", SamplingParams(temperature=0.9, top_k=20)),
              ("top-p 0.9", SamplingParams(temperature=1.0, top_p=0.9)))
# weight-only int8: the d 1024 rung of bench.py:455-464 (vocab 309, 6
# layers, d 1024, 16 heads, FFN 512, max_seq 2048), beside the flagship;
# int8 against the unquantized kernel within JAX's bound, max |int8 -
# full| / max |full| < 3e-2 (tests/test_pallas_decode.py:459-460); the
# decode rates at bench.py:25-44's shape (B 8, a 16-token prompt, 512
# sampled tokens, cache 1024), interleaved, median of 3
D_RUNG = 1024
TOL_INT8_REL = 3e-2
RATE_PROMPT, RATE_CACHE, RATE_ROUNDS = 16, 1024, 3
# timing: 64 MB written between calls evicts the 50 MB L2
FLUSH_BYTES = 64 << 20
_SPIN_CYCLES_PER_MS = []


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_rows(prof) -> list:
    """(device us, count, name) of each kernel in a torch.profiler run:
    device-side events only (a CPU op's device time repeats the time of
    the kernels it launched)."""
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    return rows


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card,
    measured once."""
    if not _SPIN_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def device_ms(fn, iters: int = 100, flush=None) -> float:
    """Device time of one ``fn()`` call, averaged over ``iters`` calls.
    Before each call a spin kernel holds the stream while the host
    enqueues the call between its own pair of events, so the host's
    launch cost never shows between them. The spin is twice the host
    time of one call, doubled until every timed call was enqueued before
    its spin ended. With ``flush`` (a buffer larger than the 50 MB L2)
    each call follows a write of the whole buffer, so it reads its
    inputs from device memory."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin_ms = 2 * (time.perf_counter() - t0) * 1e3 + 0.05
    for _ in range(4):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        held = True
        for s, e in zip(starts, ends):
            torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            if flush is not None:
                flush.zero_()
            s.record()
            fn()
            e.record()
            held = held and not s.query()
        torch.cuda.synchronize()
        if held:
            break
        spin_ms *= 2
    else:
        print(f"device_ms: the host outran a {spin_ms / 2:.2f} ms spin; the "
              "time below includes host gaps")
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_inputs(dtype, gen, with_pad: bool, l: int = L_PREFILL):
    shape = (B, H, l, DH)
    q, k, v = (torch.randn(shape, generator=gen).to(DEV, dtype)
               for _ in range(3))
    e = torch.randn(MAX_SEQ, DH, generator=gen).to(DEV)
    pad = None
    if with_pad:  # a bucket tail, as the main path's 500 tokens of 512
        pad = torch.zeros(B, l)
        pad[:, l - (L_PREFILL - PROMPT):] = 1.0
        pad = pad.to(DEV)
    return q, k, v, e, pad


def check_kernel_a() -> float:
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (dtype, key_pad, causal, L); the main path is bf16, causal, key_pad
    for dtype, with_pad, causal, l in (
            (f32, False, True, L_PREFILL), (f32, True, True, L_PREFILL),
            (bf16, False, True, L_PREFILL), (bf16, True, True, L_PREFILL),
            (f32, True, False, L_PREFILL), (f32, True, True, 100),
            (bf16, True, True, 100)):
        q, k, v, e, pad = attn_inputs(dtype, gen, with_pad, l)
        out, lse = fused_relative_attention(q, k, v, e, pad, causal,
                                            return_lse=True)
        ref, ref_lse = fused_relative_attention_plain(q, k, v, e, pad, causal,
                                                      return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = err <= TOL_A[dtype] and lse_err <= 1e-3
        print(f"kernel A {str(dtype):15s} L={l:4d} key_pad={with_pad!s:5s} "
              f"causal={causal!s:5s} max_abs_err={err:.3e} "
              f"lse_err={lse_err:.3e} tol={TOL_A[dtype]:.1e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel A disagrees with its plain version")
        if dtype == bf16:
            worst = max(worst, err)
    return worst


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """max |a - ref| over max |ref|."""
    scale = ref.float().abs().max().item()
    return (a.float() - ref.float()).abs().max().item() / max(scale, 1e-30)


def check_kernel_c() -> float:
    """Kernel C against its plain backward on the same inputs (q, k, v,
    E, key_pad, kernel A's out and LSE, a random dO), at the training
    shape (B8 H4 L512, max_seq 512) and the flagship table (max_seq
    2048), plus L 100. E rows no (t, s) pair touches must be exactly 0."""
    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(ms, dtype, causal, with_pad, L_TRAIN)
             for ms in (L_TRAIN, MAX_SEQ) for dtype in (f32, bf16)
             for causal in (True, False) for with_pad in (False, True)]
    cases += [(MAX_SEQ, dtype, causal, True, 100)
              for dtype in (f32, bf16) for causal in (True, False)]
    for ms, dtype, causal, with_pad, l in cases:
        q, k, v, _, pad = attn_inputs(dtype, gen, with_pad, l)
        e = torch.randn(ms, DH, generator=gen).to(DEV)
        dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
        out, lse = fused_relative_attention(q, k, v, e, pad, causal,
                                            return_lse=True)
        got = fused_relative_attention_bwd(q, k, v, e, pad, causal, out, lse,
                                           dout)
        ref = fused_relative_attention_bwd_plain(q, k, v, e, pad, causal,
                                                 out, lse, dout)
        torch.cuda.synchronize()
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        abs_err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(got, ref))
        untouched_zero = (got[3][:ms - l].abs().max().item() == 0.0
                          if ms > l else True)
        ok = max(errs) <= TOL_C[dtype] and untouched_zero and all(
            bool(torch.isfinite(a).all()) for a in got)
        print(f"kernel C {str(dtype):15s} max_seq={ms:4d} L={l:4d} "
              f"key_pad={with_pad!s:5s} causal={causal!s:5s} rel_err "
              f"dq={errs[0]:.2e} dk={errs[1]:.2e} dv={errs[2]:.2e} "
              f"de={errs[3]:.2e} max_abs_err={abs_err:.2e} "
              f"untouched_de_zero={untouched_zero} "
              f"tol={TOL_C[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel C disagrees with its plain version")
        if dtype == bf16:
            worst = max(worst, abs_err)
    return worst


def flagship(dtype, seed: int = 0, quant: str = "none",
             d_model: int = D_MODEL) -> mt.MusicTransformer:
    """The flagship (or, with ``d_model=D_RUNG``, the d 1024 rung) with
    seeded random weights."""
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=N_LAYERS, d_model=d_model,
        max_seq=MAX_SEQ, dtype=dtype, device=DEV,
        generator=torch.Generator().manual_seed(seed), decode_quant=quant)


def decode_inputs(model, gen, b: int = B):
    """x [b, d] and filled [L, b, 1024, d] caches in the model dtype; the
    model's stacked weights (an int8 model's hold their "int8" pair)."""
    w_all, e_all = model.decode_weights()
    cache_len = 1024
    shape = (model.num_layers, b, cache_len, model.d_model)
    kc = torch.randn(shape, generator=gen).to(DEV, model.dtype)
    vc = torch.randn(shape, generator=gen).to(DEV, model.dtype)
    x = torch.randn(b, model.d_model, generator=gen).to(DEV, model.dtype)
    return x, e_all, w_all, kc, vc


def untouched(a, b, t: int, c: int = 1) -> bool:
    """Every cache row outside [t, t+c) is equal."""
    return (torch.equal(a[:, :, :t], b[:, :, :t])
            and torch.equal(a[:, :, t + c:], b[:, :, t + c:]))


def check_kernel_b() -> float:
    gen = torch.Generator().manual_seed(2)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype)
        for t, b in ((0, B), (1, B), (127, B), (128, B), (511, B),
                     (1023, B), (5, 1), (300, 3)):
            x, e_all, w_all, kc, vc = decode_inputs(model, gen, b)
            kc2, vc2 = kc.clone(), vc.clone()
            out, kc, vc = fused_decode_step(x, t, e_all, w_all, kc, vc, H)
            ref, kc2, vc2 = fused_decode_step_plain(x, t, e_all, w_all, kc2,
                                                    vc2, H)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            row_err = max((kc[:, :, t].float() - kc2[:, :, t].float())
                          .abs().max().item(),
                          (vc[:, :, t].float() - vc2[:, :, t].float())
                          .abs().max().item())
            ok = (max(err, row_err) <= TOL_B[dtype]
                  and untouched(kc, kc2, t) and untouched(vc, vc2, t))
            print(f"kernel B {str(dtype):15s} B={b} t={t:5d} "
                  f"max_abs_err={err:.3e}"
                  f" cache_row_err={row_err:.3e} tol={TOL_B[dtype]:.1e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel B disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16:
                worst = max(worst, err, row_err)
    return worst


def ragged_starts(gen, t: int, b: int = B) -> torch.Tensor:
    """[b] int32 per-row starts in [0, t]: one row at t (only itself
    live), one in the last live split, the rest random."""
    start = torch.randint(0, t + 1, (b,), generator=gen)
    start[0] = t
    start[1] = (t // 128) * 128 + (t % 128) // 2
    return start.to(torch.int32)


def check_kernel_b_ragged() -> float:
    """Ragged kernel B (per-row start, start_min 0 and min(start))
    against its plain version, with t inside a split and at a split's
    end; every cache row but t untouched."""
    gen = torch.Generator().manual_seed(12)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype)
        for t in (300, 383, 1023):
            start = ragged_starts(gen, t).to(DEV)
            for smin in (0, int(start.min())):
                x, e_all, w_all, kc, vc = decode_inputs(model, gen)
                kc2, vc2 = kc.clone(), vc.clone()
                out, kc, vc = fused_decode_step(x, t, e_all, w_all, kc, vc,
                                                H, start=start,
                                                start_min=smin)
                ref, kc2, vc2 = fused_decode_step_plain(
                    x, t, e_all, w_all, kc2, vc2, H, start=start,
                    start_min=smin)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                row_err = max((kc[:, :, t].float() - kc2[:, :, t].float())
                              .abs().max().item(),
                              (vc[:, :, t].float() - vc2[:, :, t].float())
                              .abs().max().item())
                ok = (max(err, row_err) <= TOL_B[dtype]
                      and bool(torch.isfinite(out).all())
                      and untouched(kc, kc2, t) and untouched(vc, vc2, t))
                print(f"kernel B ragged {str(dtype):15s} B={B} t={t:5d} "
                      f"start_min={smin:4d} min(start)="
                      f"{int(start.min()):4d} max_abs_err={err:.3e} "
                      f"cache_row_err={row_err:.3e} tol={TOL_B[dtype]:.1e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("ragged kernel B disagrees with "
                                         "its plain version")
                if dtype == torch.bfloat16:
                    worst = max(worst, err, row_err)
    return worst


def chunk_inputs(model, stacked, gen, b: int, c: int, cache_len: int):
    """x [b, c, d] and filled [L, b, cache_len, d] caches in the model
    dtype, drawn on the card; the model's stacked weights."""
    w_all, e_all = stacked
    shape = (model.num_layers, b, cache_len, model.d_model)
    kc = torch.randn(shape, generator=gen, device=DEV).to(model.dtype)
    vc = torch.randn(shape, generator=gen, device=DEV).to(model.dtype)
    x = torch.randn(b, c, model.d_model, generator=gen,
                    device=DEV).to(model.dtype)
    return x, e_all, w_all, kc, vc


def chunk_ts(c: int) -> tuple:
    """t = 1; [t, t+c) across the 128-row split boundary; t 755 (the
    main path's middle); t + c = max_seq."""
    return (1, 128 - c // 2, T_TIMED, MAX_SEQ - c)


def check_kernel_e() -> float:
    """Kernel E against its plain version at the flagship width (cache
    of max_seq rows) for B 1, 4, 8, C 2, 5, 8, 64 and four t each, f32
    and bf16; every cache row outside [t, t+C) unchanged by both."""
    gen = torch.Generator(DEV).manual_seed(14)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype)
        stacked = model.decode_weights()
        for b in CHUNK_BATCHES:
            for c in CHUNKS:
                errs = []
                for t in chunk_ts(c):
                    x, e_all, w_all, kc, vc = chunk_inputs(model, stacked,
                                                           gen, b, c, MAX_SEQ)
                    kc0, vc0 = kc.clone(), vc.clone()
                    kc2, vc2 = kc.clone(), vc.clone()
                    out, kc, vc = fused_decode_chunk(x, t, e_all, w_all, kc,
                                                     vc, H)
                    ref, kc2, vc2 = fused_decode_chunk_plain(
                        x, t, e_all, w_all, kc2, vc2, H)
                    torch.cuda.synchronize()
                    err = max((out.float() - ref.float()).abs().max().item(),
                              (kc[:, :, t:t + c].float()
                               - kc2[:, :, t:t + c].float()).abs().max()
                              .item(),
                              (vc[:, :, t:t + c].float()
                               - vc2[:, :, t:t + c].float()).abs().max()
                              .item())
                    same = all(untouched(a, a0, t, c) for a, a0 in (
                        (kc, kc0), (vc, vc0), (kc2, kc0), (vc2, vc0)))
                    if not (err <= TOL_B[dtype] and same
                            and bool(torch.isfinite(out.float()).all())):
                        raise AssertionError(
                            f"kernel E disagrees with its plain version: "
                            f"{dtype} B={b} C={c} t={t} max_abs_err={err:.3e}"
                            f" other rows untouched: {same}")
                    errs.append((t, err))
                    if dtype == torch.bfloat16:
                        worst = max(worst, err)
                print(f"kernel E {str(dtype):15s} B={b} C={c:2d} max_abs_err "
                      + " ".join(f"t={t}:{e:.2e}" for t, e in errs)
                      + f" tol={TOL_B[dtype]:.1e}; rows outside [t, t+C) "
                      "untouched ok")
    return worst


def check_chunk_vs_steps() -> None:
    """One kernel-E call against C chained kernel-B steps on the same
    tokens and caches: the outputs and the written cache rows agree
    (f32 1e-4, bf16 kernel B's tolerance)."""
    gen = torch.Generator(DEV).manual_seed(15)
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype)
        stacked = model.decode_weights()
        for b, c, t in ((B, SPEC_CHUNK, T_TIMED), (1, 64, 100), (4, 5, 126)):
            x, e_all, w_all, kc, vc = chunk_inputs(model, stacked, gen, b, c,
                                                   1024)
            kb, vb = kc.clone(), vc.clone()
            out, kc, vc = fused_decode_chunk(x, t, e_all, w_all, kc, vc, H)
            steps = []
            for i in range(c):
                o, kb, vb = fused_decode_step(x[:, i].contiguous(), t + i,
                                              e_all, w_all, kb, vb, H)
                steps.append(o)
            torch.cuda.synchronize()
            err = max((out.float() - torch.stack(steps, 1).float()).abs()
                      .max().item(),
                      (kc.float() - kb.float()).abs().max().item(),
                      (vc.float() - vb.float()).abs().max().item())
            ok = err <= TOL_B[dtype]
            print(f"kernel E vs {c} chained kernel-B steps {str(dtype):15s} "
                  f"B={b} t={t}: max_abs_err {err:.3e} (outputs and caches) "
                  f"tol={TOL_B[dtype]:.1e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel E disagrees with chained kernel "
                                     "B steps")


def gru_inputs(b: int, in_dim: int, hidden: int, layers: int, dtype, gen):
    """x [b, in], h [L, b, H] in ``dtype`` and packed random GRU weights
    (torch's U(-1/sqrt(H), 1/sqrt(H)) init) on the card."""
    s = hidden ** -0.5
    params = []
    for li in range(layers):
        width = in_dim if li == 0 else hidden
        params.append(tuple(
            (torch.rand(shape, generator=gen) * 2 * s - s).to(DEV)
            for shape in ((3 * hidden, width), (3 * hidden, hidden),
                          (3 * hidden,), (3 * hidden,))))
    x = torch.randn(b, in_dim, generator=gen).to(DEV, dtype)
    h = (torch.rand(layers, b, hidden, generator=gen) * 2 - 1).to(DEV, dtype)
    return x, h, pack_gru_weights(params, dtype)


def check_kernel_d() -> float:
    """Kernel D against its plain version at both families' full width
    (in 308 and 512, H 512, 3 layers) for B 1, 4, 8 and 64, f32 and bf16,
    and at a small shape (in 32, H 32, 2 layers); its inputs unchanged."""
    gen = torch.Generator().manual_seed(21)
    worst = 0.0
    cases = [(b, in_dim, RNN_HIDDEN, RNN_LAYERS, dtype)
             for in_dim in (EVENT_DIM, RNN_HIDDEN) for b in (1, 4, 8, 64)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(b, 32, 32, 2, dtype) for b in (1, 8)
              for dtype in (torch.float32, torch.bfloat16)]
    for b, in_dim, hidden, layers, dtype in cases:
        x, h, w = gru_inputs(b, in_dim, hidden, layers, dtype, gen)
        x0, h0 = x.clone(), h.clone()
        out, h_new = fused_gru_step(x, h, w)
        ref_out, ref_h = fused_gru_step_plain(x, h, w)
        torch.cuda.synchronize()
        err = max((out.float() - ref_out.float()).abs().max().item(),
                  (h_new.float() - ref_h.float()).abs().max().item())
        ok = (err <= TOL_D[dtype] and torch.equal(x, x0)
              and torch.equal(h, h0) and torch.equal(out, h_new[-1])
              and bool(torch.isfinite(h_new.float()).all()))
        print(f"kernel D {str(dtype):15s} B={b:2d} in={in_dim:3d} H={hidden} "
              f"L={layers} max_abs_err={err:.3e} tol={TOL_D[dtype]:.0e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel D disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)
    return worst


@contextlib.contextmanager
def plain_path():
    """Run the models through the plain versions of the kernels: A and C
    (attention), B and E (the MusicTransformer decode step and chunk
    forward), F (the decode loop), D (the GRU step)."""
    saved = (mt.fused_relative_attention, mt.fused_decode_step,
             mt.fused_decode_chunk, mt.fused_decode_loop,
             gru_mod.fused_gru_step)
    mt.fused_relative_attention = fused_relative_attention_plain
    mt.fused_decode_step = fused_decode_step_plain
    mt.fused_decode_chunk = fused_decode_chunk_plain
    mt.fused_decode_loop = fused_decode_loop_plain
    gru_mod.fused_gru_step = fused_gru_step_plain
    try:
        yield
    finally:
        (mt.fused_relative_attention, mt.fused_decode_step,
         mt.fused_decode_chunk, mt.fused_decode_loop,
         gru_mod.fused_gru_step) = saved


def write_inputs(model, tmp: str) -> tuple:
    """The model saved as an exported .pth and a prime MIDI of random
    events. Returns their paths."""
    pth = os.path.join(tmp, "model.pth")
    torch.save({"net": model.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    prime_mid = os.path.join(tmp, "prime.mid")
    write_midi(np.random.default_rng(0).integers(0, VOCAB - 1, 3000),
               prime_mid)
    return pth, prime_mid


def run_cli(model, tmp: str) -> np.ndarray:
    """The user's entry point: export the model as a .pth, write a prime
    MIDI, run ``cli.generate`` on it (B 8, prime 500 -> bucket 512, 512
    sampled bf16 tokens) with both launch counters read around it.
    Returns the tokenized prime."""
    pth, prime_mid = write_inputs(model, tmp)
    prime = prime_tokens(prime_mid, PROMPT)
    if len(prime) != PROMPT:
        raise AssertionError(f"prime has {len(prime)} tokens, not {PROMPT}")
    out = os.path.join(tmp, "out.mid")
    torch.cuda.synchronize()
    fused_relative_attention.launches = 0
    fused_decode_step.launches = 0
    t0 = time.perf_counter()
    cli_main([pth, out, "--prime", prime_mid, "--prime-len", str(PROMPT),
              "--steps", str(STEPS), "--batch", str(B), "--dtype",
              "bfloat16", "--seed", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (fused_relative_attention.launches,
                fused_decode_step.launches)
    print(f"cli.generate bf16: B={B} prime {PROMPT}->{L_PREFILL} "
          f"steps={STEPS} {secs:.3f} s (load, tokenize, generate, write); "
          f"launches kernel A={launches[0]} kernel B={launches[1]}")
    if launches[0] != N_LAYERS:
        raise AssertionError(f"kernel A launched {launches[0]} times in one "
                             f"prefill, expected {N_LAYERS}")
    if launches[1] < STEPS * N_LAYERS:
        raise AssertionError(f"kernel B launched {launches[1]} times for "
                             f"{STEPS} tokens x {N_LAYERS} layers")
    for i in range(B):
        path = os.path.join(tmp, f"out-{i:03d}.mid")
        n_events = len(midilike.extract_events(path).events)
        if n_events == 0:
            raise AssertionError(f"{path} has no events")
    print(f"wrote {B} MIDI files; the first re-reads as {n_events} events")
    return np.asarray(prime)


def end_to_end() -> dict:
    model = flagship(torch.bfloat16)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        prime = run_cli(model, tmp)
    launches_a = fused_relative_attention.launches
    launches_b = fused_decode_step.launches
    prompt_np, prompt_len = bucket_prompt(np.tile(prime, (B, 1)), STEPS,
                                          MAX_SEQ, model.pad_id)
    assert prompt_np.shape[1] == L_PREFILL and prompt_len == PROMPT
    prompt = torch.from_numpy(prompt_np).to(DEV)

    # the same generation timed on its own: prefill, then decode
    dp = DecodeParams(max_len=L_PREFILL + STEPS, steps=STEPS,
                      sampling=SamplingParams())
    gen = torch.Generator(device=DEV).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens = generate(model, prompt, gen, dp, prompt_len)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    toks = tokens.cpu().numpy()
    if toks.shape != (B, STEPS) or toks.min() < 0 or toks.max() >= VOCAB:
        raise AssertionError(f"bad tokens: shape {toks.shape}, range "
                             f"[{toks.min()}, {toks.max()}]")
    prefill_ms = device_ms(lambda: model.prefill(prompt, L_PREFILL + STEPS,
                                                 PROMPT - 1), iters=5)
    tok_s = B * STEPS / (total_s - prefill_ms / 1e3)
    print(f"generate bf16: {total_s:.3f} s; prefill {prefill_ms:.3f} ms; "
          f"decode {tok_s:.1f} tokens/s (B={B}, {STEPS} steps, host clock)")

    # greedy f32: the kernel path against the plain path, on the card
    model32 = flagship(torch.float32)
    dpg = DecodeParams(max_len=L_PREFILL + GREEDY_STEPS, steps=GREEDY_STEPS,
                       sampling=SamplingParams(greedy=True))
    kern = generate(model32, prompt, None, dpg, prompt_len)
    with plain_path():
        plain = generate(model32, prompt, None, dpg, prompt_len)
    same = torch.equal(kern, plain)
    print(f"greedy f32 {GREEDY_STEPS} tokens x {B}: kernel path == plain "
          f"path: {same}")
    if not same:
        first = (kern != plain).nonzero()[0].tolist()
        raise AssertionError(f"greedy tokens differ first at {first}")
    return {"A": launches_a, "B": launches_b, "prefill_ms": prefill_ms,
            "tok_s": tok_s, "prime": prime}


def profile_decode(steps: int = 32, warm: int = 3, d_model: int = D_MODEL,
                   quant: str = "none") -> None:
    """Where a bf16 decode step's time goes (the flagship, or the d 1024
    rung; unquantized or int8): device time by kernel and the device's
    busy share of the wall time, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16, quant=quant, d_model=d_model)
    prompt = torch.randint(0, VOCAB - 1, (B, L_PREFILL), device=DEV,
                           generator=torch.Generator(DEV).manual_seed(5))
    logits, cache = model.prefill(prompt, L_PREFILL + warm + steps)
    stacked = model.decode_weights()
    t = L_PREFILL
    for _ in range(warm):
        logits, cache = model.decode_step(logits.argmax(-1), cache, t,
                                          stacked)
        t += 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(logits.argmax(-1), cache, t,
                                              stacked)
            t += 1
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    print(f"decode profile d={d_model} {quant}: {steps} steps "
          f"(decode_step + argmax), wall "
          f"{wall_us / steps:.1f} us/step under the profiler, device busy "
          f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f}% "
          f"of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / steps:8.2f} us/step {count // steps:4d}x/step "
              f"{key[:90]}")


def serve_requests(prime_mid: str) -> list:
    """cli.serve's 24 requests: prompts of SERVE_PROMPTS tokens from the
    prime MIDI, 64-768 new tokens; four with an eos id, four with their
    own sampling fields, the last a sliding window past max_seq."""
    rng = np.random.default_rng(9)
    news = rng.integers(64, 769, N_SERVE)
    own = [{"temperature": 0.9, "top_k": 20}, {"top_p": 0.9},
           {"greedy": True}, {"temperature": 1.2, "top_k": 5, "top_p": 0.95}]
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"r{i:02d}", "prime": prime_mid,
             "prime_len": SERVE_PROMPTS[i % len(SERVE_PROMPTS)],
             "max_new": int(news[i])}
        if i < 4:
            r["eos"] = int(rng.integers(0, VOCAB - 1))
        elif i < 8:
            r.update(own[i - 4])
        reqs.append(r)
    reqs[-1].update(prime_len=PROMPT, max_new=WINDOW_NEW,
                    window=SERVE_WINDOW)
    return reqs


def serve_file_mode(tmp: str, pth: str, prime_mid: str) -> dict:
    """cli.serve in file mode with its defaults, bf16, the launch
    counters of kernels A and B read around it."""
    reqs = serve_requests(prime_mid)
    path = os.path.join(tmp, "requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir = os.path.join(tmp, "served")
    buf = io.StringIO()
    torch.cuda.synchronize()
    fused_relative_attention.launches = 0
    fused_decode_step.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main([pth, path, outdir, "--dtype", "bfloat16",
                         "--seed", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (fused_relative_attention.launches,
                fused_decode_step.launches)
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    print(f"cli.serve bf16 file mode ({N_SERVE} requests, slots {SLOTS}, "
          f"seg {SEG}, depth {DEPTH}) in {secs:.3f} s (load, warm, serve, "
          f"write): {summary}")
    stat = {k: int(re.search(rf"(\d+) {k}", summary).group(1))
            for k in ("decode steps", "admission calls", "compactions",
                      "reprimes")}
    written = dict(re.findall(r"wrote .*/(r\d\d)\.mid \((\d+) tokens\)",
                              out))
    n_events = [len(midilike.extract_events(
        os.path.join(outdir, f"{r['id']}.mid")).events) for r in reqs]
    exact = all(int(written[r["id"]]) == r["max_new"] for r in reqs
                if "eos" not in r)
    cut = all(int(written[r["id"]]) <= r["max_new"] for r in reqs)
    print(f"  {len(written)} MIDI files read back as {min(n_events)}-"
          f"{max(n_events)} events; the window request wrote "
          f"{written[reqs[-1]['id']]} tokens; launches kernel A="
          f"{launches[0]} (6 x {stat['admission calls']} admission calls), "
          f"kernel B={launches[1]} (18 x {stat['decode steps']} decode "
          f"steps)")
    ok = (rc == 0 and len(written) == N_SERVE and exact and cut
          and launches[0] == N_LAYERS * stat["admission calls"]
          and launches[1] == 3 * N_LAYERS * stat["decode steps"]
          and stat["compactions"] > 0 and stat["reprimes"] > 0)
    if not ok:
        raise AssertionError(f"cli.serve: rc {rc}, {len(written)} files, "
                             f"launches {launches}, {stat}")
    return {"A": launches[0], "B": launches[1]}


def serve_parity(prime: np.ndarray, quant: str = "none") -> None:
    """Greedy f32 serving of 8 staggered requests (3 admitted later,
    mid-flight) through the kernels and through their plain versions:
    the tokens must be equal. ``quant``: the model's decode_quant."""
    model32 = flagship(torch.float32, quant=quant)
    lens = (1, 3, 64, 200, 500, 17, 100, 33)
    news = (64, 128, 96, 64, 100, 80, 128, 72)
    outs = []
    for plain in (False, True):
        cb = ContinuousBatcher(model32, slots=SLOTS, seg_len=SEG,
                               depth=DEPTH,
                               sampling=SamplingParams(greedy=True))
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(prime[:p], n) for p, n in zip(lens[:5],
                                                            news[:5])]
            cb.step()
            rids += [cb.submit(prime[:p], n) for p, n in zip(lens[5:],
                                                             news[5:])]
            done = cb.run()
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"serving greedy f32{' int8' if quant == 'int8' else ''}, "
          f"{len(lens)} staggered requests: kernel path == plain path: "
          f"{same}")
    if not same:
        raise AssertionError("served greedy tokens differ from the plain "
                             "path's")


def serve_http(tmp: str, pth: str, prime_mid: str) -> None:
    """cli.serve --http on an ephemeral port: one /generate, one /stream
    and one /cancel, then /shutdown."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rc = {}
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            rc["code"] = serve_main([pth, "-", os.path.join(tmp, "http"),
                                     "--http", str(port), "--dtype",
                                     "bfloat16"])

    th = threading.Thread(target=run, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"

    def call(path, data=None):
        body = None if data is None else json.dumps(data).encode()
        with urllib.request.urlopen(base + path, data=body, timeout=300) as r:
            return json.loads(r.read())

    deadline = time.time() + 300
    while True:
        try:
            if call("/healthz")["ready"]:
                break
        except OSError:
            if time.time() > deadline or not th.is_alive():
                raise AssertionError("cli.serve --http never became ready")
            time.sleep(0.2)
    t0 = time.perf_counter()
    gen = call("/generate", {"id": "g", "prime": prime_mid,
                             "prime_len": 200, "max_new": 256})
    gen_s = time.perf_counter() - t0
    streamed, chunks, done = [], 0, None
    with urllib.request.urlopen(base + "/stream", data=json.dumps(
            {"id": "s", "prime": prime_mid, "prime_len": 64,
             "max_new": 192}).encode(), timeout=300) as sse:
        event = None
        for raw in sse:
            line = raw.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[7:]
            elif line.startswith("data: "):
                payload = json.loads(line[6:])
                if event == "done":
                    done = payload
                    break
                streamed.extend(payload["tokens"])
                chunks += 1
                event = None
    call("/submit", {"id": "c", "prime": prime_mid, "prime_len": 3,
                     "max_new": 1500})
    cancel = call("/cancel", {"id": "c"})
    deadline = time.time() + 300
    while True:
        try:
            res = call("/result/c")
            if res.get("status") != "pending":
                break
        except urllib.error.HTTPError:
            pass                       # not drained by the engine yet
        if time.time() > deadline:
            raise AssertionError("the cancelled request never resolved")
        time.sleep(0.05)
    stats = call("/stats")
    call("/shutdown", {})
    th.join(timeout=300)
    ok = (gen["n_tokens"] == 256 and done is not None
          and done["n_tokens"] == 192 == len(streamed) and chunks >= 2
          and cancel["status"] == "cancel_requested"
          and res.get("status") == "cancelled" and res["n_tokens"] < 1500
          and not th.is_alive() and rc.get("code") == 0)
    print(f"cli.serve --http bf16: /generate 256 tokens in {gen_s:.3f} s; "
          f"/stream {len(streamed)} tokens in {chunks} chunks; /cancel -> "
          f"{res.get('status')} after {res.get('n_tokens')} tokens; "
          f"/stats committed {stats['stats']['committed_tokens']} tokens; "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.serve --http misbehaved")


def serving(prime: np.ndarray) -> dict:
    model = flagship(torch.bfloat16)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        pth, prime_mid = write_inputs(model, tmp)
        counts = serve_file_mode(tmp, pth, prime_mid)
        serve_parity(prime)
        serve_http(tmp, pth, prime_mid)
    return counts


def profile_serving() -> None:
    """The device's busy share over one serving segment (8 slots, 64
    steps, bf16, per-row sampling) under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16)
    cb = ContinuousBatcher(model, slots=SLOTS, seg_len=SEG, depth=DEPTH,
                           per_row_sampling=True,
                           generator=torch.Generator(DEV).manual_seed(0))
    prime = np.random.default_rng(3).integers(0, VOCAB - 1, PROMPT)
    for i in range(SLOTS):
        cb.submit(prime[:SERVE_PROMPTS[i % len(SERVE_PROMPTS)]], 4 * SEG)
    cb.step()                          # admissions + a first segment
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cb.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    print(f"serving profile: one segment ({SEG} steps x {SLOTS} slots, "
          f"per-row sampling), wall {wall_us / SEG:.1f} us/step under the "
          f"profiler, device busy {busy_us / SEG:.1f} us/step "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / SEG:8.2f} us/step {count / SEG:5.1f}x/step "
              f"{key[:90]}")


def draft_model(dtype) -> mt.MusicTransformer:
    """The draft of the speculative runs: seeded random weights."""
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=DRAFT_LAYERS, d_model=DRAFT_D,
        max_seq=MAX_SEQ, dtype=dtype, device=DEV,
        generator=torch.Generator().manual_seed(3))


def reset_counts() -> None:
    torch.cuda.synchronize()
    fused_relative_attention.launches = 0
    fused_decode_step.launches = 0
    fused_decode_step.int8_launches = 0
    fused_decode_chunk.launches = 0
    fused_decode_chunk.int8_launches = 0
    fused_decode_loop.launches = 0


def spec_cli(tmp: str, pth: str, prime_mid: str) -> dict:
    """cli.generate --spec at full width in bf16 (the 500-token prime, 512
    sampled tokens, --spec-chunk 8): lookup at B 1 and B 4, the draft
    checkpoint, and the target as its own draft. The launch counters,
    set to 0 before each run and read after it, must be exactly: kernel
    A one prefill of the target (6) plus one of the draft; kernel E 18
    per verify forward; kernel B C x 3 x the draft's layers per verify
    forward (none for lookup). Every MIDI file is read back."""
    dpth = os.path.join(tmp, "draft.pth")
    torch.save({"net": draft_model(torch.float32).state_dict(),
                "optimizer": {}, "epoch": 0}, dpth)
    runs = {}
    for name, spec, nb, l_draft in (("lookup_b1", "lookup", 1, 0),
                                    ("lookup_b4", "lookup", 4, 0),
                                    ("draft", dpth, 1, DRAFT_LAYERS),
                                    ("self", pth, 1, N_LAYERS)):
        out = os.path.join(tmp, f"spec-{name}.mid")
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_main([pth, out, "--prime", prime_mid, "--prime-len",
                           str(PROMPT), "--steps", str(STEPS), "--batch",
                           str(nb), "--dtype", "bfloat16", "--seed", "0",
                           "--spec", spec, "--spec-chunk", str(SPEC_CHUNK)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = (fused_relative_attention.launches, fused_decode_chunk.launches,
             fused_decode_step.launches)
        text = buf.getvalue()
        m = re.search(r"speculative: (\d+) verify forwards for (\d+) tokens "
                      r"\(mean accepted ([\d.]+)/(\d+)\)", text)
        iters = int(m.group(1))
        want = (N_LAYERS + l_draft, iters * 3 * N_LAYERS,
                iters * SPEC_CHUNK * 3 * l_draft)
        paths = re.findall(r"wrote (\S+) \((\d+) tokens\)", text)
        events = [len(midilike.extract_events(path).events)
                  for path, _ in paths]
        ok = (rc == 0 and n == want and len(paths) == nb
              and all(int(k) == STEPS for _, k in paths) and min(events) > 0)
        print(f"cli.generate --spec {name} bf16 (B={nb}, prime {PROMPT}, "
              f"{STEPS} steps, chunk {SPEC_CHUNK}): {secs:.3f} s; "
              f"{iters} verify forwards, mean accepted {m.group(3)}/"
              f"{m.group(4)}; launches A={n[0]} E={n[1]} B={n[2]} (expected "
              f"{want[0]}, {want[1]}, {want[2]}); {len(paths)} MIDI files "
              f"read back as {min(events)}-{max(events)} events "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cli.generate --spec {name} failed")
        runs[name] = {"A": n[0], "E": n[1], "B": n[2], "iterations": iters,
                      "mean_accepted": float(m.group(3)), "secs": secs}
    return runs


def spec_parity(prime: np.ndarray) -> None:
    """Greedy f32 speculative decoding through kernels A, E (and B for
    the draft) against greedy f32 ``decode.generate`` through kernels A
    and B, token for token: lookup at B 1 and B 3, the target as its own
    draft (every proposal accepted: mean_accepted == C - 1)."""
    model32 = flagship(torch.float32)
    sp = SpecParams(chunk=SPEC_CHUNK)
    p3 = PROMPT - 20
    for name, prompt, draft in (
            ("lookup B=1", prime[None], None),
            ("lookup B=3", np.stack([prime[i:i + p3] for i in (0, 10, 20)]),
             None),
            ("self-draft B=1", prime[None], model32)):
        prompt = torch.from_numpy(np.ascontiguousarray(prompt)).to(DEV)
        dp = DecodeParams(max_len=prompt.shape[1] + SPEC_GREEDY,
                          steps=SPEC_GREEDY,
                          sampling=SamplingParams(greedy=True))
        want = generate(model32, prompt, None, dp)
        got, stats = generate_speculative(model32, prompt, None, dp,
                                          draft_model=draft, spec=sp,
                                          with_stats=True)
        same = torch.equal(got, want)
        full = draft is None or stats["mean_accepted"] == SPEC_CHUNK - 1
        print(f"speculative greedy f32 {name}, {SPEC_GREEDY} tokens: == "
              f"generate: {same}; {stats['iterations']} verify forwards, "
              f"mean accepted {stats['mean_accepted']:.3f}/{SPEC_CHUNK - 1}")
        if not (same and full):
            raise AssertionError(f"speculative {name}: tokens equal {same}, "
                                 f"mean accepted {stats['mean_accepted']}")


def spec_rates(prime: np.ndarray) -> dict:
    """B 1 bf16 greedy, the 500-token prime and 512 new tokens: plain
    ``generate``, lookup and self-draft speculation run interleaved in
    SPEC_ROUNDS rounds; tokens/s over the whole call (prefill included)
    on the host clock, the median and range of each."""
    model = flagship(torch.bfloat16)
    prompt = torch.from_numpy(prime[None]).to(DEV)
    dp = DecodeParams(max_len=PROMPT + STEPS, steps=STEPS,
                      sampling=SamplingParams(greedy=True))
    sp = SpecParams(chunk=SPEC_CHUNK)
    kinds = {"plain": lambda: (generate(model, prompt, None, dp), None),
             "lookup": lambda: generate_speculative(
                 model, prompt, None, dp, spec=sp, with_stats=True),
             "self": lambda: generate_speculative(
                 model, prompt, None, dp, draft_model=model, spec=sp,
                 with_stats=True)}
    rates = {k: [] for k in kinds}
    stats = {}
    for _ in range(SPEC_ROUNDS):
        for k, fn in kinds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, st = fn()
            torch.cuda.synchronize()
            rates[k].append(STEPS / (time.perf_counter() - t0))
            stats[k] = st
            if toks.shape != (1, STEPS):
                raise AssertionError(f"{k}: tokens {tuple(toks.shape)}")
    out = {}
    for k, r in rates.items():
        med = float(np.median(r))
        extra = ("" if stats[k] is None else
                 f"; {stats[k]['iterations']} verify forwards, mean accepted "
                 f"{stats[k]['mean_accepted']:.3f}/{SPEC_CHUNK - 1}")
        print(f"B=1 bf16 greedy {k}: {med:.1f} tokens/s median of "
              f"{SPEC_ROUNDS} interleaved runs [{min(r):.1f}-{max(r):.1f}] "
              f"(prefill included, host clock){extra}")
        out[k] = {"tok_s": med, "tok_s_range": [min(r), max(r)],
                  **({} if stats[k] is None else
                     {"iterations": stats[k]["iterations"],
                      "mean_accepted": stats[k]["mean_accepted"]})}
    return out


def profile_spec(prime: np.ndarray, draft: bool, warm: int = 3) -> None:
    """Where a verify iteration's time goes at B 1 (bf16, greedy, the
    500-token prime): torch.profiler over SPEC_PROFILE iterations after
    ``warm``, from the end of one verify forward to the end of another
    (a wrapper around the model's decode_chunk starts and stops it);
    device time by kernel and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16)
    prompt = torch.from_numpy(prime[None]).to(DEV)
    dp = DecodeParams(max_len=PROMPT + STEPS, steps=STEPS,
                      sampling=SamplingParams(greedy=True))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    verify = model.decode_chunk
    calls, wall = [], []

    def traced(*args):
        out = verify(*args)
        calls.append(1)
        if len(calls) in (warm, warm + SPEC_PROFILE):
            torch.cuda.synchronize()
            wall.append(time.perf_counter())
            if len(calls) == warm:
                prof.start()
            else:
                prof.stop()
        return out

    model.decode_chunk = traced
    try:
        generate_speculative(model, prompt, None, dp,
                             draft_model=model if draft else None,
                             spec=SpecParams(chunk=SPEC_CHUNK))
    finally:
        del model.decode_chunk
    if len(wall) != 2:
        raise AssertionError(f"only {len(calls)} verify forwards to profile")
    wall_us = (wall[1] - wall[0]) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    n = SPEC_PROFILE
    name = "self-draft" if draft else "lookup"
    print(f"speculative {name} profile: {n} verify iterations (B=1, bf16, "
          f"chunk {SPEC_CHUNK}), wall {wall_us / n:.1f} us/iteration under "
          f"the profiler, device busy {busy_us / n:.1f} us/iteration "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / n:8.2f} us/iteration {count / n:5.1f}x/iteration "
              f"{key[:90]}")


def speculative_paths(prime: np.ndarray) -> dict:
    """Speculative decoding end to end: cli.generate --spec, greedy
    parity with plain generation, interleaved B 1 rates."""
    model = flagship(torch.bfloat16)
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        pth, prime_mid = write_inputs(model, tmp)
        runs = spec_cli(tmp, pth, prime_mid)
    spec_parity(prime)
    rates = spec_rates(prime)
    return {"runs": runs, "rates": rates,
            "A": sum(r["A"] for r in runs.values()),
            "B": sum(r["B"] for r in runs.values()),
            "E": sum(r["E"] for r in runs.values())}


def rnn_model(family: str, dtype, seed: int = 0):
    """A GRU model at the reference's full width, random weights from a
    seed."""
    gen = torch.Generator().manual_seed(seed)
    if family == "event_rnn":
        return EventMelodyRNN(event_dim=EVENT_DIM, init_dim=INIT_DIM,
                              hidden_dim=RNN_HIDDEN, num_layers=RNN_LAYERS,
                              dtype=dtype, device=DEV, generator=gen)
    return PerformanceRNN(event_dim=EVENT_DIM, control_dim=CONTROL_DIM,
                          init_dim=INIT_DIM, hidden_dim=RNN_HIDDEN,
                          num_layers=RNN_LAYERS, dtype=dtype, device=DEV,
                          generator=gen)


def save_rnn(model, path: str) -> None:
    """The reference formats: EventMelodyRNN's bare state dict,
    PerformanceRNN's session dict (cli/export_checkpoint.py:98-133)."""
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    if model.family == "event_rnn":
        torch.save(sd, path)
        return
    torch.save({"model_config": {
        "init_dim": INIT_DIM, "event_dim": EVENT_DIM,
        "control_dim": CONTROL_DIM, "hidden_dim": RNN_HIDDEN,
        "gru_layers": RNN_LAYERS, "gru_dropout": 0.3},
        "model_state": sd, "model_optimizer_state": {}}, path)


def count_d(fn):
    """(fn(), kernel D launches during it, host seconds)."""
    torch.cuda.synchronize()
    fused_gru_step.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, fused_gru_step.launches, time.perf_counter() - t0


def rnn_prompt(family: str, prime: np.ndarray, b: int) -> torch.Tensor:
    """[b, P] prompt as cli.generate builds it: PerformanceRNN's starts
    with the primary event."""
    toks = list(prime) if family == "event_rnn" else [EVENT_DIM - 1] + list(
        prime)
    return torch.tensor([toks] * b, dtype=torch.long, device=DEV)


def rnn_conditioning(model, b: int) -> dict:
    """PerformanceRNN's latent-seeded start state and the control of
    ``PERF_CONTROL`` (none for EventMelodyRNN)."""
    if model.family == "event_rnn":
        return {}
    init = torch.randn(b, INIT_DIM, generator=torch.Generator().manual_seed(7))
    ctrl = torch.from_numpy(parse_control(PERF_CONTROL, None, 0).astype(
        np.float32))[:, None].expand(-1, b, -1)
    return {"cache0": model.init_cache(b, init=init), "controls": ctrl}


def rnn_cli(family: str, tmp: str, pth: str, prime_mid: str) -> int:
    """cli.generate on the saved checkpoint: B 8, the prime MIDI's first
    500 tokens, 512 sampled bf16 tokens (PerformanceRNN under
    ``--control``), then ``--beam 4`` and ``--stochastic-beam`` at B 1;
    kernel D's counter read around each call must equal L x the decode
    steps (prompt + steps; a beam's prompt runs to its last token).
    Returns the launches."""
    p = RNN_PROMPT + (family == "performance_rnn")
    ctrl = ["--control", PERF_CONTROL] if family == "performance_rnn" else []
    total = 0
    for name, extra, steps in (
            ("sampled", ["--batch", str(B)], p + RNN_STEPS),
            ("beam", ["--beam", str(BEAM)], p - 1 + RNN_STEPS),
            ("stochastic", ["--beam", str(BEAM), "--stochastic-beam"],
             p - 1 + RNN_STEPS)):
        out = os.path.join(tmp, f"{family}-{name}.mid")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, n, secs = count_d(lambda: cli_main(
                [pth, out, "--prime", prime_mid, "--prime-len",
                 str(RNN_PROMPT), "--steps", str(RNN_STEPS), "--dtype",
                 "bfloat16", "--seed", "0"] + extra + ctrl))
        paths = re.findall(r"wrote (\S+) \((\d+) tokens\)", buf.getvalue())
        events = [len(midilike.extract_events(path).events)
                  for path, _ in paths]
        want = B if name == "sampled" else 1
        # a beam of a random model may settle on a path without notes
        ok = (rc == 0 and n == RNN_LAYERS * steps and len(paths) == want
              and all(int(k) == RNN_STEPS for _, k in paths)
              and (name != "sampled" or min(events) > 0))
        print(f"cli.generate {family} {name} bf16 (B={want}, prime {p}, "
              f"{RNN_STEPS} steps{', beam ' + str(BEAM) if want == 1 else ''}"
              f"): {secs:.3f} s; kernel D launches {n} (expected "
              f"{RNN_LAYERS} x {steps}); {len(paths)} MIDI files read back "
              f"as {min(events)}-{max(events)} events "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cli.generate {family} {name} failed")
        total += n
    return total


def rnn_decode_rate(family: str, prime: np.ndarray) -> float:
    """Decode tokens/s at B 8, bf16, sampled, on the host clock: the
    500-token prompt plus 512 steps through ``decode.generate``, less
    the prompt alone."""
    model = rnn_model(family, torch.bfloat16)
    prompt = rnn_prompt(family, prime, B)
    kw = rnn_conditioning(model, B)

    def run(steps):
        dp = DecodeParams(max_len=prompt.shape[1] + steps, steps=steps,
                          sampling=SamplingParams())
        gen = torch.Generator(device=DEV).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompt, gen, dp, **kw)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    run(8)
    _, t_prompt = run(0)
    toks, t_all = run(RNN_STEPS)
    t = toks.cpu().numpy()
    if t.shape != (B, RNN_STEPS) or t.min() < 0 or t.max() >= EVENT_DIM:
        raise AssertionError(f"bad tokens {t.shape} [{t.min()}, {t.max()}]")
    rate = B * RNN_STEPS / (t_all - t_prompt)
    print(f"generate {family} bf16: prompt {prompt.shape[1]} tokens "
          f"{t_prompt:.3f} s, {RNN_STEPS} steps {t_all - t_prompt:.3f} s: "
          f"decode {rate:.1f} tokens/s (B={B}, host clock)")
    return rate


def rnn_greedy_parity(family: str, prime: np.ndarray) -> None:
    """Greedy f32, 64 tokens at B 8 after the 500-token prompt: the
    kernel path's tokens equal the plain path's."""
    model = rnn_model(family, torch.float32)
    prompt = rnn_prompt(family, prime, B)
    kw = rnn_conditioning(model, B)
    dp = DecodeParams(max_len=prompt.shape[1] + RNN_GREEDY, steps=RNN_GREEDY,
                      sampling=SamplingParams(greedy=True))
    kern = generate(model, prompt, None, dp, **kw)
    with plain_path():
        plain = generate(model, prompt, None, dp, **kw)
    same = torch.equal(kern, plain)
    print(f"greedy f32 {family} {RNN_GREEDY} tokens x {B}: kernel path == "
          f"plain path: {same}")
    if not same:
        first = (kern != plain).nonzero()[0].tolist()
        raise AssertionError(f"greedy tokens differ first at {first}")


def rnn_serve_requests(family: str, prime_mid: str) -> list:
    """cli.serve's 24 requests: prompts of 1-500 prime tokens, 64-768
    new tokens, four with an eos id, four with their own sampling, every
    third with an ``init_seed``; PerformanceRNN adds a single control to
    every third request and a 100-row control sequence to every third."""
    rng = np.random.default_rng(19)
    news = rng.integers(64, 769, N_SERVE)
    own = [{"temperature": 0.9, "top_k": 20}, {"top_p": 0.9},
           {"greedy": True}, {"temperature": 1.2, "top_k": 5, "top_p": 0.95}]
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"q{i:02d}", "prime": prime_mid,
             "prime_len": SERVE_PROMPTS[i % len(SERVE_PROMPTS)],
             "max_new": int(news[i])}
        if i < 4:
            r["eos"] = int(rng.integers(0, EVENT_DIM - 1))
        elif i < 8:
            r.update(own[i - 4])
        if i % 3 == 0:
            r["init_seed"] = i
        if family == "performance_rnn" and i % 3 == 1:
            r["control"] = rng.random(CONTROL_DIM).round(4).tolist()
        elif family == "performance_rnn" and i % 3 == 2:
            r["control"] = rng.random((100, CONTROL_DIM)).round(4).tolist()
        reqs.append(r)
    return reqs


def rnn_serve_file_mode(family: str, tmp: str, pth: str,
                        prime_mid: str) -> tuple:
    """cli.serve in file mode with its defaults (8 slots, segments of
    64, depth 2, boost 8), bf16; kernel D's launches must be L x (decode
    steps + admission prefill steps). Returns (launches, summary)."""
    reqs = rnn_serve_requests(family, prime_mid)
    path = os.path.join(tmp, f"{family}-requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir = os.path.join(tmp, f"{family}-served")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, n, secs = count_d(lambda: serve_main(
            [pth, path, outdir, "--dtype", "bfloat16", "--seed", "0"]))
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    stat = {k: int(re.search(rf"(\d+) {k}", summary).group(1))
            for k in ("decode steps", "prefill steps", "admission calls")}
    written = dict(re.findall(r"wrote .*/(q\d\d)\.mid \((\d+) tokens\)", out))
    n_events = [len(midilike.extract_events(
        os.path.join(outdir, f"{r['id']}.mid")).events) for r in reqs]
    exact = all(int(written[r["id"]]) == r["max_new"] for r in reqs
                if "eos" not in r)
    cut = all(int(written[r["id"]]) <= r["max_new"] for r in reqs)
    expect = RNN_LAYERS * (stat["decode steps"] + stat["prefill steps"])
    print(f"cli.serve {family} bf16 file mode ({N_SERVE} requests, slots "
          f"{SLOTS}, seg {SEG}, depth {DEPTH}, boost {RNN_BOOST}) in "
          f"{secs:.3f} s (load, warm, serve, write): {summary}")
    print(f"  {len(written)} MIDI files read back as {min(n_events)}-"
          f"{max(n_events)} events; kernel D launches {n} ({RNN_LAYERS} x "
          f"({stat['decode steps']} decode + {stat['prefill steps']} "
          f"prefill steps) = {expect})")
    ok = (rc == 0 and len(written) == N_SERVE and exact and cut
          and n == expect and max(n_events) > 0)
    if not ok:
        raise AssertionError(f"cli.serve {family}: rc {rc}, {len(written)} "
                             f"files, launches {n} vs {expect}, {stat}")
    return n, summary


def rnn_serve_parity(family: str, prime: np.ndarray) -> None:
    """Greedy f32 serving of 8 staggered requests (3 admitted mid-flight;
    PerformanceRNN with latents and controls) through kernel D and
    through its plain version: the tokens must be equal."""
    model = rnn_model(family, torch.float32)
    lens = (1, 3, 64, 200, 500, 17, 100, 33)
    news = (64, 128, 96, 64, 100, 80, 128, 72)
    rng = np.random.default_rng(23)
    kws = []
    for i in range(len(lens)):
        kw = {"init": rng.standard_normal(INIT_DIM)} if i % 2 else {}
        if family == "performance_rnn" and i % 3:
            kw["control"] = rng.random((1 + 40 * (i % 3 - 1), CONTROL_DIM))
        kws.append(kw)
    prompts = [rnn_prompt(family, prime[:p], 1)[0].cpu().numpy()
               for p in lens]
    outs = []
    for plain in (False, True):
        cb = RNNContinuousBatcher(model, slots=SLOTS, seg_len=SEG,
                                  depth=DEPTH, boost=RNN_BOOST,
                                  sampling=SamplingParams(greedy=True))
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(prompts[i], news[i], **kws[i])
                    for i in range(5)]
            cb.step()
            rids += [cb.submit(prompts[i], news[i], **kws[i])
                     for i in range(5, len(lens))]
            done = cb.run()
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"serving {family} greedy f32, {len(lens)} staggered requests: "
          f"kernel path == plain path: {same}")
    if not same:
        raise AssertionError(f"{family}: served greedy tokens differ from "
                             "the plain path's")


def rnn_paths(prime: np.ndarray) -> dict:
    """Both GRU families end to end: cli.generate, the decode rate,
    greedy parity, cli.serve and serving parity."""
    launches, rates, serve = {}, {}, {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        prime_mid = os.path.join(tmp, "prime.mid")
        write_midi(np.random.default_rng(0).integers(0, EVENT_DIM - 1, 3000),
                   prime_mid)
        rnn_prime_toks = np.asarray(prime_tokens(prime_mid, RNN_PROMPT))
        if len(rnn_prime_toks) != RNN_PROMPT:
            raise AssertionError("the prime MIDI gives too few tokens")
        for family in ("event_rnn", "performance_rnn"):
            pth = os.path.join(tmp, f"{family}.pth")
            save_rnn(rnn_model(family, torch.float32), pth)
            gen_n = rnn_cli(family, tmp, pth, prime_mid)
            rates[family] = rnn_decode_rate(family, rnn_prime_toks)
            rnn_greedy_parity(family, rnn_prime_toks)
            serve_n, serve[family] = rnn_serve_file_mode(family, tmp, pth,
                                                         prime_mid)
            rnn_serve_parity(family, rnn_prime_toks)
            launches[f"generate_{family}"] = gen_n
            launches[f"serve_{family}"] = serve_n
    return {"launches": launches, "tok_s": rates, "serve": serve}


def profile_rnn_decode(steps: int = 32, warm: int = 3) -> None:
    """Where an EventMelodyRNN bf16 decode step's time goes at B 8:
    device time by kernel and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    model = rnn_model("event_rnn", torch.bfloat16)
    cache = model.init_cache(B)
    tok = torch.randint(0, EVENT_DIM, (B,), device=DEV,
                        generator=torch.Generator(DEV).manual_seed(5))
    for _ in range(warm):
        logits, cache = model.decode_step(tok, cache)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = model.decode_step(tok, cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    print(f"event_rnn decode profile: {steps} steps (decode_step + argmax, "
          f"B={B}, bf16), wall {wall_us / steps:.1f} us/step under the "
          f"profiler, device busy {busy_us / steps:.1f} us/step "
          f"({100 * busy_us / wall_us:.1f}% of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / steps:8.2f} us/step {count / steps:4.1f}x/step "
              f"{key[:90]}")


def gru_bound(b: int, in_dim: int, dtype) -> tuple:
    """Least time of one GRU step at full width: the weights (rows of
    their true width), biases, x and h read once, the new h written;
    2 * b * 3H * (in_l + H) operations per layer."""
    e = torch.finfo(dtype).bits // 8
    hd, nl = RNN_HIDDEN, RNN_LAYERS
    widths = [in_dim] + [hd] * (nl - 1)
    w_elems = sum(3 * hd * (w + hd) for w in widths)
    nbytes = (w_elems * e + 2 * nl * 3 * hd * 4 + b * in_dim * e
              + 2 * nl * b * hd * e)
    flops = sum(2 * b * 3 * hd * (w + hd) for w in widths)
    return bound(nbytes, flops, dtype)


def time_kernel_d(launches: int, err: float) -> dict:
    """Kernel D in bf16 at EventMelodyRNN's shape (in 308) and
    PerformanceRNN's (in 512), H 512, 3 layers, B 8 and B 1: device time
    warm (weights in L2) and with L2 flushed before each call (weights
    from device memory, what the bound counts); its plain version;
    torch.nn.GRU (cuDNN) over one time step, the same function."""
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(31)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    res = {}
    for family, in_dim in (("event_rnn", EVENT_DIM),
                           ("performance_rnn", RNN_HIDDEN)):
        for b in (B, 1):
            x, h, w = gru_inputs(b, in_dim, RNN_HIDDEN, RNN_LAYERS, dtype,
                                 gen)

            def step():
                return fused_gru_step(x, h, w)
            warm = device_ms(step)
            cold = device_ms(step, flush=flush)
            bnd, by = gru_bound(b, in_dim, dtype)
            res[(family, b)] = (warm, cold, bnd, by, x, h, w)
            print(f"kernel D bf16 {family} in={in_dim} B={b}: warm "
                  f"{warm:.5f} ms, L2 flushed {cold:.5f} ms; bound "
                  f"{bnd:.5f} ms ({by}, weights from device memory)")
    warm, cold, bnd, by, x, h, w = res[("event_rnn", B)]
    plain_ms = device_ms(lambda: fused_gru_step_plain(x, h, w), iters=20)
    library = {}
    for name, ldt in (("bf16", dtype), ("f32", torch.float32)):
        gru = torch.nn.GRU(EVENT_DIM, RNN_HIDDEN, RNN_LAYERS).to(DEV, ldt)
        gru.flatten_parameters()   # one weight buffer, as cuDNN wants it
        xs, h0 = x[None].to(ldt), h.to(ldt)
        try:
            with torch.no_grad():
                library[name] = device_ms(lambda: gru(xs, h0))
        except RuntimeError as e:      # a yardstick only; never on the path
            print(f"torch.nn.GRU {name}: {e}")
            library[name] = None
    print(f"torch.nn.GRU (cuDNN) one step, in={EVENT_DIM} B={B} L="
          f"{RNN_LAYERS}: bf16 {library['bf16']} ms, f32 {library['f32']} "
          f"ms (warm)")
    return {"name": "fused_gru_step", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_gru_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_gru_decode.py:108",
            "launches": launches, "max_abs_err": err, "ms": cold,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library["bf16"], "ms_warm": warm,
            "library_ms_f32": library["f32"],
            "ms_b1": res[("event_rnn", 1)][1],
            "ms_b1_warm": res[("event_rnn", 1)][0],
            "bound_ms_b1": res[("event_rnn", 1)][2],
            "ms_performance_rnn": res[("performance_rnn", B)][1],
            "ms_performance_rnn_warm": res[("performance_rnn", B)][0],
            "bound_ms_performance_rnn": res[("performance_rnn", B)][2],
            "ms_performance_rnn_b1": res[("performance_rnn", 1)][1],
            "ms_performance_rnn_b1_warm": res[("performance_rnn", 1)][0]}


def write_corpus(tmp: str) -> str:
    """Synthetic MIDI files written with the port's MIDI writer (each
    long enough for a seq_len+1 crop), tokenized by ``cli.tokenize``.
    Returns the shard directory."""
    midis = os.path.join(tmp, "midis")
    os.makedirs(midis)
    rng = np.random.default_rng(11)
    for i in range(N_MIDI):
        write_midi(rng.integers(0, VOCAB - 1, 3000),
                   os.path.join(midis, f"train-{i:02d}.mid"))
    shards = os.path.join(tmp, "tok")
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "tokenize.log")):
        rc = tokenize_main([midis, shards, "--workers", "1"])
    corpus = TokenCorpus(shards, limlen=L_TRAIN + 1)
    print(f"cli.tokenize: {N_MIDI} MIDI files -> {len(corpus)} sequences > "
          f"{L_TRAIN} tokens (shortest {corpus.lengths().min()}) in "
          f"{time.perf_counter() - t0:.1f} s")
    if rc != 0 or len(corpus) != N_MIDI:
        raise AssertionError("cli.tokenize lost files")
    return shards


@contextlib.contextmanager
def quiet(path: str):
    """Send a CLI's per-step JSON lines to a file instead of stdout."""
    with open(path, "a") as f, contextlib.redirect_stdout(f):
        yield


def train_args(shards: str, run: str, steps: int, *extra) -> list:
    """cli.train at the flagship's full width in its default crop mode:
    B 8, seq_len 512, 6 layers, d_model 256, bf16, dropout 0.1."""
    return [shards, f"steps={steps}", f"batch_size={B}",
            f"seq_len={L_TRAIN}", "model.dtype=bfloat16",
            f"ckpt_dir={run}", f"ckpt_every={CKPT_EVERY}", "log_every=1",
            f"metrics_path={run}.jsonl", *extra]


def losses(path: str) -> dict:
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)
                if r["kind"] == "train"}


def train_parity(shards: str) -> None:
    """One cli.train-equivalent step at full width in f32 (dropout 0,
    TF32 off) through kernels A and C against one step through their
    plain versions, from the same weights and batch."""
    cfg = apply_overrides(train_cli.TrainCLIConfig(),
                          [f"batch_size={B}", f"seq_len={L_TRAIN}"])
    kw = {"dtype": "float32", "dropout_rate": 0.0}
    corpus = TokenCorpus(shards, limlen=L_TRAIN + 1)
    x, y = (torch.from_numpy(a).to(DEV)
            for a in train_cli._lm_batch_fn(corpus, cfg)(0))
    results = []
    for plain in (False, True):
        model, tcfg = train_cli.build_model(cfg, "midilike", kw, DEV)
        tx = make_optimizer(tcfg)
        state = create_train_state(model, tx, dropout_seed=cfg.seed)
        step = make_train_step(tx, tcfg)
        fused_relative_attention.launches = 0
        fused_relative_attention_bwd.launches = 0
        with plain_path() if plain else contextlib.nullcontext():
            state, m = step(state, x, y)
        torch.cuda.synchronize()
        launches = (fused_relative_attention.launches,
                    fused_relative_attention_bwd.launches)
        if launches != ((0, 0) if plain else (N_LAYERS, N_LAYERS)):
            raise AssertionError(f"parity step launched A, C {launches}")
        results.append((state, m))
    (sk, mk), (sp, mp) = results
    lr = tx.lr(0)
    errs = {k: abs(mk[k] - mp[k]) / abs(mp[k])
            for k in ("loss", "grad_norm")}
    mom = {}
    for what in ("mu", "nu"):
        a, r = getattr(sk.opt_state, what), getattr(sp.opt_state, what)
        floor = max(t.abs().max().item() for t in r)
        mom[what] = max(((u - v).abs().max().item()
                         / (TOL_MOMENT * v.abs().max().item()
                            + 1e-6 * floor)) for u, v in zip(a, r))
    perr = max((p - q).abs().max().item() for p, q in
               zip(sk.model.parameters(), sp.model.parameters()))
    ok = (errs["loss"] <= 1e-5 and errs["grad_norm"] <= 1e-4
          and max(mom.values()) <= 1.0 and perr <= 2 * lr + 1e-6)
    print(f"train-step parity f32 (B{B} L{L_TRAIN}, full width): loss "
          f"{mk['loss']:.6f} vs {mp['loss']:.6f} (rel {errs['loss']:.1e}, "
          f"tol 1e-5); grad_norm {mk['grad_norm']:.6f} vs "
          f"{mp['grad_norm']:.6f} (rel {errs['grad_norm']:.1e}, tol 1e-4); "
          f"Adam mu/nu err {mom['mu']:.2f}/{mom['nu']:.2f} of tolerance "
          f"({TOL_MOMENT:.0e} of each tensor's max + 1e-6 of the largest); "
          f"params max diff {perr:.2e} (tol 2*lr+1e-6 = {2 * lr + 1e-6:.2e}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the kernel train step disagrees with the "
                             "plain one")


def train_end_to_end(tmp: str, shards: str) -> dict:
    """cli.train at full width for TRAIN_STEPS steps (launch counters of
    kernels A and C read around it), the same run interrupted at step
    CUT and resumed, and cli.generate from the checkpoint directory."""
    full = os.path.join(tmp, "full")
    torch.cuda.synchronize()
    fused_relative_attention.launches = 0
    fused_relative_attention_bwd.launches = 0
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "train.log")):
        train_cli.main(train_args(shards, full, TRAIN_STEPS))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (fused_relative_attention.launches,
                fused_relative_attention_bwd.launches)
    ref = losses(full + ".jsonl")
    finite = (sorted(ref) == list(range(TRAIN_STEPS))
              and all(math.isfinite(v) for v in ref.values()))
    print(f"cli.train bf16 B{B} L{L_TRAIN} {TRAIN_STEPS} steps in "
          f"{secs:.1f} s (start-up included): loss {ref[0]:.4f} -> "
          f"{ref[TRAIN_STEPS - 1]:.4f}, all finite: {finite}; launches "
          f"kernel A={launches[0]} kernel C={launches[1]} (expected "
          f"{N_LAYERS * TRAIN_STEPS} each: {N_LAYERS} layers x "
          f"{TRAIN_STEPS} steps, one kernel C call per layer backward)")
    if not finite:
        raise AssertionError("cli.train gave a non-finite or missing loss")
    if launches != (N_LAYERS * TRAIN_STEPS,) * 2:
        raise AssertionError(f"kernel launches {launches}")

    # interrupt at batch CUT (a KeyboardInterrupt from the data stream,
    # as a SIGINT would arrive), then resume from the checkpoint
    cut = os.path.join(tmp, "cut")
    requested = []
    real = train_cli._lm_batch_fn

    def recording(stop_at):
        def fn(corpus, cfg):
            at = real(corpus, cfg)

            def batch_at(idx):
                requested.append(idx)
                if idx == stop_at:
                    raise KeyboardInterrupt
                return at(idx)
            return batch_at
        return fn

    try:
        with quiet(os.path.join(tmp, "train.log")):
            train_cli._lm_batch_fn = recording(CUT)
            train_cli.main(train_args(shards, cut, TRAIN_STEPS))
            saved = [s for s, _ in list_checkpoints(cut)]
            requested.clear()
            train_cli._lm_batch_fn = recording(-1)
            train_cli.main(train_args(shards, cut, TRAIN_STEPS))
    finally:
        train_cli._lm_batch_fn = real
    resumed = losses(cut + ".jsonl")
    diff = max(abs(resumed[s] - ref[s]) for s in range(TRAIN_STEPS))
    ok = (saved[-1] == CUT - 1 and min(requested) == CUT
          and sorted(resumed) == list(range(TRAIN_STEPS)) and diff <= 1e-3)
    print(f"interrupt at step {CUT}: checkpoints {saved}; the resumed run "
          f"starts at batch {min(requested)}; its losses vs the "
          f"uninterrupted run's: max |diff| {diff:.2e} (tol 1e-3) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("resume did not replay the uninterrupted run")

    out = os.path.join(tmp, "trained.mid")
    prime = os.path.join(tmp, "midis", "train-00.mid")
    with quiet(os.path.join(tmp, "generate.log")):
        cli_main([cut, out, "--prime", prime, "--prime-len",
                  str(GEN_PRIME), "--steps", str(GEN_STEPS), "--batch", "2",
                  "--dtype", "bfloat16", "--seed", "1"])
    n_events = [len(midilike.extract_events(
        os.path.join(tmp, f"trained-{i:03d}.mid")).events) for i in range(2)]
    print(f"cli.generate from the checkpoint directory (step "
          f"{list_checkpoints(cut)[-1][0]}, bf16, prime {GEN_PRIME} tokens "
          f"bucketed, {GEN_STEPS} steps, batch 2): MIDI files re-read as "
          f"{n_events} events")
    if min(n_events) == 0:
        raise AssertionError("generated MIDI has no events")
    return {"A": launches[0], "C": launches[1]}


def train_batches(n: int, shards: str):
    cfg = apply_overrides(train_cli.TrainCLIConfig(),
                          [f"batch_size={B}", f"seq_len={L_TRAIN}"])
    corpus = TokenCorpus(shards, limlen=L_TRAIN + 1)
    at = train_cli._lm_batch_fn(corpus, cfg)
    return cfg, [tuple(torch.from_numpy(a).to(DEV) for a in at(i))
                 for i in range(n)]


def time_train_step(shards: str) -> dict:
    """Warm train steps (bf16, dropout 0.1, full width) timed with CUDA
    events, then a torch.profiler window over PROFILE_STEPS steps:
    device time by kernel group and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    warm, timed = 5, 25
    cfg, batches = train_batches(warm + timed + PROFILE_STEPS, shards)
    model, tcfg = train_cli.build_model(cfg, "midilike",
                                          {"dtype": "bfloat16"}, DEV)
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=cfg.seed)
    step = make_train_step(tx, tcfg)
    for x, y in batches[:warm]:
        state, _ = step(state, x, y)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x, y in batches[warm:warm + timed]:
        state, _ = step(state, x, y)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    tok_s = B * L_TRAIN / (ms / 1e3)
    print(f"train step bf16 B{B} L{L_TRAIN} (full width, dropout 0.1): "
          f"{ms:.3f} ms/step, {1e3 / ms:.2f} steps/s, {tok_s:.0f} tokens/s "
          f"over {timed} warm steps (CUDA events) on {gpu_line()}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for x, y in batches[warm + timed:]:
            state, _ = step(state, x, y)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, groups = device_rows(prof), {}
    for dev_us, _, key in rows:
        g = kernel_group(key)
        groups[g] = groups.get(g, 0.0) + dev_us
    busy = sum(groups.values())
    n = PROFILE_STEPS
    print(f"train profile: {n} steps, wall {wall_us / n / 1e3:.3f} ms/step "
          f"under the profiler, device busy {busy / n / 1e3:.3f} ms/step "
          f"({100 * busy / wall_us:.1f}% of wall)")
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:34s} {us / n / 1e3:8.3f} ms/step "
              f"({100 * us / busy:5.1f}% of device time)")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  {dev_us / n:9.1f} us/step {count / n:6.1f}x/step "
              f"{key[:80]}")
    return {"step_ms": ms, "tok_s": tok_s}


def kernel_group(name: str) -> str:
    if "rel_attn_fwd" in name:
        return "kernel A (attention forward)"
    if "rel_attn_bwd" in name:
        return "kernel C (attention backward)"
    if any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMMs (cuBLAS)"
    if "foreach" in name or "multi_tensor" in name:
        return "optimizer (foreach)"
    return "other (elementwise, LN, CE, copies)"


def time_kernel_c(launches: int, err: float) -> dict:
    """Kernel C at the training shape (B8 H4 L512 bf16, causal, max_seq
    512), its plain version, its bound, and SDPA forward + backward with
    the relative bias materialised as a grad-requiring attn_mask."""
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    q, k, v, _, _ = attn_inputs(dtype, gen, False, L_TRAIN)
    e = torch.randn(L_TRAIN, DH, generator=gen).to(DEV)
    dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
    out, lse = fused_relative_attention(q, k, v, e, None, True,
                                        return_lse=True)
    ms = device_ms(lambda: fused_relative_attention_bwd(q, k, v, e, None,
                                                        True, out, lse, dout))
    plain_ms = device_ms(lambda: fused_relative_attention_bwd_plain(
        q, k, v, e, None, True, out, lse, dout), iters=5)
    # yardstick: SDPA forward + backward, the relative bias (and causal
    # mask) as a grad-requiring attn_mask; building it and gathering dE
    # from its gradient are left out of the time
    t = torch.arange(L_TRAIN, device=DEV)
    idx = (L_TRAIN - 1 - t[:, None] + t[None, :]).clamp(0, L_TRAIN - 1)
    srel = torch.einsum("bhld,lsd->bhls", q.float(),
                        e.to(dtype).float()[idx])
    causal = t[None, :] > t[:, None]
    bias = (srel.masked_fill(causal, 0.0) / math.sqrt(DH)
            + causal.float() * -1e9).to(dtype).requires_grad_()
    ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
    f = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd_bwd():
        torch.autograd.backward(f(ql, kl, vl, attn_mask=bias), dout)

    library_ms = device_ms(sdpa_fwd_bwd)
    bh, l = B * H, L_TRAIN
    elems = bh * l * DH
    # read q, k, v, O, dO (bf16), lse (f32), E (f32); write dQ, dK, dV
    # (bf16), dE (f32)
    nbytes = 8 * elems * 2 + bh * l * 4 + 2 * l * DH * 4
    # per causal (t, s <= t) pair, eight 64-deep products: the recomputed
    # q.k and q.E, dO.v, and the dV, dK, dQ (K and E legs) and dE sums
    flops = 8 * 2 * DH * bh * l * (l + 1) / 2
    bound_ms, by = bound(nbytes, flops, dtype)
    return {"name": "relative_attention_bwd", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/relative_attention_bwd.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_attention.py:755",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms}


def time_kernel_a(launches: int, err: float) -> dict:
    dtype = torch.bfloat16
    q, k, v, e, pad = attn_inputs(dtype, torch.Generator().manual_seed(3),
                                  True)
    ms = device_ms(lambda: fused_relative_attention(q, k, v, e, pad))
    plain_ms = device_ms(
        lambda: fused_relative_attention_plain(q, k, v, e, pad), iters=5)
    # yardstick: SDPA with the relative bias and both masks materialized
    # as attn_mask; building that mask is left out of the time
    t = torch.arange(L_PREFILL, device=DEV)
    idx = (MAX_SEQ - 1 - t[:, None] + t[None, :]).clamp(0, MAX_SEQ - 1)
    srel = torch.einsum("bhld,lsd->bhls", q.float(),
                        e.to(dtype).float()[idx])
    srel = srel.masked_fill(t[None, :] > t[:, None], 0.0)
    mask = (srel / math.sqrt(DH)
            + (t[None, :] > t[:, None]).float() * -1e9
            + pad[:, None, None, :] * -1e9).to(dtype)
    f = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: f(q, k, v, attn_mask=mask))
    bh, l = B * H, L_PREFILL
    nbytes = (3 * bh * l * DH * 2 + l * DH * 4 + B * l * 4
              + bh * l * DH * 2 + bh * l * 4)
    flops = 3 * 2 * DH * bh * l * (l + 1) / 2
    bound_ms, by = bound(nbytes, flops, dtype)
    return {"name": "relative_attention_fwd", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/relative_attention.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_attention.py:345",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms}


def time_kernel_b(launches: int, err: float) -> dict:
    model = flagship(torch.bfloat16)
    t = T_TIMED
    x, e_all, w_all, kc, vc = decode_inputs(model,
                                            torch.Generator().manual_seed(4))
    ms = device_ms(lambda: fused_decode_step(x, t, e_all, w_all, kc, vc, H),
                   iters=50)
    plain_ms = device_ms(lambda: fused_decode_step_plain(x, t, e_all, w_all,
                                                         kc, vc, H), iters=10)
    bound_ms, by = decode_bound(np.zeros(B, np.int64), t)
    return {"name": "fused_decode_step", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1171",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


def weight_bytes(d: int, int8: bool) -> int:
    """Bytes of the six layers' bf16 decode weights (FFN d / 2), or with
    the six matrices in int8 plus their f32 scale tables (one per output
    column)."""
    f = d // 2
    mats, vecs = 4 * d * d + 2 * d * f, 9 * d + f
    if int8:
        return N_LAYERS * (mats + 2 * vecs + 4 * (5 * d + f))
    return N_LAYERS * 2 * (mats + vecs)


def decode_bound(starts: np.ndarray, t: int, d: int = D_MODEL,
                 int8: bool = False) -> tuple:
    """Least time of one bf16 decode step at position t whose rows attend
    [start_b, t]: weights (``weight_bytes``), the live K/V rows and the E
    rows they need read once, x read and written, the new K/V rows
    written; the qkv, output and FFN products plus three 64-deep products
    per live row and head."""
    f, heads = d // 2, d // DH
    live = int(np.sum(t + 1 - starts))          # (b, s) pairs attended
    e_rows = t + 1 - int(starts.min())
    nbytes = (weight_bytes(d, int8) + 2 * N_LAYERS * live * d * 2
              + N_LAYERS * e_rows * DH * 4 + 2 * len(starts) * d * 2
              + 2 * N_LAYERS * len(starts) * d * 2)
    flops = N_LAYERS * (2 * len(starts) * (4 * d * d + 2 * d * f)
                        + 3 * 2 * heads * live * DH)
    return bound(nbytes, flops, torch.bfloat16)


def time_kernel_b_ragged(launches: int, err: float) -> dict:
    """Ragged kernel B at t T_RAGGED, every row's start in the last LIVE
    rows, under start_min 0 (every split launched) and min(start) (only
    the live splits), beside the bound of that data and of the full
    prefix [0, t] for every row."""
    model = flagship(torch.bfloat16)
    gen = torch.Generator().manual_seed(13)
    t = T_RAGGED
    x, e_all, w_all, kc, vc = decode_inputs(model, gen)
    start = torch.randint(t - LIVE + 1, t + 1, (B,), generator=gen)
    start[0] = t - LIVE + 1
    start = start.to(torch.int32).to(DEV)
    smin = int(start.min())

    def step(floor):
        return fused_decode_step(x, t, e_all, w_all, kc, vc, H, start=start,
                                 start_min=floor)

    ms0 = device_ms(lambda: step(0), iters=50)
    ms = device_ms(lambda: step(smin), iters=50)
    plain_ms = device_ms(lambda: fused_decode_step_plain(
        x, t, e_all, w_all, kc, vc, H, start=start, start_min=smin), iters=10)
    bound_ms, by = decode_bound(start.cpu().numpy(), t)
    full_ms, _ = decode_bound(np.zeros(B, np.int64), t)
    print(f"ragged kernel B bf16 B{B} t={t}, live window {LIVE} rows "
          f"(min(start) {smin}): start_min 0 {ms0:.4f} ms, start_min "
          f"{smin} {ms:.4f} ms; bound {bound_ms:.5f} ms ({by}) for this "
          f"live window, {full_ms:.5f} ms for the full prefix [0, t]")
    return {"name": "fused_decode_step_ragged", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1171",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "ms_start_min_0": ms0,
            "bound_ms_full_prefix": full_ms}


def chunk_bound(b: int, c: int, t: int, int8: bool = False) -> tuple:
    """Least time of one bf16 verify forward of c tokens at t: the six
    layers' weights once (``weight_bytes``), the K/V rows [0, t+c) of
    each batch row, the E rows they need (t+c per layer), x read and the
    output written, the chunk's K/V rows written; the qkv, output and
    FFN products of b*c rows plus three 64-deep products per (query,
    live row) pair."""
    d, f = D_MODEL, D_MODEL // 2
    pairs = b * sum(t + i + 1 for i in range(c))
    nbytes = (weight_bytes(d, int8) + 2 * N_LAYERS * b * (t + c) * d * 2
              + N_LAYERS * (t + c) * DH * 4 + 2 * b * c * d * 2
              + 2 * N_LAYERS * b * c * d * 2)
    flops = N_LAYERS * (2 * b * c * (4 * d * d + 2 * d * f)
                        + 3 * 2 * H * pairs * DH)
    return bound(nbytes, flops, torch.bfloat16)


def time_kernel_e(launches: int, err: float) -> dict:
    """Kernel E in bf16 at the speculative path's shape (C 8, t 755, the
    flagship width) at B 1 and B 8: device time, its plain version, its
    bound; beside it one kernel-B step at the same B and t. No single
    PyTorch call computes the chunk forward (library null)."""
    model = flagship(torch.bfloat16)
    stacked = model.decode_weights()
    gen = torch.Generator(DEV).manual_seed(16)
    t, c = T_TIMED, SPEC_CHUNK
    res = {}
    for b in (1, B):
        x, e_all, w_all, kc, vc = chunk_inputs(model, stacked, gen, b, c,
                                               1024)
        ms = device_ms(lambda: fused_decode_chunk(x, t, e_all, w_all, kc, vc,
                                                  H), iters=50)
        plain_ms = device_ms(lambda: fused_decode_chunk_plain(
            x, t, e_all, w_all, kc, vc, H), iters=10)
        x1 = x[:, 0].contiguous()
        step_ms = device_ms(lambda: fused_decode_step(x1, t, e_all, w_all, kc,
                                                      vc, H), iters=50)
        bnd, by = chunk_bound(b, c, t)
        res[b] = (ms, plain_ms, step_ms, bnd, by)
        print(f"kernel E bf16 B={b} C={c} t={t}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bnd:.5f} ms ({by}); one kernel-B "
              f"step at B={b} t={t}: {step_ms:.4f} ms")
    ms, plain_ms, step_ms, bnd, by = res[1]
    return {"name": "fused_decode_chunk", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1487",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "ms_b8": res[B][0], "plain_ms_b8": res[B][1],
            "bound_ms_b8": res[B][3], "kernel_b_step_ms_b1": step_ms,
            "kernel_b_step_ms_b8": res[B][2]}


# ------------------------------------------------ weight-only int8 (B, E)

def int8_refusals(model) -> None:
    """Kernels B and E given int8 weights without their scales raise
    before launching anything."""
    gen = torch.Generator().manual_seed(23)
    x, e_all, w_all, kc, vc = decode_inputs(model, gen)
    qw = w_all["int8"][0]
    xc = torch.stack([x] * SPEC_CHUNK, 1)
    reset_counts()
    for name, fn in (
            ("B", lambda: fused_decode_step(x, T_TIMED, e_all, qw, kc, vc, H)),
            ("E", lambda: fused_decode_chunk(xc, T_TIMED, e_all, qw, kc, vc,
                                             H))):
        try:
            fn()
        except ValueError as e:
            if "scales" not in str(e):
                raise
            print(f"kernel {name} with int8 weights and no scales raises: "
                  f"{e}")
        else:
            raise AssertionError(f"kernel {name} took int8 weights without "
                                 "their scales")
    n = (fused_decode_step.launches + fused_decode_step.int8_launches
         + fused_decode_chunk.launches + fused_decode_chunk.int8_launches)
    if n:
        raise AssertionError(f"a refused call launched {n} kernels")


def check_step_int8(model, gen, t: int, ragged: bool, label: str) -> float:
    """One int8 kernel-B call against its plain int8 version on the same
    inputs (output and cache row t within TOL_B, every other row
    untouched) and against the unquantized kernel (TOL_INT8_REL).
    Returns the max abs error against the plain version."""
    x, e_all, w_all, kc, vc = decode_inputs(model, gen)
    qw, sc = w_all["int8"]
    heads = model.num_heads
    kw = {}
    if ragged:
        start = ragged_starts(gen, t).to(DEV)
        kw = {"start": start, "start_min": int(start.min())}
    kc2, vc2, kc3, vc3 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, kc, vc = fused_decode_step(x, t, e_all, qw, kc, vc, heads,
                                    scales=sc, **kw)
    ref, kc2, vc2 = fused_decode_step_plain(x, t, e_all, qw, kc2, vc2, heads,
                                            scales=sc, **kw)
    full, _, _ = fused_decode_step(x, t, e_all, w_all, kc3, vc3, heads, **kw)
    torch.cuda.synchronize()
    err = max((out.float() - ref.float()).abs().max().item(),
              (kc[:, :, t].float() - kc2[:, :, t].float()).abs().max().item(),
              (vc[:, :, t].float() - vc2[:, :, t].float()).abs().max().item())
    rel = rel_err(out, full)
    tol = TOL_B[model.dtype]
    ok = (err <= tol and rel < TOL_INT8_REL and untouched(kc, kc2, t)
          and untouched(vc, vc2, t) and bool(torch.isfinite(out).all()))
    extra = f" start_min={kw['start_min']}" if ragged else ""
    print(f"kernel B int8 {label} {str(model.dtype):15s} d={model.d_model} "
          f"B={x.shape[0]} t={t}{extra}: max_abs_err {err:.3e} (tol "
          f"{tol:.1e}); vs unquantized {rel:.3e} relative (< "
          f"{TOL_INT8_REL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"int8 kernel B ({label}) disagrees")
    return err


def check_chunk_int8(model, gen, b: int, t: int) -> float:
    """One int8 kernel-E call (C SPEC_CHUNK) against its plain int8
    version (TOL_B, rows outside [t, t+C) untouched), against the
    unquantized kernel E (TOL_INT8_REL) and against C chained int8
    kernel-B steps, bit for bit. Returns the error against plain."""
    c = SPEC_CHUNK
    w_all, e_all = model.decode_weights()
    x, e_all, w_all, kc, vc = chunk_inputs(model, (w_all, e_all), gen, b, c,
                                           1024)
    qw, sc = w_all["int8"]
    kc0, vc0 = kc.clone(), vc.clone()
    kc2, vc2, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, kc, vc = fused_decode_chunk(x, t, e_all, qw, kc, vc, H, scales=sc)
    ref, kc2, vc2 = fused_decode_chunk_plain(x, t, e_all, qw, kc2, vc2, H,
                                             scales=sc)
    full, _, _ = fused_decode_chunk(x, t, e_all, w_all, kc0.clone(),
                                    vc0.clone(), H)
    steps = []
    for i in range(c):
        o, kb, vb = fused_decode_step(x[:, i].contiguous(), t + i, e_all, qw,
                                      kb, vb, H, scales=sc)
        steps.append(o)
    torch.cuda.synchronize()
    err = max((out.float() - ref.float()).abs().max().item(),
              (kc[:, :, t:t + c].float() - kc2[:, :, t:t + c].float()).abs()
              .max().item(),
              (vc[:, :, t:t + c].float() - vc2[:, :, t:t + c].float()).abs()
              .max().item())
    rel = rel_err(out, full)
    same = all(untouched(a, a0, t, c) for a, a0 in (
        (kc, kc0), (vc, vc0), (kc2, kc0), (vc2, vc0)))
    chained = (torch.equal(out, torch.stack(steps, 1)) and torch.equal(kc, kb)
               and torch.equal(vc, vb))
    tol = TOL_B[model.dtype]
    ok = err <= tol and rel < TOL_INT8_REL and same and chained
    print(f"kernel E int8 {str(model.dtype):15s} B={b} C={c} t={t}: "
          f"max_abs_err {err:.3e} (tol {tol:.1e}); vs unquantized {rel:.3e} "
          f"relative; == {c} chained int8 kernel-B steps bit for bit: "
          f"{chained}; other rows untouched: {same} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("int8 kernel E disagrees")
    return err


def check_int8_kernels() -> dict:
    """The int8 modes of kernels B (non-ragged at t 755, ragged at t 1023
    with start_min = min(start)) and E (C 8, B 1 and 8, t 755) at the
    flagship's shapes, f32 and bf16; the refusals. Returns the worst
    bf16 error of each mode."""
    gen = torch.Generator().manual_seed(21)
    dgen = torch.Generator(DEV).manual_seed(22)
    worst = {"B": 0.0, "B_ragged": 0.0, "E": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype, quant="int8")
        errs = {"B": check_step_int8(model, gen, T_TIMED, False, "non-ragged"),
                "B_ragged": check_step_int8(model, gen, T_RAGGED, True,
                                            "ragged"),
                "E": max(check_chunk_int8(model, dgen, b, T_TIMED)
                         for b in (1, B))}
        if dtype == torch.bfloat16:
            worst = errs
    int8_refusals(flagship(torch.bfloat16, quant="int8"))
    return worst


def check_kernel_b_rung() -> None:
    """Kernel B at the d 1024 rung (16 heads, FFN 512; B 8, t 755), which
    no earlier run took to the card: model-dtype and int8 weights against
    their plain versions, f32 and bf16."""
    gen = torch.Generator().manual_seed(24)
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype, quant="int8", d_model=D_RUNG)
        x, e_all, w_all, kc, vc = decode_inputs(model, gen)
        heads = model.num_heads
        kc2, vc2 = kc.clone(), vc.clone()
        out, kc, vc = fused_decode_step(x, T_TIMED, e_all, w_all, kc, vc,
                                        heads)
        ref, kc2, vc2 = fused_decode_step_plain(x, T_TIMED, e_all, w_all,
                                                kc2, vc2, heads)
        torch.cuda.synchronize()
        err = max((out.float() - ref.float()).abs().max().item(),
                  (kc[:, :, T_TIMED].float() - kc2[:, :, T_TIMED].float())
                  .abs().max().item())
        ok = (err <= TOL_B[dtype] and untouched(kc, kc2, T_TIMED)
              and bool(torch.isfinite(out).all()))
        print(f"kernel B {str(dtype):15s} d={D_RUNG} H={heads} B={B} "
              f"t={T_TIMED}: max_abs_err {err:.3e} tol {TOL_B[dtype]:.1e} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel B at d 1024 disagrees with its "
                                 "plain version")
        check_step_int8(model, gen, T_TIMED, False, "rung")


def int8_paths(prime: np.ndarray) -> dict:
    """Greedy f32 on an int8 flagship, the kernel path against the plain
    path: ``decode.generate`` (64 tokens x 8, the bucketed prime) and
    serving of 8 staggered requests; lookup speculation at B 1 equal to
    ``generate`` on it. Returns the int8 launches of each run."""
    model32 = flagship(torch.float32, quant="int8")
    prompt_np, prompt_len = bucket_prompt(np.tile(prime, (B, 1)),
                                          GREEDY_STEPS, MAX_SEQ,
                                          model32.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    dpg = DecodeParams(max_len=prompt.shape[1] + GREEDY_STEPS,
                       steps=GREEDY_STEPS,
                       sampling=SamplingParams(greedy=True))
    reset_counts()
    kern = generate(model32, prompt, None, dpg, prompt_len)
    torch.cuda.synchronize()
    launches = {"generate": fused_decode_step.int8_launches}
    with plain_path():
        plain = generate(model32, prompt, None, dpg, prompt_len)
    same = torch.equal(kern, plain)
    print(f"greedy f32 int8 {GREEDY_STEPS} tokens x {B}: kernel path == "
          f"plain path: {same}; int8 kernel-B launches "
          f"{launches['generate']}")
    if not same or launches["generate"] != 3 * N_LAYERS * GREEDY_STEPS:
        raise AssertionError("greedy int8 generation: kernel path differs "
                             "or kernel B's int8 mode was not launched")
    reset_counts()
    serve_parity(prime, quant="int8")
    torch.cuda.synchronize()
    launches["serve"] = fused_decode_step.int8_launches
    if launches["serve"] == 0 or fused_decode_step.launches:
        raise AssertionError("int8 serving did not run kernel B's int8 mode")

    prompt1 = torch.from_numpy(prime[None]).to(DEV)
    dp = DecodeParams(max_len=PROMPT + SPEC_GREEDY, steps=SPEC_GREEDY,
                      sampling=SamplingParams(greedy=True))
    want = generate(model32, prompt1, None, dp)
    reset_counts()
    got, stats = generate_speculative(model32, prompt1, None, dp,
                                      spec=SpecParams(chunk=SPEC_CHUNK),
                                      with_stats=True)
    torch.cuda.synchronize()
    launches["speculative"] = fused_decode_chunk.int8_launches
    same = torch.equal(got, want)
    print(f"speculative greedy f32 int8 lookup B=1, {SPEC_GREEDY} tokens: == "
          f"generate: {same}; {stats['iterations']} verify forwards, int8 "
          f"kernel-E launches {launches['speculative']}")
    if (not same or launches["speculative"]
            != 3 * N_LAYERS * stats["iterations"]):
        raise AssertionError("int8 lookup speculation differs from "
                             "generate or missed kernel E's int8 mode")
    return launches


def int8_cli() -> dict:
    """``cli.generate --quant int8`` at full width, bf16: B 8, the
    500-token prime bucketed to 512, 512 sampled tokens, with exactly
    18 int8 kernel-B launches per decode step, 6 kernel-A launches and no
    unquantized kernel-B launch, every MIDI read back; then ``--spec
    lookup --quant int8`` at B 1 with exactly 18 int8 kernel-E launches
    per verify forward."""
    model = flagship(torch.bfloat16)
    os.makedirs(OUT_DIR, exist_ok=True)
    runs = {}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        pth, prime_mid = write_inputs(model, tmp)
        for name, extra, nb in (
                ("generate", [], B),
                ("spec_lookup", ["--spec", "lookup", "--spec-chunk",
                                 str(SPEC_CHUNK)], 1)):
            out = os.path.join(tmp, f"int8-{name}.mid")
            buf = io.StringIO()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main([pth, out, "--prime", prime_mid, "--prime-len",
                               str(PROMPT), "--steps", str(STEPS), "--batch",
                               str(nb), "--dtype", "bfloat16", "--seed", "0",
                               "--quant", "int8"] + extra)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            text = buf.getvalue()
            n = {"A": fused_relative_attention.launches,
                 "B": fused_decode_step.launches,
                 "B_int8": fused_decode_step.int8_launches,
                 "E": fused_decode_chunk.launches,
                 "E_int8": fused_decode_chunk.int8_launches}
            if name == "generate":
                want = {"A": N_LAYERS, "B": 0, "B_int8": 3 * N_LAYERS * STEPS,
                        "E": 0, "E_int8": 0}
                detail = f"{STEPS} decode steps"
            else:
                m = re.search(r"speculative: (\d+) verify forwards", text)
                iters = int(m.group(1))
                want = {"A": N_LAYERS, "B": 0, "B_int8": 0, "E": 0,
                        "E_int8": 3 * N_LAYERS * iters}
                detail = f"{iters} verify forwards"
            paths = re.findall(r"wrote (\S+) \((\d+) tokens\)", text)
            events = [len(midilike.extract_events(path).events)
                      for path, _ in paths]
            ok = (rc == 0 and n == want and len(paths) == nb
                  and all(int(k) == STEPS for _, k in paths)
                  and min(events) > 0)
            print(f"cli.generate --quant int8 {name} bf16 (B={nb}, prime "
                  f"{PROMPT}, {STEPS} steps): {secs:.3f} s; {detail}; "
                  f"launches {n} (expected {want}); {len(paths)} MIDI files "
                  f"read back as {min(events)}-{max(events)} events "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"cli.generate --quant int8 {name} "
                                     "failed")
            runs[name] = n
    return runs


def time_int8(err: dict, launches: dict) -> list:
    """Device times of the int8 modes in bf16 beside the unquantized
    kernels, interleaved (unquantized, int8, int8, unquantized): kernel B
    at B 8, t 755 at the flagship and the d 1024 rung; ragged kernel B at
    t 1023 with a live window of LIVE rows; kernel E at C 8, t 755, B 1
    and B 8; each with its plain int8 version and its bound (int8
    matrices 1 byte, their scale tables 4). Returns the kernels rows."""
    def pair(full_fn, int8_fn):
        a1, b1, b2, a2 = (device_ms(fn, iters=50)
                          for fn in (full_fn, int8_fn, int8_fn, full_fn))
        return (a1 + a2) / 2, (b1 + b2) / 2

    rows = []
    gen = torch.Generator().manual_seed(25)
    step_ms = {}
    for d in (D_MODEL, D_RUNG):
        model = flagship(torch.bfloat16, quant="int8", d_model=d)
        x, e_all, w_all, kc, vc = decode_inputs(model, gen)
        qw, sc = w_all["int8"]
        heads, t = model.num_heads, T_TIMED
        full_ms, ms = pair(
            lambda: fused_decode_step(x, t, e_all, w_all, kc, vc, heads),
            lambda: fused_decode_step(x, t, e_all, qw, kc, vc, heads,
                                      scales=sc))
        plain_ms = device_ms(lambda: fused_decode_step_plain(
            x, t, e_all, qw, kc, vc, heads, scales=sc), iters=10)
        zeros = np.zeros(B, np.int64)
        bnd, by = decode_bound(zeros, t, d, int8=True)
        full_bnd, _ = decode_bound(zeros, t, d)
        print(f"kernel B bf16 d={d} B={B} t={t}: int8 {ms:.4f} ms (bound "
              f"{bnd:.5f} ms, {by}; plain int8 {plain_ms:.4f} ms), "
              f"unquantized {full_ms:.4f} ms (bound {full_bnd:.5f} ms); "
              f"int8 / unquantized {ms / full_ms:.3f}")
        step_ms[d] = (ms, plain_ms, bnd, by, full_ms, full_bnd)
    ms, plain_ms, bnd, by, full_ms, full_bnd = step_ms[D_MODEL]
    rung = step_ms[D_RUNG]
    rows.append({
        "name": "fused_decode_step_int8", "route": "cuda",
        "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
        "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1278",
        "launches": launches["B"], "max_abs_err": err["B"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "unquantized_ms": full_ms,
        "d1024_ms": rung[0], "d1024_plain_ms": rung[1],
        "d1024_bound_ms": rung[2], "d1024_unquantized_ms": rung[4],
        "d1024_unquantized_bound_ms": rung[5]})

    model = flagship(torch.bfloat16, quant="int8")
    x, e_all, w_all, kc, vc = decode_inputs(model, gen)
    qw, sc = w_all["int8"]
    t = T_RAGGED
    start = torch.randint(t - LIVE + 1, t + 1, (B,), generator=gen)
    start[0] = t - LIVE + 1
    start = start.to(torch.int32).to(DEV)
    kw = {"start": start, "start_min": int(start.min())}
    full_ms, ms = pair(
        lambda: fused_decode_step(x, t, e_all, w_all, kc, vc, H, **kw),
        lambda: fused_decode_step(x, t, e_all, qw, kc, vc, H, scales=sc,
                                  **kw))
    plain_ms = device_ms(lambda: fused_decode_step_plain(
        x, t, e_all, qw, kc, vc, H, scales=sc, **kw), iters=10)
    bnd, by = decode_bound(start.cpu().numpy(), t, int8=True)
    print(f"ragged kernel B bf16 B={B} t={t}, live window {LIVE}: int8 "
          f"{ms:.4f} ms (bound {bnd:.5f} ms, {by}; plain int8 {plain_ms:.4f} "
          f"ms, host gaps included), unquantized {full_ms:.4f} ms")
    rows.append({
        "name": "fused_decode_step_ragged_int8", "route": "cuda",
        "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
        "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1278",
        "launches": launches["B_ragged"], "max_abs_err": err["B_ragged"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "unquantized_ms": full_ms})

    dgen = torch.Generator(DEV).manual_seed(26)
    res = {}
    for b in (1, B):
        x, e_all, w_all, kc, vc = chunk_inputs(model, (w_all, e_all), dgen, b,
                                               SPEC_CHUNK, 1024)
        full_ms, ms = pair(
            lambda: fused_decode_chunk(x, T_TIMED, e_all, w_all, kc, vc, H),
            lambda: fused_decode_chunk(x, T_TIMED, e_all, qw, kc, vc, H,
                                       scales=sc))
        plain_ms = device_ms(lambda: fused_decode_chunk_plain(
            x, T_TIMED, e_all, qw, kc, vc, H, scales=sc), iters=10)
        bnd, by = chunk_bound(b, SPEC_CHUNK, T_TIMED, int8=True)
        res[b] = (ms, plain_ms, bnd, by, full_ms)
        print(f"kernel E bf16 B={b} C={SPEC_CHUNK} t={T_TIMED}: int8 "
              f"{ms:.4f} ms (bound {bnd:.5f} ms, {by}; plain int8 "
              f"{plain_ms:.4f} ms), unquantized {full_ms:.4f} ms")
    ms, plain_ms, bnd, by, full_ms = res[1]
    rows.append({
        "name": "fused_decode_chunk_int8", "route": "cuda",
        "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
        "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1568",
        "launches": launches["E"], "max_abs_err": err["E"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "unquantized_ms": full_ms, "ms_b8": res[B][0],
        "plain_ms_b8": res[B][1], "bound_ms_b8": res[B][2],
        "unquantized_ms_b8": res[B][4]})
    return rows


def int8_rates() -> dict:
    """Decode tokens/s, bf16 sampled, int8 against unquantized at the
    flagship and the d 1024 rung: B 8, a 16-token prompt, 512 tokens,
    cache 1024 (bench.py:25-44), host clock around each whole call,
    RATE_ROUNDS interleaved rounds, the median."""
    out = {}
    for d in (D_MODEL, D_RUNG):
        models = {q: flagship(torch.bfloat16, quant=q, d_model=d)
                  for q in ("none", "int8")}
        prompt = torch.ones(B, RATE_PROMPT, dtype=torch.long, device=DEV)
        dp = DecodeParams(max_len=RATE_CACHE, steps=STEPS,
                          sampling=SamplingParams())
        rates = {q: [] for q in models}
        for _ in range(RATE_ROUNDS):
            for q, m in models.items():
                gen = torch.Generator(DEV).manual_seed(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks = generate(m, prompt, gen, dp)
                torch.cuda.synchronize()
                rates[q].append(B * STEPS / (time.perf_counter() - t0))
                if toks.shape != (B, STEPS):
                    raise AssertionError(f"tokens {tuple(toks.shape)}")
        out[d] = {q: float(np.median(r)) for q, r in rates.items()}
        for q, r in rates.items():
            print(f"decode d={d} bf16 {q}: {out[d][q]:.1f} tokens/s median "
                  f"of {RATE_ROUNDS} interleaved runs [{min(r):.1f}-"
                  f"{max(r):.1f}] (B={B}, prompt {RATE_PROMPT}, {STEPS} "
                  "tokens, cache 1024, host clock)")
        print(f"decode d={d}: int8 / unquantized "
              f"{out[d]['int8'] / out[d]['none']:.3f}")
    return out


# ---------------------------------------------------------------- kernel F

def loop_inputs(model, stacked, lw, gen, b: int, cache_len: int = MAX_SEQ):
    """Kernel F's inputs at the flagship width, drawn on the card: carried
    logits [b, V] f32, filled caches [L, b, cache_len, d] in the model
    dtype, the stacked and loop weights, one seed."""
    shape = (N_LAYERS, b, cache_len, D_MODEL)
    embed, pos, fc_w, fc_b = lw
    return {"logits": torch.randn(b, VOCAB, generator=gen, device=DEV) * 2,
            "kc": torch.randn(shape, generator=gen, device=DEV).to(model.dtype),
            "vc": torch.randn(shape, generator=gen, device=DEV).to(model.dtype),
            "seed": torch.randint(0, 1 << 31, (1,), generator=gen,
                                  device=DEV),
            "embed": embed, "pos": pos, "fc_w": fc_w, "fc_b": fc_b,
            "w_all": stacked[0], "e_all": stacked[1]}


def loop_call(fn, inp, t0: int, c: int, sp: SamplingParams):
    """One call of kernel F (or its plain version) on copies of the
    carried logits and caches: (tokens, logits, k cache, v cache)."""
    logits, kc, vc = (inp["logits"].clone(), inp["kc"].clone(),
                      inp["vc"].clone())
    toks, logits = fn(logits, t0, inp["seed"], inp["embed"], inp["pos"],
                      inp["e_all"], inp["w_all"], inp["fc_w"], inp["fc_b"],
                      kc, vc, H, c, sp.temperature, sp.greedy, sp.top_k,
                      sp.top_p)
    return toks, logits, kc, vc


def loop_agreement(inp, kern, plain, t0: int, c: int, dtype,
                   sp: SamplingParams) -> tuple:
    """Kernel F against its plain version on the same inputs: every cache
    row outside [t0, t0+c) untouched by both; per batch row the tokens
    equal, the written K/V rows and the last logits within TOL_B. A bf16
    greedy row may part at a near tie: then both versions' logits before
    that step must lie within TOL_B (so the two argmaxes are within
    2 TOL_B of each other), and the rows written before it are compared.
    f32 and sampled rows must not part. A parting prints its position
    and the two competing scores. Returns (max abs error, rows parted)."""
    tk, lk, kck, vck = kern
    tp, lp, kcp, vcp = plain
    tol = TOL_B[dtype]
    for a, a0 in ((kck, inp["kc"]), (vck, inp["vc"]), (kcp, inp["kc"]),
                  (vcp, inp["vc"])):
        if not untouched(a, a0, t0, c):
            raise AssertionError(f"kernel F: cache rows outside [{t0}, "
                                 f"{t0 + c}) changed")
    err, parted = 0.0, 0
    for row in range(tk.shape[0]):
        diff = (tk[row] != tp[row]).nonzero()
        n_eq = c if len(diff) == 0 else int(diff[0])
        if n_eq:
            for a, p in ((kck, kcp), (vck, vcp)):
                err = max(err, (a[:, row, t0:t0 + n_eq].float()
                                - p[:, row, t0:t0 + n_eq].float()).abs()
                          .max().item())
        if n_eq == c:
            err = max(err, (lk[row] - lp[row]).abs().max().item())
            continue
        before_k, before_p = (
            loop_call(fn, inp, t0, n_eq, sp)[1][row] if n_eq
            else inp["logits"][row]
            for fn in (fused_decode_loop, fused_decode_loop_plain))
        a_tok, p_tok = int(tk[row, n_eq]), int(tp[row, n_eq])
        scores = before_p
        if not sp.greedy:
            scaled = before_p[None] * inv_temperature(sp.temperature)
            if sp.top_k or sp.top_p < 1.0:
                scaled = sample_mask(scaled, sp.top_k, sp.top_p)
            bits = loop_bits(inp["seed"].reshape(1),
                             torch.tensor([row], device=DEV),
                             torch.tensor([t0 + n_eq], device=DEV), VOCAB)
            scores = (scaled + gumbel(bits))[0]
        e_before = (before_k - before_p).abs().max().item()
        print(f"kernel F {str(dtype):15s} row {row} parts at step {n_eq} "
              f"(position {t0 + n_eq}): kernel token {a_tok} score "
              f"{scores[a_tok].item():.6f}, plain token {p_tok} score "
              f"{scores[p_tok].item():.6f} (plain's scores); the logits "
              f"before it differ by {e_before:.3e}")
        if dtype == torch.float32 or not sp.greedy or e_before > tol:
            raise AssertionError("kernel F's tokens differ from its plain "
                                 "version's")
        err, parted = max(err, e_before), parted + 1
    return err, parted


def check_kernel_f() -> float:
    """Kernel F against its plain version at the flagship width (caches of
    max_seq rows): greedy, f32 and bf16, B 1 and 8, C 1, 7, 32, t0 1,
    127, 128, 755, 2047 - C; then sampled f32 (T 1; T 0.9 top-k 20;
    top-p 0.9) at B 8, C 32, t0 1 and 755 with fixed seeds."""
    gen = torch.Generator(DEV).manual_seed(17)
    greedy = SamplingParams(greedy=True)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype)
        stacked, lw = model.decode_weights(), model.loop_weights()
        cases = [(greedy, "greedy", b, c, t0) for b in (1, B)
                 for c in LOOP_CHUNKS
                 for t0 in (1, 127, 128, T_TIMED, MAX_SEQ - 1 - c)]
        if dtype == torch.float32:
            cases += [(sp, name, B, LOOP_CHUNK, t0) for name, sp in LOOP_MODES
                      for t0 in (1, T_TIMED)]
        for sp, name, b, c, t0 in cases:
            inp = loop_inputs(model, stacked, lw, gen, b)
            kern = loop_call(fused_decode_loop, inp, t0, c, sp)
            plain = loop_call(fused_decode_loop_plain, inp, t0, c, sp)
            torch.cuda.synchronize()
            err, parted = loop_agreement(inp, kern, plain, t0, c, dtype, sp)
            ok = err <= TOL_B[dtype] and bool(torch.isfinite(kern[1]).all())
            print(f"kernel F {str(dtype):15s} {name:14s} B={b} C={c:2d} "
                  f"t0={t0:4d}: tokens equal in {b - parted}/{b} rows, "
                  f"max_abs_err={err:.3e} tol={TOL_B[dtype]:.1e}; rows "
                  f"outside [t0, t0+C) untouched {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel F disagrees with its plain "
                                     "version")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    return worst


def sampler_cases() -> list:
    """(logits, top_k, top_p) of test_pallas_decode.py:538-606: V 309 with
    forced ties, V 309 padded to 384 with -1e30 columns, V 4096."""
    cases = []
    rng = np.random.RandomState(7)
    for trial in range(30):
        logits = rng.randn(4, 309).astype(np.float32) * 3
        if trial % 3 == 0:
            logits[:, 50:60] = logits[:, 49:50]
        cases.append((logits, [0, 1, 5, 40, 309][trial % 5],
                      [1.0, 0.9, 0.5, 0.99, 0.01][(trial // 5) % 5]))
    rng = np.random.RandomState(8)
    padded = np.pad(rng.randn(2, 309).astype(np.float32),
                    ((0, 0), (0, 384 - 309)), constant_values=-1e30)
    cases += [(padded, k, p) for k, p in [(10, 1.0), (0, 0.8), (7, 0.9)]]
    rng = np.random.RandomState(11)
    for trial in range(8):
        logits = rng.randn(2, 4096).astype(np.float32) * 4
        if trial % 2 == 0:
            logits[:, 1000:1032] = logits[:, 999:1000]
        cases.append((logits, [0, 50, 1, 4096][trial % 4],
                      [0.9, 1.0, 0.5, 0.995][(trial // 2) % 4]))
    return cases


def check_loop_sampler() -> None:
    """Kernel F's sampler alone (``mg_loop_sample``) against the plain
    sampler on the same logits, seeds, rows and positions: the masked
    scaled logits (the kept sets and values) and the tokens equal bit for
    bit, at T 1 and T 0.9, and greedy (ties to the lowest index)."""
    gen = torch.Generator().manual_seed(19)
    n_cases = 0
    for logits, k, p in sampler_cases():
        x = torch.from_numpy(logits).to(DEV)
        n = x.shape[0]
        seeds = torch.randint(0, 1 << 62, (n,), generator=gen).to(DEV)
        rows = torch.randint(0, 64, (n,), generator=gen).to(DEV)
        pos = torch.randint(0, MAX_SEQ, (n,), generator=gen).to(DEV)
        for temp, greedy in ((1.0, False), (0.9, False), (1.0, True)):
            tk, mk = loop_sample_kernel(x, seeds, rows, pos, temp, greedy, k,
                                        p)
            tp, mp = loop_sample(x, seeds, rows, pos, temp, greedy, k, p)
            torch.cuda.synchronize()
            if not (torch.equal(tk, tp) and torch.equal(mk, mp)):
                bad = (mk != mp).any(-1).nonzero().flatten().tolist()
                raise AssertionError(
                    f"kernel F's sampler differs: V={x.shape[1]} k={k} p={p} "
                    f"T={temp} greedy={greedy}: tokens {tk.tolist()} vs "
                    f"{tp.tolist()}, masked rows differ {bad}")
            n_cases += 1
    print(f"kernel F sampler: {n_cases} cases (V 309 with ties, V 384 "
          f"padded, V 4096; top-k, top-p, T 1 and 0.9, greedy): kept sets, "
          f"values and tokens equal the plain sampler's bit for bit ok")


def chi_square(draws: np.ndarray, probs: np.ndarray, n_bins: int = 20):
    """tests/test_tpu_sampling.py's statistic: the top n_bins tokens as
    bins plus one tail bin; every draw must lie in the support."""
    n = len(draws)
    top = np.argsort(probs)[::-1][:n_bins]
    counts = np.array([(draws == t).sum() for t in top], np.float64)
    expect = probs[top] * n
    tail_c, tail_e = n - counts.sum(), max(n - expect.sum(), 1e-9)
    keep = expect > 5
    chi2 = (((counts[keep] - expect[keep]) ** 2) / expect[keep]).sum()
    if tail_e > 5:
        chi2 += (tail_c - tail_e) ** 2 / tail_e
    if not (probs[draws] > 0).all():
        raise AssertionError("kernel F sampled outside the masked set")
    return float(chi2)


def loop_distribution() -> dict:
    """First-token draws through ``generate(use_loop_kernel=True)``, bf16
    at full width: DIST_ROWS identical prompts x DIST_SEEDS generators in
    each mode, against the masked softmax of the prefill's logits under
    the plain sampler: chi2 < 52. Returns each mode's chi2 and the loop
    launches."""
    model = flagship(torch.bfloat16)
    prompt = torch.ones(DIST_ROWS, 4, dtype=torch.long, device=DEV)
    logits, _ = model.prefill(prompt, 32)
    out = {}
    reset_counts()
    for name, sp in LOOP_MODES:
        dp = DecodeParams(max_len=32, steps=1, sampling=sp,
                          use_loop_kernel=True)
        draws = np.concatenate([
            generate(model, prompt, torch.Generator(DEV).manual_seed(s),
                     dp)[:, 0].cpu().numpy() for s in range(DIST_SEEDS)])
        scaled = logits[:1] * inv_temperature(sp.temperature)
        if sp.top_k or sp.top_p < 1.0:
            scaled = sample_mask(scaled, sp.top_k, sp.top_p)
        probs = torch.softmax(scaled, -1)[0].double().cpu().numpy()
        chi2 = chi_square(draws, probs)
        print(f"kernel F distribution bf16 {name}: {len(draws)} first-token "
              f"draws, chi2 {chi2:.2f} (< {CHI2_CRIT}) "
              f"{'ok' if chi2 < CHI2_CRIT else 'FAIL'}")
        if chi2 >= CHI2_CRIT:
            raise AssertionError(f"kernel F's draws ({name}) do not follow "
                                 "the masked softmax")
        out[name] = chi2
    torch.cuda.synchronize()
    out["F"] = fused_decode_loop.launches
    return out


def loop_generate(prime: np.ndarray) -> dict:
    """``decode.generate(use_loop_kernel=True)`` at full width: bf16, B 8,
    the 500-token prime bucketed to 512, 512 sampled tokens in chunks of
    32, with exactly 6 A, 16 F and 0 B launches; greedy f32 over 64 and
    70 tokens (2 and 3 launches, the last short) equal to the step path's
    (kernel B) token for token; B 8 bf16 sampled tokens/s of the step and
    loop paths interleaved, LOOP_ROUNDS rounds."""
    model = flagship(torch.bfloat16)
    prompt_np, prompt_len = bucket_prompt(np.tile(prime, (B, 1)), STEPS,
                                          MAX_SEQ, model.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    dps = {use: DecodeParams(max_len=L_PREFILL + STEPS, steps=STEPS,
                             sampling=SamplingParams(), use_loop_kernel=use)
           for use in (False, True)}
    reset_counts()
    toks = generate(model, prompt, torch.Generator(DEV).manual_seed(0),
                    dps[True], prompt_len)
    torch.cuda.synchronize()
    n = (fused_relative_attention.launches, fused_decode_loop.launches,
         fused_decode_step.launches)
    want = (N_LAYERS, -(-STEPS // LOOP_CHUNK), 0)
    t = toks.cpu().numpy()
    ok = (n == want and t.shape == (B, STEPS)
          and 0 <= t.min() <= t.max() < VOCAB)
    print(f"generate use_loop_kernel bf16: B={B} prime {PROMPT}->{L_PREFILL} "
          f"steps={STEPS} chunk {LOOP_CHUNK}: launches A={n[0]} F={n[1]} "
          f"B={n[2]} (expected {want[0]}, {want[1]}, {want[2]}); tokens "
          f"{t.shape} in [{t.min()}, {t.max()}] {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the loop path's launches or tokens are wrong")
    launches = {"generate": n[1]}

    model32 = flagship(torch.float32)
    reset_counts()
    for steps in (GREEDY_STEPS, LOOP_GREEDY_LONG):
        dp = DecodeParams(max_len=L_PREFILL + steps, steps=steps,
                          sampling=SamplingParams(greedy=True))
        step = generate(model32, prompt, None, dp, prompt_len)
        loop = generate(model32, prompt, None, dataclasses.replace(
            dp, use_loop_kernel=True), prompt_len)
        same = torch.equal(step, loop)
        print(f"greedy f32 {steps} tokens x {B}: loop path "
              f"({-(-steps // LOOP_CHUNK)} launches) == step path: {same}")
        if not same:
            first = (step != loop).nonzero()[0].tolist()
            raise AssertionError(f"loop and step paths differ first at "
                                 f"{first}")
    torch.cuda.synchronize()
    launches["greedy_parity"] = fused_decode_loop.launches

    reset_counts()
    rates = {"step": [], "loop": []}
    for _ in range(LOOP_ROUNDS):
        for kind in ("step", "loop"):
            gen = torch.Generator(DEV).manual_seed(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(model, prompt, gen, dps[kind == "loop"], prompt_len)
            torch.cuda.synchronize()
            rates[kind].append(B * STEPS / (time.perf_counter() - t0))
    launches["rates"] = fused_decode_loop.launches
    out = {"launches": launches}
    for kind, r in rates.items():
        out[kind] = float(np.median(r))
        print(f"B={B} bf16 sampled {kind} path: {out[kind]:.1f} tokens/s "
              f"median of {LOOP_ROUNDS} interleaved runs [{min(r):.1f}-"
              f"{max(r):.1f}] (prefill included, host clock)")
    print(f"loop / step: {out['loop'] / out['step']:.2f}x")
    return out


def profile_loop(prime: np.ndarray) -> dict:
    """Where the loop path's time goes: ``decode_loop`` for 512 sampled
    bf16 tokens at B 8 after the bucketed prefill (16 chunks) under
    torch.profiler, after one warm chunk: wall and device time per chunk,
    the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16)
    prompt_np, _ = bucket_prompt(np.tile(prime, (B, 1)), STEPS, MAX_SEQ,
                                 model.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    logits, cache = model.prefill(prompt, L_PREFILL + STEPS, PROMPT - 1)
    gen = torch.Generator(DEV).manual_seed(2)
    model.decode_loop(logits, PROMPT, gen,
                      {k: v.clone() for k, v in cache.items()}, LOOP_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.decode_loop(logits, PROMPT, gen, cache, STEPS)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    n = -(-STEPS // LOOP_CHUNK)
    print(f"loop profile: {n} chunks of {LOOP_CHUNK} (B={B}, bf16, sampled), "
          f"wall {wall_us / n:.1f} us/chunk under the profiler, device busy "
          f"{busy_us / n:.1f} us/chunk ({100 * busy_us / wall_us:.1f}% of "
          f"wall); {busy_us / STEPS:.1f} us of device time per step")
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev_us / n:10.2f} us/chunk {count / n:5.1f}x/chunk "
              f"{key[:90]}")
    return {"wall_us_per_chunk": wall_us / n,
            "busy_us_per_chunk": busy_us / n,
            "busy_share": busy_us / wall_us}


def loop_bound(b: int, c: int, t0: int) -> tuple:
    """Least time of one bf16 launch of c steps from t0: the weights, the
    embedding and the head read once, the K/V prefix [0, t0) of every row,
    the E rows [0, t0+c) of each layer, c positional rows, the logits in
    and out, the chunk's K/V rows and the tokens written; the products of
    c steps for b rows (layers and head) plus three 64-deep products per
    (head, live row) pair."""
    d, f = D_MODEL, D_MODEL // 2
    w_elems = N_LAYERS * (4 * d * d + 2 * d * f + 9 * d + f)
    nbytes = (w_elems * 2 + VOCAB * d * 2 + (VOCAB * d + VOCAB) * 2
              + 2 * N_LAYERS * b * t0 * d * 2 + N_LAYERS * (t0 + c) * DH * 4
              + c * d * 2 + 2 * b * VOCAB * 4 + 2 * N_LAYERS * b * c * d * 2
              + b * c * 8)
    pairs = b * sum(t0 + i + 1 for i in range(c))
    flops = (N_LAYERS * (2 * b * c * (4 * d * d + 2 * d * f)
                         + 3 * 2 * H * pairs * DH) + 2 * b * c * d * VOCAB)
    return bound(nbytes, flops, torch.bfloat16)


def time_kernel_f(launches: int, by_path: dict, err: float) -> dict:
    """Kernel F in bf16 at the main path's shape (C 32, t0 755, sampled
    T 1, the flagship width) at B 8 and B 1: device time, its plain
    version, its bound. No single PyTorch call computes C decode steps
    (library null)."""
    model = flagship(torch.bfloat16)
    stacked, lw = model.decode_weights(), model.loop_weights()
    gen = torch.Generator(DEV).manual_seed(18)
    t0, c = T_TIMED, LOOP_CHUNK
    res = {}
    for b in (B, 1):
        inp = loop_inputs(model, stacked, lw, gen, b, 1024)
        args = (inp["logits"], t0, inp["seed"], inp["embed"], inp["pos"],
                inp["e_all"], inp["w_all"], inp["fc_w"], inp["fc_b"],
                inp["kc"], inp["vc"], H, c)
        ms = device_ms(lambda: fused_decode_loop(*args), iters=10)
        plain_ms = device_ms(lambda: fused_decode_loop_plain(*args), iters=2)
        bnd, by = loop_bound(b, c, t0)
        res[b] = (ms, plain_ms, bnd, by)
        print(f"kernel F bf16 B={b} C={c} t0={t0}: {ms:.4f} ms per launch "
              f"({1e3 * ms / c:.1f} us per step), plain {plain_ms:.4f} ms, "
              f"bound {bnd:.5f} ms ({by})")
    ms, plain_ms, bnd, by = res[B]
    return {"name": "fused_decode_loop", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode_loop.py:377",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "launches_by_path": by_path,
            "ms_b1": res[1][0], "plain_ms_b1": res[1][1],
            "bound_ms_b1": res[1][2]}


def loop_paths(prime: np.ndarray) -> dict:
    """The decode-loop path: the sampler alone, the distribution, the
    main path's generation, parity and rates."""
    check_loop_sampler()
    dist = loop_distribution()
    run = loop_generate(prime)
    by_path = {"distribution": dist["F"], **run["launches"]}
    return {"chi2": {k: v for k, v in dist.items() if k != "F"},
            "by_path": by_path, "F": sum(by_path.values()),
            "tok_s": {"step": run["step"], "loop": run["loop"]}}


def main() -> int:
    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = cuda_build.build()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items()))
    for name, log in cuda_build.BUILD_LOGS.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = re.search(r"'\S*?\d([a-z_]+_kernel)", line)
                fn = " " + entry.group(1) if entry else ""
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}{fn}: {line.strip()}")

    err_a = check_kernel_a()
    err_b = check_kernel_b()
    err_br = check_kernel_b_ragged()
    err_c = check_kernel_c()
    err_d = check_kernel_d()
    err_e = check_kernel_e()
    check_chunk_vs_steps()
    err_int8 = check_int8_kernels()
    check_kernel_b_rung()
    err_f = check_kernel_f()
    e2e = end_to_end()
    loop = loop_paths(e2e["prime"])
    served = serving(e2e["prime"])
    spec = speculative_paths(e2e["prime"])
    q_paths = int8_paths(e2e["prime"])
    q_cli = int8_cli()
    rnn = rnn_paths(e2e["prime"])
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        shards = write_corpus(tmp)
        train_parity(shards)
        tr = train_end_to_end(tmp, shards)
        step_t = time_train_step(shards)
    row_a = time_kernel_a(e2e["A"] + tr["A"] + served["A"] + spec["A"],
                          err_a)
    row_a["launches_by_path"] = {"generate": e2e["A"], "train": tr["A"],
                                 "serve": served["A"],
                                 "speculative": spec["A"]}
    row_b = time_kernel_b(e2e["B"] + served["B"] + spec["B"],
                          max(err_b, err_br))
    row_b["launches_by_path"] = {"generate": e2e["B"], "serve": served["B"],
                                 "speculative": spec["B"]}
    row_c = time_kernel_c(tr["C"], err_c)
    row_c["launches_by_path"] = {"train": tr["C"]}
    row_br = time_kernel_b_ragged(served["B"], err_br)
    row_br["launches_by_path"] = {"serve": served["B"]}
    row_d = time_kernel_d(sum(rnn["launches"].values()), err_d)
    row_d["launches_by_path"] = rnn["launches"]
    row_e = time_kernel_e(spec["E"], err_e)
    row_e["launches_by_path"] = {f"speculative_{k}": r["E"]
                                 for k, r in spec["runs"].items()}
    row_f = time_kernel_f(loop["F"], loop["by_path"], err_f)
    q_by_path = {
        "B": {"cli_generate": q_cli["generate"]["B_int8"],
              "generate_parity": q_paths["generate"]},
        "B_ragged": {"serve_parity": q_paths["serve"]},
        "E": {"cli_spec_lookup": q_cli["spec_lookup"]["E_int8"],
              "speculative_parity": q_paths["speculative"]}}
    q_rows = time_int8(err_int8, {k: sum(v.values())
                                  for k, v in q_by_path.items()})
    for r, k in zip(q_rows, ("B", "B_ragged", "E")):
        r["launches_by_path"] = q_by_path[k]
    q_rates = int8_rates()
    profile_decode()
    for d, q in ((D_MODEL, "int8"), (D_RUNG, "none"), (D_RUNG, "int8")):
        profile_decode(d_model=d, quant=q)
    loop_prof = profile_loop(e2e["prime"])
    profile_serving()
    profile_rnn_decode()
    profile_spec(e2e["prime"], draft=False)
    profile_spec(e2e["prime"], draft=True)
    rows = [row_a, row_b, row_c, row_br, row_d, row_e, row_f] + q_rows
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{lib} ms, launches {r['launches']}")
    print(f"end to end: prefill {e2e['prefill_ms']:.3f} ms, decode "
          f"{e2e['tok_s']:.1f} tokens/s; train step {step_t['step_ms']:.3f} "
          f"ms ({step_t['tok_s']:.0f} tokens/s)")
    for family in ("event_rnn", "performance_rnn"):
        print(f"{family}: decode {rnn['tok_s'][family]:.1f} tokens/s (B={B}, "
              f"bf16); serving: {rnn['serve'][family]}")
    print("speculative B=1 bf16 greedy, tokens/s (median): " + ", ".join(
        f"{k} {r['tok_s']:.1f}" for k, r in spec["rates"].items()))
    print("decode B=8 bf16 sampled, int8 / unquantized tokens/s (median): "
          + ", ".join(f"d {d} {r['int8']:.1f} / {r['none']:.1f}"
                      for d, r in q_rates.items()))
    print(f"decode loop B={B} bf16 sampled, tokens/s (median): step path "
          f"{loop['tok_s']['step']:.1f}, loop path {loop['tok_s']['loop']:.1f}"
          f"; under the profiler {loop_prof['busy_share'] * 100:.1f}% busy; "
          "chi2 " + ", ".join(f"{k} {v:.2f}" for k, v in loop["chi2"].items()))
    print(gpu_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
