"""Drive the PyTorch/CUDA port's generation and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first failure raises and the exit code is non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the three hand-written kernels from
   ``musicgeneration_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together);
3. kernel A (relative attention, prefill) against its plain PyTorch
   version at B8 H4 L512 dh64 max_seq 2048, f32 (TF32 off) and bf16,
   with and without key padding, non-causal, and at L 100 (a ragged
   tile, as short prompts give);
4. kernel B (fused decode step) against its plain version at the
   flagship width (6 layers, d 256, B 8, cache 1024) for several t,
   f32 and bf16, and at B 1 and B 3; then kernel C (relative attention
   backward) against its plain backward at B8 H4 L512 dh64, max_seq 512
   (training) and 2048, f32 (TF32 off) and bf16, causal and not, with
   and without key padding, and at L 100;
5. end to end at full width (vocab 309, 6 layers, d 256, max_seq 2048,
   seeded random weights) through the user's entry point: the weights
   saved as a .pth, a prime MIDI written, ``cli.generate`` run on them
   (B 8, prime 500 tokens bucketed to 512, 512 sampled bf16 tokens,
   8 MIDI files written and read back) with the launch counters of both
   kernels read around it; the same generation timed through
   ``decode.generate``; then greedy in f32 for 64 tokens, where the
   kernel path's tokens must equal the plain path's;
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
7. timings at the main paths' shapes: each kernel, its plain version, its
   bound and, where one PyTorch call computes the same function,
   ``F.scaled_dot_product_attention`` with the relative bias materialized
   as ``attn_mask`` (forward for kernel A, forward + backward for kernel
   C); the bf16 train step over 25 warm steps (CUDA events) and a
   ``torch.profiler`` window over 5 of them; a ``torch.profiler`` window
   over 32 bf16 decode steps (device time by kernel, the device's busy
   share);
8. one JSON line of kernels, the card's line, and the final JSON line.

Imports nothing of JAX or of ``musicgeneration_tpu``. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: CUDA is not available", file=sys.stderr)
    sys.exit(1)

from musicgeneration_tpu_torch.cli.generate import (  # noqa: E402
    bucket_prompt, prime_tokens, write_midi)
from musicgeneration_tpu_torch.cli import train as train_cli  # noqa: E402
from musicgeneration_tpu_torch.cli.generate import main as cli_main  # noqa: E402
from musicgeneration_tpu_torch.cli.tokenize import (  # noqa: E402
    main as tokenize_main)
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus  # noqa: E402
from musicgeneration_tpu_torch.decode import (  # noqa: E402
    DecodeParams, SamplingParams, generate)
from musicgeneration_tpu_torch.models import music_transformer as mt  # noqa: E402
from musicgeneration_tpu_torch.ops import cuda_build  # noqa: E402
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention, fused_relative_attention_bwd,
    fused_relative_attention_bwd_plain, fused_relative_attention_plain)
from musicgeneration_tpu_torch.ops.fused_decode import (  # noqa: E402
    fused_decode_step, fused_decode_step_plain)
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


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def flagship(dtype, seed: int = 0) -> mt.MusicTransformer:
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=N_LAYERS, d_model=D_MODEL,
        max_seq=MAX_SEQ, dtype=dtype, device=DEV,
        generator=torch.Generator().manual_seed(seed))


def decode_inputs(model, gen, b: int = B):
    w_all, e_all = model.decode_weights()
    cache_len = 1024
    shape = (N_LAYERS, b, cache_len, D_MODEL)
    kc = torch.randn(shape, generator=gen).to(DEV, model.dtype)
    vc = torch.randn(shape, generator=gen).to(DEV, model.dtype)
    x = torch.randn(b, D_MODEL, generator=gen).to(DEV, model.dtype)
    return x, e_all, w_all, kc, vc


def untouched(a, b, t: int) -> bool:
    """Every cache row but t is equal."""
    return (torch.equal(a[:, :, :t], b[:, :, :t])
            and torch.equal(a[:, :, t + 1:], b[:, :, t + 1:]))


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


@contextlib.contextmanager
def plain_path():
    """Run the model through the plain versions of both kernels."""
    saved = (mt.fused_relative_attention, mt.fused_decode_step)
    mt.fused_relative_attention = fused_relative_attention_plain
    mt.fused_decode_step = fused_decode_step_plain
    try:
        yield
    finally:
        mt.fused_relative_attention, mt.fused_decode_step = saved


def run_cli(model, tmp: str) -> np.ndarray:
    """The user's entry point: export the model as a .pth, write a prime
    MIDI, run ``cli.generate`` on it (B 8, prime 500 -> bucket 512, 512
    sampled bf16 tokens) with both launch counters read around it.
    Returns the tokenized prime."""
    pth = os.path.join(tmp, "model.pth")
    torch.save({"net": model.state_dict(), "optimizer": {}, "epoch": 0}, pth)
    prime_mid = os.path.join(tmp, "prime.mid")
    write_midi(np.random.default_rng(0).integers(0, VOCAB - 1, 3000),
               prime_mid)
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
    prefill_ms = cuda_ms(lambda: model.prefill(prompt, L_PREFILL + STEPS,
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
            "tok_s": tok_s}


def profile_decode(steps: int = 32, warm: int = 3) -> None:
    """Where a bf16 decode step's time goes: device time by kernel and
    the device's busy share of the wall time, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16)
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
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats the
        # time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    busy_us = sum(r[0] for r in rows)
    print(f"decode profile: {steps} steps (decode_step + argmax), wall "
          f"{wall_us / steps:.1f} us/step under the profiler, device busy "
          f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f}% "
          f"of wall)")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / steps:8.2f} us/step {count // steps:4d}x/step "
              f"{key[:90]}")


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
    groups, rows = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us <= 0:
            continue
        rows.append((dev_us, ev.count, ev.key))
        g = kernel_group(ev.key)
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
    ms = cuda_ms(lambda: fused_relative_attention_bwd(q, k, v, e, None, True,
                                                      out, lse, dout))
    plain_ms = cuda_ms(lambda: fused_relative_attention_bwd_plain(
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

    library_ms = cuda_ms(sdpa_fwd_bwd)
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
    ms = cuda_ms(lambda: fused_relative_attention(q, k, v, e, pad))
    plain_ms = cuda_ms(lambda: fused_relative_attention_plain(q, k, v, e, pad),
                       iters=5)
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
    library_ms = cuda_ms(lambda: f(q, k, v, attn_mask=mask))
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
    ms = cuda_ms(lambda: fused_decode_step(x, t, e_all, w_all, kc, vc, H),
                 iters=50)
    plain_ms = cuda_ms(lambda: fused_decode_step_plain(x, t, e_all, w_all,
                                                       kc, vc, H), iters=10)
    d, f, n = D_MODEL, D_MODEL // 2, t + 1
    w_elems = N_LAYERS * (4 * d * d + 2 * d * f + 9 * d + f)
    nbytes = (w_elems * 2 + 2 * N_LAYERS * B * n * d * 2
              + N_LAYERS * n * DH * 4 + 2 * B * d * 2
              + 2 * N_LAYERS * B * d * 2)
    flops = N_LAYERS * (2 * B * (4 * d * d + 2 * d * f)
                        + 3 * 2 * B * H * n * DH)
    bound_ms, by = bound(nbytes, flops, torch.bfloat16)
    return {"name": "fused_decode_step", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1171",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None}


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")

    err_a = check_kernel_a()
    err_b = check_kernel_b()
    err_c = check_kernel_c()
    e2e = end_to_end()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        shards = write_corpus(tmp)
        train_parity(shards)
        tr = train_end_to_end(tmp, shards)
        step_t = time_train_step(shards)
    row_a = time_kernel_a(e2e["A"] + tr["A"], err_a)
    row_a["launches_by_path"] = {"generate": e2e["A"], "train": tr["A"]}
    row_b = time_kernel_b(e2e["B"], err_b)
    row_b["launches_by_path"] = {"generate": e2e["B"]}
    row_c = time_kernel_c(tr["C"], err_c)
    row_c["launches_by_path"] = {"train": tr["C"]}
    profile_decode()
    for r in (row_a, row_b, row_c):
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{lib} ms, launches {r['launches']}")
    print(f"end to end: prefill {e2e['prefill_ms']:.3f} ms, decode "
          f"{e2e['tok_s']:.1f} tokens/s; train step {step_t['step_ms']:.3f} "
          f"ms ({step_t['tok_s']:.0f} tokens/s)")
    print(gpu_line())
    print(json.dumps({"kernels": [row_a, row_b, row_c]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
