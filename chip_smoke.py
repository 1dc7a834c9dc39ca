"""Drive the PyTorch/CUDA port's generation path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (the first failure raises and the exit code is non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build both hand-written kernels from ``musicgeneration_tpu_torch/csrc``
   (one ``nvcc`` per source, started together);
3. kernel A (relative attention, prefill) against its plain PyTorch
   version at B8 H4 L512 dh64 max_seq 2048, f32 (TF32 off) and bf16,
   with and without key padding, non-causal, and at L 100 (a ragged
   tile, as short prompts give);
4. kernel B (fused decode step) against its plain version at the
   flagship width (6 layers, d 256, B 8, cache 1024) for several t,
   f32 and bf16, and at B 1 and B 3;
5. end to end at full width (vocab 309, 6 layers, d 256, max_seq 2048,
   seeded random weights) through the user's entry point: the weights
   saved as a .pth, a prime MIDI written, ``cli.generate`` run on them
   (B 8, prime 500 tokens bucketed to 512, 512 sampled bf16 tokens,
   8 MIDI files written and read back) with the launch counters of both
   kernels read around it; the same generation timed through
   ``decode.generate``; then greedy in f32 for 64 tokens, where the
   kernel path's tokens must equal the plain path's;
6. timings at the main path's shapes: each kernel, its plain version,
   its bound and (kernel A) ``F.scaled_dot_product_attention`` with the
   relative bias and masks materialized as ``attn_mask``; then a
   ``torch.profiler`` window over 32 bf16 decode steps (device time by
   kernel, the device's busy share);
7. one JSON line of kernels, the card's line, and the final JSON line.

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
from musicgeneration_tpu_torch.cli.generate import main as cli_main  # noqa: E402
from musicgeneration_tpu_torch.decode import (  # noqa: E402
    DecodeParams, SamplingParams, generate)
from musicgeneration_tpu_torch.models import music_transformer as mt  # noqa: E402
from musicgeneration_tpu_torch.ops import cuda_build  # noqa: E402
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention, fused_relative_attention_plain)
from musicgeneration_tpu_torch.ops.fused_decode import (  # noqa: E402
    fused_decode_step, fused_decode_step_plain)
from musicgeneration_tpu_torch.tokenizers import midilike  # noqa: E402

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
# main-path shapes
B, H, DH, L_PREFILL, MAX_SEQ = 8, 4, 64, 512, 2048
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
    e2e = end_to_end()
    row_a = time_kernel_a(e2e["A"], err_a)
    row_b = time_kernel_b(e2e["B"], err_b)
    profile_decode()
    for r in (row_a, row_b):
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{lib} ms, launches {r['launches']}")
    print(f"end to end: prefill {e2e['prefill_ms']:.3f} ms, decode "
          f"{e2e['tok_s']:.1f} tokens/s")
    print(gpu_line())
    print(json.dumps({"kernels": [row_a, row_b]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
