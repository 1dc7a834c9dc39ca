"""Drive the PyTorch/CUDA port's generation (step by step and through
the decode loop), speculative decoding, serving and training paths on
one NVIDIA GPU.

    python3 chip_smoke.py [--loop-phases]

Phases (the first failure raises and the exit code is non-zero):

1. the card's name and power limit, torch and CUDA versions;
2. build the hand-written kernels from ``musicgeneration_tpu_torch/csrc``
   (one ``nvcc`` per source, started together; kernels B, E and F share
   ``fused_decode.cu``) and, beside them, kernels A, G, C, B/E/F and D
   once more with their bf16 mode sent to the earlier body (timed as
   ``earlier_ms``), print each kernel's ptxas line, and count in
   ``cuobjdump -sass`` the tensor-core instructions (HMMA/HGMMA) and
   asynchronous copies (LDGSTS/UTMALDG/UBLKCP) of every entry function: a bf16
   tensor-core entry of kernels A, G, C, B, E and D without either, kernel
   F's cluster entry without asynchronous copies, or any of them with
   bytes spilled, fails;
3. kernel A (relative attention, prefill) against its plain PyTorch
   version at B8 H4 L512 dh64 max_seq 2048, f32 (TF32 off) and bf16,
   with and without key padding, non-causal, at L 100 (a ragged tile, as
   short prompts give), at L 1 (a one-token prompt), 17 and 2048, causal,
   with and without key padding, at the training shape (max_seq 512),
   and with the first 3 keys padded, causal (every row held to the
   tolerance, the 3 rows that reach no unmasked key too);
4. kernel B (fused decode step) against its plain version at the
   flagship width (6 layers, d 256, B 8, cache 1024) for several t,
   f32 and bf16, and at B 1 and B 3; then kernel C (relative attention
   backward) against its plain backward at B8 H4 L512 dh64, max_seq 512
   (training) and 2048, f32 (TF32 off) and bf16, causal and not, with
   and without key padding, and at L 100, 17 and 1, and at L 512 with
   the first 3 keys padded, causal (the extended walk), and with every
   key padded, not causal (rows at the -1e9 floor: p scaled), every call
   repeated and held bit-equal to the first; kernel E (the chunk-verify
   forward) against its plain version at the flagship width, f32 and
   bf16, B 1, 4 and 8, C 2, 5, 8 and 64, t 1, across the 128-row split,
   755 and max_seq - C, the cache rows outside [t, t+C) unchanged; then
   one kernel-E call against C chained kernel-B steps (outputs and
   caches); kernel F (the decode loop: C whole sampling-and-decode steps
   per launch) against its plain version, greedy in f32 and bf16 at B 1
   and 8, C 1, 7 and 32, t0 1, 127, 128, 755 and 2047 - C (a bf16 row may
   part only at a near tie, which is printed), and sampled in f32 with
   fixed seeds (T 1; T 0.9 top-k 20; top-p 0.9), and greedy in bf16 at
   the d 1024 rung (B 1 and 8, C 7, t0 755), whose widths send bf16 to
   the one-block body, the cache rows outside [t0, t0+C) unchanged;
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
   C); kernels A, G, C, B, E, D and F beside their earlier bf16 bodies
   (D and F in turns, current and earlier), and
   kernel C's launches one by one under ``torch.profiler``; ragged
   kernel B at t 1023 with a live window of 256, under
   ``start_min`` 0 and min(start); the bf16 train step over 25 warm
   steps (CUDA events) and a ``torch.profiler`` window over 5 of them;
   ``torch.profiler`` windows over 32 bf16 decode steps, over one
   serving segment and over 8 verify iterations of lookup and of
   self-draft speculation (device time by kernel, the device's busy
   share); kernel E at C 8, t 755, B 1 and B 8 beside its plain version,
   its bound and one kernel-B step; kernel F at C 32, t0 755, B 8 and
   B 1 beside its plain version and its bound, and a ``torch.profiler``
   window over the loop path's 16 chunks; with ``--loop-phases`` only,
   kernel F's time per step by phase (sampler, products, attention,
   cluster barriers, head) from a build with phase clocks;
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
   at B 8 and B 1, beside its earlier CUDA-core body in turns, its plain
   version, its bound, ``torch.nn.GRU``
   (cuDNN) over one step, warm and with L2 flushed as kernel D; a
   ``torch.profiler`` window over 32 decode
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
12. sequence-parallel attention (kernel G, one round of the ring per
   launch) on a virtual mesh of n shards of the card: kernel G against
   its plain tile at B 8, H 4, dh 64, max_seq 2048, Lloc 512 (L 2048,
   sp 4), 256 (sp 8), 128 (L 512, sp 4) and the ragged 25 (L 100, sp 4)
   and 17 (L 68, sp 4),
   every (shard, round) pair, causal and not, with and without key
   padding, f32 (TF32 off) and bf16; the whole ring through kernel G
   against the plain ring, and in f32 against kernel A's single-device
   output at L 2048; the full-width MusicTransformer with
   ``attention_impl="ring_pallas"`` on ``make_mesh(sp=4, devices=[cuda]
   * 4)`` against the same weights with ``"auto"``: one f32 forward at
   B 8, L 2048 (exactly 24 kernel-G and 0 kernel-A launches) and one f32
   train step, dropout 0 (kernel G forward, plain-ring backward) against
   the single-device step through kernels A and C; kernel G's time per
   launch and per ring pass beside its bound (bytes against five bf16
   tensor-core products, and the earlier f32-peak figure), its plain
   version, its earlier CUDA-core body, SDPA over the whole sequence and kernel A at L 2048; a bf16
   train step on the virtual ring against a single-device step (no
   claim: one card).
   The NCCL ring of a process group needs several GPUs and is not run
   here;
13. the Compound Word (CP) transformer at the repo's defaults (4 layers,
   d 256, 4 heads, FFN 128, max_seq 1024, 8 field heads over 347 ids;
   seeded random weights): kernel A (causal, no key_pad, B 8, L 256 and
   512, max_seq 1024), kernel B at 4 layers (t 700 and 1023 in a
   1024-row cache, t 0, 700 and 767 in an aligned 768-row cache shorter
   than the E table; plain, ragged and int8) and kernel C (L 512, max_seq
   512, causal) against their plain versions, f32 and bf16 (run with the
   other kernel checks); greedy f32 ``generate_cp`` (B 8, 64 rows after
   256) and its int8 model, kernel path == plain path; greedy f32 serving
   of 8 staggered requests, kernel path == plain path == each request's
   dedicated ``generate_cp``; ``cli.generate`` on the saved model (bf16,
   B 8, the prime cut to 512 rows, 512 sampled rows: exactly 4 kernel-A
   and 12 kernel-B launches a row) and with ``--quant int8`` (128 rows:
   12 int8 launches a row); ``cli.serve`` file mode (24 requests, exactly
   4 A per admission and 12 ragged B per decode step); ``cli.tokenize
   --scheme cp`` -> one f32 train step kernel vs plain (PERF.md section
   2's limits) -> ``cli.train model=cp_transformer`` bf16 for 30 steps
   (exactly 4 A and 4 C a step) -> ``cli.generate`` from the checkpoint
   directory; kernels A, B and C timed at CP's shapes beside their plain
   versions and bounds (A also beside SDPA); prefill ms, decode rows/s,
   serving goodput and the train step's time;
14. PoPMAG at its defaults (embed 256, hidden 256, 2 GRU layers, init_dim
   32, bar_dim 188, 485 events; seeded random weights; synthetic
   six-role 16-bar pieces written with the port's MIDI writer): kernel D
   against its plain version at in 256, H 256, 2 layers, B 1, 8 and 32,
   f32 and bf16 (run with the other kernel checks); greedy f32
   ``generate_arrangement`` (B 8, 16 bars) kernel path == plain path with
   exactly 400 D launches a bar; greedy f32 serving of 8 staggered
   requests, kernel path == plain path == one dedicated
   ``generate_arrangement`` at the pool width; ``cli.tokenize --scheme
   mumidi`` -> ``cli.train model=popmag`` (B 8, max_bars 16, max_bar_len
   96; 3 f32 steps, the same run cut after step 0 and resumed with equal
   losses, 1 bf16 step) -> ``cli.generate`` from the checkpoint directory
   (B 8, 16 bars, exactly 400 D launches a bar) -> ``cli.serve`` file mode
   (24 requests of 2-16 bars, 8 slots, exactly 400 D launches a bar step),
   every MIDI read back; arrangement bars/s and decoder steps/s at B 8
   (f32, bf16), the f32 train step's time and busy share; kernel D at
   PoPMAG's step beside its bound, plain version and cuDNN;
15. the RNN families' training (``rnn_train_paths``) at their full
   widths (EventMelodyRNN 308/32/512/3, PerformanceRNN with 24 controls,
   MelodyRNN 130/64/64/2 with attn_length 0 and 40), f32, B 8: 8
   synthetic MIDI files through ``cli.tokenize`` as ``midilike``,
   ``midilike_control`` and ``melody``; ``cli.train`` for EventMelodyRNN
   in segment mode, window mode 200/10 with scheduled sampling at 0.5 and
   sequence mode, PerformanceRNN on the control corpus and MelodyRNN, 3
   steps each, the same run cut after step 1 and resumed to equal losses
   (1e-3), no kernel D launched; one f32 step (dropout 0) on the card
   against the same step on the CPU (loss 1e-5, grad norm 1e-4
   relative); from the trained EventMelodyRNN and PerformanceRNN step
   files ``cli.generate`` (B 8, 512 sampled tokens; PerformanceRNN under
   ``--control <corpus dir>``) and ``cli.serve`` (24 requests) with
   exactly 3 kernel-D launches a decode step, and greedy f32 kernel path
   == plain path on the trained weights; the EventMelodyRNN window
   step's time and busy share;
16. MelodyRNN from its step files (``melody_paths``, attn_length 0 and
   40): ``cli.generate`` (B 8, 512 sampled tokens, MIDI read back),
   greedy f32 serving of 8 staggered requests == one dedicated
   ``generate`` at the pool width, decode tokens/s at B 8, ``cli.serve``
   goodput (24 requests) and the train step's time and busy share;
17. data parallelism (``dp_paths``) on virtual meshes of the card (NCCL
   refuses two ranks on one GPU): ``generate_dp`` of the flagship in bf16
   (B 8, the 500-token prime, 512 sampled tokens) on 2 and 4 shards with
   exactly 6 A launches a shard prefill and 18 B a shard step, tokens/s
   beside ``generate``'s (no scaling claim), greedy f32 ``generate_dp`` ==
   ``generate``; CP ``generate_cp(mesh=)`` (4 A, 12 B), both GRU families
   (cache0, controls) and PoPMAG ``generate_arrangement_dp`` (kernel D
   exactly) greedy-equal to their unsharded runs; one f32 train step of
   the flagship with its loss taken a data shard at a time (2 shards
   holding different numbers of pad targets) against the step on the
   whole batch (6 A + 6 C a shard); ``cli.train fsdp=true`` (3 f32 steps
   under a one-rank NCCL group, started as torchrun starts one rank)
   against the same
   run without it, and the bf16 step under FSDP2 and without,
   interleaved; ``cli.generate --dp 2`` exits on one card;
18. the checkpoint CLIs (``checkpoint_cli``): the fsdp run exported by
   ``cli.export_checkpoint`` and imported by ``cli.import_checkpoint``;
   ``cli.generate`` from the imported run writes the original run's MIDI
   bytes (exactly 6 A and 18 B a step); ``cli.check_install`` exits 0;
19. tensor and pipeline parallelism on virtual meshes of the card
   (``tp_paths``, ``pp_paths``, ``dryrun``): kernels A and C on a head
   shard's heads, H 2 (tp 2) and H 1 (tp 4), B 8, L 512, f32 and bf16,
   against their plain versions (A also key-padded at max_seq 2048, as
   ``generate_tp``'s prefill takes it) and timed in bf16 beside their
   bounds; f32 dropout-0 train steps of the flagship (B 8, seq 512) at
   tp 2 and tp 4 (exactly 6 tp A and 6 tp C a step) and tp 8, which does
   not divide the 4 heads (the attention block replicated: exactly 6 A
   and 6 C on all heads), tp 2 x sp 2
   through kernel G (exactly 24 G, 0 A, 0 C), pp 2 with 2 and 4
   micro-batches and pp 3 with 4 (exactly 6 n_micro A and C), each
   against the unsharded step; greedy f32 ``generate_tp`` == ``generate``
   at tp 2, 4 and 8 (64 tokens after the 500-token prime, exactly 6 tp A
   a prefill, 6 at tp 8, and no kernel B) and sampled bf16 ``generate_tp`` at tp 2 equal
   to itself twice; bf16 step ms and busy share of tp 2 and pp 2 against
   the unsharded step, ``generate_tp`` tokens/s against ``generate``'s
   (one card: no scaling claim); ``graft_entry.dryrun_multichip(4)``;
20. the native MIDI scanner and codecs (``native_codecs``; host C++,
   built by the host compiler beside the kernels in phase 2): 32
   MAESTRO-sized piano performances (4,000-8,000 notes) and 8 six-role
   pieces written with the port's MIDI writer; every native entry point
   called directly on every file, none None, each byte-equal to the
   port's Python path; ``cli.tokenize --workers 1`` files/s of each
   scheme, native and under ``MG_NATIVE=0``, the shards equal (the
   training phases' corpus, ``write_corpus``, is tokenized natively too);
21. one JSON line of kernels, the card's line, and the final JSON line.

Imports nothing of JAX or of ``musicgeneration_tpu``. Needs one CUDA card.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import os
import platform
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
    bucket_prompt, dp_mesh, melody_compound_from_midi, parse_control,
    prime_tokens, write_midi)
from musicgeneration_tpu_torch.cli.check_install import (  # noqa: E402
    main as check_install_main)
from musicgeneration_tpu_torch.cli.export_checkpoint import (  # noqa: E402
    main as export_main)
from musicgeneration_tpu_torch.cli.import_checkpoint import (  # noqa: E402
    main as import_main)
from musicgeneration_tpu_torch.cli import train as train_cli  # noqa: E402
from musicgeneration_tpu_torch.cli.eval import main as eval_main  # noqa: E402
from musicgeneration_tpu_torch.cli.generate import main as cli_main  # noqa: E402
from musicgeneration_tpu_torch.convert import load_checkpoint  # noqa: E402
from musicgeneration_tpu_torch.cli.serve import main as serve_main  # noqa: E402
from musicgeneration_tpu_torch.cli.tokenize import (  # noqa: E402
    main as tokenize_main)
from musicgeneration_tpu_torch.data.pipeline import TokenCorpus  # noqa: E402
from musicgeneration_tpu_torch.data.prefetch import to_device  # noqa: E402
from musicgeneration_tpu_torch.decode import (  # noqa: E402
    DecodeParams, SamplingParams, SpecParams, generate, generate_dp,
    generate_speculative)
from musicgeneration_tpu_torch.decode.cp_generate import (  # noqa: E402
    generate_cp, sample_row)
from musicgeneration_tpu_torch.decode.serving_cp import (  # noqa: E402
    CPContinuousBatcher)
from musicgeneration_tpu_torch.decode.serving import (  # noqa: E402
    ContinuousBatcher)
from musicgeneration_tpu_torch.decode.serving_rnn import (  # noqa: E402
    RNNContinuousBatcher)
from musicgeneration_tpu_torch.models import cp_transformer as cp_mod  # noqa: E402
from musicgeneration_tpu_torch.models import music_transformer as mt  # noqa: E402
from musicgeneration_tpu_torch.models import (  # noqa: E402
    EventMelodyRNN, MelodyRNN, PerformanceRNN, PoPMAGRNN)
from musicgeneration_tpu_torch.decode.popmag_generate import (  # noqa: E402
    flatten_arrangement, generate_arrangement, generate_arrangement_dp)
from musicgeneration_tpu_torch.decode.serving_popmag import (  # noqa: E402
    PopMAGContinuousBatcher)
from musicgeneration_tpu_torch.midi import (  # noqa: E402
    ControlChange, Instrument, MidiFile, Note, TempoChange)
from musicgeneration_tpu_torch.tokenizers.mumidi import (  # noqa: E402
    MuMIDI_EventSeq, native_split_arrays)
from musicgeneration_tpu_torch.ops import gru as gru_mod  # noqa: E402
from musicgeneration_tpu_torch.ops import cuda_build  # noqa: E402
from musicgeneration_tpu_torch.ops.decode_loop import (  # noqa: E402
    fused_decode_loop, fused_decode_loop_plain, gumbel, inv_temperature,
    loop_bits, loop_sample, loop_sample_kernel, loop_takes_cluster,
    pack_loop_matrices, sample_mask)
from musicgeneration_tpu_torch.ops.fused_attention import (  # noqa: E402
    fused_relative_attention, fused_relative_attention_bwd,
    fused_relative_attention_bwd_plain, fused_relative_attention_plain)
from musicgeneration_tpu_torch.ops.fused_decode import (  # noqa: E402
    fused_decode_chunk, fused_decode_chunk_plain, fused_decode_step,
    fused_decode_step_plain)
from musicgeneration_tpu_torch.ops.fused_gru_decode import (  # noqa: E402
    fused_gru_step, fused_gru_step_plain, pack_gru_weights)
from musicgeneration_tpu_torch.ops.relative_attention import (  # noqa: E402
    NEG_INF)
from musicgeneration_tpu_torch.ops.ring_attention import (  # noqa: E402
    ring_tile, ring_tile_plain)
from musicgeneration_tpu_torch.decode.engine import (  # noqa: E402
    generate_tp)
from musicgeneration_tpu_torch.graft_entry import (  # noqa: E402
    dryrun_multichip)
from musicgeneration_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_pipeline_apply, ring_relative_attention,
    ring_relative_attention_pallas, shard_batch)
from musicgeneration_tpu_torch.parallel.ring_attention import (  # noqa: E402
    to_shards)
from musicgeneration_tpu_torch.tokenizers import (  # noqa: E402
    cp, melody, midilike, pedal_midilike, remi)
from musicgeneration_tpu_torch import native  # noqa: E402
from musicgeneration_tpu_torch.train.objective import (  # noqa: E402
    smooth_cross_entropy, token_accuracy)
from musicgeneration_tpu_torch.train.trainer import (  # noqa: E402
    TrainerConfig, create_train_state, kept_count, make_eval_step,
    make_optimizer, make_train_step)
from musicgeneration_tpu_torch.utils.checkpoint import (  # noqa: E402
    latest_checkpoint, list_checkpoints)
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
LEFT_PAD = 3  # kernel A's check: keys padded at the start of a row
# serving windows that begin with pad ids: more than one 64-row query tile
PAD_HEAD = 70
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
# their event_dim on the REMI and pedal corpora (the scheme's vocabulary
# less the pad id, as cli.train sets it); the scheme phase trains
# EventMelodyRNN on remi and PerformanceRNN on pedal, GS_STEPS crop steps
# of GS_SEQ each, decodes GS_GREEDY greedy f32 tokens after the
# 500-token prime and serves cli.serve's N_SERVE requests
GS_WIDTHS = {"remi": 336, "pedal": 389}
GS_RUNS = (("event_rnn", "remi"), ("performance_rnn", "pedal"))
GS_STEPS, GS_SEQ, GS_GREEDY = 2, 200, 64
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
# kernels B and E in bf16 at other widths the wrapper takes, (d, FFN,
# layers, max_seq, t): the `--spec` draft (d 128, FFN 64: the tail's CTAs
# 4-7 own no FFN column); d 576 (9 heads: the tail's 8 CTAs own 72
# columns each, up to 3 heads); an FFN of 100, not a multiple of 8; d 960
# with FFN 4096, the tail's largest shared memory (120 columns a CTA);
# and a 16384-row table at t 9000 (71 split records a row)
DECODE_WIDTHS = ((DRAFT_D, DRAFT_D // 2, DRAFT_LAYERS, MAX_SEQ, T_TIMED),
                 (576, 288, 2, MAX_SEQ, T_TIMED),
                 (D_MODEL, 100, 2, MAX_SEQ, T_TIMED),
                 (960, 4096, 1, MAX_SEQ, T_TIMED),
                 (DRAFT_D, DRAFT_D // 2, DRAFT_LAYERS, 16384, 9000))
RATE_PROMPT, RATE_CACHE, RATE_ROUNDS = 16, 1024, 3
# the Compound Word transformer at the repo's defaults
# (cp_transformer_defaults: 4 layers, d 256, 4 heads, FFN 128, max_seq
# 1024; 8 field heads over 347 ids): cli.generate B 8, the prime cut to
# max_seq - 512 = 512 rows, 512 rows (128 with --quant int8); greedy
# parity at a 256-row prompt, 64 rows; serving 24 requests of 64-320 new
# rows; training at seq_len 512. Kernel B's CP cases (t, cache rows): a
# 1024-row cache (the E table's length) and an aligned 768-row one,
# shorter than the table, up to its last row
CP_LAYERS, CP_MAX_SEQ, CP_PROMPT, CP_STEPS = 4, 1024, 512, 512
CP_PARITY_PROMPT, CP_GREEDY, CP_INT8_STEPS = 256, 64, 128
CP_SERVE_NEW = (64, 321)
CP_PARITY_LENS = (1, 3, 64, 200, 500, 17, 100, 33)   # staggered serving
CP_PARITY_NEWS = (64, 128, 96, 64, 100, 80, 128, 72)
CP_B_CASES = ((700, 1024), (1023, 1024), (0, 768), (700, 768), (767, 768))
# ring attention (kernel G): the main shape is L 2048 = max_seq over sp 4
# (Lloc 512), B 8, bf16; the check also takes sp 8, L 512 and the ragged
# Lloc 25 and 17. Kernel G vs its plain tile: f32 max abs TOL_G; the f32
# carry (m, l, acc) within TOL_G relative, on the rows that have seen an
# unmasked key (the kernel's contract); bf16 outputs within one bf16 ulp
# of the plain output plus TOL_G_SUM: each rounds its own f32 quotient
# once, and the two quotients differ by the f32 summation order (<= 1.7e-6
# in f32 on the card) and, in bf16, by the split products' ~2^-17 of each
# product, which is more than a bf16 ulp for outputs below ~1e-4; and
# within one bf16 ulp alone where |out| >= 2^-8
SP_RING, L_RING = 4, MAX_SEQ
RING_CASES = ((4, MAX_SEQ), (8, MAX_SEQ), (4, 512), (4, 100), (4, 68))
TOL_G, TOL_G_SUM = 1e-4, 1e-5
# kernels A, G and C before their tensor-core bodies: their bf16 mode ran
# the CUDA-core body that is now the f32 mode's. Each source is built a
# second time behind a C entry point of the same name and signature that
# sends bf16 to that body, so the wrapper times it on the same inputs
# (earlier_ms)
EARLIER_SHIMS = {
    "relative_attention": """
#define mg_rel_attn_fwd mg_rel_attn_fwd_tc
#include "relative_attention.cu"
#undef mg_rel_attn_fwd
extern "C" int mg_rel_attn_fwd(int is_bf16, const void* q, const void* k,
                               const void* v, const void* e,
                               const void* key_pad, void* out, void* lse,
                               int B, int H, int L, int max_seq, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, e, key_pad, out, lse, B, H,
                                        L, max_seq, causal, s);
  return launch<float>(q, k, v, e, key_pad, out, lse, B, H, L, max_seq,
                       causal, s);
}
""",
    "ring_attention": """
#define mg_ring_tile mg_ring_tile_tc
#include "ring_attention.cu"
#undef mg_ring_tile
extern "C" int mg_ring_tile(int is_bf16, const void* q, const void* k,
                            const void* v, const void* pad, const void* e,
                            void* m, void* l, void* acc, void* out, int S,
                            int B, int H, int Lloc, int max_seq, int rank0,
                            int r, int n, int nkv, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, pad, e, m, l, acc, out, S,
                                        B, H, Lloc, max_seq, rank0, r, n,
                                        nkv, causal, s);
  return launch<float>(q, k, v, pad, e, m, l, acc, out, S, B, H, Lloc,
                       max_seq, rank0, r, n, nkv, causal, s);
}
"""}
EARLIER_SHIMS["relative_attention_bwd"] = """
#define mg_rel_attn_bwd mg_rel_attn_bwd_tc
#define mg_rel_attn_bwd_scratch mg_rel_attn_bwd_scratch_tc
#include "relative_attention_bwd.cu"
#undef mg_rel_attn_bwd
#undef mg_rel_attn_bwd_scratch
extern "C" long long mg_rel_attn_bwd_scratch(int is_bf16, int B, int H,
                                             int L) {
  return scratch<false>(B, H, L);
}
extern "C" int mg_rel_attn_bwd(int is_bf16, const void* q, const void* k,
                               const void* v, const void* e, void* e_lp,
                               const void* key_pad, const void* out,
                               const void* dout, const void* lse, void* delta,
                               void* dq, void* dk, void* dv, void* de,
                               void* de_part, int B, int H, int L,
                               int max_seq, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(q, k, v, e, e_lp, key_pad, out, dout,
                                        lse, delta, dq, dk, dv, de, de_part,
                                        B, H, L, max_seq, causal, s);
  return launch<float>(q, k, v, e, e_lp, key_pad, out, dout, lse, delta, dq,
                       dk, dv, de, de_part, B, H, L, max_seq, causal, s);
}
"""
# kernels B and E: the bf16 body before the tensor-core design of
# decode_tc.cuh (unquantized and int8); kernel F: the bf16 body before the
# cluster design (one block a batch row, now the f32 mode's)
EARLIER_SHIMS["fused_decode"] = """
#define mg_decode_step mg_decode_step_tc
#define mg_decode_chunk mg_decode_chunk_tc
#define mg_decode_loop mg_decode_loop_tc
#include "fused_decode.cu"
#undef mg_decode_step
#undef mg_decode_chunk
#undef mg_decode_loop
extern "C" int mg_decode_loop(int is_bf16, int num_layers, void* logits,
                              void* tokens, int tok_stride, const void* seed,
                              const void* const* w, const void* const* packed,
                              const void* embed,
                              const void* pos, const void* fc_w,
                              const void* fc_b, void* kc, void* vc,
                              const void* e, int B, int C, int S, int d,
                              int H, int f, int V, int t0, int max_seq,
                              float scale, float inv_temp, int greedy,
                              int top_k, int use_p, float top_p,
                              void* stream) {
  const LoopSampling sp{inv_temp, greedy, top_k, use_p, top_p};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || H > LOOP_WARPS || d % 8 || f % 8 || f > 8 * LOOP_THREADS)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return decode_loop<__nv_bfloat16, false>(
        num_layers, logits, tokens, tok_stride, seed, w, nullptr, embed, pos,
        fc_w, fc_b, kc, vc, e, B, C, S, d, H, f, V, t0, max_seq, scale, sp,
        s);
  return decode_loop<float>(num_layers, logits, tokens, tok_stride, seed, w,
                            nullptr, embed, pos, fc_w, fc_b, kc, vc, e, B, C,
                            S, d, H, f, V, t0, max_seq, scale, sp, s);
}
extern "C" int mg_decode_step(int is_bf16, int num_layers, void* x,
                              void* qbuf, void* part, const void* const* w,
                              const void* const* sc, void* kc, void* vc,
                              const void* e, const void* start, int B, int S,
                              int d, int H, int f, int t, int max_seq,
                              int split0, void* stream) {
  return launch<false>(false, is_bf16, num_layers, x, qbuf, part, w, sc, kc,
                       vc, e, start, B, 1, S, d, H, f, t, max_seq, split0,
                       stream);
}
extern "C" int mg_decode_chunk(int is_bf16, int num_layers, void* x,
                               void* qbuf, void* part, const void* const* w,
                               const void* const* sc, void* kc, void* vc,
                               const void* e, int B, int C, int S, int d,
                               int H, int f, int t, int max_seq,
                               void* stream) {
  if (C < 2 || C > MAX_CHUNK) return (int)cudaErrorInvalidValue;
  return launch<false>(true, is_bf16, num_layers, x, qbuf, part, w, sc, kc,
                       vc, e, nullptr, B, C, S, d, H, f, t, max_seq, 0,
                       stream);
}
"""
# kernel D: the bf16 body before the tensor-core design (the CUDA-core
# body, now the f32 mode's, with its staging loads batched)
EARLIER_SHIMS["fused_gru_decode"] = """
#define mg_gru_step mg_gru_step_tc
#include "fused_gru_decode.cu"
#undef mg_gru_step
extern "C" int mg_gru_step(int is_bf16, int num_layers, const void* x,
                           int in, const void* h, void* hout,
                           const void* const* wih, const void* const* whh,
                           const void* const* bih, const void* const* bhh,
                           int B, int H, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_step<__nv_bfloat16, false>(num_layers, x, in, h, hout, wih,
                                             whh, bih, bhh, B, H, s);
  return launch_step<float>(num_layers, x, in, h, hout, wih, whh, bih, bhh,
                            B, H, s);
}
"""
# kernel F's bf16 body with its phase clocks (MG_LOOP_TRACE): thread 0 of
# CTA 0 of batch row 0 adds the clock64 cycles of each phase; built and
# run only with --loop-phases (profile_loop_phases)
TRACE_SHIM = """
#define MG_LOOP_TRACE
#include "fused_decode.cu"
extern "C" int mg_loop_trace(void* out, int reset) {
  if (reset) {
    unsigned long long zero[LC_PHASES] = {};
    return (int)cudaMemcpyToSymbol(mg_loop_phase_cycles, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(out, mg_loop_phase_cycles,
                                   sizeof(unsigned long long) * LC_PHASES);
}
"""
LOOP_PHASES = ("sampler and embedding", "q, k, v products", "barrier: q, k, v",
               "scores", "maxima and barrier", "softmax and PV",
               "barrier: (l, PV)", "merge, fc", "barrier: z (LN1)",
               "LN1, FFN1", "barrier: hidden", "FFN2", "barrier: z (LN2)",
               "LN2", "head", "barrier: logits",
               # waits inside the phases above
               "of which waiting for weight slots",
               "of which waiting for staged rows")
EARLIER_LIBS = {}  # name -> built library of EARLIER_SHIMS (and the trace)
RING_STEPS = 3  # timed train steps, each path
# timing: 64 MB written between calls evicts the 50 MB L2
FLUSH_BYTES = 64 << 20
_SPIN_CYCLES_PER_MS = []


@functools.lru_cache(maxsize=None)
def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_rows(prof) -> list:
    """(device us, count, name) of each kernel in a torch.profiler run:
    device-side events only (a CPU op's device time repeats the time of
    the kernels it launched), and no annotation ranges (FSDP's
    ``FSDP::pre_forward`` and the like span kernels counted already)."""
    rows = []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
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


def host_ms(fn, iters: int) -> float:
    """Wall time of one ``fn()`` call on the host clock, averaged over
    ``iters`` calls after a warm one, the device idle before and after:
    for a plain version that reads a result back (kernel F's, ragged
    B's), which ends any spin queued before it, so ``device_ms`` could not
    hold it. Its time includes the host's gaps."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


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


def start_earlier_builds(loop_phases: bool = False) -> dict:
    """Start one ``nvcc`` for each of ``EARLIER_SHIMS`` (and, with
    ``loop_phases``, the trace build of kernel F), with the port's flags,
    into the build directory; ``finish_earlier_builds`` waits."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = {}
    shims = dict(EARLIER_SHIMS)
    if loop_phases:
        shims["fused_decode_trace"] = TRACE_SHIM
    for name, text in shims.items():
        src = cuda_build.BUILD_DIR / f"earlier_{name}.cu"
        src.write_text(text)
        so = src.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             str(cuda_build.CSRC), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish_earlier_builds(procs: dict) -> dict:
    """Wait for the earlier bodies' builds; raise with nvcc's output if
    one failed. Returns the path of each library."""
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the earlier {name}:\n{log}")
    return {name: so for name, (so, _) in procs.items()}


@contextlib.contextmanager
def earlier_body(name: str):
    """Inside the block the wrapper of kernel ``name`` launches its
    earlier bf16 body (``EARLIER_SHIMS``)."""
    lib = cuda_build.load(name)
    cuda_build._LIBS[name] = ctypes.CDLL(str(EARLIER_LIBS[name]))
    try:
        yield
    finally:
        cuda_build._LIBS[name] = lib


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_inputs(dtype, gen, with_pad: bool, l: int = L_PREFILL,
                max_seq: int = MAX_SEQ):
    shape = (B, H, l, DH)
    q, k, v = (torch.randn(shape, generator=gen).to(DEV, dtype)
               for _ in range(3))
    e = torch.randn(max_seq, DH, generator=gen).to(DEV)
    pad = None
    if with_pad == "all":  # no row has an unmasked key: with the -1e9
        # masks every logit is -1e9 and each row the mean of V
        pad = torch.ones(B, l, device=DEV)
    elif with_pad == "left":  # keys 0 .. LEFT_PAD - 1 padded: under
        # causal, rows 0 .. LEFT_PAD - 1 reach no unmasked key
        pad = torch.zeros(B, l, device=DEV)
        pad[:, :LEFT_PAD] = 1.0
    elif with_pad:  # a bucket tail, as the main path's 500 tokens of 512;
        # key 0 is never padded (a prompt has at least one token)
        pad = torch.zeros(B, l)
        pad[:, max(1, l - (L_PREFILL - PROMPT)):] = 1.0
        pad = pad.to(DEV)
    return q, k, v, e, pad


def check_kernel_a() -> float:
    gen = torch.Generator().manual_seed(1)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    # (dtype, key_pad, causal, L, max_seq); the main path is bf16, causal,
    # key_pad; L 1 is a one-token admission prompt, L 17 and 100 ragged
    # tiles, L 2048 max_seq, max_seq 512 the training shape, and every key
    # padded, non-causal: rows with no unmasked key over all 8 key tiles.
    # With the first keys padded ("left"), causal, rows 0 .. LEFT_PAD - 1
    # reach no unmasked key: the kernel's extended walk past the causal
    # tiles (the csrc note) must give them the plain version's average over
    # the single-mask keys, held to the same tolerance as every other row
    cases = [(f32, False, True, L_PREFILL, MAX_SEQ),
             (f32, True, True, L_PREFILL, MAX_SEQ),
             (bf16, False, True, L_PREFILL, MAX_SEQ),
             (bf16, True, True, L_PREFILL, MAX_SEQ),
             (f32, True, False, L_PREFILL, MAX_SEQ),
             (f32, True, True, 100, MAX_SEQ), (bf16, True, True, 100, MAX_SEQ)]
    cases += [(dtype, with_pad, True, l, MAX_SEQ) for l in (1, 17, MAX_SEQ)
              for dtype in (f32, bf16) for with_pad in (False, True)]
    cases += [(dtype, False, True, L_TRAIN, L_TRAIN) for dtype in (f32, bf16)]
    cases += [(dtype, "all", False, L_PREFILL, MAX_SEQ)
              for dtype in (f32, bf16)]
    cases += [(dtype, "left", True, L_PREFILL, MAX_SEQ)
              for dtype in (f32, bf16)]
    for dtype, with_pad, causal, l, max_seq in cases:
        q, k, v, e, pad = attn_inputs(dtype, gen, with_pad, l, max_seq)
        out, lse = fused_relative_attention(q, k, v, e, pad, causal,
                                            return_lse=True)
        ref, ref_lse = fused_relative_attention_plain(q, k, v, e, pad, causal,
                                                      return_lse=True)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        ok = err <= TOL_A[dtype] and lse_err <= 1e-3
        print(f"kernel A {str(dtype):15s} L={l:4d} max_seq={max_seq:4d} "
              f"key_pad={with_pad!s:5s} causal={causal!s:5s} "
              f"max_abs_err={err:.3e} lse_err={lse_err:.3e} "
              f"tol={TOL_A[dtype]:.1e} {'ok' if ok else 'FAIL'}"
              + (f"; rows 0-{LEFT_PAD - 1} (every reachable key padded): "
                 f"max_abs_err={diff[:, :, :LEFT_PAD].max().item():.3e}"
                 if with_pad == "left" else ""))
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
    2048), plus L 100, 17 and 1 (ragged tiles, a one-row tile), causal and
    not, with and without key padding. Outputs must be finite, E rows no
    (t, s) pair touches exactly 0, and a second call on the same inputs
    bit-equal to the first. At L 1 dq, dk and dE are rounding noise
    around 0 on both sides (below), held to TOL_C against the size of
    the terms whose difference they are."""
    gen = torch.Generator().manual_seed(6)
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(ms, dtype, causal, with_pad, L_TRAIN)
             for ms in (L_TRAIN, MAX_SEQ) for dtype in (f32, bf16)
             for causal in (True, False) for with_pad in (False, True)]
    cases += [(MAX_SEQ, dtype, causal, with_pad, l) for l in (100, 17, 1)
              for dtype in (f32, bf16) for causal in (True, False)
              for with_pad in (False, True)]
    for ms, dtype, causal, with_pad, l in cases:
        q, k, v, _, pad = attn_inputs(dtype, gen, with_pad, l)
        e = torch.randn(ms, DH, generator=gen).to(DEV)
        dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
        out, lse = fused_relative_attention(q, k, v, e, pad, causal,
                                            return_lse=True)
        got = fused_relative_attention_bwd(q, k, v, e, pad, causal, out, lse,
                                           dout)
        again = fused_relative_attention_bwd(q, k, v, e, pad, causal, out,
                                             lse, dout)
        ref = fused_relative_attention_bwd_plain(q, k, v, e, pad, causal,
                                                 out, lse, dout)
        torch.cuda.synchronize()
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        if l == 1:
            # one key: p = 1 and dP = delta, so dq, dk and dE are 0 in
            # exact arithmetic and both sides hold the f32 rounding of
            # dP - delta; those three are held relative to the size of
            # the terms that cancel, max |dO . v| * max |k| (|q| for dk
            # and dE) / sqrt(dh)
            dpm = ((dout.float() * v.float()).sum(-1).abs().max().item()
                   / math.sqrt(DH))
            cancel = [dpm * k.float().abs().max().item(),
                      dpm * q.float().abs().max().item(), 0.0,
                      dpm * q.float().abs().max().item()]
            errs = [(a.float() - r.float()).abs().max().item()
                    / max(r.float().abs().max().item(), c, 1e-30)
                    for a, r, c in zip(got, ref, cancel)]
        abs_err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(got, ref))
        untouched_zero = (got[3][:ms - l].abs().max().item() == 0.0
                          if ms > l else True)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = max(errs) <= TOL_C[dtype] and untouched_zero and same and all(
            bool(torch.isfinite(a).all()) for a in got)
        print(f"kernel C {str(dtype):15s} max_seq={ms:4d} L={l:4d} "
              f"key_pad={with_pad!s:5s} causal={causal!s:5s} rel_err "
              f"dq={errs[0]:.2e} dk={errs[1]:.2e} dv={errs[2]:.2e} "
              f"de={errs[3]:.2e} max_abs_err={abs_err:.2e} "
              f"untouched_de_zero={untouched_zero} bit_equal_rerun={same} "
              f"tol={TOL_C[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel C disagrees with its plain version")
        if dtype == bf16:
            worst = max(worst, abs_err)
    return worst


def check_kernel_c_left_pad() -> None:
    """Kernel C on rows that reach no unmasked key, against its plain
    backward from the same forward: keys 0 .. LEFT_PAD - 1 padded, causal
    (the extended walk: flagged query tiles' dq blocks past the diagonal,
    dkv blocks before it), and every key padded, not causal (each row at
    the -1e9 floor over all L keys); L 512, max_seq 2048, f32 and bf16.
    On such a row the prep launch scales p to sum to 1 (the csrc note):
    dq, dk, dv and dE within TOL_C, a second call bit-equal to the
    first."""
    gen = torch.Generator().manual_seed(27)
    for with_pad, causal in (("left", True), ("all", False)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, e, pad = attn_inputs(dtype, gen, with_pad)
            dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
            o, lse = fused_relative_attention(q, k, v, e, pad, causal,
                                              return_lse=True)
            got = fused_relative_attention_bwd(q, k, v, e, pad, causal, o,
                                               lse, dout)
            again = fused_relative_attention_bwd(q, k, v, e, pad, causal, o,
                                                 lse, dout)
            ref = fused_relative_attention_bwd_plain(q, k, v, e, pad, causal,
                                                     o, lse, dout)
            torch.cuda.synchronize()
            errs = [rel_err(a, r) for a, r in zip(got, ref)]
            rows = rel_err(got[0][:, :, :LEFT_PAD], ref[0][:, :, :LEFT_PAD])
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = max(errs) <= TOL_C[dtype] and same and all(
                bool(torch.isfinite(a).all()) for a in got)
            print(f"kernel C {str(dtype):15s} key_pad={with_pad} "
                  f"causal={causal!s:5s}: rel_err dq={errs[0]:.2e} "
                  f"dk={errs[1]:.2e} dv={errs[2]:.2e} de={errs[3]:.2e} (dq "
                  f"rows 0-{LEFT_PAD - 1} {rows:.2e}) bit_equal_rerun={same} "
                  f"tol={TOL_C[dtype]:.0e} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel C disagrees with its plain "
                                     "version on rows at the -1e9 floor")


def flagship(dtype, seed: int = 0, quant: str = "none",
             d_model: int = D_MODEL, vocab: int = VOCAB) -> mt.MusicTransformer:
    """The flagship (or, with ``d_model=D_RUNG``, the d 1024 rung; with
    ``vocab``, another scheme's vocabulary) with seeded random weights."""
    return mt.MusicTransformer(
        vocab_size=vocab, num_layers=N_LAYERS, d_model=d_model,
        max_seq=MAX_SEQ, dtype=dtype, device=DEV,
        generator=torch.Generator().manual_seed(seed), decode_quant=quant)


def decode_inputs(model, gen, b: int = B, cache_len: int = 1024):
    """x [b, d] and filled [L, b, cache_len, d] caches in the model dtype;
    the model's stacked weights (an int8 model's hold their "int8"
    pair)."""
    w_all, e_all = model.decode_weights()
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
    """Kernel D against its plain version at both GRU language models'
    full width (in 308 and 512, H 512, 3 layers) for B 1, 4, 8 and 64, at
    their REMI and pedal widths (in 336, rows 16-byte aligned, and 389,
    neither padded nor aligned: the staging branch for unaligned rows)
    for B 1, 8 and 64, at PoPMAG's decoder width (in 256, H 256, 2
    layers: 64 CTAs in bf16) for B 1, 8 and 32, f32 and bf16, and at a
    small shape (in 32, H 32, 2 layers); its inputs unchanged."""
    gen = torch.Generator().manual_seed(21)
    worst = 0.0
    cases = [(b, in_dim, RNN_HIDDEN, RNN_LAYERS, dtype)
             for in_dim in (EVENT_DIM, RNN_HIDDEN) for b in (1, 4, 8, 64)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(b, GS_WIDTHS[scheme], RNN_HIDDEN, RNN_LAYERS, dtype)
              for scheme in GS_WIDTHS for b in (1, 8, 64)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(b, PM_HIDDEN, PM_HIDDEN, PM_LAYERS, dtype)
              for b in PM_D_BATCHES
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
    forward), B (the CP transformer's decode step), F (the decode loop),
    D (the GRU step)."""
    saved = (mt.fused_relative_attention, mt.fused_decode_step,
             mt.fused_decode_chunk, mt.fused_decode_loop,
             gru_mod.fused_gru_step, cp_mod.fused_decode_step)
    mt.fused_relative_attention = fused_relative_attention_plain
    mt.fused_decode_step = fused_decode_step_plain
    mt.fused_decode_chunk = fused_decode_chunk_plain
    mt.fused_decode_loop = fused_decode_loop_plain
    gru_mod.fused_gru_step = fused_gru_step_plain
    cp_mod.fused_decode_step = fused_decode_step_plain
    try:
        yield
    finally:
        (mt.fused_relative_attention, mt.fused_decode_step,
         mt.fused_decode_chunk, mt.fused_decode_loop,
         gru_mod.fused_gru_step, cp_mod.fused_decode_step) = saved


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
          f"decode {tok_s:.1f} tokens/s (B={B}, {STEPS} steps, host clock)",
          f"on {gpu_line()}")

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
                   quant: str = "none", prompt_len: int = L_PREFILL,
                   earlier: bool = False) -> None:
    """Where a bf16 decode step's time goes (the flagship, or the d 1024
    rung; unquantized or int8; with ``earlier``, kernel B's earlier
    CUDA-core body): device time by kernel and the device's busy share of
    the wall time, under torch.profiler, over the steps at t = prompt_len
    + warm ... Kernels B's three launches a layer overlap (programmatic
    dependent launch: each starts while its predecessor runs and waits
    for it), so their times here include that wait and their sum can pass
    the wall time; ``time_kernel_b`` gives the step's time."""
    if earlier:
        with earlier_body("fused_decode"):
            return profile_decode(steps, warm, d_model, quant, prompt_len)
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16, quant=quant, d_model=d_model)
    prompt = torch.randint(0, VOCAB - 1, (B, prompt_len), device=DEV,
                           generator=torch.Generator(DEV).manual_seed(5))
    logits, cache = model.prefill(prompt, prompt_len + warm + steps)
    stacked = model.decode_weights()
    t = prompt_len
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
    print(f"decode profile d={d_model} {quant}: {steps} steps at t "
          f"{prompt_len + warm}-{t - 1} (decode_step + argmax), wall "
          f"{wall_us / steps:.1f} us/step under the profiler, device busy "
          f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f}% "
          f"of wall)", f"on {gpu_line()}")
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
          f"write): {summary}", f"on {gpu_line()}")
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


def serve_parity(prime: np.ndarray, quant: str = "none",
                 pad_head: int = 0) -> None:
    """Greedy f32 serving of 8 staggered requests (3 admitted later,
    mid-flight) through the kernels and through their plain versions:
    the tokens must be equal. ``quant``: the model's decode_quant. With
    ``pad_head`` every window begins with that many pad ids, which the
    admission prefill masks: its first rows reach no unmasked key (kernel
    A's extended walk)."""
    model32 = flagship(torch.float32, quant=quant)
    lens = (1, 3, 64, 200, 500, 17, 100, 33)
    news = (64, 128, 96, 64, 100, 80, 128, 72)
    head = np.full(pad_head, model32.pad_id, dtype=prime.dtype)
    prompts = [np.concatenate([head, prime[:p]]) for p in lens]
    outs = []
    for plain in (False, True):
        cb = ContinuousBatcher(model32, slots=SLOTS, seg_len=SEG,
                               depth=DEPTH,
                               sampling=SamplingParams(greedy=True))
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(x, n) for x, n in zip(prompts[:5], news[:5])]
            cb.step()
            rids += [cb.submit(x, n) for x, n in zip(prompts[5:], news[5:])]
            done = cb.run()
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    print(f"serving greedy f32{' int8' if quant == 'int8' else ''}, "
          f"{len(lens)} staggered requests"
          + (f", each window beginning with {pad_head} pad ids"
             if pad_head else "")
          + f": kernel path == plain path: {same}")
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
        serve_parity(prime, pad_head=PAD_HEAD)
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
          f"({100 * busy_us / wall_us:.1f}% of wall)", f"on {gpu_line()}")
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
              f"(prefill included, host clock){extra}", f"on {gpu_line()}")
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
          f"decode {rate:.1f} tokens/s (B={B}, host clock)",
          f"on {gpu_line()}")
    return rate


def rnn_greedy_parity(family: str, prime: np.ndarray, model=None) -> None:
    """Greedy f32, 64 tokens at B 8 after the 500-token prompt: the
    kernel path's tokens equal the plain path's (random weights from a
    seed, or ``model``'s)."""
    model = model or rnn_model(family, torch.float32)
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
          f"{secs:.3f} s (load, warm, serve, write): {summary}",
          f"on {gpu_line()}")
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
          f"({100 * busy_us / wall_us:.1f}% of wall)", f"on {gpu_line()}")
    for dev_us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  {dev_us / steps:8.2f} us/step {count / steps:4.1f}x/step "
              f"{key[:90]}")


def gru_bound(b: int, in_dim: int, dtype, hd: int = RNN_HIDDEN,
              nl: int = RNN_LAYERS) -> tuple:
    """Least time of one GRU step at full width: the weights (rows of
    their true width), biases, x and h read once, the new h written;
    2 * b * 3H * (in_l + H) operations per layer."""
    e = torch.finfo(dtype).bits // 8
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
    from device memory, what the bound counts), each beside its earlier
    CUDA-core body in turns; its plain version;
    torch.nn.GRU (cuDNN) over one time step, the same function, also warm
    and flushed (``ms`` and ``library_ms`` are both flushed)."""
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
            warm, e_warm = with_earlier(step, "fused_gru_decode", iters=100)
            cold, e_cold = with_earlier(step, "fused_gru_decode", iters=100,
                                        flush=flush)
            bnd, by = gru_bound(b, in_dim, dtype)
            res[(family, b)] = (warm, cold, bnd, by, x, h, w, e_warm, e_cold)
            print(f"kernel D bf16 {family} in={in_dim} B={b}: warm "
                  f"{warm:.5f} ms, L2 flushed {cold:.5f} ms (earlier "
                  f"CUDA-core body, in turns: warm {e_warm:.5f} ms, flushed "
                  f"{e_cold:.5f} ms); bound {bnd:.5f} ms ({by}, weights "
                  f"from device memory)", f"on {gpu_line()}")
    warm, cold, bnd, by, x, h, w, e_warm, e_cold = res[("event_rnn", B)]
    plain_ms = device_ms(lambda: fused_gru_step_plain(x, h, w), iters=20)
    # the yardstick in the same call, like with like: cuDNN warm and with
    # L2 flushed before each call, as kernel D
    library = {}
    for name, ldt in (("bf16", dtype), ("f32", torch.float32)):
        gru = torch.nn.GRU(EVENT_DIM, RNN_HIDDEN, RNN_LAYERS).to(DEV, ldt)
        gru.flatten_parameters()   # one weight buffer, as cuDNN wants it
        xs, h0 = x[None].to(ldt), h.to(ldt)
        try:
            with torch.no_grad():
                library[name] = device_ms(lambda: gru(xs, h0))
                library[name + "_flushed"] = device_ms(lambda: gru(xs, h0),
                                                       flush=flush)
        except RuntimeError as e:      # a yardstick only; never on the path
            print(f"torch.nn.GRU {name}: {e}")
            library[name] = library[name + "_flushed"] = None
    print(f"torch.nn.GRU (cuDNN) one step, in={EVENT_DIM} B={B} L="
          f"{RNN_LAYERS}: bf16 {library['bf16']} ms warm, "
          f"{library['bf16_flushed']} ms L2 flushed; f32 {library['f32']} "
          f"ms warm, {library['f32_flushed']} ms L2 flushed; kernel D bf16 "
          f"{res[('event_rnn', B)][0]:.5f} ms warm, "
          f"{res[('event_rnn', B)][1]:.5f} ms L2 flushed", f"on {gpu_line()}")
    return {"name": "fused_gru_step", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_gru_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_gru_decode.py:108",
            "launches": launches, "max_abs_err": err, "ms": cold,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library["bf16_flushed"], "ms_warm": warm,
            "earlier_ms": e_cold, "earlier_ms_warm": e_warm,
            "earlier_ms_b1": res[("event_rnn", 1)][8],
            "earlier_ms_performance_rnn": res[("performance_rnn", B)][8],
            "library_ms_warm": library["bf16"],
            "library_ms_f32": library["f32_flushed"],
            "library_ms_f32_warm": library["f32"],
            "ms_b1": res[("event_rnn", 1)][1],
            "ms_b1_warm": res[("event_rnn", 1)][0],
            "bound_ms_b1": res[("event_rnn", 1)][2],
            "ms_performance_rnn": res[("performance_rnn", B)][1],
            "ms_performance_rnn_warm": res[("performance_rnn", B)][0],
            "bound_ms_performance_rnn": res[("performance_rnn", B)][2],
            "ms_performance_rnn_b1": res[("performance_rnn", 1)][1],
            "ms_performance_rnn_b1_warm": res[("performance_rnn", 1)][0]}


def time_kernel_d_shape(tag: str, in_dim: int, hidden: int, layers: int,
                        seed: int) -> dict:
    """Kernel D at one step shape (in ``in_dim``, H ``hidden``, ``layers``
    layers, B 8), bf16 and f32: device time warm and with L2 flushed,
    beside its bytes bound, its plain version and torch.nn.GRU (cuDNN)
    over one step of the same shape, warm and flushed. Keys ``ms_<tag>``,
    ``ms_<tag>_warm``, ``bound_ms_<tag>``, ... (``<tag>_f32`` for f32)."""
    gen = torch.Generator().manual_seed(seed)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    out = {}
    for name, dtype in (("", torch.bfloat16), ("_f32", torch.float32)):
        x, h, w = gru_inputs(B, in_dim, hidden, layers, dtype, gen)
        warm = device_ms(lambda: fused_gru_step(x, h, w))
        cold = device_ms(lambda: fused_gru_step(x, h, w), flush=flush)
        plain = device_ms(lambda: fused_gru_step_plain(x, h, w), iters=20)
        bnd, by = gru_bound(B, in_dim, dtype, hidden, layers)
        gru = torch.nn.GRU(in_dim, hidden, layers).to(DEV, dtype)
        gru.flatten_parameters()
        xs = x[None]
        with torch.no_grad():
            lib_warm = device_ms(lambda: gru(xs, h))
            lib_cold = device_ms(lambda: gru(xs, h), flush=flush)
        print(f"kernel D {str(dtype)[6:]} {tag} in={in_dim} H={hidden} "
              f"L={layers} B={B}: warm {warm:.5f} ms, L2 flushed "
              f"{cold:.5f} ms; bound {bnd:.5f} ms ({by}); plain "
              f"{plain:.4f} ms; torch.nn.GRU (cuDNN) one step warm "
              f"{lib_warm:.5f} ms, L2 flushed {lib_cold:.5f} ms",
              f"on {gpu_line()}")
        k = tag + name
        out.update({f"ms_{k}": cold, f"ms_{k}_warm": warm,
                    f"bound_ms_{k}": bnd, f"plain_ms_{k}": plain,
                    f"library_ms_{k}": lib_cold,
                    f"library_ms_{k}_warm": lib_warm})
    return out


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
        model, tcfg, _ = train_cli.build_model(cfg, "midilike", kw, DEV)
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
    step_parity(f"train-step parity f32 (B{B} L{L_TRAIN}, full width)",
                results[0], results[1], tx.lr(0))


def step_parity(label: str, kern: tuple, plain: tuple, lr: float) -> None:
    """Two f32 train steps from the same weights and batch, held to the
    train-step parity tolerances (PERF.md section 2): loss 1e-5 rel, grad
    norm 1e-4 rel, Adam moments TOL_MOMENT of each tensor's max (+1e-6 of
    the largest), parameters 2*lr + 1e-6."""
    (sk, mk), (sp, mp) = kern, plain
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
    print(f"{label}: loss "
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


def cut_and_resume(argv: list, run: str, stop_at: int) -> tuple:
    """``cli.train argv`` (checkpoints in ``run``) interrupted by a
    KeyboardInterrupt from the data stream at batch ``stop_at``, then run
    again to resume. Returns (the checkpoints the cut run left, the first
    batch the resumed run read)."""
    requested, real = [], train_cli._lm_batch_fn

    def recording(stop):
        def fn(corpus, cfg):
            at = real(corpus, cfg)

            def batch_at(idx):
                requested.append(idx)
                if idx == stop:
                    raise KeyboardInterrupt
                return at(idx)
            return batch_at
        return fn

    try:
        train_cli._lm_batch_fn = recording(stop_at)
        train_cli.main(argv)
        saved = [s for s, _ in list_checkpoints(run)]
        requested.clear()
        train_cli._lm_batch_fn = recording(-1)
        train_cli.main(argv)
    finally:
        train_cli._lm_batch_fn = real
    return saved, min(requested)


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
    with quiet(os.path.join(tmp, "train.log")):
        saved, first = cut_and_resume(train_args(shards, cut, TRAIN_STEPS),
                                      cut, CUT)
    resumed = losses(cut + ".jsonl")
    diff = max(abs(resumed[s] - ref[s]) for s in range(TRAIN_STEPS))
    ok = (saved[-1] == CUT - 1 and first == CUT
          and sorted(resumed) == list(range(TRAIN_STEPS)) and diff <= 1e-3)
    print(f"interrupt at step {CUT}: checkpoints {saved}; the resumed run "
          f"starts at batch {first}; its losses vs the "
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
    model, tcfg, _ = train_cli.build_model(cfg, "midilike",
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
          f"({100 * busy / wall_us:.1f}% of wall)", f"on {gpu_line()}")
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
    if "ring_tile" in name:
        return "kernel G (ring round)"
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

    def kernel_c():
        return fused_relative_attention_bwd(q, k, v, e, None, True, out, lse,
                                            dout)
    ms = device_ms(kernel_c)
    with earlier_body("relative_attention_bwd"):
        earlier_ms = device_ms(kernel_c)
    split = launch_split(kernel_c)
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
    print(f"kernel C bf16 B{B} H{H} L{L_TRAIN} causal, max_seq {L_TRAIN}: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}), SDPA forward + backward {library_ms:.4f} ms; earlier "
          f"(CUDA-core) body {earlier_ms:.4f} ms; per call under the "
          "profiler: " + ", ".join(f"{k} {us:.1f} us" for k, us in
                                   split.items()), f"on {gpu_line()}")
    return {"name": "relative_attention_bwd", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/relative_attention_bwd.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_attention.py:755",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "earlier_ms": earlier_ms,
            "us_per_launch": split}


def launch_split(fn, calls: int = 20) -> dict:
    """Device us per call of each CUDA kernel ``fn`` launches, under
    torch.profiler over ``calls`` calls (the kernels' names shortened)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for dev_us, _, key in sorted(device_rows(prof), reverse=True):
        name = re.search(r"(rel_attn_\w+)", key)
        name = name.group(1) if name else key[:40]
        split[name] = split.get(name, 0.0) + dev_us / calls
    return split


def time_kernel_a(launches: int, err: float) -> dict:
    dtype = torch.bfloat16
    q, k, v, e, pad = attn_inputs(dtype, torch.Generator().manual_seed(3),
                                  True)
    ms = device_ms(lambda: fused_relative_attention(q, k, v, e, pad))
    with earlier_body("relative_attention"):
        earlier_ms = device_ms(
            lambda: fused_relative_attention(q, k, v, e, pad))
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
    print(f"kernel A bf16 B{B} H{H} L{L_PREFILL} key_pad, causal: {ms:.4f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}), "
          f"SDPA (bias and masks as attn_mask) {library_ms:.4f} ms; earlier "
          f"(CUDA-core) body {earlier_ms:.4f} ms, on {gpu_line()}")
    return {"name": "relative_attention_fwd", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/relative_attention.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_attention.py:345",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "earlier_ms": earlier_ms}


def with_earlier(fn, name: str = "fused_decode", iters: int = 50,
                 flush=None) -> tuple:
    """Device ms of ``fn`` through the current body and through the
    earlier one (``EARLIER_SHIMS[name]``), in turns: current, earlier,
    earlier, current. Returns (current, earlier), each the mean of two."""
    times = []
    for earlier in (False, True, True, False):
        with (earlier_body(name) if earlier
              else contextlib.nullcontext()):
            times.append(device_ms(fn, iters=iters, flush=flush))
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2


def time_kernel_b(launches: int, err: float) -> dict:
    model = flagship(torch.bfloat16)
    t = T_TIMED
    x, e_all, w_all, kc, vc = decode_inputs(model,
                                            torch.Generator().manual_seed(4))
    ms, earlier_ms = with_earlier(
        lambda: fused_decode_step(x, t, e_all, w_all, kc, vc, H))
    plain_ms = device_ms(lambda: fused_decode_step_plain(x, t, e_all, w_all,
                                                         kc, vc, H), iters=10)
    bound_ms, by = decode_bound(np.zeros(B, np.int64), t)
    print(f"kernel B bf16 B{B} t={t}: {ms:.4f} ms, earlier (CUDA-core) body "
          f"{earlier_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({by})", f"on {gpu_line()}")
    return {"name": "fused_decode_step", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1171",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "earlier_ms": earlier_ms}


def profile_kernel_b_call(calls: int = 20) -> dict:
    """The call ``time_kernel_b`` times (bf16, B 8, t 755, a 1024-row
    cache) under torch.profiler, for the tensor-core body and the earlier
    one: every device kernel the call runs (the wrapper's copy and casts
    included) with its device us per call, and the host us per call.
    Returns {body: (device us per call, host us per call)}."""
    from torch.profiler import ProfilerActivity, profile

    model = flagship(torch.bfloat16)
    x, e_all, w_all, kc, vc = decode_inputs(model,
                                            torch.Generator().manual_seed(4))

    def call():
        return fused_decode_step(x, T_TIMED, e_all, w_all, kc, vc, H)

    out = {}
    for body in ("tensor-core", "earlier"):
        with (earlier_body("fused_decode") if body == "earlier"
              else contextlib.nullcontext()):
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
                host_us = (time.perf_counter() - t0) * 1e6 / calls
        rows = device_rows(prof)
        dev_us = sum(r[0] for r in rows) / calls
        print(f"kernel B call profile ({body} body, bf16 B{B} t={T_TIMED}, "
              f"cache 1024): {dev_us:.1f} device us per call, "
              f"{host_us:.1f} host us per call under the profiler",
              f"on {gpu_line()}")
        for us, count, key in sorted(rows, reverse=True):
            print(f"  {us / calls:8.2f} us/call {count / calls:5.1f}x/call "
                  f"{key[:90]}")
        out[body] = (dev_us, host_us)
    return out


def weight_bytes(d: int, int8: bool, layers: int = N_LAYERS) -> int:
    """Bytes of the layers' bf16 decode weights (FFN d / 2), or with the
    six matrices in int8 plus their f32 scale tables (one per output
    column)."""
    f = d // 2
    mats, vecs = 4 * d * d + 2 * d * f, 9 * d + f
    if int8:
        return layers * (mats + 2 * vecs + 4 * (5 * d + f))
    return layers * 2 * (mats + vecs)


def decode_bound(starts: np.ndarray, t: int, d: int = D_MODEL,
                 int8: bool = False, layers: int = N_LAYERS) -> tuple:
    """Least time of one bf16 decode step at position t whose rows attend
    [start_b, t]: weights (``weight_bytes``), the live K/V rows and the E
    rows they need read once, x read and written, the new K/V rows
    written; the qkv, output and FFN products plus three 64-deep products
    per live row and head."""
    f, heads = d // 2, d // DH
    live = int(np.sum(t + 1 - starts))          # (b, s) pairs attended
    e_rows = t + 1 - int(starts.min())
    nbytes = (weight_bytes(d, int8, layers) + 2 * layers * live * d * 2
              + layers * e_rows * DH * 4 + 2 * len(starts) * d * 2
              + 2 * layers * len(starts) * d * 2)
    flops = layers * (2 * len(starts) * (4 * d * d + 2 * d * f)
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
    ms, earlier_ms = with_earlier(lambda: step(smin))
    plain_ms = host_ms(lambda: fused_decode_step_plain(
        x, t, e_all, w_all, kc, vc, H, start=start, start_min=smin), iters=10)
    bound_ms, by = decode_bound(start.cpu().numpy(), t)
    full_ms, _ = decode_bound(np.zeros(B, np.int64), t)
    print(f"ragged kernel B bf16 B{B} t={t}, live window {LIVE} rows "
          f"(min(start) {smin}): start_min 0 {ms0:.4f} ms, start_min "
          f"{smin} {ms:.4f} ms (earlier body {earlier_ms:.4f} ms); bound "
          f"{bound_ms:.5f} ms ({by}) for this live window, {full_ms:.5f} ms "
          f"for the full prefix [0, t]", f"on {gpu_line()}")
    return {"name": "fused_decode_step_ragged", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1171",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": None, "ms_start_min_0": ms0,
            "bound_ms_full_prefix": full_ms, "earlier_ms": earlier_ms}


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
        ms, earlier_ms = with_earlier(
            lambda: fused_decode_chunk(x, t, e_all, w_all, kc, vc, H))
        plain_ms = device_ms(lambda: fused_decode_chunk_plain(
            x, t, e_all, w_all, kc, vc, H), iters=10)
        x1 = x[:, 0].contiguous()
        step_ms = device_ms(lambda: fused_decode_step(x1, t, e_all, w_all, kc,
                                                      vc, H), iters=50)
        bnd, by = chunk_bound(b, c, t)
        res[b] = (ms, plain_ms, step_ms, bnd, by, earlier_ms)
        print(f"kernel E bf16 B={b} C={c} t={t}: {ms:.4f} ms (earlier body "
              f"{earlier_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
              f"{bnd:.5f} ms ({by}); one kernel-B step at B={b} t={t}: "
              f"{step_ms:.4f} ms", f"on {gpu_line()}")
    ms, plain_ms, step_ms, bnd, by, earlier_ms = res[1]
    return {"name": "fused_decode_chunk", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1487",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "ms_b8": res[B][0], "plain_ms_b8": res[B][1],
            "bound_ms_b8": res[B][3], "kernel_b_step_ms_b1": step_ms,
            "kernel_b_step_ms_b8": res[B][2], "earlier_ms": earlier_ms,
            "earlier_ms_b8": res[B][5]}


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


def check_decode_widths() -> dict:
    """Kernels B (B 8) and E (B 2, C SPEC_CHUNK) in bf16, unquantized and
    int8, at each of ``DECODE_WIDTHS`` against their plain versions
    (TOL_B; the written cache rows too, every other row untouched), and
    one E call against C chained B steps bit for bit. Returns the worst
    error of each kernel against its plain version."""
    gen = torch.Generator(DEV).manual_seed(25)
    worst = {"B": 0.0, "E": 0.0}
    tol = TOL_B[torch.bfloat16]
    for d, ffn, layers, max_seq, t in DECODE_WIDTHS:
        for quant in ("none", "int8"):
            model = mt.MusicTransformer(
                vocab_size=VOCAB, num_layers=layers, d_model=d,
                ffn_dim=ffn, max_seq=max_seq, dtype=torch.bfloat16,
                device=DEV, generator=torch.Generator().manual_seed(d),
                decode_quant=quant)
            w_all, e_all = model.decode_weights()
            w, kw = ((w_all["int8"][0], {"scales": w_all["int8"][1]})
                     if quant == "int8" else (w_all, {}))
            heads, c = model.num_heads, SPEC_CHUNK
            cache_len = 1024 if t + c <= 1024 else max_seq
            for kernel, b in (("B", B), ("E", 2)):
                n = 1 if kernel == "B" else c
                x, _, _, kc, vc = chunk_inputs(model, (w_all, e_all), gen, b,
                                               n, cache_len)
                kc0, vc0 = kc.clone(), vc.clone()
                kc2, vc2 = kc.clone(), vc.clone()
                if kernel == "B":
                    x = x[:, 0].contiguous()
                    out, kc, vc = fused_decode_step(x, t, e_all, w, kc, vc,
                                                    heads, **kw)
                    ref, kc2, vc2 = fused_decode_step_plain(
                        x, t, e_all, w, kc2, vc2, heads, **kw)
                else:
                    out, kc, vc = fused_decode_chunk(x, t, e_all, w, kc, vc,
                                                     heads, **kw)
                    ref, kc2, vc2 = fused_decode_chunk_plain(
                        x, t, e_all, w, kc2, vc2, heads, **kw)
                    kb, vb, steps = kc0.clone(), vc0.clone(), []
                    for i in range(c):
                        o, kb, vb = fused_decode_step(
                            x[:, i].contiguous(), t + i, e_all, w, kb, vb,
                            heads, **kw)
                        steps.append(o)
                    chained = (torch.equal(out, torch.stack(steps, 1))
                               and torch.equal(kc, kb)
                               and torch.equal(vc, vb))
                torch.cuda.synchronize()
                err = max((out.float() - ref.float()).abs().max().item(),
                          *((a[:, :, t:t + n].float()
                             - a2[:, :, t:t + n].float()).abs().max().item()
                            for a, a2 in ((kc, kc2), (vc, vc2))))
                same = all(untouched(a, a0, t, n) for a, a0 in (
                    (kc, kc0), (vc, vc0), (kc2, kc0), (vc2, vc0)))
                ok = (err <= tol and same
                      and bool(torch.isfinite(out.float()).all())
                      and (kernel == "B" or chained))
                worst[kernel] = max(worst[kernel], err)
                extra = (f"; == {c} chained kernel-B steps bit for bit: "
                         f"{chained}" if kernel == "E" else "")
                print(f"kernel {kernel} bf16 {quant:4s} d={d} H={heads} "
                      f"FFN={ffn} L={layers} max_seq={max_seq} B={b} "
                      f"C={n} t={t}: max_abs_err {err:.3e} tol {tol:.1e}; "
                      f"other rows untouched: {same}{extra} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel {kernel} at d {d}, FFN "
                                         f"{ffn}, max_seq {max_seq} ({quant})"
                                         " disagrees")
    return worst


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
        def full_fn():
            return fused_decode_step(x, t, e_all, w_all, kc, vc, heads)

        def int8_fn():
            return fused_decode_step(x, t, e_all, qw, kc, vc, heads,
                                     scales=sc)

        full_ms, ms = pair(full_fn, int8_fn)
        _, earlier_full = with_earlier(full_fn)
        _, earlier_int8 = with_earlier(int8_fn)
        plain_ms = device_ms(lambda: fused_decode_step_plain(
            x, t, e_all, qw, kc, vc, heads, scales=sc), iters=10)
        zeros = np.zeros(B, np.int64)
        bnd, by = decode_bound(zeros, t, d, int8=True)
        full_bnd, _ = decode_bound(zeros, t, d)
        print(f"kernel B bf16 d={d} B={B} t={t}: int8 {ms:.4f} ms (bound "
              f"{bnd:.5f} ms, {by}; plain int8 {plain_ms:.4f} ms; earlier "
              f"body {earlier_int8:.4f} ms), unquantized {full_ms:.4f} ms "
              f"(bound {full_bnd:.5f} ms; earlier body {earlier_full:.4f} "
              f"ms); int8 / unquantized {ms / full_ms:.3f}",
              f"on {gpu_line()}")
        step_ms[d] = (ms, plain_ms, bnd, by, full_ms, full_bnd, earlier_int8,
                      earlier_full)
    ms, plain_ms, bnd, by, full_ms, full_bnd, earlier_int8, _ = \
        step_ms[D_MODEL]
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
        "d1024_unquantized_bound_ms": rung[5], "earlier_ms": earlier_int8,
        "d1024_earlier_ms": rung[6], "d1024_unquantized_earlier_ms": rung[7]})

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
    _, earlier_int8 = with_earlier(
        lambda: fused_decode_step(x, t, e_all, qw, kc, vc, H, scales=sc,
                                  **kw))
    plain_ms = host_ms(lambda: fused_decode_step_plain(
        x, t, e_all, qw, kc, vc, H, scales=sc, **kw), iters=10)
    bnd, by = decode_bound(start.cpu().numpy(), t, int8=True)
    print(f"ragged kernel B bf16 B={B} t={t}, live window {LIVE}: int8 "
          f"{ms:.4f} ms (bound {bnd:.5f} ms, {by}; plain int8 {plain_ms:.4f} "
          f"ms, host gaps included), unquantized {full_ms:.4f} ms",
          f"on {gpu_line()}")
    rows.append({
        "name": "fused_decode_step_ragged_int8", "route": "cuda",
        "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
        "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1278",
        "launches": launches["B_ragged"], "max_abs_err": err["B_ragged"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "unquantized_ms": full_ms,
        "earlier_ms": earlier_int8})

    dgen = torch.Generator(DEV).manual_seed(26)
    res = {}
    for b in (1, B):
        x, e_all, w_all, kc, vc = chunk_inputs(model, (w_all, e_all), dgen, b,
                                               SPEC_CHUNK, 1024)
        full_ms, ms = pair(
            lambda: fused_decode_chunk(x, T_TIMED, e_all, w_all, kc, vc, H),
            lambda: fused_decode_chunk(x, T_TIMED, e_all, qw, kc, vc, H,
                                       scales=sc))
        _, earlier_int8 = with_earlier(
            lambda: fused_decode_chunk(x, T_TIMED, e_all, qw, kc, vc, H,
                                       scales=sc))
        plain_ms = device_ms(lambda: fused_decode_chunk_plain(
            x, T_TIMED, e_all, qw, kc, vc, H, scales=sc), iters=10)
        bnd, by = chunk_bound(b, SPEC_CHUNK, T_TIMED, int8=True)
        res[b] = (ms, plain_ms, bnd, by, full_ms, earlier_int8)
        print(f"kernel E bf16 B={b} C={SPEC_CHUNK} t={T_TIMED}: int8 "
              f"{ms:.4f} ms (bound {bnd:.5f} ms, {by}; plain int8 "
              f"{plain_ms:.4f} ms; earlier body {earlier_int8:.4f} ms), "
              f"unquantized {full_ms:.4f} ms", f"on {gpu_line()}")
    ms, plain_ms, bnd, by, full_ms, earlier_int8 = res[1]
    rows.append({
        "name": "fused_decode_chunk_int8", "route": "cuda",
        "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
        "replaces": "musicgeneration_tpu/ops/pallas_decode.py:1568",
        "launches": launches["E"], "max_abs_err": err["E"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None, "unquantized_ms": full_ms, "ms_b8": res[B][0],
        "plain_ms_b8": res[B][1], "bound_ms_b8": res[B][2],
        "unquantized_ms_b8": res[B][4], "earlier_ms": earlier_int8,
        "earlier_ms_b8": res[B][5]})
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
                  "tokens, cache 1024, host clock)", f"on {gpu_line()}")
        print(f"decode d={d}: int8 / unquantized "
              f"{out[d]['int8'] / out[d]['none']:.3f}")
    return out


# ---------------------------------------------------------------- kernel F

def loop_inputs(model, stacked, lw, gen, b: int, cache_len: int = MAX_SEQ):
    """Kernel F's inputs at the model's width, drawn on the card: carried
    logits [b, V] f32, filled caches [L, b, cache_len, d] in the model
    dtype, the stacked and loop weights, the matrices the cluster body
    reads (``pack_loop_matrices``, where the widths take it), one seed."""
    shape = (model.num_layers, b, cache_len, model.d_model)
    embed, pos, fc_w, fc_b = lw
    v = model.vocab_size
    cluster = loop_takes_cluster(model.d_model,
                                 stacked[0]["ffn1_w"].shape[-1], v,
                                 cache_len, model.num_heads, model.dtype)
    return {"logits": torch.randn(b, v, generator=gen, device=DEV) * 2,
            "kc": torch.randn(shape, generator=gen, device=DEV).to(model.dtype),
            "vc": torch.randn(shape, generator=gen, device=DEV).to(model.dtype),
            "seed": torch.randint(0, 1 << 31, (1,), generator=gen,
                                  device=DEV),
            "embed": embed, "pos": pos, "fc_w": fc_w, "fc_b": fc_b,
            "w_all": stacked[0], "e_all": stacked[1],
            "heads": model.num_heads,
            "packed": pack_loop_matrices(stacked[0]) if cluster else None}


def loop_args(inp, t0: int, c: int) -> tuple:
    """The positional arguments of one kernel F call on ``inp``'s own
    logits and caches (pass ``packed=inp["packed"]`` beside them)."""
    return (inp["logits"], t0, inp["seed"], inp["embed"], inp["pos"],
            inp["e_all"], inp["w_all"], inp["fc_w"], inp["fc_b"], inp["kc"],
            inp["vc"], inp["heads"], c)


def loop_call(fn, inp, t0: int, c: int, sp: SamplingParams):
    """One call of kernel F (or its plain version) on copies of the
    carried logits and caches: (tokens, logits, k cache, v cache)."""
    logits, kc, vc = (inp["logits"].clone(), inp["kc"].clone(),
                      inp["vc"].clone())
    toks, logits = fn(logits, t0, inp["seed"], inp["embed"], inp["pos"],
                      inp["e_all"], inp["w_all"], inp["fc_w"], inp["fc_b"],
                      kc, vc, inp["heads"], c, sp.temperature, sp.greedy,
                      sp.top_k, sp.top_p, packed=inp["packed"])
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
                             torch.tensor([t0 + n_eq], device=DEV),
                             inp["logits"].shape[1])
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
    top-p 0.9) at B 8, C 32, t0 1 and 755 with fixed seeds. Then bf16 at
    the d 1024 rung (16 heads, FFN 512), past the cluster body's widths,
    so the one-block body runs it: greedy, B 1 and 8, C 7, t0 755."""
    gen = torch.Generator(DEV).manual_seed(17)
    greedy = SamplingParams(greedy=True)
    worst = 0.0
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        cases = [(greedy, "greedy", b, c, t0) for b in (1, B)
                 for c in LOOP_CHUNKS
                 for t0 in (1, 127, 128, T_TIMED, MAX_SEQ - 1 - c)]
        if dtype == torch.float32:
            cases += [(sp, name, B, LOOP_CHUNK, t0) for name, sp in LOOP_MODES
                      for t0 in (1, T_TIMED)]
        runs.append((flagship(dtype), True, cases))
    runs.append((flagship(torch.bfloat16, d_model=D_RUNG), False,
                 [(greedy, "greedy", b, 7, T_TIMED) for b in (1, B)]))
    for model, cluster, cases in runs:
        dtype = model.dtype
        stacked, lw = model.decode_weights(), model.loop_weights()
        for sp, name, b, c, t0 in cases:
            err = loop_case(model, stacked, lw, gen, sp, name, b, c, t0,
                            cluster and dtype == torch.bfloat16)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    return worst


def loop_case(model, stacked, lw, gen, sp: SamplingParams, name: str, b: int,
              c: int, t0: int, cluster: bool) -> float:
    """One check of kernel F against its plain version (``loop_call``,
    ``loop_agreement``) on fresh inputs at the model's width and
    vocabulary, the cluster body taken exactly when ``cluster``. Returns
    the max abs error."""
    dtype = model.dtype
    inp = loop_inputs(model, stacked, lw, gen, b)
    if (inp["packed"] is not None) != cluster:
        raise AssertionError(f"kernel F at d {model.d_model}, V "
                             f"{model.vocab_size} in {dtype} chose the "
                             "other body")
    kern = loop_call(fused_decode_loop, inp, t0, c, sp)
    plain = loop_call(fused_decode_loop_plain, inp, t0, c, sp)
    torch.cuda.synchronize()
    err, parted = loop_agreement(inp, kern, plain, t0, c, dtype, sp)
    ok = err <= TOL_B[dtype] and bool(torch.isfinite(kern[1]).all())
    print(f"kernel F {str(dtype):15s} d={model.d_model:4d} "
          f"V={model.vocab_size} {name:14s} B={b} C={c:2d} t0={t0:4d}: "
          f"tokens equal in {b - parted}/{b} rows, max_abs_err={err:.3e} "
          f"tol={TOL_B[dtype]:.1e}; rows outside [t0, t0+C) untouched "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel F disagrees with its plain version")
    return err


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


def check_loop_sampler(cases=None, label: str = "V 309 with ties, V 384 "
                       "padded, V 4096") -> None:
    """Kernel F's sampler alone (``mg_loop_sample``) against the plain
    sampler on the same logits, seeds, rows and positions (``cases`` of
    (logits, top_k, top_p), by default ``sampler_cases()``): the masked
    scaled logits (the kept sets and values) and the tokens equal bit for
    bit, at T 1 and T 0.9, and greedy (ties to the lowest index)."""
    gen = torch.Generator().manual_seed(19)
    n_cases = 0
    for logits, k, p in sampler_cases() if cases is None else cases:
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
    print(f"kernel F sampler: {n_cases} cases ({label}; top-k, top-p, T 1 "
          "and 0.9, greedy): kept sets, values and tokens equal the plain "
          "sampler's bit for bit ok")


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
              f"{max(r):.1f}] (prefill included, host clock)",
              f"on {gpu_line()}")
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


def loop_bound(b: int, c: int, t0: int, vocab: int = VOCAB) -> tuple:
    """Least time of one bf16 launch of c steps from t0: the weights, the
    embedding and the head read once, the K/V prefix [0, t0) of every row,
    the E rows [0, t0+c) of each layer, c positional rows, the logits in
    and out, the chunk's K/V rows and the tokens written; the products of
    c steps for b rows (layers and head) plus three 64-deep products per
    (head, live row) pair."""
    d, f = D_MODEL, D_MODEL // 2
    w_elems = N_LAYERS * (4 * d * d + 2 * d * f + 9 * d + f)
    nbytes = (w_elems * 2 + vocab * d * 2 + (vocab * d + vocab) * 2
              + 2 * N_LAYERS * b * t0 * d * 2 + N_LAYERS * (t0 + c) * DH * 4
              + c * d * 2 + 2 * b * vocab * 4 + 2 * N_LAYERS * b * c * d * 2
              + b * c * 8)
    pairs = b * sum(t0 + i + 1 for i in range(c))
    flops = (N_LAYERS * (2 * b * c * (4 * d * d + 2 * d * f)
                         + 3 * 2 * H * pairs * DH) + 2 * b * c * d * vocab)
    return bound(nbytes, flops, torch.bfloat16)


def time_kernel_f(launches: int, by_path: dict, err: float) -> dict:
    """Kernel F in bf16 at the main path's shape (C 32, t0 755, sampled
    T 1, the flagship width) at B 8 and B 1: device time beside its
    earlier one-block-a-row body in turns, its plain version, its bound.
    No single PyTorch call computes C decode steps (library null)."""
    model = flagship(torch.bfloat16)
    stacked, lw = model.decode_weights(), model.loop_weights()
    gen = torch.Generator(DEV).manual_seed(18)
    t0, c = T_TIMED, LOOP_CHUNK
    res = {}
    for b in (B, 1):
        inp = loop_inputs(model, stacked, lw, gen, b, 1024)
        args = loop_args(inp, t0, c)
        ms, earlier_ms = with_earlier(
            lambda: fused_decode_loop(*args, packed=inp["packed"]), iters=10)
        plain_ms = host_ms(lambda: fused_decode_loop_plain(*args), iters=2)
        bnd, by = loop_bound(b, c, t0)
        res[b] = (ms, plain_ms, bnd, by, earlier_ms)
        print(f"kernel F bf16 B={b} C={c} t0={t0}: {ms:.4f} ms per launch "
              f"({1e3 * ms / c:.1f} us per step); earlier (one block a row) "
              f"body, in turns, {earlier_ms:.4f} ms ({1e3 * earlier_ms / c:.1f}"
              f" us per step); plain {plain_ms:.4f} ms, bound {bnd:.5f} ms "
              f"({by})", f"on {gpu_line()}")
    ms, plain_ms, bnd, by, earlier_ms = res[B]
    return {"name": "fused_decode_loop", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/fused_decode.cu",
            "replaces": "musicgeneration_tpu/ops/pallas_decode_loop.py:377",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": None, "launches_by_path": by_path,
            "earlier_ms": earlier_ms, "ms_b1": res[1][0],
            "earlier_ms_b1": res[1][4], "plain_ms_b1": res[1][1],
            "bound_ms_b1": res[1][2]}


def profile_loop_phases() -> dict:
    """Kernel F's bf16 body at time_kernel_f's shape (B 8, C 32, t0 755,
    sampled T 1) through the phase-time build: the device us per step of
    each phase on CTA 0 of batch row 0 (a barrier's time is the wait for
    the slowest CTA), from clock64 cycles at the clock ``torch.cuda._sleep``
    measures."""
    model = flagship(torch.bfloat16)
    stacked, lw = model.decode_weights(), model.loop_weights()
    gen = torch.Generator(DEV).manual_seed(18)
    t0, c = T_TIMED, LOOP_CHUNK
    inp = loop_inputs(model, stacked, lw, gen, B, 1024)
    args, packed = loop_args(inp, t0, c), inp["packed"]
    lib = cuda_build.load("fused_decode")
    traced = ctypes.CDLL(str(EARLIER_LIBS["fused_decode_trace"]))
    trace = traced.mg_loop_trace
    trace.restype = ctypes.c_int
    trace.argtypes = [ctypes.c_void_p, ctypes.c_int]
    cuda_build._LIBS["fused_decode"] = traced
    try:
        fused_decode_loop(*args, packed=packed)  # warm
        torch.cuda.synchronize()
        calls = 5
        if trace(None, 1) != 0:
            raise RuntimeError("mg_loop_trace reset failed")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fused_decode_loop(*args, packed=packed)
        end.record()
        torch.cuda.synchronize()
        cycles = (ctypes.c_ulonglong * len(LOOP_PHASES))()
        if trace(cycles, 0) != 0:
            raise RuntimeError("mg_loop_trace read failed")
    finally:
        cuda_build._LIBS["fused_decode"] = lib
    per_ms = spin_cycles_per_ms()
    us = {name: 1e3 * cycles[i] / per_ms / (calls * c)
          for i, name in enumerate(LOOP_PHASES)}
    total = sum(v for k, v in us.items() if not k.startswith("of which"))
    wall = 1e3 * start.elapsed_time(end) / (calls * c)
    print(f"kernel F bf16 phases, B={B} C={c} t0={t0}, us per step on CTA 0 "
          f"of row 0 ({total:.1f} us traced, {wall:.1f} us per step by "
          "events, the trace build): " + ", ".join(
              f"{k} {v:.2f} ({100 * v / total:.0f}%)" for k, v in us.items()),
          f"on {gpu_line()}")
    return {"us_per_step": us, "traced_us": total, "event_us": wall}


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


def ring_mesh(sp: int = SP_RING):
    """A virtual mesh of ``sp`` shards on the card."""
    return make_mesh(sp=sp, devices=[DEV] * sp)


def merged_shards(x: torch.Tensor, sp: int) -> torch.Tensor:
    """[B, H, L, dh] -> kernel G's [sp, B, L / sp, H * dh]."""
    s = to_shards(x, ring_mesh(sp), 2)
    return s.transpose(2, 3).reshape(sp, s.shape[1], s.shape[3], -1
                                     ).contiguous()


def ring_pad(gen, l: int, left: bool = False) -> torch.Tensor:
    """[B, l] key padding in the JAX ring tests' pattern: 20 % of keys
    padded, keys 0-3 never (tests/test_ring_attention.py:85-86). With
    ``left`` keys 0 .. LEFT_PAD - 1 are padded instead, so under causal
    rows 0 .. LEFT_PAD - 1 reach no unmasked key (kernel A's "left"
    case)."""
    pad = (torch.rand(B, l, generator=gen) < 0.2).float()
    pad[:, :4] = 0.0
    if left:
        pad[:, :LEFT_PAD] = 1.0
    return pad.to(DEV)


def fresh_carry(sp: int, l_loc: int) -> list:
    return [torch.full((sp, B, H, l_loc), NEG_INF, device=DEV),
            torch.zeros(sp, B, H, l_loc, device=DEV),
            torch.zeros(sp, B, H, l_loc, DH, device=DEV)]


def bf16_ulps(a: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |a - ref| over one bf16 ulp of |ref| + TOL_G_SUM; max
    |a - ref| in bf16 ulps of |ref| over the outputs with |ref| >= 2^-8,
    where TOL_G_SUM is below a tenth of an ulp). Both must be <= 1."""
    r = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -126)))
                     - 7)
    d = (a.float() - r).abs()
    big = r.abs() >= 2.0 ** -8
    return ((d / (ulp + TOL_G_SUM)).max().item(),
            (d[big] / ulp[big]).max().item() if bool(big.any()) else 0.0)


def check_kernel_g() -> float:
    """Kernel G against ring_tile_plain, round by round: both start each
    round from the plain chain's carry, which is compared on every row
    (a row that has met no unmasked key yet included: the extended walk
    gives it the plain carry). Every case also runs with keys 0 ..
    LEFT_PAD - 1 padded ("left"), causal. Returns the worst bf16 output
    error (max abs)."""
    gen = torch.Generator().manual_seed(21)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = 0.0
    pads = [(causal, with_pad) for causal in (True, False)
            for with_pad in (False, True)] + [(True, "left")]
    for sp, l in RING_CASES:
        l_loc = l // sp
        for dtype in (f32, bf16):
            for causal, with_pad in pads:
                q, k, v = (torch.randn(B, H, l, DH, generator=gen)
                           .to(DEV, dtype) for _ in range(3))
                e = torch.randn(MAX_SEQ, DH, generator=gen).to(DEV)
                pad = (to_shards(ring_pad(gen, l, with_pad == "left"),
                                 ring_mesh(sp), 1).contiguous()
                       if with_pad else None)
                qm, km, vm = (merged_shards(x, sp) for x in (q, k, v))
                carry = fresh_carry(sp, l_loc)
                out_k, out_p = torch.empty_like(qm), torch.empty_like(qm)
                carry_err = 0.0
                for r in range(sp):
                    last = r == sp - 1
                    kc = [c.clone() for c in carry]
                    ring_tile(qm, km, vm, pad, e, *kc, rank0=0, r=r,
                              n=sp, causal=causal,
                              out=out_k if last else None)
                    ring_tile_plain(qm, km, vm, pad, e, *carry, rank0=0,
                                    r=r, n=sp, causal=causal,
                                    out=out_p if last else None)
                    torch.cuda.synchronize()
                    for a, ref in zip(kc, carry):
                        carry_err = max(carry_err, rel_err(a, ref))
                err = (out_k.float() - out_p.float()).abs().max().item()
                if dtype == f32:
                    ok, how = err <= TOL_G, f"tol {TOL_G:.0e}"
                else:
                    frac, ulps = bf16_ulps(out_k, out_p)
                    ok = frac <= 1.0 and ulps <= 1.0
                    how = (f"{frac:.2f} of 1 ulp + {TOL_G_SUM:.0e}; "
                           f"{ulps:.2f} ulp where |out| >= 2^-8")
                    worst = max(worst, err)
                ok = ok and carry_err <= TOL_G and bool(
                    torch.isfinite(out_k.float()).all())
                print(f"kernel G {str(dtype):15s} L={l:4d} sp={sp} "
                      f"Lloc={l_loc:3d} causal={causal!s:5s} "
                      f"key_pad={with_pad!s:5s} max_abs_err={err:.3e} "
                      f"({how}) carry_rel_err={carry_err:.2e} "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("kernel G disagrees with its "
                                         "plain tile")
    return worst


def check_ring_pass() -> None:
    """The whole virtual ring (sp 4, L 2048) through kernel G against the
    plain ring, f32 and bf16, and in f32 against kernel A on one device;
    with the JAX tests' padding and with keys 0 .. LEFT_PAD - 1 padded
    (rows 0 .. LEFT_PAD - 1 reach no unmasked key)."""
    gen = torch.Generator().manual_seed(22)
    mesh = ring_mesh()
    for dtype, left in ((torch.float32, False), (torch.bfloat16, False),
                        (torch.float32, True), (torch.bfloat16, True)):
        q, k, v = (torch.randn(B, H, L_RING, DH, generator=gen)
                   .to(DEV, dtype) for _ in range(3))
        e = torch.randn(MAX_SEQ, DH, generator=gen).to(DEV)
        pad = ring_pad(gen, L_RING, left)
        out = ring_relative_attention_pallas(q, k, v, e, mesh, key_pad=pad)
        ref = ring_relative_attention(q, k, v, e, mesh, key_pad=pad)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            ref_a = fused_relative_attention(q, k, v, e, pad)
            err_a = (out - ref_a).abs().max().item()
            ok = err <= TOL_G and err_a <= TOL_G
            how = (f"vs plain ring {err:.3e}, vs kernel A {err_a:.3e} "
                   f"(tol {TOL_G:.0e})")
        else:
            frac, ulps = bf16_ulps(out, ref)
            ok = frac <= 1.0 and ulps <= 1.0
            how = (f"vs plain ring {err:.3e} ({frac:.2f} of 1 ulp + "
                   f"{TOL_G_SUM:.0e}; {ulps:.2f} ulp where |out| >= 2^-8)")
        print(f"ring pass {str(dtype):15s} B{B} H{H} L{L_RING} sp "
              f"{SP_RING}, key_pad{' left' if left else ''}: {how} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the kernel-G ring disagrees")


def ring_model(impl: str, dtype, dropout: float = 0.0):
    """The flagship at full width with seeded random weights (seed 0, as
    ``flagship``), attention ``impl`` over a virtual mesh of SP_RING
    shards of the card, or "auto" (kernel A, one device)."""
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=N_LAYERS, d_model=D_MODEL,
        max_seq=MAX_SEQ, dtype=dtype, device=DEV, dropout_rate=dropout,
        generator=torch.Generator().manual_seed(0), attention_impl=impl,
        mesh=ring_mesh() if impl != "auto" else None)


def ring_batch(seed: int):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, VOCAB - 1, (B, L_RING))).to(DEV)
    return x, torch.roll(x, -1, 1)


def ring_counts() -> tuple:
    return (ring_tile.launches, fused_relative_attention.launches,
            fused_relative_attention_bwd.launches)


def zero_ring_counts() -> None:
    torch.cuda.synchronize()
    ring_tile.launches = 0
    fused_relative_attention.launches = 0
    fused_relative_attention_bwd.launches = 0


def ring_paths() -> dict:
    """The main path of kernel G: the full-width model with
    ``attention_impl="ring_pallas"`` over sp 4, f32: one forward (exact
    launch counts; logits against ``"auto"``), then one train step
    (dropout 0) against the single-device step through kernels A and C.
    Returns kernel G's launches by path."""
    f32 = torch.float32
    ring, auto = ring_model("ring_pallas", f32), ring_model("auto", f32)
    x, y = ring_batch(23)
    zero_ring_counts()
    with torch.no_grad():
        logits = ring(x)
    torch.cuda.synchronize()
    g, a, c = ring_counts()
    want = N_LAYERS * SP_RING
    with torch.no_grad():
        ref = auto(x)
    err = (logits - ref).abs().max().item()
    ok = (g, a, c) == (want, 0, 0) and err <= 2e-4
    print(f"ring model f32 B{B} L{L_RING} sp {SP_RING} (full width) "
          f"forward: logits vs auto max_abs_err {err:.3e} (tol 2e-4); "
          f"launches G {g} (want {want}), A {a}, C {c} (want 0) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the ring model's forward disagrees")
    launches = {"ring_forward": g}

    tcfg = TrainerConfig(vocab_size=VOCAB, pad_id=VOCAB - 1,
                         d_model=D_MODEL)
    results, counts = [], []
    for model in (ring, auto):
        tx = make_optimizer(tcfg)
        state = create_train_state(model.requires_grad_(True), tx,
                                   dropout_seed=0)
        zero_ring_counts()
        state, m = make_train_step(tx, tcfg)(state, x, y)
        torch.cuda.synchronize()
        counts.append(ring_counts())
        results.append((state, m))
    if counts != [(want, 0, 0), (0, N_LAYERS, N_LAYERS)]:
        raise AssertionError(f"ring / single-device train steps launched "
                             f"(G, A, C) {counts}")
    print(f"ring train step launches (G, A, C): ring {counts[0]}, "
          f"single device {counts[1]}")
    step_parity(f"ring train-step parity f32 (B{B} L{L_RING}, sp "
                f"{SP_RING} kernel G + plain-ring backward vs kernels A + C)",
                results[0], results[1], tx.lr(0))
    launches["ring_train_step"] = counts[0][0]
    return launches


def ring_bound(qm: torch.Tensor, sp: int, pad: bool) -> tuple:
    """The least time of one causal ring pass (sp launches). A (shard,
    round) whose block holds keys at or before its queries reads its q,
    its K/V (and pad) block and the E rows of the distances it needs, and
    reads and writes the carry; one whose block lies wholly after its
    queries needs nothing, except in the last round, which reads l and
    acc; the last round writes out. The operations are the causal (t, s)
    pairs, each a bf16-input q.k product and two f32-operand products (q.E,
    P.V) of depth dh. On the tensor cores each f32 operand is a hi + lo
    bf16 pair, so the work is five bf16 products at the bf16 peak; the
    f32-peak figure (q.k at the bf16 peak, q.E and P.V at the f32 peak) is
    the bound earlier records used. Returns (bytes ms, tensor-core ops ms,
    the larger, its name, the f32-peak bound ms)."""
    s_, b, l_loc, d = qm.shape
    el = qm.element_size()
    h = d // DH
    rows_of = b * l_loc           # one shard's rows of a [B, Lloc] tensor
    carry = rows_of * h * (2 + DH) * 4
    nbytes = ops_qk = ops_f32 = 0.0
    t = torch.arange(sp * l_loc)
    for r in range(sp):
        pairs, need = 0, torch.zeros(sp * l_loc, dtype=torch.bool)
        for i in range(sp):
            src = (i - r) % sp
            if src <= i:
                dist_ = (t[i * l_loc:(i + 1) * l_loc, None]
                         - t[None, src * l_loc:(src + 1) * l_loc])
                pairs += int((dist_ >= 0).sum())
                need[dist_[dist_ >= 0]] = True
                nbytes += (3 * rows_of * d * el + 2 * carry
                           + (rows_of * 4 if pad else 0))
            elif r == sp - 1:
                nbytes += rows_of * h * (1 + DH) * 4
        nbytes += int(need.sum()) * DH * 4  # E rows
        ops_qk += 2 * DH * pairs * b * h
        ops_f32 += 2 * 2 * DH * pairs * b * h
    nbytes += s_ * rows_of * d * el  # out
    t_bytes = nbytes / HBM_BPS * 1e3
    bf16 = PEAK_FLOPS[torch.bfloat16]
    t_ops = (ops_qk + 2 * ops_f32) / bf16 * 1e3
    t_f32_peak = (ops_qk / bf16 + ops_f32 / PEAK_FLOPS[torch.float32]) * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                            "operations")
    return t_bytes, t_ops, bnd, by, max(t_bytes, t_f32_peak)


def time_kernel_g(launches: int, by_path: dict, err: float) -> dict:
    """Kernel G at the main shape (B 8, H 4, L 2048 over sp 4, bf16,
    causal, no key padding: a training crop): each round's launch and a
    whole ring pass, its plain tile, its bound; SDPA over the whole
    [B, H, 2048, dh] with the relative bias and the causal mask as
    attn_mask (the same work as one pass), and kernel A at L 2048. The
    row's times are per ring pass of SP_RING launches."""
    dtype, sp = torch.bfloat16, SP_RING
    gen = torch.Generator().manual_seed(24)
    q, k, v = (torch.randn(B, H, L_RING, DH, generator=gen).to(DEV, dtype)
               for _ in range(3))
    e = torch.randn(MAX_SEQ, DH, generator=gen).to(DEV)
    qm, km, vm = (merged_shards(x, sp) for x in (q, k, v))
    carry = fresh_carry(sp, L_RING // sp)
    out = torch.empty_like(qm)

    def one_pass(tile):
        for r in range(sp):
            tile(qm, km, vm, None, e, *carry, rank0=0, r=r, n=sp,
                 out=out if r == sp - 1 else None)

    per_round = [device_ms(lambda r=r: ring_tile(
        qm, km, vm, None, e, *carry, rank0=0, r=r, n=sp,
        out=out if r == sp - 1 else None)) for r in range(sp)]
    ms = device_ms(lambda: one_pass(ring_tile), iters=50)
    with earlier_body("ring_attention"):
        earlier_ms = device_ms(lambda: one_pass(ring_tile), iters=20)
    plain_ms = device_ms(lambda: one_pass(ring_tile_plain), iters=5)
    t_bytes, t_ops, bnd, by, bnd_f32 = ring_bound(qm, sp, False)
    t = torch.arange(L_RING, device=DEV)
    causal = t[None, :] > t[:, None]
    idx = (MAX_SEQ - 1 - t[:, None] + t[None, :]).clamp(0, MAX_SEQ - 1)
    srel = torch.einsum("bhld,lsd->bhls", q.float(), e[idx])
    mask = (srel.masked_fill(causal, 0.0) / math.sqrt(DH)
            + causal.float() * -1e9).to(dtype)
    del srel
    f = torch.nn.functional.scaled_dot_product_attention
    library_ms = device_ms(lambda: f(q, k, v, attn_mask=mask), iters=20)
    del mask
    a_ms = device_ms(lambda: fused_relative_attention(q, k, v, e, None),
                     iters=20)
    print(f"kernel G bf16 B{B} H{H} L{L_RING} sp {sp} (Lloc "
          f"{L_RING // sp}), causal: per launch by round "
          + ", ".join(f"r{r} {x:.4f}" for r, x in enumerate(per_round))
          + f" ms; one ring pass {ms:.4f} ms ({ms / sp:.4f} per launch), "
          f"plain {plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}; bytes "
          f"{t_bytes:.4f}, operations {t_ops:.4f}: five bf16 products at "
          f"the bf16 peak; f32-peak bound {bnd_f32:.4f}), SDPA (bias and "
          f"mask as attn_mask) {library_ms:.4f} ms, kernel A at L {L_RING} "
          f"{a_ms:.4f} ms; earlier (CUDA-core) body {earlier_ms:.4f} ms a "
          f"pass, on {gpu_line()}")
    return {"name": "ring_attention_round", "route": "cuda",
            "source": "musicgeneration_tpu_torch/csrc/ring_attention.cu",
            "replaces":
                "musicgeneration_tpu/parallel/ring_attention_pallas.py:269",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
            "library_ms": library_ms, "launches_by_path": by_path,
            "per": f"ring pass of {sp} launches", "ms_per_round": per_round,
            "bound_bytes_ms": t_bytes, "bound_operations_ms": t_ops,
            "bound_f32_peak_ms": bnd_f32,
            "earlier_ms": earlier_ms,
            "kernel_a_ms_l2048": a_ms}


def time_ring_step() -> dict:
    """Host time and peak memory of a bf16 train step (dropout 0.1, B 8,
    L 2048, full width) on the virtual ring through kernel G
    ("ring_pallas": kernel G forward, plain-ring backward recomputed), on
    the plain ring ("ring": what ``cli.train sp=N`` runs) and on one
    device (kernels A and C), interleaved. One card: no claim about
    several."""
    tcfg = TrainerConfig(vocab_size=VOCAB, pad_id=VOCAB - 1,
                         d_model=D_MODEL)
    impls = ("ring_pallas", "ring", "auto")
    steps = {}
    for impl in impls:
        model = ring_model(impl, torch.bfloat16, dropout=0.1)
        tx = make_optimizer(tcfg)
        steps[impl] = (create_train_state(model, tx, dropout_seed=0),
                       make_train_step(tx, tcfg))
    x, y = ring_batch(25)
    times = {impl: [] for impl in impls}
    peak = {impl: 0.0 for impl in impls}
    # a warm-up step each, then RING_STEPS each, in turns whose order
    # reverses every round
    turns = sum((impls[::1 - 2 * (i % 2)] for i in range(RING_STEPS)), ())
    for i, impl in enumerate(impls + turns):
        state, step = steps[impl]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, _ = step(state, x, y)
        torch.cuda.synchronize()
        if i >= len(impls):
            times[impl].append((time.perf_counter() - t0) * 1e3)
        peak[impl] = max(peak[impl],
                         torch.cuda.max_memory_allocated() / 2 ** 30)
    res = {impl: float(np.median(ts)) for impl, ts in times.items()}
    print(f"train step bf16 B{B} L{L_RING} (full width, dropout 0.1), host "
          f"clock, median of {RING_STEPS}: "
          + ", ".join(f"{impl} {res[impl]:.2f} ms (peak {peak[impl]:.2f} "
                      f"GiB, steps {', '.join(f'{t:.2f}' for t in times[impl])})"
                      for impl in impls)
          + f"; ring_pallas / ring {res['ring_pallas'] / res['ring']:.4f}; "
          "one card, no claim", f"on {gpu_line()}")
    res["peak_gib"] = peak
    from torch.profiler import ProfilerActivity, profile

    state, step = steps["ring_pallas"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, x, y)
        torch.cuda.synchronize()
    groups = {}
    for dev_us, _, key in device_rows(prof):
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + dev_us
    busy = sum(groups.values())
    print(f"ring train step profile: device busy {busy / 1e3:.3f} ms; "
          + ", ".join(f"{g} {us / 1e3:.3f} ms" for g, us in
                      sorted(groups.items(), key=lambda kv: -kv[1])),
          f"on {gpu_line()}")
    return res


# the bf16 (tensor-core) entry functions of each library; "_int8": the
# instantiation for int8 weights
# ---------------------------------------------------------------------------
# the Compound Word (CP) transformer: kernels A, B (plain, ragged, int8) and
# C at its shapes, and its generation, serving and training paths
# ---------------------------------------------------------------------------

def cp_model(dtype, seed: int = 0,
             quant: str = "none") -> cp_mod.CPTransformer:
    """The CP transformer at the repo's defaults (cp_transformer_defaults:
    4 layers, d 256, 4 heads, FFN 128, max_seq 1024) with seeded random
    weights."""
    return cp_mod.CPTransformer(
        **cp_mod.cp_transformer_defaults(max_seq=CP_MAX_SEQ), dtype=dtype,
        device=DEV, generator=torch.Generator().manual_seed(seed),
        decode_quant=quant)


def cp_profile(label: str, fn, n: int) -> float:
    """``n`` calls of ``fn`` under torch.profiler: the wall and device
    busy time a call, the busy share and the heaviest kernels. Returns
    the busy share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    print(f"{label} profile: {n} calls, wall {wall_us / n:.1f} us a call "
          f"under the profiler, device busy {busy / n:.1f} us "
          f"({100 * busy / wall_us:.1f}% of wall)", f"on {gpu_line()}")
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev_us / n:9.1f} us/call {count / n:6.1f}x/call "
              f"{key[:80]}")
    return busy / wall_us


def check_cp_kernels() -> dict:
    """Kernels A, B and C at the CP transformer's shapes against their
    plain versions, with the stated tolerances: A causal without key_pad
    at B 8, L 256 and 512, max_seq 1024 (prefill and admission); B at 4
    layers, d 256, B 8, E tables of 1024 rows, t 700 and 1023 in a
    1024-row cache and t 0, 700 and 767 in an aligned 768-row cache
    (shorter than the table), plain, ragged (start_min = min(start)) and
    int8 (also within TOL_INT8_REL of the unquantized kernel), every
    cache row but t untouched; C at L 512, max_seq 512, causal, no
    key_pad (the training shape). f32 (TF32 off) and bf16. Returns the
    worst bf16 error of each."""
    gen = torch.Generator().manual_seed(41)
    worst = {"A": 0.0, "B": 0.0, "B_ragged": 0.0, "B_int8": 0.0, "C": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for l in (CP_PARITY_PROMPT, CP_PROMPT):
            q, k, v, e, _ = attn_inputs(dtype, gen, False, l, CP_MAX_SEQ)
            out, lse = fused_relative_attention(q, k, v, e, None, True,
                                                return_lse=True)
            ref, ref_lse = fused_relative_attention_plain(
                q, k, v, e, None, True, return_lse=True)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            ok = err <= TOL_A[dtype] and lse_err <= 1e-3
            print(f"CP kernel A {str(dtype):15s} B={B} L={l} max_seq="
                  f"{CP_MAX_SEQ} causal, no key_pad: max_abs_err {err:.3e} "
                  f"lse_err {lse_err:.3e} tol {TOL_A[dtype]:.1e} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("kernel A disagrees at CP's shape")
            if dtype == torch.bfloat16:
                worst["A"] = max(worst["A"], err)
        model = cp_model(dtype, quant="int8")
        for t, cache_len in CP_B_CASES:
            for mode in ("B", "B_ragged", "B_int8"):
                x, e_all, w_all, kc, vc = decode_inputs(model, gen,
                                                        cache_len=cache_len)
                kw, w = {}, w_all
                if mode == "B_ragged":
                    start = ragged_starts(gen, t).to(DEV)
                    kw = {"start": start, "start_min": int(start.min())}
                if mode == "B_int8":
                    w, kw["scales"] = w_all["int8"]
                kc2, vc2 = kc.clone(), vc.clone()
                full, _, _ = fused_decode_step(x, t, e_all, w_all, kc.clone(),
                                               vc.clone(), model.num_heads)
                out, kc, vc = fused_decode_step(x, t, e_all, w, kc, vc,
                                                model.num_heads, **kw)
                ref, kc2, vc2 = fused_decode_step_plain(
                    x, t, e_all, w, kc2, vc2, model.num_heads, **kw)
                torch.cuda.synchronize()
                err = max((out.float() - ref.float()).abs().max().item(),
                          (kc[:, :, t].float() - kc2[:, :, t].float())
                          .abs().max().item(),
                          (vc[:, :, t].float() - vc2[:, :, t].float())
                          .abs().max().item())
                rel = rel_err(out, full) if mode == "B_int8" else 0.0
                ok = (err <= TOL_B[dtype] and rel < TOL_INT8_REL
                      and untouched(kc, kc2, t) and untouched(vc, vc2, t)
                      and bool(torch.isfinite(out.float()).all()))
                print(f"CP kernel {mode:8s} {str(dtype):15s} L={CP_LAYERS} "
                      f"B={B} t={t:4d} cache={cache_len} E rows "
                      f"{CP_MAX_SEQ}: max_abs_err {err:.3e} tol "
                      f"{TOL_B[dtype]:.1e}"
                      + (f", vs unquantized {rel:.2e} rel (< "
                         f"{TOL_INT8_REL:.0e})" if mode == "B_int8" else "")
                      + f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel {mode} disagrees at CP's "
                                         "shape")
                if dtype == torch.bfloat16:
                    worst[mode] = max(worst[mode], err)
        q, k, v, _, _ = attn_inputs(dtype, gen, False, L_TRAIN)
        e = torch.randn(L_TRAIN, DH, generator=gen).to(DEV)
        dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
        out, lse = fused_relative_attention(q, k, v, e, None, True,
                                            return_lse=True)
        got = fused_relative_attention_bwd(q, k, v, e, None, True, out, lse,
                                           dout)
        ref = fused_relative_attention_bwd_plain(q, k, v, e, None, True, out,
                                                 lse, dout)
        torch.cuda.synchronize()
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        abs_err = max((a.float() - r.float()).abs().max().item()
                      for a, r in zip(got, ref))
        ok = max(errs) <= TOL_C[dtype] and all(
            bool(torch.isfinite(a).all()) for a in got)
        print(f"CP kernel C {str(dtype):15s} B={B} L={L_TRAIN} max_seq="
              f"{L_TRAIN} causal, no key_pad: rel_err dq={errs[0]:.2e} "
              f"dk={errs[1]:.2e} dv={errs[2]:.2e} de={errs[3]:.2e} tol "
              f"{TOL_C[dtype]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("kernel C disagrees at CP's shape")
        if dtype == torch.bfloat16:
            worst["C"] = max(worst["C"], abs_err)
    return worst


def cp_prime(tmp: str) -> tuple:
    """A prime MIDI of random MIDI-like events and its CP rows."""
    path = os.path.join(tmp, "cp_prime.mid")
    write_midi(np.random.default_rng(21).integers(0, VOCAB - 1, 3000), path)
    rows = cp.extract_events(path)
    if len(rows) < CP_PROMPT:
        raise AssertionError(f"the CP prime has {len(rows)} rows, fewer than "
                             f"{CP_PROMPT}")
    return path, np.asarray(rows, np.int64)


def cp_greedy_parity(rows: np.ndarray) -> None:
    """Greedy f32 generate_cp (B 8, 64 rows after a 256-row prompt) and
    the same on an int8 model: kernel path == plain path, row for row."""
    prompt = np.tile(rows[None, :CP_PARITY_PROMPT], (B, 1, 1))
    for quant in ("none", "int8"):
        model32 = cp_model(torch.float32, quant=quant)
        kern = generate_cp(model32, prompt, CP_GREEDY, greedy=True)
        with plain_path():
            plain = generate_cp(model32, prompt, CP_GREEDY, greedy=True)
        same = torch.equal(kern, plain)
        print(f"CP greedy f32{' int8' if quant == 'int8' else ''} "
              f"generate_cp, {CP_GREEDY} rows x {B}: kernel path == plain "
              f"path: {same}")
        if not same:
            first = (kern != plain).nonzero()[0].tolist()
            raise AssertionError(f"CP greedy rows differ first at {first}")


def cp_serve_parity(rows: np.ndarray) -> None:
    """Greedy f32 serving of 8 staggered requests (3 admitted later) at
    cli.serve's defaults: the kernel path's rows equal the plain path's,
    and each request's rows equal its dedicated generate_cp run."""
    model32 = cp_model(torch.float32)
    lens, news = CP_PARITY_LENS, CP_PARITY_NEWS
    prompts = [rows[:p] for p in lens]
    outs = []
    for plain in (False, True):
        cb = CPContinuousBatcher(model32, slots=SLOTS, seg_len=SEG,
                                 depth=DEPTH,
                                 sampling=SamplingParams(greedy=True))
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(x, n) for x, n in zip(prompts[:5], news[:5])]
            cb.step()
            rids += [cb.submit(x, n) for x, n in zip(prompts[5:], news[5:])]
            done = cb.run()
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    dedicated = all(np.array_equal(
        o, generate_cp(model32, x[None], n, greedy=True)[0].cpu().numpy())
        for o, x, n in zip(outs[0], prompts, news))
    print(f"CP serving greedy f32, {len(lens)} staggered requests: kernel "
          f"path == plain path: {same}; == dedicated generate_cp: "
          f"{dedicated}")
    if not (same and dedicated):
        raise AssertionError("served CP rows differ")


def cp_generate_cli(tmp: str, prime_mid: str, rows: np.ndarray) -> dict:
    """cli.generate on a saved full-width CP model (bf16, B 8, the prime's
    rows cut to max_seq - 512 = 512, 512 sampled rows) with exact
    launches (4 kernel-A, 12 kernel-B per row), every MIDI read back;
    then --quant int8 (128 rows: 12 int8 kernel-B launches per row, no
    unquantized one); then the same generation timed through
    generate_cp (prefill on the card, decode rows/s)."""
    model = cp_model(torch.bfloat16)
    pth = os.path.join(tmp, "cp.pth")
    torch.save(model.state_dict(), pth)
    counts = {}
    for quant, steps in (("none", CP_STEPS), ("int8", CP_INT8_STEPS)):
        out = os.path.join(tmp, f"cp-{quant}.mid")
        reset_counts()
        t0 = time.perf_counter()
        with quiet(os.path.join(tmp, "cp_generate.log")):
            rc = cli_main([pth, out, "--prime", prime_mid, "--prime-len",
                           "1000", "--steps", str(steps), "--batch", str(B),
                           "--dtype", "bfloat16", "--seed", "0", "--quant",
                           quant])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = (fused_relative_attention.launches,
               fused_decode_step.launches, fused_decode_step.int8_launches)
        want = ((CP_LAYERS, 3 * CP_LAYERS * steps, 0) if quant == "none"
                else (CP_LAYERS, 0, 3 * CP_LAYERS * steps))
        n_rows = [len(cp.extract_events(os.path.join(
            tmp, f"cp-{quant}-{i:03d}.mid"))) for i in range(B)]
        print(f"cli.generate CP bf16 {quant}: B={B} prime "
              f"{CP_MAX_SEQ - CP_STEPS} rows, {steps} rows in {secs:.3f} s "
              f"(load, encode, generate, write); launches kernel A="
              f"{got[0]} B={got[1]} B int8={got[2]} (expected {want}); "
              f"{B} MIDI files re-read as {min(n_rows)}-{max(n_rows)} rows")
        if rc != 0 or got != want:
            raise AssertionError(f"cli.generate CP {quant}: rc {rc}, "
                                 f"launches {got}, expected {want}")
        counts[quant] = got
    prompt = torch.from_numpy(np.tile(rows[None, :CP_MAX_SEQ - CP_STEPS],
                                      (B, 1, 1))).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate_cp(model, prompt, CP_STEPS, generator=gen)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    if out.shape != (B, CP_STEPS, 8) or not bool(
            (out < torch.tensor(cp.field_dims(), device=DEV)).all()):
        raise AssertionError(f"bad CP rows {tuple(out.shape)}")
    prefill_ms = device_ms(lambda: model.prefill(prompt, CP_MAX_SEQ),
                           iters=5)
    rows_s = B * CP_STEPS / (total_s - prefill_ms / 1e3)
    print(f"generate_cp bf16: {total_s:.3f} s; prefill (B {B}, "
          f"{CP_MAX_SEQ - CP_STEPS} rows) {prefill_ms:.3f} ms; decode "
          f"{rows_s:.1f} rows/s (B={B}, {CP_STEPS} rows, host clock)",
          f"on {gpu_line()}")
    # one row's step as generate_cp takes it (decode step, 8 draws, mask)
    logits, cache = model.prefill(prompt, CP_MAX_SEQ)
    stacked = model.decode_weights()
    t = CP_MAX_SEQ - CP_STEPS

    def row_step():
        row = sample_row(logits, 1.0, False, gen)
        model.decode_step(row, cache, t, stacked)
    busy = cp_profile(f"CP decode row (bf16, B {B}, t {t})", row_step, 32)
    return {"A": counts["none"][0] + counts["int8"][0],
            "B": counts["none"][1], "B_int8": counts["int8"][2],
            "prefill_ms": prefill_ms, "rows_s": rows_s, "pth": pth,
            "decode_busy": busy}


def cp_serve_cli(tmp: str, pth: str, prime_mid: str) -> dict:
    """cli.serve in file mode with its defaults (8 slots, segments of 64,
    depth 2), bf16, on 24 CP requests (prompts of 1-500 rows of the prime
    MIDI and one bare bar-marker row, 64-320 new rows, four cut at the
    end-of-piece family), every MIDI read back, with exact launches:
    4 kernel-A per admission call, 12 ragged kernel-B per decode step."""
    rng = np.random.default_rng(23)
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"c{i:02d}", "prime": prime_mid,
             "prime_len": SERVE_PROMPTS[i % len(SERVE_PROMPTS)],
             "max_new": int(rng.integers(*CP_SERVE_NEW))}
        if i < 4:
            r["eos"] = cp.FAMILY_EOS
        reqs.append(r)
    del reqs[-1]["prime"], reqs[-1]["prime_len"]   # a bare bar-marker row
    path = os.path.join(tmp, "cp_requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir = os.path.join(tmp, "cp_served")
    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main([pth, path, outdir, "--dtype", "bfloat16", "--seed",
                         "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (fused_relative_attention.launches,
                fused_decode_step.launches)
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    stat = {k: int(re.search(rf"(\d+) {k}", summary).group(1))
            for k in ("decode steps", "admission calls")}
    goodput = float(re.search(r"\(([\d.]+) tok/s goodput\)",
                              summary).group(1))
    written = dict(re.findall(r"wrote .*/(c\d\d)\.mid \((\d+) tokens\)",
                              out))
    n_rows = [len(cp.extract_events(os.path.join(outdir, f"{r['id']}.mid")))
              for r in reqs]
    exact = all(int(written[r["id"]]) == r["max_new"] for r in reqs
                if "eos" not in r)
    print(f"cli.serve CP bf16 file mode ({N_SERVE} requests, slots {SLOTS}, "
          f"seg {SEG}, depth {DEPTH}) in {secs:.3f} s (load, warm, serve, "
          f"write): {summary}; goodput {goodput:.1f} rows/s; MIDI files "
          f"re-read as {min(n_rows)}-{max(n_rows)} rows; launches kernel A="
          f"{launches[0]} (4 x {stat['admission calls']} admission calls), "
          f"kernel B={launches[1]} (12 x {stat['decode steps']} decode "
          f"steps)", f"on {gpu_line()}")
    ok = (rc == 0 and len(written) == N_SERVE and exact
          and launches[0] == CP_LAYERS * stat["admission calls"]
          and launches[1] == 3 * CP_LAYERS * stat["decode steps"])
    if not ok:
        raise AssertionError(f"cli.serve CP: rc {rc}, {len(written)} files, "
                             f"launches {launches}, {stat}")
    return {"A": launches[0], "B": launches[1], "goodput": goodput}


def cp_write_corpus(tmp: str) -> str:
    """Synthetic MIDI files (random MIDI-like events, the port's writer),
    tokenized by ``cli.tokenize --scheme cp``; each holds more than
    seq_len + 1 rows."""
    midis = os.path.join(tmp, "cp_midis")
    os.makedirs(midis)
    rng = np.random.default_rng(13)
    for i in range(N_MIDI):
        write_midi(rng.integers(0, VOCAB - 1, 3000),
                   os.path.join(midis, f"cp-{i:02d}.mid"))
    shards = os.path.join(tmp, "cp_tok")
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "tokenize.log")):
        rc = tokenize_main([midis, shards, "--scheme", "cp", "--workers",
                            "1"])
    corpus = TokenCorpus(shards, limlen=(L_TRAIN + 1) * 8)
    print(f"cli.tokenize --scheme cp: {N_MIDI} MIDI files -> {len(corpus)} "
          f"sequences > {L_TRAIN} rows (shortest "
          f"{corpus.lengths().min() // 8}) in {time.perf_counter() - t0:.1f} s")
    if rc != 0 or len(corpus) != N_MIDI:
        raise AssertionError("cli.tokenize --scheme cp lost files")
    return shards


def cp_train_cfg():
    return apply_overrides(train_cli.TrainCLIConfig(),
                           ["model=cp_transformer", f"batch_size={B}",
                            f"seq_len={L_TRAIN}"])


def cp_batches(n: int, shards: str) -> list:
    corpus = TokenCorpus(shards, limlen=(L_TRAIN + 1) * 8)
    at = train_cli._cp_batch_fn(corpus, cp_train_cfg())
    return [tuple(torch.from_numpy(a).to(DEV) for a in at(i))
            for i in range(n)]


def cp_train(tmp: str, shards: str) -> dict:
    """One f32 CP train step (dropout 0, B 8, seq_len 512) through kernels
    A and C against one through their plain versions (PERF.md section 2's
    limits); ``cli.train model=cp_transformer`` in bf16 at the defaults
    (dropout 0.1) for 30 steps with exact launches (4 A and 4 C a step)
    and every loss finite; ``cli.generate`` from its checkpoint directory
    (256 rows after a 100-row prime: 4 A, 12 B a row); then 25 warm bf16
    train steps timed with CUDA events."""
    cfg = cp_train_cfg()
    x, y = cp_batches(1, shards)[0]
    results = []
    for plain in (False, True):
        model, tcfg, loss_fn = train_cli.build_model(
            cfg, "cp", {"dtype": "float32", "dropout_rate": 0.0}, DEV)
        tx = make_optimizer(tcfg)
        state = create_train_state(model, tx, dropout_seed=cfg.seed)
        step = make_train_step(tx, tcfg, loss_fn=loss_fn)
        reset_counts()
        fused_relative_attention_bwd.launches = 0
        with plain_path() if plain else contextlib.nullcontext():
            state, m = step(state, x, y)
        torch.cuda.synchronize()
        launches = (fused_relative_attention.launches,
                    fused_relative_attention_bwd.launches)
        if launches != ((0, 0) if plain else (CP_LAYERS, CP_LAYERS)):
            raise AssertionError(f"CP parity step launched A, C {launches}")
        results.append((state, m))
    step_parity(f"CP train-step parity f32 (B{B} L{L_TRAIN}, full width)",
                results[0], results[1], tx.lr(0))

    run = os.path.join(tmp, "cp_run")
    reset_counts()
    fused_relative_attention_bwd.launches = 0
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "cp_train.log")):
        train_cli.main([shards, "model=cp_transformer",
                        f"steps={TRAIN_STEPS}", f"batch_size={B}",
                        f"seq_len={L_TRAIN}", "model.dtype=bfloat16",
                        f"ckpt_dir={run}", f"ckpt_every={CKPT_EVERY}",
                        "log_every=1", f"metrics_path={run}.jsonl"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = (fused_relative_attention.launches,
                fused_relative_attention_bwd.launches)
    ref = losses(run + ".jsonl")
    finite = (sorted(ref) == list(range(TRAIN_STEPS))
              and all(math.isfinite(v) for v in ref.values()))
    print(f"cli.train model=cp_transformer bf16 B{B} L{L_TRAIN} "
          f"{TRAIN_STEPS} steps in {secs:.1f} s (start-up included): loss "
          f"{ref[0]:.4f} -> {ref[TRAIN_STEPS - 1]:.4f}, all finite: "
          f"{finite}; launches kernel A={launches[0]} kernel C="
          f"{launches[1]} (expected {CP_LAYERS * TRAIN_STEPS} each)")
    if not finite or launches != (CP_LAYERS * TRAIN_STEPS,) * 2:
        raise AssertionError(f"cli.train CP: finite {finite}, launches "
                             f"{launches}")

    out = os.path.join(tmp, "cp_trained.mid")
    reset_counts()
    with quiet(os.path.join(tmp, "cp_generate.log")):
        cli_main([run, out, "--prime", os.path.join(tmp, "cp_midis",
                                                    "cp-00.mid"),
                  "--prime-len", "100", "--steps", str(GEN_STEPS),
                  "--batch", "2", "--seed", "1"])
    torch.cuda.synchronize()
    gen_launches = (fused_relative_attention.launches,
                    fused_decode_step.launches)
    n_rows = [len(cp.extract_events(os.path.join(
        tmp, f"cp_trained-{i:03d}.mid"))) for i in range(2)]
    print(f"cli.generate from the CP checkpoint directory (step "
          f"{list_checkpoints(run)[-1][0]}, the recorded bf16, prime 100 "
          f"rows, {GEN_STEPS} rows, batch 2): launches kernel A="
          f"{gen_launches[0]} B={gen_launches[1]}; MIDI files re-read as "
          f"{n_rows} rows")
    if gen_launches != (CP_LAYERS, 3 * CP_LAYERS * GEN_STEPS):
        raise AssertionError(f"cli.generate CP launches {gen_launches}")

    warm, timed = 5, 25
    batches = cp_batches(warm + timed, shards)
    model, tcfg, loss_fn = train_cli.build_model(cfg, "cp",
                                                 {"dtype": "bfloat16"}, DEV)
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=cfg.seed)
    step = make_train_step(tx, tcfg, loss_fn=loss_fn)
    for xb, yb in batches[:warm]:
        state, _ = step(state, xb, yb)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for xb, yb in batches[warm:]:
        state, _ = step(state, xb, yb)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / timed
    print(f"CP train step bf16 B{B} L{L_TRAIN} (full width, dropout 0.1): "
          f"{ms:.3f} ms/step, {B * L_TRAIN / (ms / 1e3):.0f} rows/s over "
          f"{timed} warm steps (CUDA events)", f"on {gpu_line()}")
    xb, yb = batches[-1]
    busy = cp_profile(f"CP train step (bf16, B {B}, L {L_TRAIN})",
                      lambda: step(state, xb, yb), PROFILE_STEPS)
    return {"A": launches[0], "C": launches[1], "A_generate": gen_launches[0],
            "B_generate": gen_launches[1], "step_ms": ms, "train_busy": busy}


def time_cp_kernels() -> dict:
    """Kernels A, B and C at the CP main path's shapes, bf16, beside their
    plain versions and bounds: A causal without key_pad at B 8, L 512,
    max_seq 1024 (the prefill); B at 4 layers, B 8, t 767 (the middle of
    the 512 generated rows) in a 1024-row cache; C at B 8, L 512, max_seq
    512, causal, no key_pad (the train step)."""
    dtype = torch.bfloat16
    gen = torch.Generator().manual_seed(43)
    bh, l = B * H, CP_PROMPT
    q, k, v, e, _ = attn_inputs(dtype, gen, False, l, CP_MAX_SEQ)
    a_ms = device_ms(lambda: fused_relative_attention(q, k, v, e, None))
    a_plain = device_ms(
        lambda: fused_relative_attention_plain(q, k, v, e, None), iters=5)
    a_bound = bound(3 * bh * l * DH * 2 + l * DH * 4 + bh * l * DH * 2
                    + bh * l * 4, 3 * 2 * DH * bh * l * (l + 1) / 2, dtype)
    # yardstick at the prefill's shape: SDPA with the relative bias and the
    # causal mask materialized as attn_mask (built outside the time)
    t_idx = torch.arange(l, device=DEV)
    rel = (CP_MAX_SEQ - 1 - t_idx[:, None] + t_idx[None, :]).clamp(
        0, CP_MAX_SEQ - 1)
    later = t_idx[None, :] > t_idx[:, None]
    srel = torch.einsum("bhld,lsd->bhls", q.float(),
                        e.to(dtype).float()[rel]).masked_fill(later, 0.0)
    mask = (srel / math.sqrt(DH) + later.float() * -1e9).to(dtype)
    a_lib = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    del srel, mask
    print(f"CP prefill shape: SDPA (bias and causal mask as attn_mask) "
          f"{a_lib:.4f} ms", f"on {gpu_line()}")

    model = cp_model(dtype)
    t = CP_MAX_SEQ - CP_STEPS + CP_STEPS // 2 - 1
    x, e_all, w_all, kc, vc = decode_inputs(model, gen)
    b_ms = device_ms(lambda: fused_decode_step(x, t, e_all, w_all, kc, vc,
                                               model.num_heads), iters=50)
    b_plain = device_ms(lambda: fused_decode_step_plain(
        x, t, e_all, w_all, kc, vc, model.num_heads), iters=10)
    b_bound = decode_bound(np.zeros(B, np.int64), t, layers=CP_LAYERS)

    q, k, v, _, _ = attn_inputs(dtype, gen, False, L_TRAIN)
    e = torch.randn(L_TRAIN, DH, generator=gen).to(DEV)
    dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
    out, lse = fused_relative_attention(q, k, v, e, None, True,
                                        return_lse=True)
    c_ms = device_ms(lambda: fused_relative_attention_bwd(
        q, k, v, e, None, True, out, lse, dout))
    c_plain = device_ms(lambda: fused_relative_attention_bwd_plain(
        q, k, v, e, None, True, out, lse, dout), iters=5)
    elems = bh * L_TRAIN * DH
    c_bound = bound(8 * elems * 2 + bh * L_TRAIN * 4 + 2 * L_TRAIN * DH * 4,
                    8 * 2 * DH * bh * L_TRAIN * (L_TRAIN + 1) / 2, dtype)
    res = {"A": (a_ms, a_plain, a_bound,
                 f"B{B} H{H} L{l} max_seq {CP_MAX_SEQ} causal, no key_pad"),
           "B": (b_ms, b_plain, b_bound,
                 f"{CP_LAYERS} layers, d {model.d_model}, B{B}, t {t}, "
                 f"cache 1024"),
           "C": (c_ms, c_plain, c_bound,
                 f"B{B} H{H} L{L_TRAIN} max_seq {L_TRAIN} causal, no "
                 "key_pad")}
    for name, (ms, plain, (bnd, by), shape) in res.items():
        print(f"CP kernel {name} bf16 {shape}: {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {bnd:.5f} ms ({by})",
              f"on {gpu_line()}")
    out = {name: {"cp_shape": shape, "cp_ms": ms, "cp_plain_ms": plain,
                  "cp_bound_ms": bnd, "cp_bound_by": by}
           for name, (ms, plain, (bnd, by), shape) in res.items()}
    out["A"]["cp_library_ms"] = a_lib
    return out


def cp_paths() -> dict:
    """The CP transformer's phases: greedy parity (generate_cp f32 and
    int8, serving f32, sliding-window serving f32), cli.generate,
    cli.serve, cli.tokenize -> cli.train -> cli.generate, and the rates.
    Returns the launches of each path and the rates."""
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        prime_mid, rows = cp_prime(tmp)
        cp_greedy_parity(rows)
        cp_serve_parity(rows)
        window = cp_window_serving(rows)
        gen = cp_generate_cli(tmp, prime_mid, rows)
        served = cp_serve_cli(tmp, gen["pth"], prime_mid)
        shards = cp_write_corpus(tmp)
        tr = cp_train(tmp, shards)
    print(f"CP phases: {time.perf_counter() - t0:.1f} s")
    return {"A": {"cp_generate": gen["A"] + tr["A_generate"],
                  "cp_serve": served["A"], "cp_train": tr["A"],
                  "cp_window_serve": window["A"]},
            "B": {"cp_generate": gen["B"] + tr["B_generate"],
                  "cp_serve": served["B"], "cp_window_serve": window["B"]},
            "window_rows_s": window["rows_s"],
            "B_int8": gen["B_int8"], "C": {"cp_train": tr["C"]},
            "prefill_ms": gen["prefill_ms"], "rows_s": gen["rows_s"],
            "goodput": served["goodput"], "step_ms": tr["step_ms"],
            "decode_busy": gen["decode_busy"],
            "train_busy": tr["train_busy"]}


# PoPMAG at its defaults (musicgeneration_tpu/models/popmag.py:46-52:
# event_dim 485, bar_dim 188, init_dim 32, embed 256, hidden 256, 2 GRU
# layers, dropout 0.5 in training) with cli.train's buckets (max_bars 16,
# max_bar_len 96) and 200 decoder steps a bar, each one kernel-D launch a
# layer. Depth is cut, never width (a train step takes ~1.8 s of host
# work): 8 synthetic 16-bar MIDI files, 3 f32 train steps (the same run
# cut after step 0 and resumed, so that step 2's loss follows an update
# made with the restored Adam state) and 1 bf16 one, 24 served requests
# of 2-16 bars, 8 staggered parity requests of 2-4 bars, rates over 4
# bars and 3 train steps (one warm), one profiled step
PM_HIDDEN, PM_LAYERS, PM_STEPS, PM_BARS, PM_BAR_LEN = 256, 2, 200, 16, 96
PM_D_BATCHES = (1, 8, 32)
PM_MIDI, PM_TRAIN, PM_CUT, PM_BF16, PM_CKPT = 8, 3, 1, 1, 1
PM_PARITY_NEWS = (2, 4, 3, 2, 3, 2, 4, 3)      # staggered serving, bars
PM_RATE_BARS, PM_RATE_STEPS = 4, 3
PM_LAUNCHES_PER_BAR = PM_LAYERS * PM_STEPS
# the synthetic pieces' roles: (name, program, drum, pitch range, step in
# ticks); note starts sit 30 ticks past the grid (a downbeat-aligned note
# would count in two bars, MuMIDI's grouping quirk)
PM_ROLES = (("melody", 72, False, 60, 84, 480),
            ("piano", 0, False, 48, 72, 960),
            ("bass", 32, False, 28, 52, 480),
            ("guitar", 24, False, 52, 76, 960),
            ("string", 65, False, 55, 79, 1920),
            ("drum", 0, True, 35, 50, 480))


def popmag_model(dtype, seed: int = 0) -> PoPMAGRNN:
    """PoPMAG at its defaults with seeded random weights."""
    return PoPMAGRNN(dtype=dtype, device=DEV,
                     generator=torch.Generator().manual_seed(seed))


def popmag_midi(path: str, seed: int, n_bars: int = PM_BARS) -> None:
    """A six-role piece of ``n_bars`` 4/4 bars written with the port's MIDI
    writer: each role a note every ``step`` ticks (85 % of them), so a
    melody bar encodes to ~30 MuMIDI tokens and an arrangement bar to
    ~85, inside max_bar_len."""
    rng = np.random.default_rng(seed)
    midi = MidiFile(ticks_per_beat=480)
    midi.tempo_changes = [TempoChange(tempo=float(rng.integers(80, 140)),
                                      time=0)]
    for name, program, drum, lo, hi, step in PM_ROLES:
        inst = Instrument(program=program, is_drum=drum, name=name)
        for t in range(0, n_bars * 1920, step):
            if rng.random() < 0.85:
                inst.notes.append(Note(
                    velocity=int(rng.integers(40, 110)),
                    pitch=int(rng.integers(lo, hi)), start=t + 30,
                    end=t + 30 + int(step * rng.uniform(0.4, 0.95))))
        midi.instruments.append(inst)
    midi.dump(path)


def popmag_melodies(tmp: str) -> tuple:
    """``PM_MIDI`` synthetic pieces and their packed melodies at the
    training buckets: (paths, [(src [bars, S, 7], src_len [bars])])."""
    midis = os.path.join(tmp, "popmag_midis")
    os.makedirs(midis)
    paths, mels = [], []
    for i in range(PM_MIDI):
        path = os.path.join(midis, f"piece-{i:02d}.mid")
        popmag_midi(path, 100 + i)
        paths.append(path)
        mels.append(melody_compound_from_midi(path, PM_BARS, PM_BAR_LEN))
    if any(src.shape[0] != PM_BARS for src, _ in mels):
        raise AssertionError("a synthetic piece lost bars to max_bar_len")
    return paths, mels


def pool_batch(mels: list) -> tuple:
    """The melodies as a serving slot holds them: [B, max_bars,
    max_bar_len, 7] rows and [B, max_bars] lengths, zeros past each."""
    src = np.zeros((len(mels), PM_BARS, PM_BAR_LEN, 7), np.int64)
    src_len = np.zeros((len(mels), PM_BARS), np.int64)
    for i, (m, ml) in enumerate(mels):
        src[i, :m.shape[0], :m.shape[1]] = m
        src_len[i, :len(ml)] = ml
    return src, src_len


def popmag_greedy_parity(mels: list) -> int:
    """Greedy f32 ``generate_arrangement`` at B 8 over 16 bars: the
    kernel path's emitted tokens (``flatten_arrangement``) and valid
    flags equal the plain path's, with exactly 400 kernel-D launches a
    bar. Returns the launches. (A pitch or duration drawn where nothing
    is emitted never reaches the state or the output.)"""
    model = popmag_model(torch.float32)
    src, src_len = pool_batch(mels)
    init = torch.randn(len(mels), model.init_dim,
                       generator=torch.Generator().manual_seed(5))
    (kern, n, secs) = count_d(lambda: generate_arrangement(
        model, init, src, src_len, PM_BARS, greedy=True))
    with plain_path():
        plain = generate_arrangement(model, init, src, src_len, PM_BARS,
                                     greedy=True)
    same = torch.equal(kern[1], plain[1]) and all(
        np.array_equal(a, b) for a, b in zip(flatten_arrangement(*kern),
                                             flatten_arrangement(*plain)))
    if not same:
        diff = (kern[0] != plain[0]) & kern[1]
        print(f"  first differing emitted (row, bar, step, field): "
              f"{diff.nonzero()[:1].tolist()}")
    emitted = int(kern[1][..., 0].sum())
    print(f"PoPMAG greedy f32 generate_arrangement B={len(mels)} "
          f"{PM_BARS} bars: kernel path == plain path: {same}; kernel D "
          f"launches {n} (expected {PM_LAUNCHES_PER_BAR} x {PM_BARS}); "
          f"{emitted} event tokens in {secs:.2f} s")
    if not same or n != PM_LAUNCHES_PER_BAR * PM_BARS:
        raise AssertionError(f"PoPMAG greedy parity: same {same}, "
                             f"launches {n}")
    return n


def popmag_serve_parity(mels: list) -> None:
    """Greedy f32 serving of 8 staggered requests (5, one segment, then
    3 more; latents on every other) through kernel D and through its
    plain version: equal streams, each equal to its row of one dedicated
    ``generate_arrangement`` at the pool width on the slots' buffers."""
    model = popmag_model(torch.float32)
    rng = np.random.default_rng(29)
    inits = [rng.standard_normal(model.init_dim).astype(np.float32)
             if i % 2 else None for i in range(len(mels))]
    outs = []
    for plain in (False, True):
        cb = PopMAGContinuousBatcher(
            model, slots=SLOTS, sampling=SamplingParams(greedy=True),
            max_bars=PM_BARS, max_bar_len=PM_BAR_LEN,
            prompt_bucket=math.gcd(8, PM_BARS))
        kws = [{"src_len": ml} if init is None else
               {"src_len": ml, "init": init}
               for (_, ml), init in zip(mels, inits)]
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(m, PM_PARITY_NEWS[i], **kws[i])
                    for i, (m, _) in enumerate(mels[:5])]
            cb.step()
            rids += [cb.submit(mels[i][0], PM_PARITY_NEWS[i], **kws[i])
                     for i in range(5, len(mels))]
            done = cb.run()
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    src, src_len = pool_batch(mels)
    init = torch.from_numpy(np.stack([
        np.zeros(model.init_dim, np.float32) if x is None else x
        for x in inits]))
    ref = flatten_arrangement(*generate_arrangement(
        model, init, src, src_len, max(PM_PARITY_NEWS), greedy=True))
    bar = MuMIDI_EventSeq.segmentation
    dedicated = all(np.array_equal(
        got, np.concatenate(bar(r)[:n]) if n else r[:0])
        for got, r, n in zip(outs[0], ref, PM_PARITY_NEWS))
    print(f"PoPMAG serving greedy f32, {len(mels)} staggered requests of "
          f"{min(PM_PARITY_NEWS)}-{max(PM_PARITY_NEWS)} bars: kernel path "
          f"== plain path: {same}; == dedicated generate_arrangement at "
          f"the pool width: {dedicated}")
    if not (same and dedicated):
        raise AssertionError("PoPMAG served streams differ")


def popmag_write_corpus(tmp: str, paths: list) -> str:
    """``cli.tokenize --scheme mumidi`` over the synthetic pieces."""
    shards = os.path.join(tmp, "popmag_tok")
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "tokenize.log")):
        rc = tokenize_main([os.path.dirname(paths[0]), shards, "--scheme",
                            "mumidi", "--workers", "1"])
    corpus = TokenCorpus(shards, key="melody")
    arr_bars = [len(b) for i in range(len(corpus)) for b in
                MuMIDI_EventSeq.segmentation(np.asarray(
                    corpus.pair(i, "arrangement"), np.int64))]
    print(f"cli.tokenize --scheme mumidi: {len(paths)} MIDI files -> "
          f"{len(corpus)} melody/arrangement pairs (arrangement bars of "
          f"{min(arr_bars)}-{max(arr_bars)} tokens) in "
          f"{time.perf_counter() - t0:.1f} s")
    if rc != 0 or len(corpus) != len(paths):
        raise AssertionError("cli.tokenize --scheme mumidi lost files")
    return shards


def popmag_train_args(shards: str, run: str, steps: int, *extra) -> list:
    """cli.train model=popmag at full width and the default buckets: B 8,
    max_bars 16, max_bar_len 96, dropout 0.5, Adam at 1e-3."""
    return [shards, "model=popmag", f"steps={steps}", f"batch_size={B}",
            f"max_bars={PM_BARS}", f"max_bar_len={PM_BAR_LEN}",
            f"ckpt_dir={run}", f"ckpt_every={PM_CKPT}", "log_every=1",
            f"metrics_path={run}.jsonl", *extra]


def popmag_train(tmp: str, shards: str) -> str:
    """cli.train model=popmag in f32 for 3 steps; the same run cut after
    step 0 and resumed (it must repeat the uninterrupted losses, the last
    one after an update from the restored Adam state); 1 bf16 step. Every
    loss finite; training runs the plain GRU forward, so kernel D is not
    launched. Returns the f32 run's directory."""
    run, cut, bf = (os.path.join(tmp, n) for n in
                    ("popmag_run", "popmag_cut", "popmag_bf16"))
    fused_gru_step.launches = 0
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "popmag_train.log")):
        train_cli.main(popmag_train_args(shards, run, PM_TRAIN))
        train_cli.main(popmag_train_args(shards, cut, PM_CUT))
        train_cli.main(popmag_train_args(shards, cut, PM_TRAIN))
        train_cli.main(popmag_train_args(shards, bf, PM_BF16,
                                         "model.dtype=bfloat16"))
    secs = time.perf_counter() - t0
    ref, resumed, low = (losses(p + ".jsonl") for p in (run, cut, bf))
    finite = (sorted(ref) == sorted(resumed) == list(range(PM_TRAIN))
              and sorted(low) == list(range(PM_BF16))
              and all(math.isfinite(v) for d in (ref, resumed, low)
                      for v in d.values()))
    same = finite and all(abs(resumed[k] - ref[k]) <= 1e-3 * abs(ref[k])
                          for k in ref)
    cut_losses = [round(resumed[k], 4) for k in sorted(resumed)]
    bf_losses = [round(low[k], 4) for k in sorted(low)]
    print(f"cli.train model=popmag f32 B{B} max_bars {PM_BARS} max_bar_len "
          f"{PM_BAR_LEN}: loss {ref[0]:.4f} -> {ref[PM_TRAIN - 1]:.4f}; cut "
          f"at {PM_CUT} and resumed: {cut_losses} (equal: {same}); bf16 "
          f"{PM_BF16} steps {bf_losses}; all finite: {finite}; "
          f"{secs:.1f} s for 4 runs; "
          f"kernel D launches {fused_gru_step.launches} (training runs "
          "the plain GRU forward)")
    if not (finite and same) or fused_gru_step.launches:
        raise AssertionError("cli.train model=popmag failed")
    return run


def popmag_generate_cli(tmp: str, run: str, prime: str) -> int:
    """cli.generate from the checkpoint directory: B 8 sampled
    arrangements of the 16-bar prime, exactly 400 kernel-D launches a
    bar, every MIDI read back. Returns the launches."""
    out = os.path.join(tmp, "arranged.mid")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, n, secs = count_d(lambda: cli_main(
            [run, out, "--prime", prime, "--batch", str(B), "--seed", "3"]))
    paths = re.findall(r"wrote (\S+) \((\d+) tokens, (\d+) bars\)",
                       buf.getvalue())
    notes = [sum(len(i.notes) for i in MidiFile(p).instruments)
             for p, _, _ in paths]
    ok = (rc == 0 and len(paths) == B and n == PM_LAUNCHES_PER_BAR * PM_BARS
          and all(int(k) == PM_BARS for _, _, k in paths) and sum(notes) > 0)
    print(f"cli.generate PoPMAG f32 (checkpoint directory, B={B}, "
          f"{PM_BARS}-bar prime, sampled): {secs:.3f} s; kernel D launches "
          f"{n} (expected {PM_LAUNCHES_PER_BAR} x {PM_BARS}); {len(paths)} "
          f"MIDI files read back with {min(notes)}-{max(notes)} notes "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.generate PoPMAG failed")
    return n


def popmag_serve_cli(tmp: str, run: str, paths: list) -> tuple:
    """cli.serve file mode with its defaults (8 slots, segments of 2
    bars, boost 4, depth 2) on 24 requests of 2-16 bars (every third with
    an ``init_seed``, every fourth given as packed ``melody`` rows):
    exactly 400 kernel-D launches per bar step of the pool, every MIDI
    read back. Returns (launches, summary line)."""
    rng = np.random.default_rng(31)
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"p{i:02d}", "max_new": int(rng.integers(2, PM_BARS + 1))}
        if i % 4 == 3:
            src, src_len = melody_compound_from_midi(paths[i % len(paths)],
                                                     PM_BARS, PM_BAR_LEN)
            r.update(melody=src.tolist(), src_len=src_len.tolist())
        else:
            r["prime"] = paths[i % len(paths)]
        if i % 3 == 0:
            r["init_seed"] = i
        reqs.append(r)
    path = os.path.join(tmp, "popmag-requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir = os.path.join(tmp, "popmag-served")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, n, secs = count_d(lambda: serve_main([run, path, outdir,
                                                  "--seed", "0"]))
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    bar_steps = int(re.search(r"(\d+) bar steps", summary).group(1))
    written = dict(re.findall(r"wrote .*/(p\d\d)\.mid \((\d+) tokens\)",
                              out))
    read = [MidiFile(os.path.join(outdir, f"{r['id']}.mid")) for r in reqs]
    expect = PM_LAUNCHES_PER_BAR * bar_steps
    print(f"cli.serve PoPMAG f32 file mode ({N_SERVE} requests of 2-"
          f"{PM_BARS} bars, slots {SLOTS}, 2 bars a segment, boost 4, depth "
          f"{DEPTH}) in {secs:.3f} s (load, warm, serve, write): {summary}",
          f"on {gpu_line()}")
    print(f"  {len(written)} MIDI files read back ({len(read)} parsed); "
          f"kernel D launches {n} ({PM_LAUNCHES_PER_BAR} x {bar_steps} bar "
          f"steps = {expect})")
    if rc != 0 or len(written) != N_SERVE or n != expect:
        raise AssertionError(f"cli.serve PoPMAG: rc {rc}, {len(written)} "
                             f"files, launches {n} vs {expect}")
    return n, summary


def train_step_rate(label: str, step, state, batches: list) -> tuple:
    """A train step's time and the device's busy share: one warm step,
    the mean over the next ``len(batches) - 2`` (CUDA events), then one
    more under torch.profiler (device activity only; its raw trace, not
    ``key_averages()``: ~10^5 kernels take seconds of host time to read
    directly and tens of seconds to aggregate). Returns (ms, busy)."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = step(state, *batches[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for x, y in batches[1:-1]:
        state, _ = step(state, x, y)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (len(batches) - 2)
    print(f"{label}: {ms:.3f} ms/step over {len(batches) - 2} warm steps "
          "(CUDA events)", f"on {gpu_line()}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, *batches[-1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            us, n = rows.get(ev.name(), (0.0, 0))
            rows[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    rows = [(us, n, name) for name, (us, n) in rows.items()]
    busy_us = sum(r[0] for r in rows)
    if DEV.type == "cuda" and not busy_us:
        raise AssertionError(f"{label}: the trace holds no device time")
    print(f"{label} profile: wall {wall_us:.1f} us under the profiler, "
          f"device busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}% of "
          "wall)", f"on {gpu_line()}")
    for dev_us, count, key in sorted(rows, reverse=True)[:6]:
        print(f"  {dev_us:9.1f} us {count:7d}x {key[:80]}")
    return ms, busy_us / wall_us


def popmag_rates(mels: list, shards: str) -> dict:
    """Arrangement decoder steps/s and bars/s at B 8 (f32 and bf16,
    sampled, ``PM_RATE_BARS`` bars, host clock after a warm bar); the f32
    train step at B 8 over ``PM_RATE_STEPS`` - 1 steps after a warm one
    (CUDA events) and the device's busy share of one more step under
    torch.profiler (device activity only: a step is ~10^5 launches)."""
    src, src_len = pool_batch(mels)
    init = torch.randn(len(mels), 32, generator=torch.Generator(
    ).manual_seed(6))
    rates = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = popmag_model(dtype)
        gen = torch.Generator(device=DEV).manual_seed(0)
        generate_arrangement(model, init, src, src_len, 1, greedy=False,
                             generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, _ = generate_arrangement(model, init, src, src_len,
                                       PM_RATE_BARS, greedy=False,
                                       generator=gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rates[name] = PM_RATE_BARS * len(mels) / secs
        print(f"PoPMAG generate_arrangement {name} B={len(mels)}, sampled: "
              f"{PM_RATE_BARS} bars of {len(mels)} rows in {secs:.3f} s: "
              f"{rates[name]:.2f} arranged bars/s, "
              f"{PM_RATE_BARS * PM_STEPS / secs:.1f} decoder steps/s of the "
              "batch (host clock)", f"on {gpu_line()}")
    cfg = apply_overrides(train_cli.TrainCLIConfig(), [
        "model=popmag", f"batch_size={B}", f"max_bars={PM_BARS}",
        f"max_bar_len={PM_BAR_LEN}"])
    corpus = TokenCorpus(shards, key="melody")
    at = train_cli._popmag_batch_fn(corpus, cfg)
    model, tcfg, loss_fn = train_cli.build_model(cfg, "mumidi", {}, DEV)
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=cfg.seed)
    step = make_train_step(tx, tcfg, loss_fn=loss_fn)
    batches = [to_device(at(i), DEV) for i in range(PM_RATE_STEPS + 1)]
    ms, busy = train_step_rate(
        f"PoPMAG train step f32 B{B} ({PM_BARS} bars of {PM_BAR_LEN}, "
        "dropout 0.5)", step, state, batches)
    return {"bars_s": rates, "step_ms": ms, "train_busy": busy}


def popmag_paths() -> dict:
    """PoPMAG's phases: greedy parity (generate_arrangement, serving),
    cli.tokenize --scheme mumidi -> cli.train model=popmag (f32 with
    resume, bf16) -> cli.generate -> cli.serve, and the rates. Returns
    the kernel-D launches of the CLI paths and the rates."""
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    secs = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t, 1)
        return out

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        paths, mels = timed("melodies", popmag_melodies, tmp)
        parity_n = timed("greedy parity", popmag_greedy_parity, mels)
        timed("serve parity", popmag_serve_parity, mels)
        shards = timed("tokenize", popmag_write_corpus, tmp, paths)
        run = timed("train", popmag_train, tmp, shards)
        gen_n = timed("generate", popmag_generate_cli, tmp, run, paths[0])
        serve_n, summary = timed("serve", popmag_serve_cli, tmp, run, paths)
        rates = timed("rates", popmag_rates, mels, shards)
    print(f"PoPMAG phases: {time.perf_counter() - t0:.1f} s ({secs})")
    return {"launches": {"popmag_generate": gen_n, "popmag_serve": serve_n},
            "parity_launches": parity_n, "serve": summary, **rates}


# The RNN families' training through the port's cli.train at the
# reference's widths (the CLI's defaults): EventMelodyRNN 308/32/512/3
# with GRU dropout 0.5, PerformanceRNN with 24 controls (dropout 0.3) on
# a midilike_control corpus, MelodyRNN 130/64/64/2 (dropout 0.5) with
# attn_length 0 and 40; f32 (the JAX RNN default), B 8, crops of 512.
# Depth is cut, never width: 8 synthetic files of 640-900 MIDI-like
# events (written with the port's MIDI writer), 3 steps a run (the same
# run cut after step 1 and resumed), windows of 200/10, sequences padded
# to the longest file; from the trained step files cli.generate (B 8,
# the 500-token prime, 512 steps) and cli.serve (24 requests) of both
# GRU families through kernel D, and MelodyRNN's cli.generate, 8
# staggered served requests, decode and serving rates
RT_MIDI, RT_STEPS, RT_CUT, RT_LENS = 8, 3, 2, (640, 900)
RT_WINDOW = ["train_mode=window", "window_size=200", "stride_size=10"]
RT_RUNS = {  # run -> (scheme, cli.train overrides)
    "event_segment": ("midilike", ["model=event_rnn", "train_mode=segment"]),
    "event_window": ("midilike", ["model=event_rnn", *RT_WINDOW,
                                  "teacher_forcing_ratio=0.5"]),
    "event_sequence": ("midilike", ["model=event_rnn",
                                    "train_mode=sequence"]),
    "performance_control": ("midilike_control", ["model=performance_rnn"]),
    "melody_basic": ("melody", ["model=melody_rnn"]),
    "melody_attn40": ("melody", ["model=melody_rnn", "model.attn_length=40"]),
}
# one f32 step, dropout 0, on the card and on the CPU: (label, scheme,
# cli.train overrides, model overrides)
RT_PARITY = (("event_rnn window", "midilike", ["model=event_rnn",
                                               *RT_WINDOW], {}),
             ("performance_rnn control", "midilike_control",
              ["model=performance_rnn"], {}),
             ("melody_rnn attn 40", "melody", ["model=melody_rnn"],
              {"attn_length": 40}))
MEL_RUNS = ("melody_basic", "melody_attn40")
MEL_PROMPT, MEL_STEPS, MEL_RATE_PROMPT = 500, 512, 16
MEL_PARITY_NEWS = (64, 128, 96, 64, 100, 80, 128, 72)
MEL_SERVE_NEW = (64, 513)


def rnn_train_corpora(tmp: str) -> dict:
    """``RT_MIDI`` synthetic MIDI files tokenized by ``cli.tokenize`` as
    ``midilike``, ``midilike_control`` and ``melody``. Returns {scheme:
    shard directory}."""
    midis = os.path.join(tmp, "rnn_midis")
    os.makedirs(midis)
    rng = np.random.default_rng(41)
    for i in range(RT_MIDI):
        write_midi(rng.integers(0, EVENT_DIM - 1, int(rng.integers(*RT_LENS))),
                   os.path.join(midis, f"r{i:02d}.mid"))
    shards = {}
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "tokenize.log")):
        for scheme in ("midilike", "midilike_control", "melody"):
            shards[scheme] = os.path.join(tmp, f"rnn_{scheme}")
            if tokenize_main([midis, shards[scheme], "--scheme", scheme,
                              "--workers", "1"]) != 0:
                raise AssertionError(f"cli.tokenize --scheme {scheme} failed")
    lens = {k: TokenCorpus(d).lengths() for k, d in shards.items()}
    print(f"cli.tokenize: {RT_MIDI} MIDI files -> " + ", ".join(
        f"{k} {len(v)} sequences of {v.min()}-{v.max()}"
        for k, v in lens.items()) + f" in {time.perf_counter() - t0:.1f} s")
    if any(len(v) != RT_MIDI for v in lens.values()):
        raise AssertionError("cli.tokenize lost files")
    return shards


def rnn_train_args(shards: str, run: str, steps: int, extra: list) -> list:
    """cli.train of an RNN family at its full width (the CLI's defaults),
    B 8, a checkpoint every step."""
    return [shards, f"steps={steps}", f"batch_size={B}", f"ckpt_dir={run}",
            "ckpt_every=1", "log_every=1", f"metrics_path={run}.jsonl",
            *extra]


def rnn_train_runs(tmp: str, shards: dict) -> dict:
    """Each run of ``RT_RUNS`` for 3 f32 steps on the card, and the same
    run cut after step 1 and resumed: its losses must equal the
    uninterrupted run's (1e-3), every one finite; training launches no
    kernel D. Returns {run: checkpoint directory}."""
    runs = {}
    fused_gru_step.launches = 0
    for name, (scheme, extra) in RT_RUNS.items():
        run, cut = (os.path.join(tmp, f"{name}{s}") for s in ("", "_cut"))
        t0 = time.perf_counter()
        with quiet(os.path.join(tmp, "rnn_train.log")):
            train_cli.main(rnn_train_args(shards[scheme], run, RT_STEPS,
                                          extra))
            train_cli.main(rnn_train_args(shards[scheme], cut, RT_CUT, extra))
            train_cli.main(rnn_train_args(shards[scheme], cut, RT_STEPS,
                                          extra))
        secs = time.perf_counter() - t0
        ref, resumed = losses(run + ".jsonl"), losses(cut + ".jsonl")
        finite = (sorted(ref) == sorted(resumed) == list(range(RT_STEPS))
                  and all(math.isfinite(v) for d in (ref, resumed)
                          for v in d.values()))
        same = finite and all(abs(resumed[k] - ref[k]) <= 1e-3 * abs(ref[k])
                              for k in ref)
        print(f"cli.train {name} f32 B{B} ({' '.join(extra)}): losses "
              f"{[round(ref[k], 4) for k in sorted(ref)]}; cut after step "
              f"{RT_CUT - 1} and resumed: "
              f"{[round(resumed[k], 4) for k in sorted(resumed)]} (equal: "
              f"{same}); {secs:.1f} s for 2 runs of {2 * RT_STEPS} steps",
              f"on {gpu_line()}")
        if not same:
            raise AssertionError(f"cli.train {name} failed")
        runs[name] = run
    if fused_gru_step.launches:
        raise AssertionError(f"training launched kernel D "
                             f"{fused_gru_step.launches} times")
    return runs


def rnn_step_parity(shards: dict) -> None:
    """One f32 train step (dropout 0, TF32 off) on the card and on the
    CPU, the plain version of a path that runs no kernel, from the same
    weights, batch and latent: loss 1e-5 and grad norm 1e-4 relative."""
    for label, scheme, over, mkw in RT_PARITY:
        cfg = apply_overrides(train_cli.TrainCLIConfig(),
                              [f"batch_size={B}", *over])
        corpus = TokenCorpus(shards[scheme], limlen=train_cli._limlen(cfg))
        batch = train_cli._batch_fn(corpus, cfg, scheme)(0)
        mets = []
        for dev in (DEV, torch.device("cpu")):
            model, tcfg, loss_fn = train_cli.build_model(
                cfg, scheme, {**mkw, "dropout_rate": 0.0}, dev)
            if hasattr(model, "init_dim"):
                init = torch.randn(B, model.init_dim,
                                   generator=torch.Generator().manual_seed(3))
                init = init.to(dev)

                def loss_fn(m, x, y, gen, init=init):
                    tokens, controls = ((x["tokens"], x["controls"])
                                        if isinstance(x, dict) else (x, None))
                    return train_cli.gru_objective(m, tokens, init, controls)
            tx = make_optimizer(tcfg)
            step = make_train_step(tx, tcfg, loss_fn=loss_fn)
            t0 = time.perf_counter()
            _, met = step(create_train_state(model, tx, dropout_seed=0),
                          *to_device(batch, dev))
            mets.append((met, time.perf_counter() - t0))
        (card, t_card), (host, t_host) = mets
        loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
        norm_rel = (abs(card["grad_norm"] - host["grad_norm"])
                    / abs(host["grad_norm"]))
        print(f"train step {label} f32 B{B}, card vs CPU: loss "
              f"{card['loss']:.6f} / {host['loss']:.6f} (rel {loss_rel:.2e}), "
              f"grad norm {card['grad_norm']:.6f} / {host['grad_norm']:.6f} "
              f"(rel {norm_rel:.2e}); {t_card:.2f} s / {t_host:.2f} s",
              f"on {gpu_line()}")
        if not (loss_rel <= 1e-5 and norm_rel <= 1e-4):
            raise AssertionError(f"{label}: the card's step differs from the "
                                 "CPU's")


def rnn_trained_cli(family: str, tmp: str, run: str, prime_mid: str,
                    ctrl_dir: str) -> int:
    """cli.generate from a trained GRU step directory: B 8, the prime
    MIDI's first 500 tokens, 512 sampled f32 tokens (PerformanceRNN under
    ``--control <midilike_control corpus dir>``), kernel D's launches
    exactly L x the decode steps, every MIDI read back. Returns the
    launches."""
    p = RNN_PROMPT + (family == "performance_rnn")
    ctrl = ["--control", ctrl_dir] if family == "performance_rnn" else []
    out = os.path.join(tmp, f"{family}-trained.mid")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, n, secs = count_d(lambda: cli_main(
            [run, out, "--prime", prime_mid, "--prime-len", str(RNN_PROMPT),
             "--steps", str(RNN_STEPS), "--batch", str(B), "--seed", "0"]
            + ctrl))
    paths = re.findall(r"wrote (\S+) \((\d+) tokens\)", buf.getvalue())
    events = [len(midilike.extract_events(path).events) for path, _ in paths]
    ok = (rc == 0 and n == RNN_LAYERS * (p + RNN_STEPS) and len(paths) == B
          and all(int(k) == RNN_STEPS for _, k in paths) and min(events) > 0)
    where = ", --control <corpus dir>" if ctrl else ""
    print(f"cli.generate {family} f32 from its cli.train step file (B={B}, "
          f"prime {p}, {RNN_STEPS} steps{where}): {secs:.3f} s; kernel D "
          f"launches {n} (expected {RNN_LAYERS} x {p + RNN_STEPS}); "
          f"{len(paths)} MIDI files read back as "
          f"{min(events)}-{max(events)} events {'ok' if ok else 'FAIL'}",
          f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"cli.generate {family} from a step file failed")
    return n


def rnn_train_paths(tmp: str, shards: dict, prime_mid: str) -> dict:
    """The RNN families' training on the card (``rnn_train_runs``), the
    card-vs-CPU step, and generation and serving from the trained
    EventMelodyRNN and PerformanceRNN step files through kernel D
    (exact launches; greedy f32 kernel path == plain path on the trained
    weights); the EventMelodyRNN window step's time and busy share.
    Returns the runs, kernel D's launches by path and the step rate."""
    from musicgeneration_tpu_torch.convert import load_checkpoint

    runs = rnn_train_runs(tmp, shards)
    rnn_step_parity(shards)
    prime = np.asarray(prime_tokens(prime_mid, RNN_PROMPT))
    launches, serve = {}, {}
    for family, name in (("event_rnn", "event_window"),
                         ("performance_rnn", "performance_control")):
        launches[f"generate_{family}_trained"] = rnn_trained_cli(
            family, tmp, runs[name], prime_mid, shards["midilike_control"])
        n, serve[family] = rnn_serve_file_mode(family, tmp, runs[name],
                                               prime_mid)
        launches[f"serve_{family}_trained"] = n
        rnn_greedy_parity(family, prime, load_checkpoint(runs[name],
                                                         device=DEV))
    scheme, extra = RT_RUNS["event_window"]
    cfg = apply_overrides(train_cli.TrainCLIConfig(),
                          [f"batch_size={B}", *extra])
    at = train_cli._batch_fn(TokenCorpus(shards[scheme],
                                         limlen=train_cli._limlen(cfg)),
                             cfg, scheme)
    model, tcfg, loss_fn = train_cli.build_model(cfg, scheme, {}, DEV)
    tx = make_optimizer(tcfg)
    ms, busy = train_step_rate(
        f"EventMelodyRNN train step f32 B{B} (window 200, scheduled "
        "sampling 0.5, dropout 0.5)", make_train_step(tx, tcfg,
                                                      loss_fn=loss_fn),
        create_train_state(model, tx, dropout_seed=0),
        [to_device(at(i), DEV) for i in range(4)])
    return {"runs": runs, "launches": launches, "serve": serve,
            "step_ms": ms, "train_busy": busy}


def melody_serve_parity(model) -> None:
    """Greedy f32 serving of 8 staggered requests (5, one segment, then
    3 more) equals one dedicated ``generate`` at the pool width: one-token
    prompts, so that every step of both runs is a step of 8 rows, and each
    row's attention window is its own (``attn_n``)."""
    prompts = np.arange(60, 60 + len(MEL_PARITY_NEWS), dtype=np.int64)
    cb = RNNContinuousBatcher(model, slots=SLOTS, seg_len=SEG, depth=DEPTH,
                              sampling=SamplingParams(greedy=True))
    rids = [cb.submit(prompts[i:i + 1], MEL_PARITY_NEWS[i]) for i in range(5)]
    cb.step()
    rids += [cb.submit(prompts[i:i + 1], MEL_PARITY_NEWS[i])
             for i in range(5, len(prompts))]
    done = cb.run()
    steps = max(MEL_PARITY_NEWS)
    ref = generate(model, torch.from_numpy(prompts)[:, None], None,
                   DecodeParams(max_len=1 + steps, steps=steps,
                                sampling=SamplingParams(greedy=True)))
    ref = ref.cpu().numpy()
    same = all(np.array_equal(done[r], ref[i, :n])
               for i, (r, n) in enumerate(zip(rids, MEL_PARITY_NEWS)))
    print(f"serving melody_rnn (attn_length {model.attn_length}) greedy f32, "
          f"{len(prompts)} staggered requests: == dedicated generate at the "
          f"pool width: {same}")
    if not same:
        raise AssertionError("MelodyRNN served streams differ from generate")


def melody_cli(tmp: str, run: str, prime_mid: str) -> None:
    """cli.generate from a MelodyRNN step file: B 8, the prime MIDI's first
    500 note-array slots, 512 sampled tokens, every MIDI read back."""
    out = os.path.join(tmp, f"{os.path.basename(run)}.mid")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([run, out, "--prime", prime_mid, "--prime-len",
                       str(MEL_PROMPT), "--steps", str(MEL_STEPS), "--batch",
                       str(B), "--seed", "0"])
    secs = time.perf_counter() - t0
    paths = re.findall(r"wrote (\S+) \((\d+) tokens\)", buf.getvalue())
    notes = [len(MidiFile(p).instruments[0].notes) for p, _ in paths]
    ok = (rc == 0 and len(paths) == B and min(notes) > 0
          and all(int(k) == MEL_STEPS for _, k in paths))
    print(f"cli.generate {os.path.basename(run)} f32 from its step file "
          f"(B={B}, prime {MEL_PROMPT} slots, {MEL_STEPS} sampled): "
          f"{secs:.3f} s; {len(paths)} MIDI files read back with "
          f"{min(notes)}-{max(notes)} notes {'ok' if ok else 'FAIL'}",
          f"on {gpu_line()}")
    if not ok:
        raise AssertionError("cli.generate melody_rnn failed")


def melody_decode_rate(model, prime: np.ndarray) -> float:
    """Decode tokens/s at B 8, f32, sampled, on the host clock: a 16-slot
    prompt plus 512 steps through ``decode.generate``, less the prompt."""
    prompt = torch.tensor([list(prime[:MEL_RATE_PROMPT])] * B, device=DEV)

    def run(steps):
        dp = DecodeParams(max_len=MEL_RATE_PROMPT + steps, steps=steps,
                          sampling=SamplingParams())
        gen = torch.Generator(device=DEV).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, prompt, gen, dp)
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    run(8)
    _, t_prompt = run(0)
    toks, t_all = run(MEL_STEPS)
    t = toks.cpu().numpy()
    if t.shape != (B, MEL_STEPS) or t.min() < 0 or t.max() >= model.vocab_size:
        raise AssertionError(f"bad tokens {t.shape} [{t.min()}, {t.max()}]")
    rate = B * MEL_STEPS / (t_all - t_prompt)
    print(f"generate melody_rnn (attn_length {model.attn_length}) f32: "
          f"{MEL_STEPS} steps {t_all - t_prompt:.3f} s: decode {rate:.1f} "
          f"tokens/s (B={B}, host clock)", f"on {gpu_line()}")
    return rate


def melody_serve_cli(tmp: str, run: str, prime_mid: str) -> str:
    """cli.serve file mode with its defaults (8 slots, segments of 64,
    depth 2, boost 8) on the MelodyRNN step file: 24 requests primed from
    the prime MIDI's note array (1-500 slots), 64-512 new tokens, four
    with an eos id, four with their own sampling; every MIDI read back.
    Returns the summary line."""
    rng = np.random.default_rng(43)
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"m{i:02d}", "prime": prime_mid,
             "prime_len": SERVE_PROMPTS[i % len(SERVE_PROMPTS)],
             "max_new": int(rng.integers(*MEL_SERVE_NEW))}
        if i < 4:
            r["eos"] = int(rng.integers(0, 128))
        elif i < 8:
            r.update(temperature=0.9, top_k=20)
        reqs.append(r)
    path = os.path.join(tmp, "melody-requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir = os.path.join(tmp, "melody-served")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main([run, path, outdir, "--seed", "0"])
    secs = time.perf_counter() - t0
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    written = dict(re.findall(r"wrote .*/(m\d\d)\.mid \((\d+) tokens\)", out))
    read = [MidiFile(os.path.join(outdir, f"{r['id']}.mid")) for r in reqs]
    exact = all(int(written[r["id"]]) == r["max_new"] for r in reqs
                if "eos" not in r)
    print(f"cli.serve {os.path.basename(run)} f32 file mode ({N_SERVE} "
          f"requests, slots {SLOTS}, seg {SEG}, depth {DEPTH}) in "
          f"{secs:.3f} s (load, warm, serve, write): {summary}",
          f"on {gpu_line()}")
    if rc != 0 or len(written) != N_SERVE or len(read) != N_SERVE or not exact:
        raise AssertionError(f"cli.serve melody_rnn: rc {rc}, {len(written)} "
                             "files")
    return summary


def melody_paths(tmp: str, shards: dict, runs: dict, prime_mid: str) -> dict:
    """MelodyRNN from its trained step files (``attn_length`` 0 and 40):
    cli.generate, 8 staggered served requests == dedicated generate
    (greedy f32), decode tokens/s at B 8, cli.serve's goodput (attn 40),
    the train step's time and busy share (attn 40)."""
    from musicgeneration_tpu_torch.convert import load_checkpoint

    prime = melody.midi_to_note_array(prime_mid).astype(np.int64)
    rates = {}
    for name in MEL_RUNS:
        melody_cli(tmp, runs[name], prime_mid)
        model = load_checkpoint(runs[name], device=DEV)
        melody_serve_parity(model)
        rates[name] = melody_decode_rate(model, prime)
    summary = melody_serve_cli(tmp, runs["melody_attn40"], prime_mid)
    scheme = RT_RUNS["melody_attn40"][0]
    cfg = apply_overrides(train_cli.TrainCLIConfig(),
                          [f"batch_size={B}", "model=melody_rnn"])
    at = train_cli._batch_fn(TokenCorpus(shards[scheme],
                                         limlen=train_cli._limlen(cfg)),
                             cfg, scheme)
    model, tcfg, loss_fn = train_cli.build_model(cfg, scheme,
                                                 {"attn_length": 40}, DEV)
    tx = make_optimizer(tcfg)
    ms, busy = train_step_rate(
        f"MelodyRNN train step f32 B{B} (attn_length 40, crops of "
        f"{cfg.seq_len}, dropout 0.5)",
        make_train_step(tx, tcfg, loss_fn=loss_fn),
        create_train_state(model, tx, dropout_seed=0),
        [to_device(at(i), DEV) for i in range(4)])
    return {"tok_s": rates, "serve": summary, "step_ms": ms,
            "train_busy": busy}


def rnn_slice_paths() -> dict:
    """The RNN training slice: synthetic corpora, ``rnn_train_paths`` and
    ``melody_paths`` in one scratch directory; prints each phase's
    seconds."""
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    secs = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t, 1)
        return out

    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        prime_mid = os.path.join(tmp, "prime.mid")
        write_midi(np.random.default_rng(0).integers(0, EVENT_DIM - 1, 3000),
                   prime_mid)
        shards = timed("corpora", rnn_train_corpora, tmp)
        rt = timed("rnn_train_paths", rnn_train_paths, tmp, shards, prime_mid)
        mel = timed("melody_paths", melody_paths, tmp, shards, rt["runs"],
                    prime_mid)
    print(f"RNN training phases: {time.perf_counter() - t0:.1f} s ({secs})",
          f"on {gpu_line()}")
    return {"train": rt, "melody": mel}


# The MusicTransformer on the other token schemes at the flagship's
# config (6 layers, d 256, 4 heads of 64, FFN 128, max_seq 2048; cli.train's
# B 8 and seq_len 512, bf16, dropout 0.1): REMI (vocabulary 337), the
# sustain-pedal codec (390) and melody note arrays (131), on 8 synthetic
# piano pieces of 1,500 notes under a sustain pedal (CC64). Depth is cut,
# never width: cli.train 3 steps a scheme (the same run cut after step 1
# and resumed), cli.eval 4 batches, cli.generate B 8 with 512 tokens after
# a 500-token prime, cli.serve 24 requests on the pedal run (prompts of
# 1-200 tokens, 64-240 new; one sliding request of window 256 running
# 2,560 tokens), greedy parity over 64 tokens, rates over 5 timed steps.
# The draft of distill_paths is the JAX CLI's recipe (2 layers, d 128),
# with the target's max_seq so that it can draft past 512 tokens,
# distilled from the pedal run for 3 steps
SCHEMES = ("remi", "pedal", "melody")
SCHEME_VOCAB = {"remi": 337, "pedal": 390, "melody": 131}
SCH_MIDI, SCH_NOTES, SCH_STEPS, SCH_EVAL = 8, 1500, 3, 4
SCH_SERVE_PROMPTS, SCH_SERVE_NEW = (1, 3, 64, 200), (64, 241)
SCH_RATE_STEPS = 5
LOOP_V_CASES = ((1, 7, 1), (1, 32, T_TIMED), (B, 7, T_TIMED), (B, 32, 1))
DISTILL_KW = ["model.num_layers=2", "model.d_model=128",
              f"model.max_seq={MAX_SEQ}"]
DISTILL_SPEC_STEPS = 256
# CP sliding-window serving: window 256 on the 1024-row cache, requests
# of 1,536 rows each, so that every slot re-primes several times
CP_WINDOW, CP_WINDOW_NEW = 256, 1536


def sustain_midi(path: str, seed: int, n_notes: int = SCH_NOTES) -> None:
    """A piano part of ``n_notes`` random notes under a sustain pedal
    (CC64 down/up windows), written with the port's MIDI writer."""
    rng = np.random.default_rng(seed)
    midi = MidiFile(ticks_per_beat=480)
    midi.tempo_changes = [TempoChange(tempo=120.0, time=0)]
    midi._tempo_raw = [(0, 500000)]
    piano = Instrument(0, False, "piano")
    t = 37
    for _ in range(n_notes):
        dur = int(rng.integers(60, 500))
        piano.notes.append(Note(int(rng.integers(30, 120)),
                                int(rng.integers(36, 96)), t, t + dur))
        t += int(rng.integers(30, 240))
    c = 200
    while c < t:
        piano.control_changes.append(ControlChange(64, 100, c))
        c += int(rng.integers(400, 1600))
        piano.control_changes.append(ControlChange(64, 0, c))
        c += int(rng.integers(200, 900))
    midi.instruments = [piano]
    midi.dump(path)


def scheme_corpora(tmp: str) -> tuple:
    """The pedalled pieces, tokenized by ``cli.tokenize --scheme`` into
    each scheme's corpus; every piece holds a seq_len + 1 crop in each.
    Returns (the first piece's path, {scheme: shard directory})."""
    midis = os.path.join(tmp, "sch_midis")
    os.makedirs(midis)
    for i in range(SCH_MIDI):
        sustain_midi(os.path.join(midis, f"s-{i:02d}.mid"), 40 + i)
    shards, t0 = {}, time.perf_counter()
    for scheme in SCHEMES:
        shards[scheme] = os.path.join(tmp, f"tok_{scheme}")
        with quiet(os.path.join(tmp, "tokenize.log")):
            rc = tokenize_main([midis, shards[scheme], "--scheme", scheme,
                                "--workers", "1"])
        corpus = TokenCorpus(shards[scheme], limlen=L_TRAIN + 1)
        if rc != 0 or len(corpus) != SCH_MIDI:
            raise AssertionError(f"cli.tokenize --scheme {scheme}: rc {rc}, "
                                 f"{len(corpus)} sequences > {L_TRAIN}")
    lens = {s: int(TokenCorpus(d).lengths().min()) for s, d in shards.items()}
    print(f"cli.tokenize: {SCH_MIDI} pedalled MIDI files of {SCH_NOTES} notes "
          f"-> remi, pedal, melody in {time.perf_counter() - t0:.1f} s "
          f"(shortest sequence {lens})")
    return os.path.join(midis, "s-00.mid"), shards


def counted_train(label: str, args, run: str, steps: int, per_step: tuple,
                  tmp: str) -> dict:
    """``cli.train args(run)`` for ``steps`` steps with kernels A and C
    counted (exactly ``per_step`` a step), then the same run (``args(run
    + "_cut")``) cut after step ``steps - 2`` and resumed to the
    uninterrupted losses (1e-3). Returns the launches of the three runs
    and the losses."""
    reset_counts()
    fused_relative_attention_bwd.launches = 0
    t0 = time.perf_counter()
    with quiet(os.path.join(tmp, "train.log")):
        train_cli.main(args(run))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = (fused_relative_attention.launches,
         fused_relative_attention_bwd.launches)
    ref = losses(run + ".jsonl")
    want = (per_step[0] * steps, per_step[1] * steps)
    finite = (sorted(ref) == list(range(steps))
              and all(math.isfinite(v) for v in ref.values()))
    with quiet(os.path.join(tmp, "train.log")):
        saved, first = cut_and_resume(args(run + "_cut"), run + "_cut",
                                      steps - 1)
    torch.cuda.synchronize()
    total = (fused_relative_attention.launches,
             fused_relative_attention_bwd.launches)
    resumed = losses(run + "_cut.jsonl")
    diff = max(abs(resumed[s] - ref[s]) for s in range(steps))
    ok = (finite and n == want and saved[-1] == steps - 2
          and first == steps - 1 and sorted(resumed) == list(range(steps))
          and diff <= 1e-3 and total == (2 * want[0], 2 * want[1]))
    print(f"{label}: {steps} steps in {secs:.1f} s (start-up included), loss "
          f"{ref[0]:.4f} -> {ref[steps - 1]:.4f}; launches A={n[0]} C={n[1]} "
          f"(expected {want[0]}, {want[1]}: {per_step[0]} and {per_step[1]} "
          f"a step); cut after step {steps - 2} (checkpoints {saved}), "
          f"resumed at batch {first}: losses max |diff| {diff:.2e} (tol "
          f"1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: launches {n}/{total}, losses "
                             f"{ref} / {resumed}")
    return {"A": total[0], "C": total[1], "losses": ref}


def scheme_train_args(shards: str, run: str, steps: int,
                      extra: tuple = ()) -> list:
    """cli.train at the flagship's config on ``shards`` (B 8, seq_len 512,
    max_seq 2048, bf16, dropout 0.1), a checkpoint every step."""
    return [shards, f"steps={steps}", f"batch_size={B}", f"seq_len={L_TRAIN}",
            "model.dtype=bfloat16", f"model.max_seq={MAX_SEQ}",
            f"ckpt_dir={run}", "ckpt_every=1", "log_every=1",
            f"metrics_path={run}.jsonl", *extra]


def scheme_eval(scheme: str, run: str, shards: str) -> dict:
    """cli.eval on the run (4 batches of B 8 with --bucket: two forwards,
    6 kernel-A launches each, a batch) and the eval step's tokens/s
    (CUDA events over 8 batches, the CLI's ``make_eval_step``)."""
    buf = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = eval_main([run, shards, "--batches", str(SCH_EVAL),
                        "--batch-size", str(B), "--bucket"])
    torch.cuda.synchronize()
    a = fused_relative_attention.launches
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    ok = (rc == 0 and a == 2 * N_LAYERS * SCH_EVAL
          and math.isfinite(out["loss"]) and 0 <= out["accuracy"] <= 1
          and out["tokens"] == SCH_EVAL * B * L_TRAIN
          and out["bucket"]["vocab"] == SCHEME_VOCAB[scheme])
    model = load_checkpoint(run, device=DEV, dtype=None)
    cfg = train_cli.TrainCLIConfig(batch_size=B, seq_len=L_TRAIN)
    at = train_cli._lm_batch_fn(TokenCorpus(shards, limlen=L_TRAIN + 1), cfg)
    batches = [to_device(at(i), DEV) for i in range(9)]
    step = make_eval_step(TrainerConfig(vocab_size=model.vocab_size,
                                        pad_id=model.vocab_size - 1,
                                        label_smoothing=0.1))
    step(model, *batches[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for x, y in batches[1:]:
        step(model, x, y)
    end.record()
    torch.cuda.synchronize()
    tok_s = 8 * B * L_TRAIN / (start.elapsed_time(end) / 1e3)
    print(f"cli.eval {scheme} bf16: {json.dumps(out)}; launches A={a} "
          f"(expected {2 * N_LAYERS * SCH_EVAL}); eval step {tok_s:.0f} "
          f"tokens/s (B {B}, {L_TRAIN} tokens a row, CUDA events) "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"cli.eval {scheme} failed")
    return {"A": a, "tok_s": tok_s}


def scheme_generate(scheme: str, run: str, prime_mid: str, tmp: str) -> dict:
    """cli.generate from the run (bf16 as recorded, B 8, the prime's first
    500 tokens through the scheme's codec, 512 sampled tokens, MIDI
    written back through it) with exactly 6 kernel-A and 18 x 512
    kernel-B launches; every file reads back as MIDI (random weights may
    sample too few well-formed REMI groups for a note: the notes are
    counted, not required). Then the decode rate of
    the same generation on the library path (prefill subtracted)."""
    prime = prime_tokens(prime_mid, PROMPT, scheme)
    if len(prime) != PROMPT:
        raise AssertionError(f"{scheme} prime has {len(prime)} tokens")
    out = os.path.join(tmp, f"gen_{scheme}.mid")
    reset_counts()
    with quiet(os.path.join(tmp, "generate.log")):
        rc = cli_main([run, out, "--prime", prime_mid, "--prime-len",
                       str(PROMPT), "--steps", str(STEPS), "--batch", str(B),
                       "--seed", "0"])
    torch.cuda.synchronize()
    n = (fused_relative_attention.launches, fused_decode_step.launches)
    back = [sum(len(i.notes) for i in MidiFile(os.path.join(
        tmp, f"gen_{scheme}-{i:03d}.mid")).instruments) for i in range(B)]
    ok = rc == 0 and n == (N_LAYERS, 3 * N_LAYERS * STEPS)
    model = load_checkpoint(run, device=DEV, dtype=None)
    prompt_np, prompt_len = bucket_prompt(np.tile(np.asarray(prime), (B, 1)),
                                          STEPS, model.max_seq, model.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    dp = DecodeParams(max_len=prompt.shape[1] + STEPS, steps=STEPS,
                      sampling=SamplingParams())
    generate(model, prompt[:, :prompt_len], None, dataclasses.replace(
        dp, steps=8, max_len=prompt_len + 8))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, prompt, torch.Generator(DEV).manual_seed(0), dp,
                    prompt_len)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    prefill_ms = device_ms(lambda: model.prefill(
        prompt, prompt.shape[1] + STEPS, prompt_len - 1), iters=5)
    tok_s = B * STEPS / (total - prefill_ms / 1e3)
    t = toks.cpu().numpy()
    ok = ok and 0 <= t.min() and t.max() < SCHEME_VOCAB[scheme]
    print(f"cli.generate {scheme} bf16 (vocab {model.vocab_size}, max_seq "
          f"{model.max_seq}): B={B} prime {PROMPT} -> bucket "
          f"{prompt.shape[1]}, {STEPS} tokens; launches A={n[0]} B={n[1]} "
          f"(expected {N_LAYERS}, {3 * N_LAYERS * STEPS}); files read back "
          f"with {min(back)}-{max(back)} notes; decode {tok_s:.1f} tokens/s "
          f"(prefill {prefill_ms:.3f} ms subtracted, host clock) "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"cli.generate {scheme} failed")
    return {"A": n[0], "B": n[1], "tok_s": tok_s, "prime": prime}


def scheme_parity(scheme: str, run: str, prime: list) -> int:
    """Greedy f32 on the trained weights, B 8, 64 tokens: the kernel path
    (A, B) equals the plain path, and ``generate(use_loop_kernel=True)``
    (A, F) equals the step path, token for token. Returns F's launches."""
    model = load_checkpoint(run, device=DEV, dtype=torch.float32)
    prompt_np, plen = bucket_prompt(np.tile(np.asarray(prime), (B, 1)),
                                    GREEDY_STEPS, model.max_seq, model.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    dp = DecodeParams(max_len=prompt.shape[1] + GREEDY_STEPS,
                      steps=GREEDY_STEPS, sampling=SamplingParams(greedy=True))
    kern = generate(model, prompt, None, dp, plen)
    with plain_path():
        plain = generate(model, prompt, None, dp, plen)
    reset_counts()
    loop = generate(model, prompt, None, dataclasses.replace(
        dp, use_loop_kernel=True), plen)
    torch.cuda.synchronize()
    f = fused_decode_loop.launches
    same, same_loop = torch.equal(kern, plain), torch.equal(kern, loop)
    print(f"greedy f32 {scheme} (vocab {model.vocab_size}) {GREEDY_STEPS} "
          f"tokens x {B}: kernel path == plain path: {same}; loop path "
          f"({f} F launches) == step path: {same_loop}")
    if not (same and same_loop):
        raise AssertionError(f"{scheme}: greedy paths differ")
    return f


def check_kernel_f_vocab(vocab: int) -> float:
    """Kernel F against its plain version at the flagship width and
    another scheme's vocabulary (its bf16 body chosen from the widths
    and V, as on the main path): greedy f32 and bf16 at (B, C, t0) of
    LOOP_V_CASES, sampled f32 T 1 at B 8, C 32, t0 755; then its sampler
    alone against the plain sampler bit for bit at V ``vocab`` (ties,
    top-k, top-p). Returns the bf16 max abs error."""
    gen = torch.Generator(DEV).manual_seed(vocab)
    greedy, worst = SamplingParams(greedy=True), 0.0
    for dtype in (torch.float32, torch.bfloat16):
        model = flagship(dtype, vocab=vocab)
        stacked, lw = model.decode_weights(), model.loop_weights()
        cluster = dtype == torch.bfloat16 and loop_takes_cluster(
            model.d_model, stacked[0]["ffn1_w"].shape[-1], vocab, MAX_SEQ,
            model.num_heads, dtype)
        cases = [(greedy, "greedy") + c for c in LOOP_V_CASES]
        if dtype == torch.float32:
            cases.append((LOOP_MODES[0][1], "T 1", B, LOOP_CHUNK, T_TIMED))
        for sp, name, b, c, t0 in cases:
            err = loop_case(model, stacked, lw, gen, sp, name, b, c, t0,
                            cluster)
            if dtype == torch.bfloat16:
                worst = max(worst, err)
    rng = np.random.RandomState(vocab)
    cases = []
    for trial in range(12):
        x = rng.randn(4, vocab).astype(np.float32) * 3
        if trial % 3 == 0:
            x[:, 50:60] = x[:, 49:50]
        cases.append((x, [0, 1, 5, 40, vocab][trial % 5],
                      [1.0, 0.9, 0.5][trial % 3]))
    check_loop_sampler(cases, f"V {vocab} with ties")
    return worst


def time_kernel_f_vocab(vocab: int) -> dict:
    """Kernel F in bf16 at B 8, C 32, t0 755, sampled T 1, the flagship
    width at V ``vocab``: device time, its plain version's, its bound."""
    model = flagship(torch.bfloat16, vocab=vocab)
    gen = torch.Generator(DEV).manual_seed(18)
    inp = loop_inputs(model, model.decode_weights(), model.loop_weights(),
                      gen, B, 1024)
    args = loop_args(inp, T_TIMED, LOOP_CHUNK)
    ms = device_ms(lambda: fused_decode_loop(*args, packed=inp["packed"]),
                   iters=10)
    plain_ms = host_ms(lambda: fused_decode_loop_plain(*args), iters=2)
    bnd, by = loop_bound(B, LOOP_CHUNK, T_TIMED, vocab)
    print(f"kernel F bf16 V={vocab} B={B} C={LOOP_CHUNK} t0={T_TIMED}: "
          f"{ms:.4f} ms per launch ({1e3 * ms / LOOP_CHUNK:.1f} us per step); "
          f"plain {plain_ms:.4f} ms, bound {bnd:.5f} ms ({by})",
          f"on {gpu_line()}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by}


def scheme_serve(run: str, prime_mid: str, tmp: str) -> dict:
    """cli.serve in file mode (8 slots, segments of 64, depth 2), bf16 as
    recorded, on the pedal run: 24 requests primed through the pedal
    codec (prompts of 1-200 tokens, 64-240 new; four with an eos id, four
    with their own sampling fields; the last, as in serve_requests, the
    500-token prime in a sliding window of 256 running 2,560 tokens past
    the 2048-row cache), every result written
    back through the codec, with exactly 6 kernel-A launches an admission
    call and 18 kernel-B a decode step."""
    rng = np.random.default_rng(29)
    own = [{"temperature": 0.9, "top_k": 20}, {"top_p": 0.9},
           {"greedy": True}, {"temperature": 1.2, "top_k": 5, "top_p": 0.95}]
    reqs = []
    for i in range(N_SERVE):
        r = {"id": f"p{i:02d}", "prime": prime_mid,
             "prime_len": SCH_SERVE_PROMPTS[i % len(SCH_SERVE_PROMPTS)],
             "max_new": int(rng.integers(*SCH_SERVE_NEW))}
        if i < 4:
            r["eos"] = int(rng.integers(0, 388))
        elif i < 8:
            r.update(own[i - 4])
        reqs.append(r)
    reqs[-1].update(prime_len=PROMPT, max_new=WINDOW_NEW,
                    window=SERVE_WINDOW)
    path = os.path.join(tmp, "pedal_requests.jsonl")
    with open(path, "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    outdir, buf = os.path.join(tmp, "pedal_served"), io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main([run, path, outdir, "--seed", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = (fused_relative_attention.launches, fused_decode_step.launches)
    out = buf.getvalue()
    summary = next(x for x in out.splitlines() if x.startswith("generated"))
    stat = {k: int(re.search(rf"(\d+) {k}", summary).group(1))
            for k in ("decode steps", "admission calls", "reprimes")}
    goodput = float(re.search(r"\(([\d.]+) tok/s goodput\)",
                              summary).group(1))
    written = dict(re.findall(r"wrote .*/(p\d\d)\.mid \((\d+) tokens\)", out))
    exact = all(int(written[r["id"]]) == r["max_new"] for r in reqs
                if "eos" not in r)
    ok = (rc == 0 and len(written) == N_SERVE and exact
          and "scheme pedal" in out and stat["reprimes"] > 0
          and n == (N_LAYERS * stat["admission calls"],
                    3 * N_LAYERS * stat["decode steps"]))
    print(f"cli.serve pedal bf16 file mode ({N_SERVE} requests) in "
          f"{secs:.3f} s (load, warm, serve, write): {summary}; launches "
          f"A={n[0]} (6 x {stat['admission calls']} admission calls), B="
          f"{n[1]} (18 x {stat['decode steps']} decode steps) "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"cli.serve pedal: rc {rc}, {len(written)} "
                             f"files, launches {n}, {stat}")
    return {"A": n[0], "B": n[1], "goodput": goodput}


def scheme_rate(scheme: str, shards: str) -> tuple:
    """The cli.train step at the scheme's vocabulary (bf16, B 8, seq 512,
    dropout 0.1): ms a step and the device's busy share."""
    cfg = apply_overrides(train_cli.TrainCLIConfig(),
                          [f"batch_size={B}", f"seq_len={L_TRAIN}"])
    at = train_cli._lm_batch_fn(TokenCorpus(shards, limlen=L_TRAIN + 1), cfg)
    batches = [to_device(at(i), DEV) for i in range(SCH_RATE_STEPS + 2)]
    model, tcfg, _ = train_cli.build_model(
        cfg, scheme, {"dtype": "bfloat16", "max_seq": MAX_SEQ}, DEV)
    tx = make_optimizer(tcfg)
    return train_step_rate(f"train step {scheme} bf16 (vocab "
                           f"{model.vocab_size}) B{B} L{L_TRAIN}",
                           make_train_step(tx, tcfg),
                           create_train_state(model, tx, dropout_seed=0),
                           batches)


def gru_scheme_cli(family: str, scheme: str, run: str, prime_mid: str,
                   tmp: str) -> int:
    """Greedy f32 cli.generate from a GRU step file of ``scheme`` (B 8,
    the prime's first 500 tokens through the scheme's codec, GS_GREEDY
    tokens; PerformanceRNN from its primary event and zero latents):
    exactly RNN_LAYERS kernel-D launches a decode step. Then the same
    decode through ``decode.generate``: the kernel path's tokens equal
    the plain path's, and row 0 written through the scheme's codec is
    the CLI's first file, byte for byte. Returns the CLI's launches."""
    prime = prime_tokens(prime_mid, RNN_PROMPT, scheme)
    perf = family == "performance_rnn"
    p = RNN_PROMPT + perf
    out = os.path.join(tmp, f"gru_{scheme}.mid")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, n, secs = count_d(lambda: cli_main(
            [run, out, "--prime", prime_mid, "--prime-len", str(RNN_PROMPT),
             "--steps", str(GS_GREEDY), "--batch", str(B), "--temperature",
             "0", "--dtype", "float32"] + (["--init-zero"] if perf else [])))
    model = load_checkpoint(run, device=DEV, dtype=torch.float32)
    toks = ([model.primary_event] if perf else []) + list(prime)
    prompt = torch.tensor([toks] * B, dtype=torch.long, device=DEV)
    kw = ({"cache0": model.init_cache(B, init=torch.zeros(
        B, model.init_dim, device=DEV))} if perf else {})
    dp = DecodeParams(max_len=p + GS_GREEDY, steps=GS_GREEDY,
                      sampling=SamplingParams(greedy=True))
    kern = generate(model, prompt, None, dp, **kw)
    with plain_path():
        plain = generate(model, prompt, None, dp, **kw)
    ref = os.path.join(tmp, f"gru_{scheme}_ref.mid")
    write_midi(kern[0].cpu().numpy(), ref, scheme)
    with open(ref, "rb") as f, open(os.path.join(
            tmp, f"gru_{scheme}-000.mid"), "rb") as g:
        same_file = f.read() == g.read()
    same = torch.equal(kern, plain)
    t = kern.cpu().numpy()
    ok = (rc == 0 and len(prime) == RNN_PROMPT
          and n == RNN_LAYERS * (p + GS_GREEDY) and same and same_file
          and 0 <= t.min() and t.max() < GS_WIDTHS[scheme])
    print(f"cli.generate {family} on {scheme} (event_dim {model.event_dim}) "
          f"greedy f32 B={B}, prime {p}, {GS_GREEDY} steps: {secs:.3f} s; "
          f"kernel D launches {n} (expected {RNN_LAYERS} x "
          f"{p + GS_GREEDY}); kernel path == plain path: {same}; written "
          f"through the {scheme} codec == the CLI's file: {same_file} "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"cli.generate {family} on {scheme} failed")
    return n


def gru_scheme_paths(tmp: str, shards: dict, prime_mid: str) -> dict:
    """The GRU families on the scheme corpora: cli.train EventMelodyRNN on
    remi and PerformanceRNN on pedal at full width (hidden 512, 3 layers,
    init_dim 32: event_dim 336 and 389), GS_STEPS f32 crop steps of GS_SEQ
    at B 8 with finite losses and no kernel-D launch; from each step file
    greedy cli.generate (``gru_scheme_cli``) and cli.serve in file mode
    (N_SERVE requests, bf16, launches counted). Returns kernel D's
    launches by path and the phase's seconds."""
    t0 = time.perf_counter()
    launches = {}
    for family, scheme in GS_RUNS:
        run = os.path.join(tmp, f"gru_{family}_{scheme}")
        fused_gru_step.launches = 0
        with quiet(os.path.join(tmp, "gru_train.log")):
            rc = train_cli.main(rnn_train_args(
                shards[scheme], run, GS_STEPS,
                [f"model={family}", f"seq_len={GS_SEQ}"]))
        ref = losses(run + ".jsonl")
        ok = (rc == 0 and fused_gru_step.launches == 0
              and sorted(ref) == list(range(GS_STEPS))
              and all(math.isfinite(v) for v in ref.values()))
        print(f"cli.train {family} on {scheme} f32 B{B} seq {GS_SEQ}: "
              f"losses {[round(ref[k], 4) for k in sorted(ref)]} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"cli.train {family} on {scheme} failed")
        launches[f"{scheme}_{family}_generate"] = gru_scheme_cli(
            family, scheme, run, prime_mid, tmp)
        launches[f"{scheme}_{family}_serve"], _ = rnn_serve_file_mode(
            family, tmp, run, prime_mid)
    secs = time.perf_counter() - t0
    print(f"GRU families on remi and pedal: {secs:.1f} s",
          f"on {gpu_line()}")
    return {"launches": launches, "secs": secs}


def scheme_paths(tmp: str) -> dict:
    """The MusicTransformer on remi, pedal and melody: corpora, cli.train
    (exact launches, cut and resumed), cli.eval, cli.generate (exact
    launches, rates), greedy kernel == plain and loop == step, kernel F
    and its sampler at V 131 and 390 with F's times there, cli.serve on
    the pedal run, and each train step's rate. Returns the launches by
    path, the runs, the rates."""
    prime_mid, shards = scheme_corpora(tmp)
    out = {"A": {}, "B": {}, "C": {}, "F": {}, "runs": {}, "shards": shards,
           "rates": {}, "prime_mid": prime_mid}
    for scheme in SCHEMES:
        run = os.path.join(tmp, f"run_{scheme}")
        tr = counted_train(f"cli.train {scheme} bf16 B{B} L{L_TRAIN}",
                           functools.partial(scheme_train_args,
                                             shards[scheme],
                                             steps=SCH_STEPS),
                           run, SCH_STEPS, (N_LAYERS, N_LAYERS), tmp)
        ev = scheme_eval(scheme, run, shards[scheme])
        gen = scheme_generate(scheme, run, prime_mid, tmp)
        f = scheme_parity(scheme, run, gen["prime"])
        step_ms, busy = scheme_rate(scheme, shards[scheme])
        out["runs"][scheme] = run
        out["A"].update({f"{scheme}_train": tr["A"], f"{scheme}_eval": ev["A"],
                         f"{scheme}_generate": gen["A"]})
        out["B"][f"{scheme}_generate"] = gen["B"]
        out["C"][f"{scheme}_train"] = tr["C"]
        out["F"][f"{scheme}_greedy_parity"] = f
        out["rates"][scheme] = {"step_ms": step_ms, "train_busy": busy,
                                "eval_tok_s": ev["tok_s"],
                                "decode_tok_s": gen["tok_s"]}
    out["f_err"] = max(check_kernel_f_vocab(v) for v in (131, 390))
    out["f_times"] = {v: time_kernel_f_vocab(v) for v in (131, 390)}
    served = scheme_serve(out["runs"]["pedal"], prime_mid, tmp)
    out["A"]["pedal_serve"], out["B"]["pedal_serve"] = (served["A"],
                                                        served["B"])
    out["goodput"] = served["goodput"]
    return out


def distill_step_parity(shards: str, teacher: str, tmp: str) -> None:
    """One f32 distillation step (dropout 0, TF32 off) of the draft on
    the card and on the CPU, from the same teacher (its weights in f32),
    student weights and batch: loss 1e-5 and grad norm 1e-4 relative."""
    payload = torch.load(latest_checkpoint(teacher), map_location="cpu",
                         weights_only=True)
    payload["config"]["model_kwargs"]["dtype"] = "float32"
    teacher32 = os.path.join(tmp, "teacher32")
    os.makedirs(teacher32)
    torch.save(payload, os.path.join(teacher32, "step-0.pt"))
    cfg = apply_overrides(train_cli.TrainCLIConfig(), [
        f"batch_size={B}", f"seq_len={L_TRAIN}", f"distill_from={teacher32}"])
    batch = train_cli._lm_batch_fn(TokenCorpus(shards, limlen=L_TRAIN + 1),
                                   cfg)(0)
    kw = {"num_layers": 2, "d_model": 128, "max_seq": MAX_SEQ,
          "dtype": "float32", "dropout_rate": 0.0}
    mets = []
    for dev in (DEV, torch.device("cpu")):
        model, tcfg, loss_fn = train_cli.build_model(cfg, "pedal", kw, dev,
                                                     distill=True)
        tx = make_optimizer(tcfg)
        t0 = time.perf_counter()
        _, met = make_train_step(tx, tcfg, loss_fn=loss_fn)(
            create_train_state(model, tx, dropout_seed=0),
            *to_device(batch, dev))
        mets.append((met, time.perf_counter() - t0))
    (card, t_card), (host, t_host) = mets
    loss_rel = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    norm_rel = abs(card["grad_norm"] - host["grad_norm"]) / host["grad_norm"]
    ok = loss_rel <= 1e-5 and norm_rel <= 1e-4
    print(f"distill step f32 B{B} L{L_TRAIN} (teacher 6 x 256, draft 2 x "
          f"128), card vs CPU: loss {card['loss']:.6f} / {host['loss']:.6f} "
          f"(rel {loss_rel:.2e}, tol 1e-5), grad norm "
          f"{card['grad_norm']:.6f} / {host['grad_norm']:.6f} (rel "
          f"{norm_rel:.2e}, tol 1e-4); {t_card:.2f} s / {t_host:.2f} s "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError("the card's distillation step differs from "
                             "the CPU's")


def distill_spec(teacher: str, draft: str, prime_mid: str, tmp: str) -> dict:
    """cli.generate --spec <draft dir> from the teacher run, greedy f32,
    B 1, the 500-token pedal prime, 256 tokens, chunk 8: launches exactly
    6 + 2 kernel-A (the two prefills), 18 kernel-E a verify forward and 6
    kernel-B a draft step (C a verify forward); its MIDI equals that of
    greedy f32 ``generate`` of the teacher written through the pedal
    codec."""
    out, buf = os.path.join(tmp, "spec_draft.mid"), io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([teacher, out, "--prime", prime_mid, "--prime-len",
                       str(PROMPT), "--steps", str(DISTILL_SPEC_STEPS),
                       "--temperature", "0", "--dtype", "float32",
                       "--spec", draft, "--spec-chunk", str(SPEC_CHUNK)])
    torch.cuda.synchronize()
    n = (fused_relative_attention.launches, fused_decode_chunk.launches,
         fused_decode_step.launches)
    text = buf.getvalue()
    m = re.search(r"speculative: (\d+) verify forwards for (\d+) tokens "
                  r"\(mean accepted ([\d.]+)/(\d+)\)", text)
    iters = int(m.group(1))
    want = (N_LAYERS + 2, iters * 3 * N_LAYERS, iters * SPEC_CHUNK * 3 * 2)
    target = load_checkpoint(teacher, device=DEV, dtype=torch.float32)
    prompt = torch.tensor([prime_tokens(prime_mid, PROMPT, "pedal")],
                          device=DEV)
    ref = generate(target, prompt, None, DecodeParams(
        max_len=PROMPT + DISTILL_SPEC_STEPS, steps=DISTILL_SPEC_STEPS,
        sampling=SamplingParams(greedy=True)))
    ref_mid = os.path.join(tmp, "spec_ref.mid")
    write_midi(ref[0].cpu().numpy(), ref_mid, "pedal")
    with open(out, "rb") as a, open(ref_mid, "rb") as b:
        same = a.read() == b.read()
    ok = rc == 0 and n == want and same
    print(f"cli.generate --spec <distilled draft> greedy f32 (B 1, prime "
          f"{PROMPT}, {DISTILL_SPEC_STEPS} tokens, chunk {SPEC_CHUNK}): "
          f"{m.group(0)}; launches A={n[0]} E={n[1]} B={n[2]} (expected "
          f"{want[0]}, {want[1]}, {want[2]}); MIDI == greedy generate's: "
          f"{same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("cli.generate --spec with the distilled draft "
                             "failed")
    return {"A": n[0], "E": n[1], "B": n[2],
            "mean_accepted": float(m.group(3))}


def distill_rate(shards: str, teacher: str) -> tuple:
    """The distillation step of the draft (bf16 as cli.train runs it,
    dropout 0.1, teacher forward under no_grad): ms and busy share."""
    cfg = apply_overrides(train_cli.TrainCLIConfig(), [
        f"batch_size={B}", f"seq_len={L_TRAIN}", f"distill_from={teacher}"])
    at = train_cli._lm_batch_fn(TokenCorpus(shards, limlen=L_TRAIN + 1), cfg)
    batches = [to_device(at(i), DEV) for i in range(SCH_RATE_STEPS + 2)]
    model, tcfg, loss_fn = train_cli.build_model(
        cfg, "pedal", {"num_layers": 2, "d_model": 128, "max_seq": MAX_SEQ,
                       "dtype": "bfloat16"}, DEV, distill=True)
    tx = make_optimizer(tcfg)
    return train_step_rate(f"distill step bf16 B{B} L{L_TRAIN} (teacher 6 "
                           "x 256, draft 2 x 128)",
                           make_train_step(tx, tcfg, loss_fn=loss_fn),
                           create_train_state(model, tx, dropout_seed=0),
                           batches)


def distill_paths(tmp: str, shards: str, teacher: str,
                  prime_mid: str) -> dict:
    """Draft distillation from the pedal run: cli.train distill_from= (the
    JAX recipe, 2 layers, d 128; exactly 6 + 2 kernel-A and 2 kernel-C
    launches a step; cut and resumed), one f32 step card vs CPU,
    cli.generate --spec <draft>, and the step's rate."""
    draft = os.path.join(tmp, "draft")
    tr = counted_train(f"cli.train distill_from=<pedal run> bf16 B{B} "
                       f"L{L_TRAIN}", functools.partial(
                           scheme_train_args, shards, steps=SCH_STEPS,
                           extra=[*DISTILL_KW, f"distill_from={teacher}"]),
                       draft, SCH_STEPS, (N_LAYERS + 2, 2), tmp)
    distill_step_parity(shards, teacher, tmp)
    spec = distill_spec(teacher, draft, prime_mid, tmp)
    step_ms, busy = distill_rate(shards, teacher)
    return {"A": {"distill_train": tr["A"], "distill_spec": spec["A"]},
            "C": {"distill_train": tr["C"]},
            "B": {"distill_spec": spec["B"]}, "E": spec["E"],
            "step_ms": step_ms, "busy": busy,
            "mean_accepted": spec["mean_accepted"]}


def scheme_slice_paths() -> dict:
    """``scheme_paths``, ``gru_scheme_paths`` on its corpora, then
    ``distill_paths`` (its teacher the pedal run) in one scratch
    directory; prints each phase's seconds."""
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        sch = scheme_paths(tmp)
        gru = gru_scheme_paths(tmp, sch["shards"], sch["prime_mid"])
        t1 = time.perf_counter()
        dist = distill_paths(tmp, sch["shards"]["pedal"],
                             sch["runs"]["pedal"], sch["prime_mid"])
    print(f"scheme phases: {t1 - t0:.1f} s (the GRU families' "
          f"{gru['secs']:.1f} s); distill phases: "
          f"{time.perf_counter() - t1:.1f} s", f"on {gpu_line()}")
    return {"scheme": sch, "distill": dist, "gru": gru}


def cp_window_serving(rows: np.ndarray) -> dict:
    """Sliding-window CP serving, greedy f32 at full width: 4 requests of
    1,536 rows with window 256 on the 1024-row cache (prompts of 600, 256,
    64 and 1 rows, cut to their last 256), each re-priming its slot
    several times; the kernel path's rows (A on every admission and
    re-prime, ragged B) equal the plain path's. Returns the kernel path's
    launches, re-primes and rows/s (host clock)."""
    model32 = cp_model(torch.float32)
    prompts = [rows[:p] for p in (600, 256, 64, 1)]
    outs, stats = [], None
    for plain in (False, True):
        cb = CPContinuousBatcher(model32, slots=SLOTS, seg_len=SEG,
                                 depth=DEPTH,
                                 sampling=SamplingParams(greedy=True))
        reset_counts()
        t0 = time.perf_counter()
        with plain_path() if plain else contextlib.nullcontext():
            rids = [cb.submit(x, CP_WINDOW_NEW, window=CP_WINDOW)
                    for x in prompts]
            done = cb.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if not plain:
            stats = cb.stats()
            n = (fused_relative_attention.launches,
                 fused_decode_step.launches)
            rows_s = len(prompts) * CP_WINDOW_NEW / secs
        outs.append([done[r] for r in rids])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    shapes = all(o.shape == (CP_WINDOW_NEW, cp.WIDTH) for o in outs[0])
    ok = (same and shapes and stats["reprimes"] >= 2 * len(prompts)
          and n == (CP_LAYERS * stats["admit_calls"],
                    3 * CP_LAYERS * stats["steps"]))
    print(f"CP window serving greedy f32 ({len(prompts)} requests of "
          f"{CP_WINDOW_NEW} rows, window {CP_WINDOW}, cache {CP_MAX_SEQ}): "
          f"kernel path == plain path: {same}; {stats['reprimes']} re-primes, "
          f"{stats['admit_calls']} admission calls, "
          f"{stats['steps']} decode steps; launches A={n[0]} ragged "
          f"B={n[1]}; {rows_s:.1f} rows/s (kernel path, host clock) "
          f"{'ok' if ok else 'FAIL'}", f"on {gpu_line()}")
    if not ok:
        raise AssertionError(f"CP window serving: same {same}, {stats}, "
                             f"launches {n}")
    return {"A": n[0], "B": n[1], "rows_s": rows_s}


# data parallelism on the one card: generate_dp, CP's mesh=, PoPMAG's
# generate_arrangement_dp and one dp train step on virtual meshes of the
# card (NCCL refuses two ranks on one GPU), FSDP2 under a one-rank NCCL
# group, then the checkpoint CLIs. Greedy parity runs in f32: 64 tokens
# of the flagship, 64 CP rows after 256, 64 GRU tokens after the prime,
# PoPMAG over 4 bars
DP_SHARDS, DP_GREEDY = (2, 4), 64
DP_CP_PROMPT, DP_CP_ROWS, DP_RNN_STEPS, DP_PM_BARS = 256, 64, 64, 4
FSDP_STEPS, FSDP_RATE_STEPS = 3, 10
CK_PRIME, CK_STEPS = 100, 128


def vmesh(dp: int):
    """A virtual mesh of ``dp`` data shards, every one on the card."""
    return make_mesh(dp=dp, devices=[DEV] * dp)


def counted(fn):
    """(fn(), (kernel A, kernel B) launches during it, host seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (fused_relative_attention.launches,
                 fused_decode_step.launches), time.perf_counter() - t0


def expect(label: str, got, want) -> None:
    print(f"{label}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def dp_generate(prime: np.ndarray) -> dict:
    """``generate_dp`` of the flagship in bf16 (B 8, the 500-token prime
    bucketed to 512, 512 sampled tokens) on virtual meshes of 2 and 4
    shards, with exactly 6 A launches a shard prefill and 18 B a shard
    decode step, tokens/s beside ``generate``'s (host clock, prefill
    included; one card: no scaling); then greedy f32 ``generate_dp`` ==
    ``generate``, 64 tokens."""
    model = flagship(torch.bfloat16)
    prompt_np, prompt_len = bucket_prompt(np.tile(prime, (B, 1)), STEPS,
                                          MAX_SEQ, model.pad_id)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    dp = DecodeParams(max_len=L_PREFILL + STEPS, steps=STEPS,
                      sampling=SamplingParams())
    gen = torch.Generator(device=DEV).manual_seed(0)
    warm = DecodeParams(max_len=L_PREFILL + 8, steps=8,
                        sampling=SamplingParams())
    for n in (1,) + DP_SHARDS:  # the first calls of a process run slower
        generate_dp(model, prompt, 0, warm, vmesh(n), prompt_len)
    _, _, secs = counted(lambda: generate(model, prompt, gen, dp, prompt_len))
    rates, a, b = {1: B * STEPS / secs}, 0, 0
    for n in DP_SHARDS:
        toks, got, secs = counted(lambda: generate_dp(
            model, prompt, 0, dp, vmesh(n), prompt_len))
        expect(f"generate_dp bf16 dp {n}", got,
               (N_LAYERS * n, 3 * N_LAYERS * STEPS * n))
        t = toks.cpu().numpy()
        if t.shape != (B, STEPS) or t.min() < 0 or t.max() >= VOCAB:
            raise AssertionError(f"bad tokens {t.shape}")
        rates[n] = B * STEPS / secs
        a, b = a + got[0], b + got[1]
    model32 = flagship(torch.float32)
    dpg = DecodeParams(max_len=L_PREFILL + DP_GREEDY, steps=DP_GREEDY,
                       sampling=SamplingParams(greedy=True))
    ref = generate(model32, prompt, None, dpg, prompt_len)
    for n in DP_SHARDS:
        toks, got, _ = counted(lambda: generate_dp(
            model32, prompt, 0, dpg, vmesh(n), prompt_len))
        expect(f"generate_dp greedy f32 dp {n}", got,
               (N_LAYERS * n, 3 * N_LAYERS * DP_GREEDY * n))
        same = torch.equal(toks, ref)
        print(f"greedy f32 generate_dp dp {n} == generate, {DP_GREEDY} "
              f"tokens x {B}: {same}")
        if not same:
            raise AssertionError(f"generate_dp dp {n} differs first at "
                                 f"{(toks != ref).nonzero()[0].tolist()}")
        a, b = a + got[0], b + got[1]
    print("generate_dp bf16 B=8 tokens/s (host clock, prefill included, one "
          "card: no scaling): " + ", ".join(
              f"dp {n} {r:.1f}" for n, r in rates.items()),
          f"on {gpu_line()}")
    return {"A": a, "B": b, "tok_s": rates}


def dp_cp(tmp: str) -> dict:
    """Greedy f32 ``generate_cp(mesh=)`` on 2 shards == ``generate_cp``
    (B 8, 64 rows after 256), exactly 4 A a shard prefill and 12 B a
    shard row."""
    _, rows = cp_prime(tmp)
    prompt = np.tile(rows[None, :DP_CP_PROMPT], (B, 1, 1))
    model = cp_model(torch.float32)
    ref = generate_cp(model, prompt, DP_CP_ROWS, greedy=True)
    out, got, _ = counted(lambda: generate_cp(
        model, prompt, DP_CP_ROWS, greedy=True, mesh=vmesh(2)))
    expect("CP generate_cp(mesh=) greedy f32 dp 2", got,
           (CP_LAYERS * 2, 3 * CP_LAYERS * DP_CP_ROWS * 2))
    same = torch.equal(out, ref)
    print(f"CP greedy f32 dp 2 == mesh=None, {DP_CP_ROWS} rows x {B}: {same}")
    if not same:
        raise AssertionError("CP dp rows differ")
    return {"A": got[0], "B": got[1]}


def dp_gru(prime: np.ndarray) -> int:
    """Greedy f32 ``generate_dp`` of both GRU families on 2 shards (the
    500-token prime, 64 tokens; PerformanceRNN with its latent-seeded
    cache0 and controls) == ``generate``, kernel D exactly L a shard
    step."""
    total = 0
    for family in ("event_rnn", "performance_rnn"):
        model = rnn_model(family, torch.float32)
        prompt = rnn_prompt(family, prime, B)
        kw = rnn_conditioning(model, B)
        dp = DecodeParams(max_len=prompt.shape[1] + DP_RNN_STEPS,
                          steps=DP_RNN_STEPS,
                          sampling=SamplingParams(greedy=True))
        ref = generate(model, prompt, None, dp, **kw)
        out, n, _ = count_d(lambda: generate_dp(model, prompt, 0, dp,
                                                vmesh(2), **kw))
        want = 2 * (prompt.shape[1] + DP_RNN_STEPS) * RNN_LAYERS
        same = torch.equal(out, ref)
        print(f"greedy f32 {family} generate_dp dp 2 == generate: {same}; "
              f"kernel D launches {n} (expected {want})")
        if not same or n != want:
            raise AssertionError(f"{family} dp: same {same}, launches {n}")
        total += n
    return total


def dp_popmag(tmp: str) -> int:
    """Greedy f32 ``generate_arrangement_dp`` on 2 shards (B 8, 4 bars) ==
    ``generate_arrangement``, kernel D exactly 400 a bar a shard."""
    _, mels = popmag_melodies(tmp)
    src, src_len = pool_batch(mels)
    model = popmag_model(torch.float32)
    init = torch.randn(B, model.init_dim,
                       generator=torch.Generator().manual_seed(5))
    ref = generate_arrangement(model, init, src, src_len, DP_PM_BARS)
    out, n, _ = count_d(lambda: generate_arrangement_dp(
        model, init, src, src_len, DP_PM_BARS, vmesh(2)))
    want = PM_LAUNCHES_PER_BAR * DP_PM_BARS * 2
    same = torch.equal(out[1], ref[1]) and all(
        np.array_equal(x, y) for x, y in zip(flatten_arrangement(*out),
                                             flatten_arrangement(*ref)))
    print(f"PoPMAG greedy f32 generate_arrangement_dp dp 2 == unsharded, "
          f"{DP_PM_BARS} bars x {B}: {same}; kernel D launches {n} "
          f"(expected {want})")
    if not same or n != want:
        raise AssertionError(f"PoPMAG dp: same {same}, launches {n}")
    return n


def shard_loss(tcfg, mesh):
    """A ``loss_fn`` for the single-device step that runs each data shard
    of the virtual ``mesh`` on its rows of the micro-batch, one forward a
    shard, each shard's loss its local sum over the micro-batch's count
    of kept targets (as a rank of a process group computes it): the
    shards' sum is the global mean."""
    def loss_fn(model, x, y, generator):
        denom = kept_count(y, tcfg)
        loss = acc = 0.0
        for i in range(mesh.data):
            xi, yi = shard_batch(mesh, (x, y), i)
            logits = model(xi, deterministic=False, generator=generator)
            loss = loss + smooth_cross_entropy(
                logits, yi, tcfg.vocab_size, tcfg.label_smoothing,
                tcfg.pad_id, denom)
            acc = acc + token_accuracy(logits, yi, tcfg.pad_id, denom)
        return loss, acc
    return loss_fn


def dp_train_step(shards: str) -> tuple:
    """One f32 train step (dropout 0) of the flagship at B 8, seq 512 with
    the loss taken a data shard at a time (``shard_loss``, 2 shards whose
    rows hold different numbers of pad targets), against the step on the
    whole batch (both through kernels A and C): PERF.md section 2's
    tolerances, exactly 6 A + 6 C a shard."""
    cfg, batches = train_batches(1, shards)
    x, y = batches[0]
    y = y.clone()
    y[0, :200] = VOCAB - 1       # shard 0: 203 pad targets
    y[1, 5:8] = VOCAB - 1
    y[6, :17] = VOCAB - 1        # shard 1: 17
    kw = {"dtype": "float32", "dropout_rate": 0.0, "num_layers": N_LAYERS}
    results, counts = [], []
    for mesh in (None, vmesh(2)):
        model, tcfg, _ = train_cli.build_model(cfg, "midilike", kw, DEV)
        tx = make_optimizer(tcfg)
        state = create_train_state(model, tx, dropout_seed=cfg.seed)
        step = make_train_step(
            tx, tcfg, loss_fn=mesh and shard_loss(tcfg, mesh))
        reset_counts()
        fused_relative_attention_bwd.launches = 0
        state, m = step(state, x, y)
        torch.cuda.synchronize()
        counts.append((fused_relative_attention.launches,
                       fused_relative_attention_bwd.launches))
        results.append((state, m))
    expect("dp 2 train step f32", counts[1], (2 * N_LAYERS, 2 * N_LAYERS))
    step_parity(f"dp 2 train step (a loss a data shard, B{B} L{L_TRAIN}, "
                "unequal pads) vs the whole batch", results[1], results[0],
                tx.lr(0))
    return counts[1]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_env():
    """The variables ``torchrun --nproc-per-node 1`` sets, on a free
    local port, for the duration of the block."""
    env = dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def fsdp_cli(tmp: str, shards: str) -> dict:
    """``cli.train fsdp=true`` at full width, f32, dropout 0, 3 steps,
    started as ``torchrun --nproc-per-node 1`` starts it (a one-rank NCCL
    group), against the same run without fsdp: equal losses (1e-5
    relative), exactly 6 A + 6 C a step. Returns the launches and the
    fsdp run's directory."""
    runs = {}
    for name, extra in (("plain", ()), ("fsdp", ("fsdp=true",))):
        run = os.path.join(tmp, f"fsdp_{name}")
        reset_counts()
        fused_relative_attention_bwd.launches = 0
        env = one_rank_env() if extra else contextlib.nullcontext()
        with env, quiet(os.path.join(tmp, "train.log")):
            train_cli.main(train_args(
                shards, run, FSDP_STEPS, "model.dtype=float32",
                "model.dropout_rate=0.0", f"model.num_layers={N_LAYERS}",
                *extra))
        torch.cuda.synchronize()
        runs[name] = (losses(run + ".jsonl"),
                      (fused_relative_attention.launches,
                       fused_relative_attention_bwd.launches), run)
    (plain, _, _), (fs, got, run) = runs["plain"], runs["fsdp"]
    expect("cli.train fsdp=true f32", got,
           (N_LAYERS * FSDP_STEPS, N_LAYERS * FSDP_STEPS))
    diff = max(abs(fs[s] - plain[s]) / abs(plain[s]) for s in plain)
    print(f"cli.train fsdp=true vs without, {FSDP_STEPS} steps: losses "
          f"{[round(fs[s], 6) for s in sorted(fs)]}, max rel diff "
          f"{diff:.2e} (tol 1e-5)")
    if sorted(fs) != list(range(FSDP_STEPS)) or diff > 1e-5:
        raise AssertionError(f"fsdp losses {fs} vs {plain}")
    return {"A": got[0], "C": got[1], "run": run}


def fsdp_rate(shards: str) -> dict:
    """The bf16 train step (dropout 0.1, full width) with the model
    sharded by FSDP2 over a one-rank NCCL group and without, interleaved
    (plain, fsdp, fsdp, plain), CUDA events over FSDP_RATE_STEPS warm
    steps each."""
    import torch.distributed as dist

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, fsdp=True, device=DEV)
        cfg, batches = train_batches(FSDP_RATE_STEPS + 1, shards)
        times = {"plain": [], "fsdp": []}
        for name in ("plain", "fsdp", "fsdp", "plain"):
            m = mesh if name == "fsdp" else None
            model, tcfg, _ = train_cli.build_model(
                cfg, "midilike", {"dtype": "bfloat16",
                                  "num_layers": N_LAYERS}, DEV)
            tx = make_optimizer(tcfg)
            state = create_train_state(model, tx, cfg.seed, mesh=m)
            step = make_train_step(tx, tcfg, mesh=m)
            state, _ = step(state, *batches[0])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for x, y in batches[1:]:
                state, _ = step(state, x, y)
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / FSDP_RATE_STEPS)
            if name == "fsdp":
                sharded = (state, step)
        state, step = sharded
        # where the sharded step's time goes: the device's busy share
        # and its kernels (the gathers and reduce-scatters among them)
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for x, y in batches[1:4]:
                state, _ = step(state, x, y)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        dist.destroy_process_group()
    ms = {k: float(np.median(v)) for k, v in times.items()}
    rows = device_rows(prof)
    busy = sum(r[0] for r in rows)
    print(f"train step bf16 B{B} L{L_TRAIN}: fsdp (one-rank NCCL group) "
          f"{ms['fsdp']:.3f} ms, unsharded {ms['plain']:.3f} ms (runs "
          f"{times}; CUDA events over {FSDP_RATE_STEPS} steps); under the "
          f"profiler the fsdp step's device is busy {busy / 3e3:.3f} ms of "
          f"{wall_us / 3e3:.3f} ({100 * busy / wall_us:.1f}%)",
          f"on {gpu_line()}")
    for dev_us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {dev_us / 3:9.1f} us/step {count / 3:6.1f}x/step "
              f"{key[:80]}")
    return dict(ms, busy=busy / wall_us)


def dp_cli_refusal() -> None:
    """``cli.generate --dp 2`` on the one card exits as the JAX CLI's
    ``_dp_mesh`` does."""
    try:
        dp_mesh(2, B, "cuda")
    except SystemExit as e:
        print(f"cli.generate --dp 2 on {torch.cuda.device_count()} card: "
              f"exits with {str(e)!r}")
        if "needs 2 devices, have 1" not in str(e):
            raise
        return
    raise AssertionError("--dp 2 took a mesh on one card")


def dp_paths(tmp: str, shards: str, prime: np.ndarray) -> dict:
    """Every data-parallel phase; launches by path for the kernels
    line."""
    gen = dp_generate(prime)
    cpr = dp_cp(tmp)
    d_gru = dp_gru(prime)
    d_pm = dp_popmag(tmp)
    step = dp_train_step(shards)
    fs = fsdp_cli(tmp, shards)
    rate = fsdp_rate(shards)
    dp_cli_refusal()
    return {"A": {"dp_generate": gen["A"], "dp_cp": cpr["A"],
                  "dp_train": step[0], "fsdp_train": fs["A"]},
            "B": {"dp_generate": gen["B"], "dp_cp": cpr["B"]},
            "C": {"dp_train": step[1], "fsdp_train": fs["C"]},
            "D": {"dp_gru": d_gru, "dp_popmag": d_pm},
            "tok_s": gen["tok_s"], "fsdp_ms": rate, "fsdp_run": fs["run"]}


def checkpoint_cli(tmp: str, run: str) -> dict:
    """The fsdp run exported by ``cli.export_checkpoint`` and imported by
    ``cli.import_checkpoint``: ``cli.generate`` from the imported run
    (B 8, a 100-token prime, 128 sampled tokens; exactly 6 A and 18 B a
    step) writes the MIDI bytes the original run gives; then
    ``cli.check_install`` exits 0."""
    pth = os.path.join(tmp, "exported.pth")
    prime_mid = os.path.join(tmp, "ck_prime.mid")
    write_midi(np.random.default_rng(3).integers(0, VOCAB - 1, 600),
               prime_mid)
    with quiet(os.path.join(tmp, "ck.log")):
        export_main([run, pth])
        import_main([pth, os.path.join(tmp, "imported")])
    outs, a, b = {}, 0, 0
    for name, src in (("original", run),
                      ("imported", os.path.join(tmp, "imported"))):
        out = os.path.join(tmp, f"ck_{name}.mid")
        with quiet(os.path.join(tmp, "ck.log")):
            _, got, _ = counted(lambda: cli_main(
                [src, out, "--prime", prime_mid, "--prime-len",
                 str(CK_PRIME), "--steps", str(CK_STEPS), "--batch", str(B),
                 "--seed", "0"]))
        expect(f"cli.generate from the {name} run", got,
               (N_LAYERS, 3 * N_LAYERS * CK_STEPS))
        outs[name] = [open(os.path.join(tmp, f"ck_{name}-{i:03d}.mid"),
                           "rb").read() for i in range(B)]
        a, b = a + got[0], b + got[1]
    same = outs["original"] == outs["imported"]
    print(f"export -> import -> cli.generate: MIDI bytes equal to the "
          f"original run's: {same}")
    if not same:
        raise AssertionError("the imported run generates other MIDI")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_install_main([])
    print(buf.getvalue().rstrip())
    if rc != 0:
        raise AssertionError(f"cli.check_install exited {rc}")
    return {"A": a, "B": b}



# -- tensor and pipeline parallelism on virtual meshes of the card -------

# model axis sizes: H 2 and H 1 a shard; tp 8 does not divide the 4
# heads, so the attention block is replicated (all heads on each shard)
TP_SHARDS = (2, 4, 8)
PP_CASES = ((2, 2), (2, 4), (3, 4))       # (pp, n_micro)
TP_GREEDY, TP_RATE_STEPS = 64, 6          # greedy tokens; rate batches


def tp_mesh(tp: int = 1, sp: int = 1, pp: int = 1):
    """A virtual (data 1, seq, model, pipe) mesh, every shard on the
    card."""
    return make_mesh(dp=1, tp=tp, sp=sp, pp=pp,
                     devices=[DEV] * (tp * sp * pp))


def shard_attn_bound(h: int, backward: bool) -> tuple:
    """Kernel A's (or C's) bound at B 8, ``h`` heads, L 512, bf16, no
    key_pad, max_seq 512: time_kernel_a's and time_kernel_c's counts."""
    bh, l = B * h, L_TRAIN
    if backward:
        nbytes = 8 * bh * l * DH * 2 + bh * l * 4 + 2 * l * DH * 4
        flops = 8 * 2 * DH * bh * l * (l + 1) / 2
    else:
        nbytes = 4 * bh * l * DH * 2 + l * DH * 4 + bh * l * 4
        flops = 3 * 2 * DH * bh * l * (l + 1) / 2
    return bound(nbytes, flops, torch.bfloat16)


def check_head_shards() -> dict:
    """Kernels A and C on one head shard's heads, H 2 (tp 2) and H 1 (tp
    4), B 8, L 512, f32 and bf16, against their plain versions: A at the
    training shape (causal, no key_pad, max_seq 512) and at
    ``generate_tp``'s prefill (the bucket's key-padded tail, max_seq
    2048), C at the training shape (a second call bit-equal); then both
    timed in bf16 at the training shape (``device_ms``) beside their
    bounds. Returns the bf16 errors and the times by H."""
    gen = torch.Generator().manual_seed(41)
    out = {"err_a": 0.0, "err_c": 0.0}
    for h in (2, 1):
        for dtype in (torch.float32, torch.bfloat16):
            for pad, ms in ((False, L_TRAIN), (True, MAX_SEQ)):
                q, k, v = (torch.randn(B, h, L_TRAIN, DH, generator=gen)
                           .to(DEV, dtype) for _ in range(3))
                e = torch.randn(ms, DH, generator=gen).to(DEV)
                kp = None
                if pad:
                    kp = torch.zeros(B, L_TRAIN, device=DEV)
                    kp[:, L_TRAIN - (L_PREFILL - PROMPT):] = 1.0
                o, lse = fused_relative_attention(q, k, v, e, kp, True,
                                                  return_lse=True)
                ref, ref_lse = fused_relative_attention_plain(
                    q, k, v, e, kp, True, return_lse=True)
                errs = [(o.float() - ref.float()).abs().max().item(),
                        (lse - ref_lse).abs().max().item()]
                line = (f"kernel A {str(dtype):15s} H{h} L{L_TRAIN} "
                        f"max_seq={ms} key_pad={pad!s:5s}: max_abs_err "
                        f"{errs[0]:.3e} lse_err {errs[1]:.3e} (tol "
                        f"{TOL_A[dtype]:.1e})")
                ok = errs[0] <= TOL_A[dtype] and errs[1] <= 1e-3
                if not pad:
                    dout = torch.randn(q.shape, generator=gen).to(DEV, dtype)
                    got = fused_relative_attention_bwd(q, k, v, e, None,
                                                       True, o, lse, dout)
                    again = fused_relative_attention_bwd(q, k, v, e, None,
                                                         True, o, lse, dout)
                    cref = fused_relative_attention_bwd_plain(
                        q, k, v, e, None, True, o, lse, dout)
                    cerr = [rel_err(a, r) for a, r in zip(got, cref)]
                    same = all(torch.equal(a, b) for a, b in zip(got, again))
                    ok = ok and max(cerr) <= TOL_C[dtype] and same
                    line += (f"; kernel C rel_err dq/dk/dv/dE "
                             + "/".join(f"{x:.2e}" for x in cerr)
                             + f" (tol {TOL_C[dtype]:.0e}) bit_equal_rerun="
                             f"{same}")
                    if dtype == torch.bfloat16:
                        out["err_c"] = max(out["err_c"], max(
                            (a.float() - r.float()).abs().max().item()
                            for a, r in zip(got, cref)))
                print(line, "ok" if ok else "FAIL")
                if not ok:
                    raise AssertionError(f"kernel A or C disagrees with its "
                                         f"plain version at H {h}")
                if dtype == torch.bfloat16:
                    out["err_a"] = max(out["err_a"], errs[0])
        # bf16 times at the training shape: q, k, v, e of the last case
        q, k, v = (torch.randn(B, h, L_TRAIN, DH, generator=gen)
                   .to(DEV, torch.bfloat16) for _ in range(3))
        e = torch.randn(L_TRAIN, DH, generator=gen).to(DEV)
        dout = torch.randn(q.shape, generator=gen).to(DEV, torch.bfloat16)
        o, lse = fused_relative_attention(q, k, v, e, None, True,
                                          return_lse=True)
        a_ms = device_ms(lambda: fused_relative_attention(q, k, v, e, None,
                                                          True))
        c_ms = device_ms(lambda: fused_relative_attention_bwd(
            q, k, v, e, None, True, o, lse, dout))
        (a_b, a_by), (c_b, c_by) = (shard_attn_bound(h, bw)
                                    for bw in (False, True))
        print(f"head shard H{h} bf16 B{B} L{L_TRAIN} causal, max_seq "
              f"{L_TRAIN}: kernel A {a_ms:.4f} ms (bound {a_b:.4f}, {a_by}),"
              f" kernel C {c_ms:.4f} ms (bound {c_b:.4f}, {c_by})",
              f"on {gpu_line()}")
        out[h] = {"a_ms": a_ms, "a_bound_ms": a_b, "c_ms": c_ms,
                  "c_bound_ms": c_b}
    return out


def tp_counts() -> tuple:
    """(kernel A, kernel C, kernel G, kernel B) launches so far."""
    torch.cuda.synchronize()
    return (fused_relative_attention.launches,
            fused_relative_attention_bwd.launches, ring_tile.launches,
            fused_decode_step.launches)


def zero_tp_counts() -> None:
    zero_ring_counts()
    fused_decode_step.launches = 0


def tp_model(mesh=None, dtype=torch.float32, impl: str = "auto",
             dropout: float = 0.0) -> mt.MusicTransformer:
    """The flagship's training model (max_seq = seq_len 512, dense crops)
    with seed-0 weights, on ``mesh``'s head shards where it has them."""
    return mt.MusicTransformer(
        vocab_size=VOCAB, num_layers=N_LAYERS, d_model=D_MODEL,
        max_seq=L_TRAIN, dtype=dtype, device=DEV, dropout_rate=dropout,
        pad_in_input=False, generator=torch.Generator().manual_seed(0),
        attention_impl=impl, mesh=mesh)


def counted_step(model, x, y, mesh=None, apply=None) -> tuple:
    """One f32 train step of ``model`` (through ``apply``, a pipelined
    forward, where given): ((state, metrics), (A, C, G, B) launches,
    lr)."""
    tcfg = TrainerConfig(vocab_size=VOCAB, pad_id=VOCAB - 1,
                         d_model=D_MODEL)
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=0, mesh=mesh)
    loss_fn = apply and train_cli.pipeline_loss_fn(tcfg, apply)
    step = make_train_step(tx, tcfg, loss_fn=loss_fn, mesh=mesh)
    zero_tp_counts()
    out = step(state, x, y)
    return out, tp_counts(), tx.lr(0)


def tp_attn_launches(tpn: int) -> int:
    """Kernel A (or C) launches of one forward on a tp ``tpn`` mesh: one a
    layer and head shard, one a layer where tp does not divide the
    heads."""
    return N_LAYERS * (tpn if H % tpn == 0 else 1)


def tp_paths(shards: str) -> dict:
    """The tensor-parallel train step (f32, dropout 0, the flagship at B
    8, seq 512 from the corpus) on virtual tp 2, tp 4 and tp 8 (the
    attention replicated) meshes of the card, and on tp 2 x sp 2 with ``attention_impl="ring_pallas"``, each
    against the unsharded step (PERF.md section 2's tolerances), with
    exact launches. Returns the launches by path."""
    _, batches = train_batches(1, shards)
    x, y = batches[0]
    ref, counts, lr = counted_step(tp_model(), x, y)
    expect("unsharded train step f32 (A, C, G, B)", counts,
           (N_LAYERS, N_LAYERS, 0, 0))
    out = {"A": {}, "C": {}, "G": {}}
    for tpn in TP_SHARDS:
        mesh = tp_mesh(tp=tpn)
        got, counts, _ = counted_step(tp_model(mesh), x, y, mesh)
        expect(f"tp {tpn} train step f32 (A, C, G, B)", counts,
               (tp_attn_launches(tpn), tp_attn_launches(tpn), 0, 0))
        heads = (f"H {H // tpn} a shard" if H % tpn == 0
                 else f"the {H} heads replicated")
        step_parity(f"tp {tpn} train step f32 (B{B} L{L_TRAIN}, {heads}) "
                    "vs unsharded", got, ref, lr)
        out["A"][f"tp{tpn}_train"] = counts[0]
        out["C"][f"tp{tpn}_train"] = counts[1]
    mesh = tp_mesh(tp=2, sp=2)
    got, counts, _ = counted_step(tp_model(mesh, impl="ring_pallas"), x, y,
                                  mesh)
    expect("tp 2 x sp 2 train step f32 (A, C, G, B)", counts,
           (0, 0, N_LAYERS * 2 * 2, 0))
    step_parity(f"tp 2 x sp 2 train step f32 (kernel G on each head "
                "shard's ring, plain-ring backward) vs unsharded", got, ref,
                lr)
    out["G"]["tp2xsp2_train"] = counts[2]
    return out


def pp_paths(shards: str) -> dict:
    """The pipelined train step (f32, dropout 0, B 8, seq 512): pp 2 with
    2 and 4 micro-batches and pp 3 with 4 on virtual meshes of the card,
    each against the unsharded step, exactly 6 n_micro A and C (each
    micro-batch through the 6 layers once); the pipelined logits equal
    the unsharded model's. Returns the launches by path."""
    _, batches = train_batches(1, shards)
    x, y = batches[0]
    ref, _, lr = counted_step(tp_model(), x, y)
    out = {"A": {}, "C": {}}
    for pp, nm in PP_CASES:
        mesh = tp_mesh(pp=pp)
        model = tp_model()
        apply = make_pipeline_apply(model, mesh, nm)
        with torch.no_grad():
            err = (apply(x) - model(x)).abs().max().item()
        got, counts, _ = counted_step(model, x, y, mesh, apply)
        expect(f"pp {pp} n_micro {nm} train step f32 (A, C, G, B)", counts,
               (N_LAYERS * nm, N_LAYERS * nm, 0, 0))
        print(f"pp {pp} n_micro {nm}: pipelined logits vs unsharded max_abs "
              f"{err:.3e} (tol 1e-4)")
        if err > 1e-4:
            raise AssertionError("the pipelined forward disagrees")
        step_parity(f"pp {pp} n_micro {nm} train step f32 (B{B} "
                    f"L{L_TRAIN}) vs unsharded", got, ref, lr)
        out["A"][f"pp{pp}_m{nm}_train"] = counts[0]
        out["C"][f"pp{pp}_m{nm}_train"] = counts[1]
    return out


def tp_generate(prime: np.ndarray) -> dict:
    """``generate_tp`` of the flagship (the 500-token prime bucketed to
    512, B 8): greedy f32, 64 tokens, == ``generate`` at tp 2, 4 and 8
    with exactly 6 tp A a prefill (6 at tp 8, whose shards do not split
    the 4 heads) and no kernel B; sampled bf16, 512 tokens,
    at tp 2 twice, equal, tokens/s beside ``generate``'s (host clock,
    prefill included; one card: no scaling claim)."""
    prompt_np, prompt_len = bucket_prompt(np.tile(prime, (B, 1)), STEPS,
                                          MAX_SEQ, VOCAB - 1)
    prompt = torch.from_numpy(prompt_np).to(DEV)
    model32 = flagship(torch.float32)
    greedy = DecodeParams(max_len=L_PREFILL + TP_GREEDY, steps=TP_GREEDY,
                          sampling=SamplingParams(greedy=True))
    ref = generate(model32, prompt, None, greedy, prompt_len)
    a = 0
    for tpn in TP_SHARDS:
        zero_tp_counts()
        toks = generate_tp(model32, prompt, 0, greedy, tp_mesh(tp=tpn),
                           prompt_len)
        counts = tp_counts()
        expect(f"generate_tp greedy f32 tp {tpn} (A, C, G, B)", counts,
               (tp_attn_launches(tpn), 0, 0, 0))
        same = torch.equal(toks, ref)
        print(f"greedy f32 generate_tp tp {tpn} == generate, {TP_GREEDY} "
              f"tokens x {B}: {same}")
        if not same:
            raise AssertionError(f"generate_tp tp {tpn} differs first at "
                                 f"{(toks != ref).nonzero()[0].tolist()}")
        a += counts[0]
    model = flagship(torch.bfloat16)
    dp = DecodeParams(max_len=L_PREFILL + STEPS, steps=STEPS,
                      sampling=SamplingParams())
    warm = DecodeParams(max_len=L_PREFILL + 8, steps=8,
                        sampling=SamplingParams())
    generate_tp(model, prompt, 0, warm, tp_mesh(tp=2), prompt_len)
    generate(model, prompt, torch.Generator(device=DEV).manual_seed(0),
             warm, prompt_len)
    zero_tp_counts()
    t0 = time.perf_counter()
    first = generate_tp(model, prompt, 0, dp, tp_mesh(tp=2), prompt_len)
    torch.cuda.synchronize()
    tp_secs = time.perf_counter() - t0
    counts = tp_counts()
    expect("generate_tp sampled bf16 tp 2 (A, C, G, B)", counts,
           (N_LAYERS * 2, 0, 0, 0))
    a += counts[0]
    again = generate_tp(model, prompt, 0, dp, tp_mesh(tp=2), prompt_len)
    t = first.cpu().numpy()
    if t.shape != (B, STEPS) or t.min() < 0 or t.max() >= VOCAB:
        raise AssertionError(f"bad tokens {t.shape}")
    if not torch.equal(first, again):
        raise AssertionError("sampled generate_tp differs from itself")
    t0 = time.perf_counter()
    generate(model, prompt, torch.Generator(device=DEV).manual_seed(0), dp,
             prompt_len)
    torch.cuda.synchronize()
    one_secs = time.perf_counter() - t0
    rates = {"generate": B * STEPS / one_secs,
             "generate_tp tp 2": B * STEPS / tp_secs}
    print("sampled bf16 generate_tp tp 2 twice: equal; bf16 B=8 tokens/s "
          "(host clock, prefill included, one card: no scaling): "
          + ", ".join(f"{k} {r:.1f}" for k, r in rates.items()),
          f"on {gpu_line()}")
    return {"A": a, "tok_s": rates}


def parallel_rates(shards: str) -> dict:
    """bf16 train step ms and the device's busy share (dropout 0.1, B 8,
    seq 512): unsharded, tp 2 and pp 2 (2 micro-batches) on virtual
    meshes of the card (``train_step_rate``; one card: no scaling
    claim)."""
    _, batches = train_batches(TP_RATE_STEPS, shards)
    tcfg = TrainerConfig(vocab_size=VOCAB, pad_id=VOCAB - 1,
                         d_model=D_MODEL)
    out = {}
    for label, mesh in (("unsharded", None), ("tp 2", tp_mesh(tp=2)),
                        ("pp 2", tp_mesh(pp=2))):
        tp_on = mesh is not None and mesh.model > 1
        model = tp_model(mesh if tp_on else None, torch.bfloat16,
                         dropout=0.1)
        apply = (make_pipeline_apply(model, mesh, 2)
                 if mesh is not None and mesh.pipe > 1 else None)
        tx = make_optimizer(tcfg)
        state = create_train_state(model, tx, dropout_seed=0, mesh=mesh)
        step = make_train_step(
            tx, tcfg, loss_fn=apply and train_cli.pipeline_loss_fn(
                tcfg, apply), mesh=mesh)
        out[label] = train_step_rate(f"{label} train step bf16 B{B} "
                                     f"L{L_TRAIN}", step, state, batches)
    return out


def dryrun() -> tuple:
    """``graft_entry.dryrun_multichip(4)`` on the card: launches of A, C
    and G during it."""
    zero_tp_counts()
    line = dryrun_multichip(4)
    counts = tp_counts()
    print(f"dryrun_multichip(4) launches (A, C, G, B): {counts}")
    if "decode tp=2 token-equal ok" not in line or not all(counts[:3]):
        raise AssertionError("the dry run skipped a path")
    return counts


def parallel_slice(shards: str, prime: np.ndarray) -> dict:
    """Every tensor- and pipeline-parallel phase; launches by path for the
    kernels line."""
    t0 = time.perf_counter()
    heads = check_head_shards()
    tpr = tp_paths(shards)
    ppr = pp_paths(shards)
    gen = tp_generate(prime)
    rates = parallel_rates(shards)
    dry = dryrun()
    print(f"tensor and pipeline parallel phases: "
          f"{time.perf_counter() - t0:.1f} s")
    return {"A": {**tpr["A"], **ppr["A"], "generate_tp": gen["A"],
                  "dryrun": dry[0]},
            "C": {**tpr["C"], **ppr["C"], "dryrun": dry[1]},
            "G": {**tpr["G"], "dryrun": dry[2]},
            "heads": heads, "tok_s": gen["tok_s"], "rates": rates}


# the native codecs' corpus: MAESTRO-sized piano performances and six-role
# pieces of NC_BARS bars (popmag_midi)
NC_PIANO, NC_MULTI, NC_NOTES, NC_BARS = 32, 8, (4000, 8000), 96
NC_SCHEMES = ("midilike", "midilike_control", "remi", "pedal", "melody",
              "cp", "mumidi")


def maestro_midi(path: str, seed: int) -> int:
    """A MAESTRO-sized piano performance of 4,000-8,000 notes (onsets 0-90
    ticks apart, chords included, at 384 ticks a beat: ~6-12 minutes at
    120 bpm, then two tempo changes) under a sustain pedal, written with
    the port's MIDI writer. Returns its note count."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(NC_NOTES[0], NC_NOTES[1] + 1))
    starts = 17 + np.cumsum(rng.integers(0, 90, n))
    ends = starts + rng.integers(20, 900, n)
    span = int(ends.max())
    midi = MidiFile(ticks_per_beat=384)
    midi.tempo_changes = [TempoChange(tempo=120.0, time=0)] + [
        TempoChange(tempo=float(rng.uniform(60, 140)), time=span * k // 3)
        for k in (1, 2)]
    piano = Instrument(0, False, "Piano")
    piano.notes = [Note(int(v), int(p), int(a), int(b)) for v, p, a, b in zip(
        rng.integers(15, 115, n), rng.integers(21, 109, n), starts, ends)]
    c = 100
    while c < span:
        piano.control_changes.append(ControlChange(64, 100, c))
        c += int(rng.integers(300, 1500))
        piano.control_changes.append(ControlChange(64, 0, c))
        c += int(rng.integers(50, 400))
    midi.instruments = [piano]
    midi.dump(path)
    return n


def shard_files(out: str) -> dict:
    """{file name: {stream key: array}} of a ``cli.tokenize`` directory."""
    files = {}
    for name in sorted(os.listdir(out)):
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(out, name)) as z:
            keys = [k[:-5] for k in z.files if k.endswith("_data")]
            for i, fname in enumerate(z["names"]):
                files[str(fname)] = {
                    k: z[f"{k}_data"][z[f"{k}_offsets"][i]:
                                      z[f"{k}_offsets"][i + 1]]
                    for k in keys}
    return files


def same_arrays(a, b) -> bool:
    """Equal dtype, shape and bytes (None equal only to None)."""
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def midi_content(m) -> tuple:
    """A MidiFile's tempi, instruments, notes, controls, markers and time
    signatures (its max_tick aside: the scanner counts a note-off that
    closes no note, the Python parse does not)."""
    return (m.ticks_per_beat, [(t.tempo, t.time) for t in m.tempo_changes],
            [(i.program, i.is_drum, i.name,
              [(n.pitch, n.velocity, n.start, n.end) for n in i.notes],
              [(c.number, c.value, c.time) for c in i.control_changes])
             for i in m.instruments],
            [(k.text, k.time) for k in m.markers],
            [(t.numerator, t.denominator, t.time)
             for t in m.time_signature_changes])


def tokenize_timed(midis: str, out: str, scheme: str, python: bool) -> float:
    """``cli.tokenize --workers 1`` of ``midis`` (under MG_NATIVE=0 where
    ``python``); its wall seconds."""
    old = os.environ.pop("MG_NATIVE", None)
    if python:
        os.environ["MG_NATIVE"] = "0"
    try:
        t0 = time.perf_counter()
        with quiet(out + ".log"):
            rc = tokenize_main([midis, out, "--scheme", scheme, "--workers",
                                "1"])
        secs = time.perf_counter() - t0
    finally:
        os.environ.pop("MG_NATIVE", None)
        if old is not None:
            os.environ["MG_NATIVE"] = old
    if rc != 0:
        raise AssertionError(f"cli.tokenize --scheme {scheme} failed")
    return secs


def native_direct(path: str) -> dict:
    """Every native entry point called directly on one file, by the
    cli.tokenize scheme (or codec) whose output it is."""
    data = open(path, "rb").read()
    return {"parse": native.parse_midi_bytes(data),
            "midilike": midilike.native_array(data),
            "remi": remi.native_array(data),
            "pedal": native.encode_pedal(data),
            "pedal_faithful": native.encode_pedal(data, True),
            "cp": cp.native_rows(data),
            "mumidi": native_split_arrays(path),
            "melody": melody.note_array_from_parse(path)}


def native_codecs() -> dict:
    """The native MIDI scanner and codecs (host C++ on the card's host, no
    kernel): a corpus of ``NC_PIANO`` MAESTRO-sized piano performances and
    ``NC_MULTI`` six-role pieces written with the port's MIDI writer;
    ``cli.tokenize --workers 1`` of every scheme, native and under
    MG_NATIVE=0 (files/s of each), the shards equal; every native entry
    point called directly on every file, none None, each output byte-equal
    to the port's Python path (the MG_NATIVE=0 shards, the Python parse,
    the faithful pedal codec). Returns files/s by scheme and mode."""
    t0 = time.perf_counter()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        midis = os.path.join(tmp, "midis")
        os.makedirs(midis)
        notes = [maestro_midi(os.path.join(midis, f"piano-{i:02d}.mid"), i)
                 for i in range(NC_PIANO)]
        for i in range(NC_MULTI):
            popmag_midi(os.path.join(midis, f"multi-{i:02d}.mid"), 100 + i,
                        NC_BARS)
        paths = sorted(os.path.join(midis, f) for f in os.listdir(midis))
        rates, python = {}, {}
        for scheme in NC_SCHEMES:
            out = {m: os.path.join(tmp, f"{scheme}-{m}")
                   for m in ("native", "python")}
            secs = {m: tokenize_timed(midis, out[m], scheme, m == "python")
                    for m in out}
            rates[scheme] = {m: len(paths) / s for m, s in secs.items()}
            got, python[scheme] = (shard_files(out[m]) for m in out)
            if got.keys() != python[scheme].keys() or not all(
                    same_arrays(v, python[scheme][f][k])
                    for f, d in got.items() for k, v in d.items()):
                raise AssertionError(f"cli.tokenize --scheme {scheme}: the "
                                     "native shards differ from MG_NATIVE=0")
        checked = 0
        for path in paths:
            name = os.path.basename(path)
            got = native_direct(path)
            missing = [k for k, v in got.items() if v is None]
            if missing:
                raise AssertionError(f"{name}: the native {missing} "
                                     "returned None")
            os.environ["MG_NATIVE"] = "0"
            try:
                want = {
                    "parse": midi_content(MidiFile(path)),
                    "pedal_faithful": np.asarray(pedal_midilike.encode_midi(
                        path, faithful=True), np.uint16)}
            finally:
                os.environ.pop("MG_NATIVE")
            nat = MidiFile()
            nat._build_from_native(got["parse"], open(path, "rb").read())
            ok = {"parse": midi_content(nat) == want["parse"],
                  "pedal_faithful": same_arrays(got["pedal_faithful"],
                                                want["pedal_faithful"])}
            for scheme in ("midilike", "remi", "pedal", "melody"):
                ok[scheme] = same_arrays(got[scheme],
                                         python[scheme][name]["tokens"])
            ok["cp"] = same_arrays(got["cp"].reshape(-1),
                                   python["cp"][name]["tokens"])
            mel = python["mumidi"].get(name)
            ok["mumidi"] = all(
                same_arrays(a, None if mel is None else mel[k])
                for a, k in zip(got["mumidi"], ("melody", "arrangement")))
            bad = [k for k, v in ok.items() if not v]
            if bad:
                raise AssertionError(f"{name}: native {bad} differ from the "
                                     "Python path")
            checked += len(ok)
        n_mumidi = len(python["mumidi"])
    line = ", ".join(
        f"{k} {r['native']:.1f} / {r['python']:.1f} "
        f"({r['native'] / r['python']:.1f}x)" for k, r in rates.items())
    print(f"native codecs: {NC_PIANO} piano files of {min(notes)}-"
          f"{max(notes)} notes ({sum(notes)} in all) and {NC_MULTI} six-role "
          f"files of {NC_BARS} bars ({n_mumidi} MuMIDI pairs); {checked} "
          "direct native results, none None, each byte-equal to the Python "
          f"path; {time.perf_counter() - t0:.1f} s")
    print(f"cli.tokenize --workers 1 files/s, native / Python (MG_NATIVE=0): "
          f"{line}; host {host_cpu()}", f"on {gpu_line()}")
    return rates


def timed(fn) -> float:
    """Wall seconds of ``fn()``."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def host_cpu() -> str:
    """The host CPU's model name (or its architecture where /proc/cpuinfo
    names none) and the cores this process may use."""
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), None)
    except OSError:
        model = None
    return f"{model or platform.machine()} x{len(os.sched_getaffinity(0))}"


TC_ENTRIES = {"relative_attention": ("rel_attn_fwd_tc_kernel",),
              "ring_attention": ("ring_tile_tc_kernel",),
              "relative_attention_bwd": ("rel_attn_bwd_tc_kernel",),
              "fused_gru_decode": ("gru_layer_tc_kernel",),
              "fused_decode": ("qkv_tc_kernel", "qkv_tc_kernel_int8",
                               "attn_tc_kernel", "tail_tc_kernel",
                               "tail_tc_kernel_int8")}


# bf16 entry functions held to the asynchronous-copy and spill gates only
# (kernel F's cluster body runs its GEMVs on the CUDA cores)
ASYNC_ENTRIES = {"fused_decode": ("decode_loop_cluster_kernel",)}


def entry_name(mangled: str) -> str:
    """An entry function's short name from its mangled one, "_int8" added
    for a kernel instantiated on int8 weights (template argument `a`)."""
    m = re.search(r"\d([a-z_]+_kernel)(IaE)?", mangled)
    if not m:
        return mangled
    return m.group(1) + ("_int8" if m.group(2) else "")


def ptxas_lines() -> dict:
    """Print ptxas's registers, shared memory and spills of every entry
    function built by this process; return the spill lines of each by
    (library, entry function)."""
    spills = {}
    for name, log in cuda_build.BUILD_LOGS.items():
        fn = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = re.search(r"'(\S+)'", line)
                fn = entry_name(entry.group(1)) if entry else ""
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
            if "spill" in line:
                spills.setdefault((name, fn), []).append(line)
    return spills


def tensor_core_sass() -> None:
    """Count, in each entry function of the libraries of kernels A, G, C,
    B, E, D and F, the tensor-core instructions (HMMA for mma.sync, HGMMA
    for wgmma) and the asynchronous global-to-shared copies (LDGSTS for
    cp.async, UTMALDG for TMA) in ``cuobjdump -sass`` of the built
    library. Raises if a bf16 entry function of ``TC_ENTRIES`` has no
    tensor-core instruction, if one of it or of ``ASYNC_ENTRIES`` has no
    asynchronous copy, or if ptxas spilled in one."""
    spills = ptxas_lines()
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    for lib in sorted(set(TC_ENTRIES) | set(ASYNC_ENTRIES)):
        bf16_entries = TC_ENTRIES.get(lib, ())
        sass = subprocess.run([tool, "-sass", str(cuda_build._lib_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, entry = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                entry = entry_name(m.group(1))
                counts[entry] = [0, 0]
            elif entry is not None:
                counts[entry][0] += bool(re.search(r"\bHG?MMA\b", line))
                counts[entry][1] += bool(re.search(
                    r"\b(LDGSTS|UTMALDG|UBLKCP)\b", line))
        for entry, (mma, cp) in counts.items():
            print(f"  sass {lib} {entry}: {mma} HMMA/HGMMA, {cp} "
                  f"LDGSTS/UTMALDG/UBLKCP")
        for bf16_entry in bf16_entries + ASYNC_ENTRIES.get(lib, ()):
            mma, cp = counts.get(bf16_entry, (0, 0))
            if (mma == 0 and bf16_entry in bf16_entries) or cp == 0:
                raise AssertionError(f"{bf16_entry} has {mma} tensor-core "
                                     f"instructions and {cp} asynchronous "
                                     "copies")
            spilled = [ln for ln in spills.get((lib, bf16_entry), [])
                       if re.search(r"[1-9]\d* bytes spill", ln)]
            if spilled:
                raise AssertionError(f"{bf16_entry} spills: {spilled}")


def main(argv: list) -> int:
    """Every phase; ``--loop-phases`` also builds kernel F's trace shim and
    prints its phase times (profile_loop_phases)."""
    loop_phases = "--loop-phases" in argv
    print(gpu_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    earlier = start_earlier_builds(loop_phases)
    host = {}  # the native codecs' library, built beside the kernels

    def build_host():
        try:
            host["secs"] = timed(native.build)
        except Exception as e:  # noqa: BLE001 — re-raised below
            host["error"] = e
    host_build = threading.Thread(target=build_host)
    host_build.start()
    secs = cuda_build.build()
    EARLIER_LIBS.update(finish_earlier_builds(earlier))
    host_build.join()
    if "error" in host:
        raise host["error"]
    print(f"built kernels in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{n} {s:.1f} s" for n, s in secs.items())
          + f"; native codecs ({' '.join(native.compiler())}) "
          f"{host['secs']:.1f} s")
    tensor_core_sass()

    err_a = check_kernel_a()
    err_b = check_kernel_b()
    err_br = check_kernel_b_ragged()
    err_c = check_kernel_c()
    check_kernel_c_left_pad()
    err_d = check_kernel_d()
    err_e = check_kernel_e()
    check_chunk_vs_steps()
    err_int8 = check_int8_kernels()
    check_kernel_b_rung()
    err_w = check_decode_widths()
    err_f = check_kernel_f()
    err_g = check_kernel_g()
    check_ring_pass()
    err_cp = check_cp_kernels()
    e2e = end_to_end()
    loop = loop_paths(e2e["prime"])
    served = serving(e2e["prime"])
    spec = speculative_paths(e2e["prime"])
    q_paths = int8_paths(e2e["prime"])
    q_cli = int8_cli()
    rnn = rnn_paths(e2e["prime"])
    cp_run = cp_paths()
    pm = popmag_paths()
    rt = rnn_slice_paths()
    sl = scheme_slice_paths()
    sch, dist = sl["scheme"], sl["distill"]
    native_codecs()
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as tmp:
        shards = write_corpus(tmp)
        train_parity(shards)
        tr = train_end_to_end(tmp, shards)
        step_t = time_train_step(shards)
        dpr = dp_paths(tmp, shards, e2e["prime"])
        ck = checkpoint_cli(tmp, dpr["fsdp_run"])
        par = parallel_slice(shards, e2e["prime"])
    ring_launches = ring_paths()
    ring_launches.update(par["G"])
    cp_times = time_cp_kernels()
    by_a = {"generate": e2e["A"], "train": tr["A"], "serve": served["A"],
            "speculative": spec["A"], **cp_run["A"], **sch["A"],
            **dist["A"], **dpr["A"], "checkpoint_cli": ck["A"], **par["A"]}
    heads = par["heads"]
    row_a = time_kernel_a(sum(by_a.values()),
                          max(err_a, err_cp["A"], heads["err_a"]))
    row_a["launches_by_path"] = by_a
    by_b = {"generate": e2e["B"], "serve": served["B"],
            "speculative": spec["B"], **cp_run["B"], **sch["B"],
            **dist["B"], **dpr["B"], "checkpoint_cli": ck["B"]}
    row_b = time_kernel_b(sum(by_b.values()),
                          max(err_b, err_br, err_w["B"], err_cp["B"],
                              err_cp["B_ragged"]))
    row_b["launches_by_path"] = by_b
    by_c = {"train": tr["C"], **cp_run["C"], **sch["C"], **dist["C"],
            **dpr["C"], **par["C"]}
    row_c = time_kernel_c(sum(by_c.values()),
                          max(err_c, err_cp["C"], heads["err_c"]))
    row_c["launches_by_path"] = by_c
    for h in (2, 1):  # a head shard's heads (tp 2, tp 4), training shape
        row_a[f"ms_h{h}"] = heads[h]["a_ms"]
        row_a[f"bound_ms_h{h}"] = heads[h]["a_bound_ms"]
        row_c[f"ms_h{h}"] = heads[h]["c_ms"]
        row_c[f"bound_ms_h{h}"] = heads[h]["c_bound_ms"]
    by_br = {"serve": served["B"], "cp_serve": cp_run["B"]["cp_serve"],
             "cp_window_serve": cp_run["B"]["cp_window_serve"],
             "pedal_serve": sch["B"]["pedal_serve"]}
    row_br = time_kernel_b_ragged(sum(by_br.values()),
                                  max(err_br, err_cp["B_ragged"]))
    row_br["launches_by_path"] = by_br
    for row, key in ((row_a, "A"), (row_b, "B"), (row_c, "C")):
        row.update(cp_times[key])
    by_d = {**rnn["launches"], **pm["launches"], **rt["train"]["launches"],
            **dpr["D"], **sl["gru"]["launches"]}
    row_d = time_kernel_d(sum(by_d.values()), err_d)
    row_d["launches_by_path"] = by_d
    # PoPMAG's decoder step, and the GRU families' REMI and pedal widths
    row_d.update(time_kernel_d_shape("popmag", PM_HIDDEN, PM_HIDDEN,
                                     PM_LAYERS, 37))
    for in_dim in GS_WIDTHS.values():
        row_d.update(time_kernel_d_shape(f"in{in_dim}", in_dim, RNN_HIDDEN,
                                         RNN_LAYERS, 41))
    row_e = time_kernel_e(spec["E"] + dist["E"], max(err_e, err_w["E"]))
    row_e["launches_by_path"] = {f"speculative_{k}": r["E"]
                                 for k, r in spec["runs"].items()}
    row_e["launches_by_path"]["distill_spec"] = dist["E"]
    by_f = {**loop["by_path"], **sch["F"]}
    row_f = time_kernel_f(sum(by_f.values()), by_f, max(err_f, sch["f_err"]))
    for v, times in sch["f_times"].items():
        row_f.update({f"{k}_v{v}": x for k, x in times.items()})
    q_by_path = {
        "B": {"cli_generate": q_cli["generate"]["B_int8"],
              "generate_parity": q_paths["generate"],
              "cp_cli_generate": cp_run["B_int8"]},
        "B_ragged": {"serve_parity": q_paths["serve"]},
        "E": {"cli_spec_lookup": q_cli["spec_lookup"]["E_int8"],
              "speculative_parity": q_paths["speculative"]}}
    err_int8 = dict(err_int8, B=max(err_int8["B"], err_cp["B_int8"]))
    q_rows = time_int8(err_int8, {k: sum(v.values())
                                  for k, v in q_by_path.items()})
    for r, k in zip(q_rows, ("B", "B_ragged", "E")):
        r["launches_by_path"] = q_by_path[k]
    q_rates = int8_rates()
    row_g = time_kernel_g(sum(ring_launches.values()), ring_launches, err_g)
    ring_step = time_ring_step()
    profile_kernel_b_call()
    # kernel B's step at time_kernel_b's t and at an earlier one, both
    # bodies (the earlier body's tail slows as t grows: PERF.md section 7)
    for earlier in (True, False):
        profile_decode(earlier=earlier)
        profile_decode(prompt_len=T_TIMED - 3, earlier=earlier)
    for d, q in ((D_MODEL, "int8"), (D_RUNG, "none"), (D_RUNG, "int8")):
        profile_decode(d_model=d, quant=q)
    loop_prof = profile_loop(e2e["prime"])
    if loop_phases:
        row_f["us_per_step_by_phase"] = profile_loop_phases()["us_per_step"]
    profile_serving()
    profile_rnn_decode()
    profile_spec(e2e["prime"], draft=False)
    profile_spec(e2e["prime"], draft=True)
    rows = [row_a, row_b, row_c, row_br, row_d, row_e, row_f] + q_rows \
        + [row_g]
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"{r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
              f" bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{lib} ms, launches {r['launches']}", f"on {gpu_line()}")
    print(f"end to end: prefill {e2e['prefill_ms']:.3f} ms, decode "
          f"{e2e['tok_s']:.1f} tokens/s; train step {step_t['step_ms']:.3f} "
          f"ms ({step_t['tok_s']:.0f} tokens/s)", f"on {gpu_line()}")
    print(f"CP transformer bf16 B={B}: prefill ({CP_MAX_SEQ - CP_STEPS} rows) "
          f"{cp_run['prefill_ms']:.3f} ms, decode {cp_run['rows_s']:.1f} "
          f"rows/s ({100 * cp_run['decode_busy']:.1f}% busy); serving "
          f"goodput {cp_run['goodput']:.1f} rows/s; train step (L {L_TRAIN}) "
          f"{cp_run['step_ms']:.3f} ms ({100 * cp_run['train_busy']:.1f}% "
          "busy)", f"on {gpu_line()}")
    for family in ("event_rnn", "performance_rnn"):
        print(f"{family}: decode {rnn['tok_s'][family]:.1f} tokens/s (B={B}, "
              f"bf16); serving: {rnn['serve'][family]}", f"on {gpu_line()}")
    print(f"PoPMAG generate_arrangement B={B}, sampled: " + ", ".join(
        f"{k} {v:.2f} arranged bars/s ({v * PM_STEPS / B:.1f} decoder "
        "steps/s)" for k, v in pm["bars_s"].items())
        + f"; train step f32 {pm['step_ms']:.3f} ms ("
        f"{100 * pm['train_busy']:.1f}% busy); serving: {pm['serve']}",
        f"on {gpu_line()}")
    mel = rt["melody"]
    print(f"RNN training f32 B={B}: EventMelodyRNN window step "
          f"{rt['train']['step_ms']:.3f} ms "
          f"({100 * rt['train']['train_busy']:.1f}% busy); MelodyRNN (attn "
          f"40) step {mel['step_ms']:.3f} ms ({100 * mel['train_busy']:.1f}% "
          "busy); MelodyRNN decode B=8 f32: " + ", ".join(
              f"{k} {v:.1f} tokens/s" for k, v in mel["tok_s"].items())
          + f"; MelodyRNN serving: {mel['serve']}", f"on {gpu_line()}")
    print("speculative B=1 bf16 greedy, tokens/s (median): " + ", ".join(
        f"{k} {r['tok_s']:.1f}" for k, r in spec["rates"].items()),
        f"on {gpu_line()}")
    print("decode B=8 bf16 sampled, int8 / unquantized tokens/s (median): "
          + ", ".join(f"d {d} {r['int8']:.1f} / {r['none']:.1f}"
                      for d, r in q_rates.items()), f"on {gpu_line()}")
    print(f"decode loop B={B} bf16 sampled, tokens/s (median): step path "
          f"{loop['tok_s']['step']:.1f}, loop path {loop['tok_s']['loop']:.1f}"
          f"; under the profiler {loop_prof['busy_share'] * 100:.1f}% busy; "
          "chi2 " + ", ".join(f"{k} {v:.2f}" for k, v in loop["chi2"].items()),
          f"on {gpu_line()}")
    for scheme, r in sch["rates"].items():
        print(f"MusicTransformer {scheme} (vocab {SCHEME_VOCAB[scheme]}) "
              f"bf16 B={B}: train step {r['step_ms']:.3f} ms "
              f"({100 * r['train_busy']:.1f}% busy), eval step "
              f"{r['eval_tok_s']:.0f} tokens/s, decode {r['decode_tok_s']:.1f} "
              "tokens/s", f"on {gpu_line()}")
    print(f"pedal serving goodput {sch['goodput']:.1f} tok/s; distill step "
          f"bf16 {dist['step_ms']:.3f} ms ({100 * dist['busy']:.1f}% busy); "
          f"--spec <distilled draft> mean accepted {dist['mean_accepted']:.2f}"
          f"/{SPEC_CHUNK - 1}; CP window serving {cp_run['window_rows_s']:.1f} "
          f"rows/s (f32); kernel F bf16 B={B}: " + ", ".join(
              f"V {v} {t['ms']:.4f} ms" for v, t in sch["f_times"].items()),
          f"on {gpu_line()}")
    print("data parallel on one card (virtual meshes, no scaling claim): "
          "generate_dp bf16 B=8 tokens/s " + ", ".join(
              f"dp {n} {r:.1f}" for n, r in dpr["tok_s"].items())
          + f"; train step bf16 under FSDP2 (one rank) "
          f"{dpr['fsdp_ms']['fsdp']:.3f} ms ({100 * dpr['fsdp_ms']['busy']:.1f}"
          f"% busy), unsharded {dpr['fsdp_ms']['plain']:.3f} ms",
          f"on {gpu_line()}")
    print("tensor and pipeline parallel on one card (virtual meshes, no "
          "scaling claim): train step bf16 B=8 L=512 " + ", ".join(
              f"{k} {ms:.3f} ms ({100 * busy:.1f}% busy)"
              for k, (ms, busy) in par["rates"].items())
          + "; decode bf16 B=8 tokens/s " + ", ".join(
              f"{k} {r:.1f}" for k, r in par["tok_s"].items()),
          f"on {gpu_line()}")
    print(f"ring train step bf16 B={B} L={L_RING} (host clock, median): "
          f"virtual ring sp {SP_RING} {ring_step['ring_pallas']:.2f} ms "
          f"through kernel G, {ring_step['ring']:.2f} ms plain, "
          f"single device {ring_step['auto']:.2f} ms (one card, no claim)",
          f"on {gpu_line()}")
    print(gpu_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
