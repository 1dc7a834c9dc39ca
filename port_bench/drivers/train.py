"""The training driver: the step ``cli.train`` runs, timed over a window.

Set-up writes a seeded synthetic token corpus in ``cli.tokenize``'s
shard format under the run's temporary directory, builds the model as
``cli.train`` builds it (``build_model``: dense crops, no pad masking),
fills its weights from the seed on the card, and feeds the step
(``make_train_step``) from ``cli.train``'s LM batch stream through its
prefetch thread. The step's first ``check_steps`` calls run in set-up
on the stream's first batches and are the ones compared; the same state
and stream then run the window. Each step reads its loss to the host,
so a step's host time holds its device time.

After the window the plain reference (``reference/music_transformer.py``)
re-derives the same crops from the corpus file and the same dropout
masks from the seed and runs the same steps from the same weights. The
numbers compared, each the worst case:

* ``loss``: each step's loss, |program - reference| / reference;
* ``grad``: the first gradient as the optimizer got it (Adam's first
  moment after one step over 1 - b1), per leaf |norm_p - norm_r| /
  max(norm_r, the median leaf's norm_r);
* ``change``: each leaf's change over the steps, measured the same way,
  leaves whose reference gradient is under 1e-3 of the median leaf's
  left out (Adam moves them by rounding alone).
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from port_bench.lib import traffic, weights
from port_bench.lib.trace import DeviceTrace
from port_bench.reference import music_transformer as ref
from port_bench.reference.precision import Arith, no_tf32

KERNELS = ("relative_attention", "relative_attention_bwd")
# the trainer's Adam (optax's defaults with the reference's b2, train.py:143)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.98, 1e-9


def write_corpus(root: str, corpus: dict, seed: int, vocab: int) -> None:
    """``corpus["pieces"]`` token files of stratified lengths in
    [lo, hi], ids uniform below ``vocab - 1`` (the pad id is never
    drawn), as one ``cli.tokenize`` shard and its manifest."""
    rng = traffic.rng_for(seed, 3)
    lens = traffic.stratified(corpus["length"], int(corpus["pieces"]), rng)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = rng.integers(0, vocab - 1, int(offsets[-1])).astype(np.uint16)
    names = np.asarray([f"piece{i:04d}.mid" for i in range(len(lens))])
    np.savez(os.path.join(root, "midilike-00000"), names=names,
             tokens_data=data, tokens_offsets=offsets)
    with open(os.path.join(root, "manifest.json"), "w") as f:
        json.dump({"scheme": "midilike", "n_files": len(lens),
                   "n_ok": len(lens), "n_failed": 0,
                   "n_tokens": int(offsets[-1]),
                   "shards": ["midilike-00000.npz"]}, f)


def read_corpus(root: str):
    z = np.load(os.path.join(root, "midilike-00000.npz"))
    off, data = z["tokens_offsets"], z["tokens_data"]
    return [data[off[i]:off[i + 1]].astype(np.int64)
            for i in range(len(off) - 1)]


def train_config(run):
    cfg, t = run.config, run.cell["traffic"]
    return {"adam_b1": ADAM_B1, "adam_b2": ADAM_B2, "adam_eps": ADAM_EPS,
            "dropout_rate": cfg["dropout_rate"],
            "label_smoothing": cfg["label_smoothing"],
            "warmup_steps": cfg["warmup_steps"],
            "max_grad_norm": cfg["max_grad_norm"],
            "rows": int(t["batch_rows"]), "seq_len": int(t["seq_len"])}


def cli_config(run, ranks: int = 1):
    """``cli.train``'s config of the cell: the global batch of every data
    rank, the stream's seed from the run's seed."""
    from musicgeneration_tpu_torch.cli import train as cli
    tc = train_config(run)
    return cli.TrainCLIConfig(
        batch_size=tc["rows"] * ranks, seq_len=tc["seq_len"],
        accum_steps=int(run.cell["traffic"]["accum_steps"]),
        label_smoothing=tc["label_smoothing"],
        warmup_steps=tc["warmup_steps"], max_grad_norm=tc["max_grad_norm"],
        seed=weights.seed_word(run.seed, 11) & 0x7FFFFFFF,
        dp=ranks if ranks > 1 else None)


def make_model(run, ccfg, mesh=None):
    """(model, trainer config, loss_fn, reference weights): the model
    ``cli.train`` builds, its weights filled from the seed."""
    from musicgeneration_tpu_torch.cli import train as cli
    cfg = run.config
    kw = {"vocab_size": cfg["vocab_size"], "num_layers": cfg["num_layers"],
          "d_model": cfg["d_model"], "head_dim": cfg["head_dim"],
          "ffn_dim": cfg["ffn_dim"], "dropout_rate": cfg["dropout_rate"],
          "dtype": cfg["compute_dtype"]}
    model, tcfg, loss_fn = cli.build_model(ccfg, "midilike", kw, run.device,
                                           mesh)
    p0 = weights.fill(model, run.seed, weights.RULES[cfg["init"]])
    return model, tcfg, loss_fn, p0


def build(run, data_dir: str, ccfg=None, mesh=None):
    """(state, step, stream, reference weights) as ``cli.train`` makes
    them (on ``mesh``'s device and rows where given), the weights from
    the seed."""
    from musicgeneration_tpu_torch.cli import train as cli
    from musicgeneration_tpu_torch.data.pipeline import TokenCorpus
    from musicgeneration_tpu_torch.data.prefetch import prefetch_to_device
    from musicgeneration_tpu_torch.train.trainer import (
        create_train_state, make_optimizer, make_train_step)

    ccfg = ccfg or cli_config(run)
    model, tcfg, loss_fn, p0 = make_model(run, ccfg, mesh)
    tx = make_optimizer(tcfg)
    state = create_train_state(model, tx, dropout_seed=ccfg.seed, mesh=mesh)
    step = make_train_step(tx, tcfg, loss_fn=loss_fn, mesh=mesh)
    corpus = TokenCorpus(data_dir, limlen=cli._limlen(ccfg))
    batch_at = cli._mesh_shard(cli._lm_batch_fn(corpus, ccfg), mesh, ccfg)
    stream = prefetch_to_device(cli._indexed_stream(batch_at, 0), size=2,
                                device=run.device)
    return state, step, stream, p0, ccfg


def check_steps(state, step, stream, n: int):
    """The step's first ``n`` calls, on the stream's first batches: each
    loss, Adam's first moments after the first, every leaf after the
    last (before a later step moves it)."""
    losses, first_mu = [], None
    for i in range(n):
        x, y = next(stream)
        state, m = step(state, x, y)
        losses.append(m["loss"])
        if i == 0:
            first_mu = [mu.detach().clone() for mu in state.opt_state.mu]
    after = [p.detach().clone() for p in state.model.parameters()]
    return losses, first_mu, after


def program_numbers(names, losses, first_mu, after, p0) -> dict:
    """The program's numbers in the form ``readings`` compares: the
    losses, each leaf's first gradient norm (Adam's first moment after
    one step over 1 - b1) and its change."""
    return {"losses": losses,
            "grad": {n: float(torch.linalg.vector_norm(mu)) / (1 - ADAM_B1)
                     for n, mu in zip(names, first_mu)},
            "change": {n: float(torch.linalg.vector_norm(a - p0[n]))
                       for n, a in zip(names, after)}}


def timed_steps(run, state, step, stream, tracer, go=None) -> int:
    """Steps from the stream until the window's seconds have passed (or
    ``go(now_ns, end_ns)`` says stop), with the spans of each batch wait
    and step; the window opens before the first and closes after the
    last. Returns the steps run."""
    steps = 0
    run.open_window(tracer)
    end = run.window_lo_ns + int(run.seconds * 1e9)
    now = run.window_lo_ns
    while True:
        a = time.perf_counter_ns()
        if go is None:
            if now >= end:
                break
        elif not go(now, end):
            break
        else:
            run.spans.add("train.window_flag", a, time.perf_counter_ns())
            a = time.perf_counter_ns()
        x, y = next(stream)
        b = time.perf_counter_ns()
        state, _ = step(state, x, y)
        now = time.perf_counter_ns()
        run.spans.add("data.next_batch", a, b)
        run.spans.add("train.step", b, now)
        steps += 1
    run.close_window(tracer)
    return steps


def run(run) -> None:
    t = run.cell["traffic"]
    n_check = int(t["check_steps"])
    with run.phase("setup.kernels"):
        if run.device.type == "cuda":
            from musicgeneration_tpu_torch.ops import cuda_build
            cuda_build.build(KERNELS)
    tmp = tempfile.mkdtemp(prefix="port_bench_corpus_")
    try:
        with run.phase("setup.corpus"):
            write_corpus(tmp, t["corpus"], run.seed,
                         run.config["vocab_size"])
        with run.phase("setup.model"):
            state, step, stream, p0, ccfg = build(run, tmp)
        names = [n for n, _ in state.model.named_parameters()]
        with run.phase("setup.check_steps"):
            losses, first_mu, after = check_steps(state, step, stream,
                                                  n_check)
        prog = program_numbers(names, losses, first_mu, after, p0)
        del first_mu, after
        if run.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        run.set_up_done()
        steps = timed_steps(run, state, step, stream, DeviceTrace(run.device))
        tokens = steps * int(t["batch_rows"]) * int(t["seq_len"])
        run.e2e["train_tokens_per_s"] = tokens / run.window_s
        run.counters.update(steps=steps, tokens=tokens)
        run.attempted, run.failed = steps, 0
        stream.close()
        del state, step, stream
        seqs = read_corpus(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    compare(run, prog, p0, seqs, ccfg.seed, n_check)


def reference_steps(run, p0, seqs, data_seed: int, n: int,
                    arith: str = "f32", rows=None, whole_count=False):
    """The reference's first ``n`` steps on the crops and dropout masks
    the program's stream and step drew: the global batch of every data
    rank (the cell's ``chips``), each rank's rows under its own masks."""
    cfg, tc = run.config, train_config(run)
    ranks = int(run.cell["chips"])
    batches = []
    for i in range(n):
        x, y = ref.crop_batch(seqs, data_seed, i, tc["rows"] * ranks,
                              tc["seq_len"])
        batches.append((torch.as_tensor(x, device=run.device),
                        torch.as_tensor(y, device=run.device)))
    sites = 1 + 2 * cfg["num_layers"]
    shape = (tc["rows"], tc["seq_len"], cfg["d_model"])

    def masks_of(step):
        per = [ref.dropout_masks(data_seed, step, shape, sites,
                                 tc["dropout_rate"], run.device, rank=r)
               for r in range(ranks)]
        return [torch.cat(m) for m in zip(*per)]

    with no_tf32():
        return ref.train_steps(p0, batches, cfg, tc, masks_of, Arith(arith),
                               block_rows=int(cfg["reference_rows"]),
                               rows=rows, whole_count=whole_count)


def readings(prog, refr, p0) -> dict:
    """The three numbers compared (module docstring)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    refr["losses"]))
    g_ref = {n: float(torch.linalg.vector_norm(g))
             for n, g in refr["first_grad"].items()}
    c_ref = {n: float(torch.linalg.vector_norm(refr["params"][n] - p0[n]))
             for n in p0}
    g_med = float(np.median(list(g_ref.values())))
    c_med = float(np.median(list(c_ref.values())))
    grad = max(abs(prog["grad"][n] - g_ref[n]) / max(g_ref[n], g_med)
               for n in g_ref)
    moved = [n for n in c_ref if g_ref[n] >= 1e-3 * g_med]
    change = max(abs(prog["change"][n] - c_ref[n]) / max(c_ref[n], c_med)
                 for n in moved)
    return {"loss": loss, "grad": grad, "change": change}


def as_program(refr, p0) -> dict:
    """A reference run's numbers in the form the program's take (for the
    control and for faults planted in the reference)."""
    return {"losses": refr["losses"],
            "grad": {n: float(torch.linalg.vector_norm(g))
                     for n, g in refr["first_grad"].items()},
            "change": {n: float(torch.linalg.vector_norm(refr["params"][n]
                                                         - p0[n]))
                       for n in p0}}


def compare(run, prog, p0, seqs, data_seed: int, n: int) -> None:
    """The program's numbers against the reference's; with the run's
    ``controls`` option also the control's (``fp8``) and planted faults'
    (``half_batch``: the mean over every other row; ``no_exchange``: a
    data rank's own rows over the global count, as without the
    all-reduce) readings, as counters."""
    refr = reference_steps(run, p0, seqs, data_seed, n)
    got = readings(prog, refr, p0)
    for k, limit in run.cell["limits"].items():
        run.check(k, got[k], limit)
    run.counters["readings"] = got
    rows = train_config(run)["rows"]
    for kind in run.options.get("controls", ()):
        if kind == "fp8":
            other = reference_steps(run, p0, seqs, data_seed, n, "fp8")
        elif kind == "half_batch":
            other = reference_steps(run, p0, seqs, data_seed, n,
                                    rows=torch.arange(0, rows, 2))
        elif kind == "no_exchange":
            other = reference_steps(run, p0, seqs, data_seed, n,
                                    rows=torch.arange(rows),
                                    whole_count=True)
        else:
            raise ValueError(f"unknown control {kind!r}")
        run.counters[f"control.{kind}"] = readings(as_program(other, p0),
                                                   refr, p0)
