"""The open-loop serving driver: MusicTransformer continuations through
``decode/serving.py::ContinuousBatcher``, driven as ``cli.serve``'s
streaming modes drive it (per-row sampling on, ``warm()``, then submit
what is due and ``step()``).

Requests arrive at the cell's fixed rate (``lib/traffic.open_loop``);
each is timed from the moment it was due to the moment the harness
receives its tokens (``on_finalize``). After the window the loop drains
the window's requests, a minute at the most. The served tokens of a
sample of the greedy requests, drawn from the seed with the longest
among them, are compared with the plain reference
(``reference/music_transformer.py``): ``gap`` is the widest margin by
which a served token's reference logit lies below the reference's best
at its position.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.lib import traffic, weights
from port_bench.lib.compare import p95, sample_with_longest, served_gap
from port_bench.lib.trace import DeviceTrace
from port_bench.reference import music_transformer as ref
from port_bench.reference.precision import Arith, no_tf32

KERNELS = ("relative_attention", "fused_decode")
DRAIN_S = 60.0


class Engine:
    """The model, its batcher and what the harness records of it."""

    def __init__(self, run):
        from musicgeneration_tpu_torch.decode.sampling import SamplingParams
        from musicgeneration_tpu_torch.decode.serving import ContinuousBatcher
        from musicgeneration_tpu_torch.models.music_transformer import (
            MusicTransformer)

        cfg, e = run.config, run.cell["engine"]
        dtype = getattr(torch, cfg["compute_dtype"])
        self.model = MusicTransformer(
            vocab_size=cfg["vocab_size"], num_layers=cfg["num_layers"],
            d_model=cfg["d_model"], max_seq=cfg["max_seq"],
            head_dim=cfg["head_dim"], ffn_dim=cfg["ffn_dim"], dtype=dtype,
            device=run.device)
        self.p0 = weights.fill(self.model, run.seed,
                               weights.RULES[cfg["init"]])
        self.sampled = SamplingParams(temperature=float(e["temperature"]),
                                      top_k=int(e["top_k"]))
        self.greedy = SamplingParams(greedy=True)
        self.done_ns: Dict[int, int] = {}
        self.out: Dict[int, np.ndarray] = {}
        gen = weights.device_generator(run.device, run.seed, 5)
        self.cb = ContinuousBatcher(
            self.model, slots=int(e["slots"]), sampling=self.sampled,
            seg_len=int(e["seg_len"]), depth=int(e["depth"]),
            per_row_sampling=True, boost=int(e["boost"]),
            on_finalize=self._deliver, generator=gen)

    def _deliver(self, rid: int, toks: np.ndarray) -> None:
        self.done_ns[rid] = time.perf_counter_ns()
        self.out[rid] = toks

    def submit(self, prompt: np.ndarray, max_new: int, greedy: bool) -> int:
        return self.cb.submit(prompt, max_new,
                              sampling=self.greedy if greedy else self.sampled)

    def busy(self) -> bool:
        return bool(self.cb.pending) or any(s.active for s in self.cb.slots)

    def warm(self, t: Dict, vocab: int, rng) -> None:
        """The probe ``cli.serve`` runs, then one request of each prompt
        bucket the mix can send, drained."""
        self.cb.warm()
        lo, hi = t["prompt_len"]["lo"], t["prompt_len"]["hi"]
        bucket = self.cb.prompt_bucket
        for p in range(lo, hi + bucket, bucket):
            p = min(p, hi)
            self.submit(traffic.tokens(rng, p, vocab - 1), self.cb.seg_len,
                        True)
        while self.busy():
            self.cb.step()
        self.cb.done.clear()
        self.done_ns.clear()
        self.out.clear()


def with_prompts(run, reqs: List[Dict]) -> List[Dict]:
    """Each request's primer ids (never the pad id), from the seed."""
    vocab = run.config["vocab_size"]
    rng = traffic.rng_for(run.seed, 4)
    for r in reqs:
        r["prompt"] = traffic.tokens(rng, r["prompt_len"], vocab - 1)
    return reqs


def window(run, eng: Engine, reqs: List[Dict], tracer=None) -> Dict:
    """Serve ``reqs`` (each with its ``due`` offset and ``prompt``) open
    loop from now, then drain. Records spans; returns the per-request
    times and the scheduler's counters over the window."""
    st0 = eng.cb.stats()
    if tracer is not None:
        run.open_window(tracer)
        lo = run.window_lo_ns
    else:
        lo = time.perf_counter_ns()
    due = [lo + int(r["due"] * 1e9) for r in reqs]
    close = lo + int(run.seconds * 1e9)
    rid_of, sub_ns = [], []
    i, n = 0, len(reqs)
    step_ns, pending_at_close = 0, None
    spans = run.spans
    while True:
        now = time.perf_counter_ns()
        if i < n and due[i] <= now:
            a = now
            while i < n and due[i] <= now:
                r = reqs[i]
                sub_ns.append(time.perf_counter_ns())
                rid_of.append(eng.submit(r["prompt"], r["max_new"],
                                         r["greedy"]))
                i += 1
            spans.add("serve.submit", a, time.perf_counter_ns())
        if pending_at_close is None and now >= close:
            pending_at_close = len(eng.cb.pending)
        if eng.busy():
            a = time.perf_counter_ns()
            eng.cb.step()
            b = time.perf_counter_ns()
            spans.add("serve.step", a, b)
            step_ns += b - a
            eng.cb.done.clear()
        elif i < n:
            a = time.perf_counter_ns()
            time.sleep(max(0.0, (due[i] - a) / 1e9))
            spans.add("generator.idle", a, time.perf_counter_ns())
        else:
            break
        if now > close + DRAIN_S * 1e9:
            break
    if tracer is not None:
        run.close_window(tracer)
    st1 = eng.cb.stats()
    lat, wait, lag, failed, ok = [], [], [], 0, []
    for k, r in enumerate(reqs[:len(rid_of)]):
        rid = rid_of[k]
        lag.append((sub_ns[k] - due[k]) / 1e6)
        t_admit = eng.cb.times.get(rid, {}).get("admit")
        if t_admit is not None:
            wait.append(t_admit * 1e3 - due[k] / 1e6)
        toks = eng.out.get(rid)
        if toks is None or len(toks) != r["max_new"]:
            failed += 1
            lat.append(math.inf)
            continue
        lat.append((eng.done_ns[rid] - due[k]) / 1e6)
        ok.append(k)
    failed += n - len(rid_of)
    lat += [math.inf] * (n - len(rid_of))
    return {"latency_ms": lat, "queue_wait_ms": wait, "lag_ms": lag,
            "failed": failed, "ok": ok, "rids": rid_of,
            "steps": st1["steps"] - st0["steps"], "step_s": step_ns / 1e9,
            "pending_at_close": pending_at_close or 0}


def run(run) -> None:
    t = run.cell["traffic"]
    with run.phase("setup.kernels"):
        if run.device.type == "cuda":
            from musicgeneration_tpu_torch.ops import cuda_build
            cuda_build.build(KERNELS)
    with run.phase("setup.model"):
        eng = Engine(run)
    with run.phase("setup.warm"):
        eng.warm(t, run.config["vocab_size"], traffic.rng_for(run.seed, 6))
    rate = run.options.get("rate", t["rate_per_s"])
    reqs = with_prompts(run, traffic.open_loop(t, run.seed, run.seconds,
                                               rate))
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.set_up_done()
    res = window(run, eng, reqs, DeviceTrace(run.device))
    run.e2e["serve_e2e_p95_ms"] = p95(res["latency_ms"])
    run.attempted, run.failed = len(reqs), res["failed"]
    run.counters.update(
        queue_wait_ms=res["queue_wait_ms"], lag_ms=res["lag_ms"],
        steps=res["steps"], step_s=res["step_s"],
        pending_at_close=res["pending_at_close"])
    p0, outs = eng.p0, eng.out
    del eng
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    check(run, p0, outs, reqs, res)


def check(run, p0, outs, reqs, res) -> None:
    """The served tokens of the sample against the reference."""
    greedy = [i for i in res["ok"] if reqs[i]["greedy"]]
    idx = sample_with_longest(
        greedy, lambda i: reqs[i]["prompt_len"] + reqs[i]["max_new"],
        int(run.cell["check"]["requests"]), run.seed)
    seqs = [np.concatenate([reqs[i]["prompt"], outs[res["rids"][i]]])
            for i in idx]
    plens = [reqs[i]["prompt_len"] for i in idx]
    cfg = run.config
    run.counters["checked_tokens"] = int(sum(len(s) - p for s, p in
                                             zip(seqs, plens)))
    if not seqs:
        return  # nothing to compare: no check, so not correct
    with no_tf32():
        lg = ref.served_logits(p0, seqs, cfg, Arith("f32"), run.device)
        run.check("gap", served_gap(lg, seqs, plens), run.cell["limits"]["gap"])
        if "fp8" in run.options.get("controls", ()):
            lc = ref.served_logits(p0, seqs, cfg, Arith("fp8"), run.device)
            run.counters["control.fp8"] = {"gap": served_gap(lg, seqs, plens, lc)}
