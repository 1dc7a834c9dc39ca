"""The backlog serving driver: PerformanceRNN batch generation through
``decode/serving_rnn.py::RNNContinuousBatcher``, driven as ``cli.serve``'s
streaming modes drive it (per-row sampling on, ``warm()``, then submit
and ``step()``), with the queue never empty: before every ``step()``
the harness tops the pending queue up to ``pending`` requests.

Every request carries a constant control (a 12-bin pitch histogram and
a one-hot note-density class) and an init latent, both from the seed.
Goodput is the tokens delivered to callers within the window over its
length. The served tokens of a sample of the greedy requests finished in
the window, drawn from the seed with the longest among them, are
compared with the plain reference (``reference/performance_rnn.py``):
``gap`` is the widest margin by which a served token's reference logit
lies below the reference's best at its position.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from port_bench.lib import traffic, weights
from port_bench.lib.compare import sample_with_longest, served_gap
from port_bench.lib.trace import DeviceTrace
from port_bench.reference import performance_rnn as ref
from port_bench.reference.precision import Arith, no_tf32

KERNELS = ("fused_gru_decode",)


class Requests:
    """The endless request stream of the mix: prompt (the primary event
    then random events), max_new, greedy, control and init latent."""

    def __init__(self, run):
        cfg = run.config
        self.t = run.cell["traffic"]
        self.it = traffic.backlog(self.t, run.seed)
        self.rng = traffic.rng_for(run.seed, 9)
        self.ev = cfg["event_dim"]
        self.ctrl_dim, self.init_dim = cfg["control_dim"], cfg["init_dim"]

    def next(self) -> Dict:
        r = next(self.it)
        rng = self.rng
        prompt = np.concatenate([[self.ev - 1], traffic.tokens(
            rng, r["prompt_len"] - 1, self.ev - 1)]).astype(np.int64)
        bins = self.ctrl_dim // 2
        hist = rng.dirichlet(np.ones(bins))
        density = np.zeros(self.ctrl_dim - bins)
        density[rng.integers(len(density))] = 1.0
        r.update(prompt=prompt,
                 control=np.concatenate([hist, density]).astype(np.float32),
                 init=rng.standard_normal(self.init_dim).astype(np.float32))
        return r


class Engine:
    def __init__(self, run):
        from musicgeneration_tpu_torch.decode.sampling import SamplingParams
        from musicgeneration_tpu_torch.decode.serving_rnn import (
            RNNContinuousBatcher)
        from musicgeneration_tpu_torch.models.performance_rnn import (
            PerformanceRNN)

        cfg, e = run.config, run.cell["engine"]
        self.model = PerformanceRNN(
            event_dim=cfg["event_dim"], control_dim=cfg["control_dim"],
            init_dim=cfg["init_dim"], hidden_dim=cfg["hidden_dim"],
            num_layers=cfg["num_layers"],
            dtype=getattr(torch, cfg["compute_dtype"]), device=run.device)
        self.p0 = weights.fill(self.model, run.seed,
                               weights.RULES[cfg["init"]])
        self.sampled = SamplingParams(temperature=float(e["temperature"]),
                                      top_k=int(e["top_k"]))
        self.greedy = SamplingParams(greedy=True)
        self.done_ns: Dict[int, int] = {}
        self.out: Dict[int, np.ndarray] = {}
        self.cb = RNNContinuousBatcher(
            self.model, slots=int(e["slots"]), sampling=self.sampled,
            seg_len=int(e["seg_len"]), depth=int(e["depth"]),
            ctrl_window=int(e["ctrl_window"]), boost=int(e["boost"]),
            per_row_sampling=True, on_finalize=self._deliver,
            generator=weights.device_generator(run.device, run.seed, 5))

    def _deliver(self, rid: int, toks: np.ndarray) -> None:
        self.done_ns[rid] = time.perf_counter_ns()
        self.out[rid] = toks

    def submit(self, r: Dict) -> int:
        return self.cb.submit(r["prompt"], r["max_new"],
                              sampling=self.greedy if r["greedy"]
                              else self.sampled,
                              control=r["control"], init=r["init"])

    def drain(self) -> None:
        while bool(self.cb.pending) or any(s.active for s in self.cb.slots):
            self.cb.step()
        self.cb.done.clear()
        self.done_ns.clear()
        self.out.clear()


def admission_groups(plens: List[int], bucket: int) -> List[tuple]:
    """(width, steps) of the prefills that admit requests of prompt
    lengths ``plens`` together: one group a prompt bucket, max(p) - 1
    steps of it (``RNNContinuousBatcher._admit_group``)."""
    by: Dict[int, List[int]] = {}
    for p in plens:
        by.setdefault(max(bucket, -(-p // bucket) * bucket), []).append(p)
    return [(len(ps), max(ps) - 1) for ps in by.values() if max(ps) > 1]


def run(run) -> None:
    t, e = run.cell["traffic"], run.cell["engine"]
    pending = int(t["pending"])
    with run.phase("setup.kernels"):
        if run.device.type == "cuda":
            from musicgeneration_tpu_torch.ops import cuda_build
            cuda_build.build(KERNELS)
    with run.phase("setup.model"):
        eng = Engine(run)
    with run.phase("setup.warm"):
        eng.cb.warm()
        # one pool-wide segment and admissions of both prompt buckets
        warm = Requests(run)
        for _ in range(int(e["slots"])):
            r = warm.next()
            r["max_new"] = int(e["seg_len"])
            eng.submit(r)
        eng.drain()
    reqs = Requests(run)
    backlog: List[Dict] = [reqs.next() for _ in range(pending)]
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.set_up_done()

    tracer = DeviceTrace(run.device)
    st0 = eng.cb.stats()
    sent: Dict[int, Dict] = {}
    run.open_window(tracer)
    lo = run.window_lo_ns
    end = lo + int(run.seconds * 1e9)
    step_ns, now = 0, lo
    queued = collections.deque()       # submitted, not yet admitted
    groups = []                        # (width, steps) of each admission
    admitted = st0["admitted"]
    while now < end:
        a = time.perf_counter_ns()
        while len(eng.cb.pending) < pending:
            r = backlog.pop() if backlog else reqs.next()
            rid = eng.submit(r)
            sent[rid] = r
            queued.append(rid)
        b = time.perf_counter_ns()
        eng.cb.step()
        eng.cb.done.clear()
        now = time.perf_counter_ns()
        run.spans.add("serve.submit", a, b)
        run.spans.add("serve.step", b, now)
        step_ns += now - b
        n_adm = eng.cb.stats()["admitted"] - admitted
        admitted += n_adm
        groups += admission_groups(
            [len(sent[queued.popleft()]["prompt"]) for _ in range(n_adm)],
            eng.cb.prompt_bucket)
    run.close_window(tracer)
    st1 = eng.cb.stats()
    done = {rid: toks for rid, toks in eng.out.items()
            if eng.done_ns[rid] <= run.window_hi_ns}
    delivered = sum(len(v) for v in done.values())
    run.e2e["serve_goodput_tokens_per_s"] = delivered / run.window_s
    run.attempted = len(done)
    run.failed = sum(len(v) != sent[rid]["max_new"] for rid, v in done.items())
    run.counters.update(
        steps=st1["steps"] - st0["steps"], step_s=step_ns / 1e9,
        slot_steps=st1["slot_steps"] - st0["slot_steps"],
        active_slot_steps=st1["active_slot_steps"] - st0["active_slot_steps"],
        prefill_steps=st1["prefill_steps"] - st0["prefill_steps"],
        admit_calls=st1["admit_calls"] - st0["admit_calls"],
        admitted=st1["admitted"] - st0["admitted"],
        slots=int(e["slots"]), delivered_tokens=delivered,
        admission_groups=groups)
    p0 = eng.p0
    del eng
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    check(run, p0, done, sent)


def check(run, p0, done: Dict[int, np.ndarray], sent: Dict[int, Dict]
          ) -> None:
    """The served tokens of the sample against the reference."""
    greedy = [rid for rid, toks in done.items()
              if sent[rid]["greedy"] and len(toks) == sent[rid]["max_new"]]
    if not greedy:
        return  # nothing to compare: no check, so not correct
    rids = sample_with_longest(
        greedy, lambda r: len(sent[r]["prompt"]) + sent[r]["max_new"],
        int(run.cell["check"]["requests"]), run.seed)
    seqs = [np.concatenate([sent[r]["prompt"], done[r]]) for r in rids]
    plens = [len(sent[r]["prompt"]) for r in rids]
    ctrl = np.stack([sent[r]["control"] for r in rids])
    init = np.stack([sent[r]["init"] for r in rids])
    run.counters["checked_tokens"] = int(sum(len(s) - p for s, p in
                                             zip(seqs, plens)))
    cfg = run.config
    with no_tf32():
        lg = ref.served_logits(p0, seqs, ctrl, init, cfg, Arith("f32"),
                               run.device)
        run.check("gap", served_gap(lg, seqs, plens), run.cell["limits"]["gap"])
        if "fp8" in run.options.get("controls", ()):
            lc = ref.served_logits(p0, seqs, ctrl, init, cfg, Arith("fp8"),
                                   run.device)
            run.counters["control.fp8"] = {"gap": served_gap(lg, seqs, plens, lc)}
