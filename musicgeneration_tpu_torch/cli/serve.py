"""Serve generation requests with continuous batching.

    python -m musicgeneration_tpu_torch.cli.serve model.pth requests.jsonl \\
        outdir --slots 8 --seg-len 64 [--greedy | --temperature/--topk/--topp]

`requests.jsonl`: one JSON object per line —
    {"id": "a", "prime": "prompt.mid", "max_new": 256}
    {"id": "b", "tokens": [24, 28, 31], "max_new": 512, "eos": 107,
     "temperature": 0.8, "top_k": 20, "top_p": 0.95, "greedy": false}
(`prime` tokenizes a MIDI, up to `prime_len` tokens (500), with the
codec of the scheme the checkpoint's `cli.train` run recorded
(`midilike`, `midilike_control`, `remi`, `pedal` or `melody` for a
MusicTransformer and the GRU families; the MIDI-like codec for an
exported `.pth`), and results are written back
through it; `tokens` supplies raw ids. `id` defaults to the line
number. Any sampling field on any line switches the engine to per-row
sampling: each request decodes under its own params, defaulting to the
CLI-level flags.)

The checkpoint is an exported `.pth` or a `cli.train` checkpoint (a
directory or one `step-<N>.pt`), as for `cli.generate`; its family is
read off the state dict. A MusicTransformer serves through the KV-cache
engine (decode/serving.py), where {"window": 256} asks for
sliding-context decoding: max_new is then not bounded by the serve
window — the slot re-primes from its last `window` tokens whenever the
context would exceed 2*window, as generate_sliding does. EventMelodyRNN,
PerformanceRNN and MelodyRNN serve through the hidden-state engine
(decode/serving_rnn.py), whose slots hold O(1) state and take any
max_new (`window` is refused; a MelodyRNN slot also holds its attention
window and its own count of it); `prime` goes through the codec of the
scheme a `cli.train` run recorded (MelodyRNN: note arrays, written back
with `note_array_to_midi`). The GRU families' requests may also carry
    {"init_seed": 3}          — an N(0, 1) latent from that seed, or
    {"init": [..init_dim..]}  — an explicit latent (default: zeros),
    {"control": [..C..] | [[..C..], ...]}
                              — PerformanceRNN conditioning (a single
                                control repeats; a sequence is consumed
                                per step and holds its last row, at most
                                --ctrl-window rows). PerformanceRNN
                                prompts from `prime` or the default get
                                the primary event prepended, as in
                                cli.generate.
A CPTransformer serves Compound Word rows through the CP engine
(decode/serving_cp.py): `prime` is encoded to rows with the CP codec (up
to `prime_len` rows; no `prime` and no `tokens`: a bare bar-marker row),
`tokens` gives [P, 8] rows, `eos` is matched against the family column
(2 = end of piece), `window` re-primes the slot from its last `window`
rows as for the MusicTransformer, the results are [n, 8] rows written
with the CP codec; sampling is the CLI-level --greedy/--temperature only
(no --topk/--topp, no per-request fields).
A PoPMAG checkpoint serves melody -> arrangement requests through the
bar engine (decode/serving_popmag.py):
    {"id": "m", "prime": "melody.mid"}          — a melody MIDI, or
    {"melody": [[[..7 ids..], ...] per bar], "src_len": [..]}
                                                — packed compound rows,
with optional `init`/`init_seed` latents; `max_new` counts target BARS
(default: the melody's bar count) and `eos` is refused. A segment is
`--seg-bars` bars (default 2; `--boost` 4 by default), a bar 200
decoder steps through kernel D; melodies are cut to the run's max_bars
and max_bar_len (16 and 96 for a `.pth`) and bucketed by gcd(8,
max_bars) bars. Results are flat MuMIDI token streams written with the
MuMIDI codec; goodput is reported in bars/s and tokens/s.
Each request's continuation is written to `outdir/<id>.mid` the moment
it finalizes. Runs on `--device cuda` by default; a missing GPU is an
error.

ONLINE mode: pass `-` as the request file to read JSONL from stdin as
it arrives — requests join the live pool between decode segments, and
one JSON line per completion goes to stdout ({"id", "file", "tokens"}):

    client | python -m musicgeneration_tpu_torch.cli.serve model.pth - out

HTTP mode: `--http PORT` (0 = an ephemeral port, printed on ready; the
requests positional is ignored, pass -) serves the same live pool —
    POST /generate   one request object (the JSONL line schema); blocks
                     until it finalizes, returns {"id", "tokens": [...],
                     "n_tokens", "file"}
    POST /submit     same body, returns {"id", "status": "queued"} at once
    POST /stream     same body, server-sent events: one
                     `data: {"id", "tokens": [...]}` chunk per decoded
                     segment as it commits, then `event: done` with
                     {"id", "n_tokens", "file"}; the chunks concatenate
                     to exactly /generate's tokens
    GET  /result/ID  202 {"status": "pending", "n_tokens": so far} while
                     decoding; 200 with the /generate payload once final
                     (consumed on the first 200); 404 unknown
    POST /cancel     {"id": ID} — queued: dropped, active: slot freed;
                     /result then reports {"status": "cancelled"}
    GET  /stats      scheduler counters + latency summary
    GET  /healthz    {"ready": true, "slots": N}
    POST /shutdown   drain and exit (also SIGINT)
Handler threads only parse and enqueue; every submit, step and collect
runs on the engine thread.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(args):
    """--dtype, or None: the dtype the checkpoint records (float32 for
    an exported .pth)."""
    return None if args.dtype is None else _DTYPES[args.dtype]
_SAMP_FIELDS = ("temperature", "top_k", "top_p", "greedy")
RNN_FAMILIES = ("event_rnn", "performance_rnn", "melody_rnn")


def _load_model(args):
    """(model, recorded config) of the checkpoint; a state dict of no
    family the port runs exits."""
    from ..convert import load_checkpoint
    try:
        return load_checkpoint(args.checkpoint, device=args.device,
                               dtype=_dtype(args), with_config=True)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"{args.checkpoint}: {e}") from None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="musicgeneration_tpu_torch.cli.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help="exported .pth, or a cli.train "
                   "checkpoint directory (newest step) or step-<N>.pt")
    p.add_argument("requests", help="JSONL request file, or - (stdin)")
    p.add_argument("outdir")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--seg-len", type=int, default=64)
    p.add_argument("--depth", type=int, default=2,
                   help="segments in flight (pipelined dispatch)")
    p.add_argument("--cache-len", type=int, default=None)
    p.add_argument("--ctrl-window", type=int, default=256,
                   help="per-slot control window (performance_rnn)")
    p.add_argument("--seg-bars", type=int, default=2,
                   help="bars per dispatched segment (popmag)")
    p.add_argument("--boost", type=int, default=None,
                   help="fuse up to this many segments into one dispatch "
                        "when the queue is empty and every active "
                        "request has that much left (1 disables); "
                        "default 8 for the RNN families, 4 for PoPMAG, 1 "
                        "for the MusicTransformer")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--topp", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-new", type=int, default=512,
                   help="default when a request omits max_new")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve an HTTP endpoint instead of a request "
                        "file (0 = ephemeral port, printed on ready)")
    p.add_argument("--http-timeout", type=float, default=600.0,
                   help="per-request completion timeout (seconds)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default=None, choices=sorted(_DTYPES),
                   help="compute dtype (default: the one a cli.train "
                        "checkpoint records, else float32)")
    args = p.parse_args(argv)

    from ..decode.sampling import SamplingParams
    from ..decode.serving import ContinuousBatcher
    from ..decode.serving_cp import CPContinuousBatcher
    from ..decode.serving_rnn import RNNContinuousBatcher
    from ..tokenizers import cp as cp_codec
    from .generate import (melody_compound_from_midi, popmag_limits,
                           prime_tokens, rnn_prime, rnn_scheme,
                           transformer_scheme, write_midi)

    model, config = _load_model(args)
    is_cp = model.family == "cp_transformer"
    is_rnn = model.family in RNN_FAMILIES
    is_popmag = model.family == "popmag"
    if is_popmag:
        from ..decode.serving_popmag import PopMAGContinuousBatcher
        from ..tokenizers.mumidi import MuMIDI_EventSeq

        if args.topk or args.topp < 1.0:
            raise SystemExit("--topk/--topp are not defined for PoPMAG's "
                             "typed heads (greedy or one temperature)")
        max_bars, max_bar_len = popmag_limits(config)

        def write_midi(toks, path):
            MuMIDI_EventSeq.write_midi(MuMIDI_EventSeq.from_array(toks), path)
        print(f"loaded PoPMAG ({model.num_layers} GRU layers, hidden "
              f"{model.hidden_dim}, embed {model.embed_dim}; max_bars "
              f"{max_bars}, max_bar_len {max_bar_len}) on {model.device}")
    elif is_cp:
        if args.topk or args.topp < 1.0:
            raise SystemExit("--topk/--topp are not defined for compound-word "
                             "rows (type-first sampling draws each field "
                             "categorically)")
        write_midi = cp_codec.write_midi
        print(f"loaded CPTransformer ({model.num_layers} layers, d_model "
              f"{model.d_model}, max_seq {model.max_seq}) on {model.device}")
    elif is_rnn:
        scheme = rnn_scheme(model, config)

        def write_midi(toks, path, _write=write_midi):
            _write(toks, path, scheme)
        cell = "LSTM" if model.family == "melody_rnn" else "GRU"
        print(f"loaded {model.family} ({model.num_layers} {cell} layers, "
              f"hidden {model.hidden_dim}; scheme {scheme}) on "
              f"{model.device}")
    else:
        scheme = transformer_scheme(model, config)

        def write_midi(toks, path, _write=write_midi):
            _write(toks, path, scheme)
        print(f"loaded MusicTransformer ({model.num_layers} layers, d_model "
              f"{model.d_model}, max_seq {model.max_seq}; scheme {scheme}) "
              f"on {model.device}")
    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.topk, top_p=args.topp,
                              greedy=args.greedy)

    def parse_request(line: str, ln: int):
        req = json.loads(line)
        if not isinstance(req, dict):
            raise ValueError("request must be a JSON object, got "
                             f"{type(req).__name__}")
        name = str(req.get("id", ln))
        if is_popmag:
            return parse_popmag(req, name)
        if "tokens" in req:
            toks = np.asarray(req["tokens"], np.int32)
        elif is_cp:
            toks = (np.asarray([cp_codec._row(cp_codec.FAMILY_METRIC,
                                              position=0)], np.int32)
                    if req.get("prime") is None else np.asarray(
                        cp_codec.extract_events(req["prime"])[
                            :req.get("prime_len", 500)], np.int32))
        elif is_rnn:
            toks = np.asarray(rnn_prime(model, req.get("prime"),
                                        req.get("prime_len", 500), scheme),
                              np.int32)
        else:
            toks = np.asarray(prime_tokens(req.get("prime"),
                                           req.get("prime_len", 500), scheme),
                              np.int32)
        sp = None
        if is_cp and any(f in req for f in _SAMP_FIELDS):
            raise ValueError(
                "per-request sampling params are not defined for "
                "compound-word rows; set the CLI-level flags")
        if any(f in req for f in _SAMP_FIELDS):
            sp = SamplingParams(
                temperature=float(req.get("temperature", args.temperature)),
                top_k=int(req.get("top_k", args.topk)),
                top_p=float(req.get("top_p", args.topp)),
                greedy=bool(req.get("greedy", args.greedy)))
        extra = {}
        if "window" in req:
            if is_rnn:
                raise ValueError(
                    "window= is a KV-cache sliding-context option; RNN "
                    "slots hold O(1) state and serve any max_new — drop "
                    "the field")
            extra["window"] = int(req["window"])
        if is_rnn:
            if ("init" in req or "init_seed" in req) and not hasattr(
                    model, "init_dim"):
                raise ValueError(f"{model.family} has no init latent; drop "
                                 "'init'/'init_seed'")
            if "init" in req:
                extra["init"] = np.asarray(req["init"], np.float32)
            elif "init_seed" in req:
                extra["init"] = np.random.RandomState(
                    int(req["init_seed"])).randn(
                        model.init_dim).astype(np.float32)
            if "control" in req:
                extra["control"] = np.asarray(req["control"], np.float32)
        return (name, toks, int(req.get("max_new", args.max_new)),
                req.get("eos"), sp, extra)

    def parse_popmag(req: dict, name: str):
        """A melody -> arrangement request: ``melody`` rows or a ``prime``
        MIDI; ``max_new`` counts bars (default: the melody's)."""
        if "melody" in req:
            src = np.asarray(req["melody"], np.int32)
            if src.ndim != 3:
                raise ValueError("'melody' must be [bars, S, 7] compound "
                                 "rows")
            src_len = np.asarray(req.get(
                "src_len", (src != 0).any(-1).sum(-1)), np.int32)
        elif req.get("prime"):
            src, src_len = melody_compound_from_midi(req["prime"], max_bars,
                                                     max_bar_len)
        else:
            raise ValueError("PoPMAG requests need 'prime' (a melody MIDI) "
                             "or 'melody' (packed [bars, S, 7] compound "
                             "rows)")
        if req.get("eos") is not None:
            raise ValueError("PoPMAG requests retire by bar count; drop "
                             "'eos'")
        if any(f in req for f in _SAMP_FIELDS) or "window" in req:
            raise ValueError("per-request sampling and window= are not "
                             "defined for PoPMAG; set the CLI-level flags")
        extra = {"src_len": src_len}
        if "init" in req:
            extra["init"] = np.asarray(req["init"], np.float32)
        elif "init_seed" in req:
            rs = np.random.RandomState(int(req["init_seed"]))
            extra["init"] = rs.randn(model.init_dim).astype(np.float32)
        return (name, src, int(req.get("max_new", src.shape[0])), None, None,
                extra)

    def build_cb(per_row: bool, on_finalize):
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        if is_popmag:
            return PopMAGContinuousBatcher(
                model, slots=args.slots, sampling=sampling,
                seg_len=args.seg_bars, max_bars=max_bars,
                max_bar_len=max_bar_len, depth=args.depth,
                boost=args.boost if args.boost is not None else 4,
                # a bucket that divides max_bars (the slots' melody
                # buffers are max_bars wide)
                prompt_bucket=math.gcd(8, max_bars),
                on_finalize=on_finalize, generator=gen)
        if is_cp:
            if args.boost and args.boost > 1:
                print("note: --boost is not supported for compound-word "
                      "rows; ignored", file=sys.stderr)
            return CPContinuousBatcher(
                model, slots=args.slots, sampling=sampling,
                seg_len=args.seg_len, cache_len=args.cache_len,
                depth=args.depth, on_finalize=on_finalize, generator=gen)
        if is_rnn:
            return RNNContinuousBatcher(
                model, slots=args.slots, sampling=sampling,
                seg_len=args.seg_len, depth=args.depth,
                ctrl_window=args.ctrl_window,
                boost=args.boost if args.boost is not None else 8,
                per_row_sampling=per_row, on_finalize=on_finalize,
                generator=gen)
        return ContinuousBatcher(
            model, slots=args.slots, sampling=sampling,
            seg_len=args.seg_len, cache_len=args.cache_len,
            depth=args.depth, per_row_sampling=per_row,
            boost=args.boost if args.boost is not None else 1,
            on_finalize=on_finalize, generator=gen)

    if args.http is not None:
        return _serve_http(build_cb, parse_request, write_midi, args)
    if args.requests == "-":
        return _serve_follow(build_cb, parse_request, write_midi, args)

    parsed = []
    with open(args.requests) as fh:
        for ln, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                parsed.append(parse_request(line, ln))
            except ValueError as e:
                raise SystemExit(f"request line {ln}: {e}")
    if not parsed:
        raise SystemExit(f"no requests in {args.requests}")

    per_row = any(sp is not None for *_, sp, _e in parsed)
    os.makedirs(args.outdir, exist_ok=True)
    names, written = {}, []

    def deliver(rid, toks):
        # each result is written the moment it finalizes, while later
        # segments still decode
        path = os.path.join(args.outdir, f"{names[rid]}.mid")
        write_midi(toks, path)
        written.append((path, len(toks)))

    cb = build_cb(per_row, deliver)
    cb.warm()
    rids = []
    for name, toks, max_new, eos, sp, extra in parsed:
        rid = cb.submit(toks, max_new, eos_id=eos, sampling=sp, **extra)
        names[rid] = name
        rids.append(rid)
    seg = f"seg_bars={args.seg_bars}" if is_popmag else \
        f"seg_len={args.seg_len}"
    print(f"serving {len(rids)} requests over {args.slots} slots "
          f"({seg}, depth={args.depth})")

    t0 = time.perf_counter()
    outs = cb.run()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in outs.values())
    st = cb.stats()
    lat = cb.latency_summary()
    if is_popmag:
        bars = sum(max_new for _, _, max_new, *_ in parsed)
        print(f"generated {bars} bars, {total} tokens in {dt:.3f}s "
              f"({bars / dt:.2f} bars/s, {total / dt:.1f} tok/s goodput); "
              f"{st['segments']} segments, {st['steps']} bar steps "
              f"({st['steps'] * cb.max_steps} decoder steps), occupancy "
              f"{st['occupancy']:.1%}, {st['admit_calls']} admission calls; "
              f"latency p50/p95 {lat['e2e_p50']:.3f}/{lat['e2e_p95']:.3f}s "
              f"(queue wait {lat['wait_p50']:.3f}/{lat['wait_p95']:.3f}s)")
    else:
        _summary(st, lat, total, dt, is_rnn)
    missing = set(rids) - set(outs)
    if missing:
        raise SystemExit(f"requests never finalized: {sorted(missing)}")
    for path, n in written:
        print(f"wrote {path} ({n} tokens)")
    return 0


def _summary(st: dict, lat: dict, total: int, dt: float,
             is_rnn: bool) -> None:
    """The file-mode summary line of the token engines."""
    engine = (f"{st['prefill_steps']} prefill steps" if is_rnn else
              f"{st['compactions']} compactions, {st['reprimes']} reprimes")
    print(f"generated {total} tokens in {dt:.3f}s "
          f"({total / dt:.1f} tok/s goodput); "
          f"{st['segments']} segments, {st['steps']} decode steps, "
          f"occupancy {st['occupancy']:.1%}, "
          f"{st['admit_calls']} admission calls, {engine}; "
          f"latency p50/p95 {lat['e2e_p50']:.3f}/{lat['e2e_p95']:.3f}s "
          f"(queue wait {lat['wait_p50']:.3f}/{lat['wait_p95']:.3f}s)")


def _serve_http(build_cb, parse_request, write_midi, args) -> int:
    """HTTP serving loop: a ThreadingHTTPServer accepts requests on
    handler threads, which parse, enqueue and block on a completion
    event; the engine thread drains the intake queue between decode
    segments and runs cb.step(). Only this one thread touches the
    engine."""
    import queue
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    os.makedirs(args.outdir, exist_ok=True)
    intake = queue.Queue()   # (parsed, holder) | ("cancel", name)
    stopping = threading.Event()
    stats_lock = threading.Lock()
    shared = {"stats": {}, "latency": {}, "ready": False,
              "progress": {},  # name -> tokens emitted so far
              "results": {}}   # name -> finished async payload
    seq_lock = threading.Lock()
    seq = [0]

    def next_id():
        with seq_lock:
            seq[0] += 1
            return seq[0] - 1

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # noqa: N802 - no per-request log
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"ready": shared["ready"],
                                 "slots": args.slots})
            elif self.path == "/stats":
                with stats_lock:
                    self._json(200, {"stats": shared["stats"],
                                     "latency": shared["latency"]})
            elif self.path.startswith("/result/"):
                name = self.path[len("/result/"):]
                with stats_lock:
                    if name in shared["results"]:
                        self._json(200, shared["results"].pop(name))
                    elif name in shared["progress"]:
                        self._json(202, {
                            "id": name, "status": "pending",
                            "n_tokens": shared["progress"][name]})
                    else:
                        self._json(404, {"error": f"unknown id {name}"})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n).decode()

        def _stream(self, parsed):
            """POST /stream: one `data:` event per freshly committed
            token chunk, then `event: done`. The chunks concatenate to
            exactly /generate's tokens (both go through the engine's
            `_assemble_result`, so max_new trims and eos cuts apply to
            the stream too, prefix-exact)."""
            q = queue.Queue()
            holder = {"stream": q, "sent": 0}
            intake.put((parsed, holder))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()

            def emit(event, obj):
                head = f"event: {event}\n" if event else ""
                self.wfile.write(
                    (head + f"data: {json.dumps(obj)}\n\n").encode())
                self.wfile.flush()

            # an IDLE timeout: every delivered event resets it
            try:
                while True:
                    try:
                        kind, payload = q.get(timeout=args.http_timeout)
                    except queue.Empty:
                        holder["gone"] = True   # stop engine pushes
                        emit("error", {"error": "generation timed out"})
                        return
                    if kind == "tok":
                        emit(None, {"id": parsed[0], "tokens": payload})
                    elif kind == "done":
                        emit("done", payload)
                        return
                    else:
                        emit("error", payload)
                        return
            except (BrokenPipeError, ConnectionResetError):
                holder["gone"] = True   # client went away: stop pushing

        def do_POST(self):  # noqa: N802
            if self.path == "/shutdown":
                stopping.set()
                self._json(200, {"ok": True})
                return
            if self.path == "/cancel":
                try:
                    name = str(json.loads(self._read_body())["id"])
                except (ValueError, KeyError) as e:
                    self._json(400, {"error": f"need {{'id': ...}}: {e}"})
                    return
                intake.put(("cancel", name))
                self._json(202, {"id": name, "status": "cancel_requested"})
                return
            if self.path not in ("/generate", "/submit", "/stream"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            if stopping.is_set():
                self._json(503, {"error": "server is draining"})
                return
            try:
                parsed = parse_request(self._read_body(), next_id())
            except (ValueError, TypeError, KeyError, AttributeError,
                    UnicodeDecodeError) as e:
                # malformed field types must 400, not kill the thread
                self._json(400, {"error": str(e)})
                return
            if self.path == "/submit":
                intake.put((parsed, {"async": True}))
                self._json(200, {"id": parsed[0], "status": "queued"})
                return
            if self.path == "/stream":
                return self._stream(parsed)
            holder = {"event": threading.Event()}
            intake.put((parsed, holder))
            if not holder["event"].wait(args.http_timeout):
                self._json(504, {"error": "generation timed out"})
                return
            if "error" in holder:
                self._json(400, {"error": holder["error"]})
                return
            toks = holder["tokens"]
            self._json(200, {"id": parsed[0],
                             "tokens": np.asarray(toks).tolist(),
                             "n_tokens": int(len(toks)),
                             "file": holder["path"]})

    pending = {}  # rid -> (name, holder)

    def resolve_cancel(name, holder, toks):
        if holder.get("async"):
            with stats_lock:
                shared["results"][name] = {"id": name,
                                           "status": "cancelled",
                                           "n_tokens": int(len(toks))}
        elif "stream" in holder:
            holder["stream"].put(("done", {
                "id": name, "status": "cancelled",
                "n_tokens": int(len(toks))}))
        else:
            holder["error"] = "cancelled"
            holder["event"].set()

    def deliver(rid, toks):
        name, holder = pending.pop(rid)
        if holder.get("cancelled"):
            # an ACTIVE cancel finalizes through here (partial tokens)
            resolve_cancel(name, holder, toks)
            return
        path = os.path.join(args.outdir, f"{name}.mid")
        write_midi(toks, path)
        if holder.get("async"):
            with stats_lock:
                shared["results"][name] = {
                    "id": name, "tokens": np.asarray(toks).tolist(),
                    "n_tokens": int(len(toks)), "file": path}
            return
        if "stream" in holder:
            # flush what the per-segment pushes have not sent, then done;
            # `toks` is the assembled result, so the stream equals it
            arr = np.asarray(toks)
            if len(arr) > holder["sent"] and not holder.get("gone"):
                holder["stream"].put(("tok", arr[holder["sent"]:].tolist()))
                holder["sent"] = len(arr)
            holder["stream"].put(("done", {
                "id": name, "n_tokens": int(len(arr)), "file": path}))
            return
        holder["tokens"] = toks
        holder["path"] = path
        holder["event"].set()

    cb = build_cb(True, deliver)  # per-row: params may vary per POST
    cb.warm()
    server = ThreadingHTTPServer(("127.0.0.1", args.http), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()
    shared["ready"] = True
    port = server.server_address[1]
    print(json.dumps({"ready": True, "port": port, "slots": args.slots}),
          flush=True)

    n_sub = 0
    t0 = time.perf_counter()
    try:
        while True:
            while True:  # drain intake without blocking
                try:
                    parsed, holder = intake.get_nowait()
                except queue.Empty:
                    break
                if parsed == "cancel":
                    name = holder
                    for r in [r for r, (n2, _h) in pending.items()
                              if n2 == name]:
                        pending[r][1]["cancelled"] = True
                        cb.cancel(r)  # active: finalizes via deliver()
                        if r in pending:  # queued: no finalize fired
                            _n2, h = pending.pop(r)
                            resolve_cancel(name, h, [])
                    continue
                name, toks, max_new, eos, sp, extra = parsed
                try:
                    rid = cb.submit(toks, max_new, eos_id=eos,
                                    sampling=sp, **extra)
                except ValueError as e:
                    if holder.get("async"):
                        with stats_lock:
                            shared["results"][name] = {
                                "id": name, "error": str(e)}
                    elif "stream" in holder:
                        holder["stream"].put(("error", {"error": str(e)}))
                    else:
                        holder["error"] = str(e)
                        holder["event"].set()
                    continue
                if "stream" in holder:
                    holder["req"] = (max_new, eos)
                pending[rid] = (name, holder)
                n_sub += 1
            busy = cb.step()
            # push fresh tokens to /stream clients, assembled as the
            # final result is, so the stream is always a prefix of it
            for rid, (name, holder) in list(pending.items()):
                if "stream" not in holder or holder.get("gone") \
                        or holder.get("cancelled"):
                    continue
                em = cb._emitted.get(rid)
                if not em:
                    continue
                mn, eos2 = holder["req"]
                cur = cb._assemble_result(list(em), mn, eos2)
                if len(cur) > holder["sent"]:
                    holder["stream"].put(
                        ("tok", np.asarray(cur[holder["sent"]:]).tolist()))
                    holder["sent"] = len(cur)
            # results went out through on_finalize; run() is what
            # consumes `done`, so drop the engine's copy here
            cb.done.clear()
            with stats_lock:
                shared["stats"] = cb.stats()
                shared["latency"] = cb.latency_summary()
                shared["progress"] = {
                    n2: len(cb._emitted.get(r, []))
                    for r, (n2, _h) in pending.items()}
            if not busy and not pending:
                if stopping.is_set():
                    break
                try:  # idle: block until the next request (or stop)
                    intake.put(intake.get(timeout=0.5))
                except queue.Empty:
                    continue
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
    dt = time.perf_counter() - t0
    st = cb.stats()
    print(f"served {n_sub} requests in {dt:.1f}s; "
          f"{st['committed_tokens']} tokens, "
          f"occupancy {st['occupancy']:.1%}", file=sys.stderr)
    return 0


def _serve_follow(build_cb, parse_request, write_midi, args) -> int:
    """ONLINE serving loop: JSONL requests from stdin join the live pool
    between decode segments; each completion streams one JSON line to
    stdout at once. Ends when stdin closes and the pool drains. select()
    keeps intake from blocking decode: with work active the loop polls,
    idle it waits on the pipe."""
    import select

    os.makedirs(args.outdir, exist_ok=True)
    names = {}

    def deliver(rid, toks):
        path = os.path.join(args.outdir, f"{names[rid]}.mid")
        write_midi(toks, path)
        print(json.dumps({"id": names[rid], "file": path,
                          "tokens": int(len(toks))}), flush=True)

    # per-row sampling always on: requests with their own params can
    # arrive at any time
    cb = build_cb(True, deliver)
    cb.warm()
    print(json.dumps({"ready": True, "slots": args.slots}), flush=True)

    fh = sys.stdin
    fd = fh.fileno()
    rbuf = b""
    eof = False
    ln = 0
    n_sub = 0

    def take_lines():
        """Every complete line the pipe has ready, without blocking.
        select() on the raw fd pairs with os.read: a buffered readline()
        could pull several lines into Python's buffer while select then
        reports the fd empty."""
        nonlocal rbuf, eof
        out = []
        while not eof and select.select([fh], [], [], 0)[0]:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
                break
            rbuf += chunk
        while b"\n" in rbuf:
            raw, rbuf = rbuf.split(b"\n", 1)
            out.append(raw.decode())
        if eof and rbuf:               # trailing line without newline
            out.append(rbuf.decode())
            rbuf = b""
        return out

    t0 = time.perf_counter()
    while True:
        for line in take_lines():
            if not line.strip():
                continue
            try:
                name, toks, max_new, eos, sp, extra = parse_request(
                    line.strip(), ln)
            except (ValueError, TypeError, KeyError, AttributeError) as e:
                # a malformed line errors alone, not the server
                print(json.dumps({"id": str(ln), "error": str(e)}),
                      flush=True)
                ln += 1
                continue
            ln += 1
            try:
                rid = cb.submit(toks, max_new, eos_id=eos, sampling=sp,
                                **extra)
            except ValueError as e:
                print(json.dumps({"id": name, "error": str(e)}), flush=True)
                continue
            names[rid] = name
            n_sub += 1
        busy = cb.step()
        cb.done.clear()   # results went out through deliver()
        if not busy:
            if eof:
                break
            # idle pool: block until the next request (or EOF)
            select.select([fh], [], [], 1.0)
    dt = time.perf_counter() - t0
    st = cb.stats()
    print(f"served {n_sub} requests in {dt:.1f}s; "
          f"{st['committed_tokens']} tokens, "
          f"occupancy {st['occupancy']:.1%}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
