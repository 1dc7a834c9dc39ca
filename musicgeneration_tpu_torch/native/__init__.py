"""ctypes bindings for the port's native (C++) MIDI scanner and codecs.

``smf_scan.cc`` holds the SMF parse (``mg_parse``/``mg_free``) and the
token emitters of the MIDI-like, REMI, sustain-pedal, CP and MuMIDI
schemes. It is host code: it runs on the CPU that feeds the card, behind
every scheme's corpus path (``cli.tokenize``).

The library is compiled at first use with the host C++ compiler
(``$CXX``, default ``g++``) and the flags ``-O3 -std=c++17 -fPIC
-shared`` into ``musicgeneration_tpu_torch/_build/``, named with a hash
of the source, the compiler and the flags, so an edited source rebuilds
and an unchanged one is reused. The build writes a temporary file and
renames it, under a file lock, so concurrent processes (test workers, a
``cli.tokenize`` pool) build it once. A build or load that fails raises
``NativeLibraryError`` with the compiler's output: nothing falls back in
silence.

``MG_NATIVE=0`` in the environment selects the codecs' Python paths
(``available()`` is then False and nothing is built). Where the C++
reports an error for one file (a parse error, a tempo outside the
tables), its entry point returns None and the caller takes the Python
path for that file: the Python path is the semantics oracle.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "smf_scan.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # by $CXX


class NativeLibraryError(RuntimeError):
    """The C++ library could not be compiled or loaded."""


class _MgParse(ctypes.Structure):
    _fields_ = [
        ("notes", ctypes.POINTER(ctypes.c_int64)),
        ("n_notes", ctypes.c_int64),
        ("controls", ctypes.POINTER(ctypes.c_int64)),
        ("n_controls", ctypes.c_int64),
        ("tempos", ctypes.POINTER(ctypes.c_int64)),
        ("n_tempos", ctypes.c_int64),
        ("metas", ctypes.POINTER(ctypes.c_int64)),
        ("n_metas", ctypes.c_int64),
        ("n_tracks", ctypes.c_int32),
        ("ticks_per_beat", ctypes.c_int32),
        ("max_tick", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def compiler() -> List[str]:
    return shlex.split(os.environ.get("CXX") or "g++")


def lib_path() -> Path:
    """Where the library for the current source, compiler and flags
    lives (built or not)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(compiler() + list(CXX_FLAGS)).encode())
    return BUILD_DIR / f"libmgsmf-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    ``NativeLibraryError`` with the compiler's output if it fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = compiler()
    if shutil.which(cxx[0]) is None:
        raise NativeLibraryError(
            f"C++ compiler {cxx[0]!r} not found (set CXX): the native MIDI "
            "codecs are built with the host compiler at first use; "
            "MG_NATIVE=0 selects the Python paths instead")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libmgsmf.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeLibraryError(f"{' '.join(cmd)} failed: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeLibraryError(
                f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    key = os.environ.get("CXX") or "g++"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    with _lock:
        if key in _libs:
            return _libs[key]
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeLibraryError(f"cannot load {path}: {e}") from e
        lib.mg_parse.restype = ctypes.POINTER(_MgParse)
        lib.mg_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.mg_free.argtypes = [ctypes.POINTER(_MgParse)]
        _f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        _i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        _u16 = np.ctypeslib.ndpointer(np.uint16, flags="C")
        lib.mg_encode_midilike.restype = ctypes.c_int64
        lib.mg_encode_midilike.argtypes = [
            _f64, _f64, _i64, _i64, ctypes.c_int64,      # notes
            _f64, ctypes.c_int64, _f64, ctypes.c_int64,  # bins
            ctypes.c_int64, ctypes.c_int64,              # pitch range
            ctypes.c_int64, ctypes.c_int64,              # vel range
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,              # id offsets
            _u16, ctypes.c_int64,                        # out
        ]
        lib.mg_encode_remi.restype = ctypes.c_int64
        lib.mg_encode_remi.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,             # file bytes
            _i64, ctypes.c_int64, _i64, ctypes.c_int64,  # dur/vel bins
            ctypes.c_int64, ctypes.c_int64,              # resolution, frac
            ctypes.c_int64, ctypes.c_int64,              # vel_steps, pmax
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,              # tempo intervals
            _i64,                                        # chord id table
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,              # token offsets
            _u16, ctypes.c_int64,                        # out
        ]
        lib.mg_encode_pedal.restype = ctypes.c_int64
        lib.mg_encode_pedal.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,             # file bytes
            ctypes.c_int32,                              # faithful
            _u16, ctypes.c_int64,                        # out
        ]
        lib.mg_encode_cp.restype = ctypes.c_int64
        lib.mg_encode_cp.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,             # file bytes
            _i64, ctypes.c_int64, _i64, ctypes.c_int64,  # dur/vel bins
            ctypes.c_int64, ctypes.c_int64,              # resolution, frac
            ctypes.c_int64, ctypes.c_int64,              # vel_steps, pmax
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,              # tempo intervals
            _i64, _i64,                                  # chords, ignores
            _u16, ctypes.c_int64,                        # out (rows)
        ]
        lib.mg_encode_mumidi.restype = ctypes.c_int64
        lib.mg_encode_mumidi.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,             # file bytes
            ctypes.c_char_p, ctypes.c_int64,             # role names
            ctypes.c_int64, ctypes.c_int64,              # mask, drum role
            _i64, ctypes.c_int64, _i64, ctypes.c_int64,  # dur/vel bins
            ctypes.c_int64, ctypes.c_int64,              # resolution, frac
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,                              # pitch/drum/n
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,              # tempo intervals
            _i64,                                        # chord id table
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _u16, ctypes.c_int64,                        # out
        ]
        _libs[key] = lib
        return lib


def available() -> bool:
    """Whether the codecs take the native path: False under MG_NATIVE=0,
    else True once the library is loaded (built first if needed; a
    failure raises ``NativeLibraryError``)."""
    if os.environ.get("MG_NATIVE", "1") == "0":
        return False
    _load()
    return True


def _emit(call, cap: int, width: int = 1) -> Optional[np.ndarray]:
    """``call(out, cap)`` into a uint16 buffer of ``cap`` rows of
    ``width``: an emitter answers the rows written, -1 for an error, or
    -(rows needed) for a buffer too small, which is retried at that
    size. The rows written (flat), or None on an error."""
    for _ in range(3):
        out = np.empty(cap * width, np.uint16)
        m = call(out, cap)
        if m == -1:
            return None
        if m < -1:
            cap = -m
            continue
        return out[:m * width].copy()
    return None


def encode_midilike(starts: np.ndarray, ends: np.ndarray,
                    pitches: np.ndarray, vels: np.ndarray,
                    vel_bins: np.ndarray, ts_bins: np.ndarray,
                    pitch_range, vel_range,
                    offsets) -> Optional[np.ndarray]:
    """MIDI-like event emission in C++ (smf_scan.cc mg_encode_midilike;
    reference algorithm sequence.py:145-183). Notes must already be in
    the reference NoteSeq order. `offsets` = (note_on, note_off,
    velocity, time_shift) token-id starts from the vocab spec. uint16
    ids, or None where the emitter reports an error (the caller takes
    the Python path)."""
    lib = _load()
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.float64)
    ends = np.ascontiguousarray(ends, np.float64)
    pitches = np.ascontiguousarray(pitches, np.int64)
    vels = np.ascontiguousarray(vels, np.int64)
    vel_bins = np.ascontiguousarray(vel_bins, np.float64)
    ts_bins = np.ascontiguousarray(ts_bins, np.float64)
    # 3 tokens per note + greedy shifts: <= span/bins[-1] full bins total
    # plus at most 2 sub-max tokens per gap (3n-1 gaps)
    span = float(ends.max() - starts.min()) if n else 0.0
    cap = int(3 * n + span / float(ts_bins[-1]) + 6 * n + 64)
    out = np.empty(cap, np.uint16)
    m = lib.mg_encode_midilike(
        starts, ends, pitches, vels, n,
        vel_bins, len(vel_bins), ts_bins, len(ts_bins),
        pitch_range.start, pitch_range.stop,
        vel_range.start, vel_range.stop,
        offsets[0], offsets[1], offsets[2], offsets[3],
        out, cap)
    if m < 0:
        return None
    return out[:m].copy()


def encode_remi(data: bytes, dur_bins: np.ndarray, vel_bins: np.ndarray,
                resolution: int, fraction: int, vel_steps: int,
                pitch_max: int, tempo_bounds, chord_ids: np.ndarray,
                offsets) -> Optional[np.ndarray]:
    """Full-file REMI tokenization in C++ (smf_scan.cc mg_encode_remi):
    SMF parse -> instrument-0 notes -> 120-tick quantize -> chord
    inference -> bar grouping -> tokens, replicating the reference
    pipeline REMI.py:64-257 with the quirks tokenizers/remi.py documents.
    `offsets` = (note_on, note_duration, note_velocity, bar, position,
    tempo_class, tempo_value, chord) token-id starts; `tempo_bounds` =
    (30, 90, 150, 210)-style interval edges; `chord_ids[q*12+r]` + [60]
    for N:N from vocab.CHORD_MAP. uint16 ids, or None on a parse or
    tempo error (the caller takes the Python path)."""
    lib = _load()
    dur_bins = np.ascontiguousarray(dur_bins, np.int64)
    vel_bins = np.ascontiguousarray(vel_bins, np.int64)
    chord_ids = np.ascontiguousarray(chord_ids, np.int64)
    return _emit(lambda out, cap: lib.mg_encode_remi(
        data, len(data), dur_bins, len(dur_bins),
        vel_bins, len(vel_bins),
        resolution, fraction, vel_steps, pitch_max,
        tempo_bounds[0], tempo_bounds[1], tempo_bounds[2],
        tempo_bounds[3], chord_ids,
        offsets[0], offsets[1], offsets[2], offsets[3],
        offsets[4], offsets[5], offsets[6], offsets[7],
        out, cap), 4096)


def encode_pedal(data: bytes, faithful: bool = False
                 ) -> Optional[np.ndarray]:
    """Full-file sustain-pedal codec (vocab 388) in C++ (smf_scan.cc
    mg_encode_pedal; reference MusicTransformer/processor.py:202-230).
    Token ids as uint16, or None where parsing failed (the caller takes
    the Python path)."""
    lib = _load()
    return _emit(lambda out, cap: lib.mg_encode_pedal(
        data, len(data), int(faithful), out, cap), 8192)


def encode_cp(data: bytes, dur_bins: np.ndarray, vel_bins: np.ndarray,
              resolution: int, fraction: int, vel_steps: int,
              pitch_max: int, tempo_bounds, chord_ids: np.ndarray,
              ignore_ids: np.ndarray) -> Optional[np.ndarray]:
    """Full-file CP (Compound Word) tokenization in C++ (smf_scan.cc
    mg_encode_cp). Returns [T, 8] uint16 rows, or None where parsing
    failed (the caller takes the Python path in tokenizers/cp.py, the
    semantics oracle)."""
    lib = _load()
    dur_bins = np.ascontiguousarray(dur_bins, np.int64)
    vel_bins = np.ascontiguousarray(vel_bins, np.int64)
    chord_ids = np.ascontiguousarray(chord_ids, np.int64)
    ignore_ids = np.ascontiguousarray(ignore_ids, np.int64)
    rows = _emit(lambda out, cap: lib.mg_encode_cp(
        data, len(data), dur_bins, len(dur_bins),
        vel_bins, len(vel_bins),
        resolution, fraction, vel_steps, pitch_max,
        tempo_bounds[0], tempo_bounds[1], tempo_bounds[2],
        tempo_bounds[3], chord_ids, ignore_ids,
        out, cap), 2048, 8)
    return None if rows is None else rows.reshape(-1, 8)


def encode_mumidi(data: bytes, role_names, role_mask: int, drum_role: int,
                  dur_bins: np.ndarray, vel_bins: np.ndarray,
                  resolution: int, fraction: int,
                  pitch_lo: int, drum_lo: int, n_pitch: int,
                  tempo_bounds, chord_ids: np.ndarray,
                  offsets) -> Optional[np.ndarray]:
    """One MuMIDI con_instr subset in C++ (smf_scan.cc mg_encode_mumidi;
    reference MuMIDI.py:86-207). `role_names` = the 6 track roles in
    vocab order; `role_mask` selects which to include (melody-only vs
    the 5 arrangement roles); `offsets` = (note_on, note_duration,
    note_velocity, bar, position, track, tempo_class, tempo_value,
    chord) token-id starts. Returns an EMPTY array when the file has no
    selected notes (the caller's None case) and None where parsing
    failed (the caller takes the Python path)."""
    lib = _load()
    blob = b"".join(name.encode("ascii") + b"\0" for name in role_names)
    dur_bins = np.ascontiguousarray(dur_bins, np.int64)
    vel_bins = np.ascontiguousarray(vel_bins, np.int64)
    chord_ids = np.ascontiguousarray(chord_ids, np.int64)
    return _emit(lambda out, cap: lib.mg_encode_mumidi(
        data, len(data), blob, len(role_names), role_mask, drum_role,
        dur_bins, len(dur_bins), vel_bins, len(vel_bins),
        resolution, fraction, pitch_lo, drum_lo, n_pitch,
        tempo_bounds[0], tempo_bounds[1], tempo_bounds[2],
        tempo_bounds[3], chord_ids,
        offsets[0], offsets[1], offsets[2], offsets[3], offsets[4],
        offsets[5], offsets[6], offsets[7], offsets[8],
        out, cap), 4096)


def parse_midi_bytes(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """Parse one SMF buffer natively: the flat arrays of smf_scan.cc's
    layout, or None where the scanner reports an error (the caller takes
    the Python path)."""
    lib = _load()
    ptr = lib.mg_parse(data, len(data))
    try:
        p = ptr.contents
        if p.error:
            return None

        def arr(cptr, n, width):
            if n == 0:
                return np.zeros((0, width), np.int64)
            flat = np.ctypeslib.as_array(cptr, shape=(n * width,))
            return flat.reshape(n, width).copy()

        return {
            "notes": arr(p.notes, p.n_notes, 7),
            "controls": arr(p.controls, p.n_controls, 6),
            "tempos": arr(p.tempos, p.n_tempos, 2),
            "metas": arr(p.metas, p.n_metas, 5),
            "n_tracks": int(p.n_tracks),
            "ticks_per_beat": int(p.ticks_per_beat),
            "max_tick": int(p.max_tick),
        }
    finally:
        lib.mg_free(ptr)
