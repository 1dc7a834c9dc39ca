"""Offline tokenization pipeline: MIDI corpus -> packed token shards.

The port of ``musicgeneration_tpu/data/pipeline.py`` for every scheme:
MIDI-like (with or without per-event controls), REMI, sustain-pedal
MIDI-like, CP, MuMIDI and melody, through the port's own codecs
(``tokenizers/midilike.py``, ``tokenizers/remi.py``, ``tokenizers/
pedal_midilike.py``, ``tokenizers/cp.py``, ``tokenizers/mumidi.py``,
``tokenizers/melody.py``), each through its native-first entry point (the
C++ scanner and emitters of ``native/``; their Python paths under
``MG_NATIVE=0``). REMI and pedal files are uint16, a CP file's
[T, 8] rows are stored flattened, a MuMIDI file is a uint16 ``melody``/
``arrangement`` pair, a ``midilike_control`` file adds its compressed
[n, 13] uint8 controls flattened, a melody file is an int16 note
array. The shard layout and ``manifest.json`` are the JAX package's, so
each package reads the other's corpora: shard ``midilike-00000.npz``
holds, for the stream key ``tokens`` (``melody`` and ``arrangement`` for
MuMIDI),

    tokens_data    — 1-D uint16 concatenation of all sequences
    tokens_offsets — int64 [n+1]; file i is tokens_data[offsets[i]:offsets[i+1]]

plus ``names``, the source file basenames. Files that fail to tokenize
land in ``quarantine.jsonl`` with the exception text; shards are written
atomically (tmp + rename). ``split_ratio`` and ``split_maestro`` split a
MIDI collection into train/valid(ation)/test directories (``cli.split``).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native

MIDI_EXTENSIONS = (".mid", ".midi", ".MID", ".MIDI")


def find_midi_files(root: str) -> List[str]:
    """Recursive MIDI scan (reference utils/shared.py:14-26)."""
    out = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if name.endswith(MIDI_EXTENSIONS):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _tokenize_midilike(path: str) -> Dict[str, np.ndarray]:
    """Top level, so the worker pool can pickle it."""
    from ..tokenizers import midilike
    return {"tokens": midilike.encode_array(path).astype(np.uint16)}


def _tokenize_remi(path: str) -> Dict[str, np.ndarray]:
    """REMI tokens (uint16): the native pipeline, or its vectorised Python
    oracle."""
    from ..tokenizers import remi
    return {"tokens": remi.encode_array(path).astype(np.uint16)}


def _tokenize_pedal(path: str) -> Dict[str, np.ndarray]:
    """Sustain-pedal MIDI-like tokens (vocabulary 388), uint16."""
    from ..tokenizers import pedal_midilike
    return {"tokens": pedal_midilike.encode_array(path).astype(np.uint16)}


def _tokenize_midilike_control(path: str) -> Dict[str, np.ndarray]:
    """MIDI-like tokens and their per-event compressed controls (pitch
    histogram and note density, reference sequence.py:294-407), the
    [n_events, 13] uint8 array flattened (reshape(-1, 13) on load):
    PerformanceRNN's conditioned training data."""
    from ..tokenizers import midilike
    tokens = midilike.encode_array(path)
    controls = midilike.ControlSeq.compressed_from_ids(tokens)
    return {"tokens": tokens.astype(np.uint16),
            "controls": controls.reshape(-1)}


def _tokenize_melody(path: str) -> Dict[str, np.ndarray]:
    """The Melody-RNN note array of every non-drum part (int16)."""
    from ..tokenizers import melody
    return {"tokens": melody.midi_to_note_array(path).astype(np.int16)}


def _tokenize_cp(path: str) -> Dict[str, np.ndarray]:
    """Compound Word rows [T, 8] stored flattened (width 8 is fixed by the
    scheme; reshape(-1, 8) on load)."""
    from ..tokenizers import cp
    return {"tokens": cp.encode_rows(path).reshape(-1)}


def _tokenize_mumidi(path: str) -> Dict[str, np.ndarray]:
    """The file's melody track and the other five roles as two MuMIDI
    streams; a file without both fails (and is quarantined)."""
    from ..tokenizers import mumidi
    melody, arrangement = mumidi.MuMIDI_EventSeq.encode_split_arrays(path)
    if melody is None:
        raise ValueError("no melody/arrangement tracks to split")
    return {"melody": melody.astype(np.uint16),
            "arrangement": arrangement.astype(np.uint16)}


SCHEMES: Dict[str, Callable[[str], Dict[str, np.ndarray]]] = {
    "midilike": _tokenize_midilike,
    "midilike_control": _tokenize_midilike_control,
    "remi": _tokenize_remi,
    "pedal": _tokenize_pedal,
    "melody": _tokenize_melody,
    "cp": _tokenize_cp,
    "mumidi": _tokenize_mumidi,
}


@dataclasses.dataclass
class CorpusStats:
    n_files: int = 0
    n_ok: int = 0
    n_failed: int = 0
    n_tokens: int = 0
    shards: List[str] = dataclasses.field(default_factory=list)


def tokenize_corpus(
    input_dir: str,
    output_dir: str,
    scheme: str = "midilike",
    num_workers: int = 0,  # <= 0: one per CPU
    shard_size: int = 1024,
    paths: Optional[Sequence[str]] = None,
) -> CorpusStats:
    """Tokenize every MIDI under input_dir into packed shards."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; one of {list(SCHEMES)}")
    if num_workers <= 0:
        num_workers = os.cpu_count() or 1
    worker = SCHEMES[scheme]
    paths = list(paths) if paths is not None else find_midi_files(input_dir)
    os.makedirs(output_dir, exist_ok=True)
    quarantine_path = os.path.join(output_dir, "quarantine.jsonl")
    if os.path.exists(quarantine_path):
        os.remove(quarantine_path)  # fresh run, fresh failure log
    stats = CorpusStats(n_files=len(paths))
    # the native codecs build here, once, before any worker starts: a
    # failed build raises rather than quarantine every file
    native.available()

    results: List[Tuple[str, Dict[str, np.ndarray]]] = []
    shard_idx = 0

    def flush():
        nonlocal shard_idx, results
        if not results:
            return
        shard_path = os.path.join(
            output_dir, f"{scheme}-{shard_idx:05d}.npz")
        _write_shard(shard_path, results)
        stats.shards.append(shard_path)
        shard_idx += 1
        results = []

    def consume(path: str, out: Optional[Dict[str, np.ndarray]],
                err: Optional[str]):
        if err is not None:
            stats.n_failed += 1
            with open(quarantine_path, "a") as f:
                f.write(json.dumps({"path": path, "error": err}) + "\n")
            return
        stats.n_ok += 1
        stats.n_tokens += int(sum(v.size for v in out.values()))
        results.append((os.path.basename(path), out))
        if len(results) >= shard_size:
            flush()

    if num_workers <= 1:
        for path in paths:
            try:
                consume(path, worker(path), None)
            except Exception as e:  # noqa: BLE001 — quarantine, don't die
                consume(path, None, f"{type(e).__name__}: {e}")
    else:
        # spawn, not fork: the parent may hold CUDA state and threads
        import multiprocessing as mp
        with ProcessPoolExecutor(
                num_workers, mp_context=mp.get_context("spawn")) as pool:
            futures = [(p, pool.submit(worker, p)) for p in paths]
            for path, fut in futures:
                try:
                    consume(path, fut.result(), None)
                except Exception as e:  # noqa: BLE001
                    consume(path, None, f"{type(e).__name__}: {e}")
    flush()

    manifest = {
        "scheme": scheme, "n_files": stats.n_files, "n_ok": stats.n_ok,
        "n_failed": stats.n_failed, "n_tokens": stats.n_tokens,
        "shards": [os.path.basename(s) for s in stats.shards],
    }
    with open(os.path.join(output_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return stats


def _write_shard(path: str,
                 results: List[Tuple[str, Dict[str, np.ndarray]]]) -> None:
    keys = results[0][1].keys()
    payload: Dict[str, np.ndarray] = {
        "names": np.asarray([name for name, _ in results])
    }
    for key in keys:
        arrays = [out[key] for _, out in results]
        offsets = np.zeros(len(arrays) + 1, np.int64)
        np.cumsum([a.size for a in arrays], out=offsets[1:])
        payload[f"{key}_data"] = (np.concatenate(arrays) if arrays
                                  else np.zeros(0, np.uint16))
        payload[f"{key}_offsets"] = offsets
    tmp = path + ".tmp.npz"
    np.savez(tmp.removesuffix(".npz"), **payload)
    os.replace(tmp, path)


class TokenCorpus:
    """Lazy view over the packed shards of one tokenized corpus
    (reference ``Event_Dataset(root, limlen)``, utils/data.py:49-72:
    sequences shorter than ``limlen`` are left out). Shard members are
    decoded on first access and cached per (shard, member)."""

    def __init__(self, root: str, limlen: int = 0, key: str = "tokens"):
        self.root = root
        self.key = key
        manifest_path = os.path.join(root, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                self.manifest = json.load(f)
            shard_names = self.manifest["shards"]
        else:
            self.manifest = None
            shard_names = sorted(n for n in os.listdir(root)
                                 if n.endswith(".npz"))
        self._shards = [np.load(os.path.join(root, n), mmap_mode="r")
                        for n in shard_names]
        self._cache: Dict[Tuple[int, str], np.ndarray] = {}
        self._index: List[Tuple[int, int]] = []  # (shard, row)
        for si in range(len(self._shards)):
            lens = np.diff(self._member(si, f"{key}_offsets"))
            for row in np.nonzero(lens >= limlen)[0]:
                self._index.append((si, int(row)))

    def _member(self, si: int, name: str) -> np.ndarray:
        k = (si, name)
        if k not in self._cache:
            self._cache[k] = self._shards[si][name]
        return self._cache[k]

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.pair(i, self.key)

    def pair(self, i: int, stream_key: str) -> np.ndarray:
        """A stream for file i — ``self.key`` or a parallel one."""
        si, row = self._index[i]
        offs = self._member(si, f"{stream_key}_offsets")
        return self._member(si, f"{stream_key}_data")[
            offs[row]:offs[row + 1]]

    def name(self, i: int) -> str:
        si, row = self._index[i]
        return str(self._member(si, "names")[row])

    def lengths(self) -> np.ndarray:
        return np.asarray([len(self[i]) for i in range(len(self))])

    def count(self, v: int) -> float:
        """Fraction of sequences shorter than v (data.py:66-72)."""
        lens = self.lengths()
        return float((lens < v).mean()) if lens.size else 0.0

    def sequences(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


# ---------------------------------------------------------------------------
# dataset splitters
# ---------------------------------------------------------------------------

def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def split_ratio(paths: Sequence[str], out_root: str,
                ratios=(0.8, 0.1, 0.1)) -> Dict[str, List[str]]:
    """GiantMIDI-style 80/10/10 split by listing order
    (Giant-MIDI_generate.py:24-35): files are hard-linked (or copied where
    a link fails) into out_root/{train,valid,test}; a file already there
    is kept."""
    n = len(paths)
    n_train = int(n * ratios[0])
    n_valid = int(n * ratios[1])
    splits = {
        "train": list(paths[:n_train]),
        "valid": list(paths[n_train:n_train + n_valid]),
        "test": list(paths[n_train + n_valid:]),
    }
    for split, files in splits.items():
        d = os.path.join(out_root, split)
        os.makedirs(d, exist_ok=True)
        for src in files:
            dst = os.path.join(d, os.path.basename(src))
            if not os.path.exists(dst):
                _link_or_copy(src, dst)
    return splits


def split_maestro(csv_path: str, midi_root: str,
                  out_root: str) -> Dict[str, List[str]]:
    """MAESTRO's official split by the CSV's ``split`` column
    (maestro_generate.py:21-44), read with the stdlib ``csv``. Returns
    the destination paths of each split; a listed file missing under
    ``midi_root`` is listed but not linked."""
    splits: Dict[str, List[str]] = {"train": [], "validation": [], "test": []}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            splits.setdefault(row["split"], []).append(row["midi_filename"])
    out: Dict[str, List[str]] = {}
    for split, rels in splits.items():
        d = os.path.join(out_root, split)
        os.makedirs(d, exist_ok=True)
        out[split] = []
        for rel in rels:
            src = os.path.join(midi_root, rel)
            dst = os.path.join(d, os.path.basename(rel))
            out[split].append(dst)
            if not os.path.exists(dst) and os.path.exists(src):
                _link_or_copy(src, dst)
    return out
