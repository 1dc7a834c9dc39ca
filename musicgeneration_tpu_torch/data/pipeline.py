"""Offline tokenization pipeline: MIDI corpus -> packed token shards.

The port of ``musicgeneration_tpu/data/pipeline.py`` for the MIDI-like
and CP schemes, through the port's own codecs (``tokenizers/midilike.py``,
``tokenizers/cp.py``; a CP file's [T, 8] rows are stored flattened). The
shard layout and ``manifest.json`` are the JAX package's, so each package
reads the other's corpora: shard ``midilike-00000.npz`` holds, for the
stream key ``tokens``,

    tokens_data    — 1-D uint16 concatenation of all sequences
    tokens_offsets — int64 [n+1]; file i is tokens_data[offsets[i]:offsets[i+1]]

plus ``names``, the source file basenames. Files that fail to tokenize
land in ``quarantine.jsonl`` with the exception text; shards are written
atomically (tmp + rename).
"""

from __future__ import annotations

import dataclasses
import json
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

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
    return {"tokens": midilike.extract_events(path).to_array()
            .astype(np.uint16)}


def _tokenize_cp(path: str) -> Dict[str, np.ndarray]:
    """Compound Word rows [T, 8] stored flattened (width 8 is fixed by the
    scheme; reshape(-1, 8) on load)."""
    from ..tokenizers import cp
    return {"tokens": cp.encode_rows(path).reshape(-1)}


SCHEMES: Dict[str, Callable[[str], Dict[str, np.ndarray]]] = {
    "midilike": _tokenize_midilike,
    "cp": _tokenize_cp,
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
