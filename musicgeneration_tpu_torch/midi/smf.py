"""Standard MIDI File (SMF) binary reader / writer — first-party.

The environment ships no MIDI library, so this module implements the subset
of SMF needed by the tokenizer layer (and a bit more):

* header parsing (format 0/1, division),
* all channel messages (note on/off, CC, program change, pitch bend, ...),
* meta events: set_tempo, track name, marker, time signature, end-of-track,
* running status, variable-length quantities,
* note on/off pairing into `Note` objects (pretty_midi semantics: a note-off
  closes *all* open notes of that (channel, pitch); zero-length notes are
  dropped — reference behaviour relied on by mg/model/utils/sequence.py:52-55),
* instrument grouping per (track, channel, program) with drum channel 10,
* writing format-1 files with a dedicated tempo track.

A copy of ``musicgeneration_tpu/midi/smf.py``: the port's own C++
scanner (``native/smf_scan.cc``) parses each file, and this pure-Python
path is taken under ``MG_NATIVE=0`` or where the scanner reports an
error for a file; it is the semantics oracle for tests.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .containers import (
    ControlChange,
    Instrument,
    Marker,
    Note,
    TempoChange,
    TimeSignature,
)
from .. import native
from .timing import DEFAULT_US_PER_QN, TempoMap

DRUM_CHANNEL = 9


# ----------------------------------------------------------------------------
# Low-level binary helpers
# ----------------------------------------------------------------------------

def _read_vlq(data: bytes, pos: int) -> Tuple[int, int]:
    """Variable-length quantity. Returns (value, new_pos)."""
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def _write_vlq(value: int) -> bytes:
    if value < 0:
        raise ValueError("negative VLQ")
    out = [value & 0x7F]
    value >>= 7
    while value:
        out.append(0x80 | (value & 0x7F))
        value >>= 7
    return bytes(reversed(out))


# ----------------------------------------------------------------------------
# Raw event scan
# ----------------------------------------------------------------------------

class RawTrack:
    """Flat arrays of the events a track contains, in file order."""

    __slots__ = (
        "note_events",  # list of (tick, channel, pitch, velocity, is_on)
        "tempo",        # list of (tick, us_per_qn)
        "control",      # list of (tick, channel, number, value)
        "program",      # list of (tick, channel, program)
        "markers",      # list of (tick, text)
        "time_sigs",    # list of (tick, numerator, denominator)
        "name",
    )

    def __init__(self):
        self.note_events = []
        self.tempo = []
        self.control = []
        self.program = []
        self.markers = []
        self.time_sigs = []
        self.name = ""


def _scan_track(data: bytes) -> RawTrack:
    track = RawTrack()
    pos = 0
    tick = 0
    status = 0
    n = len(data)
    while pos < n:
        delta, pos = _read_vlq(data, pos)
        tick += delta
        b = data[pos]
        if b & 0x80:
            status = b
            pos += 1
        # else: running status — reuse previous status byte
        ev = status & 0xF0
        ch = status & 0x0F
        if ev == 0x90:  # note on
            pitch = data[pos]
            vel = data[pos + 1]
            pos += 2
            track.note_events.append((tick, ch, pitch, vel, vel > 0))
        elif ev == 0x80:  # note off
            pitch = data[pos]
            pos += 2
            track.note_events.append((tick, ch, pitch, 0, False))
        elif ev == 0xB0:  # control change
            track.control.append((tick, ch, data[pos], data[pos + 1]))
            pos += 2
        elif ev == 0xC0:  # program change
            track.program.append((tick, ch, data[pos]))
            pos += 1
        elif ev in (0xA0, 0xE0):  # aftertouch, pitch bend: skip 2 bytes
            pos += 2
        elif ev == 0xD0:  # channel pressure: skip 1
            pos += 1
        elif status == 0xFF:  # meta
            meta_type = data[pos]
            pos += 1
            length, pos = _read_vlq(data, pos)
            payload = data[pos:pos + length]
            pos += length
            if meta_type == 0x51 and length == 3:
                if len(payload) < 3:
                    break  # truncated inside tempo payload: stop the track
                us = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                track.tempo.append((tick, us))
            elif meta_type == 0x03 and not track.name:
                track.name = payload.decode("latin-1", errors="replace")
            elif meta_type == 0x06:
                track.markers.append(
                    (tick, payload.decode("latin-1", errors="replace"))
                )
            elif meta_type == 0x58 and length >= 2:
                track.time_sigs.append((tick, payload[0], 1 << payload[1]))
            elif meta_type == 0x2F:
                break  # end of track
        elif status in (0xF0, 0xF7):  # sysex
            length, pos = _read_vlq(data, pos)
            pos += length
        else:
            raise ValueError(f"unhandled MIDI status byte 0x{status:02x}")
    return track


# ----------------------------------------------------------------------------
# MidiFile
# ----------------------------------------------------------------------------

class MidiFile:
    """Parsed MIDI file. Notes are stored in TICKS (lossless canonical form);
    use `to_seconds()` for the pretty_midi-style seconds view."""

    def __init__(self, path: Optional[str] = None, ticks_per_beat: int = 480):
        self.ticks_per_beat = ticks_per_beat
        self.instruments: List[Instrument] = []
        self.tempo_changes: List[TempoChange] = []
        self.time_signature_changes: List[TimeSignature] = []
        self.markers: List[Marker] = []
        self.max_tick = 0
        if path is not None:
            with open(path, "rb") as f:
                self._parse(f.read())

    # -- parsing -------------------------------------------------------------

    def _parse(self, data: bytes) -> None:
        if os.environ.get("MG_NATIVE", "1") != "0":
            parsed = native.parse_midi_bytes(data)
            if parsed is not None:
                self._build_from_native(parsed, data)
                return
        if data[:4] != b"MThd":
            # Some files have junk before the header; search for it.
            idx = data.find(b"MThd")
            if idx < 0:
                raise ValueError("not a MIDI file (no MThd)")
            data = data[idx:]
        hlen, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        self.ticks_per_beat = division
        pos = 8 + hlen
        raw_tracks: List[RawTrack] = []
        for _ in range(ntracks):
            if pos + 8 > len(data):
                break  # truncated file: parse what we have
            if data[pos:pos + 4] != b"MTrk":
                # skip unknown chunk
                clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
                pos += 8 + clen
                continue
            clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            raw_tracks.append(_scan_track(data[pos + 8:pos + 8 + clen]))
            pos += 8 + clen
        self._build(raw_tracks)

    def _build(self, raw_tracks: List[RawTrack]) -> None:
        tempo: List[Tuple[int, int]] = []
        for tr in raw_tracks:
            tempo.extend(tr.tempo)
            for tick, text in tr.markers:
                self.markers.append(Marker(text=text, time=tick))
            for tick, num, den in tr.time_sigs:
                self.time_signature_changes.append(TimeSignature(num, den, tick))
        tempo.sort(key=lambda x: x[0])
        self._tempo_raw = tempo
        self.tempo_changes = [
            TempoChange(tempo=60e6 / us, time=tick) for tick, us in tempo
        ] or [TempoChange(tempo=60e6 / DEFAULT_US_PER_QN, time=0)]

        max_tick = 0
        for tr in raw_tracks:
            # program per channel over time (sorted once per track)
            prog_by_channel: Dict[int, List[Tuple[int, int]]] = {}
            for tick, ch, prog in tr.program:
                prog_by_channel.setdefault(ch, []).append((tick, prog))
            # open-note registry: (channel, pitch) -> [(start_tick, velocity)]
            open_notes: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
            # instruments created lazily per (channel, program)
            insts: Dict[Tuple[int, int], Instrument] = {}

            def _program_at(ch: int, tick: int) -> int:
                progs = prog_by_channel.get(ch)
                if not progs:
                    return 0
                p = 0
                for t, pr in progs:
                    if t <= tick:
                        p = pr
                    else:
                        break
                return p

            def _inst(ch: int, tick: int) -> Instrument:
                prog = _program_at(ch, tick)
                key = (ch, prog)
                if key not in insts:
                    insts[key] = Instrument(
                        program=prog, is_drum=(ch == DRUM_CHANNEL), name=tr.name
                    )
                return insts[key]

            for tick, ch, pitch, vel, is_on in tr.note_events:
                key = (ch, pitch)
                if is_on:
                    open_notes.setdefault(key, []).append((tick, vel))
                else:
                    stack = open_notes.get(key)
                    if not stack:
                        continue
                    keep = []
                    for start_tick, svel in stack:
                        if tick > start_tick:
                            _inst(ch, start_tick).notes.append(
                                Note(velocity=svel, pitch=pitch,
                                     start=start_tick, end=tick)
                            )
                        else:
                            keep.append((start_tick, svel))
                    if keep:
                        open_notes[key] = keep
                    else:
                        del open_notes[key]
                max_tick = max(max_tick, tick)
            # orphan note-ons: close at track end (pretty_midi drops them;
            # we keep parity by dropping too)
            for tick, ch, number, value in tr.control:
                _inst(ch, tick).control_changes.append(
                    ControlChange(number=number, value=value, time=tick)
                )
            for inst in insts.values():
                if inst.notes or inst.control_changes:
                    inst.notes.sort(key=lambda n: (n.start, n.pitch))
                    self.instruments.append(inst)
        self.max_tick = max(
            [max_tick]
            + [int(n.end) for i in self.instruments for n in i.notes[-64:]]
        )

    def _build_from_native(self, p, data: bytes) -> None:
        """Reconstruct from the C++ scanner's flat arrays (native/smf_scan.cc).

        Mirrors _build exactly: instrument keys are (track, channel,
        program-at-first-event), created in first-occurrence order with
        notes before controls within a track; notes sorted (start, pitch).
        """
        self.ticks_per_beat = p["ticks_per_beat"]
        self._tempo_raw = [(int(t), int(us)) for t, us in p["tempos"]]
        self.tempo_changes = [
            TempoChange(tempo=60e6 / us, time=tick)
            for tick, us in self._tempo_raw
        ] or [TempoChange(tempo=60e6 / DEFAULT_US_PER_QN, time=0)]

        names: Dict[int, str] = {}
        for track, tick, typ, off, ln in p["metas"]:
            payload = data[off:off + ln]
            if typ == 0x03:
                names.setdefault(int(track),
                                 payload.decode("latin-1",
                                                errors="replace"))
            elif typ == 0x06:
                self.markers.append(Marker(
                    text=payload.decode("latin-1", errors="replace"),
                    time=int(tick)))
            elif typ == 0x58 and ln >= 2:
                self.time_signature_changes.append(
                    TimeSignature(int(payload[0]), 1 << payload[1],
                                  int(tick)))

        notes = p["notes"]       # [n,7] track,ch,prog,pitch,vel,start,end
        controls = p["controls"]  # [n,6] track,ch,prog,number,value,tick
        # first-occurrence instrument order: per track, notes then controls
        nk = notes[:, 0] * (16 * 128) + notes[:, 1] * 128 + notes[:, 2]
        ck = (controls[:, 0] * (16 * 128) + controls[:, 1] * 128
              + controls[:, 2])
        allk = np.concatenate([nk, ck])
        is_ctrl = np.concatenate([np.zeros(len(nk), np.int64),
                                  np.ones(len(ck), np.int64)])
        track_of = np.concatenate([notes[:, 0], controls[:, 0]])
        seq = np.concatenate([np.arange(len(nk)), np.arange(len(ck))])
        order = np.lexsort((seq, is_ctrl, track_of))
        _, first_pos = np.unique(allk[order], return_index=True)
        key_order = allk[order][np.sort(first_pos)]

        insts: Dict[int, Instrument] = {}
        for key in key_order:
            track, rem = divmod(int(key), 16 * 128)
            ch, prog = divmod(rem, 128)
            insts[int(key)] = Instrument(
                program=prog, is_drum=(ch == DRUM_CHANNEL),
                name=names.get(track, ""))
        for key, inst in insts.items():
            rows = notes[nk == key]
            if len(rows):
                srt = np.lexsort((rows[:, 3], rows[:, 5]))  # (start, pitch)
                inst.notes = [
                    Note(velocity=int(v), pitch=int(pt), start=int(s),
                         end=int(e))
                    for pt, v, s, e in zip(rows[srt, 3], rows[srt, 4],
                                           rows[srt, 5], rows[srt, 6])
                ]
            crows = controls[ck == key]
            inst.control_changes = [
                ControlChange(number=int(nu), value=int(va), time=int(t))
                for nu, va, t in zip(crows[:, 3], crows[:, 4], crows[:, 5])
            ]
            self.instruments.append(inst)
        self.max_tick = max(
            [int(p["max_tick"])]
            + [int(n.end) for i in self.instruments for n in i.notes[-64:]]
        )

    # -- views ---------------------------------------------------------------

    def tempo_map(self) -> TempoMap:
        raw = getattr(self, "_tempo_raw", None) or []
        return TempoMap(raw, self.ticks_per_beat)

    def to_seconds(self) -> "MidiFile":
        """Return a copy whose note/CC times are float seconds
        (pretty_midi-style view used by the MIDI-like tokenizer)."""
        tm = self.tempo_map()
        out = MidiFile(ticks_per_beat=self.ticks_per_beat)
        out.tempo_changes = list(self.tempo_changes)
        out._tempo_raw = getattr(self, "_tempo_raw", [])
        out.markers = list(self.markers)
        for inst in self.instruments:
            ni = Instrument(inst.program, inst.is_drum, inst.name)
            if inst.notes:
                starts = tm.tick_to_time([n.start for n in inst.notes])
                ends = tm.tick_to_time([n.end for n in inst.notes])
                ni.notes = [
                    Note(velocity=n.velocity, pitch=n.pitch,
                         start=float(s), end=float(e))
                    for n, s, e in zip(inst.notes, starts, ends)
                ]
            if inst.control_changes:
                times = tm.tick_to_time([c.time for c in inst.control_changes])
                ni.control_changes = [
                    ControlChange(number=c.number, value=c.value, time=float(t))
                    for c, t in zip(inst.control_changes, times)
                ]
            out.instruments.append(ni)
        return out

    # -- writing -------------------------------------------------------------

    def dump(self, path: str) -> None:
        """Write a format-1 SMF: track 0 = tempo/markers, then one track per
        instrument."""
        chunks: List[bytes] = []

        # conductor track
        events: List[Tuple[int, int, bytes]] = []  # (tick, order, payload)
        for tc in self.tempo_changes:
            us = int(round(60e6 / tc.tempo))
            events.append(
                (int(tc.time), 0,
                 bytes([0xFF, 0x51, 0x03]) + us.to_bytes(3, "big"))
            )
        for ts in self.time_signature_changes:
            den_pow = max(0, int(ts.denominator).bit_length() - 1)
            events.append(
                (int(ts.time), 1,
                 bytes([0xFF, 0x58, 0x04, ts.numerator, den_pow, 24, 8]))
            )
        for mk in self.markers:
            text = mk.text.encode("latin-1", errors="replace")
            events.append(
                (int(mk.time), 2,
                 bytes([0xFF, 0x06]) + _write_vlq(len(text)) + text)
            )
        chunks.append(self._track_chunk(events))

        next_channel = 0
        for inst in self.instruments:
            if inst.is_drum:
                ch = DRUM_CHANNEL
            else:
                ch = next_channel
                next_channel += 1
                if next_channel == DRUM_CHANNEL:
                    next_channel += 1
                if next_channel > 15:
                    next_channel = 0
            events = []
            if inst.name:
                name = inst.name.encode("latin-1", errors="replace")
                events.append(
                    (0, 0, bytes([0xFF, 0x03]) + _write_vlq(len(name)) + name)
                )
            events.append((0, 1, bytes([0xC0 | ch, inst.program & 0x7F])))
            for cc in inst.control_changes:
                events.append(
                    (int(cc.time), 2,
                     bytes([0xB0 | ch, cc.number & 0x7F, cc.value & 0x7F]))
                )
            for note in inst.notes:
                pitch = int(note.pitch) & 0x7F
                vel = max(1, min(127, int(note.velocity)))
                start, end = int(note.start), int(note.end)
                if end <= start:
                    end = start + 1
                events.append((start, 3, bytes([0x90 | ch, pitch, vel])))
                events.append((end, 2, bytes([0x80 | ch, pitch, 64])))
            chunks.append(self._track_chunk(events))

        with open(path, "wb") as f:
            f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks),
                                          self.ticks_per_beat))
            for c in chunks:
                f.write(c)

    @staticmethod
    def _track_chunk(events: List[Tuple[int, int, bytes]]) -> bytes:
        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        last_tick = 0
        for tick, _, payload in events:
            out += _write_vlq(max(0, tick - last_tick))
            out += payload
            last_tick = tick
        out += _write_vlq(0) + bytes([0xFF, 0x2F, 0x00])
        return b"MTrk" + struct.pack(">I", len(out)) + bytes(out)

    def __repr__(self) -> str:
        return (
            f"MidiFile(tpb={self.ticks_per_beat}, "
            f"instruments={self.instruments}, "
            f"tempo_changes={len(self.tempo_changes)})"
        )
