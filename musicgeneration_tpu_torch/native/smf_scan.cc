// Native SMF (Standard MIDI File) scanner — the tokenizer pipeline's hot
// loop (byte-level VLQ/event parsing + note on/off pairing), in C++.
//
// Semantics mirror the pure-Python oracle in musicgeneration_tpu_torch/midi/smf.py
// (_scan_track / _build) exactly; tests compare both paths file-by-file:
//   * running status, VLQ deltas, meta/sysex handling, end-of-track break,
//   * junk-before-MThd recovery, unknown chunk skip, truncated-file grace,
//   * pretty_midi note pairing: a note-off closes ALL open notes of that
//     (channel, pitch) with off_tick > start (zero-length dropped),
//     orphan note-ons are dropped,
//   * program-change resolution at the note's START tick (smf.py _program_at),
//   * unhandled status bytes abort the parse (error=1) so the Python
//     fallback can take over.
//
// C ABI (ctypes): one mg_parse() per file buffer, results in flat arrays
// the Python wrapper turns into numpy views and groups vectorized.
//
// Build: at first use, by musicgeneration_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -fPIC -shared, into musicgeneration_tpu_torch/_build/)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Cursor {
    const uint8_t* data;
    int64_t n;
    int64_t pos = 0;
    bool ok = true;

    uint8_t peek() {
        if (pos >= n) { ok = false; return 0; }
        return data[pos];
    }
    uint8_t take() {
        if (pos >= n) { ok = false; return 0; }
        return data[pos++];
    }
    int64_t vlq() {
        int64_t v = 0;
        for (int i = 0; i < 8; ++i) {
            uint8_t b = take();
            if (!ok) return 0;
            v = (v << 7) | (b & 0x7F);
            if (!(b & 0x80)) break;
        }
        return v;
    }
};

struct OpenNote { int64_t start; int32_t vel; };

}  // namespace

extern "C" {

struct MgParse {
    // notes: [n, 7] = track, channel, program, pitch, velocity, start, end
    int64_t* notes; int64_t n_notes;
    // controls: [n, 6] = track, channel, program, number, value, tick
    int64_t* controls; int64_t n_controls;
    // tempos: [n, 2] = tick, us_per_quarter  (already merged + stable-sorted)
    int64_t* tempos; int64_t n_tempos;
    // metas: [n, 5] = track, tick, type, payload_offset, payload_len
    //   (type 0x03 track name, 0x06 marker, 0x58 time signature — payload
    //    decoded by the Python wrapper from the original buffer)
    int64_t* metas; int64_t n_metas;
    int32_t n_tracks;
    int32_t ticks_per_beat;
    int64_t max_tick;
    int32_t error;  // 0 ok; 1 unhandled status; 2 not midi; 3 smpte
};

static int64_t* flat(const std::vector<int64_t>& v) {
    auto* p = static_cast<int64_t*>(std::malloc(
        v.size() * sizeof(int64_t) + 1));
    std::memcpy(p, v.data(), v.size() * sizeof(int64_t));
    return p;
}

MgParse* mg_parse(const uint8_t* data, int64_t n) {
    auto* out = static_cast<MgParse*>(std::calloc(1, sizeof(MgParse)));

    // header (with junk-prefix recovery)
    int64_t start = -1;
    for (int64_t i = 0; i + 14 <= n; ++i) {
        if (std::memcmp(data + i, "MThd", 4) == 0) { start = i; break; }
    }
    if (start < 0) { out->error = 2; return out; }
    const uint8_t* d = data + start;
    int64_t nn = n - start;
    auto be32 = [&](int64_t p) -> uint32_t {
        return (uint32_t(d[p]) << 24) | (uint32_t(d[p + 1]) << 16) |
               (uint32_t(d[p + 2]) << 8) | uint32_t(d[p + 3]);
    };
    auto be16 = [&](int64_t p) -> uint32_t {
        return (uint32_t(d[p]) << 8) | uint32_t(d[p + 1]);
    };
    uint32_t hlen = be32(4);
    uint32_t ntracks = be16(10);
    uint32_t division = be16(12);
    if (division & 0x8000) { out->error = 3; return out; }
    out->ticks_per_beat = static_cast<int32_t>(division);

    std::vector<int64_t> notes, controls, tempos, metas;
    int64_t max_tick = 0;
    int64_t pos = 8 + hlen;
    int32_t track_idx = 0;

    for (uint32_t ti = 0; ti < ntracks; ++ti) {
        if (pos + 8 > nn) break;  // truncated: parse what we have
        if (std::memcmp(d + pos, "MTrk", 4) != 0) {
            pos += 8 + be32(pos + 4);
            continue;
        }
        int64_t clen = be32(pos + 4);
        int64_t tstart = pos + 8;
        int64_t tend = tstart + clen;
        if (tend > nn) tend = nn;
        Cursor c{d + tstart, tend - tstart};

        // per-track state (smf.py _build is per-track)
        // program changes per channel: (tick, program) in order
        std::vector<std::pair<int64_t, int32_t>> progs[16];
        std::vector<OpenNote> open[16][128];
        int64_t tick = 0;
        uint8_t status = 0;

        auto program_at = [&](int ch, int64_t t) -> int32_t {
            int32_t p = 0;
            for (auto& pr : progs[ch]) {
                if (pr.first <= t) p = pr.second; else break;
            }
            return p;
        };

        while (c.pos < c.n && c.ok) {
            tick += c.vlq();
            if (!c.ok) break;
            uint8_t b = c.peek();
            if (b & 0x80) { status = b; c.pos++; }
            uint8_t ev = status & 0xF0;
            int ch = status & 0x0F;
            if (ev == 0x90 || ev == 0x80) {
                uint8_t pitch = c.take() & 0x7F;
                uint8_t vel = (ev == 0x90) ? c.take() : (c.take(), 0);
                if (!c.ok) break;
                bool is_on = (ev == 0x90) && vel > 0;
                if (is_on) {
                    open[ch][pitch].push_back({tick, vel});
                } else {
                    auto& stack = open[ch][pitch];
                    if (!stack.empty()) {
                        std::vector<OpenNote> keep;
                        for (auto& onote : stack) {
                            if (tick > onote.start) {
                                notes.insert(notes.end(), {
                                    track_idx, ch,
                                    program_at(ch, onote.start),
                                    pitch, onote.vel, onote.start, tick});
                            } else {
                                keep.push_back(onote);
                            }
                        }
                        stack.swap(keep);
                    }
                }
                if (tick > max_tick) max_tick = tick;
            } else if (ev == 0xB0) {
                uint8_t num = c.take();
                uint8_t val = c.take();
                if (!c.ok) break;
                controls.insert(controls.end(), {
                    track_idx, ch, -1 /*program filled on flush*/,
                    num, val, tick});
            } else if (ev == 0xC0) {
                uint8_t prog = c.take();
                if (!c.ok) break;
                progs[ch].push_back({tick, prog});
            } else if (ev == 0xA0 || ev == 0xE0) {
                c.pos += 2;
            } else if (ev == 0xD0) {
                c.pos += 1;
            } else if (status == 0xFF) {
                uint8_t meta_type = c.take();
                int64_t len = c.vlq();
                if (!c.ok) break;
                int64_t payload = start + tstart + c.pos;
                if (meta_type == 0x51 && len == 3) {
                    // guard: a file truncated inside the tempo payload must
                    // not read past the buffer (corpus MIDI is untrusted)
                    if (c.pos + 3 > c.n) break;
                    int64_t us = (int64_t(c.data[c.pos]) << 16) |
                                 (int64_t(c.data[c.pos + 1]) << 8) |
                                 int64_t(c.data[c.pos + 2]);
                    tempos.insert(tempos.end(), {tick, us});
                } else if (meta_type == 0x03 || meta_type == 0x06 ||
                           meta_type == 0x58) {
                    metas.insert(metas.end(), {
                        track_idx, tick, meta_type, payload, len});
                }
                c.pos += len;
                if (meta_type == 0x2F) break;  // end of track
            } else if (status == 0xF0 || status == 0xF7) {
                int64_t len = c.vlq();
                c.pos += len;
            } else {
                out->error = 1;  // unhandled status -> Python fallback
                return out;
            }
        }
        // resolve control programs now that the track's changes are known
        // (controls were recorded before later program changes could land,
        //  matching Python which resolves per-track after the scan)
        for (int64_t i = (int64_t)controls.size() - 6; i >= 0; i -= 6) {
            if (controls[i] != track_idx) break;
            controls[i + 2] = program_at((int)controls[i + 1],
                                         controls[i + 5]);
        }
        pos += 8 + clen;
        track_idx++;
    }

    // stable sort tempos by tick (python: tempo.sort by tick, stable)
    std::vector<std::pair<int64_t, int64_t>> tp;
    for (size_t i = 0; i + 1 < tempos.size(); i += 2)
        tp.push_back({tempos[i], tempos[i + 1]});
    std::stable_sort(tp.begin(), tp.end(),
                     [](auto& a, auto& b) { return a.first < b.first; });
    tempos.clear();
    for (auto& t : tp) { tempos.push_back(t.first); tempos.push_back(t.second); }

    out->notes = flat(notes); out->n_notes = notes.size() / 7;
    out->controls = flat(controls); out->n_controls = controls.size() / 6;
    out->tempos = flat(tempos); out->n_tempos = tempos.size() / 2;
    out->metas = flat(metas); out->n_metas = metas.size() / 5;
    out->n_tracks = track_idx;
    out->max_tick = max_tick;
    return out;
}

void mg_free(MgParse* p) {
    if (!p) return;
    std::free(p->notes);
    std::free(p->controls);
    std::free(p->tempos);
    std::free(p->metas);
    std::free(p);
}

// MIDI-like event emission (the tokenizer hot loop after SMF parsing).
//
// Exact C++ transcription of the reference algorithm
// (mg/model/utils/sequence.py:145-183), oracle-tested against the Python
// EventSeq.from_note_seq in tests/test_native_smf.py:
//   * per note IN CALLER ORDER: clip velocity to [vel_lo, vel_hi-1],
//     velocity index = searchsorted-left over vel_bins, emit
//     (velocity, note_on) at start and note_off at end; pitches outside
//     [pitch_lo, pitch_hi) are dropped (:151-163),
//   * stable sort all events by time (:164),
//   * between consecutive events greedily emit time_shift tokens:
//     index = searchsorted-right(bins, remainder) - 1 while remainder >=
//     bins[0] (:174-181) — IEEE-double identical to the numpy loop.
//
// Bin arrays and token-id offsets are PASSED IN from the Python vocab
// spec so the constants live in exactly one place. Returns the token
// count, or -1 if `cap` is too small (caller falls back to Python).
int64_t mg_encode_midilike(
    const double* starts, const double* ends,
    const int64_t* pitches, const int64_t* vels, int64_t n,
    const double* vel_bins, int64_t n_vel,
    const double* ts_bins, int64_t n_ts,
    int64_t pitch_lo, int64_t pitch_hi,
    int64_t vel_lo, int64_t vel_hi,
    int64_t off_on, int64_t off_off, int64_t off_vel, int64_t off_ts,
    uint16_t* out, int64_t cap) {
    struct Ev { double t; uint16_t tok; };
    std::vector<Ev> evs;
    evs.reserve(static_cast<size_t>(3 * n));
    for (int64_t i = 0; i < n; ++i) {
        int64_t p = pitches[i];
        if (p < pitch_lo || p >= pitch_hi) continue;
        int64_t v = vels[i];
        if (v < vel_lo) v = vel_lo;
        if (v > vel_hi - 1) v = vel_hi - 1;
        int64_t vi = std::lower_bound(vel_bins, vel_bins + n_vel,
                                      static_cast<double>(v)) - vel_bins;
        evs.push_back({starts[i], static_cast<uint16_t>(off_vel + vi)});
        evs.push_back({starts[i],
                       static_cast<uint16_t>(off_on + (p - pitch_lo))});
        evs.push_back({ends[i],
                       static_cast<uint16_t>(off_off + (p - pitch_lo))});
    }
    std::stable_sort(evs.begin(), evs.end(),
                     [](const Ev& a, const Ev& b) { return a.t < b.t; });
    int64_t m = 0;
    if (n_ts <= 0) return -1;
    const double bin0 = ts_bins[0];
    for (size_t i = 0; i < evs.size(); ++i) {
        if (m >= cap) return -1;
        out[m++] = evs[i].tok;
        if (i + 1 == evs.size()) break;
        double interval = evs[i + 1].t - evs[i].t;
        double shift = 0.0;
        while (interval - shift >= bin0) {
            int64_t idx = (std::upper_bound(ts_bins, ts_bins + n_ts,
                                            interval - shift) - ts_bins) - 1;
            if (m >= cap) return -1;
            out[m++] = static_cast<uint16_t>(off_ts + idx);
            shift += ts_bins[idx];
        }
    }
    return m;
}

// ---------------------------------------------------------------------------
// REMI full-file tokenization: parse -> instrument-0 notes -> quantize ->
// chord inference -> bar grouping -> token emission, all in C++.
//
// Exact C++ transcription of the vectorized Python pipeline in
// tokenizers/remi.py:encode_array (itself parity-locked to the reference
// mg/model/utils/REMI.py:64-257 + chord_inference.py), oracle-tested
// file-by-file and by fuzzing in tests/test_native_remi.py:
//   * instrument selection mirrors smf.py _build_from_native: the file's
//     first (track, notes-before-controls, order) key is "instruments[0]",
//   * quantize_items 120-tick grid snap with argmin tie-down (REMI.py:113),
//   * chord inference: per-beat presence, 4- then 2-beat windows, template
//     scores, greedy (score, end) segmentation, ':None' head-strip/merge
//     (chord_inference.py:89-188),
//   * tempo items expanded per beat with EXACT-tick dict lookup
//     (REMI.py:92-110 quirk: off-grid tempo changes are invisible),
//   * bar grouping double-counts items landing exactly on a downbeat
//     (group_items l/r pointers, REMI.py:139-165), bars without notes drop,
//   * velocity searchsorted-right-1 with the <4-slots quirk, pitch clamp to
//     126, duration argmin first-min (REMI.py:196-228 non-strict mode).
//
// Bin arrays / token-id offsets / chord-id table are passed in from the
// Python vocab spec. Returns the token count; -needed when `cap` is too
// small (caller retries); -1 on parse/tempo error (caller falls back to
// the Python oracle path, which raises the matching exception).

namespace {

struct RemiItem {
    int64_t start;
    int8_t kind;  // 0 chord, 1 tempo, 2 note
    int64_t p0, p1, p2;
};

// chord template tables (the algorithm's definition — chord_inference.py:9-31)
const int kQualities = 5;  // maj min dim aug dom
int chord_weight(int q, int n) {
    static int w[5][12];
    static bool init = false;
    if (!init) {
        const int maps[5][4] = {{0, 4, -1, -1}, {0, 3, -1, -1},
                                {0, 3, 6, -1}, {0, 4, 8, -1}, {0, 4, 7, 10}};
        const int ins[5][2] = {{7, -1}, {7, -1}, {9, -1}, {-1, -1}, {-1, -1}};
        const int o1[5][3] = {{2, 5, 9}, {2, 5, 8}, {2, 5, 10},
                              {2, 5, 9}, {2, 5, 9}};
        const int o2[5][5] = {{1, 3, 6, 8, 10}, {1, 4, 6, 9, 11},
                              {1, 4, 7, 8, 11}, {1, 3, 6, 7, 10},
                              {1, 3, 6, 8, 11}};
        for (int qi = 0; qi < 5; ++qi)
            for (int n2 = 0; n2 < 12; ++n2) {
                int v = 0;
                bool member = false;
                for (int k = 0; k < 4; ++k)
                    if (maps[qi][k] == n2) member = true;
                if (!member) {
                    bool hit = false;
                    for (int k = 0; k < 3; ++k)
                        if (o1[qi][k] == n2) { v = -1; hit = true; }
                    if (!hit)
                        for (int k = 0; k < 5; ++k)
                            if (o2[qi][k] == n2) { v = -2; hit = true; }
                    if (!hit)
                        for (int k = 0; k < 2; ++k)
                            if (ins[qi][k] == n2) v = 1;
                }
                w[qi][n2] = v;
            }
        init = true;
    }
    return w[q][n];
}

struct WinResult { int root; int qual; int bass; int score; };
// qual: 0..4 quality, -1 invalid ("None"), 5 empty window ("N:N")

struct NoteRow { int64_t start, end, pitch, vel; int track; };
struct ChordSeg { int64_t start, end; int root, qual; };

WinResult score_window(const uint64_t* bits) {
    WinResult r{-1, 5, -1, 0};
    int low_by_class[12];
    for (int c = 0; c < 12; ++c) low_by_class[c] = 1000;
    int low_pitch = 1000;
    for (int p = 0; p < 128; ++p) {
        if (bits[p >> 6] & (1ull << (p & 63))) {
            if (p < low_pitch) low_pitch = p;
            if (p < low_by_class[p % 12]) low_by_class[p % 12] = p;
        }
    }
    if (low_pitch == 1000) return r;  // empty
    r.bass = low_pitch % 12;
    int best_score = -2000000, best_root = -1, best_low = 1001;
    int quals[12];
    int scores[12];
    for (int root = 0; root < 12; ++root) {
        if (low_by_class[root] == 1000) { scores[root] = -2000000; continue; }
        bool rel[12];
        for (int i = 0; i < 12; ++i)
            rel[i] = low_by_class[(root + i) % 12] < 1000;
        if (rel[3] == rel[4]) {  // both or neither third -> invalid
            scores[root] = -100;
            quals[root] = -1;
        } else {
            int q;
            if (rel[3]) q = rel[6] ? 2 : 1;            // dim : min
            else if (rel[8]) q = 3;                    // aug
            else if (rel[7] && rel[10]) q = 4;         // dom
            else q = 0;                                // maj
            int s = 0;
            for (int i = 0; i < 12; ++i)
                if (rel[i]) s += chord_weight(q, i);
            scores[root] = s;
            quals[root] = q;
        }
    }
    for (int root = 0; root < 12; ++root) {
        if (scores[root] == -2000000) continue;
        // tie-break: reference walks pitches ascending and takes the first
        // tied class == tied class with the minimal lowest pitch
        if (scores[root] > best_score ||
            (scores[root] == best_score && low_by_class[root] < best_low)) {
            best_score = scores[root];
            best_root = root;
            best_low = low_by_class[root];
        }
    }
    r.root = best_root;
    r.qual = quals[best_root];
    r.score = best_score;
    return r;
}

// chords.py MIDIChord.extract: per-beat presence, 4- then 2-beat windows,
// greedy (score, end) segmentation, ':None' head-strip/merge. Shared by
// the REMI and MuMIDI encoders (both call it on their quantized notes).
std::vector<ChordSeg> infer_chords(const std::vector<NoteRow>& notes,
                                   int64_t ticks_per_beat) {
    int64_t max_tick_c = 0;
    for (auto& nt : notes) max_tick_c = std::max(max_tick_c, nt.end);
    int64_t n_beats = std::max<int64_t>(
        (max_tick_c + ticks_per_beat - 1) / ticks_per_beat, 1);
    std::vector<uint64_t> presence(n_beats * 2, 0);
    for (auto& nt : notes) {
        if (nt.end <= nt.start) continue;
        int64_t b0 = nt.start / ticks_per_beat;
        int64_t b1 = (std::min(nt.end, max_tick_c) - 1) / ticks_per_beat;
        int pc = int(nt.pitch & 127);
        for (int64_t b = b0; b <= b1 && b < n_beats; ++b)
            presence[b * 2 + (pc >> 6)] |= 1ull << (pc & 63);
    }
    std::vector<WinResult> res4(n_beats), res2(n_beats);
    for (int pass = 0; pass < 2; ++pass) {
        int64_t interval = pass == 0 ? 4 : 2;
        auto& res = pass == 0 ? res4 : res2;
        for (int64_t b = 0; b < n_beats; ++b) {
            uint64_t bits[2] = {0, 0};
            for (int64_t d = 0; d < interval && b + d < n_beats; ++d) {
                bits[0] |= presence[(b + d) * 2];
                bits[1] |= presence[(b + d) * 2 + 1];
            }
            res[b] = score_window(bits);
        }
    }
    // greedy (score, end) segmentation
    std::vector<ChordSeg> segs;
    int64_t st = 0;
    while (st < max_tick_c) {
        int64_t b = st / ticks_per_beat;
        int64_t end4 = std::min(st + 4 * ticks_per_beat, max_tick_c);
        int64_t end2 = std::min(st + 2 * ticks_per_beat, max_tick_c);
        // candidates sorted by (score, end), take last; the 2-beat entry
        // exists only when its end differs (dict keyed by end)
        bool use2 = end2 != end4 && res2[b].score > res4[b].score;
        const WinResult& w = use2 ? res2[b] : res4[b];
        segs.push_back({st, use2 ? end2 : end4, w.root, w.qual});
        st = use2 ? end2 : end4;
    }
    // strip ':None' heads, merge ':None' into the previous chord
    size_t head = 0;
    while (head < segs.size() && segs[head].qual == -1) {
        if (head + 1 == segs.size()) { segs.clear(); break; }
        segs[head + 1].start = segs[head].start;
        ++head;
    }
    std::vector<ChordSeg> chords;
    for (size_t i = head; i < segs.size(); ++i) {
        if (segs[i].qual != -1) chords.push_back(segs[i]);
        else chords.back().end = segs[i].end;
    }
    return chords;
}

// quantize_items: snap starts to the 120-tick grid, ties down, clipped to
// the last grid point below the max start (REMI.py:113-122 / MuMIDI.py)
void quantize_notes(std::vector<NoteRow>& notes, int64_t grid) {
    if (notes.empty()) return;
    int64_t max_start = 0;
    for (auto& nt : notes) max_start = std::max(max_start, nt.start);
    int64_t grid_stop = std::max(max_start, int64_t(1));
    int64_t n_grids = (grid_stop + grid - 1) / grid;
    for (auto& nt : notes) {
        int64_t q = nt.start / grid, rem = nt.start % grid;
        int64_t idx = std::min(q + (rem > grid / 2 ? 1 : 0), n_grids - 1);
        int64_t shift = idx * grid - nt.start;
        nt.start += shift;
        nt.end += shift;
    }
}

// REMI.py:237-254 tempo interval branches incl. the ==iv3 fall-through
void tempo_class_value(int64_t t, int64_t iv0, int64_t iv1, int64_t iv2,
                       int64_t iv3, int64_t* tc, int64_t* tv) {
    (void)iv3;
    if (t >= iv0 && t < iv1) { *tc = 0; *tv = t - iv0; }
    else if (t >= iv1 && t < iv2) { *tc = 1; *tv = t - iv1; }
    else if (t >= iv2 && t < iv3) { *tc = 2; *tv = t - iv2; }
    else if (t < iv0) { *tc = 0; *tv = 0; }
    else { *tc = 2; *tv = iv1 - iv0 - 1; }  // >=210 fall-through
}

// argmin |bins - x| with the first minimum winning ties
int64_t argmin_abs(const int64_t* bins, int64_t n, int64_t x) {
    int64_t di = std::lower_bound(bins, bins + n, x) - bins;
    if (di == n) return n - 1;
    if (di > 0 && (x - bins[di - 1]) <= (bins[di] - x)) return di - 1;
    return di;
}

// read_items tempo expansion: one item per beat from 0 to the last tempo
// tick, EXACT-tick dict lookup (off-grid changes invisible, last same-tick
// wins), seeded with the first event's bpm (REMI.py:92-110)
std::vector<std::pair<int64_t, int64_t>> expand_tempo_items(
    std::vector<std::pair<int64_t, int64_t>>& tempo_ev,
    int64_t ticks_per_beat) {
    std::stable_sort(tempo_ev.begin(), tempo_ev.end(),
                     [](auto& a, auto& b) { return a.first < b.first; });
    std::vector<std::pair<int64_t, int64_t>> items;
    int64_t last = tempo_ev.front().second;
    size_t ptr = 0;
    int64_t max_tt = tempo_ev.back().first;
    for (int64_t tick = 0; tick <= max_tt; tick += ticks_per_beat) {
        while (ptr < tempo_ev.size() && tempo_ev[ptr].first < tick) ++ptr;
        size_t q = ptr;
        while (q < tempo_ev.size() && tempo_ev[q].first == tick) {
            last = tempo_ev[q].second;
            ++q;
        }
        items.push_back({tick, last});
    }
    return items;
}

}  // namespace

int64_t mg_encode_remi(
    const uint8_t* data, int64_t n_bytes,
    const int64_t* dur_bins, int64_t n_dur,
    const int64_t* vel_bins, int64_t n_vel,
    int64_t resolution, int64_t fraction, int64_t vel_steps,
    int64_t pitch_max,
    int64_t iv0, int64_t iv1, int64_t iv2, int64_t iv3,
    const int64_t* chord_ids,  // [61]: qual*12+root; [60] = N:N
    int64_t off_on, int64_t off_dur, int64_t off_vel, int64_t off_bar,
    int64_t off_pos, int64_t off_tc, int64_t off_tv, int64_t off_chord,
    uint16_t* out, int64_t cap) {
    MgParse* p = mg_parse(data, n_bytes);
    if (p->error) { mg_free(p); return -1; }

    const int64_t ticks_per_beat = resolution;            // 480
    const int64_t ticks_per_bar = resolution * 4;         // 1920
    const int64_t grid = 120;                             // quantize grid

    // ---- instrument 0 (smf.py _build_from_native key order) ----
    // first (track, notes<controls, seq) occurrence picks the key
    std::vector<NoteRow> notes;
    if (p->n_notes || p->n_controls) {
        int64_t kt, kc, kp;
        bool use_note = p->n_notes &&
            (!p->n_controls || p->notes[0] <= p->controls[0]);
        if (use_note) { kt = p->notes[0]; kc = p->notes[1]; kp = p->notes[2]; }
        else { kt = p->controls[0]; kc = p->controls[1]; kp = p->controls[2]; }
        for (int64_t i = 0; i < p->n_notes; ++i) {
            const int64_t* r = p->notes + i * 7;
            if (r[0] == kt && r[1] == kc && r[2] == kp)
                notes.push_back({r[5], r[6], r[3], r[4], -1});
        }
    }
    std::stable_sort(notes.begin(), notes.end(),
                     [](const NoteRow& a, const NoteRow& b) {
                         return a.start != b.start ? a.start < b.start
                                                   : a.pitch < b.pitch;
                     });

    // ---- tempo changes (tick, bpm_int) ----
    std::vector<std::pair<int64_t, int64_t>> tempo_ev;
    for (int64_t i = 0; i < p->n_tempos; ++i) {
        int64_t us = p->tempos[i * 2 + 1];
        if (us <= 0) { mg_free(p); return -1; }  // Python raises; fall back
        tempo_ev.push_back({p->tempos[i * 2],
                            static_cast<int64_t>(60e6 / double(us))});
    }
    mg_free(p);
    if (tempo_ev.empty()) tempo_ev.push_back({0, 120});

    if (notes.empty()) return 0;

    quantize_notes(notes, grid);
    std::vector<ChordSeg> chords = infer_chords(notes, ticks_per_beat);
    auto tempo_items = expand_tempo_items(tempo_ev, ticks_per_beat);

    // ---- items = chords + tempos + notes, stable by start ----
    std::vector<RemiItem> items;
    items.reserve(chords.size() + tempo_items.size() + notes.size());
    for (auto& c : chords) {
        int64_t cid = c.qual == 5 ? chord_ids[60]
                                  : chord_ids[c.qual * 12 + c.root];
        items.push_back({c.start, 0, off_chord + cid, 0, 0});
    }
    for (auto& tp : tempo_items) {
        int64_t tc, tv;
        tempo_class_value(tp.second, iv0, iv1, iv2, iv3, &tc, &tv);
        items.push_back({tp.first, 1, off_tc + tc, off_tv + tv, 0});
    }
    for (auto& nt : notes) {
        int64_t vi = (std::upper_bound(vel_bins, vel_bins + n_vel, nt.vel)
                      - vel_bins) - 1;
        if (vi < 0 || vi >= vel_steps) vi = vel_steps - 1;  // <4-slots quirk
        int64_t pitch = std::min(nt.pitch, pitch_max);
        int64_t di = argmin_abs(dur_bins, n_dur, nt.end - nt.start);
        items.push_back({nt.start, 2, off_vel + vi, off_on + pitch,
                         off_dur + di});
    }
    std::stable_sort(items.begin(), items.end(),
                     [](const RemiItem& a, const RemiItem& b) {
                         return a.start < b.start;
                     });

    // ---- bar entries with the downbeat double-count ----
    struct Entry { int64_t bar, start, idx; };
    std::vector<Entry> entries;
    entries.reserve(items.size() + items.size() / 4);
    for (int64_t i = 0; i < int64_t(items.size()); ++i) {
        int64_t bar = items[i].start / ticks_per_bar;
        entries.push_back({bar, items[i].start, i});
        if (items[i].start % ticks_per_bar == 0 && items[i].start > 0)
            entries.push_back({bar - 1, items[i].start, i});
    }
    std::sort(entries.begin(), entries.end(),
              [](const Entry& a, const Entry& b) {
                  if (a.bar != b.bar) return a.bar < b.bar;
                  if (a.start != b.start) return a.start < b.start;
                  return a.idx < b.idx;
              });
    int64_t max_bar = 0;
    for (auto& e : entries) max_bar = std::max(max_bar, e.bar);
    std::vector<char> bar_has_note(max_bar + 1, 0);
    for (auto& e : entries)
        if (items[e.idx].kind == 2) bar_has_note[e.bar] = 1;

    // ---- emit ----
    std::vector<uint16_t> toks;
    toks.reserve(entries.size() * 4);
    int64_t step = ticks_per_bar / fraction;
    int64_t prev_bar = -1;
    for (auto& e : entries) {
        if (!bar_has_note[e.bar]) continue;
        if (e.bar != prev_bar) {
            toks.push_back(uint16_t(off_bar));
            prev_bar = e.bar;
        }
        int64_t rel = e.start - e.bar * ticks_per_bar;
        int64_t q = rel / step, r = rel % step;
        int64_t pos = std::min(q + (r > step / 2 ? 1 : 0), fraction - 1);
        toks.push_back(uint16_t(off_pos + pos));
        const RemiItem& it = items[e.idx];
        toks.push_back(uint16_t(it.p0));
        if (it.kind >= 1) toks.push_back(uint16_t(it.p1));
        if (it.kind == 2) toks.push_back(uint16_t(it.p2));
    }
    int64_t total = int64_t(toks.size());
    if (total > cap) return -total;  // caller retries with a bigger buffer
    std::memcpy(out, toks.data(), total * sizeof(uint16_t));
    return total;
}

// ---------------------------------------------------------------------------
// Sustain-pedal MIDI-like codec (vocab 388) — full-file tokenization.
//
// Exact C++ transcription of tokenizers/pedal_midilike.py encode_midi
// (reference mg/model/MusicTransformer/processor.py:202-230), oracle-
// tested in tests/test_native_pedal.py:
//   * tick->seconds via the tempo map EXACTLY like midi/timing.py
//     TempoMap (same expression order, so IEEE-identical),
//   * per instrument: CC64 down/up pairing (processor.py:163-178),
//     sustain extension in reverse note order, the default
//     keep-all-notes routing or the faithful note-dropping variant
//     (processor.py:181-199),
//   * point events stable-sorted by time; velocity emitted when the
//     RAW previous velocity differs from the QUANTIZED current one
//     (the reference's raw-vs-quantized quirk, processor.py:128,228),
//   * 10 ms time-shift runs with Python round-half-even.
//
// Returns token count; -needed when cap too small; -1 on parse/tempo
// error (caller falls back to the Python oracle path).

namespace {

struct TempoMapC {
    std::vector<int64_t> ticks;
    std::vector<double> cumsec;
    std::vector<double> sec_per_tick;

    void build(const std::vector<std::pair<int64_t, int64_t>>& raw,
               int64_t tpb) {
        // dedup last-wins; implicit (0, 500000) when absent (timing.py)
        std::vector<std::pair<int64_t, int64_t>> ch;
        if (raw.empty() || raw.front().first != 0)
            ch.push_back({0, 500000});
        for (auto& r : raw) ch.push_back(r);
        std::stable_sort(ch.begin(), ch.end(),
                         [](auto& a, auto& b) { return a.first < b.first; });
        for (size_t i = 0; i < ch.size(); ++i) {
            if (!ticks.empty() && ticks.back() == ch[i].first) {
                sec_per_tick.back() = ch[i].second / 1e6 / double(tpb);
            } else {
                ticks.push_back(ch[i].first);
                sec_per_tick.push_back(ch[i].second / 1e6 / double(tpb));
            }
        }
        cumsec.resize(ticks.size());
        cumsec[0] = 0.0;
        for (size_t i = 1; i < ticks.size(); ++i)
            cumsec[i] = cumsec[i - 1] +
                double(ticks[i] - ticks[i - 1]) * sec_per_tick[i - 1];
    }

    double at(int64_t tick) const {
        // searchsorted-right - 1, clipped (timing.py:44-47)
        size_t idx = std::upper_bound(ticks.begin(), ticks.end(), tick)
                     - ticks.begin();
        idx = idx > 0 ? idx - 1 : 0;
        return cumsec[idx] +
               (double(tick) - double(ticks[idx])) * sec_per_tick[idx];
    }
};

struct PedalNote { double start, end; int32_t pitch, vel; };

// one pedal-down window [start, end) and its governed notes
struct SustainC {
    double start, end;
    std::vector<int64_t> managed;  // indices into a note vector
};

void extend_notes(std::vector<PedalNote>& notes, SustainC& s) {
    // reverse order: end -> next onset of the same pitch, or the pedal
    // release if later than the written end (processor.py:33-39)
    double next_start[128];
    bool seen[128] = {false};
    for (auto it = s.managed.rbegin(); it != s.managed.rend(); ++it) {
        PedalNote& n = notes[*it];
        int pc = n.pitch & 127;
        if (seen[pc]) n.end = next_start[pc];
        else n.end = std::max(s.end, n.end);
        next_start[pc] = n.start;
        seen[pc] = true;
    }
}

}  // namespace

}  // extern "C"

extern "C" {

int64_t mg_encode_pedal(const uint8_t* data, int64_t n_bytes,
                        int32_t faithful, uint16_t* out, int64_t cap) {
    const int64_t START_NOTE_OFF = 128, START_TIME_SHIFT = 256,
                  START_VELOCITY = 356, RANGE_TIME_SHIFT = 100;
    MgParse* p = mg_parse(data, n_bytes);
    if (p->error) { mg_free(p); return -1; }
    for (int64_t i = 0; i < p->n_tempos; ++i)
        if (p->tempos[i * 2 + 1] <= 0) { mg_free(p); return -1; }

    TempoMapC tm;
    {
        std::vector<std::pair<int64_t, int64_t>> raw;
        for (int64_t i = 0; i < p->n_tempos; ++i)
            raw.push_back({p->tempos[i * 2], p->tempos[i * 2 + 1]});
        tm.build(raw, p->ticks_per_beat);
    }

    // instruments in first-occurrence order over (track, notes<ctrls, seq)
    struct Inst {
        std::vector<PedalNote> notes;        // seconds
        std::vector<std::pair<double, int32_t>> pedal;  // CC64 (sec, val)
    };
    std::vector<int64_t> keys;
    std::vector<Inst> insts;
    auto slot_of = [&](int64_t key) -> size_t {
        for (size_t s = 0; s < keys.size(); ++s)
            if (keys[s] == key) return s;
        keys.push_back(key);
        insts.emplace_back();
        return keys.size() - 1;
    };
    // first-occurrence rank: notes of track t precede its controls
    struct TmpNote { int64_t key, tick, end, pitch, vel, seq; };
    std::vector<TmpNote> tmp_notes;
    for (int64_t i = 0; i < p->n_notes; ++i) {
        const int64_t* r = p->notes + i * 7;
        tmp_notes.push_back({(r[0] << 32) | (r[1] << 16) | r[2],
                             r[5], r[6], r[3], r[4], i});
    }
    struct TmpCC { int64_t key, tick, num, val, seq; };
    std::vector<TmpCC> tmp_ccs;
    for (int64_t i = 0; i < p->n_controls; ++i) {
        const int64_t* r = p->controls + i * 6;
        tmp_ccs.push_back({(r[0] << 32) | (r[1] << 16) | r[2],
                           r[5], r[3], r[4], i});
    }
    mg_free(p);
    // discovery order: walk (track, is_ctrl, seq)-sorted occurrences —
    // keys sort by (track<<32|ch<<16|prog) embedded in seq order already
    {
        size_t ni = 0, ci = 0;
        while (ni < tmp_notes.size() || ci < tmp_ccs.size()) {
            bool take_note;
            if (ni == tmp_notes.size()) take_note = false;
            else if (ci == tmp_ccs.size()) take_note = true;
            else {
                int64_t tn = tmp_notes[ni].key >> 32;
                int64_t tc = tmp_ccs[ci].key >> 32;
                take_note = tn <= tc;  // same track: notes first
            }
            if (take_note) { slot_of(tmp_notes[ni].key); ++ni; }
            else { slot_of(tmp_ccs[ci].key); ++ci; }
        }
    }
    for (auto& n : tmp_notes) {
        size_t s = slot_of(n.key);
        insts[s].notes.push_back({tm.at(n.tick), tm.at(n.end),
                                  int32_t(n.pitch), int32_t(n.vel)});
    }
    for (auto& c : tmp_ccs) {
        if (c.num != 64) continue;
        insts[slot_of(c.key)].pedal.push_back({tm.at(c.tick),
                                               int32_t(c.val)});
    }

    std::vector<PedalNote> all_notes;
    for (auto& inst : insts) {
        // instrument notes are (start_tick, pitch)-sorted in smf.py; the
        // seconds view preserves that order (monotone map), and
        // encode_midi's sorted(key=start) is stable on equal starts
        std::stable_sort(inst.notes.begin(), inst.notes.end(),
                         [](const PedalNote& a, const PedalNote& b) {
                             return a.start != b.start ? a.start < b.start
                                                       : a.pitch < b.pitch;
                         });
        // CC64 down/up pairing (processor.py:163-178)
        std::vector<SustainC> sustains;
        bool open = false;
        SustainC cur{0, 0, {}};
        for (auto& cc : inst.pedal) {
            if (cc.second >= 64 && !open) {
                cur = SustainC{cc.first, 0, {}};
                open = true;
            } else if (cc.second < 64 && open) {
                cur.end = cc.first;
                sustains.push_back(cur);
                open = false;
            } else if (cc.second < 64 && !sustains.empty()) {
                sustains.back().end = cc.first;
            }
        }
        std::vector<PedalNote>& nts = inst.notes;
        if (faithful) {
            // processor.py:181-199 transliteration incl. its
            // note-dropping/duplication
            std::vector<PedalNote> stream;
            int64_t rem0 = 0;  // start of `remaining`
            for (auto& s : sustains) {
                for (int64_t idx = 0;
                     idx < int64_t(nts.size()) - rem0; ++idx) {
                    PedalNote& note = nts[rem0 + idx];
                    if (note.start < s.start) {
                        stream.push_back(note);
                    } else if (note.start > s.end) {
                        rem0 += idx;
                        extend_notes(nts, s);
                        break;
                    } else {
                        s.managed.push_back(rem0 + idx);
                    }
                }
            }
            for (auto& s : sustains)
                for (int64_t i : s.managed) stream.push_back(nts[i]);
            std::stable_sort(stream.begin(), stream.end(),
                             [](const PedalNote& a, const PedalNote& b) {
                                 return a.start < b.start;
                             });
            all_notes.insert(all_notes.end(), stream.begin(),
                             stream.end());
        } else {
            std::vector<PedalNote> stream;
            size_t si = 0;
            for (int64_t i = 0; i < int64_t(nts.size()); ++i) {
                while (si < sustains.size() &&
                       nts[i].start > sustains[si].end)
                    ++si;
                if (si < sustains.size() &&
                    sustains[si].start <= nts[i].start)
                    sustains[si].managed.push_back(i);
                else
                    stream.push_back(nts[i]);
            }
            for (auto& s : sustains) {
                extend_notes(nts, s);
                for (int64_t i : s.managed) stream.push_back(nts[i]);
            }
            std::stable_sort(stream.begin(), stream.end(),
                             [](const PedalNote& a, const PedalNote& b) {
                                 return a.start < b.start;
                             });
            all_notes.insert(all_notes.end(), stream.begin(),
                             stream.end());
        }
    }
    // global stable start-sort across instruments (encode_midi:166)
    std::stable_sort(all_notes.begin(), all_notes.end(),
                     [](const PedalNote& a, const PedalNote& b) {
                         return a.start < b.start;
                     });
    // point events (time, is_off, pitch, vel), stable by time
    struct Point { double t; int32_t is_off, pitch, vel; };
    std::vector<Point> points;
    points.reserve(all_notes.size() * 2);
    for (auto& n : all_notes) {
        points.push_back({n.start, 0, n.pitch, n.vel});
        points.push_back({n.end, 1, n.pitch, -1});
    }
    std::stable_sort(points.begin(), points.end(),
                     [](const Point& a, const Point& b) {
                         return a.t < b.t;
                     });

    std::vector<uint16_t> toks;
    toks.reserve(points.size() * 2 + 16);
    double cur_time = 0.0;
    int64_t cur_vel = 0;  // -1 encodes Python None (after an off)
    for (auto& pt : points) {
        // 10 ms shifts; Python int(round(x)) is round-half-even
        double x = (pt.t - cur_time) * 100.0;
        int64_t interval = int64_t(std::nearbyint(x));
        while (interval >= RANGE_TIME_SHIFT) {
            toks.push_back(uint16_t(START_TIME_SHIFT + RANGE_TIME_SHIFT
                                    - 1));
            interval -= RANGE_TIME_SHIFT;
        }
        if (interval > 0)
            toks.push_back(uint16_t(START_TIME_SHIFT + interval - 1));
        if (pt.vel >= 0) {
            int64_t qvel = pt.vel / 4;
            if (cur_vel != qvel)
                toks.push_back(uint16_t(START_VELOCITY + qvel));
        }
        toks.push_back(uint16_t((pt.is_off ? START_NOTE_OFF : 0)
                                + pt.pitch));
        cur_time = pt.t;
        cur_vel = pt.vel;  // raw velocity / -1-as-None (the quirk)
    }
    int64_t total = int64_t(toks.size());
    if (total > cap) return -total;
    std::memcpy(out, toks.data(), total * sizeof(uint16_t));
    return total;
}

// ---------------------------------------------------------------------------
// CP (Compound Word) full-file tokenization -> [T, 8] rows (flattened).
//
// Exact C++ transcription of tokenizers/cp.py extract_events (this
// repo's own scheme — the reference README's "CP (to do)"), which reuses
// the REMI item pipeline: parse -> instrument-0 notes -> quantize ->
// chord inference -> REMI bar grouping (downbeat double-count). Emission
// per kept bar: a bar-marker metric row, then per occupied 1-based grid
// position one metric row (tempo/chord compounded, later items
// overwrite) followed by one note row per note. Unused fields hold the
// per-field ignore id. Row field order: family, position, tempo_class,
// tempo_value, chord, pitch, duration, velocity (cp.py _FIELDS).
// Oracle-tested against cp.extract_events in tests/test_native_cp.py.
//
// Returns ROW count; -needed when cap (in rows) is too small; -1 on
// parse/tempo error (caller falls back to the Python path).
int64_t mg_encode_cp(
    const uint8_t* data, int64_t n_bytes,
    const int64_t* dur_bins, int64_t n_dur,
    const int64_t* vel_bins, int64_t n_vel,
    int64_t resolution, int64_t fraction, int64_t vel_steps,
    int64_t pitch_max,
    int64_t iv0, int64_t iv1, int64_t iv2, int64_t iv3,
    const int64_t* chord_ids,  // [61] chord VALUES (not offsets)
    const int64_t* ignore,     // [8] per-field ignore ids
    uint16_t* out, int64_t cap) {
    MgParse* p = mg_parse(data, n_bytes);
    if (p->error) { mg_free(p); return -1; }
    const int64_t ticks_per_beat = resolution;
    const int64_t ticks_per_bar = resolution * 4;

    // instrument-0 selection: identical to mg_encode_remi
    std::vector<NoteRow> notes;
    if (p->n_notes || p->n_controls) {
        int64_t kt, kc, kp;
        bool use_note = p->n_notes &&
            (!p->n_controls || p->notes[0] <= p->controls[0]);
        if (use_note) { kt = p->notes[0]; kc = p->notes[1]; kp = p->notes[2]; }
        else { kt = p->controls[0]; kc = p->controls[1]; kp = p->controls[2]; }
        for (int64_t i = 0; i < p->n_notes; ++i) {
            const int64_t* r = p->notes + i * 7;
            if (r[0] == kt && r[1] == kc && r[2] == kp)
                notes.push_back({r[5], r[6], r[3], r[4], -1});
        }
    }
    std::stable_sort(notes.begin(), notes.end(),
                     [](const NoteRow& a, const NoteRow& b) {
                         return a.start != b.start ? a.start < b.start
                                                   : a.pitch < b.pitch;
                     });
    std::vector<std::pair<int64_t, int64_t>> tempo_ev;
    for (int64_t i = 0; i < p->n_tempos; ++i) {
        int64_t us = p->tempos[i * 2 + 1];
        if (us <= 0) { mg_free(p); return -1; }
        tempo_ev.push_back({p->tempos[i * 2],
                            static_cast<int64_t>(60e6 / double(us))});
    }
    mg_free(p);
    if (tempo_ev.empty()) tempo_ev.push_back({0, 120});
    if (notes.empty()) return 0;

    quantize_notes(notes, 120);
    std::vector<ChordSeg> chords = infer_chords(notes, ticks_per_beat);
    auto tempo_items = expand_tempo_items(tempo_ev, ticks_per_beat);

    // items (field VALUES, not token ids), stable by start
    std::vector<RemiItem> items;
    items.reserve(chords.size() + tempo_items.size() + notes.size());
    for (auto& c : chords) {
        int64_t cid = c.qual == 5 ? chord_ids[60]
                                  : chord_ids[c.qual * 12 + c.root];
        items.push_back({c.start, 0, cid, 0, 0});
    }
    for (auto& tp : tempo_items) {
        int64_t tc, tv;
        tempo_class_value(tp.second, iv0, iv1, iv2, iv3, &tc, &tv);
        items.push_back({tp.first, 1, tc, tv, 0});
    }
    for (auto& nt : notes) {
        int64_t vi = (std::upper_bound(vel_bins, vel_bins + n_vel, nt.vel)
                      - vel_bins) - 1;
        // CP clamps into [0, vel_steps) on BOTH ends (cp.py:128-131)
        vi = std::max(std::min(vi, vel_steps - 1), int64_t(0));
        int64_t pitch = std::min(nt.pitch, pitch_max);
        int64_t di = argmin_abs(dur_bins, n_dur, nt.end - nt.start);
        items.push_back({nt.start, 2, pitch, di, vi});
    }
    std::stable_sort(items.begin(), items.end(),
                     [](const RemiItem& a, const RemiItem& b) {
                         return a.start < b.start;
                     });

    struct Entry { int64_t bar, start, idx; };
    std::vector<Entry> entries;
    for (int64_t i = 0; i < int64_t(items.size()); ++i) {
        int64_t bar = items[i].start / ticks_per_bar;
        entries.push_back({bar, items[i].start, i});
        if (items[i].start % ticks_per_bar == 0 && items[i].start > 0)
            entries.push_back({bar - 1, items[i].start, i});
    }
    std::sort(entries.begin(), entries.end(),
              [](const Entry& a, const Entry& b) {
                  if (a.bar != b.bar) return a.bar < b.bar;
                  if (a.start != b.start) return a.start < b.start;
                  return a.idx < b.idx;
              });
    int64_t max_bar = 0;
    for (auto& e : entries) max_bar = std::max(max_bar, e.bar);
    std::vector<char> bar_has_note(max_bar + 1, 0);
    for (auto& e : entries)
        if (items[e.idx].kind == 2) bar_has_note[e.bar] = 1;

    // emit rows; positions bucket contiguously (pos is monotone in start)
    std::vector<uint16_t> rows;
    rows.reserve(entries.size() * 8 + 64);
    int64_t step = ticks_per_bar / fraction;
    auto push_row = [&](int64_t fam, int64_t pos, int64_t tc, int64_t tv,
                        int64_t ch, int64_t pit, int64_t dur, int64_t vel) {
        rows.push_back(uint16_t(fam));
        rows.push_back(uint16_t(pos));
        rows.push_back(uint16_t(tc));
        rows.push_back(uint16_t(tv));
        rows.push_back(uint16_t(ch));
        rows.push_back(uint16_t(pit));
        rows.push_back(uint16_t(dur));
        rows.push_back(uint16_t(vel));
    };
    const int64_t IG1 = ignore[1], IG2 = ignore[2], IG3 = ignore[3],
                  IG4 = ignore[4], IG5 = ignore[5], IG6 = ignore[6],
                  IG7 = ignore[7];
    int64_t prev_bar = -1;
    size_t i = 0;
    while (i < entries.size()) {
        if (!bar_has_note[entries[i].bar]) { ++i; continue; }
        if (entries[i].bar != prev_bar) {
            prev_bar = entries[i].bar;
            push_row(0, 0, IG2, IG3, IG4, IG5, IG6, IG7);  // bar marker
        }
        // one position run: same bar, same grid index
        int64_t bar = entries[i].bar;
        auto pos_of = [&](const Entry& e) {
            int64_t rel = e.start - e.bar * ticks_per_bar;
            int64_t q = rel / step, r = rel % step;
            return std::min(q + (r > step / 2 ? 1 : 0), fraction - 1) + 1;
        };
        int64_t pos = pos_of(entries[i]);
        size_t j = i;
        int64_t tc = -1, tv = -1, ch = -1;
        std::vector<const RemiItem*> run_notes;
        while (j < entries.size() && entries[j].bar == bar &&
               pos_of(entries[j]) == pos) {
            const RemiItem& it = items[entries[j].idx];
            if (it.kind == 1) { tc = it.p0; tv = it.p1; }
            else if (it.kind == 0) ch = it.p0;
            else run_notes.push_back(&it);
            ++j;
        }
        if (tc >= 0 || ch >= 0 || !run_notes.empty())
            push_row(0, pos, tc >= 0 ? tc : IG2, tv >= 0 ? tv : IG3,
                     ch >= 0 ? ch : IG4, IG5, IG6, IG7);
        for (auto* it : run_notes)  // payload: p0 pitch, p1 dur, p2 vel
            push_row(1, IG1, IG2, IG3, IG4, it->p0, it->p1, it->p2);
        i = j;
    }
    int64_t total_rows = int64_t(rows.size()) / 8;
    if (total_rows > cap) return -total_rows;
    std::memcpy(out, rows.data(), rows.size() * sizeof(uint16_t));
    return total_rows;
}

// ---------------------------------------------------------------------------
// MuMIDI full-file tokenization (one con_instr subset per call).
//
// Exact C++ transcription of tokenizers/mumidi.py extract_events+to_array
// (reference mg/model/utils/MuMIDI.py:86-207, 337-431), oracle-tested in
// tests/test_native_mumidi.py. Deltas from REMI:
//   * notes come from EVERY instrument whose track-name meta matches a
//     selected role (role_mask over role_names), in smf.py instrument
//     first-occurrence order, each instrument's notes (start, pitch)-sorted,
//   * combined items sort by (start, track-NAME) — chord/tempo items carry
//     the empty name and sort first (MuMIDI.py:182),
//   * position granularity 32, ONE-based, emitted only when it changes
//     within the bar (MuMIDI.py:243-251),
//   * velocity = searchsorted(side='right') WITHOUT the -1 and WITHOUT a
//     clamp (MuMIDI.py:265-268 quirk),
//   * drum notes offset into the second half of note_on; non-drum pitch 0
//     underflows to off_on-1 exactly like the reference's pitch-1.
//
// Returns token count (0 = no selected notes -> caller maps to None),
// -needed when cap is too small, -1 on parse/tempo error (fallback).
int64_t mg_encode_mumidi(
    const uint8_t* data, int64_t n_bytes,
    const char* role_names, int64_t n_roles, int64_t role_mask,
    int64_t drum_role,
    const int64_t* dur_bins, int64_t n_dur,
    const int64_t* vel_bins, int64_t n_vel,
    int64_t resolution, int64_t fraction,
    int64_t pitch_lo, int64_t drum_lo, int64_t n_pitch,
    int64_t iv0, int64_t iv1, int64_t iv2, int64_t iv3,
    const int64_t* chord_ids,
    int64_t off_on, int64_t off_dur, int64_t off_vel, int64_t off_bar,
    int64_t off_pos, int64_t off_track, int64_t off_tc, int64_t off_tv,
    int64_t off_chord,
    uint16_t* out, int64_t cap) {
    MgParse* p = mg_parse(data, n_bytes);
    if (p->error) { mg_free(p); return -1; }

    const int64_t ticks_per_beat = resolution;
    const int64_t ticks_per_bar = resolution * 4;

    // unpack role names + alphabetical rank (the Python sort key is the
    // track-name STRING; chord/tempo items carry "" and sort first)
    std::vector<const char*> roles;
    {
        const char* q = role_names;
        for (int64_t i = 0; i < n_roles; ++i) {
            roles.push_back(q);
            q += std::strlen(q) + 1;
        }
    }
    std::vector<int> alpha_rank(n_roles);
    {
        std::vector<int> order(n_roles);
        for (int64_t i = 0; i < n_roles; ++i) order[i] = int(i);
        std::sort(order.begin(), order.end(), [&](int a, int b) {
            return std::strcmp(roles[a], roles[b]) < 0;
        });
        for (int64_t r = 0; r < n_roles; ++r) alpha_rank[order[r]] = int(r);
    }

    // first track-name meta per track (smf.py names.setdefault)
    std::vector<std::pair<int64_t, std::pair<int64_t, int64_t>>> names;
    for (int64_t i = 0; i < p->n_metas; ++i) {
        const int64_t* m = p->metas + i * 5;
        if (m[2] != 0x03) continue;
        bool seen = false;
        for (auto& nm : names) if (nm.first == m[0]) { seen = true; break; }
        if (!seen) names.push_back({m[0], {m[3], m[4]}});
    }
    auto track_role = [&](int64_t track) -> int {
        for (auto& nm : names) {
            if (nm.first != track) continue;
            int64_t off = nm.second.first, len = nm.second.second;
            if (off < 0 || off + len > n_bytes) return -1;
            for (int64_t r = 0; r < n_roles; ++r) {
                if (int64_t(std::strlen(roles[r])) == len &&
                    std::memcmp(data + off, roles[r], len) == 0)
                    return int(r);
            }
            return -1;
        }
        return -1;  // unnamed track
    };

    // instruments in first-note-occurrence order (control-only instruments
    // carry no notes and cannot affect note order — skip them)
    std::vector<int64_t> inst_keys;
    std::vector<std::vector<NoteRow>> inst_notes;
    std::vector<int> inst_role;
    for (int64_t i = 0; i < p->n_notes; ++i) {
        const int64_t* r = p->notes + i * 7;
        int64_t key = (r[0] << 32) | (r[1] << 16) | r[2];
        size_t slot = 0;
        for (; slot < inst_keys.size(); ++slot)
            if (inst_keys[slot] == key) break;
        if (slot == inst_keys.size()) {
            inst_keys.push_back(key);
            inst_notes.emplace_back();
            int role = track_role(r[0]);
            if (role >= 0 && !((role_mask >> role) & 1)) role = -1;
            inst_role.push_back(role);
        }
        if (inst_role[slot] >= 0)
            inst_notes[slot].push_back({r[5], r[6], r[3], r[4],
                                        inst_role[slot]});
    }

    std::vector<std::pair<int64_t, int64_t>> tempo_ev;
    for (int64_t i = 0; i < p->n_tempos; ++i) {
        int64_t us = p->tempos[i * 2 + 1];
        if (us <= 0) { mg_free(p); return -1; }
        tempo_ev.push_back({p->tempos[i * 2],
                            static_cast<int64_t>(60e6 / double(us))});
    }
    mg_free(p);
    if (tempo_ev.empty()) tempo_ev.push_back({0, 120});

    std::vector<NoteRow> notes;
    for (size_t s = 0; s < inst_keys.size(); ++s) {
        auto& v = inst_notes[s];
        std::stable_sort(v.begin(), v.end(),
                         [](const NoteRow& a, const NoteRow& b) {
                             return a.start != b.start ? a.start < b.start
                                                       : a.pitch < b.pitch;
                         });
        notes.insert(notes.end(), v.begin(), v.end());
    }
    if (notes.empty()) return 0;  // -> None (extract_split_events)
    // read_items' global stable start-sort (ties keep instrument order)
    std::stable_sort(notes.begin(), notes.end(),
                     [](const NoteRow& a, const NoteRow& b) {
                         return a.start < b.start;
                     });

    quantize_notes(notes, 120);
    std::vector<ChordSeg> chords = infer_chords(notes, ticks_per_beat);
    auto tempo_items = expand_tempo_items(tempo_ev, ticks_per_beat);

    // items: kind 0 chord / 1 tempo / 2 note; sort (start, track-name)
    struct MuItem {
        int64_t start;
        int8_t kind;
        int rank;  // -1 for chord/tempo (empty name), else alpha rank
        int64_t p0, p1, p2, p3;
    };
    std::vector<MuItem> items;
    items.reserve(chords.size() + tempo_items.size() + notes.size());
    for (auto& c : chords) {
        int64_t cid = c.qual == 5 ? chord_ids[60]
                                  : chord_ids[c.qual * 12 + c.root];
        items.push_back({c.start, 0, -1, off_chord + cid, 0, 0, 0});
    }
    for (auto& tp : tempo_items) {
        int64_t tc, tv;
        tempo_class_value(tp.second, iv0, iv1, iv2, iv3, &tc, &tv);
        items.push_back({tp.first, 1, -1, off_tc + tc, off_tv + tv, 0, 0});
    }
    for (auto& nt : notes) {
        // searchsorted(side='right'), NO -1, NO clamp (MuMIDI.py:265-268)
        int64_t vi = std::upper_bound(vel_bins, vel_bins + n_vel, nt.vel)
                     - vel_bins;
        int64_t on = nt.track == drum_role
                         ? nt.pitch - drum_lo + n_pitch
                         : nt.pitch - pitch_lo;
        int64_t di = argmin_abs(dur_bins, n_dur, nt.end - nt.start);
        items.push_back({nt.start, 2, alpha_rank[nt.track],
                         off_track + nt.track, off_vel + vi, off_on + on,
                         off_dur + di});
    }
    std::stable_sort(items.begin(), items.end(),
                     [](const MuItem& a, const MuItem& b) {
                         return a.start != b.start ? a.start < b.start
                                                   : a.rank < b.rank;
                     });

    // bar entries with the downbeat double-count
    struct Entry { int64_t bar, start, idx; };
    std::vector<Entry> entries;
    entries.reserve(items.size() + items.size() / 4);
    for (int64_t i = 0; i < int64_t(items.size()); ++i) {
        int64_t bar = items[i].start / ticks_per_bar;
        entries.push_back({bar, items[i].start, i});
        if (items[i].start % ticks_per_bar == 0 && items[i].start > 0)
            entries.push_back({bar - 1, items[i].start, i});
    }
    std::sort(entries.begin(), entries.end(),
              [](const Entry& a, const Entry& b) {
                  if (a.bar != b.bar) return a.bar < b.bar;
                  if (a.start != b.start) return a.start < b.start;
                  return a.idx < b.idx;
              });
    int64_t max_bar = 0;
    for (auto& e : entries) max_bar = std::max(max_bar, e.bar);
    std::vector<char> bar_has_note(max_bar + 1, 0);
    for (auto& e : entries)
        if (items[e.idx].kind == 2) bar_has_note[e.bar] = 1;

    // emit: position is ONE-based and emitted only when it changes
    std::vector<uint16_t> toks;
    toks.reserve(entries.size() * 5);
    int64_t step = ticks_per_bar / fraction;
    int64_t prev_bar = -1, last_pos = -1;
    for (auto& e : entries) {
        if (!bar_has_note[e.bar]) continue;
        if (e.bar != prev_bar) {
            toks.push_back(uint16_t(off_bar));
            prev_bar = e.bar;
            last_pos = -1;
        }
        int64_t rel = e.start - e.bar * ticks_per_bar;
        int64_t q = rel / step, r = rel % step;
        int64_t pos = std::min(q + (r > step / 2 ? 1 : 0), fraction - 1) + 1;
        if (pos != last_pos) {
            toks.push_back(uint16_t(off_pos + pos));
            last_pos = pos;
        }
        const MuItem& it = items[e.idx];
        toks.push_back(uint16_t(it.p0));
        if (it.kind >= 1) toks.push_back(uint16_t(it.p1));
        if (it.kind == 2) {
            toks.push_back(uint16_t(it.p2));
            toks.push_back(uint16_t(it.p3));
        }
    }
    int64_t total = int64_t(toks.size());
    if (total > cap) return -total;
    std::memcpy(out, toks.data(), total * sizeof(uint16_t));
    return total;
}

}  // extern "C"
