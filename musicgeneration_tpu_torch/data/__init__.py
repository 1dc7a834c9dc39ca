"""The torch port's data path: MIDI-like shards, crop batching and
host-to-device prefetch."""
