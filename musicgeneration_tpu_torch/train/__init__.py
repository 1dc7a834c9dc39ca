"""The torch port's training path: objective, schedule, train step and
loop (MusicTransformer, crop mode)."""
