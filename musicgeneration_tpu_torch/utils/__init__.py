"""Config overrides, checkpoints, metrics logging and profiling of the
torch port's training path."""
