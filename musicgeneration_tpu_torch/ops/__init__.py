"""Relative attention (plain) and the port's two hand-written kernels."""
