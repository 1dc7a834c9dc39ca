"""Plain references of the benchmark's configurations: torch operations
in f32 with TF32 off, written from the published equations, importing
nothing of the program. ``precision`` gives the control's lower
precision (fp8) for the same code."""
