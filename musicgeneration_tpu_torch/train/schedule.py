"""LR schedules. Noam/transformer warmup (reference criterion.py:70-96):
lr(step) = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), in f32 with
the step clamped to >= 1, as ``musicgeneration_tpu/train/schedule.py``."""

from __future__ import annotations

import numpy as np


def noam_schedule(d_model: int, warmup_steps: int = 4000):
    scale = np.float32(d_model ** -0.5)
    ramp = np.float32(warmup_steps ** -1.5)

    def schedule(step) -> np.float32:
        step = np.maximum(np.asarray(step, np.float32), np.float32(1.0))
        return scale * np.minimum(step ** np.float32(-0.5), step * ramp)

    return schedule
