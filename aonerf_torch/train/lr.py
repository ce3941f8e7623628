"""Learning-rate schedule: log-lerp decay with a sin warm-delay (counterpart
of ``aonerf.train.lr``).

  lr(step) = delay(step) * exp(lerp(log lr_init -> log lr_final, step/max))
  delay(step) = m + (1-m) * sin(pi/2 * clip(step/delay_steps, 0, 1))

Evaluated in float32, as the JAX function is.
"""

import numpy as np


def log_lerp_lr(
    step: int,
    lr_init: float = 5.0e-4,
    lr_final: float = 5.0e-6,
    max_steps: int = 100_000,
    lr_delay_steps: int = 2500,
    lr_delay_mult: float = 0.01,
) -> float:
    f32 = np.float32
    step = f32(step)
    if lr_delay_steps > 0:
        ramp = np.clip(step / f32(lr_delay_steps), f32(0.0), f32(1.0))
        delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(f32(0.5 * np.pi) * ramp)
    else:
        delay_rate = f32(1.0)
    t = np.clip(step / f32(max_steps), f32(0.0), f32(1.0))
    scaled = np.exp(f32(np.log(lr_init)) * (f32(1.0) - t) + f32(np.log(lr_final)) * t)
    return float(f32(delay_rate * scaled))
