"""Synthetic human-activity-recognition dataset (UCI HAR shape-compatible).

MobiRNN evaluates a stacked LSTM on the UCI smartphone dataset [Anguita et
al. 2013]: windows of 128 readings x 9 sensor channels (body acc xyz, gyro
xyz, total acc xyz), 6 activity labels, 7352 train / 2947 test windows.
The dataset is not bundled, so this numpy generator synthesises the same
shape with a class-conditional signal structure (per-class fundamental
frequency, amplitude, gravity orientation and noise floor chosen to mimic
walking/upstairs/downstairs/sitting/standing/laying).

For one seed it yields arrays identical to the JAX package's generator, so
both packages can be fed the same windows.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CLASSES = ("walking", "upstairs", "downstairs", "sitting", "standing",
           "laying")
N_CHANNELS = 9
SEQ_LEN = 128

# per-class (fundamental Hz @50Hz sampling, dynamic amplitude, noise, gravity)
_PROFILE = {
    0: (2.0, 1.00, 0.25, (0.0, 0.0, 1.0)),    # walking
    1: (1.6, 1.20, 0.30, (0.2, 0.0, 0.95)),   # upstairs
    2: (2.3, 1.35, 0.35, (-0.2, 0.0, 0.95)),  # downstairs
    3: (0.0, 0.08, 0.10, (0.5, 0.5, 0.70)),   # sitting
    4: (0.0, 0.05, 0.08, (0.0, 0.0, 1.0)),    # standing
    5: (0.0, 0.04, 0.06, (0.0, 1.0, 0.05)),   # laying
}


def _window(rng: np.random.Generator, label: int) -> np.ndarray:
    f0, amp, noise, grav = _PROFILE[label]
    t = np.arange(SEQ_LEN) / 50.0
    x = np.zeros((SEQ_LEN, N_CHANNELS), np.float32)
    phase = rng.uniform(0, 2 * np.pi)
    f = f0 * rng.uniform(0.85, 1.15) if f0 else 0.0
    for c in range(3):                       # body acceleration
        h1 = amp * np.sin(2 * np.pi * f * t + phase + c * 2.1) if f else 0.0
        h2 = 0.3 * amp * np.sin(4 * np.pi * f * t + phase) if f else 0.0
        x[:, c] = h1 + h2
    for c in range(3):                       # gyro: phase-shifted derivative
        x[:, 3 + c] = (0.6 * amp * np.cos(2 * np.pi * f * t + phase + c)
                       if f else 0.0)
    for c in range(3):                       # total acc = body + gravity
        x[:, 6 + c] = x[:, c] + grav[c] * rng.uniform(0.95, 1.05)
    x += rng.normal(0, noise, x.shape).astype(np.float32)
    return x


@dataclasses.dataclass
class HARData:
    x: np.ndarray          # (N, 128, 9) float32
    y: np.ndarray          # (N,) int32


def make_har(n_train: int = 7352, n_test: int = 2947, seed: int = 0
             ) -> tuple[HARData, HARData]:
    rng = np.random.default_rng(seed)

    def gen(n):
        ys = rng.integers(0, len(CLASSES), n).astype(np.int32)
        xs = np.stack([_window(rng, int(y)) for y in ys])
        return HARData(xs, ys)

    return gen(n_train), gen(n_test)
