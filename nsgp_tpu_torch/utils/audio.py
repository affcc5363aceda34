"""Minimal WAV IO (16/24/32-bit PCM and float) on top of the stdlib.

The reference's data layer is 61 .wav files loaded with MATLAB audioread;
this module provides the equivalent without adding dependencies.  A copy
of ``nsgp_tpu/utils/audio.py`` (numpy and scipy on the host), so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str):
    """Returns (y float64 in [-1, 1] mono-mixed, sample_rate)."""
    with wave.open(path, "rb") as w:
        fs = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    elif sw == 4:
        y = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    elif sw == 1:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        v = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        y = v.astype(np.float64) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {sw}")
    if ch > 1:
        y = y.reshape(-1, ch).mean(axis=1)
    return y, fs


def resample(y, fs_to: int, fs_from: int):
    """Rational polyphase resampling (MATLAB ``resample(y, p, q)``).

    The reference downsamples every corpus file 44.1 kHz -> 16 kHz before
    any processing (train_GTFNMF_fixed_params.m:12 ``resample(y_,fs_,fs)``).
    scipy's resample_poly uses the same polyphase/Kaiser anti-alias design
    as MATLAB's resample.
    """
    if fs_to == fs_from:
        return np.asarray(y, np.float64)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(fs_to), int(fs_from))
    return resample_poly(np.asarray(y, np.float64), fs_to // g, fs_from // g)


def load_normalized(path: str, fs_target: int = 16000):
    """Reference pre-processing: read, resample to fs_target, normalize the
    WHOLE signal to unit variance (train_GTFNMF_fixed_params.m:11-15).

    Returns (y_norm float64, normaliser, fs_target).  Every experiment
    script consumes this — the trained ``y_norm`` and the test signal are
    the same array in the reference protocol (missing_data_music.m:86
    ``yTest = y_norm``).
    """
    y, fs = read_wav(path)
    y = resample(y, fs_target, fs)
    normaliser = float(np.sqrt(np.var(y)))
    return y / (normaliser + 1e-300), normaliser, fs_target


def write_wav(path: str, y, fs: int) -> None:
    y = np.asarray(y, np.float64)
    y = np.clip(y, -1.0, 1.0)
    pcm = (y * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())
