"""Short-Time Objective Intelligibility (STOI) — the PESQ substitute.

The reference ships PESQ only as an obfuscated MATLAB p-code binary
(prob_filterbank/pesq.p) and none of its committed experiments consume it;
we substitute the open STOI measure (Taal, Hendriks, Heusdens, Jensen,
"An Algorithm for Intelligibility Prediction of Time-Frequency Weighted
Noisy Speech", IEEE TASL 2011) — a standard modern speech-quality metric
with a public definition, implementable without binary blobs.

Pure numpy/scipy, host-side (an offline evaluation metric, not a
compute-path op): a copy of ``nsgp_tpu/utils/stoi.py``, so that the port
imports nothing of the JAX package.  Tensors are taken through
``np.asarray``, so a CPU tensor works; copy one on the card to the host first.

Score is in roughly [0, 1]; ~1 for perfect reconstruction, monotonically
degrading with distortion.
"""

from __future__ import annotations

import numpy as np

FS_STOI = 10_000  # internal sample rate of the measure
FRAME = 256  # analysis frame (25.6 ms at 10 kHz)
NFFT = 512
NBANDS = 15  # one-third-octave bands
MINFREQ = 150.0  # center frequency of the lowest band (Hz)
SEG = 30  # frames per short-time segment (384 ms)
BETA = -15.0  # lower SDR clipping bound (dB)
DYN_RANGE = 40.0  # silent-frame energy threshold below max (dB)


def _third_octave_bands(fs: int, nfft: int, num_bands: int, min_freq: float):
    """Boolean (num_bands, nfft//2 + 1) matrix selecting each band's bins."""
    f = np.linspace(0.0, fs / 2.0, nfft // 2 + 1)
    k = np.arange(num_bands, dtype=float)
    cf = min_freq * 2.0 ** (k / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    H = np.zeros((num_bands, f.shape[0]))
    for b in range(num_bands):
        idx = np.argmin((f - lo[b]) ** 2)
        lo_b = idx if f[idx] >= lo[b] else idx + 1
        idx = np.argmin((f - hi[b]) ** 2)
        hi_b = idx if f[idx] <= hi[b] else idx - 1
        H[b, lo_b : hi_b + 1] = 1.0
    return H


def _frames(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (x.shape[0] - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def stoi(clean, degraded, fs: float) -> float:
    """STOI intelligibility score of ``degraded`` against ``clean``."""
    x = np.asarray(clean, np.float64).ravel()
    y = np.asarray(degraded, np.float64).ravel()
    if x.shape != y.shape:
        raise ValueError("clean/degraded length mismatch")
    fs = int(round(fs))
    if fs != FS_STOI:
        from scipy.signal import resample_poly  # 3 s to import: only where it resamples

        g = np.gcd(fs, FS_STOI)
        x = resample_poly(x, FS_STOI // g, fs // g)
        y = resample_poly(y, FS_STOI // g, fs // g)

    # A post-resample signal shorter than one frame would raise a raw
    # numpy IndexError inside _frames (ADVICE r3) — fail descriptively.
    if x.shape[0] < FRAME:
        raise ValueError(f"signal too short for STOI (need >= {SEG} frames)")
    hop = FRAME // 2
    win = np.hanning(FRAME + 2)[1:-1]
    xf = _frames(x, FRAME, hop) * win
    yf = _frames(y, FRAME, hop) * win
    if xf.shape[0] < SEG:
        raise ValueError(f"signal too short for STOI (need >= {SEG} frames)")

    # drop silent frames of the CLEAN signal (Taal 2011, Sec. II-A)
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-300)
    keep = energy > (energy.max() - DYN_RANGE)
    xf, yf = xf[keep], yf[keep]
    if xf.shape[0] < SEG:
        return float("nan")

    X = np.abs(np.fft.rfft(xf, NFFT, axis=1))
    Y = np.abs(np.fft.rfft(yf, NFFT, axis=1))
    H = _third_octave_bands(FS_STOI, NFFT, NBANDS, MINFREQ)
    Xb = np.sqrt((X**2) @ H.T)  # (frames, bands)
    Yb = np.sqrt((Y**2) @ H.T)

    # short-time segments of SEG frames, normalized + SDR-clipped correlation
    n_seg = Xb.shape[0] - SEG + 1
    clip = 10.0 ** (-BETA / 20.0)
    d_sum, count = 0.0, 0
    for m in range(n_seg):
        Xs = Xb[m : m + SEG].T  # (bands, SEG)
        Ys = Yb[m : m + SEG].T
        alpha = np.linalg.norm(Xs, axis=1, keepdims=True) / (
            np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-300
        )
        Ys = np.minimum(Ys * alpha, (1.0 + clip) * Xs)
        Xc = Xs - Xs.mean(axis=1, keepdims=True)
        Yc = Ys - Ys.mean(axis=1, keepdims=True)
        num = np.sum(Xc * Yc, axis=1)
        den = np.linalg.norm(Xc, axis=1) * np.linalg.norm(Yc, axis=1) + 1e-300
        d_sum += float(np.sum(num / den))
        count += NBANDS
    return d_sum / count
