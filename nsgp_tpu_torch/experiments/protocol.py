"""Reference experiment protocol constants.

A numpy copy of ``nsgp_tpu/experiments/protocol.py``, so that the port
imports nothing of the JAX package.

The paper's experiment scripts share one protocol (missing_data_music.m /
test_missing_data.m / noise_reduction_speech.m):

- every corpus file is resampled to 16 kHz and normalized to unit variance
  over the WHOLE file (train_GTFNMF_fixed_params.m:11-15);
- models are pre-trained on the whole normalized signal (filterbank, GPPAD,
  NMF, SE-GP stages all see y_norm in full);
- the test signal IS the trained signal (`yTest = y_norm`,
  missing_data_music.m:86) — the applications evaluate reconstruction of
  the modeled signal, not generalization to unseen audio;
- missing data: 6 gaps of 321 samples (gapLim [10,320] with numgaps=1:
  MATLAB ``ceil(linspace(10,320,1)) == 320``, ind = gapPos +/- 160) at
  hand-picked non-silent positions per file (missing_data_music.m:55-75);
- likelihood noise fixed at w_lik = 1e-4 for missing data
  (missing_data_music.m:28), at the true added variance for denoising
  (noise_reduction_speech.m:80);
- EP regime: fraction 0.75, damping 0.1; IHGP at 20 sweeps drops damping
  to 0.0025 (missing data) / 0.01 (denoising); GIEKF runs ep_itts global
  passes with 1 inner iteration (missing_data_music.m:23-26,128).
"""

from __future__ import annotations

import numpy as np

FS_REFERENCE = 16000  # train_GTFNMF_fixed_params.m:5 (opts.fs)
GAP_HALF = 160  # ceil(320/2); gap length = 2*160 + 1 = 321 samples
W_LIK_MISSING = 1e-4  # missing_data_music.m:28
NOISE_LEVELS = (0.01, 0.05, 0.1, 0.3, 0.5)  # noise_reduction_speech.m:34

# Hand-picked non-silent gap centers (missing_data_music.m:55-75 and
# test_missing_data.m:40-61 — the speech table reuses the music numbers).
GAP_POSITIONS = {
    "bamboo_flute": (1500, 5000, 7000, 9000, 13000, 18000),
    "cello": (500, 1500, 3500, 5000, 8000, 10000),
    "clarinet": (1000, 2500, 4000, 5500, 6000, 7500),
    "flute": (800, 2200, 5000, 6500, 10000, 12500),
    "guitar": (700, 1600, 2500, 6000, 8000, 11000),
    "ocarina": (700, 2000, 3000, 4000, 5000, 7000),
    "piano": (800, 2000, 3000, 4000, 10000, 11000),
    "piccolo": (700, 2000, 5000, 6000, 9000, 10000),
    "sax": (1000, 2000, 5000, 8000, 12000, 13000),
    "toy-accordian": (1000, 3500, 7500, 8500, 10000, 15000),
    "speech0_female": (1500, 5000, 7000, 9000, 13000, 18000),
    "speech1_male": (500, 1500, 3500, 5000, 8000, 10000),
    "speech2_male": (1000, 2500, 4000, 5500, 6000, 7500),
    "speech3_male": (800, 2200, 5000, 6500, 10000, 12500),
    "speech4_male": (700, 1600, 2500, 6000, 8000, 11000),
    "speech5_male": (700, 2000, 3000, 4000, 5000, 7000),
    "speech6_female": (800, 2000, 3000, 4000, 10000, 11000),
    "speech7_female": (700, 2000, 5000, 6000, 9000, 10000),
    "speech8_female": (1000, 2000, 5000, 8000, 12000, 13000),
    "speech9_female": (1000, 3500, 7500, 8500, 10000, 15000),
}

MUSIC_FILES = (
    "bamboo_flute", "cello", "clarinet", "flute", "guitar",
    "ocarina", "piano", "piccolo", "sax", "toy-accordian",
)
SPEECH_FILES = tuple(f"speech{i}_{s}" for i, s in enumerate(
    ["female", "male", "male", "male", "male",
     "male", "female", "female", "female", "female"]
))
CORPUS_FILES = {"music": MUSIC_FILES, "speech": SPEECH_FILES}


def reference_gap_indices(name: str, T: int, half: int = GAP_HALF):
    """Concatenated gap sample indices for a corpus file, clipped to [0, T).

    MATLAB builds ind = gapPos(ng) + (-160:160) 1-based
    (missing_data_music.m:112-116); 0-based here.  Positions beyond a
    short file's length are dropped (the reference's tables assume
    T >~ 18k; speech files at 16 kHz run 8k-23k samples).
    """
    pos = GAP_POSITIONS[name]
    ind = np.concatenate([p - 1 + np.arange(-half, half + 1) for p in pos
                          if p - 1 + half < T and p - 1 - half >= 0])
    return ind.astype(np.int64)


def reference_gap_mask(name: str, T: int, half: int = GAP_HALF):
    """Boolean observation mask (True = observed) under the reference gaps."""
    mask = np.ones((T,), bool)
    mask[reference_gap_indices(name, T, half)] = False
    return mask
