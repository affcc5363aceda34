#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``nsgp_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is 1):

0. the card's name and power limit; build the CUDA kernels from
   ``nsgp_tpu_torch/csrc`` with nvcc (timed, one nvcc per source in parallel).
1. K1 fused_fwd, K2 fused_bwd, K3 fused_adf against their plain PyTorch
   versions on the card at the headline model's full width (D=16, N=3,
   matern32/matern52, p_cubature=9), T=4096, in float64 (proves the
   algorithm) and float32 (proves the working type); K1 and K2, which run
   as three blocked passes over chunks of T, also at T = 1, 31, 32 (one chunk),
   33 (a chunk and one step) and 4096 against the sequential plain versions,
   with sites that hold runs of zeros and one long gap, the last at the
   chunk length the main path launches with.  Then at the main path's own
   shape in float32, T=100 000 and the path's own chunk length: K3 against
   its plain version over the first 20 000 steps; K1 run over all T and held
   against the plain version on its first 20 000 rows (the filter is causal),
   K2 over all T against the plain version on its last 20 000 rows (the
   smoother runs from the end), and each over all T against the same kernel
   run as one chunk, which is the sequential pass; all timed over all T.
2. the single-signal path: ``ep_infer(backend="fused")`` at the headline
   benchmark shape (T=100 000, 3 EP sweeps, float32), launch counters reset
   just before one run and read just after; s/sweep over 3 timed runs, and
   one float64 run as the float32 health check.
3. real weights: ``results/trained/music/trained_piano_matern32.npz``,
   T=2048 from its prior, 3 sweeps on the card vs the CPU (plain versions).
4. K4 fused_adf_mb against its plain version: (a) batch width (BF=10, D=16,
   N=3, 77 sigma points, T=4096, masks that differ per file), (b) mixture
   width (BF=1, D=48, N=9, 3973 sigma points, s_chunk=256, T=512; then
   BF=3, three clusters of eight CTAs, T=128, signals and gaps that differ
   per file), each in float64 and float32, and s_chunk 0 against 256 on the
   kernel; K1 and K2 at the batched paths' channel counts C=190 and C=57,
   at the ragged lengths of phase 1 in both types, T=4096 at the chunk
   length those paths launch with.
   Every comparison also runs the kernel twice and wants the same bits.
5. the batched path: ``fill_gaps_batch(engine="ep", backend="fused")`` over
   the ten trained music models in one batch, padded to the corpus length
   T=53 248 with each file's own length and six 321-sample gaps, float32,
   seeded numpy draws from each model's prior; launch counters; files 0 and 9 against the
   single-file ``ep_infer``; s per batch call against the ten files one by
   one; K1 and K2 at the path's own shape (T=53 248, C=190) and chunk length
   as in phase 1: head and tail of 4096 rows against the plain versions, all
   T against the one-chunk kernel.
6. the mixture path: ``separate(engine="ep", backend="fused", s_chunk=256)``
   over three trained source models (joint D=48, N=9, 3973 sigma points),
   T=16 000, float32, a seeded synthetic mixture with known parts; launch
   counters; K4 ms per step and the re-site's time at this width; K1 and K2
   at the path's own shape (T=16 000, C=57) and chunk length as in phase 5;
   the same call at T=2048 in float64 on the card against the CPU.

7. the training path (``training_phase``): ``ep_energy``'s sweep 1 is K3
   forward and its adjoint K7 ``fused_adf_vjp`` backward.  K7 against its
   plain twin at the speech model's full width (T=1024, a NaN gap and an
   outlier under the Z floor, cotangents on all five outputs and on lZ
   alone) and at mixture width (S=3973, T=128), both dtypes; gradients and a
   fit card vs CPU at float64; one value and gradient at the training length
   T=16 000 float32 with its launches (K3 1, K7 1) and CUDA kernels a call;
   a 3-step fit at T=16 000 then a gap fill on the fused path; HMC/VI at
   T=2000; GIEKF; its line ``{"training": ...}``.
8. the IHGP path (``ihgp_phase``) at the headline model: its sequential
   passes are K5 ``fused_ihgp_adf`` (the steady ADF sweep) and K6
   ``fused_ihgp_smooth`` (the steady smoother), counterparts of the two
   scans JAX compiles; every path's K5 and K6 launches are counted (the
   sequential form K5 and K6 once a sweep, the parallel forms K5 once).
   (a) the DARE bank card vs CPU at float64 at the default grid and at
   ``grid_lo=-7`` (every table field, the failed coarse points per
   channel), its time in float32; (b) ``ihgp_infer`` at T=1024 float64
   card (K5, K6) vs CPU (their twins) in the sequential, blocked (chunk
   256) and one-level forms, grid indices equal; ``ihgp_energy`` (K5 and
   K8 on the card, their twins on the CPU) and its gradient over every
   leaf; ``ep_infer`` on
   ``backend="seq"`` with the one-level scans, with and without ``jitter``;
   (c) K5 and K6 against their plain twins at the headline width: float64
   at T=4096 (grid indices equal, 1e-9), float32 over T=100 000 against the
   twins over 4096 steps (K5's index flips counted, its energy held to
   1e-3), both timed at T=100 000; float32 at T=16 000: sweep 1 through K5
   (us a step, its energy's gap to float64), ``ihgp_energy``'s forward
   through K5's plain twin at T=2048, ``ihgp-seq`` and ``ihgp-blocked``
   (bench.py:222-228);
   (d) ``ihgp-blocked`` at T=100 000 (50 000 if (c) predicts sweep 1 over
   150 s there), s/sweep; (e) K5 at mixture width (D=48, N=9, 3973 sigma
   points, a cluster of 8 CTAs) against its twin over 256 steps in both
   types; ``separate()`` with its default engine at mixture width (T=2048
   float32; T=256 float64 card vs CPU) and ``infer_batch("ihgp")`` over
   three corpus models (T=4096), its last file against the single-file
   engine; (f) the energy's gradient: ``ihgp_energy``'s sweep is K5 forward
   and its adjoint K8 ``fused_ihgp_adf_vjp`` backward.  K8 against its twin
   (T=1024 with a NaN gap in both types, mixture width at T=128 in float64,
   the same bits twice); at T=16 000 float32 one value and gradient (K5 1,
   K8 1) under 8c's damping 0.1, CUDA kernels a call at T=1024 and 16 000
   (must not grow), float32 against float64 (held to 1e-3; K5's index flips
   counted, and at the default damping 0.5 reported), K5 and K8 alone, a
   3-step ``fit_hyperparams(engine="ihgp")`` (K5 3, K8 3), and the value and
   gradient through K5's plain twin (the loop it ran before K8) at T=2048;
   the launch counters read 0 for K1-K4 and K7 over 8c-8f.
   Its line ``{"ihgp": ...}`` follows the training line.
9. the denoising path (``denoise_phase``): a raw signal to a trained model to
   denoised speech (experiments/denoising.py:55-160 on a seeded draw from the
   trained speech model's prior of speech0_female's length).  (a) the
   pretraining pipeline at T=4096 float64, exp and matern32, card vs CPU: end
   to end (the Whittle fit cut to 2 levels of 100 steps, one NMF start),
   reported with the CPU against itself on a 1e-14 perturbation of y as its
   yardstick; held at 1e-8: stages 2-5 from one stage-1 fit, and stage 1 at
   its first level with its moves; (b) the pipeline at full width
   (T=23 296, the pipeline's own steps), float32 then float64 on the card,
   timed by stage, Adam steps, CUDA kernels a step, peak memory and
   results/train_speech.json's columns; (c) the denoising protocol on (b)'s
   float32 model at the five noise levels (``denoise(backend="fused")``, 30
   sweeps, 200 draws, the time-varying Wiener read-out and its blend arms,
   the stationary Wiener baseline, SNR, log-spectral SNR, STOI, fwSegSNR),
   launch counters over one call (K3 1, K2 30, K1 29), and snr_out > snr_in
   at every level; (d) ``denoise`` at T=2048 float64, card (kernels) vs CPU
   (plain versions).  Its line ``{"denoise": ...}`` follows the IHGP line.
10. the experiment drivers (``experiments_phase``,
   ``nsgp_tpu_torch.experiments``) on seeded numpy draws from the trained
   models' priors written as 16 kHz wavs into ``build/chip_smoke_audio``:
   (a) the missing-data corpus grid ``run_batched`` over the ten exp music
   models at the reference protocol (T=53 248, itts 1 and 20, 200 draws),
   launch counts over the call (K4 4, K2 42, K1 38); (b) ``run_file`` on one
   file (K3) against a batched grid's row at 20 sweeps, n_samples=0, 1e-3 in
   float32; (c) batched GIEKF through the driver and alone on three files
   cut to T=1024, ms a step against one file alone, the last file against
   ``giekf_infer`` (1e-3, float32) and card against CPU (1e-8, float64);
   (d) the driver's IHGP arm on those files (K1-K4 launch 0 times); (e)
   ``synthetic.run`` and ``train_hyperopt.run_file`` at toy sizes.  Its line
   ``{"experiments": ...}`` follows the denoise line and lists every cut.

The line before the last is ``{"kernels": [...]}``: per kernel its launches
on its path, max abs error vs plain, its time at the path's shape beside the
plain version's and the least time the card could take (``bound_ms``); K1 and
K2 also their chunk length, chunks, threads and launches a pass, all of the
launch the error was measured on.  The
last is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Headline benchmark shape (bench.py:93-110, gtnmf_ep_sweep_100k).
D, N, T_MAIN, EP_ITTS = 16, 3, 100_000, 3
T_KERNEL = 4096
T_PLAIN = 20_000  # steps of the main shape that the plain versions run
T_REAL = 2048
TRAINED = os.path.join("results", "trained", "music", "trained_piano_matern32.npz")

# The batched corpus path: results/missing_data_music_batched.json (lengths,
# pad_T), six gaps of 2*160+1 samples around the reference's hand-picked
# centres (missing_data_music.m:55-75, 1-based).
MUSIC = os.path.join("results", "trained", "music", "trained_{}_matern32.npz")
CORPUS = os.path.join("results", "missing_data_music_batched.json")
GAP_HALF = 160
CORPUS_KW = dict(ep_fraction=0.75, damping=(0.1,))  # experiments/missing_data.py:71: the
# default (0.5, 0.5) lets EP diverge on the files with large modulator variances
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
}
# The mixture path (experiments/source_sep.py:30-45, 115-123).
SOURCES = [os.path.join("results", "trained", "source_sep", f"trained_011PFNOM_M{n}_exp.npz")
           for n in (60, 64, 67)]
T_MIX, T_MIX_F64, T_MIX_KERNEL = 16_000, 2048, 512
BF_MIX_KERNEL, T_MIX_FILES = 3, 128  # K4 with several clusters: files of the mixture model
MIX_KW = dict(s_chunk=256, moment_chunk=64, ep_fraction=0.75, damping=(0.025,), ep_itts=3,
              backend="fused")
MIX_LIK = 1e-4

# The training path (experiments/train_hyperopt.py): the ADF energy of the
# trained speech model, the reference's tuned groups and boxes (:41-49), lik
# fixed at 1e-3 for training and 1e-4 for the gap fill (protocol.W_LIK_MISSING),
# the gap fill at the script's 20 sweeps, fraction 0.75, damping 0.1
# (:104-115) around speech0_female's six gap centres (protocol.py).
SPEECH = os.path.join("results", "trained", "speech", "trained_speech0_female_exp.npz")
TRAIN_SPECS = {"lik": "fixed", "sub_var": "fixed", "sub_len": (100.0, 2000.0), "omega": "fixed",
               "mod_var": (1.0, 10.0), "mod_len": (200.0, 5000.0), "W": (0.0, 1.5)}
LIK_TRAIN, LIK_MISSING = 1e-3, 1e-4
SPEECH_GAPS = (1500, 5000, 7000, 9000, 13000, 18000)
EVAL_ITTS = 20
# T of each step: 7b and 7c at the script's training length 16 000, 7d at
# hmc_hypers' own 2000 (sweep 1 is K3 and K7 on the card); the card-vs-CPU
# checks where the CPU runs the plain twins, Python loops over T: 7a's
# gradients and K7's comparisons at 1024 (the mixture width at 128), 7a's fit
# at 256, 7e 256 for the card-vs-CPU check and 1024 for the float32 timing.
# The gap fill keeps the whole 20 000-sample signal, long enough for all six gaps.
T_GRAD, T_FIT_PARITY, T_TRAIN, T_FIT, T_GAPS = 1024, 256, 16_000, 16_000, 20_000
T_HMC, T_GIEKF, T_GIEKF_LONG = 2000, 256, 1024
T_VJP, T_VJP_MIX, VJP_GAP, VJP_OUTLIER = 1024, 128, (300, 340), 600
# experiments/hmc_hypers.py:45-71: the toy and its boxes
HMC_SPECS = {"lik": (1e-4, 0.1), "sub_var": "fixed", "sub_len": "fixed", "omega": "fixed",
             "mod_var": (0.5, 8.0), "mod_len": (50.0, 800.0), "W": "fixed"}
# Card vs CPU at float64 through the same code: summation order only.
TOL_TRAIN = 1e-8

# The IHGP path (phase 8): bench.py:222-228's two configs at the headline
# model; card vs CPU at float64 at T = 1024 (the EP one-level path at 256);
# float32 at the training length and at the headline length, the latter cut
# to 50 000 when sweep 1's measured us a step predicts over 150 s there; the
# mixture's IHGP settings (experiments/source_sep.py:110-114) and the corpus
# experiment's IHGP arm (experiments/missing_data.py:82-98, 20 sweeps cut to 3).
IH_SEQ = dict(ep_itts=3, damping=(0.1,), moment_chunk=8192)
IH_BLOCKED = dict(IH_SEQ, parallel=True, chunk=2048)
IH_MIX_KW = dict(grid_lo=-7.0, parallel=True, chunk=2048, ep_itts=3, damping=(0.025,),
                 ep_fraction=0.75)
IH_CORPUS_KW = dict(ep_itts=3, ep_fraction=0.75, damping=(0.1, 0.025), grid_lo=-7.0,
                    parallel=True, chunk=2048, keep_best=True)
T_IH_PARITY, T_IH_EP, T_IH_TRAIN, T_IH_CUT = 1024, 256, 16_000, 50_000
T_IH_MIX, T_IH_MIX_F64, T_IH_BATCH, BF_IH = 2048, 256, 4096, 3
IH_SWEEP1_LIMIT_S = 150.0
# K5 and K6 against their plain twins (a Python loop over T, 1-2 ms a step on
# the card): the twins over 4096 steps at the headline width, 256 at mixture
# width; the energy through K5's plain twin (the loop ihgp_energy ran before
# K8) timed over 2048 steps, forward alone and value and gradient.
T_IH_KERNEL, T_IH_MIX_KERNEL, T_IH_ENERGY = 4096, 256, 2048
TOL_IH_GRAD = 1e-9
# 8f, K8 against its plain twin (a reverse loop over T): T = 1024 at the
# headline width with a NaN gap, 128 at mixture width; the value and gradient
# of ihgp_energy and a 3-step fit at the training length T_IH_TRAIN.
T_IH_VJP, T_IH_VJP_MIX, IH_VJP_GAP, IH_FIT_STEPS = 1024, 128, (300, 340), 3

# The denoising path (phase 9): experiments/denoising.py:55-160 on one speech
# file at the settings of results/noise_reduction_speech.json (30 EP sweeps,
# fraction 0.75, damping 0.1, 200 Monte-Carlo draws, the time-varying Wiener
# read-out at stat_floor 1.0 and its blend arms) and results/train_speech.json
# (D=16, N=3, exp/matern52, 'sq', p_cubature 9, fs 16 000, the pipeline's own
# steps).  No audio in the repo: the clean signal is a seeded numpy draw from
# trained_speech0_female_exp.npz's prior of speech0_female's length at unit
# variance, and as in the reference protocol the signal trained on is the one
# denoised, padded with NaN to the corpus length.
T_SPEECH, T_SPEECH_PAD, FS_SPEECH = 23_296, 24_576, 16_000
NOISE_LEVELS = (0.01, 0.05, 0.1, 0.3, 0.5)  # experiments/protocol.py:31
DN_KW = dict(ep_itts=30, ep_fraction=0.75, damping=(0.1,), backend="fused")
N_MC, STAT_FLOOR, BLEND_ARMS = 200, 1.0, (0.0, 0.25, 0.5, 0.75, 1.0)
# 9a: the pipeline card vs CPU at float64 at T = 4096, the Whittle fit cut from
# 3 levels of 400 steps to 2 of 100 for the CPU's time (GPPAD, NMF and SE-GP at
# their own counts, one NMF start given to both); its yardstick is the CPU
# against itself on y * (1 + PERTURB * xi), xi a seeded standard normal draw
# (a uniform scale would vanish in the pipeline's normalisation).  9d: denoise
# at T = 2048, no draws.
T_PIPE_PARITY, PIPE_PARITY_FB, PERTURB = 4096, dict(num_levels=2, steps_per_level=100), 1e-14
T_DN_PARITY = 2048
# The stages of pretrain.pipeline.train_gtnmf_fixed_params as it calls them:
# (stage, the pipeline's name of the module, function).
PIPELINE_STAGES = (("whittle", "spectral", "fit_probstft_staged"),
                   ("filterbank", "fb_mod", "build_filterbank"),
                   ("filterbank", "fb_mod", "steady_filterbank"),
                   ("gppad", "gppad", "demodulate_channels"),
                   ("nmf", "nmf", "nmf_fp"),
                   ("segp", "segp", "fit_segp"))

# The experiment drivers (phase 10): experiments/missing_data.py's batched grid
# at the reference protocol (D=16, N=3, exp/matern52, 'sq', the reference gap
# tables, w_lik 1e-4, EP fraction 0.75 and damping 0.1, 200 Monte-Carlo draws)
# over the ten trained exp music models, each on a seeded numpy draw from its
# own prior written as a 16 kHz wav of the file's own length (no audio in the
# repo) into a gitignored directory of the checkout; then its serial twin,
# the batched GIEKF and IHGP arms on three files cut to T_CUT, and two more
# drivers at toy sizes.  Every cut with its reason lands in the phase's line.
EXP_MODELS = os.path.join("results", "trained", "music", "trained_{}_exp.npz")
EXP_AUDIO = os.path.join("build", "chip_smoke_audio")
GRID_ITTS, GRID_MC, SERIAL_ITTS = (1, 20), 200, 20
T_CUT, CUT_FILES, GIEKF_ITTS, IHGP_ITTS = 1024, ("cello", "guitar", "ocarina"), (1, 2), (1, 3)
T_SYN, SYN_ITTS, T_HO, HO_STEPS = 256, 2, 2048, 3
TOL_SERIAL = 1e-3  # K3's single-file path against K4 at batch width, float32
EXP_CUTS = {
    "audio": "no audio in the repo: each file is a seeded numpy draw from its trained exp "
             "model's prior at the file's own 16 kHz length "
             "(results/missing_data_music_batched.json), peak 0.9, 16-bit wav",
    "serial": "run_file and a second batched grid at the 20-sweep arm only, n_samples=0 in "
              "both: the Monte-Carlo read-outs differ by their draws",
    "giekf": f"T 53 248 -> {T_CUT} (three files cut), itts (1, 20) -> {GIEKF_ITTS}: GIEKF is "
             "a Python loop over T of dense (57 x 57) steps, 0.7-1.7 ms a step on the card; "
             "at T=2048 (c) and (d) took 96 s of a 159 s phase on a slow host",
    "ihgp": f"the same three files at T={T_CUT}, itts (1, 20) -> {IHGP_ITTS}: the arm's later "
            "sweeps run the blocked steady passes, Python loops over a 2048-step chunk, "
            "0.35-0.47 s a pass on the card (PERF.md); sweep 1 is one launch of K5",
    "synthetic": f"T 4000 -> {T_SYN}, ep_itts 4 -> {SYN_ITTS}: the engines' Python loops",
    "train_hyperopt": f"T 4096 -> {T_HO} (speech0_female's first reference gap at 1500 "
                      "fits): a value and gradient of the ADF energy costs about 7 ms a "
                      f"step on the card (PERF.md); {HO_STEPS} steps, the 20-sweep "
                      "evaluation kept",
}

# Kernel vs plain, relative to the reference output's max |value|.
# float64: the two differ only in summation order and FMA contraction
# (~1e-15 measured), so 1e-9 leaves six orders for T-long recursions.
TOL_F64 = 1e-9
# float32: eps is 6e-8; the filters are contractive, so rounding does not
# grow with T, but the ADF residual y - mean cancels digits once the sites
# converge and feeds back through the sites; 1e-3 still separates a
# wrong kernel (O(1) errors) from rounding.
TOL_F32 = 1e-3
# The same EP on the card (kernels) and the CPU (plain), float64.
TOL_REAL = 1e-8

# Published peaks of one H100 SXM: HBM3 bytes/s, float32 FLOP/s outside the
# tensor cores (the kernels use none).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12

# What each CUDA kernel replaces in the JAX package, and its source: the
# Pallas kernel bodies (K1-K4), and the two scans that JAX compiles IHGP's
# sequential passes into (K5, K6: counterparts of compiled scans, not of
# Pallas kernels).
KERNELS = {
    "fused_fwd": ("nsgp_tpu/ops/pallas_kalman.py:112", "fused_kalman.cuh"),  # _fwd_kernel
    "fused_bwd": ("nsgp_tpu/ops/pallas_kalman.py:158", "fused_kalman.cuh"),  # _bwd_kernel
    "fused_adf": ("nsgp_tpu/ops/pallas_kalman.py:226", "fused_adf.cuh"),  # _adf_kernel
    "fused_adf_mb": ("nsgp_tpu/ops/pallas_kalman.py:341", "fused_adf_mb.cuh"),  # _adf_kernel_mb
    # the lax.scan of _steady_filter_seq and of _steady_smoother
    "fused_ihgp_adf": ("nsgp_tpu/inference/ihgp.py:402", "fused_ihgp_adf.cuh"),
    "fused_ihgp_smooth": ("nsgp_tpu/inference/ihgp.py:658", "fused_ihgp_smooth.cuh"),
    # the transposed scan that jax.value_and_grad derives from adf_filter's lax.scan
    "fused_adf_vjp": ("nsgp_tpu/ops/kalman.py:239", "fused_adf_vjp.cuh"),
    # the transposed scan that jax.grad(ihgp_energy) derives from the lax.scan of
    # _steady_filter_seq
    "fused_ihgp_adf_vjp": ("nsgp_tpu/inference/ihgp.py:402", "fused_ihgp_adf_vjp.cuh"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# The least time the card could take: bytes (each input read once, each output
# written once) over the memory rate, against operations over the float32
# rate.  Operations per step from the kernels' arithmetic, a multiply-add
# counted as 2.
# ---------------------------------------------------------------------------


def filter_flops(bs: int) -> int:
    """One channel, one step: predict (A m, A P, (A P) A' + Q), the
    marginals (H m, P H, H' P H) and the rank-one site update."""
    return 4 * bs**3 + 8 * bs**2 + 6 * bs + 5


def smoother_flops(bs: int) -> int:
    """One channel, one step: predict, Cholesky (bs^3 / 3), the bs
    triangular solve pairs (2 bs^3), G dm and G dP G' (4 bs^3)."""
    return round(10.34 * bs**3) + 8 * bs**2


def sigma_flops(D_: int, N_: int) -> int:
    """One sigma point, one step: a = W link(x) (2 D N), sqrt / s2e / mean
    and the A1, A2 terms (11 D), x, link and the G1, G2 terms (11 N), the
    log-normaliser and weight (13), and one add per moment row."""
    return 2 * D_ * N_ + 11 * D_ + 11 * N_ + 13 + (1 + 2 * D_ + 2 * N_)


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by) on one H100 at its published float32 peaks."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FLOPS_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_fwd(T, C, bs, itemsize=4):
    n = T * C * (2 + bs + bs * bs) + C * (3 * bs * bs + bs)
    return bound(n * itemsize, T * C * filter_flops(bs))


def bound_bwd(T, C, bs, itemsize=4):
    n = 2 * T * C * (bs + bs * bs) + C * (2 * bs * bs + bs)
    return bound(n * itemsize, T * C * smoother_flops(bs))


def bound_adf(T, BF, D_, N_, S, bs, observed_steps, itemsize=4):
    """K3 (BF = 1) and K4.  ``observed_steps``: (file, step) pairs whose
    sample is observed; only those run the cubature."""
    C = D_ + N_
    n = T * BF * (2 + 1 + 2 * C + C * (bs + bs * bs)) + BF * (C * (3 * bs * bs + bs) + D_ * N_ + 1) \
        + S * (N_ + 1)
    flops = T * BF * C * filter_flops(bs) + observed_steps * (S * sigma_flops(D_, N_) + 12 * C)
    return bound(n * itemsize, flops)


def bound_adf_vjp(T, D_, N_, S, bs, observed_steps, cotangent_values, itemsize=4):
    """K7: reads K3's inputs, its filtered ms and Ps and ``cotangent_values``
    numbers of output cotangents, writes the parameters' cotangents.
    Operations three times K3's: re-deriving a step, then its reverse (reverse
    mode costs about twice the forward)."""
    C = D_ + N_
    params = C * (3 * bs * bs + bs) + D_ * N_ + 1
    n = T * (2 + C * (bs + bs * bs)) + cotangent_values + 2 * params + S * (N_ + 1)
    flops = 3 * (T * C * filter_flops(bs) + observed_steps * (S * sigma_flops(D_, N_) + 12 * C))
    return bound(n * itemsize, flops)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def synth_signal(rng, omegas, T):
    """A seeded unit-variance signal with energy in the model's bands: one
    narrow-band carrier per centre frequency under a slow positive envelope
    (the construction of bench.py:147-155)."""
    freqs = np.fft.rfftfreq(T) * 2 * np.pi
    yh = np.zeros(T)
    for om in omegas:
        spec = np.fft.rfft(rng.normal(size=T))
        spec *= np.exp(-0.5 * ((freqs - om) / 0.02) ** 2)
        carrier = np.fft.irfft(spec, T)
        c = np.cumsum(rng.normal(size=T + 2000))
        env = np.abs(c[2000:] - c[:-2000]) / 2000.0 + 0.05
        yh += carrier / (carrier.std() + 1e-12) * env
    return yh / yh.std()


def bench_inputs(dtype, device):
    """bench.py:98-110 parameters and the seeded numpy signal of
    bench.py:147-155 (same generator, W drawn first)."""
    import torch

    from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams

    model = GTNMFModel(D=D, N=N, kernel1="matern32", kernel2="matern52", p_cubature=9)
    rng = np.random.default_rng(0)
    omegas = np.linspace(0.05, 2.8, D)
    params = GTNMFParams(
        lik=np.float64(1e-3), sub_var=np.ones(D), sub_len=np.linspace(50.0, 300.0, D),
        omega=omegas, mod_var=np.full(N, 2.0),
        mod_len=np.linspace(800.0, 2500.0, N), W=rng.uniform(0.1, 1.0, (D, N)),
    ).to(dtype=dtype, device=device)
    y = synth_signal(rng, omegas, T_MAIN)
    return model, params, torch.tensor(y.astype(np.float32), device=device).to(dtype)


_MATERN = {"exp": (1.0, 1), "matern32": (3.0, 2), "matern52": (5.0, 3), "matern72": (7.0, 4)}


def _gp_paths(rng, kernel, var, ell, T, omega=0.0):
    """Seeded stationary GP paths (T, len(var)) by spectral synthesis:
    white noise shaped by the kernel's spectral density, a Matern of the given
    lengthscales centred at ``omega`` (the quasi-periodic subbands), scaled to
    the marginal variances.  Circular in T, which no phase here minds."""
    two_nu, power = _MATERN[kernel]
    lam = np.sqrt(two_nu) / np.asarray(ell)[:, None]
    w = (np.fft.rfftfreq(T) * 2 * np.pi)[None, :]
    om = np.broadcast_to(np.asarray(omega, dtype=float), lam.shape[:1])[:, None]
    dens = (lam**2 + (w - om) ** 2) ** -power + (lam**2 + (w + om) ** 2) ** -power
    spec = (rng.normal(size=dens.shape) + 1j * rng.normal(size=dens.shape)) * np.sqrt(dens)
    x = np.fft.irfft(spec, T, axis=1)
    x -= x.mean(1, keepdims=True) * (om == 0.0)
    return (x / x.std(1, keepdims=True) * np.sqrt(np.asarray(var))[:, None]).T


def prior_signal(rng, model, params, T):
    """A seeded numpy draw from a trained model's own prior: subbands and
    modulators from ``_gp_paths``, y = sum_d a_d z_d + noise with
    a = W softplus(g) ('amp') or its square root ('sq')."""
    p = {k: v.detach().cpu().numpy().astype(np.float64) for k, v in params.named_buffers()}
    z = _gp_paths(rng, model.kernel1, p["sub_var"], p["sub_len"], T, p["omega"])
    g = _gp_paths(rng, model.kernel2, p["mod_var"], p["mod_len"], T)
    a = np.logaddexp(g, 0.0) @ p["W"].T
    if model.variant == "sq":
        a = np.sqrt(a)
    return (a * z).sum(1) + np.sqrt(p["lik"]) * rng.normal(size=T)


def corpus_inputs(dtype, device):
    """The ten trained music models as one batch, each with a seeded numpy
    draw from its own prior of the file's own length, zero-padded to the
    corpus length, the reference's gaps, and the padding unobserved but not
    scored.  Returns (model, paramsB, yB, maskB, gapsB, lengths)."""
    import torch

    from nsgp_tpu_torch.convert import load_trained_batch

    with open(os.path.join(ROOT, CORPUS)) as f:
        rows = [r for r in json.load(f)["files"] if r["kernel1"] == "matern32"]
    names = [r["file"] for r in rows]
    pad_T = rows[0]["pad_T"]
    model, paramsB = load_trained_batch(
        [os.path.join(ROOT, MUSIC.format(n)) for n in names], device=device, dtype=dtype)
    yB = np.zeros((len(rows), pad_T))
    maskB = np.zeros((len(rows), pad_T), bool)
    gapsB = np.zeros((len(rows), pad_T), bool)
    for b, r in enumerate(rows):
        T_b = r["T"]
        yB[b, :T_b] = prior_signal(np.random.default_rng(100 + b), model, paramsB.select(b), T_b)
        maskB[b, :T_b] = True
        for p in GAP_POSITIONS[r["file"]]:
            gapsB[b, p - 1 - GAP_HALF: p + GAP_HALF] = True
    maskB &= ~gapsB
    as_t = lambda x, dt: torch.tensor(x, device=device).to(dt)
    return (model, paramsB, as_t(yB.astype(np.float32), dtype), as_t(maskB, torch.bool),
            as_t(gapsB, torch.bool), [r["T"] for r in rows])


def mixture_inputs(dtype, device, T):
    """Three trained source models and a seeded synthetic mixture with known
    parts: each part a numpy draw from its own model's prior, so the sum is a
    draw from the joint model's."""
    import torch

    from nsgp_tpu_torch.convert import load_trained

    models, params = zip(*[load_trained(os.path.join(ROOT, p), device=device, dtype=dtype)
                           for p in SOURCES])
    parts = np.stack([prior_signal(np.random.default_rng(200 + j), m, p, T)
                      for j, (m, p) in enumerate(zip(models, params))], axis=-1)
    parts = torch.tensor(parts.astype(np.float32), device=device).to(dtype)
    return models, params, parts.sum(-1), parts


def random_sites(T, C, seed):
    """Sites as in tests/test_pallas_kalman.py:32-37, from numpy."""
    rng = np.random.default_rng(seed)
    ttau = rng.uniform(0.0, 5.0, (T, C)) * (rng.uniform(size=(T, C)) > 0.2)
    return ttau, rng.normal(size=(T, C)) * ttau


def gappy_sites(T, C, seed):
    """``random_sites`` with runs of zero sites (five whole rows, seven steps
    of every third channel) and one long gap, a third of the signal."""
    ttau, tnu = random_sites(T, C, seed)
    live = np.ones((T, C))
    live[T // 8: T // 8 + 5] = 0.0
    live[T // 4: T // 4 + 7, ::3] = 0.0
    live[T // 2: T // 2 + T // 3] = 0.0
    return ttau * live, tnu * live


# ---------------------------------------------------------------------------
# Comparing and timing
# ---------------------------------------------------------------------------


def max_err(outs, refs):
    """(max abs error, max error relative to each reference's max |value|)."""
    worst_abs = worst_rel = 0.0
    for a, b in zip(outs, refs):
        d = (a - b).abs().max().item()
        scale = max(b.abs().max().item(), 1e-300)
        if not math.isfinite(d):
            return math.inf, math.inf
        worst_abs = max(worst_abs, d)
        worst_rel = max(worst_rel, d / scale)
    return worst_abs, worst_rel


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms over ``reps`` runs, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def host_s(fn):
    """(result, seconds on the host clock, synchronised at both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_plain(plain):
    """(outputs, device ms) of one run of a plain version."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = plain()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def compare(label, name, kern, plain, tol, time_reps, timed=None, rows=slice(None)):
    """Hold one kernel call against its plain version on the same inputs:
    ``plain`` is a call, or the (outputs, ms) of a run already made, and
    covers the rows ``rows`` of the kernel's outputs.  Time ``timed``
    (default: the same kernel call) over ``time_reps`` runs."""
    import torch

    out_k = kern()
    if not all(torch.equal(a, b) for a, b in zip(out_k, kern())):
        raise AssertionError(f"{name} ({label}): two runs on the same inputs differ in their bits")
    out_p, plain_ms = plain if isinstance(plain, tuple) else timed_plain(plain)
    err_abs, err_rel = max_err([x[rows] if x.dim() else x for x in out_k], out_p)
    ms = cuda_ms(timed or kern, time_reps)
    log(f"{label} {name}: max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (tol {tol:g}) "
        f"kernel_ms={ms:.3f} plain_ms={plain_ms:.1f}")
    if not err_rel <= tol:
        raise AssertionError(f"{name} ({label}) disagrees with its plain version: "
                             f"rel err {err_rel:.3e} > {tol:g}")
    return dict(max_abs_err=err_abs, max_rel_err=err_rel, ms=ms, plain_ms=plain_ms)


def adf_case(model, params, y, mask, steps=None):
    """(kernel call, plain call) for K3 on the card, same inputs, over the
    first ``steps`` steps (default: all)."""
    from nsgp_tpu_torch.ops import fused_kalman as fk

    ssm = model.build_ssm(params)
    dt_, dev = ssm.A.dtype, ssm.A.device
    n = steps or y.shape[0]
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, dt_, dev)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    args = (y[:n].to(dt_), mask[:n].to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H, params.W, xi, wn,
            params.lik)
    return lambda: fk.fused_adf(*args, **kw), lambda: fk.fused_adf_plain(*args, **kw)


def vjp_case(model, params, y, mask, only_lZ, g_lZ=None, seed=11):
    """(kernel call, plain call, K3's outputs) for K7 on the card, same
    inputs: K3's outputs, and seeded normal cotangents on all five outputs
    or on lZ alone (``g_lZ`` given: that one alone)."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    ssm = model.build_ssm(params)
    dt_, dev = ssm.A.dtype, ssm.A.device
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, dt_, dev)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor)
    args = (torch.nan_to_num(y).to(dt_), mask.to(dt_), ssm.A, ssm.Q, ssm.Pinf, ssm.H,
            params.W.to(dt_), xi, wn, params.lik.to(dt_))
    outs = fk.fused_adf(*args, **kw)
    rng = np.random.default_rng(seed)
    cots = [torch.tensor(rng.normal(size=tuple(o.shape)), dtype=dt_, device=dev)
            if i == 2 or not only_lZ else None for i, o in enumerate(outs)]
    if g_lZ is not None:
        cots = [None, None, g_lZ.to(dt_), None, None]
    vjp_args = args + (outs[0], outs[1], *cots)
    return (lambda: fk.fused_adf_vjp(*vjp_args, **kw),
            lambda: fk.fused_adf_vjp_plain(*vjp_args, **kw), outs)


def kalman_compare(label, ssm, sites_np, tol, time_reps):
    """K1 and K2 on the card against their sequential plain versions over all
    the steps of ``sites_np``, at the wrappers' own chunk length for that
    length.  K2 smooths the plain K1 trajectory, so both see identical
    inputs.  Returns {name: numbers}."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in sites_np)
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    fwd_args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    ref_f = timed_plain(lambda: fk.fused_fwd_plain(*fwd_args))
    bwd_args = (*ref_f[0], ssm.A, ssm.Q, pad)
    shape = fk.blocked_launch_shape(*tt.shape)
    label = f"{label} chunk={shape['chunk']}"
    return {"fused_fwd": compare(label, "fused_fwd", lambda: fk.fused_fwd(*fwd_args), ref_f,
                                 tol, time_reps),
            "fused_bwd": compare(label, "fused_bwd", lambda: fk.fused_bwd(*bwd_args),
                                 lambda: fk.fused_bwd_plain(*bwd_args), tol, time_reps)}


def kalman_path_checks(label, ssm, sites_np, n_plain, tol, time_reps=3):
    """K1 and K2 at a main path's own shape, over all T of ``sites_np`` and so
    with the chunk length and the chunks the path launches.  The plain
    versions are Python loops over T, so they run ``n_plain`` steps: K1's
    first ``n_plain`` rows against the plain filter of those steps (the filter
    is causal), K2's last ``n_plain`` rows against the plain smoother of that
    tail of the same filtered trajectory (the smoother starts at the end).
    Over all T each is held against the same kernel run as one chunk, which is
    the sequential pass that the ragged checks hold against the plain version:
    that covers the carries of every chunk.  Returns {name: numbers}, timed
    over all T."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in sites_np)
    T, C = tt.shape
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    model_args = (ssm.A, ssm.Q, ssm.Pinf, ssm.H)
    shape = fk.blocked_launch_shape(T, C)
    label = f"{label} T={T} C={C} chunk={shape['chunk']} chunks={shape['chunks']}"
    fwd = lambda **kw: fk.fused_fwd(tt, tn, *model_args, **kw)
    filtered = fwd()
    bwd = lambda **kw: fk.fused_bwd(*filtered, ssm.A, ssm.Q, pad, **kw)
    head, tail = slice(0, n_plain), slice(T - n_plain, T)
    out = {
        "fused_fwd": compare(f"{label} (plain over the first {n_plain} steps)", "fused_fwd", fwd,
                             lambda: fk.fused_fwd_plain(tt[head], tn[head], *model_args), tol,
                             time_reps, rows=head),
        "fused_bwd": compare(f"{label} (plain over the last {n_plain} steps)", "fused_bwd", bwd,
                             lambda: fk.fused_bwd_plain(filtered[0][tail], filtered[1][tail],
                                                        ssm.A, ssm.Q, pad), tol, time_reps,
                             rows=tail),
    }
    for name, kern in (("fused_fwd", fwd), ("fused_bwd", bwd)):
        err_abs, err_rel = max_err(kern(), kern(_chunk=T))
        log(f"{label} {name}: all T against the one-chunk kernel max_abs_err={err_abs:.3e} "
            f"max_rel_err={err_rel:.3e} (tol {tol:g})")
        if not err_rel <= tol:
            raise AssertionError(f"{name} ({label}): the blocked passes disagree with the "
                                 f"sequential pass over all T: rel err {err_rel:.3e} > {tol:g}")
        out[name].update(one_chunk_max_abs_err=err_abs, plain_steps=n_plain, **shape)
    return out


def adf_mb_case(model, paramsB, yB, maskB, s_chunk, steps=None, **kernel_only):
    """(kernel call, plain call) for K4; yB, maskB (BF, T).  ``kernel_only``
    goes to the kernel's wrapper alone (the cycle probe's library)."""
    from nsgp_tpu_torch.ops import fused_kalman as fk

    ssmB = model.build_ssm_batch(paramsB)
    dt_, dev = ssmB.A.dtype, ssmB.A.device
    mp = model.moment_params()
    wn, xi = fk.sigma_points(mp, dt_, dev)
    n = steps or yB.shape[1]
    args = (yB[:, :n].T.contiguous().to(dt_), maskB[:, :n].T.contiguous().to(dt_), ssmB.A,
            ssmB.Q, ssmB.Pinf, ssmB.H, paramsB.W, xi, wn, paramsB.lik)
    kw = dict(damp=0.5, link=mp.link, variant=mp.variant, z_floor=mp.z_floor, s_chunk=s_chunk)
    return (lambda: fk.fused_adf_mb(*args, **kw, **kernel_only),
            lambda: fk.fused_adf_mb_plain(*args, **kw))


def blocked_checks(label, ssm, tol, seed, path_chunk, longest=True):
    """K1 and K2 (three blocked passes over chunks of T) against their
    sequential plain versions at ragged lengths: one step, just under a
    chunk, one chunk, a chunk and one step, and (``longest``) 4096 steps in
    chunks of ``path_chunk``, the length the main path at this width launches
    with; twice each for the same bits; padded state dims exactly zero."""
    import torch

    from nsgp_tpu_torch.ops import fused_kalman as fk

    dt_, dev = ssm.A.dtype, ssm.A.device
    C = ssm.num_channels
    pad = torch.diagonal(ssm.pad_eye, dim1=-2, dim2=-1)
    dead = pad > 0
    L = fk.MIN_CHUNK
    for T in (1, 31, L, L + 1, T_KERNEL)[:None if longest else -1]:
        tt, tn = (torch.tensor(x, dtype=dt_, device=dev) for x in gappy_sites(T, C, seed))
        fwd_args = (tt, tn, ssm.A, ssm.Q, ssm.Pinf, ssm.H)
        ref_f = fk.fused_fwd_plain(*fwd_args)
        bwd_args = (*ref_f, ssm.A, ssm.Q, pad)
        chunk = path_chunk if T == T_KERNEL else None
        shape = fk.blocked_launch_shape(T, C, chunk)
        errs = {}
        for name, kern, plain in (("fused_fwd", fk.fused_fwd, lambda: ref_f),
                                  ("fused_bwd", fk.fused_bwd,
                                   lambda: fk.fused_bwd_plain(*bwd_args))):
            args = fwd_args if name == "fused_fwd" else bwd_args
            out = kern(*args, _chunk=chunk)
            if not all(torch.equal(a, b) for a, b in zip(out, kern(*args, _chunk=chunk))):
                raise AssertionError(f"{name} ({label} T={T}): two runs differ in their bits")
            if bool(dead.any()) and (float(out[0][:, dead].abs().max()) != 0.0 or float(
                    (out[1] * (pad[:, :, None] + pad[:, None, :])).abs().max()) != 0.0):
                raise AssertionError(f"{name} ({label} T={T}): a padded state dim is not zero")
            errs[name] = max_err(out, plain())[1]
        log(f"{label} C={C} T={T} chunk={shape['chunk']} chunks={shape['chunks']}: "
            f"max_rel_err fused_fwd={errs['fused_fwd']:.3e} fused_bwd={errs['fused_bwd']:.3e} "
            f"(tol {tol:g})")
        for name, err in errs.items():
            if not err <= tol:
                raise AssertionError(f"{name} ({label} C={C} T={T}) disagrees with its "
                                     f"sequential plain version: rel err {err:.3e} > {tol:g}")


def check_posterior(label, nlZ, Eft, Varft, shape):
    import torch

    if tuple(Eft.shape) != shape or tuple(Varft.shape) != shape:
        raise AssertionError(f"{label}: shapes {tuple(Eft.shape)}, {tuple(Varft.shape)} != {shape}")
    if not (bool(torch.isfinite(nlZ).all()) and bool(torch.isfinite(Eft).all())
            and bool(torch.isfinite(Varft).all()) and bool((Varft > 0).all())):
        raise AssertionError(f"{label}: non-finite energies or non-positive / non-finite "
                             f"variances")


def speech_inputs(dtype, device, T):
    """The trained speech model with the training init of train_hyperopt.py
    (lik at 1e-3, the tuned groups clipped into their boxes' interiors as
    ``_clip_into`` does) and a seeded numpy draw of T samples from its prior."""
    import torch

    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.models.gtnmf import GTNMFParams

    model, p = load_trained(os.path.join(ROOT, SPEECH), device="cpu", dtype=torch.float64)
    leaves = {k: v.clone() for k, v in p.named_buffers()}
    leaves["lik"] = torch.tensor(LIK_TRAIN, dtype=torch.float64)
    for g, spec in TRAIN_SPECS.items():
        if isinstance(spec, tuple):
            lo, hi = spec
            leaves[g] = leaves[g].clamp(lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))
    init = GTNMFParams(**leaves)
    y = prior_signal(np.random.default_rng(300), model, init, T)
    return (model, init.on(device).to(dtype),
            torch.tensor(y, device=device).to(dtype))


def energy_and_grad(model, init, y, itts, device):
    """ep_energy and its gradient with respect to the unconstrained u of
    TRAIN_SPECS, on ``device``: (energy, flat gradient) on the CPU."""
    import torch

    from nsgp_tpu_torch.inference.ep import EPConfig, ep_energy
    from nsgp_tpu_torch.inference.learn import Transform

    tf = Transform(TRAIN_SPECS)
    init = init.on(device)
    u = {g: v.detach().requires_grad_(True) for g, v in tf.to_unconstrained(init).items()}
    e = ep_energy(model, tf.to_params(u, init), y, None, EPConfig(ep_itts=itts), device=device)
    grads = torch.autograd.grad(e, list(u.values()))
    return e.detach().cpu(), torch.cat([g.reshape(-1) for g in grads]).cpu()


def rel_err(a, b) -> float:
    """max |a - b| relative to max |b|, in float64."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))


def require(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def training_phase(smi, dev):
    """Phase 7: the training path on the card ``dev``: ``ep_energy``'s sweep 1
    through K3 and its adjoint K7, later sweeps autograd through the
    sequential engine; then a gap fill on the fused path with what it
    learned.  Returns the numbers of the ``training`` line (K7's kernel
    numbers under ``fused_adf_vjp``)."""
    import torch

    from nsgp_tpu_torch.apps.missing_data import fill_gaps
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_energy
    from nsgp_tpu_torch.inference.giekf import GIEKFConfig, giekf_energy, giekf_infer
    from nsgp_tpu_torch.inference.hmc import HMCConfig, hmc_sample, make_log_post, vi_fit
    from nsgp_tpu_torch.inference.learn import Transform, fit_hyperparams, make_energy_fn
    from nsgp_tpu_torch.models import mixture
    from nsgp_tpu_torch.models.gtnmf import GTNMFModel, GTNMFParams
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.tools.probe_train import kernels_per_step

    t_phase = time.perf_counter()
    out = {"device": smi}

    # ---- 7a: K7 against its plain twin; card vs CPU, float64 ------------------
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    vjp_checks = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        model, p_v, y_v = speech_inputs(dtype, dev, T_VJP)
        mask_v = torch.ones(T_VJP, dtype=torch.bool, device=dev)
        mask_v[VJP_GAP[0]:VJP_GAP[1]] = False  # a NaN gap
        y_v = torch.where(mask_v, y_v, torch.full_like(y_v, math.nan))
        y_v[VJP_OUTLIER] = 50.0 * y_v[mask_v].std()  # drives Z under its floor
        for cots in ("all", "lZ"):
            kern, plain, outs = vjp_case(model, p_v, y_v, mask_v, cots == "lZ")
            floor = math.log(model.z_floor)
            require(abs(outs[2][VJP_OUTLIER].item() - floor) <= 1e-6 * abs(floor),
                    "phase7a: the outlier does not reach the Z floor")
            vjp_checks[f"{label}_{cots}"] = compare(
                f"phase7a {label} T={T_VJP} D={model.D} N={model.N} S=77 gap {VJP_GAP} outlier "
                f"at {VJP_OUTLIER}, cotangents on {cots}", "fused_adf_vjp", kern, plain, tol, 3)
        models, plist, y_mix, _ = mixture_inputs(dtype, dev, T_VJP_MIX)
        jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
        kern, plain, _ = vjp_case(jm, jp, y_mix, torch.ones_like(y_mix, dtype=torch.bool), False)
        vjp_checks[f"{label}_mixture"] = compare(
            f"phase7a {label} T={T_VJP_MIX} D={jm.D} N={jm.N} S=3973 (one CTA, rounds)",
            "fused_adf_vjp", kern, plain, tol, 1)
    model, init64, y64 = speech_inputs(torch.float64, "cpu", T_GAPS)
    C = model.D + model.N
    for itts in (1, 3):
        (e_c, g_c), s_card = host_s(lambda: energy_and_grad(model, init64, y64[:T_GRAD].to(dev),
                                                            itts, dev))
        t0 = time.perf_counter()
        e_h, g_h = energy_and_grad(model, init64, y64[:T_GRAD], itts, "cpu")
        s_cpu = time.perf_counter() - t0
        e_rel, g_rel = rel_err(e_c, e_h), rel_err(g_c, g_h)
        log(f"phase7a ep_energy ep_itts={itts} T={T_GRAD} f64 ({model.variant}, D={model.D}, "
            f"N={model.N}, C={C}): energy {e_c.item():.10g}, card vs cpu rel {e_rel:.3e}, "
            f"gradient ({g_c.numel()} unconstrained) rel to max {g_rel:.3e} (tol {TOL_TRAIN:g}); "
            f"value+grad card {s_card:.2f} s, cpu {s_cpu:.2f} s")
        require(e_rel <= TOL_TRAIN and g_rel <= TOL_TRAIN,
              f"ep_energy (ep_itts={itts}) on the card disagrees with the CPU")
        out[f"grad_parity_itts{itts}"] = dict(energy_rel=e_rel, grad_rel=g_rel, card_s=s_card,
                                              cpu_s=s_cpu)
    fit = lambda device: fit_hyperparams(model, init64, y64[:T_FIT_PARITY], specs=TRAIN_SPECS,
                                         steps=3, learning_rate=1e-2, device=device, ep_itts=1)
    fc, fh = fit(None), fit("cpu")  # the default device: the card
    require(fc.energies.device.type == dev.type, "fit_hyperparams did not run on the card")
    f_rel = max([rel_err(fc.energies.cpu(), fh.energies)]
                + [rel_err(a.cpu(), b) for a, b in zip(fc.params.leaves(), fh.params.leaves())])
    log(f"phase7a fit_hyperparams 3 Adam steps T={T_FIT_PARITY} f64: energies "
        f"{fc.energies.cpu().tolist()}, card vs cpu (energies and params) rel {f_rel:.3e} "
        f"(tol {TOL_TRAIN:g})")
    require(f_rel <= TOL_TRAIN, "fit_hyperparams on the card disagrees with the CPU")
    out["fit_parity_rel"] = f_rel

    # ---- 7b: the training shape, float32 ----------------------------------------
    _, init32, y32 = speech_inputs(torch.float32, dev, T_GAPS)
    cfg1 = EPConfig(ep_itts=1)
    energy32 = lambda p, T_: ep_energy(model, p, y32[:T_], None, cfg1)
    with torch.no_grad():
        energy32(init32, T_TRAIN)  # warm-up
        e_fwd, fwd_s = host_s(lambda: energy32(init32, T_TRAIN))
    torch.cuda.reset_peak_memory_stats()
    fk.reset_launches()
    (e32, g32), vg_s = host_s(lambda: energy_and_grad(model, init32, y32[:T_TRAIN], 1, dev))
    vg_launches = counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    want = {"fused_fwd": 0, "fused_bwd": 0, "fused_adf": 1, "fused_adf_mb": 0, "fused_adf_vjp": 1}
    require(vg_launches == want, f"phase7b: a value and gradient launched {vg_launches}, not {want}")
    (e64, g64), vg64_s = host_s(lambda: energy_and_grad(model, init64, y64[:T_TRAIN].to(dev), 1,
                                                        dev))
    e_gap, g_gap = rel_err(e32, e64), rel_err(g32, g64)
    per_call = {}
    for T_ in (T_GRAD, T_TRAIN):  # no eager per-step loop: kernels a call do not grow with T
        (k_fwd, k_bwd), (b_fwd, b_bwd), (w_fwd, w_bwd) = kernels_per_step(
            lambda p: energy32(p, T_), init32, T_)
        per_call[T_] = dict(kernels_forward=k_fwd * T_, kernels_backward=k_bwd * T_,
                            device_busy_s=1e-6 * (b_fwd + b_bwd) * T_,
                            traced_wall_s=1e-6 * (w_fwd + w_bwd) * T_,
                            idle_share=1.0 - (b_fwd + b_bwd) / (w_fwd + w_bwd))
    grow = ((per_call[T_TRAIN]["kernels_forward"] + per_call[T_TRAIN]["kernels_backward"])
            / (per_call[T_GRAD]["kernels_forward"] + per_call[T_GRAD]["kernels_backward"]))
    require(grow <= 1.1, f"phase7b: CUDA kernels a call grow {grow:.2f}x from T={T_GRAD} to "
                         f"{T_TRAIN}: a per-step loop")
    # K3 and K7 alone on this run's inputs, lZ's cotangent the one a value and
    # gradient at ep_itts=1 gives (-1 on every step)
    kern, _, outs = vjp_case(model, init32, y32[:T_TRAIN], torch.ones(T_TRAIN, dtype=torch.bool,
                                                                      device=dev), True,
                             g_lZ=-torch.ones(T_TRAIN, device=dev))
    k7_ms = cuda_ms(kern, 3)
    k3_ms = cuda_ms(adf_case(model, init32, y32[:T_TRAIN],
                             torch.ones(T_TRAIN, dtype=torch.bool, device=dev))[0], 3)
    bs_t = model.build_ssm(init32).block_size
    pc = per_call[T_TRAIN]
    log(f"phase7b ep_energy T={T_TRAIN} f32 on {smi}: forward alone {fwd_s:.3f} s "
        f"({1e6 * fwd_s / T_TRAIN:.1f} us/step); value+grad {vg_s:.3f} s "
        f"({1e6 * vg_s / T_TRAIN:.1f} us/step), launches {vg_launches}; K3 alone {k3_ms:.2f} ms, "
        f"K7 alone {k7_ms:.2f} ms ({1e3 * k7_ms / T_TRAIN:.2f} us/step); peak memory "
        f"{peak_mib:.0f} MiB; CUDA kernels a call (traced) forward {pc['kernels_forward']:.0f}, "
        f"backward {pc['kernels_backward']:.0f} (at T={T_GRAD}: "
        f"{per_call[T_GRAD]['kernels_forward']:.0f}, "
        f"{per_call[T_GRAD]['kernels_backward']:.0f}), device busy {pc['device_busy_s']:.3f} of "
        f"{pc['traced_wall_s']:.3f} s (idle share {pc['idle_share']:.3f}); f64 value+grad "
        f"{vg64_s:.3f} s")
    log(f"phase7b f32 vs f64 at T={T_TRAIN}: energy {e32.item():.8g} vs {e64.item():.8g}, rel gap "
        f"{e_gap:.3e} (bar 1e-3); gradient rel to max {g_gap:.3e}; forward-alone energy "
        f"{e_fwd.item():.8g}")
    require(math.isfinite(e_gap) and e_gap < 1e-3, "float32 energy drifted from float64")
    require(bool(torch.isfinite(g32).all()), "non-finite float32 gradient")
    out["t16000"] = dict(T=T_TRAIN, forward_s=fwd_s, value_grad_s=vg_s,
                         forward_us_per_step=1e6 * fwd_s / T_TRAIN,
                         value_grad_us_per_step=1e6 * vg_s / T_TRAIN, launches=vg_launches,
                         k3_ms=k3_ms, k7_ms=k7_ms, per_call=per_call, peak_mib=peak_mib,
                         energy_rel_gap_f64=e_gap, grad_rel_gap_f64=g_gap,
                         value_grad_f64_s=vg64_s)
    out["fused_adf_vjp"] = dict(
        launches=vg_launches["fused_adf_vjp"], ms=k7_ms,
        max_abs_err=vjp_checks["f32_lZ"]["max_abs_err"], plain_ms=vjp_checks["f32_lZ"]["plain_ms"],
        plain_steps=T_VJP, bound=bound_adf_vjp(T_TRAIN, model.D, model.N, 77, bs_t, T_TRAIN,
                                               T_TRAIN),
        shape=f"T={T_TRAIN} D={model.D} N={model.N} S=77 bs={bs_t} f32",
        checks=vjp_checks)

    # ---- 7c: a trainer that takes a few steps, then uses what it learned --------
    fk.reset_launches()
    fit32, fit_s = host_s(lambda: fit_hyperparams(model, init32, y32[:T_FIT], specs=TRAIN_SPECS,
                                                    steps=3, learning_rate=1e-2, ep_itts=1))
    fit_launches = counts()
    require(fit_launches["fused_adf"] == 3 and fit_launches["fused_adf_vjp"] == 3,
            f"phase7c: 3 Adam steps launched {fit_launches}, not K3 3 and K7 3")
    require(bool(torch.isfinite(fit32.energies).all()), "non-finite training energies")
    gaps = torch.zeros(T_GAPS, dtype=torch.bool)
    for c in SPEECH_GAPS:
        gaps[c - 1 - GAP_HALF: c + GAP_HALF] = True
    snr = {}
    want = {"fused_fwd": EVAL_ITTS - 1, "fused_bwd": EVAL_ITTS, "fused_adf": 1, "fused_adf_mb": 0,
            "fused_adf_vjp": 0}
    for name, p in (("init", init32), ("learned", fit32.params)):
        leaves = {k: v for k, v in p.named_buffers()}
        leaves["lik"] = torch.tensor(LIK_MISSING, dtype=torch.float32, device=dev)
        fk.reset_launches()
        g, s = host_s(lambda: fill_gaps(model, GTNMFParams(**leaves), y32, ~gaps.to(dev),
                                        engine="ep", n_samples=200, backend="fused",
                                        ep_itts=EVAL_ITTS, ep_fraction=0.75, damping=(0.1,),
                                        generator=torch.Generator(device=dev).manual_seed(0)))
        counts = {fn.__name__: fn.launches for fn in fk.WRAPPERS}
        require(counts == want, f"gap fill launches {counts} != {want}")
        require(math.isfinite(g.snr_gaps.item()), "non-finite gap SNR")
        snr[name] = g.snr_gaps.item()
        log(f"phase7c fill_gaps ({name} hypers, lik {LIK_MISSING:g}) T={T_GAPS} {EVAL_ITTS} sweeps "
            f"fused f32: gap SNR {snr[name]:.3f} dB, {s:.2f} s, launches {counts}")
    log(f"phase7c fit_hyperparams 3 Adam steps T={T_FIT} f32 on the card: {fit_s:.2f} s, launches "
        f"{fit_launches}, energies "
        f"{fit32.energies.cpu().tolist()}; learned mod_len "
        f"{fit32.params.mod_len.cpu().tolist()} (synthetic signal: SNRs not asserted)")
    out["fit"] = dict(T=T_FIT, steps=3, s=fit_s, energies=fit32.energies.cpu().tolist(),
                      launches=fit_launches)
    out["gap_snr_db"] = snr

    # ---- 7d: HMC and VI on the hmc_hypers toy ---------------------------------
    hmodel = GTNMFModel(D=4, N=2, kernel1="matern32", kernel2="matern52", p_cubature=7)
    rng = np.random.default_rng(0)
    truth = GTNMFParams(lik=np.float64(1e-2), sub_var=np.ones(4), sub_len=np.linspace(40, 120, 4),
                        omega=np.linspace(0.3, 2.2, 4), mod_var=np.full(2, 2.0),
                        mod_len=np.linspace(150.0, 300.0, 2), W=rng.uniform(0.2, 1.0, (4, 2)))
    y_h = torch.tensor(prior_signal(rng, hmodel, truth, T_HMC), device=dev)
    truth = truth.on(dev)
    tf = Transform(HMC_SPECS)
    log_post = make_log_post(make_energy_fn(hmodel, y_h, engine="ep", ep_itts=1), tf, truth)
    start = GTNMFParams(*(x * f for x, f in zip(truth.leaves(), (3.0, 1, 1, 1, 0.5, 1.5, 1))))
    u0 = tf.to_unconstrained(start)
    hcfg = HMCConfig(n_samples=3, n_warmup=3, n_leapfrog=3, init_step_size=0.05)
    run = lambda: hmc_sample(torch.Generator().manual_seed(1), log_post, u0, hcfg, n_chains=2,
                             jitter_init=0.2)
    h1, hmc_s = host_s(run)
    h2 = run()
    vrun = lambda: vi_fit(torch.Generator().manual_seed(2), log_post, u0, steps=3, n_mc=2)
    v1, vi_s = host_s(vrun)
    v2 = vrun()
    dim = sum(v.numel() for v in u0.values())
    require(h1.samples.shape == (2, 3, dim) and h1.samples.device.type == dev.type, "HMC shapes")
    require(all(bool(torch.isfinite(x).all()) for x in (h1.samples, h1.accept_rate, h1.step_size,
                                                      v1.mean, v1.log_std, v1.elbo_trace)),
          "non-finite HMC/VI")
    same = (torch.equal(h1.samples, h2.samples) and torch.equal(h1.step_size, h2.step_size)
            and torch.equal(v1.mean, v2.mean) and torch.equal(v1.elbo_trace, v2.elbo_trace))
    require(same, "two HMC/VI runs from one seed differ")
    log(f"phase7d hmc_hypers toy (D=4, N=2, T={T_HMC}) HMC 2 chains x (3 warm-up + 3 draws, 3 "
        f"leapfrog): {hmc_s:.2f} s, accept {h1.accept_rate.cpu().tolist()}, step "
        f"{h1.step_size.cpu().tolist()}; VI 3 steps x 2 draws {vi_s:.2f} s, ELBO "
        f"{v1.elbo_trace.cpu().tolist()}; same bits from one seed: {same}")
    out["hmc"] = dict(T=T_HMC, hmc_s=hmc_s, vi_s=vi_s, same_bits=same)

    # ---- 7e: GIEKF at the speech model's full width -----------------------------
    gcfg = GIEKFConfig()
    y_g = y64[:T_GIEKF]
    rc, gi_s = host_s(lambda: giekf_infer(model, init64, y_g, None, gcfg))
    rh = giekf_infer(model, init64, y_g, None, gcfg, device="cpu")
    m_dim = rc.ms.shape[-1]
    i_rel = max(rel_err(a.cpu(), b) for a, b in ((rc.Eft, rh.Eft), (rc.Varft, rh.Varft),
                                                 (rc.nll, rh.nll)))
    leaf_grads = []
    for d in (dev, "cpu"):
        leaves = {k: v.detach().to(d).requires_grad_(True) for k, v in init64.named_buffers()}
        e = giekf_energy(model, GTNMFParams(**leaves), y_g, None, gcfg, device=d)
        leaf_grads.append(torch.cat([e.reshape(1).detach()] + [
            g.reshape(-1) for g in torch.autograd.grad(e, list(leaves.values()))]).cpu())
    e_rel = rel_err(*leaf_grads)
    _, init32_g, y32_g = speech_inputs(torch.float32, dev, T_GIEKF_LONG)
    r32, long_s = host_s(lambda: giekf_infer(model, init32_g, y32_g, None, gcfg))
    require(bool(torch.isfinite(r32.Eft).all()), "non-finite float32 GIEKF posterior")
    log(f"phase7e giekf (dense m={m_dim}, g_iter={gcfg.g_iter}, l_iter={gcfg.l_iter}) T={T_GIEKF} "
        f"f64: infer card vs cpu rel {i_rel:.3e}, energy and gradient rel {e_rel:.3e} (tol "
        f"{TOL_TRAIN:g}); infer on the card {gi_s:.2f} s; f32 giekf_infer T={T_GIEKF_LONG} "
        f"{long_s:.2f} s ({1e6 * long_s / T_GIEKF_LONG:.0f} us/step)")
    require(m_dim == 57 and i_rel <= TOL_TRAIN and e_rel <= TOL_TRAIN,
          "GIEKF on the card disagrees with the CPU")
    out["giekf"] = dict(m=m_dim, T=T_GIEKF, infer_rel=i_rel, energy_grad_rel=e_rel,
                        infer_card_s=gi_s, f32_T=T_GIEKF_LONG, f32_infer_s=long_s)
    out["phase7_s"] = time.perf_counter() - t_phase
    log(f"phase7 done in {out['phase7_s']:.0f} s")
    return out


def k5_inputs(model, params, y, cfg, mask=None):
    """What ``ihgp_infer`` hands K5's wrapper on sweep 1 of (model, params,
    y) (zero sites, every step matched, observed where ``mask``, default
    all): (args, kwargs, tables), taken by passing a recorder as the
    engine's sweep."""
    import torch

    from nsgp_tpu_torch.inference import ihgp
    from nsgp_tpu_torch.ops.kalman import Sites

    got = {}

    def record(*a, **k):
        got["args"], got["kwargs"] = a, k
        return (None,) * 5

    ssm = model.build_ssm(params)
    tables = ihgp.build_tables(ssm, cfg)
    zeros = torch.zeros((y.shape[0], ssm.num_channels), dtype=ssm.A.dtype, device=y.device)
    seen = torch.ones(y.shape[0], dtype=torch.bool, device=y.device)
    ihgp._steady_filter_seq(ssm, tables, torch.nan_to_num(y), seen if mask is None else mask,
                            Sites(zeros, zeros), model.moment_params(), params.W, params.lik,
                            cfg.damp(0), seen, sweep=record)
    return got["args"], got["kwargs"], tables


def k8_case(model, params, y, cfg, mask=None, g_lZ=None, seed=13):
    """(kernel call, plain call, K5's outputs) for K8 on the card, same
    inputs: K5's outputs on sweep 1 of (model, params, y) (the forward's
    indices for both) and seeded normal cotangents on ms, lZ, ttau and tnu
    (``g_lZ`` given: that one alone)."""
    import torch

    from nsgp_tpu_torch.ops import fused_ihgp as fih

    args, kw, _ = k5_inputs(model, params, y, cfg, mask)
    outs = fih.fused_ihgp_adf(*args, **kw)
    ms, idx, lZ, tt, tn = outs
    rng = np.random.default_rng(seed)
    cots = [torch.tensor(rng.normal(size=tuple(o.shape)), dtype=o.dtype, device=o.device)
            for o in (ms, lZ, tt, tn)]
    if g_lZ is not None:
        cots = [None, g_lZ.to(lZ.dtype), None, None]
    vjp_args = args + (ms, idx, tt, *cots)
    return (lambda: fih.fused_ihgp_adf_vjp(*vjp_args, **kw),
            lambda: fih.fused_ihgp_adf_vjp_plain(*vjp_args, **kw), outs)


@contextlib.contextmanager
def swapped(mod, name, fn):
    """``mod.name`` is ``fn`` inside the block."""
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, old)


def steady_compare(label, name, got, ref, tol, plain_ms=None):
    """Hold K5's outputs (ms, idx, lZ, ttau, tnu) against its twin's on the
    rows the twin ran.  float64 (``tol`` given): grid indices equal and the
    rest within ``tol``.  float32 (``tol`` None): a flipped index sends the
    trajectory to the neighbouring table row, so the error is taken over the
    rows before the first flip; the flips are counted and the energy
    (-sum lZ) over the rows held to the float32 health bar, 1e-3."""
    n_ref = ref[0].shape[0]
    got = [x[:n_ref] for x in got]
    flips = got[1] != ref[1]
    n_flips = int(flips.sum().item())
    rows = flips.any(dim=1)
    first = int(rows.nonzero()[0, 0].item()) if n_flips else n_ref
    floats = lambda xs: [xs[0], xs[2], xs[3], xs[4]]
    err_abs, err_rel = max_err([x[:first] for x in floats(got)], [x[:first] for x in floats(ref)])
    e_gap = rel_err(-got[2].double().sum(), -ref[2].double().sum())
    log(f"{label} {name}: {n_flips} index flips of {flips.numel()} (first at step "
        f"{first}), before it max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e}"
        f"{'' if tol is None else f' (tol {tol:g})'}; energy rel gap {e_gap:.3e}"
        f"{'' if plain_ms is None else f'; plain_ms={plain_ms:.1f} over {n_ref} steps'}")
    if tol is not None:
        require(n_flips == 0 and err_rel <= tol, f"{name} ({label}) disagrees with its plain twin")
    else:
        require(math.isfinite(err_rel) and e_gap < 1e-3,
                f"{name} ({label}): float32 energy drifted from its plain twin")
    return dict(index_flips=n_flips, first_flip=first, max_abs_err=err_abs, max_rel_err=err_rel,
                energy_rel_gap=e_gap, steps=n_ref)


def bound_ihgp_adf(T, D_, N_, S, bs, G, matched_steps, itemsize=4):
    """K5: y, match, obs, lZ (T); tt_in, tn_in, tt, tn (T, C); idx (T, C)
    int32; ms (T, C, bs); A, H, first, tab, W, the sigma points.  Per step
    and channel: h'A m, A m, the gain and the site (2 bs^2 + 4 bs + 16) and
    two lookups (about 40); per matched step the sigma points as K3's."""
    C = D_ + N_
    n = itemsize * (T * (4 + 4 * C + C * bs) + C * (bs * bs + bs + (G + 1) * (bs + 1))
                    + D_ * N_ + S * (N_ + 1) + 5) + 4 * T * C
    flops = T * C * (2 * bs * bs + 4 * bs + 56) + matched_steps * (S * sigma_flops(D_, N_) + 12 * C)
    return bound(n, flops)


def bound_ihgp_adf_vjp(T, D_, N_, S, bs, G, matched_steps, cotangent_values, itemsize=4):
    """K8: reads K5's inputs, its ms, idx (int32) and ttau and
    ``cotangent_values`` numbers of output cotangents; writes the cotangents
    of A, H, first, tab, W and sn2.  Operations three times K5's: re-deriving
    a step, then its reverse (reverse mode costs about twice the forward)."""
    C = D_ + N_
    params = C * (bs * bs + bs + (G + 1) * (bs + 1)) + D_ * N_ + 1
    n = itemsize * (T * (3 + 3 * C + C * bs) + cotangent_values + 2 * params + 4
                    + S * (N_ + 1)) + 4 * T * C
    flops = 3 * (T * C * (2 * bs * bs + 4 * bs + 56)
                 + matched_steps * (S * sigma_flops(D_, N_) + 12 * C))
    return bound(n, flops)


def bound_ihgp_smooth(T, C, bs, gain_rows, itemsize=4):
    """K6: ms, sm (T, C, bs), idx (T, C) int32, A, and the gain rows this
    run's indices reach (``gain_rows`` distinct (channel, grid point)).  Per
    step and channel: A mf, G (A mf), G m and two adds (6 bs^2 + 2 bs)."""
    n = itemsize * (2 * T * C * bs + C * bs * bs + gain_rows * bs * bs) + 4 * T * C
    return bound(n, T * C * (6 * bs * bs + 2 * bs))


def ihgp_phase(smi, dev):
    """Phase 8: the IHGP path on the card ``dev``: its two sequential passes
    are K5 (``fused_ihgp_adf``, the steady ADF sweep) and K6
    (``fused_ihgp_smooth``), counterparts of the two scans JAX compiles, and
    the energy's gradient runs K5's adjoint K8 (``fused_ihgp_adf_vjp``); the
    bank, the blocked and one-level passes and the re-site are plain torch.
    Returns the numbers of the ``ihgp`` line."""
    import torch

    from nsgp_tpu_torch.apps.source_sep import separate
    from nsgp_tpu_torch.convert import load_trained_batch
    from nsgp_tpu_torch.inference import ihgp
    from nsgp_tpu_torch.inference.batched import infer_batch
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
    from nsgp_tpu_torch.inference.learn import fit_hyperparams
    from nsgp_tpu_torch.models import mixture
    from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES, GTNMFParams
    from nsgp_tpu_torch.ops import _build, dare
    from nsgp_tpu_torch.ops import fused_ihgp as fih
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.tools.probe_train import kernels_per_step
    from nsgp_tpu_torch.tools.ptxas_report import parse as parse_ptxas

    t_phase = time.perf_counter()
    out = {"device": smi}
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    ih_counts = lambda: {fn.__name__: fn.launches for fn in fih.WRAPPERS}
    launches = {}  # K5, K6 and K8 launches per IHGP path

    def counted(path, fn, want):
        """Run ``fn`` with K5's, K6's and K8's counts set to 0 just before and
        read just after; they must be ``want`` (K5, K6, K8)."""
        fih.reset_launches()
        res = fn()
        got = ih_counts()
        launches[path] = got
        require((got["fused_ihgp_adf"], got["fused_ihgp_smooth"], got["fused_ihgp_adf_vjp"])
                == want, f"IHGP path {path}: K5, K6, K8 launched {got}, expected {want}")
        return res

    def value_and_grad(model_, params, y_, T_, cfg=ihgp.IHGPConfig()):
        """ihgp_energy under ``cfg`` and its gradient over every leaf: one
        vector, the energy first."""
        leaves = {k: getattr(params, k).detach().clone().requires_grad_(True)
                  for k in PARAM_NAMES}
        e = ihgp.ihgp_energy(model_, GTNMFParams(**leaves), y_[:T_], None, cfg,
                             device=y_.device)
        return torch.cat([e.reshape(1).detach()] + [
            g.reshape(-1) for g in torch.autograd.grad(e, list(leaves.values()))])

    cfg_seq, cfg_blk = ihgp.IHGPConfig(**IH_SEQ), ihgp.IHGPConfig(**IH_BLOCKED)
    # K5 and K6 every sweep; parallel: K5 once; a value and gradient K5 and K8 once
    seq_want, par_want = (cfg_seq.ep_itts, cfg_seq.ep_itts, 0), (1, 0, 0)

    # ---- 8a: the DARE bank, card vs CPU, float64 ---------------------------------
    model, p64, y64 = bench_inputs(torch.float64, "cpu")
    ssm_c, ssm_h = model.build_ssm(p64.on(dev)), model.build_ssm(p64)

    def failed_points(ssm, cfg):
        """Coarse grid points per channel whose DARE fails the bank's gate
        (residual >= 1e-4), which build_tables patches."""
        r = torch.as_tensor(10.0 ** np.linspace(cfg.grid_lo, cfg.grid_hi, cfg.grid_coarse),
                            dtype=ssm.A.dtype, device=ssm.A.device)
        args = (ssm.A[:, None], ssm.H[:, None], ssm.Q[:, None], r)
        return (~(dare.dare_residual(dare.dare_filter(*args), *args) < 1e-4)).sum(1).tolist()

    out["bank"] = {}
    for label, cfg in (("default", ihgp.IHGPConfig()), ("grid_lo-7", ihgp.IHGPConfig(grid_lo=-7.0))):
        tc, card_s = host_s(lambda: ihgp.build_tables(ssm_c, cfg))
        th = ihgp.build_tables(ssm_h, cfg)
        rel = max(rel_err(getattr(tc, f).cpu(), getattr(th, f)) for f in ihgp.IHGPTables._fields)
        failed = failed_points(ssm_c, cfg)
        require(failed == failed_points(ssm_h, cfg), f"bank {label}: failed points differ")
        log(f"phase8a build_tables {label} f64 (C={D + N}, bs={ssm_c.block_size}): card vs cpu "
            f"rel {rel:.3e} (tol {TOL_TRAIN:g}); patched coarse points per channel {failed}; "
            f"card {card_s:.3f} s")
        require(rel <= TOL_TRAIN, f"DARE bank {label} on the card disagrees with the CPU")
        out["bank"][label] = dict(rel=rel, patched_per_channel=failed, card_f64_s=card_s)
    _, p32, y32 = bench_inputs(torch.float32, dev)
    ssm32 = model.build_ssm(p32)
    ihgp.build_tables(ssm32, cfg_seq)
    _, bank32_s = host_s(lambda: ihgp.build_tables(ssm32, cfg_seq))
    out["bank"]["card_f32_s"] = bank32_s
    log(f"phase8a build_tables f32 on the card: {bank32_s:.3f} s")

    # ---- 8b: ihgp_infer in three forms (K5, K6 on the card), the energy's gradient --
    yp = y64[:T_IH_PARITY]
    lk = lambda r, cfg: ihgp._lookup_idx(ihgp._lookup_consts(ihgp.build_tables(
        model.build_ssm(p64.on(r.Eft.device)), cfg, smoother=False)), r.sites.ttau)
    out["parity"] = {}
    for label, kw in (("seq", {}), ("blocked", dict(parallel=True, chunk=256)),
                      ("one_level", dict(parallel=True, chunk=0))):
        cfg = ihgp.IHGPConfig(**IH_SEQ, **kw)
        rc, card_s = host_s(lambda: counted(f"parity_{label}", lambda: ihgp.ihgp_infer(
            model, p64, yp, None, cfg), seq_want if label == "seq" else par_want))
        t0 = time.perf_counter()
        rh = ihgp.ihgp_infer(model, p64, yp, None, cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        require(rc.Eft.device.type == dev.type, "ihgp_infer did not run on the card")
        rel = max(rel_err(a.cpu(), b) for a, b in (
            (rc.Eft, rh.Eft), (rc.Varft, rh.Varft), (rc.lZ, rh.lZ), (rc.nlZ, rh.nlZ),
            (rc.sites.ttau, rh.sites.ttau), (rc.sites.tnu, rh.sites.tnu)))
        same_idx = torch.equal(lk(rc, cfg).cpu(), lk(rh, cfg))
        log(f"phase8b ihgp_infer {label} T={T_IH_PARITY} f64: card (K5, K6 "
            f"{launches[f'parity_{label}']}) vs cpu rel {rel:.3e} (tol {TOL_TRAIN:g}), grid "
            f"indices equal {same_idx}; card {card_s:.2f} s, cpu {cpu_s:.2f} s; nlZ "
            f"{rc.nlZ.cpu().tolist()}")
        require(rel <= TOL_TRAIN and same_idx, f"ihgp_infer {label} on the card disagrees")
        out["parity"][label] = dict(rel=rel, card_s=card_s, cpu_s=cpu_s)
    grads = [counted(f"energy_{d}", lambda: value_and_grad(model, p64.on(d), yp.to(d),
                                                           T_IH_PARITY).cpu(), want)
             for d, want in ((dev.type, (1, 0, 1)), ("cpu", (0, 0, 0)))]
    g_rel = rel_err(*grads)
    log(f"phase8b ihgp_energy and its gradient over every leaf T={T_IH_PARITY} f64 (card: K5, "
        f"K6, K8 {launches[f'energy_{dev.type}']}; the CPU: their twins): energy "
        f"{grads[0][0].item():.10g}, card vs cpu rel {g_rel:.3e} (tol {TOL_IH_GRAD:g})")
    require(bool(torch.isfinite(grads[0]).all()) and g_rel <= TOL_IH_GRAD,
            "ihgp_energy's gradient on the card disagrees with the CPU")
    out["parity"]["energy_grad_rel"] = g_rel
    for label, kw in (("parallel_chunk0", {}), ("parallel_chunk0_jitter1e-6", dict(jitter=1e-6))):
        cfg = EPConfig(ep_itts=3, parallel=True, chunk=0, **kw)
        rc, rh = (ep_infer(model, p64, y64[:T_IH_EP], None, cfg, device=d) for d in (None, "cpu"))
        rel = max(rel_err(a.cpu(), b) for a, b in ((rc.Eft, rh.Eft), (rc.Varft, rh.Varft),
                                                   (rc.nlZ, rh.nlZ)))
        log(f"phase8b ep_infer seq {label} T={T_IH_EP} f64: card vs cpu rel {rel:.3e} (tol "
            f"{TOL_TRAIN:g}); nlZ {rc.nlZ.cpu().tolist()}")
        require(rel <= TOL_TRAIN, f"one-level EP ({label}) on the card disagrees with the CPU")
        out["parity"][f"ep_{label}_rel"] = rel

    # ---- 8c: K5 and K6 against their twins; float32 at the training length ------------
    fk.reset_launches()
    kern = {}
    # float64 at the headline width: the twins over T_IH_KERNEL steps, K5 and K6 over all
    a64, k64, tab64 = k5_inputs(model, p64.on(dev), y64[:T_IH_KERNEL].to(dev), cfg_seq)
    run64 = lambda: fih.fused_ihgp_adf(*a64, **k64)
    o64 = run64()
    require(all(torch.equal(x, z) for x, z in zip(o64, run64())),
            "K5: two runs on the same inputs differ in their bits")
    ref64, k5_plain64_ms = timed_plain(lambda: fih.fused_ihgp_adf_plain(*a64, **k64))
    kern["fused_ihgp_adf"] = dict(f64=steady_compare(
        f"phase8c f64 T={T_IH_KERNEL} D={D} N={N} S=77", "fused_ihgp_adf", o64, ref64, TOL_F64,
        k5_plain64_ms))
    sm_args = (o64[0], o64[1], ssm_c.A, tab64.Gn)
    sm64 = fih.fused_ihgp_smooth(*sm_args)
    require(torch.equal(sm64, fih.fused_ihgp_smooth(*sm_args)),
            "K6: two runs on the same inputs differ in their bits")
    ref_sm, k6_plain64_ms = timed_plain(lambda: fih.fused_ihgp_smooth_plain(*sm_args))
    e_abs, e_rel = max_err([sm64], [ref_sm])
    log(f"phase8c f64 T={T_IH_KERNEL} fused_ihgp_smooth: max_abs_err={e_abs:.3e} "
        f"max_rel_err={e_rel:.3e} (tol {TOL_F64:g}) plain_ms={k6_plain64_ms:.1f}")
    require(e_rel <= TOL_F64, "K6 (f64) disagrees with its plain twin")
    kern["fused_ihgp_smooth"] = dict(f64=dict(max_abs_err=e_abs, max_rel_err=e_rel,
                                              steps=T_IH_KERNEL))
    # float32 at the headline shape: K5 over all T_MAIN steps against its twin
    # over the first T_IH_KERNEL (a forward recursion), K6 over all T against
    # its twin over the last T_IH_KERNEL (a backward one)
    a32, k32, tab32 = k5_inputs(model, p32, y32, cfg_seq)
    run32 = lambda: fih.fused_ihgp_adf(*a32, **k32)
    o32 = run32()
    head = [x[:T_IH_KERNEL] if torch.is_tensor(x) and x.dim() and x.shape[0] == T_MAIN else x
            for x in a32]
    ref32, k5_plain_ms = timed_plain(lambda: fih.fused_ihgp_adf_plain(*head, **k32))
    kern["fused_ihgp_adf"]["f32"] = steady_compare(
        f"phase8c f32 T={T_MAIN} (plain over {T_IH_KERNEL} steps)", "fused_ihgp_adf", o32,
        ref32, None, k5_plain_ms)
    k5_ms = cuda_ms(run32, 3)
    sm_args32 = (o32[0], o32[1], ssm32.A, tab32.Gn)
    k6_ms = cuda_ms(lambda: fih.fused_ihgp_smooth(*sm_args32), 5)
    sm32 = fih.fused_ihgp_smooth(*sm_args32)
    ref_sm32, k6_plain_ms = timed_plain(lambda: fih.fused_ihgp_smooth_plain(
        o32[0][-T_IH_KERNEL:], o32[1][-T_IH_KERNEL:], ssm32.A, tab32.Gn))
    e_abs32, e_rel32 = max_err([sm32[-T_IH_KERNEL:]], [ref_sm32])
    require(e_rel32 <= TOL_F32, "K6 (f32) disagrees with its plain twin")
    C_h, bs_h = D + N, ssm32.block_size
    gain_rows = int(torch.unique(o32[1] * C_h + torch.arange(C_h, device=dev)).numel())
    kern["fused_ihgp_adf"].update(
        ms=k5_ms, plain_ms=k5_plain_ms, plain_steps=T_IH_KERNEL, max_abs_err=kern[
            "fused_ihgp_adf"]["f64"]["max_abs_err"],
        bound=bound_ihgp_adf(T_MAIN, D, N, 77, bs_h, tab32.Ph.shape[1], T_MAIN),
        **fk.adf_launch_shape(77))
    kern["fused_ihgp_smooth"].update(
        ms=k6_ms, plain_ms=k6_plain_ms, plain_steps=T_IH_KERNEL, max_abs_err=e_abs,
        f32=dict(max_abs_err=e_abs32, max_rel_err=e_rel32, steps=T_IH_KERNEL),
        bound=bound_ihgp_smooth(T_MAIN, C_h, bs_h, gain_rows))
    log(f"phase8c f32 T={T_MAIN} fused_ihgp_smooth (plain over the last {T_IH_KERNEL} steps): "
        f"max_abs_err={e_abs32:.3e} max_rel_err={e_rel32:.3e} (tol {TOL_F32:g}); on {smi}: "
        f"K5 {k5_ms:.2f} ms ({1e3 * k5_ms / T_MAIN:.3f} us/step; bound "
        f"{kern['fused_ihgp_adf']['bound'][0]:.3f} ms), K6 {k6_ms:.3f} ms (bound "
        f"{kern['fused_ihgp_smooth']['bound'][0]:.4f} ms); plain twins {k5_plain_ms:.0f} and "
        f"{k6_plain_ms:.0f} ms over {T_IH_KERNEL} steps")
    del o32, sm32, a32, head

    # sweep 1 through K5 at the training length, its float32 health gap
    yt = y32[:T_IH_TRAIN]
    for cfg in (cfg_seq, cfg_blk):  # first float32 use of each op outside the timings
        ihgp.ihgp_infer(model, p32, yt[:256], None, cfg)
    at, kt, _ = k5_inputs(model, p32, yt, cfg_seq)
    (_, _, lZ32, _, _), sweep1_s = host_s(lambda: fih.fused_ihgp_adf(*at, **kt))
    a64t, k64t, _ = k5_inputs(model, p64.on(dev), y64[:T_IH_TRAIN].to(dev), cfg_seq)
    lZ64 = fih.fused_ihgp_adf(*a64t, **k64t)[2]
    e32, e64 = -lZ32.double().sum(), -lZ64.sum()
    gap = rel_err(e32.cpu(), e64.cpu())
    us_step = 1e6 * sweep1_s / T_IH_TRAIN
    # the energy's forward through K5's plain twin, the loop it ran before K8
    with torch.no_grad(), swapped(fih, "fused_ihgp_adf_autograd", fih.fused_ihgp_adf_plain):
        ihgp.ihgp_energy(model, p32, yt[:256], None, cfg_seq)
        _, energy_s = host_s(lambda: ihgp.ihgp_energy(model, p32, yt[:T_IH_ENERGY], None, cfg_seq))
    r_seq, seq_s = host_s(lambda: counted("seq_16000", lambda: ihgp.ihgp_infer(
        model, p32, yt, None, cfg_seq), seq_want))
    r_blk, blk_s = host_s(lambda: counted("blocked_16000", lambda: ihgp.ihgp_infer(
        model, p32, yt, None, cfg_blk), par_want))
    for label, r in (("ihgp-seq", r_seq), ("ihgp-blocked", r_blk)):
        check_posterior(f"phase8c {label}", r.nlZ, r.Eft, r.Varft, (T_IH_TRAIN, D + N))
    log(f"phase8c T={T_IH_TRAIN} f32 on {smi}: sweep 1 (K5, tables built) {sweep1_s:.4f} s = "
        f"{us_step:.2f} us/step; its energy f32 vs f64 {e32.item():.8g} vs {e64.item():.8g}, "
        f"rel gap {gap:.3e} (bar 1e-3); ihgp_energy's forward through K5's plain twin (bank "
        f"+ the twin's loop) at T={T_IH_ENERGY} {energy_s:.2f} s = "
        f"{1e6 * energy_s / T_IH_ENERGY:.0f} us/step; "
        f"ihgp-seq {seq_s:.2f} s (K5, K6 {launches['seq_16000']}), nlZ "
        f"{r_seq.nlZ.cpu().tolist()}; ihgp-blocked {blk_s:.2f} s (K5, K6 "
        f"{launches['blocked_16000']}), nlZ {r_blk.nlZ.cpu().tolist()}")
    require(math.isfinite(gap) and gap < 1e-3, "float32 sweep 1 drifted from float64")
    out["t16000"] = dict(T=T_IH_TRAIN, sweep1_s=sweep1_s, sweep1_us_per_step=us_step,
                         energy_rel_gap_f64=gap, energy_plain_T=T_IH_ENERGY,
                         energy_plain_s=energy_s, seq_s=seq_s, blocked_s=blk_s)

    # ---- 8d: the headline shape --------------------------------------------------------
    predicted = us_step * T_MAIN / 1e6
    T_d = T_MAIN if predicted <= IH_SWEEP1_LIMIT_S else T_IH_CUT
    r_d, d_s = host_s(lambda: counted("headline_blocked", lambda: ihgp.ihgp_infer(
        model, p32, y32[:T_d], None, cfg_blk), par_want))
    check_posterior("phase8d ihgp-blocked", r_d.nlZ, r_d.Eft, r_d.Varft, (T_d, D + N))
    log(f"phase8d ihgp-blocked T={T_d} f32 on {smi}: {d_s:.2f} s, {d_s / 3:.3f} s/sweep "
        f"(sweep 1 predicted {predicted:.2f} s at T={T_MAIN}"
        f"{'' if T_d == T_MAIN else f', over {IH_SWEEP1_LIMIT_S:.0f} s: cut to T={T_d}'}); nlZ "
        f"{r_d.nlZ.cpu().tolist()}")
    out["headline"] = dict(T=T_d, s=d_s, s_per_sweep=d_s / 3, sweep1_predicted_s=predicted,
                           nlZ=r_d.nlZ.cpu().tolist())

    # ---- 8e: K5 at mixture width; separate() with its default engine, batched IHGP ----
    cfg_mix = ihgp.IHGPConfig(**IH_MIX_KW)
    for dtype, label in ((torch.float64, "f64"), (torch.float32, "f32")):
        models, plist, y_mix, _ = mixture_inputs(dtype, dev, T_IH_MIX)
        jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
        am, km, _ = k5_inputs(jm, jp, y_mix, cfg_mix)
        S_mix = fk.sigma_points(km["mp"], dtype, dev)[0].shape[0]
        om = fih.fused_ihgp_adf(*am, **km)
        head = [x[:T_IH_MIX_KERNEL] if torch.is_tensor(x) and x.dim() and x.shape[0] == T_IH_MIX
                else x for x in am]
        refm, plain_m = timed_plain(lambda: fih.fused_ihgp_adf_plain(*head, **km))
        kern["fused_ihgp_adf"][f"mixture_{label}"] = steady_compare(
            f"phase8e {label} T={T_IH_MIX} D={jm.D} N={jm.N} S={S_mix} cluster="
            f"{fk.adf_launch_shape(S_mix)['cluster']} (plain over {T_IH_MIX_KERNEL} steps)",
            "fused_ihgp_adf", om, refm, TOL_F64 if dtype == torch.float64 else None, plain_m)
        if dtype == torch.float32:
            mix_ms = cuda_ms(lambda: fih.fused_ihgp_adf(*am, **km), 3)
            bs_mx = jm.build_ssm(jp).block_size
            kern["fused_ihgp_adf"]["mixture"] = dict(
                ms=mix_ms, plain_ms=plain_m, plain_steps=T_IH_MIX_KERNEL,
                bound=bound_ihgp_adf(T_IH_MIX, jm.D, jm.N, S_mix, bs_mx, cfg_mix.grid_fine,
                                     T_IH_MIX),
                shape=f"T={T_IH_MIX} D={jm.D} N={jm.N} S={S_mix} bs={bs_mx} f32",
                **fk.adf_launch_shape(S_mix))
            log(f"phase8e K5 at mixture width T={T_IH_MIX} f32 on {smi}: {mix_ms:.2f} ms "
                f"({1e3 * mix_ms / T_IH_MIX:.2f} us/step)")
    models, plist, y_mix, parts = mixture_inputs(torch.float32, dev, T_IH_MIX)
    sep, sep_s = host_s(lambda: counted("separate", lambda: separate(
        models, plist, y_mix, true_sources=parts, mixture_lik=MIX_LIK, **IH_MIX_KW), par_want))
    require(bool(torch.isfinite(sep.sources).all()) and bool(torch.isfinite(sep.snr).all())
            and bool(torch.isfinite(sep.result.nlZ).all()), "non-finite IHGP separation")
    m64, pm64, ym64, parts64 = mixture_inputs(torch.float64, dev, T_IH_MIX_F64)
    seps = [separate(m64, pm64, ym64, true_sources=parts64, n_samples=0, mixture_lik=MIX_LIK,
                     device=d, **IH_MIX_KW) for d in (None, "cpu")]
    sep_rel = max(rel_err(a.cpu(), b) for a, b in (
        (seps[0].sources, seps[1].sources), (seps[0].result.Eft, seps[1].result.Eft),
        (seps[0].result.Varft, seps[1].result.Varft), (seps[0].result.nlZ, seps[1].result.nlZ)))
    log(f"phase8e separate (default engine ihgp, C={sep.result.Eft.shape[1]}) "
        f"T={T_IH_MIX} f32: {sep_s:.2f} s (K5, K6 {launches['separate']}), SNR "
        f"{sep.snr.cpu().tolist()} dB, nlZ {sep.result.nlZ.cpu().tolist()}; T={T_IH_MIX_F64} "
        f"f64 card vs cpu rel {sep_rel:.3e} (tol {TOL_TRAIN:g})")
    require(sep_rel <= TOL_TRAIN, "IHGP separation on the card disagrees with the CPU")
    with open(os.path.join(ROOT, CORPUS)) as f:
        names = [r["file"] for r in json.load(f)["files"] if r["kernel1"] == "matern32"][:BF_IH]
    cmodel, cpB = load_trained_batch([os.path.join(ROOT, MUSIC.format(n)) for n in names],
                                     device=dev, dtype=torch.float32)
    yB = np.stack([prior_signal(np.random.default_rng(100 + b), cmodel, cpB.select(b),
                                T_IH_BATCH) for b in range(BF_IH)])
    yB = torch.tensor(yB.astype(np.float32), device=dev)
    maskB = torch.ones_like(yB, dtype=torch.bool)
    maskB[:, 1500 - 1 - GAP_HALF:1500 + GAP_HALF] = False
    rb, batch_s = host_s(lambda: counted("batch", lambda: infer_batch(
        "ihgp", cmodel, cpB, yB, maskB, **IH_CORPUS_KW), (BF_IH, 0, 0)))
    b = BF_IH - 1
    r1 = ihgp.ihgp_infer(cmodel, cpB.select(b), yB[b], maskB[b], ihgp.IHGPConfig(**IH_CORPUS_KW))
    same = all(torch.equal(x[b], y) for x, y in ((rb.Eft, r1.Eft), (rb.Varft, r1.Varft),
                                                  (rb.nlZ, r1.nlZ), (rb.sites.ttau, r1.sites.ttau)))
    require(bool(torch.isfinite(rb.nlZ).all()), "non-finite batched IHGP energies")
    log(f"phase8e infer_batch('ihgp') BF={BF_IH} ({', '.join(names)}) T={T_IH_BATCH} f32: "
        f"{batch_s:.2f} s (K5, K6 {launches['batch']}), nlZ {rb.nlZ[:, -1].cpu().tolist()}; "
        f"file {b} the same bits as the single-file engine: {same}")
    require(same, "batched IHGP differs from the single-file engine")
    # ---- 8f: the energy's gradient: K8 against its twin, then at the training length --
    vjp_checks = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        pv = p64.on(dev) if dtype == torch.float64 else p32
        yv = (y64.to(dev) if dtype == torch.float64 else y32)[:T_IH_VJP].clone()
        mv = torch.ones(T_IH_VJP, dtype=torch.bool, device=dev)
        mv[IH_VJP_GAP[0]:IH_VJP_GAP[1]] = False  # a NaN gap
        yv[~mv] = math.nan
        kern8, plain8, _ = k8_case(model, pv, yv, ihgp.IHGPConfig(), mv)
        vjp_checks[label] = compare(
            f"phase8f {label} T={T_IH_VJP} D={D} N={N} S=77 gap {IH_VJP_GAP}, cotangents on ms, "
            f"lZ, ttau, tnu (K5's indices)", "fused_ihgp_adf_vjp", kern8, plain8, tol, 1)
    models, plist, y_mix, _ = mixture_inputs(torch.float64, dev, T_IH_VJP_MIX)
    jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
    kern8, plain8, _ = k8_case(jm, jp, y_mix, ihgp.IHGPConfig(**IH_MIX_KW))
    vjp_checks["f64_mixture"] = compare(
        f"phase8f f64 T={T_IH_VJP_MIX} D={jm.D} N={jm.N} S=3973 (one CTA, rounds; the table's "
        f"sums in the scratch)", "fused_ihgp_adf_vjp", kern8, plain8, TOL_F64, 1)
    # the value and gradient at the training length, float32, under 8c's config
    # (damping 0.1): K5 once, K8 once
    value_and_grad(model, p32, yt, 256, cfg_seq)  # first use of each op outside the timing
    vg32, vg_s = host_s(lambda: counted("energy_16000", lambda: value_and_grad(
        model, p32, yt, T_IH_TRAIN, cfg_seq), (1, 0, 1)))
    vg64, vg64_s = host_s(lambda: value_and_grad(model, p64.on(dev), y64.to(dev), T_IH_TRAIN,
                                                 cfg_seq))
    e_gap, g_gap = rel_err(vg32[:1].cpu(), vg64[:1].cpu()), rel_err(vg32[1:].cpu(), vg64[1:].cpu())
    # K5's float32 and float64 sweeps: grid-index flips and the energy's gap, under
    # 8c's damping (held above) and the IHGPConfig default 0.5 (reported: there the
    # float32 forward sweep leaves float64's)
    sweep_f32_f64 = {}
    for label, cfg in (("damping_0.1", cfg_seq), ("damping_0.5_default", ihgp.IHGPConfig())):
        a32, k32_, _ = k5_inputs(model, p32, yt, cfg)
        a64, k64_, _ = k5_inputs(model, p64.on(dev), y64[:T_IH_TRAIN].to(dev), cfg)
        o32, o64 = fih.fused_ihgp_adf(*a32, **k32_), fih.fused_ihgp_adf(*a64, **k64_)
        sweep_f32_f64[label] = dict(
            index_flips=int((o32[1] != o64[1]).sum().item()), indices=o32[1].numel(),
            energy_rel_gap=rel_err(o32[2].double().sum().reshape(1).cpu(),
                                   o64[2].sum().reshape(1).cpu()))
    per_call = {}
    for T_ in (T_IH_VJP, T_IH_TRAIN):  # no per-step loop: kernels a call do not grow with T
        (k_fwd, k_bwd), (b_fwd, b_bwd), (w_fwd, w_bwd) = kernels_per_step(
            lambda p: ihgp.ihgp_energy(model, p, yt[:T_], None, cfg_seq), p32, T_)
        per_call[T_] = dict(kernels_forward=k_fwd * T_, kernels_backward=k_bwd * T_,
                            device_busy_s=1e-6 * (b_fwd + b_bwd) * T_,
                            traced_wall_s=1e-6 * (w_fwd + w_bwd) * T_,
                            idle_share=1.0 - (b_fwd + b_bwd) / (w_fwd + w_bwd))
    n_call = {T_: v["kernels_forward"] + v["kernels_backward"] for T_, v in per_call.items()}
    require(n_call[T_IH_TRAIN] <= 1.1 * n_call[T_IH_VJP],
            f"phase8f: CUDA kernels a call grow from {n_call[T_IH_VJP]:.0f} at T={T_IH_VJP} to "
            f"{n_call[T_IH_TRAIN]:.0f} at {T_IH_TRAIN}: a per-step loop")
    kern8, _, _ = k8_case(model, p32, yt, cfg_seq, g_lZ=-torch.ones(T_IH_TRAIN, device=dev))
    k8_ms = cuda_ms(kern8, 3)
    at_e, kt_e, tab_e = k5_inputs(model, p32, yt, cfg_seq)
    k5e_ms = cuda_ms(lambda: fih.fused_ihgp_adf(*at_e, **kt_e), 3)
    fit32, fit_s = host_s(lambda: counted("fit_16000", lambda: fit_hyperparams(
        model, p32, yt, engine="ihgp", steps=IH_FIT_STEPS, learning_rate=1e-2,
        damping=cfg_seq.damping), (IH_FIT_STEPS, 0, IH_FIT_STEPS)))
    require(bool(torch.isfinite(fit32.energies).all()), "non-finite IHGP training energies")
    # the same value and gradient through K5's plain twin, the loop it ran before K8
    with swapped(fih, "fused_ihgp_adf_autograd", fih.fused_ihgp_adf_plain):
        value_and_grad(model, p32, yt, 64, cfg_seq)
        twin_vg = host_s(lambda: value_and_grad(model, p32, yt, T_IH_ENERGY, cfg_seq))
    twin_vg_s = twin_vg[1]
    twin_rel = rel_err(twin_vg[0].cpu(),
                       value_and_grad(model, p32, yt, T_IH_ENERGY, cfg_seq).cpu())
    log_path = _build.ptxas_log_path(_build.library_path())
    ptxas = {f"{dt}_bs{bs}": dict(registers=r, stack_B=st, spill_store_B=ss, spill_load_B=sl)
             for k, dt, bs, r, st, ss, sl in (parse_ptxas(log_path.read_text())
                                              if log_path.exists() else [])
             if k == "fused_ihgp_adf_vjp_kernel" and bs == ssm32.block_size}
    pc = per_call[T_IH_TRAIN]
    log(f"phase8f ihgp_energy T={T_IH_TRAIN} f32 on {smi}: value+grad {vg_s:.3f} s "
        f"({1e6 * vg_s / T_IH_TRAIN:.1f} us/step), K5, K6, K8 {launches['energy_16000']}; K5 "
        f"alone {k5e_ms:.2f} ms, K8 alone {k8_ms:.2f} ms ({1e3 * k8_ms / T_IH_TRAIN:.2f} "
        f"us/step); CUDA kernels a call (traced) forward {pc['kernels_forward']:.0f}, backward "
        f"{pc['kernels_backward']:.0f} (at T={T_IH_VJP}: "
        f"{per_call[T_IH_VJP]['kernels_forward']:.0f}, "
        f"{per_call[T_IH_VJP]['kernels_backward']:.0f}), device busy {pc['device_busy_s']:.3f} "
        f"of {pc['traced_wall_s']:.3f} s (idle share {pc['idle_share']:.3f}); f64 value+grad "
        f"{vg64_s:.3f} s; K8 ptxas {ptxas}")
    log(f"phase8f f32 vs f64 at T={T_IH_TRAIN} (damping {cfg_seq.damp(0)}): energy "
        f"{vg32[0].item():.8g} vs {vg64[0].item():.8g}, rel gap {e_gap:.3e} (bar 1e-3); gradient "
        f"rel to max {g_gap:.3e}; K5's float32 against float64 sweep by damping: "
        f"{sweep_f32_f64} (grid-index flips; the default's gap is reported, not held); the "
        f"twin's loop (K5's plain twin under autograd) value+grad at "
        f"T={T_IH_ENERGY} {twin_vg_s:.2f} s ({1e6 * twin_vg_s / T_IH_ENERGY:.0f} us/step, "
        f"{twin_vg_s * T_IH_TRAIN / T_IH_ENERGY:.1f} s scaled to T={T_IH_TRAIN}), rel "
        f"{twin_rel:.3e} from K5 and K8 on the same inputs; fit_hyperparams(engine='ihgp') "
        f"{IH_FIT_STEPS} Adam steps {fit_s:.2f} s, K5, K6, K8 {launches['fit_16000']}, energies "
        f"{fit32.energies.cpu().tolist()}")
    require(math.isfinite(e_gap) and e_gap < 1e-3, "float32 IHGP energy drifted from float64")
    require(bool(torch.isfinite(vg32).all()), "non-finite float32 IHGP gradient")
    out["energy_grad"] = dict(
        T=T_IH_TRAIN, value_grad_s=vg_s, value_grad_us_per_step=1e6 * vg_s / T_IH_TRAIN,
        damping=cfg_seq.damp(0), value_grad_f64_s=vg64_s, energy_rel_gap_f64=e_gap,
        grad_rel_gap_f64=g_gap, sweep_f32_vs_f64=sweep_f32_f64, k5_ms=k5e_ms, k8_ms=k8_ms,
        per_call=per_call, twin_T=T_IH_ENERGY, twin_value_grad_s=twin_vg_s,
        twin_vs_kernels_rel=twin_rel,
        fit=dict(steps=IH_FIT_STEPS, s=fit_s, energies=fit32.energies.cpu().tolist()))
    kern["fused_ihgp_adf_vjp"] = dict(
        ms=k8_ms, plain_ms=vjp_checks["f32"]["plain_ms"], plain_steps=T_IH_VJP,
        max_abs_err=vjp_checks["f32"]["max_abs_err"],
        max_rel_err=vjp_checks["f32"]["max_rel_err"], ptxas=ptxas,
        bound=bound_ihgp_adf_vjp(T_IH_TRAIN, D, N, 77, ssm32.block_size, tab_e.Ph.shape[1],
                                 T_IH_TRAIN, T_IH_TRAIN),
        shape=f"T={T_IH_TRAIN} D={D} N={N} S=77 bs={ssm32.block_size} G={tab_e.Ph.shape[1]} f32",
        checks=vjp_checks, **fk.adf_launch_shape(77))

    k14 = counts()
    log(f"phase8 launches of K1-K4 and K7 on the IHGP path (8c-8f): {k14}; K5, K6, K8 per "
        f"path: {launches}")
    require(all(v == 0 for v in k14.values()),
            "the IHGP path launched a kernel that JAX's IHGP does not use")
    out.update(separate=dict(T=T_IH_MIX, s=sep_s, snr_db=sep.snr.cpu().tolist(),
                             f64_T=T_IH_MIX_F64, card_vs_cpu_rel=sep_rel),
               batch=dict(BF=BF_IH, T=T_IH_BATCH, s=batch_s, same_bits_as_single=same),
               launches=k14, ihgp_launches=launches, kernels=kern,
               phase8_s=time.perf_counter() - t_phase)
    log(f"phase8 done in {out['phase8_s']:.0f} s")
    return out


def speech_signal(T, seed):
    """A seeded numpy draw of T samples from the trained speech model's prior,
    at unit variance (the reference's y_norm)."""
    import torch

    from nsgp_tpu_torch.convert import load_trained

    model, params = load_trained(os.path.join(ROOT, SPEECH), device="cpu", dtype=torch.float64)
    y = prior_signal(np.random.default_rng(seed), model, params, T)
    return y / y.std()


@contextlib.contextmanager
def pipeline_stages(fit=None):
    """Record the pipeline's stages as it calls them: seconds (synchronised at
    both ends) and Adam steps by stage, and the Whittle fit's moves of dead or
    duplicate components.  With ``fit``, stage 1 returns that fit on the
    pipeline's device: stages 2-5 from a common start."""
    import torch

    from nsgp_tpu_torch.pretrain import pipeline, spectral
    from nsgp_tpu_torch.pretrain.adam import adam

    rec = {"s": {}, "adam_steps": {}, "moves": []}
    saved = []

    def patch(mod, name, fn):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    for stage, modname, fname in PIPELINE_STAGES:
        mod = getattr(pipeline, modname)
        inner = getattr(mod, fname)
        if stage == "whittle" and fit is not None:
            inner = lambda y, *a, **k: fit._replace(**{f: getattr(fit, f).to(y.device)
                                                       for f in fit._fields})

        def timed(*a, _inner=inner, _stage=stage, **k):
            sync()
            t0, n0 = time.perf_counter(), adam.steps
            out = _inner(*a, **k)
            sync()
            rec["s"][_stage] = rec["s"].get(_stage, 0.0) + time.perf_counter() - t0
            rec["adam_steps"][_stage] = rec["adam_steps"].get(_stage, 0) + adam.steps - n0
            return out

        patch(mod, fname, timed)
    reassign = spectral._reassign_dead

    def counted(*a):
        p, moved = reassign(*a)
        rec["moves"].append(moved)
        return p, moved

    patch(spectral, "_reassign_dead", counted)
    try:
        yield rec
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def trained_gap(a, b) -> float:
    """Largest relative gap over every field of two TrainedModels: the
    parameters, the envelopes, H and the stage-1 fit."""
    from nsgp_tpu_torch.models.gtnmf import PARAM_NAMES

    pairs = ([(getattr(a.params, k), getattr(b.params, k)) for k in PARAM_NAMES]
             + [(a.envelopes, b.envelopes), (a.H, b.H)]
             + [(getattr(a.fit, f), getattr(b.fit, f)) for f in a.fit._fields])
    return max(rel_err(x.cpu(), y.cpu()) for x, y in pairs)


def train_columns(tm, fs):
    """results/train_speech.json's columns (experiments/train_corpus.py:98-108)."""
    om = np.sort(tm.params.omega.double().cpu().numpy()) * fs / (2 * np.pi)
    return dict(omega_hz_min=round(float(om[0]), 1), omega_hz_max=round(float(om[-1]), 1),
                n_distinct_omega=int(np.sum(np.diff(om, prepend=-1.0) > 1.0)),
                whittle_obj=round(float(tm.fit.obj), 4))


def kernels_per_step(fn, steps):
    """(CUDA kernels, device-busy us) per step of ``fn()``, which takes
    ``steps`` steps, under torch.profiler after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(ev.count for ev in cuda) / steps,
            sum(ev.self_device_time_total for ev in cuda) / steps)


def denoise_phase(smi, dev):
    """Phase 9: a raw signal to a trained model to denoised speech on the
    card ``dev``: the pretraining pipeline (plain torch; JAX's reaches no
    Pallas kernel) and the denoising protocol, whose EP runs K3, K2 and K1.
    Returns the numbers of the ``denoise`` line."""
    import torch

    from nsgp_tpu_torch.apps.denoise import denoise, stationary_spectrum, tv_wiener
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.pretrain import gppad, nmf, pipeline, segp, spectral
    from nsgp_tpu_torch.pretrain.filterbank import fft_filterbank
    from nsgp_tpu_torch.utils.metrics import log_spec_snr_db, rmse, snr_db
    from nsgp_tpu_torch.utils.speech_quality import fw_seg_snr
    from nsgp_tpu_torch.utils.stoi import stoi

    t_phase = time.perf_counter()
    out = {"device": smi}
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    train = lambda y, device, **kw: pipeline.train_gtnmf_fixed_params(
        y, D=16, N=3, fs=float(FS_SPEECH), device=device, **kw)

    # ---- 9a: the pipeline, card vs CPU, float64 --------------------------------------
    y_a = torch.tensor(speech_signal(T_PIPE_PARITY, 500))
    wobble = torch.tensor(np.random.default_rng(501).normal(size=T_PIPE_PARITY))
    gen = torch.Generator().manual_seed(1)
    init = tuple(torch.rand(shape, generator=gen, dtype=torch.float64) + 0.5
                 for shape in ((8, T_PIPE_PARITY, 3), (8, 16, 3)))
    out["parity"] = {}
    for kernel in ("exp", "matern32"):
        kw = dict(kernel1=kernel, filterbank_kwargs=PIPE_PARITY_FB, nmf_init=init)
        runs = {}
        for label, y, device in (("card", y_a, None), ("cpu", y_a, "cpu"),
                                 ("cpu_perturbed", y_a * (1.0 + PERTURB * wobble), "cpu")):
            with pipeline_stages() as rec:
                tm, secs = host_s(lambda: train(y, device, **kw))
            runs[label] = (tm, rec["moves"], secs)
        require(runs["card"][0].params.W.device.type == dev.type, "the pipeline did not run on "
                "the card")
        gap = trained_gap(runs["card"][0], runs["cpu"][0])
        yardstick = trained_gap(runs["cpu_perturbed"][0], runs["cpu"][0])
        same_moves = runs["card"][1] == runs["cpu"][1]
        # stages 2-5 (filterbank, GPPAD, NMF, SE-GP) from the CPU's stage-1 fit
        fit_cpu = runs["cpu"][0].fit
        tail = {}
        for label, device in (("card", None), ("cpu", "cpu")):
            with pipeline_stages(fit=fit_cpu):
                tail[label] = train(y_a, device, **kw)
        tail_gap = trained_gap(tail["card"], tail["cpu"])
        # stage 1 alone at its first level (window 256, 100 steps, its
        # reassignments and re-fits), where a perturbation of y stays at rounding
        lvl1 = {}
        for label, device in (("card", None), ("cpu", "cpu")):
            with pipeline_stages() as rec:
                lvl1[label] = (spectral.fit_probstft(y_a, 16, kernel=kernel, num_levels=1,
                                                     min_win=256, max_win=256,
                                                     steps_per_level=100, device=device),
                               rec["moves"])
        lvl1_gap = max(rel_err(getattr(lvl1["card"][0], f).cpu(), getattr(lvl1["cpu"][0], f))
                       for f in lvl1["cpu"][0]._fields)
        lvl1_moves = lvl1["card"][1] == lvl1["cpu"][1]
        log(f"phase9a pipeline {kernel} T={T_PIPE_PARITY} f64 (Whittle {PIPE_PARITY_FB}): "
            f"end to end card vs cpu rel {gap:.3e}, moves card "
            f"{runs['card'][1]} cpu {runs['cpu'][1]} (equal {same_moves}); the cpu against "
            f"itself on y*(1+{PERTURB:g}*N(0,1)) rel {yardstick:.3e} (bar {TOL_TRAIN:g}: "
            f"{'met' if gap <= TOL_TRAIN else 'missed'}); stages 2-5 from one stage-1 fit "
            f"card vs cpu rel {tail_gap:.3e}, stage 1 at its first level rel {lvl1_gap:.3e} "
            f"(tol {TOL_TRAIN:g}) with moves {lvl1['cpu'][1]} on both {lvl1_moves}; card "
            f"{runs['card'][2]:.1f} s, cpu {runs['cpu'][2]:.1f} s")
        require(tail_gap <= TOL_TRAIN and lvl1_gap <= TOL_TRAIN and lvl1_moves,
                f"the pipeline's stages ({kernel}) on the card disagree with the CPU")
        out["parity"][kernel] = dict(end_to_end_rel=gap, moves_card=runs["card"][1],
                                     moves_cpu=runs["cpu"][1], cpu_perturbed_rel=yardstick,
                                     stages_2_5_rel=tail_gap, stage1_level1_rel=lvl1_gap,
                                     stage1_level1_moves=lvl1["cpu"][1],
                                     card_s=runs["card"][2],
                                     cpu_s=runs["cpu"][2])
    t_9a = time.perf_counter() - t_phase

    # ---- 9b: the pipeline at full width, float32 then float64 ------------------------
    y_np = speech_signal(T_SPEECH, 501)
    y32 = torch.tensor(y_np, dtype=torch.float32, device=dev)
    torch.cuda.reset_peak_memory_stats()
    with pipeline_stages() as rec32:
        tm32, s32 = host_s(lambda: train(y32, None, kernel1="exp"))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    cols32 = train_columns(tm32, FS_SPEECH)
    log(f"phase9b train_gtnmf_fixed_params exp T={T_SPEECH} f32: {s32:.2f} s; by stage (s) "
        f"{ {k: round(v, 3) for k, v in rec32['s'].items()} }; Adam steps {rec32['adam_steps']}; "
        f"moves {rec32['moves']}; peak {peak_mib:.0f} MiB; {cols32}")
    with pipeline_stages() as rec64:
        tm64, s64 = host_s(lambda: train(torch.tensor(y_np, device=dev), None, kernel1="exp"))
    cols64 = train_columns(tm64, FS_SPEECH)
    gap64 = trained_gap(tm32, tm64)
    finite = all(bool(torch.isfinite(x).all()) for tm in (tm32, tm64)
                 for x in tm.params.leaves() + (tm.envelopes, tm.H))
    log(f"phase9b the same in f64 on the card: {s64:.2f} s; by stage (s) "
        f"{ {k: round(v, 3) for k, v in rec64['s'].items()} }; moves {rec64['moves']}; {cols64}; "
        f"f32 vs f64 rel gap {gap64:.3e} (no bar: reassignment is discrete); finite {finite}")
    require(finite, "the pipeline gave non-finite values")
    prof = {
        "whittle": (lambda: spectral.fit_probstft(y32, 16, num_levels=1, min_win=4096,
                                                  max_win=4096, steps_per_level=20,
                                                  reassign=False), 20),
        "gppad": (lambda: gppad.demodulate_channels(tm32.envelopes, 1600.0, 20), 20),
        "nmf": (lambda: nmf.nmf_fp(tm32.envelopes, 3, 20, 8), 20),
        "segp": (lambda: segp.fit_segp(tm32.H.T, 20), 20),
    }
    per_step = {k: kernels_per_step(*v) for k, v in prof.items()}
    log("phase9b CUDA kernels and device-busy us per Adam step (NMF: per iteration) at T="
        f"{T_SPEECH} f32: " + ", ".join(f"{k} {n:.1f} kernels {b:.1f} us"
                                        for k, (n, b) in per_step.items()))
    out["pipeline"] = dict(T=T_SPEECH, f32=dict(s=s32, stage_s=rec32["s"],
                                                adam_steps=rec32["adam_steps"],
                                                moves=rec32["moves"], peak_mib=peak_mib, **cols32),
                           f64=dict(s=s64, stage_s=rec64["s"], moves=rec64["moves"], **cols64),
                           f32_vs_f64_rel=gap64,
                           per_step={k: dict(kernels=n, busy_us=b)
                                     for k, (n, b) in per_step.items()})
    t_9b = time.perf_counter() - t_phase - t_9a

    # ---- 9c: the denoising protocol on 9b's float32 model ---------------------------------
    model, params, wfit = tm32.model, tm32.params, tm32.fit
    w_len = wfit.lengthscales(model.kernel1)
    w_noise = float(torch.clamp_min(wfit.noise, 1e-6))
    S_stat = stationary_spectrum(model.kernel1, wfit.sigma2, w_len, wfit.omega,
                                 dtype=torch.float32)
    host = lambda x: x.double().cpu().numpy()
    rows, launches = [], None
    for i, v in enumerate(NOISE_LEVELS):
        xi = np.random.default_rng(600 + i).normal(size=T_SPEECH)
        y_noisy = y32 + torch.tensor(np.sqrt(v) * xi, dtype=torch.float32, device=dev)
        ypad = torch.full((T_SPEECH_PAD,), float("nan"), dtype=torch.float32, device=dev)
        ypad[:T_SPEECH] = y_noisy
        call = lambda: denoise(model, params, ypad, float(v), n_samples=N_MC,
                               generator=torch.Generator(dev).manual_seed(i), **DN_KW)
        _, cold = host_s(call)
        if i == 0:
            fk.reset_launches()
        r, warm = host_s(call)
        if i == 0:
            launches = counts()
        y_mc = r.y_hat[:T_SPEECH]
        Eft = r.result.Eft[:T_SPEECH]
        wiener = lambda kap: tv_wiener(model, params, Eft, y_noisy, float(v), stat_spec=S_stat,
                                       stat_floor=kap)
        y_hat = wiener(STAT_FLOOR)
        y_wiener = fft_filterbank(wfit.sigma2, w_len, wfit.omega, y_noisy,
                                  kernel=model.kernel1, noise=v + w_noise).real.sum(-1)
        clean = host(y32)
        st = lambda est: round(stoi(clean, host(est), FS_SPEECH), 4)
        fw = lambda est: round(float(fw_seg_snr(y32, est, FS_SPEECH)), 3)
        ls = lambda est: float(log_spec_snr_db(y32, est))
        row = dict(noise_var=v, snr_in_db=float(snr_db(y32, y_noisy)),
                   snr_out_db=float(snr_db(y32, y_hat)), snr_mc_db=float(snr_db(y32, y_mc)),
                   snr_wiener_db=float(snr_db(y32, y_wiener)), rmse=float(rmse(y32, y_hat)),
                   log_spec_snr_out_db=ls(y_hat), log_spec_snr_mc_db=ls(y_mc),
                   log_spec_snr_wiener_db=ls(y_wiener),
                   stoi_in=st(y_noisy), stoi_out=st(y_hat), stoi_mc=st(y_mc),
                   stoi_wiener=st(y_wiener),
                   fwsegsnr_in_db=fw(y_noisy), fwsegsnr_out_db=fw(y_hat),
                   fwsegsnr_mc_db=fw(y_mc), fwsegsnr_wiener_db=fw(y_wiener),
                   seconds_cold=cold, seconds_warm=warm, stat_floor=STAT_FLOOR,
                   blend={str(k): dict(snr_db=float(snr_db(y32, wiener(k))), stoi=st(wiener(k)),
                                       log_spec_snr_db=ls(wiener(k)),
                                       fwsegsnr_db=fw(wiener(k))) for k in BLEND_ARMS})
        rows.append(row)
        log(f"phase9c v={v}: " + " ".join(f"{k}={val:.4g}" for k, val in row.items()
                                           if k not in ("blend", "noise_var", "stat_floor")))
        require(r.result.Eft.device.type == dev.type, "denoise did not run on the card")
        require(all(math.isfinite(x) for x in (row["snr_out_db"], row["snr_mc_db"],
                                               row["log_spec_snr_out_db"])),
                f"non-finite denoising metrics at v={v}")
    want = {"fused_adf": 1, "fused_bwd": DN_KW["ep_itts"], "fused_fwd": DN_KW["ep_itts"] - 1,
            "fused_adf_mb": 0, "fused_adf_vjp": 0}
    log(f"phase9c launches in one denoise call: {launches} (want {want})")
    require(launches == want, f"launch counts {launches} != {want}: the denoising path missed "
            f"a kernel")
    below = [r["noise_var"] for r in rows if not r["snr_out_db"] > r["snr_in_db"]]
    require(not below, f"snr_out_db <= snr_in_db at noise levels {below}")
    out["protocol"] = dict(T=T_SPEECH, pad_T=T_SPEECH_PAD, launches=launches, rows=rows)
    t_9c = time.perf_counter() - t_phase - t_9a - t_9b

    # ---- 9d: the application, card vs CPU, float64 ------------------------------------------
    y_c = torch.tensor(y_np[:T_DN_PARITY])
    v = NOISE_LEVELS[1]
    y_n = y_c + torch.tensor(np.sqrt(v) * np.random.default_rng(700).normal(size=T_DN_PARITY))
    dn = lambda device, backend: denoise(tm64.model, tm64.params, y_n, v, n_samples=0,
                                         device=device, **dict(DN_KW, backend=backend))
    (rc, card_s), (rh, cpu_s) = (host_s(lambda: dn(d, "fused")) for d in (None, "cpu"))
    rs = dn("cpu", "seq")
    S64 = stationary_spectrum(tm64.model.kernel1, tm64.fit.sigma2.cpu(),
                              tm64.fit.lengthscales(tm64.model.kernel1).cpu(),
                              tm64.fit.omega.cpu(), dtype=torch.float64)
    read = lambda r: tv_wiener(tm64.model, tm64.params.on(r.y_hat.device), r.result.Eft,
                               y_n.to(r.y_hat.device), v, stat_spec=S64.to(r.y_hat.device),
                               stat_floor=STAT_FLOOR)
    wc, wh = read(rc), read(rh)
    met = lambda w: torch.stack([fw_seg_snr(y_c.to(w.device), w, FS_SPEECH),
                                 log_spec_snr_db(y_c.to(w.device), w)])
    dn_rel = max(rel_err(a.cpu(), b) for a, b in (
        (rc.result.Eft, rh.result.Eft), (rc.result.Varft, rh.result.Varft),
        (rc.y_hat, rh.y_hat), (wc, wh), (met(wc), met(wh))))
    seq_rel = rel_err(rs.result.Eft, rh.result.Eft)
    log(f"phase9d denoise T={T_DN_PARITY} f64 v={v}: card (kernels) vs cpu (plain versions) "
        f"rel {dn_rel:.3e} over Eft, Varft, the read-outs, fwSegSNR and log-spectral SNR "
        f"(tol {TOL_TRAIN:g}); card {card_s:.2f} s, cpu {cpu_s:.2f} s; the cpu's seq backend "
        f"(the reference's last-site bookkeeping) against fused: Eft rel {seq_rel:.3e}")
    require(dn_rel <= TOL_TRAIN, "denoise on the card disagrees with the CPU")
    out["app_parity"] = dict(T=T_DN_PARITY, rel=dn_rel, seq_vs_fused_eft_rel=seq_rel,
                             card_s=card_s, cpu_s=cpu_s)
    out["phase9_s"] = dict(total=time.perf_counter() - t_phase, a=t_9a, b=t_9b, c=t_9c)
    log(f"phase9 done in {out['phase9_s']['total']:.0f} s (9a {t_9a:.0f}, 9b {t_9b:.0f}, "
        f"9c {t_9c:.0f})")
    return out


def write_prior_wavs(root, corpus, lengths, model_fmt, seed0):
    """One 16 kHz wav a (name, T): a seeded numpy draw from the named model's
    prior (``prior_signal``), scaled to peak 0.9."""
    import torch

    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.utils.audio import write_wav

    os.makedirs(os.path.join(root, corpus), exist_ok=True)
    for b, (name, T) in enumerate(lengths):
        model, params = load_trained(os.path.join(ROOT, model_fmt.format(name)), device="cpu",
                                     dtype=torch.float64)
        y = prior_signal(np.random.default_rng(seed0 + b), model, params, T)
        write_wav(os.path.join(root, corpus, f"{name}.wav"), 0.9 * y / np.abs(y).max(), 16000)


def experiments_phase(smi, dev, batch_s_3sweeps):
    """Phase 10: the experiment drivers on the card ``dev``.  (a) the
    missing-data corpus grid (``run_batched``) at full width, launch counts;
    (b) ``run_file`` on one file, K3's path, against the grid's row; (c)
    batched GIEKF through the driver and alone at a cut T, against
    single-file GIEKF (float32) and card against CPU (float64); (d) the
    driver's IHGP arm at the cut T; (e) ``synthetic.run`` and
    ``train_hyperopt.run_file``.  Returns the numbers of the ``experiments``
    line."""
    import shutil

    import torch

    from nsgp_tpu_torch import experiments as exps
    from nsgp_tpu_torch.experiments import (missing_data, synthetic, train_corpus,
                                            train_hyperopt, with_lik)
    from nsgp_tpu_torch.inference.batched import giekf_infer_batch
    from nsgp_tpu_torch.inference.giekf import GIEKFConfig, giekf_infer
    from nsgp_tpu_torch.models.gtnmf import stack_params
    from nsgp_tpu_torch.ops import fused_kalman as fk

    t_phase = time.perf_counter()
    out = {"device": smi, "cuts": EXP_CUTS, "s": {}}
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    audio = os.path.join(ROOT, EXP_AUDIO)
    shutil.rmtree(audio, ignore_errors=True)
    cwd, audio_root = os.getcwd(), exps.AUDIO_ROOT
    os.chdir(ROOT)  # the drivers read results/trained/ from the checkout's root
    try:
        with open(os.path.join(ROOT, CORPUS)) as f:
            lengths = [(r["file"], r["T"]) for r in json.load(f)["files"]
                       if r["kernel1"] == "exp"]
        exps.AUDIO_ROOT = os.path.join(audio, "full")
        write_prior_wavs(exps.AUDIO_ROOT, "music", lengths, EXP_MODELS, 1000)
        out["s"]["wavs"] = time.perf_counter() - t_phase

        # ---- 10a: the corpus grid at full width ------------------------------------
        t0 = time.perf_counter()
        fk.reset_launches()
        grid = missing_data.run_batched(corpus="music", kernels=("exp",), engines=("ep",),
                                        ep_itts=GRID_ITTS, n_samples=GRID_MC, device=dev)
        launches = counts()
        out["s"]["a"] = time.perf_counter() - t0
        want = {"fused_fwd": 2 * sum(i - 1 for i in GRID_ITTS), "fused_bwd": 2 * sum(GRID_ITTS),
                "fused_adf": 0, "fused_adf_mb": 2 * len(GRID_ITTS), "fused_adf_vjp": 0}
        files = grid["files"]
        pad_T = files[0]["pad_T"]
        rows = [(f["file"], r) for f in files for r in f["rows"]]
        bad = [(n, r) for n, r in rows if "error" in r or not (
            math.isfinite(r["snr_gaps_db"]) and math.isfinite(r["rmse_gaps"]))]
        arms = {str(r["ep_itts"]): dict(batch_size=r["batch_size"], seconds_cold=r["seconds_cold"],
                                        batch_seconds_warm=r["batch_seconds_warm"])
                for r in files[0]["rows"]}
        log(f"phase10a run_batched music exp ep itts={GRID_ITTS} n_samples={GRID_MC} BF="
            f"{len(files)} pad_T={pad_T} f32 on {smi}: {out['s']['a']:.1f} s; per arm {arms}; "
            f"phase 5's 3-sweep batch call {batch_s_3sweeps:.3f} s; launches={launches} "
            f"(want {want}); aggregate {grid['aggregate']}")
        require(len(files) == len(lengths) and pad_T == -(-max(T for _, T in lengths) // 2048)
                * 2048 and [f["T"] for f in files] == [T for _, T in lengths],
                "phase10a: unexpected corpus shape")
        require(not bad, f"phase10a: non-finite or failed rows {bad}")
        require(launches == want, f"launch counts {launches} != {want}: the corpus grid missed "
                f"a kernel")
        out["grid"] = dict(files=len(files), pad_T=pad_T, itts=GRID_ITTS, n_samples=GRID_MC,
                           launches=launches, arms=arms, phase5_batch_s_3sweeps=batch_s_3sweeps,
                           aggregate=grid["aggregate"], grid_wall_s=grid["grid_wall_seconds"])

        # ---- 10b: the serial driver on one file (K3) against the grid --------------
        t0 = time.perf_counter()
        name = files[0]["file"]
        fk.reset_launches()
        ser = missing_data.run_file("music", name, engines=("ep",), ep_itts=(SERIAL_ITTS,),
                                    pad_T=pad_T, n_samples=0, device=dev)
        serial_launches = counts()
        twin = missing_data.run_batched(corpus="music", kernels=("exp",), engines=("ep",),
                                        ep_itts=(SERIAL_ITTS,), n_samples=0, device=dev)
        out["s"]["b"] = time.perf_counter() - t0
        r_s = ser["rows"][0]
        r_b = next(f for f in twin["files"] if f["file"] == name)["rows"][0]
        rel = max(abs(r_s[k] - r_b[k]) / max(abs(r_b[k]), 1.0) for k in ("rmse_gaps",
                                                                       "snr_gaps_db"))
        log(f"phase10b run_file {name} ep itts={SERIAL_ITTS} n_samples=0 (K3): rmse "
            f"{r_s['rmse_gaps']:.6g} snr {r_s['snr_gaps_db']:.6g} dB against the batched grid's "
            f"{r_b['rmse_gaps']:.6g} / {r_b['snr_gaps_db']:.6g}: rel {rel:.3e} (tol "
            f"{TOL_SERIAL:g}); warm {r_s['seconds_warm']} s, cold {r_s['seconds_cold']} s; "
            f"launches {serial_launches}")
        require(rel <= TOL_SERIAL, "phase10b: the serial row disagrees with the batched grid")
        require(serial_launches["fused_adf"] == 2 and serial_launches["fused_adf_mb"] == 0,
                f"phase10b: launch counts {serial_launches}: the serial path missed K3")
        out["serial"] = dict(file=name, itts=SERIAL_ITTS, rel=rel, row=r_s, grid_row=r_b,
                             launches=serial_launches)

        # ---- 10c: batched GIEKF at the cut T ----------------------------------------
        t0 = time.perf_counter()
        exps.AUDIO_ROOT = os.path.join(audio, "cut")
        write_prior_wavs(exps.AUDIO_ROOT, "music", [(n, T_CUT) for n in CUT_FILES],
                         EXP_MODELS, 2000)
        gk = missing_data.run_batched(corpus="music", files=CUT_FILES, kernels=("exp",),
                                      engines=("giekf",), ep_itts=GIEKF_ITTS,
                                      n_samples=GRID_MC, device=dev)
        g_rows = [r for f in gk["files"] for r in f["rows"]]
        require(all(math.isfinite(r["snr_gaps_db"]) and math.isfinite(r["rmse_gaps"])
                    for r in g_rows), f"phase10c: non-finite GIEKF rows {g_rows}")

        def cut_inputs(dtype):
            tms, ys, ms = [], [], []
            for n in CUT_FILES:
                tm, y_norm = train_corpus.load_corpus_model("music", n, "exp", device=dev,
                                                            dtype=dtype)
                y, m, _ = missing_data._padded(n, y_norm, T_CUT)
                tms.append(tm)
                ys.append(y)
                ms.append(m)
            pB = stack_params([with_lik(tm.params, 1e-4) for tm in tms])
            return (tms[0].model, pB, torch.tensor(np.stack(ys), dtype=dtype, device=dev),
                    torch.tensor(np.stack(ms), device=dev))

        gcfg = GIEKFConfig(**missing_data.engine_config("giekf", GIEKF_ITTS[-1]))
        model, pB, yB, mB = cut_inputs(torch.float32)
        rb, b_s = host_s(lambda: giekf_infer_batch(model, pB, yB, mB, gcfg))
        r1, one_s = host_s(lambda: giekf_infer(model, pB.select(2), yB[2], mB[2], gcfg))
        g_rel = max(rel_err(a, b) for a, b in ((rb.Eft[2], r1.Eft), (rb.Varft[2], r1.Varft),
                                               (rb.nll[2], r1.nll)))
        steps = T_CUT * gcfg.g_iter
        m64 = cut_inputs(torch.float64)
        r64, c64_s = host_s(lambda: giekf_infer_batch(*m64, gcfg))
        h64, h64_s = host_s(lambda: giekf_infer_batch(*m64, gcfg, device="cpu"))
        g64 = max(rel_err(a.cpu(), b) for a, b in ((r64.Eft, h64.Eft), (r64.Varft, h64.Varft),
                                                   (r64.nll, h64.nll)))
        out["s"]["c"] = time.perf_counter() - t0
        arms_g = {str(r["ep_itts"]): dict(seconds_cold=r["seconds_cold"],
                                          batch_seconds_warm=r["batch_seconds_warm"])
                  for r in gk["files"][0]["rows"]}
        log(f"phase10c run_batched giekf files={CUT_FILES} T={T_CUT} itts={GIEKF_ITTS} f32: "
            f"{arms_g}; aggregate {gk['aggregate']}")
        log(f"phase10c giekf_infer_batch BF=3 m={rb.ms.shape[-1]} g_iter={gcfg.g_iter} "
            f"l_iter={gcfg.l_iter} T={T_CUT} f32: {b_s:.2f} s = {1e3 * b_s / steps:.3f} ms a "
            f"step for the batch, one file alone (giekf_infer) {one_s:.2f} s = "
            f"{1e3 * one_s / steps:.3f} ms a step; last file batch vs single rel {g_rel:.3e} "
            f"(tol {TOL_F32:g}); f64 card vs cpu rel {g64:.3e} (tol {TOL_REAL:g}), card "
            f"{c64_s:.2f} s, cpu {h64_s:.2f} s")
        require(g_rel <= TOL_F32, "phase10c: batched GIEKF disagrees with giekf_infer")
        require(g64 <= TOL_REAL, "phase10c: batched GIEKF on the card disagrees with the CPU")
        require(rb.ms.shape == (3, T_CUT, 57), f"phase10c: state shape {tuple(rb.ms.shape)}")
        out["giekf"] = dict(files=CUT_FILES, T=T_CUT, arms=arms_g, aggregate=gk["aggregate"],
                            batch_s=b_s, batch_ms_step=1e3 * b_s / steps, single_s=one_s,
                            single_ms_step=1e3 * one_s / steps, f32_rel=g_rel, f64_rel=g64,
                            f64_card_s=c64_s, f64_cpu_s=h64_s)
        del rb, r1, r64, h64, m64

        # ---- 10d: the driver's IHGP arm at the cut T ----------------------------------
        t0 = time.perf_counter()
        fk.reset_launches()
        ih = missing_data.run_batched(corpus="music", files=CUT_FILES, kernels=("exp",),
                                      engines=("ihgp",), ep_itts=IHGP_ITTS, n_samples=GRID_MC,
                                      device=dev)
        ih_launches = counts()
        out["s"]["d"] = time.perf_counter() - t0
        ih_rows = [r for f in ih["files"] for r in f["rows"]]
        arms_i = {str(r["ep_itts"]): dict(seconds_cold=r["seconds_cold"],
                                          batch_seconds_warm=r["batch_seconds_warm"])
                  for r in ih["files"][0]["rows"]}
        log(f"phase10d run_batched ihgp files={CUT_FILES} T={T_CUT} itts={IHGP_ITTS} f32 "
            f"(parallel, chunk 2048, grid_lo -7, keep_best): {arms_i}; aggregate "
            f"{ih['aggregate']}; launches of K1-K4 {ih_launches}")
        require(all(math.isfinite(r["snr_gaps_db"]) and math.isfinite(r["rmse_gaps"])
                    for r in ih_rows), f"phase10d: non-finite IHGP rows {ih_rows}")
        require(not any(ih_launches.values()), "phase10d: the IHGP arm launched an EP kernel")
        out["ihgp"] = dict(files=CUT_FILES, T=T_CUT, arms=arms_i, aggregate=ih["aggregate"])

        # ---- 10e: two more drivers at toy sizes ---------------------------------------
        t0 = time.perf_counter()
        syn = synthetic.run(T=T_SYN, seed=0, ep_itts=SYN_ITTS, device=dev)
        syn_s = time.perf_counter() - t0
        exps.AUDIO_ROOT = os.path.join(audio, "speech")
        y_sp = speech_signal(T_HO, 800)
        os.makedirs(os.path.join(exps.AUDIO_ROOT, "speech"))
        from nsgp_tpu_torch.utils.audio import write_wav

        write_wav(os.path.join(exps.AUDIO_ROOT, "speech", "speech0_female.wav"),
                  0.9 * y_sp / np.abs(y_sp).max(), 16000)
        fk.reset_launches()
        ho = train_hyperopt.run_file("speech", "speech0_female", steps=HO_STEPS, device=dev)
        ho_launches = counts()
        out["s"]["e"] = time.perf_counter() - t0
        log(f"phase10e synthetic.run T={T_SYN} ep_itts={SYN_ITTS} f32: " + ", ".join(
            f"{e} rmse_sig {syn[e]['rmse_sig']:.4g} ({syn[e]['seconds']} s)"
            for e in ("ep", "ihgp", "giekf")) + f" (y_std {syn['config']['y_std']:.4g}); "
            f"{syn_s:.1f} s")
        log(f"phase10e train_hyperopt.run_file speech0_female T={T_HO} {HO_STEPS} steps f32: "
            f"energies {ho['energy_trace']} in {ho['opt_seconds']} s; gap SNR init "
            f"{ho['snr_gaps_init_db']:.3f} dB, learned {ho['snr_gaps_learned_db']:.3f} dB; "
            f"launches {ho_launches}")
        require(ho_launches["fused_adf_vjp"] == HO_STEPS,
                f"phase10e: train_hyperopt's {HO_STEPS} steps launched K7 "
                f"{ho_launches['fused_adf_vjp']} times")
        require(all(math.isfinite(syn[e]["rmse_sig"]) for e in ("ep", "ihgp", "giekf")),
                "phase10e: non-finite synthetic rows")
        require(all(math.isfinite(v) for v in ho["energy_trace"] + [
            ho["snr_gaps_init_db"], ho["snr_gaps_learned_db"]]), "phase10e: non-finite hyperopt")
        out["synthetic"] = {e: syn[e] for e in ("ep", "ihgp", "giekf")}
        out["train_hyperopt"] = {k: ho[k] for k in ("T", "steps", "opt_seconds", "energy_trace",
                                                    "snr_gaps_init_db", "snr_gaps_learned_db",
                                                    "learned")}
        out["train_hyperopt"]["launches"] = ho_launches
    finally:
        os.chdir(cwd)
        exps.AUDIO_ROOT = audio_root
        shutil.rmtree(audio, ignore_errors=True)
    out["s"]["total"] = time.perf_counter() - t_phase
    log(f"phase10 done in {out['s']['total']:.0f} s ({', '.join(f'{k} {v:.0f}' for k, v in out['s'].items() if k != 'total')})")
    out["launches"] = launches
    return out


# Phase 11: the device mesh (nsgp_tpu_torch/parallel/mesh.py).  The ranks
# share the one card, so they join over gloo: NCCL refuses two ranks on one
# GPU ("Duplicate GPU detected", checked on an H100).
MESH_BACKEND = "gloo"
MESH_RANKS = 4
T_MESH64 = 4096  # 11a in float64
T_MESH_TIME, MESH_CHUNK = 2048, 256  # 11b, 11c: the seq engine's sweep 1 is a Python loop
MESH_TRAIN = dict(B=4, T=512, ep_itts=1)  # 11d
SD_ARGS = ["--T", "1024", "--chunk", "128", "--reps", "0", "--world", "2"]  # 11e
TOL_MESH64 = 1e-9
MESH_CUTS = {
    "b_T": f"{T_MESH_TIME} of 8192 and chunk {MESH_CHUNK}: sweep 1 is the sequential ADF loop "
           f"on every rank, about 2 ms a step on the card",
    "c_T": f"{T_MESH_TIME} of 4096, the same signal and config as (b), so one unsharded "
           f"reference serves both",
    "d": "ep_itts=1 (the ADF energy that learn.fit_hyperparams climbs by default): autograd "
         "through the sequential loop at about 7 ms a step",
    "e": "scaling_dryrun at --T 1024 --chunk 128 --reps 0 --world 2 (the CLI's T=196 608 "
         "takes minutes an arm: sweep 1 is the sequential loop on every rank)",
    "f": "wavs are seeded draws from the trained models' priors (no audio in the repo): "
         "speech_fit_probe on speech1_male at T=8000; gap_fill_data at T=1700 around the first "
         "reference gap (IHGP's sweep 1 is a Python loop); spectrogram_data at T=4096; "
         "source_sep_data on seeded test wavs; the renderers are not run (no matplotlib on "
         "the card's machine; the CPU tests draw them)",
    "phase7b": "one value and gradient at T=8000 of the training length 16 000, to keep the "
               "whole script under 1100 s of its 1200 with this phase (us a step unchanged)",
}
T_PROBE, T_GAP_FIG, T_SPEC_FIG = 8000, 1700, 4096  # 11f


def mesh_rank(rank):
    """One rank of phase 11's world (every rank runs every case; a case's
    mesh takes the leading ranks).  (a) ``shard_inference_over_channels`` on
    the fused path at the headline shape, float32, and at T_MESH64 in float64,
    each against the unsharded call timed on rank 0 alone; (b) time-sharded
    blocked EP at 4 ranks, (c) the 2-D mesh, both against one rank; (d) a
    data-parallel training step at 2 ranks against 1.  Returns launch counts
    of (a)'s sharded run, and on rank 0 the numbers of the ``mesh`` line."""
    import functools

    import torch
    import torch.distributed as dist

    from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.parallel import collectives
    from nsgp_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda")
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    out = {"rank": rank, "backend": dist.get_backend()}
    fields = ("Eft", "Varft", "nlZ", "ms", "Ps", "lZ")

    # (a) channel-sharded fused EP, float32 at the headline shape, then float64
    cfg = EPConfig(ep_itts=EP_ITTS, backend="fused", moment_chunk=8192)
    for dtype, T, label in ((torch.float32, T_MAIN, "a_f32"), (torch.float64, T_MESH64, "a_f64")):
        model, params, y = bench_inputs(dtype, dev)
        y = y[:T]
        ref, one = None, []
        if rank == 0:
            ref = ep_infer(model, params, y, None, cfg)  # warm-up, then the timed runs
            one = [host_s(lambda: ep_infer(model, params, y, None, cfg))[1] for _ in range(2)]
        dist.barrier()
        mesh = pmesh.make_mesh({"channel": 2})
        if mesh is not None:
            fk.reset_launches()
            collectives.reset_collectives()
            res, first = host_s(lambda: pmesh.shard_inference_over_channels(
                model, params, y, mesh, cfg))
            launches, coll = counts(), collectives.collective_stats()
            two = [host_s(lambda: pmesh.shard_inference_over_channels(
                model, params, y, mesh, cfg))[1] for _ in range(2)]
            out[label] = dict(launches=launches, checksum=res.Eft.double().sum().item())
            if rank == 0:
                check_posterior(f"phase11 {label}", res.nlZ, res.Eft, res.Varft, (T, D + N))
                _, rel = max_err([getattr(res, f) for f in fields], [getattr(ref, f) for f in fields])
                out[label].update(
                    T=T, channels=[c.numel() for c in torch.arange(D + N).tensor_split(2)],
                    rel=rel,
                    s_per_sweep_1rank=float(np.mean(one)) / EP_ITTS,
                    s_per_sweep_2ranks=float(np.mean(two)) / EP_ITTS, first_call_s=first,
                    collectives=coll,
                    collective_bytes_per_sweep=sum(v["bytes"] for v in coll.values()) / EP_ITTS)
        dist.barrier()
        del ref

    # (b) time-sharded blocked EP on the seq engine, (c) the 2-D mesh: float64
    model, params, y = bench_inputs(torch.float64, dev)
    y = y[:T_MESH_TIME]
    cfg_t = EPConfig(ep_itts=EP_ITTS, parallel=True, chunk=MESH_CHUNK)
    ref = None
    if rank == 0:
        ref, out["bc_1rank_s"] = host_s(lambda: ep_infer(model, params, y, None, cfg_t))
    dist.barrier()
    fk.reset_launches()
    mesh = pmesh.make_mesh({"time": MESH_RANKS})
    collectives.reset_collectives()
    res, t_b = host_s(lambda: pmesh.shard_inference_over_time(model, params, y, mesh, cfg_t,
                                                              chunk=MESH_CHUNK))
    coll_b = collectives.collective_stats()
    mesh = pmesh.make_mesh({"time": 2, "channel": 2})
    with pmesh.set_mesh(mesh):
        res_c, t_c = host_s(lambda: ep_infer(model, params, y, None, cfg_t._replace(
            time_axis="time", channel_axis="channel")))
    out["bc_launches"] = counts()
    if rank == 0:
        for label, r, t, coll in (("b", res, t_b, coll_b), ("c", res_c, t_c, None)):
            _, rel = max_err([getattr(r, f) for f in fields], [getattr(ref, f) for f in fields])
            out[label] = dict(T=T_MESH_TIME, chunk=MESH_CHUNK, rel=rel, s=t, collectives=coll)
    dist.barrier()

    # (d) one data-parallel training step, float64
    B, Tt = MESH_TRAIN["B"], MESH_TRAIN["T"]
    ys = y[: B * Tt].reshape(B, Tt)
    masks = torch.ones_like(ys, dtype=torch.bool)
    cfg_d = EPConfig(ep_itts=MESH_TRAIN["ep_itts"])
    sgd = functools.partial(torch.optim.SGD, lr=1e-2)
    steps = {}
    for n in (1, 2):
        mesh = pmesh.make_mesh({"data": n})
        if mesh is not None:
            step = pmesh.make_train_step(model, cfg_d, mesh, sgd)
            collectives.reset_collectives()
            (p2, _, loss), t = host_s(lambda: step(params, pmesh.init_train_state(params, sgd),
                                                   ys, masks))
            steps[n] = (p2, loss, t, collectives.collective_stats())
        dist.barrier()
    if rank == 0:
        (p1, l1, t1, _), (p2, l2, t2, coll_d) = steps[1], steps[2]
        _, rel = max_err([l2] + list(p2.leaves()), [l1] + list(p1.leaves()))
        out["d"] = dict(B=B, T=Tt, rel=rel, s_1rank=t1, s_2ranks=t2, loss=l2.item(),
                        collectives=coll_d)
    return out


def mesh_phase(smi):
    """Phase 11: the device mesh on the card, MESH_RANKS ranks over gloo
    (``mesh_rank``), then the scaling_dryrun CLI in its own world.  Returns the
    numbers of the ``mesh`` line and the per-rank launches of (a)."""
    import torch

    from nsgp_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    ranks = pmesh.spawn_world(mesh_rank, MESH_RANKS, MESH_BACKEND)
    r0 = ranks[0]
    t_abcd = time.perf_counter() - t_phase
    for label, tol in (("a_f32", TOL_F32), ("a_f64", TOL_MESH64)):
        a = r0[label]
        log(f"phase11 {label} shard_inference_over_channels fused T={a['T']} C={D + N} on 2 ranks "
            f"({MESH_BACKEND}): rel err vs unsharded {a['rel']:.3e} (tol {tol:g}); s/sweep 1 rank "
            f"{a['s_per_sweep_1rank']:.4f}, 2 ranks {a['s_per_sweep_2ranks']:.4f} (first call "
            f"{a['first_call_s']:.3f} s); collectives {a['collectives']}, "
            f"{a['collective_bytes_per_sweep']:.0f} B a sweep; launches by rank "
            f"{[r[label]['launches'] for r in ranks[:2]]} on {smi}")
        require(a["rel"] <= tol, f"phase11 {label}: sharded EP disagrees with unsharded")
        require(ranks[1][label]["checksum"] == a["checksum"], f"phase11 {label}: ranks differ")
        want = {"fused_fwd": EP_ITTS - 1, "fused_bwd": EP_ITTS, "fused_adf": 1, "fused_adf_mb": 0,
                "fused_adf_vjp": 0}
        for r in ranks[:2]:
            require(r[label]["launches"] == want, f"phase11 {label}: rank {r['rank']} launched "
                                                  f"{r[label]['launches']}, not {want}")
    for label in ("b", "c"):
        log(f"phase11 {label} T={T_MESH_TIME} chunk={MESH_CHUNK} f64 "
            f"{'time 4' if label == 'b' else 'time 2 x channel 2'}: rel err vs 1 rank "
            f"{r0[label]['rel']:.3e} (tol {TOL_MESH64:g}); {r0[label]['s']:.2f} s against "
            f"{r0['bc_1rank_s']:.2f} s on 1 rank; collectives {r0[label]['collectives']}")
        require(r0[label]["rel"] <= TOL_MESH64, f"phase11 {label}: sharded EP disagrees")
    require(all(v == 0 for r in ranks for v in r["bc_launches"].values()),
            "phase11 b/c: the seq engine launched a fused kernel")
    d = r0["d"]
    log(f"phase11 d data-parallel step B={d['B']} T={d['T']} f64: 2 ranks vs 1 rel err "
        f"{d['rel']:.3e} (tol {TOL_MESH64:g}); {d['s_2ranks']:.2f} s against {d['s_1rank']:.2f} s; "
        f"loss {d['loss']:.6f}; collectives {d['collectives']}")
    require(d["rel"] <= TOL_MESH64, "phase11 d: the data-parallel step disagrees with one rank")

    # (e) the scaling_dryrun CLI, its own world of ranks on the card
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "nsgp_tpu_torch.experiments.scaling_dryrun", *SD_ARGS,
                    "--device", "cuda", "--backend", MESH_BACKEND], cwd=ROOT, check=True,
                   timeout=600)
    t_e = time.perf_counter() - t0
    with open(os.path.join(ROOT, "results", "torch", "scaling_dryrun.json")) as f:
        sd = json.load(f)
    arms = [(a["arm"], a["devices"], a["cold_seconds"], a["max_abs_diff_vs_1dev"],
             a["collectives"].get("chunk_totals")) for a in sd["arms"]]
    log(f"phase11 e scaling_dryrun {' '.join(SD_ARGS)}: arms (arm, ranks, s, max|diff| vs 1 rank, "
        f"chunk totals) {arms}; model {sd['pass2_exchange_model']['total_bytes_per_pass']} B a "
        f"pass ({t_e:.0f} s)")
    require(len(sd["arms"]) == 4 and all(a["finite"] and a["max_abs_diff_vs_1dev"] <= TOL_F32
                                         for a in sd["arms"]), "phase11 e: scaling_dryrun arms")
    t0 = time.perf_counter()
    f = drivers_on_card()
    t_f = time.perf_counter() - t0
    out = dict(backend=MESH_BACKEND, ranks=MESH_RANKS, cuts=MESH_CUTS,
               **{k: r0[k] for k in ("a_f32", "a_f64", "b", "c", "d", "bc_1rank_s")},
               e=dict(args=SD_ARGS, arms=sd["arms"],
                      pass2_exchange_model=sd["pass2_exchange_model"], s=t_e), f=f,
               launches_by_rank=[r["a_f32"]["launches"] for r in ranks[:2]])
    out["phase11_s"] = dict(total=time.perf_counter() - t_phase, abcd=t_abcd, e=t_e, f=t_f)
    log(f"phase11 done in {out['phase11_s']['total']:.0f} s (a-d {t_abcd:.0f}, e {t_e:.0f}, "
        f"f {t_f:.0f})")
    return out


def drivers_on_card():
    """Phase 11f: ``speech_fit_probe.run`` and the ``figures`` data functions
    on the card, on seeded prior-draw wavs (``MESH_CUTS["f"]``)."""
    import shutil

    import torch

    from nsgp_tpu_torch import experiments as exps
    from nsgp_tpu_torch.experiments import figures, speech_fit_probe
    from nsgp_tpu_torch.experiments.source_sep import PARTS, TEST_IND
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.utils.audio import write_wav

    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}
    audio = os.path.join(ROOT, EXP_AUDIO, "mesh")
    shutil.rmtree(audio, ignore_errors=True)
    cwd, audio_root = os.getcwd(), exps.AUDIO_ROOT
    os.chdir(ROOT)  # the drivers read results/ from the checkout's root
    out = {}
    try:
        exps.AUDIO_ROOT = audio
        for name, kernel, T, seed in (("speech1_male", "matern32", T_PROBE, 1100),
                                      ("speech2_male", "exp", T_SPEC_FIG, 1101)):
            write_prior_wavs(audio, "speech", [(name, T)], os.path.join(
                "results", "trained", "speech", f"trained_{{}}_{kernel}.npz"), seed)
        write_prior_wavs(audio, "music", [("bamboo_flute", T_GAP_FIG)], EXP_MODELS, 1200)
        test_dir = os.path.join(audio, "source_sep", "test_data")
        os.makedirs(test_dir)
        rng = np.random.default_rng(1300)
        parts = {p: 0.3 * rng.normal(size=TEST_IND[1]) for p in PARTS}
        for p, y in parts.items():
            write_wav(os.path.join(test_dir, f"011PFNOM_{p}_part.wav"), y, 16000)
        write_wav(os.path.join(test_dir, "011PFNOM_mixture.wav"), sum(parts.values()) / 3, 16000)

        fk.reset_launches()
        probe, t_probe = host_s(lambda: speech_fit_probe.run(["speech1_male"]))
        row = probe["files"][0]
        out["speech_fit_probe"] = dict(T=T_PROBE, row=row, s=t_probe, launches=counts())
        log(f"phase11 f speech_fit_probe speech1_male T={T_PROBE} EP@20 fused: val "
            f"{ {a: r.get('val_snr_db') for a, r in row['arms'].items()} } selected "
            f"{row['selected']}, test {row['test_snr_db_base']} / {row['test_snr_db_selected']} dB "
            f"(prior draws); {t_probe:.1f} s; launches {counts()}")
        require(set(row["arms"]) == set(speech_fit_probe.ARMS)
                and all(math.isfinite(r["val_snr_db"]) for r in row["arms"].values())
                and counts()["fused_adf"] >= 5, "phase11 f: speech_fit_probe")
        fk.reset_launches()
        gap, t_gap = host_s(lambda: figures.gap_fill_data(gap_index=0))
        gap_launches = counts()
        spec, t_spec = host_s(lambda: figures.spectrogram_data(ep_itts=30))
        sep, t_sep = host_s(figures.source_sep_data)
        agg = figures.aggregates_data()
        finite = lambda xs: all(np.all(np.isfinite(x)) for x in xs)
        out["figures"] = dict(
            gap_fill=dict(T=T_GAP_FIG, s=t_gap, launches=gap_launches,
                          rmse_in_window={k: float(np.sqrt(np.mean((v - gap["clean"]) ** 2)))
                                          for k, v in gap["recons"].items()}),
            spectrograms=dict(T=T_SPEC_FIG, s=t_spec, snr_db={
                t: float(10 * np.log10(np.sum(spec["panels"][0][1] ** 2)
                                       / np.sum((x - spec["panels"][0][1]) ** 2)))
                for t, x in spec["panels"][1:]}),
            source_sep=dict(s=t_sep, parts=list(sep["parts"])),
            aggregates=[c for c, _ in agg], rendered=False)
        log(f"phase11 f figures data on the card: gap_fill {t_gap:.1f} s (launches "
            f"{gap_launches}), spectrograms {t_spec:.1f} s "
            f"{out['figures']['spectrograms']['snr_db']}, source_sep {t_sep:.1f} s, aggregates "
            f"{out['figures']['aggregates']}; renderers not run (no matplotlib here)")
        require(finite(gap["recons"].values()) and finite(x for _, x in spec["panels"])
                and finite(x for pair in sep["parts"].values() for x in pair)
                and gap_launches["fused_adf"] == 1 and len(agg) == 2, "phase11 f: figures data")
    finally:
        os.chdir(cwd)
        exps.AUDIO_ROOT = audio_root
        shutil.rmtree(audio, ignore_errors=True)
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "nsgp_tpu_torch")):
        raise RuntimeError("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test needs an NVIDIA GPU")

    from nsgp_tpu_torch.apps.missing_data import fill_gaps_batch
    from nsgp_tpu_torch.apps.source_sep import separate
    from nsgp_tpu_torch.convert import load_trained
    from nsgp_tpu_torch.inference import ep as ep_mod
    from nsgp_tpu_torch.inference.ep import EPConfig, ep_infer
    from nsgp_tpu_torch.models import mixture
    from nsgp_tpu_torch.models.gtnmf import sample_prior, stack_params
    from nsgp_tpu_torch.ops import _build
    from nsgp_tpu_torch.ops import fused_kalman as fk
    from nsgp_tpu_torch.ops.kalman import Sites
    from nsgp_tpu_torch.ops.ssm import flatten_files

    t_start = time.perf_counter()
    counts = lambda: {fn.__name__: fn.launches for fn in fk.WRAPPERS}

    # ---- phase 0: card, build ---------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase0 device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    log(f"phase0 kernels built (nvcc, {len(_build.SOURCES)} sources in parallel) and loaded in "
        f"{time.perf_counter() - t0:.1f} s -> {_build.library_path()}")

    # ---- phase 1: K1-K3 vs their plain versions ------------------------------
    dev = torch.device("cuda")
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        model, params, _ = bench_inputs(dtype, dev)
        gen = torch.Generator().manual_seed(0)
        y, _, _ = sample_prior(gen, model, params, T_KERNEL)  # CPU noise, card model
        mask = torch.ones(T_KERNEL, dtype=torch.bool, device=dev)
        mask[1000:1100] = False  # a gap: unobserved steps keep zero sites
        ssm = model.build_ssm(params)
        kalman_compare(f"phase1 {label} T={T_KERNEL}", ssm,
                       random_sites(T_KERNEL, D + N, seed=1), tol, time_reps=5)
        compare(f"phase1 {label} T={T_KERNEL}", "fused_adf", *adf_case(model, params, y, mask),
                tol, time_reps=5)
        blocked_checks(f"phase1 {label} blocked", ssm, tol, seed=7,
                       path_chunk=fk.chunk_length(T_MAIN, D + N))
    model, params, y = bench_inputs(torch.float32, dev)
    mask = torch.ones(T_MAIN, dtype=torch.bool, device=dev)
    single = kalman_path_checks("phase1 f32", model.build_ssm(params),
                                random_sites(T_MAIN, D + N, seed=2), T_PLAIN, TOL_F32)
    single["fused_adf"] = compare(
        f"phase1 f32 T={T_MAIN} (plain over {T_PLAIN} steps)", "fused_adf",
        *adf_case(model, params, y, mask, steps=T_PLAIN), TOL_F32, 3,
        timed=adf_case(model, params, y, mask)[0])
    bs = model.build_ssm(params).block_size
    single["fused_fwd"]["bound"] = bound_fwd(T_MAIN, D + N, bs)
    single["fused_bwd"]["bound"] = bound_bwd(T_MAIN, D + N, bs)
    single["fused_adf"]["bound"] = bound_adf(T_MAIN, 1, D, N, 77, bs, T_MAIN)

    # ---- phase 2: the single-signal path at the headline shape ----------------
    cfg = EPConfig(ep_itts=EP_ITTS, backend="fused", moment_chunk=8192)
    fk.reset_launches()
    res, first_s = host_s(lambda: ep_infer(model, params, y, None, cfg))
    launches_single = counts()
    want = {"fused_fwd": EP_ITTS - 1, "fused_bwd": EP_ITTS, "fused_adf": 1, "fused_adf_mb": 0,
            "fused_adf_vjp": 0}
    nlZ = res.nlZ.cpu().numpy()
    log(f"phase2 first run {first_s:.3f} s launches={launches_single} nlZ={nlZ.tolist()} "
        f"maxdiff={res.maxdiff.cpu().numpy().tolist()}")
    if launches_single != want:
        raise AssertionError(f"launch counts {launches_single} != {want}: the single-signal "
                             f"path missed a kernel")
    check_posterior("phase2", res.nlZ, res.Eft, res.Varft, (T_MAIN, D + N))
    if res.ms.shape != (T_MAIN, (D + N) * 4):
        raise AssertionError(f"unexpected state shape {tuple(res.ms.shape)}")
    runs = [host_s(lambda: ep_infer(model, params, y, None, cfg))[1] for _ in range(3)]
    s_sweep = float(np.mean(runs)) / EP_ITTS
    log(f"phase2 ep_infer fused f32 T={T_MAIN} {EP_ITTS} sweeps: runs_s={[round(r, 4) for r in runs]} "
        f"s/sweep={s_sweep:.4f} on {smi}")
    model64, params64, y64 = bench_inputs(torch.float64, dev)
    res64 = ep_infer(model64, params64, y64, None, cfg)
    gap_eft = (res.Eft.double() - res64.Eft).abs().max().item()
    nlZ64 = res64.nlZ.cpu().numpy()
    gap_nlz = float(np.max(np.abs(nlZ - nlZ64) / np.abs(nlZ64)))
    log(f"phase2 f32 health vs f64: max|Eft32-Eft64|={gap_eft:.3e} (max|Eft64|="
        f"{res64.Eft.abs().max().item():.3e}) nlZ rel gap={gap_nlz:.3e} nlZ64={nlZ64.tolist()}")
    if not (math.isfinite(gap_eft) and gap_nlz < 1e-3):
        raise AssertionError("float32 main path drifted from float64")
    del res, res64

    # ---- phase 3: real weights, card vs CPU ----------------------------------
    tmodel, tparams = load_trained(os.path.join(ROOT, TRAINED), device="cpu",
                                   dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    y_r, _, _ = sample_prior(gen, tmodel, tparams, T_REAL)
    cfg_r = EPConfig(ep_itts=EP_ITTS, backend="fused")
    t0 = time.perf_counter()
    r_cpu = ep_infer(tmodel, tparams, y_r, None, cfg_r, device="cpu")
    cpu_s = time.perf_counter() - t0
    r_gpu = ep_infer(tmodel, tparams, y_r, None, cfg_r)  # default device: the card
    if r_gpu.Eft.device.type != "cuda":
        raise AssertionError("ep_infer with the default device did not run on the card")
    err_abs, err_rel = max_err([r_gpu.Eft.cpu(), r_gpu.Varft.cpu(), r_gpu.nlZ.cpu()],
                               [r_cpu.Eft, r_cpu.Varft, r_cpu.nlZ])
    log(f"phase3 {TRAINED} ({tmodel.variant}, D={tmodel.D}, N={tmodel.N}) T={T_REAL} f64: "
        f"card vs cpu max_abs_err={err_abs:.3e} max_rel_err={err_rel:.3e} (tol {TOL_REAL:g}) "
        f"cpu_plain_s={cpu_s:.2f} nlZ={r_gpu.nlZ.cpu().numpy().tolist()}")
    if not err_rel <= TOL_REAL:
        raise AssertionError("real-weight EP on the card disagrees with the CPU")
    log(f"phases 0-3 done at {time.perf_counter() - t_start:.0f} s")

    # ---- phase 4: K4 vs its plain version; K1, K2 at the batched widths --------
    batch = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        cmodel, cparamsB, cyB, cmaskB, _, _ = corpus_inputs(dtype, dev)
        kern, plain = adf_mb_case(cmodel, cparamsB, cyB, cmaskB, 0, steps=T_KERNEL)
        batch = compare(f"phase4a {label} BF={cyB.shape[0]} D={cmodel.D} N={cmodel.N} "
                        f"T={T_KERNEL}", "fused_adf_mb", kern, plain, tol, time_reps=3)
        flat = flatten_files(cmodel.build_ssm_batch(cparamsB))
        # float64 at C=190 stops short of T=4096: a plain twin's Python loop over
        # 4096 steps at 190 channels, for time; float32 and phase 5 hold that width
        # at the path's own launch
        blocked_checks(f"phase4 {label} blocked", flat, tol, seed=8,
                       path_chunk=fk.chunk_length(cyB.shape[1], flat.num_channels),
                       longest=dtype == torch.float32)
    kalman_compare(f"phase4 f32 C={flat.num_channels} T={T_KERNEL}", flat,
                   random_sites(T_KERNEL, flat.num_channels, seed=3), TOL_F32, time_reps=3)
    mix = {}
    for dtype, tol, label in ((torch.float64, TOL_F64, "f64"), (torch.float32, TOL_F32, "f32")):
        models, plist, y_mix, _ = mixture_inputs(dtype, dev, T_MIX_KERNEL)
        jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
        jpB = stack_params([jp])
        S_mix = fk.sigma_points(jm.moment_params(), dtype, dev)[0].shape[0]
        flat = flatten_files(jm.build_ssm_batch(jpB))
        blocked_checks(f"phase4 {label} blocked", flat, tol, seed=9,
                       path_chunk=fk.chunk_length(T_MIX, flat.num_channels))
        kern, plain = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 256)
        mix = compare(f"phase4b {label} BF=1 D={jm.D} N={jm.N} S={S_mix} s_chunk=256 "
                      f"T={T_MIX_KERNEL}", "fused_adf_mb", kern, plain, tol, time_reps=1)
        if dtype == torch.float64:
            one_chunk, _ = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 0)
            _, rel = max_err(kern(), one_chunk())
            ms0 = cuda_ms(one_chunk, 1)
            log(f"phase4b f64 kernel s_chunk=256 vs s_chunk=0: max_rel_err={rel:.3e} "
                f"(tol {TOL_F64:g}); s_chunk=0 kernel_ms={ms0:.3f} (one code for both)")
            if not rel <= TOL_F64:
                raise AssertionError("streamed and one-chunk sigma sums disagree")
        # several files of the mixture model: a cluster a file, indexed by
        # blockIdx.x / R and % R; windows of the signal and gaps that differ
        yF = y_mix[: BF_MIX_KERNEL * T_MIX_FILES].reshape(BF_MIX_KERNEL, T_MIX_FILES)
        maskF = torch.ones_like(yF) > 0
        for b in range(BF_MIX_KERNEL):
            maskF[b, 20 + 7 * b: 30 + 11 * b] = False
        kern, plain = adf_mb_case(jm, stack_params([jp] * BF_MIX_KERNEL), yF, maskF, 256)
        compare(f"phase4b {label} BF={BF_MIX_KERNEL} D={jm.D} N={jm.N} S={S_mix} "
                f"cluster={fk.adf_launch_shape(S_mix)['cluster']} T={T_MIX_FILES}", "fused_adf_mb",
                kern, plain, tol, time_reps=1)
    if (jm.D, jm.N, S_mix) != (48, 9, 3973):
        raise AssertionError(f"mixture width is D={jm.D}, N={jm.N}, S={S_mix}")
    kalman_compare(f"phase4 f32 C={flat.num_channels} T={T_KERNEL}", flat,
                   random_sites(T_KERNEL, flat.num_channels, seed=4), TOL_F32, time_reps=3)
    del flat

    # ---- phase 5: the batched path at full width -------------------------------
    cmodel, cparamsB, cyB, cmaskB, cgapsB, lengths = corpus_inputs(torch.float32, dev)
    BF_c, T_c = cyB.shape
    C_c = cmodel.D + cmodel.N
    gap_kw = dict(engine="ep", n_samples=20, metric_gapsB=cgapsB, ep_itts=EP_ITTS,
                  backend="fused", **CORPUS_KW)
    run_batch = lambda: fill_gaps_batch(cmodel, cparamsB, cyB, cmaskB,
                                        generator=torch.Generator().manual_seed(0), **gap_kw)
    fk.reset_launches()
    gres, first_s = host_s(run_batch)
    launches_batch = counts()
    want = {"fused_adf_mb": 1, "fused_bwd": EP_ITTS, "fused_fwd": EP_ITTS - 1, "fused_adf": 0,
            "fused_adf_vjp": 0}
    rb = gres.result
    log(f"phase5 fill_gaps_batch BF={BF_c} T={T_c} lengths={lengths} f32 first call "
        f"{first_s:.3f} s launches={launches_batch}")
    log(f"phase5 nlZ[:, -1]={[round(v, 1) for v in rb.nlZ[:, -1].tolist()]} "
        f"snr_gaps_db={[round(v, 2) for v in gres.snr_gaps.tolist()]} (synthetic signals)")
    if launches_batch != want:
        raise AssertionError(f"launch counts {launches_batch} != {want}: the batched path "
                             f"missed a kernel")
    if rb.Eft.device.type != "cuda":
        raise AssertionError("fill_gaps_batch did not run on the card")
    check_posterior("phase5", rb.nlZ, rb.Eft, rb.Varft, (BF_c, T_c, C_c))
    if not (bool(torch.isfinite(gres.rmse_gaps).all()) and gres.y_hat.shape == (BF_c, T_c)):
        raise AssertionError("phase5: non-finite gap metrics")
    cfg_c = EPConfig(ep_itts=EP_ITTS, backend="fused", **CORPUS_KW)
    one_file = lambda b: ep_infer(cmodel, cparamsB.select(b), torch.where(
        cmaskB[b], cyB[b], torch.full_like(cyB[b], float("nan"))), cmaskB[b], cfg_c)
    for b in (0, BF_c - 1):
        r1 = one_file(b)
        _, rel = max_err([rb.Eft[b], rb.Varft[b], rb.nlZ[b]], [r1.Eft, r1.Varft, r1.nlZ])
        same = all(torch.equal(a, c) for a, c in zip((rb.Eft[b], rb.Varft[b]), (r1.Eft, r1.Varft)))
        log(f"phase5 file {b}: batch vs single-file ep_infer max_rel_err={rel:.3e} (tol "
            f"{TOL_F32:g}); same bits: {same} (chunk "
            f"{fk.chunk_length(T_c, BF_c * C_c)} in the batch, {fk.chunk_length(T_c, C_c)} alone)")
        if not rel <= TOL_F32:
            raise AssertionError(f"phase5: file {b} of the batch disagrees with ep_infer")
    del gres, rb, r1
    batch_runs = [host_s(run_batch)[1] for _ in range(3)]
    serial_runs = [host_s(lambda: [one_file(b) for b in range(BF_c)])[1] for _ in range(2)]
    batch_s, serial_s = float(np.mean(batch_runs)), float(np.mean(serial_runs))
    log(f"phase5 s per batch call={batch_s:.3f} (runs {[round(r, 3) for r in batch_runs]}), "
        f"per file={batch_s / BF_c:.3f}; the ten files one by one through ep_infer="
        f"{serial_s:.3f} s (runs {[round(r, 3) for r in serial_runs]}); "
        f"one-by-one / batch = {serial_s / batch_s:.2f} on {smi}")
    kern, _ = adf_mb_case(cmodel, cparamsB, cyB, cmaskB, 0)
    batch["ms"] = cuda_ms(kern, 3)
    observed = int(cmaskB.sum().item())
    bs_c = cmodel.build_ssm_batch(cparamsB).block_size
    batch["bound"] = bound_adf(T_c, BF_c, cmodel.D, cmodel.N, 77, bs_c, observed)
    log(f"phase5 K4 alone at BF={BF_c} T={T_c}: {batch['ms']:.1f} ms "
        f"({1e3 * batch['ms'] / T_c:.2f} us/step, {observed} observed (file, step) pairs)")
    C_w = BF_c * C_c
    wide = kalman_path_checks("phase5 f32", flatten_files(cmodel.build_ssm_batch(cparamsB)),
                              random_sites(T_c, C_w, seed=5), T_KERNEL, TOL_F32)
    wide["fused_fwd"]["bound"] = bound_fwd(T_c, C_w, bs_c)
    wide["fused_bwd"]["bound"] = bound_bwd(T_c, C_w, bs_c)
    del kern

    # ---- phase 6: the mixture path at full width -------------------------------
    models, plist, y_mix, parts = mixture_inputs(torch.float32, dev, T_MIX)
    run_mix = lambda: separate(models, plist, y_mix, engine="ep", true_sources=parts,
                               generator=torch.Generator(device=dev).manual_seed(0),
                               n_samples=20, mixture_lik=MIX_LIK, **MIX_KW)
    fk.reset_launches()
    sres, mix_s = host_s(run_mix)
    launches_mix = counts()
    rm = sres.result
    log(f"phase6 separate J=3 D={jm.D} N={jm.N} S={S_mix} T={T_MIX} f32: {mix_s:.3f} s "
        f"launches={launches_mix} nlZ={rm.nlZ.tolist()} "
        f"snr_db={[round(v, 2) for v in sres.snr.tolist()]} (synthetic mixture, not asserted)")
    if launches_mix != want:
        raise AssertionError(f"launch counts {launches_mix} != {want}: the mixture path "
                             f"missed a kernel")
    check_posterior("phase6", rm.nlZ, rm.Eft, rm.Varft, (T_MIX, jm.D + jm.N))
    if not (bool(torch.isfinite(sres.sources).all()) and sres.sources.shape == (T_MIX, 3)
            and rm.sites.ttau.shape == (1, T_MIX, jm.D + jm.N)):
        raise AssertionError("phase6: non-finite sources or unexpected shapes")
    jm, jp, _ = mixture.join_models(models, plist, lik=MIX_LIK)
    jpB = stack_params([jp])
    kern, _ = adf_mb_case(jm, jpB, y_mix[None], torch.ones_like(y_mix[None]) > 0, 256)
    mix["ms"] = cuda_ms(kern, 1)
    bs_m = jm.build_ssm(jp).block_size
    mix["bound"] = bound_adf(T_MIX, 1, jm.D, jm.N, S_mix, bs_m, T_MIX)
    cfg_m = EPConfig(**MIX_KW)
    all_seen = torch.ones(T_MIX, dtype=torch.bool, device=dev)
    _, resite_s = host_s(lambda: ep_mod._ep_resite(
        jm, jp, cfg_m, y_mix, all_seen, rm.Eft, rm.Varft,
        Sites(rm.sites.ttau[0], rm.sites.tnu[0]), cfg_m.damp(1)))
    log(f"phase6 K4 alone at mixture width: {mix['ms']:.1f} ms for T={T_MIX} = "
        f"{mix['ms'] / T_MIX:.4f} ms/step (T=96 000 would take {96.0 * mix['ms'] / T_MIX:.1f} s); "
        f"one re-site of all T (moment_chunk=64): {resite_s:.3f} s")
    C_m = jm.D + jm.N
    wide_m = kalman_path_checks("phase6 f32", flatten_files(jm.build_ssm_batch(jpB)),
                                random_sites(T_MIX, C_m, seed=6), T_KERNEL, TOL_F32)
    wide_m["fused_fwd"]["bound"] = bound_fwd(T_MIX, C_m, bs_m)
    wide_m["fused_bwd"]["bound"] = bound_bwd(T_MIX, C_m, bs_m)
    del sres, rm, kern
    m64, p64, y64m, parts64 = mixture_inputs(torch.float64, dev, T_MIX_F64)
    sep64 = lambda device: separate(m64, p64, y64m, engine="ep", true_sources=parts64,
                                    n_samples=0, mixture_lik=MIX_LIK, device=device, **MIX_KW)
    s_gpu = sep64(None)
    s_cpu, cpu_s = host_s(lambda: sep64("cpu"))
    err_abs, err_rel = max_err(
        [s_gpu.sources.cpu(), s_gpu.result.Eft.cpu(), s_gpu.result.Varft.cpu(),
         s_gpu.result.nlZ.cpu()],
        [s_cpu.sources, s_cpu.result.Eft, s_cpu.result.Varft, s_cpu.result.nlZ])
    log(f"phase6 separate T={T_MIX_F64} f64: card vs cpu max_abs_err={err_abs:.3e} "
        f"max_rel_err={err_rel:.3e} (tol {TOL_REAL:g}) cpu_plain_s={cpu_s:.1f}")
    if not err_rel <= TOL_REAL:
        raise AssertionError("mixture EP on the card disagrees with the CPU")
    log(f"phases 0-6 done at {time.perf_counter() - t_start:.0f} s")

    # ---- phase 7: the training path -----------------------------------------------
    training = training_phase(smi, dev)

    # ---- phase 8: the IHGP path -----------------------------------------------------
    ihgp_numbers = ihgp_phase(smi, dev)

    # ---- phase 9: the denoising path ------------------------------------------------
    denoise_numbers = denoise_phase(smi, dev)

    # ---- phase 10: the experiment drivers -------------------------------------------
    exp_numbers = experiments_phase(smi, dev, batch_s)
    launches_exp = exp_numbers["launches"]

    # ---- phase 11: the device mesh --------------------------------------------------
    mesh_numbers = mesh_phase(smi)
    log(f"all phases done at {time.perf_counter() - t_start:.0f} s")

    # ---- the kernels line --------------------------------------------------------
    # One entry per kernel at its main path's shape: K1-K3 the single-signal
    # path (phase 2), K4 the batched path (phase 5), K5 and K6 the IHGP path
    # (phase 8: timed at the headline shape, `launches` from 8c's ihgp-seq
    # call at T=16 000, `launches_by_path` every IHGP call of phase 8, K5's
    # `max_abs_err` its float64 check, `checks` all of them).  `launches` is
    # that run's count; K1-K4's `launches_by_path` has all four paths (phase
    # 10's corpus grid as "experiments").  `plain_ms` is the plain
    # version over `plain_steps` steps (it is a Python loop over T: for K1
    # the first, for K2 the last `plain_steps` rows of the kernel's run over
    # all T, so `max_abs_err` is of the launch that `chunk` and `chunks`
    # describe; `one_chunk_max_abs_err` is over all T against the same kernel
    # as one sequential chunk); `other_shapes` holds the same numbers where
    # another path runs the kernel at another shape.  K7 is the training
    # path's (phase 7b: one value and gradient at T=16 000, its `ms` K7 alone
    # on that run's inputs, `max_abs_err` and `plain_ms` 7a's float32 check
    # with lZ's cotangent over `plain_steps`, every 7a check in `checks`).  K8 is
    # the IHGP path's (phase 8f: one value and gradient of ihgp_energy at T=16 000,
    # its `ms` K8 alone on that run's inputs, `max_abs_err` and `plain_ms` the
    # float32 check over `plain_steps`, its registers and spills from the build's
    # ptxas log in `ptxas`).  No single PyTorch call computes a T-long
    # data-dependent recursion, so `library_ms` is null throughout.
    def numbers(nums, shape, **more):
        nums = dict(nums)
        bound_ms, bound_by = nums.pop("bound")
        return dict(shape=shape, bound_ms=bound_ms, bound_by=bound_by, **nums, **more)

    def entry(name, nums, shape, path_launches, other=None, **more):
        replaces, source = KERNELS[name]
        e = dict(name=name, route="cuda", source=f"nsgp_tpu_torch/csrc/{source}",
                 replaces=replaces, launches=path_launches[name], library_ms=None,
                 **numbers(nums, shape, **more),
                 launches_by_path={"single": launches_single[name],
                                   "batch": launches_batch[name],
                                   "mixture": launches_mix[name],
                                   "experiments": launches_exp[name],
                                   "mesh": [r[name] for r in mesh_numbers["launches_by_rank"]]})
        if other:
            e["other_shapes"] = other
        return e

    s_shape = f"T={T_MAIN} C={D + N} bs=4 f32"
    w_shape = f"T={T_c} C={C_w} bs={bs_c} f32"
    m_shape = f"T={T_MIX} C={C_m} bs={bs_m} f32"
    kernels = [
        entry(name, single[name], s_shape, launches_single,
              [numbers(wide[name], w_shape), numbers(wide_m[name], m_shape)])
        for name in ("fused_fwd", "fused_bwd")
    ] + [
        entry("fused_adf", single["fused_adf"], f"T={T_MAIN} D={D} N={N} S=77 bs=4 f32",
              launches_single, plain_steps=T_PLAIN, **fk.adf_launch_shape(77)),
        entry("fused_adf_mb", batch,
              f"T={T_c} BF={BF_c} D={cmodel.D} N={cmodel.N} S=77 bs={bs_c} f32", launches_batch,
              [numbers(mix, f"T={T_MIX} BF=1 D={jm.D} N={jm.N} S={S_mix} s_chunk=256 bs={bs_m} "
                            f"f32", plain_steps=T_MIX_KERNEL, **fk.adf_launch_shape(S_mix))],
              plain_steps=T_KERNEL, **fk.adf_launch_shape(77)),
    ]
    ih_kern, ih_launches = ihgp_numbers["kernels"], ihgp_numbers["ihgp_launches"]
    pick = ("ms", "plain_ms", "plain_steps", "max_abs_err", "bound", "threads", "cluster")

    def ihgp_entry(name, shape, other=None):
        replaces, source = KERNELS[name]
        nums = ih_kern[name]
        e = dict(name=name, route="cuda", source=f"nsgp_tpu_torch/csrc/{source}",
                 replaces=replaces, launches=ih_launches["seq_16000"][name], library_ms=None,
                 **numbers({k: v for k, v in nums.items() if k in pick}, shape),
                 launches_by_path={path: c[name] for path, c in ih_launches.items()},
                 checks={k: v for k, v in nums.items() if k not in pick and k != "mixture"})
        if other:
            e["other_shapes"] = other
        return e

    mix5 = ih_kern["fused_ihgp_adf"]["mixture"]
    kernels += [
        ihgp_entry("fused_ihgp_adf", f"T={T_MAIN} D={D} N={N} S=77 bs=4 G=200 f32",
                   [numbers({k: v for k, v in mix5.items() if k != "shape"}, mix5["shape"])]),
        ihgp_entry("fused_ihgp_smooth", f"T={T_MAIN} C={D + N} bs=4 G=200 f32"),
    ]
    vjp = training["fused_adf_vjp"]
    replaces, source = KERNELS["fused_adf_vjp"]
    kernels.append(dict(
        name="fused_adf_vjp", route="cuda", source=f"nsgp_tpu_torch/csrc/{source}",
        replaces=replaces, launches=vjp["launches"], library_ms=None,
        **numbers({k: vjp[k] for k in ("ms", "plain_ms", "plain_steps", "max_abs_err", "bound")},
                  vjp["shape"]),
        launches_by_path={"training": vjp["launches"],
                          "training_fit_3_steps": training["fit"]["launches"]["fused_adf_vjp"],
                          "single": launches_single["fused_adf_vjp"],
                          "batch": launches_batch["fused_adf_vjp"],
                          "mixture": launches_mix["fused_adf_vjp"],
                          "experiments": launches_exp["fused_adf_vjp"],
                          "mesh": [r["fused_adf_vjp"] for r in mesh_numbers["launches_by_rank"]]},
        checks=vjp["checks"], threads=fk.adf_launch_shape(77)["threads"], cluster=1))
    k8 = ih_kern["fused_ihgp_adf_vjp"]
    replaces, source = KERNELS["fused_ihgp_adf_vjp"]
    kernels.append(dict(
        name="fused_ihgp_adf_vjp", route="cuda", source=f"nsgp_tpu_torch/csrc/{source}",
        replaces=replaces, launches=ih_launches["energy_16000"]["fused_ihgp_adf_vjp"],
        library_ms=None,
        **numbers({k: k8[k] for k in ("ms", "plain_ms", "plain_steps", "max_abs_err",
                                      "max_rel_err", "bound")}, k8["shape"]),
        launches_by_path={path: c["fused_ihgp_adf_vjp"] for path, c in ih_launches.items()},
        checks=k8["checks"], ptxas=k8["ptxas"], threads=k8["threads"], cluster=k8["cluster"]))
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"ihgp": ihgp_numbers}), flush=True)
    print(json.dumps({"denoise": denoise_numbers}), flush=True)
    print(json.dumps({"experiments": exp_numbers}), flush=True)
    print(json.dumps({"mesh": mesh_numbers}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any failed phase: report, no result line
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
