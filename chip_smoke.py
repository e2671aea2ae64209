"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's paths at two sizes. The flagship: SKA-LOW (512 stations
within 40 km), 76 integrations at 120 MHz (~9.9M visibilities), a 1024^2
image, "T" phase-only calibration, CLEAN niter 300, gain 0.2, fractional
threshold 0.01. The MSMFS cube (the JAX package's BASELINE config 4,
``bench_msmfs_pipeline.py``): 256 stations within 2 km in the JAX test
layout, 9 hour angles over +-pi/12 at dec -35 deg, 64 channels of 1 MHz
from 100 MHz (18,800,640 visibilities), a 256^2 cube at oversampling 3,
uniform weights, one 2.0 Jy source at (+20, -14) pixels with spectral
index -0.7 about channel 32, MSMFS with 3 moments, niter 100, fractional
threshold 0.01.

Phases, each on lines of its own:
  1. device: the card's name and power limit;
  2. build: compiles the CUDA kernels from csrc/ (one nvcc per source, in
     parallel) and times the build;
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the main path's geometry, with both times, the kernel's bound
     (the least time the card could take for the same work) and, where one
     PyTorch call computes the same function, that call's time; the
     windowed Hogbom is checked against its plain version too, and each
     Hogbom kernel prints its iterations, microseconds an iteration and
     the per-iteration streaming figure; msclean and msmfs are held bit for
     bit in rows, residual stack and the component image or moment model
     they build themselves (against the plain rows' rebuild), and print
     microseconds per used iteration beside their per-iteration footprint
     reads and the barrier floor of their loop. The grid and degrid kernels'
     rows are the full flagship stream (9,942,016 entries), held against
     their plain versions in pieces of 1M entries (grid's accumulated in
     f64); a 1M-entry subset is held too. The permute row moves values
     from plan to natural order as the main path does, a gather through
     the plan's inverse permutation, timed beside the same move as a
     scatter;
  4. Hogbom ical: simulates the observation on the card, corrupts it with
     N(0, 0.4) phases, runs ``ical(algorithm="hogbom")`` with the launch
     counters reset, and prints per-cycle wall time and peak residual,
     the gain error and each cycle's CLEAN iterations;
  5. msclean ical: the same observation through ``ical`` with its default
     deconvolver, msclean (scales 0, 3, 10, 30), 4 major cycles, one
     msclean launch per CLEAN call; also the model flux around each
     source;
  6. deconvolve_cube: a stokesIQUV cube made from the flagship dirty image
     and PSF, with one fractional polarisation (p 0.2, angle 30 deg, v
     0.02), through ``algorithm="hogbom-complex"``;
  7. small slice: ical on a small observation with the CUDA kernels and
     on the CPU (plain versions), for Hogbom and msclean (the latter to a
     fractional threshold of 0.05), held to the JAX package's
     fused-vs-composed bounds;
  8. MSMFS cube: simulates the config-4 cube on the card, holds the grid
     kernel on one channel's launch (the cube cycle's shape), the degrid
     kernel's one launch over the 64 channel plans against the
     per-channel plain version and the permute kernel's (plan to natural
     order, natural to plan order, and from one shared source) bit for bit,
     and (a) the
     msmfs kernel against its plain version on the cycle-0 moment stacks,
     and the Hogbom kernels (with and without the quarter window, and
     complex) on the 64 dirty channels as 64 lanes of 256^2;
     (b) runs ``continuum_imaging(algorithm="mmclean")`` for 4 major
     cycles, printing each cycle's wall time and peak residual, and gates
     the peak's fall, the model flux around the source in channel 32 and
     the spectral index from the channel-0 and channel-63 model fluxes;
     (c) runs ``ical(algorithm="mmclean")`` on the cube corrupted with
     N(0, 0.4) "T" phases, 4 cycles, and prints the gain phase error;
     (b) and (c) print their launches per kernel and fail if degrid ran
     more than once per (cycle with a model, polarisation) or permute more
     than twice per (cycle, polarisation) and once per polarisation for the
     workspace (the channel legs are batched), or msmfs other than once
     per CLEAN call;
     (d) runs ical with MSMFS on a small cube (the JAX package's fused-cube
     test geometry) on the card and on the CPU, to the bounds of phase 7;
  9. the epsilon contract on the flagship observation with natural weights
     and a 1.0 Jy source at 70% of the half-field, pixel (+360, +280) from
     the centre; each run is held to the exact DFT computed on the host in
     numpy f64 from the Visibility's own uvw. (a) the unit_tiles kernel
     against its plain version on the entry streams of the fast-f32 row
     (f32) and of the deep-f64 row (f64); (b) predict_visibility and
     invert_visibility at epsilon 1e-3 (the fast-f32 row: the tiled core
     path, unit_tiles); (c) at epsilon 1e-5 (the precise-f32 row: an
     eskernel plan from host-f64 coordinates, grid and degrid); (d) at
     epsilon 5e-7 on an f64 Visibility (the deep-f64 row: the tiled core
     path in f64); (e) both without a plan and without epsilon, twice
     each: the plan cache, against an explicit plan at padding 2.
 10. calibration (after phase 7 on the flagship and after phase 8 on the
     cube): (a) the flagship observation also corrupted by "G" gains in
     60 s bins (amplitude 1 + N(0, 0.05), phase N(0, 0.1)) through
     ``ical(calibration_context="TG")`` with msclean, fused and composed
     (``fused=False``), 4 cycles each, printing each cycle's wall time and
     peak residual, each term's StefCal time, the T*G phase and G
     amplitude errors against the truth, and holding the two paths to
     the JAX package's "TG" bounds (residual peaks 0.02, restored peaks
     0.05); (b) the config-4 cube corrupted by "T" phases N(0, 0.4) and a
     "B" table (phase N(0, 0.25), amplitude 1 + N(0, 0.1) per station and
     channel) through ``ical(algorithm="mmclean",
     calibration_context="TB")``, fused and composed: the spectral index
     within 0.15 of -0.7 on both, the B gains within 0.5 of the truth per
     channel and within 2e-2 between the paths, residual peaks within
     2e-2; (c) on the card and on the CPU, to the bounds of phase 7: the
     composed "TG" ical of phase 7's observation with the 2.0 Jy source
     given as a sky component, and the fused "TB" ical of the JAX
     package's bandpass test cube (4 channels, Hogbom to a fractional
     threshold of 0.2, where the picks are not near-ties); then, on the
     card, a second uninterrupted fused "TG" ical and a checkpoint resume
     (2 cycles saved, resumed to 4), each equal to the first run to 1e-6
     (K1 sums in fixed point, so the card's runs repeat bit for bit).
 11. polarisation and multi-frequency synthesis (after phase 10): (a) the
     flagship layout with linear visibilities (9,942,016 rows x 4
     polarisations) of the three sources at fractional Q and U, given as
     stokesIQUV components that seed the sky, a linear 1024^2 model, "T"
     phases N(0, 0.4) on both receptors, through ``ical`` with msclean,
     fused and composed, 3 cycles each: residual peak below 0.2, the
     restored XX at the sources within 0.2 of their I, each receptor's
     gain phases within 0.05 rad of the truth, the restored peaks of the
     two paths within 0.05 and their gains within 1e-4, and the fused
     cycle's launches (grid once a
     (cycle, polarisation) and once for the PSF, degrid once a (cycle with
     a model, polarisation), permute once a polarisation for the
     workspace and once a leg of a cycle); K4 with four payloads in one
     launch held bit for bit; (b) the same sky with 8% leakage and 5%
     amplitudes through a "matrix" "T" (amplitude and phase) with Hogbom,
     fused and composed: residual peaks within 1e-3 and gains within 1e-4
     of each other, the Mueller leg's time and the cycle's peak memory
     (below 12 GiB) printed, K5 held on the first CLEAN call's four lanes;
     (c) the config-4 cube's 64 channels imaged to one MFS channel of
     256^2: K1, K3 and K4 on the MFS plan's one row of 18,800,640 entries
     and K7 on the MFS dirty image against their plain versions, the MFS
     invert within 1e-5 of the sum of its channels' (same plan geometry),
     ``continuum_imaging`` and a "TB" ``ical`` with msclean, fused and
     composed, 3 cycles each, at the bounds of phases 7 and 10b; (d) a
     "matrix" "T" + "B" ical of the bandpass cube's layout in the linear
     frame imaged MFS, on the card and on the CPU, to phase 7's bounds.
 12. streamed self-cal over the native visibility store (after phase 9):
     (a) phase 4's "T"-corrupted flagship observation written to a store
     (its uniform imaging weights as the store's weights) through
     ``streamed_ical`` in 4 slabs of 19 integrations, and the in-memory
     fused ``ical`` on the Visibility read back whole from the store, 3
     cycles of Hogbom each: peak residuals within 0.02, restored peaks
     within 0.05, phase-referenced "T" gains within 5e-3 (JAX
     tests/test_io.py:120-132), each path's peak residual falling every
     cycle; (b) a store of 100,010,274 visibilities (the geometry of JAX
     bench_streamed.py: 274 stations, 2,674 integrations over hour angles
     +-pi/6, times in MJD seconds), generated a slab at a time into a
     temporary directory and removed at the end, streamed from disk every
     cycle (``cache_slabs=False``) in 14 slabs of 200 integrations over the
     f16 wire with uvw computed on the card from the geometry
     (``uvw_compute``, f64 times), 3 cycles of Hogbom on a 1024^2 image:
     each cycle's seconds, Mvis/s and seconds in ``store.wait``, the peak
     device memory; the restored peak within 0.2 of 2.0, the peak residual
     falling, each kernel's launches equal to their count from slabs and
     cycles (``scale_launches``), and 1 cycle in slabs of 100 integrations
     below the peak memory of 1 cycle in slabs of 200; (c) 1 cycle with the
     f32 wire and the store's uvw against 1 cycle of (b)'s settings:
     residual images within 5e-3 of their maximum, and the geometry's uvw
     within 1e-6 m of the store's; (d) the streamed path on phase 7's small
     observation on the card and on the CPU, to phase 7's bounds.
 13. the rest of the imaging and CLEAN API: (a) after phase 10a, phase
     4's Hogbom ical on plans at supports 6 and 12, K1 (two launches to the
     same bits) and K3 held on each plan against their plain versions
     first: the peak falls, the restored peak within 0.2 of 2.0; (b) in
     phase 9, its f32 observation on a nearest-plane plan of 128 w-planes,
     K1 and K3 held on it: the predict within 1e-2 of the exact DFT and
     above the error of a linear plan of 64 planes, the dirty peak on the
     source; (c) after (a), the flagship's uniform and robust (-2, 0, 2)
     weights and both tapers with weights 1 + N(0, 0.1), on the card and
     on the CPU to 1e-6, two card runs of the robust weights to the same
     bits, and the PSF's peak sidelobe for uniform, robust and natural
     weights; (d) in phase 8, deconvolve_list over the cube's 64 channel
     images with hogbom, msclean and mmclean equal to deconvolve_cube bit
     for bit, restore_list to restore_cube, and, in (a), the support-12
     dirty image through image_raster_iter and image_gather_facets (4
     facets, overlap 16, tukey) back to 1e-6 of its maximum; (e) after
     (c), phase 7's small msclean slice (fractional threshold 0.05) at
     support 6, and its observation imaged and predicted on a
     nearest-plane plan, card against CPU (phase 7's bounds; 1e-5 of the
     maxima). The script prints K1 and K3 at each
     support and plane mode with time, bound and plain time.
 14. the parallel layer (after phase 13e): (a) phase 5's msclean flagship
     ical (4 cycles) through ``parallel.sharded_ical`` on 4 baseline
     shards of the card in an NCCL group of one process, twice (equal bit
     for bit), against the single-device fused ical at the JAX package's
     sharded bounds (phase-referenced gains 1e-4, peak residuals 1e-2,
     restored peaks 0.05), with each run's steady cycles beside the
     single-device ones, its collectives a cycle (one reduce-scatter of
     K1's int64 planes, at most 4 psums) and its peak memory; before the
     runs, K1's sharded route at the flagship's shapes: the weighted
     visibilities over 4 baseline-block shards, each gridded to int64
     planes at the global bound, their sum converted by grid_convert bit
     for bit as its plain version, within K1's tolerance of the whole
     stream's plain grids in f64; the runs must launch grid_convert; (b) phase
     8c's "T" MSMFS ical of the config-4 cube on 4 channel shards against
     the single-device cube ical (residual and model 2e-3, the spectral
     index within INDEX_TOL); (c) phase 7's small observation as two
     processes on the card, each owning 2 of the 4 shards, over gloo,
     equal bit for bit to one process of 4 shards (a child that fails or
     outlives 120 s fails the phase); (d) ``distributed_ical`` on phase
     7's observation over 4 shards (K9's tiled gridder, K5), card against
     CPU at phase 7's bounds.
 15. the imaging periphery (after phase 14) on a MID observation (197
     dishes, 128 hour angles, 4 channels from 1.4 GHz, 9,884,672
     visibilities, 1024^2): (a) ``invert_visibility(gridder="scatter")``
     and ``predict_visibility(gridder="gather")`` against the plan routes
     (K1, K3) to 1e-5 of the maximum (the invert before the grid
     correction), wall times, two runs equal bit for bit, a small slice
     card against CPU; (b) AW-projection: the JAX package's bounds (w = 0,
     the default pair: predict 0.05 from the exact DFT, invert peak
     within 0.05 on the source), an awterm CF (nw 5, oversampling 8,
     support 8) built on the card with its time and memory, its grid and
     degrid timed, every route twice bit for bit, the CF card against CPU;
     (c) the visibility algebra in f64 card against CPU; (d) in phases 9
     and 14d: K9's f32 and f64 streams launched twice and
     ``distributed_ical`` run twice, equal bit for bit.
 16. supports past 16 and the sky-component periphery (after phase 14, on
     the flagship): (a) K1's and K3's wide variants at supports 17 and 24
     on the full flagship stream and 32, 33 and 64 on its first million
     entries, against their plain versions in pieces (1e-5), two
     launches to the same bits, with times and bounds; the Hogbom ical
     at support 24 restores the 2.0 Jy source within 0.2; (b) K9's wide
     variant at supports 7, 17, 24 and 32 in f32 and f64 on phase 9's
     observation cut to 8 integrations, against its plain version in f64
     (1e-5 and 1e-12), twice to the same bits; then its full-width path,
     ``invert_visibility(auto_plan=False, gridder="tiled", padding=2,
     nw=6)`` on phase 9's whole observation (19,884,032 entries) at
     support 24 (f32) and 32 (f64): K9 launched, the dirty peak on the
     source's pixel within 0.02 of 1.0, two calls to the same bits, and K9
     on that stream against its plain version in f64; (c) the sky model on the
     flagship's plan (``skymodel_predict_calibrate`` held to the DFT of
     the same sky, ``skymodel_calibrate_invert``; K3, K4 and K1 launch),
     find, fit and insert on 16a's restored image card against CPU,
     gaincal on the flagship, the sky-model functions and gaincal on
     phase 7's observation card against CPU, and a spectral component
     list (fluxes on 5 channels) through the fused ical of the config-4
     cube, its DFT card against CPU.
 17. tiles the imaging API never picks (after phase 16, on the flagship):
     the limit table of K1 and K9 (by window span and nacc or by support
     and dtype, from the library's route queries: the largest tile the
     narrow kernel and the cluster-banded routes take, and every tile
     taken; fails if any tile from the support up is refused); (a)
     ``make_grid_plan`` + ``grid_with_plan`` at support 8 on the
     flagship's linear plan at tiles 112 and 336 (in turns: the cluster's
     band rows printed beside the tile plus span) and its nearest plan at
     168, K1's wide variant launched, two calls to the same bits, against
     the plain version (1e-5) and the grids at the API's tile 56 (1e-5,
     and whether the bits are equal), with K1's time beside the narrow
     kernel's at 56; (b) ``tiled_grid`` on phase 16b's full-width stream
     in f32 at support 8, tiles 128 and 512 (in turns), and in f64 at
     support 16, tile 128: K9's wide variant, the same checks against its
     plain version and the API's tile 64 (1e-5 in f32, 1e-12 in f64).
 18. every support and tile the JAX package's gridders take (after phase
     17, on the flagship): (a) ``make_grid_plan`` + ``grid_with_plan`` on
     the flagship's whole plan at supports 48 and 64 with one tile the
     whole 1344^2 padded grid, past any cluster's bands: K1's route 4
     (sub-tiles of window corners over a cluster) launched, two calls to
     the same bits, against the grids at the API's tile and its plain
     version in f64 (1e-5), its time beside K1w's at the API's tile; (b)
     the same and ``degrid_with_plan`` on the flagship's first million
     entries at windows past 64 cells (supports 72 on tile 192, 97 on 448,
     128 on 1344), linear and nearest: K1's route 4 and K3's long-window
     kernel against their plain versions (1e-5), twice to the same bits,
     K1's f32 grids beside beta x 2^-24 (not gated); (c) ``tiled_grid``
     on phase 16b's full-width stream with one tile the whole 2048^2 grid
     at supports 48 and 64, f32 and f64,
     and (d) on tile 256 at supports 96, 128 and 1 on 16b's stream cut to
     8 integrations, at support 97 on tile 448 on the same integrations
     gridded at padding 1.25 (1344^2), and at support 384 on tile 512,
     whose window no cluster holds (route 4 in blocks of the held cells,
     windows clipped to each): K9's route 4 launched, twice to the same
     bits, against its plain version
     (1e-5 in f32, 1e-12 in f64; in (c) the plain version at the API's
     tile 64). Each prints its route, its launch geometry, its time and
     its bound and its time over it.
Each of phases 4-6, 8b-c, 9b-e, 10a-b, 11a-c, 12a-c, 13a-d, 14a, b, d,
15a, 16a-c, 17a-b and 18a-d resets the launch counters just before it and fails unless
every kernel of its path launched. The script then
prints the grid and unit_tiles launches of each observation, the kernels
JSON line (launches summed over those phases), the card line, and, last,
the ``{"ok": true, ...}`` line. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero before
printing any result.

Usage: python3 chip_smoke.py
       python3 chip_smoke.py --profile-streamed [--wire f32] [--store-uvw]
       python3 chip_smoke.py --repeat-selfcal N   (phase 10c's run N times)
       python3 chip_smoke.py --phase14-only       (the build and phase 14)
       python3 chip_smoke.py --phase15-only       (the build, phase 15 and
                                                   15d's repeats)
       python3 chip_smoke.py --phase16-only       (the build and phase 16)
       python3 chip_smoke.py --phase17-only       (the build and phase 17)
       python3 chip_smoke.py --phase18-only       (the build and phase 18)
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

# The CPU runs of the small slices are the reference the card is held to,
# and their clean picks between near-equal peaks: MKL's default code path
# depends on the host's CPU model and its thread count on the host's load,
# and their rounding moved the CPU run's picks (and the gains by 4e-2) on
# one host. Its conditional numerical reproducibility mode with a fixed
# thread count gives the same CPU results on every host. Both must be set
# before torch loads MKL.
os.environ.setdefault("MKL_CBWR", "COMPATIBLE")
os.environ.setdefault("MKL_DYNAMIC", "FALSE")

# kernel: (tolerance on the max error relative to the plain version's
# maximum, source, the TPU kernel it replaces). grid: held against the
# plain version accumulated in f64 (the kernel sums f32 register runs in
# int64 fixed point, and two launches must agree bit for bit); degrid: f32
# sums in another order; permute moves
# elements and must be bit-exact; hogbom and hogbom_complex: the same f32
# operations in the same order; msclean and msmfs: bit for bit in rows,
# residual and the kernel's component image or moment model.
KERNELS = {
    "grid": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/grid.cu",
        "ska_sdp_func_python_tpu/ops/gridding_fused.py:221",
    ),
    "degrid": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/degrid.cu",
        "ska_sdp_func_python_tpu/ops/gridding_fused.py:915",
    ),
    "permute": (
        0.0,
        "ska_sdp_func_python_torch/csrc/permute.cu",
        "ska_sdp_func_python_tpu/ops/permute_pallas.py:61",
    ),
    "hogbom": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/hogbom.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:165",
    ),
    "msclean": (
        0.0,
        "ska_sdp_func_python_torch/csrc/msclean.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:1024 (and :903)",
    ),
    "hogbom_complex": (
        1e-6,
        "ska_sdp_func_python_torch/csrc/hogbom.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:517 (and :433)",
    ),
    "msmfs": (
        0.0,
        "ska_sdp_func_python_torch/csrc/msmfs.cu",
        "ska_sdp_func_python_tpu/ops/cleaners.py:1562",
    ),
    # f32, against the plain version accumulated in f64 (the kernel sums in
    # int64 fixed point, a 128-bit pair in f64, and two launches must agree
    # bit for bit); the f64 kernel is held to 1e-12 (UNIT_TILES_F64_TOL)
    "unit_tiles": (
        1e-5,
        "ska_sdp_func_python_torch/csrc/unit_tiles.cu",
        "ska_sdp_func_python_tpu/ops/gridding_pallas.py:34",
    ),
    # K1's conversion of the int64 planes, launched alone on the sharded
    # invert (phase 14a): bit for bit against its plain version
    "grid_convert": (
        0.0,
        "ska_sdp_func_python_torch/csrc/grid.cu",
        "ska_sdp_func_python_tpu/ops/gridding_fused.py:221 (K1's last step)",
    ),
}
UNIT_TILES_F64_TOL = 1e-12
CLEAN = dict(niter=300, gain=0.2, fractional_threshold=0.01)
SCALES = [0, 3, 10, 30]
# source pixel offsets (dx, dy) from the centre at 1024^2, and fluxes (Jy)
SOURCES = [(0, 0, 2.0), (60, -40, 1.2), (-80, 30, 0.8)]
# polarisation of the deconvolve_cube sky: fraction, angle, circular
POL_P, POL_CHI, POL_V = 0.2, np.deg2rad(30.0), 0.02
# the MSMFS cube (config 4): layout, observation and CLEAN
CUBE = dict(nants=256, rmax=2000.0, ntimes=9, nchan=64, df=1e6, npixel=256,
            oversampling=3.0, offset=(20, -14), alpha=-0.7, weighting="uniform")
CUBE_CLEAN = dict(algorithm="mmclean", nmoment=3, niter=100,
                  fractional_threshold=0.01, scales=SCALES)
# the spectral-index gate: the JAX package's own fused cube cycle, run on the
# CPU on this layout at 48 stations and 16 channels of 4 MHz, recovers -0.835
# for the sky's -0.7 (and -0.703 at 128 stations, 8 channels), so the gate
# is 0.15, not 0.1
INDEX_TOL = 0.15
# the small cube of the JAX package's fused-cube test (test_composite.py)
SMALL_CUBE = dict(nants=14, rmax=300.0, ntimes=3, nchan=6, df=4e6, npixel=96,
                  oversampling=4.0, offset=(7, -4), alpha=-0.7, weighting="natural")

# phase 10: the corruptions (jones type, timeslice s, phase sigma rad,
# amplitude sigma) of the calibration runs; the JAX package's "TG"
# fused-vs-composed bounds (test_composite.py:497-505: residual peaks,
# restored peaks) and bandpass bound (test_bandpass.py:245-251: B gains,
# residual peaks); its bandpass test cube (test_bandpass.py:179-200)
G_TERM = ("G", 60.0, 0.1, 0.05)
B_TERM = ("B", 1e5, 0.25, 0.1)
TG_RESIDUAL_TOL, TG_RESTORED_TOL = 0.02, 0.05
TB_TOL = 2e-2
BANDPASS_CUBE = dict(nants=10, rmax=300.0, ntimes=3, nchan=4, df=1e6, npixel=64,
                     oversampling=4.0, offset=(7, -5), alpha=0.0, weighting="natural")

# phase 11: the polarised flagship's fractional Q and U (every source);
# the share of each source's flux given as the stokesIQUV components that
# seed the sky (with the PSF in the first polarisation only, CLEAN never
# models the second receptor, so the seed carries YY; CLEAN finds the rest
# of XX, 0.2 (I + Q) = 0.46 Jy at the brightest source, and must leave
# below a tenth of it); the full-Jones run's leakage, and the JAX package's
# bounds (test_composite.py:556-562, npol-4 diagonal: the restored peaks
# 0.05 apart, and the phase-referenced gains 1e-4 of its other
# fused-vs-composed tests; :820-823, full Jones: residual peaks 1e-3,
# gains 1e-4); the MFS image against the sum of its channels; the small
# npol-4 "matrix" "T" + "B" MFS slice (the bandpass cube's layout at the
# JAX test's 128^2, Hogbom to a fractional threshold of 0.2)
POL_FRAC_Q, POL_FRAC_U = 0.15, 0.075
SEED_FRACTION = 0.8
LEAK = 0.08
NPOL4_XX_RESIDUAL, NPOL4_RESTORED_TOL = 0.046, 0.05
JONES_RESIDUAL_TOL, JONES_GAIN_TOL = 1e-3, 1e-4
MFS_TOL = 1e-5
PEAK_MEMORY_GB = 12.0
SMALL_JONES = dict(BANDPASS_CUBE, npixel=128)

# NVIDIA H100 SXM published peaks at 700 W (HBM, and f32 and f64 outside
# the tensor cores), defined once in the port's roofline module
from ska_sdp_func_python_torch.utils.roofline import (  # noqa: E402
    H100_HBM_BYTES_PER_S as PEAK_BYTES_S,
    H100_PEAK_F32_FLOPS as PEAK_F32_S,
    H100_PEAK_F64_FLOPS as PEAK_F64_S,
)

# phase 9: the source's pixel offset (dx, dy) from the centre of the 1024^2
# image (70% of the half-field, the adversarial position of the JAX
# package's epsilon tests) and the three rows' epsilons
SOURCE9 = (360, 280)
EPS_FAST, EPS_PRECISE, EPS_DEEP = 1e-3, 1e-5, 5e-7

# phase 12: (a) the flagship streamed in slabs of 19 integrations and the
# JAX package's streamed-vs-in-memory bounds (tests/test_io.py:120-132:
# residual peaks, restored peaks, phase-referenced gains); (b) the 100M
# store (JAX bench_streamed.py:31-95: 274 stations within 2 km from
# random_array_xyz seed 11, 2,674 integrations over hour angles +-pi/6 at
# dec -35 deg, 120 MHz, a 2.0 Jy source at the phase centre), times in MJD
# seconds from an epoch, a 1024^2 image at cellsize 5e-5, slabs of 200
# integrations; the JAX package's 1B run restored 1.9936, so the bound is
# test_composite.py's 0.2; (c) the f16 wire's bound (JAX
# test_streaming_wide.py:344-365) and the geometry's uvw bound in metres
STREAM_CHUNK_A = 19
STREAM_RESIDUAL_TOL, STREAM_RESTORED_TOL, STREAM_GAIN_TOL = 0.02, 0.05, 5e-3
SIDEREAL_S = 86164.1
STREAMED = dict(nants=274, rmax=2000.0, seed=11, ntimes=2674, dec=np.deg2rad(-35.0),
                frequency=1.2e8, flux=2.0, epoch=5.2424e9, npixel=1024, cellsize=5e-5,
                chunk=200, nmajor=3)
STREAMED_PEAK_TOL = 0.2
WIRE_TOL, UVW_TOL = 5e-3, 1e-6

# phase 13: the supports of the flagship ical (the JAX plan path takes 1
# to 16); the facets of the round trip; the robustness values; the card's
# imaging weights against the CPU's (relative to the largest weight); the
# nearest plan's predict error bound (JAX tests/test_imaging.py:348) and
# its planes, twice the linear plan's as in that test (a nearest plane's w
# error at phase 9's source is about pi dw |n - 1|: 0.098 at the flagship's
# default 6 planes, 0.016 at 32, 0.0078 at 64, 0.0039 at 128); the radius
# (pixels) beyond which the PSF's peak sidelobe is taken
SUPPORTS13 = (6, 12)
FACETS13 = dict(facets=4, overlap=16, taper="tukey")
ROBUST13 = (-2.0, 0.0, 2.0)
WEIGHT_TOL, FACET_TOL, NEAREST_TOL = 1e-6, 1e-6, 1e-2
NEAREST_NW = 128
SIDELOBE_RADIUS = 8


# phase 14: the parallel layer on the one card. (a) the flagship over 4
# local shards (baseline) in an NCCL group of one process against the
# single-device fused ical, at JAX tests/test_parallel.py:150-164's bounds
# (phase-referenced gains 1e-4, peak residuals 1e-2, restored peaks 0.05);
# (b) the config-4 cube over 4 channel shards against the single-device
# cube ical (JAX :222-252: residual and model 2e-3); (c) phase 7's small
# observation as 2 processes x 2 shards over gloo (NCCL refuses two ranks
# on one device), bit for bit against 1 process x 4 shards; (d)
# distributed_ical on phase 7's observation over 4 shards, card against
# CPU at phase 7's bounds. A child process that fails, or outlives
# CHILD_TIMEOUT_S, fails the phase.
SHARDS14 = 4
SHARD_GAIN_TOL, SHARD_RESIDUAL_TOL, SHARD_RESTORED_TOL = 1e-4, 1e-2, 0.05
CUBE_SHARD_TOL = 2e-3
CHILD_TIMEOUT_S = 120

# phase 15: a MID observation (the JAX package's synthetic layout, 197
# dishes of 15 m out to 80 km) of full width: 128 hour angles in +-0.3
# rad at dec -35 deg, 4 channels of 10 MHz from 1.4 GHz (19,306 x 128 x 4
# = 9,884,672 visibilities), a 1024^2 image at advise_wide_field's
# cellsize; two sources (pixel offsets from the centre of a 1024^2 image,
# scaled to smaller ones; Jy); the direct
# routes held to the plan routes (K1, K3) at 1e-5 of the maximum and to
# themselves bit for bit; the AW-projection bounds of the JAX package's
# tests (tests/test_periphery.py:135-181) and its CF (nw 5, oversampling
# 8, support 8)
MID15 = dict(ntimes=128, nchan=4, npixel=1024)
SOURCES15 = [(300, 200, 1.0), (-250, -150, 0.5)]
# 15b: one source at the offset of the JAX AW-projection test's, (+10, -6)
# pixels of 256^2, scaled to 1024^2 (the AW path grids at image resolution,
# unpadded, so the PSWF's taper error grows towards the field's edge)
SOURCE15B = [(40, -24, 1.0)]
DIRECT_TOL = 1e-5
AW_TOL = 0.05
AW_CF = dict(nw=5, oversampling=8, support=8)
# 15c: the f64 visibility algebra, card against CPU (the port's f64 parity
# tolerance)
ALGEBRA_TOL = 1e-10

# phase 16: (a) K1 and K3 at supports past 16 (the JAX plan path takes
# every support up to the tile, 64 at the flagship) on the flagship's plan,
# (support, the full stream: else its first million entries); the Hogbom
# ical at ICAL16; (b) K9 at odd and wide supports on phase 9's observation
# cut to UNIT16_TIMES integrations, on UNIT16_NW linear planes; (c) the spectral components' DFT
# card against CPU (f32 phases: frac_dot_turns rounds alike on both), the
# flagship sky model's predict against the DFT of the same sky (the plan
# path's 1e-3-class gridding error at support 8: the same bound as phase
# 9's predict at EPS_FAST) and gaincal's corrected visibilities against
# the uncorrupted ones (StefCal to 1e-6, f32)
SUPPORTS16 = ((17, True), (24, True), (32, True), (33, True), (48, False), (64, False))
# the ical at ICAL16 plans at padding 2: at the default 1.25 (npad 1344)
# the grid correction divides the image corners by 5.8e-8 at support 24,
# which lifts the f32 grid's rounding there above the sky (in the JAX
# package's formulas too, whose pipelines fix 1.25) and the self-cal
# diverges (restored 2.98 on an NVIDIA H100 80GB HBM3 at 700 W); at 2 the
# corners' divisor is 0.026
ICAL16 = 24
ICAL16_PADDING = 2.0
UNIT16 = (7, 17, 24, 32)
UNIT16_TIMES, UNIT16_NW = 8, 6
# 16b's full-width path: the tiled core path's invert on phase 9's whole
# observation at these supports, its dirty peak within this of the 1.0 Jy
# source
UNIT16_FULL = {"f32": 24, "f64": 32}
UNIT16_PEAK_TOL = 0.02
DFT16_TOL = 1e-5
SKYMODEL16_TOL = EPS_FAST
GAINCAL16_TOL = 1e-3

# phase 17: tiles the imaging API never picks (it picks 56 at the
# flagship's npad 1344 and 64 at the epsilon observation's 2048), which
# the JAX package takes wherever they divide the grid. (a) K1 on the
# flagship's plan at support 8: (tile, nearest plane), linear at 112 and
# 336 (served in turns) and nearest at 168; (b) K9 on phase 16b's
# full-width stream: (real dtype, support, tiles). Each is held to its
# plain version and to the grids at the API's tile, to K1's and K9's
# tolerances. LIMIT17_MAX: the largest tile the limit table looks at.
TILES17 = ((112, False), (336, False), (168, True))
UNIT17 = (("f32", 8, (128, 512)), ("f64", 16, (128,)))
LIMIT17_MAX = 4096

# phase 18: every support and tile the JAX package's gridders take. (a) K1
# on the flagship's whole plan at the supports of SUPPORTS18 with one tile
# the whole padded grid (TILE18), where no cluster's bands hold one
# window's rows; (b) K1 and K3 on the flagship's first million entries at
# windows past 64 cells, (support, tile), on linear and nearest planes;
# (c) K9 on phase 16b's full-width stream with one tile its whole 2048^2
# grid at the supports of UNIT18_FULL, (d) at the (support, tile, padding)
# of UNIT18 (past 64, and 1; 97 on tile 448, a tile no power of two, of the
# 1344^2 grid that padding 1.25 gives; 384 on tile 512, whose window and
# halo no cluster holds, so that route 4 serves the held cells in blocks,
# windows clipped to each), on 16b's stream cut to UNIT16_TIMES
# integrations; both in f32 and f64. Each is held
# to its plain version at K1's, K3's and K9's tolerances.
SUPPORTS18 = (48, 64)
TILE18 = 1344
WIDE18 = ((72, 192), (97, 448), (128, 1344))
UNIT18_FULL = (48, 64)
UNIT18_TILE_FULL = 2048
UNIT18 = ((96, 256, 2.0), (128, 256, 2.0), (1, 256, 2.0), (97, 448, 1.25),
          (384, 512, 2.0))


def say(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU model, which the small slices' CPU runs depend on."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return "unknown CPU"


def timed(fn, reps):
    """Mean device time of ``fn`` in ms over ``reps`` runs (CUDA events),
    after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def launch_events(names):
    """Times each launch of the kernels ``names`` with CUDA events on the
    current stream while the block runs; yields {name: [ms, ...]}, filled
    in launch order when the block ends (after a synchronise)."""
    import torch

    from ska_sdp_func_python_torch import kernels

    marks = {n: [] for n in names}
    for n in names:
        k = kernels.KERNELS[n]

        def launch(*args, _launch=k.launch, _marks=marks[n]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _launch(*args)
            end.record()
            _marks.append((start, end))

        k.launch = launch
    times = {n: [] for n in names}
    try:
        yield times
    finally:
        for n in names:
            del kernels.KERNELS[n].launch
        torch.cuda.synchronize()
        for n in names:
            times[n].extend(s.elapsed_time(e) for s, e in marks[n])


def bound(nbytes, nops, peak_ops=PEAK_F32_S):
    """(ms, what bounds it): the larger of the bytes over the card's memory
    rate and the operations over the card's peak rate for their type (f32
    by default)."""
    tb, to = nbytes / PEAK_BYTES_S * 1e3, nops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def footprint_area(y, x, ny, nx, py, px):
    """Pixels of a PSF footprint centred on (y, x), clipped to the image."""
    cy, cx = py // 2, px // 2
    h = min(ny, y - cy + py) - max(0, y - cy)
    w = min(nx, x - cx + px) - max(0, x - cx)
    return max(h, 0) * max(w, 0)


def simulate(device, rmax, ntimes, npixel, seed=42):
    """The flagship observation on ``device``: three point sources
    (2.0, 1.2, 0.8 Jy), per-station "T" phases from N(0, 0.4), uniform
    imaging weights (natural weighting of this core-heavy array gives a
    PSF whose sidelobes reach 0.99, on which Hogbom diverges)."""
    import torch

    from ska_sdp_func_python_torch.models import (
        SkyComponents,
        create_gaintable_from_visibility,
        create_named_configuration,
        create_visibility,
    )
    from ska_sdp_func_python_torch.ops import (
        apply_gaintable,
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch.ops.weighting import weight_visibility

    rng = np.random.default_rng(seed)
    cfg = create_named_configuration("LOW", rmax=rmax)
    vis = create_visibility(
        cfg, np.linspace(-0.3, 0.3, ntimes), [1.2e8],
        elevation_limit=np.deg2rad(15.0), device=device,
    )
    model = create_image_from_visibility(
        vis, npixel=npixel, oversampling=3.0, nchan=1
    )
    dirs, fluxes = [], []
    scale = npixel / 1024
    for dx, dy, f in SOURCES:
        ra, dec = model.pixel_to_radec(
            npixel // 2 + int(dx * scale), npixel // 2 + int(dy * scale)
        )
        dirs.append([float(ra), float(dec)])
        fluxes.append([[f]])
    sky = SkyComponents.from_lists(
        dirs, np.asarray(fluxes), vis.frequency, device=device
    )
    vis = dft_skycomponent_visibility(vis, sky)
    gt = create_gaintable_from_visibility(vis, jones_type="T")
    phases = rng.normal(0, 0.4, gt.gain.shape[:3])
    true_gain = torch.polar(
        torch.ones(phases.shape), torch.as_tensor(phases, dtype=torch.float32)
    ).to(device)
    gt = gt.replace(gain=true_gain[..., None, None].contiguous())
    corrupted = weight_visibility(
        apply_gaintable(vis, gt), model, weighting="uniform"
    )
    return cfg, corrupted, model, phases


def simulate_cube(device, nants, rmax, ntimes, nchan, df, npixel, oversampling,
                  offset, alpha, weighting, flux=2.0, seed=42):
    """A cube observation in the JAX package's test layout
    (``tests/simul.py``: ``random_array_xyz``, hour angles over +-pi/12,
    dec -35 deg), channels of ``df`` from 100 MHz, and one source of
    ``flux`` Jy at channel nchan // 2 with spectral index ``alpha``, at
    pixel offset ``offset`` (dx, dy) from the centre. Returns (vis,
    model)."""
    from ska_sdp_func_python_torch.models import (
        SkyComponents,
        create_visibility_from_arrays,
        random_array_xyz,
    )
    from ska_sdp_func_python_torch.ops import (
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch.ops.weighting import weight_visibility
    from ska_sdp_func_python_torch.utils.coordinates import xyz_to_uvw

    ants = random_array_xyz(nants, rmax=rmax, seed=seed)
    a1, a2 = np.triu_indices(nants, 1)
    hour_angles = np.linspace(-np.pi / 12.0, np.pi / 12.0, ntimes)
    dec = np.deg2rad(-35.0)
    uvw = np.stack([xyz_to_uvw(ants[a2] - ants[a1], ha, dec) for ha in hour_angles])
    freq = 1.0e8 + df * np.arange(nchan)
    vis = create_visibility_from_arrays(
        uvw=uvw, time=hour_angles * 86164.1 / (2 * np.pi), frequency=freq,
        antenna1=a1, antenna2=a2, phasecentre=(0.0, dec), nants=nants,
        device=device,
    )
    model = create_image_from_visibility(
        vis, npixel=npixel, oversampling=oversampling, nchan=nchan
    )
    ra, dec_s = model.pixel_to_radec(npixel // 2 + offset[0], npixel // 2 + offset[1])
    fluxes = flux * (freq / freq[nchan // 2]) ** alpha
    sky = SkyComponents.from_lists(
        [[float(ra), float(dec_s)]], fluxes[None, :, None], vis.frequency,
        device=device,
    )
    vis = dft_skycomponent_visibility(vis, sky)
    return weight_visibility(vis, model, weighting=weighting), model


def corrupt(vis, sigma, seed=42):
    """``vis`` times per-station "T" phases from N(0, sigma); returns
    (corrupted vis, true phases [ntime, nants, 1])."""
    import torch

    from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
    from ska_sdp_func_python_torch.ops import apply_gaintable

    gt = create_gaintable_from_visibility(vis, jones_type="T")
    phases = np.random.default_rng(seed).normal(0, sigma, gt.gain.shape[:3])
    true_gain = torch.polar(
        torch.ones(phases.shape), torch.as_tensor(phases, dtype=torch.float32)
    ).to(vis.device)
    gt = gt.replace(gain=true_gain[..., None, None].contiguous())
    return apply_gaintable(vis, gt), phases


def gain_phase_error(solved, true_phases):
    """Max and rms phase error (rad) of the solved gains against the true
    phases, both referenced to station 0."""
    g = solved.detach().cpu().numpy()[..., 0, 0, 0]
    ref = np.angle(g * np.conj(g[:, :1]))
    tru = true_phases[..., 0] - true_phases[:, :1, 0]
    err = np.angle(np.exp(1j * (ref - tru)))
    return float(np.max(np.abs(err))), float(np.sqrt(np.mean(err**2)))


def _row(err, rel, ms, plain_ms, bnd, library_ms=None):
    return dict(
        max_abs_err=err, rel=rel, ms=ms, plain_ms=plain_ms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms,
    )


def _plain_piece(gp):
    """Entries of one piece of the plain versions in pieces: 1M up to a
    window of 16 cells, fewer past it, so that a piece's [n, S, S] f64
    windows stay near 2 GB."""
    return 1 << 20 if gp.span <= 16 else (1 << 27) // gp.span**2


def grid_plain_pieces(gp, vals, piece=1 << 20):
    """grid_plain of plan ``gp`` over pieces of ``piece`` entries, summed:
    the plain version at the full stream within the card's memory."""
    import dataclasses

    from ska_sdp_func_python_torch.ops.gridding_fused import grid_plain

    out = None
    for a in range(0, gp.n_in, piece):
        b = min(a + piece, gp.n_in)
        sub = dataclasses.replace(
            gp, iu0=gp.iu0[a:b], iv0=gp.iv0[a:b], plane=gp.plane[a:b],
            frac=gp.frac[a:b], ku=gp.ku[a:b], kv=gp.kv[a:b], n=b - a, n_in=b - a,
        )
        g = grid_plain(sub, vals[a:b])
        out = g if out is None else out.add_(g)
    return out


def grid_bound(gp):
    """K1's bound on plan ``gp``: per entry its value, corner and 2 x S
    taps in (S the plan's span), and its plane fraction on a linear plan
    (what gridding needs: not the kernel's walk order, chunk table or the
    taps' zero padding) and the grids out; the separable work, as
    degrid_bound counts it: on each plane it adds to (two on a linear
    plan) the value scaled by each of S column taps, then per cell of the
    S x S window a complex scale by its row tap and add."""
    planes = 2 if gp.wstacked else 1
    per_entry = 8 + 4 + 4 + 2 * 4 * gp.span + (4 if gp.wstacked else 0)
    grids_bytes = gp.nplanes * gp.npixel**2 * 8
    return bound(gp.n_in * per_entry + grids_bytes,
                 gp.n_in * (planes * (gp.span**2 * 4 + gp.span * 4) + 5))


def degrid_bound(gp, nchan=1):
    """K3's bound on plan ``gp`` (or a stack of ``nchan`` channel plans,
    whose ``n_in`` is a tensor): the grid cells its windows can reach in
    (on a plan, its segments' (tile + S)^2 cells on each plane they read,
    at most every cell: a nearest plan of many planes reaches a few of
    them; on a stack, every cell); per entry its corner and 2 x S taps in
    (S the plan's span, not the taps' zero padding), its plane where
    there is more than one, its fraction on a linear plan, and the value
    out; per in-grid entry and plane read (two on a linear plan, one
    otherwise) S row sums of S complex-by-real products and one of S."""
    import torch

    planes = 2 if gp.wstacked else 1
    cells = gp.nplanes * gp.npixel**2
    if hasattr(gp, "chunk_seg"):
        nseg = int(torch.unique(gp.chunk_seg).numel())
        cells = min(cells, nseg * (gp.tile + gp.span) ** 2 * planes)
    grids_bytes = nchan * cells * 8
    per_entry = (4 + 4 + 2 * 4 * gp.span + 8 + (4 if gp.nplanes > 1 else 0)
                 + (4 if gp.wstacked else 0))
    n_in = int(gp.n_in.sum()) if hasattr(gp.n_in, "sum") else gp.n_in
    return bound(grids_bytes + nchan * gp.n * per_entry,
                 n_in * (planes * (gp.span**2 * 4 + gp.span * 4) + 6))


def degrid_plain_pieces(gp, grids, piece=1 << 20):
    """degrid_plain of plan ``gp`` over pieces of ``piece`` entries: the
    plain version at the full stream within the card's memory."""
    import dataclasses

    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import degrid_plain

    out = torch.zeros(gp.n, dtype=torch.complex64, device=grids.device)
    for a in range(0, gp.n_in, piece):
        b = min(a + piece, gp.n_in)
        sub = dataclasses.replace(
            gp, iu0=gp.iu0[a:b], iv0=gp.iv0[a:b], plane=gp.plane[a:b],
            frac=gp.frac[a:b], ku=gp.ku[a:b], kv=gp.kv[a:b], n=b - a, n_in=b - a,
        )
        out[a:b] = degrid_plain(sub, grids)
    return out


def permute_bound(n, shared=0, npay=1):
    """K4's bound on ``n`` indices moving ``npay`` complex64 payloads: the
    index read once, each payload in and out; with a ``shared`` source of
    that many elements, the source read once in place of ``n`` elements
    in."""
    if shared:
        return bound(n * 4 + npay * (n * 8 + shared * 8), 0)
    return bound(n * 4 + npay * n * (8 + 8), 0)


def once_timed(fn):
    """(fn(), its device time in ms: one run, CUDA events)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def grid_row(gp, vals, label, plain_reps=1, reps=10):
    """The grid kernel against its plain version accumulated in f64 (in
    pieces) on plan ``gp`` and plan-ordered ``vals``, and a second launch
    to the same bits; times both (the plain version in f64; ``plain_reps``
    0: the reference run's own time) and prints the row with its bound.
    Returns the kernel row."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import grid

    piece = _plain_piece(gp)
    ref, ref_ms = once_timed(lambda: grid_plain_pieces(gp, vals.to(torch.complex128), piece))
    out = grid(gp, vals)
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    same = torch.equal(out, grid(gp, vals))
    del ref, out
    nchunks = int(gp.chunk_seg.shape[0])
    row = _row(
        err, rel, timed(lambda: grid(gp, vals), reps),
        timed(lambda: grid_plain_pieces(gp, vals.to(torch.complex128), piece), plain_reps)
        if plain_reps else ref_ms,
        grid_bound(gp),
    )
    say(
        f"grid {label}: {gp.n_in} entries in {nchunks} chunks of at most "
        f"{int(gp.chunk_count.max())}, {gp.nplanes} planes of {gp.npixel}^2, "
        f"tile {gp.tile}: max abs err {err:.3e}, rel {rel:.3e} (tolerance "
        f"{KERNELS['grid'][0]:g}); kernel {row['ms']:.4f} ms, plain (f64, in "
        f"pieces) {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}); a second launch gives the same bits: {same}"
    )
    if not rel <= KERNELS["grid"][0]:
        raise AssertionError(f"grid {label} disagrees with its plain version")
    if not same:
        raise AssertionError(f"grid {label}: two launches on the same inputs differ")
    return row


def compare_gridding(device, vis, plan):
    """grid, degrid and permute against their plain versions at the main
    path's geometry."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import (
        degrid,
        degrid_plain,
    )
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_imaging_plan
    from ska_sdp_func_python_torch.ops.permute import (
        permute_apply,
        permute_apply_plain,
    )

    out = {}
    full = plan.plans[0]
    # 1M entries of the flagship coordinates on the flagship geometry
    # (same npad, tile, w planes), small enough for the plain versions
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    n_sub = min(1 << 20, uvw.shape[0])
    sub = make_imaging_plan(
        uvw[:n_sub, 0], uvw[:n_sub, 1], uvw[:n_sub, 2],
        npixel=full.npixel, cellsize=full.cellsize, nw=full.nw,
        padding=1.25, w_range=(float(uvw[:, 2].min()), float(uvw[:, 2].max())),
    ).gp
    assert (sub.npixel, sub.nplanes, sub.tile) == (
        full.gp.npixel, full.gp.nplanes, full.gp.tile
    )
    g = torch.Generator(device=device).manual_seed(1)
    # the main path's grid input: weighted visibilities in plan order;
    # reference: the plain version accumulated in f64 (its f32 form sums
    # up to ~1e5 terms per cell one by one and is the less accurate side).
    # The row is the full flagship stream; the 1M subset is held too
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    grid_row(sub, sort_values(sub, weighted[:n_sub]), "1M subset", 3)
    out["grid"] = grid_row(full.gp, sort_values(full.gp, weighted), "full stream")
    # degrid: the full flagship stream (9.9M entries) against the plain
    # version in pieces; the 1M subset held too
    grids = torch.randn(
        (full.nw, full.npad, full.npad), generator=g, device=device,
        dtype=torch.complex64,
    )
    ref = degrid_plain(sub, grids)
    err = float((degrid(sub, grids) - ref).abs().max())
    say(
        f"degrid 1M subset: {sub.n} entries: max abs err {err:.3e}, rel "
        f"{err / float(ref.abs().max()):.3e} (tolerance {KERNELS['degrid'][0]:g})"
    )
    if not err <= KERNELS["degrid"][0] * float(ref.abs().max()):
        raise AssertionError("degrid 1M subset disagrees with its plain version")
    ref = degrid_plain_pieces(full.gp, grids)
    err = float((degrid(full.gp, grids) - ref).abs().max())
    out["degrid"] = _row(
        err, err / float(ref.abs().max()),
        timed(lambda: degrid(full.gp, grids), 20),
        timed(lambda: degrid_plain_pieces(full.gp, grids), 1),
        degrid_bound(full.gp),
    )
    del ref, grids
    say(
        f"full-size kernel times ({full.gp.n} entries, {full.nw} planes of "
        f"{full.npad}^2): grid {out['grid']['ms']:.3f} ms, degrid "
        f"{out['degrid']['ms']:.4f} ms (bound {out['degrid']['bound_ms']:.4f} ms)"
    )
    # permute: the full flagship permutation, one complex64 payload, both
    # directions; plan -> natural order (the row) is a gather through the
    # plan's inverse permutation, timed beside the same move as a scatter
    perm, iperm = full.gp.perm, full.gp.iperm
    x = torch.randn(perm.shape[0], generator=g, device=device, dtype=torch.complex64)
    for inv in (False, True):
        same = torch.equal(
            permute_apply(perm, x, inverse=inv),
            permute_apply_plain(perm, x, inverse=inv),
        )
        if not same:
            raise AssertionError(f"permute (inverse={inv}) is not bit-exact")
    if not torch.equal(permute_apply(iperm, x), permute_apply_plain(perm, x, inverse=True)):
        raise AssertionError("permute: the gather through the inverse permutation differs")
    idx = perm.long()
    y = torch.empty_like(x)
    out["permute"] = _row(
        0.0, 0.0,
        timed(lambda: permute_apply(iperm, x), 20),
        timed(lambda: permute_apply_plain(iperm, x), 5),
        permute_bound(perm.shape[0]),
        timed(lambda: y.index_copy_(0, idx, x), 20),
    )
    say(
        f"permute ({perm.shape[0]} complex64), plan -> natural order: "
        f"a gather through the inverse permutation {out['permute']['ms']:.4f} ms, "
        f"as a scatter {timed(lambda: permute_apply(perm, x, inverse=True), 20):.4f} ms; "
        f"natural -> plan order (a gather) {timed(lambda: permute_apply(perm, x), 20):.4f} ms; "
        f"bound {out['permute']['bound_ms']:.4f} ms; with a 32-byte sector for "
        f"each random 8-byte access {perm.shape[0] * (4 + 8 + 32) / PEAK_BYTES_S * 1e3:.4f} ms"
    )
    return out


def _hogbom_bound(rows, ny, nx, py, px, planes=1, search_ops=2):
    """Bytes: dirty and PSF in, residual and rows out, per lane and plane;
    operations: each used row's clipped footprint (one fused multiply-add
    a pixel and plane) and one search over the image per iteration.
    ``rows``: [lanes, niter, k], the last column 1 where used. Returns
    (bound, iterations of the longest lane, footprint pixels of all)."""
    nl = rows.shape[0]
    used = [[r for r in lane if r[-1] > 0] for lane in rows.tolist()]
    area = sum(
        footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for lane in used for r in lane
    )
    nits = sum(len(lane) for lane in used)
    nbytes = nl * (4 * (2 * planes * ny * nx + py * px)) + 4 * rows.numel()
    nops = 2 * planes * area + search_ops * ny * nx * (nits + nl)
    return bound(nbytes, nops), max(len(lane) for lane in used), area, nits


def _check_clean(name, out, ref):
    """Identical component positions; every output within its tolerance of
    the plain version's maximum. Returns (max abs err, rel err)."""
    import torch

    if not torch.equal(out[0] != 0, ref[0] != 0):
        raise AssertionError(f"{name}: component positions differ")
    err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    rel = max(
        float((o - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        for o, r in zip(out, ref)
    )
    return err, rel


def hogbom_case(label, kernel, planes, d, p, win, kw, plain_reps=3):
    """K5 ("hogbom", one plane) or K6 ("hogbom_complex", Q and U) on the
    lanes ``d`` (one [lanes, ny, nx] tensor a plane) with PSFs ``p`` and
    window ``win``, against the plain loop run lane by lane on the card:
    identical component positions, outputs within the kernel's tolerance.
    Times both and prints the iterations, microseconds an iteration (over
    the longest lane, which the launch waits for) and the per-iteration
    streaming figure: one search read of every lane's planes (and window),
    plus each footprint's PSF read and residual read-modify-write, over
    3.35 TB/s. Returns the kernel's row."""
    import torch

    from ska_sdp_func_python_torch.ops import cleaners as cl

    nl, ny, nx = d[0].shape
    py, px = p.shape[-2:]
    lane_win = None if win is None else torch.broadcast_to(win, d[0].shape)

    def w(i):
        return None if lane_win is None else lane_win[i]

    if planes == 1:
        def run():
            return cl.hogbom_lanes(d[0], p, win, **kw)

        def plain():
            out = [cl.hogbom_rows_plain(d[0][i], p[i], w(i), **kw) for i in range(nl)]
            rows = torch.stack([o[0] for o in out])
            return rows, (cl._rows_to_image(rows, ny, nx), torch.stack([o[1] for o in out]))
    else:
        def run():
            return cl.hogbom_complex_lanes(d[0], d[1], p, win, **kw)

        def plain():
            out = [
                cl.hogbom_complex_rows_plain(d[0][i], d[1][i], p[i], w(i), **kw)
                for i in range(nl)
            ]
            rows = torch.stack([o[0] for o in out])
            return rows, (
                cl._rows_to_image(rows, ny, nx, col=2, used=4),
                cl._rows_to_image(rows, ny, nx, col=3, used=4),
                torch.stack([o[1] for o in out]), torch.stack([o[2] for o in out]),
            )

    rows, ref = plain()
    out = run()
    err, rel = _check_clean(label, out, ref)
    if not rel <= KERNELS[kernel][0]:
        raise AssertionError(f"{label} disagrees with its plain version: rel {rel}")
    if lane_win is not None and float(out[0][lane_win == 0].abs().max()) != 0.0:
        raise AssertionError(f"{label}: a component outside the window")
    bnd, iters, area, nits = _hogbom_bound(
        rows, ny, nx, py, px, planes=planes, search_ops=2 if planes == 1 else 5
    )
    row = _row(err, rel, timed(run, 5), timed(plain, plain_reps), bnd)
    search = 4 * (planes + (win is not None)) * ny * nx * (nits + nl)
    per_it_mb = (search + 4 * (1 + 2 * planes) * area) / max(iters, 1) / 1e6
    say(
        f"{label}: {nl} lane(s) of {ny}x{nx}, PSF {py}x{px}: {iters} iterations "
        f"(longest lane; {nits} in all), {row['ms'] / max(iters, 1) * 1e3:.2f} us "
        f"per iteration; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
        f"max abs err {err:.3e}, rel {rel:.3e}; the search read plus the footprint "
        f"read-modify-write is {per_it_mb:.2f} MB per iteration, "
        f"{per_it_mb * 1e6 / PEAK_BYTES_S * 1e6:.2f} us at 3.35 TB/s"
    )
    return row


def hogbom_cases(label, dirty, psf_patch, kw, plain_reps=3):
    """hogbom (with and without the quarter window) and hogbom_complex (on
    the Q and U planes of the polarised sky of phase 6) on the lanes
    ``dirty`` [lanes, ny, nx] with PSF patches [lanes, py, px]. Returns
    the kernels' rows without the window."""
    import torch

    ny, nx = dirty.shape[-2:]
    win = torch.zeros((ny, nx), device=dirty.device)
    win[ny // 4 + 1 : 3 * (ny // 4), nx // 4 + 1 : 3 * (nx // 4)] = 1.0
    out = {"hogbom": hogbom_case(f"hogbom {label}", "hogbom", 1, (dirty,),
                                 psf_patch, None, kw, plain_reps)}
    hogbom_case(f"hogbom {label}, quarter window", "hogbom", 1, (dirty,),
                psf_patch, win, kw, plain_reps)
    q = (POL_P * np.cos(2 * POL_CHI)) * dirty
    u = (POL_P * np.sin(2 * POL_CHI)) * dirty
    out["hogbom_complex"] = hogbom_case(
        f"hogbom_complex {label}", "hogbom_complex", 2, (q, u), psf_patch, None,
        kw, plain_reps,
    )
    return out


def compare_cleaners(dirty, psf_patch):
    """hogbom (with and without the quarter window), msclean and
    hogbom_complex against their plain versions on the card, on the
    cycle-0 dirty image and the bounded PSF."""
    ny, nx = dirty.shape[-2:]
    py, px = psf_patch.shape[-2:]
    d = dirty.reshape(1, ny, nx).contiguous()
    p = psf_patch.reshape(1, py, px).contiguous()
    kw = dict(
        gain=CLEAN["gain"], thresh=0.0, niter=CLEAN["niter"],
        fracthresh=CLEAN["fractional_threshold"],
    )
    out = hogbom_cases("flagship", d, p, kw)
    out["msclean"] = msclean_case("msclean", d[0], psf_patch.reshape(py, px), kw)
    return out


def msclean_case(label, dirty, psf_patch, kw, with_floor=True):
    """K7 against its plain version on the card, bit for bit in rows,
    residual stack and component image, on ``dirty`` [ny, nx] with the
    fused lane's stacks from the bounded PSF; times both, prints the
    microseconds per used iteration (and, ``with_floor``, the loop's
    barrier floor at the flagship's size). Returns the kernel's row."""
    from ska_sdp_func_python_torch.ops import cleaners as cl

    ny, nx = dirty.shape
    py, px = psf_patch.shape
    d = dirty.reshape(1, ny, nx).contiguous()
    st = cl.msclean_psf_stacks(psf_patch, ny, nx, SCALES)
    res_stack = cl.convolve_scalestack(st.scalestack, d[0] / st.pmax)[None].contiguous()
    ms_args = (res_stack, st.psf_ss[None], st.coupling_diag[None], st.pscalestack[None])

    def ms_kernel():
        return cl.msclean_lanes(*ms_args, **kw)

    def ms_plain():
        rows, res = cl.msclean_rows_plain(
            res_stack[0], st.psf_ss, st.coupling_diag, **kw
        )
        return rows, res, cl.msclean_rows_to_comps(rows, st.pscalestack, ny, nx)

    krows, kres, kcomp = ms_kernel()
    prows, pres, pcomp = ms_plain()
    err, rel = _check_exact(
        "msclean", (krows[0], kcomp[0], kres[0]), (prows, pcomp, pres)
    )
    ns = len(SCALES)
    used = [r for r in prows.tolist() if r[4] > 0]
    area = sum(footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for r in used)
    nscales_used = len({int(r[2]) for r in used})
    # bytes: the stack in and out, the component image out, the PSF stacks
    # and blobs of the scales picked in, the rows out; operations: each
    # footprint's update of every scale plane and of the component image,
    # and one search of the stack (a division and a comparison a pixel) per
    # iteration and at the start
    ms_bnd = bound(
        4 * (2 * ns * ny * nx + ny * nx + (ns + 1) * nscales_used * py * px + ns)
        + 4 * prows.numel(),
        2 * (ns + 1) * area + 3 * ns * ny * nx * (len(used) + 1),
    )
    ms_ms = timed(ms_kernel, 5)
    row = _row(err, rel, ms_ms, timed(ms_plain, 2), ms_bnd)
    # the floor: the same loop on one 1024^2 plane with a 1x1 PSF, so that
    # one band changes per iteration, over 300 iterations that all run
    floor = f"; barrier floor {clean_floor('msclean'):.2f} us per iteration" if with_floor else ""
    # per iteration the footprint of psf_ss[:, ms] and pscalestack[ms] is read
    # from device memory; the stack and the component image stay on chip
    per_it_mb = 4 * (ns + 1) * area / max(len(used), 1) / 1e6
    say(
        f"{label}: {len(used)} iterations at {ny}x{nx}, {ns} scales, PSF "
        f"{py}x{px}, bit-exact: kernel {ms_ms:.4f} ms, plain {row['plain_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
        f"{ms_ms / max(len(used), 1) * 1e3:.2f} us per used iteration; "
        f"the footprint reads of psf_ss[:, ms] and pscalestack[ms] are "
        f"{per_it_mb:.1f} MB per iteration, {per_it_mb * 1e6 / PEAK_BYTES_S * 1e6:.2f} "
        f"us at 3.35 TB/s{floor}"
    )
    return row


def clean_floor(name):
    """Microseconds per iteration of the msclean (K7) or msmfs (K8) loop
    where each iteration does almost nothing but its barrier and pick: one
    scale (and one moment) of the flagship's 1024^2 (msclean) or the cube's
    256^2 (msmfs), a 1x1 PSF so that one band changes per iteration, and no
    threshold, over 300 iterations that all run."""
    import torch

    from ska_sdp_func_python_torch.ops import cleaners as cl

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    kw = dict(gain=0.2, thresh=0.0, niter=300, fracthresh=0.0)
    one = torch.ones((1, 1, 1), device=dev)
    if name == "msclean":
        res = torch.rand((1, 1, 1024, 1024), generator=g, device=dev) + 1.0
        args = (res, one[None, None], one[0], one[None])
        ms = timed(lambda: cl.msclean_lanes(*args, **kw), 5)
    else:
        res = torch.rand((1, 1, 1, 256, 256), generator=g, device=dev) + 1.0
        args = (res, one[None, None], one, one, one)
        ms = timed(lambda: cl.msmfs_lanes(*args, **kw), 5)
    return ms / 300 * 1e3


def _check_exact(name, out, ref):
    """The kernel's outputs bit for bit against the plain version's.
    Returns (max abs err, rel err), both 0."""
    import torch

    for o, r in zip(out, ref):
        if not torch.equal(o, r):
            diff = float((o - r).abs().max())
            raise AssertionError(f"{name}: differs from its plain version by {diff}")
    return 0.0, 0.0


class _CycleLog(logging.Handler):
    """Collects the per-cycle log records of the port's ical with their
    arrival times (each record follows a device sync on the peak)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.events = []

    def emit(self, record):
        self.events.append((time.perf_counter(), record.getMessage()))


def _launch_gate(label, counts, names):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{label}: kernels {missing} never launched: {counts}")


def run_logged(label, entry, nmajor, path_kernels, walls=None):
    """Runs ``entry()``, a user-facing entry point that logs each major
    cycle's peak residual, on the card, with the launch counters reset
    just before it and read just after; prints each cycle's wall time and
    peak (and appends the walls, in ms, to ``walls``). Fails unless every
    cycle logged a finite peak, the peak fell and every kernel of
    ``path_kernels`` launched. Returns (entry's result, counts, peaks)."""
    import torch

    from ska_sdp_func_python_torch import kernels

    handler = _CycleLog()
    logger = logging.getLogger("ska-sdp-func-python-torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = entry()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    logger.removeHandler(handler)
    say(f"{label}: total {total:.3f} s, launches {counts}")
    peaks = []
    prev = None
    for t, msg in handler.events:
        if "cycle" in msg and prev is not None:
            peaks.append(float(msg.rsplit(" ", 1)[1]))
            say(f"{label}: {msg.split(': ', 1)[1]}, wall {(t - prev) * 1e3:.1f} ms")
            if walls is not None:
                walls.append((t - prev) * 1e3)
        prev = t
    if not all(np.isfinite(peaks)) or len(peaks) != nmajor:
        raise AssertionError(f"{label}: per-cycle peaks missing or not finite: {peaks}")
    if not peaks[-1] < peaks[0]:
        raise AssertionError(f"{label}: peak residual did not fall: {peaks}")
    if not all(torch.isfinite(im.pixels).all() for im in out[:3]):
        raise AssertionError(f"{label}: an output image is not finite")
    _launch_gate(label, counts, path_kernels)
    return out, counts, peaks


def run_ical(label, vis, model, phases, nmajor, path_kernels, **kw):
    """The user-facing ical on the card (see :func:`run_logged`), and its
    gain phase error. Returns (counts, peaks, model, restored peak)."""
    from ska_sdp_func_python_torch.pipeline import ical

    (current, residual, restored, gts), counts, peaks = run_logged(
        label,
        lambda: ical(vis, model, nmajor=nmajor, calibration_context="T",
                     context="ng", **kw),
        nmajor, path_kernels,
    )
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    rpeak = float(restored.pixels.max())
    say(
        f"{label}: gain phase error vs truth max {gmax:.3e} rad, rms {grms:.3e} "
        f"rad; restored peak {rpeak:.4f} (source 2.0 Jy); final residual "
        f"peak {float(residual.pixels.abs().max()):.4e}"
    )
    return counts, peaks, current, rpeak


def run_hogbom_ical(vis, model, phases):
    """Phase 4: the Hogbom ical of the first slice, with its gates. Each
    cycle's CLEAN input is kept (a copy of the residual, 4 MB on the card)
    and, after the run, the plain loop counts the iterations the kernel
    ran on it (the two agree bit for bit, phase 3)."""
    from ska_sdp_func_python_torch import pipeline
    from ska_sdp_func_python_torch.ops import cleaners as cl

    inputs = []

    def recording(dirty, psf, window=None, **kw):
        inputs.append((dirty.clone(), psf, window, kw))
        return cl.hogbom_lanes(dirty, psf, window, **kw)

    pipeline.hogbom_lanes = recording
    try:
        counts, _, _, rpeak = run_ical(
            "hogbom ical", vis, model, phases, 4,
            ("grid", "degrid", "permute", "hogbom"), algorithm="hogbom", **CLEAN,
        )
    finally:
        pipeline.hogbom_lanes = cl.hogbom_lanes
    iters = [
        int(cl.hogbom_rows_plain(d[0], p[0], None if w is None else w[0], **kw)[0][:, 3].sum())
        for d, p, w, kw in inputs
    ]
    say(f"hogbom ical: CLEAN iterations per cycle {iters}")
    if not abs(rpeak - 2.0) < 0.2:
        raise AssertionError(f"restored peak {rpeak} not within 0.2 of 2.0")
    return counts


@contextlib.contextmanager
def counting_calls(name):
    """Counts the calls of ``pipeline.<name>`` (the fused CLEAN lane's
    entry) while the context is open: yields a list that receives one entry
    per call."""
    from ska_sdp_func_python_torch import pipeline

    calls, fn = [], getattr(pipeline, name)

    def counted(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    setattr(pipeline, name, counted)
    try:
        yield calls
    finally:
        setattr(pipeline, name, fn)


def _one_launch_per_call(label, counts, kernel, calls):
    """The CLEAN kernel ran one launch per CLEAN call of the cycle."""
    say(f"{label}: {kernel} launches {counts[kernel]} for {len(calls)} CLEAN calls")
    if counts[kernel] != len(calls):
        raise AssertionError(
            f"{label}: {counts[kernel]} {kernel} launches for {len(calls)} CLEAN calls"
        )


def run_msclean_ical(vis, model, phases):
    """Phase 5: ical with its default deconvolver, msclean: one msclean
    launch per CLEAN call."""
    with counting_calls("msclean_with_stacks") as calls:
        counts, peaks, current, _ = run_ical(
            "msclean ical", vis, model, phases, 4,
            ("grid", "degrid", "permute", "msclean"), scales=SCALES, **CLEAN,
        )
    _one_launch_per_call("msclean ical", counts, "msclean", calls)
    n = model.npixel
    px = current.pixels[0, 0].detach().cpu().numpy()
    yy, xx = np.mgrid[0:n, 0:n]
    fluxes = []
    for dx, dy, f in SOURCES:
        sy, sx = n // 2 + int(dy * n / 1024), n // 2 + int(dx * n / 1024)
        near = np.hypot(yy - sy, xx - sx) <= 10
        fluxes.append(float(px[near].sum()))
        say(f"msclean ical: model flux within 10 px of the {f} Jy source {fluxes[-1]:.4f}")
    if not peaks[-1] < 0.1 * peaks[0]:
        raise AssertionError(f"msclean ical: last peak not below 0.1x the first: {peaks}")
    if not abs(fluxes[0] - 2.0) < 0.2:
        raise AssertionError(f"msclean ical: flux {fluxes[0]} not within 0.2 of 2.0")
    return counts


def run_deconvolve_cube(dirty_image, psf_image):
    """Phase 6: deconvolve_cube(algorithm="hogbom-complex") on a stokesIQUV
    cube whose sources share one fractional polarisation."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.deconvolution import deconvolve_cube

    d = dirty_image.pixels[0, 0].to(torch.float32)
    p = psf_image.pixels[0, 0].to(torch.float32)
    planes = [
        d, POL_P * np.cos(2 * POL_CHI) * d, POL_P * np.sin(2 * POL_CHI) * d,
        POL_V * d,
    ]
    dirty = dirty_image.replace(
        pixels=torch.stack(planes)[None], polarisation_frame="stokesIQUV"
    )
    psf = psf_image.replace(
        pixels=torch.stack([p] * 4)[None].contiguous(), polarisation_frame="stokesIQUV"
    )
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    comp, res = deconvolve_cube(dirty, psf, algorithm="hogbom-complex", **CLEAN)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = kernels.launch_counts()
    _launch_gate("deconvolve_cube", counts, ("hogbom", "hogbom_complex"))
    c = comp.pixels[0].double().sum(dim=(-2, -1)).cpu().numpy()
    chi = 0.5 * np.degrees(np.arctan2(c[2], c[1]))
    pfrac = float(np.hypot(c[1], c[2]) / c[0])
    say(
        f"deconvolve_cube hogbom-complex {tuple(dirty.pixels.shape)}: "
        f"{total * 1e3:.1f} ms, launches {counts}; component sums I {c[0]:.4f} "
        f"Q {c[1]:.4f} U {c[2]:.4f} V {c[3]:.4f}; angle {chi:.4f} deg "
        f"(sky 30), fraction {pfrac:.5f} (sky 0.2)"
    )
    if not torch.isfinite(res.pixels).all():
        raise AssertionError("deconvolve_cube: residual is not finite")
    if not (abs(chi - 30.0) < 0.1 and abs(pfrac - POL_P) < 0.01):
        raise AssertionError("deconvolve_cube: polarisation not recovered")
    return counts


@contextlib.contextmanager
def plan_grid_in_f64():
    """The CPU's plan gridding accumulated in f64 (``grid_plain`` of the
    values as complex128, rounded to complex64 after) in place of its f32
    ``index_add_``: a grid as exact as K1's fixed-point tile, whose f32
    register sums are exact to f32 rounding."""
    import torch

    from ska_sdp_func_python_torch.ops import gridding_plan
    from ska_sdp_func_python_torch.ops.gridding_fused import grid_plain

    grid = gridding_plan.grid
    gridding_plan.grid = lambda plan, vals, **_: grid_plain(
        plan, vals.to(torch.complex128)).to(torch.complex64)
    try:
        yield
    finally:
        gridding_plan.grid = grid


def small_slice_matches_cpu(device, algorithm, f64_witness=False, **clean):
    """Phase 7: ical on a small observation with the CUDA kernels and on
    the CPU with the plain versions (which the CPU tests hold against the
    JAX package), to the JAX package's fused-vs-composed bounds.

    Both restored peaks are taken with the CPU run's clean beam: the
    Gaussian fit to this small array's PSF starts from a circular beam,
    where its angle has no gradient, so f32-level PSF differences alone
    move the fitted beam, and with it the restored peak, by several
    hundredths. The beams both runs fitted are printed.

    ``f64_witness``: the card is held to a third run, on the CPU with its
    plan gridding accumulated in f64 (:func:`plan_grid_in_f64`), where a
    CLEAN's choice between near-equal peaks follows the grid's rounding;
    the CPU run's f32 grid is then printed beside it, not gated."""
    from ska_sdp_func_python_torch.ops.deconvolution import restore_cube
    from ska_sdp_func_python_torch.pipeline import ical

    out = {}
    runs = [("card", device), ("cpu", "cpu")]
    if f64_witness:
        runs.append(("cpu f64 grid", "cpu"))
    for label, dev in runs:
        f64 = label == "cpu f64 grid"
        with plan_grid_in_f64() if f64 else contextlib.nullcontext():
            _, vis, model, _ = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
            d, r, s, g = ical(
                vis, model, nmajor=3, calibration_context="T", context="ng",
                algorithm=algorithm, scales=SCALES, **{**CLEAN, **clean},
            )
        gain = g["T"].gain.cpu().numpy()[..., 0, 0, 0]
        out[label] = (gain * np.exp(-1j * np.angle(gain[:, :1])), d, r, s)
    ga, da, ra, sa = out["card"]
    res_a = float(ra.pixels.abs().max())
    verdict = {}
    for label in list(out)[1:]:
        gb, _, rb, sb = out[label]
        beam = dict(zip(("bmaj", "bmin", "bpa"), np.rad2deg(sb.clean_beam)))
        peak_a = float(restore_cube(da, residual=ra, clean_beam=beam).pixels.max())
        peak_b = float(sb.pixels.max())
        dg = float(np.max(np.abs(ga - gb)))
        res_b = float(rb.pixels.abs().max())
        gated = label == runs[-1][0]
        say(
            f"small slice {algorithm}{' ' + str(clean) if clean else ''} card vs "
            f"{label}{'' if gated else ' (not gated)'}: gain {dg:.2e} (bound 1e-4), "
            f"residual peak {res_a:.6f} vs {res_b:.6f} (bound 1e-3 rel), restored "
            f"with one beam {peak_a:.4f} vs {peak_b:.4f} (bound 0.05); fitted "
            f"beams (bmaj, bmin, bpa deg) {np.rad2deg(sa.clean_beam)} vs "
            f"{np.rad2deg(sb.clean_beam)}, restored with its own beam "
            f"{float(sa.pixels.max()):.4f}"
        )
        verdict[label] = (dg < 1e-4 and abs(res_a - res_b) < 1e-3 * res_b
                          and abs(peak_a - peak_b) < 0.05)
    if not verdict[runs[-1][0]]:
        raise AssertionError(f"small slice {algorithm}: card and {runs[-1][0]} disagree")


def model_flux_near(current, chan, offset, radius=10):
    """The model flux (Jy) of channel ``chan`` within ``radius`` pixels of
    the source at pixel offset ``offset`` (dx, dy) from the centre."""
    n = current.npixel
    px = current.pixels[chan, 0].detach().double().cpu().numpy()
    yy, xx = np.mgrid[0:n, 0:n]
    near = np.hypot(yy - (n // 2 + offset[1]), xx - (n // 2 + offset[0])) <= radius
    return float(px[near].sum())


def cube_gates(label, current, peaks, offset, alpha, gate=True):
    """The MSMFS cube gates: the last peak residual below 0.1x the first;
    the model flux within 10 px of the source in the middle channel within
    0.2 of 2.0 Jy; the spectral index from the first and last channels'
    model fluxes within INDEX_TOL of the sky's. With ``gate`` False the
    numbers are only printed. Returns the spectral index."""
    freq = np.asarray(current.frequency)
    nchan = len(freq)
    f_mid = model_flux_near(current, nchan // 2, offset)
    f_lo = model_flux_near(current, 0, offset)
    f_hi = model_flux_near(current, nchan - 1, offset)
    index = float(np.log(f_hi / f_lo) / np.log(freq[-1] / freq[0]))
    say(
        f"{label}: model flux within 10 px of the source: channel {nchan // 2} "
        f"{f_mid:.4f} (sky 2.0), channel 0 {f_lo:.4f}, channel {nchan - 1} "
        f"{f_hi:.4f}; spectral index {index:.4f} (sky {alpha}); peak residual "
        f"{peaks[0]:.6f} -> {peaks[-1]:.6f}"
    )
    if not gate:
        return index
    if not peaks[-1] < 0.1 * peaks[0]:
        raise AssertionError(f"{label}: last peak not below 0.1x the first: {peaks}")
    if not abs(f_mid - 2.0) < 0.2:
        raise AssertionError(f"{label}: flux {f_mid} not within 0.2 of 2.0")
    if not abs(index - alpha) < INDEX_TOL:
        raise AssertionError(
            f"{label}: spectral index {index} not within {INDEX_TOL} of {alpha}"
        )
    return index


def channel_shapes(gp, label):
    """K3 and K4 at one launch of the main path on plan ``gp``: degrid of
    random grids, and the inverse permute of one complex64 payload; prints
    times and bounds."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import degrid
    from ska_sdp_func_python_torch.ops.permute import permute_apply

    g = torch.Generator(device=gp.perm.device).manual_seed(2)
    grids = torch.randn((gp.nplanes, gp.npixel, gp.npixel), generator=g,
                        device=gp.perm.device, dtype=torch.complex64)
    x = torch.randn(gp.perm.shape[0], generator=g, device=gp.perm.device,
                    dtype=torch.complex64)
    d_ms = timed(lambda: degrid(gp, grids), 20)
    p_ms = timed(lambda: permute_apply(gp.perm, x, inverse=True), 20)
    say(
        f"{label}: degrid {gp.n} entries, {gp.nplanes} planes of {gp.npixel}^2: "
        f"kernel {d_ms:.4f} ms, bound {degrid_bound(gp)[0]:.4f} ms; permute "
        f"{gp.perm.shape[0]} complex64: kernel {p_ms:.4f} ms, bound "
        f"{permute_bound(gp.perm.shape[0])[0]:.4f} ms"
    )


def stack_shapes(plan, label):
    """K3 and K4 at the cube cycle's launches: one launch over the plan
    stack of every channel. The 64-channel degrid of random grids is held
    against the per-channel plain version (1e-5 of the largest |value|),
    the stacked permutes (inverse, forward, and forward from one shared
    source, as the cycle moves the model and the gain factors) bit for bit
    against the plain version; prints times and bounds."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import (
        degrid_stack,
        degrid_stack_plain,
    )
    from ska_sdp_func_python_torch.ops.permute import (
        permute_apply,
        permute_apply_plain,
    )

    st = plan.stack
    dev = st.perm.device
    g = torch.Generator(device=dev).manual_seed(3)
    grids = torch.randn((st.nchan, st.nplanes, st.npixel, st.npixel), generator=g,
                        device=dev, dtype=torch.complex64)
    ref = degrid_stack_plain(st, grids)
    err = float((degrid_stack(st, grids) - ref).abs().max())
    rel = err / float(ref.abs().max())
    del ref
    d_ms = timed(lambda: degrid_stack(st, grids), 20)
    d_bound = degrid_bound(st, st.nchan)
    say(
        f"{label}: degrid, one launch over {st.nchan} channels of {st.n} entries "
        f"({int(st.n_in.sum())} in the grid), {st.nplanes} planes of "
        f"{st.npixel}^2: max abs err {err:.3e}, rel {rel:.3e} against the "
        f"per-channel plain version (tolerance {KERNELS['degrid'][0]:g}); kernel "
        f"{d_ms:.4f} ms, bound {d_bound[0]:.4f} ms ({d_bound[1]})"
    )
    if not rel <= KERNELS["degrid"][0]:
        raise AssertionError(f"{label}: stacked degrid disagrees with its plain version")
    del grids
    x = torch.randn((st.nchan, st.n), generator=g, device=dev, dtype=torch.complex64)
    f = torch.randn(st.n, generator=g, device=dev, dtype=torch.complex64)
    times = {}
    for name, p, src, inv, sh in (
        ("plan -> natural (gather through the inverse)", st.iperm, x, False, ()),
        ("plan -> natural as a scatter", st.perm, x, True, ()),
        ("natural -> plan", st.perm, x, False, ()),
        ("natural -> plan from one shared source", st.perm, f, False, (0,)),
    ):
        if not torch.equal(permute_apply(p, src, inverse=inv, shared=sh),
                           permute_apply_plain(p, src, inverse=inv, shared=sh)):
            raise AssertionError(f"{label}: stacked permute ({name}) is not bit-exact")
        times[name] = timed(lambda: permute_apply(p, src, inverse=inv, shared=sh), 20)
    if not torch.equal(permute_apply(st.iperm, x), permute_apply(st.perm, x, inverse=True)):
        raise AssertionError(f"{label}: the gather through the inverse differs")
    total = st.nchan * st.n
    say(
        f"{label}: permute, one launch over {st.nchan} channels of {st.n} "
        f"complex64, bit-exact: " + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; bound {permute_bound(total)[0]:.4f} ms, from the shared [{st.n}] "
        f"source {permute_bound(total, st.n)[0]:.4f} ms"
    )


def _cube_launch_gate(label, counts, nmajor, npol=1):
    """The cube cycle's degrid and permute legs batch the channels: at most
    one degrid launch per (major cycle with a model, polarisation), two
    permutes per (major cycle, polarisation) and one per polarisation for
    the workspace, whatever the channel count."""
    most = {"degrid": (nmajor - 1) * npol, "permute": (2 * nmajor + 1) * npol}
    say(
        f"{label}: launches per kernel {counts}; degrid at most "
        f"{most['degrid']}, permute at most {most['permute']}"
    )
    over = {k: counts[k] for k, m in most.items() if counts[k] > m}
    if over:
        raise AssertionError(f"{label}: more launches than the batched legs make: {over}")


def compare_msmfs(model, dirty, patch):
    """Phase 8a: the msmfs kernel against its plain version on the card, on
    the cycle-0 moment stacks of the cube's fused cycle (the moment images
    of the dirty cube and the moment PSFs over the moment-PSF peak), from
    the dirty cube and its bounded PSF patches."""
    import torch

    from ska_sdp_func_python_torch.ops import cleaners as cl
    from ska_sdp_func_python_torch.ops.taylor import moment_weights

    nm = CUBE_CLEAN["nmoment"]
    w_m, w_p = (
        moment_weights(model.frequency, None, k).to(device=dirty.pixels.device, dtype=torch.float32)
        for k in (nm, 2 * nm)
    )
    psf_t = torch.einsum("cm,cpyx->mpyx", w_p, patch)
    peak = psf_t.max()
    ny, nx = model.pixels.shape[-2:]
    st = cl.msmfs_psf_stacks(psf_t[:, 0] / peak, ny, nx, SCALES)
    dpix = torch.einsum("cm,cpyx->mpyx", w_m, dirty.pixels.to(torch.float32)) / peak
    smres = cl.calculate_scale_moment_residual(dpix[:, 0] / st.pmax, st.scalestack)
    smres = smres.contiguous()
    kw = dict(gain=0.7, thresh=0.0, fracthresh=CUBE_CLEAN["fractional_threshold"],
              niter=CUBE_CLEAN["niter"])

    def kernel():
        return cl.msmfs_lanes(
            smres[None], st.canvas, st.hsmm, st.ihsmm, st.pscalestack, **kw
        )

    def plain():
        rows, res = cl.msmfs_rows_plain(smres, st.canvas, st.hsmm, st.ihsmm, **kw)
        return rows, res, cl.msmfs_rows_to_model(rows, st.pscalestack, ny, nx)

    (krows, kres, kmodel), (prows, pres, pmodel) = kernel(), plain()
    err, rel = _check_exact(
        "msmfs", (krows[0], kres[0], kmodel[0]), (prows, pres, pmodel)
    )
    ns = len(SCALES)
    py, px = st.canvas.shape[-2:]
    used = [r for r in prows.tolist() if r[3] > 0]
    area = sum(footprint_area(int(r[0]), int(r[1]), ny, nx, py, px) for r in used)
    stack = ns * nm * ny * nx
    # bytes: the stack in and out, the moment model out, the compact canvas,
    # blobs, Hessian and inverse in, the rows out; operations: the moment-0
    # criterion (nm products, nm - 1 sums) and its comparison over the stack
    # once per search, nm sums of nm products for every moment plane of
    # every scale and 2 nm for the model over each pick's footprint
    bnd = bound(
        4 * (2 * stack + nm * ny * nx + ns * ns * (2 * nm - 1) * py * px
             + ns * py * px + 2 * ns * nm * nm)
        + 4 * prows.numel(),
        (2 * nm + 1) * ns * ny * nx * (len(used) + 1) + 2 * nm * (ns * nm + 1) * area,
    )
    ms = timed(kernel, 5)
    out = _row(err, rel, ms, timed(plain, 2), bnd)
    floor = clean_floor("msmfs")
    per_it = max(len(used), 1)
    # per iteration canvas[ms] and pscalestack[ms] over the footprint are
    # read from device memory; the stack and the model stay on chip
    per_it_mb = 4 * (ns * (2 * nm - 1) + 1) * area / per_it / 1e6
    say(
        f"msmfs: {len(used)} iterations at {ny}x{nx}, {ns} scales, {nm} moments, "
        f"PSF {py}x{px}: {ms / per_it * 1e3:.2f} us per used iteration; the "
        f"footprint reads of canvas[ms] and pscalestack[ms] are {per_it_mb:.2f} MB "
        f"per iteration, {per_it_mb * 1e6 / PEAK_BYTES_S * 1e6:.2f} us at 3.35 TB/s; "
        f"barrier floor {floor:.2f} us per iteration"
    )
    return out


def run_cube(device):
    """Phase 8: the MSMFS cube. Holds the grid kernel on one channel's
    launch (the cube cycle's per-channel shape); runs phase 13d's list API
    on the cube's dirty channels. Returns (kernel row of msmfs, summed
    launch counts of 8b and 8c, those of 13d)."""
    import torch

    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )
    from ska_sdp_func_python_torch.pipeline import continuum_imaging

    t0 = time.perf_counter()
    vis, model = simulate_cube(device, **CUBE)
    torch.cuda.synchronize()
    say(
        f"cube observation: {CUBE['nants']} stations, {vis.nchan} channels, "
        f"{vis.nvis} visibilities, {model.npixel}^2 x {model.nchan} cube, "
        f"simulated in {time.perf_counter() - t0:.1f} s"
    )
    plan = make_visibility_plan(vis, model, context="ng")
    c = vis.nchan // 2
    gp = plan.plans[c].gp
    weighted = (vis.vis * vis.imaging_weight)[:, :, c, 0].reshape(-1).contiguous()
    grid_row(gp, sort_values(gp, weighted), f"cube channel {c} (one channel's launch)")
    channel_shapes(gp, f"cube channel {c}")
    stack_shapes(plan, "config-4 cube")
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    dirty, _ = invert_visibility(vis, model, plan=plan)
    patch = bound_psf(psf, psf).pixels.to(torch.float32)
    row = compare_msmfs(model, dirty, patch)
    counts_13d = cube_lists(dirty, psf)
    # the Hogbom kernels on one lane a channel (a Hogbom deconvolve_cube
    # of this cube), at the flagship's CLEAN settings
    hogbom_cases(
        "config-4 cube", dirty.pixels[:, 0].to(torch.float32).contiguous(),
        patch[:, 0].contiguous(),
        dict(gain=CLEAN["gain"], thresh=0.0, niter=CLEAN["niter"],
             fracthresh=CLEAN["fractional_threshold"]),
        plain_reps=1,
    )
    del plan, gp, weighted, psf, dirty, patch
    torch.cuda.empty_cache()
    with counting_calls("msmfs_with_stacks") as calls:
        (current, _, _), counts_b, peaks = run_logged(
            "msmfs continuum_imaging",
            lambda: continuum_imaging(vis, model, nmajor=4, context="ng", **CUBE_CLEAN),
            4, ("grid", "degrid", "msmfs"),
        )
    _cube_launch_gate("msmfs continuum_imaging", counts_b, 4)
    _one_launch_per_call("msmfs continuum_imaging", counts_b, "msmfs", calls)
    cube_gates("msmfs continuum_imaging", current, peaks, CUBE["offset"], CUBE["alpha"])
    del current
    corrupted, phases = corrupt(vis, 0.4)
    del vis
    with counting_calls("msmfs_with_stacks") as calls:
        counts_c, peaks, current, _ = run_ical(
            "msmfs ical", corrupted, model, phases, 4,
            ("grid", "degrid", "permute", "msmfs"), **CUBE_CLEAN,
        )
    _cube_launch_gate("msmfs ical", counts_c, 4)
    _one_launch_per_call("msmfs ical", counts_c, "msmfs", calls)
    # printed, not gated: the self-cal residual keeps the calibration error
    cube_gates("msmfs ical", current, peaks, CUBE["offset"], CUBE["alpha"], gate=False)
    return row, {k: counts_b[k] + counts_c[k] for k in counts_b}, counts_13d


def small_cube_matches_cpu(device):
    """Phase 8d: ical with MSMFS (2 moments) on the small cube of the JAX
    package's fused-cube test, with the CUDA kernels and on the CPU, to
    the bounds of phase 7 (gains 1e-4, residual peak 1e-3 relative)."""
    from ska_sdp_func_python_torch.pipeline import ical

    out = {}
    for dev in (device, "cpu"):
        vis, model = simulate_cube(dev, **SMALL_CUBE)
        vis, _ = corrupt(vis, 0.3)
        d, r, _, g = ical(
            vis, model, nmajor=3, calibration_context="T", context="ng",
            algorithm="mmclean", nmoment=2, niter=100, fractional_threshold=0.01,
        )
        gain = g["T"].gain.cpu().numpy()[..., 0, 0, 0]
        out[dev] = (gain * np.exp(-1j * np.angle(gain[:, :1])), d.pixels.cpu(), r.pixels.cpu())
    (ga, da, ra), (gb, db, rb) = out[device], out["cpu"]
    dg = float(np.max(np.abs(ga - gb)))
    res_a, res_b = float(ra.abs().max()), float(rb.abs().max())
    same = bool(((da != 0) == (db != 0)).all())
    say(
        f"small cube mmclean card vs cpu: gain {dg:.2e} (bound 1e-4), residual "
        f"peak {res_a:.6f} vs {res_b:.6f} (bound 1e-3 rel), same component "
        f"pixels {same}, model {float((da - db).abs().max()):.3e} apart"
    )
    if not (dg < 1e-4 and abs(res_a - res_b) < 1e-3 * res_b):
        raise AssertionError("small cube mmclean: card and cpu disagree")


def corrupt_terms(vis, terms, seed):
    """``vis`` times one gaintable per term of ``terms``, each (jones type,
    timeslice, phase sigma in rad, amplitude sigma): gains (1 + N(0, amp))
    exp(i N(0, phase)) per (interval, station, solution channel). Returns
    (corrupted vis, {jones type: true gains [ntab, nants, nchan]
    complex128})."""
    import torch

    from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
    from ska_sdp_func_python_torch.ops import apply_gaintable

    rng = np.random.default_rng(seed)
    truth = {}
    for jones_type, timeslice, phase, amp in terms:
        gt = create_gaintable_from_visibility(vis, jones_type=jones_type, timeslice=timeslice)
        shape = gt.gain.shape[:3]
        g = (1.0 + rng.normal(0, amp, shape)) * np.exp(1j * rng.normal(0, phase, shape))
        gain = torch.as_tensor(g[..., None, None], device=vis.device).to(gt.gain.dtype)
        vis = apply_gaintable(vis, gt.replace(gain=gain.contiguous()))
        truth[jones_type] = g
    return vis, truth


def gains_of(gt):
    """A scalar gaintable's gains [ntab, nants, nchan] as complex128."""
    return gt.gain.detach().cpu().numpy()[..., 0, 0].astype(np.complex128)


def referenced(g, mean_one=False):
    """Gains [ntab, nants, nchan] with station 0's phase taken out of every
    (interval, channel) and, with ``mean_one``, divided by their mean
    amplitude: the gauge freedoms of a solve."""
    g = g * np.exp(-1j * np.angle(g[:, :1]))
    return g / np.mean(np.abs(g)) if mean_one else g


def channel_phase_error(solved, true):
    """The largest |solved - true| of each channel's referenced,
    mean-amplitude-1 gains (the JAX package's bandpass check)."""
    return max(
        float(np.max(np.abs(referenced(solved[..., c:c + 1], True)
                            - referenced(true[..., c:c + 1], True))))
        for c in range(solved.shape[2])
    )


@contextlib.contextmanager
def solve_timer(context):
    """Times every StefCal solve (``solve_gains_core``, synchronised before
    and after) of the fused and the composed cycle while the context is
    open; yields {term: [ms, ...]}, the solves going to the terms of
    ``context`` in turn (every term solves in every cycle)."""
    import torch

    from ska_sdp_func_python_torch import pipeline
    from ska_sdp_func_python_torch.ops import solvers

    fn = solvers.solve_gains_core
    times = {t: [] for t in context}
    calls = []

    def timed_solve(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[context[len(calls) % len(context)]].append((time.perf_counter() - t0) * 1e3)
        calls.append(1)
        return out

    pipeline.solve_gains_core = solvers.solve_gains_core = timed_solve
    try:
        yield times
    finally:
        pipeline.solve_gains_core = solvers.solve_gains_core = fn


def _steady_solves(label, times):
    """Prints each term's StefCal time per cycle; the steady mean leaves
    out cycle 0, whose model is empty."""
    say(f"{label}: StefCal ms per cycle " + "; ".join(
        f"{t} " + ", ".join(f"{v:.2f}" for v in ms) + f" (steady mean {np.mean(ms[1:]):.2f})"
        for t, ms in times.items()
    ))


def run_tg_flagship(vis, model, t_phases):
    """Phase 10a: the flagship observation (its "T" phases from
    N(0, 0.4)) also corrupted by "G" gains in 60 s bins, through
    ``ical(calibration_context="TG")`` with msclean, fused and composed, 4
    cycles each. Gates: the peak residual falls, each restored peak within
    0.2 of 2.0 Jy, the two paths within the JAX package's "TG" bounds
    (residual peaks 0.02, restored peaks 0.05), every kernel of each path
    launched. Prints the G amplitude and phase errors and the combined
    T*G phase error against the truth. Returns the summed launch
    counts."""
    from ska_sdp_func_python_torch.ops.gain_ops import _gain_row_of_time
    from ska_sdp_func_python_torch.pipeline import ical

    corrupted, truth = corrupt_terms(vis, [G_TERM], seed=43)
    out, total = {}, None
    for label, fused in (("fused", True), ("composed", False)):
        name = f"TG ical {label}"
        with solve_timer("TG") as times:
            (_, res, restored, gts), counts, peaks = run_logged(
                name,
                lambda: ical(corrupted, model, nmajor=4, calibration_context="TG",
                             context="ng", fused=fused, scales=SCALES, **CLEAN),
                4, ("grid", "degrid", "permute", "msclean"),
            )
        _steady_solves(name, times)
        g = gains_of(gts["G"])
        rows = _gain_row_of_time(vis.time, gts["G"].time, gts["G"].interval)[0]
        rows = rows.cpu().numpy()
        tg = referenced(gains_of(gts["T"]) * g[rows])
        true_tg = referenced(np.exp(1j * t_phases) * truth["G"][rows])
        err = np.angle(tg * np.conj(true_tg))
        has = gts["G"].weight.detach().cpu().numpy()[:, 0, 0, 0, 0] > 0
        gs, gt = referenced(g[has], True), referenced(truth["G"][has], True)
        amp = np.abs(gs) - np.abs(gt)
        gph = np.angle(gs * np.conj(gt))
        rpeak = float(restored.pixels.max())
        say(
            f"{name}: G vs truth ({int(has.sum())} of {len(has)} bins with data; "
            f"station 0's phase out, mean amplitude 1): amplitude error max "
            f"{np.max(np.abs(amp)):.3e}, rms {np.sqrt(np.mean(amp**2)):.3e}; phase "
            f"error max {np.max(np.abs(gph)):.3e} rad, rms "
            f"{np.sqrt(np.mean(gph**2)):.3e} (one integration a bin: T takes "
            f"the phase of both terms); T*G phase error max "
            f"{np.max(np.abs(err)):.3e} rad, rms {np.sqrt(np.mean(err**2)):.3e}; "
            f"restored peak {rpeak:.4f} (source 2.0 Jy)"
        )
        if not abs(rpeak - 2.0) < 0.2:
            raise AssertionError(f"{name}: restored peak {rpeak} not within 0.2 of 2.0")
        out[label] = (peaks[-1], rpeak)
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    (rf, sf), (rc, sc) = out["fused"], out["composed"]
    say(
        f"TG ical fused vs composed: residual peak {rf:.6f} vs {rc:.6f} (bound "
        f"{TG_RESIDUAL_TOL}), restored peak {sf:.4f} vs {sc:.4f} (bound {TG_RESTORED_TOL})"
    )
    if not (abs(rf - rc) < TG_RESIDUAL_TOL and abs(sf - sc) < TG_RESTORED_TOL):
        raise AssertionError("TG ical: the fused and composed paths disagree")
    return total


def run_tb_cube(device):
    """Phase 10b: the config-4 cube corrupted by "T" phases N(0, 0.4) per
    integration and a "B" table (one interval; per station and channel
    phase N(0, 0.25), amplitude 1 + N(0, 0.1)), through ``ical(algorithm=
    "mmclean", calibration_context="TB")``, fused and composed, 4 cycles
    each. Gates: the spectral index within INDEX_TOL of the sky's on
    both, each channel's B phases within 0.5 of the truth, the two paths'
    B phases within TB_TOL and their residual peaks within TB_TOL, every
    kernel of each path launched (and the fused cube's batched legs).
    Returns the summed launch counts."""
    import torch

    from ska_sdp_func_python_torch.pipeline import ical

    vis, model = simulate_cube(device, **CUBE)
    corrupted, truth = corrupt_terms(vis, [("T", None, 0.4, 0.0), B_TERM], seed=44)
    del vis
    out, total = {}, None
    for label, fused in (("fused", True), ("composed", False)):
        name = f"TB ical {label}"
        with solve_timer("TB") as times:
            (current, res, _, gts), counts, peaks = run_logged(
                name,
                lambda: ical(corrupted, model, nmajor=4, calibration_context="TB",
                             context="ng", fused=fused, **CUBE_CLEAN),
                4, ("grid", "degrid", "permute", "msmfs"),
            )
        _steady_solves(name, times)
        if fused:
            _cube_launch_gate(name, counts, 4)
        index = cube_gates(name, current, peaks, CUBE["offset"], CUBE["alpha"], gate=False)
        b = gains_of(gts["B"])
        berr = channel_phase_error(b, truth["B"])
        say(f"{name}: B gains vs truth, largest per-channel difference {berr:.4f} (bound 0.5)")
        if not abs(index - CUBE["alpha"]) < INDEX_TOL:
            raise AssertionError(f"{name}: spectral index {index} not within {INDEX_TOL}")
        if not berr < 0.5:
            raise AssertionError(f"{name}: B gains {berr} from the truth")
        out[label] = (b, peaks[-1])
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
        del current, res, gts
        torch.cuda.empty_cache()
    (bf, rf), (bc, rc) = out["fused"], out["composed"]
    apart = channel_phase_error(bf, bc)
    say(
        f"TB ical fused vs composed: B gains {apart:.3e} apart (bound {TB_TOL}), "
        f"residual peak {rf:.6f} vs {rc:.6f} (bound {TB_TOL})"
    )
    if not (apart < TB_TOL and abs(rf - rc) < TB_TOL):
        raise AssertionError("TB ical: the fused and composed paths disagree")
    return total


def tg_slice(device, **kw):
    """The composed "TG" ical with a sky component on ``device``: phase
    7's small observation also corrupted by "G" gains in 60 s bins, the
    2.0 Jy source given as a SkyComponents (restored by
    ``restore_skycomponent``), Hogbom, 3 cycles. Returns (referenced
    gains {T, G}, model, residual, restored, components, launch counts)."""
    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.models import SkyComponents
    from ska_sdp_func_python_torch.pipeline import ical

    _, vis, model, _ = simulate(device, rmax=600.0, ntimes=8, npixel=256)
    vis, _ = corrupt_terms(vis, [G_TERM], seed=43)
    n = model.npixel
    comps = SkyComponents.from_lists(
        [model.pixel_to_radec(n // 2, n // 2)], [[[2.0]]], vis.frequency, device=device
    )
    kernels.reset_launch_counts()
    d, r, s, g = ical(
        vis, model, components=comps, nmajor=3, calibration_context="TG",
        context="ng", algorithm="hogbom", **{**dict(fused=False), **CLEAN, **kw},
    )
    gains = {t: referenced(gains_of(g[t])) for t in "TG"}
    return gains, d, r, s, comps, kernels.launch_counts()


def tb_slice(device):
    """The fused "TB" ical on the bandpass cube of the JAX package's test
    (test_bandpass.py:179-200) on ``device``, Hogbom, 4 cycles, each CLEAN
    to a fractional threshold of 0.2 (the test's 0.01 runs all 300
    iterations into sidelobe peaks that tie below f32 rounding: there the
    card's and the CPU's gains came out 1.1e-6 apart in one run and
    1.4e-3 in another, and either device alone moved between the two
    outcomes). Returns (referenced gains {T, B}, residual, launch
    counts)."""
    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.pipeline import ical

    vis, model = simulate_cube(device, **BANDPASS_CUBE)
    vis, _ = corrupt_terms(vis, [B_TERM], seed=45)
    kernels.reset_launch_counts()
    _, r, _, g = ical(
        vis, model, nmajor=4, calibration_context="TB", context="ng",
        algorithm="hogbom", niter=300, gain=0.2, fractional_threshold=0.2,
    )
    return {t: referenced(gains_of(g[t])) for t in "TB"}, r, kernels.launch_counts()


def slices_agree(label, gains_a, res_a, gains_b, res_b):
    """Phase 7's bounds between a card run and a CPU run: referenced gains
    within 1e-4, peak residuals within 1e-3 relative. Returns the printed
    numbers."""
    dg = max(float(np.max(np.abs(gains_a[t] - gains_b[t]))) for t in gains_a)
    ra, rb = float(res_a.pixels.abs().max()), float(res_b.pixels.abs().max())
    say(f"{label} card vs cpu: gains {dg:.2e} (bound 1e-4), residual peak "
        f"{ra:.6f} vs {rb:.6f} (bound 1e-3 rel)")
    if not (dg < 1e-4 and abs(ra - rb) < 1e-3 * rb):
        raise AssertionError(f"{label}: card and cpu disagree")


def selfcal_repeats(device, nfull, nresume):
    """Phase 10c's checkpoint observation: the fused "TG" ical of phase
    7's small observation with "G" gains, Hogbom, 4 cycles, run ``nfull``
    times uninterrupted and ``nresume`` times resumed at cycle 2 from a
    checkpoint loaded onto ``device``. Returns the (largest |model
    difference|, |residual-peak difference|) of each later run from the
    first: (repeats, resumes)."""
    import tempfile

    from ska_sdp_func_python_torch.pipeline import SelfCalState, ical

    _, vis, model, _ = simulate(device, rmax=600.0, ntimes=8, npixel=256)
    vis, _ = corrupt_terms(vis, [G_TERM], seed=43)
    kw = dict(calibration_context="TG", context="ng", algorithm="hogbom", **CLEAN)
    first = ical(vis, model, nmajor=4, **kw)
    peak = float(first[1].pixels.abs().max())

    def apart(run):
        return (
            float((run[0].pixels - first[0].pixels).abs().max()),
            abs(float(run[1].pixels.abs().max()) - peak),
        )

    repeats = [apart(ical(vis, model, nmajor=4, **kw)) for _ in range(nfull - 1)]
    resumes = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "selfcal.pkl")
        for _ in range(nresume):
            ical(vis, model, nmajor=2, checkpoint_path=path, **kw)
            state = SelfCalState.load(path, device=device)
            resumes.append(apart(ical(vis, model, nmajor=4, state=state, **kw)))
    return repeats, resumes


def repeat_selfcal(n: int) -> int:
    """``--repeat-selfcal N``: :func:`selfcal_repeats` on the card with N
    uninterrupted runs and N // 3 resumes; prints how many land more than
    1e-6 from the first run and the largest differences."""
    import torch

    from ska_sdp_func_python_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    kernels.build_library()
    say(f"device: {card_line()}")
    t0 = time.perf_counter()
    repeats, resumes = selfcal_repeats(torch.device("cuda", 0), n, n // 3)
    for label, runs in (("uninterrupted", repeats), ("resumed at cycle 2", resumes)):
        a = np.asarray(runs).reshape(-1, 2)
        say(
            f"{label}: {len(runs)} runs, {int((a.max(1) > 1e-6).sum())} more than "
            f"1e-6 from the first; model differences: median {np.median(a[:, 0]):.3e}, "
            f"largest {a[:, 0].max():.3e}; residual peaks: largest {a[:, 1].max():.3e}"
        )
    say(f"{time.perf_counter() - t0:.1f} s")
    return 0


def small_calibration_slices(device):
    """Phase 10c: the composed "TG" ical with a sky component and the
    fused "TB" bandpass cube on the card and on the CPU, to phase 7's
    bounds (the restored peaks with the CPU run's clean beam within 0.05),
    and on the card (:func:`selfcal_repeats`) a second uninterrupted run
    and a checkpoint resume (2 cycles saved, then ``state=`` to 4), each
    equal to the first run to 1e-6."""
    import torch

    from ska_sdp_func_python_torch.ops.deconvolution import restore_cube
    from ska_sdp_func_python_torch.ops.skycomponent_ops import restore_skycomponent

    runs = {dev: tg_slice(dev) for dev in (device, "cpu")}
    (ga, da, ra, _, ca, counts), (gb, _, rb, sb, _, _) = runs[device], runs["cpu"]
    _launch_gate("small TG composed", counts, ("grid", "degrid", "permute", "hogbom"))
    slices_agree("small TG composed with a component", ga, ra, gb, rb)
    beam = dict(zip(("bmaj", "bmin", "bpa"), np.rad2deg(sb.clean_beam)))
    peak_a = float(restore_skycomponent(
        restore_cube(da, residual=ra, clean_beam=beam), ca, beam).pixels.max())
    peak_b = float(sb.pixels.max())
    say(f"small TG composed: restored with one beam {peak_a:.4f} vs {peak_b:.4f} (bound 0.05)")
    if not abs(peak_a - peak_b) < 0.05:
        raise AssertionError("small TG composed: restored peaks disagree")

    runs = {dev: tb_slice(dev) for dev in (device, "cpu")}
    (ga, ra, counts), (gb, rb, _) = runs[device], runs["cpu"]
    _launch_gate("small TB fused", counts, ("grid", "degrid", "permute", "hogbom"))
    slices_agree("small TB fused cube", ga, ra, gb, rb)

    [(rm, rr)], [(dm, dr)] = selfcal_repeats(device, 2, 1)
    say(f"fused TG on the card, 4 cycles: a second run {rm:.3e} (model), {rr:.3e} "
        f"(residual peak) from the first (bound 1e-6)")
    say(f"checkpoint resume at cycle 2 of 4 (fused TG, card): model {dm:.3e}, "
        f"residual peak {dr:.3e} from the uninterrupted run (bound 1e-6)")
    if not (rm < 1e-6 and rr < 1e-6):
        raise AssertionError("a second run differs from the first")
    if not (dm < 1e-6 and dr < 1e-6):
        raise AssertionError("checkpoint resume differs from the uninterrupted run")
    torch.cuda.empty_cache()


def simulate_polarised(cfg, device, ntimes=76, npixel=1024):
    """Phase 11's flagship: phase 4's layout, hour angles and uniform
    weights with linear visibilities (9,942,016 rows x 4 polarisations) of
    the three SOURCES at fractional Q and U, a linear 1024^2 model, and
    SEED_FRACTION of each source as stokesIQUV components. Returns (vis,
    model, seed components)."""
    from ska_sdp_func_python_torch.models import SkyComponents, create_visibility
    from ska_sdp_func_python_torch.ops import (
        create_image_from_visibility,
        dft_skycomponent_visibility,
    )
    from ska_sdp_func_python_torch.ops.weighting import weight_visibility

    vis = create_visibility(
        cfg, np.linspace(-0.3, 0.3, ntimes), [1.2e8], polarisation_frame="linear",
        elevation_limit=np.deg2rad(15.0), device=device,
    )
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=3.0, nchan=1)
    scale = npixel / 1024
    dirs = [
        [float(c) for c in model.pixel_to_radec(npixel // 2 + int(dx * scale),
                                                npixel // 2 + int(dy * scale))]
        for dx, dy, _ in SOURCES
    ]
    fluxes = np.asarray([[[f, POL_FRAC_Q * f, POL_FRAC_U * f, 0.0]] for _, _, f in SOURCES])

    def components(scale):
        return SkyComponents.from_lists(dirs, scale * fluxes, vis.frequency,
                                        polarisation_frame="stokesIQUV", device=device)

    vis = dft_skycomponent_visibility(vis, components(1.0))
    return (weight_visibility(vis, model, weighting="uniform"), model,
            components(SEED_FRACTION))


def corrupt_jones(vis, phase, amp=0.0, leak=0.0, seed=47, jones_type="T", timeslice=None):
    """``vis`` times 2x2 Jones per (interval, station, solution channel):
    both receptors (1 + N(0, amp)) exp(i N(0, phase)) (the same draw, as
    the JAX tests' ``_simulate_gaintable``), and with ``leak`` off-diagonal
    leakage leak (N + i N) and conj(that) * 0.7 (test_composite.py:789-797).
    Returns (corrupted vis, true gains [ntab, nants, nchan, 2, 2]
    complex128)."""
    import torch

    from ska_sdp_func_python_torch.models import create_gaintable_from_visibility
    from ska_sdp_func_python_torch.ops import apply_gaintable

    rng = np.random.default_rng(seed)
    gt = create_gaintable_from_visibility(vis, jones_type=jones_type, timeslice=timeslice)
    shape = gt.gain.shape[:3]
    g = (1.0 + rng.normal(0, amp, shape)) * np.exp(1j * rng.normal(0, phase, shape))
    true = np.zeros(shape + (2, 2), complex)
    true[..., 0, 0] = true[..., 1, 1] = g
    if leak:
        lk = leak * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
        true[..., 0, 1], true[..., 1, 0] = lk, np.conj(lk) * 0.7
    gain = torch.as_tensor(true, device=vis.device).to(gt.gain.dtype)
    return apply_gaintable(vis, gt.replace(gain=gain)), true


def receptor_phase_error(solved, true):
    """Max and rms phase error (rad) of each receptor's solved gain against
    the truth, both referenced to station 0."""
    g = solved.detach().cpu().numpy()
    errs = []
    for r in range(2):
        s, t = g[..., 0, r, r], true[..., 0, r, r]
        s = s * np.exp(-1j * np.angle(s[:, :1]))
        t = t * np.exp(-1j * np.angle(t[:, :1]))
        errs.append(np.angle(s * np.conj(t)))
    err = np.stack(errs)
    return float(np.max(np.abs(err))), float(np.sqrt(np.mean(err**2)))


@contextlib.contextmanager
def mueller_timer():
    """Times the Mueller leg of the fused cycle (the full-Jones inverse
    and every Mueller apply, synchronised before and after) while the
    context is open; yields a list of ms per call."""
    import torch

    from ska_sdp_func_python_torch import pipeline

    times, fns = [], (pipeline._crosspol_inverse, pipeline._mueller_apply)

    def timed_call(fn):
        def call(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    pipeline._crosspol_inverse, pipeline._mueller_apply = (timed_call(f) for f in fns)
    try:
        yield times
    finally:
        pipeline._crosspol_inverse, pipeline._mueller_apply = fns


def _npol_launch_gate(label, counts, nmajor, npol, nchan=1, cal=True, clean=None):
    """The fused cycle's launches at ``npol``: K1 once a (cycle,
    polarisation, image channel) and once a channel for the PSF, K3 once a
    (cycle with a model, polarisation), K4 once a polarisation for the
    workspace and, with calibration, once a leg of a cycle (the model to
    natural order, the correction to plan order), whatever ``npol``."""
    want = {
        "grid": nchan * (npol * nmajor + 1),
        "degrid": npol * (nmajor - 1),
        "permute": npol + (2 * nmajor if cal else 0),
    }
    if clean is not None:
        want[clean[0]] = clean[1]
    got = {k: counts[k] for k in want}
    say(f"{label}: launches {got}, expected {want}")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def run_polarised_flagship(cfg, device, **size):
    """Phase 11a-b: the polarised flagship, the sky seeded with
    SEED_FRACTION of its flux. (a) diagonal "T" phases N(0, 0.4) through
    ``ical`` with msclean, fused and composed, 3 cycles each; (b) the same
    sky with 8% leakage and 5% amplitudes, a "matrix" "T" (amplitude and
    phase) with Hogbom, fused and composed, then a fused run instrumented
    to time the Mueller leg. Holds K4 with four payloads in one launch and
    K5 on the npol-4 lanes against their plain versions. Returns (summed
    launch counts, {kernel: row})."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops import cleaners as cl
    from ska_sdp_func_python_torch.ops.calibration_chain import create_calibration_controls
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan
    from ska_sdp_func_python_torch.ops.permute import permute_apply, permute_apply_plain
    from ska_sdp_func_python_torch import pipeline

    t0 = time.perf_counter()
    vis, model, sky = simulate_polarised(cfg, device, **size)
    torch.cuda.synchronize()
    say(f"polarised flagship: {vis.ntimes * vis.nbaselines} rows x {vis.npol} "
        f"polarisations ({vis.polarisation_frame}), {model.npixel}^2 "
        f"{model.polarisation_frame} model, simulated in {time.perf_counter() - t0:.1f} s")

    # K4 with the four polarisations of the cycle's model leg in one launch
    plan = make_visibility_plan(vis, model, context="ng")
    st = plan.stack
    g = torch.Generator(device=device).manual_seed(4)
    xs = [torch.randn(st.perm.shape, generator=g, device=device, dtype=torch.complex64)
          for _ in range(4)]
    if not all(torch.equal(a, b) for a, b in zip(permute_apply(st.iperm, *xs),
                                                  permute_apply_plain(st.iperm, *xs))):
        raise AssertionError("permute with four payloads is not bit-exact")
    one = timed(lambda: permute_apply(st.iperm, *xs), 20)
    each = timed(lambda: [permute_apply(st.iperm, x) for x in xs], 20)
    say(f"permute, four complex64 payloads of {st.n} in one launch, bit-exact: "
        f"{one:.4f} ms (four launches {each:.4f} ms; plain "
        f"{timed(lambda: permute_apply_plain(st.iperm, *xs), 5):.4f} ms), bound "
        f"{permute_bound(st.n, npay=4)[0]:.4f} ms")
    del xs, plan, st
    torch.cuda.empty_cache()

    total, rows = None, {}
    corrupted, true = corrupt_jones(vis, 0.4)
    out = {}
    for label, fused in (("fused", True), ("composed", False)):
        name = f"npol-4 ical {label}"
        torch.cuda.reset_peak_memory_stats()
        (_, res, restored, gts), counts, peaks = run_logged(
            name,
            lambda: pipeline.ical(corrupted, model, components=sky, nmajor=3,
                                  calibration_context="T", context="ng", fused=fused,
                                  scales=SCALES, **CLEAN),
            3, ("grid", "degrid", "permute", "msclean"),
        )
        gmax, grms = receptor_phase_error(gts["T"].gain, true)
        xx_res = float(res.pixels[0, 0].abs().max())
        # the restore adds each seed component's [I, Q, U, V] to the
        # image's polarisations in order, as the JAX package does (I to
        # XX), and CLEAN's XX model the rest of I + Q: I + 0.2 Q a source
        px = restored.pixels[0, 0].detach().cpu().numpy()
        n, scale = model.npixel, model.npixel / 1024
        flux_i = [float(px[n // 2 + int(dy * scale), n // 2 + int(dx * scale)])
                  for dx, dy, _ in SOURCES]
        say(f"{name}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"gain phase error vs truth (each receptor, station 0's phase out) max "
            f"{gmax:.3e} rad, rms {grms:.3e}; restored I (XX) at the sources "
            + ", ".join(f"{v:.4f}" for v in flux_i)
            + f" (sky {', '.join(str(f) for _, _, f in SOURCES)}); XX residual peak "
            f"{xx_res:.6f} (bound {NPOL4_XX_RESIDUAL})")
        if fused:
            _npol_launch_gate(name, counts, 3, 4, clean=("msclean", 3))
        if not xx_res < NPOL4_XX_RESIDUAL:
            raise AssertionError(f"{name}: XX residual peak {xx_res} not below "
                                 f"{NPOL4_XX_RESIDUAL}")
        if not all(abs(v - f) < 0.2 for v, (_, _, f) in zip(flux_i, SOURCES)):
            raise AssertionError(f"{name}: restored I {flux_i} not within 0.2 of the sky")
        if not gmax < 0.05:
            raise AssertionError(f"{name}: gain phase error {gmax} rad")
        g = gts["T"].gain.detach().cpu().numpy()
        out[label] = (peaks[-1], float(restored.pixels.abs().max()),
                      g * np.exp(-1j * np.angle(g[:, :1])))
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
        del res, restored, gts
    (rf, sf, gf), (rc, sc, gc) = out["fused"], out["composed"]
    dg = float(np.max(np.abs(gf - gc)))
    say(f"npol-4 ical fused vs composed: residual peak {rf:.6f} vs {rc:.6f}, restored "
        f"peak {sf:.4f} vs {sc:.4f} (bound {NPOL4_RESTORED_TOL}), phase-referenced "
        f"gains {dg:.3e} apart (bound {JONES_GAIN_TOL})")
    if not (abs(sf - sc) < NPOL4_RESTORED_TOL and dg < JONES_GAIN_TOL):
        raise AssertionError("npol-4 ical: the fused and composed paths disagree")
    del corrupted
    torch.cuda.empty_cache()

    corrupted, _ = corrupt_jones(vis, 0.2, amp=0.05, leak=LEAK)
    controls = create_calibration_controls()
    controls["T"] = dict(controls["T"], shape="matrix", phase_only=False)

    def full_jones(fused, nmajor=3):
        return pipeline.ical(corrupted, model, components=sky, nmajor=nmajor,
                             calibration_context="T", controls=controls, context="ng",
                             fused=fused, algorithm="hogbom", **CLEAN)

    out = {}
    for label, fused in (("fused", True), ("composed", False)):
        name = f"full-Jones ical {label}"
        torch.cuda.reset_peak_memory_stats()
        (_, res, _, gts), counts, peaks = run_logged(
            name, lambda: full_jones(fused), 3, ("grid", "degrid", "permute", "hogbom"),
        )
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        xx_res = float(res.pixels[0, 0].abs().max())
        # full-Jones self-cal has a unitary gauge freedom a station, so
        # parity with the composed cycle is its test, not an absolute
        # residual (test_composite.py:815-818)
        say(f"{name}: peak memory {peak_gb:.2f} GiB; XX residual peak {xx_res:.6f}")
        if fused:
            _npol_launch_gate(name, counts, 3, 4, clean=("hogbom", 3))
            if not peak_gb < PEAK_MEMORY_GB:
                raise AssertionError(f"{name}: peak memory {peak_gb:.2f} GiB")
        out[label] = (peaks[-1], gts["T"].gain.detach().cpu().numpy())
        total = {k: total[k] + counts[k] for k in total}
        del res, gts
    (rf, gf), (rc, gc) = out["fused"], out["composed"]
    dg = float(np.max(np.abs(gf - gc)) / max(np.max(np.abs(gc)), 1.0))
    say(f"full-Jones ical fused vs composed: residual peak {rf:.6f} vs {rc:.6f} "
        f"(bound {JONES_RESIDUAL_TOL}), gains {dg:.3e} apart (bound {JONES_GAIN_TOL})")
    if not (abs(rf - rc) < JONES_RESIDUAL_TOL and dg < JONES_GAIN_TOL):
        raise AssertionError("full-Jones ical: the fused and composed paths disagree")

    # a third, instrumented fused run (its walls are not the cycle's):
    # the Mueller leg timed call by call and the first CLEAN call's inputs
    inputs = []

    def recording(dirty, psf, window=None, **kw):
        if not inputs:
            inputs.append((dirty.clone(), psf.clone(), kw))
        return cl.hogbom_lanes(dirty, psf, window, **kw)

    pipeline.hogbom_lanes = recording
    try:
        with mueller_timer() as mtimes:
            kernels.reset_launch_counts()
            full_jones(True, nmajor=2)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
    finally:
        pipeline.hogbom_lanes = cl.hogbom_lanes
    total = {k: total[k] + counts[k] for k in total}
    say("full-Jones ical fused, instrumented, 2 cycles: Mueller leg ms per call "
        + ", ".join(f"{t:.2f}" for t in mtimes))
    if not (mtimes and inputs):
        raise AssertionError("full-Jones ical: the Mueller leg or CLEAN was not observed")
    # K5 on the npol-4 lanes of the first CLEAN call (three without a PSF)
    d, p, kw = inputs[0]
    rows["hogbom"] = hogbom_case("npol-4 Hogbom lanes", "hogbom", 1, (d,), p, None, kw,
                                 plain_reps=1)
    del corrupted, inputs, d, p
    torch.cuda.empty_cache()
    return total, rows


def mfs_sum_of_channels(vis, plan, model):
    """The MFS plan's unnormalised dirty image (one K1 launch over the
    whole stream) against the sum of each channel's on a plan of the same
    geometry (the MFS plan's w planes and range). Returns the relative
    difference."""
    import torch

    from ska_sdp_func_python_torch.ops.imaging import invert_with_plan, make_imaging_plan

    uvw = vis.uvw_lambda
    w = uvw[..., 2]
    vals = (vis.vis * vis.imaging_weight)[..., 0]
    mfs, _ = invert_with_plan(plan.plans[0], vals.reshape(-1))
    total = torch.zeros_like(mfs)
    w_range = (float(w.min()), float(w.max()))
    for c in range(vis.nchan):
        ip = make_imaging_plan(
            uvw[:, :, c, 0].reshape(-1), uvw[:, :, c, 1].reshape(-1), w[:, :, c].reshape(-1),
            npixel=model.npixel, cellsize=model.cellsize, nw=plan.nw, padding=1.25,
            w_range=w_range,
        )
        total += invert_with_plan(ip, vals[:, :, c].reshape(-1))[0]
    return float((mfs - total).abs().max()) / float(total.abs().max())


def run_mfs(device, cube_size=CUBE):
    """Phase 11c: the config-4 cube's 64 channels imaged to one MFS
    channel of 256^2. Holds K1 and K3 on the MFS plan's row (and K4's
    moves of it) and K7 on the MFS dirty image against their plain
    versions, the MFS invert against the sum of the channels' (same plan
    geometry); then ``continuum_imaging`` and a "TB" ``ical`` (T phases
    N(0, 0.4), phase 10b's B table) with msclean, fused and composed, 3
    cycles each. Returns (summed launch counts, {kernel: row})."""
    import torch

    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import invert_visibility, make_visibility_plan
    from ska_sdp_func_python_torch.pipeline import continuum_imaging, ical

    vis, cube = simulate_cube(device, **cube_size)
    model = cube.replace(
        pixels=cube.pixels[:1].clone(), frequency=np.array([np.mean(cube.frequency)]),
        channel_bandwidth=np.array([np.sum(cube.channel_bandwidth)]),
    )
    del cube
    t0 = time.perf_counter()
    plan = make_visibility_plan(vis, model, context="ng")
    torch.cuda.synchronize()
    gp = plan.plans[0].gp
    say(f"MFS plan: {vis.nchan} channels into one {model.npixel}^2 image: one plan "
        f"of {gp.n} entries ({gp.n_in} in the grid), npad {plan.plans[0].npad}, nw "
        f"{plan.nw}, built in {time.perf_counter() - t0:.2f} s")
    rows = {}
    weighted = (vis.vis * vis.imaging_weight)[..., 0].reshape(-1)
    rows["grid"] = grid_row(gp, sort_values(gp, weighted), "MFS plan (one launch a cycle)")
    del weighted
    stack_shapes(plan, "MFS plan")
    rel = mfs_sum_of_channels(vis, plan, model)
    say(f"MFS invert vs the sum of the {vis.nchan} channels' (same geometry): "
        f"{rel:.3e} of the image maximum (bound {MFS_TOL})")
    if not rel < MFS_TOL:
        raise AssertionError("MFS invert differs from the sum of its channels")
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    dirty, _ = invert_visibility(vis, model, plan=plan)
    kw = dict(gain=CLEAN["gain"], thresh=0.0, niter=CLEAN["niter"],
              fracthresh=CLEAN["fractional_threshold"])
    patch = bound_psf(psf, psf).pixels[0, 0].to(torch.float32)
    rows["msclean"] = msclean_case("msclean MFS", dirty.pixels[0, 0].to(torch.float32),
                                   patch, kw, with_floor=False)
    del psf, dirty, patch, plan, gp
    torch.cuda.empty_cache()

    clean = dict(scales=SCALES, **CLEAN)
    total, out = None, {}
    for label, fused in (("fused", True), ("composed", False)):
        name = f"MFS continuum_imaging {label}"
        (current, res, restored), counts, peaks = run_logged(
            name,
            lambda: continuum_imaging(vis, model, nmajor=3, context="ng", fused=fused,
                                      **clean),
            3, ("grid", "degrid", "msclean"),
        )
        if fused:
            _npol_launch_gate(name, counts, 3, 1, cal=False, clean=("msclean", 3))
        flux = model_flux_near(current, 0, cube_size["offset"])
        say(f"{name}: model flux within 10 px of the source {flux:.4f}")
        out[label] = (peaks[-1], float(restored.pixels.max()))
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    (rf, sf), (rc, sc) = out["fused"], out["composed"]
    say(f"MFS continuum_imaging fused vs composed: residual peak {rf:.6f} vs {rc:.6f} "
        f"(bound 1e-3 relative), restored peak {sf:.4f} vs {sc:.4f} (bound 0.05)")
    if not (abs(rf - rc) < 1e-3 * rc and abs(sf - sc) < 0.05):
        raise AssertionError("MFS continuum_imaging: the fused and composed paths disagree")

    corrupted, truth = corrupt_terms(vis, [("T", None, 0.4, 0.0), B_TERM], seed=44)
    del vis
    out = {}
    for label, fused in (("fused", True), ("composed", False)):
        name = f"MFS TB ical {label}"
        with solve_timer("TB") as times:
            (_, res, _, gts), counts, peaks = run_logged(
                name,
                lambda: ical(corrupted, model, nmajor=3, calibration_context="TB",
                             context="ng", fused=fused, **clean),
                3, ("grid", "degrid", "permute", "msclean"),
            )
        _steady_solves(name, times)
        if fused:
            _npol_launch_gate(name, counts, 3, 1, clean=("msclean", 3))
        b = gains_of(gts["B"])
        berr = channel_phase_error(b, truth["B"])
        say(f"{name}: B gains vs truth, largest per-channel difference {berr:.4f} (bound 0.5)")
        if not berr < 0.5:
            raise AssertionError(f"{name}: B gains {berr} from the truth")
        out[label] = (b, peaks[-1])
        total = {k: total[k] + counts[k] for k in total}
        del res, gts
    (bf, rf), (bc, rc) = out["fused"], out["composed"]
    apart = channel_phase_error(bf, bc)
    say(f"MFS TB ical fused vs composed: B gains {apart:.3e} apart (bound {TB_TOL}), "
        f"residual peak {rf:.6f} vs {rc:.6f} (bound {TB_TOL})")
    if not (apart < TB_TOL and abs(rf - rc) < TB_TOL):
        raise AssertionError("MFS TB ical: the fused and composed paths disagree")
    del corrupted
    torch.cuda.empty_cache()
    return total, rows


def jones_slice(device):
    """Phase 11d on ``device``: the "matrix" "T" (8% leakage, 5%
    amplitudes) + "B" chain on the bandpass cube's layout with linear
    visibilities imaged MFS (a linear 128^2 model) and a polarised
    component seeding the sky, fused, Hogbom to a fractional threshold of
    0.2, 2 cycles. Returns (gains {T, B}, residual, launch counts)."""
    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.models import SkyComponents, create_visibility_from_arrays
    from ska_sdp_func_python_torch.ops import dft_skycomponent_visibility
    from ska_sdp_func_python_torch.ops.calibration_chain import create_calibration_controls
    from ska_sdp_func_python_torch.ops.imaging import create_image_from_visibility
    from ska_sdp_func_python_torch.pipeline import ical

    # the bandpass cube's layout, hour angles and channels, in the linear frame
    cube, _ = simulate_cube(device, **SMALL_JONES)
    vis = create_visibility_from_arrays(
        **{k: getattr(cube, k).cpu().numpy()
           for k in ("uvw", "time", "frequency", "antenna1", "antenna2")},
        phasecentre=cube.phasecentre, polarisation_frame="linear", nants=cube.nants,
        device=device,
    )
    model = create_image_from_visibility(vis, npixel=SMALL_JONES["npixel"],
                                         oversampling=SMALL_JONES["oversampling"], nchan=1)
    n, (dx, dy) = model.npixel, SMALL_JONES["offset"]
    sky = SkyComponents.from_lists(
        [[float(c) for c in model.pixel_to_radec(n // 2 + dx, n // 2 + dy)]],
        np.tile(np.asarray([[[2.0, 0.3, 0.15, 0.0]]]), (1, vis.nchan, 1)),
        vis.frequency, polarisation_frame="stokesIQUV", device=device,
    )
    vis = dft_skycomponent_visibility(vis, sky)
    vis, _ = corrupt_jones(vis, 0.2, amp=0.05, leak=LEAK, seed=48)
    vis, _ = corrupt_jones(vis, 0.1, amp=0.05, seed=49, jones_type="B", timeslice=1e5)
    controls = create_calibration_controls()
    controls["T"] = dict(controls["T"], shape="matrix", phase_only=False)
    controls["B"] = dict(controls["B"], first_selfcal=0)
    kernels.reset_launch_counts()
    _, r, _, g = ical(
        vis, model, components=sky, nmajor=2, calibration_context="TB",
        controls=controls, context="ng", algorithm="hogbom", niter=300, gain=0.2,
        fractional_threshold=0.2,
    )
    return {t: g[t].gain.detach().cpu().numpy() for t in "TB"}, r, kernels.launch_counts()


def small_jones_slice(device):
    """Phase 11d: :func:`jones_slice` on the card and on the CPU: every
    gain entry within 1e-4 relative, residual peaks within 1e-3 relative."""
    runs = {dev: jones_slice(dev) for dev in (device, "cpu")}
    (ga, ra, counts), (gb, rb, _) = runs[device], runs["cpu"]
    _launch_gate("small full-Jones MFS fused", counts, ("grid", "degrid", "permute", "hogbom"))
    dg = max(float(np.max(np.abs(ga[t] - gb[t])) / max(np.max(np.abs(gb[t])), 1.0))
             for t in "TB")
    pa, pb = float(ra.pixels.abs().max()), float(rb.pixels.abs().max())
    say(f"small full-Jones T + B MFS card vs cpu: gains {dg:.2e} (bound 1e-4), "
        f"residual peak {pa:.6f} vs {pb:.6f} (bound 1e-3 rel)")
    if not (dg < 1e-4 and abs(pa - pb) < 1e-3 * pb):
        raise AssertionError("small full-Jones MFS: card and cpu disagree")


def observation9(cfg, device, dtype, ntimes=76, npixel=1024, source=SOURCE9):
    """Phase 9's observation: the flagship layout and hour angles with
    natural weights, in ``dtype`` on ``device``, holding the exact DFT of
    a 1.0 Jy source at SOURCE9, and the 1024^2 model image holding that
    source. Returns (vis, model, oracle [ntime, nbaseline, 1, 1] complex128
    on the host, the source's (ix, iy))."""
    import torch

    from ska_sdp_func_python_torch.models import create_visibility
    from ska_sdp_func_python_torch.ops import create_image_from_visibility

    vis = create_visibility(
        cfg, np.linspace(-0.3, 0.3, ntimes), [1.2e8],
        elevation_limit=np.deg2rad(15.0), dtype=dtype, device=device,
    )
    model = create_image_from_visibility(vis, npixel=npixel, oversampling=3.0, nchan=1)
    ix, iy = npixel // 2 + source[0], npixel // 2 + source[1]
    oracle = exact_dft(vis, model, ix, iy)
    vis = vis.replace(vis=torch.as_tensor(oracle).to(device=device, dtype=vis.vis.dtype))
    pixels = torch.zeros_like(model.pixels)
    pixels[0, 0, iy, ix] = 1.0
    return vis, model.replace(pixels=pixels), oracle, (ix, iy)


def exact_dft(vis, model, ix, iy):
    """exp(-2 pi i (u l + v m + w (n - 1))) of a 1.0 Jy source at pixel
    (ix, iy), in numpy f64 on the host from the Visibility's own uvw."""
    from ska_sdp_func_python_torch.models.visibility import C_M_S
    from ska_sdp_func_python_torch.utils.coordinates import radec_to_lmn

    ra, dec = model.pixel_to_radec(ix, iy)
    l, m, n1 = radec_to_lmn(ra, dec, *vis.phasecentre)
    f = vis.frequency.cpu().numpy().astype(np.float64)[0] / C_M_S
    uvw = vis.uvw.cpu().numpy().astype(np.float64) * f
    turns = uvw[..., 0] * l + uvw[..., 1] * m + uvw[..., 2] * n1
    return np.exp(-2j * np.pi * turns)[..., None, None]


def unit_stream9(vis, model, eps):
    """The entry stream that ``invert_visibility(vis, model,
    epsilon=eps)`` grids through unit_tiles, built as the core path
    builds it, and its geometry."""
    from ska_sdp_func_python_torch.ops import imaging as im
    from ska_sdp_func_python_torch.ops.accuracy import gridding_params_for_epsilon
    from ska_sdp_func_python_torch.ops.gridding import _es_beta
    from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream

    acc = gridding_params_for_epsilon(eps, f64=im._is_f64(vis))
    assert acc.gridder == "tiled" or acc.support != 8, acc
    s = acc.support
    npad = im._npad_for(model.npixel, acc.padding)
    nw = im._nw_wkernel_for(vis, model, s)
    if acc.coords == "host64":
        u, ulo, v, vlo, w = im._prepix_rows(vis, model, slice(0, 1), npad)
    else:
        uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
        u, v = im._pixels(uvw[:, 0], uvw[:, 1], npad, model.cellsize, False)
        ulo = vlo = None
        w = uvw[:, 2]
    p0, frac, _ = im._w_planes(w, nw, "eskernel", w_support=s)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    geo = dict(npixel=npad, tile=im._tile_for(npad), support=s,
               beta=_es_beta(s, npad / model.npixel))
    stream = entry_stream(
        u, v, weighted, p0, frac, ulo, vlo, npixel=npad, support=s,
        nplanes=nw, tile=geo["tile"], unit=im._UNIT_GRID, w_order=s,
    )
    return stream, geo


def unit_tiles_bound(stream, geo, peak_ops):
    """(ms, what bounds it) of unit_tiles on ``stream``: bytes, every sorted
    entry's coordinates, residuals and value read once, the unit table
    read once, every plane grid written once; operations, the separable
    work as grid_bound counts it: per entry 2 s ES taps (about 10
    operations each), the value scaled by each of s column taps (2 each),
    then per cell of the s x s window a complex scale by its row tap and
    add (4)."""
    n = int(stream.u.shape[0])
    s = geo["support"]
    real = stream.u.element_size()
    nbytes = (
        n * (real * (2 + (2 if stream.u_lo is not None else 0)) + 2 * real)
        + 12 * int(stream.unit_seg.shape[0])
        + stream.nplanes * geo["npixel"] ** 2 * 2 * real
    )
    return bound(nbytes, n * (4 * s * s + 22 * s), peak_ops)


def compare_unit_tiles(stream, geo, label, tol, peak_ops, plain_at=None, reps=5,
                       plain_f64=True):
    """unit_tiles against its plain version accumulated in f64 on the
    same stream (``plain_at``: (stream, geometry) of the same visibilities
    on another tile, where the plain version runs in its place;
    ``plain_f64`` False: the plain version in the stream's own precision);
    times both. Returns the kernel row."""
    import dataclasses

    import torch

    def f64(x):
        return None if x is None else x.to(torch.float64)

    ref_src, ref_geo = plain_at or (stream, geo)
    ref_stream = dataclasses.replace(
        ref_src, u=f64(ref_src.u), v=f64(ref_src.v), u_lo=f64(ref_src.u_lo),
        v_lo=f64(ref_src.v_lo), vals=ref_src.vals.to(torch.complex128),
    ) if plain_f64 else ref_src
    out = stream.grid(**geo)
    ref, plain_ms = once_timed(lambda: ref_stream.grid(plain=True, **ref_geo))
    err = float((out.to(torch.complex128) - ref).abs().max())
    peak = float(ref.abs().max())
    # support 1: the ES kernel of half width 0 is zero, so both grids are zero
    rel = err / peak if peak else (0.0 if err == 0 else float("inf"))
    del ref
    # phase 15d: K9 sums in fixed point, so a second launch gives the
    # same bits
    same = torch.equal(stream.grid(**geo), out)
    del out
    n = int(stream.u.shape[0])
    nunits = int(stream.unit_seg.shape[0])
    s = geo["support"]
    row = _row(
        err, rel, timed(lambda: stream.grid(**geo), reps), plain_ms,
        unit_tiles_bound(stream, geo, peak_ops),
    )
    say(
        f"unit_tiles {label}: {n} entries in {nunits} units of at most "
        f"{int(stream.unit_count.max())}, {stream.nplanes} planes of "
        f"{geo['npixel']}^2, tile {geo['tile']}, support {s}: max abs err "
        f"{err:.3e}, rel {rel:.3e} (tolerance {tol:g}); kernel {row['ms']:.3f} "
        f"ms, plain ({'f64' if plain_f64 else 'its own precision'}, one run"
        f"{', at tile ' + str(ref_geo['tile']) if plain_at else ''}) {plain_ms:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}); 15d: a second launch gives the "
        f"same bits: {same}"
    )
    if not rel <= tol:
        raise AssertionError(f"unit_tiles {label} disagrees with its plain version")
    if not same:
        raise AssertionError(f"15d: unit_tiles {label} differs from launch to launch")
    return row


def run_epsilon(label, vis, model, oracle, source, eps, path_kernels):
    """predict_visibility and invert_visibility with ``epsilon=eps`` on the
    card, the launch counters reset just before and read just after;
    gates the delivered predict error against the exact DFT (< eps), the
    dirty image's peak on the source pixel and the path's launches.
    Returns the counts."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        predict_visibility,
    )

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pv = predict_visibility(vis, model, epsilon=eps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dirty, _ = invert_visibility(vis, model, epsilon=eps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    err = float(np.max(np.abs(pv.vis.cpu().numpy().astype(np.complex128) - oracle)))
    img = dirty.pixels[0, 0].double().cpu().numpy()
    iy, ix = np.unravel_index(int(np.argmax(img)), img.shape)
    say(
        f"{label} (epsilon {eps:g}, {tuple(vis.vis.shape)} {vis.vis.dtype}): "
        f"predict {(t1 - t0) * 1e3:.1f} ms, delivered max error vs the exact "
        f"DFT {err:.4e}; invert {(t2 - t1) * 1e3:.1f} ms, peak {img[iy, ix]:.6f} "
        f"at ({ix}, {iy}) (source at {source}); launches {counts}"
    )
    if not np.isfinite(img).all() or not err < eps:
        raise AssertionError(f"{label}: delivered error {err} not below {eps}")
    if (ix, iy) != tuple(source):
        raise AssertionError(f"{label}: dirty peak at {(ix, iy)}, source at {source}")
    _launch_gate(label, counts, path_kernels)
    return counts


def run_plan_cache(vis, model):
    """Phase 9e: invert_visibility and predict_visibility without a plan,
    twice each: the second call of each reuses the plan the first put
    into the cache. Held to an explicit plan at padding 2 (the padding of
    a cache miss): predict bit for bit, invert to 1e-5 of its peak.
    Returns the counts of the four calls."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops import imaging as im

    im._PLAN_CACHE.clear()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    walls, plans = [], []
    for fn in (im.invert_visibility, im.invert_visibility,
               im.predict_visibility, im.predict_visibility):
        t0 = time.perf_counter()
        out = fn(vis, model)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        plans.append([p for _, _, p in im._PLAN_CACHE.values()])
        if fn is im.invert_visibility:
            dirty = out[0].pixels
        else:
            pred = out.vis
    counts = kernels.launch_counts()
    if not all(len(p) == 1 and p[0] is plans[0][0] for p in plans):
        raise AssertionError("plan cache: the calls did not share one cached plan")
    explicit = im.make_visibility_plan(vis, model, padding=2)
    pred_e = im.predict_visibility(vis, model, plan=explicit).vis
    dirty_e = im.invert_visibility(vis, model, plan=explicit)[0].pixels
    same = torch.equal(pred, pred_e)
    derr = float((dirty - dirty_e).abs().max() / dirty_e.abs().max())
    p0 = explicit.plans[0]
    say(
        f"plan cache: invert {walls[0]:.1f} then {walls[1]:.1f} ms, predict "
        f"{walls[2]:.1f} then {walls[3]:.1f} ms (npad {p0.npad}, nw {p0.nw}); "
        f"predict equals the explicit-plan predict bit for bit: {same}; "
        f"invert {derr:.3e} of the peak from the explicit-plan invert; "
        f"launches {counts}"
    )
    im._PLAN_CACHE.clear()
    if not same or not derr <= 1e-5:
        raise AssertionError("plan cache: the cached plan disagrees with the explicit one")
    _launch_gate("plan cache", counts, ("grid", "degrid", "permute"))
    return counts


def run_epsilon_phase(cfg, device, **size):
    """Phase 9 (``size``: observation9's ntimes, npixel and source), and
    phase 13b on its f32 observation. Returns (unit_tiles kernel row,
    summed launch counts of 9b-e, launch counts and kernel rows of 13b)."""
    import torch

    from ska_sdp_func_python_torch.ops import imaging as im

    t0 = time.perf_counter()
    vis, model, oracle, source = observation9(cfg, device, torch.float32, **size)
    say(f"epsilon observation: {vis.nvis} visibilities, f32, simulated in {time.perf_counter() - t0:.1f} s")
    stream, geo = unit_stream9(vis, model, EPS_FAST)
    row = compare_unit_tiles(stream, geo, "fast-f32 stream (f32)", KERNELS["unit_tiles"][0], PEAK_F32_S)
    del stream
    torch.cuda.empty_cache()
    counts = [
        run_epsilon("9b fast-f32", vis, model, oracle, source, EPS_FAST, ("unit_tiles",)),
        run_epsilon("9c precise-f32", vis, model, oracle, source, EPS_PRECISE,
                    ("grid", "degrid", "permute")),
    ]
    im._PLAN_CACHE.clear()
    counts.append(run_plan_cache(vis, model))
    counts_13b, rows_13b = run_nearest_flagship(vis, model, oracle, source)
    del vis, model, oracle
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vis, model, oracle, source = observation9(cfg, device, torch.float64, **size)
    say(f"epsilon observation: {vis.nvis} visibilities, f64, simulated in {time.perf_counter() - t0:.1f} s")
    stream, geo = unit_stream9(vis, model, EPS_DEEP)
    compare_unit_tiles(stream, geo, "deep-f64 stream (f64)", UNIT_TILES_F64_TOL, PEAK_F64_S)
    del stream
    torch.cuda.empty_cache()
    counts.append(run_epsilon("9d deep-f64", vis, model, oracle, source, EPS_DEEP, ("unit_tiles",)))
    del vis, model, oracle
    torch.cuda.empty_cache()
    return row, {k: sum(c[k] for c in counts) for k in counts[0]}, counts_13b, rows_13b


# ---------------------------------------------------------------------------
# phase 12: streamed self-cal over the native visibility store


class _PeakLog(logging.Handler):
    """Collects the peak residual of every cycle a pipeline logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.peaks = []

    def emit(self, record):
        msg = record.getMessage()
        if "peak residual" in msg:
            self.peaks.append(float(msg.rsplit(" ", 1)[1]))


def _falls(label, peaks, nmajor):
    """Every cycle logged a finite peak, each below the one before."""
    if len(peaks) != nmajor or not all(np.isfinite(peaks)):
        raise AssertionError(f"{label}: per-cycle peaks missing or not finite: {peaks}")
    if not all(b < a for a, b in zip(peaks, peaks[1:])):
        raise AssertionError(f"{label}: peak residual did not fall every cycle: {peaks}")


def store_dir(nbytes):
    """A temporary directory for a store of ``nbytes``: under the
    temporary directory if its file system has room (1.5x), else under the
    checkout's build/ (which git ignores). Fails if neither has."""
    import shutil
    import tempfile

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    for base in (tempfile.gettempdir(), build):
        free = shutil.disk_usage(base).free
        say(f"store: {free / 1e9:.1f} GB free under {base}")
        if free > 1.5 * nbytes:
            return tempfile.TemporaryDirectory(dir=base, prefix="svis_")
    raise AssertionError(f"store: no file system has room for {nbytes / 1e9:.1f} GB")


def timed_store(path):
    """A VisStore whose ``wait`` records (end time, seconds waited) in
    ``waits``."""
    from ska_sdp_func_python_torch.io import VisStore

    class Timed(VisStore):
        def wait(self, nt):
            t0 = time.perf_counter()
            out = super().wait(nt)
            t1 = time.perf_counter()
            self.waits.append((t1, t1 - t0))
            return out

    store = Timed(path)
    store.waits = []
    return store


def streamed_run(label, store, model, nmajor, path_kernels, **kw):
    """``streamed_ical`` on the card with the launch counters and the peak
    memory reset just before it and read just after. Prints each cycle's
    seconds (``on_cycle``, after a device fetch), Mvis/s and its seconds
    in ``store.wait`` against the rest; fails unless each kernel of
    ``path_kernels`` launched and the images are finite. Returns (result,
    counts, logged peaks, peak GiB)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.streaming import streamed_ical

    cycles, handler = [], _PeakLog()
    logger = logging.getLogger("ska-sdp-func-python-torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = streamed_ical(
            store, model, model.phasecentre, nmajor=nmajor,
            on_cycle=lambda c, s: cycles.append((time.perf_counter(), s)), **kw,
        )
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = kernels.launch_counts()
    finally:
        logger.removeHandler(handler)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    nvis = store.ntime * store.nbl * store.nchan * store.npol
    say(f"{label}: {nvis} visibilities, total {total:.3f} s, peak memory {peak_gib:.3f} GiB "
        f"({peak_gib - base / 2**30:.3f} above the run's start), launches {counts}, "
        f"peak residuals {handler.peaks}")
    for k, (end, secs) in enumerate(cycles):
        waited = sum(w for t, w in store.waits if end - secs <= t <= end)
        say(f"{label}: cycle {k} {secs:.3f} s, {nvis / secs / 1e6:.2f} Mvis/s; "
            f"store.wait {waited:.3f} s, the rest {secs - waited:.3f} s")
    if not all(torch.isfinite(im.pixels).all() for im in out[:3]):
        raise AssertionError(f"{label}: an output image is not finite")
    _launch_gate(label, counts, path_kernels)
    return out, counts, handler.peaks, peak_gib


def referenced_gains(gt):
    """A scalar table's gains [t, ant] with station 0's phase taken out."""
    g = gt.gain.detach().cpu().numpy()[..., 0, 0, 0]
    return g * np.exp(-1j * np.angle(g[:, :1]))


def streamed_parity(device):
    """Phase 12a: phase 4's "T"-corrupted flagship observation in a store
    (its uniform imaging weights as the store's weights), streamed in
    slabs of 19 integrations, against the in-memory fused ical of the
    Visibility read back whole from the store: 3 cycles of Hogbom each,
    at the bounds of JAX tests/test_io.py:120-132. Returns the launches
    of both runs."""
    from ska_sdp_func_python_torch.models import create_visibility_from_arrays
    from ska_sdp_func_python_torch.io import write_visibility
    from ska_sdp_func_python_torch.pipeline import ical

    _, vis, model, _ = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    path_kernels = ("grid", "degrid", "permute", "hogbom")
    with store_dir(13 * vis.nvis + 24 * vis.ntimes * vis.nbaselines) as tmp:
        path = os.path.join(tmp, "flagship.svis")
        t0 = time.perf_counter()
        write_visibility(vis.replace(weight=vis.imaging_weight), path, chunk_times=STREAM_CHUNK_A)
        say(f"12a store: {vis.nvis} visibilities written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(path) / 1e9:.3f} GB)")
        pc = vis.phasecentre
        del vis
        store = timed_store(path)
        try:
            re, im, wt, fl = store.read_chunk(0, store.ntime)
            back = create_visibility_from_arrays(
                uvw=np.array(store.uvw), time=store.time, frequency=store.frequency,
                antenna1=store.antenna1, antenna2=store.antenna2, vis=re + 1j * im,
                weight=wt, flags=fl, phasecentre=pc, device=device,
            )
            del re, im, wt, fl
            s, counts_s, peaks_s, _ = streamed_run(
                "12a streamed flagship", store, model, 3, path_kernels,
                chunk_times=STREAM_CHUNK_A, calibration_context="T", algorithm="hogbom", **CLEAN,
            )
        finally:
            store.close()
    m, counts_m, peaks_m = run_logged(
        "12a in-memory flagship",
        lambda: ical(back, model, nmajor=3, calibration_context="T", algorithm="hogbom", **CLEAN),
        3, path_kernels,
    )
    _falls("12a streamed", peaks_s, 3)
    _falls("12a in-memory", peaks_m, 3)
    r_s, r_m = float(s.residual.pixels.abs().max()), float(m[1].pixels.abs().max())
    p_s, p_m = float(s.restored.pixels.max()), float(m[2].pixels.max())
    ga, gb = referenced_gains(m[3]["T"]), referenced_gains(s.gaintable)
    dg = float(np.max(np.abs(ga - gb))) if ga.shape == gb.shape else np.inf
    say(
        f"12a streamed vs in-memory: peak residual {r_s:.6f} vs {r_m:.6f} (bound "
        f"{STREAM_RESIDUAL_TOL}), restored peak {p_s:.4f} vs {p_m:.4f} (bound "
        f"{STREAM_RESTORED_TOL}), phase-referenced gains {dg:.3e} apart (bound {STREAM_GAIN_TOL})"
    )
    if not (abs(r_s - r_m) < STREAM_RESIDUAL_TOL and abs(p_s - p_m) < STREAM_RESTORED_TOL
            and dg < STREAM_GAIN_TOL):
        raise AssertionError("12a: streamed and in-memory ical disagree")
    return {k: counts_s[k] + counts_m[k] for k in counts_s}


def scale_geometry():
    """Phase 12b's layout: (baseline xyz [nbl, 3], a1, a2, hour angles,
    times in MJD seconds)."""
    from ska_sdp_func_python_torch.models import random_array_xyz

    g = STREAMED
    ants = random_array_xyz(g["nants"], rmax=g["rmax"], seed=g["seed"])
    a1, a2 = np.triu_indices(g["nants"], 1)
    has = np.linspace(-np.pi / 6.0, np.pi / 6.0, g["ntimes"])
    return ants[a2] - ants[a1], a1, a2, has, g["epoch"] + has * SIDEREAL_S / (2 * np.pi)


def uvw_of_hour_angles(blines, ha, dec, xp=np):
    """Earth-rotation synthesis (``utils.coordinates.xyz_to_uvw``) of
    baselines ``blines`` [nbl, 3] at hour angles ``ha`` [nt]: [nt, nbl, 3],
    in numpy or torch (``xp``)."""
    ch, sh = xp.cos(ha)[:, None], xp.sin(ha)[:, None]
    x, y, z = blines[:, 0], blines[:, 1], blines[:, 2]
    v0 = x * sh + y * ch
    return xp.stack(
        [x * ch - y * sh, z * np.cos(dec) + v0 * np.sin(dec), z * np.sin(dec) - v0 * np.cos(dec)],
        -1,
    )


def write_scale_store(path, scratch):
    """Phase 12b's store (the geometry of JAX bench_streamed.py:31-95): a
    2.0 Jy source at the phase centre under per-station phases N(0, 0.3)
    plus a 0.005-rad random walk, one channel, npol 1, times in MJD
    seconds. The visibilities are made one slab at a time as the writer
    asks for them, and the uvw block is computed slab by slab into a
    memory-mapped file under ``scratch``, so host memory holds one slab."""
    from types import SimpleNamespace

    from ska_sdp_func_python_torch.io import write_visibility

    g = STREAMED
    blines, a1, a2, has, times = scale_geometry()
    nt, nbl, chunk = g["ntimes"], len(a1), g["chunk"]
    rng = np.random.default_rng(g["seed"])
    walk = rng.normal(0.0, 0.005, (nt, g["nants"])).cumsum(axis=0)
    gains = np.exp(1j * (rng.normal(0.0, 0.3, (1, g["nants"])) + walk))
    uvw = np.lib.format.open_memmap(
        os.path.join(scratch, "uvw.npy"), mode="w+", dtype=np.float64, shape=(nt, nbl, 3)
    )
    for t0 in range(0, nt, chunk):
        uvw[t0 : t0 + chunk] = uvw_of_hour_angles(blines, has[t0 : t0 + chunk], g["dec"])
    shape = (nt, nbl, 1, 1)

    class Slabs:
        """A [ntime, nbl, 1, 1] field made one time slice at a time."""

        def __init__(self, make):
            self.shape, self.make = shape, make

        def __getitem__(self, sl):
            return self.make(sl)

    obs = SimpleNamespace(
        vis=Slabs(lambda sl: (g["flux"] * gains[sl][:, a1] * np.conj(gains[sl][:, a2]))
                  .astype(np.complex64)[..., None, None]),
        weight=Slabs(lambda sl: np.ones((len(has[sl]), nbl, 1, 1), np.float32)),
        flags=Slabs(lambda sl: np.zeros((len(has[sl]), nbl, 1, 1), np.uint8)),
        uvw=uvw, time=times, frequency=np.asarray([g["frequency"]]),
        antenna1=a1, antenna2=a2,
    )
    write_visibility(obs, path, chunk_times=chunk)
    del uvw
    os.remove(os.path.join(scratch, "uvw.npy"))
    return nt * nbl


def geometry_uvw(device):
    """Phase 12b's ``uvw_compute``: the earth-rotation synthesis of the
    station geometry in torch f64 on the card, from hour angles taken
    relative to the epoch."""
    import torch

    blines, _, _, _, _ = scale_geometry()
    b = torch.as_tensor(blines, dtype=torch.float64, device=device)
    epoch, dec = STREAMED["epoch"], STREAMED["dec"]

    def uvw_compute(t):
        return uvw_of_hour_angles(b, (t - epoch) * (2 * np.pi / SIDEREAL_S), dec, xp=torch)

    return uvw_compute


def scale_launches(nslab, nmajor):
    """The launches of a streamed npol-1, one-channel Hogbom run with no
    components and no warm start: K1 once a slab in the PSF pass and in
    every cycle, S (1 + nmajor); K3 once a slab in every cycle with a
    model (all but the first), S (nmajor - 1); K4 once a slab in the PSF
    pass (weights to plan order), once a slab a cycle (residual to plan
    order) and once a slab a cycle with a model (model to natural order),
    2 S nmajor; K5 once a cycle."""
    return {"grid": nslab * (1 + nmajor), "degrid": nslab * (nmajor - 1),
            "permute": 2 * nslab * nmajor, "hogbom": nmajor}


def slab_kernels(device, store, model):
    """Phase 12b's kernels at the streamed path's shapes: slab 0 of the 100M
    store (its visibilities at the store's weights and uvw), planned as
    ``streamed_ical`` plans a slab (the store's global w range and plane
    count), with K1, K3 and K4 held against their plain versions
    (``compare_gridding``) and timed beside bounds from this slab's
    inputs. Returns the rows."""
    from ska_sdp_func_python_torch.models import create_visibility_from_arrays
    from ska_sdp_func_python_torch.ops.imaging import _nw_for, make_visibility_plan
    from ska_sdp_func_python_torch.streaming import _w_range

    nt = min(STREAMED["chunk"], store.ntime)
    re, im, wt, fl = store.read_chunk(0, nt)
    vis = create_visibility_from_arrays(
        uvw=np.array(store.uvw[:nt]), time=store.time[:nt], frequency=store.frequency,
        antenna1=store.antenna1, antenna2=store.antenna2, vis=re + 1j * im, weight=wt,
        flags=fl, phasecentre=model.phasecentre, device=device,
    )
    del re, im, wt, fl
    w_range = _w_range(store)
    nw = _nw_for(vis, model, True, None, wmax=max(abs(w_range[0]), abs(w_range[1])))
    plan = make_visibility_plan(vis, model, context="ng", nw=nw, w_range=w_range)
    say(f"12b slab 0: {vis.nvis} visibilities, the kernels against their plain versions")
    rows = compare_gridding(device, vis, plan)
    for name, r in rows.items():
        report_kernel(name, r, " at 12b's slab")
    return rows


def streamed_scale(device):
    """Phases 12b and 12c: 100M visibilities re-streamed from disk every
    cycle (f16 wire, uvw from the geometry on the card); the launches
    against their formula; K1, K3 and K4 against their plain versions on
    slab 0's plan; peak memory against a run in slabs of half the
    length; the f32 wire with the store's uvw against (b)'s settings, and
    the geometry's uvw against the store's. Returns the launches of the
    gated runs."""
    import torch

    from ska_sdp_func_python_torch.models import create_image

    g = STREAMED
    nvis_est = g["ntimes"] * g["nants"] * (g["nants"] - 1) // 2
    path_kernels = ("grid", "degrid", "permute", "hogbom")
    one_cycle = ("grid", "permute", "hogbom")  # no model to degrid in cycle 0
    model = create_image(
        g["npixel"], g["cellsize"], (0.0, g["dec"]), frequency=[g["frequency"]], device=device
    )
    kw = dict(calibration_context="T", algorithm="hogbom", cache_slabs=False, **CLEAN)
    geom = dict(wire_dtype="f16", uvw_compute=geometry_uvw(device))
    launches = []
    # the store (13 B/vis of data, 24 of uvw) and the uvw scratch file
    with store_dir(61 * nvis_est) as tmp:
        path = os.path.join(tmp, "scale.svis")
        t0 = time.perf_counter()
        nvis = write_scale_store(path, tmp)
        say(f"12b store: {nvis} visibilities, {g['nants']} stations, {g['ntimes']} integrations, "
            f"generated and written in {time.perf_counter() - t0:.1f} s "
            f"({os.path.getsize(path) / 1e9:.3f} GB)")
        store = timed_store(path)
        try:
            nslab = -(-store.ntime // g["chunk"])
            out, counts, peaks, mem3 = streamed_run(
                f"12b streamed {g['nmajor']} cycles", store, model, g["nmajor"], path_kernels,
                chunk_times=g["chunk"], **kw, **geom,
            )
            launches.append(counts)
            _falls("12b", peaks, g["nmajor"])
            rpeak = float(out.restored.pixels.max())
            want = scale_launches(nslab, g["nmajor"])
            say(f"12b: restored peak {rpeak:.4f} (source {g['flux']} Jy, bound {STREAMED_PEAK_TOL}); "
                f"launches {counts} against S = {nslab} slabs: {want}")
            if not abs(rpeak - g["flux"]) < STREAMED_PEAK_TOL:
                raise AssertionError(f"12b: restored peak {rpeak}")
            if any(counts[k] != v for k, v in want.items()):
                raise AssertionError(f"12b: launches {counts} are not {want}")
            del out
            slab_kernels(device, store, model)
            torch.cuda.empty_cache()
            wire, counts, _, mem1 = streamed_run(
                "12c f16 wire, geometry uvw, 1 cycle", store, model, 1, one_cycle,
                chunk_times=g["chunk"], **kw, **geom,
            )
            launches.append(counts)
            torch.cuda.empty_cache()
            f32, counts, _, _ = streamed_run(
                "12c f32 wire, store uvw, 1 cycle", store, model, 1, one_cycle,
                chunk_times=g["chunk"], **kw,
            )
            launches.append(counts)
            a, b = f32.residual.pixels, wire.residual.pixels
            rel = float((a - b).abs().max() / a.abs().max())
            del wire, f32, a, b
            torch.cuda.empty_cache()
            _, counts, _, mem_half = streamed_run(
                "12b streamed 1 cycle in slabs of half the length", store, model, 1,
                one_cycle, chunk_times=g["chunk"] // 2, **kw, **geom,
            )
            launches.append(counts)
            uvw_compute, err = geometry_uvw(device), 0.0
            for t0 in range(0, store.ntime, g["chunk"]):
                t = torch.as_tensor(store.time[t0 : t0 + g["chunk"]], dtype=torch.float64, device=device)
                ref = torch.as_tensor(np.array(store.uvw[t0 : t0 + g["chunk"]]), device=device)
                err = max(err, float((uvw_compute(t) - ref).abs().max()))
        finally:
            store.close()
    say(f"12c: f32 wire and store uvw against f16 wire and geometry uvw: residual images "
        f"{rel:.3e} of their maximum apart (bound {WIRE_TOL}); geometry uvw {err:.3e} m from "
        f"the store's (bound {UVW_TOL} m)")
    say(f"12b: peak memory {mem3:.3f} GiB ({g['nmajor']} cycles), {mem1:.3f} GiB (1 cycle), "
        f"{mem_half:.3f} GiB (1 cycle, slabs of {g['chunk'] // 2})")
    if not (rel < WIRE_TOL and err < UVW_TOL):
        raise AssertionError("12c: the wire or the geometry disagrees")
    if not mem_half < mem1:
        raise AssertionError("12b: peak memory did not fall with the slab")
    return {k: sum(c[k] for c in launches) for k in launches[0]}


def streamed_card_vs_cpu(device):
    """Phase 12d: the streamed path on phase 7's small observation (its
    uniform weights as the store's), on the card and on the CPU, to phase
    7's bounds (gains 1e-4, peak residual 1e-3 relative)."""
    import tempfile

    from ska_sdp_func_python_torch.io import write_visibility
    from ska_sdp_func_python_torch.streaming import streamed_ical

    _, vis, model, _ = simulate("cpu", rmax=600.0, ntimes=8, npixel=256)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "small.svis")
        write_visibility(vis.replace(weight=vis.imaging_weight), path, chunk_times=2)
        for dev in (device, "cpu"):
            m = model.replace(pixels=model.pixels.to(dev))
            out[dev] = streamed_ical(path, m, m.phasecentre, nmajor=3, chunk_times=2,
                                     calibration_context="T", algorithm="hogbom", **CLEAN)
    (a, b) = out[device], out["cpu"]
    dg = float(np.max(np.abs(referenced_gains(a.gaintable) - referenced_gains(b.gaintable))))
    ra, rb = float(a.residual.pixels.abs().max()), float(b.residual.pixels.abs().max())
    say(f"12d streamed card vs cpu: gains {dg:.2e} apart (bound 1e-4), peak residual {ra:.6f} vs "
        f"{rb:.6f} (bound 1e-3 rel)")
    if not (dg < 1e-4 and abs(ra - rb) < 1e-3 * rb):
        raise AssertionError("12d: streamed card and cpu runs disagree")


# the streaming module's names that the streamed cycle calls, each a stage
# of profile_streamed
STAGES = (
    "_upload", "make_visibility_plan", "predict_with_stack", "permute_apply",
    "_solve_terms", "grid_with_plan", "uv_grids_to_dirty", "deconvolve_cube",
    "fit_psf", "restore_cube",
)


def timed_stages(streaming, store, marks):
    """Replaces each stage of the ``streaming`` module and the store's
    ``wait`` by a synchronised timer; returns the accumulator {stage:
    [seconds, calls]}. The first FFT tail ends the PSF pass: a snapshot of the
    accumulator goes to ``marks`` then."""
    from collections import defaultdict

    import torch

    acc = defaultdict(lambda: [0.0, 0])

    def wrap(name, fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            acc[name][0] += time.perf_counter() - t0
            acc[name][1] += 1
            if name == "uv_grids_to_dirty" and acc[name][1] == 1:
                marks.append(("PSF pass", None, snapshot(acc)))
            return out

        return timed

    for name in STAGES:
        setattr(streaming, name, wrap(name, getattr(streaming, name)))
    store.wait = wrap("store.wait", store.wait)
    return acc


def snapshot(acc) -> dict:
    return {k: tuple(v) for k, v in acc.items()}


def profile_streamed(wire: str = "f16", store_uvw: bool = False,
                     out: str = "build/profile_streamed") -> int:
    """``python3 chip_smoke.py --profile-streamed``: where the time of a
    streamed cycle goes, on phase 12b's store and settings (slabs of 200
    integrations, ``cache_slabs=False``, the f16 wire unless ``--wire
    f32``, uvw from the geometry unless ``--store-uvw``, Hogbom).

      1. two cycles with a synchronised timer around each stage of the
         slab leg and the tail (``store.wait``, the upload, the plan
         build, the degrid, the permutes, the solve, the grid, the FFT
         tail, CLEAN and the restore): each stage's seconds and calls per
         cycle, and what no stage holds (the host between them: the
         slab's arrays, the f16 scale, the residual's arithmetic);
      2. two cycles under ``torch.profiler`` with no timer: the run's
         wall time, the device busy time (the union of kernel, memcpy
         and memset intervals, as ``profile_torch_cycle.py`` counts it),
         the idle share and the device time by kernel name; the chrome
         trace goes to ``<out>/streamed_trace.json``."""
    import torch

    from profile_torch_cycle import busy_in
    from ska_sdp_func_python_torch import kernels, streaming
    from ska_sdp_func_python_torch.io import VisStore
    from ska_sdp_func_python_torch.models import create_image

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    kernels.build_library()
    kernels.load_library()
    device = torch.device("cuda", 0)
    say(f"device: {card_line()}")
    g = STREAMED
    model = create_image(g["npixel"], g["cellsize"], (0.0, g["dec"]),
                         frequency=[g["frequency"]], device=device)
    kw = dict(chunk_times=g["chunk"], calibration_context="T", algorithm="hogbom",
              cache_slabs=False, wire_dtype=None if wire == "f32" else "f16", **CLEAN)
    if not store_uvw:
        kw["uvw_compute"] = geometry_uvw(device)
    nvis_est = g["ntimes"] * g["nants"] * (g["nants"] - 1) // 2
    with store_dir(61 * nvis_est) as tmp:
        path = os.path.join(tmp, "scale.svis")
        nvis = write_scale_store(path, tmp)
        say(f"store: {nvis} visibilities, slabs of {g['chunk']}, wire {wire}, "
              f"uvw {'store' if store_uvw else 'geometry'}")
        originals = {name: getattr(streaming, name) for name in STAGES}
        marks = []
        try:
            with VisStore(path) as store:
                acc = timed_stages(streaming, store, marks)
                streaming.streamed_ical(
                    store, model, model.phasecentre, nmajor=2,
                    on_cycle=lambda c, secs: marks.append((f"cycle {c}", secs, snapshot(acc))),
                    **kw,
                )
        finally:
            for name, f in originals.items():
                setattr(streaming, name, f)
        prev = {}
        for label, secs, snap in marks:
            staged = 0.0
            for name in ("store.wait",) + STAGES:
                s, n = snap.get(name, (0.0, 0))
                ds, dn = s - prev.get(name, (0.0, 0))[0], n - prev.get(name, (0.0, 0))[1]
                if dn:
                    staged += ds
                    say(f"{label}: {name} {ds:.4f} s in {dn} calls")
            if secs is not None:
                say(f"{label}: {secs:.3f} s, {nvis / secs / 1e6:.2f} Mvis/s (timed); "
                      f"no stage {secs - staged:.4f} s")
            prev = snap
        from torch.profiler import ProfilerActivity, profile, record_function

        with VisStore(path) as store:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with record_function("streamed"):
                    streaming.streamed_ical(store, model, model.phasecentre, nmajor=2, **kw)
                    torch.cuda.synchronize()
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, "streamed_trace.json")
    prof.export_chrome_trace(trace)
    wall, busy, by_name, count = busy_in(trace, window="streamed")
    say(f"profiled run (PSF pass and 2 cycles): wall {wall / 1e6:.3f} s, device busy "
          f"{busy / 1e6:.3f} s, idle share {1 - busy / wall:.4f}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        say(f"  {us / 1e3:10.3f} ms  {count[name]:6d} x  {name[:90]}")
    say(f"device: {card_line()}")
    return 0

# ---------------------------------------------------------------------------
# phase 13: the rest of the single-device imaging and CLEAN API


def degrid_row(gp, label, plain_reps=1, reps=20):
    """K3 against its plain version (in pieces) on plan ``gp`` with random
    grids; times both (``plain_reps`` 0: the plain version's reference run
    itself) and prints the row with its bound. Returns the row."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import degrid

    g = torch.Generator(device=gp.perm.device).manual_seed(13)
    grids = torch.randn((gp.nplanes, gp.npixel, gp.npixel), generator=g,
                        device=gp.perm.device, dtype=torch.complex64)
    piece = _plain_piece(gp)
    ref, ref_ms = once_timed(lambda: degrid_plain_pieces(gp, grids, piece))
    out = degrid(gp, grids)
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    same = torch.equal(out, degrid(gp, grids))
    del ref, out
    row = _row(err, rel, timed(lambda: degrid(gp, grids), reps),
               timed(lambda: degrid_plain_pieces(gp, grids, piece), plain_reps)
               if plain_reps else ref_ms, degrid_bound(gp))
    say(
        f"degrid {label}: {gp.n_in} entries, {gp.nplanes} planes of {gp.npixel}^2: "
        f"max abs err {err:.3e}, rel {rel:.3e} (tolerance {KERNELS['degrid'][0]:g}); "
        f"kernel {row['ms']:.4f} ms, plain (in pieces) {row['plain_ms']:.3f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); a second launch gives "
        f"the same bits: {same}"
    )
    if not rel <= KERNELS["degrid"][0]:
        raise AssertionError(f"degrid {label} disagrees with its plain version")
    if not same:
        raise AssertionError(f"degrid {label}: two launches on the same inputs differ")
    return row


def plan_kernels(gp, vals, label, plain_reps=1, reps=(10, 20)):
    """K1 (two launches to the same bits) and K3 against their plain
    versions on plan ``gp``, at its support and plane mode (``plain_reps``
    and ``reps`` as grid_row's and degrid_row's). Returns the rows by
    kernel."""
    mode = "nearest" if gp.nearest else "linear" if gp.wstacked else "one plane"
    label = f"{label} (support {gp.support}, span {gp.span}, {mode}, taps {gp.ku.shape[1]} wide)"
    if 16 < gp.span <= 64:
        say(f"launch geometry {label}: {wide_geometry(gp)}")
    elif gp.span > 64:
        say(f"launch geometry {label}: {route4_geometry(gp)}")
    return {"grid": grid_row(gp, vals, label, plain_reps, reps[0]),
            "degrid": degrid_row(gp, label, plain_reps, reps[1])}


def wide_geometry(gp):
    """The launch geometry of K1's and K3's wide variants on plan ``gp``
    (span past 16), as the library reports it."""
    from ska_sdp_func_python_torch.kernels import query

    nacc = 4 if gp.wstacked else 2
    cs, threads, smem, walks, k, stage = (
        query("ska_grid_wide_geometry", gp.span, gp.tile, nacc, w) for w in range(6))
    k3 = [query("ska_degrid_wide_geometry", w) for w in range(3)]
    return (f"K1 a cluster of {cs} CTA(s) a chunk, {threads} threads and {smem} shared "
            f"bytes a CTA, {walks} walk(s) a CTA of {k} rows a thread, {stage} entries "
            f"a walk a batch; K3 {k3[0]} threads and {k3[1]} shared bytes a CTA, "
            f"{k3[2]} walk positions a CTA")


def route4_geometry(gp):
    """The launch geometry of K1's route 4 and K3's route on plan ``gp``,
    as the library reports them."""
    from ska_sdp_func_python_torch.kernels import query

    nacc = 4 if gp.wstacked else 2
    v = [query("ska_grid_band_geometry", gp.span, gp.tile, nacc, w) for w in range(13)]
    k3 = [query("ska_degrid_long_geometry", gp.span, w) for w in range(6)]
    return (f"K1 route {query('ska_grid_route', gp.span, gp.tile, nacc)} (4: sub-tiles over a "
            f"cluster), {_band_text(v)}; K3 route {query('ska_degrid_route', gp.span)} (4: long "
            "windows in bands)"
            + (f", {k3[0]} threads and {k3[1]} shared bytes a CTA, {k3[2]} walk positions "
               f"a CTA, {k3[3]} columns a lane in {k3[4]} chunk(s), bands of {k3[5]} cells"
               if k3[0] else ""))


def _band_text(v):
    """Route 4's launch geometry (the 13 fields of ``ska_grid_band_geometry``
    or ``ska_unit_tiles_band_geometry``) in words."""
    if not v[0]:
        return "no geometry"
    held = (f"held in blocks of {v[11]} rows by {v[12]} columns, windows clipped to each"
            if v[11] else "held whole")
    return (f"sub-tiles of {v[6]} x {v[7]} window corners {held} by a cluster of {v[0]} "
            f"CTA(s), {v[1]} threads and {v[2]} shared bytes a CTA, {v[3]} walk(s) a CTA of "
            f"{v[4]} rows a thread, {v[8]} CTA(s) a walk in {v[9]} pass(es), {v[5]} entries "
            f"a walk a batch in {v[10]} tap buffer(s)")


def band_geometry(support, tile, f64):
    """The launch geometry of K9's route 4 at ``support`` on tiles of
    ``tile`` cells, as the library reports it."""
    from ska_sdp_func_python_torch.kernels import query

    v = [query("ska_unit_tiles_band_geometry", support, tile, int(f64), w) for w in range(13)]
    if support == 1:
        return "no launch (the taps of support 1 are zero)"
    return _band_text(v)


def run_support_flagship(vis, model, phases):
    """Phase 13a: phase 4's Hogbom ical on plans at supports 6 and 12, K1
    and K3 held on each plan first; then the facet round trip of 13d on the
    support-12 dirty image. Returns (summed counts, kernel rows by
    configuration)."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )

    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    total, rows, dirty = None, {}, None
    for support in SUPPORTS13:
        plan = make_visibility_plan(vis, model, context="ng", support=support)
        gp = plan.plans[0].gp
        rows[f"flagship support {support} linear"] = plan_kernels(
            gp, sort_values(gp, weighted), "13a flagship")
        dirty = invert_visibility(vis, model, plan=plan)[0]
        del plan, gp
        torch.cuda.empty_cache()
        counts, _, _, rpeak = run_ical(
            f"13a hogbom ical support {support}", vis, model, phases, 4,
            ("grid", "degrid", "permute", "hogbom"), algorithm="hogbom",
            support=support, **CLEAN,
        )
        if not abs(rpeak - 2.0) < 0.2:
            raise AssertionError(f"13a support {support}: restored peak {rpeak} not within 0.2 of 2.0")
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    facet_round_trip(dirty)
    return total, rows


def facet_round_trip(im):
    """Phase 13d's facets: image_raster_iter -> image_gather_facets of a
    flagship image on the card returns the image to FACET_TOL of its
    maximum."""
    from ska_sdp_func_python_torch.ops.image_iterators import (
        image_gather_facets,
        image_raster_iter,
    )

    t0 = time.perf_counter()
    facets = list(image_raster_iter(im, **FACETS13))
    back = image_gather_facets(facets, im, **FACETS13)
    err = float((back.pixels - im.pixels).abs().max() / im.pixels.abs().max())
    say(
        f"13d facets {FACETS13} of the {im.npixel}^2 flagship dirty image: "
        f"{len(facets)} facets of {tuple(facets[0].pixels.shape[-2:])} and larger, "
        f"gathered back to {err:.3e} of the maximum (bound {FACET_TOL:g}) in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms"
    )
    if not err <= FACET_TOL:
        raise AssertionError("13d: the gathered facets do not give the image back")


def _vis_to(vis, device):
    """``vis`` with every tensor moved to ``device``."""
    import dataclasses

    import torch

    return vis.replace(**{
        f.name: getattr(vis, f.name).to(device)
        for f in dataclasses.fields(vis)
        if isinstance(getattr(vis, f.name), torch.Tensor)
    })


def run_weighting_flagship(vis, model):
    """Phase 13c: uniform and robust (robustness -2, 0, 2) weights and the
    Gaussian and Tukey tapers of the flagship with weights 1 + N(0, 0.1),
    on the card against the port on the CPU (to WEIGHT_TOL relative); two
    card runs of the robust weights give the same bits; the PSF's peak
    sidelobe for uniform, robust and natural weights. Returns the counts
    of the three PSF inverts."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )
    from ska_sdp_func_python_torch.ops.weighting import (
        taper_visibility_gaussian,
        taper_visibility_tukey,
        weight_visibility,
    )

    rng = np.random.default_rng(13)
    w = 1.0 + rng.normal(0.0, 0.1, tuple(vis.weight.shape))
    vis = vis.replace(weight=torch.as_tensor(w, dtype=vis.weight.dtype, device=vis.device))
    host = _vis_to(vis, "cpu")
    hmodel = model.replace(pixels=model.pixels.cpu())
    beam = 3.0 * float(model.cellsize)
    errs, walls = {}, {}
    for label, fn in [
        (f"robust {r:g}", lambda v, m, r=r: weight_visibility(v, m, "robust", robustness=r))
        for r in ROBUST13
    ] + [
        ("uniform", lambda v, m: weight_visibility(v, m, "uniform")),
        ("gaussian taper", lambda v, m: taper_visibility_gaussian(weight_visibility(v, m), beam)),
        ("tukey taper", lambda v, m: taper_visibility_tukey(weight_visibility(v, m), 0.1)),
    ]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(vis, model).imaging_weight
        torch.cuda.synchronize()
        walls[label] = (time.perf_counter() - t0) * 1e3
        ref = fn(host, hmodel).imaging_weight
        errs[label] = float((card.cpu() - ref).abs().max() / ref.abs().max())
        if label == "robust 0":
            again = fn(vis, model).imaging_weight
            same = torch.equal(card, again)
    say(
        "13c flagship imaging weights (weights 1 + N(0, 0.1)), card against the "
        "CPU, max error relative to the largest weight: "
        + ", ".join(f"{k} {v:.3e} ({walls[k]:.1f} ms on the card)" for k, v in errs.items())
        + f" (bound {WEIGHT_TOL:g}); a second card run of robust 0 gives the same bits: {same}"
    )
    if not all(v <= WEIGHT_TOL for v in errs.values()):
        raise AssertionError("13c: the card's imaging weights differ from the CPU's")
    if not same:
        raise AssertionError("13c: two card runs of the robust weights differ")
    del host, hmodel
    plan = make_visibility_plan(vis, model, context="ng")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    lobes = {}
    n = model.npixel
    yy, xx = torch.meshgrid(torch.arange(n, device=vis.device) - n // 2,
                            torch.arange(n, device=vis.device) - n // 2, indexing="ij")
    outside = (yy**2 + xx**2) > SIDELOBE_RADIUS**2
    for label, weighting, r in (("uniform", "uniform", 0.0), ("robust 0", "robust", 0.0),
                                ("natural", "natural", 0.0)):
        wv = weight_visibility(vis, model, weighting, robustness=r)
        psf = invert_visibility(wv, model, dopsf=True, plan=plan)[0].pixels[0, 0]
        lobes[label] = float(psf[outside].abs().max() / psf.max())
    counts = kernels.launch_counts()
    say(
        f"13c PSF peak sidelobe (|psf| beyond {SIDELOBE_RADIUS} px of the centre over "
        "the peak): " + ", ".join(f"{k} {v:.4f}" for k, v in lobes.items())
        + f"; launches {counts}"
    )
    _launch_gate("13c PSF inverts", counts, ("grid",))
    return counts


def run_nearest_flagship(vis, model, oracle, source):
    """Phase 13b: phase 9's observation (natural weights, 1.0 Jy at 70% of
    the half-field) on a nearest-plane plan of NEAREST_NW w-planes, twice
    a linear plan's: K1 and K3 held on it, predict_visibility against the
    exact DFT below NEAREST_TOL and above the linear plan's error (JAX
    tests/test_imaging.py:326-352), invert_visibility's peak on the
    source. Returns (counts, kernel rows)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
        predict_visibility,
    )

    def error(plan):
        pv = predict_visibility(vis, model, plan=plan).vis
        return float(np.max(np.abs(pv.cpu().numpy().astype(np.complex128) - oracle)))

    nw = NEAREST_NW // 2
    linear = make_visibility_plan(vis, model, context="ng", nw=nw)
    err_lin = error(linear)
    del linear
    plan = make_visibility_plan(vis, model, context="ng", w_interp="nearest", nw=2 * nw)
    gp = plan.plans[0].gp
    if not (gp.nearest and gp.nplanes == 2 * nw):
        raise AssertionError("13b: the plan is not a nearest-plane plan of 2 nw planes")
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    rows = plan_kernels(gp, sort_values(gp, weighted), "13b flagship")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    err = error(plan)
    t1 = time.perf_counter()
    dirty = invert_visibility(vis, model, plan=plan)[0].pixels[0, 0]
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    img = dirty.double().cpu().numpy()
    iy, ix = np.unravel_index(int(np.argmax(img)), img.shape)
    say(
        f"13b nearest plan ({2 * nw} planes; linear {nw}): predict {(t1 - t0) * 1e3:.1f} "
        f"ms, max error vs the exact DFT {err:.4e} (bound {NEAREST_TOL:g}; linear "
        f"{err_lin:.4e}); invert {(t2 - t1) * 1e3:.1f} ms, peak {img[iy, ix]:.6f} at "
        f"({ix}, {iy}) (source at {source}); launches {counts}"
    )
    if not (err < NEAREST_TOL and err > err_lin):
        raise AssertionError(f"13b: nearest error {err}, linear {err_lin}")
    if (ix, iy) != tuple(source):
        raise AssertionError(f"13b: dirty peak at {(ix, iy)}, source at {source}")
    _launch_gate("13b nearest predict and invert", counts, ("grid", "degrid", "permute"))
    return counts, {f"epsilon observation nearest, {2 * nw} planes": rows}


def cube_lists(dirty, psf):
    """Phase 13d on the config-4 cube: deconvolve_list over its 64 channel
    images with hogbom, msclean and mmclean equals deconvolve_cube on the
    cube bit for bit, and restore_list restore_cube. Returns the summed
    counts of the list calls."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.deconvolution import (
        deconvolve_cube,
        deconvolve_list,
        restore_cube,
        restore_list,
    )
    from ska_sdp_func_python_torch.ops.image_iterators import (
        image_gather_channels,
        image_scatter_channels,
    )

    dl, pl = image_scatter_channels(dirty), image_scatter_channels(psf)
    beam = {"bmaj": 0.05, "bmin": 0.04, "bpa": 30.0}
    total = None
    for algorithm, kernel, kw in (
        ("hogbom", "hogbom", CLEAN),
        ("msclean", "msclean", dict(CLEAN, niter=100, scales=SCALES)),
        ("mmclean", "msmfs", CUBE_CLEAN),
    ):
        kw = {k: v for k, v in kw.items() if k != "algorithm"}
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        comps, res = deconvolve_list(dl, pl, algorithm=algorithm, **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        cc, rr = deconvolve_cube(dirty, psf, algorithm=algorithm, **kw)
        same = (torch.equal(image_gather_channels(comps).pixels, cc.pixels)
                and torch.equal(image_gather_channels(res).pixels, rr.pixels))
        restored = restore_list(comps, pl, res, clean_beam=beam)
        same_r = torch.equal(image_gather_channels(restored).pixels,
                             restore_cube(cc, psf, rr, clean_beam=beam).pixels)
        say(
            f"13d deconvolve_list {algorithm} over {len(dl)} channel images: "
            f"{wall:.1f} ms, launches {counts}; equals deconvolve_cube bit for bit: "
            f"{same}; restore_list equals restore_cube bit for bit: {same_r}"
        )
        if not (same and same_r):
            raise AssertionError(f"13d {algorithm}: the list API differs from the cube's")
        _launch_gate(f"13d {algorithm} list", counts, (kernel,))
        total = counts if total is None else {k: total[k] + counts[k] for k in total}
    return total


def small_nearest_matches_cpu(device):
    """Phase 13e: phase 7's small observation imaged on a nearest-plane
    plan (twice the linear planes) on the card and on the CPU, and the
    CPU's dirty image predicted on both, held to the plan path's f32
    tolerance (1e-5 of the maxima)."""
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
        predict_visibility,
    )

    out, sky = {}, None
    for dev in ("cpu", device):
        _, vis, model, _ = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
        nw = make_visibility_plan(vis, model, context="ng").nw
        plan = make_visibility_plan(vis, model, context="ng", w_interp="nearest", nw=2 * nw)
        dirty = invert_visibility(vis, model, plan=plan)[0]
        if sky is None:
            sky = dirty.pixels  # both predict the CPU's dirty image
        pred = predict_visibility(vis, dirty.replace(pixels=sky.to(dirty.device)), plan=plan).vis
        out[dev] = (dirty.pixels.cpu(), pred.cpu())
    (da, pa), (db, pb) = out[device], out["cpu"]
    ed = float((da - db).abs().max() / db.abs().max())
    ep = float((pa - pb).abs().max() / pb.abs().max())
    say(
        f"13e small observation on a nearest plan card vs cpu: dirty image "
        f"{ed:.3e}, predict {ep:.3e} of the maxima (bound 1e-5)"
    )
    if not (ed <= 1e-5 and ep <= 1e-5):
        raise AssertionError("13e: card and cpu disagree on the nearest plan")


# phase 14: the parallel layer


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _shard_agree(label, a, b, gain_tol, res_tol, restored_tol):
    """Two self-cal results (model, residual, restored, gaintables) within
    the bounds; prints the numbers."""
    dg = float(np.max(np.abs(referenced_gains(a[3]["T"]) - referenced_gains(b[3]["T"]))))
    ra, rb = (float(x[1].pixels.abs().max()) for x in (a, b))
    sa, sb = (float(x[2].pixels.max()) for x in (a, b))
    say(
        f"{label}: phase-referenced gains {dg:.3e} apart (bound {gain_tol}), peak "
        f"residuals {ra:.6f} vs {rb:.6f} (bound {res_tol}), restored peaks {sa:.4f} vs "
        f"{sb:.4f} (bound {restored_tol})"
    )
    if not (dg < gain_tol and abs(ra - rb) < res_tol and abs(sa - sb) < restored_tol):
        raise AssertionError(f"{label}: outside the bounds")


def _same_bits(label, a, b):
    """Two (model, residual, restored, gaintables) results equal bit for
    bit."""
    same = all(torch_equal(x.pixels, y.pixels) for x, y in zip(a[:3], b[:3]))
    same &= all(torch_equal(a[3][t].gain, b[3][t].gain) for t in a[3])
    say(f"{label}: bit for bit {'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError(f"{label}: the runs differ")


def torch_equal(x, y):
    import torch

    return torch.equal(x.detach().cpu(), y.detach().cpu())


def grid_raw_route(vis, gp, mesh):
    """Phase 14a's hold of K1's sharded route at the flagship's shapes: the
    flagship's weighted visibilities split over the mesh's shards by
    baseline block, each gridded in plan order with ``raw=True`` at the
    global bound (the psum of the shards' vsums, the pmax of their tap
    bounds); the int64 planes summed in two orders (the same bits);
    grid_convert held bit for bit against grid_convert_plain on the sum,
    and its grids against the whole stream's plain version accumulated in
    f64 at K1's tolerance. Returns grid_convert's row."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_fused import (
        grid,
        grid_convert,
        grid_convert_plain,
        grid_vsum,
    )
    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.parallel import collectives

    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0]
    nbl = weighted.shape[1]
    block = torch.arange(nbl, device=weighted.device) * mesh.nshards // nbl
    parts = [sort_values(gp, torch.where(block == d, weighted, 0).reshape(-1))
             for d in range(mesh.nshards)]
    bnd = (collectives.psum(mesh, [grid_vsum(p) for p in parts]),
           collectives.pmax(mesh, [gp.tap_bound for _ in parts]))
    raws = [grid(gp, p, raw=True, bound=bnd) for p in parts]
    total, backward = raws[0], raws[-1]
    for a, b in zip(raws[1:], reversed(raws[:-1])):
        total, backward = total + a, backward + b
    same_sum = torch.equal(total, backward)
    del raws, parts, backward
    out = grid_convert(total, bnd)
    exact = torch.equal(out, grid_convert_plain(total, bnd))
    ref = grid_plain_pieces(gp, sort_values(gp, weighted.reshape(-1)).to(torch.complex128))
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    del ref, out
    nfloat = total.numel()
    if not (same_sum and exact and rel <= KERNELS["grid"][0]):
        raise AssertionError(
            f"14a: K1's sharded route: int64 sums in two orders equal {same_sum}, "
            f"grid_convert bit for bit {exact}, rel err {rel:.3e}"
        )
    row = _row(
        0.0, 0.0,
        timed(lambda: grid_convert(total, bnd), 20),
        timed(lambda: grid_convert_plain(total, bnd), 5),
        # int64 in, f32 out; one f64 multiply a float
        bound(nfloat * (8 + 4), nfloat, PEAK_F64_S),
    )
    say(
        f"14a K1's sharded route ({mesh.nshards} baseline-block shards, {gp.nplanes} planes "
        f"of {gp.npixel}^2): the int64 sums in two orders equal: {same_sum}; grid_convert "
        f"equals its plain version bit for bit: {exact}; the converted sum against the whole "
        f"stream's plain version in f64: max abs err {err:.3e}, rel {rel:.3e} (tolerance "
        f"{KERNELS['grid'][0]:g}); grid_convert {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} "
        f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})"
    )
    return row


def sharded_flagship(device, vis, model):
    """Phase 14a: the flagship msclean "T" ical (phases 4-6's CLEAN, 4
    cycles) over 4 local baseline shards of the card in an NCCL group of
    one process, twice, against the single-device fused ical; K1's sharded
    route held at the flagship's shapes (:func:`grid_raw_route`). Returns
    the sharded runs' summed launch counts and grid_convert's row."""
    import torch

    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan
    from ska_sdp_func_python_torch.parallel import collectives, make_mesh, sharded_ical
    from ska_sdp_func_python_torch.pipeline import ical

    kw = dict(nmajor=4, calibration_context="T", context="ng", scales=SCALES, **CLEAN)
    path = ("grid", "grid_convert", "degrid", "permute", "msclean")
    walls_1 = []
    ref, _, _ = run_logged("14a single-device ical", lambda: ical(vis, model, **kw), 4,
                           ("grid", "degrid", "permute", "msclean"), walls=walls_1)
    mesh = make_mesh(shape=(SHARDS14,), devices=[device])
    say(f"14a mesh: {mesh.nshards} shards on {set(str(d) for d in mesh.devices)}, "
        f"group {torch.distributed.get_backend(mesh.group)} of "
        f"{torch.distributed.get_world_size(mesh.group)} process")
    plan = make_visibility_plan(vis, model, context="ng").plans[0]
    row = grid_raw_route(vis, plan.gp, mesh)
    torch.cuda.empty_cache()
    runs, total = [], {}
    for rep in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        collectives.reset_collective_counts()
        record, walls = [], []
        out, counts, _ = run_logged(
            f"14a sharded ical run {rep + 1}",
            lambda: sharded_ical(vis, model, mesh, hlo_out=record, **kw), 4, path, walls=walls,
        )
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        cc = collectives.collective_counts()
        runs.append(out)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        say(
            f"14a sharded ical run {rep + 1}: steady cycles {walls[1:]} ms against the "
            f"single-device {walls_1[1:]} ms; peak memory {peak_gib:.3f} GiB; collective "
            f"result bytes per cycle {sum(b for _, _, b in record[0])} (cycle 0: {record[0]}); "
            f"bytes received through torch.distributed in the whole run "
            f"{sum(c['comm_bytes'] for c in cc.values())}; the whole run {cc}"
        )
    nw_pad = -(-plan.nw // SHARDS14) * SHARDS14
    ops = [op for op, _, _ in record[0]]
    rs = [r for r in record[0] if r[0] == "psum_scatter"]
    # K1's int64 planes, 16 bytes a cell (the plain version's complex64
    # sums on the CPU, 8)
    want = (nw_pad // SHARDS14) * plan.npad**2 * (16 if torch.device(device).type == "cuda" else 8)
    if ops.count("psum_scatter") != 1 or rs[0][2] != want or ops.count("psum") > 4:
        raise AssertionError(
            f"14a: one reduce-scatter of {want} bytes (int64 planes) and at most 4 psums "
            f"a cycle expected: {record[0]}"
        )
    _same_bits("14a two sharded runs", runs[0], runs[1])
    _shard_agree("14a sharded vs single-device ical", runs[0], ref, SHARD_GAIN_TOL,
                 SHARD_RESIDUAL_TOL, SHARD_RESTORED_TOL)
    return total, row


def sharded_cube(device):
    """Phase 14b: the config-4 cube's "T" ical with MSMFS (CUBE_CLEAN, 4
    cycles) over 4 channel shards against the single-device cube ical.
    Returns the sharded run's launch counts."""
    import torch

    from ska_sdp_func_python_torch.parallel import make_mesh, sharded_ical
    from ska_sdp_func_python_torch.pipeline import ical

    vis, model = simulate_cube(device, **CUBE)
    corrupted, _ = corrupt(vis, 0.4)
    del vis
    kw = dict(nmajor=4, calibration_context="T", context="ng", **CUBE_CLEAN)
    path = ("grid", "degrid", "permute", "msmfs")
    walls_1, walls = [], []
    ref, _, _ = run_logged("14b single-device cube ical", lambda: ical(corrupted, model, **kw),
                           4, path, walls=walls_1)
    mesh = make_mesh(shape=(SHARDS14,), devices=[device])
    out, counts, peaks = run_logged(
        "14b channel-sharded cube ical",
        lambda: sharded_ical(corrupted, model, mesh, shard="channel", **kw), 4, path, walls=walls,
    )
    dres = float((out[1].pixels - ref[1].pixels).abs().max())
    dmod = float((out[0].pixels - ref[0].pixels).abs().max())
    index = cube_gates("14b channel-sharded cube ical", out[0], peaks, CUBE["offset"],
                       CUBE["alpha"], gate=False)
    say(
        f"14b: steady cycles {walls[1:]} ms against the single-device {walls_1[1:]} ms; "
        f"residual {dres:.3e} and model {dmod:.3e} from the single-device run (bound "
        f"{CUBE_SHARD_TOL}); spectral index {index:.4f} (bound {INDEX_TOL} of {CUBE['alpha']})"
    )
    if not (dres < CUBE_SHARD_TOL and dmod < CUBE_SHARD_TOL and abs(index - CUBE["alpha"]) < INDEX_TOL):
        raise AssertionError("14b: the channel-sharded cube is outside the bounds")
    del corrupted, ref, out
    torch.cuda.empty_cache()
    return counts


_SMALL14 = dict(CLEAN, nmajor=3, calibration_context="T", context="ng", algorithm="hogbom")


def phase14_child(rank: int, port: int, inputs: str, out: str) -> int:
    """Phase 14c's process ``rank`` of 2: 2 of the 4 shards of phase 7's
    small observation on the card, in a gloo group."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.parallel import make_mesh, multihost, sharded_ical

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout_s=CHILD_TIMEOUT_S)
    blob = torch.load(inputs, weights_only=False)
    mesh = make_mesh(shape=(SHARDS14,), devices=[blob["vis"].device])
    c, r, s, g = sharded_ical(blob["vis"], blob["model"], mesh, **_SMALL14)
    if rank == 0:
        torch.save(dict(model=c.pixels.cpu(), residual=r.pixels.cpu(), restored=s.pixels.cpu(),
                        gain=g["T"].gain.cpu(), counts=kernels.launch_counts()), out)
    torch.distributed.destroy_process_group()
    return 0


def layout_independence(device):
    """Phase 14c: two processes on the card, each owning 2 of the 4 shards
    of phase 7's small observation, over gloo (its collectives staged
    through host buffers), against one process of 4 shards on the card:
    equal bit for bit."""
    import tempfile

    import torch

    from ska_sdp_func_python_torch.parallel import collectives, make_mesh, sharded_ical

    _, vis, model, _ = simulate(device, rmax=600.0, ntimes=8, npixel=256)
    with tempfile.TemporaryDirectory(prefix="phase14_") as tmp:
        inputs, out = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "out.pt")
        torch.save(dict(vis=vis, model=model), inputs)
        port = _free_port()
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--phase14-child", str(rank),
                 str(port), inputs, out],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for rank in (0, 1)
        ]
        try:
            logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(
                    f"14c: process {rank} failed ({p.returncode}):\n{log[-3000:]}"
                )
        got = torch.load(out, weights_only=False)
    say(f"14c: 2 processes x 2 shards over gloo in {time.perf_counter() - t0:.1f} s "
        f"(process 0's launches {got['counts']})")
    collectives.reset_collective_counts()
    c, r, s, g = sharded_ical(vis, model, make_mesh(shape=(SHARDS14,), devices=[device]), **_SMALL14)
    same = (torch_equal(got["model"], c.pixels) and torch_equal(got["residual"], r.pixels)
            and torch_equal(got["restored"], s.pixels) and torch_equal(got["gain"], g["T"].gain))
    say(f"14c: 2 x 2 against 1 x 4 shards on the card bit for bit {'equal' if same else 'DIFFERENT'}; "
        f"peak residual {float(r.pixels.abs().max()):.6f}")
    if not same:
        raise AssertionError("14c: the two layouts differ")


def distributed_card_vs_cpu(device):
    """Phase 14d: distributed_ical (the core path: K9's tiled gridder, K5)
    on phase 7's observation over 4 shards, card against CPU at phase 7's
    bounds (gains 1e-4, residual peak 1e-3 relative, restored with the CPU
    run's clean beam 0.05); 15d: a second card run equals the first bit
    for bit (gains, residual, model). Returns the first card run's launch
    counts."""
    from ska_sdp_func_python_torch.ops.deconvolution import restore_cube
    from ska_sdp_func_python_torch.parallel import distributed_ical, make_mesh

    res = {}
    for label, dev in (("card", device), ("cpu", "cpu")):
        _, vis, model, _ = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
        mesh = make_mesh(shape=(SHARDS14,), devices=[dev])
        entry = lambda: distributed_ical(  # noqa: E731
            vis, model, mesh, **dict(CLEAN, nmajor=3, algorithm="hogbom"))
        if label == "card":
            res[label], counts, _ = run_logged("14d distributed_ical on the card", entry, 3,
                                               ("unit_tiles", "hogbom"))
            again = entry()
        else:
            res[label] = entry()
    (da, ra, sa, ga), (db, rb, sb, gb) = res["card"], res["cpu"]
    same = (torch_equal(again[0].pixels, da.pixels) and torch_equal(again[1].pixels, ra.pixels)
            and torch_equal(again[3].gain, ga.gain))
    say(f"15d distributed_ical: a second card run equals the first bit for bit (model, "
        f"residual, gains): {same}")
    if not same:
        raise AssertionError("15d: two card runs of distributed_ical differ")
    dg = float(np.max(np.abs(referenced_gains(ga) - referenced_gains(gb))))
    res_a, res_b = float(ra.pixels.abs().max()), float(rb.pixels.abs().max())
    beam = dict(zip(("bmaj", "bmin", "bpa"), np.rad2deg(sb.clean_beam)))
    peak_a = float(restore_cube(da, residual=ra, clean_beam=beam).pixels.max())
    peak_b = float(sb.pixels.max())
    say(
        f"14d distributed_ical card vs cpu: gain {dg:.2e} (bound 1e-4), residual peak "
        f"{res_a:.6f} vs {res_b:.6f} (bound 1e-3 rel), restored with one beam {peak_a:.4f} "
        f"vs {peak_b:.4f} (bound 0.05)"
    )
    if not (dg < 1e-4 and abs(res_a - res_b) < 1e-3 * res_b and abs(peak_a - peak_b) < 0.05):
        raise AssertionError("14d: card and cpu disagree")
    return counts


def run_parallel(device, vis, model):
    """Phase 14 (a-d). Returns ({shape: launch counts}, grid_convert's
    row)."""
    import torch

    from ska_sdp_func_python_torch.parallel import multihost

    t0 = time.perf_counter()
    by_shape = {}
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="nccl")
    try:
        counts, row = sharded_flagship(device, vis, model)
        by_shape["sharded flagship, 4 baseline shards, twice (phase 14a)"] = counts
        torch.cuda.empty_cache()
        by_shape["sharded config-4 cube, 4 channel shards (phase 14b)"] = sharded_cube(device)
    finally:
        torch.distributed.destroy_process_group()
    layout_independence(device)
    by_shape["distributed_ical, 4 shards (phase 14d)"] = distributed_card_vs_cpu(device)
    torch.cuda.empty_cache()
    say(f"phase 14: {time.perf_counter() - t0:.1f} s")
    return by_shape, row


def main14() -> int:
    """``--phase14-only``: the build and phase 14 on the flagship."""
    import torch

    from ska_sdp_func_python_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t_start:.1f} s")
    _, vis, model, _ = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    by_shape, row = run_parallel(device, vis, model)
    report_kernel("grid_convert", row)
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    return 0


# ---------------------------------------------------------------------------
# phase 15: the imaging periphery (S11a) on a MID observation


def mid_observation(device, ntimes=128, nchan=4, npixel=1024, rmax=None, zero_w=False,
                    sources=None, dtype=None):
    """Phase 15's observation: the MID layout (within ``rmax`` m), hour
    angles in +-0.3 rad above 15 deg elevation, ``nchan`` channels of 10
    MHz from 1.4 GHz, holding the exact DFT of ``sources`` (None:
    SOURCES15; pixel offsets of a 1024^2 image, scaled to ``npixel``; computed in f64 on the device from the Visibility's own
    uvw; with ``zero_w`` its w are zero first, the JAX package's
    AW-projection tests' geometry), and the one-channel ``npixel``^2
    image at advise_wide_field's cellsize holding the sources, in
    ``dtype`` (None: f32). Returns (vis, model)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype

    from ska_sdp_func_python_torch.models import (
        C_M_S,
        create_image,
        create_named_configuration,
        create_visibility,
    )
    from ska_sdp_func_python_torch.ops import advise_wide_field
    from ska_sdp_func_python_torch.utils.coordinates import radec_to_lmn

    cfg = create_named_configuration("MID", rmax=rmax)
    freq = 1.4e9 + 1e7 * np.arange(nchan)
    vis = create_visibility(cfg, np.linspace(-0.3, 0.3, ntimes), freq,
                            channel_bandwidth=[1e7] * nchan, elevation_limit=np.deg2rad(15.0),
                            dtype=dtype, device=device)
    if zero_w:
        uvw = vis.uvw.clone()
        uvw[..., 2] = 0.0
        vis = vis.replace(uvw=uvw)
    cell = float(advise_wide_field(vis)["cellsize"])
    model = create_image(npixel, cell, vis.phasecentre, frequency=[float(freq.mean())],
                         nchan=1, dtype=dtype, device=device)
    uvw = torch.einsum("tbs,f->tbfs", vis.uvw.double(),
                       torch.as_tensor(freq / C_M_S, device=vis.device))
    data = torch.zeros(uvw.shape[:3], dtype=torch.complex128, device=vis.device)
    pixels = torch.zeros_like(model.pixels)
    for dx, dy, flux in SOURCES15 if sources is None else sources:
        ix, iy = npixel // 2 + dx * npixel // 1024, npixel // 2 + dy * npixel // 1024
        ra, dec = model.pixel_to_radec(ix, iy)
        l, m, n1 = (float(x) for x in radec_to_lmn(ra, dec, *vis.phasecentre))
        turns = uvw[..., 0] * l + uvw[..., 1] * m + uvw[..., 2] * n1
        data += flux * torch.exp(-2j * np.pi * turns)
        pixels[0, 0, iy, ix] = flux
    vis = vis.replace(vis=data[..., None].to(vis.vis.dtype))
    return vis, model.replace(pixels=pixels)


def _wall(fn):
    """(fn's result, its wall time in ms, synchronised)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _rel(a, b):
    """max |a - b| over max |b|, in f64."""
    import torch

    a = a.to(torch.complex128 if a.is_complex() or b.is_complex() else torch.float64)
    b = b.to(a.dtype)
    return float((a - b).abs().max() / b.abs().max())


def _repeat_gate(label, first, second):
    import torch

    same = torch.equal(first, second)
    say(f"{label}: a second run gives the same bits: {same}")
    if not same:
        raise AssertionError(f"{label}: two card runs differ")


def run_core_gridders(device):
    """Phase 15a: ``invert_visibility(gridder="scatter")`` against the
    plan route (K1) and ``predict_visibility(gridder="gather")`` against
    K3 on phase 15's MID observation, w-stacked on the plan's planes at
    padding 2 (the core route's), to DIRECT_TOL of the maximum (the
    images before the grid correction both routes divide by); wall time
    of each route, two card runs of each direct route equal bit for bit,
    and a small slice (MID within 3 km, 8 hour angles, 256^2) card
    against CPU. Returns the plan routes' launch counts."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops import (
        extract_mid,
        grid_correction,
        invert_visibility,
        make_visibility_plan,
        predict_visibility,
    )
    from ska_sdp_func_python_torch.ops.gridding import _es_beta

    t0 = time.perf_counter()
    vis, model = mid_observation(device, **MID15)
    say(f"15 MID observation: {vis.nvis} visibilities (197 dishes, {vis.ntimes} times, "
        f"{vis.nchan} channels), {model.npixel}^2 at cellsize {model.cellsize:.4e}, "
        f"simulated in {time.perf_counter() - t0:.1f} s")
    plan = make_visibility_plan(vis, model, padding=2)
    p0 = plan.plans[0]
    core = dict(gridder="scatter", auto_plan=False, nw=p0.nw, padding=2)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    (fused, _), t_fused = _wall(lambda: invert_visibility(vis, model, plan=plan))
    pred_fused, t_pfused = _wall(lambda: predict_visibility(vis, model, plan=plan).vis)
    counts = kernels.launch_counts()
    _launch_gate("15a plan routes", counts, ("grid", "degrid", "permute"))
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (direct, _), t_direct = _wall(lambda: invert_visibility(vis, model, **core))
    pred_direct, t_gather = _wall(lambda: predict_visibility(
        vis, model, **dict(core, gridder="gather")).vis)
    peak = torch.cuda.max_memory_allocated() / 2**30
    direct_counts = kernels.launch_counts()
    if any(direct_counts.values()):
        raise AssertionError(f"15a: the direct routes launched {direct_counts}")
    # both routes divide by the same grid correction, which falls several times
    # from the field's centre to its corners and scales the f32 rounding
    # of K1's route with it there: the gridders are compared before it
    corr = extract_mid(grid_correction(p0.npad, p0.support, torch.float64,
                                       _es_beta(p0.support, p0.npad / p0.npixel),
                                       device=device), p0.npixel)
    full_err = _rel(direct.pixels, fused.pixels)
    inv_err = _rel(direct.pixels[0, 0] * corr, fused.pixels[0, 0] * corr)
    pred_err = _rel(pred_direct, pred_fused)
    src = model.pixels[0, 0] > 0
    say(f"15a invert (npad {p0.npad}, nw {p0.nw}): scatter {t_direct:.1f} ms, plan (K1) "
        f"{t_fused:.1f} ms, {inv_err:.3e} of the maximum apart before the grid correction "
        f"(bound {DIRECT_TOL:g}), {full_err:.3e} of the image maximum after it; peaks at the "
        f"sources {direct.pixels[0, 0][src].tolist()} vs {fused.pixels[0, 0][src].tolist()}")
    say(f"15a predict: gather {t_gather:.1f} ms, plan (K3, K4) {t_pfused:.1f} ms, "
        f"{pred_err:.3e} of the visibility maximum apart (bound {DIRECT_TOL:g}); direct "
        f"routes' peak memory {peak:.2f} GiB")
    if not (inv_err <= DIRECT_TOL and pred_err <= DIRECT_TOL):
        raise AssertionError("15a: the direct routes disagree with the plan routes")
    _repeat_gate("15a scatter invert", direct.pixels,
                 invert_visibility(vis, model, **core)[0].pixels)
    _repeat_gate("15a gather predict", pred_direct,
                 predict_visibility(vis, model, **dict(core, gridder="gather")).vis)
    del vis, model, plan, fused, direct, pred_fused, pred_direct
    torch.cuda.empty_cache()
    out = {}
    for dev in (device, "cpu"):
        vis, model = mid_observation(dev, ntimes=8, nchan=2, npixel=256, rmax=3000.0)
        out[str(dev)] = (
            invert_visibility(vis, model, gridder="scatter", auto_plan=False)[0].pixels.cpu(),
            predict_visibility(vis, model, gridder="gather", auto_plan=False).vis.cpu(),
        )
    (ci, cp), (hi, hp) = out[str(device)], out["cpu"]
    e_i, e_p = _rel(ci, hi), _rel(cp, hp)
    say(f"15a small slice card vs cpu: scatter {e_i:.3e}, gather {e_p:.3e} of the maximum "
        f"(bound {DIRECT_TOL:g})")
    if not (e_i <= DIRECT_TOL and e_p <= DIRECT_TOL):
        raise AssertionError("15a: card and cpu disagree on the small slice")
    return counts


def run_awprojection(device):
    """Phase 15b: AW-projection on phase 15's MID observation of one source
    (SOURCE15B). The JAX package's own bounds on its geometry (w = 0, the
    default PSWF pair): the predict within AW_TOL of the exact DFT, the
    invert peak on the source within AW_TOL of its flux. Then an awterm
    CF (AW_CF, its planes spanning the observation's w) built on the card
    (build time and peak memory; the same bits on a second build; card
    against CPU at 256^2), and the predict and invert through it on the
    observation with its w: time, peak memory and two runs equal bit for
    bit. Its kernels' error against the exact DFT is printed, not gated:
    the JAX package's awterm CF does not reproduce the DFT (ROADMAP
    Queue 3), and the port follows it."""
    import torch

    from ska_sdp_func_python_torch.ops import (
        create_awterm_convolutionfunction,
        invert_visibility,
        predict_visibility,
    )

    vis, model = mid_observation(device, zero_w=True, sources=SOURCE15B, **MID15)
    empty = model.replace(pixels=torch.zeros_like(model.pixels))
    pred, t_pred = _wall(lambda: predict_visibility(vis, model, context="awprojection").vis)
    err = float((pred - vis.vis).abs().max())
    (dirty, _), t_inv = _wall(lambda: invert_visibility(vis, empty, context="awprojection"))
    img = dirty.pixels[0, 0]
    iy, ix = np.unravel_index(int(img.argmax()), tuple(img.shape))
    dx, dy, flux = SOURCE15B[0]
    want = (model.npixel // 2 + dx * model.npixel // 1024,
            model.npixel // 2 + dy * model.npixel // 1024)
    peak = float(img[iy, ix])
    say(f"15b AW-projection, default pair, w = 0: predict {t_pred:.1f} ms, max error vs the "
        f"exact DFT {err:.4f} (bound {AW_TOL}); invert {t_inv:.1f} ms, peak {peak:.4f} at "
        f"{(int(ix), int(iy))} (source {flux} Jy at {want}, bound {AW_TOL})")
    if not (err < AW_TOL and (int(ix), int(iy)) == want and abs(peak - flux) < AW_TOL):
        raise AssertionError("15b: the default AW-projection misses the JAX package's bounds")
    _repeat_gate("15b default pair predict", pred,
                 predict_visibility(vis, model, context="awprojection").vis)
    vis0 = vis
    del pred, dirty
    torch.cuda.empty_cache()

    vis, model = mid_observation(device, sources=SOURCE15B, **MID15)
    wmax = float(vis.uvw_lambda[..., 2].abs().max())
    wstep = 2.0 * wmax / (AW_CF["nw"] - 1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    (gcf, cf), t_cf = _wall(lambda: create_awterm_convolutionfunction(model, wstep=wstep, **AW_CF))
    cf_gib = torch.cuda.max_memory_allocated() / 2**30 - base
    _repeat_gate("15b awterm CF build", cf,
                 create_awterm_convolutionfunction(model, wstep=wstep, **AW_CF)[1])
    kw = dict(gcfcf=(gcf, cf), oversampling=AW_CF["oversampling"], wstep=wstep)
    err0 = float((predict_visibility(vis0, model, context="awprojection", **kw).vis
                  - vis0.vis).abs().max())
    del vis0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    (dirty, _), t_grid = _wall(lambda: invert_visibility(vis, empty, context="awprojection", **kw))
    pred, t_degrid = _wall(lambda: predict_visibility(vis, model, context="awprojection", **kw).vis)
    run_gib = torch.cuda.max_memory_allocated() / 2**30 - base
    say(f"15b awterm CF (nw {AW_CF['nw']}, oversampling {AW_CF['oversampling']}, support "
        f"{AW_CF['support']}, wstep {wstep:.1f} over |w| <= {wmax:.1f}): built in {t_cf:.1f} ms, "
        f"peak {cf_gib:.2f} GiB above the run's; invert (grid) {t_grid:.1f} ms, predict "
        f"(degrid) {t_degrid:.1f} ms, peak {run_gib:.2f} GiB above the run's; its predict "
        f"{float((pred - vis.vis).abs().max()):.4f} from the exact DFT, {err0:.4f} at w = 0 "
        f"(the JAX package's kernels and correction, not gated)")
    _repeat_gate("15b awterm invert", dirty.pixels,
                 invert_visibility(vis, empty, context="awprojection", **kw)[0].pixels)
    _repeat_gate("15b awterm predict", pred,
                 predict_visibility(vis, model, context="awprojection", **kw).vis)
    del vis, pred, dirty, cf, gcf
    torch.cuda.empty_cache()
    cfs = {}
    for dev in (device, "cpu"):
        v, m = mid_observation(dev, ntimes=8, nchan=1, npixel=256, rmax=3000.0)
        cfs[str(dev)] = create_awterm_convolutionfunction(m, wstep=wstep, **AW_CF)[1].cpu()
    e = _rel(cfs[str(device)], cfs["cpu"])
    say(f"15b awterm CF at 256^2 card vs cpu: {e:.3e} of the maximum (bound 1e-10)")
    if not e <= 1e-10:
        raise AssertionError("15b: the card's CF differs from the CPU's")


def visibility_algebra_card_vs_cpu(device):
    """Phase 15c: the visibility algebra on an f64 MID observation
    (within 3 km, 16 hour angles, 6 channels) with weights 1 + N(0, 0.1)
    and 5% flags, on the card and on the CPU from the same input: phase
    rotation with uvw re-projection to a new centre and back returns the
    uvw and the visibilities (the JAX package's round trip); the two time
    halves concatenate to the whole bit for bit; averaging, integration
    and continuum removal card against CPU; each to ALGEBRA_TOL of the
    maximum; az/el and parallactic angles of the phase centre at MID's
    site equal (host f64)."""
    import torch

    from ska_sdp_func_python_torch import ops
    from ska_sdp_func_python_torch.models import create_named_configuration

    rng = np.random.default_rng(15)
    out = {}
    for dev in (device, "cpu"):
        vis, _ = mid_observation(dev, ntimes=16, nchan=6, npixel=256, rmax=3000.0,
                                 dtype=torch.float64)
        if not out:
            shape = tuple(vis.vis.shape)
            wt = 1.0 + rng.normal(0.0, 0.1, shape)
            flags = (rng.uniform(size=shape) < 0.05).astype(np.int32)
        vis = vis.replace(weight=torch.as_tensor(wt, device=dev).to(vis.weight.dtype),
                          flags=torch.as_tensor(flags, device=dev))
        new = (vis.phasecentre[0] + 0.001, vis.phasecentre[1] + 0.002)
        rot = ops.phaserotate_visibility(vis, new, tangent=False)
        back = ops.phaserotate_visibility(rot, vis.phasecentre, tangent=False)
        half = vis.ntimes // 2
        parts = [vis.replace(**{f: getattr(vis, f)[s] for f in
                                ("vis", "weight", "imaging_weight", "flags", "uvw", "time",
                                 "integration_time")})
                 for s in (slice(0, half), slice(half, None))]
        whole = ops.concatenate_visibility(parts)
        same = all(torch.equal(getattr(whole, f), getattr(vis, f))
                   for f in ("vis", "weight", "flags", "uvw", "time"))
        res = [rot.vis, rot.uvw, ops.integrate_visibility_by_channel(vis).vis,
               *[a.vis for a in ops.average_visibility_by_channel(vis, 4)],
               ops.remove_continuum_visibility(vis, degree=1).vis]
        loc = create_named_configuration("MID").location
        geo = np.concatenate([*ops.calculate_visibility_azel(vis, loc),
                              ops.calculate_visibility_parallactic_angles(vis, loc)])
        out[str(dev)] = dict(round_trip=(_rel(back.uvw, vis.uvw), _rel(back.vis, vis.vis)),
                             same=same, res=[r.cpu() for r in res], geo=geo)
    card, cpu = out[str(device)], out["cpu"]
    errs = [_rel(a, b) for a, b in zip(card["res"], cpu["res"])]
    geo_same = np.array_equal(card["geo"], cpu["geo"])
    say(f"15c phaserotate(tangent=False) to a new centre and back on the card: uvw "
        f"{card['round_trip'][0]:.3e}, vis {card['round_trip'][1]:.3e} of the maximum "
        f"(bound {ALGEBRA_TOL:g}); halves concatenate to the whole bit for bit: {card['same']}; "
        f"card vs cpu (rotated vis, rotated uvw, integrated, 2 averages, continuum removed): "
        + ", ".join(f"{e:.2e}" for e in errs) + f" (bound {ALGEBRA_TOL:g}); az/el and "
        f"parallactic angles equal: {geo_same}")
    if not (max(card["round_trip"]) <= ALGEBRA_TOL and card["same"] and cpu["same"]
            and max(errs) <= ALGEBRA_TOL and geo_same):
        raise AssertionError("15c: the visibility algebra failed on the card")


def run_periphery(device):
    """Phase 15 (a-c). Returns the plan routes' launch counts of 15a."""
    t0 = time.perf_counter()
    counts = run_core_gridders(device)
    run_awprojection(device)
    visibility_algebra_card_vs_cpu(device)
    say(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return counts


def main15() -> int:
    """``--phase15-only``: the build, phase 15 (a-c), and 15d: phase 9's
    f32 and f64 unit_tiles streams and phase 14d's distributed_ical, each
    run twice."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.models import create_named_configuration

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t_start:.1f} s")
    run_periphery(device)
    cfg = create_named_configuration("LOW", rmax=40000.0)
    for dtype, eps, tol, peak in ((torch.float32, EPS_FAST, KERNELS["unit_tiles"][0], PEAK_F32_S),
                                  (torch.float64, EPS_DEEP, UNIT_TILES_F64_TOL, PEAK_F64_S)):
        vis, model, _, _ = observation9(cfg, device, dtype)
        stream, geo = unit_stream9(vis, model, eps)
        label = "fast-f32 stream (f32)" if dtype == torch.float32 else "deep-f64 stream (f64)"
        compare_unit_tiles(stream, geo, label, tol, peak)
        del vis, model, stream
        torch.cuda.empty_cache()
    distributed_card_vs_cpu(device)
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    return 0


def run_wide_supports(vis, model, phases):
    """Phase 16a: K1 and K3 at the supports of SUPPORTS16 on the flagship's
    plan (the full stream, or its first million entries where
    SUPPORTS16 says so), then the flagship Hogbom ical at ICAL16 (planned
    at ICAL16_PADDING), whose restored source must lie within 0.2 of 2.0
    Jy. Returns (the ical's
    launch counts, kernel rows by configuration, the ical's restored
    image)."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_plan import sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_imaging_plan, make_visibility_plan
    from ska_sdp_func_python_torch.pipeline import ical

    t0 = time.perf_counter()
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    n_sub = min(1 << 20, uvw.shape[0])
    p0 = make_visibility_plan(vis, model, context="ng").plans[0]
    geometry = dict(npixel=p0.npixel, cellsize=p0.cellsize, nw=p0.nw,
                    padding=p0.npad / p0.npixel,
                    w_range=(float(uvw[:, 2].min()), float(uvw[:, 2].max())))
    del p0
    rows = {}
    for support, full in SUPPORTS16:
        if full:
            gp = make_visibility_plan(vis, model, context="ng", support=support).plans[0].gp
            where, vals = "flagship", sort_values(gp, weighted)
        else:
            gp = make_imaging_plan(uvw[:n_sub, 0], uvw[:n_sub, 1], uvw[:n_sub, 2],
                                   support=support, **geometry).gp
            where, vals = "flagship 1M subset", sort_values(gp, weighted[:n_sub])
        rows[f"{where} support {support} linear"] = plan_kernels(gp, vals, f"16a {where}")
        del gp, vals
        torch.cuda.empty_cache()
    say(f"16a kernels: {time.perf_counter() - t0:.1f} s")
    with launch_events(("grid", "degrid")) as ms:
        (current, residual, restored, gts), counts, peaks = run_logged(
            f"16a hogbom ical support {ICAL16}",
            lambda: ical(vis, model, nmajor=4, calibration_context="T", context="ng",
                         algorithm="hogbom", support=ICAL16, padding=ICAL16_PADDING, **CLEAN),
            4, ("grid", "degrid", "permute", "hogbom"),
        )
    say(f"16a hogbom ical support {ICAL16}: K1 (grid) device ms a launch "
        + ", ".join(f"{t:.3f}" for t in ms["grid"]) + "; K3 (degrid) "
        + ", ".join(f"{t:.3f}" for t in ms["degrid"])
        + f" (CUDA events; one K1 and one K3 a cycle after the first): K1 + K3 "
        f"{ms['grid'][-1] + ms['degrid'][-1]:.3f} ms in the last cycle")
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    rpeak = float(restored.pixels.max())
    say(
        f"16a hogbom ical support {ICAL16}: gain phase error vs truth max {gmax:.3e} rad, "
        f"rms {grms:.3e} rad; restored peak {rpeak:.4f} (source 2.0 Jy, bound 0.2)"
    )
    if not abs(rpeak - 2.0) < 0.2:
        raise AssertionError(f"16a support {ICAL16}: restored peak {rpeak} not within 0.2 of 2.0")
    return counts, rows, restored


def unit_inputs16(vis, model, support, tile=None, padding=2.0):
    """The tiled gridder's inputs for ``vis`` on UNIT16_NW linear w-planes
    at ``support`` and ``padding``, in the observation's precision: the
    positional arguments and keywords of ``tiled_grid`` (and
    ``entry_stream``), and the geometry of its grid (``tile`` None: the
    imaging API's tile)."""
    from ska_sdp_func_python_torch.ops import imaging as im
    from ska_sdp_func_python_torch.ops.gridding import _es_beta

    npad = im._npad_for(model.npixel, padding)
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    u, v = im._pixels(uvw[:, 0], uvw[:, 1], npad, model.cellsize, False)
    p0, frac, _ = im._w_planes(uvw[:, 2], UNIT16_NW)
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    geo = dict(npixel=npad, tile=tile or im._tile_for(npad), support=support,
               beta=_es_beta(support, npad / model.npixel))
    kw = dict(npixel=npad, support=support, nplanes=UNIT16_NW, tile=geo["tile"],
              unit=im._UNIT_GRID)
    return (u, v, weighted, p0, frac), kw, geo


def unit_stream16(vis, model, support, tile=None, padding=2.0):
    """Phase 9's observation (UNIT16_TIMES integrations, or all of it) as
    the tiled gridder's entry stream on linear w-planes at ``support`` and
    ``padding``, in the observation's precision, and its geometry."""
    from ska_sdp_func_python_torch.ops.gridding_tiled import entry_stream

    args, kw, geo = unit_inputs16(vis, model, support, tile, padding)
    return entry_stream(*args, **kw), geo


def run_unit_tiles_wide(cfg, device):
    """Phase 16b: K9 at the odd and wide supports of UNIT16 in f32 and f64
    on phase 9's observation, against its plain version accumulated in
    f64, two launches to the same bits; then K9's wide variant on its
    full-width path: invert_visibility through the tiled core path on
    phase 9's whole observation at UNIT16_FULL (the launch counters reset
    just before the two calls and read just after), the dirty peak on the
    source's pixel within UNIT16_PEAK_TOL of 1.0 and the two calls to the
    same bits, and K9 on that call's whole stream against its plain
    version accumulated in f64. Returns (the rows by configuration, the
    full-width calls' summed launch counts)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import invert_visibility

    t0 = time.perf_counter()
    rows = {}
    launches = {name: 0 for name in KERNELS}
    for dtype, tol, peak in ((torch.float32, KERNELS["unit_tiles"][0], PEAK_F32_S),
                             (torch.float64, UNIT_TILES_F64_TOL, PEAK_F64_S)):
        vis, model, _, _ = observation9(cfg, device, dtype, ntimes=UNIT16_TIMES)
        name = "f32" if dtype == torch.float32 else "f64"
        for support in UNIT16:
            stream, geo = unit_stream16(vis, model, support)
            rows[f"{name} support {support}"] = compare_unit_tiles(
                stream, geo, f"16b {name} support {support}", tol, peak)
            del stream
        del vis, model
        torch.cuda.empty_cache()
        support = UNIT16_FULL[name]
        vis, model, _, source = observation9(cfg, device, dtype)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        walls, dirty = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            dirty.append(invert_visibility(vis, model, support=support, nw=UNIT16_NW,
                                           auto_plan=False, gridder="tiled",
                                           padding=2)[0].pixels)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t1)
        counts = kernels.launch_counts()
        for k in launches:
            launches[k] += counts[k]
        img = dirty[0][0, 0].double().cpu().numpy()
        iy, ix = np.unravel_index(int(np.argmax(img)), img.shape)
        same = torch.equal(dirty[0], dirty[1])
        label = f"16b full-width tiled invert {name} support {support}"
        say(f"{label} ({vis.nvis} visibilities, natural weights, {model.npixel}^2, padding 2, "
            f"nw {UNIT16_NW}): {walls[0]:.3f} then {walls[1]:.3f} s a call; peak "
            f"{img[iy, ix]:.6f} at ({ix}, {iy}) (source at {source}, bound "
            f"{UNIT16_PEAK_TOL} of 1.0); two calls give the same bits: {same}; launches {counts}")
        _launch_gate(label, counts, ("unit_tiles",))
        if (ix, iy) != tuple(source) or not abs(img[iy, ix] - 1.0) <= UNIT16_PEAK_TOL:
            raise AssertionError(f"{label}: dirty peak {img[iy, ix]} at {(ix, iy)}, source at {source}")
        if not same:
            raise AssertionError(f"{label}: two calls differ")
        del dirty, img
        stream, geo = unit_stream16(vis, model, support)
        rows[f"{name} support {support} full stream"] = compare_unit_tiles(
            stream, geo, f"16b {name} support {support} full stream", tol, peak)
        del stream, vis, model
        torch.cuda.empty_cache()
    say(f"16b: {time.perf_counter() - t0:.1f} s")
    return rows, launches


def spectral_cube_ical(device):
    """Phase 16c: a spectral component list (half of the cube's source,
    its flux given on five channels across the band, interpolated onto
    the 64) through the fused ical on the config-4 cube; the components'
    DFT on the card against the CPU's on the first integration. Returns
    the ical's launch counts."""
    from ska_sdp_func_python_torch.models import SkyComponents
    from ska_sdp_func_python_torch.ops import dft_skycomponent_visibility
    from ska_sdp_func_python_torch.pipeline import ical

    vis, model = simulate_cube(device, **CUBE)
    corrupted, phases = corrupt(vis, 0.4)
    del vis
    ra, dec = model.pixel_to_radec(model.npixel // 2 + CUBE["offset"][0],
                                   model.npixel // 2 + CUBE["offset"][1])
    freq = corrupted.frequency.cpu().numpy().astype(np.float64)
    knots = np.linspace(freq[0], freq[-1], 5)
    flux = 0.5 * 2.0 * (knots / freq[CUBE["nchan"] // 2]) ** CUBE["alpha"]
    sky = {d: SkyComponents.from_lists([[float(ra), float(dec)]], flux[None, :, None], knots,
                                       device=d) for d in (device, "cpu")}
    one = corrupted.replace(**{f: getattr(corrupted, f)[:1] for f in (
        "vis", "weight", "imaging_weight", "flags", "uvw", "time", "integration_time")})
    card = dft_skycomponent_visibility(one, sky[device]).vis.cpu()
    cpu = dft_skycomponent_visibility(_vis_to(one, "cpu"), sky["cpu"]).vis
    rel = float((card - cpu).abs().max()) / float(cpu.abs().max())
    say(f"16c spectral components' DFT, card vs CPU (one integration, {cpu.numel()} "
        f"values): rel {rel:.3e} (bound {DFT16_TOL:g})")
    if not rel <= DFT16_TOL:
        raise AssertionError("16c: the spectral components' DFT differs card vs CPU")
    with counting_calls("msmfs_with_stacks") as calls:
        (current, residual, _, gts), counts, peaks = run_logged(
            "16c spectral-component ical (config-4 cube)",
            lambda: ical(corrupted, model, components=sky[device], nmajor=3,
                         calibration_context="T", context="ng", **CUBE_CLEAN),
            3, ("grid", "degrid", "permute", "msmfs"),
        )
    _one_launch_per_call("16c spectral-component ical", counts, "msmfs", calls)
    gmax, grms = gain_phase_error(gts["T"].gain, phases)
    say(f"16c spectral-component ical: gain phase error max {gmax:.3e} rad, rms {grms:.3e} "
        f"rad; residual peak {float(residual.pixels.abs().max()):.4e}")
    return counts


def skymodel_flagship(vis, model, restored):
    """Phase 16c on the flagship: skymodel_predict_calibrate and
    skymodel_calibrate_invert through its plan (K3 and K4, then K1 and
    K4: launches counted) with the sources as an image and a component,
    the predict held to the DFT of the same sky; find, fit and insert on
    16a's restored image, card against CPU; gaincal. Returns the summed
    launch counts of the sky-model calls."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.models import SkyComponents, SkyModel
    from ska_sdp_func_python_torch.ops import (
        dft_skycomponent_visibility,
        find_skycomponents,
        fit_skycomponent,
        gaincal,
        insert_skycomponent,
        skymodel_calibrate_invert,
        skymodel_predict_calibrate,
    )
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan

    n = model.npixel
    pixels = torch.zeros_like(model.pixels)
    dirs = []
    for dx, dy, f in SOURCES:
        pixels[0, 0, n // 2 + dy, n // 2 + dx] = f
        dirs.append([float(a) for a in model.pixel_to_radec(n // 2 + dx, n // 2 + dy)])
    # the brightest source as a component, the other two as image pixels
    pixels[0, 0, n // 2 + SOURCES[0][1], n // 2 + SOURCES[0][0]] = 0.0
    comps = SkyComponents.from_lists(dirs[:1], [[[SOURCES[0][2]]]], vis.frequency, device=vis.device)
    sky = SkyComponents.from_lists(dirs, [[[f]] for _, _, f in SOURCES], vis.frequency,
                                   device=vis.device)
    sm = SkyModel(image=model.replace(pixels=pixels), components=comps, gaintable=None, mask=None)
    plan = make_visibility_plan(vis, model, context="ng")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    pred = skymodel_predict_calibrate(vis, sm, context="ng", plan=plan)
    dirty, _ = skymodel_calibrate_invert(pred, sm, context="ng", plan=plan)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    _launch_gate("16c skymodel predict and invert", counts, ("grid", "degrid", "permute"))
    exact = dft_skycomponent_visibility(vis, sky).vis
    rel = float((pred.vis - exact).abs().max()) / float(exact.abs().max())
    peak = float(dirty.pixels.max())
    say(f"16c skymodel_predict_calibrate and skymodel_calibrate_invert (flagship plan): "
        f"{wall:.3f} s, launches {counts}; predict vs the DFT of the same sky rel "
        f"{rel:.3e} (bound {SKYMODEL16_TOL:g}); dirty peak {peak:.4f} (2.0 Jy source)")
    if not rel <= SKYMODEL16_TOL:
        raise AssertionError("16c: skymodel predict disagrees with the DFT")
    del plan, pred, dirty, exact
    torch.cuda.empty_cache()

    cpu_im = restored.replace(pixels=restored.pixels.cpu())
    found = {d: find_skycomponents(im, threshold=0.2, fwhm=1.0) for d, im in
             (("card", restored), ("cpu", cpu_im))}
    if found["card"].ncomp != found["cpu"].ncomp or found["card"].ncomp < len(SOURCES):
        raise AssertionError(f"16c find: {found['card'].ncomp} vs {found['cpu'].ncomp} components")
    fit = {d: fit_skycomponent(im, found[d].select([0])) for d, im in
           (("card", restored), ("cpu", cpu_im))}
    dfit = float(np.abs(fit["card"].direction - fit["cpu"].direction).max())
    dflux = float((fit["card"].flux.cpu() - fit["cpu"].flux).abs().max())
    bits = {}
    for method in ("Nearest", "Lanczos"):
        card = insert_skycomponent(restored, found["card"], insert_method=method).pixels.cpu()
        cpu = insert_skycomponent(cpu_im, found["cpu"], insert_method=method).pixels
        again = insert_skycomponent(restored, found["card"], insert_method=method).pixels.cpu()
        bits[method] = (float((card - cpu).abs().max()), torch.equal(card, again))
    say(f"16c find/fit/insert on the restored image: {found['card'].ncomp} components on "
        f"both; fit card vs CPU: direction {dfit:.3e} rad, flux {dflux:.3e}; insert card vs "
        f"CPU (max abs, the same bits twice): {bits}")
    if dfit > 1e-9 or dflux > 1e-5 or any(e > 1e-5 or not s for e, s in bits.values()):
        raise AssertionError("16c: find, fit or insert differs card vs CPU")

    vis0 = dft_skycomponent_visibility(vis, sky)
    corrupted = vis0.replace(vis=vis.vis)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corrected = gaincal(corrupted, vis0, calibration_context="T")
    torch.cuda.synchronize()
    gerr = float((corrected.vis - vis0.vis).abs().max()) / float(vis0.vis.abs().max())
    say(f"16c gaincal (flagship, \"T\"): {time.perf_counter() - t0:.3f} s; corrected vs the "
        f"uncorrupted sky rel {gerr:.3e} (bound {GAINCAL16_TOL:g})")
    if not gerr <= GAINCAL16_TOL:
        raise AssertionError("16c: gaincal did not remove the gains")
    return counts


def skymodel_small_matches_cpu(device):
    """Phase 16c's small slice: phase 7's observation through
    skymodel_predict_calibrate (docal with its true gains) and
    skymodel_calibrate_invert, and gaincal, on the card and on the CPU,
    to 1e-5 of the maximum."""
    import torch

    from ska_sdp_func_python_torch.models import create_gaintable_from_visibility, SkyModel
    from ska_sdp_func_python_torch.ops import (
        gaincal,
        skymodel_calibrate_invert,
        skymodel_predict_calibrate,
    )

    out = {}
    for dev in (device, "cpu"):
        _, vis, model, phases = simulate(dev, rmax=600.0, ntimes=8, npixel=256)
        gt = create_gaintable_from_visibility(vis, jones_type="T")
        gain = torch.polar(torch.ones(phases.shape), torch.as_tensor(phases, dtype=torch.float32))
        gt = gt.replace(gain=gain.to(dev)[..., None, None].contiguous())
        pixels = torch.zeros_like(model.pixels)
        n = model.npixel
        for dx, dy, f in SOURCES:
            pixels[0, 0, n // 2 + dy // 4, n // 2 + dx // 4] = f
        sm = SkyModel(image=model.replace(pixels=pixels), components=None, gaintable=gt, mask=None)
        pred = skymodel_predict_calibrate(vis, sm, context="ng", docal=True)
        dirty, _ = skymodel_calibrate_invert(pred, sm, context="ng", docal=True)
        corrected = gaincal(vis, skymodel_predict_calibrate(vis, sm, context="ng"), "T")
        out[dev] = [x.cpu() for x in (pred.vis, dirty.pixels, corrected.vis)]
    errs = [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip(out[device], out["cpu"])]
    bounds = (1e-5, 1e-5, 1e-4)  # gaincal: the small slices' gain bound
    say(f"16c small slice card vs CPU (predict, invert, gaincal): rel {errs} (bounds {bounds})")
    if not all(e <= b for e, b in zip(errs, bounds)):
        raise AssertionError("16c small slice: card and CPU disagree")


def run_phase16(cfg, device, vis, model, phases):
    """Phase 16 (a-c). Returns (launch counts by shape, K1/K3 rows by
    configuration, K9 rows by configuration)."""
    import torch

    t0 = time.perf_counter()
    by_shape = {}
    counts, rows, restored = run_wide_supports(vis, model, phases)
    by_shape[f"flagship ical at support {ICAL16} (phase 16a)"] = counts
    by_shape["flagship sky model (phase 16c)"] = skymodel_flagship(vis, model, restored)
    skymodel_small_matches_cpu(device)
    del restored
    torch.cuda.empty_cache()
    unit_rows, counts = run_unit_tiles_wide(cfg, device)
    by_shape["epsilon observation, tiled core path invert (phase 16b)"] = counts
    by_shape["config-4 cube spectral-component ical (phase 16c)"] = spectral_cube_ical(device)
    torch.cuda.empty_cache()
    say(f"phase 16: {time.perf_counter() - t0:.1f} s")
    return by_shape, rows, unit_rows


def main16() -> int:
    """``--phase16-only``: the build and phase 16 on the flagship."""
    import torch

    from ska_sdp_func_python_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t_start:.1f} s")
    cfg, vis, model, phases = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    by_shape, rows, unit_rows = run_phase16(cfg, device, vis, model, phases)
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print_rows("16", {**rows, **{f"unit_tiles {k}": {"unit_tiles": r} for k, r in unit_rows.items()}})
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    return 0


def flagship_grid_plan(vis, geo, tile, nearest=False):
    """The flagship's plan as the imaging API builds it (its pixel
    coordinates and w-planes at the geometry ``geo`` of its plan at
    support 8), at ``tile``, on linear or nearest planes."""
    from ska_sdp_func_python_torch.ops.gridding_plan import make_grid_plan
    from ska_sdp_func_python_torch.ops.imaging import _w_planes

    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    npad = geo["npad"]
    scale = npad * geo["cellsize"]
    p0, frac, _ = _w_planes(uvw[:, 2], geo["nw"], "nearest" if nearest else "linear")
    return make_grid_plan(-uvw[:, 0] * scale + npad // 2, uvw[:, 1] * scale + npad // 2,
                          p0, frac, npixel=npad, support=geo["support"], nplanes=geo["nw"],
                          tile=tile, beta=geo["beta"])


def _large_tile_gate(label, out, ref, tol):
    """The grids ``out`` on a large tile against ``ref``, the same stream's
    grids at the imaging API's tile: (rel error, equal bits); fails past
    ``tol`` of the maximum."""
    import torch

    rel = float((out - ref).abs().max()) / float(ref.abs().max())
    same = torch.equal(out, ref)
    say(f"{label}: against the API's tile rel {rel:.3e} (tolerance {tol:g}), the same bits: {same}")
    if not rel <= tol:
        raise AssertionError(f"{label} disagrees with the grids at the API's tile")
    return rel, same


def run_large_tiles_plan(vis, model):
    """Phase 17a: ``make_grid_plan`` + ``grid_with_plan`` at support 8 on
    the flagship at the tiles of TILES17 (the launch counters reset just
    before the two calls of each and read just after; K1 launched, the
    two calls to the same bits, its route and the cluster's band rows
    beside the tile plus span); K1 on each plan against its plain version
    accumulated in f64 (grid_row), and against the grids of the plan at
    the imaging API's tile. Returns (launch counts summed over the calls,
    kernel rows by configuration)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_fused import grid
    from ska_sdp_func_python_torch.ops.gridding_plan import grid_with_plan, sort_values
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan

    t0 = time.perf_counter()
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    api = make_visibility_plan(vis, model, context="ng").plans[0]
    geo = dict(npad=api.npad, cellsize=api.cellsize, nw=api.nw, support=api.support,
               beta=api.gp.beta)
    own = flagship_grid_plan(vis, geo, api.gp.tile)
    if not all(torch.equal(getattr(own, f), getattr(api.gp, f))
               for f in ("perm", "korder", "ku", "kv", "frac", "chunk_start")):
        raise AssertionError("17a: the plan built here differs from the imaging API's")
    del own
    launches = {name: 0 for name in KERNELS}
    rows, refs = {}, {}
    for tile, nearest in TILES17:
        ref_gp = flagship_grid_plan(vis, geo, api.gp.tile, nearest) if nearest else api.gp
        if nearest not in refs:
            ref_vals = sort_values(ref_gp, weighted)
            refs[nearest] = (grid_with_plan(ref_gp, weighted),
                             timed(lambda: grid(ref_gp, ref_vals), 10))
            del ref_vals
        if nearest:
            del ref_gp
        gp = flagship_grid_plan(vis, geo, tile, nearest)
        mode = "nearest" if nearest else "linear"
        label = f"17a flagship support {gp.support} {mode} tile {tile}"
        nacc = 2 if nearest else 4
        route = kernels.query("ska_grid_route", gp.span, tile, nacc)
        band = kernels.query("ska_grid_wide_geometry", gp.span, tile, nacc, 6)
        say(f"{label}: route {route} (1 narrow, 2 the wide kernel's bands over its cluster "
            f"hold the tile, 3 in turns); the cluster's band rows {band} beside the tile plus "
            f"span {tile + gp.span}; {wide_geometry(gp)}")
        if route < 2 or (tile == 336 and not gp.span <= band < tile + gp.span):
            raise AssertionError(f"{label}: route {route}, band rows {band}")
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = [grid_with_plan(gp, weighted) for _ in range(2)]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k in launches:
            launches[k] += counts[k]
        same = torch.equal(out[0], out[1])
        say(f"{label}: make_grid_plan + grid_with_plan twice, the same bits: {same}; "
            f"launches {counts}")
        _launch_gate(label, counts, ("grid", "permute"))
        if not same:
            raise AssertionError(f"{label}: two calls differ")
        _large_tile_gate(label, out[0], refs[nearest][0], KERNELS["grid"][0])
        del out
        row = grid_row(gp, sort_values(gp, weighted), label)
        say(f"{label}: K1 {row['ms']:.4f} ms against the narrow kernel's "
            f"{refs[nearest][1]:.4f} ms at the API's tile {api.gp.tile} (CUDA events), bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
        rows[f"flagship support {gp.support} {mode} tile {tile}"] = {"grid": row}
        del gp
        torch.cuda.empty_cache()
    del refs
    torch.cuda.empty_cache()
    say(f"17a: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def run_large_tiles_unit(cfg, device):
    """Phase 17b: ``tiled_grid`` on phase 16b's full-width stream (phase
    9's whole observation, padding 2) at the supports and tiles of UNIT17
    (the launch counters reset just before the two calls of each and read
    just after; K9 launched, the two calls to the same bits, its route and
    the cluster's band rows); K9 on each stream against its plain version
    accumulated in f64 (compare_unit_tiles), and against the grids at the
    imaging API's tile. Returns (launch counts summed over the calls, kernel
    rows by configuration)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_tiled import tiled_grid

    t0 = time.perf_counter()
    launches = {name: 0 for name in KERNELS}
    rows = {}
    for name, support, tiles in UNIT17:
        f64 = name == "f64"
        dtype = torch.float64 if f64 else torch.float32
        tol, peak = (UNIT_TILES_F64_TOL, PEAK_F64_S) if f64 else (KERNELS["unit_tiles"][0], PEAK_F32_S)
        vis, model, _, _ = observation9(cfg, device, dtype)
        ref_stream, ref_geo = unit_stream16(vis, model, support)
        ref = ref_stream.grid(**ref_geo)
        ref_ms = timed(lambda: ref_stream.grid(**ref_geo), 5)
        del ref_stream
        for tile in tiles:
            args, kw, geo = unit_inputs16(vis, model, support, tile)
            label = f"17b {name} support {support} tile {tile}"
            route = kernels.query("ska_unit_tiles_route", support, tile, int(f64))
            band = kernels.query("ska_unit_tiles_wide_geometry", support, tile, int(f64), 6)
            say(f"{label}: route {route} (1 narrow, 2 the wide variant's bands over its "
                f"cluster hold the tile, 3 in turns); the cluster's band rows {band} beside "
                f"the tile plus support and its margin row {tile + support + 1}")
            if route < 2:
                raise AssertionError(f"{label}: route {route}")
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            out = [tiled_grid(*args, beta=geo["beta"], **kw) for _ in range(2)]
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            for k in launches:
                launches[k] += counts[k]
            same = torch.equal(out[0], out[1])
            say(f"{label}: tiled_grid twice ({int(args[0].shape[0])} visibilities), the same "
                f"bits: {same}; launches {counts}")
            _launch_gate(label, counts, ("unit_tiles",))
            if not same:
                raise AssertionError(f"{label}: two calls differ")
            _large_tile_gate(label, out[0], ref, tol)
            del out, args
            stream, geo = unit_stream16(vis, model, support, tile)
            row = compare_unit_tiles(stream, geo, label, tol, peak)
            say(f"{label}: K9 {row['ms']:.4f} ms against {ref_ms:.4f} ms at the API's tile "
                f"{ref_geo['tile']} (CUDA events), bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
            rows[f"{name} support {support} tile {tile} full stream"] = row
            del stream
            torch.cuda.empty_cache()
        del vis, model, ref
        torch.cuda.empty_cache()
    say(f"17b: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def route_limits():
    """Phase 17's limit table, from the library's own route queries: for
    K1 each window span (2 to 128: supports 1 to 128) on linear (nacc 4)
    and nearest or one-plane plans (nacc 2), for K9 each support (1 to
    128) in f32 and f64: the largest tile the narrow kernel holds, the
    largest its cluster-banded wide variant serves (up to LIMIT17_MAX;
    past it, and past a span of 64, route 4 serves), and
    whether every tile from the support up is taken: every tile up to 512
    and every one that divides a 1024^2, 1344^2, 2048^2 or 4096^2 grid;
    fails if any is refused."""
    import ctypes

    from ska_sdp_func_python_torch import kernels

    lib = kernels.load_library()
    tiles = sorted(set(range(1, 513)) | {t for n in (1024, 1344, 2048, 4096)
                                         for t in range(1, n + 1) if n % t == 0})
    refused = []
    for kernel, symbol, keys, sizes in (("K1", "ska_grid_route", (4, 2), range(2, 129, 2)),
                                        ("K9", "ska_unit_tiles_route", (0, 1), range(1, 129))):
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
        for key in keys:
            line = []
            for size in sizes:
                routes = {t: fn(size, t, key) for t in tiles if t >= size}
                narrow = max([t for t, r in routes.items() if r == 1], default=0)
                refused += [(kernel, key, size, t) for t, r in routes.items() if r == 0]
                banded = 0
                if size <= 64:
                    # the banded routes' tiles end where route 4's begin:
                    # the last tile not on route 4
                    lo, hi = size, LIMIT17_MAX + 1
                    while lo < hi:
                        mid = (lo + hi) // 2
                        if fn(size, mid, key) == 4:
                            hi = mid
                        else:
                            lo = mid + 1
                    banded = lo - 1 if lo - 1 >= size and fn(size, lo - 1, key) in (2, 3) else 0
                every = "every tile" if all(routes.values()) else "REFUSED"
                line.append(f"{size}: {narrow or '-'}/{banded or '-'}/{every}")
            what = (f"K1 (grid) nacc {key}, by window span" if kernel == "K1"
                    else f"K9 (unit_tiles) {'f64' if key else 'f32'}, by support")
            say(f"17 limits {what} (the narrow kernel's largest tile / the cluster-banded "
                f"routes' largest, to {LIMIT17_MAX} / the tiles taken): " + ", ".join(line))
    say(f"17 limits: tiles refused: {refused or 'none'}")
    if refused:
        raise AssertionError(f"17: refused tiles: {refused[:20]}")


def run_phase17(cfg, device, vis, model):
    """Phase 17 (a, b, the limit table). Returns (launch counts by shape,
    K1 rows by configuration, K9 rows by configuration)."""
    t0 = time.perf_counter()
    route_limits()
    by_shape = {}
    counts, rows = run_large_tiles_plan(vis, model)
    by_shape["flagship plans on large tiles (phase 17a)"] = counts
    counts, unit_rows = run_large_tiles_unit(cfg, device)
    by_shape["epsilon observation, tiled_grid on large tiles (phase 17b)"] = counts
    say(f"phase 17: {time.perf_counter() - t0:.1f} s")
    return by_shape, rows, unit_rows


def main17() -> int:
    """``--phase17-only``: the build and phase 17 on the flagship."""
    import torch

    from ska_sdp_func_python_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t_start:.1f} s")
    cfg, vis, model, _ = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    by_shape, rows, unit_rows = run_phase17(cfg, device, vis, model)
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print_rows("17", {**rows, **{f"unit_tiles {k}": {"unit_tiles": r} for k, r in unit_rows.items()}})
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    return 0


def flagship_geometry(vis, model):
    """The flagship's plan geometry as the imaging API builds it (padding
    1.25: npad 1344, nw 6)."""
    from ska_sdp_func_python_torch.ops.imaging import make_visibility_plan

    p0 = make_visibility_plan(vis, model, context="ng").plans[0]
    return dict(npad=p0.npad, cellsize=p0.cellsize, nw=p0.nw, npixel=model.npixel)


def at_support(geo, support):
    """``geo`` at ``support``, with the imaging API's ES beta for it."""
    from ska_sdp_func_python_torch.ops.gridding import _es_beta

    return dict(geo, support=support, beta=_es_beta(support, geo["npad"] / geo["npixel"]))


def _main_path_twice(label, kernel_names, fn):
    """``fn`` twice, the launch counters reset just before and read just
    after: every kernel of ``kernel_names`` launched, the two results the
    same bits. Returns (the first result, the counts)."""
    import torch

    from ska_sdp_func_python_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = [fn() for _ in range(2)]
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    same = torch.equal(out[0], out[1])
    say(f"{label}: twice, the same bits: {same}; launches {counts}")
    _launch_gate(label, counts, kernel_names)
    if not same:
        raise AssertionError(f"{label}: two calls differ")
    return out[0], counts


def run_any_tile_plan(vis, model):
    """Phase 18a: ``make_grid_plan`` + ``grid_with_plan`` on the flagship's
    whole stream at the supports of SUPPORTS18 with one tile the whole
    padded grid (TILE18), where no cluster's bands hold one window's rows:
    K1's route 4 launched, two calls to the same bits, against the grids
    at the API's tile (56, or 64 where the support is wider) and, through
    grid_row, against its plain version accumulated in f64 in pieces with
    its time, its bound and its time over it, beside K1w's time at the
    API's tile. Returns (launch counts summed over the
    calls, kernel rows by configuration)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_fused import grid
    from ska_sdp_func_python_torch.ops.gridding_plan import grid_with_plan, sort_values

    t0 = time.perf_counter()
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    launches = {name: 0 for name in KERNELS}
    rows = {}
    base = flagship_geometry(vis, model)
    for support in SUPPORTS18:
        ref_tile = 56 if support <= 56 else 64
        geo = at_support(base, support)
        ref_gp = flagship_grid_plan(vis, geo, ref_tile)
        ref = grid_with_plan(ref_gp, weighted)
        ref_vals = sort_values(ref_gp, weighted)
        ref_ms = timed(lambda: grid(ref_gp, ref_vals), 5)
        del ref_gp, ref_vals
        gp = flagship_grid_plan(vis, geo, TILE18)
        label = f"18a flagship support {support} linear tile {TILE18}"
        route = kernels.query("ska_grid_route", gp.span, TILE18, 4)
        say(f"{label}: route {route} (4: sub-tiles over a cluster); {route4_geometry(gp)}")
        if route != 4:
            raise AssertionError(f"{label}: route {route}")
        out, counts = _main_path_twice(label, ("grid", "permute"),
                                       lambda: grid_with_plan(gp, weighted))
        for k in launches:
            launches[k] += counts[k]
        _large_tile_gate(label, out, ref, KERNELS["grid"][0])
        del out, ref
        row = grid_row(gp, sort_values(gp, weighted), label, plain_reps=0, reps=5)
        say(f"{label}: K1 {row['ms']:.4f} ms against K1w's {ref_ms:.4f} ms at tile {ref_tile} "
            f"(CUDA events), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['ms'] / row['bound_ms']:.1f} x the bound")
        rows[f"flagship support {support} linear tile {TILE18}"] = {"grid": row}
        del gp
        torch.cuda.empty_cache()
    say(f"18a: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def long_window_plan(uvw, base, support, tile, mode):
    """Phase 18b's plan of the entries ``uvw`` at ``support`` on tiles of
    ``tile`` cells, on ``mode`` ("linear" or "nearest") w-planes of the
    flagship's geometry ``base`` (flagship_geometry)."""
    from ska_sdp_func_python_torch.ops.gridding_plan import make_grid_plan
    from ska_sdp_func_python_torch.ops.imaging import _w_planes

    geo = at_support(base, support)
    npad, scale = geo["npad"], geo["npad"] * geo["cellsize"]
    p0, frac, _ = _w_planes(uvw[:, 2], geo["nw"], mode)
    return make_grid_plan(-uvw[:, 0] * scale + npad // 2, uvw[:, 1] * scale + npad // 2,
                          p0, frac, npixel=npad, support=support, nplanes=geo["nw"],
                          tile=tile, beta=geo["beta"])


def run_long_windows(vis, model):
    """Phase 18b: K1 and K3 at windows past 64 cells on the flagship's
    first million entries, at the (support, tile) pairs of WIDE18, linear
    and nearest: ``make_grid_plan`` + ``grid_with_plan`` and
    ``degrid_with_plan`` twice each (the launch counters reset just before
    and read just after; grid, degrid and permute launched, the same bits),
    then K1's route 4 and K3's long-window kernel against their plain
    versions in pieces (plan_kernels), each K1 row with its time over its
    bound and its f32 grids' distance from the plain version accumulated
    in f64 beside beta x 2^-24 (not gated). Returns (launch counts summed
    over the calls, kernel rows by configuration)."""
    import torch

    from ska_sdp_func_python_torch.ops.gridding_plan import (
        degrid_with_plan, grid_with_plan, sort_values)

    t0 = time.perf_counter()
    weighted = (vis.vis * vis.imaging_weight)[:, :, 0, 0].reshape(-1)
    uvw = vis.uvw_lambda[:, :, 0].reshape(-1, 3)
    n_sub = min(1 << 20, uvw.shape[0])
    uvw, weighted = uvw[:n_sub], weighted[:n_sub]
    launches = {name: 0 for name in KERNELS}
    rows = {}
    base = flagship_geometry(vis, model)
    for support, tile in WIDE18:
        for mode in ("linear", "nearest"):
            gp = long_window_plan(uvw, base, support, tile, mode)
            label = f"18b flagship 1M subset support {support} {mode} tile {tile}"
            g = torch.Generator(device=weighted.device).manual_seed(support)
            grids = torch.randn((gp.nplanes, gp.npixel, gp.npixel), generator=g,
                                device=weighted.device, dtype=torch.complex64)
            _, counts = _main_path_twice(
                label, ("grid", "degrid", "permute"),
                lambda: torch.cat([grid_with_plan(gp, weighted).reshape(-1),
                                   degrid_with_plan(gp, grids)]))
            for k in launches:
                launches[k] += counts[k]
            del grids
            row = plan_kernels(gp, sort_values(gp, weighted), label, plain_reps=0, reps=(5, 5))
            k1 = row["grid"]
            say(f"{label}: K1 {k1['ms']:.4f} ms, {k1['ms'] / k1['bound_ms']:.1f} x the bound "
                f"({k1['bound_ms']:.4f} ms, {k1['bound_by']}); its f32 grids against grid_plain "
                f"accumulated in f64 rel {k1['rel']:.3e}, beside beta x 2^-24 = "
                f"{at_support(base, support)['beta'] * 2.0**-24:.3e} (not gated)")
            rows[f"flagship 1M subset support {support} {mode} tile {tile}"] = row
            del gp
            torch.cuda.empty_cache()
    say(f"18b: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def f32_taps_deviation(stream, geo, label):
    """Prints (no gate) how far K9's f32 grids of ``stream`` lie from its
    plain version accumulated in f64, beside beta x 2^-24: past a support
    of 64 the f32 ES taps' beta (sqrt(1 - nu^2) - 1) cancels that much
    away, in the plain version in f32 and the JAX package alike."""
    import dataclasses

    import torch

    ref = dataclasses.replace(stream, u=stream.u.double(), v=stream.v.double(),
                              vals=stream.vals.to(torch.complex128)).grid(plain=True, **geo)
    err = float((stream.grid(**geo).to(torch.complex128) - ref).abs().max())
    peak = float(ref.abs().max())
    say(f"{label}: against the plain version accumulated in f64 rel "
        f"{err / peak if peak else 0.0:.3e}, beside beta x 2^-24 = {geo['beta'] * 2.0**-24:.3e} "
        f"(not gated)")


def run_any_support_unit(cfg, device):
    """Phase 18c-d: ``tiled_grid`` on phase 16b's full-width stream (phase
    9's whole observation, padding 2, 2048^2) with one tile the whole grid
    (UNIT18_TILE_FULL) at the supports of UNIT18_FULL, f32 and f64, where
    no cluster's bands hold one window's rows (c); then at the (support,
    tile, padding) of UNIT18 (past 64, 1, and past the largest window a
    cluster holds) on 16b's stream cut to
    UNIT16_TIMES integrations (d). Each twice (the launch counters reset
    just before and read just after; K9 launched, the same bits) and K9's
    route 4 against its plain version (compare_unit_tiles): in (c) the
    plain version at the API's tile 64, whose grids equal the plain
    version's at one tile the grid (the same sums, partitioned otherwise:
    tests/test_torch_any_support.py), since the dense plain form at tile
    2048 takes minutes; in f64 accumulated in f64 (1e-12), in f32 in (c)
    accumulated in f64 (1e-5) and in (d) in f32 (1e-5: past 64 the f32 ES
    taps, evaluated alike by the kernel, the plain version and the JAX
    package, lie about 1e-5 from the f64 ones). Returns (launch counts
    summed over the calls, kernel rows by configuration)."""
    import torch

    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.gridding_tiled import tiled_grid

    t0 = time.perf_counter()
    launches = {name: 0 for name in KERNELS}
    rows = {}
    for name, dtype, tol, peak in (("f32", torch.float32, KERNELS["unit_tiles"][0], PEAK_F32_S),
                                   ("f64", torch.float64, UNIT_TILES_F64_TOL, PEAK_F64_S)):
        f64 = int(dtype == torch.float64)
        # every case but support 1 runs the band kernel, 384 on tile 512 in
        # blocks, windows clipped to each
        for s, t, _ in UNIT18:
            geo = [kernels.query("ska_unit_tiles_band_geometry", s, t, f64, w) for w in (0, 11)]
            if s > 1 and (not geo[0] or bool(geo[1]) != (s == 384)):
                raise AssertionError(f"18d {name}: support {s} tile {t}: band geometry {geo}")
        for part, ntimes, cases in (
                ("c", None, [(s, UNIT18_TILE_FULL, 2.0) for s in UNIT18_FULL]),
                ("d", UNIT16_TIMES, UNIT18)):
            vis, model, _, _ = observation9(cfg, device, dtype,
                                            **({} if ntimes is None else {"ntimes": ntimes}))
            where = "full stream" if ntimes is None else f"{ntimes} integrations"
            for support, tile, padding in cases:
                args, kw, geo = unit_inputs16(vis, model, support, tile, padding)
                grid_at = "" if padding == 2.0 else f" padding {padding} ({geo['npixel']}^2)"
                label = f"18{part} {name} support {support} tile {tile} {where}{grid_at}"
                route = kernels.query("ska_unit_tiles_route", support, tile, f64)
                say(f"{label}: route {route} (4: sub-tiles over a cluster); "
                    f"{band_geometry(support, tile, f64)}")
                if route != 4:
                    raise AssertionError(f"{label}: route {route}")
                _, counts = _main_path_twice(
                    label, ("unit_tiles",), lambda: tiled_grid(*args, beta=geo["beta"], **kw))
                for k in launches:
                    launches[k] += counts[k]
                del args
                stream, geo = unit_stream16(vis, model, support, tile, padding)
                plain_at = unit_stream16(vis, model, support) if part == "c" else None
                row = compare_unit_tiles(stream, geo, label, tol, peak, plain_at=plain_at,
                                         reps=3, plain_f64=bool(f64) or part == "c")
                rows[f"{name} support {support} tile {tile} {where}{grid_at}"] = row
                if part == "d" and not f64:
                    f32_taps_deviation(stream, geo, label)
                del stream, plain_at
                torch.cuda.empty_cache()
            del vis, model
            torch.cuda.empty_cache()
    say(f"18c-d: {time.perf_counter() - t0:.1f} s")
    return launches, rows


def run_phase18(cfg, device, vis, model):
    """Phase 18 (a-d). Returns (launch counts by shape, K1/K3 rows by
    configuration, K9 rows by configuration)."""
    t0 = time.perf_counter()
    by_shape = {}
    counts, rows = run_any_tile_plan(vis, model)
    by_shape["flagship plan, one tile the padded grid (phase 18a)"] = counts
    counts, more = run_long_windows(vis, model)
    rows.update(more)
    by_shape["flagship 1M subset, windows past 64 cells (phase 18b)"] = counts
    counts, unit_rows = run_any_support_unit(cfg, device)
    by_shape["epsilon observation, tiled_grid at any support and tile (phase 18c-d)"] = counts
    say(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return by_shape, rows, unit_rows


def main18() -> int:
    """``--phase18-only``: the build and phase 18 on the flagship."""
    import torch

    from ska_sdp_func_python_torch import kernels

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t_start:.1f} s")
    cfg, vis, model, _ = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    by_shape, rows, unit_rows = run_phase18(cfg, device, vis, model)
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print_rows("18", {**rows, **{f"unit_tiles {k}": {"unit_tiles": r} for k, r in unit_rows.items()}})
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    return 0


def print_rows(tag, rows):
    """One line a configuration: each kernel's time, bound, plain time and
    error."""
    for shape, krows in rows.items():
        say(f"{tag} {shape}: " + "; ".join(
            f"{k} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"plain {r['plain_ms']:.3f} ms, rel err {r['rel']:.3e}" for k, r in krows.items()))


def report_kernel(name, r, label=""):
    """Prints a kernel's comparison with its plain version, and fails if
    the error is above its tolerance."""
    tol = KERNELS[name][0]
    ok = r["rel"] <= tol
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.3f} ms"
    say(
        f"kernel {name}{label}: max abs err {r['max_abs_err']:.3e}, rel err "
        f"{r['rel']:.3e} (tolerance {tol:g}) {'ok' if ok else 'FAIL'}; "
        f"kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library {lib}"
    )
    if not ok:
        raise AssertionError(f"kernel {name}{label} disagrees with its plain version")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from ska_sdp_func_python_torch import kernels
    from ska_sdp_func_python_torch.ops.imaging import (
        invert_visibility,
        make_visibility_plan,
    )
    from ska_sdp_func_python_torch.ops.deconvolution import bound_psf

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    say(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(
        f"host: {host_cpu()}, {torch.get_num_threads()} threads, "
        f"{torch.backends.cpu.get_cpu_capability()}, MKL_CBWR={os.environ['MKL_CBWR']}"
    )

    t0 = time.perf_counter()
    kernels.build_library()
    kernels.load_library()
    say(f"build: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say(f"build: {line.strip()}")

    t0 = time.perf_counter()
    cfg, vis, model, phases = simulate(device, rmax=40000.0, ntimes=76, npixel=1024)
    torch.cuda.synchronize()
    say(
        f"observation: {cfg.nants} stations, {vis.nvis} visibilities, "
        f"{model.npixel}^2 image, simulated in {time.perf_counter() - t0:.1f} s"
    )
    plan = make_visibility_plan(vis, model, context="ng")
    p0 = plan.plans[0]
    say(f"plan: npad {p0.npad}, nw {p0.nw}, tile {p0.gp.tile}, in-grid {p0.gp.n_in}/{p0.gp.n}")
    dirty, _ = invert_visibility(vis, model, plan=plan)
    psf, _ = invert_visibility(vis, model, dopsf=True, plan=plan)
    psf_patch = bound_psf(psf, psf).pixels.to(torch.float32)

    results = compare_gridding(device, vis, plan)
    results.update(compare_cleaners(dirty.pixels[0, 0].to(torch.float32), psf_patch))
    for name, r in results.items():
        report_kernel(name, r)
    del psf_patch, plan
    torch.cuda.empty_cache()

    launches = {name: 0 for name in KERNELS}
    by_shape = {}
    for counts in (
        run_hogbom_ical(vis, model, phases),
        run_msclean_ical(vis, model, phases),
        run_deconvolve_cube(dirty, psf),
    ):
        for name in launches:
            launches[name] += counts[name]
    by_shape["flagship ical and deconvolve_cube (phases 4-6)"] = dict(launches)
    del dirty, psf
    small_slice_matches_cpu(device, "hogbom")
    # msclean to a fractional threshold of 0.05: at 0.01 this small array's
    # clean goes on to PSF-sidelobe structure where peaks tie to 1e-5, below
    # the f32 difference between the card's and the CPU's dirty images
    small_slice_matches_cpu(device, "msclean", fractional_threshold=0.05)
    counts = run_tg_flagship(vis, model, phases)
    for name in launches:
        launches[name] += counts[name]
    by_shape["flagship TG ical (phase 10a)"] = counts
    rows13 = {"flagship support 8 linear": {k: results[k] for k in ("grid", "degrid")}}
    counts, rows = run_support_flagship(vis, model, phases)
    rows13.update(rows)
    for name in launches:
        launches[name] += counts[name]
    by_shape["flagship ical at supports 6 and 12 (phase 13a)"] = counts
    counts = run_weighting_flagship(vis, model)
    for name in launches:
        launches[name] += counts[name]
    by_shape["flagship PSFs of three weightings (phase 13c)"] = counts
    # 13e: at support 6 the Hogbom slice picks between near-equal peaks,
    # which the CPU's f32 plain grid orders differently from K1: the card
    # is held to the CPU run gridded in f64
    small_slice_matches_cpu(device, "hogbom", f64_witness=True, support=6)
    small_slice_matches_cpu(device, "msclean", support=6, fractional_threshold=0.05)
    small_nearest_matches_cpu(device)
    counts14, results["grid_convert"] = run_parallel(device, vis, model)
    report_kernel("grid_convert", results["grid_convert"])
    for shape, counts in counts14.items():
        for name in launches:
            launches[name] += counts[name]
        by_shape[shape] = counts
    torch.cuda.empty_cache()
    counts16, rows16, unit_rows16 = run_phase16(cfg, device, vis, model, phases)
    for shape, counts in counts16.items():
        for name in launches:
            launches[name] += counts[name]
        by_shape[shape] = counts
    torch.cuda.empty_cache()
    counts17, rows17, unit_rows17 = run_phase17(cfg, device, vis, model)
    for shape, counts in counts17.items():
        for name in launches:
            launches[name] += counts[name]
        by_shape[shape] = counts
    torch.cuda.empty_cache()
    counts18, rows18, unit_rows18 = run_phase18(cfg, device, vis, model)
    for shape, counts in counts18.items():
        for name in launches:
            launches[name] += counts[name]
        by_shape[shape] = counts
    del vis, model
    torch.cuda.empty_cache()
    counts = run_periphery(device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["MID observation, plan routes (phase 15a)"] = counts
    torch.cuda.empty_cache()

    results["msmfs"], counts, counts_13d = run_cube(device)
    for name in launches:
        launches[name] += counts[name] + counts_13d[name]
    by_shape["config-4 cube (phases 8b-c)"] = counts
    by_shape["config-4 cube list API (phase 13d)"] = counts_13d
    report_kernel("msmfs", results["msmfs"])
    small_cube_matches_cpu(device)
    torch.cuda.empty_cache()
    counts = run_tb_cube(device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["config-4 cube TB ical (phase 10b)"] = counts
    small_calibration_slices(device)
    torch.cuda.empty_cache()

    counts, _ = run_polarised_flagship(cfg, device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["polarised flagship (phases 11a-b)"] = counts
    counts, _ = run_mfs(device)
    for name in launches:
        launches[name] += counts[name]
    by_shape["config-4 MFS (phase 11c)"] = counts
    small_jones_slice(device)
    torch.cuda.empty_cache()

    results["unit_tiles"], counts, counts_13b, rows = run_epsilon_phase(cfg, device)
    rows13.update(rows)
    for name in launches:
        launches[name] += counts[name] + counts_13b[name]
    by_shape["epsilon observation (phases 9b-e)"] = counts
    by_shape["epsilon observation on a nearest plan (phase 13b)"] = counts_13b
    report_kernel("unit_tiles", results["unit_tiles"])
    torch.cuda.empty_cache()

    for shape, run in (("streamed flagship (phase 12a)", streamed_parity),
                       ("100M streamed store (phases 12b-c)", streamed_scale)):
        counts = run(device)
        for name in launches:
            launches[name] += counts[name]
        by_shape[shape] = counts
        torch.cuda.empty_cache()
    streamed_card_vs_cpu(device)
    for shape, counts in by_shape.items():
        say(f"launches at the {shape}: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    print_rows("13", rows13)
    print_rows("16", {**rows16, **{f"unit_tiles {k}": {"unit_tiles": r}
                                   for k, r in unit_rows16.items()}})
    print_rows("17", {**rows17, **{f"unit_tiles {k}": {"unit_tiles": r}
                                   for k, r in unit_rows17.items()}})
    print_rows("18", {**rows18, **{f"unit_tiles {k}": {"unit_tiles": r}
                                   for k, r in unit_rows18.items()}})
    held = {"grid": (list(rows13) + list(rows16) + [f"17a {k}" for k in rows17]
                     + [f"18 {k}" for k in rows18]),
            "degrid": list(rows13) + list(rows16) + [f"18 {k}" for k, r in rows18.items()
                                                     if "degrid" in r],
            "unit_tiles": (["phase 9 epsilon streams"] + list(unit_rows16)
                           + [f"17b {k}" for k in unit_rows17]
                           + [f"18 {k}" for k in unit_rows18])}

    say(json.dumps({
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": KERNELS[name][1],
                "replaces": KERNELS[name][2],
                "launches": launches[name],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"],
                "bound_ms": results[name]["bound_ms"],
                "bound_by": results[name]["bound_by"],
                "library_ms": results[name]["library_ms"],
                **({"held_at": held[name]} if name in held else {}),
            }
            for name in KERNELS
        ]
    }))
    say(f"command: {time.perf_counter() - t_start:.1f} s")
    say(card)
    say(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--profile-streamed", action="store_true",
                    help="only profile phase 12b's streamed cycle (see profile_streamed)")
    ap.add_argument("--wire", default="f16", choices=["f16", "f32"])
    ap.add_argument("--store-uvw", action="store_true", help="upload the store's uvw")
    ap.add_argument("--repeat-selfcal", type=int, metavar="N",
                    help="only run phase 10c's checkpoint observation N times (see repeat_selfcal)")
    ap.add_argument("--phase14-only", action="store_true",
                    help="only build the kernels and run phase 14 (the parallel layer)")
    ap.add_argument("--phase15-only", action="store_true",
                    help="only build the kernels and run phase 15 (the imaging periphery, "
                         "K9's repeats)")
    ap.add_argument("--phase16-only", action="store_true",
                    help="only build the kernels and run phase 16 (supports past 16, "
                         "the sky-component periphery)")
    ap.add_argument("--phase17-only", action="store_true",
                    help="only build the kernels and run phase 17 (tiles the imaging API "
                         "never picks, and the limit table)")
    ap.add_argument("--phase18-only", action="store_true",
                    help="only build the kernels and run phase 18 (every support and tile "
                         "the JAX package's gridders take)")
    ap.add_argument("--phase14-child", nargs=4, metavar=("RANK", "PORT", "INPUTS", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.phase14_child:
        rank, port, inputs, out = args.phase14_child
        sys.exit(phase14_child(int(rank), int(port), inputs, out))
    if args.phase14_only:
        sys.exit(main14())
    if args.phase15_only:
        sys.exit(main15())
    if args.phase16_only:
        sys.exit(main16())
    if args.phase17_only:
        sys.exit(main17())
    if args.phase18_only:
        sys.exit(main18())
    if args.profile_streamed:
        sys.exit(profile_streamed(args.wire, args.store_uvw))
    if args.repeat_selfcal:
        sys.exit(repeat_selfcal(args.repeat_selfcal))
    sys.exit(main())
