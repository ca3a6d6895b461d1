#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bcd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-crop H W [--radius R]

The second form times one ``bcd -w R -b B --stats`` run on the scene's
top-left H x W crop through the CLI's entry point, after the kernels are
built, and runs nothing else: R is phase 8's to 17's patch radius (4, 5,
6, 7, 8, 9, 10, 11, 12 or 13; 5 by default) and B its search radius (8,
10, 11, 13, 15, 16, 18, 20, 22 or 23).

Phases of the first, each printed on its own lines; any failure exits
non-zero before the final line:

1. The card (name, count, power limit) and the kernel build: nvcc's
   register, shared-memory and spill report for every kernel; K2's must
   show no spill (its Jacobi lives in registers). Beside the build, the
   1088x1920 scene of phases 2 to 17, its statistics and EXR files.
2. Each kernel against its plain PyTorch twin, timed with CUDA events,
   beside its bound (``bcd_tpu_torch/ops/bounds.py``, from this run's
   shapes and mask counts); K2 also against the plain fp32 model of its own
   schedule. K1 masks_moments, K2 solve_matrices_pm and K4 apply_scatter at the
   -w 1 path's shapes (b=6, r=1, 60 bins, tile 32) on one tile batch of
   the golden scene and one of the full-size scene, K2 also through K4 on
   every pixel the batch's filters reach; solve_filter and the lane-form
   solve_matrices on synthetic stacks at d = 27 and 75, and on one real
   16-tile batch of the full-size scene at r=2, b=6 (the stacks the
   -w 2 engine builds), finite on every center; both also against the
   plain fp32 model of their schedule, and solve_filter's in-place entry
   (the engine's) against its compact one, bit for bit.
3. The golden scene (tests/golden) through the port: monoscale and 2-scale
   outputs within rmse 1e-4 of the committed goldens, and the main-path
   fraction (gate sum over managed pixels).
4. The default ``bcd`` run through ``python -m bcd_tpu_torch.cli``'s entry
   point on a 1088x1920, 4 spp scene (-p 1 -s 3, b=6, r=1): the output must
   beat the noisy input against the clean render, and K1, K2 and K4 must
   each have launched. Wall time, MPix/s, peak memory; the same pipeline
   with K2's float64 twin in K2's place, within the goldens' rmse bound;
   device time by kernel from one traced run.
5. The -w 2 run through the CLI's entry point on the same scene: it must
   launch solve_filter and beat the noisy input. Wall time, MPix/s and
   peak memory of the r=2 pipeline (bitwise repeatable); the card against
   the port's CPU pipeline on a 64x64 crop; device time by kernel.
6. Ingest and the renderer surface on a 1088x1920, 16 spp RGBA render of
   the same scene: its raw dump through ``raw2bcd_cli.main`` on the card
   (read, accumulate and write times; the statistics against the float64
   stand-in ``accumulate_statistics``; the accumulator bitwise repeatable,
   its device time beside its bound), ``bcd --stats`` on its EXRs (the
   counters against the managed pixel count), ``MultiscaleDenoiser``
   on the in-memory statistics bitwise ``denoise_multiscale``'s, and the
   batch CLI, without stats, on two copies of the frame and a broken one
   (isolation, each output bit for bit the ``--stats`` run's, twice its
   launches, ``--resume``).
7. The -w 3 path (d = 147, the shared-memory solve kernel
   solve_filter_smem) on the same scene: the kernel against the fp32 model
   of its schedule and its float64 twin on synthetic stacks and on one
   real 16-tile r = 3 batch (its in-place rows bit for bit), its time
   beside its bound; ``bcd -w 3`` through the CLI's entry point on the
   scene's top-left 256x480 (launches only solve_filter_smem, beats the
   noisy input; wall time, peak memory,
   main-path fraction; the kernel's share of its device time, the run
   traced); a 32x32 crop on the card against the port's CPU pipeline,
   bitwise repeatable.
8. The -w 4 path (d = 243, the same kernel with the rows that do not fit
   in shared memory in a global slot, solve_filter_243) at b = 8, the
   smallest window that reaches its main path: the kernel against its
   fp32 model and float64 twin on synthetic stacks and on one real
   16-tile r = 4, b = 8 batch (in-place rows bit for bit), its time
   beside its bound; ``bcd -w 4 -b 8`` through the CLI's entry point on a
   crop of the scene (launches only solve_filter_243, beats the noisy
   input; the kernel's share of its device time, traced); ``bcd -w 4`` at
   b = 6 on that crop, where no center reaches a solve (launches no
   solve kernel); a 32x32 crop on the card against the port's CPU
   pipeline, bitwise repeatable.
9. The -w 5 path (d = 363, the same kernel with 580 of the 728 rows in
   the global slot, solve_filter_363) at b = 10, the smallest window that
   reaches its main path, checked as phase 8 checks the -w 4 path: on
   synthetic stacks against the float64 twin at the engine's 8 sweeps and
   against its fp32 model at 10, where the schedule has converged; one
   real 16-tile r = 5, b = 10 batch, a part of it timed once in place (its
   first 528 and last 264 main-path rows, held bit for bit to the compact
   call, the last past element 2^31 of the stack); ``bcd -w 5 -b 10`` on a
   crop
   (launches only
   solve_filter_363); ``bcd -w 5 -b 9`` on that crop (no solve launch); a
   32x32 crop against the port's CPU pipeline.
10. The -w 6 path (d = 507, the same kernel with 913 of the 1,016 rows in
   the global slot, solve_filter_507, 9 Jacobi sweeps) at b = 11, the
   smallest window that reaches its main path, checked as phase 9 checks
   the -w 5 path: synthetic stacks against the float64 twin at 9 sweeps
   and against the fp32 model at 11; one real 8-tile r = 6, b = 11 batch
   (the engine's batch at this d), a part of it timed once in place (its
   first and last main-path rows, the last past element 2^31 of the
   stack, bit for bit against the compact call); ``bcd -w 6 -b 11 -s 2``
   on a 40x40 crop (the smallest size here whose centers reach the solve;
   launches only solve_filter_507); ``bcd -w 6 -b 10 -s 2`` on that crop
   (no solve launch); that crop against the port's CPU pipeline.
11. The -w 7 path (d = 675, the same kernel with 1,280 of the 1,352 rows
   in the global slot and the Cholesky's pivot rows in shared memory,
   solve_filter_675, 9 sweeps) at b = 13, checked as phase 10 checks the
   -w 6 path: synthetic stacks against the float64 twin at 9 sweeps and
   the fp32 model at 11; one real 4-tile r = 7, b = 13 batch, its first
   and last main-path rows timed once in place; ``bcd -w 7 -b 13 -s 2``
   on a 40x40 crop (launches only solve_filter_675; peak memory);
   ``bcd -w 7 -b 12 -s 2`` on that crop (no solve launch); that crop
   against the port's CPU pipeline. Then ``bcd -w 3 -b 33`` on a 64x128 crop: the
   engine's batch rule, 4 tiles a batch there, and its peak memory.
12. The -w 8 path (d = 867, the same kernel with 1,683 of the 1,736 rows
   in the global slot, solve_filter_867) at b = 15, checked as phase 11
   checks the -w 7 path: synthetic stacks against the float64 twin at the
   engine's sweeps and the fp32 model two sweeps past them; one real
   2-tile r = 8, b = 15 batch, its first and last main-path rows timed
   once in place; ``bcd -w 8 -b 15 -s 2`` on a 46x46 crop (launches only
   solve_filter_867; peak memory; two scales, since at three a 64x64
   crop's 16x16 coarsest scale holds no 17x17 patch); ``bcd -w 8 -b 14
   -s 2`` on that crop (no solve launch); that crop against the port's
   CPU pipeline.
13. The -w 9 path (d = 1083, the same kernel with 2,128 of the 2,168 rows
   in the global slot and nine pivot passes a round, a lane of a group
   forming the angles of two passes, solve_filter_1083, 10 sweeps) at
   b = 16, checked as phase 12 checks the -w 8 path: synthetic stacks
   against the float64 twin at the engine's sweeps and
   the fp32 model two sweeps past them; one real 2-tile r = 9, b = 16
   batch, its first and last main-path rows timed once in place, the
   last past element 2^31 of the stack; ``bcd -w 9 -b 16 -s 2``
   on a 52x52 crop (launches only solve_filter_1083; peak memory);
   ``bcd -w 9 -b 15 -s 2`` on that crop (no solve launch); that crop
   against the port's CPU pipeline.
14. The -w 10 path (d = 1323, the same kernel with 2,618 of the 2,648 rows
   in the global slot and eleven pivot passes a round, lanes 0-2 of a
   group forming the angles of two passes, solve_filter_1323) at b = 18,
   checked as phase 13 checks the -w 9 path: synthetic stacks against
   the float64 twin at the engine's sweeps and the fp32 model two
   sweeps past them; the real one-tile r = 10, b = 18 batch, its first and
   last main-path rows timed once in place; ``bcd -w 10 -b 18 -s 2``
   on a 58x58 crop (launches only solve_filter_1323; peak memory);
   ``bcd -w 10 -b 17 -s 2`` on that crop (no solve launch); that crop
   against the port's CPU pipeline.
15. The -w 11 path (d = 1587, the same kernel with 3,153 of the 3,176 rows
   in the global slot and thirteen pivot passes a round, lanes 0-4 of a
   group forming the angles of two passes, solve_filter_1587) at b = 20,
   checked as phase 14 checks the -w 10 path: synthetic stacks against
   the float64 twin at the engine's sweeps and the fp32 model two sweeps
   past them; the real one-tile r = 11, b = 20 batch, its first and last
   main-path rows timed once in place, the last past element 2^31 of
   the stack; ``bcd -w 11 -b 20 -s 2`` on a 62x62 crop
   (launches only solve_filter_1587; peak memory); ``bcd -w 11 -b 19 -s
   2`` on that crop (no solve launch); (c)'s output against the same
   pipeline on the card with the float64 twin in the kernel's place (the
   port's CPU pipeline took 173.1 s there and ended after phase 15 needed
   it).
16. The -w 12 path (d = 1875, the same kernel with 3,735 of the 3,752 rows
   in the global slot and fifteen pivot passes a round, lanes 0-6 of a
   group forming the angles of two passes, solve_filter_1875) at b = 22,
   checked as phase 15 checks the -w 11 path: synthetic stacks against
   the float64 twin at the engine's sweeps and the fp32 model two sweeps
   past them; the real one-tile r = 12, b = 22 batch, its first and last
   main-path rows timed once in place, the last past element 2^31 of
   the stack, held bit for bit to a compact call on them; ``bcd -w 12 -b
   22 -s 2`` on a 68x68 crop, untraced, its solve calls timed by CUDA
   events (launches only solve_filter_1875; peak memory), with the kernel
   calls of (a) and (b) whose time is not read beside it; ``bcd -w 12 -b
   21 -s 2`` on that crop (no solve launch);
   (c)'s output against the same pipeline on the card with the float64
   twin in the kernel's place (the port's CPU pipeline took 347-429 s
   there, and ended after the card's phases).
17. The -w 13 path (d = 2187, the runtime-d kernel solve_filter_big of
   csrc/solve_filter_big.cu, which runs every patch radius from 13 on;
   4,363 of its 4,376 rows in the global slot, eighteen pivot passes a
   round; a tile's centers solved in bands of 16 rows) at b = 23: (a) the
   kernel forced to d = 147 and 363 through its test-only entry, bit for
   bit the compiled instances and within the fp32 model; (b) 2 synthetic
   pixels at d = 2187 (pivots of passes 9 to 18 non-zero) at the engine's
   sweeps against the float64 twin and two past them against the fp32
   model on 1, its kernel calls beside (c); (c) ``bcd -w 13 -b 23 -s 2`` on a
   74x74 crop, untraced, its solve calls timed by CUDA events (launches
   only solve_filter_big; the centers that reach the solve, peak memory,
   tiles and bands); (d) ``bcd -w 13 -b 22 -s 2`` on that crop (no
   solve launch); (e) (c)'s output against the same pipeline on the card
   with the float64 twin in the kernel's place.
18. The lane solve_matrices on the runtime-d kernel (every d but 27 and
   75, csrc/solve_filter_big.cu fed by the moments, launch counter
   solve_matrices_big) and the TPU-compiler probes' microbenchmarks
   (csrc/probes.cu, ops/probes.py): (a) the lane form at d = 147, 363 and
   675 on 4 synthetic pixels each whose similar sets outnumber d + 1,
   against the float64 twin at the engine's sweeps, its filter against
   solve_filter_pm_big's field on the same stack, and against the fp32
   model of its schedule at the sweeps phases 7, 9 and 11 hold
   solve_filter to, and timed at d = 147 on 2,048 centers beside its
   bound and twin; (b) every probe variant (transpose A to D, mosaic
   aligned and unaligned, banded dot batched and loop) at its script's
   shapes against its plain version (B, C and D bit for bit, the others
   within fp32 rounding) and the float64 reference (transpose A's
   exactness both ways), timed beside its bound, its plain version and the
   one PyTorch call that computes its function, where there is one;
   transpose A and D at a ragged P, the batched banded dot at two ragged
   shapes.
19. scripts/bisect_kernel.py's staged d = 27 solve (csrc/bisect.cu,
   ops/bisect.py; launch counters bisect_m2 to bisect_chol): each of its
   five stages driven once on the script's inputs (128 pixels of 169
   candidates), then bit for bit its plain version on the card and within
   1e-6 of the largest magnitude of float64 at m2 and bd, 2e-4 from the
   Jacobi on, timed beside its bound and its plain version, m2 also beside
   the einsum of row 0 and the einsum of the whole M2; then every stage at
   P = 77, 8 and 1, bit for bit.

Phases 18 and 19 time each kernel, plain version and library call two
ways, launched from Python and replayed from one CUDA graph
(``ops/probe_library``'s ``cuda_ms`` and ``graph_ms``); the kernels line
takes the graph's.

The crops' CPU references (phases 5, 7 and 8 to 14's (e)), the port's
CPU pipeline on each crop, are computed one after another from phase 5's
start in a process of their own (spawned; it never touches the card),
beside the card's work, on tiles as small as the crop allows.
From phase 8 to 16 the frame's main-path fraction is read on an eighth of
its tiles.
Phases 10 to 16 time the first and last PART_ROWS (4) main rows of
their batch in place and hold them bit for bit to one compact call on
the same rows and to the float64 twin. From phase 10 the kernel calls of
(a) and (b) whose time is not read run on side streams beside (c)'s CLI
run, and their fp32 models after (e); in phases 14 and 15 (b)'s timed
in-place call too, timed by CUDA events on its own stream. Where (c)'s
crop is (e)'s (phases 10 to 14), (e) holds (c)'s output, on the inputs
and parameters of the CPU pipeline's run, to that pipeline (else the
card runs the crop twice, bitwise repeatable).

Then one JSON line of kernel results, the card line, and the final line
``{"ok": true, "device": {...}}``.

Inputs are generated from fixed seeds; nothing is downloaded. No JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "chip_smoke")
GOLDEN = os.path.join(HERE, "tests", "golden")

# K2 against the plain fp32 model of its own schedule on synthetic moments
# (the same arithmetic; about 1e-7 on an H100)
K2_MODEL_RMS = 1e-5
# ... and on a tile batch's real moments, where rank-deficient similar sets
# amplify the rounding: relative rms of the filtered self-candidate, about
# 3x the largest reading on an H100 (6.3e-5, 1088x1920)
K2_MODEL_BATCH_REL_RMS = 2e-4
# K2 (4 sweeps) against its float64 twin, through K4 on every covered pixel
# of a tile batch (relative rms of the tile estimates): K2's rms bound in
# the tests, about 4x the largest reading on an H100 (5.2e-5, 1088x1920)
K2_CANDIDATE_REL_RMS = 2e-4
# the whole pipeline with K2 against it with the twin: the goldens' rmse bound
E2E_K2_RMSE = 1e-4
# solve_filter's Jacobi sweeps on the -w 2 path (core/monoscale.py)
SOLVE_SWEEPS = 6
# synthetic solves against their float64 twins: JAX's own kernel-vs-
# reference bound (tests/test_solve_filter_pallas.py:34)
SYNTH_RMS = 2e-4
# phase 9's synthetic readings with no limit (the model at the engine's
# sweeps, and against itself with the candidates reversed at both counts,
# which show why the kernel is held to its model two sweeps past the
# engine's) take its first SYNTH_DIAG_PIXELS pixels; phases 10 and 11
# read them too until phase 12 needed the run's time (their readings:
# the R6_ and R7_ notes below)
SYNTH_DIAG_PIXELS = 8
# solve_filter and the lane solve_matrices against the plain fp32 model of
# their schedule (ops/solve_filter.solve_schedule_core): synthetic stacks
# (about 2e-6 at d = 75 on an H100), and the filtered field of the real
# r = 2 batch, relative rms, about 3x the reading on an H100 (6.9e-6)
SOLVE_MODEL_RMS = 1e-5
SOLVE_MODEL_BATCH_REL_RMS = 2e-5
# centers of the real r = 2 batch the fp32 model runs on
MODEL_CENTERS = 4096
# real r = 2 batch: the filtered field against the float64 twin's, relative
# rms, the bound K2's filtered self-candidate is held to
BATCH_REL_RMS = 1e-3
# the -w 2 pipeline on the card against the port's CPU pipeline: the
# goldens' bound, on the scene's top-left R2_CPU_CROP square
R2_CPU_RMSE = 1e-4
R2_CPU_CROP = 64
# the kernels each path launches (ops/_build.LAUNCHES keys)
R1_KERNELS = ("masks_moments", "solve_matrices_pm", "apply_scatter")
R2_KERNELS = ("solve_filter",)
R3_KERNELS = ("solve_filter_smem",)
# phase 7, d = 147 (csrc/solve_filter_smem.cu): against the plain fp32 model
# of its schedule on synthetic stacks (first readings on an H100 2.3e-6
# and 2.4e-6, so about 4x), and the filtered field of a real r = 3 batch,
# relative rms (first reading 5.9e-7, so about 8x)
SMEM_MODEL_RMS = 1e-5
SMEM_MODEL_BATCH_REL_RMS = 5e-6
# centers of the real r = 3 batch the fp32 model runs on, and the float64
# twin (its eigh at d = 147 is the costly part): two a block of the
# kernel's persistent grid on an H100's 132 SMs
R3_MODEL_CENTERS = 2048
R3_TWIN_CENTERS = 264
# the -w 3 run's finest-scale main-path fraction must exceed this (first
# reading on an H100 0.9171)
R3_MAIN_FLOOR = 0.8
# the traced -w 3 CLI run: the scene's top-left 256x480 (the whole 1088x1920
# frame took 87.7 s of phase 7's 152.7 s on an H100, a 544x960 crop 23.5 s;
# cut for phase 10's and then phase 11's time)
R3_CROP = (256, 480)
# (d): a crop on the card against the port's CPU pipeline; one 32x32 tile,
# where 252 centers reach the solve (48x48, four tiles, until phase 12
# needed the run's time)
R3_CPU_CROP = 32
# phase 8, d = 243 (csrc/solve_filter_smem.cu with 261 of the 488 rows of
# W and Q in a global slot): held to phase 7's limits (the same schedule,
# model and twin), on the same counts of centers
R4_KERNELS = ("solve_filter_243",)
# every solve kernel; a run that takes no main path launches none
SOLVE_KERNELS = ("solve_matrices_pm", "solve_filter", "solve_matrices",
                 "solve_filter_smem", "solve_filter_243", "solve_filter_363",
                 "solve_filter_507", "solve_filter_675", "solve_filter_867",
                 "solve_filter_1083", "solve_filter_1323",
                 "solve_filter_1587", "solve_filter_1875",
                 "solve_filter_big")
# the smallest search radius whose window reaches the main path at r = 4:
# 289 offsets, where n >= d + 1 = 244 similar candidates are needed (b = 6
# offers 169, b = 7 225)
R4_SEARCH = 8
# the r = 4, b = 8 finest-scale main-path fraction must exceed this (first
# reading on an H100 0.9018)
R4_MAIN_FLOOR = 0.72
# the cut -w 4 -b 8 frame: the scene's top-left crop, sides a multiple of
# 32; 256x512 took 56 s of phase 8's 165 s on an H100, cut to a quarter
# so that phases 1 to 10 stay well inside the run's time limit, and
# 128x256 (11.1 s) to a quarter again for phase 15's; the whole 1088x1920
# frame takes about 14 minutes
R4_CROP = (64, 128)
# (e): a crop on the card against the port's CPU pipeline
R4_CPU_CROP = 32
# the centers of (b)'s batch the fp32 model runs on: two a block of the
# kernel's persistent grid (phase 7's 2,048 until the whole run took 1125 s
# of its 1200 on an H100, the model on them 15.9 s). (a)'s synthetic rows
# stay 1,024: on their first 264 the kernel read 1.096e-05 from its model
# at 8 sweeps, past SMEM_MODEL_RMS (9.304e-06 on all 1,024; H100)
R4_MODEL_CENTERS = 264
# phase 9, d = 363 (csrc/solve_filter_smem.cu with 580 of the 728 rows of
# W and Q in a global slot)
R5_KERNELS = ("solve_filter_363",)
# the smallest search radius whose window reaches the main path at r = 5:
# 441 offsets, where n >= d + 1 = 364 similar candidates are needed (b = 9
# offers 361)
R5_SEARCH = 10
# synthetic rows (n of 277 to 348 similar candidates, below d + 1: every
# pixel rank-deficient): at the engine's 8 sweeps the schedule sits at its
# convergence edge there, where two fp32 summation orders part by about as
# much as each sits from the exact solve (the model 1.5e-5 from the twin,
# the kernel 2.2e-5 from the model on an H100, past the 2e-5 first
# predicted: PERF.md). So the kernel is held to its model at
# R5_MODEL_SWEEPS, where the schedule has converged (the model 6e-7 from the
# twin), within phase 7's SMEM_MODEL_RMS, and at 8 sweeps to the float64
# twin within SYNTH_RMS; on R5_SYNTH_PIXELS pixels, one a block (264, two
# a block, until phase 12 needed the run's time)
R5_MODEL_SWEEPS = 10
R5_SYNTH_PIXELS = 132
# the real r = 5 batch's main-path centers (n >= 364) at 8 sweeps: field vs
# the fp32 model, relative rms; the synthetic 8-sweep distance (2.2e-5)
# over the smallest synthetic-to-batch ratio of phases 7 and 8 (4) gives
# about 5.5e-6, and the limit leaves about 4x over that
R5_MODEL_BATCH_REL_RMS = 2e-5
# centers of the real r = 5 batch the model runs on, and the first main-
# path rows of the batch that the timed in-place call solves and holds bit
# for bit to the compact call, with the last R3_TWIN_CENTERS, past element
# 2^31 of the stack. The whole 16-tile batch took 57979.203 ms on an H100
# (PERF.md); since phase 12 it is timed on those 792 rows, a part, as
# phases 10 to 12 time theirs, for the run's time limit; the model on 264
# of them (528 until then)
R5_MODEL_CENTERS = 264
R5_BITWISE_CENTERS = 528
# the r = 5, b = 10 finest-scale main-path fraction must exceed this (first
# reading on an H100 0.8875)
R5_MAIN_FLOOR = 0.7
# the cut -w 5 -b 10 frame: the scene's top-left crop, sides a multiple of
# 32; 128x256 took 102 s of phase 9's 252 s on an H100, cut to a quarter
# for phase 10's time, and 64x128 (16.1 s) to a half for phase 15's; the
# whole 1088x1920 frame takes over two hours
R5_CROP = (64, 64)
# (e): a crop on the card against the port's CPU pipeline
R5_CPU_CROP = 32
# phase 10, d = 507 (csrc/solve_filter_smem.cu with 913 of the 1,016 rows
# of W and Q in a global slot), at the engine's 9 sweeps
R6_KERNELS = ("solve_filter_507",)
# the smallest search radius whose window reaches the main path at r = 6:
# 529 offsets, where n >= d + 1 = 508 similar candidates are needed (b = 10
# offers 441)
R6_SEARCH = 11
# synthetic rows (n of 358 to 390 similar candidates, below d + 1: every
# pixel rank-deficient), as phase 9's: at the engine's 9 sweeps the fp32
# model sits about 5e-6 from itself with the candidates reversed, so the
# kernel can sit about as far from its model there; from 10 sweeps on the
# schedule has converged, and the model's distance from itself reversed
# falls under 1e-6 (phase 10 (a) printed both until phase 12: 4.3e-6 and
# 8.0e-7 on an H100). So the kernel is held to its model at
# R6_MODEL_SWEEPS, two past the engine's as at d = 363, within phase 7's
# SMEM_MODEL_RMS, more than 10x that converged distance, and at 9 sweeps
# to the float64 twin within SYNTH_RMS; on R6_SYNTH_PIXELS pixels (64
# until phase 12 needed the run's time)
R6_MODEL_SWEEPS = 11
R6_SYNTH_PIXELS = 32
# the real r = 6 batch's main-path centers (n >= 508) at 9 sweeps: field vs
# the fp32 model, relative rms. Phase 9's rule, the synthetic distance at
# the engine's sweeps over 4, gives about 1.3e-6 here (about 5e-6 / 4; at
# d = 363 it gave 5.5e-6 from 2.2e-5): d = 507 at 9 sweeps sits nearer
# convergence than d = 363 at 8, so phase 9's limit is kept, 15x over
R6_MODEL_BATCH_REL_RMS = 2e-5
# The whole 8-tile r = 6 batch took 98.4 s on an H100, most of phase 10
# (PERF.md): it is timed on a part (PART_ROWS), its first and last 264 rows
# until phase 13 needed the run's time, 132 until phase 15 did. Its last
# rows lie past element 2^31 of the (8192, 529, 507) stack. The model runs
# on R6_MODEL_CENTERS of them
R6_MODEL_CENTERS = 132
# the 8-tile batch's main-path fraction (8,192 of 8,192 centers on an H100)
R6_BATCH_FLOOR = 0.8
# the r = 6, b = 11 finest-scale main-path fraction must exceed this (first
# reading on an H100 0.8192)
R6_MAIN_FLOOR = 0.65
# the cut -w 6 -b 11 frame: the scene's top-left crop, sides a multiple of
# 32; at -s 3 its coarsest scale (16x16) still has centers at r = 6, so
# every pixel of the output has an estimate (a 48x48 crop's 12x12 has none,
# and its output there is 0). 64x128 took 34.4 s on an H100, cut to 64x64
# (the finest scale's 4 tiles in one batch) for phase 11's time, and to
# (e)'s 40x40 (its 4 tiles in one batch too) at two scales for phase 15's
# (64x64 11.1 s): at three its 10x10 coarsest scale holds no 13x13 patch
R6_CROP = (40, 40)
R6_SCALES = 2
# (e): a crop on the card against the port's CPU pipeline; in a 32x32 crop
# the patch centers span 20x20, fewer than the 508 candidates of the main
# path at r = 6, b = 11, so none takes it; in a 40x40 crop 36 do (48x48,
# 196 of them, until phase 12: the CPU pipeline's eigh on each made it the
# slower)
R6_CPU_CROP = 40
# phase 11, d = 675 (csrc/solve_filter_smem.cu with 1,280 of the 1,352 rows
# of W and Q in a global slot), at the engine's 9 sweeps
R7_KERNELS = ("solve_filter_675",)
# the smallest search radius whose window reaches the main path at r = 7:
# 729 offsets, where n >= d + 1 = 676 similar candidates are needed (b = 12
# offers 625)
R7_SEARCH = 13
# synthetic rows (n of 494 to 531, every pixel rank-deficient), as phase
# 10's: at 9 sweeps the model sits 6.8e-6 from itself with the candidates
# reversed and the kernel 6.1e-6 from the model; at 11, 9.2e-7 and 8.8e-7
# (phase 11 (a) printed them until phase 12; H100). So the kernel is held
# to its model at R7_MODEL_SWEEPS, two past the engine's, within
# SMEM_MODEL_RMS, and at 9 to the float64 twin within SYNTH_RMS, on
# R7_SYNTH_PIXELS pixels (64 until phase 12 needed the run's time)
R7_MODEL_SWEEPS = 11
R7_SYNTH_PIXELS = 32
# the real r = 7 batch at 9 sweeps against the fp32 model: phase 10's limit
# (its reading 1.1e-6, 18x under it; d = 675 at 9 sweeps sits about as near
# convergence as d = 507 at 9 on the synthetic rows)
R7_MODEL_BATCH_REL_RMS = 2e-5
# The 4-tile r = 7 batch (about 4,000 main-path centers at about 31 ms a
# center on an H100, about two minutes) is timed on a part of it in place
# (PART_ROWS; 528 rows, the model on 132 centers, until phase 13 needed the
# run's time, 264 until phase 15 did)
R7_MODEL_CENTERS = 32
# the r = 7, b = 13 finest-scale main-path fraction of the frame and of the
# 4-tile batch must exceed these (stated before the first reading: at r = 6
# the frame read 0.8192 and its batch 1.0)
R7_MAIN_FLOOR = 0.6
R7_BATCH_FLOOR = 0.8
# (e): in a 40x40 crop 4 centers reach the solve (their windows lose one
# row and one column); in a 32x32 crop none
R7_CPU_CROP = 40
# the cut -w 7 -b 13 frame: (e)'s crop, one 4-tile batch at the finest
# scale (the batch's peak memory), at two scales (at three its 10x10
# coarsest scale holds no 15x15 patch). The top-left 64x64, where all 676
# centers whose window keeps 676 offsets take the main path (22.1 s), until
# phase 15 needed the run's time
R7_CROP = (R7_CPU_CROP, R7_CPU_CROP)
R7_SCALES = 2
# phase 12, d = 867 (csrc/solve_filter_smem.cu with 1,683 of the 1,736 rows
# of W and Q in a global slot), at the engine's sweeps
R8_KERNELS = ("solve_filter_867",)
# the smallest search radius whose window reaches the main path at r = 8:
# 961 offsets, where n >= d + 1 = 868 similar candidates are needed (b = 14
# offers 841)
R8_SEARCH = 15
# synthetic rows (every pixel rank-deficient), held as phase 11's: at 9
# sweeps the model sat 1.0e-5 from itself with the candidates reversed and
# the kernel 1.0e-5 from the model; at 11, 1.0e-6 and 9.8e-7 (H100, the
# first run of phase 12, 64 pixels). So the kernel is held to its model
# two sweeps past the engine's within SMEM_MODEL_RMS, and at the engine's
# to the float64 twin within SYNTH_RMS, on R8_SYNTH_PIXELS pixels (64
# until phase 13 needed the run's time, 32 until phase 14 did)
R8_MODEL_SWEEPS = 11
R8_SYNTH_PIXELS = 16
# the real r = 8 batch against the fp32 model: phase 11's limit
R8_MODEL_BATCH_REL_RMS = 2e-5
# The 2-tile r = 8 batch (about 2,000 main-path centers at about 65 ms a
# center, about two minutes) is timed on a part of it in place (PART_ROWS;
# 528 rows, the model on 132 centers, until phase 13 needed the run's time,
# 264 until phase 15 did)
R8_MODEL_CENTERS = 32
# the r = 8, b = 15 finest-scale main-path fraction of the frame and of the
# 2-tile batch must exceed these (stated before the first reading: at r = 7
# the frame read 0.8064 and its batch 1.0)
R8_MAIN_FLOOR = 0.6
R8_BATCH_FLOOR = 0.8
# (e): in a 46x46 crop 12 centers reach the solve, all in the finest
# scale's first batch (their windows keep 900 offsets); in a 44x44 none
R8_CPU_CROP = 46
# the cut -w 8 -b 15 frame: (e)'s crop (the finest scale's 4 tiles in two
# 2-tile batches, one launch; 64x64, two launches, until phase 13 needed
# the run's time), at two scales: at three a 64x64 crop's 16x16 coarsest
# scale holds no 17x17 patch, so that scale's estimate is 0 everywhere and
# the merge loses the image's low frequencies
R8_CROP = (R8_CPU_CROP, R8_CPU_CROP)
R8_SCALES = 2
# phase 13, d = 1083 (csrc/solve_filter_smem.cu with 2,128 of the 2,168
# rows of W and Q in a global slot and nine pivot passes a round, a lane
# forming two passes' angles), at the engine's 10 sweeps
R9_KERNELS = ("solve_filter_1083",)
# the smallest search radius whose window reaches the main path at r = 9:
# 1,089 offsets, where n >= d + 1 = 1,084 similar candidates are needed
# (b = 15 offers 961)
R9_SEARCH = 16
# synthetic rows (every pixel rank-deficient), held as phase 12's: the
# kernel against its model two sweeps past the engine's within
# SMEM_MODEL_RMS, and at the engine's to the float64 twin within
# SYNTH_RMS, on R9_SYNTH_PIXELS pixels (32 until phase 14 needed the run's
# time, 16 until phase 15 did).
# The rows' pivots reach the ninth pass's pairs (512 to 541), which only a
# lane's second angle step rotates
R9_MODEL_SWEEPS = 12
# (8 until the whole run took 1125 s of its 1200 on an H100)
R9_SYNTH_PIXELS = 2
# the real r = 9 batch against the fp32 model: phase 12's limit
R9_MODEL_BATCH_REL_RMS = 2e-5
# the r = 9 batch is timed on a part in place (PART_ROWS; one wave of 132
# rows, 18.3 s at 10 sweeps on an H100, until phase 15 needed the run's
# time), the last rows past element 2^31 of the (2048, 1089, 1083) stack.
# The fp32 model's time was set by its rounds, not its centers, where its
# launches bound it (on 8 centers it took as long as on 16 on an H100),
# until it was replayed as a CUDA graph (LATE_MODEL_PIXELS)
# the r = 9, b = 16 finest-scale main-path fraction of the frame and of the
# 2-tile batch must exceed these (stated before the first reading: at r = 8
# the frame read 0.8002 and its batch 1.0; at r = 9 the first reading on an
# H100 0.7224 and 1.0)
R9_MAIN_FLOOR = 0.55
R9_BATCH_FLOOR = 0.8
# (e): in a 52x52 crop 4 centers reach the solve (their windows keep all
# 1,089 offsets), all in the finest scale's first batch; in a 50x50 none
# (the top-left crops of the scene after the prefilter)
R9_CPU_CROP = 52
# (c): bcd -w 9 -b 16 -s 2 on (e)'s crop: its 26x26 coarse scale still
# holds a 19x19 patch
R9_CROP = (R9_CPU_CROP, R9_CPU_CROP)
R9_SCALES = 2
# a round's pivot pairs a pass of csrc/solve_filter_smem.cu (Smem::PPASS)
PIVOT_PAIRS_A_PASS = 64
# phase 14, d = 1323 (csrc/solve_filter_smem.cu with 2,618 of the 2,648
# rows of W and Q in a global slot and eleven pivot passes a round, lanes
# 0-2 of a group forming two passes' angles), at the engine's sweeps
R10_KERNELS = ("solve_filter_1323",)
# the smallest search radius whose window reaches the main path at r = 10:
# 1,369 offsets, where n >= d + 1 = 1,324 similar candidates are needed
# (b = 17 offers 1,225)
R10_SEARCH = 18
# synthetic rows (every pixel rank-deficient), held as phase 13's: the
# kernel against its model two sweeps past the engine's within
# SMEM_MODEL_RMS, and at the engine's to the float64 twin within
# SYNTH_RMS, on R10_SYNTH_PIXELS pixels (32 in phase 14's first run: (a)
# took 79.7 s on an H100, 59.6 s on 16; 16 until phase 15).
# The rows' pivots reach the ninth to eleventh passes' pairs (512 to 660),
# which only a lane's second angle step rotates
R10_MODEL_SWEEPS = 12
# (8 until the whole run took 1125 s of its 1200 on an H100)
R10_SYNTH_PIXELS = 2
# the real r = 10 batch against the fp32 model: phase 13's limit
R10_MODEL_BATCH_REL_RMS = 2e-5
# the one-tile r = 10 batch is timed on a part in place (PART_ROWS; one
# wave of 132 rows, 33.8 s on an H100, until phase 15 needed the run's
# time). The (1024, 1369, 1323) stack holds 1,854,655,488 elements, under
# 2^31: phases 13, 15 and 16 hold their rows past 2^31
# the r = 10, b = 18 finest-scale main-path fraction of the frame and of the
# one-tile batch must exceed these (stated before the first reading: at
# r = 9 the frame read 0.7224 and its batch 1.0)
R10_MAIN_FLOOR = 0.5
R10_BATCH_FLOOR = 0.8
# (e): in a 58x58 crop 12 centers reach the solve (in 57x57 5, in 56x56
# none; the top-left crops of the scene after the prefilter)
R10_CPU_CROP = 58
# (c): bcd -w 10 -b 18 -s 2 on (e)'s crop: its 29x29 coarse scale still
# holds a 21x21 patch
R10_CROP = (R10_CPU_CROP, R10_CPU_CROP)
R10_SCALES = 2
# phase 15, d = 1587 (csrc/solve_filter_smem.cu with 3,153 of the 3,176
# rows of W and Q in a global slot and thirteen pivot passes a round, lanes
# 0-4 of a group forming two passes' angles), at the engine's sweeps
R11_KERNELS = ("solve_filter_1587",)
# the smallest search radius whose window reaches the main path at r = 11:
# 1,681 offsets, where n >= d + 1 = 1,588 similar candidates are needed
# (b = 19 offers 1,521)
R11_SEARCH = 20
# synthetic rows (every pixel rank-deficient), held as phase 14's: the
# kernel against its model two sweeps past the engine's within
# SMEM_MODEL_RMS, and at the engine's to the float64 twin within
# SYNTH_RMS, on R11_SYNTH_PIXELS pixels (16 in phase 15's first run: its
# model took 31.8 s and slowed the kernel's calls beside it to 67.3 s on
# an H100). The rows' pivots reach the ninth
# to thirteenth passes' pairs (512 to 792), which only a lane's second
# angle step rotates
R11_MODEL_SWEEPS = 12
# (8 until the whole run took 1125 s of its 1200 on an H100)
R11_SYNTH_PIXELS = 2
# the real r = 11 batch against the fp32 model: phase 14's limit
R11_MODEL_BATCH_REL_RMS = 2e-5
# the one-tile r = 11 batch is timed on a part in place (PART_ROWS; one
# wave of 132 rows, 58449.918 ms on an H100, until phase 16 needed the
# run's time), its last rows past element 2^31 of the (1024, 1681, 1587)
# stack
# the r = 11, b = 20 finest-scale main-path fraction of the frame's part and
# of the one-tile batch must exceed these (stated before the first reading:
# at r = 10 the frame read 0.7165 and its batch 1.0)
R11_MAIN_FLOOR = 0.45
R11_BATCH_FLOOR = 0.8
# (e): in a 62x62 crop 4 centers reach the solve (their windows keep 1,600
# offsets of the 40-wide patch-valid region); a 61x61 crop's 39-wide one
# keeps at most 1,521, under 1,588 (the top-left crops of the scene after
# the prefilter; 63x63 holds 13, 64x64 24). Its reference is the same
# pipeline on the card with the float64 twin in the kernel's place
# (wide_phases' "reference"), as phase 16's: the port's CPU pipeline on it
# took 173.1 s in the reference process and ended 44.1 s after phase 15
# needed it, once the phases before it took less time (an H100 run)
R11_CPU_CROP = 62
# (c): bcd -w 11 -b 20 -s 2 on (e)'s crop: its 31x31 coarse scale still
# holds a 23x23 patch
R11_CROP = (R11_CPU_CROP, R11_CPU_CROP)
R11_SCALES = 2
# phase 16, d = 1875 (csrc/solve_filter_smem.cu with 3,735 of the 3,752
# rows of W and Q in a global slot and fifteen pivot passes a round, lanes
# 0-6 of a group forming two passes' angles), at the engine's sweeps
R12_KERNELS = ("solve_filter_1875",)
# the smallest search radius whose window reaches the main path at r = 12:
# 2,025 offsets, where n >= d + 1 = 1,876 similar candidates are needed
# (b = 21 offers 1,849)
R12_SEARCH = 22
# synthetic rows (every pixel rank-deficient), held as phase 15's: the
# kernel against its model two sweeps past the engine's within
# SMEM_MODEL_RMS, and at the engine's to the float64 twin within
# SYNTH_RMS, on R12_SYNTH_PIXELS pixels. The rows' pivots reach the ninth
# to fifteenth passes' pairs (512 to 936), which only a lane's second
# angle step rotates
R12_MODEL_SWEEPS = 12
# (8 until the whole run took 1125 s of its 1200 on an H100)
R12_SYNTH_PIXELS = 2
# the real r = 12 batch against the fp32 model: phase 15's limit
R12_MODEL_BATCH_REL_RMS = 2e-5
# the one-tile r = 12 batch is timed on a part in place (PART_ROWS; one
# wave of 132 rows, 96937.016 ms on an H100, until phase 17 needed the
# run's time), the last rows past element 2^31 of the (1024, 2025, 1875)
# stack
# the r = 12, b = 22 finest-scale main-path fraction of the frame's part and
# of the one-tile batch must exceed these (stated before the first reading:
# at r = 11 the frame's part read 0.6861 and its batch 1.0)
R12_MAIN_FLOOR = 0.4
R12_BATCH_FLOOR = 0.8
# (e): the smallest top-left crop of the scene (after the prefilter) in
# which a center reaches the solve at r = 12, b = 22; its reference is the
# same pipeline on the card with the float64 twin in the kernel's place
# (wide_phases' "reference"): the port's CPU pipeline took 347-429 s in the
# reference process (33.4 GiB) and ended 96.9 s after phase 16 needed it
# (an H100 run)
R12_CPU_CROP = 68
# (c): bcd -w 12 -b 22 -s 2 on (e)'s crop: its 34x34 coarse scale still
# holds a 25x25 patch
R12_CROP = (R12_CPU_CROP, R12_CPU_CROP)
R12_SCALES = 2
# phase 17, d = 2187 and up (csrc/solve_filter_big.cu, d a runtime
# argument: 4,363 of the 4,376 rows of W and Q in a global slot, eighteen
# pivot passes a round, a lane forming the angles of passes k, k + 8 and
# k + 16), at the engine's sweeps
R13_KERNELS = ("solve_filter_big",)
# the smallest search radius whose window reaches the main path at r = 13:
# 2,209 offsets, where n >= d + 1 = 2,188 similar candidates are needed
# (b = 22 offers 2,025)
R13_SEARCH = 23
# (a): the runtime-d kernel forced to compiled instances' d through its
# test-only entry (solve_filter_pm_big), on R13_SMALL_PIXELS synthetic
# pixels: (O, d, the model's sweeps), the model two sweeps past the
# engine's at d = 363, where phase 9's rank-deficient rows have converged
R13_SMALL = ((169, 147, 8), (441, 363, 10))
R13_SMALL_PIXELS = 8
# (b): d = 2187 on R13_SYNTH_PIXELS synthetic pixels (pivots of passes 9 to
# 18 non-zero), at the engine's sweeps against the float64 twin, and two
# sweeps past them (12) against the fp32 model on LATE_MODEL_PIXELS, as
# phases 13 to 16 hold theirs. Not at 2 sweeps: there the schedule is far from
# converged, and the model against itself with the candidates reversed (two
# fp32 summation orders of one schedule) parts by 9.5e-3 to 1.7e-2 rms at
# d = 147 to 1083 (full masks; rank-deficient rows give NaN, their
# negative directions not yet clamped), so no limit under that could hold
# the kernel to its model there
# (4 until the whole run took 1125 s of its 1200 on an H100)
R13_SYNTH_PIXELS = 2
# (c): the smallest top-left crop of the scene (after the prefilter) in
# which a few centers reach the solve at r = 13, b = 23: 74x74, 4 centers
# (73x73 holds 1, 72x72 none; an H100 run), in the finest scale's
# tile 3 (of 9), in its first band of 16 rows
R13_CROP = (74, 74)
R13_SCALES = 2
# (d): -w 13 at b = 22 on that crop, where no center can reach the solve
# (2,025 offsets)
# (e): the crop against the same pipeline on the card with the float64
# twin in the kernel's place, within the CPU comparisons' R2_CPU_RMSE: the
# port's CPU pipeline at r = 13 would take about 550 s in the reference
# process (r = 12's took 347-419 s, 33.4 GiB), past the card's phases
# phases 10 to 17 hold the kernel to the fp32 model on the first
# LATE_MODEL_PIXELS of their synthetic pixels, and phases 13 to 17 on as
# many of their batch's timed rows (8 until phase 16 needed the run's time;
# the twin still on all): replayed as a CUDA graph the model's rounds are
# bound by their HBM traffic, which the pixels set. Phases 10 to 12 ran
# their synthetic model on all 16 to 32 pixels until the whole run took
# 1125 s of its 1200 on an H100. Not 1: on the first timed row alone the
# real batches at r = 6 to 10 read 8.300e-06, 1.243e-05, 1.728e-05,
# 1.749e-05 and 2.061e-05 from the model, the last past its 2e-5 (H100)
LATE_MODEL_PIXELS = 2
# phases 10 to 16 time the first and last PART_ROWS main rows of their
# batch in place and hold them bit for bit to one compact call on the same
# rows and to the float64 twin (a wave of 132, or two, until phase 15, 16
# or 17 needed the run's time; 16 until the whole run took 1125 s; their
# readings stay in PERF.md). At d = 1875 four rows took 37.6 s on an H100,
# 32 rows 50.3 s: the rows' HBM traffic sets a call's latency
PART_ROWS = 4
# phases 8 to 16 read the frame's finest-scale main-path fraction on every
# FRAME_PART-th 16-tile batch, an eighth of the frame's tiles spread over
# it (the whole frame took 3.5 s at r = 4 to 24.5 s at r = 10 on an H100;
# a quarter 1.4 s at r = 5 to 8.1 s at r = 11 in phase 15's first run, 0.9019
# and 0.7163 where the whole frame read 0.8875 and 0.7165)
FRAME_PART = 8
# the repaired batch rule, read cheaply: bcd -w 3 -b 33 on the scene's
# top-left 64x128 (8 tiles at the finest scale; 4 a batch, 16 before)
BATCH_RULE_CROP = (64, 128)
# centers of the real r = 2 batch on which solve_filter and the lane
# solve_matrices, on no engine path, are held to their float64 twins (whose
# call takes about 3 ms a center on the card), and the kernels line's
# times are read (solve_filter's twin on all 16,384 took 49.2 s on an
# H100 until phase 15 needed the run's time)
LANE_CENTERS = 2048
# solve_filter_pm's stack arguments, in order
PM_KEYS = ("cand", "mask", "noise", "n", "m")
# phase 6: samples a pixel of the ingest render
INGEST_SPP = 16
# the accumulator (float32) against the float64 stand-in at 16 spp: mean
# within rtol 1e-5 (float32 sums of 16 samples); cov within 1e-5 of
# |cov| + |mean_i mean_j| (it is E[x_i x_j] - mean_i mean_j, and the
# float32 error is that of the second moment, at most |cov| + |mean_i
# mean_j|); histo within 2e-4 (each sample moves its two bin weights by at
# most 18 |dv|, |dv| <= 2 ulp of v <= 2 between float32 and float64
# companding, about 9e-6 a sample, 1.4e-4 for 16)
ACC_MEAN_RTOL = 1e-5
ACC_COV_REL = 1e-5
ACC_HISTO_ATOL = 2e-4

# phase 18 (a): the lane solve_matrices on the runtime-d kernel at (O, d, the
# model's sweeps): stack_inputs' masks keep about 0.7 O candidates, more
# than d + 1 (289, 625 and 1,089 offsets are windows of b = 8, 12 and 16),
# so the main path's rank holds; the model at the sweeps phases 7, 9 and 11
# hold solve_filter to at that d (two past the engine's from d = 363). Not
# past d = 675: a call lasts a pixel's latency (about 68 s at d = 2187 on an
# NVIDIA H100 80GB HBM3 at 700 W), so d = 1875 and 2187 are gpu tests
LANE_BIG = ((289, 147, 8), (625, 363, 10), (1089, 675, 11))
LANE_PIXELS = 4
# the lane form's filter, mask (A2 c + b2), against solve_filter's field on
# the same stack: tests/test_torch_solve.py's limit at d = 27 and 75
LANE_CONSISTENT_RMS = 2e-4
# the TPU kernel each probe variant's microbenchmark stands for, by the
# second word of its name
# transpose A and D also at a P that their 128-pixel tile does not divide
PROBE_RAGGED_P = 2272
# the batched banded dot also at (Y, T, C) that its 64 x 128 tile does not
# divide: on 16-byte copies, and on 4-byte ones (C, or T, not a multiple of
# 4: B's rows, or S's, do not all start on 16 bytes)
BANDED_RAGGED = ((3, 32, 96), (2, 40, 90), (2, 30, 96))
# the staged solve also at P that no group of 8 pixels divides (77, 1) and
# at one group (8), each stage bit for bit its plain version
BISECT_RAGGED_P = (77, 8, 1)
PROBE_SCRIPTS = {"transpose": "scripts/probe_transpose.py:86",
                 "mosaic": "scripts/probe_mosaic.py:65",
                 "banded": "scripts/probe_banded_dot.py:52"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def timed_once(fn):
    """(fn(), ms) for one call timed with CUDA events, no warm-up: for the
    float64 twins, whose one call takes seconds."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def load_golden():
    from bcd_tpu_torch.io import image_io

    def load(name):
        return image_io.load_multi_channels_exr(os.path.join(GOLDEN, name))

    histo, nb = image_io.separate_nb_of_samples_from_histogram(
        load("in_hist.exr"))
    return (load("in_color.exr"), nb, histo, load("in_cov.exr"),
            load("out_mono_b6.exr"), load("out_multi2_b6.exr"))


def accumulate_statistics(samples, nb_of_bins=20, gamma=2.2, max_value=2.5):
    """Vectorized statistics of unweighted samples (H, W, S, 3): the
    semantics of tests/reference_impl.py::accumulate_samples (reference
    SamplesAccumulator.cpp:44-141) with the per-sample histogram splat as
    two bincounts. Returns float32 (color, nb, histo, cov)."""
    s = np.asarray(samples, np.float64)[..., :3]
    height, width, spp, _ = s.shape
    mean = s.mean(axis=2)
    r, g, b = s[..., 0], s[..., 1], s[..., 2]
    cov = np.stack([(r * r).sum(2), (g * g).sum(2), (b * b).sum(2),
                    (g * b).sum(2), (r * b).sum(2), (r * g).sum(2)],
                   axis=-1) / spp
    m0, m1, m2 = mean[..., 0], mean[..., 1], mean[..., 2]
    cov -= np.stack([m0 * m0, m1 * m1, m2 * m2, m1 * m2, m0 * m2, m0 * m1],
                    axis=-1)
    cov *= 1.0 / (1.0 - 1.0 / spp)  # bias 1 / (1 - w2sum / wsum^2)

    v = np.maximum(s, 0.0) ** (1.0 / gamma) / max_value
    v = np.minimum(v, 2.0)
    bin_float = v * (nb_of_bins - 2)
    floor_bin = bin_float.astype(np.int64)
    in_bounds = floor_bin < nb_of_bins - 2
    floor_bin = np.where(in_bounds, floor_bin, nb_of_bins - 2)
    ceil_w = np.where(in_bounds, bin_float - floor_bin, (v - 1.0) / 1.0)
    pix = np.arange(height * width).reshape(height, width, 1, 1)
    chan = np.arange(3).reshape(1, 1, 1, 3)
    idx = ((pix * 3 + chan) * nb_of_bins + floor_bin).ravel()
    size = height * width * 3 * nb_of_bins
    histo = (np.bincount(idx, weights=(1.0 - ceil_w).ravel(), minlength=size)
             + np.bincount(idx + 1, weights=ceil_w.ravel(), minlength=size))
    nb = np.full((height, width, 1), float(spp))
    return tuple(a.astype(np.float32) for a in (
        mean, nb, histo.reshape(height, width, 3 * nb_of_bins), cov))


def full_scene(height=1088, width=1920, spp=4, seed=0):
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_test_scene import render_clean, sample_noisy

    clean = render_clean(height, width)
    return clean, accumulate_statistics(sample_noisy(clean, spp, seed))


# ---------------------------------------------------------------------------
# engine pieces
# ---------------------------------------------------------------------------


def padded(cfg, color, nb, histo, cov, device):
    import torch
    import torch.nn.functional as F

    h = cfg.halo

    def pad(x, fill=0.0):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        return F.pad(x, (0, 0, h, h, h, h), value=fill)

    return pad(color), pad(nb, 1.0), pad(histo), pad(cov)


def k1_batches(cfg, color, nb, histo, cov, device):
    """K1's inputs [histo, nb, color, pixcov, valid] slabs, one list per
    tile batch of a whole image, as the engine builds them."""
    from bcd_tpu_torch.core.fused import validity_maps
    from bcd_tpu_torch.core.monoscale import tile_batches

    height, width = color.shape[:2]
    for _, (ly, lx), slabs in tile_batches(
            cfg, *padded(cfg, color, nb, histo, cov, device)):
        valid = validity_maps(cfg, ly, lx, ly, lx, height, width, height,
                              width)
        s_color, s_nb, s_histo, s_pixcov = slabs
        yield [s_histo, s_nb, s_color, s_pixcov, valid]


def tile_batch_inputs(cfg, color, nb, histo, cov, device, batch=0):
    """K1's inputs for tile batch number ``batch`` of a whole image."""
    it = k1_batches(cfg, color, nb, histo, cov, device)
    for _ in range(batch):
        next(it)
    return next(it)


def main_path_fraction(cfg, color, nb, histo, cov, params, device) -> float:
    """Main-path solves over managed (main + fallback) pixels: the sum of
    K2's gates over every tile of the image."""
    from bcd_tpu_torch.ops.fused import masks_moments
    from bcd_tpu_torch.ops.solve_filter import D, solve_matrices_pm

    t, h, b = cfg.tile, cfg.halo, cfg.search_radius
    main = fb = 0.0
    for inputs in k1_batches(cfg, color, nb, histo, cov, device):
        _, m2, misc = masks_moments(
            *inputs, params.histogram_distance_threshold, t=t, h=h, b=b)
        _, small = solve_matrices_pm(m2.reshape(-1, m2.shape[-1]),
                                     misc.reshape(-1, misc.shape[-1]),
                                     params.min_eigen_value, cfg.solve_sweeps)
        main += float(small[:, D].sum())
        fb += float(small[:, 2 * D + 1].sum())
    need(main + fb > 0, "no managed pixels")
    return main / (main + fb)


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def synthetic_moments(rng, P=256, n_off=49):
    """Random masked moments (the synthetic set of scripts/verify_tpu.py)."""
    import torch
    from bcd_tpu_torch.ops.fused import _tri_pack
    from bcd_tpu_torch.ops.solve_filter import D, MISC_CH

    C = rng.standard_normal((n_off, D, P))
    mask = rng.random((n_off, P)) < 0.7
    mask[n_off // 2] = True
    n = mask.sum(axis=0)
    mk = mask[:, None, :]
    m2 = np.einsum("okp,olp->pkl", mk * C, C).reshape(P, D * D)
    misc = np.zeros((P, MISC_CH))
    misc[:, :D] = (mk * C).sum(axis=0).T
    nov = np.zeros((P, 9, 6))
    nov[..., 0:3] = 0.05 + 0.1 * rng.random((P, 9, 3))
    nov[..., 3:6] = 0.01 * rng.standard_normal((P, 9, 3))
    misc[:, D : D + 54] = (nov * n[:, None, None]).reshape(P, 54)
    misc[:, D + 54] = n
    misc[:, D + 55] = 1.0
    return (torch.tensor(np.ascontiguousarray(m2[:, _tri_pack(D)]),
                         dtype=torch.float32),
            torch.tensor(misc, dtype=torch.float32))


def compare_kernels(label, inputs, params, cfg, reps):
    """K1, K2 and K4 against their twins on one tile batch. Returns a dict
    kernel -> (max_abs_err, ms, plain_ms, (bound_ms, bound_by))."""
    import torch
    from bcd_tpu_torch.ops import bounds
    from bcd_tpu_torch.ops import fused as tf
    from bcd_tpu_torch.ops import solve_filter as ts

    D = ts.D
    t, h, b = cfg.tile, cfg.halo, cfg.search_radius
    thr, eps = params.histogram_distance_threshold, params.min_eigen_value
    n_tiles = inputs[0].shape[0]
    res = {}

    # K1: masks may differ only at the threshold; moments where they agree
    k1 = lambda: tf.masks_moments(*inputs, thr, t=t, h=h, b=b)  # noqa: E731
    k1_plain = lambda: tf.masks_moments_plain(  # noqa: E731
        *inputs, thr, t=t, h=h, b=b)
    masks, m2, misc = k1()
    masks_p, m2_p, misc_p = k1_plain()
    diff = masks != masks_p
    dist = tf.distances_plain(inputs[0], inputs[1], t, h, b)
    near = (dist.reshape(diff.shape) - thr).abs() <= 1e-5 * thr
    need(bool((~diff | near).all()),
         f"{label} K1: a mask differs away from the threshold")
    same = ~diff.any(-1)
    err = 0.0
    for got, ref in ((m2, m2_p), (misc, misc_p)):
        g, r = got[same], ref[same]
        need(bool(((g - r).abs() <= 1e-5 + 2e-5 * r.abs()).all()),
             f"{label} K1: moments beyond rtol 2e-5")
        err = max(err, float((g - r).abs().max()))
    need(torch.equal(misc[same][:, D + 54 :], misc_p[same][:, D + 54 :]),
         f"{label} K1: n / center_valid not exact")
    n_sel = int(masks.sum())
    res["K1"] = (err, cuda_ms(k1, reps), cuda_ms(k1_plain, 1), bounds.k1(
        n_tiles, t, h, b, inputs[0].shape[-1], n_sel))
    print(f"[2] {label} K1 masks_moments ({n_tiles} tiles, {n_sel} selected "
          f"candidates): {int(diff.sum())} mask mismatches of {diff.numel()} "
          f"(all at the threshold), moments max abs err {err:.3e}, n exact; "
          f"kernel {res['K1'][1]:.3f} ms, twin {res['K1'][2]:.3f} ms, bound "
          f"{res['K1'][3][0]:.3f} ms ({res['K1'][3][1]})", flush=True)

    # K2 on the real moments (the engine's 4 sweeps) vs the float64 twin
    m2f, miscf = m2.reshape(-1, ts.DTRI), misc.reshape(-1, ts.MISC_CH)
    k2 = lambda: ts.solve_matrices_pm(  # noqa: E731
        m2f, miscf, eps, sweeps=cfg.solve_sweeps)
    k2_plain = lambda: ts.solve_matrices_pm_plain(  # noqa: E731
        m2f, miscf, eps)
    a2t, small = k2()
    a2t_p, small_p = k2_plain()
    need(torch.equal(small[:, D], small_p[:, D])
         and torch.equal(small[:, 2 * D + 1], small_p[:, 2 * D + 1]),
         f"{label} K2: gates not exact")
    need(bool(torch.isfinite(a2t).all() and torch.isfinite(small).all()),
         f"{label} K2: non-finite filter")
    # The filter acts on candidate patches, and only where the main-path
    # gate is on. Raw A2 entries are a poor probe: in directions where the
    # similar set has no spread (rank-deficient moments) the kernel's
    # Cholesky of M + eps I and the twin's exact eigenvalue floor differ
    # legitimately, and no candidate has a component there. So the error
    # is measured on a real filtered candidate, the center's own patch c:
    # A2 c + b2 (the mean patch is no probe: A2 m + b2 = m identically).
    main = small_p[:, D] > 0
    c = tf._patchify(inputs[2])[:, h - 1 : h - 1 + t, h - 1 : h - 1 + t]
    c = c.reshape(-1, D)[main]

    def filtered(a, s):
        return torch.einsum("pk,pkj->pj", c, a[main].reshape(-1, D, D)) \
            + s[main, :D]

    def rms(x):
        return float(torch.sqrt(torch.mean(x ** 2)))

    f_p = filtered(a2t_p, small_p)
    rel = rms(filtered(a2t, small) - f_p) / rms(f_p)
    err = float((filtered(a2t, small) - f_p).abs().max())
    k2_6 = ts.solve_matrices_pm(m2f, miscf, eps, sweeps=6)
    rel6 = rms(filtered(*k2_6) - f_p) / rms(f_p)
    res["K2"] = (err, cuda_ms(k2, reps), cuda_ms(k2_plain, 1),
                 bounds.k2(m2f.shape[0], cfg.solve_sweeps))
    a2t_m, small_m = ts.solve_matrices_pm_schedule(m2f, miscf, eps,
                                                   cfg.solve_sweeps)
    f_m = filtered(a2t_m, small_m)
    rel_m = rms(filtered(a2t, small) - f_m) / rms(f_m)
    print(f"[2] {label} K2 solve_matrices_pm ({m2f.shape[0]} pixels, "
          f"{int(main.sum())} on the main path, real K1 moments) vs float64 "
          f"twin: filtered self-candidate rel rms {rel:.3e} at "
          f"sweeps={cfg.solve_sweeps} ({rel6:.3e} at sweeps=6), max abs "
          f"err {err:.3e}; raw a2t rms {rms(a2t - a2t_p):.3e}; gates exact; "
          f"vs its fp32 schedule model rel rms {rel_m:.3e} (limit "
          f"{K2_MODEL_BATCH_REL_RMS:g}), gates exact; kernel "
          f"{res['K2'][1]:.3f} ms, twin {res['K2'][2]:.3f} ms, bound "
          f"{res['K2'][3][0]:.3f} ms ({res['K2'][3][1]})", flush=True)
    need(rel < 1e-3, f"{label} K2: filtered candidates beyond rel rms 1e-3")
    need(rel_m < K2_MODEL_BATCH_REL_RMS
         and torch.equal(small[:, D], small_m[:, D])
         and torch.equal(small[:, 2 * D + 1], small_m[:, 2 * D + 1]),
         f"{label} K2 against its schedule model on real moments")

    # K2 on every candidate its filters touch: K4's tile estimates (sum /
    # count, every center and apron pixel some mask reaches) from the
    # kernel's K2 against those from the twin's, with K1's masks
    a2t_p = a2t_p.reshape(n_tiles, t * t, D * D)
    small_p = small_p.reshape(n_tiles, t * t, ts.SMALL_CH)
    via_k2 = tf.apply_scatter(masks, a2t.reshape(a2t_p.shape),
                              small.reshape(small_p.shape), inputs[2],
                              t=t, h=h, b=b)
    via_twin = tf.apply_scatter(masks, a2t_p, small_p, inputs[2],
                                t=t, h=h, b=b)
    need(torch.equal(via_k2[..., 3], via_twin[..., 3]),
         f"{label} K2: K4 counts differ between the kernel's and the "
         "twin's gates")
    covered = via_twin[..., 3] > 0
    est_k2, est_twin = ((o[..., :3] / o[..., 3:].clamp(min=1.0))[covered]
                        for o in (via_k2, via_twin))
    rel_cand = rms(est_k2 - est_twin) / rms(est_twin)
    print(f"[2] {label} K2 through K4, all {int(covered.sum())} covered "
          f"pixels: estimate rel rms {rel_cand:.3e}, max abs err "
          f"{float((est_k2 - est_twin).abs().max()):.3e} (limit rel rms "
          f"{K2_CANDIDATE_REL_RMS:g})", flush=True)
    need(rel_cand < K2_CANDIDATE_REL_RMS,
         f"{label} K2: K4 estimates beyond rel rms {K2_CANDIDATE_REL_RMS:g}")

    # K4 with identical inputs: the twin's K2 output
    k4 = lambda: tf.apply_scatter(  # noqa: E731
        masks, a2t_p, small_p, inputs[2], t=t, h=h, b=b)
    k4_plain = lambda: tf.apply_scatter_plain(  # noqa: E731
        masks, a2t_p, small_p, inputs[2], t=t, h=h, b=b)
    out, out_p = k4(), k4_plain()
    need(torch.equal(out[..., 3], out_p[..., 3]), f"{label} K4: counts differ")
    g, r = out[..., :3], out_p[..., :3]
    need(bool(((g - r).abs() <= 3e-5 + 3e-5 * r.abs()).all()),
         f"{label} K4: sums beyond rtol/atol 3e-5")
    need(torch.equal(out, k4()), f"{label} K4: not deterministic")
    err = float((g - r).abs().max())
    n_applied = int((masks.sum(-1).float() * small_p[..., D]).sum())
    res["K4"] = (err, cuda_ms(k4, reps), cuda_ms(k4_plain, 1),
                 bounds.k4(n_tiles, t, h, b, n_applied))
    print(f"[2] {label} K4 apply_scatter ({n_tiles} tiles, {n_applied} "
          f"filtered candidates): max abs err {err:.3e}, counts exact, "
          f"bitwise repeatable; kernel {res['K4'][1]:.3f} ms, twin "
          f"{res['K4'][2]:.3f} ms, bound {res['K4'][3][0]:.3f} ms "
          f"({res['K4'][3][1]})", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 2, continued: solve_filter and the lane-form solve_matrices
# ---------------------------------------------------------------------------


def stack_inputs(rng, O, d, P, device):
    """Random candidate stacks in JAX's lane layout (the synthetic inputs
    of tests/test_solve_filter_pallas.py::make_inputs): dict of C (O, d, P),
    mask (O, P), noise (6 npx, P), n (1, P), m (d, P). The lane form's
    moments are ``lane_moments``'s, formed on the card."""
    import torch

    npx = d // 3
    C = rng.standard_normal((O, d, P))
    mask = (rng.random((O, P)) < 0.7).astype(np.float64)
    mask[O // 2] = 1.0
    n = mask.sum(axis=0, keepdims=True)
    m = (C * mask[:, None, :]).sum(axis=0) / n
    noise = np.zeros((npx, 6, P))
    noise[:, 0:3] = 0.05 + 0.1 * rng.random((npx, 3, P))
    noise[:, 3:6] = 0.01 * rng.standard_normal((npx, 3, P))
    noise = noise.reshape(6 * npx, P)
    x = dict(C=C, mask=mask, noise=noise, n=n, m=m)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32),
                            device=device) for k, v in x.items()}


def lane_moments(x):
    """The lane solve_matrices' inputs (m2, msum, nov, n) from a stack."""
    import torch

    mk = x["mask"][:, None, :]
    return (torch.einsum("okp,olp->klp", mk * x["C"], x["C"]).contiguous(),
            (mk * x["C"]).sum(0), (x["noise"] * x["n"]).contiguous(), x["n"])


def r2_batch(stats, dev, thr, batch=8, radius=2, search_radius=6):
    """The candidate-stack engine's solve inputs for tile batch ``batch``
    (the engine's tiles a batch, 16, 8 or 4 of 32x32) of a whole image at
    r = ``radius``, b = ``search_radius``, built as the engine builds
    them. Returns (pixel-major stacks cand, mask, noise, n, m of every
    center, main-path mask)."""
    from bcd_tpu_torch.core.monoscale import (MonoscaleConfig,
                                              candidate_stacks, tile_batches)

    cfg = MonoscaleConfig(patch_radius=radius, search_radius=search_radius)
    height, width = stats[0].shape[:2]
    batches = tile_batches(cfg, *padded(cfg, *stats, dev))
    for _ in range(batch):
        next(batches)
    _, (ly, lx), slabs = next(batches)
    s = candidate_stacks(cfg, *slabs, ly, lx, ly, lx, height, width, height,
                         width, thr)
    return {k: s[k] for k in PM_KEYS}, s["main"]


def pm_of(x):
    """solve_filter_pm's arguments (cand, mask, noise, n, m) from stacks in
    JAX's lane layout."""
    return (x["C"].permute(2, 0, 1).contiguous(), x["mask"].T.contiguous(),
            x["noise"].T.contiguous(), x["n"][0].contiguous(),
            x["m"].T.contiguous())


def lanes_of(x):
    """JAX's lane layout (pixels last) of pixel-major stacks: dict of C
    (O, d, P), mask (O, P), noise (6 npx, P), n (1, P), m (d, P)."""
    return {"C": x["cand"].permute(1, 2, 0).contiguous(),
            "mask": x["mask"].T.contiguous(), "noise": x["noise"].T.contiguous(),
            "n": x["n"][None].contiguous(), "m": x["m"].T.contiguous()}


def r2_main_fraction(stats, dev, thr, radius=2, search_radius=6,
                     every=1) -> float:
    """Main-path centers over managed centers of the r = ``radius``, b =
    ``search_radius`` engine on a whole image, or on every ``every``-th of
    its 16-tile batches (rows of tiles spread over the image): n >= d + 1
    similar patches (distance masks only, so STACK_TILE_BATCH tiles a
    batch at every r: the masks are a tile's own, and at the engine's 2
    tiles a batch of r = 8 the launches of the window loop took a
    minute)."""
    import itertools

    from bcd_tpu_torch.core.monoscale import (STACK_TILE_BATCH,
                                              MonoscaleConfig,
                                              _distance_masks, tile_batches)

    cfg = MonoscaleConfig(patch_radius=radius, search_radius=search_radius,
                          tile_batch=STACK_TILE_BATCH)
    height, width = stats[0].shape[:2]
    main = managed = 0
    for _, (ly, lx), slabs in itertools.islice(
            tile_batches(cfg, *padded(cfg, *stats, dev)), 0, None, every):
        masks, cv = _distance_masks(cfg, slabs[2], slabs[1][..., 0], ly, lx,
                                    ly, lx, height, width, height, width, thr)
        main += int(((masks.sum(1) >= cfg.d + 1) & cv).sum())
        managed += int(cv.sum())
    need(managed > 0, f"no managed pixels at r = {radius}")
    return main / managed


def rel_rms(got, ref) -> float:
    import torch

    return float(torch.sqrt(torch.mean((got.double() - ref.double()) ** 2))
                 / torch.sqrt(torch.mean(ref.double() ** 2)))


def compare_solve_synthetic(dev):
    """solve_filter at d = 75 and the lane solve_matrices at d = 27 and 75
    against their twins (and against solve_filter) on synthetic stacks,
    within JAX's own kernel-vs-reference bound. Returns the max abs err."""
    from bcd_tpu_torch.ops import solve_filter as ts

    err = 0.0
    for O, d in ((49, 27), (169, 75)):
        x = stack_inputs(np.random.default_rng(d), O, d, 1024, dev)
        npx = d // 3
        args = [x[k] for k in ("C", "mask", "noise", "n", "m")]
        field = ts.solve_filter(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
        ref = ts.solve_filter_plain(*args, 1e-8, npx=npx)
        e_f = rmse(field.cpu(), ref.cpu())
        lane = ts.solve_matrices(*lane_moments(x), 1e-8, npx=npx,
                                 sweeps=SOLVE_SWEEPS)
        lane_p = ts.solve_matrices_plain(*lane_moments(x), 1e-8, npx=npx)
        e_l = max(rmse(g.cpu(), r.cpu()) for g, r in zip(lane, lane_p))
        e_c = rmse(field.cpu(), lane_field(lane, x).cpu())
        model = ts.solve_filter_pm_schedule(
            *(v for v in pm_of(x)), 1e-8, npx, SOLVE_SWEEPS).permute(1, 2, 0)
        lane_m = ts.solve_matrices_schedule(*lane_moments(x), 1e-8, npx,
                                            SOLVE_SWEEPS)
        e_m = max(rmse(field.cpu(), model.cpu()),
                  max(rmse(g.cpu(), r.cpu()) for g, r in zip(lane, lane_m)))
        print(f"[2] synthetic d={d} (O={O}, 1024 pixels, sweeps "
              f"{SOLVE_SWEEPS}): solve_filter vs twin rms {e_f:.3e}; lane "
              f"solve_matrices vs twin rms {e_l:.3e}; lane filter vs "
              f"solve_filter rms {e_c:.3e} (limit {SYNTH_RMS:g}); both vs "
              f"their fp32 schedule model rms {e_m:.3e} (limit "
              f"{SOLVE_MODEL_RMS:g})", flush=True)
        need(max(e_f, e_l, e_c) < SYNTH_RMS, f"synthetic d={d} solve rms")
        need(e_m < SOLVE_MODEL_RMS, f"synthetic d={d} solves vs their model")
        err = max(err, float((field - ref).abs().max()),
                  max(float((g - r).abs().max())
                      for g, r in zip(lane, lane_p)))
    return err


def lane_field(lane, x):
    """field = mask (A2 c + b2) from the lane solve_matrices' (a2t, b2)."""
    import torch

    a2t, b2 = lane
    return x["mask"][:, None, :] * (
        torch.einsum("kjp,okp->ojp", a2t, x["C"]) + b2)


def compare_solve_batch(label, x, main, reps):
    """solve_filter and the lane solve_matrices on one real r = 2 batch of
    pixel-major stacks: the kernel must be finite on every center (main
    path, fallback, invalid); on the main-path centers, which the engine
    solves, both are held to their float64 twins through the filtered
    field, and the engine's entry (``rows``, in place) must give the same
    bits as the compact stack. Returns {name: (max_abs_err, ms, plain_ms,
    bound)}."""
    import torch
    from bcd_tpu_torch.ops import bounds
    from bcd_tpu_torch.ops import solve_filter as ts

    p_all, n_off, d = x["cand"].shape
    npx = d // 3
    args = [x[k] for k in PM_KEYS]
    every = ts.solve_filter_pm(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    need(bool(torch.isfinite(every).all()),
         f"{label} solve_filter: non-finite output")
    idx = main.nonzero()[:, 0]
    need(idx.numel() > 0, f"{label}: no main-path center")
    xm = {k: v[idx].contiguous() for k, v in x.items()}
    args_m = [xm[k] for k in PM_KEYS]
    sf = lambda: ts.solve_filter_pm(  # noqa: E731
        *args_m, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    field = sf()
    in_place = ts.solve_filter_pm(*args, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS,
                                  rows=idx)
    rest = torch.ones(p_all, dtype=torch.bool, device=idx.device)
    rest[idx] = False
    need(torch.equal(in_place[idx], field)
         and not bool(in_place[rest].any()),
         f"{label} solve_filter_pm: rows in place differ from the compact "
         "stack")
    whole_ms = cuda_ms(sf, reps)
    n_t = min(LANE_CENTERS, idx.numel())
    args_t = [v[:n_t] for v in args_m]
    sf_t = lambda: ts.solve_filter_pm(  # noqa: E731
        *args_t, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    ref, plain_ms = timed_once(lambda: ts.solve_filter_pm_plain(
        *args_t, 1e-8, npx=npx))
    rel = rel_rms(field[:n_t], ref)
    res = {"solve_filter": (float((field[:n_t] - ref).abs().max()),
                            cuda_ms(sf_t, reps), plain_ms, bounds.solve_filter(
                                n_t, n_off, d, SOLVE_SWEEPS))}
    print(f"[2] {label} solve_filter: {idx.numel()} main-path centers of "
          f"{main.numel()} (O={n_off}, d={d}), finite on all, the engine's "
          f"in-place rows bitwise equal, kernel {whole_ms:.3f} ms on all; on "
          f"the first {n_t}: field vs float64 twin rel rms {rel:.3e} (limit "
          f"{BATCH_REL_RMS:g}), max abs err {res['solve_filter'][0]:.3e}; "
          f"kernel {res['solve_filter'][1]:.3f} ms, twin "
          f"{res['solve_filter'][2]:.3f} ms, bound "
          f"{res['solve_filter'][3][0]:.3f} ms", flush=True)
    need(rel < BATCH_REL_RMS, f"{label} solve_filter vs twin")
    model = ts.solve_filter_pm_schedule(
        *(v[:MODEL_CENTERS] for v in args_m), 1e-8, npx, SOLVE_SWEEPS)
    rel_m = rel_rms(field[:MODEL_CENTERS], model)
    print(f"[2] {label} solve_filter vs its fp32 schedule model on the first "
          f"{model.shape[0]} main-path centers: field rel rms {rel_m:.3e} "
          f"(limit {SOLVE_MODEL_BATCH_REL_RMS:g})", flush=True)
    need(rel_m < SOLVE_MODEL_BATCH_REL_RMS,
         f"{label} solve_filter vs its schedule model")

    # the lane form on the first LANE_CENTERS of those centers
    xl = lanes_of({k: v[:LANE_CENTERS] for k, v in xm.items()})
    field = field[:LANE_CENTERS].permute(1, 2, 0)
    moments = lane_moments(xl)
    sm = lambda: ts.solve_matrices(  # noqa: E731
        *moments, 1e-8, npx=npx, sweeps=SOLVE_SWEEPS)
    sm_plain = lambda: ts.solve_matrices_plain(  # noqa: E731
        *moments, 1e-8, npx=npx)
    lane = sm()
    lane_p, plain_ms = timed_once(sm_plain)
    want = lane_field(lane_p, xl)
    got = lane_field(lane, xl)
    rel_l = rel_rms(got, want)
    rel_c = rel_rms(got, field)
    res["solve_matrices"] = (float((got - want).abs().max()),
                             cuda_ms(sm, reps), plain_ms, bounds.solve_matrices(
                                 xl["n"].shape[1], d, SOLVE_SWEEPS))
    print(f"[2] {label} lane solve_matrices on the moments of the first "
          f"{xl['n'].shape[1]} of those centers: "
          f"filtered field vs float64 twin rel rms {rel_l:.3e}, vs "
          f"solve_filter's kernel {rel_c:.3e} (limit {BATCH_REL_RMS:g}); "
          f"raw a2t rms {rmse(lane[0].cpu(), lane_p[0].cpu()):.3e}; kernel "
          f"{res['solve_matrices'][1]:.3f} ms, twin "
          f"{res['solve_matrices'][2]:.3f} ms, bound "
          f"{res['solve_matrices'][3][0]:.3f} ms", flush=True)
    need(max(rel_l, rel_c) < BATCH_REL_RMS, f"{label} solve_matrices")
    return res


# ---------------------------------------------------------------------------
# phase 7: the -w 3 path (d = 147, csrc/solve_filter_smem.cu)
# ---------------------------------------------------------------------------


def side_streams(dev, n):
    """``n`` CUDA streams that start after the work queued so far on the
    current one: for kernel calls whose time is not read, to run beside
    each other and beside the plain references on the current stream (a
    call on a few pixels fills a few SMs and lasts a pixel's latency).
    ``join`` makes the current stream wait for them."""
    import torch

    cur = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in range(n)]
    for st in streams:
        st.wait_stream(cur)

    def join():
        for st in streams:
            cur.wait_stream(st)

    return streams, join


class Beside:
    """Checks whose time is not read, their kernel calls run beside card
    work whose time is not read either ((e)'s card run of the crop):
    ``add(launch, model, finish)`` queues one; ``open`` calls every
    ``launch`` (kernel calls on side streams, a few pixels each, so a few
    SMs for a pixel's latency); ``close`` waits for them, then runs each
    ``model`` (the fp32 models, bound by their launches: on a host thread
    of their own beside the card run they and the run's launches took
    turns at the GIL, and both took several times as long) and calls
    ``finish(launched, model's output, model's seconds)``, which joins the
    check's side streams and compares. Returns the seconds from ``open``
    to the models' start."""

    def __init__(self, dev, label="(e)'s card run"):
        self.dev, self.label, self.checks = dev, label, []

    def add(self, launch, model, finish):
        self.checks.append((launch, model, finish))

    def open(self):
        self.t0 = time.perf_counter()
        self.launched = [launch() for launch, _, _ in self.checks]

    def close(self):
        import torch

        torch.cuda.synchronize(self.dev)
        secs = time.perf_counter() - self.t0
        for (_, model, finish), launched in zip(self.checks, self.launched):
            t0 = time.perf_counter()
            out = model()
            torch.cuda.synchronize(self.dev)
            finish(launched, out, time.perf_counter() - t0)
        # what the calls returned (at r = 10 and 11 the batch's in-place
        # field) is freed with them
        self.checks, self.launched = [], []
        return secs


def compare_smem_synthetic(dev, sweeps, O=169, d=147, tag="[7]",
                           name="solve_filter_smem", pixels=1024,
                           model_sweeps=None, diag=False, model_pixels=None,
                           beside=None):
    """solve_filter_pm at d (147: ``solve_filter_smem``, 243 to 1875:
    ``solve_filter_<d>``) on ``pixels`` synthetic
    pixels of O candidates: against the float64 twin at ``sweeps``, and
    against the fp32 model of its schedule at ``model_sweeps`` (default
    ``sweeps``) on the first ``model_pixels`` (default all; where the
    counts differ and ``diag`` is set, the model is also read at
    ``sweeps`` and against itself with the candidates reversed at both,
    with no limit, on the first SYNTH_DIAG_PIXELS pixels). The kernel's
    calls run on side streams, beside each other and the twin, and the
    model after them; or with ``beside`` (a ``Beside``) the calls and the
    model are queued there and compared when it closes. Where a round has
    more than eight pivot passes (d = 1083 to 1875), the first round's
    pivots of the pairs past the eighth pass, which a lane's second angle
    step forms, must be non-zero on every pixel. Returns the max abs err
    against the twin, or with ``beside`` a list that receives it."""
    import torch
    from bcd_tpu_torch.ops import solve_filter as ts

    npx = d // 3
    model_sweeps = sweeps if model_sweeps is None else model_sweeps
    x = stack_inputs(np.random.default_rng(d), O, d, pixels, dev)
    pm = pm_of(x)
    half = (d + d % 2) // 2
    if half > 8 * PIVOT_PAIRS_A_PASS:
        # W = Cemp - BD with Q = I: the first round pairs seats (i, i +
        # half), whose pivot is W[i][i + half]; the last pair of an odd d
        # holds the zero padding row
        w = (ts._cemp(torch.einsum("poi,poj->pij", pm[1][..., None] * pm[0],
                                   pm[0]), pm[4], pm[3])
             - ts._noise_bd(pm[2], npx))
        seats = torch.arange(8 * PIVOT_PAIRS_A_PASS, half - d % 2,
                             device=w.device)
        need(bool((w[:, seats, seats + half] != 0).all()),
             f"synthetic d={d}: a first-round pivot past the eighth pass "
             "is zero")
        print(f"{tag} synthetic d={d}: the first round's pivots of pairs "
              f"{int(seats[0])} to {int(seats[-1])} (passes 9 to "
              f"{-(-half // PIVOT_PAIRS_A_PASS)}) non-zero on all {pixels} "
              "pixels", flush=True)
        del w
    counts = sorted({sweeps, model_sweeps})
    pk = pm if model_pixels is None else [v[:model_pixels] for v in pm]

    def launch():
        streams, join = side_streams(dev, len(counts))
        fields = {}
        for st, s in zip(streams, counts):
            with torch.cuda.stream(st):
                fields[s] = ts.solve_filter_pm(*pm, 1e-8, npx=npx, sweeps=s)
        return fields, join

    def model():
        return ts.solve_filter_pm_schedule(*pk, 1e-8, npx, model_sweeps)

    def finish(launched, model_out, model_s, kernel_s=None, twin=None):
        fields, join = launched
        join()
        if twin is None:
            twin = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
        field, field_m = fields[sweeps], fields[model_sweeps]
        need(bool(torch.isfinite(field).all()),
             f"synthetic d={d}: non-finite")
        e_t = rmse(field.cpu(), twin.cpu())
        n_m = model_out.shape[0]
        e_m = rmse(field_m[:n_m].cpu(), model_out.cpu())
        when = (f"the kernel's {len(counts)} calls beside the twin "
                f"{kernel_s:.1f} s, then the model {model_s:.1f} s"
                if kernel_s is not None else
                f"the kernel's {len(counts)} calls beside {beside.label}, "
                f"then the model {model_s:.1f} s")
        print(f"{tag} synthetic d={d} (O={O}, {pixels} pixels): {name} at "
              f"{model_sweeps} sweeps vs its fp32 schedule model on the "
              f"first {n_m} rms {e_m:.3e} (limit {SMEM_MODEL_RMS:g}; {when}),"
              f" model vs twin {rmse(model_out.cpu(), twin[:n_m].cpu()):.3e};"
              f" at "
              f"{sweeps} sweeps vs float64 twin rms {e_t:.3e} (limit "
              f"{SYNTH_RMS:g})", flush=True)
        need(e_m < SMEM_MODEL_RMS, f"synthetic d={d} vs the schedule model")
        need(e_t < SYNTH_RMS, f"synthetic d={d} vs the float64 twin")
        return float((field - twin).abs().max())

    if beside is not None:
        err = []
        beside.add(launch, model,
                   lambda *a: err.append(finish(*a)))
        return err
    t0 = time.perf_counter()
    launched = launch()
    twin = ts.solve_filter_pm_plain(*pm, 1e-8, npx)
    # the fp32 model after the kernel's calls: beside the model a call ran
    # about twice as long, both streaming from HBM (PERF.md)
    launched[1]()
    torch.cuda.synchronize(dev)
    kernel_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    out = model()
    torch.cuda.synchronize(dev)
    model_s = time.perf_counter() - t1
    if diag and model_sweeps != sweeps:
        k = SYNTH_DIAG_PIXELS
        pd = [v[:k] for v in pm]
        field = launched[0][sweeps]

        def order_gap(m, s):
            # the model against itself with the candidates reversed, on the
            # first k pixels: the same schedule with M2 summed in another
            # fp32 order
            rev = ts.solve_filter_pm_schedule(pd[0].flip(1), pd[1].flip(1),
                                              *pd[2:], 1e-8, npx, s).flip(1)
            return rmse(m[:k].cpu(), rev.cpu())

        t1 = time.perf_counter()
        model_d = ts.solve_filter_pm_schedule(*pd, 1e-8, npx, sweeps)
        print(f"{tag} synthetic d={d} (O={O}, the first {k} pixels) at "
              f"{sweeps} sweeps, no limit: {name} vs its fp32 schedule model "
              f"rms {rmse(field[:k].cpu(), model_d.cpu()):.3e}, model vs "
              f"twin {rmse(model_d.cpu(), twin[:k].cpu()):.3e}, model vs "
              f"itself with the candidates reversed "
              f"{order_gap(model_d, sweeps):.3e}; at {model_sweeps} sweeps "
              f"model vs itself with the candidates reversed "
              f"{order_gap(out, model_sweeps):.3e} "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
        del model_d
    return finish(launched, out, model_s, kernel_s, twin)


def compare_smem_batch(label, x, main, sweeps, tag="[7]",
                       name="solve_filter_smem",
                       model_centers=R3_MODEL_CENTERS,
                       model_limit=SMEM_MODEL_BATCH_REL_RMS,
                       bitwise_centers=None, tail_centers=None, part=False,
                       time_once=False, twin_centers=R3_TWIN_CENTERS,
                       compact_centers=None, beside=None,
                       inplace_beside=False):
    """``name`` (solve_filter_pm at d = 147 to 1875) on one real batch: the
    engine's in-place call on the main-path rows, timed after a warm-up
    or, with ``time_once``, once (and so the twin's centers), and zero on
    every other row. The in-place call solves every main-path row, or with
    ``part`` only the first ``bitwise_centers`` and the last
    ``tail_centers`` of them (the rows at the stack's highest offsets; a
    part of a batch too costly to time whole). The in-place field against
    the float64 twin on its first ``twin_centers``. One compact call on
    the same rows, or on the first and last ``compact_centers`` / 2 of
    them, run on a side stream beside the fp32 model, must give the same
    bits, and the in-place field must lie within ``model_limit`` of the
    model on at most ``model_centers`` centers; with ``beside`` (a
    ``Beside``) those two are queued there, and with ``inplace_beside``
    the timed in-place call too, on a side stream of its own timed by
    CUDA events (its rows must be the twin's centers). Returns a list that
    holds, once the checks have run, (max_abs_err, ms, plain_ms, bound) on
    the twin's centers (the in-place call's time where they are all its
    rows) and the in-place call's ms; the in-place call's rows (printed
    beside its bound); and the batch's main-path centers."""
    import torch
    from bcd_tpu_torch.ops import bounds
    from bcd_tpu_torch.ops import solve_filter as ts

    p_all, n_off, d = x["cand"].shape
    npx = d // 3
    args = [x[k] for k in PM_KEYS]
    idx = main.nonzero()[:, 0]
    need(idx.numel() >= twin_centers, f"{label}: too few main-path centers")
    if part:
        n_first, n_last = bitwise_centers, tail_centers or 0
        rows = torch.cat([idx[:n_first],
                          idx[idx.numel() - n_last:]]).unique()
    else:
        n_first, n_last, rows = idx.numel(), 0, idx
    batch = lambda: ts.solve_filter_pm(  # noqa: E731
        *args, 1e-8, npx=npx, sweeps=sweeps, rows=rows)
    # the solved rows' stacks, for the compact call, the model and the twin
    args_m = [x[k][rows].contiguous() for k in PM_KEYS]
    n_rows = rows.numel()
    need(not inplace_beside or (beside is not None and time_once
                                and n_rows == twin_centers),
         f"{label}: an in-place call beside (c) is timed once on the "
         "twin's centers")

    def checked(whole):
        """The in-place field's solved rows; every other row must be 0."""
        need(bool(torch.isfinite(whole).all()), f"{label}: non-finite field")
        rest = torch.ones(p_all, dtype=torch.bool, device=idx.device)
        rest[rows] = False
        need(not bool(whole[rest].any()),
             f"{label} {name}: rows not solved in place are not zero")
        return whole[rows]

    got = {}
    if not inplace_beside:
        whole, got["ms"] = timed_once(batch) if time_once else (batch(),
                                                               None)
        got["field"] = checked(whole)
        del whole
        if got["ms"] is None:
            got["ms"] = cuda_ms(batch, 1)
    if compact_centers is None or compact_centers >= n_rows:
        sel = torch.arange(n_rows, device=rows.device)
    else:
        half = compact_centers // 2
        sel = torch.cat([torch.arange(half, device=rows.device),
                         torch.arange(n_rows - half, n_rows,
                                      device=rows.device)])
    bound_batch = bounds.solve_filter(n_rows, n_off, d, sweeps)
    last = int(rows[sel[-1]])
    on_rows = (f"the same {n_rows}" if sel.numel() == n_rows else
               f"the first and last {sel.numel() // 2} of the same {n_rows}")
    # the compact call, on a side stream beside the fp32 model (neither is
    # timed: the call lasts about a pixel's latency, the model about as
    # long from d = 867)
    args_c = [v[sel].contiguous() for v in args_m]
    args_model = [v[:model_centers].contiguous() for v in args_m]
    # only a queued in-place call keeps the batch's stack alive until it runs
    timed_call = batch if inplace_beside else None
    del batch

    def launch():
        streams, join = side_streams(idx.device, 1 + inplace_beside)
        with torch.cuda.stream(streams[0]):
            compact = ts.solve_filter_pm(*args_c, 1e-8, npx=npx,
                                         sweeps=sweeps)
        timed = None
        if inplace_beside:
            with torch.cuda.stream(streams[1]):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                whole = timed_call()
                end.record()
            timed = whole, start, end
        return compact, timed, join

    def model():
        return ts.solve_filter_pm_schedule(*args_model, 1e-8, npx, sweeps)

    def finish(launched, model_out, model_s, compact_s=None):
        compact, timed, join = launched
        join()
        if timed is not None:
            whole, start, end = timed
            got["ms"] = start.elapsed_time(end)
            got["field"] = checked(whole)
            del whole
        field = got["field"]
        need(torch.equal(field[sel], compact),
             f"{label} {name}: rows in place differ from the compact stack "
             f"(rows {int(rows[sel[0]])} to {last}, last element "
             f"{(last + 1) * n_off * d - 1})")
        rel_m = rel_rms(field[:model_centers], model_out)
        when = (f"the call beside the model {compact_s:.1f} s"
                if compact_s is not None else
                f"the call{'s' if timed else ''} beside {beside.label}")
        print(f"{tag} {label} {name}: the engine's in-place rows bitwise "
              f"equal to the compact call on {on_rows}, up to element "
              f"{(last + 1) * n_off * d - 1} of the stack ({when}); field "
              f"vs its fp32 schedule model on the first "
              f"{min(model_centers, n_rows)} centers rel rms {rel_m:.3e} "
              f"(limit {model_limit:g}; the model {model_s:.1f} s)",
              flush=True)
        need(rel_m < model_limit, f"{label} {name} vs its schedule model")
        if timed is not None:
            report()

    out = []

    def report():
        field, ms_batch = got["field"], got["ms"]
        subt = [v[:twin_centers].contiguous() for v in args_m]
        sf = lambda: ts.solve_filter_pm(  # noqa: E731
            *subt, 1e-8, npx=npx, sweeps=sweeps)
        ref, plain_ms = timed_once(
            lambda: ts.solve_filter_pm_plain(*subt, 1e-8, npx=npx))
        if time_once and n_rows == twin_centers:
            res_got, ms = field, ms_batch  # the in-place call above
        elif time_once:  # this too: a call takes seconds from d = 507
            res_got, ms = timed_once(sf)
        else:
            res_got, ms = sf(), cuda_ms(sf, 3)
        rel = rel_rms(res_got, ref)
        res = (float((res_got - ref).abs().max()), ms, plain_ms,
               bounds.solve_filter(twin_centers, n_off, d, sweeps))
        part_rows = (f" (the first {n_first}"
                     f"{f' and the last {n_last}' if n_last else ''}, a part "
                     "of the batch)") if part else ""
        where = (f" beside {beside.label}, by CUDA events"
                 if inplace_beside else "")
        print(f"{tag} {label} {name}: {idx.numel()} main-path centers "
              f"of {p_all} (O={n_off}, d={d}, sweeps {sweeps}), finite, zero "
              f"on the rows not solved; {ms_batch:.3f} ms for {n_rows} main "
              f"rows in place{part_rows}{where}, bound {bound_batch[0]:.3f} "
              f"ms ({bound_batch[1]})", flush=True)
        print(f"{tag} {label}: field vs the float64 twin on the first "
              f"{twin_centers} rel rms {rel:.3e} (limit {BATCH_REL_RMS:g}), "
              f"max abs err {res[0]:.3e}; on those centers kernel "
              f"{res[1]:.3f} ms, twin {res[2]:.3f} ms, bound "
              f"{res[3][0]:.3f} ms", flush=True)
        need(rel < BATCH_REL_RMS, f"{label} {name} vs twin")
        out[:] = [res, ms_batch]

    if beside is not None:
        beside.add(launch, model, finish)
    else:
        t0 = time.perf_counter()
        launched = launch()
        model_out = model()
        torch.cuda.current_stream(idx.device).synchronize()
        model_s = time.perf_counter() - t0
        launched[2]()
        torch.cuda.synchronize(idx.device)
        finish(launched, model_out, model_s, time.perf_counter() - t0)
    if not inplace_beside:
        report()
    return out, rows, idx.numel()


def r3_phase(dev, card, stats, clean, scene_path, cpu_refs):
    """Phase 7: the -w 3 path on the 1088x1920 scene (its CLI run on a
    crop). Returns the kernels line's entry (max_abs_err, ms, plain_ms,
    bound) and the -w 3 run's launch counts."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.spike_removal import spike_removal
    from bcd_tpu_torch.params import PipelineParameters

    sweeps = solve_filter_sweeps(147)
    # (a) synthetic
    e_syn = compare_smem_synthetic(dev, sweeps)
    # (b) one real 16-tile batch of the finest scale (after the prefilter)
    p3 = PipelineParameters()
    p3.denoiser.monoscale.patch_radius = 3
    thr = p3.denoiser.monoscale.histogram_distance_threshold
    pre = spike_removal(*(torch.as_tensor(a, device=dev) for a in stats),
                        p3.prefiltering.spike_removal_threshold_stdev_factor)
    frac3 = r2_main_fraction(pre, dev, thr, radius=3)
    print(f"[7] 1088x1920 finest scale at r=3, b=6, threshold {thr:g}: "
          f"main-path fraction {frac3:.4f} (floor {R3_MAIN_FLOOR:g})",
          flush=True)
    need(frac3 > R3_MAIN_FLOOR, "the -w 3 run barely reaches the main path")
    (res, _), *_ = compare_smem_batch("full-size r=3 batch 8",
                                      *r2_batch(pre, dev, thr, radius=3),
                                      sweeps=sweeps)
    res = (max(res[0], e_syn),) + res[1:]
    del pre

    # (c) bcd -w 3 through the CLI's entry point on the R3_CROP crop, warmed
    # up on a smaller one: run once, traced (the kernel's share of its
    # device time)
    dev_stats = [torch.as_tensor(x, device=dev) for x in stats]
    denoise_pipeline(*(x[:64, :64].contiguous() for x in dev_stats), dev, p3)
    ch, cw = R3_CROP
    crop_path = scene_path.replace(".exr", "_w3crop.exr")
    write_scene(crop_path, *(x[:ch, :cw] for x in stats))
    out_path = crop_path.replace(".exr", "_out.exr")
    argv3 = ["-i", crop_path, "-o", out_path, "-w", "3"]
    rcs = []
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cli3_s, busy, rows = device_time_table(
        f"[7] bcd -w 3 on the {ch}x{cw} crop",
        lambda: rcs.append(cli.main(argv3)))
    peak3 = torch.cuda.max_memory_allocated()
    launches3 = dict(_build.LAUNCHES)
    need(rcs == [0], "-w 3 CLI run")
    smem_us = sum(us for us, _, key in rows
                  if "solve_filter_smem_kernel<147>" in key)
    print(f"[7] python -m bcd_tpu_torch.cli {' '.join(argv3)}: rc 0, "
          f"{cli3_s:.3f} s wall with EXR I/O and the profiler on {card}; "
          f"peak memory {peak3 / 2**20:.1f} MiB; launches {launches3}; "
          f"solve_filter_smem {smem_us / 1e6:.4f} s of {busy:.4f} s device "
          f"time (share {smem_us / 1e6 / max(busy, 1e-9):.3f})", flush=True)
    for name in R3_KERNELS:
        need(launches3[name] > 0,
             f"kernel {name} was not launched by the -w 3 path")
    for name in R1_KERNELS:
        need(launches3[name] == 0, f"the -w 3 path launched {name}")
    out3 = image_io.load_exr(out_path)
    clean_c = clean[:ch, :cw]
    need(out3.shape == clean_c.shape and np.isfinite(out3).all(),
         "-w 3 CLI output shape / finiteness")
    e_out3, e_in_c = rmse(out3, clean_c), rmse(stats[0][:ch, :cw], clean_c)
    print(f"[7] rmse vs clean on the crop: -w 3 output {e_out3:.5f}, noisy "
          f"input {e_in_c:.5f}; finest-scale main-path fraction of the "
          f"frame {frac3:.4f}", flush=True)
    need(e_out3 < e_in_c, "the -w 3 output is not closer to the clean image")

    # (d) a crop on the card, twice, against the port's CPU pipeline
    k = R3_CPU_CROP
    crop = [x[:k, :k].contiguous() for x in dev_stats]
    got = denoise_pipeline(*crop, dev, p3)
    need(torch.equal(got, denoise_pipeline(*crop, dev, p3)),
         "-w 3 crop not bitwise repeatable")
    ref, cpu_s, _ = cpu_refs.result(3)
    gap = rmse(got.cpu(), ref)
    print(f"[7] -w 3 pipeline on a {k}x{k} crop (b=6): card vs the port's CPU "
          f"pipeline (float64 twins, {cpu_s:.1f} s) rmse {gap:.3e} (limit "
          f"{R2_CPU_RMSE:g}), max abs "
          f"{float((got.cpu() - ref).abs().max()):.3e}; bitwise repeatable "
          "on the card", flush=True)
    need(gap < R2_CPU_RMSE, "-w 3 on the card against the CPU pipeline")
    return res, launches3


def crop_scene_path(scene_path, radius) -> str:
    """Where phase 8 to 16's crop of the scene is written for the CLI."""
    return scene_path.replace(".exr", f"_w{radius}crop.exr")


def load_scene(path):
    """The three EXR files of ``write_scene`` read as the CLI reads them:
    (color, nb, histo, cov)."""
    from bcd_tpu_torch.io import image_io

    color = image_io.load_exr(path)
    histo, nb = image_io.separate_nb_of_samples_from_histogram(
        image_io.load_multi_channels_exr(path.replace(".exr", "_hist.exr")))
    cov = image_io.load_multi_channels_exr(path.replace(".exr", "_cov.exr"))
    return color, nb, histo, cov


def one_crop(c) -> bool:
    """Whether a wide phase's traced CLI crop (c) is its CPU comparison's
    (e) (from phase 10): (e) then runs the card once, on the CLI run's
    inputs and parameters, and holds it bit for bit to that run."""
    return c["crop"] == (c["cpu_crop"],) * 2 and bool(c.get("scales"))


def cpu_pipeline_params(radius, b, scales=None):
    """The pipeline parameters of ``bcd -w radius -b b [-s scales]``."""
    from bcd_tpu_torch.params import PipelineParameters

    pw = PipelineParameters()
    pw.denoiser.monoscale.patch_radius = radius
    pw.denoiser.monoscale.search_window_radius = b
    if scales:
        pw.denoiser.nb_of_scales = scales
    return pw


@contextlib.contextmanager
def recorded_pipeline():
    """Records the arguments and output of every ``denoise_pipeline`` call
    inside it (the CLI looks the function up at each run) in the dict it
    yields, with the function itself under ``run``."""
    from bcd_tpu_torch.core import pipeline

    run = pipeline.denoise_pipeline
    record = {"run": run}

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        record.update(args=args, kwargs=kwargs, out=out)
        return out

    pipeline.denoise_pipeline = recording
    try:
        yield record
    finally:
        pipeline.denoise_pipeline = run


def write_scene(path, color, nb, histo, cov) -> None:
    """The statistics as the CLI's three EXR files (path, _hist, _cov)."""
    from bcd_tpu_torch.io import image_io

    image_io.write_exr(color, path)
    image_io.write_multi_channels_exr(
        image_io.merge_histogram_and_nb_of_samples(histo, nb),
        path.replace(".exr", "_hist.exr"))
    image_io.write_multi_channels_exr(cov, path.replace(".exr", "_cov.exr"))


def wide_phases():
    """Phases 8 to 16 by patch radius: the launch counter of the kernel the
    radius runs, its window's offsets, its search radius (the smallest that
    reaches the main path), limits and sizes, the keyword arguments of its
    synthetic and real-batch checks, the b of its gate's run; each phase
    times its batch once, not after a warm-up (phase 8's after one until
    phase 14 needed the run's time). From d = 363 on the last main rows of
    the batch are held in place to the compact call as well as the first.
    ``scales``, where given, is the ``-s`` of the crop's CLI runs (else the
    default); ``reference`` "twin" holds the crop to the same pipeline on
    the card with the float64 twin in the kernel's place, not to the port's
    CPU pipeline (``cpu_s`` says why); ``jacobi_share`` False skips the timed 0-sweep call of
    (b), the Jacobi's share (0.780, 0.781 and 0.778 of the 32 rows at
    r = 10, 11 and 12 on an NVIDIA H100 80GB HBM3 at 700 W, 3.9, 6.7 and
    11.2 s of the run, given up when phase 19 came); ``batch_beside`` runs
    (b)'s timed in-place call beside (c) too, timed there by CUDA events,
    not alone before it (r = 10 and 11, 17.8 and 30.6 s alone; not at
    r = 12, where its stack and field, 31.1 GB, and (c)'s 47.5 GB peak
    would not fit the card together); ``trace`` False runs (c) untraced,
    the solve kernel timed by CUDA events (r = 12: the trace of its crop's
    280,000 launches took 17 s to collect and sum)."""
    # phases 10 to 16: the first and last PART_ROWS main rows, timed in
    # place, held to one compact call on all of them and to the twin
    part = dict(bitwise_centers=PART_ROWS, tail_centers=PART_ROWS,
                part=True, twin_centers=2 * PART_ROWS,
                compact_centers=2 * PART_ROWS)
    return {
        4: dict(tag="[8]", kernels=R4_KERNELS, O=289, search=R4_SEARCH,
                floor=R4_MAIN_FLOOR, batch_floor=0.0, crop=R4_CROP,
                cpu_crop=R4_CPU_CROP, synth={},
                batch=dict(model_centers=R4_MODEL_CENTERS),
                # no solve: -w 4 at the default b = 6
                no_solve_b=6),
        5: dict(tag="[9]", kernels=R5_KERNELS, O=441, search=R5_SEARCH,
                floor=R5_MAIN_FLOOR, batch_floor=0.0, crop=R5_CROP,
                cpu_crop=R5_CPU_CROP,
                synth=dict(pixels=R5_SYNTH_PIXELS,
                           model_sweeps=R5_MODEL_SWEEPS, diag=True),
                batch=dict(model_centers=R5_MODEL_CENTERS,
                           model_limit=R5_MODEL_BATCH_REL_RMS,
                           bitwise_centers=R5_BITWISE_CENTERS,
                           tail_centers=R3_TWIN_CENTERS, part=True),
                # no solve: -w 5 at b = 9 (361 offsets)
                no_solve_b=9),
        6: dict(tag="[10]", kernels=R6_KERNELS, O=529, search=R6_SEARCH,
                floor=R6_MAIN_FLOOR, batch_floor=R6_BATCH_FLOOR,
                crop=R6_CROP, cpu_crop=R6_CPU_CROP, scales=R6_SCALES,
                synth=dict(pixels=R6_SYNTH_PIXELS,
                           model_sweeps=R6_MODEL_SWEEPS,
                           model_pixels=LATE_MODEL_PIXELS),
                batch=dict(model_centers=R6_MODEL_CENTERS,
                           model_limit=R6_MODEL_BATCH_REL_RMS, **part),
                # no solve: -w 6 at b = 10 (441 offsets)
                no_solve_b=10),
        7: dict(tag="[11]", kernels=R7_KERNELS, O=729, search=R7_SEARCH,
                floor=R7_MAIN_FLOOR, batch_floor=R7_BATCH_FLOOR,
                crop=R7_CROP, cpu_crop=R7_CPU_CROP, scales=R7_SCALES,
                synth=dict(pixels=R7_SYNTH_PIXELS,
                           model_sweeps=R7_MODEL_SWEEPS,
                           model_pixels=LATE_MODEL_PIXELS),
                batch=dict(model_centers=R7_MODEL_CENTERS,
                           model_limit=R7_MODEL_BATCH_REL_RMS, **part),
                # no solve: -w 7 at b = 12 (625 offsets)
                no_solve_b=12),
        8: dict(tag="[12]", kernels=R8_KERNELS, O=961, search=R8_SEARCH,
                floor=R8_MAIN_FLOOR, batch_floor=R8_BATCH_FLOOR,
                crop=R8_CROP, cpu_crop=R8_CPU_CROP, scales=R8_SCALES,
                synth=dict(pixels=R8_SYNTH_PIXELS,
                           model_sweeps=R8_MODEL_SWEEPS,
                           model_pixels=LATE_MODEL_PIXELS),
                batch=dict(model_centers=R8_MODEL_CENTERS,
                           model_limit=R8_MODEL_BATCH_REL_RMS, **part),
                # no solve: -w 8 at b = 14 (841 offsets)
                no_solve_b=14),
        9: dict(tag="[13]", kernels=R9_KERNELS, O=1089, search=R9_SEARCH,
                floor=R9_MAIN_FLOOR, batch_floor=R9_BATCH_FLOOR,
                crop=R9_CROP, cpu_crop=R9_CPU_CROP, scales=R9_SCALES,
                synth=dict(pixels=R9_SYNTH_PIXELS,
                           model_sweeps=R9_MODEL_SWEEPS,
                           model_pixels=LATE_MODEL_PIXELS),
                batch=dict(model_centers=LATE_MODEL_PIXELS,
                           model_limit=R9_MODEL_BATCH_REL_RMS, **part),
                # no solve: -w 9 at b = 15 (961 offsets)
                no_solve_b=15),
        10: dict(tag="[14]", kernels=R10_KERNELS, O=1369, search=R10_SEARCH,
                 floor=R10_MAIN_FLOOR, batch_floor=R10_BATCH_FLOOR,
                 crop=R10_CROP, cpu_crop=R10_CPU_CROP, scales=R10_SCALES,
                 synth=dict(pixels=R10_SYNTH_PIXELS,
                            model_sweeps=R10_MODEL_SWEEPS,
                            model_pixels=LATE_MODEL_PIXELS),
                 batch=dict(model_centers=LATE_MODEL_PIXELS,
                            model_limit=R10_MODEL_BATCH_REL_RMS, **part),
                 # no solve: -w 10 at b = 17 (1,225 offsets)
                 no_solve_b=17, jacobi_share=False, batch_beside=True),
        11: dict(tag="[15]", kernels=R11_KERNELS, O=1681, search=R11_SEARCH,
                 floor=R11_MAIN_FLOOR, batch_floor=R11_BATCH_FLOOR,
                 crop=R11_CROP, cpu_crop=R11_CPU_CROP, scales=R11_SCALES,
                 synth=dict(pixels=R11_SYNTH_PIXELS,
                            model_sweeps=R11_MODEL_SWEEPS,
                            model_pixels=LATE_MODEL_PIXELS),
                 batch=dict(model_centers=LATE_MODEL_PIXELS,
                            model_limit=R11_MODEL_BATCH_REL_RMS, **part),
                 # no solve: -w 11 at b = 19 (1,521 offsets)
                 no_solve_b=19, jacobi_share=False, batch_beside=True,
                 reference="twin", cpu_s="173.1 s, and ended after phase 15 "
                 "needed it"),
        12: dict(tag="[16]", kernels=R12_KERNELS, O=2025, search=R12_SEARCH,
                 floor=R12_MAIN_FLOOR, batch_floor=R12_BATCH_FLOOR,
                 crop=R12_CROP, cpu_crop=R12_CPU_CROP, scales=R12_SCALES,
                 synth=dict(pixels=R12_SYNTH_PIXELS,
                            model_sweeps=R12_MODEL_SWEEPS,
                            model_pixels=LATE_MODEL_PIXELS),
                 batch=dict(model_centers=LATE_MODEL_PIXELS,
                            model_limit=R12_MODEL_BATCH_REL_RMS, **part),
                 # no solve: -w 12 at b = 21 (1,849 offsets)
                 no_solve_b=21, reference="twin", jacobi_share=False,
                 trace=False, cpu_s="347-429 s, past the card's phases"),
    }


def wide_phase(radius, dev, card, stats, clean, scene_path, cpu_refs):
    """Phase 8 (radius 4, d = 243), 9 (radius 5, d = 363), 10 (radius 6,
    d = 507), 11 (radius 7, d = 675), 12 (radius 8, d = 867), 13 (radius
    9, d = 1083), 14 (radius 10, d = 1323), 15 (radius 11, d = 1587) or 16
    (radius 12, d = 1875): the -w r path on the
    1088x1920 scene at the smallest b that reaches its main path, each
    step's time printed. (e)'s reference, the port's CPU pipeline on a
    crop, comes from ``cpu_refs`` (``CpuReferences``), computed on the
    host's cores while the card works. Returns the kernels
    line's entry (max_abs_err, ms, plain_ms, bound) and the cut frame's
    launch counts."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.core.monoscale import (STACK_TILE_BATCH,
                                              MonoscaleConfig,
                                              solve_filter_sweeps)
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops import solve_filter as ts
    from bcd_tpu_torch.ops.spike_removal import spike_removal
    from bcd_tpu_torch.params import PipelineParameters

    c = wide_phases()[radius]
    tag, b, (name,) = c["tag"], c["search"], c["kernels"]
    d = 3 * (2 * radius + 1) ** 2
    npx = d // 3
    sweeps = solve_filter_sweeps(d)
    w = ["-w", str(radius), "-b", str(b)]
    scales = ["-s", str(c["scales"])] if c.get("scales") else []
    t_step = [time.perf_counter()]

    def step_done(step):
        now = time.perf_counter()
        print(f"{tag} ({step}) in {now - t_step[0]:.1f} s", flush=True)
        t_step[0] = now

    pw = PipelineParameters()
    pw.denoiser.monoscale.patch_radius = radius
    pw.denoiser.monoscale.search_window_radius = b
    k = c["cpu_crop"]

    # (a) synthetic; from phase 10 its kernel calls and model are queued
    # to run beside (c), the crop's CLI run (``Beside``), and so are (b)'s
    # compact call and model
    twin_ref = c.get("reference") == "twin"
    later = Beside(dev, "(c)") if twin_ref or one_crop(c) else None
    e_syn = compare_smem_synthetic(dev, sweeps, O=c["O"], d=d, tag=tag,
                                   name=name, beside=later, **c["synth"])
    step_done("a")
    # (b) one real tile batch of the finest scale (after the prefilter): 16
    # tiles, 8 at r = 6, 4 at r = 7, 2 at r = 8 and 9 and 1 at r = 10 to
    # 12 (core/monoscale.STACK_BYTES), the batch that holds the tiles of
    # phase 2's 16-tile batch 8 (at r = 10 to 12 its first tile)
    n_tiles = MonoscaleConfig(patch_radius=radius, search_radius=b).batch
    k_batch = 8 * STACK_TILE_BATCH // n_tiles
    thr = pw.denoiser.monoscale.histogram_distance_threshold
    pre = spike_removal(*(torch.as_tensor(a, device=dev) for a in stats),
                        pw.prefiltering.spike_removal_threshold_stdev_factor)
    t0 = time.perf_counter()
    frac = r2_main_fraction(pre, dev, thr, radius=radius, search_radius=b,
                            every=FRAME_PART)
    print(f"{tag} 1088x1920 finest scale at r={radius}, b={b}, threshold "
          f"{thr:g}, on every {FRAME_PART}th 16-tile batch: main-path "
          f"fraction {frac:.4f} (floor "
          f"{c['floor']:g}; {time.perf_counter() - t0:.1f} s)", flush=True)
    need(frac > c["floor"], f"the {' '.join(w)} run barely reaches the main "
         "path")
    x, main = r2_batch(pre, dev, thr, batch=k_batch, radius=radius,
                       search_radius=b)
    del pre
    batch_frac = float(main.sum()) / main.numel()
    print(f"{tag} {n_tiles}-tile batch {k_batch}: main-path fraction "
          f"{batch_frac:.4f} (floor {c['batch_floor']:g})", flush=True)
    need(batch_frac > c["batch_floor"], f"the {n_tiles}-tile batch "
         f"{k_batch} barely reaches the main path")
    batch_beside = c.get("batch_beside", False)
    b_out, timed_rows, _ = compare_smem_batch(
        f"full-size r={radius} b={b} {n_tiles}-tile batch {k_batch}", x,
        main, sweeps=sweeps, tag=tag, name=name, time_once=True,
        beside=later, inplace_beside=batch_beside, **c["batch"])
    # the Jacobi's share: the same rows at 0 sweeps, timed once
    if c.get("jacobi_share", True):
        batch_ms = b_out[1]
        ms0 = timed_once(lambda: ts.solve_filter_pm(
            *(x[k] for k in PM_KEYS), 1e-8, npx=npx, sweeps=0,
            rows=timed_rows))[1]
        print(f"{tag} the same {timed_rows.numel()} rows at 0 sweeps "
              f"{ms0:.3f} ms: the Jacobi's {sweeps} sweeps "
              f"{batch_ms - ms0:.3f} ms (share {1 - ms0 / batch_ms:.3f})",
              flush=True)
    # with ``batch_beside`` the in-place call's closure keeps the batch
    # until it has run beside (c)
    del x, main
    step_done("b" if not batch_beside else "b, its inputs")

    # (c) bcd -w r -b b through the CLI's entry point on a crop, traced (or
    # its solve calls timed by CUDA events), with the calls queued in
    # ``later`` beside it on side streams
    ch, cw = c["crop"]
    crop_path = crop_scene_path(scene_path, radius)
    write_scene(crop_path, *(x[:ch, :cw] for x in stats))
    out_path = crop_path.replace(".exr", "_out.exr")
    argv = ["-i", crop_path, "-o", out_path, *w, *scales]
    rcs, held = [], []

    def run():
        # (a)'s and (b)'s queued calls start inside the trace (its start
        # waits for the card to be idle), before the counts are reset;
        # what they hold on the card, their inputs too, counts in the
        # run's peak
        if later is not None:
            later.open()
            held.append(torch.cuda.memory_allocated())
        _build.reset_launches()
        rcs.append(cli.main(argv))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    label = f"{tag} bcd {' '.join(w)} on the {ch}x{cw} crop"
    with recorded_pipeline() as record:
        if c.get("trace", True):
            cli_s, busy, rows = device_time_table(
                label, run, own_stream=later is not None)
            k_us = sum(us for us, _, key in rows
                       if f"solve_filter_smem_kernel<{d}>" in key)
            share = (f"{name} {k_us / 1e6:.4f} s of {busy:.4f} s device "
                     f"time (share {k_us / 1e6 / max(busy, 1e-9):.3f})")
        else:
            with solve_events() as calls:
                t0 = time.perf_counter()
                run()
                torch.cuda.current_stream(dev).synchronize()
                cli_s = time.perf_counter() - t0
            solved = solved_ms(calls)
            k_us = sum(ms for _, ms in solved) * 1e3
            share = (f"{name} {k_us / 1e6:.4f} s by CUDA events around the "
                     f"engine's {len(solved)} solve calls that took a "
                     f"center ({sum(n for n, _ in solved)} centers; device "
                     "time not traced)")
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    need(rcs == [0], f"{' '.join(w)} CLI run")
    # the traced run's wall ends when the card is idle, the untraced one's
    # when its own stream is
    beside_wall = (", to the end of the calls of (a) and (b) beside it"
                   if c.get("trace", True) else
                   ", the calls of (a) and (b) beside it")
    beside_mem = (f", {held[0] / 2**20:.1f} MiB of it held from its start "
                  "by the calls beside it, their inputs included"
                  if held else "")
    print(f"{tag} python -m bcd_tpu_torch.cli {' '.join(argv)}: rc 0, "
          f"{cli_s:.3f} s wall with EXR I/O "
          f"{'and the profiler ' if c.get('trace', True) else ''}on {card}"
          f"{beside_wall if held else ''}; "
          f"peak memory {peak / 2**20:.1f} MiB{beside_mem}; launches "
          f"{launches}; {share}", flush=True)
    need(launches[name] > 0,
         f"kernel {name} was not launched by the {' '.join(w)} path")
    for other in R1_KERNELS + SOLVE_KERNELS:
        if other != name:
            need(launches[other] == 0,
                 f"the {' '.join(w)} path launched {other}")
    out = image_io.load_exr(out_path)
    clean_c = clean[:ch, :cw]
    need(out.shape == clean_c.shape and np.isfinite(out).all(),
         f"{' '.join(w)} CLI output shape / finiteness")
    e_out, e_in_c = rmse(out, clean_c), rmse(stats[0][:ch, :cw], clean_c)
    print(f"{tag} rmse vs clean on the crop: {' '.join(w)} output "
          f"{e_out:.5f}, noisy input {e_in_c:.5f}", flush=True)
    need(e_out < e_in_c, f"the {' '.join(w)} output is not closer to the "
         "clean image")

    def close_later(until):
        t0 = time.perf_counter()
        window_s = later.close()
        print(f"{tag} (a)'s and (b)'s kernel calls beside (c): "
              f"{window_s:.1f} s from their start to the end of {until}, "
              f"then their models {time.perf_counter() - t0:.1f} s",
              flush=True)

    # the traced run ends when the card is idle, so the queued calls have
    # run: they are checked now, and what they hold (at r = 10 and 11 the
    # batch's stack and field) is freed before (d)
    traced_later = later is not None and c.get("trace", True)
    if traced_later:
        close_later("(c), whose trace waited for them")
    step_done("c")

    # (d) the gate: -w r on the crop at a b whose window cannot reach the
    # solve, where no center reaches it
    no_solve_run(tag, crop_path, radius, c["no_solve_b"], scales, clean_c,
                 e_in_c)
    step_done("d")

    # (e) the crop on the card against the port's CPU pipeline: from phase
    # 10, where (c)'s crop is (e)'s, (c)'s output on the inputs and
    # parameters of the CPU pipeline's run (else the pipeline on the card,
    # twice, bitwise repeatable); or, where the CPU pipeline would end
    # after the card's phases (r = 12), (c)'s output against the same
    # pipeline on the card with the float64 twin in the kernel's place, as
    # phase 17. Then the checks queued in ``later``, if not yet done
    if twin_ref:
        ref, twin_calls = twin_reference(tag, record, crop_path, radius, b,
                                         c["scales"])
        got = record["out"]
        gap = rmse(got.cpu(), ref.cpu())
        print(f"{tag} {' '.join(w)} pipeline on the {k}x{k} crop: (c)'s "
              f"card output vs the same pipeline on the card with the "
              f"float64 twin in the kernel's place (the reference; the "
              f"port's CPU pipeline took {c['cpu_s']}) "
              f"rmse {gap:.3e} (limit {R2_CPU_RMSE:g}), max abs "
              f"{float((got - ref).abs().max()):.3e}; the twin "
              f"{sum(ms for _, ms in twin_calls):.3f} ms on "
              f"{sum(n for n, _ in twin_calls)} centers", flush=True)
        need(gap < R2_CPU_RMSE, f"-w {radius} on the card against its "
             "reference")
    else:
        if one_crop(c):
            inputs, kwargs = record["args"], record["kwargs"]
            need(all(np.array_equal(x, y) for x, y in zip(
                inputs[:4], load_scene(crop_path)))
                 and inputs[5] == cpu_pipeline_params(radius, b,
                                                      c["scales"])
                 and kwargs["tile"] is None and kwargs["skip_stride"] == 1,
                 f"{tag} the CLI's pipeline call is not the CPU reference's")
            got = record["out"]
            repeat = "(c)'s output"
        else:
            crop = [torch.as_tensor(x[:k, :k]).to(dev) for x in stats]
            _build.reset_launches()
            got = denoise_pipeline(*crop, dev, pw)
            need(_build.LAUNCHES[name] > 0,
                 f"the {k}x{k} crop reaches no solve")
            need(torch.equal(got, denoise_pipeline(*crop, dev, pw)),
                 f"{' '.join(w)} crop not bitwise repeatable")
            repeat = "bitwise repeatable on the card"
        t0 = time.perf_counter()
        ref, cpu_s, cpu_peak = cpu_refs.result(radius)
        print(f"{tag} waited {time.perf_counter() - t0:.1f} s for the CPU "
              "pipeline", flush=True)
        gap = rmse(got.cpu(), ref)
        print(f"{tag} {' '.join(w)} pipeline on a {k}x{k} crop: card vs the "
              f"port's CPU pipeline (float64 twins, {cpu_tile(k)}x"
              f"{cpu_tile(k)} tiles, {cpu_s:.1f} s, its process's peak "
              f"resident memory so far {cpu_peak:.1f} GiB) rmse {gap:.3e} "
              f"(limit {R2_CPU_RMSE:g}), max abs "
              f"{float((got.cpu() - ref).abs().max()):.3e}; {repeat}",
              flush=True)
        need(gap < R2_CPU_RMSE, f"-w {radius} on the card against the CPU "
             "pipeline")
    if later is not None and not traced_later:
        close_later("(e)")
    if later is not None:
        e_syn = e_syn[0]
    step_done("e")
    res, batch_ms = b_out
    full = 1088 * 1920 / (ch * cw)
    print(f"{tag} estimate, not a run: a 1088x1920 {' '.join(w)} frame "
          f"at this crop's rate per pixel {cli_s * full:.1f} s, its kernel "
          f"{k_us / 1e6 * full:.1f} s; at (b)'s rate per main-path "
          f"center and the finest scale's fraction "
          f"{batch_ms / timed_rows.numel() * 1088 * 1920 * frac / 1e3:.1f}"
          " s in the kernel at the finest scale", flush=True)
    return (max(res[0], e_syn),) + res[1:], launches


@contextlib.contextmanager
def solve_events():
    """The engine's solve entry (``core.monoscale.solve_filter_pm``)
    wrapped while the block runs; yields a list that receives, for each
    call, its rows' count and CUDA events recorded on the current stream
    just before and after it (the kernel's time, with the zero fill of
    its field). For the untraced CLI runs of phases 16 and 17: the traces
    of their crops' 280,000 and 530,000 launches took 17 and 31 s to
    collect and sum on an H100's machine."""
    import torch
    from bcd_tpu_torch.core import monoscale

    engine = monoscale.solve_filter_pm
    calls = []

    def timed(cand, *args, rows=None, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        field = engine(cand, *args, rows=rows, **kwargs)
        end.record()
        calls.append((cand.shape[0] if rows is None else int(rows.numel()),
                      start, end))
        return field

    monoscale.solve_filter_pm = timed
    try:
        yield calls
    finally:
        monoscale.solve_filter_pm = engine


def solved_ms(calls):
    """(centers, ms) of each call of ``solve_events`` that took a center,
    once the card has run them."""
    return [(n, start.elapsed_time(end)) for n, start, end in calls if n]


def no_solve_run(tag, crop_path, radius, b, scales, clean_c, e_in_c) -> None:
    """``bcd -w radius -b b`` through the CLI's entry point on a crop where
    the window cannot reach the solve: it runs, launches no solve kernel
    and gives a finite image; wall time and peak memory."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build

    d = 3 * (2 * radius + 1) ** 2
    out_path = crop_path.replace(".exr", f"_out_w{radius}b{b}.exr")
    argv = ["-i", crop_path, "-o", out_path, "-w", str(radius), "-b",
            str(b), *scales]
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    need(rc == 0, f"-w {radius} (b = {b}) CLI run")
    need(not any(launches[k] for k in SOLVE_KERNELS),
         f"the -w {radius} b = {b} run launched a solve kernel: {launches}")
    out = image_io.load_exr(out_path)
    need(out.shape == clean_c.shape and np.isfinite(out).all(),
         f"-w {radius} (b = {b}) CLI output shape / finiteness")
    print(f"{tag} python -m bcd_tpu_torch.cli {' '.join(argv)}: rc 0, "
          f"{wall:.3f} s wall with EXR I/O; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches "
          f"{launches} (no solve: {(2 * b + 1) ** 2} offsets < {d + 1}); "
          f"rmse vs clean {rmse(out, clean_c):.5f}, noisy input "
          f"{e_in_c:.5f}", flush=True)


def twin_reference(tag, record, crop_path, radius, b, scales):
    """The pipeline call of a traced CLI run (``recorded_pipeline``'s
    ``record``), run again on the card with the float64 twin
    ``solve_filter_pm_plain`` in the solve kernel's place: swapped here, in
    the smoke's own run, not in the engine. Checks that the recorded call
    is the CLI's on the crop's files and that no kernel launches. Returns
    the output and the twin's (centers, ms) a solve call."""
    import torch
    from bcd_tpu_torch.core import monoscale
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops import solve_filter as ts

    inputs, kwargs = record["args"], record["kwargs"]
    need(all(np.array_equal(x, y) for x, y in zip(inputs[:4],
                                                  load_scene(crop_path)))
         and inputs[5] == cpu_pipeline_params(radius, b, scales)
         and kwargs["tile"] is None and kwargs["skip_stride"] == 1,
         f"{tag} the CLI's pipeline call is not the reference's")
    twin_calls = []

    def twin(cand, mask, noise, n, m, min_eigen, npx, sweeps, rows=None):
        t0 = time.perf_counter()
        field = ts.solve_filter_pm_plain(cand, mask, noise, n, m, min_eigen,
                                         npx, rows)
        torch.cuda.synchronize()
        twin_calls.append((0 if rows is None else int(rows.numel()),
                           (time.perf_counter() - t0) * 1e3))
        return field

    engine_solve = monoscale.solve_filter_pm
    _build.reset_launches()
    monoscale.solve_filter_pm = twin
    try:
        ref = record["run"](*inputs, **{
            k: v for k, v in kwargs.items()
            if k not in ("progress_callback", "stats")})
    finally:
        monoscale.solve_filter_pm = engine_solve
    need(not any(_build.LAUNCHES.values()),
         f"{tag} the reference run launched a kernel: {_build.LAUNCHES}")
    return ref, twin_calls


def big_phase(dev, card, stats, clean, scene_path, radius=13, b=R13_SEARCH,
              crop=R13_CROP):
    """Phase 17: the -w 13 path (d = 2187, the runtime-d kernel
    ``solve_filter_big``) at b = 23, each step's time printed (another
    ``radius``, ``b`` and ``crop`` rehearse it on the host at a small size,
    with the card's calls stubbed). Returns the kernels line's entry
    (max_abs_err, ms, plain_ms, bound) and the crop's launch counts."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.core.monoscale import (MonoscaleConfig,
                                              solve_filter_sweeps)
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build, bounds
    from bcd_tpu_torch.ops import solve_filter as ts

    tag, (name,) = "[17]", R13_KERNELS
    d = 3 * (2 * radius + 1) ** 2
    npx, n_off = d // 3, (2 * b + 1) ** 2
    sweeps = solve_filter_sweeps(d)
    w = ["-w", str(radius), "-b", str(b)]
    scales = ["-s", str(R13_SCALES)]
    t_step = [time.perf_counter()]

    def step_done(step):
        now = time.perf_counter()
        print(f"{tag} ({step}) in {now - t_step[0]:.1f} s", flush=True)
        t_step[0] = now

    # (a) the runtime-d kernel at compiled instances' d, forced through its
    # test-only entry: bit for bit the instance (the same pair arithmetic,
    # pivot sums and reduction order), and against the fp32 model
    err = 0.0
    for O, d0, model_sweeps in R13_SMALL:
        pm = pm_of(stack_inputs(np.random.default_rng(d0), O, d0,
                                R13_SMALL_PIXELS, dev))
        s0 = solve_filter_sweeps(d0)
        big = ts.solve_filter_pm_big(*pm, 1e-8, npx=d0 // 3, sweeps=s0)
        inst = ts.solve_filter_pm(*pm, 1e-8, npx=d0 // 3, sweeps=s0)
        big_m = big if model_sweeps == s0 else ts.solve_filter_pm_big(
            *pm, 1e-8, npx=d0 // 3, sweeps=model_sweeps)
        model = ts.solve_filter_pm_schedule(*pm, 1e-8, d0 // 3,
                                            model_sweeps)
        e_m = rmse(big_m.cpu(), model.cpu())
        print(f"{tag} synthetic d={d0} (O={O}, {R13_SMALL_PIXELS} pixels): "
              f"{name} at {s0} sweeps bitwise the compiled instance's field: "
              f"{torch.equal(big, inst)} (max abs "
              f"{float((big - inst).abs().max()):.3e}); at {model_sweeps} "
              f"vs its fp32 schedule model rms {e_m:.3e} (limit "
              f"{SMEM_MODEL_RMS:g})", flush=True)
        need(torch.equal(big, inst), f"d={d0}: {name} differs from the "
             "compiled instance")
        need(e_m < SMEM_MODEL_RMS, f"d={d0}: {name} vs its schedule model")
    step_done("a")

    # (b) d = 2187 on synthetic pixels, queued to run beside (c): at the
    # engine's sweeps against the float64 twin, two past them against the
    # model
    later = Beside(dev, "(c) to (e)")
    e_syn = compare_smem_synthetic(
        dev, sweeps, O=n_off, d=d, tag=tag, name=name,
        pixels=R13_SYNTH_PIXELS, model_sweeps=sweeps + 2,
        model_pixels=LATE_MODEL_PIXELS, beside=later)
    step_done("b, its inputs")

    # (c) bcd -w 13 -b 23 -s 2 through the CLI's entry point on the crop,
    # with (b)'s kernel calls beside it; the centers each solve call takes
    # and its time by CUDA events, read by a wrapper that calls the
    # engine's own (``solve_events``; traced until the whole run took
    # 1125 s of its 1200 on an H100: the trace took 31 s to collect and
    # sum)
    ch, cw = crop
    crop_path = crop_scene_path(scene_path, radius)
    write_scene(crop_path, *(x[:ch, :cw] for x in stats))
    out_path = crop_path.replace(".exr", "_out.exr")
    argv = ["-i", crop_path, "-o", out_path, *w, *scales]
    rcs, held = [], []
    cfg = MonoscaleConfig(patch_radius=radius, search_radius=b)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recorded_pipeline() as record, solve_events() as calls:
        t0 = time.perf_counter()
        # (b)'s calls start first, on side streams, and the counts are
        # reset after them, just before the path
        later.open()
        held.append(torch.cuda.memory_allocated())
        _build.reset_launches()
        rcs.append(cli.main(argv))
        torch.cuda.current_stream(dev).synchronize()
        cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(_build.LAUNCHES)
    need(rcs == [0], f"{' '.join(w)} CLI run")
    solved = solved_ms(calls)
    k_us = sum(ms for _, ms in solved) * 1e3
    n_c = sum(n for n, _ in solved)
    print(f"{tag} python -m bcd_tpu_torch.cli {' '.join(argv)}: rc 0, "
          f"{cli_s:.3f} s wall with EXR I/O on {card}, (b)'s calls beside "
          f"it; peak memory {peak / 2**20:.1f} MiB, {held[0] / 2**20:.1f} "
          f"MiB of it held from its start by the calls beside it, their "
          f"inputs included; {cfg.batch} tile a batch, bands "
          f"of {cfg.band} rows ({-(-cfg.tile // cfg.band)} a tile); {n_c} "
          f"centers reach the solve, in {len(solved)} of {len(calls)} solve "
          f"calls; launches of the run "
          f"{ {k: v for k, v in launches.items() if v} }; {name} "
          f"{k_us / 1e6:.4f} s by CUDA events around the engine's solve "
          f"calls that took a center (device time not traced)", flush=True)
    need(launches[name] > 0,
         f"kernel {name} was not launched by the {' '.join(w)} path")
    for other in R1_KERNELS + SOLVE_KERNELS:
        if other != name:
            need(launches[other] == 0,
                 f"the {' '.join(w)} path launched {other}")
    out = image_io.load_exr(out_path)
    clean_c = clean[:ch, :cw]
    need(out.shape == clean_c.shape and np.isfinite(out).all(),
         f"{' '.join(w)} CLI output shape / finiteness")
    e_out, e_in_c = rmse(out, clean_c), rmse(stats[0][:ch, :cw], clean_c)
    print(f"{tag} rmse vs clean on the crop: {' '.join(w)} output "
          f"{e_out:.5f}, noisy input {e_in_c:.5f}", flush=True)
    need(e_out < e_in_c, f"the {' '.join(w)} output is not closer to the "
         "clean image")
    step_done("c")

    # (d) the gate: -w 13 at b = 22 on the crop, no solve
    no_solve_run(tag, crop_path, radius, b - 1, scales, clean_c, e_in_c)
    step_done("d")

    # (e) the crop against the same pipeline on the card, on (c)'s inputs
    # and parameters, with the float64 twin in the kernel's place
    ref, twin_calls = twin_reference(tag, record, crop_path, radius, b,
                                     R13_SCALES)
    need(sum(n for n, _ in twin_calls) == n_c,
         f"the reference solved {twin_calls}, (c) {solved}")
    plain_ms = sum(ms for n, ms in twin_calls if n)
    got = record["out"]
    gap = rmse(got.cpu(), ref.cpu())
    print(f"{tag} {' '.join(w)} pipeline on the {ch}x{cw} crop: (c)'s card "
          f"output vs the same pipeline on the card with the float64 twin "
          f"in the kernel's place (the reference; the port's CPU pipeline "
          f"would take about 550 s) rmse {gap:.3e} (limit {R2_CPU_RMSE:g}), "
          f"max abs {float((got - ref).abs().max()):.3e}; the twin "
          f"{plain_ms:.3f} ms on the {n_c} centers", flush=True)
    need(gap < R2_CPU_RMSE, f"-w {radius} on the card against its reference")
    t0 = time.perf_counter()
    window_s = later.close()
    print(f"{tag} (b)'s kernel calls beside (c) to (e): {window_s:.1f} s "
          f"from their start, then their model {time.perf_counter() - t0:.1f}"
          " s", flush=True)
    step_done("e")
    bound = bounds.solve_filter(n_c, n_off, d, sweeps)
    print(f"{tag} {name} on (c)'s {n_c} centers: {k_us / 1e3:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), {k_us / 1e3 / bound[0]:.1f}x; "
          f"the twin {plain_ms:.3f} ms", flush=True)
    return (e_syn[0], k_us / 1e3, plain_ms, bound), launches


def lane_phase(dev):
    """Phase 18 (a): the lane solve_matrices on the runtime-d kernel
    (``bcd_solve_matrices_big``) at LANE_BIG's d on LANE_PIXELS synthetic
    pixels whose similar sets outnumber d + 1: driven once at the engine's
    sweeps (the launches counted), then held to the float64 twin there, to
    the fp32 model of its schedule at the sweeps phases 7, 9 and 11 hold
    solve_filter to, and to ``solve_filter_pm_big``'s field on the same
    stack; then timed at d = 147 on LANE_CENTERS synthetic centers, held to
    the twin there too. Returns ((max_abs_err, ms, plain_ms, bound),
    launches)."""
    import torch
    from bcd_tpu_torch.core.monoscale import solve_filter_sweeps
    from bcd_tpu_torch.ops import _build, bounds
    from bcd_tpu_torch.ops import solve_filter as ts

    cases = []
    for O, d, model_sweeps in LANE_BIG:
        x = stack_inputs(np.random.default_rng(d), O, d, LANE_PIXELS, dev)
        need(float(x["n"].min()) >= d + 1,
             f"[18] d={d}: a synthetic pixel has fewer than d + 1 similar "
             "candidates")
        cases.append((x, lane_moments(x), O, d, model_sweeps))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ts.solve_matrices(*mom, 1e-8, npx=d // 3,
                              sweeps=solve_filter_sweeps(d))
            for _, mom, _, d, _ in cases]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[18] (a) the lane solve_matrices at d = "
          f"{', '.join(str(c[3]) for c in cases)} on {LANE_PIXELS} pixels "
          f"each at the engine's sweeps: {time.perf_counter() - t0:.1f} s; "
          f"launches { {k: n for k, n in launches.items() if n} }",
          flush=True)
    need(launches["solve_matrices_big"] == len(cases)
         and sum(launches.values()) == len(cases),
         "the lane solve_matrices did not launch the runtime-d kernel "
         "alone, once a d")
    err = 0.0
    for (x, mom, O, d, model_sweeps), got in zip(cases, outs):
        npx, sweeps = d // 3, solve_filter_sweeps(d)
        need(all(bool(torch.isfinite(g).all()) for g in got),
             f"[18] d={d}: non-finite lane output")
        twin = ts.solve_matrices_plain(*mom, 1e-8, npx=npx)
        e_t = max(rmse(g.cpu(), r.cpu()) for g, r in zip(got, twin))
        err = max(err, max(float((g - r).abs().max())
                           for g, r in zip(got, twin)))
        field = ts.solve_filter_pm_big(*pm_of(x), 1e-8, npx,
                                       sweeps).permute(1, 2, 0)
        e_c = rmse(lane_field(got, x).cpu(), field.cpu())
        got_m = ts.solve_matrices(*mom, 1e-8, npx=npx, sweeps=model_sweeps)
        model = ts.solve_matrices_schedule(
            *(v[..., :LATE_MODEL_PIXELS] for v in mom), 1e-8, npx,
            model_sweeps)
        e_m = max(rmse(g[..., :LATE_MODEL_PIXELS].cpu(), r.cpu())
                  for g, r in zip(got_m, model))
        print(f"[18] (a) d={d} (O={O}, n >= {int(x['n'].min())}): vs the "
              f"float64 twin at {sweeps} sweeps rms {e_t:.3e} (limit "
              f"{SYNTH_RMS:g}); its filter vs solve_filter_pm_big's field "
              f"rms {e_c:.3e} (limit {LANE_CONSISTENT_RMS:g}); at "
              f"{model_sweeps} sweeps vs the fp32 model on "
              f"{LATE_MODEL_PIXELS} rms {e_m:.3e} (limit "
              f"{SMEM_MODEL_RMS:g})", flush=True)
        need(e_t < SYNTH_RMS, f"[18] d={d}: the lane form vs its twin")
        need(e_c < LANE_CONSISTENT_RMS,
             f"[18] d={d}: the lane form vs solve_filter_pm_big")
        need(e_m < SMEM_MODEL_RMS, f"[18] d={d}: the lane form vs its model")
    del cases, outs

    O, d, _ = LANE_BIG[0]
    npx, sweeps = d // 3, solve_filter_sweeps(d)
    x = stack_inputs(np.random.default_rng(LANE_CENTERS), O, d, LANE_CENTERS,
                     dev)
    mom = lane_moments(x)
    del x
    sm = lambda: ts.solve_matrices(  # noqa: E731
        *mom, 1e-8, npx=npx, sweeps=sweeps)
    got = sm()
    ms = cuda_ms(sm, 3)
    twin, plain_ms = timed_once(lambda: ts.solve_matrices_plain(
        *mom, 1e-8, npx=npx))
    rel = max(rel_rms(g, r) for g, r in zip(got, twin))
    err = max(err, max(float((g - r).abs().max()) for g, r in zip(got, twin)))
    bound = bounds.solve_matrices(LANE_CENTERS, d, sweeps)
    print(f"[18] (a) d={d} on {LANE_CENTERS} centers at {sweeps} sweeps: "
          f"{ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]}), "
          f"{ms / bound[0]:.1f}x; the twin {plain_ms:.3f} ms, rel rms "
          f"{rel:.3e} from it (limit {BATCH_REL_RMS:g})", flush=True)
    need(rel < BATCH_REL_RMS, "[18] the lane form on 2,048 centers vs its twin")
    return (err, ms, plain_ms, bound), launches


def probe_phase(dev):
    """Phase 18 (b): every variant of the probe microbenchmarks
    (``ops/probes.variants``) at its script's shapes, driven once (the
    launches counted), then measured by ``probes.measure``: held to its
    plain version (bit for bit, or within fp32 rounding) and to the float64
    reference, and timed beside its bound, its plain version and the one
    PyTorch call that computes its function. Then transpose A and D at a
    P that their 128-pixel tile does not divide (``PROBE_RAGGED_P``), one
    launch each, bit for bit their plain version and exact against
    float64, and the batched banded dot at shapes its tile does not divide
    (``BANDED_RAGGED``), one launch each, within fp32 rounding of its plain
    version and of float64. Returns ({name: (max abs err, ms, plain ms,
    bound, library ms)}, launches), the times those of a CUDA graph's
    replay."""
    import torch
    from bcd_tpu_torch.ops import _build, probe_library, probes

    vs = probes.variants(dev)
    _build.reset_launches()
    torch.cuda.synchronize()
    for v in vs:
        v.run()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[18] (b) the probe microbenchmarks, each once: launches "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    readings, lines = probes.measure(dev)
    res = {}
    for r in readings:
        need(launches[r.name] == 1, f"{r.name} did not launch once")
        res[r.name] = (r.err, *r.graph[:2], r.bound, r.graph[2])
        print(f"[18] (b) {r.line}", flush=True)
        need(r.ok, f"{r.name} against its plain version")
    for line in lines:
        print(f"[18] (b) {line}", flush=True)
    m2, expand, index = probe_library.transpose_inputs(dev)
    m2 = m2[:PROBE_RAGGED_P].contiguous()
    lanes64 = m2.double().cpu()[:, index.long().cpu()].T
    for name, back in (("probe_transpose_a", True), ("probe_transpose_d", False)):
        _build.reset_launches()
        got = probes.transpose_mma(m2, expand, back)
        torch.cuda.synchronize()
        need(_build.LAUNCHES[name] == 1 and sum(_build.LAUNCHES.values()) == 1,
             f"{name} at P = {PROBE_RAGGED_P} did not launch once, alone")
        plain = probes.transpose_plain(m2, index)[:len(got)]
        bitwise = all(torch.equal(g, q) for g, q in zip(got, plain))
        err64 = probes.max_err(got, (lanes64, lanes64.T)[:len(got)])
        print(f"[18] (b) {name} at P = {PROBE_RAGGED_P} (the 128-pixel tile "
              f"does not divide it): {'bit for bit' if bitwise else 'NOT'} "
              f"its plain version, max abs {err64:.3e} from float64",
              flush=True)
        need(bitwise and err64 == 0.0, f"{name} at P = {PROBE_RAGGED_P}")
    rng = np.random.default_rng(11)
    for n_y, t, c in BANDED_RAGGED:
        b = torch.tensor(rng.random((n_y, t, t)) < 0.5, dtype=torch.float32,
                         device=dev)
        s = torch.tensor(rng.random((n_y, t, c)), dtype=torch.float32,
                         device=dev)
        _build.reset_launches()
        got = probes.banded_dot(b, s, True)
        torch.cuda.synchronize()
        need(_build.LAUNCHES["probe_banded_batched"] == 1
             and sum(_build.LAUNCHES.values()) == 1,
             f"probe_banded_batched at {(n_y, t, c)} did not launch once, "
             "alone")
        plain = probes.banded_plain(b, s)
        limit = probe_library.FP32_REL * float(plain.abs().max())
        err = probes.max_err((got,), (plain,))
        err64 = probes.max_err((got,), (torch.bmm(b.double().cpu(),
                                                  s.double().cpu()),))
        print(f"[18] (b) probe_banded_batched at (Y, T, C) = {(n_y, t, c)} "
              f"(the 64 x 128 tile does not divide it): max abs {err:.3e} "
              f"from its plain version, {err64:.3e} from float64 (limit "
              f"{limit:.3e})", flush=True)
        need(max(err, err64) <= limit,
             f"probe_banded_batched at {(n_y, t, c)}")
    return res, launches


def bisect_phase(dev):
    """Phase 19: scripts/bisect_kernel.py's staged solve
    (``ops/bisect.py``, ``csrc/bisect.cu``) on the script's inputs: each
    stage driven once (``bisect.kernel_count`` launches under each
    ``bisect_<stage>``: M2's kernel, and from ``bd`` on the later stages';
    nothing else),
    then measured by ``bisect.measure``: bit for bit its plain version on
    the card and within ``bisect.TOLERANCE`` of its float64 run, timed in a
    CUDA graph and launched from Python beside its bound and plain version,
    and ``m2`` beside its library call (``bisect.m2_library``, an einsum of
    row 0) and the whole M2's (``bisect.m2_full_library``). Then every
    stage at the P of ``BISECT_RAGGED_P``, bit for bit. Returns
    ({"bisect_<stage>": (max abs err, ms, plain ms, bound, library ms or
    None)}, launches)."""
    import torch
    from bcd_tpu_torch.ops import _build, bisect

    inputs = bisect.bisect_inputs(dev)
    _build.reset_launches()
    torch.cuda.synchronize()
    for stage in bisect.STAGES:
        bisect.bisect(*inputs, stage)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"[19] the staged solve, each stage once: launches "
          f"{ {k: n for k, n in launches.items() if n} }", flush=True)
    counts = {f"bisect_{s}": bisect.kernel_count(i)
              for i, s in enumerate(bisect.STAGES)}
    need(all(launches[k] == n for k, n in counts.items())
         and sum(launches.values()) == sum(counts.values()),
         "the staged solve did not launch each stage's kernels once, alone")
    res = {}
    for r in bisect.measure(dev):
        print(f"[19] {r.line}", flush=True)
        need(r.ok and r.max_abs_err == 0.0,
             f"bisect_{r.stage} bit for bit its plain version, and against "
             "float64")
        res[f"bisect_{r.stage}"] = (r.max_abs_err, r.graph_ms,
                                    r.plain_graph_ms, r.bound,
                                    r.library[1] if r.library else None)
    for p in BISECT_RAGGED_P:
        x = [t[..., :p].contiguous() for t in inputs]
        bitwise = [torch.equal(bisect.bisect(*x, stage),
                               bisect.bisect_plain(*x, stage))
                   for stage in bisect.STAGES]
        print(f"[19] at P = {p}: "
              + ", ".join(f"{stage} {'bit for bit' if ok else 'NOT'}"
                          for stage, ok in zip(bisect.STAGES, bitwise))
              + " its plain version", flush=True)
        need(all(bitwise), f"the staged solve at P = {p}")
    return res, launches


def cpu_reference_worker(conn, jobs, threads) -> None:
    """The port's CPU pipeline on each (key, radius, b, scales, tile, crop)
    of ``jobs``, in order, each result sent on ``conn`` as (key, output,
    seconds, the process's peak resident memory in GiB, error)."""
    import resource
    import traceback

    import torch
    from bcd_tpu_torch.core.pipeline import denoise_pipeline

    torch.set_num_threads(threads)
    for key, radius, b, scales, tile, crop in jobs:
        t0 = time.perf_counter()
        try:
            out = denoise_pipeline(*(torch.as_tensor(x) for x in crop),
                                   torch.device("cpu"),
                                   cpu_pipeline_params(radius, b, scales),
                                   tile=tile).numpy()
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
            conn.send((key, out, time.perf_counter() - t0, peak, None))
        except Exception:  # reported where the result is read
            conn.send((key, None, 0.0, 0.0, traceback.format_exc()))
    conn.close()


def cpu_tile(k: int) -> int:
    """The core tile side of the CPU reference on a k x k crop: the
    engine's 32 where k is a multiple of it, else as small as keeps the
    number of 32-pixel tiles a side (20 at k = 40, 23 at 46 and 68, 31 at
    62). The engine builds every center of a tile, also those past the
    crop, so a 68x68 crop took 9,216 centers at its finest scale on 32x32
    tiles and takes 4,761 on 23x23; the output is the same up to the
    rounding of the overlap-add, whose order follows the tiles."""
    n = -(-k // 32)
    return -(-k // n)


class CpuReferences:
    """The crops' references, the port's CPU pipeline on phase 5's 64x64
    crop at r = 2, phase 7's at r = 3 and each wide phase's at its radius
    and b (from phase 10 on (c)'s CLI run's inputs, the crop's EXR files
    as the CLI reads them, at its scales), on ``cpu_tile`` tiles, computed
    one after another in a process
    of its own (spawned, so it never touches the card) from its start,
    beside the card's work and without the GIL of the process that drives
    the card. ``result(radius)`` waits for one; ``close()`` stops the
    process."""

    def __init__(self, stats, threads, scene_path):
        import multiprocessing
        import threading

        jobs = [(radius, radius, 6, None, cpu_tile(k),
                 [np.ascontiguousarray(x[:k, :k]) for x in stats])
                for radius, k in ((2, R2_CPU_CROP), (3, R3_CPU_CROP))]
        for radius, c in wide_phases().items():
            if c.get("reference") == "twin":  # its reference is the card's
                continue
            k = c["cpu_crop"]
            crop = [np.ascontiguousarray(x[:k, :k]) for x in stats]
            if one_crop(c):  # (c)'s CLI run's inputs and parameters
                path = crop_scene_path(scene_path, radius)
                write_scene(path, *crop)
                crop = list(load_scene(path))
            jobs.append((radius, radius, c["search"],
                         c["scales"] if one_crop(c) else None, cpu_tile(k),
                         crop))
        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe()
        self._proc = ctx.Process(target=cpu_reference_worker,
                                 args=(child, jobs, threads), daemon=True)
        self._proc.start()
        child.close()
        self._done = {}
        self._cond = threading.Condition()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self) -> None:
        while True:
            try:
                key, *rest = self._conn.recv()
            except (EOFError, OSError):
                key, rest = None, None
            with self._cond:
                self._done[key] = rest
                self._cond.notify_all()
            if key is None:
                return

    def result(self, radius):
        """(output, seconds, the process's peak resident memory in GiB so
        far) of the crop's CPU pipeline at ``radius``."""
        import torch

        with self._cond:
            self._cond.wait_for(lambda: radius in self._done
                                or None in self._done)
            got = self._done.get(radius)
        need(got is not None, f"the CPU reference process ended before "
             f"radius {radius}'s crop (exit code {self._proc.exitcode})")
        out, secs, peak, err = got
        need(err is None, f"the CPU pipeline at radius {radius}: {err}")
        return torch.from_numpy(out), secs, peak

    def close(self) -> None:
        self._proc.join(timeout=60)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join()


def batch_rule_run(card, stats, clean, scene_path) -> None:
    """``bcd -w 3 -b 33`` through the CLI's entry point on the
    BATCH_RULE_CROP crop: the engine's tiles a batch at this window (4: a
    16-tile fp32 stack would be 43.2 GB, an 8-tile one 21.6), wall time and
    peak memory. It must run and beat the noisy input."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.core.monoscale import MonoscaleConfig
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build

    ch, cw = BATCH_RULE_CROP
    crop_path = scene_path.replace(".exr", "_w3b33crop.exr")
    write_scene(crop_path, *(x[:ch, :cw] for x in stats))
    out_path = crop_path.replace(".exr", "_out.exr")
    argv = ["-i", crop_path, "-o", out_path, "-w", "3", "-b", "33"]
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, rc = time.perf_counter(), None
    try:
        rc = cli.main(argv)
    finally:  # printed also where the run raises (out of card memory)
        print(f"[11] python -m bcd_tpu_torch.cli {' '.join(argv)}: rc {rc}, "
              f"{MonoscaleConfig(patch_radius=3, search_radius=33).batch} "
              f"tiles a batch, {time.perf_counter() - t0:.3f} s wall with "
              f"EXR I/O on {card}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
              f"launches { {k: v for k, v in _build.LAUNCHES.items() if v} }",
              flush=True)
    need(rc == 0, "-w 3 -b 33 CLI run")
    out, clean_c = image_io.load_exr(out_path), clean[:ch, :cw]
    need(out.shape == clean_c.shape and np.isfinite(out).all(),
         "-w 3 -b 33 CLI output shape / finiteness")
    e_out, e_in = rmse(out, clean_c), rmse(stats[0][:ch, :cw], clean_c)
    print(f"[11] -w 3 -b 33 rmse vs clean on the crop: output {e_out:.5f}, "
          f"noisy input {e_in:.5f}", flush=True)
    need(e_out < e_in, "the -w 3 -b 33 output is not closer to the clean "
         "image")


def device_time_table(label, run, own_stream=False) -> None:
    """One traced ``run()``: wall, device busy and idle share, and the top
    device time by kernel; with ``own_stream`` of the events of the stream
    that ran the most kernels only (the run's, where other calls run
    beside it on side streams)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_stop = time.perf_counter()
    stop_s = time.perf_counter() - t_stop

    # device time by kernel name, summed over the profiler's raw events:
    # its per-event Python objects (key_averages(), events()) took 47-55 s
    # on the 280,000 kernels of a traced -w 12 crop on an H100's machine
    t1 = time.perf_counter()
    events = [ev for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA]
    if own_stream:
        per = {}
        for ev in events:
            per[ev.device_resource_id()] = per.get(
                ev.device_resource_id(), 0) + 1
        mine = max(per, key=per.get)
        events = [ev for ev in events if ev.device_resource_id() == mine]
    totals = {}
    for ev in events:
        tot = totals.setdefault(ev.name(), [0.0, 0])
        tot[0] += ev.duration_ns() / 1e3
        tot[1] += 1
    rows = sorted(((us, n, key) for key, (us, n) in totals.items()),
                  reverse=True)
    table_s = time.perf_counter() - t1
    busy = sum(r[0] for r in rows) / 1e6
    print(f"{label} traced run: wall {wall:.4f} s, device busy {busy:.4f} s"
          f"{' on its stream' if own_stream else ''} "
          f"(idle share {max(0.0, 1 - busy / wall):.3f}; the trace's "
          f"collection {stop_s:.1f} s and its table {table_s:.1f} s after "
          "the run); top device time by kernel:", flush=True)
    for us, calls, key in rows[:12]:
        print(f"    {us / 1e3:10.3f} ms  {calls:6d} calls  {key[:90]}",
              flush=True)
    return wall, busy, rows


def run_quiet(fn, *args, **kwargs):
    """(fn(...), its standard output): a CLI's prints, for parsing."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args, **kwargs)
    return rc, buf.getvalue()


def check_against_standin(label, nb, mean, cov, histo, ref):
    """The accumulator's statistics (numpy) against the float64 stand-in's
    (color, nb, histo, cov), within the ACC_* limits."""
    r_mean, r_nb, r_histo, r_cov = ref
    need(np.array_equal(nb, r_nb), f"{label}: nb not exact")
    e_mean = float(np.max(np.abs(mean - r_mean)
                          / (np.abs(r_mean) + 1e-30)))
    m0, m1, m2 = (r_mean[..., i] for i in range(3))
    scale = np.abs(r_cov) + np.abs(np.stack(
        [m0 * m0, m1 * m1, m2 * m2, m1 * m2, m0 * m2, m0 * m1], axis=-1))
    e_cov = float(np.max(np.abs(cov - r_cov) / (scale + 1e-30)))
    e_histo = float(np.max(np.abs(histo - r_histo)))
    print(f"[6] {label} vs the float64 stand-in: nb exact; mean max rel err "
          f"{e_mean:.3e} (limit {ACC_MEAN_RTOL:g}); cov max err over "
          f"|cov| + |mean_i mean_j| {e_cov:.3e} (limit {ACC_COV_REL:g}), max "
          f"abs {float(np.max(np.abs(cov - r_cov))):.3e}; histo max abs err "
          f"{e_histo:.3e} (limit {ACC_HISTO_ATOL:g})", flush=True)
    need(e_mean <= ACC_MEAN_RTOL and e_cov <= ACC_COV_REL
         and e_histo <= ACC_HISTO_ATOL, f"{label} against the stand-in")


def ingest_phase(dev, card, clean) -> None:
    """Phase 6: raw dump -> raw2bcd on the card -> bcd --stats, the API and
    the batch CLI, at 1088x1920, INGEST_SPP spp, RGBA."""
    import shutil

    import torch
    from bcd_tpu_torch import batch_cli, cli, raw2bcd_cli
    from bcd_tpu_torch.chrono import PhaseStats
    from bcd_tpu_torch.convert import to_numpy
    from bcd_tpu_torch.core.api import DenoiserInputs, MultiscaleDenoiser
    from bcd_tpu_torch.core.multiscale import denoise_multiscale
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.io import image_io, raw
    from bcd_tpu_torch.ops import _build, bounds
    from bcd_tpu_torch.ops.accumulator import SamplesAccumulator
    from bcd_tpu_torch.params import DenoiserParameters, PipelineParameters
    from make_test_scene import sample_noisy

    height, width = clean.shape[:2]
    mpix = height * width / 1e6
    work = os.path.join(WORK, "ingest")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    rgb = sample_noisy(clean, INGEST_SPP, 0)
    samples = np.concatenate(
        [rgb, np.ones(rgb.shape[:3] + (1,), np.float32)], axis=-1)
    dump = os.path.join(work, "scene.raw")
    raw.write_raw(dump, samples)
    dump_gb = os.path.getsize(dump) / 1e9
    print(f"[6] {width}x{height}, {INGEST_SPP} spp RGBA: samples and a "
          f"{dump_gb:.3f} GB raw dump in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ref = accumulate_statistics(rgb)
    print(f"[6] float64 stand-in statistics in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # raw2bcd through its entry point, in process, on the card
    prefix = os.path.join(work, "frame")
    SamplesAccumulator(1, 1, device=dev).add_samples(samples[:1, :1])
    torch.cuda.synchronize()
    st = PhaseStats()
    t0 = time.perf_counter()
    rc, log = run_quiet(raw2bcd_cli.main, [dump, prefix], stats=st)
    wall = time.perf_counter() - t0
    need(rc == 0, f"raw2bcd: rc {rc}\n{log}")
    tm = st.timers
    print(f"[6] python -m bcd_tpu_torch.raw2bcd_cli (in process) on {card}: "
          f"{wall:.3f} s wall = dump read {tm['dump read']:.3f} s + "
          f"accumulate {tm['accumulate']:.3f} s (device, by CUDA events, "
          f"{tm['accumulate, device']:.4f} s, uploads included) + EXR write "
          f"{tm['EXR write']:.3f} s; {mpix / wall:.3f} MPix/s, "
          f"{dump_gb / wall:.3f} GB/s of dump", flush=True)
    histo_f, nb_f = image_io.separate_nb_of_samples_from_histogram(
        image_io.load_multi_channels_exr(prefix + "_hist.exr"))
    cov_f = image_io.load_multi_channels_exr(prefix + "_cov.exr")
    color_f = image_io.load_exr(prefix + ".exr")
    half = float(np.max(np.abs(color_f - ref[0]) / (np.abs(ref[0]) + 1e-30)))
    need(half <= 2 ** -10, "raw2bcd color file beyond half precision")

    # the accumulator twice on the card (row blocks of 64 already on the
    # device, so the events time the device work alone), against the
    # stand-in and the raw2bcd files
    dev_samples = torch.as_tensor(samples, device=dev)
    runs, ms = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        acc = SamplesAccumulator(height, width, device=dev)
        for row0 in range(0, height, raw2bcd_cli.ROWS_PER_BLOCK):
            acc.add_samples(
                dev_samples[row0 : row0 + raw2bcd_cli.ROWS_PER_BLOCK],
                row0=row0)
        runs.append(acc.extract_samples_statistics())
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    del dev_samples
    need(all(torch.equal(a, b) for a, b in zip(*runs)),
         "accumulator not bitwise repeatable on the card")
    nb, mean, cov, histo = (to_numpy(x) for x in runs[0])
    bound = bounds.accumulate(height * width, INGEST_SPP, 20)
    print(f"[6] accumulator on device-resident row blocks: {ms[0]:.3f} / "
          f"{ms[1]:.3f} ms (CUDA events), bitwise repeatable; bound "
          f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
    check_against_standin("accumulator", nb, mean, cov, histo, ref)
    need(np.array_equal(nb_f, nb) and np.array_equal(histo_f, histo)
         and np.array_equal(cov_f, cov),
         "raw2bcd's files differ from the accumulator on device blocks")
    print(f"[6] raw2bcd's hist and cov files bitwise the accumulator's; color "
          f"file within half precision (max rel err {half:.3e})", flush=True)
    del samples, rgb

    # bcd --stats on the EXRs; the batch CLI below runs the same frame
    # without it (a plain bcd run here too until the whole run took 1125 s
    # of its 1200 on an H100: 10.121 s)
    out_stats = prefix + "_out_stats.exr"
    argv = ["-i", prefix + ".exr", "-p", "1", "-s", "3", "-o", out_stats,
            "--stats"]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, log_stats = run_quiet(cli.main, argv)
    wall_stats = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    need(rc == 0, f"bcd --stats: rc {rc}\n{log_stats}")
    for name in R1_KERNELS:
        need(launches[name] > 0, f"bcd --stats did not launch {name}")
    with_stats = image_io.load_exr(out_stats)
    counters = dict(line.rsplit(": ", 1) for line in log_stats.splitlines()
                    if line.startswith("pixels: "))
    main_n, fb_n, managed = (int(counters[f"pixels: {k}"]) for k in (
        "main-path solves", "fallback (mean patch)", "managed"))
    interior = sum((height // 2 ** s - 2) * (width // 2 ** s - 2)
                   for s in range(3))
    print(f"[6] bcd --stats (-p 1 -s 3): {wall_stats:.3f} s wall, launches "
          f"{launches}; pixels: main-path {main_n}, fallback {fb_n}, "
          f"managed {managed} (interior of the 3 scales {interior}); "
          f"main-path share {main_n / managed:.4f}", flush=True)
    print("\n".join("    " + line for line in log_stats.splitlines()
                    if line.startswith(("pixels", "Chronometers", "  "))),
          flush=True)
    need(main_n + fb_n == managed == interior, "--stats counters")
    e_out, e_in = rmse(with_stats, clean), rmse(color_f, clean)
    print(f"[6] rmse vs clean: output {e_out:.5f}, noisy input {e_in:.5f}",
          flush=True)
    need(e_out < e_in, "the 16 spp output is not closer to the clean image")

    # the stats overhead in memory: plain, stats, stats, plain
    stats_dev = [torch.as_tensor(x, device=dev) for x in (mean, nb, histo,
                                                          cov)]
    pipeline = PipelineParameters()
    times = {"plain": [], "stats": []}
    for kind in ("plain", "stats", "stats", "plain"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        denoise_pipeline(*stats_dev, dev, pipeline,
                         stats=PhaseStats() if kind == "stats" else None)
        torch.cuda.synchronize()
        times[kind].append(time.perf_counter() - t0)
    print(f"[6] denoise_pipeline 1088x1920 in memory, in turns plain, "
          f"stats, stats, plain: plain {['%.4f' % x for x in times['plain']]}"
          f" s, with stats {['%.4f' % x for x in times['stats']]} s",
          flush=True)

    # the in-memory API on the accumulator's statistics
    mean_t, nb_t, histo_t, cov_t = (runs[0][1], runs[0][0], runs[0][3],
                                    runs[0][2])
    ref_api = to_numpy(denoise_multiscale(mean_t, nb_t, histo_t, cov_t,
                                          DenoiserParameters(), dev,
                                          nb_of_scales=3))
    den = MultiscaleDenoiser(nb_of_scales=3, device=dev)
    den.set_inputs(DenoiserInputs(mean_t, nb_t, histo_t, cov_t))
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    need(den.denoise(), "MultiscaleDenoiser.denoise refused its inputs")
    api_s = time.perf_counter() - t0
    api_launches = dict(_build.LAUNCHES)
    got = den.get_outputs().denoised_colors
    need(got.dtype == np.float32 and np.array_equal(got, ref_api),
         "MultiscaleDenoiser differs from denoise_multiscale")
    for name in R1_KERNELS:
        need(api_launches[name] > 0, f"the API did not launch {name}")
    print(f"[6] MultiscaleDenoiser(3) on the accumulator's tensors: "
          f"{api_s:.4f} s a frame (download included), bitwise "
          f"denoise_multiscale's; launches {api_launches}", flush=True)
    del runs, stats_dev, mean_t, nb_t, histo_t, cov_t

    # the batch CLI: two copies of the frame and one without its _cov file
    frames = []
    for name, suffixes in (("a", ("", "_hist", "_cov")),
                           ("b", ("", "_hist", "_cov")),
                           ("broken", ("", "_hist"))):
        for suffix in suffixes:
            os.link(prefix + suffix + ".exr",
                    os.path.join(work, name + suffix + ".exr"))
        frames.append(os.path.join(work, name + ".exr"))
    preset = os.path.join(work, "preset.bcd.json")
    with open(preset, "w") as f:
        json.dump({"nbOfScales": 3, "performSpikeRemovalPrefiltering": True,
                   "searchWindowRadius": 6, "patchRadius": 1}, f)
    outdir = os.path.join(work, "batch")
    argv = frames + ["-a", preset, "-o", outdir]
    _build.reset_launches()
    t0 = time.perf_counter()
    rc, log = run_quiet(batch_cli.main, argv)
    batch_s = time.perf_counter() - t0
    need(rc == 1 and "2/3 frames" in log,
         f"batch CLI: rc {rc}, expected 1 with 2/3 frames\n{log}")
    need(dict(_build.LAUNCHES) == {k: 2 * v for k, v in launches.items()},
         f"the batch CLI's launches {_build.LAUNCHES} are not twice bcd "
         f"--stats' {launches}")
    # a frame without --stats: bit for bit the --stats run's output
    for name in ("a", "b"):
        out = image_io.load_exr(os.path.join(outdir,
                                             name + "_BCDfiltered.exr"))
        need(np.array_equal(out, with_stats),
             f"batch frame {name} differs from the CLI run")
    rc, log2 = run_quiet(batch_cli.main, argv + ["--resume"])
    need(rc == 1 and "resume: skipping 2 already-denoised frames" in log2
         and "0/1 frames" in log2, f"batch --resume\n{log2}")
    print(f"[6] batch CLI, 2 frames + 1 broken: rc 1, "
          f"{log.strip().splitlines()[-1]!r} ({batch_s / 2:.3f} s a frame "
          f"with EXR I/O), twice bcd --stats' launches, outputs bitwise "
          f"its output (--stats changes neither); --resume skipped both",
          flush=True)
    shutil.rmtree(work)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_crop(height, width, radius=5) -> int:
    """One timed ``bcd -w r -b b --stats`` run (phase 8's to 16's radius r
    and its search radius b) through the CLI's entry point on the
    scene's top-left height x width crop, the kernels built first: wall
    time with EXR I/O, launches, peak memory, rmse vs clean."""
    import torch
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.ops import _build

    search = {**{r: c["search"] for r, c in wide_phases().items()},
              13: R13_SEARCH}[radius]
    card = card_line()
    _build.library()
    clean, stats = full_scene()
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"timed_w{radius}b{search}_{height}x{width}.exr")
    write_scene(path, *(x[:height, :width] for x in stats))
    out_path = path.replace(".exr", "_out.exr")
    argv = ["-i", path, "-o", out_path, "-w", str(radius), "-b", str(search),
            "--stats"]
    _build.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    need(rc == 0, f"bcd {' '.join(argv)}")
    out = image_io.load_exr(out_path)
    clean = clean[:height, :width]
    need(out.shape == clean.shape and np.isfinite(out).all(),
         "output shape / finiteness")
    print(f"[time-crop] python -m bcd_tpu_torch.cli {' '.join(argv)}: rc 0, "
          f"{wall:.3f} s wall with EXR I/O on {card}; launches "
          f"{dict(_build.LAUNCHES)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; rmse vs "
          f"clean {rmse(out, clean):.6f}, noisy input "
          f"{rmse(stats[0][:height, :width], clean):.6f}", flush=True)
    print(card, flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs the card")
    need(os.path.isdir(os.path.join(HERE, "bcd_tpu_torch")),
         "bcd_tpu_torch/ is not beside this script: run it from a checkout "
         "of the repo")
    sys.path.insert(0, HERE)
    from bcd_tpu_torch import cli
    from bcd_tpu_torch.io import image_io
    from bcd_tpu_torch.params import DenoiserParameters, PipelineParameters
    from bcd_tpu_torch.core.monoscale import MonoscaleConfig, denoise_monoscale
    from bcd_tpu_torch.core.multiscale import denoise_multiscale
    from bcd_tpu_torch.core.pipeline import denoise_pipeline
    from bcd_tpu_torch.ops import _build
    from bcd_tpu_torch.ops.spike_removal import spike_removal
    from bcd_tpu_torch.ops.solve_filter import (
        D, solve_matrices_pm, solve_matrices_pm_plain,
        solve_matrices_pm_schedule)

    params = DenoiserParameters(search_window_radius=6)
    cfg = MonoscaleConfig()

    if sys.argv[1:2] == ["--time-crop"]:
        need(len(sys.argv) == 4 or (len(sys.argv) == 6
                                    and sys.argv[4] == "--radius"
                                    and sys.argv[5] in ("4", "5", "6", "7",
                                                        "8", "9", "10",
                                                        "11", "12", "13")),
             "usage: chip_smoke.py --time-crop H W "
             "[--radius 4|5|6|7|8|9|10|11|12|13]")
        return time_crop(int(sys.argv[2]), int(sys.argv[3]),
                         int(sys.argv[5]) if len(sys.argv) == 6 else 5)

    # --- 1. the card and the build --------------------------------------
    dev = torch.device("cuda", 0)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    card = card_line()
    print(f"[1] device: {kind}, count {count}; card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    # the build's nvcc processes run while this thread makes the scene, its
    # statistics and its EXR files (host work that needs no kernel)
    with ThreadPoolExecutor(1) as pool:
        build = pool.submit(_build.build_log)
        clean, stats = full_scene()
        print(f"[1] beside the build: the 1088x1920 scene, 4 spp, statistics "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        t1 = time.perf_counter()
        os.makedirs(WORK, exist_ok=True)
        paths = {k: os.path.join(WORK, f"scene{k}.exr")
                 for k in ("", "_hist", "_cov", "_out")}
        write_scene(paths[""], *stats)
        print(f"[1] beside the build: wrote the scene's EXRs in "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        log = build.result()
    print(f"[1] kernels built for sm_90a in {time.perf_counter() - t0:.1f} s "
          "(nvcc -Xptxas -v):", flush=True)
    for line in log.splitlines():
        if ("Compiling entry" in line or "Used" in line or "spill" in line
                or line.startswith("nvcc ")):
            print("    " + line.strip(), flush=True)
    # K2's Jacobi, the transpose's wgmma accumulator, the banded dot's mma
    # accumulators and the staged solve's sums live in registers
    for name, instances in (("solve_matrices_pm_kernel", 1),
                            ("transpose_wgmma_kernel", 4),
                            ("banded_mma_kernel", 2), ("bisect", 3)):
        report = _build.ptxas_report(log, name)
        need(len(report) == instances, f"no -Xptxas -v report for {name}")
        for entry, (regs, stack, stores, loads) in report.items():
            print(f"[1] {entry}: {regs} registers; stack frame, spill "
                  f"stores, spill loads = {[stack, stores, loads]} bytes",
                  flush=True)
            need(stores == loads == 0, f"{entry} spills registers")

    kernels = {}

    # --- 2. kernels vs twins ---------------------------------------------
    t_phase = time.perf_counter()
    rng = np.random.default_rng(99)
    m2, misc = (x.to(dev) for x in synthetic_moments(rng))
    a2t, small = solve_matrices_pm(m2, misc, 1e-8, sweeps=6)
    a2t_p, small_p = solve_matrices_pm_plain(m2, misc, 1e-8)
    e = max(rmse(a2t.cpu(), a2t_p.cpu()),
            rmse(small[:, :D].cpu(), small_p[:, :D].cpu()))
    print(f"[2] K2 sweeps=6 on synthetic moments vs float64 twin: rms "
          f"{e:.3e} (limit 2e-4)", flush=True)
    need(e < 2e-4, "K2 synthetic rms")
    a2t, small = solve_matrices_pm(m2, misc, 1e-8, sweeps=cfg.solve_sweeps)
    a2t_m, small_m = solve_matrices_pm_schedule(m2, misc, 1e-8,
                                                cfg.solve_sweeps)
    e = max(rmse(a2t.cpu(), a2t_m.cpu()), rmse(small.cpu(), small_m.cpu()))
    print(f"[2] K2 sweeps={cfg.solve_sweeps} on synthetic moments vs the fp32 "
          f"model of its schedule: rms {e:.3e} (limit {K2_MODEL_RMS:g})",
          flush=True)
    need(e < K2_MODEL_RMS and torch.equal(small[:, D], small_m[:, D]),
         "K2 against its schedule model")

    color, nb, histo, cov, gold_mono, gold_multi = load_golden()
    res_g = compare_kernels(
        "golden", tile_batch_inputs(cfg, color, nb, histo, cov, dev),
        params, cfg, reps=10)
    res_f = compare_kernels(
        "full-size", tile_batch_inputs(cfg, *stats, dev, batch=8),
        params, cfg, reps=5)
    for k in ("K1", "K2", "K4"):
        kernels[k] = (max(res_g[k][0], res_f[k][0]),) + res_f[k][1:]

    # solve_filter and the lane solve_matrices: synthetic, then one real
    # 16-tile batch of the -w 2 run's finest scale (after the prefilter)
    e_syn = compare_solve_synthetic(dev)
    thr = params.histogram_distance_threshold
    pre = spike_removal(*(torch.as_tensor(a, device=dev) for a in stats),
                        PipelineParameters().prefiltering
                        .spike_removal_threshold_stdev_factor)
    frac2 = r2_main_fraction(pre, dev, thr)
    print(f"[2] 1088x1920 finest scale at r=2, b=6, threshold {thr:g}: "
          f"main-path fraction {frac2:.4f}", flush=True)
    res_s = compare_solve_batch("full-size r=2 batch 8", *r2_batch(
        pre, dev, thr), reps=3)
    if frac2 < 0.1:  # too few main-path centers: also where there are more
        res_hi = compare_solve_batch("full-size r=2 batch 8 at threshold 4",
                                     *r2_batch(pre, dev, 4.0), reps=3)
        res_s = {k: (max(res_s[k][0], res_hi[k][0]),) + res_s[k][1:]
                 for k in res_s}
    for k in res_s:
        kernels[k] = (max(res_s[k][0], e_syn),) + res_s[k][1:]
    del pre  # 585 MB of r = 2 inputs: not part of the -w 1 peak below
    print(f"[2] phase 2 in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # --- 3. goldens on the card ------------------------------------------
    t_phase = time.perf_counter()
    for tile in (16, 32):
        out = denoise_monoscale(color, nb, histo, cov, params, dev, tile=tile)
        e_mono = rmse(out.cpu(), gold_mono)
        out = denoise_multiscale(color, nb, histo, cov, params, dev,
                                 nb_of_scales=2, tile=tile)
        e_multi = rmse(out.cpu(), gold_multi)
        print(f"[3] goldens (tile {tile}): out_mono_b6 rmse {e_mono:.3e}, "
              f"out_multi2_b6 rmse {e_multi:.3e} (limit 1e-4)", flush=True)
        need(e_mono < 1e-4 and e_multi < 1e-4, "golden rmse")
    frac = main_path_fraction(cfg, color, nb, histo, cov, params, dev)
    print(f"[3] golden main-path fraction (gate sum / managed pixels): "
          f"{frac:.4f}", flush=True)
    need(frac > 0.1, "the golden scene barely reaches the main path")
    print(f"[3] phase 3 in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # --- 4. the default bcd run through the CLI entry point --------------
    t_phase = time.perf_counter()
    s_color = stats[0]
    argv = ["-i", paths[""], "-o", paths["_out"]]
    # no warm-up CLI run: phases 2 and 3 have loaded the kernels and
    # PyTorch's libraries (a warm-up run took 8.279 s, the run after it
    # 8.530 s, on an H100's machine)
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    cli_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    need(rc == 0, "CLI run")
    print(f"[4] python -m bcd_tpu_torch.cli {' '.join(argv)}: rc {rc}, "
          f"{cli_s:.3f} s wall with EXR I/O; launches {launches}", flush=True)
    for name in R1_KERNELS:
        need(launches[name] > 0,
             f"kernel {name} was not launched by the -w 1 path")
    out = image_io.load_exr(paths["_out"])
    need(out.shape == clean.shape and np.isfinite(out).all(),
         "CLI output shape / finiteness")
    e_out, e_in = rmse(out, clean), rmse(s_color, clean)
    print(f"[4] rmse vs clean: output {e_out:.5f}, noisy input {e_in:.5f}",
          flush=True)
    need(e_out < e_in, "the denoised output is not closer to the clean image")

    pipeline = PipelineParameters()
    dev_stats = [torch.as_tensor(x, device=dev) for x in stats]
    denoise_pipeline(*dev_stats, dev, pipeline)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        denoise_pipeline(*dev_stats, dev, pipeline)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    mpix = clean.shape[0] * clean.shape[1] / 1e6
    frac = main_path_fraction(cfg, *stats, params, dev)
    print(f"[4] denoise_pipeline 1088x1920 -p 1 -s 3 b=6 r=1 on {card}: "
          f"times {['%.4f' % x for x in times]} s, median "
          f"{sorted(times)[1]:.4f} s = {mpix / sorted(times)[1]:.4f} MPix/s; "
          f"peak memory {peak / 2**20:.1f} MiB; finest-scale main-path "
          f"fraction {frac:.4f}", flush=True)

    # the 4-sweep K2 end to end: the same pipeline with K2's float64 twin
    # in its place, held to the goldens' bound
    from bcd_tpu_torch.core import fused as core_fused

    out_k2 = denoise_pipeline(*dev_stats, dev, pipeline)
    core_fused.solve_matrices_pm = (
        lambda m2, misc, eps, sweeps: solve_matrices_pm_plain(m2, misc, eps))
    try:
        out_twin = denoise_pipeline(*dev_stats, dev, pipeline)
    finally:
        core_fused.solve_matrices_pm = solve_matrices_pm
    gap = rmse(out_k2.cpu(), out_twin.cpu())
    print(f"[4] denoise_pipeline 1088x1920 with K2 vs with its float64 twin: "
          f"rmse {gap:.3e} (limit {E2E_K2_RMSE:g}), max abs "
          f"{float((out_k2 - out_twin).abs().max()):.3e}; rmse vs clean "
          f"{rmse(out_k2.cpu(), clean):.6f} (K2) and "
          f"{rmse(out_twin.cpu(), clean):.6f} (twin)", flush=True)
    need(gap < E2E_K2_RMSE, "K2 against its twin end to end")

    device_time_table("[4]", lambda: denoise_pipeline(*dev_stats, dev,
                                                      pipeline))

    print(f"[4] phase 4 in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # --- 5. the -w 2 path ---------------------------------------------------
    # from here the crops' CPU references (phases 5, 7 and 8 to 14) are
    # computed in a process of its own, beside the card's work; this
    # process keeps two cores for the host side of its phases
    t_phase = time.perf_counter()
    cpu_refs = CpuReferences(stats, max(1, (os.cpu_count() or 8) - 2),
                             paths[""])
    torch.set_num_threads(2)
    argv2 = argv[:2] + [paths["_out"].replace("_out", "_out_w2"), "-w", "2"]
    argv2[2:2] = ["-o"]
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = cli.main(argv2)
    cli2_s = time.perf_counter() - t0
    launches2 = dict(_build.LAUNCHES)
    need(rc == 0, "-w 2 CLI run")
    print(f"[5] python -m bcd_tpu_torch.cli {' '.join(argv2)}: rc {rc}, "
          f"{cli2_s:.3f} s wall with EXR I/O; launches {launches2}",
          flush=True)
    for name in R2_KERNELS:
        need(launches2[name] > 0,
             f"kernel {name} was not launched by the -w 2 path")
    out2 = image_io.load_exr(argv2[3])
    need(out2.shape == clean.shape and np.isfinite(out2).all(),
         "-w 2 CLI output shape / finiteness")
    e_out2 = rmse(out2, clean)
    print(f"[5] rmse vs clean: -w 2 output {e_out2:.5f}, -w 1 output "
          f"{e_out:.5f}, noisy input {e_in:.5f}; finest-scale main-path "
          f"fraction {frac2:.4f}", flush=True)
    need(e_out2 < e_in, "the -w 2 output is not closer to the clean image")

    p2 = PipelineParameters()
    p2.denoiser.monoscale.patch_radius = 2
    crop = [x[:R2_CPU_CROP, :R2_CPU_CROP].contiguous() for x in dev_stats]
    denoise_pipeline(*crop, dev, p2)  # warm-up on a small crop
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one timed call (two until the whole run took 1125 s of its 1200 on
    # an H100: 10.7729 and 10.7429 s), repeated bit for bit by the traced
    # run
    outs = []
    t0 = time.perf_counter()
    outs.append(denoise_pipeline(*dev_stats, dev, p2))
    torch.cuda.synchronize()
    time2 = time.perf_counter() - t0
    peak2 = torch.cuda.max_memory_allocated()
    device_time_table("[5]", lambda: outs.append(
        denoise_pipeline(*dev_stats, dev, p2)))
    need(torch.equal(outs[0], outs[1]), "-w 2 pipeline not bitwise repeatable")
    print(f"[5] denoise_pipeline 1088x1920 -p 1 -s 3 b=6 r=2 on {card}: "
          f"{time2:.4f} s, {mpix / time2:.4f} MPix/s; peak memory "
          f"{peak2 / 2**20:.1f} MiB; the traced run's output bit for bit "
          "the timed one's", flush=True)

    got = denoise_pipeline(*crop, dev, p2)
    need(torch.equal(got, denoise_pipeline(*crop, dev, p2)),
         "-w 2 crop not bitwise repeatable")
    ref, cpu_s, _ = cpu_refs.result(2)
    gap = rmse(got.cpu(), ref)
    print(f"[5] -w 2 pipeline on a {R2_CPU_CROP}x{R2_CPU_CROP} crop (b=6): "
          f"card vs the port's CPU "
          f"pipeline (float64 twins, {cpu_s:.1f} s) rmse {gap:.3e} (limit "
          f"{R2_CPU_RMSE:g}), max abs "
          f"{float((got.cpu() - ref).abs().max()):.3e}; bitwise repeatable "
          "on the card", flush=True)
    need(gap < R2_CPU_RMSE, "-w 2 on the card against the CPU pipeline")
    del dev_stats, crop, outs, got
    print(f"[5] phase 5 in {time.perf_counter() - t_phase:.1f} s", flush=True)

    # --- 6. ingest and the renderer surface --------------------------------
    t0 = time.perf_counter()
    ingest_phase(dev, card, clean)
    print(f"[6] phase 6 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 7. the -w 3 path ---------------------------------------------------
    t0 = time.perf_counter()
    kernels["solve_filter_147"], launches3 = r3_phase(
        dev, card, stats, clean, paths[""], cpu_refs)
    print(f"[7] phase 7 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 8 to 16. the -w 4 to -w 12 paths, and the batch rule after -w 7 ---
    wide_launches = {}
    for radius, c in wide_phases().items():
        t0 = time.perf_counter()
        (name,) = c["kernels"]
        kernels[f"solve_filter_{3 * (2 * radius + 1) ** 2}"], \
            wide_launches[name] = wide_phase(radius, dev, card, stats, clean,
                                             paths[""], cpu_refs)
        if radius == 7:
            batch_rule_run(card, stats, clean, paths[""])
        print(f"{c['tag']} phase {radius + 4} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    cpu_refs.close()

    # --- 17. the -w 13 path, the runtime-d kernel ---------------------------
    t0 = time.perf_counter()
    kernels["solve_filter_2187"], launches13 = big_phase(
        dev, card, stats, clean, paths[""])
    print(f"[17] phase 17 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 18. the lane solve_matrices at d >= 147, the probes ----------------
    t0 = time.perf_counter()
    kernels["solve_matrices_big"], launches18 = lane_phase(dev)
    probe_res, launches18b = probe_phase(dev)
    kernels.update(probe_res)
    print(f"[18] phase 18 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- 19. scripts/bisect_kernel.py's staged solve ------------------------
    t0 = time.perf_counter()
    bisect_res, launches19 = bisect_phase(dev)
    kernels.update(bisect_res)
    print(f"[19] phase 19 in {time.perf_counter() - t0:.1f} s", flush=True)

    # --- results ------------------------------------------------------------
    meta = {
        "K1": ("masks_moments", "bcd_tpu_torch/csrc/masks_moments.cu",
               "bcd_tpu/ops/fused_pallas.py:429"),
        "K2": ("solve_matrices_pm", "bcd_tpu_torch/csrc/solve_matrices_pm.cu",
               "bcd_tpu/ops/solve_filter_pallas.py:751"),
        "K4": ("apply_scatter", "bcd_tpu_torch/csrc/apply_scatter.cu",
               "bcd_tpu/ops/fused_pallas.py:694"),
        "solve_filter": ("solve_filter", "bcd_tpu_torch/csrc/solve_filter.cu",
                         "bcd_tpu/ops/solve_filter_pallas.py:441"),
        # the lane form is on no path of the engine (JAX's neither); its
        # launch count is that of the -w 2 run, 0
        "solve_matrices": ("solve_matrices",
                           "bcd_tpu_torch/csrc/solve_filter.cu",
                           "bcd_tpu/ops/solve_filter_pallas.py:594"),
        "solve_filter_147": ("solve_filter_smem",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_243": ("solve_filter_243",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_363": ("solve_filter_363",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_507": ("solve_filter_507",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_675": ("solve_filter_675",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_867": ("solve_filter_867",
                             "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                             "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_1083": ("solve_filter_1083",
                              "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                              "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_1323": ("solve_filter_1323",
                              "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                              "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_1587": ("solve_filter_1587",
                              "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                              "bcd_tpu/ops/solve_filter_pallas.py:441"),
        "solve_filter_1875": ("solve_filter_1875",
                              "bcd_tpu_torch/csrc/solve_filter_smem.cu",
                              "bcd_tpu/ops/solve_filter_pallas.py:441"),
        # every d from 2187 on; its numbers are phase 17's crop's
        "solve_filter_2187": ("solve_filter_big",
                              "bcd_tpu_torch/csrc/solve_filter_big.cu",
                              "bcd_tpu/ops/solve_filter_pallas.py:441"),
        # the lane form at every d but 27 and 75 (phase 18 (a))
        "solve_matrices_big": ("solve_matrices_big",
                               "bcd_tpu_torch/csrc/solve_filter_big.cu",
                               "bcd_tpu/ops/solve_filter_pallas.py:594"),
        # the probes' microbenchmarks (phase 18 (b))
        **{name: (name, "bcd_tpu_torch/csrc/probes.cu", PROBE_SCRIPTS[
            name.split("_")[1]]) for name in probe_res},
        # the staged solve, one row a stage (phase 19)
        **{name: (name, "bcd_tpu_torch/csrc/bisect.cu",
                  "scripts/bisect_kernel.py:142") for name in bisect_res},
    }
    runs = {**launches, "solve_filter": launches2["solve_filter"],
            "solve_matrices": launches2["solve_matrices"],
            "solve_filter_smem": launches3["solve_filter_smem"],
            **{name: counts[name] for name, counts in wide_launches.items()},
            "solve_filter_big": launches13["solve_filter_big"],
            "solve_matrices_big": launches18["solve_matrices_big"],
            **{name: launches18b[name] for name in probe_res},
            **{name: launches19[name] for name in bisect_res}}
    print(json.dumps({"kernels": [
        {"name": k if k == meta[k][0] else f"{k} {meta[k][0]}",
         "route": "cuda", "source": meta[k][1], "replaces": meta[k][2],
         "launches": runs[meta[k][0]], "max_abs_err": kernels[k][0],
         "ms": kernels[k][1], "plain_ms": kernels[k][2],
         "bound_ms": kernels[k][3][0], "bound_by": kernels[k][3][1],
         # one PyTorch call computes only some probes' functions and the
         # staged solve's m2 stage; none computes the other kernels'
         # (PERF.md), nor a later stage of the staged solve
         "library_ms": kernels[k][4] if len(kernels[k]) > 4 else None}
        for k in meta]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
