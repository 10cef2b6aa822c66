#!/usr/bin/env python3
r"""Smoke run of the PyTorch port on one CUDA card: build, check, serve,
score, train, the two-qubit serving, training and per-gate paths, the
single-qubit variants, GRAPE, polish and dCRAB, the mesh, the runner, the
figures' numbers, then time.

    python3 chip_smoke.py

Twenty-three phases, each printing its own line with its seconds:

1. device: the card, torch and CUDA versions, ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` call per source, started together
   (``ops/csrc/propagate_su2.cu``: B1, B2, B3; ``propagate_su4.cu``: B4,
   B6, B7; ``propagate_su4_bwd.cu``: B5, B8), with ptxas' registers and
   spills per kernel;
3. check: kernels B1 (mean fidelity), B3 (per-sample product) and B2 (the
   VJP of B3) against their plain PyTorch versions on the card, P ∈ {2, 3,
   4}, L ∈ {1, 7, 100}, M ∈ {1000, 2¹⁶}, at L = 100 also against the
   plain version in f64 beside the plain f32 version's own error, plus B2
   at L = 400 and L = 1000 (its shared-memory opt-in), P = 4; and the full
   gradient of B1 (its backward runs B3 and B2) against autograd through
   its plain version;
4. check-su4: kernels B7 (SU(4) per-sample product) and B6 (SU(4) mean
   fidelity) against their plain versions, P ∈ {2, 3, 4 (drive2)},
   L ∈ {1, 7, 100}, M ∈ {200, 2¹⁴} (B7's plans K = 1, 4 and 16 chunks a
   sample); at L = 100 also against the plain version in f64;
5. check-su4-train: kernels B4 (B6 with each sample's product), B5 (the
   product-seeded reverse sweep) and B8 (the sweep that forms the product
   itself) against their plain versions, B5 and B8 under a non-uniform
   per-target cotangent, P ∈ {2, 3, 4}, L ∈ {3, 7, 100}, M ∈ {1, 200,
   1000}; B8 also against B5 seeded by B4 on the same inputs;
6. serve: the ``length_100`` flagship (d512 × 8 layers, 16 heads, L = 100,
   P = 2) from its shipped ``.npz``, in bf16 (as the JAX demo serves) and
   f32, for the 5 named gates plus 3 random targets;
7. score: E[F] of those pulse tables through B1 at σ_δ = 1.0, ε_std = 0.05,
   M = 2²⁰ per target, and ``mc_fidelity_estimate`` through B3 on X(π),
   held against the flagship's published X(π) E[F] of 0.9502;
8. train: the training CLI (``workloads/universal_single_qubit.py``) at the
   flagship's full width with ``--backend pallas``, batch 200, M = 1000,
   two epochs of 5 steps in each of the three curriculum bands; then one
   step's gradient through ``pallas`` against ``xla`` from the same
   weights and draws, and ms per train step;
9. serve-su4: the two-qubit flagship ``two_qubit_d2_kak`` (d512 × 8 layers,
   16 heads, L = 100, drive2 P = 4, KAK tokens) from its shipped ``.npz``
   in f32, best-of-ℤ₄ serving of the 5 named gates (20 model inputs; the
   choice scored by B6), card pulses held against CPU pulses;
10. score-su4: ``workloads/two_qubit_eval.py::eval_pulse_tables`` through
    B6 at σ_δ ∈ {0, 0.1, 0.2}, M = 20 000, ε_std = 0.05, held against the
    JAX package's CPU table; then ``analysis/plots_su4.py``'s E[F](σ_δ)
    sweep (20 σ × 2000) and F(δ₁, δ₂) grid (61²) of CZ through B7, each
    against its plain version on the card;
11. train-su4: the two-qubit training CLI (``workloads/two_qubit.py``) on
    the flagship's recipe at full width with ``--backend pallas`` (batch
    32, M = 1024, σ_δ = 0.2, warm-started from ``two_qubit_d2_kak.npz``),
    2 epochs of 2 steps, its eval E[F] held above 0.85; then one step's
    gradient through ``pallas`` against ``xla`` at that width and M, ms per
    step of each, and a profile of pallas steps;
12. grape-su4: the two-qubit GRAPE CLI (``workloads/two_qubit_grape.py``):
    CZ on the drive2 system, blocks mode, 10 blocks, 24 starts, σ
    curriculum 0.1, 0.2 at M = 128, the steps per stage cut to
    ``GRAPE_STEPS``; stage 0's best exact F held at ≥ 0.99, its robustness
    curve (M = 4096) through B7; ms per GRAPE step and its profile;
13. polish-su4: the per-gate finetune CLI
    (``workloads/finetune_two_qubit_gates.py``) at full width: the
    flagship's best-of-ℤ₄ tables of the 5 named gates polished through B4
    and B5 (σ mix 0, 0.1, 0.2, M = 4096, lr 3e-3, the JAX CLI's 1500
    steps), blocks GRAPE candidates (steps cut), the candidates
    scored through B6 at M = 20 000, σ ∈ {0, 0.1, 0.2, 0.3}; each gate's
    chosen table held no worse than the model's, the bundle read back;
    ms per polish step and its profile;
14. serve-su4-variants: the shipped ``two_qubit_gates.npz`` bundle's five
    L = 40 tables scored through B6 (σ ∈ {0, 0.1, 0.2, 0.3}, M = 20 000)
    against the JAX package's CPU table, and the ``cz_robust`` and
    ``cz_drive2`` E[F](σ_δ) sweeps (``demo/app.py``) through B7 against
    the JAX package's CPU sweep;
15. serve-variants: the single-qubit variants ``small_20``, ``length_400``
    (0.2 · model + base pulse), ``length_100_p4``, ``length_400_p4``,
    ``length_100_gates`` and ``length_100_gates_p4`` (``demo/app.py``)
    loaded on the card, the 5 named gates and 3 random targets served in
    f32 and held against the CPU; a bundle variant's named gates served bit
    for bit from its bundle, a target off them from its model; both
    shipped bundles scored through B1 (σ_δ = 1, ε_std 0.05, M = 200 000)
    within 1.2e-3 of their ``fidelity_finetuned``;
16. grape: the GRAPE CLI (``workloads/grape_single_qubit.py``) on its
    config (L = 400, the MLP 4 → 1200 → 1200) with ``--backend pallas``,
    batch 100, M = 1000, one epoch (100 steps) per band; one step's
    gradient pallas against xla at that width (``grads_close``); ms per
    step and the device's busy share; ``--direct`` on X(π), 100 epochs,
    band 0's eval E[F] rising;
17. finetune: the per-gate polish CLI (``workloads/finetune_gates.py``) at
    its defaults from ``length_100`` (5 gates, 1500 steps at M = 8192, eval
    M = 200 000), no gate worse than its model by 2e-3 and the mean at least
    1e-3 above it, the bundle read back and served from a variant, ms per
    polish step; then ``analysis/p4_grape_ceiling.py`` cut to 2 starts × 2
    gates, 3 bands of 100 steps, eval M = 20 000 (B1/B3/B2 at P = 4);
18. dcrab: the dCRAB CLI in grad mode at its widths (N = 2000, 600 time
    steps, 200 samples, 5 rounds), 20 Adam steps, the infidelity falling,
    the objective on the card within 1e-5 of the CPU's on the same
    problem, ms and kernel launches per Adam step; nm mode at N = 12, 200
    iterations.  Plain PyTorch (the JAX package has no kernel here): every
    counter must stay at 0;
19. mesh: 2 ranks on this card over gloo (NCCL refuses two ranks on one
    device), started as ``chip_smoke.py --mesh-rank`` with a launcher's
    environment, as a 1 × 2 and then a 2 × 1 mesh: ``make_mean_fidelity(mesh,
    "pallas")`` and ``make_per_target_objective`` at the flagship training
    shape (B 200, L 100, P 2, M 1000, σ_δ = 1, ε_std 0.05), value within 2e-6
    and pulse gradient within 1e-5 of its largest entry of one process's B1
    on the same draws; the training CLI with ``--mesh`` at the flagship's
    width (``--backend pallas``, batch 200, M 1000, dropout on, one epoch of
    2 steps a band), its losses and E[F] at every step and band 0's eval
    E[F] within 1e-4 relative of a one-process run with the same seed, later
    bands' eval E[F] within 4e-4, the ranks' parameters bit-identical, only
    rank 0 writing; ms per train step and a step's gloo all-reduce (the
    parameters' gradient); ``--mesh 3,5``
    raising its ``ValueError``.
    Each rank reports its counters and times as one JSON line;
20. run: ``workloads/run.py`` on a RunConfig at
    ``configs/universal_single_qubit.json``'s widths (f32, ``backend``
    pallas, batch 200, M 1000, 3 bands of 2 steps), band 2 exported by
    ``workloads/export_npz.py`` in f32, f16 and int8: the f32 export served
    through the demo's loader within 1e-6 of the trainer's eval-mode pulses
    (5 named gates, 3 random targets), the f16 and int8 exports equal to a
    numpy round trip of the trainer's weights, each export's E[F] through B1
    (M = 2¹⁶) printed;
21. viz: the single-qubit figures' numbers (``analysis/``; the card's
    machine has no matplotlib, so the figures themselves are checked by the
    CPU tests) for the ``length_100`` flagship from its ``.npz`` at the
    demo's defaults (X(π), M = 10 000), each through B3: ``fidelity_grid``
    (1000 × 50 samples), ``mc_fidelity_estimate``, ``fidelity_by_std`` (199 σ
    × 10 000 samples in one launch) for ``length_100`` and
    ``length_100_p4``, the Bloch trajectories of 12 samples and their E[F],
    ``gate_parity_curves("length_100")`` (5 gates, model and SCORE: 20
    launches, the SCORE tables up to L = 2019) and
    ``compare_pulse_strategies`` on X(π); the grid and sweeps held to their
    plain versions (the L = 100 rule; the longest SCORE table on 3 σ), the
    Bloch endpoints to B3's product rotated onto ẑ at P = 2 and P = 4, the
    parity E[F] at σ_δ = 1 within 5 combined SE of the JAX package's CPU
    values (printed beside ``docs/model_vs_score_length100.md``'s), SCORE's
    total time exactly and the model's within 0.01π;
22. viz-su4: the two-qubit figures' numbers through B7: the bundle figure's
    curves (``analysis/two_qubit_bundle_figure.py``, 5 gates × 12 σ × 2000)
    at σ_δ ∈ {0.1, 0.2, 0.3} within 5 combined SE of the JAX package's CPU
    values, and ``render_two_qubit_artifacts``' grid (61²) and sweep (20 σ ×
    2000) of ``two_qubit_d2_kak`` CZ and ``cz_drive2``, each against its
    plain version;
23. time: each kernel at the shape of each path that runs it, with CUDA
    events (for B1, B2, B3 and B7 also the device's time of the kernels alone,
    each call queued behind a long one: their wrappers' host time exceeds a
    short launch's), beside its plain version, its bound and its ptxas registers,
    spills and stack, and the resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, exported by the
    libraries) with, for B1, B2 and B3, the threads per block and the
    launch's waves, for the lane-group kernels B4, B6, B5 and B8 the lanes
    per sample and the launch's warps per warp scheduler, for B7 its plan
    (chunks per sample), blocks, blocks a SM, waves and warps per
    scheduler;
    one row of the ``kernels`` line per kernel and path, with that path's
    launches (B4 and B5 at both the polish's and the training shape; B1,
    B3 and B2 also at slice 2's GRAPE, polish and ceiling shapes, the
    ceiling's at its default (80, 100, 4, 4096) though its run is cut, and
    at the mesh's local shapes 200 × 100 × 2 × 500 and 100 × 100 × 2 × 1000,
    with both ranks' launches, the runner's training shape, and B3 and B7
    at the figures' shapes).

Phases 6–7 are the single-qubit serving path, phase 8's CLI run the
training path, phases 9–10 the two-qubit serving path, phase 11's CLI run
the two-qubit training path, phases 12–13 the two-qubit per-gate paths
(GRAPE, polish), phase 14 the two-qubit demo variants and phases 15–18
slice 2's paths (the variants, GRAPE, the polish and ceiling, dCRAB),
phase 19 the mesh's (in each rank), phase 20 the runner's and phases
21–22 the figures' and the demo renderer's; the
kernels' launch counters are set to 0 just before each and read just
after, and every kernel of the path must have been launched there.  No path runs B8
(the JAX package has no caller of its ``_bwd_kernel`` either): its row
reports phase 5's launches.  Any failure raises and the run exits
nonzero.  The line before the last is the card's ``nvidia-smi`` name and
power limit; the last line is ``{"ok": true, "device": {...}}``.  Exits
nonzero without a result where CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# f32 peak outside the tensor cores and HBM rate of one H100 SXM at 700 W
# (NVIDIA data sheet); the card's actual power limit is printed beside them.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# flops per (sample, segment), an FMA counted as 2 as in the peak above, as
# tests/test_torch_su2_host.py counts them on a host build of ops/csrc/su2.cuh
# (compose()) on the path every angle within pi / 2 takes: sincos 20 (sin
# degree 9 and cos degree 10 by Horner in x^2), the half angle and sin x / n
# 2; at P = 2 a pair of segments at a time (pair2: the pair's product 22, one
# Hamilton product 28, 25 a segment), at P = 3 / 4 the axis norm 4, its
# inverse, the angle's factor, 3 axis products (+ Delta + delta at P = 4) and
# a Hamilton product 28.  Per sample: 8 at P = 2 ((1 + eps) / 2, the axis
# norm, its inverse, the angle's factor, delta^2), 2 at P = 3 / 4.  A sample
# whose angles may pass pi / 2 takes libm's sincosf (more work, not counted
# here: its bound is low); each B1/B2/B3 row prints how many did
# (libm_samples).
FLOPS_PER_SEGMENT = {2: 47, 3: 58, 4: 59}
FLOPS_PER_SAMPLE = {2: 8, 3: 2, 4: 2}
FLOPS_PER_SAMPLE_FIDELITY = 12  # <q, q_t>, F, the sum

# B2 per (sample, segment), counted the same way from su2.cuh's sweep(): the
# segment again (25 / 30 / 31 at P = 2 / 3 / 4), two Hamilton products
# (A_k = X o (Y o q_k): 56), the chain rule (20 at P = 2; 39 / 40 with the
# Omega term) and one add per pulse channel for the sum over samples; per
# sample 15 at P = 2 (the factors, and dd, de from the two sums), 3 at
# P = 3 / 4.  B2 reads B3's product; it does not rebuild it.
VJP_FLOPS_PER_SEGMENT = {2: 103, 3: 127, 4: 129}
VJP_FLOPS_PER_SAMPLE = {2: 15, 3: 3, 4: 3}

FID_TOL = 1e-5  # as tests/test_pallas_kernel.py holds the JAX kernels
XPI_PUBLISHED = 0.9502  # README.md per-gate table, flagship X(π) at σ_δ = 1.0
XPI_TOL = 0.005
SERVE_TOL = 1e-3  # card f32 vs CPU f32 pulses (φ modulo 2π)
GRAD_RTOL = 1e-4  # as tests/test_pallas_kernel.py holds the JAX VJP kernel
TRAIN_GRAD_TOL = 1e-4  # pallas vs xla, relative to the global gradient norm

# SU(4), B4, B6 and B7, per (sample, segment) as counted in su4.cuh's
# compose() (B7) and compose_lane() (B4, B6; the work every lane repeats taken
# once), which form only what the math needs: A = -iHτ/2⁴ is sparse
# (12 of its 32 reals are zero) and anti-Hermitian, A² and A⁴ Hermitian, A³
# anti-Hermitian, so each is formed as an upper triangle from the products
# that are not zero: 10 (A) + 37 (A², closed form) + 128 (A³ = A²A) + 166
# (A⁴ = A²A²) + 184 (P − I, Q) + 448 (P − I + A⁴Q) + 4 × 544 (squarings of
# I + X as 2X + X², dense) + 512 (W ← W + X W); per sample 10 (energies,
# (1 + ε)/2) and, for B6 and B4, 134 (Tr(U†T), F, the sum).
SU4_FLOPS_PER_SEGMENT = 3661
SU4_FLOPS_PER_SAMPLE = 10
SU4_FLOPS_PER_SAMPLE_FIDELITY = 134
# B5 per (sample, segment), counted the same way from su4.cuh's
# reverse_sweep_lane() (the lanes' shares summed, the work every lane repeats
# taken once): the segment rebuilt to T8(A) − I (973), the T8 adjoint
# (products with A⁴, Qᴴ, A², A: 3552), four squarings (2176) beside four
# squaring adjoints (4224), U_k = I + X (4), the 20 entries of D = E·U_k that
# the chain rule reads (316), the chain rule (57 / 58 / 65 at P = 2 / 3 / 4),
# V ← U_kᴴ V U_k (960) and one add per pulse channel for the sum over
# samples; per sample the energies, (1 + ε)/2 (10) and the seed V = G Pᴴ
# from the saved product (706).  Both held to the host build of the same code
# by tests/test_torch_su4_host.py.
SU4_VJP_FLOPS_PER_SEGMENT = {2: 12264, 3: 12266, 4: 12274}
SU4_VJP_FLOPS_PER_SAMPLE = 716
# B8: B4's product (compose_lane()) then B5's seed and sweep, per (sample,
# segment) and per sample (held to the host build by the same test)
SU4_B8_FLOPS_PER_SEGMENT = {P: SU4_FLOPS_PER_SEGMENT + f for P, f in
                            SU4_VJP_FLOPS_PER_SEGMENT.items()}
SU4_B8_FLOPS_PER_SAMPLE = SU4_FLOPS_PER_SAMPLE + SU4_VJP_FLOPS_PER_SAMPLE
# B8 against B5 seeded by B4 on the same inputs: the same compose_lane() and
# the same sweep, so the same numbers but for the compiler's choices
SU4_B8_B5_TOL = 1e-6
# B4, B6, B5 and B8: a block is 4 warps (128 / lanes samples)
SU4_WARPS_PER_BLOCK = 4
# the JAX suite's tolerances for its Pallas SU(4) kernels (tests/test_su4_pallas.py:43,
# :69, :121): products 2e-5, fidelities 1e-5 (2e-5 on drive2); at L = 100 widened to
# twice the plain f32 version's own error against f64 where that is larger
SU4_PROD_TOL = 2e-5
SU4_FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}
SU4_SWEEP_TOL = 1e-5  # E[F](σ) means, B7 against plain
SU4_MC_TOL = 0.005  # σ > 0: different draws, M = 20 000 (slice 1's rule)
SU4_EXACT_TOL = 1e-3  # σ = 0 (exact) against the JAX package's CPU value
# the two-qubit training path: the flagship recipe's batch and MC budget; its
# eval E[F] at σ_δ = 0.2 after a warm start must stay far above chance (the
# shipped model's blended figure is 0.951)
TRAIN4_BATCH, TRAIN4_MC = 32, 1024
TRAIN4_MIN_EVAL_FID = 0.85
# The JAX package's table on the CPU, from
#   JAX_PLATFORMS=cpu python -m universal_quantum_optimal_control_tpu.workloads.two_qubit_eval \
#       --sigmas 0,0.1,0.2 --monte_carlo 20000 --save_pulses jax_eval.npz
# (defaults: two_qubit_d2_kak.npz, drive2, KAK tokens, ω_min 0.05, L = 100,
# best-of-ℤ₄, ε_std 0.05, seed 7), the values of its meta_json:
# gate → E[F] at σ_δ = 0 (exact), 0.1, 0.2.
JAX_SU4_TABLE = {
    "cz": (0.9888486862182617, 0.9826241135597229, 0.9670261740684509),
    "zz(pi/4)": (0.99638831615448, 0.9918046593666077, 0.9810918569564819),
    "cnot": (0.989017128944397, 0.9810863137245178, 0.9633392095565796),
    "iswap": (0.9822724461555481, 0.9560391306877136, 0.9090651869773865),
    "sqrt_swap": (0.9938800930976868, 0.9852356910705566, 0.9655939936637878),
}
# The two-qubit GRAPE path: the JAX CLI on the CPU (`--gate cz --drive2`,
# blocks, 10 blocks, 24 starts, lr 0.02, seeds 0 / 1 / 2) first has a start
# at exact F > 0.999 after 39 / 45 / 44 steps of stage 0; the card run takes
# GRAPE_STEPS per stage and must reach 0.99 there.
GRAPE_STEPS = 50
GRAPE_MIN_EXACT_F = 0.99
# The per-gate polish path: the JAX CLI's 1500 polish steps (a step takes
# ~4 ms here), its GRAPE candidates' 2000 steps per stage cut to 20 (a
# GRAPE step takes 170–250 ms, host-bound; 50 until slice 2's phases needed
# the time); the chosen table's mean E[F] over
# the select σ may not fall more than POLISH_TOL below the model table's
# (the best iterate is kept and the model table is a candidate).
POLISH_STEPS = 1500
POLISH_GRAPE_STEPS = 20
POLISH_TOL = 2e-3
# The JAX package's eval_pulse_tables on the CPU on the shipped
# two_qubit_gates.npz bundle's five L = 40 tables (drive2, XLA path,
# M = 20 000, ε_std 0.05, seed 7): gate → E[F] at σ_δ = 0, 0.1, 0.2, 0.3.
JAX_BUNDLE_TABLE = {
    "cz": (0.9960463643074036, 0.9800006747245789, 0.9030025005340576, 0.7689083814620972),
    "zz(pi/4)": (0.9971822500228882, 0.9873948097229004, 0.93342125415802, 0.822611391544342),
    "cnot": (0.9965227842330933, 0.9778727293014526, 0.9126752018928528, 0.7872372269630432),
    "iswap": (0.9971479177474976, 0.9789591431617737, 0.9095389246940613, 0.7811154127120972),
    "sqrt_swap": (0.996422171592712, 0.984074592590332, 0.9226723313331604, 0.7999072670936584),
}
# The JAX package's analysis/plots_su4.py::fidelity_by_std_su4 on the CPU for
# the cz_robust (χ-only, P = 3) and cz_drive2 (drive2, P = 4) pulse tables,
# σ_δ = 0.02, 0.04, …, 0.40 (the demo's grid), ε_std 0.05, M = 20 000
# (PRNGKey(0)); the card's sweep, on its own draws at VARIANT_SWEEP_M, within
# VARIANT_SWEEP_TOL (the JAX SE is at most 0.0017, the card's 0.0008).
VARIANT_SWEEP_M = 100_000
VARIANT_SWEEP_TOL = 0.01
JAX_VARIANT_SWEEP = {
    "cz_robust": (0.8572357296943665, 0.8219403028488159, 0.7582226991653442,
                  0.6798102259635925, 0.626590371131897, 0.5784385800361633,
                  0.5465652942657471, 0.522517740726471, 0.49951136112213135,
                  0.4848792254924774, 0.46570539474487305, 0.4496079385280609,
                  0.43709829449653625, 0.4275376498699188, 0.41556453704833984,
                  0.4053516387939453, 0.39909911155700684, 0.39172035455703735,
                  0.3859942853450775, 0.3798447549343109),
    "cz_drive2": (0.9752307534217834, 0.9755719304084778, 0.9756261706352234,
                  0.9762162566184998, 0.9760600328445435, 0.9743930697441101,
                  0.9701351523399353, 0.962882399559021, 0.9520773887634277,
                  0.9348106980323792, 0.9154505729675293, 0.8906792998313904,
                  0.8622644543647766, 0.8403328657150269, 0.8099608421325684,
                  0.7819472551345825, 0.7534663677215576, 0.721082329750061,
                  0.695091724395752, 0.6728449463844299),
}
# cz_drive2's published E[F] at σ_δ = 0.1 / 0.2 / 0.3 (M = 4096, ε_std 0.05;
# demo/weights/README.md), printed beside the card's
CZ_DRIVE2_PUBLISHED = {0.1: 0.976, 0.2: 0.934, 0.3: 0.804}
# Slice 2, the other single-qubit optimizers.  The variants it adds; the
# shipped bundles scored at σ_δ = 1 within BUNDLE_TOL of their meta's
# fidelity_finetuned (5 standard errors: 2.2–2.6e-4 per gate, from 20 000
# draws per gate of the plain version on the CPU)
SLICE2_VARIANTS = ("small_20", "length_400", "length_100_p4", "length_400_p4",
                   "length_100_gates", "length_100_gates_p4")
BUNDLE_MC = 200_000
BUNDLE_TOL = 1.2e-3
# GRAPE: the JAX CLI's batch and M at its config's L = 400; direct mode's epochs
GRAPE_BATCH, GRAPE_MC = 100, 1000
DIRECT_EPOCHS = 100
# the finetune CLI from length_100: no gate worse than its model by more than
# FINETUNE_WORSE_TOL, the 5-gate mean at least FINETUNE_MIN_GAIN above it (the
# shipped bundle gained 3.2e-3)
FINETUNE_WORSE_TOL = 2e-3
FINETUNE_MIN_GAIN = 1e-3
# the P = 4 ceiling's default shape (16 starts × 5 gates, L = 100, M = 4096),
# timed even though its run is cut
CEILING_SHAPE = (80, 100, 4, 4096)
# dCRAB: Adam steps of the grad CLI; card vs CPU objective
DCRAB_STEPS = 20
DCRAB_TOL = 1e-5
# the SU(2) kernels' names in a profile (B1, B3, B2 and their reductions)
SU2_KERNEL_KEYS = ("mean_fid_kernel", "propagate_mc", "partials_kernel", "reduce_columns")


def quat_tol(L: int) -> float:
    """f32 rounding tolerance for per-sample quaternions: each segment's
    sincos and Hamilton product add a few f32 ulps (≲ 1e-6 on unit-norm
    components), accumulating at most linearly over L dependent products."""
    return max(1e-5, 1e-6 * L)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def random_inputs(gen, B, L, P, M, dev):
    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    cols = [u(-math.pi, math.pi, (B, L))]
    if P >= 3:
        cols.append(u(-0.3, 1.5, (B, L)))  # some Ω < 0 exercise the clamp
    if P == 4:
        cols.append(u(-1.0, 1.0, (B, L)))
    cols.append(u(0.05, 0.5, (B, L)))
    pulses = torch.stack(cols, dim=-1).contiguous()
    delta = torch.randn((B, M), generator=gen, device=dev)
    eps = 0.05 * torch.randn((B, M), generator=gen, device=dev)
    q_t = torch.randn((B, 4), generator=gen, device=dev)
    q_t = (q_t / q_t.norm(dim=-1, keepdim=True)).contiguous()
    return pulses, q_t, delta, eps


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def roofline(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound(B, L, P, M, out_bytes, fidelity):
    ops = B * M * (L * FLOPS_PER_SEGMENT[P] + FLOPS_PER_SAMPLE[P]
                   + (FLOPS_PER_SAMPLE_FIDELITY if fidelity else 0))
    in_bytes = 4 * (B * L * P + 2 * B * M + (4 * B if fidelity else 0))
    return roofline(ops, in_bytes + out_bytes)


def libm_samples(pulses, delta, eps) -> int:
    """Samples whose angles may pass the polynomial sincos's range, pi / 2,
    so that B1, B2 and B3 take libm's sincosf for them: su2.cuh's
    angle_bound from the row's max |tau| (and |tau| sqrt(Omega^2 + Delta^2)
    at P >= 3); B2 takes it for the sample's whole warp."""
    P = pulses.shape[-1]
    tau = pulses[..., -1].abs()
    h = (0.5 * (1.0 + eps)).abs()
    t0 = tau.amax(dim=1, keepdim=True)
    if P == 2:
        x = t0 * (h * torch.sqrt(delta * delta + 1.0))
    else:
        om = pulses[..., 1].clamp(min=0.0)
        det = pulses[..., 2] if P == 4 else torch.zeros_like(om)
        t1 = (tau * torch.sqrt(det * det + om * om)).amax(dim=1, keepdim=True)
        x = h * (t0 * delta.abs() + t1)
    return int((~(x <= 1.5707963)).sum())


def vjp_bound(B, L, P, M):
    """B2: reads pulses, δ, ε, g (B, M, 4) and B3's product q (B, M, 4)
    once; writes dpulses, dδ, dε."""
    in_bytes = 4 * (B * L * P + 2 * B * M + 8 * B * M)
    out_bytes = 4 * (B * L * P + 2 * B * M)
    return roofline(B * M * (L * VJP_FLOPS_PER_SEGMENT[P] + VJP_FLOPS_PER_SAMPLE[P]),
                    in_bytes + out_bytes)


def grads_close(what, names, atols, got, want, exact):
    """Hold a kernel's gradients against its plain f32 version:
    ``|kernel − plain| ≤ max(atol, 2·e32) + 1e-4·|plain|`` elementwise, with
    the JAX suite's atol (1e-4 pulses and targets, 1e-5 δ and ε) and e32 the
    plain f32 version's own max error against the same computation in f64.
    At L ≤ 7 e32 stays below atol / 2; at L = 100 and beyond it does not (the
    prefix is rebuilt through up to L products and dδ, dε sum L terms of
    growing size), so there the bound is what f32 itself allows.  Returns the
    worst |kernel − plain|, |kernel − f64| and |plain − f64|."""
    worst = [0.0, 0.0, 0.0]
    for name, atol, a, b, x in zip(names, atols, got, want, exact):
        for label, t in (("kernel", a), ("plain", b), ("f64", x)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} d{name}: {label} gradient is not finite")
        e32 = float((b.double() - x).abs().max())
        err = (a - b).abs()
        bound_ = max(atol, 2.0 * e32)
        if not bool((err <= bound_ + GRAD_RTOL * b.abs()).all()):
            raise AssertionError(f"{what} d{name}: max |kernel - plain| {float(err.max()):.3e} "
                                 f"beyond max({atol:.0e}, 2·{e32:.2e}) + {GRAD_RTOL:.0e}·|plain|")
        errs = (float(err.max()), float((a.double() - x).abs().max()), e32)
        worst = [max(w, e) for w, e in zip(worst, errs)]
    return tuple(worst)


def check_vjp(case, pulses, delta, eps, g):
    """B2 against its plain version (and both against f64)."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        propagate_mc_vjp_cuda, propagate_mc_vjp_plain)
    got = propagate_mc_vjp_cuda(pulses, delta, eps, g)
    want = propagate_mc_vjp_plain(pulses, delta, eps, g)
    exact = propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    return grads_close(f"B2 {case}", ("pulses", "delta", "eps"), (1e-4, 1e-5, 1e-5),
                       got, want, exact), got, want


def check_mean_fidelity_grad(case, pulses, q_t, delta, eps, gen):
    """B1's full gradient (pulses, q_t, δ, ε) under a per-target cotangent
    against autograd through its plain version (and both against f64)."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        mean_fidelity_cuda, mean_fidelity_plain)
    gbar = torch.rand(pulses.shape[0], generator=gen, device=pulses.device)

    def grad(fn, dtype):
        leaves = [t.to(dtype).clone().requires_grad_(True) for t in (pulses, q_t, delta, eps)]
        return torch.autograd.grad(fn(*leaves), leaves, gbar.to(dtype))

    return grads_close(f"B1 gradient {case}", ("pulses", "q_target", "delta", "eps"),
                       (1e-4, 1e-4, 1e-5, 1e-5), grad(mean_fidelity_cuda, torch.float32),
                       grad(mean_fidelity_plain, torch.float32),
                       grad(mean_fidelity_plain, torch.float64))


def wrapped_phi_err(a: torch.Tensor, b: torch.Tensor, angles: int = 1) -> float:
    """Max |a − b| with the first ``angles`` channels compared modulo 2π."""
    d = torch.remainder(a[..., :angles] - b[..., :angles] + math.pi, 2 * math.pi) - math.pi
    return max(float(d.abs().max()), float((a[..., angles:] - b[..., angles:]).abs().max()))


def su4_random_inputs(gen, B, L, P, M, dev):
    """SU(4) pulses (φ, [φ₂,] [Ω,] τ) with some Ω < 0 (the clamp), disorder
    at σ 0.3 / 0.3 / 0.05 and random unitary targets; P = 4 is drive2."""
    from universal_quantum_optimal_control_tpu_torch.core.su4 import TwoQubitSystem

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((B, L), generator=gen, device=dev)

    cols = [u(-math.pi, math.pi)] + ([u(-math.pi, math.pi)] if P == 4 else []) \
        + ([u(-0.3, 2.0)] if P >= 3 else []) + [u(0.05, 0.6)]
    pulses = torch.stack(cols, dim=-1).contiguous()
    d1, d2, ep = (s * torch.randn((B, M), generator=gen, device=dev) for s in (0.3, 0.3, 0.05))
    z = torch.complex(torch.randn((B, 4, 4), generator=gen, device=dev, dtype=torch.float64),
                      torch.randn((B, 4, 4), generator=gen, device=dev, dtype=torch.float64))
    T = torch.linalg.qr(z)[0]
    return (pulses, T.real.float().contiguous(), T.imag.float().contiguous(), d1, d2, ep,
            TwoQubitSystem(drive2=P == 4))


def max_err(a, b) -> float:
    """Max |a − b| over a tensor or a (re, im) pair, in f64."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def su4_bound(B, L, P, M, fidelity, product=False):
    """B6 (``fidelity``), B4 (``fidelity`` and ``product``) or B7: reads
    pulses, δ₁, δ₂, ε (and the target) once; writes (B,) means, the
    per-sample products, or both."""
    per_sample = L * SU4_FLOPS_PER_SEGMENT + SU4_FLOPS_PER_SAMPLE
    if fidelity:
        per_sample += SU4_FLOPS_PER_SAMPLE_FIDELITY
    in_bytes = 4 * (B * L * P + 3 * B * M + (32 * B if fidelity else 0))
    out_bytes = (4 * B if fidelity else 0) + (4 * 32 * B * M if product or not fidelity else 0)
    return roofline(B * M * per_sample, in_bytes + out_bytes)


def su4_vjp_bound(B, L, P, M, rebuild=False):
    """B5: reads pulses, the targets, ḡ, δ₁, δ₂, ε and B4's product once;
    writes dpulses, dδ₁, dδ₂ and dε.  B8 (``rebuild``): the same without
    the product, and the product's flops besides."""
    in_bytes = 4 * (B * L * P + 32 * B + B + 3 * B * M + (0 if rebuild else 32 * B * M))
    out_bytes = 4 * (B * L * P + 3 * B * M)
    if rebuild:
        per_sample = L * SU4_B8_FLOPS_PER_SEGMENT[P] + SU4_B8_FLOPS_PER_SAMPLE
    else:
        per_sample = L * SU4_VJP_FLOPS_PER_SEGMENT[P] + SU4_VJP_FLOPS_PER_SAMPLE
    return roofline(B * M * per_sample, in_bytes + out_bytes)


def ptxas_table(built) -> dict:
    """``{entry function: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}}`` from the libraries' ``-Xptxas -v`` logs."""
    table, name = {}, None
    for b in built.values():
        for line in b["log"].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                table[name] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name:
                table[name].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                                   spill_load_bytes=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                table[name]["registers"] = int(m[1])
    return table


def ptxas_of(table: dict, fragment: str) -> dict:
    """The one entry function whose mangled name contains ``fragment``."""
    hits = [v for k, v in table.items() if fragment in k]
    if len(hits) != 1:
        raise AssertionError(f"{len(hits)} ptxas entries match {fragment!r}")
    return hits[0]


def check_su4_train(gen, dev) -> str:
    """B4 (mean and product) against its plain version, and B5 and B8
    against autograd through the plain forward under a non-uniform
    per-target ḡ (the CVaR path), P ∈ {2, 3, 4}, L ∈ {3, 7, 100},
    M ∈ {1, 200, 1000}; every P ≥ 3 case has Ω < 0 entries.  Tolerances:
    B4 as B6 and B7 in check-su4; B5 and B8 the JAX suite's 1e-5 abs on
    gradients (tests/test_su4_pallas_bwd.py) with grads_close's relative
    part, widened to twice the plain f32 version's own error against f64
    where larger; B8 against B5 seeded by B4 within SU4_B8_B5_TOL."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import (
        mean_fidelity_su4_with_product_cuda, mean_fidelity_su4_with_product_plain,
        su4_objective_vjp_cuda, su4_objective_vjp_from_product_cuda,
        su4_objective_vjp_from_product_plain)
    worst_f, worst_u, worst_g, worst_8, worst_85 = 0.0, 0.0, [0.0] * 3, [0.0] * 3, 0.0
    n = 0
    for P in (2, 3, 4):
        for L in (3, 7, 100):
            for M in (1, 200, 1000):
                case = f"P={P} L={L} M={M}"
                pulses, tr, ti, d1, d2, ep, sys4 = su4_random_inputs(gen, 3, L, P, M, dev)
                gbar = 0.1 + torch.rand(3, generator=gen, device=dev)
                F_k, prod_k = mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys4)
                got = su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod_k,
                                                          sys4)
                got8 = su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar, sys4)
                torch.cuda.synchronize()
                F_p, prod_p = mean_fidelity_su4_with_product_plain(pulses, tr, ti, d1, d2, ep, sys4)
                err_f, err_u = max_err(F_k, F_p), max_err(prod_k, prod_p)
                tol_u, tol_f = SU4_PROD_TOL, SU4_FID_TOL[P]
                args64 = [t.double() for t in (pulses, tr, ti, d1, d2, ep)]
                if L > 7:
                    F64, prod64 = mean_fidelity_su4_with_product_plain(*args64, sys4)
                    tol_u = max(tol_u, 2 * max_err(prod_p, prod64))
                    tol_f = max(tol_f, 2 * max_err(F_p, F64))
                if not err_u <= tol_u:
                    raise AssertionError(f"B4 {case}: |product kernel - plain| {err_u:.3e} > "
                                         f"{tol_u:.2e}")
                if not err_f <= tol_f:
                    raise AssertionError(f"B4 {case}: |F kernel - plain| {err_f:.3e} > {tol_f:.2e}")
                want = su4_objective_vjp_from_product_plain(pulses, tr, ti, d1, d2, ep, gbar,
                                                            prod_p, sys4)
                exact = su4_objective_vjp_from_product_plain(*args64, gbar.double(), None, sys4)
                names = ("pulses", "delta1", "delta2", "eps")
                e5 = grads_close(f"B5 {case}", names, (1e-5,) * 4, got, want, exact)
                e8 = grads_close(f"B8 {case}", names, (1e-5,) * 4, got8, want, exact)
                e85 = max_err(got8, got)
                if not e85 <= SU4_B8_B5_TOL:
                    raise AssertionError(f"B8 {case}: |B8 - B5 seeded by B4| {e85:.3e} > "
                                         f"{SU4_B8_B5_TOL:.0e}")
                worst_f, worst_u = max(worst_f, err_f), max(worst_u, err_u)
                worst_g = [max(w, e) for w, e in zip(worst_g, e5)]
                worst_8 = [max(w, e) for w, e in zip(worst_8, e8)]
                worst_85 = max(worst_85, e85)
                n += 1
                print(f"  {case}: B4 F err {err_f:.2e} (tol {tol_f:.1e}), product err "
                      f"{err_u:.2e} (tol {tol_u:.1e}); B5 err {e5[0]:.2e} (vs f64: kernel "
                      f"{e5[1]:.2e}, plain {e5[2]:.2e}); B8 err {e8[0]:.2e} (vs f64 "
                      f"{e8[1]:.2e}), B8 - B5 {e85:.2e}")
    return (f"{n} cases; worst B4 F {worst_f:.3e}, product {worst_u:.3e}; worst B5 {worst_g[0]:.3e}, "
            f"B8 {worst_8[0]:.3e} against plain (atol max(1e-5, 2× the plain f32 error), rtol "
            f"{GRAD_RTOL:.0e}); against f64: B5 kernel {worst_g[1]:.3e}, B8 kernel "
            f"{worst_8[1]:.3e}, plain {worst_g[2]:.3e}; worst |B8 - B5 seeded by B4| "
            f"{worst_85:.3e} (tol {SU4_B8_B5_TOL:.0e})")


def step_profile(step, n: int, keys=(), per_call: int = 1, profile: bool = True) -> dict:
    """ms per step on the host clock around ``n`` synchronized calls of
    ``step()`` (after one warm-up), each ``per_call`` steps, then (unless
    ``profile`` is False: an eager plain step's ~10⁵ records take the
    profiler minutes) a profile of 3 calls: the device's kernel time per
    step and that of the kernels whose names contain one of ``keys``."""
    step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1) / (n * per_call)
    if not profile:
        return {"ms": ms}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / (3e3 * per_call)
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in keys)) / (3e3 * per_call)
    return {"ms": ms, "device_ms": dev_ms, "kernel_ms": ours_ms}


def device_ms(fn, n: int = 20) -> float:
    """The device's time per call of ``fn``'s kernels alone: each call is
    queued behind a 4096² matrix product (~3 ms on an H100) that keeps the
    stream busy while the host enqueues it, so the CUDA events around the
    call time its kernels, not its wrapper's time on the host (which a
    short launch's events in a loop would show, and which a 2048² product
    did not always cover)."""
    spacer = torch.randn((4096, 4096), device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        spacer @ spacer
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        total += start.elapsed_time(stop)
    return total / n


def su4_counters() -> dict:
    from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as t4
    return {"B4": t4.mean_fidelity_su4_with_product_cuda,
            "B5": t4.su4_objective_vjp_from_product_cuda,
            "B6": t4.mean_fidelity_su4_cuda, "B7": t4.propagate_su4_mc_cuda,
            "B8": t4.su4_objective_vjp_cuda}


def run_path(fn, need):
    """Every kernel's counter to 0, ``fn()``, counters read: fails unless
    every kernel in ``need`` was launched.  Returns ``(fn's result,
    launches)``."""
    counters = {**su2_counters(), **su4_counters()}
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    if need and min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of {need} was not launched on the path: {launches}")
    return out, launches


def train_su4(ckpt, kw4, dev) -> dict:
    """The two-qubit training path: the CLI (``workloads/two_qubit.py``) on
    the ``two_qubit_d2_kak`` recipe at full width with ``--backend pallas``,
    warm-started from the shipped weights, 2 epochs of 2 steps in the σ_δ =
    0.2 band, with the kernels' counters set to 0 just before and read just
    after; then one step's gradient through ``pallas`` against ``xla`` from
    the same weights and draws, ms per step, and a profile of pallas steps.
    Returns what the time phase needs."""
    from universal_quantum_optimal_control_tpu_torch.data import kak_input_tokens
    from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as t4
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand, SU4System,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit, two_qubit_eval

    B, M = TRAIN4_BATCH, TRAIN4_MC
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "run"
        argv = ["--device", "cuda", "--backend", "pallas", "--max_pulses", "100",
                "--d_model", "512", "--n_layers", "8", "--n_heads", "16", "--drive2",
                "--kak_tokens", "--omega_min", "0.05", "--target_mode", "mixed",
                "--phase_augment", "--batch_size", str(B), "--monte_carlo", str(M),
                "--curriculum", "0.2", "--lr_schedule", "cosine", "--learning_rate", "1e-4",
                "--reset_opt_per_band", "--shuffle", "--recover_collapse", "0.05",
                "--restore", ckpt, "--train_size", "64", "--eval_size", "32",
                "--num_epoch", "2", "--save_path", str(save)]
        history, launches = run_path(lambda: two_qubit.main(argv), ["B4", "B5", "B6"])
        t_cli = time.perf_counter() - t0
        band = history["bands"][0]
        losses, fids = band["train_loss"], band["eval_fid"]
        if len(history["bands"]) != 1 or len(losses) != 2 or len(fids) != 2:
            raise AssertionError(f"expected 1 band × 2 epochs, got {history}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a training loss is not finite: {losses}")
        if not all(TRAIN4_MIN_EVAL_FID < x <= 1.0 for x in fids):
            raise AssertionError(f"eval E[F] at sigma 0.2 {fids} outside ({TRAIN4_MIN_EVAL_FID}, "
                                 f"1] (the shipped model's blended figure is 0.951): the restore "
                                 f"or the KAK tokens are wrong")
        exports = sorted(save.glob("*_pulses.npz"))
        if len(exports) != 1 or not (save / "metrics.csv").exists():
            raise AssertionError(f"pulse exports {exports}, metrics.csv "
                                 f"{(save / 'metrics.csv').exists()}")
        with np.load(exports[0]) as z:
            if z["pulses"].shape != (64, 100, 4) or not np.isfinite(z["pulses"]).all():
                raise AssertionError(f"{exports[0].name}: {z['pulses'].shape}")
    print(f"  CLI: 1 band × 2 epochs × 2 steps at batch {B}, M = {M}, L = 100, d512 × 8 in "
          f"{t_cli:.2f} s; train loss " + " ".join(f"{x:.4f}" for x in losses)
          + "; eval E[F] at sigma 0.2 " + " ".join(f"{x:.5f}" for x in fids)
          + f"; launches {launches}")

    # one step's gradient through pallas and xla from the same weights and draws
    sys_p = SU4System(drive2=True, backend="pallas")
    model = two_qubit_eval.load_two_qubit_model(ckpt, device=dev, **kw4)
    targets = two_qubit.build_targets(2027, B, sys_p.system, mode="mixed", phase_augment=True)
    U = targets[:, 0].double().numpy() + 1j * targets[:, 1].double().numpy()
    x = torch.from_numpy(kak_input_tokens(U)).to(dev)
    targets = targets.to(dev)
    trainers = {b: Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, learning_rate=1e-4),
                           system=SU4System(drive2=True, backend=b), device=dev)
                for b in ("pallas", "xla")}
    band = CurriculumBand(0.2)
    errors = trainers["pallas"].sample_errors(B, band)
    grads, step_loss, peak = {}, {}, {}
    for b, tr in trainers.items():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = tr.objective(x, targets, errors)
        loss.backward()
        torch.cuda.synchronize()
        peak[b] = torch.cuda.max_memory_allocated() / 2**30
        grads[b] = torch.cat([p.grad.flatten() for p in model.parameters()])
        step_loss[b] = float(loss.detach())
    # the plain f32 version's own error at L = 100: the same step's loss and
    # pulse cotangent in f64 (the plain version from the model's pulses on),
    # chained through the same model Jacobian
    tr = trainers["xla"]
    model.train(False)
    pulses = model(x)
    p64 = pulses.detach().double().requires_grad_(True)
    F64 = t4.mean_fidelity_su4_plain(p64, *(t.double() for t in (targets[:, 0], targets[:, 1],
                                                                 *errors)), sys_p.system)
    (dp64,) = torch.autograd.grad(tr._loss_of_mean_fid(torch.mean(F64)), p64)
    g64 = torch.cat([g.flatten() for g in torch.autograd.grad(
        pulses, list(model.parameters()), dp64.float())])
    n64 = float(g64.norm())
    e32 = {b: float((g - g64).norm()) / n64 for b, g in grads.items()}
    gnorm = float(grads["xla"].norm())
    rel = float((grads["pallas"] - grads["xla"]).norm()) / gnorm
    tol = max(TRAIN_GRAD_TOL, 2.0 * e32["xla"])
    print(f"  one step at M = {M} (the plain autograd fits: peak {peak['xla']:.2f} GiB, pallas "
          f"{peak['pallas']:.2f} GiB), pallas vs xla: loss {step_loss['pallas']:.6f} / "
          f"{step_loss['xla']:.6f}, |g_pallas - g_xla| / |g_xla| {rel:.3e} (|g| {gnorm:.4e}, "
          f"tol max({TRAIN_GRAD_TOL:.0e}, 2× the plain f32 error) = {tol:.2e}); against the "
          f"step in f64 (loss and pulse cotangent): pallas {e32['pallas']:.3e}, xla "
          f"{e32['xla']:.3e} of the norm")
    if not rel <= tol:
        raise AssertionError(f"two-qubit pallas vs xla gradient: {rel:.3e} of the norm > "
                             f"{tol:.2e}")

    # ms per train step (fresh draws and dropout, as in the CLI), host clock
    # around synchronized steps
    step_ms = {}
    for b, n in (("pallas", 10), ("xla", 2)):
        tr = trainers[b]
        tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
        step_ms[b] = 1e3 * (time.perf_counter() - t1) / n
    tr = trainers["pallas"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / 3e3
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in ("mean_fid_su4_kernel", "su4_vjp_kernel",
                                              "reduce_partials_kernel",
                                              "reduce_columns_kernel"))) / 3e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  profile of 3 pallas steps: kernels {dev_ms:.3f} ms per step, "
          f"{100 * dev_ms / step_ms['pallas']:.1f} % of the {step_ms['pallas']:.2f} ms step "
          f"(B4/B5 and their reductions {ours_ms:.3f} ms, "
          f"{100 * ours_ms / step_ms['pallas']:.1f} %); top, us per step: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 3:.0f}" for e in top))
    model.eval()
    with torch.no_grad():
        pulses = model(x).contiguous()
    return {"launches": launches, "step_ms": step_ms, "fids": fids, "rel": rel, "e32": e32,
            "pulses": pulses, "targets": targets, "errors": errors}


def grape_su4(dev) -> dict:
    """The two-qubit GRAPE path: the CLI on CZ (drive2, blocks, 10 blocks,
    24 starts, σ 0.1, 0.2 at M = 128, GRAPE_STEPS per stage) into a
    tempdir, its curve through B7; then ms per exact and MC step with a
    profile.  Returns what the time phase needs."""
    from universal_quantum_optimal_control_tpu_torch.optimizers import two_qubit_grape as tg
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_grape

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", "cuda", "--gate", "cz", "--drive2", "--mode", "blocks",
                "--n_blocks", "10", "--n_starts", "24", "--sigmas", "0.1,0.2",
                "--monte_carlo", "128", "--steps", str(GRAPE_STEPS), "--out", tmp]
        res, launches = run_path(lambda: two_qubit_grape.main(argv), ["B7"])
        t_cli = time.perf_counter() - t0
        files = sorted(p.name for p in Path(tmp).iterdir())
        if files != ["pulses.npz", "result.json", "robustness.csv"]:
            raise AssertionError(f"GRAPE CLI wrote {files}")
        with np.load(Path(tmp) / "pulses.npz") as z:
            if z["pulses"].shape != (20, 4) or not np.isfinite(z["pulses"]).all():
                raise AssertionError(f"GRAPE pulses {z['pulses'].shape}")
    stages = res["info"]["stages"]
    best0 = stages[0]["best_fid"]
    if not GRAPE_MIN_EXACT_F <= best0 <= 1.0 + 1e-5:
        raise AssertionError(f"GRAPE stage 0 best exact F {best0:.5f} after {GRAPE_STEPS} steps "
                             f"< {GRAPE_MIN_EXACT_F}")
    curve = res["curve"]
    if len(curve) != 6 or not all(0.0 < m <= 1.0 and se >= 0.0 for _, m, se in curve):
        raise AssertionError(f"GRAPE robustness curve {curve}")
    print(f"  CLI: {len(stages)} stages × {GRAPE_STEPS} steps in {t_cli:.2f} s; best F per stage "
          + " / ".join(f"{st['best_fid']:.5f}" for st in stages) + "; exact F of the pulse "
          f"{res['info']['exact_fid_of_best']:.5f}; curve E[F] " + " ".join(
              f"{s:g}:{m:.4f}" for s, m, _ in curve) + f"; launches {launches}")

    # ms per GRAPE step at the CLI's shape (autograd through the plain path)
    cfg = tg.TwoQubitGrapeConfig(drive2=True, n_blocks=10, n_starts=24, monte_carlo=128)
    gen = torch.Generator(device=dev).manual_seed(3)
    raw = tg._init_raw(cfg, gen).requires_grad_(True)
    opt = tg._adam(raw, cfg)
    U = tg.named_two_qubit_targets()["cz"]
    target = (torch.as_tensor(U.real, device=dev), torch.as_tensor(U.imag, device=dev))
    exact = step_profile(lambda: tg.step_exact(raw, opt, cfg, target), 10)
    mc = step_profile(lambda: tg.step_mc(raw, opt, cfg, target, tg._draws(gen, 24, 128), 0.1),
                      10)
    print(f"  GRAPE step (24 starts, L = 20): exact {exact['ms']:.2f} ms (kernels "
          f"{exact['device_ms']:.3f} ms, {100 * exact['device_ms'] / exact['ms']:.1f} %), "
          f"MC at M = 128 {mc['ms']:.2f} ms (kernels {mc['device_ms']:.3f} ms, "
          f"{100 * mc['device_ms'] / mc['ms']:.1f} %)")
    return {"launches": launches, "best0": best0, "pulses": res["pulses"], "t_cli": t_cli,
            "exact_step": exact, "mc_step": mc}


def polish_su4(dev) -> dict:
    """The per-gate polish path: the finetune CLI at full width (the
    flagship's best-of-ℤ₄ tables of the 5 named gates, σ mix 0, 0.1, 0.2 at
    M = 4096, lr 3e-3, POLISH_STEPS; GRAPE candidates at
    POLISH_GRAPE_STEPS; eval M = 20 000, σ 0, 0.1, 0.2, 0.3) into a
    tempdir; each gate's chosen table no worse than the model's; the bundle
    read back; then ms per polish step with a profile."""
    from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
    from universal_quantum_optimal_control_tpu_torch.training import SU4System
    from universal_quantum_optimal_control_tpu_torch.workloads import \
        finetune_two_qubit_gates as ft

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "two_qubit_gates.npz"
        argv = ["--device", "cuda", "--steps", str(POLISH_STEPS), "--monte_carlo", "4096",
                "--learning_rate", "3e-3", "--sigma_mix", "0,0.1,0.2", "--eval_mc", "20000",
                "--eval_sigmas", "0,0.1,0.2,0.3", "--grape", "--grape_steps",
                str(POLISH_GRAPE_STEPS), "--out", str(out)]
        res, launches = run_path(lambda: ft.main(argv), ["B4", "B5", "B6"])
        t_cli = time.perf_counter() - t0
        tables, meta = ft.load_two_qubit_gate_bundle(out)
    names, sigmas, select = res["names"], res["sigmas"], res["select"]
    if meta["gates"] != names or len(names) != 5 or meta["sources"] != res["sources"]:
        raise AssertionError(f"bundle meta {meta['gates']} {meta['sources']}")
    worst = np.inf
    for i, g in enumerate(names):
        chosen = ft._score(meta["fidelity"][i], sigmas, select)
        model = ft._score(res["f_model"][i], sigmas, select)
        worst = min(worst, chosen - model)
        if not chosen >= model - POLISH_TOL:
            raise AssertionError(f"polish {g}: chosen {chosen:.5f} below the model's {model:.5f}")
        src = dict(zip(names, res["sources"]))[g]
        want = dict((c[0], c[1]) for c in res["candidates"][g])[src]
        if not np.array_equal(tables[g], np.asarray(want, np.float32)):
            raise AssertionError(f"bundle table of {g} is not its chosen candidate")
        print(f"  {g}: {src}, E[F] " + " ".join(f"{v:.4f}" for v in meta["fidelity"][i])
              + "; model " + " ".join(f"{v:.4f}" for v in res["f_model"][i])
              + "; candidates " + ", ".join(f"{c[0]} {ft._score(c[2], sigmas, select):.4f}"
                                            for c in res["candidates"][g]))
    print(f"  CLI: polish {POLISH_STEPS} steps, GRAPE {POLISH_GRAPE_STEPS} steps × 3 stages × "
          f"5 gates, evals at M = 20 000 in {t_cli:.2f} s; chosen minus model (mean over "
          f"select σ) ≥ {worst:.5f}; launches {launches}")

    # ms per polish step at the CLI's shape: 5 gates, L = 100, M = 4096
    pulses0 = torch.as_tensor(np.stack([res["candidates"][g][0][1] for g in names]),
                              device=dev).contiguous()
    gates = named_two_qubit_targets()
    packed = SU4System.pack_target(np.stack([gates[g] for g in names])).to(dev)
    system = SU4System(drive2=True, backend="pallas")
    prof = step_profile(lambda: ft.finetune_su4_tables(
        pulses0, packed, ft.DRIVE2_SPACE, steps=5, monte_carlo=4096, system=system,
        log_every=10**9), 2, ("mean_fid_su4_kernel", "su4_vjp_kernel",
                               "reduce_partials_kernel", "reduce_columns_kernel"), per_call=5)
    print(f"  polish step (5 gates, L = 100, M = 4096, 3 σ terms): {prof['ms']:.2f} ms, kernels "
          f"{prof['device_ms']:.3f} ms ({100 * prof['device_ms'] / prof['ms']:.1f} %), of which "
          f"B4/B5 and their reductions {prof['kernel_ms']:.3f} ms "
          f"({100 * prof['kernel_ms'] / prof['ms']:.1f} %)")
    return {"launches": launches, "pulses0": pulses0, "packed": packed, "t_cli": t_cli,
            "step": prof, "worst": worst}


def serve_su4_variants(dev) -> dict:
    """The two-qubit demo variants: the shipped bundle's tables scored
    through B6 against the JAX package's CPU table, and the cz_robust and
    cz_drive2 sweeps through B7 against the JAX package's CPU sweep."""
    from universal_quantum_optimal_control_tpu_torch.demo import app
    from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
    from universal_quantum_optimal_control_tpu_torch.training import SU4System
    from universal_quantum_optimal_control_tpu_torch.workloads import \
        finetune_two_qubit_gates as ft
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_eval

    def run():
        tables, meta = ft.load_two_qubit_gate_bundle(
            app.TWO_QUBIT_VARIANTS["two_qubit_gates"]["gate_bundle"])
        names = meta["gates"]
        for g in names:
            served, _, _, _ = app.two_qubit_pulse_table("two_qubit_gates", g, device=dev)
            if not np.array_equal(served, tables[g]):
                raise AssertionError(f"two_qubit_gates serves another table for {g}")
        gates = named_two_qubit_targets()
        pulses = torch.as_tensor(np.stack([tables[g] for g in names]), device=dev)
        packed = SU4System.pack_target(np.stack([gates[g] for g in names])).to(dev)
        sigmas = [0.0, 0.1, 0.2, 0.3]
        table = two_qubit_eval.eval_pulse_tables(
            pulses.contiguous(), packed, sigmas, monte_carlo=20_000, epsilon_std=0.05,
            system=SU4System(drive2=True, backend="pallas"))
        sweeps = {v: app.two_qubit_robustness(v, monte_carlo=VARIANT_SWEEP_M, device=dev)
                  for v in ("cz_robust", "cz_drive2")}
        return names, meta, pulses, packed, table, sweeps

    t0 = time.perf_counter()
    (names, meta, pulses, packed, table, sweeps), launches = run_path(run, ["B6", "B7"])
    err0, errmc = 0.0, 0.0
    for i, g in enumerate(names):
        ref = JAX_BUNDLE_TABLE[g]
        e0, emc = abs(table[i, 0] - ref[0]), float(np.abs(table[i, 1:] - ref[1:]).max())
        if not (e0 <= SU4_EXACT_TOL and emc <= SU4_MC_TOL):
            raise AssertionError(f"bundle {g}: E[F] {table[i]} vs JAX CPU {ref} (tol "
                                 f"{SU4_EXACT_TOL} / {SU4_MC_TOL})")
        err0, errmc = max(err0, e0), max(errmc, emc)
        print(f"  bundle {g}: E[F] " + " ".join(f"{v:.5f}" for v in table[i]) + "; JAX CPU "
              + " ".join(f"{v:.5f}" for v in ref) + "; minus the bundle's meta fidelity "
              + " ".join(f"{a - b:+.5f}" for a, b in zip(table[i], meta["fidelity"][i])))
    worst_sweep = 0.0
    for v, out in sweeps.items():
        ref = np.asarray(JAX_VARIANT_SWEEP[v])
        err = float(np.abs(out["mean"] - ref).max())
        worst_sweep = max(worst_sweep, err)
        if not (err <= VARIANT_SWEEP_TOL and out["mean"].max() <= 1.0):
            raise AssertionError(f"{v} E[F](sigma) vs JAX CPU: {err:.3e} > {VARIANT_SWEEP_TOL}")
        print(f"  {v} ({out['pulses'].shape}): E[F](sigma) within {err:.2e} of JAX CPU; at "
              f"0.1 / 0.2 / 0.3: " + " / ".join(f"{out['mean'][k]:.4f} ± {out['se'][k]:.4f}"
                                                for k in (4, 9, 14)))
    d2 = sweeps["cz_drive2"]
    print("  cz_drive2 against its published E[F] (M = 4096): " + ", ".join(
        f"sigma {s}: {d2['mean'][k]:.4f} vs {CZ_DRIVE2_PUBLISHED[s]}"
        for s, k in ((0.1, 4), (0.2, 9), (0.3, 14))))
    return {"launches": launches, "pulses": pulses, "packed": packed, "err0": err0,
            "errmc": errmc, "sweep_err": worst_sweep, "d2_pulses": d2["pulses"],
            "t": time.perf_counter() - t0}


def su2_counters() -> dict:
    from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as t2
    return {"B1": t2.mean_fidelity_cuda, "B2": t2.propagate_mc_vjp_cuda,
            "B3": t2.propagate_mc_cuda}


def serve_variants(dev) -> dict:
    """The single-qubit variants slice 2 adds: each served on the card in
    f32 for the 5 named gates and 3 random targets, held against the CPU;
    the bundle variants' named gates served bit for bit from the bundle and
    a target off them from the model; both shipped bundles scored through
    B1 at σ_δ = 1 against their ``fidelity_finetuned``."""
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.demo import app
    from universal_quantum_optimal_control_tpu_torch.workloads import finetune_gates as ft

    rng = np.random.default_rng(7)
    axes = rng.standard_normal((3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rand_rv = np.concatenate([axes, rng.uniform(0.0, 2 * np.pi, (3, 1))], axis=1)

    def run():
        from universal_quantum_optimal_control_tpu_torch.data import named_gate_rotation_vectors
        gates = named_gate_rotation_vectors(device=dev)
        rv = torch.cat([torch.stack(list(gates.values())),
                        torch.tensor(rand_rv, dtype=torch.float32, device=dev)])
        rows, scores = {}, {}
        for v in SLICE2_VARIANTS:
            t1 = time.perf_counter()
            pipe = app.load_pipeline(v, device=dev, dtype=torch.float32)
            pulses = pipe(rv)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t1
            L, P = pipe.model.max_pulses, pipe.model.param_dim
            if tuple(pulses.shape) != (8, L, P) or not bool(torch.isfinite(pulses).all()):
                raise AssertionError(f"{v}: pulses {tuple(pulses.shape)}, finite "
                                     f"{bool(torch.isfinite(pulses).all())}")
            if not bool((pulses[..., -1] >= 0).all()):
                raise AssertionError(f"{v}: tau < 0")
            cpu = app.load_pipeline(v, device="cpu", dtype=torch.float32)(rv.cpu())
            err = wrapped_phi_err(pulses.cpu(), cpu)
            if not err <= SERVE_TOL:
                raise AssertionError(f"{v}: card f32 vs CPU f32 {err:.3e} > {SERVE_TOL}")
            row = {"shape": (L, P), "err": err, "load_s": t_load}
            bundle = app.MODEL_VARIANTS[v].get("gate_bundle")
            if bundle:
                tables, meta = ft.load_gate_bundle(bundle)
                for g, grv in zip(meta["gates"], meta["rotation_vectors"]):
                    served, _ = app.compute_pulses(v, *grv, device=dev, dtype=torch.float32)
                    if not np.array_equal(served, tables[g]):
                        raise AssertionError(f"{v} does not serve its bundle's table for {g}")
                off, _ = app.compute_pulses(v, *rand_rv[0], device=dev, dtype=torch.float32)
                want = pipe(torch.tensor(rand_rv[:1], dtype=torch.float32, device=dev))
                if not (wrapped_phi_err(torch.from_numpy(off), want[0].cpu()) <= 1e-5
                        and not any(np.array_equal(off, t) for t in tables.values())):
                    raise AssertionError(f"{v}: a target off the named gates is not served by "
                                         f"its model")
                names = meta["gates"]
                q = rotation_vector_to_quat(torch.tensor(meta["rotation_vectors"],
                                                         dtype=torch.float32, device=dev))
                table = torch.as_tensor(np.stack([tables[g] for g in names]), device=dev)
                f = ft.evaluate_tables(table, q, monte_carlo=BUNDLE_MC, delta_std=1.0,
                                       epsilon_std=0.05, backend="pallas")
                diff = f - np.asarray(meta["fidelity_finetuned"])
                if not float(np.abs(diff).max()) <= BUNDLE_TOL:
                    raise AssertionError(f"{v}: bundle E[F] {f} vs fidelity_finetuned "
                                         f"{meta['fidelity_finetuned']}: beyond {BUNDLE_TOL}")
                scores[v] = {"names": names, "f": f, "diff": diff, "table": table, "q": q}
            rows[v] = row
        return rows, scores

    t0 = time.perf_counter()
    (rows, scores), launches = run_path(run, ["B1"])
    for v, r in rows.items():
        print(f"  {v} (L = {r['shape'][0]}, P = {r['shape'][1]}): load and first batch "
              f"{r['load_s']:.2f} s; card f32 vs CPU f32 {r['err']:.2e}")
    for v, s in scores.items():
        print(f"  {v} bundle at sigma 1 through B1 (M = {BUNDLE_MC}): " + ", ".join(
            f"{g} {f:.5f} ({d:+.5f})" for g, f, d in zip(s["names"], s["f"], s["diff"])))
    return {"launches": launches, "rows": rows, "scores": scores,
            "t": time.perf_counter() - t0}


def grape_su2(dev) -> dict:
    """The single-qubit GRAPE path: the CLI on its config (L = 400, the MLP
    4 → 1200 → 1200) with ``--backend pallas``, batch 100, M = 1000, one
    epoch (100 steps) per band; one step's gradient pallas against xla at
    that width (``grads_close``, against f64 on the pulses' cotangent); ms
    per step and the device's busy share; then ``--direct`` on X(π), band
    0's eval E[F] rising."""
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.models import GRAPE, normalize_pulse_space
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import \
        mean_fidelity_plain
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.utils import load_model_params
    from universal_quantum_optimal_control_tpu_torch.workloads import grape_single_qubit as gcli

    B, M = GRAPE_BATCH, GRAPE_MC
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", "cuda", "--backend", "pallas", "--batch_size", str(B),
                "--monte_carlo", str(M), "--num_epoch", "1", "--save_path", f"{tmp}/mlp"]
        history, launches = run_path(lambda: gcli.main(argv), ["B1", "B2", "B3"])
        t_cli = time.perf_counter() - t0
        losses = [x for b in history["bands"] for x in b["train_loss"]]
        fids = [x for b in history["bands"] for x in b["eval_fid"]]
        if len(history["bands"]) != 3 or len(losses) != 3:
            raise AssertionError(f"expected 3 bands × 1 epoch, got {history}")
        if not all(math.isfinite(x) for x in losses) or not all(0.0 < x <= 1.0 for x in fids):
            raise AssertionError(f"GRAPE losses {losses}, eval E[F] {fids}")
        exports = sorted(Path(tmp, "mlp").glob("*_pulses.npz"))
        if len(exports) != 3:
            raise AssertionError(f"GRAPE pulse exports {exports}")
        with np.load(exports[-1]) as z:
            if z["pulses"].shape != (B * B, 400, 2) or not np.isfinite(z["pulses"]).all():
                raise AssertionError(f"{exports[-1].name}: {z['pulses'].shape}")
        t1 = time.perf_counter()
        dargv = ["--device", "cuda", "--backend", "pallas", "--direct", "--num_epoch",
                 str(DIRECT_EPOCHS), "--learning_rate", "3e-3", "--save_path", f"{tmp}/direct"]
        dhist, dlaunches = run_path(lambda: gcli.main(dargv), ["B1", "B2", "B3"])
        t_direct = time.perf_counter() - t1
    d0 = dhist["bands"][0]["eval_fid"]
    if not d0[-1] > d0[0]:
        raise AssertionError(f"direct GRAPE band 0 eval E[F] did not rise: {d0[0]} → {d0[-1]}")
    print(f"  CLI (MLP): 3 bands × 1 epoch × {B} steps at batch {B}, M = {M}, L = 400 in "
          f"{t_cli:.2f} s; train loss " + " ".join(f"{x:.4f}" for x in losses)
          + "; eval E[F] " + " ".join(f"{x:.5f}" for x in fids) + f"; launches {launches}")
    print(f"  CLI (--direct, X(pi)): 3 bands × {DIRECT_EPOCHS} steps in {t_direct:.2f} s; band "
          f"0 eval E[F] {d0[0]:.5f} → {d0[-1]:.5f}, best per band " + " / ".join(
              f"{b['best_fid']:.5f}" for b in dhist["bands"]) + f"; launches {dlaunches}")

    # one step's gradient through pallas and xla from the same weights and draws
    cfg = load_model_params(gcli.DEFAULT_CONFIG)
    model = GRAPE(pulse_space=normalize_pulse_space(cfg["pulse_space"]),
                  num_pulses=cfg["num_pulses"], device=dev)
    model.init_like_flax(torch.Generator(device=dev).manual_seed(5))
    rv, qt = build_su2_dataset(torch.Generator().manual_seed(11), B, random=True, device=dev)
    trainers = {b: Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, backend=b),
                           device=dev) for b in ("pallas", "xla")}
    band = CurriculumBand(1.0)
    errors = trainers["pallas"].sample_errors(B, band)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    for b, tr in trainers.items():
        loss, _ = tr.objective(rv, qt, errors)
        grads[b] = torch.autograd.grad(loss, list(model.parameters()))
    # the step in f64 from the pulses on (loss and pulse cotangent), chained
    # through the same model Jacobian
    tr = trainers["xla"]
    pulses = model(rv)
    p64 = pulses.detach().double().requires_grad_(True)
    F64 = mean_fidelity_plain(p64, qt.double(), *(e.double() for e in errors))
    (dp64,) = torch.autograd.grad(tr._loss_of_mean_fid(torch.mean(F64)), p64)
    g64 = torch.autograd.grad(pulses, list(model.parameters()), dp64.float())
    worst = grads_close("GRAPE step pallas vs xla", names, (1e-4,) * len(names),
                        grads["pallas"], grads["xla"], [g.double() for g in g64])
    flat = {b: torch.cat([g.flatten() for g in gs]) for b, gs in grads.items()}
    rel = float((flat["pallas"] - flat["xla"]).norm() / flat["xla"].norm())
    print(f"  one step at L = 400, batch {B}, M = {M}: |g_pallas - g_xla| max "
          f"{worst[0]:.3e} (vs f64: pallas {worst[1]:.3e}, xla {worst[2]:.3e}), "
          f"{rel:.3e} of the norm |g| {float(flat['xla'].norm()):.4e}")

    step = {}
    for b, n in (("pallas", 20), ("xla", 2)):
        tr = trainers[b]
        step[b] = step_profile(lambda: tr.train_step(rv, qt, tr.sample_errors(B, band)), n,
                               SU2_KERNEL_KEYS, profile=b == "pallas")
    sp = step["pallas"]
    print(f"  train step: pallas {sp['ms']:.2f} ms (kernels {sp['device_ms']:.3f} ms, "
          f"{100 * sp['device_ms'] / sp['ms']:.1f} % busy; B1/B2/B3 {sp['kernel_ms']:.3f} ms), "
          f"xla {step['xla']['ms']:.2f} ms")
    model.eval()
    with torch.no_grad():
        pulses = model(rv).contiguous()
    return {"launches": launches, "direct_launches": dlaunches, "t_cli": t_cli,
            "t_direct": t_direct, "step": step, "grad": worst, "rel": rel, "pulses": pulses,
            "q": qt.contiguous(), "errors": errors, "direct": (d0[0], d0[-1])}


def finetune_su2(dev) -> dict:
    """The single-qubit per-gate polish: the finetune CLI at its defaults
    from ``length_100`` (5 gates, 1500 steps at M = 8192, lr 3e-3, eval
    M = 200 000) into a tempdir, each gate no worse than its model and the
    mean gain ≥ FINETUNE_MIN_GAIN; the bundle read back and served from a
    variant; ms per polish step; then the P = 4 ceiling, cut."""
    from universal_quantum_optimal_control_tpu_torch.analysis import p4_grape_ceiling as pc
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.demo import app
    from universal_quantum_optimal_control_tpu_torch.workloads import finetune_gates as ft

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "length100_gates.npz"
        res, launches = run_path(lambda: ft.main(["--device", "cuda", "--out", str(out)]),
                                 ["B1", "B2", "B3"])
        t_cli = time.perf_counter() - t0
        tables, meta = ft.load_gate_bundle(str(out))
        names = res["names"]
        gain = res["f_finetuned"] - res["f_model"]
        for i, g in enumerate(names):
            if not gain[i] >= -FINETUNE_WORSE_TOL:
                raise AssertionError(f"finetune {g}: {res['f_finetuned'][i]:.5f} below its "
                                     f"model's {res['f_model'][i]:.5f}")
            if not np.array_equal(tables[g], res["pulses"][i].cpu().numpy()):
                raise AssertionError(f"bundle table of {g} is not the polished table")
        if not float(gain.mean()) >= FINETUNE_MIN_GAIN:
            raise AssertionError(f"finetune mean gain {float(gain.mean()):.5f} < "
                                 f"{FINETUNE_MIN_GAIN}")
        spec = dict(app.MODEL_VARIANTS["length_100_gates"], gate_bundle=str(out))
        app.MODEL_VARIANTS["smoke_gates"] = spec
        try:
            for g, grv in zip(meta["gates"], meta["rotation_vectors"]):
                served, _ = app.compute_pulses("smoke_gates", *grv, device=dev)
                if not np.array_equal(served, tables[g]):
                    raise AssertionError(f"the new bundle is not served for {g}")
        finally:
            del app.MODEL_VARIANTS["smoke_gates"]
    shipped = ft.load_gate_bundle(app.MODEL_VARIANTS["length_100_gates"]["gate_bundle"])[1]
    for i, g in enumerate(names):
        print(f"  {g}: model {res['f_model'][i]:.5f} → {res['f_finetuned'][i]:.5f} "
              f"({gain[i]:+.5f}); the shipped bundle's {shipped['fidelity_finetuned'][i]:.4f}")
    print(f"  CLI: 1500 polish steps, 5 gates, M = 8192, evals at M = 200 000 in {t_cli:.2f} s;"
          f" mean gain {float(gain.mean()):+.5f} (the shipped bundle's 3.2e-3); launches "
          f"{launches}")

    # ms per polish step at the CLI's shape: 5 gates, L = 100, P = 2, M = 8192
    pipe = app.load_pipeline("length_100", device=dev)
    rv = torch.tensor(meta["rotation_vectors"], device=dev)
    pulses0 = pipe(rv).float().contiguous()
    q = rotation_vector_to_quat(rv).contiguous()
    space = ft.clamp_tau_nonnegative(pipe.model.pulse_space)
    prof = step_profile(lambda: ft.finetune_pulse_tables(
        pulses0, q, space, steps=5, monte_carlo=8192, log_every=10**9), 4, SU2_KERNEL_KEYS,
        per_call=5)
    print(f"  polish step (5 gates, L = 100, P = 2, M = 8192): {prof['ms']:.2f} ms, kernels "
          f"{prof['device_ms']:.3f} ms ({100 * prof['device_ms'] / prof['ms']:.1f} % busy), "
          f"B1/B2/B3 {prof['kernel_ms']:.3f} ms")

    # the P = 4 ceiling, cut: 2 starts × 2 gates, 3 bands × 100 steps, eval M = 20 000
    t1 = time.perf_counter()
    argv = ["--device", "cuda", "--starts", "2", "--gates", "X,H", "--curriculum",
            "0.4:100,0.7:100,1.0:100", "--eval_mc", "20000"]
    (rows, best), claunches = run_path(lambda: pc.main(argv), ["B1", "B2", "B3"])
    t_ceiling = time.perf_counter() - t1
    for g, fbest, fmean, j in rows:
        if not 0.0 < fmean <= fbest <= 1.0 or best[g].shape != (100, 4):
            raise AssertionError(f"ceiling {g}: best {fbest}, mean {fmean}, "
                                 f"{best[g].shape}")
    print(f"  ceiling (cut): " + ", ".join(f"{g} best {b:.4f}, mean {m:.4f}"
                                           for g, b, m, _ in rows)
          + f" in {t_ceiling:.2f} s; launches {claunches}")
    return {"launches": launches, "ceiling_launches": claunches, "t_cli": t_cli,
            "t_ceiling": t_ceiling, "step": prof, "gain": gain, "pulses0": pulses0, "q": q}


def dcrab_su2(dev) -> dict:
    """dCRAB: the CLI in grad mode at its widths (N = 2000, 600 time steps,
    200 samples, 5 rounds), DCRAB_STEPS Adam steps; the objective on the
    card against the CPU's on the same problem; ms per Adam step and its
    kernel launches; then nm mode at N = 12, 200 iterations.  No kernel of
    the port runs here: every counter must stay at 0."""
    from universal_quantum_optimal_control_tpu_torch.core.su2 import axis_angle_to_quat
    from universal_quantum_optimal_control_tpu_torch.optimizers import dcrab
    from universal_quantum_optimal_control_tpu_torch.workloads import dcrab_single_qubit as dcli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--device", "cuda", "--mode", "grad", "--steps", str(DCRAB_STEPS),
                "--out", f"{tmp}/grad.npz"]
        res, launches = run_path(lambda: dcli.main(argv), [])
        t_grad = time.perf_counter() - t0
        t1 = time.perf_counter()
        nargv = ["--device", "cuda", "--mode", "nm", "--n_modes", "12", "--maxiter", "200",
                 "--out", f"{tmp}/nm.npz"]
        nm, nlaunches = run_path(lambda: dcli.main(nargv), [])
        t_nm = time.perf_counter() - t1
    if any(launches.values()) or any(nlaunches.values()):
        raise AssertionError(f"dCRAB launched a kernel of the port: {launches} {nlaunches}")
    losses = res["losses"]
    if not (len(losses) == DCRAB_STEPS and losses[-1] < losses[0]):
        raise AssertionError(f"dCRAB infidelity did not fall: {losses[0]} → {losses[-1]}")
    for name, r in (("grad", res), ("nm", nm)):
        if not 0.0 < r["fidelity"] <= 2.0 / 3.0 + 1e-6:
            raise AssertionError(f"dCRAB {name} best fidelity {r['fidelity']} outside (0, 2/3]")

    # the objective on the card against the CPU's, on the CLI's problem
    cfg = dcrab.DcrabConfig(T=6.0, dt=0.01, n_modes=2000, rounds=5, samples=200, w_min=0.1,
                            w_max=2000 * np.pi, seed=42)
    q_t = axis_angle_to_quat(torch.tensor([1.0, 0.0, 0.0]), torch.tensor(math.pi / 2))
    cpu = dcrab._setup(q_t, cfg, device="cpu")
    card = dcrab.DcrabProblem(*(v.to(dev) for v in cpu))
    # at every round's start and at the CLI's best parameters (its round's ω)
    errs = []
    best = tuple(torch.from_numpy(np.asarray(res[k], np.float32)) for k in ("params", "omegas"))
    for x, w in ((cpu.x0, cpu.omegas), best):
        with torch.no_grad():
            a = dcrab.average_infidelity(x, cpu.t, w, cpu.q_target, cpu.delta, cpu.eps, cfg.dt)
            b = dcrab.average_infidelity(x.to(dev), card.t, w.to(dev), card.q_target,
                                         card.delta, card.eps, cfg.dt).cpu()
        errs.append(float((a - b).abs().max()))
    if not max(errs) <= DCRAB_TOL:
        raise AssertionError(f"dCRAB objective card vs CPU {max(errs):.3e} > {DCRAB_TOL}")

    # ms per Adam step and the launches it takes (the profiler's kernel count)
    dcrab.run_adam(card, cfg.dt, 1, 0.02)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    n = 5
    dcrab.run_adam(card, cfg.dt, n, 0.02)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / n
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        dcrab.run_adam(card, cfg.dt, 2, 0.02)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    kernels_per_step = sum(e.count for e in events) / 2
    dev_ms = sum(e.self_device_time_total for e in events) / 2e3
    print(f"  grad CLI: {DCRAB_STEPS} Adam steps, N = 2000, 600 time steps, 200 samples, 5 "
          f"rounds in {t_grad:.2f} s; summed infidelity {losses[0]:.5f} → {losses[-1]:.5f}; "
          f"best fidelity {res['fidelity']:.5f}; card vs CPU objective {max(errs):.2e} (tol "
          f"{DCRAB_TOL:.0e})")
    print(f"  Adam step: {step_ms:.2f} ms, {kernels_per_step:.0f} kernel launches, kernels "
          f"{dev_ms:.3f} ms ({100 * dev_ms / step_ms:.1f} % busy)")
    print(f"  nm CLI: N = 12, 200 iterations in {t_nm:.2f} s; best fidelity {nm['fidelity']:.5f}")
    return {"t_grad": t_grad, "t_nm": t_nm, "step_ms": step_ms, "kernels": kernels_per_step,
            "busy": dev_ms / step_ms, "err": max(errs), "losses": (losses[0], losses[-1])}


# Slice 4a: the mesh and the config-driven runner.  [mesh] runs 2 ranks of
# gloo on the one card (NCCL refuses two ranks on one device) at the flagship
# training shape; its gates: the sharded objective's value within MESH_VALUE_TOL
# of one process's B1 on the same draws, its gradient within MESH_GRAD_TOL of
# its largest entry, the CLI's steps' losses and E[F] and band 0's eval E[F]
# within MESH_LOSS_RTOL relative, later bands' eval E[F] within MESH_EVAL_RTOL.
MESH_LAYOUTS = ((1, 2), (2, 1))
MESH_SHAPE = (200, 100, 2, 1000)
MESH_VALUE_TOL = 2e-6
MESH_GRAD_TOL = 1e-5
MESH_LOSS_RTOL = 1e-4
# The eval E[F] after band 0 follows 2 to 4 Adam steps: their first updates
# are about lr·sign(g) entry by entry, so entries whose gradient is rounding
# noise move by ±lr either way, and the 1e-7 difference between one process
# and the mesh (the Monte-Carlo halves summed in another order, the rank's
# rows through the model as a batch of their own) grows.  On an H100 80GB
# HBM3 (700 W) sound meshes read up to 2.46e-4 relative there; a planted
# fault, an eval that averages only the rank's own block (no all-reduce),
# read 5.6e-4 and 7.3e-4 at 1 x 2, 1.5e-3 and 2.7e-3 at 2 x 1 (and 2.5e-4 and
# 2.6e-3 in band 0, above MESH_LOSS_RTOL).  MESH_EVAL_RTOL lies between.
MESH_EVAL_RTOL = 4e-4
MESH_RANK_TIMEOUT = 240
MESH_STEPS = 5  # timed train steps a rank after its CLI run
# the training CLI at the flagship's width, 2 steps a band (400 grid targets)
MESH_CLI_ARGV = ["--device", "cuda", "--backend", "pallas", "--num_epoch", "1",
                 "--batch_size", "200", "--monte_carlo", "1000", "--train_size", "400",
                 "--eval_size", "200"]
RUN_MC = 1 << 16  # the exports' E[F] through B1, printed as information
RUN_EXPORT_TOL = 1e-6  # the f32 export served against the trainer's eval pulses


def mesh_inputs(dev) -> dict:
    """The sharded objective's inputs at the flagship training shape: pulses
    in the flagship's box, unit targets, σ_δ = 1 and ε_std = 0.05 draws,
    per-target weights for the per-target objective."""
    B, L, P, M = MESH_SHAPE
    gen = torch.Generator(device=dev).manual_seed(23)
    u = torch.rand((B, L, P), generator=gen, device=dev)
    pulses = torch.stack([-math.pi + 2 * math.pi * u[..., 0], 0.1 + 0.4 * u[..., 1]], -1)
    q_t = torch.randn((B, 4), generator=gen, device=dev)
    return {"pulses": pulses.contiguous(), "q_t": (q_t / q_t.norm(dim=-1, keepdim=True)),
            "delta": torch.randn((B, M), generator=gen, device=dev),
            "eps": 0.05 * torch.randn((B, M), generator=gen, device=dev),
            "w": torch.rand((B,), generator=gen, device=dev) / B}


def params_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def mesh_rank(argv) -> int:
    """One rank of the [mesh] phase, started by :func:`mesh_phase` with the
    launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
    LOCAL_RANK): for each layout, the sharded objectives on its blocks, then
    the training CLI with ``--mesh``, its steps timed and a step's gloo
    all-reduce (the parameters' gradient) timed; then the ``--mesh 3,5`` probe.  Prints one line
    ``MESH_RANK {json}``."""
    import torch.distributed as dist
    from universal_quantum_optimal_control_tpu_torch.parallel import (
        DATA_AXIS, MC_AXIS, init_distributed, make_mean_fidelity, make_mesh, rank_device,
        shard_spec)
    from universal_quantum_optimal_control_tpu_torch.training import (
        CurriculumBand, SU2System, make_per_target_objective)
    from universal_quantum_optimal_control_tpu_torch.training import trainer as trainer_mod
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit

    in_path, out_dir = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = init_distributed()
    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    inp = {k: v.to(dev) for k, v in torch.load(in_path, weights_only=True).items()}
    writes = []
    save = trainer_mod.save_checkpoint

    def counted(*a, **k):
        writes.append(k.get("tag"))
        return save(*a, **k)

    trainer_mod.save_checkpoint = counted
    counters = su2_counters()
    report = {"rank": dist.get_rank(), "backend": backend, "device": str(dev), "layouts": {}}
    for data, mc in MESH_LAYOUTS:
        mesh = make_mesh(data=data, mc=mc)
        for c in counters.values():
            c.launches = 0
        # (a) the sharded objectives on this rank's blocks
        rows, block = shard_spec(mesh, DATA_AXIS), shard_spec(mesh, DATA_AXIS, MC_AXIS)
        r = mesh.block(MESH_SHAPE[0], DATA_AXIS)
        res = {}
        fn = make_mean_fidelity(mesh, "pallas")
        per = make_per_target_objective(mesh, SU2System("pallas").local_mean_fidelity)
        for name in ("mean_fidelity", "per_target"):
            p = rows(inp["pulses"]).requires_grad_(True)
            args = (rows(inp["q_t"]), block(inp["delta"]), block(inp["eps"]))
            if name == "mean_fidelity":
                v, scale = fn(p, *args), fn.grad_scale
                v.backward()
            else:
                v = mesh.gather(per(p, args[0], args[1:]), DATA_AXIS)
                torch.sum(inp["w"] * v).backward()
                scale = per.grad_scale
            full = torch.zeros_like(inp["pulses"])
            full[r] = p.grad
            res[name] = (v.detach(), mesh.all_reduce_(full) * scale)
        torch.save(res, Path(out_dir) / f"objective_{data}x{mc}_rank{mesh.rank}.pt")
        # (b) the training CLI with --mesh, then timed steps and all-reduces
        del writes[:]
        save_path = Path(out_dir) / f"cli_{data}x{mc}"
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tr, history = universal_single_qubit.run(universal_single_qubit.build_parser().parse_args(
            MESH_CLI_ARGV + ["--mesh", f"{data},{mc}", "--save_path", str(save_path)]))
        torch.cuda.synchronize()
        t_cli = time.perf_counter() - t1
        launches = {k: c.launches for k, c in counters.items()}
        rv, qt = inp["rv"], inp["qt"]
        band = CurriculumBand(1.0)
        tr.train_step(rv, qt, tr.sample_errors(rv.shape[0], band), dropout=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(MESH_STEPS):
            tr.train_step(rv, qt, tr.sample_errors(rv.shape[0], band), dropout=True)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t1) / MESH_STEPS
        # a step's one exchange: the parameters' gradient
        flat = torch.ones(sum(p.numel() for p in tr.model.parameters()), device=dev)
        mesh.all_reduce_(flat)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(MESH_STEPS):
            mesh.all_reduce_(flat)
        torch.cuda.synchronize()
        allreduce_ms = 1e3 * (time.perf_counter() - t1) / MESH_STEPS
        report["layouts"][f"{data}x{mc}"] = {
            "launches": launches, "t_cli": t_cli, "step_ms": step_ms,
            "allreduce_ms": allreduce_ms, "allreduce_mb": 4 * flat.numel() / 2 ** 20,
            "writes": list(writes), "digest": params_digest(tr.model),
            "bands": [{k: b[k] for k in ("step_loss", "step_fid", "eval_fid")}
                      for b in history["bands"]]}
    # (c) a mesh that is not the world size
    for probe in (lambda: make_mesh(data=3, mc=5),
                  lambda: universal_single_qubit.main(MESH_CLI_ARGV + ["--mesh", "3,5"])):
        try:
            probe()
        except ValueError as e:
            report.setdefault("probe", []).append(str(e))
        else:
            raise AssertionError("--mesh 3,5 on 2 ranks did not raise")
    print("MESH_RANK " + json.dumps(report), flush=True)
    dist.destroy_process_group()
    return 0


def mesh_phase(dev, tmp: Path) -> dict:
    """[mesh]: 2 ranks on this card over gloo, started with the launcher's
    environment as ``chip_smoke.py --mesh-rank``; the parent holds them to
    one process on the same inputs: the objectives to B1 here, the CLI to
    its one-process run, the ranks' parameters to each other, the writes to
    rank 0, the 3x5 probe to its ValueError."""
    import socket
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import mean_fidelity_cuda
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit

    inp = mesh_inputs(dev)
    rv, qt = build_su2_dataset(torch.Generator().manual_seed(31), MESH_SHAPE[0], random=True,
                               device=dev)
    inp.update(rv=rv, qt=qt)
    in_path = tmp / "mesh_inputs.pt"
    torch.save({k: v.cpu() for k, v in inp.items()}, in_path)
    # one process: B1 on the whole batch, and the CLI without --mesh
    want = {}
    for name in ("mean_fidelity", "per_target"):
        p = inp["pulses"].clone().requires_grad_(True)
        f = mean_fidelity_cuda(p, inp["q_t"], inp["delta"], inp["eps"])
        if name == "mean_fidelity":
            v = f.mean()
            v.backward()
        else:
            v = f
            torch.sum(inp["w"] * f).backward()
        want[name] = (v.detach(), p.grad)
    t1 = time.perf_counter()
    _, one = universal_single_qubit.run(universal_single_qubit.build_parser().parse_args(
        MESH_CLI_ARGV + ["--save_path", str(tmp / "cli_one")]))
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t1

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank", str(in_path),
             str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=str(Path(__file__).resolve().parent)))
    t1 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=MESH_RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.perf_counter() - t1
    reports = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if ln.startswith("MESH_RANK ")]
        if p.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"mesh rank {rank} exited {p.returncode}:\n{out[-4000:]}")
        reports.append(json.loads(lines[0][len("MESH_RANK "):]))
    if any(r["backend"] != "gloo" for r in reports):
        raise AssertionError(f"backends {[r['backend'] for r in reports]}, want gloo")
    out = {"reports": reports, "t_one": t_one, "t_ranks": t_ranks, "errs": {}, "launches": {}}
    for data, mc in MESH_LAYOUTS:
        key = f"{data}x{mc}"
        for rank in range(2):
            got = torch.load(tmp / f"objective_{key}_rank{rank}.pt", weights_only=True)
            for name, (v, g) in got.items():
                ev = float((v.to(dev) - want[name][0]).abs().max())
                g0 = want[name][1]
                eg = float((g.to(dev) - g0).abs().max()) / float(g0.abs().max())
                if not (ev <= MESH_VALUE_TOL and eg <= MESH_GRAD_TOL):
                    raise AssertionError(f"[mesh] {key} rank {rank} {name}: value err {ev:.3e} "
                                         f"(tol {MESH_VALUE_TOL}), gradient err {eg:.3e} of its "
                                         f"largest entry (tol {MESH_GRAD_TOL})")
                prev = out["errs"].get((key, name), (0.0, 0.0))
                out["errs"][(key, name)] = (max(prev[0], ev), max(prev[1], eg))
        lay = [r["layouts"][key] for r in reports]
        for rank, la in enumerate(lay):
            if min(la["launches"].values()) < 1:
                raise AssertionError(f"[mesh] {key} rank {rank}: a kernel was not launched: "
                                     f"{la['launches']}")
            # relative differences: the steps' and band 0's eval, then each
            # later band's eval (see MESH_EVAL_RTOL)
            worst, evals = 0.0, []
            for i, (b, b0) in enumerate(zip(la["bands"], one["bands"])):
                for k in ("step_loss", "step_fid", "eval_fid"):
                    a, w = np.asarray(b[k]), np.asarray(b0[k])
                    if a.shape != w.shape or not np.all(np.isfinite(a)):
                        raise AssertionError(f"[mesh] {key} rank {rank} {k}: {a} vs {w}")
                    rel = float(np.max(np.abs(a - w) / np.abs(w)))
                    if k == "eval_fid" and i > 0:
                        evals.append(rel)
                    else:
                        worst = max(worst, rel)
            la["rel"], la["rel_evals"], la["rel_eval"] = worst, evals, max(evals, default=0.0)
            if not (worst <= MESH_LOSS_RTOL and la["rel_eval"] <= MESH_EVAL_RTOL):
                raise AssertionError(
                    f"[mesh] {key} rank {rank}: steps' losses / E[F] and band 0's eval E[F] "
                    f"{worst:.3e} relative from one process (tol {MESH_LOSS_RTOL}), later "
                    f"bands' eval E[F] {evals} (tol {MESH_EVAL_RTOL}); mesh {la['bands']}; one "
                    f"process {[{k: b[k] for k in ('step_loss', 'step_fid', 'eval_fid')} for b in one['bands']]}")
        if lay[0]["digest"] != lay[1]["digest"]:
            raise AssertionError(f"[mesh] {key}: the ranks' parameters differ")
        if len(lay[0]["writes"]) != 3 or lay[1]["writes"]:
            raise AssertionError(f"[mesh] {key}: writes rank 0 {lay[0]['writes']}, "
                                 f"rank 1 {lay[1]['writes']}")
        out["launches"][f"mesh-{key}"] = {k: sum(la["launches"][k] for la in lay)
                                          for k in lay[0]["launches"]}
    for r in reports:
        if not all("mesh 3x5 != 2 devices" in m for m in r.get("probe", [])) or \
                len(r.get("probe", [])) != 2:
            raise AssertionError(f"[mesh] the 3x5 probe: {r.get('probe')}")
    return out


def run_phase(dev, tmp: Path) -> dict:
    """[run]: ``workloads/run.py`` on a RunConfig of the flagship's widths
    (configs/universal_single_qubit.json, f32, ``backend`` pallas, batch 200,
    M = 1000, 3 bands of 2 steps), band 2 exported in f32, f16 and int8;
    the f32 export served through the demo's loader against the trainer's
    eval-mode pulses, the f16 and int8 exports against a numpy round trip of
    the trainer's weights, each export's E[F] through B1."""
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.data import (build_su2_dataset,
                                                                  named_gate_rotation_vectors)
    from universal_quantum_optimal_control_tpu_torch.demo.app import load_pipeline
    from universal_quantum_optimal_control_tpu_torch.models import (
        UniversalQOCTransformer, load_params_npz, params_to_jax)
    from universal_quantum_optimal_control_tpu_torch.models.serialization import _quantize_int8
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import mean_fidelity_cuda
    from universal_quantum_optimal_control_tpu_torch.training import restore_checkpoint
    from universal_quantum_optimal_control_tpu_torch.utils import load_model_params
    from universal_quantum_optimal_control_tpu_torch.workloads import (export_npz, run,
                                                                       universal_single_qubit)

    model_json = load_model_params(universal_single_qubit.DEFAULT_CONFIG)
    model_json["finetune"] = False
    model_json["dtype"] = "float32"
    cfg = {"workload": "universal_single_qubit", "model": model_json,
           "train": {"backend": "pallas", "batch_size": 200, "monte_carlo": 1000, "epochs": 1},
           "train_set_size": 400, "eval_set_size": 200, "save_path": str(tmp / "run")}
    path = tmp / "run.json"
    path.write_text(json.dumps(cfg))
    counters = su2_counters()
    for c in counters.values():
        c.launches = 0
    t1 = time.perf_counter()
    best, history = run.main([str(path), "--device", "cuda"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t1
    steps = [x for b in history["bands"] for x in b["step_loss"]]
    if len(history["bands"]) != 3 or len(steps) != 6 or not all(map(math.isfinite, steps)):
        raise AssertionError(f"run.py: {history}")
    tag = "band2_delta1_eps0.05"
    params, meta = restore_checkpoint(str(tmp / "run"), tag)
    model = UniversalQOCTransformer(**{**model_json, "dtype": torch.float32}, device=dev)
    model.load_state_dict(params)
    model.eval()
    gates = named_gate_rotation_vectors(device=dev)
    rng = np.random.default_rng(29)
    axes = rng.standard_normal((3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rv = torch.cat([torch.stack(list(gates.values())), torch.tensor(
        np.concatenate([axes, rng.uniform(0, 2 * np.pi, (3, 1))], 1), dtype=torch.float32,
        device=dev)])
    with torch.no_grad():
        want = model(rv)
    flat = params_to_jax(params, meta["model"]["n_heads"])
    gen = torch.Generator(device=dev).manual_seed(37)
    d = torch.randn((8, RUN_MC), generator=gen, device=dev)
    e = 0.05 * torch.randn((8, RUN_MC), generator=gen, device=dev)
    q = rotation_vector_to_quat(rv)
    res = {"t_run": t_run, "best": best, "exports": {}}
    for dtype in ("f32", "f16", "int8"):
        out = str(tmp / f"band2_{dtype}.npz")
        t1 = time.perf_counter()
        export_npz.main([f"{tmp / 'run'}:{tag}", out, "--dtype", dtype])
        t_export = time.perf_counter() - t1
        got = load_params_npz(out)
        if set(got) != set(flat):
            raise AssertionError(f"{dtype} export keys differ")
        if dtype == "f32":
            pulses = load_pipeline("length_100", checkpoint=out, device=dev,
                                   dtype=torch.float32)(rv)
            err = float((pulses - want).abs().max())
            if not err <= RUN_EXPORT_TOL:
                raise AssertionError(f"f32 export served {err:.3e} from the trainer's pulses")
        else:
            for k, v in flat.items():
                if dtype == "int8" and v.ndim >= 2 and v.size >= 4096:
                    qv, scale = _quantize_int8(v)
                    ref = qv.astype(np.float32) * scale
                else:
                    ref = v.astype(np.float16).astype(np.float32)
                if not np.array_equal(got[k], ref):
                    raise AssertionError(f"{dtype} export {k} differs from the numpy round trip")
            err = 0.0
            pulses = load_pipeline("length_100", checkpoint=out, device=dev,
                                   dtype=torch.float32)(rv)
        ef = mean_fidelity_cuda(pulses.contiguous(), q, d, e)
        res["exports"][dtype] = {"err": err, "t_export": t_export,
                                 "mb": Path(out).stat().st_size / 2 ** 20,
                                 "ef": ef.tolist()}
    torch.cuda.synchronize()
    res["launches"] = {k: c.launches for k, c in counters.items()}
    if min(res["launches"].values()) < 1:
        raise AssertionError(f"[run] a kernel was not launched: {res['launches']}")
    # the training shape's pulses for the time phase: the trained model on 200
    # random targets
    rv200, res["q"] = build_su2_dataset(torch.Generator().manual_seed(41), 200, random=True,
                                        device=dev)
    with torch.no_grad():
        res["pulses"] = model(rv200).contiguous()
    return res


# [viz] and [viz-su4]: the figures' numbers at the demo's settings
VIZ_AXIS = (1.0, 0.0, 0.0, math.pi)  # the demo's defaults: X(π)
VIZ_MC = 10_000  # the demo's and the figures' M
VIZ_BLOCH_SAMPLES = 12  # the demo's animation
VIZ_SE_K = 5  # Monte-Carlo values held within 5 combined standard errors
VIZ_MODEL_T_TOL = 0.01  # the model's total time, π units, card against CPU
VIZ_SCORE_SIGMAS = (0, 99, 198)  # σ_δ 0.01, 1.00, 1.99: the long tables' subset
# gate_parity_curves("length_100", monte_carlo=10000) of the JAX package on
# the CPU, from
#   JAX_PLATFORMS=cpu python -c "from universal_quantum_optimal_control_tpu.analysis \
#       import parity_figure as p; print(p.gate_parity_curves('length_100', \
#       monte_carlo=10000, stds=[1.0]))"
# (its E[F] at σ_δ = 1 does not depend on the sweep's stds): gate → {label:
# (E[F], SE, total time in π units)}; SCORE's time as numpy sums it
JAX_PARITY = {
    "X": {"model": (0.947708, 0.001178, 6.776845),
          "SCORE": (0.737086, 0.002528, 14.994160681563658)},
    "X(pi/2)": {"model": (0.949458, 0.001182, 6.594214),
                "SCORE": (0.72052, 0.002601, 14.493039719770605)},
    "Y": {"model": (0.947708, 0.001178, 6.776845),
          "SCORE": (0.737086, 0.002528, 14.994160681563658)},
    "Z(pi/4)": {"model": (0.948931, 0.001225, 6.779712),
                "SCORE": (0.71709, 0.0026, 73.2031577361541)},
    "H": {"model": (0.949793, 0.001175, 6.478209),
          "SCORE": (0.707063, 0.002581, 29.487197972822557)},
}
# docs/model_vs_score_length100.md (the JAX package's published table):
# gate → (model E[F], SCORE E[F]) at σ_δ = 1
DOCS_PARITY = {"X": (0.9477, 0.7371), "X(pi/2)": (0.9494, 0.7205), "Y": (0.9477, 0.7371),
               "Z(pi/4)": (0.9490, 0.7171), "H": (0.9500, 0.7071)}
VIZ4_MC = 2000  # the bundle figure's and the two-qubit demo's M
VIZ4_SIGMAS = (1, 3, 5)  # the bundle figure's σ_δ 0.1, 0.2, 0.3
# render_bundle_figure(two_qubit_gates.npz, ..., monte_carlo=2000) of the JAX
# package on the CPU (seed 0), from
#   JAX_PLATFORMS=cpu python -m \
#       universal_quantum_optimal_control_tpu.analysis.two_qubit_bundle_figure \
#       --out /tmp/bundle.png
# gate → {σ_δ: (E[F], SE)}
JAX_BUNDLE_CURVES = {
    "cz": {"0.10": (0.979157, 0.000568), "0.20": (0.907171, 0.00273),
           "0.30": (0.764124, 0.005191)},
    "zz(pi/4)": {"0.10": (0.98659, 0.000356), "0.20": (0.935284, 0.002086),
                 "0.30": (0.814876, 0.004549)},
    "cnot": {"0.10": (0.977308, 0.000559), "0.20": (0.916444, 0.002445),
             "0.30": (0.784017, 0.005002)},
    "iswap": {"0.10": (0.978081, 0.000544), "0.20": (0.913015, 0.00247),
              "0.30": (0.777401, 0.004886)},
    "sqrt_swap": {"0.10": (0.983637, 0.000419), "0.20": (0.92673, 0.002281),
                  "0.30": (0.797175, 0.004838)},
}


def su2_fid_plain(p, q_t, delta, eps, dtype):
    """F of one ``(L, P)`` table on flat samples through B3's plain version
    in ``dtype``."""
    from universal_quantum_optimal_control_tpu_torch.core.su2 import quat_fidelity
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import \
        propagate_mc_plain
    q = propagate_mc_plain(p[None].to(dtype), delta.reshape(1, -1).to(dtype),
                           eps.reshape(1, -1).to(dtype))[0]
    return quat_fidelity(q, q_t[None].to(dtype))


def plain_rule(kernel, plain32, plain64, floor: float = FID_TOL):
    """The L ≥ 100 rule: |kernel − plain f32| within the larger of ``floor``
    and twice the plain f32 version's own error against f64.  Returns
    ``(err, tol)``."""
    return max_err(kernel, plain32), max(floor, 2 * max_err(plain32, plain64))


def viz_su2(dev) -> dict:
    """[viz]: the single-qubit figures' numbers at the demo's defaults, each
    B3 output held to its plain version, the Bloch endpoints to B3's product
    and the parity E[F] to the JAX package's CPU values."""
    from universal_quantum_optimal_control_tpu_torch.analysis import (bloch, compare,
                                                                      parity_figure, plots)
    from universal_quantum_optimal_control_tpu_torch.analysis.score_pulses import \
        build_score_pulses
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.core.errors import sample_ore_ple
    from universal_quantum_optimal_control_tpu_torch.data import named_gate_rotation_vectors
    from universal_quantum_optimal_control_tpu_torch.demo import app
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import \
        propagate_mc_cuda

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def run():
        out = {"tables": {}, "bloch": {}}
        for v in ("length_100", "length_100_p4"):
            p, q = app.compute_pulses(v, *VIZ_AXIS, device=dev)
            out["tables"][v] = (torch.as_tensor(p, device=dev).contiguous(), q.to(dev))
            d, e = sample_ore_ple(gen(2031), (VIZ_BLOCH_SAMPLES,), 0.5, 0.05)
            traj = bloch.bloch_trajectories(p, d, e, device=dev)
            ef = plots._mc_stats(out["tables"][v][0], q.to(dev), d, e)[0]  # the animation's E[F]
            out["bloch"][v] = (d, e, traj, float(ef))
            out[f"sweep {v}"] = plots.fidelity_by_std(p, q, monte_carlo=VIZ_MC,
                                                      generator=gen(2030), device=dev)
        p, q = out["tables"]["length_100"]
        out["grid"] = plots.fidelity_grid(p, q, device=dev)
        out["estimate"] = plots.mc_fidelity_estimate(p, q, 1.0, 0.05, VIZ_MC, device=dev)
        out["parity"] = parity_figure.gate_parity_curves("length_100", monte_carlo=VIZ_MC,
                                                         device=dev)
        score = build_score_pulses(dict(parity_figure.GATE_TO_SCORE))
        out["compare"] = compare.compare_pulse_strategies(
            {"model": p.cpu().numpy(), "SCORE": score["X"]}, q, monte_carlo=VIZ_MC,
            device=dev)[0]
        out["score"] = score
        return out

    t0 = time.perf_counter()
    out, launches = run_path(run, ["B3"])
    t_path = time.perf_counter() - t0
    p, q = out["tables"]["length_100"]
    L = p.shape[0]
    checks = {}
    # the grid: 1000 × 50 samples in one B3 launch, against its plain version
    dg, eg, F = out["grid"]
    dd, ee = torch.meshgrid(torch.as_tensor(dg, device=dev), torch.as_tensor(eg, device=dev),
                            indexing="ij")
    F = torch.as_tensor(F, device=dev).reshape(-1)
    checks["grid"] = plain_rule(F, *(su2_fid_plain(p, q, dd, ee, dt)
                                     for dt in (torch.float32, torch.float64)))
    # the sweeps: 199 σ × 10 000 samples in one B3 launch, mean and SE
    # against the plain version on the same draws
    for v in ("length_100", "length_100_p4"):
        pv, qv = out["tables"][v]
        stds, mean, se = out[f"sweep {v}"]
        nd, ne = plots._sweep_draws(gen(2030), len(stds), VIZ_MC, 0.05)
        st = torch.as_tensor(stds, device=dev)[:, None]
        ref = [su2_fid_plain(pv, qv, nd * st, ne, dt).reshape(len(stds), -1)
               for dt in (torch.float32, torch.float64)]
        got = torch.as_tensor(np.stack([mean, se]), device=dev)
        checks[f"sweep {v}"] = plain_rule(got, *(torch.stack(
            [r.mean(1), r.std(1, correction=0) / math.sqrt(VIZ_MC)]) for r in ref))
        if not (np.all(np.isfinite(mean)) and 0 < mean.min() and mean.max() <= 1
                and mean[-1] < mean[0]):
            raise AssertionError(f"{v} E[F](sigma) outside (0, 1] or not falling: {mean}")
    # the longest SCORE table (Z(π/4), L = 2019) on a subset of σ: the
    # parity sweep's values against the plain version on its draws
    zp = torch.as_tensor(out["score"]["Z(pi/4)"], device=dev).contiguous()
    zsweep = out["parity"]["Z(pi/4)"]["SCORE"]
    sub = list(VIZ_SCORE_SIGMAS)
    zs = torch.as_tensor(zsweep["stds"][sub], device=dev)
    qz = rotation_vector_to_quat(named_gate_rotation_vectors(device=dev)["Z(pi/4)"])
    nd, ne = plots._sweep_draws(gen(0), 199, VIZ_MC, 0.05)
    ref = [su2_fid_plain(zp, qz, nd[sub] * zs[:, None], ne[sub], dt).reshape(len(sub), -1)
           for dt in (torch.float32, torch.float64)]
    got = torch.as_tensor(np.stack([zsweep["mean"][sub], zsweep["se"][sub]]), device=dev)
    checks["SCORE Z(pi/4) subset"] = plain_rule(got, *(torch.stack(
        [r.mean(1), r.std(1, correction=0) / math.sqrt(VIZ_MC)]) for r in ref))
    # Bloch: each endpoint against B3's product rotated onto ẑ (a check
    # launch, outside the path's count)
    for v, (d, e, traj, _) in out["bloch"].items():
        pv, _ = out["tables"][v]
        qk = propagate_mc_cuda(pv[None], d[None].contiguous(), e[None].contiguous())[0]
        end_k = bloch.quat_rotation_matrix(qk)[..., 2]
        ends = [bloch._trajectories(pv.to(dt), d.to(dt), e.to(dt),
                                    torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev))[:, -1]
                for dt in (torch.float32, torch.float64)]
        if not np.allclose(traj[:, -1], ends[0].cpu().numpy(), atol=1e-7, rtol=0):
            raise AssertionError(f"{v}: bloch_trajectories differs from its own rerun")
        checks[f"bloch {v}"] = plain_rule(end_k, *ends)
    for name, (err, tol) in checks.items():
        if not err <= tol:
            raise AssertionError(f"[viz] {name}: kernel against plain {err:.3e} > {tol:.2e}")
    # the parity E[F] against the JAX package's CPU values
    worst_k, worst_t = 0.0, 0.0
    for gate, entry in out["parity"].items():
        row_ = []
        for label in ("model", "SCORE"):
            e = entry[label]
            ef_j, se_j, t_j = JAX_PARITY[gate][label]
            k = abs(e["EF"] - ef_j) / math.hypot(e["EF_se"], se_j)
            worst_k = max(worst_k, k)
            if not k <= VIZ_SE_K:
                raise AssertionError(f"parity {gate} {label}: E[F] {e['EF']:.5f} vs JAX CPU "
                                     f"{ef_j:.5f}, {k:.2f} combined SE")
            if label == "SCORE" and e["total_time_pi"] != t_j:
                raise AssertionError(f"parity {gate} SCORE T {e['total_time_pi']!r} != {t_j!r}")
            dt_ = abs(e["total_time_pi"] - t_j)
            if label == "model":
                worst_t = max(worst_t, dt_)
                if not dt_ <= VIZ_MODEL_T_TOL:
                    raise AssertionError(f"parity {gate} model T {e['total_time_pi']:.4f}π vs "
                                         f"CPU {t_j:.4f}π")
            row_.append(f"{label} {e['EF']:.4f}±{e['EF_se']:.4f} (JAX CPU {ef_j:.4f}, docs "
                        f"{DOCS_PARITY[gate][label == 'SCORE']:.4f}), T {e['total_time_pi']:.2f}π")
        print(f"  parity {gate}: " + "; ".join(row_))
    # compare: the same functions on the same draws give the parity's X
    # (the same pulses and draws: equal but for the reductions' order)
    cmp_, px = out["compare"], out["parity"]["X"]
    for label in ("model", "SCORE"):
        if not (abs(cmp_[label]["EF"] - px[label]["EF"]) <= 1e-6
                and np.abs(cmp_[label]["mean"] - px[label]["mean"]).max() <= 1e-6):
            raise AssertionError(f"compare {label} differs from the parity's X on the same draws")
    est = out["estimate"]
    if not (abs(est[0] - px["model"]["EF"]) <= 1e-6 and abs(est[1] - px["model"]["EF_se"]) <= 1e-6):
        raise AssertionError(f"mc_fidelity_estimate {est} differs from the parity's X model")
    for name, (err, tol) in checks.items():
        print(f"  {name}: kernel vs plain {err:.2e} (tol {tol:.2e})")
    for v, (d, e, traj, ef) in out["bloch"].items():
        print(f"  bloch {v}: {traj.shape}, endpoint z mean {traj[:, -1, 2].mean():+.4f}, "
              f"E[F] of the ensemble {ef:.4f}")
    s100 = out["sweep length_100"]
    s4 = out["sweep length_100_p4"]
    print(f"  X(pi) E[F] {est[0]:.5f} ± {est[1]:.5f}; sweep at sigma 0.5 / 1.0 / 1.99: "
          f"length_100 {s100[1][49]:.4f} / {s100[1][99]:.4f} / {s100[1][198]:.4f}, "
          f"length_100_p4 {s4[1][49]:.4f} / {s4[1][99]:.4f} / {s4[1][198]:.4f}; grid F "
          f"at the centre {out['grid'][2][500, 25]:.5f}")
    shapes = {"grid": (1, L, 2, dd.numel()), "estimate": (1, L, 2, VIZ_MC),
              "sweep": (1, L, 2, 199 * VIZ_MC),
              "sweep-p4": (1, out["tables"]["length_100_p4"][0].shape[0], 4, 199 * VIZ_MC),
              "score": (1, zp.shape[0], 2, 199 * VIZ_MC)}
    return {"launches": launches, "t_path": t_path, "checks": checks, "worst_k": worst_k,
            "worst_t": worst_t, "tables": out["tables"], "score_z": zp, "q_z": qz,
            "bloch": out["bloch"],
            "shapes": shapes}


def viz_su4(dev) -> dict:
    """[viz-su4]: the bundle figure's curves (B7) against the JAX package's
    CPU values, and the two-qubit demo's grid and sweep of two_qubit_d2_kak
    CZ and cz_drive2, each against its plain version."""
    from universal_quantum_optimal_control_tpu_torch.analysis import (plots_su4,
                                                                      two_qubit_bundle_figure)
    from universal_quantum_optimal_control_tpu_torch.core.su4 import fidelity_su4_ri
    from universal_quantum_optimal_control_tpu_torch.demo import app
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import \
        propagate_su4_mc_plain
    from universal_quantum_optimal_control_tpu_torch.workloads.finetune_two_qubit_gates import \
        load_two_qubit_gate_bundle

    bundle = two_qubit_bundle_figure._DEFAULT_BUNDLE
    demos = (("two_qubit_d2_kak", "cz"), ("cz_drive2", "cz"))

    def run():
        curves = two_qubit_bundle_figure.bundle_curves(bundle, monte_carlo=VIZ4_MC, device=dev)
        demo = {}
        for v, g in demos:
            r = app.two_qubit_robustness(v, g, monte_carlo=VIZ4_MC, device=dev)
            r["grid"] = plots_su4.fidelity_grid_su4(r["pulses"], r["u_target"], r["system"],
                                                    n_delta=61, device=dev)
            demo[v] = r
        return curves, demo

    t0 = time.perf_counter()
    (curves, demo), launches = run_path(run, ["B7"])
    t_path = time.perf_counter() - t0
    worst_k = 0.0
    for g, (s, mean, se) in curves.items():
        ref = JAX_BUNDLE_CURVES[g]
        cells = []
        for i in VIZ4_SIGMAS:
            ef_j, se_j = ref[f"{s[i]:.2f}"]
            k = abs(mean[i] - ef_j) / math.hypot(se[i], se_j)
            worst_k = max(worst_k, k)
            if not k <= VIZ_SE_K:
                raise AssertionError(f"bundle {g} sigma {s[i]:.2f}: {mean[i]:.5f} vs JAX CPU "
                                     f"{ef_j:.5f}, {k:.2f} combined SE")
            cells.append(f"{s[i]:.2f}: {mean[i]:.4f}±{se[i]:.4f} (JAX CPU {ef_j:.4f})")
        print(f"  bundle {g}: " + "; ".join(cells))
    checks = {}
    for v, r in demo.items():
        p = torch.as_tensor(r["pulses"], dtype=torch.float32, device=dev)[None].contiguous()
        tr, ti = plots_su4._as_packed(r["u_target"], dev)
        sys_ = r["system"]
        dg, F = r["grid"]
        g1, g2 = (x.reshape(1, -1) for x in torch.meshgrid(
            torch.as_tensor(dg, device=dev), torch.as_tensor(dg, device=dev), indexing="ij"))
        ref = []
        for dt in (torch.float32, torch.float64):
            U = propagate_su4_mc_plain(p.to(dt), g1.to(dt), g2.to(dt),
                                       torch.zeros_like(g1, dtype=dt), sys_)
            ref.append(fidelity_su4_ri(U[0][0], U[1][0], tr.to(dt), ti.to(dt)))
        checks[f"grid {v}"] = plain_rule(torch.as_tensor(F, device=dev).reshape(-1), *ref,
                                         floor=SU4_PROD_TOL)
        S = len(r["stds"])
        n1, n2, ne = plots_su4._sweep_draws(torch.Generator(device=dev).manual_seed(0), S,
                                            VIZ4_MC, 0.05)
        st = torch.as_tensor(r["stds"], device=dev)[:, None]
        U = propagate_su4_mc_plain(p, (n1 * st).reshape(1, -1), (n2 * st).reshape(1, -1),
                                   ne.reshape(1, -1), sys_)
        Fs = fidelity_su4_ri(U[0][0], U[1][0], tr, ti).reshape(S, -1)
        err = max(float(np.abs(r["mean"] - Fs.mean(1).cpu().numpy()).max()),
                  float(np.abs(r["se"] - (Fs.std(1, correction=0)
                                          / math.sqrt(VIZ4_MC)).cpu().numpy()).max()))
        checks[f"sweep {v}"] = (err, SU4_SWEEP_TOL)
        print(f"  {r['label']} {tuple(p.shape[1:])}: E[F] at sigma 0.1 / 0.2 / 0.4 "
              f"{r['mean'][4]:.4f} / {r['mean'][9]:.4f} / {r['mean'][19]:.4f}; grid F at the "
              f"centre {F[30, 30]:.5f}")
    for name, (err, tol) in checks.items():
        print(f"  {name}: kernel vs plain {err:.2e} (tol {tol:.2e})")
        if not err <= tol:
            raise AssertionError(f"[viz-su4] {name}: kernel against plain {err:.3e} > {tol:.2e}")
    return {"launches": launches, "t_path": t_path, "checks": checks, "worst_k": worst_k,
            "demo": demo, "bundle_pulses": load_two_qubit_gate_bundle(bundle)[0],
            "n_sigmas": len(next(iter(curves.values()))[0])}


def main() -> int:
    t_total = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2:])

    from universal_quantum_optimal_control_tpu_torch.analysis import mc_fidelity_estimate
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.data import named_gate_rotation_vectors
    from universal_quantum_optimal_control_tpu_torch.demo.app import (compute_pulses,
                                                                      load_pipeline)
    from universal_quantum_optimal_control_tpu_torch.ops import _build
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        mean_fidelity_cuda, mean_fidelity_plain, propagate_mc_cuda, propagate_mc_plain,
        propagate_mc_vjp_cuda, propagate_mc_vjp_plain)
    from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.utils import load_model_params
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit
    from universal_quantum_optimal_control_tpu_torch.analysis import plots_su4
    from universal_quantum_optimal_control_tpu_torch.core.su4 import fidelity_su4_ri
    from universal_quantum_optimal_control_tpu_torch.data import z4_representatives
    from universal_quantum_optimal_control_tpu_torch.demo.app import two_qubit_model_kwargs
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import (
        mean_fidelity_su4_cuda, mean_fidelity_su4_plain, mean_fidelity_su4_with_product_cuda,
        mean_fidelity_su4_with_product_plain, propagate_su4_mc_cuda, propagate_su4_mc_plain,
        propagate_su4_plan, su4_objective_vjp_cuda, su4_objective_vjp_from_product_cuda,
        su4_objective_vjp_from_product_plain, su4_objective_vjp_plain)
    from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
    from universal_quantum_optimal_control_tpu_torch.training import SU4System
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    t0 = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, f"{kind}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_libraries()
    for name, b in built.items():
        _build.load_library(name)
        print(f"  {name}: nvcc {'cached' if b['cached'] else 'built'} {b['path']} in "
              f"{b['seconds']:.2f} s")
        for line in b["log"].splitlines():
            if any(k in line for k in ("registers", "Compiling entry", "spill")):
                print("    " + line.strip())
    ptx = ptxas_table(built)
    phase("build", t0, f"{len(built)} libraries, one nvcc call each, started together")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst_f, worst_q, worst_g, worst_fg = 0.0, 0.0, [0.0] * 3, [0.0] * 3
    worst64 = [0.0] * 4  # at L = 100 against f64: B1 kernel, plain; B3 kernel, plain
    for P in (2, 3, 4):
        for L in (1, 7, 100):
            for M in (1000, 1 << 16):
                pulses, q_t, delta, eps = random_inputs(gen, 3, L, P, M, dev)
                case = f"P={P} L={L} M={M}"
                f_k = mean_fidelity_cuda(pulses, q_t, delta, eps)
                f_p = mean_fidelity_plain(pulses, q_t, delta, eps)
                q_k = propagate_mc_cuda(pulses, delta, eps)
                q_p = propagate_mc_plain(pulses, delta, eps)
                torch.cuda.synchronize()
                err_f = float((f_k - f_p).abs().max())
                err_q = float((q_k - q_p).abs().max())
                err_n = float((q_k.norm(dim=-1) - 1.0).abs().max())
                same_sign = bool(((q_k * q_p).sum(-1) > 0).all())
                if not err_f <= FID_TOL:
                    raise AssertionError(f"B1 {case}: |F kernel - plain| {err_f:.3e} > {FID_TOL}")
                if not (err_q <= quat_tol(L) and err_n <= quat_tol(L)):
                    raise AssertionError(
                        f"B3 {case}: |q kernel - plain| {err_q:.3e}, | |q| - 1 | "
                        f"{err_n:.3e}, tolerance {quat_tol(L):.0e}")
                if not same_sign:
                    raise AssertionError(f"B3 {case}: quaternion sign differs from plain")
                worst_f, worst_q = max(worst_f, err_f), max(worst_q, err_q)
                vs64 = ""
                if L == 100:  # kernel and plain f32 against the plain version in f64
                    a64 = [t.double() for t in (pulses, q_t, delta, eps)]
                    f64 = mean_fidelity_plain(*a64)
                    q64 = propagate_mc_plain(a64[0], *a64[2:])
                    e64 = (max_err(f_k, f64), max_err(f_p, f64), max_err(q_k, q64),
                           max_err(q_p, q64))
                    worst64 = [max(w, e) for w, e in zip(worst64, e64)]
                    vs64 = (f" (vs f64: B1 kernel {e64[0]:.2e}, plain {e64[1]:.2e}; B3 kernel "
                            f"{e64[2]:.2e}, plain {e64[3]:.2e})")
                g = torch.randn((3, M, 4), generator=gen, device=dev)
                e2, _, _ = check_vjp(case, pulses, delta, eps, g)
                e1 = check_mean_fidelity_grad(case, pulses, q_t, delta, eps, gen)
                worst_g = [max(w, e) for w, e in zip(worst_g, e2)]
                worst_fg = [max(w, e) for w, e in zip(worst_fg, e1)]
                print(f"  {case}: B1 err {err_f:.2e}  B3 err {err_q:.2e}{vs64} "
                      f"norm err {err_n:.2e}  B2 err {e2[0]:.2e} (vs f64: kernel "
                      f"{e2[1]:.2e}, plain {e2[2]:.2e})  B1 grad err {e1[0]:.2e} "
                      f"(vs f64: {e1[1]:.2e}, {e1[2]:.2e})")
    # P = 4 at L = 400 (25 KB of shared memory) and L = 1000 (64 KB: B2
    # opts in past 48 KB)
    for L in (400, 1000):
        pulses, _, delta, eps = random_inputs(gen, 2, L, 4, 1000, dev)
        g = torch.randn((2, 1000, 4), generator=gen, device=dev)
        e2, _, _ = check_vjp(f"P=4 L={L} M=1000", pulses, delta, eps, g)
        worst_g = [max(w, e) for w, e in zip(worst_g, e2)]
        print(f"  P=4 L={L} M=1000: B2 err {e2[0]:.2e} (vs f64: kernel {e2[1]:.2e}, "
              f"plain {e2[2]:.2e})")
    phase("check", t0, f"18 cases + B2 at L=400, 1000; worst B1 {worst_f:.3e} (tol "
          f"{FID_TOL:.0e}), worst B3 {worst_q:.3e} (tol max(1e-5, 1e-6 L)), worst B2 "
          f"{worst_g[0]:.3e} and B1 gradient {worst_fg[0]:.3e} against plain (rtol "
          f"{GRAD_RTOL:.0e}, atol max(1e-4 / 1e-5, 2× the plain f32 error)); against "
          f"f64: B1 kernel {worst64[0]:.3e} / plain {worst64[1]:.3e} and B3 kernel "
          f"{worst64[2]:.3e} / plain {worst64[3]:.3e} at L = 100, B2 kernel "
          f"{worst_g[1]:.3e} / plain {worst_g[2]:.3e}, B1 gradient "
          f"kernel {worst_fg[1]:.3e} / plain {worst_fg[2]:.3e}")

    # 4. check-su4: B7 and B6 against their plain versions; at L = 100 the
    # tolerance is the larger of the JAX suite's and twice the plain f32
    # version's own error against f64 on the same inputs
    t0 = time.perf_counter()
    worst_u, worst_f4 = 0.0, 0.0
    for P in (2, 3, 4):
        for L in (1, 7, 100):
            for M in (200, 1 << 14):
                case = f"P={P} L={L} M={M}"
                pulses, tr, ti, d1, d2, ep, sys4 = su4_random_inputs(gen, 3, L, P, M, dev)
                U_k = propagate_su4_mc_cuda(pulses, d1, d2, ep, sys4)
                F_k = mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys4)
                U_p = propagate_su4_mc_plain(pulses, d1, d2, ep, sys4)
                F_p = mean_fidelity_su4_plain(pulses, tr, ti, d1, d2, ep, sys4)
                torch.cuda.synchronize()
                err_u, err_f = max_err(U_k, U_p), max_err(F_k, F_p)
                tol_u, tol_f, e64_u, e64_f = SU4_PROD_TOL, SU4_FID_TOL[P], None, None
                if L > 7:
                    args64 = [t.double() for t in (pulses, tr, ti, d1, d2, ep)]
                    e64_u = max_err(U_p, propagate_su4_mc_plain(*args64[:1], *args64[3:], sys4))
                    e64_f = max_err(F_p, mean_fidelity_su4_plain(*args64, sys4))
                    tol_u, tol_f = max(tol_u, 2 * e64_u), max(tol_f, 2 * e64_f)
                if not err_u <= tol_u:
                    raise AssertionError(f"B7 {case}: |U kernel - plain| {err_u:.3e} > {tol_u:.2e}")
                if not err_f <= tol_f:
                    raise AssertionError(f"B6 {case}: |F kernel - plain| {err_f:.3e} > {tol_f:.2e}")
                worst_u, worst_f4 = max(worst_u, err_u), max(worst_f4, err_f)
                vs64 = "" if e64_u is None else (f"; plain vs f64: U {e64_u:.2e}, "
                                                 f"F {e64_f:.2e}")
                print(f"  {case}: B7 err {err_u:.2e} (tol {tol_u:.1e}, plan "
                      f"{propagate_su4_plan(3, M, L)})  B6 err {err_f:.2e} (tol {tol_f:.1e}){vs64}")
    phase("check-su4", t0, f"18 cases; worst B7 {worst_u:.3e}, worst B6 {worst_f4:.3e} "
          f"against plain (tol {SU4_PROD_TOL:.0e} / {SU4_FID_TOL[2]:.0e}, "
          f"{SU4_FID_TOL[4]:.0e} drive2; at L = 100 max of those and 2× the plain f32 "
          f"error against f64)")

    # 5. check-su4-train: B4, B5 and B8 against their plain versions; no path
    # runs B8, so its row reports this phase's launches
    t0 = time.perf_counter()
    su4_objective_vjp_cuda.launches = 0
    msg = check_su4_train(gen, dev)
    check_launches = {"B8": su4_objective_vjp_cuda.launches}
    phase("check-su4-train", t0, f"{msg}; launches {check_launches}")

    # 6. serve — the main path starts here: counters to 0
    mean_fidelity_cuda.launches = 0
    propagate_mc_cuda.launches = 0
    t0 = time.perf_counter()
    gates = named_gate_rotation_vectors(device=dev)
    rng = np.random.default_rng(7)
    axes = rng.standard_normal((3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rand_rv = np.concatenate([axes, rng.uniform(0.0, 2 * np.pi, (3, 1))], axis=1)
    rv = torch.cat([torch.stack(list(gates.values())),
                    torch.tensor(rand_rv, dtype=torch.float32, device=dev)])
    served = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t1 = time.perf_counter()
        pipe = load_pipeline("length_100", dtype=dtype)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        pipe(rv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            pulses = pipe(rv)
        torch.cuda.synchronize()
        t_batch = (time.perf_counter() - t1) / reps
        if tuple(pulses.shape) != (8, 100, 2):
            raise AssertionError(f"{name} pulses shape {tuple(pulses.shape)} != (8, 100, 2)")
        phi, tau = pulses[..., 0], pulses[..., 1]
        if not bool(torch.isfinite(pulses).all()):
            raise AssertionError(f"{name} pulses are not finite")
        if not bool(((phi > -math.pi) & (phi <= math.pi)).all()):
            raise AssertionError(f"{name} phi outside (-pi, pi]")
        if not bool((tau >= 0).all()):
            raise AssertionError(f"{name} tau < 0")
        served[name] = pulses.contiguous()
        print(f"  {name}: load {t_load:.2f} s, {1e3 * t_batch:.2f} ms per batch of 8")
    single, _ = compute_pulses("length_100", 1.0, 0.0, 0.0, math.pi)
    if single.shape != (100, 2) or not np.isfinite(single).all():
        raise AssertionError(f"compute_pulses gave {single.shape}")
    cpu_ref = load_pipeline("length_100", device="cpu", dtype=torch.float32)(rv.cpu())
    serve_err = wrapped_phi_err(served["f32"].cpu(), cpu_ref)
    if not serve_err <= SERVE_TOL:
        raise AssertionError(f"card f32 pulses vs CPU f32: {serve_err:.3e} > {SERVE_TOL}")
    phase("serve", t0, f"length_100 bf16 + f32, 8 targets; card f32 vs CPU f32 "
          f"{serve_err:.2e} (tol {SERVE_TOL:.0e})")

    # 7. score
    t0 = time.perf_counter()
    q_t = rotation_vector_to_quat(rv).contiguous()
    M_score = 1 << 20
    sgen = torch.Generator(device=dev).manual_seed(2026)
    delta = torch.randn((8, M_score), generator=sgen, device=dev)
    eps = 0.05 * torch.randn((8, M_score), generator=sgen, device=dev)
    ef = {name: mean_fidelity_local(p, q_t, delta, eps, backend="pallas")
          for name, p in served.items()}
    torch.cuda.synchronize()
    for name, v in ef.items():
        if not bool(((v > 0) & (v <= 1) & torch.isfinite(v)).all()):
            raise AssertionError(f"{name} E[F] out of (0, 1]: {v.tolist()}")
    xpi = float(ef["f32"][0])
    if not abs(xpi - XPI_PUBLISHED) <= XPI_TOL:
        raise AssertionError(f"f32 X(pi) E[F] {xpi:.5f} not within {XPI_TOL} of "
                             f"{XPI_PUBLISHED}")
    mc_mean, mc_se = mc_fidelity_estimate(served["f32"][0], q_t[0], 1.0, 0.05,
                                          monte_carlo=1 << 18, device=dev)
    if not abs(mc_mean - XPI_PUBLISHED) <= XPI_TOL:
        raise AssertionError(f"mc_fidelity_estimate X(pi) {mc_mean:.5f} not within "
                             f"{XPI_TOL} of {XPI_PUBLISHED}")
    serve_launches = {"B1": mean_fidelity_cuda.launches, "B3": propagate_mc_cuda.launches}
    if min(serve_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the serving path: "
                             f"{serve_launches}")
    for name in ef:
        print(f"  {name} E[F] (M=2^20): " + " ".join(f"{v:.5f}" for v in ef[name].tolist()))
    phase("score", t0, f"X(pi) E[F] f32 {xpi:.5f}, bf16 {float(ef['bf16'][0]):.5f}, "
          f"published {XPI_PUBLISHED}; mc_fidelity_estimate {mc_mean:.5f} ± "
          f"{mc_se:.5f} (M=2^18); launches {serve_launches}")

    # 8. train — the training path starts here: counters to 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "run"
        argv = ["--device", "cuda", "--backend", "pallas", "--num_epoch", "2",
                "--train_size", "1024", "--eval_size", "200", "--save_path", str(save)]
        mean_fidelity_cuda.launches = 0
        propagate_mc_cuda.launches = 0
        propagate_mc_vjp_cuda.launches = 0
        history = universal_single_qubit.main(argv)
        torch.cuda.synchronize()
        train_launches = {"B1": mean_fidelity_cuda.launches,
                          "B2": propagate_mc_vjp_cuda.launches,
                          "B3": propagate_mc_cuda.launches}
        t_cli = time.perf_counter() - t0
        if min(train_launches.values()) < 1:
            raise AssertionError(f"a kernel was not launched on the training path: "
                                 f"{train_launches}")
        losses = [x for b in history["bands"] for x in b["train_loss"]]
        fids = [x for b in history["bands"] for x in b["eval_fid"]]
        if len(history["bands"]) != 3 or len(losses) != 6 or len(fids) != 6:
            raise AssertionError(f"expected 3 bands × 2 epochs, got {history}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a training loss is not finite: {losses}")
        if not all(0.0 < x <= 1.0 for x in fids):
            raise AssertionError(f"an eval E[F] is outside (0, 1]: {fids}")
        tags = sorted(p.name for p in save.iterdir() if (p / "params.pt").exists())
        exports = sorted(save.glob("*_pulses.npz"))
        if len(tags) != 3 or len(exports) != 3:
            raise AssertionError(f"band checkpoints {tags}, pulse exports {exports}")
        for path in exports:
            with np.load(path) as z:
                if z["pulses"].shape != (1000, 100, 2) or not np.isfinite(z["pulses"]).all():
                    raise AssertionError(f"{path.name}: {z['pulses'].shape}")
        if not (save / "metrics.csv").exists():
            raise AssertionError("no metrics.csv")
    print(f"  CLI: 3 bands × 2 epochs × 5 steps at batch 200, M = 1000 in {t_cli:.2f} s "
          f"(kernel build cached); train loss " + " ".join(f"{x:.4f}" for x in losses)
          + "; eval E[F] " + " ".join(f"{x:.5f}" for x in fids))

    # one step's gradient through pallas and xla from the same weights and draws
    mp = load_model_params(universal_single_qubit.DEFAULT_CONFIG)
    mp["finetune"] = False
    model = UniversalQOCTransformer(**mp, dtype=torch.float32, device=dev)
    model.init_like_flax(torch.Generator(device=dev).manual_seed(5))
    rv_t, qt_t = build_su2_dataset(torch.Generator().manual_seed(11), 200, random=True,
                                   device=dev)
    trainers = {b: Trainer(model, TrainConfig(backend=b), device=dev)
                for b in ("pallas", "xla")}
    band = CurriculumBand(1.0)
    errors = trainers["pallas"].sample_errors(200, band)
    grads, step_loss = {}, {}
    for b, tr in trainers.items():
        model.zero_grad(set_to_none=True)
        loss, _ = tr.objective(rv_t, qt_t, errors)
        loss.backward()
        grads[b] = torch.cat([p.grad.flatten() for p in model.parameters()])
        step_loss[b] = float(loss.detach())
    gnorm = float(grads["xla"].norm())
    rel = float((grads["pallas"] - grads["xla"]).norm()) / gnorm
    if not rel <= TRAIN_GRAD_TOL:
        raise AssertionError(f"pallas vs xla gradient: {rel:.3e} of the norm > {TRAIN_GRAD_TOL}")
    print(f"  one step, pallas vs xla: loss {step_loss['pallas']:.6f} / "
          f"{step_loss['xla']:.6f}, |g_pallas - g_xla| / |g_xla| {rel:.3e} "
          f"(|g| {gnorm:.4e}, tol {TRAIN_GRAD_TOL:.0e})")

    # ms per train step (fresh draws and dropout, as in the CLI), host clock
    # around synchronized steps
    step_ms = {}
    for b, n in (("pallas", 20), ("xla", 3)):
        tr = trainers[b]
        for _ in range(2):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
        step_ms[b] = 1e3 * (time.perf_counter() - t1) / n
    # where a pallas step's device time goes: kernel time by name from the
    # profiler (annotation ranges such as "Optimizer.step#…" are filed under
    # the device too and left out), over the unprofiled step time above
    tr = trainers["pallas"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / 5e3
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in ("mean_fid_kernel", "propagate_mc",
                                              "partials_kernel"))) / 5e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile of 5 pallas steps: kernels {dev_ms:.3f} ms per step, "
          f"{100 * dev_ms / step_ms['pallas']:.1f} % of the {step_ms['pallas']:.2f} ms "
          f"step (B1/B2/B3 {ours_ms:.3f} ms); top, us per step: " + "; ".join(
              f"{e.key[:50]} {e.self_device_time_total / 5:.0f}" for e in top))
    phase("train", t0, f"ms per train step at full width, batch 200, M = 1000: pallas "
          f"{step_ms['pallas']:.2f}, xla {step_ms['xla']:.2f}; launches {train_launches}")

    # 9. serve-su4 — the two-qubit serving path starts here: counters to 0
    mean_fidelity_su4_cuda.launches = 0
    propagate_su4_mc_cuda.launches = 0
    t0 = time.perf_counter()
    ckpt, kw4 = two_qubit_model_kwargs("two_qubit_d2_kak")
    gates4 = named_two_qubit_targets()
    U4 = np.stack(list(gates4.values()))                    # (5, 4, 4) complex
    reps = np.stack([z4_representatives(u) for u in U4]).reshape(20, 4, 4)
    packed20 = SU4System.pack_target(reps).to(dev)
    t1 = time.perf_counter()
    model4 = two_qubit_eval.load_two_qubit_model(ckpt, device=dev, **kw4)
    torch.cuda.synchronize()
    t_load4 = time.perf_counter() - t1
    inputs20 = two_qubit_eval.model_inputs(packed20, kw4["kak_tokens"])
    with torch.no_grad():
        raw20 = model4(inputs20)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            raw20 = model4(inputs20)
        torch.cuda.synchronize()
    t_batch4 = (time.perf_counter() - t1) / 5
    if tuple(raw20.shape) != (20, 100, 4) or not bool(torch.isfinite(raw20).all()):
        raise AssertionError(f"two-qubit pulses {tuple(raw20.shape)}, finite "
                             f"{bool(torch.isfinite(raw20).all())}")
    if not bool(((raw20[..., 0] > -math.pi) & (raw20[..., 0] <= math.pi)).all()):
        raise AssertionError("two-qubit phi1 outside (-pi, pi]")
    if not bool(((raw20[..., 2] >= 0.05 - 1e-6) & (raw20[..., 3] >= 0.1 - 1e-6)).all()):
        raise AssertionError("two-qubit Omega < omega_min or tau < 0.1")
    sys4 = SU4System(drive2=True, backend="pallas")
    t1 = time.perf_counter()
    best4 = two_qubit_eval.best_phase_pulses(ckpt, U4, sys4, device=dev, **kw4).contiguous()
    torch.cuda.synchronize()
    t_best4 = time.perf_counter() - t1
    cpu_raw20 = two_qubit_eval.model_gate_pulses(ckpt, packed20.cpu(), **kw4)
    cpu_best4 = two_qubit_eval.best_phase_pulses(ckpt, U4, sys4, device="cpu", **kw4)
    serve4_err = wrapped_phi_err(raw20.cpu(), cpu_raw20, angles=2)
    best4_err = wrapped_phi_err(best4.cpu(), cpu_best4, angles=2)
    if not serve4_err <= SERVE_TOL:
        raise AssertionError(f"card f32 two-qubit pulses vs CPU f32: {serve4_err:.3e} > "
                             f"{SERVE_TOL}")
    if not best4_err <= SERVE_TOL:
        raise AssertionError(f"best-of-Z4 choice differs between card and CPU: "
                             f"{best4_err:.3e}")
    phase("serve-su4", t0, f"two_qubit_d2_kak f32: load {t_load4:.2f} s, "
          f"{1e3 * t_batch4:.2f} ms per batch of 20 (5 gates × 4 Z4 representatives), "
          f"best_phase_pulses {t_best4:.2f} s (load + KAK tokens + model + B6); card vs "
          f"CPU pulses {serve4_err:.2e}, best choice {best4_err:.2e} (tol {SERVE_TOL:.0e})")

    # 10. score-su4: the named-gate table through B6, then the sweep and the
    # grid of CZ through B7
    t0 = time.perf_counter()
    gates_packed = SU4System.pack_target(U4).to(dev)
    sigmas4 = [0.0, 0.1, 0.2]
    table4 = two_qubit_eval.eval_pulse_tables(best4, gates_packed, sigmas4,
                                              monte_carlo=20_000, epsilon_std=0.05,
                                              system=sys4)
    for i, g in enumerate(gates4):
        ref = JAX_SU4_TABLE[g]
        print(f"  {g}: E[F] " + " ".join(f"{v:.5f}" for v in table4[i]) + "  JAX CPU "
              + " ".join(f"{v:.5f}" for v in ref))
        if not abs(table4[i, 0] - ref[0]) <= SU4_EXACT_TOL:
            raise AssertionError(f"{g} sigma=0: {table4[i, 0]:.5f} vs JAX {ref[0]:.5f}")
        for k in (1, 2):
            if not abs(table4[i, k] - ref[k]) <= SU4_MC_TOL:
                raise AssertionError(f"{g} sigma={sigmas4[k]}: {table4[i, k]:.5f} vs JAX "
                                     f"{ref[k]:.5f} (tol {SU4_MC_TOL})")
    exact_err = float(np.abs(table4[:, 0] - [JAX_SU4_TABLE[g][0] for g in gates4]).max())
    mc_err = float(np.abs(table4[:, 1:] - [JAX_SU4_TABLE[g][1:] for g in gates4]).max())
    # E[F](σ) of CZ: 20 σ × 2000 samples through B7, against the plain version
    cz_pulses = best4[:1].contiguous()
    stds = np.arange(1, 21) * 0.05
    _, sweep_mean, sweep_se = plots_su4.fidelity_by_std_su4(
        best4[0], U4[0], sys4.system, stds=stds, monte_carlo=2000,
        generator=torch.Generator(device=dev).manual_seed(2028), device=dev)
    n1, n2, ne = plots_su4._sweep_draws(torch.Generator(device=dev).manual_seed(2028),
                                        len(stds), 2000, 0.05)
    st = torch.as_tensor(stds, dtype=torch.float32, device=dev)[:, None]
    sweep_d1 = (n1 * st).reshape(1, -1).contiguous()
    sweep_d2 = (n2 * st).reshape(1, -1).contiguous()
    sweep_e = ne.reshape(1, -1).contiguous()
    cz_r, cz_i = plots_su4._as_packed(U4[0], dev)
    Up = propagate_su4_mc_plain(cz_pulses, sweep_d1, sweep_d2, sweep_e, sys4.system)
    sweep_plain = fidelity_su4_ri(Up[0][0], Up[1][0], cz_r, cz_i).reshape(len(stds), -1).mean(1)
    sweep_err = float(np.abs(sweep_mean - sweep_plain.cpu().numpy()).max())
    if not sweep_err <= SU4_SWEEP_TOL:
        raise AssertionError(f"E[F](sigma) sweep, B7 vs plain: {sweep_err:.3e} > {SU4_SWEEP_TOL}")
    if not (0.0 < sweep_mean.min() and sweep_mean.max() <= 1.0
            and sweep_mean[-1] < sweep_mean[0]):
        raise AssertionError(f"E[F](sigma) outside (0, 1] or not lower at sigma 1.0: "
                             f"{sweep_mean}")
    # F(δ₁, δ₂) of CZ on a 61² grid through B7, against the plain version
    dg, grid_F = plots_su4.fidelity_grid_su4(best4[0], U4[0], sys4.system, n_delta=61,
                                             device=dev)
    dgt = torch.as_tensor(dg, device=dev)
    gd1, gd2 = (x.reshape(1, -1).contiguous() for x in torch.meshgrid(dgt, dgt, indexing="ij"))
    grid_plain = {}
    for dt in (torch.float32, torch.float64):
        Ug = propagate_su4_mc_plain(cz_pulses.to(dt), gd1.to(dt), gd2.to(dt),
                                    torch.zeros_like(gd1, dtype=dt), sys4.system)
        grid_plain[dt] = fidelity_su4_ri(Ug[0][0], Ug[1][0], cz_r.to(dt),
                                         cz_i.to(dt)).reshape(61, 61).cpu().numpy()
    grid_tol = max(SU4_PROD_TOL, 2 * float(np.abs(grid_plain[torch.float32]
                                                  - grid_plain[torch.float64]).max()))
    grid_err = float(np.abs(grid_F - grid_plain[torch.float32]).max())
    if not grid_err <= grid_tol:
        raise AssertionError(f"F(delta1, delta2) grid, B7 vs plain: {grid_err:.3e} > {grid_tol:.2e}")
    su4_launches = {"B6": mean_fidelity_su4_cuda.launches, "B7": propagate_su4_mc_cuda.launches}
    if min(su4_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the two-qubit serving path: "
                             f"{su4_launches}")
    print(f"  CZ E[F](sigma) at sigma 0.05 / 0.5 / 1.0: {sweep_mean[0]:.5f} / "
          f"{sweep_mean[9]:.5f} / {sweep_mean[19]:.5f} (SE {sweep_se[19]:.5f}); grid F at "
          f"the centre {grid_F[30, 30]:.5f}, corner {grid_F[0, 0]:.5f}")
    phase("score-su4", t0, f"sigma=0 within {exact_err:.2e} of the JAX CPU table (tol "
          f"{SU4_EXACT_TOL:.0e}), sigma 0.1/0.2 within {mc_err:.2e} (tol {SU4_MC_TOL}); "
          f"sweep B7 vs plain {sweep_err:.2e} (tol {SU4_SWEEP_TOL:.0e}), grid {grid_err:.2e} "
          f"(tol {grid_tol:.1e}); launches {su4_launches}")

    # 11. train-su4 — the two-qubit training path: counters to 0 inside
    t0 = time.perf_counter()
    tq = train_su4(ckpt, kw4, dev)
    phase("train-su4", t0, f"ms per train step at full width, batch {TRAIN4_BATCH}, M = "
          f"{TRAIN4_MC}, L = 100: pallas {tq['step_ms']['pallas']:.2f}, xla "
          f"{tq['step_ms']['xla']:.2f}; pallas vs xla gradient {tq['rel']:.3e} of the norm "
          f"(against f64: pallas {tq['e32']['pallas']:.3e}, xla {tq['e32']['xla']:.3e}); "
          f"eval E[F] {tq['fids'][-1]:.5f}; launches {tq['launches']}")

    # 12. grape-su4 — the two-qubit GRAPE path: counters to 0 inside
    t0 = time.perf_counter()
    gq = grape_su4(dev)
    phase("grape-su4", t0, f"CZ drive2, 24 starts, {GRAPE_STEPS} steps per stage: stage-0 best "
          f"exact F {gq['best0']:.5f} (gate {GRAPE_MIN_EXACT_F}); CLI {gq['t_cli']:.2f} s; ms "
          f"per step: exact {gq['exact_step']['ms']:.2f}, MC {gq['mc_step']['ms']:.2f}; "
          f"launches {gq['launches']}")

    # 13. polish-su4 — the per-gate polish path: counters to 0 inside
    t0 = time.perf_counter()
    pq = polish_su4(dev)
    phase("polish-su4", t0, f"5 gates, {POLISH_STEPS} polish steps at M = 4096: chosen minus "
          f"model ≥ {pq['worst']:.5f} (gate -{POLISH_TOL}); CLI {pq['t_cli']:.2f} s; ms per "
          f"polish step {pq['step']['ms']:.2f} (B4/B5 {pq['step']['kernel_ms']:.3f}); "
          f"launches {pq['launches']}")

    # 14. serve-su4-variants — the demo's two-qubit variants: counters to 0
    # inside
    t0 = time.perf_counter()
    vq = serve_su4_variants(dev)
    phase("serve-su4-variants", t0, f"bundle sigma=0 within {vq['err0']:.2e} of the JAX CPU "
          f"table (tol {SU4_EXACT_TOL:.0e}), sigma > 0 within {vq['errmc']:.2e} (tol "
          f"{SU4_MC_TOL}); sweeps within {vq['sweep_err']:.2e} (tol {VARIANT_SWEEP_TOL}); "
          f"launches {vq['launches']}")

    # 15. serve-variants — the single-qubit variants of slice 2: counters to
    # 0 inside
    t0 = time.perf_counter()
    sv = serve_variants(dev)
    worst_bundle = max(float(np.abs(s["diff"]).max()) for s in sv["scores"].values())
    phase("serve-variants", t0, f"{len(sv['rows'])} variants, card f32 vs CPU f32 within "
          f"{max(r['err'] for r in sv['rows'].values()):.2e} (tol {SERVE_TOL:.0e}); bundles at "
          f"sigma 1 within {worst_bundle:.2e} of their fidelity_finetuned (tol {BUNDLE_TOL}); "
          f"launches {sv['launches']}")

    # 16. grape — the single-qubit GRAPE path: counters to 0 inside
    t0 = time.perf_counter()
    g2 = grape_su2(dev)
    phase("grape", t0, f"L = 400, batch {GRAPE_BATCH}, M = {GRAPE_MC}: CLI {g2['t_cli']:.2f} s, "
          f"ms per step pallas {g2['step']['pallas']['ms']:.2f}, xla "
          f"{g2['step']['xla']['ms']:.2f}; pallas vs xla gradient max {g2['grad'][0]:.3e} "
          f"({g2['rel']:.3e} of the norm); direct X(pi) band 0 E[F] {g2['direct'][0]:.4f} → "
          f"{g2['direct'][1]:.4f}; launches {g2['launches']}")

    # 17. finetune — the per-gate polish and the P = 4 ceiling: counters to 0
    # inside
    t0 = time.perf_counter()
    f2 = finetune_su2(dev)
    phase("finetune", t0, f"5 gates, 1500 steps at M = 8192: mean gain "
          f"{float(f2['gain'].mean()):+.5f} (gate {FINETUNE_MIN_GAIN}), worst gate "
          f"{float(f2['gain'].min()):+.5f} (gate -{FINETUNE_WORSE_TOL}); CLI {f2['t_cli']:.2f} s, "
          f"ms per polish step {f2['step']['ms']:.2f}; ceiling (cut) {f2['t_ceiling']:.2f} s; "
          f"launches {f2['launches']}, ceiling {f2['ceiling_launches']}")

    # 18. dcrab — plain PyTorch, no kernel: counters to 0 inside, all stay 0
    t0 = time.perf_counter()
    dq = dcrab_su2(dev)
    phase("dcrab", t0, f"grad CLI {dq['t_grad']:.2f} s ({DCRAB_STEPS} steps), ms per Adam step "
          f"{dq['step_ms']:.2f} ({dq['kernels']:.0f} launches); card vs CPU objective "
          f"{dq['err']:.2e} (tol {DCRAB_TOL:.0e}); nm CLI {dq['t_nm']:.2f} s")

    # 19. mesh — 2 gloo ranks on this card, each setting its counters to 0
    # before each layout's run and reporting them
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mq = mesh_phase(dev, Path(tmp))
    for r in mq["reports"]:
        for key, la in r["layouts"].items():
            print(f"  rank {r['rank']} ({r['backend']}, {r['device']}) {key}: CLI {la['t_cli']:.2f} s, "
                  f"ms per train step {la['step_ms']:.2f}, a step's gloo all-reduce "
                  f"({la['allreduce_mb']:.3f} MiB) {la['allreduce_ms']:.3f} ms, steps' losses / "
                  f"E[F] and band 0's eval {la['rel']:.2e} relative from one process, later "
                  f"bands' eval E[F] {la['rel_eval']:.2e}; launches {la['launches']}")
    print("  objectives against one process's B1: " + "; ".join(
        f"{k} {n} value {v:.2e}, gradient {g:.2e}" for (k, n), (v, g) in mq["errs"].items()))
    phase("mesh", t0, f"backend gloo, layouts 1x2 and 2x1 at B 200, L 100, M 1000: value and "
          f"gradient within {MESH_VALUE_TOL:.0e} / {MESH_GRAD_TOL:.0e}, the CLI within "
          f"{MESH_LOSS_RTOL:.0e} (later evals {MESH_EVAL_RTOL:.0e}) of one process ({mq['t_one']:.2f} s), ranks bit-identical, "
          f"rank 0 alone wrote, 3x5 raised; ranks {mq['t_ranks']:.2f} s; launches "
          f"{mq['launches']}")

    # 20. run — the config-driven runner and the exports: counters to 0 inside
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rq = run_phase(dev, Path(tmp))
    for dt_name, ex in rq["exports"].items():
        print(f"  {dt_name}: {ex['mb']:.1f} MiB in {ex['t_export']:.2f} s; E[F] at sigma 1, M = "
              f"{RUN_MC} (5 gates, 3 random): " + " ".join(f"{x:.5f}" for x in ex["ef"]))
    phase("run", t0, f"run.py {rq['t_run']:.2f} s (3 bands x 2 steps, best {rq['best']:.4f}); "
          f"f32 export served within {rq['exports']['f32']['err']:.1e} (tol {RUN_EXPORT_TOL:.0e}), "
          f"f16 and int8 equal to the numpy round trip; launches {rq['launches']}")

    # 21. viz — the single-qubit figures' numbers: counters to 0 inside
    t0 = time.perf_counter()
    zq = viz_su2(dev)
    phase("viz", t0, f"length_100 at the demo's defaults (X(pi), M = {VIZ_MC}): grid, estimate, "
          f"sweeps (199 sigma x {VIZ_MC}, P = 2 and 4), Bloch (12 samples, P = 2 and 4), 5 "
          f"gates' parity curves and the compare, {zq['t_path']:.2f} s; kernel vs plain worst "
          f"{max(e / t for e, t in zq['checks'].values()):.2f} of its tolerance; parity E[F] "
          f"within {zq['worst_k']:.2f} combined SE of the JAX CPU values (gate {VIZ_SE_K}), "
          f"model T within {zq['worst_t']:.4f}π (tol {VIZ_MODEL_T_TOL}), SCORE T exact; "
          f"launches {zq['launches']}")

    # 22. viz-su4 — the two-qubit figures' numbers: counters to 0 inside
    t0 = time.perf_counter()
    zq4 = viz_su4(dev)
    phase("viz-su4", t0, f"bundle figure (5 gates x {zq4['n_sigmas']} sigma x {VIZ4_MC}) within "
          f"{zq4['worst_k']:.2f} combined SE of the JAX CPU values (gate {VIZ_SE_K}); the demo's "
          f"61² grid and 20-sigma sweep of two_qubit_d2_kak CZ and cz_drive2, kernel vs plain "
          f"worst {max(e / t for e, t in zq4['checks'].values()):.2f} of its tolerance, "
          f"{zq4['t_path']:.2f} s; launches {zq4['launches']}")

    # 23. time each kernel at each path's shape: one row per (kernel, path),
    # its launches those of that path's run
    t0 = time.perf_counter()
    csrc = "universal_quantum_optimal_control_tpu_torch/ops/csrc/"
    names = {"B1": ("mean_fidelity_cuda (B1)", "ops/propagate_pallas.py:252", "propagate_su2.cu"),
             "B2": ("propagate_mc_vjp_cuda (B2)", "ops/propagate_pallas_bwd.py:74",
                    "propagate_su2.cu"),
             "B3": ("propagate_mc_cuda (B3)", "ops/propagate_pallas.py:240", "propagate_su2.cu"),
             "B6": ("mean_fidelity_su4_cuda (B6)", "ops/propagate_su4_pallas.py:226",
                    "propagate_su4.cu"),
             "B7": ("propagate_su4_mc_cuda (B7)", "ops/propagate_su4_pallas.py:215",
                    "propagate_su4.cu"),
             "B4": ("mean_fidelity_su4_with_product_cuda (B4)",
                    "ops/propagate_su4_pallas.py:256", "propagate_su4.cu"),
             "B5": ("su4_objective_vjp_from_product_cuda (B5)",
                    "ops/propagate_su4_pallas_bwd.py:364", "propagate_su4_bwd.cu"),
             "B8": ("su4_objective_vjp_cuda (B8)", "ops/propagate_su4_pallas_bwd.py:271",
                    "propagate_su4_bwd.cu")}
    # each kernel's entry function at pulse width P, as ptxas names it
    entry = {"B1": "mean_fid_kernelILi{}E", "B2": "propagate_mc_vjp_kernelILi{}E",
             "B3": "propagate_mc_kernelILi{}E", "B4": "mean_fid_su4_kernelILi{}ELb1E",
             "B5": "su4_vjp_kernelILi{}ELb0E", "B6": "mean_fid_su4_kernelILi{}ELb0E",
             "B7": "propagate_su4_kernelILi{}E", "B8": "su4_vjp_kernelILi{}ELb1E"}
    launches = {"serve": serve_launches, "train": train_launches, "serve-su4": su4_launches,
                "train-su4": tq["launches"], "check-su4-train": check_launches,
                "grape-su4": gq["launches"], "polish-su4": pq["launches"],
                "serve-su4-variants": vq["launches"], "serve-variants": sv["launches"],
                "grape": g2["launches"], "finetune": f2["launches"],
                "ceiling": f2["ceiling_launches"], "run": rq["launches"], **mq["launches"],
                "viz": zq["launches"], "viz-su4": zq4["launches"]}

    lib2 = _build.load_library("su2")
    lib4, lib4b = _build.load_library("su4"), _build.load_library("su4_bwd")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def occupancy_su2(kid, shape):
        """B1's, B2's and B3's threads per block, resident blocks per SM
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the launch's
        waves (its blocks over the resident blocks of all SMs)."""
        B_, L_, P_, M_ = shape
        knum = {"B1": 1, "B2": 2, "B3": 3}[kid]
        threads, per_sm = lib2.uqoc_su2_threads(knum), lib2.uqoc_su2_blocks_per_sm(knum, P_, L_)
        if per_sm < 1:
            raise AssertionError(f"{kid}: occupancy query failed ({per_sm})")
        return {"threads_per_block": threads, "blocks_per_sm": per_sm,
                "waves": B_ * math.ceil(M_ / threads) / (per_sm * n_sm)}

    def occupancy(kid, shape):
        """B4's, B6's, B5's and B8's lanes per sample at the row's shape (1:
        one thread per sample), resident blocks per SM
        (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the launch's
        warps per warp scheduler (4 an SM)."""
        B_, L_, P_, M_ = shape
        if kid in ("B4", "B6"):
            lanes = lib4.uqoc_su4_lanes(B_, M_)
            per_sm = lib4.uqoc_su4_blocks_per_sm(B_, M_, P_, int(kid == "B4"), L_)
            blocks = lib4.uqoc_su4_num_blocks(B_, M_)
        else:
            lanes = lib4b.uqoc_su4_vjp_lanes(B_, M_)
            per_sm = lib4b.uqoc_su4_vjp_blocks_per_sm(B_, M_, P_, int(kid == "B8"), L_)
            blocks = lib4b.uqoc_su4_vjp_num_blocks(B_, M_)
        if per_sm < 1:
            raise AssertionError(f"{kid}: occupancy query failed ({per_sm})")
        return {"lanes_per_sample": lanes, "blocks_per_sm": per_sm,
                "warps_per_scheduler": B_ * blocks * SU4_WARPS_PER_BLOCK / (4 * n_sm)}

    def occupancy_b7(shape):
        """B7's plan at the row's shape: K chunks of a sample's segments, one
        thread each (1: one thread per sample), the launch's blocks,
        resident blocks per SM, blocks a SM, waves and warps per scheduler."""
        B_, L_, P_, M_ = shape
        K = lib4.uqoc_su4_prop_chunks(B_, M_, L_)
        per_sm = lib4.uqoc_su4_prop_blocks_per_sm(K, P_, L_)
        if per_sm < 1:
            raise AssertionError(f"B7: occupancy query failed ({per_sm})")
        blocks = B_ * math.ceil(M_ / (SU4_WARPS_PER_BLOCK * 32 // K))
        return {"chunks": K, "blocks": blocks, "blocks_per_sm": per_sm,
                "blocks_a_sm": blocks / n_sm, "waves": blocks / (per_sm * n_sm),
                "warps_per_scheduler": blocks * SU4_WARPS_PER_BLOCK / (4 * n_sm)}

    def row(kid, path, shape, err, ms, plain_ms, bound_):
        name, where, src = names[kid]
        fragment = entry[kid].format(shape[2])
        occ = None
        if kid in ("B4", "B5", "B6", "B8"):  # the instantiation at this shape's lanes
            occ = occupancy(kid, shape)
            fragment += f"Li{occ['lanes_per_sample']}E"
        elif kid == "B7":  # the chunked kernel past plan K = 1
            occ = occupancy_b7(shape)
            if occ["chunks"] > 1:
                fragment = f"propagate_su4_chunks_kernelILi{shape[2]}E"
        elif kid in ("B1", "B2", "B3"):
            occ = occupancy_su2(kid, shape)
        r = {"name": name, "route": "cuda", "source": csrc + src,
             "replaces": f"universal_quantum_optimal_control_tpu/{where}",
             "launches": launches[path][kid], "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
             "library_ms": None, "path": path,
             "shape": "B={} L={} P={} M={}".format(*shape),
             "ptxas": ptxas_of(ptx, fragment)}
        if occ:
            r["occupancy"] = occ
        return r

    def fid_row(path, p_, qt_, d_, e_, iters):
        B_, L_, P_ = p_.shape
        M_ = d_.shape[1]
        plain = mean_fidelity_plain(p_, qt_, d_, e_)
        err = float((mean_fidelity_cuda(p_, qt_, d_, e_) - plain).abs().max())
        tol = FID_TOL
        if L_ > 100:  # the L = 100 rule past it: twice the plain f32 error against f64
            tol = max(tol, 2 * max_err(plain, mean_fidelity_plain(
                *(t.double() for t in (p_, qt_, d_, e_)))))
        if not err <= tol:
            raise AssertionError(f"B1 at the {path} shape: {err:.3e} > {tol:.2e}")
        r = row("B1", path, (B_, L_, P_, M_), err,
                time_ms(lambda: mean_fidelity_cuda(p_, qt_, d_, e_), iters),
                time_ms(lambda: mean_fidelity_plain(p_, qt_, d_, e_), 3),
                bound(B_, L_, P_, M_, 4 * B_, fidelity=True))
        r["device_ms"] = device_ms(lambda: mean_fidelity_cuda(p_, qt_, d_, e_))
        r["libm_samples"] = libm_samples(p_, d_, e_)
        return r

    def prop_row(path, p_, d_, e_, iters):
        B_, L_, P_ = p_.shape
        M_ = d_.shape[1]
        err = float((propagate_mc_cuda(p_, d_, e_) - propagate_mc_plain(p_, d_, e_)).abs().max())
        if not err <= quat_tol(L_):
            raise AssertionError(f"B3 at the {path} shape: {err:.3e} > {quat_tol(L_)}")
        r = row("B3", path, (B_, L_, P_, M_), err,
                time_ms(lambda: propagate_mc_cuda(p_, d_, e_), iters),
                time_ms(lambda: propagate_mc_plain(p_, d_, e_), 3),
                bound(B_, L_, P_, M_, 16 * B_ * M_, fidelity=False))
        r["device_ms"] = device_ms(lambda: propagate_mc_cuda(p_, d_, e_))
        r["libm_samples"] = libm_samples(p_, d_, e_)
        return r

    pulses = served["f32"]
    pt = trainers["pallas"].predict(rv_t).contiguous()
    dt_, et_ = errors
    Bt, Lt, Pt = pt.shape
    Mt = dt_.shape[1]
    # B1, serving and training; at the training shape also forward + backward
    b1_train = fid_row("train", pt, qt_t, dt_, et_, 50)
    leaf = pt.clone().requires_grad_(True)

    def fwd_bwd(fn):
        return lambda: fn(leaf, qt_t, dt_, et_).mean().backward()

    b1_train["fwd_bwd_ms"] = time_ms(fwd_bwd(mean_fidelity_cuda), 20)
    b1_train["fwd_bwd_plain_ms"] = time_ms(fwd_bwd(mean_fidelity_plain), 3)
    # B2 at the training shape, on B3's product as the training step runs it
    g_t = torch.randn((Bt, Mt, 4), generator=gen, device=dev)
    _, got, want = check_vjp("at the training shape", pt, dt_, et_, g_t)
    q_pt = propagate_mc_cuda(pt, dt_, et_)
    b2_train = row("B2", "train", (Bt, Lt, Pt, Mt),
                   max(float((a - b).abs().max()) for a, b in zip(got, want)),
                   time_ms(lambda: propagate_mc_vjp_cuda(pt, dt_, et_, g_t, q_pt), 50),
                   time_ms(lambda: propagate_mc_vjp_plain(pt, dt_, et_, g_t), 3),
                   vjp_bound(Bt, Lt, Pt, Mt))
    b2_train["device_ms"] = device_ms(lambda: propagate_mc_vjp_cuda(pt, dt_, et_, g_t, q_pt))
    b2_train["libm_samples"] = libm_samples(pt, dt_, et_)
    p1 = pulses[:1].contiguous()
    d1, e1 = delta[:1, :1 << 18].contiguous(), eps[:1, :1 << 18].contiguous()
    # the SU(4) kernels, each against its plain version at the path's shape,
    # with the L = 100 rule: the JAX suite's tolerance or twice the plain
    # f32 version's own error against f64, whichever is larger
    def su4_shape(in_):
        return (*in_[0].shape, in_[-1].shape[1])

    def su4_fid_row(path, in_, sys_):
        """B6 on in_ = (pulses, target re, im, δ₁, δ₂, ε)."""
        k, p_ = mean_fidelity_su4_cuda(*in_, sys_), mean_fidelity_su4_plain(*in_, sys_)
        tol = max(SU4_FID_TOL[in_[0].shape[2]], 2 * max_err(p_, mean_fidelity_su4_plain(
            *(t.double() for t in in_), sys_)))
        err = max_err(k, p_)
        if not err <= tol:
            raise AssertionError(f"B6 at the {path} shape: {err:.3e} > {tol:.2e}")
        return row("B6", path, su4_shape(in_), err,
                   time_ms(lambda: mean_fidelity_su4_cuda(*in_, sys_), 20),
                   time_ms(lambda: mean_fidelity_su4_plain(*in_, sys_), 2),
                   su4_bound(*su4_shape(in_), fidelity=True))

    def su4_prop_row(path, in_, sys_):
        """B7 on in_ = (pulses, δ₁, δ₂, ε)."""
        k, p_ = propagate_su4_mc_cuda(*in_, sys_), propagate_su4_mc_plain(*in_, sys_)
        tol = max(SU4_PROD_TOL, 2 * max_err(p_, propagate_su4_mc_plain(
            *(t.double() for t in in_), sys_)))
        err = max_err(k, p_)
        if not err <= tol:
            raise AssertionError(f"B7 at the {path} shape: {err:.3e} > {tol:.2e}")
        r = row("B7", path, su4_shape(in_), err,
                time_ms(lambda: propagate_su4_mc_cuda(*in_, sys_), 20),
                time_ms(lambda: propagate_su4_mc_plain(*in_, sys_), 2),
                su4_bound(*su4_shape(in_), fidelity=False))
        # the wrapper's host time exceeds the launch at the GRAPE curve's shape
        r["device_ms"] = device_ms(lambda: propagate_su4_mc_cuda(*in_, sys_))
        return r

    def su4_train_rows(path, in_, gbar, sys_):
        """B4 and B5 on in_ under the per-target cotangent gbar; returns the
        two rows and the gradients (kernel, plain, f64) for B8's row."""
        in64 = tuple(t.double() for t in in_)
        F_k, prod_k = mean_fidelity_su4_with_product_cuda(*in_, sys_)
        F_p, prod_p = mean_fidelity_su4_with_product_plain(*in_, sys_)
        F64, prod64 = mean_fidelity_su4_with_product_plain(*in64, sys_)
        errs = (max_err(F_k, F_p), max_err(prod_k, prod_p))
        tols = (max(SU4_FID_TOL[4], 2 * max_err(F_p, F64)),
                max(SU4_PROD_TOL, 2 * max_err(prod_p, prod64)))
        if not all(e <= t for e, t in zip(errs, tols)):
            raise AssertionError(f"B4 at the {path} shape: F, product errors {errs} beyond {tols}")
        g_k = su4_objective_vjp_from_product_cuda(*in_, gbar, prod_k, sys_)
        g_p = su4_objective_vjp_from_product_plain(*in_, gbar, prod_p, sys_)
        g64 = su4_objective_vjp_from_product_plain(*in64, gbar.double(), None, sys_)
        e5 = grads_close(f"B5 at the {path} shape", ("pulses", "delta1", "delta2", "eps"),
                         (1e-5,) * 4, g_k, g_p, g64)
        shape = su4_shape(in_)
        b4 = row("B4", path, shape, max(errs),
                 time_ms(lambda: mean_fidelity_su4_with_product_cuda(*in_, sys_), 20),
                 time_ms(lambda: mean_fidelity_su4_with_product_plain(*in_, sys_), 2),
                 su4_bound(*shape, fidelity=True, product=True))
        b5 = row("B5", path, shape, e5[0],
                 time_ms(lambda: su4_objective_vjp_from_product_cuda(*in_, gbar, prod_k, sys_),
                         20),
                 time_ms(lambda: su4_objective_vjp_from_product_plain(*in_, gbar, prod_p, sys_),
                         2),
                 su4_vjp_bound(*shape))
        b5["vs_f64"] = {"kernel": e5[1], "plain": e5[2]}
        return b4, b5, (g_k, g_p, g64)

    # two-qubit serving: B6 at the named-gate table's shape (5 gates, σ_δ =
    # 0.2 draws), B7 at the sweep's
    sysd = sys4.system
    n4 = sys4.sample_errors(torch.Generator(device=dev).manual_seed(7), (5, 20_000), 1.0, 1.0)
    serve_draws = (n4[0] * 0.2, n4[1] * 0.2, n4[2] * 0.05)
    b6_row = su4_fid_row("serve-su4", (best4, gates_packed[:, 0].contiguous(),
                                       gates_packed[:, 1].contiguous(), *serve_draws), sysd)
    b7_row = su4_prop_row("serve-su4", (cz_pulses, sweep_d1, sweep_d2, sweep_e), sysd)
    # two-qubit training: B4, B5 and B6 on the restored model's pulses, the
    # step's targets and σ_δ = 0.2 draws; B8 beside B4 + B5 there
    tr4, ti4 = tq["targets"][:, 0].contiguous(), tq["targets"][:, 1].contiguous()
    in4 = (tq["pulses"], tr4, ti4, *tq["errors"])
    shape4 = su4_shape(in4)
    gbar4 = torch.full((shape4[0],), 1.0 / shape4[0], device=dev)
    b4_row, b5_row, (g_k, g_p, g64) = su4_train_rows("train-su4", in4, gbar4, sysd)
    b6_train = su4_fid_row("train-su4", in4, sysd)
    leaf4 = tq["pulses"].clone().requires_grad_(True)

    def fwd_bwd4(fn):
        return lambda: torch.autograd.grad(fn(leaf4, *in4[1:], sysd), leaf4, gbar4)

    b4_row["fwd_bwd_ms"] = time_ms(fwd_bwd4(mean_fidelity_su4_cuda), 20)
    b4_row["fwd_bwd_plain_ms"] = time_ms(fwd_bwd4(mean_fidelity_su4_plain), 2)
    g8 = su4_objective_vjp_cuda(*in4, gbar4, sysd)
    e8 = grads_close("B8 at the two-qubit training shape", ("pulses", "delta1", "delta2", "eps"),
                     (1e-5,) * 4, g8, g_p, g64)
    e85 = max_err(g8, g_k)
    if not e85 <= SU4_B8_B5_TOL:
        raise AssertionError(f"B8 at the two-qubit training shape: |B8 - B5 seeded by B4| "
                             f"{e85:.3e} > {SU4_B8_B5_TOL:.0e}")
    b8_row = row("B8", "check-su4-train", shape4, e8[0],
                 time_ms(lambda: su4_objective_vjp_cuda(*in4, gbar4, sysd), 20),
                 time_ms(lambda: su4_objective_vjp_plain(*in4, gbar4, sysd), 2),
                 su4_vjp_bound(*shape4, rebuild=True))
    b8_row.update(b4_plus_b5_ms=b4_row["ms"] + b5_row["ms"], max_abs_err_vs_b5=e85,
                  vs_f64={"kernel": e8[1], "plain": e8[2]})
    # the per-gate paths: B7 at the GRAPE curve's shape (the CLI's pulse,
    # σ_δ = 0.3), B4 / B5 at the polish step's (the flagship's 5 tables,
    # σ_δ = 0.2, M = 4096, the polish's ḡ = 1 / (5 gates × 3 terms)), B6 at
    # the polish eval's; the variants: B6 on the bundle's L = 40 tables, B7
    # at the cz_drive2 sweep's shape (20 σ × VARIANT_SWEEP_M)
    gen4 = torch.Generator(device=dev).manual_seed(11)
    grape_p = torch.as_tensor(gq["pulses"], device=dev)[None].contiguous()
    d_curve = tuple(torch.randn((1, 4096), generator=gen4, device=dev) * s
                    for s in (0.3, 0.3, 0.05))
    b7_grape = su4_prop_row("grape-su4", (grape_p, *d_curve), sysd)
    pk = pq["packed"]
    pol_t = (pk[:, 0].contiguous(), pk[:, 1].contiguous())
    d_pol = tuple(torch.randn((5, 4096), generator=gen4, device=dev) * s
                  for s in (0.2, 0.2, 0.05))
    b4_pol, b5_pol, _ = su4_train_rows("polish-su4", (pq["pulses0"], *pol_t, *d_pol),
                                       torch.full((5,), 1.0 / 15, device=dev), sysd)
    b6_pol = su4_fid_row("polish-su4", (pq["pulses0"], *pol_t, *serve_draws), sysd)
    vk = vq["packed"]
    b6_var = su4_fid_row("serve-su4-variants", (vq["pulses"].contiguous(), vk[:, 0].contiguous(),
                                                vk[:, 1].contiguous(), *serve_draws), sysd)
    st = torch.as_tensor(np.arange(0.02, 0.42, 0.02), dtype=torch.float32, device=dev)[:, None]
    nv = [torch.randn((20, VARIANT_SWEEP_M), generator=gen4, device=dev) for _ in range(3)]
    b7_var = su4_prop_row("serve-su4-variants",
                          (torch.as_tensor(vq["d2_pulses"], device=dev)[None].contiguous(),
                           *((n * st).reshape(1, -1).contiguous() for n in nv[:2]),
                           (0.05 * nv[2]).reshape(1, -1).contiguous()), sysd)
    # slice 2: B1 at the bundles' scoring shape; B1, B3 and B2 at the GRAPE
    # step's, the polish step's and the ceiling's default shape (random P = 4
    # tables in its box, σ_δ = 0.4 draws)
    def su2_train_rows(path, p_, qt_, d_, e_):
        """B1, B3 and B2 (on B3's product, under a random cotangent) at a
        training shape."""
        B_, L_, P_ = p_.shape
        M_ = d_.shape[1]
        g_ = torch.randn((B_, M_, 4), generator=gen, device=dev)
        _, got_, want_ = check_vjp(f"at the {path} shape", p_, d_, e_, g_)
        q_ = propagate_mc_cuda(p_, d_, e_)
        b2 = row("B2", path, (B_, L_, P_, M_),
                 max(float((a - b).abs().max()) for a, b in zip(got_, want_)),
                 time_ms(lambda: propagate_mc_vjp_cuda(p_, d_, e_, g_, q_), 20),
                 time_ms(lambda: propagate_mc_vjp_plain(p_, d_, e_, g_), 2),
                 vjp_bound(B_, L_, P_, M_))
        b2["device_ms"] = device_ms(lambda: propagate_mc_vjp_cuda(p_, d_, e_, g_, q_))
        b2["libm_samples"] = libm_samples(p_, d_, e_)
        return [fid_row(path, p_, qt_, d_, e_, 20), prop_row(path, p_, d_, e_, 20), b2]

    slice2_rows = []
    for v in ("length_100_gates", "length_100_gates_p4"):
        s_ = sv["scores"][v]
        sgen2 = torch.Generator(device=dev).manual_seed(17)
        d_b = torch.randn((5, BUNDLE_MC), generator=sgen2, device=dev)
        e_b = 0.05 * torch.randn((5, BUNDLE_MC), generator=sgen2, device=dev)
        slice2_rows.append(fid_row("serve-variants", s_["table"].contiguous(), s_["q"], d_b,
                                   e_b, 20))
    slice2_rows += su2_train_rows("grape", g2["pulses"], g2["q"], *g2["errors"])
    fgen = torch.Generator(device=dev).manual_seed(19)
    d_f = torch.randn((5, 8192), generator=fgen, device=dev)
    e_f = 0.05 * torch.randn((5, 8192), generator=fgen, device=dev)
    slice2_rows += su2_train_rows("finetune", f2["pulses0"], f2["q"], d_f, e_f)
    Bc, Lc, Pc, Mc = CEILING_SHAPE
    box = ((-3.15, 3.15), (0.0, 1.0), (-5.0, 5.0), (0.1, 0.5))
    lo_c = torch.tensor([a for a, _ in box], device=dev)
    hi_c = torch.tensor([b for _, b in box], device=dev)
    p_c = (lo_c + (hi_c - lo_c) * (0.05 + 0.9 * torch.rand((Bc, Lc, Pc), generator=fgen,
                                                             device=dev))).contiguous()
    q_c = f2["q"][torch.arange(Bc, device=dev) % 5].contiguous()
    d_c = 0.4 * torch.randn((Bc, Mc), generator=fgen, device=dev)
    e_c = 0.05 * torch.randn((Bc, Mc), generator=fgen, device=dev)
    slice2_rows += su2_train_rows("ceiling", p_c, q_c, d_c, e_c)
    # slice 4a: B1, B3 and B2 at the mesh's local shapes (rank 0's block) and
    # at the runner's training shape
    mi = mesh_inputs(dev)
    half = MESH_SHAPE[3] // 2
    slice2_rows += su2_train_rows("mesh-1x2", mi["pulses"], mi["q_t"],
                                  mi["delta"][:, :half].contiguous(),
                                  mi["eps"][:, :half].contiguous())
    rows2 = MESH_SHAPE[0] // 2
    slice2_rows += su2_train_rows("mesh-2x1", mi["pulses"][:rows2].contiguous(),
                                  mi["q_t"][:rows2].contiguous(),
                                  mi["delta"][:rows2].contiguous(), mi["eps"][:rows2].contiguous())
    rgen = torch.Generator(device=dev).manual_seed(43)
    slice2_rows += su2_train_rows("run", rq["pulses"], rq["q"],
                                  torch.randn((200, 1000), generator=rgen, device=dev),
                                  0.05 * torch.randn((200, 1000), generator=rgen, device=dev))
    # slice 4b: B3 at the single-qubit figures' shapes on their own inputs
    # (the length_100 and length_100_p4 X(π) tables, the 1000 × 50 grid, the
    # estimate's draws, the sweeps' 199 σ × 10 000 draws, the longest SCORE
    # table, the Bloch ensemble), B7 at the bundle figure's and the two-qubit
    # demo's (the grid of two_qubit_d2_kak CZ, the sweep of cz_drive2)
    from universal_quantum_optimal_control_tpu_torch.analysis import plots as vplots
    from universal_quantum_optimal_control_tpu_torch.core.errors import sample_ore_ple
    vgen = torch.Generator(device=dev).manual_seed(2030)
    pv, p4v = (zq["tables"][v][0][None].contiguous() for v in ("length_100", "length_100_p4"))
    nd, ne = vplots._sweep_draws(vgen, 199, VIZ_MC, 0.05)
    st = torch.arange(1, 200, device=dev, dtype=torch.float32)[:, None] * 0.01
    sweep_d, sweep_e = (nd * st).reshape(1, -1).contiguous(), ne.reshape(1, -1).contiguous()
    gd, ge = torch.meshgrid(torch.linspace(-3.0, 3.0, 1000, device=dev),
                            torch.linspace(-0.15, 0.15, 50, device=dev), indexing="ij")
    est_d, est_e = (t[None].contiguous() for t in sample_ore_ple(vgen, (VIZ_MC,), 1.0, 0.05))
    bd, be, _, _ = zq["bloch"]["length_100_p4"]
    viz_inputs = {"grid": (pv, gd.reshape(1, -1).contiguous(), ge.reshape(1, -1).contiguous()),
                  "estimate": (pv, est_d, est_e), "sweep": (pv, sweep_d, sweep_e),
                  "sweep-p4": (p4v, sweep_d, sweep_e),
                  "score": (zq["score_z"][None].contiguous(), sweep_d, sweep_e),
                  "bloch-p4": (p4v, bd[None].contiguous(), be[None].contiguous())}
    viz_rows = []
    for key, args in viz_inputs.items():
        launches[f"viz ({key})"] = zq["launches"]
        viz_rows.append(prop_row(f"viz ({key})", *args, 20))
    bundle_p = torch.as_tensor(next(iter(zq4["bundle_pulses"].values())), dtype=torch.float32,
                               device=dev)[None].contiguous()
    n4 = [torch.randn((12, VIZ4_MC), generator=vgen, device=dev) for _ in range(3)]
    st4 = torch.arange(1, 13, device=dev, dtype=torch.float32)[:, None] * 0.05
    d4 = [(n * st4).reshape(1, -1).contiguous() for n in n4[:2]]
    e4 = (0.05 * n4[2]).reshape(1, -1).contiguous()
    launches["viz-su4 (bundle)"] = launches["viz-su4 (grid)"] = zq4["launches"]
    launches["viz-su4 (sweep)"] = zq4["launches"]
    viz_rows.append(su4_prop_row("viz-su4 (bundle)", (bundle_p, *d4, e4), sysd))
    dk = zq4["demo"]["two_qubit_d2_kak"]
    dkp = torch.as_tensor(dk["pulses"], dtype=torch.float32, device=dev)[None].contiguous()
    g61 = torch.as_tensor(dk["grid"][0], device=dev)
    g1, g2 = (x.reshape(1, -1).contiguous() for x in torch.meshgrid(g61, g61, indexing="ij"))
    viz_rows.append(su4_prop_row("viz-su4 (grid)", (dkp, g1, g2, torch.zeros_like(g1)),
                                 dk["system"]))
    n20 = [torch.randn((20, VIZ4_MC), generator=vgen, device=dev) for _ in range(3)]
    st20 = torch.arange(1, 21, device=dev, dtype=torch.float32)[:, None] * 0.02
    d2p = zq4["demo"]["cz_drive2"]
    viz_rows.append(su4_prop_row(
        "viz-su4 (sweep)", (torch.as_tensor(d2p["pulses"], dtype=torch.float32,
                                            device=dev)[None].contiguous(),
                            *((n * st20).reshape(1, -1).contiguous() for n in n20[:2]),
                            (0.05 * n20[2]).reshape(1, -1).contiguous()), d2p["system"]))
    kernels = [fid_row("serve", pulses, q_t, delta, eps, 20), b1_train, b2_train,
               prop_row("serve", p1, d1, e1, 20), prop_row("train", pt, dt_, et_, 50),
               b6_row, b7_row, b4_row, b5_row, b6_train, b8_row, b7_grape, b4_pol, b5_pol,
               b6_pol, b6_var, b7_var] + slice2_rows + viz_rows
    for k in kernels:
        occ = k.get("occupancy")
        if occ and "chunks" in occ:
            occ_msg = (f", plan K = {occ['chunks']}, {occ['blocks']} blocks, "
                       f"{occ['blocks_a_sm']:.2f} a SM, {occ['blocks_per_sm']} resident per SM, "
                       f"{occ['waves']:.2f} waves, {occ['warps_per_scheduler']:.2f} warps per "
                       f"scheduler")
        elif occ and "waves" in occ:
            occ_msg = (f", {occ['threads_per_block']} threads a block, {occ['blocks_per_sm']} "
                       f"blocks per SM, {occ['waves']:.2f} waves")
        elif occ:
            occ_msg = (f", {occ['lanes_per_sample']} lanes a sample, {occ['blocks_per_sm']} "
                       f"blocks per SM, {occ['warps_per_scheduler']:.2f} warps per scheduler")
        else:
            occ_msg = ""
        dev_msg = f" (device {k['device_ms']:.4f} ms)" if "device_ms" in k else ""
        print(f"  {k['name']} [{k['path']}] {k['shape']}: {k['ms']:.4f} ms{dev_msg}, plain "
              f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"err {k['max_abs_err']:.2e}, launches {k['launches']}, ptxas {k['ptxas']}"
              + occ_msg)
    print(f"  B1 [train] forward + backward {b1_train['fwd_bwd_ms']:.4f} ms, plain "
          f"{b1_train['fwd_bwd_plain_ms']:.3f} ms")
    print(f"  B4 + B5 [train-su4] forward + backward through mean_fidelity_su4_cuda "
          f"{b4_row['fwd_bwd_ms']:.4f} ms, plain {b4_row['fwd_bwd_plain_ms']:.3f} ms; B5 vs "
          f"f64: kernel {b5_row['vs_f64']['kernel']:.2e}, plain {b5_row['vs_f64']['plain']:.2e}")
    print(f"  B8 at the training shape {b8_row['ms']:.4f} ms beside B4 + B5 "
          f"{b8_row['b4_plus_b5_ms']:.4f} ms; |B8 - B5 seeded by B4| {e85:.2e}; B8 vs f64 "
          f"{e8[1]:.2e} (plain {e8[2]:.2e})")
    phase("time", t0, "CUDA events, after a warm-up")

    print(f"total {time.perf_counter() - t_total:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
