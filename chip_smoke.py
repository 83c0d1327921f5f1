#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``gomavatar_tpu_torch``) on one
NVIDIA H100: the quickest proof that the port builds, drives its main path
through its kernels, and agrees with its plain versions on the card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every CUDA kernel from the
     sources in gomavatar_tpu_torch/csrc (one nvcc per source, in parallel).
  2. kernel B1 (its two launches B1a and B1b) twice on the same inputs (the
     same bits), against its plain PyTorch version and against the plain
     twin of its two launches on the card,
     B1a's partials against the twin's, on the 64^2 gate scene (untrained,
     seed 0) and on the trained 512^2 frame, with and without the mesh pass,
     and with its slot arrays padded past 2,048 slots; then the whole
     gate-scene forward on the card against the same forward on the CPU;
     B1 timed through its wrapper and as B1a and B1b, with their work and
     bounds.
  3. the eval path: the trained 57,600-face avatar rendered at 512^2 by
     the eval program (``models.gom.eval_program``: ``gom_forward(train=
     False)`` captured once as a CUDA graph and replayed, ``programs.py``)
     on three frames (the packed frame and two with a perturbed pose vector
     and camera), with every launch count set to 0 just before and read
     just after (B1a and B1b once per frame, counted through the program's
     replays; one capture); drop counters, overflow and finiteness are
     checked, and each frame against the eager forward's: bit-equal where
     two eager runs are, else within their spread; then the eager and the
     captured forward timed (median and p90 of 100 synchronised frames
     after 3 warm-up) with their device time and busy share
     (torch.profiler), and the program's memory pool.
  4. the train path:
     a. kernels B2/B3 (splat blend) and B4/B5 (mesh raster) each twice on
        the same inputs (the same bits) and against their
        plain versions on the card, forward outputs, the residuals B2 and B4
        save for the backward, and entry gradients for the cotangents of a
        real loss, on the gate scene and on the trained 512^2 frame; B2 and
        B4 also against the plain twins of their two launches, and B2a's
        and B4a's partials against the twins'; B3a's per-entry replay of
        every owned chunk from B2's state, which must never cross 1e-4 on a
        chunk B2 let through; each kernel (B3 as its two launches B3a and
        B3b, B2 and B4 through their wrappers and as B2a, B2b, B4a and B4b)
        and plain version timed there;
     b. one gate-scene train step on the card against the same step on the
        CPU: loss terms and the step's gradients;
     c. the main path: 5 ``Trainer.step`` calls (the trainer's train
        program, captured once and replayed) on the trained avatar at
        512^2 (its train config, the optimizer fast-forwarded to its
        iteration), over the three frames with the port's own eval renders
        as targets, every launch count set to 0 just before and read just
        after; B2a, B2b, B3a, B3b, B4a, B4b and B5 must launch once per
        step, nothing may be dropped and every loss, gradient and parameter
        must be finite; the program's memory pool; then, under torch's
        default algorithms, the same 5 steps by a second trainer from the
        same state and by the eager step: params, Adam moments, counts and
        the total bit-equal after each step (0 values may differ); the ops
        one eager step reaches that torch names under
        ``use_deterministic_algorithms(True, warn_only=True)``, and every
        scatter op it reaches with its dtypes (none on float data); the
        device ms of the step's index transposes (torch.profiler: the
        gathers' backward through ``mesh_ops.gather_vjp``, the neighbour
        sums, the per-frame entry table's build) and each table's bytes;
        the LPIPS trunk channels-last: ``lpips.trunk_nhwc`` counted at the
        capture, and no cuDNN layout transpose (``nchwToNhwc``,
        ``nhwcToNchw``) in a profiled stretch of captured steps;
     d. the eager and the captured train step timed (median and p90 over 20
        steps after 3 warm-up) with their device time and busy share
        (torch.profiler), and each kernel's work and bound; then the
        captured step under torch's deterministic algorithms (captured under
        them), under them without their fill of new memory, and the default
        one, 20 steps each in turns, with their device ms (CUDA events);
        then phases 2-4d again in 3 child processes, one after another,
        each profiling those three programs at its end (torch.profiler),
        each required to exit with 0 (the profiler crashed such replays
        while it kept CUPTI set up between its sessions; ``programs.py``
        has it torn down).
  5. the drivers, in-process (``cli.train.main``, ``cli.evaluate.main``),
     each run with every launch count set to 0 just before and read just
     after:
     a. fixtures: a 512^2 capture of 6 train and 2 test frames written by
        ``data/synthetic.py`` with the trained avatar's base body (14,400
        faces), and the exp yaml of the trained avatar's configs;
     b. the trained avatar saved as the port's checkpoint iter_6100, then
        ``cli.evaluate --type train`` (ZJU protocol) and ``--type view``
        (snapshot protocol, AlexNet-LPIPS): the replayed subdivision to
        57,600 faces, B1a and B1b once per frame, 0 dropped, finite
        metrics, PNGs that are not black, the first frame equal to the
        avatar rendered in memory;
     c. ``cli.train --resume --max_iters 6103`` with one periodic eval and
        one save: B2a-B5 once per step, B1 once per eval frame, no dropped
        entry (the opt-in per-step check), iter_6103 restored into a fresh
        Trainer bit-equal to the run's; then the host decode of one item
        and the steady loop's steps/s over two logged windows of 10;
     d. the phase change on the card: the gate scene from init with
        subdivide_iters [2], 4 steps on the card, each also taken on the
        CPU from the card's state, the loss terms and every leaf's gradient
        (from Adam's first moments) close at every step, the faces x4 from
        step 2 on, every train kernel once per step, and the train program
        captured once in each phase (a new program at the subdivision); a
        second trainer on the card from the same init bit-equal to the
        first after every step, across the subdivision;
     e. the gate scene's free trajectories from one init, 40 steps
        subdividing at step 20, LPIPS in float32 on both devices: the card's
        train program, a CPU trainer, and a CPU witness whose float params
        are moved one float32 up before every step; each step's three total
        losses and their differences from the CPU's; at the end of each
        phase the card's change of the params over the phase parts from the
        CPU's (relative L2 over all leaves) by at most 2x the witness's,
        which must part.
  6. pose refinement and animation, each run with every launch count set
     to 0 just before and read just after:
     a. the gate scene's pose loss (``cli.train_pose.frame_loss``: rgb and
        mask L1, VGG-LPIPS) and its gradient in (Rh, Th, pose) at
        Rh = Th = 0 and a pose perturbed by N(0, 0.03), card against CPU:
        the loss within rtol 1e-2 (LPIPS on), each gradient within 5 % of
        its norm, all finite;
     b. 30 steps of ``make_pose_optimizer`` on the trained avatar at 512^2
        from the packed frame's joint angles plus N(0, 0.03) (numpy seed
        0) towards the port's render of the packed frame: B2a-B5 once per
        step (the pose program, captured once), 0 dropped entries, the best
        loss below the first; the first and best loss, the joint-angle and
        posed-joint errors before and after; the 30 captured steps again
        from the same pose and the eager ones, losses and best pose
        bit-equal to the first run's; ``lpips.trunk_nhwc`` counted at the
        capture and no cuDNN layout transpose in a profiled stretch of
        captured steps; every scatter op one eager pose step
        reaches (none on float data); the captured and the eager step's
        mean (30 steps, one synchronize at the end) and s per test frame,
        and the captured median of 20 synchronised one-step calls;
     c. ``cli.train_pose --max_frames 2`` over the 5a test capture from
        iter_6100 with 10 steps per frame, halving every 5: each train
        kernel 20 times, B1a and B1b 6 times (raw, zeroed and refined
        evaluations), pose.pkl, finite metrics, PNGs not black; then
        ``cli.evaluate --type view --pose_path`` uses the refined poses;
     d. ``cli.animate --cfgs`` with the trained avatar twice (freeview, 4
        frames) and ``--synthetic 2 --type mdm`` (2 frames) at 512^2: B1a
        and B1b once per scene and frame, each strip 1024 x 512 with both
        halves not black, frames/s.
  7. the multi-rank layer (``gomavatar_tpu_torch.parallel``) through the
     rank programs (``programs.RankProgram``: over NCCL one captured CUDA
     graph around the collective, over gloo on the card two graphs with the
     collective on the host between their replays), each path's launches
     and collectives counted on each rank through the replays (set to 0
     just before it, read just after); every bit check under torch's
     default algorithms (the train step adds in a fixed order, 4c), and
     every phase under one cuBLAS workspace config
     (``CUBLAS_WORKSPACE_CONFIG=:4096:8``):
     a. the data-parallel step at world 1 over NCCL (``Trainer(group=...)``,
        one graph): 5 steps on the trained avatar, the params and Adam
        moments bit-equal to ``Trainer.step``'s and to the eager rank step's
        (``make_data_parallel_train_step``) after each, B2a-B5 once per step
        and one all-reduce per step, one capture; then the captured and the
        eager rank step timed in turns with ``Trainer.step`` (median, p90,
        device ms and busy share), the program's memory pool, and the
        reducer alone;
     b. world 2 on the one card over gloo (two graphs per rank): 3 steps on
        frame pairs, both replicas bit-equal after each and rank 0 bit-equal
        to the one-process mean-gradient step, (g_a + g_b) / 2 before Adam,
        one capture per rank; each rank's captured and eager step medians,
        its pool, and the two ranks' frames/s, captured and eager, against
        7a's;
     c. the tile-parallel render: B1 on 2, 4 and 8 shares of the slots in one
        process, concatenated bit-equal to the one-call sweep below n_active,
        each share against the plain version and timed; then worlds 1 (NCCL),
        2 and 4 (gloo on the one card), two frames each through the program,
        rgb and alpha bit-equal to ``render_frame_eval``, n_active and each
        rank's n_local, 0 dropped, B1a and B1b once per rank and frame, one
        all-gather per frame, one capture; the captured and the eager frame
        timed in turns on each rank (world 1 beside phase 3's captured eval
        frame);
     d. the multi-scene render of the trained avatar and a recoloured copy at
        worlds 1 (NCCL) and 2 (gloo), each scene through its own eval
        program, two calls: each scene, in order, bit-equal to its own
        ``gom_forward(train=False)``, B1 once per scene on its rank, one
        all-gather per output per call;
     e. with 2 cards or more: 7b-7d over 2 cards with NCCL and ``cli.train
        --data_parallel 2`` for 2 steps over the 5a capture; with one card a
        line says it did not run.
  8. the end-to-end demonstration chain (``gomavatar_tpu_torch.tools``),
     its train, pose and eval steps through their programs, each run with
     every launch count set to 0 just before and read just after:
     a. ``overfit_check`` at its defaults (two frames at 128^2, 400 steps):
        more than +5 dB of train-view PSNR, B2a-B5 once per step;
     b. ``run_e2e`` at 512^2 at full width on a short schedule (its first
        line lists the cuts): the teacher capture (B1 once per frame, four
        544^2 windows per raw frame), train through the subdivision, resume,
        the five evaluations, the noisy chain, export, the report; every
        stage ends, 0 dropped in the teacher renders, every logged step and
        every evaluation, the faces x4 at the split, B2a-B5 once per train
        and pose step and B1 once per render, and the exported avatar
        reloaded by ``convert.load_trained`` renders evaluate's frame; then
        the chain again from the same capture into logs of its own: the
        exported params bit-equal and every drop counter equal;
     c. B1 at the raw capture's 544^2 windows (1,156 tiles, x4 budgets, one
        binning band): the teacher's first raw frame from novel view 1 over
        8b's capture, its four windows through ``gom_forward(train=False)``
        (B1a and B1b once per window, 0 dropped, finite), then the busiest
        window with an active tile id past 1,023 (else the busiest) through
        B1 and its plain version on the same entries, held to B1's criteria
        as in phase 2.
  9. the seeded draws (``gomavatar_tpu_torch.prng``, the port's copy of
     ``jax.random``; there is no JAX on the card's machine):
     a. the e2e teacher's shadow MLP drawn from ``prng.key(7)`` bit-equal to
        JAX's draw (``weights/e2e_teacher_shadow.npz``);
     b. every draw of the witness ``weights/prng_witness.npz`` (JAX's split,
        bits, uniform and normal for six seeds, and the first and last 64
        values of each LPIPS conv draw) bit-equal to the port's;
     c. the random VGG16 (14.7 M normals) and AlexNet trunks' draw times on
        the host;
     d. ``tools/tune_trained_budgets`` on JAX's trained avatar at 512^2 at
        the budgets 32, 40 and 48, with every launch count set to 0 just
        before and read just after: each setting's counters (0 dropped
        required) and forward median and p90, B1a and B1b once per forward.
 10. calibrated LPIPS (``models.lpips.load_torch_{vgg16,alexnet,heads}``,
     ``save_npz``, ``tools/calibrate_lpips``), each run with every launch
     count set to 0 just before and read just after:
     a. VGG16 and AlexNet state dicts in torchvision's layout drawn from
        numpy seed 0 (He-scaled weights, nonzero biases, a few small
        ``classifier.*`` keys) and LPIPS head files with negative entries,
        converted by ``tools/calibrate_lpips.main``; ``load_lpips`` on the
        card reports both CALIBRATED, the params exactly the state dicts'
        tensors (the heads clamped at 0);
     b. both trunks' LPIPS on the card against the CPU, the trained
        avatar's 512^2 frame against a copy with N(0, 0.05) added: float32
        within rtol 1e-4, bfloat16 within rtol 1e-2; the VGG loss's input
        gradient in float32 and bfloat16 on each device against the float64
        gradient on the CPU, the card's no farther from it than the CPU's
        plus 5 % of its norm (the card against the CPU, and the card at the
        input moved by one ulp, printed beside), on the whole frame and on
        the subject's crop (the mask's bounding box padded by 8 pixels, in
        blocks of 16) of the same render over a seeded textured background,
        where the card's float32 gradient must also lie within 5 % of its
        norm of the CPU's;
     c. with GOMAVATAR_LPIPS_DIR (``WEIGHTS_DIR``) at the converted files,
        from the trained avatar's checkpoint: ``cli.evaluate --type train``
        (VGG) and ``--type view`` (AlexNet) report ``lpips``, not
        ``lpips_uncalibrated``, B1a and B1b once per frame, the first
        frame's lpips within rtol 1e-2 of the CPU's on the same arrays;
        ``cli.train --resume`` for 3 steps trains with the calibrated trunk,
        a finite lpips term and B2a-B5 once per step;
     d. 3 captured ``Trainer.step`` calls with the converted VGG trunk as
        the loss, bit-equal to the eager step from the same state under
        the default algorithms, B2a-B5 once per step; then the captured
        step with the converted and with the random trunk timed in turns
        (20 steps each after 3, CUDA events).
 11. the train data on the card and the grown budget, from the benchmark's
     two train cells (``portbench/``: their frames, 96 at 1024^2 and 96 at
     540^2, and their state, from the seed CARD_DATA_SEED):
     a. every frame's item from ``cli.train.train_dataset`` on the card (its
        store; the composite and resizes by ``csrc/composite_resize.cu``)
        bit-equal to the same item by the host's float64 composite and
        cv2.resize, and the kernel bit-equal to its plain float64 version
        on the card at the same background, at 1024^2 -> 512^2 and 540^2
        -> 544^2; the kernel's ms (CUDA events) and an item's host ms on
        both paths;
     b. ``zju377.train``'s loop from its state for BUDGET_STEPS steps in a
        child process under GOMAVATAR_DEBUG_BINNING=1 (the trainer reads
        its three drop counters after every step and fails on a drop),
        which must exit with 0: the per-splat budget as it grew, the widest
        splat over each 10 steps and the wall time of each step that
        captured a grown program;
     c. a 540^2 frame at its own size (``snapshot_m3c_540``'s data): the
        kernel and its plain version on the card bit-equal to the host's
        (``cv2.resize`` copies a frame at its own size), the composite with
        no resample.
     Alone: ``python3 -c "import chip_smoke as s; s.phase_card_data(s.card_line())"``.
 12. the LPIPS distance head (``csrc/lpips_head.cu``) on the taps of the
     random VGG16 trunk at 512^2, 544^2 and 540^2 (three odd taps) and of
     the AlexNet trunk at 512^2 (bfloat16, a textured target and the
     prediction a little off it),
     and of VGG16 at 512^2 in float32, each with its taps NCHW and
     channels-last (the trunk's layout on the card): the value within 1e-5 relative of
     ``lpips_head_plain``'s on the card and every bfloat16 gradient element
     within one bfloat16 ulp of the plain path's plus 2^-16 of the float32
     envelope of its terms (``HEAD_F32_ENV``; the counts past one ulp and
     each path's largest error against the float64 gradient printed;
     float32: within 1e-5 of the largest); its forward and backward
     captured in a CUDA graph, 3 launches per capture, 50 replays bit-equal
     to each other and to the eager call; the kernel pair and the plain
     head (with its float32 casts) each captured and timed by CUDA events
     over back-to-back replays, beside the bytes bound.  Then the whole
     LPIPS loss of a step (both trunks and the head, forward and the
     backward into the prediction) captured and timed at VGG 512^2, 544^2,
     540^2 and AlexNet 512^2 in the NCHW layout the trunk ran in before it
     ran channels-last on the card (the layout rule patched off, the float32
     weights cast per call) and channels-last: the values within 1e-2
     relative, the channels-last input gradient no farther from the float32
     trunk's than 1.1x the NCHW one's, and the device ms of cuDNN's layout
     transposes in each (none channels-last).
     Alone: ``python3 -c "import chip_smoke as s; s.phase_lpips_head(s.card_line())"``.
The programs' warm-up and capture are set-up: the launches they count are
taken back, and every replay adds the captured call's launches, so a count
is one per frame or step on every path, as the eager paths gave it.
Kernel times are CUDA events around back-to-back calls after a warm-up;
each part of a two-launch kernel also prints its device time (the calls
queued behind a device-side sleep) beside it, as a diagnostic.
Each phase prints its seconds. The last thirteen lines are phase 12's
numbers as JSON, phase 11's numbers as JSON, phase 10's numbers as JSON,
phase 9's numbers as JSON, phase 8's numbers as JSON, phase 7's numbers as
JSON, the pose and
animation numbers as JSON, the drivers' numbers as JSON, the forward
timings as JSON, the train-step timings as JSON, the kernels JSON line
(each kernel's launches on phase 7's paths under ``parallel_launches``, on
phase 8's under ``e2e_launches``, in 9d under ``sweep_launches``, in 10c
and 10d under ``calibrated_launches``), the card
line and the result JSON. Without a CUDA card it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-vs-plain criteria for rgb and alpha: the JAX package's fused/unfused
# gate (bench.py): > 99.95 % of values within 1e-4, worst under 5e-3 (float
# reassociation near the T < 1e-4 termination can flip one entry on
# isolated pixels).  sel: hit equal on >= 99.9 % of pixels, normal and
# shading within 1e-4 wherever the hits agree.
CLOSE_TOL, CLOSE_FRAC, WORST_MAX = 1e-4, 0.9995, 5e-3
HIT_FRAC, SEL_TOL = 0.999, 1e-4
# train kernels against their plain versions, the JAX package's own
# kernel-vs-jnp tolerances (tests/test_train_kernels_interpret.py): B2 by the
# rule above; B3's entry gradients > 99.9 % within 2e-4 + 1e-3 |plain|; B4
# hit as above, the normal within 1e-5 where the hits agree, the soft
# silhouette > 99.9 % within 1e-4; B5's entry gradients > 99.9 % within
# 5e-3; every value finite
GRAD_FRAC, GRAD_ATOL, GRAD_RTOL = 0.999, 2e-4, 1e-3
NORMAL_TOL, SOFT_TOL, MESH_GRAD_TOL = 1e-5, 1e-4, 5e-3
# the residuals the forward kernels save, against their plain versions: B4's
# winner equal on >= 99.9 % of pixels (as the hit), its S within 1e-4
# relative on > 99.9 % (1e-7 absolute where S is near 0), its live chunk
# count equal on every tile; B2's chunk-start transmittance within 1e-4 on
# > 99.95 % of the values both hold, the spent sentinel equal on >= 99.9 %
S_RTOL, S_ATOL, STATE_TOL, STATE_FRAC = 1e-4, 1e-7, 1e-4, 0.9995

# Published H100 SXM peaks (H100 SXM data sheet): float32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of B1's inner loop per (pixel, entry) pair, counted from
# csrc/frame_render.cu: the splat term 27 (11 for the power polynomial, the
# exp, 4 for the alpha gates, 4 for the transmittance step, 7 for the rgb
# and alpha accumulation), the mesh term 19 (12 for the two barycentric and
# the depth planes, 2 for w2, 5 compares).  The splat term is counted only
# for pairs a pixel still evaluates (before its transmittance is spent);
# the mesh term for every swept pair.
SPLAT_OPS, MESH_OPS = 27, 19
# exp runs on the special-function units: 16 results per SM per clock at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs, 1.98 GHz boost clock (H100 SXM data sheet).
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

# fp32 operations of the train kernels, counted from their sources
# (csrc/splat_composite.cu, csrc/mesh_raster.cu), and their exp/log on the
# special-function units.  Per live splat pair (the pixel's transmittance not
# yet spent): B2 (B2a) as B1's splat term, 27 and one exp, B2b's re-sweeps
# and B2a's pairs past the pixel's stop not counted; B3a 27 (11 for the
# power polynomial, 4 for the alpha gates, 4 for the transmittance step, 6
# for u, 2 for the u w sum) and one exp; B3b 72 (16 for the alpha, 40 for
# the alpha, conic, mean, opacity and color gradients, 9 to add each pair's
# nine values into its entry's sums, 7 for the transmittance and the
# suffix) and one exp.  B4 sets up each entry of a swept chunk once, outside
# its pixel loop: 11 for the barycentric set-up, and 21 (7 for each edge's)
# for an entry whose soft term runs (valid, tile not yet saturated).  Per
# swept mesh pair, the hard term: 22 in B4 (the pixel's offset to vertex 2,
# the two barycentrics with their IEEE divisions, w2, three compares, the
# depth, the flag and the z-test); 1 in B5 (the winner compare).  Per soft
# pair: 61 in B4 (17 for each edge projection, the minimum, the sign,
# sigmoid and log1p, the sum), an exp and a log.  B5 sets up each valid
# entry of a live soft chunk once, outside its pixel loop: 32 (11 for the
# barycentric set-up, 7 for each edge's); then, per soft pair whose pixel's
# dL/dS is not 0, 239 in the pixel loop (15 for the inside test: the two
# barycentrics, w2 and three compares; 17 for each edge projection; 6 for
# the sign and sigmoid; the hand-written chain of 167 with the six
# coordinate sums) and one exp.
B2_OPS, B3A_OPS, B3B_OPS, B2_SFU, B3A_SFU, B3B_SFU = 27, 27, 72, 1, 1, 1
B4_HARD, B4_ENTRY_HARD, B4_SOFT, B4_ENTRY_SOFT, B4_SFU = 22, 11, 61, 21, 2
# B4 counted as a sweep that derives the set-ups on every pair: 31 per
# swept pair (barycentric set-up included), 81 per soft pair (the edges')
PAIR_B4_HARD, PAIR_B4_SOFT = 31, 81
B5_HARD, B5_ENTRY, B5_SOFT, B5_SFU = 1, 32, 239, 1
# the same counts for the earlier kernels, which replayed the forward: B3 100 ops
# and two exps per live splat pair; B5 64 per swept pair, 329 and two exps
# and two logs per soft pair
REPLAY_B3_OPS, REPLAY_B3_SFU, REPLAY_B5_HARD, REPLAY_B5_SOFT, REPLAY_B5_SFU = 100, 2, 64, 329, 4

# 100 timed forwards: the p90 has 10 samples beyond it; 20 timed train
# steps after 3 warm-up steps
FORWARD_ITERS, KERNEL_ITERS, PLAIN_ITERS = 100, 50, 5
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_ITERS = 5, 3, 20
# 4d: the child processes that profile the deterministic-mode step
DET_PROFILE_CHILDREN = 3
# the calls of a torch.profiler window (device time and busy share): the
# profiler's post-processing of an eager path's thousands of launches per
# call grows with the window
PROFILE_WINDOW = 5
# the gate-scene train step, card against CPU: every loss term within rtol
# 1e-3 (LPIPS runs its convolutions in bfloat16, which cuDNN and the CPU
# round differently: rtol 1e-2), each parameter leaf's gradient within 5 %
# of its norm (relative L2)
STEP_RTOL, STEP_LPIPS_RTOL, STEP_GRAD_REL = 1e-3, 1e-2, 5e-2


def require(ok, message: str) -> None:
    """A failed check ends the smoke with an error (asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean time of one call over ``iters`` back-to-back calls, after one
    warm-up, between two CUDA events: the kernels line's ``ms``.  Where a
    call's host time (argument checks, allocations, the ctypes launch)
    exceeds its device time, this measures the host."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SM_CLOCK_HZ = 1.98e9  # the H100 SXM boost clock: the cycles of torch.cuda._sleep


def device_ms(fn, iters: int) -> float:
    """A diagnostic beside :func:`cuda_ms`: the mean device time of one call,
    its ``iters`` calls enqueued behind a device-side sleep of 1.5x the host
    time they take (measured on a synchronised call), so that the events see
    device work only."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * host_s * iters * SM_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_split(label: str, whole, parts: dict) -> dict:
    """A kernel of two launches timed by :func:`cuda_ms` through its whole
    wrapper (``whole``) and through each launch's wrapper (``parts``), with
    each one's device time printed beside it.  Returns {"ms": whole, "parts":
    {name: ms}}."""
    fns = {"whole": whole, **parts}
    ms = {k: cuda_ms(f, KERNEL_ITERS) for k, f in fns.items()}
    dev = {k: device_ms(f, KERNEL_ITERS) for k, f in fns.items()}
    print(f"  {label}: " + ", ".join(f"{k} {ms[k]:.4f} ms (device {dev[k]:.4f})" for k in fns)
          + " by events around back-to-back calls (device time: the calls queued behind a sleep)")
    return {"ms": ms["whole"], "parts": {k: ms[k] for k in parts}}


def counted(fn):
    """(fn(), launches of every kernel during it, wall seconds): the counts
    set to 0 just before and read just after, the device synchronised."""
    from gomavatar_tpu_torch.programs import kernel_wrappers

    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {k: w.launches for k, w in wrappers.items()}, seconds


def same_bits(label: str, fn, view) -> None:
    """A kernel's wrapper called twice on the same inputs: what its consumer
    reads of the outputs (``view(outputs)``; slots a launch does not write
    hold stale bytes) bit-equal.  The atomic tickets and pixel compactions
    of B1-B3 order work, never sums."""
    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else [t for v in x for t in flat(v)]

    first, second = flat(view(clone_tree(fn()))), flat(view(fn()))
    same = len(first) == len(second) and all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  {label} twice on the same inputs: {'bit-equal' if same else 'apart'}")
    require(same, f"{label}: two launches on the same inputs differ")


def check_close(label: str, a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs()
    frac = float((d <= CLOSE_TOL).float().mean())
    worst = float(d.max())
    print(f"  {label}: {frac * 100:.4f} % within {CLOSE_TOL:g}, worst {worst:.3g}")
    require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite values")
    require(frac > CLOSE_FRAC and worst < WORST_MAX, f"{label}: outside the criteria")
    return worst


def check_sel(label: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """a, b: (H, W, 5) selections [normal xyz, shading, hit]."""
    same_hit = a[..., 4] == b[..., 4]
    frac = float(same_hit.float().mean())
    both = same_hit & (a[..., 4] > 0)
    d = (a[..., :4] - b[..., :4]).abs().amax(dim=-1)
    worst = float(d[both].max()) if bool(both.any()) else 0.0
    print(f"  {label}: hit equal on {frac * 100:.4f} %, normal+shading worst {worst:.3g} "
          f"over {int(both.sum())} hit pixels")
    require(frac >= HIT_FRAC and worst <= SEL_TOL, f"{label}: outside the criteria")


def compare_b1(label, table, bins, img_size):
    """Kernel B1 (B1a then B1b) vs its plain version and vs the plain twin of
    its two launches on the same entries, with and without the mesh pass;
    B1a's partials vs the twin's; B1 with its slot arrays padded.  Returns
    (worst rgb/alpha difference, {"ms": the wrapper's, "plain_ms", "parts":
    {"B1a": ms, "B1b": ms}}), the times with the mesh pass on."""
    from gomavatar_tpu_torch.ops import frame_render as FR

    entries = FR.gather_entries(table, bins)
    args = (entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, bins.num_tiles_x)
    worst = 0.0
    resweeps = {}
    for with_mesh in (True, False):
        k = FR.frame_sweep(*args, with_mesh=with_mesh)
        p = FR.frame_sweep_plain(*args, with_mesh=with_mesh)
        tw = FR.frame_split_plain(*args, with_mesh=with_mesh, stats=resweeps if with_mesh else None)
        torch.cuda.synchronize()
        tag = f"{label} {'mesh on' if with_mesh else 'mesh off'}"
        n = int(bins.n_active)
        same_bits(f"{tag} B1", lambda: FR.frame_sweep(*args, with_mesh=with_mesh),
                  lambda out: [x[:n] for x in out if x is not None])
        for ref, name in ((p, "plain"), (tw, "twin")):
            for i, out in ((0, "rgb"), (1, "alpha")):
                worst = max(worst, check_close(f"{tag} {out} vs {name}", FR.untile(k[i], bins, img_size),
                                               FR.untile(ref[i], bins, img_size)))
            if with_mesh:
                check_sel(f"{tag} sel vs {name}", FR.untile(k[2], bins, img_size), FR.untile(ref[2], bins, img_size))
        check_b1_partials(tag, FR.frame_partials(*args, with_mesh=with_mesh),
                          FR.frame_chunk_partials_plain(*args, with_mesh=with_mesh), with_mesh,
                          FR.chunk_plan(*args[2:5], FR.NCMAX, FR.num_pairs(entries.shape[1], args[1].shape[0])))
    print(f"  {label} B1 twin: {resweeps['resweeps']} (pixel, chunk) re-sweeps, {resweeps['resweep_pairs']} "
          f"(pixel, entry) pairs re-swept")
    check_b1_padded(label, args)
    partials = FR.frame_partials(*args)
    timed = time_split(f"{label} B1", lambda: FR.frame_sweep(*args),
                       {"B1a": lambda: FR.frame_partials(*args), "B1b": lambda: FR.frame_merge(*args, partials)})
    timed["plain_ms"] = cuda_ms(lambda: FR.frame_sweep_plain(*args), PLAIN_ITERS)
    print(f"  {label}: B1 {timed['ms']:.4f} ms, plain version {timed['plain_ms']:.3f} ms")
    return worst, timed


PADDED_SLOTS = 2304  # nine runs of 256 slots in B1's chunk plan


def check_b1_padded(label, args):
    """B1 on the same entries with its slot arrays padded past n_active to
    PADDED_SLOTS (at least 256 more than they hold): the active slots'
    outputs bit-equal to the unpadded call's.  B1 takes any number of active
    slots."""
    from gomavatar_tpu_torch.ops import frame_render as FR

    entries, active_id, seg_start, seg_count, n_active, tiles_x = args
    A = active_id.shape[0]
    slots = max(PADDED_SLOTS, A + 256)
    padded = [torch.cat([t, t.new_zeros(slots - A)]) for t in (active_id, seg_start, seg_count)]
    got = FR.frame_sweep(entries, *padded, n_active, tiles_x)
    want = FR.frame_sweep(*args)
    n = int(n_active)
    same = all(bool(torch.equal(g[:n], w[:n])) for g, w in zip(got, want))
    print(f"  {label} B1 at {slots} slots (from {A}): outputs of the {n} active slots bit-equal: {same}")
    require(same, f"{label}: B1 with padded slot arrays differs")


def check_b1_partials(label, kernel, plain, with_mesh, plan):
    """B1a's partials against the twin's on the pairs of the chunk plan: the
    kernel's plan equal to ``plan``, the crossed flags equal on >= 99.9 % of
    values, the local sums and transmittance within 1e-4 on > 99.95 % of
    the values both hold, the z-buffer partial's entry equal on >= 99.9 %."""
    from gomavatar_tpu_torch.ops.frame_render import CROSSED

    (part_k, idx_k, end_k, _), (part_p, idx_p) = kernel, plain
    require(bool(torch.equal(end_k, plan)), f"{label} B1a: the chunk plan differs from its plain version")
    n = int(end_k[-1])
    part_k, part_p, idx_k, idx_p = part_k[:n], part_p[:n], idx_k[:n], idx_p[:n]
    require(bool(torch.isfinite(part_k[:, :5]).all()), f"{label} B1a partials: non-finite values")
    crossed_k, crossed_p = part_k[:, 4] == CROSSED, part_p[:, 4] == CROSSED
    same = float((crossed_k == crossed_p).float().mean())
    both = (~crossed_k & ~crossed_p)[:, None, :].expand(-1, 5, -1)
    frac = float(((part_k[:, :5] - part_p[:, :5]).abs() <= CLOSE_TOL)[both].float().mean())
    win = float((idx_k == idx_p).float().mean()) if with_mesh else 1.0
    print(f"  {label} B1a partials: {n} (tile, chunk) pairs, crossed equal on {same * 100:.4f} %, "
          f"{frac * 100:.4f} % within {CLOSE_TOL:g}, z-buffer entry equal on {win * 100:.4f} %")
    require(same >= HIT_FRAC and frac > CLOSE_FRAC and win >= HIT_FRAC, f"{label} B1a partials: outside the criteria")


def frame_inputs(params, statics, cfg, frame):
    from gomavatar_tpu_torch.models import modules as M
    from gomavatar_tpu_torch.models.gom import frame_table_and_bins, posed_vertices

    verts_obs = posed_vertices(
        params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
        frame["dst_posevec"],
    )
    colors = M.appearance_apply(params["appearance"])
    return frame_table_and_bins(params, statics, cfg, verts_obs, colors, frame["K"], frame["E"])


def forward(params, statics, cfg, frame, device="cuda"):
    from gomavatar_tpu_torch.models.gom import gom_forward

    return gom_forward(
        params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"],
        frame["dst_Rs"], frame["dst_Ts"], dst_posevec=frame["dst_posevec"], i_iter=1e7,
        device=device,
    )


def perturbed_frames(frame, seed: int = 0):
    """The packed frame plus two novel views: the camera turned +-0.3 rad
    about the vertical axis through the origin, the pose vector jittered."""
    rng = np.random.default_rng(seed)
    dev = frame["E"].device
    frames = [frame]
    for angle in (0.3, -0.3):
        c, s = np.cos(angle), np.sin(angle)
        Ry = torch.tensor(
            [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], dtype=torch.float32, device=dev
        )
        f = dict(frame)
        f["E"] = frame["E"] @ Ry
        jitter = rng.normal(0.0, 0.05, frame["dst_posevec"].shape).astype(np.float32)
        f["dst_posevec"] = frame["dst_posevec"] + torch.as_tensor(jitter, device=dev)
        frames.append(f)
    return frames


def b1_work(table, bins, ncmax: int):
    """(ops, {B1, B1a, B1b: bytes}, swept entries, swept pairs, live splat
    pairs, (tile, chunk) pairs) of one B1 call on this frame's data: entries
    swept (clamped to ncmax chunks from the aligned-down start), the (pixel,
    entry) pairs, and the pairs whose splat term is still live (the pixel's
    transmittance not yet spent).  B1 reads the entries and the slot arrays
    and writes its outputs; B1a reads the entries and the slot arrays and
    writes its partials, the chunk plan and the zeroed tickets; B1b reads
    the partials, the plan, the slot arrays and the selection rows of each
    pixel's winner, takes its tickets and writes the outputs (its re-sweeps
    are not counted)."""
    from gomavatar_tpu_torch.ops.frame_render import NPART, P, chunk_plan, gather_entries, num_pairs
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE
    from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS

    entries = gather_entries(table, bins)
    n = min(int(bins.n_active), bins.active_id.shape[0])
    start = bins.seg_start[:n].long()
    count = bins.seg_count[:n].long()
    head = start % CHUNK
    swept = torch.minimum(count, ncmax * CHUNK - head)
    L = int(swept.max())
    dev = entries.device
    lane = torch.arange(L, device=dev)[None, :]
    ok = lane < swept[:, None]
    e = entries[:, torch.clamp_max(start[:, None] + lane, entries.shape[1] - 1)]  # (NCH, n, L)
    tile = bins.active_id[:n].long()
    px = ((tile % bins.num_tiles_x) * TILE)[:, None, None] + (torch.arange(P, device=dev) % TILE)[None, :, None]
    py = ((tile // bins.num_tiles_x) * TILE)[:, None, None] + (torch.arange(P, device=dev) // TILE)[None, :, None]
    dx = px.float() - e[0][:, None, :]
    dy = py.float() - e[1][:, None, :]
    power = -0.5 * (e[2][:, None, :] * dx * dx + e[4][:, None, :] * dy * dy) - e[3][:, None, :] * dx * dy
    alpha = torch.clamp_max(e[5][:, None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power > 0) | (alpha < ALPHA_MIN) | ~ok[:, None, :], 0.0, alpha)
    t_excl = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1]], -1), -1)
    live = int(((t_excl >= T_EPS) & ok[:, None, :]).sum())
    pairs = int(swept.sum()) * P
    ops = SPLAT_OPS * live + MESH_OPS * pairs
    A = bins.active_id.shape[0]
    chunk_pairs = int(chunk_plan(bins.seg_start, bins.seg_count, bins.n_active, ncmax,
                                 num_pairs(entries.shape[1], A))[-1])
    ints = 4 * (3 * n + 1)  # active_id, seg_start, seg_count, n_active
    in_bytes = int(swept.sum()) * entries.shape[0] * 4
    out_bytes = n * (3 + 1 + 5) * P * 4
    part_bytes = chunk_pairs * (NPART + 1) * P * 4
    nbytes = {"B1": in_bytes + out_bytes + ints, "B1a": in_bytes + ints + part_bytes + 8 * A,
              "B1b": part_bytes + ints + 8 * A + n * P * 4 * 4 + out_bytes}
    return ops, nbytes, int(swept.sum()), pairs, live, chunk_pairs


# ---- the train kernels B2-B5 --------------------------------------------------

def train_kernel_inputs(params, statics, cfg, frame):
    """The inputs of kernels B2-B5 for one frame, as the train forward builds
    them: (bins, splat entries, mesh entries, mesh entry validity,
    sigma_px2)."""
    from gomavatar_tpu_torch.models.gom import posed_vertices, train_geometry
    from gomavatar_tpu_torch.ops.mesh_raster import mesh_entries, project_faces, soft_sigma_px2
    from gomavatar_tpu_torch.ops.splat.projection import project_gaussians
    from gomavatar_tpu_torch.ops.splat.render import gaussian_entries

    K, E = frame["K"], frame["E"]
    with torch.no_grad():
        verts_obs = posed_vertices(
            params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"], frame["dst_posevec"],
        )
        g = train_geometry(params, statics, cfg, verts_obs, K, E)
        bins = g["bins"]
        proj = project_gaussians(g["centroids"], g["cov"], K, E, cfg.img_size)
        s_entries = gaussian_entries(proj, g["colors"], g["opacity"], bins).contiguous()
        tris_xy, tris_z, in_front = project_faces(verts_obs, statics.faces, K, E)
        m_entries, m_valid = mesh_entries(tris_xy, tris_z, in_front, g["normals_cam"], statics.faces, bins)
    return bins, s_entries, m_entries.contiguous(), m_valid, soft_sigma_px2(1e-4, cfg.img_size)


def tile_batched_grad(entries, tile_count, outputs_fn, cotangents, tiles_per_batch):
    """d sum_i <outputs_i, cotangents_i> / d entries for a plain version,
    taken over batches of tiles and summed.  Tiles are independent given
    the entries, so each batch's autograd graph holds only its own tiles: at
    512^2 the graph of the whole frame would not fit in device memory."""
    leaf = entries.detach().requires_grad_(True)
    total = torch.zeros_like(entries)
    tiles = torch.nonzero(tile_count > 0).flatten()
    for b in range(0, tiles.numel(), tiles_per_batch):
        keep = torch.zeros_like(tile_count, dtype=torch.bool)
        keep[tiles[b : b + tiles_per_batch]] = True
        outs = outputs_fn(leaf, torch.where(keep, tile_count, torch.zeros_like(tile_count)))
        dot = sum((o * g).sum() for o, g in zip(outs, cotangents))
        total += torch.autograd.grad(dot, leaf)[0]
    return total


def check_grad(label, kernel, plain, keep, atol, rtol=0.0):
    """Gradients on the slots a kernel owns (``keep``): > 99.9 % within
    atol + rtol |plain|, every value finite.  Returns the worst difference."""
    require(bool(torch.isfinite(kernel).all() and torch.isfinite(plain).all()), f"{label}: non-finite gradients")
    k, p = kernel[keep], plain[keep]
    d = (k - p).abs()
    frac = float((d <= atol + rtol * p.abs()).float().mean())
    worst = float(d.max())
    print(f"  {label}: {frac * 100:.4f} % of {k.numel()} values within {atol:g} + {rtol:g}|plain|, "
          f"worst {worst:.3g} (largest |plain| {float(p.abs().max()):.3g})")
    require(frac > GRAD_FRAC, f"{label}: outside the criteria")
    return worst


def splat_work(entries, tile_start, tile_count, C, num_tiles_x, ncmax):
    """(chunks read, live pairs) of one B2 call on this data: a tile reads a
    chunk while any pixel's transmittance is unspent; a (pixel, entry) pair
    is live while the pixel's transmittance before the entry is >= 1e-4 (the
    pairs the kernel evaluates).  B3 reads and evaluates the same, twice."""
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK
    from gomavatar_tpu_torch.ops.splat.reference import T_EPS
    from gomavatar_tpu_torch.ops.splat.tiled_jnp import chunk_alpha, tile_pixels

    tiles = torch.nonzero(tile_count > 0).flatten()
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    px, py = tile_pixels(tiles, num_tiles_x)
    lane = torch.arange(CHUNK, device=entries.device)
    log_t = torch.zeros_like(px)
    chunks = live = 0
    log_eps = float(np.log(T_EPS))
    with torch.no_grad():
        for k in range(min(int(count.max()) // CHUNK, ncmax)):
            read = (k * CHUNK < count) & (log_t.amax(dim=1) >= log_eps)
            idx = torch.clamp_max(start + k * CHUNK, entries.shape[1] - CHUNK)[:, None] + lane
            alpha = chunk_alpha(entries[0:2, idx].permute(1, 2, 0), entries[2:5, idx].permute(1, 2, 0),
                                entries[5, idx] * read[:, None], px, py)  # (n, CHUNK, P)
            log1m = torch.log1p(-alpha)
            cum = torch.cumsum(log1m, dim=1) + log_t[:, None, :]
            live += int(((cum - log1m >= log_eps) & read[:, None, None]).sum())
            chunks += int(read.sum())
            log_t = cum[:, -1]
    return chunks, live


def mesh_work(entries, tile_start, tile_count, num_tiles_x, sigma_px2, ncmax, dl_ds):
    """(swept pairs, soft pairs, B5's soft pairs, speculative soft pairs) of
    one B4/B5 call on this data: every chunk of a segment is swept by the
    z-buffer; a chunk's soft term runs on its valid entries until every
    pixel of the tile has sum log(1 - p) <= -18; B5 runs the chain on the
    soft pairs whose pixel has dL/dS (``dl_ds`` (T, P)) not 0; B4a computes
    the soft term of the later, dead chunks too (the speculative pairs)."""
    from gomavatar_tpu_torch.ops.mesh_raster import _ONE_MINUS, _point_tri_sq_dist
    from gomavatar_tpu_torch.ops.mesh_raster_pallas import _LOG_SAT
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK
    from gomavatar_tpu_torch.ops.splat.tiled_jnp import P, tile_pixels

    tiles = torch.nonzero(tile_count > 0).flatten()
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    px, py = tile_pixels(tiles, num_tiles_x)
    px, py = px[:, :, None], py[:, :, None]
    lane = torch.arange(CHUNK, device=entries.device)
    log_om = torch.zeros(px.shape[:2], device=entries.device)
    dl_live = (dl_ds[tiles] != 0)[:, :, None]
    swept = soft = soft_dl = speculative = 0
    with torch.no_grad():
        for k in range(min(int(count.max()) // CHUNK, ncmax)):
            in_seg = k * CHUNK < count
            live = in_seg & (log_om.amax(dim=1) > _LOG_SAT)
            e = entries[:, torch.clamp_max(start + k * CHUNK, entries.shape[1] - CHUNK)[:, None] + lane][:, :, None, :]
            x0, y0, x1, y1, x2, y2 = e[0], e[1], e[2], e[3], e[4], e[5]
            denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
            denom = torch.where(denom.abs() < 1e-12, torch.ones_like(denom), denom)
            w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / denom
            w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / denom
            inside = (w0 >= 0) & (w1 >= 0) & (1.0 - w0 - w1 >= 0)
            d2 = _point_tri_sq_dist(px, py, x0, y0, x1, y1, x2, y2)
            prob = torch.sigmoid(-torch.where(inside, -d2, d2) / sigma_px2)
            valid = (e[12] > 0) & live[:, None, None]
            term = torch.log1p(-torch.clamp_max(prob, _ONE_MINUS))
            log_om = log_om + torch.where(valid, term, torch.zeros_like(term)).sum(dim=-1)
            swept += int(in_seg.sum()) * CHUNK * P
            soft += int(valid.sum()) * P
            soft_dl += int((valid & dl_live).sum())
            speculative += int(((e[12] > 0) & (in_seg & ~live)[:, None, None]).sum()) * P
    return swept, soft, soft_dl, speculative


def compare_b2b3(label, bins, entries, t_rgb, t_mask, timed: bool):
    """Kernels B2 and B3 against their plain version on the same entries; B2
    (B2a then B2b) also against the plain twin of its two launches, B2a's
    partials against the twin's, and B2's state replayed by B3a's rule.  The
    cotangents are those of the rgb L1 + 5 x mask L1 loss against (t_rgb,
    t_mask), summed over pixels rather than averaged so that the gradients
    are O(1) and the absolute tolerance bites.  Returns {"B2": (worst, ms,
    plain ms, {"B2a": ms, "B2b": ms}), "B3": ...} (times only when
    ``timed``)."""
    from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK

    C, TX, TY = 3, bins.num_tiles_x, bins.num_tiles_y
    start, count = bins.tile_start, bins.tile_count
    color_k, alpha_k, state_k = SK.splat_fwd(entries, start, count, C, TX)
    owned = owned_slots(start, count, entries.shape[1])
    same_bits(f"{label} B2", lambda: SK.splat_fwd(entries, start, count, C, TX),
              lambda out: (*SK._untile(out[0], out[1], TX, TY, C), out[2][owned]))
    part_k, _ = SK.splat_fwd_partials(entries, start, count, C, TX)
    twin = {}
    with torch.no_grad():
        color_p, alpha_p = SK.composite_plain_entries(entries, start, count, C, TX, TY)
        state_p = SK.splat_chunk_state_plain(entries, start, count, TX)
        color_w, alpha_w, state_w = SK.splat_split_plain(entries, start, count, C, TX, stats=twin)
        part_w = SK.splat_chunk_partials_plain(entries, start, count, C, TX)
    img_k, a_k = SK._untile(color_k, alpha_k, TX, TY, C)
    img_p, a_p = SK._untile(color_p, alpha_p, TX, TY, C)
    img_w, a_w = SK._untile(color_w, alpha_w, TX, TY, C)
    worst2 = max(check_close(f"{label} B2 color", img_k, img_p), check_close(f"{label} B2 alpha", a_k, a_p))
    check_close(f"{label} B2 color vs twin", img_k, img_w)
    check_close(f"{label} B2 alpha vs twin", a_k, a_w)
    check_chunk_state(label, state_k, state_p, owned)
    check_chunk_state(f"{label} vs twin", state_k, state_w, owned)
    check_b2_partials(label, part_k, part_w, owned)
    print(f"  {label} B2 twin: {twin['resweeps']} (pixel, chunk) re-sweeps, {twin['margin']} of them for the "
          f"margin alone, {twin['carries']} carried on, {twin['own']} after a carry")
    check_b2_replay(label, entries, start, count, TX, state_k, part_k, C)

    img = img_k.detach().requires_grad_(True)
    alpha = a_k.detach().requires_grad_(True)
    loss = (img - t_rgb).abs().sum() + 5.0 * (alpha - t_mask).abs().sum()
    g_img, g_alpha = torch.autograd.grad(loss, (img, alpha))
    g_color_t, g_alpha_t = SK._retile(g_img, g_alpha, TX, TY, C)
    d_k = SK.select_d_entries(SK.splat_bwd(entries, start, count, state_k, g_color_t, g_alpha_t, C, TX),
                              bins.entry_valid, start, count, 6 + C)
    same_bits(f"{label} B3", lambda: SK.splat_bwd(entries, start, count, state_k, g_color_t, g_alpha_t, C, TX),
              lambda d: SK.select_d_entries(d, bins.entry_valid, start, count, 6 + C))

    def plain_outputs(leaf, counts):
        return SK.composite_plain_entries(leaf, start, counts, C, TX, TY)

    d_p = tile_batched_grad(entries, count, plain_outputs, (g_color_t, g_alpha_t), 64)
    keep = SK.select_d_entries(torch.ones_like(d_p), bins.entry_valid, start, count, 6 + C) > 0
    worst3 = check_grad(f"{label} B3 d_entries", d_k, d_p, keep, GRAD_ATOL, GRAD_RTOL)
    out = {"B2": [worst2], "B3": [worst3]}
    if timed:
        g = (g_color_t, g_alpha_t)
        partial = SK.splat_bwd_partials(entries, start, count, state_k, *g, C, TX)
        b3a = cuda_ms(lambda: SK.splat_bwd_partials(entries, start, count, state_k, *g, C, TX), KERNEL_ITERS)
        b3b = cuda_ms(lambda: SK.splat_bwd_grads(entries, start, count, state_k, partial, *g, C, TX), KERNEL_ITERS)
        partials = SK.splat_fwd_partials(entries, start, count, C, TX)
        b2 = time_split(f"{label} B2", lambda: SK.splat_fwd(entries, start, count, C, TX),
                        {"B2a": lambda: SK.splat_fwd_partials(entries, start, count, C, TX),
                         "B2b": lambda: SK.splat_fwd_merge(entries, start, count, partials, C, TX)})
        out["B2"] += [b2["ms"], cuda_ms(lambda: SK.composite_plain_entries(entries, start, count, C, TX, TY),
                                        PLAIN_ITERS), b2["parts"]]
        out["B3"] += [b3a + b3b, cuda_ms(lambda: tile_batched_grad(entries, count, plain_outputs, g, 64), 2),
                      {"B3a": b3a, "B3b": b3b}]
        print(f"  {label}: B3a {b3a:.4f} ms + B3b {b3b:.4f} ms")
        for k in ("B2", "B3"):
            print(f"  {label}: {k} kernel {out[k][1]:.4f} ms, plain version {out[k][2]:.3f} ms")
    return out


def owned_slots(tile_start, tile_count, num_entries):
    """(num_entries / CHUNK,) bool: the chunk slots some tile sweeps."""
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK, written_slot_mask
    from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX

    return written_slot_mask(tile_start, tile_count, num_entries, NCMAX).reshape(-1, CHUNK)[:, 0] > 0


def check_chunk_state(label, state_k, state_p, owned):
    """B2's saved chunk-start transmittance against its plain version on the
    owned slots: the spent sentinel equal on >= 99.9 % of the values, the
    transmittance within 1e-4 on > 99.95 % of those both hold."""
    k, p = state_k[owned], state_p[owned]
    require(bool(torch.isfinite(k).all()), f"{label} B2 chunk state: non-finite values")
    spent_k, spent_p = k < 0, p < 0
    same = float((spent_k == spent_p).float().mean())
    both = ~spent_k & ~spent_p
    frac = float(((k - p).abs() <= STATE_TOL)[both].float().mean()) if bool(both.any()) else 1.0
    print(f"  {label} B2 chunk state: {k.numel()} values on {int(owned.sum())} slots, sentinel equal on "
          f"{same * 100:.4f} %, {frac * 100:.4f} % of {int(both.sum())} within {STATE_TOL:g}")
    require(same >= HIT_FRAC and frac > STATE_FRAC, f"{label} B2 chunk state: outside the criteria")


def check_b2_partials(label, kernel, plain, owned):
    """B2a's partials (slots, C + 2, P) against the twin's on the owned
    slots: the crossed flags equal on >= 99.9 % of (slot, pixel) values, the
    sums and the local transmittance within 1e-4 on > 99.95 % of the values
    where neither crossed."""
    from gomavatar_tpu_torch.ops.splat.pallas_kernel import CROSSED

    k, p = kernel[owned], plain[owned]
    require(bool(torch.isfinite(k).all()), f"{label} B2a partials: non-finite values")
    crossed_k, crossed_p = k[:, -1] == CROSSED, p[:, -1] == CROSSED
    same = float((crossed_k == crossed_p).float().mean())
    both = (~crossed_k & ~crossed_p)[:, None, :].expand_as(k)
    frac = float(((k - p).abs() <= CLOSE_TOL)[both].float().mean())
    print(f"  {label} B2a partials: {int(owned.sum())} slots, crossed equal on {same * 100:.4f} %, "
          f"{frac * 100:.4f} % within {CLOSE_TOL:g} where neither crossed ({float(crossed_k.float().mean()) * 100:.2f} "
          f"% of (slot, pixel) values crossed)")
    require(same >= HIT_FRAC and frac > CLOSE_FRAC, f"{label} B2a partials: outside the criteria")


def check_b2_replay(label, entries, start, count, TX, state, part, C):
    """B3a's per-entry rule replayed (plain, on the card) from B2's state on
    every owned chunk: no pixel may cross 1e-4 on a chunk B2 let through
    (its state >= 0, B2a's local T not crossed and state * T_k at least the
    margin threshold), and on >= 99.9 % of the (chunk, pixel) values with a
    next chunk in their tile the replay crosses exactly where that next
    chunk's state is -1."""
    from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK
    from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, tile_pixels

    slot, tile, k = SK.owned_chunks(start, count, NCMAX)
    px, py = tile_pixels(tile, TX)
    T0 = state[slot]
    with torch.no_grad():
        _, _, crossed, _ = SK.sweep_chunks_plain(entries, slot, px, py, T0, C)
    t_k = part[slot, C + 1]
    through = (T0 >= 0) & (t_k != SK.CROSSED) & (T0 * t_k >= SK.T_THROUGH)
    bad = int((crossed & through).sum())
    n = torch.clamp_max(torch.div(count.long(), CHUNK, rounding_mode="floor"), NCMAX)
    has_next = (k + 1 < n[tile])[:, None].expand_as(crossed)
    turns = (T0 >= 0) & (state[torch.clamp_max(slot + 1, state.shape[0] - 1)] < 0)
    agree = float((crossed == turns)[has_next].float().mean())
    print(f"  {label} B3a replay from B2's state: {int(through.sum())} (chunk, pixel) values let through, {bad} "
          f"cross 1e-4 in the replay; {int(crossed.sum())} crossings, at the state's turn to -1 on "
          f"{agree * 100:.4f} % of {int(has_next.sum())} values with a next chunk")
    require(bad == 0 and agree >= HIT_FRAC, f"{label} B3a replay from B2's state: outside the criteria")


def compare_b4b5(label, bins, entries, valid, sigma_px2, shadow, t_rgb, t_mask, albedo, timed: bool):
    """Kernels B4 and B5 against their plain version on the same entries;
    the cotangents are those of the train loss's rgb L1 through the shadow
    MLP (``shadow(normal)`` times ``albedo`` against t_rgb) and of the
    normal-mask L1 of the soft silhouette against the dilated t_mask, summed
    over pixels as in :func:`compare_b2b3`."""
    from gomavatar_tpu_torch.losses import dilate_mask
    from gomavatar_tpu_torch.ops import mesh_raster as MR
    from gomavatar_tpu_torch.ops import mesh_raster_pallas as MK
    from gomavatar_tpu_torch.ops.mesh_raster import mesh_composite_plain

    TX, TY = bins.num_tiles_x, bins.num_tiles_y
    start, count = bins.tile_start, bins.tile_count
    hard_k, soft_k, win_k, S_k, live_k = MK.mesh_fwd(entries, start, count, TX, True, sigma_px2)
    busy = count > 0
    same_bits(f"{label} B4", lambda: MK.mesh_fwd(entries, start, count, TX, True, sigma_px2),
              lambda out: (*MK._untile_outputs(out[0], out[1], TX, TY), *(r[busy] for r in out[2:])))
    res = (win_k, S_k, live_k)
    with torch.no_grad():
        hard_p, soft_p = mesh_composite_plain(entries, start, count, TX, TY, True, sigma_px2)
        twin = MR.mesh_split_plain(entries, start, count, TX, True, sigma_px2)
    check_mesh_residuals(label, res, MR.mesh_residuals_plain(entries, start, count, TX, True, sigma_px2))
    check_mesh_residuals(f"{label} vs twin", res, twin[2:])
    n_k, hit_k, s_k = MK._untile_outputs(hard_k, soft_k, TX, TY)
    worst4 = check_b4_outputs(label, (n_k, hit_k, s_k), MK._untile_outputs(hard_p, soft_p, TX, TY))
    check_b4_outputs(f"{label} vs twin", (n_k, hit_k, s_k), MK._untile_outputs(*twin[:2], TX, TY))
    check_b4_partials(label, MK.mesh_fwd_partials(entries, start, count, TX, True, sigma_px2),
                      MR.mesh_chunk_partials_plain(entries, start, count, TX, True, sigma_px2),
                      owned_slots(start, count, entries.shape[1]))

    normal = n_k.detach().requires_grad_(True)
    soft = s_k.detach().requires_grad_(True)
    H, W = soft.shape
    shading = shadow(normal.reshape(-1, 3)).reshape(H, W, 1) * 2.0
    loss = (albedo * shading - t_rgb).abs().sum() + (soft - dilate_mask(t_mask, 7)).abs().sum()
    g_normal, g_soft = torch.autograd.grad(loss, (normal, soft))
    g_hard_t, g_soft_t = MK._retile_cotangents(g_normal, g_soft, TX, TY)
    d_k = MK.select_d_entries(MK.mesh_bwd(entries, start, count, g_hard_t, g_soft_t, *res, TX, True, sigma_px2),
                              valid, start, count, MK.NCH)
    same_bits(f"{label} B5", lambda: MK.mesh_bwd(entries, start, count, g_hard_t, g_soft_t, *res, TX, True, sigma_px2),
              lambda d: MK.select_d_entries(d, valid, start, count, MK.NCH))

    def plain_outputs(leaf, counts):
        return mesh_composite_plain(leaf, start, counts, TX, TY, True, sigma_px2)

    d_p = tile_batched_grad(entries, count, plain_outputs, (g_hard_t, g_soft_t), 32)
    keep = MK.select_d_entries(torch.ones_like(d_p), valid, start, count, MK.NCH) > 0
    rows = torch.zeros((MK.NCH, 1), dtype=torch.bool, device=keep.device)
    rows[0:6] = rows[9:12] = True  # the coordinates and the summed normal
    worst5 = check_grad(f"{label} B5 d_entries", d_k, d_p, keep & rows, MESH_GRAD_TOL)
    out = {"B4": [worst4], "B5": [worst5]}
    if timed:
        partials = MK.mesh_fwd_partials(entries, start, count, TX, True, sigma_px2)
        b4 = time_split(f"{label} B4", lambda: MK.mesh_fwd(entries, start, count, TX, True, sigma_px2),
                        {"B4a": lambda: MK.mesh_fwd_partials(entries, start, count, TX, True, sigma_px2),
                         "B4b": lambda: MK.mesh_fwd_merge(entries, start, count, partials, True)})
        out["B4"] += [b4["ms"], cuda_ms(lambda: mesh_composite_plain(entries, start, count, TX, TY, True, sigma_px2),
                                        PLAIN_ITERS), b4["parts"]]
        out["B5"] += [cuda_ms(lambda: MK.mesh_bwd(entries, start, count, g_hard_t, g_soft_t, *res, TX, True,
                                                  sigma_px2), KERNEL_ITERS),
                      cuda_ms(lambda: tile_batched_grad(entries, count, plain_outputs, (g_hard_t, g_soft_t), 32), 2)]
        for k in ("B4", "B5"):
            print(f"  {label}: {k} kernel {out[k][1]:.4f} ms, plain version {out[k][2]:.3f} ms")
        out["dl_ds"] = -g_soft_t[:, 0] * torch.exp(S_k)  # B5's dL/dS, for its work count
    return out


def check_b4_outputs(label, kernel, plain):
    """B4's untiled outputs (normal, hit, soft) against a plain version's:
    the hit equal on >= 99.9 % of pixels, the normal within 1e-5 where the
    hits agree, the soft silhouette within 1e-4 on > 99.9 %.  Returns the
    worst difference."""
    (n_k, hit_k, s_k), (n_p, hit_p, s_p) = kernel, plain
    same = hit_k == hit_p
    both = same & (hit_k > 0)
    hit_frac = float(same.float().mean())
    n_worst = float((n_k - n_p).abs().amax(dim=-1)[both].max())
    print(f"  {label} B4: hit equal on {hit_frac * 100:.4f} %, normal worst {n_worst:.3g} over "
          f"{int(both.sum())} hit pixels")
    require(hit_frac >= HIT_FRAC and n_worst <= NORMAL_TOL, f"{label} B4 hard pass: outside the criteria")
    sd = (s_k - s_p).abs()
    s_frac = float((sd <= SOFT_TOL).float().mean())
    print(f"  {label} B4 soft: {s_frac * 100:.4f} % within {SOFT_TOL:g}, worst {float(sd.max()):.3g}")
    require(bool(torch.isfinite(s_k).all()) and s_frac > GRAD_FRAC, f"{label} B4 soft: outside the criteria")
    return max(n_worst, float(sd.max()))


def check_b4_partials(label, kernel, plain, owned):
    """B4a's partials against the twin's on the owned slots: the chunk
    winner's entry equal on >= 99.9 % of (slot, pixel) values, the soft
    partial within 1e-4 relative on > 99.9 %; the share whose z is
    bit-equal is printed."""
    (z_k, i_k, s_k), (z_p, i_p, s_p) = ((t[owned] for t in x) for x in (kernel, plain))
    win_frac = float((i_k == i_p).float().mean())
    z_same = float((z_k == z_p).float().mean())
    d = (s_k - s_p).abs()
    s_frac = float((d <= S_RTOL * s_p.abs() + S_ATOL).float().mean())
    print(f"  {label} B4a partials: {int(owned.sum())} slots, winner equal on {win_frac * 100:.4f} %, z bit-equal on "
          f"{z_same * 100:.4f} %, soft partial {s_frac * 100:.4f} % within {S_RTOL:g} relative "
          f"(worst {float(d.max()):.3g})")
    require(bool(torch.isfinite(s_k).all()), f"{label} B4a partials: non-finite soft partial")
    require(win_frac >= HIT_FRAC and s_frac > GRAD_FRAC, f"{label} B4a partials: outside the criteria")


def check_mesh_residuals(label, kernel, plain):
    """B4's residuals against their plain version: the winner equal on
    >= 99.9 % of pixels, S within 1e-4 relative on > 99.9 %, the live chunk
    count equal on every tile."""
    (win_k, S_k, live_k), (win_p, S_p, live_p) = kernel, plain
    win_frac = float((win_k == win_p).float().mean())
    d = (S_k - S_p).abs()
    s_frac = float((d <= S_RTOL * S_p.abs() + S_ATOL).float().mean())
    live_same = bool(torch.equal(live_k, live_p))
    print(f"  {label} B4 residuals: win equal on {win_frac * 100:.4f} %, S {s_frac * 100:.4f} % within "
          f"{S_RTOL:g} relative (worst {float(d.max()):.3g}), live chunks equal on every tile: {live_same} "
          f"({int(live_k.sum())} live soft chunks)")
    require(bool(torch.isfinite(S_k).all()), f"{label} B4 residuals: non-finite S")
    require(win_frac >= HIT_FRAC and s_frac > GRAD_FRAC and live_same, f"{label} B4 residuals: outside the criteria")


def bound(ops: float, sfu: float, nbytes: float):
    """(bound_ms, bound_by, ms of the fp32 operations, of the special-function
    operations, of the bytes) at the H100's peaks."""
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_sfu = sfu / PEAK_EXP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by = "bytes" if t_bytes >= max(t_ops, t_sfu) else "operations"
    return max(t_ops, t_sfu, t_bytes), by, t_ops, t_sfu, t_bytes


def train_kernel_bounds(bins, s_entries, m_entries, sigma_px2, dl_ds, C=3):
    """The least time of B2-B5 on this frame's data, each the larger of its
    fp32 and special-function operations at peak and the bytes it must move
    (each input read once, each output written once) at the memory rate;
    B2, B3 and B4 as one function each and as their launches B2a, B2b, B3a,
    B3b, B4a and B4b; B3 and B5 also by the count of the earlier kernels
    that replayed the forward, B4 by the per-pair count of a sweep that
    derives every set-up on every pair.  Returns {kernel: (bound_ms,
    bound_by, description)}."""
    from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK
    from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P

    start, count, TX = bins.tile_start, bins.tile_count, bins.num_tiles_x
    T = count.shape[0]
    s_chunks, live = splat_work(s_entries, start, count, C, TX, NCMAX)
    b2a_stats = {}
    SK.splat_chunk_partials_plain(s_entries, start, count, C, TX, stats=b2a_stats)
    swept, soft, soft_dl, speculative = mesh_work(m_entries, start, count, TX, sigma_px2, NCMAX, dl_ds)
    m_chunks = swept // (CHUNK * P)
    owned = int(torch.clamp_max(torch.div(count, CHUNK, rounding_mode="floor"), NCMAX).sum())
    row = CHUNK * 4  # bytes of one row of a chunk
    ints = 8 * T  # tile_start, tile_count
    s_in = s_chunks * (6 + C) * row + T * (C + 1) * P * 4 + ints  # entries read, cotangents or outputs
    state = owned * P * 4  # B2's chunk-start state, or B3a's partials
    m_in = m_chunks * 13 * row + T * 5 * P * 4 + ints
    residuals = T * P * 8 + T * 4  # B4's win, S, live
    b4_ops = B4_HARD * swept + B4_ENTRY_HARD * (swept // P) + B4_SOFT * soft + B4_ENTRY_SOFT * (soft // P)
    b4_partials = owned * P * 12  # B4a's z, entry index and soft partial per (slot, pixel)
    b2_partials = owned * (C + 2) * P * 4  # B2a's colour and alpha sums and local T per (slot, pixel)
    s_out = T * (C + 1) * P * 4  # B2's colour and alpha outputs
    work = {
        "B2": (B2_OPS * live, B2_SFU * live, s_in + state),
        # B2a reads every owned chunk and writes its partials and the zeroed
        # tickets; B2b reads the partials and the tickets, writes the state
        # and the outputs (its re-sweeps not counted)
        "B2a": (B2_OPS * live, B2_SFU * live, owned * (6 + C) * row + ints + b2_partials + 4 * T),
        "B2b": (0, 0, b2_partials + ints + 4 * T + state + s_out),
        "B3": ((B3A_OPS + B3B_OPS) * live, (B3A_SFU + B3B_SFU) * live, s_in + state + owned * s_entries.shape[0] * row),
        "B3a": (B3A_OPS * live, B3A_SFU * live, s_in + 2 * state),
        "B3b": (B3B_OPS * live, B3B_SFU * live, s_in + 2 * state + owned * s_entries.shape[0] * row),
        "B4": (b4_ops, B4_SFU * soft, m_in + residuals),
        "B4a": (b4_ops, B4_SFU * soft, m_chunks * 10 * row + ints + b4_partials),
        "B4b": (0, 0, b4_partials + T * 5 * P * 4 + ints + residuals),
        "B4 per pair": (PAIR_B4_HARD * swept + PAIR_B4_SOFT * soft, B4_SFU * soft, m_in + residuals),
        "B5": (B5_HARD * swept + B5_ENTRY * (soft // P) + B5_SOFT * soft_dl, B5_SFU * soft_dl,
               m_in + residuals + owned * m_entries.shape[0] * row),
        "B3 replayed": (REPLAY_B3_OPS * live, REPLAY_B3_SFU * live, s_in + owned * s_entries.shape[0] * row),
        "B5 replayed": (REPLAY_B5_HARD * swept + REPLAY_B5_SOFT * soft, REPLAY_B5_SFU * soft,
                               m_in + owned * m_entries.shape[0] * row),
    }
    out = {}
    for name, (ops, sfu, nbytes) in work.items():
        b, by, t_ops, t_sfu, t_bytes = bound(ops, sfu, nbytes)
        out[name] = (b, by, f"{ops:.4g} fp32 ops ({t_ops:.4f} ms), {sfu:.4g} exp/log ({t_sfu:.4f} ms), "
                            f"{nbytes} bytes ({t_bytes:.4f} ms)")
    b2a_swept = b2a_stats["swept_pairs"]
    print(f"  train kernel work: {s_chunks} splat chunks read ({owned} owned), {live} live splat pairs; {m_chunks} "
          f"mesh chunks swept ({swept} pairs), {soft} soft pairs, {soft_dl} of them with dL/dS != 0; not counted: "
          f"{speculative} speculative soft pairs of B4a (dead chunks), {b2a_swept - live} speculative splat pairs "
          f"of B2a ({b2a_swept} swept from T = 1 minus the live ones)")
    return out


def train_batch(params, statics, cfg, frame, target_frame):
    """A train batch at ``frame`` whose targets are the port's own eval
    render at ``target_frame``, composited on black (bgcolor zeros)."""
    from gomavatar_tpu_torch.losses import unpack

    dev = frame["K"].device
    with torch.no_grad():
        rgb, mask, _ = forward(params, statics, cfg, target_frame, device=dev.type)
    bg = torch.zeros(3, device=dev)
    return dict(frame, bgcolor=bg, target_rgbs=unpack(rgb, mask, bg, clamp=True), target_masks=mask)


# the LPIPS trunk of each device, drawn once (the random VGG16 takes seconds)
_LPIPS: dict = {}


def make_trainer(params, statics, cfg, i_iter, device, group=None, lpips_params=None):
    """A Trainer of the trained avatar's train config, started from
    (params, statics, cfg) at ``i_iter`` with no subdivision left to do; a
    rank of a data-parallel run under ``group``; its LPIPS trunk
    ``lpips_params`` (a converted one, 10d) or the package's default."""
    from gomavatar_tpu_torch.models.lpips import load_lpips
    from gomavatar_tpu_torch.scene import trained_train_cfg
    from gomavatar_tpu_torch.trainer import Trainer

    train_cfg = trained_train_cfg()
    phase = len(train_cfg["model"]["subdivide_iters"])
    if lpips_params is None:
        if str(device) not in _LPIPS:
            _LPIPS[str(device)] = load_lpips(device=device)[0]
        lpips_params = _LPIPS[str(device)]
    return Trainer(train_cfg, lpips_params=lpips_params, device=device,
                   state=(params, statics, cfg, i_iter, phase), group=group)


def step_gradients(trainer):
    """The gradient of every leaf in the trainer's first step: Adam's first
    moments start at 0, so after one step they are (1 - 0.9) x gradient."""
    require(trainer.opt_state.count == 1, "the gradients are read after the first step")
    return [m / (1.0 - 0.9) for m in trainer.opt_state.mu]


def gate_train_scene(device):
    """The gate scene with its per-face so3, scale and colors drawn from a
    numpy seed (a fresh model's are constant, and the so3 gradient at 0 is
    rounding noise)."""
    from gomavatar_tpu_torch.scene import gate_scene

    params, statics, cfg, frame = gate_scene(device=device, seed=0)
    randomize_faces(params, cfg.num_faces, device)
    return params, statics, cfg, frame


def randomize_faces(params, F: int, device):
    """Per-face so3, scale and colors drawn from numpy seed 0, in place."""
    rng = np.random.default_rng(0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    params["so3"] = dev(0.2 * rng.standard_normal((F, 3)))
    params["scale"] = dev(1.0 + 0.2 * rng.standard_normal((F, 3)))
    params["appearance"] = {"colors": dev(rng.uniform(0.05, 0.95, (F, 3)))}


def compare_gate_step(i_iter):
    """One gate-scene train step on the card and on the CPU from the same
    params and batch: the loss terms and every leaf's gradient."""
    out = {}
    g_params, g_statics, g_cfg, g_frame = gate_train_scene("cuda")
    batch = train_batch(g_params, g_statics, g_cfg, g_frame, perturbed_frames(g_frame)[1])
    for device in ("cuda", "cpu"):
        params, statics, cfg, _ = gate_train_scene(device)
        tr = make_trainer(params, statics, cfg, i_iter, device)
        total, losses = tr.step({k: v.to(device) for k, v in batch.items()})
        out[device] = ({"total": float(total), **{k: float(v) for k, v in losses.items()}}, step_gradients(tr))
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    require(set(lc) == set(lh), "the card and the CPU give different loss terms")
    for k in sorted(lc):
        rtol = STEP_LPIPS_RTOL if k in ("lpips", "total") else STEP_RTOL
        ok = abs(lc[k] - lh[k]) <= rtol * abs(lh[k]) + 1e-7
        print(f"  gate step {k}: card {lc[k]:.7g}, CPU {lh[k]:.7g}")
        require(ok, f"gate step {k}: the card and the CPU differ by more than rtol {rtol:g}")
    rels = []
    for i, (a, b) in enumerate(zip(gc, gh)):
        a = a.cpu()
        require(bool(torch.isfinite(a).all()), f"gate step: non-finite gradient in leaf {i}")
        rels.append(float(torch.linalg.norm(a - b) / torch.clamp_min(torch.linalg.norm(b), 1e-30)))
    print(f"  gate step gradients, relative L2 difference per leaf: " + " ".join(f"{r:.2g}" for r in rels))
    worst = max(range(len(rels)), key=rels.__getitem__)
    require(rels[worst] <= STEP_GRAD_REL, f"gate step: leaf {worst} gradient off by {rels[worst]:.3g} of its norm")


def phase_kernels_b1(card):
    from gomavatar_tpu_torch.convert import load_trained
    from gomavatar_tpu_torch.ops.frame_render import NCMAX as NCMAX_B1
    from gomavatar_tpu_torch.scene import gate_scene

    print(f"[2] kernel B1 vs its plain version on the card ({card})")
    g_params, g_statics, g_cfg, g_frame = gate_scene(device="cuda", seed=0)
    table, bins, _ = frame_inputs(g_params, g_statics, g_cfg, g_frame)
    compare_b1("gate 64^2", table, bins, g_cfg.img_size)

    t0 = time.perf_counter()
    trained = load_trained(device="cuda")
    params, statics, cfg, frame = trained
    print(f"  trained avatar loaded: {cfg.num_faces} faces at {cfg.img_size}, "
          f"{time.perf_counter() - t0:.1f} s")
    t_table, t_bins, _ = frame_inputs(params, statics, cfg, frame)
    max_abs_err, timed = compare_b1("trained 512^2", t_table, t_bins, cfg.img_size)

    print("  gate-scene forward, card vs CPU")
    rgb_c, mask_c, _ = forward(g_params, g_statics, g_cfg, g_frame)
    rgb_h, mask_h, _ = forward(*gate_scene(device="cpu", seed=0), device="cpu")
    check_close("gate forward rgb", rgb_c.cpu(), rgb_h)
    check_close("gate forward mask", mask_c.cpu(), mask_h)
    ops, nbytes, n_entries, pairs, live, chunk_pairs = b1_work(t_table, t_bins, NCMAX_B1)
    print(f"  B1 work: {int(t_bins.n_active)} active tiles, {chunk_pairs} (tile, chunk) pairs, {n_entries} swept "
          f"entries, {pairs} pairs, {live} live splat pairs; {ops:.4g} fp32 ops, {live} exps; not counted: the "
          f"twin's re-sweeps above")
    b1 = {"max_abs_err": max_abs_err, "ms": timed["ms"], "plain_ms": timed["plain_ms"], "parts": {}}
    # B1a does all of the pair work; B1b's merge is bound by its bytes
    for name, (n_ops, n_exp) in (("B1", (ops, live)), ("B1a", (ops, live)), ("B1b", (0, 0))):
        b, by, t_ops, t_exp, t_bytes = bound(n_ops, n_exp, nbytes[name])
        print(f"  {name} bound {b:.4f} ms by {by}: {n_ops:.4g} fp32 ops ({t_ops:.4f} ms at 67 TFLOP/s), "
              f"{n_exp} exps ({t_exp:.4f} ms at {PEAK_EXP_PER_S:.3g}/s), {nbytes[name]} bytes ({t_bytes:.4f} ms "
              f"at 3.35 TB/s)")
        entry = b1 if name == "B1" else b1["parts"].setdefault(name, {"ms": timed["parts"][name]})
        entry.update(bound_ms=b, bound_by=by)
    return trained, b1


def clone_tree(x):
    """A copy of a program's outputs (tensors in tuples, lists, dicts and
    NamedTuples), which its next call overwrites."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(clone_tree(v) for v in x)
    return x


def program_args(params, statics, cfg, frame):
    """``eval_program``'s arguments for one frame (as ``forward``'s)."""
    return (params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
            frame["dst_posevec"], 1e7, None, None)


def max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))


def eager_and_captured(label: str, ways: dict, iters: int, unit: str, card: str) -> dict:
    """``profile_eval.measure`` of the eager and the captured function in
    one call: median and p90 of ``iters`` synchronised calls after 3
    warm-up, device ms, kernels per call and busy share by torch.profiler
    over PROFILE_WINDOW calls."""
    from gomavatar_tpu_torch.profile_eval import measure

    out = {}
    for k, fn in ways.items():
        m = measure(fn, iters, window=PROFILE_WINDOW)
        out[k] = {x: m[x] for x in ("median_ms", "p90_ms", "device_ms", "kernels_per_call", "busy_share")}
        print(f"  {label}, {k}: median {m['median_ms']:.3f} ms/{unit}, p90 {m['p90_ms']:.3f} over {iters} {unit}s "
              f"after 3 warm-up; device {m['device_ms']:.3f} ms/{unit} over {m['kernels_per_call']:.0f} kernels, busy "
              f"{100 * m['busy_share']:.1f} % (torch.profiler, {PROFILE_WINDOW} {unit}s) on {card}")
    out["speedup"] = out["eager"]["median_ms"] / out["captured"]["median_ms"]
    print(f"  {label}: the captured median {out['speedup']:.2f}x faster than the eager one")
    return out


def phase_eval_path(trained, card):
    """Phase 3: the eval frame as the eval program, the main path (one
    captured CUDA graph replayed per frame), its launches counted, against
    the eager forward (bit-equal where two eager runs are); then both
    timed."""
    from gomavatar_tpu_torch.models.gom import eval_forward, eval_program

    params, statics, cfg, frame = trained
    print("[3] eval path: the eval program (gom_forward(train=False), captured) on the trained avatar at 512^2")
    frames = perturbed_frames(frame)
    eager = [clone_tree(eval_forward(*program_args(params, statics, cfg, f))) for f in frames]
    again = [clone_tree(eval_forward(*program_args(params, statics, cfg, f))) for f in frames]
    spread = max(max_diff(a[:2], b[:2]) for a, b in zip(eager, again))
    print(f"  eager against eager on the {len(frames)} frames: rgb and mask {'bit-equal' if spread == 0 else 'apart'}"
          f" (worst {spread:.3g})")
    render = eval_program()
    outs, counts, _ = counted(lambda: [clone_tree(render(*program_args(params, statics, cfg, f))) for f in frames])
    launches = {k: counts[k] for k in ("B1a", "B1b")}
    W, H = cfg.img_size
    for i, (rgb, mask, aux) in enumerate(outs):
        tel = aux["binning"]
        dropped, overflow = int(tel.total_dropped()), int(aux["tile_overflow"])
        print(f"  frame {i}: rgb {tuple(rgb.shape)} mean {float(rgb.mean()):.4f}, "
              f"mask mean {float(mask.mean()):.4f}, max tile entries {int(tel.max_tile_entries)}, "
              f"dropped {dropped}, tile_overflow {overflow}")
        require(rgb.shape == (H, W, 3) and mask.shape == (H, W), f"frame {i}: wrong output shape")
        require(bool(torch.isfinite(rgb).all() and torch.isfinite(mask).all()), f"frame {i}: non-finite output")
        require(float(mask.mean()) > 0.01, f"frame {i}: empty render")
        require(dropped == 0 and overflow == 0, f"frame {i}: binning dropped entries")
        apart = max_diff(outs[i][:2], eager[i][:2])
        tel_e = eager[i][2]["binning"]
        same_tel = all(torch.equal(getattr(tel, f), getattr(tel_e, f)) for f in tel._fields)
        print(f"    captured against eager: rgb and mask worst {apart:.3g}, telemetry "
              f"{'equal' if same_tel else 'different'}")
        require(apart <= spread and same_tel,
                f"frame {i}: the captured forward is further from the eager one than two eager runs are")
    print(f"  B1 launches: {launches} for {len(frames)} frames (the program's replays), {render.captures} capture")
    for k in launches:
        require(launches[k] == len(frames), f"the eval path did not launch {k} once per frame")
    require(render.captures == 1, "the eval program captured more than once for one frame shape")
    launches["B1"] = launches["B1a"] + launches["B1b"]

    timed = eager_and_captured("forward", {
        "eager": lambda: eval_forward(*program_args(params, statics, cfg, frame)),
        "captured": lambda: render(*program_args(params, statics, cfg, frame)),
    }, FORWARD_ITERS, "frame", card)
    print(f"  the eval program's memory pool: {render.pool_bytes() / 2**20:.1f} MiB")
    return launches, dict(timed, median_ms=timed["captured"]["median_ms"], p90_ms=timed["captured"]["p90_ms"],
                          fps=1e3 / timed["captured"]["median_ms"], frames=FORWARD_ITERS,
                          bit_equal_eager=spread == 0, pool_mib=render.pool_bytes() / 2**20)


def phase_train_kernels(trained):
    """Phase 4a: B2-B5 against their plain versions at 64^2 and 512^2;
    returns {kernel: {max_abs_err, ms, plain_ms, bound_ms, bound_by}}."""
    from gomavatar_tpu_torch.models import modules as M
    from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK
    from gomavatar_tpu_torch.scene import gate_scene

    print("[4a] kernels B2-B5 vs their plain versions on the card")
    results = {}
    g_params, g_statics, g_cfg, g_frame = gate_scene(device="cuda", seed=0)
    for label, (params, statics, cfg, frame), timed in (
        ("gate 64^2", (g_params, g_statics, g_cfg, g_frame), False),
        ("trained 512^2", trained, True),
    ):
        bins, s_e, m_e, m_v, s2 = train_kernel_inputs(params, statics, cfg, frame)
        tel = bins.telemetry
        print(f"  {label}: {int((bins.tile_count > 0).sum())} non-empty tiles, entries {tuple(s_e.shape)}, "
              f"max tile entries {int(tel.max_tile_entries)}, dropped {int(tel.total_dropped())}")
        with torch.no_grad():
            t_rgb, t_mask, _ = forward(params, statics, cfg, perturbed_frames(frame)[1])
        out = compare_b2b3(label, bins, s_e, t_rgb, t_mask, timed)
        color_k, alpha_k, _ = SK.splat_fwd(s_e, bins.tile_start, bins.tile_count, 3, bins.num_tiles_x)
        albedo = SK._untile(color_k, alpha_k, bins.num_tiles_x, bins.num_tiles_y, 3)[0]
        sh = cfg.module_cfg("shadow")
        out.update(compare_b4b5(label, bins, m_e, m_v, s2, lambda n: M.shadow_apply(params["shadow"], sh, n),
                                t_rgb, t_mask, albedo, timed))
        dl_ds = out.pop("dl_ds", None)
        for k, v in out.items():
            r = results.setdefault(k, {"max_abs_err": 0.0})
            r["max_abs_err"] = max(r["max_abs_err"], v[0])
            if timed:
                r["ms"], r["plain_ms"] = v[1], v[2]
                if len(v) > 3:
                    r["parts"] = {name: {"ms": ms} for name, ms in v[3].items()}
        if timed:
            bounds = train_kernel_bounds(bins, s_e, m_e, s2, dl_ds)
            for k in ("B2", "B3", "B4", "B5"):
                b, by, desc = bounds[k]
                results[k].update(bound_ms=b, bound_by=by)
                print(f"  {k}: {results[k]['ms']:.4f} ms, plain version {results[k]['plain_ms']:.3f} ms, "
                      f"bound {b:.4f} ms by {by}: {desc}")
            for kernel, k in (("B2", "B2a"), ("B2", "B2b"), ("B3", "B3a"), ("B3", "B3b"), ("B4", "B4a"),
                              ("B4", "B4b")):
                b, by, desc = bounds[k]
                results[kernel]["parts"][k].update(bound_ms=b, bound_by=by)
                print(f"  {k}: {results[kernel]['parts'][k]['ms']:.4f} ms, bound {b:.4f} ms by {by}: {desc}")
            for k, other in (("B3", "B3 replayed"), ("B5", "B5 replayed"), ("B4", "B4 per pair")):
                b, by, desc = bounds[other]
                print(f"  {k}: bound {bounds[k][0]:.4f} ms by the current count, {b:.4f} ms by the count of "
                      f"'{other}' ({by}: {desc})")
    return results


def state_diffs(a, b) -> list:
    """The values that differ in each leaf of two ``train_state`` copies
    (params, then Adam's moments)."""
    return [int((x != y).sum()) for x, y in zip(a[0] + a[1], b[0] + b[1])]


@contextlib.contextmanager
def deterministic(warn_only: bool = False):
    """torch's deterministic algorithms, which no bit check needs: the train
    and pose steps add their index transposes by gathers in a fixed order
    (``mesh_ops.gather_vjp``), so they give the same bits on every run under
    the default algorithms (4c's probe).  4c lists the ops that torch still
    names under them (``warn_only``), and 4d times the step under them.
    cuBLAS needs the fixed workspace config that ``main`` sets for the whole
    run."""
    torch.use_deterministic_algorithms(True, warn_only=warn_only)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def nondeterministic_ops(trainer, eager, batch) -> dict:
    """{op: warnings} of the ops that torch names as having no deterministic
    implementation in one eager train step from the trainer's state (its
    result dropped), run under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``."""
    import warnings

    i_dev = torch.full((), float(trainer.i_iter), device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with deterministic(warn_only=True):
            eager(trainer.params, trainer.opt_state, trainer.statics, trainer.lpips_params, batch, i_dev)
            torch.cuda.synchronize()
    ops: dict = {}
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            op = text.split(" does not have")[0]
            ops[op] = ops.get(op, 0) + 1
    print(f"  one eager step under torch.use_deterministic_algorithms(True, warn_only=True): "
          f"{ops or 'no op'} named as having no deterministic implementation")
    return ops


# the profiler's events of the train step's index transposes (mesh_ops):
# the gathers' backward and the neighbour sums of the Laplacian, each way;
# and the backward nodes of the plain forms (index_select's and indexing's,
# whose transposes scatter), which the step should no longer reach
_NODE = "autograd::engine::evaluate_function: "
TRANSPOSE_EVENTS = (_NODE + "GatherVJPBackward", _NODE + "_NeighborSumBackward", "_NeighborSum")
PLAIN_EVENTS = (_NODE + "IndexSelectBackward", _NODE + "IndexAddBackward", _NODE + "IndexBackward",
                _NODE + "IndexPutBackward")
# the aten ops that add into an output by index: atomics on the card
SCATTER_OPS = ("index_add", "index_put", "scatter_add", "scatter_reduce", "index_reduce", "put_",
               "embedding_dense_backward", "_unsafe_index_put")


def scatter_ops(label: str, step) -> dict:
    """{op: sorted dtypes} of every op of SCATTER_OPS that ``step()`` (one
    eager step) reaches, its backward included (a TorchDispatchMode sees
    each aten op and its tensors, on the autograd engine's device thread
    too: the ``*_backward`` ops it sees are counted and required); fails
    on one that adds float data."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen: dict = {}
    backward = [0]

    class Scatters(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            backward[0] += "_backward" in name
            if any(op in name for op in SCATTER_OPS):
                dtypes = {str(a.dtype) for a in args if isinstance(a, torch.Tensor)}
                seen.setdefault(name, set()).update(dtypes)
            return func(*args, **(kwargs or {}))

    with Scatters():
        step()
    torch.cuda.synchronize()
    out = {k: sorted(v) for k, v in seen.items()}
    floats = {k: v for k, v in out.items() if any("float" in d for d in v)}
    print(f"  scatter ops one eager {label} step reaches (op: dtypes): {out or 'none'}; {backward[0]} backward ops "
          f"seen")
    require(backward[0] > 0, f"the {label} step's backward was not seen")
    require(not floats, f"the {label} step adds float data by index (atomics on the card): {floats}")
    return out


# the kernels cuDNN launches to move a conv's tensors between NCHW and NHWC:
# the LPIPS trunk runs channels-last on the card, so a step launches none
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")


def layout_kernels(fn) -> tuple[dict, int]:
    """({kernel: device ms a call} of the kernels named in LAYOUT_KERNELS,
    events with device time) over PROFILE_WINDOW calls of ``fn()`` by
    torch.profiler, after one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WINDOW):
            fn()
        torch.cuda.synchronize()
    found, kernels = {}, 0
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        us = evt.cuda_time_total if us is None else us
        kernels += us > 0
        if any(k in evt.key for k in LAYOUT_KERNELS):
            found[evt.key] = us / 1e3 / PROFILE_WINDOW
    return found, kernels


def no_layout_transposes(label: str, fn) -> dict:
    """:func:`layout_kernels` of ``fn()`` (a captured step); fails on any
    such kernel, or where the profiler saw no device kernel."""
    found, kernels = layout_kernels(fn)
    print(f"  {label}: cuDNN layout transposes in {PROFILE_WINDOW} profiled calls: {found or 'none'} (of {kernels} "
          f"events with device time)")
    require(kernels > 0, f"{label}: the profiler saw no device kernel")
    require(not found, f"{label}: the LPIPS trunk's convs transpose between NCHW and NHWC: {found}")
    return found


def trunk_calls(since: float) -> int:
    """The ``lpips.trunk_nhwc`` counts recorded since ``since``."""
    from gomavatar_tpu_torch.utils import profiling

    return sum(1 for r in profiling.records(since) if isinstance(r, profiling.Count) and r.name == "lpips.trunk_nhwc")


def transpose_costs(trainer, eager, batch) -> dict:
    """The device ms per step of the step's index transposes (torch.profiler
    over PROFILE_WINDOW eager steps from the trainer's state: the device
    time under each event of TRANSPOSE_EVENTS, and of the per-frame
    entry table's build, profiled alone), and the bytes of every table."""
    from torch.profiler import ProfilerActivity, profile

    from gomavatar_tpu_torch.models.gom import posed_vertices, train_geometry
    from gomavatar_tpu_torch.ops.mesh_ops import entry_dual_index
    from gomavatar_tpu_torch.profile_eval import measure

    def dev_ms(evt):
        us = getattr(evt, "device_time_total", None)
        return (evt.cuda_time_total if us is None else us) / 1e3 / PROFILE_WINDOW

    i_dev = torch.full((), float(trainer.i_iter), device="cuda")
    step = lambda: eager(trainer.params, trainer.opt_state, trainer.statics, trainer.lpips_params, batch, i_dev)  # noqa: E731
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_WINDOW):
            step()
        torch.cuda.synchronize()
    nodes, plain = {}, {}
    for evt in prof.key_averages():
        if evt.key in TRANSPOSE_EVENTS:
            nodes[evt.key.replace(_NODE, "")] = dev_ms(evt)
        elif evt.key.startswith(PLAIN_EVENTS):
            plain[evt.key.replace(_NODE, "")] = dev_ms(evt)
    st, cfg = trainer.statics, trainer.gom_cfg
    f = batch
    with torch.no_grad():
        verts = posed_vertices(trainer.params, st, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
        bins = train_geometry(trainer.params, st, cfg, verts, f["K"], f["E"])["bins"]
    build = measure(lambda: entry_dual_index(bins.entry_gauss, bins.entry_valid, cfg.num_faces,
                                             cfg.max_tiles_per_gaussian), 2, warmup=1, window=PROFILE_WINDOW)
    def nbytes(table):
        return sum(getattr(table, f.name).nbytes for f in dataclasses.fields(table))

    tables = {k: nbytes(getattr(st, k)) for k in ("dual_faces", "dual_nc", "dual_conn", "dual_vfinc", "nbr_table")}
    tables["entry_dual"] = nbytes(bins.entry_dual)
    widths = {k: list(getattr(st, k).pos.shape) + list(getattr(st, k).ov_tab.shape)
              for k in ("dual_faces", "dual_nc", "dual_conn", "dual_vfinc")}
    widths["nbr_table"] = list(st.nbr_table.nbr.shape) + list(st.nbr_table.ov_tab.shape)
    widths["entry_dual"] = list(bins.entry_dual.pos.shape)
    total = sum(nodes.values()) + build["device_ms"]
    print(f"  the step's index transposes, device ms per step (torch.profiler, {PROFILE_WINDOW} eager steps): "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(nodes.items()))
          + f"; the entry table's build {build['device_ms']:.4f} (alone); together {total:.4f} ms; the plain "
          f"forms' nodes {plain or 'none'}")
    print(f"  table bytes: " + ", ".join(f"{k} {v} ({widths[k]})" for k, v in tables.items())
          + f"; the static tables together {sum(v for k, v in tables.items() if k != 'entry_dual')} bytes")
    return {"nodes_ms": nodes, "entry_table_ms": build["device_ms"], "total_ms": total, "plain_nodes_ms": plain,
            "table_bytes": tables, "table_shapes": widths}


def deterministic_cost(params, statics, cfg, i_iter, trainer, batch, profiled: bool = False) -> dict:
    """The captured step under torch's deterministic algorithms (a program
    of its own, captured under them: its replays run their kernels), and
    under them without their fill of new memory
    (``torch.utils.deterministic.fill_uninitialized_memory``), against the
    trainer's captured step: TRAIN_ITERS synchronised steps of each in
    turns after TRAIN_WARMUP, then each one's device ms by CUDA events
    around TRAIN_ITERS back-to-back replays; with ``profiled``, then each
    one's device ms by torch.profiler too (the replays after which the
    profiler crashed a process: :func:`deterministic_profile_child`)."""
    import torch.utils.deterministic as det_flags

    ways = {"default": lambda i: trainer.step(batch)}
    for name, fill in (("deterministic", True), ("deterministic, no fill", False)):
        det_flags.fill_uninitialized_memory = fill
        try:
            with deterministic():
                tr = make_trainer(params, statics, cfg, i_iter, "cuda")
                tr.step(batch)  # the warm-up and the capture
        finally:
            det_flags.fill_uninitialized_memory = True
        ways[name] = lambda i, tr=tr: tr.step(batch)
    in_turns(ways, TRAIN_WARMUP)
    per_step = in_turns(ways, TRAIN_ITERS)
    out = {}
    for k, fn in ways.items():
        out[k] = dict(spread(per_step[k]), device_ms=cuda_ms(lambda: fn(0), TRAIN_ITERS))
        print(f"  captured step, {k} algorithms: median {out[k]['median_ms']:.3f} ms, p90 {out[k]['p90_ms']:.3f} "
              f"over {TRAIN_ITERS} steps in turns; device {out[k]['device_ms']:.3f} ms (events around back-to-back "
              f"replays)")
    out["ratio"] = out["deterministic"]["median_ms"] / out["default"]["median_ms"]
    out["ratio_no_fill"] = out["deterministic, no fill"]["median_ms"] / out["default"]["median_ms"]
    print(f"  the step under deterministic algorithms: {out['ratio']:.3f}x the default's median, "
          f"{out['ratio_no_fill']:.3f}x without the fill of new memory")
    if profiled:
        out["profiled_ms"] = {k: profiled_ms(lambda: fn(0)) for k, fn in ways.items()}
    return out


def deterministic_profile_child() -> None:
    """One child process of :func:`deterministic_profiles` (``python3 -c
    "import chip_smoke; chip_smoke.deterministic_profile_child()"`` from the
    checkout): this script's phases 2-4d, whose profiler sessions and
    captures are the history after which torch.profiler crashed a replay
    of 4d's programs (``programs.py``'s docstring), then those programs
    profiled (:func:`deterministic_cost` with ``profiled``).  Its last line
    is their device ms as JSON."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    card = card_line()
    trained, _ = phase_kernels_b1(card)
    phase_eval_path(trained, card)
    phase_train_kernels(trained)
    _, timings = phase_train_path(trained, card, child=True)
    print(json.dumps(timings["deterministic"]["profiled_ms"]))


def child_runs(env: dict, count: int) -> list:
    """``count`` :func:`deterministic_profile_child` processes run together,
    with ``env`` as their environment: [(exit code, stdout, stderr)]."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", "import chip_smoke; chip_smoke.deterministic_profile_child()"],
                              cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(count)]
    outs = [p.communicate(timeout=900) for p in procs]
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]


def deterministic_profiles() -> dict:
    """4d's device ms of the captured step under deterministic algorithms
    (and without their fill, and the default) by torch.profiler, from
    DET_PROFILE_CHILDREN child processes run one after another, each alone
    on the card (:func:`deterministic_profile_child`): every child must
    exit with 0, so a crash under the profiler fails the smoke.  Returns
    {"exit_codes", "device_ms": {way: per child}}."""
    runs = [child_runs(dict(os.environ), 1)[0] for _ in range(DET_PROFILE_CHILDREN)]
    rcs = [rc for rc, _, _ in runs]
    print(f"  phases 2-4d again in {len(runs)} child processes, then 4d's three programs profiled: exit codes {rcs}")
    for rc, out, err in runs:
        if rc != 0:
            print("    " + "\n    ".join((out + err).splitlines()[-30:]))
    require(all(rc == 0 for rc in rcs), f"4d: a child profiling the captured steps exited with {rcs} (a crash under "
                                        f"torch.profiler: programs.py)")
    ms = [json.loads([line for line in out.splitlines() if line.startswith("{")][-1]) for _, out, _ in runs]
    device = {k: [m[k] for m in ms] for k in ms[0]}
    for k, v in device.items():
        print(f"  captured step, {k} algorithms: device " + ", ".join(f"{x:.3f}" for x in v)
              + f" ms (torch.profiler, {PROFILE_WINDOW} steps, one child each)")
    return {"exit_codes": rcs, "device_ms": device}


def profiler_crash_rates() -> dict:
    """How often :func:`deterministic_profile_child` crashes with
    ``TEARDOWN_CUPTI`` as ``programs.py`` sets it (None: not in the child's
    environment) and at 0 (CUPTI kept set up between profiler sessions):
    10 children of each, DET_PROFILE_CHILDREN at a time.  On the card:
    ``python3 -c "import chip_smoke; chip_smoke.profiler_crash_rates()"``."""
    rates, n = {}, 10
    for value in (None, "0"):
        env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
        if value is not None:
            env["TEARDOWN_CUPTI"] = value
        rcs = []
        while len(rcs) < n:
            rcs += [rc for rc, _, _ in child_runs(env, min(DET_PROFILE_CHILDREN, n - len(rcs)))]
        rates[str(value)] = {"exit_codes": rcs, "crashes": sum(rc != 0 for rc in rcs)}
        print(f"TEARDOWN_CUPTI={value}: {rates[str(value)]['crashes']} of {n} children crashed, exit codes {rcs}")
    print(json.dumps(rates))
    return rates


def phase_train_path(trained, card, child: bool = False):
    """Phases 4b-4d: the gate step card vs CPU, the main path with its
    launch counts, the train-step timings.  Returns (launches, timings).
    In a :func:`deterministic_profile_child` (``child``) 4d profiles its
    deterministic programs in that process."""
    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.optim import tree_leaves
    from gomavatar_tpu_torch.trainer import make_train_step

    i_iter = int(trained_meta()["iter"])
    print(f"[4b] one gate-scene train step at iteration {i_iter}, card vs CPU")
    compare_gate_step(i_iter)

    params, statics, cfg, frame = trained
    print(f"[4c] train path: {TRAIN_STEPS} Trainer.step calls (the captured train program) on the trained avatar at "
          f"512^2 from iteration {i_iter}")
    frames = perturbed_frames(frame)
    batches = [train_batch(params, statics, cfg, f, f) for f in frames]
    trainer = make_trainer(params, statics, cfg, i_iter, "cuda")
    before = [p.clone() for p in tree_leaves(trainer.params)]
    start = clone_tree(trainer.params), clone_tree(trainer.opt_state)
    reserved0 = torch.cuda.memory_reserved()
    snaps = []

    def run():
        out = []
        for i in range(TRAIN_STEPS):
            # each step's outputs are the program's, overwritten by the next step
            out.append(clone_tree(trainer.step(batches[i % len(batches)])))
            snaps.append(train_state(trainer))
        return out

    from gomavatar_tpu_torch.utils import profiling

    t_rec = time.perf_counter()
    with profiling.recording():
        steps, launches, _ = counted(run)
    head_calls = sum(1 for r in profiling.records(t_rec) if isinstance(r, profiling.Count)
                     and r.name == "lpips.head_kernel")
    nhwc_calls = trunk_calls(t_rec)
    for i, (total, losses) in enumerate(steps):
        terms = {k: float(v) for k, v in losses.items()}
        print(f"  step {i}: total {float(total):.6g}, " + ", ".join(f"{k} {v:.5g}" for k, v in terms.items()))
        require(all(np.isfinite(v) for v in terms.values()) and np.isfinite(float(total)), f"step {i}: non-finite loss")
        dropped = terms["bin_drop_budget"] + terms["bin_drop_buffer"] + terms["bin_drop_ncmax"]
        require(dropped == 0, f"step {i}: the binning dropped entries")
    print(f"  launches over {TRAIN_STEPS} steps: {launches} (the program's replays; {trainer._step_fn.captures} "
          f"capture)")
    for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
        require(launches[k] == TRAIN_STEPS, f"the train path did not launch {k} once per step")
    # the LPIPS head: forward (2 launches) and backward (1) in every replay;
    # its counter once per Python call (the warm-up calls and the capture)
    print(f"  lpips_head: {launches['lpips_head']} launches, lpips.head_kernel counted {head_calls} times")
    require(launches["lpips_head"] == 3 * TRAIN_STEPS, "the train path did not run the LPIPS head kernels per step")
    require(head_calls >= 1, "the captured train step did not record lpips.head_kernel")
    print(f"  lpips.trunk_nhwc counted {nhwc_calls} times (two trunks a call: the warm-up calls and the capture)")
    require(nhwc_calls >= 2, "the captured train step's LPIPS trunk did not run channels-last")
    require(trainer._step_fn.captures == 1, "the train program captured more than once in one phase")
    layout = no_layout_transposes("the captured train step", lambda: trainer.step(batches[0]))
    for k in ("B2", "B3", "B4"):  # two kernels each: their launches
        launches[k] = launches[f"{k}a"] + launches[f"{k}b"]
    after = tree_leaves(trainer.params)
    moments = list(trainer.opt_state.mu) + list(trainer.opt_state.nu)
    require(all(bool(torch.isfinite(p).all()) for p in after + moments), "non-finite parameters or gradients")
    changed = sum(not torch.equal(a, b) for a, b in zip(after, before))
    print(f"  {changed} of {len(after)} parameter leaves changed; every parameter and moment finite")
    require(changed == len(after), "a parameter leaf did not change")
    pool_mib = trainer._step_fn.pool_bytes() / 2**20
    print(f"  the train program's memory pool at {cfg.num_faces} faces and {cfg.img_size[0]}^2: {pool_mib:.1f} MiB "
          f"(the card's reserved memory grew by {(torch.cuda.memory_reserved() - reserved0) / 2**20:.1f} MiB over "
          f"the capture and the steps)")

    print(f"[4c] the same {TRAIN_STEPS} steps again from the same state, torch's default algorithms: a second "
          f"trainer's captured steps and the eager step")
    twice = make_trainer(params, statics, cfg, i_iter, "cuda")
    eager = make_train_step(twice.gom_cfg, twice.loss_cfg, twice.tx)
    p, o = start
    probe = {"leaves": len(snaps[0][0]) + len(snaps[0][1]), "values_differing": [], "leaves_differing": []}
    for i in range(TRAIN_STEPS):
        b = batches[i % len(batches)]
        total, _ = twice.step(b)
        again = train_state(twice)
        diffs = state_diffs(snaps[i], again)
        probe["values_differing"].append(sum(diffs))
        probe["leaves_differing"].append(sum(d > 0 for d in diffs))
        require(sum(diffs) == 0 and again[2] == snaps[i][2] and torch.equal(total, steps[i][0]),
                f"4c step {i}: {sum(diffs)} values in {sum(d > 0 for d in diffs)} leaves differ between two runs of "
                f"Trainer.step from one state")
        p, o, total_e, _ = eager(p, o, twice.statics, twice.lpips_params, b,
                                 torch.full((), float(i_iter + i), device="cuda"))
        same = (leaves_equal(tree_leaves(p), snaps[i][0]) and leaves_equal(list(o.mu) + list(o.nu), snaps[i][1])
                and int(o.count) == snaps[i][2] and torch.equal(total_e, steps[i][0]))
        require(same, f"4c step {i}: the captured step differs from the eager one")
    print(f"  after each of {TRAIN_STEPS} steps: 0 of the {probe['leaves']} params and Adam moments differ in any "
          f"value between the two runs (values differing per step {probe['values_differing']}); counts and the "
          f"total equal; the eager step from the same state bit-equal too")
    del twice
    unlisted = nondeterministic_ops(trainer, eager, batches[0])
    i_dev = torch.full((), float(trainer.i_iter), device="cuda")
    scatters = scatter_ops("train", lambda: eager(trainer.params, trainer.opt_state, trainer.statics,
                                                  trainer.lpips_params, batches[0], i_dev))
    transposes = transpose_costs(trainer, eager, batches[0])

    print(f"[4d] train step timed, eager and captured, over {TRAIN_ITERS} steps after {TRAIN_WARMUP} warm-up steps")
    i_dev = torch.full((), float(trainer.i_iter), device="cuda")
    timed = eager_and_captured("train step", {
        # the eager step from the trainer's state, its result dropped
        "eager": lambda: eager(trainer.params, trainer.opt_state, trainer.statics, trainer.lpips_params, batches[0],
                               i_dev),
        "captured": lambda: trainer.step(batches[0]),
    }, TRAIN_ITERS, "step", card)
    cap = timed["captured"]
    det = deterministic_cost(params, statics, cfg, i_iter, trainer, batches[0], profiled=child)
    if not child:
        det["profiled"] = deterministic_profiles()
    return launches, dict(timed, median_ms=cap["median_ms"], p90_ms=cap["p90_ms"],
                          steps_per_s=1e3 / cap["median_ms"], steps=TRAIN_ITERS, pool_mib=pool_mib,
                          bit_equal_default=True, probe_default_algorithms=probe, nondeterministic_ops=unlisted,
                          scatter_ops=scatters, layout_transposes=layout, lpips_trunk_nhwc=nhwc_calls,
                          transposes=transposes, deterministic=det)


# ---- phase 5: the drivers ------------------------------------------------------

# the drivers' captures: DRIVER_IMG^2 targets decoded from (2 x DRIVER_IMG)^2
# files, DRIVER_FRAMES train frames and DRIVER_TEST_FRAMES test frames; the
# resume runs RESUME_STEPS steps from the trained avatar's iteration, with
# one periodic eval and one save at the second
DRIVER_IMG, DRIVER_FRAMES, DRIVER_TEST_FRAMES, RESUME_STEPS = 512, 6, 2, 3
# the gate-scene phase change: PHASE_STEPS steps, subdividing at PHASE_AT
PHASE_STEPS, PHASE_AT = 4, 2
# 5e: the gate scene's free trajectories over TRAJ_STEPS steps, subdividing
# at TRAJ_SPLIT, LPIPS in float32 on both devices: the card's change of the
# params over each phase parts from the CPU's by at most TRAJ_K times what a
# CPU witness's does, whose float params are moved one float32 up before
# every step (rounding alone; the witness must part).  K was fixed on the
# CPU before any card run, from a second witness moved one float32 down:
# the two witnesses' partings differed by a ratio of 1.018 and 1.043 at the
# two phase ends, not above 2, so K stays at 2, the multiple of
# tests/test_torch_e2e_parity.py
TRAJ_STEPS, TRAJ_SPLIT, TRAJ_K = 40, 20, 2.0
# the steady driver loop: LOOP_WINDOWS logged windows of LOOP_LOG steps after
# a first window that the resume point cuts short; no eval, no save, no sync
# but the log line's
LOOP_LOG, LOOP_WINDOWS = 10, 2
DRIVER_DIR = "build/smoke_drivers"  # under the checkout, gitignored


def log_lines(path: str, *needles: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if any(n in line for n in needles)]


def write_driver_fixtures(root: str):
    """Phase 5a: a DRIVER_IMG^2 train capture and a test capture written by
    the port's fixture writer, each with the trained avatar's base body in
    its canonical_joints.pkl, and the exp yaml: the trained avatar's model
    and train configs with the dataset paths pointed at them.  Returns the
    yaml's path."""
    import pickle
    import shutil

    import yaml

    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.data.synthetic import write_synthetic_dataset
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.scene import trained_train_cfg

    shutil.rmtree(root, ignore_errors=True)
    body = synthetic_body(**trained_meta()["body"])
    dirs = {}
    for split, n, seed in (("train", DRIVER_FRAMES, 0), ("test", DRIVER_TEST_FRAMES, 1)):
        dirs[split] = write_synthetic_dataset(f"{root}/{split}", n_frames=n, img_hw=(DRIVER_IMG, DRIVER_IMG),
                                              seed=seed)
        with open(f"{dirs[split]}/canonical_joints.pkl", "wb") as f:
            pickle.dump({"vertex": body["canonical_vertex"], "joints": body["canonical_joints"],
                         "weights": body["canonical_lbs_weights"], "faces": body["faces"], "edges": None}, f)
    base = trained_train_cfg()
    model = dict(base["model"], img_size=[DRIVER_IMG, DRIVER_IMG])
    train = dict(base["train"], log_freq=1, tb_freq=1000, save_freq=2, eval_freq=2)
    cfg = {
        "exp_name": "e2e", "log_dir": f"{root}/log", "random_bgcolor": True, "bgcolor": [0.0, 0.0, 0.0],
        "img_size": [DRIVER_IMG, DRIVER_IMG],
        "dataset": {
            # the trained avatar's experiment asks for the native decoder;
            # where its library cannot load, the driver takes the cv2 path
            "train": {"dataset_path": dirs["train"], "use_native": True},
            "test_view": {"name": "snapshot", "dataset_path": dirs["test"], "skip": 1},
            "test_freeview": {"dataset_path": dirs["train"], "src_type": "zju_mocap"},
        },
        "model": model,
        "train": train,
    }
    path = f"{root}/exp.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(json.loads(json.dumps(cfg)), f)  # Config objects as plain dicts
    return path


def check_driver_eval(label, result, launches, seconds, n_faces, it):
    """A cli.evaluate run: its iteration and face count, B1a and B1b once
    per frame and nothing else, 0 dropped, finite metrics, PNGs that are
    not black.  Returns {seconds, frames/s by the wall clock, launches,
    metrics}."""
    from PIL import Image

    frames = result["frames"]
    means = result["metrics"]
    print(f"  {label}: iter {result['iter']}, {result['num_faces']} faces, {frames} frames in {seconds:.2f} s of wall "
          f"time, dropped {result['dropped']}, launches {launches}, metrics {means}")
    require(result["iter"] == it and result["num_faces"] == n_faces, f"{label}: wrong checkpoint or face count")
    require(launches["B1a"] == launches["B1b"] == frames, f"{label}: B1a and B1b did not launch once per frame")
    require(all(launches[k] == 0 for k in TRAIN_KERNELS), f"{label}: a train kernel launched")
    require(result["dropped"] == 0, f"{label}: the binning dropped entries")
    require(means and all(np.isfinite(v) for v in means.values()), f"{label}: non-finite or missing metrics")
    pngs = sorted(f for f in os.listdir(result["out_dir"]) if f.endswith(".png"))
    require(len(pngs) == frames, f"{label}: {len(pngs)} PNGs for {frames} frames")
    levels = [float(np.asarray(Image.open(f"{result['out_dir']}/{f}")).mean()) for f in pngs]
    print(f"  {label}: PNG mean levels {', '.join(f'{v:.2f}' for v in levels)}")
    require(min(levels) > 1.0, f"{label}: a black PNG")
    return {"seconds": seconds, "frames_per_s": frames / seconds, "launches": launches, "metrics": means}


def phase_driver_eval(cfg_path: str, trained, device="cuda"):
    """Phase 5b: the trained avatar saved as a checkpoint of the port, then
    cli.evaluate --type train (ZJU protocol, VGG-LPIPS) and --type view
    (snapshot protocol, AlexNet-LPIPS) from it; the train eval's first PNG
    against the same frame rendered from the avatar in memory."""
    from PIL import Image

    from gomavatar_tpu_torch.cli import evaluate
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.data.dataset import TrainDataset, to_device
    from gomavatar_tpu_torch.eval_lib import to_8b_image
    from gomavatar_tpu_torch.losses import unpack
    from gomavatar_tpu_torch.models.gom import gom_forward
    from gomavatar_tpu_torch.trainer import Trainer

    params, statics, cfg, _ = trained
    meta = trained_meta()
    it, phase = int(meta["iter"]), int(meta["phase"])
    exp = make_cfg(cfg_path)
    ckpt_dir = f"{exp['save_dir']}/checkpoints"
    Trainer(exp, device=device, state=(params, statics, cfg, it, phase)).save(ckpt_dir)
    print(f"  saved the trained avatar ({cfg.num_faces} faces, iteration {it}, phase {phase}) as {ckpt_dir}/iter_{it}")
    out = {}
    for t in ("train", "view"):
        result, launches, seconds = counted(lambda: evaluate.main(["--cfg", cfg_path, "--type", t, "--device", device]))
        out[t] = check_driver_eval(f"cli.evaluate --type {t}", result, launches, seconds, meta["num_faces"], it)
        for line in log_lines(f"{exp['save_dir']}/log_eval_{t}.txt", "frames/s", "subdividing", "metrics:"):
            print(f"    log: {line}")

    item = TrainDataset(exp["dataset"]["train"]["dataset_path"], bgcolor=exp["bgcolor"],
                        target_size=exp["img_size"])[0]
    b = to_device(item, device)
    with torch.no_grad():
        rgb, mask, _ = gom_forward(params, statics, dataclasses.replace(cfg, img_size=tuple(exp["img_size"])),
                                   b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"], b["dst_Ts"],
                                   dst_posevec=b["dst_posevec"], i_iter=float(it), device=device)
    want = to_8b_image(unpack(rgb, mask, torch.zeros(3, device=device), clamp=True).cpu().numpy()).astype(int)
    got = np.asarray(Image.open(f"{exp['save_dir']}/eval/train/{item['frame_name']}.png")).astype(int)
    d = np.abs(got - want)
    frac = float((d == 0).mean())
    print(f"  {item['frame_name']}.png of cli.evaluate --type train against the avatar rendered in memory: equal on "
          f"{frac * 100:.4f} % of values, worst {int(d.max())} levels")
    require(frac >= HIT_FRAC and int(d.max()) <= 1, "the evaluated checkpoint renders another image")
    return out


def phase_driver_train(cfg_path: str, device="cuda"):
    """Phase 5c: cli.train --resume from the saved iteration for
    RESUME_STEPS steps, with one periodic eval and one save; then the last
    checkpoint restored into a fresh Trainer, bit-equal to the run's."""
    from gomavatar_tpu_torch import trainer as T
    from gomavatar_tpu_torch.cli import train as train_cli
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.data.dataset import TrainDataset
    from gomavatar_tpu_torch.optim import tree_leaves

    meta = trained_meta()
    start = int(meta["iter"])
    stop = start + RESUME_STEPS
    exp = make_cfg(cfg_path)
    ckpt_dir = f"{exp['save_dir']}/checkpoints"
    # every step reads its drop counters and fails on a drop (the opt-in
    # check; one sync per step, as the log line at log_freq 1 takes anyway)
    T._DEBUG_BINNING = True
    try:
        trainer, launches, seconds = counted(
            lambda: train_cli.main(["--cfg", cfg_path, "--resume", "--max_iters", str(stop), "--device", device]))
    finally:
        T._DEBUG_BINNING = False
    eval_frames = min(DRIVER_FRAMES, 4) + min(DRIVER_TEST_FRAMES, 8)
    print(f"  cli.train --resume --max_iters {stop}: {seconds:.2f} s of wall time, iteration {trainer.i_iter}, phase "
          f"{trainer.phase}, {trainer.gom_cfg.num_faces} faces, launches {launches}")
    logged = log_lines(f"{exp['save_dir']}/log.txt", "it/s", "evaluate on", "resumed", "native", "subdividing")
    for line in logged:
        print(f"    log: {line}")
    require(trainer.i_iter == stop and trainer.phase == int(meta["phase"]) and
            trainer.gom_cfg.num_faces == meta["num_faces"], "the resumed run ended in the wrong state")
    for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
        require(launches[k] == RESUME_STEPS, f"cli.train did not launch {k} once per step")
    require(launches["B1a"] == launches["B1b"] == eval_frames, "the periodic eval did not launch B1 once per frame")
    for i in (start + 2, stop):
        require(os.path.isdir(f"{ckpt_dir}/iter_{i}"), f"iter_{i} was not written")

    fresh = T.Trainer(exp, TrainDataset(exp["dataset"]["train"]["dataset_path"]).get_canonical_info(), device=device)
    require(fresh.resume(ckpt_dir), "no checkpoint to resume from")
    a, b = fresh.opt_state, trainer.opt_state
    same = (fresh.i_iter == trainer.i_iter and fresh.phase == trainer.phase and a.count == b.count
            and a.schedule_count == b.schedule_count
            and all(torch.equal(x, y) for x, y in zip(tree_leaves(fresh.params), tree_leaves(trainer.params)))
            and all(torch.equal(x, y) for x, y in zip(a.mu + a.nu, b.mu + b.nu)))
    print(f"  iter_{stop} restored into a fresh Trainer: iteration {fresh.i_iter}, phase {fresh.phase}; params and "
          f"Adam state bit-equal to the run's: {same}")
    require(same, "the restored checkpoint differs from the run's state")
    rates = [float(line.split("(")[1].split(" it/s")[0]) for line in logged if " it/s)" in line]
    return {"seconds": seconds, "steps": RESUME_STEPS, "it_per_s_logged": rates, "launches": launches}


def phase_driver_loop(cfg_path: str, device="cuda"):
    """Phase 5c, timing: the host decode of one train item, then cli.train
    --resume in a steady loop (log_freq LOOP_LOG, the eval, TB and save
    cadences off); its steps/s as the log reports them, over the full
    windows."""
    import yaml

    from gomavatar_tpu_torch.checkpoint import latest_checkpoint
    from gomavatar_tpu_torch.cli import train as train_cli
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.data.dataset import TrainDataset

    exp = make_cfg(cfg_path)
    ds = TrainDataset(exp["dataset"]["train"]["dataset_path"], target_size=exp["img_size"],
                      rng=np.random.default_rng(0))
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(ds)
    print(f"  host decode of one train item (two {2 * DRIVER_IMG}^2 PNGs, composite, Lanczos resize to "
          f"{DRIVER_IMG}^2), serially: {decode_ms:.2f} ms")
    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["train"].update(log_freq=LOOP_LOG, tb_freq=10**9, save_freq=10**9, eval_freq=10**9)
    loop_path = cfg_path.replace(".yaml", "_loop.yaml")
    with open(loop_path, "w") as f:
        yaml.safe_dump(cfg, f)
    start = latest_checkpoint(f"{exp['save_dir']}/checkpoints")[1]
    stop = (start // LOOP_LOG + 1 + LOOP_WINDOWS) * LOOP_LOG
    trainer, launches, seconds = counted(
        lambda: train_cli.main(["--cfg", loop_path, "--resume", "--max_iters", str(stop), "--device", device]))
    logged = [line for line in log_lines(f"{exp['save_dir']}/log.txt", " it/s)")
              if int(line.split("iter ")[1].split(" ")[0]) > start]
    rates = [float(line.split("(")[1].split(" it/s")[0]) for line in logged]
    for line in logged:
        print(f"    log: {line[:80]}")
    steps = stop - start
    print(f"  cli.train --resume --max_iters {stop}: {steps} steps in {seconds:.2f} s of wall time (resume included); "
          f"steps/s over the {LOOP_WINDOWS} full windows of {LOOP_LOG}: {rates[1:]}")
    require(trainer.i_iter == stop and len(rates) == LOOP_WINDOWS + 1, "the timed loop did not run its windows")
    for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
        require(launches[k] == steps, f"the timed loop did not launch {k} once per step")
    return {"decode_ms_per_item": decode_ms, "steps": steps, "it_per_s_logged": rates[1:], "seconds": seconds}


def copy_train_state(src, dst):
    """``dst``'s params, Adam state and iteration set to ``src``'s, on
    ``dst``'s device."""
    def to(x):
        if isinstance(x, dict):
            return {k: to(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(to(v) for v in x)
        return x.detach().to(dst.device).clone()

    dst.params = to(src.params)
    dst.opt_state = type(src.opt_state)(*(to(x) for x in src.opt_state))
    dst.i_iter = src.i_iter


def gate_phase_trainer(device, split: int):
    """A fresh gate-scene Trainer from seed 0 (its per-face so3, scale and
    colors from numpy seed 0) with the trained avatar's train config,
    subdividing at iteration ``split``."""
    from gomavatar_tpu_torch.models.lpips import load_lpips
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.scene import gate_model_cfg, trained_train_cfg
    from gomavatar_tpu_torch.trainer import Trainer

    info = synthetic_body(n_rings=16, n_seg=18)
    cfg = {"model": dict(gate_model_cfg(), subdivide_iters=[split]), "train": trained_train_cfg()["train"]}
    tr = Trainer(cfg, info, lpips_params=load_lpips(device=device, quiet=True)[0], device=device, seed=0)
    randomize_faces(tr.params, tr.gom_cfg.num_faces, device)
    return tr


def gate_phase_batch(trainer):
    """5d's batch: the gate frame, its targets the trainer's render of a
    perturbed view (:func:`train_batch`)."""
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.scene import gate_frame

    frame = gate_frame(synthetic_body(n_rings=16, n_seg=18), device=trainer.device)
    return train_batch(trainer.params, trainer.statics, trainer.gom_cfg, frame, perturbed_frames(frame)[1])


def phase_change_on_card(device="cuda"):
    """Phase 5d: a fresh gate-scene Trainer (its per-face so3, scale and
    colors from numpy seed 0) with subdivide_iters [PHASE_AT], PHASE_STEPS
    steps on the card, each step also taken on the CPU from the card's state
    (params, Adam state, iteration): every loss term and every leaf's
    gradient close at every step, the faces x4 from step PHASE_AT on in
    both, every train kernel launched once at every step on the card.  The
    gradient is read from Adam's first moments, which both sides update
    from the same moments: mu' = 0.9 mu + 0.1 g.  Each step starts from the
    card's state because the free-running four-step trajectories parted
    past rtol 1e-3 in one run (step 3's rgb loss, after the subdivision),
    as rounding alone parts them (5e holds the free trajectories to a
    rounding witness).
    A second card trainer from the same init runs the same steps free, under
    torch's default algorithms: its params and Adam moments bit-equal to the
    first's after every step, across the subdivision."""
    from gomavatar_tpu_torch.optim import B1

    card, host, again = (gate_phase_trainer(d, PHASE_AT) for d in (device, "cpu", device))
    faces0 = card.gom_cfg.num_faces
    batch = gate_phase_batch(card)
    host_batch = {k: v.to("cpu") for k, v in batch.items()}

    def losses_of(total, losses):
        return {"total": float(total), **{k: float(v) for k, v in losses.items()}}

    worst_grad, programs, differing = [], [], []
    for i in range(PHASE_STEPS):
        card.maybe_subdivide()
        host.maybe_subdivide()
        again.maybe_subdivide()
        copy_train_state(card, host)
        mu0 = host.opt_state.mu
        (total, losses), launches, _ = counted(lambda: card.step(batch))
        if not programs or programs[-1] is not card._step_fn:
            programs.append(card._step_fn)
        total2, _ = again.step(batch)
        diffs = state_diffs(train_state(card), train_state(again))
        differing.append(sum(diffs))
        require(sum(diffs) == 0 and torch.equal(total, total2),
                f"phase change, step {i}: {sum(diffs)} values differ between two runs from one init on the card")
        for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
            require(launches[k] == 1, f"phase change, step {i}: {k} launched {launches[k]} times")
        lc, fc = losses_of(total, losses), card.gom_cfg.num_faces
        lh, fh = losses_of(*host.step(host_batch)), host.gom_cfg.num_faces
        want = faces0 * (4 if i >= PHASE_AT else 1)
        print(f"  step {i}: {fc} faces on the card, {fh} on the CPU; " + ", ".join(
            f"{k} {lc[k]:.6g}/{lh[k]:.6g}" for k in lc if not k.startswith("bin_drop")))
        require(fc == fh == want, f"phase change, step {i}: {fc} and {fh} faces where {want} were expected")
        require(set(lc) == set(lh), f"phase change, step {i}: the card and the CPU give different loss terms")
        for k in lc:
            rtol = STEP_LPIPS_RTOL if k in ("lpips", "total") else STEP_RTOL
            require(abs(lc[k] - lh[k]) <= rtol * abs(lh[k]) + 1e-7,
                    f"phase change, step {i}: {k} differs between the card and the CPU by more than rtol {rtol:g}")
        rels = []
        for j, (mc, mh, m0) in enumerate(zip(card.opt_state.mu, host.opt_state.mu, mu0)):
            mc = mc.cpu()
            require(bool(torch.isfinite(mc).all()), f"phase change, step {i}: non-finite gradient in leaf {j}")
            g_host = (mh - B1 * m0) / (1.0 - B1)
            rels.append(float(torch.linalg.norm((mc - mh) / (1.0 - B1))
                              / torch.clamp_min(torch.linalg.norm(g_host), 1e-30)))
        worst = max(range(len(rels)), key=rels.__getitem__)
        print(f"    gradients, relative L2 difference per leaf: " + " ".join(f"{r:.2g}" for r in rels))
        require(rels[worst] <= STEP_GRAD_REL,
                f"phase change, step {i}: leaf {worst} gradient off by {rels[worst]:.3g} of its norm")
        worst_grad.append(rels[worst])
    print(f"  train programs: {len(programs)}, captures {[p.captures for p in programs]}")
    require(len(programs) == 2 and all(p.captures == 1 for p in programs),
            "phase change: the train step was not captured once per phase")
    print(f"  the phase change ran on the card at step {PHASE_AT}: {faces0} -> {4 * faces0} faces, each loss term "
          f"within rtol {STEP_RTOL:g} (LPIPS and the total {STEP_LPIPS_RTOL:g}) and each leaf's gradient within "
          f"{STEP_GRAD_REL:g} of its norm of the CPU's step from the card's state at every step; a second run on "
          f"the card from the same init bit-equal after every step (values differing {differing})")
    return {"faces": [faces0, 4 * faces0], "steps": PHASE_STEPS, "worst_grad_rel": worst_grad,
            "programs": len(programs), "twice_values_differing": differing}


@contextlib.contextmanager
def float32_lpips():
    """The train loss's LPIPS term in float32 while the context lasts (a
    one-ulp witness says nothing of bfloat16 convolutions, which cuDNN and
    the CPU round differently); a program captured inside keeps it."""
    from gomavatar_tpu_torch import losses
    from gomavatar_tpu_torch.models.lpips import lpips

    saved = losses.lpips_fn
    losses.lpips_fn = lambda params, pred, gt: lpips(params, pred, gt, bf16=False)
    try:
        yield
    finally:
        losses.lpips_fn = saved


def nudge_params(trainer, toward: float) -> None:
    """Every float param leaf of ``trainer`` moved in place to its next
    float32 toward ``toward`` (+inf or -inf)."""
    from gomavatar_tpu_torch.optim import tree_leaves

    with torch.no_grad():
        for p in tree_leaves(trainer.params):
            if p.is_floating_point():
                p.copy_(torch.nextafter(p, torch.full_like(p, toward)))


def parting(a: list, b: list) -> float:
    """The relative L2 difference of two lists of leaves over all of them,
    ``b`` the reference, in float64."""
    num = sum(float(((x.double() - y.double()) ** 2).sum()) for x, y in zip(a, b))
    den = sum(float((y.double() ** 2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


def phase_trajectory(devices=("cuda", "cpu"), steps: int = TRAJ_STEPS, split: int = TRAJ_SPLIT,
                     witnesses=(("witness", math.inf),)) -> dict:
    """Phase 5e: gate-scene trainers from one init (:func:`gate_phase_trainer`)
    run free for ``steps`` steps, subdividing at ``split``, with LPIPS in
    float32: "card" on ``devices[0]`` (its train program captured under
    float32 LPIPS), "cpu" on ``devices[1]``, and each witness ``(name,
    toward)`` on ``devices[1]`` with its float params moved one float32
    toward ``toward`` before every step.  Each step prints the runs' total
    losses and their relative differences from the CPU's, and how far each
    run's change of the params since its phase began parts from the CPU's.
    At each phase end (phase 0: from init to just before the split; phase 1:
    from one step after it to the end, as tests/test_torch_e2e_parity.py
    measures a phase) the card's parting of the change over all leaves is at
    most TRAJ_K times the first witness's, which must be > 0."""
    from gomavatar_tpu_torch.optim import tree_leaves

    card_dev, host_dev = devices
    with float32_lpips():
        runs = {"card": gate_phase_trainer(card_dev, split), "cpu": gate_phase_trainer(host_dev, split)}
        for name, _ in witnesses:
            runs[name] = gate_phase_trainer(host_dev, split)
        batch = gate_phase_batch(runs["card"])
        batches = {name: {key: v.to(tr.device) for key, v in batch.items()} for name, tr in runs.items()}
        faces0 = runs["card"].gom_cfg.num_faces

        def snap():
            return {name: [p.detach().to("cpu", copy=True) for p in tree_leaves(tr.params)]
                    for name, tr in runs.items()}

        bounds, losses, per_step = [snap()], {name: [] for name in runs}, []
        start = bounds[0]
        for i in range(steps):
            if i == split:
                bounds.append(snap())
            for name, toward in witnesses:
                nudge_params(runs[name], toward)
            for name, tr in runs.items():
                total, _ = tr.step(batches[name])
                losses[name].append(float(total))
            now = snap()
            if i == split:
                bounds.append(now)
                start = now
                require(all(tr.gom_cfg.num_faces == 4 * faces0 for tr in runs.values()),
                        f"5e: the runs did not subdivide to {4 * faces0} faces at step {split}")
            ref = [b - a for a, b in zip(start["cpu"], now["cpu"])]
            params = {name: parting([b - a for a, b in zip(start[name], now[name])], ref)
                      for name in runs if name != "cpu"} if i != split else {}
            per_step.append(params)
            lc = losses["cpu"][-1]
            print(f"  step {i}: total " + ", ".join(f"{name} {v[-1]:.7g}" for name, v in losses.items())
                  + "; relative to the CPU's " + ", ".join(f"{name} {abs(v[-1] - lc) / abs(lc):.3g}"
                                                           for name, v in losses.items() if name != "cpu")
                  + ("; the params' change since the phase began parts from the CPU's by " + ", ".join(
                      f"{name} {v:.4g}" for name, v in params.items()) if params else "; the split step"))
        bounds.append(snap())
    out = {"steps": steps, "split": split, "k": TRAJ_K, "losses": losses, "param_parting_per_step": per_step,
           "phases": []}
    for phase, (a, b) in enumerate(((bounds[0], bounds[1]), (bounds[2], bounds[3]))):
        change = {name: [y - x for x, y in zip(a[name], b[name])] for name in runs}
        ref = change["cpu"]
        require(max(float(d.abs().max()) for d in ref) > 0, f"5e: the CPU's params did not move in phase {phase}")
        part = {name: parting(change[name], ref) for name in runs if name != "cpu"}
        # a leaf that does not move on the CPU (a module not yet kicked in) has no parting: None
        leaves = {name: [parting([x], [y]) if float(y.abs().max()) > 0 else None for x, y in zip(change[name], ref)]
                  for name in part}
        print(f"  phase {phase} ({'init to the split' if phase == 0 else 'one step after the split to the end'}): "
              f"the change of the params parts from the CPU's by " + ", ".join(f"{n} {v:.4g}" for n, v in part.items())
              + f" (relative L2 over all {len(ref)} leaves; limit: the card at most {TRAJ_K:g}x the witness's)")
        for name, v in leaves.items():
            print(f"    per leaf, {name}: " + " ".join("-" if r is None else f"{r:.3g}" for r in v))
        witness = part[witnesses[0][0]]
        require(witness > 0, f"5e: phase {phase}: the witness did not part from the CPU's run")
        require(part["card"] <= TRAJ_K * witness,
                f"5e: phase {phase}: the card's change of the params parts from the CPU's by {part['card']:.4g}, more "
                f"than {TRAJ_K:g}x the witness's {witness:.4g}")
        out["phases"].append({"parting": part, "per_leaf": leaves})
    return out


def phase_drivers(device="cuda"):
    """Phase 5: the drivers on the card (``device`` other than cuda: a
    rehearsal of the phase's code, whose launch checks then fail)."""
    from gomavatar_tpu_torch.convert import load_trained

    out = {}
    t0 = time.perf_counter()
    print(f"[5a] fixtures: {DRIVER_FRAMES} train and {DRIVER_TEST_FRAMES} test frames at {DRIVER_IMG}^2, the trained "
          f"avatar's base body")
    cfg_path = write_driver_fixtures(DRIVER_DIR)
    print(f"  phase 5a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("[5b] cli.evaluate --type train and --type view from the trained avatar's checkpoint")
    out["evaluate"] = phase_driver_eval(cfg_path, load_trained(device=device), device)
    print(f"  phase 5b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[5c] cli.train --resume for {RESUME_STEPS} steps, then the checkpoint restored into a fresh Trainer")
    out["train_resume"] = phase_driver_train(cfg_path, device)
    print(f"  cli.train's steady loop, {LOOP_WINDOWS} windows of {LOOP_LOG} steps timed by its log")
    out["train_loop"] = phase_driver_loop(cfg_path, device)
    print(f"  phase 5c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[5d] the phase change on the card: the gate scene from init, subdivide_iters [{PHASE_AT}], {PHASE_STEPS} "
          f"steps on the card, each also on the CPU from the card's state")
    out["phase_change"] = phase_change_on_card(device)
    print(f"  phase 5d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[5e] the gate scene's free trajectories from one init, {TRAJ_STEPS} steps subdividing at {TRAJ_SPLIT}, "
          f"float32 LPIPS: the card, the CPU, and a CPU witness moved one float32 up before every step")
    out["trajectory"] = phase_trajectory((device, "cpu"))
    print(f"  phase 5e: {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 6: pose refinement and animation ------------------------------------

# 6b: POSE_STEPS steps of the pose optimizer on the trained avatar from the
# packed frame's joint angles plus N(0, POSE_NOISE) (numpy seed 0, the noise
# of tools/make_e2e_data.py --pose_noise), then POSE_TIMED one-step calls,
# each synchronised, for the step's median; the seconds of a test frame are
# those of PROTOCOL_STEPS steps (configs/exps/snapshot_*.yaml, pose.iters)
POSE_NOISE, POSE_STEPS, POSE_TIMED, PROTOCOL_STEPS = 0.03, 30, 20, 300
# 6c: cli.train_pose over CLI_POSE_FRAMES test frames, CLI_POSE_ITERS steps
# each, the step size halving every CLI_POSE_DECAY
CLI_POSE_FRAMES, CLI_POSE_ITERS, CLI_POSE_DECAY = 2, 10, 5
# 6d: cli.animate, two scenes over ANIM_FRAMES orbit frames and
# ANIM_MDM_FRAMES motion frames
ANIM_SCENES, ANIM_FRAMES, ANIM_MDM_FRAMES = 2, 4, 2
TRAIN_KERNELS = ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5")


def packed_pose(frame):
    """The 72-d pose and the T-pose joints (24, 3) behind a frame's dst_Rs,
    dst_Ts and dst_posevec: the root angle from dst_Rs[0], the joint angles
    dst_posevec - 0.01, the joints summed down the chain from dst_Ts; checked
    against the frame through body_pose_to_body_RTs."""
    from gomavatar_tpu_torch.ops.skeleton import SMPL_PARENT, body_pose_to_body_RTs
    from gomavatar_tpu_torch.ops.transforms import so3_log

    Rs = frame["dst_Rs"].cpu().numpy()
    Ts = frame["dst_Ts"].cpu().numpy().astype(np.float64)
    pose = np.zeros(72, np.float32)
    pose[:3] = so3_log(torch.as_tensor(Rs[0], dtype=torch.float64)).numpy()
    pose[3:] = frame["dst_posevec"].cpu().numpy() - np.float32(1e-2)
    joints = np.zeros((24, 3))
    joints[0] = Ts[0]
    for i in range(1, 24):
        joints[i] = joints[SMPL_PARENT[i]] + Ts[i]
    joints = joints.astype(np.float32)
    dev = frame["dst_Rs"].device
    R2, T2 = body_pose_to_body_RTs(torch.as_tensor(pose, device=dev), torch.as_tensor(joints, device=dev))
    err = max(float((R2 - frame["dst_Rs"]).abs().max()), float((T2 - frame["dst_Ts"]).abs().max()))
    print(f"  the packed frame's pose rebuilt: body_pose_to_body_RTs reproduces dst_Rs and dst_Ts within {err:.3g}")
    require(err < 1e-5, "the packed frame's pose does not reproduce its bone transforms")
    return pose, joints


def pose_batch(params, statics, cfg, frame, joints, target_frame):
    """The pose loss's batch: ``train_batch``'s (the port's eval render of
    ``target_frame`` on black as the targets) with the T-pose joints."""
    batch = train_batch(params, statics, cfg, frame, target_frame)
    batch["dst_tpose_joints"] = torch.as_tensor(joints, device=frame["K"].device)
    return batch


def pose_loss_grads(params, statics, cfg, loss_cfg, lpips_params, batch, pose):
    """(loss, {Rh, Th, poses: gradient}, dropped) of the pose loss at
    (Rh = Th = 0, ``pose``)."""
    from gomavatar_tpu_torch.cli.train_pose import POSE_KEYS, frame_loss

    dev = batch["K"].device
    v = {"Rh": torch.zeros(3, device=dev, requires_grad=True), "Th": torch.zeros(3, device=dev, requires_grad=True),
         "poses": torch.as_tensor(pose, device=dev).requires_grad_(True)}
    loss, dropped = frame_loss(v, params, statics, cfg, loss_cfg, lpips_params, batch)
    grads = torch.autograd.grad(loss, [v[k] for k in POSE_KEYS])
    return float(loss.detach()), {k: g.cpu() for k, g in zip(POSE_KEYS, grads)}, int(dropped)


def pose_gradient_on_card(device="cuda"):
    """Phase 6a: the gate scene's pose loss and its gradient in (Rh, Th,
    pose) at Rh = Th = 0 and a perturbed pose, on ``device`` and on the
    CPU."""
    from gomavatar_tpu_torch.models.lpips import load_lpips
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.scene import trained_train_cfg

    loss_cfg = trained_train_cfg()["train"]["losses"]
    joints = synthetic_body(n_rings=16, n_seg=18)["canonical_joints"]
    pose = np.zeros(72, np.float32)
    pose[12] = 0.3  # the gate frame's pose
    rng = np.random.default_rng(0)
    pose[3:] += rng.normal(size=69).astype(np.float32) * POSE_NOISE
    g_params, g_statics, g_cfg, g_frame = gate_train_scene(device)
    batch = pose_batch(g_params, g_statics, g_cfg, g_frame, joints, perturbed_frames(g_frame)[1])
    out = {}
    for dev in (device, "cpu"):
        params, statics, cfg, _ = gate_train_scene(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        out[dev] = pose_loss_grads(params, statics, cfg, loss_cfg, load_lpips(device=dev, quiet=True)[0], b, pose)
    (lc, gc, dc), (lh, gh, dh) = out[device], out["cpu"]
    print(f"  gate pose loss: card {lc:.7g}, CPU {lh:.7g}; dropped {dc} / {dh}")
    require(np.isfinite(lc) and np.isfinite(lh) and dc == dh == 0, "gate pose loss: non-finite or dropped entries")
    rtol = STEP_LPIPS_RTOL if loss_cfg["lpips"]["coeff"] > 0 else STEP_RTOL
    require(abs(lc - lh) <= rtol * abs(lh), f"gate pose loss: the card and the CPU differ by more than rtol {rtol:g}")
    rels = {}
    for k in gc:
        require(bool(torch.isfinite(gc[k]).all() and torch.isfinite(gh[k]).all()), f"gate pose: non-finite d{k}")
        rels[k] = float(torch.linalg.norm(gc[k] - gh[k]) / torch.clamp_min(torch.linalg.norm(gh[k]), 1e-30))
    print("  gate pose gradient, card against CPU, relative L2 difference: "
          + ", ".join(f"{k} {r:.3g} (|g| {float(torch.linalg.norm(gh[k])):.3g})" for k, r in rels.items()))
    require(all(r <= STEP_GRAD_REL for r in rels.values()), "gate pose gradient off by more than 5 % of its norm")
    return {"loss": [lc, lh], "grad_rel_l2": rels}


def pose_on_trained(trained, device="cuda"):
    """Phase 6b: POSE_STEPS pose-optimizer steps on the trained avatar from
    a perturbed pose towards the port's render of the packed frame, each
    train kernel once per step, nothing dropped, the best loss below the
    first; then the step timed."""
    from gomavatar_tpu_torch.cli.train_pose import (
        POSE_KEYS,
        PoseAdam,
        init_pose_carry,
        make_pose_optimizer,
        make_pose_step,
    )
    from gomavatar_tpu_torch.config import default_cfg
    from gomavatar_tpu_torch.models.lpips import load_lpips
    from gomavatar_tpu_torch.ops.skeleton import get_joints_from_pose
    from gomavatar_tpu_torch.ops.transforms import so3_exp
    from gomavatar_tpu_torch.scene import trained_train_cfg
    from gomavatar_tpu_torch.utils import profiling

    params, statics, cfg, frame = trained
    pose_true, joints = packed_pose(frame)
    rng = np.random.default_rng(0)
    pose0 = pose_true.copy()
    pose0[3:] += rng.normal(size=69).astype(np.float32) * POSE_NOISE
    batch = pose_batch(params, statics, cfg, frame, joints, frame)
    loss_cfg = trained_train_cfg()["train"]["losses"]
    pose_cfg = default_cfg()["pose"]
    lpips_params = load_lpips(device=device, quiet=True)[0]
    optimize = make_pose_optimizer(cfg, loss_cfg, pose_cfg, POSE_STEPS)
    start = torch.as_tensor(pose0, device=device)
    t_rec = time.perf_counter()
    with profiling.recording():
        (best, best_loss, losses, dropped), launches, _ = counted(
            lambda: clone_tree(optimize(params, statics, lpips_params, batch, start)))
    nhwc_calls = trunk_calls(t_rec)
    first_run = (best, best_loss, losses)
    losses, dropped = losses.cpu().numpy(), dropped.cpu().numpy()
    best_pose = best["poses"].cpu().numpy()
    err0 = float(np.abs(pose0[3:] - pose_true[3:]).mean())
    err1 = float(np.abs(best_pose[3:] - pose_true[3:]).mean())
    # the posed joints, the global transform applied, against the true pose's
    tj = torch.as_tensor(joints, device=device)
    true_j = get_joints_from_pose(torch.as_tensor(pose_true, device=device), tj)
    start_j = get_joints_from_pose(start, tj)
    best_j = get_joints_from_pose(best["poses"], tj) @ so3_exp(best["Rh"]).T + best["Th"]
    jerr0 = float(torch.linalg.norm(start_j - true_j, dim=-1).mean())
    jerr1 = float(torch.linalg.norm(best_j - true_j, dim=-1).mean())
    first, best_loss = float(losses[0]), float(best_loss)
    print(f"  {POSE_STEPS} pose steps at lr {pose_cfg['lr']:g} (halving every {pose_cfg['decay']}): loss {first:.6g} -> "
          f"best {best_loss:.6g} at step {int(np.argmin(losses))} (ratio {best_loss / first:.4f}); mean joint-angle "
          f"error {err0:.5f} -> {err1:.5f} rad, mean posed-joint error {jerr0 * 1e3:.3f} -> {jerr1 * 1e3:.3f} mm; "
          f"dropped {int(dropped.sum())}; launches {launches}")
    require(np.isfinite(losses).all() and all(bool(torch.isfinite(v).all()) for v in best.values()),
            "pose refinement: non-finite loss or pose")
    require(int(dropped.sum()) == 0, "pose refinement: the binning dropped entries")
    require(best_loss < first, "pose refinement: the best loss is not below the first")
    for k in TRAIN_KERNELS:
        require(launches[k] == POSE_STEPS, f"pose refinement did not launch {k} once per step")
    require(launches["lpips_head"] == 3 * POSE_STEPS, "pose refinement did not run the LPIPS head kernels per step")
    require(launches["B1a"] == launches["B1b"] == 0, "pose refinement launched the eval kernel")

    require(optimize.program.captures == 1, "pose refinement: the pose step was captured more than once")
    print(f"  lpips.trunk_nhwc counted {nhwc_calls} times (two trunks a call: the warm-up calls and the capture)")
    require(nhwc_calls >= 2, "pose refinement: the LPIPS trunk did not run channels-last")

    def eager_refine():
        """The same refinement with the pose step run eagerly: the carry."""
        tx = PoseAdam(pose_cfg)
        step, carry = make_pose_step(cfg, loss_cfg, tx), init_pose_carry(tx, start, POSE_STEPS)
        i_iter = torch.full((), 1e7, device=device)
        for _ in range(POSE_STEPS):
            step(params, statics, lpips_params, batch, carry, i_iter)
        return carry

    def same_refinement(best, best_loss, losses, other):
        o_best, o_loss, o_losses = other
        return (torch.equal(losses, o_losses) and torch.equal(best_loss, o_loss)
                and all(torch.equal(best[k], o_best[k]) for k in POSE_KEYS))

    # the captured refinement again from the same pose, and the eager one,
    # under torch's default algorithms
    c_best, c_loss, c_losses, _ = optimize(params, statics, lpips_params, batch, start)
    twice = same_refinement(c_best, c_loss, c_losses, first_run)
    e = eager_refine()
    same = same_refinement(c_best, c_loss, c_losses, (dict(zip(POSE_KEYS, e.best)), e.best_loss, e.losses))
    rel = float(((c_losses - e.losses).abs() / e.losses.abs()).max())
    print(f"  {POSE_STEPS} steps from the same pose again (default algorithms): losses and best pose "
          f"{'bit-equal' if twice else 'apart'} between two runs of the program, and "
          f"{'bit-equal' if same else 'apart'} to the eager steps' (worst loss rel {rel:.3g})")
    require(twice, "pose refinement: two runs of the pose program from one pose differ")
    require(same, "pose refinement: the captured steps differ from the eager ones")
    tx = PoseAdam(pose_cfg)
    step, carry = make_pose_step(cfg, loss_cfg, tx), init_pose_carry(tx, start, POSE_STEPS)
    i_dev = torch.full((), 1e7, device=device)
    scatters = scatter_ops("pose", lambda: step(params, statics, lpips_params, batch, carry, i_dev))

    # ms per step: POSE_STEPS steps with one synchronize at the end, each way
    per_step = {}
    for name, run in (("captured", lambda: optimize(params, statics, lpips_params, batch, start)),
                      ("eager", eager_refine)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        per_step[name] = (time.perf_counter() - t0) * 1e3 / POSE_STEPS
    mean_ms = per_step["captured"]
    one_step = make_pose_optimizer(cfg, loss_cfg, pose_cfg, 1)
    one_step(params, statics, lpips_params, batch, start)  # the capture
    single = []
    for _ in range(POSE_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(params, statics, lpips_params, batch, start)
        torch.cuda.synchronize()
        single.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(single)
    layout = no_layout_transposes("the captured pose step",
                                  lambda: one_step(params, statics, lpips_params, batch, start))
    print(f"  pose step: captured mean {mean_ms:.3f} ms over {POSE_STEPS} steps (one synchronize at the end), eager "
          f"{per_step['eager']:.3f} ms ({per_step['eager'] / mean_ms:.2f}x); captured median {med:.3f} ms of "
          f"{POSE_TIMED} synchronised one-step calls; per test frame at {PROTOCOL_STEPS} steps: captured "
          f"{mean_ms * PROTOCOL_STEPS / 1e3:.2f} s, eager {per_step['eager'] * PROTOCOL_STEPS / 1e3:.2f} s")
    return {"steps": POSE_STEPS, "first_loss": first, "best_loss": best_loss, "ratio": best_loss / first,
            "joint_err_rad": [err0, err1], "posed_joint_err_m": [jerr0, jerr1], "step_mean_ms": mean_ms,
            "step_median_ms": med, "seconds_per_frame_300": mean_ms * PROTOCOL_STEPS / 1e3,
            "eager_step_mean_ms": per_step["eager"],
            "eager_seconds_per_frame_300": per_step["eager"] * PROTOCOL_STEPS / 1e3,
            "bit_equal_default": same and twice, "scatter_ops": scatters, "launches": launches,
            "layout_transposes": layout, "lpips_trunk_nhwc": nhwc_calls}


def pose_yaml(cfg_path: str, it: int) -> str:
    """A copy of the drivers' exp yaml under its own experiment name, with
    CLI_POSE_ITERS pose steps at its pose.lr halving every CLI_POSE_DECAY,
    and checkpoint iter_{it} of the drivers' experiment copied into its
    checkpoints."""
    import shutil

    import yaml

    from gomavatar_tpu_torch.config import make_cfg

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["exp_name"] = "pose"
    cfg["pose"] = {"lr": float(make_cfg(cfg_path)["pose"]["lr"]), "decay": CLI_POSE_DECAY, "iters": CLI_POSE_ITERS}
    path = cfg_path.replace(".yaml", "_pose.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    src, dst = make_cfg(cfg_path)["save_dir"], make_cfg(path)["save_dir"]
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(f"{src}/checkpoints/iter_{it}", f"{dst}/checkpoints/iter_{it}")
    return path


def png_levels(paths, halves: int = 1):
    """Mean 8-bit level of each PNG (of each of its ``halves`` side by side)
    and the shapes."""
    from PIL import Image

    levels, shapes = [], []
    for p in paths:
        a = np.asarray(Image.open(p))
        shapes.append(a.shape)
        w = a.shape[1] // halves
        levels.append([float(a[:, i * w:(i + 1) * w].mean()) for i in range(halves)])
    return levels, shapes


def cli_pose(path: str, device="cuda"):
    """Phase 6c: cli.train_pose over the test capture from iter_6100, then
    cli.evaluate --type view with its refined poses."""
    from gomavatar_tpu_torch.cli import evaluate
    from gomavatar_tpu_torch.cli import train_pose
    from gomavatar_tpu_torch.config import make_cfg

    exp = make_cfg(path)
    result, launches, seconds = counted(lambda: train_pose.main(
        ["--cfg", path, "--max_frames", str(CLI_POSE_FRAMES), "--device", device]))
    n, iters = result["frames"], result["iters"]
    print(f"  cli.train_pose: {n} frames x {iters} steps in {seconds:.2f} s of wall time ({result['seconds']:.2f} s "
          f"refining); launches {launches}")
    for line in log_lines(f"{exp['save_dir']}/log_pose.txt", "frame ", "eval [", "saved refined"):
        print(f"    log: {line}")
    require(n == CLI_POSE_FRAMES and iters == CLI_POSE_ITERS, "cli.train_pose ran the wrong frames or steps")
    for k in TRAIN_KERNELS:
        require(launches[k] == n * iters, f"cli.train_pose did not launch {k} once per step")
    require(launches["B1a"] == launches["B1b"] == 3 * n, "cli.train_pose did not launch B1 once per evaluated frame")
    require(result["dropped"] == [0] * n, "cli.train_pose: the binning dropped entries")
    require(all(b < f for f, b in zip(result["first_loss"], result["best_loss"])),
            "cli.train_pose: a frame's best loss is not below its first")
    for tag, means in result["metrics"].items():
        require(means and all(np.isfinite(v) for v in means.values()), f"cli.train_pose: non-finite {tag} metrics")
    require(os.path.isfile(result["pose_path"]), "cli.train_pose wrote no pose.pkl")
    pngs = sorted(f for f in os.listdir(result["out_dir"]) if f.endswith(".png"))
    levels, _ = png_levels([f"{result['out_dir']}/{f}" for f in pngs])
    print(f"  cli.train_pose: {len(pngs)} PNGs, mean levels {', '.join(f'{v[0]:.2f}' for v in levels)}")
    require(len(pngs) == 3 * n and min(v[0] for v in levels) > 1.0, "cli.train_pose: missing or black PNGs")

    res, ev_launches, _ = counted(lambda: evaluate.main(
        ["--cfg", path, "--type", "view", "--pose_path", result["pose_path"], "--device", device]))
    used = log_lines(f"{exp['save_dir']}/log_eval_view.txt", "using refined poses")
    print(f"  cli.evaluate --type view --pose_path: {res['frames']} frames, metrics {res['metrics']}, launches "
          f"{ev_launches}; log: {used[-1] if used else 'no refined poses'}")
    require(used and res["dropped"] == 0, "cli.evaluate did not use the refined poses")
    require(ev_launches["B1a"] == ev_launches["B1b"] == res["frames"], "cli.evaluate did not launch B1 once per frame")
    return {"frames": n, "iters": iters, "seconds": seconds, "refine_seconds": result["seconds"],
            "first_loss": result["first_loss"], "best_loss": result["best_loss"], "metrics": result["metrics"],
            "launches": launches}


def cli_animate(path: str, device="cuda"):
    """Phase 6d: cli.animate over the trained avatar twice (freeview) and
    over two synthetic avatars (MDM motion), at DRIVER_IMG^2: B1a and B1b
    once per scene and frame, strips 2 x W wide with both halves not
    black."""
    from gomavatar_tpu_torch.cli import animate

    out = {}
    for kind, args, frames in (
        ("freeview", ["--cfgs"] + [path] * ANIM_SCENES + ["--type", "freeview"], ANIM_FRAMES),
        ("mdm", ["--synthetic", str(ANIM_SCENES), "--type", "mdm"], ANIM_MDM_FRAMES),
    ):
        out_dir = f"{DRIVER_DIR}/animate_{kind}"
        result, launches, seconds = counted(lambda: animate.main(
            args + ["--n_frames", str(frames), "--img", str(DRIVER_IMG), str(DRIVER_IMG), "--out", out_dir,
                    "--device", device]))
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        levels, shapes = png_levels([f"{out_dir}/{f}" for f in pngs], halves=ANIM_SCENES)
        fps = result["frames"] / result["seconds"]
        print(f"  cli.animate --type {kind}: {result['frames']} frames x {result['scenes']} scenes, {fps:.2f} frames/s "
              f"(the render loop with its PNG writes, {result['seconds']:.3f} s; {seconds:.2f} s with the set-up); "
              f"launches {launches}; PNG {shapes[0] if shapes else None}, half levels "
              + "; ".join(", ".join(f"{x:.2f}" for x in v) for v in levels))
        require(result["frames"] == frames and result["scenes"] == ANIM_SCENES, f"cli.animate {kind}: wrong run")
        require(launches["B1a"] == launches["B1b"] == ANIM_SCENES * frames,
                f"cli.animate {kind}: B1 did not launch once per scene and frame")
        require(all(launches[k] == 0 for k in TRAIN_KERNELS), f"cli.animate {kind}: a train kernel launched")
        require(len(pngs) == frames and all(s == (DRIVER_IMG, ANIM_SCENES * DRIVER_IMG, 3) for s in shapes),
                f"cli.animate {kind}: the strips are not {ANIM_SCENES} x {DRIVER_IMG} wide")
        require(min(min(v) for v in levels) > 1.0, f"cli.animate {kind}: a black scene in a strip")
        out[kind] = {"frames": frames, "scenes": ANIM_SCENES, "frames_per_s": fps, "seconds": seconds}
    return out


def phase_pose_animate(cfg_path: str, trained, device="cuda"):
    """Phase 6: pose refinement and animation on the card."""
    from gomavatar_tpu_torch.convert import trained_meta

    out = {}
    t0 = time.perf_counter()
    print("[6a] the gate scene's pose loss and its gradient in (Rh, Th, pose), card vs CPU")
    out["gate"] = pose_gradient_on_card(device)
    print(f"  phase 6a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[6b] {POSE_STEPS} pose-refinement steps on the trained avatar at 512^2 from a pose perturbed by "
          f"N(0, {POSE_NOISE}) rad")
    out["trained"] = pose_on_trained(trained, device)
    print(f"  phase 6b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[6c] cli.train_pose: {CLI_POSE_FRAMES} test frames x {CLI_POSE_ITERS} steps from iter_"
          f"{trained_meta()['iter']}, then cli.evaluate --pose_path")
    path = pose_yaml(cfg_path, int(trained_meta()["iter"]))
    out["cli"] = cli_pose(path, device)
    print(f"  phase 6c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[6d] cli.animate at {DRIVER_IMG}^2: the trained avatar twice (freeview) and two synthetic avatars (mdm)")
    animate = cli_animate(path, device)
    print(f"  phase 6d: {time.perf_counter() - t0:.1f} s")
    return out, animate


# ---- phase 7: the multi-rank layer ---------------------------------------------

# 7a: DP_STEPS data-parallel steps at world 1 (NCCL) against Trainer.step
# and the eager rank step, then DP_TIMED synchronised steps of the three in
# turns after TRAIN_WARMUP; 7b: DP2_STEPS steps at world 2 on frame pairs
# against the one-process mean-gradient step, then DP2_TIMED synchronised
# steps of the program and of the eager step on each rank after
# TRAIN_WARMUP; 7c: B1's shard splits in one process and the tile-parallel
# render's worlds, RANK_CALLS frames each, then RANK_TIMED frames of the
# program and of the eager render in turns; 7d: the multi-scene render's
# worlds, RANK_CALLS calls each
DP_STEPS, DP_TIMED, DP2_STEPS, DP2_TIMED = 5, 10, 3, 10
RANK_CALLS, RANK_TIMED = 2, 20
SHARD_SPLITS, TILE_WORLDS, SCENE_WORLDS = (2, 4, 8), (1, 2, 4), (1, 2)


def in_turns(ways: dict, iters: int) -> dict:
    """{way: ms of each of its ``iters`` synchronised calls}, the ways
    called in turns (``fn(i)`` in round i), so that all see the same host."""
    per_call = {k: [] for k in ways}
    torch.cuda.synchronize()
    for i in range(iters):
        for k, fn in ways.items():
            t0 = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            per_call[k].append((time.perf_counter() - t0) * 1e3)
    return per_call


def spread(ms: list) -> dict:
    return {"median_ms": statistics.median(ms), "p90_ms": statistics.quantiles(ms, n=10)[-1]}


def profiled_ms(fn) -> float:
    """The device ms of one call of ``fn()`` by torch.profiler over
    PROFILE_WINDOW calls (``profile_eval.measure``'s window)."""
    from gomavatar_tpu_torch.profile_eval import measure

    return measure(fn, 2, warmup=0, window=PROFILE_WINDOW)["device_ms"]


def leaves_equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def dp_batches(trained):
    """4c's batches: the three frames, each with the port's own render as
    its target."""
    params, statics, cfg, frame = trained
    return [train_batch(params, statics, cfg, f, f) for f in perturbed_frames(frame)]


def dp_pairs(steps: int):
    """The frames (batch indices) of each 2-rank step: rank r takes pair[r]."""
    return [(s % 3, (s + 1) % 3) for s in range(steps)]


def timed_steps(step, iters: int):
    """(ms of each synchronised ``step(i)``, wall seconds of all) over
    ``iters`` steps after TRAIN_WARMUP warm-up steps."""
    for i in range(TRAIN_WARMUP):
        step(i)
    torch.cuda.synchronize()
    per_step, t_all = [], time.perf_counter()
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + iters):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        per_step.append((time.perf_counter() - t0) * 1e3)
    return per_step, time.perf_counter() - t_all


def train_state(trainer):
    """Copies of a trainer's params, Adam moments and count."""
    from gomavatar_tpu_torch.optim import tree_leaves

    st = trainer.opt_state
    return ([p.clone() for p in tree_leaves(trainer.params)], [m.clone() for m in list(st.mu) + list(st.nu)],
            int(st.count))


def check_dp_losses(label, steps):
    for i, (total, losses) in enumerate(steps):
        terms = {k: float(v) for k, v in losses.items()}
        require(np.isfinite(float(total)) and all(np.isfinite(v) for v in terms.values()),
                f"{label} step {i}: non-finite loss")
        require(terms["bin_drop_budget"] + terms["bin_drop_buffer"] + terms["bin_drop_ncmax"] == 0,
                f"{label} step {i}: the binning dropped entries")


def dp_world1(trained, group, batches, i_iter, train_median, card):
    """Phase 7a: the data-parallel step at world 1 over NCCL, the rank's
    program, against Trainer.step and the eager rank step, bit for bit after
    every step, with its launches and all-reduces counted through the
    replays; then the three timed in turns."""
    from gomavatar_tpu_torch.optim import tree_leaves
    from gomavatar_tpu_torch.parallel import all_reduce_sum, make_data_parallel_train_step

    params, statics, cfg, _ = trained
    t0 = time.perf_counter()
    ref = make_trainer(params, statics, cfg, i_iter, "cuda")
    dp = make_trainer(params, statics, cfg, i_iter, "cuda", group)
    eager = make_data_parallel_train_step(group, dp.gom_cfg, dp.loss_cfg, dp.tx)
    p, o = clone_tree(dp.params), clone_tree(dp.opt_state)
    snaps = []

    def run():
        out = []
        for i in range(DP_STEPS):
            out.append(clone_tree(dp.step(batches[i % 3])))
            snaps.append(train_state(dp))
        return out

    calls = all_reduce_sum.calls
    steps, launches, _ = counted(run)
    reduces = all_reduce_sum.calls - calls
    for i in range(DP_STEPS):
        ref.step(batches[i % 3])
        st = train_state(ref)
        require(leaves_equal(st[0], snaps[i][0]) and leaves_equal(st[1], snaps[i][1]) and st[2] == snaps[i][2],
                f"7a step {i}: the world-1 data-parallel program differs from Trainer.step")
        p, o, total, _ = eager(p, o, dp.statics, dp.lpips_params, batches[i % 3],
                               torch.full((), float(i_iter + i), device="cuda"))
        same = (leaves_equal(tree_leaves(p), snaps[i][0])
                and leaves_equal(list(o.mu) + list(o.nu), snaps[i][1]) and int(o.count) == snaps[i][2])
        require(same and torch.equal(total, steps[i][0]),
                f"7a step {i}: the data-parallel program differs from the eager rank step")
    check_dp_losses("7a", steps)
    print(f"  {DP_STEPS} steps (default algorithms): params and Adam moments bit-equal to Trainer.step's and "
          f"to the eager rank step's after every step; launches {launches}; {reduces} all-reduces (the replays); "
          f"{dp._step_fn.captures} capture ({type(dp._step_fn).__name__}, one graph: {dp._step_fn.one_graph}; "
          f"{time.perf_counter() - t0:.1f} s)")
    for k in TRAIN_KERNELS:
        require(launches[k] == DP_STEPS, f"7a: {k} did not launch once per step")
    require(launches["B1a"] == launches["B1b"] == 0, "7a: the train step launched the eval kernel")
    require(reduces == DP_STEPS, "7a: not one all-reduce per step")
    require(dp._step_fn.captures == 1 and dp._step_fn.one_graph, "7a: not one captured graph in the phase")
    del snaps
    t0 = time.perf_counter()

    # the same three timed in turns, each step synchronised; then the
    # reducer alone
    i_dev = torch.full((), float(i_iter), device="cuda")
    ways = {
        "plain": lambda i: ref.step(batches[i % 3]),
        "captured": lambda i: dp.step(batches[i % 3]),
        # the eager rank step from the program's state, its result dropped
        "eager": lambda i: eager(dp.params, dp.opt_state, dp.statics, dp.lpips_params, batches[i % 3], i_dev),
    }
    in_turns(ways, TRAIN_WARMUP)
    per_step = in_turns(ways, DP_TIMED)
    print(f"  {DP_TIMED} steps of each in turns after {TRAIN_WARMUP} and the captures: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out = {"steps": DP_STEPS, "bit_equal": True, "launches": launches, "all_reduces": reduces,
           "captures": 1, "train_4d_median_ms": train_median}
    for k, fn in ways.items():
        m = spread(per_step[k])
        m["device_ms"] = profiled_ms(lambda: fn(0))
        m["busy_share"] = m["device_ms"] / m["median_ms"]
        out[k] = m
        print(f"  {k}: median {m['median_ms']:.3f} ms, p90 {m['p90_ms']:.3f} over {DP_TIMED} steps in turns; device "
              f"{m['device_ms']:.3f} ms, busy {100 * m['busy_share']:.1f} % (torch.profiler, {PROFILE_WINDOW} steps) "
              f"on {card}")
    print(f"  the profiles: {time.perf_counter() - t0:.1f} s")
    out["pool_mib"] = dp._step_fn.pool_bytes() / 2**20
    out["reducer_ms"] = reducer_ms(group, dp, batches[0], i_iter)
    cap, plain = out["captured"]["median_ms"], out["plain"]["median_ms"]
    print(f"  the captured data-parallel step {cap / plain:.3f}x Trainer.step's median (4d's {train_median:.3f} ms), "
          f"{out['eager']['median_ms'] / cap:.2f}x faster than the eager rank step; pool {out['pool_mib']:.1f} MiB; "
          f"the pack, all-reduce, divide and unpack alone {out['reducer_ms']:.3f} ms")
    out.update(median_ms=cap, plain_median_ms=plain, frames_per_s=1e3 / cap,
               eager_frames_per_s=1e3 / out["eager"]["median_ms"], vs_plain=cap / plain)
    return out


def reducer_ms(group, trainer, batch, i_iter) -> float:
    """The median host time of the data-parallel step's reducer (pack,
    all-reduce, divide, unpack) on one step's gradients and losses, each
    call synchronised."""
    from gomavatar_tpu_torch.parallel.step import mean_over_ranks
    from gomavatar_tpu_torch.trainer import loss_and_grads

    terms = loss_and_grads(trainer.params, trainer.statics, trainer.gom_cfg, trainer.loss_cfg, trainer.lpips_params,
                           batch, float(i_iter))
    reduce = mean_over_ranks(group)
    per_call = []
    for _ in range(DP_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(*terms)
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(per_call[1:])


def rank_dp(group, trained, batches, i_iter):
    """One rank of 7b: DP2_STEPS steps of the rank's program on its frame of
    each pair, each step's params copied to the CPU; then DP2_TIMED timed
    steps of the program and of the eager rank step."""
    from gomavatar_tpu_torch.optim import tree_leaves
    from gomavatar_tpu_torch.parallel import all_reduce_sum, make_data_parallel_train_step

    params, statics, cfg, _ = trained
    pairs = dp_pairs(DP2_STEPS)
    snaps = []
    timed = make_trainer(params, statics, cfg, i_iter, group.device, group)

    def run():
        out = []
        for pair in pairs:
            out.append(clone_tree(timed.step(batches[pair[group.rank]])))
            snaps.append([p.detach().cpu() for p in tree_leaves(timed.params)])
        return out

    calls = all_reduce_sum.calls
    steps, launches, _ = counted(run)
    reduces = all_reduce_sum.calls - calls
    check_dp_losses(f"7b rank {group.rank}", steps)
    captures, one_graph = timed._step_fn.captures, timed._step_fn.one_graph
    order = dp_pairs(DP2_TIMED + TRAIN_WARMUP)
    cap_ms, cap_wall = timed_steps(lambda i: timed.step(batches[order[i][group.rank]]), DP2_TIMED)
    eager = make_data_parallel_train_step(group, timed.gom_cfg, timed.loss_cfg, timed.tx)
    state = [timed.params, timed.opt_state]
    i_dev = torch.full((), float(i_iter), device=group.device)

    def eager_step(i):
        state[0], state[1], _, _ = eager(state[0], state[1], timed.statics, timed.lpips_params,
                                         batches[order[i][group.rank]], i_dev)

    eager_ms, eager_wall = timed_steps(eager_step, DP2_TIMED)
    return {"params": snaps, "launches": launches, "all_reduces": reduces, "captures": captures,
            "one_graph": one_graph, "totals": [float(t) for t, _ in steps],
            "captured": dict(spread(cap_ms), wall_s=cap_wall), "eager": dict(spread(eager_ms), wall_s=eager_wall),
            "pool_mib": timed._step_fn.pool_bytes() / 2**20}


def dp_reference(trained, batches, i_iter):
    """7b's one-process reference on the card: the mean-gradient step over
    each pair; the params after each step."""
    from gomavatar_tpu_torch.optim import tree_leaves
    from gomavatar_tpu_torch.parallel import make_mean_gradient_step

    params, statics, cfg, _ = trained
    ref = make_trainer(params, statics, cfg, i_iter, "cuda")
    step = make_mean_gradient_step(ref.gom_cfg, ref.loss_cfg, ref.tx)
    p, o, out = ref.params, ref.opt_state, []
    for s, pair in enumerate(dp_pairs(DP2_STEPS)):
        p, o, _, _ = step(p, o, ref.statics, ref.lpips_params, [batches[j] for j in pair], float(i_iter + s))
        out.append([x.cpu() for x in tree_leaves(p)])
    return out


def check_dp_ranks(label, ranks, reference, world1):
    """7b's checks on the ranks' results; returns its JSON record."""
    for s in range(DP2_STEPS):
        require(leaves_equal(ranks[0]["params"][s], ranks[1]["params"][s]), f"{label} step {s}: the replicas differ")
        require(leaves_equal(ranks[0]["params"][s], reference[s]),
                f"{label} step {s}: rank 0 differs from the one-process mean-gradient step")
    for r, res in enumerate(ranks):
        for k in TRAIN_KERNELS:
            require(res["launches"][k] == DP2_STEPS, f"{label} rank {r}: {k} did not launch once per step")
        require(res["all_reduces"] == DP2_STEPS, f"{label} rank {r}: not one all-reduce per step")
        require(res["captures"] == 1, f"{label} rank {r}: the program captured {res['captures']} times in one phase")
    launches = [{k: r["launches"][k] for k in TRAIN_KERNELS} for r in ranks]
    reduces = [r["all_reduces"] for r in ranks]
    forms = ["one graph" if r["one_graph"] else "two graphs around a host all-reduce" for r in ranks]
    print(f"  {DP2_STEPS} steps on frame pairs (default algorithms): both replicas bit-equal after every step, "
          f"rank 0 bit-equal to the one-process (g_a + g_b) / 2 step; launches per rank {launches}; all-reduces "
          f"{reduces} (per call); one capture per rank ({forms[0]}); pools "
          f"{', '.join('%.1f' % r['pool_mib'] for r in ranks)} MiB")
    out = {"steps": DP2_STEPS, "bit_equal": True, "launches": launches, "all_reduces": reduces, "form": forms[0],
           "pool_mib": [r["pool_mib"] for r in ranks]}
    for k in ("captured", "eager"):
        fps = 2 * DP2_TIMED / max(r[k]["wall_s"] for r in ranks)
        out[k] = {"median_ms": [r[k]["median_ms"] for r in ranks], "p90_ms": [r[k]["p90_ms"] for r in ranks],
                  "frames_per_s": fps, "vs_world1": fps / world1[f"{'eager_' if k == 'eager' else ''}frames_per_s"]}
        print(f"  {k}: step median per rank {', '.join('%.3f' % m for m in out[k]['median_ms'])} ms; the two ranks "
              f"{fps:.3f} frames/s over {DP2_TIMED} steps against 7a's {k} {fps / out[k]['vs_world1']:.3f} "
              f"({out[k]['vs_world1']:.2f}x)")
    out["frames_per_s"] = out["captured"]["frames_per_s"]
    return out


def eval_inputs(trained):
    from gomavatar_tpu_torch.models import modules as M
    from gomavatar_tpu_torch.models.gom import posed_vertices

    params, statics, cfg, frame = trained
    verts_obs = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
    return verts_obs, M.appearance_apply(params["appearance"])


def b1_shards(trained):
    """Phase 7c in one process: B1 on each rank's share of the slots for
    SHARD_SPLITS ranks, concatenated in rank order, bit-equal to the one-call
    sweep on every slot below n_active; each share against the plain
    version; each share timed."""
    from gomavatar_tpu_torch.ops import frame_render as FR
    from gomavatar_tpu_torch.parallel import shard_slots

    params, statics, cfg, frame = trained
    table, bins, _ = frame_inputs(params, statics, cfg, frame)
    entries = FR.gather_entries(table, bins)
    TX = bins.num_tiles_x
    whole = FR.frame_sweep(entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, TX)
    n = int(bins.n_active)
    out = {"n_active": n, "whole_ms": cuda_ms(lambda: FR.frame_sweep(entries, bins.active_id, bins.seg_start,
                                                                      bins.seg_count, bins.n_active, TX),
                                               KERNEL_ITERS)}
    for w in SHARD_SPLITS:
        shares = [shard_slots(bins, r, w) for r in range(w)]
        got = [FR.frame_sweep(entries, *sh, TX) for sh in shares]
        for i, name in enumerate(("rgb", "alpha", "sel")):
            require(torch.equal(torch.cat([g[i] for g in got])[:n], whole[i][:n]),
                    f"7c: the {w} shares' {name} differ from the one-call sweep")
        n_local = [int(sh[3]) for sh in shares]
        for r, (sh, g) in enumerate(zip(shares, got)):
            if n_local[r] == 0:
                continue
            p = FR.frame_sweep_plain(entries, *sh, TX)
            m = n_local[r]
            check_close(f"7c {w} shares, share {r} rgb vs plain", g[0][:m], p[0][:m])
            check_close(f"7c {w} shares, share {r} alpha vs plain", g[1][:m], p[1][:m])
            check_sel(f"7c {w} shares, share {r} sel vs plain", g[2][:m].permute(0, 2, 1), p[2][:m].permute(0, 2, 1))
        ms = [cuda_ms(lambda sh=sh: FR.frame_sweep(entries, *sh, TX), KERNEL_ITERS) for sh in shares]
        print(f"  {w} shares of {bins.active_id.shape[0]} slots, n_local {n_local} of n_active {n}: concatenated "
              f"bit-equal to the one-call sweep; B1 per share {', '.join(f'{x:.4f}' for x in ms)} ms against "
              f"{out['whole_ms']:.4f} ms for the whole")
        out[str(w)] = {"n_local": n_local, "ms": ms}
    return out


def rank_tile(group, trained):
    """One rank of 7c: RANK_CALLS frames of the tile-parallel render (the
    rank's program), its launches and all-gathers counted, against
    render_frame_eval in the same process; then the program and the eager
    render timed in turns."""
    from gomavatar_tpu_torch.models.gom import frame_table_and_bins, render_frame_eval
    from gomavatar_tpu_torch.parallel import all_gather_cat, make_tile_parallel_render, shard_slots

    params, statics, cfg, frame = trained
    verts_obs, colors = eval_inputs(trained)
    args = (params, verts_obs, colors, frame["K"], frame["E"])
    render = make_tile_parallel_render(group, cfg, statics)
    calls = all_gather_cat.calls
    frames, launches, _ = counted(lambda: [clone_tree(render(*args)) for _ in range(RANK_CALLS)])
    gathers = all_gather_cat.calls - calls
    want_rgb, want_alpha, _ = render_frame_eval(params, statics, cfg, *args[1:])
    _, bins, _ = frame_table_and_bins(params, statics, cfg, *args[1:])
    rgb, alpha, aux = frames[-1]
    tel = aux["binning"]
    ms = in_turns({"captured": lambda i: render(*args), "eager": lambda i: render.fn(*args)}, RANK_TIMED)
    return {"rgb": rgb.cpu() if group.rank == 0 else None, "alpha": alpha.cpu() if group.rank == 0 else None,
            "equal": all(bool(torch.equal(f[0], want_rgb) and torch.equal(f[1], want_alpha)) for f in frames),
            "n_active": int(bins.n_active), "n_local": int(shard_slots(bins, group.rank, group.world)[3]),
            "dropped": int(tel.total_dropped()), "tile_overflow": int(aux["tile_overflow"]),
            "launches": {k: launches[k] for k in ("B1a", "B1b")}, "gathers": gathers, "captures": render.captures,
            "one_graph": render.one_graph, "captured": spread(ms["captured"]), "eager": spread(ms["eager"]),
            "pool_mib": render.pool_bytes() / 2**20}


def check_tile(label, world, ranks, want, forward_median=None):
    """7c's checks on one world's ranks against the parent's
    render_frame_eval (``want`` = (rgb, alpha)); ``forward_median`` phase
    3's captured eval frame, printed beside world 1's."""
    require(bool(torch.equal(ranks[0]["rgb"], want[0].cpu()) and torch.equal(ranks[0]["alpha"], want[1].cpu())),
            f"{label}: rank 0's frame differs from render_frame_eval")
    for r, res in enumerate(ranks):
        require(res["equal"], f"{label} rank {r}: a frame differs from render_frame_eval")
        require(res["dropped"] == 0 and res["tile_overflow"] == 0, f"{label} rank {r}: dropped entries")
        require(res["launches"]["B1a"] == res["launches"]["B1b"] == RANK_CALLS,
                f"{label} rank {r}: B1 not once per frame")
        require(res["gathers"] == RANK_CALLS, f"{label} rank {r}: not one all-gather per frame")
        require(res["captures"] == 1, f"{label} rank {r}: the render captured {res['captures']} times")
    n_local = [r["n_local"] for r in ranks]
    empty = [r for r, x in enumerate(n_local) if x == 0]
    idle = f"ranks {empty} hold no active slot" if empty else "every rank holds active slots"
    form = "one graph" if ranks[0]["one_graph"] else "two graphs around a host all-gather"
    print(f"  world {world} ({form}): {RANK_CALLS} frames, rgb and alpha bit-equal to render_frame_eval on every "
          f"rank; n_active {ranks[0]['n_active']}, n_local {n_local} ({idle}); 0 dropped, 0 tile_overflow; B1a and "
          f"B1b once per rank and frame, one all-gather per frame, one capture")
    out = {"n_active": ranks[0]["n_active"], "n_local": n_local, "bit_equal": True, "form": form,
           "launches": [r["launches"] for r in ranks], "gathers": [r["gathers"] for r in ranks],
           "pool_mib": [r["pool_mib"] for r in ranks]}
    for k in ("captured", "eager"):
        out[k] = {x: [r[k][x] for r in ranks] for x in ("median_ms", "p90_ms")}
        print(f"  {k}: frame median per rank {', '.join('%.3f' % m for m in out[k]['median_ms'])} ms, p90 "
              f"{', '.join('%.3f' % m for m in out[k]['p90_ms'])} over {RANK_TIMED} frames in turns")
    if forward_median is not None:
        out["vs_forward"] = out["captured"]["median_ms"][0] / forward_median
        print(f"  the captured tile-parallel frame {out['vs_forward']:.3f}x phase 3's captured eval frame "
              f"({forward_median:.3f} ms)")
    return out


def two_scenes(trained):
    """(packs, items) of 7d: the trained avatar and a copy with its per-face
    colours' channels reversed, both at the trained frame."""
    from gomavatar_tpu_torch.convert import FRAME_KEYS

    params, statics, cfg, frame = trained
    other = dict(params, appearance={"colors": params["appearance"]["colors"].flip(-1).contiguous()})
    item = {k: frame[k].cpu().numpy() for k in FRAME_KEYS}
    return [(params, statics, cfg), (other, statics, cfg)], [item, item]


def rank_scenes(group, trained):
    """One rank of 7d: RANK_CALLS calls of the multi-scene render of the two
    scenes, launches and all-gathers counted; the gathered frames on rank
    0."""
    from gomavatar_tpu_torch.parallel import all_gather_cat, make_multi_scene_render

    packs, items = two_scenes(trained)
    render = make_multi_scene_render(group)
    calls = all_gather_cat.calls
    outs, launches, _ = counted(lambda: [clone_tree(render(packs, items)) for _ in range(RANK_CALLS)])
    return {"rgb": [rgb.cpu() for rgb, _ in outs] if group.rank == 0 else None,
            "launches": {k: launches[k] for k in ("B1a", "B1b")}, "gathers": all_gather_cat.calls - calls}


def check_scenes(label, world, ranks, want):
    """7d's checks: every scene, in order, bit-equal to its own gom_forward,
    on every call."""
    for rgb in ranks[0]["rgb"]:
        require(rgb.shape[0] == len(want), f"{label}: {rgb.shape[0]} scenes gathered, {len(want)} expected")
        for s, w in enumerate(want):
            require(bool(torch.equal(rgb[s], w.cpu())), f"{label}: scene {s} differs from its own gom_forward")
    per = len(want) // world
    for r, res in enumerate(ranks):
        require(res["launches"]["B1a"] == res["launches"]["B1b"] == per * RANK_CALLS,
                f"{label} rank {r}: B1 not once per scene")
        require(res["gathers"] == 2 * RANK_CALLS, f"{label} rank {r}: not one all-gather per output and call")
    print(f"  world {world}: {RANK_CALLS} calls, {len(want)} scenes gathered in order, each bit-equal to its own "
          f"gom_forward(train=False) on every call (each scene through its eval program); B1a and B1b {per} per "
          f"rank and call; 2 all-gathers per call")
    return {"scenes": len(want), "calls": RANK_CALLS, "bit_equal": True,
            "launches": [r["launches"] for r in ranks], "gathers": [r["gathers"] for r in ranks]}


def parallel_rank(group, jobs):
    """A rank of phase 7's spawned worlds on the card: the trained avatar
    loaded on its device, then each of ``jobs`` ("dp", "tile", "scenes")."""
    from gomavatar_tpu_torch.convert import load_trained, trained_meta

    t0 = time.perf_counter()
    trained = load_trained(device=group.device)
    out = {"seconds": {"load": time.perf_counter() - t0}}
    for job, run in (("dp", lambda: rank_dp(group, trained, dp_batches(trained), int(trained_meta()["iter"]))),
                     ("tile", lambda: rank_tile(group, trained)), ("scenes", lambda: rank_scenes(group, trained))):
        if job in jobs:
            t0 = time.perf_counter()
            out[job] = run()
            out["seconds"][job] = time.perf_counter() - t0
    return out


def exp_copy(cfg_path: str, it: int, name: str, **train) -> str:
    """A copy of the drivers' exp yaml as experiment ``name``, its train
    section updated by ``train``, with checkpoint iter_{it} of the drivers'
    experiment copied into its checkpoints."""
    import shutil

    import yaml

    from gomavatar_tpu_torch.config import make_cfg

    with open(cfg_path) as f:
        cfg = yaml.safe_load(f)
    cfg["exp_name"] = name
    cfg["train"].update(train)
    path = cfg_path.replace(".yaml", f"_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    src, dst = make_cfg(cfg_path)["save_dir"], make_cfg(path)["save_dir"]
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(f"{src}/checkpoints/iter_{it}", f"{dst}/checkpoints/iter_{it}")
    return path


def phase_parallel(trained, train_median, forward_median, cfg_path: str, card):
    """Phase 7: the multi-rank layer on the card."""
    import tempfile

    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.models.gom import render_frame_eval
    from gomavatar_tpu_torch.parallel import close_group, init_group, spawn

    params, statics, cfg, frame = trained
    i_iter = int(trained_meta()["iter"])
    batches = dp_batches(trained)
    verts_obs, colors = eval_inputs(trained)
    want_frame = render_frame_eval(params, statics, cfg, verts_obs, colors, frame["K"], frame["E"])[:2]
    packs, _ = two_scenes(trained)
    want_scenes = [forward(p, s, c, frame)[0] for p, s, c in packs]
    require(float((want_scenes[0] - want_scenes[1]).abs().max()) > 0.1, "7d: the two scenes render alike")
    out = {}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        group = init_group(0, 1, f"{tmp}/store", "cuda:0", "nccl")
        print(f"[7a] the data-parallel step at world 1 over {group.backend}: {DP_STEPS} steps on the trained avatar "
              f"against Trainer.step")
        out["7a"] = dp_world1(trained, group, batches, i_iter, train_median, card)
        print(f"  phase 7a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        print("[7c] the tile-parallel render: B1 on shares of the slots, then worlds "
              f"{list(TILE_WORLDS)} (world 1 over nccl, the others over gloo on the one card)")
        out["7c"] = {"shares": b1_shards(trained)}
        out["7c"]["1"] = check_tile("7c world 1", 1, [rank_tile(group, trained)], want_frame, forward_median)
        print("[7d] the multi-scene render: the trained avatar and a recoloured copy, worlds "
              f"{list(SCENE_WORLDS)} (world 1 over nccl)")
        out["7d"] = {"1": check_scenes("7d world 1", 1, [rank_scenes(group, trained)], want_scenes)}
        close_group(group)
    print(f"  phases 7c-7d at world 1: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("[7b-7d] world 2 on the one card over gloo: the data-parallel step, the tile-parallel render, the "
          "multi-scene render")
    two = spawn(parallel_rank, ["cuda:0"] * 2, ("dp", "tile", "scenes"), backend="gloo")
    reference = dp_reference(trained, batches, i_iter)
    out["7b"] = check_dp_ranks("7b", [r["dp"] for r in two], reference, out["7a"])
    out["7c"]["2"] = check_tile("7c world 2", 2, [r["tile"] for r in two], want_frame)
    out["7d"]["2"] = check_scenes("7d world 2", 2, [r["scenes"] for r in two], want_scenes)
    print(f"  world 2: {time.perf_counter() - t0:.1f} s with the ranks' start; rank 0 "
          + ", ".join(f"{k} {v:.1f} s" for k, v in two[0]["seconds"].items()))
    t0 = time.perf_counter()
    print("[7c] world 4 on the one card over gloo: the tile-parallel render")
    four = spawn(parallel_rank, ["cuda:0"] * 4, ("tile",), backend="gloo")
    out["7c"]["4"] = check_tile("7c world 4", 4, [r["tile"] for r in four], want_frame)
    print(f"  world 4: {time.perf_counter() - t0:.1f} s with the ranks' start; rank 0 "
          + ", ".join(f"{k} {v:.1f} s" for k, v in four[0]["seconds"].items()))

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[7e] not run: {cards} card (7a-7d over 2 cards with NCCL and cli.train --data_parallel 2 need 2)")
        out["7e"] = {"ran": False, "cards": cards}
    else:
        from gomavatar_tpu_torch.cli import train as train_cli

        print("[7e] 2 cards over nccl: the data-parallel step, the tile-parallel render, the multi-scene render, "
              "cli.train --data_parallel 2")
        devices = [torch.device("cuda", i) for i in range(2)]
        two_cards = spawn(parallel_rank, devices, ("dp", "tile", "scenes"))
        e = {"ran": True, "cards": cards}
        e["dp"] = check_dp_ranks("7e", [r["dp"] for r in two_cards], reference, out["7a"])
        e["tile"] = check_tile("7e tile", 2, [r["tile"] for r in two_cards], want_frame)
        e["scenes"] = check_scenes("7e scenes", 2, [r["scenes"] for r in two_cards], want_scenes)
        path = exp_copy(cfg_path, i_iter, "data_parallel")
        ranks = train_cli.main(["--cfg", path, "--resume", "--max_iters", str(i_iter + 2), "--data_parallel", "2"])
        require([r["i_iter"] for r in ranks] == [i_iter + 2] * 2, "7e: cli.train --data_parallel 2 ended elsewhere")
        from gomavatar_tpu_torch.config import make_cfg

        require(os.path.isdir(f"{make_cfg(path)['save_dir']}/checkpoints/iter_{i_iter + 2}"),
                "7e: cli.train --data_parallel 2 wrote no checkpoint")
        print(f"  cli.train --data_parallel 2: 2 steps from iter_{i_iter} on 2 cards, iter_{i_iter + 2} written")
        out["7e"] = e
    print(f"  phase 7e: {time.perf_counter() - t0:.1f} s")

    # B1's and B2-B5's launches on phase 7's paths, per rank
    out["launches"] = {
        "7a": {k: out["7a"]["launches"][k] for k in TRAIN_KERNELS},
        "7b": out["7b"]["launches"],
        "7c": {w: out["7c"][w]["launches"] for w in ("1", "2", "4")},
        "7d": {w: out["7d"][w]["launches"] for w in ("1", "2")},
    }
    return out


def parallel_launches(k: str, launches: dict) -> dict:
    """Kernel ``k``'s launches on phase 7's paths (its parts' sum), per rank
    where a path runs on several."""
    parts = [k] if k == "B5" else [f"{k}a", f"{k}b"]

    def total(counts):
        return sum(counts.get(p, 0) for p in parts)

    if k == "B1":
        return {f"{path} world {w}": [total(c) for c in launches[path][w]] for path in ("7c", "7d")
                for w in launches[path]}
    return {"7a world 1": total(launches["7a"]), "7b world 2": [total(c) for c in launches["7b"]]}


# ---- phase 8: the end-to-end demonstration chain -------------------------------

# 8b: run_e2e at 512^2 at full width (the capture's 14,400-face body, 57,600
# faces after the split) on a short schedule: E2E_FRAMES train and
# E2E_TEST_FRAMES test frames, E2E_ITERS iterations with the subdivision at
# E2E_SUBDIV, both kick-ins at E2E_KICK and the non-rigid full band at
# E2E_BAND, the resume E2E_RESUME more, a periodic eval every E2E_EVAL_FREQ,
# the yaml's test-split skip of 4 (one frame of E2E_TEST_FRAMES), the raw
# capture's frame from both novel views, freeview and MDM on E2E_CLIP
# frames, train_pose on E2E_POSE_FRAMES frame of E2E_POSE_ITERS steps, the
# control off
E2E_FRAMES, E2E_TEST_FRAMES, E2E_ITERS, E2E_SUBDIV, E2E_KICK, E2E_BAND = 6, 4, 40, 21, 25, 35
E2E_RESUME, E2E_EVAL_FREQ, E2E_CLIP, E2E_POSE_FRAMES, E2E_POSE_ITERS = 5, 20, 2, 1, 10
# the capture's body (make_e2e_data's default)
E2E_BODY = (144, 48)
E2E_CUTS = (f"cut from configs/exps/e2e_synthetic.yaml: {E2E_FRAMES} train / {E2E_TEST_FRAMES} test frames (of 100 / "
            f"24), {E2E_ITERS} iterations (of 6,000), the subdivision at {E2E_SUBDIV} (1,001), the kick-ins at "
            f"{E2E_KICK} and the full band at {E2E_BAND} (2,000, 3,000 / 4,000), the resume +{E2E_RESUME} (+100), a "
            f"periodic eval every {E2E_EVAL_FREQ} (1,000), freeview and MDM on {E2E_CLIP} frames (30, 6), train_pose "
            f"{E2E_POSE_FRAMES} frame x {E2E_POSE_ITERS} steps (6 x 300), the control off; widths, faces and 512^2 "
            f"kept")
E2E_DIR = "build/smoke_e2e"  # under the checkout, gitignored
# the exported avatar's render against evaluate's PNG of the same frame:
# equal 8-bit levels on >= 99.9 % of values, none more than 1 apart
E2E_PNG_FRAC = 0.999


def e2e_yaml(root: str) -> str:
    """configs/exps/e2e_synthetic.yaml with E2E_CUTS applied, its capture
    and logs under ``root``; returns its path."""
    import shutil

    import yaml

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    with open("configs/exps/e2e_synthetic.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["log_dir"] = f"{root}/log"
    for d in cfg["dataset"].values():
        for k in ("dataset_path", "raw_dataset_path", "pose_path"):
            if k in d:
                d[k] = d[k].replace("data/e2e", f"{root}/data", 1)
    cfg["dataset"]["test_pose"]["skip"] = 1
    m = cfg["model"]
    m["subdivide_iters"] = [E2E_SUBDIV]
    m["pose_refinement"]["kick_in_iter"] = E2E_KICK
    m["non_rigid"]["kick_in_iter"] = E2E_KICK
    m["non_rigid"]["full_band_iter"] = E2E_BAND
    cfg["pose"]["iters"] = E2E_POSE_ITERS
    cfg["pose"]["decay"] = E2E_POSE_ITERS // 2
    cfg["train"].update(total_iters=E2E_ITERS, log_freq=1, eval_freq=E2E_EVAL_FREQ, save_freq=E2E_EVAL_FREQ)
    path = f"{root}/e2e_smoke.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def e2e_export_render(art: str, save_dir: str, bgcolor, device="cuda"):
    """Phase 8b: the exported avatar read back by ``convert.load_trained``
    and its packed frame rendered, against the PNG ``cli.evaluate --type
    train`` wrote for the same frame."""
    from PIL import Image

    from gomavatar_tpu_torch.convert import load_trained, trained_meta
    from gomavatar_tpu_torch.eval_lib import to_8b_image
    from gomavatar_tpu_torch.losses import unpack
    from gomavatar_tpu_torch.models.gom import gom_forward

    meta = trained_meta(art)
    params, statics, cfg, frame = load_trained(art, device)
    with torch.no_grad():
        rgb, mask, aux = gom_forward(params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"], frame["dst_Rs"],
                                     frame["dst_Ts"], dst_posevec=frame["dst_posevec"], i_iter=float(meta["iter"]),
                                     device=device)
    bg = torch.as_tensor(np.asarray(bgcolor, np.float32) / 255.0, device=device)
    got = to_8b_image(unpack(rgb, mask, bg, clamp=True).cpu().numpy()).astype(np.int32)
    want = np.asarray(Image.open(f"{save_dir}/eval/train/frame_000000.png")).astype(np.int32)
    d = np.abs(got - want)
    same = float((d == 0).mean())
    print(f"  export: {art} (iter {meta['iter']}, phase {meta['phase']}, {cfg.num_faces} faces) reloaded by "
          f"load_trained; its frame against evaluate's frame_000000.png: {same * 100:.4f} % of values equal, worst "
          f"{int(d.max())} levels")
    require(int(aux["binning"].total_dropped()) + int(aux["tile_overflow"]) == 0, "export: the render dropped entries")
    require(same >= E2E_PNG_FRAC and int(d.max()) <= 1, "export: the reloaded avatar renders another frame")
    return {"equal_frac": same, "worst": int(d.max())}


def e2e_window_b1(data_dir: str, img, device="cuda"):
    """Phase 8c: B1 at the 544^2 windows of the raw capture's 2x frames,
    the teacher's first raw frame from novel view 1 as ``make_e2e_data``
    renders it, its four windows through the eval forward (launches
    counted), then the busiest window's entries through B1 and its plain
    version (``compare_b1``)."""
    import pickle

    from gomavatar_tpu_torch.data.dataset import get_canonical_global_tfms_np
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.tools import make_e2e_data as D

    params, statics, gom_cfg = D.teacher_model(synthetic_body(*E2E_BODY), img=img, device=device)
    with open(f"{data_dir}/train/mesh_infos.pkl", "rb") as f:
        mesh_infos = pickle.load(f)
    names = D.raw_pose_names(mesh_infos)
    mi = mesh_infos[names[0]]
    K, Es, frame_hw = D.raw_cameras(img)
    E, Rs, Ts, posevec = D.raw_frame_inputs(mi, Es[1])
    cnl = get_canonical_global_tfms_np(np.asarray(mesh_infos[names[0]]["tpose_joints"], np.float32))
    window, quads = D.quadrant_windows(K, frame_hw)
    cfg2 = D.window_cfg(gom_cfg, window)

    def on_card(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    frames = [{"K": on_card(Kq), "E": on_card(E), "cnl_gtfms": on_card(cnl), "dst_Rs": on_card(Rs),
               "dst_Ts": on_card(Ts), "dst_posevec": on_card(posevec)} for Kq, *_ in quads]
    outs, launches, seconds = counted(lambda: [forward(params, statics, cfg2, f, device) for f in frames])
    W, H = cfg2.img_size
    for (_, origin, _), (rgb, mask, aux) in zip(quads, outs):
        dropped = int(aux["binning"].total_dropped()) + int(aux["tile_overflow"])
        print(f"  window at {origin}: rgb {tuple(rgb.shape)} mean {float(rgb.mean()):.4f}, mask mean "
              f"{float(mask.mean()):.4f}, dropped {dropped}")
        require(rgb.shape == (H, W, 3) and mask.shape == (H, W), "8c: wrong window shape")
        require(bool(torch.isfinite(rgb).all() and torch.isfinite(mask).all()), "8c: non-finite window")
        require(dropped == 0, "8c: a window dropped entries")
    print(f"  the four windows: {seconds:.2f} s; launches {launches}")
    require(launches["B1a"] == launches["B1b"] == len(quads), "8c: B1 not launched once per window")

    with torch.no_grad():
        inputs = [frame_inputs(params, statics, cfg2, f)[:2] for f in frames]
    # the highest active tile id of each window: ids from 1,024 on set the
    # sign bit of the sort key's tile field (ROADMAP C)
    top = [int(b.active_id[:int(b.n_active)].max()) if int(b.n_active) else -1 for _, b in inputs]
    for (_, origin, _), (_, b), t in zip(quads, inputs, top):
        print(f"  window at {origin}: {int(b.n_active)} active tiles, the highest id {t}")
    # the busiest window among those with a tile id past 1,023
    i = max(range(len(inputs)), key=lambda j: (top[j] >= 1024, int(inputs[j][1].n_active)))
    table, bins = inputs[i]
    tiles = bins.num_tiles_x * bins.num_tiles_y
    print(f"  window at {quads[i][1]}: {tiles} tiles, {int(bins.n_active)} active of the cap {cfg2.active_tile_cap}, "
          f"budget {cfg2.max_tiles_per_gaussian} tiles a splat, band0 {cfg2.binning_band0}")
    require(tiles == 34 * 34, "8c: the window is not 1,156 tiles")
    worst, timed = compare_b1(f"raw window {W}x{H}", table, bins, cfg2.img_size)
    return {"window": [W, H], "tiles": tiles, "n_active": int(bins.n_active), "top_tile": top[i],
            "max_abs_err": worst, "ms": timed["ms"], "plain_ms": timed["plain_ms"], "seconds": seconds,
            "launches": launches}


def e2e_drops(res) -> dict:
    """run_e2e's drop counters: the logged train steps', each evaluation's
    and the pose refinement's."""
    return {"train_steps": res["report"]["drops"], "pose": res["pose"]["dropped"],
            **{tag: r["dropped"] for tag, r in res["evals"].items()}}


def e2e_again(res, art, cfg_path, device="cuda") -> dict:
    """Phase 8b's chain run a second time in the same process, from the
    same capture (its datagen skipped) into logs and an export of its own:
    the exported params bit-equal to the first run's and every drop counter
    equal."""
    from gomavatar_tpu_torch.tools import run_e2e

    art2 = f"{E2E_DIR}/e2e_trained_again.npz"
    print("  run_e2e again from the same capture and yaml, its logs and export apart")
    res2, _, seconds = counted(lambda: run_e2e.main([
        "--cfg", cfg_path, "--log_dir", f"{E2E_DIR}/log_again", "--data", f"{E2E_DIR}/data", "--art", art2,
        "--resume_iters", str(E2E_ITERS + E2E_RESUME), "--freeview_frames", str(E2E_CLIP),
        "--pose_frames", str(E2E_POSE_FRAMES), "--control", "0", "--device", device]))
    a, b = np.load(art), np.load(art2)
    keys = [k for k in a.files if k.startswith("params/")]
    differing = {k: int((a[k] != b[k]).sum()) for k in keys if not np.array_equal(a[k], b[k])}
    drops, drops2 = e2e_drops(res), e2e_drops(res2)
    print(f"  the second chain: {seconds:.2f} s; its exported params against the first's: "
          f"{'all ' + str(len(keys)) + ' arrays bit-equal' if not differing else differing}; drop counters "
          f"{drops2} (first run {drops})")
    require(set(b.files) >= set(keys) and not differing, "8b: two runs of the chain export different params")
    require(drops == drops2, "8b: two runs of the chain drop different entries")
    return {"seconds": seconds, "params_arrays": len(keys), "params_differing": differing, "drops": drops2}


def phase_e2e(device="cuda"):
    """Phase 8: the end-to-end demonstration chain on the card: 8a the
    learning check at its defaults, 8b ``run_e2e`` on a short schedule."""
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.tools import make_e2e_report, overfit_check, run_e2e

    out = {}
    t0 = time.perf_counter()
    print("[8a] overfit_check at its defaults (128^2, 400 steps), +5 dB required")
    r, launches, seconds = counted(lambda: overfit_check.main(["--device", device]))
    print(f"  overfit_check: PSNR {r['psnr_before']:.4f} -> {r['psnr_after']:.4f} dB after {r['iters']} steps "
          f"({r['it_per_s']:.2f} it/s), {seconds:.2f} s; launches {launches}")
    require(r["psnr_after"] > r["psnr_before"] + 5.0, "overfit_check: less than +5 dB")
    for k in TRAIN_KERNELS:
        require(launches[k] == r["iters"], f"overfit_check did not launch {k} once per step")
    # the two targets' masks and the PSNR before and after, per frame
    require(launches["B1a"] == launches["B1b"] == 6, "overfit_check did not launch B1 once per render")
    out["8a"] = dict(r, seconds=seconds, launches=launches)
    print(f"  phase 8a: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print(f"[8b] {E2E_CUTS}")
    print("  run_e2e at 512^2: datagen, train, resume, the five evaluations, the noisy chain, export, report")
    cfg_path = e2e_yaml(E2E_DIR)
    art = f"{E2E_DIR}/e2e_trained.npz"
    res, launches, seconds = counted(lambda: run_e2e.main([
        "--cfg", cfg_path, "--data", f"{E2E_DIR}/data", "--art", art, "--resume_iters", str(E2E_ITERS + E2E_RESUME),
        "--freeview_frames", str(E2E_CLIP), "--pose_frames", str(E2E_POSE_FRAMES), "--control", "0",
        "--datagen_args", f"--frames {E2E_FRAMES} --test_frames {E2E_TEST_FRAMES} --mdm_frames {E2E_CLIP} "
        f"--rings {E2E_BODY[0]} --segs {E2E_BODY[1]}",
        "--device", device]))
    cfg = make_cfg(cfg_path)
    gen, rep = res["datagen"], res["report"]
    print(f"  run_e2e: {seconds:.2f} s of wall time; launches {launches}")
    print("  stages (s): " + ", ".join(f"{k} {v:.2f}" for k, v in res["seconds"].items()))
    print(f"  datagen: {gen['train']} train, {gen['test']} test, {gen['zju_raw']} raw frames (four 544^2 windows "
          f"each), none dropped (it raises on a drop); decode of the train split {res['decode']['items_per_s']:.2f} items/s "
          f"({res['decode']['path']})")
    print(f"  train: {res['train']}; resume: {res['resume']}; events "
          f"{[(k, it, info) for k, it, info in rep['events']]}; drops over {rep['iters']} logged steps {rep['drops']}")
    for tag, r in res["evals"].items():
        print(f"  evaluate {tag}: {r['frames']} frames, dropped {r['dropped']}, metrics "
              f"{ {k: round(v, 4) for k, v in r['metrics'].items()} }")
    print(f"  train_pose: {res['pose']['frames']} frame x {res['pose']['iters']} steps, dropped "
          f"{res['pose']['dropped']}, metrics {res['pose']['metrics']}")

    base = len(synthetic_body(*E2E_BODY)["faces"])  # 14,400
    require(rep["drops"] == 0, "run_e2e: the binning dropped entries in a train step")
    require(rep["iters"] == E2E_ITERS + E2E_RESUME, "run_e2e: not every step was logged")
    require(("subdivide", E2E_SUBDIV, f"{base} -> {4 * base} faces") in rep["events"],
            "run_e2e: the faces did not go x4 at the split")
    require(res["train"] == {"i_iter": E2E_ITERS, "phase": 1, "num_faces": 4 * base}
            and res["resume"] == {"i_iter": E2E_ITERS + E2E_RESUME, "phase": 1, "num_faces": 4 * base},
            "run_e2e: wrong iteration, phase or face count after train or resume")
    for tag, r in res["evals"].items():
        require(r["dropped"] == 0 and r["num_faces"] == 4 * base, f"run_e2e: evaluate {tag} dropped or lost faces")
        if tag not in ("freeview", "pose_mdm"):
            require(r["metrics"] and all(np.isfinite(v) for v in r["metrics"].values()),
                    f"run_e2e: non-finite {tag} metrics")
    require(res["pose"]["dropped"] == [0] * E2E_POSE_FRAMES, "run_e2e: train_pose dropped entries")

    steps = E2E_ITERS + E2E_RESUME + E2E_POSE_FRAMES * E2E_POSE_ITERS
    _, events = make_e2e_report.parse_train_log(f"{cfg['save_dir']}/log.txt")
    periodic = sum(kind == "eval:test_on_train" for kind, *_ in events)
    require(periodic == E2E_ITERS // E2E_EVAL_FREQ, f"run_e2e: {periodic} periodic evals")
    train_items = E2E_FRAMES - E2E_FRAMES // 5
    b1 = (gen["train"] + gen["test"] + 4 * gen["zju_raw"]
          + periodic * (min(4, train_items) + min(8, -(-E2E_TEST_FRAMES // cfg["dataset"]["test_view"]["skip"])))
          + sum(r["frames"] for r in res["evals"].values()) + 3 * E2E_POSE_FRAMES)
    for k in TRAIN_KERNELS:
        require(launches[k] == steps, f"run_e2e: {k} launched {launches[k]} times for {steps} train and pose steps")
    require(launches["B1a"] == launches["B1b"] == b1, f"run_e2e: B1 launched {launches['B1a']} times for {b1} renders")
    out["8b"] = {"seconds": seconds, "stages": res["seconds"], "decode": res["decode"], "launches": launches,
                 "metrics": {tag: r["metrics"] for tag, r in res["evals"].items()}, "pose": res["pose"]["metrics"],
                 "export": e2e_export_render(art, cfg["save_dir"], cfg["bgcolor"], device)}
    out["8b"]["again"] = e2e_again(res, art, cfg_path, device)
    print(f"  phase 8b: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("[8c] B1 at the raw capture's 544^2 windows: the teacher's raw frame, B1 vs its plain version")
    out["8c"] = e2e_window_b1(f"{E2E_DIR}/data", tuple(cfg["img_size"]), device)
    print(f"  phase 8c: {time.perf_counter() - t0:.1f} s")
    return out


# ---- phase 9: the seeded draws ---------------------------------------------------

# the budget sweep on JAX's avatar: the default budget and two past its floor
SWEEP_SETTINGS = ((32, 4, 512), (40, 4, 512), (48, 4, 512))
SWEEP_ITERS, SWEEP_WARMUP = 20, 3


def phase_seeded_draws(device="cuda"):
    """Phase 9: the port's copy of JAX's seeded draws on the card's host
    (no JAX there): 9a the e2e teacher's shadow MLP drawn from
    ``prng.key(7)`` against JAX's draw, ``weights/e2e_teacher_shadow.npz``;
    9b every draw of the witness ``weights/prng_witness.npz`` (JAX's split,
    bits, uniform and normal for six seeds, and the edges of each LPIPS
    conv draw); 9c the random VGG16 and AlexNet trunks' draw times; 9d the
    budget sweep (``tools/tune_trained_budgets``) on JAX's trained avatar at
    512^2 through B1, launches counted."""
    from gomavatar_tpu_torch.convert import TRAINED, load_trained, unflatten_params
    from gomavatar_tpu_torch.models import lpips
    from gomavatar_tpu_torch.models.smpl import synthetic_body
    from gomavatar_tpu_torch.tools import make_e2e_data as D
    from gomavatar_tpu_torch.tools import prng_witness
    from gomavatar_tpu_torch.tools import tune_trained_budgets as TT

    out = {}
    print("[9a] the e2e teacher's shadow MLP drawn from prng.key(7) against JAX's draw")
    params, _, cfg = D.teacher_model(synthetic_body(*E2E_BODY), device=device)
    with np.load(D.TEACHER_SHADOW) as npz:
        want = unflatten_params(npz)["shadow"]["layers"]
    got = params["shadow"]["layers"]
    same = len(got) == len(want) and all(
        np.array_equal(g[k].cpu().numpy(), w[k]) for g, w in zip(got, want) for k in ("w", "b"))
    n = sum(w[k].size for w in want for k in ("w", "b"))
    print(f"  teacher ({cfg.num_faces} faces): {len(got)} shadow layers, {n} values, bit-equal to "
          f"{D.TEACHER_SHADOW.name}: {same}")
    require(same, "9a: the teacher's shadow MLP is not JAX's draw")
    out["9a"] = {"layers": len(got), "values": n, "equal": same}

    print("[9b] the port's draws against JAX's witness")
    bad = prng_witness.mismatches()
    with np.load(prng_witness.WITNESS) as z:
        names = len(z.files)
    print(f"  {prng_witness.WITNESS.name}: {names - len(bad)} of {names} draws bit-equal"
          + (f"; differ: {bad}" if bad else ""))
    require(not bad, "9b: the port's draws differ from JAX's witness")
    out["9b"] = {"draws": names, "differ": bad}

    print("[9c] the random LPIPS trunks drawn on the host")
    draw = {}
    for name, seed, shapes in (("vgg", 1234, lpips.vgg_shapes()), ("alex", 4321, lpips.alex_shapes())):
        t = time.perf_counter()
        ws = lpips.random_trunk.__wrapped__(seed, tuple(shapes))
        draw[name] = {"seconds": time.perf_counter() - t, "values": int(sum(w.size for w in ws))}
        print(f"  {name}: {draw[name]['values']} normals in {draw[name]['seconds']:.3f} s")
    out["9c"] = draw

    print(f"[9d] the budget sweep on JAX's trained avatar at 512^2: {SWEEP_SETTINGS} (max_tiles_per_gaussian, "
          f"band0, active_tile_cap), {SWEEP_ITERS} timed forwards each after {SWEEP_WARMUP}")
    params, statics, cfg, frame = load_trained(TRAINED, device)
    span = TT.widest_span(params, statics, cfg, frame)
    rows, launches, seconds = counted(lambda: TT.sweep(params, statics, cfg, frame, SWEEP_SETTINGS, SWEEP_ITERS,
                                                       SWEEP_WARMUP, device))
    print(f"  the widest splat spans {span} tiles; {seconds:.2f} s; launches {launches}")
    for r in rows:
        print(f"  mtg={r['max_tiles_per_gaussian']} band0={r['binning_band0']} cap={r['active_tile_cap']}: "
              f"dropped_budget {r['dropped_budget']}, dropped_buffer {r['dropped_buffer']}, tile_overflow "
              f"{r['tile_overflow']}; forward median {r['median_ms']:.3f} ms, p90 {r['p90_ms']:.3f} ms")
        require(r["dropped_budget"] + r["dropped_buffer"] + r["tile_overflow"] == 0,
                "9d: JAX's avatar dropped entries at a budget of 32 or more")
    forwards = len(SWEEP_SETTINGS) * (1 + SWEEP_WARMUP + SWEEP_ITERS)
    require(launches["B1a"] == launches["B1b"] == forwards, f"9d: B1 not launched once per forward ({forwards})")
    out["9d"] = {"avatar": str(TRAINED), "widest_span": span, "settings": rows, "launches": launches,
                 "seconds": seconds}
    return out


# ---- phase 10: calibrated LPIPS on the card --------------------------------------

# 10b: LPIPS on the card against the CPU, float32 within rtol 1e-4 and
# bfloat16 within rtol 1e-2 (tests/test_torch_metrics.py's bound: cuDNN and
# the CPU round bfloat16 convolutions differently); the perturbed copy adds
# N(0, CAL_NOISE) per value (numpy seed 0).  The VGG loss's input gradient
# on this frame is ill-conditioned: ~88 % of it is flat black background,
# whose max-pool ties and near-zero feature vectors let rounding alone move
# the gradient (on an H100 80GB HBM3 at 700 W, 10b printed the card's
# float32 gradient moved 4.2 % of its norm by a 1-ulp change of the input,
# and each device's bfloat16 one 28 % from the float64 gradient).  So each
# device's gradient is held to the float64 gradient on the CPU: the card's
# no farther from it than the CPU's plus STEP_GRAD_REL of its norm, in
# float32 and in bfloat16
LPIPS_F32_RTOL, LPIPS_BF16_RTOL, CAL_NOISE = 1e-4, 1e-2, 0.05
# 10b's crop: the subject's bounding box (the pixels the render's mask
# covers) padded by CROP_PAD pixels and rounded outward to multiples of
# CROP_MULTIPLE (VGG's four 2x2 pools), inside the frame.  There the float32
# input gradient is well-conditioned (on the CPU a one-ulp change of the
# input moves it by less than 1 % of its norm), so the card's is held to
# the CPU's within STEP_GRAD_REL of its norm
CROP_PAD, CROP_MULTIPLE = 8, 16
# 10c: cli.train steps from the trained avatar's checkpoint; 10d: captured
# steps against the eager step
CAL_TRAIN_STEPS, CAL_STEPS = 3, 3
CAL_DIR = "build/smoke_lpips"  # under the checkout, gitignored


def write_torchvision_checkpoints(root: str, seed: int = 0) -> dict:
    """Phase 10a: VGG16 and AlexNet state dicts in torchvision's layout
    (``features.{i}.{weight,bias}`` at torchvision's conv positions, the
    weights He-scaled, the biases N(0, 0.05); a few small ``classifier.*``
    keys) and LPIPS head files (``lin{i}.model.1.weight`` uniform in
    [-0.05, 0.2), so some negative), drawn from numpy ``seed`` and written
    by ``torch.save``.  Returns {trunk: (trunk path, heads path, trunk
    state dict, heads state dict)}."""
    from gomavatar_tpu_torch.models import lpips

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    out = {}
    for trunk, shapes, channels in (("vgg", lpips.vgg_shapes(), lpips._TAP_CHANNELS),
                                    ("alex", lpips.alex_shapes(), lpips._ALEX_TAP_CHANNELS)):
        sd = {}
        for idx, (kh, kw, c_in, c) in zip(lpips.torch_conv_indices(trunk), shapes):
            w = rng.standard_normal((c, c_in, kh, kw)) * np.sqrt(2.0 / (c_in * kh * kw))
            sd[f"features.{idx}.weight"] = torch.from_numpy(w.astype(np.float32))
            sd[f"features.{idx}.bias"] = torch.from_numpy(rng.normal(0.0, 0.05, c).astype(np.float32))
        for k in (0, 3, 6):
            sd[f"classifier.{k}.weight"] = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
            sd[f"classifier.{k}.bias"] = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
        heads = {f"lin{i}.model.1.weight": torch.from_numpy(rng.uniform(-0.05, 0.2, (1, c, 1, 1)).astype(np.float32))
                 for i, c in enumerate(channels)}
        paths = f"{root}/{trunk}_trunk.pth", f"{root}/{trunk}_heads.pth"
        torch.save(sd, paths[0])
        torch.save(heads, paths[1])
        out[trunk] = (*paths, sd, heads)
    return out


def converted_trunks(root: str = CAL_DIR) -> tuple:
    """Phase 10a's files: :func:`write_torchvision_checkpoints` under
    ``root``/pth, converted by ``tools/calibrate_lpips.main`` into
    ``root``/weights.  Returns (the checkpoints, the converted files' dir)."""
    from gomavatar_tpu_torch.tools import calibrate_lpips

    ckpts = write_torchvision_checkpoints(f"{root}/pth")
    cal_dir = f"{root}/weights"
    v, a = ckpts["vgg"], ckpts["alex"]
    wrote = calibrate_lpips.main(["--vgg16", v[0], "--vgg_heads", v[1], "--alexnet", a[0], "--alex_heads", a[1],
                                  "--out_dir", cal_dir])
    require([cal for _, cal in wrote] == [True, True], "10a: the converter did not write two calibrated trunks")
    return ckpts, cal_dir


def converted_equal(params, trunk: str, sd: dict, heads: dict) -> bool:
    """The loaded params on the card hold exactly the state dicts' tensors:
    the convs at torchvision's positions, the heads clamped at 0."""
    from gomavatar_tpu_torch.models.lpips import torch_conv_indices

    idx = torch_conv_indices(trunk)
    leaves = [c[k] for c in params["convs"] for k in ("w", "b")] + list(params["heads"])
    ok = len(params["convs"]) == len(idx) and ("alex" in params) == (trunk == "alex")
    ok = ok and all(t.is_cuda for t in leaves)
    ok = ok and all(torch.equal(c["w"].cpu(), sd[f"features.{i}.weight"]) and
                    torch.equal(c["b"].cpu(), sd[f"features.{i}.bias"]) for c, i in zip(params["convs"], idx))
    return ok and all(torch.equal(h.cpu(), heads[f"lin{i}.model.1.weight"].reshape(-1, 1).clamp_min(0.0))
                      for i, h in enumerate(params["heads"]))


def vgg_lpips_f64(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """VGG-LPIPS in float64 on the CPU, written from torch's functional ops
    (scaling, conv + bias + ReLU, 2x2 max pools, unit-normalised taps,
    clamped heads, spatial mean): the exact gradient of 10b."""
    import torch.nn.functional as F

    from gomavatar_tpu_torch.models import lpips

    def taps(img):
        shift, scale = (torch.tensor(v, dtype=torch.float64) for v in (lpips._SHIFT, lpips._SCALE))
        h, out, i = ((img - shift) / scale).permute(2, 0, 1)[None], [], 0
        for c in lpips._VGG_CFG:
            if c == "M":
                h = F.max_pool2d(h, 2)
                continue
            conv = params["convs"][i]
            h = torch.relu(F.conv2d(h, conv["w"].double(), padding=1) + conv["b"].double()[None, :, None, None])
            if i in lpips._TAPS:
                out.append(h)
            i += 1
        return out

    total = torch.zeros((), dtype=torch.float64)
    for a, b, head in zip(taps(x), taps(y), params["heads"]):
        na, nb = (f * torch.rsqrt((f * f).sum(1, keepdim=True) + 1e-20) for f in (a, b))
        total = total + ((na - nb) ** 2 * head.double()[:, 0].clamp_min(0.0)[None, :, None, None]).sum(1).mean()
    return total


def lpips_grads(p: dict, pred: np.ndarray, gt: np.ndarray, background: np.ndarray,
                devices=("cuda", "cpu")) -> dict:
    """10b's gradient: the VGG loss's input gradient on the card and on the
    CPU (``devices``; ``p`` holds each one's params by name) in float32 and
    bfloat16, each against the float64 gradient on the CPU (the card's
    distance from it at most the CPU's plus STEP_GRAD_REL of its norm),
    with the card against the CPU, the share of that difference on the
    (H, W) ``background`` pixels, and the card's gradient at the input moved
    by one ulp (how far rounding alone moves it) printed beside."""
    from gomavatar_tpu_torch.models.lpips import lpips

    card, host = devices

    def grad(fn, x):
        x = x.requires_grad_(True)
        fn(x).backward()
        return x.grad.detach().cpu().double()

    def rel(a, b):
        return float(torch.linalg.norm(a - b) / torch.clamp_min(torch.linalg.norm(b), 1e-30))

    nudged = np.nextafter(pred, np.float32(2.0)).astype(np.float32)
    exact = grad(lambda x: vgg_lpips_f64(p[host], x, torch.as_tensor(gt, dtype=torch.float64)),
                 torch.as_tensor(pred, dtype=torch.float64))
    out = {}
    for bf16 in (False, True):
        g = {}
        for key, d, x in (("card", card, pred), ("cpu", host, pred), ("card nudged", card, nudged)):
            g[key] = grad(lambda v: lpips(p[d], v, torch.as_tensor(gt, device=d), bf16=bf16),
                          torch.as_tensor(x, device=d))
        d2 = ((g["card"] - g["cpu"]) ** 2).sum(-1).numpy()
        r = {"card_exact": rel(g["card"], exact), "cpu_exact": rel(g["cpu"], exact),
             "card_cpu": rel(g["card"], g["cpu"]),
             "card_cpu_background": float(d2[background].sum() / max(float(d2.sum()), 1e-30)),
             "card_nudged": rel(g["card nudged"], g["card"])}
        name = "bf16" if bf16 else "f32"
        print(f"  the VGG loss's {name} input gradient against the float64 one: card {r['card_exact']:.4g}, CPU "
              f"{r['cpu_exact']:.4g} of its norm (limit: the CPU's + {STEP_GRAD_REL:g}); card against CPU "
              f"{r['card_cpu']:.4g} ({r['card_cpu_background']:.3f} of it, squared, on the background's "
              f"{background.mean():.3f} of the pixels), the card's at the input moved by one ulp "
              f"{r['card_nudged']:.4g}")
        require(bool(torch.isfinite(g["card"]).all()) and float(exact.abs().max()) > 0
                and r["card_exact"] <= r["cpu_exact"] + STEP_GRAD_REL,
                f"10b: the card's {name} VGG LPIPS gradient is farther from the float64 gradient than the CPU's")
        out[name] = r
    return out


def subject_box(mask: np.ndarray) -> tuple:
    """(y0, y1, x0, x1): the rows and columns of the pixels where the (H, W)
    ``mask`` is nonzero, padded by CROP_PAD pixels and rounded outward to
    multiples of CROP_MULTIPLE, clipped to the frame (whose sides are
    multiples of CROP_MULTIPLE)."""
    H, W, m = *mask.shape, CROP_MULTIPLE
    require(H % m == 0 and W % m == 0, f"10b: a {H} x {W} frame is not in blocks of {m}")
    ys, xs = np.nonzero(mask)
    require(len(ys) > 0, "10b: the mask is empty")

    def side(lo, hi, n):
        return max(0, (lo - CROP_PAD) // m * m), min(n, -(-(hi + 1 + CROP_PAD) // m) * m)

    return (*side(int(ys.min()), int(ys.max()), H), *side(int(xs.min()), int(xs.max()), W))


def textured_background(h: int, w: int) -> np.ndarray:
    """A smooth, textured (h, w, 3) background with no flat region: values
    drawn from numpy seed 0 on grids every 32 pixels (uniform in [0.2,
    0.8]) and every 8 pixels (uniform in [-0.1, 0.1]), each bilinearly
    upsampled, summed."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    out = np.zeros((h, w, 3))
    for step, lo, hi in ((32, 0.2, 0.8), (8, -0.1, 0.1)):
        grid = torch.as_tensor(rng.uniform(lo, hi, (1, 3, h // step + 1, w // step + 1)))
        out += F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=True)[0].permute(1, 2, 0).numpy()
    return out.astype(np.float32)


def crop_grads(p: dict, pred: np.ndarray, gt: np.ndarray, mask: np.ndarray, devices=("cuda", "cpu")) -> dict:
    """10b on the subject's crop (:func:`subject_box` of the (H, W)
    ``mask``) of ``pred`` and ``gt``: :func:`lpips_grads` there, and the
    float32 gradient of the card within STEP_GRAD_REL of its norm of the
    CPU's.  The crop's input must be well-conditioned: 10b composites the
    subject over :func:`textured_background` (on the black one, half of the
    crop is flat)."""
    y0, y1, x0, x1 = subject_box(mask)
    crop = lambda a: np.ascontiguousarray(a[y0:y1, x0:x1])  # noqa: E731
    background = crop(mask) == 0
    print(f"  the subject's crop: rows {y0}:{y1}, columns {x0}:{x1} ({y1 - y0} x {x1 - x0} of {mask.shape[0]} x "
          f"{mask.shape[1]}; {background.mean():.3f} of it background)")
    out = lpips_grads(p, crop(pred), crop(gt), background, devices)
    r, b = out["f32"], out["bf16"]
    print(f"  on the crop, the f32 input gradient card against CPU: {r['card_cpu']:.4g} of its norm (limit "
          f"{STEP_GRAD_REL:g}); the bf16 one {b['card_cpu']:.4g}; the card's f32 one at the input moved by one ulp "
          f"{r['card_nudged']:.4g}")
    require(r["card_cpu"] <= STEP_GRAD_REL,
            f"10b: on the crop the card's f32 VGG LPIPS gradient is {r['card_cpu']:.4g} of its norm from the CPU's")
    return dict(out, box=[y0, y1, x0, x1])


def lpips_card_vs_cpu(trained, cal_dir: str, devices=("cuda", "cpu")) -> dict:
    """Phase 10b: both converted trunks' LPIPS on the card against the CPU
    (``devices``), float32 and bfloat16, between the trained avatar's 512^2
    render of its packed frame and a perturbed copy; the VGG loss's input
    gradient on the whole frame (:func:`lpips_grads`) and on the subject's
    crop (:func:`crop_grads`)."""
    from gomavatar_tpu_torch.losses import unpack
    from gomavatar_tpu_torch.models.lpips import load_lpips, lpips

    card, host = devices
    params, statics, cfg, frame = trained
    with torch.no_grad():
        rgb, mask, _ = forward(params, statics, cfg, frame, device=card)
    img = unpack(rgb, mask, torch.zeros(3, device=card), clamp=True).cpu().numpy()
    require(img.shape == (*cfg.img_size, 3) and img.mean() > 0.01, "10b: the render is empty")
    noise = np.random.default_rng(0).normal(0.0, CAL_NOISE, img.shape)
    noisy = np.clip(img + noise, 0.0, 1.0)
    pred, gt = (np.asarray(2.0 * x - 1.0, np.float32) for x in (img, noisy))
    # the crop's input: the same render over a textured background
    textured = unpack(rgb, mask, torch.zeros(3, device=card), clamp=False).cpu().numpy()
    mask = mask.cpu().numpy().reshape(img.shape[:2])
    textured = np.clip(textured + (1.0 - mask)[..., None] * textured_background(*mask.shape), 0.0, 1.0)
    pred_t, gt_t = (np.asarray(2.0 * x - 1.0, np.float32) for x in (textured, np.clip(textured + noise, 0.0, 1.0)))
    out = {}
    for trunk in ("vgg", "alex"):
        p = {dev: load_lpips(trunk, weights_dir=cal_dir, quiet=True, device=dev)[0] for dev in dict.fromkeys(devices)}
        for bf16, rtol in ((False, LPIPS_F32_RTOL), (True, LPIPS_BF16_RTOL)):
            v = {dev: float(lpips(p[dev], torch.as_tensor(pred, device=dev), torch.as_tensor(gt, device=dev),
                                  bf16=bf16)) for dev in p}
            rel = abs(v[card] - v[host]) / abs(v[host])
            name = f"{trunk} {'bf16' if bf16 else 'f32'}"
            print(f"  LPIPS {name} at {img.shape[0]}^2: card {v[card]:.7g}, CPU {v[host]:.7g}, relative "
                  f"difference {rel:.3g} (limit {rtol:g})")
            require(np.isfinite(v[card]) and v[host] > 0 and rel <= rtol,
                    f"10b: LPIPS {name} differs between the card and the CPU by more than rtol {rtol:g}")
            out[name] = {"card": v[card], "cpu": v[host], "rel": rel}
        if trunk == "vgg":
            out["vgg grad"] = lpips_grads(p, pred, gt, mask == 0, devices)
            out["vgg grad crop"] = crop_grads(p, pred_t, gt_t, mask, devices)
    return out


def calibrated_eval(path: str, exp, t: str, trunk: str, cal_dir: str, device="cuda") -> dict:
    """Phase 10c, one protocol: cli.evaluate --type ``t`` with the converted
    trunks; the metric reported as ``lpips``, B1a and B1b once per frame,
    and the first frame's LPIPS (``metric_{t}.npy``) against the CPU's on
    the same prediction (its PNG: the evaluator's uint8 image) and ground
    truth."""
    import argparse

    from PIL import Image

    from gomavatar_tpu_torch.cli import evaluate
    from gomavatar_tpu_torch.eval_lib import to_8b_image
    from gomavatar_tpu_torch.models.lpips import load_lpips, lpips

    result, launches, seconds = counted(lambda: evaluate.main(["--cfg", path, "--type", t, "--device", device]))
    metrics = result["metrics"]
    frames = result["frames"]
    print(f"  cli.evaluate --type {t} ({trunk}): {frames} frames in {seconds:.2f} s, dropped {result['dropped']}, "
          f"launches {launches}, metrics {metrics}")
    require("lpips" in metrics and "lpips_uncalibrated" not in metrics and np.isfinite(metrics["lpips"]),
            f"10c: cli.evaluate --type {t} did not report a calibrated lpips")
    require(launches["B1a"] == launches["B1b"] == frames, f"10c: --type {t} did not launch B1a and B1b once per frame")
    require(all(launches[k] == 0 for k in TRAIN_KERNELS), f"10c: --type {t} launched a train kernel")
    require(result["dropped"] == 0, f"10c: --type {t} dropped entries")
    dataset, _ = evaluate.build_dataset(exp, argparse.Namespace(type=t, dataset_path=None, frame_idx=0, n_frames=100,
                                                                pose_path=None))
    item = dataset[0]
    pred = np.asarray(Image.open(f"{result['out_dir']}/{item['frame_name']}.png")) / 255.0
    gt = to_8b_image(np.asarray(item["target_rgbs"])) / 255.0
    cpu_params = load_lpips(trunk, weights_dir=cal_dir, quiet=True, device="cpu")[0]
    scale = 1000.0 if t == "train" else 1.0  # the ZJU protocol reports LPIPS x 1000
    want = scale * float(lpips(cpu_params, torch.as_tensor(np.asarray(pred * 2.0 - 1.0, np.float32)),
                               torch.as_tensor(np.asarray(gt * 2.0 - 1.0, np.float32))))
    got = float(np.load(f"{exp['save_dir']}/eval/metric_{t}.npy", allow_pickle=True).item()["lpips"][0])
    rel = abs(got - want) / abs(want)
    print(f"  {item['frame_name']}: lpips on the card {got:.7g}, the CPU's on the same arrays {want:.7g}, relative "
          f"difference {rel:.3g} (limit {LPIPS_BF16_RTOL:g})")
    require(rel <= LPIPS_BF16_RTOL, f"10c: --type {t}'s first frame's lpips differs from the CPU's")
    return {"frames": frames, "seconds": seconds, "launches": launches, "metrics": metrics,
            "first_frame": {"card": got, "cpu": want, "rel": rel}}


def calibrated_drivers(cfg_path: str, cal_dir: str, device="cuda") -> dict:
    """Phase 10c: cli.evaluate --type train (VGG) and --type view (AlexNet)
    and CAL_TRAIN_STEPS steps of cli.train --resume from the trained
    avatar's checkpoint, with GOMAVATAR_LPIPS_DIR (and so ``WEIGHTS_DIR``)
    pointing at the converted trunks."""
    from gomavatar_tpu_torch.cli import train as train_cli
    from gomavatar_tpu_torch.config import make_cfg
    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.models import lpips

    it = int(trained_meta()["iter"])
    path = exp_copy(cfg_path, it, "lpips_calibrated", log_freq=1, tb_freq=10**9, save_freq=10**9, eval_freq=10**9)
    exp = make_cfg(path)
    require(exp["train"]["losses"]["lpips"]["coeff"] > 0, "10c: the train config has no LPIPS term")
    # the module reads the variable once, at import; a user's process starts
    # with it set
    saved = os.environ.get("GOMAVATAR_LPIPS_DIR"), lpips.WEIGHTS_DIR
    os.environ["GOMAVATAR_LPIPS_DIR"] = lpips.WEIGHTS_DIR = cal_dir
    try:
        out = {f"evaluate_{t}": calibrated_eval(path, exp, t, trunk, cal_dir, device)
               for t, trunk in (("train", "vgg"), ("view", "alex"))}
        stop = it + CAL_TRAIN_STEPS
        trainer, launches, seconds = counted(
            lambda: train_cli.main(["--cfg", path, "--resume", "--max_iters", str(stop), "--device", device]))
    finally:
        if saved[0] is None:
            os.environ.pop("GOMAVATAR_LPIPS_DIR")
        else:
            os.environ["GOMAVATAR_LPIPS_DIR"] = saved[0]
        lpips.WEIGHTS_DIR = saved[1]
    logged = [line for line in log_lines(f"{exp['save_dir']}/log.txt", " it/s)")
              if int(line.split("iter ")[1].split(" ")[0]) > it]
    terms = [float(line.split("lpips: ")[1].split(",")[0].rstrip(")")) for line in logged]
    print(f"  cli.train --resume --max_iters {stop}: {seconds:.2f} s, iteration {trainer.i_iter}, lpips calibrated "
          f"{trainer.lpips_calibrated}, the lpips term per step {terms}, launches {launches}")
    require(trainer.i_iter == stop and trainer.lpips_calibrated,
            "10c: cli.train did not train with the converted trunk")
    require(len(terms) == CAL_TRAIN_STEPS and all(np.isfinite(v) and v > 0 for v in terms),
            "10c: cli.train's lpips term is missing or not finite")
    for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
        require(launches[k] == CAL_TRAIN_STEPS, f"10c: cli.train did not launch {k} once per step")
    out["train"] = {"steps": CAL_TRAIN_STEPS, "seconds": seconds, "lpips": terms, "launches": launches}
    return out


def events_in_turns(ways: dict, iters: int) -> dict:
    """{way: ms of each of its ``iters`` calls by CUDA events around the
    call}, the ways called in turns, each call synchronised."""
    per_call = {k: [] for k in ways}
    for _ in range(iters):
        for k, fn in ways.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            per_call[k].append(start.elapsed_time(end))
    return per_call


def calibrated_steps(trained, cal_dir: str, card: str) -> dict:
    """Phase 10d: CAL_STEPS captured Trainer.steps on the trained avatar with
    the converted VGG trunk as the loss, bit-equal to the eager step from
    the same state (torch's default algorithms), B2a-B5 once per step; then
    the captured step with the converted and with the random trunk timed
    in turns."""
    from gomavatar_tpu_torch.convert import trained_meta
    from gomavatar_tpu_torch.models.lpips import load_lpips
    from gomavatar_tpu_torch.optim import tree_leaves
    from gomavatar_tpu_torch.trainer import make_train_step

    params, statics, cfg, _ = trained
    i_iter = int(trained_meta()["iter"])
    batches = dp_batches(trained)
    cal_params, calibrated, _ = load_lpips("vgg", weights_dir=cal_dir, quiet=True, device="cuda")
    require(calibrated, "10d: the converted VGG trunk did not load")
    trainer = make_trainer(params, statics, cfg, i_iter, "cuda", lpips_params=cal_params)
    start = clone_tree(trainer.params), clone_tree(trainer.opt_state)

    def run():
        out = []
        for i in range(CAL_STEPS):
            total, losses = clone_tree(trainer.step(batches[i % len(batches)]))
            out.append((total, losses, train_state(trainer)))
        return out

    steps, launches, _ = counted(run)
    for k in ("B2a", "B2b", "B3a", "B3b", "B4a", "B4b", "B5"):
        require(launches[k] == CAL_STEPS, f"10d: {k} not launched once per step")
    require(trainer._step_fn.captures == 1, "10d: the train program captured more than once")
    eager = make_train_step(trainer.gom_cfg, trainer.loss_cfg, trainer.tx)
    p, o = start
    lp = []
    for i, (total, losses, snap) in enumerate(steps):
        p, o, total_e, _ = eager(p, o, trainer.statics, cal_params, batches[i % len(batches)],
                                 torch.full((), float(i_iter + i), device="cuda"))
        same = (leaves_equal(tree_leaves(p), snap[0]) and leaves_equal(list(o.mu) + list(o.nu), snap[1])
                and int(o.count) == snap[2] and torch.equal(total_e, total))
        lp.append(float(losses["lpips"]))
        require(same, f"10d step {i}: the captured step with the converted trunk differs from the eager one")
        require(np.isfinite(lp[-1]) and lp[-1] > 0, f"10d step {i}: the lpips term is not finite")
    print(f"  {CAL_STEPS} captured steps with the converted VGG trunk: lpips {lp}, launches {launches}; params, Adam "
          f"moments, counts and the total bit-equal to the eager step's after each")

    random_trunk = make_trainer(params, statics, cfg, i_iter, "cuda")
    ways = {"converted": lambda: trainer.step(batches[0]), "random": lambda: random_trunk.step(batches[0])}
    events_in_turns(ways, TRAIN_WARMUP)
    timed = {k: spread(v) for k, v in events_in_turns(ways, TRAIN_ITERS).items()}
    ratio = timed["converted"]["median_ms"] / timed["random"]["median_ms"]
    for k, v in timed.items():
        print(f"  captured step, {k} VGG trunk: median {v['median_ms']:.3f} ms, p90 {v['p90_ms']:.3f} over "
              f"{TRAIN_ITERS} steps in turns after {TRAIN_WARMUP} (CUDA events; {card})")
    print(f"  converted over random: {ratio:.4f}x the median (predicted within 1 +- 0.02)")
    return {"steps": CAL_STEPS, "lpips": lp, "launches": launches, "bit_equal_eager": True, "timed": timed,
            "ratio": ratio}


def phase_calibrated_lpips(trained, cfg_path: str, card: str) -> dict:
    """Phase 10: calibrated LPIPS on the card, from torchvision-layout
    checkpoints through the port's converter to the drivers and the
    captured train step."""
    from gomavatar_tpu_torch.models.lpips import load_lpips

    out = {}
    t0 = time.perf_counter()
    print("[10a] seeded VGG16 and AlexNet state dicts in torchvision's layout (nonzero biases, classifier keys) and "
          "LPIPS heads (some negative), converted by tools/calibrate_lpips")
    ckpts, cal_dir = converted_trunks()
    out["10a"] = {}
    for trunk, (_, _, sd, heads) in ckpts.items():
        params, calibrated, status = load_lpips(trunk, weights_dir=cal_dir, quiet=True, device="cuda")
        equal = converted_equal(params, trunk, sd, heads)
        negative = sum(int((h < 0).sum()) for h in heads.values())
        print(f"  {status}; params on the card equal to the state dicts' tensors: {equal} ({negative} negative head "
              f"entries clamped)")
        require(calibrated and "CALIBRATED" in status, f"10a: load_lpips({trunk}) does not report CALIBRATED")
        require(equal and negative > 0, f"10a: the {trunk} params on the card differ from the state dicts")
        out["10a"][trunk] = {"calibrated": calibrated, "equal": equal, "negative_heads": negative}
    print(f"  phase 10a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("[10b] LPIPS of both converted trunks on the card against the CPU: the trained avatar's 512^2 frame against "
          "a perturbed copy")
    out["10b"] = lpips_card_vs_cpu(trained, cal_dir)
    print(f"  phase 10b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("[10c] cli.evaluate --type train and --type view, and cli.train --resume, with GOMAVATAR_LPIPS_DIR at the "
          "converted trunks")
    out["10c"] = calibrated_drivers(cfg_path, cal_dir)
    print(f"  phase 10c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[10d] {CAL_STEPS} captured Trainer.steps with the converted VGG trunk against the eager step; the "
          f"captured step timed with the converted and the random trunk")
    out["10d"] = calibrated_steps(trained, cal_dir, card)
    print(f"  phase 10d: {time.perf_counter() - t0:.1f} s")
    return out


def calibrated_launches(k: str, cal: dict) -> dict:
    """Kernel ``k``'s launches (its parts' sum) in 10c's runs and in 10d."""
    parts = [k] if k == "B5" else [f"{k}a", f"{k}b"]
    runs = {**{r: cal["10c"][r]["launches"] for r in ("evaluate_train", "evaluate_view", "train")},
            "10d": cal["10d"]["launches"]}
    return {r: sum(launches[q] for q in parts) for r, launches in runs.items()}


def e2e_launches(k: str, e2e: dict) -> dict:
    """Kernel ``k``'s launches (its parts' sum) in 8a, 8b and 8c."""
    parts = [k] if k == "B5" else [f"{k}a", f"{k}b"]
    return {p: sum(e2e[p]["launches"][q] for q in parts) for p in ("8a", "8b", "8c")}


KERNELS = {
    "B1": ("B1 frame_render (B1a partials + B1b merge)", "gomavatar_tpu_torch/csrc/frame_render.cu",
           "gomavatar_tpu/ops/frame_render.py:74"),
    "B2": ("B2 splat_fwd (B2a partials + B2b merge)", "gomavatar_tpu_torch/csrc/splat_composite.cu",
           "gomavatar_tpu/ops/splat/pallas_kernel.py:164"),
    "B3": ("B3 splat_bwd (B3a partials + B3b gradients)", "gomavatar_tpu_torch/csrc/splat_composite.cu",
           "gomavatar_tpu/ops/splat/pallas_kernel.py:241"),
    "B4": ("B4 mesh_fwd (B4a partials + B4b merge)", "gomavatar_tpu_torch/csrc/mesh_raster.cu",
           "gomavatar_tpu/ops/mesh_raster_pallas.py:126"),
    "B5": ("B5 mesh_bwd", "gomavatar_tpu_torch/csrc/mesh_raster.cu",
           "gomavatar_tpu/ops/mesh_raster_pallas.py:203"),
}


# phase 11: the train data on the card and the per-splat budget that grows
# with the state; the benchmark's two train cells' frames and state, from a
# seed of their own
CARD_DATA_CELLS = ("zju377.train", "snapshot_m3c.train")
CARD_DATA_SEED = 3141592653
BUDGET_STEPS = 3000
BUDGET_CHILD_TIMEOUT_S = 1500


def benchmark_cell(workload: str, seed: int, tmp: str):
    """The ``Driver`` of the benchmark cell ``workload`` (``portbench/``) after
    its set-up: its train frames written under ``tmp``, the program's state
    loaded, its first steps taken."""
    from portbench import run as bench_run
    from portbench.lib import harness

    spec = bench_run.resolve(bench_run.read_json("BENCHMARK.json"), workload)
    driver = bench_run.load_file(spec["driver"], "smoke_driver_" + spec["mix"]["driver"])
    drv = driver.Driver(harness.Cell(workload, spec["config"], spec["mix"], seed, torch.device("cuda", 0), tmp))
    drv.setup()
    return drv


def card_composite(drv) -> dict:
    """11a on one cell: each train frame's item from the dataset on the card
    (its store, the kernel on it) against the same item by the host's cv2
    path, and the kernel against its plain version on the card, at the same
    background, all bit for bit; the kernel's device ms and each path's host
    ms an item for frames in their store."""
    from gomavatar_tpu_torch.cli.train import train_dataset
    from gomavatar_tpu_torch.data.composite import composite_resize, composite_resize_plain
    from gomavatar_tpu_torch.data.dataset import CardArray

    name, ds = drv.cell.workload, drv.dataset
    cfg = drv.cell.program_cfg()
    cfg["dataset"]["train"]["dataset_path"] = drv.cell.tmp
    host = train_dataset(cfg, device="cpu")
    require(ds._card_dev is not None and host._card_dev is None, f"11a: {name}: the stores are not card and host")
    w, h = ds.target_size
    for i in range(len(ds)):
        a, b = (d.item(i, np.random.default_rng((CARD_DATA_SEED, i))) for d in (ds, host))
        for k in ("target_rgbs", "target_masks"):
            require(isinstance(a[k], CardArray), f"11a: {name} frame {i}: {k} was not made on the card")
            require(np.array_equal(np.asarray(a[k]), b[k]), f"11a: {name} frame {i}: {k} differs from the host's")
        img, mask = ds._store[a["frame_name"]]
        bg = (np.random.default_rng((CARD_DATA_SEED, i, 1)).random(3) * 255.0).astype(np.float32)
        kernel, plain = composite_resize(img, mask, bg, (h, w)), composite_resize_plain(img, mask, bg, (h, w))
        for k, p, label in zip(kernel, plain, ("image", "mask")):
            require(torch.equal(k, p), f"11a: {name} frame {i}: the kernel's {label} differs from the plain version's")
    require(len(ds._store) == len(ds), f"11a: {name}: {len(ds._store)} of {len(ds)} frames on the card")
    item_ms = {}
    for label, d in (("card", ds), ("host", host)):
        t0 = time.perf_counter()
        for i in range(len(d)):
            item = d.item(i, np.random.default_rng((CARD_DATA_SEED, i)))
        if label == "card":
            item["target_masks"].event.synchronize()
        item_ms[label] = (time.perf_counter() - t0) * 1e3 / len(d)
    img, mask = ds._store[ds.framelist[0]]
    ms = cuda_ms(lambda: composite_resize(img, mask, bg, (h, w)), KERNEL_ITERS)
    out = {"frames": len(ds), "src": list(img.shape[:2]), "out": [h, w], "kernel_ms": ms,
           "item_ms": item_ms, "card_store_bytes": ds._store_bytes}
    print(f"  11a {name}: {len(ds)} frames {tuple(img.shape[:2])} -> {(h, w)} bit-equal to the host's and the "
          f"plain version's; kernel {ms:.4f} ms; an item {item_ms['card']:.2f} ms on the card path, "
          f"{item_ms['host']:.2f} ms on the host's (stored frames); store {ds._store_bytes / 2**20:.1f} MiB")
    return out


def budget_run_child(steps: int, seed: int, out: str) -> None:
    """11b's child, under GOMAVATAR_DEBUG_BINNING=1 (the trainer reads its
    three drop counters after every step and fails on a drop): the
    ``zju377.train`` cell's loop from its state for ``steps`` steps, the
    per-splat budget as it grows, the widest splat over every 10 steps, and
    the wall time of each step that captured a grown step's program beside
    the median step, into the JSON file ``out``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        drv = benchmark_cell("zju377.train", seed, tmp)
        tr = drv.trainer
        hist = {"budget": [[0, tr.step_cfg.max_tiles_per_gaussian]], "widest_per_10": [], "capture_step_s": []}
        widest, times, grew = 0, [], False
        t_loop = time.perf_counter()
        for k in range(1, steps + 1):
            t0 = time.perf_counter()
            _, losses = drv.step()
            widest = max(widest, int(losses["bin_most_tiles"]))
            times.append(time.perf_counter() - t0)
            if grew:
                hist["capture_step_s"].append([k, times[-1]])
            budget = tr.step_cfg.max_tiles_per_gaussian
            grew = budget != hist["budget"][-1][1]
            if grew:
                hist["budget"].append([k, budget])
            if k % 10 == 0:
                hist["widest_per_10"].append(widest)
                widest = 0
        hist.update(steps=steps, loop_s=time.perf_counter() - t_loop, median_step_s=statistics.median(times),
                    failed=int(drv.counts()[1]), captures=tr._step_fn.captures)
        close_feed(drv)
    with open(out, "w") as f:
        json.dump(hist, f)


def close_feed(drv) -> None:
    """Close a train driver's feed mid-epoch and wait for its decode threads:
    a daemon thread still compositing an item on the card when the
    interpreter exits aborts the process ("terminate called without an
    active exception")."""
    feed = drv.items.gi_frame.f_locals.get("self") if drv.items.gi_frame is not None else None
    drv.items.close()
    for t in getattr(feed, "_threads", ()):
        t.join()


def composite_copy(side: int = 540) -> dict:
    """11c: a frame composited at its own size (``snapshot_m3c_540``'s 540^2
    PNGs at 540^2): the kernel, its plain version on the card and the host
    path (``cv2.resize`` to the frame's size copies it) bit for bit, each
    the composite with no resample."""
    from gomavatar_tpu_torch.data.composite import composite_resize, composite_resize_plain
    from gomavatar_tpu_torch.data.dataset import TrainDataset

    rng = np.random.default_rng(CARD_DATA_SEED)
    img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
    mask = rng.integers(0, 256, (side, side), dtype=np.uint8)
    img[rng.random((side, side)) < 0.3] = 0
    mask[rng.random((side, side)) < 0.3] = 255
    bg = (rng.random(3) * 255.0).astype(np.float32)
    host = TrainDataset.__new__(TrainDataset)
    host.target_size = (side, side)
    rgb, m = host._composite_resize(img.astype(np.float32), mask / 255.0, bg)
    rgb, m = (rgb / 255.0).astype(np.float32), m.astype(np.float32)
    a = mask / 255.0
    plain_comp = ((a[..., None] * img.astype(np.float32) + (1.0 - a[..., None]) * bg) / 255.0).astype(np.float32)
    require(np.array_equal(rgb, plain_comp) and np.array_equal(m, a.astype(np.float32)),
            "11c: the host path at the frame's own size is not the composite with no resample")
    ti, tm = torch.from_numpy(img).cuda(), torch.from_numpy(mask).cuda()
    for label, (k_rgb, k_m) in (("kernel", composite_resize(ti, tm, bg, (side, side))),
                                ("plain", composite_resize_plain(ti, tm, bg, (side, side)))):
        require(np.array_equal(k_rgb.cpu().numpy(), rgb) and np.array_equal(k_m.cpu().numpy(), m),
                f"11c: the {label} composite at {side}^2 differs from the host's copy")
    print(f"  11c a {side}^2 frame at its own size: the kernel and its plain version bit-equal to the host's "
          f"cv2 copy, the composite with no resample")
    return {"side": side, "bit_equal": True}


def phase_card_data(card: str) -> dict:
    """Phase 11: 11a (:func:`card_composite`) on both train cells; 11b
    (:func:`budget_run_child`) in a child process that must exit with 0: no
    step of BUDGET_STEPS drops an entry; 11c (:func:`composite_copy`)."""
    import tempfile

    result = {"copy": composite_copy()}
    for name in CARD_DATA_CELLS:
        with tempfile.TemporaryDirectory() as tmp:
            drv = benchmark_cell(name, CARD_DATA_SEED, tmp)
            result[name] = card_composite(drv)
            del drv
            torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    out = os.path.join(here, "build", "smoke_budget_run.json")
    env = dict(os.environ, GOMAVATAR_DEBUG_BINNING="1")
    code = f"import chip_smoke; chip_smoke.budget_run_child({BUDGET_STEPS}, {CARD_DATA_SEED}, {out!r})"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=here, env=env, capture_output=True, text=True,
                          timeout=BUDGET_CHILD_TIMEOUT_S)
    require(proc.returncode == 0, f"11b: the {BUDGET_STEPS}-step run failed (exit {proc.returncode}):\n"
                                  f"{proc.stderr[-4000:]}")
    with open(out) as f:
        hist = json.load(f)
    require(hist["failed"] == 0, f"11b: {hist['failed']} steps dropped an entry or lost the loss")
    print(f"  11b {BUDGET_STEPS} steps of zju377.train from its state under GOMAVATAR_DEBUG_BINNING=1 in "
          f"{time.perf_counter() - t0:.1f} s: no drop; budget {hist['budget']}, widest splat "
          f"{max(hist['widest_per_10'])} tiles; capturing steps {hist['capture_step_s']} s against a median "
          f"{hist['median_step_s']:.4f} s ({card})")
    result["budget_run"] = hist
    return result


# ---- phase 12: the LPIPS distance head -------------------------------------------

# (trunk, image side, float32 trunk, channels-last taps): the train and pose
# steps' taps at the two recipes' frames, the PeopleSnapshot metric's AlexNet
# taps (odd sizes), the float32 trunk of 5e and 10b; each in the NCHW layout
# and channels-last, the trunk's on the card
HEAD_CASES = tuple((t, s, f, nhwc) for nhwc in (False, True)
                   for t, s, f in (("vgg", 512, False), ("vgg", 544, False), ("vgg", 540, False), ("alex", 512, False),
                                   ("vgg", 512, True)))
# (trunk, image side) of the whole LPIPS loss timed in both layouts
TRUNK_CASES = (("vgg", 512), ("vgg", 544), ("vgg", 540), ("alex", 512))
# the two layouts' bfloat16 LPIPS loss on the card (cuDNN picks other
# algorithms in NHWC): the values' relative difference (the card-vs-CPU
# limit of 10b), and the channels-last input gradient's distance from the
# float32 trunk's at most this many times the NCHW one's (relative L2; both
# ~0.18 at VGG 544^2, 0.087 at AlexNet 512^2, as far apart as max-pool ties
# in bfloat16 take them: 0.05-0.08 of the norm)
TRUNK_VALUE_RTOL, TRUNK_GRAD_RATIO = 1e-2, 1.1
HEAD_SEED, HEAD_REPLAYS = 12, 50
# the kernel's value against the plain head's on the card, relative
HEAD_VALUE_RTOL = 1e-5
# float32 taps: each gradient element within this share of the largest
HEAD_F32_GRAD_TOL = 1e-5
# bfloat16 taps: each gradient element within one bfloat16 ulp of the plain
# path's, plus 2^-16 of the float32 envelope of its terms, rp G_c + rp^3
# |fp_c| sum_j G_j |fp_j| with G_c = 2 max(w_c, 0) (|fp_c| rp + |fg_c| rg) /
# (h w): where terms cancel (fp_c rp against fg_c rg as the prediction nears
# the target, rp g_c against rp^3 fp_c S) both paths' float32 values carry
# the float32 rounding of the terms, which one ulp of the small result does
# not cover
HEAD_F32_ENV = 2.0 ** -16


def head_images(side: int, seed: int = HEAD_SEED):
    """(pred, gt) (side, side, 3) in [-1, 1] on the card: a textured target
    (seeded noise at two scales, a flat patch) and the prediction within a
    few levels of it."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    base = torch.rand((1, 3, side // 16, side // 16), generator=g)
    fine = torch.rand((1, 3, side // 2, side // 2), generator=g)
    img = (torch.nn.functional.interpolate(base, size=(side, side), mode="bilinear", align_corners=False) * 0.7
           + torch.nn.functional.interpolate(fine, size=(side, side), mode="nearest") * 0.3)
    img[..., : side // 4, : side // 4] = 0.0  # a flat black patch
    gt = (img[0].permute(1, 2, 0) * 2.0 - 1.0).clamp(-1.0, 1.0)
    pred = (gt + 0.02 * torch.randn(gt.shape, generator=g)).clamp(-1.0, 1.0)
    return pred.cuda(), gt.cuda()


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The distance of two bfloat16 tensors in bfloat16 steps (0 and -0 equal)."""
    def key(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)

    return (key(a) - key(b)).abs()


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """The bfloat16 spacing at |v| (bfloat16 values), in float64."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float64), (e - 8).to(torch.float64)).clamp_min(2.0 ** -133)


def head_grad_f64(fp, fg, head):
    """(gradient, envelope) of the head in ``fp`` in float64 for an upstream
    1: rp g_c - rp^3 fp_c S, and HEAD_F32_ENV's envelope of its terms."""
    x, y = fp.detach().double(), fg.double()
    w = head.detach().reshape(1, -1, 1, 1).double().clamp_min(0.0)
    rp = 1.0 / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-20)
    rg = 1.0 / torch.sqrt((y * y).sum(dim=1, keepdim=True) + 1e-20)
    g = 2.0 * w * (x * rp - y * rg) / (x.shape[2] * x.shape[3])
    G = 2.0 * w * (x.abs() * rp + y.abs() * rg) / (x.shape[2] * x.shape[3])
    S = (g * x).sum(dim=1, keepdim=True)
    return rp * g - rp ** 3 * x * S, rp * G + rp ** 3 * x.abs() * (G * x.abs()).sum(dim=1, keepdim=True)


def head_graph(fn):
    """(graph, outputs, launches of the LPIPS head per replay) of ``fn()``
    captured after 3 warm-up calls on a side stream."""
    from gomavatar_tpu_torch.models.lpips import lpips_head

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph, before = torch.cuda.CUDAGraph(), lpips_head.launches
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out, lpips_head.launches - before


def head_case(trunk: str, side: int, f32: bool, nhwc: bool) -> dict:
    """One case of phase 12 (see the module docstring)."""
    from gomavatar_tpu_torch.models.lpips import (
        _alex_features,
        _vgg_features,
        head_plan,
        load_lpips,
        lpips_head,
        lpips_head_plain,
    )

    label = f"{trunk} {side}^2 {'float32' if f32 else 'bfloat16'} {'NHWC' if nhwc else 'NCHW'}"
    params = load_lpips(trunk, device="cuda", quiet=True)[0]
    heads = params["heads"]
    pred, gt = head_images(side)
    features = _alex_features if trunk == "alex" else _vgg_features
    layout = torch.channels_last if nhwc else torch.contiguous_format
    with torch.no_grad():
        f_p = [f.contiguous(memory_format=layout).requires_grad_() for f in features(params, pred, not f32)]
        f_g = [f.contiguous(memory_format=layout) for f in features(params, gt, not f32)]
    elem = f_p[0].element_size()
    shapes = [tuple(f.shape[1:]) for f in f_p]
    plans = [head_plan(f.shape[1], f.shape[2] * f.shape[3], elem, [f.data_ptr()], nhwc) for f in f_p]
    elements = sum(f.numel() for f in f_p)
    zero_px = sum(int((f.detach().float().abs().sum(dim=1) == 0).sum()) for f in f_p)

    def kernel_pair():
        v = lpips_head(f_p, f_g, heads)
        return (v, *torch.autograd.grad(v, f_p))

    def plain_pair():
        v = lpips_head_plain([f.float() for f in f_p], [f.float() for f in f_g], heads)
        return (v, *torch.autograd.grad(v, f_p))

    before = lpips_head.launches
    kern = [t.detach().clone() for t in kernel_pair()]
    eager_launches = lpips_head.launches - before
    plain = [t.detach().clone() for t in plain_pair()]
    torch.cuda.synchronize()
    require(all(bool(torch.isfinite(t).all()) for t in kern), f"12 {label}: non-finite kernel outputs")
    rel = abs(float(kern[0]) - float(plain[0])) / abs(float(plain[0]))
    out = {"taps": shapes, "tile_vec": plans, "elements": elements, "zero_feature_pixels": zero_px,
           "value": float(kern[0]), "plain_value": float(plain[0]), "value_rel": rel, "eager_launches": eager_launches}
    require(eager_launches == 3, f"12 {label}: {eager_launches} launches for one forward and backward")
    require(all(g.is_contiguous(memory_format=layout) for g in kern[1:]), f"12 {label}: gradients in another layout")
    require(rel <= HEAD_VALUE_RTOL, f"12 {label}: value {float(kern[0])!r} vs plain {float(plain[0])!r} ({rel:.3g})")
    if f32:
        worst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(kern[1:], plain[1:]))
        out["grad_worst_over_max"] = worst
        print(f"  12 {label}: value rel {rel:.3g}; gradient worst difference {worst:.3g} of the largest")
        require(worst <= HEAD_F32_GRAD_TOL, f"12 {label}: gradient {worst:.3g} of its largest apart from plain")
    else:
        ulps = [bf16_ulps(a, b) for a, b in zip(kern[1:], plain[1:])]
        out["grad_max_ulps"] = [int(u.max()) for u in ulps]
        out["grad_off_1ulp"] = [int((u == 1).sum()) for u in ulps]
        out["grad_over_1ulp"] = [int((u > 1).sum()) for u in ulps]
        print(f"  12 {label}: taps {shapes}, (tile, vec) {plans}; value {float(kern[0]):.7g} vs plain "
              f"{float(plain[0]):.7g} (rel {rel:.3g}); gradient ulps max {out['grad_max_ulps']}, one ulp off "
              f"{out['grad_off_1ulp']}, more {out['grad_over_1ulp']} of {elements}; {zero_px} all-zero pixels")
        out["grad_outside"], out["kernel_err_f64"], out["plain_err_f64"] = [], [], []
        for k, (a, b, fp, fg, head) in enumerate(zip(kern[1:], plain[1:], f_p, f_g, heads)):
            truth, env = head_grad_f64(fp, fg, head)
            outside = (a.double() - b.double()).abs() > bf16_ulp(torch.maximum(a.abs(), b.abs())) + HEAD_F32_ENV * env
            ek, ep = float((a.double() - truth).abs().max()), float((b.double() - truth).abs().max())
            out["grad_outside"].append(int(outside.sum()))
            out["kernel_err_f64"].append(ek)
            out["plain_err_f64"].append(ep)
            print(f"    tap {k}: {int(outside.sum())} past one ulp plus the float32 envelope; largest error against "
                  f"float64: kernel {ek:.3g}, plain {ep:.3g}, of the largest |grad| {float(truth.abs().max()):.3g}")
        require(not any(out["grad_outside"]), f"12 {label}: gradient elements past one bfloat16 ulp of plain and "
                                              f"the float32 envelope")

    graph, outs, per_replay = head_graph(kernel_pair)
    require(per_replay == 3, f"12 {label}: {per_replay} launches captured, not 3")
    graph.replay()
    first = [t.detach().clone() for t in outs]
    same = all(torch.equal(a, b) for a, b in zip(first, kern))
    for _ in range(HEAD_REPLAYS):
        graph.replay()
        same = same and all(torch.equal(a, b) for a, b in zip(outs, first))
    torch.cuda.synchronize()
    print(f"  12 {label}: {HEAD_REPLAYS} graph replays {'bit-equal' if same else 'APART'} (and to the eager call)")
    require(same, f"12 {label}: graph replays differ")
    kernel_ms = cuda_ms(graph.replay, KERNEL_ITERS)
    plain_graph, _, _ = head_graph(plain_pair)
    plain_ms = cuda_ms(plain_graph.replay, KERNEL_ITERS)
    # the bytes the pair must move: both images' taps read once forward, again
    # backward, the prediction's gradient written once
    nbytes = elements * elem * 5
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    print(f"  12 {label}: kernel pair {kernel_ms:.4f} ms, plain head {plain_ms:.4f} ms (graph replays, CUDA events), "
          f"bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
    del graph, plain_graph
    torch.cuda.empty_cache()
    return dict(out, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound, bytes=nbytes, replays_bit_equal=same)


def trunk_case(trunk: str, side: int) -> dict:
    """Phase 12's LPIPS loss of one step (see the module docstring) in the
    NCHW layout and channels-last: {layout: ms, layout kernels' ms}, and
    the two's differences."""
    from gomavatar_tpu_torch.models import lpips as LP

    label = f"{trunk} {side}^2"
    params = LP.load_lpips(trunk, device="cuda", quiet=True)[0]
    # the NCHW trunk's data: the float32 weights as loaded, cast per call
    nchw = {**params, "convs": [{"w": c["w"].contiguous(), "b": c["b"]} for c in params["convs"]]}
    pred, gt = head_images(side)
    out, results = {}, {}
    for name, p, rule in (("nchw", nchw, lambda device: False), ("nhwc", params, LP.channels_last)):
        x = pred.clone().requires_grad_()

        def loss_pair(p=p, x=x):
            v = LP.lpips(p, x, gt)
            return (v, *torch.autograd.grad(v, x))

        program_rule, LP.channels_last = LP.channels_last, rule
        try:
            graph, outs, _ = head_graph(loss_pair)
        finally:
            LP.channels_last = program_rule
        graph.replay()
        torch.cuda.synchronize()
        results[name] = [t.detach().clone() for t in outs]
        ms = cuda_ms(graph.replay, KERNEL_ITERS)
        found, _ = layout_kernels(graph.replay)
        out[name] = {"ms": ms, "layout_kernels_ms": found}
        print(f"  12 LPIPS loss {label} {name.upper()}: forward and backward {ms:.4f} ms (graph replays, CUDA events); "
              f"cuDNN layout transposes {found or 'none'} (torch.profiler, ms a call)")
        del graph
    # the yardstick: the float32 trunk's value and input gradient
    x = pred.clone().requires_grad_()
    v32 = LP.lpips(params, x, gt, bf16=False)
    g32 = torch.autograd.grad(v32, x)[0]
    (v0, g0), (v1, g1) = results["nchw"], results["nhwc"]
    rel = abs(float(v1) - float(v0)) / abs(float(v0))
    grad_rel = float((g1 - g0).norm() / g0.norm())
    errs = {k: (abs(float(v) - float(v32)) / abs(float(v32)), float((g - g32).norm() / g32.norm()))
            for k, (v, g) in results.items()}
    out.update(value_rel=rel, grad_rel=grad_rel, vs_float32=errs)
    print(f"  12 LPIPS loss {label}: NHWC against NCHW value rel {rel:.3g}, input gradient {grad_rel:.3g} of its norm; "
          f"against the float32 trunk's: " + ", ".join(f"{k.upper()} value {e[0]:.3g}, gradient {e[1]:.3g}"
                                                      for k, e in errs.items())
          + f"; {out['nchw']['ms'] - out['nhwc']['ms']:.4f} ms saved")
    require(rel <= TRUNK_VALUE_RTOL, f"12 LPIPS loss {label}: the layouts' values disagree")
    require(errs["nhwc"][1] <= TRUNK_GRAD_RATIO * errs["nchw"][1],
            f"12 LPIPS loss {label}: the channels-last input gradient lies farther from the float32 trunk's")
    require(not out["nhwc"]["layout_kernels_ms"], f"12 LPIPS loss {label}: the channels-last trunk transposes")
    torch.cuda.empty_cache()
    return out


def phase_lpips_head(card: str) -> dict:
    """Phase 12: :func:`head_case` for each of HEAD_CASES, then
    :func:`trunk_case` for each of TRUNK_CASES."""
    print(f"[12] the LPIPS head kernel against lpips_head_plain on the card ({card})")
    out = {f"{t} {s} {'f32' if f else 'bf16'} {'nhwc' if n else 'nchw'}": head_case(t, s, f, n)
           for t, s, f, n in HEAD_CASES}
    out["loss"] = {f"{t} {s}": trunk_case(t, s) for t, s in TRUNK_CASES}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    import faulthandler

    from gomavatar_tpu_torch import cuda_build

    # a crash still leaves every line printed before it, and the Python stack
    sys.stdout.reconfigure(line_buffering=True)
    faulthandler.enable()
    # one cuBLAS workspace config for every phase and every spawned rank,
    # set before cuBLAS starts: torch's deterministic algorithms (4c's
    # listing, 4d's timing) need it, and every other step runs under it alike
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    def done(phase, t0):
        print(f"  phase {phase}: {time.perf_counter() - t0:.1f} s")

    # ---- 1. build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"[1] built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]  # the mangled kernel name
            elif "registers" in line or ("spill" in line and " 0 bytes spill stores" not in line) or "error" in line.lower():
                print(f"  {name}: {entry}: {line.strip()}")
    done(1, t0)

    t0 = time.perf_counter()
    trained, b1 = phase_kernels_b1(card)
    done(2, t0)
    t0 = time.perf_counter()
    b1_launches, fwd = phase_eval_path(trained, card)
    done(3, t0)
    t0 = time.perf_counter()
    train_kernels = phase_train_kernels(trained)
    done("4a", t0)
    t0 = time.perf_counter()
    train_launches, train = phase_train_path(trained, card)
    done("4b-4d", t0)
    t0 = time.perf_counter()
    drivers = phase_drivers()
    done(5, t0)
    t0 = time.perf_counter()
    pose, animate = phase_pose_animate(f"{DRIVER_DIR}/exp.yaml", trained)
    done(6, t0)
    t0 = time.perf_counter()
    parallel = phase_parallel(trained, train["median_ms"], fwd["median_ms"], f"{DRIVER_DIR}/exp.yaml", card)
    done(7, t0)
    t0 = time.perf_counter()
    e2e = phase_e2e()
    done(8, t0)
    t0 = time.perf_counter()
    draws = phase_seeded_draws()
    done(9, t0)
    t0 = time.perf_counter()
    calibrated = phase_calibrated_lpips(trained, f"{DRIVER_DIR}/exp.yaml", card)
    done(10, t0)
    t0 = time.perf_counter()
    card_data = phase_card_data(card)
    done(11, t0)
    t0 = time.perf_counter()
    lpips_head = phase_lpips_head(card)
    done(12, t0)

    measured = {"B1": dict(b1, launches=b1_launches["B1"])}
    for k in ("B2", "B3", "B4", "B5"):
        measured[k] = dict(train_kernels[k], launches=train_launches[k])
    # B1-B4 are two kernels each: their launches are their parts' (counted
    # where each part launches), B3's time the sum of its parts', B1's, B2's
    # and B4's the time of their whole wrapper
    for k, launches in (("B1", b1_launches), ("B2", train_launches), ("B3", train_launches),
                        ("B4", train_launches)):
        for part, m in measured[k]["parts"].items():
            m["launches"] = launches[part]
    result = {"kernels": []}
    for k, (name, source, replaces) in KERNELS.items():
        m = measured[k]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": m["launches"],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": None,
        }
        if "parts" in m:
            entry["parts"] = m["parts"]
        entry["parallel_launches"] = parallel_launches(k, parallel["launches"])
        entry["e2e_launches"] = e2e_launches(k, e2e)
        entry["sweep_launches"] = sum(draws["9d"]["launches"][q] for q in ([k] if k == "B5" else [f"{k}a", f"{k}b"]))
        entry["calibrated_launches"] = calibrated_launches(k, calibrated)
        result["kernels"].append(entry)
    print(json.dumps({"lpips_head": lpips_head}))
    print(json.dumps({"card_data": card_data}))
    print(json.dumps({"calibrated_lpips": calibrated}))
    print(json.dumps({"seeded_draws": draws}))
    print(json.dumps({"e2e": e2e}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"pose": pose, "animate": animate}))
    print(json.dumps({"drivers": drivers}))
    print(json.dumps({"forward": fwd}))
    print(json.dumps({"train_step": train, "seconds": time.perf_counter() - t_start}))
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
