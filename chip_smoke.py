#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``vgd_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--report PATH]
                          [--only k1|attn|k4|k5|k6|eeg|fid|export|dp|mp|cli|
                                  scan|data]

1. builds the port's kernels from the checkout's sources (CUDA with nvcc
   for sm_90a, one process per source, all at once);
2. holds every kernel against its plain PyTorch version on the card at
   every shape its main path gives it, with the tolerance stated below, and
   times kernel, plain version, and the one PyTorch call that computes the
   same function (timed here only, never called by the port) on device
   time: a CUDA graph of N calls replayed between CUDA events (or, where a
   graph cannot capture a function, its kernels' profiler time), median
   and p90 of TIMING_REPEATS, the functions in turns; the old call time
   (host work between launches included) is printed beside it. K2
   (training attention: forward with logsumexp, dq, dk/dv; all bit-equal
   over two calls; K2 and the plain full-matrix attention under autograd at
   each site, which decides the size gate), K3 (serving attention, bit-equal
   over two calls), K4 (GroupNorm+SiLU with the casts and the residual add
   around it) at the 256x256, batch-16 DDPM UNet's shapes in its f32 form
   and in the fused UNet's two bf16 forms (each with its plan, bit-equal
   over two calls, timed against its bound; the f32 form also against
   ``F.group_norm`` + ``F.silu`` on the NCHW view and on an NCHW copy),
   ragged and streamed shapes checked; K1 (Conv4x4 stride 2 + batch statistics) at the 256x256,
   batch-64 VAE-GAN's nine shapes, the 64x64 batch-64 VAE's four, the
   64x64 batch-128 DCGAN's three and the 64x64 batch-64 VAE-GAN's seven
   (the VAE's encoder, the DCGAN's discriminator stages at batch 64) in
   bf16 (each with its plan, bit-equal
   over two calls, its kernels' times by stage and other plans timed
   beside it; then a decision line at the odd 127x127 enc1, which the
   reference's gate sends to XLA, and at each 64x64 shape: the port has no
   K1 size gate while K1 is no slower than cuDNN + var_mean), one f32
   shape and two ragged ones; K5
   (step 7); K6 (step 8); ``--only`` runs one kernel's checks alone;
3. DDPM: holds the fused UNet forward and one training-form train step
   (loss and every gradient) against the same weights run with no kernel at
   all (``kernels.plain_reference``), and profiles both by kernel group;
4. DDPM: trains at full width (256x256, batch 16, base_ch 64, T=1000, bf16
   convs) through ``run_diffusion``'s per-step loop (``epoch_scan=False``,
   as every phase that wraps ``train_step`` runs it; step 17 holds the
   scan to it) on synthetic faces: 2 epochs of 8 steps,
   a checkpoint per epoch, a resume that must restore exactly what was
   saved, and a third epoch. Every train step must launch K2 once of each
   kind (forward, dq, dk/dv) per attention past ``kernels.attention``'s
   size gate (3: the port gates at N * M < 2^18, so cross_attn2,
   cross_attn3 and the bottleneck all run K2), every validation forward as
   many K2 forwards, and K3/K4 never;
5. DDPM: serves that trained checkpoint: ``sample_from_dir`` answers a
   16-image DDIM-50 request and ``evaluate_diffusion`` restores one batch
   through the ancestral chain, with exactly 3 (K3) and 14 (K4) launches
   per UNet forward and no K2 launch;
6. VAE-GAN (256x256, batch 64, latent 100, ngf = ndf = 64, bf16 convs,
   ``fused_conv=True``): the first D step's and the G step's losses and
   gradients with K1 against the same state and draws with no kernel (in
   f32 at the DDPM step's bounds; in bf16 against the measured noise floor
   of the no-kernel step itself, the median over three perturbation
   seeds), the shapes K1 sees against its table,
   one train step profiled; then
   ``run_vaegan`` on 640 synthetic faces (576 train / 64 val), 2 epochs of
   9 steps, a resume that must restore params, BN buffers, the three Adam
   states and the generator exactly, and a third epoch, with exactly 33 K1
   launches per train step and none in validation or ``generate``; then
   ``sample_from_dir("vaegan", n=64)`` serves that checkpoint with no K1
   launch;
7. Glow (64x64, batch 16, K=32, L=4, width 512, bf16 couplings,
   ``fused_coupling=True``): K5 (the coupling network's forward, backward 1
   and backward 2) against its plain versions at the four block shapes,
   one f32 shape and two ragged ones, timed against the cuDNN conv chain;
   one train step's loss and gradients with K5 against no kernel (f32 at
   the DDPM step's bounds, bf16 against the measured noise floor), profiled;
   ``run_glow`` on 400 synthetic faces, 2 x 10 iterations with a grid and a
   checkpoint every 10, an exact resume and 10 more iterations from the
   right stream batch, with exactly 128 K5 launches of each kind per train
   step, 128 forwards per ``init_step`` and per ``reverse``, and no K1-K4;
   then ``sample_from_dir("glow")`` and ``evaluate_glow_from_dir`` serve the
   checkpoint;
8. Glow with ``flow_stack=True`` (the same model, ``fused_coupling=True``
   for the ActNorm init and the reverse): K6 (forward with and without
   saves, backward: one launch per block) against its plain versions at the
   four block shapes in bf16, one f32 shape, two ragged ones and the EEG
   variant's (3, 1) kernel, the no-save forward bit-equal to the saving
   one and the backward bit-equal run to run, each with its plan
   (``kernels.flow_stack_plan``) and grid syncs per flow (at most
   K6_MAX_SYNCS), timed against the per-flow path of the same block (K5,
   and the cuDNN conv chain), with the kernels' stage times (their own
   device clock) and a probe's cost of one grid sync; one train step
   against no kernel (as step 7), profiled, and the same step timed on the
   per-flow path and with ``flow_stack=256``; ``run_glow`` as in step 7
   with exactly 4 + 4 K6 launches and no K5 per train step, 128 K5
   forwards per ``init_step`` and per ``reverse``; then the checkpoint's
   likelihood (``GlowTrainer.forward``: 4 no-save launches, bits/dim
   against no kernel) and ``sample_from_dir("glow")``;
9. the denoising VAE (64x64, batch 64, latent 100, ngf 64, bf16,
   ``fused_conv=True``): one train step's losses and every gradient with
   K1 against no kernel (f32 and bf16 bounds as in step 6), with the
   fixed-std noise and with occlusion corruption, one step timed and
   profiled; ``run_vae`` on 640 synthetic faces, 2 epochs of 9 steps, an
   exact resume and a third epoch, with exactly 4 K1 launches per train
   step and none in validation, ``denoise`` or ``generate``; then on that
   checkpoint ``evaluate_vae_checkpoints``, ``evaluate_vae_occlusion``,
   ``sample_from_dir("vae")`` and ``denoise_images`` on 16 images;
10. DCGAN and WGAN (64x64, batch 128, ngf = ndf = 64, bf16,
   ``fused_conv=True``): each step's first D step and G step against no
   kernel as in step 9, a whole step timed and profiled (K1 9 launches a
   DCGAN step, 33 a WGAN step; after a WGAN step every D parameter within
   +-0.01); ``run_gan`` for DCGAN (2 epochs of 4 steps, an exact resume, a
   third) and WGAN (1 epoch of 2 steps, an exact resume, a second); then
   ``evaluate_gan_checkpoints`` and ``sample_from_dir`` for both;
11. EEG Glow (22 channels x 160 samples, batch 16, K=32, L=4, width 512,
   f32, synthetic trials; no kernel, as the reference's EEG trainer sets
   neither ``fused_coupling`` nor ``flow_stack``): one train step's loss
   and every gradient on the card against the same step of the port on
   the CPU (same weights, batch and noise; the DDPM step's f32 bounds), the
   step timed and profiled; ``run_glow_eeg`` for both event types, 10
   iterations with a dump and a checkpoint every 5, an exact resume and 5
   more from the right stream batch; ``eeg_psd_and_gif`` (the mu-band power
   of the real and generated central PSD), ``sample_from_dir("glow-eeg")``
   and the ``tstr`` command for every regime (the real regime's test
   accuracy in (0.5, 1]); no kernel launch in the phase;
12. InceptionV3 (the FID variant, 299x299, f32, seeded weights): every tap
   on the card within 1e-3 of its max against the CPU on 8 images, the FID
   of two fixed 72-image feature sets card vs CPU, a batch of 64 timed
   (with TF32 beside it, time and error); then ``evaluate_diffusion_from_dir``
   (K3 / K4), ``evaluate_glow_from_dir`` (K5 forward),
   ``evaluate_gan_checkpoints`` and ``evaluate_vae_checkpoints`` with the
   Inception ``feature_fn`` on their phases' checkpoints, one val batch
   each, their kernel launches exactly those of the same evaluation
   without it;
13. the serving export (``io/export.py``) and the real-image data path:
   (a) the trained DDPM checkpoint exported as ``diffusion`` DDIM-50,
   n=16, loaded afresh on the card and served with exactly 3 K3 and 14 K4
   launches a step forward (150 / 700 a request) and no K2, held against
   the eager ``ddim_sample`` on the same draws; (b) the fused-coupling Glow
   checkpoint as ``sample``, n=16: 128 K5 forwards a request, held against
   the eager ``reverse``; (c) the VAE checkpoint as ``denoise`` with a
   symbolic batch: B=3 and B=64 from one file, and the same file loaded on
   the CPU held against the card (CANARY_ATOL, CANARY_MEAN); each with
   export seconds, artifact MB, load seconds and the request time against
   eager (median of EXPORT_REPEATS); (d) 640 JPEGs of synthetic faces at
   CelebA's aligned 178x218, ``run_vaegan`` at 256x256, B=64 from that
   folder (decode rate, step ms), and a second run that must open the
   cache and decode nothing.
   ``--only export`` seeds the three checkpoints where none exist;
14. data and sequence parallelism across processes, and Glow ``remat``
   (``--only dp``; in the full run right after the build, before the
   phases above fill this process's share of the card): (a) ``run_diffusion`` at 256x256, B=16, 3 steps, twice
   with no process group and once as a world of one process on NCCL (the
   start-up of ``parallel/launch.py``): bit-equal, or (the card's backward
   adds with atomics, so two runs need not agree) its first loss, made
   before any backward, bit-equal and the rest within the DDPM step's
   1e-3 or DP_SPREAD_X times the two no-group runs' own spread, with
   3/3/3 K2 a step; (b)-(d) two rank processes on this one card over gloo
   (collectives staged through host memory: this measures correctness and
   collective overhead, not scaling): ``run_diffusion`` data-parallel,
   ``run_diffusion`` sequence-parallel (data=1, model=2: the bottleneck on
   the ring, 2/2/2 K2 a step), ``run_vaegan`` at 256x256, global B=64 with
   K1 (33 a step a rank), ``run_glow`` at 64x64, global B=16 with K5 (128
   of each a step a rank) and with ``flow_stack`` (4 + 4 K6 a step); after
   every step both ranks bit-equal; the first step's losses against one
   process at the same global batch (the DDPM step's 1e-3; JAX's 1e-4 for
   the ring; the bf16 VAE-GAN also 3 x the median of its own one-ulp
   floor); the sequence-parallel run's sampling forward (2 K3, 14 K4)
   within UNET_REL_TOL of one process's on the same weights; (e) one Glow
   step's gradients with and without ``remat``, on K5 (256 forwards a
   remat step) and on the stock chain: bit-equal, or within DP_SPREAD_X
   times the step's own spread or REMAT_GRAD_REL of the largest gradient;
   each form's step time and peak memory;
15. Glow's model parallelism (``--only mp``; in the full run right after
   step 14), two rank processes on this card over gloo at the full Glow
   width (64x64, global B=16, K=32, L=4, width 512, bf16), 3 iterations
   each: K5 against its plain versions at the pipeline's microbatch
   shapes (8 rows of each block); (a) ``run_glow --pp-stages 2
   --fused-coupling`` (GPipe over the flow chain, 2 microbatches): exactly
   128 K5 forwards, 128 backward 1 and 128 backward 2 a rank a step, plus
   the ActNorm init's 128 forwards on every rank and rank 0's sample grid;
   (b) ``run_glow --mesh-model 2`` on the stock chain (coupling filters
   sharded: 256 of conv1's 512 a rank), no K5 or K6; (a) and (b) both ranks
   bit-equal after every step (b: the state gathered from both), the first
   step's losses against one process at the same global batch within
   MP_LOSS_REL or DP_SPREAD_X times the median over FLOOR_SEEDS of that
   one-process run's own floor (its first losses with every coupling
   output perturbed by one f32 ulp), whichever is larger; (c) ``run_glow_eeg --mesh-model 2`` at the reference width in
   f32, its first losses within MP_EEG_REL of one process; (d) a model
   axis with ``--fused-coupling`` or ``--flow-stack`` refused before any
   training; each run's step ms a rank beside one process's, and its peak
   memory;
16. the command line (``--only cli``, which first holds K1 at the 64x64
   VAE-GAN's shapes; in the full run after step 13): the documented
   commands through ``vgd_tpu_torch.cli.main`` as a user types them, with
   ``--device cuda`` at full model width on synthetic faces and trials
   (only steps, --dataset-size and -n small), each command's rc, seconds,
   step ms, images/s, launches and peak memory on a ``[cli]`` line, every
   SystemExit or exception a failure (the VAE-GAN and DDPM training
   commands with ``--no-epoch-scan``: the phase wraps ``train_step``, and
   step 17 runs the scan): (a) the VAE-GAN at its default
   64x64, B=64 with --fused-conv, exactly K1_VAEGAN64_PER_STEP (23) K1 a
   train step, a ``--resume`` whose first step starts from the saved state
   exactly, ``sample``, and the run without the flag (no K1); (b) DDPM
   ``--no-attn``: no K2 in training, its fused forward within UNET_REL_TOL
   of no kernel, DDIM-50 ``sample`` and ``eval-diffusion`` with no K3 and
   exactly CLI_K4_PER_FORWARD (14) K4 a forward; (c) Glow with
   --fused-coupling (128 K5 of each kind a step, 128 forwards an init and
   a reverse), resumed exactly, ``sample --temperature 0.5`` bit-equal to
   ``sample_from_dir`` at 0.5 and unlike the 0.7 grid, ``eval-glow``, and
   JAX's ``glow --epochs 1 --steps-per-epoch 3 --iters 2`` (2 iterations);
   (d) EEG Glow, its sample and ``eval-eeg``; (e) the default DDPM (K2 3
   of each kind a step and a validation forward's, K3 3 and K4 14 a
   serving forward), VAE, DCGAN and WGAN (no kernel) with ``sample`` and
   ``eval-*``, ``denoise`` on a folder of four JPEGs, ``export --family vae
   --mode denoise --poly-batch`` and ``infer`` on it;
17. the epoch scan (``--only scan``, which builds K1 and K2; in the full
   run right after step 15, before the phases that leave memory held):
   seven cells, vaegan-64 (``VAEGANConfig``'s 64x64, B=64) with
   --fused-conv and without, vaegan-256 (the flagship, K1), ddpm-256 with
   attention, vae-64, gan-64 and wgan-64 with --fused-conv, all bf16.
   (a) Lockstep: SCAN_STEPS steps from one initial state and generator
   through the per-step loop twice (the floor) and through a
   ``StepGraph`` (WARMUP_STEPS eager steps, one capture, replays); every
   parameter, BN buffer and Adam moment against its own change from the
   initial state, bit-equal where the per-step loop repeats itself (one
   seed), else within SCAN_FLOOR_X times the median floor over FLOOR_SEEDS,
   parameter elements whose first-update gradient is rounding left out
   and counted; there two broken scans (Adam's count frozen at the
   capture, the generator put back before each replay) must fail that
   bound, and a third (a stale batch slot) is reported; the generator
   state bit-equal, each
   path's launches exactly SCAN_STEPS times a step's; (b) K1 / K2 (their
   CUDA functions) in a profiler trace of one replay; (c) both loops
   through ``run_*``: step ms (the median period of consecutive steps
   after the scan's warm-up and capture), images/s, the busy share of a
   profiler trace of steps SCAN_PROFILE_STEPS, peak memory, launches, and
   (``--only scan`` alone) on three 64x64 cells the per-step loop with
   Adam capturable and not;
   (d) a scan run resumed after its first epoch against a straight one
   (within the lockstep's bound, generator bit-equal; not vaegan-256);
   then (e) each family's training command through ``cli.main`` on the
   scan path, and ``vaegan --debug-nans``, which trains step by step;
   (f) one process as a world of one on NCCL: the scan bit-equal to the
   per-step loop with the collectives captured; (g) two ranks on the card
   over gloo: ``epoch_scan=True`` refused, the default trained step by
   step;
18. the native batch gather (``vgd_tpu_torch/data/native.py``, built by
   the host C++ compiler at the phase's start) and the pinned staging of
   both epoch loops (``--only data``, which builds no CUDA source up front;
   in the full run right after step 17), on memmaps the phase writes:
   7680 faces at 256x256 (1.51 GB, the decode cache of a folder of empty
   JPEG names) and 30720 at 64x64. (b) ``run_vaegan`` at 256x256, B=64
   with K1 on the default scan from the memmap, 2 epochs of 84 steps
   (chunks of 21): step ms, busy share of a traced chunk, peak, exactly
   K1_PER_STEP K1 a step, finite losses, each epoch's start gap (CUDA
   events from entering the epoch to its first step) and the gather ms of
   each chunk, beside the synthetic vaegan-256 scan cell (step 17's row;
   ``--only data`` runs that cell and the same memmap run with the
   parent's staging: numpy gathers, ``np.stack``, ``pin_memory()``, two
   chunks in flight); (a) the scan's chunk at 64x64 (341 x 64) and
   256x256 (21 x 64), staged natively into a pinned buffer (one call a
   chunk, as the scan does, and one a batch on the threads of a batch's
   bytes, as the per-step loop does), by numpy gathers, by numpy +
   ``np.stack`` + ``pin_memory()`` and by numpy + ``pin_memory()`` a batch
   (the parent's two loops): host ms and GB/s each, the native bytes equal
   to numpy's, the H2D copy ms, and the chunk's device time (``--only
   data`` adds a batch a call at 1 to 8 threads); (c) the batch-identity
   check: a probe ``StepGraph`` whose step spins ~10 ms on the card and
   records each row of its batch dotted with fixed weights (f64, exact)
   runs 84 steps (two turns of the two-buffer ring) through
   ``_train_epoch``; every step's record must equal the rows the loader
   chose for it, at B=64, at DDPM's B=16, on the per-step loop and as
   rank 1 of a data axis of 2; and three broken stagers must be caught at
   B=64: a ring buffer refilled without waiting on its copy's event, a
   buffer filled on its first turn only, and step 17's stale batch slot;
   (d) ``--only data`` only: the per-step loops of vae-64, gan-64 and
   wgan-64 (step 17's cells) with the parent's staging and the loop's, in
   the order parent, change, change, parent: step ms and busy share;
19. prints a ``{"kernels": [...]}`` line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when no card is visible, when the
port cannot be imported, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16
# and TF32 dense on the tensor cores, HBM3
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
# an f32-accurate product on the tensor cores takes three TF32 passes
# (hi hi + hi lo + lo hi), so the attention kernels' bound by operations is
# 3 x operations / 495 TFLOP/s; the 67 TFLOP/s CUDA-core figure stands
# beside it
F32_TC_FLOPS = TF32_FLOPS / 3
# kernel rows: device time, median and p90 over TIMING_REPEATS replays of a
# CUDA graph of about GRAPH_BUDGET_MS of calls (at most GRAPH_CALLS)
TIMING_REPEATS, GRAPH_BUDGET_MS, GRAPH_CALLS = 5, 10.0, 20

# K2 and K3 at 256x256, B=16: (name, B, N, M, D), once per UNet forward
# (K3, serving) or train step (K2)
ATTN_SHAPES = [("cross_attn2", 16, 16384, 64, 256),
               ("cross_attn3", 16, 4096, 64, 256),
               ("attn_bottleneck", 16, 1024, 1024, 256)]
# ragged shapes the kernels mask (checked, not timed)
ATTN_RAGGED = [("ragged", 3, 1000, 70, 256), ("ragged", 2, 129, 33, 128)]
# K4 at 256x256, B=16: (B, H, W, C, calls per UNet forward: half of them
# gn1's, half gn2's)
GN_SHAPES = [(16, 256, 256, 64, 4), (16, 128, 128, 128, 2),
             (16, 64, 64, 256, 2), (16, 32, 32, 256, 2),
             (16, 64, 64, 128, 2), (16, 128, 128, 64, 2)]
# f32 on both sides; the kernels sum in another order (online softmax,
# chunked group statistics), so they agree to a few f32 ulps of O(1) values
ATTN_ATOL = 1e-4
GN_ATOL = 1e-4
# K2 in f32: o and lse as K3; dq, dk and dv relative to max |.| of the
# plain result, since dk/dv sum over up to 16384 q rows
K2_GRAD_REL = 1e-4
# fused vs plain UNet at full width in bf16: a bf16 rounding that flips on a
# 1-ulp f32 difference propagates, so the bound is relative to the output
UNET_REL_TOL = 2e-2
# one train step, K2 vs no kernel, same weights / batch / t / noise: the
# convs run in bf16 on both sides, and an f32-ulp difference of the
# attention output can flip the bf16 rounding of its projection input (one
# bf16 ulp is 2^-8 = 3.9e-3 relative), which the backward carries through
# ~20 layers; so each gradient is held to 5e-2 of its tensor's max |g|,
# plus 1e-4 of the model's largest |g| for tensors whose gradient is ~0
# (the key biases, which softmax ignores), and the loss to 1e-3 relative
STEP_GRAD_REL, STEP_GRAD_FLOOR, STEP_LOSS_REL = 5e-2, 1e-4, 1e-3
# training run: 200 synthetic faces -> 180 train / 20 val, so the second
# val batch holds 4 true rows and 12 padded repeats
TRAIN_DATASET, TRAIN_STEPS, TRAIN_EPOCHS = 200, 8, 2

# K1 at 256x256, B=64, ngf = ndf = 64: (site, B, H, W, Cin, K, padding,
# launches per train step): each encoder layer runs in the recon0 and the G
# step forwards, each fused discriminator layer in 2 x 2 D-step forwards and
# the G step's
K1_SHAPES = [("enc0", 64, 256, 256, 3, 32, 0, 2),
             ("enc1", 64, 127, 127, 32, 64, 0, 2),
             ("enc2", 64, 62, 62, 64, 128, 0, 2),
             ("enc3", 64, 30, 30, 128, 256, 0, 2),
             ("dis1", 64, 128, 128, 16, 32, 1, 5),
             ("dis2", 64, 64, 64, 32, 64, 1, 5),
             ("dis3", 64, 32, 32, 64, 128, 1, 5),
             ("dis4", 64, 16, 16, 128, 256, 1, 5),
             ("dis5", 64, 8, 8, 256, 512, 1, 5)]
K1_PER_STEP = sum(s[-1] for s in K1_SHAPES)          # 33
# K1 at the denoising VAE (64x64, B=64, latent 100): its encoder's four
# layers, each once per train step (the train forward; validation, denoise
# and generate run in eval mode)
K1_VAE_SHAPES = [("enc0", 64, 64, 64, 3, 32, 0, 1),
                 ("enc1", 64, 31, 31, 32, 64, 0, 1),
                 ("enc2", 64, 14, 14, 64, 128, 0, 1),
                 ("enc3", 64, 6, 6, 128, 256, 0, 1)]
# K1 at DCGAN / WGAN (64x64, B=128, ndf 64): the discriminator's stages
# i > 0, each in a DCGAN step's three D forwards (real, fake, the G step's);
# a WGAN step runs each in 2 x critic_iters + 1 = 11
K1_GAN_SHAPES = [("dis1", 128, 32, 32, 16, 32, 1, 3),
                 ("dis2", 128, 16, 16, 32, 64, 1, 3),
                 ("dis3", 128, 8, 8, 64, 128, 1, 3)]
# K1 at the VAE-GAN's default 64x64, B=64 (VAEGANConfig; the cli phase):
# the encoder's four layers (the VAE's shapes) in the recon0 and the G step
# forwards, and the discriminator's stages i > 0 (64 -> 32 -> 16 -> 8 -> 4:
# dis1-3, the DCGAN's at batch 64) in 2 x 2 D-step forwards and the G
# step's: 4 x 2 + 3 x 5 = 23 a step
K1_VAEGAN64_SHAPES = [s[:-1] + (2,) for s in K1_VAE_SHAPES] + \
    [(s[0], 64) + s[2:-1] + (5,) for s in K1_GAN_SHAPES]
K1_VAE_PER_STEP = sum(s[-1] for s in K1_VAE_SHAPES)  # 4
K1_GAN_PER_STEP = sum(s[-1] for s in K1_GAN_SHAPES)  # 9
K1_WGAN_PER_STEP = 11 * len(K1_GAN_SHAPES)           # 33
K1_VAEGAN64_PER_STEP = sum(s[-1] for s in K1_VAEGAN64_SHAPES)  # 23
# the main-path shapes of each family: (family, shapes, what one step is)
K1_FAMILIES = (("vaegan", K1_SHAPES, "one 256x256 batch-64 VAE-GAN step"),
               ("vae", K1_VAE_SHAPES, "one 64x64 batch-64 VAE step"),
               ("gan", K1_GAN_SHAPES, "one 64x64 batch-128 DCGAN step"),
               ("vaegan64", K1_VAEGAN64_SHAPES,
                "one 64x64 batch-64 VAE-GAN step (the cli phase)"))
# checked, not timed: one f32 shape and two ragged ones (odd sizes, Cin and K
# that no 16-byte vector divides)
K1_EXTRA = [("f32", 8, 64, 64, 32, 64, 1, "float32"),
            ("ragged", 3, 31, 29, 5, 7, 0, "bfloat16"),
            ("ragged", 2, 9, 13, 12, 20, 1, "bfloat16")]
# K1 against its plain version (bf16 operands upcast, f32 conv, TF32 off),
# the tolerances of tests/test_fused_conv.py: c within 1e-4 of max |c| (sums
# in another order), mean / var rtol 1e-4 atol 1e-5, y = bn_lrelu(c) within
# 1e-4 of max |y| + 1e-5
K1_C_REL, K1_STAT_RTOL, K1_STAT_ATOL, K1_Y_REL, K1_Y_ATOL = \
    1e-4, 1e-4, 1e-5, 1e-4, 1e-5
# VAE-GAN training run: 640 synthetic faces -> 576 train (9 batches of 64)
# and 64 val; 2 epochs, a resume, a third epoch
VAEGAN_DATASET, VAEGAN_STEPS, VAEGAN_EPOCHS = 640, 9, 2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, warmup=3, iters=20):
    """CUDA-event time of ``iters`` back-to-back calls over their count:
    the host work of each call counts where it leaves the device idle (the
    step and request times; for a kernel row, the old call time)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_timer(fn, calls):
    """A function timing one replay of a CUDA graph of ``calls`` calls of
    ``fn`` (ms per call), or None where ``fn`` cannot be captured."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # captured on the warm-up stream, whose K4 barrier words exist, so
        # the graph holds no zeroing of its own (kernels._k4_sync)
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError:                   # a capture error: time it otherwise
        torch.cuda.synchronize()
        return None

    def replay():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / calls
    return replay


def _profiler_timer(fn, calls):
    """A function returning the summed device time of the kernels of
    ``calls`` calls of ``fn`` (torch.profiler), ms per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def window():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(device_us(e) for e in prof.key_averages()
                   if "CUDA" in str(e.device_type)) / 1e3 / calls
    return window


def device_ms(fns, repeats=TIMING_REPEATS):
    """Device time per call of each function of ``fns`` (name -> fn), with
    no host time between launches: N calls (about GRAPH_BUDGET_MS of them)
    captured into a CUDA graph whose replay is timed with CUDA events, or,
    for a function a graph cannot capture, the summed device time of its
    kernels over N calls (torch.profiler). ``repeats`` times, the
    functions in turns (in order, then reversed: plain, kernel, kernel,
    plain). Returns name -> {"median", "p90" (nearest rank), "how"}."""
    import torch
    timers = {}
    for name, fn in fns.items():
        one = cuda_ms(fn, 1, 1)
        calls = max(1, min(GRAPH_CALLS, int(GRAPH_BUDGET_MS / max(one, 1e-3))))
        graph = _graph_timer(fn, calls)
        timers[name] = (graph, "graph") if graph else \
            (_profiler_timer(fn, calls), "profiler")
    samples = {name: [] for name in fns}
    order = list(fns)
    for r in range(repeats):
        for name in order if r % 2 == 0 else order[::-1]:
            samples[name].append(timers[name][0]())
    out = {}
    for name, vals in samples.items():
        vals.sort()
        out[name] = {"median": vals[len(vals) // 2],
                     "p90": vals[math.ceil(0.9 * len(vals)) - 1],
                     "how": timers[name][1]}
    return out


def time_row(row, kernel, plain, library=None, **others):
    """Device times (``device_ms``) of one kernel row, in turns: its plain
    version, the kernel, the library call and ``others`` (more yardsticks,
    under their names); median under each name, p90 under name + "_p90".
    Beside them the kernel's old call time (``call_ms``: CUDA events around
    20 back-to-back wrapper calls, host work between launches included)."""
    fns = {"plain_ms": plain, "ms": kernel}
    if library is not None:
        fns["library_ms"] = library
    fns.update(others)
    times = device_ms(fns)
    for key, t in times.items():
        row[key], row[key + "_p90"] = t["median"], t["p90"]
    row["timing"] = {key: t["how"] for key, t in times.items()}
    row["call_ms"] = cuda_ms(kernel)
    row.setdefault("library_ms", None)
    return row


def check_attention(K, gen, dev, failures):
    import torch
    import torch.nn.functional as F
    rows = []
    for name, b, n, m, d in ATTN_SHAPES + ATTN_RAGGED:
        q = torch.randn(b, n, d, device=dev, generator=gen)
        k = torch.randn(b, m, d, device=dev, generator=gen)
        v = torch.randn(b, m, d, device=dev, generator=gen)
        scale = 1.0 / math.sqrt(d)
        out = K.flash_attention(q, k, v, scale)
        same = torch.equal(out, K.flash_attention(q, k, v, scale))
        torch.cuda.synchronize()
        ref = K.attention_plain(q, k, v, scale)
        err = float((out - ref).abs().max())
        row = {"shape": [b, n, m, d], "site": name, "max_abs_err": err,
               "max_rel_err": err / float(ref.abs().max()), "tol": ATTN_ATOL,
               "bit_equal_over_two_calls": same}
        if not err <= ATTN_ATOL:
            failures.append(f"flash_attention {name} {row['shape']}: "
                            f"max abs err {err} > {ATTN_ATOL}")
        if not same:
            failures.append(f"flash_attention {name} {row['shape']}: not "
                            f"bit-equal over two calls")
        if name != "ragged":
            flops = 4.0 * b * n * m * d
            nbytes = 4.0 * (2 * b * n * d + 2 * b * m * d)
            time_row(row, lambda: K.flash_attention(q, k, v, scale),
                     lambda: K.attention_plain(q, k, v, scale),
                     lambda: F.scaled_dot_product_attention(q, k, v,
                                                            scale=scale))
            row.update(flop_ms=flops / F32_TC_FLOPS * 1e3,
                       f32_flop_ms=flops / F32_FLOPS * 1e3,
                       byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=1)
        rows.append(row)
        print(f"[kernel] flash_attention {name} {row['shape']} "
              f"abs_err={err:.3g} rel_err={row['max_rel_err']:.3g} "
              f"tol={ATTN_ATOL} bit-equal over two calls {same} "
              + row_times(row), flush=True)
    timed = [r for r in rows if "ms" in r]
    print(f"[kernel] K3 per serving forward ({len(timed)} launches): kernel "
          f"{sum(r['ms'] for r in timed):.4f} ms (p90 "
          f"{sum(r['ms_p90'] for r in timed):.4f}) vs SDPA "
          f"{sum(r['library_ms'] for r in timed):.4f} ms (p90 "
          f"{sum(r['library_ms_p90'] for r in timed):.4f}), plain "
          f"{sum(r['plain_ms'] for r in timed):.4f}, bound 3xTF32 "
          f"{sum(max(r['flop_ms'], r['byte_ms']) for r in timed):.4f}",
          flush=True)
    return rows


def row_times(row):
    """The time fields of a kernel row, for its log line."""
    return " ".join(f"{key}={row[key]:.4f}" for key in (
        "ms", "ms_p90", "call_ms", "plain_ms", "library_ms", "flop_ms",
        "f32_flop_ms", "byte_ms") if row.get(key) is not None)


def sdpa_backend(fn):
    """Name of the longest device kernel of one call of ``fn``: which of
    PyTorch's attention backends the SDPA yardstick ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(device_us(e), e.key) for e in prof.key_averages()
            if "CUDA" in str(e.device_type)]
    return max(rows)[1][:100] if rows else "unknown"


def check_k2(K, gen, dev, failures):
    """K2 forward (o and lse), dq and dk/dv against their plain versions at
    the three training shapes and two ragged ones, dq / dk / dv bit-equal
    over two calls; per kernel a row list for ``kernel_entry``, timed at
    the training shapes on device time, in turns with the plain versions,
    SDPA's f32 forward, forward + backward and backward alone (the forward
    outside the window), and K2 as a whole (its autograd Function, delta
    included) against the plain full-matrix attention under autograd."""
    import torch
    import torch.nn.functional as F
    rows = {"attention_fwd": [], "attention_dq": [], "attention_dkv": []}
    backend = {}
    gate = {}
    for name, b, n, m, d in ATTN_SHAPES + ATTN_RAGGED:
        q, k, v, do = (torch.randn(b, s, d, device=dev, generator=gen)
                       for s in (n, m, m, n))
        scale = 1.0 / math.sqrt(d)
        o, lse = K.attention_fwd_lse(q, k, v, scale)
        o2, lse2 = K.attention_fwd_lse(q, k, v, scale)
        same_fwd = {"o": torch.equal(o, o2), "lse": torch.equal(lse, lse2)}
        del o2, lse2
        delta = (do * o).sum(-1)
        dq = K.attention_dq(q, k, v, do, lse, delta, scale)
        dk, dv = K.attention_dkv(q, k, v, do, lse, delta, scale)
        dq2 = K.attention_dq(q, k, v, do, lse, delta, scale)
        dk2, dv2 = K.attention_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        same = {"dq": torch.equal(dq, dq2), "dk": torch.equal(dk, dk2),
                "dv": torch.equal(dv, dv2)}
        if not all(same.values()):
            failures.append(f"K2 {name} {[b, n, m, d]}: backward not "
                            f"bit-equal over two calls {same}")
        if not all(same_fwd.values()):
            failures.append(f"K2 {name} {[b, n, m, d]}: forward not "
                            f"bit-equal over two calls {same_fwd}")
        same.update(same_fwd)
        del dq2, dk2, dv2
        ro, rlse = K.attention_fwd_lse_plain(q, k, v, scale)
        rdelta = (do * ro).sum(-1)
        rdq = K.attention_dq_plain(q, k, v, do, rlse, rdelta, scale)
        rdk, rdv = K.attention_dkv_plain(q, k, v, do, rlse, rdelta, scale)
        errs = {}
        for what, got, ref, rel in (("o", o, ro, False), ("lse", lse, rlse, False),
                                    ("dq", dq, rdq, True), ("dk", dk, rdk, True),
                                    ("dv", dv, rdv, True)):
            err = float((got - ref).abs().max())
            top = float(ref.abs().max())
            tol = K2_GRAD_REL * top if rel else ATTN_ATOL
            errs[what] = (err, err / top, tol)
            if not err <= tol:
                failures.append(f"K2 {what} {name} {[b, n, m, d]}: max abs "
                                f"err {err} > {tol}")
        del ro, rlse, rdelta, rdq, rdk, rdv, dq, dk, dv
        shape = [b, n, m, d]
        per = {"attention_fwd": ("o", "lse"), "attention_dq": ("dq",),
               "attention_dkv": ("dk", "dv")}
        for kname, keys in per.items():
            rows[kname].append({
                "shape": shape, "site": name,
                "max_abs_err": max(errs[x][0] for x in keys),
                "max_rel_err": max(errs[x][1] for x in keys),
                "tol": max(errs[x][2] for x in keys),
                "bit_equal_over_two_calls": all(
                    same.get(x, True) for x in keys)})
        line = " ".join(f"{x}_err={errs[x][0]:.3g}(tol {errs[x][2]:.3g})"
                        for x in errs) + f"; bit-equal over two calls {same}"
        if name != "ragged":
            bnmd, bnd, bmd, bn = b * n * m * d, b * n * d, b * m * d, b * n
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, scale=scale)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

            def sdpa_fwd_bwd():
                o_ = F.scaled_dot_product_attention(*leaves, scale=scale)
                return torch.autograd.grad(o_, leaves, do)

            def sdpa_bwd():
                return torch.autograd.grad(out, leaves, do,
                                           retain_graph=True)

            def k2_fwd_bwd():
                o_ = K._Attention.apply(*leaves, scale)
                return torch.autograd.grad(o_, leaves, do)

            def plain_fwd_bwd():
                o_ = K.attention_plain(*leaves, scale)
                return torch.autograd.grad(o_, leaves, do)
            if not backend:
                backend = {"fwd_bwd": sdpa_backend(sdpa_fwd_bwd),
                           "bwd": sdpa_backend(sdpa_bwd)}
            kern = {
                "fwd": lambda: K.attention_fwd_lse(q, k, v, scale),
                "dq": lambda: K.attention_dq(q, k, v, do, lse, delta, scale),
                "dkv": lambda: K.attention_dkv(q, k, v, do, lse, delta,
                                               scale)}
            t = device_ms({
                "fwd_plain": lambda: K.attention_fwd_lse_plain(q, k, v,
                                                               scale),
                "dq_plain": lambda: K.attention_dq_plain(q, k, v, do, lse,
                                                         delta, scale),
                "dkv_plain": lambda: K.attention_dkv_plain(
                    q, k, v, do, lse, delta, scale),
                **kern, "sdpa_fwd": sdpa_fwd, "sdpa_fwd_bwd": sdpa_fwd_bwd,
                "sdpa_bwd": sdpa_bwd, "k2_fwd_bwd": k2_fwd_bwd,
                "plain_fwd_bwd": plain_fwd_bwd})
            # (timing key, library key, operations, f32 elements moved);
            # SDPA's backward computes dq, dk and dv together, so it is no
            # library call of dq or dk/dv alone: it stands beside the pair
            work = {"attention_fwd": ("fwd", "sdpa_fwd", 4.0 * bnmd,
                                      2 * bnd + 2 * bmd + bn),
                    "attention_dq": ("dq", None, 6.0 * bnmd,
                                     3 * bnd + 2 * bmd + 2 * bn),
                    "attention_dkv": ("dkv", None, 8.0 * bnmd,
                                      2 * bnd + 4 * bmd + 2 * bn)}
            for kname, (key, lib, ops, nbytes) in work.items():
                row = rows[kname][-1]
                row.update(
                    ms=t[key]["median"], ms_p90=t[key]["p90"],
                    call_ms=cuda_ms(kern[key]),
                    plain_ms=t[key + "_plain"]["median"],
                    plain_ms_p90=t[key + "_plain"]["p90"],
                    library_ms=t[lib]["median"] if lib else None,
                    library_fwd_bwd_ms=t["sdpa_fwd_bwd"]["median"],
                    library_bwd_ms=t["sdpa_bwd"]["median"],
                    k2_fwd_bwd_ms=t["k2_fwd_bwd"]["median"],
                    plain_fwd_bwd_ms=t["plain_fwd_bwd"]["median"],
                    flop_ms=ops / F32_TC_FLOPS * 1e3,
                    f32_flop_ms=ops / F32_FLOPS * 1e3,
                    byte_ms=4.0 * nbytes / HBM_BYTES_PER_S * 1e3,
                    calls=int(n * m >= K.MIN_FLASH_ELEMS),
                    timing={x: t[x]["how"] for x in t})
                line += (f" {key}: ms={row['ms']:.4f} p90={row['ms_p90']:.4f}"
                         f" call={row['call_ms']:.4f} plain="
                         f"{row['plain_ms']:.4f} bound 3xTF32="
                         f"{max(row['flop_ms'], row['byte_ms']):.4f} f32="
                         f"{row['f32_flop_ms']:.4f};")
            line += (f" SDPA fwd={t['sdpa_fwd']['median']:.4f} fwd+bwd="
                     f"{t['sdpa_fwd_bwd']['median']:.4f} bwd alone="
                     f"{t['sdpa_bwd']['median']:.4f}; whole attention under "
                     f"autograd (delta included): K2 "
                     f"{t['k2_fwd_bwd']['median']:.4f} (p90 "
                     f"{t['k2_fwd_bwd']['p90']:.4f}), plain full-matrix "
                     f"{t['plain_fwd_bwd']['median']:.4f} (p90 "
                     f"{t['plain_fwd_bwd']['p90']:.4f})")
            gate[name] = {"elems": n * m,
                          "k2_fwd_bwd_ms": t["k2_fwd_bwd"]["median"],
                          "plain_fwd_bwd_ms": t["plain_fwd_bwd"]["median"]}
            del leaves, out
        print(f"[kernel] K2 {name} {shape} {line}", flush=True)
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    print(f"[kernel] K2 yardstick: SDPA f32 forward+backward ran "
          f"{backend['fwd_bwd']}; backward alone ran {backend['bwd']}",
          flush=True)
    # the reference sends N * M < 2^20 to its full-matrix form; the port
    # gates (kernels.MIN_FLASH_ELEMS) only where K2 measures slower than the
    # plain form there, and drops the gate where K2 is no slower
    for site, g in gate.items():
        if g["elems"] >= 1 << 20:
            continue
        slower = g["k2_fwd_bwd_ms"] > g["plain_fwd_bwd_ms"]
        gated = g["elems"] < K.MIN_FLASH_ELEMS
        g.update(k2_slower=slower, gated=gated)
        print(f"[kernel] K2 size gate at {site} (N*M = {g['elems']} < 2^20,"
              f" the reference's gate; the port's is "
              f"{K.MIN_FLASH_ELEMS}):"
              f" K2 fwd+bwd {g['k2_fwd_bwd_ms']:.4f} ms vs plain full-matrix"
              f" fwd+bwd {g['plain_fwd_bwd_ms']:.4f} ms: K2 is "
              f"{'slower' if slower else 'no slower'}; the port "
              f"{'gates' if gated else 'does not gate'} this site"
              + ("" if slower == gated else " (the decision no longer "
                 "matches this measurement)"), flush=True)
    # per train step: the sites past the size gate (calls = 1)
    timed = {k: [r for r in v if r.get("calls")] for k, v in rows.items()}
    pair = sum(r["ms"] for r in timed["attention_dq"] + timed["attention_dkv"])
    sdpa_bwd_ms = sum(r["library_bwd_ms"] for r in timed["attention_dq"])
    print(f"[kernel] K2 per train step ({len(timed['attention_dq'])} "
          f"launches of each): " + "; ".join(
              f"{k[10:]} {sum(r['ms'] for r in v):.4f} ms (p90 "
              f"{sum(r['ms_p90'] for r in v):.4f}, call time "
              f"{sum(r['call_ms'] for r in v):.4f}, plain "
              f"{sum(r['plain_ms'] for r in v):.4f}, bound 3xTF32 "
              f"{sum(max(r['flop_ms'], r['byte_ms']) for r in v):.4f}, f32 "
              f"{sum(r['f32_flop_ms'] for r in v):.4f})"
              for k, v in timed.items())
          + f"; dq + dk/dv {pair:.4f} ms vs SDPA f32 backward alone "
          f"{sdpa_bwd_ms:.4f} ms", flush=True)
    if not pair < sdpa_bwd_ms:
        print(f"[kernel] K2 finding: dq + dk/dv ({pair:.4f} ms) is not below "
              f"SDPA's f32 backward ({sdpa_bwd_ms:.4f} ms)", flush=True)
    fwd = timed["attention_fwd"]
    print(f"[kernel] K2 fwd per train step ({len(fwd)} launches): "
          f"{sum(r['ms'] for r in fwd):.4f} ms (p90 "
          f"{sum(r['ms_p90'] for r in fwd):.4f}) vs SDPA forward "
          f"{sum(r['library_ms'] for r in fwd):.4f} ms", flush=True)
    return rows, backend, gate


# K4's forms: the f32 form (the TPU kernel's own function: f32 in and out),
# gn1's (bf16 in, bf16 out), gn1s, gn1's with the time projection as its
# shift, gn1b, gn1s with conv1's bias too (the fused UNet's gn1 on the main
# path), gn2's (bf16 in, bf16 residual, bf16 out) and gn2b, gn2's with
# conv2's and the 1x1 residual conv's biases (the fused UNet's gn2 on the
# main path); bytes an element moved at least (x read, the residual read,
# out written once)
K4_FORMS = (("f32", 8), ("gn1", 4), ("gn1s", 4), ("gn1b", 4), ("gn2", 6),
            ("gn2b", 6))
# the forms the fused UNet's forward runs: gn1 with its shift and bias, gn2
# with its biases
K4_MAIN_FORMS = ("gn1b", "gn2b")
# K4 launches with a shift a fused UNet forward: gn1 of the seven ConvBlocks
K4_SHIFT_PER_FORWARD = 7
# ... with a residual conv's bias: gn2 of the six ConvBlocks that change the
# width (all but the bottleneck); every K4 launch of the forward takes its
# conv's bias
K4_RESIDUAL_BIAS_PER_FORWARD = 6
# checked, not timed: ragged shapes and one an image of which the grid's
# shared memory cannot hold (streamed), in f32 and bf16
GN_EXTRA = [(3, 7, 9, 24), (1, 1, 1, 8), (2, 7, 9, 24), (2, 512, 512, 64)]
# the seed of K4's own generator
K4_SEED = 4


def bf16_ulp(t):
    """One bf16 ulp of |t|, elementwise (2^(e - 8) for |t| = m 2^e, m in
    [0.5, 1))."""
    import torch
    _, e = torch.frexp(t.abs())
    return torch.ldexp(torch.ones_like(t), e - 8)


def gn_error(out, ref, form):
    """(max abs err, max of err over its bound): f32 within GN_ATOL; a bf16
    result within one bf16 ulp of the larger |value| plus GN_ATOL (the f32
    values before the cast agree within GN_ATOL, and each rounds by at most
    half an ulp)."""
    import torch
    err = (out.float() - ref.float()).abs()
    if form == "f32":
        bound = GN_ATOL
    else:
        bound = bf16_ulp(torch.maximum(out.float().abs(),
                                       ref.float().abs())) + GN_ATOL
    return float(err.max()), float((err / bound).max())


def gn_operands(gen, dev, b, h, w, c):
    """x, scale, bias and the residual of one K4 shape."""
    import torch
    x = torch.randn(b, h, w, c, device=dev, generator=gen) * 2.0 + 0.5
    scale = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
    bias = 0.1 * torch.randn(c, device=dev, generator=gen)
    res = torch.randn(b, h, w, c, device=dev, generator=gen)
    return x, scale, bias, res


def gn_form_args(form, x, res):
    """(x, kwargs) of one form of K4's call; gn1s's shift (B, C) is the
    residual's first pixel, times 4 (a time projection's size); the conv
    bias (C,) of gn1b and gn2b the residual's first pixel of image 0, times
    2, and gn2b's residual bias its last pixel of the last image, halved (a
    conv bias's size)."""
    import torch
    if form == "f32":
        return x, {}
    xb = x.to(torch.bfloat16)
    bf16 = {"out_dtype": torch.bfloat16}
    if form == "gn1":
        return xb, bf16
    if form in ("gn1s", "gn1b"):
        kw = {**bf16, "shift": 4.0 * res[:, 0, 0, :].contiguous()}
        if form == "gn1b":
            kw["conv_bias"] = 2.0 * res[0, 0, 0, :]
        return xb, kw
    kw = {**bf16, "residual": res.to(torch.bfloat16)}
    if form == "gn2b":
        kw.update(conv_bias=2.0 * res[0, 0, 0, :],
                  residual_bias=0.5 * res[-1, -1, -1, :])
    return xb, kw


# what K4 adds to its inputs as it reads them
GN_ADDED = ("shift", "conv_bias", "residual_bias")


def gn_pre_added(K, xi, scale, bias, kw):
    """K4 on the inputs with the conv bias, the shift and the residual bias
    added by stock ops beforehand, in their order (what the fused UNet ran
    before K4 took them): the bit-equal yardstick of a call that adds
    them."""
    rest = {k: v for k, v in kw.items() if k not in GN_ADDED}
    if kw.get("conv_bias") is not None:
        xi = xi + kw["conv_bias"].to(xi.dtype)
    if kw.get("shift") is not None:
        xi = xi + kw["shift"][:, None, None, :].to(xi.dtype)
    if kw.get("residual_bias") is not None:
        r = rest["residual"]
        rest["residual"] = r + kw["residual_bias"].to(r.dtype)
    return K.groupnorm_silu(xi, scale, bias, 8, **rest)


def gn_plan_text(plan):
    return (f"{plan.mode} cpi {plan.cpi} ipw {plan.ipw} waves {plan.waves} "
            f"run {plan.run_pix} px tiles {plan.tiles} refill "
            f"{int(plan.refill)} smem {plan.smem} B grid {plan.grid} "
            f"({plan.per_sm}/SM) threads {plan.threads}")


def k4_phases(K, xi, scale, bias, kw, plan, dev):
    """Block 0's phases (us, mean over the waves) from the kernel's own
    clock: wait for the run, statistics, barrier, merge, apply."""
    import torch
    st = torch.zeros(K.K4_STAMPS * plan.waves, dtype=torch.int64, device=dev)
    K.groupnorm_silu(xi, scale, bias, 8, stamps=st, **kw)
    torch.cuda.synchronize()
    d = st.view(plan.waves, K.K4_STAMPS).double()
    ph = ((d[:, 1:] - d[:, :-1]).mean(0) / 1e3).tolist()
    return dict(zip(("wait", "stats", "barrier", "merge", "apply"), ph))


def check_groupnorm(K, gen, dev, failures, phases=False):
    """K4 in its six forms at every main-path shape (each against its
    plain version, bit-equal over two calls, one launch a call, timed with
    its bound; the forms that add a shift or biases also bit-equal to K4 on
    the inputs with them added by stock ops; the f32 form also against
    ``F.group_norm`` + ``F.silu`` on the NHWC tensor's NCHW view and on an
    NCHW-contiguous copy), then the ragged and streamed shapes in f32 and
    bf16. Returns the f32 rows (the TPU kernel's function, the ``kernels``
    line's) and the forms' totals per forward (the main path: gn1b +
    gn2b). With ``phases``
    (``--only k4``) each form also prints block 0's phases and is timed
    with the plan of the other CTAs an SM beside it (the plan's choice,
    decided by measurement)."""
    import torch
    import torch.nn.functional as F
    rows, main_rows = [], []
    main = {k: 0.0 for form, _ in K4_FORMS[1:]
            for k in (f"{form}_ms", f"{form}_plain_ms")}
    main["bound_ms"] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, w, c, calls in GN_SHAPES:
        x, scale, bias, res = gn_operands(gen, dev, b, h, w, c)
        n = b * h * w * c
        for form, nbytes in K4_FORMS:
            xi, kw = gn_form_args(form, x, res)
            plan = K.groupnorm_silu_plan(b, h, w, c, 8, xi.dtype, sms)
            before = K.LAUNCHES["groupnorm_silu"]
            out = K.groupnorm_silu(xi, scale, bias, 8, **kw)
            again = K.groupnorm_silu(xi, scale, bias, 8, **kw)
            torch.cuda.synchronize()
            launched = K.LAUNCHES["groupnorm_silu"] - before
            ref = K.groupnorm_silu_plain(xi, scale, bias, 8, **kw)
            err, ratio = gn_error(out, ref, form)
            added_bytes = sum(kw[k].numel() * 4 for k in GN_ADDED
                              if k in kw)
            row = {"shape": [b, h, w, c], "form": form, "max_abs_err": err,
                   "max_rel_err": err / float(ref.float().abs().max()),
                   "err_over_tol": ratio, "bit_equal": torch.equal(out, again),
                   "plan": plan._asdict(), "calls": calls,
                   "byte_ms": (nbytes * n + 8 * c + added_bytes)
                   / HBM_BYTES_PER_S * 1e3,
                   # ~12 operations an element: statistics, normalise,
                   # affine, SiLU (and the residual add)
                   "flop_ms": 12.0 * n / F32_FLOPS * 1e3}
            if any(k in kw for k in GN_ADDED):
                row["equal_to_added"] = torch.equal(
                    out, gn_pre_added(K, xi, scale, bias, kw))
            if not (ratio <= 1.0 and row["bit_equal"] and launched == 2
                    and row.get("equal_to_added", True)):
                failures.append(f"groupnorm_silu {form} {row['shape']}: err "
                                f"{err} ({ratio:.3g} of the bound), bit-equal "
                                f"{row['bit_equal']}, equal to the stock add "
                                f"then K4 {row.get('equal_to_added')}, "
                                f"{launched} launches for 2 calls")
            others = {}
            library = None
            if form == "f32":
                xc = x.permute(0, 3, 1, 2).contiguous()

                def library():
                    return F.silu(F.group_norm(x.permute(0, 3, 1, 2), 8,
                                               scale, bias, 1e-5))

                def library_nchw():
                    return F.silu(F.group_norm(xc, 8, scale, bias, 1e-5))
                others["library_nchw_ms"] = library_nchw
            if phases:            # the plan with the other CTAs an SM
                other = K.groupnorm_silu_plan(b, h, w, c, 8, xi.dtype, sms,
                                              per_sm=3 - plan.per_sm)
                others[f"per_sm{other.per_sm}_ms"] = (
                    lambda p=other: K.groupnorm_silu(xi, scale, bias, 8,
                                                     plan=p, **kw))
            time_row(row, lambda: K.groupnorm_silu(xi, scale, bias, 8, **kw),
                     lambda: K.groupnorm_silu_plain(xi, scale, bias, 8, **kw),
                     library, **others)
            if phases:
                row["phases_us"] = k4_phases(K, xi, scale, bias, kw, plan,
                                             dev)
            if form == "f32":
                rows.append(row)
            else:                 # half of a shape's calls are gn1, half gn2
                main_rows.append(row)
                main[f"{form}_ms"] += row["ms"] * calls / 2
                main[f"{form}_plain_ms"] += row["plain_ms"] * calls / 2
                if form in K4_MAIN_FORMS:
                    main["bound_ms"] += row["byte_ms"] * calls / 2
            lib = (f" library {row['library_ms']:.4f} (NCHW copy "
                   f"{row['library_nchw_ms']:.4f})" if form == "f32" else "")
            ph = (f" {3 - plan.per_sm}/SM "
                  f"{row[f'per_sm{3 - plan.per_sm}_ms']:.4f}; phases us " +
                  " ".join(f"{k} {v:.2f}" for k, v in
                           row["phases_us"].items()) if phases else "")
            print(f"[kernel] K4 {form} {row['shape']} {gn_plan_text(plan)}: "
                  f"ms {row['ms']:.4f} (p90 {row['ms_p90']:.4f}) bound "
                  f"{row['byte_ms']:.4f} plain {row['plain_ms']:.4f}{lib}; "
                  f"abs_err {err:.3g} ({ratio:.3g} of tol), bit-equal "
                  f"{row['bit_equal']}{ph}", flush=True)
        del x, res
        torch.cuda.empty_cache()
    for b, h, w, c in GN_EXTRA:
        x, scale, bias, res = gn_operands(gen, dev, b, h, w, c)
        for form in ("f32", "gn1s", "gn1b", "gn2", "gn2b"):
            xi, kw = gn_form_args(form, x, res)
            plan = K.groupnorm_silu_plan(b, h, w, c, 8, xi.dtype, sms)
            out = K.groupnorm_silu(xi, scale, bias, 8, **kw)
            torch.cuda.synchronize()
            ref = K.groupnorm_silu_plain(xi, scale, bias, 8, **kw)
            err, ratio = gn_error(out, ref, form)
            added = not any(k in kw for k in GN_ADDED) or torch.equal(
                out, gn_pre_added(K, xi, scale, bias, kw))
            rows.append({"shape": [b, h, w, c], "form": form,
                         "max_abs_err": err, "err_over_tol": ratio,
                         "max_rel_err": err / float(ref.float().abs().max()),
                         "plan": plan._asdict()})
            if not (ratio <= 1.0 and added):
                failures.append(f"groupnorm_silu {form} {[b, h, w, c]}: err "
                                f"{err} ({ratio:.3g} of the bound), equal to "
                                f"the stock add then K4 {added}")
            print(f"[kernel] K4 {form} {[b, h, w, c]} {gn_plan_text(plan)}: "
                  f"abs_err {err:.3g} ({ratio:.3g} of tol)", flush=True)
        del x, res
    timed = [r for r in rows if "ms" in r]
    f32 = {k: sum(r[k] * r["calls"] for r in timed)
           for k in ("ms", "byte_ms", "plain_ms", "library_ms",
                     "library_nchw_ms")}
    main["forms_ms"] = sum(main[f"{f}_ms"] for f in K4_MAIN_FORMS)
    if phases:
        for form, _ in K4_FORMS:
            got = [r for r in (rows if form == "f32" else main_rows)
                   if r["form"] == form and "ms" in r]
            for per_sm in (1, 2):
                key = "ms" if got[0]["plan"]["per_sm"] == per_sm else \
                    f"per_sm{per_sm}_ms"
                share = sum(r[key] * r["calls"] for r in got) / \
                    (1 if form == "f32" else 2)
                print(f"[kernel] K4 {form} per forward with {per_sm} CTA(s) "
                      f"an SM: {share:.4f} ms", flush=True)
    print(f"[kernel] K4 per forward (14 calls): f32 form {f32['ms']:.4f} ms "
          f"(bound {f32['byte_ms']:.4f}, plain {f32['plain_ms']:.4f}, "
          f"library {f32['library_ms']:.4f}, on an NCHW copy "
          f"{f32['library_nchw_ms']:.4f}); main-path forms gn1b + gn2b "
          f"{main['forms_ms']:.4f} ms (gn1b {main['gn1b_ms']:.4f}, gn1s "
          f"without the bias {main['gn1s_ms']:.4f}, gn1 without either "
          f"{main['gn1_ms']:.4f}; gn2b {main['gn2b_ms']:.4f}, gn2 without "
          f"the biases {main['gn2_ms']:.4f}; bound {main['bound_ms']:.4f}, "
          f"plain {main['gn1b_plain_ms'] + main['gn2b_plain_ms']:.4f})",
          flush=True)
    return rows, main


def k4_sync_probe(K, dev):
    """us per barrier of K4's exchange alone (2000 rounds against none,
    CUDA events): the per-image barrier words at the main path's CTAs an
    image."""
    import torch
    out = {}
    for cpi, ipw in ((8, 16), (16, 16), (33, 8), (44, 6), (88, 3), (132, 1)):
        ts = []
        for rounds in (0, 2000):
            K.groupnorm_silu_sync_probe(rounds, cpi, ipw, dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            K.groupnorm_silu_sync_probe(rounds, cpi, ipw, dev)
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        key = f"counters cpi {cpi} ipw {ipw}"
        out[key] = (ts[1] - ts[0]) / 2000 * 1e3
        print(f"[kernel] K4 exchange probe {key}: {out[key]:.3f} us a "
              f"barrier", flush=True)
    return out


def k1_alternatives(K, site, shape, plan, sm_count):
    """Other plans timed beside K1's own at a main-path shape (label ->
    plan): the 3 input channels of an enc0 gathered element by element
    instead of padded to 4; where K <= 32 the 128 x 64 wgmma tile (half its
    columns idle) instead of 128 x 32 on mma.sync; where K > 64 the 128 x
    64 tile, and the chosen tile with no split (or, unsplit, 2 splits)."""
    b, h, w, cin, k, pad = shape

    def other(**kw):
        return K.conv_stats_plan(b, h, w, cin, k, pad, sm_count=sm_count,
                                 **kw)
    alts = {}
    if site == "enc0":
        alts["element gather (Cin 3)"] = plan._replace(cin=3, run=1)
    if k <= 32:
        alts["tile 2"] = other(tile=2)
    elif k > 64:
        alts["tile 2"] = other(tile=2)
        n = 1 if plan.splits > 1 else 2
        alts[f"splits {n}"] = other(tile=plan.tile, splits=n)
    return alts


def k1_slower(row):
    """K1 loses to the stock chain (cuDNN conv + var_mean) beyond both
    p90s: its median above the stock p90 and its p90 above the stock
    median."""
    return row["ms"] > row["library_ms_p90"] and \
        row["ms_p90"] > row["library_ms"]


def k1_decision(row):
    """The printed decision at one main-path shape. The port has no size
    gate for K1: it runs K1 at every shape, which holds while K1 is no
    slower than the stock chain at each (else the line says so)."""
    b, h, w, cin, k, pad = row["shape"]
    ho, wo = (h + 2 * pad - 4) // 2 + 1, (w + 2 * pad - 4) // 2 + 1
    slower = k1_slower(row)
    row["k1_slower"] = slower
    print(f"[kernel] K1 decision {row['family']} {row['site']} ({b}x{h}x{w}"
          f"x{cin} -> {k}, padding {pad}, {b * ho * wo} output rows): K1 "
          f"{row['ms']:.4f} ms (p90 {row['ms_p90']:.4f}) vs stock (cuDNN "
          f"conv + var_mean) {row['library_ms']:.4f} ms (p90 "
          f"{row['library_ms_p90']:.4f}): K1 is "
          f"{'slower' if slower else 'no slower'}; the port runs K1 there"
          + (" (the decision no longer matches this measurement)"
             if slower else ""), flush=True)


def plan_text(plan):
    return (f"tile {plan.bm}x{plan.bn}"
            f"{' wgmma' if plan.tile > 1 else ''} splits {plan.splits} x "
            f"{plan.k_split} deep, cin {plan.cin} gather {plan.run}")


def check_k1(K, gen, dev, failures, families=K1_FAMILIES, extras=True):
    """K1 against its plain version at the main-path shapes of
    ``families`` (bf16) and at K1_EXTRA: c, mean, var, and y = bn_lrelu of
    each; c, mean and var
    bit-equal over two calls; the main-path shapes timed as kernel, plain
    version and the library yardstick (cuDNN conv2d in bf16 on
    channels_last input, then torch.var_mean), with other plans beside
    (``k1_alternatives``); then the decision at the odd 127x127 enc1, where
    the reference sends its even-size gate's odd input to XLA."""
    import torch
    import torch.nn.functional as F
    from vgd_tpu_torch.ops.fused_conv import bn_lrelu
    rows = []
    extra = [("extra", (n, b, h, w, ci, k, p, 0, dt)) for n, b, h, w, ci, k,
             p, dt in K1_EXTRA] if extras else []
    for family, (site, b, h, w, cin, k, pad, calls, *dt) in \
            [(fam, s_ + ("bfloat16",)) for fam, shapes, _ in families
             for s_ in shapes] + extra:
        dtype = getattr(torch, dt[0])
        x = torch.randn(b, h, w, cin, device=dev, generator=gen).to(dtype)
        wt = (torch.randn(k, cin, 4, 4, device=dev, generator=gen)
              * (2.0 / (16 * cin)) ** 0.5).to(dtype)
        gamma = 1.0 + 0.02 * torch.randn(k, device=dev, generator=gen)
        beta = 0.02 * torch.randn(k, device=dev, generator=gen)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = K.conv_stats_plan(b, h, w, cin, k, pad,
                                 bf16=dtype == torch.bfloat16, sm_count=sms)
        c, mean, var = K.conv_stats(x, wt, pad)
        c2, mean2, var2 = K.conv_stats(x, wt, pad)
        torch.cuda.synchronize()
        same = torch.equal(c, c2) and torch.equal(mean, mean2) and \
            torch.equal(var, var2)
        del c2, mean2, var2
        rc, rm, rv = K.conv_stats_plain(x, wt, pad)
        slope = 0.2 if pad else 0.01
        y = bn_lrelu(c, gamma, beta, mean, var, slope, 1e-5)
        ry = bn_lrelu(rc, gamma, beta, rm, rv, slope, 1e-5)
        errs = {"c": float((c - rc).abs().max()),
                "mean": float((mean - rm).abs().max()),
                "var": float((var - rv).abs().max()),
                "y": float((y - ry).abs().max())}
        ok = (errs["c"] <= K1_C_REL * float(rc.abs().max())
              and bool(((mean - rm).abs() <= K1_STAT_ATOL
                        + K1_STAT_RTOL * rm.abs()).all())
              and bool(((var - rv).abs() <= K1_STAT_ATOL
                        + K1_STAT_RTOL * rv.abs()).all())
              and errs["y"] <= K1_Y_REL * float(ry.abs().max()) + K1_Y_ATOL)
        shape = [b, h, w, cin, k, pad]
        if not ok:
            failures.append(f"K1 {family} {site} {shape} {dt[0]}: errors "
                            f"{errs}")
        if not same:
            failures.append(f"K1 {family} {site} {shape} {dt[0]}: not "
                            f"bit-equal over two calls")
        row = {"shape": shape, "site": site, "family": family,
               "dtype": dt[0],
               "plan": plan._asdict(), "bit_equal_over_two_calls": same,
               "max_abs_err": max(errs.values()),
               "max_rel_err": errs["c"] / float(rc.abs().max()),
               "errors": errs, "tol": f"c {K1_C_REL} x max|c|, mean/var "
               f"rtol {K1_STAT_RTOL} atol {K1_STAT_ATOL}, y {K1_Y_REL} x "
               f"max|y| + {K1_Y_ATOL}"}
        del c, mean, var, y, ry
        alt_text = ""
        if calls:
            ho, wo = (h + 2 * pad - 4) // 2 + 1, (w + 2 * pad - 4) // 2 + 1
            m = b * ho * wo
            flops = 2.0 * m * k * 16 * cin
            nbytes = 2.0 * (b * h * w * cin + 16 * cin * k) + 4.0 * m * k \
                + 8.0 * k
            xc = x.permute(0, 3, 1, 2)            # channels_last view

            def library():
                o = F.conv2d(xc, wt, stride=2, padding=pad)
                return torch.var_mean(o, dim=(0, 2, 3), correction=0)
            alts = k1_alternatives(K, site, tuple(shape), plan, sms)
            # each other plan computes the same function (to the same bound)
            for a, p_ in alts.items():
                ac, am, av = K.conv_stats(x, wt, pad, p_)
                err = float((ac - rc).abs().max())
                if not (err <= K1_C_REL * float(rc.abs().max())
                        and torch.allclose(am, rm, K1_STAT_RTOL, K1_STAT_ATOL)
                        and torch.allclose(av, rv, K1_STAT_RTOL,
                                           K1_STAT_ATOL)):
                    failures.append(f"K1 {family} {site} other plan {a}: c "
                                    f"err {err}")
                del ac, am, av
            stages, launches = profile_stages(
                lambda: K.conv_stats(x, wt, pad), k1_stage)
            row.update(stages=stages, stage_launches=launches)
            time_row(row, lambda: K.conv_stats(x, wt, pad),
                     lambda: K.conv_stats_plain(x, wt, pad), library,
                     **{f"alt {a}": (lambda p_=p_: K.conv_stats(x, wt, pad,
                                                                p_))
                        for a, p_ in alts.items()})
            row.update(flop_ms=flops / BF16_FLOPS * 1e3,
                       byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=calls,
                       alternatives={a: plan_text(p_)
                                     for a, p_ in alts.items()})
            alt_text = "; profiler ms by stage (" + f"{launches} kernels): " \
                + ", ".join(f"{st} {ms:.4f}" for st, ms in stages.items())
            alt_text += "".join(
                f"; other plan {a} ({plan_text(p_)}) {row['alt ' + a]:.4f}"
                for a, p_ in alts.items())
        del rc, rm, rv
        rows.append(row)
        print(f"[kernel] K1 {family} {site} {shape} {dt[0]} plan: "
              f"{plan_text(plan)}; "
              + " ".join(f"{n}_err={e:.3g}" for n, e in errs.items())
              + f" bit-equal over two calls {same} " + row_times(row)
              + (f" library_p90={row['library_ms_p90']:.4f}"
                 if calls else "") + alt_text
              + ("" if ok else " FAIL"), flush=True)
        del x, wt
    for family, shapes, per in families:
        timed = [r for r in rows if "ms" in r and r["family"] == family]
        bound = sum(max(r["flop_ms"], r["byte_ms"]) * r["calls"]
                    for r in timed)
        print(f"[kernel] K1 per {per} "
              f"({sum(s_[-1] for s_ in shapes)} launches): kernel "
              f"{sum(r['ms'] * r['calls'] for r in timed):.3f} ms (p90 "
              f"{sum(r['ms_p90'] * r['calls'] for r in timed):.3f}, call "
              f"time {sum(r['call_ms'] * r['calls'] for r in timed):.3f}), "
              f"plain {sum(r['plain_ms'] * r['calls'] for r in timed):.3f} "
              f"ms, library (cuDNN conv2d bf16 channels_last + "
              f"torch.var_mean) "
              f"{sum(r['library_ms'] * r['calls'] for r in timed):.3f} ms, "
              f"bound {bound:.3f} ms (bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
    # the reference's gate sends odd padded sizes (the VAE-GAN's 127x127
    # enc1, the VAE's 31x31 enc1) to XLA (vgd_tpu/ops/fused_conv.py:308-313);
    # the port decides each shape by measurement: K1 unless it loses to the
    # stock chain beyond both p90s
    for row in rows:
        if "ms" in row and (row["family"] != "vaegan"
                            or row["site"] == "enc1"):
            k1_decision(row)
    return rows


def kernel_entry(name, source, replaces, rows, launches, per):
    """One kernel's line entry: times summed over the shapes of one UNet
    forward or train step (each shape weighted by its calls there)."""
    timed = [r for r in rows if "ms" in r]

    def total(key):
        vals = [r[key] for r in timed]
        if any(v is None for v in vals):
            return None
        return sum(v * r["calls"] for v, r in zip(vals, timed))
    # each launch is bound by the larger of its operations and its bytes;
    # the launches of a step run one after another
    by_ops = sum(r["flop_ms"] * r["calls"] for r in timed
                 if r["flop_ms"] >= r["byte_ms"])
    by_bytes = sum(r["byte_ms"] * r["calls"] for r in timed
                   if r["flop_ms"] < r["byte_ms"])
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "max_rel_err": max(r["max_rel_err"] for r in rows),
             "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": by_ops + by_bytes,
             "bound_by": "operations" if by_ops >= by_bytes else "bytes",
             "library_ms": total("library_ms"), "per": per,
             "timing": "device time, median of "
             f"{TIMING_REPEATS} (CUDA graph replays or profiler kernel "
             "time); ms_p90 the p90; call_ms the old call time",
             "ms_p90": total("ms_p90"), "plain_ms_p90": total("plain_ms_p90"),
             "call_ms": total("call_ms"), "shapes": rows}
    for key in ("library_fwd_bwd_ms", "library_bwd_ms", "k2_fwd_bwd_ms",
                "plain_fwd_bwd_ms"):
        if key in timed[0]:
            entry[key] = total(key)
    if "f32_flop_ms" in timed[0]:
        # the same operations at the 67 TFLOP/s CUDA-core f32 rate
        entry["f32_bound_ms"] = total("f32_flop_ms")
    return entry


def k1_entry(rows, report):
    """K1's line entry: its times per VAE-GAN step, as before the 64²
    families ran K1 (``per_family`` has each family's sums per step of that
    family); its launches over every main-path run (VAE-GAN, VAE, DCGAN and
    WGAN training, the data-parallel VAE-GAN's ranks, the cli phase's
    64x64 VAE-GAN, the scan phase's CUDA-graph steps and the data phase's
    memmap run; ``launches_by_path`` splits them); its errors over every
    checked shape."""
    launches = {"vaegan": report["vaegan"]["train"]["k1_launches"],
                "vae": report["vae"]["train"]["k1_launches"],
                "gan": report["gan"]["train"]["k1_launches"],
                "wgan": report["gan"]["wgan_train"]["k1_launches"],
                "dp": report["dp"]["launches"]["conv_bn_stats"],
                "cli": report["cli"]["launches"]["conv_bn_stats"],
                "scan": report["scan"]["launches"]["conv_bn_stats"],
                "data": report["data"]["run"]["launches"].get(
                    "conv_bn_stats", 0)}

    def family_entry(family, per, source="", replaces=""):
        return kernel_entry("conv_bn_stats", source, replaces, [
            r for r in rows if r["family"] in (family, "extra")],
            launches.get(family, 0), per)
    family, _, per = K1_FAMILIES[0]
    entry = family_entry(family, per, "vgd_tpu_torch/csrc/conv_bn_stats.cu",
                         "vgd_tpu/ops/fused_conv.py:125")
    entry.update(launches=sum(launches.values()), launches_by_path=launches,
                 max_abs_err=max(r["max_abs_err"] for r in rows),
                 max_rel_err=max(r["max_rel_err"] for r in rows),
                 shapes=rows, per_family={})
    for family, _, per in K1_FAMILIES:
        sub = family_entry(family, per)
        entry["per_family"][family] = {k: sub[k] for k in (
            "ms", "ms_p90", "call_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "per")}
    return entry


def hold_unet(K, trainer, gen, failures, tag="unet"):
    """The fused UNet (kernels) against the same weights with no kernel
    (``plain_reference``) at B=2, within UNET_REL_TOL of the reference's
    max; returns (max abs err, max |reference|)."""
    import torch
    model = trainer.model_fused
    h, w = trainer.cfg.data.image_size
    x = torch.randn(2, h, w, 3, device=trainer.device, generator=gen)
    t = torch.tensor([trainer.cfg.timesteps - 1, 17], dtype=torch.int32,
                     device=trainer.device)
    with torch.inference_mode():
        fused_out = model(x, t)
        with K.plain_reference():
            ref = model(x, t)
    err = float((fused_out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[{tag}] fused vs no-kernel reference, B=2 {h}x{w}: max abs err "
          f"{err:.4g}, max |reference| {scale:.4g}, tol {UNET_REL_TOL} x "
          f"max |reference|", flush=True)
    if not (torch.isfinite(fused_out).all() and err <= UNET_REL_TOL * scale):
        failures.append(f"{tag}: fused UNet disagrees with its no-kernel "
                        f"reference: {err} > {UNET_REL_TOL} x {scale}")
    return err, scale


def stock_broadcast_adds(fn):
    """The stock broadcast adds that one call of ``fn`` makes, from the
    profiler's recorded shapes: "time_projection", of (B, H, W, C) and (B,
    1, 1, C) (the time projection's add before gn1, which K4 takes as its
    shift on the fused path), and "conv_bias", of (B, C, H, W) and (1, C,
    1, 1) (a biased convolution's add of its bias after cuDNN's
    convolution, which K4 takes on the fused path for every conv whose
    output it reads)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    n = {"time_projection": 0, "conv_bias": 0}
    for evt in prof.events():
        shapes = evt.input_shapes or []
        if evt.name in ("aten::add", "aten::add_") and len(shapes) >= 2:
            a, p = shapes[0], shapes[1]
            if not (len(a) == len(p) == 4):
                continue
            n["time_projection"] += (a[1] > 1 and p[1] == p[2] == 1
                                     and p[0] == a[0] and p[3] == a[3])
            n["conv_bias"] += (p[0] == p[2] == p[3] == 1 and p[1] == a[1]
                               and a[0] > 1)
    return n


def check_unet(K, trainer, gen, failures):
    """``hold_unet``; then the fused and the no-kernel forward timed at
    B=16, one fused forward's launches (14 K4, 7 of them with the time
    projection as their shift, all with their conv's bias, 6 with a 1x1
    residual conv's bias, and 3 K3) and its stock broadcast adds of the
    time projection (none) and of conv biases (the attention block's qkv
    and proj and the output conv only), and one fused forward profiled by
    kernel group."""
    import torch
    model = trainer.model_fused
    dev = trainer.device
    (h, w), b = trainer.cfg.data.image_size, trainer.cfg.data.batch_size
    hold_unet(K, trainer, gen, failures)
    x = torch.randn(b, h, w, 3, device=dev, generator=gen)
    t = torch.full((b,), 500, dtype=torch.int32, device=dev)

    def plain():
        with K.plain_reference():
            model(x, t)
    with torch.inference_mode():
        stats = {"unet_fused_ms": cuda_ms(lambda: model(x, t), 2, 10),
                 "unet_plain_ms": cuda_ms(plain, 2, 10)}
        K.LAUNCHES.clear()
        model(x, t)
        stats["forward_launches"] = check_launches(
            K, serving_launches(1), "unet", failures)
        adds = stock_broadcast_adds(lambda: model(x, t))
        stats["stock_adds"] = adds
        want = {"time_projection": 0,
                "conv_bias": 3 if model.attention else 1}
        print(f"[unet] stock broadcast adds a fused forward: {adds} (want "
              f"{want})", flush=True)
        if adds != want:
            failures.append(f"unet: the fused forward made the stock "
                            f"broadcast adds {adds}, want {want}")
        stats["forward_profile"] = profile_fn(
            lambda: model(x, t), FORWARD_GROUPS, "profile")
    print(f"[unet] forward B={b} {h}x{w}: fused {stats['unet_fused_ms']:.3f} "
          f"ms, no-kernel reference {stats['unet_plain_ms']:.3f} ms",
          flush=True)
    return stats


def check_train_step(K, trainer, gen, failures):
    """One train step of the training-form UNet with K2 against the same
    weights, batch, t and noise with no kernel: the loss and every
    parameter's gradient. Then forward+backward timed both ways, and one
    whole train step (Adam included) profiled by kernel group."""
    import torch
    from vgd_tpu_torch.train.common import mse
    dev = trainer.device
    model = trainer.model
    (h, w), b = trainer.cfg.data.image_size, trainer.cfg.data.batch_size
    batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
    t = torch.randint(0, trainer.cfg.timesteps, (b,), device=dev,
                      generator=gen)
    noise = torch.randn(b, h, w, 3, device=dev, generator=gen)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        xt, tt, nz = trainer._inputs(batch, None, t, noise)
        loss = mse(model(xt, tt), nz)
        loss.backward()
        return loss.detach()

    def plain_fwd_bwd():
        with K.plain_reference():
            return fwd_bwd()
    K.LAUNCHES.clear()
    loss_k = float(fwd_bwd())
    launches = {k: K.LAUNCHES[k] for k in K2_NAMES}
    grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}
    K.LAUNCHES.clear()
    loss_r = float(plain_fwd_bwd())
    if sum(K.LAUNCHES.values()):
        failures.append(f"train step: the no-kernel reference launched "
                        f"{dict(K.LAUNCHES)}")
    grads_r = {n: p.grad for n, p in model.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads_r.values())
    worst = (0.0, "")
    for name, ref in grads_r.items():
        err = float((grads_k[name] - ref).abs().max())
        bound = STEP_GRAD_REL * float(ref.abs().max()) + STEP_GRAD_FLOOR * gmax
        worst = max(worst, (err / bound, name))
        if not err <= bound:
            failures.append(f"train step gradient {name}: {err} > {bound}")
    loss_ok = abs(loss_k - loss_r) <= STEP_LOSS_REL * abs(loss_r)
    if not (loss_ok and math.isfinite(loss_k)):
        failures.append(f"train step loss {loss_k} vs reference {loss_r}")
    sites = k2_sites(K)
    if launches != {k: sites for k in K2_NAMES}:
        failures.append(f"train step launched {launches}, want {sites} of "
                        f"each")
    print(f"[train-step] K2 vs no-kernel reference, B={b} {h}x{w}: loss "
          f"{loss_k:.6f} vs {loss_r:.6f}; {len(grads_r)} gradients, worst "
          f"err/bound {worst[0]:.3f} ({worst[1]}), bound {STEP_GRAD_REL} x "
          f"max|g| + {STEP_GRAD_FLOOR} x {gmax:.4g}; launches {launches}",
          flush=True)
    del grads_k, grads_r
    stats = {"step_loss": loss_k, "step_loss_ref": loss_r,
             "step_worst_err_over_bound": worst[0],
             "fwd_bwd_ms": cuda_ms(fwd_bwd, 1, 5),
             "fwd_bwd_plain_ms": cuda_ms(plain_fwd_bwd, 1, 5)}

    def step():
        trainer.train_step(batch, t=t, noise=noise)
    stats["train_step_ms"] = cuda_ms(step, 1, 5)
    stats["train_step_profile"] = profile_fn(step, TRAIN_GROUPS,
                                             "profile-train")
    print(f"[train-step] forward+backward B={b} {h}x{w}: K2 "
          f"{stats['fwd_bwd_ms']:.3f} ms, no-kernel reference "
          f"{stats['fwd_bwd_plain_ms']:.3f} ms; whole train step "
          f"{stats['train_step_ms']:.3f} ms", flush=True)
    return stats


K2_NAMES = ("attention_fwd", "attention_dq", "attention_dkv")
# K4's launch counters: every launch, and those that added a shift, a conv
# bias, a residual conv's bias
K4_NAMES = ("groupnorm_silu", "groupnorm_silu_shift", "groupnorm_silu_bias",
            "groupnorm_silu_residual_bias")
# device kernels grouped by name (first match wins)
FORWARD_GROUPS = [("flash_attention (K3)", ("flash_fwd_kernel",)),
                  ("groupnorm_silu (K4)", ("groupnorm_silu_kernel",)),
                  ("upsample", ("upsample",)),
                  ("max pool", ("pool",)),
                  ("layer/group norm (stock)", ("norm",)),
                  ("dtype casts and copies", ("copy",)),
                  ("convolution (cuDNN)", ("xmma", "conv", "gemm", "cutlass",
                                           "nchw", "nhwc"))]
TRAIN_GROUPS = [("attention (K2: fwd, dq, dk/dv, split sum)",
                 ("flash_fwd_kernel", "flash_bwd", "sum_splits")),
                ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
                ("upsample and its backward", ("upsample",)),
                ("max pool and its backward", ("pool",)),
                ("layer/group norm and backward (stock)", ("norm",)),
                ("reductions (incl. bias and K2 delta)", ("reduce",)),
                ("dtype casts and copies", ("copy",)),
                ("convolutions and their backward (cuDNN)",
                 ("xmma", "conv", "gemm", "cutlass", "nchw", "nhwc",
                  "dgrad", "wgrad"))]


def device_us(evt):
    us = getattr(evt, "self_device_time_total", None)
    return evt.self_cuda_time_total if us is None else us


def profile_fn(fn, groups, tag):
    """Device kernel time of one call of ``fn`` by kernel and by group
    (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue                       # host ops; their kernels are rows
        us = device_us(evt)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    by_group, launches = {}, {}
    for name, ms, count in rows:
        low = name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys)), "other elementwise")
        by_group[group] = by_group.get(group, 0.0) + ms
        launches[group] = launches.get(group, 0) + count
    for group, ms in sorted(by_group.items(), key=lambda g: -g[1]):
        print(f"[{tag}] {ms:8.3f} ms {100 * ms / total:5.1f}% "
              f"x{launches[group]:<5d} {group}", flush=True)
    for name, ms, count in rows[:10]:
        print(f"[{tag}]   {ms:8.3f} ms x{count:<4d} {name[:80]}", flush=True)
    print(f"[{tag}] kernel time {total:.3f} ms", flush=True)
    return {"kernel_ms": total, "groups": by_group,
            "group_launches": launches, "top": [list(r) for r in rows[:10]]}


def check_launches(K, want, what, failures):
    got = {k: K.LAUNCHES[k] for k in want}
    print(f"[{what}] launches {got}", flush=True)
    if got != want:
        failures.append(f"{what}: launches {got} != {want}")
    return got


def serving_launches(forwards):
    return {"flash_attention": 3 * forwards, "groupnorm_silu": 14 * forwards,
            "groupnorm_silu_shift": K4_SHIFT_PER_FORWARD * forwards,
            "groupnorm_silu_bias": 14 * forwards,
            "groupnorm_silu_residual_bias":
                K4_RESIDUAL_BIAS_PER_FORWARD * forwards,
            **{k: 0 for k in K2_NAMES}}


def check_images(arr, shape, what, failures):
    import numpy as np
    ok = (arr.shape == shape and np.isfinite(arr).all()
          and float(np.abs(arr).max()) <= 1.0)
    print(f"[{what}] shape {arr.shape} finite {bool(np.isfinite(arr).all())}"
          f" range [{float(arr.min()):.4f}, {float(arr.max()):.4f}]",
          flush=True)
    if not ok:
        failures.append(f"{what}: bad output {arr.shape}")


def k2_sites(K):
    """K2 launches of each kind per train step: the attentions of
    ATTN_SHAPES past ``kernels.attention``'s size gate."""
    return sum(n * m >= K.MIN_FLASH_ELEMS for _, _, n, m, _ in ATTN_SHAPES)


def train_path(K, cfg, init_params, failures):
    """``run_diffusion`` for TRAIN_EPOCHS epochs of TRAIN_STEPS steps, a
    resume that runs no epoch (it must restore exactly what was saved),
    and a resume that trains one more epoch. Launch counts of each run are
    read from zero."""
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    sites = k2_sites(K)
    step_events = []
    train_step = DiffusionTrainer.train_step

    def timed_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_step(self, *args, **kwargs)
        end.record()
        step_events.append((start, end))
        return out

    DiffusionTrainer.train_step = timed_step
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = L.run_diffusion(cfg, epochs=TRAIN_EPOCHS, epoch_scan=False,
                              max_steps_per_epoch=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trainer = res["trainer"]
        steps = len(step_events)
        evals = trainer.model.forwards - steps
        launches = check_launches(K, {
            "attention_fwd": sites * (steps + evals),
            "attention_dq": sites * steps,
            "attention_dkv": sites * steps, "flash_attention": 0,
            **{k: 0 for k in K4_NAMES}}, "train", failures)
        step_ms = sorted(s.elapsed_time(e) for s, e in step_events[1:])
        stats = {"train_steps": steps, "eval_forwards": evals,
                 "train_run_s": train_s,
                 "step_ms_median": step_ms[len(step_ms) // 2],
                 "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
                 "images_per_sec_median_step":
                     cfg.data.batch_size / step_ms[len(step_ms) // 2] * 1e3,
                 "log": res["log"], "val_rows": res["val_rows"],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if steps != TRAIN_EPOCHS * TRAIN_STEPS or evals != TRAIN_EPOCHS * 2:
            failures.append(f"train: {steps} steps and {evals} eval "
                            f"forwards, want {TRAIN_EPOCHS * TRAIN_STEPS} "
                            f"and {TRAIN_EPOCHS * 2}")
        if not all(math.isfinite(r["train_loss"]) and
                   math.isfinite(r["val_loss"]) for r in res["log"]):
            failures.append(f"train: non-finite loss {res['log']}")
        n_val = res["val"].num_examples
        if res["val_rows"] != n_val or n_val % cfg.data.batch_size == 0:
            failures.append(f"train: val rows scored {res['val_rows']}, "
                            f"want the {n_val} true rows of a padded split")
        final = trainer.model.state_dict()
        moved = sum(not torch.equal(init_params[k], v.cpu())
                    for k, v in final.items())
        if moved < len(final) // 2:
            failures.append(f"train: only {moved} of {len(final)} "
                            f"parameter tensors moved")
        for r in res["log"]:
            print(f"[train] epoch {int(r['epoch']) + 1}: train_loss "
                  f"{r['train_loss']:.6f} val_loss {r['val_loss']:.6f} "
                  f"images/s {r['images_per_sec']:.2f}", flush=True)
        print(f"[train] {steps} steps, {evals} eval forwards, val rows "
              f"{res['val_rows']} of {n_val} (padded batch of "
              f"{cfg.data.batch_size}); {moved}/{len(final)} parameter "
              f"tensors moved; step ms median {stats['step_ms_median']:.3f} "
              f"(min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}) after the "
              f"first = {stats['images_per_sec_median_step']:.1f} images/s; "
              f"peak memory {stats['peak_mem_gb']:.3f} GB", flush=True)

        # a resume with no epoch left restores, and must equal what was saved
        payload = Checkpointer(f"{cfg.run.out_dir}/ckpt").load()
        K.LAUNCHES.clear()
        back = L.run_diffusion(cfg, epochs=TRAIN_EPOCHS, resume=True,
                               epoch_scan=False,
                               device="cuda")["trainer"]
        same_params = all(torch.equal(final[k], v) and
                          torch.equal(payload["params"][k], v.cpu())
                          for k, v in back.model.state_dict().items())
        sa = trainer.opt.state_dict()["state"]
        sb = back.opt.state_dict()["state"]
        same_opt = sa.keys() == sb.keys() and all(
            torch.equal(sa[i][x].cpu(), sb[i][x].cpu())
            for i in sa for x in ("step", "exp_avg", "exp_avg_sq"))
        ok = (same_params and same_opt and payload["step"] == TRAIN_EPOCHS
              and back.step == steps == payload["opt_step"]
              and sum(K.LAUNCHES.values()) == 0)
        print(f"[resume] checkpoint epoch {payload['step']}, optimizer "
              f"steps {back.step}: params equal {same_params}, Adam state "
              f"equal {same_opt}", flush=True)
        if not ok:
            failures.append("resume did not restore what was saved")
        del back, trainer, res, final
        torch.cuda.empty_cache()

        step_events.clear()
        K.LAUNCHES.clear()
        res = L.run_diffusion(cfg, epochs=TRAIN_EPOCHS + 1, epoch_scan=False,
                              max_steps_per_epoch=TRAIN_STEPS, resume=True,
                              device="cuda")
        steps3 = len(step_events)
        evals3 = res["trainer"].model.forwards - steps3
        got = check_launches(K, {
            "attention_fwd": sites * (steps3 + evals3),
            "attention_dq": sites * steps3,
            "attention_dkv": sites * steps3, "flash_attention": 0,
            **{k: 0 for k in K4_NAMES}}, "train-resumed", failures)
        launches = {k: launches[k] + got[k] for k in launches}
        row = res["log"][-1]
        stats["resumed_log"] = res["log"]
        print(f"[train] resumed epoch {int(row['epoch']) + 1}: train_loss "
              f"{row['train_loss']:.6f} val_loss {row['val_loss']:.6f}",
              flush=True)
        if not (res["trainer"].step == steps + steps3 and
                math.isfinite(row["train_loss"]) and
                int(row["epoch"]) == TRAIN_EPOCHS):
            failures.append(f"resumed epoch: {res['log']}, optimizer step "
                            f"{res['trainer'].step}")
        stats["launches_per_step"] = {
            k: launches[k] / (steps + steps3) for k in K2_NAMES}
    finally:
        DiffusionTrainer.train_step = train_step
    return launches, stats


def serve_path(K, cfg, failures):
    """The serving requests on the trained checkpoint: a batch-size DDIM-50
    sample grid, then restoration of one val batch."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import make_image_datasets
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import ddim_timesteps
    latest = Checkpointer(f"{cfg.run.out_dir}/ckpt").latest_step()
    if latest != TRAIN_EPOCHS + 1:
        failures.append(f"serve: latest checkpoint {latest}, want the "
                        f"trained epoch {TRAIN_EPOCHS + 1}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stats = {"served_checkpoint": latest}

    # request 1: a 16-image DDIM-50 sample grid from the checkpoint
    K.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = cfg.data.batch_size
    path = L.sample_from_dir("diffusion", cfg, n=n, ddim_steps=50,
                             device="cuda")
    torch.cuda.synchronize()
    stats["sample_s"] = time.perf_counter() - t0
    forwards = len(ddim_timesteps(cfg.timesteps, 50))
    launches = check_launches(K, serving_launches(forwards), "sample",
                              failures)
    shape = (n,) + tuple(cfg.data.image_size) + (3,)
    check_images(np.load(path), shape, "sample", failures)

    # request 2: restoration of one val batch through the ancestral chain
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    trainer = L.restore_trainer(cfg, device="cuda")
    K.LAUNCHES.clear()
    f0 = trainer.model_fused.forwards
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = L.evaluate_diffusion(cfg, trainer, val, max_batches=1)
    torch.cuda.synchronize()
    stats["restore_s"] = time.perf_counter() - t0
    forwards_r = trainer.model_fused.forwards - f0
    got = check_launches(K, serving_launches(forwards_r), "restore",
                         failures)
    launches = {k: launches[k] + got[k] for k in launches}
    panel = np.load(OUT_DIR / "diffusion_restore_panel.npy")
    print(f"[restore] psnr {res['psnr']:.4f} dB mse {res['mse']:.6f} "
          f"panel {panel.shape}", flush=True)
    if not (math.isfinite(res["psnr"]) and panel.shape == (4, 4) + shape[1:]
            and float(np.abs(panel[2:]).max()) <= 1.0):
        failures.append(f"restore: bad result {res} / panel {panel.shape}")
    stats.update(
        sample_forwards=forwards, restore_forwards=forwards_r,
        psnr=res["psnr"], mse=res["mse"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[latency] sample request ({n} images, DDIM 50, checkpoint "
          f"restore included) {stats['sample_s']:.3f} s; restoration request "
          f"({n} images, {forwards_r} forwards) {stats['restore_s']:.3f} s; "
          f"peak memory {stats['peak_mem_gb']:.3f} GB", flush=True)
    return launches, stats


def smoke_config():
    """The default DiffusionConfig (256x256, batch 16, base_ch 64, T=1000,
    bf16 convs) on TRAIN_DATASET synthetic faces, writing under OUT_DIR."""
    from vgd_tpu_torch.core.config import DataConfig, DiffusionConfig, RunConfig
    return DiffusionConfig(
        data=DataConfig(batch_size=16, image_size=(256, 256),
                        dataset_size=TRAIN_DATASET),
        run=RunConfig(out_dir=str(OUT_DIR), seed=42))


def main_path(K, gen, failures):
    from vgd_tpu_torch.core.rng import seed_all
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer

    shutil.rmtree(OUT_DIR, ignore_errors=True)
    cfg = smoke_config()
    h, w = cfg.data.image_size
    # the same seeded init as run_diffusion's, kept to show the params move
    trainer = DiffusionTrainer(cfg, (h, w, 3), device="cuda")
    trainer.init(seed_all(cfg.run.seed, "cuda"))
    init_params = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[init] UNet base_ch {cfg.base_ch}, {n_params} parameters, "
          f"compute {cfg.run.compute_dtype}", flush=True)
    stats = check_unet(K, trainer, gen, failures)
    stats.update(check_train_step(K, trainer, gen, failures))
    del trainer
    train_launches, stats["train"] = train_path(K, cfg, init_params,
                                                failures)
    serve_launches, stats["serve"] = serve_path(K, cfg, failures)
    return train_launches, serve_launches, stats


# ---------------------------------------------------------------------------
# VAE-GAN: K1 on the flagship train step
# ---------------------------------------------------------------------------

# one step's first D step and G step, K1 against no kernel, same state and
# draws. In f32 (the same full-width model with compute_dtype float32) the
# DDPM step's bounds hold: each gradient within 5e-2 of its tensor's max |g|
# plus 1e-4 of its network's largest |g|, losses within 1e-3 relative. In
# bf16 (the main path) the step is chaotic at init: a one-ulp f32
# perturbation of the no-kernel reference's own conv outputs flips bf16
# roundings that the discriminator's real-minus-fake gradient and six
# BatchNorm backwards amplify past those bounds. So the bf16 comparison is
# held to VAEGAN_FLOOR_X times that noise floor, measured in the same run
# (the reference against itself with c * (1 + 2^-23 N(0, 1))), taken as
# the median over FLOOR_SEEDS: the loss floor varies six- to seventeen-fold
# between seeds on an H100, so a bound on the first seed alone rested on a
# draw.
VAEGAN_GRAD_REL, VAEGAN_GRAD_FLOOR, VAEGAN_LOSS_REL = 5e-2, 1e-4, 1e-3
VAEGAN_FLOOR_X = 3.0
# perturbation seeds of the bf16 noise floor: their median sets every bf16
# step's bound (VAE-GAN, VAE, DCGAN, WGAN, both Glow steps); all are printed
# to show the spread
FLOOR_SEEDS = (123, 124, 125)
# the seed of the VAE-GAN phase's own generator (its data and draws)
VAEGAN_SEED = 9
VAEGAN_GROUPS = [("K1 conv + batch statistics", ("conv_stats_",
                                                  "combine_stats")),
                 ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
                 ("reductions (BN statistics and backward, bias grads)",
                  ("reduce",)),
                 ("dtype casts and copies", ("copy",)),
                 ("convolutions and their backward (cuDNN)",
                  ("xmma", "conv", "gemm", "cutlass", "nchw", "nhwc",
                   "dgrad", "wgrad"))]


def vaegan_config():
    """The flagship VAE-GAN at the reference's training scale: 256x256,
    batch 64, latent 100, ngf = ndf = 64, three Adams at lr 2e-4, bf16
    convs, ``fused_conv=True`` (K1), on VAEGAN_DATASET synthetic faces."""
    from vgd_tpu_torch.core.config import DataConfig, RunConfig, VAEGANConfig
    return VAEGANConfig(
        data=DataConfig(batch_size=64, image_size=(256, 256),
                        dataset_size=VAEGAN_DATASET),
        run=RunConfig(out_dir=str(OUT_DIR / "vaegan"), seed=42,
                      fused_conv=True))


def vaegan_step_grads(trainer, batch, eps, nr, nf):
    """Losses and gradients of the first D step and of the G step of one
    train step (as ``train_step`` computes them, without the Adam
    updates)."""
    import torch
    from vgd_tpu_torch.models.blocks import frozen_running_stats
    from vgd_tpu_torch.ops.image import to_signed
    x = to_signed(batch)
    cfg = trainer.cfg
    noise_real, noise_fake = cfg.instance_noise * nr, cfg.instance_noise * nf
    with torch.no_grad(), frozen_running_stats(trainer.encoder,
                                               trainer.decoder):
        _, _, recon0 = trainer.encode_decode(x, eps)
    real_noisy = x + noise_real
    trainer.disc.zero_grad(set_to_none=True)
    d_loss = trainer.d_loss(real_noisy, recon0 + noise_fake)
    d_loss.backward()
    d_grads = {f"disc.{n}": p.grad.clone()
               for n, p in trainer.disc.named_parameters()}
    trainer.disc.zero_grad(set_to_none=True)
    total, parts = trainer.g_loss(x, eps, real_noisy, noise_fake, 1.0)
    names = [(f"{net}.{n}", p) for net in ("encoder", "decoder")
             for n, p in getattr(trainer, net).named_parameters()]
    g_grads = dict(zip([n for n, _ in names], torch.autograd.grad(
        total, [p for _, p in names])))
    losses = {"d_loss": d_loss.item(), "g_total": total.item(),
              **{k: v.item() for k, v in parts.items()}}
    return losses, d_grads, g_grads


def compare_step(got, ref, loss_scale=None):
    """(worst gradient error over its bound, that gradient's name, largest
    loss difference) of two step results (losses, grads, grads, ...): the
    loss difference relative to the reference loss, or to
    ``loss_scale[k]`` where that is larger (a WGAN critic loss, a
    difference of two means of probabilities, is near 0 and measured
    against their range, 1)."""
    (lk, *gk), (lr, *gr) = got, ref
    worst = (0.0, "")
    for g_all, r_all in zip(gk, gr):
        top = max(float(g.abs().max()) for g in r_all.values())
        for name, r in r_all.items():
            err = float((g_all[name] - r).abs().max())
            bound = VAEGAN_GRAD_REL * float(r.abs().max()) + \
                VAEGAN_GRAD_FLOOR * top
            worst = max(worst, (err / bound, name))
    scale = loss_scale or {}
    loss_rel = max(abs(lk[k] - lr[k]) / max(abs(lr[k]), scale.get(k, 0.0))
                   for k in lr)
    return worst[0], worst[1], loss_rel


def floor_spread(floors):
    """Per seed, and min / median / max over the seeds, of the noise floor
    (worst gradient err/bound, relative loss difference)."""
    worst = sorted(f[0] for f in floors.values())
    loss = sorted(f[2] for f in floors.values())
    mid = len(worst) // 2
    return {"per_seed": {str(k): {"worst": f[0], "tensor": f[1],
                                  "loss_rel": f[2]}
                         for k, f in floors.items()},
            "worst_min_median_max": [worst[0], worst[mid], worst[-1]],
            "loss_min_median_max": [loss[0], loss[mid], loss[-1]]}


def floor_line(spread):
    w, lo = spread["worst_min_median_max"], spread["loss_min_median_max"]
    return (f"floor over seeds {FLOOR_SEEDS}: worst min {w[0]:.3f} median "
            f"{w[1]:.3f} max {w[2]:.3f}, loss min {lo[0]:.3g} median "
            f"{lo[1]:.3g} max {lo[2]:.3g}")


def k1_shapes(shapes):
    """What K1 sees at each entry of a K1 shape table: (x's shape, (K,
    Cin), padding)."""
    return {((b, h, w, ci), (k, ci), p)
            for _, b, h, w, ci, k, p, _ in shapes}


def perturbed_by(fn, seed):
    """``fn`` with its output (the first of a tuple) perturbed by one f32
    ulp, the noise drawn from ``seed``."""
    import torch

    def perturbed(*args):
        out = fn(*args)
        first = out[0] if isinstance(out, tuple) else out
        g = torch.Generator(device=first.device).manual_seed(seed)
        first = first * (1 + 2.0 ** -23 * torch.randn(
            first.shape, device=first.device, generator=g))
        return (first,) + out[1:] if isinstance(out, tuple) else first
    return perturbed


def no_kernel_runs(K, plain_name, dtype, run, tag, failures):
    """``run()`` with no kernel (``kernels.plain_reference``) as "plain";
    in bf16 once more for each seed of FLOOR_SEEDS with ``K.<plain_name>``
    perturbed by one f32 ulp (``perturbed_by``) as "perturbed_<seed>". A
    no-kernel run that launches a kernel fails."""
    plain = getattr(K, plain_name)
    runs = {}
    for name, fn in [("plain", plain)] + [
            (f"perturbed_{seed}", perturbed_by(plain, seed))
            for seed in FLOOR_SEEDS if dtype == "bfloat16"]:
        K.LAUNCHES.clear()
        setattr(K, plain_name, fn)
        try:
            with K.plain_reference():
                runs[name] = run()
        finally:
            setattr(K, plain_name, plain)
        if sum(K.LAUNCHES.values()):
            failures.append(f"{tag}: the no-kernel reference launched "
                            f"{dict(K.LAUNCHES)}")
    return runs


def hold_to_floor(tag, dtype, kern, runs, compare, loss_bound, failures):
    """Hold a step with kernels (``kern``) to the no-kernel step
    (``runs["plain"]``, from ``no_kernel_runs``); ``compare(got, ref)``
    gives (worst gradient err/bound, its tensor, loss difference). f32:
    worst <= 1 and loss <= ``loss_bound``; bf16: the larger of those and
    VAEGAN_FLOOR_X times the median over FLOOR_SEEDS of the perturbed runs'
    own noise floor. Returns (row, text for the log line)."""
    worst, wname, loss_rel = compare(kern, runs["plain"])
    row = {"worst_err_over_bound": worst, "worst_tensor": wname,
           "loss_rel": loss_rel}
    text = (f"worst err/bound {worst:.3f} ({wname}), largest loss "
            f"difference {loss_rel:.3g}")
    worst_max, loss_max = 1.0, loss_bound
    if dtype == "bfloat16":
        spread = floor_spread({
            seed: compare(runs[f"perturbed_{seed}"], runs["plain"])
            for seed in FLOOR_SEEDS})
        fworst = spread["worst_min_median_max"][1]
        floss = spread["loss_min_median_max"][1]
        row.update(floor_worst_err_over_bound=fworst, floor_loss_rel=floss,
                   floors=spread)
        text += (f"; held at the f32 bounds or {VAEGAN_FLOOR_X} x the "
                 f"median floor (worst {fworst:.3f}, loss {floss:.3g}), "
                 f"whichever is larger; " + floor_line(spread))
        worst_max = max(worst_max, VAEGAN_FLOOR_X * fworst)
        loss_max = max(loss_max, VAEGAN_FLOOR_X * floss)
    if not (worst <= worst_max and loss_rel <= loss_max):
        failures.append(f"{tag} {dtype}: kernels vs no-kernel reference "
                        f"{row}")
    return row, text


def held_step(K, tag, make, draws, grads_fn, shapes, launches, failures,
              loss_scale=None):
    """``grads_fn(trainer, *draws(trainer))`` (losses and gradients of one
    step) with K1 against the same state and inputs with no kernel, held
    by ``hold_to_floor`` at VAEGAN_LOSS_REL (the bf16 floor from K1's
    plain conv output perturbed). ``make(dtype)`` builds and inits a
    trainer; K1 must see exactly ``shapes`` ((B, H, W, Cin), (K, Cin),
    padding) in ``launches`` launches. Returns (stats, the bf16 trainer
    with its state restored, its inputs)."""
    import torch
    stats = {}
    for dtype in ("float32", "bfloat16"):
        trainer = make(dtype)
        inputs = draws(trainer)
        state = {k: v.clone() for k, v in trainer.state_dict().items()}
        seen = []
        conv_stats = K.conv_stats

        def recording(xx, ww, pad):
            seen.append((tuple(xx.shape), tuple(ww.shape[:2]), pad))
            return conv_stats(xx, ww, pad)
        K.conv_stats = recording
        try:
            K.LAUNCHES.clear()
            kern = grads_fn(trainer, *inputs)
            got = K.LAUNCHES["conv_bn_stats"]
        finally:
            K.conv_stats = conv_stats

        def run():
            trainer.load(state)
            return grads_fn(trainer, *inputs)
        runs = no_kernel_runs(K, "conv_stats_plain", dtype, run, tag,
                              failures)
        trainer.load(state)
        if set(seen) != set(shapes) or got != launches:
            failures.append(f"{tag} {dtype}: K1 saw {sorted(set(seen))} in "
                            f"{got} launches, want {sorted(shapes)} in "
                            f"{launches}")
        row, text = hold_to_floor(
            tag, dtype, kern, runs,
            lambda a, b: compare_step(a, b, loss_scale), VAEGAN_LOSS_REL,
            failures)
        row.update(k1_launches=got, losses=kern[0],
                   losses_ref=runs["plain"][0])
        print(f"[{tag}] {dtype} K1 vs no-kernel reference: losses " +
              " ".join(f"{k} {kern[0][k]:.6f}/{runs['plain'][0][k]:.6f}"
                       for k in kern[0]) +
              f"; {sum(len(g) for g in kern[1:])} gradients, {text}; K1 "
              f"launches {got} at {len(set(seen))} shapes", flush=True)
        stats[f"step_{dtype}"] = row
        del kern, runs
        if dtype == "float32":
            del trainer
            torch.cuda.empty_cache()
    return stats, trainer, inputs


def timed_step(K, tag, step, batch_size, failures, launches=None):
    """One whole bf16 train step: CUDA-event time with K1 and with no
    kernel, images/s, its profile by kernel group, and
    the K1 launches of one step against ``launches``."""
    import torch

    def plain_step():
        with K.plain_reference():
            step()
    torch.cuda.reset_peak_memory_stats()
    stats = {"train_step_ms": cuda_ms(step, 2, 5),
             "train_step_plain_ms": cuda_ms(plain_step, 2, 5)}
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["train_step_profile"] = profile_fn(step, VAEGAN_GROUPS,
                                             f"profile-{tag}")
    K.LAUNCHES.clear()
    step()
    stats["k1_launches"] = K.LAUNCHES["conv_bn_stats"]
    if launches is not None and stats["k1_launches"] != launches:
        failures.append(f"{tag}: a train step launched K1 "
                        f"{stats['k1_launches']} times, want {launches}")
    print(f"[{tag}] whole bf16 train step: K1 {stats['train_step_ms']:.3f} ms"
          f" = {batch_size / stats['train_step_ms'] * 1e3:.1f} images/s, "
          f"no-kernel reference {stats['train_step_plain_ms']:.3f} ms; peak "
          f"memory {stats['peak_mem_gb']:.3f} GB; K1 launches "
          f"{stats['k1_launches']}", flush=True)
    return stats


def check_vaegan_step(K, cfg, gen, failures):
    """The first D step's and the G step's losses and gradients with K1
    against the same state and draws with no kernel (``held_step``; the
    shapes K1 sees in one bf16 step against K1_SHAPES, 23 launches: first D
    step 10, recon0 4, G step 9); then one whole bf16 train step timed and
    profiled (``timed_step``)."""
    import dataclasses
    import torch
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size

    def make(dtype):
        tr = VAEGANTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, compute_dtype=dtype)), (h, w, 3), device="cuda")
        tr.init(torch.Generator(device=tr.device).manual_seed(cfg.run.seed))
        return tr

    def draws(tr):
        batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                              device=tr.device, generator=gen)
        return (batch,) + tuple(
            torch.randn(shape, device=tr.device, generator=gen)
            for shape in ((b, cfg.latent_dim), (b, h, w, 3), (b, h, w, 3)))
    stats, trainer, (batch, eps, nr, nf) = held_step(
        K, "vaegan-step", make, draws, vaegan_step_grads,
        k1_shapes(K1_SHAPES), 23, failures)
    n_params = {n: sum(p.numel() for p in net.parameters())
                for n, net in trainer.nets().items()}
    print(f"[vaegan-init] {h}x{w} B={b} latent {cfg.latent_dim} ngf "
          f"{cfg.ngf} ndf {cfg.ndf} fused_conv {cfg.run.fused_conv}; "
          f"parameters {n_params}", flush=True)
    stats.update(timed_step(
        K, "vaegan-step", lambda: trainer.train_step(
            batch, 1.0, eps=eps, noise_real=nr, noise_fake=nf),
        b, failures, K1_PER_STEP))
    return stats


def opt_states(trainer):
    """Every optimizer's state_dict of a trainer, by name."""
    opts = getattr(trainer, "opts", None) or {"adam": trainer.opt}
    return {name: opt.state_dict() for name, opt in opts.items()}


def family_train_path(K, tag, cls, run, cfg, steps_per_epoch, epochs,
                      per_step, counted, keys, failures):
    """``run(cfg)`` (``run_vaegan``, ``run_vae``, ``run_gan``) for
    ``epochs`` epochs of ``steps_per_epoch`` steps, a resume that runs no
    epoch (it must restore exactly what was saved: parameters, BN buffers,
    every Adam state, the optimizer step), and a resume that trains one
    more epoch. The trainer class ``cls``'s ``counted`` methods (the train
    step first) are wrapped to count K1 launches and time each call with
    CUDA events: exactly ``per_step`` K1 launches per train step, none in
    the others, and no other kernel. ``keys`` are the log's metrics, which
    must be finite. Every run takes the per-step loop (the scan replays
    graphs, which no wrapper sees)."""
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    step_name = counted[0]
    calls = {n: [] for n in counted}
    originals = {n: getattr(cls, n) for n in calls}

    def wrap(name):
        fn = originals[name]

        def counted_call(self, *args, **kwargs):
            before = K.LAUNCHES["conv_bn_stats"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kwargs)
            end.record()
            calls[name].append((K.LAUNCHES["conv_bn_stats"] - before,
                                start, end, out))
            return out
        return counted_call

    for n in calls:
        setattr(cls, n, wrap(n))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = run(cfg, epochs=epochs, max_steps_per_epoch=steps_per_epoch,
                  device="cuda", epoch_scan=False)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        total = K.LAUNCHES["conv_bn_stats"]
        trainer = res["trainer"]
        per = {n: [c[0] for c in v] for n, v in calls.items()}
        steps = len(per[step_name])
        step_ms = sorted(s_.elapsed_time(e) for _, s_, e, _ in
                         calls[step_name][1:])
        bad = [i for i, (*_, m) in enumerate(calls[step_name])
               if not all(math.isfinite(float(v)) for v in m.values())]
        if bad:
            failures.append(f"{tag}: non-finite losses from step {bad[0]}: "
                            f"{calls[step_name][bad[0]][3]}")
        others = {n: sum(v) for n, v in per.items() if n != step_name}
        median = step_ms[len(step_ms) // 2]
        stats = {"train_steps": steps, "train_run_s": train_s,
                 "k1_launches": total,
                 "k1_per_step": sorted(set(per[step_name])),
                 "k1_in": others, "calls": {n: len(v) for n, v in
                                            per.items()},
                 "step_ms_median": median, "step_ms_min": step_ms[0],
                 "step_ms_max": step_ms[-1],
                 "images_per_sec_median_step":
                     cfg.data.batch_size / median * 1e3,
                 "log": res["log"],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[{tag}] launches: K1 {total} in {steps} train steps (per "
              f"step {stats['k1_per_step']}), " + ", ".join(
                  f"{len(per[n])} {n} calls {others[n]}" for n in others)
              + f"; all launches {dict(K.LAUNCHES)}", flush=True)
        if (steps != epochs * steps_per_epoch
                or stats["k1_per_step"] != [per_step] or any(others.values())
                or total != per_step * steps
                or set(K.LAUNCHES) - {"conv_bn_stats"}):
            failures.append(f"{tag}: {steps} steps, K1 per step "
                            f"{stats['k1_per_step']} (want {per_step}), "
                            f"elsewhere {others}, all {dict(K.LAUNCHES)}")
        if not all(math.isfinite(r[k]) for r in res["log"] for k in keys):
            failures.append(f"{tag}: non-finite metrics {res['log']}")
        if "val_rows" in res:
            stats["val_rows"] = res["val_rows"]
            if res["val_rows"] != res["val"].num_examples:
                failures.append(f"{tag}: val rows {res['val_rows']} of "
                                f"{res['val'].num_examples}")
        for r in res["log"]:
            print(f"[{tag}] epoch {int(r['epoch']) + 1}: " + " ".join(
                f"{k} {r[k]:.5f}" for k in keys) +
                f" images/s {r['images_per_sec']:.1f}", flush=True)
        print(f"[{tag}] {steps} steps; step ms median {median:.3f} (min "
              f"{step_ms[0]:.3f}, max {step_ms[-1]:.3f}) after the first = "
              f"{stats['images_per_sec_median_step']:.1f} images/s; peak "
              f"memory {stats['peak_mem_gb']:.3f} GB", flush=True)

        # a resume with no epoch left restores, and must equal what was saved
        final = {k: v.clone() for k, v in trainer.state_dict().items()}
        payload = Checkpointer(f"{cfg.run.out_dir}/ckpt").load()
        K.LAUNCHES.clear()
        back = run(cfg, epochs=epochs, resume=True, device="cuda",
                   epoch_scan=False)["trainer"]
        same_params = all(torch.equal(final[k], v) and
                          torch.equal(payload["params"][k], v.cpu())
                          for k, v in back.state_dict().items())
        same_opt = True
        oa, ob = opt_states(trainer), opt_states(back)
        for name in oa:
            sa, sb = oa[name]["state"], ob[name]["state"]
            same_opt &= sa.keys() == sb.keys() and all(
                torch.equal(sa[i][x].cpu(), sb[i][x].cpu())
                for i in sa for x in ("step", "exp_avg", "exp_avg_sq"))
        ok = (same_params and same_opt and payload["step"] == epochs
              and back.step == steps == payload["opt_step"]
              and sum(K.LAUNCHES.values()) == 0)
        print(f"[{tag.split('-')[0]}-resume] checkpoint epoch "
              f"{payload['step']}, optimizer steps {back.step}: params and "
              f"BN buffers equal {same_params}, {len(oa)} Adam state(s) "
              f"equal {same_opt}", flush=True)
        if not ok:
            failures.append(f"{tag}: resume did not restore what was saved")
        del back, trainer, res, final
        torch.cuda.empty_cache()

        for v in calls.values():
            v.clear()
        K.LAUNCHES.clear()
        res = run(cfg, epochs=epochs + 1, max_steps_per_epoch=steps_per_epoch,
                  resume=True, device="cuda", epoch_scan=False)
        steps3 = len(calls[step_name])
        got = K.LAUNCHES["conv_bn_stats"]
        row = res["log"][-1]
        print(f"[{tag}] resumed epoch {int(row['epoch']) + 1}: " +
              " ".join(f"{k} {row[k]:.5f}" for k in keys) +
              f"; K1 launches {got} in {steps3} steps", flush=True)
        if not (res["trainer"].step == steps + steps3
                == (epochs + 1) * steps_per_epoch
                and got == per_step * steps3
                and int(row["epoch"]) == epochs
                and all(math.isfinite(row[k]) for k in keys)):
            failures.append(f"{tag} resumed epoch: {res['log']}, step "
                            f"{res['trainer'].step}, K1 launches {got}")
        stats["resumed_log"] = res["log"]
        stats["k1_launches"] = total + got
    finally:
        for n, fn in originals.items():
            setattr(cls, n, fn)
    return stats


def vaegan_train_path(K, cfg, failures):
    """``family_train_path`` of ``run_vaegan``: VAEGAN_EPOCHS epochs of
    VAEGAN_STEPS steps, K1_PER_STEP launches a step, none in validation or
    ``generate``."""
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    return family_train_path(
        K, "vaegan-train", VAEGANTrainer, L.run_vaegan, cfg, VAEGAN_STEPS,
        VAEGAN_EPOCHS, K1_PER_STEP, ("train_step", "eval_step", "generate"),
        ("train_recon", "train_kl", "train_adv", "train_d_loss", "val_loss",
         "ssim", "psnr"), failures)


def vaegan_serve_path(K, cfg, failures):
    """``sample_from_dir("vaegan", n=64)`` on the trained checkpoint: a
    64-image grid, finite and in [-1, 1], with no K1 launch."""
    import numpy as np
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    latest = Checkpointer(f"{cfg.run.out_dir}/ckpt").latest_step()
    if latest != VAEGAN_EPOCHS + 1:
        failures.append(f"vaegan-serve: latest checkpoint {latest}, want "
                        f"{VAEGAN_EPOCHS + 1}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = L.sample_from_dir("vaegan", cfg, n=64, device="cuda")
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if sum(launches.values()):
        failures.append(f"vaegan-serve launched {launches}")
    check_images(np.load(path), (64,) + tuple(cfg.data.image_size) + (3,),
                 "vaegan-serve", failures)
    stats = {"served_checkpoint": latest, "sample_s": sample_s,
             "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[vaegan-serve] sample request (64 images, checkpoint restore "
          f"included) {sample_s:.3f} s; launches {launches}; peak memory "
          f"{stats['peak_mem_gb']:.3f} GB", flush=True)
    return stats


def vaegan_path(K, gen, failures):
    cfg = vaegan_config()
    shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    stats = check_vaegan_step(K, cfg, gen, failures)
    stats["train"] = vaegan_train_path(K, cfg, failures)
    stats["serve"] = vaegan_serve_path(K, cfg, failures)
    return stats


# ---------------------------------------------------------------------------
# The denoising VAE and DCGAN / WGAN: K1 at their 64x64 shapes
# ---------------------------------------------------------------------------

# the denoising VAE at the reference's scale (main_vae.py: 64x64, batch 64,
# latent 100, ngf 64, one joint Adam at 1e-3), bf16 convs, fused_conv: 640
# synthetic faces -> 576 train (9 batches) / 64 val; 2 epochs, a resume, a
# third
VAE_DATASET, VAE_STEPS, VAE_EPOCHS = 640, 9, 2
# DCGAN / WGAN at the reference's scale (gan_code.py: 64x64, batch 128,
# ngf = ndf = 64, latent 100), bf16, fused_conv: 640 faces -> 576 train
# (4 batches of 128); DCGAN 2 epochs of 4 steps, a resume, a third; WGAN 1
# epoch of 2 steps, a resume, a second
GAN_DATASET, GAN_STEPS, GAN_EPOCHS = 640, 4, 2
WGAN_STEPS, WGAN_EPOCHS = 2, 1
# each phase's own generator (its data and draws)
VAE_SEED, GAN_SEED = 10, 11


def vae_config():
    """The denoising VAE at the reference's training scale: 64x64, batch
    64, latent 100, ngf 64, noise std 0.5, bf16, ``fused_conv=True``."""
    from vgd_tpu_torch.core.config import DataConfig, RunConfig, VAEConfig
    return VAEConfig(
        data=DataConfig(batch_size=64, image_size=(64, 64),
                        dataset_size=VAE_DATASET, noise_max_std=0.5,
                        occlusion=False),
        run=RunConfig(out_dir=str(OUT_DIR / "vae"), seed=42,
                      fused_conv=True))


def gan_config(wgan=False):
    """DCGAN (or WGAN) at the reference's training scale: 64x64, batch 128,
    latent 100, ngf = ndf = 64, bf16, ``fused_conv=True``."""
    from vgd_tpu_torch.core.config import DataConfig, GANConfig, RunConfig
    return GANConfig(
        data=DataConfig(batch_size=128, image_size=(64, 64),
                        dataset_size=GAN_DATASET),
        run=RunConfig(out_dir=str(OUT_DIR / ("wgan" if wgan else "gan")),
                      seed=42, fused_conv=True), wgan=wgan)


def vae_step_grads(trainer, batch, noise, eps):
    """The loss parts and every gradient of one VAE train step (its
    ``corrupt_batch`` and ``loss`` at ramp 1, without the Adam update)."""
    import torch
    from vgd_tpu_torch.ops.image import to_signed
    img = to_signed(batch)
    total, parts = trainer.loss(img, trainer.corrupt_batch(img, noise), eps,
                                1.0)
    names = [(f"{net}.{n}", p) for net, m in trainer.nets().items()
             for n, p in m.named_parameters()]
    grads = dict(zip([n for n, _ in names], torch.autograd.grad(
        total, [p for _, p in names])))
    return {"total": total.item(),
            **{k: v.item() for k, v in parts.items()}}, grads


def gan_step_grads(trainer, batch, z):
    """The losses and gradients of a GAN step's first D step and of its G
    step (its ``d_loss`` and ``g_loss``, without the Adam updates; the G
    step through the D before its update): DCGAN z (B, latent), WGAN z
    (critic_iters + 1, B, latent)."""
    import torch
    from vgd_tpu_torch.models.blocks import frozen_running_stats
    from vgd_tpu_torch.models.vae import latent_to_spatial
    from vgd_tpu_torch.ops.image import to_signed
    wgan = trainer.cfg.wgan
    x = to_signed(batch)
    zd, zg = (z[0], z[-1]) if wgan else (z, z)
    with torch.no_grad(), frozen_running_stats(trainer.gen):
        fake = trainer.gen(latent_to_spatial(zd), train=True)
    trainer.disc.zero_grad(set_to_none=True)
    d_loss = trainer.d_loss(x, fake, wgan)
    d_loss.backward()
    d_grads = {f"disc.{n}": p.grad.clone()
               for n, p in trainer.disc.named_parameters()}
    trainer.disc.zero_grad(set_to_none=True)
    g_loss = trainer.g_loss(zg, wgan)
    names = list(trainer.gen.named_parameters())
    g_grads = dict(zip([f"gen.{n}" for n, _ in names], torch.autograd.grad(
        g_loss, [p for _, p in names])))
    return {"d_loss": d_loss.item(), "g_loss": g_loss.item()}, d_grads, \
        g_grads


def check_vae_steps(K, cfg, gen, failures):
    """One VAE train step with K1 against no kernel (``held_step``), with
    the fixed-std noise and with occlusion corruption; one whole bf16 step
    timed and profiled."""
    import dataclasses
    import torch
    from vgd_tpu_torch.data.corrupt import corrupt_draws
    from vgd_tpu_torch.train.vae import VAETrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size
    stats = {}
    for occlusion in (False, True):
        ocfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, occlusion=occlusion))

        def make(dtype):
            tr = VAETrainer(dataclasses.replace(ocfg, run=dataclasses.replace(
                ocfg.run, compute_dtype=dtype)), (h, w, 3), device="cuda")
            tr.init(torch.Generator(device=tr.device).manual_seed(
                ocfg.run.seed))
            return tr

        def draws(tr):
            batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                                  device=tr.device, generator=gen)
            noise = corrupt_draws(batch.shape, gen, tr.device) if occlusion \
                else torch.randn(batch.shape, device=tr.device,
                                 generator=gen)
            eps = torch.randn(b, ocfg.latent_dim, device=tr.device,
                              generator=gen)
            return batch, noise, eps
        tag = "vae-step" + (" occlusion" if occlusion else "")
        row, trainer, inputs = held_step(
            K, tag, make, draws, vae_step_grads, k1_shapes(K1_VAE_SHAPES),
            K1_VAE_PER_STEP, failures)
        stats["occlusion" if occlusion else "noise"] = row
    batch, noise, eps = inputs
    stats.update(timed_step(
        K, "vae-step", lambda: trainer.train_step(batch, 1.0, noise=noise,
                                                  eps=eps),
        b, failures, K1_VAE_PER_STEP))
    return stats


def vae_serve_path(K, cfg, failures):
    """On the trained checkpoint, on the card: ``evaluate_vae_checkpoints``
    (the latest checkpoint, 1 encode batch of each split, 1 eval batch),
    ``evaluate_vae_occlusion`` (1 batch, re-noise cycles, traversals),
    ``sample_from_dir("vae", n=64)`` and ``denoise_images`` on 16 uint8
    images: finite outputs of the right shapes, no K1 launch, each
    request's wall time."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import synthetic_faces
    from vgd_tpu_torch.train import loop as L
    (h, w) = cfg.data.image_size
    stats = {}

    def request(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stats[f"{name}_s"] = time.perf_counter() - t0
        return out
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.clear()
    sweep = request("sweep", lambda: L.evaluate_vae_checkpoints(
        cfg, max_checkpoints=1, max_encode_batches=1, max_eval_batches=1,
        device="cuda"))
    occl = request("occlusion", lambda: L.evaluate_vae_occlusion(
        cfg, max_batches=1, device="cuda"))
    path = request("sample", lambda: L.sample_from_dir("vae", cfg, n=64,
                                                       device="cuda"))
    check_images(np.load(path), (64, h, w, 3), "vae-serve sample", failures)
    imgs = synthetic_faces(16, (h, w), 3, seed=3)
    out = request("denoise", lambda: L.denoise_images(
        cfg, f"{cfg.run.out_dir}/ckpt", imgs, seed=5, device="cuda"))
    launches = dict(K.LAUNCHES)
    if not (len(sweep) == 1 and 0 < sweep[0]["ssim"] <= 1
            and all(math.isfinite(v) for v in occl.values())
            and out.shape == imgs.shape and out.dtype == np.uint8
            and not sum(launches.values())):
        failures.append(f"vae-serve: sweep {sweep}, occlusion {occl}, "
                        f"denoise {out.shape} {out.dtype}, launches "
                        f"{launches}")
    for name in ("triplets", "renoise_cycles", "traversal_mu",
                 "traversal_logvar"):
        arr = np.load(f"{cfg.run.out_dir}/occlusion_{name}.npy")
        if not np.isfinite(arr).all():
            failures.append(f"vae-serve: occlusion_{name} not finite")
    stats.update(sweep=sweep, occlusion=occl, launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[vae-serve] requests (checkpoint restore included): sweep "
          f"{stats['sweep_s']:.3f} s (ssim {sweep[0]['ssim']:.4f}), "
          f"occlusion test {stats['occlusion_s']:.3f} s (" + " ".join(
              f"{k} {v:.4f}" for k, v in occl.items()) + f"), 64-image "
          f"sample {stats['sample_s']:.3f} s, 16-image denoise "
          f"{stats['denoise_s']:.3f} s; launches {launches}; peak memory "
          f"{stats['peak_mem_gb']:.3f} GB", flush=True)
    return stats


def vae_path(K, gen, failures):
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.vae import VAETrainer
    cfg = vae_config()
    shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    stats = check_vae_steps(K, cfg, gen, failures)
    stats["train"] = family_train_path(
        K, "vae-train", VAETrainer, L.run_vae, cfg, VAE_STEPS, VAE_EPOCHS,
        K1_VAE_PER_STEP, ("train_step", "eval_step", "generate", "denoise"),
        ("train_loss", "val_loss", "mse", "psnr", "ssim"), failures)
    stats["serve"] = vae_serve_path(K, cfg, failures)
    stats["phase_s"] = time.perf_counter() - t0
    print(f"[vae] phase {stats['phase_s']:.1f} s", flush=True)
    return stats


def check_gan_step(K, cfg, gen, failures):
    """One DCGAN (or WGAN) step's first D step and G step with K1 against
    no kernel (``held_step``); one whole bf16 train step timed and
    profiled; after a WGAN step every D parameter within +-clip_value."""
    import dataclasses
    import torch
    from vgd_tpu_torch.train.gan import GANTrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size
    tag = "wgan-step" if cfg.wgan else "gan-step"

    def make(dtype):
        tr = GANTrainer(dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, compute_dtype=dtype)), (h, w, 3), device="cuda")
        tr.init(torch.Generator(device=tr.device).manual_seed(cfg.run.seed))
        return tr

    def draws(tr):
        batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                              device=tr.device, generator=gen)
        shape = ((cfg.critic_iters + 1,) if cfg.wgan else ()) + \
            (b, cfg.latent_dim)
        return batch, torch.randn(shape, device=tr.device, generator=gen)
    # the gradients' forwards: three D forwards (real, fake, the G step's)
    stats, trainer, (batch, z) = held_step(
        K, tag, make, draws, gan_step_grads, k1_shapes(K1_GAN_SHAPES),
        K1_GAN_PER_STEP, failures,
        loss_scale={"d_loss": 1.0} if cfg.wgan else None)
    fn = trainer.train_step_wgan if cfg.wgan else trainer.train_step
    stats.update(timed_step(
        K, tag, lambda: fn(batch, z=z), b, failures,
        K1_WGAN_PER_STEP if cfg.wgan else K1_GAN_PER_STEP))
    if cfg.wgan:
        top = max(float(p.detach().abs().max())
                  for p in trainer.disc.parameters())
        stats["disc_param_max_abs"] = top
        print(f"[{tag}] after the step every D parameter within "
              f"+-{cfg.clip_value}: max |p| {top:.6f}", flush=True)
        if top > cfg.clip_value:
            failures.append(f"{tag}: a D parameter at {top} after clipping")
    return stats


def gan_serve_path(K, cfgs, failures):
    """On each trained checkpoint (DCGAN, WGAN), on the card:
    ``evaluate_gan_checkpoints`` (the latest checkpoint, every val batch)
    and ``sample_from_dir`` (64 images): SSIM in (0, 1], finite images in
    [-1, 1], no K1 launch, each request's wall time."""
    import numpy as np
    import torch
    from vgd_tpu_torch.train import loop as L
    stats = {}
    for cfg in cfgs:
        name = "wgan" if cfg.wgan else "gan"
        torch.cuda.empty_cache()
        K.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep = L.evaluate_gan_checkpoints(cfg, max_checkpoints=1,
                                           device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        path = L.sample_from_dir(name, cfg, n=64, device="cuda")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check_images(np.load(path), (64,) + tuple(cfg.data.image_size) + (3,),
                     f"gan-serve {name}", failures)
        launches = dict(K.LAUNCHES)
        if not (len(sweep) == 1 and 0 < sweep[0]["ssim"] <= 1
                and not sum(launches.values())):
            failures.append(f"gan-serve {name}: sweep {sweep}, launches "
                            f"{launches}")
        stats[name] = {"sweep": sweep, "sweep_s": t1 - t0,
                       "sample_s": t2 - t1, "launches": launches}
        print(f"[gan-serve] {name}: checkpoint sweep {t1 - t0:.3f} s (ssim "
              f"{sweep[0]['ssim']:.4f}), 64-image sample {t2 - t1:.3f} s "
              f"(checkpoint restore included); launches {launches}",
              flush=True)
    return stats


def gan_path(K, gen, failures):
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.gan import GANTrainer
    t0 = time.perf_counter()
    stats = {}
    cfgs = (gan_config(), gan_config(wgan=True))
    for cfg in cfgs:
        shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
        stats["wgan_step" if cfg.wgan else "step"] = check_gan_step(
            K, cfg, gen, failures)
    counted = ("train_step", "generate")
    keys = ("d_loss", "g_loss")
    stats["train"] = family_train_path(
        K, "gan-train", GANTrainer, L.run_gan, cfgs[0], GAN_STEPS,
        GAN_EPOCHS, K1_GAN_PER_STEP, counted, keys, failures)
    stats["wgan_train"] = family_train_path(
        K, "gan-train wgan", GANTrainer, L.run_gan, cfgs[1], WGAN_STEPS,
        WGAN_EPOCHS, K1_WGAN_PER_STEP, ("train_step_wgan", "generate"), keys,
        failures)
    stats["serve"] = gan_serve_path(K, cfgs, failures)
    stats["phase_s"] = time.perf_counter() - t0
    print(f"[gan] phase {stats['phase_s']:.1f} s", flush=True)
    return stats


# ---------------------------------------------------------------------------
# Glow: K5 on the coupling networks (fused_coupling=True)
# ---------------------------------------------------------------------------

# K5 at the reference Glow (64x64, B=16, K=32, L=4, width 512): (site, B, H,
# W, cin = half the squeezed channels, f, launches of each kind per train
# step: the block's 32 couplings)
K5_SHAPES = [("block0", 16, 32, 32, 6, 512, 32),
             ("block1", 16, 16, 16, 12, 512, 32),
             ("block2", 16, 8, 8, 24, 512, 32),
             ("block3", 16, 4, 4, 48, 512, 32)]
K5_PER_STEP = sum(s[-1] for s in K5_SHAPES)          # 128
K5_NAMES = ("glow_coupling_fwd", "glow_coupling_bwd1", "glow_coupling_bwd2")
K6_NAMES = ("glow_flow_stack_fwd", "glow_flow_stack_fwd_nosave",
            "glow_flow_stack_bwd")
GLOW_NAMES = K5_NAMES + K6_NAMES
# checked, not timed: one f32 shape and three ragged ones (odd sizes, channel
# counts no tile divides; the last large enough for the 128-row tiles)
K5_EXTRA = [("f32", 16, 16, 16, 12, 512, "float32"),
            ("ragged", 3, 7, 5, 5, 40, "bfloat16"),
            ("ragged", 2, 9, 13, 11, 72, "bfloat16"),
            ("ragged", 1, 129, 127, 6, 72, "bfloat16")]
# K5 against its plain version on the same operands: f32 within 1e-4 of
# max |.| (sums in other orders); bf16 within 2e-2 of max |.| + 2e-3, since
# a bf16 rounding of h1 or h2 flips on an f32-ulp difference. Elements where
# one side is exactly zero and the other is not are a ReLU mask flipped by
# an f32-ulp difference of a pre-activation within rounding of 0: they are
# counted, must be at most 1e-5 of the elements, and left out of the error
K5_F32_REL, K5_BF16_REL, K5_BF16_ATOL, K5_FLIP_SHARE = 1e-4, 2e-2, 2e-3, 1e-5
# Glow training run: 400 synthetic faces -> 360 train (22 batches of 16 per
# pass of the endless stream) / 40 val; 2 x 10 iterations with a grid and a
# checkpoint every 10, a resume, 10 more
GLOW_DATASET, GLOW_ITERS, GLOW_EVERY = 400, 20, 10
GLOW_GROUPS = [("K6 (flow_stack_fwd, flow_stack_bwd)", ("flow_stack",)),
               ("K5 (glow_mma_kernel, glow_wgmma_kernel, shift and "
                "finishing sums)", ("glow_",)),
               ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
               ("triangular solves and small matmuls (cuBLAS)",
                ("trsm", "gemm", "gemv", "cutlass", "xmma")),
               ("reductions", ("reduce",)),
               ("dtype casts and copies", ("copy",)),
               ("convolutions (cuDNN: priors)", ("conv", "nchw", "nhwc",
                                                 "dgrad", "wgrad"))]


def glow_config():
    """The reference Glow: 64x64, batch 16, K=32, L=4, width 512, 5 bits,
    lr 1e-4, temperature 0.7, bf16 couplings, ``fused_coupling=True`` (K5),
    on GLOW_DATASET synthetic faces."""
    from vgd_tpu_torch.core.config import DataConfig, GlowConfig, RunConfig
    return GlowConfig(
        data=DataConfig(batch_size=16, image_size=(64, 64),
                        dataset_size=GLOW_DATASET, normalize=False),
        run=RunConfig(out_dir=str(OUT_DIR / "glow"), seed=42,
                      compute_dtype="bfloat16",
                      sample_every_iters=GLOW_EVERY,
                      checkpoint_every_iters=GLOW_EVERY),
        fused_coupling=True)


def k5_operands(dev, gen, b, h, w, cin, f, dtype):
    """HWIO weights with a non-zero (trained-like) ZeroConv, packed."""
    import torch
    from vgd_tpu_torch.ops.glow_coupling import prep

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=gen)
    raw = dict(ya=rnd(b, h, w, cin), w1=rnd(3, 3, cin, f, s=0.05),
               w2=rnd(1, 1, f, f, s=0.05), wz=rnd(3, 3, f, cin, s=0.01),
               b1=rnd(f, s=0.05), b2=rnd(f, s=0.05), bz=rnd(cin, s=0.02),
               scale=rnd(cin, s=0.1), g=rnd(b, h, w, cin))
    return raw, prep(raw["ya"], raw["w1"], raw["w2"], raw["wz"], dtype)


def k5_error(got, ref, rel, atol):
    """(max error outside mask flips, that over max |ref|, error / bound,
    flipped elements, elements)."""
    import torch
    got, ref = got.float(), ref.float()
    flip = (got == 0) != (ref == 0)
    err = float(torch.where(flip, 0.0, (got - ref).abs()).max())
    top = float(ref.abs().max())
    return (err, err / max(top, 1e-30), err / (rel * top + atol),
            int(flip.sum()), ref.numel())


def k5_work(b, h, w, cin, f):
    """(operations, bytes) of one call of fwd, bwd1 and bwd2 at bf16: each
    conv and product the function computes (bwd1 recomputes h1 and h2), and
    each input read and output written once."""
    p, q, taps = b * h * w, b * (h + 2) * (w + 2), 9
    conv1, conv2, convz = (2.0 * p * taps * cin * f, 2.0 * p * f * f,
                           2.0 * p * taps * f * cin)
    wbytes = 2.0 * (2 * taps * cin * f + f * f) + 4.0 * (2 * f + 2 * cin)
    fwd = (conv1 + conv2 + convz, 2.0 * p * cin + wbytes + 4.0 * p * cin)
    bwd1 = (conv1 + conv2 + convz + 2.0 * q * f * taps * cin
            + 2.0 * p * taps * cin * f,
            2.0 * p * cin + wbytes + 2.0 * taps * cin * f + 4.0 * p * cin
            + 2 * 2.0 * p * f + 4.0 * (f * taps * cin + 2 * cin + f))
    bwd2 = (2 * 2.0 * p * f * f + 2 * 2.0 * p * taps * cin * f,
            2.0 * p * cin + 2.0 * (taps * f * cin + f * f) + 2 * 2.0 * p * f
            + 4.0 * (p * cin + taps * cin * f + f + f * f))
    return {"glow_coupling_fwd": fwd, "glow_coupling_bwd1": bwd1,
            "glow_coupling_bwd2": bwd2}


# K5's stages, each named by its kernels: a kernel whose name holds one of a
# stage's keys belongs to it (the GEMM kernels carry their Op's name); a
# split sum belongs to the GEMM launched just before it
K5_STAGES = [("conv1", ("Conv1Op",)), ("conv2", ("Conv2Op",)),
             ("zeroconv shift + grad", ("zeroconv_shift_grad",)),
             ("zeroconv", ("ZeroConv", "zeroconv_shift")),
             ("zeroconv grad", ("zeroconv_grad",)),
             ("dWz", ("DwzOp",)), ("dh2", ("Dh2Op",)),
             ("column sums", ("sum_columns",)),
             ("dW2", ("Dw2Op",)), ("dh1", ("Dh1Op",)), ("dW1", ("Dw1Op",)),
             ("dya", ("Dya",)),
             ("finish (split, column and dya shift sums)", ("glow_finish",))]
K5_AFTER_GEMM = ("sum_splits",)


def k5_stage(name):
    """The K5 stage of a kernel name, or None; a GEMM kernel that runs two
    products side by side is both stages ("dW2 + dh1")."""
    hits = [s for s, keys in K5_STAGES if any(k in name for k in keys)]
    if "gemm_kernel" in name or "mma_kernel" in name:
        return " + ".join(hits) if hits else None
    return hits[0] if hits else None


def profile_stages(fn, stage_of, after=(), calls=5):
    """(device ms per call of each stage of ``fn``, kernels per call):
    torch.profiler's kernel times of one call, in launch order, over
    ``calls`` calls; ``stage_of(name)`` names a kernel's stage (None: a
    kernel in ``after`` joins the stage before it, any other is "other").
    Each call is profiled alone after a marker kernel (a fill of int8, which
    no kernel under test makes; the trace can lose the first kernels of a
    session), and only the kernels after the marker count; a call whose
    trace still lost kernels (fewer than the most any call showed) is left
    out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    traces = []
    for _ in range(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.full((1,), 1, dtype=torch.int8, device="cuda")
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if "CUDA" in str(e.device_type)),
                         key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels)
                 if "Fill" in e.name and "signed char" in e.name]
        traces.append(kernels[marks[-1] + 1:] if marks else kernels)
    most = max(len(t) for t in traces)
    kept = [t for t in traces if len(t) == most]
    stages = {}
    for kernels in kept:
        last = "other"
        for e in kernels:
            stage = stage_of(e.name)
            if stage is not None:
                last = stage
            elif any(k in e.name for k in after):
                stage = last
            else:
                stage = "other"
            stages[stage] = (stages.get(stage, 0.0)
                             + e.time_range.elapsed_us() / 1e3 / len(kept))
    return stages, most


def k5_stages(fn, calls=5):
    """K5's stages of ``fn`` (``profile_stages``), each kernel named by its
    Op (``K5_STAGES``)."""
    return profile_stages(fn, k5_stage, K5_AFTER_GEMM, calls)


def k1_stage(name):
    """K1's stage of a kernel name: its products (with their epilogue), the
    split sum, the statistics combine, or the wrapper's layout copies (w's
    layout, enc0's x padded to 4 channels), named by their kernel."""
    for key, stage in (("conv_stats_mma", "products"),
                       ("conv_stats_finish", "split sum"),
                       ("combine_stats", "combine")):
        if key in name:
            return stage
    return "copy " + name.split("<")[0].split("(")[0][-40:]


def check_k5(K, gen, dev, failures, shapes=None):
    """K5 forward, backward 1 and backward 2 against their plain versions at
    the four Glow shapes (bf16) and K5_EXTRA (backward 2 fed the plain h1 and
    dh2); the Glow shapes timed as kernel, plain version and the library
    yardstick: the cuDNN bf16 channels_last chain (conv2d, ReLU, conv2d,
    ReLU, value-1 pad, conv2d, x exp) for the forward, autograd of that chain
    for forward + backward. ``shapes``: other (site, b, h, w, cin, f,
    calls, dtype) instead (calls 0: checked, not timed)."""
    import torch
    import torch.nn.functional as F
    rows = {n: [] for n in K5_NAMES}
    khw, pad = (3, 3), (1, 1)
    if shapes is None:
        shapes = [s_ + ("bfloat16",) for s_ in K5_SHAPES] + [
            (n, b, h, w, c, f, 0, d) for n, b, h, w, c, f, d in K5_EXTRA]
    for site, b, h, w, cin, f, calls, *dt in shapes:
        dtype = getattr(torch, dt[0])
        raw, p = k5_operands(dev, gen, b, h, w, cin, f, dtype)
        rel, atol = ((K5_F32_REL, 0.0) if dtype == torch.float32
                     else (K5_BF16_REL, K5_BF16_ATOL))
        fa = (p["ya"], p["w1f"], raw["b1"], p["w2"], raw["b2"], p["wz"])
        b1a = fa + (p["wzf"], raw["bz"], raw["scale"], raw["g"], khw, pad)
        out = K.glow_coupling_fwd(*fa, raw["bz"], raw["scale"], khw, pad,
                                  wzf=p["wzf"])
        got1 = K.glow_coupling_bwd1(*b1a)
        torch.cuda.synchronize()
        ref = K.glow_coupling_fwd_plain(*fa, raw["bz"], raw["scale"], khw,
                                        pad)
        ref1 = K.glow_coupling_bwd1_plain(*b1a)
        b2a = (p["ya"], p["w1t"], p["w2t"], ref1[0], ref1[1], khw, pad)
        got2 = K.glow_coupling_bwd2(*b2a, w1f=p["w1f"])
        torch.cuda.synchronize()
        ref2 = K.glow_coupling_bwd2_plain(*b2a)
        per = {"glow_coupling_fwd": [("out", out, ref)],
               "glow_coupling_bwd1": list(zip(
                   ("h1", "dh2", "dwz", "dbz", "db2", "dscale"), got1, ref1)),
               "glow_coupling_bwd2": list(zip(
                   ("dya", "dw1", "db1", "dw2"), got2, ref2))}
        shape = [b, h, w, cin, f]
        line = []
        for kname, items in per.items():
            worst, worst_rel, errs = 0.0, 0.0, {}
            for what, a, r in items:
                err, rerr, ratio, flips, n = k5_error(a, r, rel, atol)
                errs[what] = err
                worst = max(worst, ratio)
                worst_rel = max(worst_rel, rerr)
                if not (ratio <= 1.0 and flips <= K5_FLIP_SHARE * n
                        and a.shape == r.shape and a.dtype == r.dtype):
                    failures.append(f"K5 {kname} {site} {shape} {dt[0]} "
                                    f"{what}: err {err} ({ratio:.3g} of its "
                                    f"bound), {flips} mask flips of {n}")
                if flips:
                    line.append(f"{what} flips={flips}")
            rows[kname].append({
                "shape": shape, "site": site, "dtype": dt[0],
                "max_abs_err": max(errs.values()), "max_rel_err": worst_rel,
                "err_over_bound": worst, "errors": errs,
                "tol": f"{rel} x max|.| + {atol}; ReLU mask "
                f"flips <= {K5_FLIP_SHARE} of the elements"})
            line.append(f"{kname[14:]} worst err/bound {worst:.3g}")
        if calls:
            work = k5_work(b, h, w, cin, f)
            # OIHW bf16 weights and NCHW input, channels_last in memory
            w1, w2, wz = (raw[k].permute(3, 2, 0, 1).to(torch.bfloat16)
                          .contiguous(memory_format=torch.channels_last)
                          for k in ("w1", "w2", "wz"))
            bb1, bb2, bbz = (raw[k].to(torch.bfloat16)
                             for k in ("b1", "b2", "bz"))
            esc = torch.exp(raw["scale"] * 3.0)[:, None, None]

            def chain(xx, w1_, w2_, wz_):
                hh = torch.relu(F.conv2d(xx, w1_, bb1, padding=1))
                hh = torch.relu(F.conv2d(hh, w2_, bb2))
                hh = F.pad(hh, (1, 1, 1, 1), value=1.0)
                return F.conv2d(hh, wz_, bbz).float() * esc
            xc = raw["ya"].permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (xc, w1, w2, wz)]
            gc = raw["g"].permute(0, 3, 1, 2)

            def library_fwd():
                return chain(xc, w1, w2, wz)

            def library_fwd_bwd():
                chain(*leaves).backward(gc)
            # the chain's backward alone: autograd of one retained forward
            retained = chain(*leaves)

            def library_bwd():
                torch.autograd.grad(retained, leaves, gc, retain_graph=True)
            timed = {
                "glow_coupling_fwd": (
                    lambda: K.glow_coupling_fwd(*fa, raw["bz"], raw["scale"],
                                                khw, pad, wzf=p["wzf"]),
                    lambda: K.glow_coupling_fwd_plain(
                        *fa, raw["bz"], raw["scale"], khw, pad),
                    library_fwd),
                "glow_coupling_bwd1": (
                    lambda: K.glow_coupling_bwd1(*b1a),
                    lambda: K.glow_coupling_bwd1_plain(*b1a), None),
                "glow_coupling_bwd2": (
                    lambda: K.glow_coupling_bwd2(*b2a, w1f=p["w1f"]),
                    lambda: K.glow_coupling_bwd2_plain(*b2a), None)}
            lib_keys = None
            for kname, (kern, plain, lib) in timed.items():
                ops, nbytes = work[kname]
                r = rows[kname][-1]
                if lib_keys is None:
                    time_row(r, kern, plain, lib,
                             library_fwd_bwd_ms=library_fwd_bwd,
                             library_bwd_ms=library_bwd)
                    lib_keys = {k: r[k] for k in (
                        "library_fwd_bwd_ms", "library_fwd_bwd_ms_p90",
                        "library_bwd_ms", "library_bwd_ms_p90")}
                else:
                    time_row(r, kern, plain, lib)
                    r.update(lib_keys)
                r.update(flop_ms=ops / BF16_FLOPS * 1e3,
                         byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=calls)
                r["stages"], r["kernels_per_call"] = k5_stages(kern)
                line.append(
                    f"{kname[14:]}: ms={r['ms']:.4f} p90={r['ms_p90']:.4f} "
                    f"call={r['call_ms']:.4f} plain={r['plain_ms']:.4f}"
                    f" bound={max(r['flop_ms'], r['byte_ms']):.4f} "
                    f"({100 * max(r['flop_ms'], r['byte_ms']) / r['ms']:.1f}"
                    f" % of it)")
                print(f"[kernel] K5 stages {site} {kname[14:]} "
                      f"({r['kernels_per_call']:g} kernels per call, "
                      f"profiler ms): " + ", ".join(
                          f"{s} {ms:.4f}" for s, ms in r["stages"].items()),
                      flush=True)
            line.append(f"library fwd="
                        f"{rows['glow_coupling_fwd'][-1]['library_ms']:.4f} "
                        f"fwd+bwd={lib_keys['library_fwd_bwd_ms']:.4f} "
                        f"bwd={lib_keys['library_bwd_ms']:.4f}")
            del retained, leaves
        print(f"[kernel] K5 {site} {shape} {dt[0]} " + "; ".join(line),
              flush=True)
        del raw, p, out, got1, got2, ref, ref1, ref2
    if not any("ms" in r for v in rows.values() for r in v):
        return rows
    totals = {k: {key: sum(r[key] * r["calls"] for r in v if "ms" in r)
                  for key in ("ms", "ms_p90", "call_ms", "plain_ms",
                              "flop_ms", "byte_ms")}
              for k, v in rows.items()}
    print("[kernel] K5 per train step (128 launches of each): " + "; ".join(
        f"{k[14:]} kernel {t['ms']:.3f} ms (p90 {t['ms_p90']:.3f}, call "
        f"time {t['call_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
        f"bound {max(t['flop_ms'], t['byte_ms']):.3f} ms" for k, t in
        totals.items()) + f" (bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
    for k, v in rows.items():
        staged = [r for r in v if "stages" in r]
        stages = {}
        for r in staged:
            for s, ms in r["stages"].items():
                stages[s] = stages.get(s, 0.0) + ms * r["calls"]
        print(f"[kernel] K5 stages per train step {k[14:]} (profiler ms; "
              f"kernels per call " + "/".join(
                  f"{r['kernels_per_call']:g}" for r in staged) + "): " +
              ", ".join(f"{s} {ms:.3f}" for s, ms in stages.items()),
              flush=True)
    return rows


def glow_step_grads(trainer, batch, noise):
    """Loss and every parameter's gradient of one train step (as
    ``train_step`` computes them, without the Adam update)."""
    import torch
    from vgd_tpu_torch.models.glow import calc_loss
    trainer.model.zero_grad(set_to_none=True)
    x = trainer._prep(batch, None, noise)
    log_p, logdet, _ = trainer.model(x)
    loss = calc_loss(log_p, logdet.mean(), trainer.img_shape[0],
                     trainer.n_bins, n_channels=trainer.img_shape[2])[0]
    loss.backward()
    grads = {n: p.grad.clone() for n, p in trainer.model.named_parameters()}
    trainer.model.zero_grad(set_to_none=True)
    del x, log_p, logdet
    torch.cuda.synchronize()
    return loss.item(), grads


def compare_glow_step(got, ref):
    """(worst gradient error over its bound, its name, loss difference
    relative) of two ``glow_step_grads`` results, at the DDPM step's
    bounds (STEP_GRAD_REL x the tensor's max |g| + STEP_GRAD_FLOOR x the
    model's largest |g|)."""
    (lk, gk), (lr, gr) = got, ref
    top = max(float(g.abs().max()) for g in gr.values())
    worst = (0.0, "")
    for name, r in gr.items():
        err = float((gk[name] - r).abs().max())
        bound = STEP_GRAD_REL * float(r.abs().max()) + STEP_GRAD_FLOOR * top
        worst = max(worst, (err / bound, name))
    return worst[0], worst[1], abs(lk - lr) / abs(lr)


def check_glow_step(K, cfg, gen, failures, tag, init_want, step_want,
                    compare=()):
    """One full-width train step with the kernels against the same state,
    batch and noise with no kernel (``kernels.plain_reference``): the loss
    and every gradient, held by ``hold_to_floor`` at STEP_LOSS_REL (the
    bf16 floor from the plain coupling outputs perturbed).
    The state: the seeded init, the ActNorm init on the batch, and
    ZeroConvs set to 0.01 N(0, 1) (at init they are zero and the conv1 /
    conv2 gradients with them). The K5 / K6 launches of the ActNorm init
    and of the step are held to ``init_want`` and ``step_want``. Then one
    bf16 train step timed both ways and profiled, and timed with the same
    weights under each (name, config changes) of ``compare``; ``tag``
    names the phase in the log."""
    import dataclasses
    import torch
    from vgd_tpu_torch.train.glow import GlowTrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size
    stats = {}
    for dtype in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, compute_dtype=dtype))
        trainer = GlowTrainer(dcfg, (h, w, 3), device="cuda")
        dev = trainer.device
        trainer.init(torch.Generator(device=dev).manual_seed(cfg.run.seed))
        batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                              device=dev, generator=gen)
        noise = torch.rand(b, h, w, 3, device=dev, generator=gen)
        K.LAUNCHES.clear()
        trainer.init_step(batch, noise=noise)
        init_launches = {k: K.LAUNCHES[k] for k in GLOW_NAMES}
        with torch.no_grad():
            for blk in trainer.model.blocks():
                zw = blk.flows.coupling.zero.w
                zw.copy_(0.01 * torch.randn(zw.shape, device=dev,
                                            generator=gen))
        if dtype == "float32":
            n_params = sum(p.numel() for p in trainer.model.parameters())
            stats["n_params"] = n_params
            print(f"[{tag}] init: {h}x{w} B={b} K={cfg.n_flows} L="
                  f"{cfg.n_blocks} width {cfg.filter_size}: {n_params} "
                  f"parameters; init_step launches {init_launches}",
                  flush=True)
        if init_launches != init_want:
            failures.append(f"{tag} init_step {dtype}: launches "
                            f"{init_launches}")
        K.LAUNCHES.clear()
        kern = glow_step_grads(trainer, batch, noise)
        launches = {k: K.LAUNCHES[k] for k in GLOW_NAMES}
        if launches != step_want or set(K.LAUNCHES) - set(GLOW_NAMES):
            failures.append(f"{tag} {dtype}: launches {dict(K.LAUNCHES)}, "
                            f"want {step_want}")
        runs = no_kernel_runs(
            K, "glow_coupling_fwd_plain", dtype,
            lambda: glow_step_grads(trainer, batch, noise), tag, failures)
        row, text = hold_to_floor(tag, dtype, kern, runs, compare_glow_step,
                                  STEP_LOSS_REL, failures)
        row.update(launches=launches, loss=kern[0],
                   loss_ref=runs["plain"][0])
        line = (f"[{tag}] {dtype} kernels vs no-kernel reference, B={b} "
                f"{h}x{w}: loss {kern[0]:.6f} / {runs['plain'][0]:.6f}; "
                f"{len(kern[1])} gradients, {text} (relative); launches "
                f"{launches}")
        print(line, flush=True)
        stats[f"step_{dtype}"] = row
        del kern, runs
        if dtype == "float32":
            del trainer
            torch.cuda.empty_cache()

    def step():
        trainer.train_step(batch, noise=noise)

    def plain_step():
        with K.plain_reference():
            step()
    stats.update(train_step_ms=cuda_ms(step, 1, 3),
                 train_step_plain_ms=cuda_ms(plain_step, 1, 3))
    stats["train_step_profile"] = profile_fn(step, GLOW_GROUPS,
                                             f"profile-{tag}")
    print(f"[{tag}] whole bf16 train step B={b} {h}x{w}: kernels "
          f"{stats['train_step_ms']:.3f} ms, no-kernel reference "
          f"{stats['train_step_plain_ms']:.3f} ms", flush=True)
    for name, changes in compare:
        other = GlowTrainer(dataclasses.replace(trainer.cfg, **changes),
                            (h, w, 3), device="cuda")
        other.load(trainer.model.state_dict())
        stats[f"train_step_{name}_ms"] = cuda_ms(
            lambda: other.train_step(batch, noise=noise), 1, 3)
        print(f"[{tag}] the same bf16 step with {changes}: "
              f"{stats[f'train_step_{name}_ms']:.3f} ms", flush=True)
        del other
    return stats


def glow_train_path(K, cfg, failures, tag, per_step, per_init, per_reverse):
    """``run_glow`` for GLOW_ITERS iterations (a grid and a checkpoint every
    GLOW_EVERY), a resume that runs no iteration (it must restore exactly
    what was saved), and a resume that trains GLOW_EVERY more from the
    right place in the stream. The K5 and K6 launches (GLOW_NAMES) are read
    per train step, per ``init_step`` and per ``reverse`` and held to
    ``per_step``, ``per_init`` and ``per_reverse``; ``tag`` names the
    phase in the log."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import make_image_datasets
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.glow import GlowTrainer
    calls = {"train_step": [], "init_step": [], "reverse": []}
    originals = {n: getattr(GlowTrainer, n) for n in calls}
    fed = []

    def wrap(name):
        fn = originals[name]

        def counted(self, *args, **kwargs):
            before = {k: K.LAUNCHES[k] for k in GLOW_NAMES}
            if name == "train_step":
                fed.append(args[0].clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kwargs)
            end.record()
            calls[name].append((tuple(K.LAUNCHES[k] - before[k]
                                      for k in GLOW_NAMES), start, end, out))
            return out
        return counted

    for n in calls:
        setattr(GlowTrainer, n, wrap(n))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = L.run_glow(cfg, n_iter=GLOW_ITERS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trainer = res["trainer"]
        launches = {k: K.LAUNCHES[k] for k in GLOW_NAMES}
        losses = [float(c[3]["loss"]) for c in calls["train_step"]]
        step_ms = sorted(s.elapsed_time(e) for _, s, e, _ in
                         calls["train_step"][1:])
        steps = len(losses)
        stats = {"train_steps": steps, "train_run_s": train_s,
                 "launches": dict(K.LAUNCHES),
                 "per_train_step": sorted({c[0] for c in calls["train_step"]}),
                 "per_init_step": [c[0] for c in calls["init_step"]],
                 "per_reverse": sorted({c[0] for c in calls["reverse"]}),
                 "reverses": len(calls["reverse"]),
                 "losses": losses, "log": res["log"],
                 "step_ms_median": step_ms[len(step_ms) // 2],
                 "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
                 "images_per_sec_median_step":
                     cfg.data.batch_size / step_ms[len(step_ms) // 2] * 1e3,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[{tag}] launches {dict(K.LAUNCHES)} over {steps} train "
              f"steps (per step {stats['per_train_step']}), init_step "
              f"{stats['per_init_step']}, {stats['reverses']} reverses (each "
              f"{stats['per_reverse']})", flush=True)
        if (steps != GLOW_ITERS or stats["per_train_step"] != [per_step]
                or stats["per_init_step"] != [per_init]
                or stats["per_reverse"] != [per_reverse]
                or stats["reverses"] != GLOW_ITERS // GLOW_EVERY
                or set(K.LAUNCHES) - set(GLOW_NAMES)):
            failures.append(f"{tag} launches: {stats}")
        if not (all(math.isfinite(v) for v in losses)
                and np.mean(losses[-5:]) < np.mean(losses[:5])):
            failures.append(f"{tag}: bits/dim not finite and falling: "
                            f"{losses}")
        grids = sorted((Path(cfg.run.out_dir) / "sample").glob("*.npy"))
        grid = np.load(grids[-1])
        if not (len(grids) == GLOW_ITERS // GLOW_EVERY and
                grid.shape == (cfg.n_samples, 64, 64, 3) and
                np.isfinite(grid).all()):
            failures.append(f"{tag} grids {[g.name for g in grids]} "
                            f"{grid.shape}")
        print(f"[{tag}] bits/dim by step: " + " ".join(
            f"{v:.4f}" for v in losses) + f"; log {res['log']}", flush=True)
        print(f"[{tag}] {steps} steps; step ms median "
              f"{stats['step_ms_median']:.3f} (min {step_ms[0]:.3f}, max "
              f"{step_ms[-1]:.3f}) after the first = "
              f"{stats['images_per_sec_median_step']:.1f} images/s; run "
              f"{train_s:.1f} s with the ActNorm init, 2 grids and 2 "
              f"checkpoints; peak memory {stats['peak_mem_gb']:.3f} GB",
              flush=True)

        # a resume with no iteration left restores, and must equal the save
        final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        opt_a = trainer.opt.state_dict()["state"]
        payload = Checkpointer(f"{cfg.run.out_dir}/ckpt").load()
        K.LAUNCHES.clear()
        back = L.run_glow(cfg, n_iter=GLOW_ITERS, resume=True,
                          device="cuda")["trainer"]
        same_params = all(torch.equal(final[k], v) and
                          torch.equal(payload["params"][k], v.cpu())
                          for k, v in back.model.state_dict().items())
        opt_b = back.opt.state_dict()["state"]
        same_opt = opt_a.keys() == opt_b.keys() and all(
            torch.equal(opt_a[i][x].cpu(), opt_b[i][x].cpu())
            for i in opt_a for x in ("step", "exp_avg", "exp_avg_sq"))
        ok = (same_params and same_opt and payload["step"] == GLOW_ITERS
              and back.step == steps == payload["opt_step"]
              and sum(K.LAUNCHES.values()) == 0)
        print(f"[{tag}] resume: checkpoint iteration {payload['step']}, "
              f"optimizer steps {back.step}: params and buffers equal "
              f"{same_params}, Adam state equal {same_opt}", flush=True)
        if not ok:
            failures.append(f"{tag}: resume did not restore what was saved")
        del back, trainer, res, final, opt_a, opt_b
        torch.cuda.empty_cache()

        for v in calls.values():
            v.clear()
        fed.clear()
        K.LAUNCHES.clear()
        res = L.run_glow(cfg, n_iter=GLOW_ITERS + GLOW_EVERY, resume=True,
                         device="cuda")
        steps3 = len(calls["train_step"])
        got = {k: K.LAUNCHES[k] for k in GLOW_NAMES}
        reverses3 = steps3 // GLOW_EVERY
        train, _, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
        want_batch = torch.from_numpy(next(train.stream(GLOW_ITERS + 1)))
        same_stream = torch.equal(fed[0].cpu(), want_batch)
        losses3 = [float(c[3]["loss"]) for c in calls["train_step"]]
        print(f"[{tag}] resumed: {steps3} steps from iteration "
              f"{GLOW_ITERS}, first batch is stream batch {GLOW_ITERS + 1}: "
              f"{same_stream}; bits/dim " + " ".join(
                  f"{v:.4f}" for v in losses3) + f"; launches {got}",
              flush=True)
        if not (res["trainer"].step == GLOW_ITERS + GLOW_EVERY
                == steps + steps3 and same_stream and not calls["init_step"]
                and got == {k: per_step[i] * steps3 + per_reverse[i] * reverses3
                            for i, k in enumerate(GLOW_NAMES)}
                and all(math.isfinite(v) for v in losses3)):
            failures.append(f"{tag} resumed run: step {res['trainer'].step}, "
                            f"stream {same_stream}, launches {got}")
        stats["resumed_losses"] = losses3
        stats["launches_total"] = {k: launches[k] + got[k] for k in GLOW_NAMES}
    finally:
        for n, fn in originals.items():
            setattr(GlowTrainer, n, fn)
    return stats


def glow_serve_path(K, cfg, failures):
    """``sample_from_dir("glow", n=cfg.n_samples)`` and
    ``evaluate_glow_from_dir(max_batches=1)`` on the trained checkpoint:
    finite samples, one reverse (128 K5 forwards) per request batch."""
    import numpy as np
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    latest = Checkpointer(f"{cfg.run.out_dir}/ckpt").latest_step()
    if latest != GLOW_ITERS + GLOW_EVERY:
        failures.append(f"glow-serve: latest checkpoint {latest}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    want = {"glow_coupling_fwd": K5_PER_STEP, "glow_coupling_bwd1": 0,
            "glow_coupling_bwd2": 0}
    K.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = L.sample_from_dir("glow", cfg, n=cfg.n_samples, device="cuda")
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = check_launches(K, want, "glow-serve", failures)
    arr = np.load(path)
    print(f"[glow-serve] samples {arr.shape} finite "
          f"{bool(np.isfinite(arr).all())} range [{float(arr.min()):.4f}, "
          f"{float(arr.max()):.4f}]", flush=True)
    if not (arr.shape == (cfg.n_samples, 64, 64, 3)
            and np.isfinite(arr).all()):
        failures.append(f"glow-serve: bad samples {arr.shape}")
    K.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = L.evaluate_glow_from_dir(cfg, max_batches=1, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    check_launches(K, want, "glow-eval", failures)
    if not math.isfinite(res["ssim"]):
        failures.append(f"glow-eval: {res}")
    stats = {"served_checkpoint": latest, "sample_s": sample_s,
             "eval_s": eval_s, "ssim": res["ssim"], "launches": launches,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[glow-serve] sample request ({cfg.n_samples} images, checkpoint "
          f"restore included) {sample_s:.3f} s; evaluation (one val batch "
          f"of {cfg.data.batch_size}, restore included) {eval_s:.3f} s, ssim "
          f"{res['ssim']:.4f}; peak memory {stats['peak_mem_gb']:.3f} GB",
          flush=True)
    return stats


def glow_path(K, gen, failures):
    cfg = glow_config()
    shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    none = (0,) * len(K6_NAMES)
    stats = check_glow_step(
        K, cfg, gen, failures, "glow-step",
        dict(zip(GLOW_NAMES, (K5_PER_STEP, 0, 0) + none)),
        dict(zip(GLOW_NAMES, (K5_PER_STEP,) * 3 + none)))
    stats["train"] = glow_train_path(
        K, cfg, failures, "glow-train", (K5_PER_STEP,) * 3 + none,
        (K5_PER_STEP, 0, 0) + none, (K5_PER_STEP, 0, 0) + none)
    stats["serve"] = glow_serve_path(K, cfg, failures)
    return stats



# ---------------------------------------------------------------------------
# Glow with flow_stack: K6 runs each block's whole flow chain, one launch per
# block and direction
# ---------------------------------------------------------------------------

# K6 at the reference Glow (64x64, B=16, K=32, L=4, width 512): (site, B, H,
# W, c = the squeezed channels, f, flows); one launch of each direction per
# block and train step
K6_SHAPES = [("block0", 16, 32, 32, 12, 512, 32),
             ("block1", 16, 16, 16, 24, 512, 32),
             ("block2", 16, 8, 8, 48, 512, 32),
             ("block3", 16, 4, 4, 96, 512, 32)]
K6_PER_STEP = len(K6_SHAPES)
# checked, not timed: (site, B, H, W, c, f, flows, kernel, dtype): one f32
# shape, two ragged ones (odd sizes, channel counts no tile divides) and the
# EEG variant's (3, 1) kernel
K6_EXTRA = [("f32", 16, 16, 16, 24, 512, 8, (3, 3), "float32"),
            ("ragged", 3, 7, 5, 10, 40, 3, (3, 3), "bfloat16"),
            ("ragged", 2, 9, 13, 22, 72, 2, (3, 3), "bfloat16"),
            ("eeg", 2, 40, 1, 44, 64, 2, (3, 1), "bfloat16")]
# K6 against its plain version on the same operands (the backward fed the
# plain version's saved inputs). f32, the JAX flow-stack test's bounds:
# values within 1e-4 of max |.|, gradients within 5e-4 (1e-3 + max |g|).
# bf16: 5e-2 of max |.| + 2e-3, K5's per-flow bound widened for a chain of
# 32 flows: a cd rounding of y1, h1, h2 or dy2 that goes the other way in
# one flow moves that flow's output by a bf16 ulp (3.9e-3 relative) and
# every later flow carries it on (measured on the H100: y at 1.6e-2, the
# block-3 dW2 and db2 at 3.0e-2 and 2.5e-2 of max); ReLU mask flips are
# counted and left out as K5's
K6_F32_REL, K6_GRAD_REL, K6_GRAD_FLOOR = 1e-4, 5e-4, 1e-3
# the per-flow path of the same block, timed beside K6 (``check_k6``)
K6_PER_FLOW_KEYS = ("op_fwd_bwd_ms", "per_flow_k5_fwd_ms",
                    "per_flow_k5_fwd_bwd_ms", "per_flow_cudnn_fwd_ms",
                    "per_flow_cudnn_fwd_bwd_ms")
K6_BF16_REL, K6_BF16_ATOL, K6_FLIP_SHARE = 5e-2, K5_BF16_ATOL, K5_FLIP_SHARE
# the bf16 kernels' grid syncs per flow at most (forward, backward)
K6_MAX_SYNCS = (4, 8)
# grid syncs of the probe's long run (its short run has none)
K6_PROBE_SYNCS = 1000


def k6_sync_probe(K, dev):
    """The device time of one grid sync on K6's bf16 grid: the probe (the
    same cooperative grid, nothing but syncs) with K6_PROBE_SYNCS syncs
    against none, per sync."""
    t = device_ms({"none": lambda: K.glow_flow_stack_sync_probe(0, dev),
                   "many": lambda: K.glow_flow_stack_sync_probe(
                       K6_PROBE_SYNCS, dev)})
    us = (t["many"]["median"] - t["none"]["median"]) / K6_PROBE_SYNCS * 1e3
    out = {"us_per_sync": us, "syncs": K6_PROBE_SYNCS,
           "launch_ms": t["none"]["median"], "ms": t["many"]["median"],
           "timing": t["many"]["how"]}
    print(f"[kernel] K6 grid-sync probe: {K6_PROBE_SYNCS} syncs "
          f"{out['ms']:.4f} ms, none {out['launch_ms']:.4f} ms: "
          f"{us:.3f} us per grid sync ({out['timing']})", flush=True)
    return out


K6_FWD_STAGES = ("per pixel (ZeroConv finish, ActNorm, 1x1 conv)", "conv1",
                 "conv2", "ZeroConv N-pack")
K6_BWD_STAGES = ("S1 per pixel (tail, ZeroConv grad) | ya", "S2 dWz, dh2 | conv1",
                 "S3 dW2, dh1 | conv2", "S4 dW1, dya N-pack | ZeroConv N-pack")


def k6_stages(K, fa, ba, xsave, khw, pad, n, plan, dev):
    """K6's bf16 stage times from the kernels' own clock (one warm call of
    each direction with ``stamps``): block 0 stamps the device clock after
    each grid sync, so a stage's time includes its sync. Returns us per
    flow by stage kind, and the once-per-call stages."""
    import torch
    fs, bs = plan.syncs(n)
    st = {"fwd": torch.zeros(fs + 1, dtype=torch.int64, device=dev),
          "bwd": torch.zeros(bs + 1, dtype=torch.int64, device=dev)}
    K.glow_flow_stack_fwd(*fa, khw, pad, False, stamps=st["fwd"])
    K.glow_flow_stack_bwd(xsave, *ba, khw, pad, stamps=st["bwd"])
    torch.cuda.synchronize()
    d = {k: (v[1:] - v[:-1]).double().cpu() / 1e3 for k, v in st.items()}
    fwd = {name: float(d["fwd"][i:4 * n:4].sum()) / n
           for i, name in enumerate(K6_FWD_STAGES)}
    bwd = {name: float(d["bwd"][4 + i:4 + 4 * n:4].sum()) / n
           for i, name in enumerate(K6_BWD_STAGES)}
    return {"fwd_us_per_flow": fwd, "bwd_us_per_flow": bwd,
            "fwd_last_us": float(d["fwd"][4 * n]),
            "bwd_prologue_us": float(d["bwd"][:4].sum()),
            "bwd_closing_us": float(d["bwd"][4 + 4 * n:].sum()),
            "fwd_total_us": float(d["fwd"].sum()),
            "bwd_total_us": float(d["bwd"].sum())}


def k6_plan_text(plan):
    """One line of a K6 plan: each product's tile (and splits), the unit."""
    return ", ".join(
        f"{p.name} {p.tile}" + (f" x{p.splits}" if p.splits > 1 else "")
        for p in plan.products) + f"; {plan.tail_pixels} px a unit"


def k6_operands(dev, gen, b, h, w, c, f, n, khw, dtype):
    """A block's stacked flow leaves (trained-like: ActNorm off the
    identity, an orthogonal 1x1 conv, a non-zero ZeroConv), x and g; and
    K6's packed operands of them."""
    import torch
    from vgd_tpu_torch.ops.glow_flow_stack import _pack

    def rnd(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=gen)
    kh, kw = khw
    ch = c // 2
    q, _ = torch.linalg.qr(rnd(n, c, c))
    raw = dict(x=rnd(b, h, w, c), g=rnd(b, h, w, c), an_b=rnd(n, c, s=0.1),
               an_s=torch.exp(rnd(n, c, s=0.1)), wt=q.transpose(1, 2),
               w1=rnd(n, kh, kw, ch, f, s=0.05), b1=rnd(n, f, s=0.05),
               w2=rnd(n, 1, 1, f, f, s=0.05), b2=rnd(n, f, s=0.05),
               wz=rnd(n, kh, kw, f, ch, s=0.01), bz=rnd(n, ch, s=0.02),
               scale=rnd(n, ch, s=0.1))
    p = _pack(raw["w1"], raw["w2"], raw["wz"], dtype, backward=True)
    v = {k: raw[k].contiguous() for k in ("an_b", "an_s", "wt", "b1", "b2",
                                          "bz", "scale")}
    fwd = (raw["x"], v["an_b"], v["an_s"], v["wt"], p["w1f"], v["b1"],
           p["w2"], v["b2"], p["wz"], v["bz"], v["scale"])
    bwd = (v["an_b"], v["an_s"], v["wt"], p["w1f"], p["w1t"], v["b1"],
           p["w2"], p["w2t"], v["b2"], p["wz"], p["wzf"], v["bz"],
           v["scale"], raw["g"])
    return raw, fwd, bwd


def k6_work(b, h, w, c, f, n, khw, cdb):
    """(operations, bytes) of one K6 call of each kind over n flows: every
    product the function computes (the backward recomputes each flow's
    forward to h2 and the ZeroConv), each input read and each output
    written once."""
    kh, kw = khw
    taps, ch = kh * kw, c // 2
    p, q = b * h * w, b * (h + 2 * (kh // 2)) * (w + 2 * (kw // 2))
    conv = 2.0 * p * (taps * ch * f + f * f + taps * f * ch)
    fwd_ops = n * (2.0 * p * c * c + conv)
    bwd_ops = n * (2.0 * p * c * ch + conv + 2.0 * q * f * taps * ch
                   + 3 * 2.0 * p * taps * ch * f + 2 * 2.0 * p * f * f
                   + 2 * 2.0 * p * c * c)
    vec = 4.0 * (2 * c + c * c + 2 * f + 2 * ch)
    wts = cdb * (2 * taps * ch * f + f * f)
    act = 4.0 * p * c
    fwd = (fwd_ops, n * (wts + vec) + 2 * act)
    save = (fwd_ops, n * (wts + vec) + 2 * act + n * act)
    grads = 4.0 * (2 * c + c * c + 2 * taps * ch * f + 2 * f + f * f + 2 * ch)
    bwd = (bwd_ops, n * (2 * wts + vec + grads) + 3 * act + n * act)
    return {"glow_flow_stack_fwd": save, "glow_flow_stack_fwd_nosave": fwd,
            "glow_flow_stack_bwd": bwd}


def per_flow_block(raw, khw, fused, cd):
    """The per-flow path of the same block (``Glow._flow_fwd`` flow after
    flow: the f32 1x1 conv, and K5 with ``fused``, else the cuDNN conv
    chain) as (forward, forward + backward) callables."""
    import torch
    from vgd_tpu_torch.models.glow import Glow
    variant = "image" if khw == (3, 3) else "eeg"
    m = Glow(in_channels=4, n_flows=1, n_blocks=1, variant=variant,
             filter_size=8, compute_dtype=cd, fused_coupling=fused)
    leaves = {k: raw[k].detach().clone().requires_grad_() for k in (
        "x", "an_b", "an_s", "wt", "w1", "b1", "w2", "b2", "wz", "bz",
        "scale")}
    zero = torch.zeros((), device=raw["x"].device)

    def run(t):
        y = t["x"]
        for k in range(t["an_b"].shape[0]):
            p = {"actnorm": {"b": t["an_b"][k], "s": t["an_s"][k]},
                 "coupling": {
                     "conv1": {"w": t["w1"][k], "b": t["b1"][k]},
                     "conv2": {"w": t["w2"][k], "b": t["b2"][k]},
                     "zero": {"w": t["wz"][k], "b": t["bz"][k],
                              "scale": t["scale"][k]}}}
            y, _, _ = m._flow_fwd(p, y, 0, False, t["wt"][k].t(), zero)
        return y

    def forward():
        with torch.no_grad():
            return run(raw)

    def forward_backward():
        run(leaves).backward(raw["g"])
    return forward, forward_backward


def check_k6(K, gen, dev, failures):
    """K6 (forward with and without saves, backward) against its plain
    versions at the four Glow block shapes (bf16) and K6_EXTRA: y, the saved
    inputs and every gradient; the no-save forward bit-equal to the saving
    one; two backward runs bit-equal. The block shapes timed as kernel,
    plain version, and the per-flow path of the same block (K5 with the f32
    1x1 conv, and the cuDNN conv chain), forward and forward + backward."""
    import torch
    from vgd_tpu_torch.ops.glow_flow_stack import glow_flow_stack
    rows = {n: [] for n in K6_NAMES}
    lib = None
    probe = k6_sync_probe(K, dev)
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for site, b, h, w, c, f, n, khw, dt in \
            [s_ + ((3, 3), "bfloat16") for s_ in K6_SHAPES] + K6_EXTRA:
        dtype = getattr(torch, dt)
        pad = (khw[0] // 2, khw[1] // 2)
        plan = K.flow_stack_plan(b, h, w, c, f, khw,
                                 bf16=dtype == torch.bfloat16,
                                 sm_count=sm_count)
        syncs = dict(zip(("fwd", "bwd"), plan.syncs(n)))
        if plan.bf16 and any(got > most for got, most in zip(
                plan.syncs_per_flow, K6_MAX_SYNCS)):
            failures.append(f"K6 {site}: {plan.syncs_per_flow} grid syncs "
                            f"per flow, at most {K6_MAX_SYNCS}")
        raw, fa, ba = k6_operands(dev, gen, b, h, w, c, f, n, khw, dtype)
        y, xsave = K.glow_flow_stack_fwd(*fa, khw, pad, True)
        y_ns = K.glow_flow_stack_fwd(*fa, khw, pad, False)
        got = K.glow_flow_stack_bwd(xsave, *ba, khw, pad)
        again = K.glow_flow_stack_bwd(xsave, *ba, khw, pad)
        torch.cuda.synchronize()
        ref_y, ref_xsave = K.glow_flow_stack_fwd_plain(*fa, khw, pad, True)
        ref = K.glow_flow_stack_bwd_plain(ref_xsave, *ba, khw, pad)
        got_r = K.glow_flow_stack_bwd(ref_xsave, *ba, khw, pad)
        torch.cuda.synchronize()
        same_ns = torch.equal(y, y_ns)
        same_bwd = all(torch.equal(a, r) for a, r in zip(got, again))
        if not (same_ns and same_bwd):
            failures.append(f"K6 {site} {dt}: no-save y bit-equal {same_ns}, "
                            f"backward bit-equal run to run {same_bwd}")
        gnames = ("dx", "danb", "dans", "dwt", "dw1", "db1", "dw2", "db2",
                  "dwz", "dbz", "dscale")
        per = {"glow_flow_stack_fwd": [("y", y, ref_y),
                                       ("xsave", xsave, ref_xsave)],
               "glow_flow_stack_fwd_nosave": [("y", y_ns, ref_y)],
               "glow_flow_stack_bwd": list(zip(gnames, got_r, ref))}
        shape = [b, h, w, c, f, n]
        line = []
        for kname, items in per.items():
            worst, worst_rel, errs = 0.0, 0.0, {}
            for what, a, r in items:
                if dtype == torch.float32:
                    rel, atol = ((K6_F32_REL, 0.0) if kname != K6_NAMES[2]
                                 else (K6_GRAD_REL,
                                       K6_GRAD_REL * K6_GRAD_FLOOR))
                else:
                    rel, atol = K6_BF16_REL, K6_BF16_ATOL
                err, rerr, ratio, flips, cnt = k5_error(a, r, rel, atol)
                errs[what] = err
                worst = max(worst, ratio)
                worst_rel = max(worst_rel, rerr)
                if not (ratio <= 1.0 and flips <= K6_FLIP_SHARE * cnt
                        and a.shape == r.shape and a.dtype == r.dtype):
                    failures.append(f"K6 {kname} {site} {shape} {dt} {what}:"
                                    f" err {err} ({ratio:.3g} of its bound, "
                                    f"{rerr:.3g} of max), {flips} flips of "
                                    f"{cnt}")
                line.append(f"{what} {rerr:.2e}")
            rows[kname].append({
                "shape": shape, "site": site, "dtype": dt, "kernel": khw,
                "plan": k6_plan_text(plan), "syncs": syncs,
                "syncs_per_flow": plan.syncs_per_flow,
                "max_abs_err": max(errs.values()), "max_rel_err": worst_rel,
                "err_over_bound": worst, "errors": errs,
                "tol": "f32: values 1e-4 x max|.|, gradients 5e-4 x (1e-3 "
                f"+ max|g|); bf16: {K6_BF16_REL} x max|.| + {K6_BF16_ATOL}"})
        print(f"[kernel] K6 {site} {shape} {dt} err/max: " + " ".join(line)
              + f"; no-save y bit-equal {same_ns}, backward deterministic "
              f"{same_bwd}; plan {k6_plan_text(plan)}; grid syncs "
              f"{syncs} ({plan.syncs_per_flow[0]} / "
              f"{plan.syncs_per_flow[1]} per flow)", flush=True)
        if site.startswith("block"):
            if lib is None:
                from vgd_tpu_torch.ops import _build
                lib = _build.glow_flow_stack_lib()
            work = k6_work(b, h, w, c, f, n, khw, 2)
            timed = {
                "glow_flow_stack_fwd": (
                    lambda: K.glow_flow_stack_fwd(*fa, khw, pad, True),
                    lambda: K.glow_flow_stack_fwd_plain(*fa, khw, pad, True)),
                "glow_flow_stack_fwd_nosave": (
                    lambda: K.glow_flow_stack_fwd(*fa, khw, pad, False),
                    lambda: K.glow_flow_stack_fwd_plain(*fa, khw, pad,
                                                        False)),
                "glow_flow_stack_bwd": (
                    lambda: K.glow_flow_stack_bwd(xsave, *ba, khw, pad),
                    lambda: K.glow_flow_stack_bwd_plain(ref_xsave, *ba, khw,
                                                        pad))}
            # the op with autograd (weight packing included) against the
            # per-flow path of the same block
            leaves = {k: raw[k].detach().clone().requires_grad_() for k in (
                "x", "an_b", "an_s", "wt", "w1", "b1", "w2", "b2", "wz",
                "bz", "scale")}
            tree = {"actnorm": {"b": leaves["an_b"], "s": leaves["an_s"]},
                    "coupling": {"conv1": {"w": leaves["w1"],
                                           "b": leaves["b1"]},
                                 "conv2": {"w": leaves["w2"],
                                           "b": leaves["b2"]},
                                 "zero": {"w": leaves["wz"],
                                          "b": leaves["bz"],
                                          "scale": leaves["scale"]}}}

            def op_fwd_bwd():
                glow_flow_stack(tree, leaves["wt"], leaves["x"], khw, pad,
                                dtype).backward(raw["g"])
            k5_fwd, k5_fb = per_flow_block(raw, khw, True, dtype)
            dnn_fwd, dnn_fb = per_flow_block(raw, khw, False, dtype)
            cmp = None
            for kname, (kern, plain) in timed.items():
                ops, nbytes = work[kname]
                r = rows[kname][-1]
                if cmp is None:
                    time_row(r, kern, plain, **dict(zip(K6_PER_FLOW_KEYS, (
                        op_fwd_bwd, k5_fwd, k5_fb, dnn_fwd, dnn_fb))))
                    cmp = {k: r[k] for k in K6_PER_FLOW_KEYS}
                else:
                    time_row(r, kern, plain)
                    r.update(cmp)
                r.update(flop_ms=ops / BF16_FLOPS * 1e3,
                         byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=1)
                bound = max(r["flop_ms"], r["byte_ms"])
                print(f"[kernel] K6 {site} {kname[16:]}: ms={r['ms']:.4f} "
                      f"p90={r['ms_p90']:.4f} call={r['call_ms']:.4f} "
                      f"plain={r['plain_ms']:.3f} bound={bound:.4f} "
                      f"({100 * bound / r['ms']:.1f} % of it); timing "
                      f"{r['timing']}", flush=True)
            stages = k6_stages(K, fa, ba, xsave, khw, pad, n, plan, dev)
            rows[K6_NAMES[0]][-1]["stages"] = stages
            print(f"[kernel] K6 {site} stages (us per flow, block 0's device "
                  f"clock, each stage's grid sync included): fwd " + ", ".join(
                      f"{k} {v:.2f}" for k, v in
                      stages["fwd_us_per_flow"].items())
                  + f" (+ last {stages['fwd_last_us']:.2f}; call "
                  f"{stages['fwd_total_us']:.1f}); bwd " + ", ".join(
                      f"{k} {v:.2f}" for k, v in
                      stages["bwd_us_per_flow"].items())
                  + f" (+ prologue {stages['bwd_prologue_us']:.2f}, closing "
                  f"{stages['bwd_closing_us']:.2f}; call "
                  f"{stages['bwd_total_us']:.1f})", flush=True)
            fb = {k: rows[k][-1]["ms"] for k in K6_NAMES}
            bound = {k: max(rows[k][-1]["flop_ms"], rows[k][-1]["byte_ms"])
                     for k in K6_NAMES}
            sync_ms = (syncs["fwd"] + syncs["bwd"]) * probe["us_per_sync"] / 1e3
            print(f"[kernel] K6 {site} summary: fwd {fb[K6_NAMES[0]]:.4f} / "
                  f"no-save {fb[K6_NAMES[1]]:.4f} / bwd "
                  f"{fb[K6_NAMES[2]]:.4f} ms (bound {bound[K6_NAMES[0]]:.4f}"
                  f" / {bound[K6_NAMES[1]]:.4f} / {bound[K6_NAMES[2]]:.4f});"
                  f" fwd+bwd {fb[K6_NAMES[0]] + fb[K6_NAMES[2]]:.4f} ms vs "
                  f"the per-flow K5 path {cmp['per_flow_k5_fwd_bwd_ms']:.4f}"
                  f" ms; {plan.syncs_per_flow[0]} + {plan.syncs_per_flow[1]}"
                  f" syncs per flow, {syncs['fwd'] + syncs['bwd']} a "
                  f"fwd+bwd at {probe['us_per_sync']:.3f} us each = "
                  f"{sync_ms:.4f} ms; plan {k6_plan_text(plan)}", flush=True)
            print(f"[kernel] K6 {site}: grid {lib.vgd_glow_flow_stack_grid(1, 0)}"
                  f" blocks (forward), {lib.vgd_glow_flow_stack_grid(1, 1)} "
                  f"(backward); grid syncs {syncs}; op fwd+bwd (autograd, "
                  f"packing included) {cmp['op_fwd_bwd_ms']:.3f} ms; per-flow "
                  f"path: K5 fwd {cmp['per_flow_k5_fwd_ms']:.3f} / fwd+bwd "
                  f"{cmp['per_flow_k5_fwd_bwd_ms']:.3f} ms, cuDNN fwd "
                  f"{cmp['per_flow_cudnn_fwd_ms']:.3f} / fwd+bwd "
                  f"{cmp['per_flow_cudnn_fwd_bwd_ms']:.3f} ms", flush=True)
            del leaves, tree, k5_fwd, k5_fb, dnn_fwd, dnn_fb
        del raw, fa, ba, y, xsave, y_ns, got, again, ref_y, ref_xsave, ref, \
            got_r
        torch.cuda.empty_cache()
    totals = {k: {key: sum(r[key] for r in v if "ms" in r)
                  for key in ("ms", "ms_p90", "call_ms", "plain_ms",
                              "flop_ms", "byte_ms")}
              for k, v in rows.items()}
    rows["probe"] = probe
    print("[kernel] K6 per train step (4 launches of each): " + "; ".join(
        f"{k[16:]} kernel {t['ms']:.3f} ms (p90 {t['ms_p90']:.3f}, call "
        f"time {t['call_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
        f"bound {max(t['flop_ms'], t['byte_ms']):.3f} ms" for k, t in
        totals.items()) + f" (bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
    return rows


def glow_stack_config():
    """The reference Glow of ``glow_config`` with ``flow_stack=True``: every
    block's train-step flows through K6; the ActNorm init and the reverse
    keep the per-flow path through K5."""
    import dataclasses
    cfg = glow_config()
    return dataclasses.replace(cfg, flow_stack=True, run=dataclasses.replace(
        cfg.run, out_dir=str(OUT_DIR / "glow_stack")))


def glow_stack_serve(K, cfg, failures):
    """The trained ``flow_stack`` checkpoint: ``GlowTrainer.forward`` (the
    no-grad likelihood) on a val batch, exactly one K6 no-save launch per
    block and nothing else, its bits/dim within STEP_LOSS_REL of the same
    forward with no kernel; then ``sample_from_dir("glow")`` (the reverse:
    128 K5 forwards, no K6)."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import make_image_datasets
    from vgd_tpu_torch.models.glow import calc_loss
    from vgd_tpu_torch.train import loop as L
    trainer = L.restore_glow(cfg, device="cuda")
    _, val, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
    vbatch, _ = next(iter(val.epoch()))
    gen = torch.Generator(device=trainer.device).manual_seed(cfg.run.seed)
    x = trainer._prep(torch.from_numpy(vbatch), gen, None)

    def bits(out):
        lp, ld, zs = out
        return (float(calc_loss(lp, ld, cfg.data.image_size[0],
                                trainer.n_bins)[0]),
                all(bool(torch.isfinite(z).all()) for z in zs))
    torch.cuda.synchronize()
    K.LAUNCHES.clear()
    start = time.perf_counter()
    got, finite = bits(trainer.forward(x))
    forward_s = time.perf_counter() - start
    launches = check_launches(K, dict(zip(GLOW_NAMES, (0,) * 4 + (
        K6_PER_STEP, 0))), "glow-stack-serve likelihood", failures)
    with K.plain_reference():
        ref, _ = bits(trainer.forward(x))
    rel = abs(got - ref) / abs(ref)
    print(f"[glow-stack-serve] val batch {tuple(x.shape)} bits/dim {got:.6f}"
          f" (no kernel {ref:.6f}, {rel:.3g} relative), z finite {finite}, "
          f"{forward_s * 1e3:.3f} ms", flush=True)
    if not (finite and rel <= STEP_LOSS_REL):
        failures.append(f"glow-stack-serve: bits/dim {got} vs {ref}")
    K.LAUNCHES.clear()
    path = L.sample_from_dir("glow", cfg, n=cfg.n_samples, device="cuda")
    check_launches(K, dict(zip(GLOW_NAMES, (K5_PER_STEP,) + (0,) * 5)),
                   "glow-stack-serve sample", failures)
    arr = np.load(path)
    if not (arr.shape == (cfg.n_samples, 64, 64, 3)
            and np.isfinite(arr).all()):
        failures.append(f"glow-stack-serve: bad samples {arr.shape}")
    return {"bits_per_dim": got, "bits_per_dim_ref": ref, "rel": rel,
            "forward_s": forward_s, "launches": launches,
            "samples": list(arr.shape)}


def glow_stack_path(K, gen, failures):
    cfg = glow_stack_config()
    shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    none5 = (0,) * len(K5_NAMES)
    k6_step = (K6_PER_STEP, 0, K6_PER_STEP)
    k5_fwd = (K5_PER_STEP, 0, 0) + (0,) * len(K6_NAMES)
    stats = check_glow_step(
        K, cfg, gen, failures, "glow-stack-step", dict(zip(GLOW_NAMES, k5_fwd)),
        dict(zip(GLOW_NAMES, none5 + k6_step)),
        compare=(("per_flow_k5", {"flow_stack": False}),
                 ("stack256", {"flow_stack": 256})))
    stats["train"] = glow_train_path(K, cfg, failures, "glow-stack-train",
                                     none5 + k6_step, k5_fwd, k5_fwd)
    stats["serve"] = glow_stack_serve(K, cfg, failures)
    return stats


# ---------------------------------------------------------------------------
# EEG Glow: the 1-D flow on EEG trials. No kernel runs here: the reference's
# EEG trainer sets neither fused_coupling nor flow_stack
# ---------------------------------------------------------------------------

# the reference EEG flow (flow_eeg.py: 22 channels x 160 samples, batch 16,
# K=32, L=4, width 512, Adam at 1e-3, f32) on the synthetic T session (288
# trials a class): run_glow_eeg per event type for EEG_ITERS iterations with
# a dump and a checkpoint every EEG_EVERY, a resume, EEG_EVERY more; the
# reference trains 6000
EEG_ITERS, EEG_EVERY = 10, 5
# the EEG phase's own generator (dequantisation noise, ZeroConv weights)
EEG_SEED = 12
# the TSTR regimes, each on subjects 01 and 02 of the synthetic sessions
TSTR_METHODS = ("synt", "real", "sr", "other_sub")
EEG_GROUPS = [("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad",
                                        "nchw", "nhwc", "winograd")),
              ("optimizer (Adam, foreach)", ("multi_tensor", "adam")),
              ("triangular solves and small matmuls (cuBLAS)",
               ("trsm", "gemm", "gemv", "cutlass", "xmma")),
              ("reductions", ("reduce",)),
              ("dtype casts and copies", ("copy",))]


def eeg_config(event_type="mi"):
    """The reference EEG flow at full width: ``GlowEEGConfig()`` writing
    under OUT_DIR, a dump and a checkpoint every EEG_EVERY iterations."""
    from vgd_tpu_torch.core.config import GlowEEGConfig, RunConfig
    return GlowEEGConfig(
        run=RunConfig(out_dir=str(OUT_DIR / "glow_eeg"), seed=42,
                      compute_dtype="float32", sample_every_iters=EEG_EVERY,
                      checkpoint_every_iters=EEG_EVERY),
        event_type=event_type)


def eeg_step_grads(trainer, batch, noise):
    """Loss and every parameter's gradient of one EEG train step (as
    ``train_step`` computes them, without the Adam update), on the
    trainer's device."""
    model = trainer.model
    model.zero_grad(set_to_none=True)
    log_p, logdet, _ = model(trainer._prep(batch, None, noise))
    loss = trainer._loss(log_p, logdet)[0]
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def check_eeg_step(K, cfg, failures):
    """One full-width EEG train step on the card against the same step of
    the port on the CPU: the same weights (the seeded init, the ActNorm
    init on the first stream batch, ZeroConvs set to 0.01 N(0, 1)) and the
    same batch and dequantisation noise; the loss within STEP_LOSS_REL and
    every gradient within STEP_GRAD_REL x its tensor's max |g| +
    STEP_GRAD_FLOOR x the largest (``compare_glow_step``). Then the step
    timed, profiled and its peak memory."""
    import torch
    from vgd_tpu_torch.data.eeg import EEGDataset, eeg_batches
    from vgd_tpu_torch.train.glow import GlowEEGTrainer
    ds = EEGDataset(None, "T", cfg.event_type, seed=cfg.run.seed)
    batch = torch.from_numpy(next(eeg_batches(ds, cfg.batch_size,
                                              seed=cfg.run.seed)))
    gen = torch.Generator().manual_seed(EEG_SEED)
    noise0, noise = (torch.rand(batch.shape, generator=gen)
                     for _ in range(2))
    card = GlowEEGTrainer(cfg, device="cuda")
    dev = card.device
    card.init(torch.Generator(device=dev).manual_seed(cfg.run.seed))
    card.init_step(batch, noise=noise0)
    with torch.no_grad():
        for blk in card.model.blocks():
            zw = blk.flows.coupling.zero.w
            zw.copy_(0.01 * torch.randn(zw.shape, generator=gen).to(dev))
    host = GlowEEGTrainer(cfg, device="cpu")
    host.load({k: v.cpu() for k, v in card.model.state_dict().items()})
    n_params = sum(p.numel() for p in card.model.parameters())
    t0 = time.perf_counter()
    got = eeg_step_grads(card, batch, noise)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss_h, grads_h = eeg_step_grads(host, batch, noise)
    cpu_s = time.perf_counter() - t1
    worst, name, loss_rel = compare_glow_step(
        got, (loss_h, {k: v.to(dev) for k, v in grads_h.items()}))
    print(f"[eeg-step] init: {cfg.num_channels}x{cfg.num_samples} B="
          f"{cfg.batch_size} K={cfg.n_flows} L={cfg.n_blocks} width "
          f"{cfg.filter_size} f32: {n_params} parameters", flush=True)
    print(f"[eeg-step] card vs CPU, same weights / batch / noise: loss "
          f"{got[0]:.6f} / {loss_h:.6f} ({loss_rel:.2e} relative); "
          f"{len(grads_h)} gradients, worst {worst:.3f} of the bound at "
          f"{name} (first card call {1e3 * (t1 - t0):.1f} ms, CPU "
          f"{cpu_s:.2f} s)", flush=True)
    if not (worst <= 1.0 and loss_rel <= STEP_LOSS_REL):
        failures.append(f"eeg-step: card vs CPU worst {worst:.3f} at {name},"
                        f" loss {loss_rel:.2e}")
    stats = {"n_params": n_params, "loss": got[0], "loss_cpu": loss_h,
             "loss_rel": loss_rel, "grad_worst": worst, "grad_worst_at": name,
             "cpu_grad_s": cpu_s}
    del host, grads_h, got
    bd, nd = batch.to(dev), noise.to(dev)

    def step():
        card.train_step(bd, noise=nd)
    torch.cuda.reset_peak_memory_stats()
    stats["train_step_ms"] = ms = cuda_ms(step, 2, 5)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["train_step_profile"] = profile_fn(step, EEG_GROUPS,
                                             "profile-eeg-step")
    print(f"[eeg-step] whole f32 train step B={cfg.batch_size}: {ms:.3f} ms "
          f"= {cfg.batch_size / ms * 1e3:.1f} trials/s; peak memory "
          f"{stats['peak_mem_gb']:.3f} GB", flush=True)
    return stats


def eeg_train_path(K, cfg, failures):
    """``run_glow_eeg`` for EEG_ITERS iterations, a resume that runs no
    iteration (it must restore exactly what was saved) and a resume that
    trains EEG_EVERY more from the right stream batch; the dumps (N, C, T),
    trace PNGs only where matplotlib imports, finite losses, each step's
    CUDA-event time."""
    import importlib.util
    import numpy as np
    import torch
    from vgd_tpu_torch.data.eeg import EEGDataset, eeg_batches
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.glow import GlowEEGTrainer
    draws_png = importlib.util.find_spec("matplotlib") is not None
    et, od = cfg.event_type, Path(cfg.run.out_dir)
    original = GlowEEGTrainer.train_step
    calls, fed = [], []

    def counted(self, batch, *args, **kwargs):
        fed.append(batch.clone())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = original(self, batch, *args, **kwargs)
        end.record()
        calls.append((start, end, out))
        return out
    GlowEEGTrainer.train_step = counted
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = L.run_glow_eeg(cfg, n_iter=EEG_ITERS, device="cuda")
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        trainer = res["trainer"]
        losses = [float(c[2]["loss"]) for c in calls]
        step_ms = sorted(s.elapsed_time(e) for s, e, _ in calls[1:])
        med = step_ms[len(step_ms) // 2]
        stats = {"train_steps": len(losses), "run_s": run_s,
                 "losses": losses, "log": res["log"],
                 "step_ms_median": med, "step_ms_min": step_ms[0],
                 "step_ms_max": step_ms[-1],
                 "trials_per_sec_median_step": cfg.batch_size / med * 1e3,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        dumps = sorted((od / "sample").glob(f"fake_eeg_{et}_training_*.npz"))
        pngs = sorted((od / "sample").glob(f"fake_eeg_{et}_training_*.png"))
        arr = np.load(dumps[-1])["arr_0"] if dumps else np.zeros(0)
        if not (len(losses) == EEG_ITERS
                and all(math.isfinite(v) for v in losses)
                and len(dumps) == EEG_ITERS // EEG_EVERY
                and len(pngs) == (len(dumps) if draws_png else 0)
                and arr.shape == (cfg.n_samples, cfg.num_channels,
                                  cfg.num_samples)
                and np.isfinite(arr).all()
                and (od / f"psd_{et}.npz").exists()):
            failures.append(f"eeg-train {et}: losses {losses}, dumps "
                            f"{[d.name for d in dumps]} {arr.shape}, "
                            f"{len(pngs)} PNGs")
        print(f"[eeg-train] {et}: loss by step " + " ".join(
            f"{v:.4f}" for v in losses), flush=True)
        print(f"[eeg-train] {et}: {len(losses)} steps; step ms median "
              f"{med:.3f} (min {step_ms[0]:.3f}, max {step_ms[-1]:.3f}) "
              f"after the first = {stats['trials_per_sec_median_step']:.1f} "
              f"trials/s; run {run_s:.1f} s with the ActNorm init, "
              f"{len(dumps)} dumps, {len(pngs)} PNGs and the PSD; peak "
              f"memory {stats['peak_mem_gb']:.3f} GB", flush=True)

        final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        opt_a = trainer.opt.state_dict()["state"]
        payload = Checkpointer(f"{od}/ckpt_{et}").load()
        back = L.run_glow_eeg(cfg, n_iter=EEG_ITERS, resume=True,
                              device="cuda")["trainer"]
        same_params = all(torch.equal(final[k], v) and
                          torch.equal(payload["params"][k], v.cpu())
                          for k, v in back.model.state_dict().items())
        opt_b = back.opt.state_dict()["state"]
        same_opt = opt_a.keys() == opt_b.keys() and all(
            torch.equal(opt_a[i][x].cpu(), opt_b[i][x].cpu())
            for i in opt_a for x in ("step", "exp_avg", "exp_avg_sq"))
        ok = (same_params and same_opt and payload["step"] == EEG_ITERS
              and back.step == EEG_ITERS == payload["opt_step"])
        print(f"[eeg-train] {et} resume: checkpoint iteration "
              f"{payload['step']}, optimizer steps {back.step}: params equal "
              f"{same_params}, Adam state equal {same_opt}", flush=True)
        if not ok:
            failures.append(f"eeg-train {et}: resume did not restore what "
                            f"was saved")
        del back, trainer, res, final, opt_a, opt_b
        calls.clear()
        fed.clear()
        res = L.run_glow_eeg(cfg, n_iter=EEG_ITERS + EEG_EVERY, resume=True,
                             device="cuda")
        ds = EEGDataset(None, "T", et, seed=cfg.run.seed)
        want = torch.from_numpy(next(eeg_batches(
            ds, cfg.batch_size, seed=cfg.run.seed, skip=EEG_ITERS + 1)))
        same_stream = bool(fed) and torch.equal(fed[0].cpu(), want)
        losses3 = [float(c[2]["loss"]) for c in calls]
        print(f"[eeg-train] {et} resumed: {len(losses3)} steps from "
              f"iteration {EEG_ITERS}, first batch is stream batch "
              f"{EEG_ITERS + 1}: {same_stream}; loss " + " ".join(
                  f"{v:.4f}" for v in losses3), flush=True)
        if not (res["trainer"].step == EEG_ITERS + EEG_EVERY and same_stream
                and len(losses3) == EEG_EVERY
                and all(math.isfinite(v) for v in losses3)):
            failures.append(f"eeg-train {et} resumed run: step "
                            f"{res['trainer'].step}, stream {same_stream}, "
                            f"losses {losses3}")
        stats["resumed_losses"] = losses3
    finally:
        GlowEEGTrainer.train_step = original
    return stats


def mu_power(freq, psd):
    """Power of a PSD over the mu band, 8-13 Hz (rectangle rule)."""
    band = (freq >= 8.0) & (freq <= 13.0)
    return float(psd[band].sum() * (freq[1] - freq[0]))


def eeg_serve_path(K, cfg, failures):
    """On the trained checkpoints: ``eeg_psd_and_gif`` (restore, 64
    generated trials, the central PSD against the real trials'),
    ``sample_from_dir("glow-eeg")`` and the ``tstr`` command for every
    regime on subjects 01 and 02; the real regime's test accuracy within
    (0.5, 1]; the other regimes printed (a few-iteration flow sits near
    chance)."""
    import contextlib
    import dataclasses
    import io
    import numpy as np
    import torch
    from vgd_tpu_torch import cli
    from vgd_tpu_torch.train import loop as L
    stats = {}
    t0 = time.perf_counter()
    L.eeg_psd_and_gif(cfg, n_fake=64, device="cuda")
    stats["psd_s"] = time.perf_counter() - t0
    for et in ("mi", "baseline"):
        psd = np.load(f"{cfg.run.out_dir}/psd_{et}.npz")
        real, fake = (mu_power(psd["freq"], psd[k]) for k in ("real", "fake"))
        stats[f"mu_power_{et}"] = {"real": real, "fake": fake,
                                   "n_fake": int(psd["n_fake"])}
        print(f"[eeg-psd] {et}: 8-13 Hz power of the C3/Cz/C4 average: real "
              f"{real:.4f}, generated {fake:.4f} ({int(psd['n_fake'])} finite"
              f" of 64)", flush=True)
        if not (math.isfinite(real) and real > 0):
            failures.append(f"eeg-psd {et}: real power {real}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = L.sample_from_dir("glow-eeg", dataclasses.replace(
        cfg, event_type="baseline"), n=cfg.n_samples, device="cuda")
    torch.cuda.synchronize()
    stats["sample_s"] = time.perf_counter() - t0
    arr = np.load(path)
    print(f"[eeg-serve] sample request ({cfg.n_samples} trials, checkpoint "
          f"restore included) {stats['sample_s']:.3f} s; {arr.shape} finite "
          f"{bool(np.isfinite(arr).all())}", flush=True)
    if not (arr.shape == (cfg.n_samples, cfg.num_channels, cfg.num_samples)
            and np.isfinite(arr).all()):
        failures.append(f"eeg-serve: bad samples {arr.shape}")
    stats["tstr"] = {}
    for method in TSTR_METHODS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            cli.main(["tstr", "--method", method, "--ckpt-dir",
                      cfg.run.out_dir, "--subjects", "01", "02",
                      "--flows", str(cfg.n_flows), "--blocks",
                      str(cfg.n_blocks), "--filter-size",
                      str(cfg.filter_size), "--device", "cuda"])
        secs = time.perf_counter() - t0
        res = json.loads(out.getvalue().strip().splitlines()[-1])
        stats["tstr"][method] = dict(res, seconds=secs)
        print(f"[eeg-tstr] {method} ({secs:.2f} s): " + "; ".join(
            f"subject {s}: train acc {r['train']['acc']:.4f}, test acc "
            f"{r['test']['acc']:.4f} f1 {r['test']['f1']:.4f} kappa "
            f"{r['test']['k']:.4f}" for s, r in res.items()), flush=True)
        if method == "real" and not all(
                0.5 < r["test"]["acc"] <= 1.0 for r in res.values()):
            failures.append(f"eeg-tstr real: test accuracy outside (0.5, 1]:"
                            f" {res}")
    return stats


def eeg_path(K, failures):
    """The EEG phase: the step against the CPU, both event types'
    training, the PSD, a sample request and TSTR; no kernel launched."""
    import dataclasses
    t0 = time.perf_counter()
    cfg = eeg_config()
    shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
    K.LAUNCHES.clear()
    stats = {"step": check_eeg_step(K, cfg, failures)}
    for et in ("mi", "baseline"):
        stats[f"train_{et}"] = eeg_train_path(
            K, dataclasses.replace(cfg, event_type=et), failures)
    stats["serve"] = eeg_serve_path(K, cfg, failures)
    stats["launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
    if stats["launches"]:
        failures.append(f"eeg: kernels launched {stats['launches']}")
    stats["phase_s"] = time.perf_counter() - t0
    print(f"[eeg] phase {stats['phase_s']:.1f} s; kernel launches "
          f"{stats['launches']}", flush=True)
    return stats


# ---------------------------------------------------------------------------
# Inception metrics: FID, IS and manifold P/R behind --fid (no kernel of its
# own; the evaluations it rides on run K3 / K4 (DDPM) and K5 (Glow))
# ---------------------------------------------------------------------------

# InceptionV3 at 299x299 in f32, the port's seeded weights (random-init:
# the surrogate keys): card vs CPU on FID_CHECK_IMAGES 64x64 faces, each tap
# within INCEPTION_REL of its max |value| (f32 both sides, 94 layers summed
# in other orders); the FID of two fixed sets of FID_SET images, card vs
# CPU, within FID_REL (more images than the 64 feature dimensions, so the
# covariances are full rank); timed at FID_BATCH images a call
FID_CHECK_IMAGES, FID_SET, FID_BATCH = 8, 72, 64
INCEPTION_REL, FID_REL = 1e-3, 1e-3


def inception_flops(model, x):
    """Multiply-adds x 2 of one forward of ``model`` on ``x`` (every
    convolution and the fc, from the shapes a forward hook sees)."""
    import torch
    total = [0]

    def hook(mod, inp, out):
        w = mod.weight
        total[0] += 2 * out.numel() * w[0].numel()
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def check_inception(failures):
    """The seeded InceptionV3 on the card against the same weights on the
    CPU (every tap; the FID of two fixed feature sets), then a batch of
    FID_BATCH timed in f32 and, to show what keeping f32 costs, with TF32
    convolutions (time and error), with its bound and peak memory."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import synthetic_faces
    from vgd_tpu_torch.eval.inception import TAPS, build_inception
    from vgd_tpu_torch.eval.metrics import frechet_distance
    card, tag = build_inception(None, "cuda")
    host, _ = build_inception(None, "cpu")
    dev = next(card.parameters()).device
    x = torch.from_numpy(synthetic_faces(FID_CHECK_IMAGES, (64, 64), 3,
                                         seed=21)).float() / 255.0
    got, want = card(x.to(dev)), host(x)
    errs = {k: float((got[k].cpu() - want[k]).abs().max())
            / float(want[k].abs().max()) for k in TAPS}
    print(f"[inception] card vs CPU, {FID_CHECK_IMAGES} images, weights "
          f"{tag}: max error / max |tap| " + " ".join(
              f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    if max(errs.values()) > INCEPTION_REL:
        failures.append(f"inception: card vs CPU {errs}")

    rng = np.random.default_rng(23)
    real = synthetic_faces(FID_SET, (64, 64), 3, seed=22)
    fake = np.clip(real + rng.normal(0, 40, real.shape), 0, 255).astype(
        np.uint8)

    def feats(model, u8):
        at = next(model.parameters()).device
        out = []
        for i in range(0, len(u8), 24):
            t = torch.from_numpy(u8[i:i + 24]).to(at).float() / 255.0
            out.append(model(t)["64"].cpu())
        return torch.cat(out).numpy()
    t0 = time.perf_counter()
    fid_card = frechet_distance(feats(card, real), feats(card, fake))
    t1 = time.perf_counter()
    fid_cpu = frechet_distance(feats(host, real), feats(host, fake))
    cpu_s = time.perf_counter() - t1
    fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
    print(f"[inception] FID of {FID_SET} faces against {FID_SET} noisy "
          f"copies, feature 64: card {fid_card:.6f}, CPU {fid_cpu:.6f} "
          f"({fid_rel:.2e} relative; card {t1 - t0:.2f} s, CPU {cpu_s:.2f} "
          f"s)", flush=True)
    if not (math.isfinite(fid_card) and fid_rel <= FID_REL):
        failures.append(f"inception: FID card {fid_card} vs CPU {fid_cpu}")
    del host

    xb = torch.from_numpy(synthetic_faces(FID_BATCH, (64, 64), 3, seed=24)
                          ).to(dev).float() / 255.0

    def f32():
        card(xb)

    def tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return card(xb)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ref = card(xb)
    peak = torch.cuda.max_memory_allocated() / 1e9
    low = tf32()
    tf32_err = {k: float((low[k] - ref[k]).abs().max())
                / float(ref[k].abs().max()) for k in TAPS}
    times = device_ms({"f32": f32, "tf32": tf32})
    flops = inception_flops(card, xb)
    stats = {"weights": tag, "card_vs_cpu": errs, "fid_card": fid_card,
             "fid_cpu": fid_cpu, "fid_rel": fid_rel, "batch": FID_BATCH,
             "ms": times["f32"]["median"], "ms_p90": times["f32"]["p90"],
             "tf32_ms": times["tf32"]["median"], "tf32_rel_err": tf32_err,
             "timing": times["f32"]["how"], "gflop": flops / 1e9,
             "bound_ms": flops / F32_FLOPS * 1e3,
             "tf32_bound_ms": flops / TF32_FLOPS * 1e3, "peak_mem_gb": peak}
    stats["images_per_sec"] = FID_BATCH / stats["ms"] * 1e3
    print(f"[inception] batch {FID_BATCH} (64x64 resized to 299x299), f32: "
          f"{stats['ms']:.3f} ms (p90 {stats['ms_p90']:.3f}, device time) = "
          f"{stats['images_per_sec']:.1f} images/s; {stats['gflop']:.1f} "
          f"GFLOP, bound {stats['bound_ms']:.3f} ms at 67 TFLOP/s f32; "
          f"peak memory {peak:.3f} GB", flush=True)
    print(f"[inception] the same batch with TF32 convolutions: "
          f"{stats['tf32_ms']:.3f} ms (bound {stats['tf32_bound_ms']:.3f} "
          f"ms), taps off by " + " ".join(
              f"{k} {v:.2e}" for k, v in tf32_err.items()) + " of max: the "
          f"port keeps f32", flush=True)
    return stats


def fid_eval_path(K, report, failures):
    """Each evaluation entry point once with the seeded Inception
    ``feature_fn`` on the checkpoint its phase trained, one val batch:
    DDPM restoration (K3 / K4 launches exactly those of the serve phase's
    same evaluation without it), Glow on the fused-coupling checkpoint
    (128 K5 forwards, one reverse, as without it), the DCGAN and VAE
    checkpoint sweeps (no launch); the surrogate keys present, FID
    finite."""
    import torch
    from vgd_tpu_torch.train import loop as L
    feature_fn, tag = L.load_feature_fn(True, device="cuda")
    no_kernel = {}
    runs = [
        ("diffusion", lambda: L.evaluate_diffusion_from_dir(
            smoke_config(), feature_fn=feature_fn, max_batches=1,
            device="cuda"),
         serving_launches(report["main_path"]["serve"]["restore_forwards"])),
        ("glow", lambda: L.evaluate_glow_from_dir(
            glow_config(), feature_fn=feature_fn, max_batches=1,
            device="cuda"),
         {"glow_coupling_fwd": K5_PER_STEP, "glow_coupling_bwd1": 0,
          "glow_coupling_bwd2": 0}),
        ("gan", lambda: L.evaluate_gan_checkpoints(
            gan_config(), feature_fn=feature_fn, max_checkpoints=1,
            device="cuda")[0], no_kernel),
        ("vae", lambda: L.evaluate_vae_checkpoints(
            vae_config(), feature_fn=feature_fn, max_checkpoints=1,
            max_encode_batches=1, max_eval_batches=1, device="cuda")[0],
         no_kernel)]
    stats = {"weights": tag}
    for name, run, want in runs:
        K.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        keys = ("fid_surrogate", "precision_surrogate", "recall_surrogate")
        print(f"[fid-eval] {name}: {secs:.3f} s (checkpoint restore and one "
              f"val batch included): " + " ".join(
                  f"{k} {res.get(k, float('nan')):.6f}" for k in keys)
              + f" ssim {res['ssim']:.4f}; launches {got}", flush=True)
        if got != {k: v for k, v in want.items() if v} or not (
                all(k in res for k in keys) and "inception_score" not in res
                and math.isfinite(res["fid_surrogate"])):
            failures.append(f"fid-eval {name}: {res}, launches {got}, want "
                            f"{want}")
        stats[name] = {"seconds": secs, "launches": got, **res}
    return stats


# ---------------------------------------------------------------------------
# Serving export (io/export.py) and the real-image data path
# ---------------------------------------------------------------------------

# the export phase's request seed, requests and repeats of each timing
EXPORT_SEED, EXPORT_N, EXPORT_DDIM, EXPORT_REPEATS = 0, 16, 50, 3
# the artifact against the eager path on the card, the same draws and the
# same kernels: the difference seen is printed (expected 0); a fault shows
# far above this bound (images in [-1, 1])
EXPORT_ATOL = 1e-3
# the VAE denoiser's CPU canary (the same file loaded on the CPU) against
# the card: its convs take bf16 operands on both sides, summed in f32 in
# another order, and every layer rounds its output to bf16, so an
# activation may flip by a bf16 ulp (2^-8 relative) and carry it to the
# reconstruction in [-1, 1]. The largest difference is held at 2^-5 (8
# bf16 ulps of an output near 1), the mean at 1e-3, which a systematic
# fault would pass (on an H100 the trained checkpoint measured 5.9e-3 and
# 1.4e-4, a seeded one 1.2e-4 and 1.6e-5)
CANARY_ATOL, CANARY_MEAN = 2.0 ** -5, 1e-3
# the data path: CelebA's aligned crops (178 x 218) written as JPEGs, then
# run_vaegan at 256x256, batch 64, short epochs
DATA_JPEGS, DATA_STEPS, DATA_EPOCHS = 640, 3, 2
DATA_JPEG_HW = (218, 178)


def request_ms(fn, repeats=EXPORT_REPEATS):
    """Median host time (ms) of ``repeats`` calls after one warm-up, each
    ended by a synchronise (a request's time, host work included)."""
    import statistics
    import torch
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def seeded_checkpoints():
    """``--only export``: a seeded checkpoint of the DDPM, Glow and VAE
    configurations where the full run's training phases left none."""
    import torch
    from vgd_tpu_torch.core.config import to_dict
    from vgd_tpu_torch.core.rng import seed_all
    from vgd_tpu_torch.io.checkpoint import Checkpointer, has_checkpoint
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    from vgd_tpu_torch.train.glow import GlowTrainer
    from vgd_tpu_torch.train.vae import VAETrainer
    cfg = smoke_config()
    if not has_checkpoint(f"{cfg.run.out_dir}/ckpt"):
        tr = DiffusionTrainer(cfg, (256, 256, 3), device="cuda")
        tr.init(seed_all(42, "cuda"))
        L.save_checkpoint(cfg, tr, 1)
    for cfg, make in ((glow_config(), lambda c: GlowTrainer(
            c, (64, 64, 3), device="cuda")), (vae_config(), lambda c:
            VAETrainer(c, (64, 64, 3), device="cuda"))):
        if not has_checkpoint(f"{cfg.run.out_dir}/ckpt"):
            tr = make(cfg)
            tr.init(seed_all(42, "cuda"))
            params = (tr.model if hasattr(tr, "model") else tr).state_dict()
            Checkpointer(f"{cfg.run.out_dir}/ckpt").save(1, params,
                                                         to_dict(cfg))
    torch.cuda.empty_cache()


def export_one(K, tag, family, cfg, failures, want, eager, **kw):
    """Export ``family``'s checkpoint, load it with a fresh
    ``load_artifact`` on the card, serve one request from EXPORT_SEED with
    exactly the ``want`` launches, hold it against ``eager(meta, draws)``
    (the same draws through the eager path), and time both (median of
    EXPORT_REPEATS, draws made beforehand)."""
    import numpy as np
    import torch
    from vgd_tpu_torch.io.export import (export_serving, load_artifact,
                                         run_artifact, serving_draws)
    path = str(OUT_DIR / f"serving_{family}_{kw.get('mode', 'sample')}.pt2")
    t0 = time.perf_counter()
    export_serving(family, cfg, n=EXPORT_N, artifact_path=path, **kw)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    call, meta = load_artifact(path, device="cuda")
    load_s = time.perf_counter() - t0
    draws = serving_draws(meta, EXPORT_SEED)
    K.LAUNCHES.clear()
    torch.cuda.synchronize()
    out = run_artifact(seed=EXPORT_SEED, loaded=(call, meta))
    torch.cuda.synchronize()
    launches = check_launches(K, want, tag, failures)
    ref = eager(meta, draws)
    err = float(np.abs(out - ref).max())
    print(f"[{tag}] artifact vs eager (same draws, same kernels): max abs "
          f"diff {err:.3e} (bound {EXPORT_ATOL})", flush=True)
    if not (np.isfinite(out).all() and err <= EXPORT_ATOL):
        failures.append(f"{tag}: artifact vs eager {err}")
    art_ms = request_ms(lambda: run_artifact(seed=EXPORT_SEED,
                                             loaded=(call, meta),
                                             draws=draws))
    eager_ms = request_ms(lambda: eager(meta, draws))
    mb = os.path.getsize(path) / 1e6
    print(f"[{tag}] export {export_s:.2f} s, artifact {mb:.1f} MB, load "
          f"{load_s:.2f} s; request (n={EXPORT_N}) artifact {art_ms:.3f} ms "
          f"vs eager {eager_ms:.3f} ms (median of {EXPORT_REPEATS})",
          flush=True)
    return {"export_s": export_s, "artifact_mb": mb, "load_s": load_s,
            "request_ms": art_ms, "eager_ms": eager_ms, "max_abs_diff": err,
            "launches": launches, "in_specs": meta["in_specs"]}


def export_ddpm(K, failures):
    """(a) The DDPM checkpoint as ``diffusion`` DDIM-50, n=16: 3 K3 and 14
    K4 per step forward, no K2; against ``ddim_sample`` on the same
    xt."""
    import torch
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import ddim_timesteps
    cfg = smoke_config()
    trainer = L.restore_trainer(cfg, device="cuda")
    forwards = len(ddim_timesteps(cfg.timesteps, EXPORT_DDIM))

    def eager(meta, draws):
        return trainer.ddim_sample(draws["xt"].to(trainer.device),
                                   EXPORT_DDIM, eta=0.0).cpu().numpy()
    stats = export_one(K, "export-ddpm", "diffusion", cfg, failures,
                       serving_launches(forwards), eager,
                       ddim_steps=EXPORT_DDIM)
    del trainer
    torch.cuda.empty_cache()
    return stats


def export_glow(K, failures):
    """(b) The fused-coupling Glow checkpoint as ``sample``, n=16: 128 K5
    forwards a request; against ``reverse`` on the same z."""
    import numpy as np
    import torch
    from vgd_tpu_torch.train import loop as L
    cfg = glow_config()
    trainer = L.restore_glow(cfg, device="cuda")
    sizes = [int(np.prod(s)) for s in trainer.z_shapes]

    def eager(meta, draws):
        z = draws["z"].to(trainer.device)
        zs = [part.reshape((z.shape[0],) + tuple(s)) * cfg.temperature
              for part, s in zip(z.split(sizes, 1), trainer.z_shapes)]
        return (trainer.reverse(zs) * 2.0).float().cpu().numpy()
    stats = export_one(K, "export-glow", "glow", cfg, failures,
                       {"glow_coupling_fwd": K5_PER_STEP,
                        "glow_coupling_bwd1": 0, "glow_coupling_bwd2": 0},
                       eager)
    del trainer
    torch.cuda.empty_cache()
    return stats


def export_vae(K, failures):
    """(c) The VAE checkpoint as ``denoise --poly-batch``: B=3 and B=64
    from one file on the card (each against ``denoise`` on the same eps),
    and the same file loaded on the CPU held against the card at B=3."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data.celeba import synthetic_faces
    from vgd_tpu_torch.io.export import (export_serving, load_artifact,
                                         run_artifact, serving_draws)
    from vgd_tpu_torch.train import loop as L
    cfg = vae_config()
    path = str(OUT_DIR / "serving_vae_denoise.pt2")
    t0 = time.perf_counter()
    export_serving("vae", cfg, n=2, mode="denoise", poly_batch=True,
                   artifact_path=path)
    export_s = time.perf_counter() - t0
    trainer = L.restore_vae(cfg, device="cuda")
    card = load_artifact(path, device="cuda")
    imgs = synthetic_faces(64, (64, 64), seed=EXPORT_SEED + 1)
    x = imgs.astype(np.float32) / 127.5 - 1.0
    stats = {"export_s": export_s,
             "artifact_mb": os.path.getsize(path) / 1e6}
    outs = {}
    for b in (3, 64):
        K.LAUNCHES.clear()
        out = run_artifact(seed=EXPORT_SEED, inputs=x[:b], loaded=card)
        eps = serving_draws(card[1], EXPORT_SEED, batch=b)["eps"]
        ref = trainer.denoise(torch.from_numpy(x[:b]), eps).float().cpu() \
            .numpy()
        err = float(np.abs(out - ref).max())
        ms = request_ms(lambda: run_artifact(seed=EXPORT_SEED, inputs=x[:b],
                                             loaded=card))
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        print(f"[export-vae] B={b}: out {out.shape}, vs eager denoise max "
              f"abs diff {err:.3e}, request {ms:.3f} ms, launches {got}",
              flush=True)
        if out.shape != x[:b].shape or not np.isfinite(out).all() or \
                err > EXPORT_ATOL or got:
            failures.append(f"export-vae B={b}: {out.shape} err {err} "
                            f"launches {got}")
        outs[b] = out
        stats[f"b{b}"] = {"max_abs_diff": err, "request_ms": ms}
    t0 = time.perf_counter()
    cpu = load_artifact(path, device="cpu")
    out_cpu = run_artifact(seed=EXPORT_SEED, inputs=x[:3], loaded=cpu)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(out_cpu - outs[3]).max())
    mean = float(np.abs(out_cpu - outs[3]).mean())
    print(f"[export-vae] CPU canary (the same file on the CPU, B=3): max abs "
          f"diff {err:.3e}, mean {mean:.3e} vs the card (bounds "
          f"{CANARY_ATOL}, {CANARY_MEAN}); load + request {cpu_s:.2f} s",
          flush=True)
    if not (err <= CANARY_ATOL and mean <= CANARY_MEAN):
        failures.append(f"export-vae CPU canary: max {err}, mean {mean}")
    stats["canary"] = {"max_abs_diff": err, "mean_abs_diff": mean,
                       "seconds": cpu_s}
    del trainer
    torch.cuda.empty_cache()
    return stats


def data_path(K, failures):
    """(d) DATA_JPEGS synthetic faces written at CelebA's aligned size as
    JPEGs; ``run_vaegan`` at 256x256, batch 64, from that folder for
    DATA_EPOCHS epochs of DATA_STEPS steps (the decode rate and the step
    time printed); a second run opens the cache and decodes nothing."""
    import numpy as np
    from PIL import Image
    from vgd_tpu_torch.data import celeba
    from vgd_tpu_torch.train import loop as L
    folder = OUT_DIR / "jpeg_faces"
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    t0 = time.perf_counter()
    for i, img in enumerate(celeba.synthetic_faces(DATA_JPEGS, DATA_JPEG_HW,
                                                   seed=3)):
        Image.fromarray(img).save(folder / f"{i:06d}.jpg", quality=95)
    write_s = time.perf_counter() - t0
    decoded, decode_s = [], []
    decode_one, decode_folder = celeba._decode_one, celeba._decode_folder

    def counting_one(*args):
        decoded.append(1)
        return decode_one(*args)

    def timed_folder(*args, **kwargs):
        t = time.perf_counter()
        out = decode_folder(*args, **kwargs)
        decode_s.append(time.perf_counter() - t)
        return out

    base = vaegan_config()
    stats = {"jpegs": DATA_JPEGS, "write_s": write_s, "runs": []}
    celeba._decode_one, celeba._decode_folder = counting_one, timed_folder
    try:
        for run in range(2):
            cfg = dataclasses.replace(
                base, data=dataclasses.replace(base.data, path=str(folder)),
                run=dataclasses.replace(base.run, out_dir=str(
                    OUT_DIR / f"vaegan_data{run}")), epochs=DATA_EPOCHS)
            shutil.rmtree(cfg.run.out_dir, ignore_errors=True)
            decoded.clear()
            decode_s.clear()
            res = L.run_vaegan(cfg, max_steps_per_epoch=DATA_STEPS,
                               device="cuda")
            ips = [row["images_per_sec"] for row in res["log"]]
            step_ms = [cfg.data.batch_size / v * 1e3 for v in ips]
            rate = len(decoded) / decode_s[0] if decoded else 0.0
            h, w = cfg.data.image_size
            print(f"[data] run {run + 1}: decoded {len(decoded)} JPEGs in "
                  f"{decode_s[0]:.3f} s ({rate:.1f} img/s); run_vaegan "
                  f"{h}x{w} B={cfg.data.batch_size} step ms by epoch "
                  + " ".join(f"{v:.3f}" for v in step_ms)
                  + f" (logged images/s, host work included)", flush=True)
            finite = all(np.isfinite(v) for row in res["log"]
                         for v in row.values())
            stats["runs"].append({"decoded": len(decoded),
                                  "decode_s": decode_s[0],
                                  "decode_img_per_s": rate,
                                  "step_ms": step_ms})
            want = DATA_JPEGS if run == 0 else 0
            if len(decoded) != want or not finite:
                failures.append(f"data run {run + 1}: decoded "
                                f"{len(decoded)}, want {want}")
    finally:
        celeba._decode_one, celeba._decode_folder = decode_one, decode_folder
    return stats


def export_path(K, failures):
    """The serving export and the data path (a)-(d); K3, K4 and K5 launches
    by request in ``launches``."""
    t0 = time.perf_counter()
    stats = {"ddpm": export_ddpm(K, failures),
             "glow": export_glow(K, failures),
             "vae": export_vae(K, failures),
             "data": data_path(K, failures)}
    stats["launches"] = {
        name: stats["ddpm"]["launches"].get(name, 0)
        + stats["glow"]["launches"].get(name, 0)
        for name in ("flash_attention", "groupnorm_silu",
                     "glow_coupling_fwd")}
    stats["phase_s"] = time.perf_counter() - t0
    print(f"[export] phase {stats['phase_s']:.1f} s", flush=True)
    return stats


# ---------------------------------------------------------------------------
# Data and sequence parallelism across processes, and Glow remat
# ---------------------------------------------------------------------------

# DDPM: 5 train batches of 16 (DP_STEPS run) and 11 val rows in one padded
# batch; VAE-GAN: 9 train batches of 64 (DP_VAEGAN_STEPS run), 64 val rows;
# Glow: DP_GLOW_ITERS iterations after the ActNorm init
DP_DATASET, DP_STEPS = 104, 5
DP_VAEGAN_DATASET, DP_VAEGAN_STEPS = 640, 2
DP_GLOW_DATASET, DP_GLOW_ITERS = 160, 2
# a spawn's limit (process start, kernel libraries, every job)
DP_TIMEOUT = 600
# sequence parallelism against the unsharded run: JAX's own bound for its
# ring (tests/test_tp_production.py)
SP_LOSS_REL = 1e-4
# a run that the card does not reproduce bit for bit is held to DP_SPREAD_X
# times its own run-to-run spread (or the step bound, if larger)
DP_SPREAD_X = 3.0
# the phase's device (a CPU rehearsal of its control flow sets "cpu")
DP_DEVICE = "cuda"
# remat against no remat: the same function in the same order, so any
# difference is the card's atomics (observed below 1e-9 on gradients of
# order 1e-2 to 1)
REMAT_GRAD_REL = 1e-6


def dp_dir(tag):
    return OUT_DIR / "dp" / tag


def dp_ddpm_config(tag, mesh=None):
    """``smoke_config`` on DP_DATASET faces, writing under dp/<tag>."""
    from vgd_tpu_torch.core.config import MeshConfig
    cfg = smoke_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset_size=DP_DATASET),
        run=dataclasses.replace(cfg.run, out_dir=str(dp_dir(tag)),
                                mesh=mesh or MeshConfig()))


def dp_vaegan_config(tag):
    cfg = vaegan_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data,
                                      dataset_size=DP_VAEGAN_DATASET),
        run=dataclasses.replace(cfg.run, out_dir=str(dp_dir(tag))))


def dp_glow_config(tag, **kw):
    """``glow_config`` with no sample grid inside the run (rank 0 alone
    draws one, which would make the ranks' launch counts differ)."""
    cfg = glow_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset_size=DP_GLOW_DATASET),
        run=dataclasses.replace(cfg.run, out_dir=str(dp_dir(tag)),
                                sample_every_iters=10 ** 6,
                                checkpoint_every_iters=10 ** 6), **kw)


def dp_ddpm_job(tag, mesh=None, steps=DP_STEPS, **kw):
    """A ``parallel.workers.train_loop`` job: ``run_diffusion`` for one
    epoch of ``steps`` steps on ``dp_ddpm_config(tag, mesh)``."""
    return dict(family="diffusion", device=DP_DEVICE, epochs=1,
                max_steps_per_epoch=steps, state=False,
                cfg=dp_ddpm_config(tag, mesh), epoch_scan=False, **kw)


def dp_jobs(x, t):
    """The two-rank jobs (``parallel.workers.train_loop``), by tag."""
    from vgd_tpu_torch.core.config import MeshConfig
    glow = dict(family="glow", device=DP_DEVICE, n_iter=DP_GLOW_ITERS,
                state=False)
    return {"ddpm-dp": dp_ddpm_job("ddpm-dp"),
            "ddpm-sp": dict(dp_ddpm_job("ddpm-sp", MeshConfig(
                data=1, model=2), forward={"x": x, "t": t}), state=True),
            "vaegan-dp": dict(family="vaegan", device=DP_DEVICE, epochs=1,
                              max_steps_per_epoch=DP_VAEGAN_STEPS,
                              cfg=dp_vaegan_config("vaegan-dp"),
                              state=False, epoch_scan=False),
            "glow-dp": dict(cfg=dp_glow_config("glow-dp"), **glow),
            "glow-stack-dp": dict(cfg=dp_glow_config(
                "glow-stack-dp", flow_stack=True), **glow)}


def step_losses(res):
    return [r["metrics"] for r in res["steps"]]


def loss_rel(got, ref, steps=None):
    """Largest relative difference of the per-step losses (the first
    ``steps`` steps)."""
    pairs = list(zip(step_losses(got), step_losses(ref)))[:steps]
    return max(abs(g[k] - r[k]) / max(abs(r[k]), 1e-12)
               for g, r in pairs for k in r)


def median_ms(res):
    ms = sorted(r["ms"] for r in res["steps"][1:]) or \
        [r["ms"] for r in res["steps"]]
    return ms[len(ms) // 2]


def check_ranks(tag, ranks, failures):
    """Both ranks bit-equal after every step and at the end."""
    fps = [[r["fingerprint"] for r in res["steps"]] for res in ranks]
    ok = all(f == fps[0] for f in fps) and len({res["fingerprint"] for res
                                                in ranks}) == 1
    if not ok:
        failures.append(f"{tag}: the ranks' parameters differ")
    return ok


def want_launches(tag, res, want, failures):
    got = {k: res["launches"].get(k, 0) for k in want}
    if got != want:
        failures.append(f"{tag}: launches {got} != {want}")
    return got


def dp_train_launches(sites, steps, forwards):
    """K2 launches of a DDPM run of ``steps`` train steps and
    ``forwards`` training-form forwards in all (validation included)."""
    return {"attention_fwd": sites * forwards,
            "attention_dq": sites * steps, "attention_dkv": sites * steps,
            "flash_attention": 0, **{k: 0 for k in K4_NAMES}}


def remat_path(K, failures):
    """(e) Glow at 64x64, B=16, K=32, L=4, width 512, with K5 and with the
    stock conv chain: one step's loss and gradients with and without
    ``remat`` from the same state and draws (bit-equal where the card
    repeats the step bit for bit, else within DP_SPREAD_X times its own
    spread), the K5 launches of a remat step (each flow's forward twice),
    and each form's train step timed with its peak memory over the state
    it keeps resident."""
    import torch
    from vgd_tpu_torch.train.glow import GlowTrainer
    cuda = DP_DEVICE == "cuda"
    out = {}
    for fused in (True, False):
        cfg = dp_glow_config("remat", fused_coupling=fused)
        gen = torch.Generator(device=DP_DEVICE).manual_seed(21)
        b, (h, w) = cfg.data.batch_size, cfg.data.image_size
        shape = (b, h, w, 3)
        batches = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                 device=DP_DEVICE, generator=gen)
                   for _ in range(2)]
        noises = [torch.rand(shape, device=DP_DEVICE, generator=gen)
                  for _ in range(2)]
        path = "k5" if fused else "stock"
        grads, rows = {}, {}
        for remat in (False, True):
            tr = GlowTrainer(dataclasses.replace(cfg, remat=remat),
                             (h, w, 3), device=DP_DEVICE)
            tr.init(torch.Generator(device=DP_DEVICE).manual_seed(3))
            tr.init_step(batches[0], noise=noises[0])
            runs = []
            for _ in range(1 if remat else 2):
                K.LAUNCHES.clear()
                loss, g = glow_step_grads(tr, batches[1], noises[1])
                runs.append((loss, {k: v.cpu() for k, v in g.items()}))
                del g
            launches = {k: K.LAUNCHES[k] for k in K5_NAMES}
            grads[remat] = runs
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            tr.train_step(batches[1], noise=noises[1])
            if cuda:
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            base = base if cuda else 0
            rows[remat] = {
                "peak_mem_gb": peak / 1e9,
                "step_peak_over_state_gb": (peak - base) / 1e9,
                "train_step_ms": cuda_ms(lambda: tr.train_step(
                    batches[1], noise=noises[1]), 1, 5),
                "fwd_bwd_launches": launches}
            del tr
            if cuda:
                torch.cuda.empty_cache()
        (l0, g0), (l0b, g0b) = grads[False]
        (l1, g1), = grads[True]
        spread = max(float((g0b[k] - g0[k]).abs().max()) for k in g0)
        err = max(float((g1[k] - g0[k]).abs().max()) for k in g0)
        gmax = max(float(g.abs().max()) for g in g0.values())
        same = spread == 0.0 and l0 == l0b
        # bit-equal, or within the step's own run-to-run spread (the card
        # adds its backward with atomics), and at most REMAT_GRAD_REL of
        # the largest gradient when one pair happens to show no spread
        ok = (err == 0.0 and l1 == l0) or \
            err <= max(DP_SPREAD_X * spread, REMAT_GRAD_REL * gmax)
        row = {"no_remat": rows[False], "remat": rows[True],
               "grad_max_abs_err": err, "no_remat_spread": spread,
               "grad_max": gmax,
               "loss": l1, "loss_no_remat": l0, "bit_reproducible": same}
        out[path] = row
        if not ok:
            failures.append(f"remat ({path}): gradients differ from no "
                            f"remat by {err} (the step's own spread "
                            f"{spread})")
        want = {"glow_coupling_fwd": 2 * K5_PER_STEP,
                "glow_coupling_bwd1": K5_PER_STEP,
                "glow_coupling_bwd2": K5_PER_STEP} if fused else \
            {k: 0 for k in K5_NAMES}
        if rows[True]["fwd_bwd_launches"] != want:
            failures.append(f"remat ({path}): K5 launches "
                            f"{rows[True]['fwd_bwd_launches']} != {want}")
        r, n = rows[True], rows[False]
        print(f"[remat] Glow {h}x{w} B={b} ({path}): gradients remat vs "
              f"none max abs {err:.3g} (the card's own spread "
              f"{spread:.3g}, bit-reproducible {same}); K5 a fwd+bwd "
              f"{r['fwd_bwd_launches']}; train step "
              f"{n['train_step_ms']:.2f} -> {r['train_step_ms']:.2f} ms, "
              f"peak memory {n['peak_mem_gb']:.3f} -> "
              f"{r['peak_mem_gb']:.3f} GB (over the resident state "
              f"{n['step_peak_over_state_gb']:.3f} -> "
              f"{r['step_peak_over_state_gb']:.3f} GB)", flush=True)
    return out


def dp_path(K, failures):
    """Data and sequence parallelism on the card (module docstring,
    step 14). The one-process references run in this process; the ranks
    are fresh processes (``parallel.launch.spawn``) that load the kernels
    this process built."""
    import torch
    from vgd_tpu_torch.parallel import workers
    from vgd_tpu_torch.parallel.launch import spawn
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    shutil.rmtree(OUT_DIR / "dp", ignore_errors=True)
    t_phase = time.perf_counter()
    sites = k2_sites(K)
    report = {}
    if DP_DEVICE == "cuda":
        # the rank processes share this card: hand back what the earlier
        # phases left in this process's cache
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        report["parent_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
        held = torch.cuda.memory_allocated() / 1e9
        print(f"[dp] this process keeps {report['parent_reserved_gb']:.3f} "
              f"GB reserved on the card ({held:.3f} GB allocated)",
              flush=True)
    gen = torch.Generator(device=DP_DEVICE).manual_seed(31)
    h, w = smoke_config().data.image_size
    x = torch.randn((2, h, w, 3), device=DP_DEVICE, generator=gen).cpu()
    t = torch.tensor([999, 17], dtype=torch.int32)

    # (a) no process group, twice, then NCCL at world size 1 (its process
    # warmed by one step of a throwaway run first)
    none = [workers.train_loop(**dp_ddpm_job(f"ddpm-none{i}"))
            for i in range(2)]
    nccl = spawn("vgd_tpu_torch.parallel.workers:train_loops", 1,
                 [dp_ddpm_job("ddpm-warm", steps=1),
                  dp_ddpm_job("ddpm-nccl")],
                 timeout=DP_TIMEOUT, log_dir=str(dp_dir("logs-nccl")))[0][1]
    fps = [[r["fingerprint"] for r in res["steps"]] for res in none]
    same = fps[0] == fps[1]
    # the first loss comes before any backward, which is where the card
    # adds with atomics
    first = [step_losses(r)[0] for r in (none[0], none[1], nccl)]
    spread = loss_rel(none[1], none[0])
    rel = loss_rel(nccl, none[0])
    nccl_fp = [r["fingerprint"] for r in nccl["steps"]]
    # bit-equal, or (the card rounding its atomics another way this time)
    # the first loss bit-equal and the rest within the run's own spread
    ok = nccl_fp == fps[0] or (
        (first[2] == first[0] or first[1] != first[0])
        and rel <= max(DP_SPREAD_X * spread, STEP_LOSS_REL))
    if not ok:
        failures.append(f"dp (a): NCCL world 1 vs no process group: "
                        f"bit-equal {nccl_fp == fps[0]}, first loss "
                        f"{first[2]} vs {first[0]}, loss rel {rel} (the "
                        f"card's own spread {spread})")
    evals = nccl["forwards"] - DP_STEPS
    la = want_launches("dp (a) NCCL", nccl, dp_train_launches(
        sites, DP_STEPS, DP_STEPS + evals), failures)
    report["nccl_world1"] = {
        "bit_reproducible": same, "bit_equal": nccl_fp == fps[0],
        "first_loss_equal": first[2] == first[0], "loss_rel": rel,
        "own_spread": spread, "launches": la,
        "step_ms": median_ms(nccl), "no_group_step_ms": median_ms(none[1])}
    print(f"[dp] (a) DDPM {h}x{w} B=16, NCCL world 1 vs no process group: "
          f"bit-equal {nccl_fp == fps[0]} (no group twice bit-equal {same};"
          f" first loss equal {first[2] == first[0]}; loss rel {rel:.3g}, "
          f"own spread {spread:.3g}); step ms "
          f"{report['nccl_world1']['step_ms']:.2f} vs "
          f"{report['nccl_world1']['no_group_step_ms']:.2f}; launches {la}",
          flush=True)

    # (b)-(d): two ranks on this card over gloo, each warmed by one step of
    # a throwaway DDPM run first
    if DP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    jobs = dp_jobs(x, t)
    t0 = time.perf_counter()
    ranks = spawn("vgd_tpu_torch.parallel.workers:train_loops", 2,
                  [dp_ddpm_job("ddpm-warm2", steps=1)] + list(jobs.values()),
                  timeout=DP_TIMEOUT, log_dir=str(dp_dir("logs-2")))
    report["two_rank_spawn_s"] = time.perf_counter() - t0
    res = {tag: [r[i + 1] for r in ranks] for i, tag in enumerate(jobs)}
    refs = {"vaegan-dp": workers.train_loop(
        family="vaegan", device=DP_DEVICE, epochs=1,
        max_steps_per_epoch=DP_VAEGAN_STEPS,
        cfg=dp_vaegan_config("vaegan-one"), state=False, epoch_scan=False),
        "glow-dp": workers.train_loop(
            family="glow", device=DP_DEVICE, n_iter=DP_GLOW_ITERS,
            cfg=dp_glow_config("glow-one"), state=False),
        "ddpm-dp": none[0], "ddpm-sp": none[0]}
    # the bf16 VAE-GAN's first step is chaotic (its D step's Adam update
    # and six BatchNorm backwards amplify roundings): its bound is also
    # VAEGAN_FLOOR_X times the median over FLOOR_SEEDS of the one-process
    # run against itself with K1's conv output perturbed by one f32 ulp
    plain_stats = K.conv_stats
    floors = []
    for seed in FLOOR_SEEDS:
        K.conv_stats = perturbed_by(plain_stats, seed)
        try:
            floors.append(loss_rel(workers.train_loop(
                family="vaegan", device=DP_DEVICE, epochs=1,
                max_steps_per_epoch=1, state=False, epoch_scan=False,
                cfg=dp_vaegan_config(f"vaegan-floor{seed}")),
                refs["vaegan-dp"], 1))
        finally:
            K.conv_stats = plain_stats
    floor = sorted(floors)[len(floors) // 2]
    report["vaegan_floor"] = {"per_seed": dict(zip(FLOOR_SEEDS, floors)),
                              "median": floor}
    bounds = {"ddpm-dp": STEP_LOSS_REL, "ddpm-sp": SP_LOSS_REL,
              "vaegan-dp": max(VAEGAN_LOSS_REL, VAEGAN_FLOOR_X * floor),
              "glow-dp": STEP_LOSS_REL}
    for tag, pair in res.items():
        row = {"ranks_bit_equal": check_ranks(f"dp {tag}", pair, failures),
               "step_ms_per_rank": [median_ms(p) for p in pair],
               "launches_per_rank": [p["launches"] for p in pair]}
        if tag in refs:
            # the first step: the same init and draws, the global batch's
            # statistics against one process's
            first = loss_rel(pair[0], refs[tag], 1)
            every = loss_rel(pair[0], refs[tag])
            bound = bounds[tag]
            row.update(first_step_loss_rel=first, loss_rel=every,
                       bound=bound, one_process_step_ms=median_ms(refs[tag]))
            if not first <= bound:
                failures.append(f"dp {tag}: first-step losses {first} from "
                                f"one process, bound {bound}")
        report[tag] = row
    sp = res["ddpm-sp"]
    for p in res["ddpm-dp"]:
        want_launches("dp (b) DDPM rank", p, dp_train_launches(
            sites, DP_STEPS, p["forwards"]), failures)
    for p in sp:
        want_launches("dp (c) SP rank", p, dp_train_launches(
            sites - 1, DP_STEPS, p["forwards"]), failures)
        want_launches("dp (c) SP fused forward", p["forward"], {
            "flash_attention": 2, "groupnorm_silu": 14,
            "groupnorm_silu_shift": K4_SHIFT_PER_FORWARD,
            "groupnorm_silu_bias": 14,
            "groupnorm_silu_residual_bias": K4_RESIDUAL_BIAS_PER_FORWARD,
            "attention_fwd": 0},
            failures)
    for p in res["vaegan-dp"]:
        want_launches("dp (b) VAE-GAN rank", p,
                      {"conv_bn_stats": K1_PER_STEP * DP_VAEGAN_STEPS},
                      failures)
    for p in res["glow-dp"]:
        want_launches("dp (d) Glow rank", p, {
            "glow_coupling_fwd": K5_PER_STEP * (DP_GLOW_ITERS + 1),
            "glow_coupling_bwd1": K5_PER_STEP * DP_GLOW_ITERS,
            "glow_coupling_bwd2": K5_PER_STEP * DP_GLOW_ITERS}, failures)
    for p in res["glow-stack-dp"]:
        want_launches("dp (d) Glow flow_stack rank", p, {
            "glow_flow_stack_fwd": K6_PER_STEP * DP_GLOW_ITERS,
            "glow_flow_stack_bwd": K6_PER_STEP * DP_GLOW_ITERS,
            "glow_coupling_fwd": K5_PER_STEP, "glow_coupling_bwd1": 0},
            failures)
    # (c) the SP run's sampling forward against one process's, same weights
    tr = DiffusionTrainer(dp_ddpm_config("ddpm-sp"), (h, w, 3),
                          device=DP_DEVICE)
    tr.model.load_state_dict({k: v.to(tr.device) for k, v in
                              sp[0]["state"].items()})
    with torch.inference_mode():
        one = tr.model_fused(x.to(tr.device), t.to(tr.device)).float().cpu()
    err = float((sp[0]["forward"]["out"] - one).abs().max())
    scale = float(one.abs().max())
    report["ddpm-sp"].update(forward_max_abs_err=err, forward_scale=scale,
                             forward_launches=sp[0]["forward"]["launches"])
    if not err <= UNET_REL_TOL * scale:
        failures.append(f"dp (c) SP fused forward vs one process: {err} > "
                        f"{UNET_REL_TOL} x {scale}")
    del tr
    if DP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    for tag, row in report.items():
        if isinstance(row, dict) and "ranks_bit_equal" in row:
            extra = (f"; first-step loss rel {row['first_step_loss_rel']:.3g}"
                     f" (bound {row['bound']:.3g}), every step "
                     f"{row['loss_rel']:.3g}; one-process step "
                     f"{row['one_process_step_ms']:.2f} ms"
                     if "bound" in row else "")
            print(f"[dp] {tag}: ranks bit-equal {row['ranks_bit_equal']}; "
                  f"step ms per rank "
                  f"{[round(v, 2) for v in row['step_ms_per_rank']]} (two "
                  f"ranks on one card over gloo: collective overhead, not "
                  f"scaling){extra}; launches rank 0 "
                  f"{row['launches_per_rank'][0]}", flush=True)
    print(f"[dp] (c) SP fused forward B=2 vs one process: max abs err "
          f"{err:.4g}, tol {UNET_REL_TOL} x {scale:.4g}; launches "
          f"{sp[0]['forward']['launches']}", flush=True)
    report["remat"] = remat_path(K, failures)
    report["launches"] = {
        name: sum(p["launches"].get(name, 0) for pair in res.values()
                  for p in pair) + nccl["launches"].get(name, 0)
        + sum(p["forward"]["launches"].get(name, 0) for p in sp)
        for name in ("attention_fwd", "attention_dq", "attention_dkv",
                     "flash_attention", "groupnorm_silu", "conv_bn_stats",
                     *K5_NAMES, *K6_NAMES)}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[dp] phase {report['phase_s']:.1f} s (two-rank spawn "
          f"{report['two_rank_spawn_s']:.1f} s); launches on its paths "
          f"{report['launches']}", flush=True)
    return report


# Glow's model parallelism: MP_ITERS iterations of each run, a sample grid
# at the last, on DP_GLOW_DATASET faces (the EEG run on its own trials)
MP_ITERS = 3
# the pipeline's microbatch shapes (B / pp_microbatches rows of each
# block): K5 against its plain versions there, checked, not timed
MP_K5_SHAPES = [(f"{site} microbatch", b // 2, h, w, cin, f, 0, "bfloat16")
                for site, b, h, w, cin, f, _ in K5_SHAPES]
# the f32 EEG run's first losses against one process's (its f32 convs sum
# the filters in another order under tensor parallelism)
MP_EEG_REL = 1e-4
# the bf16 runs' first losses are held as every bf16 step is: the f32
# bound, here the CPU tests' 1e-5 for a parallel run's losses, or
# DP_SPREAD_X times the median one-ulp floor, whichever is larger (the
# floor can be 0: a one-ulp change of every coupling output can vanish in
# the loss's own f32 rounding, as it did on the H100)
MP_LOSS_REL = 1e-5
# a model axis with a coupling kernel (the JAX loop's words)
MP_REFUSAL = "incompatible with --fused-coupling/--flow-stack"


def mp_dir(tag):
    return OUT_DIR / "mp" / tag


def mp_glow_config(tag, model=1, **kw):
    """``glow_config`` on DP_GLOW_DATASET faces on a data=1 x ``model``
    mesh, writing under mp/<tag>, its grid at iteration MP_ITERS."""
    from vgd_tpu_torch.core.config import MeshConfig
    cfg = glow_config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, dataset_size=DP_GLOW_DATASET),
        run=dataclasses.replace(cfg.run, out_dir=str(mp_dir(tag)),
                                sample_every_iters=MP_ITERS,
                                checkpoint_every_iters=10 ** 6,
                                mesh=MeshConfig(data=1, model=model)), **kw)


def mp_eeg_config(tag, model=1):
    from vgd_tpu_torch.core.config import MeshConfig
    cfg = eeg_config()
    return dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, out_dir=str(mp_dir(tag)), sample_every_iters=MP_ITERS,
        checkpoint_every_iters=10 ** 6,
        mesh=MeshConfig(data=1, model=model)))


def first_step_floor(cfg, ref):
    """The one-ulp floor of the first step's losses: ``run_glow(cfg)`` for
    one iteration in this process with every coupling output perturbed by
    one f32 ulp (``perturbed_by``, each seed of FLOOR_SEEDS), against the
    unperturbed run ``ref``; (median, per seed)."""
    from vgd_tpu_torch.models.glow import Glow
    from vgd_tpu_torch.parallel import workers
    plain = Glow._coupling_nn
    per = {}
    for seed in FLOOR_SEEDS:
        fn = perturbed_by(plain, seed)
        Glow._coupling_nn = lambda self, p, xa, fn=fn: fn(self, p, xa)
        tag = f"{Path(cfg.run.out_dir).name}-floor{seed}"
        try:
            res = workers.train_loop(
                family="glow", device=DP_DEVICE, n_iter=1, state=False,
                cfg=dataclasses.replace(cfg, run=dataclasses.replace(
                    cfg.run, out_dir=str(mp_dir(tag)))))
        finally:
            Glow._coupling_nn = plain
        shutil.rmtree(mp_dir(tag), ignore_errors=True)
        per[seed] = loss_rel(res, ref, 1)
    return sorted(per.values())[len(per) // 2], per


def mp_path(K, failures):
    """Glow's model parallelism on the card (module docstring, step 15):
    two rank processes on this card over gloo; the one-process references
    and the floors run in this process."""
    import torch
    from vgd_tpu_torch.parallel import workers
    from vgd_tpu_torch.parallel.launch import spawn
    from vgd_tpu_torch.parallel.mesh import Mesh
    from vgd_tpu_torch.train import loop as L
    shutil.rmtree(OUT_DIR / "mp", ignore_errors=True)
    t_phase = time.perf_counter()
    report = {}
    if DP_DEVICE == "cuda":
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    dev = torch.device(DP_DEVICE)
    k5 = check_k5(K, torch.Generator(device=dev).manual_seed(15), dev,
                  failures, shapes=MP_K5_SHAPES)
    report["k5_microbatch"] = k5
    jobs = {
        "pp": dict(family="glow", cfg=mp_glow_config("pp", 2, pp_stages=2)),
        "tp": dict(family="glow", cfg=mp_glow_config(
            "tp", 2, fused_coupling=False)),
        "eeg-tp": dict(family="glow-eeg", cfg=mp_eeg_config("eeg-tp", 2))}
    common = dict(device=DP_DEVICE, n_iter=MP_ITERS, state=False)
    t0 = time.perf_counter()
    ranks = spawn("vgd_tpu_torch.parallel.workers:train_loops", 2,
                  [dict(job, **common) for job in jobs.values()],
                  timeout=DP_TIMEOUT, log_dir=str(mp_dir("logs")))
    report["two_rank_spawn_s"] = time.perf_counter() - t0
    res = {tag: [r[i] for r in ranks] for i, tag in enumerate(jobs)}
    refs = {"pp": mp_glow_config("pp-one"),
            "tp": mp_glow_config("tp-one", fused_coupling=False),
            "eeg-tp": mp_eeg_config("eeg-one")}
    refs = {tag: workers.train_loop(
        family=jobs[tag]["family"], cfg=cfg, **common)
        for tag, cfg in refs.items()}
    floors = {tag: first_step_floor(mp_glow_config(f"{tag}-one", **kw),
                                    refs[tag])
              for tag, kw in (("pp", {}), ("tp", {"fused_coupling": False}))}
    # K5 on the pipeline's path: each step's forward and both backwards of
    # L (K / p) M flows a rank, the ActNorm init's forward of all L K flows
    # on every rank, and rank 0's sample grid; none on the other runs
    want = {"pp": lambda r: {
        "glow_coupling_fwd": K5_PER_STEP * (MP_ITERS + 1 + (r == 0)),
        "glow_coupling_bwd1": K5_PER_STEP * MP_ITERS,
        "glow_coupling_bwd2": K5_PER_STEP * MP_ITERS,
        **{name: 0 for name in K6_NAMES}}}
    for tag, pair in res.items():
        ref = refs[tag]
        first = loss_rel(pair[0], ref, 1)
        if tag in floors:
            floor, per_seed = floors[tag]
            bound = max(MP_LOSS_REL, DP_SPREAD_X * floor)
        else:
            floor, per_seed, bound = None, None, MP_EEG_REL
        row = {"ranks_bit_equal": check_ranks(f"mp {tag}", pair, failures),
               "step_ms_per_rank": [median_ms(p) for p in pair],
               "one_process_step_ms": median_ms(ref),
               "peak_mem_gb_per_rank": [p.get("peak_mem_gb") for p in pair],
               "one_process_peak_mem_gb": ref.get("peak_mem_gb"),
               "first_step_loss_rel": first, "loss_rel": loss_rel(pair[0],
                                                                  ref),
               "floor": floor, "floor_per_seed": per_seed, "bound": bound,
               "launches_per_rank": [p["launches"] for p in pair],
               "conv1_filters_per_rank": [
                   p["local_shapes"]["block0.flows.coupling.conv1.w"][-1]
                   for p in pair]}
        if not first <= bound:
            failures.append(f"mp {tag}: first-step losses {first} from one "
                            f"process, bound {bound}")
        for r, p in enumerate(pair):
            got = want.get(tag, lambda r: {n: 0 for n in GLOW_NAMES})(r)
            want_launches(f"mp {tag} rank {r}", p, got, failures)
        filters = row["conv1_filters_per_rank"]
        full = ref["local_shapes"]["block0.flows.coupling.conv1.w"][-1]
        if filters != [full if tag == "pp" else full // 2] * 2:
            failures.append(f"mp {tag}: conv1 filters per rank {filters}")
        report[tag] = row
        print(f"[mp] {tag}: ranks bit-equal {row['ranks_bit_equal']}; step "
              f"ms per rank {[round(v, 2) for v in row['step_ms_per_rank']]}"
              f" vs one process {row['one_process_step_ms']:.2f} (two ranks "
              f"on one card over gloo: collective overhead, not scaling); "
              f"peak GB per rank {row['peak_mem_gb_per_rank']} vs "
              f"{row['one_process_peak_mem_gb']}; first-step loss rel "
              f"{first:.3g} (bound {bound:.3g}"
              + (f": {MP_LOSS_REL:g} or {DP_SPREAD_X} x the median one-ulp "
                 f"floor {floor:.3g}, per seed {per_seed}"
                 if floor is not None else "")
              + f"), every step {row['loss_rel']:.3g}; conv1 filters per "
              f"rank {filters}; launches rank 0 {row['launches_per_rank'][0]}",
              flush=True)
    # (d) the refusals, before any training
    real = L.build_mesh
    L.build_mesh = lambda data, model: Mesh(1, 2)
    try:
        for flag, kw in (("fused_coupling", {}),
                         ("flow_stack", {"fused_coupling": False,
                                         "flow_stack": True})):
            try:
                L.run_glow(mp_glow_config(f"refuse-{flag}", 2, **kw),
                           device=DP_DEVICE)
                failures.append(f"mp (d): a model axis with {flag} ran")
            except ValueError as e:
                if MP_REFUSAL not in str(e):
                    failures.append(f"mp (d) {flag}: {e}")
                report[f"refusal_{flag}"] = str(e)
    finally:
        L.build_mesh = real
    print(f"[mp] (d) a model axis with --fused-coupling / --flow-stack "
          f"refused: {report.get('refusal_fused_coupling', '')!r}",
          flush=True)
    report["launches"] = {name: sum(p["launches"].get(name, 0)
                                    for pair in res.values() for p in pair)
                          for name in GLOW_NAMES}
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[mp] phase {report['phase_s']:.1f} s (two-rank spawn "
          f"{report['two_rank_spawn_s']:.1f} s); launches on its paths "
          f"{report['launches']}", flush=True)
    return report


# ---------------------------------------------------------------------------
# The command line: the documented commands through cli.main, as typed
# ---------------------------------------------------------------------------

CLI_DIR = OUT_DIR / "cli"
# synthetic faces each command trains on (90 % train, 10 % val): the
# VAE-GAN at its default 64x64, B=64 (288 train rows: CLI_STEPS full
# batches), DDPM at 256x256, B=16 (72), Glow's stream at 64x64, B=16, the
# VAE at B=64 and the GANs at B=128 (2 full batches each)
CLI_VAEGAN_SIZE, CLI_DDPM_SIZE, CLI_GLOW_SIZE = 320, 80, 160
CLI_VAE_SIZE, CLI_GAN_SIZE = 160, 320
# train steps of the two new configurations' runs, and of the others'
CLI_STEPS, CLI_SHORT = 4, 2
# Glow: 4 iterations with a grid and a checkpoint every 2, then a resume
# to 6; the JAX argv's run
CLI_GLOW_ITERS, CLI_GLOW_RESUMED, CLI_GLOW_EVERY = 4, 6, 2
CLI_GLOW_JAX_ITERS = 2
# per fused UNet forward: K3 at the three attention sites (cross_attn2,
# cross_attn3, the bottleneck; none without attention, as JAX's
# attention=False builds none), K4 at gn1 and gn2 of each of the seven
# ConvBlocks (down1-3, the bottleneck, up3-1), with or without attention
CLI_K3_PER_FORWARD = {True: 3, False: 0}
CLI_K4_PER_FORWARD = 2 * 7
CLI_DDIM_STEPS, CLI_SAMPLES = 50, 16
CLI_SEED = 13


def cli_serving_want(forwards, attention):
    """Launches of ``forwards`` fused UNet forwards."""
    want = {"flash_attention": CLI_K3_PER_FORWARD[attention] * forwards,
            "groupnorm_silu": CLI_K4_PER_FORWARD * forwards,
            "groupnorm_silu_shift": K4_SHIFT_PER_FORWARD * forwards,
            "groupnorm_silu_bias": CLI_K4_PER_FORWARD * forwards,
            "groupnorm_silu_residual_bias":
                K4_RESIDUAL_BIAS_PER_FORWARD * forwards}
    return {k: v for k, v in want.items() if v}


def trainer_state(trainer):
    """Copies of a trainer's parameters and buffers and of every Adam
    state."""
    import torch
    params = (trainer.state_dict() if hasattr(trainer, "state_dict")
              else trainer.model.state_dict())
    return ({k: v.detach().clone() for k, v in params.items()},
            {name: {i: {x: t.clone() for x, t in st.items()
                        if torch.is_tensor(t)}
                    for i, st in sd["state"].items()}
             for name, sd in opt_states(trainer).items()})


def same_state(a, b):
    import torch
    (pa, oa), (pb, ob) = a, b
    return (pa.keys() == pb.keys()
            and all(torch.equal(pa[k], pb[k]) for k in pa)
            and oa.keys() == ob.keys()
            and all(oa[n].keys() == ob[n].keys() and all(
                oa[n][i].keys() == ob[n][i].keys()
                and all(torch.equal(oa[n][i][x], ob[n][i][x])
                        for x in oa[n][i]) for i in oa[n]) for n in oa))


def cli_hooks(K, rec):
    """Wraps what the commands call, for the phase: each trainer's train
    step (its launches and CUDA-event time; the first one after
    ``rec["expect"]`` is set compares the trainer's state with it, under
    ``rec["resumed_exact"]``), Glow's init step and reverse, the DDPM
    validation loss and UNet forward (counted under ``rec["calls"]``,
    fused forwards apart), and the loop's ``run_*`` (the config and result
    kept). Returns the list of (owner, name, original or None: delete) to
    restore."""
    import torch
    from vgd_tpu_torch.models.unet import UNet
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    from vgd_tpu_torch.train.gan import GANTrainer
    from vgd_tpu_torch.train.glow import GlowEEGTrainer, GlowTrainer
    from vgd_tpu_torch.train.vae import VAETrainer
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    undo = []

    def patch(owner, name, make):
        # each concrete class is wrapped: an earlier phase may have left a
        # method in a subclass's own dict that would hide its base's wrapper
        orig = getattr(owner, name)
        undo.append((owner, name, orig if name in vars(owner) else None))
        setattr(owner, name, make(orig))

    def step(orig):
        def wrapped(self, *args, **kwargs):
            if rec.get("expect") is not None:
                rec["resumed_exact"] = same_state(trainer_state(self),
                                                  rec.pop("expect"))
            before = K.LAUNCHES.copy()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(self, *args, **kwargs)
            end.record()
            rec["steps"].append((K.LAUNCHES - before, start, end))
            return out
        return wrapped

    def counted(key):
        def make(orig):
            def wrapped(self, *args, **kwargs):
                rec["calls"][key(self)] += 1
                return orig(self, *args, **kwargs)
            return wrapped
        return make

    def kept(orig):
        def wrapped(cfg, *args, **kwargs):
            res = orig(cfg, *args, **kwargs)
            rec["cfg"], rec["result"] = cfg, res
            return res
        return wrapped

    for cls, name in ((VAEGANTrainer, "train_step"),
                      (VAETrainer, "train_step"), (GANTrainer, "train_step"),
                      (GANTrainer, "train_step_wgan"),
                      (DiffusionTrainer, "train_step"),
                      (GlowTrainer, "train_step"),
                      (GlowEEGTrainer, "train_step")):
        patch(cls, name, step)
    patch(UNet, "forward", counted(
        lambda m: "fused_forward" if m.down1.gn1.fused else "forward"))
    patch(DiffusionTrainer, "eval_loss", counted(lambda _: "eval_loss"))
    for cls in (GlowTrainer, GlowEEGTrainer):
        patch(cls, "init_step", counted(lambda _: "init_step"))
        patch(cls, "reverse", counted(lambda _: "reverse"))
    for name in ("run_vaegan", "run_vae", "run_gan", "run_glow",
                 "run_glow_eeg", "run_diffusion"):
        patch(L, name, kept)
    return undo


def cli_run(K, rec, tag, argv, failures, want=None, step_want=None,
            steps=None):
    """``cli.main(argv)`` as a user types it, its output captured: a
    SystemExit or an exception is a failure. Checks its launches against
    ``want`` (a dict, or a function of the counted calls; every kernel not
    named must launch 0 times), each train step's against ``step_want``
    and the number of train steps against ``steps``. Prints one ``[cli]``
    line: argv, rc, seconds, the steps' CUDA-event median after the first
    and its images/s, the loop's logged rate, launches and peak memory."""
    import collections
    import contextlib
    import io
    import torch
    from vgd_tpu_torch import cli
    argv = [str(x) for x in argv]
    rec.update(steps=[], calls=collections.Counter(), cfg=None, result=None)
    K.LAUNCHES.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
    except SystemExit as e:
        rc = f"SystemExit({e.code!r})"
    except Exception:                      # noqa: BLE001 - a failed command
        rc = "exception: " + traceback.format_exc().strip().splitlines()[-1]
        traceback.print_exc()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    step_ms = [s.elapsed_time(e) for _, s, e in rec["steps"]]
    stats = {"tag": tag, "argv": argv, "rc": rc, "seconds": secs,
             "launches": launches, "steps": len(step_ms), "step_ms": step_ms,
             "calls": dict(rec["calls"]), "last_line": lines[-1] if lines
             else "", "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "allocated_before_gb": base / 1e9}
    text = f"[cli] {' '.join(argv)} rc {rc} {secs:.2f} s"
    if len(step_ms) > 1:
        cfg = rec["cfg"]
        batch = cfg.data.batch_size if hasattr(cfg, "data") else \
            cfg.batch_size
        after = sorted(step_ms[1:])
        stats.update(step_ms_median=after[len(after) // 2],
                     images_per_sec=batch / after[len(after) // 2] * 1e3)
        text += (f"; {len(step_ms)} train steps, step ms median "
                 f"{stats['step_ms_median']:.3f} after the first (min "
                 f"{after[0]:.3f}, max {after[-1]:.3f}) = "
                 f"{stats['images_per_sec']:.1f} "
                 f"{'images' if hasattr(cfg, 'data') else 'trials'}/s")
    log = (rec["result"] or {}).get("log") or []
    rate = [k for k in ("images_per_sec", "trials_per_sec")
            if log and k in log[-1]]
    if rate:
        stats["logged_rate"] = log[-1][rate[0]]
        text += f", the loop's log {stats['logged_rate']:.1f} {rate[0]}"
    print(text + f"; launches {launches}; peak {stats['peak_gb']:.3f} GB "
          f"({stats['allocated_before_gb']:.3f} GB allocated before)",
          flush=True)
    if rc != 0:
        print("\n".join(lines[-20:]), flush=True)
        failures.append(f"cli {tag}: {' '.join(argv)} ended with {rc}")
        return stats
    if callable(want):
        want = want(rec["calls"])
    if want is not None and any(launches.get(k, 0) != want.get(k, 0)
                                for k in set(want) | set(launches)):
        failures.append(f"cli {tag}: launches {launches}, want {want}")
    if step_want is not None:
        bad = [dict(c) for c, _, _ in rec["steps"] if dict(c) != step_want]
        if bad:
            failures.append(f"cli {tag}: train steps launched {bad[:3]}, "
                            f"want {step_want} each")
    if steps is not None and len(step_ms) != steps:
        failures.append(f"cli {tag}: {len(step_ms)} train steps, want "
                        f"{steps}")
    return stats


def cli_json(stats, failures):
    """The JSON result an evaluation command prints last (None if it
    printed none)."""
    try:
        return json.loads(stats["last_line"])
    except ValueError:
        failures.append(f"cli {stats['tag']}: no JSON result: "
                        f"{stats['last_line']!r}")
        return None


def cli_resume_check(rec, tag, failures):
    exact = rec.pop("resumed_exact", None)
    print(f"[cli] {tag}: the resumed run's first step started from the "
          f"saved state exactly: {exact}", flush=True)
    if exact is not True:
        failures.append(f"cli {tag}: the resume did not continue from the "
                        f"saved state ({exact})")


def cli_path(K, failures):
    """The cli phase: the port's commands through ``cli.main`` as a user
    types them, on synthetic faces and trials, at full model width with
    ``--device cuda`` (only steps, --dataset-size and -n small): (1) the
    VAE-GAN at its default 64x64, B=64 with --fused-conv (K1
    K1_VAEGAN64_PER_STEP a step), resumed, sampled, and without the flag
    (no K1); (2) DDPM --no-attn (no K2 in training; serving no K3 and
    CLI_K4_PER_FORWARD K4 a forward; the fused forward against no kernel);
    (3) Glow as the README has it (K5), resumed, sampled at temperature 0.5
    (bit-equal to ``sample_from_dir`` at 0.5, unlike 0.7), evaluated, and
    the JAX argv ``glow --epochs 1 --steps-per-epoch 3 --iters 2``; (4)
    EEG Glow; (5) the default DDPM (K2, K3, K4), VAE, DCGAN and WGAN with
    kernels off, sampled and evaluated, ``denoise`` on a folder of JPEGs,
    ``export`` and ``infer``."""
    import collections
    import numpy as np
    import torch
    from PIL import Image
    from vgd_tpu_torch.core.config import DiffusionConfig
    from vgd_tpu_torch.data.celeba import synthetic_faces
    from vgd_tpu_torch.models.unet import (AttentionBlock,
                                           CrossAttentionToGlobalTokens,
                                           GroupNormSiLU)
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import ddim_timesteps
    t_phase = time.perf_counter()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir(parents=True)
    rec, total = {}, collections.Counter()
    stats = {"commands": []}

    def run(tag, argv, **kw):
        s = cli_run(K, rec, tag, list(argv) + ["--device", "cuda"], failures,
                    **kw)
        total.update(s["launches"])
        stats["commands"].append(s)
        return s

    def images(path, shape, tag):
        check_images(np.load(path), shape, f"cli {tag}", failures)

    undo = cli_hooks(K, rec)
    try:
        # (1) the VAE-GAN at its default 64x64, batch 64
        d = CLI_DIR / "vaegan64"
        data = ["--out-dir", d, "--dataset-size", CLI_VAEGAN_SIZE]
        k1 = {"conv_bn_stats": K1_VAEGAN64_PER_STEP}
        k1_run = {"conv_bn_stats": K1_VAEGAN64_PER_STEP * CLI_STEPS}
        s = run("vaegan64", ["vaegan", "--fused-conv", "--epochs", 1,
                             "--steps-per-epoch", CLI_STEPS,
                             "--no-epoch-scan"] + data,
                want=k1_run, step_want=k1, steps=CLI_STEPS)
        if s["rc"] == 0:
            row = rec["result"]["log"][-1]
            if not all(math.isfinite(row[k]) for k in ("val_loss", "ssim",
                                                        "psnr")):
                failures.append(f"cli vaegan64: validation {row}")
            rec["expect"] = trainer_state(rec["result"]["trainer"])
        stats["vaegan64"] = s
        s = run("vaegan64-resume", ["vaegan", "--fused-conv", "--epochs", 2,
                                    "--steps-per-epoch", CLI_STEPS,
                                    "--resume", "--no-epoch-scan"] + data,
                want=k1_run, step_want=k1, steps=CLI_STEPS)
        cli_resume_check(rec, "vaegan64-resume", failures)
        if s["rc"] == 0 and (rec["result"]["trainer"].step != 2 * CLI_STEPS
                             or int(rec["result"]["log"][-1]["epoch"]) != 1):
            failures.append(f"cli vaegan64-resume: step "
                            f"{rec['result']['trainer'].step}, log "
                            f"{rec['result']['log']}")
        stats["vaegan64_resume"] = s
        run("vaegan64-sample", ["sample", "--family", "vaegan", "-n", 64,
                                "--out-dir", d], want={})
        images(d / "vaegan_samples.npy", (64, 64, 64, 3), "vaegan64-sample")
        stats["vaegan64_default"] = run(
            "vaegan64-default", ["vaegan", "--epochs", 1, "--steps-per-epoch",
                                 CLI_STEPS, "--no-epoch-scan", "--out-dir",
                                 CLI_DIR / "vaegan64_default",
                                 "--dataset-size", CLI_VAEGAN_SIZE],
            want={}, step_want={}, steps=CLI_STEPS)
        rec["result"] = None

        # (2) DDPM without attention
        d = CLI_DIR / "ddpm_noattn"
        data = ["--no-attn", "--out-dir", d, "--dataset-size", CLI_DDPM_SIZE]
        stats["ddpm_noattn"] = run(
            "ddpm-noattn", ["diffusion", "--epochs", 1, "--steps-per-epoch",
                            CLI_STEPS, "--no-epoch-scan"] + data, want={},
            step_want={},
            steps=CLI_STEPS)
        cfg = rec["cfg"]
        rec["result"] = None
        if stats["ddpm_noattn"]["rc"] == 0:
            trainer = L.restore_trainer(cfg, device="cuda")
            mods = collections.Counter(type(m).__name__ for m in
                                       trainer.model_fused.modules())
            if (mods[GroupNormSiLU.__name__] != CLI_K4_PER_FORWARD
                    or mods[AttentionBlock.__name__]
                    or mods[CrossAttentionToGlobalTokens.__name__]):
                failures.append(f"cli ddpm-noattn: the UNet holds {mods}")
            stats["unet_noattn"] = hold_unet(
                K, trainer, torch.Generator(device="cuda").manual_seed(
                    CLI_SEED), failures, tag="cli-unet-noattn")
            del trainer
        forwards = len(ddim_timesteps(DiffusionConfig().timesteps,
                                      CLI_DDIM_STEPS))
        s = run("ddpm-noattn-sample", ["sample", "--family", "diffusion",
                                       "--no-attn", "-n", CLI_SAMPLES,
                                       "--ddim-steps", CLI_DDIM_STEPS,
                                       "--out-dir", d],
                want=cli_serving_want(forwards, False))
        if s["calls"].get("fused_forward") != forwards:
            failures.append(f"cli ddpm-noattn-sample: {s['calls']} forwards,"
                            f" want {forwards}")
        images(d / "diffusion_samples.npy", (CLI_SAMPLES, 256, 256, 3),
               "ddpm-noattn-sample")
        stats["ddpm_noattn_sample"] = s
        s = run("ddpm-noattn-eval", ["eval-diffusion", "--max-batches", 1]
                + data, want=lambda c: cli_serving_want(
                    c["fused_forward"], False))
        res = cli_json(s, failures) if s["rc"] == 0 else None
        if res is not None and not math.isfinite(res["psnr"]):
            failures.append(f"cli ddpm-noattn-eval: {res}")

        # (3) Glow as the README has it, K5 in every coupling
        d = CLI_DIR / "glow"
        data = ["--fused-coupling", "--out-dir", d, "--dataset-size",
                CLI_GLOW_SIZE]
        every = ["--sample-every", CLI_GLOW_EVERY, "--checkpoint-every",
                 CLI_GLOW_EVERY]
        k5 = {n: K5_PER_STEP for n in K5_NAMES}

        def k5_want(iters, inits, reverses):
            return {"glow_coupling_fwd": K5_PER_STEP * (iters + inits
                                                         + reverses),
                    "glow_coupling_bwd1": K5_PER_STEP * iters,
                    "glow_coupling_bwd2": K5_PER_STEP * iters}
        s = run("glow", ["glow", "--iters", CLI_GLOW_ITERS] + every + data,
                want=k5_want(CLI_GLOW_ITERS, 1,
                             CLI_GLOW_ITERS // CLI_GLOW_EVERY),
                step_want=k5, steps=CLI_GLOW_ITERS)
        glow_cfg = rec["cfg"]
        if s["rc"] == 0:
            rec["expect"] = trainer_state(rec["result"]["trainer"])
        rec["result"] = None
        stats["glow"] = s
        more = CLI_GLOW_RESUMED - CLI_GLOW_ITERS
        stats["glow_resume"] = run(
            "glow-resume", ["glow", "--iters", CLI_GLOW_RESUMED, "--resume"]
            + every + data, want=k5_want(more, 0, more // CLI_GLOW_EVERY),
            step_want=k5, steps=more)
        cli_resume_check(rec, "glow-resume", failures)
        rec["result"] = None
        grids = {}
        for t in (0.5, None):
            out = d / f"cli_grid_{t or 'default'}.npy"
            run(f"glow-sample-{t or 'default'}",
                ["sample", "--family", "glow", "-n", 20, "--fused-coupling",
                 "--out-dir", d, "--out", out]
                + (["--temperature", t] if t else []),
                want=k5_want(0, 0, 1))
            grids[t] = np.load(out)
            # a few iterations' reverse is not bounded to [-1, 1]
            if not (grids[t].shape == (20, 64, 64, 3)
                    and np.isfinite(grids[t]).all()):
                failures.append(f"cli glow-sample {t}: {grids[t].shape}")
        ref = np.load(L.sample_from_dir(
            "glow", dataclasses.replace(glow_cfg, temperature=0.5), n=20,
            out_path=str(d / "ref_grid_0.5.npy"), device="cuda"))
        same = np.array_equal(grids[0.5], ref)
        differ = not np.array_equal(grids[None], ref)
        print(f"[cli] glow sample --temperature 0.5 bit-equal to "
              f"sample_from_dir at 0.5: {same}; differs from the default "
              f"0.7 grid: {differ}", flush=True)
        if not (same and differ):
            failures.append(f"cli glow-sample: bit-equal {same}, differs "
                            f"from 0.7 {differ}")
        s = run("glow-eval", ["eval-glow", "--max-batches", 1] + data,
                want=k5_want(0, 0, 1))
        res = cli_json(s, failures) if s["rc"] == 0 else None
        if res is not None and not 0 < res["ssim"] <= 1:
            failures.append(f"cli glow-eval: {res}")
        run("glow-jax-argv", ["glow", "--epochs", 1, "--steps-per-epoch", 3,
                              "--iters", CLI_GLOW_JAX_ITERS, "--out-dir",
                              CLI_DIR / "glow_stock", "--dataset-size",
                              CLI_GLOW_SIZE],
            want={}, steps=CLI_GLOW_JAX_ITERS)
        rec["result"] = None

        # (4) EEG Glow (f32, no kernel)
        d = CLI_DIR / "eeg"
        run("eeg", ["glow-eeg", "--iters", CLI_STEPS, "--event-type", "mi",
                    "--out-dir", d], want={}, steps=CLI_STEPS)
        rec["result"] = None
        run("eeg-sample", ["sample", "--family", "glow-eeg", "--temperature",
                           0.5, "-n", CLI_SAMPLES, "--event-type", "mi",
                           "--out-dir", d], want={})
        trials = np.load(d / "glow-eeg_samples.npy")
        if not (trials.shape == (CLI_SAMPLES, 22, 160)
                and np.isfinite(trials).all()):
            failures.append(f"cli eeg-sample: {trials.shape}")
        s = run("eeg-eval", ["eval-eeg", "--event-type", "mi", "--out-dir",
                             d], want={})
        res = cli_json(s, failures) if s["rc"] == 0 else None
        if res is not None and not os.path.exists(res["psd_npz"]):
            failures.append(f"cli eeg-eval: {res}")

        # (5) the default DDPM (attention), VAE, DCGAN and WGAN
        d = CLI_DIR / "ddpm"
        data = ["--out-dir", d, "--dataset-size", CLI_DDPM_SIZE]
        sites = k2_sites(K)
        run("ddpm", ["diffusion", "--epochs", 1, "--steps-per-epoch",
                     CLI_SHORT, "--no-epoch-scan"] + data,
            want=lambda c: {"attention_fwd": sites * (CLI_SHORT
                                                      + c["eval_loss"]),
                            "attention_dq": sites * CLI_SHORT,
                            "attention_dkv": sites * CLI_SHORT},
            step_want={k: sites for k in K2_NAMES}, steps=CLI_SHORT)
        rec["result"] = None
        s = run("ddpm-sample", ["sample", "--family", "diffusion", "-n",
                                CLI_SAMPLES, "--ddim-steps", CLI_DDIM_STEPS,
                                "--out-dir", d],
                want=cli_serving_want(forwards, True))
        images(d / "diffusion_samples.npy", (CLI_SAMPLES, 256, 256, 3),
               "ddpm-sample")
        stats["ddpm_sample"] = s
        s = run("ddpm-eval", ["eval-diffusion", "--max-batches", 1] + data,
                want=lambda c: cli_serving_want(c["fused_forward"], True))
        res = cli_json(s, failures) if s["rc"] == 0 else None
        if res is not None and not math.isfinite(res["psnr"]):
            failures.append(f"cli ddpm-eval: {res}")

        d = CLI_DIR / "vae"
        data = ["--out-dir", d, "--dataset-size", CLI_VAE_SIZE]
        run("vae", ["vae", "--epochs", 1, "--steps-per-epoch", CLI_SHORT]
            + data, want={}, step_want={}, steps=CLI_SHORT)
        rec["result"] = None
        run("vae-sample", ["sample", "--family", "vae", "-n", 64,
                           "--out-dir", d], want={})
        images(d / "vae_samples.npy", (64, 64, 64, 3), "vae-sample")
        s = run("vae-eval", ["eval-vae", "--max-batches", 1,
                             "--max-checkpoints", 1] + data, want={})
        res = cli_json(s, failures) if s["rc"] == 0 else None
        if res is not None and [r["step"] for r in res["sweep"]] != [1]:
            failures.append(f"cli vae-eval: {res}")
        faces = CLI_DIR / "denoise_in"
        faces.mkdir()
        for i, img in enumerate(synthetic_faces(4, (64, 64), seed=CLI_SEED)):
            Image.fromarray(img).save(faces / f"{i:06d}.jpg", quality=95)
        (CLI_DIR / "denoise_out").mkdir()
        run("vae-denoise", ["denoise", "--ckpt", d / "ckpt", "--input",
                            faces, "--output",
                            CLI_DIR / "denoise_out" / "out.png"], want={})
        written = sorted(os.listdir(CLI_DIR / "denoise_out"))
        if written != [f"denoised_{i:06d}.jpg" for i in range(4)]:
            failures.append(f"cli vae-denoise: wrote {written}")
        artifact = d / "serving_vae_denoise.pt2"
        run("vae-export", ["export", "--family", "vae", "--mode", "denoise",
                           "--poly-batch", "--out-dir", d], want={})
        run("vae-infer", ["infer", "--artifact", artifact, "--input",
                          faces / "000000.jpg", "--out",
                          CLI_DIR / "infer_out.jpg"], want={})
        if not (CLI_DIR / "infer_out.jpg").exists():
            failures.append("cli vae-infer: no grid written")

        for cmd in ("gan", "wgan"):
            d = CLI_DIR / cmd
            data = ["--out-dir", d, "--dataset-size", CLI_GAN_SIZE]
            run(cmd, [cmd, "--epochs", 1, "--steps-per-epoch", CLI_SHORT]
                + data, want={}, step_want={}, steps=CLI_SHORT)
            rec["result"] = None
            run(f"{cmd}-sample", ["sample", "--family", cmd, "-n", 64,
                                  "--out-dir", d], want={})
            images(d / f"{cmd}_samples.npy", (64, 64, 64, 3),
                   f"{cmd}-sample")
            s = run(f"{cmd}-eval", ["eval-gan", "--max-batches", 1]
                    + (["--wgan"] if cmd == "wgan" else []) + data, want={})
            res = cli_json(s, failures) if s["rc"] == 0 else None
            if res is not None and [r["step"] for r in res] != [1]:
                failures.append(f"cli {cmd}-eval: {res}")
    finally:
        for owner, name, orig in reversed(undo):
            if orig is None:
                delattr(owner, name)
            else:
                setattr(owner, name, orig)
        rec.clear()
    stats["launches"] = dict(total)
    stats["phase_s"] = time.perf_counter() - t_phase
    for tag in ("vaegan64", "vaegan64_default", "ddpm_noattn"):
        s = stats.get(tag, {})
        print(f"[cli] {tag}: step ms median {s.get('step_ms_median')}, "
              f"images/s {s.get('images_per_sec')}, peak memory "
              f"{s.get('peak_gb')} GB", flush=True)
    s = stats.get("ddpm_noattn_sample", {})
    print(f"[cli] ddpm-noattn DDIM-{CLI_DDIM_STEPS} request ({CLI_SAMPLES} "
          f"images, checkpoint restore included) {s.get('seconds')} s: "
          f"{s.get('last_line')}", flush=True)
    print(f"[cli] phase {stats['phase_s']:.1f} s, {len(stats['commands'])} "
          f"commands; launches {stats['launches']}", flush=True)
    return stats


# ---------------------------------------------------------------------------
# the epoch scan (--only scan)
# ---------------------------------------------------------------------------

SCAN_DIR = OUT_DIR / "scan"
# lockstep: SCAN_STEPS steps from one state and generator, per step twice
# and through the scan path once. Each leaf (parameter, BN buffer, Adam
# moment and count) is measured against its own change from the initial
# state: |a - b| / |b - init| in the 2-norm. A cell whose first seed's per-step
# floor is 0 repeats itself bit for bit and must be bit-equal; otherwise
# the scan path stays within SCAN_FLOOR_X times the median over FLOOR_SEEDS
# of the per-step path's own floor
SCAN_STEPS, SCAN_FLOOR_X = 8, 3.0
# where the per-step loop does not repeat itself, an element of a parameter
# is rounding, not signal, when its gradient at the first update is under
# SCAN_ROUNDING of its parameter's largest (1/16 of the bf16 rounding of
# that largest value; DDPM's attention key biases, which softmax ignores,
# sit there), or when the two per-step runs of a seed do not reproduce it
# to within SCAN_NOISE_GRAD of its size: Adam's per-element normalisation
# turns such a gradient into full-size steps whose sign is rounding. Those
# elements and their Adam moments are left out of the comparison, and
# counted; at most SCAN_NOISE_MAX of a cell's parameter elements
SCAN_ROUNDING, SCAN_NOISE_GRAD, SCAN_NOISE_MAX = 2.0 ** -12, 0.5, 0.1
# the broken scans that must fail the bound where it is not 0 (the third,
# a stale batch slot, is reported)
SCAN_CONTROLS_REQUIRED = ("frozen_adam_count", "stale_draws")
# timing through run_*: SCAN_TIME_EPOCHS epochs of SCAN_TIME_STEPS steps a
# path; the step ms is the median period between consecutive steps of an
# epoch, leaving out a run's first WARMUP_STEPS + 1 steps (the scan's eager
# warm-up and its capture) on both paths; the profiler traces global steps
# SCAN_PROFILE_STEPS (the scan: the chunks that overlap them)
SCAN_TIME_EPOCHS, SCAN_TIME_STEPS = 2, 14
SCAN_PROFILE_STEPS = (17, 22)
# resume: a scan run of 2 epochs of SCAN_RESUME_STEPS against 1 epoch and
# a resumed second (SCAN_STEPS steps in all, as the lockstep's floor)
SCAN_RESUME_STEPS = SCAN_STEPS // 2
# the KL ramp of the lockstep's VAE-GAN and VAE steps
SCAN_RAMP = 0.5
# the lockstep's random uint8 batches
SCAN_DATA_SEED = 15
# the CUDA functions of K1 and K2 a replay of a step's graph must launch
SCAN_K1_FUNCS = ("conv_stats_mma_kernel", "combine_stats_kernel")
SCAN_K2_FUNCS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                 "flash_bwd_dkv_kernel")
# the cli commands' steps (one epoch each; the default profile window,
# steps 10-20, lies inside); the --debug-nans command's
SCAN_CLI_STEPS, SCAN_NANS_STEPS = 24, 4
# the per-step loop with Adam capturable and not, alternated
# SCAN_AB_ROUNDS times, SCAN_AB_STEPS steps each, on these cells
SCAN_AB_CELLS = ("vaegan-64-k1", "gan-64", "wgan-64")
SCAN_AB_ROUNDS, SCAN_AB_STEPS = 2, 12


def scan_cells():
    """The cells: (tag, family, config, kernel launches a step, CUDA
    functions of the step's graph, timed and resumed through ``run_*``).
    vaegan-64 is ``VAEGANConfig``'s default (64x64, B=64), with K1 and
    without; vaegan-256 the flagship (``vaegan_config``: 256x256, B=64,
    K1), held in lockstep and timed; ddpm-256 the default DDPM with
    attention (K2); vae-64, gan-64 and wgan-64 their 64x64 defaults with
    ``--fused-conv``; all bf16, a checkpoint every epoch."""
    from vgd_tpu_torch.core.config import (DataConfig, DiffusionConfig,
                                           GANConfig, RunConfig, VAEConfig,
                                           VAEGANConfig)

    def run(tag, fused=True):
        return RunConfig(out_dir=str(SCAN_DIR / tag), seed=42,
                         fused_conv=fused)
    k2 = {name: len(ATTN_SHAPES) for name in K2_NAMES}
    flagship = vaegan_config()
    return [
        ("vaegan-64-k1", "vaegan", VAEGANConfig(
            data=DataConfig(batch_size=64, image_size=(64, 64),
                            dataset_size=1000), run=run("vaegan-64-k1")),
         {"conv_bn_stats": K1_VAEGAN64_PER_STEP}, SCAN_K1_FUNCS, True),
        ("vaegan-64", "vaegan", VAEGANConfig(
            data=DataConfig(batch_size=64, image_size=(64, 64),
                            dataset_size=1000),
            run=run("vaegan-64", fused=False)), {}, (), True),
        ("vaegan-256-k1", "vaegan", dataclasses.replace(
            flagship, data=dataclasses.replace(flagship.data,
                                               dataset_size=1000),
            run=run("vaegan-256-k1")),
         {"conv_bn_stats": K1_PER_STEP}, SCAN_K1_FUNCS, False),
        ("ddpm-256", "diffusion", DiffusionConfig(
            data=DataConfig(batch_size=16, image_size=(256, 256),
                            dataset_size=250), run=run("ddpm-256", False)),
         k2, SCAN_K2_FUNCS, True),
        ("vae-64", "vae", VAEConfig(
            data=DataConfig(batch_size=64, image_size=(64, 64),
                            dataset_size=1000, noise_max_std=0.5,
                            occlusion=False), run=run("vae-64")),
         {"conv_bn_stats": K1_VAE_PER_STEP}, SCAN_K1_FUNCS, True),
        ("gan-64", "gan", GANConfig(
            data=DataConfig(batch_size=128, image_size=(64, 64),
                            dataset_size=2000), run=run("gan-64")),
         {"conv_bn_stats": K1_GAN_PER_STEP}, SCAN_K1_FUNCS, True),
        ("wgan-64", "wgan", GANConfig(
            data=DataConfig(batch_size=128, image_size=(64, 64),
                            dataset_size=2000), run=run("wgan-64"),
            wgan=True),
         {"conv_bn_stats": K1_WGAN_PER_STEP}, SCAN_K1_FUNCS, True)]


def scan_trainer(family, cfg, seed, capturable=True):
    """A trainer of ``family`` initialised from ``seed``, its generator
    and its step function (one batch), with Adam capturable or not."""
    import torch
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    from vgd_tpu_torch.train.gan import GANTrainer
    from vgd_tpu_torch.train.vae import VAETrainer
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    cls = {"vaegan": VAEGANTrainer, "diffusion": DiffusionTrainer,
           "vae": VAETrainer, "gan": GANTrainer, "wgan": GANTrainer}[family]
    h, w = cfg.data.image_size
    tr = cls(cfg, (h, w, 3), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tr.init(gen)
    for opt in optimizers(tr).values():
        for group in opt.param_groups:
            group["capturable"] = capturable
    ramp = torch.full((), SCAN_RAMP, device="cuda")
    step = {"vaegan": lambda b: tr.train_step(b, ramp, gen),
            "diffusion": lambda b: {"loss": tr.train_step(b, gen)},
            "vae": lambda b: tr.train_step(b, ramp, generator=gen),
            "gan": lambda b: tr.train_step(b, gen),
            "wgan": lambda b: tr.train_step_wgan(b, gen)}[family]
    return tr, gen, step


def optimizers(trainer):
    return getattr(trainer, "opts", None) or {"adam": trainer.opt}


def param_names(trainer):
    """Each parameter's name in the trainer's state (``<net>.<name>``, the
    DDPM UNet's own names), by ``id``."""
    nets = trainer.nets() if hasattr(trainer, "nets") else \
        {"": trainer.model}
    return {id(p): f"{n}.{k}" if n else k for n, net in nets.items()
            for k, p in net.named_parameters()}


def scan_state(trainer):
    """Copies of every parameter and BN buffer, and of each parameter's
    Adam moments and count (``adam.<optimizer>.<parameter>.<key>``)."""
    import torch
    params = (trainer.state_dict() if hasattr(trainer, "state_dict")
              else trainer.model.state_dict())
    out = {k: v.detach().clone() for k, v in params.items()}
    names = param_names(trainer)
    for oname, opt in optimizers(trainer).items():
        for p, st in opt.state.items():
            out.update({f"adam.{oname}.{names[id(p)]}.{x}": t.detach().clone()
                        for x, t in st.items() if torch.is_tensor(t)})
    return out


@contextlib.contextmanager
def first_grads(trainer):
    """Inside the block, records into the yielded dict a copy of each
    parameter's gradient at the first optimizer update that applies one
    (an optimizer step pre-hook: the steps clear their gradients after
    the update), by name."""
    names = param_names(trainer)
    grads = {}

    def pre(opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None and names[id(p)] not in grads:
                    grads[names[id(p)]] = p.grad.detach().clone()
    hooks = [opt.register_step_pre_hook(pre)
             for opt in optimizers(trainer).values()]
    try:
        yield grads
    finally:
        for h in hooks:
            h.remove()


def noise_masks(ga, gb):
    """For each parameter with any, the elements (True) that are rounding
    by the gradients ``ga`` and ``gb`` of two runs of the same first
    update: under SCAN_ROUNDING of the parameter's largest in ``ga``, or
    differing between the runs by more than SCAN_NOISE_GRAD of their
    size."""
    out = {}
    for k, a in ga.items():
        a64 = a.double().abs()
        m = a64 <= SCAN_ROUNDING * a64.max()
        b = gb.get(k)
        if b is not None:
            m |= (a.double() - b.double()).abs() > SCAN_NOISE_GRAD * a64
        if bool(m.any()):
            out[k] = m
    return out


def merge_masks(a, b):
    return {k: a[k] | b[k] if k in a and k in b else a.get(k, b.get(k))
            for k in set(a) | set(b)}


def leaf_mask(key, masks):
    """The noise elements of a state leaf: its parameter's, for the
    parameter and its Adam moments (not its count); None for none."""
    if key.startswith("adam."):
        _, _, rest = key.split(".", 2)
        name, x = rest.rsplit(".", 1)
        return None if x == "step" else masks.get(name)
    return masks.get(key)


def leaf_rel(got, ref, init, masks=None, params_only=False):
    """(largest |got - ref| / |ref - init| over the leaves, its name), |.|
    the 2-norm over a leaf's elements that ``masks`` (``noise_masks``)
    does not mark: each leaf against its own change from ``init`` (a leaf
    absent there, an Adam moment before the first step, starts at 0), so
    that a few elements do not decide a leaf; 0 only when every such
    element is bit-equal, inf for a NaN, a changed dtype or a difference
    where the reference did not move."""
    import torch
    worst = (0.0, "")
    for k, r in ref.items():
        if (params_only and k.startswith("adam.")) or torch.equal(got[k], r):
            continue
        r64, g64 = r.double(), got[k].double()
        moved = r64 - init[k].double() if k in init else r64
        m = leaf_mask(k, masks or {})
        if m is not None:
            keep = ~m
            r64, g64, moved = r64[keep], g64[keep], moved[keep]
            if not r64.numel():
                continue
        d = float(torch.linalg.vector_norm(g64 - r64))
        den = float(torch.linalg.vector_norm(moved))
        rel = d / den if den > 0 and math.isfinite(d) else \
            (0.0 if d == 0 else float("inf"))
        worst = max(worst, (rel, k))
    return worst


def scan_control_graphs():
    """Three broken epoch scans, each a ``StepGraph`` subclass:
    ``frozen_adam_count`` puts Adam's step counts back before every
    replay, so each replay's bias correction is the capture's (what a
    non-capturable Adam would bake into the graph); ``stale_draws`` puts
    the generator back before every replay, so every replay draws what the
    first did (a generator the graph does not advance); ``stale_batch``
    fills the batch slot only for the first replay, so every later replay
    trains on that batch again."""
    from vgd_tpu_torch.ops import kernels
    from vgd_tpu_torch.train.common import StepGraph

    class FrozenAdamCount(StepGraph):
        frozen = ()

        def _capture(self, batch):
            super()._capture(batch)
            self.frozen = [(t, t.clone())
                           for opt in optimizers(self.owner).values()
                           for st in opt.state.values()
                           for x, t in st.items() if x == "step"]

        def one(self, batch):
            for t, v in self.frozen:
                t.copy_(v)
            super().one(batch)

    class StaleDraws(StepGraph):
        saved = None

        def _capture(self, batch):
            super()._capture(batch)
            self.saved = self.generator.get_state()

        def one(self, batch):
            if self.saved is not None:
                self.generator.set_state(self.saved)
            super().one(batch)

    class StaleBatch(StepGraph):
        def one(self, batch):
            if self.graph is None:
                return super().one(batch)
            self.graph.replay()
            self.owner.step += 1
            kernels.replayed(self.captured)
            self.steps_run += 1

    return {"frozen_adam_count": FrozenAdamCount, "stale_draws": StaleDraws,
            "stale_batch": StaleBatch}


def scan_lockstep(K, tag, family, cfg, per_step, funcs, failures):
    """Items 1 and 2 of the phase for one cell: per seed, SCAN_STEPS steps
    from one initial state and generator per step twice (the run-to-run
    floor) and once through a ``StepGraph`` (WARMUP_STEPS eager steps, a
    capture, replays); every leaf against its own change (``leaf_rel``,
    rounding elements left out by their first-step gradients), the
    generator state, the launches of both paths, and the K1 / K2 functions
    in a profiler trace of one more replay (the kernels a graph launches
    are traced one by one). One seed where the per-step path repeats
    itself bit for bit, else FLOOR_SEEDS; where the floor is not 0 the
    broken scans SCAN_CONTROLS_REQUIRED (``scan_control_graphs``) must
    fail the bound on the parameters and buffers alone."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vgd_tpu_torch.train.common import WARMUP_STEPS, StepGraph
    h, w = cfg.data.image_size
    dgen = torch.Generator(device="cuda").manual_seed(SCAN_DATA_SEED)
    chunk = torch.randint(0, 256, (SCAN_STEPS, cfg.data.batch_size, h, w, 3),
                          generator=dgen, device="cuda", dtype=torch.uint8)
    runs, noise, launches, names, captured = {}, {}, {}, {}, {}
    n_elems = 0

    def one_run(seed, how):
        tr, gen, step = scan_trainer(family, cfg, seed)
        init = scan_state(tr)
        K.LAUNCHES.clear()
        grads, graph = None, None
        if how.startswith("step"):
            with first_grads(tr) as grads:
                step(chunk[0])
            for b in chunk[1:]:
                step(b)
        else:
            cls = scan_control_graphs().get(how, StepGraph)
            graph = cls(step, tr, gen)
            graph.run(chunk)
        torch.cuda.synchronize()
        out = {"state": scan_state(tr), "gen": gen.get_state(),
               "init": init, "grads": grads,
               "launches": {k: v for k, v in K.LAUNCHES.items() if v}}
        return tr, graph, out

    for seed in FLOOR_SEEDS:
        for how in ("step_a", "step_b", "scan"):
            tr, graph, runs[seed, how] = one_run(seed, how)
            launches[how] = runs[seed, how]["launches"]
            n_elems = sum(g.numel() for g in (runs[seed, how]["grads"] or {})
                          .values()) or n_elems
            if how == "scan" and seed == FLOOR_SEEDS[0]:
                captured = dict(graph.captured)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    graph.one(chunk[0])
                    torch.cuda.synchronize()
                names = {f: sum(e.count for e in prof.key_averages()
                                if f in e.key and device_us(e) > 0)
                         for f in funcs}
            del tr, graph
            gc.collect()
        a, b = runs[seed, "step_a"], runs[seed, "step_b"]
        if seed == FLOOR_SEEDS[0] and all(torch.equal(b["state"][k], v)
                                          for k, v in a["state"].items()):
            break       # the per-step loop repeats itself: bit-equality
        noise = merge_masks(noise, noise_masks(a["grads"], b["grads"]))
        a["grads"] = b["grads"] = None
    seeds = sorted({s for s, _ in runs})

    def rel(seed, how, **kw):
        a = runs[seed, "step_a"]
        return leaf_rel(runs[seed, how]["state"], a["state"], a["init"],
                        noise, **kw)
    floors = {s: rel(s, "step_b") for s in seeds}
    diffs = {s: rel(s, "scan") for s in seeds}
    gen_equal = all(torch.equal(runs[s, "scan"]["gen"],
                                runs[s, "step_a"]["gen"]) for s in seeds)
    floor = sorted(f[0] for f in floors.values())[len(floors) // 2]
    bound = SCAN_FLOOR_X * floor
    worst = max(diffs.values())
    controls = {}
    if floor > 0:
        s = seeds[0]
        for how in scan_control_graphs():
            tr, graph, runs[s, how] = one_run(s, how)
            del tr, graph
            controls[how] = {"all": list(rel(s, how)),
                             "params": list(rel(s, how, params_only=True))}
            if how in SCAN_CONTROLS_REQUIRED and \
                    controls[how]["params"][0] <= bound:
                failures.append(f"scan {tag}: the broken scan {how} stays "
                                f"within the bound {bound:.3g}: "
                                f"{controls[how]}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    want = {k: v * SCAN_STEPS for k, v in per_step.items() if v}
    n_noise = sum(int(m.sum()) for m in noise.values())
    by_param = dict(sorted(((k, int(m.sum())) for k, m in noise.items()),
                           key=lambda kv: -kv[1])[:8])
    row = {"seeds": seeds, "floors": {str(s): list(f)
                                      for s, f in floors.items()},
           "median_floor": floor, "bound": bound,
           "scan_vs_step": {str(s): list(d) for s, d in diffs.items()},
           "noise_elements": n_noise, "elements": n_elems,
           "noise_params": len(noise), "noise_by_param": by_param,
           "controls": controls, "generator_equal": gen_equal,
           "launches": launches, "captured_per_replay": captured,
           "replay_trace": names, "masks": noise}
    print(f"[scan-lockstep] {tag}: {SCAN_STEPS} steps ({WARMUP_STEPS} "
          f"eager + capture + replays on the scan path), seeds {seeds}; "
          f"each leaf against its own change: scan vs per step worst "
          f"{worst[0]:.3g} ({worst[1]}), per-step floor median {floor:.3g} "
          f"(per seed " + ", ".join(f"{f[0]:.3g} ({f[1]})"
                                    for f in floors.values())
          + f"), bound {bound:.3g}; {n_noise} of {n_elems} parameter "
          f"elements left out as rounding ({len(noise)} parameters, most "
          f"{by_param}); broken scans {controls}; "
          f"generator state bit-equal {gen_equal}; launches per step path "
          f"{launches['step_a']}, scan path {launches['scan']} ({captured} "
          f"a replay); launches of each kernel function in one replay's "
          f"trace {names}", flush=True)
    if any(d[0] > bound for d in diffs.values()):
        failures.append(f"scan {tag}: scan path off the per-step path by "
                        f"{worst} (bound {bound:.3g})")
    if n_noise > SCAN_NOISE_MAX * max(n_elems, 1):
        failures.append(f"scan {tag}: {n_noise} of {n_elems} parameter "
                        f"elements are rounding by their first-step "
                        f"gradients")
    if not gen_equal:
        failures.append(f"scan {tag}: generator state differs")
    for how in ("step_a", "step_b", "scan"):
        if launches[how] != want:
            failures.append(f"scan {tag}: {how} launched {launches[how]}, "
                            f"want {want}")
    if not all(names.values()):
        failures.append(f"scan {tag}: kernels missing from a replay's trace "
                        f"{names}")
    return row


def scan_adam_ab(tag, family, cfg):
    """The per-step loop's step ms with Adam capturable (as the port runs
    it on a card) and not, alternated SCAN_AB_ROUNDS times: the median
    period of SCAN_AB_STEPS steps after the first two, each path's
    medians."""
    import gc
    import torch
    h, w = cfg.data.image_size
    dgen = torch.Generator(device="cuda").manual_seed(SCAN_DATA_SEED)
    chunk = torch.randint(0, 256, (SCAN_AB_STEPS, cfg.data.batch_size, h, w,
                                   3), generator=dgen, device="cuda",
                          dtype=torch.uint8)
    out = {"capturable": [], "host_count": []}
    for _ in range(SCAN_AB_ROUNDS):
        for capturable in (True, False):
            tr, gen, step = scan_trainer(family, cfg, FLOOR_SEEDS[0],
                                         capturable)
            marks = []
            for b in chunk:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
                step(b)
            torch.cuda.synchronize()
            periods = sorted(marks[i].elapsed_time(marks[i + 1])
                             for i in range(2, len(marks) - 1))
            out["capturable" if capturable else "host_count"].append(
                periods[len(periods) // 2])
            del tr, gen, step
            gc.collect()
    print(f"[scan-adam] {tag}: per-step loop step ms with Adam capturable "
          f"{out['capturable']}, with its count on the host "
          f"{out['host_count']} (alternated)", flush=True)
    return out


@contextlib.contextmanager
def counted_evals():
    """Counts ``DiffusionTrainer.eval_loss`` calls (each a validation
    forward with K2's forward at every gated site) into the yielded
    counter."""
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    calls = collections.Counter()
    orig = DiffusionTrainer.eval_loss

    def counted(self, *args, **kwargs):
        calls["eval_loss"] += 1
        return orig(self, *args, **kwargs)
    DiffusionTrainer.eval_loss = counted
    try:
        yield calls
    finally:
        DiffusionTrainer.eval_loss = orig


def scan_want(per_step, steps, evals):
    """Launches of ``steps`` train steps of ``per_step`` and ``evals`` DDPM
    validation forwards (K2's forward at each gated site)."""
    want = {k: v * steps for k, v in per_step.items() if v}
    if "attention_fwd" in want:
        want["attention_fwd"] += len(ATTN_SHAPES) * evals
    return want


def scan_busy(trace_dir):
    """The device's busy ms in a profiler trace written by ``run_*``
    (``profile_dir``): the union of its kernel, memcpy and memset
    intervals (None without a trace)."""
    files = sorted(Path(trace_dir).glob("*.json"))
    if not files:
        return None
    events = json.loads(files[-1].read_text()).get("traceEvents", [])
    iv = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                and "ts" in e)
    busy, end = 0.0, iv[0][0] if iv else 0.0
    for lo, hi in iv:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def traced_steps(window, steps, chunk, epochs, scan):
    """The train steps ``run_*``'s profiler traced over ``window`` (global
    steps [start, stop)): those on the per-step path, every chunk that
    overlaps it on the scan path."""
    start, stop = window
    if not scan:
        return max(0, min(stop, steps * epochs) - start)
    n = 0
    for e in range(epochs):
        for lo in range(e * steps, (e + 1) * steps, chunk):
            hi = min(lo + chunk, (e + 1) * steps)
            n += hi - lo if lo < stop and hi > start else 0
    return n


def step_stats(marks, steps, batch, trace_dir, traced):
    """A run's step measurements: ``marks`` the CUDA events recorded before
    each step, ``steps`` a run's steps an epoch. The step ms is the median
    period of consecutive steps of one epoch, leaving out a run's first
    WARMUP_STEPS + 1 steps (on the scan path its eager warm-up and its
    capture); the busy share is the device's busy ms in the trace a traced
    step over that median."""
    from vgd_tpu_torch.train.common import WARMUP_STEPS
    periods = sorted(marks[i].elapsed_time(marks[i + 1])
                     for i in range(WARMUP_STEPS + 1, len(marks) - 1)
                     if (i + 1) % steps)
    median = periods[len(periods) // 2] if periods else float("nan")
    busy_ms = scan_busy(trace_dir)
    per = busy_ms / traced if busy_ms is not None and traced else None
    return {"steps": len(marks), "periods": len(periods),
            "step_ms_median": median,
            "step_ms_min": periods[0] if periods else None,
            "step_ms_max": periods[-1] if periods else None,
            "images_per_sec": batch / median * 1e3,
            "traced_steps": traced, "busy_ms_a_step": per,
            "busy_share": per / median if per is not None else None}


def stats_text(row):
    def num(k):
        return "none" if row[k] is None else f"{row[k]:.3f}"
    return (f"{row['steps']} steps; step ms median {num('step_ms_median')} "
            f"(min {num('step_ms_min')}, max {num('step_ms_max')}, "
            f"{row['periods']} periods) = {row['images_per_sec']:.1f} "
            f"images/s; busy share {num('busy_share')} "
            f"({row['traced_steps']} traced steps)")


def scan_hooks(family, scan, marks):
    """Records a CUDA event before every train step into ``marks``: the
    trainer's step method on the per-step path, ``StepGraph.one`` on the
    scan path. Returns an undo function."""
    import torch
    from vgd_tpu_torch.train.common import StepGraph
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
    from vgd_tpu_torch.train.gan import GANTrainer
    from vgd_tpu_torch.train.vae import VAETrainer
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    owner, name = (StepGraph, "one") if scan else {
        "vaegan": (VAEGANTrainer, "train_step"),
        "diffusion": (DiffusionTrainer, "train_step"),
        "vae": (VAETrainer, "train_step"), "gan": (GANTrainer, "train_step"),
        "wgan": (GANTrainer, "train_step_wgan")}[family]
    orig = getattr(owner, name)
    own = name in vars(owner)

    def marked(self, *args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return orig(self, *args, **kwargs)
    setattr(owner, name, marked)

    def undo():
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)
    return undo


def scan_run(K, tag, family, cfg, scan, per_step):
    """Item 3 for one path of a cell: ``run_*`` for SCAN_TIME_EPOCHS x
    SCAN_TIME_STEPS steps, profiled over SCAN_PROFILE_STEPS: step ms
    (median period of consecutive steps of an epoch after the run's first
    WARMUP_STEPS + 1), images/s, busy share of the traced window, peak
    memory, launches against ``per_step``. Returns (row, result)."""
    import torch
    from vgd_tpu_torch.train import loop as L
    path = "scan" if scan else "step"
    out = SCAN_DIR / f"{tag}-{path}"
    shutil.rmtree(out, ignore_errors=True)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, out_dir=str(out), profile_dir=str(out / "trace"),
        profile_steps=SCAN_PROFILE_STEPS))
    run = {"vaegan": L.run_vaegan, "diffusion": L.run_diffusion,
           "vae": L.run_vae, "gan": L.run_gan, "wgan": L.run_gan}[family]
    marks = []
    undo = scan_hooks(family, scan, marks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        with counted_evals() as evals:
            res = run(cfg, epochs=SCAN_TIME_EPOCHS,
                      max_steps_per_epoch=SCAN_TIME_STEPS, device="cuda",
                      epoch_scan=scan)
        torch.cuda.synchronize()
    finally:
        undo()
    secs = time.perf_counter() - t0
    n = SCAN_TIME_EPOCHS * SCAN_TIME_STEPS
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    chunk = L._chunk_steps(cfg.data.batch_size, tuple(cfg.data.image_size)
                           + (3,), SCAN_TIME_STEPS)
    row = step_stats(marks, SCAN_TIME_STEPS, cfg.data.batch_size,
                     out / "trace", traced_steps(
                         SCAN_PROFILE_STEPS, SCAN_TIME_STEPS, chunk,
                         SCAN_TIME_EPOCHS, scan))
    row.update(logged_images_per_sec=[r["images_per_sec"]
                                      for r in res["log"]],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, run_s=secs,
               launches=launches, launches_ok=launches == scan_want(
                   per_step, n, evals["eval_loss"]), log=res["log"])
    print(f"[scan-time] {tag} {path}: {stats_text(row)}; peak "
          f"{row['peak_gb']:.3f} GB; run {secs:.1f} s; launches {launches}",
          flush=True)
    return row, res



def scan_resume(K, tag, family, cfg, bound, masks, failures):
    """Item 4: a scan run of 2 epochs of SCAN_RESUME_STEPS against one
    epoch and a resumed second: the final states within ``bound`` (the
    lockstep's, each leaf against its change from the run's initial
    state, the lockstep's rounding elements left out), the generator state
    of the last checkpoints bit-equal."""
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    run = {"vaegan": L.run_vaegan, "diffusion": L.run_diffusion,
           "vae": L.run_vae, "gan": L.run_gan, "wgan": L.run_gan}[family]
    # the runs' initial state: run_* seeds its generator with the run's
    # seed and initialises the trainer from it, as scan_trainer does
    finals = {"init": scan_state(scan_trainer(family, cfg, cfg.run.seed)[0])}
    rng = {}
    for name, legs in (("straight", [(2, False)]),
                       ("resumed", [(1, False), (2, True)])):
        out = SCAN_DIR / f"{tag}-{name}"
        shutil.rmtree(out, ignore_errors=True)
        c = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, out_dir=str(out)))
        for epochs, resume in legs:
            res = run(c, epochs=epochs, max_steps_per_epoch=SCAN_RESUME_STEPS,
                      resume=resume, device="cuda", epoch_scan=True)
        finals[name] = scan_state(res["trainer"])
        rng[name] = Checkpointer(str(out / "ckpt")).load()["rng_state"]
        del res
    diff = leaf_rel(finals["resumed"], finals["straight"], finals["init"],
                    masks)
    same_rng = torch.equal(rng["resumed"], rng["straight"])
    print(f"[scan-resume] {tag}: 2 x {SCAN_RESUME_STEPS} scan steps "
          f"straight vs 1 epoch + a resumed one: worst {diff[0]:.3g} "
          f"({diff[1]}), bound {bound:.3g}; generator state bit-equal "
          f"{same_rng}", flush=True)
    if diff[0] > bound or not same_rng:
        failures.append(f"scan {tag}: resume off by {diff}, generator "
                        f"equal {same_rng}")
    return {"worst": list(diff), "generator_equal": same_rng}


def scan_refusal(failures):
    """Item 5: two ranks on the one card over gloo: ``epoch_scan=True``
    refuses before training, the default takes the per-step loop and says
    so on stderr (``parallel.workers.scan_refusal``)."""
    from vgd_tpu_torch.parallel.launch import spawn
    cfg = scan_cells()[0][2]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, dataset_size=300), run=dataclasses.replace(
        cfg.run, out_dir=str(SCAN_DIR / "refusal")))
    ranks = spawn("vgd_tpu_torch.parallel.workers:scan_refusal", 2, cfg,
                  "cuda", timeout=DP_TIMEOUT,
                  log_dir=str(SCAN_DIR / "refusal-logs"))
    for r, got in enumerate(ranks):
        print(f"[scan-refusal] rank {r}: epoch_scan=True raised "
              f"{got['raised']!r}; the default trained "
              f"{got['default_steps']} steps per step, its stderr line "
              f"{got['default_line']!r}", flush=True)
    ok = all("--no-epoch-scan" in (g["raised"] or "") and g["default_line"]
             and g["default_steps"] == 2 for g in ranks)
    if not ok:
        failures.append(f"scan refusal: {ranks}")
    return ranks


def scan_nccl(failures):
    """The scan under NCCL, which it captures: one process as a world of
    one on NCCL (so BatchNorm's global statistics, the gradient averages
    and the metric means run as NCCL collectives inside the graph) trains
    vaegan-64 with K1 for SCAN_STEPS steps step by step and then through
    the scan (the family's default); both must end bit-equal, each
    launching K1 exactly SCAN_STEPS times a step's."""
    from vgd_tpu_torch.parallel.launch import spawn
    cfg = scan_cells()[0][2]

    def job(tag, scan):
        c = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, dataset_size=700), run=dataclasses.replace(
            cfg.run, out_dir=str(SCAN_DIR / tag)))
        return dict(family="vaegan", device="cuda", epochs=1,
                    max_steps_per_epoch=SCAN_STEPS, cfg=c, state=False,
                    record=not scan, epoch_scan=None if scan else False)
    step, scan = spawn("vgd_tpu_torch.parallel.workers:train_loops", 1,
                       [job("nccl-step", False), job("nccl-scan", True)],
                       timeout=DP_TIMEOUT,
                       log_dir=str(SCAN_DIR / "nccl-logs"))[0]
    want = {"conv_bn_stats": K1_VAEGAN64_PER_STEP * SCAN_STEPS}
    got = [{k: v for k, v in r["launches"].items() if v}
           for r in (step, scan)]
    same = step["fingerprint"] == scan["fingerprint"]
    print(f"[scan-nccl] vaegan-64 K1, one process on NCCL: {SCAN_STEPS} "
          f"steps per step vs the scan bit-equal {same}; launches {got[0]} "
          f"vs {got[1]}; optimizer steps {step['opt_step']} vs "
          f"{scan['opt_step']}", flush=True)
    if not same or got != [want, want] or scan["opt_step"] != SCAN_STEPS:
        failures.append(f"scan nccl: bit-equal {same}, launches {got} (want "
                        f"{want}), steps {scan['opt_step']}")
    return {"bit_equal": same, "launches": got,
            "peak_gb": [step.get("peak_mem_gb"), scan.get("peak_mem_gb")]}


def scan_cli(K, failures):
    """Item 3 through ``cli.main``: each family's training command as a
    user types it on the scan path (``vaegan --fused-conv``, ``vaegan``,
    ``diffusion``, and ``vae``, ``gan``, ``wgan`` with ``--epoch-scan
    --fused-conv``), one epoch of SCAN_CLI_STEPS steps with
    ``--profile-dir``: rc, seconds, the loop's line, launches, and the
    step measurements of ``scan_run``; then ``vaegan --fused-conv
    --debug-nans``, which must train SCAN_NANS_STEPS steps per step and
    say why on stderr."""
    import io
    import torch
    from vgd_tpu_torch import cli
    from vgd_tpu_torch.core.config import RunConfig
    from vgd_tpu_torch.train import loop as L
    k2 = {k: len(ATTN_SHAPES) for k in K2_NAMES}
    k1_vaegan = {"conv_bn_stats": K1_VAEGAN64_PER_STEP}
    # (tag, family, argv, batch, image side, dataset size, launches a step,
    # steps, the loop the line must name)
    cmds = [("vaegan", "vaegan", ["vaegan", "--fused-conv"], 64, 64, 1720,
             k1_vaegan, SCAN_CLI_STEPS, "scan"),
            ("vaegan-default", "vaegan", ["vaegan"], 64, 64, 1720, {},
             SCAN_CLI_STEPS, "scan"),
            ("diffusion", "diffusion", ["diffusion"], 16, 256, 430, k2,
             SCAN_CLI_STEPS, "scan"),
            ("vae", "vae", ["vae", "--epoch-scan", "--fused-conv"], 64, 64,
             1720, {"conv_bn_stats": K1_VAE_PER_STEP}, SCAN_CLI_STEPS,
             "scan"),
            ("gan", "gan", ["gan", "--epoch-scan", "--fused-conv"], 128, 64,
             3420, {"conv_bn_stats": K1_GAN_PER_STEP}, SCAN_CLI_STEPS,
             "scan"),
            ("wgan", "wgan", ["wgan", "--epoch-scan", "--fused-conv"], 128,
             64, 3420, {"conv_bn_stats": K1_WGAN_PER_STEP}, SCAN_CLI_STEPS,
             "scan"),
            ("vaegan-debug-nans", "vaegan", ["vaegan", "--fused-conv",
                                             "--debug-nans"], 64, 64, 400,
             k1_vaegan, SCAN_NANS_STEPS, "per step")]
    window = RunConfig().profile_steps
    rows = {}
    for tag, family, argv, batch, side, size, per_step, steps, loop in cmds:
        out_dir = SCAN_DIR / f"cli-{tag}"
        shutil.rmtree(out_dir, ignore_errors=True)
        argv = [str(a) for a in argv + [
            "--epochs", 1, "--steps-per-epoch", steps, "--dataset-size",
            size, "--out-dir", out_dir, "--profile-dir", out_dir / "trace",
            "--device", "cuda"]]
        scan = loop == "scan"
        marks = []
        undo = scan_hooks(family, scan, marks)
        K.LAUNCHES.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(err), \
                    counted_evals() as evals:
                rc = cli.main(argv)
        except Exception:                  # noqa: BLE001 - a failed command
            rc = "exception: " + traceback.format_exc().strip() \
                .splitlines()[-1]
            traceback.print_exc()
        finally:
            undo()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        sys.stderr.write(err.getvalue())
        loop_line = next((ln for ln in lines if "epoch loop:" in ln), "")
        err_line = next((ln for ln in err.getvalue().splitlines()
                         if "epoch scan" in ln), "")
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        want = scan_want(per_step, steps, evals["eval_loss"])
        chunk = L._chunk_steps(batch, (side, side, 3), steps)
        row = step_stats(marks, steps, batch, out_dir / "trace",
                         traced_steps(window, steps, chunk, 1, scan))
        row.update(argv=argv, rc=rc, seconds=secs, loop_line=loop_line,
                   stderr_line=err_line, launches=launches,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   last_line=lines[-1] if lines else "")
        rows[tag] = row
        print(f"[scan-cli] {' '.join(argv)} rc {rc} {secs:.2f} s; "
              f"{loop_line.strip()}; {err_line.strip()}; {stats_text(row)}; "
              f"launches {launches}; peak {row['peak_gb']:.3f} GB; "
              f"{row['last_line']}", flush=True)
        ok = rc == 0 and f"epoch loop: {loop}" in loop_line and \
            launches == want and (scan or "--debug-nans" in err_line)
        if not ok:
            failures.append(f"scan cli {tag}: rc {rc}, loop line "
                            f"{loop_line!r}, stderr {err_line!r}, launches "
                            f"{launches} (want {want})")
    return rows


def scan_path(K, failures, adam_ab=False):
    """The epoch-scan phase (module docstring, step 17): per cell the
    lockstep, the kernels in the graph, both paths' times through
    ``run_*`` and the resume; with ``adam_ab`` (``--only scan``; the full
    run leaves it out for time) the capturable Adam's cost on the
    per-step loop; then the commands, the scan under NCCL and the gloo
    refusal."""
    import gc
    import torch
    shutil.rmtree(SCAN_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    report = {"cells": {}, "adam_ab": {}}
    launches = {k: 0 for k in ("conv_bn_stats",) + K2_NAMES}
    for tag, family, cfg, per_step, funcs, resumed in scan_cells():
        t_cell = time.perf_counter()
        cell = {"lockstep": scan_lockstep(K, tag, family, cfg, per_step,
                                          funcs, failures)}
        if adam_ab and tag in SCAN_AB_CELLS:
            report["adam_ab"][tag] = scan_adam_ab(tag, family, cfg)
        for scan in (False, True):
            row, res = scan_run(K, tag, family, cfg, scan, per_step)
            cell["scan" if scan else "step"] = row
            if scan:
                for k in launches:
                    launches[k] += row["launches"].get(k, 0)
            if not row["launches_ok"]:
                failures.append(f"scan {tag}: a run launched "
                                f"{row['launches']}, want {per_step} a step")
            if not all(math.isfinite(v) for r in row["log"]
                       for k, v in r.items() if k.startswith(
                           ("train", "d_loss", "g_loss"))):
                failures.append(f"scan {tag}: non-finite log {row['log']}")
            del res
        step_log, scan_log = cell["step"]["log"], cell["scan"]["log"]
        masks = cell["lockstep"].pop("masks")
        if resumed:
            cell["resume"] = scan_resume(K, tag, family, cfg,
                                         cell["lockstep"]["bound"], masks,
                                         failures)
        del masks
        cell["cell_s"] = time.perf_counter() - t_cell
        print(f"[scan] {tag}: step ms per step "
              f"{cell['step']['step_ms_median']:.3f} -> scan "
              f"{cell['scan']['step_ms_median']:.3f}; busy "
              f"{cell['step']['busy_share']} -> "
              f"{cell['scan']['busy_share']}; peak "
              f"{cell['step']['peak_gb']:.3f} -> "
              f"{cell['scan']['peak_gb']:.3f} GB; logged images/s "
              f"{step_log[-1]['images_per_sec']:.1f} -> "
              f"{scan_log[-1]['images_per_sec']:.1f}; cell "
              f"{cell['cell_s']:.1f} s", flush=True)
        report["cells"][tag] = cell
        gc.collect()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    report["cli"] = scan_cli(K, failures)
    report["cli_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report["nccl"] = scan_nccl(failures)
    report["nccl_s"] = time.perf_counter() - t
    t = time.perf_counter()
    report["refusal"] = scan_refusal(failures)
    report["refusal_s"] = time.perf_counter() - t
    report["launches"] = launches
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[scan] phase {report['phase_s']:.1f} s (commands "
          f"{report['cli_s']:.1f}, NCCL {report['nccl_s']:.1f}, refusal "
          f"{report['refusal_s']:.1f}); scan-path launches {launches}",
          flush=True)
    return report


# ---------------------------------------------------------------------------
# the native batch gather and the pinned staging of both epoch loops
# (``--only data``; step 18)
# ---------------------------------------------------------------------------

NATIVE_DIR = OUT_DIR / "native_data"
# the run's memmap: NATIVE_FACES images at 256x256 (1.51 GB), passes of
# NATIVE_BASE synthetic faces, each pass shifted one column further; the
# (a) source at 64x64: NATIVE_FACES_64 images (377 MB)
NATIVE_FACES, NATIVE_FACES_64, NATIVE_BASE = 7680, 30720, 128
# (a): (tag, image size, batch, steps a chunk): the scan's chunk under
# SCAN_CHUNK_BYTES (256 MiB) at 64x64 and 256x256, batch 64, over a full
# CelebA epoch (182,339 train images: 2849 steps, so the byte budget binds)
NATIVE_STAGE_CASES = [("vaegan-64", (64, 64), 64, 341),
                      ("vaegan-256", (256, 256), 64, 21)]
NATIVE_STAGE_REPEATS = 5
NATIVE_SWEEP_THREADS = (1, 2, 3, 4, 8)
NATIVE_SEED = 17
# (b): run_vaegan on the memmap, NATIVE_EPOCHS epochs of NATIVE_STEPS steps
# (4 chunks of 21 an epoch); the profiler traces the chunk that holds
# global steps NATIVE_PROFILE_STEPS
NATIVE_EPOCHS, NATIVE_STEPS = 2, 84
NATIVE_PROFILE_STEPS = (NATIVE_STEPS + 25, NATIVE_STEPS + 30)
# (c): the batch-identity probe: PROBE_STEPS steps (4 chunks of 21: two
# turns of the scan's two-buffer ring), each first spinning PROBE_CYCLES
# clock cycles on the card (~10 ms), so the card runs behind the host's
# staging and a buffer refilled before its copy would be caught
PROBE_STEPS, PROBE_CYCLES = 84, 20_000_000
# the stagers that must fail the probe
PROBE_BROKEN = ("refilled_without_wait", "stale_buffer", "stale_graph_slot")


def native_sources():
    """Writes the phase's memmaps: a folder whose JPEG names are empty
    files and whose decode cache (``celeba.cache_path``) holds
    NATIVE_FACES faces at 256x256, and a plain .npy of NATIVE_FACES_64 at
    64x64. Returns (folder, {image size: memmap}, seconds)."""
    import numpy as np
    from vgd_tpu_torch.data import celeba
    t0 = time.perf_counter()
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    folder = NATIVE_DIR / "faces256"
    folder.mkdir(parents=True)
    for i in range(NATIVE_FACES):
        (folder / f"{i:06d}.jpg").touch()
    sources = {}
    for hw, n, path in (((256, 256), NATIVE_FACES,
                         celeba.cache_path(str(folder), (256, 256),
                                           NATIVE_FACES)),
                        ((64, 64), NATIVE_FACES_64,
                         str(NATIVE_DIR / "faces64.npy"))):
        base = celeba.synthetic_faces(NATIVE_BASE, hw, seed=NATIVE_SEED)
        out = np.lib.format.open_memmap(path + ".tmp", mode="w+",
                                        dtype=np.uint8,
                                        shape=(n,) + hw + (3,))
        for i in range(0, n, NATIVE_BASE):
            k = min(NATIVE_BASE, n - i)
            out[i:i + k] = np.roll(base[:k], i // NATIVE_BASE, axis=2)
        out.flush()
        del out
        os.replace(path + ".tmp", path)
        sources[hw] = np.load(path, mmap_mode="r")
    return folder, sources, time.perf_counter() - t0


def native_stage(tag, data, batch, chunk, step_ms, failures, ab=False):
    """(a) for one case: one chunk of ``chunk`` random sorted selections of
    ``batch`` rows staged five ways, in turns: the native gather straight
    into a pinned buffer as the scan does (``prefetch.fill_chunk``: the
    chunk in one call, ``native.threads_for`` its bytes) and as the
    per-step loop does (``fill_chunk`` a batch into its own slot, on the
    threads of a batch's bytes), numpy fancy indexing alone, and the
    parent's passes: on the scan numpy gathers, ``np.stack`` and
    ``pin_memory()``, on the per-step loop a numpy gather and
    ``pin_memory()`` a batch; host ms median of NATIVE_STAGE_REPEATS (3
    without ``ab``), GB/s, the native bytes against numpy's, the H2D copy
    of the pinned chunk (CUDA events), beside the chunk's device time
    (``chunk`` x ``step_ms``, None where not measured in this call). With
    ``ab`` (``--only data``) also a batch a call at each of
    NATIVE_SWEEP_THREADS threads (``native.gather_rows_at``), the
    measurement behind ``native.THREAD_GRAIN``."""
    import numpy as np
    import torch
    from vgd_tpu_torch.data import native
    from vgd_tpu_torch.utils.prefetch import fill_chunk
    rng = np.random.default_rng(NATIVE_SEED)
    sels = [np.sort(rng.choice(len(data), batch, replace=False))
            for _ in range(chunk)]
    buf = torch.empty((chunk, batch) + data.shape[1:], dtype=torch.uint8,
                      pin_memory=True)
    flat = buf.numpy().reshape((-1,) + data.shape[1:])

    def per_batch():
        for i, s in enumerate(sels):
            fill_chunk(data, [s], buf[i:i + 1])

    def threaded(n):
        def run():
            for i, s in enumerate(sels):
                native.gather_rows_at(data, s, flat, i * batch, n)
        return run
    ways = {"native": lambda: fill_chunk(data, sels, buf),
            "native_per_batch": per_batch,
            "numpy": lambda: [data[s] for s in sels],
            "numpy_stack_pin": lambda: torch.from_numpy(
                np.stack([data[s] for s in sels])).pin_memory(),
            "numpy_pin_per_batch": lambda: [
                torch.from_numpy(data[s]).pin_memory() for s in sels]}
    if ab:
        ways.update({f"per_batch_{n}_threads": threaded(n)
                     for n in NATIVE_SWEEP_THREADS})
    times = {k: [] for k in ways}
    for r in range(NATIVE_STAGE_REPEATS if ab else 3):
        for k in (list(ways) if r % 2 == 0 else list(ways)[::-1]):
            t = time.perf_counter()
            ways[k]()
            times[k].append((time.perf_counter() - t) * 1e3)
    same = buf.numpy().tobytes() == np.stack(ways["numpy"]()).tobytes()
    if not same:
        failures.append(f"data {tag}: the native gather's chunk differs "
                        f"from numpy's")
    dev = torch.empty(buf.shape, dtype=torch.uint8, device="cuda")
    copy = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        dev.copy_(buf, non_blocking=True)
        b.record()
        torch.cuda.synchronize()
        copy.append(a.elapsed_time(b))
    nbytes = buf.numel()
    row = {"chunk_steps": chunk, "batch": batch, "bytes": nbytes,
           "threads": native.threads_for(nbytes),
           "threads_a_batch": native.threads_for(nbytes // chunk),
           "byte_equal": same, "h2d_ms": sorted(copy)[1],
           "device_ms": chunk * step_ms if step_ms else None}
    for k, v in times.items():
        ms = sorted(v)[len(v) // 2]
        row[k] = {"ms": ms, "ms_all": v, "gb_per_s": nbytes / ms / 1e6,
                  "ms_a_batch": ms / chunk}
    dev_txt = (f"{row['device_ms']:.3f} ms ({chunk} x {step_ms:.3f})"
               if step_ms else "not measured in this call")

    def way(k):
        return (f"{row[k]['ms']:.3f} ms = {row[k]['gb_per_s']:.2f} GB/s "
                f"({row[k]['ms_a_batch']:.4f} a batch)")
    sweep = ", ".join(f"{n}: {row[f'per_batch_{n}_threads']['ms']:.3f}"
                      for n in NATIVE_SWEEP_THREADS if ab)
    print(f"[data-stage] {tag} chunk {chunk} x {batch} ({nbytes / 1e6:.1f} "
          f"MB): scan: native {way('native')} on {row['threads']} threads, "
          f"numpy + stack + pin (the parent) {way('numpy_stack_pin')}; "
          f"per step: native {way('native_per_batch')} on "
          f"{row['threads_a_batch']} threads a batch, numpy + pin a batch "
          f"(the parent) {way('numpy_pin_per_batch')}; numpy alone "
          f"{way('numpy')}; H2D {row['h2d_ms']:.3f} ms; the chunk's device "
          f"time {dev_txt}; byte-equal {same}"
          + (f"; a batch a call by threads (ms a chunk) {sweep}"
             if ab else ""), flush=True)
    del dev
    return row


def parent_staging():
    """The parent's staging as a ``_Staging`` (``--only data``'s A/B):
    numpy fancy indexing a batch; on the scan ``np.stack`` of a chunk,
    ``pin_memory()`` of it, two chunks in flight; on the per-step loop
    ``pin_memory()`` of each batch, two in flight."""
    import itertools
    import numpy as np
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.utils.prefetch import device_prefetch

    class ParentStaging(L._Staging):
        def batches(self, selections, steps=None):
            return device_prefetch(
                (self.mesh.rows(self.data[s])
                 for s in itertools.islice(selections, steps)),
                size=2, device=self.ring.device)

        def chunks(self, selections, steps=None):
            per = self.ring.buffers[0].shape[0]

            def stacked():
                it, count = iter(selections), 0
                while steps is None or count < steps:
                    n = per if steps is None else min(per, steps - count)
                    buf = [self.mesh.rows(self.data[s])
                           for s in itertools.islice(it, n)]
                    if not buf:
                        return
                    count += len(buf)
                    yield np.stack(buf)
            return device_prefetch(stacked(), size=2,
                                   device=self.ring.device)
    return ParentStaging


def native_run(K, tag, folder, failures, staging=None):
    """(b) ``run_vaegan`` at 256x256, B=64 with K1 on the default scan from
    the memmap ``folder``, NATIVE_EPOCHS x NATIVE_STEPS: step ms (median
    period, ``step_stats``), busy share of the traced chunk, peak, K1
    launches (K1_PER_STEP a step), finite losses; per epoch the gap from
    entering ``_train_epoch`` to its first step (CUDA events: the card
    waits for the staging and the first chunk's copy) and its host ms;
    the host ms of each chunk's gather. ``staging`` replaces the loop's
    ``_Staging`` class for the run (the parent's, for the A/B)."""
    import numpy as np
    import torch
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.common import StepGraph
    base = vaegan_config()
    out = NATIVE_DIR / tag
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, path=str(folder),
                                       dataset_size=NATIVE_FACES),
        run=dataclasses.replace(base.run, out_dir=str(out),
                                profile_dir=str(out / "trace"),
                                profile_steps=NATIVE_PROFILE_STEPS))
    marks, starts, fills = [], [], []
    orig_epoch, orig_one = L._train_epoch, StepGraph.one
    orig_staging, orig_fill = L._Staging, L._Staging.fill

    def entered(*args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        starts.append((ev, time.perf_counter(), len(marks)))
        return orig_epoch(*args, **kwargs)

    def one(self, batch):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))
        return orig_one(self, batch)

    def fill(self, data, sels, buf):
        t = time.perf_counter()
        orig_fill(self, data, sels, buf)
        fills.append((time.perf_counter() - t) * 1e3)
    L._train_epoch, StepGraph.one, L._Staging.fill = entered, one, fill
    if staging is not None:
        L._Staging = staging
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES.clear()
    t0 = time.perf_counter()
    try:
        res = L.run_vaegan(cfg, epochs=NATIVE_EPOCHS,
                           max_steps_per_epoch=NATIVE_STEPS, device="cuda")
        torch.cuda.synchronize()
    finally:
        L._train_epoch, StepGraph.one = orig_epoch, orig_one
        L._Staging, L._Staging.fill = orig_staging, orig_fill
    secs = time.perf_counter() - t0
    chunk = L._chunk_steps(64, (256, 256, 3), NATIVE_STEPS)
    row = step_stats([ev for ev, _ in marks], NATIVE_STEPS, 64,
                     out / "trace", traced_steps(
                         NATIVE_PROFILE_STEPS, NATIVE_STEPS, chunk,
                         NATIVE_EPOCHS, True))
    gaps = [{"device_ms": ev.elapsed_time(marks[i][0]),
             "host_ms": (marks[i][1] - t) * 1e3}
            for ev, t, i in starts if i < len(marks)]
    launches = {k: v for k, v in K.LAUNCHES.items() if v}
    want = {"conv_bn_stats": K1_PER_STEP * NATIVE_EPOCHS * NATIVE_STEPS}
    finite = all(math.isfinite(v) for r in res["log"] for k, v in r.items()
                 if k.startswith("train"))
    row.update(chunk_steps=chunk, epoch_start_gaps=gaps,
               fill_ms=fills, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               run_s=secs, launches=launches, launches_ok=launches == want,
               finite=finite, log=res["log"])
    if staging is None and (not row["launches_ok"] or not finite):
        failures.append(f"data {tag}: launches {launches} (want {want}), "
                        f"finite losses {finite}")
    fill_txt = (f"; gather ms a chunk median "
                f"{sorted(fills)[len(fills) // 2]:.3f} of {len(fills)}"
                if fills else "")
    print(f"[data-run] {tag}: {stats_text(row)}; peak {row['peak_gb']:.3f} "
          f"GB; epoch-start gap (card ms, host ms) " + ", ".join(
              f"{g['device_ms']:.3f} / {g['host_ms']:.3f}" for g in gaps)
          + f"{fill_txt}; run {secs:.1f} s; launches {launches}", flush=True)
    return row


def probe_loaders(folder):
    """The memmap's train loader (B=64, the run's) and one at DDPM's batch
    (B=16) over the same rows."""
    from vgd_tpu_torch.data import celeba
    base = vaegan_config()
    cfg = dataclasses.replace(base.data, path=str(folder),
                              dataset_size=NATIVE_FACES)
    train, _, _ = celeba.make_image_datasets(cfg, seed=base.run.seed)
    return {64: train, 16: celeba.Loader(train.ds, train.indices, 16,
                                         shuffle=True, seed=base.run.seed)}


def probe_expected(loader, mesh, weights):
    """The probe's record a straight run must leave: per step, each of this
    rank's rows of the step's selection dotted with ``weights``."""
    import numpy as np
    loader.set_epoch(0)
    out = []
    for i, (sel, _) in enumerate(loader.selections()):
        if i == PROBE_STEPS:
            break
        rows = loader.ds.array[mesh.rows(sel)]
        out.append(rows.reshape(len(rows), -1).astype(np.float64) @ weights)
    return np.stack(out)


def broken_stagers():
    """The probe's broken stagers, each existing only in this phase:
    ``refilled_without_wait`` hands a ring buffer out again without
    waiting on its copy's event; ``stale_buffer`` fills each ring buffer
    on its first turn only; and step 17's ``stale_batch`` StepGraph, which
    fills the graph's batch slot for the capture only
    (``stale_graph_slot``)."""
    from vgd_tpu_torch.train import loop as L

    class RefilledWithoutWait(L._Staging):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.ring.wait = lambda k: None

    class StaleBuffer(L._Staging):
        filled = frozenset()

        def fill(self, data, sels, buf):
            if buf.data_ptr() not in self.filled:
                self.filled = self.filled | {buf.data_ptr()}
                super().fill(data, sels, buf)
    return {"refilled_without_wait": (RefilledWithoutWait, None),
            "stale_buffer": (StaleBuffer, None),
            "stale_graph_slot": (L._Staging,
                                 scan_control_graphs()["stale_batch"])}


def identity_probe(loader, mesh, weights, expected, scan, staging_cls,
                   graph_cls):
    """(c) one run of the probe: ``_train_epoch`` over PROBE_STEPS steps of
    ``loader`` staged by ``staging_cls`` (the scan's chunks, or one batch a
    buffer), through a ``graph_cls`` StepGraph (or the per-step loop)
    whose step spins PROBE_CYCLES on the card and records the dot of each
    row of its batch with ``weights`` (f64, exact: integer sums under
    2^53). Returns the steps whose record differs from ``expected``."""
    import types
    import numpy as np
    import torch
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.common import StepGraph
    dev = torch.device("cuda")
    rows = expected.shape[1]
    w = torch.from_numpy(weights).to(dev)
    rec = torch.full(expected.shape, -1.0, dtype=torch.float64, device=dev)
    at = torch.zeros(1, dtype=torch.long, device=dev)

    def step(b):
        torch.cuda._sleep(PROBE_CYCLES)
        rec.index_copy_(0, at, (b.reshape(rows, -1).double() @ w)[None])
        at.add_(1)
        return {"steps": torch.ones((), device=dev)}

    class Quiet:
        def step(self, i):
            pass

        def chunk_begin(self, lo, hi):
            pass

        def chunk_end(self, hi):
            pass
    owner = types.SimpleNamespace(device=dev, step=0)
    graph = (graph_cls or StepGraph)(step, owner) if scan else None
    loader.set_epoch(0)
    per = L._chunk_steps(loader.batch_size, loader.ds.image_shape,
                         PROBE_STEPS) if scan else 1
    staging = staging_cls(loader.ds.array, loader.batch_size, mesh, dev,
                          per, L.SCAN_PREFETCH if scan else L.STEP_PREFETCH)
    _, count, _ = L._train_epoch(graph, staging, loader, PROBE_STEPS,
                                 Quiet(), 0, step)
    torch.cuda.synchronize()
    got = rec.cpu().numpy()
    bad = [i for i in range(len(expected))
           if not np.array_equal(got[i], expected[i])]
    return {"steps": count, "turns": staging.ring.turn,
            "buffers": len(staging.ring.buffers), "mismatched_steps": bad}


def identity_path(folder, failures):
    """(c) the batch-identity check under the scan (module docstring)."""
    import numpy as np
    from vgd_tpu_torch.parallel.mesh import LOCAL, Mesh
    from vgd_tpu_torch.train import loop as L
    loaders = probe_loaders(folder)
    weights = np.random.default_rng(NATIVE_SEED).integers(
        1, 2 ** 16, int(np.prod(loaders[64].ds.image_shape))).astype(
            np.float64)
    out = {}
    broken = broken_stagers()
    runs = [(f"scan-b{b}", b, LOCAL, True, None) for b in (64, 16)] + [
        (f"scan-b64-{name}", 64, LOCAL, True, name)
        for name in PROBE_BROKEN] + [
        ("step-b64", 64, LOCAL, False, None),
        ("scan-b64-dp2-rank1", 64, Mesh(2, 1, 1), True, None)]
    expected = {}
    for tag, b, mesh, scan, name in runs:
        key = (b, mesh.data, mesh.rank)
        if key not in expected:
            expected[key] = probe_expected(loaders[b], mesh, weights)
        staging_cls, graph_cls = broken[name] if name else (L._Staging,
                                                            None)
        t = time.perf_counter()
        row = identity_probe(loaders[b], mesh, weights, expected[key], scan,
                             staging_cls, graph_cls)
        row["s"] = time.perf_counter() - t
        held = not row["mismatched_steps"]
        if name is None and (not held or row["steps"] != PROBE_STEPS):
            failures.append(f"data identity {tag}: steps "
                            f"{row['mismatched_steps']} differ from the "
                            f"loader's rows ({row['steps']} run)")
        if name is not None and held:
            failures.append(f"data identity {tag}: the broken stager passed")
        if scan and row["turns"] < 2 * row["buffers"]:
            failures.append(f"data identity {tag}: {row['turns']} buffer "
                            f"turns, want two turns of {row['buffers']}")
        print(f"[data-identity] {tag}: {row['steps']} steps, "
              f"{row['turns']} turns of {row['buffers']} buffers, "
              f"{len(row['mismatched_steps'])} steps differ "
              f"{row['mismatched_steps'][:8]} ({'held' if held else 'caught'}"
              f", {row['s']:.1f} s)", flush=True)
        out[tag] = row
    return out


# (d) the per-step loop's cells timed against the parent's staging
NATIVE_STEP_CELLS = ("vae-64", "gan-64", "wgan-64")


def step_ab(K):
    """(d) ``--only data``: each NATIVE_STEP_CELLS cell's per-step loop
    (step 17's timed ``run_*``, ``scan_run``) with the parent's staging
    and with the loop's, in the order parent, change, change, parent:
    step ms (median period) and busy share of each run."""
    from vgd_tpu_torch.train import loop as L
    cells = {c[0]: c for c in scan_cells()}
    parent, out = parent_staging(), {}
    for name in NATIVE_STEP_CELLS:
        tag, family, cfg, per_step, _, _ = cells[name]
        rows = []
        for which in ("parent", "change", "change", "parent"):
            orig = L._Staging
            L._Staging = parent if which == "parent" else orig
            try:
                row, res = scan_run(K, tag, family, cfg, False, per_step)
            finally:
                L._Staging = orig
            del res
            rows.append({"staging": which, "step_ms": row["step_ms_median"],
                         "busy_share": row["busy_share"],
                         "peak_gb": row["peak_gb"]})
        out[name] = rows
        print(f"[data-step] {name} per-step loop ms (busy) " + ", ".join(
            f"{r['staging']} {r['step_ms']:.3f} ({r['busy_share']})"
            for r in rows), flush=True)
    return out


def native_data_path(K, failures, scan_report=None, ab=False):
    """The data phase (module docstring, step 18): the native gather's
    build; (a) each staging case; (b) ``run_vaegan`` from the memmap, and
    with ``ab`` (``--only data``) the parent's staging on the same run and
    the synthetic vaegan-256 scan cell (else its row from ``scan_report``,
    the scan phase of this call); (c) the batch-identity probe; with
    ``ab``, (d) the per-step loops against the parent's staging."""
    import gc
    import torch
    from vgd_tpu_torch.data import native
    t_phase = time.perf_counter()
    t = time.perf_counter()
    lib = native.build(force=True)
    report = {"build_s": time.perf_counter() - t, "library": str(lib)}
    print(f"[data] native gather built by {native.find_cxx()} in "
          f"{report['build_s']:.2f} s ({lib.name}); threads "
          f"{native.default_threads()} of {os.cpu_count()} cores", flush=True)
    folder, sources, report["write_s"] = native_sources()
    print(f"[data] memmaps written in {report['write_s']:.1f} s: "
          + ", ".join(f"{len(a)} x {a.shape[1]}x{a.shape[2]} "
                      f"({a.nbytes / 1e9:.2f} GB)" for a in sources.values())
          + " (warm: just written)", flush=True)
    report["run"] = native_run(K, "memmap-256", folder, failures)
    cells = (scan_report or {}).get("cells", {})
    if ab:
        report["parent_run"] = native_run(K, "memmap-256-parent", folder,
                                          failures, parent_staging())
        tag, family, cfg, per_step, _, _ = next(
            c for c in scan_cells() if c[0] == "vaegan-256-k1")
        report["synthetic_cell"], res = scan_run(K, tag, family, cfg, True,
                                                 per_step)
        del res
    elif "vaegan-256-k1" in cells:
        report["synthetic_cell"] = cells["vaegan-256-k1"]["scan"]
    syn = report.get("synthetic_cell")
    r = report["run"]
    print(f"[data-run] memmap scan step ms {r['step_ms_median']:.3f}, busy "
          f"{r['busy_share']}, peak {r['peak_gb']:.3f} GB against the "
          f"synthetic vaegan-256 scan cell " + (
              f"{syn['step_ms_median']:.3f}, busy {syn['busy_share']}, peak "
              f"{syn['peak_gb']:.3f} GB" if syn else "(not run in this "
              "call)"), flush=True)
    step64 = cells.get("vaegan-64-k1", {}).get("scan", {}).get(
        "step_ms_median")
    report["stage"] = {}
    for tag, hw, batch, chunk in NATIVE_STAGE_CASES:
        step_ms = r["step_ms_median"] if hw == (256, 256) else step64
        report["stage"][tag] = native_stage(tag, sources[hw], batch, chunk,
                                            step_ms, failures, ab)
    del sources
    gc.collect()
    torch.cuda.empty_cache()
    report["identity"] = identity_path(folder, failures)
    if ab:
        report["step_ab"] = step_ab(K)
    report["phase_s"] = time.perf_counter() - t_phase
    print(f"[data] phase {report['phase_s']:.1f} s", flush=True)
    return report


class _PartialRun(Exception):
    """Ends a ``--only`` run after its kernel's checks."""


# ``--only`` choices and the sources each builds (the EEG phase, the
# Inception checks and the data phase build none up front: the data
# phase's run builds K1 at its first launch; ``fid`` has no trained
# checkpoint to evaluate, so it checks and times the network alone)
ONLY = {"k1": ("conv_bn_stats.cu",),
        "attn": ("flash_attention.cu", "flash_attention_bwd.cu"),
        "k4": ("groupnorm_silu.cu",),
        "k5": ("glow_coupling.cu",),
        "k6": ("glow_flow_stack.cu", "glow_coupling.cu"),
        "eeg": (),
        "fid": (),
        "export": ("flash_attention.cu", "groupnorm_silu.cu",
                   "glow_coupling.cu"),
        "dp": ("flash_attention.cu", "flash_attention_bwd.cu",
               "groupnorm_silu.cu", "conv_bn_stats.cu", "glow_coupling.cu",
               "glow_flow_stack.cu"),
        "mp": ("glow_coupling.cu",),
        "cli": ("conv_bn_stats.cu", "flash_attention.cu",
                "flash_attention_bwd.cu", "groupnorm_silu.cu",
                "glow_coupling.cu"),
        "scan": ("conv_bn_stats.cu", "flash_attention.cu",
                 "flash_attention_bwd.cu"),
        "data": ()}
# optional packages the ``[env]`` line reports (the EEG trace PNGs and PSD
# figure need matplotlib; the port computes without any of them)
OPTIONAL_PACKAGES = ("matplotlib", "PIL", "imageio", "sklearn", "scipy")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=str, default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--only", choices=tuple(ONLY), default=None,
                    help="build, then check and time only this kernel "
                    "(k1; attn: K2 fwd, dq, dk/dv and K3; k4, with its plan, "
                    "phases and the exchange probe; k5; k6, with the "
                    "per-flow K5 path it is timed against; eeg: the EEG "
                    "phase; fid: the Inception checks and timing; export: "
                    "the serving export and data path on seeded "
                    "checkpoints; dp: data and sequence parallelism across "
                    "processes and Glow remat; mp: Glow's pipeline and "
                    "tensor parallelism; cli: K1 at the 64x64 VAE-GAN's "
                    "shapes, then the documented commands through "
                    "cli.main; scan: the epoch scan's CUDA-graph steps "
                    "against the per-step loop; data: the native gather, "
                    "its pinned staging and the batch-identity probe) with "
                    "no main path and no "
                    "result line; exit 0 if it passed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        from vgd_tpu_torch.core.rng import resolve_device
        from vgd_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              f"from the root of a checkout", file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    card = card_line()
    print(card, flush=True)
    import importlib.util
    present = {m: importlib.util.find_spec(m) is not None
               for m in OPTIONAL_PACKAGES}
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} tf32 conv "
          f"{torch.backends.cudnn.allow_tf32} matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}; optional packages "
          + " ".join(f"{m} {'yes' if ok else 'no'}"
                     for m, ok in present.items()), flush=True)
    failures = []
    report = {"optional_packages": present}
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        if args.only:
            _build.build([_build.CSRC_DIR / src for src in ONLY[args.only]])
        else:
            _build.build_all()
        report["build_s"] = time.perf_counter() - t0
        report["ptxas"] = {}
        for src, log in _build.BUILD_LOGS.items():
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    line = line.split(chr(39))[1]
                elif "registers" in line or "spill" in line:
                    line = "  " + line.strip()
                else:
                    continue
                report["ptxas"].setdefault(src, []).append(line)
                print(f"[build] {src}: {line}")
        print(f"[build] nvcc {report['build_s']:.1f} s", flush=True)
        if args.only == "k5":
            report["k5"] = check_k5(K, torch.Generator(device=dev)
                                    .manual_seed(5), dev, failures)
        elif args.only == "k6":
            report["k6"] = check_k6(K, torch.Generator(device=dev)
                                    .manual_seed(7), dev, failures)
        elif args.only == "k1":
            report["k1"] = check_k1(K, torch.Generator(device=dev)
                                    .manual_seed(0), dev, failures)
        elif args.only == "k4":
            gen = torch.Generator(device=dev).manual_seed(K4_SEED)
            report["k4"] = check_groupnorm(K, gen, dev, failures, phases=True)
            report["k4_exchange"] = k4_sync_probe(K, dev)
        elif args.only == "attn":
            gen = torch.Generator(device=dev).manual_seed(0)
            report["k2"] = check_k2(K, gen, dev, failures)
            report["k3"] = check_attention(K, gen, dev, failures)
        elif args.only == "eeg":
            report["eeg"] = eeg_path(K, failures)
        elif args.only == "fid":
            report["inception"] = check_inception(failures)
        elif args.only == "export":
            seeded_checkpoints()
            report["export"] = export_path(K, failures)
        elif args.only == "dp":
            report["dp"] = dp_path(K, failures)
        elif args.only == "mp":
            report["mp"] = mp_path(K, failures)
        elif args.only == "cli":
            report["k1"] = check_k1(K, torch.Generator(device=dev)
                                    .manual_seed(0), dev, failures,
                                    families=K1_FAMILIES[-1:], extras=False)
            report["cli"] = cli_path(K, failures)
        elif args.only == "scan":
            report["scan"] = scan_path(K, failures, adam_ab=True)
        elif args.only == "data":
            report["data"] = native_data_path(K, failures, ab=True)
        if args.only:
            raise _PartialRun
        # the data-parallel phase first: its rank processes share this card,
        # and the later phases leave tens of GB in this process's hands
        report["dp"] = dp_path(K, failures)
        report["mp"] = mp_path(K, failures)
        # the scan phase spawns two rank processes on this card as well
        report["scan"] = scan_path(K, failures)
        report["data"] = native_data_path(K, failures, report["scan"])
        gen = torch.Generator(device=dev).manual_seed(0)
        k2_rows, report["sdpa_backend"], report["k2_gate"] = check_k2(
            K, gen, dev, failures)
        attn_rows = check_attention(K, gen, dev, failures)
        # K4, the VAE-GAN and the Glow phases draw from their own
        # generators, so what one phase draws moves no other phase's inputs
        gn_rows, report["k4_main_path"] = check_groupnorm(
            K, torch.Generator(device=dev).manual_seed(K4_SEED), dev,
            failures)
        k1_rows = check_k1(K, gen, dev, failures)
        k5_rows = check_k5(K, torch.Generator(device=dev).manual_seed(5), dev,
                           failures)
        k6_rows = check_k6(K, torch.Generator(device=dev).manual_seed(7), dev,
                           failures)
        train_l, serve_l, report["main_path"] = main_path(K, gen, failures)
        mp = report["main_path"]
        print(f"[serve] fused UNet forward (B=16, 256x256) "
              f"{mp['unet_fused_ms']:.3f} ms; DDIM-50 request "
              f"{mp['serve']['sample_s']:.3f} s ({mp['serve']['sample_forwards']}"
              f" forwards, checkpoint restore included)", flush=True)
        report["vaegan"] = vaegan_path(
            K, torch.Generator(device=dev).manual_seed(VAEGAN_SEED), failures)
        report["vae"] = vae_path(
            K, torch.Generator(device=dev).manual_seed(VAE_SEED), failures)
        report["gan"] = gan_path(
            K, torch.Generator(device=dev).manual_seed(GAN_SEED), failures)
        report["glow"] = glow_path(
            K, torch.Generator(device=dev).manual_seed(6), failures)
        report["glow_stack"] = glow_stack_path(
            K, torch.Generator(device=dev).manual_seed(8), failures)
        report["eeg"] = eeg_path(K, failures)
        report["inception"] = check_inception(failures)
        report["fid_eval"] = fid_eval_path(K, report, failures)
        report["export"] = export_path(K, failures)
        report["cli"] = cli_path(K, failures)
        scan_l = report["scan"]["launches"]
        dp_l = report["dp"]["launches"]
        cli_l = report["cli"]["launches"]
        mp_l = report["mp"]["launches"]
        exp_l = report["export"]["launches"]
        fid_l = {name: sum(r["launches"].get(name, 0) for r in
                           report["fid_eval"].values() if isinstance(r, dict))
                 for name in ("flash_attention", "groupnorm_silu",
                              "glow_coupling_fwd")}
        per_step = "one 256x256 batch-16 train step"
        per_fwd = "one 256x256 batch-16 UNet forward"
        fwd_src = "vgd_tpu_torch/csrc/flash_attention.cu"
        bwd_src = "vgd_tpu_torch/csrc/flash_attention_bwd.cu"
        report["kernels"] = [
            dict(kernel_entry(name, src, f"vgd_tpu/ops/pallas_kernels.py:"
                              f"{line}", k2_rows[name],
                              train_l[name] + dp_l[name]
                              + cli_l.get(name, 0) + scan_l[name],
                              per_step),
                 launches_by_path={"train": train_l[name],
                                   "dp": dp_l[name],
                                   "cli": cli_l.get(name, 0),
                                   "scan": scan_l[name]})
            for name, src, line in (("attention_fwd", fwd_src, 218),
                                    ("attention_dq", bwd_src, 251),
                                    ("attention_dkv", bwd_src, 280))] + [
            dict(kernel_entry("flash_attention", fwd_src,
                              "vgd_tpu/ops/pallas_kernels.py:63", attn_rows,
                              serve_l["flash_attention"]
                              + fid_l["flash_attention"]
                              + exp_l["flash_attention"]
                              + dp_l["flash_attention"]
                              + cli_l.get("flash_attention", 0), per_fwd),
                 launches_by_path={
                     "serve": serve_l["flash_attention"],
                     "fid_eval": fid_l["flash_attention"],
                     "export": exp_l["flash_attention"],
                     "dp": dp_l["flash_attention"],
                     "cli": cli_l.get("flash_attention", 0)}),
            dict(kernel_entry("groupnorm_silu",
                              "vgd_tpu_torch/csrc/groupnorm_silu.cu",
                              "vgd_tpu/ops/pallas_kernels.py:193", gn_rows,
                              serve_l["groupnorm_silu"]
                              + fid_l["groupnorm_silu"]
                              + exp_l["groupnorm_silu"]
                              + dp_l["groupnorm_silu"]
                              + cli_l.get("groupnorm_silu", 0), per_fwd),
                 form="f32 in and out (the TPU kernel's function)",
                 main_path_forms=report["k4_main_path"],
                 launches_by_path={
                     "serve": serve_l["groupnorm_silu"],
                     "fid_eval": fid_l["groupnorm_silu"],
                     "export": exp_l["groupnorm_silu"],
                     "dp": dp_l["groupnorm_silu"],
                     "cli": cli_l.get("groupnorm_silu", 0)}),
            k1_entry(k1_rows, report)] + [
            dict(kernel_entry(
                name, "vgd_tpu_torch/csrc/glow_coupling.cu",
                f"vgd_tpu/ops/glow_coupling.py:{line}",
                k5_rows[name] + report["mp"]["k5_microbatch"][name],
                report["glow"]["train"]["launches_total"][name]
                + fid_l.get(name, 0) + exp_l.get(name, 0) + dp_l[name]
                + mp_l[name] + cli_l.get(name, 0),
                "one 64x64 batch-16 Glow train step (K=32, L=4)"),
                launches_by_path={
                    "train": report["glow"]["train"]["launches_total"][name],
                    "fid_eval": fid_l.get(name, 0),
                    "export": exp_l.get(name, 0), "dp": dp_l[name],
                    "mp": mp_l[name], "cli": cli_l.get(name, 0)})
            for name, line in zip(K5_NAMES, (164, 206, 266))]
        # K6's forward and backward run on the training path, its no-save
        # forward on the likelihood path (the serve phase)
        stack = report["glow_stack"]
        k6_launches = dict(stack["train"]["launches_total"])
        k6_launches[K6_NAMES[1]] = stack["serve"]["launches"][K6_NAMES[1]]
        for name, line in zip(K6_NAMES, (143, 156, 173)):
            entry = kernel_entry(
                name, "vgd_tpu_torch/csrc/glow_flow_stack.cu",
                f"vgd_tpu/ops/glow_flow_stack.py:{line}", k6_rows[name],
                k6_launches[name] + dp_l[name] + mp_l[name]
                + cli_l.get(name, 0),
                "one 64x64 batch-16 Glow likelihood forward (K=32, L=4)"
                if name == "glow_flow_stack_fwd_nosave" else
                "one 64x64 batch-16 Glow train step (K=32, L=4, flow_stack)")
            # no one PyTorch call computes a flow stack: the per-flow path
            # of the same four blocks stands beside it
            timed = [r for r in k6_rows[name] if "ms" in r]
            entry.update(library="none alone", launches_by_path={
                "main": k6_launches[name], "dp": dp_l[name],
                "mp": mp_l[name], "cli": cli_l.get(name, 0)},
                **{k: sum(r[k] for r in timed) for k in K6_PER_FLOW_KEYS})
            report["kernels"].append(entry)
        idle = [e["name"] for e in report["kernels"] if not e["launches"]]
        if idle:
            failures.append(f"kernels never launched on their main path: "
                            f"{idle}")
    except _PartialRun:
        pass
    except Exception:                      # noqa: BLE001 - report and fail
        traceback.print_exc()
        failures.append("exception (traceback above)")
    report.update(card=card, failures=failures,
                  total_s=time.perf_counter() - t_start)
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(f"[done] {report['total_s']:.1f} s", flush=True)
    if args.only:
        return 0
    print(json.dumps({"kernels": [{k: v for k, v in e.items()
                                   if k != "shapes"}
                                  for e in report["kernels"]]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
