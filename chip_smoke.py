#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``vgd_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--report PATH]

1. builds the port's kernels from the checkout's sources (CUDA with nvcc
   for sm_90a, one process per source, all at once; Triton compiles at its
   first launch);
2. holds every kernel against its plain PyTorch version on the card at
   every shape its main path gives it, with the tolerance stated below, and
   times kernel, plain version, and the one PyTorch call that computes the
   same function (timed here only, never called by the port): K2 (training
   attention: forward with logsumexp, dq, dk/dv), K3 (serving attention),
   K4 (GroupNorm+SiLU) at the 256x256, batch-16 DDPM UNet's shapes; K1
   (Conv4x4 stride 2 + batch statistics) at the 256x256, batch-64 VAE-GAN's
   nine shapes in bf16, one f32 shape and two ragged ones; K5 (step 7);
3. DDPM: holds the fused UNet forward and one training-form train step
   (loss and every gradient) against the same weights run with no kernel at
   all (``kernels.plain_reference``), and profiles both by kernel group;
4. DDPM: trains at full width (256x256, batch 16, base_ch 64, T=1000, bf16
   convs) through ``run_diffusion`` on synthetic faces: 2 epochs of 8 steps,
   a checkpoint per epoch, a resume that must restore exactly what was
   saved, and a third epoch. Every train step must launch K2 exactly 3
   times each (forward, dq, dk/dv), every validation forward 3 K2
   forwards, and K3/K4 never;
5. DDPM: serves that trained checkpoint: ``sample_from_dir`` answers a
   16-image DDIM-50 request and ``evaluate_diffusion`` restores one batch
   through the ancestral chain, with exactly 3 (K3) and 14 (K4) launches
   per UNet forward and no K2 launch;
6. VAE-GAN (256x256, batch 64, latent 100, ngf = ndf = 64, bf16 convs,
   ``fused_conv=True``): the first D step's and the G step's losses and
   gradients with K1 against the same state and draws with no kernel (in
   f32 at the DDPM step's bounds; in bf16 against the measured noise floor
   of the no-kernel step itself), the shapes K1 sees against its table,
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
8. prints a ``{"kernels": [...]}`` line, the card's name and power limit,
   and as its last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when no card is visible, when the
port cannot be imported, or when any phase fails. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, bf16
# dense on the tensor cores, HBM3
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

# K2 and K3 at 256x256, B=16: (name, B, N, M, D), once per UNet forward
# (K3, serving) or train step (K2)
ATTN_SHAPES = [("cross_attn2", 16, 16384, 64, 256),
               ("cross_attn3", 16, 4096, 64, 256),
               ("attn_bottleneck", 16, 1024, 1024, 256)]
# ragged shapes the kernels mask (checked, not timed)
ATTN_RAGGED = [("ragged", 3, 1000, 70, 256), ("ragged", 2, 129, 33, 128)]
# K4 at 256x256, B=16: (B, H, W, C, calls per UNet forward)
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
        torch.cuda.synchronize()
        ref = K.attention_plain(q, k, v, scale)
        err = float((out - ref).abs().max())
        row = {"shape": [b, n, m, d], "site": name, "max_abs_err": err,
               "max_rel_err": err / float(ref.abs().max()), "tol": ATTN_ATOL}
        if not err <= ATTN_ATOL:
            failures.append(f"flash_attention {name} {row['shape']}: "
                            f"max abs err {err} > {ATTN_ATOL}")
        if name != "ragged":
            flops = 4.0 * b * n * m * d
            nbytes = 4.0 * (2 * b * n * d + 2 * b * m * d)
            row.update(
                ms=cuda_ms(lambda: K.flash_attention(q, k, v, scale)),
                plain_ms=cuda_ms(lambda: K.attention_plain(q, k, v, scale)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=scale)),
                flop_ms=flops / F32_FLOPS * 1e3,
                byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=1)
        rows.append(row)
        print(f"[kernel] flash_attention {name} {row['shape']} "
              f"abs_err={err:.3g} rel_err={row['max_rel_err']:.3g} "
              f"tol={ATTN_ATOL} " + " ".join(
                  f"{key}={row[key]:.4f}" for key in
                  ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")
                  if key in row), flush=True)
    return rows


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
    the three training shapes and two ragged ones; per kernel a row list
    for ``kernel_entry``, timed at the training shapes."""
    import torch
    import torch.nn.functional as F
    rows = {"attention_fwd": [], "attention_dq": [], "attention_dkv": []}
    backend = None
    for name, b, n, m, d in ATTN_SHAPES + ATTN_RAGGED:
        q, k, v, do = (torch.randn(b, s, d, device=dev, generator=gen)
                       for s in (n, m, m, n))
        scale = 1.0 / math.sqrt(d)
        o, lse = K.attention_fwd_lse(q, k, v, scale)
        delta = (do * o).sum(-1)
        dq = K.attention_dq(q, k, v, do, lse, delta, scale)
        dk, dv = K.attention_dkv(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
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
        shape = [b, n, m, d]
        per = {"attention_fwd": ("o", "lse"), "attention_dq": ("dq",),
               "attention_dkv": ("dk", "dv")}
        for kname, keys in per.items():
            rows[kname].append({
                "shape": shape, "site": name,
                "max_abs_err": max(errs[x][0] for x in keys),
                "max_rel_err": max(errs[x][1] for x in keys),
                "tol": max(errs[x][2] for x in keys)})
        line = " ".join(f"{x}_err={errs[x][0]:.3g}(tol {errs[x][2]:.3g})"
                        for x in errs)
        if name != "ragged":
            bnmd, bnd, bmd, bn = b * n * m * d, b * n * d, b * m * d, b * n
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))

            def library_fwd():
                return F.scaled_dot_product_attention(q, k, v, scale=scale)

            def library_fwd_bwd():
                F.scaled_dot_product_attention(qg, kg, vg, scale=scale
                                               ).backward(do)
            if backend is None:
                backend = sdpa_backend(library_fwd_bwd)
            sdpa_ms = cuda_ms(library_fwd_bwd)
            timed = {
                "attention_fwd": dict(
                    ms=cuda_ms(lambda: K.attention_fwd_lse(q, k, v, scale)),
                    plain_ms=cuda_ms(lambda: K.attention_fwd_lse_plain(
                        q, k, v, scale)),
                    library_ms=cuda_ms(library_fwd),
                    flop_ms=4.0 * bnmd / F32_FLOPS * 1e3,
                    byte_ms=4.0 * (2 * bnd + 2 * bmd + bn)
                    / HBM_BYTES_PER_S * 1e3),
                "attention_dq": dict(
                    ms=cuda_ms(lambda: K.attention_dq(q, k, v, do, lse, delta,
                                                      scale)),
                    plain_ms=cuda_ms(lambda: K.attention_dq_plain(
                        q, k, v, do, lse, delta, scale)),
                    library_ms=None,
                    flop_ms=6.0 * bnmd / F32_FLOPS * 1e3,
                    byte_ms=4.0 * (3 * bnd + 2 * bmd + 2 * bn)
                    / HBM_BYTES_PER_S * 1e3),
                "attention_dkv": dict(
                    ms=cuda_ms(lambda: K.attention_dkv(q, k, v, do, lse,
                                                       delta, scale)),
                    plain_ms=cuda_ms(lambda: K.attention_dkv_plain(
                        q, k, v, do, lse, delta, scale)),
                    library_ms=None,
                    flop_ms=8.0 * bnmd / F32_FLOPS * 1e3,
                    byte_ms=4.0 * (2 * bnd + 4 * bmd + 2 * bn)
                    / HBM_BYTES_PER_S * 1e3)}
            for kname, extra in timed.items():
                rows[kname][-1].update(extra, calls=1,
                                       library_fwd_bwd_ms=sdpa_ms)
            line += " " + " ".join(
                f"{kname[10:]}: ms={t['ms']:.4f} plain={t['plain_ms']:.4f} "
                f"bound={max(t['flop_ms'], t['byte_ms']):.4f};"
                for kname, t in timed.items())
            line += f" library(SDPA fwd+bwd)={sdpa_ms:.4f}"
        print(f"[kernel] K2 {name} {shape} {line}", flush=True)
    print(f"[kernel] K2 yardstick: SDPA f32 forward+backward ran "
          f"{backend}", flush=True)
    return rows, backend


def check_groupnorm(K, gen, dev, failures):
    import torch
    import torch.nn.functional as F
    rows = []
    for b, h, w, c, calls in GN_SHAPES + [(2, 7, 9, 24, 0)]:
        x = torch.randn(b, h, w, c, device=dev, generator=gen) * 2.0 + 0.5
        scale = 1.0 + 0.1 * torch.randn(c, device=dev, generator=gen)
        bias = 0.1 * torch.randn(c, device=dev, generator=gen)
        out = K.groupnorm_silu(x, scale, bias, 8)
        torch.cuda.synchronize()
        ref = K.groupnorm_silu_plain(x, scale, bias, 8)
        err = float((out - ref).abs().max())
        row = {"shape": [b, h, w, c], "max_abs_err": err,
               "max_rel_err": err / float(ref.abs().max()), "tol": GN_ATOL}
        if not err <= GN_ATOL:
            failures.append(f"groupnorm_silu {row['shape']}: max abs err "
                            f"{err} > {GN_ATOL}")
        if calls:
            nbytes = 4.0 * (2 * b * h * w * c + 2 * c)
            # ~12 operations per element: statistics, normalise, affine, SiLU
            flops = 12.0 * b * h * w * c

            def library():
                y = F.group_norm(x.permute(0, 3, 1, 2), 8, scale, bias, 1e-5)
                return F.silu(y)
            row.update(
                ms=cuda_ms(lambda: K.groupnorm_silu(x, scale, bias, 8)),
                plain_ms=cuda_ms(
                    lambda: K.groupnorm_silu_plain(x, scale, bias, 8)),
                library_ms=cuda_ms(library),
                flop_ms=flops / F32_FLOPS * 1e3,
                byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=calls)
        rows.append(row)
        print(f"[kernel] groupnorm_silu {row['shape']} abs_err={err:.3g} "
              f"rel_err={row['max_rel_err']:.3g} tol={GN_ATOL} " +
              " ".join(f"{key}={row[key]:.4f}" for key in
                       ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")
                       if key in row), flush=True)
    return rows


def check_k1(K, gen, dev, failures):
    """K1 against its plain version at the nine main-path shapes (bf16) and
    at K1_EXTRA: c, mean, var, and y = bn_lrelu of each; the main-path
    shapes timed as kernel, plain version and the library yardstick (cuDNN
    conv2d in bf16 on channels_last input, then torch.var_mean)."""
    import torch
    import torch.nn.functional as F
    from vgd_tpu_torch.ops.fused_conv import bn_lrelu
    rows = []
    extra = [(n, b, h, w, ci, k, p, 0, dt) for n, b, h, w, ci, k, p, dt
             in K1_EXTRA]
    for site, b, h, w, cin, k, pad, calls, *dt in \
            [s_ + ("bfloat16",) for s_ in K1_SHAPES] + extra:
        dtype = getattr(torch, dt[0])
        x = torch.randn(b, h, w, cin, device=dev, generator=gen).to(dtype)
        wt = (torch.randn(k, cin, 4, 4, device=dev, generator=gen)
              * (2.0 / (16 * cin)) ** 0.5).to(dtype)
        gamma = 1.0 + 0.02 * torch.randn(k, device=dev, generator=gen)
        beta = 0.02 * torch.randn(k, device=dev, generator=gen)
        c, mean, var = K.conv_stats(x, wt, pad)
        torch.cuda.synchronize()
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
            failures.append(f"K1 {site} {shape} {dt[0]}: errors {errs}")
        row = {"shape": shape, "site": site, "dtype": dt[0],
               "max_abs_err": max(errs.values()),
               "max_rel_err": errs["c"] / float(rc.abs().max()),
               "errors": errs, "tol": f"c {K1_C_REL} x max|c|, mean/var "
               f"rtol {K1_STAT_RTOL} atol {K1_STAT_ATOL}, y {K1_Y_REL} x "
               f"max|y| + {K1_Y_ATOL}"}
        if calls:
            ho, wo = c.shape[1], c.shape[2]
            m = b * ho * wo
            flops = 2.0 * m * k * 16 * cin
            nbytes = 2.0 * (b * h * w * cin + 16 * cin * k) + 4.0 * m * k \
                + 8.0 * k
            xc = x.permute(0, 3, 1, 2)            # channels_last view

            def library():
                o = F.conv2d(xc, wt, stride=2, padding=pad)
                return torch.var_mean(o, dim=(0, 2, 3), correction=0)
            row.update(
                ms=cuda_ms(lambda: K.conv_stats(x, wt, pad)),
                plain_ms=cuda_ms(lambda: K.conv_stats_plain(x, wt, pad)),
                library_ms=cuda_ms(library),
                flop_ms=flops / BF16_FLOPS * 1e3,
                byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=calls)
        rows.append(row)
        print(f"[kernel] K1 {site} {shape} {dt[0]} " + " ".join(
            f"{n}_err={e:.3g}" for n, e in errs.items()) + " " + " ".join(
            f"{key}={row[key]:.4f}" for key in
            ("ms", "plain_ms", "library_ms", "flop_ms", "byte_ms")
            if key in row) + ("" if ok else " FAIL"), flush=True)
    timed = [r for r in rows if "ms" in r]
    print(f"[kernel] K1 per train step ({K1_PER_STEP} launches): kernel "
          f"{sum(r['ms'] * r['calls'] for r in timed):.3f} ms, plain "
          f"{sum(r['plain_ms'] * r['calls'] for r in timed):.3f} ms, library "
          f"(cuDNN conv2d bf16 channels_last + torch.var_mean) "
          f"{sum(r['library_ms'] * r['calls'] for r in timed):.3f} ms, bound "
          f"{sum(max(r['flop_ms'], r['byte_ms']) * r['calls'] for r in timed):.3f}"
          f" ms (bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
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
    entry = {"name": name, "route": "cuda" if source.endswith(".cu")
             else "triton", "source": source, "replaces": replaces,
             "launches": launches,
             "max_abs_err": max(r["max_abs_err"] for r in rows),
             "max_rel_err": max(r["max_rel_err"] for r in rows),
             "ms": total("ms"), "plain_ms": total("plain_ms"),
             "bound_ms": by_ops + by_bytes,
             "bound_by": "operations" if by_ops >= by_bytes else "bytes",
             "library_ms": total("library_ms"), "per": per, "shapes": rows}
    if "library_fwd_bwd_ms" in timed[0]:
        entry["library_fwd_bwd_ms"] = total("library_fwd_bwd_ms")
    return entry


def check_unet(K, trainer, gen, failures):
    """Fused UNet (kernels) against the same weights with no kernel
    (``plain_reference``) at B=2; then both timed at B=16, and one fused
    forward profiled by kernel group."""
    import torch
    model = trainer.model_fused
    dev = trainer.device
    (h, w), b = trainer.cfg.data.image_size, trainer.cfg.data.batch_size
    x = torch.randn(2, h, w, 3, device=dev, generator=gen)
    t = torch.tensor([trainer.cfg.timesteps - 1, 17], dtype=torch.int32,
                     device=dev)
    with torch.inference_mode():
        fused_out = model(x, t)
        with K.plain_reference():
            ref = model(x, t)
    err = float((fused_out - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"[unet] fused vs no-kernel reference, B=2 {h}x{w}: max abs err "
          f"{err:.4g}, max |reference| {scale:.4g}, tol {UNET_REL_TOL} x "
          f"max |reference|", flush=True)
    if not (torch.isfinite(fused_out).all() and err <= UNET_REL_TOL * scale):
        failures.append(f"fused UNet disagrees with its no-kernel reference:"
                        f" {err} > {UNET_REL_TOL} x {scale}")
    x = torch.randn(b, h, w, 3, device=dev, generator=gen)
    t = torch.full((b,), 500, dtype=torch.int32, device=dev)

    def plain():
        with K.plain_reference():
            model(x, t)
    with torch.inference_mode():
        stats = {"unet_fused_ms": cuda_ms(lambda: model(x, t), 2, 10),
                 "unet_plain_ms": cuda_ms(plain, 2, 10)}
        stats["forward_profile"] = profile_fn(
            lambda: model(x, t), stats["unet_fused_ms"], FORWARD_GROUPS,
            "profile")
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
    if launches != {k: 3 for k in K2_NAMES}:
        failures.append(f"train step launched {launches}, want 3 of each")
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
    stats["train_step_profile"] = profile_fn(step, stats["train_step_ms"],
                                             TRAIN_GROUPS, "profile-train")
    print(f"[train-step] forward+backward B={b} {h}x{w}: K2 "
          f"{stats['fwd_bwd_ms']:.3f} ms, no-kernel reference "
          f"{stats['fwd_bwd_plain_ms']:.3f} ms; whole train step "
          f"{stats['train_step_ms']:.3f} ms", flush=True)
    return stats


K2_NAMES = ("attention_fwd", "attention_dq", "attention_dkv")
# device kernels grouped by name (first match wins)
FORWARD_GROUPS = [("flash_attention (K3)", ("flash_fwd_kernel",)),
                  ("groupnorm_silu (K4)", ("_gn_",)),
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


def profile_fn(fn, wall_ms, groups, tag):
    """Device kernel time of one call of ``fn`` by kernel and by group
    (torch.profiler), and the device's busy share: summed kernel time over
    the CUDA-event time of a call."""
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
    by_group = {}
    for name, ms, _ in rows:
        low = name.lower()
        group = next((g for g, keys in groups
                      if any(k in low for k in keys)), "other elementwise")
        by_group[group] = by_group.get(group, 0.0) + ms
    for group, ms in sorted(by_group.items(), key=lambda g: -g[1]):
        print(f"[{tag}] {ms:8.3f} ms {100 * ms / total:5.1f}%  {group}",
              flush=True)
    for name, ms, count in rows[:10]:
        print(f"[{tag}]   {ms:8.3f} ms x{count:<4d} {name[:80]}", flush=True)
    print(f"[{tag}] kernel time {total:.3f} ms of a {wall_ms:.3f} ms call: "
          f"device busy share {total / wall_ms:.3f}", flush=True)
    return {"kernel_ms": total, "groups": by_group,
            "top": [list(r) for r in rows[:10]]}


def check_launches(K, want, what, failures):
    got = {k: K.LAUNCHES[k] for k in want}
    print(f"[{what}] launches {got}", flush=True)
    if got != want:
        failures.append(f"{what}: launches {got} != {want}")
    return got


def serving_launches(forwards):
    return {"flash_attention": 3 * forwards, "groupnorm_silu": 14 * forwards,
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


def train_path(K, cfg, init_params, failures):
    """``run_diffusion`` for TRAIN_EPOCHS epochs of TRAIN_STEPS steps, a
    resume that runs no epoch (it must restore exactly what was saved),
    and a resume that trains one more epoch. Launch counts of each run are
    read from zero."""
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.diffusion import DiffusionTrainer
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
        res = L.run_diffusion(cfg, epochs=TRAIN_EPOCHS,
                              max_steps_per_epoch=TRAIN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        trainer = res["trainer"]
        steps = len(step_events)
        evals = trainer.model.forwards - steps
        launches = check_launches(K, {
            "attention_fwd": 3 * (steps + evals), "attention_dq": 3 * steps,
            "attention_dkv": 3 * steps, "flash_attention": 0,
            "groupnorm_silu": 0}, "train", failures)
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
        res = L.run_diffusion(cfg, epochs=TRAIN_EPOCHS + 1,
                              max_steps_per_epoch=TRAIN_STEPS, resume=True,
                              device="cuda")
        steps3 = len(step_events)
        evals3 = res["trainer"].model.forwards - steps3
        got = check_launches(K, {
            "attention_fwd": 3 * (steps3 + evals3), "attention_dq": 3 * steps3,
            "attention_dkv": 3 * steps3, "flash_attention": 0,
            "groupnorm_silu": 0}, "train-resumed", failures)
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
# (the reference against itself with c * (1 + 2^-23 N(0, 1))).
VAEGAN_GRAD_REL, VAEGAN_GRAD_FLOOR, VAEGAN_LOSS_REL = 5e-2, 1e-4, 1e-3
VAEGAN_FLOOR_X = 3.0
VAEGAN_GROUPS = [("K1 conv + batch statistics", ("conv_stats_kernel",
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


def vaegan_step_grads(trainer, x, eps, nr, nf):
    """Losses and gradients of the first D step and of the G step of one
    train step (as ``train_step`` computes them, without the Adam
    updates)."""
    import torch
    from vgd_tpu_torch.models.blocks import frozen_running_stats
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


def compare_step(got, ref):
    """(worst gradient error over its bound, that gradient's name, largest
    relative loss difference) of two ``vaegan_step_grads`` results."""
    (lk, dk, gk), (lr, dr, gr) = got, ref
    worst = (0.0, "")
    for g_all, r_all in ((dk, dr), (gk, gr)):
        top = max(float(g.abs().max()) for g in r_all.values())
        for name, r in r_all.items():
            err = float((g_all[name] - r).abs().max())
            bound = VAEGAN_GRAD_REL * float(r.abs().max()) + \
                VAEGAN_GRAD_FLOOR * top
            worst = max(worst, (err / bound, name))
    loss_rel = max(abs(lk[k] - lr[k]) / abs(lr[k]) for k in lr)
    return worst[0], worst[1], loss_rel


def check_vaegan_step(K, cfg, gen, failures):
    """The first D step's and the G step's losses and gradients with K1
    against the same state and draws with no kernel
    (``kernels.plain_reference``): in f32 at the DDPM step's bounds, in
    bf16 against the measured noise floor; the shapes K1 sees in one bf16
    step against K1_SHAPES; then one whole bf16 train step timed and
    profiled."""
    import dataclasses
    import torch
    from vgd_tpu_torch.ops.image import to_signed
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size
    stats = {}
    plain = K.conv_stats_plain

    def perturbed(xx, ww, pad):
        c, m, v = plain(xx, ww, pad)
        g = torch.Generator(device=c.device).manual_seed(123)
        return c * (1 + 2.0 ** -23 * torch.randn(
            c.shape, device=c.device, generator=g)), m, v

    for dtype in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, compute_dtype=dtype))
        trainer = VAEGANTrainer(dcfg, (h, w, 3), device="cuda")
        dev = trainer.device
        trainer.init(torch.Generator(device=dev).manual_seed(cfg.run.seed))
        if dtype == "float32":
            n_params = {n: sum(p.numel() for p in net.parameters())
                        for n, net in trainer.nets().items()}
            print(f"[vaegan-init] {h}x{w} B={b} latent {cfg.latent_dim} ngf "
                  f"{cfg.ngf} ndf {cfg.ndf} fused_conv {cfg.run.fused_conv};"
                  f" parameters {n_params}", flush=True)
        batch = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8,
                              device=dev, generator=gen)
        x = to_signed(batch)
        eps = torch.randn(b, cfg.latent_dim, device=dev, generator=gen)
        nr = torch.randn(b, h, w, 3, device=dev, generator=gen)
        nf = torch.randn(b, h, w, 3, device=dev, generator=gen)
        state = {k: v.clone() for k, v in trainer.state_dict().items()}
        seen = []
        conv_stats = K.conv_stats

        def recording(xx, ww, pad):
            seen.append((tuple(xx.shape), tuple(ww.shape[:2]), pad))
            return conv_stats(xx, ww, pad)
        K.conv_stats = recording
        try:
            K.LAUNCHES.clear()
            kern = vaegan_step_grads(trainer, x, eps, nr, nf)
            launches = K.LAUNCHES["conv_bn_stats"]
        finally:
            K.conv_stats = conv_stats
        runs = {}
        for name, fn in (("plain", plain), ("plain_perturbed", perturbed)):
            if dtype == "float32" and name == "plain_perturbed":
                continue
            trainer.load(state)
            K.LAUNCHES.clear()
            K.conv_stats_plain = fn
            try:
                with K.plain_reference():
                    runs[name] = vaegan_step_grads(trainer, x, eps, nr, nf)
            finally:
                K.conv_stats_plain = plain
            if sum(K.LAUNCHES.values()):
                failures.append(f"vaegan step: the no-kernel reference "
                                f"launched {dict(K.LAUNCHES)}")
        want = {((bb, hh, ww, ci), (kk, ci), p) for _, bb, hh, ww, ci, kk,
                p, _ in K1_SHAPES}
        if set(seen) != want or launches != 23:
            failures.append(f"vaegan step {dtype}: K1 saw "
                            f"{sorted(set(seen))} in {launches} launches, want"
                            f" the K1_SHAPES in 23 (first D step 10, recon0 "
                            f"4, G step 9)")
        worst, wname, loss_rel = compare_step(kern, runs["plain"])
        row = {"worst_err_over_bound": worst, "worst_tensor": wname,
               "loss_rel": loss_rel, "k1_launches": launches,
               "losses": kern[0], "losses_ref": runs["plain"][0]}
        line = (f"[vaegan-step] {dtype} K1 vs no-kernel reference, B={b} "
                f"{h}x{w}: losses " + " ".join(
                    f"{k} {kern[0][k]:.6f}/{runs['plain'][0][k]:.6f}"
                    for k in kern[0]) + f"; worst gradient err/bound "
                f"{worst:.3f} ({wname}), largest loss difference "
                f"{loss_rel:.3g} relative; K1 launches {launches} at "
                f"{len(set(seen))} shapes")
        if dtype == "float32":
            if not (worst <= 1.0 and loss_rel <= VAEGAN_LOSS_REL):
                failures.append(f"vaegan step f32: K1 vs reference {row}")
        else:
            fworst, fname, floss = compare_step(runs["plain_perturbed"],
                                                runs["plain"])
            row.update(floor_worst_err_over_bound=fworst,
                       floor_worst_tensor=fname, floor_loss_rel=floss)
            line += (f"; noise floor (reference vs itself, c perturbed by "
                     f"one f32 ulp): worst {fworst:.3f} ({fname}), loss "
                     f"{floss:.3g}; held at the f32 bounds or {VAEGAN_FLOOR_X} x the "
                     f"floor, whichever is larger")
            # the f32 bounds, widened to VAEGAN_FLOOR_X x the floor where
            # the floor itself exceeds them
            if not (worst <= max(1.0, VAEGAN_FLOOR_X * fworst)
                    and loss_rel <= max(VAEGAN_LOSS_REL,
                                        VAEGAN_FLOOR_X * floss)):
                failures.append(f"vaegan step bf16: K1 vs reference {row}")
        print(line, flush=True)
        stats[f"step_{dtype}"] = row
        del kern, runs
        if dtype == "float32":
            del trainer
            torch.cuda.empty_cache()
    trainer.load(state)

    def step():
        trainer.train_step(batch, 1.0, eps=eps, noise_real=nr, noise_fake=nf)

    def plain_step():
        with K.plain_reference():
            step()
    stats.update(train_step_ms=cuda_ms(step, 2, 5),
                 train_step_plain_ms=cuda_ms(plain_step, 2, 5))
    stats["train_step_profile"] = profile_fn(
        step, stats["train_step_ms"], VAEGAN_GROUPS, "profile-vaegan")
    print(f"[vaegan-step] whole bf16 train step B={b} {h}x{w}: K1 "
          f"{stats['train_step_ms']:.3f} ms, no-kernel reference "
          f"{stats['train_step_plain_ms']:.3f} ms", flush=True)
    return stats


def vaegan_train_path(K, cfg, failures):
    """``run_vaegan`` for VAEGAN_EPOCHS epochs of VAEGAN_STEPS steps, a
    resume that runs no epoch (it must restore exactly what was saved), and
    a resume that trains one more epoch. Launch counts are read from zero
    around each run and per train step, validation pass and generate."""
    import torch
    from vgd_tpu_torch.io.checkpoint import Checkpointer
    from vgd_tpu_torch.train import loop as L
    from vgd_tpu_torch.train.vaegan import VAEGANTrainer
    calls = {"train_step": [], "eval_step": [], "generate": []}
    originals = {n: getattr(VAEGANTrainer, n) for n in calls}

    def wrap(name):
        fn = originals[name]

        def counted(self, *args, **kwargs):
            before = K.LAUNCHES["conv_bn_stats"]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kwargs)
            end.record()
            calls[name].append((K.LAUNCHES["conv_bn_stats"] - before,
                                start, end, out))
            return out
        return counted

    for n in calls:
        setattr(VAEGANTrainer, n, wrap(n))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.LAUNCHES.clear()
        t0 = time.perf_counter()
        res = L.run_vaegan(cfg, epochs=VAEGAN_EPOCHS,
                           max_steps_per_epoch=VAEGAN_STEPS, device="cuda")
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        total = K.LAUNCHES["conv_bn_stats"]
        trainer = res["trainer"]
        per = {n: [c[0] for c in v] for n, v in calls.items()}
        steps = len(per["train_step"])
        step_ms = sorted(s.elapsed_time(e) for _, s, e, _ in
                         calls["train_step"][1:])
        bad = [i for i, (*_, m) in enumerate(calls["train_step"])
               if not all(math.isfinite(float(v)) for v in m.values())]
        if bad:
            failures.append(f"vaegan-train: non-finite losses from step "
                            f"{bad[0]}: {calls['train_step'][bad[0]][3]}")
        stats = {"train_steps": steps, "train_run_s": train_s,
                 "k1_launches": total,
                 "k1_per_step": sorted(set(per["train_step"])),
                 "k1_in_eval": sum(per["eval_step"]),
                 "k1_in_generate": sum(per["generate"]),
                 "step_ms_median": step_ms[len(step_ms) // 2],
                 "step_ms_min": step_ms[0], "step_ms_max": step_ms[-1],
                 "images_per_sec_median_step":
                     cfg.data.batch_size / step_ms[len(step_ms) // 2] * 1e3,
                 "log": res["log"], "val_rows": res["val_rows"],
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[vaegan-train] launches: K1 {total} in {steps} train steps "
              f"(per step {stats['k1_per_step']}), {len(per['eval_step'])} "
              f"validation batches {stats['k1_in_eval']}, "
              f"{len(per['generate'])} generate calls "
              f"{stats['k1_in_generate']}; all launches "
              f"{dict(K.LAUNCHES)}", flush=True)
        if (steps != VAEGAN_EPOCHS * VAEGAN_STEPS
                or stats["k1_per_step"] != [K1_PER_STEP]
                or stats["k1_in_eval"] or stats["k1_in_generate"]
                or total != K1_PER_STEP * steps
                or set(K.LAUNCHES) - {"conv_bn_stats"}):
            failures.append(f"vaegan-train: {steps} steps, K1 per step "
                            f"{stats['k1_per_step']}, eval "
                            f"{stats['k1_in_eval']}, generate "
                            f"{stats['k1_in_generate']}, all "
                            f"{dict(K.LAUNCHES)}")
        keys = ("train_recon", "train_kl", "train_adv", "train_d_loss",
                "val_loss", "ssim", "psnr")
        if not all(math.isfinite(r[k]) for r in res["log"] for k in keys):
            failures.append(f"vaegan-train: non-finite metrics {res['log']}")
        if res["val_rows"] != res["val"].num_examples:
            failures.append(f"vaegan-train: val rows {res['val_rows']} of "
                            f"{res['val'].num_examples}")
        for r in res["log"]:
            print(f"[vaegan-train] epoch {int(r['epoch']) + 1}: " + " ".join(
                f"{k} {r[k]:.5f}" for k in keys) +
                f" images/s {r['images_per_sec']:.1f}", flush=True)
        print(f"[vaegan-train] {steps} steps; step ms median "
              f"{stats['step_ms_median']:.3f} (min {step_ms[0]:.3f}, max "
              f"{step_ms[-1]:.3f}) after the first = "
              f"{stats['images_per_sec_median_step']:.1f} images/s; peak "
              f"memory {stats['peak_mem_gb']:.3f} GB", flush=True)

        # a resume with no epoch left restores, and must equal what was saved
        final = {k: v.clone() for k, v in trainer.state_dict().items()}
        payload = Checkpointer(f"{cfg.run.out_dir}/ckpt").load()
        K.LAUNCHES.clear()
        back = L.run_vaegan(cfg, epochs=VAEGAN_EPOCHS, resume=True,
                            device="cuda")["trainer"]
        same_params = all(torch.equal(final[k], v) and
                          torch.equal(payload["params"][k], v.cpu())
                          for k, v in back.state_dict().items())
        same_opt = True
        for name in ("encoder", "decoder", "disc"):
            sa = trainer.opts[name].state_dict()["state"]
            sb = back.opts[name].state_dict()["state"]
            same_opt &= sa.keys() == sb.keys() and all(
                torch.equal(sa[i][x].cpu(), sb[i][x].cpu())
                for i in sa for x in ("step", "exp_avg", "exp_avg_sq"))
        ok = (same_params and same_opt and payload["step"] == VAEGAN_EPOCHS
              and back.step == steps == payload["opt_step"]
              and sum(K.LAUNCHES.values()) == 0)
        print(f"[vaegan-resume] checkpoint epoch {payload['step']}, optimizer"
              f" steps {back.step}: params and BN buffers equal "
              f"{same_params}, three Adam states equal {same_opt}",
              flush=True)
        if not ok:
            failures.append("vaegan resume did not restore what was saved")
        del back, trainer, res, final
        torch.cuda.empty_cache()

        for v in calls.values():
            v.clear()
        K.LAUNCHES.clear()
        res = L.run_vaegan(cfg, epochs=VAEGAN_EPOCHS + 1,
                           max_steps_per_epoch=VAEGAN_STEPS, resume=True,
                           device="cuda")
        steps3 = len(calls["train_step"])
        got = K.LAUNCHES["conv_bn_stats"]
        row = res["log"][-1]
        print(f"[vaegan-train] resumed epoch {int(row['epoch']) + 1}: " +
              " ".join(f"{k} {row[k]:.5f}" for k in keys) +
              f"; K1 launches {got} in {steps3} steps", flush=True)
        if not (res["trainer"].step == steps + steps3 == 3 * VAEGAN_STEPS
                and got == K1_PER_STEP * steps3
                and int(row["epoch"]) == VAEGAN_EPOCHS
                and all(math.isfinite(row[k]) for k in keys)):
            failures.append(f"vaegan resumed epoch: {res['log']}, step "
                            f"{res['trainer'].step}, K1 launches {got}")
        stats["resumed_log"] = res["log"]
        stats["k1_launches"] = total + got
    finally:
        for n, fn in originals.items():
            setattr(VAEGANTrainer, n, fn)
    return stats


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
# checked, not timed: one f32 shape and two ragged ones (odd sizes, channel
# counts no tile divides)
K5_EXTRA = [("f32", 16, 16, 16, 12, 512, "float32"),
            ("ragged", 3, 7, 5, 5, 40, "bfloat16"),
            ("ragged", 2, 9, 13, 11, 72, "bfloat16")]
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
GLOW_GROUPS = [("K5 (glow_gemm_kernel, split and column sums, zeroconv "
                "grad)", ("glow_",)),
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


def check_k5(K, gen, dev, failures):
    """K5 forward, backward 1 and backward 2 against their plain versions at
    the four Glow shapes (bf16) and K5_EXTRA (backward 2 fed the plain h1 and
    dh2); the Glow shapes timed as kernel, plain version and the library
    yardstick: the cuDNN bf16 channels_last chain (conv2d, ReLU, conv2d,
    ReLU, value-1 pad, conv2d, x exp) for the forward, autograd of that chain
    for forward + backward."""
    import torch
    import torch.nn.functional as F
    rows = {n: [] for n in K5_NAMES}
    khw, pad = (3, 3), (1, 1)
    for site, b, h, w, cin, f, calls, *dt in \
            [s_ + ("bfloat16",) for s_ in K5_SHAPES] + \
            [(n, b, h, w, c, f, 0, d) for n, b, h, w, c, f, d in K5_EXTRA]:
        dtype = getattr(torch, dt[0])
        raw, p = k5_operands(dev, gen, b, h, w, cin, f, dtype)
        rel, atol = ((K5_F32_REL, 0.0) if dtype == torch.float32
                     else (K5_BF16_REL, K5_BF16_ATOL))
        fa = (p["ya"], p["w1f"], raw["b1"], p["w2"], raw["b2"], p["wz"])
        b1a = fa + (p["wzf"], raw["bz"], raw["scale"], raw["g"], khw, pad)
        out = K.glow_coupling_fwd(*fa, raw["bz"], raw["scale"], khw, pad)
        got1 = K.glow_coupling_bwd1(*b1a)
        torch.cuda.synchronize()
        ref = K.glow_coupling_fwd_plain(*fa, raw["bz"], raw["scale"], khw,
                                        pad)
        ref1 = K.glow_coupling_bwd1_plain(*b1a)
        b2a = (p["ya"], p["w1t"], p["w2t"], ref1[0], ref1[1], khw, pad)
        got2 = K.glow_coupling_bwd2(*b2a)
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
            fwd_bwd_ms = cuda_ms(library_fwd_bwd)
            timed = {
                "glow_coupling_fwd": (
                    lambda: K.glow_coupling_fwd(*fa, raw["bz"], raw["scale"],
                                                khw, pad),
                    lambda: K.glow_coupling_fwd_plain(
                        *fa, raw["bz"], raw["scale"], khw, pad),
                    cuda_ms(library_fwd)),
                "glow_coupling_bwd1": (
                    lambda: K.glow_coupling_bwd1(*b1a),
                    lambda: K.glow_coupling_bwd1_plain(*b1a), None),
                "glow_coupling_bwd2": (
                    lambda: K.glow_coupling_bwd2(*b2a),
                    lambda: K.glow_coupling_bwd2_plain(*b2a), None)}
            for kname, (kern, plain, lib) in timed.items():
                ops, nbytes = work[kname]
                rows[kname][-1].update(
                    ms=cuda_ms(kern), plain_ms=cuda_ms(plain, 2, 5),
                    library_ms=lib, library_fwd_bwd_ms=fwd_bwd_ms,
                    flop_ms=ops / BF16_FLOPS * 1e3,
                    byte_ms=nbytes / HBM_BYTES_PER_S * 1e3, calls=calls)
                r = rows[kname][-1]
                line.append(
                    f"{kname[14:]}: ms={r['ms']:.4f} plain={r['plain_ms']:.4f}"
                    f" bound={max(r['flop_ms'], r['byte_ms']):.4f} "
                    f"({100 * max(r['flop_ms'], r['byte_ms']) / r['ms']:.1f}"
                    f" % of it)")
            line.append(f"library fwd={timed['glow_coupling_fwd'][2]:.4f} "
                        f"fwd+bwd={fwd_bwd_ms:.4f}")
        print(f"[kernel] K5 {site} {shape} {dt[0]} " + "; ".join(line),
              flush=True)
        del raw, p, out, got1, got2, ref, ref1, ref2
    totals = {k: {key: sum(r[key] * r["calls"] for r in v if "ms" in r)
                  for key in ("ms", "plain_ms", "flop_ms", "byte_ms")}
              for k, v in rows.items()}
    print("[kernel] K5 per train step (128 launches of each): " + "; ".join(
        f"{k[14:]} kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
        f"bound {max(t['flop_ms'], t['byte_ms']):.3f} ms" for k, t in
        totals.items()) + f" (bf16 {BF16_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)", flush=True)
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


def check_glow_step(K, cfg, gen, failures):
    """One full-width train step with K5 against the same state, batch and
    noise with no kernel (``kernels.plain_reference``): the loss and every
    gradient, in f32 at the DDPM step's bounds and in bf16 at the larger of
    those and VAEGAN_FLOOR_X times the no-kernel step's own noise floor
    (its coupling outputs perturbed by one f32 ulp), measured here. The
    state: the seeded init, the ActNorm init on the batch, and ZeroConvs
    set to 0.01 N(0, 1) (at init they are zero and the conv1 / conv2
    gradients with them). Then one bf16 train step timed both ways and
    profiled."""
    import dataclasses
    import torch
    from vgd_tpu_torch.train.glow import GlowTrainer
    (h, w), b = cfg.data.image_size, cfg.data.batch_size
    stats = {}
    plain = K.glow_coupling_fwd_plain

    def perturbed(*args):
        out = plain(*args)
        g = torch.Generator(device=out.device).manual_seed(123)
        return out * (1 + 2.0 ** -23 * torch.randn(
            out.shape, device=out.device, generator=g))

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
        init_launches = {k: K.LAUNCHES[k] for k in K5_NAMES}
        with torch.no_grad():
            for blk in trainer.model.blocks():
                zw = blk.flows.coupling.zero.w
                zw.copy_(0.01 * torch.randn(zw.shape, device=dev,
                                            generator=gen))
        if dtype == "float32":
            n_params = sum(p.numel() for p in trainer.model.parameters())
            stats["n_params"] = n_params
            print(f"[glow-init] {h}x{w} B={b} K={cfg.n_flows} L="
                  f"{cfg.n_blocks} width {cfg.filter_size}: {n_params} "
                  f"parameters; init_step launches {init_launches}",
                  flush=True)
        if init_launches != {"glow_coupling_fwd": K5_PER_STEP,
                             "glow_coupling_bwd1": 0,
                             "glow_coupling_bwd2": 0}:
            failures.append(f"glow init_step {dtype}: launches "
                            f"{init_launches}")
        K.LAUNCHES.clear()
        kern = glow_step_grads(trainer, batch, noise)
        launches = {k: K.LAUNCHES[k] for k in K5_NAMES}
        if launches != dict.fromkeys(K5_NAMES, K5_PER_STEP) or \
                set(K.LAUNCHES) - set(K5_NAMES):
            failures.append(f"glow step {dtype}: launches {dict(K.LAUNCHES)}"
                            f", want {K5_PER_STEP} of each K5 kind only")
        runs = {}
        for name, fn in (("plain", plain), ("plain_perturbed", perturbed)):
            if dtype == "float32" and name == "plain_perturbed":
                continue
            K.LAUNCHES.clear()
            K.glow_coupling_fwd_plain = fn
            try:
                with K.plain_reference():
                    runs[name] = glow_step_grads(trainer, batch, noise)
            finally:
                K.glow_coupling_fwd_plain = plain
            if sum(K.LAUNCHES.values()):
                failures.append(f"glow step: the no-kernel reference "
                                f"launched {dict(K.LAUNCHES)}")
        worst, wname, loss_rel = compare_glow_step(kern, runs["plain"])
        row = {"worst_err_over_bound": worst, "worst_tensor": wname,
               "loss_rel": loss_rel, "launches": launches,
               "loss": kern[0], "loss_ref": runs["plain"][0]}
        line = (f"[glow-step] {dtype} K5 vs no-kernel reference, B={b} "
                f"{h}x{w}: loss {kern[0]:.6f} / {runs['plain'][0]:.6f}; "
                f"{len(kern[1])} gradients, worst err/bound {worst:.3f} "
                f"({wname}), loss difference {loss_rel:.3g} relative; "
                f"launches {launches}")
        if dtype == "float32":
            if not (worst <= 1.0 and loss_rel <= STEP_LOSS_REL):
                failures.append(f"glow step f32: K5 vs reference {row}")
        else:
            fworst, fname, floss = compare_glow_step(runs["plain_perturbed"],
                                                     runs["plain"])
            row.update(floor_worst_err_over_bound=fworst,
                       floor_worst_tensor=fname, floor_loss_rel=floss)
            line += (f"; noise floor (reference vs itself, coupling outputs "
                     f"perturbed by one f32 ulp): worst {fworst:.3f} "
                     f"({fname}), loss {floss:.3g}; held at the f32 bounds "
                     f"or {VAEGAN_FLOOR_X} x the floor, whichever is larger")
            if not (worst <= max(1.0, VAEGAN_FLOOR_X * fworst)
                    and loss_rel <= max(STEP_LOSS_REL,
                                        VAEGAN_FLOOR_X * floss)):
                failures.append(f"glow step bf16: K5 vs reference {row}")
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
    stats["train_step_profile"] = profile_fn(
        step, stats["train_step_ms"], GLOW_GROUPS, "profile-glow")
    print(f"[glow-step] whole bf16 train step B={b} {h}x{w}: K5 "
          f"{stats['train_step_ms']:.3f} ms, no-kernel reference "
          f"{stats['train_step_plain_ms']:.3f} ms", flush=True)
    return stats


def glow_train_path(K, cfg, failures):
    """``run_glow`` for GLOW_ITERS iterations (a grid and a checkpoint every
    GLOW_EVERY), a resume that runs no iteration (it must restore exactly
    what was saved), and a resume that trains GLOW_EVERY more from the
    right place in the stream. K5 launches are read per train step, per
    ``init_step`` and per ``reverse``."""
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
            before = {k: K.LAUNCHES[k] for k in K5_NAMES}
            if name == "train_step":
                fed.append(args[0].clone())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kwargs)
            end.record()
            calls[name].append((tuple(K.LAUNCHES[k] - before[k]
                                      for k in K5_NAMES), start, end, out))
            return out
        return counted

    per_step = (K5_PER_STEP,) * 3
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
        launches = {k: K.LAUNCHES[k] for k in K5_NAMES}
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
        print(f"[glow-train] launches {dict(K.LAUNCHES)} over {steps} train "
              f"steps (per step {stats['per_train_step']}), init_step "
              f"{stats['per_init_step']}, {stats['reverses']} reverses (each "
              f"{stats['per_reverse']})", flush=True)
        if (steps != GLOW_ITERS or stats["per_train_step"] != [per_step]
                or stats["per_init_step"] != [(K5_PER_STEP, 0, 0)]
                or stats["per_reverse"] != [(K5_PER_STEP, 0, 0)]
                or stats["reverses"] != GLOW_ITERS // GLOW_EVERY
                or set(K.LAUNCHES) - set(K5_NAMES)):
            failures.append(f"glow-train launches: {stats}")
        if not (all(math.isfinite(v) for v in losses)
                and np.mean(losses[-5:]) < np.mean(losses[:5])):
            failures.append(f"glow-train: bits/dim not finite and falling: "
                            f"{losses}")
        grids = sorted((Path(cfg.run.out_dir) / "sample").glob("*.npy"))
        grid = np.load(grids[-1])
        if not (len(grids) == GLOW_ITERS // GLOW_EVERY and
                grid.shape == (cfg.n_samples, 64, 64, 3) and
                np.isfinite(grid).all()):
            failures.append(f"glow-train grids {[g.name for g in grids]} "
                            f"{grid.shape}")
        print(f"[glow-train] bits/dim by step: " + " ".join(
            f"{v:.4f}" for v in losses) + f"; log {res['log']}", flush=True)
        print(f"[glow-train] {steps} steps; step ms median "
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
        print(f"[glow-resume] checkpoint iteration {payload['step']}, "
              f"optimizer steps {back.step}: params and buffers equal "
              f"{same_params}, Adam state equal {same_opt}", flush=True)
        if not ok:
            failures.append("glow resume did not restore what was saved")
        del back, trainer, res, final, opt_a, opt_b
        torch.cuda.empty_cache()

        for v in calls.values():
            v.clear()
        fed.clear()
        K.LAUNCHES.clear()
        res = L.run_glow(cfg, n_iter=GLOW_ITERS + GLOW_EVERY, resume=True,
                         device="cuda")
        steps3 = len(calls["train_step"])
        got = {k: K.LAUNCHES[k] for k in K5_NAMES}
        train, _, _ = make_image_datasets(cfg.data, seed=cfg.run.seed)
        want_batch = torch.from_numpy(next(train.stream(GLOW_ITERS + 1)))
        same_stream = torch.equal(fed[0].cpu(), want_batch)
        losses3 = [float(c[3]["loss"]) for c in calls["train_step"]]
        print(f"[glow-train] resumed: {steps3} steps from iteration "
              f"{GLOW_ITERS}, first batch is stream batch {GLOW_ITERS + 1}: "
              f"{same_stream}; bits/dim " + " ".join(
                  f"{v:.4f}" for v in losses3) + f"; launches {got}",
              flush=True)
        if not (res["trainer"].step == GLOW_ITERS + GLOW_EVERY
                == steps + steps3 and same_stream and not calls["init_step"]
                and got == {"glow_coupling_fwd": K5_PER_STEP * (steps3 + 1),
                            "glow_coupling_bwd1": K5_PER_STEP * steps3,
                            "glow_coupling_bwd2": K5_PER_STEP * steps3}
                and all(math.isfinite(v) for v in losses3)):
            failures.append(f"glow resumed run: step {res['trainer'].step}, "
                            f"stream {same_stream}, launches {got}")
        stats["resumed_losses"] = losses3
        stats["launches_total"] = {k: launches[k] + got[k] for k in K5_NAMES}
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
    stats = check_glow_step(K, cfg, gen, failures)
    stats["train"] = glow_train_path(K, cfg, failures)
    stats["serve"] = glow_serve_path(K, cfg, failures)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=str, default=None,
                    help="also write the full report as JSON here")
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
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} tf32 conv "
          f"{torch.backends.cudnn.allow_tf32} matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    failures = []
    report = {}
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
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
        gen = torch.Generator(device=dev).manual_seed(0)
        k2_rows, report["sdpa_backend"] = check_k2(K, gen, dev, failures)
        attn_rows = check_attention(K, gen, dev, failures)
        gn_rows = check_groupnorm(K, gen, dev, failures)
        k1_rows = check_k1(K, gen, dev, failures)
        # the Glow phases draw from their own generators, so the earlier
        # phases see the inputs they saw before Glow was added
        k5_rows = check_k5(K, torch.Generator(device=dev).manual_seed(5), dev,
                           failures)
        train_l, serve_l, report["main_path"] = main_path(K, gen, failures)
        report["vaegan"] = vaegan_path(K, gen, failures)
        report["glow"] = glow_path(
            K, torch.Generator(device=dev).manual_seed(6), failures)
        per_step = "one 256x256 batch-16 train step"
        per_fwd = "one 256x256 batch-16 UNet forward"
        fwd_src = "vgd_tpu_torch/csrc/flash_attention.cu"
        bwd_src = "vgd_tpu_torch/csrc/flash_attention_bwd.cu"
        report["kernels"] = [
            kernel_entry("attention_fwd", fwd_src,
                         "vgd_tpu/ops/pallas_kernels.py:218",
                         k2_rows["attention_fwd"], train_l["attention_fwd"],
                         per_step),
            kernel_entry("attention_dq", bwd_src,
                         "vgd_tpu/ops/pallas_kernels.py:251",
                         k2_rows["attention_dq"], train_l["attention_dq"],
                         per_step),
            kernel_entry("attention_dkv", bwd_src,
                         "vgd_tpu/ops/pallas_kernels.py:280",
                         k2_rows["attention_dkv"], train_l["attention_dkv"],
                         per_step),
            kernel_entry("flash_attention", fwd_src,
                         "vgd_tpu/ops/pallas_kernels.py:63", attn_rows,
                         serve_l["flash_attention"], per_fwd),
            kernel_entry("groupnorm_silu",
                         "vgd_tpu_torch/ops/groupnorm_silu_triton.py",
                         "vgd_tpu/ops/pallas_kernels.py:149", gn_rows,
                         serve_l["groupnorm_silu"], per_fwd),
            kernel_entry("conv_bn_stats",
                         "vgd_tpu_torch/csrc/conv_bn_stats.cu",
                         "vgd_tpu/ops/fused_conv.py:125", k1_rows,
                         report["vaegan"]["train"]["k1_launches"],
                         "one 256x256 batch-64 VAE-GAN train step")] + [
            kernel_entry(name, "vgd_tpu_torch/csrc/glow_coupling.cu",
                         f"vgd_tpu/ops/glow_coupling.py:{line}", k5_rows[name],
                         report["glow"]["train"]["launches_total"][name],
                         "one 64x64 batch-16 Glow train step (K=32, L=4)")
            for name, line in zip(K5_NAMES, (164, 206, 266))]
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
