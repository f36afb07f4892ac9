"""Model FLOPs of the VAE-GAN train step, from the configuration's shapes.

A convolution's forward is 2 x output pixels x Cout x Cin x k^2 (a
transposed one's counts its input pixels), a Dense one 2 x in x out; a
backward computes the input's gradient and the weights' gradient, each as
many operations as the forward, and only those the step needs: no weight
gradient for a frozen network, no input gradient for a network's input
that carries none. The step's passes: the reconstruction without gradient
(encoder, decoder); ``d_steps`` discriminator steps (two forwards, their
weight gradients, their input gradients below the first layer); the
generator step (encoder, decoder and discriminator forwards; the
discriminator's input gradients; the decoder's both gradients; the
encoder's weight gradients and its input gradients above the first layer).
Elementwise work is not counted.
"""
from __future__ import annotations

ENC_CHANNELS = (32, 64, 128, 256)


def _stages(size: int) -> int:
    n = 0
    while size > 4:
        size //= 2
        n += 1
    return n


def layer_flops(cfg: dict):
    """Forward FLOPs of one image, layer by layer: (encoder, decoder,
    discriminator), each a list from the input side."""
    size, c, nz = cfg["image_size"], cfg["channels"], cfg["latent_dim"]
    enc, s, prev = [], size, c
    for ch in ENC_CHANNELS:
        so = (s - 4) // 2 + 1
        enc.append(2 * so * so * ch * prev * 16)
        s, prev = so, ch
    flat = s * s * prev
    enc += [2 * flat * nz, 2 * flat * nz]
    ch0 = cfg["ngf"] * 16
    dec, s, prev = [2 * nz * ch0 * 16], 4, ch0
    for i in range(1, _stages(size) + 1):
        ch = max(ch0 >> i, c)
        dec.append(2 * s * s * prev * ch * 16)
        s, prev = 2 * s, ch
    dec.append(2 * size * size * c * prev * 9)
    disc, s, prev = [], size, c
    for i in range(_stages(size)):
        ch = (cfg["ndf"] // 4) << i
        s //= 2
        disc.append(2 * s * s * ch * prev * 16)
        prev = ch
    disc.append(2 * prev * 16)
    return enc, dec, disc


def step_flops(cfg: dict) -> float:
    """FLOPs of one train step of ``batch_size`` images."""
    enc, dec, disc = (sum(x) for x in layer_flops(cfg))
    enc0, _, disc0 = (x[0] for x in layer_flops(cfg))
    recon = enc + dec
    d_step = 2 * disc + 2 * disc + 2 * (disc - disc0)
    g_step = (enc + dec + disc) + disc + 2 * dec + enc + (enc - enc0)
    return cfg["batch_size"] * (recon + cfg["d_steps"] * d_step + g_step)
