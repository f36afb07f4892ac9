"""PyTorch/CUDA port of ``vgd_tpu`` for NVIDIA Hopper (H100).

Module names mirror ``vgd_tpu/`` so each counterpart is easy to find. The
port imports PyTorch only: it never imports JAX, Flax or ``vgd_tpu``.

The port trains DDPM (``train.loop.run_diffusion``, the ``diffusion`` CLI
command), checkpoints and resumes it, and serves the result: sampling and
partial-noise restoration (``train.loop.sample_from_dir`` /
``evaluate_diffusion``). It trains, evaluates and serves the VAE-GAN, the
denoising VAE, DCGAN / WGAN and Glow the same way, reads JPEG folders
through a uint8 memmap cache (``data.celeba``), imports the reference's
PyTorch checkpoints (``io.torch_import``), and exports any checkpoint's
serving program as one ``torch.export`` artifact that runs without the
model code (``io.export``, the ``export`` / ``infer`` commands; the serving
kernels are registered ``vgd::`` ops). Kernels written by
hand, all CUDA C++ (``csrc/``): the differentiable FlashAttention-2 of the
DDPM train step (``flash_attention.cu`` forward, ``flash_attention_bwd.cu``
dq and dk/dv), single-head flash attention for serving in the same forward
source, fused GroupNorm+SiLU with the casts and the residual add around it
(``groupnorm_silu.cu``), Conv4x4s2 with its batch statistics for the
encoders and discriminators (``conv_bn_stats.cu``), and Glow's coupling
network and flow stack (``glow_coupling.cu``, ``glow_flow_stack.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""
