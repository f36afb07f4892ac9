"""PyTorch/CUDA port of ``vgd_tpu`` for NVIDIA Hopper (H100).

Module names mirror ``vgd_tpu/`` so each counterpart is easy to find. The
port imports PyTorch only: it never imports JAX, Flax or ``vgd_tpu``.

The port trains DDPM (``train.loop.run_diffusion``, the ``diffusion`` CLI
command), checkpoints and resumes it, and serves the result: sampling and
partial-noise restoration (``train.loop.sample_from_dir`` /
``evaluate_diffusion``). Kernels written by hand: the differentiable
FlashAttention-2 of the train step in CUDA C++ (``csrc/flash_attention.cu``
forward, ``csrc/flash_attention_bwd.cu`` dq and dk/dv), single-head flash
attention for serving in the same forward source, and fused GroupNorm+SiLU
with the casts and the residual add around it (``csrc/groupnorm_silu.cu``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that argument they raise.
"""
