"""vsrlab_tpu_torch: the PyTorch / CUDA port of vsrlab_tpu for NVIDIA Hopper.

Public functions keep the JAX package's layout: clips ``(B, T, H, W, C)``,
flows ``(..., 2)`` in ``(dx, dy)``. The fused residual conv pair and the
bilinear sampler of VRT's deformable alignment run on hand-written CUDA
kernels (``csrc/``), built with ``nvcc`` at first use; every other conv is
``F.conv2d``, every dense product ``torch.matmul``. Inference goes through
``evaluation/``, training through ``train/`` (the kernels' gradients are
PyTorch ops around their kernel forwards), data parallelism across
processes through ``parallel/``.
"""
