"""PyTorch/CUDA port of the Phocas reproduction (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its module
names and runs on an NVIDIA GPU, with the Pallas TPU kernels replaced by
hand-written CUDA kernels for Hopper (``repro_torch.kernels``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.  Nothing here
imports JAX or the ``repro`` package.
"""
