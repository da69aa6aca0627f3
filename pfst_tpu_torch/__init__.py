"""PyTorch/CUDA port of ``pfst_tpu`` for NVIDIA Hopper.

Tensors are NCHW. Entry points run on the card unless the caller passes
``device='cpu'``. The package imports nothing of JAX or of ``pfst_tpu``.
"""
__version__ = '0.1.0'
