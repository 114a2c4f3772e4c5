"""PyTorch/CUDA port of LeftRefill for NVIDIA Hopper (H100).

``leftrefill_tpu/`` (JAX/Pallas) is the reference; this package mirrors its
structure (``ops/``, ``models/``, ``diffusion/``, ``pipeline.py``,
``convert/``) and replaces its TPU kernels with hand-written CUDA kernels in
``csrc/``, built at first launch (``kernels/``).  It imports torch and
numpy, never jax or flax.
"""

__version__ = "0.1.0"
