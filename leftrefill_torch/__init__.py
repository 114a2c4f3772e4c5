"""PyTorch/CUDA port of LeftRefill for NVIDIA Hopper (H100).

``leftrefill_tpu/`` (JAX/Pallas) is the reference; this package mirrors its
structure (``ops/``, ``models/``, ``diffusion/``, ``pipeline.py``,
``convert/``) and replaces its TPU kernels with hand-written CUDA kernels in
``csrc/``, built at first launch (``kernels/``).  It imports torch and
numpy, never jax, flax or the JAX package: it keeps its own copies of the
numpy-only modules it needs (the schedule tables, the tokenizer).
"""

__version__ = "0.1.0"
