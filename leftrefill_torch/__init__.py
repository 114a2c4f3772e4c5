"""PyTorch/CUDA port of LeftRefill for NVIDIA Hopper (H100).

``leftrefill_tpu/`` (JAX/Pallas) is the reference; this package mirrors its
structure (``ops/``, ``models/``, ``diffusion/``, ``pipeline.py``,
``convert/``) and replaces its TPU kernels with hand-written CUDA kernels in
``csrc/``, built at first launch (``kernels/``).  It imports torch and
numpy, never jax, flax or the JAX package: it keeps its own copies of the
numpy-only modules it needs (the schedule tables, the tokenizer).
"""

__version__ = "0.1.0"

# the public names, imported on first use (a bare ``import leftrefill_torch``
# stays light), as the JAX package's
__all__ = ["build_model_from_config", "build_task", "RefInpaintPipeline"]


def __getattr__(name):
    if name == "build_model_from_config":
        from leftrefill_torch.config import build_model_from_config

        return build_model_from_config
    if name == "build_task":
        from leftrefill_torch.tasks import build_task

        return build_task
    if name == "RefInpaintPipeline":
        from leftrefill_torch.pipeline import RefInpaintPipeline

        return RefInpaintPipeline
    raise AttributeError(name)
