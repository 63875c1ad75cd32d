"""PyTorch/CUDA port of the ``tpu_engine`` training path, for one NVIDIA H100.

The JAX package ``tpu_engine`` stays the reference. This package imports
``torch`` and never ``jax`` or ``tpu_engine``; the tests move weights and
batches between the two through numpy.

Slice 1 ports the single-GPU llama-family training step:

- ``tpu_engine_torch.models.config`` — ``ModelConfig`` / ``MODEL_CONFIGS``;
- ``tpu_engine_torch.models.transformer`` — the dense llama forward;
- ``tpu_engine_torch.ops.flash_attention`` — ``mha`` over three CUDA
  flash-attention kernels (``csrc/flash_attention.cu``);
- ``tpu_engine_torch.train`` — ``TrainConfig`` and ``TrainProgram``.

Imports here stay light: submodules are imported by the caller.
"""

__all__ = ["models", "ops", "train"]
