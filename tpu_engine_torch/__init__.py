"""PyTorch/CUDA port of the ``tpu_engine`` training and serving paths, for one
NVIDIA H100.

The JAX package ``tpu_engine`` stays the reference. This package imports
``torch`` and never ``jax`` or ``tpu_engine``; the tests move weights and
batches between the two through numpy.

Slice 1 ports the single-GPU llama-family training step:

- ``tpu_engine_torch.models.config`` — ``ModelConfig`` / ``MODEL_CONFIGS``;
- ``tpu_engine_torch.models.transformer`` — the dense forward (llama;
  gpt2, qwen and gemma since slice 6);
- ``tpu_engine_torch.ops.flash_attention`` — ``mha`` over three CUDA
  flash-attention kernels (``csrc/flash_attention.cu``);
- ``tpu_engine_torch.train`` — ``TrainConfig`` and ``TrainProgram``.

Slice 5 ports serving on one card:

- ``tpu_engine_torch.generate`` — the KV-cached forward, ``generate`` and
  ``speculative_generate``;
- ``tpu_engine_torch.serving`` — the continuous-batching
  ``ContinuousBatcher``.

Slice 6 adds the gpt2, qwen and gemma archs to every entry point above, and
the flash kernels at gemma's head dim of 256; slice 7 redesigns the forward
and dK/dV kernels at that head dim for Hopper.

Slice 15 adds to training:

- ``tpu_engine_torch.quant_train`` — int8 quantised training;
- ``tpu_engine_torch.lora`` — LoRA adapters on a frozen base;
- Adafactor and Lion beside AdamW, and the remat policies.

Where the training state lives:

- ``tpu_engine_torch.offload`` — ``optimizer_offload`` and
  ``param_offload`` in host memory, streamed through the device;
- ``tpu_engine_torch.disk_offload`` — the disk tier;
- bf16 masters, the ``sliding_window`` override and the ``offload_dots``
  remat policy.

Then qwen and gemma with experts, and the first multi-GPU pieces:

- ``tpu_engine_torch.mesh_runtime`` — ``MeshConfig``,
  ``initialize_distributed``, ``build_mesh`` and ``MeshRuntime`` (the
  process groups of the mesh's axes);
- ``tpu_engine_torch.sharding`` — the ZeRO stages' specs;
- ``tpu_engine_torch.parallel.zero`` — the train step on a mesh
  (``TrainConfig(mesh=..., sharding_stage=...)``), ZeRO 0–3 over ``data``
  and ``fsdp``;
- ring attention across ranks (``parallel.ring_attention.ring_mha_group``)
  and Ulysses (``parallel.ulysses_attention``) over ``sequence``.

Imports here stay light: submodules are imported by the caller.
"""

__all__ = ["disk_offload", "generate", "lora", "mesh_runtime", "models", "offload", "ops",
           "parallel", "quant", "quant_train", "serving", "sharding", "train"]
