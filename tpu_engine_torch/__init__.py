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

The mesh's wire and the training state on disk:

- ``tpu_engine_torch.comm`` / ``tpu_engine_torch.comm_compress`` — ZeRO++
  compressed collectives (qwZ, hpZ, qgZ across slices) and their plan;
- ``tpu_engine_torch.checkpoint`` — ``TrainCheckpointManager`` over
  ``torch.distributed.checkpoint`` (stable pointer, rollback, quarantine);
- ``tpu_engine_torch.reshard`` — restores onto another mesh;
- ``tpu_engine_torch.data`` and ``tpu_engine_torch.native`` — token files
  and their native reader.

The supervised job and the device plane:

- ``tpu_engine_torch.supervisor`` — ``TrainingJob`` (rollback, resume,
  preemption, self-heal) on the modules below and ``hetero``;
- ``tpu_engine_torch.tpu_manager`` and ``telemetry`` — the H100 fleet
  manager and its ``nvidia-smi`` source; ``profiler`` — MFU and traces;
  ``hbm_estimate``; ``compile_cache`` and ``compile_index`` — the kernel
  build directory and its warm/cold index.

The fleet's scheduling half:

- ``tpu_engine_torch.goodput`` — the wall-clock account of each job and
  its SLO burn-rate alerts;
- ``tpu_engine_torch.placement`` — the layout planner (H100 constants);
- ``tpu_engine_torch.scheduler`` — ``FleetScheduler``: queue, quotas,
  HBM-aware admission, preemption and requeue, elastic shrink/grow;
- ``tpu_engine_torch.launcher`` — ``TPULauncher``, the presets and the CLI
  (``python -m tpu_engine_torch.launcher``).

The serving fleet:

- ``tpu_engine_torch.serving_fleet`` — replicas as scheduler submissions,
  ``FleetRouter``, ``ReplicaAutoscaler``, ``ServingFleet``;
- ``tpu_engine_torch.disagg`` — the ``KVHandoff`` wire and
  ``DisaggServingFleet`` (prefill and decode pools);
- ``tpu_engine_torch.prefix_plane``, ``autopilot`` and ``spec_pool`` — the
  fleet prefix plane, the audited control loop and speculative pools.

Imports here stay light: submodules are imported by the caller.
"""

__all__ = ["autopilot", "checkpoint", "comm", "comm_compress", "compile_cache", "compile_index",
           "data", "disagg", "disk_offload", "generate", "goodput", "hbm_estimate", "hetero",
           "launcher", "lora", "mesh_runtime", "models", "native", "offload", "ops", "parallel",
           "placement", "prefix_plane", "profiler", "quant", "quant_train", "reshard",
           "scheduler", "serving", "serving_fleet", "sharding", "spec_pool", "supervisor",
           "telemetry", "tpu_manager", "train"]
