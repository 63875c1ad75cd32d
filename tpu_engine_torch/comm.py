"""The collective-communication surface of a training config (port of
``tpu_engine/comm.py``).

JAX's module also turns the config's comm-tuning knobs into XLA compiler
flags (``xla_flags_for``, ``apply_comm_flags``: async collectives and the
latency-hiding scheduler). The port has no compiler between the program
and its collectives: they are explicit calls on the process groups
(``parallel/collectives.py``), so those flags and their config fields have
no counterpart here, and no NCCL setting stands in for them. What remains
is the declarative plan of the compressed collectives.
"""

from __future__ import annotations

from tpu_engine_torch import comm_compress


def compression_plan(cfg) -> dict:
    """The comm-compression surface of ``cfg`` (a ``TrainConfig``) as a
    plan/launch-report dict: which ZeRO++ mechanisms are on, the block
    size, and the analytic per-element wire reduction each one buys (int8
    codes + fp32 per-block scales against fp32 full width). JAX's dict for
    the same config."""
    plan: dict = {
        "enabled": comm_compress.enabled(cfg),
        "quant_weight_gather": cfg.comm_quant_weights,
        "secondary_weight_partition": cfg.comm_secondary_weights,
        "quant_grad_reduce": cfg.comm_quant_grads,
        "block_size": cfg.comm_quant_block_size,
    }
    if plan["enabled"]:
        factors = comm_compress.expected_volume_factors(cfg.comm_quant_block_size)
        if cfg.comm_quant_weights:
            plan["weight_gather_volume_factor"] = round(factors["weight_gather"], 3)
        if cfg.comm_quant_grads:
            plan["cross_slice_grad_volume_factor"] = round(factors["grad_cross_slice"], 3)
    return plan
