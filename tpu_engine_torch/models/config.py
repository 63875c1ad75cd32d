"""Model configurations, copied field for field from
``tpu_engine/models/transformer.py`` (``ModelConfig`` / ``MODEL_CONFIGS``).

The copy is a plain dataclass with no JAX dependency. ``attention_impl``
keeps the JAX strings so configs compare equal across packages: in the
port ``"xla"`` means the plain PyTorch attention and ``"flash"`` the CUDA
flash kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "gpt-125m"
    # Architecture family: "llama" | "gpt2" | "gemma" | "qwen". The port's
    # forward pass implements "llama"; the others raise NotImplementedError.
    arch: str = "llama"
    vocab_size: int = 32_000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int = 12
    d_ff: int = 2048
    max_seq_len: int = 2048
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # "xla" (plain PyTorch attention) or "flash" (CUDA flash kernels).
    attention_impl: str = "xla"
    # Sliding-window attention: each query sees the trailing
    # ``sliding_window`` keys. 0 = full causal.
    sliding_window: int = 0
    # Mixture-of-Experts (0 experts = dense MLP).
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "dense"
    # int8 quantized training: "none" or "int8".
    quant_training: str = "none"
    quant_train_targets: tuple = ("attn", "mlp", "moe")
    # Per-head dim decoupled from d_model // n_heads (Gemma: 256). 0 = derived.
    head_dim_override: int = 0

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def expert_capacity(self, seq_len: int) -> int:
        """Tokens each expert accepts per sequence (static)."""
        cap = int(self.capacity_factor * self.top_k * seq_len / self.n_experts)
        return max(cap, 1)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


MODEL_CONFIGS: dict[str, ModelConfig] = {
    "gpt-tiny": ModelConfig(
        name="gpt-tiny", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=4, d_ff=128, max_seq_len=256,
    ),
    "qwen-tiny": ModelConfig(
        name="qwen-tiny", arch="qwen", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim_override=32, d_ff=128, max_seq_len=256,
        rope_theta=1_000_000.0,
    ),
    "qwen3-4b": ModelConfig(
        name="qwen3-4b", arch="qwen", vocab_size=151_936, d_model=2560,
        n_layers=36, n_heads=32, n_kv_heads=8, head_dim_override=128, d_ff=9728,
        max_seq_len=32_768, rope_theta=1_000_000.0, norm_eps=1e-6,
    ),
    "gpt-125m": ModelConfig(
        name="gpt-125m", vocab_size=32_000, d_model=768, n_layers=12, n_heads=12,
        n_kv_heads=12, d_ff=2048, max_seq_len=2048,
    ),
    "llama-1b": ModelConfig(
        name="llama-1b", vocab_size=32_000, d_model=2048, n_layers=16, n_heads=16,
        n_kv_heads=16, d_ff=5504, max_seq_len=4096,
    ),
    "llama-7b": ModelConfig(
        name="llama-7b", vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=32, d_ff=11_008, max_seq_len=4096,
    ),
    "llama-13b": ModelConfig(
        name="llama-13b", vocab_size=32_000, d_model=5120, n_layers=40, n_heads=40,
        n_kv_heads=40, d_ff=13_824, max_seq_len=4096,
    ),
    "llama-70b": ModelConfig(
        name="llama-70b", vocab_size=32_000, d_model=8192, n_layers=80, n_heads=64,
        n_kv_heads=8, d_ff=28_672, max_seq_len=4096,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14_336, max_seq_len=32_768, sliding_window=4096,
    ),
    "gpt2-tiny": ModelConfig(
        name="gpt2-tiny", arch="gpt2", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=256, max_seq_len=256,
    ),
    "gpt2-124m": ModelConfig(
        name="gpt2-124m", arch="gpt2", vocab_size=50_257, d_model=768, n_layers=12,
        n_heads=12, n_kv_heads=12, d_ff=3072, max_seq_len=1024,
    ),
    "gpt2-xl": ModelConfig(
        name="gpt2-xl", arch="gpt2", vocab_size=50_257, d_model=1600, n_layers=48,
        n_heads=25, n_kv_heads=25, d_ff=6400, max_seq_len=1024,
    ),
    "gemma-tiny": ModelConfig(
        name="gemma-tiny", arch="gemma", vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=1, d_ff=256, max_seq_len=256,
        head_dim_override=32, norm_eps=1e-6,
    ),
    "gemma-2b": ModelConfig(
        name="gemma-2b", arch="gemma", vocab_size=256_000, d_model=2048,
        n_layers=18, n_heads=8, n_kv_heads=1, d_ff=16_384, max_seq_len=8192,
        head_dim_override=256, norm_eps=1e-6,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b", arch="gemma", vocab_size=256_000, d_model=3072,
        n_layers=28, n_heads=16, n_kv_heads=16, d_ff=24_576, max_seq_len=8192,
        head_dim_override=256, norm_eps=1e-6,
    ),
    "moe-tiny": ModelConfig(
        name="moe-tiny", vocab_size=512, d_model=64, n_layers=2, n_heads=4,
        n_kv_heads=4, d_ff=128, max_seq_len=256, n_experts=4, top_k=2,
    ),
    "moe-8x7b": ModelConfig(
        name="moe-8x7b", vocab_size=32_000, d_model=4096, n_layers=32, n_heads=32,
        n_kv_heads=8, d_ff=14_336, max_seq_len=4096, n_experts=8, top_k=2,
    ),
}
