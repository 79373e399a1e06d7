"""Model and engine configuration dataclasses (PyTorch port).

Canonical 2B config: hidden 2560, inter 6912, 30 layers, 20 Q / 5 KV heads,
head_dim 128, vocab 128256, rope theta 5e5, tied embeddings. Counterpart
of ``wrinklefree_tpu/config.py`` with torch dtypes.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import torch


@dataclasses.dataclass(frozen=True)
class BitNetConfig:
    vocab_size: int = 128256
    hidden_size: int = 2560
    intermediate_size: int = 6912
    num_layers: int = 30
    num_heads: int = 20
    num_kv_heads: int = 5
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    max_position: int = 4096
    tie_word_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    # MoE (0 experts = dense). The port runs dense models only; the engine
    # raises NotImplementedError for num_experts > 0.
    num_experts: int = 0
    num_experts_per_tok: int = 2
    # BitNet b1.58 uses a ReLU^2 gate + attn/ffn sub-norms; ternary-converted
    # Llama keeps SiLU and no sub-norms.
    mlp_act: str = "relu2"  # relu2 | silu
    sub_norms: bool = True

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def bitnet_2b(cls) -> "BitNetConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256) -> "BitNetConfig":
        """Small config for tests (CPU-runnable)."""
        return cls(
            vocab_size=vocab_size,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=32,
            max_position=256,
        )

    @classmethod
    def llama3_8b_ternary(cls) -> "BitNetConfig":
        """Llama-3-8B converted to ternary (SiLU gate, no sub-norms)."""
        return cls(
            vocab_size=128256,
            hidden_size=4096,
            intermediate_size=14336,
            num_layers=32,
            num_heads=32,
            num_kv_heads=8,
            head_dim=128,
            max_position=8192,
            tie_word_embeddings=False,
            mlp_act="silu",
            sub_norms=False,
        )

    @classmethod
    def from_hf_config(cls, path: Path | str) -> "BitNetConfig":
        """Build from a HuggingFace config.json directory or file."""
        p = Path(path)
        if p.is_dir():
            p = p / "config.json"
        cfg = json.loads(p.read_text())
        hidden = cfg["hidden_size"]
        heads = cfg["num_attention_heads"]
        return cls(
            vocab_size=cfg["vocab_size"],
            hidden_size=hidden,
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=cfg.get("num_key_value_heads", heads),
            head_dim=cfg.get("head_dim", hidden // heads),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            rope_theta=cfg.get("rope_theta", 500_000.0),
            max_position=cfg.get("max_position_embeddings", 4096),
            tie_word_embeddings=cfg.get("tie_word_embeddings", True),
            mlp_act="silu" if cfg.get("hidden_act", "relu2") == "silu" else "relu2",
            sub_norms=cfg.get("model_type", "bitnet") != "llama",
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Continuous-batching engine configuration.

    The reference's fields and defaults, less the TPU-only path selectors
    (``use_pallas``, ``flash_decode``, ``prefill_linear``, ``kv_layout``:
    the port always runs its fused kernels over the dual KV layout) and the
    tuning knobs of features not ported yet. Fields whose feature the port
    does not run yet make ``Engine`` raise ``NotImplementedError`` when set
    away from their default (see ``engine/engine.py``).
    """

    max_batch_slots: int = 8
    page_size: int = 16
    num_pages: int = 2048
    max_context: int = 4096
    prefill_buckets: tuple = (32, 128, 512, 2048, 4096)
    kv_dtype: str = "bf16"  # bf16 | f32 (int8/fp8 not yet ported)
    enable_radix_cache: bool = True
    exact_head_k: int = 0
    # Ring-buffer width for repetition/presence/frequency penalties.
    penalty_window: int = 64
    # Max distinct (token_id, bias) logit-bias pairs per request.
    logit_bias_slots: int = 16
    # Cap on concurrently-prefilling slots (None = no cap).
    max_prefill_slots: "int | None" = None
    # Prefill round membership: "stagger" | "bucket" | "all" (all
    # token-identical; see the reference's EngineConfig for the policies).
    prefill_round_mode: str = "stagger"
    max_queue: int = 256
    # The native C++ host runtime is not bound by the port yet: True raises.
    use_native_runtime: bool = False
    # Decode steps per burst: one host read of the sampled tokens per burst.
    decode_burst: int = 16
    speculative_k: int = 0
    admission_policy: str = "fifo"  # fifo | sjf
    admission_aging_s: float = 10.0
    # Cap on rows x chunk tokens per batched prefill round.
    max_prefill_tokens_per_round: int = 8192
    # Interleave chunked prefill with decode at chunk granularity.
    interleave_prefill: bool = True
    int8_logits: bool = False
    attn_window: int = 0
    attn_global_tokens: int = 0
