"""Model and engine configuration dataclasses (PyTorch port).

Canonical 2B config: hidden 2560, inter 6912, 30 layers, 20 Q / 5 KV heads,
head_dim 128, vocab 128256, rope theta 5e5, tied embeddings. Counterpart
of ``wrinklefree_tpu/config.py`` with torch dtypes, and its YAML tier: the
readers of the repository's ``configs/`` files (PyYAML, imported only when a
file is read).
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
    # MoE (0 experts = dense); see wrinklefree_tpu_torch/models/moe.py. One
    # device: expert parallelism is not ported.
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
    (``use_pallas``, ``prefill_linear``: the port always runs its fused
    kernels). Every ``kv_dtype`` serves on the card: K4 and K6 take bf16,
    fp16 and f32 pools.

    ``kv_layout``: "layer" is the dual layout (a layer-major main pool and a
    token-major staging page per slot), "token" the token-major pool, and
    "auto" resolves to "layer" for unquantized ``kv_dtype`` and "token" for
    int8/fp8, as the reference resolves it on a TPU (where its kernel path
    runs for unquantized pools only). The port keys on the dtype alone,
    whatever the device, so the CPU runs the layout the card runs.
    """

    max_batch_slots: int = 8
    page_size: int = 16
    num_pages: int = 2048
    max_context: int = 4096
    prefill_buckets: tuple = (32, 128, 512, 2048, 4096)
    kv_dtype: str = "bf16"  # bf16 | fp16 | f32 | int8 | fp8_e4m3 | fp8_e5m2
    enable_radix_cache: bool = True
    exact_head_k: int = 0
    # Ring-buffer width for repetition/presence/frequency penalties.
    penalty_window: int = 64
    # Top-N width of the logprobs program variants (per-request logprobs_k
    # clamps to it).
    logprobs_top: int = 8
    # Max distinct (token_id, bias) logit-bias pairs per request.
    logit_bias_slots: int = 16
    # Cap on concurrently-prefilling slots (None = no cap).
    max_prefill_slots: "int | None" = None
    # Prefill round membership: "stagger" | "bucket" | "all" (all
    # token-identical; see the reference's EngineConfig for the policies).
    prefill_round_mode: str = "stagger"
    max_queue: int = 256
    # The native C++ page allocator and radix cache (native/), built with g++
    # at first use; the Python classes when it does not build.
    use_native_runtime: bool = True
    # Decode steps per burst: one host read of the sampled tokens per burst.
    decode_burst: int = 16
    # Speculative decoding in the decode burst: n-gram (prompt-lookup) drafts
    # of up to k tokens verified in one k+1-token forward, greedy requests
    # only (a burst with a sampling, penalised, biased, constrained or
    # logprobs row runs the plain burst). Windows are clamped to the current
    # KV page. 0 disables.
    speculative_k: int = 0
    # Adaptive cutoff: once spec_min_accept_window drafts have run, drafting
    # turns itself off (sticky, per engine) when the accepted tokens per
    # drafted token fall below spec_min_accept. 0 = never.
    spec_min_accept: float = 0.1
    spec_min_accept_window: int = 256
    admission_policy: str = "fifo"  # fifo | sjf
    admission_aging_s: float = 10.0
    # Cap on rows x chunk tokens per batched prefill round.
    max_prefill_tokens_per_round: int = 8192
    # Interleave chunked prefill with decode at chunk granularity.
    interleave_prefill: bool = True
    # the int8 output head for every logit (approximate); exclusive with
    # exact_head_k (the int8 scan, certified top-k rescore and bf16 fallback)
    int8_logits: bool = False
    # sliding-window attention over the dual layout (kv/paged.py
    # make_dual_window_attention): keys within attn_window positions, plus
    # the first attn_global_tokens
    attn_window: int = 0
    attn_global_tokens: int = 0
    kv_layout: str = "auto"  # auto | layer | token
    # Decode attention with the page-table gather inside the kernel
    # (ops.flash_attention.flash_paged_decode); off runs the plain gather
    # attention. The reference's None means its env default, which is off.
    flash_decode: bool = False


# ---------------------------------------------------------------------------
# YAML config tier: configs/{models,serving,sparsity,attention}/*.yaml into
# the dataclasses above and the sparsity policies
# ---------------------------------------------------------------------------

CONFIGS_DIR = Path(__file__).resolve().parent.parent / "configs"


def load_yaml(path: Path | str) -> dict:
    """Load one YAML config file (absolute path or relative to configs/).
    Needs PyYAML, imported here only."""
    import yaml

    p = Path(path)
    if not p.exists():
        p = CONFIGS_DIR / path
    with open(p) as f:
        return yaml.safe_load(f) or {}


def model_config_from_yaml(path: Path | str) -> BitNetConfig:
    """A BitNetConfig from a configs/models/*.yaml model card."""
    arch = load_yaml(path).get("architecture", {})
    fields = {f.name for f in dataclasses.fields(BitNetConfig)}
    return BitNetConfig(**{k: v for k, v in arch.items() if k in fields})


def engine_config_from_yaml(path: Path | str = "serving/default.yaml") -> EngineConfig:
    """An EngineConfig from a configs/serving/*.yaml file's ``engine`` section.
    ``use_pallas``: ``auto`` and true mean the port's kernels; false raises
    ``NotImplementedError`` (the kernels' plain versions are their CPU path,
    not a serving path on the card)."""
    doc = load_yaml(path).get("engine", {})
    kw = {}
    for key in ("max_batch_slots", "page_size", "num_pages", "max_context", "decode_burst"):
        if key in doc:
            kw[key] = int(doc[key])
    if "prefill_buckets" in doc:
        kw["prefill_buckets"] = tuple(doc["prefill_buckets"])
    if "kv_cache_dtype" in doc:
        kw["kv_dtype"] = {"bfloat16": "bf16"}.get(doc["kv_cache_dtype"], doc["kv_cache_dtype"])
    if "radix_cache" in doc:
        kw["enable_radix_cache"] = bool(doc["radix_cache"])
    if "use_pallas" in doc and doc["use_pallas"] != "auto" and not bool(doc["use_pallas"]):
        raise NotImplementedError(
            "use_pallas: false (the plain kernels as a serving path) is not ported")
    if "int8_logits" in doc:
        kw["int8_logits"] = bool(doc["int8_logits"])
    return EngineConfig(**kw)


def activation_sparsity_from_yaml(path: Path | str):
    """configs/sparsity/*.yaml -> ActivationSparsityConfig (None if off)."""
    from .ops.activation_sparsity import ActivationSparsityConfig, SparsityMode

    doc = load_yaml(path).get("activation_sparsity", {})
    mode = SparsityMode(doc.get("mode", "none"))
    if mode == SparsityMode.NONE:
        return None
    fields = {f.name for f in dataclasses.fields(ActivationSparsityConfig)}
    return ActivationSparsityConfig(
        **{k: v for k, v in doc.items() if k in fields and k != "mode"}, mode=mode)


def attention_sparsity_from_yaml(path: Path | str):
    """configs/attention/*.yaml -> AttentionSparsityConfig (None if off)."""
    from .ops.sparse_attention import AttentionSparsityConfig, AttentionSparsityMode

    doc = load_yaml(path).get("attention_sparsity", {})
    mode = AttentionSparsityMode(doc.get("mode", "none"))
    if mode == AttentionSparsityMode.NONE:
        return None
    fields = {f.name for f in dataclasses.fields(AttentionSparsityConfig)}
    return AttentionSparsityConfig(
        **{k: v for k, v in doc.items() if k in fields and k != "mode"}, mode=mode)
