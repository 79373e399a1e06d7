"""Request sampling parameters (OpenAI/llama.cpp-compatible subset). A copy
of ``wrinklefree_tpu/engine/sampling_params.py``; the engine raises
NotImplementedError at submit for the fields whose feature the port does
not run yet (mirostat, logprobs, json_mode/grammar)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    max_new_tokens: int = 128
    stop_token_ids: Optional[List[int]] = None
    ignore_eos: bool = False
    seed: Optional[int] = None
    # Penalties (llama.cpp repeat_penalty / OpenAI presence+frequency;
    # identity defaults). Window is llama.cpp `repeat_last_n` semantics,
    # clamped to EngineConfig.penalty_window at admission.
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    penalty_last_n: int = 64
    # llama.cpp min_p sampler: drop tokens with prob < min_p * p(max).
    # 0.0 = off (llama-server's own default is 0.05).
    min_p: float = 0.0
    # llama.cpp locally-typical sampling (typical_p) and tail-free
    # sampling (tfs_z); 1.0 = off for both.
    typical_p: float = 1.0
    tfs_z: float = 1.0
    # Mirostat v2 (llama.cpp mirostat/mirostat_tau/mirostat_eta):
    # 0 = off; nonzero enables the v2 algorithm (adaptive surprise
    # target; replaces the other filters for this request). mu starts
    # at 2*tau; the first (prefill-sampled) token uses the standard
    # sampler, decode steps adapt mu on-device.
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # Logprobs (OpenAI logprobs/top_logprobs, llama.cpp n_probs): 0 = off;
    # k >= 1 returns the chosen token's logprob + the top-k alternatives
    # per step (the port raises NotImplementedError for logprobs_k > 0).
    logprobs_k: int = 0
    # Additive logit bias (OpenAI `logit_bias` {token_id: -100..100},
    # llama.cpp `logit_bias` [[id, bias|false]]): list of (token_id,
    # bias) pairs, at most EngineConfig.logit_bias_slots per request.
    # Use a large negative bias (the server maps `false`/-100 to -1e9)
    # to ban a token outright.
    logit_bias: Optional[List] = None  # [(token_id, bias), ...]
    # Constrained decoding: force the output to be a valid JSON object
    # (OpenAI `response_format: {"type": "json_object"}`; llama-server
    # grammar surface analog). Requires Engine.token_pieces; the request
    # runs on single-step decode dispatches with host-side candidate
    # re-selection through a JSON-prefix validator.
    json_mode: bool = False
    # GBNF grammar text (llama-server `grammar` field); mutually
    # exclusive with json_mode in spirit (json_mode wins if both set).
    # Same host-re-selection machinery as json_mode (engine/gbnf.py).
    grammar: Optional[str] = None

    @property
    def constrained(self) -> bool:
        return self.json_mode or bool(self.grammar)

    @property
    def has_logit_bias(self) -> bool:
        return bool(self.logit_bias)

    @property
    def has_penalties(self) -> bool:
        return (
            self.repetition_penalty != 1.0
            or self.presence_penalty != 0.0
            or self.frequency_penalty != 0.0
        )
