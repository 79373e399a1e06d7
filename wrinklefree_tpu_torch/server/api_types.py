"""OpenAI-compatible + llama.cpp-compatible API payload helpers (PyTorch
port; a copy of ``wrinklefree_tpu/server/api_types.py``).

Contracts taken from the reference's client/UI call sites:
- POST /v1/chat/completions with stream=True, SSE `data:` lines ending in
  [DONE] (reference demo/serve_sglang.py:77-114)
- llama.cpp endpoints /completion, /tokenize, /detokenize, /health
  (reference client/bitnet_client.py:50-104,221-263)
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Dict, List, Optional


def chat_completion_id() -> str:
    return "chatcmpl-" + uuid.uuid4().hex[:24]


def completion_id() -> str:
    return "cmpl-" + uuid.uuid4().hex[:24]


def chat_chunk(
    cid: str, model: str, delta: Dict[str, Any], finish_reason: Optional[str] = None,
    logprobs: Optional[Dict[str, Any]] = None,
) -> str:
    choice: Dict[str, Any] = {"index": 0, "delta": delta, "finish_reason": finish_reason}
    if logprobs is not None:
        choice["logprobs"] = logprobs
    payload = {
        "id": cid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }
    return f"data: {json.dumps(payload)}\n\n"


def chat_response(
    cid: str, model: str, text: str, finish_reason: str,
    prompt_tokens: int, completion_tokens: int,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    choice: Dict[str, Any] = {
        "index": 0,
        "message": {"role": "assistant", "content": text},
        "finish_reason": finish_reason,
    }
    if logprobs is not None:
        choice["logprobs"] = logprobs
    return {
        "id": cid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }


def completion_response(
    cid: str, model: str, text: str, finish_reason: str,
    prompt_tokens: int, completion_tokens: int,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    choice: Dict[str, Any] = {
        "index": 0, "text": text, "finish_reason": finish_reason,
        "logprobs": logprobs,
    }
    return {
        "id": cid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }


def format_chat_prompt(messages: List[Dict[str, str]], tokenizer=None) -> str:
    """Render chat messages to a prompt string. Uses the tokenizer's chat
    template when available, else the reference's simple User/Assistant
    format (reference client/bitnet_client.py:205-219)."""
    if tokenizer is not None and getattr(tokenizer, "chat_template", None):
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if role == "system":
            parts.append(f"System: {content}")
        elif role == "assistant":
            parts.append(f"Assistant: {content}")
        else:
            parts.append(f"User: {content}")
    parts.append("Assistant:")
    return "\n".join(parts)
