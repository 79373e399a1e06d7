"""Ternarize arbitrary parameter trees (the "model patcher"), PyTorch port
of ``wrinklefree_tpu/models/patcher.py``.

Any 2-D float tensor in a tree of dicts, lists and tuples whose path
matches the patterns is replaced by a :class:`TernaryParam` (packed qweight
+ scale), and :func:`ternary_apply` is the drop-in matmul for it, so any
model whose weights sit in such a tree can run its linears through the
packed-ternary path: K7's exact int32 mode (``ops/ternary_cuda.py``
``ternary_matmul``) on the card, its plain version on the CPU.
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple, Sequence, Tuple

import torch

from ..ops.ternary import pack_ternary_np, quantize_weights_ternary, ternary_linear
from ..ops.ternary_cuda import ternary_matmul

DEFAULT_PATTERNS = (
    r".*(q|k|v|o)_proj.*", r".*(gate|up|down)_proj.*",
    r".*attention.*(query|key|value|dense).*", r".*mlp.*",
)


class TernaryParam(NamedTuple):
    """Packed replacement for a [K, N] float weight."""

    qweight: torch.Tensor  # [K//4, N] uint8
    scale: torch.Tensor  # scalar f32


def _is_target(leaf, name: str, regexes, min_size: int) -> bool:
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.dim() == 2
        and leaf.is_floating_point()
        and leaf.numel() >= min_size
        and leaf.shape[0] % 4 == 0
        and any(r.match(name) for r in regexes)
    )


def ternarize_tree(
    params: Any,
    patterns: Sequence[str] = DEFAULT_PATTERNS,
    min_size: int = 1024,
) -> Tuple[Any, int]:
    """Replace matching 2-D float leaves with TernaryParam, on the leaf's
    device.

    Weights are interpreted as [K, N] (inputs-first); transpose
    torch-convention [out, in] weights before calling. A leaf's path joins
    its keys with ``/`` as the reference names them: a dict key as itself, a
    list or tuple index as ``[i]``. Returns (new_tree, num_patched).
    """
    regexes = [re.compile(p) for p in patterns]
    count = 0

    def walk(node, path):
        nonlocal count
        if isinstance(node, dict):
            return type(node)((k, walk(v, path + [str(k)])) for k, v in node.items())
        if isinstance(node, (list, tuple)):
            items = [walk(v, path + [f"[{i}]"]) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):  # a NamedTuple
                return type(node)(*items)
            return type(node)(items)
        if _is_target(node, "/".join(path), regexes, min_size):
            tern, scale = quantize_weights_ternary(node.detach().float().cpu().numpy())
            count += 1
            return TernaryParam(torch.from_numpy(pack_ternary_np(tern)).to(node.device),
                                torch.tensor(scale, dtype=torch.float32, device=node.device))
        return node

    return walk(params, []), count


def ternary_apply(
    x: torch.Tensor, p: TernaryParam, out_dtype=torch.bfloat16, kernel=ternary_matmul
) -> torch.Tensor:
    """Drop-in ``x @ W`` for a patched weight: ``ternary_linear`` with K7's
    exact int32 dot (``kernel``) in place of the reference's XLA matmul."""
    return ternary_linear(x, p.qweight, p.scale, out_dtype=out_dtype, kernel=kernel)
