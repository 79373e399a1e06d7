"""Memory-bandwidth / roofline reporter (PyTorch port of
``wrinklefree_tpu/bench/roofline.py``).

Batch-1 ternary decode is bound by the memory rate, so a kernel's headline
number is its share of the card's peak bytes per second; compute-bound
shapes report their share of the peak operation rate instead.
``GPU_SPECS`` takes the place of the reference's ``TPU_SPECS``: the H100's
published figures (NVIDIA's data sheet, SXM part, dense rates at the full
700 W power limit), the one table the port's bounds read (``chip_smoke.py``
and the kernel benches), and the reference's ``"cpu"`` figures, so that both
packages give the same numbers for the same spec.

The module imports nothing of the package and no torch at import: the
kernel benches, run as files, import it from their own directory.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# Peak specs per device. bf16/fp16/TF32/f32 FLOP/s, int8 OP/s, memory B/s, GB.
GPU_SPECS: Dict[str, Dict[str, float]] = {
    "h100": {"bf16_flops": 989e12, "fp16_flops": 989e12, "tf32_flops": 495e12,
             "f32_flops": 67e12, "int8_ops": 1979e12, "hbm_bw": 3.35e12, "hbm_gb": 80},
    "cpu": {"bf16_flops": 1e12, "int8_ops": 2e12, "hbm_bw": 50e9, "hbm_gb": 64},
}
# operand kind -> its key in a spec
PEAK_KEYS = {"int8": "int8_ops", "bf16": "bf16_flops", "fp16": "fp16_flops",
             "tf32": "tf32_flops", "f32": "f32_flops"}


def peak_ops(chip: str = "h100") -> Dict[str, float]:
    """The chip's peak operation rate per operand kind (``int8``, ``bf16``,
    ``fp16``, ``tf32``, ``f32``: those its spec has)."""
    spec = GPU_SPECS[chip]
    return {kind: spec[key] for kind, key in PEAK_KEYS.items() if key in spec}


def _device(device):
    """The entry points' device rule: CUDA unless the caller names another
    device; CUDA on a host without it raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to read the CPU's figures")
    return dev


def detect_chip(device=None) -> str:
    """Map a torch device (default CUDA) to a GPU_SPECS key: ``"h100"`` for
    an H100, ``"cpu"`` otherwise."""
    import torch

    dev = _device(device)
    if dev.type == "cuda" and "h100" in torch.cuda.get_device_name(dev).lower():
        return "h100"
    return "cpu"


def device_memory_stats(device=None) -> Dict[str, float]:
    """Live device memory from the caching allocator (bytes): in use, the
    card's total and the peak in use (zeros on the CPU, as the reference
    reports a device without statistics)."""
    import torch

    dev = _device(device)
    if dev.type != "cuda":
        return {"bytes_in_use": 0.0, "bytes_limit": 0.0, "peak_bytes_in_use": 0.0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": float(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": float(torch.cuda.get_device_properties(dev).total_memory),
        "peak_bytes_in_use": float(stats.get("allocated_bytes.all.peak", 0)),
    }


def ternary_matmul_traffic(batch: int, k: int, n: int) -> Dict[str, float]:
    """Memory bytes and integer ops for one packed-ternary matmul: weights
    2-bit packed (k*n/4 bytes), activations int8 in, bf16 out."""
    bytes_w = k * n / 4
    bytes_x = batch * k  # int8
    bytes_o = batch * n * 2  # bf16
    return {
        "bytes": bytes_w + bytes_x + bytes_o,
        "flops": 2.0 * batch * k * n,
    }


@dataclasses.dataclass
class RooflinePoint:
    name: str
    time_ms: float
    gbytes_per_s: float
    gflops: float
    bw_utilization: float  # fraction of peak memory bandwidth
    compute_utilization: float  # fraction of the peak of compute_key
    bound: str  # "memory" | "compute"

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def roofline(
    name: str,
    time_s: float,
    bytes_moved: float,
    flops: float,
    chip: Optional[str] = None,
    compute_key: str = "int8_ops",
) -> RooflinePoint:
    """Score one measured kernel against the chip's roofline."""
    spec = GPU_SPECS[chip or detect_chip()]
    achieved_bw = bytes_moved / time_s
    achieved_fl = flops / time_s
    # which wall does the ideal kernel hit first at this arithmetic intensity?
    t_mem = bytes_moved / spec["hbm_bw"]
    t_cmp = flops / spec[compute_key]
    return RooflinePoint(
        name=name,
        time_ms=time_s * 1e3,
        gbytes_per_s=achieved_bw / 1e9,
        gflops=achieved_fl / 1e9,
        bw_utilization=achieved_bw / spec["hbm_bw"],
        compute_utilization=achieved_fl / spec[compute_key],
        bound="memory" if t_mem >= t_cmp else "compute",
    )


def decode_step_traffic(cfg, batch: int = 1, context: int = 512) -> Dict[str, float]:
    """Memory traffic of one full decode step of the model: all packed
    weights once + KV history + the logits matmul."""
    H, I, Q, KV = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    L, V = cfg.num_layers, cfg.vocab_size
    w_bytes = L * (H * Q + 2 * H * KV + Q * H + 2 * H * I + I * H) / 4
    kv_bytes = L * batch * context * KV * 2 * 2  # K+V bf16
    logits_bytes = V * H * 2  # tied embedding matmul, bf16
    flops = 2.0 * batch * (
        L * (H * Q + 2 * H * KV + Q * H + 2 * H * I + I * H) + V * H
    ) + 4.0 * batch * L * context * Q
    return {"bytes": w_bytes + kv_bytes + logits_bytes, "flops": flops}


def speed_of_light_toks(cfg, batch: int = 1, context: int = 512,
                        chip: Optional[str] = None) -> float:
    """Upper bound on decode tok/s per device: the memory-rate-limited time
    of one step."""
    spec = GPU_SPECS[chip or detect_chip()]
    t = decode_step_traffic(cfg, batch, context)["bytes"] / spec["hbm_bw"]
    return batch / t
