"""Profiling and timing: traces, device timers, analytic MFU, FLOP counting.

Port of ``vitok_tpu/utils/profiling.py``, under the same names:

* :func:`trace` -- ``torch.profiler`` around a block (CUDA activity on the
  card), a Chrome trace written to ``log_dir``;
* :class:`DeviceTimer` -- CUDA events on the card, the host clock on the CPU;
* :func:`mfu` -- analytic model-FLOPs utilization, ``k * N * tokens/s /
  (peak * chips)`` (k = 6 training, 2 inference);
* :func:`flops_of` -- ``torch.utils.flop_counter.FlopCounterMode``;
* :func:`device_memory_stats` -- ``torch.cuda.memory_stats`` per card.

``flops_of``, ``device_memory_stats`` and ``DeviceTimer.fence`` are library
API kept under the JAX names; no script of the port calls them yet.

The MFU inputs every entry point shares: :data:`PEAK_KEYS` (the peak each
weight dtype is held to) and :func:`count_params`.

It also holds the timers ``chip_smoke.py``, ``bench_torch.py`` and the
entry points of ``vitok_torch.benchmarks`` share (:func:`time_ms`,
:func:`device_ms`, :func:`profiler_records`, :func:`card_line`), and the
names by which a profiler's kernel records are grouped
(:func:`kernel_group`).
"""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

# Per-card dense peak FLOP/s (bf16 unless the key says otherwise).
PEAK_FLOPS = {
    "v4": 275e12,
    "v5e": 197e12,
    "v5p": 459e12,
    "v6e": 918e12,
    "h100": 989e12,        # H100 SXM, bf16 tensor cores (data sheet, 700 W)
    "h100_int8": 1979e12,  # H100 SXM, int8 tensor cores (TOP/s)
    "a100": 312e12,
}
# The peak an MFU of each weight dtype is held to.
PEAK_KEYS = {"bf16": "h100", "int8": "h100_int8"}


def count_params(model: torch.nn.Module) -> int:
    """Weight count for the MFU estimate: every entry of the model's state
    dict but the int8 bookkeeping scales. Count it before quantizing, so that
    a model's bf16 and int8 MFU use the same count."""
    return sum(v.numel() for k, v in model.state_dict().items() if not k.endswith(".scale"))


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` over the enclosed block: host activity, and CUDA
    activity where a card is present. Yields the profiler (its ``events()``
    are the records); on exit writes a Chrome trace to
    ``log_dir/trace.json`` (default: ``vitok_trace`` in the temporary
    directory)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "vitok_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class DeviceTimer:
    """Times each ``with`` block: on the card the distance between two CUDA
    events recorded at the block's entry and exit (the exit waits for the
    end event), on the CPU the host clock with no fence.

    ``times`` holds one duration in seconds per block.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.times: list = []
        self._start: Any = None

    def __enter__(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            self.times.append(self._start.elapsed_time(end) / 1e3)
        else:
            self.times.append(time.perf_counter() - self._start)

    def fence(self, value: Any) -> Any:
        """Wait for the card's work so far (nothing on the CPU); returns ``value``."""
        if self.cuda:
            torch.cuda.synchronize()
        return value

    @property
    def total(self) -> float:
        return float(sum(self.times))

    @property
    def count(self) -> int:
        return len(self.times)

    @property
    def mean_s(self) -> float:
        return self.total / max(self.count, 1)


def mfu(
    n_params: int,
    tokens_per_s: float,
    n_chips: int = 1,
    peak: Union[str, float] = "h100",
    training: bool = True,
) -> float:
    """Analytic MFU: ``k * N * tokens/s / (peak * chips)``; k=6 train, 2 infer."""
    if isinstance(peak, str):
        peak = PEAK_FLOPS[peak]
    k = 6.0 if training else 2.0
    return k * n_params * tokens_per_s / (peak * n_chips)


def flops_of(fn: Callable, *args, **kwargs) -> Dict[str, Optional[float]]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, counted by
    ``FlopCounterMode`` over the aten operators it knows (matrix products,
    convolutions, attention). A kernel launched through ``ctypes`` (the
    port's CUDA kernels) is invisible to it. The flop counter counts no
    bytes: ``bytes_accessed`` is None."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": None}


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Per-card memory stats in bytes (``torch.cuda.memory_stats``): what the
    caching allocator holds now and at its peak, and the card's size; ``{}``
    without a card."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


# ---------------------------------------------------------------------------
# The port's shared timers
# ---------------------------------------------------------------------------


def time_ms(fn: Callable[[], object], runs: int = 10, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn()``: ``runs`` calls enqueued back to back
    between two CUDA events, after ``warmup`` calls; the median of three such
    chains. Where the device is slower than the host's enqueueing, the
    enqueueing overlaps it and this is the device's time; where the host is
    slower, the host's."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return float(np.median(times))


def profiler_records(fn: Callable[[], object], runs: int = 5) -> list:
    """The CUDA kernel records ``torch.profiler`` keeps over ``runs`` calls
    of ``fn()`` (after one call outside the session): one duration in ms per
    record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return [e.device_time_total / 1e3 for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn: Callable[[], object], runs: int = 5) -> float:
    """Device time of a call of ``fn()``: the CUDA kernels' times that
    ``torch.profiler`` records over ``runs`` calls, summed, per call. Host
    time between the kernels does not count (``time_ms`` counts it where the
    host is the slower side); 0.0 where the profiler records no device time.
    Late in a long process the profiler keeps only some of the records, or
    none: there ``vitok_torch.benchmarks.host_ahead_ms`` reads the card."""
    return sum(profiler_records(fn, runs)) / runs


def card_line(device: Optional[torch.device] = None) -> str:
    """``name, power limit`` of the card from ``nvidia-smi`` (the CPU, when
    ``device`` is given and is not a CUDA device, says so)."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu (plain versions, host clock: no device time)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Kernel records by name
# ---------------------------------------------------------------------------

# The port's kernels by the base name the profiler records, grouped by the
# wrapper that launches them; then the library's matrix products
# (cuBLAS/cuBLASLt, torch._int_mm included) by markers in their names, then
# everything else.
PORT_KERNEL_GROUPS = {
    "fused_attention_sm90_kernel": "fused_attention",
    "fused_qk_prologue_kernel": "fused_qk_prologue",
    "fused_attention_kernel": "fused_attention_mma",  # the mma.sync forward, bf16 or fp32 (FMA)
    "fused_attention_f32_sm90_kernel": "fused_attention_f32",
    "fused_attention_q8_sm90_kernel": "fused_attention_q8",
    "fused_bwd_dq_kernel": "fused_attention_bwd",
    "fused_bwd_dkv_kernel": "fused_attention_bwd",
    "flash_attention_kernel": "flash_attention",
    "flash_bwd_delta_kernel": "flash_attention_dq",  # dq's prologue
    "flash_bwd_dq_kernel": "flash_attention_dq",
    "flash_bwd_dkv_kernel": "flash_attention_dkv",
    "fused_qk_prologue_f32_kernel": "fused_qk_prologue_f32",
    "flash_attention_f32_kernel": "flash_attention_f32",
    "flash_bwd_dq_f32_kernel": "flash_attention_dq_f32",  # also the fp32 #3's dq (the launch counters tell)
    "flash_bwd_dkv_f32_kernel": "flash_attention_dkv_f32",  # and its dk/dv
    "rmsnorm_quant_kernel": "rmsnorm_quant",
    "ffn_int8_kernel": "ffn_int8",
    "silu_quant_kernel": "silu_quant",
    "fused_attention_bb_sm90_kernel": "fused_attention_bb",
    "fused_attention_bb_f32_sm90_kernel": "fused_attention_bb_f32",
    "fused_attention_pack_sm90_kernel": "fused_attention_pack",
    "fused_attention_pack_f32_sm90_kernel": "fused_attention_pack_f32",
    "fused_attention_q8in_sm90_kernel": "fused_attention_q8in",
    "fused_attention_contig_sm90_kernel": "fused_attention_contig",
    "fused_attention_contig_f32_sm90_kernel": "fused_attention_contig_f32",
}
MATMUL_MARKERS = ("gemm", "xmma", "cutlass", "nvjet", "matmul", "imma")


def kernel_base_name(name: str) -> str:
    """``void (anonymous namespace)::ffn_int8_kernel<128>(CUtensorMap_st...)``
    -> ``ffn_int8_kernel``."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].rsplit("::", 1)[-1].strip()


def kernel_group(name: str) -> str:
    """The wrapper a recorded kernel belongs to, ``"matmul"`` or ``"other"``."""
    group = PORT_KERNEL_GROUPS.get(kernel_base_name(name))
    if group is not None:
        return group
    return "matmul" if any(w in name.lower() for w in MATMUL_MARKERS) else "other"


__all__ = [
    "trace",
    "DeviceTimer",
    "mfu",
    "flops_of",
    "device_memory_stats",
    "PEAK_FLOPS",
    "PEAK_KEYS",
    "count_params",
    "time_ms",
    "device_ms",
    "profiler_records",
    "card_line",
    "PORT_KERNEL_GROUPS",
    "kernel_base_name",
    "kernel_group",
]
