"""The port's counterparts of the JAX project's A/B attention experiments.

``benchmarks/ab_batch_block.py`` and ``benchmarks/ab_q8_input.py`` (JAX)
time variants of the fused attention kernel against it. Here each variant
is a hand-written Hopper kernel beside its plain PyTorch version: in bf16 the
batch-block, pack and contig variants run the wgmma walker
(``vitok_torch/csrc/fused_attention_ab_sm90.cu``), in fp32 the fp32 walker
(``fused_attention_ab_f32_sm90.cu``, which the fp32 forward runs too), and
the int8-input variant a walk of its own over the same wgmma body, its q and
v tiles arriving as codes (``fused_attention_q8in_sm90.cu``). Each
module's ``main()`` takes the JAX script's flags (plus ``--device``) and
builds, checks and times the same arms:

    python -m vitok_torch.benchmarks.ab_batch_block --c 3072 --heads 24 --tokens 256 --batch 64 --layers 256 --iters 6
    python -m vitok_torch.benchmarks.ab_q8_input --c 3072 --heads 24 --tokens 256 --batch 64

Shared here: the kernel libraries' bindings, the JAX package's head-group
pick (for the arms' descriptions), the inputs and the timing (chained calls,
calls with the host ahead; the profiler's kernel records and the card's line
come from ``vitok_torch.utils.profiling``), and ``bench_torch.py``'s dense
batch and chained-forward timing (``make_batch``, ``measure``).

The JAX package's measurement scripts have their counterparts here too:
``benchmark_mfu`` (forward and train-step MFU), ``profile_forward`` (device
time of one step by kernel category), ``bench_dit_train`` (the DiT
flow-matching step) and ``bench_generation`` (UniPC sampling and decode).
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, Optional

import numpy as np
import torch

from vitok_torch.ops import _build
from vitok_torch.ops import fused_attention as fa
from vitok_torch.utils.profiling import DeviceTimer, card_line, profiler_records

_VMEM_BUDGET = 13 * 1024 * 1024  # the JAX package's per-cell budget (bytes)


def pick_group_channels(c: int, d: int, n: int) -> int:
    """The JAX package's head-group pick for its fused forward
    (``vitok_tpu/ops/fused_attention.py`` ``_pick_group_channels`` with the
    forward estimate and 128-lane alignment): the channels one TPU grid cell
    takes. 0 if no group fits."""
    best = 0
    cg = d
    while cg <= c:
        if c % cg == 0 and cg % 128 == 0:
            if best == 0:
                best = cg
            elif 16 * n * cg + 10 * n * n <= _VMEM_BUDGET and (cg < c or c == d):
                best = cg
        cg += d
    if n <= 64 and best > 4 * d:
        cand = 4 * d
        if cand < c and c % cand == 0 and cand % 128 == 0:
            best = cand
    return best


def q8in_lib() -> ctypes.CDLL:
    """``csrc/fused_attention_q8in_sm90.cu`` (the int8-input kernel on the
    wgmma body), built on first use."""
    lib = _build.load("fused_attention_q8in_sm90")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_attention_q8in_sm90, [ptr] * 8 + [i] * 7 + [ptr]),
        (lib.vitok_fused_attention_q8in_sm90_attributes, [i] * 2 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def sm90_lib() -> ctypes.CDLL:
    """``csrc/fused_attention_ab_sm90.cu`` (the bf16 batch-block, pack and
    contig kernels on the wgmma walker), built on first use."""
    lib = _build.load("fused_attention_ab_sm90")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for fn, argtypes in (
        (lib.vitok_fused_attention_pack_sm90, [ptr] * 7 + [i] * 6 + [ptr]),
        (lib.vitok_fused_attention_bb_sm90, [ptr] * 7 + [i] * 7 + [ptr]),
        (lib.vitok_fused_attention_contig_sm90, [ptr] * 7 + [i] * 5 + [ptr]),
        (lib.vitok_fused_attention_ab_sm90_attributes, [i] * 3 + [ptr]),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def walk_sm90(qkv: torch.Tensor, kn: torch.Tensor, q_scale: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
              mask: Optional[torch.Tensor], num_heads: int, *, sw: int = -1, bb: int = 0, hpb: int = 0,
              pack: bool = False) -> torch.Tensor:
    """One launch of a bf16 wgmma walker on ``kn``, the q/k prologue's
    normed k (``[B, N, C]``): with ``bb`` > 0 the pack kernel (``pack``; no
    window) or the batch-block kernel (window ``sw``, -1 for none), ``bb``
    images x ``hpb`` heads a block; with ``bb`` = 0 the contig kernel (all
    heads of a sample a block, window ``sw``). The other arguments as
    ``fused_attention._check_cuda_args`` returns them. Counts nothing: its
    callers count."""
    b, n, c3 = qkv.shape
    out = torch.empty((b, n, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = sm90_lib()
    d = c3 // 3 // num_heads
    ptrs = (kn.data_ptr(), qkv.data_ptr(), q_scale.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    kind = "contig" if bb == 0 else ("pack" if pack else "bb")
    with torch.cuda.device(qkv.device):
        if kind == "pack":
            err = lib.vitok_fused_attention_pack_sm90(*ptrs, b, n, num_heads, d, bb, hpb, stream)
        elif kind == "bb":
            err = lib.vitok_fused_attention_bb_sm90(*ptrs, b, n, num_heads, d, bb, hpb, sw, stream)
        else:
            err = lib.vitok_fused_attention_contig_sm90(*ptrs, b, n, num_heads, d, sw, stream)
    _build.check(lib, err, f"fused_attention_{kind}_sm90 launch")
    return out


def walk_f32(qkv: torch.Tensor, q_scale: torch.Tensor, k_scale: torch.Tensor, cos: torch.Tensor,
             sin: torch.Tensor, mask: Optional[torch.Tensor], num_heads: int, *, bb: int, hpb: int, sw: int = -1,
             pack: bool = False, kind: Optional[str] = None) -> torch.Tensor:
    """One launch of the fp32 walker on an fp32 ``qkv`` (q and k normed in
    the kernel), through the one C entry of the library the fp32 forward
    loads (``fused_attention._walk_f32_cuda``): ``bb`` images x ``hpb`` heads
    a block, packed (``pack``; no window) or each its own softmax (window
    ``sw``, -1 for none), on the batch-block or pack kernel, or on the kernel
    ``kind`` names (one of ``fused_attention.F32_WALK_KINDS``: ``"fwd"`` the
    fp32 forward, ``"contig"`` with ``bb`` 1 and ``hpb`` all heads). The
    other arguments as ``fused_attention._check_cuda_args`` returns them.
    Counts nothing: its callers count."""
    kind = kind or ("pack" if pack else "bb")
    return fa._walk_f32_cuda(qkv, q_scale, k_scale, cos, sin, mask, num_heads, bb=bb, hpb=hpb, sw=sw, kind=kind)


# The walker kernels: the bf16 contig, pack and batch-block kernels, the
# int8-input kernel, and the fp32 ones (the fp32 forward's, then #10, #11 and
# #13 in fp32).
WALKER_KINDS = ("contig", "pack", "bb", "q8in") + tuple(k + "_f32" for k in fa.F32_WALK_KINDS)


def sm90_attributes(d: int, kind: str, bb: int = 1) -> dict:
    """Registers and local memory (spills) a thread, blocks an SM and shared
    memory a block of one walker instance at head dim ``d``, as the compiler
    and the card report them: ``kind`` one of ``WALKER_KINDS``, ``bb``
    images a block."""
    if kind.endswith("_f32"):
        return fa.f32_walk_attributes(d, kind[:-len("_f32")], bb)
    out = (ctypes.c_int * 4)()
    if kind == "q8in":
        lib = q8in_lib()
        err = lib.vitok_fused_attention_q8in_sm90_attributes(d, bb, out)
    else:
        lib = sm90_lib()
        err = lib.vitok_fused_attention_ab_sm90_attributes(d, ("contig", "pack", "bb").index(kind), bb, out)
    _build.check(lib, err, f"{kind} walker attributes")
    return dict(registers=out[0], local_bytes=out[1], blocks_per_sm=out[2], smem_bytes=out[3])


def check_device(t: torch.Tensor) -> None:
    """The wrappers run their kernel on a CUDA tensor and their plain version
    on a CPU tensor; any other device raises."""
    if not t.is_cuda and t.device.type != "cpu":
        raise RuntimeError(f"no fused attention kernel for device {t.device}")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain versions")
    return device


def rope_inputs(b: int, n: int, d: int, device, gen: torch.Generator):
    """The JAX scripts' gains (1 + 0.1 N(0, 1)) and rope tables
    (``cos(pos * exp(-i / (d/2)))``, one row per token, the same for every
    sample), drawn from ``gen``."""
    q_scale = 1.0 + 0.1 * torch.randn(d, generator=gen)
    k_scale = 1.0 + 0.1 * torch.randn(d, generator=gen)
    pos = torch.arange(n, dtype=torch.float32)[:, None]
    freq = torch.exp(-torch.arange(d // 2, dtype=torch.float32) / (d // 2))
    cos = torch.cos(pos * freq)[None].expand(b, n, d // 2).contiguous()
    sin = torch.sin(pos * freq)[None].expand(b, n, d // 2).contiguous()
    return q_scale.to(device), k_scale.to(device), cos.to(device), sin.to(device)


def chained_ms(call: Callable[[torch.Tensor], torch.Tensor], cos: torch.Tensor, layers: int,
               tick: float) -> float:
    """Milliseconds per call of ``layers`` chained calls: each call's input
    table is ``cos + dep``, with ``dep`` zero times a probe of the previous
    output, so the calls run in order and the dependency pass touches only
    the small table, never qkv. CUDA events on the card (the probes summed on
    the device, read once at the end), the host clock on the CPU."""
    cuda = cos.is_cuda
    dep = torch.full((), tick, device=cos.device)
    acc = torch.zeros((), device=cos.device)
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    else:
        t0 = time.perf_counter()
    for _ in range(layers):
        out = call(cos + dep)
        probe = (out[0, 0, 0] + out[-1, -1, -1]).float()
        dep = probe * 0.0
        acc = acc + probe
    if cuda:
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
    else:
        ms = (time.perf_counter() - t0) * 1e3
    float(acc)
    return ms / layers


def _held(enqueue: Callable[[], None], hold_cycles: int, doublings: int = 4) -> float:
    """Run ``enqueue()`` on the host while a spin kernel (``torch.cuda._sleep``,
    ``hold_cycles`` clock cycles) holds the stream, so the card never waits for
    the host; returns the host's milliseconds. Where the host needed longer than
    the hold (the card would then have waited for it, and what ``enqueue``
    recorded is not what it claims), the hold is doubled and ``enqueue`` run
    again, at most ``doublings`` times; after that it raises."""
    for _ in range(doublings + 1):
        torch.cuda.synchronize()
        hold = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        hold[0].record()
        torch.cuda._sleep(hold_cycles)
        hold[1].record()
        t0 = time.perf_counter()
        enqueue()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        hold_ms = hold[0].elapsed_time(hold[1])
        if host_ms < hold_ms:
            return host_ms
        hold_cycles *= 2
    raise RuntimeError(f"the host took {host_ms:.3f} ms to enqueue its calls, longer than the "
                       f"{hold_ms:.3f} ms hold after {doublings} doublings: raise hold_cycles")


def host_ahead_ms(fn: Callable[[], object], runs: int = 5, hold_cycles: int = 20_000_000) -> float:
    """Device milliseconds a call of ``fn()`` takes when the card never waits
    for the host: a spin kernel (``hold_cycles`` clock cycles, about 10 ms,
    doubled where the host was slower, see ``_held``) holds the stream while
    the host enqueues ``runs`` calls, each between two CUDA events; the mean
    of the events' distances. A call's kernels and the device's gaps between
    them count, the host's time does not."""
    fn()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(runs)]

    def enqueue():
        for start, end in marks:
            start.record()
            fn()
            end.record()

    _held(enqueue, hold_cycles)
    return sum(start.elapsed_time(end) for start, end in marks) / runs


def host_us(fn: Callable[[], object], runs: int = 200, hold_cycles: int = 200_000_000) -> float:
    """Host microseconds a call of ``fn()`` takes to enqueue its work: a spin
    kernel (``hold_cycles`` clock cycles, about 100 ms, doubled where the host
    was slower, see ``_held``) holds the stream, so the host never waits for
    the card, while the host makes ``runs`` calls on the host's clock."""
    fn()

    def enqueue():
        for _ in range(runs):
            fn()

    return _held(enqueue, hold_cycles) / runs * 1e3


def make_batch(b: int, n: int, grid, pixels_per_token: int, seed: int = 0, patch: int = 16, device="cuda"):
    """A dense NaFlex batch of ``b`` images of ``n`` tokens on a ``grid``:
    ``bench.py``'s ``make_batch`` draws (numpy, ``seed``) as tensors on
    ``device``, the patches in bf16."""
    rng = np.random.default_rng(seed)
    gr, gc = grid
    yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
    tile = lambda a: torch.from_numpy(np.tile(a.ravel()[None], (b, 1)).astype(np.int32)).to(device)
    patches = torch.from_numpy(rng.standard_normal((b, n, pixels_per_token)).astype(np.float32))
    return {
        "patches": patches.to(torch.bfloat16).to(device),
        "patch_mask": torch.ones((b, n), dtype=torch.bool, device=device),
        "row_idx": tile(yy),
        "col_idx": tile(xx),
        "orig_height": torch.full((b,), gr * patch, dtype=torch.int32, device=device),
        "orig_width": torch.full((b,), gc * patch, dtype=torch.int32, device=device),
    }


def measure(fwd, patches, b: int, iters: int, device) -> dict:
    """Time ``fwd`` (patches -> patches): one warm-up, one forward alone to
    pick ``chain`` (about 1.5 s of work a repeat, 2 to 32 forwards), then
    ``iters`` repeats of ``chain`` forwards, each feeding the next, on
    :class:`DeviceTimer` (CUDA events on the card, the host clock on the
    CPU). Every repeat's output must be finite.

    Returns ``img_per_s`` and ``ms_per_img`` (the median repeat),
    ``ms_spread`` ((max - min) / median over the repeats) and ``forwards``
    (how many forwards ran)."""
    fwd(patches)
    single = DeviceTimer(device)
    with single:
        fwd(patches)
    chain = int(min(max(round(1.5 / max(single.times[0], 1e-3)), 2), 32))
    timer = DeviceTimer(device)
    finite = []
    for _ in range(iters):
        pt = patches
        with timer:
            for _ in range(chain):
                pt = fwd(pt)
        finite.append(torch.isfinite(pt).all())
    if not all(bool(f) for f in finite):
        raise FloatingPointError("non-finite outputs")
    per_img = np.asarray(timer.times) / (chain * b)
    med = float(np.median(per_img))
    return {"img_per_s": 1.0 / med, "ms_per_img": med * 1e3,
            "ms_spread": float((per_img.max() - per_img.min()) / med), "forwards": 2 + iters * chain}


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, rows: Optional[torch.Tensor] = None) -> float:
    d = (a.float() - b.float()).abs()
    return float((d if rows is None else d[rows]).max())


__all__ = ["pick_group_channels", "q8in_lib", "sm90_lib", "walk_sm90", "walk_f32", "WALKER_KINDS",
           "sm90_attributes", "check_device", "card_line", "resolve_device", "rope_inputs", "chained_ms",
           "host_ahead_ms", "host_us", "profiler_records", "make_batch", "measure", "max_abs_diff"]
