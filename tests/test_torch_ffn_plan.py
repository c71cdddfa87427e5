"""The tiling plan of the fused int8 FFN kernel (``ffn_int8.cu``), on the CPU.

``ffn_int8_plan`` cuts a call into clusters of blocks that share a tile of
token rows and split the F' t-columns between them; the kernel computes each
rank's columns with the same formula and its shared memory with
``_ffn_smem_bytes``'s. These tests hold the plan over every shape the gate
opens on the model paths and the card tests (the 350M and 5B widths, ragged
M, a narrow F'), check that shapes no plan hosts raise, and that the wrapper
hands the plan to the kernel's C entry (a tensor that poses as a card
tensor, the library replaced by a recorder). No JAX here.
"""

import types

import pytest
import torch

from vitok_torch.ops import quant as t_q

torch.set_num_threads(1)

SMEM_LIMIT = 232448

SHAPES = [  # (M, C, F'): every shape the fused FFN serves on the model paths and in the card tests
    (16384, 1024, 2816),  # 350M, 256p B 64 and 512p B 16
    (4096, 1024, 2816),
    (16384, 3072, 8320),  # the 5B width
    (4096, 3072, 8320),
    (4096, 4096, 11008),  # the E width: a cluster of 16
    (16384, 4096, 11008),
    (4096, 3072, 12288),  # the 5B width at an mlp factor of 4
    (1000, 1024, 2816),   # ragged M
    (200, 1024, 2816),
    (24, 256, 256),       # the card test's narrow F'
    (8, 256, 128),        # F' 128, M 8
    (512, 256, 256),
]


@pytest.mark.parametrize("m,c,fp", SHAPES)
def test_plan_covers_every_column_once(m, c, fp):
    plan = t_q.ffn_int8_plan(m, c, fp)
    assert plan.rows in (64, 128) and 3 <= plan.stages <= 4
    assert 1 <= plan.cluster <= 16 and plan.cluster == len(plan.col_ranges)
    edges = [lo for lo, _ in plan.col_ranges] + [plan.col_ranges[-1][1]]
    assert edges[0] == 0 and edges[-1] == fp
    for (lo, hi), nxt in zip(plan.col_ranges, edges[1:]):
        assert hi == nxt and hi > lo and lo % 64 == 0 and hi % 64 == 0
    widest = max(hi - lo for lo, hi in plan.col_ranges)
    assert widest == -(-fp // 64 // plan.cluster) * 64  # the staged slab the kernel sizes for


@pytest.mark.parametrize("m,c,fp", SHAPES)
def test_plan_fits_shared_memory(m, c, fp):
    plan = t_q.ffn_int8_plan(m, c, fp)
    assert plan.smem_bytes == t_q._ffn_smem_bytes(plan.rows, plan.cluster, plan.stages, fp) <= SMEM_LIMIT
    if plan.stages < 4:  # as many stages as fit
        assert t_q._ffn_smem_bytes(plan.rows, plan.cluster, plan.stages + 1, fp) > SMEM_LIMIT


@pytest.mark.parametrize("m,c,fp,want", [
    (16384, 1024, 2816, (128, 8, 3)),  # 350M: 44 tiles, 5-6 a block; t staged 128 x 384 bf16
    (16384, 3072, 8320, (64, 8, 3)),   # 5B: 130 tiles, 16-17 a block; 128 rows would not fit
    (4096, 4096, 11008, (64, 16, 4)),  # E: 172 tiles; 22 a block of 8 leave room for two stages only
    (24, 256, 256, (64, 4, 4)),        # four tiles, one a block; M <= 64 takes 64 rows
    (8, 256, 128, (64, 2, 4)),
])
def test_plan_of_the_main_shapes(m, c, fp, want):
    assert tuple(t_q.ffn_int8_plan(m, c, fp)[:3]) == want


@pytest.mark.parametrize("m,c,fp", [
    (16384, 1024, 19648),  # F' not a multiple of 128, past the staged plans' widths
    (16384, 1000, 2816),   # C not a multiple of 128
    (16384, 1024, 2752),   # F' not a multiple of 128
    (1001, 1024, 2816),    # M not a multiple of 8
    (0, 1024, 2816),
])
def test_plan_raises_where_nothing_fits(m, c, fp):
    with pytest.raises(ValueError, match="ffn_int8"):
        t_q.ffn_int8_plan(m, c, fp)


def test_widest_hosted_width():
    """The widest F' whose t a cluster stages in shared memory: 304 tiles
    (19 a block of a cluster of 16, three stages); a cluster of 8 hosts up
    to 152 tiles (19 a block). Wider rows take the scratch instance."""
    assert tuple(t_q.ffn_int8_plan(64, 1024, 304 * 64)[1:3]) == (16, 3)
    assert not t_q.ffn_int8_plan(64, 1024, 304 * 64).scratch
    assert t_q.ffn_int8_plan(64, 1024, 306 * 64).scratch
    assert tuple(t_q.ffn_int8_plan(64, 1024, 152 * 64)[1:3]) == (8, 3)
    assert t_q.ffn_int8_plan(64, 1024, 154 * 64).cluster == 16


@pytest.mark.parametrize("m,c,fp,rows", [
    (2048, 1024, 20480, 128),   # the card test's shape
    (16384, 1024, 19584, 128),  # 306 tiles: the first width past the staged plans
    (64, 256, 32768, 64),       # M <= 64 takes 64 rows
    (1000, 4096, 65536, 128),
])
def test_scratch_plan_beyond_the_staged_widths(m, c, fp, rows):
    """Past 304 tiles the plan sends t through a device scratch: a cluster
    of 8 splits the tiles, four stages, and shared memory holds the ring,
    the row maxima and the barriers only."""
    plan = t_q.ffn_int8_plan(m, c, fp)
    assert plan.scratch and plan.cluster == 8 and plan.stages == 4 and plan.rows == rows
    assert plan.smem_bytes == t_q._ffn_smem_bytes(rows, 8, 4, fp, scratch=True) <= SMEM_LIMIT
    assert plan.smem_bytes == 4 * (rows * 128 + 2 * 64 * 128) + 3 * rows * 4 + 64 + 1024
    edges = [lo for lo, _ in plan.col_ranges] + [plan.col_ranges[-1][1]]
    assert edges[0] == 0 and edges[-1] == fp and all(lo % 64 == 0 for lo in edges)


def test_every_gate_shape_has_a_plan():
    """The JAX gate (``can_fuse_ffn``) admits any 128-aligned F': so does
    the plan, staged or through the scratch."""
    for fp in range(128, 40 * 1024 + 1, 128):
        assert t_q.can_fuse_ffn(256, 1024, 2 * fp)
        plan = t_q.ffn_int8_plan(256, 1024, fp)
        assert plan.smem_bytes <= SMEM_LIMIT and plan.scratch == (fp > 304 * 64)


class Card(torch.Tensor):
    """A CPU tensor that poses as a card tensor."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("m,c,f", [(200, 1024, 2736), (24, 256, 136)])
def test_wrapper_hands_the_plan_to_the_kernel(monkeypatch, m, c, f):
    gen = torch.Generator().manual_seed(0)
    hq, hs = t_q.quantize_activation(torch.randn(m, c, generator=gen))
    w, ws = t_q.quantize_weight(t_q.pad_fc1_weight(0.05 * torch.randn(2 * f, c, generator=gen)))
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    lib = types.SimpleNamespace(vitok_ffn_int8=launch)
    monkeypatch.setattr(t_q, "_lib", lambda name: lib)
    monkeypatch.setattr(t_q, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", _NullDevice)
    before = t_q.LAUNCHES["ffn_int8"]
    q, scale = t_q.fused_ffn_int8(hq.as_subclass(Card), hs, w, ws)
    fp = t_q.pad_ffn_dim(f)
    plan = t_q.ffn_int8_plan(m, c, fp)
    assert t_q.LAUNCHES["ffn_int8"] == before + 1
    assert len(calls) == 1 and calls[0][7:13] == (m, c, fp, plan.rows, plan.cluster, plan.stages)
    assert calls[0][6] is None  # no scratch: t staged in shared memory
    assert q.shape == (m, fp) and q.dtype == torch.int8 and scale.shape == (m, 1)
    assert calls[0][4] == q.data_ptr() and calls[0][5] == scale.data_ptr()


def test_wide_wrapper_hands_a_scratch_to_the_kernel(monkeypatch):
    """At F' 20,480 the wrapper allocates the bf16 scratch (rows rounded up
    to the plan's row tile) and counts the scratch instance's launch."""
    m, c, fp = 200, 256, 20480
    gen = torch.Generator().manual_seed(1)
    hq, hs = t_q.quantize_activation(torch.randn(m, c, generator=gen))
    w, ws = t_q.quantize_weight(0.05 * torch.randn(2 * fp, c, generator=gen))
    calls, scratch = [], []

    def launch(*args):
        calls.append(args)
        return 0

    real_empty = torch.empty

    def empty(shape, **kw):
        t = real_empty(shape, **kw)
        if kw.get("dtype") == torch.bfloat16:
            scratch.append(t)
        return t

    monkeypatch.setattr(t_q, "_lib", lambda name: types.SimpleNamespace(vitok_ffn_int8=launch))
    monkeypatch.setattr(t_q, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", _NullDevice)
    monkeypatch.setattr(torch, "empty", empty)
    before = dict(t_q.LAUNCHES)
    t_q.fused_ffn_int8(hq.as_subclass(Card), hs, w, ws)
    plan = t_q.ffn_int8_plan(m, c, fp)
    assert plan.scratch and len(calls) == 1 and len(scratch) == 1
    assert scratch[0].shape == (256, fp) and calls[0][6] == scratch[0].data_ptr()
    assert calls[0][7:13] == (m, c, fp, plan.rows, plan.cluster, plan.stages)
    assert t_q.LAUNCHES["ffn_int8_wide"] == before["ffn_int8_wide"] + 1
    assert t_q.LAUNCHES["ffn_int8"] == before["ffn_int8"]


class _NullDevice:
    """``torch.cuda.device`` on a host without a card: a context that does
    nothing."""

    def __init__(self, dev):
        pass

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False
