"""The row kernels #9 (RMSNorm + quantize) and #8 (SwiGLU + quantize) on the CPU.

Both CUDA kernels (``csrc/rmsnorm_quant.cu``, ``csrc/silu_quant.cu``) walk
token rows in row groups of a persistent grid, cut by ``rmsnorm_quant_plan``
and ``silu_quant_plan``. These tests hold the plans to the kernels' rules:
the groups' walk (``csrc/row_stream.cuh``, ``stream_rows``) covers every
row once for ragged and full M in at most one wave; every width the wrappers
take (C a multiple of 8 up to 8192, F' up to 16384, bf16 and fp32) has a
plan, one of the instances the C entries dispatch to, within one block's
shared memory. #9's plain version adds the squares in the kernel's order,
checked against a Python simulation of that order on fp32 rows whose fp64
sum is inexact. The wrappers take bf16 and fp32 rows and refuse fp16
with ``TypeError``: checked on tensors that pose as card tensors, the launch
replaced by a recorder that runs the plain version. The fp32 plain versions
are held to the JAX kernels in interpret mode on f32 inputs under the rule of
``tests/test_torch_quant.py``'s ``TestPlainVersionsMatchPallas`` (the JAX
kernel sums the squares in fp32, the port in fp64): codes within one step
in at most 0.1% of the entries, scales within rtol 1e-6, pad columns 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import quant as j_q
from vitok_torch.ops import quant as t_q

torch.set_num_threads(1)

SMEM_LIMIT = 232448
SMS = 132
BLOCKS_PER_SM = 4
CODE_SHARE = 1e-3
DTYPES = [torch.bfloat16, torch.float32]
NORM_WIDTHS = [8, 64, 136, 256, 1000, 1024, 1728, 3072, 4096, 8184, 8192]  # C
SILU_WIDTHS = [8, 64, 136, 1368, 2816, 4608, 8320, 11008, 16376, 16384]      # F'


def _max_per(kernel, vec):
    """The most chunks a lane holds (``norm_max_per`` / ``silu_max_per``)."""
    words = t_q._NORM_X_WORDS if kernel == "rmsnorm_quant" else t_q._SILU_T_WORDS
    return words // vec


def _plan(kernel, m, n, dtype, blocks_per_sm=BLOCKS_PER_SM):
    fn = t_q.rmsnorm_quant_plan if kernel == "rmsnorm_quant" else t_q.silu_quant_plan
    return fn(m, n, dtype, SMS, blocks_per_sm)


def _walk(plan, m):
    """The rows each group of the grid reduces, as ``stream_rows`` walks them."""
    groups = plan.grid * plan.rows_per_block
    rows = []
    for gid in range(groups):
        turns = -(-(m - gid) // groups) if gid < m else 0
        rows += [gid + t * groups for t in range(turns)]
    return rows


def _instance_ok(kernel, n, plan):
    """Whether the C entry dispatches the plan's split (``split_ok``)."""
    max_per, max_units = _max_per(kernel, plan.vec), (8192 if kernel == "rmsnorm_quant" else 16384) // plan.vec
    if plan.lanes == 32:
        return 1 <= plan.per <= max_per
    return max_per < 2 * plan.per <= 2 * max_per and (plan.lanes // 2) * max_per < max_units


def _smem(kernel, n, dtype, plan, stages):
    itemsize = torch.finfo(dtype).bits // 8
    return t_q._row_smem(kernel, n, itemsize, plan.lanes, plan.vec, plan.per, stages)


class TestPlans:
    @pytest.mark.parametrize("m", [1, 7, 1000, 16384])
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kernel,n", [("rmsnorm_quant", c) for c in (64, 136, 1024, 1728, 4096, 8192)]
                             + [("silu_quant", f) for f in (64, 136, 2816, 4608, 8320, 16384)])
    def test_walk_covers_every_row_once(self, kernel, n, dtype, m):
        for blocks in (1, BLOCKS_PER_SM):
            plan = _plan(kernel, m, n, dtype, blocks)
            assert sorted(_walk(plan, m)) == list(range(m))
            assert plan.blocks_per_sm == blocks
            assert plan.grid == min(-(-m // plan.rows_per_block), SMS * blocks)  # at most one wave

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kernel,limit", [("rmsnorm_quant", 8192), ("silu_quant", 16384)])
    def test_every_width_has_a_plan(self, kernel, limit, dtype):
        for n in range(8, limit + 1, 8):
            plan = _plan(kernel, 4096, n, dtype)
            units = n // plan.vec
            assert plan.vec == (16 if n % 16 == 0 else 8)
            assert plan.lanes * (plan.per - 1) < units <= plan.lanes * plan.per, n
            assert plan.per <= _max_per(kernel, plan.vec) and _instance_ok(kernel, n, plan), (n, plan)
            assert plan.threads == max(128, plan.lanes) and plan.rows_per_block == plan.threads // plan.lanes
            assert plan.warps_per_row == plan.lanes // 32
            assert plan.smem_bytes == _smem(kernel, n, dtype, plan, plan.stages) <= SMEM_LIMIT, n
            assert plan.stages == 2 or _smem(kernel, n, dtype, plan, 2) > SMEM_LIMIT

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("kernel,n", [("rmsnorm_quant", c) for c in NORM_WIDTHS]
                             + [("silu_quant", f) for f in SILU_WIDTHS])
    def test_split_takes_the_fewest_lanes(self, kernel, n, dtype):
        """The fewest lanes from a warp up that hold the row in at most 48
        values of x (#9) or 64 of t (#8) a lane: one warp a row at the 350M
        width (C 1024) and at F' 2048, and for every narrower row."""
        plan = _plan(kernel, 16384, n, dtype)
        units, max_per = n // plan.vec, _max_per(kernel, plan.vec)
        assert plan.lanes >= 32 and plan.per <= max_per
        assert plan.lanes == 32 or -(-units // (plan.lanes // 2)) > max_per
        if n <= 1024 or n == 2048 or (kernel == "rmsnorm_quant" and n == 1536):
            assert plan.lanes == 32

    @pytest.mark.parametrize("kernel,n,why", [
        ("rmsnorm_quant", 12, "multiple of 8"), ("rmsnorm_quant", 8200, "up to 8192"),
        ("rmsnorm_quant", 0, "C a multiple of 8"),
        ("silu_quant", 12, "multiple of 8"), ("silu_quant", 16392, "up to 16384"),
    ])
    def test_widths_outside_the_domain_raise(self, kernel, n, why):
        with pytest.raises(ValueError, match=why):
            _plan(kernel, 64, n, torch.bfloat16)

    @pytest.mark.parametrize("kernel", ["rmsnorm_quant", "silu_quant"])
    def test_no_rows_and_other_dtypes_raise(self, kernel):
        with pytest.raises(ValueError, match="M >= 1"):
            _plan(kernel, 0, 1024, torch.bfloat16)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            _plan(kernel, 64, 1024, torch.float16)
        with pytest.raises(ValueError, match="fits no SM"):
            _plan(kernel, 64, 1024, torch.bfloat16, blocks_per_sm=0)


# ---------------------------------------------------------------------------
# #9's sum of squares in the kernel's order
# ---------------------------------------------------------------------------


def _wide_rows(m, c, seed):
    """fp32 rows whose squares span about 2^-60 to 2^60: their fp64 sum is
    inexact, so the order of the additions can decide its last bit."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, c)) * np.exp2(rng.uniform(-30, 30, (m, c)))).astype(np.float32)


def _kernel_order_sum(row):
    """One row's fp64 sum of squares as ``rmsnorm_quant.cu`` adds it, in
    Python floats: lane j adds chunks j, j + L, ... (16 channels, 8 where C
    % 16 == 8) channel by channel; each warp's 32 sums go through the
    butterfly (lane l adds lane l ^ off for off = 16 .. 1); the warps' sums
    are added in warp order. L: the fewest lanes from 32 that hold the row
    in at most 48 values a lane."""
    c = len(row)
    vec = 16 if c % 16 == 0 else 8
    units = c // vec
    lanes = next(n for n in (32, 64, 128, 256) if -(-units // n) <= 48 // vec)
    acc = [0.0] * lanes
    for j in range(lanes):
        for u in range(j, units, lanes):
            for e in range(vec):
                v = float(row[u * vec + e])
                acc[j] += v * v
    warps = []
    for w in range(lanes // 32):
        lane = acc[32 * w: 32 * w + 32]
        for off in (16, 8, 4, 2, 1):
            lane = [lane[k] + lane[k ^ off] for k in range(32)]
        warps.append(lane[0])
    total = warps[0]
    for v in warps[1:]:
        total += v
    return total


def _order_rows(c, dtype):
    """Two rows of width c (lanes of 16 channels) with the same values in
    other channels: 1 and 2^-12 in lane 0, four 2^-27 after them in lane 0
    (first row) or in lane 1 (second row)."""
    rows = torch.zeros(2, c, dtype=torch.float64)
    rows[:, 0], rows[:, 1] = 1.0, 2.0 ** -12
    rows[0, 2:6] = rows[1, 16:20] = 2.0 ** -27
    return rows.to(dtype)


class TestSumOrder:
    @pytest.mark.parametrize("c", [8, 136, 1000, 1024, 1728, 3072, 4096, 8184, 8192])
    def test_sum_squares_adds_in_the_kernels_order(self, c):
        x = _wide_rows(3, c, c)
        got = t_q._sum_squares(torch.from_numpy(x)).squeeze(-1).tolist()
        assert got == [_kernel_order_sum(row) for row in x]

    def test_the_order_decides_bits(self):
        """The same values in other channels give another fp32 variance:
        lane 0 holds 1, 2^-12 and then four 2^-27, whose squares (2^-54, a
        quarter of an fp64 step at 1) vanish one by one, so the sum is 1 +
        2^-24, an fp32 midpoint once divided by C; with the four in lane 1
        they add to 2^-52 first and survive, and the variance rounds up. So
        the plain version must add in the kernel's order (on wide fp32 rows
        the fp64 sums differ from ``sum``'s too)."""
        rows = _order_rows(1024, torch.float32)
        ss = t_q._sum_squares(rows)
        assert ss[:, 0].tolist() == [1 + 2.0 ** -24, 1 + 2.0 ** -24 + 2.0 ** -52]
        var = (ss / 1024).float()
        assert var[0, 0] != var[1, 0]
        scales = t_q.fused_rmsnorm_quant_plain(_order_rows(4096, torch.float32), torch.ones(4096))[1]
        assert scales[0, 0] != scales[1, 0]  # at C 4096 the step survives into the scale
        x = torch.from_numpy(_wide_rows(256, 1024, 0))
        assert not torch.equal(t_q._sum_squares(x), x.double().square().sum(-1, keepdim=True))

    def test_other_widths_take_sum(self):
        x = torch.from_numpy(_wide_rows(4, 12, 1))
        assert torch.equal(t_q._sum_squares(x), x.double().square().sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# The wrappers' dtype gate on tensors that pose as card tensors
# ---------------------------------------------------------------------------


class Card(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the wrappers read."""

    @property
    def is_cuda(self):
        return True


def plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, Card) else t


@pytest.fixture
def launches(monkeypatch):
    """Both launches replaced by recorders that write the plain version's
    codes and scales into the wrapper's outputs; returns the launches made,
    each with its plan."""
    calls = []

    def norm(x, gain, q, a_scale, plan, eps):
        calls.append(("rmsnorm_quant", x.dtype, plan))
        wq, ws = t_q.fused_rmsnorm_quant_plain(plain(x), gain, eps)
        q.copy_(wq)
        a_scale.copy_(ws)

    def silu(hid, q, scale, plan):
        calls.append(("silu_quant", hid.dtype, plan))
        wq, ws = t_q.fused_silu_quant_plain(plain(hid))
        q.copy_(wq)
        scale.copy_(ws)

    monkeypatch.setattr(t_q, "_rmsnorm_quant_cuda", norm)
    monkeypatch.setattr(t_q, "_silu_quant_cuda", silu)
    monkeypatch.setattr(t_q, "_occupancy", lambda kernel, n, dtype, dev: (SMS, BLOCKS_PER_SM))
    return calls


def _rows(shape, dtype, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


class TestDtypeGate:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_norm_takes_bf16_and_fp32(self, launches, dtype):
        x = _rows((2, 40, 136), dtype)
        gain = torch.from_numpy(np.random.default_rng(1).uniform(0.5, 1.5, 136).astype(np.float32))
        q, s = t_q.fused_rmsnorm_quant(x.as_subclass(Card), gain)
        assert launches == [("rmsnorm_quant", dtype, t_q.rmsnorm_quant_plan(80, 136, dtype, SMS, BLOCKS_PER_SM))]
        want = t_q.fused_rmsnorm_quant_plain(x, gain)
        assert torch.equal(plain(q), want[0]) and torch.equal(plain(s), want[1])
        assert q.shape == (2, 40, 136) and s.shape == (2, 40, 1) and s.dtype == torch.float32

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_silu_takes_bf16_and_fp32(self, launches, dtype):
        hid = _rows((3, 16, 2 * 256), dtype)
        q, s = t_q.fused_silu_quant(hid.as_subclass(Card))
        assert launches == [("silu_quant", dtype, t_q.silu_quant_plan(48, 256, dtype, SMS, BLOCKS_PER_SM))]
        want = t_q.fused_silu_quant_plain(hid)
        assert torch.equal(plain(q), want[0]) and torch.equal(plain(s), want[1])
        assert q.shape == (3, 16, 256) and s.shape == (3, 16, 1)

    @pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
    def test_other_dtypes_raise_before_any_launch(self, launches, dtype):
        x = torch.zeros(4, 64, dtype=dtype).as_subclass(Card)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_q.fused_rmsnorm_quant(x, torch.ones(64))
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_q.fused_silu_quant(torch.zeros(4, 128, dtype=dtype).as_subclass(Card))
        assert launches == []

    def test_rows_must_be_contiguous_and_the_width_in_the_domain(self, launches):
        x = _rows((64, 32), torch.float32).t().as_subclass(Card)
        with pytest.raises(ValueError, match="contiguous"):
            t_q.fused_rmsnorm_quant(x, torch.ones(64))
        with pytest.raises(ValueError, match="multiple of 16"):
            t_q.fused_silu_quant(_rows((4, 24), torch.bfloat16).as_subclass(Card))
        with pytest.raises(ValueError, match="multiple of 8"):
            t_q.fused_rmsnorm_quant(_rows((4, 12), torch.bfloat16).as_subclass(Card), torch.ones(12))
        assert launches == []

    def test_the_gain_reaches_the_launch_as_fp32(self, launches, monkeypatch):
        """A contiguous fp32 gain goes to the kernel as it is; a bf16 one as
        an fp32 copy."""
        seen = []
        monkeypatch.setattr(t_q, "_rmsnorm_quant_cuda", lambda x, gain, q, a_scale, plan, eps: seen.append(gain))
        x = _rows((8, 64), torch.bfloat16).as_subclass(Card)
        gain = torch.ones(64)
        t_q.fused_rmsnorm_quant(x, gain)
        t_q.fused_rmsnorm_quant(x, gain.bfloat16())
        assert seen[0] is gain and seen[1].dtype == torch.float32 and torch.equal(seen[1], gain)

    def test_no_rows_launch_nothing(self, launches):
        q, s = t_q.fused_silu_quant(torch.zeros(0, 4, 64, dtype=torch.bfloat16).as_subclass(Card))
        assert q.shape == (0, 4, 32) and s.shape == (0, 4, 1) and launches == []


# ---------------------------------------------------------------------------
# The fp32 plain versions against the JAX kernels in interpret mode
# ---------------------------------------------------------------------------


def assert_codes_close(got, want, share=CODE_SHARE):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


class TestFp32PlainVersionsMatchPallas:
    @pytest.mark.parametrize("b,n,c", [(2, 48, 136), (3, 40, 256), (1, 200, 128)])
    def test_rmsnorm_quant(self, b, n, c):
        rng = np.random.default_rng(14)
        x = (rng.standard_normal((b, n, c)) * 2).astype(np.float32)
        g = rng.uniform(0.5, 1.5, c).astype(np.float32)
        wq, ws = j_q.fused_rmsnorm_quant(jnp.asarray(x), jnp.asarray(g), interpret=True)
        launches = dict(t_q.LAUNCHES)
        q, s = t_q.fused_rmsnorm_quant(torch.from_numpy(x), torch.from_numpy(g))
        assert t_q.LAUNCHES == launches  # the CPU runs the plain version
        assert q.shape == (b, n, c) and s.shape == (b, n, 1) and s.dtype == torch.float32
        assert_codes_close(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)

    @pytest.mark.parametrize("b,n,f,padded", [(2, 64, 136, False), (2, 64, 136, True), (1, 200, 256, False)])
    def test_silu_quant(self, b, n, f, padded):
        rng = np.random.default_rng(15)
        v = rng.standard_normal((b, n, f)).astype(np.float32)
        g = (2 * rng.standard_normal((b, n, f))).astype(np.float32)
        fp = t_q.pad_ffn_dim(f) if padded else f
        hid = np.zeros((b, n, 2 * fp), np.float32)
        hid[..., :f], hid[..., fp:fp + f] = v, g
        wq, ws = j_q.fused_silu_quant(jnp.asarray(hid), interpret=True)
        q, s = t_q.fused_silu_quant(torch.from_numpy(hid))
        assert q.shape == (b, n, fp) and s.shape == (b, n, 1)
        assert_codes_close(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
        assert not q.numpy()[..., f:].any()  # pad columns quantize to exactly 0
