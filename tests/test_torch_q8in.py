"""The int8-input A/B kernel's host side (#12, ``vitok_torch.benchmarks.ab_q8_input``)
on the CPU: the plan of its split, its shared memory, the rounding of v in
the assembled tensor at exact ties, the int8 prologue's plain version, and
the wrapper's launches on tensors that pose as card tensors.

The kernel itself is held to the redesigned forward on the assembled tensor,
bit for bit, on the card (``tests/test_torch_cuda.py``); its plain version
against the JAX script's ``_kernel_q8in`` in ``tests/test_torch_ab_kernels.py``.
All comparisons here are exact: the same function computed two ways.
"""

import numpy as np
import pytest
import torch

from vitok_torch.benchmarks import ab_q8_input as t_ab8
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops.rope import compute_2d_freqs_cis

torch.set_num_threads(1)

SMEM_PER_SM = 233472  # shared memory of one H100 SM; the runtime keeps 1 KB of it a block
SMS = 132  # an H100's SMs
AB_SHAPES = ((64, 256, 3072, 24), (16, 256, 1024, 16))  # B, N, C, H: chip_smoke.py's bf16 A/B shapes


class Card(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the wrapper reads."""

    @property
    def is_cuda(self):
        return True


def make_inputs(b, n, heads, d, seed=0):
    """Codes and scales of a seeded N(0, 1) qkv (``quantize_qkv``), gains
    U(0.5, 1.5), 2D RoPE tables and a tail mask (sample 1 keeps 23 tokens)."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * heads * d), dtype=np.float32)).bfloat16()
    codes, scale = t_ab8.quantize_qkv(qkv)
    qs = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    idx = np.arange(n)
    cos, sin = compute_2d_freqs_cis(torch.from_numpy(np.tile(idx // 8, (b, 1))),
                                    torch.from_numpy(np.tile(idx % 8, (b, 1))), d)
    mask = torch.from_numpy(idx[None, :] < np.array([n, 23] + [n] * (b - 2))[:, None])
    return codes, scale, qs, ks, cos, sin, mask


class TestPlan:
    @pytest.mark.parametrize("b,n,c,h", AB_SHAPES)
    def test_plan_at_the_ab_shapes(self, b, n, c, h):
        bb, hpb = t_ab8.q8in_plan(b, n, c, h, SMS)
        # on an H100 (PERF.md): 5B all 24 heads a block, within 1.2% of the fastest split; 350M one
        # cell a block, the fastest
        assert (bb, hpb) == {24: (1, 24), 16: (1, 1)}[h]
        assert b % bb == 0 and h % hpb == 0
        # two blocks an SM at d = 128 (and four at d = 64), by shared memory
        blocks = 2 if c // h == 128 else 4
        assert blocks * (t_ab8.q8in_smem_bytes(c // h, bb) + 1024) <= SMEM_PER_SM

    @pytest.mark.parametrize("b", [1, 2, 3, 4, 16, 64, 256])
    @pytest.mark.parametrize("n,c,h", [(64, 3072, 24), (256, 1024, 16), (1024, 1024, 16), (200, 256, 2)])
    def test_plan_divides_the_shape(self, b, n, c, h):
        bb, hpb = t_ab8.q8in_plan(b, n, c, h, SMS)
        assert bb >= 1 and hpb >= 1 and b % bb == 0 and h % hpb == 0

    def test_smem_bytes_are_the_kernels_layout(self):
        # Q8inSmem<D>: 4 bf16 tiles, 4 int8 tiles, 2 x 64 scales and key states, the gain, an int4 an image, slack
        assert t_ab8.q8in_smem_bytes(128, 1) == 4 * 16384 + 4 * 8192 + 512 + 128 + 512 + 16 + 1024 == 100496
        assert t_ab8.q8in_smem_bytes(64, 4) == 4 * 8192 + 4 * 4096 + 512 + 128 + 256 + 64 + 1024


def _bf16_rne(x: np.ndarray) -> np.ndarray:
    """fp32 values (exact in fp32) rounded to bf16, to nearest even, by the
    integer recipe on their bit patterns; returned as fp32."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16) << 16
    return rounded.astype(np.uint32).view(np.float32)


class TestAssembledV:
    def test_v_is_code_times_scale_rounded_to_nearest_even_at_exact_ties(self):
        """A token's scale m * 2^-p with m odd, and codes c (odd, or an odd
        times a power of two) with c * m in [256, 512): the fp32 product is
        exact and has nine significant bits, the last one set, so it lies
        exactly halfway between two bf16 values."""
        codes_v, scales = [], []
        for c in range(1, 128):
            odd, shift = c, 0
            while odd % 2 == 0:
                odd, shift = odd // 2, shift + 1
            ms = [m for m in range(-(-256 // odd), 512 // odd + 1) if m % 2 and 256 <= odd * m < 512]
            for m in ms[:3]:
                for sign in (1, -1):
                    codes_v.append(sign * c)
                    scales.append(m * 2.0 ** (-12 - shift))
        k = len(codes_v)
        c = 8  # channels a plane; v's first channel holds the tie, the rest are code 0
        qkv8 = torch.zeros(1, k, 3 * c, dtype=torch.int8)
        qkv8[0, :, 2 * c] = torch.tensor(codes_v, dtype=torch.int8)
        qkv8[0, :, :2 * c] = torch.arange(2 * c, dtype=torch.int8) - 8
        tok = torch.tensor(scales, dtype=torch.float32).view(1, k, 1)
        v = t_ab8.assemble_q8in(qkv8, tok)[0, :, 2 * c].float().numpy()
        exact = np.array(codes_v, dtype=np.float64) * np.array(scales, dtype=np.float64)
        assert np.array_equal(exact.astype(np.float32).astype(np.float64), exact)  # the fp32 product is exact
        want = _bf16_rne(exact.astype(np.float32))  # the reference rounding
        # every product is a tie: halfway between its two bf16 neighbours
        down = (exact.astype(np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32).astype(np.float64)
        up = down + np.sign(exact) * 2.0 ** (np.floor(np.log2(np.abs(exact))) - 7)
        assert np.array_equal(np.abs(exact - down), np.abs(up - exact))
        assert np.array_equal(v, want)
        # to nearest even: the kept value's last mantissa bit is 0, and about half the ties round up
        assert not np.any(v.view(np.uint32) & 0x10000)
        away = np.abs(v) > np.abs(exact)
        assert 0 < away.sum() < k
        # q and k are the codes, exact in bf16
        assert torch.equal(t_ab8.assemble_q8in(qkv8, tok)[..., :2 * c], qkv8[..., :2 * c].to(torch.bfloat16))


class TestInt8Prologue:
    @pytest.mark.parametrize("d,n", [(64, 64), (128, 200)])
    def test_plain_twin_is_the_bf16_prologue_on_bf16_codes(self, d, n):
        codes, scale, qs, ks, cos, sin, _ = make_inputs(2, n, 2, d)
        got = t_ab8.q8in_k_prologue(codes, ks, cos, sin, num_heads=2)
        assert got.dtype == torch.bfloat16 and got.shape == (2, n, 2 * d)
        want, _ = t_fa.fused_qk_prologue(codes.to(torch.bfloat16), qs, ks, cos, sin, num_heads=2, with_q=False)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        # and so of the assembled tensor, whose k plane is the codes
        want_assembled, _ = t_fa.fused_qk_prologue(t_ab8.assemble_q8in(codes, scale), qs, ks, cos, sin, num_heads=2,
                                                   with_q=False)
        torch.testing.assert_close(got, want_assembled, rtol=0, atol=0)


class TestWrapperOnCardTensors:
    @pytest.fixture
    def recorders(self, monkeypatch):
        calls = []

        def prologue(qkv8, k_scale, cos, sin, num_heads):
            calls.append(("prologue", qkv8.shape))
            t_ab8.LAUNCHES["fused_attention_q8in_prologue"] += 1
            return t_ab8.q8in_k_prologue_plain(qkv8.as_subclass(torch.Tensor), k_scale, cos, sin,
                                               num_heads=num_heads)

        def walk(qkv8, tok, kn, q_scale, cos, sin, mask, num_heads, *, bb, hpb, sw=-1):
            calls.append(("walk", bb, hpb, sw))
            return torch.zeros(qkv8.shape[0], qkv8.shape[1], qkv8.shape[2] // 3, dtype=torch.bfloat16)

        monkeypatch.setattr(t_ab8, "_k_prologue_q8_cuda", prologue)
        monkeypatch.setattr(t_ab8, "walk_q8in", walk)
        monkeypatch.setattr(t_fa, "_sm_count", lambda index: SMS)
        return calls

    def test_launches_the_prologue_then_the_walk_at_the_plan(self, recorders):
        codes, scale, qs, ks, cos, sin, mask = make_inputs(4, 64, 2, 64)
        before = dict(t_ab8.LAUNCHES)
        t_ab8.fused_attention_q8in(codes.as_subclass(Card), scale, qs, ks, cos, sin, mask, num_heads=2,
                                   sliding_window=24)
        assert recorders == [("prologue", codes.shape), ("walk", *t_ab8.q8in_plan(4, 64, 128, 2, SMS), 24)]
        assert t_ab8.LAUNCHES == {**before, "fused_attention_q8in": before["fused_attention_q8in"] + 1,
                                  "fused_attention_q8in_prologue": before["fused_attention_q8in_prologue"] + 1}

    @pytest.mark.parametrize("n", [60, 100, 1020])
    def test_n_not_a_multiple_of_8_raises_before_any_launch(self, recorders, n):
        codes, scale, qs, ks, cos, sin, mask = make_inputs(2, n, 2, 64)
        before = dict(t_ab8.LAUNCHES)
        with pytest.raises(ValueError, match="multiple of 8"):
            t_ab8.fused_attention_q8in(codes.as_subclass(Card), scale, qs, ks, cos, sin, mask, num_heads=2)
        assert recorders == [] and t_ab8.LAUNCHES == before
        # on the CPU the plain version takes any N
        got = t_ab8.fused_attention_q8in(codes, scale, qs, ks, cos, sin, mask, num_heads=2)
        assert got.shape == (2, n, 128) and torch.isfinite(got.float()).all()
