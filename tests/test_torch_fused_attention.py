"""Parity of the port's fused QK-norm + RoPE + attention with the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version. It is held
against the Pallas kernel ``vitok_tpu ... fused_qkv_attention`` run in
interpret mode (every row, padded rows included: both mask key-side) and
against the JAX unfused composition (valid rows: that path masks two-sided),
in float32 at atol 2e-5. The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``, which skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

ATOL = 2e-5
CASES = [("none", False, None), ("tail", True, None), ("sw", False, 12), ("tail+sw", True, 12)]


def make_inputs(b=2, n=64, heads=2, d=64, masked=False, seed=0):
    """numpy qkv, gains U(0.5, 1.5), 2D RoPE tables, tail-suffix mask."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qs = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, d).astype(np.float32)
    idx = np.arange(n)
    row = np.tile((idx // 8)[None], (b, 1)).astype(np.int32)
    col = np.tile((idx % 8)[None], (b, 1)).astype(np.int32)
    cos, sin = (np.asarray(t) for t in compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), d))
    mask = None
    if masked:  # sample 1 keeps 23 tokens: rows past 23 + sw see no valid key
        mask = idx[None, :] < np.array([n, 23] + [n // 2] * (b - 2))[:, None]
    return qkv, qs, ks, cos, sin, mask


def _torch(args):
    return [None if a is None else torch.tensor(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


class TestPlainAgainstJax:
    @pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384])
    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_matches_pallas_kernel_interpret_all_rows(self, d, case, masked, sw):
        args = make_inputs(d=d, masked=masked)
        got = t_fa.fused_qkv_attention_plain(*_torch(args), num_heads=2, sliding_window=sw)
        want = j_fa.fused_qkv_attention(*_jax(args), num_heads=2, sliding_window=sw, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    @pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384])
    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_matches_unfused_on_valid_rows(self, d, case, masked, sw):
        args = make_inputs(d=d, masked=masked)
        got = t_fa.fused_qkv_attention_plain(*_torch(args), num_heads=2, sliding_window=sw).numpy()
        want = np.asarray(
            j_fa.unfused_qkv_attention(*_jax(args), 2, sw, attn_impl="xla")
        )
        rows = np.ones(got.shape[:2], bool) if args[-1] is None else args[-1]
        np.testing.assert_allclose(got[rows], want[rows], atol=ATOL, rtol=0)

    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_port_unfused_matches_jax_unfused(self, case, masked, sw):
        args = make_inputs(masked=masked)
        got = t_fa.unfused_qkv_attention(*_torch(args), 2, sw, attn_impl="xla")
        want = j_fa.unfused_qkv_attention(*_jax(args), 2, sw, attn_impl="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


class TestRouting:
    @pytest.mark.parametrize(
        "n,c,h,ok",
        [
            (256, 1024, 16, True),    # 350M @256p
            (1024, 1024, 16, True),   # 350M @512p
            (1024, 3072, 24, True),   # 5B
            (1032, 1024, 16, False),  # over MAX_FUSED_TOKENS
            (60, 128, 2, False),      # n % 8
            (64, 96, 3, False),       # d = 32
            (64, 192, 3, False),      # d = 64 but no 128-lane group divides C
            (64, 100, 3, False),      # C % H
        ],
    )
    def test_can_fuse_follows_the_jax_gate(self, n, c, h, ok):
        assert t_fa.can_fuse(n, c, h) is ok
        d = c // h
        jax_shape_gate = (
            n <= j_fa.MAX_FUSED_TOKENS and n % 8 == 0 and c % h == 0 and d % 64 == 0
            and j_fa._pick_group_channels(c, d, n) > 0
        )
        assert jax_shape_gate is ok

    @pytest.mark.parametrize("impl", ["auto", "fused"])
    def test_cpu_tensor_runs_plain_and_launches_nothing(self, impl):
        args = _torch(make_inputs(masked=True))
        before = t_fa.LAUNCHES
        got = t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=None, impl=impl)
        assert t_fa.LAUNCHES == before
        torch.testing.assert_close(got, t_fa.fused_qkv_attention_plain(*args, num_heads=2))

    def test_xla_impl_runs_the_unfused_composition(self):
        args = _torch(make_inputs(masked=True))
        got = t_fa.fused_qkv_attention(*args, num_heads=2, impl="xla")
        torch.testing.assert_close(got, t_fa.unfused_qkv_attention(*args, 2, None, attn_impl="xla"))

    def test_bf16_plain_keeps_dtype(self):
        qkv, qs, ks, cos, sin, mask = _torch(make_inputs(masked=True))
        out = t_fa.fused_qkv_attention(qkv.bfloat16(), qs, ks, cos, sin, mask, num_heads=2)
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()

