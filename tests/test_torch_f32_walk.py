"""The fp32 forward's work split (``f32_walk_split``) and arithmetic, against
the JAX package.

On an fp32 CUDA tensor ``fused_qkv_attention`` runs the fp32 walker
(``fused_attention_f32_sm90_kernel``): a block walks ``bb`` images x ``hpb``
heads of a 64-query tile, as ``f32_walk_split`` picks them, and each product
is six bf16 products of the operands' exact three-piece splits. Here, on the
CPU: the split's rule and its choices at the shapes the card measured, the
wrapper's routing with the launch replaced by a recorder, and the walker's
arithmetic twin (``ab_batch_block.fused_attention_bb_split_plain``) at every
split the rule returns for small shapes, held against the JAX package's
fused kernel (``vitok_tpu.ops.fused_attention``, Pallas in interpret mode)
on f32 with a tail mask, an image with no valid key and a window, within
1e-5 of the largest entry (the dropped terms of the split are about 2^-24 of
a product). The kernel itself is held to these on the card in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis
from vitok_torch.benchmarks import ab_batch_block as t_bb
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs


def make_inputs(b, n, heads, d, seed=0):
    """numpy fp32 qkv, gains U(0.5, 1.5), 2D RoPE tables; mask: sample 1
    keeps 23 tokens, the last sample none, the rest all."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qs = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, d).astype(np.float32)
    idx = np.arange(n)
    row = np.tile((idx // 8)[None], (b, 1)).astype(np.int32)
    col = np.tile((idx % 8)[None], (b, 1)).astype(np.int32)
    cos, sin = (np.asarray(t) for t in compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), d))
    valid = np.array([n, 23] + [n] * (b - 3) + [0])
    return qkv, qs, ks, cos, sin, idx[None, :] < valid[:, None]


def blocks(b, n, h, split):
    bb, hpb = split
    return -(-n // 64) * (h // hpb) * (b // bb)


class TestSplitRule:
    @pytest.mark.parametrize("b,n,h", [(256, 64, 24), (16, 256, 16), (64, 256, 16), (16, 1024, 16), (4, 200, 2),
                                       (7, 128, 5), (1, 64, 1), (2, 1024, 24), (32, 8, 12)])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sms", [1, 8, 132])
    def test_divisors_of_b_and_h_and_never_a_pack(self, b, n, h, d, sms):
        split = t_fa.f32_walk_split(b, n, h, d, sms)
        assert isinstance(split, tuple) and len(split) == 2  # (bb, hpb): no pack flag to give
        bb, hpb = split
        assert bb >= 1 and hpb >= 1 and b % bb == 0 and h % hpb == 0
        assert hpb <= max(1, h // 2)
        # the grid fills the card (two blocks an SM at d = 64), or the split is down to one cell a block
        assert blocks(b, n, h, split) >= sms * (2 if d == 64 else 1) or split == (1, 1)

    def test_the_splits_the_card_read_fastest(self):
        """The fp32 walker's splits measured on an H100 (PERF.md): at the 5B
        fp32 A/B shape (d 128, one block an SM) D2, two images x 12 heads, was
        the fastest split that packs nothing; at the 350M width with a tail
        and a dead image (d 64), where the forward's kernel holds two blocks
        an SM, one cell a block."""
        assert t_fa.f32_walk_split(256, 64, 24, 128, SMS) == (2, 12)
        assert t_fa.f32_walk_split(16, 256, 16, 64, SMS) == (1, 1)

    def test_short_cells_take_many_and_long_cells_few(self):
        assert t_fa.f32_walk_split(256, 128, 24, 128, SMS) == (1, 12)  # two key tiles: 12 cells a block
        assert t_fa.f32_walk_split(256, 64, 16, 64, SMS) == (1, 8)     # two blocks an SM: 12 steps, 8 heads
        assert t_fa.f32_walk_split(64, 512, 16, 128, SMS) == (1, 1)    # eight key tiles: one cell a block
        assert t_fa.f32_walk_split(64, 256, 16, 128, SMS) == (1, 2)    # four key tiles, one block an SM
        assert t_fa.f32_walk_split(1, 64, 24, 128, SMS) == (1, 1)      # a small grid gives its cells back

    def test_refuses_what_is_not_a_shape(self):
        with pytest.raises(ValueError, match="positive"):
            t_fa.f32_walk_split(0, 64, 2, 64, SMS)


class TestWrapperRouting:
    def test_fp32_forward_launches_the_walker_at_the_rules_split(self, monkeypatch):
        """``_attend_f32`` (what an fp32 CUDA tensor reaches) launches the
        forward's kernel once at ``f32_walk_split``'s split, with the window,
        and counts one fp32 launch; the launch is replaced by a recorder."""
        calls = []

        def record(qkv, q_scale, k_scale, cos, sin, mask, num_heads, **kw):
            calls.append(kw)
            return torch.zeros(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3)

        monkeypatch.setattr(t_fa, "_walk_f32_cuda", record)
        monkeypatch.setattr(t_fa, "_sm_count", lambda index: SMS)
        monkeypatch.setattr(t_fa, "F32_LAUNCHES", 0)
        args = [torch.tensor(np.asarray(a)) for a in make_inputs(16, 256, 16, 64)]
        out = t_fa._attend_f32(*args, 16, 40)
        assert out.shape == (16, 256, 1024)
        assert calls == [dict(bb=1, hpb=1, sw=40, kind="fwd")]
        assert t_fa.F32_LAUNCHES == 1

    def test_fp32_under_autograd_is_refused_before_the_forward(self, monkeypatch):
        monkeypatch.setattr(t_fa, "_attend_f32", lambda *a, **k: pytest.fail("the forward ran"))
        args = [torch.tensor(np.asarray(a)) for a in make_inputs(4, 64, 2, 64)]
        with pytest.raises(TypeError, match=r"backward kernel \(#3\) has no fp32 instance"):
            t_fa._fused_cuda(*args, 2, None, want_lse=True)

    def test_cpu_keeps_the_plain_version_under_autograd(self):
        args = [torch.tensor(np.asarray(a)) for a in make_inputs(4, 64, 2, 64)]
        qkv = args[0].requires_grad_()
        out = t_fa.fused_qkv_attention(qkv, *args[1:], num_heads=2, impl="fused")
        out.sum().backward()
        assert qkv.grad is not None and torch.isfinite(qkv.grad).all()


def _split_cases():
    """(d, n, b, h, split) for every split the rule returns on 1 to 132 SMs."""
    cases = []
    for d, n, b, h in [(64, 64, 4, 4), (128, 64, 4, 2), (64, 200, 4, 4), (128, 128, 4, 2)]:
        for split in sorted({t_fa.f32_walk_split(b, n, h, d, sms) for sms in (1, 2, 4, 8, 16, 64, 132)}):
            cases.append((d, n, b, h, split))
    return cases


class TestTwinAgainstJaxFused:
    @pytest.mark.parametrize("d,n,b,h,split", _split_cases())
    @pytest.mark.parametrize("sw", [None, 24])
    def test_twin_at_the_split_matches_fused_kernel(self, d, n, b, h, split, sw):
        args = make_inputs(b, n, h, d)
        port = [torch.tensor(np.asarray(a)) for a in args]
        bb, hpb = split
        got = t_bb.fused_attention_bb_split_plain(*port, num_heads=h, bb=bb, cg=hpb * d, sliding_window=sw)
        want = np.asarray(j_fa.fused_qkv_attention(*[jnp.asarray(a) for a in args], num_heads=h,
                                                   sliding_window=sw, interpret=True))
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        # the dead image: every row the mean of v over its own N keys
        mean_v = port[0][-1, :, 2 * h * d:].mean(0)
        assert (got[-1] - mean_v).abs().max().item() <= 1e-5 * np.abs(want).max()
