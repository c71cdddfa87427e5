"""The high-resolution fold (the q/k prologue, then the flash kernel) and the
head-dim gates of the kernels on the card, on the CPU.

``flash_qkv_attention_plain`` (the prologue's plain version, then
``flash_attention_plain``) is held against the JAX package's
``unfused_qkv_attention`` on its flash route (``attn_impl="pallas"``, the
Pallas kernel in interpret mode) in float32 on every row, within 2e-5: the
two differ only in the order of the RMSNorm sum. Its routing and the gates
are checked with the kernels' launches replaced by recorders that run the
plain versions, on tensors that say they lie on the card (a ``Tensor``
subclass whose ``is_cuda`` is True): the fold is taken for a bf16 call
bound for the flash kernel with no gradient asked for, and not under
autograd, in fp32, at a head dim the kernels have no instance for, or below
``FLASH_MIN_TOKENS`` with ``"auto"``; a head dim of 192 or 256 takes the
unfused composition on the card where the JAX package's gate (a multiple of
64) would open. The kernels themselves are held to their plain versions in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis
from vitok_torch.ops import attention as t_attn
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

ATOL = 2e-5


class Card(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the gates read."""

    @property
    def is_cuda(self):
        return True


def card(t):
    return t.as_subclass(Card)


def plain(t):
    """A card-posing tensor as a plain one (anything else as it is)."""
    return t.as_subclass(torch.Tensor) if isinstance(t, Card) else t


def make_inputs(b, n, heads, d, masked, seed=0):
    """numpy fp32 qkv, gains U(0.5, 1.5), 2D RoPE tables of a 16-wide grid,
    and a tail mask: sample 1 keeps a third of its tokens, sample 2 none."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qs = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, d).astype(np.float32)
    idx = np.arange(n)
    row = np.tile((idx // 16)[None], (b, 1)).astype(np.int32)
    col = np.tile((idx % 16)[None], (b, 1)).astype(np.int32)
    cos, sin = (np.asarray(t) for t in compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), d))
    mask = None
    if masked:
        valid = np.array([n, n // 3, 0] + [n // 2] * (b - 3))[:b]
        mask = idx[None, :] < valid[:, None]
    return qkv, qs, ks, cos, sin, mask


def _torch(args, dtype=torch.float32):
    qkv, qs, ks, cos, sin, mask = args
    return (torch.tensor(qkv).to(dtype), torch.tensor(qs), torch.tensor(ks), torch.tensor(cos),
            torch.tensor(sin), None if mask is None else torch.tensor(mask))


class TestFoldAgainstJax:
    @pytest.mark.parametrize("n", [136, 200])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("sw", [None, 40])
    def test_plain_fold_matches_unfused_on_the_flash_route(self, n, masked, sw):
        args = make_inputs(3, n, 2, 64, masked)
        got = t_fa.flash_qkv_attention_plain(*_torch(args), num_heads=2, sliding_window=sw)
        qkv, qs, ks, cos, sin, mask = args
        want = j_fa.unfused_qkv_attention(jnp.asarray(qkv), jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(cos),
                                          jnp.asarray(sin), None if mask is None else jnp.asarray(mask), 2, sw,
                                          attn_impl="pallas")
        assert got.shape == (3, n, 128) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        if masked:  # padded rows, and every row of the all-padding sample, are 0
            assert not got.numpy()[~mask].any()

    def test_wrapper_runs_the_plain_fold_on_the_cpu(self):
        args = _torch(make_inputs(2, 136, 2, 64, True))
        got = t_fa.flash_qkv_attention(*args, num_heads=2, sliding_window=40)
        torch.testing.assert_close(got, t_fa.flash_qkv_attention_plain(*args, num_heads=2, sliding_window=40),
                                   rtol=0, atol=0)

    def test_other_devices_raise(self):
        qkv = torch.empty((1, 8, 3 * 64), device="meta")
        with pytest.raises(RuntimeError, match="no fused attention kernel"):
            t_fa.flash_qkv_attention(qkv, qkv[0, 0, :64], qkv[0, 0, :64], qkv, qkv, num_heads=1)


@pytest.fixture
def recorders(monkeypatch):
    """The fold's two launches and the fused forward replaced by recorders
    that run the plain versions; returns the list of launches made."""
    calls = []

    def prologue(qkv, q_scale, k_scale, cos, sin, num_heads, out=None, dout=None, with_q=True):
        calls.append("prologue")
        return t_fa.fused_qk_prologue_plain(plain(qkv), q_scale, k_scale, cos, sin, num_heads=num_heads,
                                            with_q=with_q)

    def flash(q, k, v, patch_mask, sliding_window, return_lse):
        calls.append("flash")
        return t_fl.flash_attention_plain(plain(q), plain(k), plain(v), patch_mask,
                                          sliding_window, return_lse)

    def fused(*a, **kw):
        calls.append("fused")
        raise AssertionError("the fused kernel's gate opened")

    monkeypatch.setattr(t_fa, "_prologue_cuda", prologue)
    monkeypatch.setattr(t_fl, "_flash_cuda", flash)
    monkeypatch.setattr(t_fa, "_fused_cuda", fused)
    return calls


def _card_args(b, n, heads, d, dtype=torch.bfloat16, masked=True):
    qkv, *rest = _torch(make_inputs(b, n, heads, d, masked), dtype)
    return (card(qkv), *rest)


class TestFoldRouting:
    def test_taken_on_the_card_in_bf16_without_grad(self, recorders):
        args = _card_args(1, 2048, 2, 64)
        got = t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=300)
        assert recorders == ["prologue", "flash"]
        want = t_fa.flash_qkv_attention_plain(*map(plain, args), num_heads=2, sliding_window=300)
        torch.testing.assert_close(plain(got), want, rtol=0, atol=0)

    def test_taken_for_flash_at_any_length(self, recorders):
        args = _card_args(2, 64, 2, 128)
        t_fa.unfused_qkv_attention(*args, 2, None, attn_impl="flash")
        assert recorders == ["prologue", "flash"]

    def test_not_taken_under_grad(self, recorders):
        qkv, *rest = _card_args(1, 2048, 2, 64)
        qkv.requires_grad_()
        assert not t_fa.takes_flash_fold(qkv, rest[0], rest[1], 2, "auto")
        t_fa.unfused_qkv_attention(qkv, *rest, 2, 300)
        assert recorders == ["flash"]  # the composition's flash kernel, through its autograd Function

    def test_not_taken_for_a_gain_that_needs_grad(self):
        qkv, qs, ks, *_ = _card_args(1, 2048, 2, 64)
        assert not t_fa.takes_flash_fold(qkv, qs.requires_grad_(), ks, 2, "auto")
        with torch.no_grad():
            assert t_fa.takes_flash_fold(qkv, qs, ks, 2, "auto")

    def test_not_taken_in_fp32(self):
        qkv, qs, ks, *_ = _card_args(1, 2048, 2, 64, dtype=torch.float32)
        assert not t_fa.takes_flash_fold(qkv, qs, ks, 2, "auto")

    @pytest.mark.parametrize("d", [192, 256])
    def test_not_taken_at_other_head_dims(self, recorders, d):
        args = _card_args(1, 2048, 1, d, masked=False)
        assert not t_fa.takes_flash_fold(args[0], args[1], args[2], 1, "auto")
        got = t_fa.unfused_qkv_attention(*args, 1, 300)
        assert recorders == []  # the unfused composition: no kernel launches
        want = t_fa.unfused_qkv_attention(*map(plain, args), 1, 300, attn_impl="xla")
        torch.testing.assert_close(plain(got), want, rtol=0, atol=0)

    def test_not_taken_below_the_flash_threshold(self, recorders):
        args = _card_args(1, 2040, 2, 64)
        assert not t_fa.takes_flash_fold(args[0], args[1], args[2], 2, "auto")
        t_fa.unfused_qkv_attention(*args, 2, 300)
        assert recorders == []

    def test_not_taken_on_the_cpu(self, recorders):
        qkv, qs, ks, cos, sin, mask = _torch(make_inputs(1, 2048, 2, 64, True), torch.bfloat16)
        assert not t_fa.takes_flash_fold(qkv, qs, ks, 2, "flash")
        t_fa.unfused_qkv_attention(qkv, qs, ks, cos, sin, mask, 2, 300)
        assert recorders == []

    def test_fold_refuses_a_gradient_on_the_card(self):
        qkv, *rest = _card_args(1, 64, 1, 64)
        with pytest.raises(RuntimeError, match="inference path"):
            t_fa.flash_qkv_attention(qkv.requires_grad_(), *rest, num_heads=1)


class TestHeadDimGates:
    @pytest.mark.parametrize("d,ok_cpu,ok_card", [(64, True, True), (128, True, True), (192, True, False),
                                                  (256, True, False), (72, False, False)])
    def test_gates_follow_the_kernel_head_dims_on_the_card(self, monkeypatch, d, ok_cpu, ok_card):
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        c = 4 * d if d != 72 else 1728
        h = c // d
        assert t_attn.head_dim_routes(d, cuda=False) is ok_cpu
        assert t_attn.head_dim_routes(d, cuda=True) is ok_card
        assert t_attn.flash_route(2048, d, "auto", cuda=False) is ok_cpu
        assert t_attn.flash_route(2048, d, "auto", cuda=True) is ok_card
        assert t_attn.flash_route(2048, d, "flash", cuda=True)  # asked for: it raises on the card
        assert t_fa.can_fuse(256, c, h) is (ok_cpu and c % 128 == 0)
        assert t_fa.can_fuse(256, c, h, cuda=True) is (ok_card and c % 128 == 0)
        assert t_fa.can_fuse_bwd(256, c, h, cuda=True) == t_fa.can_fuse(256, c, h, cuda=True)
        if ok_cpu and not ok_card:
            assert t_fa.can_fuse_q8(256, c, h) and not t_fa.can_fuse_q8(256, c, h, cuda=True)
        if ok_card:
            assert t_fa.can_fuse_q8(256, c, h, cuda=True) == t_fa.can_fuse_q8(256, c, h)

    @pytest.mark.parametrize("n", [256, 2048])
    def test_wide_heads_take_the_unfused_composition_on_the_card(self, recorders, n):
        """A d = 256 block (``w1024_d2_h4``'s heads) at 256 and 2048 tokens:
        the fused gate and the flash route close on the card, and the
        composition computes what it computes on the CPU."""
        args = _card_args(1, n, 2, 256, masked=False)
        got = t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=100)
        assert recorders == []
        want = t_fa.unfused_qkv_attention(*map(plain, args), 2, 100, attn_impl="xla")
        torch.testing.assert_close(plain(got), want, rtol=0, atol=0)

    def test_dot_product_attention_keeps_wide_heads_off_the_flash_kernel(self, recorders):
        q = card(torch.from_numpy(np.random.default_rng(0).standard_normal((1, 2048, 1, 256),
                                                                           dtype=np.float32)).bfloat16())
        t_attn.dot_product_attention(q, q, q, sliding_window=64)
        assert recorders == []
        t_attn.dot_product_attention(q[..., :128], q[..., :128], q[..., :128], sliding_window=64)
        assert recorders == ["flash"]
