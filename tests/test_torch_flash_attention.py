"""Parity of the port's flash attention forward with the JAX package.

On the CPU the wrapper runs the kernel's plain PyTorch version. It is held
against the Pallas kernel ``vitok_tpu.ops.flash_attention.flash_attention``
run in interpret mode on every row < N (both zero the padded rows) at atol
2e-5 in float32, its log-sum-exp against ``_flash_fwd(..., return_lse=True)``
at atol 1e-5 on live rows and exactly +1e30 on dead rows, and in bfloat16
(the same key blocks, so p is rounded at the same running maxima) within max
abs 2e-2 and mean abs 2e-3. The CUDA kernel itself is held against the plain
version in ``tests/test_torch_cuda.py``, which skips without a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import flash_attention as j_fl
from vitok_torch.ops import attention as t_attn
from vitok_torch.ops import flash_attention as t_fl

torch.set_num_threads(1)

ATOL = 2e-5
LSE_ATOL = 1e-5
CASES = ["none", "tail", "sw", "tail+sw"]


def make_inputs(n, d=64, b=3, heads=2, masked=False, seed=0):
    """numpy q, k, v ``[B, N, H, D]`` and a tail-suffix mask in which
    sample 1 keeps a third of its tokens and sample 2 none."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, heads, d)).astype(np.float32) for _ in range(3))
    mask = None
    if masked:
        valid = np.array([n, n // 3, 0] + [n // 2] * (b - 3))[:b]
        mask = np.arange(n)[None, :] < valid[:, None]
    return q, k, v, mask


def _torch(args, dtype=torch.float32):
    q, k, v, mask = args
    return [torch.tensor(a).to(dtype) for a in (q, k, v)] + [None if mask is None else torch.tensor(mask)]


def _jax(args, dtype=jnp.float32):
    q, k, v, mask = args
    return [jnp.asarray(a, dtype) for a in (q, k, v)] + [None if mask is None else jnp.asarray(mask)]


def _blocks(n):
    """The JAX package's default block sizes for N tokens."""
    return min(256, -(-n // 128) * 128), min(512, -(-n // 128) * 128)


class TestPlainAgainstJax:
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("case", CASES)
    def test_matches_pallas_kernel_interpret_all_rows(self, d, case):
        args = make_inputs(700, d=d, masked="tail" in case)
        sw = 100 if "sw" in case else None
        got = t_fl.flash_attention_plain(*_torch(args), sliding_window=sw)
        want = j_fl.flash_attention(*_jax(args), sliding_window=sw, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        if args[3] is not None:
            assert not got.numpy()[~args[3]].any()

    @pytest.mark.parametrize("n,sw", [(300, 40), (2100, 256)])
    def test_ragged_lengths(self, n, sw):
        """N a multiple of no block size, with a tail mask and a window."""
        args = make_inputs(n, b=2, masked=True)
        got = t_fl.flash_attention_plain(*_torch(args), sliding_window=sw)
        want = j_fl.flash_attention(*_jax(args), sliding_window=sw, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    @pytest.mark.parametrize("case", ["none", "tail", "tail+sw"])
    def test_lse_matches_flash_fwd(self, case):
        n = 700
        args = make_inputs(n, masked="tail" in case)
        sw = 100 if "sw" in case else None
        _, lse = t_fl.flash_attention_plain(*_torch(args), sliding_window=sw, return_lse=True)
        _, want = j_fl._flash_fwd(*_jax(args), sw, *_blocks(n), True, return_lse=True)
        got, want = lse.numpy(), np.asarray(want)[:, :, :n, 0]
        live = want < 1e29
        np.testing.assert_allclose(got[live], want[live], atol=LSE_ATOL, rtol=0)
        assert (got[~live] == np.float32(1e30)).all()
        if args[3] is not None:  # the all-padding sample has no live row
            assert not live[2].any() and live[0].all()

    @pytest.mark.parametrize("d", [64, 128])
    def test_bf16_matches_pallas_kernel_interpret(self, d):
        args = make_inputs(700, d=d, masked=True)
        got = t_fl.flash_attention_plain(*_torch(args, torch.bfloat16), sliding_window=100)
        want = j_fl.flash_attention(*_jax(args, jnp.bfloat16), sliding_window=100, interpret=True)
        assert got.dtype == torch.bfloat16
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert err.max() <= 2e-2 and err.mean() <= 2e-3


class TestSemantics:
    def test_key_counts(self):
        mask = torch.tensor([[1, 1, 1, 0, 0], [1, 0, 1, 1, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]]).bool()
        assert t_fl.key_counts(mask).tolist() == [[3, 4, 0, 5], [3, 1, 0, 5]]

    @pytest.mark.parametrize("sw", [None, 20])
    def test_any_mask_matches_unfused_on_valid_rows(self, sw):
        """A mask with holes (not the NaFlex tail suffix): the plain version
        applies it element by element, so valid rows equal the unfused
        composition's."""
        q, k, v, _ = _torch(make_inputs(200, b=2))
        mask = torch.from_numpy(np.random.default_rng(1).random((2, 200)) < 0.7)
        got = t_fl.flash_attention_plain(q, k, v, mask, sw)
        want = t_attn.dot_product_attention(q, k, v, mask, sw, impl="xla")
        np.testing.assert_allclose(got[mask].numpy(), want[mask].numpy(), atol=ATOL, rtol=0)
        assert not got[~mask].any()

    def test_kernels_counts_under_inference_mode(self):
        """The wrappers' mask and key counts from a mask made under
        ``torch.inference_mode()`` (an inference tensor, which tracks no
        version), a fresh count for each mask."""
        with torch.inference_mode():
            mask = torch.tensor([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]]).bool()
            assert mask.is_inference()
            got, counts = t_fl._mask_and_counts(mask, 2, 5, mask.device)
            assert torch.equal(got, mask) and counts.tolist() == [[3, 5], [3, 5]]
            mask[0, 3] = True
            assert t_fl._mask_and_counts(mask, 2, 5, mask.device)[1].tolist() == [[4, 5], [4, 5]]

    def test_other_devices_raise(self):
        q = torch.empty((1, 8, 1, 64), device="meta")
        with pytest.raises(RuntimeError, match="no flash attention kernel"):
            t_fl.flash_attention(q, q, q)


class TestRouting:
    @pytest.fixture
    def plain_calls(self, monkeypatch):
        calls = []
        plain = t_fl.flash_attention_plain
        monkeypatch.setattr(t_fl, "flash_attention_plain",
                            lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw))
        return calls

    @pytest.mark.parametrize("n,d,impl,flash", [
        (2048, 64, "auto", True),     # FLASH_MIN_TOKENS
        (2040, 64, "auto", False),    # below it: the unfused composition
        (2048, 72, "auto", False),    # the G width's head dim
        (64, 64, "flash", True),      # forced at any N
    ])
    def test_dot_product_attention_routes(self, plain_calls, n, d, impl, flash):
        q, k, v, mask = _torch(make_inputs(n, d=d, b=1, heads=1, masked=True))
        launches = t_fl.LAUNCHES
        got = t_attn.dot_product_attention(q, k, v, mask, sliding_window=300, impl=impl)
        assert len(plain_calls) == int(flash) and t_fl.LAUNCHES == launches
        want = t_attn.dot_product_attention(q, k, v, mask, sliding_window=300, impl="xla")
        np.testing.assert_allclose(got[mask].numpy(), want[mask].numpy(), atol=ATOL, rtol=0)

    def test_unknown_impl_raises(self):
        q = torch.zeros((1, 8, 1, 64))
        with pytest.raises(ValueError, match="flash"):
            t_attn.dot_product_attention(q, q, q, impl="pallas")
