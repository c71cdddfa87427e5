"""Parity of the port's plain ops (``vitok_torch.ops``) with ``vitok_tpu.ops``.

The same numpy inputs go through both packages in float32 on the CPU;
tolerance atol 1e-5 (float32 rounding in a different summation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops import attention as j_attn
from vitok_tpu.ops import mlp as j_mlp
from vitok_tpu.ops import norms as j_norms
from vitok_tpu.ops import rope as j_rope
from vitok_torch.ops import attention as t_attn
from vitok_torch.ops import mlp as t_mlp
from vitok_torch.ops import norms as t_norms
from vitok_torch.ops import rope as t_rope

torch.set_num_threads(1)

ATOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _grid(b, n, cols=8):
    idx = np.arange(n)
    row = np.tile((idx // cols)[None], (b, 1)).astype(np.int32)
    col = np.tile((idx % cols)[None], (b, 1)).astype(np.int32)
    return row, col


class TestNorms:
    def test_rms_norm(self, rng):
        x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
        s = rng.uniform(0.5, 1.5, 64).astype(np.float32)
        _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
               j_norms.rms_norm(jnp.asarray(x), jnp.asarray(s)))

    def test_rms_norm_bf16_returns_input_dtype(self, rng):
        x = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32)).bfloat16()
        y = t_norms.rms_norm(x, torch.ones(16))
        assert y.dtype == torch.bfloat16

    def test_layer_norm(self, rng):
        x = rng.standard_normal((2, 7, 32)).astype(np.float32) + 2
        _close(t_norms.layer_norm(torch.from_numpy(x)), j_norms.layer_norm(jnp.asarray(x)))

    def test_layer_scale(self, rng):
        x = rng.standard_normal((2, 3, 8)).astype(np.float32)
        g = rng.uniform(0.5, 1.5, 8).astype(np.float32)
        _close(t_norms.layer_scale(torch.from_numpy(x), torch.from_numpy(g)),
               j_norms.layer_scale(jnp.asarray(x), jnp.asarray(g)))


class TestRope:
    @pytest.mark.parametrize("dim", [16, 64, 128])
    def test_inv_freq(self, dim):
        _close(t_rope.compute_inv_freq(dim), j_rope.compute_inv_freq(dim))

    def test_inv_freq_odd_raises(self):
        with pytest.raises(ValueError):
            t_rope.compute_inv_freq(7)

    @pytest.mark.parametrize("dim", [64, 128])
    def test_2d_freqs(self, dim):
        row, col = _grid(2, 40)
        tc, ts = t_rope.compute_2d_freqs_cis(torch.from_numpy(row), torch.from_numpy(col), dim)
        jc, js = j_rope.compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), dim)
        assert tuple(tc.shape) == (2, 40, dim // 2) and tc.dtype == torch.float32
        _close(tc, jc)
        _close(ts, js)

    @pytest.mark.parametrize("convention", ["half", "interleaved"])
    @pytest.mark.parametrize("layout,table_batch", [("bnhd", True), ("bhnd", True), ("bhnd", False)])
    def test_apply_rotary_emb(self, rng, convention, layout, table_batch):
        b, n, h, d = 2, 24, 3, 64
        shape = (b, n, h, d) if layout == "bnhd" else (b, h, n, d)
        q = rng.standard_normal(shape).astype(np.float32)
        k = rng.standard_normal(shape).astype(np.float32)
        row, col = _grid(b, n)
        if not table_batch:
            row, col = row[0], col[0]
        jc, js = j_rope.compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), d)
        tq, tk = t_rope.apply_rotary_emb(
            torch.from_numpy(q), torch.from_numpy(k), torch.tensor(_np(jc)),
            torch.tensor(_np(js)), convention=convention,
        )
        jq, jk = j_rope.apply_rotary_emb(jnp.asarray(q), jnp.asarray(k), jc, js, convention=convention)
        _close(tq, jq)
        _close(tk, jk)

    def test_unknown_convention_raises(self):
        x = torch.zeros(1, 2, 1, 4)
        with pytest.raises(ValueError):
            t_rope.apply_rotary_emb(x, x, torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), convention="x")

    @pytest.mark.parametrize("d", [64, 128])
    def test_half_permutation_identity(self, rng, d):
        """Rotate-half on permuted channels == interleaved rotation, permuted."""
        perm = t_rope.rope_half_permutation(d)
        np.testing.assert_array_equal(perm, j_rope.rope_half_permutation(d))
        x = torch.from_numpy(rng.standard_normal((2, 10, 2, d)).astype(np.float32))
        row, col = _grid(2, 10, cols=5)
        cos, sin = t_rope.compute_2d_freqs_cis(torch.from_numpy(row), torch.from_numpy(col), d)
        inter, _ = t_rope.apply_rotary_emb(x, x, cos, sin, convention="interleaved")
        half, _ = t_rope.apply_rotary_emb(x[..., perm], x[..., perm], cos, sin, convention="half")
        torch.testing.assert_close(half, inter[..., perm], atol=ATOL, rtol=0)


class TestMlp:
    @pytest.mark.parametrize("h", [0, 7, 8, 9, 2734, 2736, 2744, 8202])
    def test_round_hidden_dim(self, h):
        assert t_mlp.round_hidden_dim(h) == j_mlp.round_hidden_dim(h)

    def test_swiglu(self, rng):
        d, hid = 32, 48
        x = rng.standard_normal((2, 5, d)).astype(np.float32)
        w1 = rng.standard_normal((d, 2 * hid)).astype(np.float32) / np.sqrt(d)
        w2 = rng.standard_normal((hid, d)).astype(np.float32) / np.sqrt(hid)
        got = t_mlp.swiglu(torch.from_numpy(x), torch.from_numpy(w1.T.copy()), torch.from_numpy(w2.T.copy()))
        _close(got, j_mlp.swiglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2)))


class TestAttention:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("sw", [None, 5])
    def test_make_attention_mask(self, masked, sw):
        n = 16
        pm = np.arange(n)[None] < np.array([[16], [9]]) if masked else None
        got = t_attn.make_attention_mask(None if pm is None else torch.from_numpy(pm), n, sw)
        want = j_attn.make_attention_mask(None if pm is None else jnp.asarray(pm), n, sw)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("sw", [None, 6])
    def test_xla_attention(self, rng, masked, sw):
        b, n, h, d = 2, 24, 2, 64
        q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3))
        pm = np.arange(n)[None] < np.array([[24], [11]]) if masked else None
        got = t_attn.dot_product_attention(
            *(torch.from_numpy(a) for a in (q, k, v)),
            patch_mask=None if pm is None else torch.from_numpy(pm), sliding_window=sw, impl="xla",
        )
        want = j_attn.dot_product_attention(
            *(jnp.asarray(a) for a in (q, k, v)),
            patch_mask=None if pm is None else jnp.asarray(pm), sliding_window=sw, impl="xla",
        )
        _close(got, want)

    def test_auto_on_cpu_is_the_composition(self, rng):
        q = torch.from_numpy(rng.standard_normal((1, 16, 1, 64)).astype(np.float32))
        torch.testing.assert_close(
            t_attn.dot_product_attention(q, q, q, impl="auto"),
            t_attn.dot_product_attention(q, q, q, impl="xla"),
        )

    def test_unknown_impl_raises(self):
        q = torch.zeros(1, 8, 1, 64)
        with pytest.raises(ValueError):
            t_attn.dot_product_attention(q, q, q, impl="pallas")
