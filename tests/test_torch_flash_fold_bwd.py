"""The fold's backward (high-resolution training on the q/k prologue) against
the JAX package.

The same numpy qkv, gains, RoPE tables, mask and cotangent go through
``jax.vjp`` of ``vitok_tpu.ops.fused_attention.unfused_qkv_attention`` on its
flash route (``attn_impl="pallas"``, with the Pallas dq/dkv kernels pinned:
``_BWD_IMPL = "pallas"``, interpret mode on the CPU) and through the port:
``flash_qkv_attention_bwd_plain`` given the port's own forward output and
log-sum-exp, and the autograd Function behind ``flash_qkv_attention`` (which
on CPU tensors runs the plain forward and the plain backward, the wiring the
card uses with the kernels).

Three samples: one full, one with a tail of padding, one all padding.

Tolerances. float32: dqkv within atol 1e-4 on valid rows (the flash
backward's limit, ``tests/test_torch_flash_bwd.py``), the gains' gradients
within 1e-4 of their largest entry; padded rows exactly 0 on both sides.
bfloat16: max error within 2e-2 and mean within 2e-3 of each gradient's
largest entry, the flash backward's bf16 limits: both sides round p and ds
to bf16 before the products that contract them, at other block boundaries,
and the JAX package's autodiff rounds dqrot and dkrot to bf16 before the
norm and rotation backward, which the port runs in fp32 (ROADMAP.md
Queue 3).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.flash_attention as j_fl
from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

ATOL_F32, GAIN_REL_F32 = 1e-4, 1e-4
BF16_MAX, BF16_MEAN = 2e-2, 2e-3
HEADS, D = 2, 64


@pytest.fixture()
def force_pallas_bwd():
    """Pin the JAX package's dq/dkv kernels (auto routes small N elsewhere)."""
    old = j_fl._BWD_IMPL
    j_fl._BWD_IMPL = "pallas"
    yield
    j_fl._BWD_IMPL = old


def make_case(n, seed=0):
    """numpy fp32 qkv ``[3, N, 3C]``, gains U(0.5, 1.5), 2D RoPE tables of a
    16-wide grid, a mask (sample 0 full, sample 1 a tail of padding, sample
    2 all padding) and the cotangent of the output ``[3, N, C]``."""
    rng = np.random.default_rng(seed)
    c = HEADS * D
    qkv = rng.standard_normal((3, n, 3 * c)).astype(np.float32)
    qs = rng.uniform(0.5, 1.5, D).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, D).astype(np.float32)
    idx = np.arange(n)
    row = np.tile((idx // 16)[None], (3, 1)).astype(np.int32)
    col = np.tile((idx % 16)[None], (3, 1)).astype(np.int32)
    cos, sin = (np.array(t) for t in compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), D))
    mask = idx[None, :] < np.array([n, (2 * n) // 3, 0])[:, None]
    g = rng.standard_normal((3, n, c)).astype(np.float32)
    return qkv, qs, ks, cos, sin, mask, g


def jax_grads(case, sw, dtype):
    qkv, qs, ks, cos, sin, mask, g = case

    def f(x, a, b):
        return j_fa.unfused_qkv_attention(x, a, b, jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(mask), HEADS,
                                          sw, attn_impl="pallas")

    out, vjp = jax.vjp(f, jnp.asarray(qkv, dtype), jnp.asarray(qs), jnp.asarray(ks))
    return [np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g, out.dtype))]


def _torch(case, dtype):
    qkv, qs, ks, cos, sin, mask, g = case
    return (torch.from_numpy(qkv).to(dtype), torch.from_numpy(qs), torch.from_numpy(ks), torch.from_numpy(cos),
            torch.from_numpy(sin), torch.from_numpy(mask), torch.from_numpy(g).to(dtype))


def port_grads_plain(case, sw, dtype):
    qkv, qs, ks, cos, sin, mask, g = _torch(case, dtype)
    out, lse = t_fa.flash_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=HEADS, sliding_window=sw,
                                              return_lse=True)
    return t_fa.flash_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, mask, g, num_heads=HEADS, sliding_window=sw,
                                              out=out, lse=lse)


def port_grads_autograd(case, sw, dtype):
    qkv, qs, ks, cos, sin, mask, g = _torch(case, dtype)
    qkv, qs, ks = (t.requires_grad_(True) for t in (qkv, qs, ks))
    out = t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=HEADS, sliding_window=sw)
    assert out.grad_fn is not None
    return torch.autograd.grad(out, (qkv, qs, ks), g)


@pytest.mark.usefixtures("force_pallas_bwd")
class TestAgainstJax:
    @pytest.mark.parametrize("path", ["plain", "autograd"])
    @pytest.mark.parametrize("n", [136, 200])
    @pytest.mark.parametrize("sw", [None, 40])
    def test_float32(self, path, n, sw):
        case = make_case(n)
        want = jax_grads(case, sw, jnp.float32)
        port = port_grads_plain if path == "plain" else port_grads_autograd
        got = [x.detach().numpy() for x in port(case, sw, torch.float32)]
        mask = case[5]
        a, r = got[0], want[0]
        assert a.shape == r.shape == case[0].shape and np.isfinite(a).all()
        assert not a[~mask].any() and not r[~mask].any(), "padded rows of dqkv are not 0"
        np.testing.assert_allclose(a[mask], r[mask], atol=ATOL_F32, rtol=0)
        for what, ga, gr in zip(("dq_scale", "dk_scale"), got[1:], want[1:]):
            assert np.abs(ga - gr).max() <= GAIN_REL_F32 * np.abs(gr).max(), what

    def test_bfloat16(self):
        case = make_case(136, seed=1)
        want = jax_grads(case, 40, jnp.bfloat16)
        got = [x.detach().float().numpy() for x in port_grads_autograd(case, 40, torch.bfloat16)]
        mask = case[5]
        assert not got[0][~mask].any() and not want[0][~mask].any()
        for what, a, r in zip(("dqkv", "dq_scale", "dk_scale"), got, want):
            err, scale = np.abs(a - r), np.abs(r).max()
            assert err.max() <= BF16_MAX * scale and err.mean() <= BF16_MEAN * scale, (
                what, err.max(), err.mean(), scale)


class TestPort:
    @pytest.mark.parametrize("sw", [None, 40])
    def test_function_equals_the_plain_backward(self, sw):
        """Under grad on the CPU, ``flash_qkv_attention``'s Function gives the
        plain backward's gradients bit for bit."""
        case = make_case(136, seed=2)
        got = port_grads_autograd(case, sw, torch.float32)
        want = port_grads_plain(case, sw, torch.float32)
        for a, r in zip(got, want):
            torch.testing.assert_close(a, r, rtol=0, atol=0)

    def test_no_grad_takes_no_function(self):
        qkv, qs, ks, cos, sin, mask, _ = _torch(make_case(136), torch.float32)
        qkv.requires_grad_(True)
        with torch.no_grad():
            out = t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=HEADS, sliding_window=40)
        assert out.grad_fn is None
        torch.testing.assert_close(out, t_fa.flash_qkv_attention_plain(qkv.detach(), qs, ks, cos, sin, mask,
                                                                        num_heads=HEADS, sliding_window=40),
                                   rtol=0, atol=0)

    def test_checkpoint_recomputes_through_the_function(self):
        """``torch.utils.checkpoint`` reruns the Function's forward in the
        backward and gives the stored-activation gradients bit for bit."""
        from torch.utils.checkpoint import checkpoint

        qkv, qs, ks, cos, sin, mask, g = _torch(make_case(136, seed=3), torch.float32)
        f = lambda x: t_fa.flash_qkv_attention(x, qs, ks, cos, sin, mask, num_heads=HEADS, sliding_window=40)
        x = qkv.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(f(x), x, g)
        (got,) = torch.autograd.grad(checkpoint(f, x, use_reentrant=False), x, g)
        torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_other_devices_raise(self):
        qkv = torch.empty((1, 8, 3 * 64), device="meta")
        gain = torch.empty((64,), device="meta")
        with pytest.raises(RuntimeError, match="no fused attention kernel"):
            t_fa.flash_qkv_attention_bwd(qkv, gain, gain, qkv, qkv, None, qkv[..., :64], num_heads=1,
                                         out=qkv[..., :64], lse=qkv)
