"""The port's fused attention backward against the JAX package's.

The same numpy qkv, gains, positions, mask and cotangent go through the JAX
package's Pallas backward kernel (``fa._fused_bwd(..., interpret=True)`` on
the CPU) and its unfused composition's VJP, and through the port:
``fused_qkv_attention_bwd_plain`` and the autograd Function behind
``fused_qkv_attention(impl="fused")`` (which on CPU tensors runs the plain
forward and the plain backward, so the wiring is the one the card uses).
Cases as ``tests/test_fused_attention.py::TestPallasBwdKernel``: no mask,
tail mask, window, both, head dims 64, 128, 192 and 256, an all-padding sample.

Tolerances, the JAX tests' own for this kernel: float32 dqkv and both gain
gradients within atol = rtol = 1e-4; bfloat16 within 5e-2 (both sides round
p and ds to bf16 before the products that contract them). Padded query rows
are exactly 0 on both sides.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis as j_freqs
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

TOL = {np.float32: 1e-4, "bfloat16": 5e-2}


def make_case(b, n, heads, d, valid=None, seed=0):
    """float32 qkv, gains, RoPE tables, cotangent, and a tail mask from the
    per-sample valid counts (or None)."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qs = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ks = (1.0 - 0.1 * rng.standard_normal(d)).astype(np.float32)
    idx = np.arange(n)
    cols = max(int(np.sqrt(n)), 1)
    row, col = np.tile(idx // cols, (b, 1)), np.tile(idx % cols, (b, 1))
    cos, sin = (np.asarray(t) for t in j_freqs(jnp.asarray(row), jnp.asarray(col), d))
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    mask = None if valid is None else (idx[None, :] < np.asarray(valid)[:, None])
    return qkv, qs, ks, cos, sin, mask, g


def jax_kernel_bwd(case, heads, sw, dtype):
    qkv, qs, ks, cos, sin, mask, g = case
    jm = None if mask is None else jnp.asarray(mask)
    gj = jnp.asarray(g, dtype)
    if jm is not None:
        gj = gj * jm.astype(gj.dtype)[..., None]
    bwd = jax.jit(j_fa._fused_bwd, static_argnums=(7, 8), static_argnames=("interpret",))
    out = bwd(jnp.asarray(qkv, dtype), jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(cos), jnp.asarray(sin), jm, gj,
              heads, sw, interpret=True)
    return [np.asarray(t, np.float32) for t in out]


def jax_unfused_vjp(case, heads, sw):
    qkv, qs, ks, cos, sin, mask, g = case
    jm = None if mask is None else jnp.asarray(mask)
    gj = jnp.asarray(g)
    if jm is not None:
        gj = gj * jm.astype(gj.dtype)[..., None]

    def f(qkv_, qs_, ks_):
        return j_fa.unfused_qkv_attention(qkv_, qs_, ks_, jnp.asarray(cos), jnp.asarray(sin), jm,
                                          heads, sw, attn_impl="xla")

    @jax.jit  # one compile, not one per operation
    def vjp_of(qkv_, qs_, ks_, g_):
        return jax.vjp(f, qkv_, qs_, ks_)[1](g_)

    return [np.asarray(t, np.float32) for t in vjp_of(jnp.asarray(qkv), jnp.asarray(qs), jnp.asarray(ks), gj)]


def torch_args(case, dtype=torch.float32):
    qkv, qs, ks, cos, sin, mask, g = case
    t = torch.from_numpy
    return (t(qkv).to(dtype), t(qs), t(ks), t(cos), t(sin), None if mask is None else t(mask)), t(g).to(dtype)


def port_plain(case, heads, sw, dtype=torch.float32):
    args, g = torch_args(case, dtype)
    out = t_fa.fused_qkv_attention_bwd_plain(*args, g, num_heads=heads, sliding_window=sw)
    return [o.float().numpy() for o in out]


def port_autograd(case, heads, sw, dtype=torch.float32):
    (qkv, qs, ks, cos, sin, mask), g = torch_args(case, dtype)
    qkv, qs, ks = (x.requires_grad_(True) for x in (qkv, qs, ks))
    out = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=heads, sliding_window=sw,
                                   impl="fused")
    return [o.float().numpy() for o in torch.autograd.grad(out, (qkv, qs, ks), g)]


def assert_close(got, want, tol):
    for a, b, name in zip(got, want, ("dqkv", "dq_scale", "dk_scale")):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


CASES = {
    "no_mask": dict(b=2, n=64, heads=4, d=32),
    "tail_mask": dict(b=3, n=64, heads=4, d=32, valid=[64, 40, 9]),
    "window": dict(b=2, n=64, heads=4, d=32, sw=7),
    "mask_window": dict(b=2, n=48, heads=4, d=32, valid=[48, 20], sw=5),
    "d64": dict(b=1, n=32, heads=2, d=64),
    "d128": dict(b=1, n=32, heads=2, d=128),
    "all_padding_sample": dict(b=3, n=40, heads=2, d=64, valid=[40, 17, 0], sw=6),
    "d192": dict(b=1, n=32, heads=2, d=192),
    "d256_mask_window": dict(b=2, n=64, heads=2, d=256, valid=[64, 23], sw=9),
    "d320": dict(b=1, n=32, heads=2, d=320),
}


def _split(name):
    kw = dict(CASES[name])
    sw = kw.pop("sw", None)
    return make_case(**kw), kw["heads"], sw


@functools.lru_cache(maxsize=None)
def jax_reference(name, kind, dtype=jnp.float32):
    """The JAX package's gradients of case ``name``, once per module (the
    tests of a case share them): ``"kernel"`` the interpreted Pallas
    backward, ``"unfused"`` the composition's VJP."""
    case, heads, sw = _split(name)
    if kind == "kernel":
        return jax_kernel_bwd(case, heads, sw, dtype)
    return jax_unfused_vjp(case, heads, sw)


@pytest.mark.parametrize("name", list(CASES))
class TestPlainBackward:
    def test_matches_pallas_kernel_f32(self, name):
        case, heads, sw = _split(name)
        assert_close(port_plain(case, heads, sw), jax_reference(name, "kernel"), 1e-4)

    def test_matches_unfused_vjp_f32(self, name):
        case, heads, sw = _split(name)
        assert_close(port_plain(case, heads, sw), jax_reference(name, "unfused"), 1e-4)

    def test_autograd_function_f32(self, name):
        """``fused_qkv_attention(impl="fused")`` under autograd runs the same
        backward, on the cotangent zeroed at padded query rows."""
        case, heads, sw = _split(name)
        got = port_autograd(case, heads, sw)
        assert_close(got, jax_reference(name, "kernel"), 1e-4)
        mask = case[5]
        if mask is not None:
            assert not got[0][~mask].any(), "padded rows of dqkv are exactly 0"


@pytest.mark.parametrize("name", ["no_mask", "tail_mask", "mask_window", "d64", "d128", "d192", "d256_mask_window"])
def test_matches_pallas_kernel_bf16(name):
    case, heads, sw = _split(name)
    got = port_plain(case, heads, sw, torch.bfloat16)
    assert_close(got, jax_reference(name, "kernel", jnp.bfloat16), 5e-2)


class TestWiring:
    def test_all_padding_sample_is_exactly_zero(self):
        case, heads, sw = _split("all_padding_sample")
        dqkv = port_plain(case, heads, sw)[0]
        assert not dqkv[2].any()
        assert np.isfinite(dqkv).all()

    def test_cos_sin_get_no_gradient(self):
        (qkv, qs, ks, cos, sin, mask), g = torch_args(_split("no_mask")[0])
        qkv.requires_grad_(True)
        cos.requires_grad_(True)
        out = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=4, impl="fused")
        dqkv, dcos = torch.autograd.grad(out, (qkv, cos), g, allow_unused=True)
        assert dcos is None and dqkv.abs().sum() > 0

    def test_gain_only_gradient(self):
        """A frozen qkv with trainable gains still takes the Function."""
        (qkv, qs, ks, cos, sin, mask), g = torch_args(_split("no_mask")[0])
        qs.requires_grad_(True)
        out = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=4, impl="fused")
        (dqs,) = torch.autograd.grad(out, (qs,), g)
        want = jax_reference("no_mask", "kernel")[1]
        np.testing.assert_allclose(dqs.numpy(), want, atol=1e-4, rtol=1e-4)

    def test_auto_under_grad_takes_the_unfused_composition(self):
        """``impl="auto"`` under grad stays on the unfused composition (the
        JAX package's training gate); its gradient agrees on valid rows'
        cotangents with the fused backward."""
        case, heads, sw = _split("no_mask")
        (qkv, qs, ks, cos, sin, mask), g = torch_args(case)
        qkv.requires_grad_(True)
        before = t_fa.BWD_LAUNCHES
        out = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=heads, impl="auto")
        (dqkv,) = torch.autograd.grad(out, (qkv,), g)
        assert t_fa.BWD_LAUNCHES == before  # nothing launches on the CPU either way
        np.testing.assert_allclose(dqkv.numpy(), port_plain(case, heads, sw)[0], atol=1e-4, rtol=1e-4)

    def test_gate_follows_the_forward(self):
        """The backward's gate is the forward's, on the card too since the
        backward has instances at head dims 192 and 256 (the 5B width with
        16 heads of 192 and 12 of 256), in bf16 and, since the fp32 backward
        has them too, in fp32; past 256 (20 heads of 320 at C 6400) it is
        closed on the card in both."""
        for n, c, h in [(256, 1024, 16), (1024, 1024, 16), (256, 3072, 24), (1024, 3072, 24),
                        (252, 1024, 16), (256, 96 * 16, 16), (2048, 1024, 16), (256, 3072, 16),
                        (1024, 3072, 12), (256, 6400, 20)]:
            assert t_fa.can_fuse_bwd(n, c, h) == t_fa.can_fuse(n, c, h)
            assert t_fa.can_fuse_bwd(n, c, h, cuda=True) == t_fa.can_fuse(n, c, h, cuda=True)
            f32 = dict(cuda=True, dtype=torch.float32)
            assert t_fa.can_fuse_bwd(n, c, h, **f32) == t_fa.can_fuse(n, c, h, **f32)
            assert t_fa.can_fuse_bwd(n, c, h, cuda=True) == (t_fa.can_fuse(n, c, h) and c // h <= 256)
            assert t_fa.can_fuse_bwd(n, c, h, **f32) == (t_fa.can_fuse(n, c, h) and c // h <= 256)

    def test_no_kernel_on_other_devices(self):
        (qkv, qs, ks, cos, sin, mask), g = torch_args(_split("no_mask")[0])
        with pytest.raises(RuntimeError, match="no fused attention kernel"):
            t_fa.fused_qkv_attention_bwd(qkv.to("meta"), qs, ks, cos, sin, mask, g, num_heads=4)
