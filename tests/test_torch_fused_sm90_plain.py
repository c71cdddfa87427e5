"""The plain versions behind the Hopper fused attention, against the JAX package.

The wgmma forward writes each row's log-sum-exp (log2 units) beside its
output, and the backward takes both: it forms p from the forward's
statistics and ``delta = sum_c dO * O`` from the forward's output, where the
JAX package's ``_fused_bwd_kernel`` sums ``dp * p`` over the row. The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here, on the CPU, the
plain versions are held to the JAX package on the same numpy inputs, in
float32:

* the plain backward given ``out`` from the plain forward against the Pallas
  backward kernel in interpret mode (1e-4, the JAX tests' own tolerance for
  that kernel) and against the plain backward's ``dp * p`` form (1e-5: the
  two deltas differ by float32 rounding only);
* the plain forward's log-sum-exp against ``torch.logsumexp`` of the unfused
  logits, in log2 units (1e-5), and 1e30 on padded query rows;
* the autograd Function with the saved output and log-sum-exp against
  ``jax.vjp`` of the JAX ``fused_qkv_attention`` (1e-4), the all-padding
  sample included, padded rows exactly 0;
* the prologue's plain version (q and k normed and rotated, and delta)
  against the JAX ``_norm_rope_half`` per head (1e-5), at head dims 32 and
  128.

Cases as ``tests/test_torch_fused_bwd.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.fused_attention as j_fa
from vitok_tpu.ops.rope import compute_2d_freqs_cis as j_freqs
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

CASES = {
    "no_mask": dict(b=2, n=64, heads=4, d=32),
    "tail_mask": dict(b=3, n=64, heads=4, d=32, valid=[64, 40, 9]),
    "window": dict(b=2, n=64, heads=4, d=32, sw=7),
    "mask_window": dict(b=2, n=48, heads=4, d=32, valid=[48, 20], sw=5),
    "d64": dict(b=1, n=32, heads=2, d=64),
    "d128": dict(b=1, n=32, heads=2, d=128),
    "all_padding_sample": dict(b=3, n=40, heads=2, d=64, valid=[40, 17, 0], sw=6),
}


def make_case(name, seed=0):
    """float32 numpy qkv, gains, RoPE tables, cotangent and tail mask (or
    None), with the case's head count and window."""
    kw = dict(CASES[name])
    b, n, heads, d = kw["b"], kw["n"], kw["heads"], kw["d"]
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
    valid = kw.get("valid")
    mask = None if valid is None else (idx[None, :] < np.asarray(valid)[:, None])
    return (qkv, qs, ks, cos, sin, mask, g), heads, kw.get("sw")


def torch_args(case):
    qkv, qs, ks, cos, sin, mask, g = case
    t = lambda a: torch.from_numpy(np.array(a))
    return (t(qkv), t(qs), t(ks), t(cos), t(sin), None if mask is None else t(mask)), t(g)


def assert_close(got, want, tol):
    for a, b, name in zip(got, want, ("dqkv", "dq_scale", "dk_scale")):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol,
                                   err_msg=name)


def plain_bwd_with_out(case, heads, sw):
    args, g = torch_args(case)
    kw = dict(num_heads=heads, sliding_window=sw)
    out = t_fa.fused_qkv_attention_plain(*args, **kw)
    return [x.numpy() for x in t_fa.fused_qkv_attention_bwd_plain(*args, g, out=out, **kw)]


@pytest.mark.parametrize("name", list(CASES))
class TestPlainVersions:
    def test_bwd_with_out_matches_pallas_kernel_f32(self, name):
        case, heads, sw = make_case(name)
        qkv, qs, ks, cos, sin, mask, g = case
        jm = None if mask is None else jnp.asarray(mask)
        gj = jnp.asarray(g) if jm is None else jnp.asarray(g) * jm.astype(jnp.float32)[..., None]
        want = jax.jit(lambda *xs: j_fa._fused_bwd(*xs, heads, sw, interpret=True))(
            jnp.asarray(qkv), jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(cos), jnp.asarray(sin), jm, gj)
        assert_close(plain_bwd_with_out(case, heads, sw), want, 1e-4)

    def test_bwd_with_out_matches_dp_p_form(self, name):
        """``delta = sum dO * out`` and ``sum dp * p`` are one quantity."""
        case, heads, sw = make_case(name)
        args, g = torch_args(case)
        want = t_fa.fused_qkv_attention_bwd_plain(*args, g, num_heads=heads, sliding_window=sw)
        assert_close(plain_bwd_with_out(case, heads, sw), [x.numpy() for x in want], 1e-5)

    def test_lse_matches_logsumexp(self, name):
        case, heads, sw = make_case(name)
        (qkv, qs, ks, cos, sin, mask), _ = torch_args(case)
        out, lse = t_fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=heads,
                                                  sliding_window=sw, return_lse=True)
        assert torch.equal(out, t_fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=heads,
                                                               sliding_window=sw))
        # The unfused logits: normed and rotated q/k, key mask and window filled with -1e30.
        b, n, c3 = qkv.shape
        q, k = t_fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, num_heads=heads)[0].view(b, n, 2, heads, -1).unbind(2)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
        if mask is not None:
            logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        if sw is not None:
            idx = torch.arange(n)
            logits = logits.masked_fill((idx[:, None] - idx[None, :]).abs() > sw, -1e30)
        want = torch.logsumexp(logits.double(), -1) / np.log(2.0)
        valid = torch.ones(b, n, dtype=torch.bool) if mask is None else mask
        got_valid = lse.transpose(1, 2)[valid]
        np.testing.assert_allclose(got_valid.numpy(), want.transpose(1, 2)[valid].numpy(), atol=1e-5, rtol=1e-5)
        assert (lse.transpose(1, 2)[~valid] == 1e30).all()

    def test_autograd_function_matches_jax_vjp(self, name):
        """``fused_qkv_attention(impl="fused")`` under autograd saves the
        output and log-sum-exp and runs the backward with them."""
        case, heads, sw = make_case(name)
        qkv, qs, ks, cos, sin, mask, g = case
        jm = None if mask is None else jnp.asarray(mask)
        gj = jnp.asarray(g) if jm is None else jnp.asarray(g) * jm.astype(jnp.float32)[..., None]

        def f(qkv_, qs_, ks_):
            return j_fa.fused_qkv_attention(qkv_, qs_, ks_, jnp.asarray(cos), jnp.asarray(sin), jm,
                                            num_heads=heads, sliding_window=sw)

        want = jax.jit(lambda *xs: jax.vjp(f, *xs[:3])[1](xs[3]))(
            jnp.asarray(qkv), jnp.asarray(qs), jnp.asarray(ks), gj)
        (tq, tqs, tks, tcos, tsin, tmask), tg = torch_args(case)
        tq, tqs, tks = (x.requires_grad_(True) for x in (tq, tqs, tks))
        out = t_fa.fused_qkv_attention(tq, tqs, tks, tcos, tsin, tmask, num_heads=heads, sliding_window=sw,
                                       impl="fused")
        got = [x.numpy() for x in torch.autograd.grad(out, (tq, tqs, tks), tg)]
        assert_close(got, want, 1e-4)
        if mask is not None:
            assert not got[0][~mask].any(), "padded rows of dqkv are exactly 0"


@pytest.mark.parametrize("name", ["tail_mask", "d128"])
def test_prologue_matches_jax_norm_rope(name):
    case, heads, sw = make_case(name)
    qkv, qs, ks, cos, sin, mask, g = case
    args, tg = torch_args(case)
    out = t_fa.fused_qkv_attention_plain(*args, num_heads=heads, sliding_window=sw)
    qk, delta = t_fa.fused_qk_prologue_plain(*args[:5], num_heads=heads, out=out, dout=tg)
    b, n, c3 = qkv.shape
    c, d = c3 // 3, c3 // 3 // heads

    # Every (sample, token, head) as one row of _norm_rope_half.
    rows = lambda t: jnp.asarray(np.repeat(t[:, :, None], heads, 2).reshape(b * n * heads, -1))
    want = np.stack([
        np.asarray(j_fa._norm_rope_half(jnp.asarray(qkv[..., part * c:(part + 1) * c].reshape(-1, d)),
                                        jnp.asarray(scale)[None], rows(cos), rows(sin))).reshape(b, n, c)
        for part, scale in ((0, qs), (1, ks))])
    got = qk.view(b, n, 2, c).permute(2, 0, 1, 3).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    k_only, _ = t_fa.fused_qk_prologue_plain(*args[:5], num_heads=heads, with_q=False)
    assert torch.equal(k_only, qk[..., c:])  # the forward's prologue: k alone
    want_delta = np.einsum("bnhd,bnhd->bhn", g.reshape(b, n, heads, d), out.numpy().reshape(b, n, heads, d))
    np.testing.assert_allclose(delta.numpy(), want_delta, atol=1e-5, rtol=1e-5)


def test_bwd_without_out_runs_the_forward_first():
    """``fused_qkv_attention_bwd`` without ``out``/``lse`` forms them itself."""
    case, heads, sw = make_case("mask_window")
    args, g = torch_args(case)
    got = t_fa.fused_qkv_attention_bwd(*args, g, num_heads=heads, sliding_window=sw)
    assert_close([x.numpy() for x in got], plain_bwd_with_out(case, heads, sw), 0.0)
