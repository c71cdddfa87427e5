"""The port's flash attention backward against the JAX package's.

The same numpy q, k, v, mask and cotangent go through ``jax.grad`` of
``vitok_tpu.ops.flash_attention.flash_attention`` with the Pallas dq/dkv
kernels pinned (``_BWD_IMPL = "pallas"``, interpret mode on the CPU, 128-row
blocks) and through the port: ``flash_attention_bwd_plain`` given the port's
own forward output and log-sum-exp, and the autograd Function behind
``flash_attention`` (which on CPU tensors runs the plain forward and the
plain backward, so the wiring is the one the card uses).

Tolerances. float32: dq, dk, dv within atol 1e-4 on valid rows (the JAX
tests' own limit for these kernels against the XLA vjp); padded rows exactly
0 on both sides. bfloat16 (both sides round p and ds to bf16 before the
products that contract them, at other block boundaries): max error within
2e-2 and mean within 2e-3 of each gradient's largest entry.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.flash_attention as j_fl
from vitok_torch.ops import flash_attention as t_fl

torch.set_num_threads(1)

ATOL_F32 = 1e-4
BF16_MAX, BF16_MEAN = 2e-2, 2e-3


@pytest.fixture()
def force_pallas_bwd():
    """Pin the JAX package's dq/dkv kernels (auto routes small N elsewhere)."""
    old = j_fl._BWD_IMPL
    j_fl._BWD_IMPL = "pallas"
    yield
    j_fl._BWD_IMPL = old


def make_case(n, h, d, mask_kind, seed=0):
    """q, k, v, cotangent ``[B, N, H, D]`` float32 and a mask ``[B, N]`` (or
    None): sample 0 full, sample 1 a tail-suffix mask, and with "hole" a run
    of padding inside it, with "empty" a third, all-padding sample."""
    b = 3 if mask_kind == "empty" else 2
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    mask = None
    if mask_kind != "none":
        valid = [n, (2 * n) // 3, 0][:b]
        mask = np.arange(n)[None, :] < np.array(valid)[:, None]
        if mask_kind == "hole":
            mask[1, n // 4: n // 4 + 20] = False
    return q, k, v, g, mask


@functools.lru_cache(maxsize=None)
def jax_case_grads(n, h, d, mask_kind, sw, dtype):
    """``jax_grads`` of ``make_case(n, h, d, mask_kind)``, once per module:
    the plain and autograd paths of a case share it (the interpreted Pallas
    kernels are most of this file's time)."""
    q, k, v, g, mask = make_case(n, h, d, mask_kind)
    return jax_grads(q, k, v, g, mask, sw, dtype)


def jax_grads(q, k, v, g, mask, sw, dtype):
    jm = None if mask is None else jnp.asarray(mask)
    cot = jnp.asarray(g)

    def loss(q_, k_, v_):
        out = j_fl.flash_attention(q_, k_, v_, patch_mask=jm, sliding_window=sw,
                                   block_q=128, block_k=128)
        return jnp.sum(out.astype(jnp.float32) * cot)

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))  # one compile, not one per operation
    return [np.asarray(x.astype(jnp.float32)) for x in grad(*args)]


def port_grads_plain(q, k, v, g, mask, sw, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out, lse = t_fl.flash_attention(tq, tk, tv, tm, sw, return_lse=True)
    grads = t_fl.flash_attention_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(g).to(dtype), tm, sw)
    return [x.float().numpy() for x in grads]


def port_grads_autograd(q, k, v, g, mask, sw, dtype):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = t_fl.flash_attention(tq, tk, tv, tm, sw)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [x.grad.float().numpy() for x in (tq, tk, tv)]


CASES = [  # (name, N, H, D, mask kind, window)
    ("none", 256, 2, 64, "none", None),
    ("tail", 256, 2, 64, "tail", None),
    ("sw", 256, 2, 64, "none", 40),
    ("tail+sw", 256, 2, 64, "tail", 40),
    ("hole+sw", 256, 2, 64, "hole", 40),
    ("empty-sample", 256, 1, 64, "empty", 40),
    ("d128", 256, 1, 128, "tail", 40),
    ("ragged-N", 300, 1, 64, "tail", 40),
    ("d192", 256, 1, 192, "tail", 40),
    ("d256", 256, 1, 256, "tail", 40),
]


@pytest.mark.usefixtures("force_pallas_bwd")
class TestAgainstPallasBackward:
    @pytest.mark.parametrize("path", ["plain", "autograd"])
    @pytest.mark.parametrize("name,n,h,d,mask_kind,sw", CASES, ids=[c[0] for c in CASES])
    def test_float32(self, path, name, n, h, d, mask_kind, sw):
        q, k, v, g, mask = make_case(n, h, d, mask_kind)
        want = jax_case_grads(n, h, d, mask_kind, sw, jnp.float32)
        port = port_grads_plain if path == "plain" else port_grads_autograd
        got = port(q, k, v, g, mask, sw, torch.float32)
        for what, a, r in zip(("dq", "dk", "dv"), got, want):
            assert np.isfinite(a).all(), what
            if mask is not None:
                assert not a[~mask].any() and not r[~mask].any(), f"{what}: padded rows not 0"
                a, r = a[mask], r[mask]
            np.testing.assert_allclose(a, r, atol=ATOL_F32, rtol=0, err_msg=what)

    @pytest.mark.parametrize("name,n,h,d,mask_kind,sw",
                             [c for c in CASES if c[0] in ("tail+sw", "d128", "d192", "d256")],
                             ids=["tail+sw", "d128", "d192", "d256"])
    def test_bfloat16(self, name, n, h, d, mask_kind, sw):
        q, k, v, g, mask = make_case(n, h, d, mask_kind)
        want = jax_grads(q, k, v, g, mask, sw, jnp.bfloat16)
        got = port_grads_autograd(q, k, v, g, mask, sw, torch.bfloat16)
        for what, a, r in zip(("dq", "dk", "dv"), got, want):
            assert not a[~mask].any() and not r[~mask].any(), f"{what}: padded rows not 0"
            err, scale = np.abs(a - r), np.abs(r).max()
            assert err.max() <= BF16_MAX * scale and err.mean() <= BF16_MEAN * scale, (
                what, err.max(), err.mean(), scale)


class TestWiring:
    def test_function_is_taken_only_under_grad(self, monkeypatch):
        """With grad the call goes through the Function, whose backward calls
        ``flash_attention_bwd``; without grad neither is touched. On CPU
        tensors no kernel launch is counted."""
        calls = []
        orig = t_fl.flash_attention_bwd
        monkeypatch.setattr(t_fl, "flash_attention_bwd", lambda *a: calls.append(1) or orig(*a))
        q, k, v, g, mask = make_case(128, 1, 64, "tail")
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        counts = (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES)
        out = t_fl.flash_attention(tq, tk, tv, torch.from_numpy(mask))
        assert out.grad_fn is None and not calls
        tq.requires_grad_(True)
        with torch.no_grad():
            assert t_fl.flash_attention(tq, tk, tv).grad_fn is None
        out, lse = t_fl.flash_attention(tq, tk, tv, torch.from_numpy(mask), return_lse=True)
        assert out.grad_fn is not None and not lse.requires_grad
        out.sum().backward()
        assert calls == [1] and tq.grad is not None and tk.grad is None
        assert (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES) == counts

    def test_strided_cotangent_and_v_view(self):
        """v as a view into a flat QKV tensor and a consumer that hands back a
        non-contiguous cotangent give the gradients of contiguous copies."""
        rng = np.random.default_rng(3)
        qkv = torch.from_numpy(rng.standard_normal((1, 96, 3, 2, 64)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((1, 2, 96, 64)).astype(np.float32))
        grads = []
        for contiguous in (False, True):
            base = qkv.clone().requires_grad_(True)
            q, k, v = base.unbind(2)
            if contiguous:
                q, k, v = (t.contiguous() for t in (q, k, v))
            out = t_fl.flash_attention(q, k, v, sliding_window=16)
            loss = (out.transpose(1, 2) * w).sum() if not contiguous else (out * w.transpose(1, 2)).sum()
            loss.backward()
            grads.append(base.grad)
        torch.testing.assert_close(grads[0], grads[1], atol=1e-6, rtol=0)
