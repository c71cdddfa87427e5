"""The port's fused attention with the int8 quantize epilogue against the
JAX package's.

The same numpy inputs go through the JAX package's Pallas kernel
(``fused_qkv_attention_q8(..., interpret=True)`` on the CPU) and the port's
``fused_qkv_attention_q8_plain`` (what its wrapper runs on CPU tensors).

Tolerances, the JAX tests' own for this kernel
(``tests/test_fused_attention.py::TestQuantEpilogue``): scales within rtol
1e-6 in float32 (1e-2 in bfloat16, where a scale is one bf16 value over 127
and the two packages round the attention output apart), codes within one
step and fewer than 1% of them off. The int8 autoencoder with the epilogue
forced open on both sides, each half on the JAX latents: decoded patches
within rel L2 1e-3 (2e-7 measured: every code agrees); encoder latents
within 5e-3. The encoder's 8-channel latent is a LayerNorm of a narrow
code, and a code at a rounding tie can flip between the two packages (the
port sums the RMSNorm squares in fp64, XLA in fp32; the Pallas kernel forms
its probabilities in another order): one flip moves these latents by about
7e-4, and seeds 0-3 read 2e-4 to 2.9e-3, the decoder 2e-7 at every one.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.fused_attention as j_fa
from vitok_tpu.models.ae import decode_apply, encode_apply
from vitok_tpu.ops import quant as j_q
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops.quant import quantize_activation
from vitok_torch.utils.params_io import from_jax_params

from tests.test_torch_ae import jax_params, make_batch
from tests.test_torch_fused_bwd import make_case
from tests.test_torch_quant import jax_tpu_routing

torch.set_num_threads(1)


def both(case, heads, sw, dtype_j, dtype_t):
    qkv, qs, ks, cos, sin, mask, _ = case
    jm = None if mask is None else jnp.asarray(mask)
    jq, jscale = j_fa.fused_qkv_attention_q8(
        jnp.asarray(qkv, dtype_j), jnp.asarray(qs), jnp.asarray(ks), jnp.asarray(cos), jnp.asarray(sin),
        jm, num_heads=heads, sliding_window=sw, interpret=True)
    t = torch.from_numpy
    tq, tscale = t_fa.fused_qkv_attention_q8(
        t(qkv).to(dtype_t), t(qs), t(ks), t(cos), t(sin), None if mask is None else t(mask),
        num_heads=heads, sliding_window=sw)
    return (np.asarray(jq, np.int32), np.asarray(jscale)), (tq.numpy().astype(np.int32), tscale.numpy())


def check(case, heads, sw=None, bf16=False):
    (jq, jscale), (tq, tscale) = both(case, heads, sw, jnp.bfloat16 if bf16 else jnp.float32,
                                      torch.bfloat16 if bf16 else torch.float32)
    mask = case[5]
    rows = np.ones(jq.shape[:2], bool) if mask is None else mask
    assert tq.dtype == np.int32 and tscale.shape == jscale.shape == (*jq.shape[:2], 1)
    np.testing.assert_allclose(tscale[rows], jscale[rows], rtol=1e-2 if bf16 else 1e-6)
    diff = np.abs(tq - jq)[rows]
    assert diff.max() <= (2 if bf16 else 1)
    assert (diff > 0).mean() < (0.05 if bf16 else 0.01)


class TestPlainQ8:
    def test_no_mask_f32(self):
        check(make_case(b=2, n=64, heads=4, d=32), 4)

    def test_no_mask_bf16(self):
        check(make_case(b=2, n=64, heads=4, d=32), 4, bf16=True)

    def test_tail_mask(self):
        check(make_case(b=2, n=64, heads=4, d=32, valid=[64, 40]), 4)

    def test_d64_with_window(self):
        check(make_case(b=2, n=64, heads=4, d=64, valid=[64, 37]), 4, sw=9)

    def test_d128(self):
        check(make_case(b=1, n=32, heads=2, d=128), 2)

    def test_is_quantize_of_the_plain_forward(self):
        """Codes and scales are ``quantize_activation`` of the plain forward's
        output, bit for bit (on the card the two kernels share one body)."""
        qkv, qs, ks, cos, sin, mask, _ = make_case(b=2, n=48, heads=2, d=64, valid=[48, 20])
        t = torch.from_numpy
        args = (t(qkv).bfloat16(), t(qs), t(ks), t(cos), t(sin), t(mask))
        q, s = t_fa.fused_qkv_attention_q8(*args, num_heads=2, sliding_window=5)
        wq, ws = quantize_activation(t_fa.fused_qkv_attention_plain(*args, num_heads=2, sliding_window=5))
        assert q.dtype == torch.int8 and torch.equal(q, wq) and torch.equal(s, ws)


class TestGate:
    @pytest.fixture()
    def opted_in(self, monkeypatch):
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        monkeypatch.setattr(j_fa, "_ENABLE_Q8", True)
        monkeypatch.setattr(j_fa, "_backend_is_tpu", lambda: True)

    def test_default_off(self):
        assert not t_fa.can_fuse_q8(256, 3072, 24)

    @pytest.mark.parametrize("n,c,h", [
        (256, 1024, 16), (1024, 1024, 16), (256, 3072, 24), (1024, 3072, 24), (252, 1024, 16),
        (256, 96 * 16, 16), (64, 256, 4), (2048, 1024, 16), (256, 1024, 7)])
    def test_same_shapes_as_the_jax_gate(self, opted_in, n, c, h):
        assert t_fa.can_fuse_q8(n, c, h) == j_fa.can_fuse_q8(n, c, h)

    def test_headline_shapes_open(self, opted_in):
        assert t_fa.can_fuse_q8(256, 1024, 16)  # 350M at 256 tokens
        assert t_fa.can_fuse_q8(256, 3072, 24)  # 5B at 256 tokens

    def test_never_looser_than_the_forward_gate(self, opted_in):
        for n, c, h in [(256, 1024, 16), (1024, 1024, 16), (256, 3072, 24), (252, 1024, 16)]:
            if t_fa.can_fuse_q8(n, c, h):
                assert t_fa.can_fuse(n, c, h)

    @pytest.mark.parametrize("h,d,want", [
        (16, 64, 4),     # 350M: four heads a block, 68,224 bytes of shared memory
        (24, 128, 12),   # 5B: two heads a block (non-portable), 101,248 bytes
        (32, 128, 16),   # E: two heads a block
        (16, 128, 8),
        (3, 128, 3),     # d 128 with an odd H: the portable rule
        (4, 64, 4),
        (7, 64, 7),      # 7 and 1 are as near 4: the larger
        (2, 128, 1),
        (12, 64, 4),
        (13, 64, 1),     # 13 heads of 64 in one block fit
        (13, 128, None),  # 13 heads of 128 in one block do not fit beside the tiles
    ])
    def test_cluster_size(self, h, d, want):
        """The cluster of the int8-epilogue kernel and its shared memory: the
        forward kernel's tiles, then the slab of the block's heads but the
        last, which goes over the K slots."""
        if want is None:
            with pytest.raises(ValueError, match="cluster"):
                t_fa._q8_cluster_size(h, d)
            return
        assert t_fa._q8_cluster_size(h, d) == want
        tile = 64 * d * 2
        forward = 5 * tile + 128 + 4 * d  # Q, two K and two V tiles, key states, gain
        slab = 2 * 64 * ((h // want - 1) * d + 8)
        assert t_fa._q8_smem_bytes(h // want, d) == forward + slab + 256 + 1024 <= t_fa._SMEM_LIMIT

    def test_launches_the_prologue_then_the_kernel(self, monkeypatch):
        """On a card tensor the wrapper runs the k prologue, then the epilogue
        kernel in clusters of ``_q8_cluster_size`` blocks, four at d 64 (a
        recorder in place of each launch)."""
        qkv, qs, ks, cos, sin, mask, _ = make_case(b=2, n=64, heads=16, d=64, valid=[64, 40])
        t = lambda a: torch.from_numpy(np.array(a))

        class Card(torch.Tensor):
            @property
            def is_cuda(self):
                return True

        calls = []

        def prologue(qkv_, q_scale, k_scale, cos_, sin_, num_heads, out=None, dout=None, with_q=True):
            calls.append(("prologue", with_q))
            return torch.empty(2, 64, 1024, dtype=qkv_.dtype), None

        def kernel(*args):
            calls.append(("q8", args[8:14]))
            return 0

        monkeypatch.setattr(t_fa, "_prologue_cuda", prologue)
        monkeypatch.setattr(t_fa, "_sm90_lib", lambda: type("Lib", (), {
            "vitok_fused_attention_q8_sm90_bf16": staticmethod(kernel)}))
        monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: type("S", (), {"cuda_stream": 0}))
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        before = t_fa.Q8_LAUNCHES
        codes, scales = t_fa.fused_qkv_attention_q8(
            t(qkv).bfloat16().as_subclass(Card), t(qs), t(ks), t(cos), t(sin), t(mask), num_heads=16)
        assert calls == [("prologue", False), ("q8", (2, 64, 16, 64, 4, -1))]
        assert t_fa.Q8_LAUNCHES == before + 1
        assert codes.shape == (2, 64, 1024) and codes.dtype == torch.int8 and scales.shape == (2, 64, 1)


class TestModelRouting:
    """The int8 autoencoder with the epilogue forced open, against the JAX
    model forced open the same way (interpret-mode kernels), as
    ``tests/test_fused_attention.py::TestModelQ8Routing`` does."""

    def test_int8_forward_matches_jax(self, monkeypatch):
        from vitok_tpu.models import AEConfig as JAEConfig

        kw = dict(encoder_width=256, decoder_width=256, encoder_depth=2, decoder_depth=2,
                  encoder_heads=4, decoder_heads=4, channels_per_token=8, pixels_per_token=768,
                  layer_scale_init=1.0)
        jcfg = JAEConfig(**kw, attn_impl="auto")
        params = j_q.quantize_block_params(jax_params(jcfg))
        batch = make_batch(2, 64, 16, [(8, 8), (5, 8)])

        monkeypatch.setattr(j_fa, "_backend_is_tpu", lambda: True)
        monkeypatch.setattr(j_fa, "_ENABLE_Q8", True)
        monkeypatch.setattr(j_fa, "fused_qkv_attention_q8",
                            functools.partial(j_fa.fused_qkv_attention_q8, interpret=True))
        monkeypatch.setattr(j_fa, "fused_qkv_attention",
                            functools.partial(j_fa.fused_qkv_attention, interpret=True))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        with jax_tpu_routing():  # the int8 block's other kernels as on the TPU, interpreted
            enc = encode_apply(params, jb, jcfg, compute_dtype=jnp.float32)
            dec = decode_apply(params, enc, jcfg, compute_dtype=jnp.float32)
        z_want, p_want = np.asarray(enc["z"]), np.asarray(dec["patches"])

        tcfg = t_ae.AEConfig(**kw, attn_impl="auto")
        state = from_jax_params(jax.tree_util.tree_map(np.asarray, params), tcfg)
        model = t_ae.AE(**dataclasses.asdict(tcfg), state_dict=state, device="cpu",
                        compute_dtype=torch.float32)
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        calls = {"q8": 0}
        real = t_fa.fused_qkv_attention_q8

        def counted(*a, **k):
            calls["q8"] += 1
            return real(*a, **k)

        monkeypatch.setattr(t_fa, "fused_qkv_attention_q8", counted)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        valid = batch["patch_mask"].astype(bool)
        rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
        # Each half against the JAX half on the JAX latents, as the int8 model
        # parity test does: a code at a rounding tie can flip.
        z = model.encode(tb)["z"].numpy()
        got = model.decode({**tb, "z": torch.from_numpy(z_want)})["patches"].numpy()
        assert calls["q8"] == 4, "every block takes the epilogue kernel's wrapper"
        assert rel(z[valid], z_want[valid]) <= 5e-3
        assert rel(got[valid], p_want[valid]) <= 1e-3

        # With the opt-in off the same model takes the forward + eager quantize:
        # identical codes, identical output.
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", False)
        off = model.decode({**tb, "z": torch.from_numpy(z_want)})["patches"].numpy()
        assert calls["q8"] == 4
        np.testing.assert_array_equal(got, off)
