"""Parity of the port's int8 inference (``vitok_torch.ops.quant``,
``AE.quantize``) with the JAX package's (``vitok_tpu.ops.quant``).

Inputs are made with numpy from a seed and fed to both packages.

* The recipe (weight and activation quantization, the padded SwiGLU layout,
  the int8 product and its fp32 rescale) is bit-exact at fp32.
* Each kernel's plain version is held to the JAX Pallas kernel run in
  interpret mode: codes differ by at most one step, in at most 0.1% of the
  entries (sums and ``silu`` round in another order); scales within rtol
  1e-6; the pad columns of the padded layout are exactly 0.
* The int8 model, on the CPU with the plain versions, is held to the JAX
  int8 model run at fp32 with its TPU routing reproduced on the CPU (the
  Pallas kernels in interpret mode, the backend check of the gate lifted),
  on valid tokens within rel L2 1e-3, at both FFN routes and the unfused
  one. Where every code agrees the two agree to about 2e-7 (measured). A
  code at a rounding tie can flip: the port sums the RMSNorm squares
  exactly (fp64, so the card's kernel and its plain version agree bit for
  bit) and XLA in fp32, in an order no other sum reproduces; one such flip
  moves the output of these 3-block models by 6.9e-4 (measured: the SwiGLU
  + quantize route, no window).
* An SSIM gate of int8 against fp32 (>= 0.99) and its 4-bit negative
  control, as ``tests/test_quant.py`` has them.
"""

import contextlib
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_ae import make_batch as dense_batch
from tests.test_torch_ae import jax_params, make_batch
from vitok_tpu.metrics import compute_ssim
from vitok_tpu.models import ae as j_ae
from vitok_tpu.ops import quant as j_q
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import quant as t_q
from vitok_torch.pp.ops import unpatchify
from vitok_torch.utils.params_io import from_jax_params

torch.set_num_threads(1)

MODEL_REL_L2 = 1e-3  # see the module docstring: one code at a rounding tie
CODE_SHARE = 1e-3  # at most 0.1% of the codes may differ, by one step


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 else t.detach().numpy()


def assert_codes_close(got, want, share=CODE_SHARE):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= share, (diff > 0).mean()


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# The recipe
# ---------------------------------------------------------------------------


class TestRecipe:
    @pytest.mark.parametrize("shape", [(64, 48), (3, 40, 24)])
    def test_quantize_weight_matches_jax(self, shape):
        rng = np.random.default_rng(0)
        k = rng.standard_normal(shape).astype(np.float32)
        k[..., 5] = 0.0  # an all-zero output channel: scale floors at 1e-12
        want = j_q.quantize_weight(jnp.asarray(k))
        q, s = t_q.quantize_weight(torch.from_numpy(np.swapaxes(k, -1, -2).copy()))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), np.asarray(want["kernel_int8"]))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want["scale"]))

    @pytest.mark.parametrize("shape", [(2, 10, 40), (7, 33)])
    def test_quantize_activation_matches_jax(self, shape):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        x[..., 0, :] = 0.0  # a zero token
        wq, ws = j_q.quantize_activation(jnp.asarray(x))
        q, s = t_q.quantize_activation(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))

    @pytest.mark.parametrize("f", [136, 128])
    def test_padded_layout_matches_jax(self, f):
        rng = np.random.default_rng(2)
        fc1 = rng.standard_normal((2, 24, 2 * f)).astype(np.float32)  # [depth, C, 2F]
        fc2 = rng.standard_normal((2, f, 24)).astype(np.float32)      # [depth, F, C]
        got1 = t_q.pad_fc1_weight(torch.from_numpy(np.swapaxes(fc1, -1, -2).copy()))
        got2 = t_q.pad_fc2_weight(torch.from_numpy(np.swapaxes(fc2, -1, -2).copy()))
        want1 = np.asarray(j_q.pad_fc1_kernel(jnp.asarray(fc1)))
        want2 = np.asarray(j_q.pad_fc2_kernel(jnp.asarray(fc2)))
        np.testing.assert_array_equal(np.swapaxes(got1.numpy(), -1, -2), want1)
        np.testing.assert_array_equal(np.swapaxes(got2.numpy(), -1, -2), want2)
        assert t_q.pad_ffn_dim(f) == j_q.pad_ffn_dim(f)

    @pytest.mark.parametrize("m,k,n", [(12, 40, 24), (33, 136, 64)])
    def test_int8_products_bit_identical(self, m, k, n):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
        jqp = j_q.quantize_weight(jnp.asarray(w))
        wq, ws = t_q.quantize_weight(torch.from_numpy(w.T.copy()))
        xq, xs = j_q.quantize_activation(jnp.asarray(x))
        want = j_q.int8_matmul_prequant(xq, xs, jqp, jnp.float32)
        got = t_q.int8_matmul_prequant(torch.from_numpy(np.array(xq)), torch.from_numpy(np.array(xs)),
                                       wq, ws, torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        lin = t_q.int8_linear(torch.from_numpy(x).reshape(3, -1, k) if m % 3 == 0 else torch.from_numpy(x),
                              wq, ws)
        np.testing.assert_array_equal(lin.reshape(m, n).numpy(), np.asarray(j_q.int8_linear(jnp.asarray(x), jqp)))

    def test_gates_follow_the_jax_shape_conditions(self):
        for m, c, f2 in [(4096, 3072, 2 * 8320), (4095, 3072, 2 * 8320), (4096, 3072, 2 * 8208),
                         (4096, 3000, 2 * 8320), (64, 128, 768), (60, 128, 768), (64, 192, 768)]:
            assert t_q.can_fuse_ffn(m, c, f2) == j_q._ffn_shapes_fusable(m, c, f2)
        assert [t_q.can_fuse_silu_quant(n) for n in (8, 30, 256)] == [True, False, True]

    def test_other_devices_raise(self):
        x = torch.empty(2, 32, 64, dtype=torch.bfloat16, device="meta")
        for call in (lambda: t_q.fused_rmsnorm_quant(x, torch.ones(64, device="meta")),
                     lambda: t_q.fused_silu_quant(x),
                     lambda: t_q.fused_ffn_int8(x.to(torch.int8)[0], x[0, :, :1].float(),
                                                x.to(torch.int8)[0], x[0, 0].float()),
                     lambda: t_q.int8_matmul_prequant(x.to(torch.int8), x[..., :1].float(),
                                                      x.to(torch.int8)[0], x[0, 0].float(), torch.float32)):
            with pytest.raises(RuntimeError, match="meta"):
                call()


# ---------------------------------------------------------------------------
# Each kernel's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


class TestPlainVersionsMatchPallas:
    @pytest.mark.parametrize("b,n,c", [(2, 48, 136), (3, 40, 256), (1, 200, 128)])
    def test_rmsnorm_quant(self, b, n, c):
        rng = np.random.default_rng(4)
        x = (rng.standard_normal((b, n, c)) * 2).astype(np.float32)
        g = rng.uniform(0.5, 1.5, c).astype(np.float32)
        jx = jnp.asarray(x, jnp.bfloat16)
        wq, ws = j_q.fused_rmsnorm_quant(jx, jnp.asarray(g), interpret=True)
        tx = torch.from_numpy(x).bfloat16()
        np.testing.assert_array_equal(_np(tx), np.asarray(jx, np.float32))  # same bf16 inputs
        launches = dict(t_q.LAUNCHES)
        q, s = t_q.fused_rmsnorm_quant(tx, torch.from_numpy(g))
        assert t_q.LAUNCHES == launches  # the CPU runs the plain version
        assert q.shape == (b, n, c) and s.shape == (b, n, 1)
        assert_codes_close(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)

    @pytest.mark.parametrize("b,n,f,padded", [(2, 64, 136, False), (2, 64, 136, True), (1, 200, 256, False)])
    def test_silu_quant(self, b, n, f, padded):
        rng = np.random.default_rng(5)
        v = rng.standard_normal((b, n, f)).astype(np.float32)
        g = (2 * rng.standard_normal((b, n, f))).astype(np.float32)
        fp = t_q.pad_ffn_dim(f) if padded else f
        hid = np.zeros((b, n, 2 * fp), np.float32)
        hid[..., :f], hid[..., fp:fp + f] = v, g
        jh = jnp.asarray(hid, jnp.bfloat16)
        wq, ws = j_q.fused_silu_quant(jh, interpret=True)
        q, s = t_q.fused_silu_quant(torch.from_numpy(hid).bfloat16())
        assert q.shape == (b, n, fp) and s.shape == (b, n, 1)
        assert_codes_close(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
        assert not q.numpy()[..., f:].any()  # pad columns quantize to exactly 0

    @pytest.mark.parametrize("m,c,f", [(32, 256, 136), (24, 128, 128), (200, 128, 136)])
    def test_ffn_int8(self, m, c, f):
        """F not a multiple of 128 (padded), several row tiles, and M = 200,
        a multiple of 8 that leaves the CUDA kernel's 128-row tile ragged."""
        rng = np.random.default_rng(6)
        x = rng.standard_normal((m, c)).astype(np.float32)
        w = (0.05 * rng.standard_normal((c, 2 * f))).astype(np.float32)  # JAX [C, 2F]
        hq, hs = j_q.quantize_activation(jnp.asarray(x, jnp.bfloat16))
        fc1 = j_q.quantize_weight(j_q.pad_fc1_kernel(jnp.asarray(w)))
        wq, ws = j_q.fused_ffn_int8(hq, hs, fc1, interpret=True)
        w_int8 = torch.from_numpy(np.asarray(fc1["kernel_int8"]).T.copy())
        w_scale = torch.from_numpy(np.array(fc1["scale"]))
        assert t_q.can_fuse_ffn(m, c, w_int8.shape[0])
        q, s = t_q.fused_ffn_int8(torch.from_numpy(np.array(hq)), torch.from_numpy(np.array(hs)),
                                  w_int8, w_scale)
        fp = t_q.pad_ffn_dim(f)
        assert q.shape == (m, fp) and s.shape == (m, 1)
        assert_codes_close(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)
        assert not q.numpy()[:, f:].any()  # pad columns quantize to exactly 0


# ---------------------------------------------------------------------------
# Weights across: the port's quantize against quantize_block_params
# ---------------------------------------------------------------------------

SMALL = "w128_d1_h2-w128_d2_h2/1x16x8"


def _port(cfg, state, dtype=torch.float32, attn_impl=None):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
    if attn_impl is not None:
        kw["attn_impl"] = attn_impl
    return t_ae.AE(state_dict=state, compute_dtype=dtype, device="cpu", **kw)


def _int8_entries(state):
    return {k: v for k, v in state.items() if k.endswith((".weight_int8", ".scale"))}


class TestWeightsAcross:
    def test_quantize_matches_quantize_block_params_fp32(self):
        cfg = j_ae.AEConfig.from_variant(SMALL)
        params = jax_params(cfg)
        model = _port(cfg, from_jax_params(params, cfg)).quantize()
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(params)), cfg)
        got = model.state_dict()
        assert set(got) == set(want)
        assert len(_int8_entries(want)) == 2 * 4 * (cfg.encoder_depth + cfg.decoder_depth)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), w.numpy(), err_msg=key)
        # The quantized pytree loads into an int8 model directly.
        loaded = _port(cfg, want).state_dict()
        for key, w in want.items():
            np.testing.assert_array_equal(loaded[key].numpy(), w.numpy(), err_msg=key)

    def test_bf16_codes_match_for_bf16_representable_weights(self):
        """The port quantizes the weights it holds, rounded to bf16 in a bf16
        model; weights that bf16 represents exactly give the same codes."""
        cfg = j_ae.AEConfig.from_variant(SMALL)
        params = jax_params(cfg)
        rounded = jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32), params)
        model = _port(cfg, from_jax_params(rounded, cfg), dtype=torch.bfloat16).quantize()
        want = _int8_entries(from_jax_params(
            jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(rounded)), cfg))
        got = model.state_dict()
        for key, w in want.items():
            np.testing.assert_array_equal(got[key].numpy(), w.numpy(), err_msg=key)

    def test_bf16_model_from_the_quantized_fp32_state_has_fp32_codes(self):
        """For int8 serving of fp32 checkpoints in a bf16 model, quantize the
        fp32 state dict first (``quantize_state_dict``): its codes are
        ``quantize_block_params``' bit for bit, on weights bf16 cannot
        represent, where ``quantize()`` on the bf16-held model quantizes the
        bf16-rounded weights."""
        cfg = j_ae.AEConfig.from_variant(SMALL)
        params = jax_params(cfg)
        fp32_sd = from_jax_params(params, cfg)
        linears = {k: w for k, w in fp32_sd.items() if k.endswith("proj.weight") or ".mlp.fc" in k}
        assert linears and all(not torch.equal(w, w.bfloat16().float()) for w in linears.values())
        want = _int8_entries(from_jax_params(
            jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(params)), cfg))
        got = _port(cfg, t_q.quantize_state_dict(fp32_sd), dtype=torch.bfloat16).state_dict()
        assert set(want) <= set(got)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key].numpy(), w.numpy(), err_msg=key)
        held = _port(cfg, fp32_sd, dtype=torch.bfloat16).quantize().state_dict()
        assert any(not torch.equal(held[k], w) for k, w in want.items() if k.endswith(".weight_int8"))

    def test_quantize_is_idempotent_and_replaces_the_block_linears(self):
        cfg = j_ae.AEConfig.from_variant(SMALL)
        model = _port(cfg, from_jax_params(jax_params(cfg), cfg))
        assert not t_q.is_quantized(model)
        full = model.state_dict()
        assert model.quantize() is model
        first = {k: v.clone() for k, v in model.state_dict().items()}
        model.quantize()
        assert t_q.is_quantized(model) and t_q.is_quantized(first)
        for key, v in model.state_dict().items():
            assert torch.equal(v, first[key]), key
        assert not any(k.startswith(("encoder_blocks", "decoder_blocks")) and k.endswith("proj.weight")
                       for k in first)
        assert "patch_embed.weight" in first and "to_pixels.weight" in first  # embeds and heads stay
        # The state-dict form (quantize_block_params' counterpart) agrees.
        via_state = t_q.quantize_state_dict(full)
        assert set(via_state) == set(first)
        for key, v in via_state.items():
            assert torch.equal(v, first[key]), key
        assert t_q.quantize_state_dict(via_state).keys() == via_state.keys()


# ---------------------------------------------------------------------------
# The slice as a whole: the int8 model against the JAX int8 model
# ---------------------------------------------------------------------------

INT8_CONFIGS = {  # name: (variant, tokens, per-sample grids), 2 samples
    "ffn": ("w128_d1_h2-w128_d2_h2/1x16x8", 32, [(4, 6), (3, 5)]),      # rmsnorm_quant + ffn_int8
    "silu": ("w192_d1_h3-w192_d2_h3/1x16x8", 32, [(4, 6), (3, 5)]),     # rmsnorm_quant + silu_quant
    "unfused": ("w128_d1_h2-w128_d2_h2/1x16x8", 30, [(5, 6), (3, 3)]),  # n % 8 != 0
}


@contextlib.contextmanager
def jax_tpu_routing():
    """The JAX package's int8 block as it is routed on the TPU, on the CPU:
    the backend check of the gate lifted, the Pallas kernels interpreted."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(j_q, "can_fuse_silu_quant", lambda n: n % 8 == 0))
        for name in ("fused_rmsnorm_quant", "fused_ffn_int8", "fused_silu_quant"):
            fn = getattr(j_q, name)
            stack.enter_context(mock.patch.object(j_q, name, functools.partial(fn, interpret=True)))
        yield


@functools.lru_cache(maxsize=None)
def jax_int8_reference(name, sw):
    """(cfg, quantized params, batch, z, decode(z) patches) of the JAX int8 model at fp32."""
    variant, n, grids = INT8_CONFIGS[name]
    cfg = j_ae.AEConfig.from_variant(variant, sw=sw)
    qparams = jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(jax_params(cfg)))
    batch = make_batch(len(grids), n, 16, grids)
    jp = jax.tree_util.tree_map(jnp.asarray, qparams)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax_tpu_routing():
        enc = j_ae.encode_apply(jp, jb, cfg, compute_dtype=jnp.float32)
        dec = j_ae.decode_apply(jp, enc, cfg, compute_dtype=jnp.float32)
    return cfg, qparams, batch, np.asarray(enc["z"]), np.asarray(dec["patches"])


class TestInt8Model:
    @pytest.mark.parametrize("name", list(INT8_CONFIGS))
    @pytest.mark.parametrize("sw", [None, 3])
    def test_matches_jax_int8_model(self, name, sw):
        cfg, qparams, batch, z_want, p_want = jax_int8_reference(name, sw)
        model = _port(cfg, from_jax_params(qparams, cfg))
        assert t_q.is_quantized(model)
        valid = batch["patch_mask"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        z = model.encode(tb)["z"].numpy()
        assert rel_l2(z[valid], z_want[valid]) <= MODEL_REL_L2
        patches = model.decode({**tb, "z": torch.from_numpy(z_want)})["patches"].numpy()
        assert rel_l2(patches[valid], p_want[valid]) <= MODEL_REL_L2

    @pytest.mark.parametrize("name,expect", [
        ("ffn", {"rmsnorm_quant": 3, "ffn_int8": 3, "silu_quant": 0}),
        ("silu", {"rmsnorm_quant": 3, "ffn_int8": 0, "silu_quant": 3}),
        ("unfused", {"rmsnorm_quant": 0, "ffn_int8": 0, "silu_quant": 0}),
    ])
    def test_blocks_take_the_jax_route(self, monkeypatch, name, expect):
        """Each block takes the branch the JAX gate takes; on the CPU the
        wrappers run their plain versions and launch nothing."""
        variant, n, grids = INT8_CONFIGS[name]
        cfg = t_ae.AEConfig.from_variant(variant)
        c, f2 = cfg.decoder_width, 2 * t_q.pad_ffn_dim(cfg.decoder_ffn_dim)
        assert j_q._ffn_shapes_fusable(len(grids) * n, c, f2) == (expect["ffn_int8"] > 0)
        calls = {k: 0 for k in expect}
        for k in expect:
            fn = getattr(t_q, f"fused_{k}")
            monkeypatch.setattr(t_q, f"fused_{k}",
                                lambda *a, _k=k, _fn=fn: calls.__setitem__(_k, calls[_k] + 1) or _fn(*a))
        model = t_ae.AE(**dataclasses.asdict(cfg), compute_dtype=torch.float32, device="cpu").quantize()
        launches = dict(t_q.LAUNCHES)
        out = model({k: torch.from_numpy(v) for k, v in make_batch(len(grids), n, 16, grids).items()})
        assert calls == expect
        assert t_q.LAUNCHES == launches
        assert torch.isfinite(out["patches"]).all()

    def test_bf16_int8_forward_on_cpu(self):
        cfg = t_ae.AEConfig.from_variant(SMALL)
        model = t_ae.AE(**dataclasses.asdict(cfg), device="cpu").quantize()
        out = model({k: torch.from_numpy(v) for k, v in make_batch(2, 16, 16, [(4, 4), (2, 3)]).items()})
        assert out["patches"].dtype == torch.bfloat16
        assert torch.isfinite(out["patches"].float()).all()


# ---------------------------------------------------------------------------
# Quality gate and its negative control (tests/test_quant.py::TestQuantQuality)
# ---------------------------------------------------------------------------

GATE_VARIANT = "w128_d2_h2-w128_d4_h2/1x16x16"


@functools.lru_cache(maxsize=None)
def gate_setup():
    """fp32 state (LayerScale gains ~ U(0.5, 1.5)), the batch, fp32 images."""
    cfg = j_ae.AEConfig.from_variant(GATE_VARIANT, attn_impl="xla")
    params = jax.tree_util.tree_map(np.asarray, j_ae.init_params(cfg, jax.random.key(0)))
    state = t_q.gate_sensitive_params(from_jax_params(params, cfg), seed=0)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in dense_batch(b=2, n=64, grid=(8, 8), seed=3).items()}
    return cfg, state, batch, _images(_port(cfg, state), batch)


def _images(model, batch):
    return unpatchify(model(batch), patch=16).numpy()


def _ssim(a, b):
    lo, hi = min(a.min(), b.min()), max(a.max(), b.max())
    return min(compute_ssim(jnp.asarray(x), jnp.asarray(y), data_range=max(hi - lo, 1e-6))
               for x, y in zip(a, b))


class TestQuality:
    def test_ssim_gate(self):
        cfg, state, batch, full = gate_setup()
        quant = _images(_port(cfg, state).quantize(), batch)
        assert np.isfinite(quant).all()
        s = _ssim(full, quant)
        assert 0.99 <= s < 1.0 - 1e-9, s  # passes, and is not vacuous

    def test_ssim_gate_negative_control(self):
        cfg, state, batch, full = gate_setup()
        bad = _images(_port(cfg, t_q.degrade_block_weights(state, bits=4)), batch)
        s = _ssim(full, bad)
        assert s < 0.99, f"gate failed to trip on 4-bit weights: SSIM {s}"

    def test_gate_sensitive_params_only_touches_gamma(self):
        _, state, _, _ = gate_setup()
        again = t_q.gate_sensitive_params(state, seed=7, lo=0.5, hi=1.5)
        for key, v in state.items():
            if key.endswith("layer_scale.gamma"):
                assert (again[key] >= 0.5).all() and (again[key] <= 1.5).all()
                assert not torch.equal(again[key], v)
            else:
                assert again[key] is v, key

    def test_degrade_touches_only_block_linears(self):
        _, state, _, _ = gate_setup()
        bad = t_q.degrade_block_weights(state, bits=4)
        changed = {k for k in state if not torch.equal(bad[k], state[k])}
        assert changed and all(k.endswith(("proj.weight", "fc1.weight", "fc2.weight")) and
                               k.startswith(("encoder_blocks", "decoder_blocks")) for k in changed)
        w = bad["decoder_blocks.0.ffn.fc1.weight"]
        levels = (w / (w.abs().amax(-1, keepdim=True) / 7)).round()
        assert levels.abs().max() <= 7 and torch.unique(levels).numel() <= 15
