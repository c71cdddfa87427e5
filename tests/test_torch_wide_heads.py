"""Head dims 192 and 256 on the serving and training kernels, on the CPU.

The plain q/k norm's statistics (``_rms_inv``, the kernels' order of the
sum of squares: at d = 192 the 12 piece sums padded with zeros to the row's
16 lanes, then added pairwise) against ``mean`` at every head dim that is a
multiple of 64 up to 512, and its backward (``_norm_rope_bwd``, what
``norm_rope_bwd_tile`` computes) against float64 autograd of the forward at
d 192 and 256. The plain versions of the int8-epilogue forward (#2) against
the JAX Pallas kernel interpreted, and of the fold (the q/k prologue, then
#4) against the JAX composition on its flash route (Pallas interpreted), at
d 192 and 256. Small autoencoders at head dims 192 and 256 through both
packages, the JAX parameters carried across by ``from_jax_params``: fp32
within 1e-4, int8 within rel L2 1e-3; and one fp32 training step at each
head dim through the fused attention's autograd Function (#3's plain
versions) against ``jax.grad``, the parameters carried by the JAX package's
``pytree_to_torch_state``: gradients within rel L2 1e-4.

Then the routing on the card at these head dims, on tensors that say they
lie there (a ``Tensor`` subclass whose ``is_cuda`` is True) with the CUDA
libraries replaced by recorders of their C entry points: a bf16 forward
reaches the d 192/256 instances (the prologue, #1, #2 in its cluster, #4
after the prologue), and a bf16 call under grad the backward's (the prologue
with delta, then #3, or #5/#6's fold instances); an fp32 call without a
gradient reaches the fp32 forward's (the fp32 walker, the walker then the
row quantize for #2, the fold's fp32 prologue then #4's fp32 instance),
counted under their fp32 names, and under grad the fp32 backward's (the
walker's lse instance, then the fp32 prologue with delta and #3's entry, or
the fold, then the prologue with delta and #5/#6's fold instances); under
grad with ``"auto"`` below 2048 tokens the unfused composition runs and
launches nothing, and a forced kernel at a head dim past 256, in fp16, or
an A/B kernel raises before a launch; an AE training step at d 256 launches
#1 and #3 in every block, and in fp32 at d 192 and 256 the walker's lse
instance, the fp32 prologue with delta and #3's fp32 entries. The fp32
prologue's plain version is held to the JAX package's ``_norm_rope_half``,
and its delta to sum dO * O in float64, at d 192 and 256. The kernels
themselves are
held to their plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import contextlib
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu import train_lib as j_tl
from vitok_tpu.models import ae as j_ae
from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops import quant as j_q
from vitok_tpu.utils.params_io import pytree_to_torch_state
from vitok_torch import train_lib as t_tl
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import _build
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops import quant as t_q
from vitok_torch.utils.params_io import from_jax_params, released_state_to_module_state, to_jax_params

from tests.test_torch_ae import jax_params, make_batch
from tests.test_torch_flash_fold import make_inputs as fold_inputs
from tests.test_torch_fused_bwd import make_case
from tests.test_torch_fused_q8 import check as check_q8
from tests.test_torch_quant import jax_tpu_routing, rel_l2
from tests.test_torch_train_lib import assert_trees_close, jax_tile_indices, port_grads

torch.set_num_threads(1)

ATOL = 2e-5        # attention, fp32
MODEL_ATOL = 1e-4  # an fp32 model, 3 blocks
MODEL_REL_L2 = 1e-3  # an int8 model (tests/test_torch_quant.py)
SMS = 132  # an H100 SXM's SMs


class TestRmsInv:
    @pytest.mark.parametrize("d", range(64, 513, 64))
    def test_matches_mean(self, d):
        x = torch.from_numpy(np.random.default_rng(d).standard_normal((3, 5, d)).astype(np.float32) * 3)
        got = t_fa._rms_inv(x)
        want = torch.rsqrt(x.double().square().mean(-1, keepdim=True) + 1e-6).float()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0)


class TestNormRopeBackward:
    @pytest.mark.parametrize("d", [192, 256])
    def test_matches_autograd_of_the_forward(self, d):
        """``_norm_rope_bwd`` (what ``norm_rope_bwd_tile`` computes: the
        rotation's transpose, then the RMSNorm backward on the raw rows) at
        d = 192, where a row's 12 pieces sum over 16 lanes, and at 256,
        against float64 autograd of the forward it inverts: ``_rms_inv``'s
        statistics in the kernels' order, the gain, the rotate-half rotation
        with the tables rounded to bf16. rtol 1e-5 of each gradient's
        largest entry."""
        rng = np.random.default_rng(d)
        t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x, dz, scale = t(2, 24, 3, d) * 2, t(2, 24, 3, d), 1 + 0.1 * t(d)
        ang = t(2, 24, 1, d // 2) * 3
        cos32, sin32 = ang.cos().bfloat16().float(), ang.sin().bfloat16().float()
        dx, dscale = t_fa._norm_rope_bwd(dz, x, t_fa._rms_inv(x), scale, cos32, sin32)
        x64, s64 = x.double().requires_grad_(), scale.double().requires_grad_()
        y = x64 * t_fa._rms_inv(x64) * s64
        yr, yi = y[..., : d // 2], y[..., d // 2:]
        c64, n64 = cos32.double(), sin32.double()
        rot = torch.cat([yr * c64 - yi * n64, yr * n64 + yi * c64], dim=-1)
        want_dx, want_ds = torch.autograd.grad(rot, (x64, s64), dz.double())
        for got, want in ((dx, want_dx), (dscale, want_ds)):
            assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()


class TestPlainAgainstJax:
    @pytest.mark.parametrize("d,heads", [(192, 4), (256, 2)])
    @pytest.mark.parametrize("sw", [None, 5])
    def test_q8_plain_matches_pallas_kernel_interpret(self, d, heads, sw):
        check_q8(make_case(b=2, n=32, heads=heads, d=d, valid=[32, 19]), heads, sw=sw)

    @pytest.mark.parametrize("d,masked,sw", [(192, True, None), (256, True, 40)])
    def test_plain_fold_matches_unfused_on_the_flash_route(self, d, masked, sw):
        qkv, qs, ks, cos, sin, mask = fold_inputs(3, 136, 2, d, masked)
        t = lambda a: None if a is None else torch.from_numpy(a)
        got = t_fa.flash_qkv_attention_plain(t(qkv), t(qs), t(ks), t(cos), t(sin), t(mask), num_heads=2,
                                             sliding_window=sw)
        j = lambda a: None if a is None else jnp.asarray(a)
        want = j_fa.unfused_qkv_attention(j(qkv), j(qs), j(ks), j(cos), j(sin), j(mask), 2, sw, attn_impl="pallas")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
        assert not got.numpy()[~mask].any()

    @pytest.mark.parametrize("d", [192, 256])
    def test_fp32_prologue_plain_matches_norm_rope_half(self, d):
        """The fp32 q/k prologue's plain version (q, then k, normed and
        rotated in fp32; at d = 192 the sum of squares over 16 lanes, 12 of
        them live) against the JAX package's ``_norm_rope_half`` on f32, one
        row a (sample, token, head): 1e-5."""
        qkv, qs, ks, cos, sin, _ = fold_inputs(2, 24, 2, d, False)
        b, n, c3 = qkv.shape
        c = c3 // 3
        t = torch.from_numpy
        qk, _ = t_fa.fused_qk_prologue_plain(t(qkv), t(qs), t(ks), t(cos), t(sin), num_heads=2)
        assert qk.dtype == torch.float32 and qk.shape == (b, n, 2 * c)
        rows = lambda a: jnp.asarray(np.repeat(a[:, :, None], 2, 2).reshape(b * n * 2, -1))
        want = np.concatenate([
            np.asarray(j_fa._norm_rope_half(jnp.asarray(qkv[..., part * c:(part + 1) * c].reshape(-1, d)),
                                            jnp.asarray(scale)[None], rows(cos), rows(sin))).reshape(b, n, c)
            for part, scale in ((0, qs), (1, ks))], axis=-1)
        np.testing.assert_allclose(qk.numpy(), want, atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("d", [192, 256])
    def test_fp32_prologue_plain_delta_is_the_rows_sum(self, d):
        """The fp32 prologue's plain delta (the backward's: each row's sum
        over a head's channels of dO * O) against that sum in float64:
        1e-5 of the largest entry."""
        qkv, qs, ks, cos, sin, _ = fold_inputs(2, 24, 2, d, False)
        b, n, c3 = qkv.shape
        rng = np.random.default_rng(d)
        out, dout = (rng.standard_normal((b, n, c3 // 3), dtype=np.float32) for _ in range(2))
        t = torch.from_numpy
        _, delta = t_fa.fused_qk_prologue_plain(t(qkv), t(qs), t(ks), t(cos), t(sin), num_heads=2, out=t(out),
                                                dout=t(dout))
        want = (out.astype(np.float64) * dout).reshape(b, n, 2, d).sum(-1).transpose(0, 2, 1)
        assert delta.dtype == torch.float32 and delta.shape == (b, 2, n)
        np.testing.assert_allclose(delta.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


SMALL_AE = {  # name: (variant, tokens, per-sample grids)
    "d192": ("w384_d1_h2-w384_d2_h2/1x16x8", 32, [(5, 6), (4, 4)]),
    "d256": ("w512_d1_h2-w512_d2_h2/1x16x8", 32, [(5, 6), (3, 3)]),
}


@functools.lru_cache(maxsize=None)
def small_params(name):
    """``jax_params`` of the small AE ``name`` (its JAX init runs op by op,
    seconds a call): once per module, shared by every test of the model."""
    return jax_params(j_ae.AEConfig.from_variant(SMALL_AE[name][0]))


@functools.lru_cache(maxsize=None)
def jax_model(name, sw, int8):
    """(cfg, params, batch, z, decode(z) patches) of the JAX model at fp32;
    ``int8``: its blocks quantized (``quantize_block_params``), the Pallas
    kernels interpreted as they are routed on the TPU."""
    variant, n, grids = SMALL_AE[name]
    cfg = j_ae.AEConfig.from_variant(variant, sw=sw)
    params = small_params(name)
    if int8:
        params = jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(params))
    batch = make_batch(len(grids), n, 16, grids)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax_tpu_routing() if int8 else contextlib.nullcontext():
        enc = j_ae.encode_apply(jp, jb, cfg, compute_dtype=jnp.float32)
        dec = j_ae.decode_apply(jp, enc, cfg, compute_dtype=jnp.float32)
    return cfg, params, batch, np.asarray(enc["z"]), np.asarray(dec["patches"])


def port_model(cfg, params):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
    return t_ae.AE(state_dict=from_jax_params(params, cfg), compute_dtype=torch.float32, device="cpu", **kw)


class TestSmallModels:
    @pytest.mark.parametrize("name,sw", [("d192", None), ("d256", 3)])
    def test_fp32_matches_jax(self, name, sw):
        cfg, params, batch, z_want, p_want = jax_model(name, sw, False)
        assert cfg.encoder_width // cfg.encoder_heads == int(name[1:])
        model = port_model(cfg, params)
        valid = batch["patch_mask"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        np.testing.assert_allclose(model.encode(tb)["z"].numpy()[valid], z_want[valid], atol=MODEL_ATOL, rtol=0)
        dec = model.decode({**tb, "z": torch.from_numpy(z_want)})["patches"].numpy()
        np.testing.assert_allclose(dec[valid], p_want[valid], atol=MODEL_ATOL, rtol=0)

    @pytest.mark.parametrize("name", list(SMALL_AE))
    def test_int8_matches_jax(self, name):
        cfg, qparams, batch, z_want, p_want = jax_model(name, None, True)
        model = port_model(cfg, qparams)
        valid = batch["patch_mask"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        assert rel_l2(model.encode(tb)["z"].numpy()[valid], z_want[valid]) <= MODEL_REL_L2
        dec = model.decode({**tb, "z": torch.from_numpy(z_want)})["patches"].numpy()
        assert rel_l2(dec[valid], p_want[valid]) <= MODEL_REL_L2


class TestTrainingStep:
    @pytest.mark.parametrize("name", list(SMALL_AE))
    def test_gradients_match_jax_grad(self, name):
        """One fp32 training step's loss (Charbonnier + SSIM) and parameter
        gradients at head dims 192 and 256, the JAX parameters carried across
        by ``pytree_to_torch_state`` (the released layout) and
        ``released_state_to_module_state``: ``attn_impl="fused"`` trains
        through the fused attention's autograd Function (#3's plain forward
        and backward on the CPU), against ``jax.grad`` of the JAX package's
        loss. Loss 1e-5, every gradient rel L2 1e-4."""
        variant, n, grids = SMALL_AE[name]
        cfg = j_ae.AEConfig.from_variant(variant)
        params = small_params(name)
        batch = make_batch(len(grids), n, 16, grids)
        loss = dict(ssim_weight=0.1, tile_size=32, n_tiles=1, patch=16, ssim_grid=(4, 8))
        rng = jax.random.key(23)
        grad_fn = jax.jit(jax.value_and_grad(j_tl.compute_loss, has_aux=True), static_argnums=(2, 3, 5, 6))
        (want, _), want_g = grad_fn(jax.tree_util.tree_map(jnp.asarray, params),
                                    {k: jnp.asarray(v) for k, v in batch.items()}, cfg, j_tl.LossConfig(**loss), rng,
                                    None, jnp.float32)
        state = released_state_to_module_state(pytree_to_torch_state(params))
        kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
        model = t_ae.AE(**{**kw, "attn_impl": "fused"}, state_dict=state, compute_dtype=torch.float32,
                        device="cpu", param_dtype=torch.float32, trainable=True)
        calls = []
        bwd = t_fa.fused_qkv_attention_bwd_plain
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_fa, "fused_qkv_attention_bwd_plain", lambda *a, **k: calls.append(1) or bwd(*a, **k))
            got, _, grads = port_grads(model, batch, t_tl.LossConfig(**loss),
                                       tile_indices=jax_tile_indices(batch, j_tl.LossConfig(**loss), rng))
        assert len(calls) == cfg.encoder_depth + cfg.decoder_depth
        assert abs(got - float(want)) <= 1e-5
        assert_trees_close(to_jax_params(grads), want_g, 1e-4, "grad")


# ---------------------------------------------------------------------------
# Routing on the card
# ---------------------------------------------------------------------------


class Card(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the wrappers read."""

    @property
    def is_cuda(self):
        return True


def card(t):
    return t.as_subclass(Card)


@pytest.fixture
def entries(monkeypatch):
    """Every CUDA library a recorder of its C entry points (each returns 0);
    returns the (entry, arguments) calls made, in order. The launch counts
    start at 0."""
    calls = []

    class Lib:
        def __getattr__(self, fn):
            if not fn.startswith("vitok_"):
                raise AttributeError(fn)
            entry = lambda *args: calls.append((fn, args)) or 0
            entry.argtypes = entry.restype = None
            setattr(self, fn, entry)
            return entry

    libs = {}
    monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(name, Lib()))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(t_fa, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(t_fa, "_quantize_rows_blocks", lambda c, dev: 4)
    monkeypatch.setattr(t_q, "_FNS", {})
    for name in ("LAUNCHES", "PROLOGUE_LAUNCHES", "Q8_LAUNCHES", "BWD_LAUNCHES", "F32_LAUNCHES",
                 "PROLOGUE_F32_LAUNCHES", "Q8_F32_LAUNCHES", "F32_LSE_LAUNCHES", "BWD_F32_LAUNCHES"):
        monkeypatch.setattr(t_fa, name, 0)
    for name in ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES", "F32_LAUNCHES", "DQ_F32_LAUNCHES", "DKV_F32_LAUNCHES"):
        monkeypatch.setattr(t_fl, name, 0)
    return calls


def qkv_inputs(b, n, heads, d, dtype=torch.bfloat16, masked=True):
    """Card-posing flat qkv, gains, 2D RoPE tables and a tail mask."""
    qkv, qs, ks, cos, sin, mask = fold_inputs(b, n, heads, d, masked)
    t = lambda a: None if a is None else torch.from_numpy(a)
    return card(t(qkv).to(dtype)), t(qs), t(ks), t(cos), t(sin), t(mask)


def names(calls):
    return [fn for fn, _ in calls]


def launches():
    return dict(fa=t_fa.LAUNCHES, prologue=t_fa.PROLOGUE_LAUNCHES, q8=t_fa.Q8_LAUNCHES, bwd=t_fa.BWD_LAUNCHES,
                fl=t_fl.LAUNCHES, dq=t_fl.DQ_LAUNCHES, dkv=t_fl.DKV_LAUNCHES, fa_f32=t_fa.F32_LAUNCHES,
                prologue_f32=t_fa.PROLOGUE_F32_LAUNCHES, q8_f32=t_fa.Q8_F32_LAUNCHES, fl_f32=t_fl.F32_LAUNCHES,
                fa_f32_lse=t_fa.F32_LSE_LAUNCHES, bwd_f32=t_fa.BWD_F32_LAUNCHES, dq_f32=t_fl.DQ_F32_LAUNCHES,
                dkv_f32=t_fl.DKV_F32_LAUNCHES)


def only(**named):
    return {k: named.get(k, 0) for k in launches()}


@pytest.mark.parametrize("d", [192, 256])
class TestCardRouting:
    def test_bf16_forward_reaches_the_wide_instances(self, entries, d):
        args = qkv_inputs(2, 256, 2, d)
        out = t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=40)
        assert out.shape == (2, 256, 2 * d)
        assert names(entries) == ["vitok_fused_qk_prologue_bf16", "vitok_fused_attention_sm90_bf16"]
        (_, prologue), (_, attention) = entries
        assert prologue[9:14] == (2, 256, 2, d, 1)  # B, N, H, D, parts (k alone)
        assert attention[8:13] == (2, 256, 2, d, 40)  # B, N, H, D, window
        assert launches() == only(fa=1, prologue=1)

    def test_q8_reaches_its_cluster(self, entries, d, monkeypatch):
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        heads = 3072 // d
        assert t_fa.can_fuse_q8(256, 3072, heads, cuda=True)
        codes, scales = t_fa.fused_qkv_attention_q8(*qkv_inputs(1, 64, heads, d), num_heads=heads)
        assert codes.dtype == torch.int8 and scales.shape == (1, 64, 1)
        assert names(entries) == ["vitok_fused_qk_prologue_bf16", "vitok_fused_attention_q8_sm90_bf16"]
        # B, N, H, D, cluster, window: two heads of 256 a block (a cluster of 6), four of 192 (4)
        assert entries[1][1][8:14] == (1, 64, heads, d, {192: 4, 256: 6}[d], -1)
        assert launches() == only(q8=1, prologue=1)

    def test_fold_reaches_the_wide_instances(self, entries, d):
        args = qkv_inputs(1, 2048, 1, d)
        assert t_fa.takes_flash_fold(args[0], args[1], args[2], 1, "auto")
        out = t_fa.fused_qkv_attention(*args, num_heads=1, sliding_window=300)
        assert out.shape == (1, 2048, d)
        assert names(entries) == ["vitok_fused_qk_prologue_bf16", "vitok_flash_attention_bf16"]
        (_, prologue), (_, flash) = entries
        assert prologue[9:14] == (1, 2048, 1, d, 2)  # q and k
        assert flash[16:21] == (1, 2048, 1, d, 300)
        assert launches() == only(fl=1, prologue=1)

    def test_fp32_forward_reaches_the_wide_walker(self, entries, d):
        """fp32 without a gradient, ``"auto"`` and ``"fused"``, at 1024
        tokens with a tail mask: the fp32 walker's forward at the split
        ``f32_walk_split`` picks, counted under ``F32_LAUNCHES``."""
        heads = 3072 // d
        args = qkv_inputs(2, 1024, heads, d, dtype=torch.float32)
        assert t_fa.can_fuse(1024, 3072, heads, cuda=True, dtype=torch.float32)
        assert t_fa.can_fuse(1024, 3072, heads, cuda=True, dtype=torch.float32, grad=True)
        for impl in ("auto", "fused"):
            out = t_fa.fused_qkv_attention(*args, num_heads=heads, impl=impl)
            assert out.shape == (2, 1024, 3072) and out.dtype == torch.float32
        bb, hpb = t_fa.f32_walk_split(2, 1024, heads, d, SMS)
        assert names(entries) == ["vitok_fused_attention_walk_f32"] * 2
        for _, walk in entries:
            assert walk[5] is not None and walk[7] is None  # the mask; no lse
            assert walk[8:] == (2, 1024, heads, d, bb, hpb, -1, t_fa.F32_WALK_KINDS.index("fwd"), 7)
        assert launches() == only(fa_f32=2)

    def test_fp32_q8_is_the_walker_then_the_row_quantize(self, entries, d, monkeypatch):
        """#2 on fp32 at the 5B width: the fp32 walker's forward, then the row
        quantize over the walker's output, one launch of each counted."""
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        heads = 3072 // d
        assert t_fa.can_fuse_q8(256, 3072, heads, cuda=True, dtype=torch.float32)
        codes, scales = t_fa.fused_qkv_attention_q8(*qkv_inputs(1, 64, heads, d, dtype=torch.float32),
                                                    num_heads=heads)
        assert codes.dtype == torch.int8 and codes.shape == (1, 64, 3072) and scales.shape == (1, 64, 1)
        assert names(entries) == ["vitok_fused_attention_walk_f32", "vitok_quantize_rows_f32"]
        (_, walk), (_, quant) = entries
        assert walk[8:12] == (1, 64, heads, d) and quant[0] == walk[6]  # the quantize reads the walker's output
        assert quant[1:5] == (codes.data_ptr(), scales.data_ptr(), 64, 3072)
        assert launches() == only(fa_f32=1, q8_f32=1)

    def test_fp32_fold_reaches_the_wide_instances(self, entries, d):
        """The fold on fp32 (``flash_qkv_attention``, a tail mask and a
        window): the fp32 prologue writes q and k, then #4's fp32 instance
        reads them as views of its scratch, v a view of qkv."""
        qkv, qs, ks, cos, sin, mask = qkv_inputs(2, 2048, 1, d, dtype=torch.float32)
        out = t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=1, sliding_window=1024)
        assert out.shape == (2, 2048, d) and out.dtype == torch.float32
        assert names(entries) == ["vitok_fused_qk_prologue_f32", "vitok_flash_attention_f32"]
        (_, pro), (_, flash) = entries
        assert pro[5:7] == (None, None) and pro[9:14] == (2, 2048, 1, d, 2)
        assert flash[0] == pro[7] and flash[1] == pro[7] + 4 * d  # q, k: views of the fp32 scratch
        assert flash[2] == qkv.data_ptr() + 4 * 2 * d and flash[12] is not None  # v, a view of qkv; the mask
        assert flash[16:21] == (2, 2048, 1, d, 1024)
        assert launches() == only(prologue_f32=1, fl_f32=1)

    def test_grad_and_fp32_keep_the_composition(self, entries, d):
        """Under grad (the name is kept from when such a call took the
        composition) a d 192/256 call reaches the backward's C entries, in
        bf16 and in fp32: at 256 tokens with ``impl="fused"`` #1 with its
        log-sum-exp (fp32: the walker's lse instance), then the prologue with
        delta and #3's entry (fp32: #5's and #6's fold instances at the
        walker's log2 lse, factor 1); at 2048 tokens the fold, then the
        prologue with delta and #5's and #6's fold instances (fp32: at #4's
        natural-log lse, factor log2(e)). An fp32 call without a gradient
        reaches the fp32 forward's entries (the walker at 256 tokens, the
        fp32 prologue and #4's fp32 instance at 2048); under grad with
        ``"auto"`` at 256 tokens it keeps the composition and launches
        nothing, forward or backward."""
        fold = ["vitok_fused_qk_prologue_bf16", "vitok_flash_attention_bf16", "vitok_fused_qk_prologue_bf16",
                "vitok_flash_bwd_dq_fold_bf16", "vitok_flash_bwd_dkv_fold_bf16"]
        fused = ["vitok_fused_qk_prologue_bf16", "vitok_fused_attention_sm90_bf16", "vitok_fused_qk_prologue_bf16",
                 "vitok_fused_attention_bwd_bf16"]
        fold32 = ["vitok_fused_qk_prologue_f32", "vitok_flash_attention_f32", "vitok_fused_qk_prologue_f32",
                  "vitok_flash_bwd_fold_f32", "vitok_flash_bwd_fold_f32"]
        fused32 = ["vitok_fused_attention_walk_f32", "vitok_fused_qk_prologue_f32", "vitok_flash_bwd_fold_f32",
                   "vitok_flash_bwd_fold_f32"]
        for dtype, n, impl, want in ((torch.bfloat16, 256, "fused", fused), (torch.bfloat16, 2048, "auto", fold),
                                     (torch.float32, 256, "fused", fused32), (torch.float32, 2048, "auto", fold32)):
            entries.clear()
            qkv, *rest = qkv_inputs(1, n, 2, d, dtype=dtype)
            qkv.requires_grad_()
            assert t_fa.takes_flash_fold(qkv, rest[0], rest[1], 2, "auto") is (n == 2048)
            out = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=40, impl=impl)
            out.as_subclass(torch.Tensor).float().sum().backward()
            assert qkv.grad is not None and names(entries) == want
            prologue = entries[len(want) - (2 if dtype == torch.bfloat16 and n == 256 else 3)][1]
            assert prologue[5] is not None and prologue[9:14] == (1, n, 2, d, 2)  # out given (delta); q and k
            assert entries[-1][1][-6:-1] == (1, n, 2, d, 40)  # B, N, H, D, window
            if dtype == torch.float32:  # dq's then dk/dv's fold instance, at the forward's lse units
                factor = 1.0 if n == 256 else t_fl.LOG2E
                assert [args[:2] for _, args in entries[-2:]] == [(0, factor), (1, factor)]
                if n == 256:
                    assert entries[0][1][7] is not None  # the walker's lse instance
        fp32 = {256: ["vitok_fused_attention_walk_f32"],
                2048: ["vitok_fused_qk_prologue_f32", "vitok_flash_attention_f32"]}
        for n in (256, 2048):
            entries.clear()
            args = qkv_inputs(1, n, 2, d, dtype=torch.float32)
            assert t_fa.takes_flash_fold(args[0], args[1], args[2], 2, "auto") is (n == 2048)
            t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=40)
            assert names(entries) == fp32[n]
            if n == 256:  # no lse; B, N, H, D; the window and the forward's kind
                walk = entries[0][1]
                assert walk[7] is None and walk[8:12] == (1, n, 2, d) and walk[14:16] == (40, 0)
            else:  # q and k, no delta; then #4 on their views with the window
                assert entries[0][1][5] is None and entries[0][1][9:14] == (1, n, 2, d, 2)
                assert entries[1][1][16:21] == (1, n, 2, d, 40)
        entries.clear()
        qkv, *rest = qkv_inputs(1, 256, 2, d, dtype=torch.float32)
        qkv.requires_grad_()
        out = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=40)
        out.as_subclass(torch.Tensor).sum().backward()
        assert qkv.grad is not None and entries == []
        assert launches() == only(fa=1, prologue=4, bwd=2, fl=1, dq=1, dkv=1, fa_f32=1, prologue_f32=4, fl_f32=2,
                                  fa_f32_lse=1, bwd_f32=2, dq_f32=1, dkv_f32=1)

    def test_forced_kernels_raise_before_a_launch(self, entries, d):
        """A forced kernel at a head dim no kernel has an instance for (d +
        128: 320 or 384) raises before a launch: fp32 under a gradient
        (``impl="fused"``, ``impl="flash"`` and the flash kernel) and the fp32
        prologue with delta; so do an fp16 call under a gradient and the kept
        mma.sync forward (``MMA_HEAD_DIMS``) at d. bf16 and fp32, with or
        without a gradient, no longer do at d (their instances reach 256),
        nor do the A/B kernels (``AB_HEAD_DIMS``)."""
        bad = d + 128
        for n, impl in ((256, "fused"), (2048, "flash")):
            qkv, *rest = qkv_inputs(1, n, 2, bad, dtype=torch.float32)
            qkv.requires_grad_()
            with pytest.raises(ValueError, match="head_dim"):
                t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, impl=impl)
        qkv, *rest = qkv_inputs(1, 256, 2, d, dtype=torch.float16)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_fa.fused_qkv_attention(qkv.requires_grad_(), *rest, num_heads=2, impl="fused")
        q = card(torch.zeros((1, 256, 2, bad), dtype=torch.float32, requires_grad=True))
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, q, q)
        g = card(torch.zeros((1, 64, 2 * bad), dtype=torch.float32))
        with pytest.raises(ValueError, match="head_dim"):  # delta: the backward's fp32 prologue
            t_fa.fused_qk_prologue(*qkv_inputs(1, 64, 2, bad, dtype=torch.float32)[:5], num_heads=2, out=g, dout=g)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention_mma(*qkv_inputs(1, 64, 2, d), num_heads=2)
        assert entries == [] and launches() == only()


def test_ae_training_step_at_d256_takes_the_composition(entries, monkeypatch):
    """A bf16 AE with 256-channel heads on the card (every tensor says it
    lies there; the name is kept from when its step took the composition):
    ``attn_impl="fused"`` trains on the fused kernels, so its step launches
    in every block #1 after the prologue forward and the prologue with delta
    and #3's dq and dk/dv kernels backward; the same model under
    ``no_grad`` takes the forward kernels in every block."""
    cfg = t_ae.AEConfig.from_variant("w512_d1_h2-w512_d1_h2/1x16x8")
    model = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "fused"}, param_dtype=torch.float32,
                    compute_dtype=torch.bfloat16, trainable=True, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2, 32, 16, [(5, 6), (3, 3)]).items()}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = model(batch, deterministic=False)
    out["patches"].float().square().mean().backward()
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
    depth = cfg.encoder_depth + cfg.decoder_depth
    assert launches() == only(fa=depth, prologue=2 * depth, bwd=2 * depth)
    assert set(names(entries)) == {"vitok_fused_qk_prologue_bf16", "vitok_fused_attention_sm90_bf16",
                                   "vitok_fused_attention_bwd_bf16"}
    with torch.no_grad():
        model.decode(model.encode(batch))
    assert launches() == only(fa=2 * depth, prologue=3 * depth, bwd=2 * depth)


@pytest.mark.parametrize("variant,d", [("w384_d1_h2-w384_d1_h2/1x16x8", 192), ("w512_d1_h2-w512_d1_h2/1x16x8", 256)])
def test_fp32_ae_training_step_takes_the_fp32_backward(entries, monkeypatch, variant, d):
    """An fp32 AE (compute and parameters) with heads of ``d`` on the card
    (every tensor says it lies there): ``attn_impl="fused"`` trains on the
    fp32 kernels, so its step launches in every block the fp32 walker's lse
    instance forward and the fp32 prologue with delta and #3's fp32 entries
    (the dq and dk/dv fold instances at the walker's log2 lse) backward; the
    same model under ``no_grad`` takes the walker's inference instance in
    every block."""
    cfg = t_ae.AEConfig.from_variant(variant)
    assert cfg.encoder_width // cfg.encoder_heads == d
    model = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "fused"}, param_dtype=torch.float32,
                    compute_dtype=torch.float32, trainable=True, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2, 32, 16, [(5, 6), (3, 3)]).items()}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = model(batch, deterministic=False)
    out["patches"].float().square().mean().backward()
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
    depth = cfg.encoder_depth + cfg.decoder_depth
    assert launches() == only(fa_f32_lse=depth, prologue_f32=depth, bwd_f32=2 * depth)
    assert names(entries) == ["vitok_fused_attention_walk_f32"] * depth + [
        "vitok_fused_qk_prologue_f32", "vitok_flash_bwd_fold_f32", "vitok_flash_bwd_fold_f32"] * depth
    walks = [args for fn, args in entries if fn == "vitok_fused_attention_walk_f32"]
    assert all(args[7] is not None and args[11] == d for args in walks)  # the lse instance at head dim d
    folds = [args for fn, args in entries if fn == "vitok_flash_bwd_fold_f32"]
    assert [args[:2] for args in folds] == [(0, 1.0), (1, 1.0)] * depth and all(args[17] == d for args in folds)
    with torch.no_grad():
        model.decode(model.encode(batch))
    assert launches() == only(fa_f32_lse=depth, fa_f32=depth, prologue_f32=depth, bwd_f32=2 * depth)
