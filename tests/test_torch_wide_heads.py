"""Head dims 192 and 256 on the serving kernels, on the CPU.

The plain q/k norm's statistics (``_rms_inv``, the kernels' order of the
sum of squares: at d = 192 the 12 piece sums padded with zeros to the row's
16 lanes, then added pairwise) against ``mean`` at every head dim that is a
multiple of 64 up to 512. The plain versions of the int8-epilogue forward
(#2) against the JAX Pallas kernel interpreted, and of the fold (the q/k
prologue, then #4) against the JAX composition on its flash route (Pallas
interpreted), at d 192 and 256. Small autoencoders at head dims 192 and 256
through both packages, the JAX parameters carried across by
``from_jax_params``: fp32 within 1e-4, int8 within rel L2 1e-3.

Then the routing on the card at these head dims, on tensors that say they
lie there (a ``Tensor`` subclass whose ``is_cuda`` is True) with the CUDA
libraries replaced by recorders of their C entry points: a bf16 forward
reaches the d 192/256 instances (the prologue, #1, #2 in its cluster, #4
after the prologue); a call under grad (the backward has no instance at
these head dims) and an fp32 call take the unfused composition and launch
nothing, and a forced kernel raises before a launch; an AE training step at
d 256 takes the composition. The kernels themselves are held to their plain
versions on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
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

from vitok_tpu.models import ae as j_ae
from vitok_tpu.ops import fused_attention as j_fa
from vitok_tpu.ops import quant as j_q
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import _build
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.utils.params_io import from_jax_params

from tests.test_torch_ae import jax_params, make_batch
from tests.test_torch_flash_fold import make_inputs as fold_inputs
from tests.test_torch_fused_bwd import make_case
from tests.test_torch_fused_q8 import check as check_q8
from tests.test_torch_quant import jax_tpu_routing, rel_l2

torch.set_num_threads(1)

ATOL = 2e-5        # attention, fp32
MODEL_ATOL = 1e-4  # an fp32 model, 3 blocks
MODEL_REL_L2 = 1e-3  # an int8 model (tests/test_torch_quant.py)


class TestRmsInv:
    @pytest.mark.parametrize("d", range(64, 513, 64))
    def test_matches_mean(self, d):
        x = torch.from_numpy(np.random.default_rng(d).standard_normal((3, 5, d)).astype(np.float32) * 3)
        got = t_fa._rms_inv(x)
        want = torch.rsqrt(x.double().square().mean(-1, keepdim=True) + 1e-6).float()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=0)


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


SMALL_AE = {  # name: (variant, tokens, per-sample grids)
    "d192": ("w384_d1_h2-w384_d2_h2/1x16x8", 32, [(5, 6), (4, 4)]),
    "d256": ("w512_d1_h2-w512_d2_h2/1x16x8", 32, [(5, 6), (3, 3)]),
}


@functools.lru_cache(maxsize=None)
def jax_model(name, sw, int8):
    """(cfg, params, batch, z, decode(z) patches) of the JAX model at fp32;
    ``int8``: its blocks quantized (``quantize_block_params``), the Pallas
    kernels interpreted as they are routed on the TPU."""
    variant, n, grids = SMALL_AE[name]
    cfg = j_ae.AEConfig.from_variant(variant, sw=sw)
    params = jax_params(cfg)
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
    for name in ("LAUNCHES", "PROLOGUE_LAUNCHES", "Q8_LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(t_fa, name, 0)
    for name in ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES"):
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
                fl=t_fl.LAUNCHES, dq=t_fl.DQ_LAUNCHES, dkv=t_fl.DKV_LAUNCHES)


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

    def test_grad_and_fp32_keep_the_composition(self, entries, d):
        for n in (256, 2048):
            qkv, *rest = qkv_inputs(1, n, 2, d)
            qkv.requires_grad_()
            assert not t_fa.takes_flash_fold(qkv, rest[0], rest[1], 2, "auto")
            out = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=40)
            out.as_subclass(torch.Tensor).float().sum().backward()
            assert qkv.grad is not None
            args = qkv_inputs(1, n, 2, d, dtype=torch.float32)
            assert not t_fa.takes_flash_fold(args[0], args[1], args[2], 2, "auto")
            t_fa.fused_qkv_attention(*args, num_heads=2, sliding_window=40)
        assert entries == [] and launches() == only()

    def test_forced_kernels_raise_before_a_launch(self, entries, d):
        qkv, *rest = qkv_inputs(1, 256, 2, d)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention(qkv.requires_grad_(), *rest, num_heads=2, impl="fused")
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention(*qkv_inputs(1, 256, 2, d, dtype=torch.float32), num_heads=2, impl="fused")
        q = card(torch.zeros((1, 256, 2, d), dtype=torch.bfloat16, requires_grad=True))
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, q, q)
        g = card(torch.zeros((1, 64, 2 * d), dtype=torch.bfloat16))
        with pytest.raises(ValueError, match="head_dim"):  # delta: the backward's prologue
            t_fa.fused_qk_prologue(*qkv_inputs(1, 64, 2, d)[:5], num_heads=2, out=g, dout=g)
        assert entries == [] and launches() == only()


def test_ae_training_step_at_d256_takes_the_composition(entries, monkeypatch):
    """A bf16 AE with 256-channel heads on the card (every tensor says it
    lies there): ``attn_impl="fused"`` trains on the unfused composition
    (the backward kernels have no instance at d = 256), so its step launches
    no kernel of the attention, forward or backward; the same model under
    ``no_grad`` takes the forward kernels (#1 after the prologue) in every
    block."""
    cfg = t_ae.AEConfig.from_variant("w512_d1_h2-w512_d1_h2/1x16x8")
    model = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "fused"}, param_dtype=torch.float32,
                    compute_dtype=torch.bfloat16, trainable=True, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(2, 32, 16, [(5, 6), (3, 3)]).items()}
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    out = model(batch, deterministic=False)
    out["patches"].float().square().mean().backward()
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
    assert entries == [] and launches() == only()
    with torch.no_grad():
        model.decode(model.encode(batch))
    depth = cfg.encoder_depth + cfg.decoder_depth
    assert launches() == only(fa=depth, prologue=depth)
