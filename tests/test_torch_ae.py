"""Parity of the port's AE (``vitok_torch.models.ae``) with the JAX package.

The same JAX params (LayerScale and norm gains drawn from U(0.5, 1.5) so
every block matters) and the same numpy NaFlex batch go through
``vitok_tpu``'s ``encode_apply``/``decode_apply`` in float32 on the CPU and
through the port's ``AE`` on the CPU; outputs agree on valid tokens within
atol 1e-4 (float32, 3-4 blocks deep, different summation orders).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu.models import ae as j_ae
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.utils.params_io import from_jax_params

torch.set_num_threads(1)

ATOL = 1e-4

VARIANTS = [  # the strings of tests/test_ae.py's variant DSL tests
    "B/1x16x64",
    "Ld4-Ld24/1x16x64",
    "Td4-T/1x16x64",
    "B/16x64",
    "w512_d8_h8-w256_d4_h4/1x8x16",
    "Bw512/1x16x16",
    "Bm4-Bm2/1x16x16",
]


class TestVariantDSL:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_decode_variant_and_config_match(self, variant):
        assert t_ae.decode_variant(variant) == j_ae.decode_variant(variant)
        tc, jc = t_ae.AEConfig.from_variant(variant), j_ae.AEConfig.from_variant(variant)
        for f in dataclasses.fields(tc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        for prop in ("encoder_head_dim", "decoder_head_dim", "encoder_ffn_dim", "decoder_ffn_dim"):
            assert getattr(tc, prop) == getattr(jc, prop), prop

    @pytest.mark.parametrize("variant", ["Z/1x16x64", "B/1x2x3x4"])
    def test_invalid_variant_raises(self, variant):
        with pytest.raises(ValueError):
            t_ae.decode_variant(variant)

    def test_config_checks(self):
        with pytest.raises(ValueError):
            t_ae.AEConfig(encoder=False, decoder=False)
        with pytest.raises(ValueError):
            t_ae.AEConfig(attn_impl="pallas")
        assert t_ae.AEConfig(sw=0).sw is None


def make_batch(b, n, patch, grids, seed=0):
    """numpy NaFlex batch: sample i has a dense ``grids[i]`` grid, tail padding."""
    rng = np.random.default_rng(seed)
    dim = patch * patch * 3
    d = {
        "patches": np.zeros((b, n, dim), np.float32),
        "patch_mask": np.zeros((b, n), bool),
        "row_idx": np.zeros((b, n), np.int32),
        "col_idx": np.zeros((b, n), np.int32),
        "orig_height": np.array([g[0] * patch for g in grids], np.int32),
        "orig_width": np.array([g[1] * patch for g in grids], np.int32),
        "grid_rows": np.array([g[0] for g in grids], np.int32),
        "grid_cols": np.array([g[1] for g in grids], np.int32),
    }
    for i, (gr, gc) in enumerate(grids):
        nv = gr * gc
        yy, xx = np.meshgrid(np.arange(gr), np.arange(gc), indexing="ij")
        d["patches"][i, :nv] = rng.standard_normal((nv, dim))
        d["patch_mask"][i, :nv] = True
        d["row_idx"][i, :nv] = yy.ravel()
        d["col_idx"][i, :nv] = xx.ravel()
    return d


def jax_params(cfg, seed=0):
    """JAX init, then every norm and LayerScale gain ~ U(0.5, 1.5) (numpy)."""
    params = jax.tree_util.tree_map(np.asarray, j_ae.init_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    for stack in ("encoder_blocks", "decoder_blocks"):
        if stack not in params:
            continue
        blk = params[stack]
        for node, key in ((blk["layer_scale"], "gamma"), (blk["norm1"], "scale"),
                          (blk["attn"]["norm_q"], "scale"), (blk["attn"]["norm_k"], "scale")):
            node[key] = rng.uniform(0.5, 1.5, node[key].shape).astype(np.float32)
    return params


CONFIGS = {  # name: (variant, tokens, patch, per-sample grids)
    "d64": ("w128_d2_h2-w128_d2_h2/1x16x8", 32, 16, [(4, 6), (3, 5), (2, 2)]),
    "d128": ("w256_d1_h2-w256_d2_h2/1x16x8", 32, 16, [(5, 6), (4, 4)]),
    "patch32": ("w128_d2_h2-w128_d2_h2/1x32x8", 16, 32, [(4, 4), (2, 3)]),
}


@functools.lru_cache(maxsize=None)
def jax_reference(name, sw):
    """(params, batch, enc z, dec(z) patches, forward patches) from the JAX package."""
    variant, n, patch, grids = CONFIGS[name]
    cfg = j_ae.AEConfig.from_variant(variant, sw=sw)
    params = jax_params(cfg)
    batch = make_batch(len(grids), n, patch, grids)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    enc = j_ae.encode_apply(jp, jb, cfg, compute_dtype=jnp.float32)
    dec = j_ae.decode_apply(jp, enc, cfg, compute_dtype=jnp.float32)
    return cfg, params, batch, np.asarray(enc["z"]), np.asarray(dec["patches"])


def port_model(cfg, params, attn_impl):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
    kw["attn_impl"] = attn_impl
    return t_ae.AE(state_dict=from_jax_params(params, cfg), compute_dtype=torch.float32,
                   device="cpu", **kw)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class TestModelParity:
    @pytest.mark.parametrize("name", list(CONFIGS))
    @pytest.mark.parametrize("sw", [None, 3])
    @pytest.mark.parametrize("attn_impl", ["auto", "xla"])
    def test_encode_decode_forward(self, name, sw, attn_impl):
        cfg, params, batch, z_want, p_want = jax_reference(name, sw)
        model = port_model(cfg, params, attn_impl)
        valid = batch["patch_mask"]
        tb = _torch_batch(batch)
        enc = model.encode(tb)
        np.testing.assert_allclose(enc["z"].numpy()[valid], z_want[valid], atol=ATOL, rtol=0)
        dec = model.decode({**tb, "z": torch.tensor(z_want)})
        np.testing.assert_allclose(dec["patches"].numpy()[valid], p_want[valid], atol=ATOL, rtol=0)
        fwd = model(tb)
        np.testing.assert_allclose(fwd["patches"].numpy()[valid], p_want[valid], atol=ATOL, rtol=0)
        assert set(fwd) == set(batch) | {"patches"}  # metadata passes through

    @pytest.mark.parametrize("tokens,fused", [(32, True), (30, False)])
    def test_blocks_route_by_the_kernel_gate(self, monkeypatch, tokens, fused):
        """At n % 8 == 0 every block takes the fused path (its plain version
        on the CPU, no kernel launch); otherwise the unfused composition."""
        calls = []
        plain = t_fa.fused_qkv_attention_plain
        monkeypatch.setattr(t_fa, "fused_qkv_attention_plain",
                            lambda *a, **k: calls.append(1) or plain(*a, **k))
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d2_h2/1x16x8")
        model = t_ae.AE(**dataclasses.asdict(cfg), compute_dtype=torch.float32, device="cpu")
        batch = _torch_batch(make_batch(2, tokens, 16, [(5, 6), (3, 3)]))
        launches = t_fa.LAUNCHES
        out = model(batch)
        assert len(calls) == (3 if fused else 0)
        assert t_fa.LAUNCHES == launches
        assert torch.isfinite(out["patches"]).all()

    def test_bf16_forward_on_cpu(self):
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d1_h2/1x16x8")
        model = t_ae.AE(**dataclasses.asdict(cfg), device="cpu")
        out = model(_torch_batch(make_batch(2, 16, 16, [(4, 4), (2, 3)])))
        assert out["patches"].dtype == torch.bfloat16
        assert torch.isfinite(out["patches"].float()).all()

    def test_default_device_is_the_card(self):
        kw = t_ae.decode_variant("w128_d1_h2-w128_d1_h2/1x16x8")
        if torch.cuda.is_available():
            assert t_ae.AE(**kw).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                t_ae.AE(**kw)
