"""The port's AE at 2048 tokens and more (the flash attention path) against
the JAX package.

A narrow model with head dim 64 (2 + 2 blocks) and two samples of 48x48
and 40x33 patches padded to 2304 tokens go through ``vitok_tpu``'s
``encode_apply``/``decode_apply`` with ``attn_impl="pallas"`` (its flash
kernel in interpret mode) in float32 on the CPU, and through the port's
``AE``, whose blocks route to the flash kernel's plain version there.
Valid tokens agree within atol 1e-4 with and without a sliding window. The
int8 model, quantized on both sides from the same fp32 params, is held at
rel L2 1e-3 for the reason ``tests/test_torch_quant.py`` gives (a code at a
rounding tie may flip between the two RMSNorm sums).
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_ae import jax_params, make_batch, port_model
from tests.test_torch_quant import jax_tpu_routing, rel_l2
from vitok_tpu.models import ae as j_ae
from vitok_tpu.ops import quant as j_q
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.utils.params_io import from_jax_params

torch.set_num_threads(1)

ATOL = 1e-4
INT8_REL_L2 = 1e-3
VARIANT = "w128_d2_h2-w128_d2_h2/1x16x64"
TOKENS = 2304
GRIDS = [(48, 48), (40, 33)]


@functools.lru_cache(maxsize=None)
def jax_reference(sw, int8):
    """(cfg, params, batch, enc z, dec(z) patches) of the JAX model on its flash kernel."""
    cfg = j_ae.AEConfig.from_variant(VARIANT, sw=sw, attn_impl="pallas")
    params = jax_params(cfg)
    if int8:
        params = jax.tree_util.tree_map(np.asarray, j_q.quantize_block_params(params))
    batch = make_batch(len(GRIDS), TOKENS, 16, GRIDS)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax_tpu_routing() if int8 else contextlib.nullcontext():
        enc = j_ae.encode_apply(jp, jb, cfg, compute_dtype=jnp.float32)
        dec = j_ae.decode_apply(jp, enc, cfg, compute_dtype=jnp.float32)
    return cfg, params, batch, np.asarray(enc["z"]), np.asarray(dec["patches"])


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts of the flash and fused plain versions (what runs on the CPU)."""
    calls = {"flash": 0, "fused": 0}
    for name, mod, fn in (("flash", t_fl, "flash_attention_plain"),
                          ("fused", t_fa, "fused_qkv_attention_plain")):
        orig = getattr(mod, fn)

        def counted(*a, _name=name, _orig=orig, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn, counted)
    return calls


class TestHighResolution:
    @pytest.mark.parametrize("sw", [None, 256])
    def test_matches_jax_flash_path(self, attention_calls, sw):
        cfg, params, batch, z_want, p_want = jax_reference(sw, False)
        model = port_model(cfg, params, "auto")
        valid = batch["patch_mask"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        launches = t_fl.LAUNCHES
        z = model.encode(tb)["z"].numpy()
        np.testing.assert_allclose(z[valid], z_want[valid], atol=ATOL, rtol=0)
        patches = model.decode({**tb, "z": torch.tensor(z_want)})["patches"].numpy()
        np.testing.assert_allclose(patches[valid], p_want[valid], atol=ATOL, rtol=0)
        depth = cfg.encoder_depth + cfg.decoder_depth
        assert attention_calls == {"flash": depth, "fused": 0}
        assert t_fl.LAUNCHES == launches

    def test_int8_matches_jax_flash_path(self, attention_calls):
        cfg, qparams, batch, z_want, p_want = jax_reference(256, True)
        kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
        model = t_ae.AE(state_dict=from_jax_params(qparams, cfg), compute_dtype=torch.float32,
                        device="cpu", **{**kw, "attn_impl": "auto"})
        valid = batch["patch_mask"]
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        z = model.encode(tb)["z"].numpy()
        assert rel_l2(z[valid], z_want[valid]) <= INT8_REL_L2
        patches = model.decode({**tb, "z": torch.tensor(z_want)})["patches"].numpy()
        assert rel_l2(patches[valid], p_want[valid]) <= INT8_REL_L2
        assert attention_calls == {"flash": cfg.encoder_depth + cfg.decoder_depth, "fused": 0}


class TestFlashImpl:
    def test_flash_impl_forces_the_flash_path(self, attention_calls):
        """``attn_impl="flash"`` sends every block to the flash kernel at any
        N; valid tokens match the unfused composition."""
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d2_h2/1x16x8", sw=5)
        model = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "flash"},
                        compute_dtype=torch.float32, device="cpu")
        reference = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "xla"},
                            state_dict=model.state_dict(), compute_dtype=torch.float32, device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in make_batch(2, 32, 16, [(5, 6), (3, 3)]).items()}
        got = model(batch)["patches"]
        assert attention_calls == {"flash": 3, "fused": 0}
        want = reference(batch)["patches"]
        valid = batch["patch_mask"]
        np.testing.assert_allclose(got[valid].numpy(), want[valid].numpy(), atol=1e-5, rtol=0)
