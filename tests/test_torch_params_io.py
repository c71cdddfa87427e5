"""Checkpoint interchange of the port (``vitok_torch.utils.params_io``,
``vitok_torch.pretrained``) against the JAX package's params and exporter."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu.models import ae as j_ae
from vitok_tpu.pretrained import list_pretrained as j_list_pretrained
from vitok_tpu.pretrained import get_pretrained_info as j_info
from vitok_tpu.utils.params_io import pytree_to_torch_state, save_safetensors_params
from vitok_torch import pretrained as t_pre
from vitok_torch.models import ae as t_ae
from vitok_torch.utils.params_io import from_jax_params, released_state_to_module_state

torch.set_num_threads(1)

VARIANT = "w128_d2_h2-w256_d1_h2/1x16x8"  # head dims 64 and 128


def _params(variant=VARIANT, **cfg_kw):
    cfg = j_ae.AEConfig.from_variant(variant, **cfg_kw)
    params = jax.tree_util.tree_map(np.asarray, j_ae.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(3)
    for stack in ("encoder_blocks", "decoder_blocks"):  # gains that are not all ones
        attn = params[stack]["attn"]
        for nm in ("norm_q", "norm_k"):
            attn[nm]["scale"] = rng.uniform(0.5, 1.5, attn[nm]["scale"].shape).astype(np.float32)
    return cfg, params


def _port(cfg, state, **kw):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
    return t_ae.AE(state_dict=state, compute_dtype=torch.float32, device="cpu", **{**fields, **kw})


class TestFromJaxParams:
    def test_state_matches_module_layout_and_values(self):
        cfg, params = _params()
        state = from_jax_params(params, cfg)
        model = _port(cfg, state)  # strict load: every key and shape matches
        assert set(state) == set(model.state_dict())
        np.testing.assert_array_equal(
            state["encoder_blocks.1.attn.qkv_proj.weight"].numpy(),
            params["encoder_blocks"]["attn"]["qkv"]["kernel"][1].T,
        )
        np.testing.assert_array_equal(
            state["decoder_blocks.0.attn.norm_k.weight"].numpy(),
            params["decoder_blocks"]["attn"]["norm_k"]["scale"][0],
        )
        np.testing.assert_array_equal(state["to_pixels.bias"].numpy(), params["to_pixels"]["bias"])

    def test_depth_mismatch_raises(self):
        cfg, params = _params()
        with pytest.raises(ValueError, match="depth"):
            from_jax_params(params, dataclasses.replace(cfg, encoder_depth=3))

    def test_outputs_match_jax_model_without_layer_scale(self):
        """fp32 on the CPU, valid tokens, atol 1e-4; the branch without
        LayerScale (``use_layer_scale=False``)."""
        cfg, params = _params(use_layer_scale=False)
        model = _port(cfg, from_jax_params(params, cfg))
        rng = np.random.default_rng(0)
        n = 24
        batch = {
            "patches": rng.standard_normal((2, n, 768)).astype(np.float32),
            "patch_mask": np.arange(n)[None] < np.array([[20], [12]]),
            "row_idx": np.tile((np.arange(n) // 5)[None], (2, 1)).astype(np.int32),
            "col_idx": np.tile((np.arange(n) % 5)[None], (2, 1)).astype(np.int32),
        }
        want = j_ae.forward_apply(
            jax.tree_util.tree_map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()}, cfg, compute_dtype=jnp.float32,
        )["patches"]
        got = model({k: torch.from_numpy(v) for k, v in batch.items()})["patches"]
        valid = batch["patch_mask"]
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=1e-4, rtol=0)


class TestReleasedLayout:
    def test_loader_equals_from_jax_params_exactly(self):
        """The JAX exporter writes the released (interleaved q/k) layout; the
        port's loader permutes it back to exactly the JAX params."""
        cfg, params = _params()
        released = pytree_to_torch_state(params)
        got = released_state_to_module_state(released)
        want = from_jax_params(params, cfg)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k

    def test_orig_mod_prefix_is_stripped(self):
        cfg, params = _params()
        released = {f"_orig_mod.{k}": v for k, v in pytree_to_torch_state(params).items()}
        assert set(released_state_to_module_state(released)) == set(from_jax_params(params, cfg))


class TestPretrained:
    def test_registry_matches_jax(self):
        assert t_pre.list_pretrained() == j_list_pretrained()
        for name in t_pre.list_pretrained():
            assert t_pre.get_pretrained_info(name) == j_info(name)
        with pytest.raises(KeyError):
            t_pre.get_pretrained_info("nope")

    @pytest.fixture
    def tiny_release(self, tmp_path, monkeypatch):
        """A synthesized split safetensors pair for a tiny registered model."""
        cfg, params = _params()
        name = "tiny-test"
        monkeypatch.setitem(t_pre._MODELS, name, ("none/none", t_pre._FILES, VARIANT))
        d = tmp_path / name
        d.mkdir()
        save_safetensors_params(params, str(d / "encoder.safetensors"), component="encoder")
        save_safetensors_params(params, str(d / "decoder.safetensors"), component="decoder")
        monkeypatch.setenv("VITOK_PRETRAINED_DIR", str(tmp_path))
        return name, cfg, params

    def test_load_split_pair(self, tiny_release):
        name, cfg, params = tiny_release
        t_cfg, state = t_pre.load_pretrained_params(name)
        assert t_cfg == t_ae.AEConfig.from_variant(VARIANT)
        want = from_jax_params(params, cfg)
        assert set(state) == set(want)
        for k in want:
            assert torch.equal(state[k], want[k]), k
        model = t_ae.AE(state_dict=state, device="cpu", **dataclasses.asdict(t_cfg))
        assert model.decoder_blocks[0].attn.qkv_proj.weight.dtype == torch.bfloat16

    @pytest.mark.parametrize("component,prefix", [("encoder", "decoder"), ("decoder", "encoder")])
    def test_load_one_half(self, tiny_release, component, prefix):
        name, _, _ = tiny_release
        t_cfg, state = t_pre.load_pretrained_params(name, component=component)
        assert not any(k.startswith(prefix) for k in state)
        t_ae.AE(state_dict=state, device="cpu", **dataclasses.asdict(t_cfg))

    def test_raises_without_local_dir(self, monkeypatch):
        monkeypatch.delenv("VITOK_PRETRAINED_DIR", raising=False)
        with pytest.raises(FileNotFoundError, match="VITOK_PRETRAINED_DIR"):
            t_pre.load_pretrained_params("350M-f16x64")

    def test_raises_on_missing_files(self, tmp_path, monkeypatch):
        monkeypatch.setenv("VITOK_PRETRAINED_DIR", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="not found"):
            t_pre.load_pretrained_params("350M-f16x64")
