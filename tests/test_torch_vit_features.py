"""The port's DINO ViT (``vitok_torch.models.vit_features``) against the JAX package.

A small ViT (width 128, 2 heads of 64, depth 2, pretrained at 32², patch
16) with the JAX package's random init, LayerNorm gains drawn from
U(0.5, 1.5), carried across with ``vit_from_jax_params``: the tokens at the
native grid and at interpolated grids (48², 64²), and through
``make_dino_feature_fn(target_size=...)`` with a resize, agree with
``vit_apply`` within atol 1e-4 in fp32; the image gradient of a random
projection of the features agrees with ``jax.grad`` within rel L2 1e-4. A
timm-named state dict (with a DINO wrapper, prefixes and a head) loads
through ``load_dino_backbone`` on both sides. The perceptual term:
``compute_loss`` with that backbone, loss and parameter gradients within
rel L2 1e-4 of the JAX ``compute_loss``; and the trainer CLI takes a step
with it.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train_lib import (LOSS, VARIANT, GRIDS, PATCH, TOKENS, assert_trees_close, jax_params,
                                        jax_tile_indices, port_grads, rel_l2, trainable_model)
from tests.test_torch_ae import make_batch
from vitok_tpu import train_lib as j_tl
from vitok_tpu.models import ae as j_ae
from vitok_tpu.models import vit_features as J
from vitok_torch import train_lib as t_tl
from vitok_torch.models import vit_features as T
from vitok_torch.scripts import train_vae
from vitok_torch.utils.params_io import to_jax_params, vit_from_jax_params

torch.set_num_threads(1)

J_CFG = J.ViTCfg(width=128, depth=2, heads=2, patch=16, img_size=32, attn_impl="xla")
T_CFG = T.ViTCfg(width=128, depth=2, heads=2, patch=16, img_size=32)


def jax_vit_params(cfg=J_CFG, seed=0):
    """JAX init, then every LayerNorm gain ~ U(0.5, 1.5) and bias ~ N(0, 0.1)."""
    params = jax.tree_util.tree_map(np.array, J.init_vit_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    for node in (params["blocks"]["norm1"], params["blocks"]["norm2"], params["norm"]):
        node["scale"] = rng.uniform(0.5, 1.5, node["scale"].shape).astype(np.float32)
        node["bias"] = (0.1 * rng.standard_normal(node["bias"].shape)).astype(np.float32)
    return params


def port_vit(params, cfg=T_CFG):
    return T.DinoViT(cfg, state_dict=vit_from_jax_params(params, cfg), device="cpu")


def timm_state(width, depth, heads, grid, seed=0, patch=16):
    """A random timm-named ViT state dict (torch tensors), pretrained grid ``grid``."""
    rng = np.random.default_rng(seed)
    t = lambda *shape, std=0.02: torch.from_numpy((std * rng.standard_normal(shape)).astype(np.float32))
    gain = lambda n: torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    state = {"patch_embed.proj.weight": t(width, 3, patch, patch), "patch_embed.proj.bias": t(width),
             "cls_token": t(1, 1, width), "pos_embed": t(1, 1 + grid * grid, width),
             "norm.weight": gain(width), "norm.bias": t(width)}
    for i in range(depth):
        for name, shape in (("attn.qkv", (3 * width, width)), ("attn.proj", (width, width)),
                            ("mlp.fc1", (4 * width, width)), ("mlp.fc2", (width, 4 * width))):
            state[f"blocks.{i}.{name}.weight"] = t(*shape)
            state[f"blocks.{i}.{name}.bias"] = t(shape[0])
        for norm in ("norm1", "norm2"):
            state[f"blocks.{i}.{norm}.weight"] = gain(width)
            state[f"blocks.{i}.{norm}.bias"] = t(width)
    return state


def _x(size, seed=0, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 3, size, size)).astype(np.float32)


class TestForward:
    @pytest.mark.parametrize("size", [32, 48, 64])  # the native grid, then interpolated position embeddings
    def test_tokens_match_vit_apply(self, size):
        params = jax_vit_params()
        x = _x(size, seed=size)
        want = np.asarray(J.vit_apply(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), J_CFG))
        got = port_vit(params)(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 1 + (size // 16) ** 2, 128)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    @pytest.mark.parametrize("src,dst", [(4, (2, 3)), (2, (5, 4)), (3, (3, 3))])
    def test_interpolate_pos_embed_matches_jax(self, src, dst):
        pe = np.random.default_rng(src).standard_normal((1, 1 + src * src, 8)).astype(np.float32)
        want = np.asarray(J.interpolate_pos_embed(jnp.asarray(pe), src, dst))
        got = T.interpolate_pos_embed(torch.from_numpy(pe), src, dst).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("size,target", [(64, 32), (48, 64)])  # a downsampling and an upsampling resize
    def test_feature_fn_and_its_image_gradient_match_jax(self, size, target):
        params = jax_vit_params()
        x = _x(size, seed=1)
        j_fn = J.make_dino_feature_fn(jax.tree_util.tree_map(jnp.asarray, params), J_CFG, target_size=target)
        t_fn = T.make_dino_feature_fn(port_vit(params), target_size=target)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = t_fn(xt)
        want = np.asarray(j_fn(jnp.asarray(x)))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-4)
        # a random projection of the features: the sum of squares of LayerNorm
        # outputs is nearly constant, and its gradient nearly cancels
        w = np.random.default_rng(2).standard_normal(want.shape).astype(np.float32)
        want_g = np.asarray(jax.grad(lambda z: jnp.sum(j_fn(z) * w))(jnp.asarray(x)))
        (got * torch.from_numpy(w)).sum().backward()
        assert rel_l2(xt.grad.numpy(), want_g) <= 1e-4

    def test_backbone_is_frozen(self):
        model = port_vit(jax_vit_params())
        assert not any(p.requires_grad for p in model.parameters())
        x = torch.from_numpy(_x(32)).requires_grad_(True)
        T.make_dino_feature_fn(model)(x).sum().backward()
        assert x.grad is not None and all(p.grad is None for p in model.parameters())


class TestLoading:
    @pytest.mark.parametrize("fmt", ["pth", "safetensors"])
    def test_timm_state_dict_through_load_dino_backbone(self, tmp_path, fmt):
        """ViT-S/16 pretrained at 224² (grid 14) read on both sides; a .pth
        carries DINO's wrapper, a ``module.`` prefix and a head."""
        state = timm_state(width=384, depth=12, heads=6, grid=14, seed=3)
        path = str(tmp_path / f"dino.{fmt}")
        if fmt == "pth":
            torch.save({"teacher": {"module." + k: v for k, v in {**state, "head.weight": torch.ones(2)}.items()}},
                       path)
        else:
            from safetensors.torch import save_file

            save_file(state, path)
        model = T.load_dino_backbone(path, size="S", device="cpu")
        assert model.cfg.img_size == 224 and model.cfg.width == 384
        j_params, j_cfg = J.load_dino_backbone(path, size="S", attn_impl="xla")
        x = _x(32, seed=4)
        want = np.asarray(J.vit_apply(j_params, jnp.asarray(x), j_cfg))
        got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

    def test_random_init_warns_and_is_the_same_on_every_call(self):
        with pytest.warns(UserWarning, match="random-init"):
            a = T.load_dino_backbone(None, size="S", device="cpu")
        with pytest.warns(UserWarning, match="random-init"):
            b = T.load_dino_backbone(None, size="S", device="cpu")
        assert a.cfg == T.dino_vit_s16() and all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
        w = a.blocks[0].attn.qkv.weight
        assert w.abs().max() <= 0.04 and 0.015 < float(w.std()) < 0.02  # trunc-normal 0.02 cut at 2 sigma


class TestPerceptual:
    def test_compute_loss_with_the_dino_term_matches_jax(self):
        """Charbonnier + SSIM + 500 x the DINO term on 64² tiles resized to 32²."""
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        vit = jax_vit_params(seed=6)
        batch = make_batch(len(GRIDS), TOKENS, PATCH, GRIDS)
        loss = dict(LOSS, perceptual_weight=500.0)
        j_loss_cfg = j_tl.LossConfig(**loss)
        j_feat = J.make_dino_feature_fn(jax.tree_util.tree_map(jnp.asarray, vit), J_CFG, target_size=32)
        rng = jax.random.key(5)
        loss_fn = functools.partial(j_tl.compute_loss, cfg=cfg, loss_cfg=j_loss_cfg, feature_fn=j_feat,
                                    compute_dtype=jnp.float32)
        (want, want_m), want_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(  # jitted: 4 s, eagerly 17 s
            jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()}, rng=rng)
        got, got_m, grads = port_grads(trainable_model(cfg, params), batch, t_tl.LossConfig(**loss),
                                       feature_fn=T.make_dino_feature_fn(port_vit(vit), target_size=32),
                                       tile_indices=jax_tile_indices(batch, j_loss_cfg, rng))
        assert float(got_m["loss/perceptual"]) > 0
        assert rel_l2(got, float(want)) <= 1e-4
        assert rel_l2(float(got_m["loss/perceptual"]), float(want_m["loss/perceptual"])) <= 1e-4
        assert_trees_close(to_jax_params(grads), want_g, 1e-4, "grad")

    def test_trainer_takes_a_step_with_the_perceptual_term(self, tmp_path, capsys):
        from PIL import Image

        data = tmp_path / "imgs"
        data.mkdir()
        rng = np.random.default_rng(0)
        for i, (h, w) in enumerate([(64, 64), (48, 80)]):
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(data / f"{i}.png")
        with pytest.warns(UserWarning, match="random-init"):
            train_vae.main(["--variant", "w64_d1_h1-w64_d2_h1/1x16x8", "--max-tokens", "64", "--bs", "2",
                            "--device", "cpu", "--log-freq", "1", "--tile-size", "64", "--steps", "1",
                            "--data", str(data), "--output-dir", str(tmp_path / "out"),
                            "--perceptual-weight", "500"])
        logs = capsys.readouterr().out
        assert "DINO perceptual: ViT-S (RANDOM INIT)" in logs and "loss/perceptual" in logs
        line = next(ln for ln in logs.splitlines() if ln.startswith("step 1:"))
        assert "training done" in logs and "loss/perceptual" in line
        assert os.path.exists(tmp_path / "out" / "last" / "state.pt")
