"""The port's training losses and tile sampling against the JAX package.

The same numpy images and patches go through ``vitok_tpu.losses`` and
``vitok_torch.losses`` in float32 on the CPU: values and input gradients
agree within atol 1e-5 (sums in another order; the SSIM map divides small
variances). ``sample_tiles`` with origins drawn by
``vitok_tpu.pp.ops.sample_tile_indices`` gives the JAX package's tiles bit
for bit, including the -1.0 padding of images smaller than a tile.
"""

import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from vitok_tpu import losses as j_losses
from vitok_tpu.pp import ops as j_ops
from vitok_tpu.pp.registry import build_transform as j_build_transform
from vitok_torch import losses as t_losses
from vitok_torch.pp import ops as t_ops
from vitok_torch.pp.registry import build_transform as t_build_transform

torch.set_num_threads(1)

ATOL = 1e-5


def _pair(shape, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + noise * rng.standard_normal(shape), -1, 1).astype(np.float32)
    return x, y


def _value_and_grad_jax(fn, x, y):
    val, grad = jax.value_and_grad(lambda a: fn(a, jnp.asarray(y)))(jnp.asarray(x))
    return float(val), np.asarray(grad)


def _value_and_grad_torch(fn, x, y):
    tx = torch.from_numpy(x).requires_grad_(True)
    val = fn(tx, torch.from_numpy(y))
    val.backward()
    return float(val.detach()), tx.grad.numpy()


class TestLossesAgainstJax:
    @pytest.mark.parametrize("masked", [False, True])
    def test_charbonnier(self, masked):
        pred, target = _pair((3, 20, 48))
        mask = None
        if masked:  # one sample fully padded: its mean divides by max(count, 1)
            mask = np.arange(20)[None, :] < np.array([20, 7, 0])[:, None]
        want, want_g = _value_and_grad_jax(
            lambda a, b: j_losses.charbonnier_loss(a, b, None if mask is None else jnp.asarray(mask)), pred, target)
        got, got_g = _value_and_grad_torch(
            lambda a, b: t_losses.charbonnier_loss(a, b, None if mask is None else torch.from_numpy(mask)), pred, target)
        assert abs(got - want) <= ATOL
        np.testing.assert_allclose(got_g, want_g, atol=ATOL, rtol=0)

    @pytest.mark.parametrize("shape", [(2, 3, 32, 40), (1, 3, 8, 24), (2, 1, 11, 11)])
    def test_ssim_and_ssim_loss(self, shape):
        """The last two shapes clamp the 11-tap kernel to the image (7 and 11)."""
        x, y = _pair(shape, seed=1)
        want, want_g = _value_and_grad_jax(j_losses.ssim_loss, x, y)
        got, got_g = _value_and_grad_torch(t_losses.ssim_loss, x, y)
        assert abs(got - want) <= ATOL
        np.testing.assert_allclose(got_g, want_g, atol=ATOL, rtol=0)
        per_image = t_losses.ssim(torch.from_numpy(x), torch.from_numpy(y), reduce=False).numpy()
        np.testing.assert_allclose(
            per_image, np.asarray(j_losses.ssim(jnp.asarray(x), jnp.asarray(y), reduce=False)), atol=ATOL, rtol=0)

    def test_ssim_of_identical_images_is_one(self):
        x, _ = _pair((1, 3, 16, 16))
        assert abs(float(t_losses.ssim(torch.from_numpy(x), torch.from_numpy(x))) - 1.0) <= 1e-6

    def test_psnr(self):
        x, y = _pair((2, 3, 16, 20), seed=2)
        want, want_g = _value_and_grad_jax(j_losses.psnr, x, y)
        got, got_g = _value_and_grad_torch(t_losses.psnr, x, y)
        assert abs(got - want) <= 1e-4  # decibels: log10 of an fp32 mean
        np.testing.assert_allclose(got_g, want_g, atol=1e-4, rtol=0)
        np.testing.assert_allclose(
            t_losses.psnr(torch.from_numpy(x), torch.from_numpy(y), reduce=False).numpy(),
            np.asarray(j_losses.psnr(jnp.asarray(x), jnp.asarray(y), reduce=False)), atol=1e-4, rtol=0)

    def test_perceptual_hook(self):
        x, y = _pair((2, 3, 8, 8), seed=3)
        want = float(j_losses.perceptual_loss(lambda a: a[:, :, ::2, ::2] * 2.0, jnp.asarray(x), jnp.asarray(y)))
        got = float(t_losses.perceptual_loss(lambda a: a[:, :, ::2, ::2] * 2.0, torch.from_numpy(x), torch.from_numpy(y)))
        assert abs(got - want) <= ATOL


class TestSampleTiles:
    @pytest.mark.parametrize("hw,tile", [((48, 64), (16, 16)), ((20, 24), (32, 16)), ((40, 40), (40, 40))])
    def test_tiles_match_jax_at_its_indices(self, hw, tile):
        rng = np.random.default_rng(4)
        images = rng.standard_normal((3, 3, *hw)).astype(np.float32)
        orig_h = np.array([hw[0], hw[0] - 7, 5], np.int32)
        orig_w = np.array([hw[1], hw[1] - 3, 9], np.int32)
        idx = j_ops.sample_tile_indices(jnp.asarray(orig_h), jnp.asarray(orig_w), n_tiles=3,
                                        tile_size=tile, rng=jax.random.key(5))
        want, (wy, wx) = j_ops.sample_tiles(jnp.asarray(images), orig_h, orig_w, n_tiles=3,
                                            tile_size=tile, indices=idx)
        t_idx = tuple(torch.from_numpy(np.array(i)) for i in idx)
        got, (gy, gx) = t_ops.sample_tiles(torch.from_numpy(images), torch.from_numpy(orig_h),
                                           torch.from_numpy(orig_w), n_tiles=3, tile_size=tile, indices=t_idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))

    def test_own_indices_stay_inside_and_recrop(self):
        gen = torch.Generator().manual_seed(0)
        images = torch.randn(4, 3, 40, 56, generator=gen)
        orig_h, orig_w = torch.tensor([40, 30, 17, 40]), torch.tensor([56, 20, 56, 16])
        tiles, (sy, sx) = t_ops.sample_tiles(images, orig_h, orig_w, n_tiles=5, tile_size=(16, 16), generator=gen)
        assert tiles.shape == (4, 5, 3, 16, 16) and sy.dtype == torch.int32
        assert (sy >= 0).all() and (sy <= (orig_h - 16).clamp(min=0)[:, None]).all()
        assert (sx >= 0).all() and (sx <= (orig_w - 16).clamp(min=0)[:, None]).all()
        again, _ = t_ops.sample_tiles(images, orig_h, orig_w, n_tiles=5, tile_size=(16, 16), indices=(sy, sx))
        assert torch.equal(tiles, again)
        assert torch.equal(tiles[1, 2], images[1, :, sy[1, 2]: sy[1, 2] + 16, sx[1, 2]: sx[1, 2] + 16])

    def test_gradient_flows_back_to_the_image(self):
        images = torch.zeros(1, 1, 8, 8, requires_grad=True)
        tiles, _ = t_ops.sample_tiles(images, torch.tensor([8]), torch.tensor([8]), n_tiles=2, tile_size=(4, 4),
                                      indices=(torch.tensor([[0, 2]]), torch.tensor([[0, 2]])))
        tiles.sum().backward()
        want = torch.zeros(8, 8)
        want[0:4, 0:4] += 1
        want[2:6, 2:6] += 1
        assert torch.equal(images.grad[0, 0], want)


class TestRandomHostOps:
    """One ``random.seed`` gives both packages the same crops, flips and choices."""

    PP = ("random_choice(['random_resized_crop(48)', 'identity'], [0.5, 0.5])|flip|to_tensor|"
          "normalize(minus_one_to_one)|resize_to_token_budget(16, 12)|patchify(16, 12)")

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_default_style_pipeline_is_bit_identical(self, seed):
        rng = np.random.default_rng(seed)
        imgs = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) for h, w in ((70, 90), (64, 40), (33, 120))]
        random.seed(seed)
        want = [j_build_transform(self.PP)(im) for im in imgs]
        random.seed(seed)
        got = [t_build_transform(self.PP)(im) for im in imgs]
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(np.asarray(g[key]), np.asarray(w[key]), err_msg=key)

    def test_each_op_draws_like_jax(self):
        img = Image.fromarray(np.random.default_rng(9).integers(0, 256, (50, 80, 3), dtype=np.uint8))
        for name, args in (("random_resized_crop", (32,)), ("flip", (0.5,)),
                           ("random_resized_crop", (24, (0.9, 1.0), (3.0, 4.0)))):  # the fallback branch
            for seed in range(4):
                random.seed(seed)
                want = np.asarray(j_ops.OPS[name](*args)(img))
                random.seed(seed)
                got = np.asarray(t_ops.OPS[name](*args)(img))
                np.testing.assert_array_equal(got, want, err_msg=f"{name} seed {seed}")

    def test_random_choice_checks_its_arguments(self):
        with pytest.raises(ValueError):
            t_ops.random_choice([], [])
        with pytest.raises(ValueError):
            t_ops.random_choice(["identity"], [0.5, 0.5])
