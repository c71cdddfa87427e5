"""The port's feature extractors' resize and features against the JAX package.

The port builds every resize from the weight matrices of
``jax.image.resize`` (``_resize_weights_np``), which equal the JAX
package's bit for bit; the resize itself, one separable product per shape
group, is held for bicubic and bilinear, up and down, at odd sizes, to the
JAX package's bucketed route (an einsum on those weights) within 1e-5, to an
fp64 product on the same weights within 1e-6, and to ``jax.image.resize``
within 1e-4: that route builds its weights in JAX, and they differ from the
numpy ones by up to 1e-6 each, so it differs from the other two by up to
2.6e-5 here (an upsampling to 97 of values up to 1.2); the JAX package holds
its two routes to each other within 1e-4 (``tests/test_eval_features.py``).
Random-projection features agree within 1e-5; the InceptionV3 and
DINO ViT feature functions, loaded on both sides from state dicts this
file writes, agree within 1e-4 of the largest feature (fp32 convolutions and
products in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu import eval_features as j_ef
from vitok_torch import eval_features as t_ef

torch.set_num_threads(1)

SHAPES = [(3, 37, 53), (3, 37, 53), (3, 20, 71), (3, 64, 64), (3, 37, 53)]


def _images(shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.2, 1.2, s).astype(np.float32) for s in shapes]  # some values outside the clamp


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("in_out_pad", [(37, 29, 37), (37, 97, 256), (71, 16, 256), (16, 16, 16), (5, 299, 7)])
def test_resize_weights_are_the_jax_packages_bit_for_bit(method, in_out_pad):
    n_in, n_out, pad = in_out_pad
    got = t_ef._resize_weights_np(n_in, n_out, method, pad)
    want = j_ef._resize_weights_np(n_in, n_out, method, pad)
    assert got.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("size", [29, 97])  # down and up
@pytest.mark.parametrize("bucketed", [False, True])
def test_resize_matches_both_jax_routes(method, size, bucketed):
    images = _images()
    got = t_ef.resize_batch([torch.from_numpy(x) for x in images], size, method, bucketed=bucketed).numpy()
    for j_bucketed, atol in ((True, 1e-5), (False, 1e-4)):
        want = np.asarray(j_ef._resize_batch([jnp.asarray(x) for x in images], size, method, bucketed=j_bucketed))
        assert got.shape == want.shape == (len(images), 3, size, size)
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    exact = [np.einsum("chw,ho,wp->cop", x.astype(np.float64),
                       j_ef._resize_weights_np(x.shape[1], size, method, x.shape[1]).astype(np.float64),
                       j_ef._resize_weights_np(x.shape[2], size, method, x.shape[2]).astype(np.float64))
             for x in images]
    np.testing.assert_allclose(got, np.clip(np.stack(exact), -1, 1), rtol=0, atol=1e-6)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_resize_is_differentiable_and_refuses_an_unknown_method():
    x = torch.from_numpy(_images([(3, 20, 30)])[0] * 0.5).requires_grad_(True)
    t_ef.resize_batch([x], 16, "bilinear")[0].sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    with pytest.raises(ValueError, match="unknown resize method"):
        t_ef.resize_batch([x], 16, "lanczos3")


@pytest.mark.parametrize("bucketed", [False, True])
def test_random_projection_features_match_jax(bucketed):
    images = _images()
    got = t_ef.random_projection_feature_fn(dim=32, seed=3, bucketed_resize=bucketed)(
        [torch.from_numpy(x) for x in images])
    want = np.asarray(j_ef.random_projection_feature_fn(dim=32, seed=3, bucketed_resize=bucketed)(
        [jnp.asarray(x) for x in images]))
    assert got.shape == want.shape == (len(images), 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_inception_features_from_one_state_dict_match_jax(tmp_path):
    """Both packages' ``inception_feature_fn`` on a pytorch_fid-named state
    dict this test writes, at 75² (the feed contract: bicubic, clamp, [0, 1])."""
    from tests.test_inception import make_random_state

    path = str(tmp_path / "pt_inception.pth")
    torch.save({k: torch.from_numpy(v) for k, v in make_random_state(seed=4).items()}, path)
    images = _images(SHAPES[:3], seed=1)
    got = t_ef.inception_feature_fn(path, size=75, device="cpu")([torch.from_numpy(x) for x in images])
    want = np.asarray(j_ef.inception_feature_fn(path, size=75)([jnp.asarray(x) for x in images]))
    assert got.shape == want.shape == (3, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_dino_features_from_one_state_dict_match_jax(tmp_path):
    """Both packages' ``dino_feature_fn`` (ViT-S/16, a timm-named state dict
    this test writes, pretrained grid 14) at 64²: bicubic resize and clamp,
    ImageNet normalisation, position embeddings shrunk from 14² to 4², CLS."""
    from tests.test_torch_vit_features import timm_state

    path = str(tmp_path / "dino_s16.pth")
    torch.save(timm_state(width=384, depth=12, heads=6, grid=14, seed=5), path)
    images = _images(SHAPES[:3], seed=2)
    got = t_ef.dino_feature_fn(path, size=64, model_size="S", device="cpu")([torch.from_numpy(x) for x in images])
    want = np.asarray(j_ef.dino_feature_fn(path, size=64, model_size="S")([jnp.asarray(x) for x in images]))
    assert got.shape == want.shape == (3, 384)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_feature_functions_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ef.inception_feature_fn()
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ef.dino_feature_fn()
