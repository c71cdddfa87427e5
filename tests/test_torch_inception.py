"""The port's FID InceptionV3 (``vitok_torch.models.inception``) against the JAX package.

``init_inception_params(jax.random.key(s))`` carried across with
``inception_from_jax_params`` gives ``inception_apply``'s pool features at
75² and 299² (batch 2, fp32) within 1e-4 of the largest feature; so does a
pytorch_fid-named state dict this file writes (unfused BN), folded by the JAX
package's ``torch_inception_state_to_pytree`` on one side and read by the
port's ``load_inception`` from a ``.safetensors`` and a ``.pth`` on the
other. The FIDInceptionE_2 patch (Mixed_7c pools its pool branch with a max
pool) is in the table and changes the features.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_inception import make_random_state
from vitok_tpu.models import inception as J
from vitok_torch.models import inception as T
from vitok_torch.utils.params_io import inception_from_jax_params

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_init():
    """``init_inception_params(jax.random.key(0))``, jitted (about 10 s on the CPU, eager about 18 s)."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(J.init_inception_params)(jax.random.key(0)))


def _x(size, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (2, 3, size, size)).astype(np.float32)


def _close(got, want):
    assert got.shape == want.shape == (2, T.POOL_DIM)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("size", [75, 299])
def test_carried_jax_init_matches_inception_apply(jax_init, size):
    x = _x(size, seed=size)
    want = np.asarray(jax.jit(J.inception_apply)(jax_init, jnp.asarray(x)))
    model = T.InceptionV3(state_dict=inception_from_jax_params(jax_init), device="cpu")
    _close(model(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_pytorch_fid_state_dict_loads_both_ways(tmp_path, fmt):
    state = make_random_state(seed=7)
    path = str(tmp_path / f"pt_inception.{fmt}")
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(state, path)
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, path)
    x = _x(75, seed=1)
    want = np.asarray(J.inception_apply(J.torch_inception_state_to_pytree(state), jnp.asarray(x)))
    _close(T.load_inception(path, device="cpu")(torch.from_numpy(x)).numpy(), want)


def test_fid_e2_patch_max_pools_the_last_block(monkeypatch):
    """At 299² the last block pools an 8 x 8 map (at 75² a 1 x 1 one, where
    the two pools agree)."""
    pools = {name: payload[-1][0][0] for kind, name, payload in T.INCEPTION_LAYOUT if name.startswith("Mixed_7")}
    assert pools == {"Mixed_7a": "maxpool", "Mixed_7b": "avgpool_nip", "Mixed_7c": "maxpool"}
    model = T.InceptionV3(state_dict=T.fold_inception_state(make_random_state(seed=2)), device="cpu")
    x = torch.from_numpy(_x(299, seed=2))
    patched = model(x)
    # torchvision's average pool in place of the patch: other features
    layout = [(k, n, p[:-1] + ((("avgpool_nip", (3, 1, 1)),) + p[-1][1:],) if n == "Mixed_7c" else p)
              for k, n, p in T.INCEPTION_LAYOUT]
    monkeypatch.setattr(T, "INCEPTION_LAYOUT", layout)
    assert (model(x) - patched).abs().max() > 1e-3 * patched.abs().max()


def test_random_init_warns_and_draws_the_jax_distribution():
    with pytest.warns(UserWarning, match="NOT be comparable"):
        a = T.load_inception(None, device="cpu")
    b = T.InceptionV3(seed=0, device="cpu")
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    w = a.Mixed_6b.branch7x7_2.weight  # [O, I, 1, 7]: fan-in 7 * 128
    assert abs(float(w.std()) * np.sqrt(7 * 128) - 1.0) < 0.02 and float(a.Mixed_6b.branch7x7_2.bias.abs().max()) == 0
    shapes = jax.eval_shape(J.init_inception_params, jax.random.key(0))  # shapes only: no draw
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(v["w"].shape)) + v["b"].shape[0] for v in shapes.values())
    assert not any(p.requires_grad for p in a.parameters())
