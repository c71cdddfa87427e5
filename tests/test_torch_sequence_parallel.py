"""Sequence parallelism (``vitok_torch.parallel.sequence``) over gloo on the
CPU, against the single-device port and the JAX package.

One spawn of two processes (``dryrun_multiprocess.sequence_job``, a
``file://`` rendezvous, one thread each) runs, with the token axis split
over ``seq=2``: ``halo_attention`` on 32 tokens (window 5, a tail mask),
the token-sharded AE forward, loss and gradients of the tiny AE (width 256,
four heads, window 2, 16 tokens an image) with and without padding, and then
a ``data=2`` AdamW step of the same model. Limits (fp32):

* halo attention: live rows max abs 1e-5 against the global windowed
  attention, dead rows exactly 0;
* the SP forward on valid tokens: max abs 1e-5; the loss rel 1e-5 and every
  gradient rel L2 1e-5 against the single-device port;
* against the JAX package: the SP gradients rel L2 1e-4 against
  ``jax.value_and_grad`` of the same loss (ROADMAP's gradient tolerance),
  and the two-process step's parameters rel L2 1e-4 against the JAX
  single-device ``make_train_step`` on the same numpy parameters and batch
  (``params_io`` carries them across).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu import train_lib as j_tl
from vitok_tpu.models import ae as j_ae
from vitok_torch import losses as t_losses
from vitok_torch.ops.attention import dot_product_attention
from vitok_torch.scripts import dryrun_multiprocess as dm
from vitok_torch.utils.params_io import to_jax_params

torch.set_num_threads(1)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("gloo2"))
    dm.spawn("sequence_job", 2, wd)
    return [dict(np.load(f"{wd}/sequence_{r}.npz")) for r in range(2)]


def _batch(padded):
    grids = [(4, 4), (2, 4)] if padded else [(4, 4), (4, 4)]
    gbatch, _ = dm.make_global_batch(seed=4, b=2, n=16, grids=grids)
    return gbatch


def _single_device(padded):
    """The unsharded port: output, loss and gradients by parameter name."""
    model = dm.build_model(sw=2)
    batch = dm._torch_batch(_batch(padded))
    out = model(batch)["patches"]
    train = model(batch, deterministic=False)["patches"]
    loss = t_losses.charbonnier_loss(train, batch["patches"], batch["patch_mask"])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return out, float(loss.detach()), dict(zip(names, grads)), model


def test_halo_attention_equals_global_windowed_attention(shards):
    rng = np.random.default_rng(3)
    b, n, h, d, sw = 2, 32, 2, 64, 5
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)) for _ in range(3))
    pm = torch.from_numpy(np.arange(n)[None, :] < np.array([[n], [23]]))
    want = dot_product_attention(q, k, v, patch_mask=pm, sliding_window=sw, impl="xla")
    got = torch.from_numpy(np.concatenate([s["halo"] for s in shards], axis=1))
    assert (got[pm] - want[pm]).abs().max().item() <= 1e-5
    assert not got[~pm].any()


@pytest.mark.parametrize("padded", [False, True])
def test_sp_forward_equals_single_device(shards, padded):
    want, *_ = _single_device(padded)
    got = torch.from_numpy(np.concatenate([s[f"fwd_{'pad' if padded else 'full'}"] for s in shards], axis=1))
    valid = torch.from_numpy(_batch(padded)["patch_mask"])
    assert (got[valid] - want[valid]).abs().max().item() <= 1e-5


@pytest.mark.parametrize("padded", [False, True])
def test_sp_loss_and_gradients_equal_single_device(shards, padded):
    _, loss, grads, _ = _single_device(padded)
    tag = "pad" if padded else "full"
    for s in shards:  # every shard returns the whole loss and gradients
        assert abs(float(s[f"loss_{tag}"]) - loss) <= 1e-5 * abs(loss)
        for name, g in grads.items():
            assert rel_l2(s[f"grad_{tag}/{name}"], g.numpy()) <= 1e-5, name


@pytest.mark.parametrize("padded", [False, True])
def test_sp_gradients_match_jax(shards, padded):
    _, _, _, model = _single_device(padded)
    cfg = j_ae.AEConfig.from_variant(dm.VARIANT, sw=2)
    params = to_jax_params({k: v.detach() for k, v in model.state_dict().items()})
    batch = {k: jnp.asarray(v) for k, v in _batch(padded).items()}
    (want, _), want_g = jax.value_and_grad(j_tl.compute_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), batch, cfg, j_tl.LossConfig(ssim_weight=0.0),
        jax.random.key(0), compute_dtype=jnp.float32)
    tag = "pad" if padded else "full"
    got = to_jax_params({n[len(f"grad_{tag}/"):]: torch.from_numpy(v) for n, v in shards[0].items()
                         if n.startswith(f"grad_{tag}/")})
    assert abs(float(shards[0][f"loss_{tag}"]) - float(want)) <= 1e-5
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    for path, w in jax.tree_util.tree_flatten_with_path(want_g)[0]:
        assert rel_l2(flat_got[path], w) <= 1e-4, jax.tree_util.keystr(path)


def test_two_process_data_step_matches_jax_single_device(shards):
    """``data=2``: each process steps on its two images; the parameters
    after the step equal the JAX package's step on all four."""
    cfg = j_ae.AEConfig.from_variant(dm.VARIANT)
    params = to_jax_params({k: v.detach() for k, v in dm.build_model().state_dict().items()})
    gbatch, _ = dm.make_global_batch(seed=6, b=4)
    tx = j_tl.create_optimizer(j_tl.create_schedule("constant", dm.LR, 100, warmup_frac=0.0))
    state = j_tl.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = j_tl.make_train_step(cfg, tx, j_tl.LossConfig(ssim_weight=0.0), compute_dtype=jnp.float32, donate=False)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in gbatch.items()}, jax.random.key(1))
    for s in shards:
        assert abs(float(s["data_loss"]) - float(metrics["loss/total"])) <= 1e-5 * float(metrics["loss/total"])
        assert abs(float(s["data_grad_norm"]) - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
        got = to_jax_params({n[len("data_param/"):]: torch.from_numpy(v) for n, v in s.items()
                             if n.startswith("data_param/")})
        flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        for path, w in jax.tree_util.tree_flatten_with_path(state.params)[0]:
            assert rel_l2(flat_got[path], np.asarray(w)) <= 1e-4, jax.tree_util.keystr(path)


def test_halo_outside_a_sequence_parallel_forward_raises():
    from vitok_torch.parallel.sequence import halo_attention

    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(RuntimeError, match="outside a sequence-parallel forward"):
        halo_attention(q, q, q, None, 2)


def test_halo_impl_is_accepted_by_the_config_and_needs_a_window():
    from vitok_torch.models.ae import AEConfig

    assert AEConfig.from_variant(dm.VARIANT, attn_impl="halo:seq").attn_impl == "halo:seq"
    with pytest.raises(ValueError, match="attn_impl"):
        AEConfig.from_variant(dm.VARIANT, attn_impl="ring")
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="sliding window"):
        dot_product_attention(q, q, q, impl="halo:seq")
