"""The port's DiT against the JAX package's (``vitok_tpu.models.dit``).

The JAX params (init from a key, then the adaLN ``mod`` linears and every
norm gain redrawn with numpy so that every block matters: adaLN-zero starts
them at zero) go through ``dit_from_jax_params`` into the port's ``DiT``;
the same numpy latents, timesteps and classes go through both.

Tolerances. float32 forward: atol 1e-4 against ``dit.apply`` (2e-6 measured;
sums in another order), with and without positions, class and register
tokens, the CFG null class, and each ``attn_impl``. int8 (``DiT.quantize()``
against the JAX ``quantize()``): rel L2 1e-3, as the int8 autoencoder (a code
at a rounding tie can flip), with the JAX int8 block routed as on its chip
(its gates' backend check lifted, its Pallas kernels interpreted). Parameter gradients of the flow-matching loss
with the random draws injected: rel L2 1e-4 over all parameters against
``jax.value_and_grad``, loss within 1e-5. Weights there and back: equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu.models import dit as j_dit
from vitok_torch.models import dit as t_dit
from vitok_torch.scripts.train_dit import flow_matching_loss
from vitok_torch.utils.params_io import dit_from_jax_params, dit_to_jax_params

from tests.test_torch_quant import jax_tpu_routing

torch.set_num_threads(1)

SMALL = dict(width=128, depth=2, heads=2, code_width=8, text_dim=10)
ATOL = 1e-4


def jax_dit_params(cfg, seed=0):
    """JAX init, then mod kernels ~ N(0, 0.05^2), mod biases ~ N(0, 0.5^2)
    and every norm and LayerScale gain ~ U(0.5, 1.5), from numpy."""
    params = jax.tree_util.tree_map(np.array, j_dit.init_params(cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed + 1)
    blk = params["blocks"]
    blk["mod"]["kernel"] = (0.05 * rng.standard_normal(blk["mod"]["kernel"].shape)).astype(np.float32)
    blk["mod"]["bias"] = (0.5 * rng.standard_normal(blk["mod"]["bias"].shape)).astype(np.float32)
    nodes = [(blk["norm1"], "scale"), (blk["attn"]["norm_q"], "scale"), (blk["attn"]["norm_k"], "scale")]
    if "layer_scale" in blk:
        nodes.append((blk["layer_scale"], "gamma"))
    for node, key in nodes:
        node[key] = rng.uniform(0.5, 1.5, node[key].shape).astype(np.float32)
    return params


def dit_input(b=2, n=16, c=8, seed=0, with_pos=True, classes=10):
    rng = np.random.default_rng(seed)
    d = {
        "z": rng.standard_normal((b, n, c)).astype(np.float32),
        "t": rng.uniform(0, 1000, (b,)).astype(np.float32),
        "context": rng.integers(0, classes, (b,)).astype(np.int32),
    }
    if with_pos:
        side = int(np.sqrt(n))
        yy, xx = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        d["row_idx"] = np.tile(yy.reshape(1, -1), (b, 1)).astype(np.int32)
        d["col_idx"] = np.tile(xx.reshape(1, -1), (b, 1)).astype(np.int32)
    return d


def both(cfg_kw, inp, seed=0, quantize=False):
    cfg = j_dit.DiTConfig(**cfg_kw)
    params = jax_dit_params(cfg, seed)
    jm = j_dit.DiT(params=jax.tree_util.tree_map(jnp.asarray, params), compute_dtype=jnp.float32, **cfg_kw)
    tm = t_dit.DiT(state_dict=dit_from_jax_params(params, t_dit.DiTConfig(**cfg_kw)), device="cpu",
                   compute_dtype=torch.float32, **cfg_kw)
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    if quantize:
        jm.quantize()
        tm.quantize()
        want = jax_int8_apply(jm, jin)
    else:
        want = np.asarray(jm(jin))
    got = tm(inp).numpy()
    return got, want, tm, jm


def jax_int8_apply(jm, jin):
    """The JAX int8 DiT as its chip routes it (un-jitted, so that the lifted
    gates are read at this call)."""
    with jax_tpu_routing():
        return np.asarray(j_dit.apply(jm.params, jin, jm.cfg, compute_dtype=jnp.float32))


class TestForward:
    @pytest.mark.parametrize("attn_impl", ["auto", "fused", "xla"])
    def test_matches_jax(self, attn_impl):
        kw = dict(SMALL, attn_impl=attn_impl)
        if attn_impl == "fused":  # the JAX kernel runs only on its chip: hold "fused" to its "xla"
            got, _, _, _ = both(kw, dit_input())
            _, want, _, _ = both(dict(SMALL, attn_impl="xla"), dit_input())
        else:
            got, want, _, _ = both(kw, dit_input())
        assert got.shape == (2, 16, 8)
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_without_positions(self):
        got, want, _, _ = both(SMALL, dit_input(with_pos=False))
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_non_square_implicit_grid(self):
        got, want, _, _ = both(SMALL, dit_input(n=24, with_pos=False))
        assert got.shape == (2, 24, 8)
        np.testing.assert_allclose(got, want, atol=ATOL)

    @pytest.mark.parametrize("class_token,reg_tokens", [(True, 0), (False, 3), (True, 2)])
    def test_special_tokens(self, class_token, reg_tokens):
        kw = dict(SMALL, class_token=class_token, reg_tokens=reg_tokens)
        got, want, tm, _ = both(kw, dit_input())
        assert tm.num_special_tokens == int(class_token) + reg_tokens
        assert got.shape == (2, 16, 8)  # the special tokens are stripped
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_layer_scale_and_head_dim_64(self):
        kw = dict(SMALL, use_layer_scale=True, layer_scale_init=1.0)
        got, want, _, _ = both(kw, dit_input())
        np.testing.assert_allclose(got, want, atol=ATOL)

    def test_cfg_null_class_by_batch_doubling(self):
        inp = dit_input(b=2)
        doubled = {k: np.concatenate([v, v]) for k, v in inp.items()}
        doubled["context"][2:] = SMALL["text_dim"]  # the null class
        got, want, _, _ = both(SMALL, doubled)
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert np.abs(got[:2] - got[2:]).max() > 1e-3, "the class conditions the prediction"
        # An index past the null class clips to it, as in the JAX package.
        over = dict(doubled, context=np.array([0, 1, 99, 99], np.int32))
        got2, _, _, _ = both(SMALL, over)
        np.testing.assert_allclose(got2[2:], got[2:], atol=1e-6)

    def test_no_context(self):
        inp = dit_input()
        inp["context"] = None
        cfg = j_dit.DiTConfig(**SMALL)
        params = jax_dit_params(cfg)
        want = np.asarray(j_dit.apply(jax.tree_util.tree_map(jnp.asarray, params),
                                      {k: jnp.asarray(v) for k, v in inp.items() if v is not None},
                                      cfg, compute_dtype=jnp.float32))
        tm = t_dit.DiT(state_dict=dit_from_jax_params(params), device="cpu",
                       compute_dtype=torch.float32, **SMALL)
        np.testing.assert_allclose(tm(inp).numpy(), want, atol=ATOL)

    def test_timestep_embedding(self):
        t = np.array([0.0, 1.0, 500.0, 999.0], np.float32)
        for dim in (256, 7):
            want = np.asarray(j_dit.timestep_embedding(jnp.asarray(t), dim))
            got = t_dit.timestep_embedding(torch.from_numpy(t), dim).numpy()
            # fp32 cos/sin of arguments up to 999: half an ulp of the argument is 3e-5
            np.testing.assert_allclose(got, want, atol=1e-4)
            assert np.abs(got).max() <= 1.0

    def test_variant_dsl(self):
        for v in ("Bd4/256", "L/256", "w128_d2_h2/64", "G"):
            assert t_dit.decode_variant(v) == j_dit.decode_variant(v)
        a, b = t_dit.DiTConfig(**SMALL), j_dit.DiTConfig(**SMALL)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.head_dim, a.ffn_dim) == (b.head_dim, b.ffn_dim)

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(Exception):
            t_dit.DiT(**SMALL)

    def test_bf16_forward_finite(self):
        tm = t_dit.DiT(device="cpu", seed=3, **SMALL)
        out = tm(dit_input())
        assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


class TestInt8:
    def test_quantized_matches_jax(self):
        got, want, tm, _ = both(dict(SMALL, width=256, heads=4), dit_input(n=64), quantize=True)
        assert tm.is_quantized
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-3, rel

    def test_quantized_pytree_round_trip(self):
        kw = dict(SMALL, width=256, heads=4)
        cfg = j_dit.DiTConfig(**kw)
        jm = j_dit.DiT(params=jax.tree_util.tree_map(jnp.asarray, jax_dit_params(cfg)),
                       compute_dtype=jnp.float32, **kw).quantize()
        qparams = jax.tree_util.tree_map(np.asarray, jm.params)
        state = dit_from_jax_params(qparams)
        assert state["blocks.0.attn.qkv_proj.weight_int8"].dtype == torch.int8
        tm = t_dit.DiT(state_dict=state, device="cpu", compute_dtype=torch.float32, **kw)
        inp = dit_input(n=64)
        want = jax_int8_apply(jm, {k: jnp.asarray(v) for k, v in inp.items()})
        got = tm(inp).numpy()
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-3
        back = dit_to_jax_params(tm.state_dict())
        flat_a, tree_a = jax.tree_util.tree_flatten(qparams)
        flat_b, tree_b = jax.tree_util.tree_flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_quantize_is_idempotent_and_keeps_mod(self):
        tm = t_dit.DiT(device="cpu", compute_dtype=torch.float32, **SMALL).quantize()
        keys = set(tm.state_dict())
        assert tm.quantize() is tm and set(tm.state_dict()) == keys
        assert "blocks.0.mod.weight" in keys and "blocks.0.ffn.fc1.weight_int8" in keys
        assert "final.proj.weight" in keys and "input_proj.weight" in keys

    def test_int8_cannot_train(self):
        tm = t_dit.DiT(device="cpu", compute_dtype=torch.float32, **SMALL).quantize()
        with pytest.raises(ValueError, match="int8"):
            tm(dit_input(), deterministic=False)


class TestWeights:
    def test_there_and_back(self):
        kw = dict(SMALL, class_token=True, reg_tokens=2, use_layer_scale=True)
        params = jax_dit_params(j_dit.DiTConfig(**kw))
        state = dit_from_jax_params(params, t_dit.DiTConfig(**kw))
        tm = t_dit.DiT(state_dict=state, device="cpu", compute_dtype=torch.float32, **kw)
        back = dit_to_jax_params(tm.state_dict())
        flat_a, tree_a = jax.tree_util.tree_flatten(params)
        flat_b, tree_b = jax.tree_util.tree_flatten(back)
        assert tree_a == tree_b
        for a, b in zip(flat_a, flat_b):
            np.testing.assert_array_equal(a, b)

    def test_depth_is_checked(self):
        params = jax_dit_params(j_dit.DiTConfig(**SMALL))
        with pytest.raises(ValueError, match="depth"):
            dit_from_jax_params(params, t_dit.DiTConfig(**dict(SMALL, depth=3)))

    def test_init_is_adaln_zero_and_seeded(self):
        a = t_dit.DiT(device="cpu", seed=1, compute_dtype=torch.float32, **SMALL)
        b = t_dit.DiT(device="cpu", seed=1, compute_dtype=torch.float32, **SMALL)
        c = t_dit.DiT(device="cpu", seed=2, compute_dtype=torch.float32, **SMALL)
        assert not a.blocks[0].mod.weight.any() and not a.blocks[0].mod.bias.any()
        assert torch.equal(a.input_proj.weight, b.input_proj.weight)
        assert not torch.equal(a.input_proj.weight, c.input_proj.weight)
        assert a.num_params() == sum(x.size for x in jax.tree_util.tree_leaves(
            j_dit.init_params(j_dit.DiTConfig(**SMALL), jax.random.key(0))))


class TestFlowMatchingGradients:
    """The trainer's loss and its parameter gradients with the random draws
    injected, against ``jax.value_and_grad`` of the JAX trainer's loss."""

    @pytest.mark.parametrize("attn_impl,checkpoint", [("auto", 0), ("fused", 0), ("auto", 1)])
    def test_matches_jax_value_and_grad(self, attn_impl, checkpoint):
        kw = dict(SMALL, checkpoint=checkpoint)
        cfg = j_dit.DiTConfig(**kw)
        params = jax_dit_params(cfg)
        rng = np.random.default_rng(4)
        b, n, c = 3, 16, 8
        z = rng.standard_normal((b, n, c)).astype(np.float32)
        labels = rng.integers(0, 10, (b,)).astype(np.int32)
        draws = {"sigma": rng.uniform(0, 1, (b,)).astype(np.float32),
                 "eps": rng.standard_normal((b, n, c)).astype(np.float32),
                 "drop": np.array([False, True, False])}
        shift, num_classes = 2.0, 10

        def loss_fn(p):  # scripts/train_dit.py::loss_fn with the draws given
            sigma = jnp.asarray(draws["sigma"])
            sigma = shift * sigma / (1.0 + (shift - 1.0) * sigma)
            eps, zz = jnp.asarray(draws["eps"]), jnp.asarray(z)
            x_sigma = (1.0 - sigma[:, None, None]) * zz + sigma[:, None, None] * eps
            ctx = jnp.where(jnp.asarray(draws["drop"]), num_classes, jnp.asarray(labels))
            v = j_dit.apply(p, {"z": x_sigma, "t": sigma * 1000.0, "context": ctx}, cfg,
                            compute_dtype=jnp.float32, deterministic=False)
            return jnp.mean((v.astype(jnp.float32) - (eps - zz)) ** 2)

        want_loss, want_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
        want_state = dit_from_jax_params(jax.tree_util.tree_map(np.asarray, want_grads))

        tm = t_dit.DiT(state_dict=dit_from_jax_params(params), device="cpu", compute_dtype=torch.float32,
                       param_dtype=torch.float32, trainable=True, **dict(kw, attn_impl=attn_impl))
        loss = flow_matching_loss(tm, z, labels, num_classes, cfg_dropout=0.1, shift=shift, draws=draws)
        names, ps = zip(*tm.named_parameters())
        grads = torch.autograd.grad(loss, ps)
        assert abs(loss.item() - float(want_loss)) <= 1e-5
        num = sum((g.double() - want_state[k].double()).square().sum() for k, g in zip(names, grads))
        den = sum(want_state[k].double().square().sum() for k in names)
        assert (num / den).sqrt().item() <= 1e-4
        assert set(names) == set(want_state)

    def test_draws_come_from_the_generator(self):
        tm = t_dit.DiT(device="cpu", compute_dtype=torch.float32, param_dtype=torch.float32,
                       trainable=True, **SMALL)
        z = np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32)
        run = lambda s: flow_matching_loss(tm, z, [1, 2], 10,
                                           generator=torch.Generator().manual_seed(s)).item()
        assert run(1) == run(1) and run(1) != run(2)
