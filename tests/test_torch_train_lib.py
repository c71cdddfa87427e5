"""The port's training core (``vitok_torch.train_lib``) against the JAX package.

Small float32 models on the CPU (width 128, heads of 64, 1-2 + 2-3 blocks,
64 or 256 tokens); the same JAX-initialised weights (gains drawn from
U(0.5, 1.5)) and the same numpy batches on both sides; the tile origins the
JAX package draws from its key are fed to the port. Tolerances:

* schedules against the optax schedules: rtol 1e-6 (optax evaluates them in
  float32, the port in Python floats) plus 1e-7 of the base rate;
* loss values 1e-5; parameter gradients rel L2 <= 1e-4 per leaf, also with
  the flash path on both sides (the Pallas backward in interpret mode
  against the port's autograd Function);
* three optimizer steps: parameters, EMA and grad norm rel L2 <= 1e-4, and
  the total parameter movement rel L2 <= 2e-2 per leaf: the first Adam step
  is the sign of each gradient, which flips where two float32 gradients
  straddle zero, so the movement agrees far less tightly than the values;
  with a bf16 first moment a float32 difference can also flip a bf16
  rounding (2^-8 of the moment), so parameters and EMA are held to 5e-4;
* inside the port: grad accumulation and activation checkpointing give the
  plain gradients within 1e-6, and a resumed run repeats an uninterrupted
  one bit for bit.
"""

import dataclasses
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import vitok_tpu.ops.flash_attention as j_fl
from tests.test_torch_ae import jax_params, make_batch, port_model
from vitok_tpu import train_lib as j_tl
from vitok_tpu.models import ae as j_ae
from vitok_tpu.pp import ops as j_ops
from vitok_tpu.utils import params_io as j_io
from vitok_torch import train_lib as t_tl
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.utils import checkpoint as t_ckpt
from vitok_torch.utils.params_io import from_jax_params, to_jax_params

torch.set_num_threads(1)

VARIANT = "w128_d2_h2-w128_d2_h2/1x16x8"
TOKENS, PATCH = 64, 16
GRIDS = [(8, 8), (6, 5)]
LOSS = dict(ssim_weight=0.1, tile_size=64, n_tiles=2, patch=PATCH, ssim_grid=(8, 8))


def rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(path): np.asarray(x) for path, x in flat}


def assert_trees_close(got, want, limit, what):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for key in want:
        assert rel_l2(got[key], want[key]) <= limit, f"{what} {key}: rel L2 {rel_l2(got[key], want[key]):.3e}"


def trainable_model(cfg, params, attn_impl="auto", **overrides):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(t_ae.AEConfig)}
    kw.update(attn_impl=attn_impl, **overrides)
    return t_ae.AE(state_dict=from_jax_params(params, cfg), compute_dtype=torch.float32, device="cpu",
                   param_dtype=torch.float32, trainable=True, **kw)


def jax_tile_indices(batch, loss_cfg, step_rng):
    """The origins ``vitok_tpu.train_lib.compute_loss`` draws from ``step_rng``."""
    _, tile_rng = jax.random.split(step_rng)
    gr, gc = loss_cfg.ssim_grid
    tile = (min(loss_cfg.tile_size, gr * loss_cfg.patch), min(loss_cfg.tile_size, gc * loss_cfg.patch))
    idx = j_ops.sample_tile_indices(jnp.asarray(batch["orig_height"]), jnp.asarray(batch["orig_width"]),
                                    n_tiles=loss_cfg.n_tiles, tile_size=tile, rng=tile_rng)
    return tuple(torch.from_numpy(np.array(i)) for i in idx)


def port_grads(model, batch, loss_cfg, **kw):
    loss, metrics = t_tl.compute_loss(model, batch, loss_cfg, **kw)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), metrics, dict(zip(names, grads))


class TestSchedules:
    STEPS = [0, 1, 2, 4, 5, 6, 10, 37, 50, 99, 100, 150]

    @pytest.mark.parametrize("name", ["cosine", "linear", "exponential", "constant"])
    @pytest.mark.parametrize("warmup_frac,end_lr_frac", [(0.05, 0.0), (0.0, 0.1)])
    def test_matches_optax(self, name, warmup_frac, end_lr_frac):
        want = j_tl.create_schedule(name, 3e-4, 100, warmup_frac, end_lr_frac, decay_rate=0.2)
        got = t_tl.create_schedule(name, 3e-4, 100, warmup_frac, end_lr_frac, decay_rate=0.2)
        for step in self.STEPS:
            assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=3e-11), (name, step)

    def test_unknown_schedule_raises(self):
        with pytest.raises(ValueError):
            t_tl.create_schedule("step", 1e-3, 10)


class TestOptimizerPieces:
    def test_decay_mask_is_the_linear_weights(self):
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        model = trainable_model(cfg, jax_params(cfg))
        mask = t_tl.decay_mask(model)
        assert set(mask) == {n for n, _ in model.named_parameters()}
        for name, decayed in mask.items():
            is_matrix = name.endswith(".weight") and not name.endswith(("norm1.weight", "norm_q.weight", "norm_k.weight"))
            assert decayed == is_matrix, name
        # the same split as the JAX package's leaf-name mask
        j_mask = leaves(j_tl._decay_mask(jax_params(cfg)))
        assert sum(mask.values()) == 4 + 4 * (cfg.encoder_depth + cfg.decoder_depth)
        assert sum(bool(v) for v in j_mask.values()) == 4 + 4 * 2  # stacked over depth

    def test_muon_is_not_ported(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_tl.create_optimizer(lambda s: 1e-3, optimizer="muon")
        with pytest.raises(ValueError):
            t_tl.create_optimizer(lambda s: 1e-3, optimizer="sgd")

    def test_int8_model_refuses_training(self):
        cfg = t_ae.AEConfig.from_variant(VARIANT)
        model = t_ae.AE(**dataclasses.asdict(cfg), device="cpu", compute_dtype=torch.float32).quantize()
        batch = {k: torch.from_numpy(v) for k, v in make_batch(2, TOKENS, PATCH, GRIDS).items()}
        with pytest.raises(ValueError, match="int8"):
            model(batch, deterministic=False)
        with pytest.raises(ValueError, match="int8"):
            t_ae.AE(**dataclasses.asdict(cfg), state_dict=model.state_dict(), device="cpu", trainable=True)

    def test_parameters_require_grad_only_when_asked(self):
        cfg = t_ae.AEConfig.from_variant(VARIANT)
        frozen = t_ae.AE(**dataclasses.asdict(cfg), device="cpu")
        assert not any(p.requires_grad for p in frozen.parameters())
        assert frozen.patch_embed.weight.dtype == torch.bfloat16
        model = t_ae.AE(**dataclasses.asdict(cfg), device="cpu", param_dtype=torch.float32, trainable=True)
        assert all(p.requires_grad and p.dtype == torch.float32 for p in model.parameters())
        batch = {k: torch.from_numpy(v) for k, v in make_batch(2, TOKENS, PATCH, GRIDS).items()}
        assert model(batch)["patches"].grad_fn is None  # inference stays under no_grad
        out = model(batch, deterministic=False)["patches"]
        assert out.grad_fn is not None and out.dtype == torch.bfloat16


class TestTrainingRoutes:
    def test_fused_kernel_is_an_inference_path(self, monkeypatch):
        """At 64 tokens inference takes the fused attention on every block;
        the training forward takes the unfused composition with
        ``attn_impl="auto"`` and the fused one only when asked by name (the
        JAX package's gate)."""
        from vitok_torch.ops import fused_attention as t_fa

        calls = []
        orig = t_fa.fused_qkv_attention_plain
        monkeypatch.setattr(t_fa, "fused_qkv_attention_plain", lambda *a, **k: calls.append(1) or orig(*a, **k))
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        batch = {k: torch.from_numpy(v) for k, v in make_batch(2, TOKENS, PATCH, GRIDS).items()}
        valid = batch["patch_mask"]
        model = trainable_model(cfg, params)
        want = model(batch)["patches"]
        assert len(calls) == 4
        got = model(batch, deterministic=False)["patches"]
        assert len(calls) == 4 and got.grad_fn is not None
        torch.testing.assert_close(got[valid], want[valid], atol=1e-5, rtol=0)
        named = trainable_model(cfg, params, attn_impl="fused")
        out = named(batch, deterministic=False)["patches"]
        assert len(calls) == 8
        out[valid].sum().backward()
        assert named.encoder_blocks[0].attn.qkv_proj.weight.grad is not None


class TestLossAndGradients:
    @pytest.mark.parametrize("sw", [None, 5])
    def test_loss_and_parameter_gradients_match_jax(self, sw):
        cfg = j_ae.AEConfig.from_variant(VARIANT, sw=sw)
        params = jax_params(cfg)
        batch = make_batch(len(GRIDS), TOKENS, PATCH, GRIDS)
        j_loss_cfg, t_loss_cfg = j_tl.LossConfig(**LOSS), t_tl.LossConfig(**LOSS)
        rng = jax.random.key(3)
        (want, want_m), want_g = jax.value_and_grad(j_tl.compute_loss, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()},
            cfg, j_loss_cfg, rng, compute_dtype=jnp.float32)
        got, got_m, grads = port_grads(trainable_model(cfg, params), batch, t_loss_cfg,
                                       tile_indices=jax_tile_indices(batch, j_loss_cfg, rng))
        assert abs(got - float(want)) <= 1e-5
        for key in ("loss/charbonnier", "loss/ssim", "loss/total"):
            assert abs(float(got_m[key]) - float(want_m[key])) <= 1e-5, key
        assert_trees_close(to_jax_params(grads), want_g, 1e-4, "grad")

    def test_charbonnier_weight_reaches_the_loss(self):
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        model = trainable_model(cfg, jax_params(cfg))
        batch = make_batch(len(GRIDS), TOKENS, PATCH, GRIDS)
        one, m = t_tl.compute_loss(model, batch, t_tl.LossConfig(ssim_weight=0.0))
        half, _ = t_tl.compute_loss(model, batch, t_tl.LossConfig(ssim_weight=0.0, charbonnier_weight=0.5))
        assert "loss/ssim" not in m and float(half.detach()) == pytest.approx(0.5 * float(one.detach()), rel=1e-6)

    def test_flash_path_gradients_match_pallas_backward(self):
        """256 tokens with the flash kernels forced on both sides: the JAX
        package's Pallas forward and dq/dkv kernels in interpret mode, the
        port's autograd Function (plain forward and plain backward here)."""
        variant, grids = "w128_d1_h2-w128_d2_h2/1x16x8", [(16, 16), (12, 10)]
        cfg = j_ae.AEConfig.from_variant(variant, sw=40, attn_impl="pallas")
        params = jax_params(cfg)
        batch = make_batch(2, 256, PATCH, grids)
        loss = dict(LOSS, ssim_grid=(16, 16))
        rng = jax.random.key(4)
        old, j_fl._BWD_IMPL = j_fl._BWD_IMPL, "pallas"
        try:
            (want, _), want_g = jax.value_and_grad(j_tl.compute_loss, has_aux=True)(
                jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()},
                cfg, j_tl.LossConfig(**loss), rng, compute_dtype=jnp.float32)
        finally:
            j_fl._BWD_IMPL = old
        calls = []
        bwd = t_fl.flash_attention_bwd  # count the autograd Function's backward calls
        t_fl.flash_attention_bwd = lambda *a: calls.append(1) or bwd(*a)
        try:
            got, _, grads = port_grads(trainable_model(cfg, params, attn_impl="flash"), batch, t_tl.LossConfig(**loss),
                                       tile_indices=jax_tile_indices(batch, j_tl.LossConfig(**loss), rng))
        finally:
            t_fl.flash_attention_bwd = bwd
        assert len(calls) == cfg.encoder_depth + cfg.decoder_depth
        assert abs(got - float(want)) <= 1e-5
        assert_trees_close(to_jax_params(grads), want_g, 1e-4, "grad")

    def test_drop_path_with_injected_uniforms_matches_jax(self):
        cfg = j_ae.AEConfig.from_variant("w128_d1_h2-w128_d3_h2/1x16x8", drop_path_rate=0.6)
        params = jax_params(cfg)
        grids = [(4, 4), (3, 5), (2, 2), (4, 3)]
        batch = make_batch(4, 16, PATCH, grids)
        rng = jax.random.key(11)
        want = j_ae.forward_apply(jax.tree_util.tree_map(jnp.asarray, params),
                                  {k: jnp.asarray(v) for k, v in batch.items()}, cfg,
                                  deterministic=False, rng=rng, compute_dtype=jnp.float32)["patches"]
        _, dec_rng = jax.random.split(rng)
        uniforms = np.stack([np.asarray(jax.random.uniform(r, (4,), jnp.float32))
                             for r in jax.random.split(dec_rng, cfg.decoder_depth)])
        model = trainable_model(cfg, params)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got = model(tb, deterministic=False, drop_uniforms=torch.from_numpy(uniforms))["patches"].detach().numpy()
        valid = batch["patch_mask"]
        np.testing.assert_allclose(got[valid], np.asarray(want)[valid], atol=1e-4, rtol=0)
        gates = torch.stack(model.drop_path_gates(4, uniforms=torch.from_numpy(uniforms))).flatten(1)
        assert (gates[0] == 1).all() and (gates[1:] == 0).any() and (gates[1:] > 1).any()
        # drawn from a generator: reproducible, and off when the rate is 0
        a = model(tb, deterministic=False, generator=torch.Generator().manual_seed(5))["patches"]
        b = model(tb, deterministic=False, generator=torch.Generator().manual_seed(5))["patches"]
        assert torch.equal(a, b)
        assert trainable_model(j_ae.AEConfig.from_variant(VARIANT), jax_params(
            j_ae.AEConfig.from_variant(VARIANT))).drop_path_gates(4) is None

    @pytest.mark.parametrize("checkpoint", [1, 2, -1])
    def test_activation_checkpointing_keeps_the_gradients(self, checkpoint):
        cfg = j_ae.AEConfig.from_variant("w128_d2_h2-w128_d3_h2/1x16x8", drop_path_rate=0.3)
        params = jax_params(cfg)
        batch = make_batch(len(GRIDS), TOKENS, PATCH, GRIDS)
        loss_cfg = t_tl.LossConfig(**LOSS)
        kw = dict(tile_indices=(torch.tensor([[0, 20], [3, 0]]), torch.tensor([[5, 0], [0, 9]])),
                  drop_uniforms=torch.from_numpy(np.random.default_rng(2).uniform(size=(3, 2)).astype(np.float32)))
        want, _, want_g = port_grads(trainable_model(cfg, params), batch, loss_cfg, **kw)
        got, _, got_g = port_grads(trainable_model(cfg, params, checkpoint=checkpoint), batch, loss_cfg, **kw)
        assert got == pytest.approx(want, abs=1e-6)
        for name in want_g:
            torch.testing.assert_close(got_g[name], want_g[name], atol=1e-6, rtol=0, msg=name)


def jax_three_steps(cfg, params, batches, moment_dtype, grad_accum=1):
    schedule = j_tl.create_schedule("cosine", 1e-3, 10, warmup_frac=0.2)
    tx = j_tl.create_optimizer(schedule, moment_dtype=moment_dtype)
    state = j_tl.create_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)
    step = j_tl.make_train_step(cfg, tx, j_tl.LossConfig(**LOSS), compute_dtype=jnp.float32,
                                donate=False, grad_accum=grad_accum)
    rng = jax.random.key(7)
    norms = []
    for batch in batches:
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        norms.append(float(metrics["grad_norm"]))
    return state, norms, rng


class TestTrainStep:
    @pytest.mark.parametrize("moment_dtype", [None, "bf16"])
    def test_three_adamw_steps_match_jax(self, moment_dtype):
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        batches = [make_batch(len(GRIDS), TOKENS, PATCH, GRIDS, seed=s) for s in range(3)]
        want, want_norms, rng = jax_three_steps(cfg, params, batches, jnp.bfloat16 if moment_dtype else None)

        model = trainable_model(cfg, params)
        tx = t_tl.create_optimizer(t_tl.create_schedule("cosine", 1e-3, 10, warmup_frac=0.2),
                                   moment_dtype=torch.bfloat16 if moment_dtype else None)
        state = t_tl.create_train_state(model, tx)
        step = t_tl.make_train_step(tx, t_tl.LossConfig(**LOSS))
        norms = []
        for s, batch in enumerate(batches):
            idx = jax_tile_indices(batch, j_tl.LossConfig(**LOSS), jax.random.fold_in(rng, s))
            state, metrics = step(state, batch, tile_indices=idx)
            norms.append(float(metrics["grad_norm"]))
        assert state.step == 3 and state.opt_state["count"] == 3
        np.testing.assert_allclose(norms, want_norms, rtol=1e-4)
        got_params = to_jax_params(model.state_dict())
        limit = 5e-4 if moment_dtype else 1e-4
        assert_trees_close(got_params, want.params, limit, "params")
        assert_trees_close(to_jax_params(state.ema_params), want.ema_params, limit, "ema")
        moved = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, want.params, params)
        got_moved = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - b, got_params, params)
        assert_trees_close(got_moved, moved, 2e-2, "movement")
        assert all(np.abs(x).max() > 0 for x in leaves(got_moved).values())
        # the EMA lags the parameters
        assert rel_l2(leaves(to_jax_params(state.ema_params))["['to_pixels']['kernel']"],
                      leaves(got_params)["['to_pixels']['kernel']"]) > 0
        if moment_dtype:
            assert all(m.dtype == torch.bfloat16 for m in state.opt_state["mu"])
            assert all(v.dtype == torch.float32 for v in state.opt_state["nu"])

    def test_grad_accum_equals_the_full_batch(self):
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        grids = [(8, 8), (6, 5), (4, 7), (8, 3)]
        batch = make_batch(4, TOKENS, PATCH, grids)
        idx = (torch.tensor([[0, 9], [3, 0], [0, 0], [1, 2]]), torch.tensor([[5, 0], [0, 9], [7, 7], [0, 0]]))
        results = []
        for accum in (1, 2, 4):
            model = trainable_model(cfg, params)
            # eps = 1 makes the first Adam step smooth in the gradient (with the
            # default it is the gradient's sign, which amplifies 1e-8 differences)
            tx = t_tl.AdamW(lambda s: 1e-3, eps=1.0, grad_clip=0.05)
            state = t_tl.create_train_state(model, tx)
            state, metrics = t_tl.make_train_step(tx, t_tl.LossConfig(**LOSS), grad_accum=accum)(
                state, batch, tile_indices=idx)
            results.append((float(metrics["loss/total"]), float(metrics["grad_norm"]), model.state_dict()))
        for loss, norm, sd in results[1:]:
            assert loss == pytest.approx(results[0][0], abs=1e-6) and norm == pytest.approx(results[0][1], rel=1e-5)
            for name, want in results[0][2].items():
                torch.testing.assert_close(sd[name], want, atol=1e-6, rtol=0, msg=name)
        with pytest.raises(ValueError, match="divisible"):
            t_tl.make_train_step(tx, grad_accum=3)(state, batch)
        with pytest.raises(ValueError):
            t_tl.make_train_step(tx, grad_accum=0)

    def test_resume_repeats_an_uninterrupted_run(self, tmp_path):
        cfg = j_ae.AEConfig.from_variant(VARIANT, drop_path_rate=0.2)
        params = jax_params(cfg)
        batches = [make_batch(len(GRIDS), TOKENS, PATCH, GRIDS, seed=s) for s in range(4)]

        def fresh():
            model = trainable_model(cfg, params)
            tx = t_tl.create_optimizer(t_tl.create_schedule("cosine", 1e-3, 10, warmup_frac=0.2),
                                       moment_dtype=torch.bfloat16)
            return t_tl.create_train_state(model, tx), t_tl.make_train_step(tx, t_tl.LossConfig(**LOSS))

        state, step = fresh()
        for batch in batches:
            state, _ = step(state, batch, 7)
        first, step = fresh()
        for batch in batches[:2]:
            first, _ = step(first, batch, 7)
        t_ckpt.save_checkpoint(first, str(tmp_path / "last"))
        assert os.listdir(tmp_path / "last") == ["state.pt"]
        resumed, step = fresh()
        resumed = t_ckpt.load_checkpoint(str(tmp_path / "last"), target=resumed)
        assert resumed.step == 2 and resumed.opt_state["count"] == 2
        for batch in batches[2:]:
            resumed, _ = step(resumed, batch, 7)
        assert resumed.step == state.step == 4
        for (name, a), b in zip(resumed.model.state_dict().items(), state.model.state_dict().values()):
            assert torch.equal(a, b), name
        for name in state.ema_params:
            assert torch.equal(resumed.ema_params[name], state.ema_params[name]), name
        for key in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(resumed.opt_state[key], state.opt_state[key]))
        raw = t_ckpt.load_checkpoint(str(tmp_path / "last"))
        assert raw["step"] == 2 and set(raw) == {"step", "params", "opt_state", "ema_params"}


class TestExport:
    def test_exported_safetensors_load_back_in_both_packages(self, tmp_path, monkeypatch):
        from vitok_torch.pretrained import load_pretrained_params

        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        model = trainable_model(cfg, params)
        state = {k: v.detach() for k, v in model.state_dict().items()}
        out_dir = tmp_path / "350M-f16x64"
        written = t_ckpt.export_safetensors(state, str(out_dir))
        assert [os.path.basename(p) for p in written] == ["encoder.safetensors", "decoder.safetensors"]
        # the port's own loader (interleaved q/k order on disk, rotate-half in the module)
        monkeypatch.setenv("VITOK_PRETRAINED_DIR", str(tmp_path))
        _, back = load_pretrained_params("350M-f16x64")
        assert set(back) == set(state)
        for name in state:
            assert torch.equal(back[name], state[name]), name
        # the JAX package's loader gives the pytree the weights came from
        j_back = j_io.load_safetensors_params({"encoder": written[0], "decoder": written[1]})
        want, got = leaves(params), leaves(j_back)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        # and the files are the JAX package's own export, byte for byte in value
        j_io.save_safetensors_params(params, str(tmp_path / "j_enc.safetensors"), component="encoder")
        from safetensors.numpy import load_file
        ours, theirs = load_file(written[0]), load_file(str(tmp_path / "j_enc.safetensors"))
        assert set(ours) == set(theirs)
        for key in theirs:
            np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
        single = t_ckpt.export_safetensors(state, str(tmp_path / "one"), split=False)
        assert [os.path.basename(p) for p in single] == ["model.safetensors"]

    def test_to_jax_params_inverts_from_jax_params(self):
        cfg = j_ae.AEConfig.from_variant(VARIANT)
        params = jax_params(cfg)
        want, got = leaves(params), leaves(to_jax_params(from_jax_params(params, cfg)))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
