"""The port's UniPC scheduler, device loop, samplers and the two CLIs
against the JAX package's.

* ``vitok_torch.unipc.FlowUniPCMultistepScheduler`` is the port's own copy
  of the host scheduler: its schedule and every step equal the JAX
  package's bit for bit on numpy inputs, and the coefficients extracted from
  it are equal.
* ``sample_flow_unipc_device`` (tensors, no host round trip) against the
  host loop: atol 2e-5, rtol 1e-5, the JAX tests' own limit for its device
  loop (fp32 coefficients against float64 host scalars).
* ``sample_latents`` and ``sample_latents_device`` with the same ``z0``,
  fp32, against ``scripts/generate.py``'s: atol 1e-4 after the sampler's
  steps (the DiT itself agrees to about 2e-6 per call).
* ``train_dit`` and ``generate`` run for two steps on the CPU.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_tpu import unipc as j_unipc
from vitok_tpu.models import dit as j_dit
from vitok_torch import unipc as t_unipc
from vitok_torch.models import dit as t_dit
from vitok_torch.scripts import generate as t_gen
from vitok_torch.scripts import train_dit as t_train
from vitok_torch.utils.params_io import dit_from_jax_params

from tests.test_torch_dit import SMALL, jax_dit_params

torch.set_num_threads(1)
REPO = pathlib.Path(__file__).resolve().parent.parent


def _jax_generate():
    spec = importlib.util.spec_from_file_location("jax_generate", REPO / "scripts" / "generate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCHED_KW = [dict(), dict(shift=3.0), dict(solver_type="bh1", shift=2.0), dict(solver_order=1),
            dict(use_dynamic_shifting=True), dict(lower_order_final=False, shift=3.0),
            dict(disable_corrector=[0, 2])]


class TestHostScheduler:
    @pytest.mark.parametrize("kw", SCHED_KW)
    @pytest.mark.parametrize("steps", [3, 20])
    def test_step_by_step_equal(self, kw, steps):
        a, b = t_unipc.FlowUniPCMultistepScheduler(**kw), j_unipc.FlowUniPCMultistepScheduler(**kw)
        mu = 1.5 if kw.get("use_dynamic_shifting") else None
        a.set_timesteps(steps, mu=mu)
        b.set_timesteps(steps, mu=mu)
        np.testing.assert_array_equal(a.timesteps, b.timesteps)
        np.testing.assert_array_equal(a.sigmas, b.sigmas)
        rng = np.random.default_rng(0)
        za = zb = rng.standard_normal((2, 8, 4)).astype(np.float32)
        for t in a.timesteps:
            v = np.tanh(za) + 0.001 * t
            za = a.step(v, t, za).prev_sample
            zb = b.step(v, t, zb).prev_sample
            np.testing.assert_array_equal(np.asarray(za), np.asarray(zb))
            assert (a.this_order, a.lower_order_nums) == (b.this_order, b.lower_order_nums)

    def test_surface(self):
        s = t_unipc.FlowUniPCMultistepScheduler()
        assert len(s) == 1000 and s.config.solver_order == 2
        with pytest.raises(RuntimeError):
            s.step(np.zeros(2), 1.0, np.zeros(2))
        with pytest.raises(ValueError):
            t_unipc.FlowUniPCMultistepScheduler(prediction_type="epsilon")
        s.set_timesteps(4)
        x = np.ones((2, 3), np.float32)
        np.testing.assert_array_equal(s.scale_model_input(x), x)
        js = j_unipc.FlowUniPCMultistepScheduler()
        js.set_timesteps(4)
        noise = np.full((2, 3), 2.0, np.float32)
        np.testing.assert_array_equal(s.add_noise(x, noise, s.timesteps[:2]),
                                      js.add_noise(x, noise, js.timesteps[:2]))
        assert (s.step(x, s.timesteps[0], x, return_dict=False)[0] ==
                js.step(x, js.timesteps[0], x, return_dict=False)[0]).all()

    def test_step_takes_tensors(self):
        a, b = t_unipc.FlowUniPCMultistepScheduler(shift=3.0), t_unipc.FlowUniPCMultistepScheduler(shift=3.0)
        a.set_timesteps(5)
        b.set_timesteps(5)
        z = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
        zt = torch.from_numpy(z)
        for t in a.timesteps:
            z = a.step(np.sin(z), t, z).prev_sample
            zt = b.step(torch.sin(zt), t, zt).prev_sample
        np.testing.assert_allclose(zt.numpy(), z, atol=1e-5)

    @pytest.mark.parametrize("kw", SCHED_KW)
    def test_coefficients_equal(self, kw):
        mu = 1.5 if kw.get("use_dynamic_shifting") else None
        a = t_unipc.precompute_unipc_coefficients(t_unipc.FlowUniPCMultistepScheduler(**kw), 7, mu=mu)
        b = j_unipc.precompute_unipc_coefficients(j_unipc.FlowUniPCMultistepScheduler(**kw), 7, mu=mu)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])

    def test_order_three_is_refused(self):
        with pytest.raises(NotImplementedError):
            t_unipc.precompute_unipc_coefficients(t_unipc.FlowUniPCMultistepScheduler(solver_order=3), 5)


def host_loop(sched, v_fn, z0, steps, mu=None):
    sched.set_timesteps(steps, mu=mu)
    z = np.asarray(z0, np.float32)
    for t in sched.timesteps:
        v = v_fn(torch.from_numpy(z), float(t)).numpy().astype(np.float32)
        z = np.asarray(sched.step(v, t, z).prev_sample, np.float32)
    return z


class TestDeviceLoop:
    @pytest.mark.parametrize("solver_type", ["bh1", "bh2"])
    @pytest.mark.parametrize("steps", [3, 7, 20])
    def test_matches_host_loop(self, solver_type, steps):
        rng = np.random.default_rng(5)
        z0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
        w = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32) * 0.3)
        v_fn = lambda z, t: torch.tanh(z @ w) + 0.01 * t * z
        sched = t_unipc.FlowUniPCMultistepScheduler(solver_type=solver_type, shift=3.0)
        want = host_loop(sched, v_fn, z0, steps)
        got = t_unipc.sample_flow_unipc_device(v_fn, torch.from_numpy(z0), scheduler=sched, steps=steps)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
        # ... and the JAX package's device loop on the same field.
        jw = jnp.asarray(w.numpy())
        jgot = j_unipc.sample_flow_unipc_device(
            lambda z, t: jnp.tanh(z @ jw) + 0.01 * t * z, jnp.asarray(z0),
            scheduler=j_unipc.FlowUniPCMultistepScheduler(solver_type=solver_type, shift=3.0), steps=steps)
        np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=2e-5, rtol=1e-5)

    def test_disable_corrector_and_dynamic_shifting(self):
        z0 = np.random.default_rng(6).standard_normal((1, 8, 4)).astype(np.float32)
        v_fn = lambda z, t: torch.sin(z) * 0.5
        sched = t_unipc.FlowUniPCMultistepScheduler(disable_corrector=[0, 2])
        got = t_unipc.sample_flow_unipc_device(v_fn, torch.from_numpy(z0), scheduler=sched, steps=6)
        np.testing.assert_allclose(got.numpy(), host_loop(sched, v_fn, z0, 6), atol=2e-5, rtol=1e-5)
        dyn = lambda: t_unipc.FlowUniPCMultistepScheduler(use_dynamic_shifting=True)
        got = t_unipc.sample_flow_unipc_device(v_fn, torch.from_numpy(z0), scheduler=dyn(), steps=6, mu=2.0)
        np.testing.assert_allclose(got.numpy(), host_loop(dyn(), v_fn, z0, 6, mu=2.0), atol=2e-5, rtol=1e-5)

    def test_exact_linear_flow_recovery(self):
        rng = np.random.default_rng(3)
        x0 = rng.standard_normal((1, 8, 4)).astype(np.float32)
        eps = rng.standard_normal(x0.shape).astype(np.float32)
        v = torch.from_numpy(eps - x0)
        got = t_unipc.sample_flow_unipc_device(lambda z, t: v, torch.from_numpy(eps), steps=20)
        assert np.abs(got.numpy() - x0).max() < 5e-2

    def test_timestep_is_a_tensor_and_dtype_is_kept(self):
        seen = []

        def v_fn(z, t):
            seen.append(t)
            return torch.zeros_like(z)

        z0 = torch.ones((1, 2, 2), dtype=torch.float32)
        out = t_unipc.sample_flow_unipc_device(v_fn, z0, steps=3)
        assert all(isinstance(t, torch.Tensor) and t.dim() == 0 for t in seen) and len(seen) == 3
        assert out.dtype == z0.dtype and out.shape == z0.shape


class TestSamplers:
    def _models(self, **extra):
        kw = dict(SMALL, **extra)
        params = jax_dit_params(j_dit.DiTConfig(**kw))
        jm = j_dit.DiT(params=jax.tree_util.tree_map(jnp.asarray, params), compute_dtype=jnp.float32, **kw)
        tm = t_dit.DiT(state_dict=dit_from_jax_params(params), device="cpu",
                       compute_dtype=torch.float32, **kw)
        return jm, tm

    @pytest.mark.parametrize("device_loop", [False, True])
    def test_sample_latents_matches_jax(self, monkeypatch, device_loop):
        jg = _jax_generate()
        jm, tm = self._models()
        classes, n, c, steps = [1, 7, 3], 16, 8, 4
        z0 = np.random.default_rng(2).standard_normal((3, n, c)).astype(np.float32)
        # Feed the JAX samplers the same initial noise.
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.asarray(z0, dtype))
        name = "sample_latents_device" if device_loop else "sample_latents"
        want = np.asarray(getattr(jg, name)(jm, j_unipc.FlowUniPCMultistepScheduler(shift=3.0), classes, n, c,
                                            cfg_scale=4.0, steps=steps))
        got = getattr(t_gen, name)(tm, t_unipc.FlowUniPCMultistepScheduler(shift=3.0), classes, n, c,
                                   cfg_scale=4.0, steps=steps, z0=z0)
        assert got.shape == (3, n, c) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)

    def test_device_loop_equals_host_loop(self):
        _, tm = self._models()
        z0 = np.random.default_rng(3).standard_normal((2, 16, 8)).astype(np.float32)
        args = ([2, 5], 16, 8)
        a = t_gen.sample_latents(tm, t_unipc.FlowUniPCMultistepScheduler(shift=3.0), *args, steps=6, z0=z0)
        b = t_gen.sample_latents_device(tm, t_unipc.FlowUniPCMultistepScheduler(shift=3.0), *args, steps=6, z0=z0)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=5e-5)

    def test_noise_comes_from_the_generator(self):
        _, tm = self._models()
        sched = lambda: t_unipc.FlowUniPCMultistepScheduler()
        run = lambda **kw: t_gen.sample_latents_device(tm, sched(), [1], 16, 8, steps=2, **kw)
        assert torch.equal(run(seed=3), run(generator=torch.Generator().manual_seed(3)))
        assert not torch.equal(run(seed=3), run(seed=4))

    def test_decode_latents(self):
        from vitok_torch.models.ae import AE, decode_variant

        ae = AE(**decode_variant("w64_d1_h1-w64_d1_h1/1x16x8"), encoder=False, device="cpu", seed=0)
        z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32))
        images = t_gen.decode_latents(ae, z, 16)
        assert len(images) == 2
        assert all(tuple(i.shape) == (3, 64, 64) and i.dtype == torch.uint8 for i in images)


class TestCLIs:
    @pytest.fixture()
    def latents(self, tmp_path):
        rng = np.random.default_rng(0)
        d = tmp_path / "latents"
        d.mkdir()
        for i in range(6):
            np.save(d / f"{i}.npy", {"z": rng.standard_normal((16, 32)).astype(np.float32), "label": i % 3},
                    allow_pickle=True)
        return d

    def _train(self, latents, out, *extra):
        t_train.main(["--device", "cpu", "--dit", "w64_d2_h1/16", "--data", str(latents), "--bs", "2",
                      "--log-freq", "1", "--output-dir", str(out), *extra])

    def test_train_dit_two_steps_resume_and_generate(self, latents, tmp_path, capsys):
        out = tmp_path / "run"
        self._train(latents, out, "--steps", "2", "--shift", "2.0")
        log = capsys.readouterr().out
        assert '"step": 2' in log and "training done" in log
        ckpt = out / "last"
        assert (ckpt / "state.pt").exists()
        self._train(latents, out, "--steps", "3", "--resume")
        log = capsys.readouterr().out
        assert "resumed at step 2" in log and '"step": 3' in log and '"step": 1,' not in log

        samples = tmp_path / "samples"
        common = ["--device", "cpu", "--ae", "w64_d1_h1-w64_d1_h1/1x16x32", "--dit-variant", "w64_d2_h1/16",
                  "--dit-checkpoint", str(ckpt), "--tokens", "16", "--steps", "2", "--out", str(samples)]
        t_gen.main([*common, "--classes", "1,2"])
        t_gen.main([*common, "--classes", "3", "--device-loop"])
        from PIL import Image

        for cls in (1, 2, 3):
            img = Image.open(samples / f"class{cls}_seed0.png")
            assert img.size == (64, 64) and img.mode == "RGB"

    def test_resumed_run_repeats_an_uninterrupted_one(self, latents, tmp_path):
        self._train(latents, tmp_path / "a", "--steps", "3", "--save-freq", "0")
        self._train(latents, tmp_path / "b", "--steps", "2", "--save-freq", "0")
        # The schedule depends on --steps: resume under the same total.
        self._train(latents, tmp_path / "c", "--steps", "3", "--save-freq", "2")
        load = lambda p: torch.load(p / "last" / "state.pt", weights_only=True)
        a, c = load(tmp_path / "a"), load(tmp_path / "c")
        assert a["step"] == c["step"] == 3
        for k in a["params"]:
            assert torch.equal(a["params"][k], c["params"][k]), k

    def test_train_dit_from_images_through_a_frozen_encoder(self, tmp_path, capsys):
        from PIL import Image

        rng = np.random.default_rng(0)
        for cls in ("a", "b"):
            (tmp_path / "imgs" / cls).mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.integers(0, 256, (70, 80, 3), dtype=np.uint8)).save(
                    tmp_path / "imgs" / cls / f"{i}.png")
        t_train.main(["--device", "cpu", "--dit", "w64_d1_h1/16", "--ae", "w64_d1_h1-w64_d1_h1/1x16x8",
                      "--data", str(tmp_path / "imgs"), "--max-tokens", "16", "--bs", "2", "--steps", "2",
                      "--log-freq", "1", "--num-classes", "2", "--output-dir", str(tmp_path / "run")])
        assert '"step": 2' in capsys.readouterr().out

    def test_muon_and_missing_latents_raise(self, latents, tmp_path):
        with pytest.raises(NotImplementedError, match="Muon"):
            self._train(latents, tmp_path / "m", "--steps", "1", "--optimizer", "muon")
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(SystemExit):
            self._train(empty, tmp_path / "e", "--steps", "1")

    def test_cli_flags_follow_the_jax_scripts(self):
        """Every flag of the JAX CLIs but ``--mesh`` exists, plus ``--device``."""
        import re

        for script, parser in (("generate.py", t_gen.build_parser()), ("train_dit.py", t_train.build_parser())):
            text = (REPO / "scripts" / script).read_text()
            want = set(re.findall(r'add_argument\(\s*"(--[a-z-]+)"', text)) - {"--mesh"}
            have = {o for a in parser._actions for o in a.option_strings}
            assert want <= have, want - have
            assert "--device" in have and parser.get_default("device") == "cuda"
