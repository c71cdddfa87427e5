"""The port's last modules against the JAX package: the checkpoint inspector,
the baseline VAEs, the two benchmark scripts, the entry points and the
public names.

* ``vitok_torch.scripts.inspect_checkpoint`` (twin of
  ``tests/test_inspect_checkpoint.py``): keys, summary and ``diff
  --variant`` on safetensors the port writes and on a ``state.pt``;
* ``vitok_torch.scripts.eval.baselines`` (twin of ``tests/test_baselines.py``,
  the same fake autoencoders on torch tensors); a real baseline without
  ``diffusers`` raises ``ImportError`` naming it;
* ``bench_fused_ffn --check-only`` and ``ab_q8_epilogue``'s numeric leg on
  the CPU's plain versions at a tiny shape, and ``VITOK_DISABLE_FUSED_FFN``;
* ``vitok_torch.entry``: the example batch is the JAX entry's bit for bit,
  and the entry's forward at a cut depth (one encoder and two decoder blocks,
  fp32) matches the JAX package's ``forward_apply`` on the same weights
  (max abs 1e-4); ``dryrun_multichip(2)`` holds every layout;
* the public names: an AST diff of every module of ``vitok_tpu`` (and the
  project's scripts and benchmarks) against its counterpart in the port,
  whose only exceptions are the names not ported (the JAX functional forms,
  ``download_pretrained``, ``scripts/setup_data.py``,
  ``scripts/compare_reference.py``);
* ``compute_freqs_cis``, the safetensors pair, ``load_pretrained`` and
  ``PRETRAINED_ALIASES`` against the JAX package's.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_torch.scripts import inspect_checkpoint as t_inspect
from vitok_torch.scripts.eval import baselines as t_base

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_VARIANT = "w256_d2_h4-w256_d4_h4/1x16x16"


# ---------------------------------------------------------------------------
# inspect_checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    from vitok_torch import train_lib as tl
    from vitok_torch.models.ae import AE, AEConfig
    from vitok_torch.utils.checkpoint import save_checkpoint
    from vitok_torch.utils.params_io import save_safetensors_params

    d = tmp_path_factory.mktemp("ckpt")
    model = AE(**AEConfig.from_variant(TINY_VARIANT).__dict__, device="cpu", param_dtype=torch.float32,
               trainable=True)
    state = {k: v.detach() for k, v in model.state_dict().items()}
    save_safetensors_params(state, str(d / "full.safetensors"))
    save_safetensors_params(state, str(d / "encoder.safetensors"), component="encoder")
    tx = tl.create_optimizer(tl.create_schedule("constant", 1e-3, 10, warmup_frac=0.0))
    save_checkpoint(tl.create_train_state(model, tx), str(d / "last"))
    return d


def _run(capsys, *argv):
    rc = t_inspect.main([str(a) for a in argv])
    return rc, capsys.readouterr().out


def test_keys_dump(artifacts, capsys):
    rc, out = _run(capsys, "keys", artifacts / "full.safetensors")
    assert rc == 0 and "encoder_blocks.0.attn.qkv_proj.weight" in out
    assert out.strip().endswith("tensors")


@pytest.mark.parametrize("path", ["full.safetensors", "last", "last/state.pt"])
def test_summary_counts(artifacts, capsys, path):
    rc, out = _run(capsys, "summary", artifacts / path)
    payload = json.loads(out)
    assert rc == 0 and payload["total_params"] > 0
    assert {"encoder_blocks", "decoder_blocks"} <= set(payload["components"])


def test_diff_matching(artifacts, capsys):
    for path in ("full.safetensors", "last"):
        rc, out = _run(capsys, "diff", artifacts / path, "--variant", TINY_VARIANT)
        assert rc == 0 and "OK: shapes match" in out


def test_diff_encoder_half(artifacts, capsys):
    rc, out = _run(capsys, "diff", artifacts / "encoder.safetensors", "--variant", TINY_VARIANT)
    assert rc == 1 and "MISSING" in out
    rc, out = _run(capsys, "diff", artifacts / "encoder.safetensors", "--variant", TINY_VARIANT, "--component",
                   "encoder")
    assert rc == 0, out


def test_diff_wrong_variant(artifacts, capsys):
    rc, out = _run(capsys, "diff", artifacts / "full.safetensors", "--variant", "w256_d2_h4-w256_d2_h4/1x16x16")
    assert rc == 1 and "EXTRA" in out
    rc, out = _run(capsys, "diff", artifacts / "full.safetensors", "--variant", "w512_d2_h4-w512_d4_h4/1x16x32")
    assert rc == 1 and "SHAPE" in out


def test_expected_shapes_are_the_jax_models(artifacts):
    """The shapes ``diff`` expects (a model on the meta device) are those of
    the JAX package's ``init_params`` in the flat layout."""
    from vitok_tpu.models import AEConfig, init_params
    from vitok_tpu.utils.params_io import pytree_to_torch_state

    want = pytree_to_torch_state(init_params(AEConfig.from_variant(TINY_VARIANT), jax.random.key(0)))
    assert t_inspect.expected_shapes(TINY_VARIANT) == {k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------


class FakeAE:
    """Identity-ish conv VAE stand-in: downsample by stride, upsample back."""

    def __init__(self, stride, channels):
        self.stride, self.channels = stride, channels

    def encode(self, x):
        b, c, h, w = x.shape
        s = self.stride
        pooled = x.reshape(b, c, h // s, s, w // s, s).mean(dim=(3, 5))
        return pooled.repeat(1, self.channels // c + 1, 1, 1)[:, : self.channels]

    def decode(self, z):
        return z[:, :3].repeat_interleave(self.stride, 2).repeat_interleave(self.stride, 3)


class _Dist:
    def __init__(self, mean):
        self._mean = mean

    def mode(self):
        return self._mean

    def sample(self, generator=None):
        return self._mean + 1.0


class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class _FakeDiffusersVAE(torch.nn.Module):
    """The three diffusers autoencoder APIs: KL returns ``.latent_dist``, DC
    ``.latent``, Qwen is video-shaped ``[B, C, T, H, W]``."""

    def __init__(self, kind, stride=8, channels=4):
        super().__init__()
        self.kind, self.stride, self.channels = kind, stride, channels
        self.p = torch.nn.Parameter(torch.zeros(1))

    def _pool(self, x):
        return FakeAE(self.stride, self.channels).encode(x)

    def encode(self, x):
        if self.kind == "qwen":
            assert x.dim() == 5 and x.shape[2] == 1, x.shape
            return _Out(latent_dist=_Dist(self._pool(x.squeeze(2)).unsqueeze(2)))
        if self.kind == "dc":
            return _Out(latent=self._pool(x))
        return _Out(latent_dist=_Dist(self._pool(x)))

    def decode(self, z):
        if self.kind == "qwen":
            assert z.dim() == 5 and z.shape[2] == 1, z.shape
            return _Out(sample=FakeAE(self.stride, 3).decode(z.squeeze(2)).unsqueeze(2))
        return _Out(sample=FakeAE(self.stride, 3).decode(z))


class TestBaselineVAE:
    def test_registry_is_the_jax_packages(self):
        import sys

        sys.path.insert(0, str(REPO))
        from scripts.eval.baselines import BASELINES

        assert {k: v.__dict__ for k, v in t_base.BASELINES.items()} == {k: v.__dict__ for k, v in BASELINES.items()}
        assert t_base.BASELINES["dc-ae-f64"].spatial_stride == 64 and t_base.BASELINES["flux"].subfolder == "vae"

    def test_unknown_raises(self):
        with pytest.raises(KeyError):
            t_base.BaselineVAE("nope")

    def test_pad_to_stride_is_the_jax_reflect_pad(self):
        from scripts.eval.baselines import pad_to_stride

        x = np.random.default_rng(0).standard_normal((1, 3, 50, 30)).astype(np.float32)
        got, h, w = t_base.pad_to_stride(torch.from_numpy(x), 8)
        want, _, _ = pad_to_stride(jnp.asarray(x), 8)
        assert tuple(got.shape) == (1, 3, 56, 32) and (h, w) == (50, 30)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        same, _, _ = t_base.pad_to_stride(torch.zeros(1, 3, 64, 64), 8)
        assert tuple(same.shape) == (1, 3, 64, 64)

    def test_roundtrip_crops_back(self):
        vae = t_base.BaselineVAE("flux", autoencoder=FakeAE(8, 16), dtype=torch.float32)
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 3, 50, 30)).astype(np.float32))
        assert vae(x).shape == x.shape

    def test_scaling_factors_applied(self):
        vae = t_base.BaselineVAE("sdxl", autoencoder=FakeAE(8, 4), dtype=torch.float32)
        x = torch.ones((1, 3, 16, 16))
        latents, _, _ = vae.encode(x)
        torch.testing.assert_close(latents, FakeAE(8, 4).encode(x) * t_base.BASELINES["sdxl"].scaling_factor)

    def test_missing_diffusers_raises_import_error(self):
        with pytest.raises(ImportError, match="diffusers"):
            t_base.BaselineVAE("sd")(torch.zeros((1, 3, 32, 32)))

    @pytest.mark.parametrize("name,kind,stride,channels", [
        ("sdxl", "kl", 8, 4), ("qwen", "qwen", 8, 16), ("dc-ae-f32", "dc", 32, 32)])
    def test_adapters(self, name, kind, stride, channels):
        adapter = t_base._BACKEND_CLASSES[kind][1]
        vae = t_base.BaselineVAE(name, autoencoder=adapter(_FakeDiffusersVAE(kind, stride, channels)),
                                 dtype=torch.float32)
        x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 3, 50, 30)).astype(np.float32))
        out = vae(x)
        assert out.shape == x.shape and torch.isfinite(out).all()

    def test_kl_deterministic_uses_mode(self):
        fake = _FakeDiffusersVAE("kl", 8, 4)
        x = torch.zeros((1, 3, 16, 16))
        z_det = t_base.TorchKLBackend(fake, deterministic=True).encode(x)
        z_smp = t_base.TorchKLBackend(fake, deterministic=False).encode(x)
        torch.testing.assert_close(z_smp, z_det + 1.0)


# ---------------------------------------------------------------------------
# The two benchmark scripts
# ---------------------------------------------------------------------------


def test_bench_fused_ffn_check_only(capsys):
    from vitok_torch.benchmarks import bench_fused_ffn

    assert bench_fused_ffn.main(["--device", "cpu", "--check-only", "--m", "64", "--c", "256", "--f", "300"]) == 0
    out = capsys.readouterr().out
    assert "numerics OK" in out and "fused True, unfused True" in out
    res = bench_fused_ffn.run(64, 256, 300, device="cpu", check_only=True)
    assert res["f_padded"] == 384 and res["ok"] and res["code_max_diff"] <= 2


def test_disable_fused_ffn_is_read_at_each_call(monkeypatch):
    from vitok_torch.ops import quant

    assert quant.can_fuse_ffn(64, 256, 768)
    monkeypatch.setenv("VITOK_DISABLE_FUSED_FFN", "1")
    assert not quant.can_fuse_ffn(64, 256, 768)
    monkeypatch.delenv("VITOK_DISABLE_FUSED_FFN")
    assert quant.can_fuse_ffn(64, 256, 768)


def test_ab_q8_epilogue_numeric_leg(monkeypatch):
    """Arm A takes the int8 epilogue (its wrapper is called in every int8
    block), arm B the quantize chain; on the plain versions the decoded
    patches agree to the last bit (#2's plain version is #1's followed by
    the quantize)."""
    from vitok_torch.benchmarks import ab_q8_epilogue as ab
    from vitok_torch.ops import fused_attention as fa

    calls = []
    real = fa.fused_qkv_attention_q8
    monkeypatch.setattr(fa, "fused_qkv_attention_q8", lambda *a, **k: calls.append(1) or real(*a, **k))
    res = ab.run("tiny", tokens=64, batch=2, device="cpu", numeric_only=True)
    assert len(calls) == 6  # two encoder and four decoder blocks, arm A only
    assert res["numeric"]["rel"] <= 1e-6 and res["numeric"]["max_b"] > 0
    assert not fa._ENABLE_Q8  # the opt-in is put back


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_entry_batch_is_the_jax_entrys():
    import __graft_entry__ as g

    want = g._make_batch(2, 256, (16, 16), 768)
    got = __import__("vitok_torch.entry", fromlist=["entry_batch"]).entry_batch(device="cpu")
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_entry_forward_matches_jax_at_a_cut_depth():
    """``entry()``'s model is the 350M tokenizer; its forward, on a cut of
    that model (one encoder and two decoder blocks, fp32) and its batch,
    is the JAX package's ``forward_apply`` on the same weights."""
    from vitok_tpu.models.ae import AEConfig as JCfg, forward_apply
    from vitok_torch.entry import ENTRY_VARIANT, entry
    from vitok_torch.models.ae import AE, decode_variant
    from vitok_torch.utils.params_io import to_jax_params

    fn, (model, batch) = entry(device="cpu")
    assert model.cfg == AE(**decode_variant(ENTRY_VARIANT), device="meta").cfg and model.compute_dtype == torch.bfloat16
    del model
    cut = "Ld1-Ld2/1x16x64"  # the entry's widths, one encoder and two decoder blocks
    small = AE(**decode_variant(cut), seed=0, device="cpu", compute_dtype=torch.float32)
    got = fn(small, batch)["patches"]
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(small.state_dict()))
    want = forward_apply(params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}, JCfg.from_variant(cut),
                         compute_dtype=jnp.float32)["patches"]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_entry_is_the_flagship_on_the_card_by_default(monkeypatch):
    from vitok_torch.entry import ENTRY_VARIANT, entry, multichip_meshes

    assert ENTRY_VARIANT == "Ld4-Ld24/1x16x64"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert multichip_meshes(4) == [{"data": 1, "fsdp": 2, "model": 2}, {"pipe": 4}, {"data": 2, "pipe": 2}]
    assert multichip_meshes(8)[0] == {"data": 2, "fsdp": 2, "model": 2}


def test_dryrun_multichip_two_processes(capsys):
    from vitok_torch.entry import dryrun_multichip

    reports = dryrun_multichip(2)
    assert sorted(reports) == ["data=1,fsdp=1,model=2", "metrics", "pipe=2"]
    assert "dryrun_multichip OK" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The public names
# ---------------------------------------------------------------------------

# Names of vitok_tpu the port does not carry: the JAX functional forms (the
# port's nn.Modules and utils/params_io.py stand for them) and the download.
NOT_PORTED = {
    "vitok_tpu/models/ae.py": {"encode_apply", "decode_apply", "forward_apply", "init_params"},
    "vitok_tpu/models/__init__.py": {"encode_apply", "decode_apply", "forward_apply", "init_params"},
    "vitok_tpu/models/dit.py": {"apply", "init_params"},
    "vitok_tpu/models/inception.py": {"inception_apply", "init_inception_params", "torch_inception_state_to_pytree"},
    "vitok_tpu/models/vit_features.py": {"init_vit_params", "torch_vit_state_to_pytree", "vit_apply"},
    "vitok_tpu/utils/params_io.py": {"pytree_to_torch_state", "torch_state_to_pytree"},
    "vitok_tpu/ops/quant.py": {"quantize_block_params"},
    "vitok_tpu/muon.py": {"muon", "scale_by_muon"},
    "vitok_tpu/pretrained.py": {"download_pretrained"},
    "vitok_tpu/__init__.py": {"download_pretrained"},
}
# Scripts not ported: one downloads, one needs the reference checkout.
NOT_PORTED_FILES = {"scripts/setup_data.py", "scripts/compare_reference.py"}
# Counterparts at another path.
MOVED = {"scripts/tpu/launch.py": "vitok_torch/scripts/launch.py",
         "vitok_tpu/native/build.py": "vitok_torch/native/__init__.py"}


def _public_names(path: pathlib.Path) -> set:
    """``__all__`` (its starred lists and ``sorted(dict)`` resolved from the
    module's literals), else the module's public definitions."""
    tree = ast.parse(path.read_text())
    literals = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            try:
                literals[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names = set()
            for elt in node.value.elts:
                if isinstance(elt, ast.Starred):
                    inner = elt.value.args[0] if isinstance(elt.value, ast.Call) else elt.value
                    names |= set(literals[inner.id])
                else:
                    names.add(ast.literal_eval(elt))
            return names
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name) and not t.id.startswith("_")}
    return out


def _pairs():
    for path in sorted((REPO / "vitok_tpu").rglob("*.py")):
        rel = str(path.relative_to(REPO))
        yield rel, MOVED.get(rel, "vitok_torch" + rel[len("vitok_tpu"):])
    for folder, dest in (("scripts", "vitok_torch/scripts"), ("benchmarks", "vitok_torch/benchmarks")):
        for path in sorted((REPO / folder).rglob("*.py")):
            rel = str(path.relative_to(REPO))
            if rel not in NOT_PORTED_FILES:
                yield rel, MOVED.get(rel, dest + rel[len(folder):])


@pytest.mark.parametrize("jax_file,port_file", list(_pairs()))
def test_public_names_have_their_counterparts(jax_file, port_file):
    """Every module of the JAX package, its scripts and its benchmarks has a
    counterpart in the port; a package module's public names are all there
    but the functional forms and the download."""
    port = REPO / port_file
    assert port.is_file(), f"{jax_file}: no {port_file}"
    if jax_file.startswith("vitok_tpu/") and jax_file not in MOVED:
        missing = _public_names(REPO / jax_file) - _public_names(port) - NOT_PORTED.get(jax_file, set())
        assert not missing, f"{port_file} lacks {sorted(missing)}"


def test_the_not_ported_list_names_real_gaps():
    """Each listed exception is a name of the JAX module the port lacks
    (the list shrinks as names arrive)."""
    for jax_file, names in NOT_PORTED.items():
        port = REPO / ("vitok_torch" + jax_file[len("vitok_tpu"):])
        assert names <= _public_names(REPO / jax_file) and not names & _public_names(port), jax_file
    assert all((REPO / f).is_file() for f in NOT_PORTED_FILES)


# ---------------------------------------------------------------------------
# The names added in this slice against the JAX package's
# ---------------------------------------------------------------------------


def test_compute_freqs_cis_matches_jax():
    from vitok_tpu.ops.rope import compute_freqs_cis as j_freqs
    from vitok_torch.ops import compute_freqs_cis

    t = np.arange(37, dtype=np.float32).reshape(1, 37)
    got = compute_freqs_cis(torch.from_numpy(t), dim=64)
    want = j_freqs(jnp.asarray(t), dim=64)
    for g, w in zip(got, want):
        assert g.shape == (1, 37, 32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_safetensors_pair_is_the_jax_packages(tmp_path):
    """The port's safetensors file loads in the JAX package as the same
    parameters, and the JAX package's loads in the port as the same state."""
    from vitok_tpu.models import AEConfig, init_params
    from vitok_tpu.utils.params_io import load_safetensors_params as j_load, save_safetensors_params as j_save
    from vitok_torch.models.ae import AE
    from vitok_torch.utils.params_io import from_jax_params, load_safetensors_params, save_safetensors_params

    cfg = AEConfig.from_variant(TINY_VARIANT)
    params = init_params(cfg, jax.random.key(3))
    j_save(params, str(tmp_path / "j.safetensors"))
    state = load_safetensors_params(str(tmp_path / "j.safetensors"), cfg)
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    assert sorted(state) == sorted(want)
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    save_safetensors_params(state, str(tmp_path / "t.safetensors"))
    back = j_load(str(tmp_path / "t.safetensors"), cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = AE(**cfg.__dict__, state_dict=state, device="cpu", compute_dtype=torch.float32)
    assert model.cfg.decoder_depth == 4
    with pytest.raises(ValueError, match="the config 6"):
        load_safetensors_params(str(tmp_path / "t.safetensors"),
                                AEConfig.from_variant("w256_d2_h4-w256_d6_h4/1x16x16"))


def test_load_pretrained_reads_the_released_files(tmp_path, monkeypatch):
    from vitok_tpu.pretrained import PRETRAINED_ALIASES as J_ALIASES, load_pretrained as j_load
    from vitok_torch import load_pretrained
    from vitok_torch.models.ae import AE, AEConfig
    from vitok_torch.pretrained import PRETRAINED_ALIASES
    from vitok_torch.utils.params_io import save_safetensors_params

    assert PRETRAINED_ALIASES == J_ALIASES
    name = "350M-f16x16"
    (tmp_path / name).mkdir()
    model = AE(**AEConfig.from_variant(TINY_VARIANT).__dict__, device="cpu", param_dtype=torch.float32)
    state = model.state_dict()
    for half in ("encoder", "decoder"):
        save_safetensors_params(state, str(tmp_path / name / f"{half}.safetensors"), component=half)
    monkeypatch.setenv("VITOK_PRETRAINED_DIR", str(tmp_path))
    got, want = load_pretrained(name), j_load(name)
    assert got["variant"] == want["variant"] == "Ld4-Ld24/1x16x16"
    for half in ("encoder", "decoder"):
        assert sorted(got[half]) == sorted(want[half])
        for k, v in want[half].items():
            np.testing.assert_array_equal(got[half][k].numpy(), v)
    assert "decoder" not in load_pretrained(name, component="encoder")


def test_io_aliases():
    from vitok_torch.pp import io

    assert io.preprocess_images is io.preprocess and io.postprocess_images is io.postprocess
