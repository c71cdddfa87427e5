"""The port's preprocessing (``vitok_torch.pp``) against ``vitok_tpu.pp``, and
the port's import boundary.

Host ops are the same numpy/PIL code, so outputs are compared bit for bit.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from vitok_tpu.pp import io as j_io
from vitok_tpu.pp import ops as j_ops
from vitok_tpu.pp import registry as j_reg
from vitok_torch.pp import io as t_io
from vitok_torch.pp import ops as t_ops
from vitok_torch.pp import registry as t_reg

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


def make_image(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


MIXED = [(64, 64), (48, 32), (123, 77), (16, 80)]
PP_STRINGS = [
    "to_tensor|normalize(minus_one_to_one)|patchify(16, 64)",
    "to_tensor|normalize(imagenet)|resize_to_token_budget(16, 12)|patchify(16, 12)",
    "resize_longest_side(60)|to_tensor|normalize(zero_to_one)|patchify(8, 64)",
    "center_crop(32)|to_tensor|normalize|patchify(16, 4)",
]


class TestPreprocess:
    @pytest.mark.parametrize("pp", PP_STRINGS)
    def test_bit_equal_to_jax(self, pp):
        images = [make_image(w, h, seed=i) for i, (w, h) in enumerate(MIXED)]
        got = t_io.preprocess(images, pp=pp, device="cpu")
        want = j_io.preprocess(images, pp=pp, device="cpu")
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    def test_dsl_parse_matches_jax(self):
        for pp in PP_STRINGS:
            assert [(s.name, s.args, s.kwargs) for s in t_reg.parse_pipeline(pp)] == [
                (s.name, s.args, s.kwargs) for s in j_reg.parse_pipeline(pp)
            ]
        with pytest.raises(KeyError):
            t_reg.build_transform("nope(1)")
        with pytest.raises(ValueError):
            t_reg.parse_op("bad op(")

    def test_default_device_is_the_card(self):
        img = make_image(32, 32)
        if torch.cuda.is_available():
            assert t_io.preprocess(img)["patches"].device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                t_io.preprocess(img)


class TestRoundTrip:
    def test_patchify_unpatchify_unpack_bit_exact(self):
        """Mixed grids take the scatter path; every image comes back exactly."""
        arrays = [
            np.random.default_rng(i).standard_normal((3, h, w)).astype(np.float32)
            for i, (w, h) in enumerate(MIXED)
        ]
        batch = t_io.patch_collate_fn([t_ops.patchify_array(a, 16, 64) for a in arrays])
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        images = t_ops.unpatchify(tb, patch=16)
        np.testing.assert_array_equal(
            images.numpy(), np.asarray(j_ops.unpatchify({k: jnp.asarray(v) for k, v in batch.items()}))
        )
        for a, out in zip(arrays, t_ops.unpack(images, tb["orig_height"], tb["orig_width"])):
            np.testing.assert_array_equal(out.numpy(), a)

    def test_unpatchify_without_grid_metadata(self):
        arrays = [np.ones((3, 32, 48), np.float32), np.full((3, 16, 16), 2.0, np.float32)]
        batch = t_io.patch_collate_fn([t_ops.patchify_array(a, 16, 8) for a in arrays])
        tb = {k: torch.from_numpy(v) for k, v in batch.items() if not k.startswith("grid_")}
        jb = {k: jnp.asarray(v) for k, v in batch.items() if not k.startswith("grid_")}
        np.testing.assert_array_equal(
            t_ops.unpatchify(tb).numpy(), np.asarray(j_ops.unpatchify(jb))
        )
        np.testing.assert_array_equal(
            t_ops.unpatchify(tb, max_grid_size=4).numpy(),
            np.asarray(j_ops.unpatchify(jb, max_grid_size=4)),
        )

    def test_patchify_image_matches_jax(self):
        x = np.random.default_rng(0).standard_normal((2, 3, 32, 48)).astype(np.float32)
        got = t_ops.patchify_image(torch.from_numpy(x), patch=16)
        want = j_ops.patchify_image(jnp.asarray(x), patch=16)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)

    def test_postprocess_of_input_is_identity(self):
        images = [make_image(w, h, seed=i) for i, (w, h) in enumerate(MIXED)]
        d = t_io.preprocess(images, pp=PP_STRINGS[0], device="cpu")
        out = t_io.postprocess(dict(d), output_format="0_255", do_unpack=True)
        for img, o in zip(images, out):
            np.testing.assert_array_equal(o.numpy().transpose(1, 2, 0), np.asarray(img))

    @pytest.mark.parametrize(
        "src,dst",
        [("minus_one_to_one", "0_255"), ("minus_one_to_one", "zero_to_one"),
         ("zero_to_one", "0_255"), ("0_255", "minus_one_to_one"), ("0_255", "zero_to_one"),
         ("zero_to_one", "minus_one_to_one")],
    )
    def test_format_conversion_matches_jax(self, src, dst):
        x = np.linspace(-1.2, 1.2, 48, dtype=np.float32).reshape(1, 3, 4, 4)
        if src == "0_255":
            x = np.arange(48, dtype=np.uint8).reshape(1, 3, 4, 4) * 5
        got = t_io.postprocess(torch.from_numpy(x), output_format=dst, current_format=src)
        want = j_io.postprocess(jnp.asarray(x), output_format=dst, current_format=src)
        assert got.numpy().dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _port_files():
    return sorted((REPO / "vitok_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


class TestImportBoundary:
    @pytest.mark.parametrize("module", [
        "losses.py", "train_lib.py", "data/loaders.py", "utils/checkpoint.py", "utils/preemption.py",
        "scripts/train_vae.py", "ops/flash_attention.py"])
    def test_training_modules_are_inside_the_boundary(self, module):
        """The training slice's modules are among the files the import check reads."""
        assert REPO / "vitok_torch" / module in _port_files()

    @pytest.mark.parametrize("module", [
        "models/dit.py", "unipc.py", "scripts/generate.py", "scripts/train_dit.py",
        "ops/fused_attention.py", "utils/params_io.py"])
    def test_generation_modules_are_inside_the_boundary(self, module):
        """The DiT, the sampler and their CLIs are among the files the import check reads."""
        assert REPO / "vitok_torch" / module in _port_files()

    @pytest.mark.parametrize("module", [
        "benchmarks/__init__.py", "benchmarks/ab_batch_block.py", "benchmarks/ab_q8_input.py",
        "benchmarks/device_time.py"])
    def test_ab_benchmark_modules_are_inside_the_boundary(self, module):
        """The A/B entry points and their kernel wrappers are among the files the import check reads."""
        assert REPO / "vitok_torch" / module in _port_files()

    @pytest.mark.parametrize("module", [
        "ops/fused_attention.py", "ops/_build.py", "benchmarks/fused_bits.py"])
    def test_fused_attention_modules_are_inside_the_boundary(self, module):
        """The fused attention's wrappers (the q/k prologue, the wgmma forward
        and backward, the mma.sync forward), their build and the checkouts'
        comparison are among the files the import check reads."""
        assert REPO / "vitok_torch" / module in _port_files()

    def test_kernel_sources_include_only_their_own_headers(self):
        """Every quoted include of a CUDA source is a header in csrc/ (the
        build hashes those into each library's key), and no source includes
        PyTorch's headers (the kernels bind through a plain C interface)."""
        csrc = REPO / "vitok_torch" / "csrc"
        sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
        assert {"fused_attention_sm90.cu", "sm90.cuh"} <= {p.name for p in sources}
        for path in sources:
            for line in path.read_text().splitlines():
                if line.startswith("#include"):
                    target = line.split()[1]
                    assert not target.strip('<>"').startswith(("torch/", "ATen/", "c10/")), f"{path}: {line}"
                    if target.startswith('"'):
                        assert (csrc / target.strip('"')).is_file(), f"{path}: {line}"

    def test_ctypes_bindings_match_the_c_entry_points(self, monkeypatch):
        """Every argument list a loader binds with ctypes has the types, in
        order, of the C entry point it calls (pointers, int, long long,
        float): a binding one argument short raises only on the card. The
        loaders run against a stand-in for ``_build.load``; the entry points
        are read from ``csrc/*.cu``."""
        import ctypes
        import re

        from vitok_torch import benchmarks
        from vitok_torch.ops import _build, flash_attention, fused_attention, quant

        class FakeLib:
            def __init__(self):
                self.fns = {}

            def __getattr__(self, name):
                if name.startswith("vitok_"):
                    return self.fns.setdefault(name, type("Fn", (), {"argtypes": None, "restype": None})())
                raise AttributeError(name)

        libs = {}
        monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(name, FakeLib()))
        for loader in (fused_attention._kernel_lib, fused_attention._sm90_lib, fused_attention._f32_lib,
                       fused_attention._bwd_kernel_lib, flash_attention._kernel_lib, flash_attention._bwd_kernel_lib,
                       benchmarks.q8in_lib, benchmarks.sm90_lib):
            loader()
        for name in sorted({lib for lib, _ in quant._ARGTYPES.values()}):
            quant._lib(name)
        kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_longlong: "l", ctypes.c_float: "f"}
        bound = {(lib, fn): "".join(kinds[t] for t in f.argtypes) for lib, fake in libs.items()
                 for fn, f in fake.fns.items()}

        def c_kind(param):
            param = param.strip()
            if "*" in param:
                return "p"
            return {"long long": "l", "float": "f", "int": "i"}[param.rsplit(" ", 1)[0].replace("const ", "")]

        csrc = REPO / "vitok_torch" / "csrc"
        declared = {}
        for path in csrc.glob("*.cu"):
            for fn, params in re.findall(r"^int (vitok_\w+)\(([^)]*)\)", path.read_text(), re.M):
                declared[(path.stem, fn)] = "".join(c_kind(x) for x in params.split(","))
        assert len(bound) >= 18 and ("fused_attention_ab_f32_sm90", "vitok_fused_attention_walk_f32") in bound
        for key, sig in bound.items():
            assert declared.get(key) == sig, f"{key}: bound {sig}, declared {declared.get(key)}"

    def test_port_imports_no_jax(self):
        """No file of the port, nor chip_smoke.py, imports jax, jaxlib, flax
        or vitok_tpu."""
        banned = {"jax", "jaxlib", "flax", "vitok_tpu"}
        files = _port_files()
        assert len(files) > 10
        for path in files:
            for node in ast.walk(ast.parse(path.read_text(), str(path))):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for name in names:
                    assert name.split(".")[0] not in banned, f"{path}: imports {name}"
