"""The A/B attention kernels of ``vitok_torch.benchmarks`` against the JAX
project's ``benchmarks/ab_batch_block.py`` and ``benchmarks/ab_q8_input.py``.

On the CPU each wrapper runs its kernel's plain version. The JAX scripts are
loaded from their files, unchanged, and their Pallas kernels run in
interpret mode, on the same numpy inputs: B = 4 samples of N = 64 or 128
tokens, 2 heads of 64, 128, 192 or 256 channels, a tail mask on sample 1 and
no valid token in sample 3. Tolerances: fp32 2e-5 on every row. bf16: max 2e-2 and
mean 2e-3 on every row (outputs are O(1); both sides round P to bf16 and
q/k to the bf16 grid, where one rounding flip moves a value by 2^-8 of its
size, and the JAX kernel's d = 64 head pairs take a packed variance).

The pack kernel's trap is asserted explicitly: on an image with no valid key
it averages v over the whole pack (bb = 2 at N = 64, bb = 4 at N = 200), not
over its own tokens as the fused forward does. The int8-input kernel takes the same int8 codes on both sides.
Both ``main()``s run with ``--device cpu`` at small sizes. The kernels
themselves are held against these plain versions on the card in
``tests/test_torch_cuda.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu.ops.rope import compute_2d_freqs_cis
from vitok_torch.benchmarks import ab_batch_block as t_bb
from vitok_torch.benchmarks import ab_q8_input as t_q8
from vitok_torch.benchmarks import pick_group_channels
from vitok_torch.ops import fused_attention as t_fa

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
H = 2


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_benchmarks_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


j_bb = _load_jax_script("ab_batch_block")
j_q8 = _load_jax_script("ab_q8_input")


def make_inputs(d, n=64, b=4, seed=0):
    """numpy qkv, gains U(0.5, 1.5), 2D RoPE tables; mask: sample 1 keeps 23
    tokens, sample 3 none."""
    rng = np.random.default_rng(seed)
    c = H * d
    qkv = rng.standard_normal((b, n, 3 * c)).astype(np.float32)
    qs = rng.uniform(0.5, 1.5, d).astype(np.float32)
    ks = rng.uniform(0.5, 1.5, d).astype(np.float32)
    idx = np.arange(n)
    row = np.tile((idx // 8)[None], (b, 1)).astype(np.int32)
    col = np.tile((idx % 8)[None], (b, 1)).astype(np.int32)
    cos, sin = (np.asarray(t) for t in compute_2d_freqs_cis(jnp.asarray(row), jnp.asarray(col), d))
    mask = idx[None, :] < np.array([n, 23, n // 2, 0])[:, None]
    return qkv, qs, ks, cos, sin, mask


def both(args, dtype):
    """The arguments for the port (torch) and for JAX, qkv in ``dtype``."""
    qkv, *rest = args
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    port = [torch.from_numpy(qkv).to(tdt)] + [torch.tensor(np.asarray(a)) for a in rest]
    jax_args = [jnp.asarray(qkv, jdt)] + [jnp.asarray(a) for a in rest]
    return port, jax_args


def assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= 2e-5, err.max()
    else:
        assert err.max() <= 2e-2 and err.mean() <= 2e-3, (err.max(), err.mean())


class TestPlainAgainstJax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d,bb", [(64, 1), (64, 2), (128, 2), (192, 2), (256, 2)])
    def test_batch_block_matches_kernel_bb(self, dtype, d, bb):
        port, jax_args = both(make_inputs(d), dtype)
        before = dict(t_bb.LAUNCHES)
        got = t_bb.fused_attention_bb(*port, num_heads=H, bb=bb, cg=H * d)
        assert t_bb.LAUNCHES == before  # the CPU runs the plain version
        want = j_bb.fused_attention_bb(*jax_args, num_heads=H, bb=bb, cg=H * d, interpret=True)
        assert got.dtype == port[0].dtype
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("d,bb,n", [(64, 2, 64), (128, 2, 64), (64, 4, 200), (192, 2, 64), (256, 2, 64)])
    def test_pack_matches_kernel_pack_and_averages_a_dead_image_over_its_pack(self, dtype, d, bb, n):
        args = make_inputs(d, n=n)
        port, jax_args = both(args, dtype)
        got = t_bb.fused_attention_bb(*port, num_heads=H, bb=bb, cg=H * d, pack=True)
        want = j_bb.fused_attention_bb(*jax_args, num_heads=H, bb=bb, cg=H * d, pack=True, interpret=True)
        assert_close(got, want, dtype)
        # Images 0-2 have a valid key: the fused forward's function there.
        fused = t_fa.fused_qkv_attention_plain(*port, num_heads=H)
        assert_close(got[:3], jnp.asarray(fused[:3].float().numpy()), dtype)
        # Image 3 has none: every row is the mean of v over all images of its
        # pack (bb*N keys), where the fused forward averages over its own N.
        v = port[0].float()[4 - bb:4, :, 2 * H * d:].reshape(-1, H * d)
        mean_pack = v.mean(0)
        tol = 2e-5 if dtype == "float32" else 2e-2
        assert (got[3].float() - mean_pack).abs().max() <= tol
        assert (fused[3].float() - mean_pack).abs().max() > 0.1

    @pytest.mark.parametrize("dtype,d,n", [("float32", 64, 64), ("bfloat16", 64, 64), ("float32", 128, 128),
                                           ("float32", 192, 64), ("bfloat16", 256, 64)])
    def test_contig_matches_kernel_contig(self, dtype, d, n):
        port, jax_args = both(make_inputs(d, n=n), dtype)
        got = t_q8.fused_attention_contig(*port, num_heads=H)
        want = j_q8.fused_attention_contig(*jax_args, num_heads=H, interpret=True)
        assert_close(got, want, dtype)

    @pytest.mark.parametrize("d,n", [(64, 64), (128, 128), (192, 64), (256, 64)])
    def test_int8_input_matches_kernel_q8in_from_the_same_codes(self, d, n):
        qkv, *rest = make_inputs(d, n=n)
        rest_t = [torch.tensor(np.asarray(a)) for a in rest]
        codes, scale = t_q8.quantize_qkv(torch.from_numpy(qkv).bfloat16())
        got = t_q8.fused_attention_q8in(codes, scale, *rest_t, num_heads=H)
        want = j_q8.fused_attention_q8in(jnp.asarray(codes.numpy()), jnp.asarray(scale.numpy()),
                                         *[jnp.asarray(a) for a in rest], num_heads=H, interpret=True)
        assert got.dtype == torch.bfloat16
        assert_close(got, want, "bfloat16")
        # The same function as the fused forward on the assembled tensor.
        assembled = t_q8.assemble_q8in(codes, scale)
        assert torch.equal(assembled[..., :2 * H * d], codes[..., :2 * H * d].to(torch.bfloat16))
        torch.testing.assert_close(got, t_fa.fused_qkv_attention_plain(assembled, *rest_t, num_heads=H),
                                   rtol=0, atol=0)


class TestSplitTwin:
    """The fp32 walker's arithmetic (``fused_attention_bb_split_plain``): each
    fp32 operand split exactly into three bf16 pieces, the six products of
    pieces small terms first, accumulated in fp32. Within 1e-5 of the largest
    entry of the fp32 function (the plain version and the JAX kernels in
    interpret mode): the dropped terms are about 2^-24 of a product."""

    def test_pieces_sum_to_the_value_exactly(self):
        rng = np.random.default_rng(9)
        x = (10.0 ** rng.uniform(-30, 30, 100_000) * rng.choice([-1.0, 1.0], 100_000)).astype(np.float32)
        fed = [make_inputs(d, n=n)[0].ravel() for d in (64, 128) for n in (64, 200)]
        for values in [x, *fed]:
            t = torch.from_numpy(values)
            hi, mid, lo = t_bb.split_bf16(t)
            assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
            assert torch.equal(hi.double() + mid.double() + lo.double(), t.double())
            assert torch.equal(mid, (t - hi.float()).bfloat16())  # each piece is the rounded rest

    @pytest.mark.parametrize("pack,sw", [(False, None), (False, 24), (True, None)])
    def test_twin_is_the_fp32_function(self, pack, sw):
        port, _ = both(make_inputs(128, n=200), "float32")
        kw = dict(num_heads=H, bb=2, cg=H * 128, sliding_window=sw, pack=pack)
        want = t_bb.fused_attention_bb_plain(*port, **kw)
        got = t_bb.fused_attention_bb_split_plain(*port, **kw)
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()

    @pytest.mark.parametrize("d,n,bb,sw", [(64, 64, 1, None), (64, 200, 2, 24), (128, 64, 2, None),
                                           (128, 200, 1, 40), (192, 64, 2, 24), (256, 64, 1, None)])
    def test_twin_matches_kernel_bb(self, d, n, bb, sw):
        port, jax_args = both(make_inputs(d, n=n), "float32")
        got = t_bb.fused_attention_bb_split_plain(*port, num_heads=H, bb=bb, cg=H * d, sliding_window=sw)
        want = np.asarray(j_bb.fused_attention_bb(*jax_args, num_heads=H, bb=bb, cg=H * d, sliding_window=sw,
                                                  interpret=True))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    @pytest.mark.parametrize("d,n,sw", [(64, 64, None), (64, 200, 24), (128, 64, None), (128, 128, 40),
                                        (192, 64, None), (256, 64, 40)])
    def test_twin_matches_kernel_contig(self, d, n, sw):
        """#13 in fp32 runs the fp32 walker with one image x all heads a
        block (bb = 1, hpb = H): its arithmetic against ``_kernel_contig``."""
        port, jax_args = both(make_inputs(d, n=n), "float32")
        got = t_bb.fused_attention_bb_split_plain(*port, num_heads=H, bb=1, cg=H * d, sliding_window=sw)
        want = np.asarray(j_q8.fused_attention_contig(*jax_args, num_heads=H, sliding_window=sw, interpret=True))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        # image 3 (no valid key): the mean of v over its own tokens
        mean_v = port[0][3, :, 2 * H * d:].mean(0)
        assert (got[3] - mean_v).abs().max().item() <= 1e-5 * np.abs(want).max()

    @pytest.mark.parametrize("d,n", [(64, 200), (128, 64), (192, 64), (256, 64)])
    def test_twin_matches_kernel_pack(self, d, n):
        port, jax_args = both(make_inputs(d, n=n), "float32")
        got = t_bb.fused_attention_bb_split_plain(*port, num_heads=H, bb=2, cg=H * d, pack=True)
        want = np.asarray(j_bb.fused_attention_bb(*jax_args, num_heads=H, bb=2, cg=H * d, pack=True,
                                                  interpret=True))
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        # image 3 (no valid key): the mean of v over its pack of two
        mean_pack = port[0][2:4, :, 2 * H * d:].reshape(-1, H * d).mean(0)
        assert (got[3] - mean_pack).abs().max().item() <= 1e-5 * np.abs(want).max()

    def test_twin_refuses_bf16(self):
        port, _ = both(make_inputs(64), "bfloat16")
        with pytest.raises(TypeError, match="float32"):
            t_bb.fused_attention_bb_split_plain(*port, num_heads=H, bb=1, cg=64)


class TestWrappers:
    def test_refused_splits_raise_value_error_up_front(self):
        port, _ = both(make_inputs(64), "float32")
        for kw in (dict(bb=3, cg=128), dict(bb=1, cg=96), dict(bb=1, cg=256), dict(bb=2, cg=128, pack=True,
                                                                                     sliding_window=8)):
            with pytest.raises(ValueError):
                t_bb.fused_attention_bb(*port, num_heads=H, **kw)
        with pytest.raises(ValueError, match="tok_scale"):
            t_q8.fused_attention_q8in(port[0].to(torch.int8), port[0][..., :2], *port[1:], num_heads=H)

    def test_other_devices_raise(self):
        port, _ = both(make_inputs(64), "float32")
        meta = [t.to("meta") for t in port]
        with pytest.raises(RuntimeError, match="no fused attention kernel"):
            t_bb.fused_attention_bb(*meta, num_heads=H, bb=1, cg=128)
        with pytest.raises(RuntimeError, match="no fused attention kernel"):
            t_q8.fused_attention_contig(*meta, num_heads=H)

    def test_head_group_pick_is_the_jax_packages(self):
        from vitok_tpu.ops.fused_attention import _pick_group_channels

        for c, d, n in ((3072, 128, 256), (3072, 128, 64), (1024, 64, 256), (1024, 64, 1024), (1728, 72, 256)):
            assert pick_group_channels(c, d, n) == _pick_group_channels(c, d, n)


class TestEntryPoints:
    def test_batch_block_main_prints_every_arm(self, capsys):
        result = t_bb.main(["--c", "1536", "--heads", "12", "--tokens", "64", "--batch", "4",
                            "--iters", "1", "--layers", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        names = ["B", "G", "S2", "D2", "D4", "C768", "C512", "C384", "C256", "C128", "P2"]
        assert list(result["arms"]) == names and not result["skipped"]
        for name in names:
            assert f"\n{name} (" in out and "ms/call" in out
            if name != "B":
                # in bf16 every arm but B runs the redesigned forward's (wgmma) body: held to it (X)
                assert f"numeric {name}: max|{name}-X| = 0.000000 (expect 0.0)" in out
                assert result["references"][name].startswith("X: ")
                assert f"delta {name}/B = " in out
        assert all(v == 0.0 for v in result["numeric"].values())
        assert "redesigned forward" in result["references"]["P2"]
        assert set(result["references"]) == set(result["numeric"]) == set(names) - {"B"}
        assert "numeric redesigned: max|X-B|" in out and "walker_f32" not in result

    def test_batch_block_main_holds_the_fp32_pack_to_arm_b(self, capsys):
        result = t_bb.main(["--c", "1536", "--heads", "12", "--tokens", "64", "--batch", "2", "--dtype", "float32",
                            "--iters", "1", "--layers", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        # in fp32 every arm but B runs the fp32 walker: held to its one-cell-a-block arm (W), and W to B
        assert {"P2", "D2", "C128"} <= set(result["numeric"])
        for name in result["numeric"]:
            assert f"numeric {name}: max|{name}-W| = 0.000000 (expect 0.0)" in out
        assert all(r.startswith("W: the fp32 walker") for r in result["references"].values())
        assert "numeric fp32 walker: max|W-B| = 0.000e+00" in out
        assert result["walker_f32"]["max_abs_vs_B"] == 0.0 and result["walker_f32"]["max_abs_B"] > 0
        assert "redesigned" not in result and all(v == 0.0 for v in result["numeric"].values())

    def test_q8_input_main_prints_every_arm(self, capsys):
        result = t_q8.main(["--c", "256", "--heads", "2", "--tokens", "64", "--batch", "2",
                            "--iters", "1", "--layers", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "max|A-X(assembled)|=0.000000" in out and "max|C-X|=0.000000" in out
        assert result["numeric"]["A_assembled"] == 0.0 and result["numeric"]["C"] == 0.0
        # A and C run the redesigned forward's body and are held to it (A on the assembled tensor); A's
        # quantization leg to the mma.sync forward on the bf16 qkv
        assert result["references"]["C"].startswith("X: the redesigned forward")
        assert result["references"]["A_assembled"].startswith("X on the assembled tensor")
        assert result["references"]["A"].startswith("B: ") and set(result["references"]) == set(result["numeric"])
        assert 0.0 < result["numeric"]["A"] < 0.1  # the input quantization
        for name in ("A", "B", "C"):
            assert f"\n{name} (" in out
        assert "delta A/B" in out and "delta C/B" in out and "delta A/redesigned" in out
        assert result["arms"]["A"]["delta_vs_redesigned"] > 0

    @pytest.mark.parametrize("heads,skipped", [(16, {"C512", "C256", "C128"}), (12, {"C384", "C128"})])
    def test_wide_heads_skip_the_arms_the_jax_entry_skips(self, capsys, heads, skipped):
        """At C 3072 with heads of 192 (16) and 256 (12) channels every arm
        runs but those whose group is not whole heads (``cg % d``), which
        the JAX entry's assert fails to build; each prints its reason. Arm B
        is the shipped forward there (the mma.sync forward has no instance),
        so B reads 0 from X."""
        result = t_bb.main(["--c", "3072", "--heads", str(heads), "--tokens", "16", "--batch", "4",
                            "--iters", "1", "--layers", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        d = 3072 // heads
        assert set(result["skipped"]) == skipped
        for name in skipped:
            assert f"arm {name} skipped: cg=" in out and f"whole number of {d}-channel heads" in out
        assert set(result["arms"]) == {"B", "G", "S2", "D2", "D4", "C768", "C512", "C384", "C256", "C128",
                                       "P2"} - skipped
        assert all(v == 0.0 for v in result["numeric"].values())
        assert result["arm_B"] == f"the shipped forward (#1 at d {d})" and f"arm B: {result['arm_B']}" in out
        assert result["redesigned"]["max_abs_vs_B"] == 0.0 and "(B is X: expect 0.0)" in out

    def test_a_split_the_kernels_refuse_is_skipped(self, capsys):
        result = t_bb.main(["--c", "256", "--heads", "4", "--tokens", "64", "--batch", "2",
                            "--iters", "1", "--layers", "1", "--device", "cpu"])
        out = capsys.readouterr().out
        assert {"S2", "D2", "D4", "P2"} <= set(result["skipped"])
        assert "arm D4 skipped: " in out and set(result["arms"]) == {"B", "G", "C256", "C128"}
