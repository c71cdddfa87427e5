"""The port's CUDA kernels on the card, held against their plain PyTorch versions.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip without one.
The file imports neither JAX nor ``vitok_tpu``, so it also runs on a machine
that has only the port's dependencies; ``tests/conftest.py`` imports JAX, so
there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances. Attention, bf16 on the card, valid rows: max abs 2e-2 and mean
abs 2e-3. Both sides round P to bf16 before PV, but the kernel's online
softmax rounds it at running row maxima, in another order than the plain
version's (full-row for the fused kernel, 512-key blocks for the flash
kernel). The flash kernel's padded rows are exactly 0 on both sides, and its
log-sum-exp agrees within 1e-3 on live rows (+1e30 on dead rows). The quantize kernels: codes within one step in
at most 0.1% of the entries and scales within rtol 1e-5 (on the H100 they
agree bit for bit); pad columns exactly 0. Small int8 models: rel L2 2e-2
against the same model on the plain versions. The fused forward's
log-sum-exp agrees within 1e-3 on valid rows (1e30 on padded rows), and its
q/k prologue with the plain version's normed q/k to one bf16 step in at most
0.1% of the entries. The fused backward kernel and the int8-epilogue kernel
state their limits on their test classes, as do the fp32 instance and the
A/B kernels of ``vitok_torch.benchmarks``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vitok_torch.benchmarks import ab_batch_block as t_bb
from vitok_torch.benchmarks import ab_q8_input as t_ab8
from vitok_torch.models import ae as t_ae
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops import quant as t_q
from vitok_torch.ops.norms import rms_norm
from vitok_torch.ops.rope import apply_rotary_emb, compute_2d_freqs_cis

torch.set_num_threads(1)

CASES = [("none", False, None), ("tail", True, None), ("sw", False, 12), ("tail+sw", True, 12)]


def counts():
    """The fused attention kernels' launch counts."""
    return dict(fwd=t_fa.LAUNCHES, prologue=t_fa.PROLOGUE_LAUNCHES, bwd=t_fa.BWD_LAUNCHES, q8=t_fa.Q8_LAUNCHES,
                mma=t_fa.MMA_LAUNCHES, f32=t_fa.F32_LAUNCHES, f32_mma=t_fa.F32_MMA_LAUNCHES)


def added(before, **more):
    """``before`` with the named counts raised."""
    return {k: v + more.get(k, 0) for k, v in before.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


def assert_forward_close(got, want, mask):
    """Valid rows max abs 2e-2, mean 2e-3; padded rows, which may see few
    keys, within one bf16 step of |out| (2^-7 * |out|) against 2e-2."""
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    valid = err if mask is None else err[mask]
    assert valid.max().item() <= 2e-2 and valid.mean().item() <= 2e-3
    assert (err / want.abs().clamp(min=1.0)).max().item() <= 2e-2


def make_inputs(device, b=3, n=200, heads=2, d=64, masked=False, seed=0):
    """bf16 qkv, gains U(0.5, 1.5), 2D RoPE tables and a tail-suffix mask
    with another valid count per sample, from a numpy seed."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c), dtype=np.float32))
    qs = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    idx = np.arange(n)
    row = torch.from_numpy(np.tile(idx // 16, (b, 1)))
    col = torch.from_numpy(np.tile(idx % 16, (b, 1)))
    cos, sin = compute_2d_freqs_cis(row, col, d)
    mask = None
    if masked:  # sample 1 keeps 23 tokens: rows past 23 + sw see no valid key
        mask = torch.from_numpy(idx[None, :] < np.array([n, 23] + [n // 2] * (b - 2))[:, None])
    to = lambda t: None if t is None else t.to(device)
    return to(qkv).bfloat16(), to(qs), to(ks), to(cos), to(sin), to(mask)


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_kernel_matches_plain_bf16(self, cuda_device, d, case, masked, sw):
        """The redesigned forward: the q/k prologue, then the wgmma kernel."""
        qkv, *rest = make_inputs(cuda_device, d=d, masked=masked)
        before = counts()
        got = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=sw, impl="fused")
        assert counts() == added(before, fwd=1, prologue=1)
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=2, sliding_window=sw).float()
        assert_forward_close(got, want, rest[-1])

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_mma_kernel_matches_plain_bf16(self, cuda_device, d, case, masked, sw):
        """The mma.sync forward kept beside the redesign."""
        qkv, *rest = make_inputs(cuda_device, d=d, masked=masked)
        before = counts()
        got = t_fa.fused_qkv_attention_mma(qkv, *rest, num_heads=2, sliding_window=sw)
        assert counts() == added(before, mma=1)
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=2, sliding_window=sw).float()
        assert_forward_close(got, want, rest[-1])

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [200, 1024])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", None), ("none", 12), ("tail+dead", 40)])
    def test_lse_matches_plain(self, cuda_device, d, n, case, sw):
        """Asked for under grad, the forward also writes each row's
        log-sum-exp (log2 units; 1e30 on padded rows, an all-padding sample
        included) and the same output."""
        qkv, qs, ks, cos, sin, mask = make_inputs(cuda_device, d=d, n=n, masked=case != "none")
        if mask is not None:
            mask[-1] = False
        out, lse = t_fa._fused_cuda(qkv, qs, ks, cos, sin, mask, 2, sw, want_lse=True)
        want, want_lse = t_fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=2,
                                                        sliding_window=sw, return_lse=True)
        assert torch.equal(out, t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=2,
                                                         sliding_window=sw, impl="fused"))
        assert_forward_close(out, want.float(), mask)
        valid = torch.ones(out.shape[:2], dtype=torch.bool, device=cuda_device) if mask is None else mask
        assert (lse - want_lse).abs().transpose(1, 2)[valid].max().item() <= 1e-3
        assert (lse.transpose(1, 2)[~valid] == 1e30).all()

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("with_q", [True, False])
    def test_prologue_matches_plain(self, cuda_device, d, with_q):
        """q and k normed and rotated once (the forward's k alone), and the
        backward's delta."""
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, d=d)
        out = torch.randn(qkv.shape[0], qkv.shape[1], 2 * d, device=cuda_device).bfloat16()
        g = torch.randn_like(out)
        kw = dict(num_heads=2, out=out, dout=g, with_q=with_q)
        before = counts()
        qk, delta = t_fa.fused_qk_prologue(qkv, qs, ks, cos, sin, **kw)
        assert counts() == added(before, prologue=1)
        want, want_delta = t_fa.fused_qk_prologue_plain(qkv, qs, ks, cos, sin, **kw)
        torch.cuda.synchronize()
        assert qk.shape == want.shape
        err = (qk.float() - want.float()).abs()
        assert err.max().item() <= 2 ** -5 and (err > 0).float().mean().item() <= 1e-3
        assert (delta - want_delta).abs().max().item() <= 1e-5 * want_delta.abs().max().item() + 1e-6

    def test_ragged_and_dead_rows(self, cuda_device):
        """N a multiple of 8 and not of 64, a window, an all-padding sample
        (every row the mean of v over all N keys)."""
        qkv, qs, ks, cos, sin, mask = make_inputs(cuda_device, b=3, n=136, d=128, masked=True)
        mask[-1] = False
        got = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=20, impl="fused")
        want = t_fa.fused_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=20)
        assert_forward_close(got, want.float(), mask)
        mean_v = qkv[-1, :, 4 * 128:].float().mean(0)
        assert (got[-1].float() - mean_v).abs().max().item() <= 2e-2

    def test_long_sequence_routes_through_flash(self, cuda_device):
        """At N = 2048 the fused kernel's gate refuses: the prologue norms and
        rotates q and k, and the flash kernel takes them with v as a view of
        qkv (the fold)."""
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, b=1, n=2048, heads=1, d=64)
        fused, flash, prologue = t_fa.LAUNCHES, t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES
        got = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, num_heads=1)
        assert (t_fa.LAUNCHES, t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES) == (fused, flash + 1, prologue + 1)
        q, k, v = qkv.view(1, 2048, 3, 1, 64).unbind(2)
        q, k = apply_rotary_emb(rms_norm(q, qs), rms_norm(k, ks), cos, sin, convention="half")
        want = t_fl.flash_attention_plain(q, k, v).reshape(got.shape).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3

    def test_kernel_rejects_fp32(self, cuda_device):
        """fp32 has an instance of the forward only: a gradient through it
        raises in the forward, before anything launches, and fp16 has no
        instance at all."""
        qkv, *rest = make_inputs(cuda_device)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention(qkv.half(), *rest, num_heads=2, impl="fused")
        x = qkv.float().requires_grad_()
        before = counts()
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention(x, *rest, num_heads=2, impl="fused")
        assert counts() == before

    def test_kernel_rejects_ragged_rows(self, cuda_device):
        """N must be a multiple of 8 (the gate's own condition)."""
        qkv, *rest = make_inputs(cuda_device, n=100)
        with pytest.raises(ValueError, match="multiple of 8"):
            t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, impl="fused")

    def test_kernel_rejects_unsupported_head_dim(self, cuda_device):
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, heads=4, d=32)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, num_heads=4, impl="fused")

    def test_model_routes_every_block_through_the_kernel(self, cuda_device):
        """A small bf16 AE on the card: one launch per block, and decoded
        patches within rel L2 2e-2 of the same weights on the unfused path."""
        cfg = t_ae.AEConfig.from_variant("w128_d2_h2-w128_d3_h2/1x16x8")
        gen = torch.Generator().manual_seed(0)
        n, grids = 64, [(8, 8), (5, 7)]
        batch = {
            "patches": torch.randn(2, n, 768, generator=gen),
            "patch_mask": torch.zeros(2, n, dtype=torch.bool),
            "row_idx": torch.zeros(2, n, dtype=torch.int32),
            "col_idx": torch.zeros(2, n, dtype=torch.int32),
        }
        for i, (gr, gc) in enumerate(grids):
            batch["patch_mask"][i, : gr * gc] = True
            batch["row_idx"][i, : gr * gc] = torch.arange(gr * gc) // gc
            batch["col_idx"][i, : gr * gc] = torch.arange(gr * gc) % gc
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        model = t_ae.AE(**dataclasses.asdict(cfg), device=cuda_device)
        card_gen = torch.Generator(device=cuda_device).manual_seed(1)
        with torch.no_grad():  # LayerScale gains ~ U(0.5, 1.5): every block matters
            for blk in [*model.encoder_blocks, *model.decoder_blocks]:
                blk.layer_scale.gamma.uniform_(0.5, 1.5, generator=card_gen)
        reference = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "xla"},
                            state_dict=model.state_dict(), device=cuda_device)
        before = t_fa.LAUNCHES
        got = model(batch)["patches"]
        assert t_fa.LAUNCHES - before == cfg.encoder_depth + cfg.decoder_depth
        want = reference(batch)["patches"]
        valid = batch["patch_mask"]
        a, r = got[valid].float(), want[valid].float()
        assert torch.isfinite(a).all()
        assert ((a - r).norm() / r.norm()).item() <= 2e-2


def flash_inputs(device, b=3, n=300, heads=2, d=64, masked=False, seed=0):
    """bf16 q, k, v as strided views of one [B, N, 3, H, D] tensor (as the
    model hands them) and a tail-suffix mask in which sample 1 keeps a third
    of its tokens and sample 2 none, from a numpy seed."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3, heads, d), dtype=np.float32))
    q, k, v = qkv.to(device).bfloat16().unbind(2)
    mask = None
    if masked:
        valid = np.array([n, n // 3, 0] + [n // 2] * (b - 3))
        mask = torch.from_numpy(np.arange(n)[None, :] < valid[:, None]).to(device)
    return q, k, v, mask


@pytest.mark.cuda
class TestFlashKernelOnCard:
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n,sw", [(300, 40), (2100, 256)])
    @pytest.mark.parametrize("case", ["none", "tail", "sw", "tail+sw"])
    def test_kernel_matches_plain_bf16(self, cuda_device, d, n, sw, case):
        q, k, v, mask = flash_inputs(cuda_device, n=n, d=d, masked="tail" in case)
        sw = sw if "sw" in case else None
        before = t_fl.LAUNCHES
        got, lse = t_fl.flash_attention(q, k, v, mask, sw, return_lse=True)
        assert t_fl.LAUNCHES == before + 1
        want, want_lse = t_fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == torch.bfloat16 and lse.shape == (3, 2, n)
        err = (got.float() - want.float()).abs()
        if mask is not None:
            assert not got[~mask].any() and not want[~mask].any()  # padded rows exactly 0
            err = err[mask]
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3
        live = want_lse < 1e29
        assert torch.equal(lse < 1e29, live) and (lse[~live] == 1e30).all()
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-3

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [300, 2100])
    @pytest.mark.parametrize("sw", [None, 64, 1024])
    @pytest.mark.parametrize("masked", [False, True])
    def test_redesigned_kernel_within_the_flash_limits(self, cuda_device, d, n, sw, masked):
        """The wgmma kernel (two warpgroups of 64 query rows a block) at
        ragged N, with a tail and an all-padding sample, against the plain
        version under ``chip_smoke.py``'s flash limits: valid rows max 8e-3,
        mean 2e-4; lse 1e-3 on live rows, +1e30 on dead rows on both sides;
        padded rows exactly 0."""
        q, k, v, mask = flash_inputs(cuda_device, n=n, d=d, masked=masked, seed=n + d)
        got, lse = t_fl.flash_attention(q, k, v, mask, sw, return_lse=True)
        want, want_lse = t_fl.flash_attention_plain(q, k, v, mask, sw, return_lse=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if mask is not None:
            assert not got[~mask].any() and not want[~mask].any()
            err = err[mask]
        assert err.max().item() <= 8e-3 and err.mean().item() <= 2e-4
        live = want_lse < 1e29
        assert torch.equal(lse < 1e29, live) and (lse[~live] == 1e30).all()
        assert (lse[live] - want_lse[live]).abs().max().item() <= 1e-3
        if masked:  # the all-padding sample has no live row
            assert not live[2].any()

    def test_kernel_reads_strided_views(self, cuda_device):
        """q and k as views of a [B, N, 2C] scratch and v of a [B, N, 3C]
        tensor (what the fold hands over) give the bits of contiguous copies."""
        q, k, v, mask = flash_inputs(cuda_device, n=2100, masked=True)
        got = t_fl.flash_attention(q, k, v, mask, 256)
        want = t_fl.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask, 256)
        assert torch.equal(got, want)

    def test_kernel_rejects_fp32(self, cuda_device):
        q, k, v, _ = flash_inputs(cuda_device)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fl.flash_attention(q.float(), k.float(), v.float())

    def test_kernel_rejects_unsupported_head_dim(self, cuda_device):
        q, k, v, _ = flash_inputs(cuda_device, d=32)
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, k, v)


@pytest.mark.cuda
class TestFlashFoldOnCard:
    """The fold (the q/k prologue, then the flash kernel, from the flat QKV)
    against its plain version under the flash limits, and its routing."""

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sw", [None, 256])
    @pytest.mark.parametrize("masked", [False, True])
    def test_fold_matches_plain(self, cuda_device, d, sw, masked):
        qkv, qs, ks, cos, sin, mask = make_inputs(cuda_device, b=3, n=2100, heads=2, d=d, masked=masked)
        before = (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fa.LAUNCHES)
        got = t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=sw)
        assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fa.LAUNCHES) == (before[0] + 1, before[1] + 1, before[2])
        want = t_fa.flash_qkv_attention_plain(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=sw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if mask is not None:
            assert not got[~mask].any() and not want[~mask].any()
            err = err[mask]
        assert err.max().item() <= 8e-3 and err.mean().item() <= 2e-4

    def test_unfused_branch_takes_the_fold_without_grad_only(self, cuda_device):
        """The unfused branch takes the fold without grad and, since the
        fold has a backward, under grad too (the name is kept from when it
        took it without grad only): the prologue and #4 forward, the
        prologue again and the dq and dk/dv kernels backward, no eager q/k
        norm or rotation."""
        qkv, *rest = make_inputs(cuda_device, b=2, n=2048, heads=2, d=64, masked=True)
        before = (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES)
        with torch.no_grad():
            t_fa.unfused_qkv_attention(qkv, *rest, 2, 300)
        assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES) == (before[0] + 1, before[1] + 1)
        x = qkv.detach().clone().requires_grad_(True)
        out = t_fa.unfused_qkv_attention(x, *rest, 2, 300)  # the fold's autograd Function
        assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES) == (before[0] + 2, before[1] + 2)
        out.float().square().sum().backward()
        assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES) == (
            before[0] + 2, before[1] + 3, before[2] + 1, before[3] + 1)
        assert torch.isfinite(x.grad).all() and x.grad.any()


@pytest.mark.cuda
class TestInferenceModeOnCard:
    """Under ``torch.inference_mode()``, the usual serving context, every
    tensor made is an inference tensor, which tracks no version: the flash
    kernel, the fold and a 2048-token AE give the bits they give under
    ``torch.no_grad()``, with the same launches."""

    def test_flash_kernel_and_fold(self, cuda_device):
        q, k, v, mask = flash_inputs(cuda_device, n=2100, masked=True)
        qkv, qs, ks, cos, sin, fold_mask = make_inputs(cuda_device, b=3, n=2100, heads=2, d=64, masked=True)
        fold = lambda m: t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, m, num_heads=2, sliding_window=256)
        with torch.no_grad():
            want, want_fold = t_fl.flash_attention(q, k, v, mask, 256), fold(fold_mask)
        with torch.inference_mode():
            mask, fold_mask = mask.clone(), fold_mask.clone()
            assert mask.is_inference() and fold_mask.is_inference()
            before = (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES)
            got, got_fold = t_fl.flash_attention(q, k, v, mask, 256), fold(fold_mask)
            assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES) == (before[0] + 2, before[1] + 1)
        assert torch.equal(got, want) and torch.equal(got_fold, want_fold)

    def test_ae_at_2048_tokens(self, cuda_device):
        cfg = t_ae.AEConfig.from_variant("w128_d2_h2-w128_d2_h2/1x16x8")
        gen = torch.Generator().manual_seed(0)
        n, grids = 2048, [(48, 40), (32, 32)]
        batch = {
            "patches": torch.randn(2, n, 768, generator=gen),
            "patch_mask": torch.zeros(2, n, dtype=torch.bool),
            "row_idx": torch.zeros(2, n, dtype=torch.int32),
            "col_idx": torch.zeros(2, n, dtype=torch.int32),
        }
        for i, (gr, gc) in enumerate(grids):
            batch["patch_mask"][i, : gr * gc] = True
            batch["row_idx"][i, : gr * gc] = torch.arange(gr * gc) // gc
            batch["col_idx"][i, : gr * gc] = torch.arange(gr * gc) % gc
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        model = t_ae.AE(**{**dataclasses.asdict(cfg), "sw": 256}, device=cuda_device)
        depth = cfg.encoder_depth + cfg.decoder_depth
        with torch.no_grad():
            want = model.decode(model.encode(batch))["patches"]
        with torch.inference_mode():
            before = (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES)
            z = model.encode(batch)
            assert z["z"].is_inference()
            got = model.decode(z)["patches"]
            assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES) == (before[0] + depth, before[1] + depth)
        assert torch.isfinite(got).all() and torch.equal(got, want)


@pytest.mark.cuda
class TestWideHeadsOnCard:
    """Head dims the kernels have no instance for (192, 256) take the
    unfused composition on the card, where the JAX package's gates (a
    multiple of 64) would open: the same function, no kernel launched."""

    @pytest.mark.parametrize("n,grids", [(256, [(16, 16), (12, 15)]), (2048, [(48, 40), (32, 32)])])
    def test_d256_ae_matches_its_plain_path(self, cuda_device, n, grids):
        cfg = t_ae.AEConfig.from_variant("w1024_d2_h4-w1024_d2_h4/1x16x64")
        assert cfg.encoder_width // cfg.encoder_heads == 256
        gen = torch.Generator().manual_seed(0)
        batch = {
            "patches": torch.randn(2, n, 768, generator=gen),
            "patch_mask": torch.zeros(2, n, dtype=torch.bool),
            "row_idx": torch.zeros(2, n, dtype=torch.int32),
            "col_idx": torch.zeros(2, n, dtype=torch.int32),
        }
        for i, (gr, gc) in enumerate(grids):
            batch["patch_mask"][i, : gr * gc] = True
            batch["row_idx"][i, : gr * gc] = torch.arange(gr * gc) // gc
            batch["col_idx"][i, : gr * gc] = torch.arange(gr * gc) % gc
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        model = t_ae.AE(**dataclasses.asdict(cfg), device=cuda_device)
        reference = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "xla"},
                            state_dict=model.state_dict(), device=cuda_device)
        before = (counts(), t_fl.LAUNCHES)
        got = model(batch)["patches"]
        torch.cuda.synchronize()
        assert (counts(), t_fl.LAUNCHES) == before
        want = reference(batch)["patches"]
        valid = batch["patch_mask"]
        a, r = got[valid].float(), want[valid].float()
        assert torch.isfinite(a).all()
        assert ((a - r).norm() / r.norm()).item() <= 2e-2

    def test_gates_close_and_forced_kernels_raise(self, cuda_device):
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, b=1, n=256, heads=1, d=256)
        assert not t_fa.can_fuse(256, 256, 1, cuda=True) and t_fa.can_fuse(256, 256, 1)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, num_heads=1, impl="fused")
        q = qkv[..., :256].view(1, 256, 1, 256)
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, q, q)


def _bwd_case(device, n, d, case, sw):
    """q, k, v, mask, window, then the forward's output and log-sum-exp and a
    seed-made cotangent that reaches the wrapper as a strided view."""
    q, k, v, mask = flash_inputs(device, n=n, d=d, masked="tail" in case or "hole" in case)
    if "hole" in case:  # a run of padding inside sample 0's valid range
        mask[0, 100:140] = False
    sw = sw if "sw" in case else None
    out, lse = t_fl.flash_attention(q, k, v, mask, sw, return_lse=True)
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((*q.shape[:3], 2 * d), dtype=np.float32))
    g = g.to(device).bfloat16()[..., :d]  # token and head strides of 2d: not contiguous
    return q, k, v, mask, sw, out, lse, g


@pytest.mark.cuda
class TestFlashBackwardOnCard:
    """The dq and dk/dv kernels against ``flash_attention_bwd_plain``. Both
    sides round p and ds to bf16 before the products that contract them; the
    kernel sums 64-row tiles, the plain version 1024-query blocks, and the
    kernel takes exp2 of a fused multiply-add. Limits relative to each
    gradient's largest entry: max 2e-2, mean 2e-3."""

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n,sw", [(300, 40), (2100, 256)])
    @pytest.mark.parametrize("case", ["none", "tail", "sw", "tail+sw", "hole+sw"])
    def test_kernels_match_plain_bf16(self, cuda_device, d, n, sw, case):
        q, k, v, mask, sw, out, lse, g = _bwd_case(cuda_device, n, d, case, sw)
        before = (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES)
        got = t_fl.flash_attention_bwd(q, k, v, out, lse, g, mask, sw)
        assert (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES) == (
            before[0], before[1] + 1, before[2] + 1)
        again = t_fl.flash_attention_bwd(q, k, v, out, lse, g, mask, sw)
        want = t_fl.flash_attention_bwd_plain(q, k, v, out, lse, g, mask, sw)
        torch.cuda.synchronize()
        for name, a, a2, r in zip(("dq", "dk", "dv"), got, again, want):
            assert a.shape == q.shape and a.dtype == torch.bfloat16 and a.is_contiguous()
            assert torch.equal(a, a2), f"{name}: two runs differ"
            assert torch.isfinite(a).all()
            if mask is not None:  # padded rows exactly 0 on both sides
                assert not a[~mask].any() and not r[~mask].any(), name
            err = (a.float() - r.float()).abs()
            scale = r.float().abs().max().item()
            assert scale > 0
            assert err.max().item() <= 2e-2 * scale and err.mean().item() <= 2e-3 * scale, (
                name, err.max().item(), err.mean().item(), scale)

    def test_autograd_function_launches_both_kernels(self, cuda_device):
        q, k, v, mask = flash_inputs(cuda_device, n=300, masked=True)
        q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        before = (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES)
        out = t_fl.flash_attention(q, k, v, mask, 40)
        w = torch.linspace(0.5, 1.5, 300, device=cuda_device)[None, :, None, None]
        (out.float() * w).square().sum().backward()
        torch.cuda.synchronize()
        assert (t_fl.LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES) == tuple(x + 1 for x in before)
        for t in (q, k, v):
            assert t.grad is not None and torch.isfinite(t.grad).all() and t.grad.any()
            assert not t.grad[~mask].any()

    def test_fused_kernel_refuses_a_gradient(self, cuda_device):
        """Asked for by name under grad, the fused attention kernel runs with
        its backward kernel (it refused a gradient until that kernel was
        written); ``impl="auto"`` still takes the unfused composition under
        grad, and then no fused launch is counted."""
        qkv, *rest = make_inputs(cuda_device, masked=True)
        qkv.requires_grad_(True)
        before = (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES)
        out = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, impl="fused")
        out.float().square().sum().backward()
        assert (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        fused_grad, qkv.grad = qkv.grad, None
        out = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2)
        out.float().square().sum().backward()
        assert (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
        assert torch.isfinite(qkv.grad).all() and qkv.grad.any() and torch.isfinite(fused_grad).all()

    def test_backward_rejects_fp32(self, cuda_device):
        q, k, v, _ = flash_inputs(cuda_device)
        out, lse = t_fl.flash_attention(q, k, v, return_lse=True)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fl.flash_attention_bwd(q.float(), k.float(), v.float(), out.float(), lse, out.float())


@pytest.mark.cuda
class TestFlashFoldBackwardOnCard:
    """The fold's backward (the q/k prologue, then the dq and dk/dv kernels'
    fold instances, which end in the norm and rotation backward) through its
    autograd Function, against ``flash_qkv_attention_bwd_plain`` given the
    same forward output and log-sum-exp. Limits: the fused backward's (#3's
    function and rounding points): dqkv max 4e-2 and mean 1.5e-3 of its
    largest entry on valid rows, the gains' gradients 3e-2."""

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("sw", [None, 256])
    @pytest.mark.parametrize("masked", [False, True])
    def test_function_matches_plain(self, cuda_device, d, sw, masked):
        qkv, qs, ks, cos, sin, mask = make_inputs(cuda_device, b=3, n=2100, heads=2, d=d, masked=masked)
        dout = torch.from_numpy(np.random.default_rng(5).standard_normal((3, 2100, 2 * d), dtype=np.float32))
        dout = dout.to(cuda_device).bfloat16()

        def grads():
            x, a, k = (t.detach().clone().requires_grad_(True) for t in (qkv, qs, ks))
            out = t_fa.flash_qkv_attention(x, a, k, cos, sin, mask, num_heads=2, sliding_window=sw)
            return torch.autograd.grad(out, (x, a, k), dout)

        before = (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES, t_fa.LAUNCHES)
        got = grads()
        assert (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fl.DQ_LAUNCHES, t_fl.DKV_LAUNCHES, t_fa.LAUNCHES) == (
            before[0] + 1, before[1] + 2, before[2] + 1, before[3] + 1, before[4])
        again = grads()
        out, lse = t_fa._flash_fold_cuda(qkv, qs, ks, cos, sin, mask, 2, sw, want_lse=True)
        want = t_fa.flash_qkv_attention_bwd_plain(qkv, qs, ks, cos, sin, mask, dout, num_heads=2,
                                                  sliding_window=sw, out=out, lse=lse)
        torch.cuda.synchronize()
        for a, a2 in zip(got, again):
            assert torch.equal(a, a2), "two runs differ"
        dqkv, ref = got[0].float(), want[0].float()
        assert got[0].shape == qkv.shape and got[0].dtype == torch.bfloat16 and torch.isfinite(dqkv).all()
        err, scale = (dqkv - ref).abs(), ref.abs().max().item()
        if mask is not None:
            assert not dqkv[~mask].any() and not ref[~mask].any()
            err = err[mask]
        assert err.max().item() <= 4e-2 * scale and err.mean().item() <= 1.5e-3 * scale
        for a, r in zip(got[1:], want[1:]):
            assert a.dtype == torch.float32 and (a - r).abs().max().item() <= 3e-2 * r.abs().max().item()

    def test_training_blocks_launch_the_fold(self, cuda_device):
        """A training forward + backward at 2048 tokens: per block one
        prologue and #4 forward, one prologue, dq and dk/dv backward (with
        ``checkpoint=1`` a second prologue and #4 per block); the parameter
        gradients within rel L2 2e-2 of the same step with the plain
        backwards, and the recomputed step's loss the stored one's."""
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d2_h2/1x16x8")
        model = t_ae.AE(**{**dataclasses.asdict(cfg), "sw": 256}, seed=0, device=cuda_device,
                        param_dtype=torch.float32, trainable=True)
        depth = cfg.encoder_depth + cfg.decoder_depth
        n, rng = 2048, np.random.default_rng(0)
        batch = {"patches": torch.from_numpy(rng.standard_normal((2, n, 768), dtype=np.float32)),
                 "patch_mask": torch.from_numpy(np.arange(n)[None, :] < np.array([[n], [1500]])),
                 "row_idx": torch.from_numpy(np.tile(np.arange(n) // 64, (2, 1))),
                 "col_idx": torch.from_numpy(np.tile(np.arange(n) % 64, (2, 1)))}
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        params = list(model.parameters())

        def grads():  # the same drop-path uniforms every call
            gen = torch.Generator(device=cuda_device).manual_seed(3)
            out = model(batch, deterministic=False, generator=gen)["patches"]
            loss = out.float().square().mean()
            return loss.detach(), torch.autograd.grad(loss, params)

        names = ("flash", "prologue", "dq", "dkv", "fused")
        counts_now = lambda: dict(zip(names, (t_fl.LAUNCHES, t_fa.PROLOGUE_LAUNCHES, t_fl.DQ_LAUNCHES,
                                              t_fl.DKV_LAUNCHES, t_fa.LAUNCHES)))
        before = counts_now()
        loss, kernel = grads()
        assert counts_now() == {k: v + {"flash": depth, "prologue": 2 * depth, "dq": depth, "dkv": depth}.get(k, 0)
                                for k, v in before.items()}
        saved = t_fl.flash_attention_bwd, t_fa.flash_qkv_attention_bwd
        t_fl.flash_attention_bwd, t_fa.flash_qkv_attention_bwd = (t_fl.flash_attention_bwd_plain,
                                                                   t_fa.flash_qkv_attention_bwd_plain)
        try:
            _, plain = grads()
        finally:
            t_fl.flash_attention_bwd, t_fa.flash_qkv_attention_bwd = saved
        num = sum((a.double() - b.double()).square().sum() for a, b in zip(kernel, plain))
        den = sum(b.double().square().sum() for b in plain)
        assert all(torch.isfinite(g).all() for g in kernel) and (num / den).sqrt().item() <= 2e-2
        model.cfg = dataclasses.replace(model.cfg, checkpoint=1)
        before = counts_now()
        remat_loss, _ = grads()
        assert counts_now() == {k: v + {"flash": 2 * depth, "prologue": 3 * depth, "dq": depth,
                                        "dkv": depth}.get(k, 0) for k, v in before.items()}
        assert remat_loss.item() == loss.item()


def _fused_bwd_case(device, d, case, n=200, sw=12):
    """The forward kernel's inputs (sample 1 keeps 23 tokens; with "dead" the
    last sample is all padding) and a bf16 cotangent."""
    qkv, qs, ks, cos, sin, mask = make_inputs(device, d=d, n=n, masked=case != "none" and "sw" != case)
    if "dead" in case:
        mask[-1] = False
    g = torch.from_numpy(np.random.default_rng(9).standard_normal((*qkv.shape[:2], 2 * d), dtype=np.float32))
    return (qkv, qs, ks, cos, sin, mask), g.to(device).bfloat16(), (sw if "sw" in case else None)


@pytest.mark.cuda
class TestFusedBackwardOnCard:
    """The fused backward (the q/k prologue, then the dq and dk/dv kernels),
    given the forward kernel's output and log-sum-exp, against
    ``fused_qkv_attention_bwd_plain`` given the same output. Both sides round
    p and ds to bf16 before the products that contract them and the outputs
    to bf16; the kernel forms p from the forward's log-sum-exp in log2 units,
    the plain version from the full row. Limits relative to each gradient's
    largest entry: dq, dk, dv max 4e-2 and mean 1.5e-3, the gain gradients
    3e-2 (about three times the readings on an H100)."""

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [200, 1000])
    @pytest.mark.parametrize("case", ["none", "tail", "sw", "tail+sw", "tail+sw+dead"])
    def test_kernel_matches_plain_bf16(self, cuda_device, d, n, case):
        args, g, sw = _fused_bwd_case(cuda_device, d, case, n=n)
        mask = args[5]
        out, lse = t_fa._fused_cuda(*args, 2, sw, want_lse=True)
        before = counts()
        got = t_fa.fused_qkv_attention_bwd(*args, g, num_heads=2, sliding_window=sw, out=out, lse=lse)
        assert counts() == added(before, bwd=1, prologue=1)
        again = t_fa.fused_qkv_attention_bwd(*args, g, num_heads=2, sliding_window=sw, out=out, lse=lse)
        want = t_fa.fused_qkv_attention_bwd_plain(*args, g, num_heads=2, sliding_window=sw, out=out)
        torch.cuda.synchronize()
        for a, a2 in zip(got, again):
            assert torch.equal(a, a2), "two runs differ"
        dqkv, dqs, dks = got
        assert dqkv.shape == args[0].shape and dqkv.dtype == torch.bfloat16
        assert dqs.dtype == dks.dtype == torch.float32 and dqs.shape == (d,)
        assert torch.isfinite(dqkv).all()
        if mask is not None:
            assert not dqkv[~mask].any() and not want[0][~mask].any()
        c = 2 * d
        for i, name in enumerate(("dq", "dk", "dv")):
            a, r = dqkv[..., i * c:(i + 1) * c].float(), want[0][..., i * c:(i + 1) * c].float()
            err, scale = (a - r).abs(), r.abs().max().item()
            assert err.max().item() <= 4e-2 * scale and err.mean().item() <= 1.5e-3 * scale, (
                name, err.max().item(), err.mean().item(), scale)
        for a, r in ((dqs, want[1]), (dks, want[2])):
            assert (a - r).abs().max().item() <= 3e-2 * r.abs().max().item()

    def test_autograd_function_runs_both_kernels(self, cuda_device):
        (qkv, qs, ks, cos, sin, mask), g, sw = _fused_bwd_case(cuda_device, 64, "tail+sw")
        qkv, qs, ks = (t.detach().clone().requires_grad_(True) for t in (qkv, qs, ks))
        before = counts()
        out = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=sw, impl="fused")
        dqkv, dqs, dks = torch.autograd.grad(out, (qkv, qs, ks), g)
        torch.cuda.synchronize()
        assert counts() == added(before, fwd=1, bwd=1, prologue=2)
        # Without out and lse the backward runs the forward first: the same bits.
        want = t_fa.fused_qkv_attention_bwd(qkv.detach(), qs.detach(), ks.detach(), cos, sin, mask, g,
                                            num_heads=2, sliding_window=sw)
        assert torch.equal(dqkv, want[0]) and torch.equal(dqs, want[1]) and torch.equal(dks, want[2])
        assert not dqkv[~mask].any()

    def test_backward_rejects_fp32_and_other_head_dims(self, cuda_device):
        args, g, _ = _fused_bwd_case(cuda_device, 64, "none")
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention_bwd(args[0].float(), *args[1:], g.float(), num_heads=2)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention_bwd(*args, g, num_heads=4)  # d = 32
        with pytest.raises(ValueError, match="dout"):
            t_fa.fused_qkv_attention_bwd(*args, g[:, :-8], num_heads=2)

    def test_training_blocks_launch_forward_and_backward(self, cuda_device):
        """A training forward + backward with ``attn_impl="fused"`` launches
        the fused kernel and its backward once per block, and its parameter
        gradients agree with ``attn_impl="auto"`` (rel L2 2e-2)."""
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d2_h2/1x16x8", attn_impl="fused")
        model = t_ae.AE(**dataclasses.asdict(cfg), seed=0, device=cuda_device,
                        param_dtype=torch.float32, trainable=True)
        rng = np.random.default_rng(0)
        batch = {"patches": torch.from_numpy(rng.standard_normal((2, 64, 768), dtype=np.float32)),
                 "patch_mask": torch.from_numpy(np.arange(64)[None, :] < np.array([[64], [40]])),
                 "row_idx": torch.from_numpy(np.tile(np.arange(64) // 8, (2, 1))),
                 "col_idx": torch.from_numpy(np.tile(np.arange(64) % 8, (2, 1)))}
        params = list(model.parameters())

        def grads():
            out = model(batch, deterministic=False)["patches"]
            return torch.autograd.grad(out.float().square().mean(), params)

        before = (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES)
        fused = grads()
        assert (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES) == (before[0] + 3, before[1] + 3)
        model.cfg = dataclasses.replace(model.cfg, attn_impl="auto")
        auto = grads()
        assert (t_fa.LAUNCHES, t_fa.BWD_LAUNCHES) == (before[0] + 3, before[1] + 3)
        num = sum((a.double() - b.double()).square().sum() for a, b in zip(fused, auto))
        den = sum(b.double().square().sum() for b in auto)
        assert (num / den).sqrt().item() <= 2e-2


@pytest.mark.cuda
class TestQ8OnCard:
    """The int8-epilogue kernel: its codes and scales are
    ``quantize_activation`` of the mma.sync forward's output bit for bit (one
    attention body, the same IEEE divisions); against the plain version its
    dequantized values are held to the forward kernel's limits plus half a
    quantization step (max 3e-2, mean 3e-3)."""

    @pytest.mark.parametrize("heads,d", [(2, 64), (16, 64), (3, 128), (24, 128), (7, 64)])
    @pytest.mark.parametrize("case,masked,sw", CASES)
    def test_codes_equal_quantized_forward(self, cuda_device, heads, d, case, masked, sw):
        qkv, *rest = make_inputs(cuda_device, heads=heads, d=d, masked=masked)
        before = (t_fa.LAUNCHES, t_fa.Q8_LAUNCHES)
        codes, scales = t_fa.fused_qkv_attention_q8(qkv, *rest, num_heads=heads, sliding_window=sw)
        assert (t_fa.LAUNCHES, t_fa.Q8_LAUNCHES) == (before[0], before[1] + 1)
        fwd = t_fa.fused_qkv_attention_mma(qkv, *rest, num_heads=heads, sliding_window=sw)
        want_codes, want_scales = t_q.quantize_activation(fwd)
        torch.cuda.synchronize()
        assert codes.dtype == torch.int8 and scales.shape == (*qkv.shape[:2], 1)
        assert torch.equal(codes, want_codes) and torch.equal(scales, want_scales)
        p_codes, p_scales = t_fa.fused_qkv_attention_q8_plain(qkv, *rest, num_heads=heads, sliding_window=sw)
        err = (codes.float() * scales - p_codes.float() * p_scales).abs()
        mask = rest[-1]
        if mask is not None:
            err = err[mask]
        assert err.max().item() <= 3e-2 and err.mean().item() <= 3e-3

    def test_rejects_fp32_and_thirteen_wide_heads(self, cuda_device):
        qkv, *rest = make_inputs(cuda_device)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention_q8(qkv.float(), *rest, num_heads=2)
        qkv, *rest = make_inputs(cuda_device, b=1, n=64, heads=13, d=128)
        with pytest.raises(ValueError, match="cluster"):
            t_fa.fused_qkv_attention_q8(qkv, *rest, num_heads=13)

    def test_int8_blocks_take_the_epilogue_when_opted_in(self, cuda_device, monkeypatch):
        """With the opt-in each int8 block launches the epilogue kernel and no
        forward; the output equals the opt-in off on the mma.sync forward,
        whose attention body the epilogue kernel shares."""
        cfg = t_ae.AEConfig.from_variant("w256_d1_h4-w256_d2_h4/1x16x8")
        model = t_ae.AE(**dataclasses.asdict(cfg), seed=0, device=cuda_device).quantize()
        rng = np.random.default_rng(0)
        batch = {"patches": torch.from_numpy(rng.standard_normal((2, 64, 768), dtype=np.float32)),
                 "patch_mask": torch.from_numpy(np.arange(64)[None, :] < np.array([[64], [40]])),
                 "row_idx": torch.from_numpy(np.tile(np.arange(64) // 8, (2, 1))),
                 "col_idx": torch.from_numpy(np.tile(np.arange(64) % 8, (2, 1)))}
        with monkeypatch.context() as m:
            m.setattr(t_fa, "_fused_cuda", lambda *a: (t_fa._mma_cuda(*a[:8]), None))  # no lse in inference
            off = model(batch)["patches"]
        monkeypatch.setattr(t_fa, "_ENABLE_Q8", True)
        before = (t_fa.LAUNCHES, t_fa.Q8_LAUNCHES)
        on = model(batch)["patches"]
        torch.cuda.synchronize()
        assert (t_fa.LAUNCHES, t_fa.Q8_LAUNCHES) == (before[0], before[1] + 3)
        assert torch.equal(on, off)


def assert_codes_close(got, want, pad_from=None):
    (q, s), (q_ref, s_ref) = got, want
    torch.cuda.synchronize()
    diff = (q.int() - q_ref.int()).abs()
    assert diff.max().item() <= 1 and (diff > 0).float().mean().item() <= 1e-3
    assert ((s - s_ref).abs() / s_ref.abs()).max().item() <= 1e-5
    if pad_from is not None:
        assert not q[..., pad_from:].any().item()


def _quant_inputs(device, m, c, f, seed=0):
    """bf16 residual rows, a gain, the padded bf16 fc1 output, and int8
    activations with a padded int8 fc1 weight, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    fp = t_q.pad_ffn_dim(f)
    x = (2 * torch.randn(m, c, generator=gen)).bfloat16()
    gain = 0.5 + torch.rand(c, generator=gen)
    hid = torch.zeros(m, 2 * fp)
    hid[:, :f] = torch.randn(m, f, generator=gen)
    hid[:, fp:fp + f] = 2 * torch.randn(m, f, generator=gen)
    hq, hs = t_q.quantize_activation(torch.randn(m, c, generator=gen))
    w, ws = t_q.quantize_weight(t_q.pad_fc1_weight(0.05 * torch.randn(2 * f, c, generator=gen)))
    return [t.to(device) for t in (x, gain, hid.bfloat16(), hq, hs, w, ws)]


@pytest.mark.cuda
class TestQuantKernelsOnCard:
    @pytest.mark.parametrize("m,c", [(40, 1024), (200, 1728)])
    def test_rmsnorm_quant_matches_plain(self, cuda_device, m, c):
        x, gain, *_ = _quant_inputs(cuda_device, m, c, 136)
        before = t_q.LAUNCHES["rmsnorm_quant"]
        got = t_q.fused_rmsnorm_quant(x.view(2, m // 2, c), gain)
        assert t_q.LAUNCHES["rmsnorm_quant"] == before + 1
        assert got[0].shape == (2, m // 2, c) and got[1].shape == (2, m // 2, 1)
        assert_codes_close(got, t_q.fused_rmsnorm_quant_plain(x.view(2, m // 2, c), gain))

    @pytest.mark.parametrize("m,f", [(40, 2736), (200, 4608)])
    def test_silu_quant_matches_plain(self, cuda_device, m, f):
        _, _, hid, *_ = _quant_inputs(cuda_device, m, 128, f)
        before = t_q.LAUNCHES["silu_quant"]
        got = t_q.fused_silu_quant(hid)
        assert t_q.LAUNCHES["silu_quant"] == before + 1
        assert_codes_close(got, t_q.fused_silu_quant_plain(hid), pad_from=f)

    @pytest.mark.parametrize("m,c,f", [(200, 1024, 2736), (24, 256, 136)])
    def test_ffn_int8_matches_plain(self, cuda_device, m, c, f):
        """A ragged last row tile (200 = 128 + 72) and a padded F."""
        *_, hq, hs, w, ws = _quant_inputs(cuda_device, m, c, f)
        before = t_q.LAUNCHES["ffn_int8"]
        got = t_q.fused_ffn_int8(hq, hs, w, ws)
        assert t_q.LAUNCHES["ffn_int8"] == before + 1
        assert got[0].shape == (m, t_q.pad_ffn_dim(f)) and got[1].shape == (m, 1)
        assert_codes_close(got, t_q.fused_ffn_int8_plain(hq, hs, w, ws), pad_from=f)

    def test_kernels_reject_what_they_do_not_take(self, cuda_device):
        x, gain, hid, hq, hs, w, ws = _quant_inputs(cuda_device, 24, 256, 136)
        with pytest.raises(TypeError, match="bfloat16"):
            t_q.fused_rmsnorm_quant(x.float(), gain)
        with pytest.raises(TypeError, match="bfloat16"):
            t_q.fused_silu_quant(hid.float())
        with pytest.raises(ValueError, match="can_fuse_ffn"):
            t_q.fused_ffn_int8(hq[:20], hs[:20], w, ws)  # 20 rows: not a multiple of 8
        with pytest.raises(ValueError, match="M > 16"):
            t_q.int8_matmul_prequant(hq[:8], hs[:8], w, ws, torch.bfloat16)

    @pytest.mark.parametrize("variant,route", [
        ("w1024_d1_h16-w1024_d1_h16/1x16x8", "ffn_int8"),    # the 350M width
        ("w1728_d1_h24-w1728_d1_h24/1x16x8", "silu_quant"),  # the G width: C % 128 != 0
    ])
    def test_int8_blocks_route_through_the_kernels(self, cuda_device, monkeypatch, variant, route):
        """An int8 AE on the card: per block one RMSNorm + quantize launch and
        one launch of the FFN route's kernel (fused attention where head_dim
        64 allows it), and decoded patches within rel L2 2e-2 of the same
        model with the quantize kernels swapped for their plain versions."""
        cfg = t_ae.AEConfig.from_variant(variant)
        gen = torch.Generator().manual_seed(0)
        n, grids = 64, [(8, 8), (5, 7)]
        batch = {
            "patches": torch.randn(2, n, 768, generator=gen),
            "patch_mask": torch.zeros(2, n, dtype=torch.bool),
            "row_idx": torch.zeros(2, n, dtype=torch.int32),
            "col_idx": torch.zeros(2, n, dtype=torch.int32),
        }
        for i, (gr, gc) in enumerate(grids):
            batch["patch_mask"][i, : gr * gc] = True
            batch["row_idx"][i, : gr * gc] = torch.arange(gr * gc) // gc
            batch["col_idx"][i, : gr * gc] = torch.arange(gr * gc) % gc
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        model = t_ae.AE(**dataclasses.asdict(cfg), device=cuda_device)
        card_gen = torch.Generator(device=cuda_device).manual_seed(1)
        with torch.no_grad():
            for blk in [*model.encoder_blocks, *model.decoder_blocks]:
                blk.layer_scale.gamma.uniform_(0.5, 1.5, generator=card_gen)
        model.quantize()
        depth = cfg.encoder_depth + cfg.decoder_depth
        before = dict(t_q.LAUNCHES)
        attn_before = t_fa.LAUNCHES
        got = model(batch)["patches"]
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in t_q.LAUNCHES.items()}
        other = "silu_quant" if route == "ffn_int8" else "ffn_int8"
        assert launched == {"rmsnorm_quant": depth, route: depth, other: 0}
        assert t_fa.LAUNCHES - attn_before == (depth if route == "ffn_int8" else 0)
        for name in ("fused_rmsnorm_quant", "fused_ffn_int8", "fused_silu_quant"):
            monkeypatch.setattr(t_q, name, getattr(t_q, name + "_plain"))
        want = model(batch)["patches"]
        valid = batch["patch_mask"]
        a, r = got[valid].float(), want[valid].float()
        assert torch.isfinite(a).all()
        assert ((a - r).norm() / r.norm()).item() <= 2e-2


def ab_inputs(device, dtype, b=4, n=200, heads=2, d=64, case="tail+dead", seed=0):
    """``make_inputs`` in ``dtype`` with a mask where sample 1 keeps 23 tokens,
    sample 2 half and sample 3 none ("tail+dead"), or no mask ("none")."""
    qkv, qs, ks, cos, sin, _ = make_inputs(device, b=b, n=n, heads=heads, d=d, seed=seed)
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.standard_normal(tuple(qkv.shape), dtype=np.float32)).to(device).to(dtype)
    mask = None
    if case != "none":
        valid = np.array([n, 23, n // 2, 0] + [n] * (b - 4))
        mask = torch.from_numpy(np.arange(n)[None, :] < valid[:, None]).to(device)
    return qkv, qs, ks, cos, sin, mask


def assert_fp32_close(got, want):
    """fp32 kernel against its plain version on the card (tf32 off): the same
    function with sums in another order, within 1e-5 of the largest entry."""
    assert got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def one_cell_f32(qkv, rest, heads, sw=None):
    """The fp32 walker with one cell (one image, one head) a block (W): the
    bits of every split of every fp32 walker kernel."""
    d = qkv.shape[-1] // 3 // heads
    return t_bb.fused_attention_bb(qkv, *rest, num_heads=heads, bb=1, cg=d, sliding_window=sw)


@pytest.mark.cuda
class TestFp32ForwardOnCard:
    """The fp32 forward (#1 on the fp32 walker, ``fused_attention_f32_sm90_kernel``
    of ``csrc/fused_attention_ab_f32_sm90.cu``): the bits of W at every
    split ``f32_walk_split`` can return, within 1e-5 of the plain version's
    largest entry; the FMA instance it replaced stays behind
    ``fused_qkv_attention_mma``."""

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", None), ("tail+dead", 12), ("none", 40)])
    def test_fp32_instance_matches_plain(self, cuda_device, no_tf32, d, case, sw):
        qkv, *rest = ab_inputs(cuda_device, torch.float32, d=d, case=case)
        before = counts()
        got = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=sw, impl="fused")
        assert counts() == added(before, f32=1)
        assert torch.equal(got, one_cell_f32(qkv, rest, 2, sw))
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=2, sliding_window=sw)
        torch.cuda.synchronize()
        assert_fp32_close(got, want)

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [60, 64, 200, 1024])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", None), ("tail+dead", 24)])
    def test_every_split_of_the_fp32_forward_equals_one_cell_a_block(self, cuda_device, no_tf32, d, n, case, sw):
        """Each split ``f32_walk_split`` returns for this shape on a card of
        1 to 132 SMs, launched on the forward's kernel, gives the bits of W
        (N = 60 is ragged), within 1e-5 of the plain version."""
        heads, b = 4, 4
        qkv, *rest = ab_inputs(cuda_device, torch.float32, b=b, n=n, heads=heads, d=d, case=case)
        one = one_cell_f32(qkv, rest, heads, sw)
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=heads, sliding_window=sw)
        _, _, _, _, qs, ks, cos, sin, mask, swi = t_fa._check_cuda_args(qkv, *rest, heads, sw, dtypes=(torch.float32,))
        splits = {t_fa.f32_walk_split(b, n, heads, d, sms) for sms in (1, 2, 4, 8, 16, 64, 132)}
        assert len(splits) > 1 or n > 128
        for bb, hpb in sorted(splits):
            got = t_fa._walk_f32_cuda(qkv, qs, ks, cos, sin, mask, heads, bb=bb, hpb=hpb, sw=swi, kind="fwd")
            assert torch.equal(got, one), (bb, hpb)
        torch.cuda.synchronize()
        assert_fp32_close(one, want)

    def test_fp32_under_autograd_raises_before_any_launch(self, cuda_device):
        """A gradient through the fp32 forward would need an fp32 backward
        kernel (#3), which does not exist: the forward raises TypeError naming
        it before anything launches, whether qkv or only a gain asks for the
        gradient."""
        qkv, qs, ks, cos, sin, mask = ab_inputs(cuda_device, torch.float32)
        before = counts()
        for args in ((qkv.requires_grad_(), qs, ks), (qkv.detach(), qs.requires_grad_(), ks)):
            with pytest.raises(TypeError, match=r"backward kernel \(#3\) has no fp32 instance"):
                t_fa.fused_qkv_attention(*args, cos, sin, mask, num_heads=2, impl="fused")
        assert counts() == before

    @pytest.mark.parametrize("d", [64, 128])
    def test_fma_instance_stays_off_the_main_path(self, cuda_device, no_tf32, d):
        """The mma.sync forward's fp32 instance (FMA products) launches only
        behind ``fused_qkv_attention_mma``, counted apart, within 1e-5 of the
        plain version; W is within 1e-5 of it."""
        qkv, *rest = ab_inputs(cuda_device, torch.float32, d=d)
        before = counts()
        got = t_fa.fused_qkv_attention_mma(qkv, *rest, num_heads=2)
        assert counts() == added(before, f32_mma=1)
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=2)
        torch.cuda.synchronize()
        assert_fp32_close(got, want)
        assert_fp32_close(one_cell_f32(qkv, rest, 2), got)

    def test_fp32_model_routes_through_the_instance(self, cuda_device, no_tf32):
        """A small fp32 AE on the card: one fp32 launch per block, decoded
        patches within rel L2 1e-4 of the unfused composition."""
        cfg = t_ae.AEConfig.from_variant("w128_d1_h2-w128_d2_h2/1x16x8")
        rng = np.random.default_rng(0)
        batch = {"patches": torch.from_numpy(rng.standard_normal((2, 64, 768), dtype=np.float32)),
                 "patch_mask": torch.from_numpy(np.arange(64)[None, :] < np.array([[64], [40]])),
                 "row_idx": torch.from_numpy(np.tile(np.arange(64) // 8, (2, 1))),
                 "col_idx": torch.from_numpy(np.tile(np.arange(64) % 8, (2, 1)))}
        batch = {k: v.to(cuda_device) for k, v in batch.items()}
        model = t_ae.AE(**dataclasses.asdict(cfg), seed=0, device=cuda_device, compute_dtype=torch.float32)
        reference = t_ae.AE(**{**dataclasses.asdict(cfg), "attn_impl": "xla"}, state_dict=model.state_dict(),
                            device=cuda_device, compute_dtype=torch.float32)
        before = counts()
        got = model(batch)["patches"]
        assert counts() == added(before, f32=cfg.encoder_depth + cfg.decoder_depth)
        want = reference(batch)["patches"]
        valid = batch["patch_mask"]
        a, r = got[valid], want[valid]
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert ((a - r).norm() / r.norm()).item() <= 1e-4


@pytest.mark.cuda
class TestABKernelsOnCard:
    """The A/B kernels hold the bits of the forward whose body they run: #12
    (on the assembled tensor) the mma.sync forward's
    (``csrc/fused_attention_ab.cu``, body ``fused_attend.cuh``); #10, #11
    (on images with a valid key) and #13 in bf16 the redesigned forward's
    (``csrc/fused_attention_ab_sm90.cu``, the wgmma body of
    ``fused_attend_sm90.cuh``, after the q/k prologue); #10, #11 and #13 in
    fp32 those of the fp32 walker with one cell a block
    (``csrc/fused_attention_ab_f32_sm90.cu``, ``fused_attend_f32_sm90.cuh``),
    which is within 1e-5 of the largest entry of the FMA forward. Each is
    within the forward's limits of its plain version (bf16: max 2e-2, mean
    2e-3 on valid rows, a dead image's rows included; fp32: 1e-5 of the
    largest entry)."""

    @staticmethod
    def _forward(qkv, rest, heads, sw=None):
        return t_fa.fused_qkv_attention_mma(qkv, *rest, num_heads=heads, sliding_window=sw)

    @staticmethod
    def _redesigned(qkv, rest, heads, sw=None):
        return t_fa.fused_qkv_attention(qkv, *rest, num_heads=heads, sliding_window=sw, impl="fused")

    _one_cell = staticmethod(one_cell_f32)

    @staticmethod
    def _assert_bf16_close(got, want, mask):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if mask is not None:  # valid rows, and every row of an image with no valid key
            err = err[mask | ~mask.any(1)[:, None]]
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d,heads,bb,hpb", [(64, 4, 1, 2), (64, 4, 2, 4), (128, 2, 4, 1), (128, 2, 2, 2)])
    @pytest.mark.parametrize("sw", [None, 24])
    def test_batch_block_equals_the_forward_kernel(self, cuda_device, no_tf32, dtype, d, heads, bb, hpb, sw):
        qkv, *rest = ab_inputs(cuda_device, dtype, d=d, heads=heads)
        f32 = dtype == torch.float32
        name = "fused_attention_bb_f32" if f32 else "fused_attention_bb"
        before, fa_before = dict(t_bb.LAUNCHES), counts()
        got = t_bb.fused_attention_bb(qkv, *rest, num_heads=heads, bb=bb, cg=hpb * d, sliding_window=sw)
        assert t_bb.LAUNCHES == {**before, name: before[name] + 1}
        assert counts() == added(fa_before, prologue=0 if f32 else 1)
        reference = (self._one_cell if f32 else self._redesigned)(qkv, rest, heads, sw)
        assert torch.equal(got, reference)
        want = t_bb.fused_attention_bb_plain(qkv, *rest, num_heads=heads, bb=bb, cg=hpb * d, sliding_window=sw)
        torch.cuda.synchronize()
        if f32:
            assert_fp32_close(got, want)
            assert_fp32_close(reference, self._forward(qkv, rest, heads, sw))
        else:
            err = (got.float() - want.float()).abs()[rest[-1]]
            assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d,heads,n", [(64, 4, 200), (128, 2, 64)])
    def test_pack_equals_the_forward_where_an_image_has_a_valid_key(self, cuda_device, no_tf32, dtype, d, heads, n):
        qkv, *rest = ab_inputs(cuda_device, dtype, d=d, heads=heads, n=n)
        f32 = dtype == torch.float32
        name = "fused_attention_pack_f32" if f32 else "fused_attention_pack"
        before, prologue = t_bb.LAUNCHES[name], t_fa.PROLOGUE_LAUNCHES
        got = t_bb.fused_attention_bb(qkv, *rest, num_heads=heads, bb=2, cg=heads * d, pack=True)
        assert t_bb.LAUNCHES[name] == before + 1 and t_fa.PROLOGUE_LAUNCHES == prologue + (0 if f32 else 1)
        forward = self._one_cell if f32 else self._redesigned
        assert torch.equal(got[:3], forward(qkv, rest, heads)[:3])
        want = t_bb.fused_attention_bb_plain(qkv, *rest, num_heads=heads, bb=2, cg=heads * d, pack=True)
        if f32:
            torch.cuda.synchronize()
            assert_fp32_close(got, want)
        else:  # image 3: the mean of v over the pack, bf16 P = 1
            self._assert_bf16_close(got, want, None)
        mean_pack = qkv.float()[2:4, :, 2 * heads * d:].reshape(-1, heads * d).mean(0)
        assert (got[3].float() - mean_pack).abs().max().item() <= (1e-5 if f32 else 2e-2)

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [60, 64, 200, 1024])
    @pytest.mark.parametrize("case", ["none", "tail+dead"])
    @pytest.mark.parametrize("bb,hpb,pack", [(2, 2, False), (4, 1, False), (2, 1, True), (4, 2, True)])
    def test_fp32_walker_splits_equal_one_cell_a_block(self, cuda_device, no_tf32, d, n, case, bb, hpb, pack):
        """Every split of the fp32 walker gives a row the bits of the split
        with one cell a block (the pack on images with a valid key; a dead
        image in a pack the mean of v over the pack), within 1e-5 of the
        plain version; and one cell a block within 1e-5 of the FMA forward.
        N = 60 is ragged (the fp32 walker takes any N)."""
        qkv, *rest = ab_inputs(cuda_device, torch.float32, n=n, heads=2, d=d, case=case)
        one = self._one_cell(qkv, rest, 2)
        got = t_bb.fused_attention_bb(qkv, *rest, num_heads=2, bb=bb, cg=hpb * d, pack=pack)
        live = slice(0, 3) if pack and case != "none" else slice(None)
        assert torch.equal(got[live], one[live])
        want = t_bb.fused_attention_bb_plain(qkv, *rest, num_heads=2, bb=bb, cg=hpb * d, pack=pack)
        torch.cuda.synchronize()
        assert_fp32_close(got, want)
        assert_fp32_close(one, self._forward(qkv, rest, 2))

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("d,heads", [(64, 16), (128, 3)])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", 24)])
    def test_contig_equals_the_forward_kernel(self, cuda_device, no_tf32, dtype, d, heads, case, sw):
        qkv, *rest = ab_inputs(cuda_device, dtype, d=d, heads=heads, case=case)
        f32 = dtype == torch.float32
        name = "fused_attention_contig_f32" if f32 else "fused_attention_contig"
        before = t_ab8.LAUNCHES[name]
        got = t_ab8.fused_attention_contig(qkv, *rest, num_heads=heads, sliding_window=sw)
        assert t_ab8.LAUNCHES[name] == before + 1
        assert torch.equal(got, (self._one_cell if f32 else self._redesigned)(qkv, rest, heads, sw))
        want = t_ab8.fused_attention_contig_plain(qkv, *rest, num_heads=heads, sliding_window=sw)
        if f32:
            torch.cuda.synchronize()
            assert_fp32_close(got, want)
        else:
            self._assert_bf16_close(got, want, rest[-1])

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [200, 256, 1024])
    @pytest.mark.parametrize("case", ["none", "tail+dead"])
    @pytest.mark.parametrize("bb,hpb", [(1, 1), (2, 2), (4, 1), (4, 2)])
    def test_pack_walker_equals_the_redesigned_forward(self, cuda_device, d, n, case, bb, hpb):
        """The bf16 pack on the wgmma walker: the redesigned forward's bits
        on every image with a valid key; a dead image (sample 3, in a pack
        of bb = 2 or 4) the mean of v over its pack's bb * N keys."""
        qkv, *rest = ab_inputs(cuda_device, torch.bfloat16, n=n, heads=2, d=d, case=case)
        before = counts()
        got = t_bb.fused_attention_bb(qkv, *rest, num_heads=2, bb=bb, cg=hpb * d, pack=True)
        assert counts() == added(before, prologue=1)
        live = slice(None) if case == "none" else slice(0, 3)
        assert torch.equal(got[live], self._redesigned(qkv, rest, 2)[live])
        want = t_bb.fused_attention_bb_plain(qkv, *rest, num_heads=2, bb=bb, cg=hpb * d, pack=True)
        self._assert_bf16_close(got, want, rest[-1])

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [200, 256, 1024])
    @pytest.mark.parametrize("case", ["none", "tail+dead"])
    @pytest.mark.parametrize("sw", [None, 64])
    def test_contig_walker_equals_the_redesigned_forward(self, cuda_device, d, n, case, sw):
        """The bf16 contig on the wgmma walker: the redesigned forward's bits
        on every row (padded rows, rows past a window's reach and a dead
        sample's included)."""
        heads = 3
        qkv, *rest = ab_inputs(cuda_device, torch.bfloat16, n=n, heads=heads, d=d, case=case)
        before = counts()
        got = t_ab8.fused_attention_contig(qkv, *rest, num_heads=heads, sliding_window=sw)
        assert counts() == added(before, prologue=1)
        assert torch.equal(got, self._redesigned(qkv, rest, heads, sw))
        want = t_ab8.fused_attention_contig_plain(qkv, *rest, num_heads=heads, sliding_window=sw)
        self._assert_bf16_close(got, want, rest[-1])

    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("n", [60, 64, 200, 1024])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", None), ("tail+dead", 24)])
    def test_fp32_contig_walker_equals_one_cell_a_block(self, cuda_device, no_tf32, d, n, case, sw):
        """#13 in fp32 on the fp32 walker (``fused_attention_contig_f32_sm90_kernel``):
        the bits of W on every row (N = 60 is ragged), within 1e-5 of the
        plain version; nothing else launches."""
        heads = 3
        qkv, *rest = ab_inputs(cuda_device, torch.float32, n=n, heads=heads, d=d, case=case)
        before, fa_before = dict(t_ab8.LAUNCHES), counts()
        got = t_ab8.fused_attention_contig(qkv, *rest, num_heads=heads, sliding_window=sw)
        assert t_ab8.LAUNCHES == {**before, "fused_attention_contig_f32": before["fused_attention_contig_f32"] + 1}
        assert counts() == fa_before
        assert torch.equal(got, self._one_cell(qkv, rest, heads, sw))
        want = t_ab8.fused_attention_contig_plain(qkv, *rest, num_heads=heads, sliding_window=sw)
        torch.cuda.synchronize()
        assert_fp32_close(got, want)

    def test_walkers_report_their_attributes(self, cuda_device):
        from vitok_torch.benchmarks import WALKER_KINDS, sm90_attributes

        for d in (64, 128):
            for kind in WALKER_KINDS:
                a = sm90_attributes(d, kind, bb=2)
                assert 0 < a["registers"] <= 255 and a["blocks_per_sm"] >= 1 and a["smem_bytes"] > 0

    @pytest.mark.parametrize("d,heads", [(64, 4), (128, 2)])
    @pytest.mark.parametrize("case,sw", [("none", None), ("tail+dead", None), ("tail+dead", 24)])
    def test_int8_input_equals_the_forward_on_the_assembled_tensor(self, cuda_device, d, heads, case, sw):
        qkv, *rest = ab_inputs(cuda_device, torch.bfloat16, d=d, heads=heads, case=case)
        codes, scale = t_ab8.quantize_qkv(qkv)
        before = t_ab8.LAUNCHES["fused_attention_q8in"]
        got = t_ab8.fused_attention_q8in(codes, scale, *rest, num_heads=heads, sliding_window=sw)
        assert t_ab8.LAUNCHES["fused_attention_q8in"] == before + 1
        assembled = t_ab8.assemble_q8in(codes, scale)
        assert torch.equal(got, self._forward(assembled, rest, heads, sw))
        want = t_ab8.fused_attention_q8in_plain(codes, scale, *rest, num_heads=heads, sliding_window=sw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if rest[-1] is not None:
            err = err[rest[-1]]
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3

    def test_kernels_refuse_what_they_do_not_take(self, cuda_device):
        qkv, *rest = ab_inputs(cuda_device, torch.bfloat16)
        with pytest.raises(ValueError, match="bb=3"):
            t_bb.fused_attention_bb(qkv, *rest, num_heads=2, bb=3, cg=128)
        with pytest.raises(TypeError, match="int8"):
            t_ab8.fused_attention_q8in(qkv, rest[0].new_ones(4, 200, 1), *rest, num_heads=2)
        with pytest.raises(TypeError, match="bfloat16"):
            t_ab8.fused_attention_contig(qkv.half(), *rest, num_heads=2)
        ragged, *rrest = ab_inputs(cuda_device, torch.bfloat16, n=60)
        ragged_args = (ragged[:, :58].contiguous(), rrest[0], rrest[1], rrest[2][:, :58].contiguous(),
                       rrest[3][:, :58].contiguous(), None)
        before, fa_before = dict(t_bb.LAUNCHES), counts()
        for pack in (True, False):  # bf16 #11 and #10: refused before anything launches
            with pytest.raises(ValueError, match="multiple of 8"):
                t_bb.fused_attention_bb(*ragged_args, num_heads=2, bb=2, cg=128, pack=pack)
        assert t_bb.LAUNCHES == before and counts() == fa_before
