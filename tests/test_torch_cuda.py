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
against the same model on the plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vitok_torch.models import ae as t_ae
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops import quant as t_q
from vitok_torch.ops.norms import rms_norm
from vitok_torch.ops.rope import apply_rotary_emb, compute_2d_freqs_cis

torch.set_num_threads(1)

CASES = [("none", False, None), ("tail", True, None), ("sw", False, 12), ("tail+sw", True, 12)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


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
        qkv, *rest = make_inputs(cuda_device, d=d, masked=masked)
        before = t_fa.LAUNCHES
        got = t_fa.fused_qkv_attention(qkv, *rest, num_heads=2, sliding_window=sw, impl="fused")
        assert t_fa.LAUNCHES == before + 1
        want = t_fa.fused_qkv_attention_plain(qkv, *rest, num_heads=2, sliding_window=sw).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        valid = err if rest[-1] is None else err[rest[-1]]
        assert valid.max().item() <= 2e-2 and valid.mean().item() <= 2e-3
        # Padded rows may see few keys: one bf16 step there is 2^-7 * |out|.
        assert (err / want.abs().clamp(min=1.0)).max().item() <= 2e-2

    def test_long_sequence_routes_through_flash(self, cuda_device):
        """At N = 2048 the fused kernel's gate refuses: q and k are normed and
        rotated, and the flash kernel takes them with v as a view of qkv."""
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, b=1, n=2048, heads=1, d=64)
        fused, flash = t_fa.LAUNCHES, t_fl.LAUNCHES
        got = t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, num_heads=1)
        assert (t_fa.LAUNCHES, t_fl.LAUNCHES) == (fused, flash + 1)
        q, k, v = qkv.view(1, 2048, 3, 1, 64).unbind(2)
        q, k = apply_rotary_emb(rms_norm(q, qs), rms_norm(k, ks), cos, sin, convention="half")
        want = t_fl.flash_attention_plain(q, k, v).reshape(got.shape).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        assert err.max().item() <= 2e-2 and err.mean().item() <= 2e-3

    def test_kernel_rejects_fp32(self, cuda_device):
        qkv, *rest = make_inputs(cuda_device)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention(qkv.float(), *rest, num_heads=2, impl="fused")

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

    def test_kernel_rejects_fp32(self, cuda_device):
        q, k, v, _ = flash_inputs(cuda_device)
        with pytest.raises(TypeError, match="bfloat16"):
            t_fl.flash_attention(q.float(), k.float(), v.float())

    def test_kernel_rejects_unsupported_head_dim(self, cuda_device):
        q, k, v, _ = flash_inputs(cuda_device, d=32)
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, k, v)


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
