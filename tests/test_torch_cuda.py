"""The port's CUDA kernel on the card, held against its plain PyTorch version.

These tests need an NVIDIA GPU with ``nvcc`` (sm_90a) and skip without one.
The file imports neither JAX nor ``vitok_tpu``, so it also runs on a machine
that has only the port's dependencies; ``tests/conftest.py`` imports JAX, so
there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance, bf16 on the card, valid rows: max abs 2e-2 and mean abs 2e-3.
Both sides round P to bf16 before PV, but the kernel's online softmax rounds
it at running row maxima, in another order than the plain version's
full-row softmax.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vitok_torch.models import ae as t_ae
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops.rope import compute_2d_freqs_cis

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

    def test_long_sequence_raises(self, cuda_device):
        qkv, qs, ks, cos, sin, _ = make_inputs(cuda_device, b=1, n=2048, heads=1, d=64)
        with pytest.raises(NotImplementedError, match="flash"):
            t_fa.fused_qkv_attention(qkv, qs, ks, cos, sin, num_heads=1)

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
