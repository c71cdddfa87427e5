"""The fp32 instances of the flash family (#4, #5, #6, plain and fold), the
q/k prologue, the fp32 walker's log-sum-exp instance and the fused backward
(#3): how the wrappers route an fp32 call on the card, on the CPU.

Each wrapper runs as it does on the card, on tensors that say they lie there
(a ``Tensor`` subclass whose ``is_cuda`` is True), with the CUDA libraries
replaced by recorders of the C entry points they call (``_build.load``) and
the stream and device context by stand-ins. An fp32 call reaches the fp32
instance's entry with the shape, window, strides and flags its plan sets,
and counts a launch under the fp32 instance's name, at head dims 64 to 256
forward and backward (``F32_FWD_HEAD_DIMS``, ``F32_BWD_HEAD_DIMS``); an fp16
call, and a head dim the fp32 instances lack (past 256), raise before
anything launches. The
arithmetic of the plain versions that these instances are held to on the
card is held against the JAX package in ``tests/test_torch_train_lib.py``,
``test_torch_flash_*.py`` and ``test_torch_fused_*.py``; the kernels
themselves against their plain versions in ``tests/test_torch_cuda.py``.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from vitok_torch.ops import _build
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.ops import fused_attention as t_fa
from vitok_torch.ops.rope import compute_2d_freqs_cis

torch.set_num_threads(1)

SMS = 132  # an H100 SXM's SMs


class Card(torch.Tensor):
    """A CPU tensor that says it lies on the card: what the wrappers read."""

    @property
    def is_cuda(self):
        return True


def card(t):
    return t.as_subclass(Card)


class Entry:
    """A C entry point that records its arguments and returns 0 (success)."""

    def __init__(self, lib, name, calls):
        self.lib, self.name, self.calls = lib, name, calls
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append((self.lib, self.name, args))
        return 0


class FakeLib:
    def __init__(self, name, calls):
        self.name, self.calls, self.fns = name, calls, {}

    def __getattr__(self, fn):
        if not fn.startswith("vitok_"):
            raise AttributeError(fn)
        return self.fns.setdefault(fn, Entry(self.name, fn, self.calls))


@pytest.fixture
def entries(monkeypatch):
    """Every CUDA library a recorder; returns the (library, entry, arguments)
    calls made, in order."""
    calls = []
    libs = {}
    monkeypatch.setattr(_build, "load", lambda name: libs.setdefault(name, FakeLib(name, calls)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(t_fa, "_sm_count", lambda index: SMS)
    for mod, names in ((t_fa, ("LAUNCHES", "PROLOGUE_LAUNCHES", "BWD_LAUNCHES", "F32_LAUNCHES", "F32_LSE_LAUNCHES",
                                "PROLOGUE_F32_LAUNCHES", "BWD_F32_LAUNCHES")),
                       (t_fl, ("LAUNCHES", "DQ_LAUNCHES", "DKV_LAUNCHES", "F32_LAUNCHES", "DQ_F32_LAUNCHES",
                               "DKV_F32_LAUNCHES"))):
        for name in names:
            monkeypatch.setattr(mod, name, 0)
    return calls


def counts():
    return dict(fa_f32=t_fa.F32_LAUNCHES, fa_f32_lse=t_fa.F32_LSE_LAUNCHES, prologue=t_fa.PROLOGUE_LAUNCHES,
                prologue_f32=t_fa.PROLOGUE_F32_LAUNCHES, bwd=t_fa.BWD_LAUNCHES, bwd_f32=t_fa.BWD_F32_LAUNCHES,
                fa=t_fa.LAUNCHES, fl=t_fl.LAUNCHES, fl_f32=t_fl.F32_LAUNCHES, dq=t_fl.DQ_LAUNCHES,
                dkv=t_fl.DKV_LAUNCHES, dq_f32=t_fl.DQ_F32_LAUNCHES, dkv_f32=t_fl.DKV_F32_LAUNCHES)


def only(**named):
    return {k: named.get(k, 0) for k in counts()}


def qkv_inputs(b=2, n=128, heads=2, d=64, dtype=torch.float32, masked=True, seed=0):
    """Card-posing flat qkv ``[B, N, 3C]``, gains U(0.5, 1.5), 2D RoPE tables
    and a tail mask (sample 1 keeps 40 tokens)."""
    rng = np.random.default_rng(seed)
    c = heads * d
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * c)).astype(np.float32)).to(dtype)
    qs = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    ks = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
    idx = np.arange(n)
    cos, sin = compute_2d_freqs_cis(torch.from_numpy(np.tile(idx // 16, (b, 1))),
                                    torch.from_numpy(np.tile(idx % 16, (b, 1))), d)
    mask = None
    if masked:
        mask = torch.from_numpy(idx[None, :] < np.array([n] + [40] * (b - 1))[:, None])
    return card(qkv), qs, ks, cos, sin, mask


def qkv_views(b=2, n=128, heads=2, d=64, dtype=torch.float32):
    """Card-posing q, k, v ``[B, N, H, D]`` as views of one flat tensor, v
    strided as the model hands it over."""
    x = torch.randn((b, n, 3, heads, d), generator=torch.Generator().manual_seed(1)).to(dtype)
    return tuple(card(t) for t in x.unbind(2))


def entry_calls(calls, fn):
    return [args for _, name, args in calls if name == fn]


class TestFlashForward:
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    @pytest.mark.parametrize("return_lse", [False, True])
    def test_fp32_reaches_its_instance(self, entries, d, return_lse):
        q, k, v = qkv_views(d=d)
        mask = torch.arange(128)[None] < torch.tensor([[128], [50]])
        res = t_fl.flash_attention(q, k, v, mask, 32, return_lse=return_lse)
        out = res[0] if return_lse else res
        assert out.dtype == torch.float32 and out.shape == (2, 128, 2, d)
        ((lib, fn, args),) = entries
        assert (lib, fn) == ("flash_attention_f32", "vitok_flash_attention_f32")
        assert args[3:12] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
        assert args[14] == out.data_ptr() and (args[15] is not None) == return_lse
        assert args[16:] == (2, 128, 2, d, 32, 7)
        assert counts() == only(fl_f32=1)

    def test_fp32_without_a_mask_or_window(self, entries):
        q, k, v = qkv_views()
        t_fl.flash_attention(q, k, v)
        (args,) = entry_calls(entries, "vitok_flash_attention_f32")
        assert args[12] is None and args[13] is None and args[-2] == -1

    def test_fp16_and_other_head_dims_raise_before_a_launch(self, entries):
        q, k, v = qkv_views(dtype=torch.float16)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_fl.flash_attention(q, k, v)
        q, k, v = qkv_views()
        with pytest.raises(TypeError, match="one dtype"):
            t_fl.flash_attention(q, k, card(v.bfloat16()))
        q, k, v = (t.requires_grad_() for t in qkv_views(d=320))  # the backward's head dims: 64-256
        with pytest.raises(ValueError, match="head_dim"):
            t_fl.flash_attention(q, k, v)
        assert entries == [] and counts() == only()

    def test_bf16_keeps_its_instance(self, entries):
        q, k, v = qkv_views(dtype=torch.bfloat16)
        t_fl.flash_attention(q, k, v)
        assert [(lib, fn) for lib, fn, _ in entries] == [("flash_attention", "vitok_flash_attention_bf16")]
        assert counts() == only(fl=1)


class TestFlashBackward:
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_fp32_reaches_dq_then_dkv(self, entries, d):
        q, k, v = qkv_views(d=d)
        out, g = (card(torch.randn(q.shape)) for _ in range(2))
        lse = torch.zeros((2, 2, 128))
        dq, dk, dv = t_fl.flash_attention_bwd(q, k, v, out, lse, g, None, 40)
        assert all(t.dtype == torch.float32 and t.shape == q.shape for t in (dq, dk, dv))
        assert [fn for _, fn, _ in entries] == ["vitok_flash_bwd_dq_f32", "vitok_flash_bwd_dkv_f32"]
        (dq_args,), (dkv_args,) = entry_calls(entries, "vitok_flash_bwd_dq_f32"), entry_calls(
            entries, "vitok_flash_bwd_dkv_f32")
        assert dq_args[-6:] == (2, 128, 2, d, 40, 7) and dq_args[24] == dq.data_ptr()
        assert dkv_args[-6:] == (2, 128, 2, d, 40, 7)
        assert dkv_args[17] == dq_args[23]  # dk/dv reads the delta dq wrote
        assert (dkv_args[20], dkv_args[21]) == (dk.data_ptr(), dv.data_ptr())
        assert counts() == only(dq_f32=1, dkv_f32=1)

    def test_fp16_and_a_mixed_cotangent_raise_before_a_launch(self, entries):
        q, k, v = qkv_views(dtype=torch.float16)
        lse = torch.zeros((2, 2, 128))
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_fl.flash_attention_bwd(q, k, v, q, lse, q)
        q, k, v = qkv_views()
        with pytest.raises(ValueError, match="grad_out"):
            t_fl.flash_attention_bwd(q, k, v, q, lse, card(q.bfloat16()))
        assert entries == [] and counts() == only()

    def test_autograd_function_runs_the_fp32_backward(self, entries):
        q, k, v = (t.requires_grad_() for t in qkv_views())
        out = t_fl.flash_attention(q, k, v, None, 40)
        torch.autograd.grad(out.as_subclass(torch.Tensor).sum(), (q, k, v))
        assert [fn for _, fn, _ in entries] == ["vitok_flash_attention_f32", "vitok_flash_bwd_dq_f32",
                                                "vitok_flash_bwd_dkv_f32"]
        assert entry_calls(entries, "vitok_flash_attention_f32")[0][15] is not None  # the lse for the backward
        assert counts() == only(fl_f32=1, dq_f32=1, dkv_f32=1)


class TestFold:
    def test_takes_flash_fold_opens_for_fp32(self):
        qkv, qs, ks, *_ = qkv_inputs(1, 2048)
        assert t_fa.takes_flash_fold(qkv, qs, ks, 2, "auto")
        assert t_fa.takes_flash_fold(card(qkv.bfloat16()), qs, ks, 2, "auto")
        assert not t_fa.takes_flash_fold(card(qkv.half()), qs, ks, 2, "auto")
        assert not t_fa.takes_flash_fold(qkv, qs, ks, 2, "xla")
        assert not t_fa.takes_flash_fold(qkv.as_subclass(torch.Tensor), qs, ks, 2, "auto")
        qkv, qs, ks, *_ = qkv_inputs(1, 2048, heads=1, d=256, masked=False)
        assert t_fa.takes_flash_fold(qkv, qs, ks, 1, "auto")  # the fp32 forward has d 256
        assert t_fa.takes_flash_fold(qkv, qs.requires_grad_(), ks, 1, "auto")  # and its backward
        qkv, qs, ks, *_ = qkv_inputs(1, 2048, heads=1, d=320, masked=False)
        assert not t_fa.takes_flash_fold(qkv, qs, ks, 1, "auto")  # neither has d 320

    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_forward_is_the_fp32_prologue_then_the_fp32_flash_kernel(self, entries, d):
        qkv, qs, ks, cos, sin, mask = qkv_inputs(d=d)
        out = t_fa.flash_qkv_attention(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=40)
        assert out.shape == (2, 128, 2 * d) and out.dtype == torch.float32
        assert [fn for _, fn, _ in entries] == ["vitok_fused_qk_prologue_f32", "vitok_flash_attention_f32"]
        (pro,) = entry_calls(entries, "vitok_fused_qk_prologue_f32")
        assert pro[5:7] == (None, None) and pro[9:] == (2, 128, 2, d, 2, 7)  # q and k, no delta
        (fwd,) = entry_calls(entries, "vitok_flash_attention_f32")
        c = 2 * d
        assert fwd[0] == pro[7] and fwd[1] == pro[7] + 4 * c  # q, k: views of the prologue's fp32 scratch
        assert fwd[2] == qkv.data_ptr() + 4 * 2 * c  # v: a view of qkv
        assert fwd[3:12] == (128 * 2 * c, 2 * c, d, 128 * 2 * c, 2 * c, d, 128 * 3 * c, 3 * c, d)
        assert counts() == only(prologue_f32=1, fl_f32=1)

    @pytest.mark.parametrize("d", [64, 192, 256])
    def test_backward_is_the_prologue_then_the_fold_instances(self, entries, d):
        qkv, qs, ks, cos, sin, mask = qkv_inputs(d=d)
        x = qkv.requires_grad_()
        out = t_fa.unfused_qkv_attention(x, qs, ks, cos, sin, mask, 2, 40, attn_impl="flash")
        torch.autograd.grad(out.as_subclass(torch.Tensor).sum(), x)
        assert [fn for _, fn, _ in entries] == ["vitok_fused_qk_prologue_f32", "vitok_flash_attention_f32",
                                                "vitok_fused_qk_prologue_f32", "vitok_flash_bwd_fold_f32",
                                                "vitok_flash_bwd_fold_f32"]
        pro = entry_calls(entries, "vitok_fused_qk_prologue_f32")[1]
        assert pro[5] is not None and pro[6] is not None and pro[8] is not None  # out, dout: delta
        dq, dkv = entry_calls(entries, "vitok_flash_bwd_fold_f32")
        assert dq[:2] == (0, t_fl.LOG2E) and dkv[:2] == (1, t_fl.LOG2E)  # dq, dk/dv; #4's natural-log lse
        assert dq[3] == dkv[3] == pro[7] and dq[11] == dkv[11] == pro[8]  # qk and delta from the prologue
        assert dq[-6:] == dkv[-6:] == (2, 128, 2, d, 40, 7)
        assert dq[8] is not None  # the key counts of the mask
        assert counts() == only(prologue_f32=2, fl_f32=1, dq_f32=1, dkv_f32=1)

    def test_fp16_raises_before_a_launch(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_fa.flash_qkv_attention(card(qkv.half()), qs, ks, cos, sin, mask, num_heads=2)
        assert entries == [] and counts() == only()

    def test_bf16_fold_instances_take_only_a_natural_log_lse(self, entries):
        qkv, qs, ks, cos, sin, _ = qkv_inputs(dtype=torch.bfloat16)
        rows = torch.zeros((2, 2, 128))
        with pytest.raises(ValueError, match="natural-log"):
            t_fl.fold_bwd_launch(0, qkv, qkv, qs, cos, sin, None, None, qkv, rows, rows, qkv, rows, 2, -1,
                                 lse_factor=1.0)
        assert entries == [] and counts() == only()


class TestFused:
    def test_forward_under_autograd_writes_the_lse(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        out, lse = t_fa._fused_cuda(qkv, qs, ks, cos, sin, mask, 2, 32, want_lse=True)
        assert lse.shape == (2, 2, 128) and lse.dtype == torch.float32
        ((lib, fn, args),) = entries
        assert (lib, fn) == ("fused_attention_ab_f32_sm90", "vitok_fused_attention_walk_f32")
        bb, hpb = t_fa.f32_walk_split(2, 128, 2, 64, SMS)
        assert args[6] == out.data_ptr() and args[7] == lse.data_ptr()
        assert args[8:] == (2, 128, 2, 64, bb, hpb, 32, t_fa.F32_WALK_KINDS.index("fwd"), 7)
        assert counts() == only(fa_f32_lse=1)

    def test_forward_without_grad_keeps_the_inference_instance(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        out, lse = t_fa._fused_cuda(qkv, qs, ks, cos, sin, mask, 2, None)
        ((_, _, args),) = entries
        assert lse is None and args[7] is None and counts() == only(fa_f32=1)

    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_backward_is_the_prologue_then_the_fused_fold_instances(self, entries, d):
        qkv, qs, ks, cos, sin, mask = qkv_inputs(d=d)
        out = card(torch.randn((2, 128, 2 * d)))
        g = card(torch.randn((2, 128, 2 * d)))
        lse = torch.zeros((2, 2, 128))
        dqkv, dqs, dks = t_fa.fused_qkv_attention_bwd(qkv, qs, ks, cos, sin, mask, g, num_heads=2,
                                                      sliding_window=32, out=out, lse=lse)
        assert dqkv.shape == qkv.shape and dqkv.dtype == torch.float32 and dqs.shape == dks.shape == (d,)
        assert [fn for _, fn, _ in entries] == ["vitok_fused_qk_prologue_f32", "vitok_flash_bwd_fold_f32",
                                                "vitok_flash_bwd_fold_f32"]
        (pro,) = entry_calls(entries, "vitok_fused_qk_prologue_f32")
        assert pro[9:] == (2, 128, 2, d, 2, 7)
        dq, dkv = entry_calls(entries, "vitok_flash_bwd_fold_f32")
        assert dq[:2] == (0, 1.0) and dkv[:2] == (1, 1.0)  # the walker's lse, in log2 units
        assert dq[2] == dkv[2] == qkv.data_ptr() and dq[12] == dkv[12] == dqkv.data_ptr()
        assert dq[3] == pro[7] and dq[11] == pro[8] and dq[10] == lse.data_ptr()
        assert dq[-6:] == dkv[-6:] == (2, 128, 2, d, 32, 7)
        assert counts() == only(prologue_f32=1, bwd_f32=2)  # one a launch

    def test_autograd_function_runs_forward_with_lse_then_backward(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        x = qkv.requires_grad_()
        out = t_fa.fused_qkv_attention(x, qs, ks, cos, sin, mask, num_heads=2, impl="fused")
        torch.autograd.grad(out.as_subclass(torch.Tensor).sum(), x)
        assert [fn for _, fn, _ in entries] == ["vitok_fused_attention_walk_f32", "vitok_fused_qk_prologue_f32",
                                                "vitok_flash_bwd_fold_f32", "vitok_flash_bwd_fold_f32"]
        (walk,) = entry_calls(entries, "vitok_fused_attention_walk_f32")
        dq, _ = entry_calls(entries, "vitok_flash_bwd_fold_f32")
        assert dq[10] == walk[7]  # the backward reads the lse the forward wrote
        assert counts() == only(fa_f32_lse=1, prologue_f32=1, bwd_f32=2)

    def test_fp16_and_other_head_dims_raise_before_a_launch(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        g = card(torch.zeros((2, 128, 128)))
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            t_fa.fused_qkv_attention_bwd(card(qkv.half()), qs, ks, cos, sin, mask, card(g.half()), num_heads=2,
                                         out=card(g.half()), lse=torch.zeros((2, 2, 128)))
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention_bwd(qkv, qs[:32], ks[:32], cos[..., :16], sin[..., :16], mask, g,
                                         num_heads=4, out=g, lse=torch.zeros((2, 4, 128)))
        assert entries == [] and counts() == only()


class TestQ8Fp32:
    """#2 on fp32 compute: the fp32 walker's forward into a scratch, then the
    row quantize over each token's C channels (``csrc/quantize_rows.cu``):
    one ``F32_LAUNCHES`` and one ``Q8_F32_LAUNCHES`` a call."""

    @pytest.fixture(autouse=True)
    def _quantize_rows(self, monkeypatch):
        from vitok_torch.ops import quant as t_q

        monkeypatch.setattr(t_q, "_FNS", {})
        monkeypatch.setattr(t_fa, "_quantize_rows_blocks", lambda c, dev: 4)
        monkeypatch.setattr(t_fa, "Q8_F32_LAUNCHES", 0)
        monkeypatch.setattr(t_fa, "Q8_LAUNCHES", 0)

    @pytest.mark.parametrize("n", [64, 256, 1024])
    @pytest.mark.parametrize("d", [64, 128, 192, 256])
    def test_fp32_is_the_walker_then_the_row_quantize(self, entries, n, d):
        qkv, qs, ks, cos, sin, mask = qkv_inputs(n=n, d=d)
        codes, scales = t_fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, num_heads=2)
        assert codes.shape == (2, n, 2 * d) and codes.dtype == torch.int8
        assert scales.shape == (2, n, 1) and scales.dtype == torch.float32
        assert [(lib, fn) for lib, fn, _ in entries] == [
            ("fused_attention_ab_f32_sm90", "vitok_fused_attention_walk_f32"),
            ("quantize_rows", "vitok_quantize_rows_f32")]
        (walk,) = entry_calls(entries, "vitok_fused_attention_walk_f32")
        (quant,) = entry_calls(entries, "vitok_quantize_rows_f32")
        bb, hpb = t_fa.f32_walk_split(2, n, 2, d, SMS)
        assert walk[7] is None and walk[8:] == (2, n, 2, d, bb, hpb, -1, t_fa.F32_WALK_KINDS.index("fwd"), 7)
        assert quant[0] == walk[6]  # the quantize reads the walker's output
        assert quant[1] == codes.data_ptr() and quant[2] == scales.data_ptr()
        assert quant[3:] == (2 * n, 2 * d, min(2 * n, SMS * 4), qkv.device.index, 7)
        assert t_fa.Q8_F32_LAUNCHES == 1 and t_fa.Q8_LAUNCHES == 0 and counts() == only(fa_f32=1)

    def test_window_reaches_the_walker(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        t_fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, num_heads=2, sliding_window=32)
        (walk,) = entry_calls(entries, "vitok_fused_attention_walk_f32")
        assert walk[14] == 32

    def test_bf16_keeps_its_kernel(self, entries, monkeypatch):
        monkeypatch.setattr(t_fa, "_q8_cluster_size", lambda h, d: 2)
        qkv, qs, ks, cos, sin, mask = qkv_inputs(dtype=torch.bfloat16)
        t_fa.fused_qkv_attention_q8(qkv, qs, ks, cos, sin, mask, num_heads=2)
        assert [fn for _, fn, _ in entries] == ["vitok_fused_qk_prologue_bf16", "vitok_fused_attention_q8_sm90_bf16"]
        assert t_fa.Q8_LAUNCHES == 1 and t_fa.Q8_F32_LAUNCHES == 0

    def test_fp16_and_other_head_dims_raise_before_a_launch(self, entries):
        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        with pytest.raises(TypeError, match="bfloat16"):
            t_fa.fused_qkv_attention_q8(card(qkv.half()), qs, ks, cos, sin, mask, num_heads=2)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.fused_qkv_attention_q8(qkv, qs[:32], ks[:32], cos[..., :16], sin[..., :16], mask, num_heads=4)
        assert entries == [] and t_fa.Q8_F32_LAUNCHES == 0

    def test_plain_version_is_quantize_activation_of_the_forward(self):
        """The function the card holds the kernel to: ``quantize_activation``
        of the fp32 forward, which the CPU path computes."""
        from vitok_torch.ops.quant import quantize_activation

        qkv, qs, ks, cos, sin, mask = qkv_inputs()
        x = qkv.as_subclass(torch.Tensor)
        codes, scales = t_fa.fused_qkv_attention_q8(x, qs, ks, cos, sin, mask, num_heads=2)
        want = quantize_activation(t_fa.fused_qkv_attention_plain(x, qs, ks, cos, sin, mask, num_heads=2))
        assert torch.equal(codes, want[0]) and torch.equal(scales, want[1])
