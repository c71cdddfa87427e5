"""The port's bucketed serving (``vitok_torch.serving``) on the CPU.

Every test of ``tests/test_serving.py`` runs here on the port with
``device="cpu"``. Beside them: ``TokenBucketer.prepare`` gives the JAX
package's patch dict bit for bit, resized or not, and ``ServingPipeline.run``
of the port and of the JAX package on the same float32 weights agree within
atol 1e-4 on every reconstruction, with one image in the 4096-token bucket
(the port's flash attention path; the JAX package's unfused attention on the
CPU: the same function on valid tokens).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_ae import jax_params, port_model
from vitok_tpu.models import ae as j_ae
from vitok_tpu import serving as j_serving
from vitok_torch import AE, decode_variant
from vitok_torch.ops import flash_attention as t_fl
from vitok_torch.serving import ServingPipeline, TokenBucketer, bucket_for_tokens

torch.set_num_threads(1)

ATOL = 1e-4


def img(w, h, seed=0):
    return Image.fromarray(
        np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)
    )


def small_model():
    return AE(**decode_variant("w64_d2_h2-w64_d2_h2/1x16x8"), attn_impl="xla", device="cpu")


class TestBucketing:
    def test_bucket_selection(self):
        assert bucket_for_tokens(50, (64, 256)) == 64
        assert bucket_for_tokens(64, (64, 256)) == 64
        assert bucket_for_tokens(65, (64, 256)) == 256
        assert bucket_for_tokens(9999, (64, 256)) == 256  # clamps to largest

    def test_prepare_shapes(self):
        b = TokenBucketer(patch=16, buckets=(64, 256))
        bucket, d = b.prepare(img(128, 128))  # 64 tokens
        assert bucket == 64 and d["patches"].shape == (64, 768)
        bucket, d = b.prepare(img(320, 200))  # 260 tokens -> resized into 256
        assert bucket == 256
        assert int(d["patch_mask"].sum()) <= 256

    @pytest.mark.parametrize("size,resized", [((128, 128), False), ((96, 64), False),
                                              ((320, 200), True), ((333, 257), True)])
    def test_prepare_matches_jax_bit_for_bit(self, size, resized):
        image = img(*size, seed=sum(size))
        t_bucket, got = TokenBucketer(patch=16, buckets=(64, 256)).prepare(image)
        j_bucket, want = j_serving.TokenBucketer(patch=16, buckets=(64, 256)).prepare(image)
        assert t_bucket == j_bucket
        n = -(-size[0] // 16) * -(-size[1] // 16)  # tokens before any resize
        assert (n > 256) == resized and (int(got["patch_mask"].sum()) == n) != resized
        assert set(got) == set(want)
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), k

    def test_batch_stream_groups_by_bucket(self):
        b = TokenBucketer(patch=16, buckets=(64, 256))
        imgs = [img(128, 128, i) for i in range(3)] + [img(256, 256, 9)]
        batches = list(b.batch_stream(imgs, batch_size=2))
        shapes = {(bk, d["patches"].shape[0]) for bk, d in batches}
        assert (64, 2) in shapes          # full small-bucket batch
        assert any(bk == 256 for bk, _ in batches)

    def test_run_preserves_stream_order(self):
        """Outputs come back in input order even when the stream interleaves
        buckets (batches run bucket-grouped)."""
        pipe = ServingPipeline(small_model(), buckets=(64, 256), batch_size=2)
        sizes = [(128, 128), (256, 256), (96, 64), (320, 192), (64, 128)]
        inputs = [img(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
        outs = pipe.run(inputs)
        assert len(outs) == len(inputs)
        for o, (w, h) in zip(outs, sizes):
            assert o.shape == (3, h, w), (o.shape, (3, h, w))

    def test_batch_stream_with_indices(self):
        b = TokenBucketer(patch=16, buckets=(64, 256))
        imgs = [img(128, 128, 0), img(256, 256, 1), img(128, 128, 2)]
        triples = list(b.batch_stream(imgs, batch_size=2, with_indices=True))
        seen = sorted(i for _, _, idx in triples for i in idx)
        assert seen == [0, 1, 2]
        for _, d, idx in triples:
            assert d["patches"].shape[0] == len(idx)

    def test_pipeline_end_to_end(self):
        pipe = ServingPipeline(small_model(), buckets=(64, 256), batch_size=2)
        inputs = [img(128, 128, 1), img(96, 64, 2), img(200, 320, 3)]
        outs = pipe.run(inputs)
        assert len(outs) == 3
        sizes = sorted(tuple(o.shape) for o in outs)
        # 200x320 lands in the 256 bucket: 13x20=260 > 256 -> budget-resized
        assert (3, 64, 96) in sizes and (3, 128, 128) in sizes


class TestStreaming:
    """Bounded-memory generator serving."""

    def test_stream_ordered_matches_run(self):
        pipe = ServingPipeline(small_model(), buckets=(64, 256), batch_size=2)
        sizes = [(128, 128), (256, 256), (96, 64), (320, 192), (64, 128)]
        inputs = [img(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
        ref = pipe.run(list(inputs))
        got = list(pipe.stream(inputs, ordered=True))
        assert [i for i, _ in got] == list(range(len(inputs)))
        for (_, a), b in zip(got, ref):
            assert torch.equal(a, b)

    def test_stream_unordered_is_complete(self):
        pipe = ServingPipeline(small_model(), buckets=(64, 256), batch_size=2)
        sizes = [(128, 128), (256, 256), (96, 64), (320, 192), (64, 128)]
        inputs = [img(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
        got = dict(pipe.stream(inputs, ordered=False))
        assert sorted(got) == list(range(len(inputs)))
        for i, (w, h) in enumerate(sizes):
            assert got[i].shape == (3, h, w)

    def test_stream_bounds_reorder_buffer(self):
        """Head-of-line image stuck in a never-filling bucket: the reorder
        buffer stays <= max_buffered through forced partial flushes."""
        pipe = ServingPipeline(small_model(), buckets=(64, 256), batch_size=4)
        # Image 0 is the only large-bucket image: its batch never fills, so
        # every later small image's output queues behind it in ordered mode.
        inputs = [img(256, 256, 0)] + [img(64, 64, i) for i in range(1, 12)]
        got = list(pipe.stream(inputs, ordered=True, max_buffered=4))
        assert [i for i, _ in got] == list(range(len(inputs)))
        # steady-state bound max_buffered, transiently up to 2 extra batches
        assert pipe.stats["max_buffered"] <= 4 + 2 * pipe.batch_size
        assert pipe.stats["forced_flushes"] >= 1

    def test_stream_is_lazy(self):
        """Outputs are yielded before the input stream is exhausted."""
        pipe = ServingPipeline(small_model(), buckets=(64,), batch_size=2)
        consumed = []

        def gen():
            for i in range(6):
                consumed.append(i)
                yield img(64, 64, i)

        it = pipe.stream(gen(), ordered=True)
        first = next(it)
        assert first[0] == 0
        assert len(consumed) < 6, "stream() must not drain the input eagerly"
        rest = list(it)
        assert [i for i, _ in rest] == [1, 2, 3, 4, 5]


class TestAgainstJax:
    def test_run_matches_jax_pipeline_with_4096_bucket(self, monkeypatch):
        """Buckets (64, 256, 4096): a 320x200 image (260 tokens) lands in
        the 4096 bucket, whose blocks take the flash attention path."""
        variant = "w128_d1_h2-w128_d1_h2/1x16x8"  # head dim 64
        cfg = j_ae.AEConfig.from_variant(variant)
        params = jax_params(cfg)
        buckets = (64, 256, 4096)
        j_pipe = j_serving.ServingPipeline(
            j_ae.AE(params=params, compute_dtype=jnp.float32, **decode_variant(variant)),
            buckets=buckets, batch_size=2)
        t_pipe = ServingPipeline(port_model(cfg, params, "auto"), buckets=buckets, batch_size=2)
        flash_tokens = []
        plain = t_fl.flash_attention_plain
        monkeypatch.setattr(t_fl, "flash_attention_plain",
                            lambda q, *a, **kw: flash_tokens.append(q.shape[1]) or plain(q, *a, **kw))

        sizes = [(128, 128), (320, 200), (96, 64), (256, 192)]
        inputs = [img(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
        assert [TokenBucketer(buckets=buckets).prepare(x)[0] for x in inputs] == [64, 4096, 64, 256]
        got, want = t_pipe.run(inputs), j_pipe.run(inputs)
        assert flash_tokens == [4096, 4096]  # one encoder and one decoder block
        for g, w, (width, height) in zip(got, want, sizes):
            assert tuple(g.shape) == (3, height, width) == w.shape
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
