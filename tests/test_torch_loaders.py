"""The port's image-folder loader against the JAX package's, and the trainer CLI.

A folder of seed-made PNGs (one RGBA, one grayscale, one broken file) goes
through both ``create_dataloader``s with a deterministic pp string: the
batches are bit-identical and come in the same order, over two epochs.
With the trainer's random pp string one ``random.seed`` gives the same
batches too. The trainer CLI then takes two steps on the folder on the CPU
and writes a checkpoint and the safetensors export.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from vitok_tpu.data import loaders as j_loaders
from vitok_torch.data import loaders as t_loaders
from vitok_torch.scripts import train_vae

torch.set_num_threads(1)

PP = "resize_longest_side(96)|to_tensor|normalize(minus_one_to_one)|resize_to_token_budget(16, 24)|patchify(16, 24)"


@pytest.fixture
def image_folder(tmp_path):
    rng = np.random.default_rng(0)
    root = tmp_path / "imgs"
    (root / "sub").mkdir(parents=True)
    sizes = [(70, 90), (64, 40), (33, 120), (96, 96), (50, 81), (128, 60), (40, 40)]
    for i, (h, w) in enumerate(sizes):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / ("sub" if i % 3 == 0 else "") / f"img_{i}.png")
    Image.fromarray(rng.integers(0, 256, (48, 48, 4), dtype=np.uint8), mode="RGBA").save(root / "alpha.png")
    Image.fromarray(rng.integers(0, 256, (48, 64), dtype=np.uint8), mode="L").save(root / "gray.png")
    (root / "broken.jpg").write_bytes(b"not an image")
    (root / "notes.txt").write_text("skipped")
    return str(root)


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert g[key].dtype == w[key].dtype, key


class TestImageFolderLoader:
    @pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, partial=True, return_labels=True),
                                    dict(seed=1, rank=1, world=2, partial=True), dict(seed=0, num_samples=5, partial=True)],
                             ids=["seed0", "partial+labels", "rank1of2", "num_samples"])
    def test_batches_match_jax_bit_for_bit(self, image_folder, kw):
        want = list(j_loaders.create_dataloader(image_folder, PP, batch_size=2, **kw))
        got = list(t_loaders.create_dataloader(image_folder, PP, batch_size=2, **kw))
        _assert_same_batches(got, want)
        assert got[0]["patches"].shape == (2, 24, 768)

    def test_repeat_walks_epochs_in_the_same_order(self, image_folder):
        def take(mod, n):
            out = []
            for batch in mod.create_dataloader(image_folder, PP, batch_size=4, seed=2, repeat=True):
                out.append(batch)
                if len(out) == n:
                    break  # abandoning the iterator stops the producer thread
            return out

        _assert_same_batches(take(t_loaders, 5), take(j_loaders, 5))  # 9 readable images: over two epochs

    def test_random_pp_follows_the_seed_like_jax(self, image_folder):
        pp = train_vae.default_pp(16, 16)
        random.seed(5)
        want = list(j_loaders.create_dataloader(image_folder, pp, batch_size=3, seed=0, prefetch=1))
        random.seed(5)
        got = list(t_loaders.create_dataloader(image_folder, pp, batch_size=3, seed=0, prefetch=1))
        _assert_same_batches(got, want)

    def test_sample_stream_and_to_rgb(self, image_folder):
        want = [np.asarray(img) for img, _ in j_loaders.iter_samples(image_folder, seed=4)]
        got = [(np.asarray(img), label) for img, label in t_loaders.iter_samples(image_folder, seed=4)]
        assert len(got) == len(want) == 9 and all(label == -1 for _, label in got)
        for (g, _), w in zip(got, want):
            assert g.ndim == 3 and g.shape[2] == 3
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("source", ["shards-{0000..0003}.tar", "hf://org/repo/x.tar", "coco"])
    def test_other_sources_are_not_ported(self, source):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            list(t_loaders.create_dataloader(source, PP))

    def test_decode_workers_are_not_ported(self, image_folder):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_loaders.create_dataloader(image_folder, PP, decode_workers=2)


class TestTrainerCli:
    ARGS = ["--variant", "w64_d1_h1-w64_d2_h1/1x16x8", "--max-tokens", "64", "--bs", "2", "--device", "cpu",
            "--log-freq", "1", "--tile-size", "64", "--save-freq", "1", "--lr", "1e-3"]

    def test_two_steps_write_a_checkpoint_and_resume(self, image_folder, tmp_path, capsys):
        out = str(tmp_path / "run")
        train_vae.main([*self.ARGS, "--data", image_folder, "--output-dir", out, "--steps", "2", "--grad-accum", "2",
                        "--checkpoint", "1", "--drop-path", "0.1", "--eval-freq", "2"])
        logs = capsys.readouterr().out
        assert "step 2:" in logs and "loss/charbonnier" in logs and "timing/tokens_per_s" in logs
        assert "perf/mfu" not in logs  # an MFU is stated only against the card's peak
        assert "step 2 eval:" in logs and "training done" in logs
        assert os.path.exists(os.path.join(out, "last", "state.pt"))
        assert sorted(os.listdir(os.path.join(out, "safetensors"))) == ["decoder.safetensors", "encoder.safetensors"]
        saved = torch.load(os.path.join(out, "last", "state.pt"), weights_only=True)
        assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
        assert all(torch.isfinite(v).all() for v in saved["params"].values())
        train_vae.main([*self.ARGS, "--data", image_folder, "--output-dir", out, "--steps", "3", "--resume"])
        logs = capsys.readouterr().out
        assert "resumed at step 2" in logs and "step 3:" in logs and "step 2:" not in logs

    def test_defaults_follow_the_jax_trainer(self):
        args = train_vae.build_parser().parse_args(["--data", "x"])
        assert (args.variant, args.max_tokens, args.bs, args.lr, args.schedule, args.wd, args.b2) == (
            "Ld2-Ld22/1x16x64", 256, 32, 3e-4, "cosine", 1e-4, 0.99)
        assert (args.charbonnier_weight, args.ssim_weight, args.tile_size, args.n_tiles, args.device) == (
            1.0, 0.1, 256, 2, "cuda")
        assert "random_resized_crop(256)" in train_vae.default_pp(16, 256)

    def test_refuses_what_is_not_ported_and_a_missing_card(self, image_folder, tmp_path):
        base = [*self.ARGS, "--data", image_folder, "--output-dir", str(tmp_path / "o"), "--steps", "1"]
        # the DINO perceptual term is ported: its flags parse (a step with it: tests/test_torch_vit_features.py)
        args = train_vae.build_parser().parse_args([*base, "--perceptual-weight", "500", "--dino-size", "B"])
        assert (args.perceptual_weight, args.dino_size, args.dino_weights) == (500.0, "B", None)
        assert train_vae.build_parser().parse_args(base).dino_size == "S"
        with pytest.raises(NotImplementedError, match="Muon"):
            train_vae.main([*base, "--optimizer", "muon"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                train_vae.main([a for a in base if a not in ("--device", "cpu")])
