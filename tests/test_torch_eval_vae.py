"""The port's eval CLI (``python -m vitok_torch.scripts.eval_vae``) against the JAX pieces.

In process: a small AE (``w128_d2_h2-w128_d2_h2/1x16x8``, the JAX package's
init with gains drawn from U(0.5, 1.5), carried across with
``from_jax_params``, bf16 on both sides) evaluates the same folder of six
mixed-size images in the same batches: the port's ``evaluate`` loop against
the JAX CLI's loop built from its pieces (``encode_apply`` /
``decode_apply``, ``postprocess``, ``MetricCalculator`` with
random-projection FID). SSIM abs 1e-4, PSNR abs 1e-2 dB, FID rel 1e-3
(bf16 models whose roundings may differ in a few values). In subprocesses:
the CLI with ``--device cpu`` over the static, ``--buckets``, ``--quant``
and random-projection fid/fdd paths prints a JSON with the JAX CLI's keys.
Without a card and without ``--device cpu`` it raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from tests.test_torch_ae import jax_params
from vitok_tpu import eval_features as j_ef
from vitok_tpu import metrics as j_metrics
from vitok_tpu.data import create_dataloader as j_create_dataloader
from vitok_tpu.models import ae as j_ae
from vitok_tpu.pp import postprocess as j_postprocess
from vitok_torch.metrics import MetricCalculator
from vitok_torch.models.ae import AE, decode_variant
from vitok_torch.scripts import eval_vae
from vitok_torch.utils.params_io import from_jax_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 64), (48, 64), (64, 40), (33, 50), (64, 64), (20, 28)]  # (height, width)
# The JAX CLI's stats keys (scripts/eval_vae.py), with fid and fdd when asked for.
STATS_KEYS = {"n_images", "ssim", "psnr", "model", "data", "pp", "throughput_img_per_sec", "avg_img_latency_ms",
              "wall_img_per_sec", "wall_time_s", "host_data_time_s", "device_time_s", "host_post_time_s",
              "first_batch_wall_s", "steady_img_per_sec", "device"}


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_imgs")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(SIZES):
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(d / f"img_{i}.png")
    return str(d)


def _args(image_folder, *extra):
    return eval_vae.build_parser().parse_args(
        ["--model", "w128_d2_h2-w128_d2_h2/1x16x8", "--data", image_folder, "--random-weights",
         "--max-size", "64", "--batch-size", "2", "--metrics", "ssim,psnr,fid", "--feature-backbone",
         "random-proj", "--device", "cpu", *extra])


def _jax_eval(cfg, params, args, pp):
    """The JAX CLI's loop (scripts/eval_vae.py), from its pieces."""
    calc = j_metrics.MetricCalculator(
        metrics=("ssim", "psnr", "fid"),
        fid_feature_fn=j_ef.random_projection_feature_fn(dim=64, seed=0, bucketed_resize=True))
    encode = jax.jit(lambda p, d: j_ae.encode_apply(p, d, cfg, compute_dtype=jnp.bfloat16))
    decode = jax.jit(lambda p, d: j_ae.decode_apply(p, d, cfg, compute_dtype=jnp.bfloat16))
    batches = []
    for batch in j_create_dataloader(args.data, pp, batch_size=args.batch_size, seed=args.seed):
        jb = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
        out = decode(params, encode(params, jb))
        calc.update(j_postprocess(jb, do_unpack=True, patch=16), j_postprocess(dict(out), do_unpack=True, patch=16))
        batches.append(batch)
    return calc.gather(), batches


def test_loop_matches_the_jax_pieces(image_folder):
    args = _args(image_folder)
    cfg = j_ae.AEConfig.from_variant(args.model)
    params = jax_params(cfg)
    pp = eval_vae.build_pp(args, 16)
    want, j_batches = _jax_eval(cfg, jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params), args, pp)

    model = AE(**decode_variant(args.model), state_dict=from_jax_params(params, cfg), device="cpu")
    loader, port_pp = eval_vae.build_loader(args, model.cfg.spatial_stride)
    batches = list(loader)
    assert port_pp == pp and len(batches) == len(j_batches) == 3
    for got_b, want_b in zip(batches, j_batches):  # the same batches on both sides
        assert all(np.array_equal(got_b[k], want_b[k]) for k in want_b if isinstance(want_b[k], np.ndarray))
    got = eval_vae.evaluate(model, batches, eval_vae.build_metrics(args, model.device))
    assert got["n_images"] == want["n_images"] == 6
    assert abs(got["ssim"] - want["ssim"]) <= 1e-4
    assert abs(got["psnr"] - want["psnr"]) <= 1e-2
    assert got["fid"] > 0 and abs(got["fid"] - want["fid"]) <= 1e-3 * want["fid"]


def test_steady_rate_leaves_out_the_first_batchs_own_images(image_folder):
    """A short first batch (one image, then two): the steady rate counts the
    images after it, not ``n_images - batch_size``."""
    args = _args(image_folder, "--buckets", "4,16")
    model = eval_vae.build_model(args, torch.device("cpu"))
    loader, _ = eval_vae.build_loader(args, 16)
    batches = list(loader)
    first = {k: (v[:1] if isinstance(v, np.ndarray) else v[:1]) for k, v in batches[0].items()}
    stats = eval_vae.evaluate(model, [first, batches[0]], MetricCalculator(("psnr",)))
    assert stats["n_images"] == 3
    steady_window = stats["wall_time_s"] - stats["first_batch_wall_s"]
    assert stats["steady_img_per_sec"] == pytest.approx(2 / steady_window, rel=1e-9)


def test_save_visuals_writes_the_first_batchs_pairs(image_folder, tmp_path):
    args = _args(image_folder, "--metrics", "ssim")
    model = eval_vae.build_model(args, torch.device("cpu"))
    loader, _ = eval_vae.build_loader(args, 16)
    eval_vae.evaluate(model, loader, MetricCalculator(("ssim",)), save_visuals=str(tmp_path / "vis"))
    files = sorted(os.listdir(tmp_path / "vis"))
    assert files == ["pair_000.png", "pair_001.png"]
    for f in files:  # reference and reconstruction side by side
        w, h = Image.open(tmp_path / "vis" / f).size
        assert w % 2 == 0 and (h, w // 2) in SIZES


def run_cli(image_folder, tmp_path, *extra):
    out = tmp_path / "stats.json"
    res = subprocess.run(
        [sys.executable, "-m", "vitok_torch.scripts.eval_vae", "--model", "w64_d2_h2-w64_d2_h2/1x16x8",
         "--data", image_folder, "--random-weights", "--batch-size", "2", "--max-size", "64", "--device", "cpu",
         "--output", str(out), *extra],
        capture_output=True, text=True, timeout=300, env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    assert res.returncode == 0, res.stderr[-2000:]
    stats = json.loads(out.read_text())
    assert json.loads(res.stdout[res.stdout.index("{"):]) == stats
    return stats


@pytest.mark.parametrize("extra,keys", [
    ((), ()),
    (("--buckets", "4,16"), ()),
    (("--quant",), ()),
    (("--metrics", "ssim,psnr,fid,fdd", "--feature-backbone", "random-proj"), ("fid", "fdd")),
], ids=["static", "buckets", "quant", "random-proj"])
def test_cli_paths_print_the_jax_clis_keys(image_folder, tmp_path, extra, keys):
    stats = run_cli(image_folder, tmp_path, *extra)
    assert set(stats) == STATS_KEYS | set(keys)
    assert stats["n_images"] == 6 and stats["device"] == "cpu"
    assert 0.0 <= stats["ssim"] <= 1.0 and np.isfinite(stats["psnr"]) and stats["throughput_img_per_sec"] > 0
    assert ("bucketed" in stats["pp"]) == ("--buckets" in extra)
    for k in keys:
        assert np.isfinite(stats[k]) and stats[k] >= 0.0


def test_refuses_a_missing_card_and_the_decode_pool(image_folder):
    base = ["--model", "w64_d2_h2-w64_d2_h2/1x16x8", "--data", image_folder, "--random-weights", "--max-size", "64"]
    with pytest.raises(NotImplementedError, match="decode_workers"):
        eval_vae.main([*base, "--device", "cpu", "--decode-workers", "2"])
    assert eval_vae.build_parser().parse_args(base).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_vae.main(base)
