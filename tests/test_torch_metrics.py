"""The port's eval metrics (``vitok_torch.metrics``) against the JAX package.

The same fp64 statistics go through both Fréchet distances (rel 1e-10,
including a product of covariances with no square root, which takes the
eps retry); the accumulators and their ``merge`` against numpy's mean and
covariance (1e-12); ``MetricCalculator`` on the same lists of mixed-shape
images with random-projection FID and FDD: SSIM abs 1e-5, PSNR abs 1e-4 dB,
FID and FDD rel 1e-4 (the port's resize runs on a weight matrix, the JAX
one through ``jax.image.resize``: fp32 sums in another order). Across two
processes on a gloo group, ``allreduce`` gives one process's sums over all
the features.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vitok_tpu import eval_features as j_ef
from vitok_tpu import metrics as j_metrics
from vitok_torch import eval_features as t_ef
from vitok_torch import metrics as t_metrics

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(3, 32, 32)] * 5 + [(3, 24, 40)] * 4 + [(3, 48, 48)] * 3


def _images(seed, shapes=SHAPES, noise=None):
    rng = np.random.default_rng(seed)
    refs = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    if noise is None:
        return refs
    return refs, [np.clip(r + noise * rng.standard_normal(r.shape), -1, 1).astype(np.float32) for r in refs]


def _frechet_both(mu1, s1, mu2, s2):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scipy's singular-matrix and deprecation warnings
        return (t_metrics.calculate_frechet_distance(mu1, s1, mu2, s2),
                j_metrics.calculate_frechet_distance(mu1, s1, mu2, s2))


class TestFrechetDistance:
    @pytest.mark.parametrize("n", [64, 4])  # full rank, and fewer samples than dimensions
    def test_matches_jax(self, n):
        rng = np.random.default_rng(n)
        x, y = rng.standard_normal((n, 16)), 0.5 + 1.3 * rng.standard_normal((n, 16))
        args = (x.mean(0), np.cov(x, rowvar=False), y.mean(0), np.cov(y, rowvar=False))
        got, want = _frechet_both(*args)
        assert np.isfinite(got) and abs(got - want) <= 1e-10 * abs(want)

    def test_eps_retry_when_the_product_has_no_square_root(self):
        """A nilpotent product has no square root: ``sqrtm`` returns inf,
        and both retry with eps on the diagonals."""
        s1, s2 = np.array([[0.0, 1.0], [0.0, 0.0]]), np.eye(2)
        got, want = _frechet_both(np.zeros(2), s1, np.ones(2), s2)
        assert np.isfinite(got) and abs(got - want) <= 1e-10 * abs(want)

    def test_identical_statistics_give_zero(self):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((200, 8))
        mu, s = x.mean(0), np.cov(x, rowvar=False)
        assert abs(t_metrics.calculate_frechet_distance(mu, s, mu, s)) <= 1e-9 * np.trace(s)


class TestAccumulators:
    def test_mean_cov_with_merge_matches_numpy_and_jax(self):
        rng = np.random.default_rng(2)
        feats = rng.standard_normal((50, 6)).astype(np.float32)
        a, b = t_metrics.MeanCovAccumulator(6), t_metrics.MeanCovAccumulator(6)
        a.update(feats[:20])
        b.update(feats[20:35])
        b.update(feats[35:])
        a.merge(b)
        mu, cov = a.finalize()
        j = j_metrics.MeanCovAccumulator(6)
        j.update(feats)
        j_mu, j_cov = j.finalize()
        f64 = feats.astype(np.float64)
        np.testing.assert_allclose(mu, f64.mean(0), rtol=0, atol=1e-12)
        np.testing.assert_allclose(cov, np.cov(f64, rowvar=False), rtol=0, atol=1e-12)
        np.testing.assert_allclose(mu, j_mu, rtol=0, atol=1e-12)
        np.testing.assert_allclose(cov, j_cov, rtol=0, atol=1e-12)
        a.allreduce()  # no process group: nothing changes
        assert a.n == 50 and np.array_equal(a.finalize()[1], cov)

    def test_mean_accumulator_and_too_few_samples(self):
        m = t_metrics.MeanAccumulator()
        m.update([1.0, 2.0])
        m.update(np.array([[3.0]]))
        m.allreduce()
        assert m.finalize() == 2.0 and t_metrics.MeanAccumulator().finalize() == 0.0
        one = t_metrics.MeanCovAccumulator(3)
        one.update(np.ones((1, 3)))
        with pytest.raises(ValueError, match=">= 2 samples"):
            one.finalize()


class TestMetricCalculator:
    def test_mixed_shapes_with_random_projection_frechet(self):
        """Two updates of twelve mixed-shape pairs; the JAX side's images are
        JAX arrays, the port's CPU tensors."""
        kw = dict(dim=8, size=16)
        calcs = {
            "port": t_metrics.MetricCalculator(
                ("ssim", "psnr", "fid", "fdd"), fid_feature_fn=t_ef.random_projection_feature_fn(seed=0, **kw),
                fdd_feature_fn=t_ef.random_projection_feature_fn(seed=1, bucketed_resize=True, **kw), chunk=5),
            "jax": j_metrics.MetricCalculator(
                ("ssim", "psnr", "fid", "fdd"), fid_feature_fn=j_ef.random_projection_feature_fn(seed=0, **kw),
                fdd_feature_fn=j_ef.random_projection_feature_fn(seed=1, bucketed_resize=True, **kw), chunk=5),
        }
        for seed in (0, 1):
            refs, recons = _images(seed, noise=0.2)
            calcs["port"].update([torch.from_numpy(r) for r in refs], [torch.from_numpy(x) for x in recons])
            calcs["jax"].update([jnp.asarray(r) for r in refs], [jnp.asarray(x) for x in recons])
        got, want = calcs["port"].gather(), calcs["jax"].gather()
        assert set(got) == set(want) and got["n_images"] == want["n_images"] == 24
        assert abs(got["ssim"] - want["ssim"]) <= 1e-5
        assert abs(got["psnr"] - want["psnr"]) <= 1e-4
        for name in ("fid", "fdd"):
            assert got[name] > 0 and abs(got[name] - want[name]) <= 1e-4 * want[name], name

    def test_per_image_metrics(self):
        refs, recons = _images(3, shapes=[(3, 20, 20)], noise=0.1)
        r, x = torch.from_numpy(refs[0]), torch.from_numpy(recons[0])
        assert t_metrics.compute_ssim(r, x) == pytest.approx(
            float(j_metrics.compute_ssim(jnp.asarray(refs[0]), jnp.asarray(recons[0]))), abs=1e-5)
        assert t_metrics.compute_psnr(r, x) == pytest.approx(
            float(j_metrics.compute_psnr(jnp.asarray(refs[0]), jnp.asarray(recons[0]))), abs=1e-4)

    def test_refuses_a_frechet_metric_without_features_and_unequal_lists(self):
        with pytest.raises(ValueError, match="fid_feature_fn"):
            t_metrics.MetricCalculator(("fid",))
        calc = t_metrics.MetricCalculator(("ssim",))
        with pytest.raises(ValueError, match="reconstructions"):
            calc.update([torch.zeros(3, 8, 8)], [])


_WORKER = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from vitok_torch.metrics import MeanAccumulator, MeanCovAccumulator

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
feats = np.random.default_rng(0).standard_normal((10, 4))
acc = MeanCovAccumulator(4)
acc.update(feats[:3] if rank == 0 else feats[3:])
acc.allreduce()
m = MeanAccumulator()
m.update(feats[:3, 0] if rank == 0 else feats[3:, 0])
m.allreduce()
dist.destroy_process_group()
json.dump({"n": acc.n, "s": acc.s.tolist(), "outer": acc.outer.tolist(), "mean": m.finalize()}, open(out, "w"))
"""


def test_allreduce_over_a_two_process_gloo_group(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": REPO}
    outs = [tmp_path / f"rank{r}.json" for r in (0, 1)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), str(port), str(outs[r])], env=env)
             for r in (0, 1)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    feats = np.random.default_rng(0).standard_normal((10, 4))
    whole = t_metrics.MeanCovAccumulator(4)
    whole.update(feats)
    for out in outs:
        got = json.loads(out.read_text())
        assert got["n"] == 10
        np.testing.assert_allclose(got["s"], whole.s, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got["outer"], whole.outer, rtol=0, atol=1e-12)
        assert got["mean"] == pytest.approx(feats[:, 0].mean(), abs=1e-12)
