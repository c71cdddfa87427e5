"""``train_vae --mesh pipe=K`` under ``torchrun`` on the CPU (gloo).

A tiny AE (width 64, one head, two decoder blocks: one a stage under
``pipe=2``) on eight seeded images:

* ``--mesh data=2,pipe=2`` (four processes) with ``--grad-accum 2`` and the
  full loss (Charbonnier, SSIM tiles and a random-init DINO ViT-S perceptual
  term) for two steps, then ``--mesh pipe=2 --resume`` for a third, then a
  single process resumes the fourth: the runs finish, resume at the saved
  step, and ``state.pt`` keeps the single-device layout throughout;
* ``--charbonnier-weight 0.5`` without tiles halves the first step's loss
  against the default weight on a pipe mesh (the JAX CLI passed no loss
  config there and dropped the weight);
* the meshes and flags the pipeline refuses exit before any process group
  starts.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

from vitok_torch.scripts import launch as t_launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANT = "w64_d1_h1-w64_d2_h1/1x16x8"
PP = "to_tensor|normalize(minus_one_to_one)|resize_to_token_budget(16, 16)|patchify(16, 16)"  # no random crop or flip


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pipe_cli") / "imgs"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (64 + 8 * i, 64, 3), dtype=np.uint8)).save(root / f"{i}.png")
    return root


def run(*args, nproc=2):
    """``train_vae`` in ``nproc`` gloo processes (one without torchrun);
    the first process's output."""
    argv = ["--device", "cpu", *map(str, args)]
    cmd = (t_launch.torchrun_command("train_vae", argv, nproc) if nproc > 1
           else [t_launch.sys.executable, "-m", "vitok_torch.scripts.train_vae", *argv])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def common(images, out, steps, bs=4):
    return ["--variant", VARIANT, "--data", images, "--max-tokens", 16, "--tile-size", 32, "--bs", bs,
            "--steps", steps, "--log-freq", 1, "--output-dir", out]


def step_log(text, step):
    line = next(ln for ln in text.splitlines() if ln.startswith(f"step {step}:"))
    return json.loads(line.split(":", 1)[1])


def test_pipe_runs_resume_across_layouts_with_accum_and_the_full_loss(images, tmp_path):
    from vitok_torch.models.ae import AE, AEConfig

    out = tmp_path / "pipe"
    first = run(*common(images, out, 2), "--mesh", "data=2,pipe=2", "--grad-accum", 2, "--perceptual-weight", 0.5,
                nproc=4)
    assert "mesh: {'data': 2, 'pipe': 2}, processes: 4" in first and "training done" in first
    log = step_log(first, 2)
    assert {"loss/charbonnier", "loss/ssim", "loss/perceptual", "grad_norm"} <= set(log)
    assert all(np.isfinite(v) for v in log.values())
    second = run(*common(images, out, 3), "--mesh", "pipe=2", "--pipe-microbatches", 4, "--resume")
    assert "resumed at step 2" in second and "step 3:" in second
    third = run(*common(images, out, 4), "--resume", nproc=1)
    assert "resumed at step 3" in third and "step 4:" in third
    payload = torch.load(out / "last" / "state.pt", weights_only=True)
    want = AE(**AEConfig.from_variant(VARIANT).__dict__, device="cpu", param_dtype=torch.float32,
              trainable=True).state_dict()
    assert payload["step"] == 4 and payload["opt_state"]["count"] == 4
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert [tuple(m.shape) for m in payload["opt_state"]["mu"]] == [tuple(v.shape) for v in want.values()]
    assert (out / "safetensors" / "decoder.safetensors").exists()


def test_charbonnier_weight_holds_on_a_pipe_mesh_without_tiles(images, tmp_path):
    losses = {}
    for w in (1.0, 0.5):
        text = run(*common(images, tmp_path / str(w), 1), "--mesh", "pipe=2", "--ssim-weight", 0,
                   "--charbonnier-weight", w, "--pp", PP)
        losses[w] = step_log(text, 1)
    # The log prints five decimals.
    assert losses[0.5]["loss/charbonnier"] == losses[1.0]["loss/charbonnier"]
    assert losses[0.5]["loss/total"] == pytest.approx(0.5 * losses[1.0]["loss/total"], abs=1e-5)
    assert abs(losses[0.5]["loss/total"] - losses[1.0]["loss/total"]) > 0.1


@pytest.mark.parametrize("args,match", [
    (["--mesh", "pipe=2,model=2"], "composes with data=D only"),
    (["--mesh", "pipe=2", "--drop-path", "0.1"], "drop-path"),
    (["--pipe-microbatches", "4"], "needs --mesh pipe=K"),
])
def test_pipe_meshes_the_cli_refuses(args, match, tmp_path):
    from vitok_torch.scripts.train_vae import main

    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "--data", str(tmp_path), *args])
    assert not torch.distributed.is_initialized()
