"""The distributed CLIs under ``torchrun`` on the CPU (gloo): ``train_vae
--mesh``, ``train_dit --mesh``, ``python -m vitok_torch.scripts.train_highres``
and ``vitok_torch.scripts.launch``, each end to end with resume, and a
checkpoint moving between layouts (``data=2`` -> ``fsdp=2`` ->
single-device -> the token-sharded finetune; the DiT's ``data=2`` ->
``model=2``).

Each run is two processes of a tiny AE (width 64, one head) or DiT on eight
seeded images (or latents); ``torchrun --standalone`` picks a free local
port. What is held: the runs finish, resume at the saved step, write the
single-device ``state.pt`` (shapes of the unsharded model), and a
``train_vae`` checkpoint warm-starts ``train_highres``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitok_torch.scripts import launch as t_launch
from vitok_torch.scripts import train_highres as t_hr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANT = "w64_d1_h1-w64_d2_h1/1x16x8"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    (root / "imgs").mkdir()
    (root / "lat").mkdir()
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (64 + 8 * i, 64, 3), dtype=np.uint8)).save(root / "imgs" / f"{i}.png")
        np.save(root / "lat" / f"{i}.npy",
                {"z": rng.standard_normal((16, 32)).astype(np.float32), "label": i % 3}, allow_pickle=True)
    return root


def torchrun(cli, *args, nproc=2):
    """Run ``vitok_torch.scripts.<cli>`` in ``nproc`` gloo processes; the
    first process's output."""
    cmd = t_launch.torchrun_command(cli, ["--device", "cpu", *map(str, args)], nproc)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _vae_args(data, out, steps):
    return ["--variant", VARIANT, "--data", data / "imgs", "--max-tokens", 16, "--tile-size", 64, "--bs", 2,
            "--steps", steps, "--log-freq", 1, "--output-dir", out]


def test_train_vae_mesh_resumes_across_layouts_and_warm_starts_the_finetune(data, tmp_path):
    from vitok_torch.models.ae import AE, AEConfig

    out = tmp_path / "vae"
    first = torchrun("train_vae", *_vae_args(data, out, 2), "--mesh", "data=2")
    assert "mesh: {'data': 2}, processes: 2" in first and "step 2:" in first and "training done" in first
    assert first.count("device: cpu") == 1  # the first process logs
    second = torchrun("train_vae", *_vae_args(data, out, 3), "--mesh", "fsdp=2", "--resume")
    assert "resumed at step 2" in second and "step 3:" in second
    payload = torch.load(out / "last" / "state.pt", weights_only=True)
    cfg = AEConfig.from_variant(VARIANT)
    want = AE(**cfg.__dict__, device="cpu", param_dtype=torch.float32, trainable=True).state_dict()
    assert payload["step"] == 3 and payload["opt_state"]["count"] == 3
    assert {k: tuple(v.shape) for k, v in payload["params"].items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert all(tuple(m.shape) == tuple(want[n].shape)
               for n, m in zip(want, payload["opt_state"]["mu"]))
    assert (out / "safetensors" / "decoder.safetensors").exists()

    hr = tmp_path / "hr"
    common = ["--variant", VARIANT, "--data", data / "imgs", "--res", 64, "--sw", 4, "--bs", 1, "--log-freq", 1,
              "--output-dir", hr]
    warm = torchrun("train_highres", *common, "--steps", 2, "--init-ckpt", out / "last")
    assert "seq mesh: 2 shards, 16 tokens/img (8/shard), sw=4" in warm
    assert "warm-started params from" in warm and "step 2:" in warm and "finetune done" in warm
    resumed = torchrun("train_highres", *common, "--steps", 3, "--resume")
    assert "resumed at step 2" in resumed and "step 3:" in resumed
    assert torch.load(hr / "last" / "state.pt", weights_only=True)["step"] == 3


def test_train_dit_mesh_through_the_launcher(data, tmp_path):
    """``launch --run`` builds and runs the torchrun command of ``train_dit
    --mesh data=2``; a second run resumes under ``model=2`` (tensor
    parallelism over the DiT's blocks)."""
    out = tmp_path / "dit"
    args = ["--nproc-per-node", "2", "--run", "--", "train_dit", "--device", "cpu", "--dit", "w64_d2_h2/16",
            "--data", str(data / "lat"), "--bs", "2", "--log-freq", "1", "--output-dir", str(out)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for steps, want in ((2, '"step": 2'), (3, "resumed at step 2")):
        proc = subprocess.run([sys.executable, "-m", "vitok_torch.scripts.launch", *args, "--steps", str(steps)]
                              + (["--mesh", "data=2"] if steps == 2 else ["--mesh", "model=2", "--resume"]),
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
        assert "torch.distributed.run --nproc-per-node=2 --standalone -m vitok_torch.scripts.train_dit" in proc.stdout
        assert want in proc.stdout and "training done" in proc.stdout
    assert torch.load(out / "last" / "state.pt", weights_only=True)["step"] == 3


class TestCommands:
    def test_one_node_is_standalone(self):
        cmd = t_launch.torchrun_command("train_vae", ["--mesh", "data=4"], 4)
        assert cmd[1:5] == ["-m", "torch.distributed.run", "--nproc-per-node=4", "--standalone"]
        assert cmd[-4:] == ["-m", "vitok_torch.scripts.train_vae", "--mesh", "data=4"]

    def test_several_nodes_name_the_first(self):
        cmd = t_launch.torchrun_command("train_highres", [], 8, nnodes=2, node_rank=1, master_addr="10.0.0.1")
        assert "--nnodes=2" in cmd and "--node-rank=1" in cmd and "--master-addr=10.0.0.1" in cmd
        with pytest.raises(SystemExit, match="master-addr"):
            t_launch.torchrun_command("train_vae", [], 8, nnodes=2)
        with pytest.raises(SystemExit, match="unknown CLI"):
            t_launch.torchrun_command("gcloud", [], 1)

    def test_prints_without_running(self, capsys):
        assert t_launch.main(["--nproc-per-node", "2", "--", "train_vae", "--data", "x"]) == 0
        assert "--nproc-per-node=2 --standalone -m vitok_torch.scripts.train_vae --data x" in capsys.readouterr().out


class TestGeometry:
    def test_tokens_split_over_the_shards(self):
        assert t_hr.check_geometry(2048, 16, 8, 1024) == 16384

    @pytest.mark.parametrize("res,seq,sw,match", [(1008, 2, 64, "not divisible"), (256, 4, 128, "exceeds")])
    def test_bad_geometry_raises(self, res, seq, sw, match):
        with pytest.raises(SystemExit, match=match):
            t_hr.check_geometry(res, 16, seq, sw)


@pytest.mark.parametrize("cli,args,match", [
    # The first two ids are those of the cases before pipeline parallelism was ported.
    pytest.param("train_vae", ["--mesh", "pipe=2,fsdp=2"], "composes with data=D only",
                 id="train_vae-args0-not ported yet"),
    pytest.param("train_vae", ["--pipe-microbatches", "4"], "needs --mesh pipe=K", id="train_vae-args1-not ported yet"),
    ("train_vae", ["--mesh", "seq=2"], "train_highres"),
    ("train_dit", ["--mesh", "data=1,seq=2"], "takes the axes"),
    ("train_dit", ["--mesh", "pipe=2"], "takes the axes"),
])
def test_meshes_the_clis_do_not_take_raise(cli, args, match, tmp_path):
    """A pipe mesh composes with data only, and the microbatch count needs
    one; sequence parallelism is ``train_highres``; the DiT takes data,
    fsdp and model. Each raises before any process group starts."""
    import importlib

    main = importlib.import_module(f"vitok_torch.scripts.{cli}").main
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "--data", str(tmp_path), *args])
    assert not torch.distributed.is_initialized()
