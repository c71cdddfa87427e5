"""Pipeline parallelism (``vitok_torch.parallel.pipeline``) over gloo on the
CPU, against the single-process port and the JAX package.

One spawn of four processes (``dryrun_multiprocess.launch``, a ``file://``
rendezvous, one thread each) stages a tiny AE (width 256, four heads of 64,
one encoder and eight decoder blocks; 8 NaFlex images of 16 tokens with
tail padding, fp32) over ``pipe=4`` (two blocks a stage) and
``data=2,pipe=2`` (four blocks a stage, four images a data slice). Each
process holds, against the same model unstaged in that process on the
whole batch:

* the pipelined decode, masked with ``m = S`` and ``m = 2S`` microbatches
  and without padding: max abs 1e-5 (measured 0);
* ``pipeline_parallel_value_and_grad`` with ``remat`` on (``m = S``) and
  off (``m = 2S``): loss rel 1e-5, every gradient and ``dz`` rel L2 1e-5
  (measured up to 1.6e-7: the microbatches' gradients add in another
  order), each stage holding its own blocks' gradients only;
* one AdamW and one Muon step of ``make_pipeline_train_step`` (Charbonnier +
  SSIM tiles at fixed origins; on ``data=2,pipe=2`` also a random-init DINO
  ViT-S perceptual term), ``grad_accum=2``, and on ``pipe=4`` a step whose
  tile origins come from the step's seed: parameters and EMA max abs 1e-5,
  losses rel 1e-5, ``grad_norm`` rel 1e-6;
* stage 0's rows: a decode and an AdamW step whose later stages are given
  other rows, grids and tile origins (what a loader with a random pp gives
  each process) equal the single process on stage 0's: max abs 1e-5;
* a checkpoint of the staged state is the single-device layout, bit for
  bit, and loads back into a fresh staged state bit for bit;
* the int8 decode of a ``quantize()``d model: max abs 2e-4 (the JAX
  ``TestInt8Pipeline`` limit; measured 0);
* the errors: a depth, batch or microbatch count that does not divide, a
  ``model`` axis beside ``pipe``, and ``drop_path_rate > 0``.

Against the JAX package (``pipe=4`` on a virtual CPU mesh, the same weights
through ``to_jax_params`` and the same latents): the decode max abs 1e-5;
``pipeline_parallel_value_and_grad``'s loss rel 1e-5, every gradient and
``dz`` rel L2 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vitok_torch.parallel import comm
from vitok_torch.parallel import pipeline as t_pipe
from vitok_torch.scripts import dryrun_multiprocess as dm
from vitok_torch.utils.params_io import from_jax_params, to_jax_params

torch.set_num_threads(1)

MESHES = [{"pipe": 4}, {"data": 2, "pipe": 2}]
NAMES = [dm.mesh_name(m) for m in MESHES]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    wd = tmp_path_factory.mktemp("pipe4")
    reports = dm.launch(4, MESHES, workdir=str(wd))
    raw = [dict(np.load(wd / f"pipe_{r}.npz")) for r in range(4)]
    return reports, raw


def _stages(name):
    return dict(dm.parse_mesh(name))["pipe"]


@pytest.mark.parametrize("name", NAMES)
def test_decode_equals_single_device(spawned, name):
    s = _stages(name)
    for rep in spawned[0][name]:
        keys = [f"decode_masked_m{s}_max_abs", f"decode_masked_m{2 * s}_max_abs", f"decode_dense_m{s}_max_abs"]
        assert all(rep[k] <= 1e-5 for k in keys), rep


@pytest.mark.parametrize("remat", [1, 0])
@pytest.mark.parametrize("name", NAMES)
def test_value_and_grad_equals_single_device(spawned, name, remat):
    for rep in spawned[0][name]:
        got = rep[f"vjg_remat{remat}"]
        assert got["loss_rel"] <= 1e-5 and got["grads_rel_l2"] <= 1e-5 and got["dz_rel_l2"] <= 1e-5, got


@pytest.mark.parametrize("name", NAMES)
def test_block_grads_stay_on_their_stage(spawned, name):
    s = _stages(name)
    per = 8 // s
    for rank, rep in enumerate(spawned[0][name]):
        stage = rank % s  # the mesh's last axis is pipe
        want = list(range(stage * per, (stage + 1) * per))
        assert rep["blocks_held"] == want
        assert rep["vjg_remat1"]["blocks"] == want and rep["vjg_remat0"]["blocks"] == want


@pytest.mark.parametrize("opt", ["adamw", "muon"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_equals_single_device(spawned, name, opt):
    for rep in spawned[0][name]:
        got = rep[opt]
        assert got["params_max_abs"] <= 1e-5 and got["ema_max_abs"] <= 1e-5, got
        assert got["loss_rel"] <= 1e-5 and got["grad_norm_rel"] <= 1e-6, got
        assert got["moved"] > 1e-4 and got["metrics"], got


@pytest.mark.parametrize("name", NAMES)
def test_grad_accum_equals_the_full_batch(spawned, name):
    for rep in spawned[0][name]:
        assert rep["accum"]["params_max_abs"] <= 1e-5 and rep["accum"]["loss_rel"] <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_every_stage_takes_stage0_rows(spawned, name):
    for rep in spawned[0][name]:
        assert rep["decode_stage0_max_abs"] <= 1e-5, rep["decode_stage0_max_abs"]
        got = rep["stage0_rows"]
        assert got["params_max_abs"] <= 1e-5 and got["loss_rel"] <= 1e-5, got


def test_seeded_tile_origins_are_the_single_devices(spawned):
    for rep in spawned[0]["pipe=4"]:
        assert rep["seeded"]["params_max_abs"] <= 1e-5 and rep["seeded"]["loss_rel"] <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_is_the_single_device_state(spawned, name):
    for rep in spawned[0][name]:
        assert rep["checkpoint_params_max_abs"] == 0.0 and rep["checkpoint_ema_max_abs"] == 0.0
        assert rep["checkpoint_mu_max_abs"] == 0.0 and rep["checkpoint_mu_layout"]
        assert rep["checkpoint_reload_max_abs"] == 0.0 and rep["checkpoint_step"] == 1


def test_int8_decode_equals_single_device(spawned):
    for rep in spawned[0]["pipe=4"]:
        assert rep["int8_decode_max_abs"] <= 2e-4


@pytest.mark.parametrize("case,match", [
    ("depth", "decoder_depth 9 not divisible by pipe=4"),
    ("batch", "batch 5 not divisible by microbatches 4"),
    ("microbatches", "microbatches 2 not divisible by pipe=4"),
    ("model_axis", "composes with data only"),
    ("drop_path", "drop_path_rate must be 0"),
])
def test_pipeline_errors(spawned, case, match):
    for rep in spawned[0]["pipe=4"]:
        assert rep["errors"][case] is not None and match in rep["errors"][case]


def test_dryrun_reports_pass(spawned):
    for name in NAMES:
        for rep in spawned[0][name]:
            assert dm.failures(rep, pipe=True) == []


def test_dryrun_failures_read_the_pipe_limits():
    rep = {"decode_masked_m4_max_abs": 2e-5, "vjg_remat1": {"grads_rel_l2": 2e-4}, "adamw": {"grad_norm_rel": 2e-6},
           "errors": {"depth": None, "batch": "raised"}, "checkpoint_mu_layout": False}
    assert dm.failures(rep, pipe=True) == ["decode_masked_m4_max_abs", "vjg_remat1.grads_rel_l2",
                                           "adamw.grad_norm_rel", "errors.depth", "checkpoint_mu_layout"]


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_setup():
    from vitok_tpu.models import ae as j_ae
    from vitok_tpu.parallel import create_mesh

    cfg = j_ae.AEConfig.from_variant(dm.PIPE_VARIANT)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_params(
        {k: v.detach() for k, v in dm.build_model(dm.PIPE_VARIANT).state_dict().items()}))
    mesh = create_mesh({"pipe": 4}, devices=jax.devices()[:4])
    return cfg, params, mesh


def _enc(tag, z):
    grids = dm.GRIDS if tag == "masked" else [(4, 4)] * dm.GLOBAL_BATCH
    batch, _ = dm.make_global_batch(grids=grids)
    enc = {k: jnp.asarray(batch[k]) for k in ("patch_mask", "row_idx", "col_idx")}
    enc["z"] = jnp.asarray(z)
    return enc, batch


@pytest.mark.parametrize("tag", ["masked", "dense"])
def test_decode_matches_jax(spawned, tag):
    from vitok_tpu.parallel.pipeline import pipeline_parallel_decode

    cfg, params, mesh = _jax_setup()
    raw = spawned[1]
    enc, batch = _enc(tag, raw[0][f"z_{tag}"])
    want = np.asarray(pipeline_parallel_decode(params, enc, cfg, mesh, num_microbatches=4,
                                               compute_dtype=jnp.float32)["patches"])
    valid = batch["patch_mask"]
    for r in raw:  # every stage returns the whole batch in batch order
        got = r[f"decode_{tag}_m4"]
        assert np.abs(got - want)[valid].max() <= 1e-5


@pytest.mark.parametrize("remat", [1, 0])
def test_value_and_grad_matches_jax(spawned, remat):
    from vitok_tpu.parallel.pipeline import pipeline_parallel_value_and_grad

    cfg, params, mesh = _jax_setup()
    raw = spawned[1]
    enc, batch = _enc("masked", raw[0]["z_masked"])
    loss, grads, dz = pipeline_parallel_value_and_grad(
        params, enc, jnp.asarray(batch["patches"]), cfg, mesh, num_microbatches=4 if remat else 8,
        compute_dtype=jnp.float32, remat=bool(remat))
    tag = f"vjg_remat{remat}"
    want = from_jax_params({k: jax.tree_util.tree_map(np.asarray, v) for k, v in grads.items()})
    got = {}
    for r in raw:  # each stage's blocks, the replicated gradients from every stage
        got.update({k[len(f"{tag}/grad/"):]: v for k, v in r.items() if k.startswith(f"{tag}/grad/")})
    assert sorted(got) == sorted(want)
    for r in raw:
        assert abs(float(r[f"{tag}/loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
        assert rel_l2(r[f"{tag}/dz"], np.asarray(dz)) <= 1e-4
    for name, w in want.items():
        assert rel_l2(got[name], w.numpy()) <= 1e-4, name


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_staged(tmp_path_factory):
    import json

    wd = tmp_path_factory.mktemp("p2p")
    dm.spawn("p2p_job", 2, str(wd), host_staged=True)
    return [json.loads((wd / f"p2p_{r}.json").read_text()) for r in range(2)]


def test_host_staged_transfers_deliver(host_staged):
    """The point-to-point helper's host copy (gloo's route for a CUDA
    tensor), forced on CPU tensors: every rank receives its neighbour's
    tensor, and the halo exchange its neighbours' rows."""
    for rep in host_staged:
        assert rep["ring"] and rep["halo"] and rep["device"] == "cpu"


def test_cards_job_rehearses_on_the_host():
    """``dryrun_multiprocess --cards`` (the halo exchange and a ``pipe=4``
    pipeline, one process a card over NCCL) over gloo on the CPU: every
    exchange delivers, the pipeline within the dry run's pipe limits, no
    kernel launched."""
    got = dm.cards_check(4, device="cpu", halo_rows=64)
    assert got["ok"], got["failed"]
    for rep in got["ranks"]:
        assert rep["backend"] == "gloo" and rep["halo"] and rep["halo_grad"]
        assert rep["adamw"]["params_max_abs"] <= 1e-5 and rep["adamw"]["grad_norm_rel"] <= 1e-6, rep["adamw"]


def test_staging_reads_the_backend(monkeypatch):
    monkeypatch.setattr(comm.dist, "get_backend", lambda group: "gloo")
    cpu = torch.zeros(2)
    assert not comm._host_staged(cpu, None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert comm._host_staged(cpu, None)
    monkeypatch.setattr(comm.dist, "get_backend", lambda group: "nccl")
    assert not comm._host_staged(cpu, None)


def test_param_specs_and_the_staged_model():
    spec = t_pipe.pipeline_param_specs(None)
    assert spec("decoder_blocks.3.attn.qkv_proj.weight") == "pipe"
    assert spec("decoder_embed.weight") is None and spec("encoder_blocks.0.norm1.weight") is None
    place = t_pipe.Elsewhere(5, 2)
    with pytest.raises(RuntimeError, match="block 5 lives on pipe stage 2"):
        place(torch.zeros(1))
    with pytest.raises(ValueError, match="not laid over a pipe mesh"):
        t_pipe.pipeline_parallel_decode(dm.build_model(dm.PIPE_VARIANT), {"z": torch.zeros(4, 16, 8)})


def test_only_data_composes_with_pipe():
    import types

    mesh = lambda **sizes: types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))
    t_pipe.check_pipe_mesh(mesh(data=2, pipe=2))
    t_pipe.check_pipe_mesh(mesh(pipe=4, fsdp=1))
    for other in ("fsdp", "model", "seq"):
        with pytest.raises(ValueError, match="composes with data only"):
            t_pipe.check_pipe_mesh(mesh(pipe=2, **{other: 2}))
