"""The distributed slice (``vitok_torch.parallel``): DDP, FSDP2 (HSDP) and
tensor parallelism against the single-device port, over gloo on the CPU.

One spawn of four processes (``dryrun_multiprocess.launch``, a ``file://``
rendezvous in a temporary folder, one thread each) lays a tiny AE (width
256, four heads of 64, one encoder and one decoder block, 8 NaFlex images
of 16 tokens with tail padding) over four meshes: ``data=4``,
``data=2,fsdp=2``, ``fsdp=2,model=2`` and ``model=4``. Each process holds
its layout against the same model unsharded, in that process, on the whole
batch. Limits:

* the sharded forward (inference), valid tokens: max abs 1e-5 (fp32);
* one AdamW step and one Muon step (constant LR 3e-4, clipping at 1.0,
  Charbonnier + SSIM tiles at fixed origins): loss rel 1e-5, EMA max abs
  1e-5, parameters max abs 1e-5 where the batch alone is split (the JAX
  ``TestShardedGradAccum`` limits). Where ``model`` splits the blocks, the
  row-parallel partial sums are added in another order, and the first Adam
  step (``g / (|g| + eps)``) and bf16 Newton-Schulz carry those last-digit
  differences of small gradient entries to up to 2.9e-5 (measured: grad
  accumulation under ``model=4``): 3e-5 there, a tenth of the step's
  movement (3e-4);
* a step under selective recomputation (``remat_save``, its replay inside
  the block's call, where FSDP2 gathers the parameters) and one step of a
  tiny DiT (two blocks, the adaLN ``mod`` whole), with the step's limits;
* the int8 forward where ``model`` splits the blocks (qkv and out sliced,
  the FFN whole, the out-projection's int32 partial products summed over
  the group): the single device's bit for bit;
* a checkpoint of the sharded state is the single-device layout, bit for
  bit, and loads back into a fresh sharded state bit for bit;
* gradient accumulation (two microbatches of each shard's rows) against
  the whole batch in one step, with the step's limits; the distributed
  mean and covariance of ``metrics.MeanCovAccumulator``: atol 1e-6.
"""

import ast
import os
import types
from pathlib import Path

import pytest
import torch

from vitok_torch.parallel import mesh as t_mesh
from vitok_torch.parallel import sharding as t_sh
from vitok_torch.scripts import dryrun_multiprocess as dm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MESHES = [{"data": 4}, {"data": 2, "fsdp": 2}, {"fsdp": 2, "model": 2}, {"model": 4}]
NAMES = [dm.mesh_name(m) for m in MESHES]


def params_limit(name):
    return dm.SPLIT_PARAMS_MAX_ABS if "model" in name else dm.LIMITS["params_max_abs"]


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    return dm.launch(4, MESHES, workdir=str(tmp_path_factory.mktemp("gloo4")))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_forward_equals_single_device(reports, name):
    for rep in reports[name]:
        assert rep["forward_max_abs"] <= 1e-5


@pytest.mark.parametrize("opt", ["adamw", "muon"])
@pytest.mark.parametrize("name", NAMES)
def test_one_step_equals_single_device(reports, name, opt):
    for rep in reports[name]:
        got = rep[opt]
        assert got["loss_rel"] <= 1e-5 and got["grad_norm_rel"] <= 1e-5
        assert got["params_max_abs"] <= params_limit(name), got
        assert got["ema_max_abs"] <= 1e-5
        assert got["moved"] > 1e-4  # the step moved the parameters


@pytest.mark.parametrize("name", NAMES)
def test_sharded_grad_accum_equals_the_full_batch(reports, name):
    """Each shard's rows in two microbatches, against the whole batch in one
    step unsharded (the JAX ``TestShardedGradAccum``)."""
    for rep in reports[name]:
        assert rep["accum"]["loss_rel"] <= 1e-5
        assert rep["accum"]["params_max_abs"] <= params_limit(name)


@pytest.mark.parametrize("name", NAMES)
def test_remat_save_step_equals_single_device(reports, name):
    for rep in reports[name]:
        assert rep["remat"]["loss_rel"] <= 1e-5
        assert rep["remat"]["params_max_abs"] <= params_limit(name)


@pytest.mark.parametrize("name", NAMES)
def test_dit_step_equals_single_device(reports, name):
    for rep in reports[name]:
        got = rep["dit"]
        assert got["loss_rel"] <= 1e-5 and got["params_max_abs"] <= params_limit(name)
        assert got["moved"] > 1e-4


@pytest.mark.parametrize("name", [n for n in NAMES if "model" in n])
def test_int8_tensor_parallel_forward_is_the_single_devices(reports, name):
    for rep in reports[name]:
        assert rep["int8_forward_max_abs"] == 0.0


def test_distributed_mean_and_covariance(reports):
    """``metrics.MeanCovAccumulator`` over rank-strided rows, all-reduced
    over the four processes, equals the statistics of all rows (the JAX
    ``TestDistributedMetrics``, atol 1e-6)."""
    for rep in reports["metrics"]:
        assert rep["mean_cov_max_abs"] <= 1e-6


@pytest.mark.parametrize("name", NAMES)
def test_checkpoint_is_the_single_device_state(reports, name):
    for rep in reports[name]:
        assert rep["checkpoint_params_max_abs"] == 0.0 and rep["checkpoint_mu_max_abs"] == 0.0
        assert rep["checkpoint_reload_max_abs"] == 0.0 and rep["checkpoint_step"] == 1


def test_dryrun_failures_read_the_limits():
    rep = {"forward_max_abs": 2e-5, "adamw": {"params_max_abs": 2e-5, "loss_rel": 1.0}}
    assert dm.failures(rep) == ["forward_max_abs", "adamw.params_max_abs", "adamw.loss_rel"]
    assert dm.failures(rep, split=True) == ["forward_max_abs", "adamw.loss_rel"]


class TestMesh:
    @pytest.mark.parametrize("axes,world,want", [
        (None, 4, {"data": 4}),
        ({"data": -1, "model": 2}, 8, {"data": 4, "model": 2}),
        ({"data": 2, "fsdp": 2, "model": 2}, 8, {"data": 2, "fsdp": 2, "model": 2}),
        ({"seq": -1}, 1, {"seq": 1}),
    ])
    def test_sizes(self, axes, world, want):
        assert t_mesh.mesh_sizes(axes, world) == want
        assert list(t_mesh.mesh_sizes(axes, world)) == list(want)  # the order is the mesh's

    @pytest.mark.parametrize("axes,world,match", [
        ({"data": -1, "fsdp": -1}, 4, "At most one"),
        ({"data": 3}, 4, "require 3"),
        ({"data": -1, "model": 3}, 4, "not divisible"),
        ({"tensor": 2}, 2, "unknown mesh axes"),
        ({"data": 0}, 0, "positive"),
    ])
    def test_bad_sizes_raise(self, axes, world, match):
        with pytest.raises(ValueError, match=match):
            t_mesh.mesh_sizes(axes, world)

    def test_initialize_is_a_no_op_in_one_process(self, monkeypatch):
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            monkeypatch.delenv(key, raising=False)
        assert t_mesh.initialize_distributed("cpu") == (0, 1, 0)
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="both"):
            t_mesh.initialize_distributed("cpu", rank=0)

    def test_backends(self):
        assert t_mesh.backend_for("cuda") == "nccl" and t_mesh.backend_for("cpu") == "gloo"
        with pytest.raises(ValueError, match="cuda"):
            t_mesh.backend_for("meta")

    def test_the_card_without_a_card_raises(self, monkeypatch):
        """No quiet fallback: asked for NCCL without a card, the start raises."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_mesh.initialize_distributed("cuda", rank=0, world_size=2)


def _stub_mesh(**sizes):
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


class TestSpecs:
    @pytest.mark.parametrize("name,shape,want", [
        ("encoder_blocks.0.attn.qkv_proj.weight", (768, 256), (("model", "fsdp"), None)),
        ("decoder_blocks.3.ffn.fc1.weight", (1376, 256), (("model", "fsdp"), None)),
        ("encoder_blocks.0.attn.out_proj.weight", (256, 256), (("fsdp",), ("model",))),
        ("decoder_blocks.0.ffn.fc2.weight", (256, 688), (("fsdp",), ("model",))),
        ("encoder_blocks.0.attn.norm_q.weight", (64,), (("fsdp",),)),
        ("patch_embed.weight", (256, 768), (("fsdp",), None)),
    ])
    def test_param_specs(self, name, shape, want):
        spec = t_sh.ae_param_specs(_stub_mesh(fsdp=2, model=2))(name, torch.zeros(shape))
        assert spec == want
        assert t_sh.ae_param_specs(_stub_mesh(data=4))(name, torch.zeros(shape)) == (None,) * len(shape)

    def test_batch_splits_over_data_and_fsdp(self):
        assert t_sh.batch_specs(_stub_mesh(data=2, fsdp=2, model=2)) == ("data", "fsdp")
        assert t_sh.batch_specs(_stub_mesh(model=4)) == ()

    @pytest.mark.parametrize("kind,rows,size", [("slab3", 768, 4), ("slab3", 384, 2), ("slab2", 1376, 2)])
    def test_slabs_keep_each_ranks_heads(self, kind, rows, size):
        """Every rank keeps a block of each slab (q, k, v or v, g): together
        they cover every row once, and rank r's rows of each slab follow
        rank r - 1's."""
        parts = [t_sh._slab_rows(kind, rows, size, r) for r in range(size)]
        assert sorted(torch.cat(parts).tolist()) == list(range(rows))
        slabs = 3 if kind == "slab3" else 2
        per = rows // slabs // size
        for r, p in enumerate(parts):
            assert p.tolist()[:per] == list(range(r * per, (r + 1) * per))


class TestSlices:
    def test_int8_linear_keeps_the_scales_of_its_rows(self):
        from vitok_torch.models.ae import Int8Linear

        w = torch.arange(24 * 8, dtype=torch.int32).remainder(255).sub(127).to(torch.int8).reshape(24, 8)
        lin = Int8Linear(w, torch.arange(24, dtype=torch.float32))
        rows = t_sh._sliced_linear(lin, "slab3", 2, 1)
        keep = t_sh._slab_rows("slab3", 24, 2, 1)
        assert torch.equal(rows.weight_int8, w[keep]) and torch.equal(rows.scale, lin.scale[keep])
        cols = t_sh._sliced_linear(lin, "cols", 2, 1)
        assert torch.equal(cols.weight_int8, w[:, 4:]) and torch.equal(cols.scale, lin.scale)

    def test_full_precision_slices_keep_requires_grad(self):
        lin = torch.nn.Linear(8, 12, bias=False)
        out = t_sh._sliced_linear(lin, "cols", 4, 3)
        assert torch.equal(out.weight, lin.weight[:, 6:]) and out.weight.requires_grad

    def test_quantize_after_tensor_parallelism_raises(self):
        model = dm.build_model()
        model.encoder_blocks[0].tp_group = object()
        with pytest.raises(ValueError, match="quantize before tensor parallelism"):
            model.quantize()


def test_pipeline_names_are_not_ported_yet():
    """Once raising stubs, the four pipeline names are now the functions of
    ``vitok_torch.parallel.pipeline`` (``tests/test_torch_pipeline.py``
    holds them)."""
    import vitok_torch.parallel as par
    from vitok_torch.parallel import pipeline

    for name in ("make_pipeline_train_step", "pipeline_param_specs", "pipeline_parallel_decode",
                 "pipeline_parallel_value_and_grad"):
        assert getattr(par, name) is getattr(pipeline, name) and name in par.__all__
    assert par.PIPE_AXIS == "pipe"


@pytest.mark.parametrize("module", ["parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
                                    "parallel/sequence.py", "parallel/comm.py", "parallel/pipeline.py",
                                    "scripts/dryrun_multiprocess.py",
                                    "scripts/train_highres.py", "scripts/launch.py"])
def test_distributed_modules_import_no_jax(module):
    """The new modules lie inside the port and import neither JAX nor the
    JAX package (the AST check of ``test_torch_pp.py`` reads them too)."""
    path = REPO / "vitok_torch" / module
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "optax", "vitok_tpu"), (module, n)
