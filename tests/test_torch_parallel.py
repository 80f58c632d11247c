"""The port's parallel layer in one process: the mesh's sizing, its layout, and every helper a no-op outside a mesh.

``create_mesh`` keeps the JAX package's sizing semantics and errors
(tests/test_parallel.py::test_mesh_sizing_semantics, here over 8
processes); the ranks are laid out row-major (data, rays) as the JAX
package lays out its devices. Without a process group and outside a mesh
context the helpers answer for one process and change nothing, so a run
of one process computes what it computed without them. The two-process
behaviour is tests/test_torch_multiprocess.py's.
"""

import numpy as np
import pytest
import torch

from yanerf_tpu_torch import parallel
from yanerf_tpu_torch.ops.kernels import nerf_mlp_bwd as K3
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.parallel import distributed, mesh as port_mesh, sharding


def test_mesh_sizing_semantics():
    # both axes pinned: a 1x1 mesh of 8 processes is legitimate
    assert port_mesh.mesh_shape(8, 1, 1) == (1, 1)
    assert port_mesh.mesh_shape(8, 1, 4) == (1, 4)
    # one axis given: the other covers the world; none: every process on the ray axis
    assert port_mesh.mesh_shape(8, ray_parallel=2) == (4, 2)
    assert port_mesh.mesh_shape(8, data_parallel=2) == (2, 4)
    assert port_mesh.mesh_shape(8) == (1, 8)
    with pytest.raises(ValueError, match="evenly divide"):
        port_mesh.mesh_shape(8, ray_parallel=3)
    with pytest.raises(ValueError, match="evenly divide"):
        port_mesh.mesh_shape(8, data_parallel=0)
    with pytest.raises(ValueError, match="only 8 available"):
        port_mesh.mesh_shape(8, 3, 4)


def test_mesh_layout_is_row_major_over_data_then_rays():
    mesh = parallel.create_mesh(2, 4, world_size=8, rank=6)
    assert (mesh.shape, mesh.size, mesh.data_index, mesh.ray_index) == ({"data": 2, "rays": 4}, 8, 1, 2)
    assert mesh.data_ranks(2) == [2, 6] and mesh.ray_ranks(1) == [4, 5, 6, 7]
    assert mesh.data_group is mesh.ray_group is None  # no process group: no subgroups
    alone = parallel.create_mesh()
    assert (alone.shape, alone.rank) == ({"data": 1, "rays": 1}, 0)


def test_one_process_answers_for_itself(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "SLURM_NTASKS", "SLURM_PROCID"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.detect_world() == (1, 0)
    assert parallel.init_distributed_mode(device="cpu") is False
    assert not parallel.is_dist_avail_and_initialized()
    assert (parallel.get_rank(), parallel.get_world_size(), parallel.is_main_process()) == (0, 1, True)
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    assert np.array_equal(parallel.concat_all_gather(x), x)
    parallel.barrier("nothing to wait for")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_PROCID", "3")
    assert distributed.detect_world() == (4, 3)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        parallel.init_distributed_mode(device="cpu")


def test_ray_helpers_are_no_ops_outside_a_mesh_and_without_a_ray_split():
    t = torch.arange(24.0).reshape(2, 6, 2).requires_grad_()
    assert sharding.active_mesh() is None and sharding.ray_parallel() == 1
    assert parallel.shard_rays(t) is t and parallel.gather_rays(t) is t
    params = [torch.nn.Parameter(torch.ones(3))]
    params[0].grad = torch.full((3,), 2.0)
    parallel.reduce_gradients(params)  # no mesh: nothing
    data_only = parallel.create_mesh(4, 1, world_size=4, rank=1)
    with parallel.mesh_context(data_only):
        assert sharding.active_mesh() is data_only and sharding.ray_parallel() == 1
        assert parallel.shard_rays(t) is t and parallel.gather_rays(t) is t
        parallel.reduce_gradients(params)  # no process group: nothing
    assert sharding.active_mesh() is None and torch.equal(params[0].grad, torch.full((3,), 2.0))


def test_shard_rays_takes_this_process_slice():
    t = torch.arange(16.0).reshape(1, 8, 2)
    with parallel.mesh_context(parallel.create_mesh(1, 4, world_size=4, rank=2)):
        assert torch.equal(parallel.shard_rays(t), t[:, 4:6])
        with pytest.raises(ValueError, match="do not split over 4"):
            parallel.shard_rays(torch.zeros(1, 6, 2))


def test_chip_smoke_distributed_phase_runs_on_the_cpu_with_gloo(tmp_path, monkeypatch):
    """chip_smoke.py's "distributed" phase at a tiny size: the fused CLI in a one-rank gloo group equals the run
    without a group bit for bit, its evals gathered through the group."""
    import chip_smoke
    from yanerf_tpu_torch.synth_scene import write_scene
    from yanerf_tpu_torch.utils import Config

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    scene = write_scene(tmp_path / "scene", hw=8, n_train=8, n_val=1, n_test=1, n_spheres=3, seed=1)
    cfg = Config.fromfile(str(chip_smoke.CONFIG))
    cfg.merge_from_dict({
        "pipeline.ray_sampler.image_height": 8, "pipeline.ray_sampler.image_width": 8,
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 1024,
        "runner.num_workers_list": [0, 0, 0], "pipeline.model.2.n_layers": 3, "pipeline.model.2.input_skips": [2],
        "pipeline.model.2.n_hidden_neurons_xyz": 32, "pipeline.model.2.n_hidden_neurons_dir": 16,
        **{f"pipeline.model.{i}.{k}": v for i in (0, 1) for k, v in (("n_layers", 2), ("hidden_dim", 16))}})
    cfg.dump(str(tmp_path / "flagship.yml"))
    paths = chip_smoke.distributed_phase(torch, K1, K3, "cpu", scene, tmp_path / "runs", tmp_path / "flagship.yml",
                                         steps=8)
    assert set(paths) == {"distributed_train_fused"}
    assert not parallel.is_dist_avail_and_initialized()  # the phase leaves no group behind
