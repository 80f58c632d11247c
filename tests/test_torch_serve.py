"""yanerf_tpu_torch.serve: the port's HTTP render server end to end on the CPU.

The service serves a tiny two-level proposal pipeline (the structure of
configs/nerf/lego_proposal.yml) with the NeRF-MLP kernel switch on; on the
CPU the kernel's plain version runs. Its weights come from a JAX param
tree saved as the ``.npz`` that ``--checkpoint`` takes.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu_torch.convert import flatten_tree
from yanerf_tpu_torch.serve import create_server, service_from_config
from yanerf_tpu_torch.utils import Config

HW = 8
PIPELINE_CFG = dict(
    type="NeRFPipeline",
    chunk_size_grid=64,
    num_passes=3,
    output_rasterized_mc=False,
    loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
    model=[
        dict(type="ProposalMLP", n_layers=2, hidden_dim=16),
        dict(type="ProposalMLP", n_layers=2, hidden_dim=16),
        dict(type="NeRFMLP", n_layers=2, input_skips=[1], n_harmonic_functions_xyz=2,
             n_harmonic_functions_dir=1, n_hidden_neurons_xyz=16, n_hidden_neurons_dir=8, use_pallas=True),
    ],
    ray_sampler=dict(
        type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0,
        max_depth=3.0, n_pts_per_ray_training=4, n_pts_per_ray_evaluation=4,
        n_rays_per_image_sampled_from_mask=8,
    ),
    renderer=dict(
        type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=3,
        n_pts_per_ray_final_evaluation=3, n_pts_per_ray_intermediate_training=[3],
        n_pts_per_ray_intermediate_evaluation=[3], bg_color=[0.0, 0.0, 0.0],
    ),
    feature_extractor=[],
)


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    params = JAX_PIPELINES.build(dict(PIPELINE_CFG)).init(jax.random.PRNGKey(0))
    ckpt = tmp_path_factory.mktemp("ckpt") / "params.npz"
    np.savez(ckpt, **flatten_tree(jax.tree_util.tree_map(np.asarray, params)))
    cfg = Config({"pipeline": PIPELINE_CFG, "serve": {"default_focal": 10.0}})
    return service_from_config(cfg, checkpoint=str(ckpt), device="cpu")


@pytest.fixture(scope="module")
def server_url(service):
    server = create_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _get(url, timeout=120):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_checkpoint_weights_are_loaded(service):
    params = JAX_PIPELINES.build(dict(PIPELINE_CFG)).init(jax.random.PRNGKey(0))
    w = service._pipeline.implicit_functions[2].xyz_encoder.mlp[0].w.detach().numpy()
    np.testing.assert_array_equal(w, np.asarray(params["implicit_functions"][2]["xyz_encoder"]["mlp"][0]["w"]))


def test_health_and_spec(server_url):
    status, ctype, payload = _get(f"{server_url}/health")
    assert status == 200 and ctype == "application/json"
    assert json.loads(payload)["status"] == "ok"
    spec = json.loads(_get(f"{server_url}/spec")[2])
    assert spec["image_hw"] == [HW, HW]
    assert spec["default_bounds"] == [1.0, 3.0]
    assert spec["default_focal"] == 10.0 and spec["default_focal_source"] == "config:serve.default_focal"


@pytest.mark.parametrize("output", ["rgb", "depth"])
def test_orbit_render_returns_png(server_url, output):
    status, ctype, payload = _get(f"{server_url}/render?theta=30&phi=-25&radius=2&output={output}")
    assert status == 200 and ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(payload)))
    assert img.shape == ((HW, HW, 3) if output == "rgb" else (HW, HW))


def test_post_render_pose_and_json_format(server_url):
    pose = np.eye(4)
    pose[2, 3] = 2.0
    status, ctype, payload = _post(f"{server_url}/render", {"pose": pose.tolist(), "focal": 10.0, "format": "json"})
    assert status == 200 and ctype == "application/json"
    out = json.loads(payload)
    assert out["shape"] == [HW, HW, 3]
    assert np.all(np.isfinite(np.asarray(out["data"])))


def test_bad_requests(server_url):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(f"{server_url}/render", {"pose": [[1, 2], [3, 4]]})
    assert err.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(f"{server_url}/nope")
    assert err.value.code == 404


def test_trajectory_gif(server_url):
    status, ctype, payload = _get(f"{server_url}/trajectory?n=3&radius=2&phi=-30")
    assert status == 200 and ctype == "image/gif"
    gif = Image.open(io.BytesIO(payload))
    assert gif.size == (HW, HW)
    gif.seek(2)  # three frames present


def test_render_counter_advances(server_url):
    _get(f"{server_url}/render?theta=10")
    stats = json.loads(_get(f"{server_url}/health")[2])
    assert stats["renders"] >= 1 and stats["mean_render_s"] > 0


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: cuda is a valid device here")
    cfg = Config({"pipeline": PIPELINE_CFG})
    with pytest.raises(RuntimeError, match="cuda"):
        service_from_config(cfg, device="cuda")


def test_render_service_rejects_non_npz_checkpoints(tmp_path):
    """Besides an .npz and a reference .pth, only a checkpoint of the port's runner is read
    (tests/test_torch_runner.py)."""
    cfg = Config({"pipeline": PIPELINE_CFG})
    with pytest.raises(FileNotFoundError):
        service_from_config(cfg, checkpoint=str(tmp_path / "ckpts_-001"), device="cpu")
    torch.save({"model": {}}, tmp_path / "other.ckpt")
    with pytest.raises(KeyError, match="params"):
        service_from_config(cfg, checkpoint=str(tmp_path / "other.ckpt"), device="cpu")
    # a reference-layout .pth is read (tests/test_torch_checkpoint_io.py), and held to the pipeline's shapes
    torch.save({"model": {"implicit_functions.1._fn.density_layer.weight": torch.zeros(1, 7)}}, tmp_path / "x.pth")
    with pytest.raises(ValueError, match="shape mismatch at implicit_functions.1.density_layer.w"):
        service_from_config(cfg, checkpoint=str(tmp_path / "x.pth"), device="cpu")
