"""Multi-scene latent conditioning in yanerf_tpu_torch against yanerf_tpu, on the CPU.

configs/nerf/synth_multiscene_latent.yml's path (and its control,
synth_multiscene_unconditioned.yml), held to the JAX package on the same
inputs, weights (``convert.py``) and draws:
  * ``concat_global_codes`` exactly, and both of its errors;
  * ``LearnedSceneEmbedding``: the gather, its errors, its init, its
    registration;
  * NeRFMLP (also with ``input_xyz=False``), ProposalMLP and MipNeRFMLP with
    ``latent_dim`` at f32 1e-5 and bf16 one ulp; the kernel switch on a
    latent NeRFMLP gives the eager numbers and launches nothing, as the JAX
    package's rule (``use_pallas and input_xyz and latent_dim == 0``);
  * ``MultiSceneBlenderDataset`` array-equal to the JAX dataset (unequal
    scenes, ``n_scenes``, the empty directory); ``synth_multiscene.py``
    writes the scenes of ``scripts/make_synth_multiscene.py``;
  * ``scene_id`` through the host loader and the device cache, not quantized;
  * one train step of the latent config at narrow widths against
    ``make_train_step`` (objective 1e-5, every gradient, the codes', at
    rtol 2e-4 / atol 2e-5), three fused steps at batch 4 against
    ``make_train_step_fused``, an eval frame per scene at 1e-4, and one step
    of the control;
  * the ``*iters*`` rescale against ``scripts/run.py``'s; a strict load of a
    JAX tree with a non-empty ``feature_extractors``; the CLI trains both
    configs on a 2-scene 16x16 dataset and its checkpoint reloads with the
    codes; serving a latent config without a ``scene_id`` raises the
    extractor's own error.
"""

import json
import logging
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_classic import F32_GRAD_TOL
from test_torch_models import TOLS
from test_torch_train import _capture_draws
from yanerf_tpu.datasets import MultiSceneBlenderDataset as JaxMultiSceneBlenderDataset
from yanerf_tpu.models import MODELS as JAX_MODELS
from yanerf_tpu.models import layers as jax_layers
from yanerf_tpu.ops.structures import EvaluationMode as JaxEvaluationMode
from yanerf_tpu.pipelines import FEATURE_EXTRACTORS as JAX_FEATURE_EXTRACTORS
from yanerf_tpu.pipelines import PIPELINES as JAX_PIPELINES
from yanerf_tpu.runners import apis as jax_apis
from yanerf_tpu.runners import optim as jax_optim
from yanerf_tpu_torch import run as port_run
from yanerf_tpu_torch.convert import flatten_tree, load_jax_params
from yanerf_tpu_torch.datasets import (
    DATASETS,
    DeviceCachedLoader,
    MultiSceneBlenderDataset,
    MultiSceneBlenderWrapper,
    create_loader,
    create_sampler,
    stack_batch,
)
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.models.layers import concat_global_codes
from yanerf_tpu_torch.ops.kernels import fused_mlp
from yanerf_tpu_torch.ops.kernels import nerf_mlp_fwd as K1
from yanerf_tpu_torch.ops.structures import EvaluationMode
from yanerf_tpu_torch.pipelines import FEATURE_EXTRACTORS, PIPELINES, LearnedSceneEmbedding
from yanerf_tpu_torch.runners import (
    TrainState,
    apis,
    checkpoint_params_tree,
    create_optimizer,
    load_checkpoint,
    make_train_step,
    make_train_step_fused,
)
from yanerf_tpu_torch.serve import CAM_CALIBRATION, orbit_pose, service_from_config
from yanerf_tpu_torch.synth_multiscene import write_multiscene
from yanerf_tpu_torch.utils import Config
from yanerf_tpu_torch.utils.images import load_image_u8

REPO = Path(__file__).resolve().parent.parent
HW = 8
LATENT = 4
N_SCENES = 3
@pytest.fixture(autouse=True)
def one_torch_thread():
    """Every test here runs torch ops on tensors of a few thousand elements: one thread each, so that the
    suite's parallel workers do not oversubscribe the cores (the intra-op pool's barriers then dominate)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RUNNER = dict(
    init_lr=5e-3, min_lr=5e-4, lr_decay_type="exponential", lr_decay_rate=0.1, lr_decay_iters=1000,
    warmup_steps=0, warmup_lr=1e-5, weight_decay=1e-3, num_iters=100,
    lr_param_groups=[dict(prefix="feature_extractors", base=2.0)],
)


# --- concat_global_codes and the extractor ---------------------------------------------


@pytest.mark.parametrize("embeds_shape", [(2, 5, 7), (2, 3, 1, 4, 6), (2, 0)], ids=["rays", "grid", "no_xyz"])
@pytest.mark.parametrize("codes_shape", [(2, 6), (2, 2, 3)], ids=["flat", "stacked"])
def test_concat_global_codes_matches_jax_exactly(embeds_shape, codes_shape):
    rng = np.random.RandomState(0)
    embeds = rng.randn(*embeds_shape).astype(np.float32)
    codes = rng.randn(*codes_shape).astype(np.float32)
    ref = jax_layers.concat_global_codes(jnp.asarray(embeds), jnp.asarray(codes), 6)
    got = concat_global_codes(torch.from_numpy(embeds), torch.from_numpy(codes), 6)
    assert tuple(got.shape) == ref.shape == (*embeds_shape[:-1], embeds_shape[-1] + 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # cast to the embedding's dtype
    half = concat_global_codes(torch.from_numpy(embeds).to(torch.bfloat16), torch.from_numpy(codes), 6)
    assert half.dtype == torch.bfloat16
    # no codes: the embedding as it is, exactly when latent_dim is 0
    assert concat_global_codes(torch.from_numpy(embeds), None, 0) is not None
    for fn, e, c in ((jax_layers.concat_global_codes, jnp.asarray(embeds), jnp.asarray(codes)),
                     (concat_global_codes, torch.from_numpy(embeds), torch.from_numpy(codes))):
        with pytest.raises(ValueError, match=r"^latent_dim > 0 requires global_codes$"):
            fn(e, None, 6)
        with pytest.raises(ValueError, match=r"^global_codes dim 6 is incompatible with latent_dim 5$"):
            fn(e, c, 5)


def test_learned_scene_embedding_gathers_and_validates_as_jax():
    jax_fe = JAX_FEATURE_EXTRACTORS.build(dict(type="LearnedSceneEmbedding", n_scenes=3, latent_dim=4))
    params = jax_fe.init(jax.random.PRNGKey(0))
    fe = FEATURE_EXTRACTORS.build(dict(type="LearnedSceneEmbedding", n_scenes=3, latent_dim=4))
    assert isinstance(fe, LearnedSceneEmbedding) and tuple(fe.codes.shape) == (3, 4)
    load_jax_params(fe, jax.tree_util.tree_map(np.asarray, params))
    ids = np.asarray([2, 0, 2], np.int32)
    ref = jax_fe.apply(params, scene_id=jnp.asarray(ids), poses=None)
    out = fe(scene_id=torch.from_numpy(ids), poses=None)
    assert list(out) == list(ref) == ["global_codes"]  # nothing else reaches the models
    np.testing.assert_array_equal(out["global_codes"].detach().numpy(), np.asarray(ref["global_codes"]))
    # a (B, 1) id and an int64 id gather the same rows
    np.testing.assert_array_equal(fe(scene_id=torch.tensor([[2], [0]]))["global_codes"].detach().numpy(),
                                  np.asarray(params["codes"])[[2, 0]])
    with pytest.raises(ValueError, match="scene_id") as port_err:
        fe()
    with pytest.raises(ValueError, match="scene_id") as jax_err:
        jax_fe.apply(params)
    assert str(port_err.value) == str(jax_err.value)
    for bad in (dict(n_scenes=0, latent_dim=4), dict(n_scenes=3, latent_dim=0)):
        with pytest.raises(ValueError, match="must be positive"):
            FEATURE_EXTRACTORS.build(dict(type="LearnedSceneEmbedding", **bad))
    # N(0, init_scale^2) from the builder's generator, drawn the same twice
    big = FEATURE_EXTRACTORS.build(dict(type="LearnedSceneEmbedding", n_scenes=64, latent_dim=64, init_scale=0.5,
                                        generator=torch.Generator().manual_seed(3)))
    again = FEATURE_EXTRACTORS.build(dict(type="LearnedSceneEmbedding", n_scenes=64, latent_dim=64, init_scale=0.5,
                                          generator=torch.Generator().manual_seed(3)))
    assert torch.equal(big.codes, again.codes)
    codes = big.codes.detach()
    assert abs(float(codes.std()) - 0.5) < 0.02 and abs(float(codes.mean())) < 0.02


# --- the models ------------------------------------------------------------------------

NERF = dict(type="NeRFMLP", n_layers=3, input_skips=[2], n_harmonic_functions_xyz=3, n_harmonic_functions_dir=2,
            n_hidden_neurons_xyz=32, n_hidden_neurons_dir=16, latent_dim=LATENT)
MODEL_CFGS = {
    "nerf_mlp": NERF,
    "nerf_mlp_no_xyz": dict(NERF, input_xyz=False),
    "proposal_mlp": dict(type="ProposalMLP", n_layers=2, hidden_dim=16, n_harmonic_functions_xyz=3, latent_dim=LATENT),
    "mip_nerf_mlp": dict(NERF, type="MipNeRFMLP", base_radius=1e-2),
}


def _inputs(seed=0, batch=2, n_rays=4, n_pts=6):
    rng = np.random.RandomState(seed)
    origins = rng.randn(batch, n_rays, 1, 3).astype(np.float32)
    directions = rng.randn(batch, n_rays, 1, 3).astype(np.float32)
    lengths = np.sort(rng.uniform(1, 4, (batch, n_rays, 1, n_pts)), axis=-1).astype(np.float32)
    codes = rng.randn(batch, 1, LATENT).astype(np.float32)  # the pipeline's stacked (B, 1, D)
    return origins, directions, lengths, codes


def _pair(cfg, seed=0):
    jax_model = JAX_MODELS.build(dict(cfg))
    params = jax_model.init(jax.random.PRNGKey(seed))
    model = load_jax_params(MODELS.build(dict(cfg)), jax.tree_util.tree_map(np.asarray, params))
    return jax_model, params, model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_latent_models_match_apply(name, compute_dtype):
    cfg = dict(MODEL_CFGS[name], compute_dtype=compute_dtype)
    jax_model, params, model = _pair(cfg)
    assert model.input_dim == jax_model.input_dim
    o, d, l, c = _inputs()
    ref = jax_model.apply(params, *map(jnp.asarray, (o, d, l)), global_codes=jnp.asarray(c))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (o, d, l)), global_codes=torch.from_numpy(c))
    for key in ("rays_densities", "rays_features"):
        assert got[key].shape == ref[key].shape and got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), **TOLS[compute_dtype], err_msg=key)
    # the codes matter: other codes, other densities
    with torch.no_grad():
        other = model(*map(torch.from_numpy, (o, d, l)), global_codes=torch.from_numpy(c[::-1].copy()))
    assert float((other["rays_densities"] - got["rays_densities"]).abs().max()) > 1e-6
    # the JAX package's refusals, word for word
    for codes in (None, np.zeros((2, 3), np.float32)):
        with pytest.raises(ValueError) as jax_err:
            jax_model.apply(params, *map(jnp.asarray, (o, d, l)),
                            global_codes=None if codes is None else jnp.asarray(codes))
        with pytest.raises(ValueError) as port_err:
            model(*map(torch.from_numpy, (o, d, l)), global_codes=None if codes is None else torch.from_numpy(codes))
        assert str(port_err.value) == str(jax_err.value)


def test_nerf_mlp_without_xyz_needs_a_latent_and_widths_follow_jax():
    for mod in (MODELS, JAX_MODELS):
        with pytest.raises(ValueError, match="latent dimension has to be > 0"):
            mod.build(dict(NERF, input_xyz=False, latent_dim=0))
    for cfg in (NERF, dict(NERF, input_xyz=False), MODEL_CFGS["proposal_mlp"]):
        model, jax_model = MODELS.build(dict(cfg)), JAX_MODELS.build(dict(cfg))
        ref = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_model.init(jax.random.PRNGKey(0))))
        assert {k: tuple(p.shape) for k, p in model.named_parameters()} == {k: v.shape for k, v in ref.items()}
    # the skip layer takes the embedding and the codes again
    assert MODELS.build(dict(NERF)).xyz_encoder.mlp[2].in_features == 32 + 3 * 2 * 3 + 3 + LATENT


def test_the_kernel_switch_on_a_latent_nerf_mlp_runs_the_eager_path(monkeypatch):
    """``use_pallas and input_xyz and latent_dim == 0`` (yanerf_tpu/models/nerf_mlp.py:183): a latent NeRFMLP with
    the switch on gives the eager numbers bit for bit and never reaches the fused function."""
    _, _, model = _pair(dict(NERF, use_pallas=True, use_pallas_train=True))
    o, d, l, c = map(torch.from_numpy, _inputs(seed=1))
    eager = model(o, d, l, global_codes=c, use_pallas=False)

    def refused(*args, **kwargs):
        raise AssertionError("the fused function ran on a latent NeRFMLP")

    monkeypatch.setattr("yanerf_tpu_torch.models.nerf_mlp.fused_nerf_mlp", refused)
    for switch in (None, True):
        out = model(o, d, l, global_codes=c, use_pallas=switch)
        assert torch.equal(out["rays_densities"], eager["rays_densities"])
        assert torch.equal(out["rays_features"], eager["rays_features"])
    # the kernel's own entry still refuses a latent model
    with pytest.raises(NotImplementedError, match="standard xyz\\+dir"):
        model.packed_weights()
    # on an unconditioned model the switch takes the fused function, and codes are refused as in JAX
    monkeypatch.setattr("yanerf_tpu_torch.models.nerf_mlp.fused_nerf_mlp", fused_mlp.fused_nerf_mlp)
    plain = MODELS.build(dict(NERF, latent_dim=0, use_pallas=True))
    jax_plain = JAX_MODELS.build(dict(NERF, latent_dim=0))
    with pytest.raises(ValueError, match="incompatible with latent_dim 0") as port_err:
        plain(o, d, l, global_codes=c)
    params = jax_plain.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as jax_err:
        jax_plain.apply(params, *(jnp.asarray(t.numpy()) for t in (o, d, l)), global_codes=jnp.asarray(c.numpy()),
                        use_pallas=True)
    assert str(port_err.value) == str(jax_err.value)


def test_proposal_mlp_latent_conditioning_contract():
    """tests/test_latent.py's ProposalMLP case on the port: codes move the densities; refusals as in JAX."""
    m = MODELS.build(dict(type="ProposalMLP", n_layers=2, hidden_dim=32, n_harmonic_functions_xyz=4, latent_dim=6))
    o = torch.zeros(2, 8, 1, 3)
    d = torch.cat([torch.zeros(2, 8, 1, 2), torch.ones(2, 8, 1, 1)], dim=-1)
    t = torch.linspace(2.0, 6.0, 5).expand(2, 8, 1, 5)
    with torch.no_grad():
        out_a = m(o, d, t, global_codes=torch.tensor([[1.0] * 6, [0.0] * 6]))
        out_b = m(o, d, t, global_codes=torch.tensor([[0.0] * 6, [1.0] * 6]))
    assert tuple(out_a["rays_densities"].shape) == (2, 8, 1, 5, 1)
    assert float((out_a["rays_densities"] - out_b["rays_densities"]).abs().max()) > 1e-6
    with pytest.raises(ValueError, match="incompatible"):
        m(o, d, t, global_codes=torch.zeros(2, 3))
    with pytest.raises(ValueError, match="requires global_codes"):
        m(o, d, t)
    m0 = MODELS.build(dict(type="ProposalMLP", n_layers=2, hidden_dim=32, n_harmonic_functions_xyz=4))
    with pytest.raises(ValueError):
        m0(o, d, t, global_codes=torch.zeros(2, 6))


# --- the data --------------------------------------------------------------------------


@pytest.fixture
def multiscene(tmp_path):
    """Three 16x16 scenes, the last with fewer train frames (scenes of unequal length)."""
    root = write_multiscene(tmp_path / "multiscene", n_scenes=3, hw=16, n_train=3, n_val=2, n_test=2, n_spheres=3,
                            seed=1)
    meta = json.loads((root / "scene_2" / "transforms_train.json").read_text())
    meta["frames"] = meta["frames"][:1]
    (root / "scene_2" / "transforms_train.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("split,options", [("train", {}), ("train", {"n_scenes": 2}), ("val", {"test_skip": 2}),
                                           ("test", {"test_skip": 1})])
def test_multiscene_dataset_matches_jax(multiscene, split, options):
    ref = JaxMultiSceneBlenderDataset(str(multiscene), split, **options)
    got = DATASETS.build(dict(type="MultiSceneBlenderDataset", base_dir=str(multiscene), split=split, **options))
    assert isinstance(got, MultiSceneBlenderDataset) and got.data_wrapper is MultiSceneBlenderWrapper
    assert got.n_scenes == ref.n_scenes and len(got) == len(ref)
    for i in range(len(ref)):
        for a, b in zip(got[i], ref[i]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    if split == "train" and not options:
        assert [int(got[i][3]) for i in range(len(got))] == [0, 0, 0, 1, 1, 1, 2]
        assert got[6][3].dtype == np.int32 and got[6][3].shape == ()


def test_multiscene_dataset_refuses_an_empty_directory_as_jax(tmp_path):
    (tmp_path / "empty").mkdir()
    for cls in (JaxMultiSceneBlenderDataset, MultiSceneBlenderDataset):
        with pytest.raises(FileNotFoundError, match="No scene_"):
            cls(str(tmp_path / "empty"), "train")
        with pytest.raises(FileNotFoundError):
            cls(str(tmp_path / "nope"), "train")


def test_synth_multiscene_writes_the_scenes_of_make_synth_multiscene(tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import make_synth_multiscene
    finally:
        sys.path.remove(str(REPO / "scripts"))
    args = ["--n_scenes", "2", "--hw", "12", "--n_train", "3", "--n_val", "1", "--n_test", "2", "--n_spheres", "3",
            "--radius", "3.5", "--seed", "4"]
    monkeypatch.setattr(sys, "argv", ["make_synth_multiscene.py", "--out_dir", str(tmp_path / "ref"), *args])
    make_synth_multiscene.main()
    from yanerf_tpu_torch import synth_multiscene

    synth_multiscene.main(["--out_dir", str(tmp_path / "port"), *args])
    for k in range(2):
        for split, count in (("train", 3), ("val", 1), ("test", 2)):
            name = f"scene_{k}/transforms_{split}.json"
            assert json.loads((tmp_path / "port" / name).read_text()) == json.loads((tmp_path / "ref" / name).read_text())
            for i in range(count):
                with Image.open(tmp_path / "ref" / f"scene_{k}" / f"r_{split}_{i}.png") as im:
                    ref = np.array(im.convert("RGB"))
                np.testing.assert_array_equal(load_image_u8(tmp_path / "port" / f"scene_{k}" / f"r_{split}_{i}.png"),
                                              ref)


@pytest.mark.parametrize("quantize", [False, True])
def test_scene_id_goes_through_both_loaders_unquantized(multiscene, quantize):
    dataset = MultiSceneBlenderDataset(str(multiscene), "train")
    items = [dataset[i] for i in (0, 4, 6)]
    stacked = stack_batch(items)
    assert stacked[3].dtype == np.int32 and stacked[3].tolist() == [0, 1, 2]
    loader = create_loader(dataset, create_sampler(dataset, shuffle=False), batch_size=3, num_workers=0,
                           is_train=False)
    host = [dataset.data_wrapper(*b) for b in loader]
    cached = DeviceCachedLoader(loader, "cpu", quantize_images=quantize)
    assert cached._ensure_cache()
    arrays = cached._arrays
    assert arrays[2].dtype == (torch.uint8 if quantize else torch.float32)
    assert arrays[3].dtype == torch.int32 and arrays[3].tolist() == [0, 0, 0, 1, 1, 1, 2]
    assert cached._maybe_quantize(np.asarray(2, np.int32)).dtype == np.int32
    for ref, got in zip(host, (dataset.data_wrapper(*b) for b in cached)):
        assert got.scene_id.dtype == torch.int32
        np.testing.assert_array_equal(got.scene_id.numpy(), ref.scene_id)
        np.testing.assert_array_equal(got.image_rgb.numpy(), ref.image_rgb)
    # the fused step's gather
    batch = apis._gather_batch(arrays, dataset.data_wrapper, torch.tensor([6, 0]))
    assert batch["scene_id"].dtype == torch.int32 and batch["scene_id"].tolist() == [2, 0]


# --- the latent config's structure: a step, three fused steps, an eval frame ---------------


def latent_cfg(latent_dim=LATENT, compute_dtype="float32"):
    """synth_multiscene_latent.yml at tiny widths: three conditioned models, the scene embedding, pixels with
    replacement, the NeRF-MLP's kernel switch on (the latent rule sends it down the eager path)."""
    extra = dict(latent_dim=latent_dim, compute_dtype=compute_dtype)
    return dict(
        type="NeRFPipeline", chunk_size_grid=42, num_passes=3, output_rasterized_mc=False,
        loss_weights={"loss_rgb_mse": 1.0, "loss_proposal": 1.0},
        model=[
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, **extra),
            dict(type="ProposalMLP", n_layers=2, hidden_dim=16, **extra),
            dict(NERF, use_pallas_train=True, **extra),
        ],
        ray_sampler=dict(
            type="RaySampler", image_height=HW, image_width=HW, min_depth=1.0, max_depth=3.0,
            n_pts_per_ray_training=5, n_pts_per_ray_evaluation=6, n_rays_per_image_sampled_from_mask=12,
            pixel_replacement=True,
        ),
        renderer=dict(
            type="ProposalEmissionAbsorpsionRenderer", n_pts_per_ray_final_training=4,
            n_pts_per_ray_final_evaluation=5, n_pts_per_ray_intermediate_training=[6],
            n_pts_per_ray_intermediate_evaluation=[6], bg_color=[0.0, 0.0, 0.0],
            density_noise_std_train=0.0, background_density_bias=1e-6,
        ),
        feature_extractor=([dict(type="LearnedSceneEmbedding", n_scenes=N_SCENES, latent_dim=latent_dim)]
                           if latent_dim else []),
    )


def _arrays(n=4, seed=0):
    rng = np.random.RandomState(seed)
    poses = np.stack([orbit_pose(30.0 + 40 * i, -30.0, 2.0) @ CAM_CALIBRATION for i in range(n)]).astype(np.float32)
    return (poses, np.full((n, 1), 10.0, np.float32), rng.rand(n, HW, HW, 3).astype(np.float32),
            (np.arange(n) % N_SCENES).astype(np.int32))


def _params(jax_pipeline, seed):
    params = jax_pipeline.init(jax.random.PRNGKey(seed))
    # every ray carries mass: on an empty ray the refined depths differ by ~1e-3 between the packages
    # (ROADMAP.md Queue 3, "Noted, not faults"); the codes at unit scale, so that they move the outputs
    for fn in params["implicit_functions"]:
        fn["density_layer"]["b"] = fn["density_layer"]["b"] + 1.0
    if params["feature_extractors"]:
        params["feature_extractors"][0]["codes"] = params["feature_extractors"][0]["codes"] * 100.0
    return params


def _port(cfg, params):
    pipeline = PIPELINES.build(dict(cfg), device="cpu")
    return load_jax_params(pipeline, jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("latent_dim", [LATENT, 0], ids=["latent", "control"])
def test_train_step_matches_jax_make_train_step(monkeypatch, latent_dim):
    """Batch 2 of two scenes; the control config (no extractor, scene_id ignored) on the fused function."""
    cfg = latent_cfg(latent_dim)
    batch = {k: v[:2] for k, v in zip(MultiSceneBlenderWrapper._fields, _arrays(seed=1))}
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _params(jax_pipeline, 2)
    tx = jax_optim.create_optimizer(RUNNER, params)
    rng = jax.random.PRNGKey(11)
    jax_batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        preds = jax_pipeline.forward(p, jax.random.fold_in(rng, 0), evaluation_mode=JaxEvaluationMode.TRAINING,
                                     output_rasterized_mc=False, **jax_batch)
        return jnp.mean(preds["objective"])

    with monkeypatch.context() as m:
        draws = _capture_draws(m)
        ref_grads = flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(params)))
    _, ref_preds = jax_apis.make_train_step(jax_pipeline, tx, donate=False)(
        jax_optim.create_train_state(params, tx), jax_batch, rng)
    if latent_dim:
        assert np.abs(ref_grads["feature_extractors.0.codes"]).max() > 10 * F32_GRAD_TOL["atol"]
        assert not np.abs(ref_grads["feature_extractors.0.codes"][2]).any()  # no frame of scene 2 in the batch

    pipeline = _port(cfg, params)
    calls, k1 = [], K1.nerf_mlp_fwd
    monkeypatch.setattr(K1, "nerf_mlp_fwd", lambda *a, **kw: calls.append(1) or k1(*a, **kw))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(RUNNER, pipeline), step=0)
    preds = make_train_step(pipeline, RUNNER, seed=0)(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                      draws=draws)
    assert len(calls) == (0 if latent_dim else 1)  # the JAX rule: no kernel on a latent NeRFMLP
    np.testing.assert_allclose(preds["objective"].numpy(), np.asarray(ref_preds["objective"]), rtol=1e-5, atol=1e-5)
    named = dict(pipeline.named_parameters())
    assert set(named) == set(ref_grads)
    for key, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[key], err_msg=key, **F32_GRAD_TOL)
    if latent_dim:  # the codes: an Adam parameter of their own prefix group, as lr_param_groups names them
        group = next(g for g in state.optimizer.param_groups if any(p is named["feature_extractors.0.codes"]
                                                                      for p in g["params"]))
        assert len(group["params"]) == 1 and group["init_lr"] == 2.0 * RUNNER["init_lr"]



def test_latent_fused_dispatch_matches_jax_make_train_step_fused(monkeypatch):
    """Three steps at batch 4 (scenes 0, 1, 2, 0 and others) at steps_per_call 3, the JAX draws fed in through the
    static buffers; scene_id gathered at the device counter like every field. Adam moves every row of the codes,
    the rows of scenes not in a batch too (zero gradient, decaying moments), as optax does."""
    cfg = latent_cfg()
    runner = dict(RUNNER, steps_per_call=3)
    arrays = _arrays(6, seed=5)
    idx = np.array([[0, 1, 3, 4], [5, 2, 0, 3], [1, 1, 4, 4]])
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _params(jax_pipeline, 1)
    tx = jax_optim.create_optimizer(runner, params)
    rng = jax.random.PRNGKey(11)
    jax_arrays = tuple(jnp.asarray(a) for a in arrays)

    step = jax_apis.make_train_step(jax_pipeline, tx, donate=False)
    state = jax_optim.create_train_state(params, tx)
    draws, grads, per_step_params = [], [], []
    for k in range(3):
        batch = {key: a[idx[k]] for key, a in zip(MultiSceneBlenderWrapper._fields, jax_arrays)}

        def loss_fn(p, batch=batch, k=k):
            preds = jax_pipeline.forward(p, jax.random.fold_in(rng, k), evaluation_mode=JaxEvaluationMode.TRAINING,
                                         output_rasterized_mc=False, **batch)
            return jnp.mean(preds["objective"])

        per_step_params.append(flatten_tree(jax.tree_util.tree_map(np.asarray, state.params)))
        with monkeypatch.context() as m:
            draws.append(_capture_draws(m))
            grads.append(flatten_tree(jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(state.params))))
        state, _ = step(state, batch, rng)
    assert not grads[2]["feature_extractors.0.codes"][2].any()  # step 3 has no frame of scene 2

    fused = jax_apis.make_train_step_fused(jax_pipeline, tx, MultiSceneBlenderWrapper, donate=False)
    ref_state, ref_hist = fused(jax_optim.create_train_state(params, tx), jax_arrays, jnp.asarray(idx), rng)
    ref_params = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_state.params))

    pipeline = _port(cfg, params)
    port = TrainState(pipeline=pipeline, optimizer=create_optimizer(runner, pipeline), step=0)

    def fed_draws(pipeline, batch_size, seed, step, out=None):
        for key, value in draws[step].items():
            targets = out[key] if isinstance(out[key], list) else [out[key]]
            for target, v in zip(targets, value if isinstance(value, list) else [value]):
                target.copy_(v)
        return out

    monkeypatch.setattr(apis, "make_step_draws", fed_draws)
    trainer = make_train_step_fused(pipeline, runner, 0, MultiSceneBlenderWrapper)
    codes_before = pipeline.feature_extractors[0].codes.detach().clone()
    hist = trainer(port, tuple(torch.from_numpy(a) for a in arrays), idx)
    assert port.step == 3 and trainer.dispatches == 1
    np.testing.assert_allclose(hist["objective"].numpy(), np.asarray(ref_hist["objective"]), rtol=1e-5, atol=1e-5)
    lr = float(port.optimizer.param_groups[-1]["init_lr"])
    for key, p in pipeline.named_parameters():
        new, ref = p.detach().numpy(), ref_params[key]
        settled = np.all([np.abs(g[key] + RUNNER["weight_decay"] * w[key]) > F32_GRAD_TOL["atol"]
                          for g, w in zip(grads, per_step_params)], axis=0)
        np.testing.assert_allclose(new[settled], ref[settled], err_msg=key, **F32_GRAD_TOL)
        assert np.all(np.abs(new - ref) <= 2.0 * 3 * 2.0 * lr * (1 + 1e-5)), key
    codes = pipeline.feature_extractors[0].codes.detach()
    assert bool((codes != codes_before).all(dim=-1).all())  # every row moved
    np.testing.assert_allclose(codes.numpy(), ref_params["feature_extractors.0.codes"], **F32_GRAD_TOL)


def test_eval_frame_gives_each_scene_its_code_and_matches_jax():
    """One eval batch of 2 frames from scenes 2 and 0, chunked, at 1e-4; each frame equals the frame rendered
    alone with its own scene_id."""
    cfg = latent_cfg()
    arrays = _arrays(3, seed=3)
    batch = {k: v[[2, 0]] for k, v in zip(MultiSceneBlenderWrapper._fields, arrays)}
    assert batch["scene_id"].tolist() == [2, 0]
    jax_pipeline = JAX_PIPELINES.build(dict(cfg))
    params = _params(jax_pipeline, 0)
    ref = jax_pipeline.forward(params, jax.random.PRNGKey(1), evaluation_mode=JaxEvaluationMode.EVALUATION,
                               **{k: jnp.asarray(v) for k, v in batch.items()})
    pipeline = _port(cfg, params)
    with torch.no_grad():
        got = pipeline(evaluation_mode=EvaluationMode.EVALUATION, **{k: torch.from_numpy(v) for k, v in batch.items()})
        alone = [pipeline(evaluation_mode=EvaluationMode.EVALUATION,
                          **{k: torch.from_numpy(v[i : i + 1]) for k, v in batch.items()}) for i in range(2)]
        swapped = pipeline(evaluation_mode=EvaluationMode.EVALUATION,
                           **{k: torch.from_numpy(v[::-1].copy() if k == "scene_id" else v) for k, v in batch.items()})
    for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks", "objective"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4, err_msg=key)
    for i in range(2):
        np.testing.assert_allclose(got["rendered_images"][i].numpy(), alone[i]["rendered_images"][0].numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert float((swapped["rendered_images"] - got["rendered_images"]).abs().max()) > 1e-4


def test_a_jax_tree_with_scene_codes_loads_strictly_and_round_trips():
    cfg = latent_cfg()
    params = JAX_PIPELINES.build(dict(cfg)).init(jax.random.PRNGKey(4))
    assert len(params["feature_extractors"]) == 1
    pipeline = _port(cfg, params)
    np.testing.assert_array_equal(pipeline.feature_extractors[0].codes.detach().numpy(),
                                  np.asarray(params["feature_extractors"][0]["codes"]))
    tree = jax.tree_util.tree_map(np.asarray, params)
    del tree["feature_extractors"][0]["codes"]
    with pytest.raises(KeyError, match="feature_extractors.0.codes"):
        load_jax_params(PIPELINES.build(dict(cfg), device="cpu"), tree)


def test_iters_rescale_matches_scripts_run():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import run as jax_run
    finally:
        sys.path.remove(str(REPO / "scripts"))

    class Loader:  # 4 scenes of 30 train frames at batch 4: 30 batches
        batch_size = 4

        def __len__(self):
            return 30

    cfgs = [Config.fromfile(str(REPO / "configs" / "nerf" / "synth_multiscene_latent.yml")).runner for _ in range(2)]
    log = logging.getLogger("test_iters_rescale")
    jax_run.setup_iter_based_runner(cfgs[0], Loader(), 1, log)
    port_run.setup_iter_based_runner(cfgs[1], Loader(), log)
    assert dict(cfgs[1]) == dict(cfgs[0])
    assert cfgs[1]["num_iters"] == 12000 and cfgs[1]["lr_decay_iters"] == 14000 and cfgs[1]["val_per_epoch"] == 50


# --- the CLI and serving -----------------------------------------------------------------


def _tiny_multiscene_config(config: str, path: Path, data: Path, out: Path) -> Path:
    """``config`` at a 16x16 frame, 16 rays, narrow models, 2 scenes, 8 iterations (2 epochs of 1 fused step of
    batch 4 after the rescale), written to ``path``."""
    cfg = Config.fromfile(str(REPO / "configs" / "nerf" / config))
    opts = {"pipeline.ray_sampler.image_height": 16, "pipeline.ray_sampler.image_width": 16,
            "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask": 16, "pipeline.chunk_size_grid": 2048,
            "runner.num_iters": 8, "runner.output_dir": str(out), "runner.val_per_iter": 4,
            "runner.save_per_iter": 4, "runner.print_per_iter": 1, "runner.num_workers_list": [0, 0, 0],
            "runner.lr_decay_iters": 100, "runner.warmup_steps": 0,
            **{f"datasets.{i}.base_dir": str(data) for i in range(3)}}
    for i, model in enumerate(cfg.pipeline.model):
        key = f"pipeline.model.{i}"
        if model["type"] == "NeRFMLP":
            opts.update({f"{key}.n_layers": 3, f"{key}.input_skips": [2], f"{key}.n_hidden_neurons_xyz": 32,
                         f"{key}.n_hidden_neurons_dir": 16, f"{key}.use_pallas_train": True})
        else:
            opts.update({f"{key}.n_layers": 2, f"{key}.hidden_dim": 16})
    if cfg.pipeline.feature_extractor:
        opts["pipeline.feature_extractor.0.n_scenes"] = 2
    cfg.merge_from_dict(opts)
    cfg.dump(str(path))
    return path


@pytest.mark.parametrize("config", ["synth_multiscene_latent.yml", "synth_multiscene_unconditioned.yml"])
def test_run_trains_the_multiscene_configs_fused_and_the_checkpoint_reloads_the_codes(tmp_path, config):
    data = write_multiscene(tmp_path / "data", n_scenes=2, hw=16, n_train=3, n_val=1, n_test=1, n_spheres=3, seed=2)
    tiny = _tiny_multiscene_config(config, tmp_path / "tiny.yml", data, tmp_path / "results")
    result = port_run.main(["--config", str(tiny), "--device", "cpu"])
    state, out = result["state"], result["output_dir"]
    trainer = result["train_step_fused"]
    assert state.step == 2 and trainer.steps == 2 and trainer.dispatches == 2  # one batch of 4 of 6 frames, 2 epochs
    assert "fused path is ineligible" not in (out / "run.log").read_text()
    train = [json.loads(line) for line in (out / "train_stats.json").read_text().splitlines()]
    assert all(math.isfinite(r["train_objective"]) for r in train)
    assert all(math.isfinite(v) for v in result["test_stats"].values())
    latent = config == "synth_multiscene_latent.yml"
    assert [type(fe).__name__ for fe in state.pipeline.feature_extractors] == (["LearnedSceneEmbedding"] if latent
                                                                                else [])
    cfg = Config.fromfile(str(out / "config.yml"))
    fresh = PIPELINES.build(cfg.pipeline, device="cpu")
    reloaded = TrainState(pipeline=fresh, optimizer=create_optimizer(cfg.runner, fresh), step=0)
    load_checkpoint(result["checkpoint"], reloaded)
    assert reloaded.step == state.step
    for (k, p), q in zip(state.pipeline.named_parameters(), fresh.parameters()):
        assert torch.equal(p.detach(), q.detach()), k
    tree = checkpoint_params_tree(result["checkpoint"])
    if latent:
        np.testing.assert_array_equal(tree["feature_extractors"][0]["codes"],
                                      state.pipeline.feature_extractors[0].codes.detach().numpy())
        assert tree["feature_extractors"][0]["codes"].shape == (2, 16)
    else:
        assert tree["feature_extractors"] == []
    # serving: the control renders without a scene; a latent config raises the extractor's own error
    service = service_from_config(cfg, checkpoint=str(result["checkpoint"]), device="cpu")
    view = ((orbit_pose(30.0, -30.0, 4.0) @ CAM_CALIBRATION)[:3, :4].astype(np.float32), service.default_focal)
    if latent:
        with pytest.raises(ValueError, match="requires a scene_id"):
            service.render(*view)
    else:
        rgb, _ = service.render(*view)
        assert np.isfinite(rgb).all() and rgb.shape == (16, 16, 3)


@pytest.mark.parametrize("config,kernels", [("synth_multiscene_latent.yml", []),
                                            ("synth_multiscene_unconditioned.yml", ["nerf_mlp_fwd", "nerf_mlp_bwd"])])
def test_the_training_profiler_lists_the_kernels_a_multiscene_step_launches(config, kernels):
    """The switch is set on both configs' NeRFMLP; only the control's runs K1 / K3 (the JAX rule)."""
    from yanerf_tpu_torch.profile_training import training_config

    cfg, listed = training_config(str(REPO / "configs" / "nerf" / config))
    assert listed == kernels and cfg.pipeline.model[2].use_pallas_train is True
