"""The port's own config and registry against yanerf_tpu's, on the repo's config files."""

import argparse
from pathlib import Path

import pytest

from yanerf_tpu.utils import Config as JaxConfig
from yanerf_tpu_torch.utils import Config, DictAction, Registry

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "configs" / "nerf").glob("*.yml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_configs_load_as_in_the_jax_package(path):
    assert Config.fromfile(str(path)).to_dict() == JaxConfig.fromfile(str(path)).to_dict()


def test_flagship_override_reaches_the_nerf_mlp():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    args = parser.parse_args(["--cfg_options", "pipeline.model.2.use_pallas=True", "pipeline.chunk_size_grid=65536"])
    cfg = Config.fromfile(str(Path(CONFIGS[0]).parent / "lego_proposal.yml"))
    cfg.merge_from_dict(args.cfg_options)
    model = cfg.pipeline.model
    assert [m.type for m in model] == ["ProposalMLP", "ProposalMLP", "NeRFMLP"]
    assert model[2].use_pallas is True and "use_pallas" not in model[0]
    assert cfg.pipeline.chunk_size_grid == 65536
    assert cfg.pipeline.renderer.type == "ProposalEmissionAbsorpsionRenderer"  # _delete_ replaced the base's
    with pytest.raises(KeyError):
        cfg.merge_from_dict({"pipeline.model.7.use_pallas": True})


def test_registry_builds_and_reports_unported_components():
    reg = Registry("things")

    @reg.register_module()
    class Thing:
        def __init__(self, size=1):
            self.size = size

    assert reg.build({"type": "Thing", "size": 3}).size == 3
    with pytest.raises(KeyError):
        reg.build({"type": "Other"})
    from yanerf_tpu_torch.datasets import DATASETS, MultiSceneBlenderDataset
    from yanerf_tpu_torch.utils.registry import register_not_ported

    # MultiSceneBlenderDataset is ported: the registry builds it (and its own error comes through)
    assert DATASETS.get("MultiSceneBlenderDataset") is MultiSceneBlenderDataset
    with pytest.raises(FileNotFoundError, match="MultiSceneBlenderDataset: No scene_"):
        DATASETS.build({"type": "MultiSceneBlenderDataset", "base_dir": "/nonexistent", "split": "train"})
    # a component a config names before the port has it says so when built
    register_not_ported(reg, ("Later",))
    with pytest.raises(NotImplementedError, match="Later is not ported"):
        reg.build({"type": "Later"})


def test_png_and_gif_encoders_round_trip_through_pil():
    import io

    import numpy as np
    from PIL import Image

    from yanerf_tpu_torch.utils.images import gif_bytes, png_bytes

    rng = np.random.RandomState(0)
    rgb = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    grey = (rng.rand(20, 30) * 255).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_bytes(rgb)))), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png_bytes(grey)))), grey)
    # noise fills the 4096-code LZW table (a clear code mid-stream); a ramp grows the code size
    frames = [(rng.rand(120, 160, 3) * 255).astype(np.uint8), np.tile(np.arange(160, dtype=np.uint8)[None, :, None], (120, 1, 3))]
    gif = Image.open(io.BytesIO(gif_bytes(frames, fps=10)))
    for k, f in enumerate(frames):
        gif.seek(k)
        f = f.astype(int)
        want = np.stack([(f[..., 0] >> 5) * 255 // 7, (f[..., 1] >> 5) * 255 // 7, (f[..., 2] >> 6) * 255 // 3], -1)
        np.testing.assert_array_equal(np.asarray(gif.convert("RGB")), want)


PORT_THIRD_PARTY = '''
from yanerf_tpu_torch.models import MODELS
from yanerf_tpu_torch.models.nerf_mlp import NeRFMLP


@MODELS.register_module()
class PortThirdPartyNeRF(NeRFMLP):
    """Registered by a config's custom_imports alone."""
'''


def test_custom_imports_register_a_component_from_the_config_alone(tmp_path, monkeypatch):
    """tests/test_custom_imports.py's cases against the port (``misc.import_modules_from_strings``)."""
    import sys
    import warnings

    from yanerf_tpu_torch.models import MODELS

    pkg = tmp_path / "port_thirdparty_pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "models.py").write_text(PORT_THIRD_PARTY)
    monkeypatch.syspath_prepend(str(tmp_path))
    cfg_path = tmp_path / "cfg.yml"
    cfg_path.write_text("custom_imports: { imports: [port_thirdparty_pkg.models], allow_failed_imports: false }\n"
                        "model: { type: PortThirdPartyNeRF, n_layers: 2 }\n")
    assert "PortThirdPartyNeRF" not in MODELS
    try:
        assert Config.fromfile(cfg_path).model.type == "PortThirdPartyNeRF" and "PortThirdPartyNeRF" in MODELS
    finally:
        MODELS._module_dict.pop("PortThirdPartyNeRF", None)
        sys.modules.pop("port_thirdparty_pkg.models", None)
        sys.modules.pop("port_thirdparty_pkg", None)

    missing = tmp_path / "missing.yml"
    missing.write_text("custom_imports: { imports: [no_such_pkg_anywhere], allow_failed_imports: false }\n")
    for config in (Config, JaxConfig):
        with pytest.raises(ImportError, match="no_such_pkg_anywhere"):
            config.fromfile(missing)
        config.fromfile(missing, import_custom_modules=False)  # the opt-out skips the imports
    allowed = tmp_path / "allowed.yml"
    allowed.write_text("custom_imports: { imports: no_such_pkg_anywhere, allow_failed_imports: true }\nx: 1\n")
    with pytest.warns(UserWarning, match="no_such_pkg_anywhere failed to import and is ignored"):
        assert Config.fromfile(allowed).x == 1
    empty = tmp_path / "empty.yml"
    empty.write_text("custom_imports: { imports: [] }\nx: 2\n")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert Config.fromfile(empty).to_dict() == JaxConfig.fromfile(empty).to_dict()
