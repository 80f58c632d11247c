"""yanerf_tpu_torch imports neither JAX nor yanerf_tpu.

The port must install and run without the JAX package. Note the prefix:
``yanerf_tpu_torch`` starts with ``yanerf_tpu``, so the checks match
``yanerf_tpu`` only when it is not followed by ``_torch``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "yanerf_tpu_torch"
FORBIDDEN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|yanerf_tpu(?!_torch))\b", re.MULTILINE)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_port_module_leaves_jax_and_yanerf_tpu_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import yanerf_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(yanerf_tpu_torch.__path__, 'yanerf_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yanerf_tpu'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_port_source_imports_jax_or_yanerf_tpu():
    offenders = [
        f"{path.relative_to(REPO)}: {m.group(0).strip()}"
        for path in _port_sources()
        for m in FORBIDDEN_IMPORT.finditer(path.read_text())
    ]
    assert not offenders, offenders


def test_the_walk_reaches_the_parallel_layer_and_the_diagnostics():
    import pkgutil

    import yanerf_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(yanerf_tpu_torch.__path__, "yanerf_tpu_torch.")}
    assert {"yanerf_tpu_torch.parallel.distributed", "yanerf_tpu_torch.parallel.mesh",
            "yanerf_tpu_torch.parallel.sharding", "yanerf_tpu_torch.trajectory"} <= names
    scanned = {str(path.relative_to(REPO)) for path in _port_sources()}
    assert {"yanerf_tpu_torch/parallel/sharding.py", "yanerf_tpu_torch/trajectory.py", "chip_smoke.py"} <= scanned


def test_the_scan_tells_the_packages_apart():
    assert FORBIDDEN_IMPORT.search("from yanerf_tpu.ops import rays")
    assert FORBIDDEN_IMPORT.search("import jax.numpy as jnp")
    assert FORBIDDEN_IMPORT.search("    from yanerf_tpu import utils")
    assert not FORBIDDEN_IMPORT.search("from yanerf_tpu_torch.ops import rays")
    assert not FORBIDDEN_IMPORT.search("import yanerf_tpu_torch")


FORBIDDEN_IMAGING = re.compile(r"^\s*(?:import|from)\s+(?:PIL|cv2)\b", re.MULTILINE)


def test_the_port_needs_no_imaging_package():
    """PNGs are decoded and encoded with zlib and numpy (utils/images.py): the card machine has no PIL or cv2."""
    offenders = [
        f"{path.relative_to(REPO)}: {m.group(0).strip()}"
        for path in _port_sources()
        for m in FORBIDDEN_IMAGING.finditer(path.read_text())
    ]
    assert not offenders, offenders
    code = (
        "import importlib, pkgutil, sys\n"
        "import yanerf_tpu_torch\n"
        "for m in pkgutil.walk_packages(yanerf_tpu_torch.__path__, 'yanerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


IMAGING_HEADER = re.compile(r'^\s*#\s*include\s*[<"](?:jpeglib\.h|turbojpeg\.h|png\.h|opencv2/[^>"]*)[>"]', re.MULTILINE)


def test_the_native_sources_link_no_imaging_library():
    """The JPEG decoder is the port's own (native/src/jpeg.cpp): no libjpeg, libpng or OpenCV header or library."""
    from yanerf_tpu_torch.ops.kernels._build import GXX_FLAGS, NVCC_FLAGS

    sources = [p for ext in ("*.cpp", "*.cu", "*.cuh", "*.h") for p in PORT.rglob(ext)]
    assert any(p.name == "jpeg.cpp" for p in sources)
    offenders = [f"{p.relative_to(REPO)}: {m.group(0).strip()}" for p in sources
                 for m in IMAGING_HEADER.finditer(p.read_text())]
    assert not offenders, offenders
    assert not [f for f in GXX_FLAGS + NVCC_FLAGS if f.startswith("-l") and f != "-lpthread"]
    assert IMAGING_HEADER.search("#include <jpeglib.h>") and IMAGING_HEADER.search('#include "png.h"')
