"""Dataset helpers: counterpart of ``yanerf_tpu/datasets/utils.py``.

``load_image`` reads a PNG or a JPEG as float32 RGB in [0, 1]. The JAX
package decodes through ``yanerf_tpu/native`` (libpng / libjpeg) and falls
back to PIL; the port dispatches on the file's first bytes, PNG to the
numpy ``decode_png`` and JPEG to its own decoder in
``yanerf_tpu_torch/native``, with no imaging package and no fallback.
"""

from __future__ import annotations

from ..utils.images import load_image

__all__ = ["load_image"]
