"""The JPEG decoder's rate on the committed captures, on this machine's host CPU.

    python -m yanerf_tpu_torch.decode_rate [--repeats 5] [--against OTHER_CHECKOUT] [--out rates.json]

Each capture under ``tests/data`` (``llff_jpeg``: baseline JPEGs;
``llff_jpeg_progressive`` and ``llff_jpeg_arith``: the same 12 views at
1008x756 as progressive and as arithmetic-coded JPEGs) is decoded view by view with ``native.decode_image`` (one thread) and
at once with ``native.decode_batch`` (a ``std::thread`` per core); every
array is checked against the digest of the JAX package's decode committed
beside the capture. A time is the fastest of ``--repeats`` passes (the
median beside it), and within a pass the captures take turns, so the rates and their ratios to
the baseline capture's come from the same minutes of the same host. ``--against`` names another
checkout of the repository (say the parent commit, unpacked with ``git
archive``): its ``jpeg.cpp`` is built as well and each pass times the two
builds in turns (other, this, then this, other in the next pass) on every
capture the other build decodes. Prints one JSON object; ``--out`` writes
it to a file too. Needs no GPU, no JAX and no imaging package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import native
from .ops.kernels._build import HostLibrary

REPO = Path(__file__).resolve().parent.parent
CAPTURES = {"baseline": REPO / "tests" / "data" / "llff_jpeg",
            "progressive": REPO / "tests" / "data" / "llff_jpeg_progressive",
            "arith": REPO / "tests" / "data" / "llff_jpeg_arith"}


def _sha(img) -> str:
    return hashlib.sha256(img.tobytes()).hexdigest()


def measure(captures: Optional[Dict[str, Path]] = None, repeats: int = 3,
            libraries: Optional[Dict[str, HostLibrary]] = None) -> Dict[str, dict]:
    """Per build and capture: sizes, the fastest one-thread and batched seconds, megapixels/s and the digest
    checks. ``libraries`` maps a name to a decoder build (default: this checkout's, as ``"this"``); a capture a
    build refuses (``NotImplementedError``) is recorded as ``{"refused": message}``."""
    captures = CAPTURES if captures is None else captures
    libraries = {"this": native.LIBRARY} if libraries is None else libraries
    files = {name: sorted((path / "images").iterdir()) for name, path in captures.items()}
    digests = {name: json.loads((path / "digests.json").read_text())["decode"] for name, path in captures.items()}
    times: Dict[tuple, Dict[str, List[float]]] = {}
    out: Dict[str, dict] = {lib: {} for lib in libraries}
    for lib_name, library in libraries.items():
        for name in captures:
            try:
                native.decode_image(files[name][0], library)
            except NotImplementedError as e:
                out[lib_name][name] = {"refused": str(e)}
                continue
            times[lib_name, name] = {"one_thread_s": [], "batched_s": []}
    order = list(libraries)
    for r in range(repeats):
        for lib_name in order if r % 2 == 0 else order[::-1]:
            for name in captures:
                if (lib_name, name) not in times:
                    continue
                library = libraries[lib_name]
                t = time.perf_counter()
                single = [native.decode_image(f, library) for f in files[name]]
                times[lib_name, name]["one_thread_s"].append(time.perf_counter() - t)
                t = time.perf_counter()
                batched = native.decode_batch(files[name], library=library)
                times[lib_name, name]["batched_s"].append(time.perf_counter() - t)
                want = [digests[name][f.name] for f in files[name]]
                entry = out[lib_name].setdefault(name, {"decode_digests": True, "batch_digests": True})
                entry["decode_digests"] &= [_sha(img) for img in single] == want
                entry["batch_digests"] &= [_sha(img) for img in batched] == want
                entry["megapixels"] = sum(img.shape[0] * img.shape[1] for img in single) / 1e6
    for (lib_name, name), t in times.items():
        entry = out[lib_name][name]
        jpeg_mb = sum(f.stat().st_size for f in files[name]) / 1e6
        one, batch = min(t["one_thread_s"]), min(t["batched_s"])
        entry.update(files=len(files[name]), jpeg_mb=jpeg_mb, one_thread_s=one, batched_s=batch,
                     one_thread_median_s=statistics.median(t["one_thread_s"]),
                     batched_median_s=statistics.median(t["batched_s"]),
                     one_thread_s_all=t["one_thread_s"], batched_s_all=t["batched_s"],
                     one_thread_megapixels_per_s=entry["megapixels"] / one,
                     batched_megapixels_per_s=entry["megapixels"] / batch)
    return out


def over_baseline(rates: dict) -> Dict[str, Dict[str, float]]:
    """Per capture other than the baseline one: its megapixels/s over the baseline capture's, for one build,
    one thread and batched."""
    return {name: {kind: entry[f"{kind}_megapixels_per_s"] / rates["baseline"][f"{kind}_megapixels_per_s"]
                   for kind in ("one_thread", "batched")}
            for name, entry in rates.items() if name != "baseline" and "refused" not in entry}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--against", default=None, help="another checkout whose jpeg.cpp is timed in turns with this one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    libraries = {"this": native.LIBRARY}
    if args.against:
        other = Path(args.against) / "yanerf_tpu_torch" / "native" / "src" / "jpeg.cpp"
        libraries = {"other": HostLibrary(other.resolve(), native._bind), "this": native.LIBRARY}
    rates = measure(repeats=args.repeats, libraries=libraries)
    result = {"where": "host CPU", "cpus": os.cpu_count(), "repeats": args.repeats, "rates": rates,
              "over_baseline": over_baseline(rates["this"])}
    if args.against:
        result["against"] = str(args.against)
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1) + "\n")
    return result


if __name__ == "__main__":
    main()
