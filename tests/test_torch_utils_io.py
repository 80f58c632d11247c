"""The port's ``utils`` (fileio, timer, logging, misc, path) against ``yanerf_tpu/utils``, on the CPU.

Every case of tests/test_utils.py that covers ``fileio``, ``Timer`` /
``check_time`` or ``print_log`` is repeated against the port, and the two
packages are held to each other:
  * files that both packages' ``dump`` write (json, yaml, pickle; plain
    data, numpy scalars and arrays) are equal byte for byte, and each
    package ``load``s the other's; both refuse what a format cannot hold
    with the same error;
  * the backend registry, the prefix map and the inferred backends are
    equal, and so are the ``ImportError`` of each optional backend and the
    ``NotImplementedError`` of a write to a read-only one;
  * ``misc`` and ``path`` give equal results on the same inputs;
  * ``get_logger`` sets up the JAX package's handlers, and under a one-rank
    and a two-rank gloo group rank 1 logs errors only.
"""

import io
import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import yaml

import yanerf_tpu.utils as jax_utils
import yanerf_tpu_torch.utils as port_utils
from yanerf_tpu.utils import fileio as jax_fileio
from yanerf_tpu.utils import misc as jax_misc
from yanerf_tpu.utils import path as jax_path
from yanerf_tpu.utils.fileio.backends import FileClient as JaxFileClient
from yanerf_tpu_torch.utils import fileio, misc, path
from yanerf_tpu_torch.utils.fileio.backends import FileClient

REPO = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": jax_fileio, "port": fileio}

PLAIN = {"x": [1, 2], "y": "z", "nested": {"a": 1.5, "b": None, "c": True}, "list": [[1, "2"], []]}
NUMPY = {"i": np.int64(3), "f": np.float32(0.25), "d": np.float64(1e-9), "arr": np.arange(6).reshape(2, 3),
         "farr": np.linspace(0, 1, 4, dtype=np.float32), "u8": np.uint8(255), "set": {3}}


# --- fileio: the files of both packages ----------------------------------------


@pytest.mark.parametrize("ext", ["json", "yml", "yaml", "pkl", "pickle"])
@pytest.mark.parametrize("kind", ["plain", "numpy"])
def test_dump_writes_the_jax_files_byte_for_byte_and_each_loads_the_other(tmp_path, ext, kind):
    obj = PLAIN if kind == "plain" else NUMPY
    if kind == "numpy" and ext in ("yml", "yaml"):  # SafeDumper holds no numpy type, in either package
        errors = []
        for name, pkg in PACKAGES.items():
            with pytest.raises(yaml.representer.RepresenterError) as err:
                pkg.dump(obj, str(tmp_path / f"{name}.{ext}"))
            errors.append(str(err.value))
        assert errors[0] == errors[1]
        return
    paths = {name: tmp_path / f"{name}.{ext}" for name in PACKAGES}
    for name, pkg in PACKAGES.items():
        assert pkg.dump(obj, str(paths[name])) is None
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    for reader in PACKAGES.values():
        for writer in paths.values():
            a, b = reader.load(str(writer)), jax_fileio.load(str(paths["jax"]))
            if ext in ("pkl", "pickle"):
                assert pickle.dumps(a) == pickle.dumps(b)
            else:
                assert a == b
    if kind == "plain":
        assert fileio.load(paths["port"]) == PLAIN  # a Path as well as a str


@pytest.mark.parametrize("fmt", ["json", "yaml", "pickle"])
def test_dump_to_a_string_and_a_file_object_equal_the_jax_package(fmt):
    obj = PLAIN if fmt == "yaml" else {**PLAIN, **NUMPY}
    assert fileio.dump(obj, file_format=fmt) == jax_fileio.dump(obj, file_format=fmt)
    streams = {}
    for name, pkg in PACKAGES.items():
        streams[name] = io.BytesIO() if fmt == "pickle" else io.StringIO()
        pkg.dump(obj, streams[name], file_format=fmt)
    assert streams["port"].getvalue() == streams["jax"].getvalue()
    for stream in streams.values():
        stream.seek(0)
    ours, theirs = fileio.load(streams["jax"], file_format=fmt), jax_fileio.load(streams["port"], file_format=fmt)
    assert pickle.dumps(ours) == pickle.dumps(theirs) if fmt == "pickle" else ours == theirs


def test_fileio_load_dump(tmp_path):
    """tests/test_utils.py::test_fileio_load_dump against the port."""
    obj = {"x": [1, 2], "y": "z"}
    for ext in ("json", "yml", "pkl"):
        file = str(tmp_path / f"f.{ext}")
        fileio.dump(obj, file)
        assert fileio.load(file) == obj
    text = fileio.dump(obj, file_format="json")
    assert "\"x\"" in text


@pytest.mark.parametrize("call", [
    lambda pkg: pkg.load("f.txt"),
    lambda pkg: pkg.dump({}, "f.txt"),
    lambda pkg: pkg.dump({}),
    lambda pkg: pkg.load(3, file_format="json"),
    lambda pkg: pkg.dump({}, 3, file_format="json"),
], ids=["load_unknown_format", "dump_unknown_format", "dump_without_format", "load_not_a_file", "dump_not_a_file"])
def test_fileio_errors_equal_the_jax_package(call):
    errors = []
    for pkg in PACKAGES.values():
        with pytest.raises((TypeError, ValueError)) as err:
            call(pkg)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1]


def test_register_handler_adds_a_format(tmp_path):
    class Lines(fileio.BaseFileHandler):
        def load_from_fileobj(self, file, **kwargs):
            return file.read().splitlines()

        def dump_to_fileobj(self, obj, file, **kwargs):
            file.write(self.dump_to_str(obj))

        def dump_to_str(self, obj, **kwargs):
            return "\n".join(obj)

    try:
        fileio.register_handler(Lines(), ["lines", "ln"])
        fileio.dump(["a", "b"], str(tmp_path / "x.lines"))
        assert fileio.load(str(tmp_path / "x.lines")) == ["a", "b"] == fileio.load(str(tmp_path / "x.lines"), "ln")
    finally:
        for fmt in ("lines", "ln"):
            fileio.file_handlers.pop(fmt, None)
    assert sorted(fileio.file_handlers) == sorted(jax_fileio.file_handlers)


# --- fileio: the backends --------------------------------------------------------


def test_fileio_backend_registry_complete():
    """tests/test_utils.py::test_fileio_backend_registry_complete against the port."""
    for name in ("disk", "http", "lmdb", "memcached", "petrel", "ceph"):
        assert name in FileClient._backends
    with pytest.raises(ImportError, match="ceph"):
        FileClient("ceph")


def test_the_backend_registry_and_prefix_inference_equal_the_jax_package():
    assert {k: v.__name__ for k, v in FileClient._backends.items()} == {
        k: v.__name__ for k, v in JaxFileClient._backends.items()}
    assert FileClient._prefix_to_backend == JaxFileClient._prefix_to_backend
    uris = [None, "a/b.json", Path("c.yml"), "http://host/x.json", "https://h/y", "s3://bucket/k", "petrel://b/k",
            "ftp://elsewhere/z", "file://local", "://odd"]
    for uri in uris:
        assert FileClient.parse_uri_prefix(str(uri)) == JaxFileClient.parse_uri_prefix(str(uri))
        # petrel's prefixes build a client that needs petrel_client: both packages raise the same ImportError
        assert _outcome(lambda: FileClient.infer_client(uri).backend_name) == _outcome(
            lambda: JaxFileClient.infer_client(uri).backend_name)
    errors = []
    for client in (FileClient, JaxFileClient):
        with pytest.raises(ValueError) as err:
            client("nosuch")
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_register_backend_as_in_the_jax_package(tmp_path):
    backends, prefixes = dict(FileClient._backends), dict(FileClient._prefix_to_backend)

    class Memory(fileio.BaseStorageBackend):
        store = {}

        def get(self, filepath):
            return self.store[filepath]

        def get_text(self, filepath, encoding="utf-8"):
            return self.get(filepath).decode(encoding)

        def put(self, obj, filepath):
            self.store[filepath] = obj

        def put_text(self, obj, filepath, encoding="utf-8"):
            self.put(obj.encode(encoding), filepath)

    try:
        with pytest.raises(KeyError, match="already registered"):
            FileClient.register_backend("disk", Memory)
        FileClient.register_backend("memory", Memory, prefixes="mem")
        fileio.dump({"a": [1]}, "mem://x.json")
        fileio.dump({"b": 2}, "mem://y.pkl")
        assert fileio.load("mem://x.json") == {"a": [1]} and fileio.load("mem://y.pkl") == {"b": 2}
        FileClient.register_backend("memory", Memory, prefixes=["mem2"], force=True)
        assert FileClient.infer_client("mem2://z").backend_name == "memory"
        assert FileClient("disk").get_text(__file__).startswith('"""')
    finally:
        FileClient._backends, FileClient._prefix_to_backend = backends, prefixes
    assert FileClient._backends == backends and "memory" not in FileClient._backends


@pytest.mark.parametrize("backend,module", [("lmdb", "lmdb"), ("memcached", "pymemcache"),
                                            ("petrel", "petrel_client"), ("ceph", "ceph")])
def test_an_optional_backend_without_its_package_raises_the_jax_import_error(monkeypatch, backend, module):
    monkeypatch.setitem(sys.modules, module, None)  # the package is absent, whatever this machine has
    kwargs = {"db_path": "/nonexistent"} if backend == "lmdb" else {}
    messages = []
    for client in (FileClient, JaxFileClient):
        with pytest.raises(ImportError) as err:
            client(backend, **kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and module.split("_")[0] in messages[0]


def test_fileio_dump_routes_through_backend_dispatch(tmp_path):
    """tests/test_utils.py::test_fileio_dump_routes_through_backend_dispatch against the port: a read-only
    backend refuses the write before any request, with the JAX package's message."""
    file = str(tmp_path / "x.json")
    fileio.dump({"a": 1}, file)
    assert fileio.load(file) == {"a": 1}
    messages = []
    for pkg in PACKAGES.values():
        for target in ("http://localhost:1/x.json", "http://localhost:1/x.pkl"):
            with pytest.raises(NotImplementedError, match="does not support writing") as err:
                pkg.dump({"a": 1}, target)
            messages.append(str(err.value))
    assert messages[:2] == messages[2:] and messages[0] == "HTTPBackend does not support writing"


def test_the_disk_backend_writes_into_new_directories(tmp_path):
    for client in (FileClient("disk"), JaxFileClient("disk")):
        name = type(client).__module__.split(".")[0]
        client.put(b"\x00\x01", tmp_path / name / "deep" / "b.bin")
        client.put_text("t", tmp_path / name / "deeper" / "t.txt")
        assert client.get(tmp_path / name / "deep" / "b.bin") == b"\x00\x01"
        assert client.get_text(tmp_path / name / "deeper" / "t.txt") == "t"
        disk = client.client
        assert disk.exists(tmp_path / name) and disk.isdir(tmp_path / name) and disk.isfile(
            tmp_path / name / "deeper" / "t.txt")


# --- Timer, check_time, print_log ----------------------------------------------------


def test_timer_and_check_time():
    """tests/test_utils.py::test_timer_and_check_time against the port."""
    t = port_utils.Timer()
    time.sleep(0.01)
    assert t.since_start() >= 0.01
    first = t.since_last_check()
    assert first < 0.01
    assert port_utils.check_time("test_torch_timer_id") == 0.0
    time.sleep(0.005)
    assert port_utils.check_time("test_torch_timer_id") >= 0.005


def test_timer_states_and_errors_equal_the_jax_package(capsys):
    for utils in (port_utils, jax_utils):
        t = utils.Timer(start=False, print_tmpl="took {:.1f}")
        assert not t.is_running
        for call in (t.since_start, t.since_last_check):
            with pytest.raises(utils.TimerError, match="timer is not running") as err:
                call()
            assert err.value.message == "timer is not running"
        with t:
            assert t.is_running
        assert not t.is_running
    out = capsys.readouterr().out.splitlines()
    assert out == ["took 0.0", "took 0.0"]


def test_print_log_variants(capsys):
    """tests/test_utils.py::test_print_log_variants against the port, with the other two logger kinds and the
    TypeError."""
    port_utils.print_log("to stdout", logger=None)
    assert "to stdout" in capsys.readouterr().out
    port_utils.print_log("silenced", logger="silent")
    assert capsys.readouterr().out == ""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append((record.name, record.levelno, record.getMessage()))

    named = port_utils.get_logger("test_torch_utils_io.print_log")
    named.addHandler(Keep())
    port_utils.print_log("by name", logger="test_torch_utils_io.print_log", level=logging.WARNING)
    port_utils.print_log("by logger", logger=named, level=logging.ERROR)
    assert records == [("test_torch_utils_io.print_log", logging.WARNING, "by name"),
                       ("test_torch_utils_io.print_log", logging.ERROR, "by logger")]
    messages = []
    for utils in (port_utils, jax_utils):
        with pytest.raises(TypeError) as err:
            utils.print_log("x", logger=3)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# --- get_logger -------------------------------------------------------------------


def _handlers(logger):
    return [(type(h).__name__, h.level, h.formatter._fmt, getattr(h, "mode", None)) for h in logger.handlers]


def test_get_logger_sets_up_the_jax_handlers_once(tmp_path):
    loggers = {}
    for name, utils in (("jax", jax_utils), ("port", port_utils)):
        logger = utils.get_logger(f"test_torch_utils_io.{name}", log_file=str(tmp_path / f"{name}.log"),
                                  log_level=logging.DEBUG, file_mode="a")
        assert utils.get_logger(f"test_torch_utils_io.{name}") is logger  # once
        assert len(utils.get_logger(f"test_torch_utils_io.{name}.child").handlers) == 0  # under an initialized prefix
        logger.debug("debug line")
        loggers[name] = logger
    assert _handlers(loggers["port"]) == _handlers(loggers["jax"])
    assert [(lg.level, lg.propagate) for lg in loggers.values()] == [(logging.DEBUG, False)] * 2
    lines = {name: (tmp_path / f"{name}.log").read_text().split(" - ", 1)[1] for name in loggers}
    assert lines["port"] == lines["jax"].replace(".jax", ".port") == "test_torch_utils_io.port - DEBUG - debug line\n"


LOGGER_WORKER = r"""
import json, os, sys
import torch.distributed as dist
from yanerf_tpu_torch.utils import get_logger
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method=os.environ["URL"], rank=rank, world_size=world)
log = os.path.join(os.environ["OUT"], f"rank{rank}.log")
logger = get_logger("worker", log_file=log, log_level=10)
logger.info("an info line")
logger.error("an error line")
print(json.dumps({"level": logger.level, "file": os.path.exists(log)}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [1, 2])
def test_get_logger_under_a_gloo_group_logs_errors_only_beyond_rank_0(tmp_path, world):
    url = f"tcp://localhost:{_free_port()}"
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), URL=url, OUT=str(tmp_path),
                   OMP_NUM_THREADS="1", PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, "-c", LOGGER_WORKER], env=env, cwd=REPO, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=120) for p in procs]
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out}\n{err}"
    results = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert results[0] == {"level": logging.DEBUG, "file": True}
    assert "an info line" in outs[0][1] and "an error line" in outs[0][1]
    assert [line.split(" - ", 2)[2] for line in (tmp_path / "rank0.log").read_text().splitlines()] == [
        "INFO - an info line", "ERROR - an error line"]
    if world == 2:
        assert results[1] == {"level": logging.ERROR, "file": False}
        assert "an info line" not in outs[1][1] and "an error line" in outs[1][1]
        assert not (tmp_path / "rank1.log").exists()


# --- misc and path ----------------------------------------------------------------------


MISC_CASES = [
    ("is_str", ("a",)), ("is_str", (1,)),
    ("is_seq_of", ([1, 2], int)), ("is_seq_of", ((1, "a"), int)), ("is_seq_of", ("ab", str)),
    ("is_seq_of", ([1], int, tuple)), ("is_list_of", ([1.0], float)), ("is_list_of", ((1.0,), float)),
    ("is_tuple_of", ((1,), int)), ("is_tuple_of", ([1], int)),
    ("list_cast", (["1", "2"], int)), ("tuple_cast", ([1, 2], str)),
    ("slice_list", (list(range(6)), 2)), ("slice_list", (list(range(6)), [1, 2, 3])),
    ("slice_list", (list(range(6)), 4)), ("slice_list", (list(range(6)), [1, 2])),
    ("slice_list", (list(range(6)), (3, 3))),
    ("concat_list", ([[1], [2, 3], []],)),
    ("to_1tuple", (5,)), ("to_2tuple", (5,)), ("to_3tuple", ([1, 2],)), ("to_4tuple", ("ab",)),
    ("iter_cast", (5, int)),
    ("import_modules_from_strings", ("json",)), ("import_modules_from_strings", (["json", "os.path"],)),
    ("import_modules_from_strings", ([],)), ("import_modules_from_strings", ("no_such_module_anywhere",)),
    ("import_modules_from_strings", (3,)),
]


def _outcome(fn, *args):
    try:
        return "ok", fn(*args)
    except Exception as e:  # the two packages must fail alike
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name,args", MISC_CASES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(MISC_CASES)])
def test_misc_equals_the_jax_package(name, args):
    assert _outcome(getattr(misc, name), *args) == _outcome(getattr(jax_misc, name), *args)


def test_to_ntuple_iter_cast_and_failed_imports_equal_the_jax_package():
    for n in (1, 3, 5):
        assert misc.to_ntuple(n)(7) == jax_misc.to_ntuple(n)(7) == (7,) * n
        assert misc.to_ntuple(n)(range(2)) == jax_misc.to_ntuple(n)(range(2)) == (0, 1)
    assert list(misc.iter_cast(["1", "2"], float)) == list(jax_misc.iter_cast(["1", "2"], float)) == [1.0, 2.0]
    with pytest.warns(UserWarning, match="no_such_module_anywhere failed to import and is ignored"):
        got = misc.import_modules_from_strings(["json", "no_such_module_anywhere"], allow_failed_imports=True)
    assert got == [json, None]
    def double(new):
        return new * 2

    with pytest.warns(DeprecationWarning, match="'old' is deprecated in double, use 'new' instead"):
        assert misc.deprecated_api_warning({"old": "new"})(double)(old=3) == 6
    both = [_outcome(lambda m=m: m.deprecated_api_warning({"old": "new"}, "C")(lambda new: new)(old=1, new=2))
            for m in (misc, jax_misc)]
    assert both[0] == both[1] and both[0][0] == "TypeError"


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "tree"
    for rel in ("a.png", "b.jpg", "c.txt", ".hidden.png", "sub/d.png", "sub/e.JPG", "sub/deep/f.jpg",
                ".git_like/g.png"):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(rel)
    return root


@pytest.mark.parametrize("suffix", [None, ".png", (".png", ".jpg"), "x"])
@pytest.mark.parametrize("recursive", [False, True])
def test_scandir_equals_the_jax_package(tree, suffix, recursive):
    for dir_path in (tree, str(tree)):
        got = sorted(path.scandir(dir_path, suffix, recursive))
        assert got == sorted(jax_path.scandir(dir_path, suffix, recursive))
    assert ("sub/deep/f.jpg" in got) == (recursive and suffix in (None, (".png", ".jpg")))
    assert ".hidden.png" not in got


def test_path_helpers_equal_the_jax_package(tree, tmp_path):
    for bad in ((3,), (tree, 3)):
        assert _outcome(lambda: list(path.scandir(*bad))) == _outcome(lambda: list(jax_path.scandir(*bad)))
    (tree / ".git").mkdir()
    for start in (tree / "sub" / "deep", tree / "sub" / "deep" / "f.jpg", tree, str(tree / "sub")):
        assert path.find_vcs_root(str(start)) == jax_path.find_vcs_root(str(start)) == str(tree)
    assert path.find_vcs_root(str(tree), markers=(".no_marker",)) is None
    assert jax_path.find_vcs_root(str(tree), markers=(".no_marker",)) is None
    for x in ("a", Path("a"), 3, None):
        assert path.is_filepath(x) == jax_path.is_filepath(x)
    for pkg in (path, jax_path):
        with pkg.fopen(str(tree / "a.png")) as f, pkg.fopen(tree / "c.txt") as g:
            assert (f.read(), g.read()) == ("a.png", "c.txt")
        with pytest.raises(ValueError, match="string or a Path"):
            pkg.fopen(3)
        with pytest.raises(FileNotFoundError, match="nope"):
            pkg.check_file_exist(str(tree / "nope"))
        pkg.check_file_exist(str(tree / "a.png"))
        pkg.mkdir_or_exist(tmp_path / pkg.__name__ / "x" / "y")
        pkg.mkdir_or_exist("")
        assert (tmp_path / pkg.__name__ / "x" / "y").is_dir()
        link = tmp_path / f"{pkg.__name__}.link"
        pkg.symlink(str(tree / "a.png"), str(link))
        pkg.symlink(str(tree / "c.txt"), str(link))  # overwrite
        assert os.readlink(link) == str(tree / "c.txt")


def test_the_port_exports_the_jax_utils_names():
    assert set(jax_utils.__all__) <= set(port_utils.__all__)
    assert set(port_utils.__all__) - set(jax_utils.__all__) == {"device_constant", "resolve_device"}
    for name in port_utils.__all__:
        assert getattr(port_utils, name).__module__.startswith("yanerf_tpu_torch."), name
