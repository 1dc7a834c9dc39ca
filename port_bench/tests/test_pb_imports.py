"""Nothing the benchmark runs imports JAX or the JAX package; the
reference imports nothing of the program. Module names are compared by
their whole top-level name."""

import ast
import os
import subprocess
import sys
import types

import pytest

import pb_tiny
from port_bench.lib import common

BENCH = common.HERE


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "musicgeneration_tpu_torch.fake", None)
    assert "musicgeneration_tpu" not in common.loaded_banned()
    monkeypatch.setitem(sys.modules, "musicgeneration_tpu.models", None)
    assert "musicgeneration_tpu" in common.loaded_banned()


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in common.BANNED, (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "musicgeneration_tpu_torch", path


def test_a_run_loads_no_jax_module():
    """Every module a cell's driver, its metrics and the reference load,
    in a fresh process: no banned top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import pb_tiny\n"
        "from port_bench.lib import common\n"
        "for c in ('mt-train-b72', 'mt-serve-continue', "
        "'prnn-serve-backlog'):\n"
        "    r = pb_tiny.tiny_run(c, seconds=0.2)\n"
        "    common.result_line(r, common.read_json(%r))\n"
        "print(common.loaded_banned())\n"
        % (common.ROOT, os.path.join(BENCH, "tests"),
           os.path.join(common.ROOT, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_reader_that_loads_jax_gives_no_result(monkeypatch):
    """The check runs after the per-layer readers: one that loads a
    module named ``jax`` leaves the run without a result."""
    run = pb_tiny.tiny_run("mt-train-b72")
    run.trace = True
    bench = common.read_json(os.path.join(common.ROOT, "BENCHMARK.json"))

    def read(r):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return 1.0

    monkeypatch.setattr(common, "metric_reader",
                        lambda name: types.SimpleNamespace(read=read))
    with pytest.raises(common.RunFailure, match="jax"):
        common.finish(run, bench)


def test_a_rank_that_loads_jax_gives_no_result():
    """Four gloo ranks on the CPU, the last of which loads a module named
    ``jax`` after the window: the run gives no result."""
    with pytest.raises(common.RunFailure, match="rank 3"):
        pb_tiny.tiny_run("mt-train-dp4", plant="jax_loaded")
