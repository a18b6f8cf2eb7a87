"""Nothing the benchmark runs loads the JAX side (compared by whole
top-level module names: the port's name begins with the JAX package's), and
no reference package that a configuration names imports anything of the
program."""
import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.conftest import DATA, ROOT


PROBE = r"""
import glob, importlib, os, sys
sys.path.insert(0, {root!r})
import benchmark.run
from benchmark.harness import check, core, frames, peaks, probe, spec, trace, weights
for kind in glob.glob(os.path.join({root!r}, "benchmark", "traffic", "*.py")):
    spec.load_module(kind, "k_" + os.path.basename(kind)[:-3])
for m in glob.glob(os.path.join({root!r}, "benchmark", "metrics", "*.py")):
    spec.load_module(m, "m_" + os.path.basename(m)[:-3].replace(".", "_"))
import waymo_2d_tracking_tpu_torch.pipeline.run, waymo_2d_tracking_tpu_torch.pipeline.multicam
import waymo_2d_tracking_tpu_torch.pipeline.online, waymo_2d_tracking_tpu_torch.pipeline.link
import waymo_2d_tracking_tpu_torch.io_out.submission
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.strip().splitlines()[-1].split(","))


def test_benchmark_loads_nothing_of_the_jax_side():
    names = _top_level(PROBE.format(root=ROOT))
    assert "waymo_2d_tracking_tpu_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "waymo_2d_tracking_tpu"}


def _reference_packages() -> list:
    """Every package that a configuration of BENCHMARK.json or of the tests'
    bench names under ``reference``."""
    found = set()
    for bench in (os.path.join(ROOT, "BENCHMARK.json"), os.path.join(DATA, "bench.json")):
        with open(bench) as f:
            for conf in json.load(f)["configs"]:
                with open(os.path.join(ROOT, conf["file"])) as g:
                    found.add(json.load(g)["reference"])
    return sorted(found)


def test_reference_imports_nothing_of_the_program():
    packages = _reference_packages()
    assert "benchmark/reference" in packages
    for package in packages:
        paths = glob.glob(os.path.join(ROOT, package, "*.py"))
        assert paths, package
        for path in paths:
            tree = ast.parse(open(path).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in ("waymo_2d_tracking_tpu_torch",
                                                   "waymo_2d_tracking_tpu", "jax"), (path, n)
        modules = [package.replace("/", ".") + "." + os.path.basename(p)[:-3] for p in paths
                   if not p.endswith("__init__.py")]
        code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
                f"import {', '.join(modules)}\n"
                "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
        assert not _top_level(code) & {"waymo_2d_tracking_tpu_torch", "waymo_2d_tracking_tpu",
                                       "jax"}, package
