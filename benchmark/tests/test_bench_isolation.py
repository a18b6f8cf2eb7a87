"""Nothing the benchmark runs loads the JAX side (compared by whole
top-level module names: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import glob
import os
import subprocess
import sys

from benchmark.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")

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


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
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
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import benchmark.reference.model, benchmark.reference.postprocess\n"
            "import benchmark.reference.preprocess, benchmark.reference.tracker\n"
            "import benchmark.reference.records\n"
            "print(','.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "waymo_2d_tracking_tpu_torch" not in _top_level(code)
