"""The plain reference is the configuration's own: ``spec.resolve`` imports
the package that the configuration file names under ``reference``, and
every use (the FLOP count, the weights, each stage of the check and the
control) takes it from the cell. A copy of ``benchmark/reference`` made into
a package of its own, in a temporary directory, is what a configuration
that names it gets."""
import json
import os
import shutil
import sys

import pytest
import torch

from benchmark.conftest import DATA
from benchmark.harness import core, spec, weights

torch.set_num_threads(1)
SEED = 2 ** 31 + 4243
COPY = "w2t_bench_reference_copy"
# each entry point of the copy notes its calls in the package's CALLS
NOTED = {
    "model": ("Detector.forward", "init_weights", "set_fake_quant"),
    "preprocess": ("letterbox",),
    "postprocess": ("select",),
    "tracker": ("step",),
}
NOTE = """
import {pkg} as _pkg


def _noted(name, fn):
    def noted(*a, **kw):
        _pkg.CALLS.append(name)
        return fn(*a, **kw)
    return noted
"""


@pytest.fixture
def copied_reference(tmp_path, monkeypatch, tiny_bench):
    """(the tiny bench with its configuration ``tiny`` naming the copy, the
    copy's call list)."""
    pkg = tmp_path / COPY
    shutil.copytree(os.path.join(spec.HERE, "reference"), pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in pkg.glob("*.py"):
        path.write_text(path.read_text().replace("benchmark.reference", COPY))
    with open(pkg / "__init__.py", "a") as f:
        f.write("\nCALLS = []\n")
    for mod, names in NOTED.items():
        with open(pkg / f"{mod}.py", "a") as f:
            f.write(NOTE.format(pkg=COPY))
            for name in names:
                f.write(f"{name} = _noted({mod + '.' + name!r}, {name})\n")
    entry = next(c for c in tiny_bench["configs"] if c["name"] == "tiny")
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        conf = json.load(f)
    conf["reference"] = COPY
    (tmp_path / "tiny_copy.json").write_text(json.dumps(conf))
    bench = dict(tiny_bench, configs=[dict(c, file=str(tmp_path / "tiny_copy.json"))
                                      if c["name"] == "tiny" else c
                                      for c in tiny_bench["configs"]])
    monkeypatch.syspath_prepend(str(tmp_path))
    yield bench, __import__(COPY).CALLS
    for name in [m for m in sys.modules if m == COPY or m.startswith(COPY + ".")]:
        del sys.modules[name]


def test_shipped_configurations_get_benchmark_reference_itself():
    import benchmark.reference as shipped
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    for config in bench["configs"]:
        cell = next(w["name"] for w in bench["workloads"] if w["config"] == config["name"])
        ref = spec.resolve(cell, bench)["reference"]
        assert ref.package == "benchmark.reference"
        for mod in spec.REFERENCE_MODULES:
            assert getattr(ref, mod) is sys.modules[f"benchmark.reference.{mod}"]
            assert getattr(shipped, mod) is getattr(ref, mod)


def test_a_configuration_without_a_reference_is_refused(tmp_path, tiny_bench):
    entry = next(c for c in tiny_bench["configs"] if c["name"] == "tiny")
    with open(os.path.join(spec.ROOT, entry["file"])) as f:
        conf = json.load(f)
    for bad in (None, "/abs/reference", "benchmark/../reference"):
        if bad is None:
            conf.pop("reference")
        else:
            conf["reference"] = bad
        path = tmp_path / "no_reference.json"
        path.write_text(json.dumps(conf))
        bench = dict(tiny_bench, configs=[dict(entry, file=str(path))])
        with pytest.raises(ValueError, match="no_reference.json"):
            spec.resolve("tiny.segments", bench, DATA)


def test_a_configuration_naming_a_copy_gets_the_copy(copied_reference):
    bench, calls = copied_reference
    cell = spec.resolve("tiny.segments", bench, DATA)
    ref = cell["reference"]
    assert ref.package == COPY
    for mod in spec.REFERENCE_MODULES:
        assert getattr(ref, mod).__name__ == f"{COPY}.{mod}"
    cfg = cell["config"]["config"]

    assert core.flops_per_image(ref, cfg) > 0
    assert calls == ["model.Detector.forward"]
    calls.clear()
    model = weights.make(ref, cfg, cell["config"]["weights"], "cpu")
    assert isinstance(model, ref.model.Detector) and calls == ["model.init_weights"]
    calls.clear()

    out = core.result_line(cell, core.run(cell, SEED, 1.0, False, "cpu"))
    assert out["correct"], out["checks"]
    # the check's forward (staging and detector), select and track stages
    for name in ("model.init_weights", "preprocess.letterbox", "model.Detector.forward",
                 "postprocess.select", "tracker.step"):
        assert name in calls, name
    calls.clear()
    out = core.result_line(cell, core.run(cell, SEED, 1.0, False, "cpu", control=True))
    assert not out["correct"]
    assert "model.set_fake_quant" in calls
