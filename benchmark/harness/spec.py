"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root names the cell's configuration and traffic; the cell's own file is
``workloads/<cell>.json``, the configuration ``configs/<config>.json``,
the traffic mix ``traffic/<traffic>.json`` (its ``kind`` names the runner
module ``traffic/<kind>.py``), and each per-layer metric a reader
``metrics/<metric>.py``. Nothing here knows a cell, a configuration or a
metric by name.

The plain reference is the configuration's own: its file's ``reference``
field names a package by its path from the checkout's root (today
``benchmark/reference``), imported by the dotted form of that path with the
root on ``sys.path``, and ``resolve`` hands the cell that package's
``model``, ``postprocess``, ``preprocess``, ``records`` and ``tracker``.
A reference package imports its siblings by its own package name (its
``tracker.py`` takes ``auction`` from ``benchmark.reference.assign``), never
by a relative import or another package's name. Under that rule a copy of
``benchmark/reference`` placed beside it as a new package, its imports
renamed and its additions made there, is the whole reference of a new
configuration, and no file of the harness or of another reference changes."""
from __future__ import annotations

import importlib.util
import json
import os
import re
import types
from typing import Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))   # benchmark/
ROOT = os.path.dirname(HERE)
REFERENCE_MODULES = ("model", "postprocess", "preprocess", "records", "tracker")
_PACKAGE_PATH = re.compile(r"[A-Za-z_][A-Za-z0-9_]*(/[A-Za-z_][A-Za-z0-9_]*)*")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(conf: dict, file: str) -> types.SimpleNamespace:
    """The modules of the reference package that the configuration ``conf``
    (read from ``file``) names under ``reference``."""
    path = conf.get("reference")
    if not isinstance(path, str) or not _PACKAGE_PATH.fullmatch(path):
        raise ValueError(f"{file}: the configuration has to name its plain reference under "
                         f"'reference', a package path from the checkout's root such as "
                         f"'benchmark/reference' (got {path!r})")
    name = path.replace("/", ".")
    return types.SimpleNamespace(
        package=name, **{m: importlib.import_module(f"{name}.{m}") for m in REFERENCE_MODULES})


def resolve(cell: str, bench: Optional[dict] = None, base: str = HERE) -> dict:
    """Everything a run of ``cell`` needs, read from files: the entry of
    BENCHMARK.json, the cell's file, the configuration and its reference,
    the traffic mix and the metrics (end to end and per layer) that the
    cell reports. ``base``
    holds the cell and traffic files (the tests keep tiny ones of their
    own); the runners and readers are always this folder's."""
    bench = bench if bench is not None else load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(m):
        return "workloads" not in m or cell in m["workloads"]

    config = load_json(os.path.join(ROOT, conf_entry["file"]))
    return {
        "name": cell,
        "entry": entry,
        "cell": load_json(os.path.join(base, "workloads", f"{cell}.json")),
        "config": config,
        "reference": reference(config, conf_entry["file"]),
        "traffic": load_json(os.path.join(base, "traffic", f"{entry['traffic']}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
        "base": base,
    }


def runner(spec: dict):
    kind = spec["traffic"]["kind"]
    return load_module(os.path.join(HERE, "traffic", f"{kind}.py"), f"_bench_kind_{kind}")


def reader(spec: dict, metric: str):
    return load_module(os.path.join(HERE, "metrics", f"{metric}.py"),
                       "_bench_metric_" + metric.replace(".", "_"))
