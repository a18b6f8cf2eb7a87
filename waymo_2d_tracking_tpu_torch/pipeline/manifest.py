"""Segment-manifest failure recovery (counterpart of ``pipeline/manifest.py``):
per-segment outputs are idempotent files plus a ``manifest.jsonl`` of
completed ``context/camera`` keys; reruns skip completed work. One
implementation for every driver (``run_segments``, ``run_context_groups``),
with the JAX package's key format and schema.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Set


def manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, "manifest.jsonl")


def segment_key(context_name: str, camera_name) -> str:
    return f"{context_name}/{camera_name}"


def load_done_keys(out_dir: str) -> Set[str]:
    """Completed (context/camera) keys recorded in out_dir's manifest."""
    os.makedirs(out_dir, exist_ok=True)
    path = manifest_path(out_dir)
    done: Set[str] = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                if line.strip():
                    done.add(json.loads(line)["key"])
    return done


def append_manifest(out_dir: str, stats: Iterable[dict]) -> None:
    """Record completed segments; each stat needs context/camera fields."""
    with open(manifest_path(out_dir), "a") as f:
        for st in stats:
            key = st.get("key") or segment_key(st["context"], st["camera"])
            f.write(json.dumps({"key": key, **st}) + "\n")
