"""Cross-camera track identity linking (counterpart of ``pipeline/link.py``).

One driving context records 5 cameras; an object leaving one camera's view
reappears in another under a new per-camera track id. This offline pass
unifies identities: every camera's final track-table embeddings (the
``.gallery.npz`` sidecars that ``run_segments`` and ``MultiCamPipeline``
write) are scored against every other camera's; mutual cosine best matches
above a threshold merge by union-find into global ids, and the per-camera
track files are rewritten with ``g{n}`` object ids.

Scoring is the dense host matmul, or, with ``mesh=`` (a ``DeviceMesh`` from
``parallel/sharding.py make_mesh``), the ring-sharded gallery of
``parallel/ring.py`` over the mesh's ranks, the queries and the gallery
padded to sizes the data axis divides. Every rank then computes the same
mapping; the rank at (data 0, model 0) writes the linked files.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from waymo_2d_tracking_tpu_torch.io_out import submission as subm
from waymo_2d_tracking_tpu_torch.parallel.ring import ring_gallery_topmatch
from waymo_2d_tracking_tpu_torch.parallel.sharding import barrier, check_mesh, data_size, is_writer
from waymo_2d_tracking_tpu_torch.types import SLOT_EMPTY


class _UnionFind:
    def __init__(self):
        self.parent: Dict = {}

    def find(self, a):
        p = self.parent.setdefault(a, a)
        if p != a:
            p = self.parent[a] = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def write_gallery_sidecar(path_jsonl: str, state, cam_index=None) -> None:
    """Final track-table embeddings next to a track JSONL: the input of
    :func:`load_galleries`. The one writer for every driver.

    state: a host (numpy) TrackerState, optionally with a leading camera axis
    selected by ``cam_index``. No-op when the config has no ReID embeddings.
    """
    sel = (lambda x: x[cam_index]) if cam_index is not None else (lambda x: x)
    if state.embed.shape[-1] <= 1:
        return
    np.savez(
        path_jsonl[: -len(".jsonl")] + ".gallery.npz",
        track_id=np.asarray(sel(state.track_id)),
        status=np.asarray(sel(state.status)),
        embed=np.asarray(sel(state.embed), np.float32),
    )


def load_galleries(out_dir: str) -> Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """{context: {camera: (track_ids (K,), embeds (K, E))}}, live tracks only."""
    out: Dict[str, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
    for path in sorted(glob.glob(os.path.join(out_dir, "*.gallery.npz"))):
        m = re.match(r"(.+)_(\d+)\.gallery\.npz$", os.path.basename(path))
        if not m:
            continue
        ctx, cam = m.group(1), int(m.group(2))
        z = np.load(path)
        keep = (z["status"] != SLOT_EMPTY) & (z["track_id"] >= 0)
        out.setdefault(ctx, {})[cam] = (z["track_id"][keep], z["embed"][keep])
    return out


def best_cross_camera_matches(
    cams: Dict[int, Tuple[np.ndarray, np.ndarray]],
    mesh=None,
) -> List[Tuple[int, int, int, int, float]]:
    """For each track, its best match among all other cameras' tracks, by a
    dense matmul or, with ``mesh``, the ring-sharded gallery. Returns rows
    (cam, track_id, other_cam, other_track_id, cosine_sim)."""
    if mesh is not None:
        check_mesh(mesh)
    cam_ids = sorted(cams)
    all_ids: List[Tuple[int, int]] = []   # (camera, track_id) per gallery row
    embeds: List[np.ndarray] = []
    for c in cam_ids:
        ids, emb = cams[c]
        all_ids.extend((c, int(t)) for t in ids)
        embeds.append(emb)
    if not all_ids:
        return []
    gallery = np.concatenate(embeds, axis=0).astype(np.float32)   # (N, E)
    cam_of_row = np.array([c for c, _ in all_ids])

    rows: List[Tuple[int, int, int, int, float]] = []
    for c in cam_ids:
        ids, queries = cams[c]
        if len(ids) == 0:
            continue
        valid = cam_of_row != c                    # exclude own camera
        if mesh is not None:
            sims, idx = _ring_scores(queries.astype(np.float32), gallery, valid, mesh)
        else:
            s = queries.astype(np.float32) @ gallery.T            # (Q, N)
            s[:, ~valid] = -2.0
            idx = s.argmax(axis=1)
            sims = s[np.arange(len(ids)), idx]
            idx = np.where(sims <= -2.0, -1, idx)
        for q, (g, sim) in enumerate(zip(idx, sims)):
            if g < 0:
                continue
            oc, ot = all_ids[int(g)]
            rows.append((c, int(ids[q]), oc, ot, float(sim)))
    return rows


def _ring_scores(queries: np.ndarray, gallery: np.ndarray, valid: np.ndarray, mesh):
    """(sims, idx) of ``queries`` against the ring-sharded ``gallery``, both
    zero-padded to sizes the data axis divides (padded gallery rows are
    invalid; an index past the real gallery is -1)."""
    n_dev = data_size(mesh)
    q, e = queries.shape
    n = gallery.shape[0]
    queries_p = np.concatenate([queries, np.zeros(((-q) % n_dev, e), np.float32)])
    gallery_p = np.concatenate([gallery, np.zeros(((-n) % n_dev, e), np.float32)])
    valid_p = np.concatenate([valid, np.zeros(((-n) % n_dev,), bool)])
    sims, idx = ring_gallery_topmatch(torch.from_numpy(queries_p), torch.from_numpy(gallery_p),
                                      torch.from_numpy(valid_p), mesh)
    sims = sims.cpu().numpy()[:q]
    idx = idx.cpu().numpy()[:q]
    return sims, np.where(idx >= n, -1, idx)


def link_context(
    cams: Dict[int, Tuple[np.ndarray, np.ndarray]],
    threshold: float = 0.6,
    mesh=None,
) -> Dict[Tuple[int, int], str]:
    """(camera, track_id) -> global id ('g<n>') for one context. Mutual best
    matches above ``threshold`` merge; every other track keeps a singleton
    global id."""
    rows = best_cross_camera_matches(cams, mesh=mesh)
    best: Dict[Tuple[int, int], Tuple[int, int, float]] = {
        (c, t): (oc, ot, s) for c, t, oc, ot, s in rows
    }
    uf = _UnionFind()
    for (c, t), (oc, ot, s) in best.items():
        if s < threshold:
            continue
        back = best.get((oc, ot))
        if back and back[0] == c and back[1] == t and back[2] >= threshold:
            uf.union((c, t), (oc, ot))            # mutual best match
    mapping: Dict[Tuple[int, int], str] = {}
    root_gid: Dict = {}
    for c in sorted(cams):
        ids, _ = cams[c]
        for t in ids:
            root = uf.find((c, int(t)))
            gid = root_gid.setdefault(root, len(root_gid))
            mapping[(c, int(t))] = f"g{gid}"
    return mapping


def link_tracks(
    out_dir: str,
    linked_dir: Optional[str] = None,
    threshold: float = 0.6,
    mesh=None,
) -> dict:
    """Rewrite the per-(context, camera) track files of ``out_dir`` with
    unified global ids into ``linked_dir``. Returns a report: contexts,
    tracks, merged groups. With ``mesh`` every rank scores through the ring
    and returns the report; the rank at (data 0, model 0) writes."""
    writer = True
    if mesh is not None:
        writer = is_writer(check_mesh(mesh))
    linked_dir = linked_dir or os.path.join(out_dir, "linked")
    os.makedirs(linked_dir, exist_ok=True)
    galleries = load_galleries(out_dir)
    n_tracks = n_merged = 0
    for ctx, cams in sorted(galleries.items()):
        mapping = link_context(cams, threshold=threshold, mesh=mesh)
        n_tracks += len(mapping)
        n_merged += len(mapping) - len(set(mapping.values()))
        for cam in sorted(cams):
            src = os.path.join(out_dir, f"{ctx}_{cam}.jsonl")
            if not writer or not os.path.exists(src):
                continue
            out = []
            for r in subm.read_jsonl(src):
                # emitted ids are "{camera}_{track_id}" (io_out/submission.py)
                try:
                    tid = int(str(r.object_id).rsplit("_", 1)[-1])
                except ValueError:
                    tid = None
                gid = mapping.get((cam, tid)) if tid is not None else None
                out.append(r if gid is None else dataclasses.replace(r, object_id=gid))
            subm.write_jsonl(os.path.join(linked_dir, f"{ctx}_{cam}.jsonl"), out)
    if mesh is not None:
        barrier(mesh)     # the linked files exist on every rank's return
    return {
        "contexts": len(galleries),
        "tracks": n_tracks,
        "cross_camera_merges": n_merged,
        "out": linked_dir,
    }
