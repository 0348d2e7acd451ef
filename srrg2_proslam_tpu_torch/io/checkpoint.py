"""Checkpoint and resume of a GraphSLAM session.

Port of srrg2_proslam_tpu/io/checkpoint.py for the port's GraphSLAM: the
same container (one compressed ``.npz`` with a ``_meta_json`` entry) and
the same keys where the state has the same fields: ``tracker_<i>``,
``graph_<i>``, ``db_<i>`` and ``arena<map>_<i>`` hold the leaves of the
tracker state (arena, pose, velocity, and the smoother's measurement
buffers when present), the pose graph, the closure database ring and each
finalized map's arena, in field order.  The port's session keeps more
than the JAX one, and all of it decides the continuation, so it is saved
too: the database ring's map ids and evictions, which finalized arenas
were on the device and in what order of use (the arena LRU), the local-BA
keyframes (``bakf<k>_<i>``), the closure events and every counter.

``save`` consumes the speculative queue first (``flush``); ``load``
restores onto the GraphSLAM's own device, so a session saved on the card
resumes on the CPU, and back.  The GraphSLAM given to ``load`` must have
been built with the saved session's camera, config and model.

A session on a device mesh (``GraphSLAM(mesh=...)``) is saved by every
rank together: the striped ring and the sharded factors are gathered, and
rank 0 writes the file, which equals the unmeshed session's array for
array.  ``load`` into a meshed GraphSLAM reads the file on every rank and
shards it again.
"""
from __future__ import annotations

import json
from collections import deque
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from ..models.slam import GraphSLAM

_COUNTERS = ("num_maps", "current_map", "num_edges", "num_closures", "num_relocalizations",
             "num_losses", "num_backstop_rejections", "num_db_evictions",
             "num_reloc_rollbacks", "num_reloc_replays", "num_replayed_frames")


def _leaves(tree) -> list:
    """The tensors of nested tuples in field order (None has none), as
    ``jax.tree_util.tree_leaves`` orders a pytree."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for child in tree for leaf in _leaves(child)]


def _rebuild(template, leaves):
    """``template``'s structure with the tensors of ``leaves`` (an iterator)."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    children = [_rebuild(child, leaves) for child in template]
    return type(template)(*children) if hasattr(template, "_fields") else tuple(children)


def _put(arrays: dict, prefix: str, tree) -> None:
    for i, leaf in enumerate(_leaves(tree)):
        arrays[f"{prefix}_{i}"] = leaf.detach().cpu().numpy()


def _get(data, prefix: str, template, device):
    count = len(_leaves(template))
    return _rebuild(template, iter(torch.as_tensor(data[f"{prefix}_{i}"]).to(device)
                                   for i in range(count)))


def save(slam: "GraphSLAM", path: str) -> None:
    """Snapshot a GraphSLAM session to ``path`` (.npz)."""
    slam.flush()
    graph, db = slam.graph, slam.db
    if slam.mesh is not None:
        from ..parallel import spmd

        graph, db = spmd.gather_graph(graph, slam.mesh), spmd.gather_database(db, slam.mesh)
        if slam.mesh.rank != 0:
            return
    arrays = {}
    _put(arrays, "tracker", slam.tracker_state)
    _put(arrays, "graph", graph)
    _put(arrays, "db", db)
    for map_id, arena in slam._map_arenas.items():
        _put(arrays, f"arena{map_id}", arena)
    for k, keyframe in enumerate(slam._ba_keyframes):
        _put(arrays, f"bakf{k}", keyframe)
    meta = {
        **{name: getattr(slam, name) for name in _COUNTERS},
        "frames_in_current_map": slam._frames_in_current_map,
        "frame_count": len(slam.frames),
        "status": slam.status,
        "model": slam.model,
        "map_arena_ids": list(slam._map_arenas),
        "arena_lru": list(slam._arena_lru),
        "db_map_ids": list(slam._db_maps),
        "num_ba_keyframes": len(slam._ba_keyframes),
        "closure_events": [list(e) for e in slam.closure_events],
        "graph_capacity": [graph.capacity, graph.edge_capacity],
        "frames": [{"timestamp": f.timestamp, "local_map_index": f.local_map_index,
                    "T_lm_robot": np.asarray(f.T_lm_robot).tolist()} for f in slam.frames],
    }
    arrays["_meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load(slam: "GraphSLAM", path: str) -> "GraphSLAM":
    """Restore a snapshot into ``slam``, a GraphSLAM built with the saved
    session's camera, config and model, on any device."""
    from ..models import landmarks as lm
    from ..models.slam import FrameRecord
    from ..ops import pgo

    data = np.load(path)
    meta = json.loads(bytes(data["_meta_json"]).decode())
    if meta["model"] != slam.model:
        raise ValueError(f"checkpoint of a {meta['model']!r} session, GraphSLAM is "
                         f"{slam.model!r}")
    dev = slam.device
    slam._queue.clear()
    slam.tracker_state = _get(data, "tracker", slam.tracker_state, dev)
    slam.graph = _get(data, "graph", pgo.empty_graph(*meta["graph_capacity"], "cpu"), dev)
    slam.db = _get(data, "db", slam.db, dev)
    if slam.mesh is not None:
        from ..parallel import spmd

        slam.graph = spmd.shard_graph(slam.graph, slam.mesh)
        slam.db = spmd.shard_database(slam.db, slam.mesh)
    for name in _COUNTERS:
        setattr(slam, name, meta[name])
    slam._frames_in_current_map = meta["frames_in_current_map"]
    slam.status = meta["status"]
    arena_template = lm.empty_arena(1, "cpu")
    lru = meta["arena_lru"]
    # arenas in the LRU were on the device, the others had moved to the CPU
    slam._map_arenas = {mid: _get(data, f"arena{mid}", arena_template,
                                  dev if mid in lru else "cpu")
                        for mid in meta["map_arena_ids"]}
    slam._arena_lru = deque(lru)
    slam._db_maps = dict.fromkeys(meta["db_map_ids"])
    keyframe_template = tuple(torch.zeros(0) for _ in range(4))
    slam._ba_keyframes = [_get(data, f"bakf{k}", keyframe_template, dev)
                          for k in range(meta["num_ba_keyframes"])]
    slam.closure_events = [tuple(e) for e in meta["closure_events"]]
    slam.frames = [FrameRecord(timestamp=f["timestamp"], local_map_index=f["local_map_index"],
                               T_lm_robot=np.asarray(f["T_lm_robot"], np.float32))
                   for f in meta["frames"]]
    slam.last_stats = None
    return slam
