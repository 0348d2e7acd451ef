"""Entry points of the port: one stereo tracker step, and the multi-GPU dry run.

The counterparts of the repo's ``__graft_entry__.py``.  ``entry()``
returns ``(fn, example_args)``: ``fn(*example_args)`` runs one
``track_step`` of the flagship stereo model for the KITTI camera on 512
synthetic measurements against a warm 2048-landmark arena, built with the
same ``np.random.RandomState`` draws as the JAX entry, so the example
inputs are equal to its.  On the card the step launches the GN burst
kernel (K2) three times.

``dryrun_multichip(n_devices)`` runs the sharded stages (the tracker step,
the striped ring query, PGO dense and CG, BA structure-only and joint) on
their tiny shapes over ``n_devices`` spawned ranks (parallel/launch.py),
rank r on ``cuda:(r % device_count)``, then a short meshed GraphSLAM
through the chunk program; each stage is held to its single-rank call on
the same rank (parallel/checks.py) and a mismatch raises.  The backend is
NCCL when every rank has a card of its own and gloo when ranks share a
card; ``device="cpu"`` runs the ranks on the CPU over gloo.  Unlike the
JAX package's dry run it never moves itself to the CPU.

    python -m srrg2_proslam_tpu_torch.entry [n_devices]
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .io.datasets import kitti_camera
from .models.tracker import TrackerConfig, initial_state, track_step


def synthetic_arrays(n_meas: int, capacity: int, cam, seed: int = 0):
    """The numpy draws of ``_synthetic_frame``: (world points [n, 3],
    measurements [n, 4], descriptors [n, 256], valid [n])."""
    rng = np.random.RandomState(seed)
    pts = np.stack([
        rng.uniform(-10, 10, n_meas),
        rng.uniform(-3, 3, n_meas),
        rng.uniform(4, 40, n_meas),
    ], axis=1).astype(np.float32)
    u = cam.fx * pts[:, 0] / pts[:, 2] + cam.cx
    v = cam.fy * pts[:, 1] / pts[:, 2] + cam.cy
    ur = u - cam.baseline_px / pts[:, 2]
    points = np.stack([u, v, ur, v], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n_meas, 256))
    valid = (u > 0) & (u < cam.cols) & (v > 0) & (v < cam.rows) & (ur > 0)
    return pts, points, desc, valid


def _synthetic_frame(n_meas: int, capacity: int, cam, seed: int = 0,
                     device=torch.device("cuda")):
    """A synthetic stereo frame and a warm tracker state (no image I/O)."""
    pts, points, desc, valid = synthetic_arrays(n_meas, capacity, cam, seed)
    state = initial_state(capacity, device=device)
    n_lm = min(n_meas, capacity)
    arena = state.arena
    pos, cov, dsc = arena.pos.clone(), arena.cov.clone(), arena.desc.clone()
    num_updates, ok = arena.num_updates.clone(), arena.valid.clone()
    pos[:n_lm] = torch.from_numpy(pts[:n_lm]).to(device)
    dsc[:n_lm] = torch.from_numpy(desc[:n_lm]).to(device)
    cov[:n_lm] = torch.eye(3, device=device) * 0.05
    num_updates[:n_lm] = 1
    ok[:n_lm] = True
    state = state._replace(arena=arena._replace(pos=pos, cov=cov, desc=dsc,
                                                num_updates=num_updates, valid=ok))
    return (state, torch.from_numpy(points).to(device), torch.from_numpy(desc).to(device),
            torch.from_numpy(valid).to(device))


def entry(device=torch.device("cuda")):
    """(fn, example_args): one stereo tracker step (the flagship model)."""
    cam = kitti_camera()
    state, points, desc, valid = _synthetic_frame(512, 2048, cam, device=device)
    fn = partial(track_step, cam=cam, config=TrackerConfig(), model="stereo")
    return fn, (state, points, desc, valid)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The sharded stages over ``n_devices`` ranks, each held to its
    single-rank call, and a short meshed GraphSLAM run held to the
    unmeshed one; raises on a mismatch.  Returns the ranks' reports."""
    from .parallel import checks, launch

    reports = launch.run(checks.dryrun_rank, n_devices, device=device)
    for report in reports:
        checks.check_stages(report)
    r = reports[0]
    print(f"dryrun_multichip({n_devices}) on {r['device']} over {r['backend']}: tracker "
          f"inliers={r['tracker']['sharded']['num_inliers']}, loop votes="
          f"{r['ring']['sharded']['votes'][0]}, pgo chi={r['pgo']['sharded']['chi']:.4f}, "
          f"ba chi={r['ba']['sharded']['chi']:.4f}, meshed chunked SLAM: "
          f"{r['slam']['frames']} frames / {r['slam']['num_maps']} maps; every stage equals "
          f"its single-rank call - OK", flush=True)
    return reports


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1:
        dryrun_multichip(int(sys.argv[1]))
    else:
        fn, args = entry()
        _, stats, _ = fn(*args)
        print("entry(): ran one track_step, inliers =", int(stats.num_inliers))
