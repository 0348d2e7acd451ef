"""Rendered stereo and RGB-D sequences: a textured room and a known trajectory.

Port of srrg2_proslam_tpu/io/synthetic.py.  A closed rectangular circuit
(or an out-and-back walk) inside a room of textured planes (ground + four
walls) gives real stereo images with exact ground-truth poses and dense
left-camera depth, so the whole SLAM path (FAST/BRIEF, epipolar matching,
tracker, splits, loop closure, relocalisation, PGO) can run on images
without a dataset.

The renderer is batched torch over the planes: per pixel a ray/plane
intersection for every plane at once ([P, H, W]), a z-buffer argmin, and a
bilinear wrapping texture lookup; ``supersample`` renders at S x the
resolution and box-filters.  The textures come from the same numpy recipe
and seed as the JAX package's, so both render the same room.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.pinhole import Camera
from .datasets import RGBDFrame, StereoFrame


class PlaneSet(NamedTuple):
    """Stacked textured quads: origin/edges in the world frame, [P, ...]."""

    origin: torch.Tensor    # [P, 3]
    e1: torch.Tensor        # [P, 3] unit edge direction 1
    e2: torch.Tensor        # [P, 3] unit edge direction 2
    ext1: torch.Tensor      # [P] extent along e1 (m)
    ext2: torch.Tensor      # [P] extent along e2 (m)
    tex: torch.Tensor       # [P, T, T] float32 texture (0..255)
    px_per_m: torch.Tensor  # [P] texture resolution on the surface


def synthetic_camera(rows: int = 480, cols: int = 640, baseline_m: float = 0.12,
                     fx: float = 450.0) -> Camera:
    return Camera(fx=fx, fy=fx, cx=cols / 2.0, cy=rows / 2.0,
                  rows=rows, cols=cols, baseline_px=fx * baseline_m,
                  range_min=0.1, range_max=120.0)


def _texture(rng: np.random.RandomState, size: int = 512) -> np.ndarray:
    """High-contrast multi-scale blocky texture (dense FAST corners)."""
    coarse = np.kron(rng.uniform(0, 255, (size // 8, size // 8)), np.ones((8, 8)))
    fine = np.kron(rng.uniform(0, 255, (size // 2, size // 2)), np.ones((2, 2)))
    return (0.65 * coarse + 0.35 * fine).astype(np.float32)


def make_room(seed: int = 0, size_x: float = 32.0, size_z: float = 24.0,
              wall_height: float = 5.0, ground_y: float = 1.6,
              tex_size: int = 512, device=torch.device("cuda")) -> PlaneSet:
    """A rectangular room: ground plane + 4 textured walls.

    World frame = the camera's at the trajectory start: x right, y down,
    z forward.  The ground is at y = +ground_y, walls rise to
    y = ground_y - wall_height; the room spans x in [-4, size_x - 4],
    z in [-4, size_z - 4].
    """
    rng = np.random.RandomState(seed)
    x0, x1 = -4.0, size_x - 4.0
    z0, z1 = -4.0, size_z - 4.0
    y_top = ground_y - wall_height
    planes = []

    def add(origin, e1, ext1, e2, ext2, ppm):
        planes.append((np.asarray(origin, np.float32), np.asarray(e1, np.float32),
                       np.asarray(e2, np.float32), np.float32(ext1), np.float32(ext2),
                       _texture(rng, tex_size), np.float32(ppm)))

    add([x0, ground_y, z0], [1, 0, 0], x1 - x0, [0, 0, 1], z1 - z0, 24.0)   # ground
    # walls: e2 points down from the top, so textures start at the top
    add([x0, y_top, z0], [1, 0, 0], x1 - x0, [0, 1, 0], wall_height, 24.0)  # near z0
    add([x0, y_top, z1], [1, 0, 0], x1 - x0, [0, 1, 0], wall_height, 24.0)  # far z1
    add([x0, y_top, z0], [0, 0, 1], z1 - z0, [0, 1, 0], wall_height, 24.0)  # left x0
    add([x1, y_top, z0], [0, 0, 1], z1 - z0, [0, 1, 0], wall_height, 24.0)  # right x1
    return PlaneSet(*(torch.as_tensor(np.stack([p[k] for p in planes]), device=device)
                      for k in range(7)))


def render_view(cam: Camera, T_wc: torch.Tensor, planes: PlaneSet,
                supersample: int = 1):
    """Render one pinhole view from T_wc [4, 4] (world -> camera).

    Returns (image [H, W] float32 0..255, depth [H, W] float32 meters,
    +inf where no surface is hit).  With ``supersample`` S the view renders
    at S x the resolution; the image is the SxS block mean and the depth
    the block minimum.
    """
    S = supersample
    H, W = cam.rows * S, cam.cols * S
    dev = T_wc.device
    u = ((torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / S - 0.5 - cam.cx) / cam.fx
    v = ((torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / S - 0.5 - cam.cy) / cam.fy
    d = torch.stack([u[None, :].expand(H, W), v[:, None].expand(H, W),
                     torch.ones((H, W), dtype=torch.float32, device=dev)], dim=-1)
    R, t = T_wc[:3, :3], T_wc[:3, 3]
    # every plane at once: [P, 3] in the camera frame, [P, H, W] per pixel
    o_c = planes.origin @ R.T + t
    e1_c = planes.e1 @ R.T
    e2_c = planes.e2 @ R.T
    n_c = torch.linalg.cross(e1_c, e2_c)
    denom = torch.einsum("hwk,pk->phw", d, n_c)
    num = (o_c * n_c).sum(-1)
    t_star = num[:, None, None] / torch.where(denom.abs() < 1e-9, 1e-9, denom)
    rel = t_star[..., None] * d - o_c[:, None, None, :]          # [P, H, W, 3]
    s1 = torch.einsum("phwk,pk->phw", rel, e1_c)
    s2 = torch.einsum("phwk,pk->phw", rel, e2_c)
    ext1, ext2, ppm = (a[:, None, None] for a in (planes.ext1, planes.ext2, planes.px_per_m))
    ok = (t_star > cam.range_min) & (s1 >= 0) & (s1 <= ext1) & (s2 >= 0) & (s2 <= ext2)
    # bilinear wrapping texture lookup
    T = planes.tex.shape[1]
    t1 = s1 * ppm - 0.5
    t2 = s2 * ppm - 0.5
    f1, f2 = torch.floor(t1), torch.floor(t2)
    a1, a2 = t1 - f1, t2 - f2
    i1 = f1.to(torch.int64) % T
    i2 = f2.to(torch.int64) % T
    j1, j2 = (i1 + 1) % T, (i2 + 1) % T
    flat = planes.tex.reshape(planes.tex.shape[0], -1)

    def tex(r, c):
        return torch.gather(flat, 1, (r * T + c).reshape(flat.shape[0], -1)).reshape(r.shape)

    vals = ((1 - a2) * ((1 - a1) * tex(i2, i1) + a1 * tex(i2, j1))
            + a2 * ((1 - a1) * tex(j2, i1) + a1 * tex(j2, j1)))
    depths = torch.where(ok, t_star, torch.inf)        # the ray's z is 1
    depth, best = depths.min(dim=0)                               # z-buffer
    img = torch.gather(vals, 0, best[None])[0]
    img = torch.where(torch.isfinite(depth), img, 0.0)
    if S > 1:
        img = img.reshape(cam.rows, S, cam.cols, S).mean(dim=(1, 3))
        depth = depth.reshape(cam.rows, S, cam.cols, S).amin(dim=(1, 3))
    return img, depth


def render_stereo(cam: Camera, T_wc: torch.Tensor, planes: PlaneSet,
                  supersample: int = 2):
    """A rectified stereo pair + left depth, rendered from the LEFT pose."""
    left, depth = render_view(cam, T_wc, planes, supersample)
    T_shift = torch.eye(4, dtype=torch.float32, device=T_wc.device)
    T_shift[0, 3] = -cam.baseline_m
    right, _ = render_view(cam, T_shift @ T_wc, planes, supersample)
    return left, right, depth


def _T_wc_from(pos, yaw):
    """World->camera from planar position + heading (y = camera down)."""
    fwd = np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    right = np.array([np.cos(yaw), 0.0, -np.sin(yaw)])
    down = np.array([0.0, 1.0, 0.0])
    T_cw = np.eye(4, dtype=np.float32)
    T_cw[:3, :3] = np.stack([right, down, fwd], axis=1)   # camera axes in world
    T_cw[:3, 3] = pos
    return np.linalg.inv(T_cw).astype(np.float32)


def loop_trajectory(side_a: float = 20.0, side_b: float = 10.0,
                    step_m: float = 0.35, turn_frames: int = 14,
                    extra_frames: int = 25, laps: int = 1) -> List[np.ndarray]:
    """Closed rectangular circuit with smooth 90-degree corner turns.

    World->camera transforms (left camera): start at the origin heading +z,
    walk the rectangle (side_a along z, side_b along x) ``laps`` times,
    then revisit the start plus ``extra_frames`` of overlap.
    """
    poses = []
    pos = np.array([0.0, 0.0, 0.0])
    yaw = 0.0
    for side in [side_a, side_b, side_a, side_b] * laps:
        for _ in range(int(round(side / step_m))):
            poses.append(_T_wc_from(pos, yaw))
            pos = pos + step_m * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
        for _ in range(turn_frames):
            poses.append(_T_wc_from(pos, yaw))
            yaw += (np.pi / 2) / turn_frames
    for _ in range(extra_frames):
        poses.append(_T_wc_from(pos, yaw))
        pos = pos + step_m * np.array([np.sin(yaw), 0.0, np.cos(yaw)])
    return poses


def out_and_back_trajectory(length_m: float = 14.0, step_m: float = 0.4,
                            turn_frames: int = 12,
                            overlap_frames: int = 12) -> List[np.ndarray]:
    """Out along +z, a 180-degree turn, back to the start, another turn, and
    the first outbound steps again (re-observing the oldest maps)."""
    poses = []
    pos = np.array([0.0, 0.0, 0.0])
    yaw = 0.0
    n = int(round(length_m / step_m))

    def walk(steps):
        nonlocal pos
        for _ in range(steps):
            poses.append(_T_wc_from(pos, yaw))
            pos = pos + step_m * np.array([np.sin(yaw), 0.0, np.cos(yaw)])

    def turn():
        nonlocal yaw
        for _ in range(2 * turn_frames):
            poses.append(_T_wc_from(pos, yaw))
            yaw += np.pi / (2 * turn_frames)

    walk(n)
    turn()
    walk(n)
    turn()
    walk(overlap_frames)
    return poses


def crush_exposure(image, strength: float = 0.985):
    """An exposure blow-out: contrast collapsed below the FAST threshold."""
    return 128.0 + (image - 128.0) * (1.0 - strength)


def iter_rendered_loop(count: Optional[int] = None, seed: int = 0, rows: int = 480,
                       cols: int = 640, side_a: float = 20.0, side_b: float = 10.0,
                       step_m: float = 0.35, turn_frames: int = 14, fx: float = 450.0,
                       laps: int = 1, device=torch.device("cuda")) -> Iterator[StereoFrame]:
    """Rendered closed-loop stereo sequence with GT poses (camera in world).

    Frames render on ``device``; ``left``/``right`` are float32 tensors
    there, ``gt_pose`` a numpy 4x4.
    """
    cam = synthetic_camera(rows, cols, fx=fx)
    planes = make_room(seed=seed, size_x=side_b + 12.0, size_z=side_a + 12.0,
                       device=device)
    poses = loop_trajectory(side_a, side_b, step_m, turn_frames, laps=laps)
    if count is not None:
        poses = poses[:count]
    for i, T_wc in enumerate(poses):
        left, right, _ = render_stereo(cam, torch.as_tensor(T_wc, device=device), planes)
        yield StereoFrame(timestamp=0.1 * i, left=left, right=right,
                          gt_pose=np.linalg.inv(T_wc).astype(np.float32))


def depth_to_raw_mm(depth: torch.Tensor) -> torch.Tensor:
    """Rendered depth in metres -> raw millimetres as an RGB-D sensor gives
    them (the adaptor's default ``depth_scale`` 1e-3), 0 where no plane
    is hit."""
    return torch.where(torch.isfinite(depth), depth * 1000.0, 0.0)


def iter_rendered_loop_rgbd(count: Optional[int] = None, seed: int = 0, rows: int = 480,
                            cols: int = 640, side_a: float = 20.0, side_b: float = 10.0,
                            step_m: float = 0.35, turn_frames: int = 14, fx: float = 450.0,
                            laps: int = 1,
                            device=torch.device("cuda")) -> Iterator[RGBDFrame]:
    """:func:`iter_rendered_loop` as RGB-D frames: the left view (the same
    render, supersample 2) as intensity and its depth as raw millimetres."""
    cam = synthetic_camera(rows, cols, fx=fx)
    planes = make_room(seed=seed, size_x=side_b + 12.0, size_z=side_a + 12.0,
                       device=device)
    poses = loop_trajectory(side_a, side_b, step_m, turn_frames, laps=laps)
    if count is not None:
        poses = poses[:count]
    for i, T_wc in enumerate(poses):
        image, depth = render_view(cam, torch.as_tensor(T_wc, device=device), planes, 2)
        yield RGBDFrame(timestamp=0.1 * i, intensity=image, depth=depth_to_raw_mm(depth),
                        gt_pose=np.linalg.inv(T_wc).astype(np.float32))


def sparse_stereo_gt(cam: Camera, depth: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Exact disparity per keypoint from the rendered left depth [H, W]:
    baseline_px / depth at the rounded pixel of each uv [N, 2] -> [N]
    float32 (inf where there is no surface)."""
    y = np.clip(np.round(uv[:, 1]).astype(int), 0, depth.shape[0] - 1)
    x = np.clip(np.round(uv[:, 0]).astype(int), 0, depth.shape[1] - 1)
    return (cam.baseline_px / depth[y, x]).astype(np.float32)
