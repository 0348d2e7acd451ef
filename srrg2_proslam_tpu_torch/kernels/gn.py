"""K2: one whole GN burst on the stereo factor (csrc/gn_burst.cu).

Replaces srrg2_proslam_tpu/ops/gn_pallas.py::gn_burst_stereo; the plain
version is ops/gn.py::gn_iterate over stereo_projective_system.  The kernel
solves with a prescaled LDL^T instead of the TPU kernel's f32 cofactor
Schur solve, which overflows for large H.

On the card the burst is bound by latency, not arithmetic (~270 flops per
active correspondence and iteration): one CTA loads the masked-in
correspondences once into registers and runs every iteration's block
reduction, solve and exp-compose with one barrier each, where the plain
version issues dozens of small launches per iteration and reads the stop
flag back to the host.
"""
from __future__ import annotations

import torch

from . import _build
from ..ops.gn import GNStats, gn_iterate, stereo_projective_system
from ..ops.pinhole import Camera

launches = 0


def gn_burst_stereo_plain(X0, pts_moving, meas_uvu, weights, mask, cam: Camera,
                          iterations: int, damping: float = 1e-6,
                          min_inliers: int = 6, epsilon: float = 0.0,
                          chi_threshold: float = 25.0):
    system = lambda X: stereo_projective_system(
        X, pts_moving, meas_uvu, weights, mask, cam, chi_threshold)
    return gn_iterate(system, X0, iterations, damping=damping,
                      min_inliers=min_inliers, epsilon=epsilon)


def gn_burst_stereo(X0, pts_moving, meas_uvu, weights, mask, cam: Camera,
                    iterations: int, damping: float = 1e-6,
                    min_inliers: int = 6, epsilon: float = 0.0,
                    chi_threshold: float = 25.0):
    """GN burst: X0 [4,4], pts [C,3], meas (uL, vL, uR) [C,3], weights [C],
    mask [C] bool -> (X [4,4], GNStats)."""
    global launches
    C = pts_moving.shape[0]
    shapes = {"X0": (X0, (4, 4), torch.float32),
              "pts_moving": (pts_moving, (C, 3), torch.float32),
              "meas_uvu": (meas_uvu, (C, 3), torch.float32),
              "weights": (weights, (C,), torch.float32),
              "mask": (mask, (C,), torch.bool)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"gn_burst: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not X0.is_cuda:
        return gn_burst_stereo_plain(X0, pts_moving, meas_uvu, weights, mask,
                                     cam, iterations, damping, min_inliers,
                                     epsilon, chi_threshold)
    for name, (t, _, _) in shapes.items():
        if t.device != X0.device or not t.is_contiguous():
            raise ValueError(f"gn_burst: {name} must be contiguous on {X0.device}")
    # X [16] and chi_total as float32, then num_inliers and num_terms as int32
    out = torch.empty(19, dtype=torch.float32, device=X0.device)
    lib = _build.library()
    err = lib.gn_burst_stereo_launch(
        X0.data_ptr(), pts_moving.data_ptr(), meas_uvu.data_ptr(),
        weights.data_ptr(), mask.data_ptr(), out.data_ptr(), C, int(iterations),
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
        float(cam.baseline_px), float(cam.range_min), float(chi_threshold),
        float(damping), float(epsilon), int(min_inliers),
        torch.cuda.current_stream(X0.device).cuda_stream)
    _build.check(err, "gn_burst_stereo_launch")
    launches += 1
    counts = out[17:].view(torch.int32)
    stats = GNStats(chi_total=out[16], num_inliers=counts[0], num_terms=counts[1])
    return out[:16].view(4, 4), stats
