#!/usr/bin/env python3
"""Smoke test of the PyTorch port: RGB-D tracking on the bundled ICL
frames, the twin of scripts/smoke_rgbd.py.

Checks the estimated frame-0 -> frame-1 motion against the ground-truth
poses the reference fixture pins (fixtures.hpp:597-615), through
adapt_rgbd -> GraphSLAM(model="rgbd"): within 5e-3 m per axis and 0.01
rad.  Same printed lines and verdict as the JAX script, plus ``--device``
(default ``cuda``).

    python3 scripts/smoke_rgbd_torch.py [--device cuda|cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.io.quaternions import quaternion_to_rotation  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import DepthAdaptorConfig, adapt_rgbd  # noqa: E402
from srrg2_proslam_tpu_torch.models.slam import GraphSLAM, GraphSLAMConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import se3  # noqa: E402

GATE_T = 5e-3       # m per axis
GATE_ANGLE = 0.01   # rad


def _pose(t, q_wxyz):
    T = np.eye(4, dtype=np.float32)
    w, x, y, z = q_wxyz
    T[:3, :3] = quaternion_to_rotation(np.array([x, y, z, w]))
    T[:3, 3] = t
    return T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = torch.device(ap.parse_args(argv).device)

    frames = list(datasets.iter_bundled_icl(os.path.join(ROOT, "test_data")))
    cam = datasets.icl_camera()
    slam = GraphSLAM(cam, GraphSLAMConfig(), model="rgbd", device=device)
    acfg = DepthAdaptorConfig()

    for i, fr in enumerate(frames[:2]):
        m = adapt_rgbd(torch.as_tensor(fr.intensity, device=device),
                       torch.as_tensor(fr.depth, device=device), acfg)
        stats = slam.process(m.points, m.desc, m.valid, float(i))
        print(f"frame {i}: meas={int(stats.num_measurements)} "
              f"inliers={int(stats.num_inliers)} map={int(slam.current_local_map().count)}")

    T_w_c0 = _pose([0.0, 0.0, -2.25], [1, 0, 0, 0])
    T_w_c1 = _pose([0.000466347, 0.00895357, -2.24935],
                   [0.999999, -0.00101358, 0.00052453, -0.000231475])
    gt = np.linalg.inv(T_w_c0) @ T_w_c1
    est = slam.robot_in_world()
    t_err, ang = se3.error_t_and_angle(torch.as_tensor(est.astype(np.float32)),
                                       torch.as_tensor(gt))
    print("per-axis |t err|:", t_err.numpy().round(5), "angle:", float(ang))
    ok = np.all(t_err.numpy() <= GATE_T) and float(ang) <= GATE_ANGLE
    print("PASS" if ok else "FAIL")


if __name__ == "__main__":
    main()
