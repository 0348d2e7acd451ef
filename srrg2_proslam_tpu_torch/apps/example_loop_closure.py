"""Didactic example: the loop-closure subsystem in isolation.

The port's twin of apps/example_loop_closure.py (the reference's
test_loop_closing.cpp walkthrough): build a descriptor database from two
synthetic local maps, query a revisit of map 0 under a known SE3 offset,
and print the vote histogram, the per-candidate validation (inliers / chi
/ ratio against the acceptance gates) and the recovered transform against
ground truth.  The data come from ``np.random.RandomState(0)`` drawn in
the JAX app's order, so both packages see the same descriptors and
points.  Same printed lines as the JAX app, plus ``--device`` (default
``cuda``).

    python -m srrg2_proslam_tpu_torch.apps.example_loop_closure [--device cuda|cpu]
"""
import argparse

import numpy as np
import torch

from ..models import loop_closure
from ..ops import se3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    def on_device(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rng = np.random.RandomState(0)
    cfg = loop_closure.LoopDetectorConfig(minimum_age_difference=1)
    db = loop_closure.empty_database(4096, device=device)
    ones = lambda n: torch.ones(n, dtype=torch.bool, device=device)

    # two old local maps with random 256-bit descriptors
    pts0 = rng.uniform(-5, 5, (200, 3)).astype(np.float32) + [0, 0, 10]
    desc0 = rng.choice(np.array([-1, 1], np.int8), size=(200, 256))
    db = loop_closure.add_local_map(db, on_device(desc0), on_device(pts0, torch.float32),
                                    ones(200), 0)
    desc1 = rng.choice(np.array([-1, 1], np.int8), size=(150, 256))
    db = loop_closure.add_local_map(
        db, on_device(desc1),
        on_device(rng.uniform(-5, 5, (150, 3)).astype(np.float32)), ones(150), 1)
    print(f"database: {int(db.valid.sum())} descriptors from 2 maps")

    # the query map re-observes map 0's landmarks, displaced by a known SE3
    # and with 5 descriptor bits flipped (sensor noise)
    T_gt = se3.exp(torch.tensor([0.5, -0.2, 1.0, 0.02, -0.01, 0.05],
                                dtype=torch.float32)).numpy()
    q_desc = desc0.copy()
    for i in range(200):
        idx = rng.choice(256, size=5, replace=False)
        q_desc[i, idx] = -q_desc[i, idx]
    q_pts = pts0 @ np.linalg.inv(T_gt)[:3, :3].T + np.linalg.inv(T_gt)[:3, 3]

    result = loop_closure.query(on_device(q_desc), ones(200), 5, db, cfg, num_maps=8)
    print("candidate maps:", result.candidate_maps.cpu().numpy())
    print("votes:         ", result.votes.cpu().numpy())

    K = int(result.candidate_maps.shape[0])
    T_init = torch.eye(4, dtype=torch.float32, device=device).repeat(K, 1, 1)
    closures = loop_closure.validate_batch(on_device(q_pts, torch.float32), result,
                                           T_init, cfg)
    for k in range(K):
        cand = int(result.candidate_maps[k])
        if cand < 0:
            continue
        print(f"candidate map {cand}: inliers="
              f"{int(closures.num_inliers[k])} "
              f"chi/inl={float(closures.chi_per_inlier[k]):.3f} "
              f"ratio={float(closures.inlier_ratio[k]):.2f} "
              f"accepted={bool(closures.accepted[k])} "
              f"(gates: >={cfg.relocalize_min_inliers} inl, "
              f"<={cfg.relocalize_max_chi_inliers} chi, "
              f">={cfg.relocalize_min_inliers_ratio} ratio)")
        if bool(closures.accepted[k]):
            T_est = closures.T_query_in_ref[k].cpu().numpy()
            err = se3.log(torch.as_tensor(np.linalg.inv(T_est) @ T_gt)).numpy()
            print(f"  recovered T error: |t|={np.linalg.norm(err[:3]):.4f} m"
                  f" |r|={np.linalg.norm(err[3:]):.5f} rad")


if __name__ == "__main__":
    main()
