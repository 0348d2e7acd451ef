#!/usr/bin/env python3
"""Dissect the turn-onset alignment failure with the PyTorch port, the
twin of scripts/diag_turn.py (a developer tool).

``rebuild`` runs GraphSLAM over the default rendered loop up to frame 58,
and caches the tracker state, frame 58's measurements, the predicted and
the ground-truth pose; ``sweep`` then runs matcher schedules on that frame
(three rounds of ``match_projective`` and five ``gn_step`` each) with
ground-truth supervision and prints, per round, the stage, the matches,
the correct ones, the inliers and the remaining pose error.  The cache
holds the JAX script's keys, so either package's cache can be swept by
the other.  Same printed lines as the JAX script, plus ``--device``
(default ``cuda``) and ``--cache`` (default in the port's git-ignored
build/ folder).

    python3 scripts/diag_turn_torch.py [--rebuild] [--cache PATH] [--device cuda|cpu]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as syn  # noqa: E402
from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.models.slam import (  # noqa: E402
    GraphSLAM, GraphSLAMConfig, SplittingConfig,
)
from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import se3  # noqa: E402
from srrg2_proslam_tpu_torch.ops.gn import gn_step, stereo_projective_system  # noqa: E402
from srrg2_proslam_tpu_torch.ops.matching import (  # noqa: E402
    ProjectiveMatcherConfig, match_projective,
)
from srrg2_proslam_tpu_torch.ops.pinhole import project  # noqa: E402

CACHE = os.path.join(ROOT, "srrg2_proslam_tpu_torch", "build", "diag_turn_state.npz")
TURN_FRAME = 58

CONFIGS = {
    "baseline r(10,25,50) d(25,50,75)": ProjectiveMatcherConfig(),
    "flipped  r(10,25,50) d(75,50,25)": ProjectiveMatcherConfig(
        descriptor_stages=(75.0, 50.0, 25.0)),
    "wide-flip r(10,25,90) d(75,50,25)": ProjectiveMatcherConfig(
        radius_stages=(10.0, 25.0, 90.0), descriptor_stages=(75.0, 50.0, 25.0)),
    "wide-strict r(10,30,90) d(50,35,20)": ProjectiveMatcherConfig(
        radius_stages=(10.0, 30.0, 90.0), descriptor_stages=(50.0, 35.0, 20.0)),
    "wide-vstrict r(10,30,90) d(40,25,15)": ProjectiveMatcherConfig(
        radius_stages=(10.0, 30.0, 90.0), descriptor_stages=(40.0, 25.0, 15.0)),
}


def rebuild(cache=CACHE, frame=TURN_FRAME, device=torch.device("cuda")):
    """GraphSLAM over the loop's frames before ``frame``, then cache the
    tracker state and frame ``frame``'s measurements and poses."""
    config = GraphSLAMConfig(
        tracker=TrackerConfig(),
        splitting=SplittingConfig(maximum_translation_m=5.0, maximum_rotation_rad=0.35),
        loop=LoopDetectorConfig(minimum_age_difference=5),
        arena_capacity=4096, database_capacity=16384,
        max_db_descriptors_per_map=512,
    )
    cam = syn.synthetic_camera()
    slam = GraphSLAM(cam, config, model="stereo", device=device)
    acfg = StereoAdaptorConfig()
    frames = []
    for n, fr in enumerate(syn.iter_rendered_loop(count=frame + 1, device=device)):
        frames.append(fr)
        if n == frame:
            break
        meas = adapt_stereo(fr.left, fr.right, acfg)
        slam.process(meas.points, meas.desc, meas.valid, fr.timestamp)

    fr = frames[frame]
    state = slam.tracker_state
    meas = adapt_stereo(fr.left, fr.right, acfg)
    T_prev = np.linalg.inv(frames[frame - 1].gt_pose)
    T_cur = np.linalg.inv(frames[frame].gt_pose)
    delta_gt = T_cur @ np.linalg.inv(T_prev)
    X_prev = se3.inverse(state.T_lm_robot).cpu().numpy()
    X_gt = delta_gt @ X_prev
    T_pred = (state.T_lm_robot @ se3.exp(state.velocity)).cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(cache)), exist_ok=True)
    arena = state.arena
    np.savez(cache,
             arena_pos=arena.pos.cpu().numpy(),
             arena_desc=arena.desc.cpu().numpy(),
             arena_valid=arena.valid.cpu().numpy(),
             arena_nup=arena.num_updates.cpu().numpy(),
             meas_points=meas.points.cpu().numpy(),
             meas_desc=meas.desc.cpu().numpy(),
             meas_valid=meas.valid.cpu().numpy(),
             X_pred=np.linalg.inv(T_pred), X_gt=X_gt,
             velocity=state.velocity.cpu().numpy())
    print("cached state to", cache)


def sweep(cache=CACHE, device=torch.device("cuda")):
    """Every schedule of CONFIGS on the cached frame -> {name: [(stage,
    matches, correct, inliers, |t err|, |r err|) per round]} (also
    printed)."""
    cam = syn.synthetic_camera()
    d = np.load(cache)

    def t(key, dtype=None):
        return torch.as_tensor(d[key], dtype=dtype, device=device)

    pos, desc, valid = t("arena_pos"), t("arena_desc"), t("arena_valid")
    weights_all = 1.0 + torch.log1p(t("arena_nup").to(torch.float32))
    meas_uv = t("meas_points")[:, :2]
    gn_meas = t("meas_points")[:, :3]
    mdesc, mvalid = t("meas_desc"), t("meas_valid")
    X_pred = t("X_pred", torch.float32)
    X_gt = t("X_gt", torch.float32)
    print("pred-gt twist:", se3.log(X_gt @ se3.inverse(X_pred)).cpu().numpy().round(4))

    out = {}
    for name, mcfg in CONFIGS.items():
        X = X_pred
        n_stages = len(mcfg.radius_stages)
        print(f"\n== {name}")
        out[name] = []
        for r in range(3):
            pts_sensor = se3.transform_points(X, pos)
            proj_uv, in_view = project(cam, pts_sensor)
            proj_valid = valid & in_view
            matches, stage = match_projective(
                meas_uv, mdesc, mvalid, proj_uv, desc, proj_valid, mcfg,
                force_stage=-1 if r == 2 else max(n_stages - 1 - r, 0))
            uv_gt, _ = project(cam, se3.transform_points(X_gt, pos))
            idxj = torch.clamp_min(matches.idx, 0).long()
            mk = matches.mask.cpu().numpy()
            err_px = np.linalg.norm(meas_uv.cpu().numpy() - uv_gt.cpu().numpy()[idxj.cpu().numpy()],
                                    axis=1)
            good = mk & (err_px < 3.0)
            pm = pos[idxj]
            w = weights_all[idxj]
            for _ in range(5):
                H, b, stats = stereo_projective_system(X, pm, gn_meas, w, matches.mask, cam, 25.0)
                X = gn_step(X, H, b, 1e-6)
            tw = se3.log(X_gt @ se3.inverse(X)).cpu().numpy()
            row = (int(stage), int(mk.sum()), int(good.sum()), int(stats.num_inliers),
                   float(np.linalg.norm(tw[:3])), float(np.linalg.norm(tw[3:])))
            out[name].append(row)
            print(f" round{r} stage={row[0]} m={row[1]:4d} "
                  f"correct={row[2]:4d} ({row[2]/max(row[1],1):.2f}) "
                  f"-> inl={row[3]:4d} t_err={row[4]:.4f} r_err={row[5]:.4f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rebuild", action="store_true")
    ap.add_argument("--cache", default=CACHE)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if args.rebuild or not os.path.exists(args.cache):
        rebuild(args.cache, device=device)
    sweep(args.cache, device=device)


if __name__ == "__main__":
    main()
