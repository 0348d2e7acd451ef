"""Dataset converter: raw dataset folders -> a packed frame cache or a
BOSS message log.  The port's twin of apps/convert_dataset.py.

``--format npz`` (default) decodes every frame once (the native decoder
and its prefetcher) and packs them into one uncompressed ``.npz`` of
uint8/uint16 stacks (``timestamps``, ``images_a``, ``images_b``, and
``gt_poses`` and the rectified ``camera`` where the dataset has them) that
loads without decoding an image; ``--format boss`` writes the reference's
``messages.json`` log (stereo only).

    python -m srrg2_proslam_tpu_torch.apps.convert_dataset --dataset kitti \
        --sequence <dir> [--gt poses.txt] [--count N] --output frames.npz
    python -m srrg2_proslam_tpu_torch.apps.convert_dataset --dataset kitti \
        --sequence <dir> --format boss --output messages.json
"""
import argparse
import os

import numpy as np

from ..io import datasets


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srrg2_proslam_tpu_torch.apps.convert_dataset")
    ap.add_argument("--dataset", required=True,
                    choices=["kitti", "tum", "icl", "euroc", "malaga"])
    ap.add_argument("--sequence", required=True)
    ap.add_argument("--gt", default=None)
    ap.add_argument("--count", type=int, default=None)
    ap.add_argument("--output", required=True)
    ap.add_argument("--format", default="npz", choices=["npz", "boss"],
                    help="npz = packed frame cache; boss = reference-style "
                         "BOSS messages.json log (stereo only)")
    args = ap.parse_args(argv)

    rgbd = args.dataset in ("tum", "icl")
    if args.format == "boss":
        if rgbd:
            raise SystemExit("BOSS export currently supports stereo only")
        from ..io import boss

        if args.dataset == "kitti":
            frames = datasets.iter_kitti_odometry(args.sequence, args.gt,
                                                  count=args.count)
            # probe the first frame for the image size
            frames = list(frames)
            cam = datasets.kitti_camera(*frames[0].left.shape)
        elif args.dataset == "euroc":
            frames = list(datasets.iter_euroc_stereo(args.sequence,
                                                     count=args.count))
            cam = datasets.euroc_rectified_camera(args.sequence)
        else:
            frames = list(datasets.iter_malaga_stereo(args.sequence,
                                                      count=args.count))
            cam = datasets.malaga_camera()
        n = boss.write_boss_stereo(args.output, frames, cam)
        print(f"wrote {n} BOSS message triplets to {args.output}")
        return

    if args.dataset == "kitti":
        frames = datasets.iter_kitti_odometry(args.sequence, args.gt,
                                              count=args.count)
    elif rgbd:
        frames = datasets.iter_tum_rgbd(args.sequence, count=args.count)
    elif args.dataset == "euroc":
        frames = datasets.iter_euroc_stereo(args.sequence, count=args.count)
    else:
        frames = datasets.iter_malaga_stereo(args.sequence, count=args.count)

    stamps, a_imgs, b_imgs, gts = [], [], [], []
    for fr in frames:
        stamps.append(fr.timestamp)
        if rgbd:
            a_imgs.append(fr.intensity.astype(np.uint8))
            b_imgs.append(fr.depth.astype(np.uint16))
        else:
            a_imgs.append(fr.left.astype(np.uint8))
            b_imgs.append(fr.right.astype(np.uint8))
        if fr.gt_pose is not None:
            gts.append(fr.gt_pose)
        if len(stamps) % 200 == 0:
            print(f"converted {len(stamps)} frames")

    out = {
        "dataset": np.frombuffer(args.dataset.encode(), np.uint8),
        "rgbd": np.asarray(rgbd),
        "timestamps": np.asarray(stamps, np.float64),
        "images_a": np.stack(a_imgs),
        "images_b": np.stack(b_imgs),
    }
    if gts and len(gts) == len(stamps):
        out["gt_poses"] = np.stack(gts).astype(np.float32)
    # the camera model of the cached pixels: the EuRoC reader rectifies, so
    # the cache carries the rectified pinhole (and the body-from-rectified-
    # camera extrinsic), not the raw cam0 intrinsics
    if args.dataset == "euroc":
        from ..io.rectify import find_euroc_rectification

        rect = find_euroc_rectification(args.sequence)
        if rect is not None:
            c = rect.camera
            out["camera"] = np.asarray(
                [c.fx, c.fy, c.cx, c.cy, c.rows, c.cols, c.baseline_px,
                 c.range_min, c.range_max], np.float64)
            if rect.T_B_rect is not None:
                out["T_robot_sensor"] = np.asarray(rect.T_B_rect, np.float32)
    np.savez(args.output, **out)
    print(f"wrote {len(stamps)} frames to {args.output} "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")


def packed_camera(path):
    """Camera model recorded in a converted cache (None when absent).

    Returns (Camera, T_robot_sensor or None)."""
    from ..ops.pinhole import Camera

    data = np.load(path, mmap_mode="r")
    if "camera" not in data:
        return None, None
    c = np.asarray(data["camera"], np.float64)
    cam = Camera(fx=float(c[0]), fy=float(c[1]), cx=float(c[2]),
                 cy=float(c[3]), rows=int(c[4]), cols=int(c[5]),
                 baseline_px=float(c[6]), range_min=float(c[7]),
                 range_max=float(c[8]))
    T = (np.asarray(data["T_robot_sensor"], np.float32)
         if "T_robot_sensor" in data else None)
    return cam, T


def iter_packed(path):
    """Read a converted cache back as StereoFrame/RGBDFrame objects."""
    data = np.load(path, mmap_mode="r")
    rgbd = bool(data["rgbd"])
    gt = data["gt_poses"] if "gt_poses" in data else None
    for i, ts in enumerate(data["timestamps"]):
        if rgbd:
            yield datasets.RGBDFrame(
                timestamp=float(ts),
                intensity=np.asarray(data["images_a"][i], np.float32),
                depth=np.asarray(data["images_b"][i], np.float32),
                gt_pose=gt[i] if gt is not None else None,
            )
        else:
            yield datasets.StereoFrame(
                timestamp=float(ts),
                left=np.asarray(data["images_a"][i], np.float32),
                right=np.asarray(data["images_b"][i], np.float32),
                gt_pose=gt[i] if gt is not None else None,
            )


if __name__ == "__main__":
    main()
