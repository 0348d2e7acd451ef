#!/usr/bin/env python3
"""Time the GN burst kernel (K2) with 256 and with 512 threads per CTA.

Usage (one CUDA card; builds the kernel library twice from csrc/):

    python3 scripts/gn_threads_torch.py [--reps 20] [--rounds 2]

Builds the default library (GN_BURST_THREADS=256) and one with
-DGN_BURST_THREADS=512, checks both against the plain burst, and times
them in turns (256, 512, 512, 256 per round) as device time per call
(torch.profiler, as chip_smoke.py times kernels) on two inputs: frame 1's
round-0 correspondences of the bundled KITTI frames, as chip_smoke.py
forms them, and the same 1152 rows all masked in.  The last line is one
JSON object with every timing.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    from chip_smoke import GN_ATOL, device_ms, main_path_inputs
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.kernels import _build
    from srrg2_proslam_tpu_torch.kernels.gn import gn_burst_stereo, gn_burst_stereo_plain
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    libs = {256: _build.library(), 512: _build.build(("-DGN_BURST_THREADS=512",))}
    for line in _build.build_log.splitlines():
        if "gn_burst" in line or "registers" in line or "spill" in line:
            print(f"  ptxas (512): {line.strip()}")

    dev = torch.device("cuda:0")
    frames_np = list(datasets.iter_bundled_kitti(os.path.join(ROOT, "test_data"), "city"))
    cam = datasets.kitti_camera(*frames_np[0].left.shape)
    frames = [(torch.from_numpy(f.left).to(dev), torch.from_numpy(f.right).to(dev))
              for f in frames_np[:2]]
    inp = main_path_inputs(frames, cam, StereoAdaptorConfig(), TrackerConfig())
    X0, pts, meas, w, mask, cam = inp["gn_args"]
    kw = inp["gn_kw"]
    cases = {"kitti_frame1_round0": (X0, pts, meas, w, mask, cam),
             "all_rows_active": (X0, pts, meas, w, torch.ones_like(mask), cam)}

    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "cases": {}}
    for case, gn_args in cases.items():
        Xp, sp = gn_burst_stereo_plain(*gn_args, **kw)
        times = {256: [], 512: []}
        for threads in (256, 512):
            _build._lib = libs[threads]
            Xk, sk = gn_burst_stereo(*gn_args, **kw)
            err = float((Xk - Xp).abs().max())
            if not (err <= GN_ATOL and int(sk.num_terms) == int(sp.num_terms)):
                raise SystemExit(f"{case}: {threads} threads disagree with the plain "
                                 f"burst (X err {err}, terms {int(sk.num_terms)}/"
                                 f"{int(sp.num_terms)})")
        for _ in range(args.rounds):
            for threads in (256, 512, 512, 256):
                _build._lib = libs[threads]
                times[threads].append(device_ms(lambda: gn_burst_stereo(*gn_args, **kw),
                                                reps=args.reps,
                                                kernel="gn_burst_stereo_kernel"))
        result["cases"][case] = {"active": int(gn_args[4].sum()),
                                 "ms_per_call": {str(t): v for t, v in times.items()}}
        print(f"{case}: active {int(gn_args[4].sum())}; device ms/call "
              f"256 threads {times[256]}, 512 threads {times[512]} [{smi}]", flush=True)
    _build._lib = libs[256]
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
