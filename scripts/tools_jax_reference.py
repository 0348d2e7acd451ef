#!/usr/bin/env python3
"""The JAX scripts' reference numbers that chip_smoke.py's phase 11 holds
the port's tools to on the card (its ``JAX_*`` constants).

Runs, on the CPU (``JAX_PLATFORMS=cpu``), the JAX package's
scripts/rendered_e2e.py (default loop), ab_local_ba.py,
ab_seeded_detection.py (with each variant's stereo matches and VO inliers
summed at its ``track_step``), ab_motion_envelopes.py's first regime
(maps read from ``run``) and diag_rendered.py's part 1, prints each
script's own output, and as its last line one JSON object with the
counts, the ATEs and the part-1 lines.  Needs jax; ~7 min on 8 CPU cores.

    JAX_PLATFORMS=cpu python3 scripts/tools_jax_reference.py
"""
import contextlib
import io
import json
import os
import runpy
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _script(name: str) -> dict:
    return runpy.run_path(os.path.join(ROOT, "scripts", f"{name}.py"))


def _echoed(fn, *args):
    """fn(*args) -> (result, printed lines), the lines echoed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    return result, lines


def _as_main(name: str, argv) -> list:
    old, sys.argv = sys.argv, [name] + list(argv)
    try:
        return _echoed(runpy.run_path, os.path.join(ROOT, "scripts", f"{name}.py"),
                       None, "__main__")[1]
    finally:
        sys.argv = old


def main():
    import numpy as np

    import srrg2_proslam_tpu.models.tracker as tracker

    ref = {}
    lines = _as_main("rendered_e2e", [])
    ref["rendered_e2e"] = [ln for ln in lines if ln.startswith(("maps=", "KITTI-gates"))]

    ab = _script("ab_local_ba")
    for enabled in (False, True):
        err, slam = ab["run"](enabled)
        ref[f"ab_local_ba_{enabled}"] = dict(
            counts=(slam.num_maps, slam.num_closures, slam.num_backstop_rejections),
            ate=float(err.ate_rmse), t_rmse=np.asarray(err.mean_translation_rmse).tolist())

    calls, real = [], tracker.track_step

    def counting(state, pts, desc, valid, *args, **kw):
        out = real(state, pts, desc, valid, *args, **kw)
        calls.append((int(np.asarray(valid).sum()), int(out[1].num_inliers)))
        return out

    tracker.track_step = counting
    try:
        lines = _as_main("ab_seeded_detection", [])
    finally:
        tracker.track_step = real
    for seeded in (False, True):
        mine = calls[int(seeded)::2]        # dense and seeded alternate per frame
        ref[f"ab_seeded_{seeded}"] = dict(
            counts=(len(mine), sum(c[0] for c in mine), sum(c[1] for c in mine)),
            recall=lines[1 + int(seeded)].split()[2])

    motion = _script("ab_motion_envelopes")
    scn = motion["SCENARIOS"]["turn15deg"]
    for vname, tweaks in motion["VARIANTS"].items():
        err, slam = motion["run"](scn, tweaks)
        ref[f"ab_motion_turn15deg_{vname}"] = dict(
            counts=(slam.num_maps, slam.num_closures, slam.num_relocalizations,
                    slam.num_backstop_rejections),
            ate=float(err.ate_rmse), t_rmse=np.asarray(err.mean_translation_rmse).tolist())
        print(vname, ref[f"ab_motion_turn15deg_{vname}"], flush=True)

    ref["diag_rendered_part1"] = _as_main("diag_rendered", ["--part", "1"])
    print(json.dumps(ref), flush=True)


if __name__ == "__main__":
    main()
