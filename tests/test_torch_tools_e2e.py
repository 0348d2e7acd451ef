"""The port's rendered-sequence tools — scripts/rendered_e2e_torch.py,
diag_rendered_torch.py and diag_turn_torch.py — == their JAX twins, on
the CPU.

* ``rendered_e2e --frames 8``: the printouts agree (counts exactly, floats
  within one printed unit; the timing line left out) and the trajectory
  errors within 1e-4 m (rotation 1e-4 rad): each package renders its own
  images, and the renderers' seams differ by an ulp
  (tests/test_torch_slam.py);
* the camera and GraphSLAM config that ``rendered_e2e`` (under its
  flags), ``diag_rendered`` part 2 and ``diag_turn`` build equal JAX's
  (read where each builds its GraphSLAM);
* ``diag_rendered``: part 1's printout at frames 0, 60 and 75, and part
  2's trace over 8 frames (the timing columns left out);
* ``diag_turn``: one small cache (the port's ``rebuild`` at frame 1) swept
  by both packages: the same keys, the printouts agree, and every round's
  remaining pose error within 1e-5.
"""
import math
import os
import runpy
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch_printout import captured, printout_diff, run_as_main  # noqa: E402
from torch_twins import config_fields  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")
CPU = torch.device("cpu")


def _agree(out_t, out_j, skip=()):
    diff = printout_diff(out_t, out_j, skip=skip)
    assert not diff, "\n".join(diff)


def test_rendered_e2e_matches_jax(monkeypatch):
    import srrg2_proslam_tpu.metrics.trajectory as jtm

    got = []
    real = jtm.evaluate
    monkeypatch.setattr(jtm, "evaluate", lambda *a, **k: got.append(real(*a, **k)) or got[-1])
    _, out_j = run_as_main(os.path.join(SCRIPTS, "rendered_e2e.py"), ["--frames", "8"])
    port = runpy.run_path(os.path.join(SCRIPTS, "rendered_e2e_torch.py"))
    (slam, err), out_t = captured(port["main"], ["--frames", "8", "--device", "cpu"])
    _agree(out_t, out_j, skip=("wall=",))
    ref = got[0]
    assert (slam.num_maps, slam.num_closures) == (1, 0) and len(slam.trajectory()) == 8
    for key in ("mean_translation_rmse", "std_translation_rmse"):
        np.testing.assert_allclose(getattr(err, key), getattr(ref, key), atol=1e-4)
    assert abs(err.ate_rmse - ref.ate_rmse) <= 1e-4
    assert abs(err.mean_rotation_deg - ref.mean_rotation_deg) <= math.degrees(1e-4)


class _Built(Exception):
    """Raised by a recording GraphSLAM once it has its config."""


CONFIG_RUNS = {
    "rendered_e2e": ([], []),
    "rendered_e2e-idw-prior": (["--idw", "--prior", "2.5"],) * 2,
    "rendered_e2e-local-ba-open-loop": (["--local-ba", "--open-loop"],) * 2,
    "diag_rendered-part2": (["--part", "2", "--idw", "--prior", "1.0"],) * 2,
    "diag_turn": (["--rebuild", "--cache", "{tmp}/turn.npz"], ["--rebuild"]),
}


@pytest.mark.parametrize("run", list(CONFIG_RUNS))
def test_script_config_matches_jax(monkeypatch, tmp_path, run):
    import srrg2_proslam_tpu.models.slam as jslam
    import srrg2_proslam_tpu_torch.models.slam as tslam

    built = {}
    for tag, mod in (("t", tslam), ("j", jslam)):
        def recording(cam, config, *a, _tag=tag, **k):
            built[_tag] = (cam, config)
            raise _Built

        monkeypatch.setattr(mod, "GraphSLAM", recording)
    name = run.split("-")[0]
    port_flags, jax_flags = CONFIG_RUNS[run]
    for target, argv in ((f"{name}_torch.py", port_flags + ["--device", "cpu"]),
                         (f"{name}.py", jax_flags)):
        with pytest.raises(_Built):
            run_as_main(os.path.join(SCRIPTS, target), [a.format(tmp=tmp_path) for a in argv])
    assert built["t"][0]._asdict() == built["j"][0]._asdict()
    assert config_fields(built["t"][1]) == config_fields(built["j"][1])
    assert list(tmp_path.iterdir()) == []


# ---- the diagnostics ------------------------------------------------------------------

def test_diag_rendered_part1_matches_jax():
    port = runpy.run_path(os.path.join(SCRIPTS, "diag_rendered_torch.py"))
    _, out_t = run_as_main(os.path.join(SCRIPTS, "diag_rendered_torch.py"),
                           ["--part", "1", "--device", "cpu"])
    _, out_j = run_as_main(os.path.join(SCRIPTS, "diag_rendered.py"), ["--part", "1"])
    assert len(out_t) == 3 and port["PART1_FRAMES"] == (0, 60, 75)
    _agree(out_t, out_j)


# the trace's yaw error is arccos((trace(R) - 1) / 2) of float32 rotations:
# near zero one ulp of its argument (2^-24) moves it by 0.020 deg, so two
# runs whose poses differ by 1e-6 print it up to a few such steps apart
YAW_RESOLUTION_DEG = 0.05


def _split_trace(lines):
    """part 2's printout -> (the lines with the adapt_ms, track_ms and
    yaw_err columns taken out, the yaw_err column)."""
    out, yaw = [], []
    for ln in lines:
        f = ln.split()
        if f and f[0].isdigit() and len(f) == 11:
            ln = " ".join(f[:1] + f[3:7] + f[8:])
            yaw.append(float(f[7]))
        out.append(ln)
    return out, yaw


def test_diag_rendered_part2_matches_jax():
    argv = ["--part", "2", "--frames", "8"]
    _, out_t = run_as_main(os.path.join(SCRIPTS, "diag_rendered_torch.py"),
                           argv + ["--device", "cpu"])
    _, out_j = run_as_main(os.path.join(SCRIPTS, "diag_rendered.py"), argv)
    (rows_t, yaw_t), (rows_j, yaw_j) = _split_trace(out_t), _split_trace(out_j)
    assert len(yaw_t) == 2
    _agree(rows_t, rows_j, skip=("steady-state",))
    np.testing.assert_allclose(yaw_t, yaw_j, atol=YAW_RESOLUTION_DEG)


def test_diag_turn_sweep_matches_jax(tmp_path):
    cache = str(tmp_path / "turn.npz")
    port = runpy.run_path(os.path.join(SCRIPTS, "diag_turn_torch.py"))
    port["rebuild"](cache, frame=1, device=CPU)
    keys = {"arena_pos", "arena_desc", "arena_valid", "arena_nup", "meas_points",
            "meas_desc", "meas_valid", "X_pred", "X_gt", "velocity"}
    assert set(np.load(cache).files) == keys

    rows, out_t = captured(port["sweep"], cache, device=CPU)

    jax = runpy.run_path(os.path.join(SCRIPTS, "diag_turn.py"))
    sweep = jax["sweep"]
    se3 = sweep.__globals__["se3"]
    twists = []
    sweep.__globals__["CACHE"] = cache
    sweep.__globals__["se3"] = types.SimpleNamespace(
        **{k: getattr(se3, k) for k in dir(se3) if not k.startswith("__") and k != "log"},
        log=lambda T: twists.append(np.asarray(se3.log(T))) or twists[-1])
    _, out_j = captured(sweep)
    _agree(out_t, out_j)
    # twists[0] is the prediction's; then one per round, in CONFIGS order
    want = [(np.linalg.norm(tw[:3]), np.linalg.norm(tw[3:])) for tw in twists[1:]]
    got = [(r[4], r[5]) for name in port["CONFIGS"] for r in rows[name]]
    assert len(got) == len(want) == 15
    np.testing.assert_allclose(got, want, atol=1e-5)
