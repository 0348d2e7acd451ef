"""The port's diagnostics — scripts/diag_rendered_torch.py and
diag_turn_torch.py — == their JAX twins, on the CPU (their configs are
checked in tests/test_torch_tools_e2e.py).

* ``diag_rendered``: part 1's printout at frames 0, 60 and 75, and part
  2's trace over 8 frames (the timing columns left out);
* ``diag_turn``: one small cache (the port's ``rebuild`` at frame 1) swept
  by both packages: the same keys, the printouts agree, and every round's
  remaining pose error within 1e-5.
"""
import os
import runpy
import types

import numpy as np
import torch

torch.set_num_threads(1)

from torch_printout import captured, run_as_main  # noqa: E402
from test_torch_tools_e2e import CPU, SCRIPTS, _agree  # noqa: E402


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
