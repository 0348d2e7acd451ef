"""The port's rendered-sequence tools — scripts/rendered_e2e_torch.py,
diag_rendered_torch.py and diag_turn_torch.py — == their JAX twins, on
the CPU (the diagnostics' runs in tests/test_torch_tools_diag.py, so that
each file stays under a minute alone).

* ``rendered_e2e --frames 8``: the printouts agree (counts exactly, floats
  within one printed unit; the timing line left out) and the trajectory
  errors within 1e-4 m (rotation 1e-4 rad): each package renders its own
  images, and the renderers' seams differ by an ulp
  (tests/test_torch_slam.py);
* the camera and GraphSLAM config that ``rendered_e2e`` (under its
  flags), ``diag_rendered`` part 2 and ``diag_turn`` build equal JAX's
  (read where each builds its GraphSLAM).
"""
import math
import os
import runpy

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
