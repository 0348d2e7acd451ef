"""The port's scripts/ab_motion_envelopes_torch.py == the JAX package's
scripts/ab_motion_envelopes.py, on the CPU, over a cut pose list.

``SCENARIOS`` and ``VARIANTS`` equal JAX's.  Each variant's ``run`` on the
15 deg/frame regime, cut to its first 10 poses in both packages and on the
JAX renderer's images (tests/torch_twins.py), builds the same camera and
GraphSLAM config (sub-pixel refinement on; inverse-depth weighting and the
smoother as the variant sets them) and gives equal maps, closures,
relocalizations and backstop rejections, with ATE and t-RMSE within 1e-4 m.
"""
import os
import runpy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch_twins import (  # noqa: E402
    config_fields, cut_loops, record_slam_args, share_renderer,
)

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")
PORT = runpy.run_path(os.path.join(SCRIPTS, "ab_motion_envelopes_torch.py"))
JAX = runpy.run_path(os.path.join(SCRIPTS, "ab_motion_envelopes.py"))


def test_scenarios_and_variants_match_jax():
    assert PORT["SCENARIOS"] == JAX["SCENARIOS"]
    assert PORT["VARIANTS"] == JAX["VARIANTS"]


@pytest.mark.parametrize("variant", list(JAX["VARIANTS"]))
def test_motion_envelope_run_matches_jax(monkeypatch, variant):
    share_renderer(monkeypatch)
    cut_loops(monkeypatch, 10)
    args_t = record_slam_args(monkeypatch, PORT["run"].__globals__)
    args_j = record_slam_args(monkeypatch, JAX["run"].__globals__)
    scn, tweaks = JAX["SCENARIOS"]["turn15deg"], JAX["VARIANTS"][variant]
    err_t, slam_t = PORT["run"](scn, tweaks, torch.device("cpu"))
    err_j, slam_j = JAX["run"](scn, tweaks)
    assert args_t[0][0]._asdict() == args_j[0][0]._asdict()
    assert config_fields(args_t[0][1]) == config_fields(args_j[0][1])
    counts = [(s.num_maps, s.num_closures, s.num_relocalizations, s.num_backstop_rejections)
              for s in (slam_t, slam_j)]
    assert counts[0] == counts[1] and counts[0][0] >= 2
    assert len(slam_t.trajectory()) == 10
    assert abs(err_t.ate_rmse - err_j.ate_rmse) <= 1e-4
    np.testing.assert_allclose(err_t.mean_translation_rmse, err_j.mean_translation_rmse,
                               atol=1e-4)
