"""The port's A/B scripts — scripts/ab_local_ba_torch.py,
ab_seeded_detection_torch.py and ab_motion_envelopes_torch.py — == their
JAX twins, on the CPU, over a cut pose list (one file each, so that each
stays under a minute alone and they spread over the test workers).

``loop_trajectory`` is cut to its first poses in both packages' synthetic
modules (the same patch on each side), so each script's ``run`` walks the
start of its loop at the script's own widths (320x416) and config, and
both packages see the JAX renderer's images (tests/torch_twins.py):

* ``ab_local_ba.run`` with local BA off and on: the GraphSLAM config and
  camera equal JAX's, maps / closures / relocalizations / backstop
  rejections equal, ATE within 1e-4 m;
* ``ab_seeded_detection`` (tests/test_torch_tools_seeded.py);
* ``ab_motion_envelopes.run`` (tests/test_torch_tools_motion.py).
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
CPU = torch.device("cpu")


def counts(slam):
    return (slam.num_maps, slam.num_closures, slam.num_relocalizations,
            slam.num_backstop_rejections)


@pytest.mark.parametrize("local_ba", [False, True], ids=["off", "on"])
def test_ab_local_ba_run_matches_jax(monkeypatch, local_ba):
    share_renderer(monkeypatch)
    cut_loops(monkeypatch, 12)
    port = runpy.run_path(os.path.join(SCRIPTS, "ab_local_ba_torch.py"))
    jax = runpy.run_path(os.path.join(SCRIPTS, "ab_local_ba.py"))
    args_t = record_slam_args(monkeypatch, port["run"].__globals__)
    args_j = record_slam_args(monkeypatch, jax["run"].__globals__)
    err_t, slam_t = port["run"](local_ba, CPU)
    err_j, slam_j = jax["run"](local_ba)
    assert args_t[0][0]._asdict() == args_j[0][0]._asdict()
    assert config_fields(args_t[0][1]) == config_fields(args_j[0][1])
    assert args_t[0][1].local_ba.enabled == local_ba
    assert counts(slam_t) == counts(slam_j) and slam_t.num_maps >= 2
    assert len(slam_t.trajectory()) == 12
    assert abs(err_t.ate_rmse - err_j.ate_rmse) <= 1e-4
    np.testing.assert_allclose(err_t.mean_translation_rmse, err_j.mean_translation_rmse,
                               atol=1e-4)
