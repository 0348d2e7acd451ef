"""The port's A/B scripts — scripts/ab_local_ba_torch.py,
ab_seeded_detection_torch.py and ab_motion_envelopes_torch.py — == their
JAX twins, on the CPU, over a cut pose list.

``loop_trajectory`` is cut to its first poses in both packages' synthetic
modules (the same patch on each side), so each script's ``run`` walks the
start of its loop at the script's own widths (320x416) and config, and
both packages see the JAX renderer's images (tests/torch_twins.py):

* ``ab_local_ba.run`` with local BA off and on, over 12 poses: the
  GraphSLAM config and camera equal JAX's, maps / closures /
  relocalizations / backstop rejections equal, ATE within 1e-4 m;
* ``ab_seeded_detection`` over the first 26 poses, the contrast-crushed
  frames 24 and 25 included.  The landmark arena is cut from the scripts'
  4096 slots to 2048 in both packages: insertion takes the lowest free
  slots and drops only what does not fit, and no frame comes near that
  (the live landmarks plus the frame's measurements stay within 2048,
  checked), so every frame's result is the one at 4096 and the projective
  matcher's cost matrices are half as wide.  Every frame's stereo matches
  and VO inliers of both variants (dense and seeded detection) are equal,
  read at each side's ``track_step``, and the printed table agrees within
  one printed unit (recall included).  Both scripts run once; each
  variant's frames and table row are a case of their own;
* ``ab_motion_envelopes``: ``SCENARIOS`` and ``VARIANTS`` equal JAX's.
  Each variant's ``run`` on the 15 deg/frame regime, cut to its first 10
  poses, builds the same camera and GraphSLAM config (sub-pixel
  refinement on; inverse-depth weighting and the smoother as the variant
  sets them) and gives equal maps, closures, relocalizations and backstop
  rejections, with ATE and t-RMSE within 1e-4 m.

The three scripts share a file so that it is queued with the long files
(pytest-xdist queues files by their number of tests).
"""
import os
import runpy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch_printout import printout_diff, run_as_main  # noqa: E402
from torch_twins import (  # noqa: E402
    config_fields, cut_loops, record_slam_args, share_renderer,
)

import srrg2_proslam_tpu.models.tracker as jtracker  # noqa: E402
import srrg2_proslam_tpu_torch.models.tracker as ttracker  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")
CPU = torch.device("cpu")


# ---- ab_local_ba ---------------------------------------------------------------------

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


# ---- ab_seeded_detection --------------------------------------------------------------

SEEDED_FRAMES = 26
SEEDED_CAPACITY = 2048
SEEDED_VARIANTS = ("dense", "seeded")


@pytest.fixture(scope="module")
def seeded_runs():
    """Both scripts over the cut pose list -> (each side's (valid, inliers)
    per ``track_step`` call, the port's printout, JAX's printout)."""
    seen = {"t": [], "j": []}
    room = []  # live landmarks + the frame's measurements, per call
    with pytest.MonkeyPatch.context() as mp:
        share_renderer(mp)
        cut_loops(mp, SEEDED_FRAMES)
        for tag, mod in (("t", ttracker), ("j", jtracker)):
            real, real_initial = mod.track_step, mod.initial_state

            def recording(state, pts, desc, valid, *a, _real=real, _sink=seen[tag], **k):
                n = int(np.asarray(valid).sum())
                room.append(int(np.asarray(state.arena.valid).sum()) + n)
                out = _real(state, pts, desc, valid, *a, **k)
                _sink.append((n, int(out[1].num_inliers)))
                return out

            mp.setattr(mod, "track_step", recording)
            mp.setattr(mod, "initial_state", lambda capacity, *a, _real=real_initial, **k:
                       _real(SEEDED_CAPACITY, *a, **k))
        _, out_t = run_as_main(os.path.join(SCRIPTS, "ab_seeded_detection_torch.py"),
                               ["--device", "cpu"])
        _, out_j = run_as_main(os.path.join(SCRIPTS, "ab_seeded_detection.py"), [])
    assert max(room) <= SEEDED_CAPACITY
    return seen, out_t, out_j


@pytest.mark.parametrize("variant", SEEDED_VARIANTS)
def test_ab_seeded_detection_matches_jax(seeded_runs, variant):
    seen, out_t, out_j = seeded_runs
    # dense and seeded alternate, one call each per frame
    assert len(seen["t"]) == 2 * SEEDED_FRAMES and len(seen["j"]) == 2 * SEEDED_FRAMES
    k = SEEDED_VARIANTS.index(variant)
    assert seen["t"][k::2] == seen["j"][k::2]
    # the header and this variant's row
    other = SEEDED_VARIANTS[1 - k]
    rows_t, rows_j = ([ln for ln in out if ln.split()[:1] != [other]] for out in (out_t, out_j))
    assert sum(ln.split()[:1] == [variant] for ln in rows_t) == 1
    diff = printout_diff(rows_t, rows_j)
    assert not diff, "\n".join(diff)


# ---- ab_motion_envelopes --------------------------------------------------------------

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
