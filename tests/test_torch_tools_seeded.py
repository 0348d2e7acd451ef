"""The port's scripts/ab_seeded_detection_torch.py == the JAX package's
scripts/ab_seeded_detection.py, on the CPU, over a cut pose list.

``loop_trajectory`` is cut to its first 26 poses in both packages'
synthetic modules, so the script walks the start of its loop at its own
widths (320x416), the contrast-crushed frames 24 and 25 included, and both
packages see the JAX renderer's images (tests/torch_twins.py).  The
landmark arena is cut from the scripts' 4096 slots to 2048 in both
packages: insertion takes the lowest free slots and drops only what does
not fit, and no frame comes near that (the live landmarks plus the frame's
measurements stay within 2048, checked), so every frame's result is the
one at 4096 and the projective matcher's cost matrices are half as wide.  Every
frame's stereo matches and VO inliers of both variants (dense and seeded
detection) are equal, read at each side's ``track_step``, and the printed
table agrees within one printed unit (recall included).  Both scripts run
once; each variant's frames and table row are a case of their own.  The
other A/B scripts are in tests/test_torch_tools_ab.py and
test_torch_tools_motion.py.
"""
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch_printout import printout_diff, run_as_main  # noqa: E402
from torch_twins import cut_loops, share_renderer  # noqa: E402

import srrg2_proslam_tpu.models.tracker as jtracker  # noqa: E402
import srrg2_proslam_tpu_torch.models.tracker as ttracker  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "scripts")


FRAMES = 26
CAPACITY = 2048
VARIANTS = ("dense", "seeded")


@pytest.fixture(scope="module")
def runs():
    """Both scripts over the cut pose list -> (each side's (valid, inliers)
    per ``track_step`` call, the port's printout, JAX's printout)."""
    seen = {"t": [], "j": []}
    room = []  # live landmarks + the frame's measurements, per call
    with pytest.MonkeyPatch.context() as mp:
        share_renderer(mp)
        cut_loops(mp, FRAMES)
        for tag, mod in (("t", ttracker), ("j", jtracker)):
            real, real_initial = mod.track_step, mod.initial_state

            def recording(state, pts, desc, valid, *a, _real=real, _sink=seen[tag], **k):
                n = int(np.asarray(valid).sum())
                room.append(int(np.asarray(state.arena.valid).sum()) + n)
                out = _real(state, pts, desc, valid, *a, **k)
                _sink.append((n, int(out[1].num_inliers)))
                return out

            mp.setattr(mod, "track_step", recording)
            mp.setattr(mod, "initial_state",
                       lambda capacity, *a, _real=real_initial, **k: _real(CAPACITY, *a, **k))
        _, out_t = run_as_main(os.path.join(SCRIPTS, "ab_seeded_detection_torch.py"),
                               ["--device", "cpu"])
        _, out_j = run_as_main(os.path.join(SCRIPTS, "ab_seeded_detection.py"), [])
    assert max(room) <= CAPACITY
    return seen, out_t, out_j


@pytest.mark.parametrize("variant", VARIANTS)
def test_ab_seeded_detection_matches_jax(runs, variant):
    seen, out_t, out_j = runs
    # dense and seeded alternate, one call each per frame
    assert len(seen["t"]) == 2 * FRAMES and len(seen["j"]) == 2 * FRAMES
    k = VARIANTS.index(variant)
    assert seen["t"][k::2] == seen["j"][k::2]
    # the header and this variant's row
    other = VARIANTS[1 - k]
    rows_t, rows_j = ([ln for ln in out if ln.split()[:1] != [other]] for out in (out_t, out_j))
    assert sum(ln.split()[:1] == [variant] for ln in rows_t) == 1
    diff = printout_diff(rows_t, rows_j)
    assert not diff, "\n".join(diff)
