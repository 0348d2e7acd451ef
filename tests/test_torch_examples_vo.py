"""The port's image-driven examples — ``example_tracking``,
``example_triangulate_stereo`` and ``example_feature_matching`` — == the
JAX package's apps/, on the CPU.

Each app runs with ``--device cpu`` and its JAX twin through ``runpy`` on
the CPU; their printouts agree line for line (tests/torch_printout.py:
counts exactly, floats within one printed unit).  ``example_tracking``
reads its columns out of ``TrackStats.host_packet`` by index, so the
indices are held to the stats' own fields on two KITTI frames: an
off-by-one there would print the wrong column.
"""
import os

import numpy as np
import torch

torch.set_num_threads(1)

from torch_printout import printout_diff  # noqa: E402
from torch_twins import app_twins  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TEST_DATA = os.path.join(REPO, "test_data")


def _both(name, argv, out_dir=None):
    out_t, out_j = app_twins(name, argv, out_dir)
    diff = printout_diff(out_t, out_j)
    assert not diff, "\n".join(diff)
    return out_t


def test_tracking_example_matches_jax():
    out = _both("example_tracking", [])
    rows = [ln.split() for ln in out[2:]]
    assert len(rows) == 5
    # measurements and matches of the verify recipe's 5 frames
    assert [int(r[1]) for r in rows] == [486, 502, 479, 509, 496]
    assert [int(r[2]) for r in rows] == [0, 133, 112, 101, 153]


def test_tracking_packet_columns():
    from srrg2_proslam_tpu_torch.apps import example_tracking as ex
    from srrg2_proslam_tpu_torch.io import datasets
    from srrg2_proslam_tpu_torch.models.frontend import StereoAdaptorConfig, adapt_stereo
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig, initial_state, track_step

    frames = list(datasets.iter_bundled_kitti(TEST_DATA, "city"))[:2]
    cam = datasets.kitti_camera(*frames[0].left.shape)
    state = initial_state(4096, device="cpu")
    for fr in frames:
        meas = adapt_stereo(torch.from_numpy(fr.left), torch.from_numpy(fr.right),
                            StereoAdaptorConfig())
        state, stats, _ = track_step(state, meas.points, meas.desc, meas.valid, cam,
                                     TrackerConfig(), "stereo")
        pkt = stats.host_packet.numpy()
        assert pkt[ex.PACKET_INLIERS] == int(stats.num_inliers)
        assert pkt[ex.PACKET_MATCHES] == int(stats.num_matches)
        assert pkt[ex.PACKET_MERGES] == int(stats.num_merges)
        assert pkt[ex.PACKET_ADDS] == int(stats.num_additions)
        assert pkt[ex.PACKET_STAGE] == int(stats.matcher_stage)
        assert pkt[ex.PACKET_CHI] == float(stats.chi_per_inlier)
        np.testing.assert_array_equal(pkt[ex.PACKET_T:].reshape(3, 4),
                                      state.T_lm_robot[:3].numpy())
    assert int(stats.num_matches) == 133


def test_triangulate_example_matches_jax(tmp_path):
    out = _both("example_triangulate_stereo",
                ["--cloud", "{out}/cloud.npz", "--render", "{out}/matches.png"], tmp_path)
    assert out[0] == "# stereo measurements: 486/1152"
    t, j = (np.load(tmp_path / tag / "cloud.npz") for tag in "tj")
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["points"], j["points"], rtol=1e-6, atol=1e-6)
    assert (tmp_path / "t" / "matches.png").stat().st_size > 1000


def test_triangulate_example_calibration_flags():
    _both("example_triangulate_stereo", ["--fx", "700", "--baseline-px", "350"])


def test_feature_matching_example_matches_jax():
    out = _both("example_feature_matching", [])
    assert out[1] == "brute-force matches (bijective + Lowe): 101"
    assert out[2] == "epipolar stereo matches: 273"


def test_tracking_example_on_a_sequence_folder(tmp_path):
    from srrg2_proslam_tpu_torch.io import datasets

    seq = tmp_path / "seq"
    for sub in ("image_0", "image_1"):
        (seq / sub).mkdir(parents=True)
    for i, fr in enumerate(datasets.iter_bundled_kitti(TEST_DATA, "city")):
        datasets.save_gray(str(seq / "image_0" / f"{i:06d}.png"), fr.left)
        datasets.save_gray(str(seq / "image_1" / f"{i:06d}.png"), fr.right)
    out = _both("example_tracking", ["--sequence", str(seq), "--count", "3"])
    assert out[0].startswith("3 frames") and len(out) == 5
