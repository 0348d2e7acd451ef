"""The port's didactic examples (``srrg2_proslam_tpu_torch/apps/example_*``
and ``export_viewer``) == the JAX package's apps/, on the CPU.

Each app runs as ``__main__`` with ``--device cpu`` and its JAX twin
through ``runpy`` on the CPU, on the same inputs; their printouts agree
line for line (tests/torch_printout.py: counts exactly, floats within one
printed unit; timing lines left out).  The importable pieces —
``radius_mask``, ``paint`` / ``PATTERNS``, ``unproject_dense`` — equal the
JAX apps' own functions: masks and canvas bit for bit, points at rtol
1e-6.  The seeded extractor runs on a 96x128 crop of the scene_flow image
(20 masked detections).  The image-driven examples (``example_tracking``,
``example_triangulate_stereo``, ``example_feature_matching``) print
nothing to leave out: their printouts agree with no line skipped.
``example_tracking`` reads its columns out of ``TrackStats.host_packet``
by index, so the indices are held to the stats' own fields on two KITTI
frames: an off-by-one there would print the wrong column.
"""
import os
import runpy

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch_printout import printout_diff, run_as_main  # noqa: E402
from torch_twins import app_twins  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets as tds  # noqa: E402

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TEST_DATA = os.path.join(REPO, "test_data")
TIMINGS = ("duration",)


def _jax_app(name):
    return runpy.run_path(os.path.join(REPO, "apps", f"{name}.py"))


def _agree(out_t, out_j):
    diff = printout_diff(out_t, out_j, skip=TIMINGS)
    assert not diff, "\n".join(diff)


def _both(name, argv, out_dir=None):
    out_t, out_j = app_twins(name, argv, out_dir)
    _agree(out_t, out_j)
    return out_t


def test_radius_mask_matches_jax():
    import jax.numpy as jnp

    from srrg2_proslam_tpu_torch.apps.example_feature_extractor import radius_mask

    jax_mask = _jax_app("example_feature_extractor")["radius_mask"]
    rng = np.random.RandomState(3)
    uv = np.stack([rng.randint(0, 64, 40), rng.randint(0, 48, 40)], -1).astype(np.float32)
    valid = rng.rand(40) < 0.7
    for radius in (100, 9, 3, 1):
        want = np.asarray(jax_mask(48, 64, jnp.asarray(uv), jnp.asarray(valid), radius))
        got = radius_mask(48, 64, torch.from_numpy(uv), torch.from_numpy(valid), radius)
        assert got.shape == (48, 64) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


def test_paint_matches_jax():
    from srrg2_proslam_tpu_torch.apps import example_search_patterns as port

    jax_app = _jax_app("example_search_patterns")
    assert port.PATTERNS == jax_app["PATTERNS"] and port.SAMPLES == jax_app["SAMPLES"]
    got = np.zeros((500, 500), np.uint8)
    want = np.zeros((500, 500), np.uint8)
    for norm, color in port.PATTERNS:
        got = port.paint(got, norm, color, "cpu")
        want = jax_app["paint"](want, norm, color)
        np.testing.assert_array_equal(got, want)


def test_unproject_dense_matches_jax():
    import jax.numpy as jnp

    from srrg2_proslam_tpu_torch.apps.example_unproject_rgbd import unproject_dense

    jax_fn = _jax_app("example_unproject_rgbd")["unproject_dense"]
    depth = tds.load_depth(os.path.join(TEST_DATA, "xtion", "image_depth.pgm")) * 1e-3
    args = (269.853, 269.733, 157.051, 113.118, 0.1, 10.0)
    pts_j, ok_j = jax_fn(jnp.asarray(depth), *args)
    pts_t, ok_t = unproject_dense(torch.from_numpy(depth), *args)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=1e-6, atol=1e-7)


def test_loop_closure_example_matches_jax():
    out = _both("example_loop_closure", [])
    assert any("accepted=True" in ln for ln in out)


def test_unproject_example_matches_jax(tmp_path):
    out = _both("example_unproject_rgbd", ["--cloud", "{out}/c.npz"], tmp_path)
    assert "# unprojected points: 67544" in out
    cloud = np.load(tmp_path / "t" / "c.npz")
    assert cloud["points"].shape == (240 * 320, 3) and int(cloud["valid"].sum()) == 67544


def test_search_patterns_example_matches_jax(tmp_path):
    _both("example_search_patterns", ["--out", "{out}/p.pgm"], tmp_path)
    assert (tmp_path / "t" / "p.pgm").read_bytes() == (tmp_path / "j" / "p.pgm").read_bytes()


@pytest.mark.parametrize("seeded", [False, True], ids=["binned", "seeded"])
def test_feature_extractor_example_matches_jax(tmp_path, seeded):
    # the seeded loop's 20 masked detections on a 96x128 crop (the full
    # 540x960 image takes minutes on the CPU); the binned mode at full size
    image = os.path.join(TEST_DATA, "scene_flow", "image_left.png")
    if seeded:
        crop = tds.load_gray(image)[200:296, 400:528]
        image = str(tmp_path / "crop.png")
        tds.save_gray(image, crop)
    argv = ["--moving", image] + (["--seeded", "-n", "30"] if seeded else [])
    out = _both("example_feature_extractor", argv)
    n = [int(ln.split()[-1]) for ln in out if "# extracted features" in ln]
    assert len(n) == (21 if seeded else 1) and min(n) > 0


def test_export_viewer_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    traj = tmp_path / "traj.txt"
    poses = np.tile(np.eye(4)[:3].reshape(1, 12), (6, 1))
    poses[:, 11] = np.arange(6) * 0.5
    np.savetxt(traj, poses)
    out_t, out_j = [run_as_main(target, ["--trajectory", str(traj), "--gt", str(traj),
                                         "--output", str(tmp_path / f"{tag}.png")])[1]
                    for tag, target in (("t", "srrg2_proslam_tpu_torch.apps.export_viewer"),
                                        ("j", os.path.join(REPO, "apps", "export_viewer.py")))]
    assert out_t == [f"wrote {tmp_path / 't.png'}"] and out_j == [f"wrote {tmp_path / 'j.png'}"]
    assert (tmp_path / "t.png").stat().st_size > 1000


def test_export_viewer_raises_without_matplotlib(tmp_path, monkeypatch):
    import sys

    from srrg2_proslam_tpu_torch.apps import export_viewer

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    traj = tmp_path / "traj.txt"
    np.savetxt(traj, np.eye(4)[:3].reshape(1, 12))
    with pytest.raises(ImportError):
        export_viewer.main(["--trajectory", str(traj), "--output", str(tmp_path / "v.png")])
    assert not (tmp_path / "v.png").exists()


def test_printout_comparison_rules():
    from torch_printout import line_diff

    # a float on a rounding edge may print one unit apart; a count may not
    assert line_diff("t=[-0.001  0.676]", "t=[-0.002 0.677]") is None
    assert line_diff("chi/inl=6.46", "chi/inl=6.48") is not None
    assert line_diff("matches=133", "matches=134") is not None
    assert line_diff("t=[0.  2.8  ]", "t=[0.001 2.799]") is None
    assert line_diff("angle: 0.0077351871", "angle: 0.0077352398") is None
    assert line_diff("stage=2 PASS", "stage=2 FAIL") is not None


# ---- the image-driven examples --------------------------------------------------------

def _both_exact(name, argv, out_dir=None):
    """The printouts agree with no line left out."""
    out_t, out_j = app_twins(name, argv, out_dir)
    diff = printout_diff(out_t, out_j)
    assert not diff, "\n".join(diff)
    return out_t


def test_tracking_example_matches_jax():
    out = _both_exact("example_tracking", [])
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
    out = _both_exact("example_triangulate_stereo",
                ["--cloud", "{out}/cloud.npz", "--render", "{out}/matches.png"], tmp_path)
    assert out[0] == "# stereo measurements: 486/1152"
    t, j = (np.load(tmp_path / tag / "cloud.npz") for tag in "tj")
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_allclose(t["points"], j["points"], rtol=1e-6, atol=1e-6)
    assert (tmp_path / "t" / "matches.png").stat().st_size > 1000


def test_triangulate_example_calibration_flags():
    _both_exact("example_triangulate_stereo", ["--fx", "700", "--baseline-px", "350"])


def test_feature_matching_example_matches_jax():
    out = _both_exact("example_feature_matching", [])
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
    out = _both_exact("example_tracking", ["--sequence", str(seq), "--count", "3"])
    assert out[0].startswith("3 frames") and len(out) == 5
