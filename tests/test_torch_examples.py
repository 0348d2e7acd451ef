"""The port's didactic examples (``srrg2_proslam_tpu_torch/apps/example_*``
and ``export_viewer``) == the JAX package's apps/, on the CPU.

Each app runs as ``__main__`` with ``--device cpu`` and its JAX twin
through ``runpy`` on the CPU, on the same inputs; their printouts agree
line for line (tests/torch_printout.py: counts exactly, floats within one
printed unit; timing lines left out).  The importable pieces —
``radius_mask``, ``paint`` / ``PATTERNS``, ``unproject_dense`` — equal the
JAX apps' own functions: masks and canvas bit for bit, points at rtol
1e-6.  The seeded extractor runs on a 96x128 crop of the scene_flow image
(20 masked detections); the tracking, triangulation and matching examples
are in tests/test_torch_examples_vo.py.
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
