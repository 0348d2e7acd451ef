"""The port's apps on a dataset folder, on the CPU.

On a KITTI-odometry folder the test writes from the 5 bundled pairs, the
port's ``app_benchmark`` (``--device cpu``) gives the same trajectory per
frame, on the BOSS log ``convert_dataset --format boss`` makes of the
folder, and with ``--chunked`` (the same pixels, and the batched adaptor
equals the per-frame one): exactly equal.  ``convert_dataset``'s npz
equals the JAX app's array for array; ``compute_sparse_stereo_gt``'s
output file equals the JAX app's byte for byte.  The app's helpers are
tests/test_torch_app.py's.
"""
import os
import runpy
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu_torch.io import datasets as tds  # noqa: E402
from tests.test_torch_app import TEST_DATA, _jax, _port, _result  # noqa: E402


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """The 5 bundled city pairs as a KITTI-odometry folder."""
    d = tmp_path_factory.mktemp("kitti_seq")
    for sub in ("image_0", "image_1"):
        os.makedirs(d / sub)
    frames = list(tds.iter_bundled_kitti(TEST_DATA, "city"))
    for i, fr in enumerate(frames):
        tds.save_gray(str(d / "image_0" / f"{i:06d}.png"), fr.left)
        tds.save_gray(str(d / "image_1" / f"{i:06d}.png"), fr.right)
    np.savetxt(d / "times.txt", 0.1 * np.arange(len(frames)))
    np.savetxt(d / "poses.txt", np.stack([fr.gt_pose[:3].reshape(-1) for fr in frames]))
    return d


@pytest.fixture(scope="module")
def folder_run(kitti_dir, tmp_path_factory):
    """The port's app over the KITTI folder, per frame."""
    out = tmp_path_factory.mktemp("folder_run") / "traj"
    old = sys.argv
    sys.argv = ["app_benchmark", "--dataset", "kitti", "--sequence", str(kitti_dir),
                "--gt", str(kitti_dir / "poses.txt"), "--device", "cpu", "--output", str(out)]
    try:
        runpy.run_module("srrg2_proslam_tpu_torch.apps.app_benchmark", run_name="__main__")
    except SystemExit:
        pass
    finally:
        sys.argv = old
    return np.loadtxt(str(out) + "_kitti.txt")


@pytest.mark.parametrize("mode", ["boss", "chunked"])
def test_app_modes_equal_the_folder_run(kitti_dir, folder_run, tmp_path, capsys, mode):
    if mode == "boss":
        log = str(tmp_path / "messages.json")
        code, out = _port("convert_dataset", ["--dataset", "kitti", "--sequence",
                                              str(kitti_dir), "--gt",
                                              str(kitti_dir / "poses.txt"), "--format",
                                              "boss", "--output", log], capsys)
        assert code == 0 and "wrote 5 BOSS message triplets" in out
        argv = ["--dataset", "boss", "--sequence", log]
    else:
        argv = ["--dataset", "kitti", "--sequence", str(kitti_dir), "--gt",
                str(kitti_dir / "poses.txt"), "--chunked", "2"]
    code, out = _port("app_benchmark", argv + ["--device", "cpu", "--output",
                                               str(tmp_path / "m")], capsys)
    assert "processed 5 frames" in out and set(_result(out)) >= {"mean_frame_hz",
                                                                 "regression"}
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "m_kitti.txt"), folder_run)


def test_convert_dataset_npz_equals_jax(kitti_dir, tmp_path, capsys):
    argv = ["--dataset", "kitti", "--sequence", str(kitti_dir), "--gt",
            str(kitti_dir / "poses.txt"), "--count", "3"]
    assert _port("convert_dataset", argv + ["--output", str(tmp_path / "t.npz")], capsys)[0] == 0
    assert _jax("convert_dataset", argv + ["--output", str(tmp_path / "j.npz")], capsys)[0] == 0
    got, ref = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert sorted(got.files) == sorted(ref.files)
    for key in ref.files:
        assert got[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    from srrg2_proslam_tpu_torch.apps.convert_dataset import iter_packed

    packed = list(iter_packed(str(tmp_path / "t.npz")))
    assert len(packed) == 3 and packed[0].left.dtype == np.float32


def test_compute_sparse_stereo_gt_equals_jax(tmp_path, capsys, rng):
    left = os.path.join(TEST_DATA, "scene_flow", "image_left.png")
    right = os.path.join(TEST_DATA, "scene_flow", "image_right.png")
    shape = tds.load_gray(left).shape
    disp = rng.uniform(-5, 80, shape).astype(np.float32)
    tds.write_pfm(str(tmp_path / "disp.pfm"), disp)
    for who, run in (("t", _port), ("j", _jax)):
        os.makedirs(tmp_path / who)
        code, out = run("compute_sparse_stereo_gt",
                        ["-l", left, "-r", right, "-d", str(tmp_path / "disp.pfm"), "-t", "10",
                         "-o", str(tmp_path / who)] + (["--device", "cpu"] if who == "t" else []),
                        capsys)
        assert code == 0 and "validated stereo matches" in out
    name = "gt_stereo_matching_threshold-10.txt"
    text = (tmp_path / "t" / name).read_text()
    assert text == (tmp_path / "j" / name).read_text() and text.count("\n") > 100
