"""The port's benchmark app (``python -m
srrg2_proslam_tpu_torch.apps.app_benchmark``) == the JAX package's
apps/app_benchmark.py, on the CPU.

The app runs through ``runpy`` with ``--device cpu``: on the bundled KITTI
frames it prints the JAX app's JSON keys, exits with its code, and writes
a KITTI trajectory within 1e-5 of the JAX app's (one JAX run, for time);
``--dataset boss-rgbd`` reads a BLOB log of the bundled ICL frames;
``--profile``, ``--trace-dir`` and ``--viewer-port`` report, trace and
serve.  The dataset folder, BOSS, ``--chunked`` and converter cases are in
tests/test_torch_app_datasets.py.
"""
import json
import os
import runpy
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu_torch.io import boss as tboss, datasets as tds  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), "..")
TEST_DATA = os.path.join(REPO, "test_data")


def _run(argv, capsys, module=None, script=None):
    """Run an app as ``__main__`` -> (exit code, stdout)."""
    old = sys.argv
    sys.argv = [module or script] + argv
    code = 0
    try:
        if module:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        else:
            runpy.run_path(script, run_name="__main__")
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = old
    return code, capsys.readouterr().out


def _port(app, argv, capsys):
    return _run(argv, capsys, module=f"srrg2_proslam_tpu_torch.apps.{app}")


def _jax(app, argv, capsys):
    return _run(argv, capsys, script=os.path.join(REPO, "apps", f"{app}.py"))


def _result(out):
    return json.loads(out.strip().splitlines()[-1])


def test_app_bundled_kitti_matches_jax(tmp_path, capsys):
    code_t, out_t = _port("app_benchmark", ["--device", "cpu", "--output",
                                            str(tmp_path / "t")], capsys)
    code_j, out_j = _jax("app_benchmark", ["--output", str(tmp_path / "j")], capsys)
    res_t, res_j = _result(out_t), _result(out_j)
    assert set(res_t) == set(res_j)
    assert (code_t, res_t["regression"]) == (code_j, res_j["regression"])
    assert "processed 5 frames" in out_t
    np.testing.assert_allclose(np.loadtxt(tmp_path / "t_kitti.txt"),
                               np.loadtxt(tmp_path / "j_kitti.txt"), atol=1e-5)
    for key in ("mean_translation_rmse", "std_translation_rmse"):
        np.testing.assert_allclose(res_t[key], res_j[key], atol=1e-5)
    tum = np.loadtxt(tmp_path / "t_tum.txt")
    assert tum.shape == (5, 8)


def test_app_boss_rgbd(tmp_path, capsys):
    frames = list(tds.iter_bundled_icl(TEST_DATA))
    log = str(tmp_path / "messages.json")
    assert tboss.write_boss_rgbd(log, frames, tds.icl_camera()) == 3
    code, out = _port("app_benchmark", ["--dataset", "boss-rgbd", "--sequence", log,
                                        "--device", "cpu", "--output",
                                        str(tmp_path / "r")], capsys)
    assert code == 0 and "processed 3 frames" in out
    assert np.loadtxt(tmp_path / "r_tum.txt").shape == (3, 8)


def test_app_profile_trace_and_viewer(tmp_path, capsys):
    code, out = _port("app_benchmark", ["--device", "cpu", "--count", "2", "--profile",
                                        "--trace-dir", str(tmp_path / "trace"),
                                        "--viewer-port", "0", "--viewer-every", "1"],
                      capsys)
    assert "profile_time report:" in out and "adaptor" in out
    assert "[viewer] live view at http://127.0.0.1:" in out
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


