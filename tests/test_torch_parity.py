"""The PyTorch port stands alone and mirrors the JAX package's constants.

* importing ``srrg2_proslam_tpu_torch`` pulls in no jax;
* its config dataclasses carry the JAX package's field names and defaults;
* its frozen FAST ring and BRIEF pair tables equal the JAX package's;
* its PNG reader decodes the bundled KITTI frames like ``datasets.load_gray``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import datasets as jax_datasets  # noqa: E402
from srrg2_proslam_tpu.models import frontend as jax_frontend  # noqa: E402
from srrg2_proslam_tpu.models import tracker as jax_tracker  # noqa: E402
from srrg2_proslam_tpu.ops import ekf as jax_ekf  # noqa: E402
from srrg2_proslam_tpu.ops import features as jax_features  # noqa: E402
from srrg2_proslam_tpu.ops import landmark_estimators as jax_le  # noqa: E402
from srrg2_proslam_tpu.ops import matching as jax_matching  # noqa: E402
from srrg2_proslam_tpu.models import loop_closure as jax_loop_closure  # noqa: E402
from srrg2_proslam_tpu.models import slam as jax_slam  # noqa: E402
from srrg2_proslam_tpu.ops import ba as jax_ba, pgo as jax_pgo  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, tracker  # noqa: E402
from srrg2_proslam_tpu_torch.models import loop_closure, slam  # noqa: E402
from srrg2_proslam_tpu_torch.ops import ekf, features, landmark_estimators, matching, pgo  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "test_data")


def test_port_imports_without_jax():
    # every module of the port, and chip_smoke.py, with jax and the JAX
    # package blocked: importing either raises
    code = ("import importlib, pkgutil, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['srrg2_proslam_tpu'] = None\n"
            "import srrg2_proslam_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for name in names + ['chip_smoke']:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) > 20 and 'srrg2_proslam_tpu_torch.models.slam' in names\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_disables_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _as_plain(cfg):
    """Config -> nested dict of field values (class names dropped)."""
    return {f.name: (_as_plain(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("port_cls,jax_cls", [
    (features.FeatureExtractorConfig, jax_features.FeatureExtractorConfig),
    (matching.EpipolarMatcherConfig, jax_matching.EpipolarMatcherConfig),
    (matching.ProjectiveMatcherConfig, jax_matching.ProjectiveMatcherConfig),
    (frontend.StereoAdaptorConfig, jax_frontend.StereoAdaptorConfig),
    (frontend.DepthAdaptorConfig, jax_frontend.DepthAdaptorConfig),
    (matching.BruteforceMatcherConfig, jax_matching.BruteforceMatcherConfig),
    (ekf.LandmarkEKFConfig, jax_ekf.LandmarkEKFConfig),
    (landmark_estimators.WeightedMeanConfig, jax_le.WeightedMeanConfig),
    (landmark_estimators.SmootherConfig, jax_le.SmootherConfig),
    (tracker.MergerConfig, jax_tracker.MergerConfig),
    (tracker.TrackerConfig, jax_tracker.TrackerConfig),
    (pgo.PGOConfig, jax_pgo.PGOConfig),
    (loop_closure.LoopDetectorConfig, jax_loop_closure.LoopDetectorConfig),
    (slam.SplittingConfig, jax_slam.SplittingConfig),
    (slam.RelocalizerConfig, jax_slam.RelocalizerConfig),
    (slam.BAConfig, jax_ba.BAConfig),
    (slam.LocalBAConfig, jax_slam.LocalBAConfig),
    (slam.GraphSLAMConfig, jax_slam.GraphSLAMConfig),
], ids=lambda c: c.__name__ if isinstance(c, type) else None)
def test_config_fields_and_defaults_match(port_cls, jax_cls):
    assert port_cls.__name__ == jax_cls.__name__
    assert [f.name for f in dataclasses.fields(port_cls)] == \
        [f.name for f in dataclasses.fields(jax_cls)]
    assert _as_plain(port_cls()) == _as_plain(jax_cls())
    assert port_cls.__dataclass_params__.frozen


def test_frozen_tables_match():
    np.testing.assert_array_equal(features._FAST_OFFSETS, jax_features._FAST_OFFSETS)
    np.testing.assert_array_equal(features._BRIEF_PAIRS, jax_features._BRIEF_PAIRS)
    assert features._BRIEF_PAIRS.dtype == jax_features._BRIEF_PAIRS.dtype
    assert features.BORDER == jax_features.BORDER
    assert features._ARC_LENGTH == jax_features._ARC_LENGTH


@pytest.mark.parametrize("sequence", ["city", "highway"])
def test_png_reader_matches_load_gray(sequence):
    folder = os.path.join(DATA, "kitti", sequence)
    names = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    assert names
    for name in names:
        got = datasets.load_gray(os.path.join(folder, name))
        ref = jax_datasets.load_gray(os.path.join(folder, name))
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_bundled_kitti_iterator_matches():
    ours = list(datasets.iter_bundled_kitti(DATA, "city"))
    ref = list(jax_datasets.iter_bundled_kitti(DATA, "city"))
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours, ref):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
    assert tuple(datasets.kitti_camera()) == tuple(jax_datasets.kitti_camera())


def test_png_filters_decode(tmp_path):
    """All five scanline filters (the bundled frames use Sub only)."""
    import zlib
    import struct

    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (5, 7)).astype(np.int64)
    rows = []
    prev = np.zeros(7, np.int64)
    for y, f in enumerate([0, 1, 2, 3, 4]):
        line = img[y]
        left = np.concatenate([[0], line[:-1]])
        upleft = np.concatenate([[0], prev[:-1]])
        if f == 0:
            enc = line
        elif f == 1:
            enc = line - left
        elif f == 2:
            enc = line - prev
        elif f == 3:
            enc = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = line - pred
        rows.append(bytes([f]) + bytes((enc % 256).astype(np.uint8)))
        prev = line

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 0, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(b"".join(rows)))
           + chunk(b"IEND", b""))
    path = tmp_path / "filters.png"
    path.write_bytes(png)
    np.testing.assert_array_equal(datasets.load_gray(str(path)), img.astype(np.float32))
