"""The port's config loader (utils/config.py) == the JAX package's, and the
shipped SLAM configurations run in the port as in the JAX package, on the
CPU.

* Every ``configurations/*.json`` loads into the port's dataclasses and
  ``to_dict`` of it equals ``to_dict`` of the JAX package's own load, key
  for key and value for value; lists come back as tuples.
* The registry holds the JAX package's class names; a save/load round trip
  returns an equal config; a key the class lacks raises KeyError.
* ``kitti_slam.json`` and ``euroc_slam.json`` (``speculation_depth`` 8,
  ``chunk_size`` 16), as each package loads them, run a short measurement
  stream (a split at euroc's 1.0 m, a Lost frame) through the port's
  ``process_meas_sequence`` and the JAX package's ``process``: per-frame
  status and local map, counters and closure events equal, every pose
  within 1e-5.  The other four shipped SLAM configs do the same in a
  ``slow`` test (the RGB-D ones on (u, v, depth) rows).
* ``kitti_slam.json`` + ``kitti_adaptor.json`` over the 5 bundled KITTI
  pairs through ``process_sequence`` (one batched adaptor call) equal the
  port's ``adapt_stereo -> process`` loop exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.utils import config as jcfg  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.ops import matching  # noqa: E402
from srrg2_proslam_tpu_torch.utils import config as tcfg  # noqa: E402
from tests.test_torch_sequence import (CAM, _assert_exact, _assert_jax, _run_jax,  # noqa: E402
                                       _run_port, _summary, _watch)
from tests.test_torch_slam import _stereo_measurements  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configurations")
DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")
FILES = sorted(f for f in os.listdir(CONFIGS) if f.endswith(".json"))


def test_every_shipped_config_is_listed():
    assert len(FILES) == 13 and sum(f.endswith("_slam.json") for f in FILES) == 6


@pytest.mark.parametrize("name", FILES)
def test_config_loads_as_jax(name):
    path = os.path.join(CONFIGS, name)
    got, ref = tcfg.load(path), jcfg.load(path)
    assert type(got).__name__ == type(ref).__name__
    assert tcfg.to_dict(got) == jcfg.to_dict(ref)
    with open(path) as f:
        _assert_within(json.load(f), tcfg.to_dict(got))
    assert got == tcfg.from_dict(tcfg.to_dict(got))


def _assert_within(raw, full):
    """Every key of the file holds its value in the loaded config (the
    file may leave fields at their defaults)."""
    if isinstance(raw, dict):
        for k, v in raw.items():
            _assert_within(v, full[k])
    else:
        assert raw == full, (raw, full)


def test_registry_names_match_jax():
    jcfg._ensure_registry_populated()
    assert set(tcfg.registry()) == set(jcfg.registry())


def test_roundtrip(tmp_path):
    c = matching.ProjectiveMatcherConfig(radius_stages=(5.0, 10.0),
                                         descriptor_stages=(25.0, 50.0))
    p = tmp_path / "c.json"
    tcfg.save(c, str(p))
    back = tcfg.load(str(p))
    assert back == c and back.radius_stages == (5.0, 10.0)
    nested = {"slam": ts.GraphSLAMConfig(speculation_depth=3),
              "bf": matching.BruteforceMatcherConfig(), "list": [1, 2]}
    tcfg.save(nested, str(p))
    back = tcfg.load(str(p))
    assert back == {"slam": nested["slam"], "bf": nested["bf"], "list": (1, 2)}
    assert json.loads(p.read_text())["slam"]["type"] == "GraphSLAMConfig"
    assert tcfg.replace(c, lowe_ratio=0.5).lowe_ratio == 0.5


def test_unknown_key_raises():
    data = tcfg.to_dict(ts.GraphSLAMConfig())
    data["splitting"]["maximum_yaw"] = 1.0
    with pytest.raises(KeyError):
        tcfg.from_dict(data)
    with pytest.raises(KeyError):
        tcfg.from_dict({"type": "NoSuchConfig"})


def _short_stream(model: str):
    """8 frames 0.4 m apart along the optical axis, frame 5 with nothing
    valid: a split at 1.0 m splitting thresholds, then a Lost frame."""
    rng = np.random.RandomState(0)
    n = 500
    pts_w = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                      rng.uniform(2, 40, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for i in range(8):
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -0.4 * i
        p, ok = _stereo_measurements(pts_w, T_wc)
        if model == "rgbd":
            z = (pts_w @ T_wc[:3, :3].T + T_wc[:3, 3])[:, 2]
            p = np.stack([p[:, 0], p[:, 1], z], axis=1).astype(np.float32)
        if i == 5:
            ok[:] = False
        frames.append((p, desc, ok, 0.1 * i))
    return frames


def _shipped_config_run(name: str):
    path = os.path.join(CONFIGS, f"{name}_slam.json")
    jc, tc = jcfg.load(path), tcfg.load(path)
    assert tc.speculation_depth == 8 and tc.chunk_size == 16
    model = "rgbd" if name in ("icl", "tum") else "stereo"
    frames = _short_stream(model)
    _, port = _run_port(CAM, tc, frames, "sequence", model)
    ref = _run_jax(CAM, jc, frames, model)
    _assert_jax(port, ref)
    assert port["counters"]["num_losses"] == 1


@pytest.mark.parametrize("name", ["kitti", "euroc"])
def test_shipped_slam_config_runs_as_jax(name):
    _shipped_config_run(name)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["kitti_in_baselink", "malaga", "tum", "icl"])
def test_other_shipped_slam_configs_run_as_jax(name):
    _shipped_config_run(name)


def test_kitti_sequence_equals_per_frame():
    """kitti_slam.json + kitti_adaptor.json over the 5 bundled KITTI pairs:
    ``process_sequence`` (one batched adaptor call) equals ``adapt_stereo
    -> process`` per frame."""
    kitti = list(datasets.iter_bundled_kitti(DATA, "city"))
    cam = datasets.kitti_camera(*kitti[0].left.shape)
    scfg = tcfg.load(os.path.join(CONFIGS, "kitti_slam.json"))
    acfg = tcfg.load(os.path.join(CONFIGS, "kitti_adaptor.json"))
    sync = ts.GraphSLAM(cam, tcfg.replace(scfg, speculation_depth=0), device="cpu")
    statuses = _watch(sync)
    for f in kitti:
        m = frontend.adapt_stereo(torch.from_numpy(f.left), torch.from_numpy(f.right), acfg)
        sync.process(m.points, m.desc, m.valid, f.timestamp)
    seq = ts.GraphSLAM(cam, scfg, device="cpu")
    seq_statuses = _watch(seq)
    seq.process_sequence(np.stack([f.left for f in kitti]), np.stack([f.right for f in kitti]),
                         [f.timestamp for f in kitti], acfg)
    _assert_exact(_summary(seq, seq_statuses), _summary(sync, statuses))
    assert seq_statuses == [ts.INITIALIZING] + [ts.TRACKING] * 4
