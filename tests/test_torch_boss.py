"""The port's BOSS message logs == the JAX package's, on the CPU.

Each writer's log is read by both packages: the port parses logs the JAX
package writes and the JAX package parses logs the port writes, with PNG,
PGM and BLOB payloads, for stereo and RGB-D.  The cases of
tests/test_boss.py and tests/test_app_cli.py's RGB-D round trip run as
parametrised cases through the port, each against the JAX reader on the
same log.  Bounds: frames (timestamps, images, ground truth) and
``boss_camera`` exactly equal between the packages; against the written
frames the bounds of tests/test_boss.py (BLOBs bit-exact, image files
within 1 grey level).
"""
import json
import os

import numpy as np
import pytest

from srrg2_proslam_tpu.io import boss as jboss, datasets as jds

from srrg2_proslam_tpu_torch.io import boss as tboss, datasets as tds

PKGS = {"jax": (jboss, jds), "port": (tboss, tds)}

REFERENCE_TEXT = '''
"MessageFileSource" {
  "#id" : 44,
  "name" : "source",

  // file to read
  "filename" : "messages.json"
 }

"MessageSortedSource" {
  "#id" : 17,
  "source" : {
    "#pointer" : 48
   },

  // lag time to sort messages
  "time_interval" : 0.01
 }
'''


def _frames(rng, pkg="port", n=4, shape=(48, 64)):
    out = []
    T = np.eye(4, dtype=np.float32)
    for i in range(n):
        left = rng.randint(0, 255, shape).astype(np.float32)
        T = T.copy()
        T[2, 3] += 0.5
        out.append(PKGS[pkg][1].StereoFrame(timestamp=100.0 + 0.1 * i, left=left,
                                            right=np.roll(left, -3, axis=1), gt_pose=T))
    return out


def _read_both(path, **kw):
    got_t = list(tboss.iter_boss_stereo(path, **kw))
    got_j = list(jboss.iter_boss_stereo(path, **kw))
    assert len(got_t) == len(got_j)
    for a, b in zip(got_t, got_j):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        assert (a.gt_pose is None) == (b.gt_pose is None)
        if b.gt_pose is not None:
            np.testing.assert_array_equal(a.gt_pose, b.gt_pose)
    return got_t


@pytest.mark.parametrize("text", [REFERENCE_TEXT,
                                  '"A" { "url" : "http://x//y", // real comment\n "v" : 1 }'])
def test_parse_boss_equals_jax(text):
    assert tboss.parse_boss(text) == jboss.parse_boss(text)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("image_format", ["png", "pgm", "blob", "bmp"])
def test_stereo_logs_read_across_packages(tmp_path, rng, writer, image_format):
    boss_mod, ds_mod = PKGS[writer]
    cam = ds_mod.kitti_camera(rows=40, cols=56)
    frames = _frames(rng, writer, n=3, shape=(40, 56))
    path = os.path.join(tmp_path, "messages.json")
    assert boss_mod.write_boss_stereo(path, frames, cam, image_format=image_format) == 3
    got = _read_both(path)
    assert len(got) == 3
    for a, b in zip(frames, got):
        assert abs(a.timestamp - b.timestamp) < 1e-9
        np.testing.assert_array_equal(np.uint8(a.left), np.uint8(b.left))
        np.testing.assert_array_equal(np.uint8(a.right), np.uint8(b.right))
        np.testing.assert_allclose(a.gt_pose, b.gt_pose, atol=1e-6)
    assert tboss.boss_camera(path) == jboss.boss_camera(path)
    got_cam = tboss.boss_camera(path)
    assert abs(got_cam.baseline_px - cam.baseline_px) < 1e-3
    assert (got_cam.rows, got_cam.cols) == (40, 56)


def test_logs_are_byte_identical(tmp_path, rng):
    """Both writers emit the same log text and the same BLOB bytes."""
    cam = tds.kitti_camera(rows=16, cols=24)
    frames = _frames(rng, n=2, shape=(16, 24))
    for name, (boss_mod, _) in PKGS.items():
        os.makedirs(tmp_path / name)
        boss_mod.write_boss_stereo(str(tmp_path / name / "messages.json"), frames, cam,
                                   image_format="blob")
    for rel in ["messages.json"] + [f"messages.json.d/{n}" for n in
                                    sorted(os.listdir(tmp_path / "port" / "messages.json.d"))]:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def _edit(path, *pairs, count=-1):
    text = open(path).read()
    for old, new in pairs:
        text = text.replace(old, new, count)
    open(path, "w").write(text)


def _sync_threshold(path):
    _edit(path, ('"timestamp": 100.1,', '"timestamp": 99.0,'), count=1)
    got = _read_both(path)
    assert len(got) <= 2 and all(fr.left.shape == (32, 32) for fr in got)


def _topic_pairing(path, frames):
    _edit(path, ("/camera_left/image_raw", "/cam0/image"),
          ("/camera_right/image_raw", "/cam1/image"),
          ('"camera_left"', '"cam0"'), ('"camera_right"', '"cam1"'))
    got = _read_both(path)
    assert len(got) == 3
    for a, b in zip(frames, got):
        np.testing.assert_allclose(a.right, b.right, atol=1.0)
    swapped = _read_both(path, left_topic="/cam1/image", right_topic="/cam0/image")
    np.testing.assert_allclose(swapped[0].left, frames[0].right, atol=1.0)


def _duplicate_timestamps(path):
    _edit(path, ('"timestamp": 100.1,', '"timestamp": 100.2,'))
    got = _read_both(path)
    assert len(got) == 3
    assert len({np.uint8(fr.right).tobytes() for fr in got}) == 3


def _unknown_blob_header(path, frames):
    d = path + ".d"
    for name in os.listdir(d):
        p = os.path.join(d, name)
        with open(p, "rb") as f:
            raw = f.read()
        with open(p, "wb") as f:
            f.write(b"\x07" * 25 + raw)
    got = _read_both(path)
    np.testing.assert_array_equal(np.uint8(frames[0].left), np.uint8(got[0].left))


@pytest.mark.parametrize("case", ["sync_threshold", "topic_pairing", "duplicate_timestamps",
                                  "unknown_blob_header"])
def test_log_edits_read_like_jax(tmp_path, rng, case):
    """tests/test_boss.py's edited logs, each read by both packages."""
    frames = _frames(rng, n=3, shape=(32, 32))
    path = os.path.join(tmp_path, "messages.json")
    tboss.write_boss_stereo(path, frames, tds.kitti_camera(rows=32, cols=32),
                            image_format="blob" if case == "unknown_blob_header" else "png")
    if case == "sync_threshold":
        _sync_threshold(path)
    elif case == "topic_pairing":
        _topic_pairing(path, frames)
    elif case == "duplicate_timestamps":
        _duplicate_timestamps(path)
    else:
        _unknown_blob_header(path, frames)


def test_unsorted_right_messages_pair(tmp_path):
    path = os.path.join(tmp_path, "messages.json")

    def msg(topic, ts, value):
        return '"ImageMessage" ' + json.dumps({
            "topic": topic, "frame_id": topic.strip("/"), "seq": 0, "timestamp": ts,
            "image_rows": 4, "image_cols": 6, "image_data": [[float(value)] * 6] * 4}) + "\n\n"

    with open(path, "w") as f:
        for i in range(3):
            f.write(msg("/camera_left/image_raw", 100.0 + 0.1 * i, i))
        for i in (2, 0, 1):   # rights out of order
            f.write(msg("/camera_right/image_raw", 100.0 + 0.1 * i, 10 + i))
    got = _read_both(path)
    assert [(fr.left[0, 0], fr.right[0, 0]) for fr in got] == [(0, 10), (1, 11), (2, 12)]


@pytest.mark.parametrize("case", ["rgb", "rgb_header", "header_disambiguates"])
def test_blob_decode_equals_jax(rng, case):
    if case == "header_disambiguates":
        # a headered uint8 blob whose length equals rows * cols * 2
        img = rng.randint(0, 255, (4, 5)).astype(np.uint8)
        raw, shape = np.uint64([4, 5]).tobytes() + np.uint32([0]).tobytes() + img.tobytes(), (4, 5)
        want = img.astype(np.float32)
    else:
        rgb = rng.randint(0, 255, (10, 14, 3)).astype(np.uint8)
        raw, shape = rgb.tobytes(), (10, 14)
        if case == "rgb_header":
            raw = np.uint64([10, 14]).tobytes() + np.uint32([0]).tobytes() + raw
        want = (0.299 * rgb[:, :, 0] + 0.587 * rgb[:, :, 1]
                + 0.114 * rgb[:, :, 2]).astype(np.float32)
    got = tboss._decode_image_blob(raw, *shape)
    np.testing.assert_array_equal(got, jboss._decode_image_blob(raw, *shape))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rgbd_logs_read_across_packages(tmp_path, rng, writer):
    boss_mod, ds_mod = PKGS[writer]
    frames = [ds_mod.RGBDFrame(timestamp=10.0 + 0.1 * i,
                               intensity=rng.randint(0, 255, (32, 40)).astype(np.float32),
                               depth=rng.randint(500, 5000, (32, 40)).astype(np.float32))
              for i in range(3)]
    log = os.path.join(tmp_path, "messages.json")
    assert boss_mod.write_boss_rgbd(log, frames, ds_mod.icl_camera()) == 3
    got_t, got_j = list(tboss.iter_boss_rgbd(log)), list(jboss.iter_boss_rgbd(log))
    assert len(got_t) == len(got_j) == 3
    for a, b, ref in zip(got_t, got_j, frames):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.intensity, b.intensity)
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_allclose(ref.intensity, a.intensity, atol=0.51)
        np.testing.assert_array_equal(np.uint16(ref.depth), np.uint16(a.depth))
    assert tboss.boss_camera(log) == jboss.boss_camera(log)
