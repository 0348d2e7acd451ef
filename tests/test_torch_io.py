"""The port's dataset readers and writers, rectification and native decoder
== the JAX package's, on the CPU.

No KITTI-odometry, TUM, EuRoC or Malaga sequence is in the repository, so
the test writes a tiny folder in each layout from the bundled frames (and
seeded noise where a size is fixed by the layout): KITTI odometry
(``image_0/ image_1/ times.txt`` and a poses file), TUM (``rgb.txt``,
``depth.txt``, RGB PNGs and 16-bit PNG depth, one image with no depth
within the pairing window), EuRoC (``mav0/cam{0,1}/data``, ``data.csv``
and ``sensor.yaml`` with a non-coplanar rig) and Malaga (``Images/``).
Bounds: images, timestamps and ground-truth poses exactly equal; the EuRoC
rectification tables and ``euroc_rectified_camera`` within 1e-9; the
port's ``sensor.yaml`` parser equal to ``yaml.safe_load``; trajectory and
PFM writers byte-identical; ``save_gray`` PNG, PGM and BMP files decode to
the same pixels both ways and its JPEG is PIL's file byte for byte (the
Malaga folder is also written as JPEG, read through the second image
library); the native decoder equal to the plain Python decoder and to the
JAX package's decoder on every bundled image, and its prefetcher in order.
"""
import glob
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import datasets as jds, native as jnative  # noqa: E402
from srrg2_proslam_tpu.io import rectify as jrect  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets as tds, native as tnative  # noqa: E402
from srrg2_proslam_tpu_torch.io import rectify as trect  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..", "test_data")
BUNDLED = sorted(glob.glob(os.path.join(ROOT, "kitti", "*", "*.png"))
                 + glob.glob(os.path.join(ROOT, "icl", "*"))
                 + glob.glob(os.path.join(ROOT, "xtion", "*"))
                 + glob.glob(os.path.join(ROOT, "scene_flow", "*.png")))
CROP = (slice(100, 164), slice(300, 396))       # 64 x 96 of each KITTI image

SENSOR_YAML = """\
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam{cam} (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [{T}]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [{fx}, {fy}, {cx}, {cy}] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def _kitti_pairs():
    frames = list(tds.iter_bundled_kitti(ROOT, "city"))
    return [(f.left[CROP], f.right[CROP], f.gt_pose) for f in frames[:3]]


def _frames_equal(got_t, got_j, fields):
    assert len(got_t) == len(got_j) > 0
    for a, b in zip(got_t, got_j):
        assert a.timestamp == b.timestamp
        for name in fields:
            x, y = getattr(a, name), getattr(b, name)
            if y is None:
                assert x is None
            else:
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("kitti_odometry")
    for sub in ("image_0", "image_1"):
        os.makedirs(d / sub)
    poses = []
    for i, (left, right, gt) in enumerate(_kitti_pairs()):
        tds.save_gray(str(d / "image_0" / f"{i:06d}.png"), left)
        tds.save_gray(str(d / "image_1" / f"{i:06d}.png"), right)
        poses.append(gt[:3].reshape(-1))
    np.savetxt(d / "times.txt", 0.1036 * np.arange(3) + 0.5)
    np.savetxt(d / "poses.txt", np.stack(poses))
    return d


@pytest.mark.parametrize("start,count", [(0, None), (1, 1)])
def test_kitti_odometry_equals_jax(kitti_dir, start, count):
    gt = str(kitti_dir / "poses.txt")
    got_t = list(tds.iter_kitti_odometry(str(kitti_dir), gt, start=start, count=count))
    got_j = list(jds.iter_kitti_odometry(str(kitti_dir), gt, start=start, count=count))
    _frames_equal(got_t, got_j, ("left", "right", "gt_pose"))
    assert len(got_t) == (3 if count is None else count)


def test_tum_rgbd_equals_jax(tmp_path, rng):
    for sub in ("rgb", "depth"):
        os.makedirs(tmp_path / sub)
    rgb_lines, depth_lines = ["# color images"], ["# depth maps"]
    for i in range(4):
        ts = 1305031102.175304 + 0.0333 * i
        rgb = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
        Image.fromarray(rgb, mode="RGB").save(tmp_path / "rgb" / f"{ts:.6f}.png")
        rgb_lines.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        if i == 2:
            continue            # no depth within the 0.02 s window: skipped
        dts = ts + 0.004 * (i - 1)
        depth = rng.randint(0, 60000, (48, 64)).astype(np.uint16)
        Image.fromarray(depth).save(tmp_path / "depth" / f"{dts:.6f}.png")
        depth_lines.append(f"{dts:.6f} depth/{dts:.6f}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(depth_lines) + "\n")
    for count in (None, 2):
        got_t = list(tds.iter_tum_rgbd(str(tmp_path), count=count))
        got_j = list(jds.iter_tum_rgbd(str(tmp_path), count=count))
        _frames_equal(got_t, got_j, ("intensity", "depth"))
        assert len(got_t) == (3 if count is None else 2)
    assert got_t[0].depth.max() > 255     # 16-bit depth kept in raw units


def _euroc_rig():
    ry, rx = np.deg2rad(1.5), np.deg2rad(0.8)
    Ry = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0], [-np.sin(ry), 0, np.cos(ry)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)], [0, np.sin(rx), np.cos(rx)]])
    T_BS0 = np.eye(4)
    T_BS0[:3, :3] = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422],
                              [0.999557249008, 0.0149672133247, 0.025715529948],
                              [-0.0257744366974, 0.00375618835797, 0.999660727178]])
    T_BS0[:3, 3] = [-0.0216401454975, -0.064676986768, 0.00981073058949]
    T_10 = np.eye(4)
    T_10[:3, :3] = Ry @ Rx
    T_10[:3, 3] = [-0.11, 0.002, 0.003]
    return T_BS0, T_BS0 @ np.linalg.inv(T_10)


@pytest.fixture(scope="module")
def euroc_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("euroc")
    rng = np.random.RandomState(1)
    stamps = [1403636579763555584 + 50000000 * i for i in range(2)]
    for cam, T_BS, (fx, fy, cx, cy) in zip(
            (0, 1), _euroc_rig(), ((458.654, 457.296, 367.215, 248.375),
                                   (457.587, 456.134, 379.999, 255.238))):
        cam_dir = d / "mav0" / f"cam{cam}"
        os.makedirs(cam_dir / "data")
        (cam_dir / "sensor.yaml").write_text(SENSOR_YAML.format(
            cam=cam, fx=fx, fy=fy, cx=cx, cy=cy,
            T=",\n         ".join(", ".join(repr(float(v)) for v in row) for row in T_BS)))
        lines = ["#timestamp [ns],filename"]
        for ns in stamps:
            tds.save_gray(str(cam_dir / "data" / f"{ns}.png"),
                          rng.randint(0, 256, (480, 752)).astype(np.float32))
            lines.append(f"{ns},{ns}.png")
        (cam_dir / "data.csv").write_text("\n".join(lines) + "\n")
    return d


def test_sensor_yaml_parser_equals_pyyaml(euroc_dir):
    for cam in (0, 1):
        text = (euroc_dir / "mav0" / f"cam{cam}" / "sensor.yaml").read_text()
        assert trect.parse_sensor_yaml(text) == yaml.safe_load(text)
    # scalars PyYAML resolves otherwise than a float() would
    text = "a: 1e-05\nb: 1_000\nc: .5\nd: [1, 2.0, x, true]\ne: ~\nf: -3\n"
    assert trect.parse_sensor_yaml(text) == yaml.safe_load(text)


def test_euroc_rectification_equals_jax(euroc_dir):
    rt = trect.find_euroc_rectification(str(euroc_dir))
    rj = jrect.find_euroc_rectification(str(euroc_dir))
    for name in ("R_rect0", "R_rect1", "map0", "map1", "T_B_rect"):
        np.testing.assert_allclose(getattr(rt, name), getattr(rj, name), atol=1e-9, rtol=0,
                                   err_msg=name)
    assert rt.baseline_m == pytest.approx(rj.baseline_m, abs=1e-9)
    np.testing.assert_allclose(tuple(tds.euroc_rectified_camera(str(euroc_dir))),
                               tuple(jds.euroc_rectified_camera(str(euroc_dir))), atol=1e-9)
    c_t = trect.load_asl_sensor_yaml(str(euroc_dir / "mav0" / "cam1" / "sensor.yaml"))
    c_j = jrect.load_asl_sensor_yaml(str(euroc_dir / "mav0" / "cam1" / "sensor.yaml"))
    np.testing.assert_array_equal(c_t.T_BS, c_j.T_BS)
    assert (c_t.fx, c_t.k1, c_t.p2, c_t.rows, c_t.cols) == (c_j.fx, c_j.k1, c_j.p2,
                                                           c_j.rows, c_j.cols)


@pytest.mark.parametrize("rectify", [True, False])
def test_euroc_stereo_equals_jax(euroc_dir, rectify):
    got_t = list(tds.iter_euroc_stereo(str(euroc_dir), rectify=rectify))
    got_j = list(jds.iter_euroc_stereo(str(euroc_dir), rectify=rectify))
    _frames_equal(got_t, got_j, ("left", "right"))
    assert len(got_t) == 2 and got_t[0].left.shape == (480, 752)


def test_malaga_stereo_equals_jax(tmp_path):
    for ext in ("png", "jpg"):         # JPEG takes the second image library
        img = tmp_path / ext / "Images"
        os.makedirs(img)
        for i, (left, right, _) in enumerate(_kitti_pairs()):
            stamp = f"img_CAMERA1_{1261228749.918590 + 0.05 * i:.6f}"
            tds.save_gray(str(img / f"{stamp}_left.{ext}"), left)
            if i != 1:                     # a left image without its right: skipped
                tds.save_gray(str(img / f"{stamp}_right.{ext}"), right)
        for count in (None, 1):
            got_t = list(tds.iter_malaga_stereo(str(tmp_path / ext), count=count))
            got_j = list(jds.iter_malaga_stereo(str(tmp_path / ext), count=count))
            _frames_equal(got_t, got_j, ("left", "right"))
            assert len(got_t) == (2 if count is None else 1)


@pytest.mark.parametrize("name", ["kitti_camera", "icl_camera", "tum_camera",
                                  "euroc_camera", "malaga_camera"])
def test_cameras_equal_jax(name):
    assert tuple(getattr(tds, name)()) == tuple(getattr(jds, name)())


def test_trajectory_writers_byte_identical(tmp_path, rng):
    from srrg2_proslam_tpu_torch.ops import se3

    poses = list(se3.exp(torch.from_numpy(rng.normal(0, 0.5, (6, 6)).astype(np.float32)))
                 .numpy())
    stamps = list(1305031102.175304 + 0.1 * np.arange(6))
    for writer, args in (("write_kitti_trajectory", (poses,)),
                         ("write_tum_trajectory", (stamps, poses))):
        getattr(tds, writer)(str(tmp_path / "t.txt"), *args)
        getattr(jds, writer)(str(tmp_path / "j.txt"), *args)
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_pfm_write_byte_identical_and_read(tmp_path, rng):
    img = rng.uniform(-5, 300, (24, 40)).astype(np.float32)
    tds.write_pfm(str(tmp_path / "t.pfm"), img)
    jds.write_pfm(str(tmp_path / "j.pfm"), img)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(tds.read_pfm(str(tmp_path / "t.pfm")), img)
    # a big-endian 3-channel PFM with a comment line
    rgb = rng.uniform(0, 1, (5, 7, 3)).astype(">f4")
    (tmp_path / "c.pfm").write_bytes(b"PF\n# x\n7 5\n1.0\n" + rgb[::-1].tobytes())
    np.testing.assert_array_equal(tds.read_pfm(str(tmp_path / "c.pfm")),
                                  jds.read_pfm(str(tmp_path / "c.pfm")))


@pytest.mark.parametrize("ext", ["png", "pgm", "jpg", "bmp"])
def test_save_gray_both_ways(tmp_path, rng, ext):
    img = rng.uniform(-20, 280, (37, 53)).astype(np.float32)
    want = np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)
    tds.save_gray(str(tmp_path / f"t.{ext}"), img)          # the port's writer
    jds.save_gray(str(tmp_path / f"j.{ext}"), img)          # PIL's
    if ext == "jpg":    # lossy: the port writes PIL's bytes, so both read back alike
        assert (tmp_path / "t.jpg").read_bytes() == (tmp_path / "j.jpg").read_bytes()
        want = jds.load_gray(str(tmp_path / "j.jpg"))
    np.testing.assert_array_equal(jds.load_gray(str(tmp_path / f"t.{ext}")), want)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / f"t.{ext}"), np.float32),
                                  want)
    np.testing.assert_array_equal(tds.load_gray(str(tmp_path / f"j.{ext}")), want)
    if ext in ("png", "pgm"):
        np.testing.assert_array_equal(tds.decode_plain(str(tmp_path / f"j.{ext}")),
                                      want.astype(np.uint8))


@pytest.mark.parametrize("path", BUNDLED, ids=lambda p: os.path.relpath(p, ROOT))
def test_native_decoder_equals_plain_and_jax(path):
    got = tnative.decode(path)
    ref = tds.decode_plain(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jnative.decode(path))
    if path.endswith(".pgm"):
        np.testing.assert_array_equal(tds.load_depth(path), jds.load_depth(path))
    else:
        np.testing.assert_array_equal(tds.load_gray(path), jds.load_gray(path))


def test_prefetcher_in_order():
    with tnative.Prefetcher(BUNDLED, n_threads=3, window=2) as pf:
        got = list(pf)
    assert len(got) == len(BUNDLED)
    for arr, path in zip(got, BUNDLED):
        np.testing.assert_array_equal(arr, tds.decode_plain(path))


def test_native_decoder_refuses_unknown_files(tmp_path):
    bad = tmp_path / "x.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0 not a png")
    with pytest.raises(ValueError):
        tnative.decode(str(bad))
    with pytest.raises(ValueError):
        list(tnative.Prefetcher([str(bad)]))
