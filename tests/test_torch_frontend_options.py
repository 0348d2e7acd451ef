"""The port's frontend options == the JAX package's, on the CPU: oriented
BRIEF, the sub-pixel disparity refinement, the brute-force matcher, the
detection mask and the batched adaptors.

Bounds, measured on the CPU before they were pinned:

* ``_centroid_angles`` (two 31x31 convolutions, then atan2; torch's
  convolution sums in another order than XLA's): 99 % of the pixels of
  a KITTI image within 1e-4 rad of JAX's, the median within 1e-6
  (observed: 3e-5 and 4.8e-7; where a patch is nearly flat the moments
  nearly vanish and the angle is ill-conditioned: up to 0.05 rad there).
* Oriented descriptors read bilinear samples at rotated pairs, so an ulp
  of angle can flip a bit where two samples nearly tie: on the 5 KITTI
  pairs and the scene-flow pair under ``euroc_adaptor.json`` (oriented,
  sub-pixel, 2 px epipolar band) at most ``ORIENTED_BITS`` bits of the
  measurements' descriptors differ per frame (1 bit in one frame
  observed); keypoints, the valid mask and uL/v are bit-exact.
* Sub-pixel u_R: ``refine_disparity(_batch)`` is bit-exact with the JAX
  functions run op by op; JAX's jitted adaptor fuses the arithmetic in
  its own way: u_R within ``UR_ATOL`` px on at most
  ``UR_MAX_DIFF`` matches per frame (1 ulp on at most one match observed),
  the rest bit-exact, under ``aggressive_motion_adaptor.json`` (upright,
  sub-pixel) and ``euroc_adaptor.json``.
* The brute-force matcher, ``stripe_mask`` and the detection mask:
  bit-exact.
* Batched adaptors (``adapt_stereo_batch`` at B = 16, ``adapt_rgbd_batch``)
  equal the per-frame adaptors bit for bit, upright and oriented.

Gates ported from tests/test_oriented_features.py (matching across a 45
and 90 degree rotation keeps >= 60 % of the upright zero-rotation inlier
ratio with oriented BRIEF; upright collapses below 5 % at 60 degrees) and
tests/test_stereo_quality.py (the scene-flow pair: >= 60 % disparity
inliers at 1 px, sub-half-pixel median; the refinement loses no inliers)
hold for the port's own functions.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import frontend as jfe  # noqa: E402
from srrg2_proslam_tpu.ops import features as JF, matching as JM  # noqa: E402
from srrg2_proslam_tpu.ops import subpixel as JS  # noqa: E402
from srrg2_proslam_tpu.utils import config as jcfg  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend  # noqa: E402
from srrg2_proslam_tpu_torch.ops import features as TF, matching as TM  # noqa: E402
from srrg2_proslam_tpu_torch.ops import subpixel as TS  # noqa: E402
from srrg2_proslam_tpu_torch.utils import config as tcfg  # noqa: E402
from tests.test_oriented_features import _rotate, _texture  # noqa: E402
from tests.test_stereo_quality import _evaluate  # noqa: E402
from tests.torch_bounds import ORIENTED_BITS, UR_ATOL  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "test_data")
CONFIGS = os.path.join(ROOT, "configurations")
UR_MAX_DIFF = 2
THETA_ATOL = 1e-4


@pytest.fixture(scope="module")
def kitti():
    return list(datasets.iter_bundled_kitti(DATA, "city"))


@pytest.fixture(scope="module")
def scene_flow():
    L = datasets.load_gray(os.path.join(DATA, "scene_flow", "image_left.png"))
    R = datasets.load_gray(os.path.join(DATA, "scene_flow", "image_right.png"))
    gt = {}
    with open(os.path.join(DATA, "scene_flow", "gt_stereo_matching_threshold-10.txt")) as f:
        for line in f:
            r, c, _, _, d = line.split()
            gt[(int(r), int(c))] = float(d)
    return L, R, gt


# ---- gates of tests/test_oriented_features.py -----------------------------

def _match_ratio(img, deg, oriented):
    """(correct, wrong, co-visible) matching img against its rotation."""
    fc = TF.FeatureExtractorConfig(max_keypoints=576, oriented=oriented,
                                   detector_threshold=10.0)
    mc = TM.BruteforceMatcherConfig(maximum_descriptor_distance=60.0, lowe_ratio=0.8)
    rot, R, c = _rotate(img, deg)
    fa = TF.extract_features(torch.from_numpy(img), fc)
    fb = TF.extract_features(torch.from_numpy(rot), fc)
    m = TM.match_bruteforce(fa.desc, fa.valid, fb.desc, fb.valid, mc)
    idx, mask = m.idx.numpy(), m.mask.numpy()
    uva, uvb = fa.uv.numpy(), fb.uv.numpy()
    pred = (uva - c) @ R.T + c
    H, W = img.shape
    B = TF.BORDER
    covis = (fa.valid.numpy() & (pred[:, 0] >= B) & (pred[:, 0] < W - B)
             & (pred[:, 1] >= B) & (pred[:, 1] < H - B))
    dist = np.linalg.norm(pred - uvb[np.maximum(idx, 0)], axis=1)
    good = mask & covis & (dist < 4.0)
    wrong = mask & covis & ~good
    return int(good.sum()), int(wrong.sum()), int(covis.sum())


def test_oriented_descriptors_survive_rotation(rng):
    img = _texture(rng)
    up_good, _, up_n = _match_ratio(img, 0.0, oriented=False)
    upright_ratio = up_good / up_n
    assert upright_ratio >= 0.85
    for deg in (45.0, 90.0):
        good, wrong, n = _match_ratio(img, deg, oriented=True)
        assert good / n >= 0.6 * upright_ratio, (deg, good / n, upright_ratio)
        assert wrong <= 0.05 * max(good, 1), (deg, good, wrong)


def test_upright_descriptors_collapse_under_rotation(rng):
    good, _, n = _match_ratio(_texture(rng), 60.0, oriented=False)
    assert good / n < 0.05


def test_oriented_matches_upright_at_zero_rotation(rng):
    img = _texture(rng)
    up_good, _, up_n = _match_ratio(img, 0.0, oriented=False)
    o_good, _, o_n = _match_ratio(img, 0.0, oriented=True)
    assert o_good / o_n >= 0.9 * (up_good / up_n)


# ---- gates of tests/test_stereo_quality.py --------------------------------

def test_stereo_adaptor_beats_reference_inlier_ratio(scene_flow):
    L, R, gt = scene_flow
    m = frontend.adapt_stereo(torch.from_numpy(L), torch.from_numpy(R),
                              frontend.StereoAdaptorConfig())
    n_gt, n_in, errs = _evaluate(m.points.numpy(), m.valid.numpy(), gt)
    assert n_gt > 150, n_gt
    assert n_in / n_gt >= 0.60, (n_in, n_gt)
    assert np.median(errs) < 0.5


def test_stereo_adaptor_subpixel_no_regression(scene_flow):
    L, R, gt = scene_flow
    counts = []
    for sub in (False, True):
        m = frontend.adapt_stereo(torch.from_numpy(L), torch.from_numpy(R),
                                  frontend.StereoAdaptorConfig(subpixel_refinement=sub))
        counts.append(_evaluate(m.points.numpy(), m.valid.numpy(), gt)[1])
    assert counts[1] >= counts[0] - 3, counts


# ---- functions against JAX ------------------------------------------------

def test_centroid_angles_match_jax(kitti):
    img = kitti[0].left
    smooth = TF._boxfilter(torch.from_numpy(img), 5)
    got = TF._centroid_angles(smooth).numpy()
    ref = np.asarray(JF._centroid_angles(JF._boxfilter(jnp.asarray(img), 5)))
    d = np.abs(got - ref)
    d = np.minimum(d, 2 * np.pi - d)[TF.BORDER:-TF.BORDER, TF.BORDER:-TF.BORDER]
    assert np.quantile(d, 0.99) <= THETA_ATOL, np.quantile(d, 0.99)
    assert np.median(d) <= 1e-6, np.median(d)


def test_oriented_descriptors_match_jax(kitti):
    """compute_descriptors with ``oriented`` at a KITTI image's keypoints."""
    img = kitti[1].left
    cfg = TF.FeatureExtractorConfig(oriented=True)
    uv, _, valid = TF.detect_keypoints(torch.from_numpy(img), cfg)
    got = TF.compute_descriptors(torch.from_numpy(img), uv, valid, cfg).numpy()
    ref = np.asarray(JF.compute_descriptors(
        jnp.asarray(img), jnp.asarray(uv.numpy()), jnp.asarray(valid.numpy()),
        JF.FeatureExtractorConfig(oriented=True)))
    assert int(valid.sum()) > 1000
    assert (got != ref).sum() <= ORIENTED_BITS, (got != ref).sum()


def test_refine_disparity_matches_jax(rng):
    B, H, W, N = 3, 60, 200, 300
    L = rng.randint(0, 256, (B, H, W)).astype(np.float32)
    R = rng.randint(0, 256, (B, H, W)).astype(np.float32)
    uvl = np.stack([rng.uniform(5, W - 5, (B, N)), rng.uniform(5, H - 5, (B, N))],
                   -1).astype(np.float32)
    uvr = uvl.copy()
    uvr[..., 0] -= rng.uniform(0, 3, (B, N)).astype(np.float32)
    got = TS.refine_disparity_batch(*map(torch.from_numpy, (L, R, uvl, uvr))).numpy()
    ref = np.asarray(JS.refine_disparity_batch(*map(jnp.asarray, (L, R, uvl, uvr))))
    np.testing.assert_array_equal(got, ref)
    assert (got != uvr[..., 0]).mean() > 0.3   # most matches moved
    one = TS.refine_disparity(*map(torch.from_numpy, (L[1], R[1], uvl[1], uvr[1]))).numpy()
    np.testing.assert_array_equal(one, got[1])


def test_match_bruteforce_matches_jax(rng):
    a = np.where(rng.uniform(size=(120, 256)) < 0.5, 1, -1).astype(np.int8)
    b = np.where(rng.uniform(size=(150, 256)) < 0.5, 1, -1).astype(np.int8)
    b[:60] = a[:60] * np.where(rng.uniform(size=(60, 256)) < 0.08, -1, 1).astype(np.int8)
    b[60:70] = b[:10]                         # duplicates: ties go to the first index
    va, vb = rng.uniform(size=120) < 0.9, rng.uniform(size=150) < 0.9
    for kw in (dict(), dict(maximum_descriptor_distance=30.0, lowe_ratio=0.8)):
        got = TM.match_bruteforce(*map(torch.from_numpy, (a, va, b, vb)),
                                  TM.BruteforceMatcherConfig(**kw))
        ref = JM.match_bruteforce(*map(jnp.asarray, (a, va, b, vb)),
                                  JM.BruteforceMatcherConfig(**kw))
        for name in ("idx", "distance", "mask"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)
        assert int(got.mask.sum()) > 20


def test_stripe_and_detection_masks_match_jax(rng):
    img = rng.randint(0, 256, (80, 130)).astype(np.float32)
    seed_v = rng.uniform(0, 80, 12).astype(np.float32)
    seed_ok = rng.uniform(size=12) < 0.7
    got = TF.stripe_mask(80, 130, torch.from_numpy(seed_v), torch.from_numpy(seed_ok))
    ref = JF.stripe_mask(80, 130, jnp.asarray(seed_v), jnp.asarray(seed_ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.numpy().mean() < 1
    kw = dict(max_keypoints=90)
    for oriented in (False, True):
        f_t = TF.extract_features(torch.from_numpy(img), TF.FeatureExtractorConfig(
            oriented=oriented, **kw), got)
        f_j = JF.extract_features(jnp.asarray(img), JF.FeatureExtractorConfig(
            oriented=oriented, **kw), ref)
        for name in ("uv", "response", "valid", "desc"):
            np.testing.assert_array_equal(getattr(f_t, name).numpy(),
                                          np.asarray(getattr(f_j, name)), err_msg=name)
        v = f_t.uv.numpy()[f_t.valid.numpy(), 1]   # integer row +- 0.5 sub-pixel
        inside = got.numpy()[np.floor(v).astype(int), 0] | got.numpy()[np.ceil(v).astype(int), 0]
        assert inside.all()                   # detections only inside the stripes


def _adaptor_pairs(kitti, scene_flow):
    return [(f.left, f.right) for f in kitti] + [scene_flow[:2]]


@pytest.mark.parametrize("name", ["euroc_adaptor", "aggressive_motion_adaptor"])
def test_shipped_adaptors_match_jax(kitti, scene_flow, name):
    """The 5 KITTI pairs and the scene-flow pair, each package under its own
    load of the file."""
    path = os.path.join(CONFIGS, f"{name}.json")
    jc, tc = jcfg.load(path), tcfg.load(path)
    assert tc.subpixel_refinement and tc.extractor.oriented == (name == "euroc_adaptor")
    for i, (l, r) in enumerate(_adaptor_pairs(kitti, scene_flow)):
        jm = jfe.adapt_stereo(jnp.asarray(l), jnp.asarray(r), jc)
        tm = frontend.adapt_stereo(torch.from_numpy(l), torch.from_numpy(r), tc)
        jp, jd, jv = (np.asarray(x) for x in jm)
        tp, td, tv = (x.numpy() for x in tm)
        np.testing.assert_array_equal(tv, jv, err_msg=f"pair {i} valid")
        assert tv.sum() > 150
        for col in (0, 1, 3):
            np.testing.assert_array_equal(tp[:, col], jp[:, col], err_msg=f"pair {i}")
        ur = np.abs(tp[:, 2] - jp[:, 2])
        assert ur.max() <= UR_ATOL and (ur > 0).sum() <= UR_MAX_DIFF, (i, ur.max())
        bits = int((td != jd).sum())
        assert bits <= (ORIENTED_BITS if tc.extractor.oriented else 0), (i, bits)


def _crops(kitti, n=16, width=400):
    """n crops [n, 376, width] of the KITTI pairs, at three column offsets."""
    out = [(f.left[:, c:c + width], f.right[:, c:c + width])
           for c in (0, 420, 840) for f in kitti][:n]
    out += out[:n - len(out)]
    return [np.ascontiguousarray(np.stack(s)) for s in zip(*out)]


@pytest.mark.parametrize("name", ["euroc_adaptor", "aggressive_motion_adaptor"])
def test_batched_stereo_adaptor_equals_per_frame(kitti, name):
    cfg = tcfg.load(os.path.join(CONFIGS, f"{name}.json"))
    lefts, rights = (torch.from_numpy(x) for x in _crops(kitti))
    batch = frontend.adapt_stereo_batch(lefts, rights, cfg)
    assert batch.points.shape == (16, 1152, 4)
    for i in range(16):
        one = frontend.adapt_stereo(lefts[i], rights[i], cfg)
        for got, ref in zip(batch, one):
            assert torch.equal(got[i], ref), i
    assert int(batch.valid.sum()) > 16 * 100


@pytest.mark.parametrize("oriented", [False, True])
def test_batched_rgbd_adaptor_equals_per_frame(oriented):
    frames = list(datasets.iter_bundled_icl(DATA))
    cfg = frontend.DepthAdaptorConfig(
        extractor=frontend.FeatureExtractorConfig(oriented=oriented))
    intens = torch.stack([torch.from_numpy(f.intensity) for f in frames])
    depths = torch.stack([torch.from_numpy(f.depth) for f in frames])
    batch = frontend.adapt_rgbd_batch(intens, depths, cfg)
    for i, f in enumerate(frames):
        one = frontend.adapt_rgbd(intens[i], depths[i], cfg)
        for got, ref in zip(batch, one):
            assert torch.equal(got[i], ref), i
    jm = jfe.adapt_rgbd(jnp.asarray(frames[0].intensity), jnp.asarray(frames[0].depth),
                        jfe.DepthAdaptorConfig(extractor=jfe.FeatureExtractorConfig(
                            oriented=oriented)))
    np.testing.assert_array_equal(batch.valid[0].numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(batch.points[0].numpy(), np.asarray(jm.points))
    bits = int((batch.desc[0].numpy() != np.asarray(jm.desc)).sum())
    assert bits <= (ORIENTED_BITS if oriented else 0), bits
