"""The port's CUDA kernels == their plain PyTorch versions, on the card.

Needs a CUDA card and nvcc (the kernels build at first use); skips
elsewhere.  Run on a GPU machine with:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports jax, which a machine that
only runs the port need not have.)

Bounds: FAST scores bit-exact over the whole image (KITTI frame 0's pair,
noise, a flat image with no candidates, non-integer values, spikes at the
edges; B = 1, 2, 5 and shapes that are not multiples of the kernel's tile)
and BRIEF descriptors
bit-exact at every keypoint (min/max/subtraction and comparisons are
exact); the GN burst X within
atol 5e-4 of the plain burst with num_terms exact and inliers within 1
(the reduction order differs), as tests/test_gn_pallas.py bounds the TPU
kernel.
"""
import os

import numpy as np
import pytest
import torch

from srrg2_proslam_tpu_torch.io import datasets
from srrg2_proslam_tpu_torch.kernels import brief, fast, gn, launch_counts, reset_launch_counts
from srrg2_proslam_tpu_torch.ops import se3
from srrg2_proslam_tpu_torch.ops.features import BORDER, _boxfilter
from srrg2_proslam_tpu_torch.ops.pinhole import Camera

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card"),
]


DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")


@pytest.fixture()
def rng():
    return np.random.RandomState(0)


CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, rows=480, cols=640, baseline_px=45.0)


def _fast_input(rng, kind, shape):
    if kind == "uniform":
        return rng.randint(0, 256, shape).astype(np.float32)
    if kind == "flat":          # no pixel passes the compass test
        return np.zeros(shape, np.float32)
    if kind == "gaussian":      # non-integer values
        return rng.normal(0.0, 50.0, shape).astype(np.float32)
    if kind == "spikes":        # bright spikes within 3 px of every edge
        img = rng.randint(0, 30, shape).astype(np.float32)
        B, H, W = shape
        for e in range(3):
            for y, x in ((e, W // 2), (H - 1 - e, W // 3), (H // 2, e), (H // 3, W - 1 - e),
                         (e, e), (H - 1 - e, W - 1 - e)):
                img[:, y, x] = 255.0
        return img
    frame = next(iter(datasets.iter_bundled_kitti(DATA, "city")))
    return np.stack([frame.left, frame.right]).astype(np.float32)


@pytest.mark.parametrize("kind,shape", [
    ("kitti", (2, 376, 1241)),
    ("uniform", (2, 376, 1241)), ("uniform", (1, 37, 45)), ("uniform", (3, 64, 160)),
    ("uniform", (5, 100, 300)), ("uniform", (1, 17, 129)), ("uniform", (2, 130, 33)),
    ("flat", (2, 376, 1241)), ("flat", (1, 20, 70)),
    ("gaussian", (2, 376, 1241)), ("gaussian", (5, 61, 97)),
    ("spikes", (1, 40, 50)), ("spikes", (2, 129, 257)), ("spikes", (5, 16, 128)),
])
def test_fast_kernel_matches_plain(rng, kind, shape):
    img = torch.from_numpy(_fast_input(rng, kind, shape)).cuda()
    for thr in (0.0, 15.0, 60.0):
        before = fast.launches
        got = fast.fast_scores_kernel(img, thr)
        assert fast.launches == before + 1
        ref = fast.fast_scores_plain(img, thr)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)
        assert int((ref > 0).sum()) == 0 if kind == "flat" else int((ref > 0).sum()) > 0


@pytest.mark.parametrize("shape,n", [((2, 376, 1241), 1152), ((1, 37, 45), 50),
                                     ((2, 96, 160), 300), ((1, 96, 160), 7)])
def test_brief_kernel_matches_plain(rng, shape, n):
    B, H, W = shape
    img = torch.from_numpy(rng.randint(0, 256, shape).astype(np.float32)).cuda()
    smooth = _boxfilter(img, 5).contiguous()
    b = BORDER
    # half anywhere in the image (samples fall outside: zeros), half clipped
    # as the frontend clips, with the clip's corners in the first rows
    y = rng.randint(0, H, (B, n))
    x = rng.randint(0, W, (B, n))
    y[:, n // 2:] = np.clip(y[:, n // 2:], b, max(b, H - b - 1))
    x[:, n // 2:] = np.clip(x[:, n // 2:], b, max(b, W - b - 1))
    y[:, :2], x[:, :2] = [b, H - b - 1], [b, W - b - 1]
    valid = rng.uniform(size=(B, n)) < 0.8
    valid[:, 0] = False
    y, x, valid = (torch.from_numpy(a).cuda() for a in (y.astype(np.int64), x.astype(np.int64), valid))
    before = brief.launches
    got = brief.brief_descriptors(smooth, y, x, valid)
    assert brief.launches == before + 1
    ref = brief.brief_descriptors_plain(smooth, y, x, valid)
    dense = brief.descriptors_from_planes(brief.brief_bitplanes_plain(smooth), y, x)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and got.shape == (B, n, 256)
    assert torch.equal(got, ref)
    assert torch.equal(got, torch.where(valid[..., None], dense, -1).to(torch.int8))
    assert bool((got[~valid] == -1).all())


def _gn_problem(rng, n, outliers, n_valid, w_range):
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    pts[:, 2] += 8.0
    X_gt = se3.exp(torch.tensor([0.2, -0.1, 0.35, 0.02, -0.01, 0.03]))
    p = se3.transform_points(X_gt, torch.from_numpy(pts)).numpy()
    meas = np.stack([CAM.fx * p[:, 0] / p[:, 2] + CAM.cx,
                     CAM.fy * p[:, 1] / p[:, 2] + CAM.cy,
                     CAM.fx * p[:, 0] / p[:, 2] + CAM.cx - CAM.baseline_px / p[:, 2]],
                    -1).astype(np.float32)
    meas[:outliers] += rng.uniform(50, 200, (outliers, 3)).astype(np.float32)
    w = rng.uniform(*w_range, (n,)).astype(np.float32)
    mask = np.arange(n) < n_valid
    return [torch.from_numpy(a).cuda() for a in (pts, meas, w, mask)]


@pytest.mark.parametrize("n,eps,outliers,n_valid,w_range", [
    (300, 0.0, 0, 300, (0.5, 2.0)),
    (300, 1e-5, 30, 300, (0.5, 2.0)),
    (300, 0.0, 0, 4, (0.5, 2.0)),
    (1152, 0.0, 40, 1000, (5e3, 2e4)),
    (1000, 0.0, 20, 997, (0.5, 2.0)),      # C not a multiple of the CTA's threads
    (300, 0.0, 0, 0, (0.5, 2.0)),          # no active term
    (300, 1e-2, 0, 300, (0.5, 2.0)),       # epsilon stops the burst early
    (3000, 0.0, 100, 3000, (0.5, 2.0)),    # more active rows than registers hold
])
def test_gn_kernel_matches_plain(rng, n, eps, outliers, n_valid, w_range):
    args = _gn_problem(rng, n, outliers, n_valid, w_range)
    X0 = se3.identity("cuda")
    kw = dict(iterations=5, damping=1e-6, min_inliers=6, epsilon=eps, chi_threshold=25.0)
    X_k, s_k = gn.gn_burst_stereo(X0, *args, CAM, **kw)
    X_p, s_p = gn.gn_burst_stereo_plain(X0, *args, CAM, **kw)
    torch.cuda.synchronize()
    assert s_k.num_inliers.dtype == s_k.num_terms.dtype == torch.int32
    assert torch.equal(X_k[3], X0[3])
    assert float((X_k - X_p).abs().max()) <= 5e-4
    assert int(s_k.num_terms) == int(s_p.num_terms)
    assert abs(int(s_k.num_inliers) - int(s_p.num_inliers)) <= 1
    np.testing.assert_allclose(float(s_k.chi_total), float(s_p.chi_total), rtol=1e-2, atol=1e-2)


def test_kernel_switches_keep_kernels_on_cuda(rng):
    """dense_brief=False and gn_pallas=False still take K1 and K2 on the card."""
    from srrg2_proslam_tpu_torch.models import frontend, tracker
    from srrg2_proslam_tpu_torch.ops.features import FeatureExtractorConfig

    cam = Camera(fx=100.0, fy=100.0, cx=80.0, cy=48.0, rows=96, cols=160, baseline_px=10.0)
    left, right = (torch.from_numpy(rng.randint(0, 256, (96, 160)).astype(np.float32)).cuda()
                   for _ in range(2))
    reset_launch_counts()
    meas = frontend.adapt_stereo(left, right, frontend.StereoAdaptorConfig(
        extractor=FeatureExtractorConfig(dense_brief=False)))
    tracker.track_step(tracker.initial_state(64, "cuda"), meas.points, meas.desc, meas.valid,
                       cam, tracker.TrackerConfig(gn_pallas=False), "stereo")
    assert launch_counts() == {"fast": 1, "brief": 1, "gn_burst": 3}


def test_launch_counters_and_input_checks(rng):
    reset_launch_counts()
    img = torch.zeros(1, 40, 50, device="cuda")
    y = torch.full((1, 3), 20, dtype=torch.int64, device="cuda")
    ok = torch.ones(1, 3, dtype=torch.bool, device="cuda")
    fast.fast_scores_kernel(img, 15.0)
    brief.brief_descriptors(img, y, y, ok)
    assert launch_counts() == {"fast": 1, "brief": 1, "gn_burst": 0}
    with pytest.raises(ValueError):
        fast.fast_scores_kernel(img.transpose(1, 2), 15.0)
    with pytest.raises(ValueError):
        brief.brief_descriptors(img.double(), y, y, ok)
    with pytest.raises(ValueError):
        brief.brief_descriptors(img, y.cpu(), y, ok)
    with pytest.raises(ValueError):
        brief.brief_descriptors(img.transpose(1, 2).contiguous().transpose(1, 2), y, y, ok)
    assert launch_counts() == {"fast": 1, "brief": 1, "gn_burst": 0}
