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
kernel.  A short GraphSLAM run (an out-and-back walk through a random
world, with closures and a relocalisation, at most 2 finished-map arenas
kept on the card) on the card gives the CPU run's
per-frame status and map, counts and closure events, and its trajectory
within 1e-3 m / 1e-3 rad.  The RGB-D path: FAST and BRIEF bit-exact at
ICL frame 0's [1, 480, 640] and its keypoints; ICL frames 0 -> 1 through
``adapt_rgbd -> track_step(model="rgbd")`` on the card give the CPU run's
measurements bit for bit, its counts, and its pose within 5e-4 (the GN
route with no kernel: launches FAST 2, BRIEF 2, GN 0); a smoother step
(KITTI frames 0 -> 1, stereo) on the card gives the CPU run's counts,
pose within 5e-4, positions within 1e-3 m and buffers within 1e-3.
Slice 6: K3 and K1 at B = 32 bit-exact against their plain versions and
per image against B = 1; the batched stereo adaptor at B = 16 equal to the
per-frame adaptor on the card; the shipped oriented / sub-pixel adaptors
on the card against the CPU (keypoints and uL/v bit-exact, u_R within
UR_ATOL px, oriented descriptor bits within ORIENTED_BITS per frame, both
pinned in tests/torch_bounds.py);
``process_meas_sequence`` (the chunk program: a CUDA graph per chunk) on
the card against the CPU's synchronous loop (GN launches 3 per tracker
step: graph replays, eager frames and the graph's warm-up); one chunk of
that walk through its CUDA graph against ``chunk_frames`` run eagerly on
the card (packet counts and maps equal, poses within 1e-4).
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
# by module name, not as tests.torch_bounds: pytest puts tests/ on sys.path,
# and an installed package named ``tests`` would shadow the directory
from torch_bounds import ORIENTED_BITS, UR_ATOL

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
    tracker.track_step(tracker.initial_state(64, device="cuda"), meas.points, meas.desc, meas.valid,
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


def _walk_frames(rng, cam):
    """tests/test_relocalization.py's stream: a random world seen from an
    out-and-back walk along z, as (points [N, 4], desc, valid) numpy."""
    n = 500
    pts_w = np.stack([rng.uniform(-15, 15, n), rng.uniform(-5, 5, n),
                      rng.uniform(2, 40, n)], axis=1).astype(np.float32)
    desc = rng.choice(np.array([-1, 1], np.int8), size=(n, 256))
    frames = []
    for z in list(np.arange(0, 3.5, 0.25)) + list(np.arange(3.5, -0.01, -0.25)):
        p = pts_w + np.array([0.0, 0.0, -z], np.float32)
        zs = np.maximum(p[:, 2], 0.5)
        u = cam.fx * p[:, 0] / zs + cam.cx
        v = cam.fy * p[:, 1] / zs + cam.cy
        ur = u - cam.baseline_px / zs
        ok = (p[:, 2] > 0.5) & (u >= 0) & (u < cam.cols) & (v >= 0) & (v < cam.rows) & (ur >= 0)
        frames.append((np.stack([u, v, ur, v], 1).astype(np.float32), desc, ok))
    return frames


def test_graphslam_on_the_card_matches_cpu(rng):
    from srrg2_proslam_tpu_torch.models import slam
    from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig

    cam = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600, baseline_px=225.0)
    cfg = slam.GraphSLAMConfig(
        splitting=slam.SplittingConfig(maximum_translation_m=0.6),
        loop=LoopDetectorConfig(minimum_age_difference=3), arena_capacity=1024,
        max_local_maps=32, max_edges=64, database_capacity=16384,
        max_device_map_arenas=2)    # older arenas move to the host and reload
    frames = _walk_frames(rng, cam)
    runs = {}
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        s = slam.GraphSLAM(cam, cfg, device=device)
        rows = []
        for i, (p, d, ok) in enumerate(frames):
            s.process(*(torch.from_numpy(a).to(device) for a in (p, d, ok)), 0.1 * i)
            rows.append((s.status, s.current_map))
        runs[device] = (s, rows, launch_counts())
    (g, g_rows, g_launch), (c, c_rows, _) = runs["cuda"], runs["cpu"]
    assert g_launch == {"fast": 0, "brief": 0, "gn_burst": 3 * len(frames)}
    assert g_rows == c_rows
    keys = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses",
            "num_backstop_rejections")
    assert {k: getattr(g, k) for k in keys} == {k: getattr(c, k) for k in keys}
    assert g.closure_events == c.closure_events and g.num_relocalizations >= 1
    on_card = [a.pos.is_cuda for a in g._map_arenas.values()]
    assert sum(on_card) <= 2 and not all(on_card)
    d_t, d_ang = se3.error_t_and_angle(torch.from_numpy(np.stack(g.trajectory())),
                                       torch.from_numpy(np.stack(c.trajectory())))
    assert float(d_t.max()) <= 1e-3 and float(d_ang.max()) <= 1e-3


def _icl_frames():
    return list(datasets.iter_bundled_icl(DATA))[:2]


def test_fast_and_brief_kernels_at_icl_frame_0():
    from srrg2_proslam_tpu_torch.ops.features import (
        FeatureExtractorConfig, _keypoint_rows_cols, detect_keypoints_batch)

    img = torch.from_numpy(_icl_frames()[0].intensity)[None].cuda()
    assert img.shape == (1, 480, 640)
    cfg = FeatureExtractorConfig()
    got = fast.fast_scores_kernel(img, cfg.detector_threshold)
    ref = fast.fast_scores_plain(img, cfg.detector_threshold)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and int((ref > 0).sum()) > 1000
    uv, _, valid = detect_keypoints_batch(img, cfg)
    y, x = _keypoint_rows_cols(uv, 480, 640)
    smooth = _boxfilter(img, cfg.smoothing_window).contiguous()
    got = brief.brief_descriptors(smooth, y, x, valid)
    ref = brief.brief_descriptors_plain(smooth, y, x, valid)
    torch.cuda.synchronize()
    assert got.shape == (1, 1152, 256) and int(valid.sum()) > 300
    assert torch.equal(got, ref)


def _track(frames, device, model, cfg):
    from srrg2_proslam_tpu_torch.models import frontend, tracker

    state = tracker.initial_state(4096, cfg.landmark_estimator, device=device)
    out = []
    for a, b in frames:
        a, b = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        if model == "rgbd":
            cam = datasets.icl_camera()
            meas = frontend.adapt_rgbd(a, b, frontend.DepthAdaptorConfig())
        else:
            cam = datasets.kitti_camera(*a.shape)
            meas = frontend.adapt_stereo(a, b, frontend.StereoAdaptorConfig())
        state, stats, _ = tracker.track_step(state, meas.points, meas.desc, meas.valid, cam,
                                             cfg, model)
        out.append(([t.cpu() for t in meas], {k: int(getattr(stats, k)) for k in (
            "num_measurements", "num_matches", "num_inliers", "num_merges",
            "num_additions")}))
    return state.to("cpu"), out


def test_rgbd_track_step_on_the_card_matches_cpu():
    from srrg2_proslam_tpu_torch.models import tracker

    frames = [(f.intensity, f.depth) for f in _icl_frames()]
    reset_launch_counts()
    g_state, g_out = _track(frames, "cuda", "rgbd", tracker.TrackerConfig())
    assert launch_counts() == {"fast": 2, "brief": 2, "gn_burst": 0}
    c_state, c_out = _track(frames, "cpu", "rgbd", tracker.TrackerConfig())
    for (g_meas, g_counts), (c_meas, c_counts) in zip(g_out, c_out):
        assert all(torch.equal(a, b) for a, b in zip(g_meas, c_meas))
        assert g_counts == c_counts
    assert c_out[1][1]["num_inliers"] > 30
    assert float((g_state.T_lm_robot - c_state.T_lm_robot).abs().max()) <= 5e-4


def test_smoother_step_on_the_card_matches_cpu():
    from srrg2_proslam_tpu_torch.models import tracker

    frames = [(f.left, f.right) for f in datasets.iter_bundled_kitti(DATA, "city")][:2]
    cfg = tracker.TrackerConfig(landmark_estimator="smoother")
    reset_launch_counts()
    g_state, g_out = _track(frames, "cuda", "stereo", cfg)
    assert launch_counts() == {"fast": 2, "brief": 2, "gn_burst": 6}
    c_state, c_out = _track(frames, "cpu", "stereo", cfg)
    for (_, g_counts), (_, c_counts) in zip(g_out, c_out):
        assert g_counts == c_counts
    assert c_out[1][1]["num_merges"] > 50
    assert float((g_state.T_lm_robot - c_state.T_lm_robot).abs().max()) <= 5e-4
    assert torch.equal(g_state.arena.valid, c_state.arena.valid)
    assert float((g_state.arena.pos - c_state.arena.pos).abs().max()) <= 1e-3
    for a, b in zip(g_state.meas_buf, c_state.meas_buf):
        assert float((a.double() - b.double()).abs().max()) <= 1e-3


def _kitti_stack(n):
    frames = list(datasets.iter_bundled_kitti(DATA, "city"))
    images = [im for f in frames for im in (f.left, f.right)]
    return torch.from_numpy(np.stack([images[i % len(images)] for i in range(n)])).cuda()


def test_fast_and_brief_kernels_at_b32():
    """K3 and K1 at B = 32 (a chunk of 16 pairs through the batched adaptor):
    bit-exact against their plain versions, and every image's result equal
    to the kernel's at B = 1."""
    from srrg2_proslam_tpu_torch.ops.features import (
        FeatureExtractorConfig, _keypoint_rows_cols, detect_keypoints_batch)

    images = _kitti_stack(32)
    cfg = FeatureExtractorConfig()
    got = fast.fast_scores_kernel(images, cfg.detector_threshold)
    assert torch.equal(got, fast.fast_scores_plain(images, cfg.detector_threshold))
    for i in (0, 7, 31):
        assert torch.equal(got[i:i + 1], fast.fast_scores_kernel(images[i:i + 1].contiguous(),
                                                                 cfg.detector_threshold))
    uv, _, valid = detect_keypoints_batch(images, cfg)
    y, x = _keypoint_rows_cols(uv, *images.shape[1:])
    smooth = _boxfilter(images, cfg.smoothing_window).contiguous()
    got = brief.brief_descriptors(smooth, y, x, valid)
    assert got.shape == (32, 1152, 256) and int(valid.sum()) > 32 * 1000
    assert torch.equal(got, brief.brief_descriptors_plain(smooth, y, x, valid))
    for i in (0, 7, 31):
        one = brief.brief_descriptors(smooth[i:i + 1].contiguous(), y[i:i + 1].contiguous(),
                                      x[i:i + 1].contiguous(), valid[i:i + 1].contiguous())
        assert torch.equal(got[i:i + 1], one)


@pytest.mark.parametrize("name", ["kitti_adaptor", "euroc_adaptor", "aggressive_motion_adaptor"])
def test_batched_adaptor_on_the_card_equals_per_frame(name):
    """adapt_stereo_batch at B = 16 on the card equals 16 adapt_stereo calls
    on the card bit for bit (the Hamming GEMMs stay exact at any batch),
    with one FAST and one BRIEF launch (none for oriented descriptors)."""
    from srrg2_proslam_tpu_torch.models import frontend
    from srrg2_proslam_tpu_torch.utils import config

    cfg = config.load(os.path.join(DATA, "..", "configurations", f"{name}.json"))
    images = _kitti_stack(32)
    lefts, rights = images[0::2].contiguous(), images[1::2].contiguous()
    reset_launch_counts()
    batch = frontend.adapt_stereo_batch(lefts, rights, cfg)
    brief_launches = 0 if cfg.extractor.oriented else 1
    assert launch_counts() == {"fast": 1, "brief": brief_launches, "gn_burst": 0}
    for i in range(16):
        one = frontend.adapt_stereo(lefts[i], rights[i], cfg)
        for got, ref in zip(batch, one):
            assert torch.equal(got[i], ref), i


@pytest.mark.parametrize("name", ["euroc_adaptor", "aggressive_motion_adaptor"])
def test_adaptor_options_on_the_card_match_cpu(name):
    """The 5 KITTI pairs under the shipped oriented / sub-pixel adaptor
    configs, card vs CPU: keypoints, valid rows and uL/v bit-exact, u_R
    within UR_ATOL, oriented descriptor bits within ORIENTED_BITS per
    frame (upright: bit-exact)."""
    from srrg2_proslam_tpu_torch.models import frontend
    from srrg2_proslam_tpu_torch.ops.features import extract_features_batch
    from srrg2_proslam_tpu_torch.utils import config

    cfg = config.load(os.path.join(DATA, "..", "configurations", f"{name}.json"))
    for f in datasets.iter_bundled_kitti(DATA, "city"):
        cpu = [torch.from_numpy(f.left), torch.from_numpy(f.right)]
        g_feat = extract_features_batch(torch.stack(cpu).cuda(), cfg.extractor)
        c_feat = extract_features_batch(torch.stack(cpu), cfg.extractor)
        for key in ("uv", "response", "valid"):
            assert torch.equal(getattr(g_feat, key).cpu(), getattr(c_feat, key)), key
        g = [t.cpu() for t in frontend.adapt_stereo(cpu[0].cuda(), cpu[1].cuda(), cfg)]
        c = frontend.adapt_stereo(*cpu, cfg)
        assert torch.equal(g[2], c.valid)
        both = g[2] & c.valid
        d = (g[0][both] - c.points[both]).abs()
        assert float(d[:, [0, 1, 3]].max()) == 0.0 and float(d[:, 2].max()) <= UR_ATOL
        bits = int((g[1][both] != c.desc[both]).sum())
        assert bits <= (ORIENTED_BITS if cfg.extractor.oriented else 0), bits


def test_sequence_on_the_card_matches_cpu(rng):
    """The walk of test_graphslam_on_the_card_matches_cpu through
    process_meas_sequence (the chunk program, chunks of 4) on the card
    against the CPU's synchronous per-frame run."""
    from srrg2_proslam_tpu_torch.models import slam
    from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig
    from srrg2_proslam_tpu_torch.utils import graphs

    cam = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600, baseline_px=225.0)
    kw = dict(splitting=slam.SplittingConfig(maximum_translation_m=0.6),
              loop=LoopDetectorConfig(minimum_age_difference=3), arena_capacity=1024,
              max_local_maps=32, max_edges=64, database_capacity=16384)
    frames = _walk_frames(rng, cam)
    c = slam.GraphSLAM(cam, slam.GraphSLAMConfig(**kw), device="cpu")
    for i, (p, d, ok) in enumerate(frames):
        c.process(*(torch.from_numpy(a) for a in (p, d, ok)), 0.1 * i)
    g = slam.GraphSLAM(cam, slam.GraphSLAMConfig(speculation_depth=8, chunk_size=4, **kw),
                       device="cuda")
    graphs.clear()
    reset_launch_counts()
    g.process_meas_sequence(*(np.stack([f[k] for f in frames]) for k in range(3)),
                            [0.1 * i for i in range(len(frames))])
    warm = sum(key[2][0] for key in graphs.programs() if key[0] == "chunk")
    assert launch_counts()["gn_burst"] == 3 * (g.chunk_stats["tracker_steps"] + warm)
    assert g.chunk_stats["graph_replays"] > 0 and g.num_relocalizations >= 1
    assert [f.local_map_index for f in g.frames] == [f.local_map_index for f in c.frames]
    keys = ("num_maps", "num_edges", "num_closures", "num_relocalizations", "num_losses")
    assert {k: getattr(g, k) for k in keys} == {k: getattr(c, k) for k in keys}
    d_t, d_ang = se3.error_t_and_angle(torch.from_numpy(np.stack(g.trajectory())),
                                       torch.from_numpy(np.stack(c.trajectory())))
    assert float(d_t.max()) <= 1e-3 and float(d_ang.max()) <= 1e-3


def test_chunk_graph_equals_eager(rng):
    """The walk's first 8 frames as one chunk: the chunk graph's replay
    against ``chunk_frames`` run eagerly on the same inputs, and one replay
    counts the launches recorded at capture."""
    from srrg2_proslam_tpu_torch.models import chunk
    from srrg2_proslam_tpu_torch.models.tracker import TrackerConfig, initial_state
    from srrg2_proslam_tpu_torch.utils import graphs

    cam = Camera(fx=450.0, fy=450.0, cx=300.0, cy=200.0, rows=400, cols=600, baseline_px=225.0)
    frames = _walk_frames(rng, cam)[:8]
    dev = torch.device("cuda")
    pts, desc, valid = (torch.from_numpy(np.stack([f[k] for f in frames])).to(dev)
                        for k in range(3))
    args = (cam, TrackerConfig(), "stereo", 6, 0.6, 0.25)
    state = initial_state(1024, device=dev)
    fim = torch.zeros((), dtype=torch.int32, device=dev)
    graphs.clear()
    chunk.run_chunk(state, fim, pts, desc, valid, 0, 8, *args)      # capture + replay
    reset_launch_counts()
    g_state, g_fim, g = chunk.run_chunk(state, fim, pts, desc, valid, 0, 8, *args)
    assert launch_counts()["gn_burst"] == 3 * 8
    e_state, e_fim, e = chunk.chunk_frames(state, fim, pts, desc, valid, 0, 8, *args)
    assert len(graphs.programs()) == 1 and int(g_fim) == int(e_fim)
    exact = [chunk.PKT_INLIERS, chunk.PKT_MATCHES, chunk.PKT_FINISH, chunk.PKT_ACTIVE]
    assert torch.equal(g.packet[:, exact], e.packet[:, exact])
    assert torch.equal(g.arenas.valid, e.arenas.valid)
    assert float((g.T_lm_robot - e.T_lm_robot).abs().max()) <= 1e-4
    graphs.clear()
