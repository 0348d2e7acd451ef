"""The port's stereo VO slice == the JAX package on the 5 bundled KITTI frames.

Full-size frames (376x1241, 1152 keypoints per image, a 4096-landmark
arena, 3 rounds x 5 GN iterations, default configs) go through
``adapt_stereo -> track_step`` in both packages on the CPU.

Bounds: the adaptor's points/desc/valid are bit-exact on every pair;
frame 0 is exact; frames 1-4 keep match, inlier, merge and addition counts
within 2; the final pose is within 1 cm and 1e-3 rad of JAX's, and the
reference's (0.2, 0.2, 0.7) m / 0.01 rad gate passes.  Observed on the CPU:
every count equal and the final poses within 1e-6 m.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from srrg2_proslam_tpu.io import datasets as jds  # noqa: E402
from srrg2_proslam_tpu.models import frontend as jfe, tracker as jtr  # noqa: E402
from srrg2_proslam_tpu.ops import se3 as jse3  # noqa: E402

from srrg2_proslam_tpu_torch.io import datasets  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, landmarks, tracker  # noqa: E402
from srrg2_proslam_tpu_torch.ops import se3  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "test_data")
CAPACITY = 4096
COUNT_KEYS = ("num_measurements", "num_matches", "num_inliers", "num_merges",
              "num_additions")
GATE_T = np.array([0.2, 0.2, 0.7])
GATE_ANGLE = 0.01


def _counts(stats):
    return {k: int(getattr(stats, k)) for k in COUNT_KEYS}


def _jax_state_numpy(state):
    a = state.arena
    return {"pos": np.array(a.pos), "cov": np.array(a.cov), "desc": np.array(a.desc),
            "num_updates": np.array(a.num_updates), "valid": np.array(a.valid),
            "T_lm_robot": np.array(state.T_lm_robot), "velocity": np.array(state.velocity)}


@pytest.fixture(scope="module")
def frames():
    return list(datasets.iter_bundled_kitti(DATA, "city"))


@pytest.fixture(scope="module")
def jax_run(frames):
    """JAX package over the 5 frames: measurements, stats, states (numpy)."""
    cam = jds.kitti_camera(*frames[0].left.shape)
    state = jtr.initial_state(capacity=CAPACITY)
    out = {"meas": [], "counts": [], "states": [], "poses": [], "X": []}
    for fr in frames:
        meas = jfe.adapt_stereo(jnp.asarray(fr.left), jnp.asarray(fr.right),
                                jfe.StereoAdaptorConfig())
        state, stats, X = jtr.track_step(state, meas.points, meas.desc, meas.valid, cam,
                                         jtr.TrackerConfig(), "stereo")
        jax.block_until_ready(state)
        out["meas"].append(tuple(np.array(t) for t in meas))
        out["counts"].append(_counts(stats))
        out["states"].append(_jax_state_numpy(state))
        out["poses"].append(np.array(state.T_lm_robot))
        out["X"].append(np.array(X))
    return out


@pytest.fixture(scope="module")
def port_run(frames):
    cam = datasets.kitti_camera(*frames[0].left.shape)
    state = tracker.initial_state(capacity=CAPACITY, device="cpu")
    out = {"meas": [], "counts": [], "poses": []}
    for fr in frames:
        meas = frontend.adapt_stereo(torch.from_numpy(fr.left), torch.from_numpy(fr.right),
                                     frontend.StereoAdaptorConfig())
        state, stats, _ = tracker.track_step(state, meas.points, meas.desc, meas.valid, cam,
                                             tracker.TrackerConfig(), "stereo")
        out["meas"].append(tuple(t.numpy() for t in meas))
        out["counts"].append(_counts(stats))
        out["poses"].append(state.T_lm_robot.numpy())
    return out


@pytest.mark.parametrize("i", range(5))
def test_adapt_stereo_bit_exact(jax_run, port_run, i):
    for name, got, ref in zip(("points", "desc", "valid"), port_run["meas"][i],
                              jax_run["meas"][i]):
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=f"frame {i} {name}")
    assert port_run["meas"][i][2].sum() > 400


@pytest.mark.parametrize("i", range(5))
def test_slice_counts_per_frame(jax_run, port_run, i):
    got, ref = port_run["counts"][i], jax_run["counts"][i]
    if i == 0:
        assert got == ref
        np.testing.assert_array_equal(port_run["poses"][0], jax_run["poses"][0])
    for k in COUNT_KEYS:
        assert abs(got[k] - ref[k]) <= 2, (i, k, got, ref)
    if i > 0:
        assert got["num_inliers"] > 50


def test_slice_final_pose_and_gate(frames, jax_run, port_run):
    final_t = torch.from_numpy(port_run["poses"][-1])
    d_t, d_ang = se3.error_t_and_angle(final_t, torch.from_numpy(jax_run["poses"][-1]))
    assert float(d_t.max()) <= 1e-2 and float(d_ang) <= 1e-3
    gt = frames[-1].gt_pose
    t_err, angle = se3.error_t_and_angle(final_t, torch.from_numpy(gt))
    assert np.all(t_err.numpy() <= GATE_T) and float(angle) <= GATE_ANGLE
    j_err, j_angle = jse3.error_t_and_angle(jnp.asarray(jax_run["poses"][-1]), jnp.asarray(gt))
    np.testing.assert_allclose(t_err.numpy(), np.asarray(j_err), atol=1e-2)


# the tracker options a dataset config can set: inverse-depth weighting, a
# sensor-in-robot extrinsic (yaw 0.01 rad, 10 cm), no binning, no GN kernel
_T_RS = np.array(jse3.exp(jnp.asarray(np.array([0.1, 0.0, 0.05, 0.0, 0.01, 0.0],
                                                np.float32))))
OPTIONS = dict(stereo_inverse_depth_weighting=True, gn_pallas=False,
               T_robot_sensor=tuple(float(v) for v in _T_RS.reshape(-1)))


@pytest.mark.parametrize("k,options", [(1, False), (2, False), (3, False), (2, True)])
def test_carried_state_step(frames, jax_run, k, options):
    """Step both packages once from JAX's state after frame k."""
    d = jax_run["states"][k]
    state = tracker.state_from_numpy(d, "cpu")
    back = tracker.state_to_numpy(state)
    for key, val in d.items():
        np.testing.assert_array_equal(back[key], val, err_msg=key)
        assert back[key].dtype == val.dtype, key
    points, desc, valid = jax_run["meas"][k + 1]
    cam = datasets.kitti_camera(*frames[0].left.shape)
    kw = OPTIONS if options else {}
    new_state, stats, X = tracker.track_step(
        state, torch.from_numpy(points), torch.from_numpy(desc), torch.from_numpy(valid),
        cam, tracker.TrackerConfig(merger=tracker.MergerConfig(enable_binning=not options),
                                   **kw), "stereo")
    if options:
        j_cfg = jtr.TrackerConfig(merger=jtr.MergerConfig(enable_binning=False), **kw)
        j_state = jtr.TrackerState(
            arena=jtr.lm.LandmarkArena(*(jnp.asarray(d[n]) for n in
                                         ("pos", "cov", "desc", "num_updates", "valid"))),
            T_lm_robot=jnp.asarray(d["T_lm_robot"]), velocity=jnp.asarray(d["velocity"]))
        j_new, j_stats, j_X = jtr.track_step(
            j_state, *map(jnp.asarray, (points, desc, valid)),
            jds.kitti_camera(*frames[0].left.shape), j_cfg, "stereo")
        ref_counts, ref_X = _counts(j_stats), np.asarray(j_X)
        ref_pose, ref_count = np.asarray(j_new.T_lm_robot), int(j_new.arena.count)
    else:
        ref_counts, ref_X = jax_run["counts"][k + 1], jax_run["X"][k + 1]
        ref_pose = jax_run["poses"][k + 1]
        ref_count = int(jax_run["states"][k + 1]["valid"].sum())
    got = _counts(stats)
    for key in COUNT_KEYS:
        assert abs(got[key] - ref_counts[key]) <= 1, (key, got, ref_counts)
    assert got["num_inliers"] > 50
    np.testing.assert_allclose(X.numpy(), ref_X, atol=5e-4)
    np.testing.assert_allclose(new_state.T_lm_robot.numpy(), ref_pose, atol=5e-4)
    assert abs(int(new_state.arena.count) - ref_count) <= 1


def test_unsupported_options_raise():
    cam = datasets.kitti_camera()
    state = tracker.initial_state(8, "cpu")
    pts, desc, valid = torch.zeros(4, 4), torch.zeros(4, 256, dtype=torch.int8), torch.zeros(4, dtype=torch.bool)
    for cfg, model in [(tracker.TrackerConfig(), "rgbd"),
                       (tracker.TrackerConfig(landmark_estimator="smoother"), "stereo"),
                       (tracker.TrackerConfig(motion_prior_translation_info=1.0), "stereo")]:
        with pytest.raises(NotImplementedError):
            tracker.track_step(state, pts, desc, valid, cam, cfg, model)
    with pytest.raises(NotImplementedError):
        frontend.adapt_stereo(torch.zeros(40, 60), torch.zeros(40, 60),
                              frontend.StereoAdaptorConfig(subpixel_refinement=True))


def test_entry_points_default_to_the_card():
    """With no device given the state lives on the card; without one it raises."""
    d = tracker.state_to_numpy(tracker.initial_state(8, "cpu"))

    def leaves(x):
        return [t for v in x for t in (leaves(v) if isinstance(v, tuple) else [v])]

    for make in (lambda: tracker.initial_state(8), lambda: landmarks.empty_arena(8),
                 lambda: tracker.state_from_numpy(d)):
        if torch.cuda.is_available():
            assert all(t.is_cuda for t in leaves(make()))
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
