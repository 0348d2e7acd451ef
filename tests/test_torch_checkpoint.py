"""The port's checkpoints: a session saved and loaded continues bit for bit
like the uninterrupted run, on the CPU, and within 1e-5 of the JAX
package's uninterrupted run.

Four streams of tests/test_torch_slam.py's synthetic world, each through
the port uninterrupted and through the port saved after ``SPLIT_AT``
frames, loaded into a fresh GraphSLAM and continued:
  * ``closure``: tests/test_checkpoint.py's scenario (splits every metre,
    loop closing on) on the out-and-back closure walk;
  * ``rgbd_smoother_ba``: that walk as RGB-D (u, v, depth) rows with the
    smoother estimator and split-time local BA (keyframes, measurement
    buffers);
  * ``speculation``: the walk at speculation depth 8, saved with frames
    in the queue (``save`` flushes them);
  * ``eviction``: the walk with a two-slot database ring
    (``database_capacity`` 1024 at 512 rows per map), saved after an
    eviction.
Bounds: per-frame local map, counters, closure events and every pose of
the continued run exactly equal to the uninterrupted port run; against
JAX's uninterrupted run the maps, counters and events equal and every pose
within 1e-5 (tests/test_torch_sequence.py's bound).  The saved arrays use
the JAX checkpoint's keys and shapes where the state has the same fields.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.io import checkpoint as jckpt  # noqa: E402
from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402

from srrg2_proslam_tpu_torch.io import checkpoint  # noqa: E402
from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from tests.test_torch_slam import CAM, COUNTERS, _config, _scenario  # noqa: E402

JAX_ATOL = 1e-5
SCENARIOS = ("closure", "eviction", "rgbd_smoother_ba", "speculation")
SPLIT_AT = {"closure": 8, "rgbd_smoother_ba": 8, "speculation": 8, "eviction": 17}


def _stream(name):
    """(frames, config kwargs, model) of a scenario."""
    frames, kw = _scenario("closure")
    model = "stereo"
    if name == "rgbd_smoother_ba":
        model = "rgbd"
        frames = [(np.stack([p[:, 0], p[:, 1],
                             CAM.baseline_px / np.maximum(p[:, 0] - p[:, 2], 1e-3)], 1),
                   d, ok, stamp) for p, d, ok, stamp in frames]
        kw = dict(kw, tracker=ts.TrackerConfig(landmark_estimator="smoother"),
                  local_ba=ts.LocalBAConfig(enabled=True, max_keyframes=4))
    elif name == "speculation":
        kw = dict(kw, speculation_depth=8)
    elif name == "eviction":
        kw = dict(kw, database_capacity=1024, max_db_descriptors_per_map=512)
    return frames, kw, model


def _jax_config(kw):
    kw = dict(kw)
    if "tracker" in kw:
        kw["tracker"] = js.TrackerConfig(landmark_estimator=kw["tracker"].landmark_estimator)
    if "local_ba" in kw:
        kw["local_ba"] = js.LocalBAConfig(enabled=True, max_keyframes=4)
    return _config(js, JLoopCfg, kw)


def _feed(slam, frames, to):
    for p, d, ok, stamp in frames:
        slam.process(to(p), to(d), to(ok), stamp)
    slam.flush()


def _summary(slam):
    return dict(maps=[f.local_map_index for f in slam.frames],
                counters={k: getattr(slam, k) for k in COUNTERS},
                events=[tuple(e) for e in slam.closure_events],
                trajectory=np.stack(slam.trajectory()), status=slam.status,
                keyframes=len(slam._ba_keyframes))


def checkpoint_runs(names, tmp_path_factory):
    """Each named stream: the port uninterrupted, saved at ``SPLIT_AT`` and
    resumed, and JAX uninterrupted."""
    out = {}
    for name in names:
        frames, kw, model = _stream(name)
        config = _config(ts, LoopDetectorConfig, kw)
        whole = ts.GraphSLAM(CAM, config, model=model, device="cpu")
        _feed(whole, frames, torch.from_numpy)
        first = ts.GraphSLAM(CAM, config, model=model, device="cpu")
        k = SPLIT_AT[name]
        for p, d, ok, stamp in frames[:k]:
            first.process(*map(torch.from_numpy, (p, d, ok)), stamp)
        queued = len(first._queue)
        path = str(tmp_path_factory.mktemp(name) / "ckpt.npz")
        checkpoint.save(first, path)
        resumed = checkpoint.load(ts.GraphSLAM(CAM, config, model=model, device="cpu"), path)
        loaded = _summary(resumed)
        _feed(resumed, frames[k:], torch.from_numpy)
        j = js.GraphSLAM(CAM, _jax_config(kw), model=model)
        _feed(j, frames, jnp.asarray)
        out[name] = dict(whole=_summary(whole), resumed=_summary(resumed),
                         saved=_summary(first), loaded=loaded, jax=_summary(j),
                         queued=queued, path=path, k=k, kw=kw)
    return out


def check_resumed(r, name):
    """The continued run equals the uninterrupted one; the loaded session
    the saved one."""
    for key in ("maps", "counters", "events", "status"):
        assert r["resumed"][key] == r["whole"][key], key
    np.testing.assert_array_equal(r["resumed"]["trajectory"], r["whole"]["trajectory"])
    # the restored session is the saved one
    for key in ("maps", "counters", "events", "status"):
        assert r["loaded"][key] == r["saved"][key], key
    np.testing.assert_array_equal(r["loaded"]["trajectory"], r["saved"]["trajectory"])
    c = r["whole"]["counters"]
    assert c["num_maps"] >= 3
    if name == "speculation":
        assert r["queued"] > 0             # saved with frames in the queue
    elif name == "eviction":
        assert r["saved"]["counters"]["num_db_evictions"] >= 1
        assert c["num_db_evictions"] > r["saved"]["counters"]["num_db_evictions"]
    elif name == "closure":
        assert c["num_closures"] >= 1
    elif name == "rgbd_smoother_ba":
        assert r["saved"]["keyframes"] > 0


def check_jax(r):
    for key in ("maps", "counters", "events"):
        assert r["resumed"][key] == r["jax"][key], key
    np.testing.assert_allclose(r["resumed"]["trajectory"], r["jax"]["trajectory"],
                               atol=JAX_ATOL)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return checkpoint_runs(SCENARIOS, tmp_path_factory)


@pytest.mark.parametrize("name", SCENARIOS)
def test_resumed_run_equals_uninterrupted(runs, name):
    check_resumed(runs[name], name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_resumed_run_agrees_with_jax(runs, name):
    check_jax(runs[name])


def test_keys_follow_the_jax_checkpoint(runs, tmp_path):
    """Where both sessions have a field, the arrays carry JAX's key and
    shape (JAX adds the host-side database entries ``dbent*``)."""
    r = runs["closure"]
    frames, kw, _ = _stream("closure")
    j = js.GraphSLAM(CAM, _jax_config(kw))
    for p, d, ok, stamp in frames[:r["k"]]:
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(j, jpath)
    port, ref = np.load(r["path"]), np.load(jpath)
    shared = [k for k in ref.files if not k.startswith("dbent") and k != "_meta_json"]
    assert shared and set(shared) <= set(port.files)
    for key in shared:
        assert port[key].shape == ref[key].shape, key


def test_load_restores_the_arena_store(runs, tmp_path):
    """The finalized arenas, their LRU order (one arena kept on the device)
    and the database ring's map ids come back as saved; a checkpoint of
    another model is refused."""
    r = runs["closure"]
    config = _config(ts, LoopDetectorConfig, dict(r["kw"], max_device_map_arenas=1))
    slam = ts.GraphSLAM(CAM, config, device="cpu")
    frames, _, _ = _stream("closure")
    for p, d, ok, stamp in frames[:r["k"]]:
        slam.process(*map(torch.from_numpy, (p, d, ok)), stamp)
    path = str(tmp_path / "lru.npz")
    checkpoint.save(slam, path)
    resumed = checkpoint.load(ts.GraphSLAM(CAM, config, device="cpu"), path)
    assert list(resumed._arena_lru) == list(slam._arena_lru)
    assert list(resumed._map_arenas) == list(slam._map_arenas)
    assert list(resumed._db_maps) == list(slam._db_maps)
    with pytest.raises(ValueError):
        checkpoint.load(ts.GraphSLAM(CAM, config, model="rgbd", device="cpu"), path)
