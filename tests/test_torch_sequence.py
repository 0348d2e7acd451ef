"""The port's speculative pipeline and its chunk program == its per-frame
loop and the JAX package's, on the CPU.

Measurement streams of tests/test_torch_slam.py (a Lost frame; closures;
a relocalisation into a map whose arena was moved off the device; the
closure walk with a two-slot database ring, so that maps are evicted) and
a rendered RGB-D loop at 120x160 (the image path through
``adapt_rgbd_batch``) go through:

* the port's synchronous per-frame loop (``speculation_depth = 0``);
* the port's speculative per-frame pipeline at ``speculation_depth`` 8
  (``process`` per frame, then ``flush``);
* the port's ``process_meas_sequence`` / ``process_sequence`` with
  ``chunk_size`` 4 (chunks straddle the splits; the shipped
  ``speculation_depth`` 8, which the chunk program ignores): the chunk
  program (models/chunk.py);
* the JAX package's per-frame loop.

Bounds: the port's runs equal each other exactly (per-frame status
and local map, counters, closure events, every pose bit for bit); against
JAX the per-frame status and local map, the counters and closure events
are equal and every pose within 1e-5 (tests/test_speculation.py:83,
tests/test_chunked.py:83); on the RGB-D image path within 1e-4 (the
depth GN's float differences, pinned in tests/test_torch_rgbd.py, add up
to 2.7e-5 over the walk).  The shipped configurations run in
tests/test_torch_config.py, the chunk program's other streams and sizes
in tests/test_torch_chunk.py.
"""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import frontend as jfe, slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402

from srrg2_proslam_tpu_torch.io import synthetic as tsyn  # noqa: E402
from srrg2_proslam_tpu_torch.models import frontend, slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from tests.test_torch_slam import CAM, COUNTERS, _config, _scenario  # noqa: E402
from tests.torch_shared import digest, shared  # noqa: E402

JAX_ATOL = 1e-5
RGBD_JAX_ATOL = 1e-4
DEPTH = 8
CHUNK = 4


def _watch(slam):
    """Record the status after each consumed frame: the per-frame queue and
    the chunk program's host mirror both consume frames in order."""
    statuses = []
    # (the JAX package's GraphSLAM has no chunk mirror to watch)
    for name in ("_consume_frame", "_consume_chunk_frame"):
        consume = getattr(slam, name, None)
        if consume is None:
            continue

        def consume_and_record(*args, consume=consume):
            out = consume(*args)
            statuses.append(slam.status)
            return out

        setattr(slam, name, consume_and_record)
    return statuses


def _summary(slam, statuses):
    return dict(status=list(statuses), maps=[f.local_map_index for f in slam.frames],
                counters={k: getattr(slam, k) for k in COUNTERS},
                events=list(slam.closure_events),
                trajectory=np.stack(slam.trajectory()))


def _assert_exact(a, b):
    for key in ("status", "maps", "counters", "events"):
        assert a[key] == b[key], key
    np.testing.assert_array_equal(a["trajectory"], b["trajectory"])


def _assert_jax(port, ref, atol=JAX_ATOL):
    for key in ("status", "maps", "counters", "events"):
        assert port[key] == ref[key], key
    np.testing.assert_allclose(port["trajectory"], ref["trajectory"], atol=atol)


def _kw(name):
    if name == "eviction":
        frames, kw = _scenario("closure")
        return frames, dict(kw, database_capacity=1024, max_db_descriptors_per_map=512)
    return _scenario(name)


def _run_jax(cam, config, frames, model="stereo"):
    """The JAX package's per-frame run and ``flush``, shared by every file
    that runs the same frames and config (tests/torch_shared.py)."""
    key = digest("run_jax", repr(cam), repr(config), model, [list(f) for f in frames])
    return shared(key, lambda: _run_jax_once(cam, config, frames, model))


def _run_jax_once(cam, config, frames, model):
    j = js.GraphSLAM(cam, config, model=model)
    statuses = _watch(j)
    for p, d, ok, stamp in frames:
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
    j.flush()
    return _summary(j, statuses)


def _run_port(cam, config, frames, mode, model="stereo"):
    """The frames through the port: ``mode`` "sequence" through
    ``process_meas_sequence``, else ``process`` per frame and ``flush``."""
    t = ts.GraphSLAM(cam, config, model=model, device="cpu")
    statuses = _watch(t)
    if mode == "sequence":
        stacks = [np.stack([f[k] for f in frames]) for k in range(3)]
        t.process_meas_sequence(*stacks, [f[3] for f in frames])
    else:
        for p, d, ok, stamp in frames:
            t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        t.flush()
    return t, _summary(t, statuses)


def _run_port_sync(cam, config, frames):
    """The port's synchronous per-frame run: (the counters the tests read
    off its GraphSLAM, its summary), shared by every file that runs the
    same frames and config (tests/torch_shared.py)."""
    def run():
        slam, summary = _run_port(cam, config, frames, "sync")
        return types.SimpleNamespace(
            num_replayed_frames=slam.num_replayed_frames,
            num_reloc_rollbacks=slam.num_reloc_rollbacks, num_losses=slam.num_losses,
            _db_maps=list(slam._db_maps)), summary
    return shared(digest("run_port_sync", repr(cam), repr(config), [list(f) for f in frames]),
                  run)


def scenario_runs(names):
    """Each named stream through JAX (per frame) and the port: synchronous,
    speculative at depth 8, and ``process_meas_sequence`` in chunks of 4."""
    out = {}
    for name in names:
        frames, kw = _kw(name)
        res = {"jax": _run_jax(CAM, _config(js, JLoopCfg, kw), frames)}
        res["sync_slam"], res["sync"] = _run_port_sync(
            CAM, _config(ts, LoopDetectorConfig, kw), frames)
        for mode, extra in (("speculative", dict(speculation_depth=DEPTH)),
                            ("sequence", dict(chunk_size=CHUNK, speculation_depth=DEPTH))):
            slam, res[mode] = _run_port(CAM, _config(ts, LoopDetectorConfig, dict(kw, **extra)),
                                        frames, mode)
            res[mode + "_slam"] = slam
        out[name] = res
    return out


def check_sequence(r, name):
    """The speculative queue at depth 8 and the chunk program each equal
    the synchronous per-frame loop exactly; the queue's counters of
    re-dispatched frames, rollbacks and replays, and the chunk program's
    (the JAX package's meaning: a relocalisation whose chunk held later
    finishes counts once, as a device rollback or a chunk replay)."""
    _assert_exact(r["speculative"], r["sync"])
    _assert_exact(r["sequence"], r["sync"])
    spec, seq = r["speculative_slam"], r["sequence_slam"]
    assert seq.num_replayed_frames == 0          # no per-frame queue
    assert seq.num_reloc_rollbacks + seq.num_reloc_replays <= seq.num_relocalizations
    if name == "lost":
        assert r["sync"]["counters"]["num_losses"] == 1
    elif name == "relocalize":
        # the split before the relocalisation had frames queued behind it
        assert spec.num_relocalizations >= 1 and spec.num_reloc_rollbacks >= 1
        assert spec.num_reloc_replays >= spec.num_reloc_rollbacks
    elif name == "eviction":
        assert r["sync"]["counters"]["num_db_evictions"] >= 1
    assert spec.num_replayed_frames > 0          # splits rolled frames back
    assert r["sync_slam"].num_replayed_frames == 0
    assert r["sync_slam"].num_reloc_rollbacks == 0


def check_jax(r, name):
    _assert_jax(r["sequence"], r["jax"])
    _assert_jax(r["speculative"], r["jax"])
    _assert_jax(r["sync"], r["jax"])
    if name in ("closure", "relocalize"):
        assert r["jax"]["counters"]["num_closures"] >= 1


SCENARIOS = ("closure", "eviction", "lost", "relocalize")


@pytest.fixture(scope="module")
def runs():
    return scenario_runs(SCENARIOS)


@pytest.mark.parametrize("name", SCENARIOS)
def test_sequence_equals_synchronous_loop(runs, name):
    check_sequence(runs[name], name)


@pytest.mark.parametrize("name", SCENARIOS)
def test_sequence_agrees_with_jax_per_frame(runs, name):
    check_jax(runs[name], name)


def test_flush_is_idempotent(runs):
    for mode in ("speculative", "sequence"):
        slam = runs["closure"][mode + "_slam"]
        n, maps = len(slam.frames), slam.num_maps
        for _ in range(2):
            slam.flush()
        assert len(slam.frames) == n and slam.num_maps == maps and not slam._queue


def test_flush_is_idempotent_after_a_relocalisation(runs):
    slam = runs["relocalize"]["speculative_slam"]
    n, maps = len(slam.frames), slam.num_maps
    for _ in range(2):
        slam.flush()
    assert len(slam.frames) == n and slam.num_maps == maps and not slam._queue


def test_finalize_keeps_the_depth():
    frames, kw = _scenario("lost")
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, dict(kw, speculation_depth=3)),
                     device="cpu")
    for i, (p, d, ok, stamp) in enumerate(frames[:5]):
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        assert len(t.frames) == max(0, i + 1 - 3)
    t.flush()
    assert len(t.frames) == 5


def test_sequence_refusals():
    frames, kw = _scenario("lost")
    stacks = [np.stack([f[k] for f in frames]) for k in range(3)]
    stamps = [f[3] for f in frames]
    with pytest.raises(ValueError):        # chunk_size 0: no sequence API
        ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, kw),
                     device="cpu").process_meas_sequence(*stacks, stamps)
    with pytest.raises(ValueError):        # local BA is per-frame only, as in JAX
        ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, dict(
            kw, chunk_size=4, local_ba=ts.LocalBAConfig(enabled=True))),
            device="cpu").process_meas_sequence(*stacks, stamps)
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, dict(
        kw, chunk_size=4, speculation_depth=2)), device="cpu")
    p, d, ok, stamp = frames[0]
    t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
    with pytest.raises(RuntimeError):      # pending per-frame work
        t.process_meas_sequence(*stacks, stamps)


def test_missing_timestamps_are_padded():
    frames, kw = _scenario("lost")
    stacks = [np.stack([f[k] for f in frames[:6]]) for k in range(3)]
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, dict(kw, chunk_size=4)),
                     device="cpu")
    t.process_meas_sequence(*stacks, [0.5, 0.7])
    assert t.timestamps() == [0.5, 0.7, 2.0, 3.0, 4.0, 5.0]


RGBD_KW = dict(count=24, rows=120, cols=160, side_a=10.0, side_b=6.0, step_m=0.4,
               turn_frames=10, fx=112.5)


def test_rgbd_image_sequence():
    """The rendered loop's first 24 frames as RGB-D at 120x160 through
    ``process_sequence`` (the batched RGB-D adaptor), the port's per-frame
    ``adapt_rgbd -> process`` loop and the JAX package's."""
    cam = tsyn.synthetic_camera(120, 160, fx=112.5)
    frames = list(tsyn.iter_rendered_loop_rgbd(device="cpu", **RGBD_KW))
    kw = dict(splitting=dict(maximum_translation_m=1.1, maximum_rotation_rad=0.35),
              arena_capacity=1024, max_local_maps=32, max_edges=64, database_capacity=8192,
              max_db_descriptors_per_map=512, loop=dict(minimum_age_difference=3))
    acfg = frontend.DepthAdaptorConfig(extractor=frontend.FeatureExtractorConfig(
        max_keypoints=288))
    j_acfg = jfe.DepthAdaptorConfig(extractor=jfe.FeatureExtractorConfig(max_keypoints=288))
    meas = [frontend.adapt_rgbd(f.intensity, f.depth, acfg) for f in frames]
    rows = [(m.points.numpy(), m.desc.numpy(), m.valid.numpy(), f.timestamp)
            for m, f in zip(meas, frames)]
    _, sync = _run_port(cam, _config(ts, LoopDetectorConfig, kw), rows, "sync", "rgbd")
    seq = ts.GraphSLAM(cam, _config(ts, LoopDetectorConfig, dict(
        kw, chunk_size=CHUNK, speculation_depth=DEPTH)), model="rgbd", device="cpu")
    statuses = _watch(seq)
    seq.process_sequence(torch.stack([f.intensity for f in frames]),
                         torch.stack([f.depth for f in frames]),
                         [f.timestamp for f in frames], acfg)
    _assert_exact(_summary(seq, statuses), sync)
    assert seq.num_maps >= 3
    jrows = []
    for f in frames:
        jm = jfe.adapt_rgbd(jnp.asarray(f.intensity.numpy()), jnp.asarray(f.depth.numpy()),
                            j_acfg)
        jrows.append((np.asarray(jm.points), np.asarray(jm.desc), np.asarray(jm.valid),
                      f.timestamp))
    for a, b in zip(rows, jrows):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
    ref = _run_jax(tsyn.synthetic_camera(120, 160, fx=112.5), _config(js, JLoopCfg, kw),
                   jrows, "rgbd")
    # the depth GN's float differences pinned in tests/test_torch_rgbd.py
    # add up over the walk: 2.7e-5 at most here
    _assert_jax(sync, ref, RGBD_JAX_ATOL)


@pytest.mark.slow
def test_meas_sequence_agrees_with_jax_process_sequence():
    """One direct comparison with the JAX package's chunked mode
    (models/chunk.py, minutes to compile on the CPU): the relocalisation
    stream through both packages' ``process_meas_sequence`` in chunks of 4.
    The JAX run is not watched frame by frame, so per-frame local maps,
    counters (with the relocalisation rollbacks and replays), closure
    events and poses (within 1e-5) are compared."""
    frames, kw = _kw("relocalize")
    stacks = [np.stack([f[k] for f in frames]) for k in range(3)]
    stamps = [f[3] for f in frames]
    j = js.GraphSLAM(CAM, _config(js, JLoopCfg, dict(kw, chunk_size=CHUNK)))
    j.process_meas_sequence(*(jnp.asarray(x) for x in stacks), stamps)
    t, port = _run_port(CAM, _config(ts, LoopDetectorConfig, dict(
        kw, chunk_size=CHUNK, speculation_depth=DEPTH)), frames, "sequence")
    ref = _summary(j, [])
    assert ref["counters"]["num_relocalizations"] >= 1
    for key in ("maps", "counters", "events"):
        assert port[key] == ref[key], key
    for key in ("num_reloc_rollbacks", "num_reloc_replays"):
        assert getattr(t, key) == getattr(j, key), key
    np.testing.assert_allclose(port["trajectory"], ref["trajectory"], atol=JAX_ATOL)
