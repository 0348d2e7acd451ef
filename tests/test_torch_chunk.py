"""The port's chunk program (models/chunk.py) == its synchronous per-frame
loop, and agrees with the JAX package's per-frame loop, on the CPU.

The measurement streams of tests/test_torch_slam.py and
tests/test_torch_sequence.py go through ``process_meas_sequence``, the
counterparts of tests/test_chunked.py's runs of the JAX chunk program:

* ``lost`` (splits and a Lost frame) in chunks of 4, 5 and 16 (aligned,
  straddling, one chunk for the whole stream);
* ``closure`` (closures, a relocalisation) in chunks of 4 and 8;
* ``closure`` in chunks of 4 at ``chunk_group`` 2 (two chunks per
  dispatch and packet read), equal to the ungrouped run;
* ``eviction`` (a two-slot database ring) in chunks of 4;
* the relocalisation streams (``relocalize``, ``rollback``) in
  tests/test_torch_chunk_reloc.py (a file of its own, so that the two run
  side by side).

Bounds: against the port's synchronous loop the per-frame status and local
map, the counters, the closure events and every pose are equal, bit for
bit (on the CPU the chunk program runs its eager body, the plain version
of its CUDA graphs); against the JAX package's per-frame loop the same,
with every pose within 1e-5 (tests/test_chunked.py:83).  Unit cases: the
packet layout against the JAX package's, a frame's packet row against its
tracker step, ``undo_graph_entries`` against a graph that never had the
undone entries, ``db_write_slot`` restoring an evicted and a free slot.
The chunk graph against its eager body on a card is in
tests/test_torch_kernels_cuda.py (this file imports JAX, which a machine
that only runs the port need not have).
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import chunk as jchunk, slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402

from srrg2_proslam_tpu_torch.models import chunk, loop_closure, slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.models.tracker import initial_state, track_step  # noqa: E402
from srrg2_proslam_tpu_torch.ops import pgo  # noqa: E402
from tests.test_torch_sequence import (_assert_exact, _assert_jax, _kw, _run_jax,  # noqa: E402
                                       _run_port, _run_port_sync)
from tests.test_torch_slam import CAM, _config  # noqa: E402

# (stream, chunk_size, chunk_group)
CASES = [("lost", 4, 1), ("lost", 5, 1), ("lost", 16, 1),
         ("closure", 4, 1), ("closure", 8, 1), ("closure", 4, 2), ("eviction", 4, 1)]


def ids(cases):
    return [f"{n}-{c}" + (f"x{g}" if g > 1 else "") for n, c, g in cases]


def _stream(name):
    if name != "rollback":
        return _kw(name)
    frames, kw = _kw("relocalize")
    for j in (16, 17):
        p, d, ok, stamp = frames[j]
        frames[j] = (p, d, np.zeros_like(ok), stamp)
    return frames, kw


@lru_cache(maxsize=None)
def _references(name):
    """(JAX per-frame summary, the port's synchronous (counters, summary))."""
    frames, kw = _stream(name)
    jax_ref = _run_jax(CAM, _config(js, JLoopCfg, kw), frames)
    return jax_ref, _run_port_sync(CAM, _config(ts, LoopDetectorConfig, kw), frames)


@lru_cache(maxsize=None)
def _chunked(name, size, group):
    frames, kw = _stream(name)
    return _run_port(CAM, _config(ts, LoopDetectorConfig, dict(
        kw, chunk_size=size, chunk_group=group)), frames, "sequence")


def check_exact(name, size, group):
    """The chunked run equals the synchronous one exactly; its counters."""
    _, (sync_slam, sync) = _references(name)
    slam, got = _chunked(name, size, group)
    _assert_exact(got, sync)
    assert slam.num_replayed_frames == 0 and not slam._cqueue
    # a relocalisation counts once, as a device rollback or a chunk replay
    assert slam.num_reloc_rollbacks + slam.num_reloc_replays <= slam.num_relocalizations
    if name == "lost":
        assert sync["counters"]["num_losses"] == 1 and sync["counters"]["num_maps"] >= 3
    elif name in ("closure", "relocalize", "rollback"):
        assert sync["counters"]["num_relocalizations"] >= 1
    elif name == "eviction":
        assert sync["counters"]["num_db_evictions"] >= 1
        assert list(slam._db_maps) == list(sync_slam._db_maps)


def check_jax(name, size, group):
    jax_ref, _ = _references(name)
    _assert_jax(_chunked(name, size, group)[1], jax_ref)


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_equals_synchronous_loop(name, size, group):
    check_exact(name, size, group)


@pytest.mark.parametrize("name,size,group", CASES, ids=ids(CASES))
def test_chunk_program_agrees_with_jax_per_frame(name, size, group):
    check_jax(name, size, group)


def test_chunk_group_equals_ungrouped():
    _assert_exact(_chunked("closure", 4, 2)[1], _chunked("closure", 4, 1)[1])


def test_packet_layout_matches_jax():
    names = [n for n in dir(jchunk) if n.startswith(("PKT_", "FINISH_", "SM_"))]
    names.append("PACKET_SIZE")
    assert len(names) > 20
    for n in names:
        assert getattr(chunk, n) == getattr(jchunk, n), n
    for k in (1, 4, 8):
        assert chunk.split_meta_size(k) == jchunk.split_meta_size(k)


def test_frame_body_packet_row():
    """A frame's packet row: the tracker step's packet, the finish code, the
    active flag, the pose and the velocity; a Lost frame resets the state
    with zero velocity and restarts the map's frame count."""
    frames, kw = _kw("lost")
    tcfg = ts.TrackerConfig()
    state = initial_state(1024, device="cpu")
    fim = torch.zeros((), dtype=torch.int32)
    for j in (0, 1, 6):       # initializing, tracking, nothing measured
        p, d, ok, _ = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                       for x in frames[j])
        ref_state, stats, _ = track_step(state, p, d, ok, CAM, tcfg, "stereo")
        nxt, nfim, row, arena, T = chunk.frame_body(
            state, fim, p, d, ok, CAM, tcfg, "stereo", 6, 10.0, 0.25)
        assert row.shape == (chunk.PACKET_SIZE,)
        assert torch.equal(row[:8], stats.host_packet[:8])
        assert torch.equal(row[chunk.PKT_T:chunk.PKT_T + 12], stats.host_packet[8:20])
        assert torch.equal(row[chunk.PKT_VEL:], ref_state.velocity)
        assert float(row[chunk.PKT_ACTIVE]) == 1.0
        assert torch.equal(T, ref_state.T_lm_robot)
        assert torch.equal(arena.pos, ref_state.arena.pos)
        lost = j == 6
        assert float(row[chunk.PKT_FINISH]) == (chunk.FINISH_LOST if lost else chunk.FINISH_NONE)
        if lost:
            assert int(nfim) == 0 and not bool(nxt.arena.valid.any())
            assert not bool(nxt.velocity.any())
        else:
            assert int(nfim) == int(fim) + 1 and torch.equal(nxt.T_lm_robot, T)
        state, fim = nxt, nfim


def _graph_with(n):
    """A graph of ``n`` poses chained by ``n - 1`` odometry edges."""
    g = pgo.empty_graph(8, 8, "cpu")
    for i in range(n):
        T = torch.eye(4)
        T[0, 3] = float(i)
        g = pgo.add_pose(g, i, T)
        if i:
            g = pgo.add_edge(g, i - 1, i - 1, i, torch.eye(4))
    return g


def test_undo_graph_entries_against_fresh_graph():
    fresh, later = _graph_with(4), _graph_with(6)
    undone = chunk.undo_graph_entries(later, [4, 5], [3, 4])
    for name in ("pose_valid", "edge_valid"):
        assert torch.equal(getattr(undone, name), getattr(fresh, name)), name
    for name in ("poses", "edge_i", "edge_j", "edge_Z"):     # values stay stale
        assert torch.equal(getattr(undone, name), getattr(later, name)), name


def test_db_write_slot_restores_evicted_and_free_slots():
    rng = np.random.RandomState(1)
    db = loop_closure.empty_database(64, 16, "cpu")              # 4 slots of 16

    def rows(n):
        desc = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (24, 256)))
        pos = torch.from_numpy(rng.randn(24, 3).astype(np.float32))
        valid = torch.arange(24) < n
        return loop_closure.select_db_rows(
            desc, pos, valid, torch.from_numpy(rng.randint(0, 9, 24).astype(np.int32)), 16)

    stored = []
    for mid in range(4):
        desc_b, pos_b, rows_b, valid_b, n_b = rows(10 + mid)
        db = loop_closure.add_local_map(db, desc_b, pos_b, valid_b, mid, rows_b)
        stored.append((desc_b, pos_b, rows_b, int(n_b)))
    before = db
    desc_b, pos_b, rows_b, valid_b, _ = rows(12)
    db = loop_closure.add_local_map(db, desc_b, pos_b, valid_b, 7, rows_b)   # evicts map 0
    assert int(db.map_id[0]) == 7

    def restore(db, mid, slot, next_val):
        desc = torch.full((16, 256), -1, dtype=torch.int8)
        points, rws, valid = torch.zeros((16, 3)), torch.zeros(16, dtype=torch.int32), \
            torch.zeros(16, dtype=torch.bool)
        if mid >= 0:
            m_desc, m_pos, m_rows, n = stored[mid]
            desc[:n], points[:n], rws[:n], valid[:n] = m_desc[:n], m_pos[:n], m_rows[:n], True
        return chunk.db_write_slot(db, slot, desc, points, rws, valid, mid, next_val)

    back = restore(db, 0, 0, 4)
    for name in loop_closure.DescriptorDatabase._fields:
        assert torch.equal(getattr(back, name), getattr(before, name)), name
    freed = restore(loop_closure.add_local_map(loop_closure.empty_database(64, 16, "cpu"),
                                               desc_b, pos_b, valid_b, 7, rows_b), -1, 0, 0)
    for name in loop_closure.DescriptorDatabase._fields:
        assert torch.equal(getattr(freed, name),
                           getattr(loop_closure.empty_database(64, 16, "cpu"), name)), name
