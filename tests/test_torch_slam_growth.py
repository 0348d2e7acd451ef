"""Pose-graph growth and ring eviction of the port's GraphSLAM == the JAX
package's, per frame on the CPU, over tests/test_torch_slam.py's
measurement streams (its other GraphSLAM cases are there; this file keeps
each under a minute alone).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from srrg2_proslam_tpu.models import slam as js  # noqa: E402
from srrg2_proslam_tpu.models.loop_closure import LoopDetectorConfig as JLoopCfg  # noqa: E402

from srrg2_proslam_tpu_torch.models import slam as ts  # noqa: E402
from srrg2_proslam_tpu_torch.models.loop_closure import LoopDetectorConfig  # noqa: E402
from srrg2_proslam_tpu_torch.ops import se3 as tse3  # noqa: E402
from tests.test_torch_slam import CAM, COUNTERS, POSE_TOL, _config, _scenario  # noqa: E402


GROWTH_CASES = {"growth": ("relocalize", dict(max_local_maps=2, max_edges=2)),
                "eviction": ("closure", dict(database_capacity=1024,
                                             max_db_descriptors_per_map=512))}


@pytest.mark.parametrize("case", GROWTH_CASES)
def test_growth_and_eviction_match_jax(case):
    """Pose-graph growth (the relocalise walk from 2 poses and 2 edges: 11
    maps, 12 closures) and ring eviction (the closure walk with two ring
    slots: 2 evictions) per frame in both packages: per-frame status and
    map, counters and closure events equal, the trajectory within
    POSE_TOL, the grown capacities equal."""
    name, extra = GROWTH_CASES[case]
    frames, kw = _scenario(name)
    kw = dict(kw, **extra)
    j = js.GraphSLAM(CAM, _config(js, JLoopCfg, kw))
    t = ts.GraphSLAM(CAM, _config(ts, LoopDetectorConfig, kw), device="cpu")
    j_rows, t_rows = [], []
    for p, d, ok, stamp in frames:
        j.process(jnp.asarray(p), jnp.asarray(d), jnp.asarray(ok), stamp)
        j_rows.append((j.status, j.current_map))
        t.process(torch.from_numpy(p), torch.from_numpy(d), torch.from_numpy(ok), stamp)
        t_rows.append((t.status, t.current_map))
    assert t_rows == j_rows
    assert {k: getattr(t, k) for k in COUNTERS} == {k: getattr(j, k) for k in COUNTERS}
    assert t.closure_events == j.closure_events
    assert (t.graph.capacity, t.graph.edge_capacity) == (j.graph.capacity, j.graph.edge_capacity)
    if case == "growth":
        assert t.num_maps > 2 and t.graph.edge_capacity > 2 and t.num_relocalizations >= 1
    else:
        assert t.num_db_evictions >= 1
    d_t, d_ang = tse3.error_t_and_angle(
        torch.from_numpy(np.stack(t.trajectory())),
        torch.from_numpy(np.stack(j.trajectory()).astype(np.float32)))
    print(f"{case}: largest |dt| {float(d_t.max()):.3e} m, angle {float(d_ang.max()):.3e} rad")
    assert float(d_t.max()) <= POSE_TOL and float(d_ang.max()) <= POSE_TOL
