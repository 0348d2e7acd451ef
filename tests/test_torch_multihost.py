"""Two OS processes form one process group through the port's
``parallel/multihost.py``, the port of tests/test_multihost.py.

Each process (parallel/launch.py::spawn; parallel/checks.py::multihost_rank)
calls ``multihost.initialize`` with a FileStore in tmp_path (no TCP port
to collide under xdist), builds ``global_mesh`` and checks
``is_coordinator``; a SUM of 1 + rank crosses the process boundary; then a
real stage runs across the processes: the loop-closure ring query with its
budget axis striped over the two ranks, which must equal the
single-process query on the same inputs bit for bit (candidates, votes,
keys, rows, masks and points).  The full GraphSLAM across processes is in
tests/test_torch_mesh_slam.py.
"""
import numpy as np

from srrg2_proslam_tpu_torch.parallel import launch
from srrg2_proslam_tpu_torch.parallel.checks import multihost_rank


def test_two_process_group_and_striped_query(tmp_path):
    reports = launch.spawn(multihost_rank, 2, f"file://{tmp_path / 'store'}", timeout_s=300)
    for rank, r in enumerate(reports):
        assert (r["rank"], r["size"], r["backend"]) == (rank, 2, "gloo")
        assert r["coordinator"] == (rank == 0)
        assert r["total"] == 1.0 + 2.0
        assert r["single"]["candidate_maps"][0] == 0 and r["single"]["votes"][0] >= 10
        for key, ref in r["single"].items():
            np.testing.assert_array_equal(r["sharded"][key], ref, err_msg=key)
