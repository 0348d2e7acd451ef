"""Multi-GPU execution of the SLAM stages over torch.distributed.

Port of srrg2_proslam_tpu/parallel/.  One process per rank, a 1-D mesh
named ``"d"`` (``spmd.Mesh``), explicit collectives where the JAX package
lets XLA insert them.  ``spmd`` holds the mesh, the placement helpers and
the sharded stages; ``multihost`` initialises a process group for ranks
started by the user; ``launch`` starts ranks on one host; ``checks`` holds
the rank programs that ``entry.dryrun_multichip``, the tests and
``chip_smoke.py`` run.  The JAX package's mesh-integrated orchestrator is
``models/slam.py::GraphSLAM(mesh=...)``.
"""
from .spmd import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_frame_inputs,
    slam_step_spmd,
    pgo_optimize_spmd,
    loop_query_spmd,
    ba_optimize_spmd,
)
from . import multihost  # noqa: F401
