"""srrg2_proslam_tpu_torch — the PyTorch + CUDA port of srrg2_proslam_tpu.

The JAX package ``srrg2_proslam_tpu`` is the reference; this package mirrors
its layout module for module, so each function has a counterpart of the
same name:

ops/       SE3, pinhole, triangulation, Hamming, matching, features
           (upright and oriented BRIEF), sub-pixel disparity refinement,
           Gauss-Newton, EKF, weighted-mean and smoother landmark
           estimators, pose-graph optimization, bundle adjustment — plain
           functions on tensors.
models/    stereo and RGB-D adaptors, landmark arena, frame-to-map tracker,
           loop closure database and validation, the GraphSLAM
           orchestrator (with split-time local BA) and its chunk program.
io/        dataset readers and writers (bundled KITTI and ICL, KITTI
           odometry, TUM, EuRoC with rectification, Malaga; trajectories,
           PFM, PNG/PGM), the native C++ decoder and prefetcher (built
           with g++ at first use), BOSS message logs, GraphSLAM
           checkpoints, quaternions; the rendered room and trajectories
           (stereo or RGB-D).
metrics/   ATE / RPE trajectory evaluation (numpy).
utils/     profile_time scoped host timers and device_trace; the config
           registry and its JSON round trip (loads
           ``configurations/*.json``); CUDA graphs captured once and
           replayed (``graphs.py``).
apps/      app_benchmark, convert_dataset, compute_sparse_stereo_gt, the
           didactic example_* apps and export_viewer
           (``python -m srrg2_proslam_tpu_torch.apps.<name>``).
parallel/  the multi-GPU slice over torch.distributed: the 1-D mesh and
           its collectives, the sharded stages (tracker step, striped
           loop query, PGO, BA), process-group setup and a launcher of
           ranks on one host.
entry.py   ``entry()``: one stereo tracker step on the card;
           ``dryrun_multichip(n)``: the sharded stages over n ranks.
viz.py     the live viewer (snapshot, LiveViewer).
kernels/   Python wrappers of the hand-written CUDA kernels (FAST, BRIEF
           bitplanes, GN burst), each beside its plain PyTorch version.
csrc/      the CUDA C++ sources, built for sm_90a at first use.

Imports torch and numpy only, never jax.  The port covers stereo and
RGB-D VO (``adapt_stereo`` / ``adapt_rgbd`` and their batched forms ->
``track_step``, with the EKF, weighted-mean or smoother landmark estimator
and the optional motion prior) and GraphSLAM on it (->
``GraphSLAM.process``, speculative or synchronous, with optional local BA,
or ``GraphSLAM.process_sequence`` over whole image stacks through the
chunk program, ``models/chunk.py``, CUDA graphs on the card), on one
device or on every rank of a device mesh (``GraphSLAM(mesh=...)``,
``parallel/``); every shipped
configuration loads through ``utils.config.load``; the apps start it as
the JAX package's apps start that one.
"""

import torch as _torch

__version__ = "0.1.0"

# SLAM geometry needs true float32 products (the JAX package pins
# jax_default_matmul_precision="highest" for the same reason); the ±1
# descriptor products are exact only while TF32 is off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
