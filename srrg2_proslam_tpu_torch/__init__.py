"""srrg2_proslam_tpu_torch — the PyTorch + CUDA port of srrg2_proslam_tpu.

The JAX package ``srrg2_proslam_tpu`` is the reference; this package mirrors
its layout module for module, so each function has a counterpart of the
same name:

ops/       SE3, pinhole, triangulation, Hamming, matching, features,
           Gauss-Newton, EKF — plain functions on tensors.
models/    stereo adaptor, landmark arena, frame-to-map tracker.
io/        bundled KITTI reader with a zlib/numpy PNG decoder.
kernels/   Python wrappers of the hand-written CUDA kernels (FAST, BRIEF
           bitplanes, GN burst), each beside its plain PyTorch version.
csrc/      the CUDA C++ sources, built for sm_90a at first use.

Imports torch and numpy only, never jax.  The port covers the stereo VO
slice (``adapt_stereo`` -> ``track_step`` with the EKF estimator).
"""

import torch as _torch

__version__ = "0.1.0"

# SLAM geometry needs true float32 products (the JAX package pins
# jax_default_matmul_precision="highest" for the same reason); the ±1
# descriptor products are exact only while TF32 is off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
