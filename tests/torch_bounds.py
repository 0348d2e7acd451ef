"""Bounds pinned for the port's oriented and sub-pixel adaptor, in one
place for every comparison that uses them: the port against the JAX
package on the CPU (tests/test_torch_frontend_options.py,
tests/test_torch_slice.py), the card against the CPU
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 7).

Imports neither jax nor torch, so a machine that runs only the port can
load it; chip_smoke.py reads it by path.

* ``ORIENTED_BITS``: descriptor bits that may differ per frame between
  two runs of oriented BRIEF.  The 31x31 moment convolutions sum in
  another order in XLA, torch's CPU convolution and cuDNN, so an ulp of
  angle can flip a rotated pair where two bilinear samples nearly tie
  (port vs JAX on the CPU: 1 bit in one frame of 6 seen; card vs CPU: 0).
* ``UR_ATOL``: px between two runs' sub-pixel u_R (JAX's jitted adaptor
  fuses the 49-sample SSD otherwise: 1 ulp seen; card vs CPU: 0).
"""

ORIENTED_BITS = 8
UR_ATOL = 2.5e-4
