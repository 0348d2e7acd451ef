"""Command-line apps of the port, each the twin of the JAX package's app of
the same name in ``apps/``: run them as ``python -m
srrg2_proslam_tpu_torch.apps.<name>``."""
