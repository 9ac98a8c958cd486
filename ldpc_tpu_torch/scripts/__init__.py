"""The port's counterparts of the JAX package's ``scripts/``, run as
``python -m ldpc_tpu_torch.scripts.<name>``."""
