"""The plain reference that decides `correct`: imports nothing of genie2_tpu_torch or JAX."""
