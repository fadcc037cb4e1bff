"""Examples built on the port (``python -m aligator_tpu_torch.examples.<name>``)."""
