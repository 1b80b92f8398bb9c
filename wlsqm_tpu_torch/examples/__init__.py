"""Runnable examples of the port (``python -m wlsqm_tpu_torch.examples.<name>``)."""
