"""Command-line tools of the port (``python -m basi_tpu_torch.tools.<name>``)."""
