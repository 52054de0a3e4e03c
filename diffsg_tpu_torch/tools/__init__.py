"""Command-line entry points of the port (``python -m diffsg_tpu_torch.tools.<name>``)."""
