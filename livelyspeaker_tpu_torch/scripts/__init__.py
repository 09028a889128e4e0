"""Command-line entry points of the port, run as
``python -m livelyspeaker_tpu_torch.scripts.<name>``."""
