"""Command-line tools, run as ``python -m radet_tpu_torch.tools.<name>``."""
