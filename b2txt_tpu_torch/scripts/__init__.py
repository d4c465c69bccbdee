"""Scripts of the port, run as ``python -m b2txt_tpu_torch.scripts.<name>``."""
