"""The user-facing examples of the port, run as
``python -m b2txt_tpu_torch.examples.<name>`` (on the CUDA card unless
``--device cpu`` is given, where a demo puts work on a device)."""
