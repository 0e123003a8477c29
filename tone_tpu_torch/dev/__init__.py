"""The quality studies and debugging scripts of the port (counterparts of
the repo's ``dev/``), each runnable as ``python -m tone_tpu_torch.dev.<name>``
on the GPU, or on the CPU with ``--device cpu``."""
