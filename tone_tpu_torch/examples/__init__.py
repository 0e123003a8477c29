"""The recipes of the port (counterparts of the repo's ``examples/``), each
runnable as ``python -m tone_tpu_torch.examples.<name>`` on the GPU, or on
the CPU with ``--device cpu``."""
