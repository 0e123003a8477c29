"""Parallelism of the port (port of ``tone_tpu/parallel/``): the device mesh
of bulk transcription and serving (``mesh``), the process mesh and
collectives of tensor- and data-parallel training (``collectives``), and
the starting of training ranks (``ranks``)."""
