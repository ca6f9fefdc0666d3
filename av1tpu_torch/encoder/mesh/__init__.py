"""Multi-process stripes: the ``AV1TPU_*`` process group (``distributed``)."""
