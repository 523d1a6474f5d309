"""Host data blocks, batch schedules and the feature annotation: the
port's copy of ``mmvae_tpu/data/block.py``, ``pipeline.py`` and
``annotation.py``."""
