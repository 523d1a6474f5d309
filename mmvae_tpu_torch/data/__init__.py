"""Host data blocks and batch schedules: the port's copy of
``mmvae_tpu/data/block.py`` and ``pipeline.py``."""
