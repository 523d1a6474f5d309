"""Logging and per-epoch metrics: the port's copy of
``mmvae_tpu/utils/logging.py`` and ``metrics.py``."""
