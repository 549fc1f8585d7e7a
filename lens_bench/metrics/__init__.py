"""Per-layer metric readers, one a file: ``<metric>.py`` has ``read(ctx)``."""
