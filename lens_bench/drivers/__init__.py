"""Drivers, one a traffic kind: ``<kind>.py`` has ``run(cell, ctx)``."""
