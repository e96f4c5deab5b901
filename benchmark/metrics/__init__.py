"""One reader per per-layer metric: ``metrics/<name>.py`` with
``read(record)``, which returns the number or None when the run holds
nothing to read."""
