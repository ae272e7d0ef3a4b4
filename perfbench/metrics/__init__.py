"""One reader a per-layer metric, found by the metric's name
(``manifest.Manifest.reader``). Each has ``read(ctx)``, which returns
the metric's value, or None where the run gave it nothing to read; the
harness then leaves the metric out of the result. ``ctx`` is
``run.Context``."""
