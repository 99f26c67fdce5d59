"""One reader a metric, found by the metric's name: ``<name>.py`` holds
``read(ctx) -> float | None`` (None: nothing to read in this run)."""
