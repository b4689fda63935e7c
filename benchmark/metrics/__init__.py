"""One reader a per-layer metric, found by the metric's name
(``<name>.py``). ``read(ctx)`` returns the value, or ``None`` when the run
holds nothing to read; ``ctx`` has ``trace`` (``harness.trace.Trace``),
``work`` (what the window did), ``conf`` (the configuration) and
``chips``."""
