"""The metrics of the benchmark: one reader a metric (``<name>.py``, with a
``read(ctx)`` that returns the value or None where it finds nothing to
read), and what the readers share: the published peaks (``peaks.py``),
the operations and bytes of each configuration's work (``work.py``) and the
classes of the port's kernels (``kernel_parts.py``)."""
