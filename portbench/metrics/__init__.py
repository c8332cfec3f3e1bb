"""Per-layer metric readers, one file a metric, named as in BENCHMARK.json.

Each ``read(t)`` takes a ``portbench.profiling.TraceView`` of the traced
window, with ``t.work`` (the loop's work in it: ``fits``, or ``columns`` and
``calls``), ``t.counts`` (``portbench.counts.for_config``) and ``t.peak``
(``portbench.counts.PEAKS``' entry of the card, None if it has none), and
returns the metric's value, or None where it finds nothing to read.  A
reader of one layer's kernels names the layer's file in ``LAYER`` and reads
``t.layer_seconds(LAYER)``.
"""
