"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that belongs
to one configuration, traffic mix, layer or per-layer metric is a file of its
own, found by its name (``spec.py``).  Nothing here imports ``jax`` or the
JAX package ``repro``; the reference (``references/``) imports nothing of
``repro_torch`` either.
"""
