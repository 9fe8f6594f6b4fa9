"""The benchmark of ``unclerenderer_tpu_torch`` (``BENCHMARK.json``): the
harness (``run.py``), its configurations, traffic mixes and per-layer
metric readers, the frozen yardstick (scene generator, trace arithmetic,
roofline work) and the reference (``reference/``)."""
