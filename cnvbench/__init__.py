"""cnvbench: the benchmark of canvas_tpu_torch (see README.md)."""
