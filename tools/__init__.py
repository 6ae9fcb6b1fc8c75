"""Measurement tools of the PyTorch + CUDA port: the before/after timers of
its kernels (tools/*_before_after.py, on one card) and the SASS
instruction counter behind chip_smoke.py's issue floors (tools/sass.py)."""
