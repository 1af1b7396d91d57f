"""PyTorch/CUDA port of the probe workload of ``gpumounter_tpu``.

The JAX package stays the reference; this package imports neither JAX nor
anything of ``gpumounter_tpu``. Its kernels are hand-written for Hopper
(sm_90a) under ``ops/csrc`` and built at first use (``ops/_build.py``).
"""
