"""goworld_tpu_torch: the PyTorch/CUDA port of goworld_tpu.

The same engine -- entities, spaces, the batched per-tick AOI visibility
pass -- with the pass running on an NVIDIA GPU through PyTorch and a
hand-written Hopper kernel (``csrc/``).  It imports torch and numpy, never
jax and never the goworld_tpu package; the tests hold it against
goworld_tpu bit for bit.  Entry points take ``device`` ("cuda" by
default; "cpu" runs the plain PyTorch versions of the kernels).
"""
