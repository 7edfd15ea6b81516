"""Build of the hand-written CUDA kernels (see build.py)."""
