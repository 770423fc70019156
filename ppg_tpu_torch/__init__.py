"""ppg_tpu_torch: the guided path tracer of ppg_tpu ported to PyTorch and
CUDA for NVIDIA Hopper.

The layout mirrors ppg_tpu's: each module here is the counterpart of the
module of the same path there, which stays the reference. The package
imports torch and never JAX. Host-side scene loading, the BVH builder and
the native C++ helpers are shared with ppg_tpu (see scene.py).
"""
