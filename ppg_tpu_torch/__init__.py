"""ppg_tpu_torch: the guided path tracer of ppg_tpu ported to PyTorch and
CUDA for NVIDIA Hopper.

The layout mirrors ppg_tpu's: each module here is the counterpart of the
module of the same path there, which stays the reference. The package
imports torch and never JAX, and nothing of ppg_tpu: the host code it
needs (scene loading, the BVH builder, the native C++ helpers) is its own
copy of ppg_tpu's, and its native libraries are built into
build/ppg_tpu_torch/ at the root of the checkout (native.py).
"""
