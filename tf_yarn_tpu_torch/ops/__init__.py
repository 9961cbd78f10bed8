"""Ops of the port: plain torch versions and hand-written Hopper kernels.

Each kernel module dispatches on the tensor's device — CUDA tensors
launch the kernel (built from csrc/ at first use, `_build.py`), CPU
tensors take the plain version beside it — and counts its launches in a
plain integer on the wrapper (``rmsnorm.launches`` and so on).
"""
