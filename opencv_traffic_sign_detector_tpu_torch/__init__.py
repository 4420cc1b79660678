"""PyTorch/CUDA port of the traffic-sign detection framework.

A second package beside ``opencv_traffic_sign_detector_tpu`` (the JAX
reference, which stays as it is).  Plain tensor code is PyTorch; every TPU
kernel on a ported path is a CUDA kernel written for Hopper (``csrc/``),
built at first use by :mod:`.runtime.build`, each with a plain PyTorch
version that CPU tensors take.  The host modules it shares with the
reference (config, constants, data, eval, utils, the native JPEG loader)
are its own copies, under the same relative paths: this package imports
neither JAX nor anything of the reference package.
"""
