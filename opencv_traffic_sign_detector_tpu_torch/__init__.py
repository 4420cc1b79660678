"""PyTorch/CUDA port of the traffic-sign detection framework.

A second package beside ``opencv_traffic_sign_detector_tpu`` (the JAX
reference, which stays as it is).  Plain tensor code is PyTorch; every TPU
kernel on a ported path is a CUDA kernel written for Hopper (``csrc/``),
built at first use by :mod:`.runtime.build`, each with a plain PyTorch
version that CPU tensors take.  The reference package's framework-free host
modules (config, constants, data, eval, utils) are imported, not copied.
This package never imports JAX.
"""
