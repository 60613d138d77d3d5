"""PyTorch/CUDA port of t5_resnet_vqa_tpu for NVIDIA Hopper (H100).

The subpackages mirror the JAX package (core, ops, models, data, eval,
utils), so each module's counterpart is found by name. The two Pallas TPU
kernels of that package are hand-written CUDA C++ here (``csrc/``), each
beside a plain PyTorch version of the same function (``ops/attention.py``,
``ops/bottleneck.py``). This package imports torch and numpy, never JAX or
the JAX package.
"""
