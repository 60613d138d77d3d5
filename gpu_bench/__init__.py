"""The benchmark of the PyTorch/CUDA port (``t5_resnet_vqa_torch``) on one
NVIDIA H100: see README.md in this folder and ``BENCHMARK.json``."""
