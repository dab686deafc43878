"""PyTorch/CUDA port of vist3a_tpu for NVIDIA Hopper (H100).

Module paths mirror the JAX package (`vist3a_tpu/nn/layers.py` ↔
`vist3a_tpu_torch/nn/layers.py`).  The package imports torch and never JAX;
every Pallas kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built at first use into `_build/`.
"""
