"""MMGL in PyTorch on an NVIDIA H100: the port of mmgl_tpu.

mmgl_tpu (JAX on a TPU) stays the reference; each module here names its
counterpart there. Plain tensor code is PyTorch; the attention kernels the
JAX package wrote in Pallas are hand-written CUDA for Hopper (csrc/). The
package imports no JAX.

  data    — copies of the JAX package's numpy data layer
  models  — OPT, the CLIP vision tower and the fusion model
  ops     — attention dispatch, kernel wrappers and their build
  train   — losses, the eval step and greedy generation
  utils   — weight conversion from the JAX parameter tree
  cli     — the test-time pass of the command line
"""

__version__ = "0.1.0"
