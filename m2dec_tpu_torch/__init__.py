"""m2dec_tpu_torch — the PyTorch/CUDA port of m2dec_tpu's H.264 Phase B.

Phase A (native C++ entropy decode, plan packing) is host code with no
framework and is imported from ``m2dec_tpu`` unchanged; Phase B
(reconstruction) runs here on torch tensors. On a CUDA device the intra
and deblocking wavefronts run as hand-written kernels for sm_90a
(``csrc/h264_wavefront.cu``), built with nvcc at first use; on CPU
tensors the same functions run their plain PyTorch versions.

This package never imports jax.
"""

import torch

# The plain intra mode evaluation is an f32 matmul (values <= 2^12) that
# is exact only in full f32: keep TF32 off for matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
