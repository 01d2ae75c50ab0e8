"""m2dec_tpu_torch — the PyTorch/CUDA port of m2dec_tpu.

It decodes H.264, H.265 and MPEG-1/2 in two phases, like the JAX
package. Phase A (entropy decode into plans) is host code with no
framework: the port keeps its own copies of the JAX package's host
layer (``bitstream``, the codecs' headers, decoders and plan producers,
and the native C++ Phase A under ``native/``). Phase B (reconstruction)
runs on torch tensors. On a CUDA device the H.264 intra and deblocking
wavefronts (``csrc/h264_wavefront.cu``) and the MPEG-2 8x8 IDCT
(``csrc/mpeg2_idct.cu``) run as hand-written kernels for sm_90a, built
with nvcc at first use; on CPU tensors the same functions run their
plain PyTorch versions. H.265's Phase B is plain torch ops (the JAX
package has no Pallas kernel for it).

This package imports neither jax nor any module of ``m2dec_tpu``.
"""

import torch

# The plain intra mode evaluation is an f32 matmul (values <= 2^12) that
# is exact only in full f32: keep TF32 off for matmuls and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
