"""Host-side pieces reused from the JAX package, unchanged.

Phase A (the native C++ entropy decoder and the wire packer), the
reference-frame slot bookkeeping and the constant tables are plain
numpy/ctypes code: importing them does not import jax. The port takes
them from ``m2dec_tpu`` instead of copying them, and this module is
the one place that names them.
"""

from m2dec_tpu.codecs.h264 import tables  # noqa: F401
from m2dec_tpu.codecs.h264.decoder import Frame, H264Decoder  # noqa: F401
from m2dec_tpu.codecs.h264.native_pack import pack_batches  # noqa: F401
from m2dec_tpu.codecs.h264.reconstruct import (  # noqa: F401
    _HP_TAB,
    _I4_MAT,
    _I4_TAB,
    _I8_MAT,
    _I8_TAB,
    _PLAN_KEYS,
    _ZORDER,
    _DevSlotMap,
    _derive_mc_aux,
    _next_pow2,
    _pcm_rows,
    _remap_batch,
    _wire_views,
    dev_pool_size,
)
from m2dec_tpu.codecs.h264 import wavefront as _wf

get_geom = _wf.get_geom
#: skewed-plane margins (left, right, top, bottom) of the JAX package
WF_MARGINS_Y = (_wf.ML, _wf.MR, _wf.MT, _wf.MB_)
WF_MARGINS_C = (_wf.MLC, _wf.MRC, _wf.MTC, _wf.MBC)
