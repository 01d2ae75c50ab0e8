from .reader import BitReader, BitstreamError, BitstreamExhausted, unescape_nal
from .writer import BitWriter

__all__ = [
    "BitReader",
    "BitWriter",
    "BitstreamError",
    "BitstreamExhausted",
    "unescape_nal",
]
