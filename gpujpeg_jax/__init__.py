"""gpujpeg_jax — a baseline JPEG (ITU-T T.81) encoder/decoder in JAX.

A JAX re-design of the capabilities of GPUJPEG: the pixel pipeline
(color transform, subsampling, 8x8 DCT+quantization as one fp32
product) runs on the device, restart-marker segments make Huffman
entropy coding data-parallel there (a Pallas kernel decodes one segment
per lane on the GPU), and the stream layer (JFIF/SPIFF/Adobe markers,
PNM/PAM/Y4M I/O) runs on the host. Unlike the single-GPU reference,
images shard across device meshes by MCU rows / restart segments with
collective bitstream assembly.
"""
from __future__ import annotations

from .runtime import enable_compilation_cache as _enable_compilation_cache

_enable_compilation_cache()

from .params import ImageParameters, Parameters, suggest_restart_interval
from .models.decoder import Decoder
from .models.encoder import Encoder
from . import parallel  # noqa: F401  (ShardedEncoder / ShardedDecoder)
from .stream.reader import JpegParseError, get_image_info, read_image
from .types import (
    ColorSpace,
    ComponentType,
    GpujpegError,
    HuffmanType,
    PixelFormat,
    SamplingFactor,
    SUBSAMPLING_420,
    SUBSAMPLING_422,
    SUBSAMPLING_444,
    YCBCR_JPEG,
)

__version__ = "0.1.0"

__all__ = [
    "ColorSpace", "ComponentType", "Decoder", "Encoder", "GpujpegError",
    "HuffmanType", "ImageParameters", "JpegParseError", "Parameters",
    "PixelFormat",
    "SamplingFactor", "SUBSAMPLING_420", "SUBSAMPLING_422", "SUBSAMPLING_444",
    "YCBCR_JPEG", "get_image_info", "read_image", "suggest_restart_interval",
]
