"""Encoding/decoding parameters.

Mirrors ``struct gpujpeg_parameters`` and ``struct gpujpeg_image_parameters``
(reference: libgpujpeg/gpujpeg_common.h:165-196, 250-261) with the same
defaults (reference: gpujpeg_set_default_parameters, gpujpeg_common.c:264-298).
"""
from __future__ import annotations

import dataclasses

from .types import (
    ColorSpace,
    MAX_COMPONENT_COUNT,
    PixelFormat,
    PIXEL_FORMAT_DESC,
    SamplingFactor,
    SUBSAMPLING_420,
    SUBSAMPLING_422,
    SUBSAMPLING_444,
)


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Codec parameters (reference: gpujpeg_common.h:165-196)."""

    #: JPEG quality 1..100
    quality: int = 75
    #: Restart interval: number of MCUs per independent entropy segment.
    #: 0 disables restart markers (sequential CPU-style entropy coding).
    restart_interval: int = 8
    #: Single interleaved scan (True) vs one scan per component (False).
    interleaved: bool = False
    #: Emit APP13 segment-info headers for O(1) decode-side segment split.
    segment_info: bool = False
    #: Per-component sampling factors of the *JPEG internal* representation.
    sampling_factor: tuple[SamplingFactor, ...] = SUBSAMPLING_444 + (SamplingFactor(1, 1),)
    #: Color space inside the JPEG stream (default: full-range BT.601 YCbCr).
    color_space_internal: ColorSpace = ColorSpace.YCBCR_BT601_256LVLS
    #: Verbosity 0-3
    verbose: int = 0
    #: Collect per-stage performance statistics
    perf_stats: bool = False

    def with_chroma_subsampling(self, subsampling: int) -> "Parameters":
        """Set 4:4:4/4:2:2/4:2:0 preset
        (reference: gpujpeg_parameters_chroma_subsampling, gpujpeg_common.c:332)."""
        table = {444: SUBSAMPLING_444, 422: SUBSAMPLING_422, 420: SUBSAMPLING_420}
        sf = table[subsampling] + (SamplingFactor(1, 1),)
        return dataclasses.replace(self, sampling_factor=sf)


@dataclasses.dataclass(frozen=True)
class ImageParameters:
    """Image parameters (reference: gpujpeg_common.h:250-261)."""

    width: int = 0
    height: int = 0
    color_space: ColorSpace = ColorSpace.RGB
    pixel_format: PixelFormat = PixelFormat.PF_444_U8_P012

    @property
    def comp_count(self) -> int:
        return PIXEL_FORMAT_DESC[PixelFormat(self.pixel_format)].comp_count


def suggest_restart_interval(img: ImageParameters, subsampled: bool,
                             interleaved: bool, pow2: bool = False) -> int:
    """Heuristic restart interval by image size
    (reference: gpujpeg_encoder_suggest_restart_interval,
    gpujpeg_encoder.c:256-283). With ``pow2=False`` (default) the values
    are reference-identical.

    ``pow2=True`` rounds to the nearest power of two: the device entropy
    stage pads every segment to a power-of-two block count for its
    logarithmic merge tree (ops/entropy_v2.py), so ri=36 would waste 78%
    of the stage's rows where ri=32 wastes none. The device encoder
    paths (CLI, sharded encoder, benches) pass it explicitly.
    """
    mpix = img.width * img.height / 1_000_000.0
    if mpix < 1:
        ri = 4
    elif mpix < 3:
        ri = 8
    elif mpix < 9:
        ri = 10
    else:
        ri = 12
    if subsampled and interleaved:
        ri = max(1, ri // 2)
    if not interleaved:
        ri *= img.comp_count
    if pow2:
        p = 1
        while p * 2 <= ri:
            p *= 2
        ri = p * 2 if ri - p > p * 2 - ri else p
    return ri
