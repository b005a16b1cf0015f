"""Encoder orchestrator — the analog of ``gpujpeg_encoder_encode``
(reference: src/gpujpeg_encoder.c:287-548).

Pipeline: plan -> preprocess -> fused DCT+quant -> segment-parallel Huffman
-> stream assembly. The compute stages run either on the host golden path
(NumPy; reference's CPU fallback analog) or on device via JAX (default).
"""
from __future__ import annotations

import time

import numpy as np

from ..ops import golden
from ..ops.blocks import plane_to_blocks
from ..ops.preprocess import preprocess
from ..params import ImageParameters, Parameters
from ..plan import CoderPlan, make_plan
from ..stream.writer import HeaderType, JpegWriter
from ..tables import default_huffman_table, quant_table_zz
from ..types import ComponentType, HuffmanType


class EncoderStats:
    """Per-stage wall-clock durations in ms
    (analog of struct gpujpeg_duration_stats, gpujpeg_common.h:315-325)."""

    def __init__(self) -> None:
        self.duration_memory_to = 0.0      # H2D raw upload (perf_stats)
        self.duration_preprocessor = 0.0
        self.duration_dct_quantization = 0.0
        self.duration_huffman_coder = 0.0
        self.duration_memory_from = 0.0    # compaction D2H (perf_stats)
        self.duration_stream = 0.0
        self.duration_in_gpu = 0.0
        #: frames a device-backend encoder coded on the host: restart
        #: interval 0 (one segment per scan) or segments beyond the
        #: worst-case device capacities
        self.host_frames = 0

    def asdict(self) -> dict[str, float]:
        return dict(self.__dict__)


class Encoder:
    """Reusable encoder. Holds table state; the geometry plan is cached per
    (params, image) just like the reference re-uses its coder
    (gpujpeg_encoder.c:300-315)."""

    def __init__(self, backend: str = "jax", header_type: HeaderType = HeaderType.DEFAULT):
        self.backend = backend
        self.header_type = header_type
        self.stats = EncoderStats()

    # ------------------------------------------------------------------
    def _tables(self, params: Parameters):
        quant_zz = {
            0: quant_table_zz(ComponentType.LUMINANCE, params.quality),
            1: quant_table_zz(ComponentType.CHROMINANCE, params.quality),
        }
        huff = {
            (ct, ht): default_huffman_table(ct, ht)
            for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)
            for ht in (HuffmanType.DC, HuffmanType.AC)
        }
        return quant_zz, huff

    def warmup(self, params: Parameters, image: ImageParameters) -> None:
        """Pre-compile and pre-allocate for a geometry (the analog of the
        reference's gpujpeg_encoder_allocate / first-iteration cost,
        gpujpeg_encoder.c:221-254, FAQ.md:14-19)."""
        from ..types import image_calculate_size
        size = image_calculate_size(image.width, image.height,
                                    image.pixel_format)
        self.encode(np.zeros(size, np.uint8), params, image)

    #: rough device bytes per pixel of the encode pipeline at its peak
    #: (u8 planes + f32 DCT rows + i32 coefficients + entropy buffers),
    #: an estimate from those buffer sizes; used by the budgeting
    #: helpers below
    _DEVICE_BYTES_PER_PIXEL = 24

    def allocate(self, params: Parameters, image: ImageParameters) -> None:
        """Pre-allocate/compile for a geometry before the first encode
        (reference: gpujpeg_encoder_allocate, gpujpeg_encoder.c:221-254).
        Alias of :meth:`warmup`."""
        self.warmup(params, image)

    @classmethod
    def max_pixels(cls, memory_bytes: int) -> int:
        """Largest image (in pixels) the device encode pipeline fits in
        ``memory_bytes`` of device memory — a coarse estimate (reference:
        gpujpeg_encoder_max_pixels, gpujpeg_encoder.c:132-168). Images
        past ~2M blocks also chunk automatically, so this is a floor."""
        return max(0, memory_bytes // cls._DEVICE_BYTES_PER_PIXEL)

    @classmethod
    def max_memory(cls, pixels: int) -> int:
        """Estimated peak device memory (bytes) to encode ``pixels``
        (reference: gpujpeg_encoder_max_memory,
        gpujpeg_encoder.c:171-218)."""
        return pixels * cls._DEVICE_BYTES_PER_PIXEL

    def encode(self, raw, params: Parameters, image: ImageParameters) -> bytes:
        """Encode one frame to a JPEG byte stream.

        ``raw`` may be a NumPy array/bytes (host input) or a JAX device
        array — the latter skips the host->device copy, the analog of the
        reference's device-pointer/OpenGL-texture inputs
        (gpujpeg_encoder.c:353-395)."""
        plan = make_plan(params, image)
        quant_zz, huff = self._tables(params)

        result = None
        # restart_interval == 0 means one segment per whole scan: the
        # segment-parallel device formulation degenerates (bps pads to the
        # whole component's block count), so route to the host Huffman
        # coder exactly like the reference (gpujpeg_encoder.c:437-446).
        device_eligible = params.restart_interval > 0
        if self.backend != "golden" and device_eligible:
            result = self._encode_segments_jax(raw, plan, quant_zz, huff)
        if result is None:  # golden backend or a documented host route
            if self.backend != "golden":
                self.stats.host_frames += 1
            seg_bytes = self._encode_segments_golden(raw, plan, quant_zz, huff)
            result = self._to_scan_bodies(plan, seg_bytes)
        scan_bodies, seg_sizes_by_scan = result

        t0 = time.perf_counter()
        out = self._assemble(plan, quant_zz, huff, scan_bodies, seg_sizes_by_scan)
        self.stats.duration_stream = (time.perf_counter() - t0) * 1e3
        return out

    def encode_batch(self, raws, params: Parameters,
                     image: ImageParameters) -> list[bytes]:
        """Pipelined encode of same-geometry frames (the encode mirror of
        :meth:`Decoder.decode_batch`; reference users iterate
        ``gpujpegtool -e`` over image lists / Y4M frames).

        Device work for a window of upcoming frames is queued before each
        frame's D2H + host stream assembly, so the stream formatter (the
        reference's ~0.82 ms/8K host hot loop, README.md:115-118) and the
        JPEG writer run under later frames' device compute. Per-frame
        perf stats are not recorded. Returns one JPEG byte stream per
        frame."""
        device_eligible = (params.restart_interval > 0
                           and self.backend != "golden")
        if not device_eligible:
            return [self.encode(r, params, image) for r in raws]
        plan = make_plan(params, image)
        quant_zz, huff = self._tables(params)
        from ..ops.jax_pipeline import encode_batch_device
        outs = []
        for raw, result in zip(raws, encode_batch_device(
                self, raws, plan, quant_zz, huff)):
            if result is None:   # beyond worst-case caps: host coder
                self.stats.host_frames += 1
                seg_bytes = self._encode_segments_golden(
                    raw, plan, quant_zz, huff)
                result = self._to_scan_bodies(plan, seg_bytes)
            outs.append(self._assemble(plan, quant_zz, huff, *result))
        return outs

    _RST = tuple(bytes((0xFF, 0xD0 + i)) for i in range(8))

    @staticmethod
    def _to_scan_bodies(plan: CoderPlan, seg_bytes: list[bytes]):
        """Join per-segment bytes into per-scan bodies with RST markers
        (reference stream formatter: gpujpeg_encoder.c:479-537). RST
        markers ride as separate join parts so no per-segment bytes
        concatenation happens (~2x on the 50k-segment 8K fallback path)."""
        scan_bodies, seg_sizes_by_scan = [], []
        seg = 0
        for scan in plan.scans:
            n = scan.segment_count
            chunk = seg_bytes[seg:seg + n]
            seg += n
            sizes = np.fromiter(map(len, chunk), np.int64, n)
            sizes[:-1] += 2
            parts = []
            for i, data in enumerate(chunk):
                parts.append(data)
                if i != n - 1:
                    parts.append(Encoder._RST[i & 7])
            scan_bodies.append(b"".join(parts))
            seg_sizes_by_scan.append(sizes)
        return scan_bodies, seg_sizes_by_scan

    # ------------------------------------------------------------------
    def _encode_segments_golden(self, raw, plan: CoderPlan, quant_zz, huff):
        t0 = time.perf_counter()
        planes = preprocess(raw, plan.image, plan, np)
        t1 = time.perf_counter()
        coeff_plane = np.concatenate([
            golden.fdct_quant(plane_to_blocks(planes[c.index], np),
                              quant_zz[c.quant_table_index])
            for c in plan.components
        ])
        coeff_scan = coeff_plane[plan.block_plane_idx]
        t2 = time.perf_counter()
        dc_by_comp = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
        ac_by_comp = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
        from ..native import encode_segments_native
        seg_bytes = encode_segments_native(plan, coeff_scan, dc_by_comp, ac_by_comp)
        if seg_bytes is None:  # no compiler available
            seg_bytes = golden.encode_segments(plan, coeff_scan, dc_by_comp, ac_by_comp)
        t3 = time.perf_counter()
        self.stats.duration_preprocessor = (t1 - t0) * 1e3
        self.stats.duration_dct_quantization = (t2 - t1) * 1e3
        self.stats.duration_huffman_coder = (t3 - t2) * 1e3
        return seg_bytes

    def _encode_segments_jax(self, raw, plan: CoderPlan, quant_zz, huff):
        from ..ops.jax_pipeline import encode_segments_device
        return encode_segments_device(self, raw, plan, quant_zz, huff)

    # ------------------------------------------------------------------
    def _assemble(self, plan: CoderPlan, quant_zz, huff, scan_bodies,
                  seg_sizes_by_scan) -> bytes:
        """Final stream formatting (reference: gpujpeg_encoder.c:479-537).
        Scan bodies arrive with RST markers already in place (inserted on
        device, or by :meth:`_to_scan_bodies` on the golden path)."""
        w = JpegWriter()
        w.write_header(plan, quant_zz, huff, self.header_type)
        for scan in plan.scans:
            w.write_scan_header(plan, scan.index)
            w.emit_bytes(scan_bodies[scan.index])
            sizes = seg_sizes_by_scan[scan.index]
            offsets = np.concatenate([[0], np.cumsum(sizes)])
            w.patch_segment_info(offsets)
        w.write_eoi()
        return w.tobytes()
