"""Multi-chip sharded JPEG encode over a ``jax.sharding.Mesh``.

This is the capability the reference does NOT have (SURVEY §2.3: GPUJPEG is
single-process/single-GPU; multi-GPU only via one coder per device,
reference: gpujpeg_common.c:192-260). This engine makes distribution a
first-class axis:

* **Band sharding ('seg' mesh axis)** — one huge image is split into
  horizontal *bands* of whole MCU rows. JPEG makes this embarrassingly
  parallel: 8x8 blocks are independent through DCT+quant, and restart
  markers make entropy segments independent too (DC prediction resets at
  every RST, reference: gpujpeg_huffman_gpu_encoder.cu:326-337). Each
  device runs the full pixel+entropy pipeline on its band; the only
  cross-device work is assembling the variable-length per-segment byte
  ranges — per-segment byte counts come back to the host (the analog of
  the reference's single output-size D2H sync,
  gpujpeg_huffman_gpu_encoder.cu:1158) and the bitstream is compacted with
  one vectorized gather.

* **Frame sharding ('frame' mesh axis)** — a video batch dimension; frames
  are dealt across the other mesh axis (per-host frame sharding for Y4M
  streams, BASELINE.json config 5).

Alignment rules (validated by :func:`plan_bands`):

* pixel rows per band must be a multiple of the MCU pixel height
  (8 * max vertical sampling), so bands contain whole MCU rows;
* the restart interval must divide every component's per-band MCU count,
  so band boundaries coincide with segment boundaries and every
  non-final segment is exactly ``restart_interval`` MCUs as DRI promises.
  :func:`choose_restart_interval` picks the largest conforming interval
  at or below the single-chip heuristic
  (reference: gpujpeg_encoder_suggest_restart_interval,
  gpujpeg_encoder.c:256-283).
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.4.35 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map as _shard_map

from ..params import ImageParameters, Parameters, suggest_restart_interval
from ..plan import CoderPlan, make_plan
from ..stream.writer import HeaderType, JpegWriter
from ..tables import default_huffman_table, quant_table_zz
from ..types import ComponentType, HuffmanType, PixelFormat, PIXEL_FORMAT_DESC
from ..ops.blocks import plane_to_blocks
from ..ops.preprocess import preprocess
from ..runtime import device_routes


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """Static description of how an image splits into per-device bands."""

    n_bands: int
    rows_per_band: int
    band_image: ImageParameters
    plan: CoderPlan           # per-band coder plan (identical for all bands)
    band_raw_bytes: int

    @property
    def segs_per_band(self) -> int:
        return self.plan.n_segments


def _mcu_pixel_height(params: Parameters, comp_count: int) -> int:
    if comp_count == 1:
        return 8
    max_v = max(s.vertical for s in params.sampling_factor[:comp_count])
    return 8 * max_v


def choose_restart_interval(params: Parameters, image: ImageParameters,
                            n_bands: int) -> int:
    """Largest restart interval <= the single-chip suggestion that divides
    every component's per-band MCU count (so all bands' segments are full)."""
    rows = image.height // n_bands
    subsampled = any(s != params.sampling_factor[0]
                     for s in params.sampling_factor[:image.comp_count])
    want = suggest_restart_interval(image, subsampled, params.interleaved,
                                    pow2=True)
    band_image = dataclasses.replace(image, height=rows)
    plan = make_plan(dataclasses.replace(params, restart_interval=0), band_image)
    if params.interleaved and image.comp_count > 1:
        counts = [plan.scans[0].mcu_count]
    else:
        counts = [c.mcu_count for c in plan.components]
    for ri in range(min(want, min(counts)), 0, -1):
        if all(cnt % ri == 0 for cnt in counts):
            return ri
    return 1


def plan_bands(params: Parameters, image: ImageParameters,
               n_bands: int) -> BandLayout:
    """Split the image into ``n_bands`` equal horizontal bands of whole MCU
    rows and build the per-band coder plan."""
    mcu_h = _mcu_pixel_height(params, image.comp_count)
    if params.restart_interval <= 0 and n_bands > 1:
        raise ValueError("sharded encode requires restart markers "
                         "(restart_interval > 0): segments are the unit of "
                         "cross-device independence")
    if image.height % n_bands != 0:
        raise ValueError(
            f"image height {image.height} not divisible into {n_bands} bands")
    rows = image.height // n_bands
    if rows % mcu_h != 0:
        raise ValueError(
            f"band height {rows} is not a multiple of the MCU height {mcu_h}")
    band_image = dataclasses.replace(image, height=rows)
    plan = make_plan(params, band_image)
    # every band but the last must end exactly on a segment boundary, i.e.
    # the restart interval divides each scan's per-band MCU count
    if n_bands > 1:
        if params.interleaved and image.comp_count > 1:
            counts = {0: plan.scans[0].mcu_count}
        else:
            counts = {c.index: c.mcu_count for c in plan.components}
        for idx, cnt in counts.items():
            if cnt % params.restart_interval != 0:
                raise ValueError(
                    f"restart interval {params.restart_interval} does not "
                    f"divide scan {idx}'s per-band MCU count {cnt}; use "
                    "choose_restart_interval()")
    from ..types import image_calculate_size
    return BandLayout(
        n_bands=n_bands, rows_per_band=rows, band_image=band_image,
        plan=plan,
        band_raw_bytes=image_calculate_size(image.width, rows,
                                            image.pixel_format),
    )


def split_raw_bands(raw, image: ImageParameters, layout: BandLayout) -> np.ndarray:
    """Reshape a raw frame into (n_bands, band_raw_bytes) — contiguous for
    packed formats, a per-component row-slice shuffle for planar ones."""
    raw = np.asarray(raw, dtype=np.uint8).reshape(-1)
    desc = PIXEL_FORMAT_DESC[PixelFormat(image.pixel_format)]
    n, rows = layout.n_bands, layout.rows_per_band
    if not desc.planar:
        return raw.reshape(n, rows * image.width * desc.bpp)
    # planar: slice each component's plane by rows, re-concat per band
    sf0 = desc.sampling[0]
    parts = []
    pos = 0
    for c in range(desc.comp_count):
        sfc = desc.sampling[c]
        cw = -(-image.width * sfc.horizontal // sf0.horizontal)
        ch = -(-image.height * sfc.vertical // sf0.vertical)
        plane = raw[pos:pos + cw * ch].reshape(ch, cw)
        pos += cw * ch
        parts.append(plane.reshape(n, ch // n * cw))
    return np.concatenate(parts, axis=1)


def _global_rst_arrays(layout: BandLayout) -> tuple[np.ndarray, np.ndarray]:
    """Per-band RST markers / has-RST flags with *global* scan numbering.

    Within one scan, segment i gets RST(i % 8) after it, except the very
    last segment of the scan (reference: gpujpeg_encoder.c:479-537). Bands
    concatenate in order inside each scan, so band b's local segment j of
    scan s has global index b * segs_per_band(s) + j.
    """
    plan = layout.plan
    n = layout.n_bands
    S = plan.n_segments
    rst = np.zeros((n, S), np.int32)
    has = np.ones((n, S), np.int32)
    for s in range(S):
        scan_id = int(plan.seg_scan[s])
        local_idx = int(plan.seg_scan_index[s])
        spb = plan.scans[scan_id].segment_count
        for b in range(n):
            g = b * spb + local_idx
            rst[b, s] = 0xD0 + (g % 8)
            if b == n - 1 and local_idx == spb - 1:
                has[b, s] = 0
    return rst, has


@dataclasses.dataclass
class _DeferredBands:
    """Un-fetched per-band device output (ShardedDecoder.decode_batch
    pipelining): the device_get + stitch run at collect time."""
    out: object
    out_image: ImageParameters
    layout: "BandLayout"


class ShardedDecoder:
    """Decoder that deals restart segments to devices band by band.

    The decode mirror of :class:`ShardedEncoder`: the host parses markers
    and splits the scan into segments (O(1) with APP13 segment info,
    reference: gpujpeg_reader.c:1058-1126), deals each band's segments to
    its device, and every device runs Huffman decode -> dequant+IDCT ->
    postprocess on its band. The host stitches the raw bands back
    together. Requires every scan's segment count to divide evenly into
    bands (true for streams produced by :class:`ShardedEncoder` and for
    any stream whose per-scan MCU count is band-aligned)."""

    def __init__(self, mesh: Mesh | None = None):
        if mesh is None:
            devs = np.array(jax.devices())
            mesh = Mesh(devs.reshape(1, -1), ("frame", "seg"))
        if "seg" not in mesh.axis_names:
            raise ValueError("mesh must have a 'seg' axis")
        self.mesh = mesh
        self.n_seg = mesh.shape["seg"]
        #: device route of each stage, fixed by platform (runtime.ROUTES)
        self.routes = device_routes()
        #: run the Huffman kernel in the Pallas interpreter (tests only)
        self._kernel_interpret = False
        self._cache: dict = {}
        self._reorders: dict = {}

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> tuple[np.ndarray, ImageParameters]:
        from ..stream import reader as stream_reader
        from ..models.decoder import Decoder
        from ..types import ColorSpace

        info = stream_reader.read_image(data)
        n = self.n_seg
        # feasibility: height splits into whole-MCU-row bands and every
        # scan's segments divide across bands
        try:
            params, image, plan_full = self._plan_params(info)
            layout = plan_bands(params, image, n)
        except ValueError:
            dec = Decoder(backend="jax")
            return dec.decode(data)
        for scan in layout.plan.scans:
            full = plan_full.scans[scan.index].segment_count
            if full != scan.segment_count * n:
                dec = Decoder(backend="jax")
                return dec.decode(data)

        out_image = ImageParameters(
            width=info.width, height=info.height,
            color_space=ColorSpace.RGB,
            pixel_format=info.deduce_pixel_format())
        raw_bands = self._decode_bands(info, layout, out_image)
        if not isinstance(raw_bands, np.ndarray):
            # deferred device fetch (decode_batch pipelining)
            return _DeferredBands(raw_bands, out_image, layout)
        raw = self._stitch(raw_bands, out_image, layout)
        return raw, out_image

    def decode_batch(self, streams, window: int = 3) -> list:
        """Pipelined decode of a frame sequence: each frame's host work
        (parse, per-band row build) runs while earlier frames' bands
        decode on the devices; band fetch + stitch happen at collect
        time (the sharded mirror of Decoder.decode_batch). At most
        ``window`` frames' band outputs are in flight at once so long
        sequences run in bounded device memory."""
        outs = []
        pending = []   # (decode() result, stream bytes) in launch order

        def collect_one():
            item, s = pending.pop(0)
            if not isinstance(item, _DeferredBands):
                outs.append(item)
                return
            bands = np.asarray(jax.device_get(item.out))
            outs.append((self._stitch(bands, item.out_image,
                                       item.layout), item.out_image))

        self._defer_get = True
        try:
            for s in streams:
                pending.append((self.decode(s), s))
                if len(pending) > window:
                    collect_one()
        finally:
            self._defer_get = False
        while pending:
            collect_one()
        return outs

    # ------------------------------------------------------------------
    def _plan_params(self, info):
        from ..types import ColorSpace, SamplingFactor
        sampling = tuple(c.sampling for c in info.components)
        sampling = sampling + (SamplingFactor(1, 1),) * (4 - len(sampling))
        params = Parameters(
            restart_interval=info.restart_interval,
            interleaved=info.interleaved,
            color_space_internal=info.color_space,
            sampling_factor=sampling,
        )
        image = ImageParameters(
            width=info.width, height=info.height,
            color_space=ColorSpace.RGB,
            pixel_format=info.deduce_pixel_format(),
        )
        return params, image, make_plan(params, image)

    def _decode_bands(self, info, layout: BandLayout, out_image):
        """Decode every band on its own device under shard_map, on the
        Huffman route of this decoder's platform (runtime.ROUTES)."""
        from ..models.decoder import huffman_maps

        plan = layout.plan
        band_out = dataclasses.replace(out_image, height=layout.rows_per_band)
        dc_by_comp, ac_by_comp = huffman_maps(info)
        qts = tuple(
            tuple(int(x) for x in info.quant_tables[
                info.components[c.index].quant_table_index])
            for c in plan.components)
        route = self.routes["huffman_decode"]
        band_inputs = (self._kernel_band_inputs if route == "kernel"
                       else self._xla_band_inputs)
        key_extra, frames, consts = band_inputs(info, layout, dc_by_comp,
                                                ac_by_comp)
        # the jitted shard_map is cached per (geometry, capacity bucket,
        # quant tables): a fresh jit(closure) per call would retrace and
        # recompile every frame of a video stream. Decode tables ride as
        # runtime arguments, so they need not key the cache.
        key = (route, plan.params, plan.image, band_out, layout.n_bands,
               key_extra, qts, self._kernel_interpret)
        fn = self._cache.get(key)
        if fn is None:
            from ..ops.jax_pipeline import _huffman_stage
            from ..ops.blocks import blocks_to_plane
            from ..ops.dct import dequant_idct_device, idct_split_operator
            from ..ops.preprocess import postprocess

            huff, out_row = _huffman_stage(plan, route,
                                           self._kernel_interpret)
            inv = np.empty(plan.n_blocks, dtype=np.int32)
            inv[plan.block_plane_idx] = np.arange(plan.n_blocks,
                                                  dtype=np.int32)
            inv_identity = bool(np.array_equal(inv,
                                               np.arange(plan.n_blocks)))
            # geometry-sized reorder maps are replicated runtime ARGUMENTS
            # (embedded million-element constants serialize into the
            # lowered module — minutes of lowering at 8K+)
            self._reorders[key] = (
                jnp.asarray(out_row if out_row is not None
                            else np.zeros(1, np.int32)),
                jnp.asarray(inv if not inv_identity
                            else np.zeros(1, np.int32)))
            Ws = tuple(jnp.asarray(np.asarray(q, np.float32)) for q in qts)
            d_hi, d_lo = (jnp.asarray(a) for a in idct_split_operator())
            comp_slices = []
            pos = 0
            for c in plan.components:
                comp_slices.append((pos, c.block_count, c.data_height,
                                    c.data_width))
                pos += c.block_count
            n_frame = len(frames)

            def local_fn(*args):
                frame_b = args[:n_frame]
                consts_l = args[n_frame:-2]
                out_row_a, inv_a = args[-2:]

                def one(*frame):
                    coeff = huff(frame, consts_l, out_row_a)
                    coeff = coeff if inv_identity else coeff[inv_a]
                    planes = []
                    for (start, count, dh, dw), q in zip(comp_slices, Ws):
                        blocks = dequant_idct_device(
                            coeff[start:start + count], q, d_hi, d_lo)
                        planes.append(blocks_to_plane(blocks, dh, dw, jnp))
                    planes = list(
                        jax.lax.optimization_barrier(tuple(planes)))
                    return postprocess(planes, band_out, plan, jnp)
                if frame_b[0].shape[0] == 1:
                    # one band per device (the common mesh): no vmap
                    return one(*(f[0] for f in frame_b))[None]
                return jax.vmap(one)(*frame_b)

            band_spec = [P("seg", *([None] * (f.ndim - 1))) for f in frames]
            fn = jax.jit(_shard_map(
                local_fn, mesh=self.mesh,
                in_specs=tuple(band_spec) + (P(),) * (len(consts) + 2),
                out_specs=P("seg", None),
                # pallas_call out_shapes carry no varying-axis types
                check_vma=False,
            ))
            self._cache[key] = fn
        # each band goes straight from the host to its own device
        frames_dev = tuple(
            jax.device_put(f, NamedSharding(
                self.mesh, P("seg", *([None] * (f.ndim - 1)))))
            for f in frames)
        dev_args = frames_dev + tuple(jnp.asarray(c) for c in consts) + \
            self._reorders[key]
        # bench hook (mirrors Decoder.capture_device_call)
        self.last_device_call = (fn, dev_args)
        out = fn(*dev_args)
        if getattr(self, "_defer_get", False):
            return out          # decode_batch fetches at collect time
        return np.asarray(jax.device_get(out))

    def _stream_scan(self, info, scan):
        return (info.scans[0] if info.interleaved
                else next(sc for sc in info.scans
                          if sc.components[0].comp_index == scan.index))

    def _kernel_band_inputs(self, info, layout, dc_by_comp, ac_by_comp):
        """Per-band transposed word rows with one common capacity, plus
        the kernel's segment layout and tables."""
        from ..ops.huffman_kernel import (
            SEG_TILE, build_segment_rows_t, bucket_wcap, segment_layout,
            segment_ranges_wcap, table_slots)
        plan = layout.plan
        n = layout.n_bands
        spb = {s.index: s.segment_count for s in plan.scans}
        band_ranges = []
        wcap = 0
        for b in range(n):
            scan_data_b, segs_b = [], []
            for scan in plan.scans:
                stream_scan = self._stream_scan(info, scan)
                lo_seg = b * spb[scan.index]
                segs_b.append(stream_scan.segments[
                    lo_seg:lo_seg + spb[scan.index]])
                scan_data_b.append(stream_scan.data)
            concat_b, lo_b, hi_b, w_b = segment_ranges_wcap(
                scan_data_b, segs_b, plan)
            band_ranges.append((concat_b, lo_b, hi_b))
            wcap = max(wcap, w_b)
        wcap = bucket_wcap(wcap)
        s_pad = -(-plan.n_segments // SEG_TILE) * SEG_TILE
        data_t = np.stack([build_segment_rows_t(c, lo, hi, plan, wcap, s_pad)
                           for c, lo, hi in band_ranges])
        tabs, dc_slot, ac_slot = table_slots(plan, dc_by_comp, ac_by_comp)
        seg_comp, seg_nblk, tpl = segment_layout(plan, s_pad)
        consts = (seg_comp, seg_nblk, tpl, tabs.quick, tabs.maxcode,
                  tabs.delta, tabs.huffval, dc_slot, ac_slot)
        return (wcap, s_pad, tabs.quick.shape[0]), (data_t,), consts

    def _xla_band_inputs(self, info, layout, dc_by_comp, ac_by_comp):
        """Per-band concatenated scan bytes (one common bucketed length)
        and local segment starts, plus the lockstep decoder's tables."""
        from ..ops.huffman_decode import build_dec_tables
        plan = layout.plan
        n = layout.n_bands
        # band b of plan-scan s gets global segments [b*spb, (b+1)*spb)
        spb = {s.index: s.segment_count for s in plan.scans}
        band_blobs, band_starts = [], []
        for b in range(n):
            parts, starts = [], np.zeros(plan.n_segments, np.int64)
            base = 0
            for scan in plan.scans:
                stream_scan = self._stream_scan(info, scan)
                segs = np.asarray(stream_scan.segments, np.int64)
                lo_seg = b * spb[scan.index]
                hi_seg = lo_seg + spb[scan.index]
                lo = int(segs[lo_seg, 0])
                hi = int(segs[hi_seg - 1, 1])
                part = np.asarray(stream_scan.data[lo:hi], np.uint8)
                sel = plan.seg_scan == scan.index
                starts[sel] = base + (segs[lo_seg:hi_seg, 0] - lo)
                parts.append(part)
                base += part.size
            band_blobs.append(np.concatenate(parts) if parts
                              else np.zeros(1, np.uint8))
            band_starts.append(starts)
        L_pad = max(1024, 1 << int(np.ceil(np.log2(
            max(max(bb.size for bb in band_blobs), 1)))))
        datab = np.zeros((n, L_pad), np.uint8)
        for b, bb in enumerate(band_blobs):
            datab[b, :bb.size] = bb
        startsb = np.stack(band_starts).astype(np.int32)
        luts, dc_tab, ac_tab = build_dec_tables(dc_by_comp, ac_by_comp)
        consts = (luts, dc_tab, ac_tab, np.asarray(plan.block_comp, np.int32),
                  np.asarray(plan.seg_block_start, np.int32),
                  np.asarray(plan.seg_block_count, np.int32))
        return (L_pad, luts.shape[0]), (datab, startsb), consts

    @staticmethod
    def _stitch(raw_bands: np.ndarray, out_image: ImageParameters,
                layout: BandLayout) -> np.ndarray:
        """Inverse of split_raw_bands: per-band raw buffers -> one frame."""
        desc = PIXEL_FORMAT_DESC[PixelFormat(out_image.pixel_format)]
        if not desc.planar:
            return raw_bands.reshape(-1)
        n = layout.n_bands
        H, W = out_image.height, out_image.width
        sf0 = desc.sampling[0]
        parts = []
        pos = 0
        for c in range(desc.comp_count):
            sfc = desc.sampling[c]
            cw = -(-W * sfc.horizontal // sf0.horizontal)
            ch = -(-H * sfc.vertical // sf0.vertical)
            rows_band = ch // n
            parts.append(raw_bands[:, pos:pos + rows_band * cw].reshape(-1))
            pos += rows_band * cw
        return np.concatenate(parts)


@dataclasses.dataclass
class _ShardedBuild:
    """Cached per-(params, image) sharded-encode state with lazy tier-2."""
    layout: BandLayout
    quant_zz: dict
    huff: dict
    rst_np: np.ndarray
    has_np: np.ndarray
    plan: CoderPlan
    geo1: object
    geo2: object
    make_fn: object
    fn1: object = None
    fn2: object = None

    def tier2(self):
        """Worst-case-capacity variant, built lazily on tier-1 overflow
        (mirror of the single-chip encode_segments_device tier loop)."""
        if self.fn2 is None:
            from ..ops.entropy_v2 import build_uniform_geometry
            self.geo2 = build_uniform_geometry(self.plan)
            self.fn2 = self.make_fn(self.geo2)
        return self.geo2, self.fn2


class ShardedEncoder:
    """Encoder that shards one image's MCU-row bands across the 'seg' mesh
    axis and (optionally) a frame batch across the 'frame' axis."""

    def __init__(self, mesh: Mesh | None = None):
        if mesh is None:
            devs = np.array(jax.devices())
            mesh = Mesh(devs.reshape(1, -1), ("frame", "seg"))
        if "seg" not in mesh.axis_names:
            raise ValueError("mesh must have a 'seg' axis")
        self.mesh = mesh
        self.n_seg = mesh.shape["seg"]
        self.n_frame = mesh.shape.get("frame", 1)
        self._cache: dict = {}

    # ------------------------------------------------------------------
    def _build(self, params: Parameters, image: ImageParameters):
        key = (params, image)
        hit = self._cache.get(key)
        if hit is not None:
            return hit

        from ..ops.entropy_v2 import (
            block_byte_budget, build_packed_tables, build_uniform_geometry,
            seg_budget_for_quality)

        layout = plan_bands(params, image, self.n_seg)
        plan = layout.plan
        quant_zz = {
            0: quant_table_zz(ComponentType.LUMINANCE, params.quality),
            1: quant_table_zz(ComponentType.CHROMINANCE, params.quality),
        }
        huff = {
            (ct, ht): default_huffman_table(ct, ht)
            for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)
            for ht in (HuffmanType.DC, HuffmanType.AC)
        }
        tabs = build_packed_tables(huff)
        rst_np, has_np = _global_rst_arrays(layout)
        geo_probe = build_uniform_geometry(plan)
        budget = seg_budget_for_quality(params.quality, geo_probe.bps)

        from ..ops.dct import fdct_quant_rows, fdct_split_operator
        d_hi, d_lo = (jnp.asarray(a) for a in fdct_split_operator())
        qdiv = jnp.asarray(np.maximum(np.stack([
            np.asarray(quant_zz[0], np.float32),
            np.asarray(quant_zz[1], np.float32)]), 1.0))
        # row layout (coeff_idx / block_cls) is capacity-independent:
        # geo_probe, tier-1 and tier-2 share it
        NB = plan.n_blocks
        spp = np.append(plan.block_plane_idx, NB)
        idx_plane = spp[np.minimum(geo_probe.coeff_idx, NB)]
        idx_plane[geo_probe.coeff_idx >= NB] = NB
        idx_plane_j = jnp.asarray(idx_plane)
        cls_rows = jnp.asarray(geo_probe.block_cls)
        band_image = layout.band_image

        # band geometry tensors are jit ARGUMENTS (replicated across the
        # mesh), not closed-over constants: embedded-constant lowering
        # costs minutes at scale, and the runtime-arg form keeps the
        # quant divide numerically identical to the single-chip
        # encoder's (XLA strength-reduces divides by embedded constants,
        # which changes float rounding and breaks byte-identity)
        valid_rows = jnp.asarray(geo_probe.block_valid)
        dcd_rows = jnp.asarray(geo_probe.dc_dist)
        from ..ops.entropy_v2 import encode_rows_arrays
        geo_args = (idx_plane_j, cls_rows, valid_rows, dcd_rows, qdiv)

        def make_fn(geo_t):
            def encode_band(raw_band, rst, has_rst, idxp, clsr, validr,
                            dcdr, qd):
                planes = preprocess(raw_band, band_image, plan, jnp)
                planes = jax.lax.optimization_barrier(tuple(planes))
                pblocks = jnp.concatenate(
                    [plane_to_blocks(p, jnp) for p in planes])
                pblocks = jnp.concatenate(
                    [pblocks, jnp.zeros((1, 64), pblocks.dtype)])
                rows = fdct_quant_rows(pblocks[idxp], d_hi, d_lo, qd[clsr])
                return encode_rows_arrays(
                    rows, clsr, validr, dcdr, rst, has_rst,
                    geo_t.dc_distances, geo_t.bps, geo_t.cap_seg_words,
                    geo_t.cap_out_bytes, geo_t.words_per_block, tabs,
                    geo_t.max_stuff)

            def local_fn(raw, rst, has_rst, idxp, clsr, validr, dcdr, qd):
                # raw: (B_local, 1, band_bytes); rst/has: (1, S_local)
                out, out_len, seg_bits, n_ff = jax.vmap(
                    lambda r: encode_band(r, rst[0], has_rst[0], idxp,
                                          clsr, validr, dcdr, qd))(raw[:, 0])
                return (out[:, None], out_len[:, None],
                        seg_bits[:, None], n_ff[:, None])

            fspec = "frame" if "frame" in self.mesh.axis_names else None
            jfn = jax.jit(_shard_map(
                local_fn, mesh=self.mesh,
                in_specs=(P(fspec, "seg", None), P("seg", None),
                          P("seg", None), P(None), P(None), P(None),
                          P(None), P(None, None)),
                out_specs=(P(fspec, "seg", None), P(fspec, "seg", None),
                           P(fspec, "seg", None), P(fspec, "seg", None)),
                # the entropy stage's loop carries mix replicated geometry
                # with per-band data
                check_vma=False,
            ))
            return lambda bands, rst, has: jfn(bands, rst, has, *geo_args)

        built = _ShardedBuild(
            layout=layout, quant_zz=quant_zz, huff=huff,
            rst_np=rst_np, has_np=has_np, plan=plan,
            geo1=build_uniform_geometry(
                plan, cap_bytes_per_block=block_byte_budget(params.quality),
                seg_byte_budget=min(budget, geo_probe.cap_seg_words * 4)),
            geo2=None, make_fn=make_fn)
        built.fn1 = make_fn(built.geo1)
        self._cache[key] = built
        return built

    # ------------------------------------------------------------------
    def encode(self, raw, params: Parameters, image: ImageParameters) -> bytes:
        """Encode one frame sharded across the 'seg' axis."""
        return self.encode_batch([raw], params, image)[0]

    def encode_batch(self, raws, params: Parameters,
                     image: ImageParameters) -> list[bytes]:
        """Encode a batch of same-geometry frames: frames sharded over the
        'frame' axis, each frame's bands over the 'seg' axis. Tier-1
        typical-content capacity overflow reruns on the tier-2 worst-case
        geometry; pathological content beyond that falls back to the host
        golden coder per frame (mirrors encode_segments_device's loop)."""
        b = self._build(params, image)
        layout = b.layout
        B = len(raws)
        # pad the batch to a multiple of the frame axis
        Bp = -(-B // self.n_frame) * self.n_frame
        bands = np.stack([
            split_raw_bands(raws[min(i, B - 1)], image, layout)
            for i in range(Bp)
        ])  # (Bp, n_bands, band_bytes)
        fspec = "frame" if "frame" in self.mesh.axis_names else None
        # each band goes straight from the host to its own device
        bands_j = jax.device_put(
            bands, NamedSharding(self.mesh, P(fspec, "seg", None)))
        rst_j, has_j = jnp.asarray(b.rst_np), jnp.asarray(b.has_np)

        for tier in (1, 2):
            geo, fn = (b.geo1, b.fn1) if tier == 1 else b.tier2()
            # bench hook (mirrors Decoder.capture_device_call): the
            # compiled sharded jit + this batch's device args, so perf
            # scripts can time device-only iterations
            self.last_device_call = (fn, (bands_j, rst_j, has_j))
            out, out_len, seg_bits, n_ff = fn(bands_j, rst_j, has_j)
            len_h = np.asarray(jax.device_get(out_len))
            bits_h = np.asarray(jax.device_get(seg_bits))
            nff_h = np.asarray(jax.device_get(n_ff))
            stuffed = ((bits_h + 7) >> 3) + nff_h
            overflow = (bits_h > geo.cap_seg_words * 4 * 8).any() or \
                (stuffed + 2 > geo.cap_out_bytes).any() or \
                (nff_h > geo.max_stuff).any()
            if not overflow:
                out_h = np.asarray(jax.device_get(out))
                return [self._assemble(layout, b.quant_zz, b.huff,
                                       out_h[f], len_h[f], params, image)
                        for f in range(B)]

        # beyond worst-case caps: host golden coder (last resort)
        from ..models.encoder import Encoder
        enc = Encoder(backend="golden")
        return [enc.encode(np.asarray(r), params, image) for r in raws]

    # ------------------------------------------------------------------
    def _assemble(self, layout: BandLayout, quant_zz, huff,
                  out_f: np.ndarray, len_f: np.ndarray,
                  params: Parameters, image: ImageParameters) -> bytes:
        """Host-side stream formatting: concatenate per-band segment bytes in
        global scan order (reference: gpujpeg_encoder.c:479-537)."""
        plan = layout.plan
        n, S = layout.n_bands, plan.n_segments
        cap = out_f.shape[-1] // S
        regions = out_f.reshape(n * S, cap)
        lens = len_f.reshape(n * S)

        # full-image plan for the header (correct total height)
        full_plan = make_plan(params, image)
        w = JpegWriter()
        w.write_header(full_plan, quant_zz, huff, HeaderType.DEFAULT)
        for scan in plan.scans:
            local_ids = np.nonzero(plan.seg_scan == scan.index)[0]
            order = (np.arange(n)[:, None] * S + local_ids[None, :]).reshape(-1)
            slens = lens[order]
            starts = np.concatenate([[0], np.cumsum(slens)])
            total = int(starts[-1])
            seg_of_byte = np.repeat(np.arange(order.size), slens)
            off_of_byte = np.arange(total) - np.repeat(starts[:-1], slens)
            body = regions[order[seg_of_byte], off_of_byte]
            w.write_scan_header(full_plan, scan.index)
            w.emit_bytes(body)
            w.patch_segment_info(starts)
        w.write_eoi()
        return w.tobytes()
