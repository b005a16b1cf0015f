"""Device pipeline orchestration.

Builds and caches jitted end-to-end compute functions per coder plan:

* encode: raw pixels -> preprocess -> DCT+quant (float32 product at
  HIGHEST precision) -> segment-parallel Huffman (ops/entropy_v2.py) ->
  per-segment bytes (one device round trip for lengths + one compaction
  gather — mirroring the reference's single output-size sync,
  gpujpeg_huffman_gpu_encoder.cu:1158).
* decode: entropy bytes -> segment-parallel Huffman on the platform's
  route (the GPU kernel of ops/huffman_kernel.py, or the XLA lockstep
  decoder of ops/huffman_decode.py on the CPU) -> dequant+IDCT product ->
  postprocess -> raw pixels.

The route of each stage is fixed per platform (runtime.ROUTES) when an
encoder context or a decoder is built. A device failure raises; the only
host routes are the documented capacity and format decisions (tier-2
overflow on encode, restart-interval 0, too few segments on decode),
each counted on the encoder's or decoder's stats.

Everything inside the jit boundary has static shapes derived from the
plan; variable-length byte buffers are bucketed so a video stream of
same-geometry frames reuses one compiled executable.
"""
from __future__ import annotations

import hashlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import CoderPlan
from ..params import ImageParameters
from ..runtime import device_routes
from .blocks import blocks_to_plane, plane_to_blocks
from .dct import (
    dequant_idct_device, fdct_quant_rows, fdct_split_operator,
    idct_split_operator)
from .huffman_encode import compact_segments
from .preprocess import postprocess, preprocess


def _bucket(n: int, minimum: int = 4096) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

_ENC_CACHE: dict = {}


class _EncContext:
    """Device encoder (v2 entropy): preprocess -> DCT+quant over the
    segment-uniform row layout -> dense entropy encode. See
    ops/entropy_v2.py for the design rationale."""

    def __init__(self, plan: CoderPlan, quant_zz: dict, huff: dict):
        from .entropy_v2 import (
            block_byte_budget, build_packed_tables, build_uniform_geometry,
            seg_budget_for_quality)

        #: stage routes; raises on a platform without one
        self.routes = device_routes()
        self.plan = plan
        self._quant_zz = quant_zz
        self._tabs = build_packed_tables(huff)
        # tier 1: typical-content segment budget; tier 2 (lazy): worst case
        geo_probe = build_uniform_geometry(plan)
        budget = seg_budget_for_quality(plan.params.quality, geo_probe.bps)
        geo = build_uniform_geometry(
            plan, cap_bytes_per_block=block_byte_budget(plan.params.quality),
            seg_byte_budget=min(budget, geo_probe.cap_seg_words * 4))
        self.geo = geo
        self.cap_seg_bytes = geo.cap_seg_words * 4
        self.cap_out_bytes = geo.cap_out_bytes
        self.n_pad_segments = geo.n_segments
        self.fn = self._build_fn(geo)
        self._tier2: "_EncContext | None" = None

    def tier2(self) -> "_EncContext":
        """Worst-case-capacity context, built lazily on tier-1 overflow."""
        if self._tier2 is None:
            from .entropy_v2 import build_uniform_geometry
            ctx = object.__new__(_EncContext)
            ctx.routes = self.routes
            ctx.plan = self.plan
            ctx._quant_zz = self._quant_zz
            ctx._tabs = self._tabs
            ctx.geo = build_uniform_geometry(self.plan)
            ctx.cap_seg_bytes = ctx.geo.cap_seg_words * 4
            ctx.cap_out_bytes = ctx.geo.cap_out_bytes
            ctx.n_pad_segments = ctx.geo.n_segments
            ctx.fn = ctx._build_fn(ctx.geo)
            ctx._tier2 = ctx
            self._tier2 = ctx
        return self._tier2

    def batched_fn(self):
        """jit(vmap(fn)): B same-geometry frames in ONE device launch —
        the leading-batch-dim form of the reference's per-stream frame
        pipelining (SURVEY §2.2 row 5). Amortizes per-launch dispatch,
        which dominates at HD sizes. Bit-identical per frame to fn."""
        if getattr(self, "_batched", None) is None:
            self._batched = jax.jit(jax.vmap(self.fn))
        return self._batched

    #: rows-per-chunk target for the lax.map-chunked encode of very large
    #: plans (16K plans otherwise materialize ~18 GB of (n_rows, .) f32/u32
    #: intermediates at once)
    CHUNK_ROWS = 1 << 20

    def _build_fn(self, geo):
        from .entropy_v2 import encode_rows_arrays

        plan = self.plan
        quant_zz = self._quant_zz
        tabs = self._tabs

        d_hi, d_lo = (jnp.asarray(a) for a in fdct_split_operator())
        n_qt = max(c.quant_table_index for c in plan.components) + 1
        n_q = max(n_qt, 2)
        qdiv_h = np.ones((n_q, 64), np.float32)
        for qi in range(n_q):
            if qi in quant_zz:
                qdiv_h[qi] = np.maximum(np.asarray(quant_zz[qi], np.float32),
                                        1.0)
        qdiv = jnp.asarray(qdiv_h)

        # uniform rows gather straight from plane-order blocks
        NB = plan.n_blocks
        spp = np.append(plan.block_plane_idx, plan.n_blocks)  # scan -> plane
        idx_plane = spp[np.minimum(geo.coeff_idx, NB)]
        idx_plane[geo.coeff_idx >= NB] = plan.n_blocks        # dummy row
        idx_plane_j = jnp.asarray(idx_plane)
        cls_rows = jnp.asarray(geo.block_cls)
        # Non-interleaved plans with segment counts that divide evenly have
        # plane order == uniform-row order; skip the (n_rows, 64) row
        # gather there (XLA cannot see it is the identity).
        identity_gather = bool(
            np.array_equal(idx_plane, np.arange(geo.n_rows, dtype=np.int64)))

        S = geo.n_segments

        def stage_pre(raw):
            planes = preprocess(raw, plan.image, plan, jnp)
            # keep XLA from fusing the pixel chain into the 8x8 blockify
            # transpose
            planes = jax.lax.optimization_barrier(tuple(planes))
            return jnp.concatenate([plane_to_blocks(p, jnp) for p in planes])

        # geometry tensors AND quant divisors are jit ARGUMENTS (see the
        # fn_chunked note; quantization divides by embedded constants get
        # strength-reduced by XLA, changing float rounding and breaking
        # byte-identity — CLAUDE.md invariant): the staged fns receive
        # them per call from the arrays held here. The sharded encoder
        # runs the same (N, 64) @ (64, 64) product per band, so both
        # round identically.
        dct_args = ((cls_rows, qdiv) if identity_gather else
                    (idx_plane_j, cls_rows, qdiv))
        ent_args = (jnp.asarray(geo.block_cls), jnp.asarray(geo.block_valid),
                    jnp.asarray(geo.dc_dist), jnp.asarray(geo.seg_rst_marker),
                    jnp.asarray(geo.seg_has_rst))

        def stage_dct(pblocks, *args):
            if identity_gather:
                cls_r, qd = args
                x = pblocks                                  # (n_rows, 64)
            else:
                idx_j, cls_r, qd = args
                pblocks = jnp.concatenate(
                    [pblocks, jnp.zeros((1, 64), pblocks.dtype)])
                x = pblocks[idx_j]
            return fdct_quant_rows(x, d_hi, d_lo, qd[cls_r])

        def stage_entropy(rows, cls, valid, dcd, rst, hrst):
            return encode_rows_arrays(
                rows, cls, valid, dcd, rst, hrst, geo.dc_distances,
                geo.bps, geo.cap_seg_words, geo.cap_out_bytes,
                geo.words_per_block, tabs, geo.max_stuff)

        # per-stage jits for perf_stats mode (the reference records its
        # CUDA-event phase timers only when param.perf_stats is set,
        # gpujpeg_common_internal.h:71-120); the staged run is the real
        # pipeline split at stage boundaries
        self._stage_fns = (jax.jit(stage_pre), jax.jit(stage_dct),
                           jax.jit(stage_entropy))
        self._stage_args = (dct_args, ent_args)

        # Very large plans: the staged formulation materializes ~18 GB of
        # (n_rows, .) intermediates at 16K, so the DCT+entropy stages run
        # chunked over segment ranges with lax.map. Safe at segment
        # granularity: DC prediction resets at every segment start
        # (plan.py: dc_pred = -1 at idx % ri == 0).
        if geo.n_rows > 2 * self.CHUNK_ROWS and S > 1:
            segs_per_chunk = max(1, self.CHUNK_ROWS // geo.bps)
            n_chunks = -(-S // segs_per_chunk)
            S_pad = n_chunks * segs_per_chunk
            rpad = (S_pad - S) * geo.bps
            CR = segs_per_chunk * geo.bps
            idx_p = np.pad(idx_plane, (0, rpad),
                           constant_values=plan.n_blocks)
            chunks = (
                jnp.asarray(idx_p.reshape(n_chunks, CR)),
                jnp.asarray(np.pad(geo.block_cls, (0, rpad))
                            .reshape(n_chunks, CR)),
                jnp.asarray(np.pad(geo.block_valid, (0, rpad))
                            .reshape(n_chunks, CR)),
                jnp.asarray(np.pad(geo.dc_dist, (0, rpad))
                            .reshape(n_chunks, CR)),
                jnp.asarray(np.pad(geo.seg_rst_marker, (0, S_pad - S))
                            .reshape(n_chunks, segs_per_chunk)),
                jnp.asarray(np.pad(geo.seg_has_rst, (0, S_pad - S))
                            .reshape(n_chunks, segs_per_chunk)),
            )
            distances = geo.dc_distances
            bps, csw = geo.bps, geo.cap_seg_words
            cob, W = geo.cap_out_bytes, geo.words_per_block
            mstuff = geo.max_stuff

            # geometry tensors (and the quant divisors) are jit
            # ARGUMENTS, not closed-over constants: constants serialize
            # into the lowered module and cost minutes of host-side
            # lowering at 8K+
            @jax.jit
            def fn_chunked(raw, chunks, qdiv_a):
                planes = preprocess(raw, plan.image, plan, jnp)
                planes = jax.lax.optimization_barrier(tuple(planes))
                pblocks = jnp.concatenate(
                    [plane_to_blocks(p, jnp) for p in planes])

                def tail(x, clsc, valc, dcdc, rstc, hrstc):
                    rows = fdct_quant_rows(x, d_hi, d_lo, qdiv_a[clsc])
                    return encode_rows_arrays(
                        rows, clsc, valc, dcdc, rstc, hrstc, distances,
                        bps, csw, cob, W, tabs, mstuff)

                if identity_gather:
                    pb = jnp.concatenate(
                        [pblocks, jnp.zeros((rpad, 64), pblocks.dtype)])
                    xs = (pb.reshape(n_chunks, CR, 64),) + tuple(chunks[1:])

                    def body(c):
                        pbc, clsc, valc, dcdc, rstc, hrstc = c
                        return tail(pbc, clsc, valc, dcdc, rstc, hrstc)
                else:
                    pb = jnp.concatenate(
                        [pblocks, jnp.zeros((1, 64), pblocks.dtype)])
                    xs = tuple(chunks)

                    def body(c):
                        idxc, clsc, valc, dcdc, rstc, hrstc = c
                        return tail(pb[idxc], clsc, valc, dcdc, rstc,
                                    hrstc)

                out, out_len, seg_bits, n_ff = jax.lax.map(body, xs)
                return (out.reshape(-1), out_len.reshape(-1),
                        seg_bits.reshape(-1), n_ff.reshape(-1))

            self._stage_fns = None      # no staged timing for huge plans
            self._fn_args = (chunks, qdiv)
            wrapped = lambda raw: fn_chunked(raw, *self._fn_args)
            wrapped.kind = "chunked"
            return wrapped

        @jax.jit
        def fn(raw, dct_args, ent_args):
            return stage_entropy(stage_dct(stage_pre(raw), *dct_args),
                                 *ent_args)

        self._fn_args = (dct_args, ent_args)
        wrapped = lambda raw: fn(raw, *self._fn_args)
        wrapped.kind = "staged"
        return wrapped


def _enc_context(plan: CoderPlan, quant_zz, huff) -> _EncContext:
    key = (plan.params, plan.image)
    ctx = _ENC_CACHE.get(key)
    if ctx is None:
        ctx = _EncContext(plan, quant_zz, huff)
        _ENC_CACHE[key] = ctx
    return ctx


def _run_staged(encoder, ctx, raw_j):
    """perf_stats execution: the pipeline split at stage boundaries with
    a sync after each, filling the reference's per-phase durations
    (struct gpujpeg_duration_stats, gpujpeg_common.h:315-325)."""
    s_pre, s_dct, s_ent = ctx._stage_fns
    dct_args, ent_args = ctx._stage_args
    t0 = time.perf_counter()
    pblocks = jax.block_until_ready(s_pre(raw_j))
    t1 = time.perf_counter()
    rows = jax.block_until_ready(s_dct(pblocks, *dct_args))
    t2 = time.perf_counter()
    out = jax.block_until_ready(s_ent(rows, *ent_args))
    t3 = time.perf_counter()
    encoder.stats.duration_preprocessor = (t1 - t0) * 1e3
    encoder.stats.duration_dct_quantization = (t2 - t1) * 1e3
    encoder.stats.duration_huffman_coder = (t3 - t2) * 1e3
    return out


def _raw_to_device(raw):
    if isinstance(raw, jax.Array):
        # device-resident input: the analog of the reference's
        # GPUJPEG_ENCODER_INPUT_GPU_IMAGE / OpenGL-texture paths
        # (gpujpeg_encoder.c:353-395) — no host round trip
        return raw.reshape(-1).astype(jnp.uint8)
    return jnp.asarray(np.asarray(raw, dtype=np.uint8).reshape(-1))


def encode_segments_device(encoder, raw, plan: CoderPlan, quant_zz, huff):
    """Run the device encoder; returns (scan_bodies, seg_sizes_by_scan):
    per scan, the ready-to-emit entropy bytes (RST markers included) and
    the per-segment byte sizes (for APP13 segment-info back-patching).
    Returns None when a segment overflows even the worst-case tier-2
    capacities: the caller then codes the frame on the host."""
    ctx = _enc_context(plan, quant_zz, huff)
    perf_stats = bool(getattr(plan.params, "perf_stats", False))
    t_h2d = time.perf_counter()
    raw_j = _raw_to_device(raw)
    if perf_stats:
        jax.block_until_ready(raw_j)   # upload excluded from in_gpu
        encoder.stats.duration_memory_to = \
            (time.perf_counter() - t_h2d) * 1e3
    t0 = time.perf_counter()
    for tier in (1, 2):
        if perf_stats and ctx._stage_fns:
            out_flat, out_len, seg_bits, n_ff = _run_staged(
                encoder, ctx, raw_j)
        else:
            out_flat, out_len, seg_bits, n_ff = jax.block_until_ready(
                ctx.fn(raw_j))
        out_len_h = np.asarray(out_len)
        if not _seg_overflow(ctx, plan, out_len_h, seg_bits, n_ff):
            break
        if tier == 1:
            ctx = ctx.tier2()   # busier content than the typical budget
        else:
            return None         # beyond worst-case caps: host coder
    encoder.stats.duration_in_gpu = (time.perf_counter() - t0) * 1e3
    t_d2h = time.perf_counter()
    bodies = _split_scan_bodies(plan, ctx, out_flat, out_len_h)
    if perf_stats:
        # compaction gather + D2H of the compressed bytes (the gather is
        # tiny device work; the transfer dominates)
        encoder.stats.duration_memory_from = \
            (time.perf_counter() - t_d2h) * 1e3
    return bodies


def _split_scan_bodies(plan: CoderPlan, ctx, out_flat, out_len_h):
    flat, starts = compact_segments(out_flat, out_len_h, ctx.cap_out_bytes)
    scan_bodies = []
    seg_sizes_by_scan = []
    seg = 0
    for scan in plan.scans:
        n = scan.segment_count
        body = flat[starts[seg]:starts[seg + n]]
        sizes = out_len_h[seg:seg + n]
        scan_bodies.append(body.tobytes())
        seg_sizes_by_scan.append(sizes)
        seg += n
    return scan_bodies, seg_sizes_by_scan


def _seg_overflow(ctx, plan: CoderPlan, out_len_h, seg_bits, n_ff):
    seg_bits_h = np.asarray(seg_bits)[:plan.n_segments]
    n_ff_h = np.asarray(n_ff)[:plan.n_segments]
    stuffed = ((seg_bits_h + 7) >> 3) + n_ff_h
    return bool((seg_bits_h > ctx.cap_seg_bytes * 8).any() or
                (stuffed + 2 > ctx.cap_out_bytes).any() or
                (n_ff_h > ctx.geo.max_stuff).any())


def _batch_frames_auto(raw_bytes: int) -> int:
    """Frames fused per launch: GPUJPEG_BATCH_FRAMES, or sized so a
    chunk's device footprint (~4x raw per frame across planes/windows/
    out) stays around 512 MB — HD gets 8 frames/launch, 4K ~5, 8K+ 1
    (the pipelined per-frame path)."""
    env = os.environ.get("GPUJPEG_BATCH_FRAMES")
    if env:
        return max(1, int(env))
    return int(max(1, min(8, (512 << 20) // max(4 * raw_bytes, 1))))


def encode_batch_device(encoder, raws, plan: CoderPlan, quant_zz, huff,
                        depth: int = 3):
    """Pipelined batch encode: same-geometry frames are fused B-at-a-time
    into one vmapped device launch (leading batch dim — the form of the
    reference's per-stream frame parallelism, gpujpeg_encoder.h:106),
    and up to ``depth`` launches are queued ahead so each chunk's D2H +
    host compaction/stream formatting overlap later chunks' device
    compute (the encode mirror of Decoder.decode_batch). Yields one
    encode_segments_device-shaped result per frame — or None for frames
    that must take the host coder. A frame whose segments overflow the
    tier-1 capacities re-runs synchronously through
    encode_segments_device's tier chain."""
    ctx = _enc_context(plan, quant_zz, huff)
    n = len(raws)
    if not n:
        return
    B = min(_batch_frames_auto(int(np.asarray(raws[0]).size)), n)

    def launch(chunk):
        if B == 1:
            return ctx.fn(_raw_to_device(chunk[0]))
        arrs = [_raw_to_device(r) for r in chunk]
        if len(arrs) < B:   # pad the tail chunk; outputs are dropped
            arrs += [arrs[-1]] * (B - len(arrs))
        return ctx.batched_fn()(jnp.stack(arrs))

    chunks = [raws[i:i + B] for i in range(0, n, B)]
    pending: list = []
    ci = 0
    while ci < len(chunks) or pending:
        while ci < len(chunks) and len(pending) < depth:
            pending.append((chunks[ci], launch(chunks[ci])))
            ci += 1
        chunk, res = pending.pop(0)
        out_flat, out_len, seg_bits, n_ff = res
        for b, raw in enumerate(chunk):
            if B > 1:
                fo, fl = out_flat[b], out_len[b]
                fb, fn_ = seg_bits[b], n_ff[b]
            else:
                fo, fl, fb, fn_ = out_flat, out_len, seg_bits, n_ff
            out_len_h = np.asarray(fl)   # blocks on this chunk
            if not _seg_overflow(ctx, plan, out_len_h, fb, fn_):
                yield _split_scan_bodies(plan, ctx, fo, out_len_h)
            else:
                yield encode_segments_device(encoder, raw, plan, quant_zz,
                                             huff)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

_DEC_CACHE: dict = {}

#: sentinel returned by decode_device in fused-batch collect mode (the
#: prep was appended to decoder._fuse_collect; no launch happened)
_FUSE_PENDING = object()


def _kernel_inputs(plan, scan_data, segments_by_scan, dc_by_comp,
                   ac_by_comp):
    """Huffman-stage inputs of the kernel route: the transposed
    destuffed word rows per frame; segment layout and tables as
    stream-family constants."""
    from .huffman_kernel import (
        SEG_TILE, build_segment_rows_t, segment_layout, segment_ranges_wcap,
        table_slots)
    tabs, dc_slot, ac_slot = table_slots(plan, dc_by_comp, ac_by_comp)
    concat, lo, hi, wcap = segment_ranges_wcap(scan_data, segments_by_scan,
                                               plan)
    s_pad = -(-plan.n_segments // SEG_TILE) * SEG_TILE
    seg_comp, seg_nblk, tpl = segment_layout(plan, s_pad)
    frame = (build_segment_rows_t(concat, lo, hi, plan, wcap, s_pad),)
    consts = (seg_comp, seg_nblk, tpl, tabs.quick, tabs.maxcode, tabs.delta,
              tabs.huffval, dc_slot, ac_slot)
    return (wcap, s_pad, tabs.quick.shape[0]), frame, consts


def _xla_inputs(plan, scan_data, segments_by_scan, dc_by_comp, ac_by_comp):
    """Huffman-stage inputs of the XLA route: the concatenated stuffed
    scan bytes (bucketed length) and segment starts per frame; the 16-bit
    lookahead tables and block geometry as constants."""
    from .huffman_decode import build_dec_tables
    scan_base = []
    base = 0
    for sd in scan_data:
        scan_base.append(base)
        base += int(sd.size)
    concat = (np.concatenate([np.asarray(s, np.uint8) for s in scan_data])
              if base else np.zeros(1, np.uint8))
    seg_starts = np.zeros(plan.n_segments, np.int32)
    for s in range(plan.n_segments):
        scan_id = int(plan.seg_scan[s])
        seg_idx = int(plan.seg_scan_index[s])
        seg_list = segments_by_scan[scan_id]
        if seg_idx < len(seg_list):
            seg_starts[s] = scan_base[scan_id] + seg_list[seg_idx][0]
    data = np.zeros(_bucket(concat.size), np.uint8)
    data[:concat.size] = concat
    luts, dc_tab, ac_tab = build_dec_tables(dc_by_comp, ac_by_comp)
    consts = (luts, dc_tab, ac_tab, np.asarray(plan.block_comp, np.int32),
              np.asarray(plan.seg_block_start, np.int32),
              np.asarray(plan.seg_block_count, np.int32))
    return (data.size, luts.shape[0]), (data, seg_starts), consts


_INPUTS = {"kernel": _kernel_inputs, "xla": _xla_inputs}


def _huffman_stage(plan: CoderPlan, route: str, interpret: bool):
    """(huff(frame, consts, out_row) -> (n_blocks, 64) scan-order
    coefficients, out_row map or None when the kernel's segment-major
    rows already are scan order)."""
    nb = plan.n_blocks
    if route == "xla":
        from .huffman_decode import build_dec_geometry, huffman_decode_kernel
        max_iters = build_dec_geometry(plan).max_iters

        def huff(frame, consts, out_row):
            data, seg_starts = frame
            luts, dc_tab, ac_tab, bc, sbs, sbc = consts
            g = {"block_comp": bc, "seg_block_start": sbs,
                 "seg_block_count": sbc}
            return huffman_decode_kernel(data, seg_starts, g, luts, dc_tab,
                                         ac_tab, nb, max_iters)
        return huff, None

    from .huffman_kernel import decode_rows
    bps = int(plan.max_seg_block_count)
    interleaved = bool(plan.params.interleaved and plan.image.comp_count > 1)
    slot = np.arange(nb, dtype=np.int64) - \
        plan.seg_block_start[plan.block_segment]
    out_row = (plan.block_segment.astype(np.int64) * bps + slot)
    identity = bool(np.array_equal(out_row, np.arange(nb)))

    def huff(frame, consts, out_row_a):
        flat = decode_rows(*frame, *consts, bps=bps, interleaved=interleaved,
                           interpret=interpret)
        return flat[:nb] if identity else flat[out_row_a]
    return huff, (None if identity else out_row.astype(np.int32))


def _dec_fn(plan: CoderPlan, out_image: ImageParameters, route: str,
            key_extra: tuple, interpret: bool):
    key = (plan.params, plan.image, out_image, route, key_extra, interpret)
    fn = _DEC_CACHE.get(key)
    if fn is not None:
        return fn

    huff, out_row = _huffman_stage(plan, route, interpret)
    inv = np.empty(plan.n_blocks, dtype=np.int32)
    inv[plan.block_plane_idx] = np.arange(plan.n_blocks, dtype=np.int32)
    inv_identity = bool(np.array_equal(inv, np.arange(plan.n_blocks)))
    # reorder maps are jit ARGUMENTS (closed-over million-element
    # constants serialize into the lowered module and dominate the first
    # call at 8K)
    reorders = (jnp.asarray(out_row if out_row is not None
                            else np.zeros(1, np.int32)),
                jnp.asarray(inv if not inv_identity
                            else np.zeros(1, np.int32)))
    comp_slices = []
    pos = 0
    for c in plan.components:
        comp_slices.append((pos, c.block_count, c.data_height, c.data_width))
        pos += c.block_count

    def stage_huffman(frame, consts, out_row_a, inv_a):
        coeff_scan = huff(frame, consts, out_row_a)
        return coeff_scan if inv_identity else coeff_scan[inv_a]

    d_hi, d_lo = (jnp.asarray(a) for a in idct_split_operator())

    def stage_idct(coeff_plane, Ws):
        planes = []
        for (start, count, dh, dw), q in zip(comp_slices, Ws):
            blocks = dequant_idct_device(coeff_plane[start:start + count], q,
                                         d_hi, d_lo)
            planes.append(blocks_to_plane(blocks, dh, dw, jnp))
        # keep XLA from fusing the 8x8 un-blockify transpose into the
        # pixel chain
        return list(jax.lax.optimization_barrier(tuple(planes)))

    def stage_post(planes):
        return postprocess(planes, out_image, plan, jnp)

    @jax.jit
    def fn_j(frame, consts, Ws, reorders):
        return stage_post(stage_idct(
            stage_huffman(frame, consts, *reorders), Ws))

    def fn(frame, consts, Ws):
        return fn_j(frame, consts, Ws, reorders)

    s_huff = jax.jit(stage_huffman)
    # per-stage jits for perf_stats mode: the reference reports
    # huffman/idct/postprocess splits (gpujpeg_common.h:315-325)
    fn.stages = (lambda frame, consts: s_huff(frame, consts, *reorders),
                 jax.jit(stage_idct), jax.jit(stage_post))
    # fused-batch form: B same-geometry frames in one launch (frame
    # arrays batched; constants broadcast) — see Decoder.decode_batch
    fn.batched = jax.jit(jax.vmap(fn_j, in_axes=(0, None, None, None)))
    fn.reorders = reorders
    fn.key = key
    _DEC_CACHE[key] = fn
    return fn


def decode_device(decoder, plan: CoderPlan, info, scan_data,
                  segments_by_scan, dc_by_comp, ac_by_comp,
                  out_image: ImageParameters):
    """Decode one frame on the device route chosen when ``decoder`` was
    built. Returns the raw image (host array, or a device array with
    ``decoder.output_to_device``/``_defer_sync``), or ``_FUSE_PENDING``
    in fused-batch collect mode."""
    route = decoder.routes["huffman_decode"]
    key_extra, frame, consts = _INPUTS[route](
        plan, scan_data, segments_by_scan, dc_by_comp, ac_by_comp)
    fn = _dec_fn(plan, out_image, route, key_extra,
                 decoder._kernel_interpret)
    const_key = hashlib.sha1(b"".join(
        np.ascontiguousarray(a).tobytes() for a in consts)).digest()
    qts = tuple(
        tuple(int(x) for x in info.quant_tables[
            info.components[c.index].quant_table_index])
        for c in plan.components)

    # device copies of the per-component quant steps (runtime values)
    ws_cached = getattr(decoder, "_dev_ws_cache", None)
    if ws_cached is None or ws_cached[0] != qts:
        Ws = tuple(jnp.asarray(np.asarray(k, np.float32)) for k in qts)
        decoder._dev_ws_cache = (qts, Ws)
    else:
        Ws = ws_cached[1]

    fuse = getattr(decoder, "_fuse_collect", None)
    if fuse is not None:
        # fused batch decode (Decoder.decode_batch): hand the host-side
        # prep to the caller, which stacks same-geometry frames into ONE
        # vmapped launch (shared constants ride once)
        fuse.append({"fn": fn, "frame": frame, "consts": consts, "Ws": Ws,
                     "key": fn.key, "const_key": const_key, "qts": qts})
        return _FUSE_PENDING

    t_h2d = time.perf_counter()
    # per-call device uploads are the per-frame DATA only: the tables and
    # segment maps are stream-family constants, so their device copies
    # are cached on the decoder (the reference's analog uploads tables
    # once at init, gpujpeg_table.c)
    cached = getattr(decoder, "_dev_const_cache", None)
    const_fresh = cached is None or cached[0] != (fn.key, const_key)
    if const_fresh:
        const_dev = tuple(jnp.asarray(a) for a in consts)
        decoder._dev_const_cache = ((fn.key, const_key), const_dev)
    else:
        const_dev = cached[1]
    frame_dev = tuple(jnp.asarray(a) for a in frame)
    if getattr(decoder, "capture_device_call", False):
        # first-class bench hook (Decoder.capture_device_call): the
        # compiled device fn + this stream's device-resident args, so
        # benchmarks can time device-only iterations
        decoder.last_device_call = (fn, (frame_dev, const_dev, Ws))
    # bytes actually transferred this call: the cached stream-family
    # constants cost nothing after their first upload
    decoder.stats.bytes_memory_to = int(
        sum(a.nbytes for a in frame_dev)
        + (sum(a.nbytes for a in const_dev) if const_fresh else 0))
    if decoder.perf_stats:
        jax.block_until_ready((frame_dev, const_dev))  # uploads excluded
        decoder.stats.duration_memory_to = \
            (time.perf_counter() - t_h2d) * 1e3

    t0 = time.perf_counter()
    if getattr(decoder, "_defer_sync", False):
        # pipelined batch decode (Decoder.decode_batch): launch only —
        # the caller syncs after queueing the following frames, so the
        # host parse/row-build of frame i+1 overlaps this frame's device
        # work via async dispatch (perf_stats staging would sync here
        # and serialize the pipeline, so it is bypassed)
        return fn(frame_dev, const_dev, Ws)
    if decoder.perf_stats:
        s_huff, s_idct, s_post = fn.stages
        coeff_plane = jax.block_until_ready(s_huff(frame_dev, const_dev))
        t1 = time.perf_counter()
        planes = jax.block_until_ready(s_idct(coeff_plane, Ws))
        t2 = time.perf_counter()
        raw = jax.block_until_ready(s_post(planes))
        t3 = time.perf_counter()
        decoder.stats.duration_huffman_coder = (t1 - t0) * 1e3
        decoder.stats.duration_dct_quantization = (t2 - t1) * 1e3
        decoder.stats.duration_postprocessor = (t3 - t2) * 1e3
    else:
        raw = jax.block_until_ready(fn(frame_dev, const_dev, Ws))
    decoder.stats.duration_in_gpu = (time.perf_counter() - t0) * 1e3
    if not getattr(decoder, "output_to_device", False):
        t_d2h = time.perf_counter()
        raw = np.asarray(raw)   # D2H (the reference's default output path)
        decoder.stats.duration_memory_from = \
            (time.perf_counter() - t_d2h) * 1e3
    return raw
