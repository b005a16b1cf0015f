"""Segment-parallel Huffman decode kernel for the GPU (Pallas, Triton route).

The GPU form of the reference's one-thread-per-segment decoder
(gpujpeg_huffman_gpu_decoder.cu:397-544): one lane per restart segment,
the whole symbol loop inside one kernel, segments tiled over the grid.

* **Stream**: each segment's destuffed bytes arrive as big-endian u32
  words in the transposed ``(Wcap, S_pad)`` layout (word ``w`` of every
  segment is one contiguous row), built on the host by
  :func:`build_segment_rows_t`. A lane keeps a three-word window in
  registers and loads the next word only when its bit offset crosses a
  word boundary, so the load is in flight a full word ahead of its use.
* **Symbols**: an 8-bit lookahead ("quick") table; longer codes take the
  canonical T.81 F.16 path through ``maxcode``/``delta``/``huffval`` as
  indexed loads, issued only for the lanes that need them.
* **Coefficients**: masked indexed stores into a zeroed, segment-major
  ``(S_pad * bps, 64)`` array (row ``seg * bps + block``).

Corrupt-stream behaviour matches the golden decoder
(ops/golden.py ``decode_block``): an invalid code consumes one bit as
symbol 0, a run past coefficient 63 ends the block without reading its
value bits, and reads past the segment see zero bits.

``ops/huffman_decode.py`` keeps the plain-XLA formulation; it is the CPU
route and the reference this kernel is tested against.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..tables import HuffmanTable

I32 = jnp.int32
U32 = jnp.uint32

#: lookahead bits of the quick table (the reference uses a 64K "full"
#: table, gpujpeg_huffman_gpu_decoder.cu:552-617; 256 entries per table
#: stay in L1 and most codes at photographic qualities are <= 8 bits)
QUICK_BITS = 8

#: segments per kernel program (one lane each)
SEG_TILE = 128


@dataclasses.dataclass(frozen=True)
class DecTables:
    """Decode tables of up to 4 unique Huffman tables ("slots")."""

    quick: np.ndarray     # (n_slots, 256) int32: sym<<5 | len (len 0 = slow)
    maxcode: np.ndarray   # (n_slots, 18) int32: code-length boundaries
    delta: np.ndarray     # (n_slots, 17) int32: valptr[l] - mincode[l]
    huffval: np.ndarray   # (n_slots, 256) int32


def build_dec_tables(tables: list[HuffmanTable]) -> DecTables:
    n = len(tables)
    quick = np.zeros((n, 1 << QUICK_BITS), np.int32)
    maxcode = np.zeros((n, 18), np.int32)
    delta = np.zeros((n, 17), np.int32)
    huffval = np.zeros((n, 256), np.int32)
    for t, tab in enumerate(tables):
        nv = min(len(tab.values), 256)
        huffval[t, :nv] = tab.values[:nv]
        # canonical code enumeration (T.81 C.2)
        code = 0
        k = 0
        mincode = np.zeros(17, np.int64)
        valptr = np.zeros(17, np.int64)
        for l in range(1, 17):
            valptr[l] = k
            mincode[l] = code
            nl = int(tab.bits[l - 1])
            for _ in range(nl):
                if l <= QUICK_BITS:
                    lo = code << (QUICK_BITS - l)
                    hi = (code + 1) << (QUICK_BITS - l)
                    quick[t, lo:hi] = (int(tab.values[k]) << 5) | l
                k += 1
                code += 1
            maxcode[t, l] = code << (16 - l)  # compare against 16-bit peek
            code <<= 1
        maxcode[t, 17] = 1 << 30              # terminator (gpujpeg_table.c:423)
        delta[t, :] = (valptr - mincode)[:17]
    return DecTables(quick, maxcode, delta, huffval)


def table_slots(plan, dc_by_comp, ac_by_comp):
    """Unique decode tables and the per-component DC/AC slot maps."""
    uniq: list = []

    def slot_of(t):
        for i, u in enumerate(uniq):
            if u is t:
                return i
        uniq.append(t)
        return len(uniq) - 1

    dc_slot = np.zeros(4, np.int32)
    ac_slot = np.zeros(4, np.int32)
    for c in plan.components:
        dc_slot[c.index] = slot_of(dc_by_comp[c.index])
        ac_slot[c.index] = slot_of(ac_by_comp[c.index])
    return build_dec_tables(uniq), dc_slot, ac_slot


def segment_layout(plan, s_pad: int):
    """Per-segment component ids, block counts and the per-slot
    component template of interleaved scans (-1 = per-segment id)."""
    bps = int(plan.max_seg_block_count)
    seg_comp = np.zeros(s_pad, np.int32)
    seg_nblk = np.zeros(s_pad, np.int32)
    seg_nblk[:plan.n_segments] = plan.seg_block_count
    interleaved = plan.params.interleaved and plan.image.comp_count > 1
    if interleaved:
        tpl = np.asarray([plan.block_comp[i] for i in range(bps)], np.int32)
    else:
        tpl = np.full(bps, -1, np.int32)
        seg_comp[:plan.n_segments] = plan.seg_scan  # scan == component
    return seg_comp, seg_nblk, tpl


# ---------------------------------------------------------------------------
# Host-side stream prep: destuffed per-segment word rows
# ---------------------------------------------------------------------------

def _segment_ranges(scan_data, segments_by_scan, plan):
    """Global (lo, hi) byte ranges of every plan segment in the
    concatenated scan data (vectorized; missing segments get -1)."""
    S = plan.n_segments
    scan_base = []
    base = 0
    for sd in scan_data:
        scan_base.append(base)
        base += int(np.asarray(sd).size)
    concat = (np.concatenate([np.asarray(s, np.uint8).reshape(-1)
                              for s in scan_data])
              if base else np.zeros(1, np.uint8))
    lo = np.full(S, -1, np.int64)
    hi = np.full(S, -1, np.int64)
    for scan_id, seg_list in enumerate(segments_by_scan):
        if len(seg_list) == 0:
            continue
        arr = np.asarray(seg_list, np.int64)            # (n, 2)
        sel = np.flatnonzero(plan.seg_scan == scan_id)
        n = min(sel.size, arr.shape[0])
        idx = plan.seg_scan_index[sel[:n]]
        valid = idx < arr.shape[0]
        lo[sel[:n][valid]] = scan_base[scan_id] + arr[idx[valid], 0]
        hi[sel[:n][valid]] = scan_base[scan_id] + arr[idx[valid], 1]
    return concat, lo, hi


def build_segment_rows_from_ranges(concat, lo, hi, S: int,
                                   Wcap: int) -> np.ndarray:
    """Destuffed (S, Wcap) big-endian word rows from segment ranges."""
    from ..native import lib as native_lib

    L = native_lib()
    if L is not None:
        rows = np.zeros((S, Wcap), np.uint32)
        L.gj_build_rows(np.ascontiguousarray(concat), concat.size,
                        np.ascontiguousarray(lo), np.ascontiguousarray(hi),
                        S, rows, Wcap)
        return rows

    # NumPy fallback
    rows8 = np.zeros((S, Wcap * 4), np.uint8)
    for s in range(S):
        if lo[s] < 0 or hi[s] <= lo[s]:
            continue
        d = concat[lo[s]:hi[s]]
        prev = np.concatenate([[0], d[:-1]])
        d = d[~((d == 0) & (prev == 0xFF))]
        rows8[s, :d.size] = d
    w = rows8.reshape(S, Wcap, 4).astype(np.uint32)
    words = (w[:, :, 0] << 24) | (w[:, :, 1] << 16) | \
        (w[:, :, 2] << 8) | w[:, :, 3]
    return words.astype(np.uint32)


def bucket_wcap(w: int) -> int:
    """Round a per-segment word capacity up to a ~1.25x geometric,
    8-word-aligned bucket. Wcap is content-dependent and keys the decode
    executable cache, so without buckets every video frame whose busiest
    segment grew would recompile. Zero words past a segment's stream
    are harmless to the decoder."""
    b = 8
    while b < w:
        b = -(-int(b * 1.25) // 8) * 8
    return b


def segment_ranges_wcap(scan_data, segments_by_scan, plan):
    """(concat bytes, lo, hi, Wcap) for the row builders."""
    S = plan.n_segments
    concat, lo, hi = _segment_ranges(scan_data, segments_by_scan, plan)
    max_raw = int(np.maximum(hi - lo, 1).max()) if S else 1
    return concat, lo, hi, bucket_wcap(-(-(max_raw + 4) // 4))


def build_segment_rows_t(concat, lo, hi, plan, Wcap: int,
                         s_pad: int) -> np.ndarray:
    """Destuffed words in the transposed (Wcap, S_pad) layout the kernel
    reads, as int32 (the same bits as the big-endian u32 words)."""
    from ..native import lib as native_lib
    L = native_lib()
    if L is None or not hasattr(L, "gj_build_rows_t"):
        rows = build_segment_rows_from_ranges(concat, lo, hi,
                                              plan.n_segments, Wcap)
        rows_pad = np.zeros((s_pad, Wcap), np.uint32)
        rows_pad[:plan.n_segments] = rows
        return np.ascontiguousarray(rows_pad.T).view(np.int32)
    # gj_build_rows_t fully writes the buffer (zero padding included)
    rowsT = np.empty((Wcap, s_pad), np.uint32)
    L.gj_build_rows_t(np.ascontiguousarray(concat), concat.size,
                      np.ascontiguousarray(lo), np.ascontiguousarray(hi),
                      plan.n_segments, rowsT, Wcap, s_pad)
    return rowsT.view(np.int32)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _kernel(data_ref, comp_ref, nblk_ref, tpl_ref, quick_ref, maxcode_ref,
            delta_ref, huffval_ref, dcslot_ref, acslot_ref, _zeros_ref,
            out_ref, *, tile: int, s_pad: int, wcap: int, bps: int,
            interleaved: bool):
    from jax.experimental.pallas import triton as plgpu
    from jax.experimental import pallas as pl

    seg = pl.program_id(0) * tile + jax.lax.iota(I32, tile)
    nblk = nblk_ref[seg]
    seg_comp = comp_ref[seg]
    dcs = [dcslot_ref[i] for i in range(4)]
    acs = [acslot_ref[i] for i in range(4)]
    zero = jnp.zeros((tile,), I32)

    def word(wp, need=True):
        # word wp of every lane's segment; zero past the row capacity
        w = plgpu.load(data_ref.at[jnp.minimum(wp, wcap - 1) * s_pad + seg],
                       mask=need & (wp < wcap), other=0)
        return w.astype(U32)

    def slots(comp):
        dslot, aslot = zero + dcs[0], zero + acs[0]
        for c in range(1, 4):
            dslot = jnp.where(comp == c, dcs[c], dslot)
            aslot = jnp.where(comp == c, acs[c], aslot)
        return dslot, aslot

    def cond(st):
        # (Triton has no reduce_or: any() as a max over the lane mask)
        return jnp.max(st[0].astype(I32)) > 0

    def body(st):
        act, blk, kp, off, wp, w0, w1, w2, d0, d1, d2, d3 = st
        if interleaved:
            comp = tpl_ref[jnp.minimum(blk, bps - 1)]
        else:
            comp = seg_comp
        dslot, aslot = slots(comp)
        is_dc = kp == 0
        slot = jnp.where(is_dc, dslot, aslot)

        # 32-bit view at the lane's bit offset (MSB first)
        sh = off.astype(U32)
        view = jnp.where(off > 0, (w0 << sh) | (w1 >> ((32 - sh) & 31)), w0)
        peek = (view >> 16).astype(I32)

        q = quick_ref[slot * 256 + (peek >> (16 - QUICK_BITS))]
        slow = act & ((q & 31) == 0)
        # canonical slow path (T.81 F.16): the length is the number of
        # boundaries at or below the peek, counted from QUICK_BITS + 1
        cnt = zero
        for l in range(QUICK_BITS + 1, 17):
            mc = plgpu.load(maxcode_ref.at[slot * 18 + l], mask=slow,
                            other=0)
            cnt = cnt + (peek >= mc).astype(I32)
        s_len = QUICK_BITS + 1 + cnt                  # 17 = invalid code
        l16 = jnp.minimum(s_len, 16)
        dlt = plgpu.load(delta_ref.at[slot * 17 + l16], mask=slow, other=0)
        v_idx = jnp.clip(jax.lax.shift_right_logical(peek, 16 - l16) + dlt,
                         0, 255)
        s_sym = plgpu.load(huffval_ref.at[slot * 256 + v_idx], mask=slow,
                           other=0)
        use_slow = (q & 31) == 0
        bad = use_slow & (s_len > 16)
        sym = jnp.where(use_slow, jnp.where(bad, 0, s_sym), q >> 5)
        ln = jnp.where(use_slow, jnp.where(bad, 1, s_len), q & 31)

        cat = jnp.clip(jnp.where(is_dc, sym, sym & 15), 0, 16)
        run = jnp.where(is_dc, 0, sym >> 4)
        vraw = ((view << ln.astype(U32))
                >> (32 - jnp.maximum(cat, 1)).astype(U32)).astype(I32)
        half = jax.lax.shift_left(1, jnp.maximum(cat - 1, 0))
        val = jnp.where(cat > 0,
                        jnp.where(vraw < half,
                                  vraw - jax.lax.shift_left(1, cat) + 1,
                                  vraw), 0)

        dc_prev = jnp.where(comp == 0, d0, jnp.where(
            comp == 1, d1, jnp.where(comp == 2, d2, d3)))
        dc_new = dc_prev + val
        k = kp + run
        ac_in = (cat > 0) & (k <= 63)
        write = act & (is_dc | ac_in)
        wpos = jnp.where(is_dc, 0, jnp.minimum(k, 63))
        wval = jnp.where(is_dc, dc_new, val)
        plgpu.store(out_ref.at[(seg * bps + jnp.minimum(blk, bps - 1)) * 64
                               + wpos], wval, mask=write)

        upd = act & is_dc
        d0 = jnp.where(upd & (comp == 0), dc_new, d0)
        d1 = jnp.where(upd & (comp == 1), dc_new, d1)
        d2 = jnp.where(upd & (comp == 2), dc_new, d2)
        d3 = jnp.where(upd & (comp == 3), dc_new, d3)

        zrl = (cat == 0) & (run == 15)
        newk = jnp.where(is_dc, 1, jnp.where(
            ac_in, k + 1, jnp.where(zrl, kp + 16, 64)))
        # value bits are read only for a DC or an in-range AC coefficient
        used = ln + jnp.where(is_dc | ac_in, cat, 0)
        done = newk >= 64
        blk = jnp.where(act & done, blk + 1, blk)
        kp = jnp.where(act, jnp.where(done, 0, newk), kp)

        off = jnp.where(act, off + used, off)
        adv = off >= 32
        nxt = word(wp + 3, adv)
        w0 = jnp.where(adv, w1, w0)
        w1 = jnp.where(adv, w2, w1)
        w2 = jnp.where(adv, nxt, w2)
        wp = jnp.where(adv, wp + 1, wp)
        off = jnp.where(adv, off - 32, off)
        act = act & (blk < nblk)
        return act, blk, kp, off, wp, w0, w1, w2, d0, d1, d2, d3

    st = (nblk > 0, zero, zero, zero, zero, word(zero), word(zero + 1),
          word(zero + 2), zero, zero, zero, zero)
    jax.lax.while_loop(cond, body, st)


def decode_rows(data_t, seg_comp, seg_nblk, tpl, quick, maxcode, delta,
                huffval, dc_slot, ac_slot, *, bps: int, interleaved: bool,
                tile: int = SEG_TILE, num_warps: int = 4,
                interpret: bool = False):
    """Decode every segment: ``data_t`` (Wcap, S_pad) int32 destuffed
    words, ``seg_comp``/``seg_nblk`` (S_pad,), ``tpl`` (bps,) interleaved
    slot template (all -1 otherwise), tables as :class:`DecTables`
    arrays, ``dc_slot``/``ac_slot`` (4,). Returns (S_pad * bps, 64) int32
    zig-zag coefficients, row ``seg * bps + block``. ``interleaved``
    selects the component by ``tpl[block]`` instead of ``seg_comp``.
    ``S_pad`` must be a multiple of ``tile`` (a power of two)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    wcap, s_pad = data_t.shape
    assert s_pad % tile == 0 and tile & (tile - 1) == 0, (s_pad, tile)
    kern = functools.partial(_kernel, tile=tile, s_pad=s_pad, wcap=wcap,
                             bps=bps, interleaved=interleaved)
    out_shape = jax.ShapeDtypeStruct((s_pad * bps * 64,), I32)
    out = pl.pallas_call(
        kern,
        out_shape=out_shape,
        grid=(s_pad // tile,),
        input_output_aliases={10: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="huffman_decode_segments",
    )(data_t.reshape(-1), seg_comp, seg_nblk, jnp.asarray(tpl, I32),
      quick.reshape(-1), maxcode.reshape(-1), delta.reshape(-1),
      huffval.reshape(-1), dc_slot, ac_slot,
      jnp.zeros(out_shape.shape, I32))
    return out.reshape(s_pad * bps, 64)
