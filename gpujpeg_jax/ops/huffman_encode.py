"""Segment-parallel Huffman encoder on device (pure-jnp, fully vectorized).

Array-math redesign of the reference's 4-kernel warp pipeline
(reference: src/gpujpeg_huffman_gpu_encoder.cu:191-615). Where the CUDA
version uses ballot/clz/popc warp tricks and an atomicAdd compaction, this
formulation is branch-free data-parallel array math over all blocks at
once, with prefix sums replacing atomics:

1.  **Codeword synthesis** — per (block, zig-zag position), compute the
    Huffman chunk: DC category code + value bits at position 0, run-length
    symbol code + value bits at positions 1..63, EOB at a virtual position
    64. Runs derive from a cumulative-max "previous nonzero" scan instead
    of the reference's ballot bitmask.
2.  **ZRL placement** — a block emits at most 3 ZRL (16-zero-run) codes in
    total, so they get 3 dedicated chunk slots located by a per-block
    prefix sum of run>>4.
3.  **Offset computation** — per-position bit lengths cumsum to in-block
    offsets; per-block totals cumsum to in-segment offsets (reset at
    segment starts by subtracting the gathered segment-base prefix); each
    segment owns a fixed-capacity region (the analog of the reference's
    128-byte-aligned temp regions, gpujpeg_common.c:713-772).
4.  **Bit scatter** — every chunk (<= 27 bits) lands in at most two 32-bit
    big-endian words; a single scatter-add assembles the bitstream (bits
    are disjoint, so add == or). Replaces the serialization kernel.
5.  **Byte stuffing + RST append** — 0xFF detection and a per-segment
    prefix sum compute stuffed positions in one shot; the RST marker is
    appended on device so scan bodies come out ready for the stream
    (replaces the reference's host-side stream formatter hot loop,
    gpujpeg_encoder.c:479-537).
6.  **Compaction** — per-segment byte counts -> exclusive cumsum -> one
    gather compacts the used prefix of each segment region (replaces the
    atomicAdd compaction kernel, gpujpeg_huffman_gpu_encoder.cu:562-615).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import CoderPlan
from ..tables import HuffmanTable
from ..types import ComponentType, HuffmanType

I32 = jnp.int32
U32 = jnp.uint32


@dataclasses.dataclass(frozen=True)
class EncTables:
    """Huffman code tables stacked by component class, device-ready."""

    dc_code: np.ndarray  # (2, 16) int32
    dc_len: np.ndarray   # (2, 16) int32
    ac_code: np.ndarray  # (2, 256) int32
    ac_len: np.ndarray   # (2, 256) int32


def build_enc_tables(huff: dict) -> EncTables:
    dc_code = np.zeros((2, 16), np.int32)
    dc_len = np.zeros((2, 16), np.int32)
    ac_code = np.zeros((2, 256), np.int32)
    ac_len = np.zeros((2, 256), np.int32)
    for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE):
        dc: HuffmanTable = huff[(ct, HuffmanType.DC)]
        ac: HuffmanTable = huff[(ct, HuffmanType.AC)]
        dc_code[int(ct), :] = dc.ehufco[:16]
        dc_len[int(ct), :] = dc.ehufsi[:16]
        ac_code[int(ct), :] = ac.ehufco
        ac_len[int(ct), :] = ac.ehufsi
    return EncTables(dc_code, dc_len, ac_code, ac_len)


@dataclasses.dataclass(frozen=True)
class EncGeometry:
    """Static per-plan arrays for the encoder (device constants)."""

    block_cls: np.ndarray        # (NB,) component class (0 luma / 1 chroma)
    dc_pred_idx: np.ndarray      # (NB,)
    block_segment: np.ndarray    # (NB,)
    seg_block_start: np.ndarray  # (S,)
    seg_block_count: np.ndarray  # (S,)
    seg_rst_marker: np.ndarray   # (S,) RST byte value 0xD0..0xD7
    seg_has_rst: np.ndarray      # (S,) 1 unless last segment of its scan
    cap_seg_bytes: int           # per-segment region capacity (pre-stuffing)
    cap_out_bytes: int           # per-segment region capacity (post-stuffing)


def cap_for_quality(quality: int) -> int:
    """Per-block compressed-size capacity (bytes) by quality. Worst legal
    block is ~209 bytes (63 AC * 26 bit + DC); typical Q75 photo blocks are
    ~4-8 bytes. Capacity overflow is detected on host and falls back, so
    these are throughput knobs, not correctness bounds."""
    if quality >= 98:
        return 224
    if quality >= 90:
        return 96
    if quality >= 80:
        return 48
    return 32


def build_enc_geometry(plan: CoderPlan, cap_bytes_per_block: int | None = None) -> EncGeometry:
    if cap_bytes_per_block is None:
        cap_bytes_per_block = cap_for_quality(plan.params.quality)
    scan_nseg = {s.index: s.segment_count for s in plan.scans}
    last_in_scan = np.array(
        [plan.seg_scan_index[i] == scan_nseg[int(plan.seg_scan[i])] - 1
         for i in range(plan.n_segments)], dtype=np.int32)
    cls = np.array([int(plan.components[c].comp_type) for c in plan.block_comp],
                   dtype=np.int32)
    cap = plan.max_seg_block_count * cap_bytes_per_block
    cap = max(64, (cap + 63) // 64 * 64)
    cap_out = cap + cap // 2 + 8  # stuffing slack; host verifies, never lies
    return EncGeometry(
        block_cls=cls,
        dc_pred_idx=plan.dc_pred_idx,
        block_segment=plan.block_segment,
        seg_block_start=plan.seg_block_start,
        seg_block_count=plan.seg_block_count,
        seg_rst_marker=(0xD0 + plan.seg_scan_index % 8).astype(np.int32),
        seg_has_rst=(1 - last_in_scan),
        cap_seg_bytes=cap,
        cap_out_bytes=cap_out,
    )


def _scatter_bits(words: jax.Array, vals: jax.Array, lens: jax.Array,
                  offs: jax.Array) -> jax.Array:
    """OR (via add: bits are disjoint) MSB-first bitfields into a big-endian
    uint32 word array. Each field is <= 27 bits -> at most 2 words."""
    vals = jnp.where(lens > 0, vals, 0).astype(U32)
    offs = offs.astype(I32)
    w = offs >> 5
    sh = 32 - (offs & 31) - lens  # in [-26, 32]
    lo = jnp.where(sh >= 0,
                   vals << jnp.clip(sh, 0, 31).astype(U32),
                   vals >> jnp.clip(-sh, 0, 31).astype(U32))
    hi_sh = jnp.clip(32 + sh, 1, 32)
    hi = jnp.where(sh < 0, vals << jnp.minimum(hi_sh, 31).astype(U32), jnp.uint32(0))
    # drop empty fields by sending them out of bounds
    w = jnp.where(lens > 0, w, words.shape[0])
    words = words.at[w.reshape(-1)].add(lo.reshape(-1), mode="drop")
    words = words.at[(w + 1).reshape(-1)].add(hi.reshape(-1), mode="drop")
    return words


def huffman_encode_kernel(coeff: jax.Array, g: dict, t: dict):
    """The jit-traceable encoder body.

    Args:
      coeff: (NB, 64) int32 quantized zig-zag coefficients in scan order.
      g: geometry arrays (device constants, from :class:`EncGeometry`).
      t: table arrays (device constants, from :class:`EncTables`).

    Returns:
      out: (S * cap_out,) uint8 — per-segment stuffed bytes + RST marker.
      out_len: (S,) int32 — used bytes per segment region (incl. RST).
      seg_bits: (S,) int32 — raw bit counts (host-side overflow check).
    """
    NB = coeff.shape[0]
    S = g["seg_block_start"].shape[0]
    cls = g["block_cls"]
    cap_bits = g["cap_seg_bytes"] * 8
    # optional masks for padded geometry (chunked pipeline): invalid blocks
    # and zero-count segments must produce zero output bits
    valid = g.get("block_valid")
    if valid is None:
        valid = jnp.ones((NB,), jnp.bool_)
    else:
        valid = valid.astype(jnp.bool_)
    seg_valid = g["seg_block_count"] > 0

    # ---- 1. DC chunks -------------------------------------------------
    dc = coeff[:, 0]
    pred = g["dc_pred_idx"]
    dc_prev = jnp.where(pred < 0, 0, dc[jnp.maximum(pred, 0)])
    diff = dc - dc_prev
    cat = 32 - jax.lax.clz(jnp.abs(diff))
    vbits = jnp.where(diff >= 0, diff, diff + (1 << cat) - 1) & ((1 << cat) - 1)
    dc_val = (t["dc_code"][cls, cat] << cat) | vbits
    dc_len = jnp.where(valid, t["dc_len"][cls, cat] + cat, 0)

    # ---- 2. AC chunks --------------------------------------------------
    ac = coeff[:, 1:]
    nz = ac != 0
    k = jnp.arange(1, 64, dtype=I32)[None, :]
    prev_incl = jax.lax.cummax(jnp.where(nz, k, 0), axis=1)
    prev = jnp.concatenate(
        [jnp.zeros((NB, 1), I32), prev_incl[:, :-1]], axis=1)
    run = k - prev - 1
    r16 = jnp.where(nz & valid[:, None], run >> 4, 0)
    cat_ac = 32 - jax.lax.clz(jnp.abs(ac))
    cat_ac = jnp.where(nz, cat_ac, 0)
    sym = ((run & 15) << 4) | cat_ac
    a_code = t["ac_code"][cls[:, None], sym]
    a_len = t["ac_len"][cls[:, None], sym]
    av = jnp.where(ac >= 0, ac, ac + (1 << cat_ac) - 1) & ((1 << cat_ac) - 1)
    sym_val = (a_code << cat_ac) | av
    sym_len = jnp.where(nz & valid[:, None], a_len + cat_ac, 0)

    # EOB when position 63 is zero (trailing run exists)
    has_eob = (ac[:, -1] == 0) & valid
    eob_val = t["ac_code"][cls, 0]
    eob_len = jnp.where(has_eob, t["ac_len"][cls, 0], 0)

    zrl_code = t["ac_code"][cls, 0xF0]
    zrl_len1 = t["ac_len"][cls, 0xF0]
    zrl_bits = r16 * zrl_len1[:, None]

    # ---- 3. offsets ----------------------------------------------------
    len_pos = jnp.concatenate(
        [dc_len[:, None], zrl_bits + sym_len, eob_len[:, None]], axis=1)  # (NB,65)
    csum = jnp.cumsum(len_pos, axis=1)
    off_pos = csum - len_pos                       # exclusive
    block_bits = csum[:, -1]

    gpref = jnp.cumsum(block_bits) - block_bits    # exclusive over blocks
    seg_start_c = jnp.clip(g["seg_block_start"], 0, NB - 1)
    seg_base = gpref[seg_start_c]                  # (S,)
    in_seg = gpref - seg_base[jnp.clip(g["block_segment"], 0, S - 1)]
    seg_last = jnp.clip(g["seg_block_start"] + g["seg_block_count"] - 1,
                        0, NB - 1)
    seg_bits = jnp.where(seg_valid,
                         gpref[seg_last] + block_bits[seg_last] - seg_base, 0)

    block_abs = g["block_segment"] * cap_bits + in_seg  # (NB,)

    # ---- 4. bit scatter -------------------------------------------------
    n_words = S * (g["cap_seg_bytes"] // 4)
    words = jnp.zeros((n_words,), U32)
    # DC
    words = _scatter_bits(words, dc_val, dc_len, block_abs + off_pos[:, 0])
    # AC symbol+value (after any ZRLs of that position)
    words = _scatter_bits(words, sym_val, sym_len,
                          (block_abs[:, None] + off_pos[:, 1:64] + zrl_bits))
    # EOB
    words = _scatter_bits(words, eob_val, eob_len, block_abs + off_pos[:, 64])
    # ZRLs: at most 3 per block, located via prefix sums of r16
    c_incl = jnp.cumsum(r16, axis=1)               # (NB,63)
    total_r16 = c_incl[:, -1]
    rows = jnp.arange(NB)
    for j in range(3):
        exists = total_r16 > j
        p = jnp.sum((c_incl <= j).astype(I32), axis=1)      # first pos with c>j
        p = jnp.minimum(p, 62)
        ce = c_incl[rows, p] - r16[rows, p]
        off_j = block_abs + off_pos[:, 1:][rows, p] + (j - ce) * zrl_len1
        words = _scatter_bits(words, zrl_code,
                              jnp.where(exists, zrl_len1, 0), off_j)
    # per-segment 1-bit padding to byte boundary (T.81 F.1.2.3)
    pad = (-seg_bits) & 7
    seg_ids = jnp.arange(S)
    words = _scatter_bits(words, (1 << pad) - 1, pad,
                          seg_ids * cap_bits + seg_bits)

    # ---- 5. words -> bytes, stuffing, RST -------------------------------
    wb = words.reshape(S, -1)
    by = jnp.stack([(wb >> 24) & 0xFF, (wb >> 16) & 0xFF,
                    (wb >> 8) & 0xFF, wb & 0xFF], axis=-1)
    by = by.reshape(S, g["cap_seg_bytes"]).astype(U32)

    seg_len = (seg_bits + pad) >> 3                                  # (S,)
    idx = jnp.arange(g["cap_seg_bytes"], dtype=I32)[None, :]
    valid = idx < seg_len[:, None]
    is_ff = (by == 0xFF) & valid
    stuff_pref = jnp.cumsum(is_ff.astype(I32), axis=1) - is_ff
    n_ff = stuff_pref[:, -1] + is_ff[:, -1]

    cap_out = g["cap_out_bytes"]
    out = jnp.zeros((S * cap_out,), U32)
    out_pos = seg_ids[:, None] * cap_out + idx + stuff_pref
    out_pos = jnp.where(valid, out_pos, S * cap_out)
    out = out.at[out_pos.reshape(-1)].add(by.reshape(-1), mode="drop")
    # (stuffed 0x00 bytes are the zero-init gaps — no write needed)

    stuffed_len = seg_len + n_ff
    has_rst = g["seg_has_rst"]
    rst_base = seg_ids * cap_out + stuffed_len
    rst_base = jnp.where((has_rst > 0) & (stuffed_len + 2 <= cap_out),
                         rst_base, S * cap_out)
    out = out.at[rst_base].add(jnp.full((S,), 0xFF, U32), mode="drop")
    out = out.at[rst_base + 1].add(g["seg_rst_marker"].astype(U32), mode="drop")
    out_len = stuffed_len + 2 * has_rst

    return out.astype(jnp.uint8), out_len, seg_bits, n_ff


@functools.lru_cache(maxsize=64)
def _compact_fn(total_pad: int):
    """Second-stage gather: compact per-segment regions into one contiguous
    stream of ``total_pad`` bytes (bucketed static shape)."""

    @jax.jit
    def compact(out_flat, out_starts, cap_out):
        i = jnp.arange(total_pad, dtype=I32)
        seg = jnp.searchsorted(out_starts, i, side="right") - 1
        src = seg * cap_out + (i - out_starts[seg])
        if out_flat.dtype == jnp.uint32:
            # little-endian byte stream packed four per word
            w = out_flat[jnp.clip(src >> 2, 0, out_flat.shape[0] - 1)]
            return ((w >> ((src & 3).astype(jnp.uint32) * 8)) &
                    0xFF).astype(jnp.uint8)
        return out_flat[jnp.clip(src, 0, out_flat.shape[0] - 1)]

    return compact


def compact_segments(out_flat: jax.Array, out_len: np.ndarray,
                     cap_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-driven compaction: sync per-segment lengths (one small D2H),
    then gather the real bytes in one bucketed-static-shape jit call.
    Mirrors the reference's output-size sync
    (gpujpeg_huffman_gpu_encoder.cu:1158)."""
    out_len = np.asarray(out_len)
    starts = np.concatenate([[0], np.cumsum(out_len)]).astype(np.int32)
    total = int(starts[-1])
    total_pad = max(1024, 1 << int(np.ceil(np.log2(max(total, 1)))))
    fn = _compact_fn(total_pad)
    flat = np.asarray(fn(out_flat, jnp.asarray(starts[:-1]), cap_out))
    return flat[:total], starts
