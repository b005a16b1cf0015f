"""Segment-parallel Huffman decoder on device.

Plain-XLA form of the reference's one-thread-per-segment CUDA decoder
(reference: src/gpujpeg_huffman_gpu_decoder.cu:397-544): **all segments
decode in lockstep**, one Huffman symbol per segment per iteration of a
``lax.while_loop``. It is the CPU route and the reference the GPU kernel
(ops/huffman_kernel.py) is tested against. Each iteration is pure
vectorized math over (S,)-shaped state:

* 16-bit lookahead into the destuffed bitstream (3-byte gather + shift) —
  same single-lookup-per-symbol structure as the reference's 64K "full"
  table (gpujpeg_huffman_gpu_decoder.cu:552-617),
* one gather from the stacked (T, 65536) code LUT,
* branch-free DC/AC/EOB/ZRL state update,
* one dropped-or-real scatter of the decoded coefficient.

Byte unstuffing is a prefix-sum compaction over the whole scan instead of
the reference's per-thread skip logic (:134-151).

Corrupt-stream guards mirror the reference: invalid codes consume one bit,
out-of-range coefficient positions are clamped and the block terminates
(sentinel behavior of gpujpeg_table.h:64-83), and a global iteration bound
prevents livelock.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import CoderPlan
from ..tables import HuffmanTable

I32 = jnp.int32


@dataclasses.dataclass(frozen=True)
class DecGeometry:
    """Static decoder-side arrays."""

    block_comp: np.ndarray       # (NB,)
    seg_block_start: np.ndarray  # (S,)
    seg_block_count: np.ndarray  # (S,)
    max_iters: int


def build_dec_geometry(plan: CoderPlan) -> DecGeometry:
    # worst case symbols per block: DC + 63 AC + 3 ZRL + EOB
    max_iters = int(plan.max_seg_block_count) * 68 + 16
    return DecGeometry(
        block_comp=plan.block_comp,
        seg_block_start=plan.seg_block_start,
        seg_block_count=plan.seg_block_count,
        max_iters=max_iters,
    )


def build_dec_tables(dc_by_comp: list[HuffmanTable],
                     ac_by_comp: list[HuffmanTable]):
    """Stack the unique 16-bit lookahead LUTs and map components to them."""
    uniq: list[HuffmanTable] = []
    def idx_of(t: HuffmanTable) -> int:
        for i, u in enumerate(uniq):
            if u is t:
                return i
        uniq.append(t)
        return len(uniq) - 1

    dc_tab = np.zeros(4, np.int32)
    ac_tab = np.zeros(4, np.int32)
    for i, (d, a) in enumerate(zip(dc_by_comp, ac_by_comp)):
        dc_tab[i] = idx_of(d)
        ac_tab[i] = idx_of(a)
    luts = np.stack([t.lut16 for t in uniq]).astype(np.int32)  # (T, 65536)
    return luts, dc_tab, ac_tab


def destuff(data: jax.Array, seg_starts: jax.Array):
    """Remove 0x00 bytes that follow 0xFF; remap segment start offsets.
    (reference: gpujpeg_huffman_gpu_decoder.cu:134-151 does this inline;
    here it is one prefix-sum compaction over the scan)."""
    prev = jnp.concatenate([jnp.zeros(1, data.dtype), data[:-1]])
    keep = ~((data == 0x00) & (prev == 0xFF))
    kept_before = jnp.cumsum(keep.astype(I32)) - keep.astype(I32)
    dst = jnp.where(keep, kept_before, data.shape[0])
    out = jnp.zeros_like(data).at[dst].set(data, mode="drop")
    new_starts = kept_before[jnp.clip(seg_starts, 0, data.shape[0] - 1)]
    return out, new_starts


def huffman_decode_kernel(data: jax.Array, seg_starts: jax.Array,
                          g: dict, luts: jax.Array,
                          dc_tab: jax.Array, ac_tab: jax.Array,
                          n_blocks: int, max_iters: int) -> jax.Array:
    """Decode all segments in lockstep.

    Args:
      data: (L,) uint8 — concatenated entropy bytes of all scans, RST
        markers already removed, **stuffed** (destuffing happens here).
      seg_starts: (S,) int32 byte offset of each segment (plan seg order).
      g: geometry dict (block_comp, seg_block_start, seg_block_count).
      luts: (T, 65536) int32 packed (symbol<<8 | code_len).
      dc_tab/ac_tab: (4,) component -> LUT row.

    Returns:
      (n_blocks, 64) int32 zig-zag coefficients in scan order.
    """
    S = seg_starts.shape[0]
    data, seg_starts = destuff(data, seg_starts)
    d32 = data.astype(I32)
    L = d32.shape[0]

    def peek16(bitpos):
        byte = bitpos >> 3
        rem = bitpos & 7
        b0 = d32[jnp.clip(byte, 0, L - 1)]
        b1 = d32[jnp.clip(byte + 1, 0, L - 1)]
        b2 = d32[jnp.clip(byte + 2, 0, L - 1)]
        # fake zeros past the end of the buffer (corrupt-stream guard)
        b0 = jnp.where(byte < L, b0, 0)
        b1 = jnp.where(byte + 1 < L, b1, 0)
        b2 = jnp.where(byte + 2 < L, b2, 0)
        w24 = (b0 << 16) | (b1 << 8) | b2
        return (w24 >> (8 - rem)) & 0xFFFF

    coeff0 = jnp.zeros((n_blocks + 1, 64), I32)

    def cond(state):
        it, active, *_ = state
        return jnp.logical_and(jnp.any(active), it < max_iters)

    def body(state):
        it, active, bitpos, blk, pos, dc_pred, coeff = state

        bidx = g["seg_block_start"] + blk                      # (S,)
        bidx_c = jnp.clip(bidx, 0, n_blocks - 1)
        comp = g["block_comp"][bidx_c]                         # (S,)
        is_dc = pos == 0

        tab = jnp.where(is_dc, dc_tab[comp], ac_tab[comp])
        peek = peek16(bitpos)
        entry = luts[tab, peek]
        clen = entry & 0xFF
        sym = entry >> 8
        # invalid code: consume 1 bit, emit EOB-like symbol to move on
        bad = clen == 0
        clen = jnp.where(bad, 1, clen)
        sym = jnp.where(bad, 0, sym)
        bitpos2 = bitpos + clen

        cat = jnp.where(is_dc, sym, sym & 15)
        vraw = peek16(bitpos2) >> (16 - jnp.clip(cat, 0, 16))
        vraw = jnp.where(cat > 0, vraw, 0)
        half = 1 << jnp.maximum(cat - 1, 0)
        val = jnp.where((cat > 0) & (vraw < half),
                        vraw - (1 << cat) + 1, vraw)
        bitpos3 = bitpos2 + cat

        run = sym >> 4
        # next coefficient position / write target
        ac_wpos = pos + run
        is_zrl = (~is_dc) & (cat == 0) & (run == 15)
        is_eob = (~is_dc) & (cat == 0) & (run != 15)
        write = active & (is_dc | ((~is_dc) & (cat > 0) & (ac_wpos <= 63)))

        dc_val = dc_pred[jnp.arange(S), comp] + val
        wval = jnp.where(is_dc, dc_val, val)
        wpos = jnp.where(is_dc, 0, jnp.clip(ac_wpos, 0, 63))
        wrow = jnp.where(write, bidx_c, n_blocks)  # dummy row when masked
        coeff = coeff.at[wrow, wpos].set(wval, mode="drop")

        dc_pred = dc_pred.at[jnp.arange(S), comp].set(
            jnp.where(active & is_dc, dc_val, dc_pred[jnp.arange(S), comp]))

        newpos = jnp.where(
            is_dc, 1,
            jnp.where(is_zrl, pos + 16,
                      jnp.where(is_eob, 64, ac_wpos + 1)))
        done = newpos >= 64
        blk2 = jnp.where(active & done, blk + 1, blk)
        pos2 = jnp.where(done, 0, newpos)
        active2 = active & (blk2 < g["seg_block_count"])
        bitpos4 = jnp.where(active, bitpos3, bitpos)
        return (it + 1, active2, bitpos4, blk2, pos2, dc_pred, coeff)

    # Derive all carries from the (possibly device-varying) inputs so the
    # loop types check under shard_map's varying-axis discipline: constants
    # would be 'invariant' on entry but 'varying' after one iteration.
    z = seg_starts.astype(I32) * 0            # varying zero (S,)
    vz = data[0].astype(I32) & 0               # varying zero scalar
    init = (
        jnp.zeros((), I32) + vz,
        (g["seg_block_count"] + z) > 0,
        seg_starts.astype(I32) * 8,
        z,
        z,
        jnp.zeros((S, 4), I32) + z[:, None],
        coeff0 + vz,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[-1][:n_blocks]
