"""Gather/scatter-light segment-parallel Huffman encoder (v2), plain XLA.

The v1 formulation (scatter codeword bits into the output, one gather
per code table lookup; ops/huffman_encode.py) serializes badly. v2 keeps
the stage dense:

* **Symbol synthesis**: every block's <= 64 codeword chunks come from
  lane-wise math on the (N, 64) coefficients; the Annex-K tables are
  packed as ``code<<5 | len`` (<= 21 bits) and read by small gathers
  (512 + 64 entries).

* **Bit assembly** is dense math instead of scatter: every chunk knows
  its intra-block bit offset (a lane-wise cumsum); each of the block's
  output words is a masked sum of shifted chunk contributions (bits are
  disjoint, so add == or).

* **Cross-block concatenation** is a logarithmic tree merge over each
  segment's (power-of-two padded) blocks: at every level, the right
  string shifts by the left string's bit length — a per-row variable
  bit-shift plus a barrel word-roll (log-step selects).

* **Byte stuffing** is a bounded select-chain of shifts: each byte moves
  right by the number of 0xFF bytes before it; skipped output slots are
  exactly the inserted 0x00 stuff bytes.

The reference's warp/atomics pipeline (gpujpeg_huffman_gpu_encoder.cu:
191-615) maps to this as: encode_kernel -> block_chunks_xla,
serialization -> merge_segments + stuff_and_rst, compaction -> host-side
prefix-sum slice (huffman_encode.compact_segments).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..plan import CoderPlan
from ..tables import HuffmanTable
from ..types import ComponentType, HuffmanType
from .huffman_encode import cap_for_quality

I32 = jnp.int32
U32 = jnp.uint32

MAX_STUFF = 255  # max 0xFF bytes per segment handled on device (fits uint8)
#: tier-1 stuffing cap: typical segments stuff ~2 bytes, so 31 (5
#: butterfly stages instead of 8) covers real content; overflow falls
#: back to the tier-2 worst-case geometry like the other caps
MAX_STUFF_T1 = 31


# ---------------------------------------------------------------------------
# Tables: packed (code<<5 | len) entries
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedTables:
    ac512: np.ndarray   # (512,) int32: [cls*256 + sym] -> code<<5|len
    dc64: np.ndarray    # (64,)  int32: [cls*32 + cat]  -> code<<5|len
    zrl: np.ndarray     # (2, 2) int32: [cls] -> (code, len)
    eob: np.ndarray     # (2, 2) int32: [cls] -> (code, len)


def build_packed_tables(huff: dict) -> PackedTables:
    ac512 = np.zeros(512, np.int32)
    dc64 = np.zeros(64, np.int32)
    zrl = np.zeros((2, 2), np.int32)
    eob = np.zeros((2, 2), np.int32)
    for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE):
        c = int(ct)
        dc: HuffmanTable = huff[(ct, HuffmanType.DC)]
        ac: HuffmanTable = huff[(ct, HuffmanType.AC)]
        ac512[c * 256:(c + 1) * 256] = \
            (ac.ehufco.astype(np.int64) << 5 | ac.ehufsi).astype(np.int32)
        dc64[c * 32:c * 32 + 16] = \
            (dc.ehufco[:16].astype(np.int64) << 5 | dc.ehufsi[:16]).astype(np.int32)
        zrl[c] = (int(ac.ehufco[0xF0]), int(ac.ehufsi[0xF0]))
        eob[c] = (int(ac.ehufco[0x00]), int(ac.ehufsi[0x00]))
    return PackedTables(ac512, dc64, zrl, eob)


# ---------------------------------------------------------------------------
# Uniform segment geometry: every segment padded to BPS (pow2) blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UniformGeometry:
    n_segments: int
    bps: int                 # blocks per segment (power of two, padded)
    n_rows: int              # n_segments * bps
    #: (n_rows,) gather index into the scan-order coefficient array;
    #: n_blocks = dummy zero row (padded slots)
    coeff_idx: np.ndarray
    block_cls: np.ndarray    # (n_rows,)
    block_valid: np.ndarray  # (n_rows,)
    #: (n_rows,) distance (in scan order) to the DC predecessor; 0 = none
    dc_dist: np.ndarray
    dc_distances: tuple      # distinct nonzero distances
    seg_rst_marker: np.ndarray  # (S,)
    seg_has_rst: np.ndarray     # (S,)
    words_per_block: int        # W
    cap_seg_words: int          # merged string capacity (words)
    cap_out_bytes: int          # stuffed output region capacity per segment
    max_stuff: int = 255        # stuffing displacement cap (butterfly depth)


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def block_byte_budget(quality: int) -> int:
    """Tier-1 per-block string capacity (bytes). Stage-1 window assembly
    cost is linear in this (W = ceil(cap/4) words per block), so the
    encoder first runs with a typical-content cap — worst legal blocks
    (~209 bytes) overflow, are detected via seg_bits, and re-run on the
    tier-2 worst-case geometry (cap_for_quality)."""
    if quality >= 98:
        return 224
    if quality >= 80:
        return 32   # W=8 (pow2 keeps the packed merge path eligible)
    return 16       # W=4


def seg_budget_for_quality(quality: int, bps: int) -> int:
    """Typical-content per-segment byte budget (tier-1 sizing). Real photo
    blocks at Q75 average ~4-8 bytes; the worst-case cap (cap_for_quality)
    is ~4-8x larger. Merge/stuff cost scales with this, so the encoder
    first runs with this budget and falls back to the worst-case tier
    only when a segment overflows (detected via seg_bits)."""
    if quality >= 98:
        return bps * 96
    if quality >= 90:
        return bps * 40
    if quality >= 80:
        return bps * 20
    if quality >= 50:
        return bps * 14
    return bps * 10


def build_uniform_geometry(plan: CoderPlan,
                           cap_bytes_per_block: int | None = None,
                           rst_marker: np.ndarray | None = None,
                           has_rst: np.ndarray | None = None,
                           seg_byte_budget: int | None = None) -> UniformGeometry:
    if cap_bytes_per_block is None:
        cap_bytes_per_block = cap_for_quality(plan.params.quality)
    S = plan.n_segments
    bps = _pow2(int(plan.max_seg_block_count))
    n_rows = S * bps

    coeff_idx = np.full(n_rows, plan.n_blocks, np.int32)
    cls = np.zeros(n_rows, np.int32)
    valid = np.zeros(n_rows, np.int32)
    dc_dist = np.zeros(n_rows, np.int32)

    starts = plan.seg_block_start
    counts = plan.seg_block_count
    rows = np.arange(n_rows)
    seg = rows // bps
    k = rows % bps
    real = k < counts[seg]
    b = starts[seg] + np.minimum(k, np.maximum(counts[seg] - 1, 0))
    coeff_idx[real] = b[real]
    from .huffman_encode import build_enc_geometry
    g = build_enc_geometry(plan, cap_bytes_per_block)
    cls_all = g.block_cls
    cls[real] = cls_all[b[real]]
    valid[real] = 1
    pred = plan.dc_pred_idx
    dist = np.where(pred >= 0, np.arange(plan.n_blocks) - pred, 0)
    dc_dist[real] = dist[b[real]]
    distances = tuple(sorted(set(int(d) for d in np.unique(dist) if d > 0)))

    W = max(2, (cap_bytes_per_block + 3) // 4)
    if seg_byte_budget is not None:
        cap_seg_words = max(W, -(-seg_byte_budget // 4))
    else:
        cap_seg_words = (int(plan.max_seg_block_count) *
                         cap_bytes_per_block + 3) // 4
    cap_seg_words = -(-cap_seg_words // 4) * 4 + 2
    cap_out = cap_seg_words * 4
    cap_out = cap_out + cap_out // 2 + 8          # stuffing slack + RST
    cap_out = -(-cap_out // 128) * 128
    return UniformGeometry(
        n_segments=S, bps=bps, n_rows=n_rows,
        coeff_idx=coeff_idx, block_cls=cls, block_valid=valid,
        dc_dist=dc_dist, dc_distances=distances,
        seg_rst_marker=(rst_marker if rst_marker is not None
                        else g.seg_rst_marker),
        seg_has_rst=(has_rst if has_rst is not None else g.seg_has_rst),
        words_per_block=W, cap_seg_words=cap_seg_words,
        cap_out_bytes=cap_out,
        max_stuff=MAX_STUFF_T1 if seg_byte_budget is not None else MAX_STUFF,
    )


# ---------------------------------------------------------------------------
# Stage 1 — per-block chunks + window assembly
# ---------------------------------------------------------------------------

def _chunk_planes(c, diff, cls, valid, t):
    """Symbol-synthesis math for a tile of blocks.

    Args:
      c: (T, 64) int32 zig-zag coefficients.
      diff: (T, 1) int32 DC difference.
      cls/valid: (T, 1) int32.
      t: dict of packed table arrays (ac512, dc64, zrl2, eob2 jnp arrays)
        plus a `lookup(tab, idx, n)` function.

    Returns per-lane SINGLE chunks (val, ln, off): every lane emits at
    most one <= 27-bit string. ZRL codes for runs >= 16 are relocated
    onto the zero lanes they stand for (lane prev+16m emits the m-th
    ZRL — those lanes are otherwise empty, and the offset cumsum orders
    them before their run's terminating code automatically); EOB rides
    in lane 63's otherwise-empty slot. Plus block_bits (T, 1).
    """
    T = c.shape[0]
    k = jax.lax.broadcasted_iota(I32, (T, 64), 1)
    is_dc = k == 0
    v = jnp.where(is_dc, diff, c)
    nz = (v != 0) & (~is_dc)

    av = jnp.abs(v)
    cat = 32 - t["clz"](av)                       # 0 for v == 0
    vbits = jnp.where(v >= 0, v, v + (1 << cat) - 1) & ((1 << cat) - 1)

    # runs of zeros before each nonzero AC
    prev_incl = t["cummax"](jnp.where(nz, k, 0))
    prev = t["shift_lanes_right"](prev_incl, 1)
    run = jnp.where(nz, k - prev - 1, 0)

    # code + value bits (<= 27 bits) for DC / nonzero AC lanes
    sym = ((run & 15) << 4) | cat
    entry_ac = t["lookup512"](cls * 256 + sym)
    entry_dc = t["lookup64"](cls * 32 + jnp.minimum(cat, 15))
    entry = jnp.where(is_dc, entry_dc, entry_ac)
    code = entry >> 5
    clen = entry & 31
    emit = is_dc | nz
    ln = jnp.where(emit, clen + cat, 0)
    val = jnp.where(emit, (code << cat) | vbits, 0)

    # ZRL on the 16th/32nd/48th zero lane of a run that a nonzero ends
    zc = jnp.where(cls > 0, t["zrl_c"][0], t["zrl_l"][0])
    zl = jnp.where(cls > 0, t["zrl_c"][1], t["zrl_l"][1])
    d = k - prev
    has_next = t["shift_lanes_left"](t["revmax"](nz.astype(I32)), 1)
    is_zrl = (~is_dc) & (~nz) & (has_next > 0) & (d >= 16) & ((d & 15) == 0)
    ln = jnp.where(is_zrl, zl, ln) * valid
    val = jnp.where(is_zrl, zc, val)

    csum = t["cumsum"](ln)
    off = csum - ln
    pre_eob_bits = csum[:, 63:64]

    # EOB in lane 63: c[63] == 0 implies lane 63 emits nothing, and its
    # offset (= pre_eob_bits) is exactly where EOB belongs
    has_eob = (c[:, 63:64] == 0) & (valid > 0)
    ec = jnp.where(cls > 0, t["eob_c"][0], t["eob_l"][0])
    el = jnp.where(cls > 0, t["eob_c"][1], t["eob_l"][1])
    lane63 = k == 63
    ln = jnp.where(lane63 & has_eob, el, ln)
    val = jnp.where(lane63 & has_eob, ec, val)

    block_bits = pre_eob_bits + jnp.where(has_eob, el, 0)
    return val, ln, off, block_bits


def _srl(x, n):
    """Logical (unsigned) right shift on int32 lanes."""
    return jax.lax.shift_right_logical(x, n)


def _windows(val, ln, off, W: int):
    """Dense window assembly: (T, W) words from per-lane single chunks
    (<= 27 bits each, so a chunk spans at most two adjacent words).

    Runs in int32: `<<` wraps mod 2^32 and right shifts are explicit
    logical shifts, so the math is exactly the uint32 math the merge
    stage expects; the final convert to uint32 is a mod-2^32
    reinterpretation."""
    out = []
    for w in range(W):
        rel = off - 32 * w
        sh = 32 - rel - ln
        pos_sh = jnp.clip(sh, 0, 31)
        neg_sh = jnp.clip(-sh, 0, 31)
        contrib = jnp.where(sh >= 0, val << pos_sh, _srl(val, neg_sh))
        mask = (ln > 0) & (rel < 32) & (rel + ln > 0)
        total = jnp.where(mask, contrib, 0)
        out.append(jnp.sum(total, axis=1, keepdims=True, dtype=I32))
    return jnp.concatenate(out, axis=1).astype(U32)


def _xla_helpers(tabs: PackedTables):
    ac512 = jnp.asarray(tabs.ac512)
    dc64 = jnp.asarray(tabs.dc64)
    return {
        "clz": jax.lax.clz,
        "cummax": lambda x: jax.lax.cummax(x, axis=1),
        "revmax": lambda x: jax.lax.cummax(x, axis=1, reverse=True),
        "cumsum": lambda x: jnp.cumsum(x, axis=1),
        "shift_lanes_right": lambda x, s: jnp.concatenate(
            [jnp.zeros((x.shape[0], s), x.dtype), x[:, :-s]], axis=1),
        "shift_lanes_left": lambda x, s: jnp.concatenate(
            [x[:, s:], jnp.zeros((x.shape[0], s), x.dtype)], axis=1),
        "lookup512": lambda i: ac512[i],
        "lookup64": lambda i: dc64[i],
        "zrl_l": tuple(int(v) for v in tabs.zrl[0]),
        "zrl_c": tuple(int(v) for v in tabs.zrl[1]),
        "eob_l": tuple(int(v) for v in tabs.eob[0]),
        "eob_c": tuple(int(v) for v in tabs.eob[1]),
    }


def block_chunks_xla(coeff, diff, cls, valid, tabs: PackedTables, W: int):
    """(N, 64) coeffs -> (N, W) uint32 local words + (N, 1) bit lengths."""
    t = _xla_helpers(tabs)
    val, ln, off, bits = _chunk_planes(
        coeff, diff, cls[:, None], valid[:, None], t)
    return _windows(val, ln, off, W), bits


# ---------------------------------------------------------------------------
# Stage 2 — tree merge of block strings into segment strings
# ---------------------------------------------------------------------------

def _word_roll_right(x, o):
    """Barrel roll: shift each row right by o (per-row) words."""
    R = x.shape[1]
    bit = 1
    while bit < R:
        sh = jnp.concatenate(
            [jnp.zeros((x.shape[0], bit), x.dtype), x[:, :-bit]], axis=1)
        x = jnp.where((o & bit) > 0, sh, x)
        bit <<= 1
    return x


def _merge_pair(lw, lb, rw, rb, R_out: int):
    """Concatenate bit strings: (left words, left bits) + (right ...)."""
    rows = lw.shape[0]
    R_in = lw.shape[1]
    lw = jnp.pad(lw, ((0, 0), (0, R_out - R_in)))
    rw = jnp.pad(rw, ((0, 0), (0, R_out - R_in)))
    sh = (lb & 31).astype(U32)                    # (rows, 1)
    prev = jnp.concatenate(
        [jnp.zeros((rows, 1), rw.dtype), rw[:, :-1]], axis=1)
    lo = jnp.where(sh > 0, rw >> sh, rw)
    hi = jnp.where(sh > 0, prev << ((32 - sh) & 31).astype(U32), 0)
    shifted = lo | hi
    rolled = _word_roll_right(shifted, lb >> 5)
    return lw | rolled, lb + rb


def merge_segments(words, bits, bps: int, cap_words: int):
    """(S*bps, W) block strings -> (S, cap_words) segment strings + bits."""
    n_rows, W = words.shape
    R = W
    lv_words = words
    lv_bits = bits
    blocks = bps
    while blocks > 1:
        R_out = min(2 * R, cap_words)
        lw = lv_words[0::2]
        rw = lv_words[1::2]
        lb = lv_bits[0::2]
        rb = lv_bits[1::2]
        lv_words, lv_bits = _merge_pair(lw, lb, rw, rb, R_out)
        R = R_out
        blocks //= 2
    if R < cap_words:
        lv_words = jnp.pad(lv_words, ((0, 0), (0, cap_words - R)))
    return lv_words, lv_bits[:, 0]


# ---------------------------------------------------------------------------
# Stage 3 — byte stuffing + RST append (byte-per-lane domain)
# ---------------------------------------------------------------------------

def stuff_and_rst(seg_words, seg_bits, rst_marker, has_rst, cap_out: int,
                  max_stuff: int = MAX_STUFF):
    """(S, CW) uint32 big-endian words -> (S, cap_out) uint8 stuffed bytes
    with byte-align padding and RST markers; returns (out, out_len, n_ff).

    Runs in the uint8 domain (a quarter of the int32 bytes):
    displacements fit in a byte because MAX_STUFF <= 255.
    """
    S, CW = seg_words.shape
    capB = CW * 4
    U8 = jnp.uint8

    # unpack words to byte lanes (static strided writes)
    by = jnp.zeros((S, capB), U8)
    w = seg_words
    by = by.at[:, 0::4].set((w >> 24).astype(U8))
    by = by.at[:, 1::4].set((w >> 16).astype(U8))
    by = by.at[:, 2::4].set((w >> 8).astype(U8))
    by = by.at[:, 3::4].set(w.astype(U8))

    # byte-align: pad final partial byte with 1-bits (T.81 F.1.2.3)
    pad = (-seg_bits) & 7
    seg_len = (seg_bits + pad) >> 3
    idx = jax.lax.broadcasted_iota(I32, (S, capB), 1)
    last = (seg_bits >> 3)[:, None]
    by = jnp.where(idx == last, by | ((1 << pad) - 1)[:, None].astype(U8), by)
    valid = idx < seg_len[:, None]
    by = jnp.where(valid, by, 0)

    is_ff = (by == 0xFF) & valid
    pref = jnp.cumsum(is_ff.astype(I32), axis=1)
    pref_ex = (pref - is_ff)
    n_ff = pref[:, -1]

    # Forward-route each byte right by the number of 0xFF bytes before it.
    # Displacements are non-decreasing along the row, so an MSB-first
    # butterfly (conditional shift by 2^b per stage) is collision-free:
    # floor(p/2^b)*2^b stays monotone, hence injective at every stage.
    # Slots nothing routes to are exactly the inserted 0x00 stuff bytes.
    arr = jnp.pad(by, ((0, 0), (0, cap_out - capB)))
    disp = jnp.where(jnp.pad(valid, ((0, 0), (0, cap_out - capB))),
                     jnp.pad(jnp.minimum(pref_ex, max_stuff).astype(U8),
                             ((0, 0), (0, cap_out - capB))),
                     jnp.uint8(0))
    b = min(max_stuff, 255).bit_length() - 1
    while (1 << b) >= cap_out:
        b -= 1
    zero8 = jnp.uint8(0)
    while b >= 0:
        step = 1 << b
        move = (disp >> b) & 1
        arr_s = jnp.concatenate(
            [jnp.zeros((S, step), U8), arr[:, :-step]], axis=1)
        disp_s = jnp.concatenate(
            [jnp.zeros((S, step), U8), disp[:, :-step]], axis=1)
        move_s = jnp.concatenate(
            [jnp.zeros((S, step), U8), move[:, :-step]], axis=1)
        arr = jnp.where(move_s > 0, arr_s, jnp.where(move > 0, zero8, arr))
        disp = jnp.where(move_s > 0, disp_s - jnp.uint8(step),
                         jnp.where(move > 0, zero8, disp))
        b -= 1
    out = arr

    stuffed_len = seg_len + jnp.minimum(n_ff, max_stuff)
    oidx = jax.lax.broadcasted_iota(I32, (S, cap_out), 1)
    rpos = stuffed_len[:, None]
    hr = (has_rst > 0)[:, None]
    out = jnp.where(hr & (oidx == rpos), jnp.uint8(0xFF), out)
    out = jnp.where(hr & (oidx == rpos + 1),
                    rst_marker[:, None].astype(U8), out)
    out_len = stuffed_len + 2 * has_rst
    return out, out_len, n_ff


# ---------------------------------------------------------------------------
# Full entropy encode (drop-in for huffman_encode_kernel, uniform geometry)
# ---------------------------------------------------------------------------

def dc_diff(dc, dc_dist, distances):
    """DC differences via static shifts (no gather): dc (N,) in scan order,
    dc_dist (N_rows,) distance to predecessor in scan order (0 = none)."""
    prev = jnp.zeros_like(dc)
    for d in distances:
        sh = jnp.concatenate([jnp.zeros((d,), dc.dtype), dc[:-d]])
        prev = jnp.where(dc_dist == d, sh, prev)
    return dc - prev


def encode_rows_arrays(rows, cls, valid, dc_dist, rst_marker, has_rst,
                       distances: tuple, bps: int, cap_seg_words: int,
                       cap_out_bytes: int, W: int,
                       tabs: PackedTables, max_stuff: int = MAX_STUFF):
    """Traced-array core of :func:`encode_rows` (geometry as tensors so
    large plans can ``lax.map`` over segment chunks).

    Stage 1 (per-block strings), then stages 2+3: tree-merge block
    strings into segment strings, byte stuff, append RST. Per-block
    capacity overflow (> W*32 bits) folds into that block's bit length
    (1<<20 offset) so the merged segment total trips the host's
    seg_bits-vs-cap check; stuffing overflow (n_ff > max_stuff) is
    checked by the host against the returned n_ff directly."""
    diff_rows = dc_diff(rows[:, 0], dc_dist, distances)[:, None]
    words, bits = block_chunks_xla(rows, diff_rows, cls, valid, tabs, W)
    bits = bits + jnp.where((bits > W * 32) & (bits < (1 << 20)),
                            1 << 20, 0)
    seg_words, seg_bits = merge_segments(words, bits, bps, cap_seg_words)
    out, out_len, n_ff = stuff_and_rst(
        seg_words, seg_bits, rst_marker, has_rst, cap_out_bytes, max_stuff)
    return out.reshape(-1), out_len, seg_bits, n_ff


def encode_rows(rows, geo: UniformGeometry, tabs: PackedTables,
                rst_marker=None, has_rst=None):
    """Entropy-encode uniform-layout coefficient rows.

    rows: (n_rows, 64) int32 — segment-uniform layout (geo.coeff_idx
    applied by the caller; padded rows arbitrary, masked by block_valid).

    Returns (out u8 (S*cap_out,), out_len (S,), seg_bits (S,), n_ff (S,))
    — the contract of huffman_encode_kernel. Capacity overflow (block
    string > W words, or > MAX_STUFF stuffed bytes) is folded into
    seg_bits so the host's single seg_bits-vs-cap check catches it."""
    return encode_rows_arrays(
        rows, jnp.asarray(geo.block_cls), jnp.asarray(geo.block_valid),
        jnp.asarray(geo.dc_dist),
        jnp.asarray(geo.seg_rst_marker) if rst_marker is None else rst_marker,
        jnp.asarray(geo.seg_has_rst) if has_rst is None else has_rst,
        geo.dc_distances, geo.bps, geo.cap_seg_words, geo.cap_out_bytes,
        geo.words_per_block, tabs, geo.max_stuff)


def encode_entropy_v2(coeff_scan, geo: UniformGeometry, tabs: PackedTables):
    """coeff_scan: (n_blocks, 64) int32 scan-order zig-zag coefficients."""
    coeff_idx = jnp.asarray(geo.coeff_idx)
    cpad = jnp.concatenate([coeff_scan, jnp.zeros((1, 64), coeff_scan.dtype)])
    rows = cpad[coeff_idx]                              # (n_rows, 64) row gather
    return encode_rows(rows, geo, tabs)
