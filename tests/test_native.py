"""Native C++ host codec: bit-exactness against the NumPy golden coder
(the reference's CPU coders are its oracle; ours must match ours)."""
import numpy as np
import pytest

from gpujpeg_jax import native
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.ops import golden
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.plan import make_plan
from gpujpeg_jax.tables import default_huffman_table
from gpujpeg_jax.types import ColorSpace, ComponentType, HuffmanType, PixelFormat

pytestmark = pytest.mark.skipif(native.lib() is None,
                                reason="no C++ compiler available")


def _tables(plan):
    dc = [default_huffman_table(c.comp_type, HuffmanType.DC)
          for c in plan.components]
    ac = [default_huffman_table(c.comp_type, HuffmanType.AC)
          for c in plan.components]
    return dc, ac


@pytest.mark.parametrize("interleaved,ri", [(False, 0), (False, 3), (True, 2)])
def test_native_encode_matches_golden(rng, interleaved, ri):
    image = ImageParameters(width=48, height=32, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=75, restart_interval=ri, interleaved=interleaved)
    plan = make_plan(params, image)
    # adversarial coefficients: sparse + extremes, exercises ZRL/EOB/big cats
    coeff = rng.integers(-40, 40, (plan.n_blocks, 64)).astype(np.int32)
    coeff[rng.random((plan.n_blocks, 64)) < 0.85] = 0
    coeff[0, 0] = 1023
    coeff[1, 63] = -1023
    dc, ac = _tables(plan)
    ref = golden.encode_segments(plan, coeff, dc, ac)
    nat = native.encode_segments_native(plan, coeff, dc, ac)
    assert nat is not None
    assert len(nat) == len(ref)
    for a, b in zip(nat, ref):
        assert a == b


@pytest.mark.parametrize("interleaved,ri", [(False, 0), (False, 3), (True, 2)])
def test_native_decode_round_trip(rng, interleaved, ri):
    image = ImageParameters(width=48, height=32, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=75, restart_interval=ri, interleaved=interleaved)
    plan = make_plan(params, image)
    coeff = rng.integers(-100, 100, (plan.n_blocks, 64)).astype(np.int32)
    coeff[rng.random((plan.n_blocks, 64)) < 0.8] = 0
    dc, ac = _tables(plan)
    seg_bytes = golden.encode_segments(plan, coeff, dc, ac)

    # lay segments out per scan like the stream reader would
    scan_data, segments_by_scan = [], []
    si = 0
    for scan in plan.scans:
        parts, segs, pos = [], [], 0
        for _ in range(scan.segment_count):
            b = seg_bytes[si]
            si += 1
            parts.append(np.frombuffer(b, np.uint8))
            segs.append((pos, pos + len(b)))
            pos += len(b)
        scan_data.append(np.concatenate(parts) if parts else np.zeros(0, np.uint8))
        segments_by_scan.append(segs)

    ref = golden.decode_segments(plan, scan_data, segments_by_scan, dc, ac)
    nat = native.decode_segments_native(plan, scan_data, segments_by_scan, dc, ac)
    assert nat is not None
    np.testing.assert_array_equal(nat, ref)
    np.testing.assert_array_equal(nat, coeff)


def test_native_decode_corrupt_stream_no_crash():
    image = ImageParameters(width=32, height=32, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    plan = make_plan(Parameters(restart_interval=2), image)
    dc, ac = _tables(plan)
    garbage = np.frombuffer(bytes(range(256)) * 4, np.uint8)
    segs = [[(0, 256)] for _ in plan.scans]
    out = native.decode_segments_native(
        plan, [garbage] * len(plan.scans), segs, dc, ac)
    assert out is not None
    assert out.shape == (plan.n_blocks, 64)


def _ref_destuffed_rows(data, lo, hi, S, Wc):
    """Per-byte reference of the destuff-to-words contract (the native
    builders use memchr-run copies + bswap packing; this is the obvious
    slow form both must match)."""
    rows = np.zeros((S, Wc), np.uint32)
    weights = np.array([1 << 24, 1 << 16, 1 << 8, 1], np.uint32)
    for s in range(S):
        a, b = int(lo[s]), int(hi[s])
        if a < 0 or b > data.size or a >= b:
            continue
        out = []
        i = a
        while i < b and len(out) < Wc * 4:
            byte = int(data[i])
            out.append(byte)
            if byte == 0xFF and i + 1 < b and data[i + 1] == 0:
                i += 1
            i += 1
        buf = np.zeros(Wc * 4, np.uint8)
        buf[:len(out)] = out
        rows[s] = buf.reshape(Wc, 4).astype(np.uint32) @ weights
    return rows


@pytest.mark.parametrize("ff_density", [0.0, 0.05, 0.6])
def test_native_row_builders_match_byte_reference(rng, ff_density):
    """gj_build_rows / gj_build_rows_t against the per-byte destuff
    reference, across 0xFF densities (clean runs, typical stuffing,
    pathological marker-heavy data) incl. empty/missing/overlong
    segments and tile-boundary segment counts."""
    import ctypes
    L = native.lib()
    data = rng.integers(0, 256, 120000).astype(np.uint8)
    if ff_density:
        n_ff = int(data.size * ff_density)
        data[rng.choice(data.size, n_ff, replace=False)] = 0xFF
    for S in (1, 64, 65, 257):
        W = int(rng.integers(3, 14))
        lo = np.sort(rng.choice(data.size - 400, S, replace=False)).astype(np.int64)
        hi = (lo + rng.integers(1, 380, S)).astype(np.int64)
        if S > 2:
            hi[1] = lo[1]        # empty
            lo[2] = -1           # missing
        ref = _ref_destuffed_rows(data, lo, hi, S, W)

        rows = np.zeros((S, W), np.uint32)
        L.gj_build_rows(np.ascontiguousarray(data), data.size,
                        lo, hi, S, rows, W)
        np.testing.assert_array_equal(rows, ref)

        S_pad = -(-S // 128) * 128
        rowsT = np.empty((W, S_pad), np.uint32)
        L.gj_build_rows_t(np.ascontiguousarray(data), data.size,
                          lo, hi, S, rowsT, W, S_pad)
        exp = np.zeros((W, S_pad), np.uint32)
        exp[:, :S] = ref.T
        np.testing.assert_array_equal(rowsT, exp)
