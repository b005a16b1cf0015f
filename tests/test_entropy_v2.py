"""v2 entropy encoder vs the golden bit-serial coder.

The v2 formulation is plain XLA: the same code runs on the CPU test
mesh and on the GPU.
"""
import numpy as np
import pytest

from gpujpeg_jax.ops import golden
from gpujpeg_jax.ops.entropy_v2 import (
    build_packed_tables,
    build_uniform_geometry,
    encode_entropy_v2,
)
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.plan import make_plan
from gpujpeg_jax.tables import default_huffman_table
from gpujpeg_jax.types import ColorSpace, ComponentType, HuffmanType, PixelFormat

import jax.numpy as jnp


def _huff():
    return {(ct, ht): default_huffman_table(ct, ht)
            for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)
            for ht in (HuffmanType.DC, HuffmanType.AC)}


def _coeffs(rng, plan, lo=-40, hi=40, density=0.15):
    coeff = rng.integers(lo, hi, (plan.n_blocks, 64)).astype(np.int32)
    coeff[rng.random((plan.n_blocks, 64)) > density] = 0
    return coeff


@pytest.mark.parametrize("interleaved,ri,w,h", [
    (False, 2, 48, 32),
    (False, 4, 64, 48),    # pow2 restart, multi-component
    (True, 2, 32, 32),     # interleaved MCU walk
    (False, 3, 40, 24),    # non-pow2 restart -> padded segments
])
def test_v2_matches_golden(rng, interleaved, ri, w, h):
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=75, restart_interval=ri, interleaved=interleaved)
    plan = make_plan(params, image)
    coeff = _coeffs(rng, plan)
    # include extremes: big DC swings, last-position nonzero (no EOB),
    # long zero runs (ZRL chains)
    coeff[0, 0] = 1000
    if plan.n_blocks > 1:
        coeff[1, 0] = -1000
        coeff[1, 63] = 5
        coeff[1, 1:63] = 0
    if plan.n_blocks > 2:
        coeff[2, :] = 0
        coeff[2, 50] = -1      # run of 49 zeros -> 3 ZRLs
    huff = _huff()
    dc = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
    ac = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
    ref = golden.encode_segments(plan, coeff, dc, ac)

    geo = build_uniform_geometry(plan, cap_bytes_per_block=224)
    tabs = build_packed_tables(huff)
    out, out_len, seg_bits, n_ff = encode_entropy_v2(
        jnp.asarray(coeff), geo, tabs)
    out = np.asarray(out).reshape(plan.n_segments, geo.cap_out_bytes)
    out_len = np.asarray(out_len)

    for s in range(plan.n_segments):
        has_rst = int(geo.seg_has_rst[s])
        body = out[s, :out_len[s] - 2 * has_rst].tobytes()
        assert body == ref[s], f"segment {s} mismatch"
        if has_rst:
            assert out[s, out_len[s] - 2] == 0xFF
            assert out[s, out_len[s] - 1] == geo.seg_rst_marker[s]


def test_v2_stuffing_and_align(rng):
    """Force 0xFF bytes in the stream (big values) to exercise stuffing."""
    image = ImageParameters(width=32, height=16, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=75, restart_interval=1)
    plan = make_plan(params, image)
    coeff = _coeffs(rng, plan, lo=-1000, hi=1000, density=0.6)
    huff = _huff()
    dc = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
    ac = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
    ref = golden.encode_segments(plan, coeff, dc, ac)
    n_stuffed = sum(b.count(b"\xff\x00"[0:2]) for b in ref)
    assert n_stuffed > 0, "test vector produced no stuffed bytes"

    geo = build_uniform_geometry(plan, cap_bytes_per_block=224)
    tabs = build_packed_tables(huff)
    out, out_len, seg_bits, n_ff = encode_entropy_v2(
        jnp.asarray(coeff), geo, tabs)
    out = np.asarray(out).reshape(plan.n_segments, geo.cap_out_bytes)
    out_len = np.asarray(out_len)
    for s in range(plan.n_segments):
        has_rst = int(geo.seg_has_rst[s])
        body = out[s, :out_len[s] - 2 * has_rst].tobytes()
        assert body == ref[s], f"segment {s} mismatch"
