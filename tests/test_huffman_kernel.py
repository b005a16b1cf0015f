"""The GPU route's Huffman decode kernel (ops/huffman_kernel.py) against
the golden bit-serial decoder, coefficient for coefficient.

On the CPU the kernel runs in the Pallas interpreter; the ``gpu`` test
runs the same checks on the kernel as compiled for the card.
"""
import numpy as np
import pytest

from conftest import make_test_rgb

from gpujpeg_jax.models.decoder import Decoder, huffman_maps
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.ops import golden
from gpujpeg_jax.ops import huffman_kernel as hk
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.stream import reader
from gpujpeg_jax.types import ColorSpace, PixelFormat


def _stream(h, w, sampling, quality, ri, img=None):
    """Golden-encoded stream -> (plan, scan_data, segments, dc, ac)."""
    gray = sampling == "gray"
    if img is None:
        img = make_test_rgb(h, w)
    if gray:
        img = np.ascontiguousarray(img[..., 0])
    image = ImageParameters(
        width=w, height=h, color_space=ColorSpace.RGB,
        pixel_format=PixelFormat.U8 if gray else PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=quality, restart_interval=ri,
                        interleaved=sampling in (420, 422))
    if sampling in (420, 422):
        params = params.with_chroma_subsampling(sampling)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    info = reader.read_image(data)
    plan, scan_data, segs = Decoder(backend="golden")._plan_from_info(info)
    dcm, acm = huffman_maps(info)
    return plan, scan_data, segs, dcm, acm


def _kernel_coeffs(plan, scan_data, segs, dcm, acm, interpret=True):
    """Scan-order (n_blocks, 64) coefficients from the kernel."""
    import jax.numpy as jnp
    tabs, dc_slot, ac_slot = hk.table_slots(plan, dcm, acm)
    concat, lo, hi, wcap = hk.segment_ranges_wcap(scan_data, segs, plan)
    s_pad = -(-plan.n_segments // hk.SEG_TILE) * hk.SEG_TILE
    data_t = hk.build_segment_rows_t(concat, lo, hi, plan, wcap, s_pad)
    seg_comp, seg_nblk, tpl = hk.segment_layout(plan, s_pad)
    bps = int(plan.max_seg_block_count)
    out = hk.decode_rows(
        *(jnp.asarray(a) for a in (
            data_t, seg_comp, seg_nblk, tpl, tabs.quick, tabs.maxcode,
            tabs.delta, tabs.huffval, dc_slot, ac_slot)),
        bps=bps, interleaved=bool((tpl >= 0).any()), interpret=interpret)
    out = np.asarray(out)
    assert out.shape == (s_pad * bps, 64)
    slot = np.arange(plan.n_blocks) - plan.seg_block_start[plan.block_segment]
    return out[plan.block_segment * bps + slot], wcap


def _check(plan, scan_data, segs, dcm, acm, interpret=True):
    want = golden.decode_segments(plan, scan_data, segs, dcm, acm)
    got, wcap = _kernel_coeffs(plan, scan_data, segs, dcm, acm, interpret)
    np.testing.assert_array_equal(got, want)
    return wcap


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("sampling", [444, 420, 422, "gray"])
def test_decode_kernel_matches_golden(sampling, quality):
    _check(*_stream(48, 64, sampling, quality, ri=2))


def test_decode_kernel_large_wcap():
    """Q100 noise with long segments: rows of hundreds of words (every
    capacity, no upper limit)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (32, 128, 3), dtype=np.uint8)
    wcap = _check(*_stream(32, 128, 444, 100, ri=32, img=img))
    assert wcap >= 512


def test_decode_kernel_ragged_segments():
    """Segment counts that fill neither the restart interval nor the
    kernel tile: short last segments per scan and padded lanes."""
    plan, *rest = _stream(40, 72, 444, 75, ri=7)
    counts = np.asarray(plan.seg_block_count)
    assert counts.min() < counts.max()
    assert plan.n_segments % hk.SEG_TILE
    _check(plan, *rest)


def test_decode_kernel_corrupt_entropy():
    """Corrupted entropy bytes: invalid codes, runs past coefficient 63
    and reads past the segment end decode exactly as the golden
    decoder does."""
    plan, scan_data, segs, dcm, acm = _stream(48, 64, 444, 75, ri=2)
    rng = np.random.default_rng(11)
    bad = []
    for sd in scan_data:
        sd = np.array(sd, np.uint8)
        for i in rng.integers(0, sd.size, max(4, sd.size // 40)):
            sd[i] ^= np.uint8(rng.integers(1, 256))
        bad.append(sd)
    _check(plan, bad, segs, dcm, acm)


@pytest.mark.gpu
def test_decode_kernel_compiled_matches_golden(gpu_device):
    """The kernel as compiled for the card, on interleaved 4:2:0 and
    non-interleaved Q100 streams."""
    _check(*_stream(64, 96, 420, 75, ri=2), interpret=False)
    _check(*_stream(64, 96, 444, 100, ri=8), interpret=False)
