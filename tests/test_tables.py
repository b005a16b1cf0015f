"""Golden tests for quant/Huffman table generation vs T.81 Annex K and a
libjpeg-encoded stream (PIL) as external oracle."""
import io

import numpy as np
import pytest
from PIL import Image

from gpujpeg_jax import tables
from gpujpeg_jax.ops import golden
from gpujpeg_jax.types import ComponentType, HuffmanType


def test_zigzag_roundtrip():
    assert np.array_equal(
        tables.ZIGZAG_TO_NATURAL[tables.NATURAL_TO_ZIGZAG], np.arange(64))
    # spot values from T.81 Figure A.6
    assert tables.ZIGZAG_TO_NATURAL[0] == 0
    assert tables.ZIGZAG_TO_NATURAL[1] == 1
    assert tables.ZIGZAG_TO_NATURAL[2] == 8
    assert tables.ZIGZAG_TO_NATURAL[63] == 63


def test_quant_quality_50_is_base():
    q = tables.quant_table_zz(ComponentType.LUMINANCE, 50)
    assert np.array_equal(q, tables.DEFAULT_QUANT_LUMA_ZZ)


def test_quant_quality_100_is_ones():
    q = tables.quant_table_zz(ComponentType.LUMINANCE, 100)
    assert q.min() >= 1
    assert q.max() == 1  # s=0 -> all entries round to 0 -> clamped to 1


def test_quant_quality_scaling_matches_reference_formula():
    for quality in (1, 10, 25, 49, 50, 75, 90, 99, 100):
        s = (5000 // quality) if quality < 50 else (200 - 2 * quality)
        expect = np.clip((s * tables.DEFAULT_QUANT_CHROMA_ZZ + 50) // 100, 1, 255)
        got = tables.quant_table_zz(ComponentType.CHROMINANCE, quality)
        assert np.array_equal(got, expect), quality


def test_huffman_code_lengths_annexk():
    t = tables.default_huffman_table(ComponentType.LUMINANCE, HuffmanType.DC)
    # T.81 Table K.3: DC luma symbol 0 has code 00 (2 bits)
    assert t.ehufsi[0] == 2 and t.ehufco[0] == 0b00
    # symbol 11 has the longest code: 9 bits, 111111110
    assert t.ehufsi[11] == 9 and t.ehufco[11] == 0b111111110

    ac = tables.default_huffman_table(ComponentType.LUMINANCE, HuffmanType.AC)
    # T.81 Table K.5: EOB (0x00) = 1010 (4 bits), ZRL (0xF0) = 11111111001 (11)
    assert ac.ehufsi[0x00] == 4 and ac.ehufco[0x00] == 0b1010
    assert ac.ehufsi[0xF0] == 11 and ac.ehufco[0xF0] == 0b11111111001
    # 0x01 (run 0, size 1) = 00 (2 bits)
    assert ac.ehufsi[0x01] == 2 and ac.ehufco[0x01] == 0b00

    acc = tables.default_huffman_table(ComponentType.CHROMINANCE, HuffmanType.AC)
    # K.6: EOB = 00 (2 bits), ZRL = 1111111010 (10 bits)
    assert acc.ehufsi[0x00] == 2 and acc.ehufco[0x00] == 0b00
    assert acc.ehufsi[0xF0] == 10 and acc.ehufco[0xF0] == 0b1111111010


def test_huffman_lut16_agrees_with_serial_tables():
    for ct in ComponentType:
        for ht in HuffmanType:
            t = tables.default_huffman_table(ct, ht)
            # every symbol decodes back through the LUT
            n = t.n_values
            for i in range(n):
                sym = int(t.values[i])
                size = int(t.ehufsi[sym])
                code = int(t.ehufco[sym])
                peek = code << (16 - size)
                entry = int(t.lut16[peek])
                assert entry & 0xFF == size
                assert entry >> 8 == sym


def test_default_tables_match_pil_libjpeg_stream():
    """PIL (libjpeg) writes the Annex-K default tables when optimize=False;
    our DHT/DQT must parse back to the same bits/values."""
    from gpujpeg_jax.stream.reader import read_image

    img = Image.fromarray(np.zeros((64, 64, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=50, subsampling=0)
    info = read_image(buf.getvalue())

    # quality 50 == base tables in libjpeg's scaling too
    got_luma = info.quant_tables[0]
    assert np.array_equal(got_luma, tables.DEFAULT_QUANT_LUMA_ZZ)

    for (tc, th), table in info.huffman_tables.items():
        ct = ComponentType(th) if th <= 1 else None
        ht = HuffmanType(tc)
        ours = tables.default_huffman_table(ComponentType(th), ht)
        assert np.array_equal(table.bits, ours.bits), (tc, th)
        assert np.array_equal(table.values, ours.values), (tc, th)


def test_dct_matrix_orthonormal():
    D = tables.dct8_matrix()
    assert np.allclose(D @ D.T, np.eye(8), atol=1e-12)


def test_fdct_idct_roundtrip_lossless_at_q1_tables():
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (32, 64)).astype(np.uint8)
    ones = np.ones(64, dtype=np.int32)
    coeff = golden.fdct_quant(blocks, ones)
    back = golden.dequant_idct(coeff, ones)
    # with quant=1 the only loss is coefficient rounding: max error 1
    assert np.abs(back.astype(int) - blocks).max() <= 1


def test_suggest_restart_interval_quality_aware():
    """The suggestion depends on the image geometry alone: every quality
    of a sweep gets the same interval (the device encode has no
    quality-dependent kernel eligibility to protect). pow2 rounds the
    reference heuristic (gpujpeg_encoder.c:256-283) to the nearest power
    of two for the entropy stage's merge tree."""
    from gpujpeg_jax.params import ImageParameters, suggest_restart_interval
    from gpujpeg_jax.types import ColorSpace, PixelFormat
    import inspect
    assert "quality" not in inspect.signature(
        suggest_restart_interval).parameters
    img = ImageParameters(width=7680, height=4320,
                          color_space=ColorSpace.RGB,
                          pixel_format=PixelFormat.PF_444_U8_P012)
    # reference: 12 MCUs x 3 components at > 9 Mpix; pow2 -> 32
    assert suggest_restart_interval(img, subsampled=False,
                                    interleaved=False) == 36
    assert suggest_restart_interval(img, subsampled=False,
                                    interleaved=False, pow2=True) == 32
    # interleaved 4:2:0 halves the interval (12 -> 6; a tie rounds
    # down: pow2 -> 4)
    assert suggest_restart_interval(img, subsampled=True,
                                    interleaved=True) == 6
    assert suggest_restart_interval(img, subsampled=True, interleaved=True,
                                    pow2=True) == 4
    hd = ImageParameters(width=1920, height=1080,
                         color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.PF_444_U8_P012)
    assert suggest_restart_interval(hd, subsampled=False, interleaved=False,
                                    pow2=True) == 16   # 8 x 3 = 24 -> 16
