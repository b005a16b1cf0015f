"""Image-file delegates: PNM/PAM/Y4M/raw round trips
(reference test analog: test/regression/run_tests.sh:37-50)."""
import numpy as np
import pytest

from gpujpeg_jax.params import ImageParameters
from gpujpeg_jax.types import ColorSpace, PixelFormat
from gpujpeg_jax.utils import image_io
from gpujpeg_jax.utils.image_io import FileFormat


def test_file_format_from_extension():
    assert image_io.image_get_file_format("x.jpg") == FileFormat.JPEG
    assert image_io.image_get_file_format("x.JPEG") == FileFormat.JPEG
    assert image_io.image_get_file_format("x.pnm") == FileFormat.PNM
    assert image_io.image_get_file_format("x.y4m") == FileFormat.Y4M
    assert image_io.image_get_file_format("x.i420") == FileFormat.I420
    assert image_io.image_get_file_format("x.r") == FileFormat.GRAY
    assert image_io.image_get_file_format("noext") == FileFormat.UNKNOWN


def test_ppm_round_trip(tmp_path, rng):
    H, W = 24, 17
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    path = str(tmp_path / "t.ppm")
    image_io.save_image(path, img.reshape(-1), ImageParameters(
        width=W, height=H, pixel_format=PixelFormat.PF_444_U8_P012))
    data, info = image_io.load_image(path)
    assert (info.width, info.height) == (W, H)
    assert info.pixel_format == PixelFormat.PF_444_U8_P012
    np.testing.assert_array_equal(data, img.reshape(-1))


def test_pgm_round_trip(tmp_path, rng):
    H, W = 16, 16
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    path = str(tmp_path / "t.pgm")
    image_io.save_image(path, img.reshape(-1), ImageParameters(
        width=W, height=H, pixel_format=PixelFormat.U8))
    data, info = image_io.load_image(path)
    assert info.pixel_format == PixelFormat.U8
    np.testing.assert_array_equal(data, img.reshape(-1))


def test_pam_alpha_round_trip(tmp_path, rng):
    H, W = 8, 8
    img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    path = str(tmp_path / "t.pam")
    image_io.save_image(path, img.reshape(-1), ImageParameters(
        width=W, height=H, pixel_format=PixelFormat.PF_444_U8_P012A))
    data, info = image_io.load_image(path)
    assert info.pixel_format == PixelFormat.PF_444_U8_P012A
    np.testing.assert_array_equal(data, img.reshape(-1))


def test_pnm_comment_and_probe(tmp_path):
    raw = b"P6\n# a comment\n10 5\n255\n" + bytes(10 * 5 * 3)
    path = tmp_path / "c.ppm"
    path.write_bytes(raw)
    info = image_io.image_get_properties(str(path))
    assert (info.width, info.height) == (10, 5)
    data, _ = image_io.load_image(str(path))
    assert data.size == 150


def test_pbm_bitmap(tmp_path):
    # 9x2 bitmap: row bytes = 2
    bits = bytes([0b10101010, 0b10000000, 0b01010101, 0b00000000])
    path = tmp_path / "b.pnm"
    path.write_bytes(b"P4\n9 2\n" + bits)
    data, info = image_io.load_image(str(path))
    assert info.pixel_format == PixelFormat.U8
    assert data.size == 18
    assert data[0] == 0 and data[1] == 255  # 1 = black in PBM


def test_plain_ascii_pnm_rejected(tmp_path):
    path = tmp_path / "a.pnm"
    path.write_bytes(b"P3\n1 1\n255\n1 2 3\n")
    with pytest.raises(ValueError, match="ASCII"):
        image_io.load_image(str(path))


def test_y4m_multiframe_round_trip(tmp_path, rng):
    H, W = 16, 32
    frames = [rng.integers(0, 256, W * H * 3 // 2, dtype=np.uint8)
              for _ in range(3)]
    info = image_io.Y4mInfo(width=W, height=H, subsampling=420)
    path = tmp_path / "v.y4m"
    path.write_bytes(image_io.y4m_write(info, frames))
    parsed, got = image_io.y4m_read_frames(path.read_bytes())
    assert parsed.frame_count == 3
    assert parsed.subsampling == 420
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a, b)
    probed = image_io.image_get_properties(str(path))
    assert probed.pixel_format == PixelFormat.PF_420_U8_P0P1P2
    assert probed.color_space == ColorSpace.YCBCR_BT601_256LVLS


def test_y4m_limited_range_and_mono(tmp_path):
    hdr = b"YUV4MPEG2 W8 H8 F25:1 Cmono XCOLORRANGE=LIMITED\nFRAME\n" + bytes(64)
    path = tmp_path / "m.y4m"
    path.write_bytes(hdr)
    data, info = image_io.load_image(str(path))
    assert info.pixel_format == PixelFormat.U8
    assert info.color_space == ColorSpace.YCBCR_BT601
    assert data.size == 64


def test_raw_probe():
    info = image_io.image_get_properties("frame.rgb", file_exists=False)
    assert info.pixel_format == PixelFormat.PF_444_U8_P012
    assert info.color_space == ColorSpace.RGB
    info = image_io.image_get_properties("frame.i420", file_exists=False)
    assert info.pixel_format == PixelFormat.PF_420_U8_P0P1P2
    assert info.color_space == ColorSpace.YCBCR_BT601_256LVLS
    info = image_io.image_get_properties("frame.r", file_exists=False)
    assert info.pixel_format == PixelFormat.U8
