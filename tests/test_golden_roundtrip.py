"""End-to-end golden (host) codec tests, cross-validated against PIL/libjpeg:

1. our encoder's output decodes correctly in PIL (stream validity oracle),
2. our decoder decodes PIL-encoded JPEGs (parser + entropy oracle),
3. our own round trip meets PSNR thresholds (color-math oracle, mirrors
   the reference's colors/ test recipe: PSNR >= 40 dB at Q100).
"""
import io

import numpy as np
import pytest
from PIL import Image

from gpujpeg_jax import (
    ColorSpace, Decoder, Encoder, ImageParameters, Parameters, PixelFormat,
)
from tests.conftest import make_test_rgb, psnr


def _encode(img, params, image_params):
    enc = Encoder(backend="golden")
    return enc.encode(img, params, image_params)


def _decode(data, **kw):
    dec = Decoder(backend="golden")
    return dec.decode(data)


# ---------------------------------------------------------------------------
# gray, 4:4:4, restart markers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("restart_interval", [0, 2, 8])
def test_gray_roundtrip_pil_oracle(restart_interval):
    h, w = 48, 64
    img = make_test_rgb(h, w)[:, :, 0].copy()
    params = Parameters(quality=90, restart_interval=restart_interval)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.U8)
    data = _encode(img.reshape(-1), params, image)

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("L"))
    assert pil.shape == (h, w)
    assert psnr(pil, img) > 38.0

    # our own decode agrees with PIL's (same stream, same coefficients;
    # IDCT rounding may differ by a hair)
    raw, out_image = _decode(data)
    ours = raw.reshape(h, w)
    assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 2
    assert psnr(ours, img) > 38.0


@pytest.mark.parametrize("quality", [50, 75, 100])
def test_rgb_444_noninterleaved_roundtrip(quality):
    h, w = 40, 56
    img = make_test_rgb(h, w)
    params = Parameters(quality=quality, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = _encode(img.reshape(-1), params, image)

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    raw, out_image = _decode(data)
    ours = raw.reshape(h, w, 3)
    assert out_image.pixel_format == PixelFormat.PF_444_U8_P012

    threshold = 40.0 if quality == 100 else 30.0
    assert psnr(pil, img) > threshold
    assert psnr(ours, img) > threshold
    # PIL and we decode the same stream: results should be very close
    # (different IDCT implementations)
    assert psnr(ours, pil) > 40.0


def test_rgb_interleaved_420():
    h, w = 64, 48
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=4, interleaved=True).with_chroma_subsampling(420)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = _encode(img.reshape(-1), params, image)

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 28.0

    raw, out_image = _decode(data)
    # decoder deduces 420 planar output; re-decode to RGB via explicit format
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    raw, out_image = dec.decode(data)
    ours = raw.reshape(h, w, 3)
    assert psnr(ours, img) > 28.0
    assert psnr(ours, pil) > 32.0


def test_rgb_interleaved_422_odd_size():
    h, w = 33, 49  # odd dims exercise padding + chroma edge clamp
    img = make_test_rgb(h, w)
    params = Parameters(quality=92, restart_interval=2, interleaved=True).with_chroma_subsampling(422)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = _encode(img.reshape(-1), params, image)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 28.0


def test_decode_pil_encoded_jpeg():
    """Foreign-stream decode: PIL/libjpeg encodes, we decode."""
    h, w = 56, 72
    img = make_test_rgb(h, w)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90, subsampling=0)
    data = buf.getvalue()

    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    raw, out_image = dec.decode(data)
    ours = raw.reshape(h, w, 3)
    assert out_image.width == w and out_image.height == h
    assert psnr(ours, pil) > 38.0


def test_decode_pil_420_jpeg():
    h, w = 64, 64
    img = make_test_rgb(h, w)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=85, subsampling=2)
    data = buf.getvalue()
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    raw, _ = dec.decode(data)
    ours = raw.reshape(h, w, 3)
    assert psnr(ours, pil) > 30.0


def test_segment_info_fast_path():
    """APP13 segment info: encode with it, decode splits in O(1)."""
    h, w = 40, 40
    img = make_test_rgb(h, w)
    params = Parameters(quality=80, restart_interval=2, segment_info=True)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = _encode(img.reshape(-1), params, image)

    from gpujpeg_jax.stream.reader import read_image
    info = read_image(data)
    assert info.segment_info_found

    raw, _ = _decode(data)
    assert psnr(raw.reshape(h, w, 3), img) > 28.0
    # PIL must still decode the stream despite the APP13 extension
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(pil, img) > 28.0


def test_colorspaces_roundtrip():
    """BT.601 limited / BT.709 internal color spaces survive a round trip
    (these emit SPIFF headers)."""
    h, w = 32, 32
    img = make_test_rgb(h, w)
    for cs in (ColorSpace.YCBCR_BT601, ColorSpace.YCBCR_BT709, ColorSpace.RGB):
        params = Parameters(quality=95, restart_interval=4,
                            color_space_internal=cs)
        image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                                pixel_format=PixelFormat.PF_444_U8_P012)
        data = _encode(img.reshape(-1), params, image)
        dec = Decoder(backend="golden")
        dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
        raw, _ = dec.decode(data)
        assert psnr(raw.reshape(h, w, 3), img) > 30.0, cs
