"""Quality oracles — the analog of the reference's colors/ suite
(colors/run_tests.sh: 6 configs, Q100 round trip, PSNR >= 40 dB,
test_common.sh:17) and the quality/size table (README.md:147-167)."""
import numpy as np
import pytest

from gpujpeg_jax.models.decoder import Decoder
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat

from conftest import make_natural_rgb, make_test_rgb, psnr


def _roundtrip(img, params, image, out_cs=None, out_pf=None):
    enc = Encoder(backend="jax")
    data = enc.encode(img.reshape(-1), params, image)
    dec = Decoder(backend="jax")
    dec.set_output_format(out_cs or image.color_space,
                          out_pf or image.pixel_format)
    raw, oi = dec.decode(data)
    return raw, data


# the reference's 6 color configs, mapped to our surface
CONFIGS = [
    # (pixel format, color space, subsampling, interleaved)
    (PixelFormat.PF_444_U8_P012, ColorSpace.RGB, 444, False),
    (PixelFormat.PF_444_U8_P012A, ColorSpace.RGB, 444, False),
    (PixelFormat.PF_444_U8_P0P1P2, ColorSpace.YCBCR_BT601_256LVLS, 444, False),
    (PixelFormat.PF_422_U8_P1020, ColorSpace.YCBCR_BT709, 422, False),
    (PixelFormat.PF_420_U8_P0P1P2, ColorSpace.YCBCR_BT601_256LVLS, 420, True),
    (PixelFormat.PF_422_U8_P0P1P2, ColorSpace.YCBCR_BT601, 422, True),
]


@pytest.mark.parametrize("pf,cs,sub,interleaved", CONFIGS)
def test_q100_roundtrip_psnr(pf, cs, sub, interleaved):
    """Q100 round trip must reach >= 40 dB on every config, subsampled
    included, on a 1080p-class natural-statistics frame (reference
    oracle: colors/test_common.sh:17 on a 1920x1080 camera fixture)."""
    from gpujpeg_jax.ops.preprocess import pack_raw, unpack_raw
    from gpujpeg_jax.ops.colorspace import transform

    H, W = 1080, 1920
    rgb = make_natural_rgb(H, W, seed=11)
    image = ImageParameters(width=W, height=H, color_space=cs, pixel_format=pf)
    # build the raw test frame in the target space/format
    chans = [rgb[:, :, c].astype(np.int32) for c in range(3)]
    chans = transform(chans, ColorSpace.RGB, cs, np)
    if pf == PixelFormat.PF_444_U8_P012A:
        chans = chans + [np.full((H, W), 255, np.int32)]
    raw = pack_raw(chans, image, np)

    params = Parameters(quality=100, restart_interval=2,
                        interleaved=interleaved).with_chroma_subsampling(sub)
    out, data = _roundtrip(raw, params, image)

    # compare in RGB like the reference (FFmpeg convert-back step)
    chans2 = unpack_raw(out, image, np)
    rgb2 = transform(chans2[:3], cs, ColorSpace.RGB, np)
    rgb2 = np.stack(rgb2, axis=-1)
    q = psnr(rgb, rgb2)
    assert q >= 40.0, f"PSNR {q:.1f} < 40 for {pf} {cs}"


def test_quality_size_monotonic():
    """Higher quality -> larger stream and higher PSNR
    (reference table: README.md:147-167)."""
    H, W = 96, 128
    img = make_test_rgb(H, W, seed=3)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    sizes, quals = [], []
    for q in (10, 30, 50, 75, 90, 100):
        params = Parameters(quality=q, restart_interval=4)
        out, data = _roundtrip(img, params, image)
        sizes.append(len(data))
        quals.append(psnr(img, out.reshape(H, W, 3)))
    assert all(a < b for a, b in zip(sizes, sizes[1:])), sizes
    assert all(a <= b + 0.3 for a, b in zip(quals, quals[1:])), quals
    assert quals[0] > 24 and quals[-1] > 40


def test_grayscale_roundtrip():
    H, W = 48, 48
    img = make_test_rgb(H, W, seed=5)[:, :, 0]
    image = ImageParameters(width=W, height=H,
                            color_space=ColorSpace.YCBCR_BT601_256LVLS,
                            pixel_format=PixelFormat.U8)
    out, data = _roundtrip(img, Parameters(quality=90, restart_interval=2),
                           image)
    assert psnr(img, out.reshape(H, W)) > 38


def test_decode_output_format_conversion():
    """Decode a 3-comp JPEG straight to RGBA with alpha fill 0xFF
    (reference: gpujpeg_postprocessor.cu:247-249)."""
    H, W = 32, 32
    img = make_test_rgb(H, W)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(
        img.reshape(-1), Parameters(quality=90, restart_interval=2), image)
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012A)
    raw, oi = dec.decode(data)
    rgba = raw.reshape(H, W, 4)
    assert (rgba[:, :, 3] == 255).all()
    assert psnr(img, rgba[:, :, :3]) > 30


def test_decoder_init_and_memory_helpers():
    """Decoder.init pre-initializes (reference: gpujpeg_decoder_init);
    Encoder.max_pixels/max_memory budget estimates round-trip."""
    from gpujpeg_jax import Decoder, Encoder
    params = Parameters(quality=80, restart_interval=4)
    image = ImageParameters(width=48, height=32, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    dec = Decoder(backend="jax")
    dec.init(params, image)
    img = make_test_rgb(32, 48)
    data = Encoder(backend="jax").encode(img.reshape(-1), params, image)
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    raw, out = dec.decode(data)
    assert raw.size == 32 * 48 * 3

    assert Encoder.max_memory(Encoder.max_pixels(1 << 30)) <= (1 << 30)
    Encoder().allocate(params, image)
