"""Corrupt-stream robustness, reformat tool, concurrency — analogs of the
reference's error-recovery guards (gpujpeg_reader.c:962-1046, sentinel
tables gpujpeg_table.h:64-83) and the mt_encode stress (test/misc/)."""
import concurrent.futures
import io

import numpy as np
import pytest
from PIL import Image

from gpujpeg_jax.models.decoder import Decoder
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.stream.reader import JpegParseError
from gpujpeg_jax.tools.reformat import reformat
from gpujpeg_jax.types import ColorSpace, PixelFormat

from conftest import make_test_rgb, psnr


def _sample_jpeg(H=48, W=64, ri=4, q=85):
    img = make_test_rgb(H, W)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(
        img.reshape(-1), Parameters(quality=q, restart_interval=ri), image)
    return img, data


def test_garbage_input_raises():
    with pytest.raises(JpegParseError):
        Decoder(backend="golden").decode(b"\x00" * 64)
    with pytest.raises(JpegParseError):
        Decoder(backend="golden").decode(b"")


def test_truncated_stream_no_crash():
    img, data = _sample_jpeg()
    # cut inside the entropy data: decoder must not crash; missing
    # segments decode to zeros (the reference resynchronizes similarly)
    for frac in (0.5, 0.8, 0.95):
        cut = data[:int(len(data) * frac)]
        try:
            raw, oi = Decoder(backend="golden").decode(cut)
            assert raw.size == oi.width * oi.height * 3
        except JpegParseError:
            pass  # a clean parse error is also acceptable


def test_corrupt_entropy_bytes_no_crash(rng):
    img, data = _sample_jpeg()
    buf = bytearray(data)
    # flip bytes in the scan body only (after SOS)
    sos = data.find(b"\xff\xda")
    for _ in range(20):
        i = rng.integers(sos + 20, len(buf) - 3)
        buf[i] ^= 0x55
    try:
        raw, oi = Decoder(backend="golden").decode(bytes(buf))
        assert raw.size == oi.width * oi.height * 3
    except JpegParseError:
        pass


def test_reformat_adds_segment_info_losslessly():
    img, data = _sample_jpeg(H=64, W=64, ri=2)
    # strip our own APP13 by re-encoding without segment_info (default) —
    # then reformat must add it back
    out = reformat(data)
    from gpujpeg_jax.stream.reader import get_image_info, read_image
    info = get_image_info(out)
    assert info.segment_info_found
    # PIL still decodes the reformatted stream identically
    a = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    b = np.asarray(Image.open(io.BytesIO(out)).convert("RGB"))
    np.testing.assert_array_equal(a, b)
    # and so do we
    r1, _ = Decoder(backend="golden").decode(data)
    r2, _ = Decoder(backend="golden").decode(out)
    np.testing.assert_array_equal(r1, r2)


def test_reformat_foreign_pil_jpeg():
    img = make_test_rgb(80, 96, seed=9)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=85, restart_marker_blocks=2)
    out = reformat(buf.getvalue())
    a = np.asarray(Image.open(io.BytesIO(out)).convert("RGB"))
    assert psnr(img, a) > 30


def test_concurrent_encoders():
    """Thread-safety of independent encoders (reference: mt_encode.c)."""
    H, W = 32, 48
    imgs = [make_test_rgb(H, W, seed=s) for s in range(8)]
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=80, restart_interval=2)

    def work(i):
        enc = Encoder(backend="golden")
        data = enc.encode(imgs[i].reshape(-1), params, image)
        raw, _ = Decoder(backend="golden").decode(data)
        return psnr(imgs[i], raw.reshape(H, W, 3))

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(work, range(8)))
    assert all(q > 30 for q in results), results


def test_missing_segment_decodes_zeros():
    """Dropping a whole restart segment must not shift the others
    (per-segment independence, the core RST invariant)."""
    img, data = _sample_jpeg(H=64, W=64, ri=2)
    # find the first RST marker in the scan and excise one segment
    sos = data.find(b"\xff\xda")
    first_rst = data.find(b"\xff\xd0", sos)
    second_rst = data.find(b"\xff\xd1", first_rst)
    if second_rst < 0:
        pytest.skip("stream too small")
    cut = data[:first_rst + 2] + data[second_rst + 2:]
    raw, oi = Decoder(backend="golden").decode(cut)
    assert raw.size == oi.width * oi.height * 3


def test_rst_resync_out_of_order():
    """An out-of-order RST sequence must trigger forward resync, not
    silent segment misassignment (reference: gpujpeg_reader.c:962-996).
    Duplicating one segment+RST pair makes the duplicate's marker
    unexpected; the resync should skip the duplicated span and keep all
    later segments aligned."""
    img, data = _sample_jpeg(H=64, W=64, ri=2, q=85)
    sos = data.find(b"\xff\xda")
    r0 = data.find(b"\xff\xd0", sos)
    r1 = data.find(b"\xff\xd1", r0)
    assert r0 > 0 and r1 > 0
    # duplicate segment 1 (between RST0 and RST1) *including* its RST1:
    # stream now reads ... RST0 seg1 RST1 seg1 RST1 seg2 ... — the second
    # RST1 is unexpected (expected RST2), resync scans forward to RST2.
    dup = data[r0 + 2:r1 + 2]
    corrupted = data[:r1 + 2] + dup + data[r1 + 2:]
    raw, oi = Decoder(backend="golden").decode(corrupted)
    clean, _ = Decoder(backend="golden").decode(data)
    # resync semantics: the bogus span is dropped, all later segments
    # decode from their true data -> image identical except possibly the
    # segments adjacent to the corruption
    diff_rows = np.any(
        raw.reshape(64, 64, 3) != clean.reshape(64, 64, 3), axis=(1, 2))
    assert diff_rows.sum() <= 16, f"{diff_rows.sum()} rows differ"


def test_rst_resync_expected_never_found():
    """If the expected RST never appears, the mismatched RST is ignored
    (not a boundary) and decode must not crash."""
    img, data = _sample_jpeg(H=32, W=32, ri=2, q=85)
    sos = data.find(b"\xff\xda")
    r0 = data.find(b"\xff\xd0", sos)
    assert r0 > 0
    # corrupt RST0 -> RST5: expected RST0 never appears
    buf = bytearray(data)
    buf[r0 + 1] = 0xD5
    raw, oi = Decoder(backend="golden").decode(bytes(buf))
    assert raw.size == oi.width * oi.height * 3


def test_restart_interval_zero_device_backend():
    """restart_interval == 0 must route to the host Huffman coder even on
    the device backend (reference: gpujpeg_encoder.c:437-446)."""
    from PIL import Image as _Image
    H, W = 48, 64
    img = make_test_rgb(H, W)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="jax").encode(
        img.reshape(-1), Parameters(quality=85, restart_interval=0), image)
    # DRI is still emitted (value 0, like the reference's writer), but the
    # scan body must contain no RST markers
    scan = data.split(b"\xff\xda", 1)[1]
    assert not any(scan.find(bytes((0xFF, 0xD0 + i))) >= 0 for i in range(8))
    pil = np.asarray(_Image.open(io.BytesIO(data)).convert("RGB"))
    assert psnr(img, pil) > 30


def test_decode_batch_corrupt_frame_raises_and_recovers():
    """A corrupt stream mid-batch raises JpegParseError (parse happens
    at launch time) and must leave the decoder usable: the deferred-sync
    flag is restored so later decodes run normally."""
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import ImageParameters, Parameters
    from gpujpeg_jax.stream.reader import JpegParseError
    from gpujpeg_jax.types import ColorSpace, PixelFormat
    from conftest import make_test_rgb

    h, w = 32, 48
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    with pytest.raises(JpegParseError):
        dec.decode_batch([data, b"\xff\xd8garbage", data])
    assert not getattr(dec, "_defer_sync", False)
    raw, _ = dec.decode(data)        # decoder still works
    assert raw.size == h * w * 3


def test_fuzz_mutated_streams_never_crash():
    """Seeded mini-fuzz: byte flips/drops/inserts anywhere in a valid
    stream must produce a successful decode or JpegParseError — never an
    internal IndexError/KeyError/assert. (The full fuzz campaign that
    drove the reader's validation hardening ran 16k+ mutations; this
    keeps a fast regression tripwire.)"""
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import ImageParameters, Parameters
    from gpujpeg_jax.stream.reader import JpegParseError
    from gpujpeg_jax.types import ColorSpace, PixelFormat
    from conftest import make_test_rgb

    h, w = 48, 64
    img = make_test_rgb(h, w)
    params = Parameters(quality=85, restart_interval=4)
    image = ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img.reshape(-1), params, image)
    dec = Decoder(backend="golden")
    dec.set_output_format(ColorSpace.RGB, PixelFormat.PF_444_U8_P012)
    rng = np.random.default_rng(20260818)
    for _ in range(200):
        buf = bytearray(data)
        for _ in range(rng.integers(1, 6)):
            kind = rng.integers(0, 3)
            pos = int(rng.integers(2, len(buf)))
            if kind == 0:
                buf[pos] = int(rng.integers(0, 256))
            elif kind == 1:
                del buf[pos]
            else:
                buf.insert(pos, int(rng.integers(0, 256)))
        try:
            dec.decode(bytes(buf))
        except JpegParseError:
            pass

def test_corrupt_seginfo_offsets_fall_back_to_byte_parse():
    """APP13 segment-info whose offsets collide (diff < 2 where an RST
    marker must sit) must be rejected so the byte-parse splitter runs —
    not produce negative-length segments (reference validates seginfo
    consistency the same way it validates RST sequences,
    gpujpeg_reader.c:1058-1126)."""
    img, _ = _sample_jpeg(H=64, W=64, ri=2)
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import ImageParameters, Parameters
    from gpujpeg_jax.types import ColorSpace, PixelFormat
    p = Parameters(quality=85, restart_interval=2, segment_info=True)
    im = ImageParameters(width=64, height=64, color_space=ColorSpace.RGB,
                         pixel_format=PixelFormat.PF_444_U8_P012)
    data = Encoder(backend="golden").encode(img, p, im)
    ref, _ = Decoder(backend="golden").decode(data)

    # corrupt the first APP13 seginfo payload: make offset[1] == offset[0]
    buf = bytearray(data)
    i = buf.find(bytes([0xFF, 0xED]))
    assert i >= 0
    # marker(2) + length(2) + scan_index(1), then big-endian u32 offsets
    off0 = buf[i + 5:i + 9]
    buf[i + 9:i + 13] = off0
    raw, oi = Decoder(backend="golden").decode(bytes(buf))
    np.testing.assert_array_equal(raw, ref)
