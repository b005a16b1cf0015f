"""Smoke test of the codec on an NVIDIA GPU, through the public API.

Phases (each one raises, and the script exits non-zero, on a failed
check):

1. Encode 8K: 7680x4320 RGB 4:4:4 Q75, ri=32 (suggest_restart_interval,
   pow2) through ``Encoder(backend="jax")``. Checks the device route
   served the frame with no host route, the stream parses, re-encoding
   the device's own quantized coefficients with the native host entropy
   coder gives identical bytes, the coefficients match the golden f64
   DCT (at most 1e-5 of them differ, each by exactly 1), and the golden
   decoder's PSNR of the device stream is within 0.05 dB of the golden
   encoder's own round trip. Prints the staged per-stage split, where
   the staged wall goes, and the steady-state encode times.
2. Decode 8K, and a golden-encoded 4K interleaved 4:2:0 stream with
   restart markers, through ``Decoder(backend="jax")``: Huffman
   coefficients bit-exact against the native decoder, pixels within 1
   LSB of the golden decode at no more than 1e-4 of pixels. Prints the
   decode times, where the staged decode wall goes, and the Huffman
   kernel against the XLA lockstep decoder (``huffman_decode_kernel``),
   timed in turns in this process.
3. Batch: 8 HD frames through ``encode_batch`` and ``decode_batch``,
   each frame identical to its per-frame result.

``--four-cards`` runs only the sharded phase instead: ``ShardedEncoder``
/ ``ShardedDecoder`` on a (1, 4) mesh at 16K (15360x8640, Q75), compared
with single-card encode and decode in the same process.

The last line of standard output is one JSON object with the device as
JAX reports it. Without a GPU, or without the repository beside it, the
script exits non-zero and prints no result.

Run from the repository root:  python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: (height, width) of each phase's frames
FLAGSHIP = (4320, 7680)      # 8K, 4:4:4
INTERLEAVED = (2160, 3840)   # 4K, interleaved 4:2:0
BATCH = (1080, 1920)         # HD video frames
SHARDED = (8640, 15360)      # 16K across four cards


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def synth_rgb(h: int, w: int, seed: int):
    """Seeded synthetic photo-like RGB frame (smooth structure + noise)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    ph = float(seed)
    img = np.empty((h, w, 3), np.float32)
    img[..., 0] = 128 + 90 * np.sin(x / 23.0 + ph) * np.cos(y / 17.0)
    img[..., 1] = 128 + 80 * np.cos(x / 31.0 + 1.0) * np.sin(y / 11.0 + ph)
    img[..., 2] = 128 + 70 * np.sin((x + y) / 41.0)
    img += rng.normal(0.0, 6.0, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def timed(fn, n: int):
    """Median and quartiles (ms) of n timed calls; fn must block."""
    import numpy as np
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    q1, med, q3 = np.percentile(ts, [25, 50, 75])
    return float(med), float(q1), float(q3)


def fmt(t) -> str:
    return f"{t[0]:.3f} ms (q1 {t[1]:.3f}, q3 {t[2]:.3f})"


def psnr(a, b) -> float:
    import numpy as np
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def image_params(w: int, h: int):
    from gpujpeg_jax.params import ImageParameters
    from gpujpeg_jax.types import ColorSpace, PixelFormat
    return ImageParameters(width=w, height=h, color_space=ColorSpace.RGB,
                           pixel_format=PixelFormat.PF_444_U8_P012)


def stream_parts(data: bytes):
    from gpujpeg_jax.models.decoder import Decoder, huffman_maps
    from gpujpeg_jax.stream import reader
    info = reader.read_image(data)
    plan, scan_data, segs = Decoder(backend="golden")._plan_from_info(info)
    dcm, acm = huffman_maps(info)
    return info, plan, scan_data, segs, dcm, acm


def check_decode(dec, data: bytes, label: str):
    """Device decode of ``data``: Huffman coefficients bit-exact against
    the native decoder, pixels within 1 LSB of the golden decode."""
    import jax
    import numpy as np
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.native import decode_segments_native

    hosted = dec.stats.host_frames
    dec.capture_device_call = True
    raw, oi = dec.decode(data)
    check(dec.stats.host_frames == hosted,
          f"{label}: decode took the host route")
    fn, (frame, consts, Ws) = dec.last_device_call
    coeff_plane = np.asarray(jax.block_until_ready(
        fn.stages[0](frame, consts)))
    info, plan, scan_data, segs, dcm, acm = stream_parts(data)
    ref_scan = decode_segments_native(plan, scan_data, segs, dcm, acm)
    check(ref_scan is not None, "native host codec unavailable")
    ref_plane = np.empty_like(ref_scan)
    ref_plane[plan.block_plane_idx] = ref_scan
    n_bad = int((coeff_plane != ref_plane).any(axis=1).sum())
    check(n_bad == 0, f"{label}: {n_bad} blocks' coefficients differ")
    gold, _ = Decoder(backend="golden").decode(data)
    diff = np.abs(raw.astype(np.int32) - gold.astype(np.int32))
    frac = float((diff != 0).mean())
    print(f"{label}: huffman coefficients bit-exact ({plan.n_blocks} "
          f"blocks); pixels vs golden: max |diff| {int(diff.max())}, "
          f"{frac:.3e} of pixels differ")
    check(diff.max() <= 1 and frac <= 1e-4,
          f"{label}: pixels off the golden decode")
    return raw


def phase_encode(img, params, image):
    import jax
    import numpy as np
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.native import encode_segments_native
    from gpujpeg_jax.ops import golden
    from gpujpeg_jax.ops import jax_pipeline as jp
    from gpujpeg_jax.ops.blocks import plane_to_blocks
    from gpujpeg_jax.ops.preprocess import preprocess
    from gpujpeg_jax.plan import make_plan
    from gpujpeg_jax.stream import reader
    from gpujpeg_jax.types import HuffmanType

    raw = img.reshape(-1)
    enc = Encoder(backend="jax")
    t0 = time.perf_counter()
    data = enc.encode(raw, params, image)
    print(f"encode 8K: first call (compile) {time.perf_counter() - t0:.2f} s,"
          f" {len(data)} bytes, ri={params.restart_interval}")
    ctx = jp._ENC_CACHE[(params, image)]
    check(enc.stats.host_frames == 0, "encode took a host route")
    check(ctx.routes["encode"] == "xla" and ctx.fn.kind == "staged",
          f"unexpected encode route {ctx.routes} / {ctx.fn.kind}")
    reader.read_image(data)

    t_e2e = timed(lambda: enc.encode(raw, params, image), 5)
    raw_j = jax.block_until_ready(jax.numpy.asarray(raw))
    t_dev = timed(lambda: jax.block_until_ready(ctx.fn(raw_j)), 10)
    check(enc.stats.host_frames == 0, "encode took a host route")
    stats = []
    staged = dataclasses.replace(params, perf_stats=True)
    enc.encode(raw, staged, image)      # compiles the staged executables
    for _ in range(5):
        t0 = time.perf_counter()
        enc.encode(raw, staged, image)
        s = enc.stats
        stats.append(((time.perf_counter() - t0) * 1e3,
                      s.duration_memory_to, s.duration_preprocessor,
                      s.duration_dct_quantization, s.duration_huffman_coder,
                      s.duration_memory_from, s.duration_stream))
    wall, h2d, pre, dct, ent, d2h, stream = np.median(np.asarray(stats),
                                                      axis=0)
    print(f"encode 8K end to end (host pixels -> JPEG bytes): {fmt(t_e2e)}")
    print(f"encode 8K device pipeline (block_until_ready): {fmt(t_dev)}")
    print(f"encode 8K staged split (median of 5): pre {pre:.3f} ms, "
          f"dct+quant {dct:.3f} ms, entropy {ent:.3f} ms")
    print(f"encode 8K staged wall {wall:.3f} ms: H2D {h2d:.3f}, device "
          f"stages {pre + dct + ent:.3f}, compaction+D2H {d2h:.3f}, stream "
          f"{stream:.3f}, other host "
          f"{wall - h2d - pre - dct - ent - d2h - stream:.3f} ms")
    print(f"encode 8K tier-2 context built: {ctx._tier2 is not None}")

    # the device's own quantized coefficients, in scan order
    plan = make_plan(params, image)
    s_pre, s_dct, _ = ctx._stage_fns
    dct_args, _ = ctx._stage_args
    rows = np.asarray(s_dct(s_pre(raw_j), *dct_args))
    idx = np.asarray(ctx.geo.coeff_idx)
    real = idx < plan.n_blocks
    dev_scan = np.zeros((plan.n_blocks, 64), np.int32)
    dev_scan[idx[real]] = rows[real]

    quant_zz, huff = enc._tables(params)
    dcm = [huff[(c.comp_type, HuffmanType.DC)] for c in plan.components]
    acm = [huff[(c.comp_type, HuffmanType.AC)] for c in plan.components]
    seg_bytes = encode_segments_native(plan, dev_scan, dcm, acm)
    check(seg_bytes is not None, "native host codec unavailable")
    host_stream = enc._assemble(plan, quant_zz, huff,
                                *Encoder._to_scan_bodies(plan, seg_bytes))
    check(host_stream == data,
          "device entropy bytes differ from the host coder's on the "
          "device's own coefficients")
    print("encode 8K: entropy bytes identical to the native host coder "
          "on the device's coefficients")

    planes = preprocess(raw, image, plan, np)
    gold_plane = np.concatenate([
        golden.fdct_quant(plane_to_blocks(planes[c.index], np),
                          quant_zz[c.quant_table_index])
        for c in plan.components])
    gold_scan = gold_plane[plan.block_plane_idx]
    diff = np.abs(dev_scan.astype(np.int64) - gold_scan)
    n_diff = int((diff != 0).sum())
    frac = n_diff / diff.size
    print(f"encode 8K: {n_diff} of {diff.size} coefficients differ from "
          f"the golden f64 DCT ({frac:.3e}), max |diff| {int(diff.max())}")
    check(frac <= 1e-5 and diff.max() <= 1,
          "device DCT+quant off the golden f64 operator")

    gold_stream = Encoder(backend="golden").encode(raw, params, image)
    from gpujpeg_jax.models.decoder import Decoder
    gdec = Decoder(backend="golden")
    p_dev = psnr(gdec.decode(data)[0], raw)
    p_gold = psnr(gdec.decode(gold_stream)[0], raw)
    print(f"encode 8K: PSNR of the device stream {p_dev:.4f} dB, golden "
          f"encoder {p_gold:.4f} dB")
    check(abs(p_dev - p_gold) <= 0.05, "PSNR off the golden round trip")
    return data


def phase_decode(data, image):
    import jax
    import numpy as np
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import Parameters, suggest_restart_interval

    dec = Decoder(backend="jax")
    check(dec.routes["huffman_decode"] == "kernel",
          f"unexpected decode route {dec.routes}")
    t0 = time.perf_counter()
    dec.decode(data)
    print(f"decode 8K: first call (compile) {time.perf_counter() - t0:.2f} s")
    check_decode(dec, data, "decode 8K")

    # the Huffman kernel against the XLA lockstep decoder, in turns
    xdec = Decoder(backend="jax")
    xdec.routes = dict(xdec.routes, huffman_decode="xla")
    xdec.capture_device_call = True
    xdec.decode(data)
    check_decode(xdec, data, "decode 8K (xla route)")
    kfn, kargs = dec.last_device_call
    xfn, xargs = xdec.last_device_call
    runs = {"kernel": {"wall": [], "device": [], "huffman": []},
            "xla": {"wall": [], "device": [], "huffman": []}}
    order = ("kernel", "xla", "xla", "kernel")
    for _ in range(3):
        for route in order:
            d, fn, args = ((dec, kfn, kargs) if route == "kernel"
                           else (xdec, xfn, xargs))
            r = runs[route]
            r["wall"].append(timed(lambda: d.decode(data), 1)[0])
            r["device"].append(timed(
                lambda: jax.block_until_ready(fn(*args)), 1)[0])
            r["huffman"].append(timed(lambda: jax.block_until_ready(
                fn.stages[0](args[0], args[1])), 1)[0])
    for route in ("kernel", "xla"):
        med = {k: float(np.median(v)) for k, v in runs[route].items()}
        print(f"decode 8K Q75 {route:6s}: wall {med['wall']:.3f} ms, "
              f"device {med['device']:.3f} ms, huffman stage "
              f"{med['huffman']:.3f} ms (medians of "
              f"{len(runs[route]['wall'])}, in turns)")
    check(dec.stats.host_frames == 0, "decode took the host route")

    # where the decode wall goes: the staged (perf_stats) run syncs after
    # each stage; "other host" is parse-to-upload prep (plan, row build)
    pdec = Decoder(backend="jax", perf_stats=True)
    pdec.decode(data)
    splits = []
    for _ in range(5):
        t0 = time.perf_counter()
        pdec.decode(data)
        s = pdec.stats
        splits.append(((time.perf_counter() - t0) * 1e3, s.duration_stream,
                       s.duration_memory_to, s.duration_huffman_coder,
                       s.duration_dct_quantization, s.duration_postprocessor,
                       s.duration_memory_from))
    wall, parse, h2d, huf, idct, post, d2h = np.median(np.asarray(splits),
                                                       axis=0)
    print(f"decode 8K staged wall {wall:.3f} ms: parse {parse:.3f}, H2D "
          f"{h2d:.3f}, huffman {huf:.3f}, dequant+idct {idct:.3f}, post "
          f"{post:.3f}, D2H {d2h:.3f}, other host "
          f"{wall - parse - h2d - huf - idct - post - d2h:.3f} ms "
          f"(median of 5)")

    # golden-encoded 4K interleaved 4:2:0 stream with restart markers
    img4 = synth_rgb(*INTERLEAVED, seed=42)
    image4 = image_params(INTERLEAVED[1], INTERLEAVED[0])
    ri4 = suggest_restart_interval(image4, subsampled=True,
                                   interleaved=True, pow2=True)
    params4 = Parameters(quality=75, restart_interval=ri4,
                         interleaved=True).with_chroma_subsampling(420)
    data4 = Encoder(backend="golden").encode(img4.reshape(-1), params4,
                                             image4)
    check(b"\xff\xdd" in data4, "4K stream has no restart interval")
    dec4 = Decoder(backend="jax")
    dec4.decode(data4)
    check_decode(dec4, data4, f"decode 4K interleaved 4:2:0 ri={ri4}")
    print(f"decode 4K 4:2:0 end to end: "
          f"{fmt(timed(lambda: dec4.decode(data4), 5))}")


def phase_batch():
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import Parameters, suggest_restart_interval
    import numpy as np

    image = image_params(BATCH[1], BATCH[0])
    params = Parameters(quality=75, restart_interval=suggest_restart_interval(
        image, False, False, pow2=True))
    frames = [synth_rgb(*BATCH, seed=100 + i).reshape(-1)
              for i in range(8)]
    enc = Encoder(backend="jax")
    outs = enc.encode_batch(frames, params, image)
    singles = [enc.encode(f, params, image) for f in frames]
    check(outs == singles, "encode_batch differs from per-frame encodes")
    check(enc.stats.host_frames == 0, "batch encode took a host route")
    dec = Decoder(backend="jax")
    got = dec.decode_batch(outs)
    for i, ((raw, _), data) in enumerate(zip(got, outs)):
        check(np.array_equal(raw, dec.decode(data)[0]),
              f"decode_batch frame {i} differs from its per-frame decode")
    check(dec.stats.host_frames == 0, "batch decode took the host route")
    t_enc = timed(lambda: enc.encode_batch(frames, params, image), 3)
    t_dec = timed(lambda: dec.decode_batch(outs), 3)
    print(f"batch 8 x HD: encode_batch {fmt(t_enc)}, decode_batch "
          f"{fmt(t_dec)}; every frame identical to per-frame results")


def phase_four_cards(devs):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from gpujpeg_jax.models.decoder import Decoder
    from gpujpeg_jax.models.encoder import Encoder
    from gpujpeg_jax.params import Parameters
    from gpujpeg_jax.parallel import ShardedDecoder, ShardedEncoder
    from gpujpeg_jax.parallel.sharded import choose_restart_interval

    check(len(devs) >= 4, f"--four-cards needs 4 GPUs, JAX sees {len(devs)}")
    mesh = Mesh(np.array(devs[:4]).reshape(1, 4), ("frame", "seg"))
    h, w = SHARDED
    img = synth_rgb(h, w, seed=16)
    image = image_params(w, h)
    params = Parameters(quality=75)
    params = dataclasses.replace(
        params, restart_interval=choose_restart_interval(params, image, 4))

    senc = ShardedEncoder(mesh)
    t0 = time.perf_counter()
    got = senc.encode(img, params, image)
    print(f"sharded encode 16K: first call {time.perf_counter() - t0:.2f} s,"
          f" {len(got)} bytes, ri={params.restart_interval}")
    bands = senc.last_device_call[1][0]
    placed = sorted({(s.device.id, s.index[1].start)
                     for s in bands.addressable_shards})
    print(f"sharded encode band placement (device, band): {placed}")
    check(len({d for d, _ in placed}) == 4,
          "band inputs are not spread over the four cards")
    enc = Encoder(backend="jax")
    want = enc.encode(img.reshape(-1), params, image)
    check(enc.stats.host_frames == 0, "single-card encode took a host route")
    if got == want:
        print("sharded encode 16K: bytes identical to the single-card "
              "encoder")
    else:
        print(f"sharded encode 16K: bytes DIFFER from single card "
              f"({len(got)} vs {len(want)} bytes)")
    t_s = timed(lambda: senc.encode(img, params, image), 3)
    t_1 = timed(lambda: enc.encode(img.reshape(-1), params, image), 3)
    print(f"encode 16K end to end: sharded x4 {fmt(t_s)}; single card "
          f"{fmt(t_1)}")

    sdec = ShardedDecoder(mesh)
    raw_s, _ = sdec.decode(want)
    frames = sdec.last_device_call[1][0]
    placed = sorted({s.device.id for s in frames.addressable_shards})
    check(len(placed) == 4, "decode band inputs are not on four cards")
    dec = Decoder(backend="jax")
    raw_1, _ = dec.decode(want)
    diff = np.abs(raw_s.astype(np.int32) - raw_1.astype(np.int32))
    print(f"sharded decode 16K vs single card: max |diff| "
          f"{int(diff.max())}, {int((diff != 0).sum())} pixels differ")
    t_s = timed(lambda: sdec.decode(want), 3)
    t_1 = timed(lambda: dec.decode(want), 3)
    print(f"decode 16K end to end: sharded x4 {fmt(t_s)}; single card "
          f"{fmt(t_1)}")
    check(got == want, "sharded 16K stream differs from single card")
    check(diff.max() == 0, "sharded 16K pixels differ from single card")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 16K phase on four GPUs")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    try:
        import gpujpeg_jax
    except ImportError:
        fail("the gpujpeg_jax package is not beside this script")
    if os.path.dirname(os.path.dirname(os.path.abspath(
            gpujpeg_jax.__file__))) != HERE:
        fail("gpujpeg_jax was not imported from this checkout")
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        fail(f"no GPU: JAX's first device is {devs[0]!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip())
    print(devs)

    if args.four_cards:
        phase_four_cards(devs)
        count = 4
    else:
        from gpujpeg_jax.params import Parameters, suggest_restart_interval
        image = image_params(FLAGSHIP[1], FLAGSHIP[0])
        params = Parameters(quality=75, restart_interval=(
            suggest_restart_interval(image, False, False, pow2=True)))
        data = phase_encode(synth_rgb(*FLAGSHIP, seed=0), params, image)
        phase_decode(data, image)
        phase_batch()
        count = 1
    stats = devs[0].memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 0)} bytes")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
