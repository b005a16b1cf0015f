"""Real multi-process distributed encode: 2 CPU processes x 4 virtual
devices each, spawned as subprocesses with a jax.distributed
coordinator. Output must be byte-identical to the single-process
encoder (SURVEY §2.3 north-star; BASELINE configs 4-5)."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat

from conftest import make_test_rgb

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); port = sys.argv[2]; outdir = sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_gpujpeg_jax")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
sys.path.insert(0, os.environ["GPUJPEG_REPO"])
sys.path.insert(0, os.path.join(os.environ["GPUJPEG_REPO"], "tests"))
from gpujpeg_jax.parallel.multihost import (
    MultiHostEncoder, MultiHostSingleImageEncoder, init_distributed)
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat
from conftest import make_test_rgb

init_distributed(f"localhost:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

H, W = 128, 160
image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                        pixel_format=PixelFormat.PF_444_U8_P012)
params = Parameters(quality=80, restart_interval=4)

# per-process frames (video sharding): process p owns frame p
frame = make_test_rgb(H, W, seed=10 + pid)
enc = MultiHostEncoder()
streams = enc.encode_my_frames([frame], params, image)
with open(os.path.join(outdir, f"frames_p{pid}.jpg"), "wb") as f:
    f.write(streams[0])

# one image across all 8 devices of both hosts
img = make_test_rgb(H, W, seed=42)
enc1 = MultiHostSingleImageEncoder()
data = enc1.encode(img, params, image)
with open(os.path.join(outdir, f"single_p{pid}.jpg"), "wb") as f:
    f.write(data)

# tier-2 capacity fallback with a GLOBAL rerun decision: a tiny forced
# tier-1 budget makes noisy frames overflow; both processes must agree
# to re-enter the collective tier-2 fn together (a one-sided rerun
# would deadlock the shard_map) and still produce the standard stream
import gpujpeg_jax.ops.entropy_v2 as _ev2
_ev2.seg_budget_for_quality = lambda q, bps: 8
rng = np.random.default_rng(100 + pid)
noisy = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
enc2 = MultiHostEncoder()
streams2 = enc2.encode_my_frames([noisy], params, image)
with open(os.path.join(outdir, f"noisy_p{pid}.jpg"), "wb") as f:
    f.write(streams2[0])
print("WORKER_OK", pid)
"""


def test_two_process_distributed_encode(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["GPUJPEG_REPO"] = repo
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for p in range(2)]
    outs = [p.communicate(timeout=560)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
        assert "WORKER_OK" in o, o[-3000:]

    H, W = 128, 160
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=80, restart_interval=4)

    # video frames: each process's stream == single-process encode of
    # that frame
    for pid in range(2):
        frame = make_test_rgb(H, W, seed=10 + pid)
        want = Encoder(backend="jax").encode(frame, params, image)
        got = (tmp_path / f"frames_p{pid}.jpg").read_bytes()
        assert got == want, f"frame stream of process {pid} differs"

    # single image across hosts: both processes produced the identical
    # stream, equal to the single-process encoder's
    img = make_test_rgb(H, W, seed=42)
    want = Encoder(backend="jax").encode(img, params, image)
    a = (tmp_path / "single_p0.jpg").read_bytes()
    b = (tmp_path / "single_p1.jpg").read_bytes()
    assert a == b
    assert a == want

    # tier-2 fallback frames: capacity tiers change internal buffers,
    # never bytes — the overflow rerun must equal the standard encode
    for pid in range(2):
        rng = np.random.default_rng(100 + pid)
        noisy = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        want = Encoder(backend="jax").encode(noisy, params, image)
        got = (tmp_path / f"noisy_p{pid}.jpg").read_bytes()
        assert got == want, f"tier-2 stream of process {pid} differs"


def test_multihost_tier2_fallback_single_process(monkeypatch):
    """Single-process MultiHost encoders must detect tier-1 capacity
    overflow (seg_bits/n_ff were previously ignored — silently corrupt
    streams on busy frames) and rerun on the tier-2 geometry, staying
    byte-identical to the single-chip encoder."""
    import jax
    import gpujpeg_jax.ops.entropy_v2 as ev2
    import gpujpeg_jax.ops.jax_pipeline as jp
    from gpujpeg_jax.parallel.multihost import (
        MultiHostEncoder, MultiHostSingleImageEncoder)

    monkeypatch.setattr(ev2, "seg_budget_for_quality", lambda q, bps: 8)
    rng = np.random.default_rng(7)
    H, W = 64, 64
    noisy = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=90, restart_interval=2)

    jp._ENC_CACHE.clear()     # cached contexts were built with real budgets
    want = Encoder(backend="jax").encode(noisy, params, image)
    jp._ENC_CACHE.clear()

    enc = MultiHostEncoder()
    got = enc.encode_my_frames([noisy], params, image)
    assert got[0] == want
    assert next(iter(enc._inner._cache.values())).fn2 is not None, \
        "expected tier-2 rerun to have engaged"

    enc1 = MultiHostSingleImageEncoder()
    got1 = enc1.encode(noisy, params, image)
    assert got1 == want
    assert next(iter(enc1._inner._cache.values())).fn2 is not None


def test_multihost_decoder_local_frames():
    """MultiHostDecoder decodes each process's frames on local devices
    (single-process here: a 4-device local band mesh); output must match
    the plain decoder bit for bit."""
    import jax
    from jax.sharding import Mesh
    from gpujpeg_jax.parallel import MultiHostDecoder
    from gpujpeg_jax.models.decoder import Decoder

    H, W = 128, 160
    image = ImageParameters(width=W, height=H, color_space=ColorSpace.RGB,
                            pixel_format=PixelFormat.PF_444_U8_P012)
    params = Parameters(quality=80, restart_interval=4)
    streams = [Encoder(backend="jax").encode(
        make_test_rgb(H, W, seed=20 + i), params, image) for i in range(2)]

    devs = np.array(jax.devices()[:4])
    dec = MultiHostDecoder(Mesh(devs.reshape(1, -1), ("frame", "seg")))
    got = dec.decode_my_frames(streams)
    assert len(got) == 2
    for stream, (raw, oi) in zip(streams, got):
        ref_dec = Decoder(backend="jax")
        ref_raw, _ = ref_dec.decode(stream)
        assert np.array_equal(np.asarray(raw).reshape(-1),
                              np.asarray(ref_raw).reshape(-1))
