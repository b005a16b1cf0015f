"""Route selection by platform, loud device failures, the compilation
cache location, and the chip smoke script's refusal to run without a
GPU."""
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from conftest import make_test_rgb

from gpujpeg_jax.models.decoder import Decoder
from gpujpeg_jax.models.encoder import Encoder
from gpujpeg_jax.params import ImageParameters, Parameters
from gpujpeg_jax.types import ColorSpace, PixelFormat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE = ImageParameters(width=64, height=48, color_space=ColorSpace.RGB,
                        pixel_format=PixelFormat.PF_444_U8_P012)
PARAMS = Parameters(quality=75, restart_interval=2)


def _fake_platform(monkeypatch, platform):
    fake = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [fake])


@pytest.mark.parametrize("platform, huffman", [("gpu", "kernel"),
                                               ("cpu", "xla")])
def test_route_selection_per_platform(monkeypatch, platform, huffman):
    """GPU: the Huffman kernel for decode, XLA for encode; CPU: XLA for
    both. Chosen once, when the decoder / encoder context is built."""
    from gpujpeg_jax.ops.jax_pipeline import _EncContext
    from gpujpeg_jax.plan import make_plan
    quant_zz, huff = Encoder()._tables(PARAMS)
    plan = make_plan(PARAMS, IMAGE)
    _fake_platform(monkeypatch, platform)
    dec = Decoder(backend="jax")
    assert dec.routes["huffman_decode"] == huffman
    assert dec.routes["encode"] == "xla"
    ctx = _EncContext(plan, quant_zz, huff)
    assert ctx.routes["encode"] == "xla"
    assert ctx.fn.kind == "staged"
    # the route is fixed at construction: later platform changes do not
    # reach an existing decoder
    _fake_platform(monkeypatch, "cpu")
    assert dec.routes["huffman_decode"] == huffman


def test_route_selection_rejects_other_platform(monkeypatch):
    from gpujpeg_jax.ops.jax_pipeline import _EncContext
    from gpujpeg_jax.plan import make_plan
    quant_zz, huff = Encoder()._tables(PARAMS)
    plan = make_plan(PARAMS, IMAGE)
    _fake_platform(monkeypatch, "rocm")
    with pytest.raises(RuntimeError, match="rocm"):
        Decoder(backend="jax")
    with pytest.raises(RuntimeError, match="rocm"):
        _EncContext(plan, quant_zz, huff)
    Decoder(backend="golden")      # the host backend needs no device


def test_failing_device_decode_raises(monkeypatch):
    """A device failure in the decode pipeline propagates: no host or
    XLA fallback runs in its place, for single and batch decodes."""
    import gpujpeg_jax.models.decoder as dmod
    import gpujpeg_jax.ops.jax_pipeline as jp
    data = Encoder(backend="golden").encode(
        make_test_rgb(48, 64).reshape(-1), PARAMS, IMAGE)

    def boom(frame, consts, out_row):
        raise RuntimeError("synthetic device failure")

    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD", 0)
    monkeypatch.setattr(jp, "_huffman_stage", lambda *a: (boom, None))
    jp._DEC_CACHE.clear()
    try:
        dec = Decoder(backend="jax")
        with pytest.raises(RuntimeError, match="synthetic"):
            dec.decode(data)
        with pytest.raises(RuntimeError, match="synthetic"):
            dec.decode_batch([data, data])
        assert dec.stats.host_frames == 0
    finally:
        jp._DEC_CACHE.clear()


def test_failing_device_encode_raises(monkeypatch):
    import gpujpeg_jax.ops.jax_pipeline as jp

    def build(self, geo):
        def fn(raw):
            raise RuntimeError("synthetic device failure")
        fn.kind = "staged"
        self._stage_fns = None
        return fn

    monkeypatch.setattr(jp._EncContext, "_build_fn", build)
    jp._ENC_CACHE.clear()
    try:
        enc = Encoder(backend="jax")
        img = make_test_rgb(48, 64).reshape(-1)
        with pytest.raises(RuntimeError, match="synthetic"):
            enc.encode(img, PARAMS, IMAGE)
        with pytest.raises(RuntimeError, match="synthetic"):
            enc.encode_batch([img, img], PARAMS, IMAGE)
        assert enc.stats.host_frames == 0
    finally:
        jp._ENC_CACHE.clear()


def _run_python(code, env_updates, cwd=REPO):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_updates)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


_CACHE_PROBE = ("import jax, gpujpeg_jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_in_checkout_when_env_unset():
    from gpujpeg_jax.runtime import DEFAULT_CACHE_DIR
    r = _run_python(_CACHE_PROBE, {})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    r = _run_python(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
