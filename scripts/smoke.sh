#!/bin/sh
# CLI regression smoke — the analog of the reference's
# test/regression/run_tests.sh: encode/decode round trips through the
# command-line tool plus the runnable examples.
set -e
cd "$(dirname "$0")/.."
TMP=$(mktemp -d)
trap 'rm -rf "$TMP"' EXIT

export JAX_PLATFORMS=${JAX_PLATFORMS:-cpu}
export PYTHONPATH=".:${PYTHONPATH:-}"

echo "== raw planar RGB round trip (reference: /dev/zero 1080p) =="
head -c $((160*96*3)) /dev/zero > "$TMP/zero.rgb"
python -m gpujpeg_jax -e -s 160x96 -q 90 -r 4 "$TMP/zero.rgb" "$TMP/zero.jpg"
python -m gpujpeg_jax -d "$TMP/zero.jpg" "$TMP/zero_out.rgb"
test -s "$TMP/zero_out.jpg" 2>/dev/null || test -s "$TMP/zero_out.rgb"

echo "== gray 16x16 =="
head -c $((16*16)) /dev/zero > "$TMP/g.r"
python -m gpujpeg_jax -e -s 16x16 -f u8 -r 1 "$TMP/g.r" "$TMP/g.jpg"
python -m gpujpeg_jax -d "$TMP/g.jpg" "$TMP/g_out.r"

echo "== PNM round trip =="
python examples/encode_minimal.py
python examples/decode_to_pnm.py minimal.jpg "$TMP/out.pnm"
python -m gpujpeg_jax -e "$TMP/out.pnm" "$TMP/out2.jpg"
python -m gpujpeg_jax -I "$TMP/out2.jpg"

echo "== device-array + sharded examples =="
python examples/device_array_roundtrip.py
XLA_FLAGS=--xla_force_host_platform_device_count=4 \
    python examples/sharded_encode.py

rm -f minimal.jpg decoded.pnm
echo "SMOKE OK"
