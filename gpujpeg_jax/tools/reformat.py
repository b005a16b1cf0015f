"""JPEG reformatter: add GPUJPEG APP13 segment-info to a foreign JPEG.

Behavioral analog of the reference's standalone reformatter
(reference: test/decoder_gltex/gpujpeg_reformat.c): parses any baseline
JPEG, splits its scans into restart segments, and rewrites the stream
with APP13 segment-index headers so decoders can deal segments to
compute units in O(1) instead of byte-scanning
(reference: gpujpeg_reader.c:1058-1126). The transform is lossless —
entropy data is copied verbatim.

Usage: ``python -m gpujpeg_jax.tools.reformat in.jpg out.jpg``
"""
from __future__ import annotations

import sys

import numpy as np

from ..stream import reader as stream_reader
from ..stream.markers import Marker, MARKER_SEGMENT_INFO
from ..stream.writer import MAX_HEADER_SIZE


def reformat(data: bytes) -> bytes:
    """Return a new JPEG byte stream with APP13 segment info added."""
    info = stream_reader.read_image(data)
    if not info.scans:
        raise ValueError("no scan in JPEG stream")

    out = bytearray()

    # copy everything up to the first SOS verbatim (all original headers)
    first_sos = data.find(b"\xff\xda")
    if first_sos < 0:
        raise ValueError("missing SOS")
    out += data[:first_sos]

    for scan in info.scans:
        n_seg = len(scan.segments)
        # APP13 segment-info blocks (reference: gpujpeg_writer.c:500-526):
        # (n_seg + 1) 4-byte scan-relative offsets (RST markers re-inserted
        # below, none after the final segment), split across APP headers
        offsets = [0]
        pos = 0
        for i, (lo, hi) in enumerate(scan.segments):
            pos += (hi - lo) + (2 if i < n_seg - 1 else 0)
            offsets.append(pos)
        payload = b"".join(int(o).to_bytes(4, "big") for o in offsets)
        for off in range(0, max(len(payload), 1), MAX_HEADER_SIZE):
            chunk = payload[off:off + MAX_HEADER_SIZE]
            out += bytes((0xFF, int(MARKER_SEGMENT_INFO)))
            out += (3 + len(chunk)).to_bytes(2, "big")
            out.append(scan.index & 0xFF)
            out += chunk

        # SOS header for this scan (reconstructed from parse)
        out += bytes((0xFF, int(Marker.SOS)))
        comps = scan.components
        out += (6 + 2 * len(comps)).to_bytes(2, "big")
        out.append(len(comps))
        for sc in comps:
            out.append(info.components[sc.comp_index].comp_id)
            out.append((sc.dc_table << 4) | sc.ac_table)
        out += bytes((0, 0x3F, 0))

        # entropy data with RST markers re-inserted between segments
        d = np.asarray(scan.data)
        for i, (lo, hi) in enumerate(scan.segments):
            out += d[lo:hi].tobytes()
            if i < n_seg - 1:
                out += bytes((0xFF, 0xD0 + (i % 8)))

    out += bytes((0xFF, int(Marker.EOI)))
    return bytes(out)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m gpujpeg_jax.tools.reformat in.jpg out.jpg",
              file=sys.stderr)
        return 2
    with open(argv[0], "rb") as f:
        data = f.read()
    out = reformat(data)
    with open(argv[1], "wb") as f:
        f.write(out)
    print(f"{argv[0]} ({len(data)} B) -> {argv[1]} ({len(out)} B, "
          "segment info added)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
