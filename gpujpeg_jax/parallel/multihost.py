"""Multi-host (multi-process) distributed encode.

SURVEY §2.3: the reference has no distributed backend at all (single
process, one GPU per coder). Here distribution is first-class:

* ``init_distributed`` wraps ``jax.distributed.initialize`` — one JAX
  process per host, all devices form one global platform.
* :class:`MultiHostEncoder` builds a global ``('frame', 'seg')`` mesh:
  the 'frame' axis spans processes (each host feeds and assembles its
  own frames — video sharding with zero cross-host pixel traffic), the
  'seg' axis spans each process's local devices (band sharding of each
  frame, as in :class:`ShardedEncoder`).
* For a single image spread across *all* hosts
  (:class:`MultiHostSingleImageEncoder`, bands across the whole mesh),
  per-segment bytes gather with ``multihost_utils.process_allgather``
  and every process assembles the identical stream (symmetric — no
  dedicated coordinator).

Every path is bit-identical to the single-device encoder: bands/segments
are independent (DC prediction resets at every restart marker), so
distribution changes only WHERE segments are coded, never their bytes.

Validated by ``tests/test_multihost.py`` (2 CPU processes x 4 virtual
devices each, spawned subprocesses with a real coordinator) and by
``__graft_entry__.dryrun_multichip``.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..params import ImageParameters, Parameters
from .sharded import ShardedEncoder, plan_bands, split_raw_bands


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the multi-process JAX runtime (idempotent).

    With no arguments, relies on a cluster environment JAX can detect
    (e.g. a SLURM or MPI launcher); elsewhere, including a single GPU
    host with one process per card, pass the coordinator explicitly:
    ``init_distributed("host0:8476", num_processes=2, process_id=i)``.
    """
    kw = {}
    if coordinator_address is not None:
        kw = dict(coordinator_address=coordinator_address,
                  num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:  # already initialized is fine
        if "already" not in str(e):
            raise


def global_mesh(frame_axis_per_process: int = 1) -> Mesh:
    """Global ('frame', 'seg') mesh: 'frame' spans processes, 'seg' the
    devices within each process."""
    n_proc = jax.process_count()
    n_local = jax.local_device_count()
    devs = np.empty((n_proc * frame_axis_per_process,
                     n_local // frame_axis_per_process), dtype=object)
    for d in jax.devices():
        # jax.devices() is ordered by process; keep each process's
        # devices in one 'frame' row so 'seg' collectives stay intra-host
        p = d.process_index
        li = _local_index(d)
        fr = p * frame_axis_per_process + li // (n_local //
                                                 frame_axis_per_process)
        devs[fr, li % (n_local // frame_axis_per_process)] = d
    return Mesh(devs, ("frame", "seg"))


def _local_index(d) -> int:
    locs = [x for x in jax.devices() if x.process_index == d.process_index]
    return locs.index(d)


class MultiHostEncoder:
    """Frame sharding across processes + band sharding across each
    process's local devices.

    ``encode_my_frames(frames, ...)`` — each process passes the frames it
    owns (``len(frames)`` equal on every process); returns that process's
    encoded streams. Pixel data never crosses hosts; the only global
    operation is the jitted shard_map itself.
    """

    def __init__(self, mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else global_mesh()
        self._inner = ShardedEncoder(self.mesh)

    def encode_my_frames(self, frames, params: Parameters,
                         image: ImageParameters) -> list[bytes]:
        from jax.experimental import multihost_utils

        b = self._inner._build(params, image)
        layout = b.layout
        n_frame = self.mesh.shape["frame"]
        n_proc = jax.process_count()
        frames_per_proc = n_frame // n_proc
        if len(frames) > frames_per_proc:
            out = []
            for i in range(0, len(frames), frames_per_proc):
                out.extend(self.encode_my_frames(
                    frames[i:i + frames_per_proc], params, image))
            return out
        n_my = len(frames)
        pad = frames_per_proc - n_my
        local = np.stack([
            split_raw_bands(frames[min(i, n_my - 1)], image, layout)
            for i in range(frames_per_proc)
        ])  # (frames_per_proc, n_bands_total? -> bands of this frame)

        # global array: frame axis = n_frame across processes
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(self.mesh, P("frame", "seg", None))
        global_shape = (n_frame,) + local.shape[1:]
        arrs = []
        local_j = jnp.asarray(local)
        seg_size = self.mesh.shape["seg"]
        bands_per_dev = local.shape[1] // seg_size
        dev_arrays, devs = [], []
        for fr in range(frames_per_proc):
            for si in range(seg_size):
                d = self.mesh.devices[jax.process_index() * frames_per_proc
                                      + fr, si]
                piece = local_j[fr, si * bands_per_dev:
                                (si + 1) * bands_per_dev][None]
                dev_arrays.append(jax.device_put(piece, d))
                devs.append(d)
        garr = jax.make_array_from_single_device_arrays(
            global_shape, sh, dev_arrays)

        rst_j = multihost_utils.broadcast_one_to_all(b.rst_np) \
            if n_proc > 1 else jnp.asarray(b.rst_np)
        has_j = multihost_utils.broadcast_one_to_all(b.has_np) \
            if n_proc > 1 else jnp.asarray(b.has_np)

        # tier loop mirroring ShardedEncoder.encode_batch: tier-1 uses
        # typical-content capacity; overflow (busy frames) reruns on the
        # tier-2 worst-case geometry. The rerun decision must be GLOBAL
        # (fn1/fn2 are collective shard_maps every process must enter),
        # so each process's local overflow flag is OR-reduced cluster-wide.
        my = jax.process_index()
        for tier in (1, 2):
            geo, fn = (b.geo1, b.fn1) if tier == 1 else b.tier2()
            out, out_len, seg_bits, n_ff = fn(garr, jnp.asarray(rst_j),
                                              jnp.asarray(has_j))
            loc = False
            for fr in range(n_my):
                gf = my * frames_per_proc + fr
                loc = loc or _tier_overflow(geo, _local_frame(seg_bits, gf),
                                            _local_frame(n_ff, gf))
            if n_proc > 1:
                anyflow = bool(multihost_utils.process_allgather(
                    np.asarray([loc], np.int32)).any())
            else:
                anyflow = loc
            if not anyflow:
                # each process owns its frames' shards: gather local data
                results = []
                for fr in range(n_my):
                    gf = my * frames_per_proc + fr
                    out_f = _local_frame(out, gf)
                    len_f = _local_frame(out_len, gf)
                    results.append(self._inner._assemble(
                        layout, b.quant_zz, b.huff, out_f, len_f, params,
                        image))
                return results

        # beyond worst-case caps: host golden coder per frame (local-only,
        # no collectives — safe to run on the overflowing process alone,
        # but every process lands here together via the global decision)
        from ..models.encoder import Encoder
        enc = Encoder(backend="golden")
        return [enc.encode(np.asarray(f), params, image) for f in frames]


class MultiHostSingleImageEncoder:
    """One huge image's bands spread across every device of every host
    (the 'seg' axis spans the whole cluster); per-segment bytes gather
    with ``process_allgather`` and every process assembles the stream
    (symmetric, no dedicated coordinator)."""

    def __init__(self):
        n = len(jax.devices())
        devs = np.array(jax.devices()).reshape(1, n)
        self.mesh = Mesh(devs, ("frame", "seg"))
        self._inner = ShardedEncoder(self.mesh)

    def encode(self, raw, params: Parameters,
               image: ImageParameters) -> bytes:
        from jax.experimental import multihost_utils
        from jax.sharding import NamedSharding, PartitionSpec as P

        b = self._inner._build(params, image)
        layout = b.layout
        n_bands = layout.n_bands
        bands = split_raw_bands(raw, image, layout)[None]  # (1, n_bands, L)

        sh = NamedSharding(self.mesh, P("frame", "seg", None))
        per_dev = n_bands // self.mesh.shape["seg"]
        dev_arrays = []
        for si, d in enumerate(self.mesh.devices[0]):
            if d.process_index != jax.process_index():
                continue
            piece = jnp.asarray(
                bands[:, si * per_dev:(si + 1) * per_dev])
            dev_arrays.append(jax.device_put(piece, d))
        garr = jax.make_array_from_single_device_arrays(
            bands.shape, sh, dev_arrays)

        def gather(g):
            """This process's band shards -> the full global array (by
            allgather); symmetric, so every process decides/assembles
            identically."""
            mine = [np.asarray(s.data)[0] for s in sorted(
                g.addressable_shards, key=lambda s: s.index[1].start)]
            local = np.concatenate(mine, axis=0)
            if jax.process_count() > 1:
                allv = multihost_utils.process_allgather(local)
                return allv.reshape(-1, *local.shape[1:])
            return local

        # tier loop mirroring ShardedEncoder.encode_batch; the gathered
        # seg_bits/n_ff are identical everywhere, so the tier-2 decision
        # is symmetric by construction (all processes re-enter fn2)
        for tier in (1, 2):
            geo, fn = (b.geo1, b.fn1) if tier == 1 else b.tier2()
            out, out_len, seg_bits, n_ff = fn(
                garr, jnp.asarray(b.rst_np), jnp.asarray(b.has_np))
            bits_f = gather(seg_bits)
            nff_f = gather(n_ff)
            if not _tier_overflow(geo, bits_f, nff_f):
                out_f = gather(out)
                len_f = gather(out_len)
                return self._inner._assemble(layout, b.quant_zz, b.huff,
                                             out_f, len_f,
                                             params, image)

        # beyond worst-case caps: host golden coder (identical result on
        # every process; raw is fully replicated here by contract)
        from ..models.encoder import Encoder
        return Encoder(backend="golden").encode(
            np.asarray(raw), params, image)


class MultiHostDecoder:
    """Frame sharding across processes for decode: each process decodes
    the frames it owns on its own local devices (band sharding via
    :class:`ShardedDecoder`). Decode needs no cross-host collectives at
    all — APP13 segment info gives O(1) segment offsets
    (reference: gpujpeg_reader.c:1058-1126), so streams deal out to
    processes and each stream's bands to local chips."""

    def __init__(self, local_mesh: Mesh | None = None):
        from .sharded import ShardedDecoder
        if local_mesh is None:
            devs = np.array(jax.local_devices())
            local_mesh = Mesh(devs.reshape(1, -1), ("frame", "seg"))
        self._inner = ShardedDecoder(local_mesh)

    def decode_my_frames(self, streams) -> list:
        """``streams``: the JPEG byte streams this process owns. Returns
        ``[(raw, ImageParameters), ...]`` in the same order. Pipelined:
        frame i+1's parse + band row build overlap frame i's device
        decode (ShardedDecoder.decode_batch)."""
        return self._inner.decode_batch(streams)


def _tier_overflow(geo, bits_h, nff_h) -> bool:
    """Per-segment capacity overflow under a tier's geometry caps —
    the same predicate as ShardedEncoder.encode_batch's tier loop."""
    bits_h = np.asarray(bits_h)
    nff_h = np.asarray(nff_h)
    stuffed = ((bits_h + 7) >> 3) + nff_h
    return bool((bits_h > geo.cap_seg_words * 4 * 8).any()
                or (stuffed + 2 > geo.cap_out_bytes).any()
                or (nff_h > geo.max_stuff).any())


def _local_frame(garr, frame_idx: int) -> np.ndarray:
    """Materialize one frame's row of a ('frame','seg')-sharded global
    array from this process's addressable shards. Shard index slices of
    an unsharded dimension can be ``slice(None)`` — normalize bounds."""
    def span(sl, size):
        if not isinstance(sl, slice):
            return 0, size
        return (sl.start or 0,
                size if sl.stop is None else sl.stop)

    shards = []
    for s in garr.addressable_shards:
        lo, hi = span(s.index[0], garr.shape[0])
        if lo <= frame_idx < hi:
            shards.append((s, lo))
    shards.sort(key=lambda t: span(t[0].index[1], garr.shape[1])[0])
    parts = [np.asarray(s.data)[frame_idx - lo] for s, lo in shards]
    return np.concatenate(parts, axis=0)
