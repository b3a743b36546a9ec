"""On-disk BLCO format: versioned, checksummed, memmap-zero-copy.

The port's copy of ``repro.store.format``, byte for byte the same file:
a ``.blco`` file written by either package opens in the other.  The file
stores the launches **already padded to the reservation**, so feeding the
host-to-device queue from disk is one ``np.memmap`` row slice per section
and launch — the disk layout *is* the wire layout of ``StreamBuffers``'
ring.

File layout (little-endian)::

    [0:8)    magic  b"BLCOSTR1"
    [8:12)   u32    format version
    [12:16)  u32    header JSON length H
    [16:20)  u32    crc32 of the header JSON bytes
    [20:20+H) header JSON (section table, dims, encoding specs, fingerprint)
    ...      sections, each aligned to SECTION_ALIGN for mmap slicing:
               hi / lo / vals / bases    (num_launches, reservation[, order])
               launch_lens / launch_ranges / launch_blocks
               block_keys / block_ranges / block_upper

Every section carries a crc32 in the header (stored as fixed-width hex so
the header length is known before the data pass).  ``open_blco`` always
validates magic, version, header checksum, and that every section lies
inside the file (truncation); ``verify=True`` additionally checksums every
section's bytes.  All failures raise typed errors (:class:`StoreFormatError`
/ :class:`StoreCorruptionError`), never garbage arrays.

``StoredBLCO.chunk`` gives a launch as zero-copy memmap row slices;
``StoredBLCO.chunk_into`` copies those slices into caller-owned buffers —
on the card, the ring's pinned host set, which the copy to the device then
reads.  A read of the same rows with ``os.preadv`` into the pinned set
took longer (84.7 against 53.3 ms per 402,653,184 B NELL-2 chunk on the
host of an NVIDIA H100 80GB HBM3, ``chip_smoke.py``'s ``[disk]`` timing),
so the memmap copy is the read.
``DiskChunkSource`` wraps both with the ``store.read`` fault probe, the
retry layer and the disk counters.

``save_blco`` pads one launch at a time into one reservation of buffers
(``LaunchChunks.chunk_into``), so writing a tensor to the store needs
O(reservation) host memory.
"""
from __future__ import annotations

import json
import os
import time
import zlib

import numpy as np

from repro_torch.core import linearize as lin
from repro_torch.core.blco import BLCOTensor, Block, Launch
from repro_torch.core.streaming import (LaunchChunks, ReservationSpec,
                                        reservation_for)
from repro_torch.faults import inject as faults
from repro_torch.faults.retry import retry_call
from repro_torch.obs import trace as obs_trace

MAGIC = b"BLCOSTR1"
VERSION = 1
SECTION_ALIGN = 4096          # page-aligned sections: clean mmap slices
_HEADER_FIXED = 20            # magic + version + header len + header crc
# the sections a launch's chunk is made of, in the ring's order
CHUNK_SECTIONS = ("hi", "lo", "vals", "bases")


class StoreError(RuntimeError):
    """Base error of the persistent BLCO store."""


class StoreFormatError(StoreError):
    """Not a store file / unsupported version / malformed header."""


class StoreCorruptionError(StoreError):
    """Checksum mismatch or truncated section data."""


def _crc_hex(crc: int) -> str:
    return f"{crc & 0xFFFFFFFF:08x}"


def _align(offset: int) -> int:
    return -(-offset // SECTION_ALIGN) * SECTION_ALIGN


def _section_table(num_launches: int, reservation: int, order: int,
                   value_dtype: np.dtype, num_blocks: int) -> dict:
    """Section name -> {dtype, shape} in file order (offsets filled next)."""
    L, R, N, B = num_launches, reservation, order, num_blocks
    return {
        "hi": {"dtype": "uint32", "shape": [L, R]},
        "lo": {"dtype": "uint32", "shape": [L, R]},
        "vals": {"dtype": str(value_dtype), "shape": [L, R]},
        "bases": {"dtype": "int32", "shape": [L, R, N]},
        "launch_lens": {"dtype": "int64", "shape": [L]},
        "launch_ranges": {"dtype": "int64", "shape": [L, 2]},
        "launch_blocks": {"dtype": "int64", "shape": [L, 2]},
        "block_keys": {"dtype": "uint64", "shape": [B]},
        "block_ranges": {"dtype": "int64", "shape": [B, 2]},
        "block_upper": {"dtype": "int64", "shape": [B, N]},
    }


def _section_nbytes(sec: dict) -> int:
    n = np.dtype(sec["dtype"]).itemsize
    for d in sec["shape"]:
        n *= int(d)
    return n


def _bytes(arr: np.ndarray) -> memoryview:
    """A C-contiguous array's bytes, without a copy."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save_blco(blco: BLCOTensor, path: str, *,
              reservation_nnz: int | None = None,
              fingerprint: str | None = None,
              norm_x: float | None = None) -> int:
    """Write ``blco`` to ``path`` in the store format; returns file bytes.

    Launches are written reservation-padded (default: the streaming
    regime's power-of-two reservation, so a disk-streamed plan uses the
    same ring shape as a host-streamed one), one launch at a time —
    O(reservation) host memory regardless of tensor size.
    ``fingerprint``/``norm_x`` ride along so a registry can re-key and
    re-admit the tensor after a process restart without the original COO.
    """
    spec = reservation_for(blco, reservation_nnz)
    res = spec.nnz
    chunks = LaunchChunks(blco, res)
    L, B, N = len(blco.launches), len(blco.blocks), blco.order
    # write-then-rename: a crash mid-write must never leave a truncated
    # file at the final path — the rename is the commit point
    tmp_path = f"{path}.tmp"

    sections = _section_table(L, res, N, blco.values.dtype, B)
    header = {
        "dims": [int(d) for d in blco.dims],
        "nnz": int(blco.nnz),
        "order": N,
        "value_dtype": str(blco.values.dtype),
        "reservation_nnz": int(res),
        "num_launches": L,
        "num_blocks": B,
        "field_bits": list(blco.re.field_bits),
        "field_shift": list(blco.re.field_shift),
        "block_bits": list(blco.re.block_bits),
        "total_bits": int(blco.spec.total_bits),
        "fingerprint": fingerprint,
        "norm_x": float(norm_x) if norm_x is not None else None,
        "sections": sections,
    }
    # fixed-width crc placeholders keep the header length stable while the
    # real checksums are patched in after the data pass; section offsets
    # depend on the header length (and vice versa through their digit
    # count), so size the header to a fixed point — section alignment makes
    # this converge almost immediately
    for sec in sections.values():
        sec["crc32"] = _crc_hex(0)
        sec["nbytes"] = _section_nbytes(sec)
    hlen, total_bytes, header_json = 0, 0, b""
    for _ in range(10):
        offset = _align(_HEADER_FIXED + hlen)
        for sec in sections.values():
            sec["offset"] = offset
            offset = _align(sec["offset"] + sec["nbytes"])
        total_bytes = (sections["block_upper"]["offset"]
                       + sections["block_upper"]["nbytes"])
        header_json = json.dumps(header, sort_keys=True).encode()
        if len(header_json) == hlen:
            break
        hlen = len(header_json)
    else:
        raise StoreError("header sizing did not converge")

    try:
        _write_store(tmp_path, header, sections, header_json, chunks, blco,
                     L, B, N, total_bytes)
    except BaseException:
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        raise
    os.replace(tmp_path, path)
    return total_bytes


def _write_store(path, header, sections, header_json, chunks, blco,
                 L, B, N, total_bytes) -> None:
    crcs = {name: 0 for name in sections}
    res = chunks.reservation_nnz
    # one reservation of buffers, refilled per launch (tail zeroed)
    bufs = (np.empty(res, np.uint32), np.empty(res, np.uint32),
            np.empty(res, blco.values.dtype), np.empty((res, N), np.int32))
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(np.uint32(VERSION).tobytes())
        f.write(np.uint32(len(header_json)).tobytes())
        f.write(np.uint32(0).tobytes())            # header crc patched below
        f.write(header_json)
        # --- padded launches, streamed one at a time --------------------
        for i in range(L):
            chunks.chunk_into(i, bufs)
            for name, arr in zip(CHUNK_SECTIONS, bufs):
                raw = _bytes(arr)
                row = sections[name]["nbytes"] // L
                if raw.nbytes != row:
                    raise StoreError(f"section {name} row size mismatch")
                f.seek(sections[name]["offset"] + i * row)
                f.write(raw)
                crcs[name] = zlib.crc32(raw, crcs[name])
        # --- launch + block tables --------------------------------------
        launches = blco.launches
        blocks = blco.blocks
        tables = {
            "launch_lens": np.asarray([l.nnz for l in launches], np.int64),
            "launch_ranges": np.asarray([[l.start, l.end] for l in launches],
                                        np.int64).reshape(L, 2),
            "launch_blocks": np.asarray(
                [[l.block_ids[0], l.block_ids[-1] + 1] for l in launches],
                np.int64).reshape(L, 2),
            "block_keys": np.asarray([b.key for b in blocks], np.uint64),
            "block_ranges": np.asarray([[b.start, b.end] for b in blocks],
                                       np.int64).reshape(B, 2),
            "block_upper": np.asarray([list(b.upper) for b in blocks],
                                      np.int64).reshape(B, N),
        }
        for name, arr in tables.items():
            raw = _bytes(arr)
            f.seek(sections[name]["offset"])
            f.write(raw)
            crcs[name] = zlib.crc32(raw, crcs[name])
        # --- patch in the real checksums --------------------------------
        for name, sec in sections.items():
            sec["crc32"] = _crc_hex(crcs[name])
        final_json = json.dumps(header, sort_keys=True).encode()
        if len(final_json) != len(header_json):
            raise StoreError("header length changed while patching checksums")
        f.seek(_HEADER_FIXED)
        f.write(final_json)
        f.seek(12)
        f.write(np.uint32(len(final_json)).tobytes())
        f.write(np.uint32(zlib.crc32(final_json)).tobytes())
        f.truncate(total_bytes)


class DiskChunkSource:
    """Re-iterable chunk source over a :class:`StoredBLCO` for
    ``stream_mttkrp``, with the ``store.read`` fault probe and retry.

    ``chunk_into(i, bufs)`` reads launch ``i`` into the ring's host
    buffers (the route ``stream_mttkrp`` takes); ``chunk(i)`` and
    iteration give memmap row slices.  When ``stats`` is given, each fetch
    records the chunk's bytes and the host wall time of the fetch: for
    ``chunk_into`` the whole read, page-in included; for ``chunk`` only
    the lazy slice construction (the page-in happens when the slices are
    copied).
    """

    def __init__(self, stored: "StoredBLCO", stats=None):
        self.stored = stored
        self.stats = stats

    def __len__(self) -> int:
        return self.stored.num_launches

    def _fetch(self, i: int, read):
        t0 = time.perf_counter()

        def _read():
            faults.maybe_fail("store.read")
            return read()

        # transient read failures (injected OSError or a genuinely flaky
        # mount) retry with backoff; corruption (StoreCorruptionError) is
        # permanent and surfaces immediately — re-reading bad bytes does
        # not help
        out = retry_call(_read, site="store.read", stats=self.stats)
        t1 = time.perf_counter()
        nbytes = self.stored.spec.bytes_per_launch
        if self.stats is not None:
            self.stats.disk_time_s += t1 - t0
            self.stats.disk_bytes += nbytes
            # EngineStats.hist.disk_read_s and the obs_ledger DISK_HOST
            # record take these same floats (ROADMAP queue 1 item 8)
        if obs_trace.TRACING.enabled:
            obs_trace.add_event("store.read", "store", t0, t1,
                                launch=i, bytes=nbytes)
        return out

    def chunk(self, i: int):
        """Launch ``i`` as memmap slices: (hi, lo, vals, bases, n)."""
        return self._fetch(i, lambda: self.stored.chunk(i))

    def chunk_into(self, i: int, bufs) -> int:
        """Read launch ``i`` into ``bufs`` (hi, lo, vals, bases); its nnz."""
        return self._fetch(i, lambda: self.stored.chunk_into(i, bufs))

    def __iter__(self):
        for i in range(len(self)):
            yield self.chunk(i)


class StoredBLCO:
    """A disk-resident BLCO tensor opened from the store (mmap-backed).

    Exposes exactly what the streaming loop needs — ``dims``, ``re``,
    ``value_dtype`` and per-launch reservation chunks — without ever
    materializing the nnz arrays in host memory.  ``to_blco()`` is the
    explicit reload path that does.
    """

    def __init__(self, path: str, header: dict, maps: dict):
        self.path = path
        self._header = header
        self._maps = maps
        self.dims = tuple(int(d) for d in header["dims"])
        self.nnz = int(header["nnz"])
        self.value_dtype = np.dtype(header["value_dtype"])
        self.reservation_nnz = int(header["reservation_nnz"])
        self.num_launches = int(header["num_launches"])
        self.num_blocks = int(header["num_blocks"])
        self.fingerprint = header.get("fingerprint")
        self.norm_x = header.get("norm_x")
        self.re = lin.ReencodeSpec(tuple(header["field_bits"]),
                                   tuple(header["field_shift"]),
                                   tuple(header["block_bits"]))
        self._closed = False

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def spec(self) -> ReservationSpec:
        """The reservation disk chunks are padded to (the ring's shape)."""
        return ReservationSpec(nnz=self.reservation_nnz, order=self.order,
                               value_itemsize=self.value_dtype.itemsize)

    def file_bytes(self) -> int:
        return os.path.getsize(self.path)

    def _check_open(self) -> None:
        if self._closed:
            raise StoreError(f"store {self.path} is closed")

    def chunk(self, i: int):
        """Launch ``i`` as zero-copy memmap slices: (hi, lo, vals, bases, n)."""
        self._check_open()
        m = self._maps
        return (m["hi"][i], m["lo"][i], m["vals"][i], m["bases"][i],
                int(m["launch_lens"][i]))

    def chunk_into(self, i: int, bufs) -> int:
        """Copy launch ``i``'s rows of the hi, lo, vals and bases sections
        into caller-owned numpy buffers of the reservation's shape, byte
        for byte what ``chunk(i)`` gives, and return its nnz.  The rows are
        padded in the file, so every byte of the buffers is overwritten
        (no stale tail)."""
        *rows, n = self.chunk(i)
        r, n_modes = self.reservation_nnz, self.order
        for buf, row in zip(bufs, rows):
            if buf.shape != row.shape or buf.dtype != row.dtype:
                raise ValueError(f"buffer {buf.shape} {buf.dtype} does not "
                                 f"hold a reservation of {r} at order "
                                 f"{n_modes} ({self.value_dtype} values)")
            np.copyto(buf, row)
        return n

    def chunks(self, stats=None) -> DiskChunkSource:
        """Re-iterable chunk source for ``stream_mttkrp``."""
        return DiskChunkSource(self, stats=stats)

    _VERIFY_BLOCK = 4 << 20        # checksum in blocks: O(1) host memory

    def verify(self) -> None:
        """Checksum every section; raises :class:`StoreCorruptionError`.

        Reads in fixed-size blocks — verification of a larger-than-RAM
        store must not itself materialize a section in host memory.
        """
        with open(self.path, "rb") as f:
            for name, sec in self._header["sections"].items():
                f.seek(sec["offset"])
                crc, remaining = 0, sec["nbytes"]
                while remaining:
                    raw = f.read(min(remaining, self._VERIFY_BLOCK))
                    if not raw:
                        raise StoreCorruptionError(
                            f"{self.path}: section {name} truncated "
                            f"({sec['nbytes'] - remaining} of "
                            f"{sec['nbytes']} bytes)")
                    crc = zlib.crc32(raw, crc)
                    remaining -= len(raw)
                if _crc_hex(crc) != sec["crc32"]:
                    raise StoreCorruptionError(
                        f"{self.path}: section {name} checksum mismatch")

    def to_blco(self) -> BLCOTensor:
        """Materialize the full host-resident BLCOTensor (the reload path)."""
        self._check_open()
        m = self._maps
        idx_hi = np.empty(self.nnz, np.uint32)
        idx_lo = np.empty(self.nnz, np.uint32)
        values = np.empty(self.nnz, self.value_dtype)
        for i in range(self.num_launches):
            s, e = (int(v) for v in m["launch_ranges"][i])
            n = int(m["launch_lens"][i])
            idx_hi[s:e] = m["hi"][i, :n]
            idx_lo[s:e] = m["lo"][i, :n]
            values[s:e] = m["vals"][i, :n]
        blocks = [Block(key=int(m["block_keys"][i]),
                        start=int(m["block_ranges"][i, 0]),
                        end=int(m["block_ranges"][i, 1]),
                        upper=tuple(int(u) for u in m["block_upper"][i]))
                  for i in range(self.num_blocks)]
        launches = [Launch(block_ids=tuple(range(
                        int(m["launch_blocks"][i, 0]),
                        int(m["launch_blocks"][i, 1]))),
                        start=int(m["launch_ranges"][i, 0]),
                        end=int(m["launch_ranges"][i, 1]))
                    for i in range(self.num_launches)]
        spec = lin.LinearSpec.make(self.dims)
        if spec.total_bits != int(self._header["total_bits"]):
            raise StoreCorruptionError(
                f"{self.path}: linearization width mismatch "
                f"({spec.total_bits} rebuilt vs {self._header['total_bits']} "
                f"stored)")
        return BLCOTensor(dims=self.dims, spec=spec, re=self.re,
                          idx_hi=idx_hi, idx_lo=idx_lo, values=values,
                          blocks=blocks, launches=launches,
                          construction_stats={"loaded_from": self.path})

    def close(self) -> None:
        self._maps = {}
        self._closed = True

    def __enter__(self) -> "StoredBLCO":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_blco(path: str, *, verify: bool = False) -> StoredBLCO:
    """Open a store file as a :class:`StoredBLCO` (mmap, no data read).

    Always validates magic, version, header checksum, and section bounds
    against the real file size (truncation); ``verify=True`` additionally
    checksums every section's data.
    """
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            fixed = f.read(_HEADER_FIXED)
            if len(fixed) < _HEADER_FIXED or fixed[:8] != MAGIC:
                raise StoreFormatError(f"{path}: not a BLCO store file")
            version = int(np.frombuffer(fixed[8:12], np.uint32)[0])
            if version != VERSION:
                raise StoreFormatError(
                    f"{path}: store version {version} unsupported "
                    f"(expected {VERSION})")
            hlen = int(np.frombuffer(fixed[12:16], np.uint32)[0])
            hcrc = int(np.frombuffer(fixed[16:20], np.uint32)[0])
            raw = f.read(hlen)
    except OSError as exc:
        raise StoreError(f"cannot open store file {path}: {exc}") from exc
    if len(raw) != hlen:
        raise StoreCorruptionError(f"{path}: truncated header "
                                   f"({len(raw)} of {hlen} bytes)")
    if zlib.crc32(raw) != hcrc:
        raise StoreCorruptionError(f"{path}: header checksum mismatch")
    try:
        header = json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise StoreCorruptionError(f"{path}: unreadable header") from exc

    maps = {}
    for name, sec in header["sections"].items():
        if sec["offset"] + sec["nbytes"] > size:
            raise StoreCorruptionError(
                f"{path}: section {name} extends past end of file "
                f"(needs {sec['offset'] + sec['nbytes']} bytes, file has "
                f"{size})")
        shape = tuple(int(d) for d in sec["shape"])
        if sec["nbytes"] == 0:
            maps[name] = np.zeros(shape, np.dtype(sec["dtype"]))
        else:
            maps[name] = np.memmap(path, dtype=np.dtype(sec["dtype"]),
                                   mode="r", offset=sec["offset"],
                                   shape=shape)
    stored = StoredBLCO(path, header, maps)
    if verify:
        stored.verify()
    return stored
