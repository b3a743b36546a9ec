"""The port's disk tier (``repro_torch.store``: the ``.blco`` format,
``StoredBLCO``, ``DiskChunkSource``, ``DiskStreamedPlan``), ``plan_for``'s
host budget and the plan sanitizer, against the JAX package's, on the CPU:
the same ring of buffers as on the card, unpinned and without streams."""
import functools
import os
import weakref

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro import engine as rengine  # noqa: E402
from repro import store as rstore  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.analysis import (SanitizedPlan, SanitizerError,  # noqa: E402
                                  check_factors, sanitize_enabled, sanitized,
                                  wrap_plan)
from repro_torch.core import streaming  # noqa: E402
from repro_torch.engine import (DiskStreamedPlan, ExecutionPlan,  # noqa: E402
                                InMemoryPlan, StreamedPlan, plan_for)
from repro_torch.store import (DiskChunkSource,  # noqa: E402
                               StoreCorruptionError, StoreError,
                               StoreFormatError, open_blco, save_blco)
from repro_torch.store import format as fmt  # noqa: E402

# max |port - x| / max |x|: the JAX package's tests bound f32 at 5e-4; f64
# differs only in the order of additions
F32_TOL, F64_TOL = 5e-4, 1e-10
RANK = 6
# (dims, nnz, dist, target_bits, max_nnz_per_block): order 4 with a stash
# mode (7 rows) and launches of 64, 63, 64, 63, 36; order 3 with a ragged
# last launch; order 3 at 13 bits per mode, whose mode-2 field (shift 26,
# width 13) straddles the two index words
CASES = {
    "order4-stash": ((13, 7, 29, 5), 499, "powerlaw", 8, 64),
    "order3-ragged": ((30, 22, 14), 1500, "powerlaw", 64, 96),
    "straddle": ((1 << 13, 1 << 13, 1 << 13), 400, "uniform", 64, 96),
}
RESOLUTIONS = ("register", "direct", "hierarchical")


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


@functools.lru_cache(maxsize=None)
def _setup(case, dtype=np.float32):
    """The reference's tensor and BLCO and the port's, built from the same
    seed by each package's own host code (byte-identical)."""
    dims, nnz, dist, tb, mx = CASES[case]
    t = rcore.random_tensor(dims, nnz, seed=5, dist=dist, dtype=dtype)
    ref = rcore.build_blco(t, target_bits=tb, max_nnz_per_block=mx)
    port = core.build_blco(core.random_tensor(dims, nnz, seed=5, dist=dist,
                                              dtype=dtype),
                           target_bits=tb, max_nnz_per_block=mx)
    return t, ref, port


def _oracle(t, f, mode):
    """The reference's dense oracle where the dense tensor is small, else
    the same sum over the COO entries in float64 (the straddle case's
    dense tensor would hold 2^39 entries)."""
    if np.prod(t.dims) <= 1 << 22:
        return rcore.mttkrp_dense_oracle(t, f, mode)
    rows = t.values.astype(np.float64)[:, None] * np.prod(
        [np.asarray(f[m], np.float64)[t.indices[:, m]]
         for m in range(t.order) if m != mode], axis=0)
    out = np.zeros((t.dims[mode], rows.shape[1]))
    np.add.at(out, t.indices[:, mode], rows)
    return out


def _factors(dims, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((d, RANK)).astype(dtype) for d in dims]


def _torch(fs):
    return [torch.from_numpy(x) for x in fs]


def _ragged(blco):
    return max(l.nnz for l in blco.launches) + 3


def _empty(pkg):
    t = pkg.from_coo(np.zeros((0, 3), np.int64), np.zeros(0, np.float32),
                     (8, 6, 4))
    return pkg.build_blco(t)


# ------------------------------------------------------------------ format
FILES = ["order3-f32", "order4-f32", "straddle-f64", "ragged-reservation",
         "empty"]


def _file_pair(which):
    """(reference BLCO, port BLCO, reservation_nnz) of one file case."""
    if which == "empty":
        return _empty(rcore), _empty(core), None
    case, dtype = {"order3-f32": ("order3-ragged", np.float32),
                   "order4-f32": ("order4-stash", np.float32),
                   "straddle-f64": ("straddle", np.float64),
                   "ragged-reservation": ("order3-ragged", np.float32)}[which]
    _, ref, port = _setup(case, dtype)
    res = _ragged(port) if which == "ragged-reservation" else None
    return ref, port, res


@pytest.mark.parametrize("which", FILES)
def test_save_blco_byte_identical_to_reference(which, tmp_path):
    """The port writes the reference's file, byte for byte, for the same
    BLCO, reservation, fingerprint and norm."""
    ref, port, res = _file_pair(which)
    if which == "straddle-f64":
        assert int(port.idx_hi.max()) > 0 and \
            port.re.field_shift[2] < 32 < port.re.field_shift[2] \
            + port.re.field_bits[2]
    a, b = str(tmp_path / "ref.blco"), str(tmp_path / "port.blco")
    na = rstore.save_blco(ref, a, reservation_nnz=res, fingerprint="fp",
                          norm_x=2.5)
    nb = save_blco(port, b, reservation_nnz=res, fingerprint="fp",
                   norm_x=2.5)
    assert na == nb == os.path.getsize(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert not os.path.exists(b + ".tmp")


@pytest.mark.parametrize("which", FILES)
def test_to_blco_gives_back_the_blco(which, tmp_path):
    _, port, res = _file_pair(which)
    path = str(tmp_path / "t.blco")
    save_blco(port, path, reservation_nnz=res, fingerprint="fp", norm_x=2.5)
    s = open_blco(path, verify=True)
    assert s.fingerprint == "fp" and s.norm_x == 2.5
    assert s.dims == port.dims and s.nnz == port.nnz and s.re == port.re
    assert s.reservation_nnz == (res or streaming.reservation_for(port).nnz)
    back = s.to_blco()
    for name in ("idx_hi", "idx_lo", "values"):
        got, want = getattr(back, name), getattr(port, name)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert back.blocks == port.blocks and back.launches == port.launches
    assert back.spec == port.spec
    s.close()
    with pytest.raises(StoreError, match="closed"):
        s.chunk(0)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_files_open_and_stream_in_both_packages(case, writer, tmp_path):
    """A file written by either package opens (verified) in the other and
    streams the same MTTKRP there."""
    t, ref, port = _setup(case)
    path = str(tmp_path / "t.blco")
    if writer == "reference":
        rstore.save_blco(ref, path)
    else:
        save_blco(port, path)
    f = _factors(t.dims)
    plan = DiskStreamedPlan(open_blco(path, verify=True), queues=2,
                            device="cpu")
    rplan = rstore.DiskStreamedPlan(rstore.open_blco(path, verify=True),
                                    queues=2)
    for mode in range(t.order):
        out = plan.mttkrp(_torch(f), mode)
        assert _rel(out, np.asarray(rplan.mttkrp(f, mode))) < F32_TOL
    plan.close()
    rplan.close()


def test_open_rejects_non_store_and_bad_version(tmp_path):
    path = str(tmp_path / "junk.blco")
    with open(path, "wb") as f:
        f.write(b"NOTASTORE" + b"\0" * 64)
    with pytest.raises(StoreFormatError, match="not a BLCO store"):
        open_blco(path)
    _, _, port = _setup("order3-ragged")
    good = str(tmp_path / "good.blco")
    save_blco(port, good)
    raw = bytearray(open(good, "rb").read())
    raw[8:12] = (99).to_bytes(4, "little")
    bad = str(tmp_path / "badver.blco")
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(StoreFormatError, match="version 99"):
        open_blco(bad)
    with pytest.raises(StoreError, match="cannot open"):
        open_blco(str(tmp_path / "missing.blco"))


def test_truncated_file_detected_without_verify(tmp_path):
    _, _, port = _setup("order3-ragged")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 1)
    with pytest.raises(StoreCorruptionError, match="past end of file"):
        open_blco(path)        # bounds check runs even with verify=False


def test_corrupted_section_detected_by_checksum(tmp_path):
    _, _, port = _setup("order3-ragged")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    s = open_blco(path)                     # find a real data byte to flip
    sec = s._header["sections"]["vals"]
    s.close()
    with open(path, "r+b") as f:
        f.seek(sec["offset"] + 5)
        byte = f.read(1)
        f.seek(sec["offset"] + 5)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(StoreCorruptionError, match="checksum mismatch"):
        open_blco(path, verify=True)
    # header corruption is caught even without verify
    with open(path, "r+b") as f:
        f.seek(25)
        f.write(b"\xff")
    with pytest.raises(StoreCorruptionError):
        open_blco(path)


def test_save_blco_is_atomic(tmp_path, monkeypatch):
    """save_blco commits via rename: no .tmp remnants on success, and a
    mid-write failure leaves nothing at the final path."""
    _, _, port = _setup("order3-ragged")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")

    class Boom(fmt.LaunchChunks):
        def chunk_into(self, i, bufs):
            if i >= 2:
                raise RuntimeError("simulated crash mid-write")
            return super().chunk_into(i, bufs)

    monkeypatch.setattr(fmt, "LaunchChunks", Boom)
    bad = str(tmp_path / "bad.blco")
    with pytest.raises(RuntimeError, match="mid-write"):
        save_blco(port, bad)
    assert not os.path.exists(bad) and not os.path.exists(bad + ".tmp")


# ----------------------------------------------------------- the two reads
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", CASES)
def test_chunk_into_equals_memmap_chunk_byte_for_byte(case, dtype, tmp_path):
    """``chunk_into`` reads into the ring's host buffers exactly the bytes
    of the memmap slices and of ``LaunchChunks.chunk_into``, also into
    buffers that last held the fullest chunk (a stale tail) and for the
    ragged last launch; a ring of another shape is refused."""
    _, _, port = _setup(case, dtype)
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    s = open_blco(path)
    ring = streaming.StreamBuffers(s.spec, 1, s.value_dtype, device="cpu")
    bufs = ring.host_set(0)
    host = core.LaunchChunks(port, s.reservation_nnz)
    want = tuple(np.empty_like(b) for b in bufs)
    fullest = max(range(s.num_launches), key=lambda i: port.launches[i].nnz)
    assert port.launches[-1].nnz < port.launches[fullest].nnz
    for i in range(s.num_launches):
        s.chunk_into(fullest, bufs)
        n = s.chunk_into(i, bufs)
        mm = s.chunk(i)
        assert n == mm[4] == host.chunk_into(i, want) == \
            port.launches[i].nnz
        for got, m, w in zip(bufs, mm[:4], want):
            assert got.tobytes() == np.asarray(m).tobytes() == w.tobytes()
    with pytest.raises(ValueError, match="reservation"):
        s.chunk_into(0, tuple(b[:-1] for b in want[:3]) + (want[3],))
    with pytest.raises(IndexError):
        s.chunk_into(s.num_launches, bufs)
    ring.close()


def test_chunk_into_refuses_other_buffers_and_a_closed_store(tmp_path):
    """A buffer of another value dtype (f64 rows into an f32 ring) is
    refused rather than cast, and a closed store reads nothing."""
    _, _, port = _setup("order3-ragged", np.float64)
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    s = open_blco(path)
    bufs = [np.empty_like(np.asarray(a)) for a in s.chunk(0)[:4]]
    assert s.chunk_into(0, bufs) == port.launches[0].nnz
    bufs[2] = bufs[2].astype(np.float32)
    with pytest.raises(ValueError, match="float64 values"):
        s.chunk_into(0, bufs)
    s.close()
    with pytest.raises(StoreError, match="closed"):
        s.chunk_into(0, bufs)


def test_stream_mttkrp_over_a_stored_blco(tmp_path):
    """``stream_mttkrp`` takes a StoredBLCO as its ``blco`` (dims,
    re-encoding, ``value_dtype``; no ``values``, no launches), through
    the ``chunk_into`` route, the memmap-tuple route and a list, with and
    without a ring, and gives the host-streamed bits."""
    t, _, port = _setup("order4-stash")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    s = open_blco(path)
    assert not hasattr(s, "values") and not hasattr(s, "launches")
    ft = _torch(_factors(t.dims))
    ring = streaming.StreamBuffers(s.spec, 2, s.value_dtype, device="cpu")
    for mode in range(t.order):
        want = core.stream_mttkrp(core.LaunchChunks(port, s.reservation_nnz),
                                  port, ft, mode, queues=2)
        for source in (s.chunks, lambda: iter(s.chunks()),
                       lambda: list(s.chunks())):
            for buffers in (None, ring):
                got = core.stream_mttkrp(source(), s, ft, mode, queues=2,
                                         buffers=buffers)
                assert got.dtype == torch.float32
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    ring.close()


# -------------------------------------------------------- disk-streamed plan
@functools.lru_cache(maxsize=None)
def _reference_disk_outputs(case, dtype, tmp):
    """The reference DiskStreamedPlan's outputs (kernel="xla") on every
    mode and resolution, and the dense oracle's per mode."""
    t, ref, _ = _setup(case, dtype)
    path = os.path.join(tmp, f"ref-{case}-{np.dtype(dtype).name}.blco")
    f = _factors(t.dims, dtype)
    with jax.enable_x64(dtype == np.float64):
        rstore.save_blco(ref, path)
        plan = rstore.DiskStreamedPlan(path, queues=3)
        outs = {(m, r): np.asarray(plan.mttkrp(f, m, resolution=r))
                for m in range(t.order) for r in RESOLUTIONS}
        plan.close()
    oracle = [_oracle(t, f, m) for m in range(t.order)]
    return outs, oracle


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ref_store"))


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("queues", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_disk_streamed_matches_reference_and_oracle(case, queues, dtype,
                                                    kernel, ref_dir,
                                                    tmp_path):
    """Every mode and resolution through the port's DiskStreamedPlan
    against the reference's DiskStreamedPlan and the dense oracle
    (``kernel="cuda"`` runs the plain versions of K1/K2 on the CPU, once
    per chunk)."""
    t, _, port = _setup(case, dtype)
    tol = F32_TOL if dtype == np.float32 else F64_TOL
    want, oracle = _reference_disk_outputs(case, dtype, ref_dir)
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    plan = DiskStreamedPlan(path, queues=queues, kernel=kernel, device="cpu")
    assert isinstance(plan, ExecutionPlan)
    ft = _torch(_factors(t.dims, dtype))
    for mode in range(t.order):
        for res in RESOLUTIONS:
            out = plan.mttkrp(ft, mode, resolution=res)
            assert out.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
            assert out.shape == (t.dims[mode], RANK)
            assert _rel(out, want[mode, res]) < tol, (mode, res)
            assert _rel(out, oracle[mode]) < tol, (mode, res)
    chunks = len(port.launches)
    calls = t.order * len(RESOLUTIONS)
    s = plan.stats()
    assert s.backend == "disk_streamed" and s.mttkrp_calls == calls
    assert s.launches == calls * chunks
    assert s.disk_bytes == s.h2d_bytes == \
        calls * chunks * plan.spec.bytes_per_launch
    assert s.disk_time_s > 0
    assert plan.close() == plan.spec.bytes_in_flight(queues)
    assert plan.device_bytes() == plan.host_window_bytes() == \
        plan.disk_bytes() == 0
    assert plan.close() == 0                # idempotent
    assert os.path.exists(path)             # not the plan's to delete
    with pytest.raises(RuntimeError, match="closed"):
        plan.mttkrp(ft, 0)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("queues", [1, 3, 8])
@pytest.mark.parametrize("case", CASES)
def test_disk_streamed_equals_host_streamed_bitwise(case, queues, kernel,
                                                    tmp_path):
    """The same padded bytes through the same ring and the same plain
    dataflow: disk-streamed and host-streamed outputs are bit-identical
    on the CPU, every mode and resolution."""
    t, _, port = _setup(case)
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    disk = DiskStreamedPlan(path, queues=queues, kernel=kernel, device="cpu")
    host = StreamedPlan(port, queues=queues, kernel=kernel, device="cpu")
    assert disk.spec == host.spec
    ft = _torch(_factors(t.dims))
    for mode in range(t.order):
        for res in RESOLUTIONS:
            torch.testing.assert_close(
                disk.mttkrp(ft, mode, resolution=res),
                host.mttkrp(ft, mode, resolution=res), rtol=0, atol=0)
    assert disk.stats().h2d_bytes == host.stats().h2d_bytes
    assert disk.device_bytes() == host.device_bytes()
    assert disk.host_window_bytes() == host.host_window_bytes()


def test_ragged_reservation_and_empty_tensor(tmp_path):
    t, _, port = _setup("order3-ragged")
    path = str(tmp_path / "ragged.blco")
    save_blco(port, path, reservation_nnz=_ragged(port))
    plan = DiskStreamedPlan(path, queues=2, device="cpu")
    assert plan.spec.nnz == _ragged(port)
    f = _factors(t.dims)
    assert _rel(plan.mttkrp(_torch(f), 1),
                rcore.mttkrp_dense_oracle(t, f, 1)) < F32_TOL
    plan.close()
    path = str(tmp_path / "empty.blco")
    save_blco(_empty(core), path)
    plan = DiskStreamedPlan(path, device="cpu")
    out = plan.mttkrp([torch.ones(d, 5) for d in (8, 6, 4)], 0)
    assert out.shape == (8, 5) and not out.any()
    assert plan.stats().launches == plan.stats().disk_bytes == 0


def test_spill_and_delete_on_close(tmp_path):
    t, _, port = _setup("order4-stash")
    path = str(tmp_path / "spill.blco")
    plan = DiskStreamedPlan.spill(port, path, queues=2, device="cpu")
    assert plan.delete_on_close and plan.disk_bytes() == \
        os.path.getsize(path)
    f = _factors(t.dims)
    assert _rel(plan.mttkrp(_torch(f), 2),
                rcore.mttkrp_dense_oracle(t, f, 2)) < F32_TOL
    plan.close()
    assert not os.path.exists(path)


def test_default_device_is_the_card(tmp_path):
    """Without ``device="cpu"`` the plan's ring goes to the card: where
    there is none it raises, and nothing runs on the CPU instead."""
    _, _, port = _setup("order4-stash")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    if torch.cuda.is_available():
        plan = DiskStreamedPlan(path)
        assert plan.buffers.device.type == "cuda"
        plan.close()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiskStreamedPlan(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_for(port, 1 << 40, rank=RANK, backend="disk_streamed",
                 store_path=str(tmp_path / "u.blco"))


# --------------------------------------------------------- bounded window
def test_memmap_route_holds_a_bounded_host_window(tmp_path):
    """Memmap tuples fed to the loop: at most ``queues`` + 1 per-chunk
    allocations are alive at once (weakref finalizers on every chunk the
    loop pulls)."""
    t, _, port = _setup("order3-ragged")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    stored = open_blco(path)
    queues = 3
    plan = DiskStreamedPlan(stored, queues=queues, device="cpu")
    assert plan.host_window_bytes() == queues * plan.spec.bytes_per_launch
    live = {"now": 0, "peak": 0, "total": 0}

    def tracked():
        for chunk in DiskChunkSource(stored, stats=plan.stats()):
            arr = np.array(chunk[0])   # a per-chunk allocation we can track
            live["now"] += 1
            live["total"] += 1
            live["peak"] = max(live["peak"], live["now"])

            def _dead(_ref=None):
                live["now"] -= 1
            weakref.finalize(arr, _dead)
            yield (arr,) + chunk[1:]
            del arr, chunk

    got = core.stream_mttkrp(tracked(), stored, _torch(_factors(t.dims)), 0,
                             queues=queues, buffers=plan.buffers)
    n_launches = len(port.launches)
    assert n_launches > 2 * queues       # the test only means something then
    assert live["total"] == n_launches
    assert live["peak"] <= queues + 1, live
    torch.testing.assert_close(got, plan.mttkrp(_torch(_factors(t.dims)), 0),
                               rtol=0, atol=0)
    plan.close()


def test_chunk_into_route_reads_only_into_the_ring(tmp_path, monkeypatch):
    """The plan's route: every chunk is read by ``chunk_into`` into one of
    the ring's ``queues`` host sets, with no chunk tuple in between."""
    t, _, port = _setup("order3-ragged")
    path = str(tmp_path / "t.blco")
    save_blco(port, path)
    queues = 3
    plan = DiskStreamedPlan(path, queues=queues, device="cpu")
    ring = {tuple(b.ctypes.data for b in plan.buffers.host_set(k))
            for k in range(queues)}
    seen = []
    real = fmt.StoredBLCO.chunk_into

    def spy(self, i, bufs):
        seen.append((i, tuple(b.ctypes.data for b in bufs)))
        return real(self, i, bufs)

    monkeypatch.setattr(fmt.StoredBLCO, "chunk_into", spy)
    monkeypatch.setattr(streaming, "_copy_chunk", lambda *a: pytest.fail(
        "the plan must read into the ring, not copy a chunk tuple"))
    plan.mttkrp(_torch(_factors(t.dims)), 0)
    assert [i for i, _ in seen] == list(range(len(port.launches)))
    assert {ptrs for _, ptrs in seen} == ring
    plan.close()


# --------------------------------------------------------------- plan_for
def test_plan_for_disk_regime_and_host_budget(tmp_path, monkeypatch):
    """plan_for picks the disk tier when the tensor exceeds the host
    budget, honours backend="disk_streamed", and cleans up temp spills."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    t, ref, port = _setup("order3-ragged")
    f = _factors(t.dims)
    ft = _torch(f)
    budget = rcore.format_bytes(ref) - 1
    assert core.format_bytes(port) == rcore.format_bytes(ref)
    plan = plan_for(port, 1 << 40, rank=RANK, host_budget_bytes=budget,
                    device="cpu")
    assert isinstance(plan, DiskStreamedPlan)
    rplan = rengine.plan_for(ref, 1 << 40, rank=RANK,
                             host_budget_bytes=budget)
    assert isinstance(rplan, rstore.DiskStreamedPlan)
    rplan.close()
    temp_file = plan.stored.path
    assert os.path.dirname(temp_file) == str(tmp_path)
    assert _rel(plan.mttkrp(ft, 0), rcore.mttkrp_dense_oracle(t, f, 0)) \
        < F32_TOL
    plan.close()
    assert not os.path.exists(temp_file)    # anonymous spill is cleaned up

    # a generous host budget stays in memory
    assert isinstance(plan_for(port, 1 << 40, rank=RANK,
                               host_budget_bytes=1 << 40, device="cpu"),
                      InMemoryPlan)
    # explicit backend + explicit store path -> the file is kept
    keep = str(tmp_path / "kept.blco")
    plan = plan_for(port, 1 << 40, rank=RANK, backend="disk_streamed",
                    store_path=keep, queues=2, device="cpu")
    assert plan.backend == "disk_streamed" and not plan.delete_on_close
    plan.mttkrp(ft, 1)
    plan.close()
    assert os.path.exists(keep)
    assert open_blco(keep, verify=True).reservation_nnz == plan.spec.nnz

    # the device budget still binds: reservation + factors must fit
    with pytest.raises(ValueError, match="disk-streamed plan needs"):
        plan_for(port, 1, rank=RANK, backend="disk_streamed", device="cpu")
    with pytest.raises(ValueError, match="disk-streamed plan needs"):
        plan_for(port, 1, rank=RANK, host_budget_bytes=budget, device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["kept.blco"]


def test_plan_for_leaves_no_orphan_spill(tmp_path, monkeypatch):
    """A spill that fails mid-write leaves neither the anonymous file nor
    its temporary behind."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    _, _, port = _setup("order3-ragged")

    class Boom(fmt.LaunchChunks):
        def chunk_into(self, i, bufs):
            raise OSError("disk full")

    monkeypatch.setattr(fmt, "LaunchChunks", Boom)
    with pytest.raises(OSError, match="disk full"):
        plan_for(port, 1 << 40, rank=RANK, host_budget_bytes=1,
                 device="cpu")
    assert os.listdir(tmp_path) == []


# -------------------------------------------------------------- sanitizer
def test_sanitize_env_gate(monkeypatch):
    monkeypatch.delenv("REPRO_SANITIZE", raising=False)
    assert not sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert sanitize_enabled()
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert not sanitize_enabled()
    with sanitized():
        assert sanitize_enabled()        # override beats the environment
    assert not sanitize_enabled()


@pytest.mark.parametrize("backend", ["in_memory", "streamed",
                                     "disk_streamed"])
def test_sanitized_plan_bit_identical(backend, tmp_path):
    """sanitize=True changes nothing about the numbers — the wrapper only
    inspects, on every backend tier."""
    t, _, port = _setup("order4-stash")
    ft = _torch(_factors(t.dims))
    kwargs = dict(rank=RANK, backend=backend, queues=2, device="cpu")
    plain = plan_for(port, 1 << 30, sanitize=False,
                     store_path=str(tmp_path / "a.blco"), **kwargs)
    sane = plan_for(port, 1 << 30, sanitize=True,
                    store_path=str(tmp_path / "b.blco"), **kwargs)
    assert type(sane) is SanitizedPlan and type(plain) is not SanitizedPlan
    assert isinstance(sane, type(plain))        # regime checks see through
    assert wrap_plan(sane, enable=True) is sane  # idempotent
    assert sane.plan.backend == backend
    for mode in range(t.order):
        torch.testing.assert_close(sane.mttkrp(ft, mode),
                                   plain.mttkrp(ft, mode), rtol=0, atol=0)
    plain.close()
    sane.close()


class _FakePlan:
    """Minimal ExecutionPlan double with a controllable mttkrp result."""
    dims = (4, 3)
    backend = "fake"

    def __init__(self, result):
        self._result = result

    def mttkrp(self, factors, mode):
        return self._result


def test_sanitizer_rejects_factor_shape_and_mode():
    plan = SanitizedPlan(_FakePlan(torch.zeros(4, 2)))
    good = [torch.zeros(4, 2), torch.zeros(3, 2)]
    with pytest.raises(SanitizerError, match="factor matrices"):
        plan.mttkrp(good[:1], 0)
    with pytest.raises(SanitizerError, match="out of range"):
        plan.mttkrp(good, 2)
    with pytest.raises(SanitizerError, match="factor 1 has shape"):
        plan.mttkrp([torch.zeros(4, 2), torch.zeros(5, 2)], 0)
    assert plan.mttkrp(good, 0).shape == (4, 2)


def test_sanitizer_rejects_output_shape_downcast_and_nonfinite(tmp_path):
    good = [torch.zeros(4, 2), torch.zeros(3, 2)]
    with pytest.raises(SanitizerError, match="output shape"):
        SanitizedPlan(_FakePlan(torch.zeros(3, 2))).mttkrp(good, 0)
    with pytest.raises(SanitizerError, match="downcast"):
        SanitizedPlan(_FakePlan(torch.zeros(4, 2, dtype=torch.float16))) \
            .mttkrp(good, 0)
    with pytest.raises(SanitizerError, match="non-finite"):
        SanitizedPlan(_FakePlan(torch.full((4, 2), float("nan")))) \
            .mttkrp(good, 0)
    # f64 values with f32 factors must come out f64 (the store's dtype)
    fake = _FakePlan(torch.zeros(4, 2))
    fake.stored = type("S", (), {"value_dtype": np.dtype(np.float64)})()
    with pytest.raises(SanitizerError, match="downcast"):
        SanitizedPlan(fake).mttkrp(good, 0)


def test_check_factors_guards_nan():
    with sanitized():
        check_factors([torch.ones(3, 2)], "ok")
        with pytest.raises(SanitizerError, match="non-finite factor"):
            check_factors([torch.ones(3, 2),
                           torch.full((2, 2), float("inf"))], "sweep 3")
    with sanitized(False):
        check_factors([torch.full((2, 2), float("nan"))], "off")
