"""K4's launch layout (``blco_mttkrp.segments_layout``), checked without a
card: the stages fit one CTA's shared memory, the pieces cover the stream's
tiles exactly once, the bulk-copy fill is chosen exactly when every span it
would copy is 16-byte aligned, and the grid is one wave."""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import blco_mttkrp as bm
from repro_torch.kernels.common import STASH_MAX_BYTES

PHASES_CU = Path(bm.__file__).resolve().parent / "csrc" / "phases.cu"
# (values itemsize, gathered rows itemsize): f32 x f32, f64 x f64, f64 x f32
PAIRS = {"f32": (4, 4), "f64": (8, 8), "f64xf32": (8, 4)}


def _pieces(lay):
    """Every piece ``(start, length)`` in stream order, by the kernel's
    formula: task q's p-th piece starts at q * span + p * rows (a warp
    takes tasks in a grid-stride, all pieces of each)."""
    for task in range(lay.tasks):
        for p in range(lay.pieces_per_task):
            start = task * lay.span + p * lay.rows
            yield start, min(lay.rows, lay.span - p * lay.rows,
                             lay.t - start)


def test_k4_shape_mirrors_the_source():
    src = PHASES_CU.read_text()
    for name in ("K4_WARPS", "K4_MAX_STAGES", "K4_MAX_ROWS",
                 "K4_BAR_BYTES"):
        found = re.search(rf"^#define {name} (\d+)$", src, re.M)
        assert found and int(found.group(1)) == getattr(bm, name), name
    assert bm.K4_BAR_BYTES >= 8 * bm.K4_MAX_STAGES
    assert bm.K4_BAR_BYTES % 16 == 0


@pytest.mark.parametrize("pair", PAIRS.values(), ids=PAIRS.keys())
@pytest.mark.parametrize("order", range(2, 9))
def test_stages_fit_shared_memory(order, pair):
    """Every order 2-8, R 1-64 and tile 1-256 gets rings of 2 or 3 stages
    of at most K4_MAX_ROWS slots within 227 KB per CTA."""
    for rank in range(1, 65):
        for tile in range(1, 257):
            lay = bm.segments_layout(4 * tile, tile, rank, order - 1, *pair,
                                     aligned=True)
            assert lay.smem <= STASH_MAX_BYTES
            assert 1 <= lay.rows <= bm.K4_MAX_ROWS
            assert 2 <= lay.stages <= bm.K4_MAX_STAGES
            assert lay.smem == bm.K4_WARPS * (
                bm.K4_BAR_BYTES + -(-rank * max(pair) // 16) * 16
                + lay.stages * lay.stage_bytes)


# (t, tile, rank, order): NELL-2's and Uber's padded streams at full size
# are too long to enumerate here, so their tile counts are checked apart
COVER_CASES = [(2048, 256, 32, 3), (1152, 96, 33, 3), (63, 1, 8, 4),
               (64, 1, 8, 4), (1200, 24, 5, 3), (3 * 256, 256, 64, 8),
               (600, 3, 1, 3), (7 * 250, 250, 40, 5), (96, 96, 1, 2),
               (4096, 128, 64, 8)]


@pytest.mark.parametrize("pair", PAIRS.values(), ids=PAIRS.keys())
@pytest.mark.parametrize("t,tile,rank,order", COVER_CASES)
def test_pieces_cover_the_tiles_once(t, tile, rank, order, pair):
    """The pieces, in stream order, cover every slot once; a piece lies
    inside one tile or holds whole tiles, and fits its stage."""
    lay = bm.segments_layout(t, tile, rank, order - 1, *pair, aligned=True)
    pieces = list(_pieces(lay))
    assert len(pieces) == lay.tasks * lay.pieces_per_task
    at = 0
    for start, length in pieces:
        assert start == at and 1 <= length <= lay.rows
        first, last = start // tile, (start + length - 1) // tile
        assert first == last or (start % tile == 0
                                 and (start + length) % tile == 0)
        at += length
    assert at == t
    # a task is one tile, or whole tiles in one piece
    assert lay.span == tile or (lay.pieces_per_task == 1
                                and lay.span % tile == 0)


@pytest.mark.parametrize("t,tiles", [(83_886_080, 327_680),
                                     (3_670_016, 14_336)])
def test_full_size_streams_are_whole_tiles(t, tiles):
    """NELL-2's (order 3) and Uber's (order 4) f32 streams at R = 32: 32-slot
    stages by bulk copies, two CTAs per SM; 3 stages at order 3, 2 at 4."""
    for order, stages in ((3, 3), (4, 2)):
        lay = bm.segments_layout(t, 256, 32, order - 1, 4, 4, aligned=True)
        assert lay.tasks == tiles and lay.span == 256
        assert lay.rows == 32 and lay.pieces_per_task == 8 and lay.bulk
        assert lay.stages == stages and lay.smem <= bm.K4_PAIR_BYTES


def _spans_aligned(lay, rank, pair) -> bool:
    """Every (offset, size) a bulk copy of each piece would take, for
    vals, tgt and one gathered matrix, is a multiple of 16 B."""
    vi, fi = pair
    for start, length in _pieces(lay):
        for item in (vi, 4, rank * fi):
            if (start * item) % 16 or (length * item) % 16:
                return False
    return True


@pytest.mark.parametrize("pair", PAIRS.values(), ids=PAIRS.keys())
@pytest.mark.parametrize("rank", [1, 8, 32, 33, 40, 64])
def test_bulk_fill_exactly_when_every_span_is_aligned(rank, pair):
    for tile in (1, 2, 3, 4, 5, 8, 12, 24, 31, 32, 64, 96, 100, 250, 256):
        for tiles in (1, 2, 3, 7, 12):
            t = tile * tiles
            for order in (3, 4, 8):
                lay = bm.segments_layout(t, tile, rank, order - 1, *pair,
                                         aligned=True)
                assert lay.bulk == _spans_aligned(lay, rank, pair), \
                    (t, tile, order, lay)
                assert lay.fill == ("bulk" if lay.bulk else "cp.async")
                # a tensor that does not start on 16 B never takes bulk
                assert not bm.segments_layout(t, tile, rank, order - 1,
                                              *pair, aligned=False).bulk


@pytest.mark.parametrize("tasks_scale", [0.001, 0.5, 1, 3, 310])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (1, 1)])
def test_blocks_are_one_wave_without_idle_ctas(tasks_scale, sms, per_sm):
    t = max(1, int(tasks_scale * sms * per_sm * bm.K4_WARPS)) * 256
    lay = bm.segments_layout(t, 256, 32, 2, 4, 4, aligned=True)
    blocks = lay.blocks(sms, per_sm)
    assert 1 <= blocks <= sms * per_sm                    # one wave
    assert (blocks - 1) * bm.K4_WARPS < lay.tasks         # no idle CTA
    geo = bm.SegmentsGeometry(lay, blocks, sms, per_sm)
    assert geo.waves == 1
    assert geo.bytes_in_flight_per_sm == (per_sm * bm.K4_WARPS
                                          * (lay.stages - 1)
                                          * lay.stage_bytes)


def test_layout_prefers_two_ctas_per_sm():
    """Where any ring lets two CTAs share an SM, the layout takes one."""
    for rank in (1, 8, 32, 33, 40, 64):
        for order in range(2, 9):
            for pair in PAIRS.values():
                lay = bm.segments_layout(256, 256, rank, order - 1, *pair,
                                         aligned=True)
                if bm._k4_smem(4, 2, rank, order - 1, *pair) \
                        <= bm.K4_PAIR_BYTES:
                    assert lay.smem <= bm.K4_PAIR_BYTES, lay
                    assert lay.rows % 4 == 0, lay


def test_layout_refuses_what_cannot_launch():
    with pytest.raises(ValueError):      # one slot's stages exceed 227 KB
        bm.segments_layout(256, 256, 2000, 7, 8, 8, aligned=True)
    for args in ((0, 1, 8, 2), (100, 7, 8, 2), (512, 512, 8, 2),
                 (256, 256, 0, 2), (256, 256, 8, 0), (256, 256, 8, 8)):
        with pytest.raises(ValueError):
            bm.segments_layout(*args, 4, 4, aligned=True)
