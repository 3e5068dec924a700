"""The plan of the gain kernels C and D
(``repro_torch.kernels.knn.gains._gain_plan``), on the CPU.

The kernels never split the request axis (each candidate's sum keeps one
fixed order), so blocks own whole, ordered tiles of ``O_TILE``
candidates, resident in shared memory where their rows fit and streamed
beside the requests where they are too wide. These tests hold what the
kernels rely on: the tiles cover 0..O once, in order; the shared memory
fits a block; and the stream phase's 20,000 candidates give every SM of
an H100 a block.
"""
import pytest

from repro_torch.kernels.knn import gains as G

N_SM = 132                     # an H100 SXM's SMs


@pytest.mark.parametrize("O", [1, 127, 128, 129, 16_385, 20_000, 100_000])
@pytest.mark.parametrize("D", [1, 13, 100, 1000])
@pytest.mark.parametrize("per_request_h", [False, True])
def test_plan_covers_every_candidate_with_whole_ordered_tiles(
        O, D, per_request_h):
    tiles = G._gain_plan(O, D, 1, 3, per_request_h).tiles()
    assert tiles[0][0] == 0 and tiles[-1][1] == O
    assert all(b == c for (_, b), (c, _) in zip(tiles, tiles[1:]))
    assert all(e - s == G.O_TILE for s, e in tiles[:-1])
    assert 0 < tiles[-1][1] - tiles[-1][0] <= G.O_TILE
    assert len(tiles) == -(-O // G.O_TILE)


@pytest.mark.parametrize("per_request_h", [False, True])
def test_plan_fills_the_card_at_the_stream_catalog(per_request_h):
    plan = G._gain_plan(20_000, 100, 1, 3, per_request_h)
    assert len(plan.tiles()) >= N_SM
    assert not plan.y_stream


@pytest.mark.parametrize("D,y_stream", [(100, False), (300, False),
                                        (1000, True), (8192, True)])
@pytest.mark.parametrize("I,J", [(1, 3), (3, 8)])
@pytest.mark.parametrize("per_request_h", [False, True])
def test_plan_shared_memory_fits_a_block(D, y_stream, I, J, per_request_h):
    """227 KB a block: the engine's D 100 keeps its candidates resident,
    wide rows stream them."""
    plan = G._gain_plan(100_000, D, I, J, per_request_h)
    assert plan.y_stream == y_stream
    assert plan.smem_bytes <= G.SMEM_LIMIT == 227 * 1024
    assert plan.smem_bytes == G._smem_bytes(
        D, I, plan.j_width, per_request_h, plan.y_stream)
    assert plan.j_width >= J


@pytest.mark.parametrize("per_request_h", [False, True])
def test_plan_streams_rows_past_420(per_request_h):
    """At the engine's I 1, J 3 a row of 420 features still fits
    resident (128 × 420 floats beside the request ring), 421 does not."""
    assert not G._gain_plan(100_000, 420, 1, 3, per_request_h).y_stream
    assert G._gain_plan(100_000, 421, 1, 3, per_request_h).y_stream


def test_plan_j_widths_cover_one_to_eight():
    widths = {J: G._j_width(J, False) for J in range(1, 9)}
    assert widths == {1: 1, 2: 3, 3: 3, 4: 8, 5: 8, 6: 8, 7: 8, 8: 8}
    assert all(G._j_width(J, True) == 8 for J in range(1, 9))


def test_plan_candidate_stride_is_an_odd_number_of_float4s():
    for D in range(1, 300):
        s = G._cand_stride(D)
        assert s >= D and s % 4 == 0 and (s // 4) % 2 == 1


def test_plan_refuses_what_no_tile_fits():
    with pytest.raises(ValueError, match="ingresses"):
        G._gain_plan(1000, 100, 500, 3, False)
