"""PyTorch port, the LEM kernels' cluster grid (ops/lem_scan.py::
lem_launch_shape), checked on the CPU: a cluster of C CTAs owns a tile of
rows, CTA i the hidden columns [i H/C, (i + 1) H/C). The kernels themselves
run on the card only (tests/test_torch_kernels_gpu.py)."""
import pytest

from msmp_pde_torch.ops.lem_scan import lem_launch_shape

SMS = 132          # an H100 SXM's SMs
SMEM_MAX = 232448  # the shared memory a CTA may use on it
ROWS = (1, 37, 100, 400, 1600)
HIDDEN = (96, 128)


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", HIDDEN)
@pytest.mark.parametrize("N", ROWS)
def test_every_row_and_column_once(N, H, backward):
    rows, C, ctas, _ = lem_launch_shape(N, H, backward=backward)
    assert ctas % C == 0
    clusters = ctas // C
    owner = [0] * N
    for cl in range(clusters):
        tile = range(cl * rows, min((cl + 1) * rows, N))
        assert len(tile) > 0, "a cluster with no rows"
        for r in tile:
            owner[r] += 1
    assert owner == [1] * N
    cols = [0] * H
    for i in range(C):
        for j in range(i * H // C, (i + 1) * H // C):
            cols[j] += 1
    assert cols == [1] * H


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", HIDDEN)
def test_shape_fits_a_cta(H, backward):
    """H/C is a multiple of 8 (one m16n8 tile a warp), the rows a multiple
    of 16, at most 16 warps a CTA, and the shared memory within a CTA's."""
    for N in ROWS:
        rows, C, _, smem = lem_launch_shape(N, H, backward=backward)
        assert (H // C) % 8 == 0 and H % C == 0
        assert rows % 16 == 0
        assert (rows // 16) * (H // C // 8) <= 16
        assert 0 < smem <= SMEM_MAX


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", HIDDEN)
def test_one_wave_at_bucket_16(H, backward):
    """At N = 1600 (bucket 16 of nx 100) every CTA has an SM of its own on
    an H100's 132, so the whole grid runs at once."""
    _, _, ctas, smem = lem_launch_shape(1600, H, backward=backward)
    assert ctas <= SMS
    assert smem <= SMEM_MAX


def test_clusters_own_64_rows():
    """A cluster owns 64 rows (one wgmma tile of the forward) in both
    directions: 2 clusters at bucket 1, 7 at 4, 25 at 16."""
    for backward in (False, True):
        assert lem_launch_shape(100, 128, backward=backward)[:3] == (64, 4, 8)
        assert lem_launch_shape(400, 128, backward=backward)[:3] == (64, 4, 28)
        assert lem_launch_shape(1600, 128, backward=backward)[:3] == (
            64, 4, 100)


@pytest.mark.parametrize("H", [16, 32, 64, 100, 160, 164, 256])
def test_unsupported_hidden_raises(H):
    for backward in (False, True):
        with pytest.raises(ValueError, match="hidden"):
            lem_launch_shape(100, H, backward=backward)


def test_no_rows_raises():
    with pytest.raises(ValueError):
        lem_launch_shape(0, 128)
