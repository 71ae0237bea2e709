"""PyTorch port, the LEM kernels' grid (ops/lem_scan.py::lem_launch_shape),
checked on the CPU: at hidden 96 and 128 a cluster of C CTAs owns a tile of
rows, CTA i the hidden columns [i H/C, (i + 1) H/C); at 164 (the hidden-164
route) CTA i of a cluster owns 16 of its 64 rows and every column, padded to
168. Also the padding's premise, on the plain versions in float64. The
kernels themselves run on the card only (tests/test_torch_kernels_gpu.py)."""
import numpy as np
import pytest
import torch

from msmp_pde_torch.ops.lem_scan import (
    lem_cta_rows,
    lem_launch_shape,
    lem_scan_bwd_plain,
    lem_scan_plain,
)

SMS = 132          # an H100 SXM's SMs
SMEM_MAX = 232448  # the shared memory a CTA may use on it
ROWS = (1, 37, 100, 400, 1600)
HIDDEN = (96, 128)      # the cluster route
ALL_HIDDEN = HIDDEN + (164,)  # and the hidden-164 route


def owners(N, H, backward):
    """{(row, column): CTAs that own it} of lem_launch_shape's grid, a CTA
    over the lem_cta_rows(H) rows that follow those of the CTAs before it
    in its cluster: at hidden 96 and 128 CTA i of a cluster owns all the
    cluster's rows and the columns [i H/C, (i + 1) H/C); at 164 it owns
    the cluster's rows cta i + [0, cta) and every column."""
    rows, C, ctas, _ = lem_launch_shape(N, H, backward=backward)
    cta = lem_cta_rows(H)
    own = {}
    for b in range(ctas):
        cl, i = divmod(b, C)
        if H == 164:
            mine = range(cl * rows + cta * i, cl * rows + cta * (i + 1))
            cols = range(H)
        else:
            mine = range(cl * rows, cl * rows + cta)
            cols = range(i * H // C, (i + 1) * H // C)
        for r in mine:
            if r < N:
                for j in cols:
                    own[r, j] = own.get((r, j), 0) + 1
    return own


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("H", ALL_HIDDEN)
@pytest.mark.parametrize("N", ROWS)
def test_every_row_and_column_once(N, H, backward):
    rows, C, ctas, _ = lem_launch_shape(N, H, backward=backward)
    assert ctas % C == 0
    for cl in range(ctas // C):
        assert cl * rows < N, "a cluster with no rows"
    own = owners(N, H, backward)
    assert set(own) == {(r, j) for r in range(N) for j in range(H)}
    assert set(own.values()) == {1}


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
@pytest.mark.parametrize("H", ALL_HIDDEN)
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


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("N", [37, 100, 400, 1600])
def test_hidden164_route_shape(N, backward):
    """Hidden 164: clusters of 4 CTAs, 16 rows a CTA (one m16 tile), so the
    grid is 4 cdiv(N, 64) CTAs, a multiple of 4, in which the CTAs past the
    last row (1, 1 and 3 at N = 37, 100, 400) hold none; every row once;
    one wave of at most 132 CTAs at N = 1600."""
    rows, C, ctas, _ = lem_launch_shape(N, 164, backward=backward)
    cta = lem_cta_rows(164)
    assert cta == 16 and (rows, C) == (C * cta, 4)
    assert ctas % 4 == 0 and ctas == 4 * -(-N // 64)
    assert ctas - -(-N // cta) == {37: 1, 100: 1, 400: 3, 1600: 0}[N]
    per_row = [0] * N
    for b in range(ctas):  # the kernels' row0 = blockIdx.x * GR
        for r in range(cta * b, min(cta * (b + 1), N)):
            per_row[r] += 1
    assert per_row == [1] * N
    assert sorted(r for (r, j) in owners(N, 164, backward) if j == 0) \
        == list(range(N))
    if N == 1600:
        assert ctas == 100 <= SMS


@pytest.mark.parametrize("backward", [False, True])
def test_hidden164_shared_memory(backward):
    """A hidden-164 CTA's shared memory: ring stages of 24 k-rows of 168
    floats (12 in the forward, 8 in the backward), row buffers of 16 rows
    at a pitch of 172 floats (y, z; or y_prev and z_t twice each and da)
    and the dg rows at 3 * 168 + 4, a full and an empty barrier a stage and
    128 bytes of phase counters: within a CTA's 232,448 bytes."""
    stages, rows = (8, 5 * 16 * 172 + 16 * 508) if backward else (12,
                                                                   2 * 16 * 172)
    want = stages * 24 * 168 * 4 + 4 * rows + 2 * 8 * stages + 128
    for N in (37, 1600):
        assert lem_launch_shape(N, 164, backward=backward)[3] == want
    assert want <= SMEM_MAX
    assert want == (216832 if backward else 215872)


def _pad(x, H, HP, blocks=1):
    """x [..., blocks H] -> [..., blocks HP]: each block of H columns at
    the start of a block of HP, zeros after it."""
    out = x.new_zeros(x.shape[:-1] + (blocks * HP,))
    for q in range(blocks):
        out[..., q * HP:q * HP + H] = x[..., q * H:(q + 1) * H]
    return out


def _unpad(x, H, HP, blocks=1):
    """(x's first H columns of each block, its padded columns)"""
    keep = torch.cat([x[..., q * HP:q * HP + H] for q in range(blocks)], -1)
    pad = torch.cat([x[..., q * HP + H:(q + 1) * HP] for q in range(blocks)],
                    -1)
    return keep, pad


@pytest.mark.parametrize("dt", [1.0, 0.5])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_zero_padding_to_168_is_exact(direction, dt):
    """The hidden-164 kernels pad 164 to 168 inside the kernel. Zero-padding
    Wy's rows and each of its three gate blocks, Wzz, gx (each gate block),
    zx, y0 and z0 (and the cotangents) leaves the first 164 columns of yT,
    zT, the stash and every gradient those of the unpadded scan, within
    1e-12 in float64, and the padded columns exactly zero."""
    H, HP, T, N = 164, 168, 5, 9
    rng = np.random.default_rng(7)
    r = lambda *s, scale=1.0: torch.tensor(rng.normal(size=s) * scale)
    gx, zx = r(T, N, 3 * H), r(T, N, H)
    y0, z0 = r(N, H, scale=.5), r(N, H, scale=.5)
    wy, wzz = r(H, 3 * H, scale=H ** -.5), r(H, H, scale=H ** -.5)
    wy_p = torch.zeros(HP, 3 * HP, dtype=wy.dtype)
    wy_p[:H] = _pad(wy, H, HP, 3)
    wzz_p = torch.zeros(HP, HP, dtype=wzz.dtype)
    wzz_p[:H, :H] = wzz
    args = (gx, zx, y0, z0, wy, wzz)
    args_p = (_pad(gx, H, HP, 3), _pad(zx, H, HP), _pad(y0, H, HP),
              _pad(z0, H, HP), wy_p, wzz_p)
    fwd = lem_scan_plain(*args, dt=dt, stash=True)
    fwd_p = lem_scan_plain(*args_p, dt=dt, stash=True)
    pairs = list(zip(fwd, fwd_p, [1] * 4))
    if direction == "backward":
        dyT, dzT = r(N, H), r(N, H)
        bwd = lem_scan_bwd_plain(*args, *fwd[2:], dyT, dzT, dt=dt)
        bwd_p = lem_scan_bwd_plain(*args_p, *fwd_p[2:], _pad(dyT, H, HP),
                                   _pad(dzT, H, HP), dt=dt)
        # dgx, dzx, dy0, dz0, dwy (its rows padded too), dwzz
        pairs = list(zip(bwd[:4], bwd_p[:4], (3, 1, 1, 1)))
        for want, got, blocks in ((bwd[4], bwd_p[4], 3), (bwd[5], bwd_p[5],
                                                           1)):
            assert not got[H:].any()  # the padded rows
            pairs.append((want, got[:H], blocks))
    for want, got, blocks in pairs:
        keep, pad = _unpad(got, H, HP, blocks)
        assert torch.allclose(keep, want, rtol=0, atol=1e-12)
        assert not pad.any()


@pytest.mark.parametrize("H", [16, 32, 64, 100, 160, 192, 256])
def test_unsupported_hidden_raises(H):
    for backward in (False, True):
        with pytest.raises(ValueError, match="hidden"):
            lem_launch_shape(100, H, backward=backward)
    with pytest.raises(ValueError, match="hidden"):
        lem_cta_rows(H)


def test_no_rows_raises():
    with pytest.raises(ValueError):
        lem_launch_shape(0, 128)
