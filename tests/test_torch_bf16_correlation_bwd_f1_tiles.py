"""The arithmetic of the bf16 correlation backward's tensor-core body for
f1, on the CPU.

On the card, ``correlation_bwd_f1_bf16`` (K5) and
``correlation_bwd_f1_rows_bf16`` (K7's d_f1) run FlowNetC's
configuration (maxd 20, s2 2) as the TPU kernel's band product
(``flownet2_tpu_torch/csrc/correlation_bwd.cu``,
``correlation_bwd_f1_mma_kernel``): per tile of 16 output columns x of
one output row and per row shift tj, the band matrix of the cotangent,
``Band[k][m] = g[tj*D + ti][y][x0 + m]`` at
``k = m + lead - maxd + s2*ti`` and zero elsewhere (lead 24 at maxd 20,
so ``k = m + 4 + 2ti``): the band is read at the output column, not at
the source column as in d_f2.  It multiplies the f2 window
``f2[c][y2][x0 - lead + k]`` of 16 + 2 lead columns, 16 columns (a
k-step) at a time, each k-step's float32 partial added in order, the
shifts in ascending order; then one division by C and one rounding to
bf16.  ``band_product_bwd_f1`` below is a small torch emulation of that
arithmetic, written here and not in the package, and the tests hold it to
the port's plain versions and to the TPU kernel.  ``test_band_registers``
rebuilds the body's band fragments from its lane formula over a flat copy
of its shared memory.  The kernel's bits are held on the card
(``chip_smoke.py`` phase 2, ``kernel_ab.py``).

Tolerances:
- against ``correlation_bwd_plain`` and ``corr_slab_bwd_plain`` in bf16:
  one bf16 ulp (rtol 2**-7, atol 1e-6 of the largest |out|) with at most
  1% of the values not bit-equal, the card's gate: both sum exact products
  in float32 in other orders before the one rounding;
- every band's d_f1 against the same rows of the whole map: bit for bit,
  since each output row is summed over the same shifts and k-steps either
  way (a shift whose f2 row lies outside the map adds exact zeros in the
  slab form, where the whole map skips it);
- against the TPU kernel in interpret mode: the tolerance of
  ``tests/test_torch_bf16.py``'s own case (rtol 0.05, atol 0.02).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu_torch.ops import correlation, correlation_spatial

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

jax_corr_pallas = importlib.import_module(
    "flownet2_tpu.ops.correlation_pallas")

BF16_ULP = 2.0 ** -7
TILE = 16       # output columns a tile, window columns a k-step


def _lead(maxd):
    """The window's start left of the tile: maxd rounded up to 8 columns
    (16-byte pieces of bf16)."""
    return -(-maxd // 8) * 8


def band_matrix(g_tile, maxd=20, s2=2):
    """The band of one row shift: ``g_tile`` (..., D, 16) holds the
    cotangent planes of that shift at a tile's output columns; returns
    (..., window, 16), Band[k][m] = g_tile[ti][m] at k = m + lead - maxd +
    s2*ti, zero elsewhere."""
    disp = 2 * (maxd // s2) + 1
    lead = _lead(maxd)
    band = torch.zeros(*g_tile.shape[:-2], TILE + 2 * lead, TILE)
    m = torch.arange(TILE)
    for ti in range(disp):
        band[..., m + lead - maxd + s2 * ti, m] = g_tile[..., ti, :]
    return band


def band_product_bwd_f1(g, f2, maxd=20, s2=2, slab=False):
    """The tensor-core body's arithmetic.  g (B, D*D, H, W) and f2
    (B, C, H, W) or, with ``slab``, the halo slab (B, C, H + 2 maxd, W),
    bf16; returns d_f1 (B, C, H, W), bf16."""
    dtype = f2.dtype
    g, f2 = g.float(), f2.float()
    batch, _, height, width = g.shape
    channels, rows2 = f2.shape[1], f2.shape[2]
    disp = 2 * (maxd // s2) + 1
    lead = _lead(maxd)
    span = TILE + 2 * lead
    tiles = -(-width // TILE)
    shift = maxd if slab else 0
    # zero fill: g's columns to whole tiles, f2's also a window of lead
    # columns either side of each tile
    g = F.pad(g, (0, tiles * TILE - width)).unflatten(3, (tiles, TILE))
    f2 = F.pad(f2, (lead, tiles * TILE - width + lead))
    acc = torch.zeros(batch, channels, height, tiles, TILE)
    for tj in range(disp):
        rows = torch.arange(height) + shift - maxd + s2 * tj    # f2 rows
        inside = ((rows >= 0) & (rows < rows2)).view(1, 1, -1, 1, 1)
        f2_win = f2[:, :, rows.clamp(0, rows2 - 1)].unfold(3, span, TILE)
        f2_win = f2_win * inside                  # (B, C, H, tiles, span)
        band = band_matrix(g[:, tj * disp:(tj + 1) * disp].movedim(1, 3),
                           maxd, s2)              # (B, H, tiles, span, 16)
        for ks in range(span // TILE):
            part = torch.zeros_like(acc)   # one k-step, its columns in order
            for k in range(ks * TILE, (ks + 1) * TILE):
                part = part + (band[:, None, ..., k, :]
                               * f2_win[..., k:k + 1])
            acc = acc + part
    out = acc.flatten(3)[..., :width] / channels
    return out.to(dtype)


def _bf16(shape, seed):
    """Seeded normal values as a bf16 tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16()


def _inputs(shape, seed, maxd=20, s2=2):
    """g (B, D*D, H, W), f1 and f2 (B, C, H, W), bf16, NCHW."""
    disp = 2 * (maxd // s2) + 1
    batch, _, height, width = shape
    return (_bf16((batch, disp * disp, height, width), seed),
            _bf16(shape, seed + 1), _bf16(shape, seed + 2))


def _band(g, f1, f2, off, local_h, maxd=20):
    """Band rows [off, off + local_h): g and f1's rows and f2's halo slab."""
    rows = slice(off, off + local_h)
    slab = F.pad(f2, (0, 0, maxd, maxd))[:, :, off:off + local_h + 2 * maxd]
    return (g[:, :, rows].contiguous(), f1[:, :, rows].contiguous(),
            slab.contiguous())


def _one_ulp(got, want, what):
    """One bf16 ulp and at most 1% of the values not bit-equal."""
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape, (got.shape, want.shape)
    g, w = got.float().numpy(), want.float().numpy()
    flips = float(np.mean(g != w))
    print(f"{what}: max abs diff {np.abs(g - w).max():.3e}, not bit-equal "
          f"{flips:.4%}")
    np.testing.assert_allclose(g, w, rtol=BF16_ULP,
                               atol=1e-6 * float(np.abs(w).max()),
                               err_msg=what)
    assert flips <= 0.01, (what, flips)


@pytest.mark.parametrize("shape", [(8, 32, 8, 56), (2, 40, 20, 152)])
def test_band_product_bwd_f1_matches_plain(shape):
    """FlowNetC's configuration; C = 40 is no multiple of 16 and W = 152
    none of the kernel's 64-column tiles."""
    g, f1, f2 = _inputs(shape, 0)
    got = band_product_bwd_f1(g, f2)
    want = correlation.correlation_bwd_plain(g, f1, f2, 20, 2,
                                             needs=(True, False))[0]
    _one_ulp(got, want, f"band product d_f1 {shape}")


@pytest.mark.parametrize("band", [0, 1])
@pytest.mark.parametrize("shape", [(8, 32, 8, 56), (2, 40, 20, 152)])
def test_band_product_bwd_f1_slab_form(shape, band):
    """Band ``band`` of two: d_f1 against the slab's plain version at one
    ulp."""
    g, f1, f2 = _inputs(shape, 3)
    local_h = shape[2] // 2
    g_loc, f1_loc, slab = _band(g, f1, f2, band * local_h, local_h)
    got = band_product_bwd_f1(g_loc, slab, slab=True)
    want = correlation_spatial.corr_slab_bwd_plain(
        g_loc, f1_loc, slab, 20, 2, needs=(True, False))[0]
    _one_ulp(got, want, f"band product K7 d_f1, band {band} of 2, {shape}")


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("shape", [(8, 32, 8, 56), (2, 40, 5, 64)])
def test_band_product_bands_are_the_whole_map(shape, shards):
    """Every band of 1, 2 and 4 gives the whole map's d_f1 rows bit for
    bit; at 5 rows the bands of 4 are one row each, and 40 of the 41 rows
    of each slab are halo."""
    g, f1, f2 = _inputs(shape, 6)
    whole = band_product_bwd_f1(g, f2)
    local_h = shape[2] // shards
    for band in range(shards):
        off = band * local_h
        g_loc, _, slab = _band(g, f1, f2, off, local_h)
        got = band_product_bwd_f1(g_loc, slab, slab=True)
        assert torch.equal(got, whole[:, :, off:off + local_h]), (shards,
                                                                  band)


@pytest.mark.parametrize("maxd, s2", [(20, 2), (4, 2), (4, 1)])
def test_band_matrix_places_g_at_the_output_column(maxd, s2):
    """Each g[tj*D + ti] value of output column x sits at the band row of
    the f2 column that the general body reads for x and column shift ti,
    x + (ti - r)*s2, in the column of x, and every other entry is zero."""
    disp = 2 * (maxd // s2) + 1
    rad = maxd // s2
    lead = _lead(maxd)
    g_tile = torch.arange(1, disp * TILE + 1,
                          dtype=torch.float32).view(disp, TILE)
    band = band_matrix(g_tile, maxd, s2)
    x0 = 64                    # the tile's first output column
    want = torch.zeros(TILE + 2 * lead, TILE)
    for m in range(TILE):
        x = x0 + m
        for ti in range(disp):
            x2 = x + (ti - rad) * s2               # the general body's column
            want[x2 - (x0 - lead), m] = g_tile[ti, m]
    assert torch.equal(band, want)


# The body's shared-memory geometry (correlation_bwd.cu, namespace band).
ROWS, DISP, PITCH, PAD = 4, 21, 72, 9   # rows a block, planes, pitch, pad


def _meets(j, s):
    """band::meets: n-tile j reads window columns 8j + 4 .. 8j + 51."""
    return j // 2 <= s <= j // 2 + 3


def test_band_registers():
    """The body's band fragments from its lane formula: lane (gq, qq), n-tile
    j, k-step s and register h load the 4-byte pair at a fixed offset
    j (8 - 4 pitch) + s 8 pitch + h 4 pitch from the lane's base (plane
    ti0 = qq - (gq >> 1) - 2 of the warp's row, column 32 half + 2 (gq >> 1))
    and keep the half gq & 1 where plane ti0 + 4 (2s + h - j) lies in
    [0, 21), one of 9 masks.  Over two stages of staged cotangent rows, with
    garbage in the columns past the 64 staged, in the 9 rows before the
    stages (the f2 ring there) and in the 9-row pad after them, every
    register that ``meets`` admits is the band's m16n8k16 B fragment
    exactly; the admitted pairs cover every nonzero of the band; every load
    stays inside the allocation; and the 16 words of each band load lie on
    16 distinct banks."""
    rng = np.random.RandomState(0)
    stage = ROWS * DISP * PITCH
    before = PAD * PITCH        # the ring's tail below the first stage
    smem = rng.randint(1, 1 << 16, size=before + 2 * stage + PAD * PITCH,
                       dtype=np.uint32)   # bf16 bit patterns, 0 nowhere
    for st in range(2):
        for r in range(ROWS):
            for half in range(2):
                # the band of warp (r, half): window rows k of 80, its 32
                # output columns n, Band[k][n] = g[ti][32 half + n] at
                # k = n + 4 + 2 ti
                band = np.zeros((80, 32), np.uint32)
                row = before + st * stage + r * DISP * PITCH
                for ti in range(DISP):
                    n = np.arange(32)
                    band[n + 4 + 2 * ti, n] = smem[row + ti * PITCH
                                                   + 32 * half + n]
                covered = np.zeros_like(band, bool)
                for lane in range(32):
                    gq, qq = lane >> 2, lane & 3
                    keep = 0xFFFF0000 if gq & 1 else 0x0000FFFF
                    ti0 = qq - (gq >> 1) - 2
                    base = row + ti0 * PITCH + 2 * (gq >> 1) + 32 * half
                    for j in range(4):
                        for s in range(5):
                            if not _meets(j, s):
                                continue
                            for h in range(2):
                                m = 2 * s + h - j
                                assert -1 <= m <= 7   # 9 masks
                                at = (base + j * (8 - 4 * PITCH)
                                      + s * 8 * PITCH + h * 4 * PITCH)
                                assert 0 <= at and at + 1 < smem.size
                                word = smem[at] | smem[at + 1] << 16
                                mask = keep if 0 <= ti0 + 4 * m < DISP else 0
                                k = 16 * s + 8 * h + 2 * qq
                                n = 8 * j + gq
                                want = band[k, n] | band[k + 1, n] << 16
                                assert word & mask == want, (st, r, half,
                                                             lane, j, s, h)
                                covered[k:k + 2, n] = True
                assert not (band.astype(bool) & ~covered).any()
    # banks: the lanes' words of one load, at the pitch of 72
    for j, s, h in ((0, 0, 0), (1, 2, 1), (3, 4, 0)):
        words = {}
        for lane in range(32):
            gq, qq = lane >> 2, lane & 3
            at = ((qq - (gq >> 1) - 2) * PITCH + 2 * (gq >> 1)
                  + j * (8 - 4 * PITCH) + s * 8 * PITCH + h * 4 * PITCH)
            words[at // 2] = True
        banks = {w % 32 for w in words}
        assert len(words) == len(banks) == 16


@pytest.mark.parametrize("maxd, s2", [(4, 2), (4, 1)])
def test_band_product_bwd_f1_matches_pallas_kernel_interpret(maxd, s2):
    """Against the TPU kernel K5's bf16 form in interpret mode (bf16
    products, f32 sums, f32 out, NHWC), at the size and tolerance of the
    JAX package's interpret-mode cases (the kernel wants H % 8 == 0)."""
    g, f1, f2 = _inputs((1, 32, 8, 16), 9, maxd, s2)
    nhwc = [jnp.asarray(t.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
            for t in (g, f1, f2)]
    with pltpu.force_tpu_interpret_mode():
        want = jax_corr_pallas.correlation_pallas_bwd(*nhwc, maxd, maxd,
                                                      s2)[0]
    assert want.dtype == jnp.float32
    got = band_product_bwd_f1(g, f2, maxd, s2)
    assert got.shape == (1, 32, 8, 16)
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0.05, atol=0.02)
