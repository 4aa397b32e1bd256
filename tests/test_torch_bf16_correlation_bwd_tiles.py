"""The arithmetic of the correlation backward's tensor-core body for f2, in
bf16 and fp16, on the CPU.

On the card, ``correlation_bwd_f2_bf16`` (K6) and
``correlation_bwd_f2_rows_bf16`` (K7's d_slab), and their ``_fp16`` forms,
run FlowNetC's configuration (maxd 20, s2 2) as the TPU kernel's band
product (``flownet2_tpu_torch/csrc/correlation_bwd.cu``,
``correlation_bwd_f2_mma_kernel``, one template on the element type): per
tile of 16 output columns x2 of
one output row and per row shift tj, the band matrix of the cotangent,
``Band[m][k] = g[tj*D + ti][y][x0 - lead + k]`` at
``k = m + lead + maxd - s2*ti`` and zero elsewhere (lead 24 at maxd 20,
so ``k = m + 44 - 2ti``), times the f1 window
``f1[c][y][x0 - lead + k]`` of 16 + 2 lead columns, 16 columns (a k-step)
at a time, each k-step's float32 partial added in order, the shifts in
ascending order; then one division by C and one rounding to the operands'
dtype.  ``band_product_bwd_f2`` below is a small torch emulation of that
arithmetic, written here and not in the package, and the tests hold it, in
each dtype, to the port's plain versions and, in bf16, to the TPU kernel,
whose Pallas form refuses fp16 (``correlation_pallas.py:70``), and in fp16
to ``jax.vjp`` of the JAX package's fp16 correlation (XLA).  The kernel's index
arithmetic, fragments and bits are held on the card (``chip_smoke.py``
phase 2, ``kernel_ab.py``).

Tolerances:
- against ``correlation_bwd_plain`` and ``corr_slab_bwd_plain``: one ulp of
  the dtype (rtol 2**-7 in bf16, 2**-10 in fp16, atol 1e-6 of the largest
  |out|) with at most 1% of the values not bit-equal, the card's gate: both
  sum exact products in float32 in other orders before the one rounding;
- one band's slab rows [maxd, maxd + H) against the whole map: bit for bit,
  since each output is summed over the same shifts and k-steps either way;
- against the TPU kernel in interpret mode (bf16): the tolerance of
  ``tests/test_torch_bf16.py``'s own case (rtol 0.05, atol 0.02);
- against ``jax.vjp`` of the JAX package's fp16 correlation: one fp16 ulp
  of the largest magnitude (rtol and atol 2**-10 of it), as
  ``tests/test_torch_fp16.py`` holds the plain version, since both sum in
  float32 and round once.
"""

import importlib

import jax
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

jax_corr = importlib.import_module("flownet2_tpu.ops.correlation")
jax_corr_pallas = importlib.import_module(
    "flownet2_tpu.ops.correlation_pallas")

# one ulp of each dtype the tensor-core body takes, relative
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
TILE = 16       # output columns a tile, window columns a k-step
# the bf16 cases under the ids they had before the fp16 ones joined
DTYPES = ((torch.bfloat16, ""), (torch.float16, "-fp16"))


def with_dtypes(argname, values):
    """Parametrise ``argname`` over ``values`` and ``dtype`` over bf16 and
    fp16; the bf16 cases keep pytest's ids (``shape0``, ...), the fp16 ones
    add ``-fp16``."""
    return pytest.mark.parametrize(f"{argname}, dtype", [
        pytest.param(v, dtype, id=f"{argname}{i}{tail}")
        for dtype, tail in DTYPES for i, v in enumerate(values)])


def _lead(maxd):
    """The window's start left of the tile: maxd rounded up to 8 columns
    (16-byte pieces of bf16)."""
    return -(-maxd // 8) * 8


def band_matrix(g_win, maxd=20, s2=2):
    """The band of one row shift: ``g_win`` (..., D, window) holds the
    cotangent planes of that shift over a tile's window; returns
    (..., 16, window), Band[m][k] = g_win[ti][k] at k = m + lead + maxd -
    s2*ti, zero elsewhere."""
    disp = 2 * (maxd // s2) + 1
    lead = _lead(maxd)
    band = torch.zeros(*g_win.shape[:-2], TILE, g_win.shape[-1])
    m = torch.arange(TILE)
    for ti in range(disp):
        k = m + lead + maxd - s2 * ti
        band[..., m, k] = g_win[..., ti, :][..., k]
    return band


def band_product_bwd_f2(g, f1, maxd=20, s2=2, slab=False):
    """The tensor-core body's arithmetic.  g (B, D*D, H, W) and f1
    (B, C, H, W), bf16 or fp16; returns d_f2 (B, C, H, W) or, with
    ``slab``, d_slab (B, C, H + 2 maxd, W) in slab coordinates, in their
    dtype."""
    dtype = f1.dtype
    g, f1 = g.float(), f1.float()
    batch, channels, height, width = f1.shape
    disp = 2 * (maxd // s2) + 1
    lead = _lead(maxd)
    span = TILE + 2 * lead
    tiles = -(-width // TILE)
    out_h = height + 2 * maxd if slab else height
    shift = maxd if slab else 0
    # zero fill: the columns to whole tiles and a window of lead columns
    # either side of each
    pad = (lead, tiles * TILE - width + lead)
    g, f1 = F.pad(g, pad), F.pad(f1, pad)
    acc = torch.zeros(batch, channels, out_h, tiles, TILE)
    for tj in range(disp):
        rows = torch.arange(out_h) - shift + maxd - s2 * tj   # source rows
        inside = ((rows >= 0) & (rows < height)).view(1, 1, -1, 1)
        rows = rows.clamp(0, height - 1)
        g_rows = g[:, tj * disp:(tj + 1) * disp, rows] * inside
        f1_rows = f1[:, :, rows] * inside
        g_win = g_rows.unfold(3, span, TILE)      # (B, D, Hout, tiles, span)
        f1_win = f1_rows.unfold(3, span, TILE)    # (B, C, Hout, tiles, span)
        band = band_matrix(g_win.movedim(1, 3), maxd, s2)
        for ks in range(span // TILE):
            k = slice(ks * TILE, (ks + 1) * TILE)
            acc = acc + torch.einsum("bhtmk,bchtk->bchtm", band[..., k],
                                     f1_win[..., k])
    out = acc.flatten(3)[..., :width] / channels
    return out.to(dtype)


def _low(shape, seed, dtype=torch.bfloat16):
    """Seeded normal values as a bf16 or fp16 tensor."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


def _inputs(shape, seed, maxd=20, s2=2, dtype=torch.bfloat16):
    """g (B, D*D, H, W), f1 and f2 (B, C, H, W), bf16 or fp16, NCHW."""
    disp = 2 * (maxd // s2) + 1
    batch, _, height, width = shape
    return (_low((batch, disp * disp, height, width), seed, dtype),
            _low(shape, seed + 1, dtype), _low(shape, seed + 2, dtype))


def _one_ulp(got, want, what):
    """One ulp of the dtype (bf16 or fp16) and at most 1% of the values
    not bit-equal."""
    assert got.dtype == want.dtype and got.dtype in ULP
    assert got.shape == want.shape, (got.shape, want.shape)
    g, w = got.float().numpy(), want.float().numpy()
    flips = float(np.mean(g != w))
    print(f"{what}: max abs diff {np.abs(g - w).max():.3e}, not bit-equal "
          f"{flips:.4%}")
    np.testing.assert_allclose(g, w, rtol=ULP[got.dtype],
                               atol=1e-6 * float(np.abs(w).max()),
                               err_msg=what)
    assert flips <= 0.01, (what, flips)


@with_dtypes("shape", [(8, 32, 8, 56), (2, 40, 20, 152)])
def test_band_product_bwd_f2_matches_plain(shape, dtype):
    """FlowNetC's configuration; C = 40 is no multiple of 16 and W = 152
    none of the kernel's 64-column tiles."""
    g, f1, f2 = _inputs(shape, 0, dtype=dtype)
    got = band_product_bwd_f2(g, f1)
    want = correlation.correlation_bwd_plain(g, f1, f2, 20, 2,
                                             needs=(False, True))[1]
    _one_ulp(got, want, f"band product d_f2 {shape} {dtype}")


@pytest.mark.parametrize("band", [0, 1])
@with_dtypes("shape", [(8, 32, 8, 56), (2, 40, 20, 152)])
def test_band_product_bwd_f2_slab_form(shape, dtype, band):
    """Band ``band`` of two: d_slab against the slab's plain version at one
    ulp."""
    g, f1, f2 = _inputs(shape, 3, dtype=dtype)
    local_h = shape[2] // 2
    off = band * local_h
    rows = slice(off, off + local_h)
    g_loc, f1_loc = g[:, :, rows].contiguous(), f1[:, :, rows].contiguous()
    slab = F.pad(f2, (0, 0, 20, 20))[:, :, off:off + local_h + 40]
    got = band_product_bwd_f2(g_loc, f1_loc, slab=True)
    want = correlation_spatial.corr_slab_bwd_plain(
        g_loc, f1_loc, slab.contiguous(), 20, 2, needs=(False, True))[1]
    _one_ulp(got, want,
             f"band product d_slab, band {band} of 2, {shape} {dtype}")


@with_dtypes("shape", [(8, 32, 8, 56), (2, 40, 5, 75)])
def test_band_product_one_band_is_the_whole_map(shape, dtype):
    """One band's d_slab rows [20, 20 + H) are the whole map's d_f2 bit for
    bit: the same shifts and k-steps sum every output."""
    g, f1, _ = _inputs(shape, 6, dtype=dtype)
    whole = band_product_bwd_f2(g, f1)
    d_slab = band_product_bwd_f2(g, f1, slab=True)
    assert d_slab.shape[2] == shape[2] + 40
    assert torch.equal(d_slab[:, :, 20:20 + shape[2]], whole)


@pytest.mark.parametrize("maxd, s2", [(20, 2), (4, 2), (4, 1)])
def test_band_matrix_places_g_at_the_source_column(maxd, s2):
    """Each g[tj*D + ti] value sits at the band column of the source column
    that the general body reads for output x2 and column shift ti,
    x = x2 - (ti - r)*s2, and every other entry is zero."""
    disp = 2 * (maxd // s2) + 1
    rad = maxd // s2
    lead = _lead(maxd)
    window = TILE + 2 * lead
    g_win = torch.arange(disp * window, dtype=torch.float32).view(disp,
                                                                   window)
    band = band_matrix(g_win, maxd, s2)
    x0 = 64                    # the tile's first output column
    want = torch.zeros(TILE, window)
    for m in range(TILE):
        x2 = x0 + m
        for ti in range(disp):
            x = x2 - (ti - rad) * s2               # the general body's column
            want[m, x - (x0 - lead)] = g_win[ti, x - (x0 - lead)]
    assert torch.equal(band, want)


@pytest.mark.parametrize("maxd, s2", [(4, 2), (4, 1)])
def test_band_product_bwd_f2_matches_pallas_kernel_interpret(maxd, s2):
    """Against the TPU kernel K6's bf16 form in interpret mode (bf16
    products, f32 sums, f32 out, NHWC), at the size and tolerance of the
    JAX package's interpret-mode cases (the kernel wants H % 8 == 0)."""
    g, f1, f2 = _inputs((1, 32, 8, 16), 9, maxd, s2)
    nhwc = [jnp.asarray(t.float().permute(0, 2, 3, 1).numpy(), jnp.bfloat16)
            for t in (g, f1, f2)]
    with pltpu.force_tpu_interpret_mode():
        want = jax_corr_pallas.correlation_pallas_bwd(*nhwc, maxd, maxd,
                                                      s2)[1]
    assert want.dtype == jnp.float32
    got = band_product_bwd_f2(g, f1, maxd, s2)
    assert got.shape == (1, 32, 8, 16)
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=0.05, atol=0.02)


@pytest.mark.parametrize("maxd, s2", [(20, 2), (4, 2)])
def test_band_product_bwd_f2_matches_jax_vjp_fp16(maxd, s2):
    """fp16, against d_f2 of ``jax.vjp`` of the JAX package's correlation
    in fp16 (float32 sums of the fp16 products, one rounding; XLA, since
    the Pallas kernel refuses fp16).  C = 24 ends in a partial k-step and
    W = 40 in a partial tile."""
    g, f1, f2 = _inputs((1, 24, 8, 40), 10, maxd, s2, torch.float16)
    nhwc = [jnp.asarray(t.float().permute(0, 2, 3, 1).numpy(), jnp.float16)
            for t in (g, f1, f2)]
    _, vjp = jax.vjp(lambda a, b: jax_corr.correlation(
        a, b, maxd, 1, maxd, 1, s2), nhwc[1], nhwc[2])
    want = vjp(nhwc[0])[1]
    assert want.dtype == jnp.float16
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = band_product_bwd_f2(g, f1, maxd, s2)
    assert got.dtype == torch.float16 and got.shape == want.shape
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=ULP[torch.float16],
                               atol=ULP[torch.float16] * top)
