"""The arithmetic of the correlation forward's tensor-core body, in bf16 and
fp16, on the CPU.

On the card, ``correlation_fwd_bf16`` (K1) and ``correlation_fwd_rows_bf16``
(K7's forward), and their ``_fp16`` forms, run FlowNetC's configuration
(maxd 20, s2 2) as the TPU kernel's band product
(``flownet2_tpu_torch/csrc/correlation_fwd.cu``,
``correlation_fwd_mma_kernel``, one template on the element type): per tile
of 16 output pixels of one row at
one row shift, the product of their f1 values (16 px x C) with the f2
columns of a window around them (C x (16 + 2 maxd)), taken 16 channels at a
time with the channels past C zero-filled, each chunk's float32 partial
added in order, and the band read off it: pixel r at column shift ti is the
element (r, r + ti * s2) of the window product.  Then one division by C and
one rounding to the operands' dtype.  A product of two bf16 (8 significant
bits) or two fp16 values (11) is exact in float32, so only the order of the
sums differs between dtypes.  ``band_product`` below is a small torch
emulation of that arithmetic, written here and not in the package, and the
tests hold it, in each dtype, to the port's plain versions and, in bf16, to
the TPU kernel, whose Pallas form refuses fp16
(``correlation_pallas.py:70``), and in fp16 to the JAX package's fp16
correlation (XLA).  The kernel's index
arithmetic, fragments and bits are held on the card (``chip_smoke.py``
phase 2, ``kernel_ab.py``).

Tolerances:
- against ``correlation_plain`` and ``corr_slab_plain``: one ulp of the
  dtype (rtol 2**-7 in bf16, 2**-10 in fp16, atol 1e-6 of the largest
  |out|) with at most 1% of the values not bit-equal, the card's gate:
  both sum exact products in float32 in other orders before the one
  rounding;
- the slab form's rows against the whole map's: bit for bit, since each
  output is summed in the same chunks either way;
- against the TPU kernel in interpret mode (bf16): the tolerance of
  ``tests/test_torch_bf16.py``'s own case (rtol 0.05, atol 0.02);
- against the JAX package's fp16 correlation: one fp16 ulp of the largest
  magnitude (rtol and atol 2**-10 of it), as ``tests/test_torch_fp16.py``
  holds the plain version, since both sum in float32 and round once.
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

jax_corr = importlib.import_module("flownet2_tpu.ops.correlation")
jax_corr_pallas = importlib.import_module(
    "flownet2_tpu.ops.correlation_pallas")

# one ulp of each dtype the tensor-core body takes, relative
ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
TILE = 16       # output pixels a tile, channels a k-step
# the bf16 cases under the ids they had before the fp16 ones joined
DTYPES = ((torch.bfloat16, ""), (torch.float16, "-fp16"))


def with_dtypes(argname, values):
    """Parametrise ``argname`` over ``values`` and ``dtype`` over bf16 and
    fp16; the bf16 cases keep pytest's ids (``shape0``, ...), the fp16 ones
    add ``-fp16``."""
    return pytest.mark.parametrize(f"{argname}, dtype", [
        pytest.param(v, dtype, id=f"{argname}{i}{tail}")
        for dtype, tail in DTYPES for i, v in enumerate(values)])


def band_product(f1, f2, maxd=20, s2=2, slab=False):
    """The tensor-core body's arithmetic.  f1 (B, C, H, W) and f2 (B, C, H,
    W), or with ``slab`` the halo slab (B, C, H + 2 maxd, W), bf16 or fp16;
    returns (B, D*D, H, W) in their dtype."""
    dtype = f1.dtype
    f1, f2 = f1.float(), f2.float()
    batch, channels, height, width = f1.shape
    d_rad = maxd // s2
    disp = 2 * d_rad + 1
    tiles = -(-width // TILE)
    chunks = -(-channels // TILE)
    # zero fill: the channels to whole k-steps, the columns to whole tiles
    # and a window of maxd columns either side of each
    f1 = F.pad(f1, (0, tiles * TILE - width, 0, 0,
                    0, chunks * TILE - channels))
    f2 = F.pad(f2, (maxd, tiles * TILE - width + maxd, 0, 0,
                    0, chunks * TILE - channels))
    a = f1.unflatten(3, (tiles, TILE))               # (B, C, H, tiles, 16)
    span = TILE + 2 * maxd
    shift = maxd if slab else 0
    out = torch.zeros(batch, disp, disp, height, tiles * TILE)
    r = torch.arange(TILE)
    for tj in range(disp):
        rows = torch.arange(height) + shift + (tj - d_rad) * s2
        inside = (rows >= 0) & (rows < f2.shape[2])
        f2_rows = f2[:, :, rows.clamp(0, f2.shape[2] - 1)] * inside.view(
            1, 1, -1, 1)
        win = f2_rows.unfold(3, span, TILE)    # (B, C, H, tiles, span)
        acc = torch.zeros(batch, height, tiles, TILE, span)
        for k in range(chunks):
            ch = slice(k * TILE, (k + 1) * TILE)
            acc = acc + torch.einsum("bchtr,bchtj->bhtrj", a[:, ch],
                                     win[:, ch])
        for ti in range(disp):
            band = acc[..., r, r + ti * s2 + (maxd - d_rad * s2)]
            out[:, tj, ti] = band.flatten(2)
    out = out[..., :width] / channels
    return out.reshape(batch, disp * disp, height, width).to(dtype)


def _low(shape, seed, dtype=torch.bfloat16):
    """Seeded normal values as a bf16 or fp16 tensor, NCHW."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


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


SHAPES = [(8, 32, 8, 64), (2, 40, 20, 152)]


@with_dtypes("shape", SHAPES)
def test_band_product_matches_plain(shape, dtype):
    """FlowNetC's configuration; C = 40 is no multiple of the k-step and
    W = 152 none of the tile."""
    f1, f2 = _low(shape, 0, dtype), _low(shape, 1, dtype)
    got = band_product(f1, f2)
    want = correlation.correlation_plain(f1, f2, 20, 1, 20, 1, 2)
    _one_ulp(got, want, f"band product {shape} {dtype}")


@pytest.mark.parametrize("band", [0, 1])
@with_dtypes("shape", SHAPES)
def test_band_product_slab_form(shape, dtype, band):
    """One band of two against its halo slab: the slab's plain version at
    one ulp, and the whole map's rows bit for bit."""
    f1, f2 = _low(shape, 2, dtype), _low(shape, 3, dtype)
    local_h = shape[2] // 2
    off = band * local_h
    f2p = F.pad(f2, (0, 0, 20, 20))
    f1_loc = f1[:, :, off:off + local_h].contiguous()
    slab = f2p[:, :, off:off + local_h + 40].contiguous()
    got = band_product(f1_loc, slab, slab=True)
    want = correlation_spatial.corr_slab_plain(f1_loc, slab, 20, 2)
    _one_ulp(got, want, f"band product, band {band} of 2, {shape} {dtype}")
    whole = band_product(f1, f2)
    assert torch.equal(got, whole[:, :, off:off + local_h])


@pytest.mark.parametrize("maxd, s2", [(4, 2), (4, 1)])
def test_band_product_matches_pallas_kernel_interpret(maxd, s2):
    """Against the TPU kernel's bf16 form in interpret mode, at the size
    and tolerance of tests/test_torch_bf16.py's own case (the kernel wants
    H % 8 == 0)."""
    rng = np.random.RandomState(4)
    f1, f2 = (torch.from_numpy(rng.randn(1, 8, 16, 8).astype(np.float32))
              .bfloat16() for _ in range(2))                   # NHWC
    with pltpu.force_tpu_interpret_mode():
        want = jax_corr_pallas.correlation_pallas(
            jnp.asarray(f1.float().numpy(), jnp.bfloat16),
            jnp.asarray(f2.float().numpy(), jnp.bfloat16), maxd, maxd, s2)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = band_product(f1.permute(0, 3, 1, 2).contiguous(),
                       f2.permute(0, 3, 1, 2).contiguous(), maxd, s2)
    disp = 2 * (maxd // s2) + 1
    assert got.shape == (1, disp * disp, 8, 16)
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 3, 1),
                               want, rtol=0.05, atol=0.02)


@pytest.mark.parametrize("maxd, s2", [(20, 2), (4, 2)])
def test_band_product_matches_jax_fp16(maxd, s2):
    """fp16, against the JAX package's correlation in fp16 (float32 sums of
    the fp16 products, one rounding; XLA, since the Pallas kernel refuses
    fp16).  C = 24 ends in a partial k-step and W = 40 in a partial
    tile."""
    f1, f2 = (_low((1, 24, 16, 40), seed, torch.float16) for seed in (6, 7))
    want = jax_corr.correlation(
        *(jnp.asarray(t.permute(0, 2, 3, 1).float().numpy(), jnp.float16)
          for t in (f1, f2)), maxd, 1, maxd, 1, s2)
    assert want.dtype == jnp.float16
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    got = band_product(f1, f2, maxd, s2)
    assert got.dtype == torch.float16 and got.shape == want.shape
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=ULP[torch.float16],
                               atol=ULP[torch.float16] * top)


@pytest.mark.parametrize("dtype, scale", [
    pytest.param(dtype, scale, id=f"{tail[1:]}{'-' if tail else ''}{scale}")
    for dtype, tail, scales in (
        (torch.bfloat16, "", (1.0, 2.0 ** 40, 2.0 ** -40)),
        (torch.float16, "-fp16", (1.0, 2.0 ** 7, 2.0 ** -14)))
    for scale in scales])
def test_bf16_products_are_exact_in_float32(dtype, scale):
    """A product of two bf16 values (8 significant bits each) has at most
    16, and one of two fp16 values (11 each, exponents down to 2**-24, the
    last scale making subnormals) at most 22 and an exponent of at least
    -48: both are exact in float32, so the sums alone decide the bits."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(100_000).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(100_000).astype(np.float32) * scale)
    b = b.to(dtype)
    exact = a.double() * b.double()
    assert torch.equal((a.float() * b.float()).double(), exact)
