"""The row tiles of the warp with tangents (K3), on the CPU.

On the card, K3 (``resample2d_tangents.cu``, one and F flows) runs on K2's
row tiles (``WarpTile``, ``FnetWarpPixels`` in
``flownet2_tpu_torch/csrc/common.cuh``): the thread map, the flow's pieces,
the box, the window and the route are K2's, which
``tests/test_torch_warp_tiles.py`` emulates; this file reuses that
emulation.  What K3 adds is its stores: for each channel a thread stores
``out`` as pieces of kPiece elements of the image's dtype and the float32
tangents d1 and d2 as pieces of float, 16 bytes at most a store: one store
a plane in a float32 tile; two in a bfloat16 tile, whose thread's 8
columns are 32 bytes of float, made by thread pairs that swap halves, so
that each store of a warp fills whole 32-byte sectors
(``fnet_store_pair``); pieces of 2 or 1 where a row is not 16-byte
aligned; a piece past the row's end masked.  The emulation below writes
each store, with the values of the pixels it carries, into flat output
buffers at the kernel's offsets and checks that every output element is
written once, with the value the plain version gives.  The kernel's bits are held on the card
(``chip_smoke.py`` phase 2, ``kernel_ab.py``).

Tolerances:
- the emulated out, d1 and d2 against ``resample2d_tangents_plain``: 1e-6
  in float32; in bfloat16 one bf16 ulp on ``out`` (rtol 2**-7, atol 1e-6
  of the largest |out|; the card's fused multiply-adds round other than
  torch's separate products) and 1e-6 on the float32 d1, d2;
- against the TPU kernel in interpret mode: the tolerances of
  ``tests/test_torch_ops.py`` (1e-5) in float32 and of
  ``tests/test_torch_bf16_train.py`` (one ulp on out, at most 1% of it not
  bit-equal; d1, d2 at 1e-6) in bfloat16.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flownet2_tpu_torch.ops import resample2d
from test_torch_warp_tiles import (COLS, HEIGHT, ROW_CASES, Tile, _flow,
                                   _image, _one_ulp, _smooth_flow,
                                   gather_corners, thread_pixels)

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

jax_r2d_pallas = importlib.import_module("flownet2_tpu.ops.resample2d_pallas")

K3_SOURCE = (Path(resample2d.__file__).resolve().parents[1] / "csrc"
             / "resample2d_tangents.cu").read_text()
STORE_MUTATIONS = ("half", "swap", "plane", "flow")


def tangent_group(tile):
    """Pixels a tangent store covers: a piece, 16 bytes of float at most."""
    return min(tile.piece, 4)


def paired(tile):
    """Whether the tangents are stored by thread pairs (fnet_store_pair): a
    bfloat16 tile of 16-byte pieces, whose thread's 8 columns are 32 bytes
    of float."""
    return tile.piece == 8


def stores(tile, width, out_h, bx, by, mutation=None):
    """The stores of one channel plane that the threads of block (bx, by)
    make, in the kernel's order, as (kind, dest, count, valid, src): kind
    "out" or "tangent"; over the threads, the plane offset ``dest`` that a
    store of ``count`` elements starts at, whether it is made, and the
    plane offset ``src`` of the first pixel whose values it carries.  Per
    piece j of kPiece pixels, the tangent stores of tangent_group pixels
    each, then the piece's ``out`` store; a piece past the row's end or the
    last row is masked.  Paired tangents: thread 2m stores its own first
    half at its x and, second, the odd thread's first half at x + 8;
    thread 2m + 1 stores the even thread's second half at its x - 4 and,
    second, its own second half at x + 4, each store made where the
    columns it carries lie in the row.  ``mutation`` breaks the paired
    stores on purpose: "half" (each thread's second store where its first
    went) or "swap" (the halves the threads hand over swapped)."""
    rows, cols, valid = thread_pixels(tile, width, out_h, bx, by)
    r, x = rows[:, 0], cols[:, 0]
    own = r * width + x
    made = []
    if paired(tile):
        odd = torch.arange(tile.threads) % 2 == 1
        mine = valid[:, 0]
        theirs = (r < out_h) & (torch.where(odd, x - 8, x + 8) < width)
        partner = torch.where(odd, own - 8, own + 8)
        first = torch.where(odd, own - 4, own)
        second = torch.where(odd, own + 4, own + 8)
        if mutation == "half":
            second = first
        # the even thread receives the odd one's first half, the odd one
        # the even one's second half
        got = partner + torch.where(odd, 4, 0)
        if mutation == "swap":
            got = partner + torch.where(odd, 0, 4)
        made.append(("tangent", first, 4, torch.where(odd, theirs, mine),
                     torch.where(odd, got, own)))
        made.append(("tangent", second, 4, torch.where(odd, mine, theirs),
                     torch.where(odd, own + 4, got)))
        made.append(("out", own, tile.piece, mine, own))
        return made
    group = tangent_group(tile)
    for j in range(tile.kv // tile.piece):
        ok = valid[:, j * tile.piece]
        for h in range(0, tile.piece, group):
            at = own + j * tile.piece + h
            made.append(("tangent", at, group, ok, at))
        at = own + j * tile.piece
        made.append(("out", at, tile.piece, ok, at))
    return made


def emulated_k3(img, flows, off=0, mutation=None):
    """K3 for one image (C, H, W) and F flows (F, 2, Ho, W): the corners of
    the emulated tiles, the float32 values rounded once (out, to the
    image's dtype), written store by store into flat buffers (NaN where
    nothing was written) at the kernel's offsets, each store carrying its
    source pixels' values: flow f, channel c and plane offset o at
    (f*C + c)*Ho*W + o.  Returns out, d1, d2, each (F, C, Ho, W), and how
    often each element was written.  ``mutation`` breaks the tangents'
    stores on purpose: "half" and "swap" (``stores``), "plane" (the
    channels an image plane, H*W, apart, not a flow's Ho*W) or "flow" (the
    flows 2*Ho*W apart, the flow's own stride, not C*Ho*W)."""
    channels, height, width = img.shape
    nflows, _, out_h, _ = flows.shape
    tile = Tile(img.dtype, width)
    oplane = out_h * width
    n = nflows * channels * oplane
    bufs = [torch.full((n,), float("nan")) for _ in range(3)]
    writes = torch.zeros(3, n, dtype=torch.long)
    cstride = height * width if mutation == "plane" else oplane
    fstride = (2 if mutation == "flow" else channels) * oplane
    for f in range(nflows):
        a, b, (tl, tr, bl, br), _, _ = gather_corners(img, flows[f], off)
        tl, tr, bl, br = (t.float() for t in (tl, tr, bl, br))
        out = ((1 - a) * (1 - b) * tl + a * (1 - b) * tr + (1 - a) * b * bl
               + a * b * br).to(img.dtype).float()
        d1 = (1 - b) * (tr - tl) + b * (br - bl)
        d2 = (1 - a) * (bl - tl) + a * (br - tr)
        for by in range(-(-out_h // tile.rows)):
            for bx in range(-(-width // COLS)):
                for kind, dest, count, ok, src in stores(
                        tile, width, out_h, bx, by, mutation):
                    dest, src = dest[ok], src[ok]
                    r, col = src // width, src % width
                    if kind == "tangent":
                        base = f * fstride
                        planes = ((1, d1, cstride), (2, d2, cstride))
                    else:
                        base = f * channels * oplane
                        planes = ((0, out, oplane),)
                    for e in range(count):
                        for k, vals, stride in planes:
                            for c in range(channels):
                                at = base + c * stride + dest + e
                                keep = at < n
                                bufs[k][at[keep]] = vals[c, r, col + e][keep]
                                writes[k].index_add_(
                                    0, at[keep],
                                    torch.ones_like(at[keep]))
    shape = (nflows, channels, out_h, width)
    out, d1, d2 = (t.reshape(shape) for t in bufs)
    return out.to(img.dtype), d1, d2, writes


def fnet_piece(dtype, width, offsets, float_offsets=()):
    """common.cuh's fnet_piece: the widest piece (16 bytes of the dtype, 2
    elements, 1) on which every row of each tensor starts, the tensors of
    the dtype at byte ``offsets`` from a 256-byte boundary, the float ones
    (K3's tangents) at ``float_offsets``, those moving as words of 16 bytes
    at most."""
    size = torch.empty((), dtype=dtype).element_size()
    for n in (16 // size, 2):
        if (width % n == 0 and all(o % (n * size) == 0 for o in offsets)
                and all(o % (min(n, 4) * 4) == 0 for o in float_offsets)):
            return n
    return 1


def test_piece_choice_checks_the_tangents():
    """The tangents' pointers take part in the piece choice at float32's
    width: a bfloat16 tile of 16-byte pieces needs them 16-byte aligned (two
    16-byte words a piece), a piece of 2 needs 8 bytes; K3's launch passes
    them."""
    assert re.search(r"fnet_piece<T>\(W, \{img, flows, out\}, \{d1, d2\}\)",
                     K3_SOURCE)
    bf16, f32 = torch.bfloat16, torch.float32
    assert fnet_piece(bf16, 64, (0, 0, 0), (0, 0)) == 8
    assert fnet_piece(bf16, 64, (0, 0, 0), (0, 8)) == 2
    assert fnet_piece(bf16, 64, (0, 0, 0), (4, 0)) == 1
    assert fnet_piece(bf16, 150, (0, 0, 0), (0, 0)) == 2
    assert fnet_piece(f32, 64, (0, 0, 0), (0, 0)) == 4
    assert fnet_piece(f32, 64, (0, 0, 0), (0, 8)) == 2
    assert fnet_piece(f32, 151, (0, 0, 0), (0, 0)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 136, 150, 151])
def test_store_map_and_pieces(dtype, width):
    """Every element of out and of each tangent plane is stored once, by a
    store of its row that carries its own pixel's values; a tangent store
    is 16 bytes of float at most and starts on its own size (a bfloat16
    thread of 8 columns makes two 16-byte stores a tangent plane where the
    rows allow 16 bytes, by thread pairs, and a store of a warp fills whole
    32-byte sectors); an out store is one piece of the dtype; a masked
    piece (past the row's end, inside a thread's 16 bytes at W = 150 and
    151, or the odd thread of a pair at W = 136) stores nothing."""
    tile = Tile(dtype, width)
    group = tangent_group(tile)
    want_group = {64: 4, 136: 4, 150: 2, 151: 1}[width]
    assert group == want_group
    assert paired(tile) == (dtype == torch.bfloat16 and width % 8 == 0)
    out_h = 37
    covered = {"out": torch.zeros(out_h * width, dtype=torch.long),
               "tangent": torch.zeros(out_h * width, dtype=torch.long)}
    tails = 0
    for by in range(-(-out_h // tile.rows)):
        for bx in range(-(-width // COLS)):
            made = stores(tile, width, out_h, bx, by)
            # threads of a live row with pieces on both sides of its end
            rows, _, valid = thread_pixels(tile, width, out_h, bx, by)
            live = rows[:, 0] < out_h
            tails += int((live & valid.any(1) & ~valid.all(1)).sum())
            per_thread = {"out": 0, "tangent": 0}
            for kind, dest, count, ok, src in made:
                per_thread[kind] += 1
                size = count * (4 if kind == "tangent" else tile.size)
                assert size <= 16
                assert torch.equal(dest[ok], src[ok])
                assert (dest[ok] % count == 0).all(), (kind, count)
                # a store lies in its row
                assert ((dest[ok] % width) + count <= width).all()
                if kind == "tangent" and size == 16:
                    for w in range(tile.threads // 32):
                        lanes = slice(32 * w, 32 * w + 32)
                        sectors = dest[lanes][ok[lanes]] // 8
                        assert (torch.bincount(sectors)[sectors] == 2).all()
                for e in range(count):
                    covered[kind][dest[ok] + e] += 1
            assert per_thread == {"out": tile.kv // tile.piece,
                                  "tangent": tile.kv // group}
    for kind in covered:
        assert (covered[kind] == 1).all(), kind
    assert (tails > 0) == (width % tile.kv != 0)


def _want(img, flows, off):
    return [t[0] for t in resample2d.resample2d_tangents_plain(
        img[None], flows[None], off)]


def _close(got, want, dtype):
    """out, d1, d2 against the plain version: 1e-6 in float32; one bf16 ulp
    on out and 1e-6 on the float32 tangents in bfloat16."""
    assert got[0].dtype == dtype
    assert got[1].dtype == got[2].dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    else:
        _one_ulp(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 150, 151])
def test_emulated_tangents_match_plain(dtype, width):
    """K3 on the emulated tiles and stores against the plain version, for
    two flows in one launch (+-8 px, whose windows are staged, and the
    smooth flow or +-200 px), over the whole image and on local rows at
    offsets 24 and 192 (each band's rows the whole image's bits); every
    element written once."""
    img = _image(3, HEIGHT, width, 21).to(dtype)
    second = (_smooth_flow(HEIGHT, width, 23) if width % 4 == 0
              else _flow((HEIGHT, width), 200.0, 23))
    flows = torch.stack([_flow((HEIGHT, width), 8.0, 22), second]).to(dtype)
    *got, writes = emulated_k3(img, flows)
    assert (writes == 1).all()
    _close(got, _want(img, flows, 0), dtype)
    for off, out_h in ROW_CASES[2:]:
        rows = slice(off, off + out_h)
        *band, writes = emulated_k3(img, flows[:, :, rows].contiguous(), off)
        assert (writes == 1).all()
        for a, b in zip(band, got):
            assert torch.equal(a, b[:, :, rows])


@pytest.mark.parametrize("mutation", STORE_MUTATIONS)
def test_tangent_store_mutations_are_caught(mutation):
    """A paired store whose second half goes where its first went, or that
    hands over the wrong half, and a tangent store that takes the image's
    plane for the channel stride or the flow's stride between flows, leave
    elements unwritten or written twice or the tangents off the plain
    version, in every case where the mutation moves something: "half" and
    "swap" where the tangents are paired (a bfloat16 tile of 16-byte
    pieces), "plane" on local rows, "flow" wherever there are two flows."""
    cases = {(torch.bfloat16, 64, 0, 48): {"half", "swap", "flow"},
             (torch.bfloat16, 136, 16, 32): {"half", "swap", "plane",
                                             "flow"},
             (torch.float32, 150, 16, 32): {"plane", "flow"},
             (torch.bfloat16, 151, 16, 32): {"plane", "flow"}}
    for (dtype, width, off, out_h), moved in cases.items():
        img = _image(3, 48, width, 24).to(dtype)
        flows = torch.stack([_flow((out_h, width), 8.0, 25 + k)
                             for k in range(2)]).to(dtype)
        want = _want(img, flows, off)
        *good, writes = emulated_k3(img, flows, off)
        assert (writes == 1).all()
        _close(good, want, dtype)
        *got, writes = emulated_k3(img, flows, off, mutation)
        wrong = not (writes[1:] == 1).all() or not all(
            torch.allclose(a, b, rtol=1e-6, atol=1e-6)
            for a, b in zip(got[1:], want[1:]))
        assert wrong == (mutation in moved), (mutation, dtype, width)


@pytest.mark.parametrize("dtype,width", [(torch.float32, 150),
                                         (torch.bfloat16, 151)])
def test_emulated_tangents_match_pallas_kernels_interpret(dtype, width):
    """K3 on the emulated tiles against the TPU kernel it replaces, for one
    flow (resample2d_bilinear_tangents_pallas) and for two
    (resample2d_bilinear_tangents_cm_multi), in interpret mode, at +-8 px."""
    img = _image(3, 24, width, 26).to(dtype)
    flows = torch.stack([_flow((24, width), 8.0, 27),
                         _flow((24, width), 8.0, 28)]).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def nhwc(t):
        return jnp.asarray(t.float().permute(1, 2, 0)[None].numpy(), jdt)

    with pltpu.force_tpu_interpret_mode():
        one = jax_r2d_pallas.resample2d_bilinear_tangents_pallas(
            nhwc(img), nhwc(flows[0]))
        two = jax_r2d_pallas.resample2d_bilinear_tangents_cm_multi(
            nhwc(img), jnp.stack([nhwc(f) for f in flows], axis=1))
    got_one = emulated_k3(img, flows[:1])[:3]
    got_two = emulated_k3(img, flows)[:3]

    def chw(a):
        return torch.from_numpy(np.array(jnp.asarray(a).astype(
            jnp.float32))[0]).permute(2, 0, 1)

    want_one = [chw(a) for a in one]
    want_two = [torch.from_numpy(np.array(jnp.asarray(two[0]).astype(
        jnp.float32))[0]).permute(0, 3, 1, 2)]
    want_two += [torch.from_numpy(np.array(t)[0, :, :, :24, :width])
                 for t in two[2:]]
    for got, want in ((got_one, [w[None] for w in want_one]),
                      (got_two, want_two)):
        if dtype == torch.float32:
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            out, ref = got[0].float(), want[0]
            atol = 1e-6 * ref.abs().max()
            torch.testing.assert_close(out, ref, rtol=2.0 ** -7, atol=atol)
            assert (out != ref).float().mean() <= 0.01
            for a, b in zip(got[1:], want[1:]):
                torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
