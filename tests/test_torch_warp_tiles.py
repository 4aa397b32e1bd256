"""The row tiles of the bilinear warp's kernels, on the CPU.

On the card, K2 (``resample2d_fwd.cu``, one and F flows) and K4
(``resample2d_grad_flow.cu``) map a block to 64 output columns x 16
(float32) or 32 (bfloat16) output rows of one flow and a thread to 16
bytes of one row (``WarpTile`` and ``FnetWarpPixels`` in
``flownet2_tpu_torch/csrc/common.cuh``).  The flow, K2's output and K4's
cotangent and d_flow move in pieces: 16 bytes where every row is 16-byte
aligned, else 2 elements, else 1, a piece past the row's end masked.  A
block takes the box of its sample points' clamped corners; where the box of
all C channels fits in the window's bytes, it stages it in shared memory at
its own pitch and gathers the corners there, else it gathers them from the
image.  The emulation below rebuilds that mapping, box, staged copy (a flat
buffer at the kernel's pitch with garbage around it), corner offsets and
route choice in torch, written here and not in the package; its constants
are read from ``common.cuh``.  The kernels' bits are held on the card
(``chip_smoke.py`` phase 2, ``kernel_ab.py``).

Tolerances:
- every gathered corner against the image at the clamped corner: bit for
  bit, in float32 and bfloat16;
- the emulated K2 and K4 against ``resample2d_plain`` and
  ``resample2d_grad_flow_plain``: 1e-6 in float32, one bf16 ulp in
  bfloat16 (rtol 2**-7, atol 1e-6 of the largest |out|), since the card's
  fused multiply-adds round other than torch's separate products;
- against the TPU kernels in interpret mode: the tolerances of
  ``tests/test_torch_ops.py`` (1e-5; d_flow atol 1e-4) in float32, of
  ``tests/test_torch_bf16.py`` (0.02) and ``tests/test_torch_bf16_train.py``
  (one ulp of the kernel's d_flow cast to bf16) in bfloat16.
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

# one torch thread per test process: several test workers share the cores
# with XLA's own thread pools
torch.set_num_threads(1)

jax_r2d_pallas = importlib.import_module("flownet2_tpu.ops.resample2d_pallas")

COMMON = (Path(resample2d.__file__).resolve().parents[1] / "csrc"
          / "common.cuh").read_text()


def _constant(name):
    return re.search(rf"constexpr int {name} =\s*([^;]+);", COMMON).group(1)


def _per_dtype(name):
    """A constant of WarpTile<T> that is one value for float32 and one for
    bfloat16: (float32's, bfloat16's)."""
    return tuple(int(v) for v in re.fullmatch(
        r"sizeof\(T\) == 4 \? (\d+) : (\d+)", _constant(name)).groups())


COLS = int(_constant("kCols"))
ROWS_F32, ROWS_BF16 = _per_dtype("kTileRows")
WINDOW_F32, WINDOW_BF16 = _per_dtype("kWindowBytes")
BF16_ULP = 2.0 ** -7
MUTATIONS = ("pitch", "origin", "cstride")


class Tile:
    """One dtype's tile: kV columns a thread, COLS x rows a block, and the
    piece width for rows of W elements (every tensor aligned)."""

    def __init__(self, dtype, width):
        self.size = torch.empty((), dtype=dtype).element_size()
        self.kv = 16 // self.size
        self.rows = ROWS_F32 if self.size == 4 else ROWS_BF16
        self.window = WINDOW_F32 if self.size == 4 else WINDOW_BF16
        self.threads_x = COLS // self.kv
        self.threads = self.threads_x * self.rows
        self.piece = next((n for n in (self.kv, 2) if width % n == 0), 1)


def thread_pixels(tile, width, out_h, bx, by):
    """(row, column, valid) of every thread's kV pixels in block (bx, by):
    thread t owns columns x .. x + kV of row r; piece j of its pixels is
    valid where r < Ho and x + j*piece < W."""
    t = torch.arange(tile.threads)
    x = bx * COLS + (t % tile.threads_x) * tile.kv
    r = by * tile.rows + t // tile.threads_x
    i = torch.arange(tile.kv)
    cols = x[:, None] + i
    piece_start = x[:, None] + (i // tile.piece) * tile.piece
    valid = (r[:, None] < out_h) & (piece_start < width)
    return r[:, None].expand_as(cols), cols, valid


def sample_points(dx, dy, cols, rows, off, height, width):
    """fnet_bilinear's arithmetic in float32: a, b and the clamped corner
    columns xL, xR and rows yT, yB."""
    xf = cols.float() + dx
    yf = (rows + off).float() + dy
    x0, y0 = torch.floor(xf), torch.floor(yf)
    xi = x0.clamp(-1.0, float(width)).long()
    yi = y0.clamp(-1.0, float(height)).long()
    return (xf - x0, yf - y0, xi.clamp(0, width - 1),
            (xi + 1).clamp(0, width - 1), yi.clamp(0, height - 1),
            (yi + 1).clamp(0, height - 1))


def window(tile, channels, box, tile_rows=None, tile_cols=COLS):
    """The block's window for its box (yl, yh, xl, xh): origin, pitch,
    rows and channel stride, and its route: shared where the window of all
    channels fits in the window's bytes and is more than a few pixels
    larger than the tile's part of the map (``tile_rows`` x ``tile_cols``:
    more rows than 2 past them or a pitch more than 2 kV past them), global
    otherwise."""
    yl, yh, xl, xh = box
    piece = tile.piece
    x0 = xl - xl % piece
    pitch = (xh + piece) // piece * piece - x0
    rows = yh - yl + 1
    tile_rows = tile.rows if tile_rows is None else tile_rows
    near = rows <= tile_rows + 2 and pitch <= tile_cols + 2 * tile.kv
    shared = (not near
              and channels * rows * pitch * tile.size <= tile.window)
    return {"y0": yl, "x0": x0, "pitch": pitch, "rows": rows,
            "cstride": rows * pitch, "shared": shared}


def staged(img, tile, win, garbage):
    """The window as the kernel stages it: a flat buffer of the window's
    bytes, filled with ``garbage``, and each channel's rows copied in
    pieces at the window's pitch, the channels rows x pitch apart."""
    channels = img.shape[0]
    buf = garbage.clone()
    pieces = win["pitch"] // tile.piece
    k = torch.arange(win["rows"] * pieces)
    row, col = k // pieces, (k % pieces) * tile.piece
    for c in range(channels):
        for e in range(tile.piece):
            buf[c * win["cstride"] + row * win["pitch"] + col + e] = img[
                c, win["y0"] + row, win["x0"] + col + e]
    assert buf.numel() * tile.size == tile.window
    assert channels * win["cstride"] <= buf.numel()
    return buf


def gather_corners(img, flow, off=0, mutation=None, seed=0):
    """The kernel's corners of one image (C, H, W) warped by one flow
    (2, Ho, W): per output pixel a, b, the four corner values of every
    channel (C, Ho, W), the clamped corners themselves, and the route each
    block took ({(bx, by): shared?}).  ``mutation`` breaks the in-window
    offsets on purpose: "pitch" (a piece too wide), "origin" (the window's
    first column one to the right) or "cstride" (the channels a row too
    far apart)."""
    channels, height, width = img.shape
    out_h = flow.shape[1]
    tile = Tile(img.dtype, width)
    garbage = torch.from_numpy(np.random.RandomState(seed).randn(
        tile.window // tile.size).astype(np.float32) * 1e3).to(img.dtype)
    a = torch.zeros(out_h, width)
    b = torch.zeros(out_h, width)
    corners = torch.zeros(4, channels, out_h, width, dtype=img.dtype)
    clamped = torch.zeros(4, out_h, width, dtype=torch.long)
    covered = torch.zeros(out_h, width, dtype=torch.long)
    routes = {}
    for by in range(-(-out_h // tile.rows)):
        for bx in range(-(-width // COLS)):
            rows, cols, valid = thread_pixels(tile, width, out_h, bx, by)
            r, x = rows[valid], cols[valid]
            covered[r, x] += 1
            pa, pb, x_l, x_r, y_t, y_b = sample_points(
                flow[0, r, x].float(), flow[1, r, x].float(), x, r, off,
                height, width)
            box = (int(y_t.min()), int(y_b.max()), int(x_l.min()),
                   int(x_r.max()))
            win = window(tile, channels, box,
                         min(tile.rows, out_h - by * tile.rows),
                         min(COLS, width - bx * COLS))
            routes[bx, by] = win["shared"]
            if win["shared"]:
                src = staged(img, tile, win, garbage)
            else:
                win = {"y0": 0, "x0": 0, "pitch": width,
                       "cstride": height * width}
                src = img.reshape(-1)
            pitch, cstride, x0 = win["pitch"], win["cstride"], win["x0"]
            if mutation == "pitch" and win.get("rows"):
                pitch += tile.piece
            if mutation == "origin" and win.get("rows"):
                x0 += 1
            if mutation == "cstride" and win.get("rows"):
                cstride += pitch
            # the kernel's code: the top-left offset times 4, plus 2 where
            # the bottom corner is a row below, plus 1 where the right one
            # is a column right
            code = (((y_t - win["y0"]) * pitch + (x_l - x0)) * 4
                    + 2 * (y_b != y_t).long() + (x_r != x_l).long())
            o, dxo = code >> 2, code & 1
            dyo = torch.where(code & 2 != 0, pitch, 0)
            for c in range(channels):
                p = c * cstride + o
                for k, q in enumerate((p, p + dxo, p + dyo, p + dyo + dxo)):
                    corners[k, c, r, x] = src[q]
            a[r, x], b[r, x] = pa, pb
            for k, v in enumerate((y_t, x_l, y_b, x_r)):
                clamped[k, r, x] = v
    assert (covered == 1).all(), "every output pixel has exactly one thread"
    return a, b, corners, clamped, routes


def corners_equal_image(img, corners, clamped):
    """Whether each gathered corner is the image at its clamped corner."""
    y_t, x_l, y_b, x_r = clamped
    want = [img[:, y, x] for y, x in ((y_t, x_l), (y_t, x_r), (y_b, x_l),
                                      (y_b, x_r))]
    return all(torch.equal(corners[k], want[k]) for k in range(4))


def emulated_k2(img, flow, off=0):
    """K2 on the emulated corners: the weights and the lerp in float32,
    rounded once to the image's dtype."""
    a, b, (tl, tr, bl, br), _, _ = gather_corners(img, flow, off)
    tl, tr, bl, br = (t.float() for t in (tl, tr, bl, br))
    out = ((1 - a) * (1 - b) * tl + a * (1 - b) * tr + (1 - a) * b * bl
           + a * b * br)
    return out.to(img.dtype)


def emulated_k4(g, img, flow, off=0):
    """K4 on the emulated corners: both sums in float32 over the channels
    in order, rounded once to the flow's dtype."""
    a, b, (tl, tr, bl, br), _, _ = gather_corners(img, flow, off)
    tl, tr, bl, br, g = (t.float() for t in (tl, tr, bl, br, g))
    ddx = torch.zeros_like(a)
    ddy = torch.zeros_like(a)
    for c in range(img.shape[0]):
        ddx = ddx + g[c] * ((1 - b) * (tr[c] - tl[c]) + b * (br[c] - bl[c]))
        ddy = ddy + g[c] * ((1 - a) * (bl[c] - tl[c]) + a * (br[c] - tr[c]))
    return torch.stack([ddx, ddy]).to(flow.dtype)


def _flow(shape, px, seed):
    """A uniform +-px flow (2, Ho, W) as float32; 0 px is the zero flow."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(((rng.rand(2, *shape) * 2 - 1) * px).astype(
        np.float32))


def _image(channels, height, width, seed):
    return torch.from_numpy(np.random.RandomState(seed).randn(
        channels, height, width).astype(np.float32))


def _one_ulp(got, want):
    got, want = got.float(), want.float()
    tol = BF16_ULP * want.abs() + 1e-6 * want.abs().max()
    assert bool(((got - want).abs() <= tol).all())


HEIGHT = 208      # a band at row 192 of 16 rows fits
ROW_CASES = [(0, HEIGHT), (0, 40), (24, 40), (192, 16)]   # (off, Ho)


def test_constants_hold_the_budget():
    """The window holds the box of a +-8 px flow over C = 3 for both dtypes
    (the tile's rows + 16 x 64 + 16 columns: rows [Y - 8, Y + rows + 8)
    and columns [X - 8, X + 72) of a tile at X = 64), which takes the
    shared route; a zero flow's (the tile and one more row and column)
    takes the global one; and the window leaves room for at least two
    blocks an SM (227 KB a block at most)."""
    for dtype in (torch.float32, torch.bfloat16):
        tile = Tile(dtype, 512)
        assert tile.threads % 32 == 0 and tile.threads <= 1024
        win = window(tile, 3, (0, tile.rows + 15, 56, 135))
        assert (win["rows"], win["pitch"]) == (tile.rows + 16, 80)
        assert win["shared"], (dtype, win)
        assert not window(tile, 3, (8, 8 + tile.rows, 64, 128))["shared"]
        assert 2 * tile.window <= 227 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 150, 151])
def test_thread_map_and_pieces(dtype, width):
    """Every output pixel has one thread; a valid piece starts on a
    multiple of its width and lies inside the row; the tail is masked; the
    piece width is 16 bytes, 2 elements or 1 as W allows."""
    tile = Tile(dtype, width)
    want = {(torch.float32, 64): 4, (torch.float32, 150): 2,
            (torch.float32, 151): 1, (torch.bfloat16, 64): 8,
            (torch.bfloat16, 150): 2, (torch.bfloat16, 151): 1}
    assert tile.piece == want[dtype, width]
    out_h = 37
    covered = torch.zeros(out_h, width, dtype=torch.long)
    for by in range(-(-out_h // tile.rows)):
        for bx in range(-(-width // COLS)):
            rows, cols, valid = thread_pixels(tile, width, out_h, bx, by)
            assert (cols[valid] < width).all() and (rows[valid] < out_h).all()
            starts = cols[:, ::tile.piece][valid[:, ::tile.piece]]
            assert (starts % tile.piece == 0).all()
            # a piece is valid whole or not at all
            per_piece = valid.reshape(tile.threads, -1, tile.piece)
            assert (per_piece.all(-1) | ~per_piece.any(-1)).all()
            # and every in-row pixel of the block is valid
            in_map = (rows < out_h) & (cols < width)
            assert torch.equal(valid, in_map)
            covered[rows[valid], cols[valid]] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 150, 151])
@pytest.mark.parametrize("px", [0.0, 8.0, 200.0])
def test_corners_are_the_image_at_the_clamped_corners(dtype, width, px):
    """Both routes gather each corner of every channel bit for bit, over
    the whole image and local rows at offsets 0, 24 and 192; +-8 px flows
    take the shared route, zero and +-200 px flows the global one."""
    img = _image(3, HEIGHT, width, 1).to(dtype)
    for off, out_h in ROW_CASES:
        flow = _flow((out_h, width), px, 2 + off).to(dtype)
        a, b, corners, clamped, routes = gather_corners(img, flow, off)
        assert corners_equal_image(img, corners, clamped), (off, out_h)
        assert set(routes.values()) == {px == 8.0}, (off, routes)
        # the fractional offsets are fnet_bilinear's, in [0, 1)
        assert ((a >= 0) & (a < 1) & (b >= 0) & (b < 1)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_choice_mixed_batch_and_wide_channels(dtype):
    """One launch whose blocks take both routes: one image at +-8 px (its
    windows staged), one at +-200 px (its windows too large) and one at a
    zero flow (its windows hardly larger than the tile); and a +-8 px flow
    over C = 5, whose window does not fit away from the image's edges
    (5 x 32 rows x 80 columns x 4 bytes in float32, 5 x 48 x 80 x 2 in
    bfloat16)."""
    img = _image(3, 64, 150, 3).to(dtype)
    seen = set()
    for px, shared in ((8.0, True), (200.0, False), (0.0, False)):
        _, _, corners, clamped, routes = gather_corners(
            img, _flow((64, 150), px, 4).to(dtype))
        assert corners_equal_image(img, corners, clamped)
        assert set(routes.values()) == {shared}, px
        seen |= set(routes.values())
    assert seen == {True, False}
    wide = _image(5, 64, 150, 5).to(dtype)
    _, _, corners, clamped, routes = gather_corners(
        wide, _flow((64, 150), 8.0, 6).to(dtype))
    assert corners_equal_image(wide, corners, clamped)
    assert not routes[1, 1]


@pytest.mark.parametrize("mutation", MUTATIONS)
def test_offset_mutations_are_caught(mutation):
    """A wrong pitch, a window origin off by one column and a wrong channel
    stride in the in-window offsets each gather a corner that is not the
    image's (the garbage around the staged window shows through)."""
    for dtype, width in ((torch.float32, 64), (torch.bfloat16, 151)):
        img = _image(3, 48, width, 7).to(dtype)
        flow = _flow((48, width), 8.0, 8).to(dtype)
        _, _, corners, clamped, routes = gather_corners(img, flow,
                                                        mutation=mutation)
        assert all(routes.values())
        assert not corners_equal_image(img, corners, clamped), (mutation,
                                                                dtype)


def _smooth_flow(out_h, width, seed):
    """A uniform +-8 px flow at (Ho/4, W/4) bilinearly upsampled x4, as the
    stage glue's flow is made."""
    coarse = _flow((out_h // 4, width // 4), 8.0, seed).unsqueeze(0)
    return torch.nn.functional.interpolate(
        coarse, scale_factor=4, mode="bilinear", align_corners=False)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [64, 150, 151])
def test_emulated_warps_match_plain(dtype, width):
    """K2 and K4 on the emulated corners against the plain versions, for
    two flows (+-8 px, and smooth or +-200 px), over the whole image and
    on local rows at offsets 24 and 192 (each band's rows the whole
    image's bits)."""
    img = _image(3, HEIGHT, width, 9).to(dtype)
    flows = [_flow((HEIGHT, width), 8.0, 10),
             _smooth_flow(HEIGHT, width - width % 4, 11) if width % 4 == 0
             else _flow((HEIGHT, width), 200.0, 11)]
    for k, flow in enumerate(flows):
        flow = flow.to(dtype)
        g = _image(3, HEIGHT, width, 12 + k).to(dtype)
        out = emulated_k2(img, flow)
        d_flow = emulated_k4(g, img, flow)
        want = resample2d.resample2d_plain(img[None], flow[None])[0]
        want_d = resample2d.resample2d_grad_flow_plain(
            g[None, None], img[None], flow[None, None])[0, 0]
        if dtype == torch.float32:
            torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(d_flow, want_d, rtol=1e-6, atol=1e-6)
        else:
            assert out.dtype == d_flow.dtype == torch.bfloat16
            _one_ulp(out, want)
            _one_ulp(d_flow, want_d)
        for off, out_h in ROW_CASES[2:]:
            rows = slice(off, off + out_h)
            local = flow[:, rows].contiguous()
            assert torch.equal(emulated_k2(img, local, off), out[:, rows])
            assert torch.equal(emulated_k4(g[:, rows], img, local, off),
                               d_flow[:, rows])


@pytest.mark.parametrize("dtype,width", [(torch.float32, 150),
                                         (torch.bfloat16, 151)])
def test_emulated_warps_match_pallas_kernels_interpret(dtype, width):
    """K2 and K4 on the emulated corners against the TPU kernels they
    replace (resample2d_bilinear_pallas, resample2d_grad_flow_pallas) in
    interpret mode, at a +-8 px flow."""
    img = _image(3, 24, width, 13).to(dtype)
    flow = _flow((24, width), 8.0, 14).to(dtype)
    g = _image(3, 24, width, 15).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def nhwc(t):
        return jnp.asarray(t.float().permute(1, 2, 0)[None].numpy(), jdt)

    with pltpu.force_tpu_interpret_mode():
        want = jax_r2d_pallas.resample2d_bilinear_pallas(nhwc(img),
                                                         nhwc(flow))
        want_d = jax_r2d_pallas.resample2d_grad_flow_pallas(
            nhwc(g), nhwc(img), nhwc(flow))
    want = torch.from_numpy(np.array(want.astype(jnp.float32))[0]).permute(
        2, 0, 1)
    got = emulated_k2(img, flow).float()
    got_d = emulated_k4(g, img, flow)
    if dtype == torch.float32:
        want_d = torch.from_numpy(np.array(want_d)[0]).permute(2, 0, 1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_d, want_d, rtol=1e-5, atol=1e-4)
    else:
        want_d = torch.from_numpy(np.array(
            want_d.astype(jnp.bfloat16).astype(jnp.float32))[0]).permute(
                2, 0, 1)
        torch.testing.assert_close(got, want, rtol=0.02, atol=0.02)
        _one_ulp(got_d, want_d)
