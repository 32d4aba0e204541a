"""The weight gradient of the fused corner entry (`spectral_corners_dw_*`):
the plain version against the JAX package's VJPs in float64, a numpy
emulation of `corners_dw_kernel`'s launch plan and index arithmetic
(csrc/corner_contract.cu) against the plain version, and the wrapper's
refusals on the CPU."""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.ops import fourier as jfourier
from pde_policylearning_tpu.ops.pallas_kernels import \
    corner_contract as jcorner_contract
from pde_policylearning_torch.native import cuda_build
from pde_policylearning_torch.ops import fourier, spectral_cuda

# (spatial, half_modes, I, O): ragged channels and modes, modes up to the
# spectrum's edge (8 x 8: 2 m1 = H, m2 = Wh), one channel in
DW_CASES = [((12, 10), (4, 3), 3, 5), ((9, 7), (3, 4), 5, 2),
            ((8, 8), (4, 5), 1, 3)]
BATCHES = [1, 3, 20]


def case(seed, layout, spatial, half_modes, I, O, B):
    """x, the two corners' weights as the JAX package stores them (`mm2`
    (2, m1, m2, I, O) or the legacy `tensor` (2, I, O, m1, m2)) and a
    cotangent of the conv's output, from one numpy generator."""
    rng = np.random.default_rng(seed)
    m1, m2 = half_modes
    shape = (2, m1, m2, I, O) if layout == "mm2" else (2, I, O, m1, m2)
    ws = [{layout: 0.3 * rng.normal(size=shape)} for _ in range(2)]
    x = rng.normal(size=(B, *spatial, I))
    cot = rng.normal(size=(B, *spatial, O))
    return x, ws, cot


def spectra(x, cot, O, norm):
    """The conv's input spectrum and the gradient that reaches its output
    spectrum (irfftn's VJP of the cotangent), float64 torch tensors."""
    spatial = x.shape[1:3]
    x_ft = fourier.rfftn(torch.as_tensor(x), axes=(1, 2), norm=norm)
    out_ft = torch.zeros((x.shape[0], spatial[0], spatial[1] // 2 + 1, O),
                         dtype=torch.complex128, requires_grad=True)
    y = fourier.irfftn(out_ft, s=spatial, axes=(1, 2), norm=norm)
    (dout,) = torch.autograd.grad(y, out_ft, torch.as_tensor(cot))
    return x_ft, dout


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("spatial,half_modes,I,O", DW_CASES)
@pytest.mark.parametrize("layout", ["mm2", "tensor"])
def test_dw_plain_matches_jax_conv_vjp(layout, spatial, half_modes, I, O,
                                       B):
    """Both corners' weight gradients against `jax.vjp` of the JAX
    `spectral_conv_nd` in float64, rtol 1e-8; the legacy layout's
    gradient is the (2, m1, m2, I, O) block read through its permute."""
    x, ws, cot = case(60 + B, layout, spatial, half_modes, I, O, B)
    _, vjp = jax.vjp(
        lambda ws_: jfourier.spectral_conv_nd(jnp.asarray(x), ws_,
                                              half_modes, fft_norm="ortho"),
        [{layout: jnp.asarray(w[layout])} for w in ws])
    (refs,) = vjp(jnp.asarray(cot))
    x_ft, dout = spectra(x, cot, O, "ortho")
    dws = spectral_cuda.spectral_corners_dw_plain(x_ft, dout, *half_modes)
    for dw, ref in zip(dws, refs):
        got = dw if layout == "mm2" else dw.permute(0, 3, 4, 1, 2)
        b = np.asarray(ref[layout])
        assert got.dtype == torch.float64 and tuple(got.shape) == b.shape
        np.testing.assert_allclose(got.numpy(), b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("spatial,half_modes,I,O", DW_CASES[:2])
def test_dw_plain_matches_pallas_vjp(spatial, half_modes, I, O, B):
    """Against the dw of `jax.vjp` of the Pallas `corner_contract` (its
    kernel in interpret mode) on the stacked corner rows of the same
    spectra.  The Pallas kernel writes float32 (its `out_shape`) whatever
    its inputs, so this holds at its own test's float32 tolerance (rtol
    1e-4, atol 1e-5 of the largest entry); the float64 hold is the conv's
    VJP above."""
    m1, m2 = half_modes
    x, _, cot = case(70 + B, "mm2", spatial, half_modes, I, O, B)
    x_ft, dout = spectra(x, cot, O, "backward")

    def rows(a):                    # (B, H, Wh, C) -> (2 m1, B, m2, C)
        a = torch.cat([a[:, :m1, :m2], a[:, -m1:, :m2]], 1)
        return a.transpose(0, 1).numpy()
    xc, dc = rows(x_ft), rows(dout)

    def f32(a):
        return jnp.asarray(a, jnp.float32)
    w = f32(np.zeros((2 * m1, m2, I, O)))
    _, vjp = jax.vjp(lambda wr, wi: jcorner_contract(
        f32(xc.real), f32(xc.imag), wr, wi, True), w, w)
    dwr, dwi = vjp((f32(dc.real), f32(dc.imag)))
    dws = spectral_cuda.spectral_corners_dw_plain(x_ft, dout, m1, m2)
    for c, dw in enumerate(dws):
        for part, ref in zip(dw, (dwr, dwi)):
            b = np.asarray(ref)[c * m1:(c + 1) * m1]
            np.testing.assert_allclose(part.numpy(), b, rtol=1e-4,
                                       atol=1e-5 * np.abs(b).max())


def test_dw_plain_computes_only_the_corners_asked_for():
    x, _, cot = case(80, "mm2", (12, 10), (4, 3), 3, 5, 2)
    x_ft, dout = spectra(x, cot, 5, "forward")
    both = spectral_cuda.spectral_corners_dw_plain(x_ft, dout, 4, 3)
    for want in ((True, False), (False, True)):
        got = spectral_cuda.spectral_corners_dw_plain(x_ft, dout, 4, 3, want)
        for w, g, b in zip(want, got, both):
            assert (g is None) != w
            if w:
                assert torch.equal(g, b)


# ---------------------------------------------------------------------------
# A numpy emulation of corners_dw_kernel: the host's launch plan, the block
# decode, the staging copies, the register tiles and the stores, written
# as csrc/corner_contract.cu writes them.  Unstaged shared memory is NaN,
# so a read of a slot no copy filled shows in the result.
# ---------------------------------------------------------------------------

def kernel_constants():
    """The kDw... constants (tile, rows, shared bytes, register tile) from
    the source's text."""
    src = (cuda_build.CSRC / "corner_contract.cu").read_text()
    line = re.search(r"constexpr int (kDwMaxTile[^;]*);", src, re.S).group(1)
    vals = dict(re.findall(r"(\w+) = ([^,]+)", line))
    return {k: eval(v) for k, v in vals.items()}


def pitch(t, reg):
    """dw_pitch: a tile padded to whole register tiles."""
    return -(-t // reg) * reg


def balance(n, tiles):
    width = -(-n // tiles)
    return -(-n // width), width


def launch_plan(B, I, O, modes, sms=132, c=None):
    """`pde_spectral_corners_dw`'s launch: (i_tiles, o_tiles, tI, tO, kb,
    nbuf, shared bytes, threads, blocks)."""
    c = c or kernel_constants()
    tile, rows, smem_cap = c["kDwMaxTile"], c["kDwMaxRows"], c["kDwSmemBytes"]
    i_tiles, tI = balance(I, -(-I // tile))
    o_tiles, tO = balance(O, -(-O // tile))
    while modes * i_tiles * o_tiles < sms and (tI >= 16 or tO >= 16):
        if tO >= tI:
            o_tiles, tO = balance(O, 2 * o_tiles)
        else:
            i_tiles, tI = balance(I, 2 * i_tiles)
    pI, pO = pitch(tI, c["kDwRegI"]), pitch(tO, c["kDwRegO"])
    kb = min(smem_cap // 2 // ((pI + pO) * 8), rows, B)
    nbuf = 2 if B > kb else 1
    threads = -(-(pI // c["kDwRegI"]) * (pO // c["kDwRegO"]) // 32) * 32
    return (i_tiles, o_tiles, tI, tO, kb, nbuf, nbuf * kb * (pI + pO) * 8,
            threads, modes * i_tiles * o_tiles)


def stage(buf, flat, base, stride, step, nb, width, pitch, vec):
    """stage_rows: element e of the copy loop to its slot."""
    if vec:
        assert step == 1 and width % 2 == 0 and base % 2 == 0 \
            and stride % 2 == 0
        e = np.arange(nb * (width // 2))
        b = e // (width // 2)
        p = 2 * (e - b * (width // 2))
        cols = np.concatenate([p, p + 1])
        b = np.concatenate([b, b])
    else:
        e = np.arange(nb * width)
        b = e // width
        cols = e - b * width
    src = base + b * stride + cols * step
    assert src.max() < flat.size and (cols < pitch).all()
    buf[b, cols] = flat[src]


def pairs_fit(st, tile):
    """The host's 16-byte rule (the spectra taken as 16-byte aligned)."""
    return st[3] == 1 and all(v % 2 == 0 for v in st[:3]) and tile % 2 == 0


def emulate_dw(x, d, m1, m2, want, sms=132):
    """The kernel on complex128 numpy spectra x (B, H, Wh, I), d (B, H, Wh,
    O) of any strides (read through them from the arrays' buffers, as the
    kernel does): returns [low, high] (2, m1, m2, I, O) or None, and the
    plan."""
    B, H, Wh, I = x.shape
    O = d.shape[3]
    c = kernel_constants()
    nc = sum(want)
    c_first = 0 if want[0] else 1
    plan = launch_plan(B, I, O, nc * m1 * m2, sms)
    i_tiles, o_tiles, tI, tO, kb, nbuf, smem, threads, blocks = plan
    assert smem <= c["kDwSmemBytes"] and threads <= 1024
    RI, RO = c["kDwRegI"], c["kDwRegO"]
    pI, pO = pitch(tI, RI), pitch(tO, RO)
    xst, dst = (tuple(s // 16 for s in a.strides) for a in (x, d))
    vec_x, vec_d = pairs_fit(xst, tI), pairs_fit(dst, tO)
    vec_o = O % 2 == 0 and tO % 2 == 0
    xf, df = (np.lib.stride_tricks.as_strided(
        a, shape=(a.size if a.base is None else a.base.size,),
        strides=(16,)) for a in (x, d))
    outs = [np.full((2, m1, m2, I, O), np.nan) if w else None for w in want]
    written = [np.zeros((m1, m2, I, O), int) for _ in range(2)]
    tid = np.arange(threads)
    nto = pO // RO
    ia, oa = RI * (tid // nto), RO * (tid % nto)
    for blk in range(blocks):
        ot, idx = blk % o_tiles, blk // o_tiles
        it, idx = idx % i_tiles, idx // i_tiles
        ky, r = idx % m2, idx // m2
        corner, kx = c_first + r // m1, r % m1
        h = H - m1 + kx if corner else kx
        i0, o0 = it * tI, ot * tO
        wI, wO = min(tI, I - i0), min(tO, O - o0)
        assert wI >= 1 and wO >= 1
        live = (ia < wI) & (oa < wO)
        acc = np.zeros((threads, RI, RO), complex)
        nchunks = -(-B // kb)
        assert (nchunks > 1) == (nbuf == 2)
        for ch in range(nchunks):
            nb = min(kb, B - ch * kb)

            sx = np.full((kb, pI), np.nan + 0j)
            sd = np.full((kb, pO), np.nan + 0j)
            b0 = ch * kb
            stage(sx, xf, h * xst[1] + ky * xst[2] + i0 * xst[3]
                  + b0 * xst[0], xst[0], xst[3], nb, wI, pI, vec_x)
            stage(sd, df, h * dst[1] + ky * dst[2] + o0 * dst[3]
                  + b0 * dst[0], dst[0], dst[3], nb, wO, pO, vec_d)
            la, lo = ia[live], oa[live]
            assert (la + RI <= pI).all() and (lo + RO <= pO).all()
            for a in range(RI):
                for c_ in range(RO):
                    acc[live, a, c_] += (np.conj(sx[:nb, la + a])
                                         * sd[:nb, lo + c_]).sum(0)
        out = outs[corner]
        for t in tid[live]:
            for a in range(RI):
                if ia[t] + a >= wI:
                    break
                i, o = i0 + ia[t] + a, o0 + oa[t]
                for c_ in range(RO):
                    if oa[t] + c_ >= wO:
                        break
                    if vec_o and c_ % 2 == 0:   # an 8-byte pair, both live
                        assert (o + c_) % 2 == 0 and oa[t] + c_ + 1 < wO
                    out[0, kx, ky, i, o + c_] = acc[t, a, c_].real
                    out[1, kx, ky, i, o + c_] = acc[t, a, c_].imag
                    written[corner][kx, ky, i, o + c_] += 1
    for c_, w in enumerate(want):
        assert (written[c_] == (1 if w else 0)).all()
    return outs, plan


# (B, H, Wh, I, O, m1, m2): the FNO's and RNO's training shapes, a UNO
# block (I != O), the patched Trainer's B 80 (three chunks), wide channels
# (several tiles, a ragged last one), odd widths (the 8-byte copies),
# B 1, and a spectrum all corner
EMU_SHAPES = [(20, 32, 17, 32, 32, 6, 6), (32, 32, 17, 34, 34, 12, 12),
              (20, 16, 9, 128, 64, 3, 3), (80, 8, 5, 6, 4, 2, 2),
              (3, 6, 4, 200, 130, 1, 2), (5, 9, 5, 5, 7, 4, 3),
              (1, 4, 3, 3, 1, 2, 3), (2, 2, 1, 1, 1, 1, 1)]


def spectrum(rng, B, H, Wh, C, layout):
    """A complex128 (B, H, Wh, C) spectrum, contiguous or laid out
    channels-first (B, C, H, Wh) as autograd hands it to the backward."""
    shape = (B, C, H, Wh) if layout == "channels-first" else (B, H, Wh, C)
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return a.transpose(0, 2, 3, 1) if layout == "channels-first" else a


@pytest.mark.parametrize("layout", ["contiguous", "channels-first"])
@pytest.mark.parametrize("want", [(True, True), (True, False),
                                  (False, True)])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_kernel_emulation_matches_plain(shape, want, layout):
    """Every gradient entry written once, by the thread whose sums read
    only staged slots, equal to the plain version (float64, 1e-12), for
    contiguous spectra and for the channels-first ones the backward gets."""
    B, H, Wh, I, O, m1, m2 = shape
    rng = np.random.default_rng(sum(shape))
    x, d = (spectrum(rng, B, H, Wh, C, layout) for C in (I, O))
    got, _ = emulate_dw(x, d, m1, m2, want)
    ref = spectral_cuda.spectral_corners_dw_plain(
        torch.as_tensor(x), torch.as_tensor(d), m1, m2, want)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            np.testing.assert_allclose(g, r.numpy(), rtol=1e-12, atol=1e-12)


def test_launch_plan_fills_the_card_and_keeps_whole_warps():
    """The plans the main path's shapes get: the FNO's 72 modes split to
    144 blocks of 32 x 16, the RNO's 34 channels one tile of 9 x 17
    threads of 4 x 2 register tiles (5 warps, no warp idle), B 80 in
    double-buffered chunks, everything inside 48 KB and 1024 threads."""
    fno = launch_plan(20, 32, 32, 72)
    assert fno[:4] == (1, 2, 32, 16) and fno[7:] == (64, 144)
    rno = launch_plan(32, 34, 34, 288)
    assert rno[:6] == (1, 1, 34, 34, 32, 1) and rno[7:] == (160, 288)
    assert launch_plan(80, 32, 32, 288)[4:6] == (32, 2)
    for B in (1, 7, 64, 500):
        for I, O in ((1, 1), (34, 34), (64, 64), (96, 48), (300, 7)):
            for modes in (1, 72, 288, 5000):
                p = launch_plan(B, I, O, modes)
                assert p[6] <= 48 * 1024 and 32 <= p[7] <= 1024
                assert p[2] <= 64 and p[3] <= 64 and p[4] >= 1


# ---------------------------------------------------------------------------
# The wrapper on the CPU: it refuses, and the plan checks shapes
# ---------------------------------------------------------------------------

def test_dw_kernel_takes_cuda_complex64_only():
    x_ft = torch.zeros((2, 8, 5, 3), dtype=torch.complex64)
    dout = torch.zeros((2, 8, 5, 4), dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64 CUDA"):
        spectral_cuda.spectral_corners_dw_kernel(x_ft, dout, 3, 3)
    with pytest.raises(ValueError, match="complex64 CUDA"):
        spectral_cuda.spectral_corners_dw_kernel(
            x_ft.to(torch.complex128), dout.to(torch.complex128), 3, 3)
    with pytest.raises(RuntimeError, match="passes no gradient"):
        spectral_cuda.spectral_corners_dw_kernel(
            x_ft.clone().requires_grad_(), dout, 3, 3)
    assert spectral_cuda.spectral_corners_dw_kernel.launches == 0

    def plan(x, d, m1=3, m2=3, want=(True, True)):
        return spectral_cuda._dw_plan(x.shape, d.shape, x.stride(),
                                      d.stride(), m1, m2, want)
    dims, _, shape = plan(x_ft, dout)
    assert shape == (2, 2, 3, 3, 3, 4)
    assert (dims.B, dims.H, dims.Wh, dims.I, dims.O, dims.m1, dims.m2) == \
        (2, 8, 5, 3, 4, 3, 3) and list(dims.want) == [1, 1]
    assert list(dims.xs) == [120, 15, 3, 1] and list(dims.ds) == [160, 20,
                                                                   4, 1]
    # a channels-first spectrum (autograd's layout) is read in place
    first = torch.zeros((2, 4, 8, 5), dtype=torch.complex64).permute(
        0, 2, 3, 1)
    dims, _, _ = plan(x_ft, first)
    assert list(dims.ds) == [160, 5, 1, 40]
    dims, _, shape = plan(x_ft, dout, want=(False, True))
    assert shape == (1, 2, 3, 3, 3, 4) and list(dims.want) == [0, 1]
    for bad in (dict(d=dout[:1]), dict(d=dout[:, :7]), dict(m1=5),
                dict(m2=6), dict(want=(False, False)), dict(x=x_ft[0])):
        args = {"x": x_ft, "d": dout, **bad}
        with pytest.raises(ValueError, match="expected"):
            plan(**args)
