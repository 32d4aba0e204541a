"""The x/z transforms of the channel-flow kernels on the CPU: the host-side
plan of the in-kernel FFTs (twiddle tables, bit reversal, output column
order, inverse scaling) driven by a numpy emulation of the kernels' index
arithmetic (kept here, beside its only callers), the rule that picks the
FFT or the DFT route, the plain versions against the JAX package's
Kronecker factors, and the wrappers' refusals.  Inputs are numpy arrays made from a seed."""
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.envs import poisson_pallas as jpp
from pde_policylearning_torch.envs import channel_flow as cf
from pde_policylearning_torch.envs import rk3_cuda as rk
from pde_policylearning_torch.envs import xz_fft
from pde_policylearning_torch.envs.poisson_cuda import _kron_mats

PLANES = [(8, 8), (16, 32), (32, 32), (2, 2), (4, 2), (2, 16)]


# ---------------------------------------------------------------------------
# The kernels' index arithmetic (csrc/common.cuh: xz_fft_forward_kernel,
# xz_fft_inverse_kernel, fft_passes) in numpy, statement by statement, on the
# tables the host uploads (`xz_fft.twiddles`).
# ---------------------------------------------------------------------------

def bit_reverse(N: int) -> np.ndarray:
    """perm[v] = v with its log2(N) bits reversed."""
    bits = N.bit_length() - 1
    v = np.arange(N)
    out = np.zeros(N, dtype=np.int64)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def _passes(re, im, count, stride, N, tw, sign):
    """`fft_passes` of the kernels (csrc/common.cuh) on flat re/im arrays,
    in place: `count` arrays of N points at a*stride, bit-reversed in,
    natural out."""
    half_n = N // 2
    e = np.arange(count * half_n)
    a, q = e // half_n, e % half_n
    half = 1
    while half < N:
        tstep = half_n // half
        k = q & (half - 1)
        i0 = a * stride + ((q - k) << 1) + k
        i1 = i0 + half
        wr, wi = tw[k * tstep, 0], sign * tw[k * tstep, 1]
        br, bi = re[i1], im[i1]
        tr, ti = wr * br - wi * bi, wr * bi + wi * br
        ar, ai = re[i0].copy(), im[i0].copy()
        re[i1], im[i1] = ar - tr, ai - ti
        re[i0], im[i0] = ar + tr, ai + ti
        half *= 2


def emulate_forward(plane: np.ndarray, dtype=np.float64) -> np.ndarray:
    """`xz_fft_forward_kernel` on one (Nx, Nz) plane -> (F2,), step by step
    as the kernel indexes it, in `dtype` (the twiddles rounded to it)."""
    Nx, Nz = plane.shape
    Nzr, sx = Nz // 2 + 1, Nx + 1
    twx = xz_fft.twiddles(Nx).astype(dtype)
    twz = xz_fft.twiddles(Nz).astype(dtype)
    brx, brz = bit_reverse(Nx), bit_reverse(Nz)
    zre = np.zeros(Nx // 2 * Nz, dtype)
    zim = np.zeros_like(zre)
    xre = np.zeros(Nzr * sx, dtype)
    xim = np.zeros_like(xre)
    flat = plane.astype(dtype).reshape(-1)
    e = np.arange(Nx * Nz)
    x, z = e // Nz, e % Nz
    pos = (x >> 1) * Nz + brz[z]
    zre[pos[x % 2 == 0]] = flat[x % 2 == 0]
    zim[pos[x % 2 == 1]] = flat[x % 2 == 1]
    _passes(zre, zim, Nx // 2, Nz, Nz, twz, 1.0)
    e = np.arange(Nx // 2 * Nzr)
    pr, f = e // Nzr, e % Nzr
    fc = (Nz - f) & (Nz - 1)
    ar, ai = zre[pr * Nz + f], zim[pr * Nz + f]
    cr, ci = zre[pr * Nz + fc], zim[pr * Nz + fc]
    p0, p1 = f * sx + brx[2 * pr], f * sx + brx[2 * pr + 1]
    half = dtype(0.5)
    xre[p0], xim[p0] = half * (ar + cr), half * (ai - ci)
    xre[p1], xim[p1] = half * (ai + ci), half * (cr - ar)
    _passes(xre, xim, Nzr, sx, Nx, twx, 1.0)
    e = np.arange(Nx * Nzr)
    kx, f = e // Nzr, e % Nzr
    return np.concatenate([xre[f * sx + kx], xim[f * sx + kx]])


def emulate_inverse(spec: np.ndarray, Nx: int, Nz: int,
                    dtype=np.float64) -> np.ndarray:
    """`xz_fft_inverse_kernel` on one (F2,) spectrum -> (Nx, Nz)."""
    Nzr, sx = Nz // 2 + 1, Nx + 1
    F = Nx * Nzr
    twx = xz_fft.twiddles(Nx).astype(dtype)
    twz = xz_fft.twiddles(Nz).astype(dtype)
    brx, brz = bit_reverse(Nx), bit_reverse(Nz)
    spec = spec.astype(dtype)
    zre = np.zeros(Nx // 2 * Nz, dtype)
    zim = np.zeros_like(zre)
    xre = np.zeros(Nzr * sx, dtype)
    xim = np.zeros_like(xre)
    e = np.arange(F)
    kx, f = e // Nzr, e % Nzr
    pos = f * sx + brx[kx]
    xre[pos], xim[pos] = spec[e], spec[F + e]
    _passes(xre, xim, Nzr, sx, Nx, twx, -1.0)
    e = np.arange(Nx // 2 * Nzr)
    pr, f = e // Nzr, e % Nzr
    g0r, g0i = xre[f * sx + 2 * pr], xim[f * sx + 2 * pr]
    g1r, g1i = xre[f * sx + 2 * pr + 1], xim[f * sx + 2 * pr + 1]
    p = pr * Nz + brz[f]
    edge = (f == 0) | (2 * f == Nz)
    zre[p[edge]], zim[p[edge]] = g0r[edge], g1r[edge]
    mid = ~edge
    pc = pr * Nz + brz[(Nz - f) & (Nz - 1)]
    zre[p[mid]], zim[p[mid]] = (g0r - g1i)[mid], (g0i + g1r)[mid]
    zre[pc[mid]], zim[pc[mid]] = (g0r + g1i)[mid], (g1r - g0i)[mid]
    _passes(zre, zim, Nx // 2, Nz, Nz, twz, -1.0)
    e = np.arange(Nx * Nz)
    x, z = e // Nz, e % Nz
    src = (x >> 1) * Nz + z
    scale = dtype(1.0) / (dtype(Nx) * dtype(Nz))
    return (scale * np.where(x % 2 == 1, zim[src], zre[src])).reshape(Nx, Nz)


def kron2(Nx, Nz):
    """T2 (C, 2F) and Ti2 (2F, C) in float64."""
    TR, TI, TiR, TiI = _kron_mats(Nx, Nz)
    return np.concatenate([TR, TI], 1), np.concatenate([TiR, -TiI], 0)


@pytest.mark.parametrize("Nx,Nz", PLANES)
def test_forward_plan_matches_dft_product(Nx, Nz):
    """The forward kernel's index arithmetic (bit-reversed loads, radix-2
    passes, separation of the packed row pairs, transposed store) emulated
    in float64 equals `plane @ T2`, 1e-12 of the spectrum's scale."""
    rng = np.random.default_rng(0)
    T2, _ = kron2(Nx, Nz)
    for _ in range(3):
        plane = rng.normal(size=(Nx, Nz))
        ref = plane.reshape(-1) @ T2
        out = emulate_forward(plane)
        assert out.shape == (2 * Nx * (Nz // 2 + 1),)
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("Nx,Nz", PLANES)
def test_inverse_plan_matches_dft_product(Nx, Nz):
    """The inverse kernel emulated in float64 equals `spec @ Ti2` for an
    arbitrary spectrum (not a transform of a real plane): the conjugate-pair
    doubling, the 1/(Nx Nz) factor and the dropped imaginary parts of the
    f = 0 and Nyquist bins are Ti2's; 1e-12."""
    rng = np.random.default_rng(1)
    _, Ti2 = kron2(Nx, Nz)
    for _ in range(3):
        spec = rng.normal(size=Ti2.shape[0])
        ref = (spec @ Ti2).reshape(Nx, Nz)
        out = emulate_inverse(spec, Nx, Nz)
        np.testing.assert_allclose(out, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("Nx,Nz", [(8, 8), (32, 32)])
def test_plan_round_trip_and_float32(Nx, Nz):
    """inverse(forward(plane)) is the plane (1e-12), and the float32
    emulation (twiddles rounded once to float32, as the kernels read them)
    sits no further from float64 than the float32 DFT product does."""
    rng = np.random.default_rng(2)
    plane = rng.normal(size=(Nx, Nz))
    back = emulate_inverse(emulate_forward(plane), Nx, Nz)
    np.testing.assert_allclose(back, plane, rtol=0, atol=1e-12)
    T2, _ = kron2(Nx, Nz)
    exact = plane.reshape(-1) @ T2
    fft32 = emulate_forward(plane, np.float32)
    assert fft32.dtype == np.float32
    prod32 = plane.reshape(-1).astype(np.float32) @ T2.astype(np.float32)
    assert np.linalg.norm(fft32 - exact) <= np.linalg.norm(prod32 - exact)


def test_plan_tables():
    """Twiddles are exp(-2 pi i k / N) for k < N/2; the bit reversal is an
    involution that matches a string reversal of the bits."""
    for N in (2, 8, 32, 64):
        tw = xz_fft.twiddles(N)
        k = np.arange(N // 2)
        np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1],
                                   np.exp(-2j * np.pi * k / N), atol=1e-15)
        br = bit_reverse(N)
        bits = N.bit_length() - 1
        assert [int(format(v, f"0{bits}b")[::-1], 2) for v in range(N)] \
            == br.tolist()
        np.testing.assert_array_equal(br[br], np.arange(N))
    assert xz_fft.fft_flops(32, 32) == 28576


@pytest.mark.parametrize("Nx,Nz,fft", [
    (32, 32, True), (8, 8, True), (16, 64, True), (2, 2, True),
    (128, 128, True),            # 197 KB of shared memory: still one block
    (256, 128, False),           # the plane no longer fits an SM
    (24, 20, False), (32, 20, False), (24, 32, False), (1, 32, False),
    (32, 1, False), (48, 48, False)])
def test_dispatch_rule(Nx, Nz, fft):
    """Powers of two (>= 2) whose block fits shared memory take the FFT
    kernels; any other grid keeps the DFT products."""
    assert xz_fft.fft_route(Nx, Nz) is fft
    if fft:
        assert xz_fft.smem_bytes(Nx, Nz) <= xz_fft.MAX_DYNAMIC_SMEM


def test_kernel_args_refuse_fft_constants_for_a_dft_grid():
    """The route is the grid's (`xz_fft.fft_route`): asking `kernel_args`
    for the FFT kernels' constants on a grid that cannot take them raises,
    before the device is looked at."""
    odd = cf.make_channel_grid(Nx=6, Ny=9, Nz=10, device="cpu")
    with pytest.raises(ValueError, match="cannot take the FFT kernels"):
        rk.kernel_args(odd, 1, fft=True)
    assert not odd.cache.get(("kernel_args", 1))


@pytest.mark.parametrize("Nx,Nz", [(8, 8), (16, 32), (32, 32)])
def test_plan_matches_jax_factors(Nx, Nz):
    """The emulated kernels against the JAX package's own Kronecker factors
    (`poisson_pallas._kron_mats`, stored in float32: 1e-6 of the result's
    scale), forward and inverse."""
    rng = np.random.default_rng(5)
    TR, TI, TiR, TiI = (np.asarray(a, np.float64)
                        for a in jpp._kron_mats(Nx, Nz))
    F = Nx * (Nz // 2 + 1)
    plane = rng.normal(size=(Nx, Nz))
    out = emulate_forward(plane)
    ref = np.concatenate([plane.reshape(-1) @ TR, plane.reshape(-1) @ TI])
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    spec = rng.normal(size=2 * F)
    back = emulate_inverse(spec, Nx, Nz)
    ref = (spec[:F] @ TiR - spec[F:] @ TiI).reshape(Nx, Nz)
    np.testing.assert_allclose(back, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("Nx,Nz", [(8, 8), (6, 10)])
def test_plain_transforms_match_jax_factors(Nx, Nz):
    """`xz_forward_plain` / `xz_inverse_plain` on packed fields are the
    products with the JAX package's Kronecker factors
    (`poisson_pallas._kron_mats`, stored in float32: 1e-5), B = 1 and 3,
    and with the port's float64 factors (1e-12)."""
    rng = np.random.default_rng(3)
    grid = cf.make_channel_grid(Nx=Nx, Ny=9, Nz=Nz, device="cpu",
                                dtype=torch.float64)
    TR, TI, TiR, TiI = (np.asarray(a, np.float64)
                        for a in jpp._kron_mats(Nx, Nz))
    C, F = Nx * Nz, Nx * (Nz // 2 + 1)
    for B in (1, 3):
        Y = rng.normal(size=(5, B * C))
        t = rk.xz_forward_plain(grid, B, torch.as_tensor(Y)).numpy()
        Yb = Y.reshape(5, B, C).transpose(1, 0, 2)
        np.testing.assert_allclose(t[..., :F], Yb @ TR, atol=1e-5)
        np.testing.assert_allclose(t[..., F:], Yb @ TI, atol=1e-5)
        P = rng.normal(size=(B, 4, 2 * F))
        out = rk.xz_inverse_plain(grid, torch.as_tensor(P)).numpy()
        ref = P[..., :F] @ TiR - P[..., F:] @ TiI
        np.testing.assert_allclose(
            out, ref.transpose(1, 0, 2).reshape(4, B * C), atol=1e-5)
        # and against the float64 factors of the port, tightly
        T2, Ti2 = kron2(Nx, Nz)
        np.testing.assert_allclose(t, Yb @ T2, atol=1e-12)
        np.testing.assert_allclose(
            out, (P @ Ti2).transpose(1, 0, 2).reshape(4, B * C), atol=1e-12)


def test_dft_matrices_are_built_at_first_use():
    """A grid's constants hold no DFT matrix until a plain version (or a
    grid on the DFT route) asks for one."""
    grid = cf.make_channel_grid(Nx=8, Ny=9, Nz=8, device="cpu")
    c = rk.solve_consts(grid)
    assert "_kron" not in c.__dict__
    assert tuple(c.T2.shape) == (64, 80) and tuple(c.Ti2.shape) == (80, 64)
    assert "_kron" in c.__dict__ and rk.solve_consts(grid) is c


@pytest.mark.parametrize("which", ["forward", "inverse"])
def test_transform_wrappers_refuse(which):
    """The kernel wrappers take float32 CUDA tensors only: a CPU tensor, a
    wrong dtype, a wrong shape and an input that needs a gradient raise."""
    grid = cf.make_channel_grid(Nx=8, Ny=9, Nz=8, device="cpu")
    if which == "forward":
        good = torch.zeros((8, 2 * 64))

        def call(a):
            return rk.xz_forward_kernel(grid, 2, a)
    else:
        good = torch.zeros((2, 8, 80))
        call = lambda a: rk.xz_inverse_kernel(grid, a)   # noqa: E731
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        call(good)
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        call(good.double())
    with pytest.raises(RuntimeError, match="passes no gradient"):
        call(good.clone().requires_grad_())
    assert rk.xz_forward_kernel.launches == 0
    assert rk.xz_inverse_kernel.launches == 0


def test_kernel_args_need_a_cuda_float32_grid():
    grid = cf.make_channel_grid(Nx=8, Ny=9, Nz=8, device="cpu")
    with pytest.raises(ValueError, match="float32 grid on a CUDA"):
        rk.kernel_args(grid, 1)


@pytest.mark.cuda
def test_transform_kernels_match_products_on_the_card():
    """On a card: both routes against the products (2e-6) at a
    power-of-two grid and at one that is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    rng = np.random.default_rng(4)
    for shape in ((16, 10, 32), (12, 10, 20)):
        grid = cf.make_channel_grid(*shape, device="cuda")
        Nx, Ny, Nz = shape
        Y = torch.as_tensor(rng.normal(size=(Ny - 1, 2 * Nx * Nz)),
                            dtype=torch.float32, device="cuda")
        out, ref = (rk.xz_forward_kernel(grid, 2, Y),
                    rk.xz_forward_plain(grid, 2, Y))
        assert float((out - ref).norm() / ref.norm()) < 2e-6
        back = rk.xz_inverse_kernel(grid, out)
        assert float((back - Y).norm() / Y.norm()) < 2e-6
