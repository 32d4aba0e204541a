"""The port's spectral ops (normalizers, factorized weights, spectral
convolution, the corner contraction's plain version and its autograd
Function, padding, resampling) against the JAX package's, on the CPU.
Inputs and weights are numpy arrays made from a seed and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pde_policylearning_tpu.ops import factorized as jfz
from pde_policylearning_tpu.ops import fourier as jfourier
from pde_policylearning_tpu.ops import normalization as jnorm
from pde_policylearning_tpu.ops import padding as jpadding
from pde_policylearning_tpu.ops import resample as jresample
from pde_policylearning_tpu.ops.pallas_kernels import \
    corner_contract as jcorner_contract
from pde_policylearning_tpu.ops.pallas_kernels import spectral_conv_2d_pallas
from pde_policylearning_torch.ops import factorized as fz
from pde_policylearning_torch.ops import fourier, normalization, padding
from pde_policylearning_torch.ops import resample, spectral_cuda


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def to_torch(tree, dtype=torch.float64):
    """A numpy weight tree (dict of arrays / lists of arrays) as tensors."""
    return {k: [torch.as_tensor(a).to(dtype) for a in v]
            if isinstance(v, list) else torch.as_tensor(v).to(dtype)
            for k, v in tree.items()}


def to_jax(tree):
    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in tree.items()}


def numpy_weight(rng, shape, factorization="dense", rank=0.5, n_lead=2,
                 scale=0.3):
    """A factorized weight with the JAX package's structure and leaf
    shapes, filled from `rng`."""
    ref = jfz.init_factorized(jax.random.PRNGKey(0), shape, factorization,
                              rank=rank, n_lead=n_lead, dtype=jnp.float64)
    return {k: [scale * rng.normal(size=a.shape) for a in v]
            if isinstance(v, list) else scale * rng.normal(size=v.shape)
            for k, v in ref.items()}


def contraction_inputs(seed, R, B, M2, I, O, dtype):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in
            [(R, B, M2, I), (R, B, M2, I), (R, M2, I, O), (R, M2, I, O)]]


# the main path's shape, the JAX tests' ragged shape, a contraction of 1
SHAPES = [(12, 1, 6, 32, 32), (4, 3, 3, 5, 6), (2, 4, 1, 1, 7)]


@pytest.mark.parametrize("shape", SHAPES)
def test_corner_contract_plain_matches_complex_einsum(shape):
    """float64, 1e-12: the four real products are the complex product."""
    xr, xi, wr, wi = map(torch.as_tensor,
                         contraction_inputs(0, *shape, np.float64))
    or_, oi_ = spectral_cuda.corner_contract_plain(xr, xi, wr, wi)
    ref = torch.einsum("rbmi,rmio->rbmo", torch.complex(xr, xi),
                       torch.complex(wr, wi))
    np.testing.assert_allclose(or_, ref.real, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(oi_, ref.imag, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_corner_contract_matches_pallas_kernel(shape):
    """float32 against the Pallas kernel in interpret mode, at the
    tolerance its own test holds it to (rtol 1e-4, atol 1e-5)."""
    args = contraction_inputs(1, *shape, np.float32)
    ref = jcorner_contract(*map(jnp.asarray, args), True)
    out = spectral_cuda.corner_contract(*map(torch.as_tensor, args))
    for a, b in zip(out, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def _torch_grads(fn, args):
    args = [torch.as_tensor(a).requires_grad_() for a in args]
    or_, oi_ = fn(*args)
    loss = (or_ ** 2).sum() + (or_ * oi_).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, args)]


def test_corner_contract_grads_match_jax_vjp():
    """float32: the Function's gradients (two transposed contractions)
    against jax.grad through the Pallas kernel's custom VJP, rtol 1e-4."""
    args = contraction_inputs(2, 2, 4, 3, 5, 6, np.float32)

    def loss(xr, xi, wr, wi):
        or_, oi_ = jcorner_contract(xr, xi, wr, wi, True)
        return jnp.sum(or_ ** 2) + jnp.sum(or_ * oi_)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
    for a, b in zip(_torch_grads(spectral_cuda.corner_contract, args), ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_corner_contract_grads_match_einsum_autograd(shape):
    """float64, 1e-10: the Function's backward against autograd through
    the complex einsum."""
    args = contraction_inputs(3, *shape, np.float64)

    def ref_fn(xr, xi, wr, wi):
        o = torch.einsum("rbmi,rmio->rbmo", torch.complex(xr, xi),
                         torch.complex(wr, wi))
        return o.real, o.imag

    for a, b in zip(_torch_grads(spectral_cuda.corner_contract, args),
                    _torch_grads(ref_fn, args)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("frozen", ["w", "x", "none"])
def test_corner_contract_backward_runs_what_is_asked(frozen, monkeypatch):
    """The backward runs one contraction per operand that needs a
    gradient: a frozen observer costs one (dx), training two."""
    calls = []
    real = spectral_cuda._contract
    monkeypatch.setattr(spectral_cuda, "_contract",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    xr, xi, wr, wi = map(torch.as_tensor,
                         contraction_inputs(4, 4, 3, 3, 5, 6, np.float64))
    needs = {"w": (xr, xi), "x": (wr, wi), "none": (xr, xi, wr, wi)}[frozen]
    for a in needs:
        a.requires_grad_()
    or_, oi_ = spectral_cuda.corner_contract(xr, xi, wr, wi)
    assert len(calls) == 1
    (or_.sum() + (oi_ ** 2).sum()).backward()
    assert len(calls) == (3 if frozen == "none" else 2)
    for a in (xr, xi, wr, wi):
        assert (a.grad is not None) == any(a is b for b in needs)


def test_corner_contract_kernel_takes_cuda_float32_only():
    args = list(map(torch.as_tensor,
                    contraction_inputs(5, 2, 2, 2, 3, 3, np.float32)))
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        spectral_cuda.corner_contract_kernel(*args)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match="passes no gradient"):
        spectral_cuda.corner_contract_kernel(*args)
    with pytest.raises(ValueError, match="expected"):
        spectral_cuda.corner_contract_kernel(args[1][0], *args[1:])


# ---------------------------------------------------------------------------
# spectral convolution
# ---------------------------------------------------------------------------

def conv_case(rng, order, half_modes, spatial, cin=3, cout=4,
              factorization="dense", n_lead=2, batch=2):
    n_corners = 2 ** (order - 1)
    ws = [numpy_weight(rng, (cin, cout, *half_modes), factorization,
                       n_lead=n_lead) for _ in range(n_corners)]
    x = rng.normal(size=(batch, *spatial, cin))
    return x, ws


def assert_conv_matches(x, ws, half_modes, tol=1e-10, **kw):
    ref = jfourier.spectral_conv_nd(jnp.asarray(x), [to_jax(w) for w in ws],
                                    half_modes, **kw)
    out = fourier.spectral_conv_nd(t64(x), [to_torch(w) for w in ws],
                                   half_modes, **kw)
    assert out.dtype == torch.float64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("order,half_modes,spatial", [
    (1, (5,), (16,)), (1, (4,), (11,)),
    (2, (4, 3), (12, 10)), (2, (3, 4), (9, 7)),
    (3, (2, 3, 2), (8, 6, 8)), (3, (2, 2, 3), (5, 6, 7))])
@pytest.mark.parametrize("norm", ["backward", "forward", "ortho"])
def test_spectral_conv_nd_matches_jax(order, half_modes, spatial, norm):
    """1-D, 2-D and 3-D, even and odd sizes, every norm; float64 1e-10."""
    rng = np.random.default_rng(10 + order)
    x, ws = conv_case(rng, order, half_modes, spatial)
    assert_conv_matches(x, ws, half_modes, fft_norm=norm)


@pytest.mark.parametrize("factorization", ["dense", "tucker", "cp", "tt"])
@pytest.mark.parametrize("implementation", ["reconstructed", "factorized"])
def test_spectral_conv_factorizations_match_jax(factorization,
                                                implementation):
    rng = np.random.default_rng(20)
    x, ws = conv_case(rng, 2, (4, 3), (12, 10), factorization=factorization)
    bias = rng.normal(size=(4,))
    ref = jfourier.spectral_conv_nd(
        jnp.asarray(x), [to_jax(w) for w in ws], (4, 3),
        implementation=implementation, bias=jnp.asarray(bias))
    out = fourier.spectral_conv_nd(
        t64(x), [to_torch(w) for w in ws], (4, 3),
        implementation=implementation, bias=t64(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("separable", [False, True])
@pytest.mark.parametrize("factorization", ["dense", "tucker", "cp", "tt"])
def test_separable_and_sliced_modes_match_jax(factorization, separable):
    """`slice_weight_modes` (incremental modes) on every factorization,
    regular and separable."""
    rng = np.random.default_rng(21)
    shape = (3, 4, 3) if separable else (3, 3, 4, 3)
    ws = [numpy_weight(rng, shape, factorization, n_lead=len(shape) - 2)
          for _ in range(2)]
    x = rng.normal(size=(2, 12, 10, 3))
    jws = [jfourier.slice_weight_modes(to_jax(w), (3, 2), separable)
           for w in ws]
    tws = [fourier.slice_weight_modes(to_torch(w), (3, 2), separable)
           for w in ws]
    ref = jfourier.spectral_conv_nd(jnp.asarray(x), jws, (3, 2),
                                    separable=separable,
                                    implementation="factorized")
    out = fourier.spectral_conv_nd(t64(x), tws, (3, 2), separable=separable,
                                   implementation="factorized")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("out_sizes", [(16, 14), (8, 6), (13, 9), (12, 11)])
@pytest.mark.parametrize("backend", ["plain", "kernel_route"])
def test_output_sizes_match_jax(out_sizes, backend):
    """Up- and down-scaling outputs, even and odd, on the plain route and
    on the kernel route's Python (its plain contraction on the CPU)."""
    rng = np.random.default_rng(22)
    x, ws = conv_case(rng, 2, (4, 3), (12, 10))
    ref = jfourier.spectral_conv_nd(
        jnp.asarray(x), [to_jax(w) for w in ws], (4, 3), fft_norm="forward",
        output_sizes=out_sizes)
    fn = (fourier.spectral_conv_nd if backend == "plain"
          else spectral_cuda.spectral_conv_2d_kernel)
    out = fn(t64(x), [to_torch(w) for w in ws], (4, 3), fft_norm="forward",
             output_sizes=out_sizes)
    assert tuple(out.shape) == (2, *out_sizes, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("layout", ["mm2", "tensor", "tucker"])
@pytest.mark.parametrize("spatial", [(12, 10), (9, 7)])
def test_kernel_route_matches_jax(layout, spatial):
    """`spectral_conv_2d_kernel` (corner stacking, contraction, placing)
    in float64 on the CPU against the JAX conv, for the mode-major and
    the legacy dense layouts; 1e-10.  A factorized weight is not the
    kernel's: the kernel route refuses it, 'kernel' raises, and 'auto'
    contracts it as the caller's `implementation` says."""
    rng = np.random.default_rng(23)
    if layout == "tucker":
        x, ws = conv_case(rng, 2, (4, 3), spatial, factorization="tucker")
    else:
        x, ws = conv_case(rng, 2, (4, 3), spatial,
                          n_lead=2 if layout == "mm2" else 0)
        assert all(layout in w for w in ws)
    bias = rng.normal(size=(4,))
    ref = jfourier.spectral_conv_nd(jnp.asarray(x), [to_jax(w) for w in ws],
                                    (4, 3), bias=jnp.asarray(bias),
                                    implementation="factorized")
    tws = [to_torch(w) for w in ws]
    if layout == "tucker":
        with pytest.raises(ValueError, match="takes dense weights"):
            spectral_cuda.spectral_conv_2d_kernel(t64(x), tws, (4, 3))
        x32 = t64(x).float()
        tws32 = [to_torch(w, torch.float32) for w in ws]
        assert not fourier.kernel_eligible(x32, tws32, (4, 3), False)
        with pytest.raises(ValueError, match="backend='kernel' requires"):
            fourier.spectral_conv_nd(x32, tws32, (4, 3), backend="kernel")
        out = fourier.spectral_conv_nd(t64(x), tws, (4, 3), bias=t64(bias),
                                       implementation="factorized")
    else:
        assert fourier.kernel_eligible(t64(x).float(), tws, (4, 3), False)
        out = spectral_cuda.spectral_conv_2d_kernel(t64(x), tws, (4, 3),
                                                    bias=t64(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


def test_kernel_route_grads_match_plain_route():
    """Gradients to x and to the stored weights through the kernel route
    (the Function's backward) against the plain route; float64 1e-10."""
    rng = np.random.default_rng(24)
    x, ws = conv_case(rng, 2, (3, 3), (8, 8))

    def grads(fn):
        xt = t64(x).requires_grad_()
        wt = [to_torch(w) for w in ws]
        leaves = [w["mm2"].requires_grad_() for w in wt]
        loss = (fn(xt, wt, (3, 3)) ** 2).mean()
        return torch.autograd.grad(loss, [xt, *leaves])

    for a, b in zip(grads(spectral_cuda.spectral_conv_2d_kernel),
                    grads(fourier.spectral_conv_nd)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_backend_dispatch(monkeypatch):
    rng = np.random.default_rng(25)
    x, ws = conv_case(rng, 2, (3, 3), (8, 8))
    ws = [to_torch(w, torch.float32) for w in ws]
    x32 = torch.as_tensor(x, dtype=torch.float32)
    plain = fourier.spectral_conv_nd(x32, ws, (3, 3), backend="plain")
    # 'kernel' on a CPU tensor: the kernel route with the plain contraction
    routed = fourier.spectral_conv_nd(x32, ws, (3, 3), backend="kernel")
    # float32: the two routes differ in the contraction's summation order
    np.testing.assert_allclose(routed.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-6)
    with pytest.raises(ValueError, match="backend='kernel' requires"):
        fourier.spectral_conv_nd(x32.double(), ws, (3, 3), backend="kernel")
    with pytest.raises(ValueError, match="backend='kernel' requires"):
        fourier.spectral_conv_nd(x32[:, :, 0], ws[:1], (3,),
                                 backend="kernel")
    with pytest.raises(ValueError, match="Unknown spectral backend"):
        fourier.spectral_conv_nd(x32, ws, (3, 3), backend="pallas")
    with pytest.raises(ValueError, match="exceeds the available spectrum"):
        fourier.spectral_conv_nd(x32, ws, (5, 3))

    # 'auto' never takes the kernel route for a CPU tensor
    def boom(*a, **k):
        raise AssertionError("kernel route taken for a CPU tensor")
    monkeypatch.setattr(spectral_cuda, "spectral_corners", boom)
    auto = fourier.spectral_conv_nd(x32, ws, (3, 3))
    np.testing.assert_array_equal(auto.numpy(), plain.numpy())


def test_scatter_oracle_and_1d_wrapper():
    rng = np.random.default_rng(26)
    x, ws = conv_case(rng, 2, (4, 3), (12, 10), cin=3, cout=3)
    tws = [to_torch(w) for w in ws]
    out = fourier.spectral_conv_nd(t64(x), tws, (4, 3))
    ref = fourier.dft_matmul_reference(
        t64(x), [fz.to_dense(w) for w in tws], (4, 3))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    x1, w1 = conv_case(rng, 1, (5,), (16,))
    np.testing.assert_allclose(
        fourier.spectral_conv_1d(t64(x1), to_torch(w1[0]), 5).numpy(),
        np.asarray(jfourier.spectral_conv_1d(jnp.asarray(x1),
                                             to_jax(w1[0]), 5)),
        rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("norm", ["backward", "forward", "ortho"])
@pytest.mark.parametrize("size,out", [((8, 6), (8, 6)), ((7, 5), (7, 5)),
                                      ((8, 6), (11, 9)), ((7, 6), (4, 4))])
def test_fft_helpers_match_jax(norm, size, out):
    """rfftn / irfftn: norms, odd and even sizes, and an output size
    different from the input's (the spectrum cut or padded at its end, the
    imaginary parts of the DC and Nyquist bins dropped)."""
    rng = np.random.default_rng(27)
    x = rng.normal(size=(2, *size, 3))
    jf = jfourier.rfftn(jnp.asarray(x), (1, 2), norm)
    tf = fourier.rfftn(t64(x), (1, 2), norm)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12,
                               atol=1e-12)
    # an arbitrary spectrum, not a transform of a real field
    spec = np.asarray(jf) + 1j * rng.normal(size=jf.shape)
    np.testing.assert_allclose(
        fourier.irfftn(torch.as_tensor(spec), out, (1, 2), norm).numpy(),
        np.asarray(jfourier.irfftn(jnp.asarray(spec), out, (1, 2), norm)),
        rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="Unknown fft norm"):
        fourier.rfftn(t64(x), (1, 2), "unitary")


# ---------------------------------------------------------------------------
# the fused corner entry: spectrum in, whole spectrum out
# ---------------------------------------------------------------------------

# (spatial, half_modes, output_sizes): even, odd and ragged sizes, modes up
# to the spectrum's edge, outputs larger and smaller than the input
FUSED_CASES = [((12, 10), (4, 3), None), ((9, 7), (3, 4), (13, 9)),
               ((8, 8), (4, 5), (6, 6)), ((5, 4), (2, 1), (5, 9))]


def fused_case(seed, layout, spatial, half_modes, cin=3, cout=4, batch=2):
    rng = np.random.default_rng(seed)
    x, ws = conv_case(rng, 2, half_modes, spatial, cin=cin, cout=cout,
                      n_lead=2 if layout == "mm2" else 0, batch=batch)
    assert all(layout in w for w in ws)
    return x, ws


@pytest.mark.parametrize("layout", ["mm2", "tensor"])
@pytest.mark.parametrize("spatial,half_modes,out_sizes", FUSED_CASES)
def test_spectral_corners_matches_jax_conv(layout, spatial, half_modes,
                                           out_sizes):
    """rfftn -> `spectral_corners` (its plain version and the Function on
    the CPU) -> irfftn against the JAX conv, float64 1e-10, for both
    stored layouts."""
    x, ws = fused_case(50, layout, spatial, half_modes)
    ref = jfourier.spectral_conv_nd(jnp.asarray(x), [to_jax(w) for w in ws],
                                    half_modes, output_sizes=out_sizes)
    tws = [to_torch(w) for w in ws]
    x_ft = torch.fft.rfftn(t64(x), dim=(1, 2))
    for fn in (spectral_cuda.spectral_corners,
               spectral_cuda.spectral_corners_plain):
        out_ft = fn(x_ft, tws, half_modes)
        assert out_ft.shape == (*x_ft.shape[:3], 4)
        out = torch.fft.irfftn(out_ft, s=out_sizes or spatial, dim=(1, 2))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("layout", ["mm2", "tensor"])
@pytest.mark.parametrize("spatial,half_modes,out_sizes", FUSED_CASES[:3])
def test_spectral_corners_matches_pallas_route(layout, spatial, half_modes,
                                               out_sizes):
    """The kernel route's Python in float32 on the CPU against
    `spectral_conv_2d_pallas` in interpret mode (a float32 kernel: the
    tolerance of its own test, rtol 1e-4, atol 1e-5)."""
    x, ws = fused_case(51, layout, spatial, half_modes)
    x32 = np.asarray(x, np.float32)
    jws = [{k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
           for w in ws]
    ref = spectral_conv_2d_pallas(jnp.asarray(x32), jws, half_modes,
                                  output_sizes=out_sizes, interpret=True)
    out = spectral_cuda.spectral_conv_2d_kernel(
        torch.as_tensor(x32), [to_torch(w, torch.float32) for w in ws],
        half_modes, output_sizes=out_sizes)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("layout", ["mm2", "tensor"])
def test_spectral_corners_writes_the_whole_spectrum(layout):
    """Against a numpy oracle on an arbitrary complex spectrum: the two
    corner products where they belong, exact zeros everywhere else;
    1e-12."""
    rng = np.random.default_rng(52)
    B, H, Wh, I, O, m1, m2 = 2, 9, 5, 3, 4, 4, 3
    _, ws = fused_case(52, layout, (H, 2 * (Wh - 1)), (m1, m2), I, O)
    x_ft = rng.normal(size=(B, H, Wh, I)) + 1j * rng.normal(
        size=(B, H, Wh, I))
    ref = np.zeros((B, H, Wh, O), complex)
    for rows, w in zip((slice(None, m1), slice(-m1, None)), ws):
        wc = fz.to_dense(to_torch(w)).numpy()               # (I, O, m1, m2)
        ref[:, rows, :m2] = np.einsum("bxyi,ioxy->bxyo", x_ft[:, rows, :m2],
                                      wc)
    out = spectral_cuda.spectral_corners(torch.as_tensor(x_ft),
                                         [to_torch(w) for w in ws]).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)
    mask = np.ones((H, Wh), bool)
    mask[:m1, :m2] = mask[-m1:, :m2] = False
    assert np.all(out[:, mask] == 0)
    with pytest.raises(ValueError, match="half_modes"):
        spectral_cuda.spectral_corners(torch.as_tensor(x_ft),
                                       [to_torch(w) for w in ws], (m1, 2))


@pytest.mark.parametrize("layout", ["mm2", "tensor"])
@pytest.mark.parametrize("spatial,half_modes,out_sizes", FUSED_CASES[:2])
def test_spectral_corners_grads_match_jax_vjp(layout, spatial, half_modes,
                                              out_sizes):
    """The gradients to x and to both stored weights through the kernel
    route on the CPU (the Function's backward: the adjoint entry for dx,
    the weight-gradient entry for dw) against `jax.vjp` of the JAX conv;
    float64, rtol 1e-8."""
    x, ws = fused_case(53, layout, spatial, half_modes)
    cot = np.random.default_rng(54).normal(
        size=(2, *(out_sizes or spatial), 4))
    _, vjp = jax.vjp(
        lambda x_, ws_: jfourier.spectral_conv_nd(
            x_, ws_, half_modes, fft_norm="ortho", output_sizes=out_sizes),
        jnp.asarray(x), [to_jax(w) for w in ws])
    gx_ref, gws_ref = vjp(jnp.asarray(cot))
    xt = t64(x).requires_grad_()
    leaves = [t64(w[layout]).requires_grad_() for w in ws]
    out = spectral_cuda.spectral_conv_2d_kernel(
        xt, [{layout: v} for v in leaves], half_modes, fft_norm="ortho",
        output_sizes=out_sizes)
    grads = torch.autograd.grad(out, [xt, *leaves], t64(cot))
    refs = [gx_ref, *(g[layout] for g in gws_ref)]
    for a, b in zip(grads, refs):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=1e-8 * np.abs(b).max())


@pytest.mark.parametrize("frozen", ["w", "x", "none", "x and low"])
def test_spectral_corners_backward_runs_what_is_asked(frozen, monkeypatch):
    """A frozen observer costs one adjoint pass per conv (dx) and no weight
    gradient; training adds one weight-gradient call per conv, for the
    corners whose weights ask for a gradient, and none of the strided
    contraction."""
    passes, dw_calls, strided = [], [], []
    real_corners, real_dw, real_contract = (
        spectral_cuda._corners, spectral_cuda._corner_dw,
        spectral_cuda._contract)
    monkeypatch.setattr(
        spectral_cuda, "_corners", lambda *a, adjoint=False:
        passes.append(adjoint) or real_corners(*a, adjoint=adjoint))
    monkeypatch.setattr(
        spectral_cuda, "_corner_dw",
        lambda *a: dw_calls.append(a[2:]) or real_dw(*a))
    monkeypatch.setattr(
        spectral_cuda, "_contract",
        lambda *a, **k: strided.append(k) or real_contract(*a, **k))
    x, ws = fused_case(55, "mm2", (8, 8), (3, 3))
    x_ft = torch.fft.rfftn(t64(x), dim=(1, 2))
    leaves = [t64(w["mm2"]) for w in ws]
    needs = {"w": [x_ft], "x": leaves, "none": [x_ft, *leaves],
             "x and low": leaves[1:]}[frozen]
    for a in needs:
        a.requires_grad_()
    out = spectral_cuda.spectral_corners(x_ft, [{"mm2": v} for v in leaves])
    assert passes == [False] and not dw_calls
    (out.real.sum() + (out.imag ** 2).sum()).backward()

    def needed(t):
        return any(a is t for a in needs)
    assert passes == ([False, True] if needed(x_ft) else [False])
    want = (needed(leaves[0]), needed(leaves[1]))
    assert dw_calls == ([] if frozen == "w" else [(3, 3, want)])
    assert not strided
    for a in (x_ft, *leaves):
        assert (a.grad is not None) == needed(a)


def test_spectral_corners_reads_the_weights_where_they_are_stored():
    """The views handed to the kernel share the leaves' storage (mode-major,
    legacy, and mode-sliced weights alike), so there is no copy and no
    cache: an in-place weight update shows in the next call."""
    x, ws = fused_case(56, "mm2", (12, 10), (4, 3))
    tws = [to_torch(w) for w in ws]
    for w, v in zip(tws, spectral_cuda._dense_views(tws)):
        assert v.data_ptr() == w["mm2"].data_ptr() and v.shape == (2, 4, 3,
                                                                   3, 4)
    _, legacy = fused_case(56, "tensor", (12, 10), (4, 3))
    tl = [to_torch(w) for w in legacy]
    for w, v in zip(tl, spectral_cuda._dense_views(tl)):
        assert v.data_ptr() == w["tensor"].data_ptr()
        assert v.shape == (2, 4, 3, 3, 4) and not v.is_contiguous()
    sliced = [fourier.slice_weight_modes(w, (2, 2)) for w in tws]
    for w, v in zip(tws, spectral_cuda._dense_views(sliced)):
        assert v.data_ptr() == w["mm2"].data_ptr() and v.shape[1:3] == (2, 2)
    x_ft = torch.fft.rfftn(t64(x), dim=(1, 2))
    before = spectral_cuda.spectral_corners(x_ft, tws)
    with torch.no_grad():
        tws[0]["mm2"].mul_(2.0)
    after = spectral_cuda.spectral_corners(x_ft, tws)
    np.testing.assert_allclose(after[:, :4, :3].numpy(),
                               2.0 * before[:, :4, :3].numpy(), rtol=1e-14)
    np.testing.assert_array_equal(after[:, -4:].numpy(),
                                  before[:, -4:].numpy())
    with pytest.raises(ValueError, match="of one shape"):
        spectral_cuda.spectral_corners(x_ft, [tws[0], sliced[1]])


def test_spectral_corners_kernel_takes_cuda_complex64_only():
    x, ws = fused_case(57, "mm2", (8, 8), (3, 3))
    x_ft = torch.fft.rfftn(torch.as_tensor(x, dtype=torch.float32),
                           dim=(1, 2))
    views = spectral_cuda._dense_views([to_torch(w, torch.float32)
                                        for w in ws])
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        spectral_cuda.spectral_corners_kernel(x_ft, *views)
    with pytest.raises(ValueError, match="float32 CUDA tensors"):
        spectral_cuda.spectral_corners_kernel(
            x_ft.to(torch.complex128), *(v.double() for v in views))
    with pytest.raises(RuntimeError, match="passes no gradient"):
        spectral_cuda.spectral_corners_kernel(
            x_ft.clone().requires_grad_(), *views)
    with pytest.raises(RuntimeError, match="passes no gradient"):
        spectral_cuda.spectral_corners_kernel(
            x_ft, views[0].clone().requires_grad_(), views[1])
    assert spectral_cuda.spectral_corners_kernel.launches == 0

    # the shape checks and the struct of one call signature (a pure function)
    def plan(x, lo, hi, adjoint=False):
        return spectral_cuda._spectral_plan(x.shape, lo.shape, hi.shape,
                                            lo.stride(), hi.stride(), adjoint)
    d, _, out_shape = plan(x_ft, *views)
    assert out_shape == (2, 8, 5, 4)
    assert (d.B, d.H, d.Wh, d.I, d.O, d.m1, d.m2) == (2, 8, 5, 3, 4, 3, 3)
    assert list(d.ws[0]) == list(views[0].stride()[1:]) and d.sgn_wi == 1.0
    # the adjoint reads the same leaves with the channel strides swapped
    d_ft = torch.zeros(out_shape, dtype=torch.complex64)
    d, _, back_shape = plan(d_ft, *views, adjoint=True)
    assert back_shape == tuple(x_ft.shape) and (d.I, d.O) == (4, 3)
    s = views[1].stride()
    assert list(d.ws[1]) == [s[1], s[2], s[4], s[3]] and d.sgn_wi == -1.0
    with pytest.raises(ValueError, match="expected"):
        plan(x_ft[0], *views)
    with pytest.raises(ValueError, match="expected"):
        plan(x_ft, views[0], views[1][:, :2])
    with pytest.raises(ValueError, match="expected"):
        plan(x_ft, *views, adjoint=True)              # 3 channels, not 4
    with pytest.raises(ValueError, match="expected"):
        plan(x_ft[:, :5], *views)                     # 2 * m1 > H


# ---------------------------------------------------------------------------
# factorized weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("factorization", ["dense", "tucker", "cp", "tt"])
def test_to_dense_and_take_layer_match_jax(factorization):
    rng = np.random.default_rng(30)
    w = numpy_weight(rng, (4, 3, 5, 4, 3), factorization, n_lead=3)
    np.testing.assert_allclose(fz.to_dense(to_torch(w)).numpy(),
                               np.asarray(jfz.to_dense(to_jax(w))),
                               rtol=1e-12, atol=1e-12)
    assert fz.factorization_of(to_torch(w)) == factorization
    for index in (0, 3):
        ours = fz.take_layer(to_torch(w), index)
        ref = jfz.take_layer(to_jax(w), index)
        assert sorted(ours) == sorted(ref)
        np.testing.assert_allclose(fz.to_dense(ours).numpy(),
                                   np.asarray(jfz.to_dense(ref)),
                                   rtol=1e-12, atol=1e-12)


def test_legacy_dense_layout():
    rng = np.random.default_rng(31)
    w = numpy_weight(rng, (3, 4, 5, 2), "dense", n_lead=0)
    assert list(w) == ["tensor"]
    np.testing.assert_allclose(fz.to_dense(to_torch(w)).numpy(),
                               np.asarray(jfz.to_dense(to_jax(w))))
    layer = fz.take_layer(to_torch(w), 1)
    np.testing.assert_allclose(
        fz.to_dense(layer).numpy(),
        np.asarray(jfz.to_dense(jfz.take_layer(to_jax(w), 1))))


@pytest.mark.parametrize("factorization", ["dense", "tucker", "cp", "tt"])
def test_init_factorized_structure_and_scale(factorization):
    """Same keys and leaf shapes as the JAX init, drawn from a seeded
    generator (same seed, same weights), with the dense std requested."""
    shape = (6, 5, 4, 3)
    ref = jfz.init_factorized(jax.random.PRNGKey(0), shape, factorization,
                              rank=0.5, std=0.1)
    gen = torch.Generator().manual_seed(3)
    ours = fz.init_factorized(gen, shape, factorization, rank=0.5, std=0.1)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, list):
            assert [tuple(a.shape) for a in ours[k]] == [a.shape for a in v]
        else:
            assert tuple(ours[k].shape) == v.shape
    again = fz.init_factorized(torch.Generator().manual_seed(3), shape,
                               factorization, rank=0.5, std=0.1)
    np.testing.assert_array_equal(fz.to_dense(ours).numpy(),
                                  fz.to_dense(again).numpy())
    assert fz.n_params(ours) == jfz.n_params(ref)
    if factorization == "dense":
        big = fz.init_factorized(gen, (16, 16, 8, 8), std=0.1)
        assert abs(float(fz.to_dense(big).abs().pow(2).mean().sqrt()) - 0.1
                   ) < 5e-3


def test_rank_helpers_match_jax():
    shape = (8, 6, 5, 4)
    for rank in (0.5, 0.1, 3, (2, 3, 2, 2)):
        assert fz.tucker_rank(shape, rank) == jfz.tucker_rank(shape, rank)
    for rank in (0.5, 0.1, 3):
        assert fz.cp_rank(shape, rank) == jfz.cp_rank(shape, rank)
        assert fz.tt_rank(shape, rank) == jfz.tt_rank(shape, rank)
    assert fz.n_dense_params(shape) == jfz.n_dense_params(shape)
    with pytest.raises(ValueError, match="Unknown factorization"):
        fz.init_factorized(None, shape, "svd", device="cpu")


# ---------------------------------------------------------------------------
# normalizers, padding, resampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unit", "given", "gaussian", "range",
                                  "identity"])
def test_normalizers_match_jax(kind):
    """Population statistics (jnp.std), eps, and encode/decode; 1e-12."""
    rng = np.random.default_rng(40)
    data = rng.normal(size=(7, 5, 4)) * 3 + 1
    x = rng.normal(size=(3, 5, 4))
    if kind == "unit":
        ref = jnorm.UnitGaussianNormalizer.fit(jnp.asarray(data))
        ours = normalization.UnitGaussianNormalizer.fit(t64(data))
    elif kind == "given":
        mean, std = data.mean(0), data.std(0)
        ref = jnorm.NormalizerGivenMeanStd(jnp.asarray(mean),
                                           jnp.asarray(std))
        ours = normalization.NormalizerGivenMeanStd(t64(mean), t64(std))
    elif kind == "gaussian":
        ref = jnorm.GaussianNormalizer.fit(jnp.asarray(data))
        ours = normalization.GaussianNormalizer.fit(t64(data))
    elif kind == "range":
        ref = jnorm.RangeNormalizer.fit(jnp.asarray(data), -1.0, 2.0)
        ours = normalization.RangeNormalizer.fit(t64(data), -1.0, 2.0)
    else:
        ref, ours = jnorm.IdentityNormalizer(), \
            normalization.IdentityNormalizer()
    if kind in ("unit", "given", "gaussian"):
        assert ours.eps == ref.eps
    ours = ours.to("cpu", torch.float64)
    enc = ours.encode(t64(x))
    np.testing.assert_allclose(enc.numpy(),
                               np.asarray(ref.encode(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.decode(enc).numpy(),
                               np.asarray(ref.decode(ref.encode(
                                   jnp.asarray(x)))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mode", ["one-sided", "symmetric"])
def test_domain_padding_matches_jax(mode):
    rng = np.random.default_rng(41)
    x = rng.normal(size=(2, 10, 8, 3))
    ref = jpadding.pad_domain(jnp.asarray(x), [0.2, 0.25], mode)
    out = padding.pad_domain(t64(x), [0.2, 0.25], mode)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = padding.unpad_domain(out, [0.2, 0.25], mode)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        padding.unpad_domain(out, 0.2, mode, 1.0).numpy(),
        np.asarray(jpadding.unpad_domain(ref, 0.2, mode, 1.0)))
    with pytest.raises(ValueError, match="padding mode"):
        padding.pad_domain(t64(x), 0.1, "reflect")


@pytest.mark.parametrize("shape,scale,axes", [
    ((2, 10, 3), 2.0, 1), ((2, 10, 3), 0.5, 1),           # linear
    ((2, 8, 6, 3), 2.0, None), ((2, 8, 6, 3), 0.5, None),  # cubic
    ((2, 9, 6, 3), [1.5, 1.0], [1, 2]),
    ((1, 6, 4, 8, 2), 2.0, None), ((1, 6, 4, 8, 2), 0.5, None)])  # spectral
def test_resample_matches_jax(shape, scale, axes):
    rng = np.random.default_rng(42)
    x = rng.normal(size=shape)
    ref = jresample.resample(jnp.asarray(x), scale, axes)
    out = resample.resample(t64(x), scale, axes)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_iterative_resample_matches_jax(scale):
    rng = np.random.default_rng(43)
    x = rng.normal(size=(2, 8, 6, 3))
    ref = jresample.iterative_resample(jnp.asarray(x), scale, [1, 2])
    out = resample.iterative_resample(t64(x), scale, [1, 2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-10)
