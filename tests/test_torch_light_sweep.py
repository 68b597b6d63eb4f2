"""The light sweep's scan (kernels/light_sweep.py) on the CPU: its tap
tables against the dense shear matrices of ops/resample.py, its plain
version against the dense-matmul loop it replaces, and the plain adjoint
against autograd. The file imports no JAX; tests/test_torch_lighting.py
holds the whole light volume to the JAX package, and tests/test_torch_gpu.py
holds the CUDA kernel to the plain version on the card.
"""
import numpy as np
import pytest
import torch

import volumetricrenderer_tpu_torch as T
from volumetricrenderer_tpu_torch.kernels import light_sweep as ls
from volumetricrenderer_tpu_torch.ops.lighting import light_sweep_geometry
from volumetricrenderer_tpu_torch.ops.resample import linear_resample_matrix

torch.set_num_threads(1)

CONFIG4 = (0.5, 0.5, 1.0)  # LightConfig's default, config 4's light
# All three dominant axes, both signs.
DIRECTIONS = [CONFIG4, (0.3, -0.2, -1.0), (1.0, 0.3, 0.2),
              (-1.0, 0.25, -0.4), (0.2, 1.0, 0.3), (0.4, -1.0, -0.1)]
OBLIQUE = [(0.3, -0.7, 1.0), (1.0, 0.45, -0.2), (-0.35, -1.0, 0.8)]
CUBE = (16, 16, 16)
# Not a cube: along each sweep axis that is not the longest one, the
# in-plane shift of a slice step is more than one texel.
LONG = (6, 40, 11)


def _geometry(direction, shape, density=8.0):
    medium = T.MediumConfig(combine="single", density=density)
    perm, sweep = light_sweep_geometry(T.LightConfig(direction=direction),
                                       T.RenderConfig(), medium, shape)
    return tuple(shape[p] for p in perm), sweep


def _matrix(n, shift):
    """The dense shear the light sweep multiplied by before the tables."""
    x01 = (torch.arange(n, dtype=torch.float32) + 0.5) / n + shift
    return linear_resample_matrix(x01, n, "zero", zero_outside=True)


def _dense(table, n):
    idx, w = table[:2]
    out = torch.zeros((n, n), dtype=torch.float32)
    rows = torch.arange(n)[:, None].expand_as(idx)
    return out.index_put_((rows.reshape(-1), idx.long().reshape(-1)),
                          w.reshape(-1), accumulate=True)


def dense_loop(sigma, sweep):
    """The light sweep as it ran before the tap tables: S - 1 steps of two
    dense matrix products."""
    S, A, B = sigma.shape
    Wa, WbT = _matrix(A, sweep.shift_a), _matrix(B, sweep.shift_b).T
    order = list(range(S - 1, -1, -1) if sweep.sign > 0 else range(S))
    slices = sigma.unbind(0)
    tau = torch.zeros((A, B), dtype=torch.float32)
    taus = [None] * S
    taus[order[0]] = tau
    for k_prev, k in zip(order, order[1:]):
        tau = Wa @ (tau + slices[k_prev] * sweep.dl) @ WbT
        taus[k] = tau
    return torch.exp(-sweep.density * torch.stack(taus))


def _sigma(shape, seed=0, lo=0.0, hi=1.6):
    return torch.tensor(np.random.default_rng(seed).uniform(lo, hi, shape),
                        dtype=torch.float32)


def _cases():
    return [(d, s) for s in (CUBE, LONG) for d in DIRECTIONS]


@pytest.mark.parametrize("direction,shape", _cases())
def test_tap_tables_are_the_shear_matrices_rows(direction, shape):
    """Each table row holds its matrix row's non-zeros, weight for weight:
    rebuilt dense, the table equals the matrix bit for bit; the transposed
    table equals the matrix's transpose."""
    (_, A, B), sweep = _geometry(direction, shape)
    for n, shift in ((A, sweep.shift_a), (B, sweep.shift_b)):
        want = _matrix(n, shift)
        idx, w, reach = ls.shear_taps(n, shift, torch.device("cpu"))
        assert idx.dtype == torch.int32 and w.dtype == torch.float32
        assert tuple(idx.shape) == tuple(w.shape) == (n, 2)
        assert torch.equal(_dense((idx, w), n), want)
        assert reach <= abs(shift) * n + 2
        tidx, tw, treach = ls.shear_taps(n, shift, torch.device("cpu"), True)
        assert tidx.shape[1] <= ls.MAX_TAPS
        assert torch.equal(_dense((tidx, tw), n), want.T.contiguous())
        assert treach <= abs(shift) * n + 2


@pytest.mark.parametrize("direction,shape,none", [
    (CONFIG4, CUBE, False), (DIRECTIONS[3], CUBE, False),
    (CONFIG4, LONG, True), (OBLIQUE[1], LONG, True)])
def test_tap_tables_edge_rows(direction, shape, none):
    """An edge row keeps its one in-box tap. On the cube the shifts are
    sub-texel and every row has a tap in the box; on the long grid the
    shift spans several texels and rows whose position leaves the box
    weigh nothing. Counted over both axes."""
    (S, A, B), sweep = _geometry(direction, shape)
    texels = max(abs(sweep.shift_a) * A, abs(sweep.shift_b) * B)
    assert (texels > 1.0) == none
    counts = []
    for n, shift in ((A, sweep.shift_a), (B, sweep.shift_b)):
        w = ls.shear_taps(n, shift, torch.device("cpu")).w
        counts.append((w != 0).sum(1))
    nz = torch.cat(counts)
    assert int((nz == 1).sum()) >= 1
    assert (int((nz == 0).sum()) >= 1) == none


@pytest.mark.parametrize("size", [32, 64])
def test_plain_version_equals_dense_loop_at_config4(size):
    """At config 4's light every weight is exactly 0.5, so the two-tap sum
    rounds like the matrix products: equal bit for bit, on the FBM cloud
    at config 4's density and sample scale."""
    grid = T.cloud_volume(size, 7, device="cpu")
    sigma = grid * 0.2
    (S, A, B), sweep = _geometry(CONFIG4, tuple(sigma.shape))
    for n, shift in ((A, sweep.shift_a), (B, sweep.shift_b)):
        w = ls.shear_taps(n, shift, torch.device("cpu")).w
        assert set(w[w != 0].tolist()) == {0.5}
    got = ls.light_sweep_reference(sigma, sweep)
    want = dense_loop(sigma, sweep)
    assert torch.equal(got, want)
    assert float(got.min()) < 0.5 and float(got.max()) == 1.0


@pytest.mark.parametrize("direction,shape",
                         [(d, CUBE) for d in OBLIQUE] + [(OBLIQUE[0], LONG)])
def test_plain_version_near_dense_loop_oblique(direction, shape):
    """Elsewhere the two sum the same exact taps in another order: within
    1e-7 relative L2."""
    swept, sweep = _geometry(direction, shape)
    sigma = _sigma(swept, 1)
    got = ls.light_sweep_reference(sigma, sweep)
    want = dense_loop(sigma, sweep)
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= 1e-7
    assert float(got.min()) < 0.5


@pytest.mark.parametrize("direction", [CONFIG4, DIRECTIONS[3], OBLIQUE[2]])
def test_plain_version_gradcheck(direction):
    (S, A, B), sweep = _geometry(direction, (4, 5, 6), density=1.5)
    sigma = _sigma((S, A, B), 2, 0.1, 1.0).double().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda s: ls.light_sweep_reference(s, sweep), (sigma,))


@pytest.mark.parametrize("direction,shape", [(CONFIG4, CUBE),
                                             (DIRECTIONS[1], CUBE),
                                             (DIRECTIONS[4], LONG),
                                             (OBLIQUE[1], LONG)])
def test_adjoint_plain_version_matches_autograd(direction, shape):
    """The adjoint kernel's plain version (reverse scan, transposed tables)
    against autograd through the forward's plain version, in float64."""
    (S, A, B), sweep = _geometry(direction, shape, density=3.0)
    sigma = _sigma((S, A, B), 3).double().requires_grad_()
    dL = torch.tensor(np.random.default_rng(4).normal(size=(S, A, B)))
    L = ls.light_sweep_reference(sigma, sweep)
    L.backward(dL)
    got = ls.light_sweep_adjoint_reference(L.detach(), dL, sweep)
    scale = float(sigma.grad.abs().max())
    assert scale > 0.0
    torch.testing.assert_close(got, sigma.grad, rtol=1e-10,
                               atol=1e-12 * scale)


def test_light_sweep_takes_the_plain_version_on_the_cpu():
    (S, A, B), sweep = _geometry(DIRECTIONS[2], CUBE)
    sigma = _sigma((S, A, B), 5)
    before = dict(ls.launches)
    assert torch.equal(ls.light_sweep(sigma, sweep),
                       ls.light_sweep_reference(sigma, sweep))
    assert ls.launches == before
    with pytest.raises(ValueError, match="needs CUDA"):
        ls.launch_kernel(sigma, sweep)
