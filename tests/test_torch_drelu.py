"""PyTorch port, D-ReLU and CBSR: values and indices equal to the JAX
package's, ties and all-zero rows included; the bisection kernel's plain
version bit-exact against ``drelu_pallas``, and so is the CUDA kernel's
formulation (the (k+1)-th largest value, then the steps as scalar
compares); the CUDA kernel is held against the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.cbsr import cbsr_from_dense as j_cbsr
from repro.core.drelu import drelu as j_drelu
from repro.kernels.drelu_topk import drelu_pallas
from repro_torch.core.cbsr import cbsr_from_dense
from repro_torch.core.drelu import drelu
from repro_torch.kernels import drelu_topk
from _torch_port import drelu_rows


def _rows(seed, n=61, d=32):
    """Seeded rows plus the hard cases: all-zero rows, rows of one repeated
    value, rows with a tie straddling the threshold, negative rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[0] = 0.0
    x[1] = 0.5
    x[2, :12] = 1.25                       # 12-way tie at the top
    x[3] = np.round(x[3])                  # many small-integer ties
    x[4] = -np.abs(x[4]) - 1.0             # all negative
    x[5, ::2] = 0.0
    x[6] = 0.0
    x[6, 1::3] = -0.0                      # total order: -0.0 below +0.0
    return x


@pytest.mark.parametrize("k", [1, 8, 16, 31])
def test_cbsr_from_dense_matches(k):
    x = _rows(k)
    cj = j_cbsr(jnp.asarray(x), k)
    ct = cbsr_from_dense(torch.from_numpy(x), k)
    assert np.array_equal(np.asarray(cj.idx), ct.idx.numpy())
    assert ct.idx.dtype == torch.int32
    assert np.array_equal(np.asarray(cj.values), ct.values.numpy())
    assert np.array_equal(np.asarray(cj.to_dense()), ct.to_dense().numpy())


@pytest.mark.parametrize("k", [1, 8, 16, 31, 32])
def test_drelu_matches(k):
    x = _rows(100 + k)
    assert np.array_equal(np.asarray(j_drelu(jnp.asarray(x), k)),
                          drelu(torch.from_numpy(x), k).numpy())


def test_drelu_straight_through_grad():
    x = torch.from_numpy(_rows(3)).requires_grad_()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    drelu(x, 8).backward(g)
    keep = x.detach() >= torch.topk(x.detach(), 8).values[:, -1:]
    assert torch.equal(x.grad, torch.where(keep, g, torch.zeros_like(g)))


@pytest.mark.parametrize("k", [1, 8, 16, 31])
def test_drelu_bisect_plain_matches_pallas(k):
    """The plain bisection is the TPU kernel's arithmetic step for step, so
    the two agree bit for bit (Pallas interpret mode on the CPU)."""
    x = _rows(200 + k, n=45)
    ref = np.asarray(drelu_pallas(jnp.asarray(x), k))
    out = drelu_topk.drelu_bisect(torch.from_numpy(x), k).numpy()
    assert np.array_equal(ref, out)


def test_drelu_bisect_wide_k_is_identity():
    x = torch.from_numpy(_rows(5))
    assert drelu_topk.drelu_bisect(x, 32) is x


def _select_then_bisect(x, k):
    """The CUDA kernel's formulation in plain PyTorch: t, the (k+1)-th
    largest value of each row (duplicates kept), found exactly, then the
    64 steps as scalar compares ``mid <= t`` from the row's min and max.
    ``count(x >= mid) > k`` holds exactly when ``mid <= t``."""
    t = torch.sort(x, dim=1, descending=True).values[:, k]
    lo = x.min(dim=1).values
    hi = x.max(dim=1).values
    for _ in range(drelu_topk.N_ITERS):
        mid = 0.5 * (lo + hi)
        up = mid <= t
        lo = torch.where(up, mid, lo)
        hi = torch.where(up, hi, mid)
    return torch.where(x >= hi[:, None], x, torch.zeros_like(x))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("d,k", sorted({
    (d, k) for d in (1, 3, 32, 33, 64, 96, 256)
    for k in (1, d // 4, d - 1) if k < d}))
def test_drelu_select_then_bisect_bit_exact(d, k):
    """Bit for bit (the sign of a zero included) against the plain
    bisection and the Pallas kernel, on rows with ties at the threshold,
    one value, zeros, -0.0, +-inf (a NaN mid), ReLU'd rows."""
    x = drelu_rows(45, d, seed=1000 * d + k)
    xt = torch.from_numpy(x)
    out = _select_then_bisect(xt, k)
    assert np.array_equal(_bits(out), _bits(drelu_topk.drelu_bisect_plain(
        xt, k)))
    assert np.array_equal(_bits(out), _bits(drelu_pallas(jnp.asarray(x), k)))
