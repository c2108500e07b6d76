"""Direct linear solvers: host sparse LU and on-device dense LU.

The reference funnels every linear solve through MUMPS
(ref: src/flowcontrol/flowsolver.py:812-814). Here:

- ``HostSparseLU``: scipy splu (f64) — setup-time solves (steady state,
  operator work) where a one-time CPU factorization is the right tool.
- ``DeviceDenseLU``: dense LU on the accelerator via jax lu_factor. For
  small/medium meshes the factors live in device memory and the per-step back-solve is
  two triangular solves; with batched RHS (vmapped rollouts) the factor read
  is amortized across the batch — the dense-matmul regime.

Both present ``solve(b)`` with leading batch dims supported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax
import jax.numpy as jnp


class HostSparseLU:
    """scipy splu wrapper (setup-time, f64)."""

    def __init__(self, a_csr):
        self._lu = spla.splu(a_csr.tocsc())
        self.n = a_csr.shape[0]

    def solve(self, b: np.ndarray) -> np.ndarray:
        b = np.asarray(b, dtype=np.float64)
        if b.ndim == 1:
            return self._lu.solve(b)
        flat = b.reshape(-1, b.shape[-1])
        out = np.stack([self._lu.solve(x) for x in flat])
        return out.reshape(b.shape)


class DeviceDenseLU:
    """Dense LU factorization resident on the accelerator.

    Factors are computed once (jit) and stored as a pytree usable inside
    jitted step functions: ``solve`` is pure and traceable.
    """

    def __init__(self, a_dense, dtype=jnp.float32):
        a = jnp.asarray(a_dense, dtype=dtype)
        lu, piv = jax.scipy.linalg.lu_factor(a)
        self.lu = lu
        self.piv = piv
        self.n = a.shape[0]
        self.dtype = dtype

    def tree(self):
        return (self.lu, self.piv)

    def solve(self, b):
        return dense_lu_solve((self.lu, self.piv), b)


def dense_lu_solve(factors, b):
    """Solve with precomputed LU factors; b may have leading batch dims."""
    lu, piv = factors
    b = jnp.asarray(b, dtype=lu.dtype)
    if b.ndim == 1:
        return jax.scipy.linalg.lu_solve((lu, piv), b)
    # batched: (..., n) -> lu_solve wants (n, k)
    batch = b.shape[:-1]
    bt = b.reshape(-1, b.shape[-1]).T  # (n, k)
    xt = jax.scipy.linalg.lu_solve((lu, piv), bt)
    return xt.T.reshape(batch + (b.shape[-1],))


def dense_from_csr(a_csr, dtype=np.float64) -> np.ndarray:
    return np.asarray(a_csr.todense(), dtype=dtype)


class HostDenseLUOnDevice:
    """f64 factorization on HOST CPU, factors shipped to device at chosen dtype.

    Gives f64-accurate pivoting/factorization while keeping the per-step
    back-substitution on the accelerator (useful when f32 on-device
    factorization loses too much accuracy for stiff systems).
    """

    def __init__(self, a_dense: np.ndarray, device_dtype=jnp.float32):
        import scipy.linalg as sla

        lu, piv = sla.lu_factor(np.asarray(a_dense, dtype=np.float64))
        self.lu = jnp.asarray(lu, dtype=device_dtype)
        self.piv = jnp.asarray(piv.astype(np.int32))
        self.n = a_dense.shape[0]
        self.dtype = device_dtype

    def tree(self):
        return (self.lu, self.piv)

    def solve(self, b):
        return dense_lu_solve((self.lu, self.piv), b)
