"""Fast-diagonalization (FDM) Poisson solves as dense matmuls.

The pressure-correction operator of this framework is separable: the
obstacle is handled entirely through the velocity masks
(predictor/corrector/divergence; the reference's Jacobi likewise never
special-cases obstacle cells, model.rs:733-824), so on the interior
unknowns A = Ty (x) I + I (x) Tx with Tx, Ty one-dimensional folded
Laplacians (Neumann mirror folds from the p' boundary slaving,
model.rs:807-815, plus the Dirichlet-0 outlet ghost). A separable
operator diagonalizes as A = (Qy (x) Qx) L (Qy (x) Qx)^T, so the EXACT
solve is two small dense matmuls per side plus an elementwise scale:

    e = -Qy @ ((Qy^T r Qx) * S) @ Qx^T,   S = 1/(ly + lx)

This is a direct solver shaped for matrix units: the eigenbases are
trace-time constants (f64 numpy eigh, cast to the operand's dtype) and
the apply is pure matmul work in ONE fused dispatch -- no iteration, no halo exchanges, no
per-sweep latency. Used as the exact coarse solve of the aligned
MG_PRODUCTION hierarchy (ops.poisson) and as a standalone projection
solver (PressureSolver.FDM).

Sign convention: the package's residual is r = rhs - A p with
A = +Laplacian (ops.poisson._mg_residual); the 1-D matrices built here
are the positive-definite -Laplacian (so eigh applies), hence the
leading minus in the apply.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax


def _t1d(m: int, h: float, right_dirichlet: bool,
         d_wall: float) -> np.ndarray:
    """1-D folded -Laplacian (positive semi-definite, symmetric).

    Left end is always a Neumann mirror fold (ghost = first cell: the
    p' row/column copies of model.rs:807-815). ``right_dirichlet``
    couples the last cell to a 0-valued ghost at distance ``d_wall``
    in the symmetric FV flux form: diag(last) = (1 + h/d)/h^2. At the
    finest level d = h reproduces the reference stencil exactly; the
    aligned-MG coarse levels pass the tracked center-to-wall distance.

    The end folds COMPOSE (each subtracts/replaces its own coupling)
    rather than overwrite the diagonal, so m = 1 -- reachable via the
    saturated short axis of extreme-aspect aligned hierarchies -- gets
    the correct h/d (Dirichlet) / 0 (all-Neumann) operator; a direct
    diag write of 1 + h/d at m = 1 would clobber the left Neumann fold
    (round-2 review: the 'exact' bottom solve then removes only ~half
    the residual on (N, 1) levels).
    """
    T = np.zeros((m, m), np.float64)
    for i in range(m):
        T[i, i] = 2.0
        if i > 0:
            T[i, i - 1] = -1.0
        if i < m - 1:
            T[i, i + 1] = -1.0
    T[0, 0] -= 1.0                    # left Neumann: west coupling folds out
    if right_dirichlet:
        T[m - 1, m - 1] += h / d_wall - 1.0  # east coupling -> wall flux
    else:
        T[m - 1, m - 1] -= 1.0        # right Neumann mirror
    return T / (h * h)


@lru_cache(maxsize=64)
def _fdm_constants(my: int, mx: int, dy: float, dx: float,
                   east_dirichlet: bool, d_wall: float
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(Qy, Qx, S) as float64 numpy, cached per geometry. Only the
    d != h folded operator routes here (the aligned-MG coarse bottom);
    it is always east-Dirichlet -- the all-Neumann cavity operator has
    no distance-dependent fold and always takes the closed-form DCT
    path in fdm_solve_interior. Sizes are bounded by the max-side stop
    rule of ops.poisson._cc_vcycle, so these O(m^2) constants stay a
    few tens of KB of the compiled program."""
    assert east_dirichlet, "d != h fold is east-Dirichlet only"
    Ty = _t1d(my, dy, False, 0.0)
    Tx = _t1d(mx, dx, True, d_wall)
    ly, Qy = np.linalg.eigh(Ty)
    lx, Qx = np.linalg.eigh(Tx)
    S = 1.0 / (ly[:, None] + lx[None, :])
    return Qy, Qx, S


def _mulmod_i32(a, b, period: int):
    """(a * b) % period without int32 overflow, via an 8-bit limb
    split of b: the largest intermediate is a * (b // 256) <
    period^2 / 256, exact in int32 for period <= ~741k (sides up to
    ~92k cells, far past HBM limits). The naive product (2m-1)^2
    overflows int32 from m = 23171 (Dirichlet) / m = 32768 (Neumann),
    silently corrupting the basis residues. Bitwise-identical results
    below those sizes (plain modular arithmetic identity)."""
    a = a % period
    b = b % period
    return ((a * (b // 256) % period) * 256 + a * (b % 256)) % period


def _dct_basis(m: int, dirichlet_right: bool, dtype=jnp.float32):
    """Closed-form orthonormal eigenbasis of the d = h folded 1-D
    operator, built IN-GRAPH from iota (no host constants: O(N^2)
    baked arrays would bloat the compiled program).

    Neumann-Neumann (T[0,0] = T[m-1,m-1] = 1): DCT-II vectors
    v_k[i] = cos(pi k (2i+1) / (2m)), lambda_k = 2 - 2 cos(pi k / m).
    Neumann-Dirichlet (T[m-1,m-1] = 2, 0-ghost at distance h):
    v_k[i] = cos(pi (2k+1)(2i+1) / (2(2m+1))),
    lambda_k = 2 - 2 cos(pi (2k+1) / (2m+1))  (the ghost lands exactly
    on a cosine zero: theta_k (m+1/2) = pi (2k+1)/2).

    The cosine argument's integer numerator is reduced mod the period
    in INT arithmetic first, so f32 cos never sees arguments beyond
    2 pi (large-angle f32 cos loses ~1e-3 at m ~ 2000). Columns are
    normalized numerically (exact orthogonality is structural).
    Returns (Q, lam) in ``dtype`` with lam ascending (lam[0] = 0 for
    the singular Neumann-Neumann operator)."""
    i = lax.iota(jnp.int32, m)
    k = lax.iota(jnp.int32, m)
    # Eigenvalues as 4 sin^2(theta/2), NOT 2 - 2 cos(theta): the cos
    # form cancels catastrophically for low modes at large m (at
    # interior width 8190 the lowest Dirichlet eigenvalue rounds to
    # exactly 0 in f32 -> S = inf -> NaN fields; at 4094 the smooth
    # modes carry O(1) relative error). sin(theta/2) of a small angle
    # is fully accurate in f32, so lam keeps full RELATIVE precision
    # at every mode (and the Neumann lam[0] stays exactly 0 for the
    # gauge).
    if dirichlet_right:
        period = 2 * (4 * m + 2)
        numer = _mulmod_i32(2 * i[:, None] + 1, 2 * k[None, :] + 1,
                            period)
        ang = jnp.asarray(np.pi / (4 * m + 2), dtype) * numer.astype(dtype)
        half = (jnp.asarray(np.pi / (2 * (2 * m + 1)), dtype)
                * (2 * k + 1).astype(dtype))
    else:
        period = 4 * m
        numer = _mulmod_i32(2 * i[:, None] + 1, k[None, :], period)
        ang = jnp.asarray(np.pi / (2 * m), dtype) * numer.astype(dtype)
        half = jnp.asarray(np.pi / (2 * m), dtype) * k.astype(dtype)
    s = jnp.sin(half)
    lam = 4.0 * s * s
    Q = jnp.cos(ang)
    Q = Q / jnp.sqrt(jnp.sum(Q * Q, axis=0, keepdims=True))
    return Q, lam


def fdm_solve_interior(r: jnp.ndarray, dx: float, dy: float,
                       east_dirichlet: bool, d_wall: float) -> jnp.ndarray:
    """Exact solve A e = r of the folded interior operator (+Laplacian
    convention). ``r`` is an interior-unknown array (my, mx); batch
    dims vmap transparently (the matmuls batch).

    d_wall == dx (the fine-level operator) takes the closed-form DCT
    bases from iota -- O(1) HLO bytes at any size; the
    coarse-level folds (d != h, no closed form) take the numpy-eigh
    constants, which are tiny there (<= mgp_coarse_stop per side).
    Works in ``r.dtype``: float32 in the solver, float64 for references."""
    my, mx = r.shape[-2], r.shape[-1]
    dt = r.dtype
    # Full f32 products: TF32 (Precision.HIGH on the GPU) leaves a
    # residual ~3e3 eps of scale at 2048^2, far above the noise floor.
    hp = lax.Precision.HIGHEST
    if float(d_wall) == float(dx) or not east_dirichlet:
        Qy, ly = _dct_basis(my, False, dt)
        Qx, lx_ = _dct_basis(mx, bool(east_dirichlet), dt)
        L = (ly[:, None] / jnp.asarray(dy * dy, dt)
             + lx_[None, :] / jnp.asarray(dx * dx, dt))
        if east_dirichlet:
            S = 1.0 / L
        else:
            S = jnp.where(L == 0.0, 0.0, 1.0 / jnp.where(L == 0.0, 1.0, L))
            # lam is ascending per axis, so the exact zero sits at
            # (0, 0); rounding keeps it exactly 0 (cos(0) terms).
    else:
        Qy_, Qx_, S_ = _fdm_constants(my, mx, float(dy), float(dx),
                                      bool(east_dirichlet), float(d_wall))
        Qy, Qx, S = (jnp.asarray(a.astype(dt)) for a in (Qy_, Qx_, S_))
    t = jnp.matmul(Qy.T, jnp.matmul(r, Qx, precision=hp), precision=hp)
    t = t * S
    e = jnp.matmul(Qy, jnp.matmul(t, Qx.T, precision=hp), precision=hp)
    return -e
