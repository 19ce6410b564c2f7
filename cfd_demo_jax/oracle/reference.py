"""Scalar NumPy oracle: the golden reference for the JAX solver.

This is an *independent* transcription of the reference discretization
(Rust model.rs / JS index.html) into plain scalar loops over float32
NumPy values (NEP-50 keeps every intermediate in float32, mirroring the
f32 arithmetic of both references and of the JAX path). It is
deliberately written in the reference's per-cell style -- NOT shared
with, or derived from, the vectorized ops in cfd_demo_jax.ops -- so a
transcription mistake in one implementation cannot hide in the other.
Golden tests assert per-field L2 agreement (tests/test_golden.py)
per BASELINE.json: L2 <= 1e-5 per step.

Clean-spec decisions (deviations from reference quirks) are shared with
the JAX path and documented in docs/SPEC.md:
  * predictor update regions: u faces i in [1,nx-1] x j in [1,ny-2],
    v faces i in [1,nx-2] x j in [1,ny-1] (no SIMD-tail overshoot).
  * u*/v* are re-seeded from u/v at the start of every substep
    (JS semantics; Rust's stale-buffer boundary values not reproduced).
  * Jacobi max-error includes the full interior (Rust skips its scalar
    tail chunk, model.rs:757-770).
  * SOR is red/black (JS lexicographic is sequential).
  * JS second-order/QUICK v-Laplacian typo (index.html:641) fixed.
  * JS extrapolation no-op bug fixed (u_prev = previous converged field).
"""
from __future__ import annotations

import numpy as np

from ..core.config import (FlowCase, Grid, InletProfile, PressureSolver,
                           Semantics, SimulationParams, SolverOptions,
                           VelocityScheme)
from ..core.masks import build_masks

F = np.float32


class NumpyModel:
    """Mutable scalar-loop model mirroring Rust `Model` (model.rs:166)."""

    def __init__(self, grid: Grid, params: SimulationParams,
                 opts: SolverOptions):
        self.grid = grid
        self.params = params
        self.opts = opts
        ny, nx = grid.ny, grid.nx
        self.u = np.zeros((ny, nx + 1), F)
        self.v = np.zeros((ny + 1, nx), F)
        self.p = np.zeros((ny, nx), F)
        self.p_prime = np.zeros((ny, nx), F)
        self.u_prev = self.u.copy()
        self.v_prev = self.v.copy()
        mu, mv, mub, mvb = build_masks(grid, opts.semantics)
        # build_masks returns v masks in the implicit-top-row layout
        # (Grid.shape_v); the oracle keeps the reference's (ny+1, nx) v,
        # whose top row is identically zero, so the mask row is False.
        pad = np.zeros((1, nx), dtype=bool)
        self.mask_u = mu > 0
        self.mask_v = np.concatenate([mv > 0, pad], axis=0)
        self.mask_u_bc = mub > 0
        self.mask_v_bc = np.concatenate([mvb > 0, pad], axis=0)
        self.dt = F(params.dt)
        self.dt_user = F(params.dt)
        self.nu = F(params.viscosity)
        self.target_inlet = F(params.target_inlet_velocity)
        self.inlet = F(0.0)
        self.t = F(0.0)
        self.step = 0
        self.substeps = opts.substeps_init
        self.res_u = F(0.0)
        self.res_v = F(0.0)
        self.res_p = F(0.0)

    # ---------------- predictor ----------------

    def _predict(self, dt_sub: F):
        g = self.grid
        nx, ny = g.nx, g.ny
        dx, dy = F(g.dx), F(g.dy)
        u, v, nu = self.u, self.v, self.nu
        js = self.opts.semantics == Semantics.JS
        scheme = self.params.velocity_scheme
        u_star = u.copy()
        v_star = v.copy()

        for j in range(1, ny - 1):
            for i in range(1, nx):
                if self.mask_u[j, i]:
                    u_star[j, i] = F(0.0)
                    continue
                uC = u[j, i]
                uE = u[j, i + 1]
                uW = u[j, i - 1]
                uN = u[j + 1, i]
                uS = u[j - 1, i]
                v_ne = v[j + 1, i]
                v_nw = v[j + 1, i - 1]
                v_se = v[j, i]
                v_sw = v[j, i - 1]
                v_n_avg = 0.5 * (v_nw + v_ne)
                v_s_avg = 0.5 * (v_sw + v_se)
                v_n = v_n_avg if js else v_ne   # model.rs:1056 vs index.html:397
                v_s = v_s_avg if js else v_se

                if scheme == VelocityScheme.FIRST:
                    fe = uC if 0.5 * (uC + uE) >= 0 else uE
                    fw = uW if 0.5 * (uW + uC) >= 0 else uC
                    fn = uC if v_n >= 0 else uN
                    fs = uS if v_s >= 0 else uC
                elif scheme == VelocityScheme.SECOND:
                    if uC >= 0:
                        fe = 1.5 * uC - 0.5 * uW if i > 1 else uC
                    else:
                        fe = 1.5 * uE - 0.5 * u[j, i + 2] if i < nx - 1 else uE
                    if uW >= 0:
                        fw = 1.5 * uW - 0.5 * u[j, i - 2] if i > 2 else uW
                    else:
                        fw = 1.5 * uC - 0.5 * uE
                    if v_n_avg >= 0:
                        fn = 1.5 * uC - 0.5 * uS if j > 1 else uC
                    else:
                        fn = 1.5 * uN - 0.5 * u[j + 2, i] if j < ny - 2 else uN
                    if v_s_avg >= 0:
                        fs = 1.5 * uS - 0.5 * u[j - 2, i] if j > 1 else uS
                    else:
                        fs = 1.5 * uC - 0.5 * uN
                else:  # QUICK (index.html:471-549)
                    if uC >= 0:
                        fe = ((-uW + 6 * uC + 3 * uE) / 8 if i >= 2
                              else 1.5 * uC - 0.5 * uW)
                    else:
                        fe = ((3 * uC + 6 * uE - u[j, i + 2]) / 8 if i <= nx - 2
                              else uE)
                    if uW >= 0:
                        fw = ((-u[j, i - 2] + 6 * uW + 3 * uC) / 8 if i >= 3
                              else 1.5 * uW - 0.5 * uC)
                    else:
                        fw = (3 * uW + 6 * uC - uE) / 8
                    if v_n_avg >= 0:
                        fn = ((-uS + 6 * uC + 3 * uN) / 8 if j >= 2
                              else 1.5 * uC - 0.5 * uS)
                    else:
                        fn = ((3 * uC + 6 * uN - u[j + 2, i]) / 8 if j < ny - 2
                              else uN)
                    if v_s_avg >= 0:
                        fs = ((-u[j - 2, i] + 6 * uS + 3 * uC) / 8 if j >= 2
                              else 1.5 * uS - 0.5 * uC)
                    else:
                        fs = ((3 * uS + 6 * uC - uN) / 8 if j < ny - 1
                              else uC)

                conv = (fe * fe - fw * fw) / dx + (v_n * fn - v_s * fs) / dy
                lap = ((uE - 2.0 * uC + uW) / (dx * dx)
                       + (uN - 2.0 * uC + uS) / (dy * dy))
                u_star[j, i] = uC + dt_sub * (-conv + nu * lap)

        for j in range(1, ny):
            for i in range(1, nx - 1):
                if self.mask_v[j, i]:
                    v_star[j, i] = F(0.0)
                    continue
                vC = v[j, i]
                vE = v[j, i + 1]
                vW = v[j, i - 1]
                vN = v[j + 1, i]
                vS = v[j - 1, i]
                u_e = u[j, i + 1]
                u_w = u[j, i]
                n_avg = 0.5 * (vC + vN)
                s_avg = 0.5 * (vS + vC)

                if scheme == VelocityScheme.FIRST:
                    fe = vC if u_e >= 0 else vE
                    fw = vW if u_w >= 0 else vC
                    fn = vC if n_avg >= 0 else vN
                    fs = vS if s_avg >= 0 else vC
                elif scheme == VelocityScheme.SECOND:
                    if u_e >= 0:
                        fe = 1.5 * vC - 0.5 * vW if i > 0 else vC
                    else:
                        fe = 1.5 * vE - 0.5 * v[j, i + 2] if i < nx - 2 else vE
                    if u_w >= 0:
                        fw = 1.5 * vW - 0.5 * v[j, i - 2] if i > 1 else vW
                    else:
                        fw = 1.5 * vC - 0.5 * vE if i < nx - 1 else vC
                    if n_avg >= 0:
                        fn = 1.5 * vC - 0.5 * vS if j > 1 else vC
                    else:
                        fn = 1.5 * vN - 0.5 * v[j + 2, i] if j < ny - 1 else vN
                    if s_avg >= 0:
                        fs = 1.5 * vS - 0.5 * v[j - 2, i] if j > 1 else vS
                    else:
                        fs = 1.5 * vC - 0.5 * vN
                else:  # QUICK (index.html:643-723)
                    if u_e >= 0:
                        fe = ((-vW + 6 * vC + 3 * vE) / 8 if i >= 2
                              else 1.5 * vC - 0.5 * vW)
                    else:
                        fe = ((3 * vC + 6 * vE - v[j, i + 2]) / 8 if i < nx - 2
                              else vE)
                    if u_w >= 0:
                        fw = ((-v[j, i - 2] + 6 * vW + 3 * vC) / 8 if i >= 3
                              else 1.5 * vW - 0.5 * vC)
                    else:
                        fw = (3 * vW + 6 * vC - vE) / 8
                    if n_avg >= 0:
                        fn = ((-vS + 6 * vC + 3 * vN) / 8 if j >= 2
                              else 1.5 * vC - 0.5 * vS)
                    else:
                        fn = ((3 * vC + 6 * vN - v[j + 2, i]) / 8 if j < ny - 1
                              else vN)
                    if s_avg >= 0:
                        fs = ((-v[j - 2, i] + 6 * vS + 3 * vC) / 8 if j >= 2
                              else 1.5 * vS - 0.5 * vC)
                    else:
                        fs = ((3 * vS + 6 * vC - vN) / 8 if j < ny - 1
                              else vC)

                conv = (u_e * fe - u_w * fw) / dx + (fn * fn - fs * fs) / dy
                lap = ((vE - 2.0 * vC + vW) / (dx * dx)
                       + (vN - 2.0 * vC + vS) / (dy * dy))
                v_star[j, i] = vC + dt_sub * (-conv + nu * lap)

        return u_star, v_star

    # ---------------- pressure ----------------

    def _divergence_rhs(self, u_star, v_star, dt_sub):
        g = self.grid
        dx, dy = F(g.dx), F(g.dy)
        rhs = np.zeros((g.ny, g.nx), F)
        for j in range(g.ny):
            for i in range(g.nx):
                rhs[j, i] = ((u_star[j, i + 1] - u_star[j, i]) / dx
                             + (v_star[j + 1, i] - v_star[j, i]) / dy) / dt_sub
        return rhs

    def _pp_bcs(self, pp):
        pp[0, :] = pp[1, :]
        pp[-1, :] = pp[-2, :]
        pp[:, 0] = pp[:, 1]
        if self.params.flow_case == FlowCase.CHANNEL:
            pp[:, -1] = F(0.0)
        else:  # cavity: all-Neumann + pinned gauge cell
            pp[:, -1] = pp[:, -2]
            pp[0, 0] = F(0.0)

    def _jacobi(self, pp, rhs):
        g, opts = self.grid, self.opts
        nx, ny = g.nx, g.ny
        dx2 = F(g.dx) * F(g.dx)
        dy2 = F(g.dy) * F(g.dy)
        denom = 2.0 / dx2 + 2.0 / dy2
        omega = F(opts.jacobi_omega)
        max_error = F(0.0)
        for _ in range(opts.jacobi_iters):
            new = pp.copy()
            max_error = F(0.0)
            for j in range(1, ny - 1):
                for i in range(1, nx - 1):
                    upd = ((pp[j, i + 1] + pp[j, i - 1]) / dx2
                           + (pp[j + 1, i] + pp[j - 1, i]) / dy2
                           - rhs[j, i]) / denom
                    val = omega * upd + (1.0 - omega) * pp[j, i]
                    err = abs(val - pp[j, i])
                    if err > max_error:
                        max_error = err
                    new[j, i] = val
            pp = new
            self._pp_bcs(pp)
            if max_error < opts.jacobi_tol:
                break
        return pp, max_error

    def _sor_redblack(self, pp, rhs):
        g, opts = self.grid, self.opts
        nx, ny = g.nx, g.ny
        dx2 = F(g.dx) * F(g.dx)
        dy2 = F(g.dy) * F(g.dy)
        denom = 2.0 / dx2 + 2.0 / dy2
        omega = F(opts.sor_omega)
        max_error = F(0.0)
        for _ in range(opts.jacobi_iters):
            old = pp.copy()
            for parity in (0, 1):
                for j in range(1, ny - 1):
                    for i in range(1, nx - 1):
                        if (i + j) % 2 != parity:
                            continue
                        upd = ((pp[j, i + 1] + pp[j, i - 1]) / dx2
                               + (pp[j + 1, i] + pp[j - 1, i]) / dy2
                               - rhs[j, i]) / denom
                        pp[j, i] = (1.0 - omega) * pp[j, i] + omega * upd
            max_error = F(0.0)
            for j in range(1, ny - 1):
                for i in range(1, nx - 1):
                    err = abs(pp[j, i] - old[j, i])
                    if err > max_error:
                        max_error = err
            self._pp_bcs(pp)
            if max_error < opts.jacobi_tol:
                break
        return pp, max_error

    def _sor_lexicographic(self, pp, rhs):
        """JS-exact in-place lexicographic SOR (index.html:747-773):
        the sweep mutates pp in row-major order so each cell reads
        already-updated west/south neighbors; the per-cell |new - old|
        error accumulates DURING the sweep, before the post-sweep BCs.
        Inherently sequential -- this is the ordering the red/black
        redesign (docs/SPEC.md deviation 4) deviates from; it exists
        to MEASURE that deviation (tests/test_sor_ordering.py)."""
        g, opts = self.grid, self.opts
        nx, ny = g.nx, g.ny
        dx2 = F(g.dx) * F(g.dx)
        dy2 = F(g.dy) * F(g.dy)
        denom = 2.0 / dx2 + 2.0 / dy2
        omega = F(opts.sor_omega)
        max_error = F(0.0)
        for _ in range(opts.jacobi_iters):
            max_error = F(0.0)
            for j in range(1, ny - 1):
                for i in range(1, nx - 1):
                    p_old = pp[j, i]
                    upd = ((pp[j, i + 1] + pp[j, i - 1]) / dx2
                           + (pp[j + 1, i] + pp[j - 1, i]) / dy2
                           - rhs[j, i]) / denom
                    pp[j, i] = (1.0 - omega) * p_old + omega * upd
                    err = abs(pp[j, i] - p_old)
                    if err > max_error:
                        max_error = err
            self._pp_bcs(pp)
            if max_error < opts.jacobi_tol:
                break
        return pp, max_error

    # -- multigrid (scalar transcription of index.html:1344-1470) --

    def _mg_smooth(self, p, rhs, nx, ny, dx, dy, iters):
        denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
        for _ in range(iters):
            new = p.copy()
            for j in range(1, ny - 1):
                for i in range(1, nx - 1):
                    new[j, i] = ((p[j, i + 1] + p[j, i - 1]) / (dx * dx)
                                 + (p[j + 1, i] + p[j - 1, i]) / (dy * dy)
                                 - rhs[j, i]) / denom
            p[1:ny - 1, 1:nx - 1] = new[1:ny - 1, 1:nx - 1]
        return p

    def _mg_vcycle(self, p, rhs, nx, ny, dx, dy):
        opts = self.opts
        denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
        p = self._mg_smooth(p, rhs, nx, ny, dx, dy, opts.mg_pre_smooth)
        r = np.zeros((ny, nx), F)
        for j in range(1, ny - 1):
            for i in range(1, nx - 1):
                ap = ((p[j, i + 1] + p[j, i - 1]) / (dx * dx)
                      + (p[j + 1, i] + p[j - 1, i]) / (dy * dy)
                      - denom * p[j, i])
                r[j, i] = rhs[j, i] - ap
        if nx <= opts.mg_coarsest or ny <= opts.mg_coarsest:
            return self._mg_smooth(p, rhs, nx, ny, dx, dy,
                                   opts.mg_coarse_smooth)
        nx_c, ny_c = (nx + 1) // 2, (ny + 1) // 2
        rc = np.zeros((ny_c, nx_c), F)
        for j in range(1, ny_c - 1):
            for i in range(1, nx_c - 1):
                fi, fj = 2 * i, 2 * j
                rc[j, i] = (r[fj, fi]
                            + 0.5 * (r[fj, fi - 1] + r[fj, fi + 1]
                                     + r[fj - 1, fi] + r[fj + 1, fi])
                            + 0.25 * (r[fj - 1, fi - 1] + r[fj + 1, fi - 1]
                                      + r[fj - 1, fi + 1] + r[fj + 1, fi + 1])
                            ) / 4.0
        for i in range(nx_c):
            rc[0, i] = r[0, min(2 * i, nx - 1)]
            rc[ny_c - 1, i] = r[ny - 1, min(2 * i, nx - 1)]
        for j in range(ny_c):
            rc[j, 0] = r[min(2 * j, ny - 1), 0]
            rc[j, nx_c - 1] = r[min(2 * j, ny - 1), nx - 1]
        ec = np.zeros((ny_c, nx_c), F)
        ec = self._mg_vcycle(ec, rc, nx_c, ny_c, 2.0 * dx, 2.0 * dy)
        for j in range(ny):
            j0 = j // 2
            j1 = min(j0 + 1, ny_c - 1)
            b = F(0.5) if j % 2 else F(0.0)
            for i in range(nx):
                i0 = i // 2
                i1 = min(i0 + 1, nx_c - 1)
                a = F(0.5) if i % 2 else F(0.0)
                e = ((1.0 - a) * (1.0 - b) * ec[j0, i0]
                     + a * (1.0 - b) * ec[j0, i1]
                     + (1.0 - a) * b * ec[j1, i0]
                     + a * b * ec[j1, i1])
                p[j, i] = p[j, i] + e
        return self._mg_smooth(p, rhs, nx, ny, dx, dy, opts.mg_post_smooth)

    def _multigrid(self, pp, rhs):
        g, opts = self.grid, self.opts
        nx, ny = g.nx, g.ny
        dx, dy = F(g.dx), F(g.dy)
        pp = np.zeros((ny, nx), F)
        for _ in range(opts.mg_cycles):
            pp = self._mg_vcycle(pp, rhs, nx, ny, dx, dy)
        denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
        max_error = F(0.0)
        for j in range(1, ny - 1):
            for i in range(1, nx - 1):
                rr = ((pp[j, i + 1] + pp[j, i - 1]) / (dx * dx)
                      + (pp[j + 1, i] + pp[j - 1, i]) / (dy * dy)
                      - denom * pp[j, i] - rhs[j, i])
                if abs(rr) > max_error:
                    max_error = abs(rr)
        return pp, max_error

    def _solve_pressure(self, pp, rhs):
        solver = self.params.pressure_solver
        if solver == PressureSolver.JACOBI:
            return self._jacobi(pp, rhs)
        if solver == PressureSolver.SOR:
            if self.opts.sor_ordering == "lexicographic":
                return self._sor_lexicographic(pp, rhs)
            return self._sor_redblack(pp, rhs)
        if solver == PressureSolver.MULTIGRID:
            return self._multigrid(pp, rhs)
        raise NotImplementedError(
            f"{solver} is a beyond-reference solver (docs/SPEC.md items "
            "12-13); the oracle transcribes reference semantics only. "
            "Validate via tests/test_projection.py / test_physics.py.")

    # ---------------- corrector & BCs ----------------

    def _correct(self, u_star, v_star, pp, dt_sub):
        g = self.grid
        nx, ny = g.nx, g.ny
        dx, dy = F(g.dx), F(g.dy)
        u = u_star.copy()
        v = v_star.copy()
        for j in range(ny):
            for i in range(1, nx):
                u[j, i] = u_star[j, i] - dt_sub * (pp[j, i] - pp[j, i - 1]) / dx
        for j in range(1, ny):
            for i in range(nx):
                v[j, i] = v_star[j, i] - dt_sub * (pp[j, i] - pp[j - 1, i]) / dy
        self.p = self.p + pp
        return u, v

    def _apply_bcs(self):
        g = self.grid
        nx, ny = g.nx, g.ny
        dy = F(g.dy)
        if self.params.flow_case == FlowCase.CAVITY:
            if self.params.inlet_profile == InletProfile.UNIFORM:
                self.u[ny - 1, :] = self.inlet  # moving lid
            else:
                # Parabolic lid along x (ops/bc.py cavity branch):
                # u-face i at x = i*dx, zero at side walls.
                half = F(g.lx) / F(2.0)
                for i in range(nx + 1):
                    x = F(i) * F(g.dx)
                    val = self.inlet * (F(1.0) - ((x - half) / half) ** 2)
                    self.u[ny - 1, i] = max(val, F(0.0))
            self.u[0, :] = F(0.0)
            # No-penetration side walls win at the lid corners.
            self.u[:, 0] = F(0.0)
            self.u[:, nx] = F(0.0)
            self.v[0, :] = F(0.0)
            self.v[ny, :] = F(0.0)
            self.v[:, 0] = F(0.0)
            self.v[:, nx - 1] = F(0.0)
            self.u[self.mask_u_bc] = F(0.0)
            self.v[self.mask_v_bc] = F(0.0)
            return
        profile = self.params.inlet_profile
        for j in range(ny):
            if profile == InletProfile.UNIFORM:
                val = self.inlet
            else:
                y = (F(j) + 0.5) * dy
                if profile == InletProfile.PARABOLIC_UPPER:
                    # Documented addition (docs/SPEC.md): sudden-
                    # expansion inlet for the backward-facing step.
                    center = F(3.0) * F(g.ly) / 4.0
                    radius = F(g.ly) / 4.0
                else:
                    center = F(g.ly) / 2.0
                    radius = F(g.ly) / 2.0
                val = self.inlet * (1.0 - ((y - center) / radius) ** 2)
                if val < 0:
                    val = F(0.0)
            self.u[j, 0] = val
        self.u[:, nx] = self.u[:, nx - 1]
        self.u[0, :] = F(0.0)
        self.u[ny - 1, :] = F(0.0)
        self.v[0, :] = F(0.0)
        self.v[ny, :] = F(0.0)
        self.u[self.mask_u_bc] = F(0.0)
        self.v[self.mask_v_bc] = F(0.0)

    # ---------------- PISO ----------------

    def piso_substep(self, dt_sub):
        opts = self.opts
        u_star, v_star = self._predict(dt_sub)
        rhs = self._divergence_rhs(u_star, v_star, dt_sub)
        pp = (self.p_prime if opts.semantics == Semantics.RUST
              else np.zeros_like(self.p_prime))
        pp, err = self._solve_pressure(pp, rhs)
        self.u, self.v = self._correct(u_star, v_star, pp, dt_sub)
        for _ in range(opts.outer_corrector_rounds):
            if err < opts.outer_corrector_tol:
                break
            rhs = self._divergence_rhs(self.u, self.v, dt_sub)
            pp, err = self._solve_pressure(pp, rhs)
            self.u, self.v = self._correct(self.u, self.v, pp, dt_sub)
        self.p_prime = pp
        self._apply_bcs()
        return err

    def update(self):
        """One outer step (model.rs:304-379 / index.html:261-363)."""
        opts = self.opts
        js = opts.semantics == Semantics.JS
        u_enter, v_enter = self.u.copy(), self.v.copy()
        if js and opts.extrapolate and self.step > 0:
            self.u = 2.0 * self.u - self.u_prev
            self.v = 2.0 * self.v - self.v_prev
        u_old, v_old = self.u.copy(), self.v.copy()

        if self.step < opts.ramp_up_steps:
            self.inlet = (F(self.step) / F(opts.ramp_up_steps)
                          ) * self.target_inlet
        else:
            self.inlet = self.target_inlet

        dt_sub = self.dt / F(self.substeps)
        res_p = F(0.0)
        for _ in range(self.substeps):
            err = self.piso_substep(dt_sub)
            res_p = max(res_p, err) if js else err

        self.res_u = F(np.max(np.abs(self.u - u_old)))
        self.res_v = F(np.max(np.abs(self.v - v_old)))
        self.res_p = res_p
        self.step += 1
        self.t = self.t + self.dt

        if js and opts.substeps_adaptive:
            error_norm = max(self.res_u, self.res_v, res_p)
            tol = F(opts.substep_tolerance)
            if error_norm > tol:
                self.substeps = min(
                    int(np.ceil(F(self.substeps) * (error_norm / tol))),
                    opts.substeps_max)
            elif error_norm < tol / 10.0 and self.substeps > 1:
                self.substeps = max(self.substeps // 2, 1)

        max_vel = F(max(np.max(np.abs(self.u)), np.max(np.abs(self.v))))
        cap = self.dt_user if js else self.dt
        if max_vel == 0:
            dt_cfl = cap
        else:
            dt_cfl = min(F(opts.cfl) * F(min(self.grid.dx, self.grid.dy))
                         / max_vel, cap)
        if js and opts.residual_dt_scaling:
            ptol = F(opts.residual_dt_tol)
            if res_p > ptol:
                dt_cfl = min(dt_cfl, dt_cfl * (ptol / (res_p + F(1e-10))))
        if dt_cfl > self.dt:
            self.dt = min(dt_cfl, self.dt * F(opts.dt_growth_cap))
        else:
            self.dt = dt_cfl

        if js:
            self.u_prev, self.v_prev = u_enter, v_enter
