"""Upwind face reconstruction for the convective terms.

Vectorized re-derivations of the reference's per-face helpers:

* first order: model.rs:893-1248 (8 SIMD helpers + scalar variants),
  index.html:382-417 (u), :564-591 (v)
* second order: model.rs:911-1053 (u), :1098-1248 (v);
  index.html:418-470 (u), :593-641 (v)
* QUICK (JS only): index.html:471-549 (u), :643-723 (v)

Each function returns face values on the *full* staggered array shape;
out-of-range entries carry junk that the predictor masks away. Boundary
fallback conditions (`i > 1`, `j < ny - 2`, ...) become static iota
predicates that XLA folds into the fused stencil loop.

Semantics note (see docs/SPEC.md): for the u-momentum north/south
convecting velocity the Rust SIMD path uses the *unaveraged* east v
neighbor (get_v_north, model.rs:1056-1061) while the JS twin and the
Rust scalar helpers average the two adjacent v faces
(index.html:396-404, model.rs:984-989). ``avg_conv_v`` selects which.
The second-order/QUICK upwind *selection* always uses the averaged v
(model.rs:996, :1041); only the flux multiplier differs by mode.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.config import VelocityScheme
from .stencil import DEFAULT_CTX, StencilCtx


class UFaces(NamedTuple):
    e: jnp.ndarray
    w: jnp.ndarray
    n: jnp.ndarray
    s: jnp.ndarray
    v_n: jnp.ndarray  # convecting velocity multiplier at the north face
    v_s: jnp.ndarray


class VFaces(NamedTuple):
    e: jnp.ndarray
    w: jnp.ndarray
    n: jnp.ndarray
    s: jnp.ndarray
    u_e: jnp.ndarray
    u_w: jnp.ndarray


def u_faces(u: jnp.ndarray, v: jnp.ndarray, nx: int, ny: int,
            scheme: VelocityScheme, avg_conv_v: bool,
            ctx: StencilCtx = DEFAULT_CTX) -> UFaces:
    """Face values for the u-momentum cell around u face (i, j).

    u face (i, j) sits at (i*dx, (j+0.5)*dy); the adjacent v faces are
    v[j, i-1], v[j, i] (south) and v[j+1, i-1], v[j+1, i] (north).
    """
    shape = u.shape
    su = ctx.shifts(u, shape)
    sv = ctx.shifts(v, shape)
    uC, uE, uW = su(0, 0), su(0, 1), su(0, -1)
    uN, uS = su(1, 0), su(-1, 0)
    uEE, uWW = su(0, 2), su(0, -2)
    uNN, uSS = su(2, 0), su(-2, 0)
    vNE, vNW = sv(1, 0), sv(1, -1)
    vSE, vSW = sv(0, 0), sv(0, -1)

    v_n_avg = 0.5 * (vNW + vNE)
    v_s_avg = 0.5 * (vSW + vSE)
    if avg_conv_v:
        v_n_mult, v_s_mult = v_n_avg, v_s_avg
    else:
        v_n_mult, v_s_mult = vNE, vSE  # model.rs:1056-1069

    i = ctx.col_index(shape)
    j = ctx.row_index(shape)

    if scheme == VelocityScheme.FIRST:
        # model.rs:893-908 (e), :929-941 (w), :966-981 (n), :1011-1026 (s)
        e = jnp.where(0.5 * (uC + uE) >= 0, uC, uE)
        w = jnp.where(0.5 * (uW + uC) >= 0, uW, uC)
        # Selection sign: unaveraged v in Rust SIMD (model.rs:977),
        # averaged in JS (index.html:397).
        n = jnp.where(v_n_mult >= 0, uC, uN)
        s = jnp.where(v_s_mult >= 0, uS, uC)
    elif scheme == VelocityScheme.SECOND:
        # model.rs:911-926 / index.html:425-433
        e = jnp.where(
            uC >= 0,
            jnp.where(i > 1, 1.5 * uC - 0.5 * uW, uC),
            jnp.where(i < nx - 1, 1.5 * uE - 0.5 * uEE, uE))
        # model.rs:944-963 / index.html:436-443
        w = jnp.where(
            uW >= 0,
            jnp.where(i > 2, 1.5 * uW - 0.5 * uWW, uW),
            1.5 * uC - 0.5 * uE)  # `i < nx` always holds on the interior
        # model.rs:992-1008 (len-check implies j < ny-2) / index.html:446-454
        n = jnp.where(
            v_n_avg >= 0,
            jnp.where(j > 1, 1.5 * uC - 0.5 * uS, uC),
            jnp.where(j < ny - 2, 1.5 * uN - 0.5 * uNN, uN))
        # model.rs:1037-1053 / index.html:457-464
        s = jnp.where(
            v_s_avg >= 0,
            jnp.where(j > 1, 1.5 * uS - 0.5 * uSS, uS),
            1.5 * uC - 0.5 * uN)  # `j < ny` always holds on the interior
    elif scheme == VelocityScheme.QUICK:
        # index.html:471-488 (e), :490-501 (w), :503-521 (n), :523-541 (s)
        e = jnp.where(
            uC >= 0,
            jnp.where(i >= 2, (-uW + 6 * uC + 3 * uE) / 8, 1.5 * uC - 0.5 * uW),
            jnp.where(i <= nx - 2, (3 * uC + 6 * uE - uEE) / 8, uE))
        w = jnp.where(
            uW >= 0,
            jnp.where(i >= 3, (-uWW + 6 * uW + 3 * uC) / 8, 1.5 * uW - 0.5 * uC),
            (3 * uW + 6 * uC - uE) / 8)
        n = jnp.where(
            v_n_avg >= 0,
            jnp.where(j >= 2, (-uS + 6 * uC + 3 * uN) / 8, 1.5 * uC - 0.5 * uS),
            jnp.where(j < ny - 2, (3 * uC + 6 * uN - uNN) / 8, uN))
        s = jnp.where(
            v_s_avg >= 0,
            jnp.where(j >= 2, (-uSS + 6 * uS + 3 * uC) / 8, 1.5 * uS - 0.5 * uC),
            jnp.where(j < ny - 1, (3 * uS + 6 * uC - uN) / 8, uC))
    else:
        raise ValueError(scheme)
    return UFaces(e, w, n, s, v_n_mult, v_s_mult)


def v_faces(u: jnp.ndarray, v: jnp.ndarray, nx: int, ny: int,
            scheme: VelocityScheme,
            ctx: StencilCtx = DEFAULT_CTX) -> VFaces:
    """Face values for the v-momentum cell around v face (i, j).

    v face (i, j) sits at ((i+0.5)*dx, j*dy); the convecting u values
    are the unaveraged u faces u[j, i] (west) and u[j, i+1] (east) in
    both references (model.rs:600-601, index.html:568/573).
    """
    shape = v.shape
    sv = ctx.shifts(v, shape)
    su = ctx.shifts(u, shape)
    vC, vE, vW = sv(0, 0), sv(0, 1), sv(0, -1)
    vN, vS = sv(1, 0), sv(-1, 0)
    vEE, vWW = sv(0, 2), sv(0, -2)
    vNN, vSS = sv(2, 0), sv(-2, 0)
    u_e = su(0, 1)
    u_w = su(0, 0)

    v_n_avg = 0.5 * (vC + vN)
    v_s_avg = 0.5 * (vS + vC)

    i = ctx.col_index(shape)
    j = ctx.row_index(shape)

    if scheme == VelocityScheme.FIRST:
        # model.rs:1085-1095 (e), :1128-1142 (w), :1176-1185 (n), :1220-1229 (s)
        e = jnp.where(u_e >= 0, vC, vE)
        w = jnp.where(u_w >= 0, vW, vC)
        n = jnp.where(v_n_avg >= 0, vC, vN)
        s = jnp.where(v_s_avg >= 0, vS, vC)
    elif scheme == VelocityScheme.SECOND:
        # model.rs:1098-1113 / index.html:596-603
        e = jnp.where(
            u_e >= 0,
            jnp.where(i > 0, 1.5 * vC - 0.5 * vW, vC),
            jnp.where(i < nx - 2, 1.5 * vE - 0.5 * vEE, vE))
        # model.rs:1145-1160 / index.html:606-613
        w = jnp.where(
            u_w >= 0,
            jnp.where(i > 1, 1.5 * vW - 0.5 * vWW, vW),
            jnp.where(i < nx - 1, 1.5 * vC - 0.5 * vE, vC))
        # model.rs:1188-1204 (len-check implies j < ny-1) / index.html:616-623
        n = jnp.where(
            v_n_avg >= 0,
            jnp.where(j > 1, 1.5 * vC - 0.5 * vS, vC),
            jnp.where(j < ny - 1, 1.5 * vN - 0.5 * vNN, vN))
        # model.rs:1232-1248 / index.html:626-633
        s = jnp.where(
            v_s_avg >= 0,
            jnp.where(j > 1, 1.5 * vS - 0.5 * vSS, vS),
            1.5 * vC - 0.5 * vN)  # `j < ny` always holds on the interior
    elif scheme == VelocityScheme.QUICK:
        # index.html:645-661 (e), :663-673 (w), :675-692 (n), :694-711 (s)
        e = jnp.where(
            u_e >= 0,
            jnp.where(i >= 2, (-vW + 6 * vC + 3 * vE) / 8, 1.5 * vC - 0.5 * vW),
            jnp.where(i < nx - 2, (3 * vC + 6 * vE - vEE) / 8, vE))
        w = jnp.where(
            u_w >= 0,
            jnp.where(i >= 3, (-vWW + 6 * vW + 3 * vC) / 8, 1.5 * vW - 0.5 * vC),
            (3 * vW + 6 * vC - vE) / 8)
        n = jnp.where(
            v_n_avg >= 0,
            jnp.where(j >= 2, (-vS + 6 * vC + 3 * vN) / 8, 1.5 * vC - 0.5 * vS),
            jnp.where(j < ny - 1, (3 * vC + 6 * vN - vNN) / 8, vN))
        s = jnp.where(
            v_s_avg >= 0,
            jnp.where(j >= 2, (-vSS + 6 * vS + 3 * vC) / 8, 1.5 * vS - 0.5 * vC),
            jnp.where(j < ny - 1, (3 * vS + 6 * vC - vN) / 8, vC))
    else:
        raise ValueError(scheme)
    return VFaces(e, w, n, s, u_e, u_w)
