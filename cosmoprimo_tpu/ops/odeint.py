"""Fixed-grid Runge-Kutta integration on ``lax.scan``.

Fixed grids keep shapes static so the whole integration vmaps over
parameter batches (the reference makes the same choice,
cosmoprimo/jax.py:672-716).
"""

import jax
import jax.numpy as jnp


def odeint(fun, y0, t, args=(), method='rk4'):
    """Integrate dy/dt = fun(y, t, *args) on the fixed grid ``t`` (1D,
    increasing or decreasing), returning y at every grid point (y(t[0]) = y0).
    ``y0`` may be a scalar or an array; returned shape is t.shape + y0.shape.
    """
    t = jnp.asarray(t)
    func = lambda y, tt: fun(y, tt, *args)

    if method == 'rk1':
        def step(y, t_last, h):
            return y + h * func(y, t_last)
    elif method == 'rk2':
        def step(y, t_last, h):
            k1 = func(y, t_last)
            k2 = func(y + h * k1 / 2, t_last + h / 2)
            return y + h * k2
    elif method == 'rk4':
        def step(y, t_last, h):
            k1 = func(y, t_last)
            k2 = func(y + h * k1 / 2, t_last + h / 2)
            k3 = func(y + h * k2 / 2, t_last + h / 2)
            k4 = func(y + h * k3, t_last + h)
            return y + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    else:
        raise ValueError(f'unknown method {method}')

    y0 = jnp.asarray(y0, dtype=jnp.result_type(float, t.dtype))

    def scan_fn(carry, tnext):
        y, tlast = carry
        ynext = step(y, tlast, tnext - tlast)
        return (ynext, tnext), ynext

    # First output corresponds to t[0] with zero step (y0 itself).
    (_, _), ys = jax.lax.scan(scan_fn, (y0, t[0]), t)
    return ys


def cumquad_rk4(fun, y0, t, args=()):
    """Cumulative integral y(t) = y0 + int fun(t') dt' on the fixed grid
    ``t``, for integrands that do NOT depend on y.

    Numerically identical to ``odeint(fun, y0, t, method='rk4')`` for
    y-independent ``fun`` (RK4 on a quadrature problem collapses to the
    Simpson rule with midpoint evaluation per interval), but the sequential
    lax.scan becomes a vectorized evaluation + one cumsum — no per-step
    kernel launches inside jit/vmap megagraphs (this is the hot path of the
    batched distance/time tables).
    """
    t = jnp.asarray(t)
    func = lambda tt: fun(None, tt, *args)
    mid = (t[:-1] + t[1:]) / 2.0
    f_ends = func(t)
    f_mid = func(mid)
    h = jnp.diff(t)
    inc = h / 6.0 * (f_ends[:-1] + 4.0 * f_mid + f_ends[1:])
    y0 = jnp.asarray(y0, dtype=jnp.result_type(float, t.dtype))
    zero = jnp.zeros((1,) + inc.shape[1:], dtype=inc.dtype)
    return y0 + jnp.concatenate([zero, jnp.cumsum(inc, axis=0)], axis=0)


def linear_ode2_magnus(coeffs_fun, y0, t):
    """Solve the LINEAR 2nd-order ODE y'' = s(t) y + f(t) y' on the fixed
    grid ``t`` in O(log n) depth, returning (n, 2) with columns (y, y').

    ``coeffs_fun(t) -> (s, f)`` must accept array arguments.

    Design: as a first-order linear system Y' = A(t) Y with
    A = [[0, 1], [s, f]], the exact propagator over each grid interval is a
    2x2 matrix; a 4th-order two-point Gauss-Legendre Magnus expansion gives
    Omega_i = h/2 (A1 + A2) + sqrt(3) h^2 / 12 [A2, A1] and
    P_i = expm(Omega_i), all evaluated VECTORIZED over the n-1 intervals.
    The cumulative solution is then a parallel prefix of matrix products
    (jax.lax.associative_scan) — log-depth instead of the n sequential
    steps of rk4-on-scan, which dominated the growth-table latency inside
    the batched pipelines. Same 4th-order accuracy as rk4.
    """
    t = jnp.asarray(t)
    h = jnp.diff(t)                                       # (n-1,)
    mid = (t[:-1] + t[1:]) / 2.0
    off = h * (jnp.sqrt(3.0) / 6.0)
    s1, f1 = coeffs_fun(mid - off)
    s2, f2 = coeffs_fun(mid + off)

    # COMPONENT form throughout: a (n-1, 2, 2) matrix stack puts the 2x2
    # on the two minor dims, and turns the prefix products into tiny dots
    # of shape 2x2. Four (n-1,) component arrays keep the interval
    # axis (and under vmap the batch axis) on the lanes, and the companion
    # structure A = [[0, 1], [s, f]] constant-folds at trace time.
    # Omega = h/2 (A1 + A2) + sqrt(3) h^2 / 12 [A2, A1], componentwise:
    # [A2, A1] = [[ds, df], [f2 s1 - f1 s2, -ds]], ds = s1-s2, df = f1-f2
    ch = jnp.sqrt(3.0) * h ** 2 / 12.0
    ds, df = s1 - s2, f1 - f2
    o00 = ch * ds
    o01 = h + ch * df
    o10 = h / 2.0 * (s1 + s2) + ch * (f2 * s1 - f1 * s2)
    o11 = h / 2.0 * (f1 + f2) - ch * ds

    # closed-form expm of a 2x2 matrix: with B = Omega - (tr/2) I traceless,
    # B^2 = -det(B) I = q^2 I, so expm = e^{tr/2} (c0 I + c1 B) where
    # (c0, c1) = (cosh q, sinh(q)/q) for q^2 > 0 and (cos p, sin(p)/p) for
    # q^2 = -p^2 < 0 — both branches via even power series in q^2 near 0
    tr2 = (o00 + o11) / 2.0
    b00 = o00 - tr2                                       # b11 = -b00
    q2 = o01 * o10 + b00 ** 2                             # = -det(B)
    q = jnp.sqrt(jnp.abs(q2))
    qs = jnp.where(q > 1e-8, q, 1.0)
    c0 = jnp.where(q2 >= 0, jnp.cosh(q), jnp.cos(q))
    c1 = jnp.where(q > 1e-8,
                   jnp.where(q2 >= 0, jnp.sinh(qs) / qs, jnp.sin(qs) / qs),
                   1.0 + q2 / 6.0)
    e = jnp.exp(tr2)
    P = (e * (c0 + c1 * b00), e * c1 * o01,
         e * c1 * o10, e * (c0 - c1 * b00))

    # prefix products: cum_i = P_i @ ... @ P_1 (combine(a, b) = b @ a)
    def combine(a, b):
        a00, a01, a10, a11 = a
        b00_, b01, b10, b11 = b
        return (b00_ * a00 + b01 * a10, b00_ * a01 + b01 * a11,
                b10 * a00 + b11 * a10, b10 * a01 + b11 * a11)

    cum = jax.lax.associative_scan(combine, P)
    y0 = jnp.asarray(y0, dtype=P[0].dtype)
    ys = jnp.stack([cum[0] * y0[0] + cum[1] * y0[1],
                    cum[2] * y0[0] + cum[3] * y0[1]], axis=-1)
    return jnp.concatenate([y0[None, :], ys], axis=0)


def linear_ode2_rk4_prefix(coeffs_fun, y0, t):
    """Fixed-grid rk4 for the LINEAR 2nd-order ODE y'' = s(t) y + f(t) y',
    with the n sequential scan steps replaced by a log-depth parallel
    prefix — numerically the SAME rk4 recurrence (to fp re-association,
    ~1e-13), so results stay bit-compatible with ``odeint(..., 'rk4')``
    and with the reference's growth integration (reference jax.py:672-716,
    cosmology.py:2073-2079) at the 1e-9 parity bar.

    On a linear system Y' = A(t) Y (A = [[0, 1], [s, f]]), one rk4 step is
    itself a linear map R_i = I + h/6 (K1 + 2 K2 + 2 K3 + K4) with
    K1 = A1, K2 = A2 (I + h/2 K1), K3 = A2 (I + h/2 K2),
    K4 = A3 (I + h K3); all R_i are built VECTORIZED over the intervals and
    composed with jax.lax.associative_scan.  Returns (n, 2): (y, y').
    """
    t = jnp.asarray(t)
    h = jnp.diff(t)                                       # (n-1,)
    s_end, f_end = coeffs_fun(t)
    s_mid, f_mid = coeffs_fun((t[:-1] + t[1:]) / 2.0)

    # COMPONENT form (see linear_ode2_magnus): 2x2s as 4-tuples of (n-1,)
    # arrays keep the interval/batch axes minor instead of the (2, 2)
    # dims, and the companion zeros/
    # ones of A = [[0, 1], [s, f]] constant-fold out of the K products.
    def mmul(x, y):
        x00, x01, x10, x11 = x
        y00, y01, y10, y11 = y
        return (x00 * y00 + x01 * y10, x00 * y01 + x01 * y11,
                x10 * y00 + x11 * y10, x10 * y01 + x11 * y11)

    def iplus(x, c):                                      # I + c * x
        x00, x01, x10, x11 = x
        return (1.0 + c * x00, c * x01, c * x10, 1.0 + c * x11)

    A1 = (0.0, 1.0, s_end[:-1], f_end[:-1])
    A2 = (0.0, 1.0, s_mid, f_mid)
    A3 = (0.0, 1.0, s_end[1:], f_end[1:])
    K1 = A1
    K2 = mmul(A2, iplus(K1, h / 2.0))
    K3 = mmul(A2, iplus(K2, h / 2.0))
    K4 = mmul(A3, iplus(K3, h))
    Ksum = tuple(k1 + 2.0 * k2 + 2.0 * k3 + k4
                 for k1, k2, k3, k4 in zip(K1, K2, K3, K4))
    R = iplus(Ksum, h / 6.0)

    def combine(a, b):                                    # b @ a
        return mmul(b, a)

    cum = jax.lax.associative_scan(combine, R)
    y0 = jnp.asarray(y0, dtype=R[0].dtype)
    ys = jnp.stack([cum[0] * y0[0] + cum[1] * y0[1],
                    cum[2] * y0[0] + cum[3] * y0[1]], axis=-1)
    return jnp.concatenate([y0[None, :], ys], axis=0)
