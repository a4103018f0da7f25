"""Numerical kernels: splines, quadrature, ODE integration,
root finding, FFTLog and special functions. All functions are pure jnp and
traceable (jit/vmap/grad)."""

from .misc import flatarray, bcast_dtype, exception, exception_or_nan
from .spline import tridiagonal_solve, natural_cubic_coeffs, cubic_eval, Interpolator1D, Interpolator2D
from .quadrature import simpson, romberg, gauss_legendre, gauss_laguerre_nodes, fixed_quad_legendre
from .odeint import cumquad_rk4, linear_ode2_magnus, linear_ode2_rk4_prefix, odeint
from .roots import bracket, bisect
from .special import loggamma, gamma
from .fft import fft_pair, rfft_pair, irfft_pair
