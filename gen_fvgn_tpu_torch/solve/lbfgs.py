"""L-BFGS with optax's zoom line search, on one flat parameter vector.

The port's own copy of `optax.lbfgs(memory_size=m)` as optax 0.2.6 has it,
with its defaults: `scale_by_lbfgs(memory_size, scale_init_precond=True)`
(optax/_src/transform.py:1573, the two-loop recursion over the m newest
(s, y) pairs), then `scale(-1)`, then `scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy="one")` (linesearch.py:576
and :1331, with the defaults of :1333-1341 and the cubic and quadratic
steps `_cubicmin` / `_quadmin`, :455 and :496), driven as
`optax.value_and_grad_from_state` drives it: an iteration reuses the value
and gradient that the previous line search ended on. `torch.optim.LBFGS`
is another algorithm (its own line search and stopping rules) and is not
used.

The vectors stay on their device. The line search's scalars (values,
slopes, step sizes) are read to the host once a function evaluation and
computed there as NumPy scalars of the vector's dtype, in optax's order of
operations, so a float32 solve rounds them as JAX's float32 scalars are
rounded and a float64 one follows optax's float64 iterates.
"""

from __future__ import annotations

import collections
from typing import Callable, Tuple

import numpy as np
import torch

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]

# optax's zoom line search as `optax.lbfgs` makes it
# (scale_by_zoom_linesearch(max_linesearch_steps=20) and its defaults)
MAX_LINESEARCH_STEPS = 20
TOL = 0.0
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5


def _cubicmin(a, fa, fpa, b, fb, c, fc, T):
    """A critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * (dc * dc)) * v0 + db * (db * db) * v1) / denom
    radical = B * B - T(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (T(3.0) * A)


def _quadmin(a, fa, fpa, b, fb, T):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (T(2.0) * B)


class _Search:
    """One zoom line search (Nocedal & Wright algorithms 3.5 and 3.6 with
    Hager & Zhang's approximate decrease), state as optax's
    ZoomLinesearchState."""

    def __init__(self, f: ValueAndGrad, x, u, value, grad, slope, T):
        self.f, self.x, self.u, self.T = f, x, u, T
        self.max_steps = MAX_LINESEARCH_STEPS
        self.tol = T(TOL)
        self.increase = T(INCREASE_FACTOR)
        self.slope_rtol = T(SLOPE_RTOL)
        self.approx_slope = T(2 * SLOPE_RTOL - 1.0)
        self.curv_rtol = T(CURV_RTOL)
        self.approx_dec_rtol = T(APPROX_DEC_RTOL)
        self.threshold = T(STEPSIZE_PRECISION)
        self.evaluations = 0
        zero = T(0.0)
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = \
            zero, value, grad, slope
        self.value_init, self.slope_init = value, slope
        self.decrease_error = T(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe = (zero, value, grad)

    def _on_line(self, stepsize):
        """(value, gradient, slope along u) at x + stepsize·u."""
        value, grad = self.f(self.x + float(stepsize) * self.u)
        slope = torch.dot(grad, self.u)
        v, s = torch.stack([value.to(grad.dtype), slope]).cpu().numpy()
        self.evaluations += 1
        return self.T(v), grad, self.T(s)

    def _errors(self, stepsize, value, slope):
        T = self.T
        dec = value - self.value_init - self.slope_rtol * stepsize \
            * self.slope_init
        approx = slope - self.approx_slope * self.slope_init
        delta = value - self.value_init \
            - self.approx_dec_rtol * np.abs(self.value_init)
        dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, T(0.0))
        dec = T(np.inf) if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - self.curv_rtol
                          * np.abs(self.slope_init), T(0.0))
        curv = T(np.inf) if np.isnan(curv) else curv
        return dec, np.maximum(dec, curv)

    def _search_interval(self):
        it = self.count
        prev = (self.stepsize, self.value, self.slope)
        new = self.T(1.0) if it == 0 else self.increase * prev[0]
        value, grad, slope = self._on_line(new)
        dec, error = self._errors(new, value, slope)
        if dec <= self.tol:
            self.safe = (new, value, grad)
        set_high = (dec > 0.0) or (value >= prev[1] and it > 0)
        set_low = slope >= 0.0 and not set_high
        if set_low:
            low, high = (new, value, slope), prev
        else:
            low, high = prev, (new, value, slope)
        self.low, self.value_low, self.slope_low = low
        self.high, self.value_high, self.slope_high = high
        self.cubic_ref, self.value_cubic_ref = low[0], low[1]
        self.interval_found = set_high or set_low or error <= self.tol
        self.done = bool(error <= self.tol)
        self.failed = it + 1 >= self.max_steps and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = \
            new, value, grad, slope
        self.decrease_error = dec

    def _zoom(self):
        T, it = self.T, self.count
        low, vlow, slow = self.low, self.value_low, self.slope_low
        high, vhigh, shigh = self.high, self.value_high, self.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        too_small = delta <= self.threshold
        cubic = _cubicmin(low, vlow, slow, high, vhigh, self.cubic_ref,
                          self.value_cubic_ref, T)
        use_cubic = left + T(0.2) * delta < cubic < right - T(0.2) * delta
        quad = _quadmin(low, vlow, slow, high, vhigh, T)
        use_quad = not use_cubic and \
            left + T(0.1) * delta < quad < right - T(0.1) * delta
        middle = cubic if use_cubic else quad if use_quad \
            else (low + high) / T(2.0)
        value, grad, slope = self._on_line(middle)
        dec, error = self._errors(middle, value, slope)
        if dec <= self.tol and value < self.safe[1]:
            self.safe = (middle, value, grad)
        self.done = bool(error <= self.tol)
        set_high_mid = dec > 0.0 or value >= vlow
        set_high_low = slope * (high - low) >= 0.0 and not set_high_mid
        if set_high_mid:
            self.high, self.value_high, self.slope_high = middle, value, slope
        if set_high_low:
            self.high, self.value_high, self.slope_high = low, vlow, slow
        if not set_high_mid:
            self.low, self.value_low, self.slope_low = middle, value, slope
        if set_high_mid or set_high_low:
            self.cubic_ref, self.value_cubic_ref = high, vhigh
        else:
            self.cubic_ref, self.value_cubic_ref = low, vlow
        presumably = it + 1 >= self.max_steps or \
            (too_small and self.safe[0] > 0.0)
        self.failed = presumably and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = \
            middle, value, grad, slope
        self.decrease_error = dec

    def run(self):
        """(stepsize, value, gradient) where the search ends."""
        with np.errstate(all="ignore"):
            while not (self.done or self.failed):
                if self.interval_found:
                    self._zoom()
                else:
                    self._search_interval()
                if self.failed and (self.safe[0] > 0.0
                                    or np.isinf(self.decrease_error)):
                    self.stepsize, self.value, self.grad = self.safe
        return self.stepsize, self.value, self.grad


class LBFGS:
    """optax.lbfgs(memory_size=memory_size) on the flat vector `x` (any
    float dtype, any device). Each `step(f)` is one optax iteration, f(x)
    -> (value, gradient): it returns the value at the iterate it started
    from and moves `self.x`; `self.evaluations` counts f's calls in it."""

    def __init__(self, x: torch.Tensor, memory_size: int = 10):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.x = x
        self.T = np.float64 if x.dtype == torch.float64 else np.float32
        self.memory = collections.deque(maxlen=memory_size)  # (s, y, ρ)
        self.count = 0
        self.prev = None                 # (x, gradient) of the last step
        self.value = self.T(np.inf)      # where the last line search ended
        self.grad = torch.zeros_like(x)
        self.evaluations = 0

    def _direction(self, grad: torch.Tensor) -> torch.Tensor:
        """-P_k g: the memory updated with this iterate, then the two-loop
        recursion (entries optax holds at zero are skipped: they leave the
        vector exactly as it is)."""
        if self.count > 0:
            s = self.x - self.prev[0]
            y = grad - self.prev[1]
            sy = torch.dot(y, s)
            rho = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
            self.memory.append((s, y, rho))
        if self.count > 0:
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        vec, alphas = grad, []
        for s, y, rho in reversed(self.memory):
            alpha = rho * torch.dot(s, vec)
            vec = vec - alpha * y
            alphas.append(alpha)
        vec = gamma * vec
        for (s, y, rho), alpha in zip(self.memory, reversed(alphas)):
            beta = rho * torch.dot(y, vec)
            vec = vec + (alpha - beta) * s
        self.count += 1
        self.prev = (self.x, grad)
        return -vec

    def step(self, f: ValueAndGrad):
        """One iteration; returns the value at the iterate it started from."""
        T = self.T
        self.evaluations = 0
        if np.isfinite(self.value):
            value, grad = self.value, self.grad
        else:
            v, grad = f(self.x)
            value = T(v.detach().to("cpu", torch.float64).item())
            self.evaluations += 1
        u = self._direction(grad)
        slope = T(torch.dot(u, grad).to("cpu", torch.float64).item())
        search = _Search(f, self.x, u, value, grad, slope, T)
        stepsize, self.value, self.grad = search.run()
        self.evaluations += search.evaluations
        self.x = self.x + float(stepsize) * u
        return value
