"""Fused-loop device timing.

A host dispatch + sync costs far more than a microsecond-scale kernel, so
the reference's warmup + N-iteration `Instant` discipline
(linalg/benches/perf.rs:29-41) is re-expressed as: run N repetitions
*inside one jitted program* whose per-repetition input is perturbed by the
loop index (defeating XLA loop-invariant motion), sync once, divide.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp


def fused_loop_time(make_step: Callable, reps: int = 16, iters: int = 3) -> float:
    """Median-free best-of-iters per-repetition time of ``make_step``.

    ``make_step(bump)`` must run the computation with its input perturbed by
    the traced f32 scalar ``bump`` and return a f32 scalar probe derived
    from the result (so nothing is dead code).  Each repetition gets a
    distinct bump, so no iteration can be hoisted out of the (sequential)
    while-loop.
    """

    @jax.jit
    def run(bump0):
        def body(i, acc):
            probe = make_step(bump0 + i.astype(jnp.float32))
            # accumulate the probe directly: `0.0 * probe` invites constant
            # folding (and with fast-math, DCE of the whole step).  Overflow
            # to inf is harmless — only the data dependence matters.
            return acc + probe

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    float(run(jnp.float32(0.0)))  # compile + warm
    best = float("inf")
    for it in range(iters):
        t0 = time.perf_counter()
        float(run(jnp.float32((it + 1) * reps)))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def fused_loop_time_args(make_step: Callable, args, reps: int = 16,
                         iters: int = 3) -> float:
    """fused_loop_time with the operand arrays passed as JIT ARGUMENTS.

    Arrays closed over by a jitted function are embedded as CONSTANTS in
    the compiled program, which for a multi-GB operand bloats compilation
    and the compile cache.  ``make_step(bump, *args)`` receives the same
    pytrees passed here as real parameters.
    """

    @jax.jit
    def run(bump0, *xs):
        def body(i, acc):
            probe = make_step(bump0 + i.astype(jnp.float32), *xs)
            return acc + probe

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    float(run(jnp.float32(0.0), *args))  # compile + warm
    best = float("inf")
    for it in range(iters):
        t0 = time.perf_counter()
        float(run(jnp.float32((it + 1) * reps), *args))
        best = min(best, time.perf_counter() - t0)
    return best / reps
