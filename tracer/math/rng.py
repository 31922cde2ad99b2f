"""Counter-based PRNG matching the reference's GPU generator bit-for-bit.

The reference seeds each pixel with an NVIDIA TEA-style xorshift hash of
``(pixel_index, iteration)`` and then draws floats from an MCG31 LCG
(``/root/reference/res/shaders/w9e2.wgsl:133-164``). Because the state is a
single u32 derived from a counter, the generator is *stateless across frames*
— a fully vectorized uint32 hash with no
sequential dependency between pixels, and deterministic images for fixed
(pixel, iteration), which makes renders reproducible and the backward pass
replayable from the same seeds.

All functions are vectorized over arbitrary leading shapes and work under
``jax.jit``/Pallas (pure uint32 ops). ``numpy`` arrays also work (the CPU
oracle uses this same module so oracle and device renders consume identical
random streams).
"""

from __future__ import annotations

import jax.numpy as jnp

_U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x, _U32)


def tea_seed(val0, val1, rounds: int = 16):
    """TEA-based seed hash of two u32 counters.

    Mirrors ``prng_xorshift_seed_generator``
    (``/root/reference/res/shaders/w9e2.wgsl:132-147``): 16 rounds of the TEA
    block cipher's mixing function; returns ``v0``.
    """
    v0 = _u32(val0)
    v1 = _u32(val1)
    s0 = _u32(0)
    for _ in range(rounds):
        s0 = s0 + _u32(0x9E3779B9)
        v0 = v0 + (
            ((v1 << 4) + _u32(0xA341316C))
            ^ (v1 + s0)
            ^ ((v1 >> 5) + _u32(0xC8013EA4))
        )
        v1 = v1 + (
            ((v0 << 4) + _u32(0xAD90777D))
            ^ (v0 + s0)
            ^ ((v0 >> 5) + _u32(0x7E95761E))
        )
    return v0


def mcg31(state):
    """One MCG31 step: ``state' = (A * state) & 0x7FFFFFFF``.

    Multiplier from Hui-Ching Tang [EJOR 2007], as used by the reference
    (``/root/reference/res/shaders/w9e2.wgsl:150-155``). Returns the new
    state, which doubles as the 31-bit random draw.
    """
    return (_u32(1977654935) * _u32(state)) & _u32(0x7FFFFFFF)


def rnd(state):
    """Draw a float in [0, 1) and the advanced state.

    ``rnd`` in the reference (``w9e2.wgsl:157-160``): the 31-bit LCG output
    divided by 2^31.
    """
    state = mcg31(state)
    return state.astype(jnp.float32) * jnp.float32(1.0 / 2147483648.0), state


def rnd_int(state):
    """Draw a u32 in [0, 2^31) and the advanced state (``w9e2.wgsl:163-166``)."""
    state = mcg31(state)
    return state, state


def pixel_seed(pixel_index, iteration, rounds: int = 16):
    """Per-pixel stream seed for a progressive frame.

    ``launch_idx = y * res_x + x`` hashed with the frame iteration
    (``/root/reference/res/shaders/w8e3.wgsl:255-258``).
    """
    return tea_seed(pixel_index, iteration, rounds)
