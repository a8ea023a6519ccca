"""Compile a function of the JAX reference for the port's parity tests.

The tests that hold the port against the reference on the CPU spend most
of their time in XLA compiling the reference's LM and MLP functions, each
called a few times at most. ``compiled`` compiles one at XLA's backend
optimization level 0: the same HLO, so the same operations in the same
order, with less LLVM optimization of the generated code (a reduced
smollm round compiles in ~2 s instead of ~6.5 s and runs in ~1 s instead
of ~0.6 s).
"""
import jax


def compiled(fn, *args):
    """``fn`` compiled for ``args`` (call it with arguments of their shapes)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
