"""The arithmetic of the reference, and of its precision control.

The configurations state float32 with TF32 off
(``torch.set_float32_matmul_precision("highest")``). The precision control
is the reference computed one step below that, the step that would tempt a
later change: its matrix products in TF32, which keeps float32's range and
10 of its 23 mantissa bits in the operands and accumulates in float32; its
elementwise float32 arithmetic (the plant's RK4 substeps, the constraint
bounds, the saturation, the measurement), where TF32 does not exist, in
bfloat16, float32's range with 7 mantissa bits. ``Control`` emulates both on
any machine: float32 storage, the operands of every matrix product and
factorisation rounded to TF32, the result of every elementwise stage
rounded to bfloat16 (round to nearest, ties to even).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg


def _round_mantissa(a, keep: int) -> np.ndarray:
    """``a`` in float32 with its mantissa rounded to ``keep`` bits (round
    to nearest, ties to even); infinities and NaNs pass."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    drop = 23 - keep
    bits = a.view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    bits = (bits + half + ((bits >> drop) & 1)) & (0xFFFFFFFF ^ ((1 << drop) - 1))
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), out, a)


def round_tf32(a) -> np.ndarray:
    """``a`` in float32 with its mantissa rounded to TF32's 10 bits."""
    return _round_mantissa(a, 10)


def round_bf16(a) -> np.ndarray:
    """``a`` in float32 with its mantissa rounded to bfloat16's 7 bits."""
    return _round_mantissa(a, 7)


class Precision:
    """float64 numpy arithmetic; ``Control`` rounds."""

    name = "float64"

    def cast(self, a):
        return np.asarray(a, dtype=np.float64)

    def ew(self, a):
        """The result of an elementwise stage, in this arithmetic."""
        return np.asarray(a, dtype=np.float64)

    def mm(self, a, b):
        return self.cast(a) @ self.cast(b)

    def held(self, a):
        """A matrix as this arithmetic holds it for a solver's products."""
        return self.cast(a)

    def factor(self, M):
        # LU with pivoting: near the solution the weights z/s of the active
        # rows reach 1e20 and a Cholesky factor breaks down in float64
        return scipy.linalg.lu_factor(self.cast(M), check_finite=False)

    def solve_factored(self, fac, rhs):
        return scipy.linalg.lu_solve(fac, self.cast(rhs), check_finite=False)

    def solve(self, M, rhs):
        return self.solve_factored(self.factor(M), rhs)


class Control(Precision):
    name = "tf32 products, bfloat16 elementwise"

    def cast(self, a):
        return np.asarray(a, dtype=np.float32)

    def ew(self, a):
        return round_bf16(a)

    def mm(self, a, b):
        return np.matmul(round_tf32(a), round_tf32(b))

    def held(self, a):
        return round_tf32(a)

    def factor(self, M):
        return scipy.linalg.lu_factor(round_tf32(M), check_finite=False)

    def solve_factored(self, fac, rhs):
        return scipy.linalg.lu_solve(fac, round_tf32(rhs),
                                     check_finite=False).astype(np.float32)


FLOAT64 = Precision()
CONTROL = Control()
