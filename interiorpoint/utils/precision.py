"""Matmul precision of the solve paths.

On an NVIDIA GPU a float32 ``dot_general`` left at the default precision
may run on the tensor cores in TF32, which keeps about three significant
digits — too few for the ``dtype="float32"`` solve mode, whose Newton
systems and residuals are float32 throughout.  Every jitted solve entry
is therefore traced under ``highest_precision``: each matmul it contains
records ``Precision.HIGHEST`` (full float32) in its jaxpr.  float64
products are unaffected.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Wrap ``fn`` so everything it traces or dispatches uses
    ``jax.default_matmul_precision("highest")``.  Apply it beneath
    ``jax.jit`` so the setting is part of the traced program."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
