"""Command-line entry points of the port.  The mesh helpers the JAX package
exports here (``HW``, ``make_mesh``, ``make_production_mesh``) load on first
use, so importing an entry point pulls in no mesh code."""

import importlib

_LAZY = ("HW", "make_mesh", "make_production_mesh")


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(".mesh", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = list(_LAZY)
