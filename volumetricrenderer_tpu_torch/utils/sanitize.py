"""Runtime numeric checks (port of volumetricrenderer_tpu/utils/sanitize.py).

The JAX package wraps a function with checkify's float checks, which name
the primitive that produced a NaN or Inf. Eager PyTorch has no such
transform; here `checked(f)` tests what f returns with torch.isfinite and
raises naming the first non-finite output, and `first_nonfinite(tree)`
counts the non-finite elements per leaf of a nested result (a restored
checkpoint, a fit's state).
"""
from __future__ import annotations

import functools

import torch

__all__ = ["checked", "first_nonfinite", "assert_all_finite"]


def _leaves(tree, path=""):
    """(path, tensor) for every floating tensor in a tensor or a nested
    tuple, list or dict of them; other leaves are converted when they are
    numeric and skipped otherwise."""
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, f"{path}[{key!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, val in enumerate(tree):
            yield from _leaves(val, f"{path}[{i}]")
    elif tree is not None:
        try:
            leaf = torch.as_tensor(tree)
        except (TypeError, ValueError, RuntimeError):
            return
        if leaf.dtype.is_floating_point:
            yield path or "<root>", leaf


def first_nonfinite(tree) -> dict:
    """Count the non-finite elements per floating leaf of a nested result:
    {path: count}, {} when clean."""
    bad = {}
    for path, leaf in _leaves(tree):
        n = int((~torch.isfinite(leaf)).sum())
        if n:
            bad[path] = n
    return bad


def assert_all_finite(tree, name="array"):
    """Raise ValueError naming the leaves that hold NaN or Inf."""
    bad = first_nonfinite(tree)
    if bad:
        raise ValueError(f"non-finite values in {name}: {bad}")


def checked(f):
    """Wrap a function so that a NaN or Inf in what it returns raises
    FloatingPointError with the name of the first non-finite output and its
    count. The check reads the result back from the device: for debug runs
    and tests, not the hot path."""

    @functools.wraps(f)
    def wrapper(*args, **kwargs):
        out = f(*args, **kwargs)
        bad = first_nonfinite(out)
        if bad:
            path, n = next(iter(bad.items()))
            raise FloatingPointError(
                f"{getattr(f, '__name__', 'function')}: output {path} holds "
                f"{n} non-finite value(s)")
        return out

    return wrapper
