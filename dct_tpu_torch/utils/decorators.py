"""Argument checks as decorators (``dct_tpu/utils/decorators.py``):
``accepts`` holds the arguments to the function's type annotations,
``onehot`` holds named tensor arguments one-hot along the last (class)
axis. Both skip a value that ``torch.jit`` or ``torch.fx`` is tracing."""
from __future__ import annotations

import functools
import inspect
import typing
from typing import Sequence

from .general import _is_traced, one_hot


def accepts(func):
    """Check call arguments against the function's type annotations.
    Annotation containers (``List[int]`` etc.) check the origin type only."""
    sig = inspect.signature(func)
    hints = typing.get_type_hints(func)

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        for name, value in bound.arguments.items():
            if name not in hints or _is_traced(value):
                continue
            expected = hints[name]
            origin = typing.get_origin(expected) or expected
            if origin is typing.Union:
                options = tuple(typing.get_origin(t) or t
                                for t in typing.get_args(expected)
                                if t is not type(None))
                ok = value is None or isinstance(value, options)
            else:
                try:
                    ok = isinstance(value, origin)
                except TypeError:
                    ok = True
            assert ok, (f"{func.__name__}: argument {name!r} expected "
                        f"{expected}, got {type(value)}")
        return func(*args, **kwargs)

    return wrapper


def onehot(*arg_names: Sequence[str]):
    """Assert the named arguments are one-hot along the class (last) axis."""
    def deco(func):
        sig = inspect.signature(func)

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            for name in arg_names:
                value = bound.arguments.get(name)
                if value is None or _is_traced(value):
                    continue
                assert one_hot(value), \
                    f"{func.__name__}: argument {name!r} is not one-hot"
            return func(*args, **kwargs)

        return wrapper
    return deco
