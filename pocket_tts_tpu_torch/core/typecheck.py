"""Call-time type validation for the public API surface.
Port of pocket_tts_tpu/core/typecheck.py (the port keeps its own copy: the
JAX package's __init__ imports JAX).

A clear TypeError at the public boundary instead of a shape or dtype error
three layers deep, from an explicit per-parameter spec applied to the entry
points users call (TTSModel.load_model, generate_audio(_stream),
get_state_for_audio_prompt, export_model_state), with the JAX package's specs.
"""

from __future__ import annotations

import functools
import inspect


def typechecked(**specs):
    """Validate named parameters against type specs at call time.

    Spec values are a type or a tuple of types; include ``None`` in a tuple to
    allow None. Validation happens when the function is *called* (also for
    generator functions — the check must not be deferred to the first
    ``next()``).
    """

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            for name, exp in specs.items():
                if name not in bound.arguments:
                    continue
                val = bound.arguments[name]
                types = exp if isinstance(exp, tuple) else (exp,)
                allow_none = None in types
                real = tuple(t for t in types if t is not None)
                if val is None:
                    if allow_none:
                        continue
                elif isinstance(val, real):
                    # bool passes isinstance(…, int); reject unless bool is
                    # explicitly allowed (beartype's strictness)
                    if not (isinstance(val, bool) and bool not in real and int in real):
                        continue
                names = " | ".join(
                    ("None" if t is None else t.__name__) for t in types
                )
                raise TypeError(
                    f"{fn.__qualname__}: parameter '{name}' must be {names}, "
                    f"got {type(val).__name__}"
                )
            return fn(*args, **kwargs)

        return wrapper

    return deco
