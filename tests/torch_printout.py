"""Printed-output comparison for the port's examples and tools, in one
place for both of its users: the port against the JAX twin on the CPU
(tests/test_torch_examples*.py, tests/test_torch_tools*.py) and the card
against ``--device cpu`` (chip_smoke.py phase 11).

Imports neither jax nor torch; chip_smoke.py reads it by path.

Two printouts agree when, line by line, their text with every number taken
out is equal (whitespace aside, so a padded column may widen) and each
pair of numbers agrees: integers exactly, a decimal number within one unit
of the last place printed (the finer of the two; a value printed with more
than ``MAX_DECIMALS`` places is a float's repr, held within
``10 ** -MAX_DECIMALS``).  A value on a rounding edge prints differently
with no fault, which is why one unit is allowed.
"""
import re

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")
MAX_DECIMALS = 6


def _decimals(token: str) -> int:
    mantissa, _, exponent = token.lower().partition("e")
    places = len(mantissa.partition(".")[2])
    return places - int(exponent or 0)


def _skeleton(line: str) -> str:
    return "".join(NUMBER.sub("#", line).split())


def line_diff(a: str, b: str):
    """Why two printed lines disagree, or None when they agree."""
    if _skeleton(a) != _skeleton(b):
        return f"text differs: {a!r} vs {b!r}"
    for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)):
        exact = not any(c in t for t in (x, y) for c in ".eE")
        if exact:
            if int(x) != int(y):
                return f"count {x} vs {y} in {a!r} vs {b!r}"
            continue
        tol = 10.0 ** -min(max(_decimals(x), _decimals(y)), MAX_DECIMALS)
        if abs(float(x) - float(y)) > tol * (1 + 1e-9):
            return f"{x} vs {y} (one printed unit {tol:g}) in {a!r} vs {b!r}"
    return None


def printout_diff(a_lines, b_lines, skip=()):
    """Every disagreement between two printouts (lists of lines), leaving
    out blank lines and lines that contain any of ``skip`` (timings)."""
    def keep(lines):
        return [ln for ln in lines if ln.strip() and not any(s in ln for s in skip)]

    a, b = keep(a_lines), keep(b_lines)
    if len(a) != len(b):
        return [f"{len(a)} lines vs {len(b)}"]
    return [d for d in (line_diff(x, y) for x, y in zip(a, b)) if d]


def captured(fn, *args, **kw):
    """fn(*args, **kw) -> (its result, the lines it printed)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return result, out.getvalue().splitlines()


def run_as_main(target: str, argv):
    """Run a script's path (``*.py``) as ``__main__`` with ``sys.argv`` set,
    or call a module's ``main(argv)`` -> (exit code, printed lines)."""
    import contextlib
    import importlib
    import io
    import runpy
    import sys

    old, out, code = sys.argv, io.StringIO(), 0
    sys.argv = [target] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            if target.endswith(".py"):
                runpy.run_path(target, run_name="__main__")
            else:
                importlib.import_module(target).main(list(argv))
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
    return code, out.getvalue().splitlines()
