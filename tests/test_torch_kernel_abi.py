"""The kernels' C interface against the ctypes table that binds it.

``kernels._SIGNATURES`` tells ctypes each exported function's argument
types.  ctypes passes whatever it is told, so a C signature that changes
without the table would pass wrong pointers silently on the card.  Each
``extern "C"`` declaration in ``oversim_tpu_torch/csrc/*.cu`` is parsed
here (text only) and held to the table: the same functions per source,
the same number and order of pointer and int arguments, an int result.
"""

import ctypes
import pathlib
import re

import pytest

from oversim_tpu_torch import kernels

CSRC = pathlib.Path(kernels.CSRC)
_DECL = re.compile(r'extern\s+"C"\s+(\w+)\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_exports():
    """{(source, function): (result type, [argument kinds])}, where an
    argument kind is "ptr" or "int"."""
    out = {}
    for path in sorted(CSRC.glob("*.cu")):
        for result, name, args in _DECL.findall(path.read_text()):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append("ptr")
                elif re.fullmatch(r"(const )?int \w+", arg):
                    kinds.append("int")
                else:
                    kinds.append(f"unsupported: {arg}")
            out[(path.stem, name)] = (result, kinds)
    return out


def table_exports():
    kind = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}
    return {(src, name): [kind.get(t, repr(t)) for t in argtypes]
            for src, fns in kernels._SIGNATURES.items()
            for name, argtypes in fns.items()}


EXPORTS = sorted(set(c_exports()) | set(table_exports()))


def test_every_source_is_built_and_bound():
    assert sorted(kernels.SOURCES) == sorted(p.stem
                                             for p in CSRC.glob("*.cu"))
    assert sorted(kernels._SIGNATURES) == sorted(kernels.SOURCES)
    assert len(EXPORTS) >= 4


@pytest.mark.parametrize("source,function", EXPORTS)
def test_c_signature_matches_ctypes_table(source, function):
    c, table = c_exports(), table_exports()
    assert (source, function) in c, "bound but not exported by the source"
    assert (source, function) in table, "exported but not in _SIGNATURES"
    result, kinds = c[(source, function)]
    assert result == "int"
    assert kinds == table[(source, function)]
    assert kinds[-1] == "ptr", "the stream comes last"
