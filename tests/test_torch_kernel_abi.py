"""The kernels' C interface against the ctypes table that binds it.

``kernels._SIGNATURES`` tells ctypes each exported function's argument
types.  ctypes passes whatever it is told, so a C signature that changes
without the table would pass wrong pointers silently on the card.  Each
``extern "C"`` declaration in ``oversim_tpu_torch/csrc/*.cu`` is parsed
here (text only) and held to the table: the same functions per source,
the same number and order of pointer and int arguments, an int result.
The wrappers size each kernel's scratch from tile constants of their own
(``scratch_words``); those are held to the sources' ``#define``s too.
"""

import ctypes
import pathlib
import re

import pytest

from oversim_tpu_torch import kernels
from oversim_tpu_torch.kernels import compact, inbox, outbox

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


_DEFINE = re.compile(r"^#define\s+(\w+)\s+(.+?)\s*(?://.*)?$", re.M)


def c_defines(source):
    """Integer ``#define``s of ``csrc/<source>.cu`` and the headers under
    ``csrc/``, each evaluated (products and sums of earlier ones)."""
    text = "".join(p.read_text() for p in sorted(CSRC.glob("*.cuh")))
    text += (CSRC / f"{source}.cu").read_text()
    out = {}
    for name, expr in _DEFINE.findall(text):
        expr = re.sub(r"\w+", lambda m: str(out.get(m.group(0),
                                                     m.group(0))), expr)
        if re.fullmatch(r"[\d\s()*+-]+", expr):
            out[name] = eval(expr, {"__builtins__": {}})
    return out


@pytest.mark.parametrize("source,define,value", [
    ("compact", "COMPACT_TILE", compact.TILE),
    ("outbox", "TILE", outbox.TILE),
    ("inbox", "SCAN_TILE", inbox.SCAN_TILE),
    ("inbox", "MAX_R", inbox.MAX_R)])
def test_wrapper_tile_constants_match_sources(source, define, value):
    assert c_defines(source)[define] == value


@pytest.mark.parametrize("m", [0, 1, compact.TILE - 1, compact.TILE,
                               compact.TILE + 1, 65_536])
def test_compact_scratch_holds_every_tile_status(m):
    """Two words (tile counter, pad) and one 64-bit status word for each
    tile the launch starts (csrc/compact.cu ``tiles_of``)."""
    tiles = max(1, -(-m // compact.TILE))
    assert compact.scratch_words(m) == 2 + 2 * tiles
