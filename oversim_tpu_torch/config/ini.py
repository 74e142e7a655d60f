"""OMNeT++-style .ini configuration parser (the port's own copy).

Counterpart of ``oversim_tpu/config/ini.py``, line for line: the port
imports nothing of the JAX package, and this module is pure Python.

Host-side front-end reimplementing the configuration surface the reference
relies on (SURVEY.md §2.6 "Config/CLI"; reference behavior defined by the
OMNeT++ ini format as used in simulations/default.ini + omnetpp.ini):

  * ``[General]`` and ``[Config Name]`` sections; ``extends = Other`` and
    the implicit fallback of every config to General;
  * ``include ./default.ini`` directives (verify.ini:55);
  * hierarchical wildcard parameter keys
    (``**.overlay*.chord.stabilizeDelay = 20s``): ``*`` matches within one
    dot-separated path segment, ``**`` matches across segments;
    first matching assignment wins, searched config-section-first then
    through the extends chain to General (OMNeT++ precedence);
  * value literals: quantities with units (``60s``, ``100B``, ``10Mbps``),
    booleans, ints, floats, quoted strings;
  * ``${a,b,c}`` / ``${x=1..5 step 2}`` parameter-study iteration values
    (thesis.ini:16) — exposed as `Study` objects so a caller can expand
    the cartesian product of run variants.

It runs once at simulation-build time; the resolved values feed the
static dataclass params of the engine (``config/scenario.py``).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

_UNIT_SCALE = {
    "s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9, "ps": 1e-12,
    "m": 60.0, "h": 3600.0, "d": 86400.0,
    "B": 1.0, "KiB": 1024.0, "MiB": 1024.0 ** 2, "GiB": 1024.0 ** 3,
    "KB": 1e3, "MB": 1e6, "GB": 1e9,
    "bps": 1.0, "Kbps": 1e3, "Mbps": 1e6, "Gbps": 1e9,
}

_QUANTITY_RE = re.compile(
    r"^([+-]?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)\s*([a-zA-Z]+)$")
_STUDY_RE = re.compile(r"^\$\{(.*)\}$")


@dataclasses.dataclass(frozen=True)
class Study:
    """A ``${...}`` parameter-study placeholder: iterate ``values``."""

    name: str | None
    values: tuple

    def default(self):
        return self.values[0]


def parse_value(raw: str):
    """Parse one ini value literal into a python object."""
    raw = raw.strip()
    if m := _STUDY_RE.match(raw):
        return _parse_study(m.group(1))
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    low = raw.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if m := _QUANTITY_RE.match(raw):
        num, unit = m.groups()
        if unit in _UNIT_SCALE:
            return float(num) * _UNIT_SCALE[unit]
    return raw  # bare string (module type names etc.)


def _parse_study(body: str) -> Study:
    name = None
    if "=" in body and not body.lstrip().startswith(".."):
        head, body = body.split("=", 1)
        name = head.strip()
    body = body.strip()
    m = re.match(r"^(.+?)\.\.(.+?)(?:\s+step\s+(.+))?$", body)
    if m and "," not in body:
        lo, hi = parse_value(m.group(1)), parse_value(m.group(2))
        step = parse_value(m.group(3)) if m.group(3) else 1
        vals, v = [], lo
        while v <= hi + (1e-12 if isinstance(v, float) else 0):
            vals.append(v)
            v += step
        return Study(name, tuple(vals))
    return Study(name, tuple(parse_value(x) for x in body.split(",")))


def _pattern_to_regex(pattern: str) -> re.Pattern:
    """OMNeT++ wildcard pattern → regex over dot-separated paths."""
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if pattern.startswith("**", i):
            out.append(r".*")
            i += 2
        elif c == "*":
            out.append(r"[^.]*")
            i += 1
        elif c in ".[]{}()+^$|\\?":
            out.append("\\" + c)
            i += 1
        else:
            out.append(re.escape(c))
            i += 1
    return re.compile("^" + "".join(out) + "$")


class IniFile:
    """Parsed ini tree: sections hold ordered (pattern, value) assignments."""

    def __init__(self):
        self.sections: dict[str, list[tuple[str, object]]] = {"General": []}
        self.extends: dict[str, str | None] = {"General": None}
        self._regex_cache: dict[str, re.Pattern] = {}
        self.base_dir = Path(".")   # for ini-relative resources (xml pools)

    # -- loading ------------------------------------------------------------

    @classmethod
    def load(cls, path: str | Path) -> "IniFile":
        ini = cls()
        ini._load_file(Path(path))
        return ini

    @classmethod
    def loads(cls, text: str, base_dir: str | Path = ".") -> "IniFile":
        ini = cls()
        ini._parse(text, Path(base_dir))
        return ini

    def _load_file(self, path: Path):
        self.base_dir = Path(path).parent
        self._parse(path.read_text(), path.parent)

    @staticmethod
    def _strip_comment(raw_line: str) -> str:
        """Drop a '#' comment, but only outside double-quoted strings
        (quoted values may legitimately contain '#')."""
        in_quote = False
        for i, ch in enumerate(raw_line):
            if ch == '"':
                in_quote = not in_quote
            elif ch == "#" and not in_quote:
                return raw_line[:i]
        return raw_line

    def _parse(self, text: str, base_dir: Path):
        current = "General"
        for raw_line in text.splitlines():
            line = self._strip_comment(raw_line).strip()
            if not line:
                continue
            # whole-word match: keys like 'includeTraffic = x' are plain
            # assignments, not include directives
            if re.match(r"^include\s", line):
                inc = line.split(None, 1)[1].strip()
                self._load_file(base_dir / inc)
                continue
            if line.startswith("["):
                name = line.strip("[]").strip()
                if name.startswith("Config "):
                    name = name[len("Config "):].strip()
                current = name
                self.sections.setdefault(current, [])
                self.extends.setdefault(
                    current, None if current == "General" else "General")
                continue
            if "=" not in line:
                continue
            key, val = line.split("=", 1)
            key, val = key.strip(), val.strip()
            if key == "extends":
                self.extends[current] = val.strip('"')
                continue
            self.sections.setdefault(current, []).append(
                (key, parse_value(val)))

    # -- resolution ---------------------------------------------------------

    def _chain(self, config: str):
        seen = []
        cur: str | None = config
        while cur is not None and cur not in seen:
            if cur in self.sections:
                seen.append(cur)
            cur = self.extends.get(cur, "General" if cur != "General" else None)
        if "General" not in seen and "General" in self.sections:
            seen.append("General")
        return seen

    def _match(self, pattern: str, path: str) -> bool:
        rx = self._regex_cache.get(pattern)
        if rx is None:
            rx = self._regex_cache[pattern] = _pattern_to_regex(pattern)
        return rx.match(path) is not None

    def get(self, path: str, config: str = "General", default=None):
        """Resolve a full parameter path (e.g.
        ``OverSim.overlayTerminal[3].overlay.chord.stabilizeDelay``) the
        OMNeT++ way: first matching assignment, config chain order."""
        for section in self._chain(config):
            for pattern, value in self.sections[section]:
                if self._match(pattern, path):
                    return value
        return default

    def study_variables(self, config: str = "General") -> dict[str, Study]:
        """All ${...} study placeholders reachable from ``config``."""
        out = {}
        for section in self._chain(config):
            for pattern, value in self.sections[section]:
                if isinstance(value, Study):
                    out.setdefault(value.name or pattern, value)
        return out

    def configs(self):
        return [s for s in self.sections if s != "General"]

    def with_overrides(self, config: str, pairs: dict[str, object]) -> str:
        """Create a derived config section holding ``pairs`` as highest-
        priority assignments; returns its name.  Used to pin one variant
        of a parameter study."""
        name = config
        i = 0
        while name in self.sections:
            i += 1
            name = f"{config}#{i}"
        self.sections[name] = list(pairs.items())
        self.extends[name] = config
        return name

    def expand_study_runs(self, config: str = "General"):
        """Expand ``${...}`` parameter studies into the cartesian product
        of run variants (OMNeT++ run expansion, thesis.ini:16).

        Yields (label, config_name) pairs; each config_name is a derived
        section pinning one combination under the study's original
        pattern key.  With no studies, yields the plain config once.
        """
        import itertools

        entries: list[tuple[str, Study]] = []
        seen = set()
        for section in self._chain(config):
            for pattern, value in self.sections[section]:
                if isinstance(value, Study):
                    key = value.name or pattern
                    if key not in seen:
                        seen.add(key)
                        entries.append((pattern, value))
        if not entries:
            yield "", config
            return
        for combo in itertools.product(*(s.values for _, s in entries)):
            label = ",".join(f"{s.name or p}={v}"
                             for (p, s), v in zip(entries, combo))
            pairs = {p: v for (p, _), v in zip(entries, combo)}
            yield label, self.with_overrides(config, pairs)
