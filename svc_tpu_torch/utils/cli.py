"""Command-line option parser with the reference's flag semantics (a copy
of ``svc_tpu/utils/cli.py``).

Re-implements the contract of ``cli::ParseOpts``
(reference: libs/cli.hpp:17-56, libs/cli.cpp:14-75):

* options are ``--name value`` pairs and must come before positionals,
* a bare ``--`` terminates option parsing,
* values are converted according to the declared type with C ``sscanf``
  prefix semantics (``"12abc"`` parses as int 12),
* unknown option names, missing arguments, and unconvertible values map to
  the same status codes and messages as the reference.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class OptArgType(enum.Enum):
    INT = 0
    UINT = 1
    FLOAT = 2
    STRING = 3  # sscanf %s semantics: first whitespace token (reference)
    PATH = 4  # framework extensions: the whole argv element (paths may
    #           contain spaces; %s token truncation would lose data)


class Status(enum.Enum):
    OK = 0
    INVALID_OPT_ARG_TYPE = 1
    MISSING_OPT_ARG = 2
    INVALID_OPT_ARG = 3
    UNEXPECTED_OPT_NAME = 4


# Same status strings as the reference (libs/cli.cpp:8-10).
_STATUS_MESSAGES = {
    Status.OK: "success",
    Status.INVALID_OPT_ARG_TYPE: "invalid option argument type",
    Status.MISSING_OPT_ARG: "missing option argument",
    Status.INVALID_OPT_ARG: "invalid option argument",
    Status.UNEXPECTED_OPT_NAME: "unexpected option name",
}


def status_message(s: Status) -> str:
    return _STATUS_MESSAGES[s]


@dataclasses.dataclass
class Opt:
    name: str
    arg_type: OptArgType
    # Called with the converted value when the option is seen.
    setter: Callable[[Any], None]


# sscanf-style prefix matchers: %d / %u accept an optional sign followed by
# digits; %f accepts standard C float syntax. Only the longest valid prefix
# is consumed; parsing fails when no prefix matches (sscanf returns 0).
_INT_RE = re.compile(r"^[ \t]*[+-]?\d+")
_FLOAT_RE = re.compile(
    r"^[ \t]*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
)


def _sscanf_int(text: str) -> Optional[int]:
    m = _INT_RE.match(text)
    return int(m.group()) if m else None


def _sscanf_uint(text: str) -> Optional[int]:
    # C sscanf %u with a negative input wraps modulo 2**32; the reference
    # passes through that wrap (libs/cli.cpp:45-47). Replicate it.
    m = _INT_RE.match(text)
    if m is None:
        return None
    return int(m.group()) % (1 << 32)


def _sscanf_float(text: str) -> Optional[float]:
    m = _FLOAT_RE.match(text)
    return float(m.group()) if m else None


def parse_opts(
    argv: Sequence[str], opts: Sequence[Opt]
) -> Tuple[Status, int]:
    """Parse leading ``--name value`` options from ``argv``.

    ``argv`` includes the program name at index 0, matching the reference's
    ``ParseOpts(argc, argv, ...)`` call shape. Returns ``(status, argi)``
    where ``argi`` is one past the last successfully parsed option
    (reference: libs/cli.cpp:14-75).
    """
    by_name: Dict[str, Opt] = {o.name: o for o in opts}

    i = 1
    n = len(argv)
    while i < n and argv[i].startswith("--"):
        if argv[i] == "--":
            i += 1
            break

        if i + 1 >= n:
            return Status.MISSING_OPT_ARG, i

        name = argv[i][2:]
        opt = by_name.get(name)
        if opt is None:
            return Status.UNEXPECTED_OPT_NAME, i

        raw = argv[i + 1]
        value: Any
        if opt.arg_type == OptArgType.INT:
            value = _sscanf_int(raw)
        elif opt.arg_type == OptArgType.UINT:
            value = _sscanf_uint(raw)
        elif opt.arg_type == OptArgType.FLOAT:
            value = _sscanf_float(raw)
        elif opt.arg_type == OptArgType.STRING:
            value = raw.split()[0] if raw.split() else None
        elif opt.arg_type == OptArgType.PATH:
            value = raw if raw else None
        else:  # pragma: no cover - enum is closed
            return Status.INVALID_OPT_ARG_TYPE, i

        if value is None:
            return Status.INVALID_OPT_ARG, i

        opt.setter(value)
        i += 2

    return Status.OK, i


def field_setter(obj: Any, field: str) -> Callable[[Any], None]:
    """Convenience setter targeting an attribute, mirroring the reference's
    pointer-to-member option table style (apps/encoder.cpp:75-104)."""

    def set_(value: Any) -> None:
        setattr(obj, field, value)

    return set_
