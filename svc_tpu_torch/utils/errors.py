"""Typed error results for config validation (a copy of
``svc_tpu/utils/errors.py``).

Mirrors the reference's ``Error{code, message}`` contract
(reference: libs/error.hpp:6-11) so CLI behavior and validation
messages stay compatible.
"""

from __future__ import annotations

import dataclasses
import enum


class ErrorCode(enum.Enum):
    OK = 0
    UNSPECIFIED = 1
    INVALID_PARAMETER = 2


@dataclasses.dataclass
class Error:
    code: ErrorCode = ErrorCode.OK
    message: str = ""

    @property
    def ok(self) -> bool:
        return self.code == ErrorCode.OK

    def __bool__(self) -> bool:  # truthy when an actual error occurred
        return not self.ok


OK = Error(ErrorCode.OK, "")
