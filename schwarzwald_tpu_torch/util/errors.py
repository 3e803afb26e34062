"""Recoverable-error machinery.

Parity: util::IgnoreErrors bitflags + parsing (schwarzwald/core/util/
Error.h:20-103, main.cpp:150-186) and ErrorChain nested-cause exceptions
(Error.h:105-118). Every file touchpoint consults the flags: missing /
inaccessible files, unsupported formats, corrupted files, and missing point
attributes.
"""
from __future__ import annotations

import enum


class IgnoreErrors(enum.IntFlag):
    NONE = 0
    MISSING_FILES = 1 << 0
    INACCESSIBLE_FILES = 1 << 1
    UNSUPPORTED_FILE_FORMAT = 1 << 2
    CORRUPTED_FILES = 1 << 3
    MISSING_POINT_ATTRIBUTES = 1 << 4

    @classmethod
    def all_file_errors(cls) -> "IgnoreErrors":
        return (cls.MISSING_FILES | cls.INACCESSIBLE_FILES
                | cls.UNSUPPORTED_FILE_FORMAT | cls.CORRUPTED_FILES)

    @classmethod
    def all_errors(cls) -> "IgnoreErrors":
        return cls.all_file_errors() | cls.MISSING_POINT_ATTRIBUTES


_NAMES = {
    "NONE": IgnoreErrors.NONE,
    "MISSING_FILES": IgnoreErrors.MISSING_FILES,
    "INACCESSIBLE_FILES": IgnoreErrors.INACCESSIBLE_FILES,
    "UNSUPPORTED_FILE_FORMAT": IgnoreErrors.UNSUPPORTED_FILE_FORMAT,
    "CORRUPTED_FILES": IgnoreErrors.CORRUPTED_FILES,
    "MISSING_POINT_ATTRIBUTES": IgnoreErrors.MISSING_POINT_ATTRIBUTES,
    "ALL_FILE_ERRORS": IgnoreErrors.all_file_errors(),
    "ALL_ERRORS": IgnoreErrors.all_errors(),
}


def parse_ignore_errors(tokens) -> IgnoreErrors:
    """Compositional parse of --ignore values (main.cpp:150-186)."""
    flags = IgnoreErrors.NONE
    for token in tokens:
        token = token.strip().upper()
        if token not in _NAMES:
            raise ValueError(
                f"Unrecognized --ignore value '{token}'. Valid values: "
                + ", ".join(_NAMES))
        flags |= _NAMES[token]
    return flags


class ChainedError(RuntimeError):
    """chain_error (Error.h:105-118): an error with an explicit cause chain,
    printed as 'msg\\n\\tcaused by: ...'."""

    def __init__(self, message: str, cause: Exception | None = None):
        self.cause = cause
        super().__init__(message)

    def __str__(self) -> str:
        msg = super().__str__()
        if self.cause is not None:
            return f"{msg}\n\tcaused by: {self.cause}"
        return msg


def chain_error(cause: Exception, message: str) -> ChainedError:
    return ChainedError(message, cause)
