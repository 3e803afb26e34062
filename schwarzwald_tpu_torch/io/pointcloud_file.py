"""Point-file facade: the designed extension point for input formats.

Parity: the PointcloudFile trait interface + factory (schwarzwald/core/io/
PointcloudFile.h, PointcloudFactory.{h,cpp}): open_point_file dispatches on
the file extension to a reader object exposing bounds / count / attributes
/ batched reads. Currently LAS (and gated LAZ); new formats register here.
"""
from __future__ import annotations

import os

from ..util.errors import chain_error
from . import las

_SUPPORTED = {".las": las.LASFile, ".laz": las.LASFile}


def file_format_is_supported(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _SUPPORTED


def open_point_file(path: str):
    ext = os.path.splitext(path)[1].lower()
    opener = _SUPPORTED.get(ext)
    if opener is None:
        raise ValueError(f"Unsupported point file format: {path}")
    try:
        return opener(path)
    except Exception as err:
        raise chain_error(err, f"Could not open point file {path}")


def get_bounds(point_file) -> object:
    return point_file.header.bounds()


def get_point_count(point_file) -> int:
    return point_file.count


def has_attribute(point_file, attribute) -> bool:
    return attribute in point_file.attributes()
