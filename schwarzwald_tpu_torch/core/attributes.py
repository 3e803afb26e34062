"""Point attributes and per-format supported sets.

Parity: PointAttribute enum (schwarzwald/core/pointcloud/PointAttributes.h:
15-31), RGBMapping (:37-44), string names (:46-97), and the per-output-format
supported attribute sets (schwarzwald/core/io/PointsPersistence.cpp:45-62 and
the supported_output_attributes() of each sink).
"""
from __future__ import annotations

import enum


class PointAttribute(enum.Enum):
    Position = "POSITION"
    RGB = "RGB"
    Intensity = "INTENSITY"
    Classification = "CLASSIFICATION"
    Normal = "NORMAL"
    GPSTime = "GPS_TIME"
    EdgeOfFlightLine = "EDGE_OF_FLIGHT_LINE"
    NumberOfReturns = "NUMBER_OF_RETURNS"
    ReturnNumber = "RETURN_NUMBER"
    PointSourceID = "POINT_SOURCE_ID"
    ScanAngleRank = "SCAN_ANGLE_RANK"
    ScanDirectionFlag = "SCAN_DIRECTION_FLAG"
    UserData = "USER_DATA"


class RGBMapping(enum.Enum):
    Nothing = "NONE"
    FromIntensityLinear = "INTENSITY_LINEAR"
    FromIntensityLogarithmic = "INTENSITY_LOG"


ALL_ATTRIBUTES = frozenset(PointAttribute)

# Column dtype + shape per attribute as stored in PointBuffer
# (schwarzwald/core/datastructures/PointBuffer.h:290-305).
ATTRIBUTE_LAYOUT = {
    PointAttribute.Position: ("f8", 3),
    PointAttribute.RGB: ("u1", 3),
    PointAttribute.Normal: ("f4", 3),
    PointAttribute.Intensity: ("u2", 1),
    PointAttribute.Classification: ("u1", 1),
    PointAttribute.EdgeOfFlightLine: ("u1", 1),
    PointAttribute.GPSTime: ("f8", 1),
    PointAttribute.NumberOfReturns: ("u1", 1),
    PointAttribute.ReturnNumber: ("u1", 1),
    PointAttribute.PointSourceID: ("u2", 1),
    PointAttribute.ScanDirectionFlag: ("u1", 1),
    PointAttribute.ScanAngleRank: ("i1", 1),
    PointAttribute.UserData: ("u1", 1),
}


class OutputFormat(enum.Enum):
    CZM_3DTILES = "3DTILES"
    BIN = "BIN"
    BINZ = "BINZ"
    LAS = "LAS"
    LAZ = "LAZ"
    ENTWINE_LAS = "ENTWINE_LAS"
    ENTWINE_LAZ = "ENTWINE_LAZ"


# Cesium3DTilesPersistence::supported_output_attributes
# (Cesium3DTilesPersistence.cpp:18-22)
_3DTILES_ATTRS = frozenset(
    {PointAttribute.Position, PointAttribute.RGB, PointAttribute.Intensity}
)
# LASPersistence::supported_output_attributes (LASPersistence.cpp:30-40):
# everything except Normal is writable to LAS point formats; the reference
# includes Normal in the declared set but LAS has no normal field, keep parity
# with the declared set.
_LAS_ATTRS = ALL_ATTRIBUTES
# BinaryPersistence supports everything (BinaryPersistence.h:24-36).
_BIN_ATTRS = ALL_ATTRIBUTES


def supported_output_attributes_for_format(fmt: OutputFormat) -> frozenset:
    if fmt == OutputFormat.CZM_3DTILES:
        return _3DTILES_ATTRS
    if fmt in (OutputFormat.LAS, OutputFormat.LAZ, OutputFormat.ENTWINE_LAS,
               OutputFormat.ENTWINE_LAZ):
        return _LAS_ATTRS
    return _BIN_ATTRS


def print_attributes(attrs) -> str:
    return "[" + ", ".join(sorted(a.value for a in attrs)) + "]"
