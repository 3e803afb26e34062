"""Persistence facade + factory.

Parity: PointsPersistence (schwarzwald/core/io/PointsPersistence.{h,cpp}):
the variant facade is plain duck typing here (all sinks implement
persist_points / retrieve_points / node_exists / is_lossless / close);
make_persistence (:5-43) selects by OutputFormat, and
supported_output_attributes_for_format comes from core.attributes.
"""
from __future__ import annotations

from ..core.attributes import OutputFormat, RGBMapping
from .bin_persistence import BinaryPersistence
from .cesium3dtiles import Cesium3DTilesPersistence
from .entwine import EntwinePersistence
from .las_persistence import LASPersistence
from .memory import MemoryPersistence  # noqa: F401 (part of the facade)


def make_persistence(output_format: OutputFormat, output_directory: str,
                     input_attributes, output_attributes,
                     rgb_mapping: RGBMapping = RGBMapping.Nothing,
                     spacing_at_root: float = 0.0, total_bounds=None,
                     extended: bool = False,
                     laz_extended_output: bool = False):
    if output_format == OutputFormat.CZM_3DTILES:
        global_offset = (total_bounds.center() if total_bounds is not None
                         else (0.0, 0.0, 0.0))
        return Cesium3DTilesPersistence(
            output_directory, input_attributes, output_attributes,
            rgb_mapping, spacing_at_root, global_offset)
    if output_format in (OutputFormat.BIN, OutputFormat.BINZ):
        return BinaryPersistence(
            output_directory, input_attributes, output_attributes,
            compressed=(output_format == OutputFormat.BINZ))
    if output_format in (OutputFormat.LAS, OutputFormat.LAZ):
        return LASPersistence(
            output_directory, input_attributes, output_attributes,
            compressed=(output_format == OutputFormat.LAZ),
            extended=extended, laz_extended_output=laz_extended_output)
    if output_format in (OutputFormat.ENTWINE_LAS, OutputFormat.ENTWINE_LAZ):
        return EntwinePersistence(
            output_directory, input_attributes, output_attributes,
            compressed=(output_format == OutputFormat.ENTWINE_LAZ),
            extended=extended, laz_extended_output=laz_extended_output)
    raise ValueError(f"Unrecognized output format {output_format}")
