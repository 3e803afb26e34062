"""The port's LAZ codec against the committed escrow corpus
(tests/golden/laz_escrow): the nine specs of tests/test_laz_escrow.py
(pointwise formats 0-3 with compressor 2, layered formats 6-8 with
compressor 3, default and 4,096-point chunks), written by the port's
`io.laz` through the native library built from the port's own C++ copy
(schwarzwald_tpu_torch/native/src), must hash to the manifest's
`file_sha256`, their records to `records_sha256`, and the port's reader
must decode every committed file to exactly those records. Exact: hashes
and bytes, tolerance 0."""
import hashlib
import json
import os

import numpy as np
import pytest

from schwarzwald_tpu_torch import native
from schwarzwald_tpu_torch.io import las, laz
from schwarzwald_tpu_torch.native import loader

from test_laz_escrow import CORPUS_DIR, MANIFEST, SPECS, _records

PORT_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "schwarzwald_tpu_torch", "native", "src")


def header(fmt, n):
    """The escrow corpus's header (tests/test_laz_escrow.py `_header`),
    built with the port's LAS module."""
    minor = 4 if fmt >= 6 else 2
    hsize = las.HEADER_SIZE_14 if minor == 4 else 227
    return las.LASHeader(
        version_minor=minor, point_data_format=fmt,
        point_record_length=las.record_length_for_format(fmt),
        point_count=n, scale=np.full(3, 0.01), offset=np.zeros(3),
        mins=np.zeros(3), maxs=np.full(3, 100.0),
        offset_to_point_data=hsize, header_size=hsize)


@pytest.fixture(scope="module")
def manifest():
    with open(MANIFEST) as f:
        return json.load(f)


def test_codec_is_built_from_the_ports_own_sources():
    assert native.las_codec() is not None
    assert [os.path.dirname(s) for s in loader._SRCS] == [PORT_SRC] * 2
    assert all(os.path.exists(s) for s in loader._SRCS)


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_port_writes_the_escrow_bytes(manifest, tmp_path, spec):
    name, fmt, n, chunk, seed = spec
    entry = manifest[name]
    rec = _records(fmt, n, seed)
    assert hashlib.sha256(np.ascontiguousarray(rec).view(np.uint8)
                          ).hexdigest() == entry["records_sha256"]
    path = tmp_path / f"{name}.laz"
    laz.write_laz(str(path), header(fmt, n), rec, chunk_size=chunk)
    blob = path.read_bytes()
    assert len(blob) == entry["file_bytes"]
    assert hashlib.sha256(blob).hexdigest() == entry["file_sha256"]


@pytest.mark.parametrize("spec", SPECS, ids=[s[0] for s in SPECS])
def test_port_decodes_the_committed_corpus(manifest, spec):
    name, fmt, n, chunk, seed = spec
    path = os.path.join(CORPUS_DIR, name + ".laz")
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == \
            manifest[name]["file_sha256"]
    f = las.LASFile(path)
    assert f.header.point_data_format == fmt and f.count == n
    got = laz.LAZReader(path, f.header).read_records(0, n)
    np.testing.assert_array_equal(
        np.asarray(got, dtype=np.uint8).reshape(-1),
        np.ascontiguousarray(_records(fmt, n, seed)).view(np.uint8)
        .reshape(-1), err_msg=name)
