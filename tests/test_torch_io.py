"""The port's GeoJSON, raster and stream import against the JAX package.

The 4 cases of tests/test_geo_import.py, the 7 of
tests/test_raster_import.py and the 9 of tests/test_stream_ingest.py
(the Kafka adapter against that file's fake broker), each run as one
scenario through both packages: the same rows, counts, statistics and
errors.  Then the port's own: a stream importer's batches into a table
past eager_staging_min_rows each upload the whole table again (the rule
of `_maybe_prestage`, counted in `h2d_bytes`).

Every value is compared exactly, but sums of DOUBLE values within rtol
1e-9.
"""

import importlib
import json
import os

import numpy as np
import pytest

from heavydb_tpu_torch.exec.batch import bucket
from test_raster_import import ASC, _write_geotiff
from test_stream_ingest import _FakeKafkaBroker, _FakeKafkaMessage
from torch_pair import PORT, both, raises_in_both


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.pkg}.{name}")


def _write(p, doc, name="data.geojson"):
    os.makedirs(p, exist_ok=True)
    path = os.path.join(p, name)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# ---------------------------------------------------------------------------
# tests/test_geo_import.py
# ---------------------------------------------------------------------------


def _points_with_properties(pkg, p):
    doc = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "Point", "coordinates": [1.0, 2.0]},
         "properties": {"name": "a", "pop": 10, "area": 1.5}},
        {"type": "Feature", "geometry": {"type": "Point", "coordinates": [3.0, 4.0]},
         "properties": {"name": "b", "pop": 20, "area": None}}]}
    db = pkg.connect()
    r = db.sql(f"COPY pts FROM '{_write(p, doc)}' WITH (source_type='geo_file')").rows()
    return (r, db.sql("SELECT name, pop, area, ST_X(geom), ST_Y(geom) FROM pts "
                      "ORDER BY name").rows(), db.sql("DESCRIBE pts").rows())


def _polygons_promote(pkg, p):
    doc = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {"type": "Polygon", "coordinates": [
            [[0, 0], [4, 0], [4, 4], [0, 4], [0, 0]]]}, "properties": {"tag": "square"}},
        {"type": "Feature", "geometry": {"type": "MultiPolygon", "coordinates": [
            [[[10, 10], [12, 10], [12, 12], [10, 12], [10, 10]]],
            [[[20, 20], [21, 20], [21, 21], [20, 21], [20, 20]]]]},
         "properties": {"tag": "two"}}]}
    db = pkg.connect()
    db.sql(f"COPY polys FROM '{_write(p, doc)}' WITH (source_type='geojson')")
    return (db.sql("SELECT tag, ST_AREA(geom) FROM polys ORDER BY tag").rows(),
            db.sql("DESCRIBE polys").rows())


def _autodetect_spatial(pkg, p):
    feats = [{"type": "Feature", "geometry": {"type": "Point", "coordinates": [float(i), 0.0]},
              "properties": {"i": i}} for i in range(10)]
    db = pkg.connect()
    db.sql(f"COPY gpts FROM '{_write(p, {'type': 'FeatureCollection', 'features': feats})}'")
    return db.sql("SELECT count(*) FROM gpts WHERE ST_DISTANCE(geom, 'POINT (0 0)') < 3.5").rows()


def _bare_and_missing(pkg, p):
    db = pkg.connect()
    db.sql(f"COPY bare FROM '{_write(p, {'type': 'Point', 'coordinates': [5.0, 6.0]})}' "
           "WITH (source_type='geo_file')")
    out = [db.sql("SELECT ST_X(geom) FROM bare").rows()]
    doc = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": None, "properties": {"i": 1}},
        {"type": "Feature", "geometry": {"type": "Point", "coordinates": [1.0, 1.0]},
         "properties": {"i": 2}}]}
    db.sql(f"COPY ng FROM '{_write(p, doc, 'nulls.geojson')}'")
    return out + [db.sql("SELECT i, geom IS NULL FROM ng ORDER BY i").rows()]


# ---------------------------------------------------------------------------
# tests/test_raster_import.py
# ---------------------------------------------------------------------------


def _asc(p):
    os.makedirs(p, exist_ok=True)
    path = os.path.join(p, "g.asc")
    with open(path, "w") as f:
        f.write(ASC)
    return path


def _esri_world(pkg, p):
    db = pkg.connect()
    db.sql(f"COPY rast FROM '{_asc(p)}' WITH (source_type='raster_file')")
    return db.sql("SELECT raster_lon, raster_lat, band_1_1 FROM rast "
                  "ORDER BY raster_lat DESC, raster_lon").rows()


def _esri_file_coords(pkg, p):
    db = pkg.connect()
    db.sql(f"COPY rast2 FROM '{_asc(p)}' WITH (source_type='raster_file', "
           "raster_point_transform='none', raster_drop_if_all_null='true')")
    return db.sql("SELECT raster_x, raster_y, band_1_1 FROM rast2 "
                  "ORDER BY raster_y, raster_x").rows()


def _xyz(pkg, p):
    os.makedirs(p)
    path = os.path.join(p, "pts.xyz")
    with open(path, "w") as f:
        f.write("10 20 1.5\n11 21 2.5\n")
    db = pkg.connect()
    db.sql(f"COPY xyz FROM '{path}' WITH (source_type='raster_file')")
    return db.sql("SELECT raster_lon, raster_lat, band_1_1 FROM xyz ORDER BY raster_lon").rows()


def _point_type_point(pkg, p):
    db = pkg.connect()
    db.sql(f"COPY rastp FROM '{_asc(p)}' WITH (source_type='raster_file', "
           "raster_point_type='point')")
    return db.sql("SELECT ST_X(raster_point), band_1_1 FROM rastp WHERE band_1_1 = 6 "
                  "ORDER BY 1").rows()


def _geotiff(pkg, p):
    os.makedirs(p)
    path = os.path.join(p, "g.tif")
    _write_geotiff(path, np.array([[10, 20], [30, 40]], dtype=np.int32),
                   scale=(0.1, 0.1, 0.0), tiepoint=(0, 0, 0, 5.0, 50.0, 0))
    db = pkg.connect()
    db.sql(f"COPY tif FROM '{path}' WITH (source_type='raster_file')")
    return db.sql("SELECT raster_lon, raster_lat, band_1_I FROM tif "
                  "ORDER BY raster_lat DESC, raster_lon").rows()


def _geotiff_nodata(pkg, p):
    os.makedirs(p)
    path = os.path.join(p, "n.tif")
    _write_geotiff(path, np.array([[1, 7], [7, 4]], dtype=np.uint8), scale=(1.0, 1.0, 0.0),
                   tiepoint=(0, 0, 0, 0.0, 2.0, 0), nodata=7)
    db = pkg.connect()
    db.sql(f"COPY tifn FROM '{path}' WITH (source_type='raster_file', "
           "raster_import_bands='band_1_L', raster_point_transform='none')")
    return (db.sql("SELECT band_1_L FROM tifn ORDER BY raster_y, raster_x").rows(),
            db.sql("SELECT COUNT(band_1_L) FROM tifn").rows())


def _unknown_extension(pkg, p):
    os.makedirs(p)
    path = os.path.join(p, "g.png")
    with open(path, "w") as f:
        f.write("x")
    pkg.connect().sql(f"COPY bad FROM '{path}' WITH (source_type='raster_file')")


# ---------------------------------------------------------------------------
# tests/test_stream_ingest.py
# ---------------------------------------------------------------------------


def _stats(st):
    return (st.batches, st.rows_loaded, st.rows_rejected, len(st.rejected_samples))


def _push_delimited(pkg, p):
    db = pkg.connect()
    db.sql("CREATE TABLE s1 (a INT, b DOUBLE, c TEXT)")
    imp = db.stream_importer("s1", batch_size=3)
    imp.push_delimited(["1,1.5,x", "2,2.5,y", "3,3.5,z", "4,4.5,w"])
    first = imp.stats.batches
    return first, _stats(imp.close()), db.sql("SELECT a, b, c FROM s1 ORDER BY a").rows()


def _rejects_and_nulls(pkg, p):
    db = pkg.connect()
    db.sql("CREATE TABLE s2 (a INT, b TEXT)")
    imp = db.stream_importer("s2", batch_size=100)
    imp.push_delimited(["1,ok", "nope,bad-int", "2,with,comma", r"\N,nulled", "3,"])
    st = imp.close()
    return (_stats(st), [str(s) for s in st.rejected_samples],
            db.sql("SELECT a, b FROM s2 ORDER BY a NULLS FIRST").rows())


def _max_reject(pkg, p):
    db = pkg.connect()
    db.sql("CREATE TABLE s3 (a INT)")
    db.stream_importer("s3", batch_size=10, max_reject=2).push_delimited(["x", "y", "z"])


def _transforms(pkg, p):
    db = pkg.connect()
    db.sql("CREATE TABLE s4 (a INT, b TEXT)")
    imp = db.stream_importer("s4", transforms={"b": (r"^raw:", ""), "a": (r"#", "")})
    imp.push_delimited(["#1,raw:hello", "#2,raw:world"])
    imp.close()
    return db.sql("SELECT a, b FROM s4 ORDER BY a").rows()


def _typed_rows(pkg, p):
    db = pkg.connect()
    db.sql("CREATE TABLE s5 (a INT, b BOOLEAN)")
    imp = db.stream_importer("s5", batch_size=2)
    imp.push_rows([(1, True), (2, False), (3, None)])
    return _stats(imp.close()), db.sql("SELECT a, b FROM s5 ORDER BY a").rows()


def _file_tail(pkg, p):
    os.makedirs(p)
    db = pkg.connect()
    db.sql("CREATE TABLE s6 (a INT, v DOUBLE)")
    path = os.path.join(p, "feed.csv")
    with open(path, "w") as fh:
        fh.write("1,0.5\n2,1.5\n")
        fh.write("3,")  # a partial line is not consumed yet
    src = _mod(pkg, "io.stream").FileTailSource(path)
    imp = db.stream_importer("s6", batch_size=100)
    lines = src.poll(0.1)
    imp.push_delimited(lines)
    with open(path, "a") as fh:
        fh.write("2.5\n4,3.5\n")
    imp.run(src, poll_timeout_s=0.05, idle_limit=2)
    return lines, db.sql("SELECT count(*), sum(a), sum(v) FROM s6").rows()


def _kafka_gated(pkg, p):
    KafkaSource = _mod(pkg, "io.stream").KafkaSource
    with pytest.raises(pkg.errors.SqlError, match="consumer") as err:
        KafkaSource()

    class FakeConsumer:
        def __init__(self, batches):
            self.batches = list(batches)

        def poll(self, timeout):
            return _FakeKafkaMessage(self.batches.pop(0)) if self.batches else None

    db = pkg.connect()
    db.sql("CREATE TABLE s7 (a INT)")
    src = KafkaSource(consumer=FakeConsumer([b"1\n2\n", b"3\n"]))
    db.stream_importer("s7", batch_size=10).run(src, poll_timeout_s=0.01, idle_limit=1)
    return str(err.value), db.sql("SELECT count(*), sum(a) FROM s7").rows()


def _kafka_fake_broker(pkg, p):
    KafkaSource = _mod(pkg, "io.stream").KafkaSource
    db = pkg.connect()
    db.sql("CREATE TABLE ks (a INT, v DOUBLE, s TEXT)")
    broker = _FakeKafkaBroker()
    broker.produce("1,0.5,x\n2,1.5,y")
    broker.produce(b"3,2.5,z")
    db.stream_importer("ks", batch_size=2).run(
        KafkaSource(consumer=broker.consumer()), poll_timeout_s=0.02, idle_limit=2)
    out = [db.sql("SELECT count(*), sum(a) FROM ks").rows()]
    broker.produce("4,3.5,w")  # late records resume from the committed offset
    db.stream_importer("ks", batch_size=10).run(
        KafkaSource(consumer=broker.consumer(start_offset=2)), poll_timeout_s=0.02,
        idle_limit=2)
    return out + [db.sql("SELECT count(*), sum(a), sum(v) FROM ks").rows()]


def _kafka_error_frames(pkg, p):
    KafkaSource = _mod(pkg, "io.stream").KafkaSource

    class ErrConsumer:
        def __init__(self):
            self.n = 0

        def poll(self, timeout_s):
            self.n += 1
            if self.n == 1:
                return _FakeKafkaMessage(b"", error="transport error")
            if self.n == 2:
                return _FakeKafkaMessage(b"20\n30")
            return None

    db = pkg.connect()
    db.sql("CREATE TABLE ke (a INT)")
    db.stream_importer("ke", batch_size=10).run(
        KafkaSource(consumer=ErrConsumer()), poll_timeout_s=0.02, idle_limit=2)
    return db.sql("SELECT sum(a) FROM ke").rows()


CASES = {
    "test_geo_import.py::test_points_with_properties": _points_with_properties,
    "test_geo_import.py::test_polygons_promote_to_multipolygon": _polygons_promote,
    "test_geo_import.py::test_extension_autodetect_and_spatial_query": _autodetect_spatial,
    "test_geo_import.py::test_bare_geometry_and_missing_geometry": _bare_and_missing,
    "test_raster_import.py::test_esri_ascii_world": _esri_world,
    "test_raster_import.py::test_esri_ascii_file_coords_and_drop_null": _esri_file_coords,
    "test_raster_import.py::test_xyz": _xyz,
    "test_raster_import.py::test_point_type_point": _point_type_point,
    "test_raster_import.py::test_geotiff": _geotiff,
    "test_raster_import.py::test_geotiff_band_filter_and_nodata": _geotiff_nodata,
    "test_stream_ingest.py::test_push_delimited_batches": _push_delimited,
    "test_stream_ingest.py::test_rejects_and_nulls": _rejects_and_nulls,
    "test_stream_ingest.py::test_transforms": _transforms,
    "test_stream_ingest.py::test_typed_rows_and_epoch_per_batch": _typed_rows,
    "test_stream_ingest.py::test_file_tail_source": _file_tail,
    "test_stream_ingest.py::test_kafka_source_gated": _kafka_gated,
    "test_stream_ingest.py::test_kafka_adapter_against_fake_broker": _kafka_fake_broker,
    "test_stream_ingest.py::test_kafka_adapter_error_frames_skipped": _kafka_error_frames,
}
ERROR_CASES = {
    "test_raster_import.py::test_unknown_extension_rejected": _unknown_extension,
    "test_stream_ingest.py::test_max_reject_aborts": _max_reject,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_io_cases(tmp_path, name):
    both(tmp_path, CASES[name])


@pytest.mark.parametrize("name", sorted(ERROR_CASES))
def test_reference_io_errors(tmp_path, name):
    raises_in_both(tmp_path, ERROR_CASES[name])


def test_stream_batches_upload_whole_table_when_prestaged():
    """Past eager_staging_min_rows every batch of a stream importer goes
    through load_table, so the whole table is uploaded again: the bytes a
    batch puts on the wire grow with the table, not with the batch."""
    cfg = PORT.Config(eager_device_staging=True, eager_staging_min_rows=1000)
    db = PORT.connect(config=cfg)
    db.sql("CREATE TABLE sb (a INT, v DOUBLE)")
    rng = np.random.default_rng(1621)
    imp = db.stream_importer("sb", batch_size=600)
    wire = []
    for _ in range(4):
        before = db.executor.h2d_bytes
        imp.push_rows([(int(a), float(v)) for a, v in
                       zip(rng.integers(0, 100, 600), rng.random(600))])
        wire.append(db.executor.h2d_bytes - before)
    imp.close()
    # under 1000 rows nothing is staged; then 12 bytes a row of the whole
    # table, padded to its row bucket
    assert wire == [0] + [bucket(n) * 12 for n in (1200, 1800, 2400)]
    assert db.sql("SELECT COUNT(*) FROM sb").rows() == [(2400,)]
