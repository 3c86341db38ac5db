"""Raster file import — the reference's GDAL raster path
(ImportExport/RasterImporter.cpp, COPY ... WITH (source_type='raster_file')).

This environment has no GDAL, so the formats are decoded natively:

- **ESRI ASCII grid** (.asc/.agr): header ncols/nrows/xllcorner/yllcorner/
  cellsize/NODATA_value + whitespace-separated cells (one band).
- **GeoTIFF / TIFF** via Pillow: every channel (or frame) is a band;
  georeferencing read straight from the GeoTIFF tags — ModelPixelScale
  (33550), ModelTiepoint (33922), ModelTransformation (34264), and
  GDAL_NODATA (42113).
- **XYZ text** (.xyz): `x y z` rows (already point-form).

Semantics mirror RasterImporter.h: each pixel becomes one row carrying
its coordinates plus one column per band.  Options (CopyParams.h:98-106):

- ``raster_point_type``: none|auto|smallint|int|float|double|point
  (kAuto → double under a world transform, else the smallest integer
  that fits the pixel grid; kPoint emits a POINT geo column).
- ``raster_point_transform``: none|auto|file|world (kAuto → world when
  the file is georeferenced, else file pixel coords).
- ``raster_import_bands``: comma-separated band names to keep.
- ``raster_drop_if_all_null``: drop rows where every band is NODATA.

Coordinates are computed vectorized (numpy meshgrid) and loaded through
the engine's columnar insert path — the device sees big contiguous
columns, never per-pixel Python objects.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from heavydb_tpu_torch import types as T
from heavydb_tpu_torch.errors import StorageError

K = T.SQLTypeKind

# GeoTIFF tag ids (OGC GeoTIFF 1.1 / GDAL)
_TAG_PIXEL_SCALE = 33550
_TAG_TIEPOINT = 33922
_TAG_TRANSFORM = 34264
_TAG_GDAL_NODATA = 42113


class RasterBand:
    def __init__(self, name: str, data: np.ndarray, nodata=None):
        self.name = name
        self.data = data  # 2-D (rows, cols)
        self.nodata = nodata


class RasterDataset:
    """(bands, geotransform) — geotransform follows the GDAL affine
    convention: x = gt[0] + col*gt[1] + row*gt[2];
    y = gt[3] + col*gt[4] + row*gt[5].  None when not georeferenced."""

    def __init__(self, bands: List[RasterBand],
                 geotransform: Optional[Tuple[float, ...]]):
        if not bands:
            raise StorageError("raster file has no bands")
        self.bands = bands
        self.geotransform = geotransform
        self.height, self.width = bands[0].data.shape


# ---------------------------------------------------------------------------
# format readers


def _read_esri_ascii(path: str) -> RasterDataset:
    head: Dict[str, float] = {}
    data_start = 0
    with open(path) as fh:
        lines = fh.readlines()
    for i, ln in enumerate(lines):
        parts = ln.split()
        if len(parts) == 2 and re.fullmatch(r"[A-Za-z_]+", parts[0]):
            head[parts[0].lower()] = float(parts[1])
            data_start = i + 1
        else:
            break
    for req in ("ncols", "nrows", "cellsize"):
        if req not in head:
            raise StorageError(f"ESRI ASCII grid missing header {req!r}")
    ncols, nrows = int(head["ncols"]), int(head["nrows"])
    cell = head["cellsize"]
    vals = np.array(" ".join(lines[data_start:]).split(), dtype=np.float64)
    if vals.size != nrows * ncols:
        raise StorageError(
            f"ESRI grid has {vals.size} cells, header says {nrows * ncols}"
        )
    grid = vals.reshape(nrows, ncols)
    nodata = head.get("nodata_value")
    # llcorner/llcenter → GDAL affine (origin = top-left pixel corner)
    if "xllcorner" in head:
        x0 = head["xllcorner"]
        y0 = head["yllcorner"] + nrows * cell
    elif "xllcenter" in head:
        x0 = head["xllcenter"] - cell / 2
        y0 = head["yllcenter"] - cell / 2 + nrows * cell
    else:
        x0, y0 = 0.0, nrows * cell
    gt = (x0, cell, 0.0, y0, 0.0, -cell)
    return RasterDataset([RasterBand("band_1_1", grid, nodata)], gt)


def _read_xyz(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    a = np.loadtxt(path)
    if a.ndim == 1:
        a = a.reshape(1, -1)
    if a.shape[1] < 3:
        raise StorageError("XYZ raster needs at least 3 columns")
    return a[:, 0], a[:, 1], a[:, 2]


def _read_tiff(path: str) -> RasterDataset:
    try:
        from PIL import Image
    except Exception as exc:  # pragma: no cover - PIL baked into the image
        raise StorageError(f"TIFF import needs Pillow: {exc}")
    im = Image.open(path)
    tags = dict(getattr(im, "tag_v2", {}) or {})
    gt = None
    if _TAG_TRANSFORM in tags:
        m = [float(v) for v in tags[_TAG_TRANSFORM]]
        # 4x4 row-major: x = m0*col + m1*row + m3 ; y = m4*col + m5*row + m7
        gt = (m[3], m[0], m[1], m[7], m[4], m[5])
    elif _TAG_PIXEL_SCALE in tags and _TAG_TIEPOINT in tags:
        sx, sy = (float(tags[_TAG_PIXEL_SCALE][0]),
                  float(tags[_TAG_PIXEL_SCALE][1]))
        tp = [float(v) for v in tags[_TAG_TIEPOINT][:6]]
        # tiepoint: raster (i,j,k) ↔ model (x,y,z)
        gt = (tp[3] - tp[0] * sx, sx, 0.0, tp[4] + tp[1] * sy, 0.0, -sy)
    nodata = None
    if _TAG_GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[_TAG_GDAL_NODATA]).strip().strip("\x00"))
        except ValueError:
            pass
    bands: List[RasterBand] = []
    frame = 0
    while True:
        arr = np.asarray(im)
        if arr.ndim == 2:
            planes = [arr]
        else:
            planes = [arr[:, :, c] for c in range(arr.shape[2])]
        names = list(im.getbands()) if len(planes) == len(im.getbands()) \
            else [str(i + 1) for i in range(len(planes))]
        for b, plane in zip(names, planes):
            bands.append(RasterBand(
                f"band_{frame + 1}_{b}", plane.astype(plane.dtype, copy=True),
                nodata))
        frame += 1
        try:
            im.seek(frame)
        except EOFError:
            break
    return RasterDataset(bands, gt)


# ---------------------------------------------------------------------------
# option parsing (CopyParams.h RasterPointType / RasterPointTransform)

_POINT_TYPES = ("none", "auto", "smallint", "int", "float", "double", "point")
_TRANSFORMS = ("none", "auto", "file", "world")


def _band_type(data: np.ndarray) -> T.TypeInfo:
    dt = data.dtype
    if dt.kind == "f":
        return T.double() if dt.itemsize > 4 else T.float_()
    if dt.kind in "iu":
        hi = int(data.max(initial=0))
        lo = int(data.min(initial=0))
        if -128 < lo and hi < 127:
            return T.smallint()  # reference promotes int8 (no TINYINT bands)
        if -(2**15) < lo and hi < 2**15 - 1:
            return T.smallint()
        if -(2**31) < lo and hi < 2**31 - 1:
            return T.integer()
        return T.bigint()
    if dt.kind == "b":
        return T.smallint()
    raise StorageError(f"unsupported raster band dtype {dt}")


def _coord_type(name: str, world: bool, width: int, height: int) -> T.TypeInfo:
    if name == "auto":
        if world:
            return T.double()
        return T.smallint() if max(width, height) < 2**15 else T.integer()
    return {"smallint": T.smallint(), "int": T.integer(),
            "float": T.float_(), "double": T.double()}[name]


def import_raster(db, table_name: str, path: str, options: Dict) -> int:
    """COPY ... WITH (source_type='raster_file') — one row per pixel."""
    pt = str(options.get("raster_point_type", "auto")).lower()
    tf = str(options.get("raster_point_transform", "auto")).lower()
    if pt not in _POINT_TYPES:
        raise StorageError(f"raster_point_type must be one of {_POINT_TYPES}")
    if tf not in _TRANSFORMS:
        raise StorageError(f"raster_point_transform must be one of {_TRANSFORMS}")
    keep = options.get("raster_import_bands")
    keep_set = None
    if keep:
        keep_set = {b.strip().lower() for b in str(keep).split(",") if b.strip()}
    drop_null = bool(options.get("raster_drop_if_all_null", False))

    ext = os.path.splitext(path)[1].lower()
    if ext in (".xyz", ".txt"):
        xs, ys, zs = _read_xyz(path)
        cols: Dict[str, np.ndarray] = {}
        schema: List[Tuple[str, T.TypeInfo]] = []
        _emit_coords(cols, schema, xs, ys, pt, world=True)
        schema.append(("band_1_1", T.double()))
        cols["band_1_1"] = zs
        return _load(db, table_name, schema, cols)

    if ext in (".asc", ".agr", ".grd"):
        ds = _read_esri_ascii(path)
    elif ext in (".tif", ".tiff", ".gtiff"):
        ds = _read_tiff(path)
    else:
        raise StorageError(
            f"unsupported raster extension {ext!r} (asc/tif/xyz)")

    world = tf == "world" or (tf == "auto" and ds.geotransform is not None)
    if world and ds.geotransform is None:
        raise StorageError(
            "raster_point_transform='world' but the file has no "
            "georeferencing tags")

    rows = np.arange(ds.height)
    colns = np.arange(ds.width)
    cgrid, rgrid = np.meshgrid(colns, rows)  # (H, W) each
    cflat, rflat = cgrid.ravel(), rgrid.ravel()
    if world:
        gt = ds.geotransform
        # pixel-center convention (reference kWorld: affine at center)
        xc, yc = cflat + 0.5, rflat + 0.5
        xs = gt[0] + xc * gt[1] + yc * gt[2]
        ys = gt[3] + xc * gt[4] + yc * gt[5]
    else:
        xs, ys = cflat, rflat

    bands = [b for b in ds.bands
             if keep_set is None or b.name.lower() in keep_set]
    if not bands:
        raise StorageError(
            f"raster_import_bands={keep!r} matched none of "
            f"{[b.name for b in ds.bands]}")

    cols = {}
    schema = []
    if pt != "none":
        _emit_coords(cols, schema, xs, ys, pt, world)
    mask_all_null = None
    for b in bands:
        flat = b.data.ravel()
        ti = _band_type(b.data)
        if b.nodata is not None:
            isnull = flat == b.nodata
            if isnull.any():
                ti = ti.with_nullable(True)
                obj = flat.astype(object)
                obj[isnull] = None
                flat = obj
            mask_all_null = (isnull if mask_all_null is None
                             else (mask_all_null & isnull))
        else:
            mask_all_null = np.zeros(flat.shape[0], bool)
        schema.append((b.name, ti))
        cols[b.name] = flat
    if drop_null and mask_all_null is not None and mask_all_null.any():
        live = ~mask_all_null
        cols = {k: v[live] for k, v in cols.items()}
    return _load(db, table_name, schema, cols)


def _emit_coords(cols, schema, xs, ys, pt: str, world: bool):
    if pt == "point":
        # POINT column (reference PointType::kPoint)
        wkt = np.array([f"POINT ({x} {y})" for x, y in zip(xs, ys)],
                       dtype=object)
        schema.append(("raster_point", T.geo(K.GEO_POINT, srid=4326 if world
                                             else 0)))
        cols["raster_point"] = wkt
        return
    h = int(ys.max(initial=0)) + 1 if not world else 0
    w = int(xs.max(initial=0)) + 1 if not world else 0
    ti = _coord_type(pt, world, w, h)
    dt = ti.np_dtype()
    schema.append(("raster_lon" if world else "raster_x", ti))
    schema.append(("raster_lat" if world else "raster_y", ti))
    cols["raster_lon" if world else "raster_x"] = xs.astype(dt)
    cols["raster_lat" if world else "raster_y"] = ys.astype(dt)


def _load(db, table_name, schema, cols) -> int:
    t = db.catalog.get_table_opt(table_name)
    if t is None:
        t = db.catalog.create_table(table_name, schema)
    n = len(next(iter(cols.values()))) if cols else 0
    if n:
        db._insert_columns(t, {k: np.asarray(v) for k, v in cols.items()})
    return n
