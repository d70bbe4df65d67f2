"""Owned CRS engine: WKT parsing, Snyder projections, AOI reprojection wiring.

Ground truth: the worked ellipsoidal examples from Snyder, *Map Projections:
A Working Manual* (USGS PP 1395), Appendix A — Clarke 1866 ellipsoid:
- Albers  (p. 103): phi1=29.5, phi2=45.5, phi0=23, lam0=-96; (35N, 75W) ->
  x=1,885,472.7  y=1,535,925.0
- LCC     (p. 109): phi1=33, phi2=45, phi0=23, lam0=-96; (35N, 75W) ->
  x=1,894,410.9  y=1,564,649.5
- TM      (p. 270): k0=0.9996, lam0=-75 (UTM 18); (40.5N, 73.5W) ->
  x=127,106.5    y=4,484,124.4
"""

import math

import numpy as np
import pytest

from gpras_tpu.utils.crs import CRS, make_transformer, transform_points

CLARKE = dict(a=6378206.4, inv_f=294.9786982)

# The SHG / standard-hydrologic-grid CRS (ESRI WKT) every FFRD HMS precip grid
# ships in (srsDefinition of DSS grid records).
SHG_WKT = (
    'PROJCS["USA_Contiguous_Albers_Equal_Area_Conic_USGS_version",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Albers"],'
    'PARAMETER["False_Easting",0.0],PARAMETER["False_Northing",0.0],'
    'PARAMETER["Central_Meridian",-96.0],'
    'PARAMETER["Standard_Parallel_1",29.5],'
    'PARAMETER["Standard_Parallel_2",45.5],'
    'PARAMETER["Latitude_Of_Origin",23.0],UNIT["Meter",1.0]]'
)

NAD83_WKT = (
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]]'
)

# Texas North Central state plane (the Trinity pilot's zone), US survey feet.
TX_NC_WKT = (
    'PROJCS["NAD_1983_StatePlane_Texas_North_Central_FIPS_4202_Feet",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Lambert_Conformal_Conic"],'
    'PARAMETER["False_Easting",1968500.0],'
    'PARAMETER["False_Northing",6561666.666666666],'
    'PARAMETER["Central_Meridian",-98.5],'
    'PARAMETER["Standard_Parallel_1",32.13333333333333],'
    'PARAMETER["Standard_Parallel_2",33.96666666666667],'
    'PARAMETER["Latitude_Of_Origin",31.66666666666667],'
    'UNIT["Foot_US",0.3048006096012192]]'
)

UTM14_WKT = (
    'PROJCS["NAD_1983_UTM_Zone_14N",'
    'GEOGCS["GCS_North_American_1983",DATUM["D_North_American_1983",'
    'SPHEROID["GRS_1980",6378137.0,298.257222101]],'
    'PRIMEM["Greenwich",0.0],UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Transverse_Mercator"],'
    'PARAMETER["False_Easting",500000.0],PARAMETER["False_Northing",0.0],'
    'PARAMETER["Central_Meridian",-99.0],PARAMETER["Scale_Factor",0.9996],'
    'PARAMETER["Latitude_Of_Origin",0.0],UNIT["Meter",1.0]]'
)


def _crs(kind, **params):
    rad = {k: math.radians(v) for k, v in params.items()
           if k in ("sp1", "sp2", "lat0", "lon0")}
    other = {k: v for k, v in params.items() if k not in rad}
    return CRS(kind=kind, **CLARKE,
               params={"fe": 0.0, "fn": 0.0, "k0": 1.0, **other, **rad})


def test_albers_snyder_example():
    c = _crs("aea", sp1=29.5, sp2=45.5, lat0=23.0, lon0=-96.0)
    x, y = c.from_lonlat(np.array([-75.0]), np.array([35.0]))
    assert abs(x[0] - 1885472.7) < 0.5
    assert abs(y[0] - 1535925.0) < 0.5


def test_lcc_snyder_example():
    c = _crs("lcc", sp1=33.0, sp2=45.0, lat0=23.0, lon0=-96.0)
    x, y = c.from_lonlat(np.array([-75.0]), np.array([35.0]))
    assert abs(x[0] - 1894410.9) < 0.5
    assert abs(y[0] - 1564649.5) < 0.5


def test_tmerc_snyder_example():
    c = _crs("tmerc", lat0=0.0, lon0=-75.0, k0=0.9996)
    x, y = c.from_lonlat(np.array([-73.5]), np.array([40.5]))
    assert abs(x[0] - 127106.5) < 0.5
    assert abs(y[0] - 4484124.4) < 0.5


@pytest.mark.parametrize("wkt", [SHG_WKT, TX_NC_WKT, UTM14_WKT])
def test_round_trip_grid(wkt):
    c = CRS.from_wkt(wkt)
    lon, lat = np.meshgrid(np.linspace(-99.5, -94.0, 6),
                           np.linspace(29.0, 35.0, 6))
    x, y = c.from_lonlat(lon.ravel(), lat.ravel())
    lon2, lat2 = c.to_lonlat(x, y)
    np.testing.assert_allclose(lon2, lon.ravel(), atol=1e-9)
    np.testing.assert_allclose(lat2, lat.ravel(), atol=1e-9)


def test_wkt_parse_shg():
    c = CRS.from_wkt(SHG_WKT)
    assert c.kind == "aea"
    assert c.a == 6378137.0
    assert abs(c.params["lon0"] - math.radians(-96.0)) < 1e-12
    assert abs(c.params["sp1"] - math.radians(29.5)) < 1e-12
    assert c.unit == 1.0
    # origin invariant: (lam0, lat0) -> (FE, FN)
    x, y = c.from_lonlat(np.array([-96.0]), np.array([23.0]))
    assert abs(x[0]) < 1e-6 and abs(y[0]) < 1e-6


def test_wkt_parse_geographic():
    c = CRS.from_wkt(NAD83_WKT)
    assert c.kind == "geographic"
    lon, lat = c.to_lonlat(np.array([-96.0]), np.array([23.0]))
    assert lon[0] == -96.0 and lat[0] == 23.0


def test_foot_unit_scaling():
    """State-plane feet: output in US survey feet; false easting honored."""
    c = CRS.from_wkt(TX_NC_WKT)
    assert abs(c.unit - 0.3048006096012192) < 1e-16
    x, y = c.from_lonlat(np.array([-98.5]), np.array([31.66666666666667]))
    # at the projection origin, x == false easting (in feet), y == false northing
    assert abs(x[0] - 1968500.0) < 1e-5
    assert abs(y[0] - 6561666.666666666) < 1e-5
    # a meter-unit twin must give exactly unit-scaled coordinates
    c_m = CRS(kind=c.kind, a=c.a, inv_f=c.inv_f, unit=1.0,
              params=dict(c.params))
    xm, ym = c_m.from_lonlat(np.array([-97.0]), np.array([33.0]))
    xf, yf = c.from_lonlat(np.array([-97.0]), np.array([33.0]))
    np.testing.assert_allclose(xf * c.unit, xm, rtol=1e-14)
    np.testing.assert_allclose(yf * c.unit, ym, rtol=1e-14)


def test_utm_central_meridian_invariants():
    c = CRS.from_wkt(UTM14_WKT)
    # on the central meridian: x = 500000 exactly, y = k0 * meridian arc > 0
    x, y = c.from_lonlat(np.array([-99.0]), np.array([33.0]))
    assert abs(x[0] - 500000.0) < 1e-6
    assert y[0] > 3.6e6  # ~3,652 km from the equator at 33N


def test_transformer_identity_cases():
    assert make_transformer(None, SHG_WKT) is None
    assert make_transformer(SHG_WKT, None) is None
    assert make_transformer(SHG_WKT, SHG_WKT) is None
    # equivalent parameters, different name string -> still identity
    other = SHG_WKT.replace("USGS_version", "SHG")
    assert make_transformer(SHG_WKT, other) is None


def test_transform_points_feet_to_shg_and_back():
    pts_deg = np.array([[-97.2, 32.8], [-97.0, 33.1], [-96.8, 32.9]])
    geo = CRS.from_wkt(NAD83_WKT)
    feet = transform_points(NAD83_WKT, TX_NC_WKT, pts_deg)
    shg_direct = transform_points(NAD83_WKT, SHG_WKT, pts_deg)
    shg_via_feet = transform_points(TX_NC_WKT, SHG_WKT, feet)
    np.testing.assert_allclose(shg_via_feet, shg_direct, atol=1e-6)
    back = transform_points(SHG_WKT, NAD83_WKT, shg_direct)
    np.testing.assert_allclose(back, pts_deg, atol=1e-9)
    assert geo.kind == "geographic"


def test_builder_rasterized_aoi_reprojects(tmp_path):
    """End-to-end: model + AOI in geographic
    coordinates, precip raster in SHG Albers — the mask must match the one
    computed from the manually projected AOI (reference gpras/preprocess.py:
    236-251 via geopandas to_crs + rasterio rasterize)."""
    import fixtures as fx
    from gpras_tpu.data.builders import DataBuilder
    from gpras_tpu.data.geometry import Polygon, rasterize_polygon
    from gpras_tpu.data.ras_model import RasModel

    # a tiny geographic-CRS model near (-97.0, 33.0); cells ~0.01 degrees
    plans = ["e1"]
    shg = CRS.from_wkt(SHG_WKT)
    # precip raster: 2000 m SHG cells covering the model area
    x0, y0 = (float(v[0]) for v in shg.from_lonlat(np.array([-97.05]),
                                                   np.array([33.08])))
    rows, cols = 8, 8
    meta = {"Raster Cellsize": 2000.0, "Raster Left": x0, "Raster Top": y0,
            "Raster Rows": rows, "Raster Cols": cols,
            "Projection": SHG_WKT}
    precip = np.abs(np.random.default_rng(0).normal(
        size=(40, rows * cols))).astype(np.float32)
    proj = fx.make_project(
        tmp_path / "hf", "hfm", nx=6, ny=6, cell=0.01, plans=plans,
        projection=NAD83_WKT, precip=precip, precip_meta=meta,
        elevation_fn=lambda c: np.zeros(len(c)))
    aoi_ring = np.array([[0.005, 0.005], [0.055, 0.005],
                         [0.055, 0.055], [0.005, 0.055]])
    # fixture grid lives at (0..0.06, 0..0.06); shift into the lon/lat window
    aoi_ring = aoi_ring + np.array([-97.05, 33.0])

    model = RasModel.from_stac(proj["stac"])
    assert model.projection == NAD83_WKT

    # fixture meshes sit at 0-origin coordinates, so translate the AOI back
    # for the mesh mask; the precip mask is what exercises the reprojection
    b = DataBuilder(hf_ras=model, mesh_id=fx.MESH_ID, plans=plans,
                    area_of_interest=Polygon(aoi_ring - [-97.05, 33.0]))
    b.area_of_interest = Polygon(aoi_ring)  # AOI in the model CRS (degrees)

    got = b._rasterized_aoi
    want_poly = Polygon(transform_points(NAD83_WKT, SHG_WKT, aoi_ring))
    want = rasterize_polygon(want_poly, (x0, y0), 2000.0, (rows, cols),
                             all_touched=True)
    assert want.any()  # the projected AOI must actually hit the grid
    np.testing.assert_array_equal(got, want)
    # and the unprojected AOI (degrees vs meters) would have missed entirely
    miss = rasterize_polygon(Polygon(aoi_ring), (x0, y0), 2000.0,
                             (rows, cols), all_touched=True)
    assert not miss.any()


def test_wkt_axis_enum_tokens_parse():
    """GDAL/rasterio WKT1 commonly ends with AXIS["Easting",EAST],
    AXIS["Northing",NORTH]: bare enum tokens starting with 'E' must not be
    eaten by the float tokenizer (regression: float('E') ValueError)."""
    wkt_axes = SHG_WKT[:-1] + (',AXIS["Easting",EAST],AXIS["Northing",NORTH],'
                               'AUTHORITY["EPSG","5070"]]')
    c = CRS.from_wkt(wkt_axes)
    assert c.kind == "aea"
    x, y = c.from_lonlat(np.array([-96.0]), np.array([23.0]))
    assert abs(x[0]) < 1e-6 and abs(y[0]) < 1e-6
    # scientific-notation numbers still parse as floats
    from gpras_tpu.utils.crs import _tokenize_wkt

    node = _tokenize_wkt('PARAMETER["false_easting",1.5e6]')
    assert node[1][1] == 1.5e6
