"""Synthetic AOI: a self-consistent satellite scene written to disk in
the reference's dataset layout (per-image JSON + GeoTIFF + MicMac depth
triplets + split files + GT DSM).

Originally the test fixture behind the data/DSM/e2e suites; promoted to
a framework API because it doubles as a controlled-experiment dataset
generator: known terrain (flat or ±BUMP_AMP hills), known albedo
texture, known per-image view/sun geometry (fixed tables, or an n-view
golden-angle spiral, or a sun-aligned hotspot view), and optionally
physically BRDF-shaded imagery with known RPV parameters — the setup
the BRDF ground-truth inversion study is built on
(examples/brdf_inversion_check.py, BASELINE.md study table).  No
reference counterpart: the reference's generate_dataset.py prepares
REAL Pléiades data and cannot provide ground truth for reflectance.

World model: terrain near (lat 48, lon 2), UTM zone 31N.  Each image
has an exactly-affine RPC (denominators == 1) so localization is
closed-form invertible; image intensity is a smooth function of ground
lon/lat so multi-view consistency holds.

The port's copy of the JAX package's data/synth_aoi.py: it writes the
same files.  RPV, Hapke and Microfacet shading run this package's brdf/
modules on CPU tensors.
"""

import json
import os

import numpy as np

from ..geo.geodesy import latlon_from_utm, latlon_to_ecef, utm_from_latlon
from ..utils.geotiff import write_geotiff, GeoProfile, utm_epsg

LAT0, LON0 = 48.0, 2.0
ALT0 = 100.0
MIN_ALT, MAX_ALT = 60.0, 160.0
H = W = 32
ZONE = 31


def affine_rpc_dict(dlon_dalt=0.0, dlat_dalt=0.0, hw=None):
    """col = 16 + 16*nlon + a13*nalt ... (col_scale = W/2 = 16),
    denominators 1.  The nalt terms tilt the view direction away from
    nadir (different per image).  hw=(h, w) overrides the module's 32 px
    default (the ground footprint is fixed by the lat/lon scales; hw only
    changes sampling density)."""
    h, w = hw if hw is not None else (H, W)
    col_num = [0.0] * 20
    col_num[1] = 1.0            # nlon
    col_num[3] = dlon_dalt      # nalt cross-talk -> oblique view
    row_num = [0.0] * 20
    row_num[2] = -1.0           # -nlat (row grows southward)
    row_num[3] = dlat_dalt
    den = [0.0] * 20
    den[0] = 1.0
    return dict(
        row_offset=h / 2.0, col_offset=w / 2.0,
        lat_offset=LAT0, lon_offset=LON0, alt_offset=ALT0,
        row_scale=h / 2.0, col_scale=w / 2.0,
        lat_scale=2e-4, lon_scale=3e-4, alt_scale=100.0,
        row_num=row_num, row_den=den, col_num=col_num, col_den=den)


def ground_texture(lon, lat):
    """Smooth multi-view-consistent intensity in [0, 1]."""
    u = (lon - LON0) / 3e-4
    v = (lat - LAT0) / 2e-4
    return 0.5 + 0.25 * np.sin(2.0 * u) + 0.25 * np.cos(3.0 * v)


BUMP_AMP = 15.0     # meters


def terrain_alt(lon, lat, bumpy: bool):
    """Terrain altitude: flat ALT0, or a smooth +/-BUMP_AMP hill field."""
    if not bumpy:
        return np.full_like(np.asarray(lon, np.float64), ALT0)
    u = (lon - LON0) / 3e-4
    v = (lat - LAT0) / 2e-4
    return ALT0 + BUMP_AMP * np.sin(1.5 * u) * np.cos(1.2 * v)


def terrain_normal(lon, lat, bumpy: bool, d: float = 0.25):
    """Unit terrain surface normal in the local (east, north, up) frame by
    central finite differences of terrain_alt in UTM meters.  The bumpy
    hill field has slopes up to ~45 deg, which is what gives the
    BRDF-shaded imagery its angular diversity (ci/cv vary per pixel even
    though each affine-RPC view direction is constant per image)."""
    lon = np.asarray(lon, np.float64)
    if not bumpy:
        n = np.zeros(lon.shape + (3,))
        n[..., 2] = 1.0
        return n
    e, n_ = utm_from_latlon(np.asarray(lat, np.float64), lon, zone=ZONE)

    def alt_at(ee, nn):
        la, lo = latlon_from_utm(ee, nn, ZONE, northern=True)
        return terrain_alt(lo, la, True)

    dzde = (alt_at(e + d, n_) - alt_at(e - d, n_)) / (2.0 * d)
    dzdn = (alt_at(e, n_ + d) - alt_at(e, n_ - d)) / (2.0 * d)
    nrm = np.stack([-dzde, -dzdn, np.ones_like(dzde)], -1)
    return nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)


def view_dir_up(rpc_d, cols, rows):
    """Per-pixel unit ground->camera direction in (east, north, up): the
    normalized vector from the ray's MIN_ALT ground point to its MAX_ALT
    ground point (the same two-altitude construction the ray generator
    uses, so pts2c = -rays_d in the trained model matches this exactly)."""
    lon_n, lat_n = localize_affine(rpc_d, cols, rows, MAX_ALT)
    lon_f, lat_f = localize_affine(rpc_d, cols, rows, MIN_ALT)
    e_n, n_n = utm_from_latlon(lat_n, lon_n, zone=ZONE)
    e_f, n_f = utm_from_latlon(lat_f, lon_f, zone=ZONE)
    v = np.stack([e_n - e_f, n_n - n_f,
                  np.full_like(e_n, MAX_ALT - MIN_ALT)], -1)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ground-truth RPV parameters for the BRDF-shaded AOI variant; chosen
# non-trivial (k != 1: bowl-shaped Minnaert darkening; theta < 0:
# backscattering HG lobe; rhoc < 1: live hotspot factor) but inside the
# heads' output ranges (k in [0,2], theta in [-1,1], rhoc in [0,1])
RPV_GT = dict(k=0.75, theta=-0.20, rhoc=0.55)

# ground-truth Hapke parameters for the Hapke-shaded AOI variant; inside
# the heads' output ranges (b, c in [0,1] sigmoids; theta in [0, 30 deg]
# = [0, 0.524] rad) and non-trivial: b/c give a genuine double-HG phase
# lobe and theta a real macroscopic-roughness shadowing term
HAPKE_GT = dict(b=0.35, c=0.60, theta=0.25)


HAPKE_HPK_SCL = 1.0   # generator + trained model must agree on the BRF
# normalizer; the ModelConfig default 4.0 leaves uint8 imagery at
# max ~0.12 (30 gray levels), so the Hapke study uses --hpk_scl 1


# ground-truth Microfacet roughness for the GGX-shaded AOI variant;
# mid-range of the sigmoid head.  The glossy lobe carries the fixed 0.04
# factor the reference hardcodes (microfacet.py:56), so roughness is
# mainly observable near the specular geometry — pair with hotspot_view
MICROFACET_GT = dict(rough=0.45)


def _on_cpu(*arrays):
    import torch
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


def microfacet_radiance(albedo, view_up, sun_up, normal, rough):
    """Ground-truth Microfacet (GGX) radiance:
    I = |sun_z| * (albedo + 0.04 * D / (4 l.n v.n)),
    through this package's brdf.microfacet.microfacet_brdf on CPU
    tensors."""
    from ..brdf.microfacet import microfacet_brdf

    def fn(sun, view, nrm, alb):
        r = np.full((alb.shape[0], 1), rough, np.float32)
        return microfacet_brdf(*_on_cpu(sun, view, nrm, alb, r))[1].numpy()

    return _shaded_radiance(fn, albedo, view_up, sun_up, normal)


def hapke_radiance(albedo, view_up, sun_up, normal, b, c, theta,
                   hpk_scl: float = HAPKE_HPK_SCL):
    """Ground-truth Hapke radiance:
    I = |sun_z| * HapkeBRF(view, sun, normal; w=albedo, b, c, theta),
    through this package's brdf.hapke.hapke_brdf (full BRF, shell 0) on
    CPU tensors."""
    from ..brdf.hapke import hapke_brdf

    def fn(sun, view, nrm, alb):
        ones3 = np.ones_like(alb)
        sun, view, nrm, alb, bb, cc, th = _on_cpu(
            sun, view, nrm, alb, b * ones3, c * ones3,
            np.full(alb.shape[0], theta, np.float32))
        return hapke_brdf(sun, view, nrm, alb, bb, cc, th, hpk_scl=hpk_scl,
                          shell_hapke=0)[0].numpy()

    return _shaded_radiance(fn, albedo, view_up, sun_up, normal)


def _shaded_radiance(brdf_fn, albedo, view_up, sun_up, normal):
    """Shared shading shell for the ground-truth radiance helpers:
    I = |sun_z| * BRDF(view, sun, normal; ...) — the framework's
    rendering equation for the blessed stage-2 configs (cos_irra_on,
    per-ray BRDF accumulation).  brdf_fn(sun, view, normal, albedo3)
    -> (N, 3) BRDF values, evaluated through the framework's own BRDF
    kernels so clamp/eps conventions match the trained model exactly."""
    sh = np.shape(albedo)
    flat = lambda a: np.asarray(a, np.float32).reshape(-1, 3)
    alb = np.repeat(np.asarray(albedo, np.float32).reshape(-1, 1),
                    3, axis=1)
    brdf = brdf_fn(flat(sun_up), flat(view_up), flat(normal), alb)
    irr = np.abs(np.asarray(sun_up, np.float64).reshape(-1, 3)[:, 2])
    return (irr[:, None] * np.asarray(brdf)).reshape(sh + (3,))


def rpv_radiance(albedo, view_up, sun_up, normal, k, theta, rhoc):
    """Ground-truth RPV radiance:
    I = |sun_z| * albedo * M1(ci,cv;k) * F(cg;theta) * H(rhoc;G),
    through this package's brdf.rpv.rpv_brdf on CPU tensors."""
    import torch
    from ..brdf.rpv import rpv_brdf

    def fn(sun, view, nrm, alb):
        sun, view, nrm, alb = _on_cpu(sun, view, nrm, alb)
        ones3 = torch.ones_like(alb)
        return rpv_brdf(sun, view, nrm, alb, k * ones3, theta * ones3,
                        rhoc * ones3)[0].numpy()

    return _shaded_radiance(fn, albedo, view_up, sun_up, normal)


def intersect_terrain(rpc_d, cols, rows, bumpy: bool, iters: int = 25):
    """Ray-terrain intersection by fixed-point altitude iteration:
    a <- alt(lonlat(a)).  Converges fast for gentle slopes (the affine RPC
    maps pixel+altitude to ground linearly)."""
    a = np.full(np.shape(cols), ALT0, np.float64)
    for _ in range(iters):
        lon, lat = localize_affine(rpc_d, cols, rows, a)
        a = 0.5 * a + 0.5 * terrain_alt(lon, lat, bumpy)
    lon, lat = localize_affine(rpc_d, cols, rows, a)
    return lon, lat, a


def localize_affine(rpc_d, cols, rows, alt):
    """Closed-form inverse of the affine RPC above."""
    nalt = (np.asarray(alt, np.float64) - rpc_d["alt_offset"]) / rpc_d["alt_scale"]
    ncol = (np.asarray(cols, np.float64) - rpc_d["col_offset"]) / rpc_d["col_scale"]
    nrow = (np.asarray(rows, np.float64) - rpc_d["row_offset"]) / rpc_d["row_scale"]
    nlon = ncol - rpc_d["col_num"][3] * nalt
    nlat = -(nrow - rpc_d["row_num"][3] * nalt)
    return (nlon * rpc_d["lon_scale"] + rpc_d["lon_offset"],
            nlat * rpc_d["lat_scale"] + rpc_d["lat_offset"])


ALB_SCALE = 0.5     # albedo = ALB_SCALE * ground_texture in BRDF mode,
# keeping irr * albedo * (M1*F*H) inside [0, 1] for nearly every pixel
# (both the generator and the model's render clip identically, but heavy
# saturation would destroy the angular signal the inversion needs)


def build_aoi(root: str, n_train: int = 2, n_test: int = 1,
              depth_subdir: str = "DenseDepth_ZM4",
              with_keypoints: bool = False, bumpy: bool = False,
              size: int = None, brdf: dict = None,
              hotspot_view: bool = False):
    """size: image height/width in pixels (default the module's 32).
    The ground FOOTPRINT is fixed by the RPC lat/lon scales, so size only
    changes sampling density — larger sizes give realistic
    steps-per-epoch so the per-epoch StepLR follows the reference's
    schedule geometry (the convergence runs use this; at 32 px the lr
    decays 0.9 every 2 steps and training freezes by step ~1000).

    brdf: optional ground-truth BRDF parameter dict; the family is
    dispatched by key names — dict(k=, theta=, rhoc=) shades with RPV
    (see RPV_GT), dict(b=, c=, theta=) with the full Hapke BRF at
    hpk_scl=HAPKE_HPK_SCL (see HAPKE_GT).  When set, the imagery is
    physically shaded instead of Lambertian:
    I = |sun_z| * BRDF(view, sun, normal; params) with
    albedo = ALB_SCALE * ground_texture, per-pixel terrain normals, the
    per-image view direction, and a per-image sun spread over azimuth AND
    elevation — the setup for the BRDF ground-truth inversion experiment
    (examples/brdf_inversion_check.py).  Use bumpy=True with it: on flat
    terrain every pixel of an (affine-RPC) image shares one angle triple,
    so 3 views give only 2 brightness ratios for 3 parameters."""
    h = w = int(size) if size is not None else H
    return _build_aoi(root, n_train, n_test, depth_subdir,
                      with_keypoints, bumpy, h, w, brdf, hotspot_view)


def _build_aoi(root: str, n_train: int, n_test: int, depth_subdir: str,
               with_keypoints: bool, bumpy: bool, h: int = H, w: int = W,
               brdf: dict = None, hotspot_view: bool = False):
    os.makedirs(root, exist_ok=True)
    depth_dir = os.path.join(root, depth_subdir)
    os.makedirs(depth_dir, exist_ok=True)
    tilts = [(0.0, 0.0), (0.15, 0.05), (-0.1, 0.12), (0.05, -0.15)]
    sun_els = [55.0] * 4
    sun_azs = [140.0 + 5 * i for i in range(4)]
    if brdf is not None:
        # view zeniths 0/17/18/20 deg with spread azimuths (|tilt| of 1.0
        # corresponds to ~12.6 deg off-nadir: dE/dalt = a13*lon_scale*
        # m_per_deg_lon/alt_scale ~ 0.22 per unit a13), plus sun positions
        # spread over elevation AND azimuth — the angular diversity the
        # 3-parameter RPV inversion needs
        tilts = [(0.0, 0.0), (1.3, 0.4), (-0.9, -1.1), (0.5, 1.5)]
        sun_els = [35.0, 55.0, 45.0, 65.0]
        sun_azs = [140.0, 230.0, 20.0, 320.0]
        m = n_train + n_test
        if m > 4:
            # identifiability-study mode: a deterministic golden-angle
            # spiral of view tilts (zenith 0 -> ~20 deg) and sun
            # positions spread over elevation AND azimuth, so every
            # surface point is observed under m distinct (view, sun)
            # pairs — per-point (albedo, k, theta, rhoc) has 4 unknowns,
            # so m >= ~6 diverse views make the RPV inversion
            # overdetermined where the blessed 3-view workload is not
            ga = 137.50776405  # golden angle, degrees
            phi = 0.6180339887  # golden-ratio stride: irrational, so the
            # elevation sequence never degenerates for any m (an integer
            # stride like 7 collapses to one value whenever gcd(7, m) > 1)
            tilts, sun_els, sun_azs = [], [], []
            for i in range(m):
                r = 1.6 * np.sqrt(i / max(m - 1, 1))
                az = np.radians(ga * i)
                tilts.append((r * np.cos(az), r * np.sin(az)))
                sun_els.append(30.0 + 35.0 * ((i * phi) % 1.0))
                sun_azs.append((140.0 + ga * i) % 360.0)
    names = []
    # shared bundle-adjustment tie points on the terrain (ECEF, the BA
    # convention): a coarse grid in the common footprint
    kp_lon = kp_lat = None
    if with_keypoints:
        kp_c, kp_r = np.meshgrid(np.arange(4, w - 4, 4),
                                 np.arange(4, h - 4, 4))
        kp_lon, kp_lat = localize_affine(affine_rpc_dict(hw=(h, w)),
                                         kp_c.ravel(), kp_r.ravel(), ALT0)
        kp_ecef = np.stack(latlon_to_ecef(kp_lat, kp_lon,
                                          np.full_like(kp_lat, ALT0)), -1)
        np.save(os.path.join(root, "pts3d.npy"), kp_ecef)
    for i in range(n_train + n_test):
        rpc_d = affine_rpc_dict(*tilts[i % len(tilts)], hw=(h, w))
        img_name = f"img_{i:02d}.tif"
        cols, rows = np.meshgrid(np.arange(w), np.arange(h))
        lon, lat, alt = intersect_terrain(rpc_d, cols, rows, bumpy)
        tex = ground_texture(lon, lat)
        sun_el = sun_els[i % len(sun_els)]
        sun_az = sun_azs[i % len(sun_azs)]
        if brdf is not None:
            from ..geo.geodesy import sun_direction
            nrm = terrain_normal(lon, lat, bumpy)
            vup = view_dir_up(rpc_d, cols, rows)
            if hotspot_view and i == n_train - 1:
                # place the sun ON this view's center direction: phase
                # angle ~0 at the image center, so the RPV hotspot
                # factor H(rhoc; G->0) = 2 - rhoc becomes observable —
                # without it satellite-style geometry never samples the
                # hotspot and rhoc is correctly unidentifiable
                v0 = vup[h // 2, w // 2]
                sun_el = float(np.degrees(np.arcsin(v0[2])))
                sun_az = float(np.degrees(np.arctan2(v0[0], v0[1]))) % 360.0
            sun = np.broadcast_to(sun_direction(sun_el, sun_az), vup.shape)
            # family dispatch by parameter names: RPV {k, theta, rhoc},
            # Hapke {b, c, theta}, Microfacet {rough}
            if "k" in brdf:
                rad = rpv_radiance(ALB_SCALE * tex, vup, sun, nrm,
                                   brdf["k"], brdf["theta"], brdf["rhoc"])
            elif "rough" in brdf:
                rad = microfacet_radiance(ALB_SCALE * tex, vup, sun, nrm,
                                          brdf["rough"])
            else:
                rad = hapke_radiance(ALB_SCALE * tex, vup, sun, nrm,
                                     brdf["b"], brdf["c"], brdf["theta"])
            rgb = np.clip(rad, 0.0, 1.0).transpose(2, 0, 1).astype(np.float32)
        else:
            rgb = np.stack([tex, tex, tex]).astype(np.float32)
        rgb8 = (rgb * 255).astype(np.uint8)
        write_geotiff(os.path.join(root, img_name), rgb8,
                      GeoProfile(epsg=utm_epsg(ZONE, True)))
        meta = dict(img=img_name, height=h, width=w, rpc=rpc_d,
                    min_alt=MIN_ALT, max_alt=MAX_ALT,
                    sun_elevation=sun_el, sun_azimuth=sun_az)
        if with_keypoints:
            # project the shared tie points into this image (exact affine
            # inverse => zero reprojection error)
            from ..geo import rpc as rpc_mod
            rpc_obj = rpc_mod.rpc_from_dict(rpc_d)
            col, row = rpc_mod.projection_np(
                rpc_obj, kp_lon, kp_lat, np.full_like(kp_lon, ALT0))
            meta["keypoints"] = {
                "2d_coordinates": np.stack([col, row], -1).tolist(),
                "pts3d_indices": list(range(len(kp_lon)))}
        jname = f"img_{i:02d}.json"
        with open(os.path.join(root, jname), "w") as f:
            json.dump(meta, f)
        names.append(jname)

        # MicMac depth triplet: dense (every pixel) on the terrain surface
        # — the SAME grid intersection already computed for the texture
        sel_c, sel_r = cols.ravel(), rows.ravel()
        lon_s, lat_s, alt_s = lon.ravel(), lat.ravel(), alt.ravel()
        e, n = utm_from_latlon(lat_s, lon_s, zone=ZONE)
        pts3d = np.stack([e, n, alt_s], -1)
        img_id = f"img_{i:02d}"
        np.savetxt(os.path.join(depth_dir, img_id + "_2DPts.txt"),
                   np.stack([sel_c, sel_r], -1), fmt="%d")
        np.savetxt(os.path.join(depth_dir, img_id + "_3DPts.txt"), pts3d,
                   fmt="%.6f")
        np.savetxt(os.path.join(depth_dir, img_id + "_Correl.txt"),
                   np.linspace(0.5, 1.0, len(sel_c)), fmt="%.6f")

    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("".join(n + "\n" for n in names[:n_train]))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("".join(n + "\n" for n in names[n_train:]))

    # GT lidar DSM over the AOI footprint (terrain_alt), resolution 1 m
    rpc_d = affine_rpc_dict(hw=(h, w))
    cols, rows = np.meshgrid([0, w - 1], [0, h - 1])
    lon, lat = localize_affine(rpc_d, cols.ravel(), rows.ravel(), ALT0)
    e, n = utm_from_latlon(lat, lon, zone=ZONE)
    res = 1.0
    xoff = np.floor(e.min())
    size = int(np.ceil(max(e.max() - e.min(), n.max() - n.min()))) + 2
    yoff_b = np.floor(n.min())
    ci, rj = np.meshgrid(np.arange(size), np.arange(size))
    ce = xoff + (ci + 0.5) * res
    cn = yoff_b + size * res - (rj + 0.5) * res
    glat, glon = latlon_from_utm(ce.ravel(), cn.ravel(), ZONE, northern=True)
    gt = terrain_alt(glon, glat, bumpy).reshape(size, size).astype(np.float32)
    gt_dir = os.path.join(root, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    aoi_id = "Synth_001"
    write_geotiff(os.path.join(gt_dir, f"{aoi_id}_DSM.tif"), gt[None],
                  GeoProfile(ulx=float(xoff), uly=float(yoff_b) + size * res,
                             xres=res, yres=res, epsg=utm_epsg(ZONE, True)))
    np.savetxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"),
               np.asarray([xoff, yoff_b, size, res]))
    return dict(root=root, gt_dir=gt_dir, aoi_id=aoi_id, names=names,
                brdf=brdf)


def rpc00b_text(d: dict) -> str:
    """An RPC dict as classic RPC00B sidecar text (.rpc / .rpc_adj)."""
    lines = [f"LINE_OFF: {d['row_offset']} pixels",
             f"SAMP_OFF: {d['col_offset']} pixels",
             f"LAT_OFF: {d['lat_offset']} degrees",
             f"LONG_OFF: {d['lon_offset']} degrees",
             f"HEIGHT_OFF: {d['alt_offset']} meters",
             f"LINE_SCALE: {d['row_scale']} pixels",
             f"SAMP_SCALE: {d['col_scale']} pixels",
             f"LAT_SCALE: {d['lat_scale']} degrees",
             f"LONG_SCALE: {d['lon_scale']} degrees",
             f"HEIGHT_SCALE: {d['alt_scale']} meters"]
    for pref, key in (("LINE_NUM_COEFF", "row_num"),
                      ("LINE_DEN_COEFF", "row_den"),
                      ("SAMP_NUM_COEFF", "col_num"),
                      ("SAMP_DEN_COEFF", "col_den")):
        for j, v in enumerate(d[key]):
            lines.append(f"{pref}_{j + 1}: {v}")
    return "\n".join(lines)


def write_full_scenes(img_dir: str, size: int = None,
                      tilts=((0.0, 0.0), (0.1, 0.05), (-0.08, 0.1))):
    """Full-scene inputs of the dataset generator (cli/generate_dataset):
    one float32 GeoTIFF per tilt covering three times the AOI's footprint at
    its ground resolution (size: the AOI's pixels, default the module's
    32), with an RPC00B sidecar <name>.rpc.  Returns [(tif, rpc dict)]."""
    size = size or W
    full = 3 * size
    os.makedirs(img_dir, exist_ok=True)
    out = []
    for i, tilt in enumerate(tilts):
        d = affine_rpc_dict(*tilt, hw=(size, size))
        d = dict(d, col_offset=full / 2.0, row_offset=full / 2.0,
                 col_scale=full / 2.0, row_scale=full / 2.0,
                 lon_scale=3 * d["lon_scale"], lat_scale=3 * d["lat_scale"])
        cols, rows = np.meshgrid(np.arange(full), np.arange(full))
        lon, lat = localize_affine(d, cols, rows, ALT0)
        tex = ground_texture(lon, lat)
        p = os.path.join(img_dir, f"full_{i:02d}.tif")
        write_geotiff(p, (np.stack([tex] * 3) * 4000).astype(np.float32),
                      GeoProfile(epsg=utm_epsg(ZONE, True)))
        with open(p[:-4] + ".rpc", "w") as f:
            f.write(rpc00b_text(d))
        out.append((p, d))
    return out
