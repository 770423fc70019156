"""Sun & sky environment emitters (host-side rasterization, numpy).

Replicates the reference's sun/sky/sunsky plugins
(mitsuba/src/emitters/{sky.cpp,sun.cpp,sunsky.cpp} + sunsky/*.h):

  * sun position: PSA algorithm (Blanco-Muriel et al. 2001), exactly as
    sunmodel.h computeSunCoordinates
  * sky dome: Hosek & Wilkie 2012 analytic RGB model; the coefficient
    dataset (data/hosek_rgb.npz) is the authors' published data
    (3-clause BSD), repacked from the reference's skymodeldata.h
  * sun radiance: Preetham-style solar spectrum with Rayleigh / aerosol /
    ozone / mixed-gas / water-vapor attenuation (sunmodel.h
    computeSunRadiance), converted to linear RGB via the CIE tables
  * sunsky: sky rasterized to a resolution x resolution/2 lat-long map,
    sun disk splatted with a QMC (0,2)-sequence point set
    (sunsky.cpp:161-215), handed to the envmap machinery

All outputs are plain numpy images; `EnvmapArrays.from_image` uploads.

The port's own copy of ppg_tpu/emitters/sunsky.py, with its own copy of
the data file.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.spectrum import InterpolatedSpectrum, spectrum_to_rgb

SUN_APP_RADIUS = 0.5358  # deg, apparent diameter of the sun
CIE_Y_SUM = 106.856980  # sum of Spectrum::CIE_Y entries (sky.cpp:434)

_DATA = None


def _hosek_data():
    global _DATA
    if _DATA is None:
        path = os.path.join(os.path.dirname(__file__), "data", "hosek_rgb.npz")
        z = np.load(path)
        # [channel, albedo, turbidity, bezier-knot, coeff]
        _DATA = dict(
            cfg=np.stack([z[f"rgb{i}"].reshape(2, 10, 6, 9) for i in (1, 2, 3)]),
            rad=np.stack([z[f"rad{i}"].reshape(2, 10, 6) for i in (1, 2, 3)]),
        )
    return _DATA


# --------------------------------------------------------------------------
# sun position (PSA algorithm, sunmodel.h:115-203)
# --------------------------------------------------------------------------

def compute_sun_coordinates(props: dict):
    """Returns (elevation, azimuth) in radians; elevation is the ZENITH
    angle (the reference's SphericalCoordinates convention)."""
    if "sunDirection" in props:
        d = np.asarray(props["sunDirection"], np.float64)
        d = d / np.linalg.norm(d)
        azimuth = np.arctan2(d[0], -d[2])
        if azimuth < 0:
            azimuth += 2 * np.pi
        return float(np.arccos(np.clip(d[1], -1, 1))), float(azimuth)

    lat = float(props.get("latitude", 35.6894))
    lon = float(props.get("longitude", 139.6917))
    tz = float(props.get("timezone", 9))
    year = int(props.get("year", 2010))
    month = int(props.get("month", 7))
    day = int(props.get("day", 10))
    hour = float(props.get("hour", 15.0))
    minute = float(props.get("minute", 0.0))
    second = float(props.get("second", 0.0))

    dec_hours = hour - tz + (minute + second / 60.0) / 60.0
    aux1 = (month - 14) // 12
    aux2 = (1461 * (year + 4800 + aux1)) // 4 \
        + (367 * (month - 2 - 12 * aux1)) // 12 \
        - (3 * ((year + 4900 + aux1) // 100)) // 4 + day - 32075
    julian = aux2 - 0.5 + dec_hours / 24.0
    elapsed = julian - 2451545.0

    omega = 2.1429 - 0.0010394594 * elapsed
    mean_lon = 4.8950630 + 0.017202791698 * elapsed
    anomaly = 6.2400600 + 0.0172019699 * elapsed
    ecl_lon = mean_lon + 0.03341607 * np.sin(anomaly) \
        + 0.00034894 * np.sin(2 * anomaly) - 0.0001134 \
        - 0.0000203 * np.sin(omega)
    ecl_obl = 0.4090928 - 6.2140e-9 * elapsed + 0.0000396 * np.cos(omega)

    sin_ecl_lon = np.sin(ecl_lon)
    ra = np.arctan2(np.cos(ecl_obl) * sin_ecl_lon, np.cos(ecl_lon))
    if ra < 0:
        ra += 2 * np.pi
    decl = np.arcsin(np.sin(ecl_obl) * sin_ecl_lon)

    gmst = 6.6974243242 + 0.0657098283 * elapsed + dec_hours
    lmst = np.deg2rad(gmst * 15 + lon)
    lat_r = np.deg2rad(lat)
    hour_angle = lmst - ra
    elevation = np.arccos(
        np.cos(lat_r) * np.cos(hour_angle) * np.cos(decl)
        + np.sin(decl) * np.sin(lat_r)
    )
    azimuth = np.arctan2(
        -np.sin(hour_angle),
        np.tan(decl) * np.cos(lat_r) - np.sin(lat_r) * np.cos(hour_angle),
    )
    if azimuth < 0:
        azimuth += 2 * np.pi
    # parallax correction (EARTH_MEAN_RADIUS / ASTRONOMICAL_UNIT)
    elevation += (6371.01 / 149597890.0) * np.sin(elevation)
    return float(elevation), float(azimuth)


# --------------------------------------------------------------------------
# Hosek-Wilkie RGB sky model (skymodel.cpp)
# --------------------------------------------------------------------------

def _cook_weights(turbidity, albedo, solar_elevation):
    """Shared interpolation weights: quintic bezier in elevation^(1/3),
    linear in turbidity and albedo. Returns ([4] combo weights over
    (albedo, turb) pairs, [6] bezier knot weights, turb indices)."""
    t_int = int(np.clip(int(turbidity), 1, 10))
    t_rem = turbidity - t_int
    x = (solar_elevation / (np.pi / 2.0)) ** (1.0 / 3.0)
    xi = 1.0 - x
    bez = np.array([
        xi ** 5, 5 * xi ** 4 * x, 10 * xi ** 3 * x ** 2,
        10 * xi ** 2 * x ** 3, 5 * xi * x ** 4, x ** 5,
    ])
    combos = []  # (albedo_idx, turb_idx, weight)
    combos.append((0, t_int - 1, (1 - albedo) * (1 - t_rem)))
    combos.append((1, t_int - 1, albedo * (1 - t_rem)))
    if t_int < 10:
        combos.append((0, t_int, (1 - albedo) * t_rem))
        combos.append((1, t_int, albedo * t_rem))
    return combos, bez


def hosek_rgb_state(turbidity, albedo_rgb, solar_elevation):
    """Cook per-channel configs [3,9] and radiance scales [3]."""
    data = _hosek_data()
    cfgs = np.zeros((3, 9))
    rads = np.zeros(3)
    for ch in range(3):
        combos, bez = _cook_weights(turbidity, float(albedo_rgb[ch]),
                                    solar_elevation)
        for a, t, w in combos:
            cfgs[ch] += w * (bez @ data["cfg"][ch, a, t])
            rads[ch] += w * (bez @ data["rad"][ch, a, t])
    return cfgs, rads


def hosek_radiance(cfgs, rads, theta, gamma):
    """ArHosekSkyModel_GetRadianceInternal vectorized over a grid.
    theta/gamma broadcastable arrays; returns [..., 3]."""
    ct = np.cos(theta)[..., None]
    cg = np.cos(gamma)[..., None]
    g = gamma[..., None]
    c = cfgs[None, ...] if cfgs.ndim == 2 else cfgs  # broadcast [...,3,9]
    A, B, C, D, E = c[..., 0], c[..., 1], c[..., 2], c[..., 3], c[..., 4]
    F, G, H, I = c[..., 5], c[..., 6], c[..., 7], c[..., 8]
    exp_m = np.exp(E * g)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(1.0 + I * I - 2.0 * I * cg, 1.5)
    zenith = np.sqrt(np.maximum(ct, 0.0))
    val = (1.0 + A * np.exp(B / (ct + 0.01))) * \
        (C + D * exp_m + F * ray_m + G * mie_m + H * zenith)
    return val * rads


def sky_radiance_map(resolution, turbidity, albedo_rgb, sun_elevation_zenith,
                     sun_azimuth, scale=1.0, stretch=1.0, extend=False):
    """Rasterize the sky to [res/2, res, 3] linear RGB (sky.cpp:313-332,
    getSkyRadiance :412-441). sun_elevation_zenith is the zenith angle."""
    W, H = resolution, resolution // 2
    sun_alt = 0.5 * np.pi - sun_elevation_zenith
    if sun_alt < 0:
        raise ValueError("sun below the horizon: unsupported by the sky model")
    cfgs, rads = hosek_rgb_state(turbidity, albedo_rgb, sun_alt)

    theta = (np.arange(H) + 0.5) * (np.pi / H)
    phi = (np.arange(W) + 0.5) * (2 * np.pi / W)
    th = np.broadcast_to(theta[:, None], (H, W)) / stretch
    ph = np.broadcast_to(phi[None, :], (H, W))

    cos_gamma = np.cos(th) * np.cos(sun_elevation_zenith) \
        + np.sin(th) * np.sin(sun_elevation_zenith) * np.cos(ph - sun_azimuth)
    gamma = np.arccos(np.clip(cos_gamma, -1.0, 1.0))

    below = np.cos(th) <= 0
    th_eval = np.where(below, 0.5 * np.pi - 1e-4 if extend else 0.0, th)
    img = hosek_radiance(cfgs, rads, th_eval, gamma) / CIE_Y_SUM
    img = np.maximum(img, 0.0)
    if extend:
        s = np.clip(2 - 2 * (th * stretch) / np.pi, 0.0, 1.0)
        img *= (s * s * (3 - 2 * s))[..., None]
    else:
        img[below] = 0.0
    return (img * scale).astype(np.float32)


# --------------------------------------------------------------------------
# sun spectral radiance (sunmodel.h:206-376)
# --------------------------------------------------------------------------

_K_O_WL = [300, 305, 310, 315, 320, 325, 330, 335, 340, 345,
           350, 355, 445, 450, 455, 460, 465, 470, 475, 480,
           485, 490, 495, 500, 505, 510, 515, 520, 525, 530,
           535, 540, 545, 550, 555, 560, 565, 570, 575, 580,
           585, 590, 595, 600, 605, 610, 620, 630, 640, 650,
           660, 670, 680, 690, 700, 710, 720, 730, 740, 750,
           760, 770, 780, 790]
_K_O_AMP = [10.0, 4.8, 2.7, 1.35, .8, .380, .160, .075, .04, .019, .007,
            .0, .003, .003, .004, .006, .008, .009, .012, .014, .017,
            .021, .025, .03, .035, .04, .045, .048, .057, .063, .07,
            .075, .08, .085, .095, .103, .110, .12, .122, .12, .118,
            .115, .12, .125, .130, .12, .105, .09, .079, .067, .057,
            .048, .036, .028, .023, .018, .014, .011, .010, .009,
            .007, .004, .0, .0][:64]
_K_G_WL = [759, 760, 770, 771]
_K_G_AMP = [0, 3.0, 0.210, 0]
_K_WA_WL = [689, 690, 700, 710, 720, 730, 740, 750, 760, 770, 780, 790, 800]
_K_WA_AMP = [0, 0.160e-1, 0.240e-1, 0.125e-1, 0.100e+1, 0.870, 0.610e-1,
             0.100e-2, 0.100e-4, 0.100e-4, 0.600e-3, 0.175e-1, 0.360e-1]
_SOL_WL = [380, 390, 400, 410, 420, 430, 440, 450, 460, 470, 480, 490,
           500, 510, 520, 530, 540, 550, 560, 570, 580, 590, 600, 610,
           620, 630, 640, 650, 660, 670, 680, 690, 700, 710, 720, 730,
           740, 750]
_SOL_AMP = [16559.0, 16233.7, 21127.5, 25888.2, 25829.1, 24232.3, 26760.5,
            29658.3, 30545.4, 30057.5, 30663.7, 28830.4, 28712.1, 27825.0,
            27100.6, 27233.6, 26361.3, 25503.8, 25060.2, 25311.6, 25355.9,
            25134.2, 24631.5, 24173.2, 23685.3, 23212.1, 22827.7, 22339.8,
            21970.2, 21526.7, 21097.9, 20728.3, 20240.4, 19870.8, 19427.2,
            19072.4, 18628.9, 18259.2]


def compute_sun_radiance(theta, turbidity):
    """Attenuated solar RGB radiance for zenith angle theta [rad]."""
    k_o = InterpolatedSpectrum(_K_O_WL, _K_O_AMP)
    k_g = InterpolatedSpectrum(_K_G_WL, _K_G_AMP)
    k_wa = InterpolatedSpectrum(_K_WA_WL, _K_WA_AMP)
    sol = InterpolatedSpectrum(_SOL_WL, _SOL_AMP)

    beta = 0.04608365822050 * turbidity - 0.04586025928522
    m = 1.0 / (np.cos(theta) + 0.15
               * (93.885 - np.rad2deg(theta)) ** -1.253)

    lam = np.arange(91) * 5.0 + 350.0  # nm
    lam_um = lam / 1000.0
    tau_r = np.exp(-m * 0.008735 * lam_um ** -4.08)
    tau_a = np.exp(-m * beta * lam_um ** -1.3)
    tau_o = np.exp(-m * np.array([k_o.eval(l) for l in lam]) * 0.35)
    kg = np.array([k_g.eval(l) for l in lam])
    tau_g = np.exp(-1.41 * kg * m / (1 + 118.93 * kg * m) ** 0.45)
    kwa = np.array([k_wa.eval(l) for l in lam])
    tau_wa = np.exp(-0.2385 * kwa * 2.0 * m / (1 + 20.07 * kwa * 2.0 * m) ** 0.45)

    data = np.array([sol.eval(l) for l in lam]) * tau_r * tau_a * tau_o \
        * tau_g * tau_wa
    rgb = spectrum_to_rgb(lam, data)
    return np.maximum(rgb, 0.0)


# --------------------------------------------------------------------------
# (0,2)-sequence QMC points for the sun-disk splat (qmc.h sample02)
# --------------------------------------------------------------------------

def _sample02(n):
    i = np.arange(n, dtype=np.uint32)
    # van der Corput, base 2 (bit reversal)
    v = i.copy()
    v = ((v << np.uint32(16)) | (v >> np.uint32(16))).astype(np.uint32)
    v = (((v & np.uint32(0x00ff00ff)) << np.uint32(8))
         | ((v & np.uint32(0xff00ff00)) >> np.uint32(8))).astype(np.uint32)
    v = (((v & np.uint32(0x0f0f0f0f)) << np.uint32(4))
         | ((v & np.uint32(0xf0f0f0f0)) >> np.uint32(4))).astype(np.uint32)
    v = (((v & np.uint32(0x33333333)) << np.uint32(2))
         | ((v & np.uint32(0xcccccccc)) >> np.uint32(2))).astype(np.uint32)
    v = (((v & np.uint32(0x55555555)) << np.uint32(1))
         | ((v & np.uint32(0xaaaaaaaa)) >> np.uint32(1))).astype(np.uint32)
    x = v.astype(np.float64) / 4294967296.0
    # Sobol' second dimension (gray-code construction)
    y = np.zeros(n, np.uint32)
    vdir = np.uint32(1 << 31)
    idx = i.copy()
    for _ in range(32):
        active = (idx & 1).astype(bool)
        y = np.where(active, y ^ vdir, y)
        idx >>= 1
        vdir ^= vdir >> np.uint32(1)
    return x, y.astype(np.float64) / 4294967296.0


def splat_sun(img, sun_elevation_zenith, sun_azimuth, sun_radiance_rgb,
              sun_radius_scale=1.0, stretch=1.0):
    """Add the sun disk into a lat-long map in place (sunsky.cpp:182-215)."""
    H, W = img.shape[:2]
    theta_s = np.deg2rad(SUN_APP_RADIUS * 0.5)
    elev = sun_elevation_zenith * stretch
    n = np.array([
        np.sin(sun_azimuth) * np.sin(elev),
        np.cos(elev),
        -np.cos(sun_azimuth) * np.sin(elev),
    ])
    # any orthonormal frame around n (the cone is symmetric)
    up = np.array([1.0, 0, 0]) if abs(n[1]) > 0.9 else np.array([0, 1.0, 0])
    s = np.cross(up, n)
    s /= np.linalg.norm(s)
    t = np.cross(n, s)

    cos_cut = np.cos(theta_s * sun_radius_scale)
    covered = 0.5 * (1 - cos_cut)
    n_samples = int(max(100, W * H * covered * 1000))
    value = sun_radiance_rgb * (2 * np.pi * (1 - np.cos(theta_s))) \
        * (W * H) / (2 * np.pi * np.pi * n_samples)

    u1, u2 = _sample02(n_samples)
    ct = (1 - u1) + u1 * cos_cut
    st = np.sqrt(np.maximum(1 - ct * ct, 0.0))
    ph = 2 * np.pi * u2
    local = np.stack([np.cos(ph) * st, np.sin(ph) * st, ct], -1)
    dirs = local[:, 0:1] * s + local[:, 1:2] * t + local[:, 2:3] * n

    sin_theta = np.sqrt(np.maximum(1 - dirs[:, 1] ** 2, 1e-12))
    az = np.arctan2(dirs[:, 0], -dirs[:, 2])
    az = np.where(az < 0, az + 2 * np.pi, az)
    el = np.arccos(np.clip(dirs[:, 1], -1, 1))
    px = np.clip((az * (W / (2 * np.pi))).astype(np.int64), 0, W - 1)
    py = np.clip((el * (H / np.pi)).astype(np.int64), 0, H - 1)
    w = 1.0 / np.maximum(1e-3, sin_theta)
    np.add.at(img, (py, px), value[None, :] * w[:, None])
    return img


# --------------------------------------------------------------------------
# plugin-level builders
# --------------------------------------------------------------------------

def rasterize_sun_sky(props: dict, kind: str):
    """Build the lat-long radiance map for emitter type 'sky', 'sun' or
    'sunsky' from its Properties dict. Returns float32 [H, W, 3]."""
    resolution = int(props.get("resolution", 512))
    turbidity = float(props.get("turbidity", 3.0))
    stretch = float(props.get("stretch", 1.0))
    scale = float(props.get("scale", 1.0))
    albedo = props.get("albedo", 0.2)
    if np.isscalar(albedo):
        albedo = [float(albedo)] * 3
    albedo = np.asarray(albedo, np.float64)
    elev, azim = compute_sun_coordinates(props)

    W, H = resolution, resolution // 2
    if kind in ("sky", "sunsky"):
        sky_scale = float(props.get("skyScale", scale)) if kind == "sunsky" \
            else scale
        img = sky_radiance_map(resolution, turbidity, albedo, elev, azim,
                               scale=sky_scale, stretch=stretch,
                               extend=bool(props.get("extend", False)))
    else:
        img = np.zeros((H, W, 3), np.float32)

    if kind in ("sun", "sunsky"):
        sun_scale = float(props.get("sunScale", scale)) if kind == "sunsky" \
            else scale
        radius_scale = float(props.get("sunRadiusScale", 1.0))
        if radius_scale <= 0:
            # sunRadiusScale=0: the sun is emitted as a directional delta
            # light by scene flattening (sun.cpp:153-166) — skip the splat
            pass
        else:
            sun_rgb = compute_sun_radiance(elev, turbidity) * sun_scale
            img = splat_sun(img, elev, azim, sun_rgb,
                            sun_radius_scale=radius_scale, stretch=stretch)
    return img.astype(np.float32)


def directional_sun(props: dict):
    """sunRadiusScale=0 conversion (sun.cpp:153-166): returns
    (direction light travels, irradiance rgb) for a directional emitter
    with irradiance = sunRadiance * solidAngle."""
    turbidity = float(props.get("turbidity", 3.0))
    scale = float(props.get("scale", 1.0))
    sun_scale = float(props.get("sunScale", scale))
    stretch = float(props.get("stretch", 1.0))
    elev, azim = compute_sun_coordinates(props)
    theta = np.deg2rad(SUN_APP_RADIUS * 0.5)
    solid_angle = 2 * np.pi * (1 - np.cos(theta))
    irradiance = compute_sun_radiance(elev, turbidity) * sun_scale * solid_angle
    e = elev * stretch
    n = np.array([np.sin(azim) * np.sin(e), np.cos(e),
                  -np.cos(azim) * np.sin(e)])
    return -n, irradiance
