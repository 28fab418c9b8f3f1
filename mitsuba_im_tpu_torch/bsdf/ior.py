"""IOR presets (``mitsuba_im_tpu/bsdf/ior.py``): the named dielectrics of
the reference's ``src/bsdfs/ior.h`` and the conductors' eta/k as
linear-RGB reductions of its measured spectra (``data/ior/*.spd``)."""
from __future__ import annotations

import numpy as np

# name -> ior (reference ior.h iorData table)
DIELECTRICS = {
    "vacuum": 1.0,
    "helium": 1.000036,
    "hydrogen": 1.000132,
    "air": 1.000277,
    "carbon dioxide": 1.00045,
    "water": 1.3330,
    "acetone": 1.36,
    "ethanol": 1.361,
    "carbon tetrachloride": 1.461,
    "glycerol": 1.4729,
    "benzene": 1.501,
    "silicone oil": 1.52045,
    "bromine": 1.661,
    "water ice": 1.31,
    "fused quartz": 1.458,
    "pyrex": 1.470,
    "acrylic glass": 1.49,
    "polypropylene": 1.49,
    "bk7": 1.5046,
    "sodium chloride": 1.544,
    "amber": 1.55,
    "pet": 1.5750,
    "diamond": 2.419,
}

# name -> (eta rgb, k rgb); RGB reductions of the reference's spectral data
CONDUCTORS = {
    "a-C": ([2.9440, 2.2271, 1.9822], [0.8874, 0.7993, 0.8195]),
    "Ag": ([0.1552, 0.1167, 0.1383], [4.8283, 3.1222, 2.1457]),
    "Al": ([1.6574, 0.8803, 0.5212], [9.2238, 6.2692, 4.8368]),
    "Au": ([0.1431, 0.3749, 1.4424], [3.9831, 2.3857, 1.6032]),
    "Be": ([4.1850, 3.1850, 2.7870], [3.8350, 3.0050, 2.6750]),
    "Cr": ([4.3696, 2.9167, 1.6547], [5.2064, 4.2313, 3.7549]),
    "Cu": ([0.2004, 0.9240, 1.1022], [3.9129, 2.4528, 2.1421]),
    "Hg": ([2.3989, 1.4400, 0.9095], [6.3150, 4.3620, 3.4140]),
    "Ir": ([3.0864, 2.0821, 1.6178], [5.5800, 4.0500, 3.2600]),
    "K": ([0.0526, 0.0460, 0.0382], [2.0700, 1.3400, 0.9130]),
    "Li": ([0.2657, 0.1951, 0.2203], [3.5395, 2.3494, 1.6794]),
    "MgO": ([2.0850, 1.6450, 1.0590], [0.0000, 0.0000, 0.0000]),
    "Mo": ([4.4837, 3.5254, 2.7698], [4.1057, 3.4175, 3.3238]),
    "Na": ([0.0603, 0.0561, 0.0618], [3.1792, 2.1124, 1.5790]),
    "Nb": ([3.4201, 2.7901, 2.3955], [3.4430, 2.7376, 2.5745]),
    "Ni": ([2.3672, 1.6633, 1.4670], [4.4988, 3.0501, 2.3454]),
    "Rh": ([2.5918, 1.8601, 1.5544], [6.7933, 4.7025, 3.9910]),
    "Se": ([4.0592, 2.8702, 2.8190], [0.7554, 0.6391, 0.5211]),
    "SiC": ([3.1723, 2.5259, 2.4793], [0.0000, 0.0000, 0.0000]),
    "SnTe": ([4.5200, 4.4800, 2.0400], [0.0000, 0.0000, 0.0000]),
    "Ta": ([2.0558, 2.3953, 2.6255], [2.4032, 1.7398, 1.9491]),
    "Te": ([7.3790, 4.4990, 2.3020], [3.2410, 3.5110, 3.7910]),
    "ThF4": ([1.8300, 1.4400, 1.3300], [0.0000, 0.0000, 0.0000]),
    "TiC": ([3.7000, 2.7400, 2.4300], [3.2300, 2.2000, 1.8600]),
    "TiN": ([1.6484, 1.1493, 1.3738], [3.3684, 1.9400, 1.1022]),
    "TiO2": ([3.4437, 2.8092, 2.5441], [0.0001, 0.0000, 0.0000]),
    "VC": ([3.6454, 2.7512, 2.5318], [3.0684, 2.1940, 1.9400]),
    "V": ([4.2656, 3.5066, 2.7620], [3.4838, 2.8802, 3.1068]),
    "VN": ([2.8566, 2.1191, 1.9400], [3.0230, 2.0590, 1.4700]),
    "W": ([4.3658, 3.2999, 2.9970], [3.5006, 2.6045, 2.2716]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),  # perfect mirror
}


def lookup_dielectric(name: str) -> float:
    """The IOR of a named dielectric, or of a number given as text."""
    key = name.strip().lower()
    if key in DIELECTRICS:
        return DIELECTRICS[key]
    try:
        return float(name)
    except ValueError:
        raise KeyError(f"unknown dielectric material '{name}'") from None


def lookup_conductor(name: str):
    if name in CONDUCTORS:
        eta, k = CONDUCTORS[name]
        return np.asarray(eta, np.float64), np.asarray(k, np.float64)
    raise KeyError(f"unknown conductor material '{name}'")
