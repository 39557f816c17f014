"""Physical constants (CGS unless noted); this package's own copy of
bart_tpu/constants.py, equal to the last bit (tests/test_torch_copies.py).

Values match the reference BART project constants (reference:
code/constants.py:1-19) plus CODATA values used throughout the
forward model, as plain Python floats.
"""

# --- Astronomical (SI) ---------------------------------------------------
MJUP = 1.8983e27        # Jupiter mass [kg]
RJUP = 7.1492e7         # Jupiter radius [m]
RSUN = 6.96e8           # Solar radius [m]
AU = 1.495978707e11     # Astronomical unit [m]
G_NEWTON = 6.67430e-11  # Gravitational constant [m3 kg-1 s-2]

# --- CGS microphysics (match transit/include/constants_tr.h values as
# --- recorded in reference code/constants.py:13-16) ----------------------
H_PLANCK = 6.6260755e-27   # Planck constant [erg s]
C_LIGHT = 2.99792458e10    # Speed of light [cm s-1]
K_BOLTZ = 1.380658e-16     # Boltzmann constant [erg K-1]
SIGMA_SB = 5.670367e-8     # Stefan-Boltzmann [W m-2 K-4]
SIGMA_SB_CGS = 5.670367e-5 # Stefan-Boltzmann [erg s-1 cm-2 K-4]

# Derived radiation constant: hc/k [cm K], the Planck exponent scale.
C2 = H_PLANCK * C_LIGHT / K_BOLTZ

# --- Particle data -------------------------------------------------------
AMU = 1.66053906660e-24    # Atomic mass unit [g]
N_AVOGADRO = 6.02214076e23 # Avogadro number [mol-1]
K_BOLTZ_SI = 1.380649e-23  # Boltzmann constant [J K-1]
E_CHARGE = 4.80320425e-10  # Electron charge [statC]
M_ELECTRON = 9.1093897e-28 # Electron mass [g]

# Classical line-intensity prefactor pi e^2 / (m_e c^2)  [cm]
# (appears in gf -> cross-section conversion)
PI_E2_MEC2 = 8.85282e-13   # pi*e^2/(m_e*c^2) in cm (standard value)
# pi e^2/(m_e c): used with oscillator strengths, [cm^2 s-1]
C_OSC = 0.02654008854574474  # pi e^2 / (m_e c) in cgs over c... see voigt.py

# --- Unit conversions ----------------------------------------------------
BAR_TO_BARYE = 1e6         # bar -> barye (dyn cm-2)
KM_TO_CM = 1e5
MICRON_TO_CM = 1e-4
ERG_TO_JOULE = 1e-7
JOULE_TO_ERG = 1e7
