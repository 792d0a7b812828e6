"""Physical and astronomical constants (port of ``cora_tpu/constants.py``).

CODATA-2018 / IAU standard values in SI units unless stated otherwise;
identical to the JAX package's table.
"""

import math

# Speed of light [m/s]
c = 299792458.0
c_sl = c

# Gravitational constant [m^3 kg^-1 s^-2]
G = 6.67430e-11
G_n = G

# Boltzmann constant [J/K]
k_B = 1.380649e-23

# Planck constant [J s]
h_planck = 6.62607015e-34

# Radiation constant [J m^-3 K^-4]
a_rad = 7.565723e-16

# Stefan-Boltzmann [W m^-2 K^-4]
stefan_boltzmann = 5.670374419e-8

# Parsec and friends [m]
parsec = 3.0856775814913673e16
kilo_parsec = 1e3 * parsec
mega_parsec = 1e6 * parsec
giga_parsec = 1e9 * parsec

# Astronomical unit [m]
astronomical_unit = 1.495978707e11

# Solar quantities
solar_mass = 1.98892e30  # [kg]
solar_luminosity = 3.828e26  # [W]
solar_radius = 6.957e8  # [m]

# Time units [s]
year = 365.25 * 24 * 3600.0
kilo_year = 1e3 * year
mega_year = 1e6 * year
giga_year = 1e9 * year

# Angle conversions [radians]
degree = math.pi / 180.0
arc_minute = degree / 60.0
arc_second = arc_minute / 60.0

# Frequency of the 21cm hyperfine transition of hydrogen [MHz]
nu21 = 1420.40575177

# Jansky [W m^-2 Hz^-1]
jansky = 1e-26

# Electron mass [kg] and charge [C]
m_e = 9.1093837015e-31
e_q = 1.602176634e-19

# Permittivity of free space [F/m]
epsilon_0 = 8.8541878128e-12

# Thomson cross-section [m^2]
sigma_T = 6.6524587321e-29
