"""The port's data tables, shipped as package data beside this module.

Byte-identical copies of the reference's tables that the port reads:
the 21cm power spectrum and its correlation cache (``ps_z1.5.npz``,
``corr_z1.5.npz``), the LSS power spectra (``ps_<name>.npz``), the bright
point-source catalogue (``combinedps.npz``) and the galactic sky maps
(``skydata.npz``).  Every module resolves them here, so the package runs
from any directory it is copied or installed to.
"""

import os

DATA_DIR = os.path.dirname(os.path.abspath(__file__))


def data_path(name):
    """The path of the shipped table ``name`` (e.g. ``"ps_z1.5.npz"``)."""
    return os.path.join(DATA_DIR, name)
