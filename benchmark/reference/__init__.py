"""The plain reference that decides a run's ``correct``.

Plain torch and numpy, written from the published definitions (HEALPix ring
geometry, the orthonormal associated-Legendre recurrence, the flat-sky
redshift-space C_l of the 21cm model).  It imports nothing of the program
under test and takes nothing the program made except the outputs it judges
and, for the synthesis, the covariance roots it is told to follow (the
roots are checked on their own against this package's C_l grid).
"""
