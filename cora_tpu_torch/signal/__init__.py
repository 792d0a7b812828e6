"""Signal models: the redshift-space C_l engine and the 21cm models."""
