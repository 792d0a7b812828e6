"""``k1_ms``: milliseconds of the program's ``legendre`` stage per channel map
in a scan-mode cell, from ``cora_tpu_torch.util.profiling.stage_times`` over
the stage-timed stretch of a traced run: the device span of K1, the scan
Legendre kernel that generates the rows and contracts them with the a_lm
planes, with the launch's own preparation.  None where the stage did not
run."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "legendre")
