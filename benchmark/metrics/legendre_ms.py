"""``legendre_ms``: milliseconds of the program's ``legendre`` stage per
channel map, from ``cora_tpu_torch.util.profiling.stage_times`` over the
stage-timed stretch of a traced run: the device span of whatever contracts
the a_lm planes with Λ (K4 or a successor), whatever its kernel's name."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "legendre")
