"""``ring_ms``: milliseconds of the program's ``ring`` stage per channel map,
from ``cora_tpu_torch.util.profiling.stage_times`` over the stage-timed
stretch of a traced run (each stage closes with a synchronise there)."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "ring")
