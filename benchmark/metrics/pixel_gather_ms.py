"""``pixel_gather_ms``: milliseconds of the program's ``pixel_gather`` stage
(ring grid → HEALPix RING pixels, ``SHT.grid_to_map``) per channel map, from
``cora_tpu_torch.util.profiling.stage_times`` over the stage-timed stretch of
a traced run."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "pixel_gather")
