"""``projection_ms``: milliseconds of the program's ``projection`` stage per
channel map, from ``cora_tpu_torch.util.profiling.stage_times`` over the
stage-timed stretch of a traced run: the analysis's Legendre projection
(``sht.project_GeGo``: the routing by m parity, the adjoint of the Legendre
contraction, the interleave of the even and odd ℓ rows), 1 + iter of them
a chunk, whatever kernel projects."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "projection")
