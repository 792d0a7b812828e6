"""``ring_fwd_ms``: milliseconds of the program's ``ring_fwd`` stage per
channel map, from ``cora_tpu_torch.util.profiling.stage_times`` over the
stage-timed stretch of a traced run: the analysis's ring transforms (the
N/S fold, the DFT and the conjugate-chirp Bluestein convolution of
``sht.grid_to_rings_parity``), 1 + iter of them a chunk."""

from harness.stats import stage_ms_per_map


def read(ctx):
    return stage_ms_per_map(ctx, "ring_fwd")
